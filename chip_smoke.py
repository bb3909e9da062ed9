#!/usr/bin/env python3
"""Drive accl_tpu_torch on an NVIDIA GPU: build, kernel phases, main path.

Run from the root of a checkout:  python3 chip_smoke.py
(``--slice-child RANK PORT`` is phase 16c's child process, not an entry.)

1. Device and build: requires CUDA, prints the card's name and power
   limit, builds the CUDA kernels from ``accl_tpu_torch/csrc`` (one
   nvcc per source, all started together).
2. Kernel phases: each kernel (B1 combine, B2 cast, B3 fp8_quant with
   its fp8_scale step, B4 fp8_dequant, B5 bs_quant, B6 bs_dequant, B7
   bs_combine) against its plain PyTorch version on the same CUDA
   inputs, bitwise (a NaN matches a NaN; every other value bit for bit),
   over an edge corpus (NaN, +-inf, +-0, f32 denormals, values past every
   wire's max, all-zero blocks, ragged tails and unaligned rows, every
   wire dtype, func and block size; every 16- and 8-bit code for the
   up-casts) and at the main path's hop shape (8 rank rows of one 8 Mi-
   element ring chunk), where each is timed with CUDA events (median of
   many launches after warm-up). B1 and B2 (one tile a block,
   ``csrc/stream.cuh``) first show 128-bit global accesses in their
   SASS and no ptxas spills, then meet the edges of their tiles: row
   lengths 0, 1, one step - 1, one tile - 1, one tile, one tile + 1 and
   one past what the card holds at once, 1, 7, 8, 32 and 33 rows, a
   second operand or output one element off, out aliasing a and b; all
   bitwise. B7 (one tile a block, ``csrc/bs_codec.cu``) shows 128-bit
   loads of ``other`` (and round-closing stores) in the SASS of every
   instantiation and no spills, then meets its own edges in both modes
   (``bs_edge_cases``): every wire and block size 32-4096, lengths 0,
   1, 3, one scale block - 1, + 0, + 1 and one tile - 1, + 0, + 1, the
   same row counts, ``other`` or the code rows one element off, blocks
   whose amax is NaN, inf, 0, denormal or just above FLT_MIN * qmax,
   rounding ties; guard bytes around every output row. B1's record times
   the ring's out-of-place call; B1 in place in f32 and bf16 is timed
   beside ``torch.add(a, b, out=a)``, B2 in six directions beside
   ``.to(dtype)``, B7's round-closing mode beside its requant record,
   each with its bound, beside the ``copy_`` rate of the same bytes.
3. Main path: ``cuda_world(8)`` with device-resident buffers of 64 Mi
   fp32 per rank, through ``ACCL``: ring allreduce, reduce_scatter and
   allgather (fp32), the fp8-e4m3 block-scaled (block 128) ring
   allreduce, the ring allreduce on the f16, bf16 and per-tensor
   fp8-e4m3 wires, the xla-family allreduce on per-tensor fp8-e4m3,
   bcast (root 3, bf16 wire), reduce (root 5, fp32, AUTO: the 2x4 tree),
   scatter and gather (root 3, f16 wire, 8 Mi per rank) and alltoall
   (fp8-e4m3 pure cast, 8 Mi per peer). Every result is held against
   the plain path (the same schedule through the plain versions) bitwise
   (the xla family within rtol=1e-6, atol=1e-6: its rank-axis sum is a
   torch reduction) and against a float64 golden within a bound printed
   beside the measured error (see ``golden_bound``). Every kernel's
   launch count must rise during this run.
4. Where the time goes: each call of the main path once more under
   torch.profiler, device time summed per kernel family, beside the
   call's host-clock time (the rest is the device's idle share); then
   the combine (B1) and cast (B2) families' ms per call on one line.
4b. Point-to-point and local ops: ``cuda_world(8)`` with device-resident
   buffers of 64 Mi fp32 a rank, through ``ACCL``: a ring shift (rank r
   sends to r+1, receives from r-1, every call async) on the fp32, f16,
   bf16 and fp8-e4m3 block-128 wires, a conflicting set (8 transfers,
   every source twice), a host-mirror ring of 8 Mi, ``copy``, ``combine``
   SUM and MAX in f32 and bf16, and at 8 Mi the stream ports: copy and
   combine from ``stream_push``, recv to the stream-out port and
   ``stream_pop``, ``stream_put``. Every result bitwise against the same
   work through the plain versions and against numpy (exact, or within
   the block codec's bound, printed beside the error); B1, B2, B5 and B6
   must launch; a call takes at most one exchange round a transfer, and
   with the exchange held busy until all its transfers wait, the ring
   shift takes one round, the conflicting set two. Then phase 4's lines
   for each call, with the library's share of its host time, its
   logical wire bytes, exchange rounds and launches.
4c. One-sided RMA: ``cuda_world(8)``, 64 Mi fp32 a message, through
   ``ACCL``: a put ring (rank r into rank r+1's registered window) and a
   get ring on the fp32, f16, bf16 and fp8-e4m3 wires (fp8 a plain
   per-element cast), a put at byte offset 2, a put ring into host-mirror
   windows of 8 Mi, and a storm of 256 puts with notify of 2 MiB into one
   window, discovered by polling. Every landing bitwise against its plain
   version on the card (a torch copy or ``.to()``), every token exactly
   once, no ``accl_calls_total`` row added while polling, no parked send,
   B2 launched; each case's device ms a message (CUDA events behind a GPU
   sleep), library and host ms, idle share and B2 launches.
5. Attention kernels: B8 (``attn_fwd``), B9 (``attn_fwd_single``) and
   B12 (``attn_decode``, ``attn_prefill``) against their plain versions
   on the same CUDA inputs: the CPU tests' shapes, single-block B9 cases
   (Skv 40 to 2048, MHA/GQA/MQA, causal and not, Sq != Skv), NaN in the
   cache past ``kv_len`` with ``kv_len`` at 1, one key tile -1, +0, +1
   and T, chunks of 3, 64 and 65 new tokens after a filled prefix,
   single-token decode with more key slices than filled tiles, and the
   full-width shapes of Llama-3-8B (H=32, Hkv=8, D=128) in bf16 and f32
   (B9 at S=128 and at the serving path's S=512), each timed with CUDA
   events beside the same function through PyTorch's
   ``scaled_dot_product_attention`` (timed only; the port never calls
   it). bf16 B8, bf16 B9 and bf16 B12 chunks run on the tensor cores
   (``attention_sm90.cu``) and are held under the limit of their
   rounding of P (``FWD_TOL``); f32 B8, f32 B9 and f32 B12 chunks run
   on the TF32 tensor cores with 3xTF32 products (``attention.cu``): their
   SASS must hold TF32 HMMA with no spills (``tf32_kernels_checked``),
   each f32 call runs twice and must repeat bitwise, and B8 at B=1,
   S=8192 and B9 over one 4096-key block are held too
   (``attention_long_f32``); their full-width rows ``attn_*_tf32`` join
   the kernels line beside the 3xTF32 bound. Single-token decode runs the
   split-KV kernels (``attention_decode.cu``) in both dtypes, its
   ``n_split`` printed.
6. Llama model, f32, full width, 4 layers: the same random weights
   through ``attention="flash"`` (the kernels) and ``"dense"`` (the
   reference's plain path): ``forward`` on (2, 2048) (B8) and (4, 128)
   (B9), ``forward_cached`` over a 1000-token prefill and 8 decode steps
   (B12), held within a stated tolerance.
7. Serving: Llama-3-8B as published (32 layers, bf16 weights), four
   random 1024-token prompts through ``generate(max_new=32)``, and
   ``forward`` on their first 512 tokens (B9: one key block); the
   prefill logits of ``forward_cached`` against ``forward``, every
   logit against the dense path; forward, prefill and per-step decode
   time, tokens/s, the device's busy share per kernel family under
   torch.profiler and the peak memory. The attention launch counters are
   zeroed before phase 6 and again before phase 7's pass: every
   attention kernel must have run there, every bf16 B8, B9 and B12
   prefill launch on the tensor-core route and no f32 one, and every
   single-token decode on the split-KV kernel (the route counters).
7b. Disaggregated serving on phase 7's model: ``cuda_world(4)``, ranks
   0-1 prefill and 2-3 decode, four 1024-token prompts (0 and 2 share
   512 tokens) through ``serving.serve_disaggregated``: KVBlockManager
   placement and ContinuousBatcher admission, B12 prefill, one
   put-with-notify per missed 2 MiB KV block (16 tokens x 32 layers x K,
   V) into the decode ranks' bf16 windows, polling, unpacking and 32
   decode steps (B12 split-KV). Landed blocks bitwise their source, put
   bytes = misses x 2 MiB, request 2's 32 shared blocks hits, no call
   while polling, the first decode step within SERVE_DENSE_REL of
   ``generate``'s local run; TTFT, KV GB/s, decode ms a step, puts,
   hits, polls and busy share.
8. Attention backward: the bf16 route's kernels (``attention_sm90.cu``:
   B8, B9 and B12 prefill; ``attention_bwd_sm90.cu``) hold HGMMA
   instructions in their SASS (``cuobjdump -sass``), with no ptxas spills
   and no wgmma that ptxas serialized (the split-KV decode kernel's
   registers and spills printed beside them), and the f32 route of B10
   and B11 (``attention_bwd.cu``, 3xTF32) holds TF32 HMMA instructions
   with no spills (checked with phase 5); B10 (``attn_bwd_dkv``) and
   B11 (``attn_bwd_dq``) against their plain versions on an edge corpus
   (MHA/GQA/MQA, causal and not, ragged S, Sq != Skv both ways, D 16-128,
   f32 and bf16) and at the full Llama-3-8B width (B=4, H=32, Hkv=8,
   S=2048, D=128) in bf16 and f32, timed beside PyTorch's SDPA backward
   (timed only), bf16 under the limit of its rounding of P and dS
   (``BWD_TOL``), the f32 route's repeat bitwise equal and its time
   beside both of its bounds (the CUDA cores' f32 rate and three TF32
   products at the tensor cores' rate); the autograd Function's gradients (B8 + B10 + B11)
   against torch autograd through dense attention at the same shape, bf16
   (relative L2, SDPA's beside it) and f32. Then a gradient check: a
   2-layer f32 Llama-3-8B, flash against dense, on (1, 2048): the loss
   and every parameter's gradient; the flash run is the f32 route's path
   (``grad_check``), every B10 and B11 launch there on 3xTF32.
9. Training: Llama-3-8B width, 8 of 32 layers, f32 parameters and bf16
   activations, ``make_train_step`` with Adam(lr=1e-4), 4 steps on one
   (2, 2048) batch: finite losses that fall, B8/B10/B11 once per layer
   per step (B8 on the tensor-core route), the first and last layer's
   B10 and B11 calls of the first step and B8 calls of one more forward
   against their plain versions, step time,
   tokens/s, model FLOPs, the busy share and kernels by family under
   torch.profiler, peak memory. Less than 2 GiB
   may be allocated when it starts.

10. Sequence parallelism at Llama-3-8B's attention width (H=32, Hkv=8,
   D=128), in four parts. 10a (the last phase): the ring's kernel route
   (``ring_attention_fwd``: one B8 launch a visible (rank, K/V block)
   pair, B9 at 512-key shards, the LSE merge in f32; the Function's
   backward, B10 and B11 a visible pair) at B=1, S=8192, W=8 causal in
   bf16 and f32, non-causal in bf16, and W=4, S=2048 (B9) in both,
   against the plain ring (``block_update`` through the reference's
   schedule, autograd, on f32 copies) and against the unsharded kernels
   over the whole sequence (B8, ``_FlashAttention``), under RING_TOL;
   Ulysses (``ulysses_attention``: two alltoalls a side, one B8 launch
   over all ranks) against the unsharded B8 and its gradients, expected
   bitwise; in f32, the unsharded B10 and B11 against their plain
   versions (run one kv head at a time) under phase 8's BWD_TOL, the
   longest sequence the f32 route is held to it at; launches (W(W+1)/2
   causal, W^2 not), exchange rounds (W - 1
   each way) and the logical K/V and alltoall bytes a rank; device ms
   (CUDA events behind a GPU sleep) and host ms of the ring forward and
   backward, Ulysses, the unsharded B8, B10 and B11 and SDPA (timed
   only), and the ring's kernels by family. 10b (inside phase 7, on its
   32-layer bf16 model): ``forward`` of one 8192-token sequence with a
   mesh of 8 ranks on the sp axis against the unsharded ``forward``
   (within SERVE_DENSE_REL), tokens/s, busy share and kernels by family
   of both, peak memory. 10c (after the gradient check, on its 2-layer
   f32 model): the loss and every gradient with sp = 4 against the
   unsharded flash model's (GRAD_LOSS_REL, GRAD_REL_L2). 10d (inside
   phase 9, after its steps): the same model re-initialised from phase
   9's seed, a fresh Adam, ``make_train_step`` over a dp 2 x sp 4 mesh,
   4 steps that must fall, the first loss within 2^-8 of phase 9's,
   B9, B10 and B11 10 times a layer a step, step ms, tokens/s, model
   FLOP/s, busy share and peak memory beside phase 9's. The launches of
   10b and 10d make the ``sp`` entry of each attention record's
   ``launches_by_path``.
11. Tensor parallelism (the Megatron-sharded Llama over the virtual
   ranks of a tp axis), in three parts. 11a (inside phase 7, after 10b,
   on its 32-layer bf16 model and prompts): ``forward``,
   ``generate(max_new=32)`` and ``forward_cached`` over a dp 2 x tp 4
   mesh; the forward, the prefill and a decode step from the same token
   within SERVE_DENSE_REL of the unsharded ones (greedy agreement
   printed), generate's token agreement with phase 7's printed; B8 32 a
   forward, B12 prefill 32 and decode 32 a step, 2 tp all-reduces a
   layer and 1 for the embedding, every bf16 launch on the tensor-core
   route, the first and last layer's kernel calls held against their
   plain versions at the path's shapes; the sharded cache the same
   tensors (data_ptr) through a prefill and 17 steps; forward, prefill
   and decode times beside phase 7's, the tp all-reduce's device ms and
   the shard views' host ms, a column GEMM on the strided shards
   allocating no byte beyond its output (timed beside contiguous
   shards), busy share, kernels by family, peak memory. 11b (after 10c): the 2-layer
   f32 model's loss and every gradient with tp = 4 and tp = 2 against
   the unsharded flash model's (GRAD_LOSS_REL, GRAD_REL_L2). 11c (inside
   phase 9, after 10d): phase 9's model re-initialised from its seed, a
   fresh Adam, ``make_train_step`` over a dp 2 x tp 4 mesh, 4 steps
   that must fall, the first loss within 2^-8 of phase 9's, B8, B10 and
   B11 8 a step, 34 tp all-reduces a step; step ms, tokens/s, model
   FLOP/s, busy share and peak memory beside phase 9's. The launches of
   11a and 11c make the ``tp`` entry of each attention record's
   ``launches_by_path``.
12. The call contract, membership and the uneven exchanges (after 4c;
   its lines print when it ends, the first with its seconds): 12a
   ``alltoallv`` on ``cuda_world(8)``, device-resident, 64 Mi fp32 sent a
   rank with skewed counts (rank r sends floor(p_j N) to peer j, p =
   roll(HOT_P, r)), on the fp32, bf16 and fp8-e4m3 block-128 wires, in
   place (staged) and a routing collapse (8 Mi a rank, all to rank 0),
   each landing bitwise the same schedule through the plain versions
   and within the wire's bound of the exact values, with device ms
   behind a GPU sleep, library ms, idle share, bytes and launches; 12b
   MoE dispatch and combine (4096 tokens of 4096 a rank, top-1 with the
   rotated hot expert, 2 chunks, the expert in f32 with TF32 off) on the
   fp32 and fp8 block-128 dispatch wires, overlap on and off, against
   ``moe_reference`` in float64 (fp32: rtol 1e-5, atol 1e-5; fp8: the
   landed tokens bitwise the plain codecs' run and the output within
   |dx| @ |W|); 12c the ring-attention workload (S = 8192 over 8 ranks,
   d = 128, ``chain=True``) on fp32 and the fp8 block-128 rotation
   against ``ring_attention_reference`` (rtol 1e-5, atol 1e-6; fp8
   bitwise the plain codecs' run, relative L2 below 2^-3), with
   ``overlap_frac``; 12d the elastic decode pool on ``cuda_world(4)``: a
   bf16 arena of 224 blocks of 2 MiB over decode ranks (1, 2) reshards
   as rank 3 joins (``grow_communicator``) and again over ranks 1, 3
   and 0 after rank 2 is revoked and shrunk away, each landing bitwise
   ``redistribute_oracle``, fewer elements moved than the oracle's and
   no piece above one block; 12e the retry contract (a late peer
   outlasted under ``retries=3``, RECEIVE_TIMEOUT_ERROR under 0,
   CALL_RETRIES_EXHAUSTED when spent) and a revoke failing a call in
   flight with PEER_FAILED within 1 s. B2, B5 and B6 must launch.
13. The tuner and the N-tier hierarchy (after 12; its lines print when
   it ends): ``cuda_world(8, algorithm="ring")`` configured as 2 hosts
   of 4 ranks, 64 Mi fp32 a rank, device-resident. 13a HIERARCHICAL
   allreduce, allgather, reduce_scatter and bcast (root 5), each bitwise
   the same phases issued by hand on split communicators and within
   ``golden_bound`` of the float64 oracle (gathers and broadcasts
   exact); the uneven leader shape and a 3-tier nest (chips of 2 in
   racks of 4) at 8 Mi. 13b ``compress_phases="inter"``: fp8-e4m3 block
   128 (``hier_phase_wire_total`` full on the intra phases, quantized on
   the inter ones; B5, B6, B7 launched exactly as often as in the
   program issued by hand with only its outer allreduce compressed;
   bitwise that program; within the codec's bound of two quantizations)
   and bf16 (B2 on the inter phases). Then the 64 Mi allreduce
   hierarchical, fp8 inter and the flat ring: device ms behind a GPU
   sleep, library ms, idle share, kernels by family, launches. 13d
   ``verify_integrity`` (W verifications a logical call, a forced
   mismatch on rank 1 failing every rank naming [1], the time of
   ``fingerprint_of`` on 256 MiB with its read-back and crc32 apart).
   13e ``preflight``, ``set_max_segment_size``, a custom arith registry
   entry, ``plan_cache_stats``. 13c the card's own link figures
   (``CudaDevice.topology()``: the host floor of a 1-element allreduce,
   the copy rate of an exchange round), then a shared ``Tuner`` over
   ``MeshTopology.from_hosts`` with epsilon 0: AUTO allreduces with
   ``compress_dtype="auto"`` at 1 Ki, 64 Ki, 4 Mi and 64 Mi a rank, the
   route, wire and block each equal to a fresh Tuner's and within its
   bound, ``describe()`` after the measured calls, and one AUTO
   allreduce under the card's own topology. B1, B5, B6 and B7 must
   launch.

14. The driver's observability, tenants, the tuning table and DDP.
   14a-14c (after 13; their lines print when they end): 14a on
   ``cuda_world(8, algorithm="ring")`` at 64 Mi fp32 a rank, under
   ``start_profiling``: the fp32 ring, the fp8-e4m3 block-128 ring and
   the 2 x 4 hierarchical allreduce; one ``CallRecord`` a call issued on
   every rank, the HIERARCHICAL record tagged as its phases, the table
   and summary; each call's record (issue to enqueue: host time) beside
   its device ms behind a GPU sleep and library ms; the armed flight
   recorder over a ``verify_integrity`` allreduce and a recv retried
   under ``retries=3``, exported as Chrome JSON whose kinds include
   ``fingerprint`` and ``call_retry``, its first deadline dumping the
   recorder (``recv_deadline_abort``); ``metrics_text`` parsed as
   Prometheus text, every ``accl_calls_total`` row with a ``tenant``
   label; ``measure_call_latency``; a 1-element allreduce's library time
   with the hooks off, the profiler on and the trace armed. 14b
   ``cuda_world(8)`` and ``add_tenant(..., "tenant-b", key=1)`` on the
   same devices: interleaved async 64 Mi fp32 ring allreduces of both,
   each bitwise its plain version, ``accl_calls_total`` and the records
   split per tenant, an invalid label refused with the reference's
   message. 14c ``tuner.sweep.run_tune`` on ``cuda_world(8)`` over the
   reference's six ops at 1 Ki, 64 Ki, 4 Mi and 64 Mi f32 a rank, 3
   reps, every window closed by a device synchronize, the sources seeded
   random, the first warm-up of each (op, algorithm, wire) bitwise the
   same call through the plain versions; the table and rows
   written under ``build/``, loaded into a fresh Tuner through
   ``tuner/cache.py``, AUTO at every swept size resolving to the chosen
   row (and running it through a world's drivers); the forced and chosen
   rows printed beside phase 13c's prediction. B1, B5, B6 and B7 must
   launch in 14a and 14c, B1 in 14b. 14d (after phase 9, before 10a,
   under the same 2 GiB check): Llama-3-8B width, 4 of 32 layers, f32
   parameters, bf16 activations, ``make_ddp_train_step`` over a dp = 2
   ``RankMesh`` with one 2048-token sequence a rank, Adam lr 1e-4, the
   reference's 25 MiB buckets (``Llama.grad_buckets``): every bucket's
   ring all-reduce bitwise the plain kernels' on the same rows on the
   fp32 and bf16 wires; the ring, flatten, average and scatter timed; 4
   steps on the fp32 wire and 2 on the bf16 wire, the first loss within
   1e-2 of the full-batch loss, falling; before the first update every
   leaf's averaged gradient within 1e-2 relative L2 of the full batch's
   backward, after it a strided sample of each leaf Adam's first step on
   those gradients; B1, B2, B8, B10 and B11 launch on path ``ddp``.

15. The Mixtral-style MoE Llama, expert parallelism and the pipeline
   (after 14d, before 10a; each part under the 2 GiB check, its model
   freed before the next). The configuration is Mixtral-8x7B's published
   widths (``mixtral_8x7b``: vocab 32000, dim 4096, 32/8 heads, ffn
   14336, 8 experts, top 2, rope_theta 1e6), routed as the reference
   routes (capacity factor 1.25, drops, aux 0.01), random weights from
   the seed. 15a serving, 16 of 32 layers, bf16: ``generate(max_new=32)``
   for four 1024-token prompts, a 4 x 1024 ``forward`` (B8) and a 4 x
   512 one (B9), B8/B9/B12 launches counted (path ``moe_serving``), every
   bf16 launch on the tensor-core route; each pass against the plain
   route (attention="dense", the same weights) and the prefill against
   the forward: the share of tokens whose experts or drops differ in
   some layer (bound MOE_FLIP_MAX) and the other tokens' logits within
   SERVE_DENSE_REL; a decode step drops nothing; prefill and forward
   tokens/s, decode ms a step, busy share and kernels by family
   (``expert_gemm`` and ``route`` told apart by profiler ranges), one
   layer's MoE pieces on CUDA events, peak memory. 15b training, 2 of
   32 layers, f32 parameters and bf16 activations, (2, 2048), Adam:
   step 0's gradients of the kernel route, the bf16 plain route and the
   f32 plain route (the plain passes replaying the kernel pass's expert
   choices), every leaf's kernel-route distance from f32 within
   MOE_GRAD_RATIO times the bf16 plain route's; 3 steps that fall, B8,
   B10 and B11 once a layer a step (path ``moe_training``), step ms,
   tokens/s, peak memory. 15c one Mixtral-width ``MoELayer`` (f32
   parameters, bf16 compute) over ep = 8 virtual ranks of 2048 tokens:
   against the per-rank dense layer with the same capacity (MOE_EP_REL),
   both alltoalls' rows bitwise the plain exchange, their device ms
   beside the expert GEMMs'. 15d ``pipeline_sharded`` over pp = 4 stages
   of ``x + MoELayer.apply_dense(x)``, 8 microbatches of 512 tokens:
   bitwise the stages in sequence, W * n_micro stage calls, device ms
   beside the sequence's.

16. Checkpoint/resume, the multi-slice tier, sequence parallelism with
   experts and the dry run (after 15, before 10a). 16a (under the 2 GiB
   check): Llama-3-8B widths cut to 1 of 32 layers (15.2 GB of f32
   parameters and Adam moments on disk), bf16 activations, (2, 2048),
   Adam: step 1, ``CheckpointManager.save`` under ``build/`` (the free
   space printed beside the state's bytes; a shortfall fails), steps 2
   and 3; the unbroken run twice, to learn whether a step repeats itself
   bitwise; the checkpoint restored into a model and optimizer from
   another seed, every tensor's crc32 equal to the save's, steps 2 and 3
   again, the losses bitwise the unbroken run's (or within the two
   unbroken runs' spread, the varying parameters named); one flipped byte
   of the largest file refused with DATA_INTEGRITY_ERROR; save, verify and
   restore seconds and GB/s; B8, B10 and B11 launch (path checkpoint).
   16b: ``hybrid_mesh((4,), 2)`` on the card, 64 Mi f32 a rank:
   ``hierarchical_allreduce_sharded`` for SUM, MAX, MIN, PROD and SUM on
   a bf16 dcn wire, and ``multi_axis_ring_allreduce`` on a (2, 2, 2) mesh
   (64 Mi cut to a multiple of 24), each bitwise the same call through
   ``kernels=PLAIN``, its hop strides {1, 2, 4}; device ms behind a GPU
   sleep, the bound, a call's host ms and the library call over the rank
   axis; B1 and B2 launch (path multislice). 16c: two processes of this
   script (``--slice-child``) on the card, one slice each, over gloo on
   a port the OS picked: SUM and the bf16 wire, each process's rows equal
   16b's (sha256), a 120 s timeout; B1 and B2 launch in them (path
   multiprocess). 16d (inside 15a, on its 16-layer model): an sp = 8
   ``forward`` of the 4 x 1024 prompts over a (1, 8) ("dp", "sp") mesh
   beside the unsharded one, held with 15a's route checks; host ms and
   tokens/s (path sp_moe). 16e: ``dryrun_multichip(8)`` on the card, its
   seven checks' seconds (path dryrun).

Each phase starts with a line of the device memory allocated.

Prints per-kernel and per-call lines, then one JSON line of kernel
records, then ``{"ok": true, "device": {...}}`` as the last line. Any
failure raises: the exit code is then not 0 and no result line prints.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import zlib

import numpy as np

W = 8                      # ranks
N = 64 << 20               # fp32 elements per rank (256 MiB)
QBLOCK = 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
TF32_OPS_PER_S = 495e12    # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
SEED = 20261016
T_START = time.perf_counter()   # the phase lines' clock
# tests/test_pallas_quant.py holds the W=4 quantized allreduce within
# 0.07 * max(sum_r |x_r|) + 1e-3: an allreduce quantizes each element W
# times (W-1 on the reduce-scatter, once for the allgather), so per
# quantization that is 0.07 / 4 of max(sum_r |x_r|)
FP8_BOUND_PER_QUANT = 0.07 / 4
ROOT = 3                   # bcast / scatter / gather
REDUCE_ROOT = 5
# per-tensor wires: unit roundoff u (half an ulp at 1), and the largest
# absolute error of one rounding in the wire's denormal range, in units
# of the payload's scale (1 for a pure cast; amax / fp8_max for the
# scaled fp8 codec)
WIRE_U = {"float16": 2.0 ** -11, "bfloat16": 2.0 ** -8,
          "float8_e4m3fn": 2.0 ** -4, "float8_e5m2": 2.0 ** -3}
WIRE_DENORMAL = {"float16": 2.0 ** -25, "bfloat16": 0.0,
                 "float8_e4m3fn": 2.0 ** -10, "float8_e5m2": 2.0 ** -17}
FP8_MAX = {"float8_e4m3fn": 448.0, "float8_e5m2": 57344.0}


CARD = ""                  # nvidia-smi's "name, power limit", phase 1


class SmokeFailure(RuntimeError):
    pass


def need(cond, what: str):
    if not cond:
        raise SmokeFailure(what)


HEAD_START_CYCLES = 50_000_000   # ~25 ms of GPU sleep at the H100's clock
# ahead of one p2p call of phase 4b, whose host part takes 10-30 ms
CALL_HEAD_START_CYCLES = 400_000_000


def time_ms(fn, reps: int = 20, warmup: int = 3,
            head_start: int = HEAD_START_CYCLES) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call).
    The calls are enqueued behind a GPU sleep of ``head_start`` cycles
    (``HEAD_START_CYCLES``), so the host runs ahead of the device and
    each event pair times the kernels alone, not the host's Python
    between two short launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(head_start)
    evs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        evs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def bound_ms(nbytes: int, nops: int,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def same_bits(a, b) -> tuple[bool, float]:
    """(bitwise equal with NaN matching NaN, max |a-b| over non-NaN)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False, float("inf")
    if a.element_size() == 1:           # fp8 and int8 codes: as bytes
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            return False, float("inf")
        ia = a.masked_fill(na, 0).contiguous()
        ib = b.masked_fill(nb, 0).contiguous()
        iv = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[a.element_size()]
        eq = torch.equal(ia.view(iv), ib.view(iv))
        fin = torch.isfinite(ia) & torch.isfinite(ib)
        d = (ia.double() - ib.double()).abs()[fin]
        err = float(d.max()) if d.numel() else 0.0
        return eq, err
    eq = torch.equal(a, b)
    return eq, float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def check_rows(got, ref, what: str) -> float:
    worst = 0.0
    for g, r in zip(got, ref):
        eq, err = same_bits(g, r)
        need(eq, f"{what}: kernel and plain version differ "
                 f"(max abs err {err})")
        worst = max(worst, err)
    return worst


def edge_corpus(rng, n: int) -> np.ndarray:
    x = (rng.standard_normal(n).astype(np.float32)
         * np.float32(10.0) ** rng.integers(-24, 24, n).astype(np.float32))
    specials = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40, -3e-42,
                         500.0, -1e5, 7e4, 448.0, 57344.0, 6e4] * 8,
                        np.float32)
    x[:specials.size] = specials
    rng.shuffle(x)
    x[:4096] = 0.0                      # an all-zero block at every size
    return x


# -- phases ------------------------------------------------------------------

def phase_device():
    import torch
    need(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    need(smi.returncode == 0 and smi.stdout.strip(),
         f"nvidia-smi failed: {smi.stderr.strip()}")
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)                                  # name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    from accl_tpu_torch import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds})")
    regs = [ln.strip() for ln in _build.build_log.splitlines()
            if "registers" in ln]
    spills = [ln.strip() for ln in _build.build_log.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")
              and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    print(f"ptxas: {len(regs)} kernels; spill lines: {len(spills)}")
    for ln in spills[:5]:
        print(f"  {ln}")


def corpus_combine(rng):
    import torch
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.ops.combine import combine, combine_ref
    n = 100_003
    for dtype in (torch.float32, torch.float16, torch.bfloat16,
                  torch.float64, torch.int32, torch.int64, torch.int8):
        for func in ReduceFunc:
            rows_a, rows_b = [], []
            for _ in range(3):
                if dtype.is_floating_point:
                    a = torch.from_numpy(edge_corpus(rng, n)).to(dtype)
                    b = torch.from_numpy(edge_corpus(rng, n)).to(dtype)
                else:
                    info = torch.iinfo(dtype)
                    a = torch.from_numpy(rng.integers(
                        info.min, info.max, n)).to(dtype)
                    b = torch.from_numpy(rng.integers(
                        info.min, info.max, n)).to(dtype)
                rows_a.append(a.cuda())
                rows_b.append(b.cuda())
            ref = combine_ref(rows_a, rows_b, func)
            check_rows(combine(rows_a, rows_b, func), ref,
                       f"combine {dtype} {func.name}")
            # unaligned rows (scalar path) and in place (out aliases a)
            ua = [r[1:] for r in rows_a]
            ub = [r[1:] for r in rows_b]
            check_rows(combine(ua, ub, func), combine_ref(ua, ub, func),
                       f"combine {dtype} {func.name} unaligned")
            combine(rows_a, rows_b, func, out=rows_a)
            check_rows(rows_a, ref, f"combine {dtype} {func.name} in place")
    print("combine: edge corpus bitwise over 7 dtypes x 4 funcs (fp8: "
          "every code pair in phase 3b)")


def corpus_codec(rng):
    import torch
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.ops import compression as C
    n = 3 * 4096 + 1001                 # ragged for every block size
    for wire in ("int8", "float8_e4m3fn", "float8_e5m2"):
        for block in (32, 128, 4096):
            xs = [torch.from_numpy(edge_corpus(rng, n)).cuda()
                  for _ in range(3)]
            q, s = C.bs_quant(xs, wire, block)
            rq, rs = C.bs_quant_ref(xs, wire, block)
            check_rows(q, rq, f"bs_quant codes {wire}/{block}")
            check_rows(s, rs, f"bs_quant scales {wire}/{block}")
            check_rows(C.bs_dequant(q, s, wire, block),
                       C.bs_dequant_ref(q, s, wire, block),
                       f"bs_dequant {wire}/{block}")
            for func in ReduceFunc:
                others = [torch.from_numpy(edge_corpus(rng, n)).cuda()
                          for _ in range(3)]
                q2, s2 = C.bs_combine(q, s, others, func, wire, block)
                rq2, rs2 = C.bs_combine_ref(q, s, others, func, wire, block)
                what = f"bs_combine {wire}/{block} {func.name}"
                check_rows(q2, rq2, what + " codes")
                check_rows(s2, rs2, what + " scales")
                check_rows(C.bs_combine(q, s, others, func, wire, block,
                                        requant=False),
                           C.bs_combine_ref(q, s, others, func, wire, block,
                                            requant=False),
                           what + " f32")
    print("bs codec: edge corpus bitwise over 3 wires x 3 blocks "
          "(x 4 funcs for bs_combine)")


LANE_WIRES = ("float16", "bfloat16", "float8_e4m3fn", "float8_e5m2")


def corpus_lanes(rng):
    """B2-B4 over the edge corpus, unaligned rows, every code, and
    payloads whose amax is NaN, 0, tiny or huge."""
    import torch
    from accl_tpu_torch.ops import compression as C
    n = 3 * 4096 + 1001
    for wire in LANE_WIRES:
        dt = getattr(torch, wire)
        xs = [torch.from_numpy(edge_corpus(rng, n)).cuda() for _ in range(3)]
        down = C.cast(xs, dt)
        check_rows(down, C.cast_ref(xs, dt), f"cast f32->{wire}")
        check_rows(C.cast(down, torch.float32),
                   C.cast_ref(down, torch.float32), f"cast {wire}->f32")
        ua = [x[1:] for x in xs]
        check_rows(C.cast(ua, dt), C.cast_ref(ua, dt),
                   f"cast f32->{wire} unaligned")
        bits = 8 if dt.itemsize == 1 else 16
        codes = torch.arange(1 << bits, device="cuda").to(
            torch.uint8 if bits == 8 else torch.int32)
        if bits == 16:
            codes = (codes - (codes >= 1 << 15).int() * (1 << 16)).to(
                torch.int16)
        every = [codes.view(dt)]
        check_rows(C.cast(every, torch.float32),
                   C.cast_ref(every, torch.float32), f"cast every {wire}")
        if wire not in C.FP8_DTYPE_NAMES:
            continue
        clean = torch.from_numpy(edge_corpus(rng, n)).cuda()
        clean = torch.where(torch.isfinite(clean), clean,
                            torch.zeros_like(clean))
        rows = [xs[0], clean, torch.zeros(n, device="cuda"),
                clean * 1e-30, clean * 1e-38, clean[:1].expand(n) + 0]
        s, inv = C.fp8_scale(rows, wire)
        rs, rinv = C.fp8_scale_ref(rows, wire)
        check_rows(s, rs, f"fp8_scale {wire} scales")
        check_rows(inv, rinv, f"fp8_scale {wire} inverses")
        q = C.fp8_quant(rows, inv, wire)
        check_rows(q, C.fp8_quant_ref(rows, inv, wire), f"fp8_quant {wire}")
        check_rows(C.fp8_dequant(q, s, wire),
                   C.fp8_dequant_ref(q, s, wire), f"fp8_dequant {wire}")
        uq = C.fp8_quant([r[3:] for r in rows], inv, wire)
        check_rows(uq, C.fp8_quant_ref([r[3:] for r in rows], inv, wire),
                   f"fp8_quant {wire} unaligned")
        check_rows(C.fp8_dequant(uq, s, wire),
                   C.fp8_dequant_ref(uq, s, wire),
                   f"fp8_dequant {wire} unaligned")
    print("wire lanes: edge corpus bitwise over 4 wires (casts both ways, "
          "every code; fp8 scale/quant/dequant incl. NaN, zero, tiny and "
          "unaligned rows)")


COMBINE_DTYPES = ("float32", "float16", "bfloat16", "float64", "int32",
                  "int64", "int8", "float8_e4m3fn", "float8_e5m2")
CAST_PAIRS = tuple((a, b) for w in LANE_WIRES
                   for a, b in (("float32", w), (w, "float32")))
EDGE_ROWS = (1, 7, 8, 32, 33)        # 33: two launches of 32 and 1 row


# B1's and B2's tiles (csrc/stream.cuh: STREAM_THREADS thread-steps a
# block; a step is 16 bytes of each B1 operand, CAST_STEP elements of B2)
STREAM_THREADS = 256
CAST_STEP = 4


def combine_step(itemsize: int) -> int:
    """Elements of one B1 thread-step: a 16-byte vector."""
    return 16 // itemsize


def edge_lengths(vec: int, tile: int, rows: int) -> list:
    """Row lengths at the tiles' edges: 0, 1, one vector step - 1, one
    tile - 1, one tile, one tile + 1, and one that gives a launch of
    ``rows`` rows more blocks than the card holds at once (132 SMs of at
    most 8 such blocks) with a ragged last tile."""
    return [0, 1, vec - 1, tile - 1, tile, tile + 1,
            (2048 // rows + 1) * tile - 3]


def stream_operands(make, nrows: int, n: int, shift: int = 0):
    """``nrows`` rows of ``n`` elements as views into one buffer, as the
    ring's chunks are (a row is 16-byte aligned only where its offset
    is), each starting ``shift`` elements into its slot."""
    buf = make((nrows, n + shift))
    return [r[shift:] for r in buf]


def edge_values(rng, shape):
    """f32 edge-corpus values of ``shape`` on the card, at any size: the
    tail of a corpus longer than its leading zero block."""
    import torch
    n = shape[0] * shape[1]
    x = edge_corpus(rng, n + 8192)[8192:]
    return torch.from_numpy(x).cuda().view(shape)


def stream_edges(rng):
    """B1 and B2 at the edges of their tiles (csrc/stream.cuh), bitwise
    against their plain versions: row lengths 0, 1, one vector step - 1,
    one tile - 1, one tile, one tile + 1 and one past what the card
    holds at once; nrows 1, 7, 8, 32 and 33 (two launches); rows whose
    second operand (B1) or output (B2) is one element off; out aliasing
    a and aliasing b."""
    import torch
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.ops import compression as C
    from accl_tpu_torch.ops.combine import combine, combine_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cases = 0
    for di, name in enumerate(COMBINE_DTYPES):
        dt = getattr(torch, name)
        vec = combine_step(dt.itemsize)

        def make(shape, dt=dt):
            if dt.itemsize == 1 and dt.is_floating_point:   # every code
                return torch.randint(0, 1 << 8, shape, dtype=torch.uint8,
                                     device="cuda", generator=gen).view(dt)
            if dt.is_floating_point:
                return edge_values(rng, shape).to(dt)
            info = torch.iinfo(dt)
            return torch.randint(info.min, info.max, shape, dtype=dt,
                                 device="cuda", generator=gen)

        for ni, nrows in enumerate(EDGE_ROWS):
            func = ReduceFunc((di + ni) % 4)
            for n in edge_lengths(vec, STREAM_THREADS * vec, min(nrows, 32)):
                what = f"combine edge {name} {func.name} {nrows}x{n}"
                a = stream_operands(make, nrows, n)
                b = stream_operands(make, nrows, n, shift=1)
                ref = combine_ref(a, b, func)
                check_rows(combine(a, b, func), ref, what)
                a2 = [t.clone() for t in a]
                combine(a2, b, func, out=a2)
                check_rows(a2, ref, what + " out=a")
                b2 = [t.clone() for t in b]
                combine(a, b2, func, out=b2)
                check_rows(b2, ref, what + " out=b")
                cases += 1
    for src, dst in CAST_PAIRS:
        sdt, ddt = getattr(torch, src), getattr(torch, dst)

        def make(shape, sdt=sdt):
            if sdt == torch.float32:
                return edge_values(rng, shape)
            if sdt.itemsize == 1:           # every code, NaNs included
                return torch.randint(0, 1 << 8, shape, dtype=torch.uint8,
                                     device="cuda", generator=gen).view(sdt)
            return torch.randint(-(1 << 15), 1 << 15, shape,
                                 dtype=torch.int16, device="cuda",
                                 generator=gen).view(sdt)

        for nrows in EDGE_ROWS:
            for n in edge_lengths(CAST_STEP, STREAM_THREADS * CAST_STEP,
                                  min(nrows, 32)):
                what = f"cast edge {src}->{dst} {nrows}x{n}"
                x = stream_operands(make, nrows, n)
                ref = C.cast_ref(x, ddt)
                check_rows(C.cast(x, ddt), ref, what)
                y = stream_operands(lambda shape: torch.empty(
                    shape, dtype=ddt, device="cuda"), nrows, n, shift=1)
                check_rows(C.cast(x, ddt, y), ref, what + " output off")
                cases += 1
    print(f"stream edges: B1 and B2 bitwise over {cases} (dtype or lane "
          f"pair, nrows, length) cases, aligned, one element off and in "
          f"place")


# B7's tiles (csrc/bs_codec.cu: BS_THREADS thread-steps of BS_STEP
# elements a block, S = block / tile steps a thread where a scale block is
# larger than one step of every thread, so that a tile holds whole scale
# blocks); every block size the codec takes, its three amax reductions
# (shuffles within a warp, shared memory, several steps a thread)
BS_THREADS = 256
BS_STEP = 4
BS_BLOCKS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
BS_WIRES = ("int8", "float8_e4m3fn", "float8_e5m2")
# where the rows lie: all at their slots; `other` one element off (its
# scalar path); the code rows in and out one byte off
BS_LAYOUTS = ("aligned", "other off", "codes off")
# what block 0 of a row holds, rotated over the rows: the edge values as
# they are; an amax that is NaN, inf, 0 or an f32 denormal (the scale
# falls back to 1, the integer encoder); a scale just above FLT_MIN (the
# largest inverse the hardware conversion meets); the wire's rounding
# ties at scale 1
BS_KINDS = (None, "nan", "inf", "zero", "denormal", "tiny", "ties")
# values halfway between two codes of each wire at scale 1, the wire's
# denormal range included (qmax itself sits in the block to fix s = 1),
# and f32 denormals of either sign (codes +-0)
BS_TIES = {"int8": (0.5, 1.5, 2.5, -2.5, 126.5, -0.5, -1e-40),
           "float8_e4m3fn": (1.0625, 1.1875, -1.0625, 2.0 ** -10,
                             3 * 2.0 ** -10, -(2.0 ** -10), 432.0, 232.0,
                             -1e-40, 3e-42),
           "float8_e5m2": (1.125, 1.375, -1.125, 2.0 ** -17, 3 * 2.0 ** -17,
                           -(2.0 ** -17), 53248.0, 26624.0, -1e-40, 3e-42)}


def bs_tile(block: int) -> int:
    """Elements of one B7 tile: one step of every thread, or one scale
    block where that is larger."""
    return max(BS_THREADS * BS_STEP, block)


def bs_edge_lengths(block: int) -> list:
    """Row lengths at B7's edges: 0, 1, 3 (less than one step), one
    scale block - 1, + 0 and + 1, one tile - 1, + 0 and + 1."""
    tile = bs_tile(block)
    return sorted({0, 1, 3, block - 1, block, block + 1, tile - 1, tile,
                   tile + 1})


def bs_edge_cases() -> list:
    """(wire, block, nrows, n, func, layout) of B7's tile-edge check:
    every wire, block size, row count and edge length; the four funcs
    and the layouts rotated over them, as ``stream_edges`` rotates its
    funcs. Each case runs both modes (requant and round-closing)."""
    cases = []
    for wi, wire in enumerate(BS_WIRES):
        for bi, block in enumerate(BS_BLOCKS):
            for ni, nrows in enumerate(EDGE_ROWS):
                for li, n in enumerate(bs_edge_lengths(block)):
                    cases.append((wire, block, nrows, n,
                                  (wi + bi + ni + li) % 4,
                                  BS_LAYOUTS[(ni + li) % len(BS_LAYOUTS)]))
    return cases


def bs_edge_payload(rng, wire: str, block: int, nrows: int, n: int,
                    salt: int, device: str = "cuda"):
    """The f32 rows that are quantized into the received codes, and the
    local ``other`` rows, (nrows, n) edge values on ``device``; block 0
    of row r holds BS_KINDS[(r + salt) % len(BS_KINDS)] in ``other``,
    over a payload of zeros (codes 0: the combined value is func(other,
    0))."""
    import torch
    from accl_tpu_torch.quant import _FLT_MIN, _QMAX
    x, other = (edge_corpus(rng, nrows * n + 8192)[8192:].reshape(nrows, n)
                for _ in range(2))
    b = min(block, n)
    for r in range(nrows if b else 0):
        kind = BS_KINDS[(r + salt) % len(BS_KINDS)]
        if kind is None:
            continue
        x[r, :b] = 0.0
        mag = rng.uniform(1.0, 2.0, b) * rng.choice([-1.0, 1.0], b)
        if kind == "nan":
            other[r, b // 2] = np.nan
        elif kind == "inf":
            other[r, b - 1] = -np.inf
        elif kind == "zero":
            other[r, :b] = 0.0
        elif kind == "denormal":
            other[r, :b] = mag * 1e-40
        elif kind == "tiny":
            other[r, :b] = mag * (_FLT_MIN * _QMAX[wire])
        else:
            ties = BS_TIES[wire]
            other[r, :b] = [ties[i % len(ties)] for i in range(b)]
            other[r, 0] = _QMAX[wire]
    return (torch.from_numpy(x).to(device), torch.from_numpy(other).to(device))


def bs_edges(rng):
    """B7 at the edges of its tiles (csrc/bs_codec.cu), bitwise against
    ``bs_combine_ref`` in both modes (``bs_edge_cases``): outputs in
    buffers of their own, with guard bytes around every row that must
    stay as they were."""
    import torch
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.ops import compression as C
    from accl_tpu_torch.quant import n_blocks
    cases = bs_edge_cases()
    for ci, (wire, block, nrows, n, func, layout) in enumerate(cases):
        func = ReduceFunc(func)
        what = f"bs_combine edge {wire}/{block} {func.name} {nrows}x{n} {layout}"
        nb = n_blocks(n, block)
        x, xo = bs_edge_payload(rng, wire, block, nrows, n, ci)
        q0, s = C.bs_quant(list(x), wire, block)
        qs = 1 if layout == "codes off" else 0
        xs = 1 if layout == "other off" else 0
        q = stream_operands(lambda shape: torch.empty(
            shape, dtype=torch.uint8, device="cuda"), nrows, n, shift=qs)
        other = stream_operands(lambda shape: torch.empty(
            shape, device="cuda"), nrows, n, shift=xs)
        for r in range(nrows):
            q[r].copy_(q0[r])
            other[r].copy_(xo[r])
        q2buf = torch.full((nrows, n + qs + 4), 0xA5, dtype=torch.uint8,
                           device="cuda")
        s2buf = torch.full((nrows, nb + 1), -7.5, device="cuda")
        obuf = torch.full((nrows, n + qs + 4), 12345.0, device="cuda")
        q2 = list(q2buf[:, qs:qs + n])
        s2 = list(s2buf[:, :nb])
        out = list(obuf[:, qs:qs + n])
        C.bs_combine(q, s, other, func, wire, block, q2, s2)
        C.bs_combine(q, s, other, func, wire, block, out=out, requant=False)
        rq2, rs2 = C.bs_combine_ref(q, s, other, func, wire, block)
        check_rows(q2, rq2, what + " codes")
        check_rows(s2, rs2, what + " scales")
        check_rows(out, C.bs_combine_ref(q, s, other, func, wire, block,
                                         requant=False), what + " f32")
        guard = torch.ones_like(q2buf, dtype=torch.bool)
        guard[:, qs:qs + n] = False
        need(bool((q2buf[guard] == 0xA5).all())
             and bool((s2buf[:, nb] == -7.5).all())
             and bool((obuf[guard] == 12345.0).all()),
             f"{what}: a store outside the rows")
    print(f"bs edges: B7 bitwise in both modes over {len(cases)} (wire, "
          f"block, nrows, length) cases, {len(BS_BLOCKS)} block sizes, "
          f"funcs and layouts ({', '.join(BS_LAYOUTS)}) rotated; amax NaN, "
          f"inf, 0, denormal, just above FLT_MIN and rounding ties")


def kernel_records():
    """Each kernel at the main path's shape (W rows of one 32 MiB ring
    chunk: the per-hop launch), against its plain version, timed."""
    import torch
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.ops import compression as C
    from accl_tpu_torch.ops.combine import combine, combine_ref
    g = torch.Generator(device="cuda").manual_seed(SEED)
    c = N // W
    nb = c // QBLOCK
    wire = "float8_e4m3fn"
    a = torch.randn(W, c, device="cuda", generator=g)
    b = torch.randn(W, c, device="cuda", generator=g)
    out = torch.empty_like(a)
    ra, rb, ro = list(a), list(b), list(out)
    recs = []

    def rec(name, source, replaces, err, ms, plain_ms, nbytes, nops,
            library_ms=None):
        bms, by = bound_ms(nbytes, nops)
        recs.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by,
                     "library_ms": library_ms})
        print(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"bound {bms:.4f} ms by {by}, {100 * bms / ms:.1f} % of it"
              + (f", library {library_ms:.4f} ms" if library_ms else "")
              + f"), max abs err vs plain {err}")

    copy_ms = time_ms(lambda: out.copy_(a))
    print(f"copy_ ceiling: {copy_ms:.4f} ms for 8 x 8 Mi f32 (bound "
          f"{bound_ms(8 * N, 0)[0]:.4f} ms)")

    def variant(ms, library_ms, nbytes):
        bms = bound_ms(nbytes, 0)[0]
        return {"ms": ms, "library_ms": library_ms, "bound_ms": bms,
                "pct_of_bound": 100 * bms / ms}

    err = check_rows(combine(ra, rb, ReduceFunc.SUM, out=ro),
                     combine_ref(ra, rb, ReduceFunc.SUM), "combine main")
    flat_a, flat_b = a.view(-1), b.view(-1)
    library_ms = time_ms(lambda: torch.add(flat_a, flat_b, out=flat_a))
    # out of place, as the ring calls it (parallel/collectives.py)
    rec("combine", "accl_tpu_torch/csrc/combine.cu",
        "accl_tpu/ops/combine.py:71", err,
        time_ms(lambda: combine(ra, rb, ReduceFunc.SUM, out=ro)),
        time_ms(lambda: combine_ref(ra, rb, ReduceFunc.SUM, out=ro)),
        3 * 4 * N, N, library_ms=library_ms)
    a16, b16 = a.bfloat16(), b.bfloat16()
    r16, s16 = list(a16), list(b16)
    check_rows(combine(r16, s16, ReduceFunc.SUM),
               combine_ref(r16, s16, ReduceFunc.SUM), "combine main bf16")
    f16a, f16b = a16.view(-1), b16.view(-1)
    # in place beside torch.add(out=a): the same call on the same bytes
    recs[-1]["variants"] = {
        "SUM float32 in place": variant(
            time_ms(lambda: combine(ra, rb, ReduceFunc.SUM, out=ra)),
            library_ms, 3 * 4 * N),
        "SUM bfloat16 in place": variant(
            time_ms(lambda: combine(r16, s16, ReduceFunc.SUM, out=r16)),
            time_ms(lambda: torch.add(f16a, f16b, out=f16a)), 3 * 2 * N)}
    recs[-1]["copy_ceiling_ms"] = copy_ms
    del a16, b16, r16, s16, f16a, f16b
    a.copy_(torch.randn(W, c, device="cuda", generator=g))

    q = list(torch.empty(W, c, dtype=torch.uint8, device="cuda"))
    s = list(torch.empty(W, nb, device="cuda"))
    C.bs_quant(ra, wire, QBLOCK, q, s)
    rq, rs = C.bs_quant_ref(ra, wire, QBLOCK)
    err = max(check_rows(q, rq, "bs_quant main codes"),
              check_rows(s, rs, "bs_quant main scales"))
    rec("bs_quant", "accl_tpu_torch/csrc/bs_codec.cu",
        "accl_tpu/ops/compression.py:358", err,
        time_ms(lambda: C.bs_quant(ra, wire, QBLOCK, q, s)),
        time_ms(lambda: C.bs_quant_ref(ra, wire, QBLOCK, q, s), reps=5),
        4 * N + N + 4 * N // QBLOCK, 4 * N)

    err = check_rows(C.bs_dequant(q, s, wire, QBLOCK, ro),
                     C.bs_dequant_ref(q, s, wire, QBLOCK), "bs_dequant main")
    rec("bs_dequant", "accl_tpu_torch/csrc/bs_codec.cu",
        "accl_tpu/ops/compression.py:382", err,
        time_ms(lambda: C.bs_dequant(q, s, wire, QBLOCK, ro)),
        time_ms(lambda: C.bs_dequant_ref(q, s, wire, QBLOCK, ro), reps=5),
        N + 4 * N // QBLOCK + 4 * N, N)

    q2 = list(torch.empty(W, c, dtype=torch.uint8, device="cuda"))
    s2 = list(torch.empty(W, nb, device="cuda"))
    C.bs_combine(q, s, rb, ReduceFunc.SUM, wire, QBLOCK, q2, s2)
    rq2, rs2 = C.bs_combine_ref(q, s, rb, ReduceFunc.SUM, wire, QBLOCK)
    err = max(check_rows(q2, rq2, "bs_combine main codes"),
              check_rows(s2, rs2, "bs_combine main scales"))
    rec("bs_combine", "accl_tpu_torch/csrc/bs_codec.cu",
        "accl_tpu/ops/compression.py:439", err,
        time_ms(lambda: C.bs_combine(q, s, rb, ReduceFunc.SUM, wire, QBLOCK,
                                     q2, s2)),
        time_ms(lambda: C.bs_combine_ref(q, s, rb, ReduceFunc.SUM, wire,
                                         QBLOCK, q2, s2), reps=5),
        2 * (N + 4 * N // QBLOCK) + 4 * N, 8 * N)
    # the ring's round-closing hop: f32 out, 9 bytes an element + scales
    check_rows(C.bs_combine(q, s, rb, ReduceFunc.SUM, wire, QBLOCK, out=ro,
                            requant=False),
               C.bs_combine_ref(q, s, rb, ReduceFunc.SUM, wire, QBLOCK,
                                requant=False), "bs_combine main f32")
    recs[-1]["variants"] = {"round-closing f32": variant(
        time_ms(lambda: C.bs_combine(q, s, rb, ReduceFunc.SUM, wire, QBLOCK,
                                     out=ro, requant=False)),
        None, 9 * N + 4 * N // QBLOCK)}
    del q, s, q2, s2, rq, rs, rq2, rs2

    h = list(torch.empty(W, c, dtype=torch.float16, device="cuda"))
    err = check_rows(C.cast(ra, torch.float16, h),
                     C.cast_ref(ra, torch.float16), "cast main")
    rec("cast", "accl_tpu_torch/csrc/wire_lanes.cu",
        "accl_tpu/ops/compression.py:65", err,
        time_ms(lambda: C.cast(ra, torch.float16, h)),
        time_ms(lambda: C.cast_ref(ra, torch.float16, h), reps=5),
        6 * N, N, library_ms=time_ms(lambda: flat_a.to(torch.float16)))
    del h
    variants = {}
    for wire in (torch.float16, torch.bfloat16, torch.float8_e4m3fn):
        low = torch.empty(W, c, dtype=wire, device="cuda")
        rl, flat_l = list(low), low.view(-1)
        nbytes = (4 + wire.itemsize) * N
        check_rows(C.cast(ra, wire, rl), C.cast_ref(ra, wire),
                   f"cast main f32->{wire}")
        check_rows(C.cast(rl, torch.float32, ro),
                   C.cast_ref(rl, torch.float32), f"cast main {wire}->f32")
        name = str(wire).split(".")[1]
        if wire != torch.float16:
            variants[f"float32->{name}"] = variant(
                time_ms(lambda: C.cast(ra, wire, rl)),     # noqa: B023
                time_ms(lambda: flat_a.to(wire)), nbytes)  # noqa: B023
        variants[f"{name}->float32"] = variant(
            time_ms(lambda: C.cast(rl, torch.float32, ro)),   # noqa: B023
            time_ms(lambda: flat_l.to(torch.float32)), nbytes)  # noqa: B023
        del low, rl, flat_l
    recs[-1]["variants"] = variants
    recs[-1]["copy_ceiling_ms"] = copy_ms
    for r in recs:
        for k, v in r.get("variants", {}).items():
            lib = v["library_ms"]
            print(f"kernel {r['name']} {k}: {v['ms']:.4f} ms ("
                  + (f"library {lib:.4f} ms, " if lib else "")
                  + f"bound {v['bound_ms']:.4f} ms, "
                  f"{v['pct_of_bound']:.1f} % of bound)")

    sc = list(torch.empty(W, 1, device="cuda"))
    iv = list(torch.empty(W, 1, device="cuda"))
    C.fp8_scale(ra, wire, sc, iv)
    rsc, riv = C.fp8_scale_ref(ra, wire)
    err = max(check_rows(sc, rsc, "fp8_scale main scales"),
              check_rows(iv, riv, "fp8_scale main inverses"))
    rec("fp8_scale", "accl_tpu_torch/csrc/wire_lanes.cu",
        "accl_tpu/ops/compression.py:149", err,
        time_ms(lambda: C.fp8_scale(ra, wire, sc, iv)),
        time_ms(lambda: C.fp8_scale_ref(ra, wire, sc, iv), reps=5),
        4 * N + 8 * W, 2 * N)

    q8 = list(torch.empty(W, c, dtype=torch.float8_e4m3fn, device="cuda"))
    err = check_rows(C.fp8_quant(ra, iv, wire, q8),
                     C.fp8_quant_ref(ra, iv, wire), "fp8_quant main")
    rec("fp8_quant", "accl_tpu_torch/csrc/wire_lanes.cu",
        "accl_tpu/ops/compression.py:154", err,
        time_ms(lambda: C.fp8_quant(ra, iv, wire, q8)),
        time_ms(lambda: C.fp8_quant_ref(ra, iv, wire, q8), reps=5),
        5 * N + 4 * W, N)

    err = check_rows(C.fp8_dequant(q8, sc, wire, ro),
                     C.fp8_dequant_ref(q8, sc, wire), "fp8_dequant main")
    rec("fp8_dequant", "accl_tpu_torch/csrc/wire_lanes.cu",
        "accl_tpu/ops/compression.py:175", err,
        time_ms(lambda: C.fp8_dequant(q8, sc, wire, ro)),
        time_ms(lambda: C.fp8_dequant_ref(q8, sc, wire, ro), reps=5),
        5 * N + 4 * W, N)
    del a, b, out, ra, rb, ro, q8, sc, iv, rsc, riv
    torch.cuda.empty_cache()
    return recs


FP8_PAYLOADS = ("float8_e4m3fn", "float8_e5m2")


def fp8_payload_phase(recs):
    """3b: B1 on fp8 payloads (``csrc/fp8_hw.cuh``). For each format:
    every one of the 65,536 code pairs (a the codes repeated, b the codes
    tiled, as ``tests/test_torch_fp8_payload.py`` builds them) as W rank
    rows of one launch, under SUM, MAX, MIN and PROD, out of place and
    with ``out`` aliasing a, bitwise against the plain version. Then the
    format's row of the kernels line at phase 3's shape (W rows of one 8
    Mi ring chunk: one ring hop's launch, random codes, NaN codes
    included): the four functions bitwise against the plain version and
    each timed beside the bound (3 bytes an element); the row's ``ms`` is
    SUM's, beside the plain version and torch.add where it takes fp8.
    Then the path: a W-rank ring allreduce at 64 Mi fp8 a rank
    (``RankCollectives``, every hop one B1 launch) bitwise the same call
    through the plain versions, with the counts set to 0 just before it
    and read just after."""
    import torch
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.ops.combine import combine, combine_ref
    from accl_tpu_torch.parallel.collectives import PLAIN, RankCollectives
    from accl_tpu_torch.parallel.mesh import RankGroup
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    c = N // W
    every = torch.arange(256, dtype=torch.uint8, device="cuda")
    for name in FP8_PAYLOADS:
        dt = getattr(torch, name)

        def codes(shape):
            return torch.randint(0, 256, shape, dtype=torch.uint8,
                                 device="cuda", generator=g).view(dt)

        pa = list(every.repeat_interleave(256).view(dt).view(W, -1))
        pb = list(every.repeat(256).view(dt).view(W, -1))
        for func in ReduceFunc:
            want = combine_ref(pa, pb, func)
            n0 = combine.launches
            check_rows(combine(pa, pb, func), want,
                       f"combine {name} {func.name} every code pair")
            ia = [r.clone() for r in pa]
            combine(ia, pb, func, out=ia)
            check_rows(ia, want,
                       f"combine {name} {func.name} every code pair in place")
            need(combine.launches - n0 == 2,
                 f"combine {name}: {W} rows took "
                 f"{combine.launches - n0} launches for 2 calls")
        print(f"combine {name}: every code pair ({W} rows x {256 * 256 // W}"
              f" in one launch) bitwise the plain version under SUM, MAX, "
              f"MIN and PROD, out of place and in place")
        a, b = codes((W, c)), codes((W, c))
        ra, rb = list(a), list(b)
        out = list(torch.empty_like(a))
        err = 0.0
        for func in ReduceFunc:
            err = max(err, check_rows(combine(ra, rb, func, out=out),
                                      combine_ref(ra, rb, func),
                                      f"combine {name} {func.name} main"))
        try:
            fa, fb = a.view(-1), b.view(-1)
            torch.add(fa, fb)
            library_ms = time_ms(lambda: torch.add(fa, fb))  # noqa: B023
        except (RuntimeError, NotImplementedError):
            library_ms = None             # torch.add takes no fp8 here
        bms, by = bound_ms(3 * N, N)
        by_func = {f.name: time_ms(lambda: combine(ra, rb, f, out=out))  # noqa: B023
                   for f in ReduceFunc}
        ms = by_func["SUM"]
        plain_ms = time_ms(lambda: combine_ref(ra, rb, ReduceFunc.SUM,  # noqa: B023
                                               out=out), reps=3)
        recs.append({"name": f"combine_{name.removeprefix('float8_')}",
                     "route": "cuda", "source": "accl_tpu_torch/csrc/combine.cu",
                     "replaces": "accl_tpu/ops/combine.py:71", "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bms, "bound_by": by,
                     "library_ms": library_ms, "ms_by_func": by_func})
        print(f"kernel combine {name} (8 x 8 Mi, SUM, MAX, MIN and PROD "
              f"bitwise the plain version): {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, bound {bms:.4f} ms by {by}, "
              f"{100 * bms / ms:.1f} % of it, library torch.add "
              + (f"{library_ms:.4f} ms" if library_ms else "takes no fp8")
              + f") ({CARD})")
        print(f"kernel combine {name} by function (8 x 8 Mi): "
              + ", ".join(f"{f} {t:.4f} ms ({100 * bms / t:.1f} % of the "
                          f"bound)" for f, t in by_func.items())
              + f" ({CARD})")
        del a, b, ra, rb, out
        # the path: a W-rank ring allreduce of fp8 payloads
        coll = RankCollectives(RankGroup(W, torch.device("cuda")))
        plain = RankCollectives(RankGroup(W, torch.device("cuda")), PLAIN)
        x = codes((W, N))
        combine.launches = 0
        got = coll.allreduce(x, ReduceFunc.SUM, "ring")
        torch.cuda.synchronize()
        n = combine.launches
        check_rows(got, plain.allreduce(x, ReduceFunc.SUM, "ring"),
                   f"fp8 ring allreduce {name}")
        need(n > 0, f"fp8 ring allreduce {name}: B1 never launched")
        recs[-1]["launches"] = n
        recs[-1]["launches_by_path"] = {"fp8_payload": n}
        dev_ms = time_ms(lambda: coll.allreduce(x, ReduceFunc.SUM, "ring"),  # noqa: B023
                         reps=3)
        print(f"fp8 ring allreduce {name}: {W} ranks x {N} a rank, bitwise "
              f"the plain versions, {n} B1 launches, device {dev_ms:.3f} ms "
              f"({CARD})")
        del x, got
        gc.collect()
        torch.cuda.empty_cache()


# kernel family <- a substring of the device kernel's name (first match)
FAMILIES = (("bs_quant", "bs_quant_kernel"),
            # the f32 band forms' passes past head dim 4096 (17a)
            ("attn_fwd_band_score", "attn_fwd_band_score_kernel"),
            ("attn_fwd_band_norm", "attn_fwd_band_norm_kernel"),
            ("attn_fwd_band_pv", "attn_fwd_band_pv_kernel"),
            ("attn_decode_band_score", "attn_decode_band_score_kernel"),
            ("attn_decode_band_pv", "attn_decode_band_pv_kernel"),
            ("bs_dequant", "bs_dequant_kernel"),
            ("bs_combine", "bs_combine_kernel"),
            ("combine", "combine_kernel"),
            ("cast", "cast_kernel"),
            ("fp8_scale", "amax_partial_kernel"),
            ("fp8_scale", "scale_finish_kernel"),
            ("fp8_quant", "fp8_quant_kernel"),
            ("fp8_dequant", "fp8_dequant_kernel"),
            ("attn_fwd_single", "attn_fwd_single_kernel"),
            # bf16 B9: its tensor-core kernel
            ("attn_fwd_single", "attn_fwd_single_wgmma_kernel"),
            ("attn_fwd", "attn_fwd_kernel"),
            # bf16 B8 and B12 prefill: the tensor-core route's one kernel
            ("attn_fwd_wgmma", "attn_fwd_wgmma_kernel"),
            ("attn_bwd_dkv", "attn_bwd_dkv_"),   # both routes' kernels
            ("attn_bwd_dq", "attn_bwd_dq_"),
            ("attn_decode", "attn_decode_kernel"),
            # single-token decode: the split-KV kernel
            ("attn_decode", "attn_decode_split_kernel"),
            ("optimizer", "multi_tensor_apply"),
            ("gemm", "gemm"), ("gemm", "gemv"), ("gemm", "nvjet"),
            ("gemm", "cutlass"), ("gemm", "xmma"),
            ("torch_reduce", "reduce_kernel"),
            ("copy", "copy"), ("copy", "Memcpy"), ("fill", "Memset"),
            ("fill", "Fill"))


def device_ms_by_family(fn, counts: dict | None = None) -> dict:
    """Device time in ms of the kernels ``fn`` runs, summed per family,
    from torch.profiler's CUDA activity; empty when it saw none. GPU-side
    user annotations (``Optimizer.step#Adam.step`` spans the optimizer's
    kernels) are ranges, not kernels, and are skipped. ``counts``, when
    given, receives the number of kernel records per family. Reads the
    trace's raw records, with the filters ``prof.events()`` applies, but
    without building its event tree (which took tens of seconds for a
    trace of 10^5 records)."""
    import torch
    from torch.autograd.profiler_util import _filter_name
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fams = collections.defaultdict(float)
    for ev in prof.profiler.kineto_results.events():
        if (ev.device_type() != torch.autograd.DeviceType.CUDA
                or ev.is_user_annotation() or _filter_name(ev.name())
                or getattr(ev, "is_hidden_event", lambda: False)()):
            continue
        fam = next((f for f, key in FAMILIES if key in ev.name()), "other")
        fams[fam] += ev.duration_ns() / 1e6
        if counts is not None:
            counts[fam] = counts.get(fam, 0) + 1
    return dict(fams)


def counters():
    from accl_tpu_torch.ops import combine
    from accl_tpu_torch.ops import compression as C
    return {"combine": combine, "bs_quant": C.bs_quant,
            "bs_dequant": C.bs_dequant, "bs_combine": C.bs_combine,
            "cast": C.cast, "fp8_scale": C.fp8_scale,
            "fp8_quant": C.fp8_quant, "fp8_dequant": C.fp8_dequant}


def add_path(recs, path: str, counts: dict):
    """Record a path's launches on the stream kernels' records."""
    for r in recs:
        if r["name"] in counts:
            r.setdefault("launches_by_path", {"collectives": r["launches"]})
            r["launches_by_path"][path] = counts[r["name"]]


def golden_bound(absum, k32: int, wire=None, kw: int = 0, amax=None):
    """Per-element bound on |result - float64 golden| for a result whose
    every intermediate value is at most sum_r |x_r| (``absum``) in
    magnitude and which took ``kw`` roundings to the wire dtype and
    ``k32`` f32 roundings: ((1+u)^kw (1+2^-24)^k32 - 1) * absum, plus
    ``kw`` times the wire's denormal-range error, which for the scaled
    fp8 codec is in units of its scale (``amax`` / fp8_max, amax grown
    by the same factor)."""
    u = WIRE_U[wire] if wire else 0.0
    grow = (1 + u) ** kw * (1 + 2.0 ** -24) ** k32
    floor = 0.0
    if wire:
        unit = 1.0 if amax is None else amax * grow / FP8_MAX[wire]
        floor = kw * WIRE_DENORMAL[wire] * unit
    return (grow - 1) * absum + floor


def main_path(recs):
    import torch
    from accl_tpu_torch import cuda_world
    from accl_tpu_torch.parallel.collectives import PLAIN, RankCollectives
    from accl_tpu_torch.parallel.tree import (Tree2DCollectives,
                                              gather_rounds, scatter_rounds)
    from accl_tpu_torch.testing import run_ranks
    c = N // W
    accls = cuda_world(W)            # device="cuda": no CPU fallback
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        xs = [torch.randn(N, device="cuda", generator=g) for _ in range(W)]
        ags = [torch.randn(c, device="cuda", generator=g) for _ in range(W)]
        bufs = {}

        def setup(a):
            r = a.rank

            def dev(n):
                return a.buffer((n,), torch.float32, device_resident=True)

            bufs[r] = {
                "src": a.buffer(data=xs[r]),
                "ar": dev(N), "rs": dev(c),
                "ag_src": a.buffer(data=ags[r]), "ag": dev(N), "bs": dev(N),
                "ar_f16": dev(N), "ar_bf16": dev(N), "ar_fp8": dev(N),
                "xla_fp8": dev(N),
                "bc": (a.buffer(data=xs[r].clone(), device_resident=True)
                       if r == ROOT
                       else dev(N)),
                "rd": dev(N) if r == REDUCE_ROOT else None,
                "sc": dev(c), "ga": dev(N) if r == ROOT else None,
                "a2a": dev(N),
            }
        run_ranks(accls, setup)

        def ring_wire(key, wire):
            return lambda a, b: a.allreduce(b["src"], b[key], N,
                                            algorithm="ring",
                                            compress_dtype=wire)

        calls = {
            "allreduce": lambda a, b: a.allreduce(
                b["src"], b["ar"], N, algorithm="ring"),
            "reduce_scatter": lambda a, b: a.reduce_scatter(
                b["src"], b["rs"], c, algorithm="ring"),
            "allgather": lambda a, b: a.allgather(
                b["ag_src"], b["ag"], c, algorithm="ring"),
            "allreduce_fp8bs": lambda a, b: a.allreduce(
                b["src"], b["bs"], N, algorithm="ring",
                compress_dtype=torch.float8_e4m3fn, block_scale=QBLOCK),
            "allreduce_f16": ring_wire("ar_f16", torch.float16),
            "allreduce_bf16": ring_wire("ar_bf16", torch.bfloat16),
            "allreduce_fp8": ring_wire("ar_fp8", torch.float8_e4m3fn),
            "allreduce_xla_fp8": lambda a, b: a.allreduce(
                b["src"], b["xla_fp8"], N,
                compress_dtype=torch.float8_e4m3fn),
            "bcast_bf16": lambda a, b: a.bcast(
                b["bc"], N, root=ROOT, compress_dtype=torch.bfloat16),
            "reduce": lambda a, b: a.reduce(
                b["src"], b["rd"], N, root=REDUCE_ROOT),
            "scatter_f16": lambda a, b: a.scatter(
                b["src"] if a.rank == ROOT else None, b["sc"], c, root=ROOT,
                compress_dtype=torch.float16),
            "gather_f16": lambda a, b: a.gather(
                b["ag_src"], b["ga"], c, root=ROOT,
                compress_dtype=torch.float16),
            "alltoall_fp8": lambda a, b: a.alltoall(
                b["src"], b["a2a"], c, compress_dtype=torch.float8_e4m3fn),
        }

        def drive(name):
            run_ranks(accls, lambda a: calls[name](a, bufs[a.rank]))

        torch.cuda.synchronize()
        cnt = counters()
        for k in cnt.values():
            k.launches = 0
        for name in calls:                       # the main path, once
            drive(name)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in cnt.items()}
        print(f"main path launches: {launches}")
        for r in recs:
            r["launches"] = launches[r["name"]]
            need(r["launches"] > 0,
                 f"kernel {r['name']} was never launched on the main path")

        # -- correctness ----------------------------------------------------
        plain = RankCollectives(accls[0].device.ctx.group, kernels=PLAIN)
        plain_tree = Tree2DCollectives.fold(plain)
        # a bf16 payload on an f16 wire (ROADMAP F2): the ring allreduce
        # of the rows cast to bf16, through the kernels (B2 widens, B2
        # down to f16 and back through f32, B1 in bf16) and through the
        # plain versions, bitwise
        kern = RankCollectives(accls[0].device.ctx.group)
        xb = [x.to(torch.bfloat16) for x in xs]
        cast0, comb0 = cnt["cast"].launches, cnt["combine"].launches
        got = kern.allreduce(xb, algorithm="ring", wire_dtype="float16")
        casts = cnt["cast"].launches - cast0
        combines = cnt["combine"].launches - comb0
        want = plain.allreduce(xb, algorithm="ring", wire_dtype="float16")
        same, diff = same_bits(got, want)
        exact = torch.stack(xb).float().sum(0)
        print(f"allreduce of a bf16 payload on an f16 wire, {W} ranks x "
              f"{N} elements: bitwise the plain versions' {same}; B2 "
              f"launches {casts}, B1 {combines}; max |got - f32 sum| "
              f"{float((got[0].float() - exact).abs().max()):.4g}")
        need(same and got.dtype == torch.bfloat16,
             "bf16 payload on an f16 wire: the kernels and the plain "
             "versions differ")
        need(casts > 0 and combines > 0, "bf16 payload on an f16 wire: "
             "B1 or B2 not launched")
        del kern, xb, got, want, exact
        torch.cuda.empty_cache()
        out = lambda key: [bufs[r][key].tensor for r in range(W)]  # noqa
        x64 = torch.zeros(N, dtype=torch.float64, device="cuda")
        absum = torch.zeros(N, dtype=torch.float64, device="cuda")
        for x in xs:
            x64 += x.double()
            absum += x.double().abs()
        tol = W * 2.0 ** -24 * absum

        ref = plain.allreduce(xs, algorithm="ring")
        check_rows(out("ar"), list(ref), "allreduce vs plain path")
        del ref
        for t in out("ar"):
            need(bool(torch.isfinite(t).all()), "allreduce: non-finite")
            need(bool(((t.double() - x64).abs() <= tol).all()),
                 "allreduce: outside the fp32 bound of the f64 golden")

        ref = plain.reduce_scatter(xs, algorithm="ring")
        check_rows(out("rs"), list(ref), "reduce_scatter vs plain path")
        for r, t in enumerate(out("rs")):
            sl = slice(r * c, (r + 1) * c)
            need(bool(((t.double() - x64[sl]).abs() <= tol[sl]).all()),
                 "reduce_scatter: outside the fp32 bound")

        ref = plain.allgather(ags, algorithm="ring")
        check_rows(out("ag"), list(ref), "allgather vs plain path")
        gold = torch.cat(ags)
        for t in out("ag"):
            need(torch.equal(t, gold), "allgather: not the exact gather")
        del ref, gold

        ref = plain.allreduce(xs, algorithm="ring",
                              wire_dtype="float8_e4m3fn", qblock=QBLOCK)
        check_rows(out("bs"), list(ref), "fp8 allreduce vs plain path")
        del ref
        amax = float(absum.max())
        bound = FP8_BOUND_PER_QUANT * W * amax + 1e-3
        errmax = 0.0
        for t in out("bs"):
            need(bool(torch.isfinite(t).all()), "fp8 allreduce: non-finite")
            err = float((t.double() - x64).abs().max())
            need(0 < err < bound, f"fp8 allreduce: error {err} not in "
                                  f"(0, {bound}) (0: wire not quantized)")
            errmax = max(errmax, err)
        print(f"main path results: bitwise vs plain path, within golden "
              f"bounds; fp8 max err {errmax} < {bound} "
              f"(0.07*(W/4)*max sum|x| + 1e-3; the unscaled W=4 bound "
              f"would be {amax * 0.07 + 1e-3})")

        def hold(name, got, gold, bound, wired=True):
            """Every element of ``got`` within ``bound`` of ``gold`` (f64
            rows or tensors); a wired call must differ somewhere."""
            worst, err_max, ratio = 0.0, 0.0, 0.0
            for t, g64, bd in zip(got, gold, bound):
                need(bool(torch.isfinite(t).all()), f"{name}: non-finite")
                err = (t.double() - g64).abs()
                need(bool((err <= bd).all()),
                     f"{name}: outside its float64-golden bound")
                err_max = max(err_max, float(err.max()))
                ratio = max(ratio, float((err / bd.clamp_min(1e-300)).max()))
                worst = max(worst, float(bd.max()))
            need(err_max > 0 or not wired,
                 f"{name}: no error at all (the wire was not used)")
            print(f"golden {name}: max err {err_max:.6g}, bound up to "
                  f"{worst:.6g}, worst err/bound {ratio:.4f}")

        for wire in ("float16", "bfloat16", "float8_e4m3fn"):
            key = {"float16": "ar_f16", "bfloat16": "ar_bf16",
                   "float8_e4m3fn": "ar_fp8"}[wire]
            ref = plain.allreduce(xs, algorithm="ring", wire_dtype=wire)
            check_rows(out(key), list(ref), f"ring {wire} vs plain path")
            del ref
            if wire == "float8_e4m3fn":   # W-1 hops + W-1 relay requants,
                kw, k32 = 2 * W - 2, (W - 1) + 3 * (2 * W - 2)
                bd = golden_bound(absum, k32, wire, kw, amax)
            else:                         # W-1 hops + one idempotent cast
                bd = golden_bound(absum, W - 1, wire, W)
            hold(f"allreduce ring {wire}", out(key), [x64] * W, [bd] * W)

        ref = plain.allreduce(xs, algorithm="xla", wire_dtype="float8_e4m3fn")
        for t, r in zip(out("xla_fp8"), ref):
            need(torch.allclose(t, r, rtol=1e-6, atol=1e-6),
                 "xla fp8 allreduce: outside rtol=1e-6, atol=1e-6 of the "
                 "plain path")
        xla_diff = max(float((t - r).abs().max())
                       for t, r in zip(out("xla_fp8"), ref))
        del ref
        bd = golden_bound(absum, (W - 1) + 6, "float8_e4m3fn", 2, amax)
        hold("allreduce xla float8_e4m3fn", out("xla_fp8"), [x64] * W,
             [bd] * W)
        print(f"xla fp8 allreduce vs plain path: max abs diff {xla_diff}")
        del x64, tol

        ref = plain_tree.reduce(xs, REDUCE_ROOT)
        rd = bufs[REDUCE_ROOT]["rd"].tensor
        check_rows([rd], [ref[REDUCE_ROOT]], "reduce (2x4 tree) vs plain")
        del ref
        gsum = torch.zeros(N, dtype=torch.float64, device="cuda")
        for x in xs:
            gsum += x.double()
        hold("reduce tree fp32", [rd], [gsum],
             [golden_bound(absum, W - 1)], wired=False)
        del gsum, absum

        ref = plain.bcast(xs, ROOT, "bfloat16")
        bc = out("bc")
        check_rows([bc[r] for r in range(W) if r != ROOT],
                   [ref[r] for r in range(W) if r != ROOT],
                   "bcast bf16 vs plain path")
        need(torch.equal(bc[ROOT], xs[ROOT]), "bcast: root's buffer changed")
        del ref
        g64 = xs[ROOT].double()
        bd = golden_bound(g64.abs(), 0, "bfloat16", 1)
        hold("bcast bfloat16", [bc[r] for r in range(W) if r != ROOT],
             [g64] * (W - 1), [bd] * (W - 1))
        del g64, bd

        ref = plain.scatter([xs[ROOT] if r == ROOT else None
                             for r in range(W)], ROOT, "float16")
        check_rows(out("sc"), list(ref), "scatter f16 vs plain path")
        del ref
        chunks = [xs[ROOT][r * c:(r + 1) * c].double() for r in range(W)]
        need(torch.equal(out("sc")[ROOT], xs[ROOT][ROOT * c:(ROOT + 1) * c]),
             "scatter: the root's own chunk is not exact")
        hold("scatter float16", out("sc"), chunks,
             [golden_bound(ch.abs(), 0, "float16", 1) for ch in chunks])
        del chunks

        ga = bufs[ROOT]["ga"].tensor
        ref = plain.gather(ags, ROOT, "float16")
        check_rows([ga], [ref[ROOT]], "gather f16 vs plain path")
        del ref
        need(torch.equal(ga[ROOT * c:(ROOT + 1) * c], ags[ROOT]),
             "gather: the root's own chunk is not exact")
        g64 = torch.cat(ags).double()
        hold("gather float16", [ga], [g64],
             [golden_bound(g64.abs(), 0, "float16", 1)])
        del g64

        ref = plain.alltoall(xs, "float8_e4m3fn")
        check_rows(out("a2a"), list(ref), "alltoall fp8 vs plain path")
        del ref
        for r, t in enumerate(out("a2a")):
            sl = slice(r * c, (r + 1) * c)
            need(torch.equal(t[sl], xs[r][sl]),
                 "alltoall: the own chunk is not exact")
        gold = [torch.cat([xs[j][r * c:(r + 1) * c] for j in range(W)])
                .double() for r in range(W)]
        hold("alltoall float8_e4m3fn (pure cast)", out("a2a"), gold,
             [golden_bound(gd.abs(), 0, "float8_e4m3fn", 1) for gd in gold])
        del gold
        torch.cuda.empty_cache()

        # -- timing -----------------------------------------------------------
        nbq = -(-c // QBLOCK)

        def tree_bytes(rounds, b):
            return sum(len(vs) * bs for _, bs, vs in rounds) * c * b

        # logical wire bytes of one call, all ranks together
        wire_bytes = {
            "allreduce": W * 2 * (W - 1) * c * 4,
            "reduce_scatter": W * (W - 1) * c * 4,
            "allgather": W * (W - 1) * c * 4,
            "allreduce_fp8bs": W * 2 * (W - 1) * (c + 4 * nbq),
            "allreduce_f16": W * 2 * (W - 1) * c * 2,
            "allreduce_bf16": W * 2 * (W - 1) * c * 2,
            "allreduce_fp8": W * 2 * (W - 1) * (c + 4),
            "allreduce_xla_fp8": W * 2 * (W - 1) * (c + 4),
            "bcast_bf16": (W - 1) * N * 2,
            "reduce": 7 * N * 4,          # 2x4 tree: 4 outer + 3 inner
            "scatter_f16": tree_bytes(scatter_rounds(W), 2),
            "gather_f16": tree_bytes(gather_rounds(W), 2),
            "alltoall_fp8": W * (W - 1) * c,
        }
        timing = {}
        for name in calls:
            ts = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                drive(name)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            timing[name] = statistics.median(ts[1:])
            print(f"call {name}: {timing[name]:.3f} ms per call (host "
                  f"clock, median of 3 after one warm-up); "
                  f"{wire_bytes[name] // W} logical wire bytes per rank")

        # -- where the time goes ---------------------------------------------
        streams = {}
        for name in calls:
            fams = device_ms_by_family(lambda: drive(name))
            if not fams:
                print(f"device {name}: not measured (the profiler saw no "
                      f"device activity)")
                continue
            busy = sum(fams.values())
            print(f"device {name}: {busy:.3f} ms of kernels in a "
                  f"{timing[name]:.3f} ms call, idle share "
                  f"{1 - busy / timing[name]:.3f}; " + ", ".join(
                      f"{f} {ms:.3f} ms" for f, ms in sorted(fams.items())))
            streams[name] = {f: round(fams[f], 4) for f in ("combine", "cast")
                             if f in fams}
        print(f"B1 combine and B2 cast families, ms per call: {streams}")
        return timing
    finally:
        for a in accls:
            a.deinit()


# -- phase 4b: point-to-point and local ops ---------------------------------

P2P_N = 8 << 20            # host-mirror sendrecv and the streamed variants
# the block-scaled codec's bound per element (accl_tpu/quant.py's error
# model): half an e4m3 step at the block's scale, amax * 2^-4 / (1 - 2^-4)
BS_BOUND_PER_AMAX = 2.0 ** -4 / (1 - 2.0 ** -4)
# B1, B2, B5 and B6: the kernels the p2p path must launch
P2P_KERNELS = ("combine", "cast", "bs_quant", "bs_dequant")


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 -> float32, round to nearest even (finite
    values, whose bits plus 0x8000 stay below 2^32; numpy has no
    bfloat16)."""
    b = x.view(np.uint32)
    return ((b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1)))
            & np.uint32(0xFFFF0000)).view(np.float32)


def hold_exchange(ctx, cid: int, k: int, timeout: float = 60.0):
    """Keep the exchange of communicator ``cid`` busy, as a running batch
    does, until ``k`` transfers wait in its window; they then ride the
    next batch together. Returns the thread that frees it."""
    with ctx._lock:
        ctx._xchg_running.add(cid)

    def free():
        end = time.monotonic() + timeout
        with ctx._lock:
            while (len(ctx._xchg_pending[cid]) < k
                   and time.monotonic() < end):
                ctx._lock.wait(0.01)
            ctx._xchg_running.discard(cid)
            ctx._lock.notify_all()

    th = threading.Thread(target=free, daemon=True)
    th.start()
    return th


def p2p_path(recs):
    """Phase 4b: send/recv, copy, combine and the stream ports through
    ``ACCL`` on ``cuda_world(8)``, device-resident buffers of 64 Mi fp32
    a rank. Every result is held bitwise against the same work through
    the plain versions (``PLAIN``) and against a numpy golden; B1, B2, B5
    and B6 must launch; with the exchange held busy until every transfer
    waits, the ring shift takes one exchange round, the conflicting set
    two. Then each call's host time (the library's own, slowest rank),
    device time by family, idle share, logical wire bytes a rank and
    launches."""
    import torch
    from accl_tpu_torch import StreamFlags, cuda_world
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.parallel.collectives import PLAIN
    from accl_tpu_torch.testing import run_ranks
    wire8 = "float8_e4m3fn"
    accls = cuda_world(W)            # device="cuda": no CPU fallback
    ctx = accls[0].device.ctx
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 2)
        xs = [torch.randn(N, device="cuda", generator=g) for _ in range(W)]
        ys = [torch.randn(N, device="cuda", generator=g) for _ in range(W)]
        hosts = [x[:P2P_N].cpu() for x in xs]
        bufs = {}

        def setup(a):
            r = a.rank

            def dev(n=N, dtype=torch.float32):
                return a.buffer((n,), dtype, device_resident=True)

            def res(x):
                return a.buffer(data=x, device_resident=True)

            bufs[r] = {
                "src": res(xs[r]), "y": res(ys[r]),
                "src16": res(xs[r].bfloat16()), "y16": res(ys[r].bfloat16()),
                "hsrc": a.buffer(data=hosts[r].clone()),
                "hdst": a.buffer((P2P_N,), torch.float32),
                "fp32": dev(), "float16": dev(), "bfloat16": dev(),
                wire8: dev(), "cf1": dev(), "cf2": dev(), "copy": dev(),
                "sum": dev(), "max": dev(), "sum16": dev(N, torch.bfloat16),
                "max16": dev(N, torch.bfloat16),
                "s_copy": dev(P2P_N), "s_comb": dev(P2P_N),
                "s_put": dev(P2P_N), "s_pop": None,
            }
        run_ranks(accls, setup)

        def ring(key, tag, **kw):
            def fn(a, b):
                r = a.rank
                src = b["hsrc"] if key == "hdst" else b["src"]
                n = src.size
                hs = a.send(src, n, dst=(r + 1) % W, tag=tag, run_async=True,
                            **kw)
                hr = a.recv(b[key], n, src=(r - 1) % W, tag=tag,
                            run_async=True, **kw)
                hs.wait()
                hr.wait()
            return fn

        def conflicting(a, b):
            """Ranks 0-3 send twice, to r+4 and to (r+1) % 4: 8 transfers,
            every source twice, every destination once."""
            r = a.rank
            hs = ([a.send(b["src"], N, dst=(r + 4), tag=20, run_async=True),
                   a.send(b["src"], N, dst=(r + 1) % 4, tag=21,
                          run_async=True)] if r < 4 else [])
            hr = (a.recv(b["cf1"], N, src=r - 4, tag=20, run_async=True)
                  if r >= 4 else
                  a.recv(b["cf2"], N, src=(r - 1) % 4, tag=21,
                         run_async=True))
            for h in hs + [hr]:
                h.wait()

        def combine_call(func, key, dt=""):
            return lambda a, b: a.combine(N, func, b["src" + dt],
                                          b["y" + dt], b[key])

        def streamed_local(a, b):
            a.stream_push(xs[a.rank][:P2P_N])
            a.copy(None, b["s_copy"], P2P_N,
                   stream_flags=StreamFlags.OP0_STREAM)
            a.stream_push(xs[a.rank][:P2P_N])
            a.combine(P2P_N, ReduceFunc.SUM, None, b["y"], b["s_comb"],
                      stream_flags=StreamFlags.OP0_STREAM)

        def streamed_p2p(a, b):
            r = a.rank
            hs = a.send(b["src"], P2P_N, dst=(r + 1) % W, tag=30,
                        run_async=True)
            a.recv(None, P2P_N, src=(r - 1) % W, tag=30,
                   stream_flags=StreamFlags.RES_STREAM)
            hs.wait()
            b["s_pop"] = a.stream_pop(30.0)
            a.stream_put(b["src"], P2P_N, dst=(r + 1) % W)
            a.copy(None, b["s_put"], P2P_N,
                   stream_flags=StreamFlags.OP0_STREAM)

        calls = {
            "sendrecv_fp32": ring("fp32", 1),
            "sendrecv_f16": ring("float16", 2, compress_dtype=torch.float16),
            "sendrecv_bf16": ring("bfloat16", 3,
                                  compress_dtype=torch.bfloat16),
            "sendrecv_fp8bs": ring(wire8, 4,
                                   compress_dtype=torch.float8_e4m3fn,
                                   block_scale=QBLOCK),
            "sendrecv_conflicting": conflicting,
            "sendrecv_host_8Mi": ring("hdst", 5),
            "copy": lambda a, b: a.copy(b["src"], b["copy"], N),
            "combine_sum_f32": combine_call(ReduceFunc.SUM, "sum"),
            "combine_max_f32": combine_call(ReduceFunc.MAX, "max"),
            "combine_sum_bf16": combine_call(ReduceFunc.SUM, "sum16", "16"),
            "combine_max_bf16": combine_call(ReduceFunc.MAX, "max16", "16"),
            "streamed_copy_combine_8Mi": streamed_local,
            "streamed_recv_pop_put_8Mi": streamed_p2p,
        }
        # exchange rounds with the window held until every transfer of
        # the call waits (one batch), and the transfers of a call
        want_rounds = {"sendrecv_fp32": 1, "sendrecv_f16": 1,
                       "sendrecv_bf16": 1, "sendrecv_fp8bs": 1,
                       "sendrecv_conflicting": 2, "sendrecv_host_8Mi": 1}
        transfers = {"streamed_recv_pop_put_8Mi": 2 * W,
                     **{name: W for name in want_rounds}}
        lib = {}

        def drive(name, hold=False):
            """One call on every rank: (exchange rounds, logical wire bytes
            a rank) it took; the slowest rank's seconds inside the library
            land in ``lib[name]``. ``hold`` keeps the exchange busy, as a
            running batch does, until every transfer of the call waits."""
            def fn(a):
                t0 = time.perf_counter()
                calls[name](a, bufs[a.rank])
                return time.perf_counter() - t0
            r0, b0 = ctx.exchange_rounds, ctx.exchange_bytes
            freer = (hold_exchange(ctx, accls[0].comm.comm_id,
                                   transfers[name]) if hold else None)
            lib[name] = max(run_ranks(accls, fn))
            if freer is not None:
                freer.join()
            return ctx.exchange_rounds - r0, (ctx.exchange_bytes - b0) // W

        for name in calls:                 # warm-up: the allocator's blocks
            drive(name)
        torch.cuda.synchronize()
        cnt = counters()
        for k in cnt.values():
            k.launches = 0
        rounds, wire = {}, {}
        for name in calls:                 # the p2p path, once
            rounds[name], wire[name] = drive(name)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in cnt.items()}
        print(f"p2p path launches: {launches}")
        print(f"p2p exchange rounds (batches as the transfers arrived): "
              f"{rounds}")
        for name, n in transfers.items():
            need(1 <= rounds[name] <= n,
                 f"{name}: {rounds[name]} exchange rounds for {n} transfers")
        held = {name: drive(name, hold=True)[0] for name in want_rounds}
        print(f"p2p exchange rounds, the window held until every transfer "
              f"waits: {held}")
        for name, n in want_rounds.items():
            need(held[name] == n,
                 f"{name}: {held[name]} exchange rounds held, expected {n}")
        for k in P2P_KERNELS:
            need(launches[k] > 0, f"kernel {k} never launched on the p2p path")
        add_path(recs, "p2p", launches)

        # -- correctness: the plain versions on the card -------------------
        def t(key, r):
            return bufs[r][key].tensor

        for r in range(W):
            s = (r - 1) % W
            for wire_name in ("float16", "bfloat16"):
                wd = getattr(torch, wire_name)
                check_rows([t(wire_name, r)],
                           PLAIN.cast(PLAIN.cast([xs[s]], wd), torch.float32),
                           f"sendrecv {wire_name} vs plain")
            q, sc = PLAIN.bs_quant([xs[s]], wire8, QBLOCK)
            check_rows([t(wire8, r)], PLAIN.bs_dequant(q, sc, wire8, QBLOCK),
                       "sendrecv fp8 block 128 vs plain")
            del q, sc
            for key, func, dt in (("sum", ReduceFunc.SUM, ""),
                                  ("max", ReduceFunc.MAX, ""),
                                  ("sum16", ReduceFunc.SUM, "16"),
                                  ("max16", ReduceFunc.MAX, "16")):
                check_rows([t(key, r)], [PLAIN.combine(
                    t("src" + dt, r), t("y" + dt, r), func)],
                    f"combine {key} vs plain")
            check_rows([t("s_comb", r)], [PLAIN.combine(
                xs[r][:P2P_N], ys[r][:P2P_N], ReduceFunc.SUM)],
                "combine from stream vs plain")
        torch.cuda.empty_cache()

        # -- correctness: a numpy golden, one host thread a rank -----------
        def golden(r):
            """fp32, copy and the streams are the inputs themselves
            (checked on the card, below); the rest against numpy."""
            s = (r - 1) % W

            def got(key):
                x = t(key, r)
                if x.dtype == torch.bfloat16:     # widened on the host
                    u = x.view(torch.int16).cpu().numpy().view(np.uint16)
                    return (u.astype(np.uint32) << 16).view(np.float32)
                return x.cpu().numpy()

            gx = xs[s].cpu().numpy()
            need(np.array_equal(got("float16"),
                                gx.astype(np.float16).astype(np.float32)),
                 "sendrecv f16: not numpy's round trip")
            need(np.array_equal(got("bfloat16"), bf16_round(gx)),
                 "sendrecv bf16: not the bf16 round trip")
            amax = np.abs(gx).reshape(-1, QBLOCK).max(axis=1)
            bound = (amax * BS_BOUND_PER_AMAX)[:, None]
            err = np.abs(got(wire8) - gx).reshape(-1, QBLOCK)
            need(bool(np.isfinite(err).all() and (err <= bound).all()),
                 "sendrecv fp8 block 128: outside the codec's bound")
            need(float(err.max()) > 0, "sendrecv fp8: the wire was exact")
            ratio = float((err / np.maximum(bound, 1e-30)).max())
            del gx, err
            mine, y = xs[r].cpu().numpy(), ys[r].cpu().numpy()
            need(np.array_equal(got("sum"), mine + y), "combine sum f32")
            need(np.array_equal(got("max"), np.maximum(mine, y)),
                 "combine max f32")
            need(np.array_equal(got("s_comb"),
                                mine[:P2P_N] + y[:P2P_N]),
                 "combine from stream: not numpy's")
            del mine, y
            a16, b16 = got("src16"), got("y16")
            need(np.array_equal(got("sum16"), bf16_round(a16 + b16)),
                 "combine sum bf16: not the rounded f32 sum")
            need(np.array_equal(got("max16"), np.maximum(a16, b16)),
                 "combine max bf16")
            need(np.array_equal(bufs[r]["hdst"].storage.numpy(),
                                hosts[s].numpy()),
                 "host-mirror sendrecv: not exact")
            return ratio

        with concurrent.futures.ThreadPoolExecutor(W) as pool:
            ratios = list(pool.map(golden, range(W)))
        for r in range(W):
            s = (r - 1) % W
            for got, want, what in (
                    (t("fp32", r), xs[s], "sendrecv fp32"),
                    (t("copy", r), xs[r], "copy"),
                    (t("s_copy", r), xs[r][:P2P_N], "copy from stream"),
                    (bufs[r]["s_pop"], xs[s][:P2P_N], "recv to stream"),
                    (t("s_put", r), xs[s][:P2P_N], "stream_put"),
                    (t("cf1" if r >= 4 else "cf2", r),
                     xs[r - 4 if r >= 4 else (r - 1) % 4],
                     "the conflicting set")):
                need(torch.equal(got, want), f"{what}: not exact")
        print(f"p2p path results: bitwise vs the plain versions; fp32, "
              f"copy and the streams exact; against numpy: the f16 and bf16 "
              f"round trips and combine exact, fp8-e4m3 block {QBLOCK} "
              f"worst err/bound {max(ratios):.4f} (bound amax(block) * 2^-4 "
              f"/ (1 - 2^-4) per element); checks done at "
              f"{time.perf_counter() - T_START:.1f} s")

        # -- timing and where the time goes -------------------------------
        for name in calls:
            ts, libs = [], []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                drive(name)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
                libs.append(lib[name] * 1e3)
            ms = statistics.median(ts[1:])
            lib_ms = statistics.median(libs[1:])
            msgs = {"sendrecv_conflicting": 8}.get(name, W)
            line = (f"call {name}: {ms:.3f} ms per call (host clock, median "
                    f"of 3 after one warm-up, {msgs} messages or local calls "
                    f"over the 8 ranks; {lib_ms:.3f} ms of it inside the "
                    f"library, slowest rank); {wire[name]} logical wire "
                    f"bytes per rank; exchange rounds {rounds[name]}")
            for k in cnt.values():
                k.launches = 0
            seen = {}
            fams = device_ms_by_family(lambda: drive(name),   # noqa: B023
                                       seen)
            per = {k: f.launches for k, f in cnt.items() if f.launches}
            print(line)
            # the same call enqueued behind a GPU sleep: the events time
            # its kernels back to back (a call that waits for the host,
            # as the host-mirror ring does, still shows its gaps)
            torch.cuda.synchronize()
            torch.cuda._sleep(CALL_HEAD_START_CYCLES)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            drive(name)
            host = (time.perf_counter() - t0) * 1e3
            e1.record()
            torch.cuda.synchronize()
            dev = e0.elapsed_time(e1)
            print(f"device {name}: {dev:.3f} ms of device work behind a GPU "
                  f"sleep ({dev / msgs:.4f} ms a message; the host enqueued "
                  f"it in {host:.1f} ms), idle share {1 - dev / ms:.3f} of "
                  f"the call, {1 - dev / lib_ms:.3f} of the library's time; "
                  f"launches {per or 'none'}")
            if not fams:
                print(f"device {name} by family: not measured (the profiler "
                      f"saw no device activity)")
                continue
            busy = sum(fams.values())
            print(f"device {name} by family (torch.profiler): {busy:.3f} ms "
                  f"in {sum(seen.values())} kernel records: " + ", ".join(
                      f"{f} {v:.3f} ms ({seen[f]})"
                      for f, v in sorted(fams.items())))
    finally:
        for a in accls:
            a.deinit()


# -- phase 4c: one-sided RMA -------------------------------------------------

RMA_STORM = 256            # put-with-notify storm: puts into one window
RMA_STORM_N = 512 << 10    # f32 elements a storm put (2 MiB)
RMA_WIRES = (None, "float16", "bfloat16", "float8_e4m3fn")


def rma_path(recs):
    """Phase 4c: put and get through ``ACCL`` on ``cuda_world(8)``,
    device-resident buffers of 64 Mi fp32 a rank: a put ring (rank r into
    rank r+1's window) and a get ring (rank r from rank r+1's window) on
    the fp32, f16, bf16 and fp8-e4m3 (per-element cast) wires, a put at
    byte offset 2, a put ring into host-mirror windows of 8 Mi, and a
    storm of 256 puts with notify of 2 MiB into one window, which its
    rank discovers by polling. Every landing bitwise against its plain
    version on the card (a torch copy or ``.to()``); every token exactly
    once; no ``accl_calls_total`` row added while polling; B2 launched.
    Then, for each case, its device ms a message behind a GPU sleep, the
    library's host ms (slowest rank), the drive's host ms, the idle share
    and the B2 launches."""
    import torch
    from accl_tpu_torch import cuda_world
    from accl_tpu_torch.serving.disagg import counter_total
    from accl_tpu_torch.testing import run_ranks
    accls = cuda_world(W)            # device="cuda": no CPU fallback
    per = RMA_STORM // W             # storm puts a rank
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 3)
        xs = [torch.randn(N, device="cuda", generator=g) for _ in range(W)]
        bufs = {}

        def setup(a):
            r = a.rank
            b = bufs[r] = {
                "src": a.buffer(data=xs[r]),
                "win": a.buffer((N,), torch.float32, device_resident=True),
                "gwin": a.buffer(data=xs[r].clone()),
                "dst": a.buffer((N,), torch.float32, device_resident=True),
                "hwin": a.buffer((P2P_N,), torch.float32),   # host mirror
                "hsrc": a.buffer(data=xs[r][:P2P_N]),
                "ssrc": [a.buffer(data=xs[r][k * RMA_STORM_N:
                                              (k + 1) * RMA_STORM_N])
                         for k in range(per)]}
            # the same registration order on every rank: agreeing ids
            b["ids"] = {k: a.register_window(b[k])
                        for k in ("win", "gwin", "hwin")}
            if r == 0:
                b["swin"] = a.buffer((RMA_STORM * RMA_STORM_N,),
                                     torch.float32, device_resident=True)
                b["ids"]["swin"] = a.register_window(b["swin"])
        run_ranks(accls, setup)
        ids = bufs[0]["ids"]
        need(all(bufs[r]["ids"]["win"] == ids["win"] for r in range(W)),
             "RMA window ids disagree across ranks")
        storm = {"records": [], "calls": 0, "polls": 0}

        def put_ring(wire):
            return lambda a, b: a.put(b["src"], N, dst=(a.rank + 1) % W,
                                      window=ids["win"],
                                      compress_dtype=wire)

        def get_ring(wire):
            return lambda a, b: a.get(b["dst"], N, src=(a.rank + 1) % W,
                                      window=ids["gwin"],
                                      compress_dtype=wire)

        def put_storm(a, b):
            r = a.rank
            hs = [a.put(s, RMA_STORM_N, dst=0, window=ids["swin"],
                        offset=(r * per + k) * RMA_STORM_N * 4,
                        notify=r * per + k + 1, run_async=True)
                  for k, s in enumerate(b["ssrc"])]
            if r == 0:                # discovery: polls, no call
                recs_, polls = [], 0
                calls0 = counter_total(a, "accl_calls_total")
                end = time.monotonic() + 60.0
                while len(recs_) < RMA_STORM and time.monotonic() < end:
                    got = a.poll_notifications(ids["swin"], 1024)
                    polls += 1
                    if not got:
                        time.sleep(0.0002)   # leave the GIL to the puts
                    recs_ += got
                storm.update(records=recs_, polls=polls, calls=counter_total(
                    a, "accl_calls_total") - calls0)
            for h in hs:
                h.wait()

        cases = {f"put_{w or 'fp32'}": (put_ring(w), W) for w in RMA_WIRES}
        cases["put_offset2"] = (
            lambda a, b: a.put(b["src"], N - 1, dst=(a.rank + 1) % W,
                               window=ids["win"], offset=2), W)
        cases.update({f"get_{w or 'fp32'}": (get_ring(w), W)
                      for w in RMA_WIRES})
        cases["put_host_8Mi"] = (
            lambda a, b: a.put(b["hsrc"], P2P_N, dst=(a.rank + 1) % W,
                               window=ids["hwin"]), W)
        cases["put_notify_storm_2MiB"] = (put_storm, RMA_STORM)
        lib = {}

        def drive(name):
            def fn(a):
                t0 = time.perf_counter()
                cases[name][0](a, bufs[a.rank])
                return time.perf_counter() - t0
            lib[name] = max(run_ranks(accls, fn))

        def t(key, r):
            return bufs[r][key].tensor

        def plain(x, wire):
            return x if wire is None else x.to(getattr(torch, wire)).float()

        def check(name):
            """The landing of ``name`` against its plain version."""
            for r in range(W):
                s, nxt = (r - 1) % W, (r + 1) % W
                if name.startswith("put_") and name[4:] in (
                        "fp32", "float16", "bfloat16", "float8_e4m3fn"):
                    wire = None if name == "put_fp32" else name[4:]
                    eq, err = same_bits(t("win", r), plain(xs[s], wire))
                    need(eq, f"rma {name}: rank {r}'s window is not the "
                         f"plain version (err {err})")
                elif name.startswith("get_"):
                    wire = None if name == "get_fp32" else name[4:]
                    eq, err = same_bits(t("dst", r), plain(xs[nxt], wire))
                    need(eq, f"rma {name}: rank {r}'s result is not the "
                         f"plain version (err {err})")
                elif name == "put_offset2":
                    want = plain(xs[s], "float8_e4m3fn")  # the case before
                    want.view(torch.uint8)[2:2 + 4 * (N - 1)].copy_(
                        xs[s].view(torch.uint8)[:4 * (N - 1)])
                    eq, _ = same_bits(t("win", r).view(torch.uint8),
                                      want.view(torch.uint8))
                    need(eq, f"rma {name}: rank {r}'s window bytes")
                    del want
                elif name == "put_host_8Mi":
                    need(torch.equal(bufs[r]["hwin"].storage,
                                     xs[s][:P2P_N].cpu()),
                         f"rma {name}: rank {r}'s host window")
            if name == "put_notify_storm_2MiB":
                toks = sorted(rc.token for rc in storm["records"])
                need(toks == list(range(1, RMA_STORM + 1)),
                     f"rma storm: {len(toks)} records, tokens not each "
                     f"exactly once")
                need(all(rc.err == 0 and rc.nbytes == 4 * RMA_STORM_N
                         and rc.offset == (rc.token - 1) * 4 * RMA_STORM_N
                         for rc in storm["records"]),
                     "rma storm: a record's error, offset or size")
                need(storm["calls"] == 0, f"rma storm: polling added "
                     f"{storm['calls']} accl_calls_total")
                need(torch.equal(
                    bufs[0]["swin"].tensor.view(W, per * RMA_STORM_N),
                    torch.stack([x[:per * RMA_STORM_N] for x in xs])),
                    "rma storm: the window is not the sources")

        for name in cases:                 # warm-up: the allocator's blocks
            drive(name)
        torch.cuda.synchronize()
        cnt = counters()
        for k in cnt.values():
            k.launches = 0
        per_case = {}
        parked0 = accls[0].device.ctx._parked_sends
        for name in cases:                 # the RMA path, once
            before = cnt["cast"].launches
            drive(name)
            torch.cuda.synchronize()
            per_case[name] = cnt["cast"].launches - before
            check(name)
        launches = {k: f.launches for k, f in cnt.items()}
        print(f"rma path launches: {launches}")
        need(launches["cast"] > 0, "kernel cast (B2) never launched on the "
             "RMA path")
        need(accls[0].device.ctx._parked_sends == parked0 == 0,
             "rma: a put parked a send")
        add_path(recs, "rma", launches)
        print(f"rma path results: every landing bitwise equal to its plain "
              f"version (torch copy or .to()); storm: {RMA_STORM} tokens "
              f"each exactly once in {storm['polls']} polls, "
              f"accl_calls_total delta across the polls 0; checks done at "
              f"{time.perf_counter() - T_START:.1f} s ({CARD})")

        # -- timing: host, library and device ms a case --------------------
        for name, (_, msgs) in cases.items():
            ts, libs = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                drive(name)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
                libs.append(lib[name] * 1e3)
            ms, lib_ms = statistics.median(ts), statistics.median(libs)
            torch.cuda.synchronize()
            torch.cuda._sleep(CALL_HEAD_START_CYCLES)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            drive(name)
            e1.record()
            torch.cuda.synchronize()
            dev = e0.elapsed_time(e1)
            print(f"rma {name}: device {dev / msgs:.4f} ms a message "
                  f"({dev:.3f} ms for {msgs} behind a GPU sleep), library "
                  f"{lib_ms:.3f} ms (slowest rank), host {ms:.3f} ms (median "
                  f"of 3), idle share {1 - dev / lib_ms:.3f} of the "
                  f"library's time; B2 launches {per_case[name]} ({CARD})")
    finally:
        for a in accls:
            a.deinit()


# -- attention and the Llama serving path ----------------------------------

ATTN_SRC = "accl_tpu_torch/csrc/attention.cu"   # f32 B8, B9, prefill: 3xTF32
ATTN_SM90_SRC = "accl_tpu_torch/csrc/attention_sm90.cu"  # bf16 B8, B9, prefill
ATTN_DECODE_SRC = "accl_tpu_torch/csrc/attention_decode.cu"  # S_new == 1
# f32 B8, B9 and the B12 chunks past head dim 4096: the band form
ATTN_BAND_FWD_SRC = "accl_tpu_torch/csrc/attention_band_fwd.cu"
# one attention tolerance, stated once and held element by element:
# f32 |got - plain| <= 2e-5 + 2e-5 * |plain| (one f32 softmax summed in
# another order); bf16 <= 2^-7 * |plain| + 2^-7 * median |plain|: one
# bf16 ulp of each element (both round an f32 value, which may sit on
# either side of a rounding boundary), with a floor of one ulp of the
# typical output for elements near zero; the LSE is f32 always
F32_RTOL = F32_ATOL = 2e-5
BF16_REL = 2.0 ** -7
# f16 outputs the same rule at f16's unit: one f16 ulp (2^-10 relative)
HALF_REL = 2.0 ** -10
ATTN_TOL = ("f32 2e-5 + 2e-5*|plain|; bf16 2^-7*|plain| + "
            "2^-7*median|plain|; f16 2^-10*|plain| + 2^-10*median|plain|; "
            "per element")
# the forward's bf16 tensor-core route (B8, B9, B12 with S_new > 1) rounds P
# to bf16 (8 significant bits) as the first operand of P V, which moves
# each term p*v by less than 2^-8 of its magnitude, so an output moves by
# less than 2^-8 * m, m = sum_j p_ij |v_j| / l_i
# (``fwd_rounding_magnitudes``), on top of the bf16 output limit; its
# LSE keeps the f32 limit
FWD_BF16_MARGIN = 2.0 ** -8
# the f16 route rounds P to f16 (11 significant bits): 2^-11 * m; a P
# below 2^-14 is subnormal in f16, rounded with an absolute step of
# 2^-24, which moves an output by at most 2^-25 * s, s = sum over the
# visible keys of |v_j| / l_i (``fwd_subnormal_magnitudes``)
FWD_HALF_MARGIN = 2.0 ** -11
SUBNORMAL_STEP = 2.0 ** -25
FWD_TOL = ("tensor-core route: bf16 2^-8*m + 2^-7*|plain| + "
           "2^-7*median|plain|, f16 2^-11*m + 2^-25*s + 2^-10*|plain| + "
           "2^-10*median|plain|, m the magnitude of the rounded sum P V, s "
           "the sum of the visible |v| / l; LSE 2e-5 + 2e-5*|lse|; per "
           "element")
# the output rule of a 16-bit dtype: (relative term, P's rounding unit)
HALF_UNITS = {"torch.bfloat16": (BF16_REL, FWD_BF16_MARGIN),
              "torch.float16": (HALF_REL, FWD_HALF_MARGIN)}
KEY_TILE = 64               # the bf16 and split-KV kernels' key tile
# the f32 forward's route (B8, B9, B12 chunks): csrc/attention.cu
F32_ROUTE = "f32 route (TF32 tensor cores, 3xTF32)"
# flash against dense, f32, 4 layers: the two attentions sum in other
# orders (about 1e-7 relative per output), amplified through 4 layers and
# the lm_head's 4096-term products: max |diff| <= 1e-4 * max |logit|
MODEL_F32_RTOL = 1e-4
# serving prefill, bf16, forward_cached (B12) against forward (B8): both
# run 64-row query tiles over the same 64-key tiles in the same order, so
# their f32 results agree but for rare roundings that 32 bf16 layers may
# carry: max |diff| <= one bf16 ulp of the logit scale (2^-7 * max|logit|)
# and the greedy token the same at 99 % of the positions
SERVE_BF16_RTOL = 2.0 ** -7
SERVE_MIN_AGREE = 0.99
# serving, bf16, 32 layers, flash (the kernels) against dense (the plain
# path) on the same weights: dense rounds its probabilities to bf16
# before the PV product (2^-9 relative per term), flash keeps them f32;
# that difference, about 2^-9 of each attention output, reaches the
# logits through 32 residual layers as a random walk (sqrt(32) * 2^-9 =
# 0.011 relative). A wiring fault (a head, a cache row, a rope position)
# moves the logits by O(1) relative. Limit: ||flash - dense|| <= 2^-4 *
# ||dense|| (Frobenius norms over all logits)
SERVE_DENSE_REL = 2.0 ** -4
# the path each attention record's ``launches`` is read from: serving
# runs B9 in its forward on the prompts' first 512 tokens (one key block)
SERVE_B9_LEN = 512
LAUNCH_PATH = {"attn_fwd": "serving", "attn_fwd_single": "serving",
               "attn_decode": "serving", "attn_prefill": "serving",
               "attn_bwd_dkv": "training", "attn_bwd_dq": "training",
               "attn_bwd_dkv_tf32": "grad_check",
               "attn_bwd_dq_tf32": "grad_check",
               "attn_fwd_tf32": "model_f32", "attn_fwd_single_tf32":
               "model_f32", "attn_prefill_tf32": "model_f32"}


def attention_counters() -> dict:
    from accl_tpu_torch.ops import attention as A
    return {"attn_fwd": A.fwd_launches,
            "attn_fwd_single": A.fwd_single_launches,
            "attn_bwd_dkv": A.bwd_dkv_launches,
            "attn_bwd_dq": A.bwd_dq_launches,
            "attn_decode": A.decode_launches,
            "attn_prefill": A.prefill_launches,
            "attn_fwd_wgmma": A.fwd_wgmma_launches,
            "attn_fwd_single_wgmma": A.fwd_single_wgmma_launches,
            "attn_prefill_wgmma": A.prefill_wgmma_launches,
            "attn_decode_split": A.decode_split_launches}


def zero_attention_counters():
    from accl_tpu_torch.ops import attention as A
    A.fwd_launches = A.fwd_single_launches = 0
    A.bwd_dkv_launches = A.bwd_dq_launches = 0
    A.decode_launches = A.prefill_launches = 0
    A.fwd_wgmma_launches = A.prefill_wgmma_launches = 0
    A.fwd_single_wgmma_launches = A.decode_split_launches = 0


def need_routes(launches: dict, bf16: bool, what: str):
    """Every B8, B9 and B12 prefill launch of a path took the 16-bit
    tensor-core (wgmma) route when the path runs bf16 or f16, none when it
    runs f32 (the 3xTF32 route); every single-token decode launch took
    the split-KV kernel (every dtype). The route counts are the ones the
    C entry points reported (``accl_attn_last_route``), so a dispatch
    that sent a launch elsewhere fails here."""
    from accl_tpu_torch.ops import attention as A
    keys = ("attn_fwd", "attn_fwd_single", "attn_prefill")
    for key in keys:
        want = launches[key] if bf16 else 0
        need(launches[key + "_wgmma"] == want,
             f"{what}: {launches[key + '_wgmma']} of {launches[key]} "
             f"{key} launches on the tensor-core route, want {want}")
    need(launches["attn_decode_split"] == launches["attn_decode"],
         f"{what}: {launches['attn_decode_split']} of "
         f"{launches['attn_decode']} decode launches on the split-KV route")
    print(f"{what} routes: " + ", ".join(
        f"{k} {launches[k + '_wgmma']} of {launches[k]}" for k in keys)
        + f" launches on the 16-bit tensor-core route ({ATTN_SM90_SRC}), the "
        f"rest on the f32 3xTF32 route ({ATTN_SRC}); attn_decode "
        f"{launches['attn_decode_split']} of {launches['attn_decode']} on "
        f"the split-KV kernel ({ATTN_DECODE_SRC}"
        + (f", n_split {A.last_decode_splits} at the last"
           if launches["attn_decode"] else "") + ")")


def attn_limit(plain, mag=None):
    """Per-element limit of |kernel - plain| (see ATTN_TOL); ``mag``, the
    rounding allowance of the P V product (``fwd_route_mag``), selects
    the 16-bit tensor-core route's (FWD_TOL)."""
    p = plain.float().abs()
    if str(plain.dtype) in HALF_UNITS:
        rel = HALF_UNITS[str(plain.dtype)][0]
        lim = rel * p + rel * float(p.median())
        return lim if mag is None else lim + mag
    return F32_ATOL + F32_RTOL * p


def fwd_route_mag(kind: str, args, kwargs=None):
    """For a 16-bit call of B8, B9 or B12 with S_new > 1 (the tensor-core
    route), the allowance its limit adds for P's rounding (FWD_TOL): u *
    m, u P's unit (2^-8 bf16, 2^-11 f16), m ``fwd_rounding_magnitudes``,
    and for f16 2^-25 * s (``fwd_subnormal_magnitudes``); None for every
    other call (a single-token decode on the split-KV kernel keeps f32,
    to ``SPLIT_MAX_D``; past it it runs the tensor-core prefill form and
    rounds P too).
    ``kind`` "fwd": args as ``flash_attention_fwd``'s; "decode": as
    ``flash_decode``'s."""
    from accl_tpu_torch.ops import attention as A
    kwargs = kwargs or {}
    q = args[0]
    if str(q.dtype) not in HALF_UNITS:
        return None
    if kind == "fwd":
        k, v = args[1], args[2]
        causal = args[3] if len(args) > 3 else kwargs.get("causal", True)
        scale = args[4] if len(args) > 4 else kwargs.get("sm_scale")
        off = 0
    else:
        kv_len = args[3] if len(args) > 3 else kwargs["kv_len"]
        if q.shape[2] == 1 and A.takes_split(q.dtype, q.shape[-1]):
            return None                        # decode: split-KV, f32
        k, v = A.cache_prefix(args[1], args[2], kv_len)
        causal, scale = True, kwargs.get("sm_scale")
        off = kv_len - q.shape[2]
    unit = HALF_UNITS[str(q.dtype)][1]
    mag = unit * A.fwd_rounding_magnitudes(q, k, v, causal, scale, off)
    if unit == FWD_HALF_MARGIN:
        mag += SUBNORMAL_STEP * A.fwd_subnormal_magnitudes(q, k, v, causal,
                                                           scale, off)
    return mag


def hold_attn(got, plain, what: str, lse=None, plain_lse=None,
              mag=None) -> tuple[float, float]:
    """Kernel output within the stated tolerance of its plain version,
    element by element; returns (max abs error, largest ratio of an
    error to its element's limit), over O and, where given, the LSE.
    ``mag`` (see ``fwd_route_mag``) selects the tensor-core route's
    limit."""
    import torch
    need(got.shape == plain.shape and got.dtype == plain.dtype,
         f"{what}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
         f"{tuple(plain.shape)} {plain.dtype}")
    need(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    d = (got.float() - plain.float()).abs()
    ratio = float((d / attn_limit(plain, mag)).max())
    err = float(d.max())
    need(ratio <= 1.0, f"{what}: max abs err {err}, {ratio:.3g} times "
         f"its element's limit ({ATTN_TOL if mag is None else FWD_TOL})")
    if lse is not None:
        dl = (lse - plain_lse).abs()
        r = float((dl / (F32_ATOL + F32_RTOL * plain_lse.abs())).max())
        need(r <= 1.0, f"{what}: LSE max abs err {float(dl.max())}")
        err, ratio = max(err, float(dl.max())), max(ratio, r)
    return err, ratio


def attn_work(B, H, Hkv, Sq, Skv, D, esize, s_new=None):
    """(bytes, operations) causal attention needs: q, k, v read once (for
    decode only the kv_len prefix of the cache), O (and the f32 LSE of the
    forward) written once; 4*D operations per score entry a query sees."""
    if s_new is None:              # forward: query i sees keys 0..i
        n = min(Sq, Skv)
        seen = n * (n + 1) // 2 + (Sq - n) * Skv
        nbytes = (2 * B * H * Sq * D + 2 * B * Hkv * Skv * D) * esize \
            + 4 * B * H * Sq
    else:                          # decode: kv_len = Skv, s_new new rows
        seen = s_new * (Skv - s_new) + s_new * (s_new + 1) // 2
        nbytes = (2 * B * H * s_new * D + 2 * B * Hkv * Skv * D) * esize
    return nbytes, 4 * D * B * H * seen


def attn_source(kind: str, dtype, s_new: int = 0) -> str:
    """The source of the kernel a call of ``kind`` ("fwd" for B8 and B9,
    "decode" for B12) runs in ``dtype`` with ``s_new`` new tokens."""
    if kind == "decode" and s_new == 1:
        return ATTN_DECODE_SRC
    return ATTN_SM90_SRC if str(dtype) in HALF_UNITS else ATTN_SRC


def need_repeat(fn, outs, what: str):
    """A second call of ``fn`` (an f32-route kernel) on the same inputs
    gives ``outs`` again, bitwise."""
    import torch
    again = fn()
    again = again if isinstance(again, tuple) else (again,)
    outs = outs if isinstance(outs, tuple) else (outs,)
    need(all(torch.equal(a, b) for a, b in zip(outs, again)),
         f"{what}: a repeat on the same inputs is not bitwise equal")


def attention_edges(rng):
    """The CPU tests' shapes, single-block B9 cases and the decode and
    chunked-prefill edge cases, f32 and bf16 (bf16 B8, B9 and B12 chunks
    on the tensor-core route, under FWD_TOL; f32 B8, B9 and B12 chunks on
    the 3xTF32 route, each run twice and bitwise equal; single-token
    decode on the split-KV kernel)."""
    import torch
    from accl_tpu_torch.ops import attention as A
    fwd_cases = [  # B, H, Hkv, Sq, Skv, D, causal, block_k
        (1, 2, 2, 64, 64, 16, True, None), (1, 2, 2, 130, 130, 32, False, None),
        (1, 4, 2, 96, 96, 16, True, 32), (2, 4, 1, 96, 96, 16, False, None),
        (1, 4, 2, 40, 96, 16, True, 32), (2, 8, 2, 300, 300, 64, True, None),
        (1, 8, 1, 513, 513, 128, False, None)]
    # one key block (B9): Skv 40, 128, 130 (block_k 256), 256, 512 and
    # 2048 (block_k 2048); MHA/GQA/MQA, causal and not, Sq != Skv
    single_cases = [
        (1, 4, 4, 40, 40, 64, True, None), (2, 4, 2, 128, 128, 128, True, None),
        (1, 8, 1, 130, 130, 32, False, 256),
        (1, 8, 2, 256, 256, 16, True, None),
        (2, 4, 4, 512, 512, 128, True, None),
        (1, 4, 1, 512, 512, 64, False, None),
        (1, 4, 2, 96, 40, 128, True, None), (1, 4, 2, 40, 256, 32, True, None),
        (1, 4, 2, 200, 512, 64, False, None),
        (1, 2, 1, 64, 2048, 128, False, 2048),
        (1, 4, 2, 2048, 2048, 64, True, 2048)]
    T = 3 * KEY_TILE + 8
    # (S_new, kv_len, D, generator): decode and chunks of new tokens, the
    # whole prefill (kv_len = S_new) and after a filled prefix (kv_len >
    # S_new). The chunks of 64 and 65 and the other head dims draw from a
    # generator of their own, so that the phases after this one see the
    # inputs they saw before these cases were added.
    more = np.random.default_rng(SEED + 13)
    dec_cases = [(s, n, 32, rng) for s in (1, 3)
                 for n in (s, KEY_TILE - 1, KEY_TILE, KEY_TILE + 1, T)]
    dec_cases += [(s, n, d, more) for d in (16, 64, 128) for s, n in (
        (3, 3), (3, KEY_TILE + 1), (KEY_TILE, KEY_TILE), (KEY_TILE, T),
        (KEY_TILE + 1, KEY_TILE + 1), (KEY_TILE + 1, 2 * KEY_TILE + 3))]
    # single-token decode through the split-KV kernel: NaN past kv_len,
    # kv_len 1, 63, 64, 65 and T at D 16-128, MHA/GQA/MQA (groups 1, 2, 4,
    # 8), and a long cache whose 64 slices outnumber the filled tiles
    # (B, H, Hkv, T, kv_len, D)
    split_cases = [(2, 8, 2, T, n, d) for d in (16, 64, 128)
                   for n in (1, KEY_TILE - 1, KEY_TILE, KEY_TILE + 1, T)]
    split_cases += [(1, 4, 4, T, 65, 32), (2, 6, 3, T, T, 64),
                    (1, 8, 1, T, 130, 128), (1, 8, 2, 4096, 1, 128),
                    (1, 8, 2, 4096, 100, 128), (1, 8, 2, 4096, 4000, 64),
                    (1, 8, 2, 4096, 4096, 128)]
    split_rng = np.random.default_rng(SEED + 14)
    worst = {}              # route -> (max abs err, largest error/limit)
    splits = set()
    for dt in (torch.float32, torch.bfloat16):
        for B, H, Hkv, Sq, Skv, D, causal, bk in fwd_cases:
            q = torch.from_numpy(rng.standard_normal((B, H, Sq, D))).to(
                "cuda", dt)
            k, v = (torch.from_numpy(rng.standard_normal(
                (B, Hkv, Skv, D))).to("cuda", dt) for _ in range(2))
            o, lse = A.flash_attention_fwd(q, k, v, causal, block_k=bk)
            ro, rl = A.flash_attention_ref(q, k, v, causal)
            mag = fwd_route_mag("fwd", (q, k, v, causal, None, None, bk))
            route = "tensor cores" if mag is not None else F32_ROUTE
            what = f"attn fwd {dt} {(B, H, Hkv, Sq, Skv, D, causal, bk)}"
            worst[route] = max_pair(worst.get(route, (0.0, 0.0)), hold_attn(
                o, ro, what, lse, rl, mag))
            if mag is None:
                need_repeat(lambda: A.flash_attention_fwd(  # noqa: B023
                    q, k, v, causal, block_k=bk), (o, lse), what)
        for B, H, Hkv, Sq, Skv, D, causal, bk in single_cases:
            need(A.is_single_block(Skv, bk), f"B9 case {Skv}/{bk}: not one "
                 f"key block")
            q = torch.from_numpy(split_rng.standard_normal(
                (B, H, Sq, D))).to("cuda", dt)
            k, v = (torch.from_numpy(split_rng.standard_normal(
                (B, Hkv, Skv, D))).to("cuda", dt) for _ in range(2))
            before = A.fwd_single_launches
            o, lse = A.flash_attention_fwd(q, k, v, causal, block_k=bk)
            need(A.fwd_single_launches == before + 1, "B9 case: not B9")
            ro, rl = A.flash_attention_ref(q, k, v, causal)
            mag = fwd_route_mag("fwd", (q, k, v, causal, None, None, bk))
            route = ("B9 tensor cores" if mag is not None
                     else "B9 " + F32_ROUTE)
            what = f"attn B9 {dt} {(B, H, Hkv, Sq, Skv, D, causal, bk)}"
            worst[route] = max_pair(worst.get(route, (0.0, 0.0)), hold_attn(
                o, ro, what, lse, rl, mag))
            if mag is None:
                need_repeat(lambda: A.flash_attention_fwd(  # noqa: B023
                    q, k, v, causal, block_k=bk), (o, lse), what)
        for B, H, Hkv, Tc, kv_len, D in split_cases:
            q = torch.from_numpy(split_rng.standard_normal(
                (B, H, 1, D))).to("cuda", dt)
            kc, vc = (torch.from_numpy(split_rng.standard_normal(
                (B, Tc, Hkv, D))).to("cuda", dt) for _ in range(2))
            kc[:, kv_len:] = float("nan")
            vc[:, kv_len:] = float("nan")
            before = A.decode_split_launches
            o = A.flash_decode(q, kc, vc, kv_len)
            need(A.decode_split_launches == before + 1, "decode: not split")
            n = A.last_decode_splits
            filled = sum(hi > lo for lo, hi in A.decode_split_ranges(kv_len, n))
            splits.add((n, filled))
            worst["split-KV"] = max_pair(worst.get("split-KV", (0.0, 0.0)),
                                         hold_attn(
                o, A.flash_decode_ref(q, kc, vc, kv_len),
                f"attn decode {dt} {(B, H, Hkv, Tc, kv_len, D)} n_split {n}"))
        for s_new, kv_len, D, gen in dec_cases:
            q = torch.from_numpy(gen.standard_normal(
                (2, 8, s_new, D))).to("cuda", dt)
            kc, vc = (torch.from_numpy(gen.standard_normal(
                (2, T, 2, D))).to("cuda", dt) for _ in range(2))
            kc[:, kv_len:] = float("nan")
            vc[:, kv_len:] = float("nan")
            mag = fwd_route_mag("decode", (q, kc, vc, kv_len))
            route = ("tensor cores" if mag is not None else
                     "split-KV" if s_new == 1 else F32_ROUTE)
            what = f"attn decode {dt} s_new={s_new} kv_len={kv_len} D={D}"
            o = A.flash_decode(q, kc, vc, kv_len)
            worst[route] = max_pair(worst.get(route, (0.0, 0.0)), hold_attn(
                o, A.flash_decode_ref(q, kc, vc, kv_len), what, mag=mag))
            if route == F32_ROUTE:
                need_repeat(lambda: A.flash_decode(  # noqa: B023
                    q, kc, vc, kv_len), o, what)
    print(f"attention edges: {2 * len(fwd_cases)} forward cases (B8 and "
          f"B9, MHA/GQA/MQA, ragged, straddling blocks, Sq != Skv), "
          f"{2 * len(single_cases)} single-block B9 cases (Skv 40-2048, "
          f"MHA/GQA/MQA, causal and not, Sq != Skv), "
          f"{2 * len(dec_cases)} decode and chunked-prefill cases (NaN past "
          f"kv_len, S_new 1/3/64/65, kv_len = S_new and past it, D 16-128) "
          f"and {2 * len(split_cases)} single-token decode cases on the "
          f"split-KV kernel (NaN past kv_len, kv_len 1 to T, groups 1-8, D "
          f"16-128; (n_split, filled slices) {sorted(splits)}) within "
          f"tolerance; every f32 B8, B9 and prefill case repeated bitwise")
    for route, (err, ratio) in sorted(worst.items()):
        tol = FWD_TOL if route.endswith("tensor cores") else ATTN_TOL
        print(f"  {route}: max abs err {err}, largest error/limit "
              f"{ratio:.3f} ({tol})")


# f32 forward cases at the longest lengths the port runs (the tensor
# core's truncation grows with the length of a sum): B8 at phase 10a's
# unsharded shape, B9 over one 4096-key block (block_k = 4096), causal
# and not. (B, H, Hkv, Sq, Skv, D, causal, block_k)
LONG_F32_CASES = ((1, 32, 8, 8192, 8192, 128, True, None),
                  (1, 32, 8, 4096, 4096, 128, True, 4096),
                  (1, 8, 2, 512, 4096, 64, False, 4096))


def hold_attn_by_kv_head(q, k, v, causal, o, lse, what):
    """An f32 forward's O and LSE against the plain version run one kv
    head at a time (a long sequence's dense scores for every head would
    not fit), under ATTN_TOL; returns (max abs error, error/limit)."""
    import torch
    from accl_tpu_torch.ops import attention as A
    B, H, Sq, _ = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    w = (0.0, 0.0)
    for j in range(Hkv):
        hs = slice(j * g, (j + 1) * g)
        ro, rl = A.flash_attention_ref(q[:, hs], k[:, j:j + 1],
                                       v[:, j:j + 1], causal)
        w = max_pair(w, hold_attn(
            o[:, hs], ro, f"{what} kv head {j}",
            lse.view(B, H, Sq)[:, hs].reshape(B * g, Sq), rl))
        del ro, rl
        torch.cuda.empty_cache()
    return w


def attention_long_f32():
    """LONG_F32_CASES: f32 B8 and B9 against their plain versions under
    ATTN_TOL, each run twice and bitwise equal, timed."""
    import torch
    from accl_tpu_torch.ops import attention as A
    gen = np.random.default_rng(SEED + 20)
    for B, H, Hkv, Sq, Skv, D, causal, bk in LONG_F32_CASES:
        q = torch.from_numpy(gen.standard_normal((B, H, Sq, D))).to(
            "cuda", torch.float32)
        k, v = (torch.from_numpy(gen.standard_normal((B, Hkv, Skv, D))).to(
            "cuda", torch.float32) for _ in range(2))
        single = A.is_single_block(Skv, bk)
        before = A.fwd_single_launches
        o, lse = A.flash_attention_fwd(q, k, v, causal, block_k=bk)
        need((A.fwd_single_launches == before + 1) == single,
             "long f32 case: the wrong kernel")
        case = (B, H, Hkv, Sq, Skv, D, causal, bk)
        what = f"attn {'B9' if single else 'B8'} f32 {case}"
        err, ratio = hold_attn_by_kv_head(q, k, v, causal, o, lse, what)
        need_repeat(lambda: A.flash_attention_fwd(  # noqa: B023
            q, k, v, causal, block_k=bk), (o, lse), what)
        ms = time_ms(lambda: A.flash_attention_fwd(  # noqa: B023
            q, k, v, causal, block_k=bk), reps=10)
        print(f"{what} ({ATTN_SRC}, {F32_ROUTE}): {ms:.4f} ms, max abs err "
              f"vs plain {err}, largest error/limit {ratio:.3f} (O and LSE, "
              f"{ATTN_TOL}); a repeat bitwise equal")
        del q, k, v, o, lse
        torch.cuda.empty_cache()


def max_pair(a, b):
    """Element-wise max of two (max abs error, error/limit) pairs."""
    return max(a[0], b[0]), max(a[1], b[1])


def attention_records():
    """B8, B9 and B12 at the full-width shapes, bf16 and f32 (the f32
    rows named ``*_tf32``: the 3xTF32 route, each run twice and bitwise
    equal), against their plain versions and PyTorch's SDPA (f32 with
    ``allow_tf32`` off), timed. B9 at S=128 (printed) and at the serving
    path's S=512 (the record). The f32 route's bound is three TF32
    products at the tensor cores' rate (or the bytes); the CUDA cores'
    f32 bound is printed beside it."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    H, Hkv, D = 32, 8, 128          # Llama-3-8B attention geometry
    recs = []
    shapes = [  # name, replaces, B, Sq/S_new, Skv/kv_len, T (decode)
        ("attn_fwd", "accl_tpu/ops/attention.py:285", 4, 2048, 2048, None),
        ("attn_fwd_single", "accl_tpu/ops/attention.py:252", 4, 128, 128,
         None),
        ("attn_fwd_single", "accl_tpu/ops/attention.py:252", 4,
         SERVE_B9_LEN, SERVE_B9_LEN, None),
        ("attn_decode", "accl_tpu/ops/attention.py:689", 4, 1, 2047, 4096),
        ("attn_prefill", "accl_tpu/ops/attention.py:689", 4, 1024, 1024,
         1024)]
    for name, replaces, B, sq, skv, T in shapes:
        for dt in (torch.bfloat16, torch.float32):
            q = torch.randn(B, H, sq, D, device="cuda", generator=g).to(dt)
            if T is None:
                k = torch.randn(B, Hkv, skv, D, device="cuda",
                                generator=g).to(dt)
                v = torch.randn_like(k)
                o, lse = A.flash_attention_fwd(q, k, v, True)
                ref, rl = A.flash_attention_ref(q, k, v, True)
                mag = fwd_route_mag("fwd", (q, k, v, True))
                err, ratio = hold_attn(o, ref, f"{name} {dt}", lse, rl, mag)
                outs = (o, lse)
                kern = lambda: A.flash_attention_fwd(q, k, v, True)  # noqa
                plain = lambda: A.flash_attention_ref(q, k, v, True)  # noqa
                lib = lambda: F.scaled_dot_product_attention(  # noqa
                    q, k, v, is_causal=True, enable_gqa=True)
                nbytes, nops = attn_work(B, H, Hkv, sq, skv, D,
                                         q.element_size())
            else:
                kc = torch.randn(B, T, Hkv, D, device="cuda",
                                 generator=g).to(dt)
                vc = torch.randn_like(kc)
                kc[:, skv:] = float("nan")
                vc[:, skv:] = float("nan")
                o = A.flash_decode(q, kc, vc, skv)
                ref = A.flash_decode_ref(q, kc, vc, skv)
                mag = fwd_route_mag("decode", (q, kc, vc, skv))
                err, ratio = hold_attn(o, ref, f"{name} {dt}", mag=mag)
                outs = o
                kern = lambda: A.flash_decode(q, kc, vc, skv)  # noqa
                plain = lambda: A.flash_decode_ref(q, kc, vc, skv)  # noqa
                kt = kc[:, :skv].transpose(1, 2)
                vt = vc[:, :skv].transpose(1, 2)
                # q at the end of the prefix: causal (square) or no mask
                lib = lambda: F.scaled_dot_product_attention(  # noqa
                    q, kt, vt, is_causal=sq > 1, enable_gqa=True)
                nbytes, nops = attn_work(B, H, Hkv, sq, skv, D,
                                         q.element_size(), s_new=sq)
            # the f32 route of B8, B9 and the prefill: 3xTF32
            tf32 = dt == torch.float32 and name != "attn_decode"
            repeat = ""
            if tf32:
                need_repeat(kern, outs, f"{name} {dt}")
                repeat = "; a repeat bitwise equal"
            ms = time_ms(kern)
            plain_ms = time_ms(plain, reps=5)
            library_ms = time_ms(lib)
            if tf32:
                bms, by = bound_ms(nbytes, 3 * nops, TF32_OPS_PER_S)
                core_ms, _ = bound_ms(nbytes, nops, F32_OPS_PER_S)
                bounds = (f"bound {bms:.4f} ms by {by} (3 x ops / 495 "
                          f"TFLOP/s or bytes / 3.35 TB/s), {bms / ms:.1%} "
                          f"of it; CUDA-core bound {core_ms:.4f} ms, "
                          f"{core_ms / ms:.1%} of it")
            else:
                rate = (BF16_OPS_PER_S if dt == torch.bfloat16
                        else F32_OPS_PER_S)
                bms, by = bound_ms(nbytes, nops, rate)
                bounds = f"bound {bms:.4f} ms by {by}, {bms / ms:.1%} of bound"
            src = attn_source("fwd" if T is None else "decode", dt, sq)
            n_split = A.last_decode_splits if name == "attn_decode" else None
            print(f"kernel {name} {str(dt)[6:]} ({src}) B={B} H={H} "
                  f"Hkv={Hkv} D={D} "
                  f"{'Sq' if T is None else 'S_new'}={sq} "
                  f"{'Skv' if T is None else 'kv_len'}={skv}"
                  f"{'' if T is None else f' T={T}'}"
                  f"{'' if n_split is None else f' n_split={n_split}'}: "
                  f"{ms:.4f} ms (plain "
                  f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms = "
                  f"{ms / library_ms:.2f}x sdpa, {bounds}), max abs "
                  f"err vs plain {err}, largest error/limit {ratio:.3f} "
                  f"({ATTN_TOL if mag is None else FWD_TOL}){repeat}")
            # the table's rows: bf16 and the f32 route; B9 at the serving
            # path's length
            if (dt == torch.bfloat16 or tf32) and not (
                    name == "attn_fwd_single" and sq != SERVE_B9_LEN):
                recs.append({"name": name + ("_tf32" if tf32 else ""),
                             "route": "cuda",
                             "source": src, "replaces": replaces,
                             "launches": 0, "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bms,
                             "bound_by": by, "library_ms": library_ms})
                if n_split is not None:
                    recs[-1]["n_split"] = n_split
            del q, o, ref, mag, outs
            torch.cuda.empty_cache()
    return recs


def llama_model_phase():
    """Flash (the kernels) against dense (the plain path), f32, full
    width, 4 layers, the same weights."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama, LlamaConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"model phase: allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=4,
                              dtype=torch.float32,
                              param_dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    flash = Llama(cfg).init(g)
    dense = Llama(dataclasses.replace(cfg, attention="dense"))
    dense.load_state_dict(flash.state_dict())
    print(f"model: Llama-3-8B geometry, 4 of 32 layers, f32, "
          f"{flash.param_count()} parameters")
    tg = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def toks(b, s):
        return torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                             generator=tg)

    def compare(a, b, what):
        need(bool(torch.isfinite(a).all()), f"model {what}: non-finite")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        tol = MODEL_F32_RTOL * scale
        print(f"model {what}: max abs diff flash vs dense {err:.3g} "
              f"(logit scale {scale:.3g}, tolerance {tol:.3g})")
        need(err <= tol, f"model {what}: flash and dense differ by {err}")

    with torch.no_grad(), attention_calls(cfg.n_layers) as calls:
        for b, s in ((2, 2048), (4, 128)):
            t = toks(b, s)
            compare(flash(t), dense(t), f"forward ({b}, {s})")
        t = toks(2, 1008)
        cf, cd = flash.init_kv_cache(2, 1008), dense.init_kv_cache(2, 1008)
        compare(flash.forward_cached(t[:, :1000], cf)[0],
                dense.forward_cached(t[:, :1000], cd)[0],
                "forward_cached prefill 1000")
        for i in range(1000, 1008):
            compare(flash.forward_cached(t[:, i:i + 1], cf)[0],
                    dense.forward_cached(t[:, i:i + 1], cd)[0],
                    f"decode step at {i}")
    with torch.no_grad():
        hold_path_calls(calls, "model")
    del calls, flash, dense
    torch.cuda.empty_cache()


@contextlib.contextmanager
def attention_calls(n_layers: int):
    """Record the Llama path's attention calls of its first and last
    layer as (wrapper name, args, kwargs, output), so that the kernels'
    outputs can be held against the plain versions at exactly the
    shapes the path gave them. The wrappers are the model module's own
    names; the kernels still count their launches."""
    from accl_tpu_torch.models import llama as L
    calls = []
    seen = {"flash_attention": 0, "flash_decode": 0}
    wrapped = {name: getattr(L, name) for name in seen}

    def recorder(name):
        def call(*args, **kwargs):
            out = wrapped[name](*args, **kwargs)
            if seen[name] % n_layers in (0, n_layers - 1):
                calls.append((name, args, kwargs, out.clone()))
            seen[name] += 1
            return out
        return call

    for name in seen:
        setattr(L, name, recorder(name))
    try:
        yield calls
    finally:
        for name, fn in wrapped.items():
            setattr(L, name, fn)


def hold_path_calls(calls, what: str):
    """Each recorded kernel output against its plain version on the same
    inputs; one line per kernel with its shapes and kv_len range."""
    from accl_tpu_torch.ops import attention as A
    kinds = {}
    for name, args, kwargs, out in calls:
        q = args[0]
        if name == "flash_attention":
            kind = ("B9" if A.is_single_block(args[1].shape[2]) else "B8")
            plain = A.flash_attention_ref(*args, **kwargs)[0]
            at = args[1].shape[2]
            mag = fwd_route_mag("fwd", args, kwargs)
        else:
            kind = ("B12 decode (split-KV)" if q.shape[2] == 1
                    else "B12 prefill")
            plain = A.flash_decode_ref(*args, **kwargs)
            at = kwargs["kv_len"]
            mag = fwd_route_mag("decode", args, kwargs)
        if mag is not None:
            kind += " (tensor cores)"
        pair = hold_attn(out, plain, f"{what} {kind} q {tuple(q.shape)} "
                         f"keys {at}", mag=mag)
        k = kinds.setdefault(kind, {"n": 0, "q": tuple(q.shape),
                                    "dtype": q.dtype, "keys": set(),
                                    "worst": (0.0, 0.0)})
        k["n"] += 1
        k["keys"].add(at)
        k["worst"] = max_pair(k["worst"], pair)
        del plain, mag
    for kind, k in sorted(kinds.items()):
        print(f"{what} {kind}: {k['n']} calls of the first and last layer "
              f"held against the plain version at the path's own shapes "
              f"(q {k['q']} {k['dtype']}, keys {min(k['keys'])}.."
              f"{max(k['keys'])}); max abs err {k['worst'][0]}, largest "
              f"error/limit {k['worst'][1]:.3f} "
              f"({FWD_TOL if 'tensor' in kind else ATTN_TOL})")
    return kinds


def serving_phase():
    """Llama-3-8B as published (32 layers, bf16 weights): generate for
    four 1024-token prompts, held against the plain path, timed and
    profiled. Returns the serving path's launch counts."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama, LlamaConfig
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              param_dtype=torch.bfloat16)
    B, S, NEW = 4, 1024, 32
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    t0 = time.perf_counter()
    model = Llama(cfg).init(g)
    torch.cuda.synchronize()
    print(f"serving: Llama-3-8B, {cfg.n_layers} layers, bf16, "
          f"{model.param_count()} parameters, init "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                            generator=g)
    short = prompts[:, :SERVE_B9_LEN]      # one key block: B9

    def against_dense(what, flash, dense):
        """``flash`` logits against ``dense()`` on the same weights with
        attention="dense" (the plain path), ||diff|| <= SERVE_DENSE_REL *
        ||dense||."""
        model.config = dataclasses.replace(cfg, attention="dense")
        try:
            ref = dense()
        finally:
            model.config = cfg
        rel = float(torch.linalg.vector_norm(flash - ref)
                    / torch.linalg.vector_norm(ref))
        agree = float((flash.argmax(-1) == ref.argmax(-1)).float().mean())
        print(f"serving {what}, flash vs dense (bf16, 32 layers): relative "
              f"diff {rel:.4g} (limit {SERVE_DENSE_REL}), max abs diff "
              f"{float((flash - ref).abs().max()):.4g}, greedy agreement "
              f"{agree:.4f}")
        need(rel <= SERVE_DENSE_REL, f"serving {what}: flash and dense "
             f"differ")

    # the serving path, once: generate, a forward on the prompts' first
    # 512 tokens (checked and freed at once, so that the phase's peak
    # memory stays that of the 1024-token checks), then one more prefill,
    # a decode step and a full forward for the checks below
    with torch.no_grad(), attention_calls(cfg.n_layers) as calls:
        zero_attention_counters()
        out = model.generate(prompts, max_new=NEW)
        full_short = model(short)
        need(full_short.shape == (B, SERVE_B9_LEN, cfg.vocab_size)
             and bool(torch.isfinite(full_short).all()),
             f"serving forward {B}x{SERVE_B9_LEN}: shape "
             f"{tuple(full_short.shape)} or non-finite logits")
        against_dense(f"forward {B}x{SERVE_B9_LEN} (B9)", full_short,
                      lambda: model(short))
        del full_short
        cache = model.init_kv_cache(B, S + NEW)
        cached, _ = model.forward_cached(prompts, cache)
        tok = cached[:, -1].argmax(-1)[:, None]
        step, _ = model.forward_cached(tok, cache)
        full = model(prompts)
        torch.cuda.synchronize()
        launches = attention_counters()
    print(f"serving phase launches: {launches}")
    need(launches["attn_fwd"] > 0 and launches["attn_decode"] > 0
         and launches["attn_prefill"] > 0,
         "serving: B8 or B12 (decode or prefill) not launched")
    need(launches["attn_fwd_single"] == cfg.n_layers,
         f"serving: B9 launched {launches['attn_fwd_single']} times on the "
         f"{B}x{SERVE_B9_LEN} forward, not once per layer ({cfg.n_layers})")
    need_routes(launches, True, "serving")
    with torch.no_grad():
        need(out.shape == (B, NEW), f"generate: shape {tuple(out.shape)}")
        need(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
             "generate: token outside the vocabulary")
        need(bool(torch.isfinite(cached).all() and torch.isfinite(full).all()
                  and torch.isfinite(step).all()),
             "serving: non-finite logits")
        err = float((cached - full).abs().max())
        scale = float(full.abs().max())
        agree = float((cached.argmax(-1) == full.argmax(-1)).float().mean())
        print(f"serving prefill logits, forward_cached (B12) vs forward (B8): "
              f"max abs diff {err:.4g} (logit scale {scale:.4g}, tolerance "
              f"{SERVE_BF16_RTOL * scale:.4g}); greedy agreement {agree:.4f} "
              f"(at least {SERVE_MIN_AGREE}); bitwise equal: "
              f"{torch.equal(cached, full)}")
        need(err <= SERVE_BF16_RTOL * scale and agree >= SERVE_MIN_AGREE,
             "serving: forward_cached prefill and forward disagree")
        hold_path_calls(calls, "serving")
        del calls
        # the plain path on the same weights: dense attention
        dcache = model.init_kv_cache(B, S + NEW)
        for what, flash, dense in (
                ("prefill (forward_cached)", cached,
                 lambda: model.forward_cached(prompts, dcache)[0]),
                ("decode step at 1024", step,
                 lambda: model.forward_cached(tok, dcache)[0]),
                ("forward", full, lambda: model(prompts))):
            against_dense(what, flash, dense)
        del cached, full, step, cache, dcache
        # the timing and profiling below drive the path again; its
        # launch counts were read above

        def prefill():
            c = model.init_kv_cache(B, S + NEW)
            return model.forward_cached(prompts, c)

        def decode_steps(state, n):
            """n greedy steps from ``state`` = (logits, cache); each
            step's host-clock ms."""
            logits, c = state
            ts = []
            for _ in range(n):
                t1 = time.perf_counter()
                tok = logits[:, -1].argmax(-1)
                logits, c = model.forward_cached(tok[:, None], c)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t1) * 1e3)
            return ts

        fwd_ms = host_ms(lambda: model(prompts))
        short_ms = host_ms(lambda: model(short))
        pre_ms = host_ms(prefill)
        state = prefill()
        dec_ms = statistics.median(decode_steps(state, 16))
        print(f"serving forward (B8): {fwd_ms:.2f} ms for {B}x{S} tokens "
              f"({B * S / fwd_ms * 1e3:.0f} tokens/s; host clock, median "
              f"of 3)")
        print(f"serving forward {B}x{SERVE_B9_LEN} (B9): {short_ms:.2f} ms "
              f"({B * SERVE_B9_LEN / short_ms * 1e3:.0f} tokens/s; host "
              f"clock, median of 3)")
        print(f"serving prefill: {pre_ms:.2f} ms for {B}x{S} tokens "
              f"({B * S / pre_ms * 1e3:.0f} tokens/s; host clock, median "
              f"of 3)")
        print(f"serving decode: {dec_ms:.3f} ms per step of {B} tokens "
              f"({B / dec_ms * 1e3:.1f} tokens/s; median of 16 steps at "
              f"positions {S}..{S + 15})")
        state = prefill()
        for what, fn, window in (
                ("forward", lambda: model(prompts), fwd_ms),
                (f"forward {B}x{SERVE_B9_LEN}", lambda: model(short),
                 short_ms),
                ("prefill", prefill, pre_ms),
                ("decode x8", lambda: decode_steps(state, 8), 8 * dec_ms)):
            fams = device_ms_by_family(fn)
            if not fams:
                print(f"serving {what}: busy share not measured (the "
                      f"profiler saw no device activity)")
                continue
            busy = sum(fams.values())
            print(f"serving {what}: {busy:.2f} ms of kernels in a "
                  f"{window:.2f} ms host-clock window, busy share "
                  f"{busy / window:.3f}; " + ", ".join(
                      f"{f} {ms:.2f} ms" for f, ms in sorted(fams.items())))
        del state
        disagg = disaggregated_phase(model, prompts, NEW)
    sp_launches, peak = sp_forward_phase(model)
    print(f"serving peak memory (phases 7 and 7b): "
          f"{(peak - held) / 2 ** 30:.2f} GiB "
          f"above the {held / 2 ** 30:.2f} GiB held before the phase")
    tp_launches = tp_serving_phase(model, prompts, out, dict(
        fwd_ms=fwd_ms, pre_ms=pre_ms, dec_ms=dec_ms))
    del model, short
    torch.cuda.empty_cache()
    return launches, disagg, sp_launches, tp_launches


# -- phase 7b: disaggregated serving over put-with-notify --------------------

DISAGG_BLOCK = 16       # tokens a KV block: 32 layers x K, V x 8 x 128 bf16
#                         = 2 MiB, Llama-3-8B's 128 KiB a token
DISAGG_BLOCKS = 160     # blocks a decode rank's window holds (320 MiB)
DISAGG_SHARED = 512     # leading tokens requests 0 and 2 share


def disaggregated_phase(model, prompts, new: int) -> dict:
    """Phase 7b, on phase 7's model: ``cuda_world(4)``, ranks 0-1 prefill
    and 2-3 decode, four 1024-token prompts of which 0 and 2 share their
    first 512 tokens; ``serve_disaggregated`` places and admits them
    (KVBlockManager, ContinuousBatcher), prefills (B12 prefill), puts each
    missed 2 MiB block with notify into its decode rank's bf16 window,
    polls, unpacks and runs ``new`` decode steps (B12 split-KV). Checks:
    landed blocks bitwise equal to their source, put bytes = misses x 2
    MiB, request 2's 32 shared blocks hits, no call while polling, and
    each request's first decode step against ``generate``'s local run on
    the same prompt (SERVE_DENSE_REL). Returns the path's attention launch
    counts."""
    import torch
    from accl_tpu_torch import cuda_world
    from accl_tpu_torch.serving.disagg import serve_disaggregated
    phase("phase 7b: disaggregated serving")
    B, S = prompts.shape
    dp = prompts.clone()
    dp[2, :DISAGG_SHARED] = dp[0, :DISAGG_SHARED]
    # the local run: generate's tokens, and its first decode step's logits
    ref_tokens = model.generate(dp, max_new=new)
    cache = model.init_kv_cache(B, S + new)
    logits, cache = model.forward_cached(dp, cache)
    ref_step, _ = model.forward_cached(logits[:, -1].argmax(-1)[:, None],
                                       cache)
    ref_step = ref_step[:, -1]
    del cache, logits
    accls = cuda_world(4)            # device="cuda": no CPU fallback

    def drive():
        return serve_disaggregated(
            model, accls, dp, new, prefill_ranks=(0, 1), decode_ranks=(2, 3),
            block_tokens=DISAGG_BLOCK, blocks_per_rank=DISAGG_BLOCKS)

    try:
        drive()                      # warm-up: the allocator's blocks
        torch.cuda.synchronize()
        zero_attention_counters()
        t0 = time.perf_counter()
        run = drive()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = attention_counters()
        t0 = time.perf_counter()
        fams = device_ms_by_family(drive)
        prof_s = time.perf_counter() - t0
    finally:
        for a in accls:
            a.deinit()
    print(f"disaggregated path launches: {launches}")
    need(launches["attn_prefill"] > 0 and launches["attn_decode"] > 0,
         "disaggregated: B12 (prefill or decode) not launched")
    need_routes(launches, True, "disaggregated")
    cfg = model.config
    nb = S // DISAGG_BLOCK
    want = DISAGG_BLOCK * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    need(run.block_nbytes == want, f"disaggregated: a block is "
         f"{run.block_nbytes} bytes, not {want}")
    need(run.landed_mismatches == 0, f"disaggregated: "
         f"{run.landed_mismatches} landed blocks differ from their source")
    need(run.duplicates == 0 and run.records == run.puts == run.misses,
         f"disaggregated: {run.records} records for {run.puts} puts "
         f"({run.duplicates} duplicates)")
    need(run.put_bytes == run.misses * run.block_nbytes,
         f"disaggregated: {run.put_bytes} put bytes for {run.misses} misses")
    need(run.hits == DISAGG_SHARED // DISAGG_BLOCK and run.shared == {2}
         and run.misses == B * nb - run.hits,
         f"disaggregated: {run.hits} hits, shared {run.shared}")
    need(run.calls_while_polling == 0, f"disaggregated: polling added "
         f"{run.calls_while_polling} accl_calls_total")
    need(bool(torch.isfinite(run.step_logits).all()),
         "disaggregated: non-finite logits")
    worst = 0.0
    for r in range(B):
        rel = float(torch.linalg.vector_norm(run.step_logits[r, 0]
                                             - ref_step[r])
                    / torch.linalg.vector_norm(ref_step[r]))
        worst = max(worst, rel)
        need(rel <= SERVE_DENSE_REL, f"disaggregated: request {r}'s first "
             f"decode step differs from the local run by {rel:.4g}")
    agree = float((run.tokens[:, :new] == ref_tokens).float().mean())
    busy = sum(fams.values()) if fams else None
    ttft = ", ".join(f"{q.rid}: {q.ttft_s * 1e3:.1f}" for q in run.requests)
    print(f"disaggregated results: {run.puts} puts of "
          f"{run.block_nbytes / 2 ** 20:.3f} MiB, every landed "
          f"block bitwise its source, {run.hits} hits (request 2's shared "
          f"prefix, 0 wire bytes), put bytes {run.put_bytes} = misses x "
          f"block, {run.polls} polls with no call; first decode step vs the "
          f"local generate: worst relative diff {worst:.4g} (limit "
          f"{SERVE_DENSE_REL}), greedy agreement {agree:.4f} over "
          f"{B}x{new} tokens")
    print(f"disaggregated serving ({CARD}): TTFT ms {{{ttft}}}; KV landed "
          f"{run.put_bytes / run.kv_seconds / 1e9:.2f} GB/s ({run.put_bytes}"
          f" bytes in {run.kv_seconds * 1e3:.1f} ms, first put to last "
          f"poll); decode {statistics.median(run.decode_ms):.3f} ms a step "
          f"(median of {len(run.decode_ms)}, 2 decode ranks of 2 "
          f"sequences); drive {wall_ms:.1f} ms (profiled drive and its "
          f"trace {prof_s:.1f} s); busy share "
          + (f"{busy / wall_ms:.3f} ({busy:.1f} ms of kernels: "
             + ", ".join(f"{f} {v:.2f}" for f, v in sorted(fams.items()))
             + ")" if busy else "not measured (the profiler saw no device "
             "activity)"))
    del run, ref_step, ref_tokens, dp
    torch.cuda.empty_cache()
    return launches


# -- attention backward and the Llama training path --------------------------

ATTN_BWD_SRC = "accl_tpu_torch/csrc/attention_bwd.cu"          # f32 route
# the f32 routes' kernels on the TF32 tensor cores (mangled: the name's
# length before it, which keeps the wgmma and split-KV kernels out), their
# sources, and the SASS of a TF32 mma.sync
TF32_KERNELS = {"attn_fwd": (r"\d+attn_fwd_kernel", ATTN_SRC),
                "attn_fwd_single": (r"\d+attn_fwd_single_kernel", ATTN_SRC),
                "attn_prefill": (r"\d+attn_decode_kernel", ATTN_SRC),
                "attn_bwd_dkv": (r"\d+attn_bwd_dkv_kernel", ATTN_BWD_SRC),
                "attn_bwd_dq": (r"\d+attn_bwd_dq_kernel", ATTN_BWD_SRC)}
TF32_HMMA = r"HMMA\.\S*TF32"
ATTN_BWD_SM90_SRC = "accl_tpu_torch/csrc/attention_bwd_sm90.cu"  # bf16 route
WGMMA_KERNELS = ("attn_fwd_wgmma_kernel", "attn_fwd_single_wgmma_kernel",
                 "attn_bwd_dkv_wgmma_kernel", "attn_bwd_dq_wgmma_kernel")
# the single-token decode route: CUDA-core code, its registers printed
SPLIT_KERNEL = "attn_decode_split_kernel"
# B10/B11 against their plain versions, per element. f32 inputs: the same
# f32 FlashAttention-2 backward summed in another order over up to S*D
# terms per output, whose error scales with the largest gradient of the
# tensor, not with each element: |got - plain| <= 2e-5*|plain| +
# 2e-5*max|plain|. bf16 inputs (the tensor-core route): P and dS are
# rounded to bf16 (8 significant bits) as the first operand of dV, dK
# and dQ, which moves each term of those sums by less than 2^-8 of its
# magnitude, so an output moves by less than 2^-8 * m, m the sum of the
# terms' magnitudes (``bwd_rounding_magnitudes``); the floor
# 2e-5*max|plain| covers the f32 order of the sums, dP's acting on dS
# where dP ~ delta: dk, dv (f32) 2^-8*m + 2e-5*max|plain|; dq (bf16 out)
# 2^-8*m + 2^-7*|plain| + 2^-7*median|plain| (one bf16 ulp of the
# element, floored at one ulp of the median, as the forward)
BWD_REL = 2e-5
BWD_BF16_MARGIN = 2.0 ** -8
# f16 inputs: the same at f16's unit (2^-11 a term, dq's output 2^-10),
# plus 2^-25 * s for a P or dS below 2^-14 (subnormal in f16, rounded with
# an absolute step of 2^-24), s the sum of the other operand's magnitudes
# over the output's visible pairs (``bwd_subnormal_magnitudes``)
BWD_HALF_MARGIN = 2.0 ** -11
BWD_TOL = ("f32 2e-5*|plain| + 2e-5*max|plain|; bf16 dk, dv 2^-8*m + "
           "2e-5*max|plain|, dq 2^-8*m + 2^-7*|plain| + 2^-7*median|plain|, "
           "m the magnitude of the rounded sum; f16 the same with 2^-11*m + "
           "2^-25*s and dq's 2^-10; per element")
# the Function's gradients (B8 + B10 + B11) against torch autograd through
# dense attention, f32: two algorithms (a dense softmax backward against
# the recomputation from the LSE with delta from O), each rounding at its
# own places: 5x the kernel-vs-plain limit, 1e-4*|dense| + 1e-4*max|dense|
FN_DENSE_REL = 1e-4
# the bf16 Function against f32 dense autograd on the same bf16-valued
# inputs: O, P, dS and the gradients round to bf16 (under 2^-8 each),
# so each gradient within 1e-2 relative L2; SDPA's bf16 backward is
# printed beside it as the yardstick
FN_BF16_REL_L2 = 1e-2
# flash against dense, 2-layer f32 Llama-3-8B, B=1, S=2048: the attention
# outputs differ by ~1e-7 relative (phase 6 read ~6e-6 relative on 4
# layers' logits); the loss within 1e-5 relative, every parameter's
# gradient within 1e-4 relative L2 (||g_flash - g_dense|| / ||g_dense||)
GRAD_LOSS_REL = 1e-5
GRAD_REL_L2 = 1e-4
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2, 2048, 4
TRAIN_MAX_PEAK = 75 * 2 ** 30


def bwd_limit(plain, part: str, mag=None, rel: float = BF16_REL):
    """Per-element limit of a B10/B11 output ``part`` ("dk", "dv", "dq")
    against its plain version (see BWD_TOL); ``mag``, the allowance for
    the rounded sum (u * m, and for f16 2^-25 * s), selects the 16-bit
    route's rule, ``rel`` dq's output unit (2^-7 bf16, 2^-10 f16)."""
    p = plain.float().abs()
    if mag is None:
        return BWD_REL * p + BWD_REL * float(p.max())
    if part == "dq":
        return mag + rel * p + rel * float(p.median())
    return mag + BWD_REL * float(p.max())


def hold_bwd(got, plain, what: str, part: str, mag=None,
             rel: float = BF16_REL) -> tuple[float, float]:
    """(max abs error, largest error/limit) of a B10/B11 output against
    its plain version under BWD_TOL; fails past the limit."""
    import torch
    need(got.shape == plain.shape and got.dtype == plain.dtype,
         f"{what}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
         f"{tuple(plain.shape)} {plain.dtype}")
    need(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    d = (got.float() - plain.float()).abs()
    ratio = float((d / bwd_limit(plain, part, mag, rel)).max())
    err = float(d.max())
    need(ratio <= 1.0, f"{what}: max abs err {err}, {ratio:.3g} times its "
         f"element's limit ({BWD_TOL})")
    return err, ratio


def hold_bwd_outputs(args, outs, what: str) -> tuple[float, float]:
    """B10's (dk, dv) or B11's (dq,) on ``args`` (the wrappers' operands)
    against the plain versions, under the rule of the inputs' dtype."""
    import torch
    from accl_tpu_torch.ops import attention as A
    if len(outs) == 2:
        plain, parts = A.flash_attention_bwd_dkv_ref(*args), ("dk", "dv")
    else:
        plain, parts = (A.flash_attention_bwd_dq_ref(*args),), ("dq",)
    mags, rel = bwd_route_mags(args)
    w = (0.0, 0.0)
    for got, want, part in zip(outs, plain, parts):
        w = max_pair(w, hold_bwd(got, want, f"{what} {part}", part,
                                 mags.get(part), rel))
    return w


def bwd_route_mags(args) -> tuple[dict, float]:
    """For 16-bit B10/B11 operands ``args``, the allowances of BWD_TOL by
    part (u * m, and for f16 2^-25 * s) and dq's output unit; ({}, 0)
    for f32."""
    from accl_tpu_torch.ops import attention as A
    if str(args[0].dtype) not in HALF_UNITS:
        return {}, 0.0
    f16 = str(args[0].dtype) == "torch.float16"
    unit = BWD_HALF_MARGIN if f16 else BWD_BF16_MARGIN
    mags = {p: unit * m for p, m in zip(("dk", "dv", "dq"),
                                        A.bwd_rounding_magnitudes(*args))}
    if f16:
        for p, sub in zip(("dk", "dv", "dq"),
                          A.bwd_subnormal_magnitudes(*args)):
            mags[p] = mags[p] + SUBNORMAL_STEP * sub
    return mags, HALF_UNITS[str(args[0].dtype)][0]


@functools.lru_cache(maxsize=1)
def sass_and_ptxas():
    """The built library's SASS, one string per function (its first line
    the mangled name), and ptxas's report of each kernel from the build
    log: mangled name -> [registers, spill bytes]. Read once a run (the
    library does not change within one); callers only read them."""
    import re
    import shutil
    from accl_tpu_torch import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.build())],
                          capture_output=True, text=True, timeout=300)
    need(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()}")
    funcs = re.split(r"\n\s*Function : ", sass.stdout)[1:]
    ptx = {}
    name = None
    for ln in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            ptx.setdefault(name, [0, 0])[1] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            ptx.setdefault(name, [0, 0])[0] = int(m.group(1))
    return funcs, ptx


# B1 and B2's stream kernels (csrc/stream.cuh): the mangled names hold the
# name's length before it, which keeps bs_combine_kernel out
STREAM_KERNELS = {"combine": r"\d+combine_kernel", "cast": r"\d+cast_kernel"}


BS_COMBINE_KERNEL = "17bs_combine_kernel"


def bs_combine_instantiations() -> set:
    """(wire, func, requant, steps) of every B7 kernel accl_bs_combine
    launches: the round-closing mode one step a thread at every block,
    requant as many as bs_tile needs."""
    steps = sorted({bs_tile(b) // (BS_THREADS * BS_STEP) for b in BS_BLOCKS})
    return ({(w, f, True, s) for w in range(3) for f in range(4)
             for s in steps}
            | {(w, f, False, 1) for w in range(3) for f in range(4)})


def stream_kernels_checked():
    """B1's and B2's kernels carry 128-bit global accesses (LDG.E...128,
    STG.E...128) where their design puts them: every B1 instantiation
    loads and stores 16-byte vectors, every B2 instantiation reads or
    writes its f32 side in 16-byte vectors (the wire codes' side in 8 or
    4 bytes: a thread-step is 4 elements); ptxas reports no spills for
    them. So does B7 (``bs_combine_kernel``, every instantiation that
    accl_bs_combine launches): 16-byte loads of ``other``, and in the
    round-closing mode 16-byte f32 stores. Prints the counts and the
    registers; fails otherwise."""
    import re
    funcs, ptx = sass_and_ptxas()
    ldg, stg = r"LDG\.E(?:\.\w+)*\.128", r"STG\.E(?:\.\w+)*\.128"
    for name, pat in STREAM_KERNELS.items():
        bodies = {f.split("\n", 1)[0].strip(): f for f in funcs
                  if re.search(pat, f.split("\n", 1)[0])}
        need(bodies, f"{name}: no {pat} kernel in the library's SASS")
        counts = []
        for head, body in bodies.items():
            nl, ns = len(re.findall(ldg, body)), len(re.findall(stg, body))
            # cast_kernel<SRC, DST>: lane 0 is f32
            m = re.search(r"cast_kernelILi(\d)ELi(\d)E", head)
            want_l = m is None or m.group(1) == "0"
            want_s = m is None or m.group(2) == "0"
            need((nl > 0 or not want_l) and (ns > 0 or not want_s),
                 f"{head}: 128-bit loads {nl}, stores {ns}")
            counts.append((nl, ns))
        info = {k: v for k, v in ptx.items() if re.search(pat, k)}
        need(len(info) == len(bodies),
             f"{name}: {len(info)} ptxas reports for {len(bodies)} kernels")
        spills = {k: v for k, v in info.items() if v[1]}
        need(not spills, f"{name}: ptxas spills {spills}")
        regs = [v[0] for v in info.values()]
        print(f"{name}_kernel: {len(bodies)} instantiations, 128-bit "
              f"(LDG, STG) per instantiation {sorted(set(counts))}; ptxas "
              f"registers {min(regs)}-{max(regs)}, no spills")
    # B7: bs_combine_kernel<WIRE, F, REQUANT, S>
    bodies = {f.split("\n", 1)[0].strip(): f for f in funcs
              if BS_COMBINE_KERNEL in f.split("\n", 1)[0]}
    need(len(bodies) == len(bs_combine_instantiations()),
         f"bs_combine_kernel: {len(bodies)} instantiations in the SASS, "
         f"expected {len(bs_combine_instantiations())}")
    counts = {}
    for head, body in bodies.items():
        m = re.search(BS_COMBINE_KERNEL + r"ILi(\d)ELi(\d)ELb([01])ELi(\d)E",
                      head)
        need(m, f"{head}: not bs_combine_kernel<WIRE, F, REQUANT, S>")
        requant = m.group(3) == "1"
        nl, ns = len(re.findall(ldg, body)), len(re.findall(stg, body))
        need(nl > 0 and (ns > 0 or requant),
             f"{head}: 128-bit loads {nl}, stores {ns}")
        counts.setdefault("requant" if requant else "round-closing",
                          set()).add((nl, ns))
    info = {k: v for k, v in ptx.items() if BS_COMBINE_KERNEL in k}
    need(len(info) == len(bodies),
         f"bs_combine_kernel: {len(info)} ptxas reports for {len(bodies)}")
    spills = {k: v for k, v in info.items() if v[1]}
    need(not spills, f"bs_combine_kernel: ptxas spills {spills}")
    by_mode = {}
    for k, v in info.items():
        m = re.search(BS_COMBINE_KERNEL + r"ILi\dELi\dELb([01])ELi(\d)E", k)
        key = f"S={m.group(2)}" if m.group(1) == "1" else "round-closing"
        by_mode.setdefault(key, []).append(v[0])
    print(f"bs_combine_kernel: {len(bodies)} instantiations, 128-bit (LDG, "
          f"STG) {dict((k, sorted(v)) for k, v in counts.items())}; ptxas "
          f"registers {dict((k, f'{min(v)}-{max(v)}') for k, v in sorted(by_mode.items()))}, "
          f"no spills")


# B1 on fp8 payloads (csrc/combine.cu OpFP8<F, W>, csrc/fp8_hw.cuh): the
# hardware fp8 conversions SUM and PROD must carry, by wire (W 1 e4m3fn:
# the pairwise decode and the satfinite encode; W 2 e5m2: the encode, its
# decode a byte move), and the opcodes of common.cuh's software decode
# and encode (int -> float, float -> int, rintf) that no instantiation
# may carry
FP8_SASS = {"1": ("F2FP.F16.E4M3.UNPACK_B", "F2FP.SATFINITE.E4M3.F16"),
            "2": ("F2FP.SATFINITE.E5M2.F16",)}
SOFTWARE_FP8_OPS = ("I2F", "I2FP", "F2I", "FRND")


def fp8_combine_checked():
    """Each of B1's eight fp8 instantiations (``combine_kernel<OpFP8<F,
    W>>``, F SUM/MAX/MIN/PROD, W e4m3fn/e5m2): SUM and PROD carry the
    hardware fp8 conversions (``FP8_SASS``), MAX and MIN none (they work
    on the codes), no instantiation the software decode's or encode's
    opcodes (``SOFTWARE_FP8_OPS``); each loads and stores 16-byte
    vectors; ptxas reports no spill. Prints each one's SASS instruction
    count and registers beside ``OpBF16<SUM>``'s; fails otherwise."""
    import re
    from accl_tpu_torch.constants import ReduceFunc
    funcs, ptx = sass_and_ptxas()
    ldg, stg = r"LDG\.E(?:\.\w+)*\.128", r"STG\.E(?:\.\w+)*\.128"

    def ops(body):                   # the opcodes, NOPs left out
        return [o for o in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+"
                                      r"\s+)?([A-Z][A-Z0-9_.]*)", body)
                if o != "NOP"]

    bodies, bf16 = {}, None
    for f in funcs:
        head = f.split("\n", 1)[0].strip()
        m = re.search(r"\d+combine_kernelI5OpFP8ILi(\d)ELi(\d)EEEv", head)
        if m:
            bodies[(int(m.group(1)), m.group(2))] = (head, f)
        elif re.search(r"\d+combine_kernelI6OpBF16ILi0EEEv", head):
            bf16 = (head, f)
    need(bf16 is not None, "combine_kernel<OpBF16<SUM>> not in the SASS")
    want = {(f, w) for f in range(4) for w in FP8_SASS}
    need(set(bodies) == want, f"combine_kernel<OpFP8>: instantiations "
         f"{sorted(bodies)} in the SASS, want {sorted(want)}")
    counts = {}
    for (func, w), (head, body) in sorted(bodies.items()):
        names = ops(body)
        what = f"combine_kernel<OpFP8<{ReduceFunc(func).name}, {w}>>"
        arith = func in (0, 3)
        for form in FP8_SASS[w]:
            have = any(o.startswith(form) for o in names)
            need(have == arith,
                 f"{what}: {form} {'missing' if arith else 'present'}")
        if not arith:
            need(not any(o.startswith("F2FP") for o in names),
                 f"{what}: a conversion where MAX and MIN work on codes")
        soft = sorted({o for o in names if o.split(".")[0] in
                       SOFTWARE_FP8_OPS})
        need(not soft, f"{what}: software decode/encode opcodes {soft}")
        need(re.search(ldg, body) and re.search(stg, body),
             f"{what}: no 128-bit loads or stores")
        reg = ptx.get(head.split()[0])
        need(reg is not None and reg[1] == 0, f"{what}: ptxas {reg}")
        wire = "e4m3fn" if w == "1" else "e5m2"
        counts[f"{ReduceFunc(func).name}/{wire}"] = (
            f"{len(names)} ({reg[0]} registers)")
    conv = sorted({o for (_, w), (_, body) in bodies.items()
                   for o in ops(body) if o.startswith("F2FP")})
    reg = ptx.get(bf16[0].split()[0], ["?"])
    print(f"combine_kernel<OpFP8>: 8 instantiations, SASS instructions "
          f"{counts}; OpBF16<SUM> {len(ops(bf16[1]))} ({reg[0]} registers);"
          f" fp8 conversions {conv}; no software decode or encode, "
          f"128-bit (LDG, STG), no spills")


# the 16-bit element types of the tensor-core route as the mangled names
# hold them, and the column tiers it is built on
WGMMA_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "f16"}
WGMMA_TIERS = (64, 128, 192, 256)


def wgmma_kernels_checked():
    """The 16-bit route's kernels in the built library (B8, B9 and B12's
    prefill route, B10, B11), one instantiation per element type (bf16,
    f16) and column tier (64, 128, 192, 256): each one's SASS holds
    HGMMA (Hopper's warpgroup MMA: the tensor cores) on operands of its
    type (the f16 ones without the BF16 suffix, the bf16 ones with it)
    and ptxas reports no spills. Prints the HGMMA forms, counts and
    registers by type and tier; fails otherwise. Then the split-KV
    decode kernels' registers and spill bytes (printed, failing on a
    spill)."""
    import re
    from accl_tpu_torch import _build
    funcs, ptx = sass_and_ptxas()
    for kern in WGMMA_KERNELS:
        bodies = {}
        for f in funcs:
            head = f.split("\n", 1)[0]
            m = re.search(r"I(\w+?)Li(\d+)E", head)
            if kern in head and m and m.group(1) in WGMMA_TYPES:
                bodies[(WGMMA_TYPES[m.group(1)], int(m.group(2)))] = f
        want = {(t, d) for t in WGMMA_TYPES.values() for d in WGMMA_TIERS}
        need(set(bodies) == want, f"{kern}: instantiations "
             f"{sorted(bodies)} in the SASS, want {sorted(want)}")
        counts, forms = {}, {}
        for (t, d), body in bodies.items():
            ops = re.findall(r"HGMMA\.(\S+)", body)
            counts[f"{t}/{d}"] = len(ops)
            forms.setdefault(t, set()).update(
                re.sub(r"^\d+x\d+x\d+\.", "", o) for o in ops)
            need(ops, f"{kern} {t} tier {d}: no HGMMA in its SASS")
            bf = [o for o in ops if "BF16" in o]
            need(len(bf) == (len(ops) if t == "bf16" else 0),
                 f"{kern} {t} tier {d}: HGMMA forms {sorted(set(ops))} "
                 f"do not take {t} operands")
        info = {k: v for k, v in ptx.items() if kern in k}
        need(len(info) == len(bodies), f"{kern}: {len(info)} ptxas reports "
             f"for {len(bodies)} instantiations")
        need(all(v[1] == 0 for v in info.values()),
             f"{kern}: ptxas spills {info}")
        regs = {}
        for k, v in info.items():
            m = re.search(r"I(\w+?)Li(\d+)E", k)
            regs[f"{WGMMA_TYPES.get(m.group(1), m.group(1))}/"
                 f"{m.group(2)}"] = v[0]
        print(f"{kern}: {len(bodies)} instantiations (bf16, f16 x column "
              f"tiers {WGMMA_TIERS}), HGMMA forms "
              f"{ {t: sorted(f) for t, f in sorted(forms.items())} }, HGMMA "
              f"instructions {dict(sorted(counts.items()))}; ptxas "
              f"registers {dict(sorted(regs.items()))}, no spills")
    info = {k: v for k, v in ptx.items() if SPLIT_KERNEL in k}
    need(info, f"{SPLIT_KERNEL}: no ptxas report in the build log")
    need(all(v[1] == 0 for v in info.values()),
         f"{SPLIT_KERNEL}: ptxas spills {info}")
    print(f"{SPLIT_KERNEL}: {len(info)} instantiations (f32/bf16/f16 x "
          f"column tiers 16-256 x rows 1/2/4); ptxas registers "
          f"{sorted(v[0] for v in info.values())}, no spills")
    wide = {}
    types = {"f": "f32", **WGMMA_TYPES}
    for k, v in ptx.items():
        m = re.search(WIDE_SPLIT_KERNEL + r"I(\w+?)Li(\d+)ELi(\d+)E", k)
        if m and m.group(1) in types:
            wide[(types[m.group(1)], int(m.group(2)), int(m.group(3)))] = v
    need(set(wide) == {(t, dp, gr) for t in types.values()
                       for dp in (512, 1024, 2048) for gr in (1, 2, 4, 8)},
         f"{WIDE_SPLIT_KERNEL}: ptxas reports {sorted(wide)}")
    need(all(v[1] == 0 for v in wide.values()),
         f"{WIDE_SPLIT_KERNEL}: ptxas spills {wide}")
    print(f"{WIDE_SPLIT_KERNEL}: {len(wide)} instantiations (f32, bf16, "
          f"f16 x column tiers 512/1024/2048 x rows 1/2/4/8); ptxas "
          f"registers { {f'{t}/{dp}/{gr}': v[0] for (t, dp, gr), v in sorted(wide.items())} }"
          f", no spills")
    for ln in _build.build_log.splitlines():
        if "wgmma" in ln.lower() and ("warning" in ln.lower()
                                      or "Performance" in ln):
            print(f"  ptxas: {ln.strip()}")
            # ptxas waits out each wgmma before the next (C7515)
            need("serialized" not in ln or not any(
                k in ln for k in WGMMA_KERNELS + CLUSTER_WGMMA_KERNELS),
                "a tensor-core kernel's wgmma were serialized by ptxas")


def tf32_kernels_checked():
    """The f32 route of B8, B9, the B12 prefill, B10 and B11 in the built
    library: every instantiation (column tiers 16/32/64/128/256) holds
    TF32 HMMA instructions (mma.sync on the tensor cores) and ptxas
    reports no spills. Prints the counts and the registers by tier;
    fails otherwise."""
    import re
    funcs, ptx = sass_and_ptxas()
    for name, (pat, src) in TF32_KERNELS.items():
        bodies = {f.split("\n", 1)[0].strip(): f for f in funcs
                  if re.search(pat, f.split("\n", 1)[0])}
        need(len(bodies) == 5, f"{name}: {len(bodies)} f32-route "
             f"instantiations in the SASS, want 5 (tiers 16-256)")
        counts = {}
        for head, body in bodies.items():
            m = re.search(r"ILi(\d+)E", head)
            counts[int(m.group(1)) if m else head] = len(
                re.findall(TF32_HMMA, body))
        need(min(counts.values()) > 0, f"{name}: an f32-route "
             f"instantiation without TF32 HMMA ({counts})")
        info = {k: v for k, v in ptx.items() if re.search(pat, k)}
        need(len(info) == len(bodies), f"{name}: {len(info)} ptxas "
             f"reports for {len(bodies)} kernels")
        need(all(v[1] == 0 for v in info.values()),
             f"{name}: ptxas spills {info}")
        regs = {int(m.group(1)): v[0] for k, v in info.items()
                for m in [re.search(r"ILi(\d+)E", k)] if m}
        print(f"{name} f32 route ({src}, 3xTF32 on mma.sync): "
              f"{len(bodies)} instantiations, TF32 HMMA instructions by "
              f"column tier {dict(sorted(counts.items()))}; ptxas registers "
              f"{dict(sorted(regs.items()))}, no spills")


# the column-group forms (head dims past 256): the 16-bit kernels, one
# instantiation per element type, and the f32 ones (the f32 backward's
# cluster form to D 4096, its column-group form past it)
# the 16-bit B10's cluster form (head dims 256 < D <= 1024)
# and B8, B9, the B12 chunks and B11 (256 < D <= 2048)
CLUSTER_WGMMA_KERNELS = ("attn_bwd_dkv_cluster_wgmma_kernel",
                         "attn_fwd_cluster_wgmma_kernel",
                         "attn_bwd_dq_cluster_wgmma_kernel")
COLS_WGMMA_KERNELS = ("attn_fwd_cols_wgmma_kernel", *CLUSTER_WGMMA_KERNELS,
                      "attn_bwd_dkv_cols_wgmma_kernel",
                      "attn_bwd_dq_cols_wgmma_kernel")
COLS_TF32_KERNELS = ("attn_fwd_cluster_kernel", "attn_decode_cluster_kernel",
                     "attn_fwd_band_score_kernel", "attn_fwd_band_pv_kernel",
                     "attn_bwd_dkv_cluster_kernel",
                     "attn_bwd_dq_cluster_kernel",
                     "attn_bwd_band_score_kernel", "attn_bwd_band_dkv_kernel",
                     "attn_bwd_band_dq_kernel")
# the f32 kernels built from templates, by their instantiations: the
# cluster kernels (forward and backward) for each count of 64-column
# slices a block holds (attention_cluster.cuh's cluster_ns); the band
# form's score pass for B11's stores (0) and B10's (1)
F32_CLUSTER_NS = (2, 4, 8)
F32_TEMPLATES = {"attn_fwd_cluster_kernel": set(F32_CLUSTER_NS),
                 "attn_decode_cluster_kernel": set(F32_CLUSTER_NS),
                 "attn_bwd_dkv_cluster_kernel": set(F32_CLUSTER_NS),
                 "attn_bwd_dq_cluster_kernel": set(F32_CLUSTER_NS),
                 "attn_bwd_band_score_kernel": {0, 1}}
# the f32 single-token decode past 256: one instantiation for each column
# tier (512, 1024, 2048) and rows of the group a block (8, 4, 2, 1)
WIDE_SPLIT_KERNEL = "attn_decode_split_wide_kernel"
# the f32 single-token decode past 2048 (CUDA cores, no tensor core): its
# two passes, one instantiation for each rows of the group a block
BAND_DECODE_KERNELS = ("attn_decode_band_score_kernel",
                       "attn_decode_band_pv_kernel")
BAND_DECODE_ROWS = (1, 2, 4, 8)
# the f32 band forward's normalisation pass (CUDA cores, no tensor core)
BAND_NORM_KERNEL = "attn_fwd_band_norm_kernel"


def cols_kernels_checked():
    """The column-group kernels in the built library: each 16-bit one
    instantiated for bf16 and f16, with HGMMA on operands of its type;
    each f32 one with TF32 HMMA, the f32 cluster kernels (B8/B9, the B12
    chunks, B10, B11) in each of their instantiations (2, 4 and 8 slices
    a block), and the band forms' (the forward's score and product
    passes; the backward's score pass for B10's and B11's stores, its two
    product passes); the f32 band decode's two passes (CUDA cores) for
    each rows of the group a block and the band forward's normalisation;
    ptxas reports no spills for any.
    Prints the counts, registers and spill bytes; fails otherwise."""
    import re
    funcs, ptx = sass_and_ptxas()
    for kern in COLS_WGMMA_KERNELS:
        bodies = {}
        for f in funcs:
            head = f.split("\n", 1)[0]
            m = re.search(r"I(\w+?)EEv", head)
            if kern in head and m and m.group(1) in WGMMA_TYPES:
                bodies[WGMMA_TYPES[m.group(1)]] = f
        need(set(bodies) == set(WGMMA_TYPES.values()),
             f"{kern}: instantiations {sorted(bodies)} in the SASS")
        counts = {}
        for t, body in bodies.items():
            ops = re.findall(r"HGMMA\.(\S+)", body)
            bf = [o for o in ops if "BF16" in o]
            need(ops and len(bf) == (len(ops) if t == "bf16" else 0),
                 f"{kern} {t}: HGMMA forms {sorted(set(ops))}")
            counts[t] = len(ops)
        info = {k: v for k, v in ptx.items() if kern in k}
        need(len(info) == 2 and all(v[1] == 0 for v in info.values()),
             f"{kern}: ptxas reports {info}")
        print(f"{kern}: bf16 and f16, HGMMA instructions {counts}; ptxas "
              f"registers {sorted(v[0] for v in info.values())}, no spills")
    for kern in COLS_TF32_KERNELS:
        pat = rf"\d+{kern}"
        # by instantiation (F32_TEMPLATES), None for the kernels that are
        # no templates
        bodies, info = {}, {}
        for f in funcs:
            head = f.split("\n", 1)[0]
            if re.search(pat, head):
                m = re.search(r"IL[ib](\d+)E", head)
                bodies[int(m.group(1)) if m else None] = f
        for k, v in ptx.items():
            if re.search(pat, k):
                m = re.search(r"IL[ib](\d+)E", k)
                info[int(m.group(1)) if m else None] = v
        want = F32_TEMPLATES.get(kern, {None})
        need(set(bodies) == want, f"{kern}: instantiations "
             f"{sorted(bodies, key=str)} in the SASS, want "
             f"{sorted(want, key=str)}")
        counts = {ns: len(re.findall(TF32_HMMA, body))
                  for ns, body in bodies.items()}
        need(min(counts.values()) > 0,
             f"{kern}: an instantiation without TF32 HMMA ({counts})")
        need(set(info) == want and all(v[1] == 0 for v in info.values()),
             f"{kern}: ptxas reports {info}")
        if want == {None}:
            print(f"{kern}: TF32 HMMA instructions {counts[None]}; ptxas "
                  f"registers {[info[None][0]]}, no spills")
        else:
            regs = {ns: v[0] for ns, v in sorted(info.items())}
            spills = {ns: v[1] for ns, v in sorted(info.items())}
            print(f"{kern}: {len(bodies)} instantiations "
                  f"{sorted(want)}, TF32 HMMA instructions "
                  f"{dict(sorted(counts.items()))}; ptxas registers {regs}, "
                  f"spill bytes {spills}")
    for kern in BAND_DECODE_KERNELS:
        regs = {}
        for k, v in ptx.items():
            m = re.search(kern + r"IfLi(\d+)E", k)
            if m:
                need(v[1] == 0, f"{kern}<{m.group(1)}>: ptxas spills {v}")
                regs[int(m.group(1))] = v[0]
        need(set(regs) == set(BAND_DECODE_ROWS),
             f"{kern}: f32 instantiations by rows {sorted(regs)}, want "
             f"{BAND_DECODE_ROWS}")
        print(f"{kern}: f32, rows of the group a block {BAND_DECODE_ROWS}; "
              f"ptxas registers {dict(sorted(regs.items()))}, no spills")
    norm = [v for k, v in ptx.items()
            if re.search(rf"\d+{BAND_NORM_KERNEL}", k)]
    need(len(norm) == 1 and norm[0][1] == 0,
         f"{BAND_NORM_KERNEL}: ptxas reports {norm}")
    print(f"{BAND_NORM_KERNEL}: ptxas registers {norm[0][0]}, no spills")


def bwd_operands(q, k, v, do, causal):
    """The forward's O and LSE (B8/B9) and delta = rowsum(do * o) from O
    in q's dtype, as ``_FlashAttention.backward`` forms them."""
    from accl_tpu_torch.ops import attention as A
    B, H, Sq, _ = q.shape
    o, lse = A.flash_attention_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).reshape(B * H, Sq)
    return o, lse, delta


def hold_bwd_by_kv_head(args, what: str) -> tuple[float, float]:
    """B10 and B11 on f32 ``args`` (the wrappers' operands) against their
    plain versions under BWD_TOL, the plain versions run one kv head at a
    time: a long sequence's dense scores for every head would not fit."""
    import torch
    from accl_tpu_torch.ops import attention as A
    q, do, k, v, lse, delta, causal, scale = args
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    plain = {"dk": [], "dv": [], "dq": []}
    for j in range(Hkv):
        hs = slice(j * g, (j + 1) * g)
        sub = (q[:, hs], do[:, hs], k[:, j:j + 1], v[:, j:j + 1],
               lse.view(B, H, Sq)[:, hs].reshape(B * g, Sq),
               delta.view(B, H, Sq)[:, hs].reshape(B * g, Sq), causal, scale)
        dk, dv = A.flash_attention_bwd_dkv_ref(*sub)
        plain["dk"].append(dk.view(B, g, Skv, D))
        plain["dv"].append(dv.view(B, g, Skv, D))
        plain["dq"].append(A.flash_attention_bwd_dq_ref(*sub))
        del sub, dk, dv
        torch.cuda.empty_cache()
    plain = {part: torch.cat(ts, 1) for part, ts in plain.items()}
    got = dict(zip(("dk", "dv"), A.flash_attention_bwd_dkv(*args)))
    got["dq"] = A.flash_attention_bwd_dq(*args)
    w = (0.0, 0.0)
    for part in ("dk", "dv", "dq"):
        want = plain[part].reshape(got[part].shape)
        w = max_pair(w, hold_bwd(got[part], want, f"{what} {part}", part))
    return w


def hold_bwd_call(q, do, k, v, lse, delta, causal, what):
    """B10 and B11 on one set of operands against their plain versions."""
    from accl_tpu_torch.ops import attention as A
    args = (q, do, k, v, lse, delta, causal, q.shape[-1] ** -0.5)
    w = hold_bwd_outputs(args, A.flash_attention_bwd_dkv(*args),
                         f"{what} B10")
    return max_pair(w, hold_bwd_outputs(
        args, (A.flash_attention_bwd_dq(*args),), f"{what} B11"))


def attention_bwd_edges(rng):
    """B10 and B11 against their plain versions over an edge corpus:
    MHA/GQA/MQA, causal and not, ragged S, Sq != Skv both ways, every
    head dim, f32 and bf16."""
    import torch
    cases = [  # B, H, Hkv, Sq, Skv, D, causal
        (1, 4, 4, 130, 130, 16, True), (1, 4, 4, 130, 130, 32, False),
        (2, 8, 2, 300, 300, 64, True), (1, 8, 2, 300, 300, 64, False),
        (1, 8, 1, 513, 513, 128, True), (1, 8, 1, 513, 513, 128, False),
        (1, 4, 2, 40, 96, 16, True), (1, 4, 2, 40, 96, 32, False),
        (1, 4, 2, 200, 70, 64, True), (2, 4, 4, 96, 40, 128, False)]
    for dt in (torch.float32, torch.bfloat16):
        worst, ratios = (0.0, 0.0), []
        for B, H, Hkv, Sq, Skv, D, causal in cases:
            q, do = (torch.from_numpy(rng.standard_normal(
                (B, H, Sq, D))).to("cuda", dt) for _ in range(2))
            k, v = (torch.from_numpy(rng.standard_normal(
                (B, Hkv, Skv, D))).to("cuda", dt) for _ in range(2))
            _o, lse, delta = bwd_operands(q, k, v, do, causal)
            case = (B, H, Hkv, Sq, Skv, D, causal)
            w = hold_bwd_call(q, do, k, v, lse, delta, causal,
                              f"attn bwd {dt} {case}")
            worst = max_pair(worst, w)
            ratios.append(round(w[1], 3))
        src = ATTN_BWD_SM90_SRC if dt == torch.bfloat16 else ATTN_BWD_SRC
        print(f"attention backward edges, {str(dt)[6:]} ({src}): "
              f"{len(cases)} cases (B10 and B11; MHA/GQA/MQA, causal and "
              f"not, ragged 130/300/513, Sq != Skv both ways, D 16-128) "
              f"within tolerance; max abs err {worst[0]}, largest "
              f"error/limit {worst[1]:.3f}, per case {ratios} ({BWD_TOL})")


def dense_topleft(q, k, v, causal=True):
    """Dense f32 attention with the reference's top-left causal mask, GQA
    by repeating KV: differentiable by torch autograd."""
    import torch
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        Sq, Skv = q.shape[2], k.shape[2]
        rows = torch.arange(Sq, device=q.device)
        mask = torch.arange(Skv, device=q.device)[None, :] <= rows[:, None]
        s = torch.where(mask, s, torch.finfo(torch.float32).min)
    return torch.matmul(torch.softmax(s, dim=-1), v)


def attention_bwd_records():
    """B10 and B11 at the full Llama-3-8B width (B=4, H=32, Hkv=8, S=2048,
    D=128, causal), bf16 and f32 (the table's rows, the f32 ones named
    ``*_tf32``), against their plain versions, each kernel run twice on
    the same inputs (the f32 route must repeat bitwise), timed beside
    PyTorch's SDPA backward (dq, dk and dv together: the library time of
    the pair; timed only). The f32 route's bound is three TF32 products
    at the tensor cores' rate; the CUDA cores' f32 bound is printed
    beside it. Then the whole Function's gradients against torch autograd
    through dense attention at the same shape: bf16 (relative L2, SDPA's
    beside it) and f32."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"attention backward: allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    B, H, Hkv, S, D = 4, 32, 8, 2048, 128
    n = S * (S + 1) // 2 * B * H           # visible scores, causal
    recs = []
    for dt in (torch.bfloat16, torch.float32):
        q, do = (torch.randn(B, H, S, D, device="cuda", generator=g).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, Hkv, S, D, device="cuda", generator=g).to(dt)
                for _ in range(2))
        _o, lse, delta = bwd_operands(q, k, v, do, True)
        scale = D ** -0.5
        args = (q, do, k, v, lse, delta, True, scale)
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            enable_gqa=True)
        library_ms = time_ms(lambda: torch.autograd.grad(  # noqa: B023
            lo, (lq, lk, lv), do, retain_graph=True))
        del lo, lq, lk, lv
        es = q.element_size()
        qbytes, kvbytes = B * H * S * D * es, B * Hkv * S * D * es
        bf16 = dt == torch.bfloat16
        pair_ms, worst = 0.0, (0.0, 0.0)
        for name, fn, plain, ops_per, out_bytes in (
                ("attn_bwd_dkv", A.flash_attention_bwd_dkv,
                 A.flash_attention_bwd_dkv_ref, 8, 2 * B * H * S * D * 4),
                ("attn_bwd_dq", A.flash_attention_bwd_dq,
                 A.flash_attention_bwd_dq_ref, 6, qbytes)):
            outs = fn(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            k_err, k_ratio = hold_bwd_outputs(args, outs, f"full width "
                                              f"{dt} {name}")
            worst = max_pair(worst, (k_err, k_ratio))
            again = fn(*args)
            again = again if isinstance(again, tuple) else (again,)
            repeat = all(torch.equal(a, b) for a, b in zip(outs, again))
            need(repeat or bf16, f"{name} f32: a repeat on the same inputs "
                 f"is not bitwise equal")
            del outs, again
            ms = time_ms(lambda: fn(*args))  # noqa: B023
            plain_ms = time_ms(lambda: plain(*args), reps=5)  # noqa: B023
            pair_ms += ms
            nbytes = 2 * qbytes + 2 * kvbytes + 2 * 4 * B * H * S + out_bytes
            ops = ops_per * D * n
            if bf16:
                bms, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
                src, route = ATTN_BWD_SM90_SRC, "tensor cores, wgmma"
                bounds = (f"bound {bms:.4f} ms by {by}, {bms / ms:.1%} of "
                          f"bound")
            else:
                # three TF32 products a product (3xTF32); beside it the
                # CUDA cores' f32 rate for the same products
                bms, by = bound_ms(nbytes, 3 * ops, TF32_OPS_PER_S)
                core_ms, _ = bound_ms(nbytes, ops, F32_OPS_PER_S)
                src, route = ATTN_BWD_SRC, "tensor cores, 3xTF32"
                bounds = (f"bound {bms:.4f} ms by {by} at 3 x ops / 495 "
                          f"TFLOP/s, {bms / ms:.1%} of it; CUDA-core bound "
                          f"{core_ms:.4f} ms at ops / 67 TFLOP/s, "
                          f"{core_ms / ms:.1%} of it")
            print(f"kernel {name} {str(dt)[6:]} ({src}; {route}) B={B} "
                  f"H={H} Hkv={Hkv} D={D} S={S} causal: {ms:.4f} ms (plain "
                  f"{plain_ms:.4f} ms, sdpa backward (dq, dk, dv together) "
                  f"{library_ms:.4f} ms, {bounds}); max abs err vs plain "
                  f"{k_err}, largest error/limit {k_ratio:.3f}; a repeat "
                  f"bitwise equal: {repeat} ({BWD_TOL})")
            recs.append({"name": name if bf16 else name + "_tf32",
                         "route": "cuda", "source": src,
                         "replaces": {"attn_bwd_dkv":
                                      "accl_tpu/ops/attention.py:461",
                                      "attn_bwd_dq":
                                      "accl_tpu/ops/attention.py:492"}[name],
                         "launches": 0, "max_abs_err": k_err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bms,
                         "bound_by": by, "library_ms": library_ms})
        print(f"B10 + B11 {str(dt)[6:]}: {pair_ms:.4f} ms, "
              f"{pair_ms / library_ms:.3f}x SDPA's backward "
              f"({library_ms:.4f} ms); B10+B11 max abs err vs plain "
              f"{worst[0]}, largest error/limit {worst[1]:.3f}")
        del q, do, k, v, lse, delta, args
        torch.cuda.empty_cache()

    # the bf16 Function (B8 + B10 + B11 on the tensor-core route) and
    # SDPA's bf16 backward against f32 dense autograd on the same
    # bf16-valued inputs, relative L2
    x = [torch.randn(B, h, S, D, device="cuda", generator=g).to(
        torch.bfloat16) for h in (H, Hkv, Hkv, H)]
    do = x[3]
    leaves = [t.float().requires_grad_() for t in x[:3]]
    want = torch.autograd.grad(dense_topleft(*leaves), leaves, do.float())
    del leaves
    torch.cuda.empty_cache()
    fl = [t.clone().requires_grad_() for t in x[:3]]
    got = torch.autograd.grad(A.flash_attention(*fl, causal=True), fl, do)
    sl = [t.clone().requires_grad_() for t in x[:3]]
    lib = torch.autograd.grad(F.scaled_dot_product_attention(
        *sl, is_causal=True, enable_gqa=True), sl, do)
    del fl, sl
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, lib):
        need(a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()),
             f"bf16 Function {name}: dtype {a.dtype} or non-finite")
        norm = torch.linalg.vector_norm(b)
        rel = float(torch.linalg.vector_norm(a.float() - b) / norm)
        rel_sdpa = float(torch.linalg.vector_norm(c.float() - b) / norm)
        print(f"bf16 Function {name} (B8 + B10 + B11, tensor-core route) vs "
              f"f32 dense autograd on the same bf16 inputs, (4, 32/8, 2048, "
              f"128) causal: relative L2 {rel:.4g} (limit {FN_BF16_REL_L2}); "
              f"SDPA bf16 backward {rel_sdpa:.4g}")
        need(rel <= FN_BF16_REL_L2, f"bf16 Function {name}: relative L2 "
             f"{rel:.4g} past {FN_BF16_REL_L2}")
    del x, do, got, want, lib
    torch.cuda.empty_cache()

    # the Function (B8 + B10 + B11) against dense autograd, f32
    q, k, v = (torch.randn(B, h, S, D, device="cuda", generator=g)
               .requires_grad_() for h in (H, Hkv, Hkv))
    do = torch.randn(B, H, S, D, device="cuda", generator=g)
    got = torch.autograd.grad(A.flash_attention(q, k, v, causal=True),
                              (q, k, v), do)
    want = torch.autograd.grad(dense_topleft(q, k, v), (q, k, v), do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        need(bool(torch.isfinite(a).all()), f"Function {name}: non-finite")
        lim = FN_DENSE_REL * b.abs() + FN_DENSE_REL * float(b.abs().max())
        r = float(((a - b).abs() / lim).max())
        print(f"Function {name} (B8 + B10 + B11) vs dense autograd, f32, "
              f"(4, 32/8, 2048, 128) causal: max abs diff "
              f"{float((a - b).abs().max()):.4g}, largest error/limit "
              f"{r:.3f} (1e-4*|dense| + 1e-4*max|dense|)")
        need(r <= 1.0, f"Function {name}: flash and dense gradients differ")
    del q, k, v, do, got, want
    torch.cuda.empty_cache()
    return recs


def grad_check_phase():
    """Flash against dense, f32, full width, 2 layers, B=1, S=2048: one
    model, its config switched between the two; the loss and every
    parameter's gradient. Phase 10c: the same model's loss over a mesh
    of 4 ranks on the sp axis (ring attention, f32 B9, B10 and B11 a
    visible block) against the unsharded flash run. Phase 11b: the same
    over a tp axis of each TP_GRAD_SIZES size (B8, B10 and B11 once a
    layer over every rank's head shard). Returns the flash run's
    attention launches (the f32 path of B10 and B11: 3xTF32)."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama, LlamaConfig
    from accl_tpu_torch.parallel import make_mesh
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2,
                              dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    model = Llama(cfg).init(g).requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                           generator=g)
    sp_mesh = make_mesh((4,), ("sp",))
    runs = {}
    for run, attention, kw in (("flash", "flash", {}),
                               ("dense", "dense", {}),
                               ("sp", "flash", dict(sp="sp", mesh=sp_mesh))):
        if run == "sp":
            phase("phase 10c: sequence-parallel gradients, f32")
        if run != "dense":
            zero_attention_counters()
        model.config = dataclasses.replace(cfg, attention=attention)
        model.zero_grad(set_to_none=True)
        loss = model.loss(tokens, **kw)
        loss.backward()
        runs[run] = (loss.item(), {k: p.grad for k, p in
                                   model.named_parameters()})
        if run == "flash":
            flash_launches = attention_counters()
    model.config = cfg
    sp_launches = attention_counters()

    def compare(a, b, what):
        (la, ga), (lb, gb) = runs[a], runs[b]
        need(np.isfinite(la) and np.isfinite(lb),
             f"{what}: non-finite loss")
        loss_rel = abs(la - lb) / abs(lb)
        rels = {k: float(torch.linalg.vector_norm(ga[k] - gb[k])
                         / torch.linalg.vector_norm(gb[k])) for k in gb}
        worst = max(rels, key=rels.get)
        print(f"{what}, Llama-3-8B width, 2 layers, f32, (1, 2048): loss "
              f"{la:.7f} vs {lb:.7f} (relative {loss_rel:.3g}, limit "
              f"{GRAD_LOSS_REL}); worst gradient {worst} relative L2 "
              f"{rels[worst]:.3g} (limit {GRAD_REL_L2}); median "
              f"{statistics.median(rels.values()):.3g} over {len(rels)} "
              f"parameters")
        need(loss_rel <= GRAD_LOSS_REL, f"{what}: losses differ")
        need(rels[worst] <= GRAD_REL_L2, f"{what}: {worst} gradients "
             f"differ")

    compare("flash", "dense", "grad check, flash vs dense")
    print(f"grad check launches (path grad_check, the flash run): "
          f"{flash_launches}")
    for key in ("attn_bwd_dkv", "attn_bwd_dq"):
        need(flash_launches[key] == cfg.n_layers, f"grad check: {key} "
             f"launched {flash_launches[key]} times, want {cfg.n_layers}")
    need_routes(flash_launches, False, "grad check")
    blocks = 4 * 5 // 2 * cfg.n_layers
    print(f"sp gradient launches: {sp_launches}")
    for key in ("attn_fwd_single", "attn_bwd_dkv", "attn_bwd_dq"):
        need(sp_launches[key] == blocks, f"sp gradients: {key} launched "
             f"{sp_launches[key]} times, want {blocks}")
    need_routes(sp_launches, False, "sp gradients")
    compare("sp", "flash", "sp gradients (sp = 4, ring attention) vs the "
            "unsharded flash model")
    del runs["dense"], runs["sp"]
    L = cfg.n_layers
    for T in TP_GRAD_SIZES:
        phase(f"phase 11b: tensor-parallel gradients, f32, tp = {T}")
        zero_tp_counts()
        model.zero_grad(set_to_none=True)
        loss = model.loss(tokens, mesh=make_mesh((T,), ("tp",)))
        loss.backward()
        runs["tp"] = (loss.item(), {k: p.grad for k, p in
                                    model.named_parameters()})
        launches = tp_counts()
        print(f"tp gradient launches: {launches}")
        need_tp_launches(launches, {
            "attn_fwd": L, "attn_bwd_dkv": L, "attn_bwd_dq": L,
            "tp_allreduce": 2 * (2 * L + 1)}, f"tp {T} gradients")
        need_routes(launches, False, f"tp {T} gradients")
        compare("tp", "flash", f"tp gradients (tp = {T}, "
                f"{cfg.n_heads // T}/{cfg.n_kv_heads // T} heads a rank) vs "
                f"the unsharded flash model")
        del runs["tp"], loss
    del model, runs
    torch.cuda.empty_cache()
    return flash_launches


@contextlib.contextmanager
def recorded_calls(names, n_layers: int):
    """Record the calls of the attention module's wrappers ``names`` that
    the first and last layer of one model pass make (the first n_layers
    calls of each) as (wrapper name, args, outputs). The model and
    ``_FlashAttention`` look these names up at each call."""
    from accl_tpu_torch.ops import attention as A
    calls = []
    seen = dict.fromkeys(names, 0)
    wrapped = {name: getattr(A, name) for name in names}

    def recorder(name):
        def call(*args):
            out = wrapped[name](*args)
            if seen[name] in (0, n_layers - 1):
                kept = tuple(t.clone() for t in (out if isinstance(out, tuple)
                                                 else (out,)))
                calls.append((name, args, kept))
            seen[name] += 1
            return out
        return call

    for name in names:
        setattr(A, name, recorder(name))
    try:
        yield calls
    finally:
        for name, fn in wrapped.items():
            setattr(A, name, fn)


def training_phase():
    """Llama-3-8B width, 8 of 32 layers, f32 parameters and bf16
    activations: ``make_train_step`` with Adam(lr=1e-4), 4 steps on one
    batch of (2, 2048) random tokens. Returns the path's launch counts."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama, LlamaConfig
    from accl_tpu_torch.ops import attention as A
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=TRAIN_LAYERS)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    model = Llama(cfg).init(g)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = model.make_train_step(opt)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                           device="cuda", generator=g)
    N = model.param_count()
    n_mat = N - model.embed.numel() - (2 * cfg.n_layers + 1) * cfg.dim
    logits = TRAIN_B * TRAIN_S * cfg.vocab_size * 4
    est = 16 * N + 2 * n_mat + 3 * logits + cfg.n_layers * 10 ** 9
    print(f"training: Llama-3-8B width, {cfg.n_layers} of 32 layers, f32 "
          f"parameters, bf16 activations, B={TRAIN_B}, S={TRAIN_S}, Adam "
          f"lr=1e-4; {N} parameters. Memory reckoning: weights, gradients "
          f"and Adam's two moments 16 B x N = {16 * N / 2 ** 30:.1f} GiB; "
          f"bf16 weight casts saved for backward "
          f"{2 * n_mat / 2 ** 30:.1f} GiB; activations ~1 GB per layer; f32 "
          f"logits, their slice and gradient 3 x {logits / 2 ** 30:.1f} GiB;"
          f" about {est / 2 ** 30:.1f} GiB in all")
    zero_attention_counters()
    losses, times = [], []
    with recorded_calls(("flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
                        cfg.n_layers) as calls:
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(tokens)))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    launches = attention_counters()
    peak = torch.cuda.max_memory_allocated()
    print(f"training losses {losses}; step ms (host clock) {times}")
    print(f"training phase launches: {launches}")
    per_run = cfg.n_layers * TRAIN_STEPS
    need(all(np.isfinite(x) for x in losses), "training: non-finite loss")
    need(losses[-1] < losses[0], "training: the loss did not fall")
    for key in ("attn_fwd", "attn_bwd_dkv", "attn_bwd_dq"):
        need(launches[key] == per_run, f"training: {key} launched "
             f"{launches[key]} times, not once per layer per step "
             f"({per_run})")
    need_routes(launches, True, "training")
    print(f"training peak memory: {peak / 2 ** 30:.2f} GiB (the "
          f"{held / 2 ** 30:.2f} GiB held before the phase included; limit "
          f"{TRAIN_MAX_PEAK / 2 ** 30:.0f} GiB)")
    need(peak <= TRAIN_MAX_PEAK, "training: peak memory past the limit")
    kinds = {}
    with torch.no_grad():
        # B8 on the training model and batch once more (after the steps,
        # so that holding its outputs adds nothing to the peak above)
        with recorded_calls(("flash_attention_fwd",), cfg.n_layers) as fwd:
            model(tokens)
        calls += fwd
        for name, args, outs in calls:
            what = f"training {name} q {tuple(args[0].shape)}"
            if name == "flash_attention_fwd":
                plain, plain_lse = A.flash_attention_ref(*args[:5])
                w = hold_attn(outs[0], plain, what, outs[1], plain_lse,
                              fwd_route_mag("fwd", args))
                del plain, plain_lse
            else:
                w = hold_bwd_outputs(args, outs, what)
            kinds[name] = max_pair(kinds.get(name, (0.0, 0.0)), w)
    for name, w in sorted(kinds.items()):
        when = ("a forward after the steps" if name == "flash_attention_fwd"
                else "the first step")
        print(f"training {name}: the first and last layer's calls of "
              f"{when} held against the plain version at the path's "
              f"shapes ({TRAIN_B}, 32/8, {TRAIN_S}, 128) bf16; max abs err "
              f"{w[0]}, largest error/limit {w[1]:.3f} "
              f"({FWD_TOL if name == 'flash_attention_fwd' else BWD_TOL})")
    need(len(calls) == 6, f"training: {len(calls)} attention calls recorded")
    del calls
    step_ms = statistics.median(times[1:])
    tokens_n = TRAIN_B * TRAIN_S
    visible = TRAIN_S * (TRAIN_S + 1) // 2 * TRAIN_B * cfg.n_heads
    flops = 6 * n_mat * tokens_n + 12 * cfg.head_dim * visible * cfg.n_layers
    print(f"training step: {step_ms:.2f} ms (host clock, median of steps "
          f"2-{TRAIN_STEPS}), {tokens_n / step_ms * 1e3:.0f} tokens/s; "
          f"model FLOPs per step {flops:.4g} (6 x {n_mat} matmul "
          f"parameters x {tokens_n} tokens + 12 x D per visible attention "
          f"score), {flops / (step_ms / 1e3) / 1e12:.1f} TFLOP/s = "
          f"{flops / (step_ms / 1e3) / BF16_OPS_PER_S:.1%} of 989 TFLOP/s")
    # the step's two halves on CUDA events (one more step, by hand as
    # train_step runs it): loss and backward, then the optimizer
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    opt.zero_grad(set_to_none=True)
    evs[0].record()
    model.loss(tokens).backward()
    evs[1].record()
    opt.step()
    evs[2].record()
    torch.cuda.synchronize()
    fb_ms, opt_ms = evs[0].elapsed_time(evs[1]), evs[1].elapsed_time(evs[2])
    print(f"training step halves (CUDA events): loss + backward "
          f"{fb_ms:.2f} ms, Adam step {opt_ms:.2f} ms")
    fams = device_ms_by_family(lambda: step(tokens))
    if fams:
        busy = sum(fams.values())
        print(f"training step under the profiler: {busy:.2f} ms of "
              f"kernels; busy "
              f"share {busy / step_ms:.3f} of the unprofiled {step_ms:.2f} "
              f"ms step; " + ", ".join(f"{f} {ms:.2f} ms" for f, ms in
                                       sorted(fams.items(),
                                              key=lambda x: -x[1])))
    else:
        print("training step: busy share not measured (the profiler saw no "
              "device activity)")
    phase9 = {"loss": losses[0], "step_ms": step_ms, "flops": flops,
              "peak": peak, "busy": (f"{sum(fams.values()) / step_ms:.3f}"
                                     if fams else "not measured")}
    del opt, step
    sp_launches = sp_training_phase(model, tokens, phase9)
    tp_launches = tp_training_phase(model, tokens, phase9)
    del model, tokens
    torch.cuda.empty_cache()
    return launches, sp_launches, tp_launches


# -- phase 10: sequence parallelism (ring attention, Ulysses, the sp Llama) --

# The ring's bf16 limits add one bf16 rounding of each block's partial to
# FWD_TOL and BWD_TOL: B8/B9 write each block's O, and B11 each block's
# dq, in q's dtype before the f32 merge, which moves O by at most 2^-8 *
# sum_b w_b |o_b| (w_b = exp(lse_b - lse), the block's weight in the
# merge) and dq by 2^-8 * sum_b |dq_b|. The plain ring (block_update
# through the reference's schedule, torch autograd) runs on f32 copies of
# the inputs, so its gradients carry no rounding of their own, and the
# ring's carry one more: delta = rowsum(dO * O) is formed from O in q's
# dtype, as _FlashAttention forms it; ``ring_rounding_magnitudes`` adds
# that dependence to the dq and dk magnitudes m. dk and dv are bf16
# outputs (f32 sums cast once) and take BWD_TOL's dq rule. So, bf16, per
# element: O 2^-8*m + 2^-8*sum_b w_b|o_b| + 2^-7*|plain| +
# 2^-7*median|plain|; dq 2^-8*m + 2^-8*sum_b|dq_b| + the same; dk, dv
# 2^-8*m + the same. f32: O within ATTN_TOL, the gradients within
# FN_DENSE_REL (phase 8's limit for the Function against autograd). The
# unsharded kernels (B8, _FlashAttention over the whole sequence) are
# held to the plain ring under the same rules without the partials' term,
# and a ring result against the unsharded one within the sum of the two
# limits (the triangle inequality).
RING_TOL = ("bf16: O 2^-8*m + 2^-8*sum_b w_b|o_b| + 2^-7*|plain| + "
            "2^-7*median|plain|, dq 2^-8*m + 2^-8*sum_b|dq_b| + the same, "
            "dk and dv 2^-8*m + the same; f16: the same at 2^-11 and 2^-10, "
            "plus 2^-25 * S * max|v| (O), * scale * S * max|k| (dq), * scale "
            "* S * group * max|q| (dk), * S * group * max|do| (dv) for a P "
            "or dS below 2^-14 (f16 subnormals); f32: O 2e-5 + "
            "2e-5*|plain|, gradients 1e-4*|plain| + 1e-4*max|plain|; per "
            "element")
SP_HEADS, SP_KV_HEADS, SP_D = 32, 8, 128     # Llama-3-8B's attention
# (W, S, causal, dtype): B8 blocks at S/W = 1024, B9 at 512
SP_CASES = ((8, 8192, True, "bfloat16"), (8, 8192, True, "float16"),
            (8, 8192, True, "float32"),
            (8, 8192, False, "bfloat16"), (4, 2048, True, "bfloat16"),
            (4, 2048, True, "float32"))
SP_SERVE_LEN = 8192        # phase 10b: one max_seq_len sequence, sp = 8
SP_SERVE_W = 8
SP_TRAIN_MESH = (2, 4)     # phase 10d: dp x sp on phase 9's batch
SP_TRAIN_LOSS_REL = 2.0 ** -8


def sp_limit(plain, mag, part: str, ring: bool, dt=None):
    """Per-element limit of a result ``part`` ("o", "dq", "dk", "dv")
    against the plain ring (RING_TOL): ``mag`` from
    ``ring_rounding_magnitudes`` (bf16, f16: ``dt`` the ring's dtype,
    whose unit scales the terms; for f16 ``mag["sub"]`` the subnormal
    terms) or None (f32); ``ring`` adds the rounded partials' term, which
    the unsharded kernels do not have."""
    p = plain.float().abs()
    if mag is None:
        if part == "o":
            return F32_ATOL + F32_RTOL * p
        return FN_DENSE_REL * p + FN_DENSE_REL * float(p.max())
    rel, unit = HALF_UNITS[str(dt)]
    lim = unit * mag[part] + rel * (p + float(p.median()))
    if ring and part + "_parts" in mag:
        lim = lim + unit * mag[part + "_parts"]
    if "sub" in mag:
        lim = lim + mag["sub"][part]
    return lim


def rel_l2(a, b) -> float:
    import torch
    b = b.float()
    return float(torch.linalg.vector_norm(a.float() - b)
                 / torch.linalg.vector_norm(b))


def hold_sp(got, want, lim, what: str) -> tuple[float, float]:
    """(max abs error, largest error/limit) of ``got`` against ``want``
    under the per-element limit ``lim``; fails past it."""
    import torch
    need(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs "
         f"{tuple(want.shape)}")
    need(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    d = (got.float() - want.float()).abs()
    ratio = float((d / lim).max())
    need(ratio <= 1.0, f"{what}: max abs err {float(d.max())}, {ratio:.3g} "
         f"times its element's limit ({RING_TOL})")
    return float(d.max()), ratio


def host_ms(fn, n: int = 3) -> float:
    """Median host-clock ms of ``n`` calls, each ending synchronised."""
    import torch
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def sp_ring_case(g, W: int, S: int, causal: bool, dtype: str) -> dict:
    """Phase 10a, one case: the ring's kernel route (forward and the
    Function's backward) against the plain ring and against the unsharded
    kernels over the whole sequence, Ulysses against the unsharded B8;
    launch, round and byte counts; device and host times. Returns the
    case's numbers for the summary line."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch.ops import attention as A
    from accl_tpu_torch.parallel import (RankCollectives, make_group,
                                         ring_attention, ring_attention_fwd,
                                         ring_attention_ref,
                                         ring_rounding_magnitudes,
                                         ulysses_attention)
    from accl_tpu_torch.parallel.ring_attention import (from_rank_rows,
                                                        to_rank_rows)
    dt = getattr(torch, dtype)
    bf16 = str(dt) in HALF_UNITS         # the 16-bit tensor-core route
    B, H, Hkv, D = 1, SP_HEADS, SP_KV_HEADS, SP_D
    S_l, es = S // W, torch.finfo(dt).bits // 8
    what = (f"sp ring W={W} S={S} {'causal' if causal else 'full'} "
            f"{dtype}")
    q, do = (torch.randn(B, H, S, D, device="cuda", generator=g).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, Hkv, S, D, device="cuda", generator=g).to(dt)
            for _ in range(2))
    rows = [to_rank_rows(t, W).contiguous() for t in (q, k, v)]
    dor = to_rank_rows(do, W).contiguous()
    coll = RankCollectives(make_group(W))
    blocks = W * (W + 1) // 2 if causal else W * W
    fwd_key = ("attn_fwd_single" if A.is_single_block(S_l) else "attn_fwd")
    kv_bytes = (W - 1) * 2 * B * Hkv * S_l * D * es    # a rank, a call

    # the kernel route: forward, then the Function's backward
    c0 = attention_counters()
    o, lse = ring_attention_fwd(*rows, coll, causal)
    c1 = attention_counters()
    fwd_rounds, fwd_bytes = coll.exchange_rounds, coll.wire_bytes
    moved = {key: c1[key] - c0[key] for key in c1 if c1[key] != c0[key]}
    need(moved.pop(fwd_key, 0) == blocks and set(moved) <= {
        fwd_key + "_wgmma"}, f"{what}: forward launches "
         f"{ {key: c1[key] - c0[key] for key in c1} }, want {blocks} of "
         f"{fwd_key} only")
    need(c1[fwd_key + "_wgmma"] - c0[fwd_key + "_wgmma"]
         == (blocks if bf16 else 0), f"{what}: tensor-core route launches")
    need(fwd_rounds == W - 1 and fwd_bytes == W * kv_bytes,
         f"{what}: forward exchange rounds {fwd_rounds} (want {W - 1}), "
         f"bytes {fwd_bytes} (want {W * kv_bytes})")
    need(bool(torch.isfinite(lse).all()), f"{what}: a merged LSE row is "
         f"not finite")
    leaves = [t.clone().requires_grad_() for t in rows]
    out = ring_attention(*leaves, coll, causal)
    same_fwd = torch.equal(out.detach(), o)
    c2 = attention_counters()
    grads = torch.autograd.grad(out, leaves, dor)
    c3 = attention_counters()
    bwd_rounds = coll.exchange_rounds - 2 * fwd_rounds
    bwd_bytes = coll.wire_bytes - 2 * fwd_bytes
    for key in ("attn_bwd_dkv", "attn_bwd_dq"):
        need(c3[key] - c2[key] == blocks, f"{what}: {key} launched "
             f"{c3[key] - c2[key]} times, want {blocks}")
    need(bwd_rounds == W - 1, f"{what}: backward exchange rounds "
         f"{bwd_rounds}, want {W - 1}")
    del out, leaves

    # the unsharded kernels over the whole sequence
    whole_o, _whole_lse = A.flash_attention_fwd(q, k, v, causal)
    wl = [t.clone().requires_grad_() for t in (q, k, v)]
    whole_g = torch.autograd.grad(A.flash_attention(*wl, causal=causal), wl,
                                  do)
    del wl
    # Ulysses: B8 over the whole sequence, H/W heads a rank
    u0, c4 = coll.wire_bytes, attention_counters()
    ul = [t.clone().requires_grad_() for t in rows]
    uo = ulysses_attention(*ul, coll, causal)
    u_total = coll.wire_bytes - u0
    u_bytes = u_total // W
    c5 = attention_counters()
    whole_key = ("attn_fwd_single" if A.is_single_block(S)
                 else "attn_fwd")
    need(c5[whole_key] - c4[whole_key] == 1, f"{what}: Ulysses launched "
         f"{whole_key} {c5[whole_key] - c4[whole_key]} times, want once")
    need(u_total == (W - 1) * 2 * B * (H + Hkv) * S_l * D * es,
         f"{what}: Ulysses alltoall bytes {u_total} over {W} ranks")
    ug = torch.autograd.grad(uo, ul, dor)
    del ul
    # the plain ring on f32 copies; the limits' magnitudes
    pl = [t.to(torch.float32, copy=True).requires_grad_() for t in rows]
    plain_o = ring_attention_ref(*pl, causal=causal)
    plain_g = torch.autograd.grad(plain_o, pl, dor.float())
    plain_o = plain_o.detach()
    del pl
    torch.cuda.empty_cache()
    mag = (ring_rounding_magnitudes(*rows, lse, dor, o, causal) if bf16
           else None)
    if dt == torch.float16:     # P and dS below 2^-14: f16 subnormals
        step, sc, grp = SUBNORMAL_STEP * S, D ** -0.5, H // Hkv
        mag["sub"] = {"o": step * float(v.abs().max()),
                      "dq": step * sc * float(k.abs().max()),
                      "dk": step * sc * grp * float(q.abs().max()),
                      "dv": step * grp * float(do.abs().max())}
    held = {}
    ring_res = dict(zip(("o", "dq", "dk", "dv"), (o,) + tuple(grads)))
    whole_res = dict(zip(("o", "dq", "dk", "dv"), (whole_o,) + whole_g))
    uly_res = dict(zip(("o", "dq", "dk", "dv"), (uo.detach(),) + ug))
    plain_res = dict(zip(("o", "dq", "dk", "dv"), (plain_o,) + plain_g))
    uly_bitwise = {}
    for part in ("o", "dq", "dk", "dv"):
        plain = plain_res[part]
        lr = sp_limit(plain, mag, part, True, dt)
        lw = sp_limit(plain, mag, part, False, dt)
        ring, whole = ring_res[part], to_rank_rows(whole_res[part], W)
        held[part] = (
            hold_sp(ring, plain, lr, f"{what} {part} ring vs plain ring"),
            hold_sp(whole, plain, lw, f"{what} {part} unsharded vs plain "
                    f"ring"),
            hold_sp(ring, whole, lr + lw, f"{what} {part} ring vs "
                    f"unsharded"),
            rel_l2(ring, plain), rel_l2(ring, whole))
        uly = uly_res[part]
        uly_bitwise[part] = torch.equal(uly, whole)
        if not uly_bitwise[part]:
            e = float((uly.float() - whole.float()).abs().max())
            r = hold_sp(uly, plain, lw, f"{what} {part} Ulysses vs plain "
                        f"ring")
            print(f"{what}: Ulysses {part} differs from the unsharded "
                  f"kernel's (max abs diff {e}); within the unsharded "
                  f"kernel's limit against the plain ring ({r[1]:.3f})")
    del grads, whole_g, ug, plain_g, plain_res, whole_res, uly_res, mag
    del uo, plain_o
    torch.cuda.empty_cache()

    # times: the kernel route behind a GPU sleep and on the host clock.
    # A ring call enqueues 100-250 launches and merge ops, 5-14 ms of
    # host work, so its reps wait behind CALL_HEAD_START_CYCLES (~200
    # ms) and are fewer: behind HEAD_START_CYCLES the host would fall
    # behind the device after a few reps and the events time the host.
    reps = 10 if bf16 else 5
    ring = dict(reps=reps, head_start=CALL_HEAD_START_CYCLES)
    fwd_ms = time_ms(lambda: ring_attention_fwd(*rows, coll, causal),
                     **ring)
    fwd_host = host_ms(lambda: ring_attention_fwd(*rows, coll, causal))
    leaves = [t.clone().requires_grad_() for t in rows]
    out = ring_attention(*leaves, coll, causal)
    bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, leaves, dor, retain_graph=True), **ring)
    bwd_host = host_ms(lambda: torch.autograd.grad(
        out, leaves, dor, retain_graph=True))
    # where the time goes: one more forward and backward under the
    # profiler, device time per kernel family
    fams = {"forward": device_ms_by_family(
        lambda: ring_attention_fwd(*rows, coll, causal)),
        "backward": device_ms_by_family(lambda: torch.autograd.grad(
            out, leaves, dor, retain_graph=True))}
    del out, leaves
    uly_ms = time_ms(lambda: ulysses_attention(*rows, coll, causal),
                     **ring)
    _o, wlse, wdelta = bwd_operands(q, k, v, do, causal)
    args = (q, do, k, v, wlse, wdelta, causal, D ** -0.5)
    b8_ms = time_ms(lambda: A.flash_attention_fwd(q, k, v, causal),
                    reps=2 * reps)
    b10_ms = time_ms(lambda: A.flash_attention_bwd_dkv(*args),
                     reps=2 * reps)
    b11_ms = time_ms(lambda: A.flash_attention_bwd_dq(*args), reps=2 * reps)
    if not bf16:
        k_err, k_ratio = hold_bwd_by_kv_head(args, f"{what} unsharded")
        print(f"{what}: unsharded attn_bwd_dkv and attn_bwd_dq (f32 route, "
              f"3xTF32) against their plain versions: max abs err {k_err}, "
              f"largest error/limit {k_ratio:.3f} ({BWD_TOL})")
    del _o, wlse, wdelta, args
    sdpa = ""
    if bf16:
        lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                            enable_gqa=True)
        sdpa_f = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
        sdpa_b = time_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True))
        sdpa = f"; SDPA forward {sdpa_f:.4f} ms, backward {sdpa_b:.4f} ms"
        del lq, lk, lv, lo
    seen = S * (S + 1) // 2 if causal else S * S
    # f32: the kernels' three TF32 products a product (3xTF32)
    bms, by = bound_ms((2 * B * H * S * D + 2 * B * Hkv * S * D) * es
                       + 4 * B * H * S, (1 if bf16 else 3) * 4 * D * B * H
                       * seen, BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S)
    print(f"{what}: {blocks} {fwd_key} launches ({fwd_key} tensor cores "
          f"{c1[fwd_key + '_wgmma'] - c0[fwd_key + '_wgmma']}), backward "
          f"attn_bwd_dkv {blocks}, attn_bwd_dq {blocks}; exchange rounds "
          f"{fwd_rounds} forward + {bwd_rounds} backward; logical bytes a "
          f"rank a call: K/V {fwd_bytes // W:,} forward (un-repeated, "
          f"{Hkv} heads), {bwd_bytes // W:,} backward (K, V and their f32 "
          f"dK, dV accumulators); the Function's forward bitwise the "
          f"forward's: {same_fwd}")
    print(f"{what}: forward {fwd_ms:.4f} ms device ({fwd_host:.3f} ms host, "
          f"ending in a synchronise), backward {bwd_ms:.4f} ms device "
          f"({bwd_host:.3f} ms host); unsharded attn_fwd {b8_ms:.4f} "
          f"ms (ring {fwd_ms / b8_ms:.2f}x), attn_bwd_dkv "
          f"{b10_ms:.4f} ms + attn_bwd_dq {b11_ms:.4f} ms (ring backward "
          f"{bwd_ms / (b10_ms + b11_ms):.2f}x); forward bound {bms:.4f} ms "
          f"by {by}{'' if bf16 else ' at 3 x ops / 495 TFLOP/s'} "
          f"({bms / fwd_ms:.1%} of it){sdpa}; Ulysses forward "
          f"{uly_ms:.4f} ms, alltoall bytes a rank a call {u_bytes:,} "
          f"(the (W - 1)/W of q, k, v and O that leave the rank; the own "
          f"chunk not counted)")
    print(f"{what}: kernels by family (torch.profiler, one call): "
          + "; ".join(f"{half} " + (", ".join(
              f"{f} {ms:.3f} ms" for f, ms in sorted(
                  fam.items(), key=lambda x: -x[1]))
              if fam else "not measured") for half, fam in fams.items()))
    for part, (rp, wp, rw, l2p, l2w) in held.items():
        print(f"{what} {part}: ring vs plain ring max abs err {rp[0]:.4g} "
              f"(error/limit {rp[1]:.3f}, relative L2 {l2p:.3g}); "
              f"unsharded vs plain ring {wp[0]:.4g} ({wp[1]:.3f}); ring vs "
              f"unsharded {rw[0]:.4g} ({rw[1]:.3f}, relative L2 {l2w:.3g}); "
              f"Ulysses bitwise the unsharded kernel's: {uly_bitwise[part]}")
    del q, k, v, do, rows, dor, o, lse
    torch.cuda.empty_cache()
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "uly_ms": uly_ms,
            "b8_ms": b8_ms, "u_bytes": u_bytes, "kv_bytes": fwd_bytes // W}


def sp_attention_phase():
    """Phase 10a: every SP_CASES case at Llama-3-8B's attention width."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for W, S, causal, dtype in SP_CASES:
        sp_ring_case(g, W, S, causal, dtype)
        gc.collect()
        torch.cuda.empty_cache()


def sp_forward_phase(model) -> tuple[dict, int]:
    """Phase 10b, on phase 7's model (Llama-3-8B, bf16, 32 layers): one
    SP_SERVE_LEN-token sequence through ``forward`` with ``mesh`` of
    SP_SERVE_W ranks on the sp axis, against the unsharded ``forward`` of
    the same tokens; tokens/s of both, busy share and kernels by family,
    peak memory. Returns the path's launch counts and the peak allocated
    before the phase (the serving phase's own)."""
    import torch
    from accl_tpu_torch.ops import attention as A
    from accl_tpu_torch.parallel import make_mesh
    phase("phase 10b: sequence-parallel Llama forward")
    cfg = model.config
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    tokens = torch.randint(0, cfg.vocab_size, (1, SP_SERVE_LEN),
                           device="cuda", generator=g)
    mesh = make_mesh((SP_SERVE_W,), ("sp",))
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    blocks = SP_SERVE_W * (SP_SERVE_W + 1) // 2
    with torch.no_grad():
        zero_attention_counters()
        sp = model(tokens, sp="sp", mesh=mesh)
        torch.cuda.synchronize()
        launches = attention_counters()
        full = model(tokens)
        need(sp.shape == full.shape == (1, SP_SERVE_LEN, cfg.vocab_size)
             and bool(torch.isfinite(sp).all()),
             f"sp forward: shape {tuple(sp.shape)} or non-finite logits")
        rel = rel_l2(sp, full)
        agree = float((sp.argmax(-1) == full.argmax(-1)).float().mean())
        del sp, full
        print(f"sp forward launches: {launches}")
        key = ("attn_fwd_single" if A.is_single_block(
            SP_SERVE_LEN // SP_SERVE_W) else "attn_fwd")
        need(launches[key] == blocks * cfg.n_layers and sum(
            launches[k] for k in ("attn_fwd", "attn_fwd_single",
                                  "attn_decode", "attn_prefill"))
             == launches[key], f"sp forward: {key} launched "
             f"{launches[key]} times, want {blocks} a layer "
             f"({blocks * cfg.n_layers}) and no other attention kernel")
        need_routes(launches, True, "sp forward")
        print(f"sp forward, Llama-3-8B bf16 32 layers, 1x{SP_SERVE_LEN} "
              f"tokens, sp = {SP_SERVE_W} (ring attention, {blocks} {key} "
              f"launches a layer) vs the unsharded forward: relative L2 "
              f"{rel:.4g} (limit {SERVE_DENSE_REL}), greedy agreement "
              f"{agree:.4f}")
        need(rel <= SERVE_DENSE_REL, "sp forward: sp and unsharded logits "
             "differ")
        times = {}
        for what, fn in (("sp", lambda: model(tokens, sp="sp", mesh=mesh)),
                         ("unsharded", lambda: model(tokens))):
            times[what] = host_ms(fn)
            fams = device_ms_by_family(fn)
            busy = sum(fams.values())
            print(f"sp forward {what}: {times[what]:.2f} ms host clock "
                  f"(median of 3), {SP_SERVE_LEN / times[what] * 1e3:.0f} "
                  f"tokens/s; " + (
                      f"{busy:.2f} ms of kernels, busy share "
                      f"{busy / times[what]:.3f}; " + ", ".join(
                          f"{f} {ms:.2f} ms" for f, ms in sorted(
                              fams.items(), key=lambda x: -x[1]))
                      if fams else "busy share not measured (the profiler "
                      "saw no device activity)"))
        print(f"sp forward: {times['sp'] / times['unsharded']:.3f}x the "
              f"unsharded forward's host time")
    del tokens
    print(f"sp forward peak memory: "
          f"{(torch.cuda.max_memory_allocated() - held) / 2 ** 30:.2f} GiB "
          f"above the {held / 2 ** 30:.2f} GiB held before it")
    return launches, peak_before


def sp_training_phase(model, tokens, phase9: dict) -> dict:
    """Phase 10d, after phase 9's steps: the same model re-initialised in
    place from phase 9's seed, a fresh Adam(lr=1e-4), the same batch,
    ``make_train_step`` over a dp x sp mesh (SP_TRAIN_MESH): 4 steps.
    Returns the path's launch counts."""
    import torch
    from accl_tpu_torch.parallel import make_mesh
    phase("phase 10d: sequence-parallel training")
    cfg = model.config
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    model.init(torch.Generator(device="cuda").manual_seed(SEED + 11))
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    mesh = make_mesh(SP_TRAIN_MESH, ("dp", "sp"))
    step = model.make_train_step(opt, dp="dp", sp="sp", mesh=mesh)
    W = mesh.shape["sp"]
    blocks = W * (W + 1) // 2
    torch.cuda.reset_peak_memory_stats()
    zero_attention_counters()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(tokens)))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = attention_counters()
    peak = torch.cuda.max_memory_allocated()
    print(f"sp training losses {losses}; step ms (host clock) {times}")
    print(f"sp training launches: {launches}")
    need(all(np.isfinite(x) for x in losses), "sp training: non-finite loss")
    need(losses[-1] < losses[0], "sp training: the loss did not fall")
    first_rel = abs(losses[0] - phase9["loss"]) / abs(phase9["loss"])
    print(f"sp training first loss {losses[0]:.7f} vs phase 9's "
          f"{phase9['loss']:.7f}: relative {first_rel:.3g} (limit "
          f"{SP_TRAIN_LOSS_REL})")
    need(first_rel <= SP_TRAIN_LOSS_REL, "sp training: the first loss "
         "departs from phase 9's")
    per_run = blocks * cfg.n_layers * TRAIN_STEPS
    for key in ("attn_fwd_single", "attn_bwd_dkv", "attn_bwd_dq"):
        need(launches[key] == per_run, f"sp training: {key} launched "
             f"{launches[key]} times, not {blocks} a layer a step "
             f"({per_run})")
    need(launches["attn_fwd"] == 0, "sp training: B8 launched")
    need_routes(launches, True, "sp training")
    step_ms = statistics.median(times[1:])
    tokens_n = tokens.numel()
    flops = phase9["flops"]
    fams = device_ms_by_family(lambda: step(tokens))
    busy = sum(fams.values())
    print(f"sp training step (dp {SP_TRAIN_MESH[0]} x sp {W}, B9 {blocks} "
          f"a layer): {step_ms:.2f} ms (phase 9: {phase9['step_ms']:.2f}; "
          f"host clock, median of steps 2-{TRAIN_STEPS}), "
          f"{tokens_n / step_ms * 1e3:.0f} tokens/s (phase 9: "
          f"{tokens_n / phase9['step_ms'] * 1e3:.0f}), "
          f"{flops / (step_ms / 1e3) / 1e12:.1f} model TFLOP/s (phase 9: "
          f"{flops / (phase9['step_ms'] / 1e3) / 1e12:.1f}); peak memory "
          f"{peak / 2 ** 30:.2f} GiB (phase 9: "
          f"{phase9['peak'] / 2 ** 30:.2f})")
    print("sp training step under the profiler: " + (
        f"{busy:.2f} ms of kernels, busy share {busy / step_ms:.3f} "
        f"(phase 9: {phase9['busy']}); " + ", ".join(
            f"{f} {ms:.2f} ms" for f, ms in sorted(fams.items(),
                                                   key=lambda x: -x[1]))
        if fams else "busy share not measured (the profiler saw no device "
        "activity)"))
    need(peak <= TRAIN_MAX_PEAK, "sp training: peak memory past the limit")
    del opt, step
    return launches


# -- phase 11: tensor parallelism (the Megatron-sharded Llama) ---------------

TP_MESH = (2, 4)           # phases 11a and 11c: dp x tp
TP_GRAD_SIZES = (4, 2)     # phase 11b: tp axis sizes (both GQA at 32/8 heads)
TP_TRAIN_LOSS_REL = 2.0 ** -8


def tp_counts() -> dict:
    """The attention launch counters and the tp all-reduces run."""
    from accl_tpu_torch.parallel import tensor_parallel as TP
    return {**attention_counters(), "tp_allreduce": TP.allreduce_calls}


def zero_tp_counts():
    from accl_tpu_torch.parallel import tensor_parallel as TP
    zero_attention_counters()
    TP.allreduce_calls = 0


def need_tp_launches(got: dict, want: dict, what: str):
    """Each counter of ``want`` at its value and every other attention
    kernel not launched."""
    for key in ("attn_fwd", "attn_fwd_single", "attn_decode",
                "attn_prefill", "attn_bwd_dkv", "attn_bwd_dq",
                "tp_allreduce"):
        need(got[key] == want.get(key, 0), f"{what}: {key} ran {got[key]} "
             f"times, want {want.get(key, 0)}")


def tp_serving_phase(model, prompts, out, phase7: dict):
    """Phase 11a, on phase 7's model (Llama-3-8B, bf16, 32 layers) and
    prompts: ``forward``, ``generate`` and ``forward_cached`` with a dp x
    tp mesh (TP_MESH) against the unsharded path; launches, the cache
    left in place, times beside phase 7's, busy share, kernels by family,
    peak memory."""
    import torch
    from accl_tpu_torch.parallel import RankCollectives, make_mesh
    from accl_tpu_torch.parallel import tensor_parallel as TP
    phase("phase 11a: tensor-parallel Llama serving")
    cfg = model.config
    L = cfg.n_layers
    B, S = prompts.shape
    NEW = out.shape[1]
    mesh = make_mesh(TP_MESH, ("dp", "tp"), prompts.device)
    T = mesh.shape["tp"]
    tp_kw = dict(mesh=mesh, dp="dp")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), attention_calls(L) as calls:
        zero_tp_counts()
        tp_logits = model(prompts, **tp_kw)
        torch.cuda.synchronize()
        fwd = tp_counts()
        need_tp_launches(fwd, {"attn_fwd": L, "tp_allreduce": 2 * L + 1},
                         "tp forward")
        need_routes(fwd, True, "tp forward")
        full = model(prompts)
        need(tp_logits.shape == full.shape == (B, S, cfg.vocab_size)
             and bool(torch.isfinite(tp_logits).all()),
             f"tp forward: shape {tuple(tp_logits.shape)} or non-finite "
             f"logits")
        rel = rel_l2(tp_logits, full)
        agree = float((tp_logits.argmax(-1) == full.argmax(-1)).float()
                      .mean())
        del tp_logits, full
        print(f"tp forward, Llama-3-8B bf16 {L} layers, {B}x{S} tokens, dp "
              f"{TP_MESH[0]} x tp {T} (B8 once a layer over {T * B} rank "
              f"rows of {cfg.n_heads // T}/{cfg.n_kv_heads // T} heads, "
              f"{2 * L + 1} tp all-reduces) vs the unsharded forward: "
              f"relative L2 {rel:.4g} (limit {SERVE_DENSE_REL}), greedy "
              f"agreement {agree:.4f}")
        need(rel <= SERVE_DENSE_REL, "tp forward: tp and unsharded logits "
             "differ")
        zero_tp_counts()
        tp_out = model.generate(prompts, max_new=NEW, **tp_kw)
        torch.cuda.synchronize()
        gen = tp_counts()
        need_tp_launches(gen, {"attn_prefill": L,
                               "attn_decode": L * (NEW - 1),
                               "tp_allreduce": (2 * L + 1) * NEW},
                         "tp generate")
        need_routes(gen, True, "tp generate")
        need(tp_out.shape == (B, NEW) and bool(
            ((tp_out >= 0) & (tp_out < cfg.vocab_size)).all()),
             f"tp generate: shape {tuple(tp_out.shape)} or a token outside "
             f"the vocabulary")
        same = (tp_out == out).float()
        lead = int(same.cumprod(1).sum(1).min())
        print(f"tp generate (max_new={NEW}) vs the unsharded generate: "
              f"token agreement {float(same.mean()):.4f}, every sequence "
              f"equal through its first {lead} tokens")
        hold_path_calls(calls, "tp serving")
        del calls
    launches = {k: fwd[k] + gen[k] for k in fwd}
    print(f"tp serving launches (forward, generate): {launches}")

    def prefill():
        c = model.init_kv_cache(B, S + NEW, mesh=mesh)
        return model.forward_cached(prompts, c, **tp_kw)

    def decode_steps(state, n):
        logits, c = state
        ts = []
        for _ in range(n):
            t1 = time.perf_counter()
            tok = logits[:, -1].argmax(-1)
            logits, c = model.forward_cached(tok[:, None], c, **tp_kw)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t1) * 1e3)
        return ts

    with torch.no_grad():
        # the cache stays where init_kv_cache put it: the same tensors,
        # the same storage, no gathered copy, through a prefill and 16
        # steps
        state = prefill()
        cache = state[1]
        # one decode step from the same token, tp against unsharded
        plain_cache = model.init_kv_cache(B, S + NEW)
        plain_pre, _ = model.forward_cached(prompts, plain_cache)
        tok = plain_pre[:, -1].argmax(-1)[:, None]
        plain_step, _ = model.forward_cached(tok, plain_cache)
        tp_step, _ = model.forward_cached(tok, cache, **tp_kw)
        for what, a, b in (("prefill", state[0], plain_pre),
                           (f"decode step at {S}", tp_step, plain_step)):
            rel = rel_l2(a, b)
            print(f"tp {what} (forward_cached) vs unsharded: relative L2 "
                  f"{rel:.4g} (limit {SERVE_DENSE_REL}), greedy agreement "
                  f"{float((a.argmax(-1) == b.argmax(-1)).float().mean()):.4f}")
            need(rel <= SERVE_DENSE_REL, f"tp {what}: tp and unsharded "
                 f"logits differ")
        del plain_cache, plain_pre, plain_step, tp_step
        state = (state[0], cache)
        ptrs = (cache["k"].data_ptr(), cache["v"].data_ptr())
        k_obj = cache["k"]
        before = torch.cuda.memory_allocated()
        dec_ms = statistics.median(decode_steps(state, 16))
        need(cache["k"] is k_obj and (cache["k"].data_ptr(),
                                      cache["v"].data_ptr()) == ptrs
             and cache["k"].shape == (L, T, B, S + NEW, cfg.n_kv_heads // T,
                                      cfg.head_dim),
             "tp decode: the cache moved or changed its layout")
        print(f"tp decode cache: k and v {tuple(cache['k'].shape)} "
              f"{cache['k'].dtype}, data_ptr unchanged through the prefill "
              f"and 17 steps (no gather); {(torch.cuda.memory_allocated() - before) / 2 ** 20:.1f} MiB "
              f"more allocated after the steps")
        del state, cache, k_obj
        fwd_ms = host_ms(lambda: model(prompts, **tp_kw))
        pre_ms = host_ms(prefill)
        print(f"tp forward: {fwd_ms:.2f} ms for {B}x{S} tokens "
              f"({B * S / fwd_ms * 1e3:.0f} tokens/s; phase 7: "
              f"{phase7['fwd_ms']:.2f} ms, {B * S / phase7['fwd_ms'] * 1e3:.0f}"
              f" tokens/s; {fwd_ms / phase7['fwd_ms']:.3f}x; host clock, "
              f"median of 3)")
        print(f"tp prefill: {pre_ms:.2f} ms ({B * S / pre_ms * 1e3:.0f} "
              f"tokens/s; phase 7: {phase7['pre_ms']:.2f} ms, "
              f"{B * S / phase7['pre_ms'] * 1e3:.0f} tokens/s)")
        print(f"tp decode: {dec_ms:.3f} ms per step of {B} tokens (phase 7: "
              f"{phase7['dec_ms']:.3f}; median of 16 steps at positions "
              f"{S + 1}..{S + 16})")
        # the tp all-reduce alone at the path's shape (T rows of the
        # prefill's activation, bf16), and the host time of the shard
        # views a forward builds
        coll = RankCollectives(mesh.group("tp"))
        rows = torch.randn(T, B, S, cfg.dim, device=prompts.device,
                           dtype=cfg.dtype)
        ar_ms = time_ms(lambda: TP.tp_allreduce(rows, coll))
        views_ms = host_ms(lambda: model.shard_params(mesh))
        print(f"tp all-reduce of {T} x {B}x{S}x{cfg.dim} bf16 rows: "
              f"{ar_ms:.4f} ms device time (behind a GPU sleep, median of "
              f"20), {(2 * L + 1) * ar_ms:.2f} ms for a forward's "
              f"{2 * L + 1}; shard_params (the views a forward builds): "
              f"{views_ms:.3f} ms host clock")
        state = prefill()
        for what, fn, window in (
                ("forward", lambda: model(prompts, **tp_kw), fwd_ms),
                ("prefill", prefill, pre_ms),
                ("decode x8", lambda: decode_steps(state, 8), 8 * dec_ms)):
            fams = device_ms_by_family(fn)
            if not fams:
                print(f"tp {what}: busy share not measured (the profiler "
                      f"saw no device activity)")
                continue
            busy = sum(fams.values())
            print(f"tp {what}: {busy:.2f} ms of kernels in a {window:.2f} "
                  f"ms host-clock window, busy share {busy / window:.3f}; "
                  + ", ".join(f"{f} {ms:.2f} ms" for f, ms in sorted(
                      fams.items(), key=lambda x: -x[1])))
        del state
    print(f"tp serving peak memory: "
          f"{(torch.cuda.max_memory_allocated() - held) / 2 ** 30:.2f} GiB "
          f"above the {held / 2 ** 30:.2f} GiB held before it")
    with torch.no_grad():
        # one column GEMM on the strided wq shards: a copy of the shards
        # inside bmm would allocate their bytes beyond the output's, and
        # the strided call would trail the same call on contiguous shards
        wq = model.shard_params(mesh)["layers.0.wq"]
        wq_c = wq.contiguous()
        TP.rank_matmul(rows, wq)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = TP.rank_matmul(rows, wq)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before - y.nbytes
        del y
        strided_ms = time_ms(lambda: TP.rank_matmul(rows, wq))
        contig_ms = time_ms(lambda: TP.rank_matmul(rows, wq_c))
        print(f"tp column GEMM on the wq shards {tuple(wq.shape)} strides "
              f"{wq.stride()}: {extra} bytes allocated beyond its output "
              f"(a copy of the shards: {wq_c.nbytes}); {strided_ms:.4f} ms, "
              f"on contiguous shards {contig_ms:.4f} ms (device, median of "
              f"20)")
        need(extra < wq_c.nbytes, "tp: bmm copied the strided weight shards")
        del rows, wq, wq_c
    return launches


def tp_training_phase(model, tokens, phase9: dict) -> dict:
    """Phase 11c, after phase 10d: the same model re-initialised in place
    from phase 9's seed, a fresh Adam(lr=1e-4), the same batch,
    ``make_train_step`` over a dp x tp mesh (TP_MESH): 4 steps. Returns
    the path's launch counts."""
    import torch
    from accl_tpu_torch.parallel import make_mesh
    phase("phase 11c: tensor-parallel training")
    cfg = model.config
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    model.init(torch.Generator(device=tokens.device).manual_seed(SEED + 11))
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    mesh = make_mesh(TP_MESH, ("dp", "tp"), tokens.device)
    step = model.make_train_step(opt, dp="dp", mesh=mesh)
    T = mesh.shape["tp"]
    torch.cuda.reset_peak_memory_stats()
    zero_tp_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(tokens)))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = tp_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"tp training losses {losses}; step ms (host clock) {times}")
    print(f"tp training launches: {launches}")
    need(all(np.isfinite(x) for x in losses), "tp training: non-finite loss")
    need(losses[-1] < losses[0], "tp training: the loss did not fall")
    first_rel = abs(losses[0] - phase9["loss"]) / abs(phase9["loss"])
    print(f"tp training first loss {losses[0]:.7f} vs phase 9's "
          f"{phase9['loss']:.7f}: relative {first_rel:.3g} (limit "
          f"{TP_TRAIN_LOSS_REL})")
    need(first_rel <= TP_TRAIN_LOSS_REL, "tp training: the first loss "
         "departs from phase 9's")
    per_run = cfg.n_layers * TRAIN_STEPS
    # forward and backward: 2 all-reduces a layer and 1 for the embedding
    need_tp_launches(launches, {
        "attn_fwd": per_run, "attn_bwd_dkv": per_run, "attn_bwd_dq": per_run,
        "tp_allreduce": 2 * (2 * cfg.n_layers + 1) * TRAIN_STEPS},
        "tp training")
    need_routes(launches, True, "tp training")
    step_ms = statistics.median(times[1:])
    tokens_n = tokens.numel()
    flops = phase9["flops"]
    fams = device_ms_by_family(lambda: step(tokens))
    busy = sum(fams.values())
    print(f"tp training step (dp {TP_MESH[0]} x tp {T}, B8, B10, B11 once a "
          f"layer over {T * tokens.shape[0]} rank rows): {step_ms:.2f} ms "
          f"(phase 9: {phase9['step_ms']:.2f}; {step_ms / phase9['step_ms']:.3f}x;"
          f" host clock, median of steps 2-{TRAIN_STEPS}), "
          f"{tokens_n / step_ms * 1e3:.0f} tokens/s (phase 9: "
          f"{tokens_n / phase9['step_ms'] * 1e3:.0f}), "
          f"{flops / (step_ms / 1e3) / 1e12:.1f} model TFLOP/s = "
          f"{flops / (step_ms / 1e3) / BF16_OPS_PER_S:.1%} of 989 (phase 9: "
          f"{flops / (phase9['step_ms'] / 1e3) / 1e12:.1f}); peak memory "
          f"{peak / 2 ** 30:.2f} GiB (phase 9: {phase9['peak'] / 2 ** 30:.2f})")
    print("tp training step under the profiler: " + (
        f"{busy:.2f} ms of kernels, busy share {busy / step_ms:.3f} "
        f"(phase 9: {phase9['busy']}); " + ", ".join(
            f"{f} {ms:.2f} ms" for f, ms in sorted(fams.items(),
                                                   key=lambda x: -x[1]))
        if fams else "busy share not measured (the profiler saw no device "
        "activity)"))
    need(peak <= TRAIN_MAX_PEAK, "tp training: peak memory past the limit")
    del opt, step
    return launches


# -- phase 12: the call contract, membership and the uneven exchanges ---------

# the skewed routing of 12a and 12b: rank r sends a share p_j of its
# elements (or tokens) to peer j, p = roll(HOT_P, r); the remainder of
# the floors goes to the hot peer
HOT_P = (0.40, 0.20, 0.12, 0.09, 0.07, 0.06, 0.04, 0.02)
A2AV_COLLAPSE_N = 8 << 20  # 12a's routing collapse: elements a rank
MOE_T, MOE_D = 4096, 4096  # 12b: tokens a rank, Llama-3-8B's width
RING_S, RING_D = 8192, 128  # 12c: sequence over W ranks, head dim
KV_BLOCKS, KV_BLOCK = 224, 1 << 20   # 12d: 2 MiB bf16 blocks (phase 7b's)


def skew_counts(n: int) -> list:
    """Rank r's send vector of ``n`` elements: floor(p_j * n) to peer j
    with p = roll(HOT_P, r), the remainder to the hot peer."""
    out = []
    for r in range(W):
        p = np.roll(HOT_P, r)
        c = [int(np.floor(pj * n)) for pj in p]
        c[int(np.argmax(p))] += n - sum(c)
        out.append(c)
    return out


@contextlib.contextmanager
def plain_codecs(ctx):
    """Route a world's dataplane and its p2p codecs through the plain
    versions (``PLAIN``) for the duration: the yardstick run of the same
    schedule. The plain versions count no launches."""
    import accl_tpu_torch.device.cuda as cuda_mod
    from accl_tpu_torch.parallel.collectives import PLAIN
    saved = (ctx.coll.kernels, cuda_mod.bs_quant, cuda_mod.bs_dequant,
             cuda_mod.cast)
    ctx.coll.kernels = PLAIN
    cuda_mod.bs_quant, cuda_mod.bs_dequant = PLAIN.bs_quant, PLAIN.bs_dequant
    cuda_mod.cast = PLAIN.cast
    try:
        yield
    finally:
        (ctx.coll.kernels, cuda_mod.bs_quant, cuda_mod.bs_dequant,
         cuda_mod.cast) = saved


def timed_drive(accls, fn):
    """One call on every rank: (device ms behind a GPU sleep, the slowest
    rank's ms inside the library, the host ms of the drive)."""
    import torch
    from accl_tpu_torch.testing import run_ranks

    def one(a):
        t0 = time.perf_counter()
        fn(a)
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda._sleep(CALL_HEAD_START_CYCLES)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    t0 = time.perf_counter()
    lib = max(run_ranks(accls, one))
    host = (time.perf_counter() - t0) * 1e3
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), lib * 1e3, host


def a2av_phase(say, launched):
    """12a: alltoallv on ``cuda_world(8)``, device-resident, 64 Mi fp32
    sent a rank with the skewed counts, on the fp32, bf16 and fp8-e4m3
    block-128 wires, in place (staged), and a routing collapse (8 Mi a
    rank, all to rank 0); each landing bitwise the same schedule through
    the plain versions and within the wire's bound of the exact values."""
    import torch
    from accl_tpu_torch import cuda_world
    from accl_tpu_torch.parallel import collectives as P
    from accl_tpu_torch.testing import run_ranks
    accls = cuda_world(W)
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 12)
        xs = [torch.randn(N, device="cuda", generator=g) for _ in range(W)]
        sends = skew_counts(N)
        recvs = [[sends[i][j] for i in range(W)] for j in range(W)]
        col = [[0] * W for _ in range(W)]
        col_n = A2AV_COLLAPSE_N
        for r in range(W):
            col[r][0] = col_n
        col_r = [[col[i][j] for i in range(W)] for j in range(W)]
        bufs = {}

        def setup(a):
            r = a.rank
            bufs[r] = {
                "src": a.buffer(data=xs[r], device_resident=True),
                "dst": a.buffer((N,), torch.float32, device_resident=True),
                "inplace": a.buffer(data=xs[r].clone(),
                                    device_resident=True),
                "col": a.buffer((W * col_n if r == 0 else 1,),
                                torch.float32, device_resident=True)}
        run_ranks(accls, setup)

        def case(name):
            wire = {"fp32": None, "bf16": "bfloat16",
                    "fp8_block128": "float8_e4m3fn", "in_place": None,
                    "collapse_8Mi": None}[name]
            kw = {}
            if wire is not None:
                kw["compress_dtype"] = getattr(torch, wire)
            if name == "fp8_block128":
                kw["block_scale"] = QBLOCK

            def fn(a, refill=True):
                b, r = bufs[a.rank], a.rank
                if name == "in_place":
                    if refill:
                        b["inplace"].tensor.copy_(xs[r])
                    a.alltoallv(b["inplace"], b["inplace"], sends[r],
                                recvs[r])
                elif name == "collapse_8Mi":
                    a.alltoallv(b["src"], b["col"], col[r], col_r[r])
                else:
                    a.alltoallv(b["src"], b["dst"], sends[r], recvs[r],
                                **kw)
            return fn, wire

        names = ("fp32", "bf16", "fp8_block128", "in_place", "collapse_8Mi")
        exact = [torch.empty(N, device="cuda") for _ in range(W)]
        P.alltoallv(xs, exact, sends, recvs, P.PLAIN)   # copies only
        for name in names:
            fn, wire = case(name)
            cnt = counters()
            before = {k: f.launches for k, f in cnt.items()}
            run_ranks(accls, fn)
            torch.cuda.synchronize()
            per = {k: f.launches - before[k] for k, f in cnt.items()
                   if f.launches - before[k]}
            for k, v in per.items():
                launched[k] = launched.get(k, 0) + v
            # the same schedule through the plain versions
            if name == "collapse_8Mi":
                got = [bufs[0]["col"].tensor]
                plain = [torch.empty(W * col_n, device="cuda")]
                P.alltoallv([x[:col_n] for x in xs],
                            plain + [torch.empty(0, device="cuda")] * (W - 1),
                            col, col_r, P.PLAIN)
                want = [torch.cat([x[:col_n] for x in xs])]
            else:
                key = "inplace" if name == "in_place" else "dst"
                got = [bufs[r][key].tensor for r in range(W)]
                plain = [torch.empty(N, device="cuda") for _ in range(W)]
                qb = QBLOCK if name == "fp8_block128" else 0
                P.alltoallv(xs, plain, sends, recvs, P.PLAIN, wire, qb)
                want = exact
            check_rows(got, plain, f"alltoallv {name} vs plain")
            del plain
            # against the exact values: chunk by chunk, the wire's bound
            worst, ratio = 0.0, 0.0
            for r, (gt, ex) in enumerate(zip(got, want)):
                err = (gt.double() - ex.double()).abs()
                worst = max(worst, float(err.max()))
                if wire is None:
                    need(worst == 0.0, f"alltoallv {name}: not exact")
                    continue
                off = 0
                for s in range(W):
                    c = recvs[r][s]
                    e, x = err[off:off + c], ex[off:off + c].double().abs()
                    if s == r:
                        need(float(e.max()) == 0.0,
                             f"alltoallv {name}: own chunk not exact")
                    elif c:
                        bound = (x * WIRE_U[wire] if wire == "bfloat16"
                                 else x.max() * BS_BOUND_PER_AMAX)
                        ratio = max(ratio, float((e / bound.clamp_min(
                            1e-30)).max()))
                    off += c
                del err
            need(ratio <= 1.0, f"alltoallv {name}: err/bound {ratio:.4f}")
            bound_txt = {None: "exact (0)",
                         "bfloat16": "2^-8 |x| per element",
                         "float8_e4m3fn": "amax(chunk) 2^-4 / (1 - 2^-4)"}
            # timed without re-filling the in-place buffer: the call alone
            dev, lib, host = timed_drive(accls, lambda a: fn(a, False))
            nbytes = (W * col_n if name == "collapse_8Mi" else N) * 4
            say(f"12a alltoallv {name}: {dev:.4f} ms of device work behind a "
                f"GPU sleep, library {lib:.3f} ms (slowest rank), host "
                f"{host:.3f} ms, idle share {1 - dev / lib:.3f} of the "
                f"library's time; {nbytes} logical bytes a rank (rank 0 "
                f"for the collapse); launches {per or 'none'}; bitwise the "
                f"plain versions, max abs err vs exact {worst:.6g} "
                f"(bound {bound_txt[wire]}"
                + (f", worst err/bound {ratio:.4f}" if wire else "") + ")")
        fp32_bound = bound_ms(2 * W * N * 4, 0)[0]
        say(f"12a bound: fp32 {fp32_bound:.4f} ms (each element read once "
            f"and written once over 8 ranks at {HBM_BYTES_PER_S / 1e12} "
            f"TB/s), fp8 block 128 {bound_ms(W * N * 10, 0)[0]:.4f} ms "
            f"(~10 B an element through B5 and B6)")
        del exact
    finally:
        for a in accls:
            a.deinit()


def moe_phase(say, launched):
    """12b: MoE dispatch and combine, W = 8, 4096 tokens of 4096 a rank,
    top-1 routing with the rotated hot expert, 2 chunks; fp32 and
    fp8-e4m3 block-128 dispatch, overlap on and off; the expert in f32
    (TF32 off). fp32 against ``moe_reference`` in float64 (rtol 1e-5,
    atol 1e-5); fp8 bitwise the plain codecs' run and within the bound
    the expert's Lipschitz constant gives against float64."""
    import torch
    from accl_tpu_torch import cuda_world
    from accl_tpu_torch.testing import run_ranks
    from accl_tpu_torch.workloads.moe import (default_expert,
                                              moe_dispatch_combine,
                                              moe_reference)
    need(not torch.backends.cuda.matmul.allow_tf32,
         "12b: TF32 matmuls are on")
    accls = cuda_world(W)
    try:
        rng = np.random.default_rng(SEED + 120)
        g = torch.Generator(device="cuda").manual_seed(SEED + 121)
        toks = [torch.randn(MOE_T, MOE_D, device="cuda", generator=g)
                for _ in range(W)]
        dest = [rng.choice(W, size=MOE_T, p=np.roll(HOT_P, r))
                for r in range(W)]
        experts = [default_expert(r, MOE_D, "cuda") for r in range(W)]
        ctx = accls[0].device.ctx

        def f64_expert(e):
            w64, b64 = e.weight.double(), e.bias.double()

            def f(x):
                return torch.tanh(x.double() @ w64 + b64)
            f.weight = w64
            return f
        f64 = [f64_expert(e) for e in experts]
        oracle = moe_reference(toks, dest, f64)
        fp8 = dict(compress_dtype=torch.float8_e4m3fn, block_scale=QBLOCK)

        def leg(overlap, kw, identity=False):
            def fn(a):
                t0 = time.perf_counter()
                out, stats = moe_dispatch_combine(
                    a, toks[a.rank], dest[a.rank], n_chunks=2,
                    expert_fn=(lambda x: x) if identity
                    else experts[a.rank], overlap=overlap, **kw)
                torch.cuda.synchronize()
                return out, stats, time.perf_counter() - t0
            return fn

        run_ranks(accls, leg(True, fp8))   # warm-up: cuBLAS, the allocator
        for wire, kw in (("fp32", {}), ("fp8_block128", fp8)):
            outs = {}
            for overlap in (True, False):
                cnt = counters()
                before = {k: f.launches for k, f in cnt.items()}
                res = run_ranks(accls, leg(overlap, kw))
                per = {k: f.launches - before[k] for k, f in cnt.items()
                       if f.launches - before[k]}
                for k, v in per.items():
                    launched[k] = launched.get(k, 0) + v
                outs[overlap] = [o for o, _, _ in res]
                of = [s["overlap_frac"] for _, s, _ in res]
                exp_ms = [s["exposed_s"] * 1e3 for _, s, _ in res]
                skew = max(max(s["recv_counts"]) * W / max(1, s["tokens"])
                           for _, s, _ in res)
                ms = max(t for _, _, t in res) * 1e3
                say(f"12b moe {wire} overlap {'on' if overlap else 'off'}: "
                    f"{ms:.2f} ms (slowest rank, host clock), overlap_frac "
                    f"{min(of):.4f}-{max(of):.4f}, exposed "
                    f"{statistics.median(exp_ms):.2f} ms (median rank), "
                    f"skew {skew:.3f} (largest peer share over the even "
                    f"one), launches {per or 'none'}")
            if wire == "fp32":
                worst = 0.0
                for overlap in (True, False):
                    for r in range(W):
                        err = (outs[overlap][r].double() - oracle[r]).abs()
                        lim = 1e-5 * oracle[r].abs() + 1e-5
                        need(bool((err <= lim).all()),
                             "12b fp32: outside rtol 1e-5, atol 1e-5")
                        worst = max(worst, float(err.max()))
                say(f"12b moe fp32 vs float64 moe_reference: max abs err "
                    f"{worst:.3g} (limit 1e-5 |ref| + 1e-5)")
                continue
            # what the dispatch landed, through an identity expert: the
            # kernels' run bitwise the plain codecs' (no GEMM between)
            landed = [o for o, _, _ in run_ranks(accls, leg(True, kw,
                                                            True))]
            with plain_codecs(ctx):
                plain = [o for o, _, _ in run_ranks(accls, leg(True, kw,
                                                               True))]
            check_rows(landed, plain, "12b fp8 dispatch vs plain")
            del landed, plain
            ratio = 0.0
            for r in range(W):
                x = toks[r].double()
                dx = 2.0 ** -4 * x.abs() + 2.0 ** -10 * x.abs().amax(
                    dim=1, keepdim=True) / 448.0
                bound = torch.empty_like(x)
                d = torch.as_tensor(dest[r], device="cuda")
                for p in range(W):
                    sel = d == p
                    bound[sel] = dx[sel] @ f64[p].weight.abs()
                bound += 1e-5
                for overlap in (True, False):
                    err = (outs[overlap][r].double() - oracle[r]).abs()
                    ratio = max(ratio, float((err / bound).max()))
            need(ratio <= 1.0, f"12b fp8: err/bound {ratio:.4f}")
            say(f"12b moe fp8 dispatch: the landed tokens bitwise the plain "
                f"codecs' run (identity expert); vs "
                f"float64 worst err/bound {ratio:.4f} (bound |dx| @ |W| + "
                f"1e-5, |dx| <= 2^-4 |x| + 2^-10 amax/448)")
        say(f"12b expert bound: 2 T d^2 = {2 * MOE_T * MOE_D ** 2 / 1e9:.1f} "
            f"GFLOP a rank a pass, "
            f"{bound_ms(0, W * 2 * MOE_T * MOE_D ** 2)[0]:.2f} ms for {W} "
            f"ranks at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s f32")
    finally:
        for a in accls:
            a.deinit()


def ring_workload_phase(say, launched):
    """12c: the ring-attention workload, W = 8, S = 8192 (1024 a rank),
    d = 128, ``chain=True``; the rotation on fp32 and on the fp8-e4m3
    block-128 wire, overlap on and off, against
    ``ring_attention_reference`` (fp32: rtol 1e-5, atol 1e-6; fp8:
    bitwise the plain codecs' run, relative L2 below 2^-3)."""
    import torch
    from accl_tpu_torch import cuda_world
    from accl_tpu_torch.testing import run_ranks
    from accl_tpu_torch.workloads.ring_attention import (
        ring_attention_forward, ring_attention_reference)
    accls = cuda_world(W)
    try:
        L = RING_S // W
        g = torch.Generator(device="cuda").manual_seed(SEED + 122)
        q, k, v = ([torch.randn(L, RING_D, device="cuda", generator=g)
                    for _ in range(W)] for _ in range(3))
        K, V = torch.cat(k), torch.cat(v)
        gold = [ring_attention_reference(q[r], K, V) for r in range(W)]
        ctx = accls[0].device.ctx
        fp8 = dict(compress_dtype=torch.float8_e4m3fn, block_scale=QBLOCK)

        def leg(overlap, kw):
            def fn(a):
                t0 = time.perf_counter()
                out, stats = ring_attention_forward(
                    a, q[a.rank], k[a.rank], v[a.rank], overlap=overlap,
                    use_chain=True, **kw)
                torch.cuda.synchronize()
                return out, stats, time.perf_counter() - t0
            return fn

        run_ranks(accls, leg(True, fp8))   # warm-up: cuBLAS, the allocator
        for wire, kw in (("fp32", {}), ("fp8_block128", fp8)):
            outs = {}
            for overlap in (True, False):
                cnt = counters()
                before = {k_: f.launches for k_, f in cnt.items()}
                res = run_ranks(accls, leg(overlap, kw))
                per = {k_: f.launches - before[k_] for k_, f in cnt.items()
                       if f.launches - before[k_]}
                for k_, n in per.items():
                    launched[k_] = launched.get(k_, 0) + n
                outs[overlap] = [o for o, _, _ in res]
                of = [s["overlap_frac"] for _, s, _ in res]
                ms = max(t for _, _, t in res) * 1e3
                say(f"12c ring workload {wire} overlap "
                    f"{'on' if overlap else 'off'}: {ms:.2f} ms (slowest "
                    f"rank, host clock), overlap_frac {min(of):.4f}-"
                    f"{max(of):.4f}, launches {per or 'none'}")
            for r in range(W):
                need(torch.equal(outs[True][r], outs[False][r]),
                     f"12c {wire}: overlap on and off differ")
            if wire == "fp32":
                worst = 0.0
                for r in range(W):
                    err = (outs[True][r] - gold[r]).abs()
                    need(bool((err <= 1e-5 * gold[r].abs() + 1e-6).all()),
                         "12c fp32: outside rtol 1e-5, atol 1e-6")
                    worst = max(worst, float(err.max()))
                say(f"12c ring fp32 vs float64 reference: max abs err "
                    f"{worst:.3g} (limit 1e-5 |ref| + 1e-6)")
                continue
            with plain_codecs(ctx):
                plain = [o for o, _, _ in run_ranks(accls, leg(True, kw))]
            check_rows(outs[True], plain, "12c fp8 rotation vs plain")
            rel = max(float((outs[True][r] - gold[r]).norm()
                            / gold[r].norm()) for r in range(W))
            need(rel < 2.0 ** -3, f"12c fp8: relative L2 {rel:.4f}")
            say(f"12c ring fp8 block 128: bitwise the plain codecs' run; "
                f"relative L2 vs float64 {rel:.5f} (limit 2^-3)")
    finally:
        for a in accls:
            a.deinit()


def elastic_kv_phase(say):
    """12d: the elastic decode pool on ``cuda_world(4)``: a bf16 KV arena
    of 224 blocks of 2 MiB dealt over decode ranks (1, 2); rank 3 joins
    (``grow_communicator``, the joiner by ``base_members``) and the arena
    reshards block_cyclic -> block_cyclic; then rank 2 leaves (revoke,
    ``shrink_communicator``) and the survivors' blocks re-deal over global
    ranks 1, 3 and 0. Each landing bitwise ``redistribute_oracle``; fewer
    elements moved than the gather-reshard-scatter oracle; no piece above
    one block."""
    import torch
    from accl_tpu_torch import cuda_world
    from accl_tpu_torch.hier import plan_redistribute, redistribute_oracle
    from accl_tpu_torch.serving import kv_shard_spec, reshard_plan_counts
    from accl_tpu_torch.testing import run_ranks
    accls = cuda_world(4)
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 123)
        subs, grown = {}, {}

        def split(a):
            if a.rank < 3:
                subs[a.rank] = a.split_communicator([0, 1, 2])
        run_ranks(accls, split)

        def grow(a):
            if a.rank == 3:
                grown[3] = a.grow_communicator([3], base_members=[0, 1, 2],
                                               key=21)
            else:
                grown[a.rank] = a.grow_communicator([3], comm=subs[a.rank],
                                                    key=21)
        run_ranks(accls, grow)
        need(len({c.comm_id for c in grown.values()}) == 1,
             "12d: the members disagree on the grown comm id")

        def reshard(what, members, comms, src, dst, src_bufs):
            counts = reshard_plan_counts(src, dst)
            need(counts["moved_elems"] < counts["oracle_moved_elems"],
                 f"12d {what}: moved no fewer elements than the oracle")
            p2p = 0
            for me in range(src.world):
                plan = plan_redistribute(src, dst, me)
                big = [s.count for s in plan.steps
                       if s.kind in ("send", "recv") and s.count > KV_BLOCK]
                need(not big, f"12d {what}: a staged piece above one block")
                p2p += sum(1 for s in plan.steps if s.kind in ("send",
                                                               "recv"))
            dst_bufs = {}

            def fn(a):
                me = comms[a.rank].local_rank
                db = a.buffer((max(1, dst.local_count(me)),), torch.bfloat16,
                              device_resident=True)
                t0 = time.perf_counter()
                a.redistribute(src_bufs[a.rank], src, db, dst,
                               comm=comms[a.rank])
                torch.cuda.synchronize()
                dst_bufs[a.rank] = db
                return time.perf_counter() - t0
            t0 = time.perf_counter()
            lib = max(run_ranks([accls[g_] for g_ in members], fn))
            host = (time.perf_counter() - t0) * 1e3
            # the oracle on the bf16 bits (numpy has no bfloat16)
            shards = [src_bufs[g_].tensor.view(torch.int16)[
                :src.local_count(i)].cpu().numpy()
                for i, g_ in enumerate(members)]
            want = redistribute_oracle(shards, src, dst)
            for i, g_ in enumerate(members):
                got = dst_bufs[g_].tensor.view(torch.int16)[
                    :dst.local_count(i)].cpu().numpy()
                need(got.tobytes() == want[i].tobytes(),
                     f"12d {what}: rank {g_}'s landing is not the oracle's")
            frac = counts["moved_elems"] / counts["oracle_moved_elems"]
            say(f"12d elastic {what}: {lib * 1e3:.1f} ms (slowest rank "
                f"inside redistribute), host {host:.1f} ms; moved "
                f"{counts['moved_elems']} of the oracle's "
                f"{counts['oracle_moved_elems']} elements (fraction "
                f"{frac:.3f}), {counts['local_elems']} copied locally, "
                f"{p2p} p2p calls (peak a rank "
                f"{counts['peak_rank_transfers']}); bitwise the oracle")
            return dst_bufs

        src = kv_shard_spec(KV_BLOCKS, KV_BLOCK, 4, order=(1, 2))
        dst = kv_shard_spec(KV_BLOCKS, KV_BLOCK, 4, order=(1, 2, 3))
        bufs = {}
        for r in range(4):
            n = max(1, src.local_count(r))
            bits = torch.randint(-2 ** 15, 2 ** 15, (n,), dtype=torch.int32,
                                 device="cuda", generator=g)
            bufs[r] = accls[r].buffer(data=bits.to(torch.int16).view(
                torch.bfloat16), device_resident=True)
        landed = reshard("grow by rank 3", [0, 1, 2, 3], grown, src, dst,
                         bufs)
        del bufs

        survivors = [0, 1, 3]
        shrunk = {}

        def shrink(a):
            a.revoke(grown[a.rank])
            shrunk[a.rank] = a.shrink_communicator([2], comm=grown[a.rank])
        run_ranks([accls[g_] for g_ in survivors], shrink)
        need(len({c.comm_id for c in shrunk.values()}) == 1,
             "12d: the survivors disagree on the shrunken comm id")
        # the survivors hold every third block but rank 2's: renumbered,
        # they are a block-cyclic arena over global ranks 1 and 3 (local
        # 1 and 2) as they lie; re-deal it over 1, 3 and 0
        n_blocks = sum(1 for b in range(KV_BLOCKS) if b % 3 != 1)
        src2 = kv_shard_spec(n_blocks, KV_BLOCK, 3, order=(1, 2))
        dst2 = kv_shard_spec(n_blocks, KV_BLOCK, 3, order=(1, 2, 0))
        for i, g_ in enumerate(survivors):
            need(src2.local_count(i) == (dst.local_count(g_) if g_ else 0),
                 "12d: the survivors' blocks are not the renumbered arena")
        reshard("shrink away rank 2", survivors, shrunk, src2, dst2, landed)
    finally:
        for a in accls:
            a.deinit()


def retry_phase(say):
    """12e: the call contract on the card: a recv with a 0.2 s deadline
    posted before its peer's send succeeds under ``retries=3`` and counts
    a retry, fails with RECEIVE_TIMEOUT_ERROR under ``retries=0``, and
    with the attempts spent carries CALL_RETRIES_EXHAUSTED; an async
    call in flight on a revoked comm finishes with PEER_FAILED within
    1 s."""
    import torch
    from accl_tpu_torch import ACCLError, ErrorCode, cuda_world
    from accl_tpu_torch.retry import RetryPolicy
    from accl_tpu_torch.testing import run_ranks
    from accl_tpu_torch.tracing import METRICS
    accls = cuda_world(2)
    try:
        def late(retries, delay, policy=None):
            def fn(a):
                if a.rank == 0:
                    if delay is not None:
                        time.sleep(delay)
                        a.send(a.buffer(data=torch.arange(
                            16, dtype=torch.float32, device="cuda")), 16,
                            dst=1, tag=5)
                    return None
                a.set_timeout(0.2)
                dst = a.buffer((16,), torch.float32, device_resident=True)
                try:
                    a.recv(dst, 16, src=0, tag=5, retries=retries,
                           retry_policy=policy)
                    return 0, bool(torch.equal(dst.tensor, torch.arange(
                        16, dtype=torch.float32, device="cuda")))
                except ACCLError as exc:
                    return exc.error_word, False
                finally:
                    a.set_timeout(30.0)
            return fn

        def n_retries():
            return sum(METRICS.snapshot()["counters"].get(
                "call_retries_total", {}).values())

        r0 = n_retries()
        t0 = time.perf_counter()
        word, ok = run_ranks(accls, late(3, 0.3))[1]
        ms = (time.perf_counter() - t0) * 1e3
        n = n_retries() - r0
        need(word == 0 and ok and n >= 1,
             f"12e: retries=3 gave word {word:#x}, data ok {ok}, {n} retries")
        # the send comes 0.6 s late where the recv must fail: a margin
        word0, _ = run_ranks(accls, late(0, 0.6))[1]
        need(word0 == int(ErrorCode.RECEIVE_TIMEOUT_ERROR),
             f"12e: retries=0 gave {word0:#x}")
        run_ranks(accls, lambda a: a.soft_reset())   # the late send
        wordx, _ = run_ranks(accls, late(None, None, RetryPolicy(
            retries=2, backoff_s=0.01)))[1]
        need(wordx == int(ErrorCode.RECEIVE_TIMEOUT_ERROR)
             | int(ErrorCode.CALL_RETRIES_EXHAUSTED),
             f"12e: exhausted attempts gave {wordx:#x}")
        a = accls[1]
        dst = a.buffer((16,), torch.float32, device_resident=True)
        h = a.recv(dst, 16, src=0, tag=77, run_async=True)
        time.sleep(0.1)
        need(not h.done(), "12e: the recv retired with no send")
        t1 = time.perf_counter()
        a.revoke()
        try:
            h.wait(1.0)
            wordr = 0
        except ACCLError as exc:
            wordr = exc.error_word
        abort_ms = (time.perf_counter() - t1) * 1e3
        need(wordr == int(ErrorCode.PEER_FAILED) and abort_ms < 1000,
             f"12e: revoke gave {wordr:#x} after {abort_ms:.1f} ms")
        say(f"12e retries: a recv 0.3 s ahead of its send succeeded under "
            f"retries=3 in {ms:.1f} ms with {n} retries counted; "
            f"retries=0 {ErrorCode(word0).name}; exhausted "
            f"{wordx:#x} (RECEIVE_TIMEOUT_ERROR | CALL_RETRIES_EXHAUSTED); "
            f"an async recv in flight on a revoked comm failed "
            f"{ErrorCode(wordr).name} {abort_ms:.2f} ms after the revoke")
    finally:
        for a in accls:
            a.deinit()


ELASTIC_KERNELS = ("cast", "bs_quant", "bs_dequant")   # B2, B5, B6


def elastic_phase(recs):
    """Phase 12: 12a-12e, its lines printed after it ends, the first with
    its seconds. The B2, B5 and B6 counts are zeroed before it and read
    after it (the yardstick runs through the plain versions count none);
    each must have launched."""
    import torch
    lines, launched = [], {}
    t0 = time.perf_counter()
    ok = False
    try:
        for k in counters().values():
            k.launches = 0
        a2av_phase(lines.append, launched)
        gc.collect()
        torch.cuda.empty_cache()
        moe_phase(lines.append, launched)
        gc.collect()
        torch.cuda.empty_cache()
        ring_workload_phase(lines.append, launched)
        gc.collect()
        torch.cuda.empty_cache()
        elastic_kv_phase(lines.append)
        retry_phase(lines.append)
        ok = True
    finally:
        secs = time.perf_counter() - t0
        print(f"phase 12: {secs:.1f} s of command time"
              + ("" if ok else " (failed)") + f" ({CARD})")
        for line in lines:
            print(line)
    print(f"phase 12 launches (the drives, not the timing repeats): "
          f"{launched}")
    for k in ELASTIC_KERNELS:
        need(launched.get(k, 0) > 0, f"phase 12: kernel {k} never launched")
    add_path(recs, "elastic", {k: launched[k] for k in ELASTIC_KERNELS})


# -- phase 13: the tuner and the N-tier hierarchy ----------------------------

HIER_HOSTS = [0, 0, 0, 0, 1, 1, 1, 1]       # 2 "hosts" of 4 virtual ranks
HIER_UNEVEN = [0, 0, 0, 1, 1, 1, 1, 1]      # the leader shape
HIER_CHIPS = [0, 0, 1, 1, 2, 2, 3, 3]       # 3 tiers: chips in racks
HIER_RACKS = [0, 0, 0, 0, 1, 1, 1, 1]
HIER_SMALL_N = 8 << 20     # the uneven and 3-tier allreduces, a rank
HIER_BCAST_ROOT = 5
TUNER_SIZES = (1 << 10, 64 << 10, 4 << 20, 64 << 20)   # 13c, a rank
# B1, B5, B6, B7: the kernels phase 13 must launch (B2 rides 13b's bf16)
HIER_KERNELS = ("combine", "bs_quant", "bs_dequant", "bs_combine")


def hand_hier(a, op: str, src, dst, n: int, root: int = HIER_BCAST_ROOT,
              outer_kw=None):
    """The HIERARCHICAL program of ``op`` on HIER_HOSTS issued by hand,
    phase by phase, on split communicators of the driver: the yardstick
    its lowering is held to bitwise. ``n`` is the allreduce / bcast
    count, the per-rank chunk for allgather and reduce_scatter;
    ``outer_kw`` the wire of the inter phase (compress_phases="inter")."""
    import torch
    r = a.rank
    host, j = divmod(r, 4)
    inner = a.split_communicator([4 * host + i for i in range(4)],
                                 key=0x13A1)
    empty = lambda k: a.buffer((k,), torch.float32,  # noqa: E731
                               device_resident=True)
    if op == "allreduce":
        outer = a.split_communicator([j, 4 + j], key=0x13A2 + j)
        s1, s2 = empty(n // 4), empty(n // 4)
        a.reduce_scatter(src, s1, n // 4, comm=inner)
        a.allreduce(s1, s2, n // 4, comm=outer, **(outer_kw or {}))
        a.allgather(s2, dst, n // 4, comm=inner)
    elif op == "allgather":
        blk = dst[4 * host * n:(4 * host + 4) * n]
        a.gather(src, blk if j == 0 else None, n, root=0, comm=inner)
        if j == 0:
            leaders = a.split_communicator([0, 4], key=0x13B0)
            a.allgather(blk, dst, 4 * n, comm=leaders)
        a.bcast(dst, W * n, root=0, comm=inner)
    elif op == "reduce_scatter":
        sn = empty(W * n) if j == 0 else None
        a.reduce(src, sn, W * n, root=0, comm=inner)
        sb = None
        if j == 0:
            leaders = a.split_communicator([0, 4], key=0x13B0)
            sb = empty(4 * n)
            a.reduce_scatter(sn, sb, 4 * n, comm=leaders)
        a.scatter(sb, dst, n, root=0, comm=inner)
    else:                                   # bcast from root (host 1)
        rep = root if root // 4 == host else 4 * host
        if r in (0, root):
            reps = a.split_communicator([0, root], key=0x13B1)
            a.bcast(src, n, root=1, comm=reps)
        a.bcast(src, n, root=rep - 4 * host, comm=inner)


def hier_counts(metrics) -> dict:
    """hier_phase_wire_total by (tier, wire)."""
    rows = metrics.snapshot()["counters"].get("hier_phase_wire_total", {})
    out = collections.Counter()
    for labels, v in rows.items():
        kv = dict(p.split("=", 1) for p in labels.split(","))
        out[(kv["tier"], kv["wire"])] += v
    return out


def drive_counted(accls, fn, launched: dict):
    """One run of ``fn`` on every rank; its kernel launches are added to
    ``launched`` (the main path's count: comparison runs add nothing)."""
    import torch
    from accl_tpu_torch.testing import run_ranks
    cnt = counters()
    torch.cuda.synchronize()
    before = {k: f.launches for k, f in cnt.items()}
    out = run_ranks(accls, fn)
    torch.cuda.synchronize()
    per = {k: f.launches - before[k] for k, f in cnt.items()
           if f.launches - before[k]}
    for k, v in per.items():
        launched[k] = launched.get(k, 0) + v
    return out, per


def oracle(xs):
    """(float64 sum, float64 sum of |x|) of the rank rows, on the card."""
    import torch
    x64 = torch.zeros(xs[0].numel(), dtype=torch.float64, device="cuda")
    absum = torch.zeros_like(x64)
    for x in xs:
        x64 += x.double()
        absum += x.double().abs()
    return x64, absum


def hold_f32(name, got, x64, absum, k32: int = W - 1):
    """Every row within ``golden_bound(absum, k32)`` of the float64 sum
    (every intermediate of a sum is at most sum|x| in magnitude)."""
    import torch
    bd = golden_bound(absum, k32)
    worst = 0.0
    for t in got:
        need(bool(torch.isfinite(t).all()), f"{name}: non-finite")
        err = (t.double() - x64).abs()
        need(bool((err <= bd).all()), f"{name}: outside the f32 bound of "
                                      f"the float64 oracle")
        worst = max(worst, float((err / bd.clamp_min(1e-300)).max()))
    return worst


def hier_main(say, launched, accls, bufs, xs, ags):
    """13a and 13b on the aligned hierarchy, 64 Mi fp32 a rank, then the
    uneven and the 3-tier nests at 8 Mi."""
    import torch
    from accl_tpu_torch.tracing import METRICS
    from accl_tpu_torch.testing import run_ranks
    c = N // W
    H = "HIERARCHICAL"
    for a in accls:
        a.configure_hierarchy(HIER_HOSTS)
    calls = {
        "allreduce": lambda a, b: a.allreduce(b["src"], b["ar"], N,
                                              algorithm=H),
        "allgather": lambda a, b: a.allgather(b["ag_src"], b["ag"], c,
                                              algorithm=H),
        "reduce_scatter": lambda a, b: a.reduce_scatter(
            b["src"], b["rs"], c, algorithm=H),
        "bcast": lambda a, b: a.bcast(b["bc"], N, root=HIER_BCAST_ROOT,
                                      algorithm=H),
    }
    x64, absum = oracle(xs)
    for name, call in calls.items():
        _, per = drive_counted(accls, lambda a: call(a, bufs[a.rank]),
                               launched)
        # the same phases by hand, on the driver's split communicators
        hand = {}

        def by_hand(a, name=name):
            b = bufs[a.rank]
            dst = a.buffer(b[{"allreduce": "ar", "allgather": "ag",
                              "reduce_scatter": "rs",
                              "bcast": "bc"}[name]].shape, torch.float32,
                           device_resident=True)
            if name == "bcast":
                dst.tensor.copy_(b["bc_in"])
            src = b["ag_src"] if name == "allgather" else b["src"]
            n = N if name in ("allreduce", "bcast") else c
            hand_hier(a, name, dst if name == "bcast" else src, dst, n)
            hand[a.rank] = dst.tensor
        run_ranks(accls, by_hand)
        torch.cuda.synchronize()
        key = {"allreduce": "ar", "allgather": "ag", "reduce_scatter": "rs",
               "bcast": "bc"}[name]
        got = [bufs[r][key].tensor for r in range(W)]
        check_rows(got, [hand[r] for r in range(W)],
                   f"hierarchical {name} vs its phases by hand")
        del hand
        if name == "allreduce":
            ratio = hold_f32("hierarchical allreduce", got, x64, absum)
        elif name == "reduce_scatter":
            ratio = max(hold_f32(
                "hierarchical reduce_scatter", [t], x64[r * c:(r + 1) * c],
                absum[r * c:(r + 1) * c]) for r, t in enumerate(got))
        elif name == "allgather":
            gold = torch.cat(ags)
            need(all(torch.equal(t, gold) for t in got),
                 "hierarchical allgather: not the exact gather")
            ratio = 0.0
        else:
            need(all(torch.equal(t, xs[HIER_BCAST_ROOT]) for t in got),
                 "hierarchical bcast: not the root's values")
            ratio = 0.0
        say(f"13a {name}: bitwise its phases by hand; "
            + ("exact" if name in ("allgather", "bcast") else
               f"worst err/bound {ratio:.4f} against the float64 oracle "
               f"(bound ((1+2^-24)^{W - 1} - 1) sum|x|)")
            + f"; launches {per}")
    # -- 13b: compress_phases="inter", fp8-e4m3 block 128 ------------------
    fp8 = dict(compress_dtype=torch.float8_e4m3fn, block_scale=QBLOCK)
    h0 = hier_counts(METRICS)
    _, per = drive_counted(accls, lambda a: a.allreduce(
        bufs[a.rank]["src"], bufs[a.rank]["ar8"], N, algorithm=H,
        compress_phases="inter", **fp8), launched)
    dh = hier_counts(METRICS) - h0
    need(dh == {("intra", "full"): 2 * W, ("inter", "quantized"): W},
         f"13b: hier_phase_wire_total moved {dict(dh)}")
    need(all(per.get(k, 0) > 0 for k in ("bs_quant", "bs_dequant",
                                          "bs_combine")),
         f"13b: the codec did not launch ({per})")
    hand = {}
    cnt = counters()
    before = {k: f.launches for k, f in cnt.items()}

    def inter_by_hand(a):
        dst = a.buffer((N,), torch.float32, device_resident=True)
        hand_hier(a, "allreduce", bufs[a.rank]["src"], dst, N,
                  outer_kw=fp8)
        hand[a.rank] = dst.tensor
    run_ranks(accls, inter_by_hand)
    torch.cuda.synchronize()
    by_hand = {k: f.launches - before[k] for k, f in cnt.items()
               if f.launches - before[k]}
    # codec launches only in the inter phases: as many as the hand-issued
    # program's, whose only compressed phase is the outer allreduce
    need({k: per.get(k, 0) for k in ("bs_quant", "bs_dequant", "bs_combine")}
         == {k: by_hand.get(k, 0) for k in ("bs_quant", "bs_dequant",
                                             "bs_combine")},
         f"13b: codec launches {per} differ from the inter-only program's "
         f"{by_hand}")
    got = [bufs[r]["ar8"].tensor for r in range(W)]
    check_rows(got, [hand[r] for r in range(W)],
               "13b fp8 inter allreduce vs its phases by hand")
    del hand
    amax = float(absum.max())
    bound = BS_BOUND_PER_AMAX * 2 * amax + 1e-3
    err = max(float((t.double() - x64).abs().max()) for t in got)
    need(all(bool(torch.isfinite(t).all()) for t in got),
         "13b: non-finite")
    need(0 < err <= bound, f"13b: error {err} not in (0, {bound}]")
    say(f"13b compress_phases=inter fp8-e4m3 block {QBLOCK}: "
        f"hier_phase_wire_total {dict(dh)}; launches {per} (the inter-only "
        f"program by hand: {by_hand}); bitwise its phases by hand; max abs "
        f"err vs float64 {err:.6g} <= {bound:.6g} (2 quantizations on the "
        f"2-rank inter tier, amax 2^-4/(1-2^-4) each, + 1e-3)")
    # a bf16 inter wire on the same program: B2 on the inter phases
    h0 = hier_counts(METRICS)
    _, per = drive_counted(accls, lambda a: a.allreduce(
        bufs[a.rank]["src"], bufs[a.rank]["ar8"], N, algorithm=H,
        compress_dtype=torch.bfloat16, compress_phases="inter"), launched)
    dh = hier_counts(METRICS) - h0
    need(dh == {("intra", "full"): 2 * W, ("inter", "narrowed"): W}
         and per.get("cast", 0) > 0, f"13b bf16: {dict(dh)}, {per}")
    ratio = 0.0
    bd = golden_bound(absum, W - 1, "bfloat16", 2)
    for t in got:
        e = (t.double() - x64).abs()
        need(bool((e <= bd).all()), "13b bf16: outside its bound")
        ratio = max(ratio, float((e / bd.clamp_min(1e-300)).max()))
    say(f"13b compress_phases=inter bf16: hier_phase_wire_total "
        f"{dict(dh)}; launches {per}; worst err/bound {ratio:.4f}")
    del x64, absum
    # -- the uneven (leader) and 3-tier nests at 8 Mi a rank -------------
    n = HIER_SMALL_N
    small = [x[:n] for x in xs]
    s64, sabs = oracle(small)
    for what, hosts, levels in (("uneven [0,0,0,1,1,1,1,1]", HIER_UNEVEN,
                                 ()),
                                ("3-tier [0,0,1,1,2,2,3,3] in "
                                 "[0,0,0,0,1,1,1,1]", HIER_CHIPS,
                                 [HIER_RACKS])):
        for a in accls:
            a.configure_hierarchy(hosts, levels=levels)
        out = {}

        def small_ar(a):
            src = a.buffer(data=small[a.rank], device_resident=True)
            dst = a.buffer((n,), torch.float32, device_resident=True)
            a.allreduce(src, dst, n, algorithm=H)
            out[a.rank] = dst.tensor
        _, per = drive_counted(accls, small_ar, launched)
        got = [out[r] for r in range(W)]
        need(all(torch.equal(t, got[0]) for t in got),
             f"{what}: ranks' results differ")
        ratio = hold_f32(f"hierarchical allreduce {what}", got, s64, sabs)
        mode = accls[0].hierarchy.nest
        say(f"13a allreduce {what}, 8 Mi a rank: the same on every rank, "
            f"worst err/bound {ratio:.4f} against the float64 oracle; "
            f"{len(mode)} boundary grouping(s); launches {per}")
        del out, got
    for a in accls:
        a.configure_hierarchy(HIER_HOSTS)


def hier_timing(say, accls, bufs):
    """The 64 Mi allreduce three ways: hierarchical fp32, fp8 on the inter
    tier, and the flat ring beside them."""
    import torch
    from accl_tpu_torch.testing import run_ranks
    ways = {
        "hierarchical fp32": lambda a: a.allreduce(
            bufs[a.rank]["src"], bufs[a.rank]["ar"], N,
            algorithm="HIERARCHICAL"),
        "hierarchical, fp8-e4m3 block 128 inter": lambda a: a.allreduce(
            bufs[a.rank]["src"], bufs[a.rank]["ar8"], N,
            algorithm="HIERARCHICAL",
            compress_dtype=torch.float8_e4m3fn, block_scale=QBLOCK,
            compress_phases="inter"),
        "flat ring fp32": lambda a: a.allreduce(
            bufs[a.rank]["src"], bufs[a.rank]["ar"], N, algorithm="ring"),
    }
    for name, fn in ways.items():
        run_ranks(accls, fn)                        # warm-up
        runs = sorted(timed_drive(accls, fn) for _ in range(3))
        dev, lib, host = runs[1]
        cnt = counters()
        before = {k: f.launches for k, f in cnt.items()}
        kcounts = {}
        fams = device_ms_by_family(lambda: run_ranks(accls, fn), kcounts)
        per = {k: f.launches - before[k] for k, f in cnt.items()
               if f.launches - before[k]}
        say(f"13 timing, 64 Mi allreduce, {name}: {dev:.4f} ms of device "
            f"work behind a GPU sleep (median of 3), library {lib:.3f} ms "
            f"(slowest rank), host {host:.3f} ms, idle share "
            f"{1 - dev / lib:.3f}; kernels by family (profiled) "
            + (", ".join(f"{f} {ms:.3f}" for f, ms in sorted(fams.items()))
               or "not measured (the profiler saw none)")
            + f"; launches a call {per}")


def hier_integrity(say, accls, bufs):
    """13d: verify_integrity on a hierarchical allreduce and a flat
    allgather and bcast; a forced fingerprint mismatch on rank 1; the
    time of fingerprint_of on 256 MiB."""
    import torch
    from accl_tpu_torch import ACCLError, ErrorCode
    from accl_tpu_torch.tracing import METRICS
    from accl_tpu_torch.testing import run_ranks
    c = N // W

    def tot(name):
        return sum(METRICS.snapshot()["counters"].get(name, {}).values())

    calls = {
        "hierarchical allreduce": lambda a, b: a.allreduce(
            b["src"], b["ar"], N, algorithm="HIERARCHICAL",
            verify_integrity=True),
        "flat allgather": lambda a, b: a.allgather(
            b["ag_src"], b["ag"], c, algorithm="ring",
            verify_integrity=True),
        "flat bcast": lambda a, b: a.bcast(b["bc"], N, root=HIER_BCAST_ROOT,
                                           verify_integrity=True),
    }
    for name, call in calls.items():
        v0 = tot("integrity_verified_total")
        t0 = time.perf_counter()
        run_ranks(accls, lambda a: call(a, bufs[a.rank]))
        secs = time.perf_counter() - t0
        dv = tot("integrity_verified_total") - v0
        need(dv == W, f"13d {name}: integrity_verified_total rose {dv}, "
                      f"not {W}")
        say(f"13d {name} with verify_integrity: verified {dv:g} (once a "
            f"rank), {secs * 1e3:.1f} ms host clock for the call")
    saved = accls[1].fingerprint_of
    accls[1].fingerprint_of = lambda buf, nelems=None: 0xDEAD
    m0 = tot("integrity_mismatch_total")

    def corrupt(a):
        try:
            calls["hierarchical allreduce"](a, bufs[a.rank])
        except ACCLError as exc:
            return (bool(exc.error_word
                         & int(ErrorCode.DATA_INTEGRITY_ERROR)), str(exc))
        return False, "no error"
    try:
        outs = run_ranks(accls, corrupt)
    finally:
        accls[1].fingerprint_of = saved
    need(all(ok and "[1]" in msg for ok, msg in outs),
         f"13d: a forced mismatch did not fail every rank naming [1]: "
         f"{outs[:2]}")
    say(f"13d forced mismatch on rank 1: every rank raised "
        f"DATA_INTEGRITY_ERROR, e.g. {outs[0][1]!r}; "
        f"integrity_mismatch_total +{tot('integrity_mismatch_total') - m0:g}")
    # fingerprint_of on 256 MiB: the read-back into pinned memory and the
    # crc32 apart
    a, buf = accls[0], bufs[0]["ar"]
    fp = a.fingerprint_of(buf)                   # allocates the pinned buffer
    ts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        need(a.fingerprint_of(buf) == fp, "13d: fingerprint not stable")
        ts.append((time.perf_counter() - t0) * 1e3)
    host = torch.empty(buf.nbytes, dtype=torch.uint8, pin_memory=True)
    e0, e1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    e0.record()
    host.copy_(buf.tensor.view(torch.uint8))
    e1.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zlib.crc32(host.numpy())
    crc_ms = (time.perf_counter() - t0) * 1e3
    say(f"13d fingerprint_of, 256 MiB device-resident: "
        f"{statistics.median(ts):.2f} ms (median of 3, host clock); its "
        f"read-back into pinned memory {e0.elapsed_time(e1):.2f} ms (CUDA "
        f"events, {buf.nbytes / e0.elapsed_time(e1) / 1e6:.1f} GB/s), "
        f"crc32 {crc_ms:.2f} ms")


def hier_config(say, accls):
    """13e: preflight, the segment size, a custom arith registry entry,
    plan_cache_stats."""
    import torch
    from accl_tpu_torch import CCLOp
    from accl_tpu_torch.arith import _mk
    from accl_tpu_torch.testing import run_ranks
    a = accls[0]
    need(a.preflight(N) == [] and a.preflight(N, op="bcast") == [],
         "13e: preflight warned")
    a.set_max_segment_size(4096)
    need(a.device.max_segment_size == 4096,
         "13e: set_max_segment_size did not reach the device")
    a.set_max_segment_size(1 << 20)
    entry = _mk("float32", "bfloat16")

    def custom(a):
        a.arith_registry = {**a.arith_registry,
                            ("float32", "bfloat16"): entry}
        desc = a._prepare(CCLOp.allreduce, count=1024, comm=a.comm,
                          op0=a.buffer((1024,), torch.float32),
                          res=a.buffer((1024,), torch.float32),
                          compress_dtype=torch.bfloat16)
        return desc.arithcfg is entry
    need(all(run_ranks(accls, custom)), "13e: the custom entry did not "
                                        "resolve")
    stub = {"enabled": False, "entries": 0, "hits": 0, "misses": 0,
            "bypasses": 0, "evictions": 0, "invalidations": {}}
    need(a.plan_cache_stats() == stub, "13e: plan_cache_stats")
    say("13e preflight [] (no rx pool on this tier); set_max_segment_size "
        "4096 reached the device; a custom (float32, bfloat16) registry "
        "entry resolved; plan_cache_stats is the disabled stub")


def card_topology(say):
    """The figures CudaDevice.topology() carries, measured: the slowest
    rank's library time of a 1-element allreduce over 8 ranks (median of
    20) and the rate of one exchange round of 64 Mi f32 rows over 8
    ranks (device time, CUDA events)."""
    import torch
    from accl_tpu_torch import cuda_world
    from accl_tpu_torch.device import cuda as cuda_mod
    from accl_tpu_torch.testing import run_ranks
    accls = cuda_world(W)
    try:
        one = {}

        def setup(a):
            one[a.rank] = (a.buffer((1,), torch.float32, device_resident=True),
                           a.buffer((1,), torch.float32, device_resident=True))
        run_ranks(accls, setup)

        def call(a):
            t0 = time.perf_counter()
            a.allreduce(*one[a.rank], 1)
            return time.perf_counter() - t0
        for _ in range(3):
            run_ranks(accls, call)
        alpha_us = statistics.median(max(run_ranks(accls, call)) * 1e6
                                     for _ in range(20))
        coll = accls[0].device.ctx.coll
        rows = [torch.empty(N, device="cuda") for _ in range(W)]
        outs = [torch.empty(N, device="cuda") for _ in range(W)]
        pairs = [(r, (r + 1) % W) for r in range(W)]
        ms = time_ms(lambda: coll.exchange(rows, pairs, outs), reps=5,
                     warmup=1)
        beta_gbps = N * 4 / (ms * 1e-3) / 1e9
        del rows, outs
        say(f"13c the card's link figures (CudaDevice.topology()): alpha "
            f"{alpha_us:.1f} us measured (the code carries "
            f"{cuda_mod.CUDA_ALPHA_US}), beta {beta_gbps:.1f} GB/s "
            f"measured (a ring shift of 64 Mi f32 rows over 8 ranks in "
            f"{ms:.4f} ms; the code carries {cuda_mod.CUDA_BETA_GBPS}) "
            f"({CARD})")
    finally:
        for a in accls:
            a.deinit()


def hier_tuner(say, launched):
    """13c: one shared Tuner over MeshTopology.from_hosts(HIER_HOSTS),
    epsilon 0; AUTO allreduces with compress_dtype="auto" at 1 Ki, 64 Ki,
    4 Mi and 64 Mi a rank, each decision held to a fresh Tuner's; then
    one AUTO allreduce under the card's own topology."""
    import torch
    from accl_tpu_torch import Tuner, cuda_world
    from accl_tpu_torch.hier import MeshTopology
    from accl_tpu_torch.tracing import METRICS
    tuner = Tuner(topology=MeshTopology.from_hosts(HIER_HOSTS), epsilon=0.0)
    fresh = Tuner(topology=MeshTopology.from_hosts(HIER_HOSTS))
    accls = cuda_world(W, tuner=tuner)
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 13)
        xs = [torch.randn(max(TUNER_SIZES), device="cuda", generator=g)
              for _ in range(W)]
        for n in TUNER_SIZES:
            nb = 4 * n
            outs = {}
            h0 = hier_counts(METRICS)
            subs0 = sum(v for (op, cid), v in accls[0]._call_counts.items()
                        if op == "reduce_scatter")

            def fn(a):
                src = a.buffer(data=xs[a.rank][:n], device_resident=True)
                dst = a.buffer((n,), torch.float32, device_resident=True)
                a.allreduce(src, dst, n, compress_dtype="auto")
                outs[a.rank] = dst.tensor
            _, per = drive_counted(accls, fn, launched)
            for _ in range(2):                    # measured calls
                drive_counted(accls, fn, {})
            routed = sum(v for (op, cid), v in accls[0]._call_counts.items()
                         if op == "reduce_scatter") > subs0
            dh = hier_counts(METRICS) - h0
            quantized = (dh.get(("intra", "quantized"), 0) > 0 if routed
                         else per.get("bs_quant", 0) > 0)
            alg = tuner.select("allreduce", W, nb)
            wire = tuner.select_wire("allreduce", W, nb)
            block = tuner.recommend_quant_block(nb)
            need(alg == fresh.select("allreduce", W, nb)
                 and wire == fresh.select_wire("allreduce", W, nb)
                 and block == fresh.recommend_quant_block(nb),
                 f"13c {n}: the run's decisions differ from the Tuner's")
            need(routed == (alg.name == "HIERARCHICAL")
                 and quantized == wire,
                 f"13c {n}: ran routed={routed} quantized={quantized}, "
                 f"decided {alg.name} {wire}")
            got = [outs[r] for r in range(W)]
            x64, absum = oracle([x[:n] for x in xs])
            if wire:
                bound = BS_BOUND_PER_AMAX * 6 * float(absum.max()) + 1e-3
                err = max(float((t.double() - x64).abs().max())
                          for t in got)
                need(0 < err <= bound, f"13c {n}: err {err} > {bound}")
                txt = (f"max abs err {err:.6g} <= {bound:.6g} (6 "
                       f"quantizations, amax 2^-4/(1-2^-4) each, + 1e-3)")
            else:
                ratio = hold_f32(f"13c {n}", got, x64, absum)
                txt = f"f32, worst err/bound {ratio:.4f}"
            say(f"13c AUTO allreduce {n} elements a rank: "
                f"{alg.name}, wire {'fp8-e4m3 block-scaled' if wire else 'fp32'}"
                f", block {block} (the Tuner's select / select_wire / "
                f"recommend_quant_block alike); {txt}; launches {per}")
            del outs, got, x64, absum
        for line in tuner.describe().splitlines():
            say(f"13c describe: {line}")
    finally:
        for a in accls:
            a.deinit()
    gc.collect()
    card = Tuner()
    accls = cuda_world(W, tuner=card)
    try:
        topo = card.topology
        nb = 4 * N
        x = torch.ones(N, device="cuda")

        def fn(a):
            src = a.buffer(data=x, device_resident=True)
            dst = a.buffer((N,), torch.float32, device_resident=True)
            a.allreduce(src, dst, N, compress_dtype="auto")
            return bool((dst.tensor == W).all())
        ok, per = drive_counted(accls, fn, launched)
        need(all(ok), "13c card topology: wrong sum")
        say(f"13c AUTO allreduce 64 Mi under the card's topology (tier "
            f"{topo.tier}, alpha {topo.alpha_us} us, beta {topo.beta_gbps} "
            f"GB/s): {card.select('allreduce', W, nb).name}, wire "
            f"{'fp8' if card.select_wire('allreduce', W, nb) else 'fp32'}; "
            f"launches {per}")
    finally:
        for a in accls:
            a.deinit()


def hier_phase(recs):
    """Phase 13: 13a-13e on ``cuda_world(8)``, its lines printed after it
    ends. B1, B5, B6 and B7 must launch in its main drives (the hand-
    issued yardsticks count none)."""
    import torch
    from accl_tpu_torch import cuda_world
    from accl_tpu_torch.testing import run_ranks
    lines, launched = [], {}
    t0 = time.perf_counter()
    ok = False
    c = N // W
    try:
        # AUTO phases run the ring of B1 combines (the world's algorithm)
        accls = cuda_world(W, algorithm="ring")
        try:
            g = torch.Generator(device="cuda").manual_seed(SEED + 130)
            xs = [torch.randn(N, device="cuda", generator=g)
                  for _ in range(W)]
            ags = [torch.randn(c, device="cuda", generator=g)
                   for _ in range(W)]
            bufs = {}

            def setup(a):
                r = a.rank

                def dev(n):
                    return a.buffer((n,), torch.float32,
                                    device_resident=True)
                bufs[r] = {"src": a.buffer(data=xs[r],
                                           device_resident=True),
                           "ag_src": a.buffer(data=ags[r],
                                              device_resident=True),
                           "ar": dev(N), "ar8": dev(N), "ag": dev(N),
                           "rs": dev(c),
                           "bc": a.buffer(data=xs[r].clone() if r ==
                                          HIER_BCAST_ROOT else
                                          torch.zeros_like(xs[r]),
                                          device_resident=True)}
                bufs[r]["bc_in"] = bufs[r]["bc"].tensor.clone()
            run_ranks(accls, setup)
            hier_main(lines.append, launched, accls, bufs, xs, ags)
            hier_timing(lines.append, accls, bufs)
            hier_integrity(lines.append, accls, bufs)
            hier_config(lines.append, accls)
        finally:
            for a in accls:
                a.deinit()
            bufs = xs = ags = None
            gc.collect()
            torch.cuda.empty_cache()
        card_topology(lines.append)
        hier_tuner(lines.append, launched)
        ok = True
    finally:
        secs = time.perf_counter() - t0
        print(f"phase 13: {secs:.1f} s of command time"
              + ("" if ok else " (failed)") + f" ({CARD})")
        for line in lines:
            print(line)
    print(f"phase 13 launches (the drives, not the yardsticks): {launched}")
    for k in HIER_KERNELS:
        need(launched.get(k, 0) > 0, f"phase 13: kernel {k} never launched")
    add_path(recs, "hier", launched)


# -- phase 14: the driver's profiler, flight recorder and tenants, the ------
# -- tuning-table producer, DDP bucketed gradient all-reduce -----------------

# 14a's hooks are timed on a 1-element allreduce: blocks of this many drives
# a state (the first of a block a warm-up), the states in turns, 4 rounds
HOOK_REPS = 10
HOOK_MICRO = 20000          # 14a: records and emits timed alone
TUNE_SIZES = (1 << 10, 64 << 10, 4 << 20, 64 << 20)   # 14c, f32 a rank
TUNE_REPS = 3
# the table phase 13c's link figures predict for the allreduce (ROADMAP §C2)
TUNE_PREDICTED = {1 << 10: "NON_FUSED", 64 << 10: "NON_FUSED",
                  4 << 20: "NON_FUSED", 64 << 20: "RECURSIVE_DOUBLING"}
# B1, B5, B6, B7: what 14a's and 14c's drives must launch
DRIVER_KERNELS = ("combine", "bs_quant", "bs_dequant", "bs_combine")
DDP_LAYERS, DDP_STEPS, DDP_BF16_STEPS = 4, 4, 2
DDP_DP, DDP_S = 2, 2048             # one 2048-token sequence a dp rank
DDP_BUCKET = 25 << 20
DDP_LOSS_REL = 1e-2
# the DDP step's averaged gradients against the full batch's, per leaf,
# relative L2: bf16 activations round each weight gradient to 2^-9 on
# either side (about 1e-3 relative); a missing average is 1 and one
# rank's gradient alone about 0.5
DDP_GRAD_REL = 1e-2
DDP_UPD_SAMPLE = 1 << 16            # elements a leaf in the update check
DDP_LR = 1e-4
BUILD_DIR = "build/accl_tpu_torch/phase14"
PROM_LINE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def prometheus_rows(text: str) -> list:
    """(name, labels, value) of every sample line of an exposition; fails
    on a line that is neither a sample nor a ``# TYPE`` line."""
    rows = []
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            need(ln.split()[-1] in ("counter", "gauge", "histogram"),
                 f"14a: bad TYPE line {ln!r}")
            continue
        m = PROM_LINE.match(ln)
        need(m is not None, f"14a: not a Prometheus sample line: {ln!r}")
        labels = dict(PROM_LABEL.findall(m.group(3) or ""))
        need(",".join(f'{k}="{v}"' for k, v in labels.items())
             == (m.group(3) or ""), f"14a: bad labels in {ln!r}")
        rows.append((m.group(1), labels, float(m.group(4))))
    return rows


def hook_costs(accls, fn) -> dict:
    """The slowest rank's library time of ``fn`` in microseconds with the
    hooks off, the profiler on and the flight recorder armed: four rounds
    of one block of HOOK_REPS drives a state, the states in turns (so
    drift falls on all three alike), the first drive of a block dropped;
    (median, first quartile, third quartile) of each state's drives."""
    from accl_tpu_torch.testing import run_ranks
    from accl_tpu_torch.tracing import TRACE

    def one(a):
        t0 = time.perf_counter()
        fn(a)
        return time.perf_counter() - t0
    states = ("off", "profiler on", "trace armed")
    samples = {k: [] for k in states}
    for _ in range(4):
        for k in states:
            if k == "profiler on":
                for a in accls:
                    a.start_profiling()
            elif k == "trace armed":
                TRACE.start()
            samples[k] += [max(run_ranks(accls, one)) * 1e6
                           for _ in range(HOOK_REPS)][1:]
            for a in accls:
                if a.profiler.enabled:
                    a.end_profiling()
                a.profiler.clear()
            TRACE.stop()
            TRACE.clear()
    out = {}
    for k, v in samples.items():
        q1, _, q3 = statistics.quantiles(v, n=4)
        out[k] = (statistics.median(v), q1, q3)
    return out


def hook_micro() -> dict:
    """Host microseconds of one record (attach on a retired handle, the
    profiler armed), one armed emit and one disarmed ``TRACE.enabled``
    test, each over HOOK_MICRO repetitions."""
    from accl_tpu_torch.call import CompletedHandle
    from accl_tpu_torch.tracing import TRACE, EventTrace, Profiler
    prof, h = Profiler(), CompletedHandle()
    prof.start()
    t0 = time.perf_counter()
    for _ in range(HOOK_MICRO):
        prof.attach(h, "allreduce", 1, 4, 1, algorithm="RING",
                    tenant="comm-1")
    rec = (time.perf_counter() - t0) / HOOK_MICRO * 1e6
    tr = EventTrace(capacity=HOOK_MICRO)
    tr.start()
    t0 = time.perf_counter()
    for i in range(HOOK_MICRO):
        tr.emit("call_retry", rank=0, seqn=i, nbytes=4, peer=-1)
    emit = (time.perf_counter() - t0) / HOOK_MICRO * 1e6
    TRACE.stop()
    n = 0
    t0 = time.perf_counter()
    for _ in range(HOOK_MICRO):
        if TRACE.enabled:
            n += 1
    guard = (time.perf_counter() - t0) / HOOK_MICRO * 1e6
    need(len(prof.records) == HOOK_MICRO and len(tr.events()) == HOOK_MICRO
         and n == 0, "14a: the hook microbenchmark lost records")
    return {"record": rec, "emit": emit, "guard": guard}


def profiler_phase(say, launched):
    """14a: under start_profiling, the fp32 ring allreduce, the fp8-e4m3
    block-128 ring allreduce and the 2 x 4 hierarchical allreduce of
    phase 13 at 64 Mi fp32 a rank; the records, the summary, the trace
    (a verify_integrity call and one retried recv under the armed
    recorder) and the exposition checked; the hooks' cost."""
    import os
    import torch
    from accl_tpu_torch import cuda_world
    from accl_tpu_torch.testing import run_ranks
    from accl_tpu_torch.tracing import (TRACE, annotate,
                                        measure_call_latency, trace_to)
    accls = cuda_world(W, algorithm="ring")
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 140)
        xs = [torch.randn(N, device="cuda", generator=g) for _ in range(W)]
        bufs = {}

        def setup(a):
            bufs[a.rank] = (a.buffer(data=xs[a.rank], device_resident=True),
                            a.buffer((N,), torch.float32,
                                     device_resident=True))
            a.configure_hierarchy(HIER_HOSTS)
        run_ranks(accls, setup)
        fp8 = dict(compress_dtype=torch.float8_e4m3fn, block_scale=QBLOCK)
        calls = {
            "fp32 ring": lambda a: a.allreduce(*bufs[a.rank], N,
                                               algorithm="ring"),
            "fp8-e4m3 block-128 ring": lambda a: a.allreduce(
                *bufs[a.rank], N, algorithm="ring", **fp8),
            "hierarchical 2 x 4": lambda a: a.allreduce(
                *bufs[a.rank], N, algorithm="HIERARCHICAL"),
        }
        for fn in calls.values():                        # warm-up
            run_ranks(accls, fn)
        issued0 = [sum(a._call_counts.values()) for a in accls]
        TRACE.clear()
        for a in accls:
            a.start_profiling()
        TRACE.start()
        for fn in calls.values():
            drive_counted(accls, fn, launched)
        for a in accls:
            a.end_profiling()
        issued = [sum(a._call_counts.values()) - i0
                  for a, i0 in zip(accls, issued0)]
        for a, n_issued in zip(accls, issued):
            recs = a.profiler.records
            need(len(recs) == n_issued,
                 f"14a rank {a.rank}: {len(recs)} records for {n_issued} "
                 f"calls issued (the logical one included)")
            flat = [x for x in recs if not x.parent]
            need(sorted(x.algorithm for x in flat) == ["RING", "RING"]
                 and all(x.op == "allreduce" and x.count == N
                         for x in flat),
                 f"14a rank {a.rank}: flat records {flat}")
            tags = {x.parent for x in recs if x.parent}
            need(len(tags) == 1, f"14a rank {a.rank}: parent tags {tags}")
            logical = [x for x in recs if x.algorithm == "HIERARCHICAL"]
            need(len(logical) == 1 and logical[0].parent in tags
                 and len(recs) - len(flat) > 1,
                 f"14a rank {a.rank}: the logical record {logical}")
            need(all(x.tenant == f"comm-{a.comm.comm_id}" or x.parent
                     for x in recs), f"14a rank {a.rank}: tenant labels")
        prof = accls[0].profiler
        phases = len(prof.records) - 3
        for line in prof.table().splitlines():
            say(f"14a table (rank 0): {line}")
        summ = prof.summary()["allreduce"]
        say(f"14a records: {sum(issued)} over {W} ranks, one a call issued "
            f"(rank 0: 2 flat rings, {phases} phases tagged "
            f"{next(iter({x.parent for x in prof.records if x.parent}))!r} "
            f"and their HIERARCHICAL record); ProfilerSummary allreduce n "
            f"{summ.n}, p50 {summ.p50_us:.1f} us, p95 {summ.p95_us:.1f} us")
        # each call's record beside its device and library time: a record
        # ends when the rank's call retires, which on the card is when its
        # kernels are enqueued
        for name, fn in calls.items():
            for a in accls:
                a.profiler.clear()
                a.start_profiling()
            dev, lib, host = timed_drive(accls, fn)
            for a in accls:
                a.end_profiling()
            rec_us = max(x.duration_us for a in accls
                         for x in a.profiler.records if not x.parent
                         or x.algorithm == "HIERARCHICAL")
            fams = device_ms_by_family(lambda: run_ranks(accls, fn))
            say(f"14a {name} allreduce, 64 Mi a rank: CallRecord "
                f"duration_us {rec_us:.1f} (slowest rank: issue to retire, "
                f"where retire means the kernels are enqueued, so this is "
                f"host time) beside {dev:.4f} ms of device work (CUDA "
                f"events behind a GPU sleep) and {lib:.3f} ms library time "
                f"(slowest rank; host {host:.3f} ms); kernels by family "
                + (", ".join(f"{f} {ms:.3f}" for f, ms in sorted(
                    fams.items())) or "not measured") + f" ({CARD})")
        # the flight recorder: a verified allreduce and a retried recv
        run_ranks(accls, lambda a: a.allreduce(*bufs[a.rank], N,
                                               algorithm="ring",
                                               verify_integrity=True))

        def late(a):
            if a.rank == 0:
                time.sleep(0.3)
                a.send(bufs[0][0], 16, dst=1, tag=41)
            elif a.rank == 1:
                a.set_timeout(0.2)
                try:
                    a.recv(bufs[1][1], 16, src=0, tag=41, retries=3)
                finally:
                    a.set_timeout(30.0)
        os.makedirs(BUILD_DIR, exist_ok=True)
        TRACE.dump_dir = BUILD_DIR
        run_ranks(accls, late)
        TRACE.stop()
        # the first attempt's recv deadline dumped the armed recorder
        dumps = [p for p in TRACE.dump_paths
                 if p.endswith("_recv_deadline_abort.json")]
        need(len(dumps) >= 1, f"14a: no recv-deadline dump in "
             f"{TRACE.dump_paths}")
        with open(dumps[0]) as f:
            n_dump = sum(e["ph"] == "X" for e in json.load(f)["traceEvents"])
        path = os.path.join(BUILD_DIR, "trace.json")
        n_ev = accls[0].export_trace(path)
        with open(path) as f:
            doc = json.load(f)
        kinds = collections.Counter(e["name"] for e in doc["traceEvents"]
                                    if e["ph"] == "X")
        need(kinds["fingerprint"] == W and kinds["call_retry"] >= 1
             and n_ev == sum(kinds.values()),
             f"14a: trace event kinds {dict(kinds)}, {n_ev} events")
        TRACE.clear()
        say(f"14a export_trace: {n_ev} events, valid Chrome JSON "
            f"({os.path.getsize(path)} bytes), kinds {dict(kinds)}; the "
            f"retried recv's first deadline dumped the recorder "
            f"({len(dumps)} dump(s), the first with {n_dump} events)")
        text = accls[0].metrics_text()
        rows = prometheus_rows(text)
        calls_rows = [lab for name, lab, _ in rows
                      if name == "accl_calls_total"]
        need(calls_rows and all("tenant" in lab for lab in calls_rows),
             "14a: an accl_calls_total row without a tenant label")
        say(f"14a metrics_text: {len(text.splitlines())} lines parse as "
            f"Prometheus text, {len(rows)} samples; all "
            f"{len(calls_rows)} accl_calls_total rows carry a tenant label")
        lat = measure_call_latency(accls[0], n=200)
        say(f"14a measure_call_latency (nop, rank 0, 200 calls): p50 "
            f"{lat['p50_us']:.1f} us, p95 {lat['p95_us']:.1f} us, min "
            f"{lat['min_us']:.1f} us")
        one = {}

        def setup1(a):
            one[a.rank] = (a.buffer((1,), torch.float32, device_resident=True),
                           a.buffer((1,), torch.float32, device_resident=True))
        run_ranks(accls, setup1)

        cost = hook_costs(accls, lambda a: a.allreduce(*one[a.rank], 1))
        off = cost["off"][0]
        micro = hook_micro()
        say(f"14a the hooks' cost, a 1-element allreduce over {W} ranks "
            f"(slowest rank's library time, median and quartiles of "
            f"{4 * (HOOK_REPS - 1)} drives a state, 4 rounds of the states "
            f"in turns): "
            + ", ".join(f"{k} {m:.1f} us ({q1:.1f}-{q3:.1f}; {m - off:+.1f})"
                        for k, (m, q1, q3) in cost.items())
            + f" (the call has no emit site); alone, over {HOOK_MICRO} "
            f"repetitions (host): one record {micro['record']:.2f} us, one "
            f"armed emit {micro['emit']:.2f} us, one disarmed test "
            f"{micro['guard'] * 1e3:.1f} ns ({CARD})")
        # annotate and trace_to: a named range in a torch.profiler capture
        prof_dir = os.path.join(BUILD_DIR, "profile")
        with trace_to(prof_dir):
            with annotate("accl_phase14a_ring"):
                run_ranks(accls, calls["fp32 ring"])
            torch.cuda.synchronize()
        with open(os.path.join(prof_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        ranges = sum(1 for e in events
                     if e.get("name") == "accl_phase14a_ring")
        kern = sum(1 for e in events if e.get("cat") == "kernel")
        need(ranges >= 1,
             "14a: the annotate range is not in the trace_to capture")
        say(f"14a trace_to: {len(events)} events in {prof_dir}/trace.json, "
            f"the annotate range 'accl_phase14a_ring' {ranges} time(s), "
            f"{kern} kernel records")
    finally:
        TRACE.stop()
        TRACE.clear()
        for a in accls:
            a.deinit()


def tenants_phase(say, launched):
    """14b: ``cuda_world(8)`` and ``add_tenant(..., "tenant-b", key=1)``
    on the same devices, 64 Mi fp32 ring allreduces of both interleaved,
    each bitwise its plain version; the rows and records per tenant; an
    invalid label refused."""
    import torch
    from accl_tpu_torch import ACCL, cuda_world
    from accl_tpu_torch.testing import add_tenant, run_ranks
    from accl_tpu_torch.tracing import METRICS
    tenant_a = cuda_world(W, algorithm="ring")
    tenant_b = add_tenant(tenant_a, "tenant-b", key=1)
    ctx = tenant_a[0].device.ctx
    try:
        need(all(x.device is y.device for x, y in zip(tenant_a, tenant_b)),
             "14b: the tenants do not share the devices")
        g = torch.Generator(device="cuda").manual_seed(SEED + 141)
        xs = {t: [torch.randn(N, device="cuda", generator=g)
                  for _ in range(W)] for t in "ab"}
        outs = {t: [[torch.empty(N, device="cuda") for _ in range(2)]
                    for _ in range(W)] for t in "ab"}

        def interleaved(a):
            b = tenant_b[a.rank]
            r = a.rank
            src = {"a": a.buffer(data=xs["a"][r], device_resident=True),
                   "b": b.buffer(data=xs["b"][r], device_resident=True)}
            hs = []
            for i in range(2):
                for t, d in (("a", a), ("b", b)) if i == 0 else \
                        (("b", b), ("a", a)):
                    dst = d.buffer(data=outs[t][r][i], device_resident=True)
                    hs.append(d.allreduce(src[t], dst, N, run_async=True))
            for h in hs:
                h.wait(60)
        for d in tenant_a + tenant_b:
            d.start_profiling()
        before = METRICS.snapshot()
        drive_counted(tenant_a, interleaved, launched)
        after = METRICS.snapshot()
        for d in tenant_a + tenant_b:
            d.end_profiling()

        def per_tenant(snap):
            out = collections.Counter()
            for labels, v in snap["counters"].get("accl_calls_total",
                                                  {}).items():
                kv = dict(p.split("=", 1) for p in labels.split(","))
                if kv.get("ctx") == str(ctx.seq):
                    out[(kv["tenant"], kv["op"])] += v
            return out
        rows = per_tenant(after) - per_tenant(before)
        ta = f"comm-{tenant_a[0].comm.comm_id}"
        need(rows == {(ta, "allreduce"): 2 * W,
                      ("tenant-b", "allreduce"): 2 * W},
             f"14b: accl_calls_total per tenant moved {dict(rows)}")
        for drivers, t in ((tenant_a, ta), (tenant_b, "tenant-b")):
            for d in drivers:
                recs = d.profiler.records
                need(len(recs) == 2 and all(x.tenant == t for x in recs),
                     f"14b rank {d.rank}: records {recs}")
                need(d.device.tenant_of(d.comm.comm_id) == t,
                     f"14b rank {d.rank}: the device's tenant of its comm")
        # the plain version of every result: the same rings through PLAIN
        with plain_codecs(ctx):
            plain = {}
            for t, world in (("a", tenant_a), ("b", tenant_b)):
                plain[t] = ctx.coll.allreduce(xs[t], algorithm="ring")
        torch.cuda.synchronize()
        for t in "ab":
            check_rows([o for r in range(W) for o in outs[t][r]],
                       [plain[t][r] for r in range(W) for _ in range(2)],
                       f"14b tenant {t} interleaved ring allreduce")
        try:
            ACCL(tenant_a[0].device, tenant_a[0].comm, tenant="bad label")
            msg = None
        except ValueError as exc:
            msg = str(exc)
        want = ("invalid tenant label 'bad label': must match "
                "[A-Za-z0-9][A-Za-z0-9._-]{0,63} (it is embedded in CSV, "
                "Prometheus and trace encodings)")
        need(msg == want, f"14b: an invalid tenant gave {msg!r}")
        say(f"14b two tenants on the same {W} CudaDevices (comm ids "
            f"{tenant_a[0].comm.comm_id} and {tenant_b[0].comm.comm_id}): "
            f"2 + 2 interleaved async 64 Mi fp32 ring allreduces a rank, "
            f"each bitwise its plain version; accl_calls_total moved "
            f"{dict(rows)}; every CallRecord names its tenant; "
            f"ACCL(tenant='bad label') raised the reference's ValueError")
    finally:
        for d in tenant_a:
            d.deinit()


def tune_phase(say, launched):
    """14c: the port's ``run_tune`` on ``cuda_world(8)`` over the
    reference's ops at 1 Ki, 64 Ki, 4 Mi and 64 Mi f32 a rank, 3 reps, the
    window of each rep closed by a device synchronize, the sources seeded
    random; the first warm-up of each (op, algorithm, wire) bitwise the
    same call through the plain versions; the table loaded
    into a fresh Tuner through ``tuner/cache.py``; AUTO at every swept
    size resolving to the chosen row, also through a world's drivers."""
    import os
    import torch
    from accl_tpu_torch import Tuner, cuda_world
    from accl_tpu_torch.testing import run_ranks
    from accl_tpu_torch.tuner import cache, sweep
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "tuning.json")
    cnt = counters()
    before = {k: f.launches for k, f in cnt.items()}
    yard = cuda_world(W)
    checked = []

    def check(op, count, alg, kw, kept):
        """The sweep's first warm-up of (op, algorithm, wire) against the
        same call on the same seeded sources through the plain versions,
        bitwise; the yardstick launches no kernel."""
        moved = {k: f.launches for k, f in cnt.items()}
        with plain_codecs(yard[0].device.ctx):
            again = run_ranks(yard, sweep._rank_body(
                op, count, W, alg, 0, True,
                sources=[src for src, _ in kept], **kw))
        torch.cuda.synchronize()
        need(all(f.launches == moved[k] for k, f in cnt.items()),
             f"14c {op} {alg.name}: the plain yardstick launched kernels")
        name = alg.name + ("+fp8-bs" if kw else "")
        check_rows([out for _, out in kept], [k[1] for _, k in again],
                   f"14c {op} {name} {count} f32 a rank")
        checked.append(f"{op} {name}")

    t0 = time.perf_counter()
    try:
        out = sweep.run_tune(W, sizes=[4 * n for n in TUNE_SIZES],
                             reps=TUNE_REPS, cache_path=path, check=check)
    finally:
        for a in yard:
            a.deinit()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    for k, f in cnt.items():
        if f.launches - before[k]:
            launched[k] = launched.get(k, 0) + f.launches - before[k]
    rows_path = sweep.write_rows(out["rows"], BUILD_DIR)
    forced = [r for r in out["rows"] if r["source"] == "forced"]
    chosen = [r for r in out["rows"] if r["source"] == "chosen"]
    need(len(checked) == len({(r["op"], r["algorithm"]) for r in forced}),
         f"14c: {len(checked)} (op, algorithm, wire) points checked")
    say(f"14c run_tune: {len(forced)} forced rows ({TUNE_REPS} reps each, "
        f"synchronized windows, seeded random sources) and {len(chosen)} "
        f"chosen rows in {secs:.1f} s; the first warm-up of each of "
        f"{len(checked)} (op, algorithm, wire) points, at "
        f"{TUNE_SIZES[0]} f32 a rank, bitwise the plain versions' on the "
        f"same sources; table {path}, rows {rows_path} ({CARD})")
    by_point = collections.defaultdict(dict)
    for r in forced:
        by_point[(r["op"], r["count"])][r["algorithm"]] = \
            r["seconds_per_op"] * 1e3
    for (op, count), algs in by_point.items():
        say(f"14c forced {op} {count} f32 a rank (ms, min of {TUNE_REPS}): "
            + ", ".join(f"{k} {v:.3f}" for k, v in algs.items()))
    fresh = Tuner()
    n_pinned = cache.load_into(fresh, path, strict=True)
    need(n_pinned == len(json.load(open(path))["entries"]) and n_pinned,
         f"14c: {n_pinned} entries pinned")
    for r in chosen:
        alg = r["algorithm"].split("+")[0]
        need(fresh.select(r["op"], W, r["nbytes"]).name == alg,
             f"14c: AUTO {r['op']} {r['nbytes']} B resolves to "
             f"{fresh.select(r['op'], W, r['nbytes']).name}, the table "
             f"chose {alg}")
    say("14c chosen: " + "; ".join(f"{r['op']} {r['count']} "
                                   f"{r['algorithm']}" for r in chosen))
    disagree = [(n, r["algorithm"], TUNE_PREDICTED[n]) for r in chosen
                for n in TUNE_SIZES if r["op"] == "allreduce"
                and r["count"] == n
                and r["algorithm"].split("+")[0] != TUNE_PREDICTED[n]]
    say("14c the allreduce table against phase 13c's link figures "
        "(NON_FUSED to 4 Mi, RECURSIVE_DOUBLING at 64 Mi): "
        + ("agrees" if not disagree else "differs at " + ", ".join(
            f"{n} ({got}, predicted {want})" for n, got, want in disagree)))
    # the drivers of a world with the table's tuner run the chosen rows
    accls = cuda_world(W, tuner=fresh)
    try:
        ran = {}
        for n in TUNE_SIZES:
            def fn(a, n=n):
                src = a.buffer(data=torch.ones(n, device="cuda"),
                               device_resident=True)
                dst = a.buffer((n,), torch.float32, device_resident=True)
                a.start_profiling()
                a.allreduce(src, dst, n)
                a.end_profiling()
                ok = bool((dst.tensor == W).all())
                src.free_buffer()
                dst.free_buffer()
                return a.profiler.records[-1].algorithm, ok
            got = run_ranks(accls, fn)
            want = next(r["algorithm"].split("+")[0] for r in chosen
                        if r["op"] == "allreduce" and r["count"] == n)
            need(all(ok and alg == want for alg, ok in got),
                 f"14c: AUTO allreduce {n} ran {got}, the table chose {want}")
            ran[n] = want
        say(f"14c a world with the loaded Tuner: AUTO allreduce ran the "
            f"table's algorithm at every swept size {ran}, sums exact")
    finally:
        for a in accls:
            a.deinit()


def ddp_grad_rows(model, leaves, tokens):
    """Each dp rank's gradients of its sequence, one row a rank, as the
    DDP step forms them."""
    rows = []
    for shard in tokens.chunk(DDP_DP):
        for p in leaves:
            p.grad = None
        model.loss(shard).backward()
        rows.append([p.grad for p in leaves])
    for p in leaves:
        p.grad = None
    return rows


def ddp_hold_grads(model, leaves, tokens, held):
    """Before the first DDP update (an optimizer pre-hook): the averaged
    gradients the step set, each leaf's relative L2 distance from the
    full batch's backward; then the gradients restored and a strided
    sample of each leaf and its gradient kept for the update check."""
    import torch
    if "grad_rel" in held:
        return
    ddp = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    before = attention_counters()
    model.loss(tokens).backward()
    # the yardstick's attention launches are not the path's
    held["check_launches"] = {k: v - before[k]
                              for k, v in attention_counters().items()}
    rel = []
    for p, g in zip(leaves, ddp):
        rel.append(float((g - p.grad).norm() / p.grad.norm()))
        p.grad = g
    held["grad_rel"] = rel
    stride = [max(1, p.numel() // DDP_UPD_SAMPLE) for p in leaves]
    held["sample"] = [(p.detach().view(-1)[::k].double(),
                       p.grad.view(-1)[::k].double())
                      for p, k in zip(leaves, stride)]
    held["stride"] = stride
    torch.cuda.synchronize()


def ddp_hold_update(leaves, held):
    """After the first DDP update (a post-hook): the sampled elements
    against Adam's first step on the averaged gradients, in float64
    (bias-corrected, it moves p by lr g / (|g| + eps))."""
    if "sample" not in held:
        return
    err, ok = 0.0, True
    for p, k, (before, g) in zip(leaves, held.pop("stride"),
                                 held.pop("sample")):
        want = before - DDP_LR * g / (g.abs() + 1e-8)   # Adam's eps
        d = (p.detach().view(-1)[::k].double() - want).abs()
        err = max(err, float(d.max()))
        ok = ok and bool((d <= 2.0 ** -23 * want.abs() + 1e-9).all())
    held["upd_err"], held["upd_ok"] = err, ok


def ddp_phase():
    """14d: Llama-3-8B width, 4 of 32 layers, f32 parameters, bf16
    activations, a dp = 2 RankMesh, one 2048-token sequence a rank, Adam
    lr 1e-4, the reference's 25 MiB buckets (``grad_buckets``): each
    bucket's ring all-reduce on the fp32 and bf16 wires bitwise the same
    through the plain kernels on the same rows, the copies and the ring
    timed; 4 steps on the fp32 wire and 2 on the bf16 wire, the first loss
    within 1e-2 of the full-batch loss, falling; the first step's
    averaged gradients against the full batch's and its update against
    Adam's (optimizer hooks). Returns the path's launch counts (B1, B2
    and the attention kernels)."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama, LlamaConfig
    from accl_tpu_torch.parallel import (RankCollectives, make_ddp_train_step,
                                         make_mesh, plan_from_buckets)
    from accl_tpu_torch.parallel.bucketing import (_flatten_bucket,
                                                   _scatter_bucket,
                                                   tree_flatten)
    from accl_tpu_torch.parallel.collectives import PLAIN
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=DDP_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(SEED + 142)
    model = Llama(cfg).init(g)
    tokens = torch.randint(0, cfg.vocab_size, (DDP_DP, DDP_S),
                           device="cuda", generator=g)
    params = dict(model.named_parameters())
    leaves = tree_flatten(params)[0]
    plan = plan_from_buckets(params, model.grad_buckets(DDP_BUCKET))
    mesh = make_mesh((DDP_DP,), ("dp",))
    coll = RankCollectives(mesh.group("dp"))
    plain = RankCollectives(mesh.group("dp"), PLAIN)
    N = model.param_count()
    big = max(b.nbytes for b in plan.buckets)
    print(f"14d DDP: Llama-3-8B width, {DDP_LAYERS} of 32 layers (the cut: "
          f"depth only), f32 parameters, bf16 activations, dp {DDP_DP}, "
          f"tokens ({DDP_DP}, {DDP_S}), Adam lr 1e-4; {N} parameters. "
          f"Memory reckoning: parameters {4 * N / 1e9:.1f} GB, with Adam's "
          f"moments {12 * N / 1e9:.1f} GB; {DDP_DP} gradient rows "
          f"{DDP_DP * 4 * N / 1e9:.1f} GB; the largest bucket "
          f"({big / 1e9:.2f} GB) in and out on {DDP_DP} ranks "
          f"{2 * DDP_DP * big / 1e9:.1f} GB; plus activations, about "
          f"{(12 + 4 * DDP_DP) * N / 1e9 + 2 * DDP_DP * big / 1e9 + 5:.0f} "
          f"GB of 80")
    print(f"14d buckets ({DDP_BUCKET >> 20} MiB, the reference's grouping): "
          f"{len(plan.buckets)}, bytes "
          f"{[b.nbytes for b in plan.buckets]}")
    with torch.no_grad():
        full_loss = float(model.loss(tokens))
    model.requires_grad_(True)
    # the reduced buckets against the plain kernels, on the same rows
    timing = collections.defaultdict(float)
    for wire in (None, torch.bfloat16):
        rows = ddp_grad_rows(model, leaves, tokens)
        for b in plan.buckets:
            fused = _flatten_bucket(b, rows)
            got = coll.allreduce(fused, algorithm="ring", wire_dtype=wire)
            want = plain.allreduce(fused, algorithm="ring", wire_dtype=wire)
            torch.cuda.synchronize()
            check_rows(list(got), list(want),
                       f"14d bucket of {b.nbytes} B, wire "
                       f"{dtype_label(wire)}")
            del want
            name = dtype_label(wire)
            timing[f"ring {name}"] += time_ms(
                lambda: coll.allreduce(fused, algorithm="ring",
                                       wire_dtype=wire), reps=3, warmup=1)
            if wire is None:
                timing["flatten"] += time_ms(
                    lambda: _flatten_bucket(b, rows), reps=3, warmup=1)
                timing["average"] += time_ms(lambda: got.div_(DDP_DP),
                                             reps=3, warmup=1)
                timing["scatter"] += time_ms(
                    lambda: _scatter_bucket(b, got, rows), reps=3, warmup=1)
            del fused, got
        del rows
    gc.collect()
    torch.cuda.empty_cache()
    print(f"14d every bucket's ring all-reduce bitwise the plain kernels' "
          f"on the same rows, fp32 and bf16 wires; device ms a step (CUDA "
          f"events behind a GPU sleep, summed over the buckets): "
          + ", ".join(f"{k} {v:.3f}" for k, v in timing.items())
          + f"; copies around the fp32 ring "
          f"{timing['flatten'] + timing['average'] + timing['scatter']:.3f}"
          f" ms ({CARD})")
    for k in counters().values():
        k.launches = 0
    zero_attention_counters()
    opt = torch.optim.Adam(model.parameters(), lr=DDP_LR)
    held = {}
    hooks = [opt.register_step_pre_hook(
                 lambda *_: ddp_hold_grads(model, leaves, tokens, held)),
             opt.register_step_post_hook(
                 lambda *_: ddp_hold_update(leaves, held))]
    losses, times = [], []
    for wire, steps in ((None, DDP_STEPS), (torch.bfloat16, DDP_BF16_STEPS)):
        step = make_ddp_train_step(model.loss, opt, params, mesh, plan=plan,
                                   wire_dtype=wire, algorithm="ring")
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(tokens)))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            print(f"14d step {len(losses) - 1} (wire "
                  f"{dtype_label(wire)}): loss {losses[-1]:.6f}, "
                  f"{times[-1]:.1f} ms (host clock"
                  + (", with the gradient check's full-batch backward"
                     if len(losses) == 1 else "") + "), "
                  f"{DDP_DP * DDP_S / times[-1] * 1e3:.0f} tokens/s, "
                  f"{len(plan.buckets)} buckets of {plan.total_bytes} B, "
                  f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
                  f"GiB")
    for h in hooks:
        h.remove()
    launches = {k: v - held["check_launches"][k]
                for k, v in attention_counters().items()}
    launches.update({k: f.launches for k, f in counters().items()})
    print(f"14d launches (path ddp; the gradient check's full-batch pass "
          f"excluded): {launches}")
    names = sorted(params)
    rel_g = held["grad_rel"]
    worst = max(range(len(names)), key=rel_g.__getitem__)
    print(f"14d step 0 (fp32 wire), before its update: every leaf's "
          f"averaged gradient against the full batch's backward "
          f"(model.loss on tokens ({DDP_DP}, {DDP_S})), relative L2: worst "
          f"{rel_g[worst]:.3e} ({names[worst]}), median "
          f"{statistics.median(rel_g):.3e}, bound {DDP_GRAD_REL}; after "
          f"it, {DDP_UPD_SAMPLE} strided elements a leaf against Adam's "
          f"first step on those gradients (p - lr g / (|g| + eps), float64)"
          f": max abs err {held['upd_err']:.3e}, bound 2^-23 |p| + 1e-9")
    need(all(r <= DDP_GRAD_REL for r in rel_g),
         f"14d: the averaged gradient of {names[worst]} is "
         f"{rel_g[worst]} from the full batch's (> {DDP_GRAD_REL})")
    need(held["upd_ok"], f"14d: the first update is not Adam's step on the "
         f"averaged gradients (max abs err {held['upd_err']})")
    need(all(np.isfinite(x) for x in losses), "14d: non-finite loss")
    rel = abs(losses[0] - full_loss) / abs(full_loss)
    need(rel <= DDP_LOSS_REL, f"14d: step-0 loss {losses[0]} vs the "
         f"full-batch loss {full_loss}: rel {rel}")
    need(losses[-1] < losses[0], "14d: the loss did not fall")
    per_run = DDP_LAYERS * DDP_DP * (DDP_STEPS + DDP_BF16_STEPS)
    for key in ("attn_fwd", "attn_bwd_dkv", "attn_bwd_dq"):
        need(launches[key] == per_run, f"14d: {key} launched "
             f"{launches[key]} times, not {per_run}")
    need(launches["combine"] > 0 and launches["cast"] > 0,
         f"14d: B1 or B2 never launched ({launches})")
    need_routes(launches, True, "14d DDP")
    step_ms = statistics.median(times[1:DDP_STEPS])
    print(f"14d DDP losses {losses}; the full-batch loss "
          f"(model.loss, what make_train_step computes) {full_loss:.6f}, "
          f"step 0 rel {rel:.2e} <= {DDP_LOSS_REL}; fp32-wire step "
          f"{step_ms:.1f} ms (median of steps 1-{DDP_STEPS - 1}), "
          f"{DDP_DP * DDP_S / step_ms * 1e3:.0f} tokens/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({CARD})")
    del opt, step, model, params, leaves, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- phase 15: the Mixtral-style MoE Llama, expert parallelism, the pipeline --

MOE_SERVE_LAYERS = 16      # 15a: 16 of 32 layers, bf16: 46.4 GB of layers
MOE_SERVE_B, MOE_SERVE_S, MOE_SERVE_NEW = 4, 1024, 32
MOE_TRAIN_LAYERS = 2       # 15b: 2 of 32, f32 parameters: 50.6 GB with Adam
MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 2, 2048, 3
MOE_TRAIN_SEED = SEED + 151
# 15b: step 0's gradients. Both bf16 routes carry bf16 activations through
# the backward and round differently (the flash route rounds P before P V,
# the dense route its normalised probabilities), each a few 1e-2 from f32
# and about as far as the other: so every leaf's gradient of the kernel
# route is held within MOE_GRAD_RATIO times the bf16 plain route's
# relative L2 distance from the f32 plain route (attention="dense", f32
# activations), both plain passes replaying the kernel pass's expert
# choices (tests/test_torch_llama_moe.py::
# test_bf16_route_gradients_within_the_chip_bound holds the same rule)
MOE_GRAD_RATIO = 1.5
# 15a: tokens whose route or drop differs between the kernel route and the
# plain route. bf16 attention moves the normed input of every router by
# its rounding, which flips ~1 % of a layer's near-tie choices
# (MOE_FLIP_FIRST bounds the first layer's share on passes of at least
# MOE_FLIP_TOKENS tokens); a flipped token's hidden state then differs by
# O(1), and through attention so do later layers' inputs, so the share
# that differs in some layer cascades with depth (54 % over 16 layers of
# random weights on an H100): MOE_FLIP_MAX is a sanity bound on it. The
# other tokens' logits are held to SERVE_DENSE_REL, phase 7's bf16 limit.
MOE_FLIP_FIRST = 2.0 ** -5
MOE_FLIP_TOKENS = 1024
MOE_FLIP_MAX = 0.75
MOE_EP, MOE_EP_T = 8, 2048  # 15c: ep ranks (one expert a rank), tokens a rank
# 15c: ep against per-rank dense with the same capacity, relative L2 (bf16
# expert GEMMs of other shapes: cuBLAS may sum in another order)
MOE_EP_REL = 2.0 ** -7
MOE_PP, MOE_PP_MICRO, MOE_PP_MB = 4, 8, 512    # 15d
MOE_RANGE = "moe_family:"  # profiler ranges of the MoE families (15a)


def mixtral_8x7b(n_layers: int, **kw):
    """Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1
    config.json: vocab 32000, dim 4096, 32 heads, 8 KV heads, ffn 14336,
    8 experts, top 2, rope_theta 1e6, rms_norm_eps 1e-5) in LlamaConfig's
    fields, routed as the reference routes: capacity factor 1.25, tokens
    past it dropped, Switch aux coefficient 0.01."""
    import dataclasses
    from accl_tpu_torch.models import LlamaConfig
    return dataclasses.replace(
        LlamaConfig.llama3_8b(), vocab_size=32000, n_layers=n_layers,
        max_seq_len=32768, rope_theta=1e6, norm_eps=1e-5, n_experts=8,
        moe_top_k=2, moe_capacity_factor=1.25, moe_aux_coef=0.01, **kw)


def mixtral_layer_config(**kw):
    from accl_tpu_torch.models import MoEConfig
    return MoEConfig(dim=4096, ffn_dim=14336, n_experts=8, top_k=2,
                     capacity_factor=1.25, **kw)


@contextlib.contextmanager
def moe_hooks(record=None, replay=None, annotate=False, capture=None):
    """Wrap ``accl_tpu_torch.models.moe``'s functions, which the Llama and
    the layer look up at each call: ``record`` (a list) receives each
    routing's (idx, keep); ``replay`` (a list of idx from an earlier pass)
    makes each top-k choice the recorded one, and the yielded dict counts
    the rows whose own choice differed; ``annotate`` opens a profiler range
    per family (route: routing, dispatch, combine; expert_gemm: the expert
    SwiGLU); ``capture`` (a dict) keeps the first call's arguments of each
    function."""
    from accl_tpu_torch.models import moe as M
    import torch
    names = ("route", "dispatch", "combine", "expert_ffn", "_top_k")
    saved = {n: getattr(M, n) for n in names}
    fams = {"route": "route", "dispatch": "route", "combine": "route",
            "expert_ffn": "expert_gemm"}
    stats = {"calls": 0, "rows": 0, "differ": 0}

    def wrap(name):
        def call(*args, **kw):
            if capture is not None and name not in capture:
                capture[name] = args
            if annotate:
                with torch.profiler.record_function(MOE_RANGE + fams[name]):
                    out = saved[name](*args, **kw)
            else:
                out = saved[name](*args, **kw)
            if name == "route" and record is not None:
                record.append((out.idx, out.keep))
            return out
        return call

    def top_k(probs, k):
        own = saved["_top_k"](probs, k)
        if replay is None:
            return own
        want = replay[stats["calls"]]
        stats["calls"] += 1
        stats["rows"] += own[..., 0].numel()
        stats["differ"] += int((own.sort(-1)[0] != want.sort(-1)[0])
                               .any(-1).sum())
        return want

    for name in names[:4]:
        setattr(M, name, wrap(name))
    M._top_k = top_k
    try:
        yield stats
    finally:
        for name, fn in saved.items():
            setattr(M, name, fn)


def routes_differ(a, b, per_layer: bool = False):
    """(groups, tokens) bool: the tokens whose chosen experts or kept flags
    differ in any layer between two passes' routing records; with
    ``per_layer``, (layers, groups, tokens), one plane a layer."""
    import torch
    d = torch.stack([(ia.sort(-1)[0] != ib.sort(-1)[0]).any(-1)
                     | (ka != kb).any(-1)
                     for (ia, ka), (ib, kb) in zip(a, b, strict=True)])
    return d if per_layer else d.any(0)


def hold_routes(what: str, got, want, rec_got, rec_want,
                limit: float = SERVE_DENSE_REL) -> float:
    """Logits (B, S, V) of two routes with their routing records: the share
    of tokens routed or dropped otherwise (bounded by MOE_FLIP_MAX), and
    the other tokens' logits within ``limit`` relative L2."""
    import torch
    need(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    layers = routes_differ(rec_got, rec_want, per_layer=True)
    differ = layers.any(0)
    share = float(differ.float().mean())
    first = float(layers[0].float().mean())
    print(f"{what}: tokens routed or dropped otherwise, share a layer "
          + " ".join(f"{float(x):.4f}" for x in layers.float().mean((1, 2)))
          + "; share first differing at each layer "
          + " ".join(f"{float(x):.4f}" for x in (
              layers.int().cumsum(0).clamp(max=1).diff(
                  dim=0, prepend=torch.zeros_like(layers[:1].int()))
              .float().mean((1, 2)))))
    same = ~differ
    rel = rel_l2(got[same], want[same]) if bool(same.any()) else 0.0
    rel_all = rel_l2(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"{what}: {int(differ.sum())} of {differ.numel()} tokens routed "
          f"or dropped otherwise in some layer (share {share:.4%}, bound "
          f"{MOE_FLIP_MAX:.0%}; in the first layer {first:.4%}"
          + (f", bound {MOE_FLIP_FIRST:.4%}" if differ.numel()
             >= MOE_FLIP_TOKENS else f", not bounded under "
             f"{MOE_FLIP_TOKENS} tokens")
          + f"); the other tokens' logits relative L2 {rel:.4g} (limit "
          f"{limit}), all tokens {rel_all:.4g}; greedy "
          f"agreement {agree:.4f}")
    if differ.numel() >= MOE_FLIP_TOKENS:
        need(first <= MOE_FLIP_FIRST, f"{what}: {first:.4%} of tokens "
             f"routed otherwise in the first layer (bound "
             f"{MOE_FLIP_FIRST:.4%})")
    need(share <= MOE_FLIP_MAX, f"{what}: {share:.4%} of tokens routed "
         f"otherwise (bound {MOE_FLIP_MAX:.0%})")
    need(rel <= limit, f"{what}: the same-route tokens' logits differ by "
         f"{rel} relative L2 (limit {limit})")
    return share


def moe_family_ms(fn) -> dict:
    """Device ms by kernel family of ``fn`` (``device_ms_by_family``), with
    the kernels launched inside ``moe_hooks(annotate=True)``'s ranges
    counted as their range's family (``route``, ``expert_gemm``): each
    kernel's launch (the CUDA runtime or driver call) found on the host
    by its correlation id."""
    import torch
    from torch.autograd.profiler_util import _filter_name
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with moe_hooks(annotate=True), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    spans, launch_at = [], {}
    for ev in evs:
        if ev.device_type() == cuda:
            continue
        if ev.name().startswith(MOE_RANGE):
            t0 = ev.start_ns()
            spans.append((t0, t0 + ev.duration_ns(),
                          ev.name()[len(MOE_RANGE):]))
        elif ev.name().startswith("cu") and ev.correlation_id():
            launch_at[ev.correlation_id()] = ev.start_ns()   # a launch
    fams = collections.defaultdict(float)
    for ev in evs:
        if (ev.device_type() != cuda or ev.is_user_annotation()
                or _filter_name(ev.name())
                or getattr(ev, "is_hidden_event", lambda: False)()):
            continue
        t = launch_at.get(ev.correlation_id())
        fam = None if t is None else next(
            (f for a, b, f in spans if a <= t <= b), None)
        fam = fam or next((f for f, key in FAMILIES if key in ev.name()),
                          "other")
        fams[fam] += ev.duration_ns() / 1e6
    return dict(fams)


def print_families(what: str, fams: dict, window_ms: float):
    if not fams:
        print(f"{what}: busy share not measured (the profiler saw no device "
              f"activity)")
        return
    busy = sum(fams.values())
    print(f"{what}: {busy:.2f} ms of kernels in a {window_ms:.2f} ms "
          f"host-clock window, busy share {busy / window_ms:.3f}; "
          + ", ".join(f"{f} {ms:.2f} ms" for f, ms in
                      sorted(fams.items(), key=lambda x: -x[1]))
          + ("" if "expert_gemm" in fams else
             " (the expert GEMMs were not told apart: they count as gemm)"))


def moe_piece_times(cap: dict, n_layers: int, what: str):
    """One layer's MoE pieces at the path's shapes (the first call's
    arguments), CUDA events behind a GPU sleep: the routing, dispatch,
    expert SwiGLU (beside its bound) and combine."""
    from accl_tpu_torch.models import moe as M
    cfg, router, x, C = cap["route"]
    r = M.route(cfg, router, x, C)
    t = M.dispatch(r, cap["dispatch"][1])
    params = cap["expert_ffn"][1]
    y = M.expert_ffn(cfg, params, t)
    n_tok = cap["combine"][2]
    ms = {"route": time_ms(lambda: M.route(cfg, router, x, C), reps=5),
          "dispatch": time_ms(lambda: M.dispatch(r, cap["dispatch"][1]),
                              reps=5),
          "expert_gemm": time_ms(lambda: M.expert_ffn(cfg, params, t),
                                 reps=5),
          "combine": time_ms(lambda: M.combine(r, y, n_tok), reps=5)}
    E, slots, d = t.shape[-3:]
    f = params["w_gate"].shape[-1]
    esize = t.element_size()
    nbytes = 3 * E * d * f * params["w_gate"].element_size() \
        + 2 * E * slots * d * esize
    b_ms, by = bound_ms(nbytes, 6 * E * slots * d * f, BF16_OPS_PER_S)
    print(f"{what} one layer's MoE pieces (CUDA events, median of 5, "
          f"routing of {tuple(x.shape[:2])} tokens, capacity {C}, slots "
          f"(E, G*C) = ({E}, {slots})): route {ms['route']:.4f} ms, "
          f"dispatch {ms['dispatch']:.4f}, expert SwiGLU (3 batched "
          f"GEMMs) {ms['expert_gemm']:.4f} (bound {b_ms:.4f} ms by {by}, "
          f"{b_ms / ms['expert_gemm']:.1%}), combine {ms['combine']:.4f}; "
          f"x {n_layers} layers: route family "
          f"{(ms['route'] + ms['dispatch'] + ms['combine']) * n_layers:.2f}"
          f" ms, expert_gemm {ms['expert_gemm'] * n_layers:.2f} ms")
    return ms


def moe_serving_phase() -> dict:
    """15a: the MoE Llama at Mixtral-8x7B's widths, 16 of 32 layers, bf16:
    ``generate(max_new=32)`` for four 1024-token prompts, a 4 x 1024
    ``forward`` (B8) and a 4 x 512 ``forward`` (B9); against the plain
    route (attention="dense", the same weights) with the routes that
    differ counted and bounded; timed, profiled. Returns the path's
    launch counts."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama
    cfg = mixtral_8x7b(MOE_SERVE_LAYERS, param_dtype=torch.bfloat16)
    B, S, NEW = MOE_SERVE_B, MOE_SERVE_S, MOE_SERVE_NEW
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    g = torch.Generator(device="cuda").manual_seed(SEED + 150)
    t0 = time.perf_counter()
    model = Llama(cfg).init(g)
    torch.cuda.synchronize()
    N = model.param_count()
    emb = 2 * cfg.vocab_size * cfg.dim
    per_layer = (N - emb - cfg.dim) // cfg.n_layers
    print(f"15a MoE serving: Mixtral-8x7B widths, {cfg.n_layers} of 32 "
          f"layers (the cut: depth only), bf16, {N} parameters "
          f"({per_layer} a layer, embedding and lm_head {emb}), "
          f"{2 * N / 1e9:.2f} GB; 32 layers would need "
          f"{2 * (32 * per_layer + emb) / 1e9:.1f} GB; init "
          f"{time.perf_counter() - t0:.1f} s; TF32 for f32 matmuls "
          f"{torch.backends.cuda.matmul.allow_tf32} (precision "
          f"{torch.get_float32_matmul_precision()})")
    prompts = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                            generator=g)
    short = prompts[:, :SERVE_B9_LEN]
    dense_cfg = dataclasses.replace(cfg, attention="dense")
    L = cfg.n_layers

    def dense(fn):
        model.config = dense_cfg
        try:
            return fn()
        finally:
            model.config = cfg

    with torch.no_grad():
        # the serving path once, counted: generate, a 4 x 1024 forward (B8)
        # and a 4 x 512 forward (B9), their routings recorded
        zero_attention_counters()
        before = {k: f.launches for k, f in counters().items()}
        rec_fwd, rec_short = [], []
        out = model.generate(prompts, max_new=NEW)
        with moe_hooks(record=rec_fwd):
            full = model(prompts)
        with moe_hooks(record=rec_short):
            full_short = model(short)
        torch.cuda.synchronize()
        launches = attention_counters()
        launches.update({k: f.launches - before[k]
                         for k, f in counters().items()})
        print(f"15a launches (path moe_serving): {launches}")
        need(out.shape == (B, NEW) and bool(((out >= 0)
                                              & (out < cfg.vocab_size)).all()),
             f"15a generate: shape {tuple(out.shape)} or a token outside "
             f"the vocabulary")
        need(launches["attn_fwd"] == L and launches["attn_fwd_single"] == L,
             f"15a: B8 {launches['attn_fwd']}, B9 "
             f"{launches['attn_fwd_single']} launches, not {L} each")
        need(launches["attn_prefill"] == L
             and launches["attn_decode"] == L * (NEW - 1),
             f"15a: B12 prefill {launches['attn_prefill']}, decode "
             f"{launches['attn_decode']}, not {L} and {L * (NEW - 1)}")
        need_routes(launches, True, "15a")
        # against the plain route, and prefill against forward
        rec_dense = []
        with moe_hooks(record=rec_dense):
            dfull = dense(lambda: model(prompts))
        hold_routes(f"15a forward {B}x{S} (B8) vs plain route", full, dfull,
                    rec_fwd, rec_dense)
        del dfull
        rec_dense = []
        with moe_hooks(record=rec_dense):
            dshort = dense(lambda: model(short))
        hold_routes(f"15a forward {B}x{SERVE_B9_LEN} (B9) vs plain route",
                    full_short, dshort, rec_short, rec_dense)
        del dshort, full_short
        rec_pre, rec_dpre, rec_step, rec_dstep = [], [], [], []
        cache = model.init_kv_cache(B, S + NEW)
        with moe_hooks(record=rec_pre):
            cached, _ = model.forward_cached(prompts, cache)
        hold_routes(f"15a prefill {B}x{S} (B12) vs forward (B8)", cached,
                    full, rec_pre, rec_fwd)
        del full
        dcache = model.init_kv_cache(B, S + NEW)
        with moe_hooks(record=rec_dpre):
            dcached = dense(lambda: model.forward_cached(prompts, dcache)[0])
        hold_routes(f"15a prefill {B}x{S} (B12) vs plain route", cached,
                    dcached, rec_pre, rec_dpre)
        del dcached
        tok = cached[:, -1].argmax(-1)[:, None]
        del cached
        # the decode step on both routes from the kernel route's cache
        dcache = {"k": cache["k"].clone(), "v": cache["v"].clone(),
                  "pos": cache["pos"]}
        with moe_hooks(record=rec_step):
            step = model.forward_cached(tok, cache)[0]
        with moe_hooks(record=rec_dstep):
            dstep = dense(lambda: model.forward_cached(tok, dcache)[0])
        hold_routes(f"15a decode step at {S} (B12 split-KV) vs plain route "
                    f"on the same cache", step, dstep, rec_step, rec_dstep)
        need(all(bool((k.sum(-1) == cfg.moe_top_k).all())
                 for _, k in rec_step),
             "15a decode: a decode step dropped a token (capacity 1)")
        del step, dstep, cache, dcache
        torch.cuda.empty_cache()

        def prefill():
            c = model.init_kv_cache(B, S + NEW)
            return model.forward_cached(prompts, c)

        def decode_steps(state, n):
            logits, c = state
            ts = []
            for _ in range(n):
                t1 = time.perf_counter()
                nxt = logits[:, -1].argmax(-1)
                logits, c = model.forward_cached(nxt[:, None], c)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t1) * 1e3)
            return ts

        fwd_ms = host_ms(lambda: model(prompts))
        short_ms = host_ms(lambda: model(short))
        pre_ms = host_ms(prefill)
        dec_ms = statistics.median(decode_steps(prefill(), 16))
        expert_bytes = 3 * cfg.n_experts * cfg.dim * cfg.ffn_dim * 2 * L
        print(f"15a forward {B}x{S} (B8): {fwd_ms:.2f} ms, "
              f"{B * S / fwd_ms * 1e3:.0f} tokens/s; forward "
              f"{B}x{SERVE_B9_LEN} (B9): {short_ms:.2f} ms, "
              f"{B * SERVE_B9_LEN / short_ms * 1e3:.0f} tokens/s; prefill: "
              f"{pre_ms:.2f} ms, {B * S / pre_ms * 1e3:.0f} tokens/s (host "
              f"clock, median of 3); decode: {dec_ms:.3f} ms a step of {B} "
              f"tokens (median of 16 at {S}..{S + 15}; every step reads all "
              f"{cfg.n_experts} experts' {expert_bytes / 1e9:.1f} GB: "
              f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s) "
              f"({CARD})")
        state = prefill()
        for what, fn, window in (
                (f"forward {B}x{S}", lambda: model(prompts), fwd_ms),
                ("prefill", prefill, pre_ms),
                ("decode x8", lambda: decode_steps(state, 8), 8 * dec_ms)):
            print_families(f"15a {what}", moe_family_ms(fn), window)
        del state
        cap = {}
        with moe_hooks(capture=cap):
            prefill()
        moe_piece_times(cap, L, f"15a prefill {B}x{S}:")
        del cap
    peak = torch.cuda.max_memory_allocated()
    print(f"15a peak memory {peak / 2 ** 30:.2f} GiB (the "
          f"{held / 2 ** 30:.2f} GiB held before the phase included)")
    phase("phase 16d: sequence parallelism with experts")
    sp_launches = sp_moe_phase(model, prompts)
    del model, prompts, short, out
    gc.collect()
    torch.cuda.empty_cache()
    return {"moe_serving": launches, "sp_moe": sp_launches}


def moe_training_phase() -> dict:
    """15b: the MoE Llama at Mixtral-8x7B's widths, 2 of 32 layers, f32
    parameters and bf16 activations, batch (2, 2048), Adam lr 1e-4: step
    0's gradients of the kernel route, the bf16 plain route and the f32
    plain route (the plain passes replaying the kernel pass's expert
    choices, so that all three weigh the same tokens; MOE_GRAD_RATIO),
    then 3 steps. Returns the steps' launch counts."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama
    cfg = mixtral_8x7b(MOE_TRAIN_LAYERS)
    L, Bt, St = cfg.n_layers, MOE_TRAIN_B, MOE_TRAIN_S
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    g = torch.Generator(device="cuda").manual_seed(MOE_TRAIN_SEED)
    model = Llama(cfg).init(g)
    tokens = torch.randint(0, cfg.vocab_size, (Bt, St), device="cuda",
                           generator=g)
    N = model.param_count()
    n_exp = L * 3 * cfg.n_experts * cfg.dim * cfg.ffn_dim
    print(f"15b MoE training: Mixtral-8x7B widths, {L} of 32 layers (the "
          f"cut: depth only), f32 parameters, bf16 activations, tokens "
          f"({Bt}, {St}), capacity {model.layers[0].moe.config.capacity(St)}"
          f" a sequence, Adam lr 1e-4; {N} parameters. Memory reckoning: "
          f"weights, gradients and Adam's moments 16 B x N = "
          f"{16 * N / 1e9:.1f} GB; the bf16 expert casts saved for "
          f"backward {2 * n_exp / 1e9:.1f} GB; 3 layers would need "
          f"{16 * (N + (N - 2 * cfg.vocab_size * cfg.dim) // L) / 1e9:.1f} "
          f"GB before activations")
    model.requires_grad_(True)
    rec, losses0, stats = [], {}, {}

    def grads(route: str, **change):
        """One loss backward on the route (the kernel route records its
        expert choices, the plain routes replay them); its gradients."""
        model.config = dataclasses.replace(cfg, **change)
        try:
            with moe_hooks(record=None if change else rec,
                           replay=[i for i, _ in rec] if change else None
                           ) as st:
                loss = model.loss(tokens)
                loss.backward()
        finally:
            model.config = cfg
        losses0[route], stats[route] = float(loss.detach()), dict(st)
        out = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return out

    kernel = grads("kernel")
    f32 = grads("f32 plain", attention="dense", dtype=torch.float32)
    far_k = {n: rel_l2(g, f32[n]) for n, g in kernel.items()}
    plain = grads("bf16 plain", attention="dense")
    far_p = {n: rel_l2(g, f32[n]) for n, g in plain.items()}
    k_vs_p = {n: rel_l2(g, plain[n]) for n, g in kernel.items()}
    del kernel, f32, plain, rec
    ratio = {n: far_k[n] / far_p[n] for n in far_k}
    worst = max(ratio, key=ratio.get)
    far = max(far_k, key=far_k.get)
    print(f"15b step 0, before any update: losses {losses0}; expert "
          f"choices of the plain passes replayed from the kernel pass (their "
          f"own would differ in " + ", ".join(
              f"{r}: {st['differ']} of {st['rows']}" for r, st in
              stats.items() if st["rows"]) + " token-layers); every leaf's "
          f"gradient, relative L2 from the f32 plain route's: kernel route "
          f"worst {far_k[far]:.3e} ({far}; bf16 plain route {far_p[far]:.3e})"
          f", median {statistics.median(far_k.values()):.3e} (bf16 plain "
          f"{statistics.median(far_p.values()):.3e}); ratio kernel / bf16 "
          f"plain worst {ratio[worst]:.3f} ({worst}), bound "
          f"{MOE_GRAD_RATIO}; kernel vs bf16 plain route worst "
          f"{max(k_vs_p.values()):.3e}, median "
          f"{statistics.median(k_vs_p.values()):.3e}")
    need(ratio[worst] <= MOE_GRAD_RATIO,
         f"15b: the gradient of {worst} is {far_k[worst]} from the f32 "
         f"route's, {ratio[worst]:.3f} times the bf16 plain route's "
         f"(> {MOE_GRAD_RATIO})")
    gc.collect()
    torch.cuda.empty_cache()
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = model.make_train_step(opt)
    zero_attention_counters()
    before = {k: f.launches for k, f in counters().items()}
    losses, times = [], []
    for _ in range(MOE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(tokens)))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = attention_counters()
    launches.update({k: f.launches - before[k]
                     for k, f in counters().items()})
    peak = torch.cuda.max_memory_allocated()
    print(f"15b launches (path moe_training): {launches}")
    need(all(np.isfinite(x) for x in losses), "15b: non-finite loss")
    need(losses[-1] < losses[0], f"15b: the loss did not fall ({losses})")
    for key in ("attn_fwd", "attn_bwd_dkv", "attn_bwd_dq"):
        need(launches[key] == L * MOE_TRAIN_STEPS,
             f"15b: {key} launched {launches[key]} times, not once a layer "
             f"a step ({L * MOE_TRAIN_STEPS})")
    need_routes(launches, True, "15b")
    step_ms = statistics.median(times[1:])
    fams = moe_family_ms(lambda: step(tokens))
    print(f"15b losses {losses}; step ms (host clock) {times}; step "
          f"{step_ms:.1f} ms (median of steps 1-{MOE_TRAIN_STEPS - 1}), "
          f"{Bt * St / step_ms * 1e3:.0f} tokens/s; peak "
          f"{peak / 2 ** 30:.2f} GiB (the {held / 2 ** 30:.2f} GiB held "
          f"before the phase included) ({CARD})")
    print_families("15b one more step", fams, step_ms)
    del opt, step, model, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_ep_phase():
    """15c: one Mixtral-width MoELayer (f32 parameters, bf16 compute) over
    ep = 8 virtual ranks, one expert a rank, 2048 tokens a rank: against
    the per-rank dense layer with the same capacity; each alltoall's
    rows bitwise the plain exchange (a transpose of the rank blocks); the
    two alltoalls' device ms beside the expert GEMMs'."""
    import torch
    from accl_tpu_torch.models import MoELayer
    from accl_tpu_torch.models import moe as M
    from accl_tpu_torch.parallel import RankCollectives, make_mesh
    cfg = mixtral_layer_config(dtype=torch.bfloat16)
    W, T, d = MOE_EP, MOE_EP_T, cfg.dim
    g = torch.Generator(device="cuda").manual_seed(SEED + 152)
    layer = MoELayer(cfg).init(g)
    x = torch.randn(W * T, d, device="cuda", generator=g).to(torch.bfloat16)
    C = cfg.capacity(T)
    coll = RankCollectives(make_mesh((W,), ("ep",)).group("ep"))
    seen = []
    orig = coll.alltoall

    def kept(rows, *a, **kw):
        got = orig(rows, *a, **kw)
        seen.append((rows.clone(), got.clone()))
        return got

    coll.alltoall = kept
    rec_ep, rec_dense, cap = [], [], {}
    with torch.no_grad():
        with moe_hooks(record=rec_ep, capture=cap):
            out, aux = layer.apply_ep(x.view(W, T, d), coll, C)
        coll.alltoall = orig
        parts = []
        with moe_hooks(record=rec_dense):
            for r in range(W):
                parts.append(layer.apply_dense(x[r * T:(r + 1) * T], C))
        torch.cuda.synchronize()
    dense = torch.cat([o for o, _ in parts])
    daux = torch.stack([a for _, a in parts])
    need(len(seen) == 2, f"15c: {len(seen)} alltoalls, not 2")
    for i, (rows, got) in enumerate(seen):
        want = rows.view(W, W, -1).transpose(0, 1).reshape(W, -1)
        ok, err = same_bits(got, want)
        need(ok, f"15c alltoall {i}: rows differ from the plain exchange "
                 f"(max abs err {err})")
    idx_ep, keep_ep = rec_ep[0]
    differ = routes_differ([(idx_ep, keep_ep)], [(
        torch.cat([i for i, _ in rec_dense]),
        torch.cat([k for _, k in rec_dense]))])
    rel = rel_l2(out.reshape(W * T, d), dense)
    aux_rel = float(((aux - daux).abs() / daux.abs()).max())
    print(f"15c ep = {W}, one expert a rank, {T} tokens a rank, capacity "
          f"{C}: two alltoalls of {tuple(seen[0][0].shape)} bf16 rows, "
          f"each bitwise the plain exchange; {coll.wire_bytes} bytes left "
          f"their ranks; against the per-rank dense layer: {int(differ.sum())}"
          f" of {differ.numel()} tokens routed otherwise, relative L2 "
          f"{rel:.4g} (limit {MOE_EP_REL}), aux max rel diff {aux_rel:.3g}")
    need(rel <= MOE_EP_REL, f"15c: ep and dense differ by {rel}")
    need(aux_rel <= 1e-5, f"15c: the aux differs by {aux_rel}")
    local = {k: layer.weights()[k].view(W, 1, *layer.weights()[k].shape[1:])
             for k in ("w_gate", "w_up", "w_down")}
    t = cap["expert_ffn"][2]
    with torch.no_grad():
        a2a = [time_ms(lambda rows=rows: orig(rows), reps=5)
               for rows, _ in seen]
        gemm = time_ms(lambda: M.expert_ffn(cfg, local, t), reps=5)
        ep_ms = time_ms(lambda: layer.apply_ep(x.view(W, T, d), coll, C),
                        reps=3, warmup=1)
        dense_ms = time_ms(lambda: [layer.apply_dense(
            x[r * T:(r + 1) * T], C) for r in range(W)], reps=3, warmup=1)
    nb = seen[0][0].numel() * seen[0][0].element_size()
    print(f"15c device ms (CUDA events behind a GPU sleep): alltoall "
          f"dispatch {a2a[0]:.4f}, combine {a2a[1]:.4f} ({nb} bytes each, "
          f"{2 * nb / a2a[0] / 1e6:.0f} GB/s read + write); expert GEMMs "
          f"(3 batched, (W, 1, {W * C}, {d}) x (W, 1, {d}, {cfg.ffn_dim})) "
          f"{gemm:.4f}; apply_ep {ep_ms:.3f}, per-rank dense x {W} "
          f"{dense_ms:.3f} ({CARD})")
    del layer, x, seen, out, dense, parts, cap, t, local
    gc.collect()
    torch.cuda.empty_cache()


def moe_pipeline_phase():
    """15d: pp = 4 stages, each ``x + MoELayer.apply_dense(x)`` at
    Mixtral's layer width (bf16), 8 microbatches of 512 tokens through
    ``pipeline_sharded``: bitwise the four stages applied in sequence to
    each microbatch (the same products on the same shapes in the same
    order); stage calls and time beside the sequence's."""
    import torch
    from accl_tpu_torch.models import MoELayer
    from accl_tpu_torch.parallel import make_mesh, pipeline_sharded
    cfg = mixtral_layer_config(dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)
    W, n_micro, mb = MOE_PP, MOE_PP_MICRO, MOE_PP_MB
    g = torch.Generator(device="cuda").manual_seed(SEED + 153)
    layer = MoELayer(cfg)
    stacked = {k: torch.empty((W, *p.shape), dtype=p.dtype, device="cuda")
               for k, p in layer.weights().items()}
    for s in range(W):
        layer.init(g)
        for k, p in layer.weights().items():
            stacked[k][s].copy_(p)
    x = torch.randn(n_micro, mb, cfg.dim, device="cuda",
                    generator=g).to(torch.bfloat16)
    mesh = make_mesh((W,), ("pp",))
    calls = [0]

    def stage(p, h):
        calls[0] += 1
        return h + layer.apply_dense(h, params=p)[0]

    def sequence():
        outs = []
        for m in range(n_micro):
            h = x[m]
            for s in range(W):
                h = stage({k: v[s] for k, v in stacked.items()}, h)
            outs.append(h)
        return torch.stack(outs)

    with torch.no_grad():
        out = pipeline_sharded(stage, stacked, x, mesh, "pp")
        piped = calls[0]
        want = sequence()
        torch.cuda.synchronize()
        ok, err = same_bits(out, want)
        need(ok, f"15d: the pipeline's outputs differ from the stages in "
                 f"sequence (max abs err {err})")
        pipe_ms = time_ms(lambda: pipeline_sharded(stage, stacked, x, mesh,
                                                   "pp"), reps=3, warmup=1)
        seq_ms = time_ms(sequence, reps=3, warmup=1)
    print(f"15d pipeline pp = {W}, {n_micro} microbatches of {mb} tokens, "
          f"each stage x + MoELayer.apply_dense(x) at Mixtral's width "
          f"(capacity {cfg.capacity(mb)}): outputs bitwise the stages in "
          f"sequence (limit: bitwise); {piped} stage calls over "
          f"{n_micro + W - 1} steps (the masked schedule computes "
          f"{W * (n_micro + W - 1)}); device ms (CUDA events behind a GPU "
          f"sleep, median of 3): pipeline {pipe_ms:.3f}, sequence "
          f"{seq_ms:.3f}, ratio {pipe_ms / seq_ms:.4f} ({CARD})")
    need(piped == W * n_micro, f"15d: {piped} stage calls, not "
         f"{W * n_micro}")
    del layer, stacked, x, out, want
    gc.collect()
    torch.cuda.empty_cache()


def moe_llama_phase() -> dict:
    """Phase 15a-d (16d inside 15a), each under the 2 GiB check. Returns
    the launch counts of the moe_serving, sp_moe and moe_training
    paths."""
    import torch
    by_path = {}
    for name, fn in (("15a MoE serving", moe_serving_phase),
                     ("15b MoE training",
                      lambda: {"moe_training": moe_training_phase()}),
                     ("15c expert parallelism", moe_ep_phase),
                     ("15d the pipeline", moe_pipeline_phase)):
        phase(f"phase {name}")
        held = torch.cuda.memory_allocated()
        need(held < 2 * 2 ** 30, f"{held / 2 ** 30:.2f} GiB still "
             f"allocated before phase {name} (limit 2 GiB)")
        by_path.update(fn() or {})
    return by_path


# -- phase 16: checkpoint/resume, the multi-slice tier, the dry run -----------

CKPT_LAYERS = 1            # 16a: 1 of 32 Llama-3-8B layers (disk and time)
CKPT_B, CKPT_S, CKPT_LR = 2, 2048, 1e-4
CKPT_SEED = SEED + 161     # the unbroken runs' weights and tokens
CKPT_OTHER_SEED = SEED + 162   # the fresh model the checkpoint lands in
CKPT_PARENT = "build/accl_tpu_torch"    # the temporary directory's parent
SLICE_SEED = SEED + 171    # 16b/16c: the 8 rank rows
SLICE_SHAPE = (2, 4)       # 16b/16c: 2 slices of 4 ranks
SLICE_AXES = (2, 2, 2)     # 16b: the multi-axis ring's mesh
SLICE_CHILD_TIMEOUT_S = 120
SP_MOE_W = 8               # 16d: sp ranks over 15a's prompts
DRYRUN_RANKS = 8           # 16e


def tree_crcs(tree, prefix: str = "") -> dict:
    """crc32 and byte count of every tensor of a nested dict / list tree,
    keyed by its path; each tensor copied to the host one at a time."""
    import torch
    out = {}
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    for k, v in items:
        path = f"{prefix}/{k}"
        if isinstance(v, torch.Tensor):
            raw = v.detach().contiguous().reshape(-1).view(torch.uint8)
            out[path] = (zlib.crc32(raw.cpu().numpy()), raw.numel())
        else:
            out.update(tree_crcs(v, path))
    return out


def param_prints(model) -> dict:
    """A device-side fingerprint of each parameter's bits (the int32 words
    summed in int64): two runs whose prints differ computed otherwise."""
    import torch
    return {n: int(p.detach().view(torch.int32).to(torch.int64).sum())
            for n, p in model.named_parameters()}


def checkpoint_phase() -> dict:
    """16a: checkpoint/resume on the training path. Llama-3-8B widths, 1
    of 32 layers, f32 parameters, Adam, bf16 activations, (2, 2048)
    tokens: step 1, ``CheckpointManager.save(1, ...)`` into a temporary
    directory, steps 2 and 3 (the unbroken run, twice, to learn whether a
    step repeats itself bitwise); the checkpoint restored into a fresh
    model and optimizer from another seed (every tensor's crc32 equal to
    the one taken at save time), steps 2 and 3 again, their losses held
    to the unbroken run's; a flipped byte refused with
    DATA_INTEGRITY_ERROR. Returns the steps' attention launch counts."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from accl_tpu_torch.constants import ACCLError, ErrorCode
    from accl_tpu_torch.models import Llama, LlamaConfig
    from accl_tpu_torch.utils import CheckpointManager
    from accl_tpu_torch.utils.checkpoint import verify_integrity_manifest
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=CKPT_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(CKPT_SEED)
    tokens = torch.randint(0, cfg.vocab_size, (CKPT_B, CKPT_S),
                           device="cuda", generator=g)

    def fresh(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        model = Llama(cfg).init(gen)
        opt = torch.optim.Adam(model.parameters(), lr=CKPT_LR)
        return model, opt, model.make_train_step(opt)

    def state(model, opt, step):
        return {"params": model.state_dict(), "opt_state": opt.state_dict(),
                "step": step}

    os.makedirs(CKPT_PARENT, exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt-", dir=CKPT_PARENT)
    zero_attention_counters()
    try:
        # the unbroken run, with the save after step 1
        model, opt, step = fresh(CKPT_SEED)
        N = model.param_count()
        losses = [float(step(tokens))]
        prints = [param_prints(model)]
        tree = state(model, opt, 1)
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree["params"].values()) + sum(
            t.numel() * t.element_size() for s in tree["opt_state"]["state"]
            .values() for t in s.values())
        free = shutil.disk_usage(root).free
        print(f"16a checkpoint: Llama-3-8B widths, {cfg.n_layers} of 32 "
              f"layers (the cut: depth, for disk and time), {N} "
              f"parameters, f32 parameters and Adam's two moments "
              f"{nbytes / 1e9:.2f} GB to write; free on the checkpoint's "
              f"disk {free / 1e9:.2f} GB")
        need(free >= nbytes * 1.05 + (1 << 30),
             f"16a: {free / 1e9:.2f} GB free under {root}, the state needs "
             f"{nbytes / 1e9:.2f} GB (+5 % and 1 GiB)")
        t0 = time.perf_counter()
        saved = tree_crcs(tree)
        crc_s = time.perf_counter() - t0
        mgr = CheckpointManager(os.path.join(root, "run"))
        t0 = time.perf_counter()
        mgr.save(1, tree)
        save_s = time.perf_counter() - t0
        del tree
        losses += [float(step(tokens)) for _ in range(2)]
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        # the unbroken run again, from the same seed
        model, opt, step = fresh(CKPT_SEED)
        again = [float(step(tokens))]
        prints.append(param_prints(model))
        again += [float(step(tokens)) for _ in range(2)]
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        repeats = again == losses and prints[0] == prints[1]
        differ = [n for n in prints[0] if prints[0][n] != prints[1][n]]
        print(f"16a unbroken losses {losses}, again {again}: the step "
              + ("repeats itself bitwise" if repeats else
                 "does not repeat itself; parameters differing after step "
                 f"1: {differ or 'none'}"))
        # verify alone, then restore into a fresh model and optimizer
        step_dir = os.path.join(mgr.directory, "1")
        manifest = os.path.join(mgr.directory, ".integrity", "1.json")
        t0 = time.perf_counter()
        verify_integrity_manifest(step_dir, manifest)
        verify_s = time.perf_counter() - t0
        model, opt, step = fresh(CKPT_OTHER_SEED)
        need(tree_crcs({"params": {"embed": model.embed}})
             != {k: v for k, v in saved.items() if k == "/params/embed"},
             "16a: the fresh model's embedding is the saved one")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = mgr.restore()
        model.load_state_dict(restored["params"])
        opt.load_state_dict(restored["opt_state"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        need(restored["step"] == 1, f"16a: restored step {restored['step']}")
        del restored
        got = tree_crcs(state(model, opt, 1))
        bad = [k for k in saved if got.get(k) != saved[k]]
        need(set(got) == set(saved) and not bad,
             f"16a: restored tensors differ from the saved ones: {bad[:5]}")
        resumed = [losses[0]] + [float(step(tokens)) for _ in range(2)]
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        if repeats:
            need(resumed == losses, f"16a: resumed losses {resumed} differ "
                 f"from the unbroken run's {losses}")
            rule = "bitwise"
        else:
            spread = [abs(a - b) for a, b in zip(losses, again)]
            need(all(min(a, b) - s <= r <= max(a, b) + s for a, b, r, s in
                     zip(losses, again, resumed, spread)),
                 f"16a: resumed losses {resumed} outside the unbroken "
                 f"runs' spread {losses} / {again}")
            rule = "within the unbroken runs' spread"
        print(f"16a resumed losses {resumed} ({rule} the unbroken run's); "
              f"{len(saved)} restored tensors' crc32 equal to the save's")
        # one flipped byte of the largest file is refused
        files = [os.path.join(dp, f) for dp, _, fs in os.walk(step_dir)
                 for f in fs]
        victim = max(files, key=os.path.getsize)
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0x01]))
        try:
            mgr.restore()
            need(False, "16a: a flipped byte was restored")
        except ACCLError as exc:
            need(exc.error_word & int(ErrorCode.DATA_INTEGRITY_ERROR),
                 f"16a: the flipped byte raised {exc}")
            print(f"16a flipped byte at {size // 2} of "
                  f"{os.path.basename(victim)} ({size} B): {exc}")
        finally:
            with open(victim, "r+b") as f:
                f.seek(size // 2)
                f.write(b)
        print(f"16a seconds: save {save_s:.2f} ({nbytes / save_s / 1e9:.2f} "
              f"GB/s, the manifest's crc32 pass included), verify "
              f"{verify_s:.2f} ({size / verify_s / 1e9:.2f} GB/s), restore "
              f"{restore_s:.2f} ({nbytes / restore_s / 1e9:.2f} GB/s: verify, "
              f"load, load_state_dict to the card); the tensors' crc32 at "
              f"save {crc_s:.2f}; file {size} B for {nbytes} B of tensors "
              f"({CARD})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = attention_counters()
    print(f"16a launches (path checkpoint): {launches}")
    from accl_tpu_torch.ops import attention as A
    fwd = "attn_fwd_single" if A.is_single_block(CKPT_S) else "attn_fwd"
    for key in (fwd, "attn_bwd_dkv", "attn_bwd_dq"):
        need(launches[key] == 8 * cfg.n_layers, f"16a: {key} launched "
             f"{launches[key]} times, not once a layer in each of 8 steps")
    need_routes(launches, True, "16a")
    return launches


def slice_rows():
    """The 8 seeded rank rows of 16b and 16c, made on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(SLICE_SEED)
    return torch.randn((math.prod(SLICE_SHAPE), N), device="cuda",
                       generator=g)


def rows_digest(t) -> str:
    import hashlib
    import torch
    raw = t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw).hexdigest()


def multislice_phase() -> tuple[dict, dict]:
    """16b: ``hierarchical_allreduce_sharded`` on ``hybrid_mesh((4,), 2)``
    (8 virtual ranks on the card, 64 Mi f32 a rank) for SUM, MAX, MIN and
    PROD, SUM with a bf16 dcn wire, and the four with an e4m3fn and an
    e5m2 dcn wire; ``multi_axis_ring_allreduce`` on a (2, 2, 2) mesh, and
    on it with the fp8 per-tensor wires; each bitwise the same call
    through the plain versions, timed. Returns the drives' launch counts and the sha256 of
    each slice's SUM and bf16 results (16c's yardstick)."""
    import torch
    from accl_tpu_torch.constants import ReduceFunc
    from accl_tpu_torch.parallel import (hierarchical_allreduce_sharded,
                                         hybrid_mesh, make_mesh,
                                         multi_axis_ring_allreduce)
    from accl_tpu_torch.parallel.collectives import PLAIN
    mesh = hybrid_mesh(SLICE_SHAPE[1:], SLICE_SHAPE[0])
    x = slice_rows()
    R, per = mesh.size, mesh.size // SLICE_SHAPE[0]
    nbytes = 2 * x.numel() * 4              # each row read, each written
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    launched = {k: 0 for k in counters()}
    digests = {}
    print(f"16b multi-slice tier: {mesh}, {N} f32 a rank; bound "
          f"{bound:.4f} ms ({nbytes} B at 3.35 TB/s); beside phase 13's "
          f"64 Mi allreduce as 2 x 4 (device ms on an H100 80GB HBM3 at "
          f"700 W): flat ring 3.4947, the hierarchy engine 3.8043")
    library = {ReduceFunc.SUM: ("sum", lambda: torch.sum(x, 0)),
               ReduceFunc.MAX: ("amax", lambda: torch.amax(x, 0)),
               ReduceFunc.MIN: ("amin", lambda: torch.amin(x, 0)),
               ReduceFunc.PROD: ("prod", lambda: torch.prod(x, 0))}
    cases = [(f.name, f, None) for f in (ReduceFunc.SUM, ReduceFunc.MAX,
                                        ReduceFunc.MIN, ReduceFunc.PROD)]
    cases.append(("SUM, bf16 dcn wire", ReduceFunc.SUM, "bfloat16"))
    cases += [(f"{f.name}, {w} dcn wire", f, w) for w in FP8_PAYLOADS
              for f in (ReduceFunc.SUM, ReduceFunc.MAX, ReduceFunc.MIN,
                        ReduceFunc.PROD)]
    for what, func, wire in cases:
        before = {k: f.launches for k, f in counters().items()}
        got = hierarchical_allreduce_sharded(x, mesh, func=func,
                                             wire_dtype=wire)
        torch.cuda.synchronize()
        for k, f in counters().items():
            launched[k] += f.launches - before[k]
        plain = hierarchical_allreduce_sharded(x, mesh, func=func,
                                               wire_dtype=wire,
                                               kernels=PLAIN)
        err = check_rows(got, plain, f"16b hierarchical {what}")
        need(all(same_bits(got[r], got[0])[0] for r in range(R)),
             f"16b hierarchical {what}: ranks disagree")
        key = {None: "sum", "bfloat16": "bf16",
               "float8_e4m3fn": "e4m3"}.get(wire)
        if func == ReduceFunc.SUM and key:
            digests[key] = [rows_digest(got[s * per:(s + 1) * per])
                            for s in range(SLICE_SHAPE[0])]
        del got, plain

        def run(func=func, wire=wire):
            return hierarchical_allreduce_sharded(x, mesh, func=func,
                                                  wire_dtype=wire)

        dev_ms = time_ms(run, reps=10)
        call_ms = host_ms(run)
        lib_name, lib_fn = library[func]
        lib_ms = time_ms(lib_fn, reps=10)
        print(f"16b hierarchical allreduce {what}: bitwise the plain "
              f"versions (max abs err {err}); device {dev_ms:.4f} ms "
              f"({bound / dev_ms:.1%} of bound), a call {call_ms:.3f} ms "
              f"host clock; library torch.{lib_name} over the rank axis "
              f"{lib_ms:.4f} ms ({CARD})")
    del x
    # the multi-axis ring: 64 Mi cut to the multiple of 3 parts x 8 ranks
    n = N - N % (len(SLICE_AXES) * math.prod(SLICE_AXES))
    mesh3 = make_mesh(SLICE_AXES, ("a", "b", "c"))
    x = slice_rows()[:, :n].contiguous()
    for wire in FP8_PAYLOADS:           # the per-tensor fp8 lanes on it
        before = {k: f.launches for k, f in counters().items()}
        got = multi_axis_ring_allreduce(x, mesh3, wire_dtype=wire)
        torch.cuda.synchronize()
        for k, f in counters().items():
            launched[k] += f.launches - before[k]
        err = check_rows(got, multi_axis_ring_allreduce(
            x, mesh3, wire_dtype=wire, kernels=PLAIN),
            f"16b multi-axis ring, {wire} wire")
        del got
        dev_ms = time_ms(lambda: multi_axis_ring_allreduce(  # noqa: B023
            x, mesh3, wire_dtype=wire), reps=3)  # noqa: B023
        print(f"16b multi-axis ring allreduce, {wire} wire: bitwise the "
              f"plain versions (max abs err {err}); device {dev_ms:.4f} ms "
              f"({CARD})")
    before = {k: f.launches for k, f in counters().items()}
    colls = {}
    got = multi_axis_ring_allreduce(x, mesh3, colls=colls)
    torch.cuda.synchronize()
    for k, f in counters().items():
        launched[k] += f.launches - before[k]
    plain = multi_axis_ring_allreduce(x, mesh3, kernels=PLAIN)
    err = check_rows(got, plain, "16b multi-axis ring")
    strides = sorted({min(abs(a - b), 8 - abs(a - b)) for per_ax in
                      colls.values() for c in per_ax
                      for a, b in c.permutation_pairs})
    need({1, 2, 4} <= set(strides), f"16b multi-axis: strides {strides}")
    del got, plain
    dev_ms = time_ms(lambda: multi_axis_ring_allreduce(x, mesh3), reps=10)
    call_ms = host_ms(lambda: multi_axis_ring_allreduce(x, mesh3))
    lib_ms = time_ms(lambda: torch.sum(x, 0), reps=10)
    nb3 = 2 * x.numel() * 4
    print(f"16b multi-axis ring allreduce on {mesh3}, {n} f32 a rank: "
          f"bitwise the plain versions (max abs err {err}); hop strides "
          f"{strides}; device {dev_ms:.4f} ms, bound "
          f"{nb3 / HBM_BYTES_PER_S * 1e3:.4f} ms "
          f"({nb3 / HBM_BYTES_PER_S * 1e3 / dev_ms:.1%}); a call "
          f"{call_ms:.3f} ms host clock; library torch.sum {lib_ms:.4f} ms "
          f"({CARD})")
    del x
    gc.collect()
    torch.cuda.empty_cache()
    print(f"16b launches (path multislice): {launched}")
    for k in ("combine", "cast"):
        need(launched[k] > 0, f"16b: {k} never launched")
    return launched, digests


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def slice_child(rank: int, port: int) -> int:
    """One process of 16c: slice ``rank`` of 2 over gloo on ``port``,
    its 4 rank rows of the 8 seeded ones; prints one JSON line."""
    import torch
    import torch.distributed as dist
    from accl_tpu_torch.parallel import (distributed_init,
                                         hierarchical_allreduce_sharded,
                                         hybrid_mesh, slice_count)
    need(distributed_init(f"127.0.0.1:{port}", SLICE_SHAPE[0], rank),
         "16c: distributed_init refused")
    mesh = hybrid_mesh(SLICE_SHAPE[1:], SLICE_SHAPE[0])
    need(slice_count() == SLICE_SHAPE[0] and mesh.local_slice == rank,
         f"16c: {mesh} in a group of {slice_count()}")
    per = mesh.local_size
    x = slice_rows()[rank * per:(rank + 1) * per].clone()
    torch.cuda.empty_cache()
    before = {k: f.launches for k, f in counters().items()}
    res, ms = {}, {}
    for name, wire in (("sum", None), ("bf16", "bfloat16"),
                       ("e4m3", "float8_e4m3fn")):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = hierarchical_allreduce_sharded(x, mesh, wire_dtype=wire)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        res[name] = rows_digest(out)
        del out
    launched = {k: f.launches - before[k] for k, f in counters().items()}
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "digests": res, "ms": ms,
                      "launches": launched}))
    return 0


def multiprocess_phase(digests: dict) -> dict:
    """16c: two processes on the card, one slice each, over gloo on a port
    the OS picked: each runs ``hierarchical_allreduce_sharded`` for SUM
    and the bf16 and e4m3fn dcn wires on its 4 of the 8 seeded rows, and
    its rows must equal 16b's one-process result (sha256 of their bytes). Returns the
    children's launch counts, summed."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--slice-child",
         str(r), str(port)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(SLICE_SHAPE[0])]
    outs = []
    try:
        deadline = time.monotonic() + SLICE_CHILD_TIMEOUT_S
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                need(False, f"16c: a child ran past "
                     f"{SLICE_CHILD_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    secs = time.perf_counter() - t0
    launched = {k: 0 for k in counters()}
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        need(p.returncode == 0, f"16c: child {r} exited {p.returncode}: "
             f"{se.strip()[-1500:]}")
        rep = json.loads(so.strip().splitlines()[-1])
        for name in ("sum", "bf16", "e4m3"):
            need(rep["digests"][name] == digests[name][r],
                 f"16c: child {r}'s {name} rows differ from 16b's")
        for k, v in rep["launches"].items():
            launched[k] += v
        print(f"16c child {r} (slice {r}, gloo on 127.0.0.1:{port}): SUM, "
              f"bf16 and e4m3fn wire rows equal 16b's (sha256); a call "
              f"{rep['ms']['sum']:.2f} / {rep['ms']['bf16']:.2f} / "
              f"{rep['ms']['e4m3']:.2f} ms host clock (the dcn hop staged "
              f"through pinned host memory)")
    print(f"16c: {len(procs)} processes in {secs:.1f} s; launches (path "
          f"multiprocess, counted in the children): {launched} ({CARD})")
    for k in ("combine", "cast"):
        need(launched[k] > 0, f"16c: {k} never launched in the children")
    return launched


def sp_moe_phase(model, prompts) -> dict:
    """16d, on 15a's model: an sp = 8 ``forward`` of the 4 x 1024 prompts
    over a (1, 8) ("dp", "sp") mesh beside the unsharded kernel forward,
    held with 15a's route checks; timed. Returns its launch counts."""
    import torch
    from accl_tpu_torch.parallel import make_mesh
    B, S = prompts.shape
    mesh = make_mesh((1, SP_MOE_W), ("dp", "sp"))
    with torch.no_grad():
        rec_full, rec_sp = [], []
        with moe_hooks(record=rec_full):
            full = model(prompts)
        zero_attention_counters()
        with moe_hooks(record=rec_sp):
            sp = model(prompts, dp="dp", sp="sp", mesh=mesh)
        torch.cuda.synchronize()
        launches = attention_counters()
        print(f"16d launches (path sp_moe): {launches}")
        need(launches["attn_fwd"] + launches["attn_fwd_single"] > 0,
             "16d: no attention forward kernel launched")
        need_routes(launches, True, "16d")
        hold_routes(f"16d sp = {SP_MOE_W} forward {B}x{S} vs the unsharded "
                    f"forward", sp, full, rec_sp, rec_full)
        del sp, full
        sp_ms = host_ms(lambda: model(prompts, dp="dp", sp="sp", mesh=mesh))
        full_ms = host_ms(lambda: model(prompts))
    print(f"16d sp = {SP_MOE_W} forward {B}x{S}: {sp_ms:.2f} ms host clock "
          f"(median of 3), {B * S / sp_ms * 1e3:.0f} tokens/s; the unsharded "
          f"forward {full_ms:.2f} ms, {B * S / full_ms * 1e3:.0f} tokens/s "
          f"({CARD})")
    return launches


def dryrun_phase() -> tuple[dict, dict]:
    """16e: ``dryrun_multichip(8)`` on the card: its seven checks, their
    seconds. Returns the attention and stream kernels' launch counts."""
    import torch
    from accl_tpu_torch.dryrun import CHECKS, dryrun_multichip
    zero_attention_counters()
    before = {k: f.launches for k, f in counters().items()}
    t0 = time.perf_counter()
    secs = dryrun_multichip(DRYRUN_RANKS)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    attn = attention_counters()
    stream = {k: f.launches - before[k] for k, f in counters().items()}
    print(f"16e dryrun_multichip({DRYRUN_RANKS}) ok in {total:.2f} s: "
          + ", ".join(f"{k} {s:.2f} s" for k, s in secs.items()))
    print(f"16e launches (path dryrun): {attn}; {stream}")
    need(tuple(secs) == CHECKS, f"16e: checks that did not run: "
         f"{sorted(set(CHECKS) - set(secs))}")
    need(attn["attn_fwd"] + attn["attn_fwd_single"] > 0,
         "16e: no attention forward kernel launched")
    for k in ("attn_bwd_dkv", "attn_bwd_dq", "attn_decode"):
        need(attn[k] > 0, f"16e: {k} never launched")
    need(stream["combine"] > 0, "16e: combine never launched")
    return attn, stream


def dtype_label(dt) -> str:
    return "fp32" if dt is None else str(dt).removeprefix("torch.")


def driver_phase(recs):
    """Phase 14a-14c, its lines printed after it ends; B1, B5, B6 and B7
    must launch in 14a's and 14c's drives, B1 in 14b's."""
    import torch
    lines, launched = [], {"profiler": {}, "tenants": {}, "tune": {}}
    t0 = time.perf_counter()
    ok = False
    try:
        profiler_phase(lines.append, launched["profiler"])
        gc.collect()
        torch.cuda.empty_cache()
        tenants_phase(lines.append, launched["tenants"])
        gc.collect()
        torch.cuda.empty_cache()
        tune_phase(lines.append, launched["tune"])
        ok = True
    finally:
        secs = time.perf_counter() - t0
        print(f"phase 14a-c: {secs:.1f} s of command time"
              + ("" if ok else " (failed)") + f" ({CARD})")
        for line in lines:
            print(line)
    print(f"phase 14a-c launches by path (the drives, not the yardsticks): "
          f"{launched}")
    for path in ("profiler", "tune"):
        for k in DRIVER_KERNELS:
            need(launched[path].get(k, 0) > 0,
                 f"phase 14 {path}: kernel {k} never launched")
    need(launched["tenants"].get("combine", 0) > 0,
         "phase 14 tenants: B1 never launched")
    for path, per in launched.items():
        add_path(recs, path, per)


# -- phase 17: the attention kernels on every dtype and head dim ------------

# the head layouts of public models at their widths: (model, H, Hkv, D)
HEAD_DIM_CASES = (("Gemma-2B", 8, 1, 256), ("Phi-2", 32, 32, 80),
                  ("Phi-3-mini", 32, 32, 96))
HD_B, HD_S, HD_B9_S = 4, 2048, 512     # B8, B10/B11 at 2048; B9 at 512
HD_T, HD_KV, HD_PREFILL = 4096, 2047, 1024   # decode and prefill
WIDE_DIMS = (264, 512)     # head dims past 256: the cluster forms
WIDE_MAX_D, WIDE_S = 1024, 1024
# the f32 B10/B11's cluster form (attention_bwd.cu): its last head dim
# (CLUSTER_MAX_D) and the slices a block holds (cluster_ns: 2 to 1024, 4
# to 2048, 8 past it); the f32 backward's own edge dims: clusters of 7
# blocks over 13 slices (the most receive slots, an odd slice count), of
# 5 blocks over 17 and 33 slices (the first head dims of the 4- and
# 8-slice tiers, one live slice in the last block), of 8 full blocks at
# 4096, and past the cluster form (the band forms; the decode's band form
# from 2056); the 17a rows at S 1024
F32_CLUSTER_MAX_D = 4096
WIDE_BWD_F32_DIMS = (776, 1032, 2056, 4096, 4104)
F32_BWD_ROW_DIMS = (776, 1032, 2048, 4096)
PAST_CLUSTER_D = 4104      # the f32 kernels past the cluster form, timed
# the f32 B10 and B11's band form (attention_bwd.cu, past
# F32_CLUSTER_MAX_D): wide_edges' cases of its own, (B, H, Hkv, Sq, Skv,
# D, causal): D 8192 on the ragged causal and uneven unmasked shapes, and
# a shape whose workspace takes several bands (B10 3 of 2048 rows, B11 2
# of 4096); 17a's timed rows; the band path's shape (17a's, B 1)
BAND_EDGE_CASES = ((1, 2, 1, 300, 300, 8192, True),
                   (1, 4, 2, 200, 300, 8192, False),
                   (1, 2, 1, 4160, 4160, 4104, True))
BAND_ROW_DIMS = (PAST_CLUSTER_D, 8192)
BAND_PATH = (1, 8, 1, 1024, PAST_CLUSTER_D)     # B, H, Hkv, S, D
# 17a's f32 forward rows past the cluster form and the decode's past the
# wide split, B 1, H 8/1: (kind, D, S or S_new, kv length, cache T,
# timed launches): B8, B9 (S 512), the chunk (S_new 1024) and the decode
# (kv_len 1023 of 1024) at D 4104 (the band forms), B8 at D 8192, and B9,
# the chunk (the cluster form) and the decode (the band decode) at D 2056
# and 4096
BAND_FWD_ROWS = tuple(
    [("fwd", PAST_CLUSTER_D, 1024, 1024, None, 5),
     ("fwd", 8192, 1024, 1024, None, 5)]
    + [row for D in (2056, 4096, PAST_CLUSTER_D) for row in (
        ("fwd_single", D, 512, 512, None, 5),
        ("prefill", D, 1024, 1024, 1024, 5),
        ("decode", D, 1, 1023, 1024, 20))])
# the band serving path (band_phase): B9 on the prompt's first
# BAND_SERVE_B9 tokens, the chunk of BAND_PATH's S tokens into a cache of
# S + BAND_SERVE_STEPS rows, then BAND_SERVE_STEPS single-token decodes
BAND_SERVE_B9 = 512
BAND_SERVE_STEPS = 4
# the single-token decode's wide split kernel (attention_decode.cu), every
# dtype: its last head dim (DECODE_SPLIT_MAX_D); past it the chunk's form
SPLIT_MAX_D = 2048
# the 16-bit B10's cluster form (attention_bwd_sm90.cu): its last head dim
# (BWD16_CLUSTER_MAX_D); past it the column-group kernel
BWD16_CLUSTER_MAX_D = 1024
# the kinds with a 16-bit cluster form of 256-column slices (B8, B9, the
# B12 chunks: attention_sm90.cu; B11: attention_bwd_sm90.cu), at the head
# dims ops.attention.takes_cluster16 names
CLUSTER16_KINDS = ("fwd", "fwd_single", "prefill", "bwd_dq")


def f32_cluster_ns(d: int) -> int:
    """The 64-column slices a block of the f32 backward's cluster form
    holds at head dim d (attention_bwd.cu's cluster_ns)."""
    return 2 if d <= 1024 else 4 if d <= 2048 else 8
DRY_D, DRY_S = 8, 64                   # the dry run's sp ring (8 ranks)
HALF_DTYPES = ("float32", "bfloat16", "float16")
F16_SERVE_SEED, F16_TRAIN_SEED, D256_SEED = SEED + 181, SEED + 182, SEED + 183
F16_TRAIN_LAYERS, F16_TRAIN_STEPS = 2, 3
# the f16 rows of the kernels line and where their launches are read
F16_RECORDS = {"attn_fwd_f16": "accl_tpu/ops/attention.py:285",
               "attn_fwd_single_f16": "accl_tpu/ops/attention.py:252",
               "attn_decode_f16": "accl_tpu/ops/attention.py:689",
               "attn_prefill_f16": "accl_tpu/ops/attention.py:689",
               "attn_bwd_dkv_f16": "accl_tpu/ops/attention.py:461",
               "attn_bwd_dq_f16": "accl_tpu/ops/attention.py:492"}
LAUNCH_PATH.update({name: ("training_f16" if "bwd" in name
                           else "serving_f16") for name in F16_RECORDS})


def tier_of(kind: str, dtype: str, D: int) -> tuple[str, str, int]:
    """The route a launch of ``kind`` ("fwd", "fwd_single", "prefill",
    "decode", "bwd_dkv", "bwd_dq") must report for ``dtype`` and head dim
    D: (route, dtype, column tier). The wrapper pads D to a multiple of
    8; 16-bit tensor-core routes hold 64, 128, 192 or 256 columns, the
    f32 routes and the split decode a power of two from 16; past 256
    every kind takes its column-group form ("_cols"), whose tier is the
    group's width (f32: 64, but a cluster block's columns, 64 times its
    slices (128, 256 or 512), to D 4096; 16-bit: 128 for B10's dK and
    dV, else 256), except f32 B8, B9, the B12 chunks, B10 and B11 past D
    4096, which take the band form ("<kind>_tf32_band", tier a product
    tile's 128 columns), the decode, which takes the wide split kernel to
    ``SPLIT_MAX_D`` on every dtype (its tier 512, 1024 or 2048) and, f32,
    the band decode past it ("decode_band", tier a product slice's 256
    columns), and the 16-bit B10 to
    ``BWD16_CLUSTER_MAX_D`` and B8, B9, the B12 chunks and B11 where
    ``ops.attention.takes_cluster16`` says (past 256 to 2048 but for some
    head dims the column groups keep), which take their cluster forms
    ("<kind>_wgmma_cluster", tier a block's slice: 128 for B10, 256 for
    the others)."""
    d = -(-D // 8) * 8
    f32 = dtype == "float32"
    if kind == "decode" and 256 < d <= SPLIT_MAX_D:
        return "decode_split", dtype, next(t for t in (512, 1024, 2048)
                                           if d <= t)
    if not f32 and kind == "bwd_dkv" and 256 < d <= BWD16_CLUSTER_MAX_D:
        return "bwd_dkv_wgmma_cluster", dtype, 128
    from accl_tpu_torch.ops import attention as A
    if (not f32 and kind in CLUSTER16_KINDS
            and A.takes_cluster16(kind, -(-d // 128) * 128)):
        return f"{kind}_wgmma_cluster", dtype, 256
    if f32 and kind == "decode" and d > SPLIT_MAX_D:
        return "decode_band", dtype, 256         # a product slice's columns
    if f32 and d > F32_CLUSTER_MAX_D:
        return f"{kind}_tf32_band", dtype, 128   # a product tile's columns
    if d > 256:                  # the column-group forms, by group width
        tier = (64 * f32_cluster_ns(d) if f32
                else 128 if kind == "bwd_dkv" else 256)
        return f"{kind}_{'tf32' if f32 else 'wgmma'}_cols", dtype, tier
    pow2 = next(t for t in (16, 32, 64, 128, 256) if d <= t)
    if kind == "decode":
        return "decode_split", dtype, pow2
    if dtype == "float32":
        return f"{kind}_tf32", dtype, pow2
    return f"{kind}_wgmma", dtype, next(t for t in WGMMA_TIERS if d <= t)


def routes_since(before: dict) -> dict:
    """The route launches counted since the snapshot ``before`` of
    ``ops.attention.route_launches``."""
    from accl_tpu_torch.ops import attention as A
    return {k: n - before.get(k, 0) for k, n in A.route_launches.items()
            if n != before.get(k, 0)}


def need_one_route(before: dict, kind: str, dtype: str, D: int, what: str):
    """Exactly one launch since ``before``, on the route ``tier_of``
    names, as the C entry point reported it."""
    got = routes_since(before)
    want = tier_of(kind, dtype, D)
    need(got == {want: 1}, f"{what}: routes {got}, want {want} once")


def kernel_case(kind: str, dt, B: int, H: int, Hkv: int, D: int, sq: int,
                skv: int, g, T: int | None = None,
                reps: int = 20) -> dict:
    """One launch of B8 (``kind`` "fwd"), B9 ("fwd_single"), B12 ("decode"
    with S_new = ``sq`` = 1, "prefill" with S_new = ``sq`` over a cache of
    T rows filled through ``skv``, NaN past it), or B10 and B11
    ("bwd"), causal, on random operands of ``dt``: held against its plain
    version (the limits of the dtype: ATTN_TOL/FWD_TOL, BWD_TOL), its
    route checked as the C entry point reported it, timed behind the GPU
    sleep beside the plain version, SDPA (forward, or its backward for
    "bwd", the three gradients together) and the bound. Returns the
    numbers."""
    import torch
    import torch.nn.functional as F
    from accl_tpu_torch.ops import attention as A
    dname = str(dt)[6:]
    q = torch.randn(B, H, sq, D, device="cuda", generator=g).to(dt)
    es = q.element_size()
    half = dname != "float32"
    rate = BF16_OPS_PER_S if half else TF32_OPS_PER_S
    mult = 1 if half else 3          # the f32 route: three TF32 products
    out = {}
    if kind in ("fwd", "fwd_single", "bwd"):
        k, v = (torch.randn(B, Hkv, skv, D, device="cuda",
                            generator=g).to(dt) for _ in range(2))
        bk = None if kind == "fwd_single" else 16
        need(A.is_single_block(skv, bk) == (kind == "fwd_single"),
             f"{kind} at Skv={skv}: the dispatch takes the other branch")
    if kind in ("fwd", "fwd_single"):
        before = dict(A.route_launches)
        o, lse = A.flash_attention_fwd(q, k, v, True, None, None, bk)
        need_one_route(before, kind, dname, D, f"{kind} {dname} D={D}")
        ref, rl = A.flash_attention_ref(q, k, v, True)
        err, ratio = hold_attn(o, ref, f"{kind} {dname} D={D}", lse, rl,
                               fwd_route_mag("fwd", (q, k, v, True)))
        kern = lambda: A.flash_attention_fwd(q, k, v, True, None, None, bk)  # noqa
        if D > 256 and (dname == "float32" or A.takes_cluster16(
                kind, -(-D // 128) * 128)):   # the cluster forms' repeat
            need_repeat(kern, (o, lse), f"{kind} {dname} D={D}")
            out["repeat"] = "bitwise"
        plain = lambda: A.flash_attention_ref(q, k, v, True)  # noqa
        lib = lambda: F.scaled_dot_product_attention(  # noqa
            q, k, v, is_causal=True, enable_gqa=True)
        nbytes, nops = attn_work(B, H, Hkv, sq, skv, D, es)
        del o, lse, ref, rl
    elif kind in ("decode", "prefill"):
        kc, vc = (torch.randn(B, T, Hkv, D, device="cuda",
                              generator=g).to(dt) for _ in range(2))
        kc[:, skv:] = float("nan")
        vc[:, skv:] = float("nan")
        before = dict(A.route_launches)
        o = A.flash_decode(q, kc, vc, skv)
        need_one_route(before, kind, dname, D, f"{kind} {dname} D={D}")
        ref = A.flash_decode_ref(q, kc, vc, skv)
        err, ratio = hold_attn(o, ref, f"{kind} {dname} D={D}",
                               mag=fwd_route_mag("decode", (q, kc, vc, skv)))
        kern = lambda: A.flash_decode(q, kc, vc, skv)  # noqa
        if D > 256 and (dname == "float32" or kind == "decode" and
                        D <= SPLIT_MAX_D or A.takes_cluster16(
                            kind, -(-D // 128) * 128)):
            # the cluster forms, the wide split
            need_repeat(kern, o, f"{kind} {dname} D={D}")
            out["repeat"] = "bitwise"
        plain = lambda: A.flash_decode_ref(q, kc, vc, skv)  # noqa
        kt, vt = (t[:, :skv].transpose(1, 2) for t in (kc, vc))
        lib = lambda: F.scaled_dot_product_attention(  # noqa
            q, kt, vt, is_causal=sq > 1, enable_gqa=True)
        nbytes, nops = attn_work(B, H, Hkv, sq, skv, D, es, s_new=sq)
        if kind == "decode" and (D <= SPLIT_MAX_D or not half):
            mult, rate = 1, F32_OPS_PER_S   # CUDA cores, f32 arithmetic
        out["n_split"] = A.last_decode_splits
        del o, ref
    else:                                    # B10 and B11
        do = torch.randn_like(q)
        _o, lse, delta = bwd_operands(q, k, v, do, True)
        args = (q, do, k, v, lse, delta, True, D ** -0.5)
        before = dict(A.route_launches)
        dk, dv = A.flash_attention_bwd_dkv(*args)
        need_one_route(before, "bwd_dkv", dname, D, f"bwd_dkv {dname} D={D}")
        before = dict(A.route_launches)
        dq = A.flash_attention_bwd_dq(*args)
        need_one_route(before, "bwd_dq", dname, D, f"bwd_dq {dname} D={D}")
        err, ratio = max_pair(
            hold_bwd_outputs(args, (dk, dv), f"bwd_dkv {dname} D={D}"),
            hold_bwd_outputs(args, (dq,), f"bwd_dq {dname} D={D}"))
        if D > 256:   # the cluster forms' (and column groups') repeat
            need_repeat(lambda: (*A.flash_attention_bwd_dkv(*args),  # noqa: B023
                                 A.flash_attention_bwd_dq(*args)),  # noqa: B023
                        (dk, dv, dq), f"bwd {dname} D={D}")
            out["repeat"] = "bitwise"
        del dk, dv, dq
        torch.cuda.empty_cache()
        n = sq * (sq + 1) // 2 * B * H       # visible scores, causal
        # each kernel: q, do, k, v, lse and delta read once; B10 writes
        # the f32 dK, dV partials (8*D operations a visible score), B11
        # dQ in q's dtype (6*D)
        ins = ((2 * B * H * sq + 2 * B * Hkv * skv) * D * es
               + 8 * B * H * sq)
        for part, fn, ref, ops_per, outb in (
                ("dkv", A.flash_attention_bwd_dkv,
                 A.flash_attention_bwd_dkv_ref, 8, 8 * B * H * skv * D),
                ("dq", A.flash_attention_bwd_dq,
                 A.flash_attention_bwd_dq_ref, 6, B * H * sq * D * es)):
            bms, by = bound_ms(ins + outb, mult * ops_per * D * n, rate)
            out[part] = {"ms": time_ms(lambda: fn(*args), reps=reps),  # noqa: B023
                         "plain_ms": time_ms(lambda: ref(*args), reps=3),  # noqa: B023
                         "bound_ms": bms, "bound_by": by}
        kern = lambda: (A.flash_attention_bwd_dkv(*args),  # noqa
                        A.flash_attention_bwd_dq(*args))
        plain = lambda: (A.flash_attention_bwd_dkv_ref(*args),  # noqa
                         A.flash_attention_bwd_dq_ref(*args))
        lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            enable_gqa=True)
        lib = lambda: torch.autograd.grad(lo, (lq, lk, lv), do,  # noqa
                                          retain_graph=True)
        probe = lambda: torch.autograd.grad(  # noqa: E731
            F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                           enable_gqa=True),
            (lq, lk, lv), do)
        nops = 14 * D * n
        nbytes = ins + 8 * B * H * skv * D + B * H * sq * D * es
    out.update(err=err, ratio=ratio, ms=time_ms(kern, reps=reps),
               plain_ms=time_ms(plain, reps=3),
               library_ms=time_ms(lib, reps=reps))
    if D > 256:                     # which of SDPA's backends take it
        out["sdpa"] = sdpa_backends(probe if kind == "bwd" else lib)
    out["bound_ms"], out["bound_by"] = bound_ms(nbytes, mult * nops, rate)
    torch.cuda.empty_cache()
    return out


def sdpa_backends(call) -> str:
    """The backends of scaled_dot_product_attention that take ``call``
    (flash, cuDNN, memory-efficient, math, in that order), "none" if
    none does."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    took = []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]), warnings.catch_warnings():
                warnings.simplefilter("ignore")    # each refusal's reasons
                call()
            took.append(b.name.lower())
        except RuntimeError:
            continue
    return "/".join(took) or "none"


def case_line(kind, dt, B, H, Hkv, D, sq, skv, r, T=None, model="") -> str:
    """A kernel case's printed line."""
    dname = str(dt)[6:]
    route = tier_of("bwd_dkv" if kind == "bwd" else kind, dname, D)
    extra = "".join(
        f"{'; ' if part == 'dq' else ' ('}attn_bwd_{part} "
        f"{r[part]['ms']:.4f} ms, bound {r[part]['bound_ms']:.4f}, "
        f"{r[part]['bound_ms'] / r[part]['ms']:.1%} of it"
        for part in ("dkv", "dq")) + (
        f"; repeat {r['repeat']}" if "repeat" in r else "") + (
        "; the pair below)") if kind == "bwd" else (
        f" (repeat {r['repeat']})" if "repeat" in r else "")
    return (f"kernel {kind} {dname} {model} B={B} H={H} Hkv={Hkv} D={D} "
            f"{'S' if T is None else 'S_new'}={sq} "
            f"{'Skv' if T is None else 'kv_len'}={skv}"
            f"{'' if T is None else f' T={T}'} route {route}: "
            f"{r['ms']:.4f} ms{extra} (plain {r['plain_ms']:.4f} ms, sdpa "
            f"{r['library_ms']:.4f} ms"
            + (f" on {r['sdpa']}" if "sdpa" in r else "")
            + f", bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of it), max abs "
            f"err vs plain {r['err']:.4g}, largest error/limit "
            f"{r['ratio']:.3f}")


def wide_edges(g):
    """The forms past 256 (D 264 and 512, every dtype) at ragged and
    uneven shapes, each on the route it must report and held against its
    plain version: B8 at S = 300 causal (q tiles and key tiles past S) and
    Sq 200 against Skv 300 unmasked; B9 over one block at S = 100 causal
    and Sq 70 against Skv 130 unmasked; B10 and B11 on the first two;
    B12 over a cache of 320 rows with NaN past kv_len 1, 65 and 300, one
    new token and five; the f32 forward run twice, bitwise equal. Then the
    f32 forward, B10 and B11 at D 776, 1032, 2056, 4096 (the cluster
    form's three tiers) and 4104 (the band forms; ``WIDE_BWD_F32_DIMS``)
    on the ragged, uneven and GQA shapes of B8 (and B9 at Sq 70 against
    Skv 130 unmasked), and B12 over a 320-row cache with NaN past kv_len
    1, 65 and 300 (one new token at 16/2 and 2/2 heads: the wide split
    decode to 2048, the band decode past it; five at 8/2), each run twice,
    bitwise equal; then the band forms on cases of their own
    (``band_edges``)."""
    import torch
    from accl_tpu_torch.ops import attention as A
    n = 0
    for D in WIDE_DIMS:
        for dname in HALF_DTYPES:
            dt = getattr(torch, dname)

            def rnd(*shape, dt=dt):
                return torch.randn(*shape, device="cuda", generator=g).to(dt)

            for B, H, Hkv, Sq, Skv, causal, bk in (
                    (1, 2, 1, 300, 300, True, None),
                    (1, 4, 2, 200, 300, False, None),
                    (1, 2, 1, 100, 100, True, None),
                    (1, 4, 1, 70, 130, False, 256)):
                q, k, v = rnd(B, H, Sq, D), rnd(B, Hkv, Skv, D), rnd(
                    B, Hkv, Skv, D)
                single = A.is_single_block(Skv, bk)
                what = f"wide {dname} D={D} {(B, H, Hkv, Sq, Skv, causal)}"
                before = dict(A.route_launches)
                o, lse = A.flash_attention_fwd(q, k, v, causal, block_k=bk)
                need_one_route(before, "fwd_single" if single else "fwd",
                               dname, D, what)
                ro, rl = A.flash_attention_ref(q, k, v, causal)
                hold_attn(o, ro, what, lse, rl, fwd_route_mag(
                    "fwd", (q, k, v, causal, None, None, bk)))
                # f32's cluster form and the 16-bit cluster form
                need_repeat(lambda: A.flash_attention_fwd(  # noqa: B023
                    q, k, v, causal, block_k=bk), (o, lse), what)  # noqa: B023
                if not single:
                    do = rnd(B, H, Sq, D)
                    delta = (do.float() * o.float()).sum(-1).reshape(B * H,
                                                                     Sq)
                    args = (q, do, k, v, lse, delta, causal, D ** -0.5)
                    before = dict(A.route_launches)
                    dkv = A.flash_attention_bwd_dkv(*args)
                    need_one_route(before, "bwd_dkv", dname, D, what)
                    before = dict(A.route_launches)
                    dq = A.flash_attention_bwd_dq(*args)
                    need_one_route(before, "bwd_dq", dname, D, what)
                    hold_bwd_outputs(args, dkv, what + " bwd")
                    hold_bwd_outputs(args, (dq,), what + " bwd")
                    if dt != torch.float32:   # the 16-bit cluster B10
                        need_repeat(lambda: A.flash_attention_bwd_dkv(  # noqa: B023
                            *args), dkv, what + " bwd")  # noqa: B023
                n += 1
            for kv_len in (1, 65, 300):
                kc, vc = rnd(1, 320, 1, D), rnd(1, 320, 1, D)
                kc[:, kv_len:] = float("nan")
                vc[:, kv_len:] = float("nan")
                for s_new in (1, 5):
                    if s_new > kv_len:
                        continue
                    q = rnd(1, 4, s_new, D)
                    what = f"wide {dname} D={D} kv_len {kv_len} S_new {s_new}"
                    kind = "decode" if s_new == 1 else "prefill"
                    before = dict(A.route_launches)
                    o = A.flash_decode(q, kc, vc, kv_len)
                    need_one_route(before, kind, dname, D, what)
                    hold_attn(o, A.flash_decode_ref(q, kc, vc, kv_len), what,
                              mag=fwd_route_mag("decode", (q, kc, vc,
                                                           kv_len)))
                    # the wide split decode, the 16-bit cluster chunks
                    need_repeat(lambda: A.flash_decode(  # noqa: B023
                        q, kc, vc, kv_len), o, what)  # noqa: B023
                    n += 1
    w = wide16_edges(g)
    m = f = 0
    for D in WIDE_BWD_F32_DIMS:
        for B, H, Hkv, Sq, Skv, causal, bk in (
                (1, 2, 1, 300, 300, True, None),
                (1, 4, 2, 200, 300, False, None),
                (1, 8, 1, 130, 300, True, None),
                (1, 4, 1, 70, 130, False, 256)):
            q, do = (torch.randn(B, H, Sq, D, device="cuda", generator=g)
                     for _ in range(2))
            k, v = (torch.randn(B, Hkv, Skv, D, device="cuda", generator=g)
                    for _ in range(2))
            single = A.is_single_block(Skv, bk)
            what = f"wide float32 D={D} {(B, H, Hkv, Sq, Skv, causal)}"
            before = dict(A.route_launches)
            o, lse = A.flash_attention_fwd(q, k, v, causal, block_k=bk)
            need_one_route(before, "fwd_single" if single else "fwd",
                           "float32", D, what)
            ro, rl = A.flash_attention_ref(q, k, v, causal)
            hold_attn(o, ro, what, lse, rl, fwd_route_mag(
                "fwd", (q, k, v, causal, None, None, bk)))
            need_repeat(lambda: A.flash_attention_fwd(  # noqa: B023
                q, k, v, causal, block_k=bk), (o, lse), what)  # noqa: B023
            f += 1
            if single:
                continue
            what = f"wide bwd float32 D={D} {(B, H, Hkv, Sq, Skv, causal)}"
            delta = (do * o).sum(-1).reshape(B * H, Sq)
            args = (q, do, k, v, lse, delta, causal, D ** -0.5)
            before = dict(A.route_launches)
            dkv = A.flash_attention_bwd_dkv(*args)
            need_one_route(before, "bwd_dkv", "float32", D, what)
            before = dict(A.route_launches)
            dq = A.flash_attention_bwd_dq(*args)
            need_one_route(before, "bwd_dq", "float32", D, what)
            hold_bwd_outputs(args, dkv, what)
            hold_bwd_outputs(args, (dq,), what)
            need_repeat(lambda: (*A.flash_attention_bwd_dkv(*args),  # noqa: B023
                                 A.flash_attention_bwd_dq(*args)),  # noqa: B023
                        (*dkv, dq), what)
            m += 1
        # B12 over a ragged cache: the f32 decode (the wide split to
        # SPLIT_MAX_D) and chunks (the cluster form to 4096)
        for kv_len in (1, 65, 300):
            kc, vc = (torch.randn(1, 320, 2, D, device="cuda", generator=g)
                      for _ in range(2))
            kc[:, kv_len:] = float("nan")
            vc[:, kv_len:] = float("nan")
            for s_new, H in ((1, 16), (1, 2), (5, 8)):
                if s_new > kv_len:
                    continue
                q = torch.randn(1, H, s_new, D, device="cuda", generator=g)
                what = (f"wide float32 D={D} H={H} kv_len {kv_len} S_new "
                        f"{s_new}")
                before = dict(A.route_launches)
                o = A.flash_decode(q, kc, vc, kv_len)
                need_one_route(before, "decode" if s_new == 1 else "prefill",
                               "float32", D, what)
                hold_attn(o, A.flash_decode_ref(q, kc, vc, kv_len), what)
                need_repeat(lambda: A.flash_decode(  # noqa: B023
                    q, kc, vc, kv_len), o, what)  # noqa: B023
                f += 1
    b = band_edges(g)
    print(f"wide edges: the forms past 256 over {n} ragged, uneven "
          f"and cache cases at D {WIDE_DIMS} on f32, bf16 and f16 (16-bit "
          f"B10 on the cluster form, the decode on the wide split, each "
          f"bitwise on a repeat); 16-bit B8 at D "
          f"{sorted(set(WIDE16_BWD_DIMS) | set(WIDE16_CLUSTER_DIMS))}, B10 at "
          f"D {WIDE16_BWD_DIMS}, B11 at D {WIDE16_CLUSTER_DIMS} and decode at "
          f"D {WIDE16_DECODE_DIMS} over {w} more; the "
          f"f32 forward (the cluster and band forms, the wide split and "
          f"band decodes) over {f} "
          f"and the f32 backward over {m} at D {WIDE_BWD_F32_DIMS}, each on "
          f"its route, within its limit and (f32) bitwise on a repeat; the "
          f"band forms over {b} more ({BAND_EDGE_CASES}, B12 at D "
          f"{BAND_ROW_DIMS[-1]})")


def band_edges(g) -> int:
    """The f32 band forms on ``BAND_EDGE_CASES``: D 8192 and a shape whose
    workspaces take several bands (the bands' count from
    ``ops.attention.fwd_band_rows`` and ``band_rows``): B8 (O and the LSE)
    within ATTN_TOL of the plain forward, and B10 and B11, on the plain
    forward's O and LSE, within BWD_TOL of their plain versions; then B12
    at D 8192 over a 320-row cache with NaN past kv_len 65 and 300 (a
    chunk of five new tokens at 8/2 heads on the band form, one new token
    at 16/2 on the band decode) within ATTN_TOL. Each launch on its band
    route and bitwise on a repeat. Returns the cases run."""
    import torch
    from accl_tpu_torch.ops import attention as A
    n = 0
    for B, H, Hkv, Sq, Skv, D, causal in BAND_EDGE_CASES:
        q, do = (torch.randn(B, H, Sq, D, device="cuda", generator=g)
                 for _ in range(2))
        k, v = (torch.randn(B, Hkv, Skv, D, device="cuda", generator=g)
                for _ in range(2))
        o, lse = A.flash_attention_ref(q, k, v, causal)
        what = (f"band fwd float32 D={D} {(B, H, Hkv, Sq, Skv, causal)} "
                f"bands {-(-Sq // A.fwd_band_rows(Sq, Skv, D))}")
        before = dict(A.route_launches)
        ko, klse = A.flash_attention_fwd(q, k, v, causal, block_k=16)
        need_one_route(before, "fwd", "float32", D, what)
        err, ratio = hold_attn(ko, o, what, klse, lse)
        need_repeat(lambda: A.flash_attention_fwd(  # noqa: B023
            q, k, v, causal, block_k=16), (ko, klse), what)  # noqa: B023
        print(f"{what}: max abs err vs plain {err:.4g}, largest error/limit "
              f"{ratio:.3f}, bitwise on a repeat")
        del ko, klse
        n += 1
        delta = (do * o).sum(-1).reshape(B * H, Sq)
        args = (q, do, k, v, lse, delta, causal, D ** -0.5)
        bands = [-(-Sq // A.band_rows(dkv, Sq, Skv, D)) for dkv in (True,
                                                                    False)]
        what = (f"band float32 D={D} {(B, H, Hkv, Sq, Skv, causal)} bands "
                f"B10 {bands[0]}, B11 {bands[1]}")
        before = dict(A.route_launches)
        dkv = A.flash_attention_bwd_dkv(*args)
        need_one_route(before, "bwd_dkv", "float32", D, what)
        before = dict(A.route_launches)
        dq = A.flash_attention_bwd_dq(*args)
        need_one_route(before, "bwd_dq", "float32", D, what)
        err, ratio = max_pair(hold_bwd_outputs(args, dkv, what),
                              hold_bwd_outputs(args, (dq,), what))
        need_repeat(lambda: (*A.flash_attention_bwd_dkv(*args),  # noqa: B023
                             A.flash_attention_bwd_dq(*args)),  # noqa: B023
                    (*dkv, dq), what)
        print(f"{what}: max abs err vs plain {err:.4g}, largest error/limit "
              f"{ratio:.3f}, bitwise on a repeat")
        del q, do, k, v, o, lse, delta, args, dkv, dq
        torch.cuda.empty_cache()
        n += 1
    D = BAND_ROW_DIMS[-1]
    for kv_len in (65, 300):
        kc, vc = (torch.randn(1, 320, 2, D, device="cuda", generator=g)
                  for _ in range(2))
        kc[:, kv_len:] = float("nan")
        vc[:, kv_len:] = float("nan")
        for s_new, H in ((5, 8), (1, 16)):
            q = torch.randn(1, H, s_new, D, device="cuda", generator=g)
            kind = "decode" if s_new == 1 else "prefill"
            what = f"band {kind} float32 D={D} H={H} kv_len {kv_len}"
            before = dict(A.route_launches)
            o = A.flash_decode(q, kc, vc, kv_len)
            need_one_route(before, kind, "float32", D, what)
            err, ratio = hold_attn(o, A.flash_decode_ref(q, kc, vc, kv_len),
                                   what)
            need_repeat(lambda: A.flash_decode(  # noqa: B023
                q, kc, vc, kv_len), o, what)  # noqa: B023
            print(f"{what}: max abs err vs plain {err:.4g}, largest "
                  f"error/limit {ratio:.3f}, bitwise on a repeat")
            n += 1
    return n


# 16-bit head dims of wide_edges past 512: B10 on the cluster form's other
# sizes (5, 6, 7 blocks) and past it (D 1032, the column-group kernel);
# B8 and B11 at clusters of 3 (D 640 and 768: the column groups but B11
# at 768), 5, 6, 7 and 8 blocks (D 1280 to 2048) and past them (D 2056);
# the decode on the wide split's last two tiers and past it (D 2056, the
# prefill form at S_new = 1)
WIDE16_BWD_DIMS = (640, 768, 896, 1032)
WIDE16_CLUSTER_DIMS = (640, 768, 1280, 1536, 1792, 2048, 2056)
PAST_CLUSTER16_D = 2056    # 17a's timed rows of the 16-bit column groups
WIDE16_DECODE_DIMS = (1024, 2048, 2056)


def wide16_edges(g) -> int:
    """bf16 and f16 B8 (O and the LSE), B10 at ``WIDE16_BWD_DIMS`` and B11
    at ``WIDE16_CLUSTER_DIMS`` on the ragged causal and the uneven
    unmasked shape of ``wide_edges`` (B10 and B11 on B8's O and LSE), and
    the single-token decode at ``WIDE16_DECODE_DIMS`` over a 320-row
    cache with NaN past kv_len 1, 65 and 300 (16/2 and 2/2 heads: eight
    rows and one of a kv head a block), each on its route, held against
    its plain version and bitwise on a repeat. Returns the case count."""
    import torch
    from accl_tpu_torch.ops import attention as A
    n = 0
    for dname in HALF_DTYPES[1:]:
        dt = getattr(torch, dname)

        def rnd(*shape, dt=dt):
            return torch.randn(*shape, device="cuda", generator=g).to(dt)

        for D in sorted(set(WIDE16_BWD_DIMS) | set(WIDE16_CLUSTER_DIMS)):
            for B, H, Hkv, Sq, Skv, causal in ((1, 2, 1, 300, 300, True),
                                               (1, 4, 2, 200, 300, False)):
                q, do = rnd(B, H, Sq, D), rnd(B, H, Sq, D)
                k, v = rnd(B, Hkv, Skv, D), rnd(B, Hkv, Skv, D)
                what = f"wide16 {dname} D={D} {(B, H, Hkv, Sq, Skv, causal)}"
                before = dict(A.route_launches)
                o, lse = A.flash_attention_fwd(q, k, v, causal)
                need_one_route(before, "fwd", dname, D, what)
                ro, rl = A.flash_attention_ref(q, k, v, causal)
                hold_attn(o, ro, what, lse, rl,
                          fwd_route_mag("fwd", (q, k, v, causal)))
                need_repeat(lambda: A.flash_attention_fwd(  # noqa: B023
                    q, k, v, causal), (o, lse), what)  # noqa: B023
                delta = (do.float() * o.float()).sum(-1).reshape(B * H, Sq)
                args = (q, do, k, v, lse, delta, causal, D ** -0.5)
                for kind, fn, on in (
                        ("bwd_dkv", A.flash_attention_bwd_dkv,
                         WIDE16_BWD_DIMS),
                        ("bwd_dq", lambda *a: (A.flash_attention_bwd_dq(*a),),
                         WIDE16_CLUSTER_DIMS)):
                    if D not in on:
                        continue
                    before = dict(A.route_launches)
                    outs = fn(*args)
                    need_one_route(before, kind, dname, D, f"{what} {kind}")
                    hold_bwd_outputs(args, outs, f"{what} {kind}")
                    need_repeat(lambda: fn(*args), outs,  # noqa: B023
                                f"{what} {kind}")
                n += 1
        for D in WIDE16_DECODE_DIMS:
            for kv_len in (1, 65, 300):
                kc, vc = rnd(1, 320, 2, D), rnd(1, 320, 2, D)
                kc[:, kv_len:] = float("nan")
                vc[:, kv_len:] = float("nan")
                for H in (16, 2):
                    q = rnd(1, H, 1, D)
                    what = f"wide16 decode {dname} D={D} H={H} kv_len {kv_len}"
                    before = dict(A.route_launches)
                    o = A.flash_decode(q, kc, vc, kv_len)
                    need_one_route(before, "decode", dname, D, what)
                    hold_attn(o, A.flash_decode_ref(q, kc, vc, kv_len), what,
                              mag=fwd_route_mag("decode", (q, kc, vc,
                                                           kv_len)))
                    need_repeat(lambda: A.flash_decode(  # noqa: B023
                        q, kc, vc, kv_len), o, what)  # noqa: B023
                    n += 1
    return n


# 17f: the split decode's ticket counters on two streams (ROADMAP C1-1).
# The cases (name, B, H, Hkv, T, kv_len, D, dtype): the narrow split
# kernel at Llama-3-8B's decode (bf16, D 128), the wide kernel's merge
# tree at Gemma-2B's heads (bf16 and f32, D 512) and the f32 band decode's
# tickets past the wide split (D 4104, 17a's B 1, kv_len 1023 of 1024);
# each stream launches them in its own order, round after round, the two
# queues behind one GPU sleep so that the device runs them side by side
STREAM_CASES = (("bf16 D128", 4, 32, 8, 4096, 2047, 128, "bfloat16"),
                ("bf16 D512", 4, 8, 1, 4096, 2047, 512, "bfloat16"),
                ("f32 D512", 4, 8, 1, 4096, 2047, 512, "float32"),
                ("f32 D4104", 1, 8, 1, 1024, 1023, 4104, "float32"))
STREAM_ORDERS = (("bf16 D128", "f32 D512", "bf16 D512", "f32 D4104"),
                 ("f32 D4104", "bf16 D128", "bf16 D512", "f32 D512"))
STREAM_ROUNDS = 100


def two_stream_decode(rounds: int = STREAM_ROUNDS) -> tuple[dict, dict]:
    """Each case of ``STREAM_CASES`` decoded alone (held against its plain
    version), then ``rounds`` rounds of all of them on each of two CUDA
    streams at once (``STREAM_ORDERS``), every output kept. Returns
    ({case: launches whose output is not bitwise the one alone}, the
    routes the launches reported)."""
    import torch
    from accl_tpu_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(SEED + 190)
    ins, alone = {}, {}
    for name, B, H, Hkv, T, kv, D, dname in STREAM_CASES:
        dt = getattr(torch, dname)
        q = torch.randn(B, H, 1, D, device="cuda", generator=g).to(dt)
        kc, vc = (torch.randn(B, T, Hkv, D, device="cuda", generator=g)
                  .to(dt) for _ in range(2))
        ins[name] = (q, kc, vc, kv)
        alone[name] = A.flash_decode(q, kc, vc, kv)
        hold_attn(alone[name], A.flash_decode_ref(q, kc, vc, kv),
                  f"two streams: {name} alone",
                  mag=fwd_route_mag("decode", (q, kc, vc, kv)))
    streams = [torch.cuda.Stream() for _ in STREAM_ORDERS]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            torch.cuda._sleep(CALL_HEAD_START_CYCLES)
    before = dict(A.route_launches)
    outs = []
    for _ in range(rounds):
        for i in range(len(STREAM_CASES)):
            for st, order in zip(streams, STREAM_ORDERS):
                with torch.cuda.stream(st):
                    outs.append((order[i], A.flash_decode(*ins[order[i]])))
    torch.cuda.synchronize()
    bad = {name: sum(not torch.equal(o, alone[name]) for n, o in outs
                     if n == name) for name in alone}
    return bad, routes_since(before)


def two_stream_phase():
    """17f: ``two_stream_decode``; fails on any launch that differs from
    the same call alone, or off its route (the narrow split kernel at D
    128, the wide one at D 512, the band decode at D 4104)."""
    import torch
    from accl_tpu_torch.ops import attention as A
    bad, routes = two_stream_decode()
    want = {tier_of("decode", dname, D): 2 * STREAM_ROUNDS
            for _n, _b, _h, _k, _t, _kv, D, dname in STREAM_CASES}
    need(routes == want, f"two streams: routes {routes}, want {want}")
    keys = [k for k in A._SPLIT_COUNTERS if k[0] == torch.cuda.current_device()]
    print(f"two streams: {STREAM_ROUNDS} rounds of {len(STREAM_CASES)} "
          f"single-token decodes on each of {len(STREAM_ORDERS)} streams "
          f"at once ({', '.join(n for n, *_ in STREAM_CASES)}), routes "
          f"{routes}; launches not bitwise the call alone: {bad}; counter "
          f"sets on the card: {len(keys)} (one a stream)")
    need(not any(bad.values()), f"two streams: outputs differ from the "
         f"same calls alone: {bad}")


def cluster16_occupancy() -> str:
    """The clusters of each 16-bit cluster form the card holds at once
    (cudaOccupancyMaxActiveClusters, one block an SM), by blocks a
    cluster: B8/B9/B12 chunks and B11 at D = 256 C (C 2 to 8; the form's
    shape, also where the dispatch keeps the column groups), B10 at D =
    128 C (C 3 to 8)."""
    from accl_tpu_torch import _build
    lib = _build.library()
    fwd = {c: lib.accl_attn_fwd16_active_clusters(256 * c)
           for c in range(2, 9)}
    dq = {c: lib.accl_attn_bwd_dq16_active_clusters(256 * c)
          for c in range(2, 9)}
    dkv = {c: lib.accl_attn_bwd_dkv16_active_clusters(128 * c)
           for c in range(3, 9)}
    need(all(n > 0 for d in (fwd, dq, dkv) for n in d.values()),
         f"16-bit cluster forms: a cluster size the card cannot hold: "
         f"{fwd} {dq} {dkv}")
    return (f"16-bit cluster forms, clusters the card holds at once by "
            f"blocks a cluster: B8/B9/B12 chunks {fwd}, B11 {dq}, B10 {dkv}")


def column_groups16_rows(g):
    """17a's rows of the 16-bit routes no other row times, bf16 at
    Gemma-2B's heads, B 4, S 1024 (B9 512): B10 past its cluster form (D
    2048, the column groups; B11 there on its cluster form) and every
    kind past the 16-bit cluster forms (D 2056, the column groups; the
    decode, kv_len 1023 of 1024, past the wide split), each beside SDPA
    and its bound."""
    import torch
    for D, cases in ((SPLIT_MAX_D, (("bwd", WIDE_S, WIDE_S, None),)),
                     (PAST_CLUSTER16_D,
                      (("fwd", WIDE_S, WIDE_S, None),
                       ("fwd_single", HD_B9_S, HD_B9_S, None),
                       ("prefill", WIDE_S, WIDE_S, WIDE_S),
                       ("bwd", WIDE_S, WIDE_S, None),
                       ("decode", 1, WIDE_S - 1, WIDE_S)))):
        for kind, sq, skv, T in cases:
            r = kernel_case(kind, torch.bfloat16, HD_B, 8, 1, D, sq, skv, g,
                            T, reps=3)
            print(case_line(kind, torch.bfloat16, HD_B, 8, 1, D, sq, skv, r,
                            T, "Gemma-2B heads, 16-bit column groups"))
            gc.collect()
            torch.cuda.empty_cache()


def head_dim_phase() -> tuple[list, list]:
    """17a: B8-B12 at the head layouts of Gemma-2B (D = 256, H = 8,
    Hkv = 1), Phi-2 (D = 80) and Phi-3-mini (D = 96, both H = Hkv = 32)
    on f32, bf16 and f16; the forms past 256 at Gemma-2B's heads with
    D = 264 and 512 (every kind and dtype) and D = 1024 at S = 1024 (B8,
    B10/B11 and decode in bf16, f16 and f32), the wide edges and the
    16-bit cluster forms' occupancy (``cluster16_occupancy``), f32 B8 and
    B10/B11 at D = 776,
    1032, 2048 and 4096, S = 1024 (``F32_BWD_ROW_DIMS``: each tier of the
    cluster form), the f32 and bf16 decode at D = 2048 (``SPLIT_MAX_D``,
    the wide split's last); the bf16 column groups at S = 1024 (B9 512):
    B10 at D = 2048 and B8, B9, the prefill, B10/B11 and the decode
    (kv_len 1023 of 1024) at D = 2056 (``PAST_CLUSTER16_D``); the f32
    forward's band forms and the f32 band decode at B = 1
    (``BAND_FWD_ROWS``: D 2056 to 8192) and B10 and B11's band form with
    the band paths (``band_phase``); at D = 8 (the dry run's ring shapes);
    then
    the f16 rows of the kernels line at Llama-3-8B's shapes (phases 5 and
    8's). Returns the f16 records and the band form's."""
    import torch
    from accl_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 184)
    for model, H, Hkv, D in HEAD_DIM_CASES:
        for dname in HALF_DTYPES:
            dt = getattr(torch, dname)
            for kind, sq, skv, T in (("fwd", HD_S, HD_S, None),
                                     ("fwd_single", HD_B9_S, HD_B9_S, None),
                                     ("bwd", HD_S, HD_S, None),
                                     ("decode", 1, HD_KV, HD_T),
                                     ("prefill", HD_PREFILL, HD_PREFILL,
                                      HD_PREFILL)):
                r = kernel_case(kind, dt, HD_B, H, Hkv, D, sq, skv, g, T,
                                reps=10)
                print(case_line(kind, dt, HD_B, H, Hkv, D, sq, skv, r, T,
                                model))
            gc.collect()
            torch.cuda.empty_cache()
    # head dims past 256 at Gemma-2B's head layout: the cluster forms, the
    # column groups and the wide split
    wide_edges(g)
    print(cluster16_occupancy())
    for D in WIDE_DIMS:
        for dname in HALF_DTYPES:
            dt = getattr(torch, dname)
            for kind, sq, skv, T in (("fwd", HD_S, HD_S, None),
                                     ("fwd_single", HD_B9_S, HD_B9_S, None),
                                     ("bwd", HD_S, HD_S, None),
                                     ("decode", 1, HD_KV, HD_T),
                                     ("prefill", HD_PREFILL, HD_PREFILL,
                                      HD_PREFILL)):
                r = kernel_case(kind, dt, HD_B, 8, 1, D, sq, skv, g, T,
                                reps=3)
                print(case_line(kind, dt, HD_B, 8, 1, D, sq, skv, r, T,
                                "Gemma-2B heads"))
            gc.collect()
            torch.cuda.empty_cache()
    for dname in HALF_DTYPES[1:] + HALF_DTYPES[:1]:  # D = 1024, S = 1024
        dt = getattr(torch, dname)
        for kind, sq, skv, T in (("fwd", WIDE_S, WIDE_S, None),
                                 ("bwd", WIDE_S, WIDE_S, None),
                                 ("decode", 1, WIDE_S - 1, WIDE_S)):
            r = kernel_case(kind, dt, HD_B, 8, 1, WIDE_MAX_D, sq, skv, g, T,
                            reps=3)
            print(case_line(kind, dt, HD_B, 8, 1, WIDE_MAX_D, sq, skv, r, T,
                            "Gemma-2B heads"))
        gc.collect()
        torch.cuda.empty_cache()
    for D in F32_BWD_ROW_DIMS:          # the f32 cluster form's tiers
        for kind in ("fwd", "bwd"):
            r = kernel_case(kind, torch.float32, HD_B, 8, 1, D, WIDE_S,
                            WIDE_S, g, reps=3)
            print(case_line(kind, torch.float32, HD_B, 8, 1, D, WIDE_S,
                            WIDE_S, r, model="Gemma-2B heads"))
            gc.collect()
            torch.cuda.empty_cache()
    # the f32 and bf16 decode at the wide split's last head dim
    for dt in (torch.float32, torch.bfloat16):
        r = kernel_case("decode", dt, HD_B, 8, 1, SPLIT_MAX_D, 1,
                        WIDE_S - 1, g, WIDE_S, reps=3)
        print(case_line("decode", dt, HD_B, 8, 1, SPLIT_MAX_D, 1,
                        WIDE_S - 1, r, WIDE_S, "Gemma-2B heads"))
    column_groups16_rows(g)
    # the f32 kernels past the cluster form and the wide split (no public
    # model's width; BAND_FWD_ROWS): B8, B9, the chunk and the decode on
    # the band forms, the decode's band form from D 2056; B10 and B11's
    # band form in band_phase, which takes the D 4104 rows' numbers
    past = {}
    for kind, D, sq, skv, T, reps in BAND_FWD_ROWS:
        r = kernel_case(kind, torch.float32, 1, 8, 1, D, sq, skv, g, T,
                        reps=reps)
        print(case_line(kind, torch.float32, 1, 8, 1, D, sq, skv, r, T,
                        "Gemma-2B heads, past the cluster form"))
        past[kind, D] = r
        gc.collect()
        torch.cuda.empty_cache()
    band_recs = band_phase(g, past)
    for dname in HALF_DTYPES:           # the dry run's sp ring: D = 8
        dt = getattr(torch, dname)
        for kind, sq, skv, T in (("fwd", DRY_S, DRY_S, None),
                                 ("fwd_single", DRY_S, DRY_S, None),
                                 ("bwd", DRY_S, DRY_S, None),
                                 ("decode", 1, DRY_S - 1, DRY_S),
                                 ("prefill", 16, DRY_S, DRY_S)):
            r = kernel_case(kind, dt, 1, 2, 2, DRY_D, sq, skv, g, T)
            print(case_line(kind, dt, 1, 2, 2, DRY_D, sq, skv, r, T,
                            "dry-run"))
    # the f16 rows at Llama-3-8B's attention (H 32, Hkv 8, D 128)
    recs = []
    for name, (kind, B, sq, skv, T) in (
            ("attn_fwd_f16", ("fwd", 4, 2048, 2048, None)),
            ("attn_fwd_single_f16", ("fwd_single", 4, SERVE_B9_LEN,
                                     SERVE_B9_LEN, None)),
            ("attn_decode_f16", ("decode", 4, 1, 2047, 4096)),
            ("attn_prefill_f16", ("prefill", 4, 1024, 1024, 1024)),
            ("attn_bwd_dkv_f16", ("bwd", 4, 2048, 2048, None))):
        r = kernel_case(kind, torch.float16, B, 32, 8, 128, sq, skv, g, T)
        print(case_line(kind, torch.float16, B, 32, 8, 128, sq, skv, r, T,
                        "Llama-3-8B"))
        src = (ATTN_BWD_SM90_SRC if kind == "bwd"
               else attn_source("decode" if T else "fwd", torch.float16,
                                sq))
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": F16_RECORDS[name], "launches": 0,
               "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if kind == "bwd":            # B10 and B11 each their own row
            for part, nm in (("dkv", "attn_bwd_dkv_f16"),
                             ("dq", "attn_bwd_dq_f16")):
                recs.append(dict(rec, name=nm, replaces=F16_RECORDS[nm],
                                 **r[part]))
        else:
            if r.get("n_split"):
                rec["n_split"] = r["n_split"]
            recs.append(rec)
    print(f"phase 17a routes: {dict(sorted(A.route_launches.items()))}")
    return recs, band_recs


def band_phase(g, past: dict) -> list:
    """17a's rows of the f32 B10 and B11's band form at Gemma-2B's heads,
    B 1, S 1024, D ``BAND_ROW_DIMS`` (each beside the plain versions,
    SDPA's backward and the bound), then the band paths at ``BAND_PATH``,
    each's route launches counted from a snapshot taken just before it:
    training, the Function a trainer calls (``flash_attention`` forward
    and backward: B8, B10 and B11 once each on the band forms), the
    gradients held against dense autograd (FN_DENSE_REL); serving, B9 on
    the prompt's first ``BAND_SERVE_B9`` tokens, the prompt's chunk into a
    cache and ``BAND_SERVE_STEPS`` single-token decodes (B9, the chunk on
    the band form, the decodes on the band decode), each held against its
    plain version (ATTN_TOL). Returns the kernels line's rows of the band
    forms, with the paths' launches; the forward's and decode's numbers
    are ``past``'s (17a's rows at D 4104, kernel_case)."""
    import torch
    from accl_tpu_torch.ops import attention as A
    rows = {}
    for D in BAND_ROW_DIMS:
        rows[D] = kernel_case("bwd", torch.float32, 1, 8, 1, D, WIDE_S,
                              WIDE_S, g, reps=5)
        print(case_line("bwd", torch.float32, 1, 8, 1, D, WIDE_S, WIDE_S,
                        rows[D], model="Gemma-2B heads, the band form"))
        gc.collect()
        torch.cuda.empty_cache()
    B, H, Hkv, S, D = BAND_PATH
    q, k, v = (torch.randn(B, h, S, D, device="cuda", generator=g)
               .requires_grad_() for h in (H, Hkv, Hkv))
    do = torch.randn(B, H, S, D, device="cuda", generator=g)
    before = dict(A.route_launches)
    got = torch.autograd.grad(A.flash_attention(q, k, v, causal=True),
                              (q, k, v), do)
    routes = routes_since(before)
    launches = {kind: routes.get(tier_of(kind, "float32", D), 0)
                for kind in ("fwd", "bwd_dkv", "bwd_dq")}
    need(launches == {"fwd": 1, "bwd_dkv": 1, "bwd_dq": 1}, f"band path: "
         f"B8, B10 and B11 not once each on the band forms: {routes}")
    want = torch.autograd.grad(dense_topleft(q, k, v), (q, k, v), do)
    worst = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        need(bool(torch.isfinite(a).all()), f"band path {name}: non-finite")
        lim = FN_DENSE_REL * b.abs() + FN_DENSE_REL * float(b.abs().max())
        worst = max(worst, float(((a - b).abs() / lim).max()))
    print(f"band path (Function forward and backward, f32, {BAND_PATH}): "
          f"routes {routes}; dq, dk, dv vs dense autograd largest "
          f"error/limit {worst:.3f} (1e-4*|dense| + 1e-4*max|dense|)")
    need(worst <= 1.0, "band path: flash and dense gradients differ")
    q, k, v = (t.detach() for t in (q, k, v))
    del do, got, want
    torch.cuda.empty_cache()
    # serving: B9 on the first tokens, the chunk, then the decode steps
    T = S + BAND_SERVE_STEPS
    kc, vc = (torch.zeros(B, T, Hkv, D, device="cuda") for _ in range(2))
    kc[:, :S] = k.transpose(1, 2)
    vc[:, :S] = v.transpose(1, 2)
    n9 = BAND_SERVE_B9
    q9, k9, v9 = (t[:, :, :n9].contiguous() for t in (q, k, v))
    before = dict(A.route_launches)
    o9, lse9 = A.flash_attention_fwd(q9, k9, v9, True)
    serve = [("B9", o9, A.flash_attention_ref(q9, k9, v9, True)[0])]
    o = A.flash_decode(q, kc, vc, S)
    serve.append(("chunk", o, A.flash_decode_ref(q, kc, vc, S)))
    for step in range(BAND_SERVE_STEPS):
        kv = S + step + 1
        kc[:, kv - 1] = torch.randn(B, Hkv, D, device="cuda", generator=g)
        vc[:, kv - 1] = torch.randn(B, Hkv, D, device="cuda", generator=g)
        qs = torch.randn(B, H, 1, D, device="cuda", generator=g)
        o = A.flash_decode(qs, kc, vc, kv)
        serve.append((f"decode {kv}", o,
                      A.flash_decode_ref(qs, kc, vc, kv)))
    routes = routes_since(before)
    for kind in ("fwd_single", "prefill", "decode"):
        launches[kind] = routes.get(tier_of(kind, "float32", D), 0)
    need([launches[k] for k in ("fwd_single", "prefill", "decode")]
         == [1, 1, BAND_SERVE_STEPS], f"band serving path: B9, the chunk "
         f"and the decodes not on the band forms: {routes}")
    worst = max(hold_attn(got, want, f"band serving {name}")[1]
                for name, got, want in serve)
    print(f"band serving path (f32, {BAND_PATH}, B9 on {n9} tokens, the "
          f"chunk into a {T}-row cache, {BAND_SERVE_STEPS} decodes): routes "
          f"{routes}; largest error/limit {worst:.3f} ({ATTN_TOL})")
    # where the band forms' time goes: each pass's device ms a launch
    for what, fn in (("B8", lambda: A.flash_attention_fwd(q, k, v, True)),
                     ("decode", lambda: A.flash_decode(qs, kc, vc, kv))):
        fams = device_ms_by_family(lambda: [fn() for _ in range(5)])  # noqa: B023
        passes = {f: round(ms / 5, 4) for f, ms in fams.items()
                  if "band" in f}
        print(f"band {what} passes at {BAND_PATH} (torch.profiler, device "
              f"ms a launch): {passes or 'not measured (no device records)'}")
    del q, k, v, q9, k9, v9, qs, kc, vc, o, o9, lse9, serve
    torch.cuda.empty_cache()
    r = rows[D]
    recs = [{"name": name, "route": "cuda", "source": ATTN_BWD_SRC,
             "replaces": f"accl_tpu/ops/attention.py:{line}",
             "launches": launches[kind],
             "launches_by_path": {"band_grad": launches[kind]},
             "max_abs_err": r["err"], "ms": r[kind[4:]]["ms"],
             "plain_ms": r[kind[4:]]["plain_ms"],
             "bound_ms": r[kind[4:]]["bound_ms"],
             "bound_by": r[kind[4:]]["bound_by"],
             "library_ms": r["library_ms"]}
            for kind, name, line in (
                ("bwd_dkv", "attn_bwd_dkv_tf32_band", 461),
                ("bwd_dq", "attn_bwd_dq_tf32_band", 492))]
    for kind, name, src, line, path in (
            ("fwd", "attn_fwd_tf32_band", ATTN_BAND_FWD_SRC, 285,
             "band_grad"),
            ("fwd_single", "attn_fwd_single_tf32_band", ATTN_BAND_FWD_SRC,
             252, "band_serve"),
            ("prefill", "attn_prefill_tf32_band", ATTN_BAND_FWD_SRC, 689,
             "band_serve"),
            ("decode", "attn_decode_band", ATTN_DECODE_SRC, 689,
             "band_serve")):
        p = past[kind, D]
        recs.append({"name": name, "route": "cuda", "source": src,
                     "replaces": f"accl_tpu/ops/attention.py:{line}",
                     "launches": launches[kind],
                     "launches_by_path": {path: launches[kind]},
                     "max_abs_err": p["err"], "ms": p["ms"],
                     "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
                     "bound_by": p["bound_by"],
                     "library_ms": p["library_ms"]})
    return recs


def f16_serving_phase() -> dict:
    """17b: Llama-3-8B as published (32 layers) in f16, weights and
    activations, random weights: ``generate(max_new=32)`` for four
    1024-token prompts (the B12 prefill and decode), a forward on the
    prompts (B8) and one on their first 512 tokens (B9), held against the
    dense path on the same weights; tokens/s, decode ms a step, the busy
    share and the peak memory. Returns the path's launch counts."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama, LlamaConfig
    from accl_tpu_torch.ops import attention as A
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), dtype=torch.float16,
                              param_dtype=torch.float16)
    B, S, NEW = 4, 1024, 32
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    g = torch.Generator(device="cuda").manual_seed(F16_SERVE_SEED)
    t0 = time.perf_counter()
    model = Llama(cfg).init(g)
    torch.cuda.synchronize()
    print(f"f16 serving: Llama-3-8B, {cfg.n_layers} layers, f16 weights and "
          f"activations, {model.param_count()} parameters, init "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                            generator=g)
    short = prompts[:, :SERVE_B9_LEN]
    with torch.no_grad():
        zero_attention_counters()
        before = dict(A.route_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(prompts, max_new=NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        full = model(prompts)
        full_short = model(short)
        torch.cuda.synchronize()
        launches = attention_counters()
        routes = routes_since(before)
    print(f"f16 serving launches: {launches}; routes {routes}")
    need(launches["attn_fwd"] > 0 and launches["attn_decode"] > 0
         and launches["attn_prefill"] > 0
         and launches["attn_fwd_single"] == cfg.n_layers,
         "f16 serving: B8, B9 or B12 (decode or prefill) not launched")
    need(all(dt == "float16" for _r, dt, _t in routes),
         f"f16 serving: a launch on another dtype's route: {routes}")
    need_routes(launches, True, "f16 serving")
    need(out.shape == (B, NEW) and bool(((out >= 0)
                                         & (out < cfg.vocab_size)).all()),
         f"f16 generate: shape {tuple(out.shape)} or a token outside the "
         f"vocabulary")
    for what, t in (("forward", full), ("forward 512", full_short)):
        need(bool(torch.isfinite(t).all()), f"f16 serving {what}: "
             f"non-finite logits")
    with torch.no_grad():
        for what, flash, fn in (("forward", full, lambda: model(prompts)),
                                (f"forward {B}x{SERVE_B9_LEN} (B9)",
                                 full_short, lambda: model(short))):
            model.config = dataclasses.replace(cfg, attention="dense")
            try:
                ref = fn()
            finally:
                model.config = cfg
            rel = float(torch.linalg.vector_norm((flash - ref).float())
                        / torch.linalg.vector_norm(ref.float()))
            agree = float((flash.argmax(-1) == ref.argmax(-1)).float()
                          .mean())
            print(f"f16 serving {what}, flash vs dense (32 layers): "
                  f"relative diff {rel:.4g} (limit {SERVE_DENSE_REL}), "
                  f"greedy agreement {agree:.4f}")
            need(rel <= SERVE_DENSE_REL, f"f16 serving {what}: flash and "
                 f"dense differ")
            del ref
        del full, full_short
        torch.cuda.empty_cache()

        def prefill():
            c = model.init_kv_cache(B, S + NEW)
            return model.forward_cached(prompts, c)

        def decode_steps(state, n):
            logits, c = state
            ts = []
            for _ in range(n):
                t1 = time.perf_counter()
                tok = logits[:, -1].argmax(-1)
                logits, c = model.forward_cached(tok[:, None], c)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t1) * 1e3)
            return ts

        fwd_ms = host_ms(lambda: model(prompts))
        pre_ms = host_ms(prefill)
        state = prefill()
        dec_ms = statistics.median(decode_steps(state, 16))
        print(f"f16 serving: generate {B}x{S} + {NEW} tokens in "
              f"{gen_s:.3f} s ({B * NEW / gen_s:.1f} new tokens/s, host "
              f"clock, the build's first calls included); forward "
              f"{fwd_ms:.2f} ms for {B}x{S} tokens ({B * S / fwd_ms * 1e3:.0f}"
              f" tokens/s); prefill {pre_ms:.2f} ms ({B * S / pre_ms * 1e3:.0f}"
              f" tokens/s); decode {dec_ms:.3f} ms a step of {B} tokens "
              f"({B / dec_ms * 1e3:.1f} tokens/s; median of 16 steps; host "
              f"clock, median of 3 for the others)")
        state = prefill()
        for what, fn, window in (("forward", lambda: model(prompts), fwd_ms),
                                 ("decode x8", lambda: decode_steps(state, 8),
                                  8 * dec_ms)):
            fams = device_ms_by_family(fn)
            if not fams:
                print(f"f16 serving {what}: busy share not measured (the "
                      f"profiler saw no device activity)")
                continue
            busy = sum(fams.values())
            print(f"f16 serving {what}: {busy:.2f} ms of kernels in a "
                  f"{window:.2f} ms host-clock window, busy share "
                  f"{busy / window:.3f}; " + ", ".join(
                      f"{f} {ms:.2f} ms" for f, ms in sorted(fams.items())))
        del state
    peak = torch.cuda.max_memory_allocated()
    print(f"f16 serving peak memory: {(peak - held) / 2 ** 30:.2f} GiB above "
          f"the {held / 2 ** 30:.2f} GiB held before the phase")
    del model, prompts, short, out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def f16_training_phase() -> dict:
    """17c: Llama-3-8B width, 2 of 32 layers, f32 parameters and f16
    activations (phase 9's, with f16 for bf16), Adam(lr=1e-4), 3 steps on
    one (2, 2048) batch: the losses finite and falling, B10 and B11 on
    the f16 route once a layer a step. Returns the path's launch
    counts."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama, LlamaConfig
    from accl_tpu_torch.ops import attention as A
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              n_layers=F16_TRAIN_LAYERS, dtype=torch.float16)
    g = torch.Generator(device="cuda").manual_seed(F16_TRAIN_SEED)
    model = Llama(cfg).init(g)
    step = model.make_train_step(torch.optim.Adam(model.parameters(),
                                                  lr=1e-4))
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                           device="cuda", generator=g)
    zero_attention_counters()
    before = dict(A.route_launches)
    losses, times = [], []
    for _ in range(F16_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(tokens)))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = attention_counters()
    routes = routes_since(before)
    print(f"f16 training: {cfg.n_layers} of 32 layers, f32 parameters, f16 "
          f"activations, B={TRAIN_B}, S={TRAIN_S}: losses {losses}; step ms "
          f"(host clock) {times}; launches {launches}; routes {routes}")
    need(all(np.isfinite(x) for x in losses), "f16 training: non-finite "
         "loss")
    need(losses[-1] < losses[0], "f16 training: the loss did not fall")
    per_run = cfg.n_layers * F16_TRAIN_STEPS
    for key in ("attn_fwd", "attn_bwd_dkv", "attn_bwd_dq"):
        need(launches[key] == per_run, f"f16 training: {key} launched "
             f"{launches[key]} times, not once a layer a step ({per_run})")
    need(routes.get(("bwd_dkv_wgmma", "float16", 128)) == per_run
         and routes.get(("bwd_dq_wgmma", "float16", 128)) == per_run,
         f"f16 training: B10/B11 not on the f16 tensor-core route: {routes}")
    need_routes(launches, True, "f16 training")
    del model, step, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def head_dim_256_model_phase():
    """17d: the port's Llama at Gemma-2B's attention widths (dim 2048, 8
    q heads, 1 kv head: D = 256; Gemma-2B's ffn 16384, Llama-3's
    vocabulary), 2 layers, bf16, random weights: a 1 x 2048 forward held
    against the dense path, and ``generate`` 16 tokens from it; every
    attention launch on a 256-column tier."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama, LlamaConfig
    from accl_tpu_torch.ops import attention as A
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), dim=2048, n_heads=8,
                              n_kv_heads=1, ffn_dim=16384, n_layers=2,
                              param_dtype=torch.bfloat16)
    need(cfg.head_dim == 256, f"head dim {cfg.head_dim}")
    g = torch.Generator(device="cuda").manual_seed(D256_SEED)
    model = Llama(cfg).init(g)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                           generator=g)
    before = dict(A.route_launches)
    with torch.no_grad():
        logits = model(tokens)
        out = model.generate(tokens, max_new=16)
        model.config = dataclasses.replace(cfg, attention="dense")
        try:
            ref = model(tokens)
        finally:
            model.config = cfg
    routes = routes_since(before)
    rel = float(torch.linalg.vector_norm((logits - ref).float())
                / torch.linalg.vector_norm(ref.float()))
    print(f"D=256 model (dim 2048, 8/1 heads, 2 layers, bf16): 1x2048 "
          f"forward flash vs dense relative diff {rel:.4g} (limit "
          f"{SERVE_DENSE_REL}); generate 16 tokens {out.tolist()}; routes "
          f"{routes}")
    need(bool(torch.isfinite(logits).all()), "D=256 model: non-finite "
         "logits")
    need(rel <= SERVE_DENSE_REL, "D=256 model: flash and dense differ")
    need(out.shape == (1, 16) and bool(((out >= 0)
                                        & (out < cfg.vocab_size)).all()),
         "D=256 model: generate's tokens")
    need(routes and all(t == 256 for _r, _d, t in routes)
         and {r for r, _d, _t in routes} >= {
             "fwd_wgmma", "prefill_wgmma", "decode_split"},
         f"D=256 model: routes {routes}")
    del model, logits, ref, out
    gc.collect()
    torch.cuda.empty_cache()


# 17e: the Llama at D = 512 (dim 4096, 8 q heads, 1 kv head, Gemma-2B's
# ffn), 2 layers; the rows past 256 of the kernels line, each from
# its path at the path's shapes: (kind, S or S_new, kv length, cache T)
D512_SEED, D512_F32_SEED = SEED + 185, SEED + 186
D512_S, D512_F32_S, D512_NEW, D512_STEPS, D512_F32_STEPS = (2048, 1024, 16,
                                                            3, 2)
# the 16-bit rows' names past the column-group form, by route
D512_SUFFIX = {"decode_split": "_split", "bwd_dkv_wgmma_cluster": "_cluster",
               "fwd_wgmma_cluster": "_cluster",
               "fwd_single_wgmma_cluster": "_cluster",
               "prefill_wgmma_cluster": "_cluster",
               "bwd_dq_wgmma_cluster": "_cluster"}
D512_RECORDS = {
    "attn_fwd": ("fwd", "accl_tpu/ops/attention.py:285"),
    "attn_fwd_single": ("fwd_single", "accl_tpu/ops/attention.py:252"),
    "attn_prefill": ("prefill", "accl_tpu/ops/attention.py:689"),
    "attn_decode": ("decode", "accl_tpu/ops/attention.py:689"),
    "attn_bwd_dkv": ("bwd_dkv", "accl_tpu/ops/attention.py:461"),
    "attn_bwd_dq": ("bwd_dq", "accl_tpu/ops/attention.py:492")}


def d512_config(dtype):
    """Llama-3's vocabulary at dim 4096 over 8 q heads and 1 kv head (head
    dim 512), Gemma-2B's ffn 16384, 2 layers; f32 parameters, activations
    of ``dtype``."""
    import dataclasses
    from accl_tpu_torch.models import LlamaConfig
    return dataclasses.replace(LlamaConfig.llama3_8b(), dim=4096, n_heads=8,
                               n_kv_heads=1, ffn_dim=16384, n_layers=2,
                               dtype=dtype)


def d512_records(dt, S: int, T: int, path: str, routes: dict) -> list:
    """The rows past 256 of the kernels line for ``dt``: each kind at
    the path's shapes (B 1, 8 q heads, 1 kv head, D 512; S, a cache of T
    rows), held against its plain version and timed (kernel_case), with
    the launches the path made on its route."""
    import torch
    dname = str(dt)[6:]
    g = torch.Generator(device="cuda").manual_seed(D512_SEED + 7)
    cases = {"fwd": (S, S, None), "fwd_single": (HD_B9_S, HD_B9_S, None),
             "prefill": (S, S, T), "decode": (1, T - 1, T),
             "bwd": (S, S, None)}
    res = {kind: kernel_case(kind, dt, 1, 8, 1, 512, sq, skv, g, t, reps=3)
           for kind, (sq, skv, t) in cases.items()}
    recs = []
    for name, (kind, replaces) in D512_RECORDS.items():
        r = res["bwd"] if kind.startswith("bwd") else res[kind]
        part = r[kind.removeprefix("bwd_")] if kind.startswith("bwd") else r
        route = tier_of(kind, dname, 512)
        # the 16-bit rows on the cluster B10 and the wide split decode
        suffix = ("_cols_tf32" if dt == torch.float32 else
                  D512_SUFFIX.get(route[0], "_cols"))
        n = routes.get(route, 0)
        need(n > 0, f"{path}: no launch on {route}")
        src = (ATTN_BWD_SM90_SRC if dt != torch.float32 else ATTN_BWD_SRC) \
            if kind.startswith("bwd") else ATTN_DECODE_SRC \
            if kind == "decode" else \
            (ATTN_SM90_SRC if dt != torch.float32 else ATTN_SRC)
        recs.append({"name": name + suffix, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": n,
                     "launches_by_path": {path: n},
                     "max_abs_err": r["err"], "ms": part["ms"],
                     "plain_ms": part["plain_ms"],
                     "bound_ms": part["bound_ms"],
                     "bound_by": part["bound_by"],
                     "library_ms": r["library_ms"]})
    for kind, (sq, skv, t) in cases.items():
        print(case_line(kind, dt, 1, 8, 1, 512, sq, skv, res[kind], t,
                        f"D=512 Llama ({path})"))
    return recs


def head_dim_512_model_phase() -> list:
    """17e: the port's Llama with head dim 512 (d512_config), random
    weights. bf16: a 1 x 2048 forward and a 512-token one held against
    the dense path, ``generate`` 16 tokens from the 2048, and three Adam
    steps at (1, 2048) with f32 parameters, the losses falling. f32 (the
    3xTF32 routes): the same at 1024 tokens, two training steps. Every
    attention launch on its route past 256 (``route_launches`` against
    ``tier_of``: the 16-bit cluster forms (B11 the column groups at D
    512), f32's cluster form and the wide split decode).
    Returns the kernels line's rows past 256."""
    import dataclasses
    import torch
    from accl_tpu_torch.models import Llama
    from accl_tpu_torch.ops import attention as A
    recs = []
    for dt, S, seed, path in ((torch.bfloat16, D512_S, D512_SEED,
                               "model_d512"),
                              (torch.float32, D512_F32_S, D512_F32_SEED,
                               "model_d512_f32")):
        cfg = d512_config(dt)
        need(cfg.head_dim == 512, f"head dim {cfg.head_dim}")
        g = torch.Generator(device="cuda").manual_seed(seed)
        serve_cfg = dataclasses.replace(cfg, param_dtype=dt)
        model = Llama(serve_cfg).init(g)
        tokens = torch.randint(0, cfg.vocab_size, (1, S), device="cuda",
                               generator=g)
        before = dict(A.route_launches)
        rels = []
        with torch.no_grad():
            for toks in (tokens, tokens[:, :HD_B9_S]):
                logits = model(toks)
                need(bool(torch.isfinite(logits).all()),
                     f"{path}: non-finite logits")
                model.config = dataclasses.replace(serve_cfg,
                                                   attention="dense")
                try:
                    ref = model(toks)
                finally:
                    model.config = serve_cfg
                rels.append(float(torch.linalg.vector_norm(
                    (logits - ref).float())
                    / torch.linalg.vector_norm(ref.float())))
                del logits, ref
            out = model.generate(tokens, max_new=D512_NEW)
        need(out.shape == (1, D512_NEW) and bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()),
            f"{path}: generate's tokens")
        need(max(rels) <= SERVE_DENSE_REL, f"{path}: flash and dense "
             f"differ: {rels}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        model = Llama(cfg).init(g)           # f32 parameters for Adam
        step = model.make_train_step(torch.optim.Adam(model.parameters(),
                                                      lr=1e-4))
        steps = D512_STEPS if dt != torch.float32 else D512_F32_STEPS
        losses = [float(step(tokens)) for _ in range(steps)]
        torch.cuda.synchronize()
        routes = routes_since(before)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"D=512 model {path} (dim 4096, 8/1 heads, ffn 16384, 2 "
              f"layers, {str(dt)[6:]} activations): 1x{S} and "
              f"1x{HD_B9_S} forward flash vs dense relative diff {rels} "
              f"(limit {SERVE_DENSE_REL}); generate {D512_NEW} tokens "
              f"{out.tolist()}; losses {losses}; routes {routes}; peak "
              f"{peak:.1f} GiB")
        need(all(np.isfinite(x) for x in losses), f"{path}: non-finite "
             f"loss")
        need(losses[-1] < losses[0], f"{path}: the loss did not fall: "
             f"{losses}")
        want = {tier_of(kind, str(dt)[6:], 512) for kind in (
            "fwd", "fwd_single", "prefill", "decode", "bwd_dkv", "bwd_dq")}
        need(routes and set(routes) <= want, f"{path}: a launch off the "
             f"routes past 256 (the column-group, cluster and split forms "
             f"{sorted(want)}): {routes}")
        per_run = cfg.n_layers * steps       # B10 and B11: a layer a step
        need({k: n for k, n in routes.items() if k[0].startswith("bwd")}
             == {tier_of(kind, str(dt)[6:], 512): per_run
                 for kind in ("bwd_dkv", "bwd_dq")},
             f"{path}: B10/B11 not once a layer a step on their "
             f"route past 256: {routes}")
        del model, step, tokens, out
        gc.collect()
        torch.cuda.empty_cache()
        recs += d512_records(dt, S, S + D512_NEW, path, routes)
        gc.collect()
        torch.cuda.empty_cache()
    return recs


def phase(name: str):
    """One line at the start of each phase: the seconds since the script
    started and what the device holds."""
    import torch
    print(f"== {name} at {time.perf_counter() - T_START:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    phase("phase 1: device and build")
    phase_device()
    rng = np.random.default_rng(SEED)
    phase("phase 2: kernel corpora and records")
    corpus_combine(rng)
    corpus_codec(rng)
    corpus_lanes(rng)
    stream_kernels_checked()
    fp8_combine_checked()
    stream_edges(rng)
    bs_edges(rng)
    recs = kernel_records()
    phase("phases 3-4: collectives main path")
    main_path(recs)
    gc.collect()                      # the rank worlds' buffers sit in cycles
    torch.cuda.empty_cache()
    phase("phase 3b: B1 on fp8 payloads")
    fp8_payload_phase(recs)
    phase("phase 4b: point-to-point and local ops")
    p2p_path(recs)
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 4c: one-sided RMA")
    rma_path(recs)
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 12: call contract, membership, uneven exchanges")
    elastic_phase(recs)
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 13: the tuner and the N-tier hierarchy")
    hier_phase(recs)
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 14a-c: profiler, flight recorder, tenants, tuning table")
    driver_phase(recs)
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 5: attention kernels")
    tf32_kernels_checked()
    attention_edges(rng)
    attention_long_f32()
    attn_recs = attention_records()
    zero_attention_counters()         # the f32 model path's own counts
    phase("phase 6: f32 model, flash vs dense")
    llama_model_phase()
    by_path = {"model_f32": attention_counters()}
    print(f"model phase launches: {by_path['model_f32']}")
    need(by_path["model_f32"]["attn_fwd_single"] > 0,
         "model phase: B9 never launched")
    need_routes(by_path["model_f32"], False, "model phase")
    phase("phase 7: serving")
    # each path (7, 7b and 10b) zeroes the counts itself
    (by_path["serving"], by_path["disaggregated"], sp_fwd,
     tp_serve) = serving_phase()
    phase("phase 8: attention backward kernels")
    wgmma_kernels_checked()
    cols_kernels_checked()
    attention_bwd_edges(rng)
    attn_recs += attention_bwd_records()
    phase("gradient check: flash vs dense, f32")
    by_path["grad_check"] = grad_check_phase()
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 9: training")
    held = torch.cuda.memory_allocated()
    need(held < 2 * 2 ** 30, f"{held / 2 ** 30:.2f} GiB still allocated "
         f"before the training phase (limit 2 GiB)")
    # phases 9, 10d and 11c zero the counts themselves
    by_path["training"], sp_train, tp_train = training_phase()
    # the sequence-parallel path: the sp forward (10b) and training (10d)
    by_path["sp"] = {k: sp_fwd[k] + sp_train[k] for k in sp_fwd}
    # the tensor-parallel path: serving (11a) and training (11c)
    by_path["tp"] = {k: tp_serve[k] + tp_train[k] for k in sp_fwd}
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 14d: DDP bucketed gradient all-reduce")
    held = torch.cuda.memory_allocated()
    need(held < 2 * 2 ** 30, f"{held / 2 ** 30:.2f} GiB still allocated "
         f"before the DDP phase (limit 2 GiB)")
    ddp = ddp_phase()
    by_path["ddp"] = {k: ddp[k] for k in sp_fwd}
    add_path(recs, "ddp", {k: ddp[k] for k in ("combine", "cast")})
    gc.collect()
    torch.cuda.empty_cache()
    # phase 15: the MoE Llama (15a, 15b), expert parallelism, the pipeline
    moe = moe_llama_phase()
    for path, counts in moe.items():
        by_path[path] = {k: counts[k] for k in sp_fwd}
        add_path(recs, path, counts)
    # phase 16: checkpoint/resume, the multi-slice tier, the dry run
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 16a: checkpoint/resume on the training path")
    held = torch.cuda.memory_allocated()
    need(held < 2 * 2 ** 30, f"{held / 2 ** 30:.2f} GiB still allocated "
         f"before phase 16a (limit 2 GiB)")
    by_path["checkpoint"] = {k: v for k, v in checkpoint_phase().items()
                             if k in sp_fwd}
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 16b: the multi-slice tier on 8 virtual ranks")
    launched, digests = multislice_phase()
    add_path(recs, "multislice", launched)
    phase("phase 16c: two processes, one slice each, over gloo")
    add_path(recs, "multiprocess", multiprocess_phase(digests))
    phase("phase 16e: the dry run of every parallelism axis")
    attn, stream = dryrun_phase()
    by_path["dryrun"] = {k: attn[k] for k in sp_fwd}
    add_path(recs, "dryrun", stream)
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 17a: the attention kernels on every dtype and head dim")
    f16_recs, band_recs = head_dim_phase()
    attn_recs += f16_recs
    gc.collect()
    torch.cuda.empty_cache()
    phase("phase 17f: split decodes on two streams")
    two_stream_phase()
    phase("phase 17b: f16 Llama-3-8B serving")
    by_path["serving_f16"] = f16_serving_phase()
    phase("phase 17c: f16 training")
    by_path["training_f16"] = f16_training_phase()
    phase("phase 17d: the Llama at D = 256")
    head_dim_256_model_phase()
    phase("phase 17e: the Llama at D = 512, the routes past 256")
    wide_recs = head_dim_512_model_phase()
    phase("phase 10a: ring attention and Ulysses kernels")
    sp_attention_phase()
    for r in attn_recs:
        # the f32 and f16 records (``*_tf32``, ``*_f16``) count the same
        # wrappers' launches, on their own paths
        key = r["name"].removesuffix("_tf32").removesuffix("_f16")
        r["launches_by_path"] = {p: c[key] for p, c in by_path.items()}
        r["launches"] = r["launches_by_path"][LAUNCH_PATH[r["name"]]]
        need(r["launches"] > 0, f"kernel {r['name']} was never launched on "
             f"the {LAUNCH_PATH[r['name']]} path")
    recs += attn_recs + wide_recs + band_recs
    print(f"total: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--slice-child"]:      # a process of phase 16c
        sys.exit(slice_child(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
