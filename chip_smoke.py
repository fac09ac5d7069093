#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: require CUDA, print the card's name and power limit, turn TF32
   off for matmul and cuDNN;
2. kernels: each of the seven Triton kernels (mvr_update, axpby, add_sub,
   dse_combine, dse_combine_yh, qsgd_quantize, qsgd_dequantize), built from
   the checkout on first launch, is held against its plain PyTorch version
   on the card -- on the 8-node MLP tree as the main path feeds it and on
   one flat buffer of 2**26+3 elements in fp32 and bf16 -- and timed with
   CUDA events on the fp32 buffer beside its HBM bound, its plain version
   and a one-call PyTorch yardstick where one exists.  The two CUDA C++
   kernels (top_k_pack, top_k_unpack), compiled by nvcc from
   src/repro_torch/csrc/ on first launch, are held bit for bit against
   their plain versions on the MLP's four leaves at ratio 0.1 and on
   N=8, d=2**24+3, k=ceil(0.1 d), in fp32 and bf16 (the pack in fp16
   too), with indices in magnitude order as the codec makes them, and
   timed there in fp32 and bf16 beside their bounds and the torch.gather /
   zero_ + scatter_add_ yardsticks, with each stage's device time (count,
   scan, place, tile; the pack's one kernel) and the pack's windowed
   passes against one pass; then repeated indices against the unpack's
   fp32-accumulate mirror, subnormal values, every index in one tile or
   window (timed once), k = d, a ragged last tile, out-of-range indices,
   a model rank's tp shard of Qwen2-VL-2B's embedding at top-k 0.01 (the
   shard's candidates packed; the merged payload's in-shard entries
   unpacked, the rest padded as +0.0 at spread indices) and a row of 4,097
   tiles;
   flash_attention (CUDA C++, src/repro_torch/csrc/flash_attention.cu:
   in bf16 at D=128 and 256 a warp-specialised TMA + wgmma kernel) is held
   against its plain version on Gemma-2 2B's global and local layer shapes
   (B=2, H=8, K=4, S=8192, D=256, softcap 50, window 4096), on the global
   shape without softcap, on Yi-9B's (H=32, K=4, D=128), Qwen1.5-MoE's
   (H=16, K=16, D=128), Arctic's (B=1, S=4096, H=56, K=8, D=128) and
   Zamba2's (H=32, K=32, D=112, zero-padded to the D=128 instance) and
   Qwen2-VL-2B's (H=12, K=2, D=128) at the prefill's B=2, S=8192 and at
   the training step's B=1, S=2048, bf16, SDPA timed beside the seven
   cases it computes, and checked untimed in
   fp32 at S=1024, at a ragged S=1000 (D=112 too) and at phase 3g's fp32
   tp ranks (H=K=8, S=2048, D=128; H=K=16, S=1024, D=112), the first call of
   each case under
   torch.profiler to print its launch's grid, block, registers and shared
   memory; rms_norm (CUDA C++, src/repro_torch/csrc/rms_norm.cu) on 16,384
   rows of Gemma-2's 2304 in bf16, timed with its spread beside F.rms_norm
   (both as CUDA-graph replays of one call),
   and untimed in fp32 on an odd row count; wkv_chunk (CUDA C++,
   src/repro_torch/csrc/wkv_chunk.cu: three passes over groups of chunks)
   at RWKV-6 3B's layer shape (B=2, S=8192, H=40, P=64, chunk 16, bf16
   r/k/v and fp32 logw from the model's first layer on random weights)
   against the plain chunked form, untimed in fp32 too, and against the
   per-token recurrence on decays scaled into the clamp envelope, with the
   grouped carry's PyTorch mirror held to the plain chunked form and each
   pass's launch and device time printed.  The four CUDA sources are built
   side by side, one nvcc each, and each kernel's ptxas report printed.
   Each kernel is timed beside its bound, its plain version (and
   wkv_chunk's plain chunked form) and, where one PyTorch call computes the
   same function, that call (axpby's and rms_norm's with their spread);
3. main paths, each through ``run_method`` at the MLP's full width:
   DSE-MVR (omega=0.5, tau=4, b=16, 200 steps) through the kernels against
   the unfused path on the card and on the CPU from the same index stream,
   then the fused-z state layout and DSE-SGD; the six baselines through the
   kernels against the CPU; DSE-MVR with QSGD-compressed gossip through the
   kernels, plain on the card and plain on the CPU from the same index and
   codec-seed streams (64 steps); ten compressed-gossip configurations of
   DSE-MVR in the same three ways (64 steps): sync+EF top_k:0.1, choco
   top_k:0.1, choco:0.8 top_k:0.1, async(4, 0.5) top_k:0.1, async(4, 0.1)
   raw, rand_k:0.25 (its index draws come from the seed stream on the
   host, the same on every device), low_rank:2, {"params": "choco"} with
   top_k:0.1 and choco top_k:0.1 with overlap, each with its link bytes per
   round; ``compression="identity"`` and ``channel="async:1"`` against the
   uncompressed run, bit for bit.  Launch counts are reset just before and
   read just after each run through the kernels;
3b. the scenario engine on the same problem: ``run_method`` with
   ``scenario=make_scenario(name)`` (no static topology; the same index and
   codec-seed streams).  The ``baseline`` scenario through the kernels
   against the static ring(8) run, bit for bit (metrics, state, launch
   counts); DSE-MVR under ``dropout_ring``, ``straggler_ring``, ``one_peer``,
   ``hetero_clients`` and ``hostile``, GT-HSGD under ``dropout_ring``,
   ``warmup_compress`` with ``top_k:0.1`` and ``async_lossy`` with
   ``async:3``, 64 steps each through the kernels, plain on the card and
   plain on the CPU: final metrics and the consensus, tracking-error and
   spectral-gap streams card against CPU within the run's band,
   ``active_nodes`` exactly, 8 top-k packs and unpacks per event, the async
   run's send-rate and staleness gaps printed, and steps/s on each path;
   then the six uncompressed ones over 200 steps through the kernels and on
   the CPU, the spectral-gap and active-node streams held, the rest printed
   beside the gap a one-ulp change of the initial weights makes on the CPU;
3d. the elastic runtime (``repro_torch.runtime``): the paper MLP at full
   width (the runtime's ``pseudo_mnist``: 196 -> 64 -> 10, 128 samples a
   node, 8 nodes, b=16) trained by DSE-MVR through the kernels for 12
   rounds over 4 worker processes, each with its own CUDA context on the
   card; worker 2 (nodes 4-5) SIGKILLed before round 3, a real 0.4 s
   straggler sleep on worker 0 at round 4, worker 2 respawned before round
   6 and resynced through the on-disk bundle.  Three launches: the dense
   protocol; CHOCO top-k 0.1 with overlap on the packed protocol; the same
   config on the dense protocol, for bytes; the three side by side, a
   thread each (one after another before: the time limit).  Each:
   ``active_log`` and the
   epochs exactly as planned (a round abandoned would bump an epoch), one
   resync, the final leaves bit for bit ``simulate_reference`` run in this
   process on the card through the kernels; that replay's final loss and
   consensus against the replay under ``dispatch_mode("ref")`` and on the
   CPU (from the card's index stream) within rtol 5e-4 (the top-k run 2e-2,
   as phase 3 holds its config); every worker's records show launches of
   every op the replay launched; the packed protocol's framed socket bytes
   below the dense one's.  Prints rounds/s, round, start-up, rejoin and
   resync seconds, socket bytes and each launch's wall time;
3e. the sharded engine (``repro_torch.launch.distributed.make_train_job``
   over a ``NodeMesh``): DSE-MVR through the kernels (tau 3, lr 0.01,
   alpha 0.1, 3 rounds) training Qwen2-VL-2B at full width (d 1536, 12
   heads on 2 KV heads of 128, d_ff 8960, vocab 151,936, tied;
   ``attn_impl="pallas"``, fp32 state, bf16 activations) cut to 1 of 28
   layers, each node a batch of 1 x (256 vision + 1,792 text) tokens.  On
   one process: roll gossip on 4 nodes (ring(4)) through the kernels,
   against dense gossip and against roll under ``dispatch_mode("ref")``,
   within rtol 5e-3 / atol 1e-4 after round 1 (the gap after round 3
   printed); sync QSGD through ``rotation_combine`` and CHOCO top-k 0.01
   on the neighbour wire and on ``wire_mode="dense"``, also on 4 nodes
   (two shifts, so the payload rolls, decodes and sums per shift), the
   two CHOCO wires held to the same band; launches by op checked exactly
   (flash in every layer of every node's 5 forwards a round; axpby 4,
   mvr_update 2, dse_combine 1 a round, each once a ``tree_apply`` bucket:
   5 at this width, the leaves of 2**24 elements or more alone; the
   codecs' per leaf and shift), QSGD's node-link bytes equal to its
   payload's, the neighbour wire at least 4x below the dense wire's; each
   run's peak memory printed.  Cut from 4 layers to 1: at 2 layers the
   roll run's plain twin passes the card (PERF.md).  Then 2 gloo ranks on
   the card, each
   its own process, against a world-1 process, both deterministic
   (``torch.use_deterministic_algorithms``, cuBLAS workspace config): roll
   on 4 nodes for 1 round (2 before phase 3g's codec runs took on the roll
   between gloo ranks: the time limit) and CHOCO on 2 for 2 rounds (its
   replicas carried between them), final params bit for bit by per-node
   fingerprints, process bytes, ms a round and each rank's launches.
   Every run prints ms a round, node-steps/s, peak memory, launches by op
   and the mesh's bytes a round beside the card's name and power limit;
3f. the training CLI, its example and the sweep, on the example's lm-100m
   at full width (12 layers, d 768, 12 heads on 4 KV heads, d_ff 2048,
   vocab 16,384, tied; registered as a config module by the example, as a
   user registers one), seq 128, global batch 8, through the kernels:
   ``examples/decentralized_lm_torch.py --full --use-fused`` at world 1 (one
   node, DSE-MVR tau 4, 3 rounds, the loss falling) and
   ``repro_torch.launch.train --algorithm gt_dsgd --use-fused`` (4 steps:
   ``add_sub`` on the CLI's path), launches checked exactly, and the sweep
   (below), all in this process while the CLI runs over 4 gloo ranks on
   the card (``python -m torch.distributed.run --standalone
   --nproc-per-node 4 chip_smoke.py --train-rank ...``, this file each
   rank's script; the three runs in turn in the one group, one spawn
   where there were three: the time limit) at the reference's layout: 2 nodes x a model
   axis of 2 on ring(2), lm-100m's default tp (the printed
   ``mesh={'data': 2, 'model': 2}`` checked), DSE-MVR tau 2 for 2 rounds
   (3 before phase 3g took on four more runs: the time limit): roll
   gossip, ``--compression qsgd`` and ``--compression top_k:0.01 --channel
   choco``, each rank's ``--telemetry-out`` JSONL read back: the loss at
   every round (falling, the same on every rank), link bytes together equal
   to the byte rule of ``compression/gossip.py`` (model 1's
   ``link_bytes_per_round`` plus the replicated leaves' messages), each
   rank's kernel launches exactly the ops' counts, s a round and peak
   memory by rank; the losses and rank 0's checkpoint of both nodes
   against the same 2 nodes at model 1 in this process (the CLI's flags,
   init and token pipeline): roll within the band, QSGD and CHOCO within
   ``LAYOUT_FLOOR_TIMES`` times the floor of model 1 from its init one
   fp32 ulp up (as phase 3g's codec runs); the sweep:
   ``repro_torch.experiments.sweep --engines sim,sharded --compressors
   identity,qsgd --rounds 4`` at the reference's other defaults: 8 cells, the
   artifacts' schema, finite final losses, the codec kernels launched;
3g. the within-node layouts (``make_train_job(profile=...)`` on a
   ``NodeMesh`` with a model axis of 2: rank d M + m holds model shard m of
   node block d): phase 3e's DSE-MVR (tau 3, lr 0.01, alpha 0.1, roll
   gossip) through the kernels on 1 layer of each model at full width, each
   run on gloo ranks on the one card started by ``python -m
   torch.distributed.run --standalone --nproc-per-node <ranks> chip_smoke.py
   --layout-rank <runs> <dir>`` (this file each rank's script; the runs of
   one node count share a group, each in turn): (a) ``tp`` on
   Qwen2-VL-2B, 2 nodes x model 2 = 4 ranks, 1 x (256 + 1,792) tokens a
   node (flash at 6 heads on 1 KV head a rank); (b) ``fsdp`` on Qwen2-VL-2B,
   2 x (256 + 768) tokens a node, split over the model ranks; (c) ``fsdp``
   (its default profile) on Yi-9B (d 4096, 32 heads on 4 KV heads, d_ff
   11,008, vocab 64,000, untied), 1 node x model 2, 2 x 1,024 tokens;
   (d)-(g) ``tp``, the default profile of the rest, on each one's first
   block unit: RWKV-6 3B (1 layer; ``wkv_chunk`` at 20 of 40 heads a
   rank), Zamba2-7B (2 Mamba-2 layers, 56 of 112 SSM heads a rank, and the
   shared attention, flash at 16 of 32 heads, D 112) and HuBERT X-Large (1
   layer, the plain bidirectional attention at 8 of 16 heads; 1 x 1,500
   frames of 512 features and frame targets drawn on the card), each 2
   nodes x model 2; Qwen1.5-MoE-A2.7B (1 layer, 30 of 60 experts and flash
   at 8 of 16 heads a rank), 1 node x model 2; 1 x 512, 1,024 and 2,048
   tokens a node.  RWKV-6, Zamba2 and Qwen1.5-MoE run twice: in the
   engine's bf16 activations, held to ``LAYOUT_FLOOR_TIMES``
   times the floor of the same round, model 1 against itself from its init
   one fp32 ulp up (in bf16 a tp round's partial sums round apart past the
   band), and in fp32 activations (``LAYOUT_FP32``), held to the band.  Each against the same nodes at model
   1 in this process, run after the group, after round 1 and the last
   round (each rank writes its rows and shards, which the model-1 run
   reads a leaf at a time; (f)'s ranks also gather the whole tree with
   ``TrainJob.full``, held the same way); the loss falling, the same on
   every rank; replicated leaves bit for bit across the model ranks of a
   node (deterministic cuBLAS and algorithms); launches by op and rank
   exactly (flash once a causal attention layer, ``wkv_chunk`` once an
   RWKV layer, a node's forward, none in a backward; the update ops once a
   ``tree_apply`` bucket of the rank's shards); Qwen1.5-MoE's routing
   decisions by round that differ from model 1's (and the floor's), the
   same on both ranks; the model group's movements (tp all-reduces, and
   all-gathers the MoE router's logits and Mamba-2's projection and conv
   weights, reduce-scattering their gradients, to the byte; fsdp
   all-gathers and reduce-scatters); ms a round, peak memory, the model
   group's and the node axis's bytes a round, by rank.  Then the codecs
   and channels on the model axis, in the 2-node group, tp on
   Qwen2-VL-2B as (a), 2 rounds each: sync QSGD (its int8 payload rolled
   through ``rotation_combine``), CHOCO top-k 0.01 on the neighbour wire
   (the merged payload's chunks rolled and joined over the model group),
   async:3 QSGD under ``dropout_ring`` (the allgather, replicated wire, the
   scenario's streams and ``replicated_local`` at model 2); each held to
   ``LAYOUT_FLOOR_TIMES`` times the floor of model 1 with the same codec
   from its init one fp32 ulp up, after rounds 1 and 2; node-link bytes
   over the ranks and the model group's payload and codec bytes to the
   byte by ``compression/gossip.py``'s rule; every model rank of a node
   moved the same payloads and send masks (fingerprints); the codecs'
   launches by rank; the scenario's streams the same on every rank and
   within the band of model 1's.  Node block 0's ranks also encode their tp
   shards of a seeded full-width Qwen2-VL-2B embedding (151,936 x 1,536
   fp32) with QSGD and top-k 0.01: the payload gathered over the model
   group and the decoded shard are the whole leaf's in this process, bit
   for bit (chunked fingerprints).  Cuts, no width: 1
   block unit of each model (as phase 3e), Yi-9B and Qwen1.5-MoE on 1 node
   (two nodes of their state do not fit the card), the batches above, the
   fsdp runs to 1 round, (a) to 1 (the codec runs take its path, 2 rounds
   each), the fp32 twins to 1 (their bf16 runs keep round 2) and the rest
   to 2 (the time limit; see ``LAYOUT_RUNS``);
4. the LM serving path at Gemma-2 2B's full width (26 layers, d 2304,
   vocab 256,000; random bf16 weights from a seed): ``make_serve_job(...).
   prefill_fn`` with ``attn_impl="pallas"`` on 2 prompts of 8192 tokens,
   through the kernel (26 flash_attention launches a call) and through the
   plain version on the card; one more kernel call under torch.profiler:
   device time by kernel (top 10), the attention, GEMM and other shares and
   the device's idle share; the same prefill in fp32 at B=1, kernel
   against plain (at 6 layers within 1e-3, at 26 within twice the gap of
   the plain path's blockwise twin); the kernel prefill against
   ``scan_prefill`` through
   decode steps (fp32, B=2, S=128); then ``serve.main`` and a 4-slot
   ``RequestDriver`` of 8 requests through the bf16 ``decode_fn``;
4b. Qwen1.5-MoE-A2.7B at full width (24 layers, 60 routed experts top-4
   and 4 shared, vocab 151,936; random bf16 weights from a seed, about
   14.3 B parameters): ``prefill_fn`` on 2 prompts of 8192 tokens, kernel,
   kernel, plain, kernel (24 flash launches a call), one more call under
   torch.profiler split into the attention kernel, the MoE dispatch
   scatter and combine gather (the kernels launched inside the model's
   ``repro/moe_dispatch`` and ``repro/moe_combine`` ranges), the other
   GEMMs and the rest; one bf16 prefill each in the 'gather_tokens' layout
   (auto's bits) and the 'grouped' one (16 groups: tokens/s and dropped
   entries beside auto's); the fp32 prefill at B=1 on the first 4 layers,
   kernel against plain within twice the blockwise twin's gap, with the
   tokens whose top-4 sets differ at each layer; ``prefill_fn`` against
   ``scan_prefill`` (fp32, 2 x 128, 4 layers, capacity factor raised to 8
   so that the prefill drops no token, which is checked); ``serve.main``
   (fp32) and a 4-slot bf16 ``RequestDriver``; then Arctic 480B at full
   width on 1 of its 35 layers (about 14.1 B parameters): the bf16
   prefill of 1 x 4096, kernel against plain;
4c. Zamba2-7B at full width (27 x (mamba, mamba, shared_attn), d 3584,
   vocab 32,000, about 4.5 B parameters): the same bf16 prefill of 2 x
   8192 (27 flash launches at D=112 a call), traced into the attention
   kernel, the SSD scan (the kernels inside the ``repro/ssd_scan``
   ranges), the other GEMMs and the rest; the fp32 prefill at B=1, kernel
   against plain (1e-3 of the logits' max at 6 layers, twice the blockwise
   twin's gap at 81); ``prefill_fn`` against ``scan_prefill`` on the 6
   layers (fp32, 2 x 128, logits and SSM states); ``serve.main`` and a
   4-slot bf16 ``RequestDriver``;
4d. Qwen2-VL-2B at full width (28 layers, d 1536, 12 heads on 2 KV heads
   of 128, vocab 151,936, M-RoPE; random bf16 weights from a seed, about
   1.5 B parameters): ``prefill_fn`` on 2 x (256 random vision embeddings
   + 7,936 text tokens), kernel, kernel, plain, kernel (28 flash launches a
   call), one more call traced; the fp32 prefill at B=1, kernel against
   the flash op's plain version (never the xla / blockwise twin, which
   masks the vision block by its temporal positions: another function),
   within 1e-3 of the logits' max abs at 4 layers and 1e-2 at 28;
   ``serve.main`` (fp32, text prompts) and a 4-slot bf16 ``RequestDriver``;
   then HuBERT X-Large at full width (48 bidirectional layers, d 1280, 16
   heads of 80; about 0.95 B parameters): ``Model.forward`` in bf16 under
   ``torch.inference_mode()`` on 8 clips of 1,500 frames of 512-dim random
   features, frames/s, peak memory and a trace (no kernel: its attention
   is the plain ``_sdpa``), and fp32 on 2 full-width layers, the card
   against the CPU within rtol 1e-4 and an atol of 1e-4 of the logits' max;
4e. LM training on the card: Qwen2-VL-2B at full width, fp32 parameters,
   bf16 activations, 1 x (256 + 1,792) tokens: ``Model.loss`` then
   ``torch.autograd.grad`` (28 flash launches in the forward, none in the
   backward, which differentiates the op's plain version), 3 plain SGD
   steps of lr 0.03 on one batch, the loss falling at each, ms a step and
   peak memory, one more step's loss and gradients traced; the gradients at 4 layers in fp32, the kernel's forward
   against the plain one's, each leaf within 1e-4 of its max |gradient|;
4f. serving while training, on phase 4e's model, batch and lr: after each
   of 4 SGD steps (gradients freed first) the live fp32 parameters are
   published to three ``ReplicaSet``s -- ``qsgd`` with bounds (1, 2) (one
   ``qsgd_quantize`` and ``qsgd_dequantize`` launch a leaf), ``top_k:0.01``
   with bound 1 (one ``top_k_pack`` and ``top_k_unpack`` a leaf; the
   largest leaf's row is 23,520 tiles, the unpack's global-atomic path)
   and an ``identity`` mirror, which must equal the live parameters bit for
   bit after every step, in storage of its own, and keep its bits after the
   next in-place update; publish ms (the first apart), launches, the SLO,
   link bytes against ``message_bytes``, the served error against live and
   the peak memory; replica 0 of the QSGD set and the live parameters each
   serve a bf16 prefill of 2 x (256 + 1,792) through ``prefill_fn`` (28
   flash launches), tokens/s and greedy tokens side by side; one publish of
   each lossy set through the kernels against ``dispatch_mode("ref")`` from
   the same state and seeds (top-k bit for bit, QSGD within the codec's
   band), and the top-k pair at the largest leaf timed, the unpack by
   stage; 4 more steps publishing ``top_k:0.01`` through a ``SnapshotFeed``
   to a ``RemoteReplica`` over localhost (4 messages pulled, then 0; its
   state equal to the feed's; tx bytes against 4 x ``message_bytes``);
   then ``examples/serve_while_training_torch.py`` (its default size) and
   ``examples/quickstart_torch.py --smoke`` in process, their asserts live;
4g. the mesh-sharded serve job (``make_serve_job(cfg, mesh)`` on a
   ``NodeMesh`` of 2 data ranks x a model axis of 2 = 4 gloo ranks on the
   one card, started by ``python -m torch.distributed.run --standalone
   --nproc-per-node 4 chip_smoke.py --serve-rank <dir>``, this file each
   rank's script): Gemma-2 2B (its block unit ``("local", "attn")``, flash
   at 4 of 8 heads a rank with the window and softcap), RWKV-6 3B
   (``wkv_chunk`` at 20 of 40 heads), Zamba2-7B (56 of 112 SSM heads, the
   conv window gathered a decode step, flash at 16 of 32 heads, D 112) and
   Qwen1.5-MoE-A2.7B (30 of 60 experts, flash at 8 of 16 heads), each at
   full width on one block unit (``layout_config``), fp32 parameters from a
   seed, each rank's shard cut from the whole tree; 4 prompts of 512
   tokens (2 a data rank) through ``prefill_fn`` twice (the second timed),
   then 8 decode steps through a ``RequestDriver(..., job=job)`` on
   ``job.decode_fn``.  The group is spawned as phase 4 begins and sets up
   while phases 4-4f run; its ranks then wait for this phase's ``go``.
   Model 1 is the one-device job on the whole batch in this process, run
   before the go: its greedy decode gives the token stream both are fed (a
   rank's requests are its rows' first token and that stream, teacher
   forced), so that one flipped token does not carry on.  In bf16 (the
   job's activations) each rank's logits after the prefill and at every
   step within ``LAYOUT_FLOOR_TIMES`` times the floor, model 1 against
   itself with its parameters one fp32 ulp up on the same stream; Zamba2
   in fp32 activations too, within the band, its greedy tokens model 1's;
   greedy disagreements printed; every model rank of a data rank the same
   logits bit for bit; launches by rank exactly (flash once a causal
   attention layer a prefill call, ``wkv_chunk`` once an RWKV layer, none
   in a decode step).  The MoE's data ranks queue the whole batch once
   (one exchange of the per-expert counts a layer), so model 1 is the
   whole batch for every arch.  Prints prefill tokens/s and
   ms a decode step by rank, peak memory by rank against model 1's and the
   model group's bytes a step.  Cuts, no width: one block unit; 8 decode
   steps, not 16 (the time limit, with every serving path's ``serve.main``
   and ``RequestDriver`` sizes, ``MAIN_SERVE``);
5. RWKV-6 3B at full width (32 layers, d 2560, 40 heads of 64, vocab
   65,536; random bf16 weights from a seed): ``prefill_fn`` with
   ``rwkv_chunk=16, rwkv_pallas=True`` on 2 prompts of 8192 tokens, three
   calls of 32 wkv_chunk launches, against the plain chunked twin (layer
   0's state within 1e-5); one more kernel call under torch.profiler:
   device time by kernel (top 10), the wkv, GEMM and other shares and the
   device's idle share; the share of clamped (chunk, channel) pairs at
   three layers; the fp32 prefill at B=1, S=2048, kernel against the plain
   chunked path (relative 1e-3 at 4 layers, 1e-2 at 32); the kernel
   prefill's caches against ``scan_prefill`` and 4 decode steps on (fp32,
   B=2, S=128, decays inside the clamp envelope); ``serve.main`` and a
   4-slot ``RequestDriver`` through the bf16 ``decode_fn``;
6. a ``{"kernels": [...]}`` line (with each op's phase 3d launches by
   worker, ``elastic_launches``, phase 3e's by process,
   ``sharded_launches``, phase 3f's by run and rank, ``cli_launches``, and
   phase 3g's by run and rank, ``layout_launches``, and phase 4g's by run
   and rank, ``serve_layout_launches``),
   then the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import importlib.metadata
import json
import math
import resource
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

STEPS, TAU, BATCH, OMEGA = 200, 4, 16, 0.5
QSGD_STEPS = 64
BIG_N = 2**26 + 3
TOP_K_BIG_D = 2**24 + 3        # per node; N = 8 nodes
TOP_K_RATIO = 0.1
REPS = 25
# fp32 kernel vs plain: FMA contraction in the kernel may move one ulp
RTOL32 = ATOL32 = 1e-6
# qsgd_quantize vs plain: at most this share of levels may differ, by one
FLIP_BUDGET = 1e-4
# run vs run (kernels vs plain on the card vs plain on the CPU): fp32
# reassociation (cuBLAS vs CPU GEMM, FMA) drifts over 200 steps
RUN_RTOL, RUN_ATOL, ACC_TOL = 5e-4, 1e-5, 2e-3
# the scenario phase's fault and heterogeneity presets on DSE-MVR.  They
# are held card against CPU over SCENARIO_STEPS: over STEPS these dynamics
# amplify a one-ulp change of the initial weights on the CPU alone to 5e-4
# (dropout_ring) up to 0.4 (one_peer) of the consensus stream (ROADMAP
# queue 3), so there the runs are compared only where the trajectory does
# not enter (the spectral-gap and active-node streams) and printed
SCENARIO_RUNS = ("dropout_ring", "straggler_ring", "one_peer", "hetero_clients", "hostile")
SCENARIO_STEPS = 64
# compressed runs, held over QSGD_STEPS: an ulp that moves |x|*L + u across
# an integer flips one int8 level, error feedback carries it and later
# steps compound it.  On the CPU the port lies 1e-3 from the reference after
# 64 steps (tests/test_torch_compression.py)
QSGD_RTOL, QSGD_ACC_TOL = 5e-3, 5e-3
FP32_PEAK_FLOPS = 67e12          # H100 SXM, fp32 outside the tensor cores
BASELINES = ("dlsgd", "dsgd", "gt_dsgd", "gt_hsgd", "pd_sgdm", "slowmo_d")
# difference gossip with a sparsifier: x - x_hat cancels, so the ulps by
# which cuBLAS, the CPU's GEMM and Triton's FMAs differ become relative
# gaps of 1e-4 in the top-k input, and a near-tie at the k-th magnitude
# then swaps an index and the replicas carry it on.  On the CPU against the
# reference, choco:0.8 top-k first swaps at event 5 of 16 and ends 6.7e-3
# apart on consensus (ROADMAP queue 3); these runs are held to 2e-2
CHOCO_BAND = ("choco_top_k0.1", "choco0.8_top_k0.1", "async4_thr0.5_top_k0.1",
              "choco_overlap_top_k0.1")
CHOCO_RTOL = 2e-2
MLP_SHAPES = {"w1": (8, 196, 64), "b1": (8, 64), "w2": (8, 64, 10), "b2": (8, 10)}
# the elastic runtime (phase 3d): the paper MLP at full width (the runtime's
# pseudo_mnist problem: 196 -> 64 -> 10, 128 samples a node, 8 nodes) over
# ELASTIC_WORKERS worker processes, each with its own CUDA context on the
# one card; worker 2 (nodes 4-5) killed before round ELASTIC_KILL, a real
# ELASTIC_SLEEP s straggler sleep on worker 0 at round ELASTIC_SLEEP_AT,
# worker 2 respawned before round ELASTIC_REJOIN; the runtime's default lr,
# tau and alpha, every update through the kernels (use_fused)
ELASTIC_WORKERS, ELASTIC_ROUNDS, ELASTIC_BATCH = 4, 12, 16
ELASTIC_KILL, ELASTIC_SLEEP_AT, ELASTIC_REJOIN, ELASTIC_SLEEP = 3, 4, 6, 0.4
ELASTIC_CHOCO = (("channel", "choco"), ("compression", "top_k:0.1"), ("overlap", True))
# the sharded engine (phase 3e): Qwen2-VL-2B at full width (d 1536, 12 heads
# on 2 KV heads of 128, d_ff 8960, vocab 151,936, tied), attn_impl "pallas",
# fp32 state, bf16 activations, depth cut to SHARD_LAYERS of 28 layers (at
# 2 layers the roll run peaks at 66.3 GiB and the plain versions' run runs
# out of the card; the 233 M-parameter tied embedding is most of a node);
# DSE-MVR through the kernels (use_fused), tau SHARD_TAU, each node a batch
# of 1 x (256 vision + TRAIN_TEXT) tokens, the same batches for every run;
# runs held to the reference's band between its sharded job and its
# single-device path.  Every run takes 4 nodes on ring(4) (two shifts): the
# codec runs fit the card since their whole-tree temporaries went
# (scripts/sharded_memory_probe.py; PERF.md)
SHARD_NODES = SHARD_QSGD_NODES = SHARD_CHOCO_NODES = 4
# the 2-rank group's runs (two ranks share the card, each with its own
# state): tag -> (nodes, rounds); roll on 4 nodes, 1 round (2 before phase
# 3g's codec runs took on the roll between gloo ranks; the time limit),
# CHOCO on 2 (one a rank), 2 rounds (its replicas carried between them)
SHARD_GROUP_RUNS = {"roll": (4, 1), "choco": (2, 2)}
SHARD_TAU, SHARD_ROUNDS = 3, 3
SHARD_LAYERS = 1
SHARD_LR, SHARD_ALPHA, SHARD_TOP_K = 1e-2, 0.1, "top_k:0.01"
SHARD_RTOL, SHARD_ATOL = 5e-3, 1e-4
SHARD_DEADLINE = 900   # s, a spawned world of phase 3e
# the within-node layouts (phase 3g): each node spread over LAYOUT_MODEL
# gloo ranks on the one card (a data x model mesh, rank d M + m), started by
# torch.distributed.run with this file as each rank's script; phase 3e's
# DSE-MVR (tau, lr, alpha, roll gossip, the kernels), the first block unit
# of each model at full width (attn_impl "pallas"; RWKV through wkv_chunk);
# each run held to the same nodes at model 1 in this process after round 1
# and the last round (phase 3e's band).  Cuts: depth to one block unit (as
# phase 3e: the 233 M-parameter Qwen2-VL embedding is most of a node), 2
# nodes for Qwen2-VL-2B, RWKV-6 3B (about 0.42 B parameters a node),
# Zamba2-7B (0.48 B) and HuBERT X-Large and 1 for Yi-9B and Qwen1.5-MoE (4
# ranks of their state do not fit the card beside each other: about 0.70 B
# and 1.19 B parameters a node, at about 40 bytes of a node's state a
# parameter), the batches below (RWKV-6 on 512 tokens a node: its training
# backward recomputes the plain per-token recurrence, 8-10 s a round at
# 1,024 in fp32; Zamba2 on 1,024: host staging, 8-10 s a round at 2,048 in
# fp32), and the rounds below (an fsdp round moves the whole tree through the host twice a
# gradient, 10-23 s a round on the card): the smoke's time limit holds
# every phase
LAYOUT_MODEL = 2
# run -> (arch, profile, nodes, node batch, text tokens (HuBERT: frames) a
# row, rounds)
LAYOUT_RUNS = {
    # 1 round (2 before the codec runs below took on its path, each 2)
    "tp_qwen2_vl": ("qwen2-vl-2b", "tp", 2, 1, 1792, 1),      # phase 3e's batch
    "tp_qwen2_vl_qsgd": ("qwen2-vl-2b", "tp", 2, 1, 1792, 2),
    "tp_qwen2_vl_choco": ("qwen2-vl-2b", "tp", 2, 1, 1792, 2),
    "tp_qwen2_vl_async_dropout": ("qwen2-vl-2b", "tp", 2, 1, 1792, 2),
    "fsdp_qwen2_vl": ("qwen2-vl-2b", "fsdp", 2, 2, 768, 1),   # splits over the 2 ranks
    "fsdp_yi_9b": ("yi-9b", "fsdp", 1, 2, 1024, 1),
    "tp_rwkv6": ("rwkv6-3b", "tp", 2, 1, 512, 2),
    "tp_zamba2": ("zamba2-7b", "tp", 2, 1, 1024, 2),
    "tp_hubert": ("hubert-xlarge", "tp", 2, 1, 1500, 2),
    "tp_qwen2_moe": ("qwen2-moe-a2.7b", "tp", 1, 1, 2048, 2),
    # the fp32 twins 1 round (2 before: the time limit; their bf16 runs
    # keep round 2, where the loss must fall)
    "tp_rwkv6_fp32": ("rwkv6-3b", "tp", 2, 1, 512, 1),
    "tp_zamba2_fp32": ("zamba2-7b", "tp", 2, 1, 1024, 1),
    "tp_qwen2_moe_fp32": ("qwen2-moe-a2.7b", "tp", 1, 1, 2048, 1),
}
# RWKV-6, Mamba-2 and the MoE in bf16 activations (the engine's own path):
# a tp round rounds each row-parallel partial sum to bf16 before the fp32
# all-reduce, which moves RWKV-6's and the MoE's rounds past the band from
# model 1, so these runs are held to LAYOUT_FLOOR_TIMES times the floor of
# the same round: model 1 against itself from its init one fp32 ulp up,
# which the same bf16 roundings (and the MoE's flipped routes) amplify as
# far (PERF.md §6: the tp gap 0.8-1.5 times the floor)
LAYOUT_FLOOR = ("tp_rwkv6", "tp_zamba2", "tp_qwen2_moe", "tp_qwen2_vl_qsgd", "tp_qwen2_vl_choco",
                "tp_qwen2_vl_async_dropout")
LAYOUT_FLOOR_TIMES = 4
# the codecs and channels on a model axis: run -> (make_train_job
# keywords, scenario preset or None).  Sync QSGD rolls its int8 payload
# through rotation_combine; CHOCO top-k 0.01 rolls the merged payload's
# chunks on the neighbour wire; async:3 QSGD under dropout_ring takes the
# allgather (replicated) wire.  Each is held to LAYOUT_FLOOR_TIMES times the
# floor of model 1 with the same codec (in bf16 a tp round's roundings flip
# QSGD levels and top-k picks at the cut past the band, as an ulp of the
# init does at model 1; PERF.md's prediction for these runs)
LAYOUT_CODECS = {
    "tp_qwen2_vl_qsgd": (dict(compression="qsgd"), None),
    "tp_qwen2_vl_choco": (dict(channel="choco", compression="top_k:0.01"), None),
    "tp_qwen2_vl_async_dropout": (dict(channel="async:3", compression="qsgd"), "dropout_ring"),
}
# the codec-level check in the group: each rank of node block 0 encodes its
# tp shard of a seeded full-width Qwen2-VL-2B embedding (151,936 x 1,536
# fp32) with each codec; its payload gathered over the model group and its
# decoded shard are the whole leaf's, bit for bit (chunked fingerprints)
LAYOUT_LEAF_CODECS = ("qsgd", "top_k:0.01")
# the runs a node count's group runs as its first stage, apart from the
# rest: the rank files of one stage at a time fit the machine's disk
LAYOUT_STAGE_FIRST = ("tp_qwen2_vl",) + tuple(LAYOUT_CODECS)
LAYOUT_LEAF_SEED = 0x5EED
# and their twins in fp32 activations (Model.loss wrapped; the engine asks
# for bf16), each and its model-1 run: held to the band, as the rest
LAYOUT_FP32 = ("tp_rwkv6_fp32", "tp_zamba2_fp32", "tp_qwen2_moe_fp32")
# the run whose ranks also gather their parameters over both axes with
# TrainJob.full (the rest write their own rows and shards): the cheapest
LAYOUT_FULL = ("tp_hubert",)
# the block kinds that run attention (through flash where causal)
ATTENTION_KINDS = ("attn", "local", "moe", "shared_attn")
LAYOUT_DEADLINE = 900  # s, a spawned group of phase 3g
# the mesh-sharded serve job (phase 4g): make_serve_job(cfg, mesh) over
# SERVE_DATA data ranks x a model axis of SERVE_MODEL gloo ranks on the one
# card, each model at full width on its first block unit (layout_config:
# flash at the ranks' heads, wkv_chunk at RWKV-6's), fp32 parameters from
# SERVE_SEED, a batch of SERVE_BATCH prompts of SERVE_PROMPT tokens (a data
# rank's half of them) through prefill_fn, then SERVE_STEPS decode steps
# through a RequestDriver on job.decode_fn; in bf16 activations (the job's)
# held to LAYOUT_FLOOR_TIMES times the floor of model 1 against itself one
# fp32 ulp up, and SERVE_FP32's runs in fp32 activations too, held to the
# band with the greedy tokens equal
SERVE_ARCHS = ("gemma2-2b", "rwkv6-3b", "zamba2-7b", "qwen2-moe-a2.7b")
SERVE_DATA, SERVE_MODEL = 2, 2
# (16 decode steps before: the time limit)
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 512, 8
SERVE_FP32 = ("zamba2-7b",)   # Mamba-2's conv window gathered a step
SERVE_SEED = 7
SERVE_DEADLINE = 600   # s, the spawned group of phase 4g from its go
# the group starts with phase 4 and sets up while phases 4-4f run here (its
# ranks then wait for the go of phase 4g: the time limit)
SERVE_WAIT = 1500      # s, a rank's wait for the go
# the CLI and the sweep (phase 3f): the example's lm-100m at full width (12
# layers, d 768, 12 heads on 4 KV heads, d_ff 2048, vocab 16,384, tied;
# attn_impl "xla", the reference's default, so no flash launch), seq 128,
# global batch 8, lr CLI_LR, DSE-MVR through the kernels.  World 1: the
# example (tau 4,
# CLI_EXAMPLE_ROUNDS rounds) and GT-DSGD (CLI_GT_STEPS steps).  CLI_WORLD
# gloo ranks on the card at the reference's layout, 2 nodes x model 2 on
# ring(2) (one node a rank on ring(4) before), each its own process
# started by torch.distributed.run: tau CLI_GROUP_TAU, CLI_GROUP_ROUNDS
# rounds, roll gossip, QSGD and CHOCO top-k 0.01.  Then the sweep at the
# reference's defaults on both engines, uncompressed and with QSGD
CLI_EXAMPLE_ROUNDS, CLI_GT_STEPS, CLI_GROUP_ROUNDS, CLI_GROUP_TAU, CLI_WORLD = 3, 4, 2, 2, 4
# the sweep's rounds a cell (the reference's default is 16); the groups'
# rounds were 3: both cut for the smoke's time limit when phase 3g took on
# four more runs
CLI_SWEEP_ROUNDS = 4
CLI_GROUP_RUNS = {"roll": [], "qsgd": ["--compression", "qsgd"],
                  "choco": ["--compression", "top_k:0.01", "--channel", "choco"]}
CLI_LR = 0.01   # the example's 0.1 diverges on lm-100m, in the reference too
CLI_FLAGS = ["--arch", "lm-100m", "--seq-len", "128", "--global-batch", "8", "--lr",
             str(CLI_LR), "--use-fused"]
CLI_DEADLINE = 600     # s, a spawned group of phase 3f
CLI_TOKENS: dict = {}  # the CLI's token stream by vocabulary, for the model-1 twins
# the LM serving path: Gemma-2 2B at full width, prompts of its 8192 context
LM_ARCH, LM_BATCH, LM_SEQ = "gemma2-2b", 2, 8192
# every full-width serving path's serve.main and RequestDriver (phases 4-5):
# serve.main of MAIN_SERVE = (requests, prompt tokens, new tokens); a 4-slot
# driver of 8 requests of DRIVER_PROMPTS = (fewest, most) prompt tokens and
# DRIVER_NEW new ones.  Cut for the time limit (8 x 128 + 32 for
# Gemma-2 and RWKV-6 and 4 x 64 + 16 for the rest before; the drivers'
# prompts 16-96 or 16-48 tokens and 16 new ones): host-bound decode loops
MAIN_SERVE, DRIVER_PROMPTS, DRIVER_NEW = (4, 16, 8), (4, 12), 8
# fp32 flash_attention and rms_norm vs plain: other summation orders, the
# hardware's rsqrt; bf16 within one bf16 ulp beyond that
ATT_RTOL = ATT_ATOL = 1e-5
# fp32 last-token logits of the kernel prefill vs the plain one (capped at
# +-30), at 6 of the 26 layers (see serving_path); prefill vs decode steps:
# the repo's own prefill-vs-decode tolerance (tests/test_arch_smoke.py)
LOGIT_TOL, PREFILL_DECODE_TOL = 1e-3, 2e-3
BF16_PEAK_FLOPS = 989e12         # H100 SXM, dense bf16 tensor cores
# timed flash_attention cases at the serving path's shapes, bf16:
# (label, B, H, K, S, D, window, softcap)
FLASH_CASES = (
    ("gemma2_global", 2, 8, 4, LM_SEQ, 256, None, 50.0),
    ("gemma2_local", 2, 8, 4, LM_SEQ, 256, 4096, 50.0),
    ("gemma2_global_nocap", 2, 8, 4, LM_SEQ, 256, None, None),
    ("yi_9b", 2, 32, 4, LM_SEQ, 128, None, None),
    ("qwen2_moe", 2, 16, 16, LM_SEQ, 128, None, None),
    ("arctic", 1, 56, 8, 4096, 128, None, None),
    ("zamba2", 2, 32, 32, LM_SEQ, 112, None, None),   # zero-padded to the 128 instance
    ("qwen2_vl", 2, 12, 2, LM_SEQ, 128, None, None),
    ("qwen2_vl_train", 1, 12, 2, 256 + 1792, 128, None, None),   # phase 4e's forward
    # phase 3g's ranks: tp's 6 heads on 1 KV head; fsdp's share of a node batch
    ("qwen2_vl_tp", 1, 6, 1, 256 + 1792, 128, None, None),
    ("qwen2_vl_fsdp", 1, 12, 2, 256 + 768, 128, None, None),
    ("yi_9b_fsdp", 1, 32, 4, 1024, 128, None, None),
    # and tp's heads of Qwen1.5-MoE and of Zamba2's shared attention
    ("qwen2_moe_tp", 1, 8, 8, 2048, 128, None, None),
    ("zamba2_tp", 1, 16, 16, 1024, 112, None, None),
    # phase 4g's ranks: a data rank's 2 prompts at the model rank's heads
    ("gemma2_serve_tp", 2, 4, 2, 512, 256, None, 50.0),
    ("gemma2_serve_tp_local", 2, 4, 2, 512, 256, 4096, 50.0),
    ("qwen2_moe_serve_tp", 2, 8, 8, 512, 128, None, None),
    ("zamba2_serve_tp", 2, 16, 16, 512, 112, None, None),
)
# the kernels of a traced prefill by name: the bf16 attention kernel, and
# the GEMMs by the substrings of cuBLAS's and CUTLASS's kernel names
ATTENTION_KERNEL = "fa_hopper_kernel"
GEMM_KERNELS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
# the mixture-of-experts archs at full width: Qwen1.5-MoE-A2.7B's prefill of
# 2 x 8192 tokens, Arctic's of 1 x 4096 on one of its 35 layers; the fp32
# checks on Qwen cut to 4 layers; the prefill-vs-decode check with the
# capacity factor raised to 8 (a 256-token prefill at the config's 1.25
# has a capacity of 21 and may drop tokens, in the reference too, where a
# decode step never drops one)
MOE_ARCH, MOE_BATCH, MOE_SEQ, MOE_CUT = "qwen2-moe-a2.7b", 2, 8192, 4
ARCTIC_ARCH, ARCTIC_SEQ = "arctic-480b", 4096
MOE_NO_DROP_FACTOR, MOE_GROUPS = 8.0, 16
# Zamba2-7B at full width: 2 x 8192 tokens; fp32 checks on 6 of its 81
# layers (two repeats of mamba, mamba, shared_attn)
HYBRID_ARCH, HYBRID_BATCH, HYBRID_SEQ, HYBRID_CUT = "zamba2-7b", 2, 8192, 6
# the profiler ranges the model code opens around the MoE dispatch scatter,
# the combine gather and the SSD scan
MOE_RANGES, SSD_RANGES = ("moe_dispatch", "moe_combine"), ("ssd_scan",)
# Qwen2-VL-2B at full width: 2 x (256 vision embeddings + 7936 text tokens);
# fp32 prefill at B=1, kernel against the flash op's plain version (never
# the xla / blockwise twin: those mask the vision block by its temporal
# positions, the kernel by index, so they compute another function), within
# VLM_CUT_TOL of the logits' max abs at VLM_CUT layers and VLM_FULL_TOL at
# all 28 (two fp32 summation orders drift apart with depth on random
# weights, as Gemma-2's and RWKV-6's do)
VLM_ARCH, VLM_BATCH, VLM_TEXT, VLM_CUT = "qwen2-vl-2b", 2, 7936, 4
VLM_CUT_TOL, VLM_FULL_TOL = 1e-3, 1e-2
# HuBERT X-Large at full width: 8 clips of 1500 frames (30 s at its 20 ms
# stride) of 512-dim features in bf16; fp32 on AUDIO_CUT layers, the card
# against the port's CPU path within rtol AUDIO_TOL and an atol of
# AUDIO_TOL of the logits' max abs (no kernel on this path: its attention
# is bidirectional, so the plain _sdpa runs, as in the reference)
AUDIO_ARCH, AUDIO_CLIPS, AUDIO_FRAMES, AUDIO_CUT, AUDIO_TOL = "hubert-xlarge", 8, 1500, 2, 1e-4
# LM training on the card: Qwen2-VL-2B at full width, fp32 parameters, bf16
# activations, 1 x (256 + TRAIN_TEXT) tokens, TRAIN_STEPS plain SGD steps of
# TRAIN_LR on one batch (the loss must fall at each); the gradients at
# TRAIN_CUT layers in fp32, the kernel's forward against the plain one's,
# each leaf within GRAD_BAND of its largest |gradient| (the same backward,
# recomputed through the plain version, from inputs that differ by the
# forward's rounding)
TRAIN_TEXT, TRAIN_STEPS, TRAIN_LR, TRAIN_CUT, GRAD_BAND = 1792, 3, 0.03, 4, 1e-4
# Serving while training (phase 4f): phase 4e's model, batch and lr; after
# each of SNAP_STEPS SGD steps the live fp32 parameters are published to
# every set of SNAP_SETS (codec, staleness bounds); then SNAP_REMOTE_STEPS
# more steps publish through a SnapshotFeed to a RemoteReplica over
# localhost; replica 0 of the QSGD set serves a bf16 prefill of
# SNAP_SERVE_BATCH x (256 + TRAIN_TEXT) tokens.  One publish of each lossy
# set, kernel against plain from the same state and seeds: top-k bit for
# bit, QSGD within the codec's band (at most FLIP_BUDGET of a leaf's
# snapshot elements off, each by one level)
SNAP_STEPS, SNAP_REMOTE_STEPS, SNAP_SERVE_BATCH = 4, 4, 2
SNAP_SETS = (("qsgd", (1, 2)), ("top_k:0.01", (1,)), ("identity", (1,)))
SNAP_REMOTE_CODEC = "top_k:0.01"
# RWKV-6 3B at full width: 2 prompts of 8192 tokens, the wkv chunk of 16
RWKV_ARCH, RWKV_BATCH, RWKV_SEQ, WKV_CHUNK = "rwkv6-3b", 2, 8192, 16
# a tp rank's wkv_chunk call in phase 3g: RWKV-6 3B's 20 of 40 heads on a
# node batch of 1 x 512 tokens, (B, S, heads)
WKV_TP_SHAPE = (1, 512, 20)
# wkv_chunk vs the plain chunked form: the same fp32 arithmetic in other
# summation orders; vs the per-token recurrence inside the clamp envelope:
# the reference's kernel-test tolerance (tests/test_kernels.py)
WKV_TOL, WKV_REF_RTOL, WKV_REF_ATOL = 1e-5, 2e-4, 2e-5
# the kernel's three launches a call, in order, each timed over this many calls
WKV_PASSES, WKV_PASS_CALLS = ("wkv_pass_a", "wkv_pass_b", "wkv_pass_c"), 10
WKV_KERNEL = "wkv_pass"   # the name the three share in a trace
# the model's decays scaled into the envelope (no chunk sum past -25) for
# the check against the per-token recurrence
WKV_ENVELOPE_SCALE = 0.25
RWKV_SHARE_LAYERS = (0, 15, 31)
# fp32 prefill, kernel vs the plain chunked twin, relative to the logits'
# max abs: within 1e-3 at 4 layers and 1e-2 at all 32 (two fp32 summation
# orders drift apart with depth on random weights, as Gemma-2's do)
RWKV_FP32_SEQ, RWKV_CUT_LAYERS = 2048, 4
RWKV_LOGIT_TOL_CUT, RWKV_LOGIT_TOL_FULL = 1e-3, 1e-2
# every layer's decay base for the prefill-vs-decode-steps check, which
# holds only inside the clamp envelope (the random init's base is 0)
RWKV_ENVELOPE_BASE = -2.0


def randn(shape, dtype, gen, feed):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def unit(shape, dtype, gen, feed):
    """A node-normalized buffer, |x| <= 1 (the quantize's input)."""
    return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1).to(dtype)


def uniform01(shape, dtype, gen, feed):
    """The quantize's U[0, 1) noise."""
    return torch.rand(shape, generator=gen, device="cuda").to(dtype)


def levels(shape, dtype, gen, feed):
    """The int8 QSGD payload, whatever the float dtype."""
    return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)


def scale_of(shape, dtype, gen, feed):
    """A positive per-node scale.  On the MLP tree it is the (N, 1) scale
    broadcast as the codec passes it (a stride-0 view that ``tree_apply``
    copies); on the flat buffer a full buffer."""
    if feed == "mlp":
        s = torch.rand((shape[0], 1), generator=gen, device="cuda") * 1.9 + 0.1
        return s.to(dtype).expand(shape[0], math.prod(shape[1:])).reshape(shape)
    return (torch.rand(shape, generator=gen, device="cuda") * 1.9 + 0.1).to(dtype)


# op -> (kernel source, TPU kernel replaced, scalars, operations per element,
#        input makers)
OPS = {
    "mvr_update": ("src/repro_torch/kernels/mvr_update/kernel.py",
                   "src/repro/kernels/mvr_update/kernel.py:21", (0.05,), 3, (randn,) * 3),
    "axpby": ("src/repro_torch/kernels/tree_math/kernel.py",
              "src/repro/kernels/tree_math/kernel.py:16", (-0.3, 1.0), 3, (randn,) * 2),
    "add_sub": ("src/repro_torch/kernels/tree_math/kernel.py",
                "src/repro/kernels/tree_math/kernel.py:21", (), 2, (randn,) * 3),
    "dse_combine": ("src/repro_torch/kernels/dse_combine/kernel.py",
                    "src/repro/kernels/dse_combine/kernel.py:25", (0.3,), 4, (randn,) * 4),
    "dse_combine_yh": ("src/repro_torch/kernels/dse_combine/kernel.py",
                       "src/repro/kernels/dse_combine/kernel.py:31", (0.3,), 5, (randn,) * 5),
    "qsgd_quantize": ("src/repro_torch/kernels/comm_compress/kernel.py",
                      "src/repro/kernels/comm_compress/kernel.py:35", (127.0,), 5,
                      (unit, uniform01)),
    "qsgd_dequantize": ("src/repro_torch/kernels/comm_compress/kernel.py",
                        "src/repro/kernels/comm_compress/kernel.py:42", (1.0 / 127,), 2,
                        (levels, scale_of)),
}
# the QSGD codec calls its ops once per leaf (not once per dtype bucket)
PER_LEAF = ("qsgd_quantize", "qsgd_dequantize")
# shaped CUDA C++ ops: (source, TPU kernel replaced)
TOP_K_OPS = {
    "top_k_pack": ("src/repro_torch/csrc/top_k.cu",
                   "src/repro/kernels/comm_compress/kernel.py:67"),
    "top_k_unpack": ("src/repro_torch/csrc/top_k.cu",
                     "src/repro/kernels/comm_compress/kernel.py:101"),
}
# registered and held to its plain version, but on no path: no model calls
# rms_norm, in the port as in the reference (models/common.py's norm)
OFF_PATH = ("rms_norm",)


def hbm_bytes_per_s(name: str) -> float:
    """Published HBM bandwidth of the card by product name."""
    if "H200" in name:
        return 4.8e12
    if "NVL" in name:
        return 3.9e12
    if "PCIe" in name:
        return 2.0e12
    return 3.35e12


def spin_up(seconds: float = 1.0) -> None:
    """Keep the card busy for a while so its clocks are up before timing."""
    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a @ a
        torch.cuda.synchronize()


def cuda_times(fn) -> list:
    """Per-call device times of ``fn`` (ms), REPS calls after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(REPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def abba_samples(*fns) -> list:
    """Per-call ms of each function, timed in turns (a, b, ..., ..., b, a)."""
    samples = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in order + order[::-1]:
        samples[i] += cuda_times(fns[i])
    return samples


def abba_ms(*fns) -> list:
    """Median ms of each function, timed in turns (a, b, ..., ..., b, a)."""
    return [statistics.median(x) for x in abba_samples(*fns)]


def graphed(fn):
    """``fn``'s launches captured once in a CUDA graph; returns its replay.
    For a kernel shorter than the host's dispatch of it, replays time the
    device and not the Python in front of it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def spread(samples) -> list:
    """[10th percentile, 90th percentile] of timing samples (ms)."""
    q = statistics.quantiles(samples, n=10)
    return [q[0], q[-1]]


def bf16_excess_ulps(got: torch.Tensor, want: torch.Tensor, rtol: float = 0.0,
                     atol: float = ATOL32) -> float:
    """Largest |got - want| beyond the fp32 tolerance, in bf16 ulps of the
    larger magnitude.  Both sides compute in fp32 and round once to bf16, so
    they differ by one rounding step plus their fp32 difference; where an
    output cancels to near zero that fp32 difference (an ulp of the O(1)
    operands) is many bf16 ulps of the output, so it is taken off first."""
    g, w = got.float(), want.float()
    _, exp = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(g), exp - 8)   # bf16: 8 significand bits
    return float(((g - w).abs() - atol - rtol * w.abs()).clamp(min=0).div(ulp).max())


def gossip_configs():
    """(tag, channel, compression): the configurations of the repo's gossip
    and compression benches (benchmarks/gossip_bench.py:26-33,
    compression_bench.py:21) on DSE-MVR."""
    from repro_torch.compression import AsyncChannel, ChocoChannel

    return (
        ("sync_ef_top_k0.1", None, "top_k:0.1"),
        ("choco_top_k0.1", "choco", "top_k:0.1"),
        ("choco0.8_top_k0.1", "choco:0.8", "top_k:0.1"),
        ("async4_thr0.5_top_k0.1", AsyncChannel(max_staleness=4, threshold=0.5), "top_k:0.1"),
        ("async4_thr0.1_raw", AsyncChannel(max_staleness=4, threshold=0.1), None),
        ("sync_ef_rand_k0.25", None, "rand_k:0.25"),
        ("sync_ef_low_rank2", None, "low_rank:2"),
        ("per_buffer_choco_top_k0.1", {"params": "choco"}, "top_k:0.1"),
        ("choco_overlap_top_k0.1", ChocoChannel(overlap=True), "top_k:0.1"),
    )


def top_k_case(n, d, dtype, gen):
    """x (n, d) and its top-k indices at TOP_K_RATIO in magnitude order (the
    codec's stable sort), as the main path feeds the pack."""
    k = max(1, min(d, math.ceil(TOP_K_RATIO * d)))
    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    idx = torch.sort(-x.float().abs(), dim=1, stable=True).indices[:, :k]
    return x, idx.to(torch.int32).contiguous()


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(bits), b.view(bits))


def check_elementwise(api, bw) -> dict:
    """Phase 2 for the seven Triton elementwise kernels: agreement with the
    plain versions on the MLP tree and on one large flat buffer in fp32 and
    bf16, and timing beside the bound.  Its buffers (2 GB) go when it
    returns."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, (source, replaces, scalars, flops, makers) in OPS.items():
        op = api.get(name)
        row = {"name": name, "route": "triton", "source": source, "replaces": replaces}
        max_err, flips = 0.0, 0
        for label, shapes, dtype in (
            ("mlp", MLP_SHAPES, torch.float32),
            ("big", {"x": (BIG_N,)}, torch.float32),
            ("big_bf16", {"x": (BIG_N,)}, torch.bfloat16),
        ):
            trees = [{k: make(s, dtype, gen, label) for k, s in shapes.items()} for make in makers]

            def apply(mode="kernel"):
                with api.dispatch_mode(mode):
                    if name in PER_LEAF:
                        return ({k: api.call(name, *(t[k] for t in trees), scalars=scalars)
                                 for k in shapes},)
                    out = api.tree_apply(name, *trees, scalars=scalars)
                    return out if isinstance(out, tuple) else (out,)

            got, want = apply(), apply("ref")
            torch.cuda.synchronize()
            for g_tree, w_tree in zip(got, want):
                for k in shapes:
                    g, w = g_tree[k], w_tree[k]
                    assert g.dtype == w.dtype == dtype, (name, label, g.dtype, w.dtype)
                    if name == "qsgd_quantize":   # integer levels: count the flips
                        off = (g.float() - w.float()).abs()
                        n_off = int((off > 0).sum())
                        assert float(off.max()) <= 1.0, f"{name} {label}: a level off by >1"
                        assert n_off <= FLIP_BUDGET * off.numel(), f"{name} {label}: {n_off} flips"
                        flips += n_off
                        max_err = max(max_err, float(off.max()))
                    elif dtype == torch.bfloat16:
                        ulps = bf16_excess_ulps(g, w)
                        assert ulps <= 1.0, f"{name} {label}: {ulps} bf16 ulps"
                        row["bf16_max_abs_err"] = max(
                            row.get("bf16_max_abs_err", 0.0), float((g - w).abs().max()))
                    else:
                        torch.testing.assert_close(g, w, rtol=RTOL32, atol=ATOL32)
                        max_err = max(max_err, float((g - w).abs().max()))

            def plain():
                return apply("ref")

            if label == "mlp":
                row["mlp_ms"], row["mlp_plain_ms"] = abba_ms(apply, plain)
            if label == "big":
                n_bytes = sum(t["x"].numel() * t["x"].element_size() for t in trees + list(got))
                bytes_ms = n_bytes / bw * 1e3
                ops_ms = flops * BIG_N / FP32_PEAK_FLOPS * 1e3
                row["bound_ms"] = max(bytes_ms, ops_ms)
                row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
                fns = [apply, plain]
                if name == "axpby":   # b = 1 on the DSE path: y + a*x is one call
                    x, y = trees[0]["x"], trees[1]["x"]
                    out = torch.empty_like(y)
                    fns.append(lambda: torch.add(y, x, alpha=scalars[0], out=out))
                samples = abba_samples(*fns)
                times = [statistics.median(x) for x in samples]
                row["ms"], row["plain_ms"] = times[:2]
                row["library_ms"] = times[2] if len(times) > 2 else None
                if name == "axpby":   # a tie with torch.add: keep the spread
                    row["ms_p10_p90"] = spread(samples[0])
                    row["library_ms_p10_p90"] = spread(samples[2])
                    print(f"kernel axpby vs torch.add, {2 * REPS} calls each in turns: "
                          f"median {times[0]:.4f} ms (p10-p90 {row['ms_p10_p90']}) vs "
                          f"{times[2]:.4f} ms (p10-p90 {row['library_ms_p10_p90']})")
            del trees, got, want
        row["max_abs_err"] = max_err
        if name == "qsgd_quantize":
            row["flips"] = flips
        results[name] = row
        print(f"kernel {name}: max_abs_err={max_err:.3g} "
              f"bf16_max_abs_err={row.get('bf16_max_abs_err')} flips={row.get('flips')} "
              f"ms={row['ms']:.4f} bound_ms={row['bound_ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']} "
              f"mlp_ms={row['mlp_ms']:.4f} mlp_plain_ms={row['mlp_plain_ms']:.4f}")
    torch.cuda.empty_cache()
    return results


def check_top_k_cases(api) -> dict:
    """The cases the tile-owning unpack and the windowed pack make risky,
    each held to the right result: repeated indices to the fp32-accumulate
    mirror (values whose fp32 sums are exact in any order, so bit for bit),
    subnormal values (the unpack to the plain version on the CPU: on the
    card the plain scatter_add_ adds by fp32 atomics that flush), every
    index in one unpack tile or one pack window (timed once), k = d, a
    ragged last tile, indices outside [0, d), and rows of more than 4,096
    tiles."""
    from repro_torch.kernels.comm_compress.kernel import UNPACK_TILE, pack_window
    from repro_torch.kernels.comm_compress.ref import top_k_unpack_tiled_ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}

    def pack(x, i, mode="kernel"):
        with api.dispatch_mode(mode):
            return api.call("top_k_pack", x, i)

    def unpack(i, v, d, mode="kernel"):
        with api.dispatch_mode(mode):
            return api.call("top_k_unpack", i, v, d=d)

    def perm_rows(n, d, k, lo=0):
        return torch.stack([torch.randperm(d, generator=gen, device="cuda")[:k] + lo
                            for _ in range(n)]).to(torch.int32)

    for d, k in ((12544, 5000), (1_000_003, 100_000)):   # one tile; 62 tiles
        i = torch.randint(0, d, (8, k), generator=gen, device="cuda", dtype=torch.int32)
        i[:, : k // 4] = i[:, :1]
        for dtype in (torch.float32, torch.bfloat16):
            v = (torch.randint(-63, 64, (8, k), generator=gen, device="cuda").float() / 64
                 ).to(dtype)
            got, want = unpack(i, v, d), top_k_unpack_tiled_ref(i, v, d, UNPACK_TILE)
            assert same_bits(got, want), f"top_k_unpack repeated d={d} {dtype}"
    out["repeated"] = "bit-equal to top_k_unpack_tiled_ref (fp32 sums), d 12544 and 1000003"

    flushed = {}
    for d in (12544, 1_000_003):
        for dtype in (torch.float32, torch.bfloat16):
            tiny = torch.finfo(dtype).tiny
            x = ((torch.rand((8, d), generator=gen, device="cuda") * 2 - 1) * tiny).to(dtype)
            i = perm_rows(8, d, d // 10)
            v = pack(x, i)
            assert same_bits(v, pack(x, i, "ref")), f"top_k_pack subnormal d={d} {dtype}"
            got = unpack(i, v, d)
            assert same_bits(got.cpu(), unpack(i.cpu(), v.cpu(), d)), \
                f"top_k_unpack subnormal d={d} {dtype}"
            assert bool(((got != 0) & (got.abs() < tiny)).any())
            card_plain = unpack(i, v, d, "ref")
            flushed[f"{d}_{str(dtype)[6:]}"] = int(((card_plain == 0) & (got != 0)).sum())
    out["subnormal_flushed_by_card_plain"] = flushed
    print("top_k subnormals: kernels bit-equal to the plain versions on the CPU; the card's "
          "plain scatter_add_ flushed " + json.dumps(flushed) + " of the kept subnormals")

    n, d = 8, TOP_K_BIG_D
    k = math.ceil(TOP_K_RATIO * d)
    # skew: every unpack entry of a row in tile 500 of 1,025, every pack
    # index in the second of its two windows
    i = perm_rows(n, UNPACK_TILE, UNPACK_TILE, 500 * UNPACK_TILE)
    v = torch.randn((n, UNPACK_TILE), generator=gen, device="cuda")
    assert same_bits(unpack(i, v, d), unpack(i, v, d, "ref")), "top_k_unpack skew"
    out["unpack_skew_ms"] = once_ms(lambda: unpack(i, v, d))
    x = torch.randn((n, d), generator=gen, device="cuda")
    window = pack_window(d, 4)
    i = perm_rows(n, d - window, k, window)
    assert same_bits(pack(x, i), pack(x, i, "ref")), "top_k_pack skew"
    out["pack_skew_ms"] = once_ms(lambda: pack(x, i))
    del x, i, v
    torch.cuda.empty_cache()

    # k = d over two tiles, a ragged last tile, indices outside [0, d)
    for d, k in ((20000, 20000), (5 * UNPACK_TILE + 9, 8200), (100_003, 10_000)):
        x = torch.randn((8, d), generator=gen, device="cuda")
        i = perm_rows(8, d, k)
        if d == 100_003:
            stray = torch.zeros((8, k), dtype=torch.bool, device="cuda")
            stray[:, ::4] = True
            bad = torch.tensor([-1, d, d + 600, 2**31 - 1, -(2**31)], dtype=torch.int32,
                               device="cuda").repeat(k)[:k]
            i_ok = i
            i = torch.where(stray, bad, i)
            want = torch.where(stray, 0.0, pack(x, i_ok, "ref"))
            assert same_bits(pack(x, i), want), "top_k_pack out-of-range"
            v = torch.randn((8, k), generator=gen, device="cuda")
            want = unpack(torch.where(stray, 0, i), torch.where(stray, 0.0, v), d, "ref")
            assert same_bits(unpack(i, v, d), want), "top_k_unpack out-of-range"
            continue
        v = pack(x, i)
        assert same_bits(v, pack(x, i, "ref")), f"top_k_pack d={d} k={k}"
        assert same_bits(unpack(i, v, d), unpack(i, v, d, "ref")), f"top_k_unpack d={d} k={k}"

    # a model rank's tp shard of Qwen2-VL-2B's embedding at top-k 0.01 (phase
    # 3g's codec runs): the pack of the shard's candidates, and the unpack of
    # the merged payload's entries in the shard, re-indexed, the rest padded
    # as +0.0 at spread indices (a ragged in-shard count padded to k)
    d_whole = 151_936 * 1536
    d = d_whole // 2
    k = math.ceil(0.01 * d_whole)
    x = torch.randn((1, d), generator=gen, device="cuda")
    i = perm_rows(1, d, k)
    for dtype in (torch.float32, torch.bfloat16):
        xt = x.to(dtype)
        assert same_bits(pack(xt, i), pack(xt, i, "ref")), f"top_k_pack shard {dtype}"
        inside = torch.rand((1, k), generator=gen, device="cuda") < 0.5
        pad = (torch.arange(k, device="cuda") % d).to(torch.int32)[None]
        il = torch.where(inside, i, pad)
        v = torch.where(inside, torch.randn((1, k), generator=gen, device="cuda"), 0.0).to(dtype)
        assert same_bits(unpack(il, v, d), unpack(il, v, d, "ref")), f"top_k_unpack shard {dtype}"
        del xt, il, v
    out["shard"] = (f"a tp shard of Qwen2-VL-2B's embedding: pack and padded unpack, d {d}, "
                    f"k {k}, fp32 and bf16, bit for bit")
    del x, i
    torch.cuda.empty_cache()

    # a row of 4,097 tiles: one global atomic per entry for counts and cursors
    d = 4097 * UNPACK_TILE + 5
    i = perm_rows(1, d, 20000)
    v = torch.randn((1, 20000), generator=gen, device="cuda")
    assert same_bits(unpack(i, v, d), unpack(i, v, d, "ref")), "top_k_unpack 4097 tiles"
    del i, v
    torch.cuda.empty_cache()
    print("top_k cases: repeated, subnormal, skew, k = d, ragged last tile, out-of-range, "
          "a padded tp shard and 4,097-tile rows held; skew ms " + json.dumps(
              {k_: round(out[k_], 4) for k_ in ("unpack_skew_ms", "pack_skew_ms")}))
    return out


def check_top_k(api, bw) -> dict:
    """Phase 2 for the CUDA C++ pair: build, bit-equality against the plain
    versions on the MLP's leaves and the large shape (the pack in fp16 too),
    the cases of ``check_top_k_cases``, and timing: the MLP's leaves and
    the large shape in fp32 and bf16 beside the plain versions and library
    calls, each stage's device time, and the pack's windowed passes
    against one pass over the row."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.comm_compress import kernel as top_k_kernel

    gen = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.perf_counter()
    x, idx = top_k_case(2, 5, torch.float32, gen)
    api.call("top_k_pack", x, idx)          # the first launch loads the library
    torch.cuda.synchronize()
    print(f"top_k.cu loaded in {time.perf_counter() - t0:.1f} s")
    rows = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep,
                   "max_abs_err": 0.0}
            for name, (src, rep) in TOP_K_OPS.items()}
    mlp_d = {k: math.prod(s[1:]) for k, s in MLP_SHAPES.items()}
    for label, shapes in (("mlp", mlp_d), ("big", {"x": TOP_K_BIG_D})):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            cases = {k: top_k_case(8, d, dtype, gen) for k, d in shapes.items()}

            def pack(mode="kernel"):
                with api.dispatch_mode(mode):
                    return {k: api.call("top_k_pack", x, i) for k, (x, i) in cases.items()}

            vals = pack()
            want = pack("ref")
            for k in cases:
                assert same_bits(vals[k], want[k]), f"top_k_pack {label} {dtype} {k} differs"
            if dtype == torch.float16:   # the unpack takes fp32 and bf16
                del cases, vals, want
                continue

            def unpack(mode="kernel"):
                with api.dispatch_mode(mode):
                    return {k: api.call("top_k_unpack", cases[k][1], vals[k], d=shapes[k])
                            for k in cases}

            dense, dense_want = unpack(), unpack("ref")
            torch.cuda.synchronize()
            for k in cases:
                assert same_bits(dense[k], dense_want[k]), \
                    f"top_k_unpack {label} {dtype} {k} differs"
            if label == "mlp":
                if dtype == torch.float32:   # host-bound: keep the spreads
                    for name, fn in (("top_k_pack", pack), ("top_k_unpack", unpack)):
                        got, plain = abba_samples(fn, lambda fn=fn: fn("ref"))
                        rows[name].update(
                            mlp_ms=statistics.median(got), mlp_plain_ms=statistics.median(plain),
                            mlp_ms_p10_p90=spread(got), mlp_plain_ms_p10_p90=spread(plain))
                del cases, vals, want, dense, dense_want
                continue
            (x, i), v, d = cases["x"], vals["x"], shapes["x"]
            del dense, dense_want
            torch.cuda.empty_cache()
            i64 = i.long()
            n, kk = i.shape
            eb = x.element_size()
            out = torch.empty((n, d), device="cuda", dtype=dtype)
            pack_bytes = n * kk * (4 + 2 * eb)
            unpack_bytes = n * d * eb + n * kk * (4 + eb)
            pack_times = abba_ms(lambda: api.call("top_k_pack", x, i),
                                 lambda: pack("ref"),
                                 lambda: torch.gather(x, 1, i64, out=v))
            unpack_times = abba_ms(lambda: api.call("top_k_unpack", i, v, d=d),
                                   lambda: unpack("ref"),
                                   lambda: out.zero_().scatter_add_(1, i64, v))
            if dtype == torch.bfloat16:
                rows["top_k_pack"]["bf16"] = dict(zip(("ms", "plain_ms", "library_ms"),
                                                      pack_times),
                                                  bound_ms=pack_bytes / bw * 1e3)
                rows["top_k_unpack"]["bf16"] = dict(zip(("ms", "plain_ms", "library_ms"),
                                                        unpack_times),
                                                    bound_ms=unpack_bytes / bw * 1e3)
                del out, i64, cases, vals, want
                continue
            rows["top_k_pack"].update(ms=pack_times[0], plain_ms=pack_times[1],
                                      library_ms=pack_times[2],
                                      bound_ms=pack_bytes / bw * 1e3, bytes=pack_bytes)
            rows["top_k_unpack"].update(ms=unpack_times[0], plain_ms=unpack_times[1],
                                        library_ms=unpack_times[2],
                                        bound_ms=unpack_bytes / bw * 1e3, bytes=unpack_bytes)
            rows["top_k_unpack"]["pass_ms"] = stage_ms(
                lambda: api.call("top_k_unpack", i, v, d=d),
                ("count_kernel", "scan_kernel", "place_kernel", "tile_kernel"))
            rows["top_k_pack"]["pass_ms"] = stage_ms(
                lambda: api.call("top_k_pack", x, i), ("pack_kernel",))
            # the windowed passes against one pass over each row, straight
            # through the library (uncounted)
            lib = top_k_kernel._top_k_lib()
            window = top_k_kernel.pack_window(d, eb)
            one = torch.empty_like(v)

            def pack_with(w, dst):
                err = lib.top_k_pack(x.data_ptr(), i.data_ptr(), dst.data_ptr(), n, d, kk, eb,
                                     w, _cuda.stream_of(x))
                _cuda.check("top_k", "top_k_pack", err)

            pack_with(d, one)
            assert same_bits(one, want["x"]), "top_k_pack one pass differs"
            windowed_ms, one_pass_ms = abba_ms(lambda: pack_with(window, v),
                                               lambda: pack_with(d, one))
            rows["top_k_pack"].update(windows=-(-d // window), windowed_ms=windowed_ms,
                                      one_pass_ms=one_pass_ms)
            del out, i64, one, cases, vals, want
        torch.cuda.empty_cache()
    cases = check_top_k_cases(api)
    rows["top_k_unpack"]["skew_ms"] = cases["unpack_skew_ms"]
    rows["top_k_pack"]["skew_ms"] = cases["pack_skew_ms"]
    for row in rows.values():
        row["bound_by"] = "bytes"   # no arithmetic: the bytes are the bound
        print(f"kernel {row['name']}: bit-equal to plain (mlp leaves and N=8 d={TOP_K_BIG_D} "
              f"k={math.ceil(TOP_K_RATIO * TOP_K_BIG_D)}, fp32 and bf16"
              + (", fp16" if row["name"] == "top_k_pack" else "") + ") "
              f"ms={row['ms']:.4f} bound_ms={row['bound_ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
              f"mlp_ms={row['mlp_ms']:.4f} (p10-p90 {row['mlp_ms_p10_p90']}) "
              f"mlp_plain_ms={row['mlp_plain_ms']:.4f} (p10-p90 {row['mlp_plain_ms_p10_p90']}) "
              f"skew_ms={row['skew_ms']:.4f}; by stage (CUPTI, median of 10 calls) "
              + json.dumps({k_: round(v_, 4) for k_, v_ in row["pass_ms"].items()})
              + "; bf16 " + json.dumps({k_: round(v_, 4) for k_, v_ in row["bf16"].items()}))
    pack_row = rows["top_k_pack"]
    print(f"top_k_pack fp32, {pack_row['windows']} windows against one pass, same ABBA turn: "
          f"{pack_row['windowed_ms']:.4f} ms against {pack_row['one_pass_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return rows


def attention_pairs(s: int, window) -> int:
    """Query-key pairs a causal (windowed) pass over s tokens must score."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def ptxas_summary(log: str) -> list:
    """(kernel, registers, spill-store bytes, static shared-memory bytes) per
    entry function of an nvcc -Xptxas -v report."""
    out, name, spill = [], None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and name:
            smem = line.split("bytes smem")[0].split(",")[-1] if "bytes smem" in line else "0"
            out.append((name, int(line.split("Used")[1].split("registers")[0]), spill,
                        int(smem)))
    return out


def sass_counts(sass: str, ops) -> dict:
    """{kernel: {op: instructions}} from a ``cuobjdump -sass`` listing, an
    instruction counted under each op its opcode starts with (``HGMMA`` for
    ``HGMMA.64x256x16.F32.BF16``)."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            out[name] = dict.fromkeys(ops, 0)
        elif name and "*/" in line:
            words = [w for w in line.split("*/", 1)[1].split() if not w.startswith("@")]
            opcode = words[0].split(".")[0] if words else ""
            if opcode in out[name]:
                out[name][opcode] += 1
    return out


def launch_records(fn, kernel: str, calls: int = 2):
    """``fn()`` run ``calls`` times under ``torch.profiler`` (after one call
    outside it, so its kernels are loaded), and each launch of a kernel
    whose name holds ``kernel`` as CUPTI recorded it, in order: grid, block,
    registers a thread, shared memory (static and dynamic together) and
    device time.  CUPTI can miss the first launches of a session, so
    callers read the last call's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            out = fn()
        torch.cuda.synchronize()
    path = ROOT / "build" / "launch_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    launches = [e for e in json.loads(path.read_text())["traceEvents"]
                if e.get("cat") == "kernel" and kernel in e.get("name", "")]
    return out, [{"kernel": e["name"], "ms": e.get("dur", 0) / 1e3, **{
        k: e.get("args", {}).get(k)
        for k in ("grid", "block", "registers per thread", "shared memory")}}
        for e in launches]


PROFILE_TRIES = 4


def stage_ms(fn, stages, calls: int = 10) -> dict:
    """Median device ms of each stage (the kernels whose names hold the
    stage's name) over at least ``calls - 2`` recorded launches of each.
    CUPTI can miss launches it traces (three of ten in one session on an
    H100), so sessions of ``calls`` profiled calls of ``fn`` repeat, up to
    ``PROFILE_TRIES``, and their records are pooled."""
    ms = {stage: [] for stage in stages}
    for _ in range(PROFILE_TRIES):
        _, launches = launch_records(fn, "", calls=calls)
        for stage in stages:
            ms[stage] += [e["ms"] for e in launches if stage in e["kernel"]]
        if all(len(v) >= calls - 2 for v in ms.values()):
            break
    for stage, v in ms.items():
        assert len(v) >= calls - 2, (stage, len(v), [e["kernel"] for e in launches])
    return {stage: statistics.median(v) for stage, v in ms.items()}


def launch_record(fn, kernel: str):
    """The launch of a kernel whose name holds ``kernel`` in the last of
    two profiled calls of ``fn`` (``launch_records``); each call makes one.
    A session in which CUPTI recorded none is repeated, up to
    ``PROFILE_TRIES`` sessions."""
    for _ in range(PROFILE_TRIES):
        out, launches = launch_records(fn, kernel)
        if launches:
            break
    assert 1 <= len(launches) <= 2, (kernel, [e["kernel"] for e in launches])
    launches[-1].pop("ms")
    return out, launches[-1]


def check_attention_kernels(api, bw) -> dict:
    """Phase 2 for flash_attention and rms_norm (both CUDA C++):
    agreement with the plain versions on the card, and timing at the
    serving path's shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import kernel_head_dim

    gen = torch.Generator(device="cuda").manual_seed(2)
    flash = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
             "bound_by": "operations", "cases": []}
    peak = BF16_PEAK_FLOPS

    def qkv(b, h, kh, s, d, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, d))]

    def held(got, want, what):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        assert bool(torch.isfinite(got).all()), f"{what}: not finite"
        if got.dtype == torch.bfloat16:
            ulps = bf16_excess_ulps(got, want, ATT_RTOL, ATT_ATOL)
            assert ulps <= 1.0, f"{what}: {ulps} bf16 ulps beyond rtol/atol {ATT_RTOL}"
        else:
            torch.testing.assert_close(got, want, rtol=ATT_RTOL, atol=ATT_ATOL)
        return float((got.float() - want.float()).abs().max())

    # rms_norm first (on inputs of its own): timed right after the flash
    # cases' heavy runs, its first turn read slower than the rest
    norm = {"name": "rms_norm", "route": "cuda", "source": "src/repro_torch/csrc/rms_norm.cu",
            "replaces": "src/repro/kernels/rms_norm/kernel.py:29", "bound_by": "bytes"}
    norm_gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((1001, 2304), generator=norm_gen, device="cuda")
    w = torch.randn((2304,), generator=norm_gen, device="cuda")
    got = api.call("rms_norm", x, w, eps=1e-6, plus_one=False)
    with api.dispatch_mode("ref"):
        want = api.call("rms_norm", x, w, eps=1e-6, plus_one=False)
    norm["max_abs_err"] = held(got, want, "rms_norm fp32")
    rows, d = 16384, 2304
    x = torch.randn((rows, d), generator=norm_gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((d,), generator=norm_gen, device="cuda") * 0.1).to(torch.bfloat16)
    got = api.call("rms_norm", x, w, eps=1e-6, plus_one=True)
    with api.dispatch_mode("ref"):
        want = api.call("rms_norm", x, w, eps=1e-6, plus_one=True)
    norm["bf16_max_abs_err"] = held(got, want, "rms_norm bf16")
    w1 = w + 1
    def plain_norm():
        with api.dispatch_mode("ref"):
            return api.call("rms_norm", x, w, eps=1e-6, plus_one=True)

    # the kernel (0.06 ms) can be shorter than its dispatch from Python, so
    # it and F.rms_norm are timed as graph replays of one call each
    samples = abba_samples(graphed(lambda: api.call("rms_norm", x, w, eps=1e-6, plus_one=True)),
                           plain_norm, graphed(lambda: F.rms_norm(x, (d,), w1, 1e-6)))
    times = [statistics.median(t) for t in samples]
    n_bytes = 2 * x.numel() * 2 + d * 2
    ops_ms = 4 * x.numel() / FP32_PEAK_FLOPS * 1e3
    norm.update(ms=times[0], plain_ms=times[1], library_ms=times[2],
                bound_ms=max(n_bytes / bw * 1e3, ops_ms), ms_p10_p90=spread(samples[0]),
                library_ms_p10_p90=spread(samples[2]))
    print(f"kernel rms_norm {rows}x{d} bf16: max_abs_err={norm['max_abs_err']:.3g} "
          f"bf16_max_abs_err={norm['bf16_max_abs_err']:.3g} ms={norm['ms']:.4f} "
          f"(p10-p90 {norm['ms_p10_p90']}) bound_ms={norm['bound_ms']:.4f} "
          f"plain_ms={norm['plain_ms']:.4f} library_ms={norm['library_ms']:.4f} "
          f"(F.rms_norm, p10-p90 {norm['library_ms_p10_p90']})")
    del x, w, w1, got, want
    torch.cuda.empty_cache()

    # untimed: fp32 at S=1024 and ragged lengths, Gemma-2's and Yi's heads,
    # the fp32 ranks of phase 3g (tp Qwen1.5-MoE's and Zamba2's shared
    # attention's heads), and phase 4g's model 1 (the whole batch) and its
    # Zamba2 fp32 ranks
    fp32_err, bf16_err = 0.0, 0.0
    for b, h, kh, s, d, window, cap, dtype in (
        (4, 8, 4, 512, 256, None, 50.0, torch.bfloat16),
        (4, 8, 4, 512, 256, 4096, 50.0, torch.bfloat16),
        (4, 16, 16, 512, 128, None, None, torch.bfloat16),
        (4, 32, 32, 512, 112, None, None, torch.bfloat16),
        (4, 32, 32, 512, 112, None, None, torch.float32),
        (2, 16, 16, 512, 112, None, None, torch.float32),
        (1, 8, 4, 1024, 256, 256, 50.0, torch.float32),
        (1, 32, 4, 1024, 128, None, None, torch.float32),
        (2, 8, 4, 1000, 256, 400, 50.0, torch.float32),
        (2, 8, 4, 1000, 256, 400, 50.0, torch.bfloat16),
        (1, 32, 4, 1000, 128, None, None, torch.bfloat16),
        (1, 32, 32, 1000, 112, None, None, torch.float32),
        (1, 8, 8, 2048, 128, None, None, torch.float32),
        (1, 16, 16, 1024, 112, None, None, torch.float32),
    ):
        q, k, v = qkv(b, h, kh, s, d, dtype)
        kw = dict(causal=True, sliding_window=window, softcap=cap)
        got, launch = launch_record(lambda: api.call("flash_attention", q, k, v, **kw), "fa_")
        print(f"launch flash_attention {dtype} S={s} D={d}: " + json.dumps(launch))
        with api.dispatch_mode("ref"):
            want = api.call("flash_attention", q, k, v, **kw)
        err = held(got, want, f"flash_attention {dtype} S={s} D={d}")
        if dtype == torch.float32:
            fp32_err = max(fp32_err, err)
        else:
            bf16_err = max(bf16_err, err)
    # timed: the serving path's shapes in bf16
    for label, b, h, kh, s, d, window, cap in FLASH_CASES:
        q, k, v = qkv(b, h, kh, s, d, torch.bfloat16)
        kw = dict(causal=True, sliding_window=window, softcap=cap)
        got, launch = launch_record(lambda: api.call("flash_attention", q, k, v, **kw), "fa_")
        print(f"launch flash_attention {label}: " + json.dumps(launch))
        with api.dispatch_mode("ref"):
            want = api.call("flash_attention", q, k, v, **kw)
        bf16_err = max(bf16_err, held(got, want, f"flash_attention {label}"))
        del got, want
        torch.cuda.empty_cache()

        def plain():
            with api.dispatch_mode("ref"):
                return api.call("flash_attention", q, k, v, **kw)

        fns = [lambda: api.call("flash_attention", q, k, v, **kw), plain]
        if cap is None and window is None:   # SDPA has neither softcap nor window
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            fns.append(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                              enable_gqa=True))
        times = abba_ms(*fns)
        flops = attention_pairs(s, window) * 4 * d * b * h
        n_bytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
        bound = max(flops / peak, n_bytes / bw) * 1e3
        case = {"case": label, "shape": [b, h, kh, s, d], "window": window, "softcap": cap,
                "ms": times[0], "plain_ms": times[1],
                "library_ms": times[2] if len(times) > 2 else None, "bound_ms": bound,
                "tflops": flops / times[0] / 1e9}
        padded = ""
        if kernel_head_dim(d) != d:   # the bound counts the true D's work
            dk = case["padded_to"] = kernel_head_dim(d)
            case["pad_ms"] = statistics.median(cuda_times(
                lambda: [F.pad(t, (0, dk - d)) for t in (q, k, v)]))
            padded = (f"; D={d} zero-padded to {dk}: the kernel does {dk / d:.4f}x the "
                      f"work, and the padding copies of q, k and v take "
                      f"{case['pad_ms']:.4f} ms of the call")
        flash["cases"].append(case)
        print(f"kernel flash_attention {label}: ms={case['ms']:.4f} bound_ms={bound:.4f} "
              f"plain_ms={case['plain_ms']:.4f} library_ms={case['library_ms']} "
              f"({case['tflops']:.1f} TFLOP/s of {peak / 1e12:.0f}){padded}")
        del q, k, v, fns
        torch.cuda.empty_cache()
    main_case = flash["cases"][0]   # Gemma-2's global layer, the longest
    flash.update({k: main_case[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    flash.update(max_abs_err=fp32_err, bf16_max_abs_err=bf16_err)

    return {"flash_attention": flash, "rms_norm": norm}


def run_prefill(api, runs, mode, p, batch, fn, expect):
    """One prefill call in dispatch ``mode``, fenced: (logits, caches,
    seconds, peak bytes).  Through the kernels the launches must be exactly
    ``expect``, and they are recorded in ``runs``; the plain path launches
    nothing."""
    api.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with api.dispatch_mode(mode):
        logits, caches = fn(p, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = api.launch_counts()
    if mode == "kernel":
        assert launches == expect, launches
        runs.append(launches)
    else:
        assert not launches, launches
    assert bool(torch.isfinite(logits).all()), f"prefill {mode}: logits not finite"
    return logits, caches, dt, torch.cuda.max_memory_allocated()


def trace_prefill(api, fn, params, batch, expect, label, focus, ranges=()) -> None:
    """One call of ``fn`` (a prefill, an encoder's forward or a training
    step's loss and gradients) through the kernels under
    ``torch.profiler``, which must launch exactly ``expect``: device time by
    kernel name (top 10), the
    shares of the kernels launched inside each ``repro/<range>`` profiler
    range the model code opens (``ranges``), of the other kernels named
    ``focus`` (a label and name substrings), of the other GEMMs and of the
    rest, and the device's idle share of the call's span (CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    api.reset_counters()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        with api.dispatch_mode("kernel"):
            out = fn(params, batch)
        end.record()
        torch.cuda.synchronize()
    del out
    assert api.launch_counts() == expect, api.launch_counts()
    span_ms = start.elapsed_time(end)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not e.key.startswith("repro/")),   # the ranges, not kernels
                  key=lambda r: -r[1])
    assert rows, "torch.profiler recorded no device time"
    path = ROOT / "build" / "prefill_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    work = [(e["name"], e["dur"] / 1e3, e.get("args", {}).get("correlation"))
            for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    inside = range_launches(events, ranges)
    del events
    name, patterns = focus[0], focus[1:]
    split = dict.fromkeys(ranges, 0.0)
    busy = hot = gemm = 0.0
    for kernel, ms, corr in work:
        busy += ms
        where = next((r for r in ranges if corr in inside[r]), None)
        if where is not None:
            split[where] += ms
        elif any(p in kernel for p in patterns):
            hot += ms
        elif any(g in kernel.lower() for g in GEMM_KERNELS):
            gemm += ms
    rest = busy - hot - gemm - sum(split.values())
    parts = "".join(f"{r} {ms:.3f} ms ({ms / busy:.4f}), " for r, ms in split.items())
    print(f"trace {label}: device busy {busy:.3f} ms of a {span_ms:.3f} ms span (idle share "
          f"{1 - busy / span_ms:.4f}); {name} {hot:.3f} ms ({hot / busy:.4f}), {parts}"
          f"GEMMs{' outside those' if ranges else ''} {gemm:.3f} ms ({gemm / busy:.4f}), "
          f"rest {rest:.3f} ms ({rest / busy:.4f}); {len(work)} launches, {len(rows)} kernel "
          "names" + (("; launches inside the ranges " + json.dumps(
              {r: len(v) for r, v in inside.items()})) if ranges else ""))
    print(f"trace {label} top 10 by device ms: " + json.dumps(
        [{"kernel": k[:120], "ms": round(ms, 4), "calls": n} for k, ms, n in rows[:10]]))


def range_launches(events: list, ranges) -> dict:
    """``{range: {correlation ids}}``: the launches whose runtime or driver
    call lies inside a ``repro/<range>`` range of a Chrome trace's events."""
    import bisect

    calls = sorted((e["ts"], e["args"]["correlation"]) for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {}))
    stamps = [ts for ts, _ in calls]
    out = {}
    for r in ranges:
        ids = set()
        for e in events:
            if (e.get("name") == f"repro/{r}" and e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"):
                lo = bisect.bisect_left(stamps, e["ts"])
                hi = bisect.bisect_right(stamps, e["ts"] + e["dur"])
                ids.update(corr for _, corr in calls[lo:hi])
        out[r] = ids
    return out


def serving_path(api) -> list:
    """Phase 4: the LM serving path at Gemma-2 2B's full width.  Returns the
    launch counts of each run through the kernels."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving import RequestDriver, ServingMetrics, scan_prefill
    from repro_torch.telemetry import Telemetry

    runs = []
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="pallas")
    job = serve.make_serve_job(cfg, device="cuda")
    model = job.model
    t0 = time.perf_counter()
    params = job.init_params(0)
    torch.cuda.synchronize()
    print(f"serve {cfg.name}: {cfg.param_count(params):,} parameters in "
          f"{job.param_dtype}, initialized in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ), generator=gen, device="cuda")

    def prefill(mode, p, batch, fn, layers=cfg.n_layers):
        return run_prefill(api, runs, mode, p, batch, fn, {"flash_attention": layers})

    # 1. bf16 prefill of 2 x 8192 tokens through prefill_fn: kernel (twice:
    #    the first call carries one-time set-up), plain, kernel
    batch = {"tokens": tokens}
    rates = {}
    for mode in ("kernel", "kernel", "ref", "kernel"):
        logits, caches, dt, peak = prefill(mode, params, batch, job.prefill_fn)
        rates.setdefault(mode, []).append(LM_BATCH * LM_SEQ / dt)
        print(f"serve prefill bf16 {mode}: {LM_BATCH}x{LM_SEQ} tokens in {dt:.3f} s, "
              f"{LM_BATCH * LM_SEQ / dt:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB, "
              f"launches {api.launch_counts()}")
        if mode == "ref":
            plain_logits = logits.float()
        else:
            kernel_logits = logits.float()
        del caches
    print("serve prefill bf16 last-token logits, kernel vs plain: max abs diff "
          f"{float((kernel_logits - plain_logits).abs().max()):.4g} ({cfg.n_layers} layers "
          "of bf16 rounding on random weights; the kernel is held at the op level)")
    print("serve prefill tokens/s: " + json.dumps(rates))
    del logits
    trace_prefill(api, job.prefill_fn, params, batch, {"flash_attention": cfg.n_layers},
                  f"prefill bf16 {LM_BATCH}x{LM_SEQ}", ("attention", ATTENTION_KERNEL))
    del params
    torch.cuda.empty_cache()

    # 2. fp32 prefill at B=1, S=8192: kernel vs plain, last-token logits.
    #    On random weights the gap between any two fp32 summation orders
    #    grows with depth: at 26 layers the plain path's own online-softmax
    #    twin (attn_impl="blockwise", no kernel) lies further than
    #    LOGIT_TOL from it.  So the kernel is held within LOGIT_TOL at 6
    #    layers and, at all 26, within twice the blockwise twin's gap
    params32 = job.model.init(0, dtype=torch.float32, device="cuda")

    def prefill32(m):
        def fn(p, b):
            with torch.inference_mode():
                return m.prefill(p, b, dtype=torch.float32)
        return fn

    batch1 = {"tokens": tokens[:1]}
    cut = dataclasses.replace(cfg, n_layers=6)
    params_cut = first_repeats(params32, cut.repeats)
    got, _, _, _ = prefill("kernel", params_cut, batch1, prefill32(Model(cut)), cut.n_layers)
    want, _, _, _ = prefill("ref", params_cut, batch1, prefill32(Model(cut)))
    err_cut = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    got, _, dt_k, _ = prefill("kernel", params32, batch1, prefill32(model))
    want, _, dt_p, _ = prefill("ref", params32, batch1, prefill32(model))
    twin, _, dt_b, _ = prefill("ref", params32, batch1, prefill32(
        Model(dataclasses.replace(cfg, attn_impl="blockwise"))))
    err, err_twin = float((got - want).abs().max()), float((twin - want).abs().max())
    assert err <= 2 * err_twin, f"fp32 prefill: kernel {err} vs plain, blockwise twin {err_twin}"
    print(f"serve prefill fp32 1x{LM_SEQ}: last-token logits, kernel vs plain max abs diff "
          f"{err_cut:.3g} at {cut.n_layers} layers (tolerance {LOGIT_TOL}); at "
          f"{cfg.n_layers} layers {err:.3g}, the plain blockwise twin {err_twin:.3g} "
          f"(bound: twice the twin's); kernel {dt_k:.3f} s, plain {dt_p:.3f} s, "
          f"blockwise {dt_b:.3f} s")
    del params_cut, twin

    # 3. the kernel prefill against scan_prefill through decode steps
    short = tokens[:, :128]
    got, _, _, _ = prefill("kernel", params32, {"tokens": short}, prefill32(model))
    caches = model.init_cache(LM_BATCH, 128, dtype=torch.float32, device="cuda")
    want, _ = scan_prefill(model, params32, caches, short, dtype=torch.float32)
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=PREFILL_DECODE_TOL, atol=PREFILL_DECODE_TOL)
    print(f"serve prefill_fn path vs scan_prefill (fp32, {LM_BATCH}x128): last-token "
          f"logits max abs diff {err:.3g} (tolerance {PREFILL_DECODE_TOL})")
    del params32, caches, got, want
    torch.cuda.empty_cache()

    # 4. the serving CLI and continuous batching
    out = serve.main(main_serve_args(LM_ARCH))
    assert out["finite"], "serve.main: non-finite logits"
    print(f"serve.main: decode {out['decode_ms_per_step']:.2f} ms/step, "
          f"{out['tokens_per_s']:.1f} tokens/s, prefill {out['prefill_s']:.2f} s, "
          f"finite logits {out['finite']}")
    torch.cuda.empty_cache()
    params = job.init_params(0)
    requests = driver_requests(cfg, 4)
    driver = RequestDriver(model, slots=4, max_len=DRIVER_PROMPTS[1] + DRIVER_NEW,
                           dtype=torch.bfloat16, decode_fn=job.decode_fn, device=job.device)
    res = driver.run(params, requests)
    outs = res["outputs"]
    ok = all(len(o) == DRIVER_NEW and 0 <= int(o.min()) and int(o.max()) < cfg.vocab_size
             for o in outs.values())
    assert res["completed"] == 8 and ok, res
    print(f"serve RequestDriver(slots=4) 8 requests: {res['steps']} steps, "
          f"{res['elapsed_s'] / res['steps'] * 1e3:.2f} ms/step, "
          f"{res['tokens_per_sec']:.1f} tokens/s, {res['requests_per_sec']:.2f} requests/s, "
          f"every output {DRIVER_NEW} tokens in the vocabulary: {ok}")
    # the same driver with a hub (fenced serve/admit and serve/decode spans)
    # and serving metrics: the same tokens
    hub = Telemetry(config={"arch": LM_ARCH, "slots": 4})
    metrics = ServingMetrics((1,), telemetry=hub)
    driver = RequestDriver(model, slots=4, max_len=DRIVER_PROMPTS[1] + DRIVER_NEW,
                           dtype=torch.bfloat16, decode_fn=job.decode_fn, device=job.device,
                           telemetry=hub, metrics=metrics)
    got = driver.run(params, requests)
    for i, o in outs.items():
        assert np.array_equal(got["outputs"][i], o), f"request {i}: tokens differ with a hub"
    assert hub.labels("span_seconds") == ("serve/admit", "serve/decode"), hub.labels(
        "span_seconds")
    decode = hub.collect()["span_seconds"]["series"]["serve/decode"]["summary"]
    assert decode["count"] == got["steps"], (decode, got["steps"])
    prom = metrics.prometheus()
    rps = [line for line in prom.splitlines()
           if line.startswith("repro_serving_requests_per_sec ")]
    assert rps, prom
    print(f"serve RequestDriver with a hub and ServingMetrics: tokens equal the hub-free "
          f"driver's; {got['steps']} serve/decode spans, p50 {decode['p50'] * 1e3:.2f} ms, "
          f"{got['elapsed_s'] / got['steps'] * 1e3:.2f} ms/step; prometheus {rps[0]}")
    del params, driver
    torch.cuda.empty_cache()
    return runs


def prefill_in(model, dtype):
    """``model.prefill`` in ``dtype`` under inference mode, as a prefill_fn."""
    def fn(p, b):
        with torch.inference_mode():
            return model.prefill(p, b, dtype=dtype)
    return fn


def moe_routes(api, mode, model, params, batch, dtype) -> list:
    """Per layer of a MoE model, the experts each token chose and the kept
    mask, ``(experts (B*S, k), keep)``, from a layer-by-layer forward whose
    attention runs in dispatch ``mode`` (the routing input is the block's
    own: the second norm of x plus the attention's output)."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import mlp as mlp_lib
    from repro_torch.tree import tree_map

    cfg, out = model.cfg, []
    with torch.inference_mode(), api.dispatch_mode(mode):
        x, positions = model._embed_inputs(params, batch, dtype)
        for layer in range(cfg.n_layers):
            bp = tree_map(lambda t: t[layer], params["blocks"]["b0"])
            y = attn_lib.attention_forward(cfg.attn_cfg("moe"), bp["attn"],
                                           model._norm(x, bp["norm1"]), positions)
            out.append(mlp_lib.moe_routing(cfg.moe_cfg(), bp["ffn"],
                                           model._norm(x + y, bp["norm2"])))
            x, _, _ = model._apply_block("moe", bp, x, positions, "fwd")
    return out


def topk_sets_differ(a: list, b: list) -> list:
    """Per layer, the tokens whose set of chosen experts differs."""
    return [int((torch.sort(ea, dim=-1).values != torch.sort(eb, dim=-1).values)
                .any(-1).sum()) for (ea, _), (eb, _) in zip(a, b)]


def dropped(routes: list) -> list:
    """Per layer, the (token, k) entries dropped past their expert's capacity."""
    return [int((~keep).sum()) for _, keep in routes]


def main_serve_args(arch: str) -> list:
    """``serve.main``'s flags on a full-width serving path (MAIN_SERVE)."""
    n, prompt, new = MAIN_SERVE
    return ["--arch", arch, "--requests", str(n), "--prompt-len", str(prompt),
            "--new-tokens", str(new)]


def driver_requests(cfg, seed: int) -> list:
    """A serving path's 8 driver requests: DRIVER_PROMPTS prompt tokens and
    DRIVER_NEW new ones each, drawn from ``seed``."""
    rng = torch.Generator().manual_seed(seed)
    return [(torch.randint(0, cfg.vocab_size, (int(n),), generator=rng).tolist(), DRIVER_NEW)
            for n in torch.randint(DRIVER_PROMPTS[0], DRIVER_PROMPTS[1] + 1, (8,), generator=rng)]


def serve_and_drive(cfg, job, arch: str, seed: int) -> None:
    """``serve.main`` at full width (fp32 parameters, freed after), then a
    4-slot bf16 ``RequestDriver`` of 8 requests through ``job.decode_fn``:
    every output DRIVER_NEW tokens in the vocabulary."""
    from repro_torch.launch import serve
    from repro_torch.serving import RequestDriver

    torch.cuda.empty_cache()
    print(f"device memory allocated before serve.main {arch}: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(main_serve_args(arch))
    assert out["finite"], "serve.main: non-finite logits"
    print(f"serve.main {arch}: decode {out['decode_ms_per_step']:.2f} ms/step, "
          f"{out['tokens_per_s']:.1f} tokens/s, prefill {out['prefill_s']:.2f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, finite logits "
          f"{out['finite']}")
    torch.cuda.empty_cache()
    params = job.init_params(0)
    requests = driver_requests(cfg, seed)
    driver = RequestDriver(job.model, slots=4, max_len=DRIVER_PROMPTS[1] + DRIVER_NEW,
                           dtype=torch.bfloat16, decode_fn=job.decode_fn, device=job.device)
    res = driver.run(params, requests)
    ok = all(len(o) == DRIVER_NEW and 0 <= int(o.min()) and int(o.max()) < cfg.vocab_size
             for o in res["outputs"].values())
    assert res["completed"] == 8 and ok, res
    print(f"serve {cfg.name} RequestDriver(slots=4) 8 requests: {res['steps']} steps, "
          f"{res['elapsed_s'] / res['steps'] * 1e3:.2f} ms/step, "
          f"{res['tokens_per_sec']:.1f} tokens/s, {res['requests_per_sec']:.2f} requests/s, "
          f"every output {DRIVER_NEW} tokens in the vocabulary: {ok}")
    del params, driver
    torch.cuda.empty_cache()


def moe_serving_path(api) -> list:
    """Phase 4b: Qwen1.5-MoE-A2.7B serving at full width, and Arctic 480B at
    full width on one of its layers.  Returns the launch counts of each run
    through the kernels."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving import scan_prefill

    print(f"device memory allocated as the phase starts: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    runs = []
    cfg = dataclasses.replace(get_config(MOE_ARCH), attn_impl="pallas")
    job = serve.make_serve_job(cfg, device="cuda")
    model = job.model
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = job.init_params(0)
    torch.cuda.synchronize()
    print(f"serve {cfg.name}: {cfg.param_count(params):,} parameters in {job.param_dtype}, "
          f"initialized in {time.perf_counter() - t0:.1f} s, peak memory while drawn "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (each leaf drawn in fp32)")
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ), generator=gen,
                           device="cuda")
    n_tok = MOE_BATCH * MOE_SEQ

    def prefill(mode, p, batch, fn, layers=cfg.n_layers):
        return run_prefill(api, runs, mode, p, batch, fn, {"flash_attention": layers})

    # 1. bf16 prefill of 2 x 8192 tokens: kernel, kernel, plain, kernel
    batch = {"tokens": tokens}
    rates = {}
    for mode in ("kernel", "kernel", "ref", "kernel"):
        logits, caches, dt, peak = prefill(mode, params, batch, job.prefill_fn)
        rates.setdefault(mode, []).append(n_tok / dt)
        print(f"serve {cfg.name} prefill bf16 {mode}: {MOE_BATCH}x{MOE_SEQ} tokens in "
              f"{dt:.3f} s, {n_tok / dt:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB, "
              f"launches {api.launch_counts()}")
        if mode == "ref":
            plain_logits = logits.float()
        else:
            kernel_logits = logits.float()
        del caches
    print(f"serve {cfg.name} prefill bf16 last-token logits, kernel vs plain: max abs diff "
          f"{float((kernel_logits - plain_logits).abs().max()):.4g} of "
          f"{float(plain_logits.abs().max()):.4g} ({cfg.n_layers} layers of bf16 rounding and "
          "routing on random weights; the kernel is held at the op level)")
    print(f"serve {cfg.name} prefill tokens/s: " + json.dumps(rates))
    del logits, kernel_logits, plain_logits
    trace_prefill(api, job.prefill_fn, params, batch, {"flash_attention": cfg.n_layers},
                  f"{cfg.name} prefill bf16 {MOE_BATCH}x{MOE_SEQ}",
                  ("attention", ATTENTION_KERNEL), MOE_RANGES)

    # 2. the other dispatch layouts, one bf16 prefill each: 'gather_tokens'
    #    is 'auto' bit for bit; 'grouped' (16 groups, local capacities)
    #    beside 'auto', with each one's dropped entries over the layers
    want, _, _, _ = prefill("kernel", params, batch, job.prefill_fn)
    layouts = {}
    for layout in ("gather_tokens", "grouped"):
        got, _, dt, peak = prefill("kernel", params, batch, serve.make_serve_job(
            dataclasses.replace(cfg, moe_dispatch=layout), device="cuda").prefill_fn)
        layouts[layout] = (got, dt, peak)
    assert torch.equal(layouts["gather_tokens"][0], want), "gather_tokens is not auto's bits"
    drops = {layout: sum(dropped(moe_routes(api, "kernel", Model(dataclasses.replace(
        cfg, moe_dispatch=layout)), params, batch, torch.bfloat16)))
        for layout in ("auto", "grouped")}
    grouped_cfg = dataclasses.replace(cfg, moe_dispatch="grouped").moe_cfg()
    assert grouped_cfg.dispatch_groups == MOE_GROUPS and n_tok % MOE_GROUPS == 0
    print(f"serve {cfg.name} dispatch layouts, bf16 prefill {MOE_BATCH}x{MOE_SEQ}: "
          f"'gather_tokens' equals 'auto' bit for bit; 'grouped' "
          f"({grouped_cfg.dispatch_groups} groups) {n_tok / layouts['grouped'][1]:.0f} tokens/s, "
          f"peak {layouts['grouped'][2] / 2**30:.2f} GiB, {drops['grouped']} of "
          f"{n_tok * cfg.top_k * cfg.n_layers} (token, k) entries dropped over the layers, "
          f"against 'auto' {drops['auto']} (rates of 'auto' above); last-token logits "
          f"grouped vs auto max abs diff "
          f"{float((layouts['grouped'][0].float() - want.float()).abs().max()):.4g}")
    del layouts, want, got, params
    torch.cuda.empty_cache()

    # 3. fp32 prefill at B=1, S=8192 on the first MOE_CUT layers at full
    #    width: kernel vs plain, held within twice the gap of the plain
    #    blockwise twin (as phase 4 holds Gemma-2 at 26 layers); a routing
    #    tie can flip under an ulp of attention output and shift the queues,
    #    so the tokens whose top-k sets differ are counted at each layer
    cut = dataclasses.replace(cfg, n_layers=MOE_CUT)
    twin_cut = dataclasses.replace(cut, attn_impl="blockwise")
    params32 = Model(cut).init(0, dtype=torch.float32, device="cuda")
    batch1 = {"tokens": tokens[:1]}
    got, _, dt_k, _ = prefill("kernel", params32, batch1, prefill_in(Model(cut), torch.float32),
                              cut.n_layers)
    want, _, dt_p, _ = prefill("ref", params32, batch1, prefill_in(Model(cut), torch.float32))
    twin, _, dt_b, _ = prefill("ref", params32, batch1, prefill_in(Model(twin_cut),
                                                                   torch.float32))
    err, err_twin = float((got - want).abs().max()), float((twin - want).abs().max())
    routes_plain = moe_routes(api, "ref", Model(cut), params32, batch1, torch.float32)
    flips = topk_sets_differ(moe_routes(api, "kernel", Model(cut), params32, batch1,
                                        torch.float32), routes_plain)
    flips_twin = topk_sets_differ(moe_routes(api, "ref", Model(twin_cut), params32, batch1,
                                             torch.float32), routes_plain)
    print(f"serve {cfg.name} prefill fp32 1x{MOE_SEQ} at {cut.n_layers} layers: last-token "
          f"logits, kernel vs plain max abs diff {err:.3g} of {float(want.abs().max()):.3g}, "
          f"the plain blockwise twin {err_twin:.3g} (bound: twice the twin's); tokens whose "
          f"top-{cfg.top_k} sets differ from plain by layer: kernel {flips}, twin "
          f"{flips_twin}; entries dropped by layer {dropped(routes_plain)}; kernel "
          f"{dt_k:.3f} s, plain {dt_p:.3f} s, blockwise {dt_b:.3f} s")
    assert err <= 2 * err_twin, f"fp32 prefill: kernel {err} vs plain, blockwise twin {err_twin}"
    del got, want, twin, routes_plain

    # 4. the prefill_fn path against scan_prefill (fp32, 2 x 128, the cut),
    #    at a capacity factor of 8: the prefill drops no token
    no_drop = dataclasses.replace(cut, capacity_factor=MOE_NO_DROP_FACTOR)
    short = {"tokens": tokens[:, :128]}
    print(f"serve {cfg.name} prefill vs decode steps: capacity factor raised from "
          f"{cfg.capacity_factor} to {MOE_NO_DROP_FACTOR}: at {cfg.capacity_factor} a "
          f"{MOE_BATCH}x128 prefill has a capacity of "
          f"{int(cfg.capacity_factor * MOE_BATCH * 128 * cfg.top_k / cfg.n_experts)} a queue "
          "and may drop tokens (in the reference too), where a decode step never drops one")
    assert sum(dropped(moe_routes(api, "kernel", Model(no_drop), params32, short,
                                  torch.float32))) == 0
    got, _, _, _ = prefill("kernel", params32, short, prefill_in(Model(no_drop), torch.float32),
                           cut.n_layers)
    caches = Model(no_drop).init_cache(MOE_BATCH, 128, dtype=torch.float32, device="cuda")
    want, _ = scan_prefill(Model(no_drop), params32, caches, short["tokens"],
                           dtype=torch.float32)
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=PREFILL_DECODE_TOL, atol=PREFILL_DECODE_TOL)
    print(f"serve {cfg.name} prefill_fn path vs scan_prefill (fp32, {MOE_BATCH}x128, "
          f"{cut.n_layers} layers, no token dropped): last-token logits max abs diff "
          f"{err:.3g} (tolerance {PREFILL_DECODE_TOL})")
    del params32, caches, got, want
    torch.cuda.empty_cache()

    # 5. the serving CLI (fp32, about 53 GiB of parameters) and a 4-slot
    #    bf16 RequestDriver, both at full width
    serve_and_drive(cfg, job, MOE_ARCH, seed=12)

    # 6. Arctic 480B at full width on 1 of its 35 layers (the reduction is
    #    depth only): bf16 prefill of 1 x 4096, kernel vs plain
    full = get_config(ARCTIC_ARCH)
    acfg = dataclasses.replace(full, n_layers=1, attn_impl="pallas")
    ajob = serve.make_serve_job(acfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    aparams = ajob.init_params(0)
    torch.cuda.synchronize()
    print(f"serve {acfg.name}: depth cut from {full.n_layers} layers to {acfg.n_layers}, "
          f"widths as published; {acfg.param_count(aparams):,} parameters in "
          f"{ajob.param_dtype}, initialized in {time.perf_counter() - t0:.1f} s, peak memory "
          f"while drawn {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    abatch = {"tokens": torch.randint(0, acfg.vocab_size, (1, ARCTIC_SEQ), generator=gen,
                                      device="cuda")}
    arates = {}
    for mode in ("kernel", "kernel", "ref", "kernel"):
        logits, caches, dt, peak = prefill(mode, aparams, abatch, ajob.prefill_fn, 1)
        arates.setdefault(mode, []).append(ARCTIC_SEQ / dt)
        print(f"serve {acfg.name} prefill bf16 {mode}: 1x{ARCTIC_SEQ} tokens in {dt:.4f} s, "
              f"{ARCTIC_SEQ / dt:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB")
        if mode == "ref":
            plain_logits = logits.float()
        else:
            kernel_logits = logits.float()
        del caches
    print(f"serve {acfg.name} prefill tokens/s: " + json.dumps(arates) + "; last-token "
          f"logits kernel vs plain max abs diff "
          f"{float((kernel_logits - plain_logits).abs().max()):.4g} of "
          f"{float(plain_logits.abs().max()):.4g}")
    del aparams, logits, kernel_logits, plain_logits
    torch.cuda.empty_cache()
    return runs


def hybrid_serving_path(api) -> list:
    """Phase 4c: Zamba2-7B serving at full width (27 x (mamba, mamba,
    shared_attn); the shared block's attention at D=112 through the flash
    kernel, zero-padded to 128).  Returns the launch counts of each run
    through the kernels."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving import scan_prefill
    from repro_torch.tree import tree_map

    print(f"device memory allocated as the phase starts: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    runs = []
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), attn_impl="pallas")
    n_attn = cfg.block_unit.count("shared_attn") * cfg.repeats
    job = serve.make_serve_job(cfg, device="cuda")
    model = job.model
    t0 = time.perf_counter()
    params = job.init_params(0)
    torch.cuda.synchronize()
    print(f"serve {cfg.name}: {cfg.param_count(params):,} parameters in {job.param_dtype}, "
          f"initialized in {time.perf_counter() - t0:.1f} s; {n_attn} applications of the "
          f"shared attention block (head_dim {cfg.hd}), {cfg.n_layers - n_attn} Mamba-2 blocks")
    gen = torch.Generator(device="cuda").manual_seed(13)
    tokens = torch.randint(0, cfg.vocab_size, (HYBRID_BATCH, HYBRID_SEQ), generator=gen,
                           device="cuda")
    n_tok = HYBRID_BATCH * HYBRID_SEQ

    def prefill(mode, p, batch, fn, launches=n_attn):
        return run_prefill(api, runs, mode, p, batch, fn, {"flash_attention": launches})

    # 1. bf16 prefill of 2 x 8192 tokens: kernel, kernel, plain, kernel; traced
    batch = {"tokens": tokens}
    rates = {}
    for mode in ("kernel", "kernel", "ref", "kernel"):
        logits, caches, dt, peak = prefill(mode, params, batch, job.prefill_fn)
        rates.setdefault(mode, []).append(n_tok / dt)
        print(f"serve {cfg.name} prefill bf16 {mode}: {HYBRID_BATCH}x{HYBRID_SEQ} tokens in "
              f"{dt:.3f} s, {n_tok / dt:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB, "
              f"launches {api.launch_counts()}")
        if mode == "ref":
            plain_logits = logits.float()
        else:
            kernel_logits = logits.float()
        del caches
    print(f"serve {cfg.name} prefill bf16 last-token logits, kernel vs plain: max abs diff "
          f"{float((kernel_logits - plain_logits).abs().max()):.4g} of "
          f"{float(plain_logits.abs().max()):.4g} ({cfg.n_layers} layers of bf16 rounding on "
          "random weights; the kernel is held at the op level)")
    print(f"serve {cfg.name} prefill tokens/s: " + json.dumps(rates))
    del logits, kernel_logits, plain_logits
    trace_prefill(api, job.prefill_fn, params, batch, {"flash_attention": n_attn},
                  f"{cfg.name} prefill bf16 {HYBRID_BATCH}x{HYBRID_SEQ}",
                  ("attention", ATTENTION_KERNEL), SSD_RANGES)
    del params
    torch.cuda.empty_cache()

    # 2. fp32 prefill at B=1, S=8192: kernel vs plain, last-token logits
    #    relative to their max abs, within LOGIT_TOL at HYBRID_CUT layers;
    #    at all 81 within twice the gap of the plain blockwise twin
    params32 = model.init(0, dtype=torch.float32, device="cuda")
    batch1 = {"tokens": tokens[:1]}
    cut = dataclasses.replace(cfg, n_layers=HYBRID_CUT)
    n_cut = cut.block_unit.count("shared_attn") * cut.repeats

    def first(p, layers):   # stacked blocks cut to the first repeats; shared kept
        return {**p, "blocks": {k: v if kind == "shared_attn" else
                                tree_map(lambda t: t[:layers // len(cfg.block_unit)], v)
                                for (k, v), kind in zip(p["blocks"].items(), cfg.block_unit)}}

    p_cut = first(params32, HYBRID_CUT)
    got, _, _, _ = prefill("kernel", p_cut, batch1, prefill_in(Model(cut), torch.float32), n_cut)
    want, _, _, _ = prefill("ref", p_cut, batch1, prefill_in(Model(cut), torch.float32))
    gap_cut = float((got - want).abs().max() / want.abs().max())
    assert gap_cut <= LOGIT_TOL, f"fp32 prefill at {HYBRID_CUT} layers: relative gap {gap_cut}"
    got, _, dt_k, _ = prefill("kernel", params32, batch1, prefill_in(model, torch.float32))
    want, _, dt_p, _ = prefill("ref", params32, batch1, prefill_in(model, torch.float32))
    twin, _, dt_b, _ = prefill("ref", params32, batch1, prefill_in(
        Model(dataclasses.replace(cfg, attn_impl="blockwise")), torch.float32))
    err, err_twin = float((got - want).abs().max()), float((twin - want).abs().max())
    print(f"serve {cfg.name} prefill fp32 1x{HYBRID_SEQ}: last-token logits, kernel vs plain "
          f"relative to their max abs {gap_cut:.3g} at {HYBRID_CUT} layers (tolerance "
          f"{LOGIT_TOL}); at {cfg.n_layers} layers max abs diff {err:.3g} of "
          f"{float(want.abs().max()):.3g}, the plain blockwise twin {err_twin:.3g} (bound: "
          f"twice the twin's); kernel {dt_k:.3f} s, plain {dt_p:.3f} s, blockwise {dt_b:.3f} s")
    assert err <= 2 * err_twin, f"fp32 prefill: kernel {err} vs plain, blockwise twin {err_twin}"
    del got, want, twin

    # 3. the prefill_fn path against scan_prefill through decode steps
    #    (fp32, 2 x 128, on the cut: 128 decode steps through 81 layers are
    #    host-bound seconds, and the check is of each block's two paths)
    short = tokens[:, :128]
    got, got_caches, _, _ = prefill("kernel", p_cut, {"tokens": short},
                                    prefill_in(Model(cut), torch.float32), n_cut)
    caches = Model(cut).init_cache(HYBRID_BATCH, 128, dtype=torch.float32, device="cuda")
    want, want_caches = scan_prefill(Model(cut), p_cut, caches, short, dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=PREFILL_DECODE_TOL, atol=PREFILL_DECODE_TOL)
    ssm_err = float((got_caches["b0"]["mamba"]["ssm"] - want_caches["b0"]["mamba"]["ssm"])
                    .abs().max())
    torch.testing.assert_close(got_caches["b0"]["mamba"]["ssm"],
                               want_caches["b0"]["mamba"]["ssm"],
                               rtol=PREFILL_DECODE_TOL, atol=PREFILL_DECODE_TOL)
    print(f"serve {cfg.name} prefill_fn path vs scan_prefill (fp32, {HYBRID_BATCH}x128, "
          f"{HYBRID_CUT} layers): last-token logits max abs diff "
          f"{float((got - want).abs().max()):.3g}, first Mamba-2 element's SSM states "
          f"{ssm_err:.3g} (tolerance {PREFILL_DECODE_TOL})")
    del params32, p_cut, caches, got, want, got_caches, want_caches
    torch.cuda.empty_cache()

    # 4. the serving CLI (fp32) and a 4-slot bf16 RequestDriver at full width
    serve_and_drive(cfg, job, HYBRID_ARCH, seed=14)
    return runs


def vision_batch(cfg, batch: int, text: int, dtype, gen) -> dict:
    """Random text tokens and vision embeddings (a stand-in for the vision
    encoder's output) for a Qwen2-VL model, on the card."""
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, text), generator=gen,
                                    device="cuda"),
            "vision_embeds": torch.randn((batch, cfg.n_vision_tokens, cfg.d_model),
                                         generator=gen, device="cuda").to(dtype)}


def first_repeats(params, repeats: int) -> dict:
    """Parameters with the stacked blocks cut to their first ``repeats``
    (layers, for a block unit of one element)."""
    from repro_torch.tree import tree_map

    return {**params, "blocks": tree_map(lambda t: t[:repeats], params["blocks"])}


def vlm_audio_path(api) -> list:
    """Phase 4d: Qwen2-VL-2B serving at full width (M-RoPE, the vision front
    end, 28 flash launches a prefill) and the HuBERT X-Large encoder at full
    width.  Returns the launch counts of each run through the kernels."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.tree import tree_map

    print(f"device memory allocated as the phase starts: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    runs = []
    cfg = dataclasses.replace(get_config(VLM_ARCH), attn_impl="pallas")
    job = serve.make_serve_job(cfg, device="cuda")
    model = job.model
    t0 = time.perf_counter()
    params = job.init_params(0)
    torch.cuda.synchronize()
    print(f"serve {cfg.name}: {cfg.param_count(params):,} parameters in {job.param_dtype}, "
          f"initialized in {time.perf_counter() - t0:.1f} s; M-RoPE sections "
          f"{cfg.mrope_sections}, {cfg.n_vision_tokens} vision tokens on a {cfg.vision_grid} grid")
    gen = torch.Generator(device="cuda").manual_seed(21)
    batch = vision_batch(cfg, VLM_BATCH, VLM_TEXT, torch.bfloat16, gen)
    seq = cfg.n_vision_tokens + VLM_TEXT
    n_tok = VLM_BATCH * seq

    def prefill(mode, p, b, fn, layers=cfg.n_layers):
        return run_prefill(api, runs, mode, p, b, fn, {"flash_attention": layers})

    # 1. bf16 prefill of 2 x 8192 tokens: kernel, kernel, plain, kernel; traced
    rates = {}
    for mode in ("kernel", "kernel", "ref", "kernel"):
        logits, caches, dt, peak = prefill(mode, params, batch, job.prefill_fn)
        rates.setdefault(mode, []).append(n_tok / dt)
        print(f"serve {cfg.name} prefill bf16 {mode}: {VLM_BATCH}x({cfg.n_vision_tokens}+"
              f"{VLM_TEXT}) tokens in {dt:.3f} s, {n_tok / dt:.0f} tokens/s, peak memory "
              f"{peak / 2**30:.2f} GiB, launches {api.launch_counts()}")
        assert caches["b0"]["attn"]["k"].shape == (cfg.repeats, VLM_BATCH, seq, cfg.n_kv_heads,
                                                   cfg.hd)
        # the cached positions are M-RoPE's temporal stream: 0 on the vision block
        assert int(caches["b0"]["attn"]["pos"][0, :, :cfg.n_vision_tokens].abs().max()) == 0
        if mode == "ref":
            plain_logits = logits.float()
        else:
            kernel_logits = logits.float()
        del caches
    print(f"serve {cfg.name} prefill bf16 last-token logits, kernel vs plain: max abs diff "
          f"{float((kernel_logits - plain_logits).abs().max()):.4g} of "
          f"{float(plain_logits.abs().max()):.4g} ({cfg.n_layers} layers of bf16 rounding on "
          "random weights; the kernel is held at the op level)")
    print(f"serve {cfg.name} prefill tokens/s: " + json.dumps(rates))
    del logits, kernel_logits, plain_logits
    trace_prefill(api, job.prefill_fn, params, batch, {"flash_attention": cfg.n_layers},
                  f"{cfg.name} prefill bf16 {VLM_BATCH}x{seq}", ("attention", ATTENTION_KERNEL))
    del params
    torch.cuda.empty_cache()

    # 2. fp32 prefill at B=1: kernel against the flash op's plain version,
    #    relative to the logits' max abs
    params32 = model.init(0, dtype=torch.float32, device="cuda")
    batch1 = {"tokens": batch["tokens"][:1], "vision_embeds": batch["vision_embeds"][:1].float()}
    cut = dataclasses.replace(cfg, n_layers=VLM_CUT)
    p_cut = first_repeats(params32, VLM_CUT)
    got, _, _, _ = prefill("kernel", p_cut, batch1, prefill_in(Model(cut), torch.float32),
                           VLM_CUT)
    want, _, _, _ = prefill("ref", p_cut, batch1, prefill_in(Model(cut), torch.float32))
    gap_cut = float((got - want).abs().max() / want.abs().max())
    got, _, dt_k, _ = prefill("kernel", params32, batch1, prefill_in(model, torch.float32))
    want, _, dt_p, _ = prefill("ref", params32, batch1, prefill_in(model, torch.float32))
    gap = float((got - want).abs().max() / want.abs().max())
    print(f"serve {cfg.name} prefill fp32 1x{seq}: last-token logits, kernel vs the flash op's "
          f"plain version, relative to their max abs: {gap_cut:.3g} at {VLM_CUT} layers "
          f"(tolerance {VLM_CUT_TOL}), {gap:.3g} at {cfg.n_layers} (band {VLM_FULL_TOL}); "
          f"kernel {dt_k:.3f} s, plain {dt_p:.3f} s")
    assert gap_cut <= VLM_CUT_TOL, f"fp32 prefill at {VLM_CUT} layers: relative gap {gap_cut}"
    assert gap <= VLM_FULL_TOL, f"fp32 prefill at {cfg.n_layers} layers: relative gap {gap}"
    del params32, p_cut, got, want
    torch.cuda.empty_cache()

    # 3. the serving CLI (fp32, text prompts) and a 4-slot bf16 RequestDriver
    serve_and_drive(cfg, job, VLM_ARCH, seed=22)

    # 4. HuBERT X-Large: Model.forward in bf16 on 8 clips of 1500 frames
    acfg = get_config(AUDIO_ARCH)
    amodel = Model(acfg)
    t0 = time.perf_counter()
    aparams = amodel.init(0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    print(f"{acfg.name}: {acfg.param_count(aparams):,} parameters in bf16, initialized in "
          f"{time.perf_counter() - t0:.1f} s; {acfg.n_layers} bidirectional layers, "
          f"{acfg.n_heads} heads of {acfg.hd}, frame head over {acfg.vocab_size} units")
    agen = torch.Generator(device="cuda").manual_seed(23)
    frames = torch.randn((AUDIO_CLIPS, AUDIO_FRAMES, acfg.audio_frontend_dim), generator=agen,
                         device="cuda").to(torch.bfloat16)

    def encode(p, b):
        with torch.inference_mode():
            return amodel.forward(p, b, dtype=torch.bfloat16)

    for _ in range(3):
        api.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _ = encode(aparams, {"frames": frames})
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        assert api.launch_counts() == {}, api.launch_counts()
        assert logits.shape == (AUDIO_CLIPS, AUDIO_FRAMES, acfg.vocab_size)
        assert bool(torch.isfinite(logits).all()), "HuBERT logits not finite"
        print(f"{acfg.name} forward bf16: {AUDIO_CLIPS}x{AUDIO_FRAMES} frames in {dt:.3f} s, "
              f"{AUDIO_CLIPS * AUDIO_FRAMES / dt:.0f} frames/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del logits
    trace_prefill(api, encode, aparams, {"frames": frames}, {},
                  f"{acfg.name} forward bf16 {AUDIO_CLIPS}x{AUDIO_FRAMES}", ("softmax", "softmax"))
    del aparams
    torch.cuda.empty_cache()

    # 5. fp32 on AUDIO_CUT full-width layers: the card against the CPU
    acut = dataclasses.replace(acfg, n_layers=AUDIO_CUT)
    p32 = Model(acut).init(0, dtype=torch.float32, device="cuda")
    clip = {"frames": frames[:1].float()}
    p_cpu = tree_map(lambda t: t.cpu(), p32)
    with torch.inference_mode():
        got, _ = Model(acut).forward(p32, clip, dtype=torch.float32)
        want, _ = Model(acut).forward(p_cpu, {"frames": clip["frames"].cpu()}, dtype=torch.float32)
    got = got.cpu()
    scale = float(want.abs().max())
    print(f"{acfg.name} forward fp32 1x{AUDIO_FRAMES} on {AUDIO_CUT} layers, card vs CPU: max "
          f"abs diff {float((got - want).abs().max()):.3g} of {scale:.3g} (rtol {AUDIO_TOL}, "
          f"atol {AUDIO_TOL} of the max)")
    torch.testing.assert_close(got, want, rtol=AUDIO_TOL, atol=AUDIO_TOL * scale)
    del p32, p_cpu
    torch.cuda.empty_cache()
    return runs


def training_path(api) -> list:
    """Phase 4e: LM training on the card through ``Model.loss`` and
    ``torch.autograd.grad``: Qwen2-VL-2B at full width, the flash kernel in
    every layer's forward, the plain version's gradient in the backward.
    Returns the launch counts of each training step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.tree import tree_flatten, tree_unflatten

    print(f"device memory allocated as the phase starts: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    runs = []
    cfg = dataclasses.replace(get_config(VLM_ARCH), attn_impl="pallas")
    model = Model(cfg)
    params = model.init(0, dtype=torch.float32, device="cuda")
    leaves, _ = tree_flatten(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(31)
    batch = vision_batch(cfg, 1, TRAIN_TEXT, torch.bfloat16, gen)
    batch["targets"] = torch.randint(0, cfg.vocab_size, (1, TRAIN_TEXT), generator=gen,
                                     device="cuda")
    n_tok = cfg.n_vision_tokens + TRAIN_TEXT
    # phase 2 held the kernel to its plain version at this step's shape
    assert ("qwen2_vl_train", 1, cfg.n_heads, cfg.n_kv_heads, n_tok) in \
        [c[:5] for c in FLASH_CASES], "no phase-2 flash case at the training shape"
    print(f"train {cfg.name}: {cfg.param_count(params):,} fp32 parameters, bf16 activations, "
          f"1x({cfg.n_vision_tokens}+{TRAIN_TEXT}) tokens, plain SGD lr {TRAIN_LR}")

    # 1. TRAIN_STEPS steps on one batch: loss, gradients, update; fenced
    losses = []
    for step in range(TRAIN_STEPS):
        api.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = model.loss(params, batch, dtype=torch.bfloat16)
        forward_launches = api.launch_counts()
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for leaf, g in zip(leaves, grads):
                leaf.add_(g, alpha=-TRAIN_LR)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = api.launch_counts()
        assert launches == forward_launches == {"flash_attention": cfg.n_layers}, launches
        runs.append(launches)
        losses.append(float(loss.detach()))
        assert math.isfinite(losses[-1]), f"training step {step}: loss {losses[-1]}"
        print(f"train {cfg.name} step {step}: loss {losses[-1]:.6f}, {dt * 1e3:.1f} ms "
              f"({n_tok / dt:.0f} tokens/s), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches} "
              "(the backward launches none)")
        del loss, grads
    assert all(b < a for a, b in zip(losses, losses[1:])), f"the loss did not fall: {losses}"
    trace_prefill(api, lambda p, b: torch.autograd.grad(model.loss(p, b, dtype=torch.bfloat16),
                                                        leaves),
                  params, batch, {"flash_attention": cfg.n_layers},
                  f"train {cfg.name} loss and gradients 1x{n_tok}", ("attention", ATTENTION_KERNEL))

    # 2. gradients at TRAIN_CUT layers in fp32: the kernel's forward against
    #    the plain version's, each leaf within GRAD_BAND of its max |gradient|
    cut = Model(dataclasses.replace(cfg, n_layers=TRAIN_CUT))
    cut_leaves, cut_def = tree_flatten(first_repeats(params, TRAIN_CUT))
    cut_leaves = [t.detach().clone().requires_grad_(True) for t in cut_leaves]
    del params, leaves
    torch.cuda.empty_cache()
    p_cut = tree_unflatten(cut_def, cut_leaves)
    batch32 = dict(batch, vision_embeds=batch["vision_embeds"].float())
    grads = {}
    for mode in ("kernel", "ref"):
        api.reset_counters()
        with api.dispatch_mode(mode):
            grads[mode] = torch.autograd.grad(cut.loss(p_cut, batch32, dtype=torch.float32),
                                              cut_leaves)
        torch.cuda.synchronize()
        assert api.launch_counts() == ({"flash_attention": TRAIN_CUT} if mode == "kernel"
                                       else {}), api.launch_counts()
    worst = max(float((g - w).abs().max()) / float(w.abs().max())
                for g, w in zip(grads["kernel"], grads["ref"]))
    print(f"train {cfg.name} gradients fp32 at {TRAIN_CUT} layers, kernel forward vs plain: "
          f"worst leaf's max abs diff {worst:.3g} of its max |gradient| (band {GRAD_BAND}) over "
          f"{len(cut_leaves)} leaves")
    assert worst <= GRAD_BAND, f"gradients at {TRAIN_CUT} layers: {worst}"
    del grads, p_cut, cut_leaves
    torch.cuda.empty_cache()
    return runs


def fingerprint(tree) -> list:
    """Exact int64 sums of each leaf's 32-bit words: any change of a leaf
    moves its sum with near certainty (it shows that a snapshot did not
    move when the live parameters did)."""
    from repro_torch.tree import tree_leaves

    return [int(t.detach().view(torch.int32).sum(dtype=torch.int64)) for t in tree_leaves(tree)]


def relative_error(got, want) -> float:
    """||got - want|| / ||want|| over whole trees, in fp64 on the host."""
    from repro_torch.tree import tree_leaves

    num = den = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        w = w.detach().float()
        num += float(torch.linalg.vector_norm(g.float() - w)) ** 2
        den += float(torch.linalg.vector_norm(w)) ** 2
    return math.sqrt(num / den)


def load_example(name: str):
    """An example script of ``examples/`` as a module (its ``main`` uncalled)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def snapshot_top_k_timing(api, bw, codec, leaf) -> dict:
    """The top-k pair at the snapshot's largest leaf, one replica: bit-equal
    to plain, timed beside its bound, the plain version and the library
    call, and the unpack by stage (rows of more than 4,096 tiles count and
    place with one global atomic an entry)."""
    from repro_torch.kernels.comm_compress.kernel import UNPACK_TILE

    x = leaf.detach().reshape(1, -1)
    packed = codec.encode(x, 0)
    idx, vals = packed.data["idx"], packed.data["vals"]
    n, d = x.shape
    k = idx.shape[1]
    tiles = -(-d // UNPACK_TILE)
    assert tiles > 4096, f"the snapshot's largest leaf has {tiles} tiles"
    i64 = idx.long()
    out = torch.empty_like(x)
    got = api.call("top_k_pack", x, idx)
    with api.dispatch_mode("ref"):
        want = api.call("top_k_pack", x, idx)
        dense_want = api.call("top_k_unpack", idx, vals, d=d)
    dense = api.call("top_k_unpack", idx, vals, d=d)
    assert same_bits(got, want) and same_bits(dense, dense_want), "top-k at the snapshot shape"
    del got, want, dense, dense_want

    def plain(op, *args, **kw):
        with api.dispatch_mode("ref"):
            return api.call(op, *args, **kw)

    eb = x.element_size()
    pack_ms = abba_ms(lambda: api.call("top_k_pack", x, idx), lambda: plain("top_k_pack", x, idx),
                      lambda: torch.gather(x, 1, i64, out=vals))
    unpack_ms = abba_ms(lambda: api.call("top_k_unpack", idx, vals, d=d),
                        lambda: plain("top_k_unpack", idx, vals, d=d),
                        lambda: out.zero_().scatter_add_(1, i64, vals))
    stages = stage_ms(lambda: api.call("top_k_unpack", idx, vals, d=d),
                      ("count_kernel", "scan_kernel", "place_kernel", "tile_kernel"))
    shape = {"n": n, "d": d, "k": k, "tiles": tiles}
    rows = {
        "top_k_pack": dict(shape, ms=pack_ms[0], plain_ms=pack_ms[1], library_ms=pack_ms[2],
                           bound_ms=n * k * (4 + 2 * eb) / bw * 1e3),
        "top_k_unpack": dict(shape, ms=unpack_ms[0], plain_ms=unpack_ms[1],
                             library_ms=unpack_ms[2], pass_ms=stages,
                             bound_ms=(n * d * eb + n * k * (4 + eb)) / bw * 1e3),
    }
    for name, row in rows.items():
        print(f"kernel {name} at the snapshot's largest leaf (1 x {d:,}, k {k:,}, {tiles:,} "
              f"tiles), bit-equal to plain: ms={row['ms']:.4f} bound_ms={row['bound_ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f}"
              + (f"; by stage (CUPTI, median of 10 calls) "
                 + json.dumps({s: round(v, 4) for s, v in stages.items()})
                 if name == "top_k_unpack" else ""))
    del x, packed, idx, vals, i64, out
    torch.cuda.empty_cache()
    return rows


def serve_while_training_path(api, bw) -> tuple:
    """Phase 4f: the serving plane on the card while Qwen2-VL-2B trains at
    full width.  Returns the launch counts of each run through the kernels
    and the top-k rows at the snapshot shape."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serving import RemoteReplica, ReplicaSet, SnapshotFeed, SnapshotPublisher
    from repro_torch.tree import tree_flatten, tree_leaves

    torch.cuda.empty_cache()
    print(f"device memory allocated as the phase starts: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()
    runs = []
    cfg = dataclasses.replace(get_config(VLM_ARCH), attn_impl="pallas")
    model = Model(cfg)
    params = model.init(0, dtype=torch.float32, device="cuda")
    leaves, _ = tree_flatten(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    n_leaves = len(leaves)
    big = max(range(n_leaves), key=lambda i: leaves[i].numel())
    gen = torch.Generator(device="cuda").manual_seed(31)
    batch = vision_batch(cfg, 1, TRAIN_TEXT, torch.bfloat16, gen)
    batch["targets"] = torch.randint(0, cfg.vocab_size, (1, TRAIN_TEXT), generator=gen,
                                     device="cuda")
    raw_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"serve while training {cfg.name}: {cfg.param_count(params):,} fp32 parameters "
          f"({raw_bytes / 1e9:.3f} GB) in {n_leaves} leaves, the largest "
          f"{tuple(leaves[big].shape)}; plain SGD lr {TRAIN_LR} on 1x({cfg.n_vision_tokens}+"
          f"{TRAIN_TEXT}) tokens, bf16 activations; snapshot sets "
          + ", ".join(f"{c} bounds {b}" for c, b in SNAP_SETS))
    losses = []

    def sgd_step() -> float:
        api.reset_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = model.loss(params, batch, dtype=torch.bfloat16)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for leaf, g in zip(leaves, grads):
                leaf.add_(g, alpha=-TRAIN_LR)
        del grads   # freed before any publish
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = api.launch_counts()
        assert launches == {"flash_attention": cfg.n_layers}, launches
        runs.append(launches)
        losses.append(float(loss.detach()))
        assert math.isfinite(losses[-1]), f"training step {len(losses)}: loss {losses[-1]}"
        return dt

    each_leaf = {"qsgd": ("qsgd_quantize", "qsgd_dequantize"),
                 "top_k": ("top_k_pack", "top_k_unpack"), "identity": ()}

    def expected(codec, times=1):
        return {op: n_leaves * times for op in each_leaf[codec.split(":")[0]]}

    def publish(target, codec):
        api.reset_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        info = target.publish(params)   # host numpy: fenced by its copy
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = api.launch_counts()
        assert launches == expected(codec), (codec, launches)
        runs.append(launches)
        return info, ms, launches

    # 1. SNAP_STEPS SGD steps, each followed by a publish to every set
    sets = {codec: ReplicaSet(params, codec=codec, bounds=bounds) for codec, bounds in SNAP_SETS}
    print(f"snapshot sets allocated: {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    mirror = sets["identity"]
    publish_ms = {codec: [] for codec in sets}
    last_fp = None
    for step in range(SNAP_STEPS):
        dt = sgd_step()
        if last_fp is not None:
            # the step updated the parameters in place; the identity
            # snapshot of the step before must not have moved with them
            assert fingerprint(mirror.params_for(0)) == last_fp, "the identity snapshot moved"
            assert not all(torch.equal(h, p.detach()) for h, p in
                           zip(tree_leaves(mirror.params_for(0)), leaves)), "aliased snapshot"
        line = []
        for codec, rs in sets.items():
            info, ms, launches = publish(rs, codec)
            publish_ms[codec].append(ms)
            line.append(f"{codec} {ms:.1f} ms sent {info['sent'].astype(int).tolist()} age "
                        f"{info['age'].tolist()} drift {[round(float(x), 6) for x in info['drift']]} "
                        f"launches {json.dumps(launches)}")
        for h, p in zip(tree_leaves(mirror.params_for(0)), leaves):
            assert torch.equal(h, p.detach()), "the identity mirror is not the live parameters"
            assert h.untyped_storage().data_ptr() != p.untyped_storage().data_ptr()
        last_fp = fingerprint(mirror.params_for(0))
        print(f"serve while training step {step}: loss {losses[-1]:.6f}, step {dt * 1e3:.1f} ms; "
              f"publish " + "; ".join(line) + "; the identity mirror equals the live parameters "
              f"bit for bit, in storage of its own; memory allocated "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    print(f"serve while training, peak memory through {SNAP_STEPS} steps and "
          f"{SNAP_STEPS * len(sets)} publishes: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for codec, rs in sets.items():
        rs.assert_slo()
        msg = rs.publisher.message_bytes(params)
        refreshes = [-(-SNAP_STEPS // b) for b in rs.bounds]
        link = rs.link_bytes()
        errs = [relative_error(rs.params_for(r), params) for r in range(rs.n_replicas)]
        ms = publish_ms[codec]
        print(f"snapshot set {codec} bounds {rs.bounds}: publish first {ms[0]:.1f} ms, then "
              f"{statistics.median(ms[1:]):.1f} ms (median of {len(ms) - 1}: "
              f"{[round(m, 1) for m in ms[1:]]}); SLO {rs.slo_report()}; link bytes per replica "
              f"{link.tolist()} against message_bytes {msg:,} x refreshes {refreshes} (raw "
              f"fp32 {raw_bytes:,}, {raw_bytes / msg:.3f}x a message); served relative error "
              f"against live {[f'{e:.4g}' for e in errs]}")
        # the info's bytes are fp32, as the reference's
        assert link.tolist() == [float(torch.tensor(float(msg)).item()) * n for n in refreshes]
        if codec == "identity":
            assert errs == [0.0], errs

    # 2. replica 0 of the QSGD set serves a bf16 prefill beside the live params
    job = serve.make_serve_job(cfg, device="cuda")
    sbatch = vision_batch(cfg, SNAP_SERVE_BATCH, TRAIN_TEXT, torch.bfloat16, gen)
    n_tok = SNAP_SERVE_BATCH * (cfg.n_vision_tokens + TRAIN_TEXT)
    served = {}
    for label, p in (("qsgd replica 0", sets["qsgd"].params_for(0)), ("live", params)):
        logits, caches, dt, peak = run_prefill(api, runs, "kernel", p, sbatch, job.prefill_fn,
                                               {"flash_attention": cfg.n_layers})
        del caches
        served[label] = logits[:, -1].float()
        print(f"serve {cfg.name} from {label}: bf16 prefill {SNAP_SERVE_BATCH}x"
              f"({cfg.n_vision_tokens}+{TRAIN_TEXT}) in {dt:.3f} s, {n_tok / dt:.0f} tokens/s, "
              f"{cfg.n_layers} flash launches, greedy tokens "
              f"{served[label].argmax(-1).tolist()}")
    gap = float((served["qsgd replica 0"] - served["live"]).abs().max()
                / served["live"].abs().max())
    print(f"serve {cfg.name}: last-token logits of the QSGD replica against the live params, "
          f"max abs diff {gap:.4g} of their max abs; greedy tokens agree on "
          f"{int((served['qsgd replica 0'].argmax(-1) == served['live'].argmax(-1)).sum())} of "
          f"{SNAP_SERVE_BATCH} prompts")
    del served, logits
    del mirror, sets["identity"]
    torch.cuda.empty_cache()

    # 3. kernel against plain on one publish of each lossy set, from the same
    #    state and seeds: top-k bit for bit; QSGD within the codec's band
    #    (each after one more publish of its set traced: device time by kernel)
    for codec, focus in (("top_k:0.01", ("top-k kernels", "pack_kernel<", "count_kernel",
                                         "scan_kernel", "place_kernel<", "tile_kernel<")),
                         ("qsgd", ("QSGD kernels", "_qsgd_"))):
        rs = sets[codec]
        trace_prefill(api, lambda state, p, pub=rs.publisher: pub.publish(state, p), rs.state,
                      params, expected(codec), f"{codec} publish of {cfg.name}", focus)
    rs = sets["top_k:0.01"]
    pub, before = rs.publisher, rs.state
    got, _ = pub.publish(before, params)
    with api.dispatch_mode("ref"):
        want, _ = pub.publish(before, params)
    for a, b in zip(tree_leaves(got.hat), tree_leaves(want.hat)):
        assert same_bits(a, b), "top-k snapshot: kernel against plain"
    assert torch.equal(got.age, want.age) and torch.equal(got.sent, want.sent)
    print(f"snapshot top_k:0.01 publish, kernel against plain from the same state and seeds: "
          f"hat ({n_leaves} leaves), age and sent bit for bit")
    del got, want, before
    rows = snapshot_top_k_timing(api, bw, pub.codec, leaves[big])
    del rs, sets["top_k:0.01"]
    torch.cuda.empty_cache()

    rs = sets["qsgd"]
    pub, before = rs.publisher, rs.state
    got, _, packed = pub.publish_packed(before, params)
    scales = [float(l.data["scale"].max()) for l in tree_leaves(packed["payload"])]
    del packed
    with api.dispatch_mode("ref"):
        want, _ = pub.publish(before, params)
    assert torch.equal(got.age, want.age) and torch.equal(got.sent, want.sent)
    n_off = worst = 0
    for a, b, scale in zip(tree_leaves(got.hat), tree_leaves(want.hat), scales):
        off = a != b
        count = int(off.sum())
        assert count <= FLIP_BUDGET * a.numel(), f"QSGD snapshot: {count} of {a.numel()} off"
        if count:
            step = float((a - b).abs().max()) / (scale / 127)
            assert step <= 1.0 + 1e-5, f"QSGD snapshot: off by {step} levels"
            worst = max(worst, step)
        n_off += count
    print(f"snapshot qsgd publish, kernel against plain from the same state and seeds: age and "
          f"sent equal; {n_off} of {sum(t.numel() for t in tree_leaves(got.hat)):,} snapshot "
          f"elements differ (band {FLIP_BUDGET} of each leaf, one level each), the largest by "
          f"{worst:.4f} levels")
    del got, want, before, rs, sets
    torch.cuda.empty_cache()

    # 4. a SnapshotFeed and a RemoteReplica over localhost, SNAP_REMOTE_STEPS
    #    more SGD steps, one publish after each
    pub = SnapshotPublisher(codec=SNAP_REMOTE_CODEC, bounds=(1,))
    feed = SnapshotFeed(pub, params)
    replica = RemoteReplica(feed.address, pub, params)
    try:
        packed_ms = []
        for _ in range(SNAP_REMOTE_STEPS):
            sgd_step()
            _, ms, _ = publish(feed, SNAP_REMOTE_CODEC)
            packed_ms.append(ms)
        api.reset_counters()
        t = time.perf_counter()
        pulled = replica.pull()
        torch.cuda.synchronize()
        pull_s = time.perf_counter() - t
        launches = api.launch_counts()
        assert pulled == SNAP_REMOTE_STEPS and launches == {
            "top_k_unpack": n_leaves * SNAP_REMOTE_STEPS}, (pulled, launches)
        runs.append(launches)
        assert replica.pull() == 0, "a drained pull applied a message"
        for a, b in zip(tree_leaves(replica.state.hat), tree_leaves(feed.state.hat)):
            assert torch.equal(a, b), "the remote replica differs from its feed"
        assert torch.equal(replica.state.age, feed.state.age)
        assert torch.equal(replica.state.sent, feed.state.sent)
        assert (replica.state.seq, replica.state.key) == (feed.state.seq, feed.state.key)
        msg = pub.message_bytes(params)
        tx = feed.link_bytes()["tx"]
        print(f"remote replica ({SNAP_REMOTE_CODEC}, localhost, one process): publishes "
              f"{[round(m, 1) for m in packed_ms]} ms with the host copy, pull of "
              f"{pulled} messages in {pull_s:.3f} s ({launches['top_k_unpack']} unpack "
              f"launches), then 0; hat, age, sent, seq and key equal to the feed's; feed tx "
              f"{tx:,} bytes against {SNAP_REMOTE_STEPS} x message_bytes "
              f"{SNAP_REMOTE_STEPS * msg:,} (send masks {SNAP_REMOTE_STEPS} bytes; framing and "
              f"pickle {tx - SNAP_REMOTE_STEPS * (msg + 1):,} bytes, two replies); raw fp32 "
              f"would be {SNAP_REMOTE_STEPS * raw_bytes:,}")
        # the payloads themselves, plus pickle's and the frames' headers
        assert 0 < tx - SNAP_REMOTE_STEPS * (msg + 1) < 65536, tx
    finally:
        replica.close()
        feed.close()
    assert losses[SNAP_STEPS - 1] < losses[0], f"the loss did not fall: {losses}"
    print(f"serve while training losses over {len(losses)} steps: "
          f"{[round(x, 6) for x in losses]}; peak memory of the phase "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, leaves, replica, feed
    torch.cuda.empty_cache()

    # 5. the examples, in process, their asserts live
    for name, argv in (("serve_while_training_torch", []), ("quickstart_torch", ["--smoke"])):
        module = load_example(name)
        api.reset_counters()
        t = time.perf_counter()
        module.main(argv)
        torch.cuda.synchronize()
        launches = api.launch_counts()
        assert launches.get("axpby", 0) > 0, (name, launches)
        runs.append(launches)
        print(f"example {name} {' '.join(argv)} on the card: {time.perf_counter() - t:.1f} s, "
              f"launches {json.dumps(launches)}")
    return runs, rows


def clamped_share(logw: torch.Tensor, chunk: int = WKV_CHUNK) -> float:
    """Share of (chunk, channel) pairs whose log-decay sum passes -25, where
    the chunked form departs from the exact recurrence."""
    b, s = logw.shape[:2]
    sums = logw.float().reshape(b, s // chunk, chunk, -1).sum(dim=2)
    return float((sums < -25).float().mean())


def rwkv_layer_inputs(gen):
    """r, k, v (bf16) and logw (fp32) in heads, (B, S, H, P), as RWKV-6 3B's
    first layer makes them: its time-mix inputs from random full-width
    weights, on a unit-RMS activation (the normed embedding)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import Initializer
    from repro_torch.models import rwkv

    rcfg = get_config(RWKV_ARCH).rwkv_cfg()
    params = rwkv.init_rwkv(rcfg, Initializer(gen, torch.bfloat16, "cuda"))
    x = torch.randn((RWKV_BATCH, RWKV_SEQ, rcfg.d_model), generator=gen, device="cuda")
    x = x.to(torch.bfloat16)
    with torch.inference_mode():
        r, k, v, _, logw = rwkv._timemix_inputs(rcfg, params, x, rwkv._shift(x))
    return [rwkv._heads(rcfg, t) for t in (r, k, v, logw)]


def once_ms(fn, n: int = 3) -> float:
    """Median device ms of ``n`` calls after one warm-up (for slow plain
    versions, where ``cuda_times``' 25 calls would take seconds)."""
    fn()
    times = []
    for _ in range(n):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def check_wkv_kernel(api, bw) -> dict:
    """Phase 2 for wkv_chunk (CUDA C++): at RWKV-6 3B's layer shape, against
    the plain chunked form under the model's own decays (the clamp bites)
    and against the per-token recurrence inside the clamp envelope; the
    grouped carry's PyTorch mirror against the plain chunked form; each of
    the kernel's three passes as CUPTI records it; timing beside the bound
    and both plain versions."""
    from repro_torch.kernels.wkv_chunk.kernel import group_size
    from repro_torch.kernels.wkv_chunk.ref import wkv_chunked_ref, wkv_grouped_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    row = {"name": "wkv_chunk", "route": "cuda", "source": "src/repro_torch/csrc/wkv_chunk.cu",
           "replaces": "src/repro/kernels/wkv_chunk/kernel.py:80", "library_ms": None,
           "group": group_size(WKV_CHUNK)}
    r, k, v, logw = rwkv_layer_inputs(gen)
    b, s, h, p = r.shape
    share = clamped_share(logw)
    chunk_sums = logw.reshape(b, s // WKV_CHUNK, WKV_CHUNK, h, p).sum(dim=2)
    print(f"wkv_chunk inputs (B={b}, S={s}, H={h}, P={p}, chunk {WKV_CHUNK}; RWKV-6 3B's "
          f"first layer, random weights): logw min {float(logw.min()):.3f} mean "
          f"{float(logw.mean()):.3f}, chunk sums min {float(chunk_sums.min()):.2f}, "
          f"clamped (chunk, channel) pairs {share:.4%}")
    del chunk_sums

    def kernel(x=(r, k, v, logw)):
        return api.call("wkv_chunk", *x, chunk=WKV_CHUNK)

    def plain_chunked(x=(r, k, v, logw)):
        return wkv_chunked_ref(*x, WKV_CHUNK)

    def per_token(x=(r, k, v, logw)):
        with api.dispatch_mode("ref"):
            return api.call("wkv_chunk", *x, chunk=WKV_CHUNK)

    errs = {}
    for label, x in (("bf16", (r, k, v, logw)),
                     ("fp32", (r.float(), k.float(), v.float(), logw))):
        (y, st), (y_want, st_want) = kernel(x), plain_chunked(x)
        torch.cuda.synchronize()
        for got, want, what in ((y, y_want, "y"), (st, st_want, "state")):
            assert got.dtype == torch.float32 and got.shape == want.shape, what
            assert bool(torch.isfinite(got).all()), f"wkv_chunk {label} {what}: not finite"
            torch.testing.assert_close(got, want, rtol=WKV_TOL, atol=WKV_TOL)
            errs[f"{label}_{what}"] = float((got - want).abs().max())
        if label == "bf16":   # the clamp's size on these decays: kernel vs exact
            y_exact, _ = per_token(x)
            errs["vs_exact_clamped"] = float((y - y_exact).abs().max())
            errs["y_max_abs"] = float(y_want.abs().max())
            del y_exact
            # the grouped carry in PyTorch, at the kernel's group size
            y_g, st_g = wkv_grouped_ref(*x, WKV_CHUNK, row["group"])
            torch.testing.assert_close(y_g, y_want, rtol=WKV_TOL, atol=WKV_TOL)
            torch.testing.assert_close(st_g, st_want, rtol=WKV_TOL, atol=WKV_TOL)
            errs["grouped_ref_y"] = float((y_g - y_want).abs().max())
            errs["grouped_ref_state"] = float((st_g - st_want).abs().max())
            del y_g, st_g
        del y, st, y_want, st_want
    # inside the clamp envelope the kernel is the exact recurrence too
    weak = logw * WKV_ENVELOPE_SCALE
    assert clamped_share(weak) == 0.0
    (y, st), (y_want, st_want) = kernel((r, k, v, weak)), per_token((r, k, v, weak))
    torch.testing.assert_close(y, y_want, rtol=WKV_REF_RTOL, atol=WKV_REF_ATOL)
    torch.testing.assert_close(st, st_want, rtol=WKV_REF_RTOL, atol=WKV_REF_ATOL)
    errs["envelope_y"] = float((y - y_want).abs().max())
    errs["envelope_state"] = float((st - st_want).abs().max())
    del y, st, y_want, st_want, weak
    torch.cuda.empty_cache()

    # the three passes of a call, then each one's median device time
    for _ in range(PROFILE_TRIES):   # a session in which CUPTI missed one is repeated
        _, launches = launch_records(kernel, "wkv_pass")
        order = [next((n for n in WKV_PASSES if n in e["kernel"]), None)
                 for e in launches[-3:]]
        if order == list(WKV_PASSES):
            break
    assert order == list(WKV_PASSES), [e["kernel"] for e in launches]
    for e in launches[-3:]:
        e.pop("ms")
        print("launch wkv_chunk: " + json.dumps(e))
    row["pass_ms"] = stage_ms(kernel, WKV_PASSES, WKV_PASS_CALLS)
    row["ms"], row["plain_chunked_ms"] = abba_ms(kernel, plain_chunked)
    row["plain_ms"] = once_ms(per_token)
    n_bytes = (3 * r.numel() * r.element_size() + logw.numel() * 4
               + r.numel() * 4 + b * h * p * p * 4)
    n_chunks = b * h * (s // WKV_CHUNK)
    flops = n_chunks * (2 * WKV_CHUNK * (WKV_CHUNK - 1) * p + 4 * WKV_CHUNK * p * p)
    bytes_ms, ops_ms = n_bytes / bw * 1e3, flops / FP32_PEAK_FLOPS * 1e3
    row.update(bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               max_abs_err=errs["bf16_y"], errors=errs, clamped_share=share)
    print(f"kernel wkv_chunk: vs plain chunked (rtol/atol {WKV_TOL}) "
          + json.dumps({k_: float(f"{v_:.4g}") for k_, v_ in errs.items()})
          + f"; ms={row['ms']:.4f} bound_ms={row['bound_ms']:.4f} ({row['bound_by']}: "
          f"{n_bytes / 1e6:.1f} MB, {bytes_ms:.4f} ms; {flops / 1e9:.3f} GFLOP fp32, "
          f"{ops_ms:.4f} ms) plain_chunked_ms={row['plain_chunked_ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} (per-token) library_ms=None; group of "
          f"{row['group']} chunks; by pass (CUPTI, median of {WKV_PASS_CALLS} calls) "
          + json.dumps({k_: round(v_, 4) for k_, v_ in row["pass_ms"].items()}))
    # a tp rank's share of phase 3g's RWKV-6 3B layer (WKV_TP_SHAPE) and of
    # phase 4g's (a data rank's 2 prompts of SERVE_PROMPT tokens), timed;
    # phase 4g's model 1 (all 4 prompts, every head), untimed
    row["cases"] = []
    s4 = SERVE_PROMPT
    for label, x in (
            ("rwkv6_tp", [t[:WKV_TP_SHAPE[0], :WKV_TP_SHAPE[1], :WKV_TP_SHAPE[2]].contiguous()
                          for t in (r, k, v, logw)]),
            ("rwkv6_serve_tp", [t[:, :s4, :h // 2].contiguous() for t in (r, k, v, logw)]),
            ("rwkv6_serve", [torch.cat([t[:, :s4], t[:, s4:2 * s4]]) for t in (r, k, v, logw)])):
        b, s, h_x = x[0].shape[:3]
        (y, st), (y_want, st_want) = kernel(x), plain_chunked(x)
        torch.testing.assert_close(y, y_want, rtol=WKV_TOL, atol=WKV_TOL)
        torch.testing.assert_close(st, st_want, rtol=WKV_TOL, atol=WKV_TOL)
        err = float((y - y_want).abs().max())
        del y, st, y_want, st_want
        if label == "rwkv6_serve":
            print(f"kernel wkv_chunk {label} (B={b}, S={s}, H={h_x}): against the plain chunked "
                  f"form within {WKV_TOL}, max_abs_err={err:.3g} (untimed)")
            continue
        case = {"case": label, "shape": [b, s, h_x, p], "max_abs_err": err}
        case["ms"], case["plain_chunked_ms"] = abba_ms(lambda: kernel(x),
                                                       lambda: plain_chunked(x))
        n_bytes = (3 * x[0].numel() * x[0].element_size() + 2 * x[0].numel() * 4
                   + b * h_x * p * p * 4)
        flops = b * h_x * (s // WKV_CHUNK) * (2 * WKV_CHUNK * (WKV_CHUNK - 1) * p
                                              + 4 * WKV_CHUNK * p * p)
        case["bound_ms"] = max(n_bytes / bw, flops / FP32_PEAK_FLOPS) * 1e3
        row["cases"].append(case)
        print(f"kernel wkv_chunk {label} (B={b}, S={s}, H={h_x}): ms={case['ms']:.4f} "
              f"bound_ms={case['bound_ms']:.4f} "
              f"plain_chunked_ms={case['plain_chunked_ms']:.4f} "
              f"max_abs_err={case['max_abs_err']:.3g}")
    del r, k, v, logw, x
    torch.cuda.empty_cache()
    return row


def rwkv_serving_path(api) -> list:
    """Phase 5: RWKV-6 3B serving at full width.  Returns the launch counts
    of each run through the kernels."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.models import rwkv
    from repro_torch.serving import RequestDriver, scan_prefill
    from repro_torch.tree import tree_map

    print(f"device memory allocated as the phase starts: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    runs = []
    cfg = dataclasses.replace(get_config(RWKV_ARCH), rwkv_chunk=WKV_CHUNK, rwkv_pallas=True)
    twin_cfg = dataclasses.replace(cfg, rwkv_pallas=False)   # the plain chunked path
    job = serve.make_serve_job(cfg, device="cuda")
    model, twin = job.model, Model(twin_cfg)
    t0 = time.perf_counter()
    params = job.init_params(0)
    torch.cuda.synchronize()
    print(f"serve {cfg.name}: {cfg.param_count(params):,} parameters in "
          f"{job.param_dtype}, initialized in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (RWKV_BATCH, RWKV_SEQ), generator=gen,
                           device="cuda")

    def prefill(mode, p, batch, fn, layers=cfg.n_layers):
        return run_prefill(api, runs, mode, p, batch, fn, {"wkv_chunk": layers})

    def inference(m, dtype):
        def fn(p, b):
            with torch.inference_mode():
                return m.prefill(p, b, dtype=dtype)
        return fn

    # 1. bf16 prefill of 2 x 8192 tokens through prefill_fn, three calls
    #    (the first carries one-time set-up), then the plain chunked twin
    batch = {"tokens": tokens}
    rates = []
    for i in range(3):
        logits, caches, dt, peak = prefill("kernel", params, batch, job.prefill_fn)
        rates.append(RWKV_BATCH * RWKV_SEQ / dt)
        print(f"serve {cfg.name} prefill bf16 kernel call {i + 1}: {RWKV_BATCH}x{RWKV_SEQ} "
              f"tokens in {dt:.3f} s, {rates[-1]:.0f} tokens/s, peak memory "
              f"{peak / 2**30:.2f} GiB, launches {api.launch_counts()}")
    kernel_logits, kernel_wkv = logits.float(), caches["b0"]["rwkv"]["wkv"]
    del caches
    logits, caches, dt, peak = prefill("ref", params, batch, inference(twin, torch.bfloat16))
    twin_wkv = caches["b0"]["rwkv"]["wkv"]
    # layer 0's state: the same bf16 inputs reach the kernel and the plain form
    torch.testing.assert_close(kernel_wkv[0], twin_wkv[0], rtol=WKV_TOL, atol=WKV_TOL)
    print(f"serve {cfg.name} prefill bf16 plain chunked twin: {dt:.3f} s, "
          f"{RWKV_BATCH * RWKV_SEQ / dt:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB; "
          f"kernel vs twin: layer-0 wkv state max abs diff "
          f"{float((kernel_wkv[0] - twin_wkv[0]).abs().max()):.3g} (tolerance {WKV_TOL}), "
          f"last layer's {float((kernel_wkv[-1] - twin_wkv[-1]).abs().max()):.3g} of "
          f"{float(twin_wkv[-1].abs().max()):.3g}, last-token logits "
          f"{float((kernel_logits - logits.float()).abs().max()):.4g} of "
          f"{float(logits.float().abs().max()):.4g} ({cfg.n_layers} layers of bf16 rounding "
          "on random weights; the kernel is held at the op level)")
    print(f"serve {cfg.name} prefill tokens/s: " + json.dumps(rates))
    del caches, kernel_wkv, twin_wkv, logits, kernel_logits
    trace_prefill(api, job.prefill_fn, params, batch, {"wkv_chunk": cfg.n_layers},
                  f"{cfg.name} prefill bf16 {RWKV_BATCH}x{RWKV_SEQ}", ("wkv", WKV_KERNEL))

    # the decays the model makes: clamped (chunk, channel) pairs by layer
    shares = {}
    with torch.inference_mode():
        x, positions = model._embed_inputs(params, batch, torch.bfloat16)
        for layer in range(cfg.n_layers):
            bp = tree_map(lambda t: t[layer], params["blocks"]["b0"])
            if layer in RWKV_SHARE_LAYERS:
                h = model._norm(x, bp["norm1"])
                *_, logw = rwkv._timemix_inputs(cfg.rwkv_cfg(), bp["rwkv"], h, rwkv._shift(h))
                shares[layer] = clamped_share(logw)
                del h, logw
            x, _, _ = model._apply_block("rwkv", bp, x, positions, "fwd")
    del x
    print(f"serve {cfg.name} clamped (chunk, channel) pairs by layer (chunk sums of logw "
          f"past -25, {RWKV_BATCH}x{RWKV_SEQ} tokens): "
          + json.dumps({k: float(f"{v:.6g}") for k, v in shares.items()}))
    del params
    torch.cuda.empty_cache()

    # 2. fp32 prefill at B=1, S=2048: kernel vs the plain chunked twin,
    #    last-token logits relative to their max abs; at 4 layers and at 32
    params32 = model.init(0, dtype=torch.float32, device="cuda")
    batch1 = {"tokens": tokens[:1, :RWKV_FP32_SEQ]}
    gaps = {}
    for layers in (RWKV_CUT_LAYERS, cfg.n_layers):
        cut = dataclasses.replace(cfg, n_layers=layers)
        p = {**params32, "blocks": tree_map(lambda t: t[:layers], params32["blocks"])}
        got, _, dt_k, _ = prefill("kernel", p, batch1, inference(Model(cut), torch.float32),
                                  layers)
        want, _, dt_p, _ = prefill("ref", p, batch1, inference(
            Model(dataclasses.replace(cut, rwkv_pallas=False)), torch.float32))
        gaps[layers] = float((got - want).abs().max() / want.abs().max())
        print(f"serve {cfg.name} prefill fp32 1x{RWKV_FP32_SEQ} at {layers} layers: "
              f"last-token logits, kernel vs plain chunked, max abs diff "
              f"{float((got - want).abs().max()):.3g} of {float(want.abs().max()):.3g} "
              f"(relative {gaps[layers]:.3g}); kernel {dt_k:.3f} s, plain {dt_p:.3f} s")
        del p, got, want
    assert gaps[RWKV_CUT_LAYERS] <= RWKV_LOGIT_TOL_CUT, gaps
    assert gaps[cfg.n_layers] <= RWKV_LOGIT_TOL_FULL, gaps

    # 3. the kernel prefill's caches against scan_prefill through decode
    #    steps (fp32, B=2, S=128).  The chunked form and the recurrence agree
    #    only inside the clamp envelope, so this runs on the same weights
    #    with every layer's decay base at RWKV_ENVELOPE_BASE, where no chunk
    #    sum passes -25 (checked at the first layer)
    blocks = dict(params32["blocks"]["b0"])
    blocks["rwkv"] = {**blocks["rwkv"], "decay_base": torch.full_like(
        blocks["rwkv"]["decay_base"], RWKV_ENVELOPE_BASE)}
    env = {**params32, "blocks": {"b0": blocks}}
    short = tokens[:, :128]
    with torch.inference_mode():
        x, _ = model._embed_inputs(env, {"tokens": short}, torch.float32)
        bp = tree_map(lambda t: t[0], env["blocks"]["b0"])
        h = model._norm(x, bp["norm1"])
        *_, logw = rwkv._timemix_inputs(cfg.rwkv_cfg(), bp["rwkv"], h, rwkv._shift(h))
        assert clamped_share(logw) == 0.0
    got, got_caches, _, _ = prefill("kernel", env, {"tokens": short},
                                    inference(model, torch.float32))
    caches = model.init_cache(RWKV_BATCH, 160, dtype=torch.float32, device="cuda")
    want, want_caches = scan_prefill(model, env, caches, short, dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=PREFILL_DECODE_TOL, atol=PREFILL_DECODE_TOL)
    cache_err = {k: float((got_caches["b0"]["rwkv"][k] - want_caches["b0"]["rwkv"][k])
                          .abs().max()) for k in ("wkv", "shift_t", "shift_c")}
    for k in cache_err:
        torch.testing.assert_close(got_caches["b0"]["rwkv"][k], want_caches["b0"]["rwkv"][k],
                                   rtol=PREFILL_DECODE_TOL, atol=PREFILL_DECODE_TOL)
    step_err = 0.0
    tok = torch.argmax(want[:, -1], dim=-1)[:, None]
    for i in range(4):   # decode on from both caches
        pos = torch.full((RWKV_BATCH,), 128 + i, dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            a, got_caches = model.decode_step(env, got_caches, tok, pos, dtype=torch.float32)
            b_, want_caches = model.decode_step(env, want_caches, tok, pos,
                                                dtype=torch.float32)
        torch.testing.assert_close(a, b_, rtol=PREFILL_DECODE_TOL, atol=PREFILL_DECODE_TOL)
        step_err = max(step_err, float((a - b_).abs().max()))
        tok = torch.argmax(b_[:, -1], dim=-1)[:, None]
    print(f"serve {cfg.name} prefill_fn path vs scan_prefill (fp32, {RWKV_BATCH}x128, "
          f"decay base {RWKV_ENVELOPE_BASE}): last-token logits max abs diff "
          f"{float((got - want).abs().max()):.3g}, caches " + json.dumps(
              {k: float(f"{v:.3g}") for k, v in cache_err.items()})
          + f", 4 decode steps on from each {step_err:.3g} (tolerance {PREFILL_DECODE_TOL})")
    del params32, env, blocks, caches, got, want, got_caches, want_caches, x, h, logw
    torch.cuda.empty_cache()

    # 4. the serving CLI and continuous batching
    out = serve.main(main_serve_args(RWKV_ARCH))
    assert out["finite"], "serve.main: non-finite logits"
    print(f"serve.main {RWKV_ARCH}: decode {out['decode_ms_per_step']:.2f} ms/step, "
          f"{out['tokens_per_s']:.1f} tokens/s, prefill {out['prefill_s']:.2f} s, "
          f"finite logits {out['finite']}")
    torch.cuda.empty_cache()
    params = job.init_params(0)
    requests = driver_requests(cfg, 7)
    driver = RequestDriver(model, slots=4, max_len=DRIVER_PROMPTS[1] + DRIVER_NEW,
                           dtype=torch.bfloat16, decode_fn=job.decode_fn, device=job.device)
    res = driver.run(params, requests)
    ok = all(len(o) == DRIVER_NEW and 0 <= int(o.min()) and int(o.max()) < cfg.vocab_size
             for o in res["outputs"].values())
    assert res["completed"] == 8 and ok, res
    print(f"serve {cfg.name} RequestDriver(slots=4) 8 requests: {res['steps']} steps, "
          f"{res['elapsed_s'] / res['steps'] * 1e3:.2f} ms/step, "
          f"{res['tokens_per_sec']:.1f} tokens/s, {res['requests_per_sec']:.2f} requests/s, "
          f"every output {DRIVER_NEW} tokens in the vocabulary: {ok}")
    del params, driver
    torch.cuda.empty_cache()
    return runs


def scenario_path(run, agree) -> None:
    """Phase 3b: the scenario engine through the kernels against the static
    executor, the plain path on the card and the CPU (``run`` resets the
    launch counts just before each run and reads them just after)."""
    import numpy as np
    from repro_torch.paper_problem import mlp_init
    from repro_torch.scenarios import make_scenario

    def streams_agree(a, b, what, rtol, fields=("consensus", "tracking_err", "spectral_gap")):
        for k in fields:
            x, y = a["streams"][k], b["streams"][k]
            assert x.shape == y.shape and np.isfinite(x).all(), (what, k)
            gap = np.abs(x - y)
            print(f"scenario {what} stream {k}: max relative gap "
                  f"{float(np.max(gap / np.abs(y)))}")
            assert (gap <= RUN_ATOL + rtol * np.abs(y)).all(), (what, k, x, y)
        assert np.array_equal(a["streams"]["active_nodes"], b["streams"]["active_nodes"]), what

    def three(name, scen, steps=SCENARIO_STEPS, **kw):
        """Through the kernels, plain on the card, plain on the CPU: the same
        fused update formulas each time (``use_fused=True``), so the three
        differ only in each device's arithmetic."""
        kw.update(scenario=make_scenario(scen), use_fused=True)
        got = run(name, "cuda", steps=steps, **kw)
        plain = run(name, "cuda", steps=steps, mode="ref", **kw)
        cpu = run(name, "cpu", steps=steps, **kw)
        assert not plain["launches"] and not cpu["launches"]
        rates[f"{name}/{scen}/{steps}"] = (
            got["steps_per_s"], plain["steps_per_s"], cpu["steps_per_s"])
        return got, plain, cpu

    def long_run(name, scen):
        """STEPS steps through the kernels and on the CPU, and on the CPU
        again from w1 one ulp (2**-23 relative) away: the trajectory-free
        streams are held, the rest printed beside the CPU's own spread."""
        kw = dict(scenario=make_scenario(scen), use_fused=True)
        got = run(name, "cuda", **kw)
        cpu = run(name, "cpu", **kw)
        nudged = {k: v * (1 + 2.0**-23) if k == "w1" else v for k, v in mlp_init(0).items()}
        spread = run(name, "cpu", init_params=nudged, **kw)
        streams_agree(got, cpu, f"{name} {scen} {STEPS} steps kernels vs cpu", RUN_RTOL,
                      fields=("spectral_gap",))
        for k in ("train_loss", "consensus", "test_acc"):
            assert math.isfinite(got[k]), (name, scen, k)
        rel = {}
        for k in ("train_loss", "consensus"):
            rel[k] = (abs(got[k] - cpu[k]) / abs(cpu[k]), abs(spread[k] - cpu[k]) / abs(cpu[k]))
        for k in ("consensus", "tracking_err"):
            ref = np.abs(cpu["streams"][k])
            rel[f"stream {k}"] = (float(np.max(np.abs(got["streams"][k] - cpu["streams"][k]) / ref)),
                                  float(np.max(np.abs(spread["streams"][k] - cpu["streams"][k]) / ref)))
        print(f"scenario {name} {scen} {STEPS} steps: relative gap to the cpu, card vs one-ulp "
              f"nudge of w1 on the cpu: " + json.dumps(rel))
        rates[f"{name}/{scen}/{STEPS}"] = (got["steps_per_s"], None, cpu["steps_per_s"])

    rates = {}
    # the fault-free scenario is the static executor, bit for bit
    static = run("dse_mvr", "cuda", use_fused=True, keep_state=True)
    base = run("dse_mvr", "cuda", use_fused=True, keep_state=True,
               scenario=make_scenario("baseline"))
    for k in ("train_loss", "consensus", "test_acc"):
        assert base[k] == static[k], f"baseline vs static ring: {k}"
    assert base["launches"] == static["launches"], (base["launches"], static["launches"])
    for field in ("params", "x_ref", "v", "y", "h_prev"):
        for leaf, t in getattr(static["state"], field).items():
            assert torch.equal(getattr(base["state"], field)[leaf], t), (field, leaf)
    assert base["state"].step == static["state"].step == STEPS
    print(f"scenario baseline: bit for bit the static ring; launches "
          f"{json.dumps(base['launches'])}; steps/s {base['steps_per_s']:.1f} "
          f"(static {static['steps_per_s']:.1f})")

    for scen in SCENARIO_RUNS:
        got, plain, cpu = three("dse_mvr", scen)
        for a, b, what in ((got, cpu, "kernels vs cpu"), (plain, cpu, "plain cuda vs cpu")):
            agree(a, b, f"dse_mvr {scen} {what}")
            streams_agree(a, b, f"dse_mvr {scen} {what}", RUN_RTOL)
        for op in ("mvr_update", "axpby", "dse_combine_yh"):
            assert got["launches"].get(op, 0) > 0, f"{scen}: dse_mvr did not launch {op}"
        print(f"scenario {scen}: active nodes per round min "
              f"{got['streams']['active_nodes'].min():.0f}, spectral gap mean "
              f"{got['streams']['spectral_gap'].mean():.6f}")
        long_run("dse_mvr", scen)

    # add_sub under a gated round: GT-HSGD communicates every step
    got, plain, cpu = three("gt_hsgd", "dropout_ring")
    for a, b, what in ((got, cpu, "kernels vs cpu"), (plain, cpu, "plain cuda vs cpu")):
        agree(a, b, f"gt_hsgd dropout_ring {what}")
        streams_agree(a, b, f"gt_hsgd dropout_ring {what}", RUN_RTOL)
    want = {op: SCENARIO_STEPS for op in ("axpby", "mvr_update", "add_sub")}
    assert got["launches"] == want, got["launches"]
    long_run("gt_hsgd", "dropout_ring")

    # per-round codec knobs: top-k spends a shrinking share of its payload
    got, plain, cpu = three("dse_mvr", "warmup_compress", steps=QSGD_STEPS,
                            compression="top_k:0.1")
    for a, b, what in ((got, cpu, "kernels vs cpu"), (plain, cpu, "plain cuda vs cpu")):
        agree(a, b, f"warmup_compress {what}", rtol=QSGD_RTOL, acc_tol=QSGD_ACC_TOL)
        streams_agree(a, b, f"warmup_compress {what}", QSGD_RTOL)
    events = QSGD_STEPS // TAU
    for op in ("top_k_pack", "top_k_unpack"):
        assert got["launches"].get(op) == 8 * events, got["launches"]

    # async gossip under lossy links with a per-round trigger schedule
    got, plain, cpu = three("dse_mvr", "async_lossy", steps=QSGD_STEPS, channel="async:3")
    for a, b, what in ((got, cpu, "kernels vs cpu"), (plain, cpu, "plain cuda vs cpu")):
        agree(a, b, f"async_lossy {what}", rtol=QSGD_RTOL, acc_tol=QSGD_ACC_TOL)
        gaps = {k: float(np.max(np.abs(a["streams"][k] - b["streams"][k])))
                for k in ("send_rate", "staleness", "consensus", "replica_drift")}
        print(f"scenario async_lossy {what}: max abs stream gaps " + json.dumps(gaps))
    print(f"scenario async_lossy: send rate mean {got['streams']['send_rate'].mean():.4f}, "
          f"staleness mean {got['streams']['staleness'].mean():.4f}")
    print("scenario steps/s (kernels, plain cuda, plain cpu): " + json.dumps(rates))


def trace_ranges(path: Path, phases, kernels) -> dict:
    """Launches inside each ``repro/<phase>`` range of a Chrome trace: a
    kernel belongs to the range whose host time holds the runtime or driver
    call that launched it (matched by CUPTI's correlation id), or, where no
    such call was recorded, its own run (a fenced span ends after its
    kernels do).  Returns ``{phase: {"ranges": n, kernel: launches, ...}}``,
    a kernel counted where its name holds the key."""
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {ph: [(e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == f"repro/{ph}" and e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"] for ph in phases}
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    out = {ph: {"ranges": len(r), **{k: 0 for k in kernels}} for ph, r in ranges.items()}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"), e["ts"])
        for ph, spans in ranges.items():
            if any(a <= ts <= b for a, b in spans):
                for k in kernels:
                    out[ph][k] += k in e["name"]
    return out


def telemetry_path(run, idx_cuda, seed_fn, smi: str) -> None:
    """Phase 3c: the telemetry hub and checkpoints on the main path through
    the kernels (``run`` resets the launch counts just before each run and
    reads them just after)."""
    import dataclasses

    import numpy as np
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.compression import link_bytes_per_round
    from repro_torch.configs import get_config
    from repro_torch.core import Simulator, ring
    from repro_torch.models import Model
    from repro_torch.paper_problem import make_algorithm, make_paper_problem, mlp_init, mlp_loss
    from repro_torch.scenarios import STREAM_FIELDS, make_scenario
    from repro_torch.telemetry import Telemetry, profile_trace
    from repro_torch.tree import tree_leaves, tree_map

    choco = dict(channel="choco", compression="top_k:0.1")
    rounds = QSGD_STEPS // TAU

    # three ways bit for bit: no hub, a hub with spans off, spans on
    runs = {}
    for mode in ("none", "off", "on"):
        hub = None if mode == "none" else Telemetry(spans=mode == "on")
        runs[mode] = (run("dse_mvr", "cuda", steps=QSGD_STEPS, use_fused=True, keep_state=True,
                          telemetry=hub, **choco), hub)
    base = runs["none"][0]
    assert runs["off"][0]["launches"] == base["launches"], (runs["off"][0]["launches"],
                                                            base["launches"])
    params = {k: v.unsqueeze(0).repeat((8,) + (1,) * v.dim()) for k, v in mlp_init(0).items()}
    per_round = link_bytes_per_round(make_algorithm("dse_mvr", 0.3, TAU, QSGD_STEPS,
                                                    **choco).comm, params)
    for mode in ("off", "on"):
        out, hub = runs[mode]
        for k, t in base["state"].params.items():
            assert torch.equal(out["state"].params[k], t), (mode, k)
        links = {lb: hub.total("link_bytes", lb) for lb in hub.labels("link_bytes")}
        assert links == {lb: b * rounds for lb, b in per_round.items()}, (mode, links)
        folded = {op: hub.total("kernel_launches", op) for op in hub.labels("kernel_launches")}
        assert folded == {op: float(n) for op, n in out["launches"].items()}, (mode, folded)
    spanned = runs["on"][1]
    phases = spanned.labels("span_seconds")
    assert {"local", "gossip", "eval"} <= set(phases), phases
    print("telemetry choco top-k, a hub with spans off and on: params bit for bit the "
          f"hub-free run's, launches {json.dumps(base['launches'])}; link bytes "
          f"{json.dumps(links)} (= per round x {rounds}); kernel_launches folded "
          f"{json.dumps(folded)}; span phases {list(phases)}, gossip span p50 "
          f"{spanned.collect()['span_seconds']['series']['gossip']['summary']['p50'] * 1e3:.3f} ms")

    # the scheduled executor: dropout_ring with spans against without
    plain = run("dse_mvr", "cuda", steps=QSGD_STEPS, use_fused=True, keep_state=True,
                scenario=make_scenario("dropout_ring"))
    hub = Telemetry(spans=True)
    sched = run("dse_mvr", "cuda", steps=QSGD_STEPS, use_fused=True, keep_state=True,
                scenario=make_scenario("dropout_ring"), telemetry=hub)
    for k, t in plain["state"].params.items():
        assert torch.equal(sched["state"].params[k], t), ("dropout_ring", k)
    for k in STREAM_FIELDS:
        steps_k, vals = hub.series(k)
        assert steps_k.tolist() == list(range(rounds)), k
        assert np.array_equal(vals, sched["streams"][k].astype(np.float64), equal_nan=True), k
        assert np.array_equal(sched["streams"][k], plain["streams"][k], equal_nan=True), k
    print(f"telemetry dropout_ring: spans on vs off bit for bit, every stream one value a "
          f"round ({rounds}) equal to the run's; span phases {list(hub.labels('span_seconds'))}")

    # span overhead: steps/s with spans off and on, host clock, in turns
    rates = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off") * 2:
        out = run("dse_mvr", "cuda", use_fused=True, telemetry=Telemetry(spans=mode == "on"))
        rates[mode].append(out["steps_per_s"])
    med = {m: statistics.median(r) for m, r in rates.items()}
    print(f"telemetry span overhead, dse_mvr {STEPS} steps through the kernels ({smi}): "
          f"spans off {med['off']:.1f} steps/s (min {min(rates['off']):.1f}, max "
          f"{max(rates['off']):.1f}), on {med['on']:.1f} (min {min(rates['on']):.1f}, max "
          f"{max(rates['on']):.1f}); on/off {med['on'] / med['off']:.4f}; runs "
          + json.dumps(rates))

    # two spanned rounds under the profiler: kernels inside the phase ranges
    data, _ = make_paper_problem(OMEGA, seed=0)
    alg = make_algorithm("dse_mvr", 0.3, TAU, QSGD_STEPS, use_fused=True, **choco)
    sim = Simulator(alg, ring(8), mlp_loss, data, BATCH, telemetry=Telemetry(spans=True),
                    device="cuda", index_fn=lambda s: idx_cuda[s], comm_seed_fn=seed_fn)
    state = sim.run_rounds(sim.init_state(mlp_init(0)), 1)   # kernels loaded first
    trace_dir = ROOT / "build" / "span_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    with profile_trace(str(trace_dir)):
        state = sim.run_rounds(state, 2)
        torch.cuda.synchronize()
    (trace,) = trace_dir.glob("trace_*.json")
    inside = trace_ranges(trace, ("local", "gossip"),
                          ("_mvr_update_kernel", "pack_kernel", "tile_kernel"))
    print("telemetry profiler trace of two spanned rounds, launches inside the ranges: "
          + json.dumps(inside))
    assert inside["local"]["ranges"] == inside["gossip"]["ranges"] == 2, inside
    assert inside["local"]["_mvr_update_kernel"] >= 1, inside
    assert inside["gossip"]["pack_kernel"] >= 1 and inside["gossip"]["tile_kernel"] >= 1, inside

    # checkpoints: save at round 8, load onto the card, run on to round 16
    ckpt = ROOT / "build" / "checkpoints"
    shutil.rmtree(ckpt, ignore_errors=True)

    def timed_save(path, step, tree):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(str(path), step, tree)
        return time.perf_counter() - t0

    def timed_load(path, like):
        t0 = time.perf_counter()
        tree, _ = load_checkpoint(str(path), like=like)
        torch.cuda.synchronize()
        return tree, time.perf_counter() - t0

    sim = Simulator(alg, ring(8), mlp_loss, data, BATCH, device="cuda",
                    index_fn=lambda s: idx_cuda[s], comm_seed_fn=seed_fn)
    whole = sim.run_rounds(sim.init_state(mlp_init(0)), rounds)
    half = sim.run_rounds(sim.init_state(mlp_init(0)), rounds // 2)
    save_s = timed_save(ckpt / "mlp", rounds // 2, half)
    loaded, load_s = timed_load(ckpt / "mlp", half)
    assert loaded.step == half.step and loaded.comp.event == half.comp.event
    resumed = sim.run_rounds(loaded, rounds - rounds // 2)
    for field in ("params", "x_ref", "v", "y", "h_prev"):
        for leaf, t in getattr(whole, field).items():
            assert torch.equal(getattr(resumed, field)[leaf], t), (field, leaf)
    for b, wire in enumerate(whole.comp.wire):
        for leaf, t in wire["hat"].items():
            assert torch.equal(resumed.comp.wire[b]["hat"][leaf], t), (b, leaf)
    mlp_mb = (ckpt / "mlp" / f"step_{rounds // 2:010d}" / "data.npz").stat().st_size / 1e6
    print(f"checkpoint choco top-k state saved at round {rounds // 2}, loaded onto the card "
          f"with like=, run on to round {rounds}: bit for bit the uninterrupted run; "
          f"{mlp_mb:.2f} MB, save {save_s * 1e3:.1f} ms, load {load_s * 1e3:.1f} ms")

    # one Gemma-2 2B layer's bf16 parameters (the first block of a 2-layer cut)
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2)
    layer = tree_map(lambda t: t[0].contiguous(),
                     Model(cfg).init(0, dtype=torch.bfloat16, device="cuda")["blocks"]["b0"])
    torch.cuda.empty_cache()
    mb = sum(t.numel() * t.element_size() for t in tree_leaves(layer)) / 1e6
    save_s = timed_save(ckpt / "gemma2_layer", 0, layer)
    back, load_s = timed_load(ckpt / "gemma2_layer", layer)
    for a, b in zip(tree_leaves(back), tree_leaves(layer)):
        assert a.is_cuda and a.dtype == torch.bfloat16 and torch.equal(
            a.view(torch.int16), b.view(torch.int16))
    print(f"checkpoint {cfg.name} layer 0, bf16, {mb:.1f} MB ({smi}): bits equal after the "
          f"round trip; save {save_s:.3f} s ({mb / save_s:.1f} MB/s), load onto the card "
          f"{load_s:.3f} s ({mb / load_s:.1f} MB/s)")
    del layer, back
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()


def elastic_path(api, smi: str) -> tuple:
    """Phase 3d: the elastic runtime on the card.  Each launch spawns
    ELASTIC_WORKERS worker processes (``python -m repro_torch.runtime.
    worker``), each of which loads the kernels phase 2 built, warms up and
    resets its launch counts before READY, and reports its launches with
    every DONE.  Returns the workers' launches, one dict a launch, and each
    op's launches by worker over the phase."""
    from collections import Counter
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from repro_torch.runtime import RuntimeConfig, launch, simulate_reference
    from repro_torch.runtime.chaos import ChaosEvent
    from repro_torch.runtime.engine import index_stream
    from repro_torch.runtime.replay import leaves_equal

    t_phase = time.perf_counter()
    dense = RuntimeConfig(problem="pseudo_mnist", algorithm="dse_mvr", n_nodes=8,
                          n_rounds=ELASTIC_ROUNDS, batch_size=ELASTIC_BATCH, device="cuda")
    dense = dense.with_(hyper=dense.hyper + (("use_fused", True),))
    packed = dense.with_(hyper=dense.hyper + ELASTIC_CHOCO)
    runs = (("dense", dense), ("packed", packed),
            ("packed_off", packed.with_(packed_transport="off")))
    plan = (ChaosEvent(round=ELASTIC_KILL, action="kill", worker=2),
            ChaosEvent(round=ELASTIC_SLEEP_AT, action="sleep", worker=0, seconds=ELASTIC_SLEEP),
            ChaosEvent(round=ELASTIC_REJOIN, action="rejoin", worker=2))
    want_log = np.ones((ELASTIC_ROUNDS, 8), dtype=bool)
    want_log[ELASTIC_KILL:ELASTIC_REJOIN, 4:6] = False      # worker 2 owns nodes 4-5
    # a kill and a rejoin bump the epoch once each; an abandoned round
    # (a worker dropped as stale, or dead mid-round) would bump it again
    want_epochs = ([0] * ELASTIC_KILL + [1] * (ELASTIC_REJOIN - ELASTIC_KILL)
                   + [2] * (ELASTIC_ROUNDS - ELASTIC_REJOIN))
    cuda_idx = index_stream(dense.seed, 8, 128, ELASTIC_BATCH, "cuda")

    # the three launches side by side (one thread each: a launch's
    # coordinator waits on its workers' sockets), then each checked in turn
    def timed(cfg):
        t0 = time.perf_counter()
        res = launch(cfg, ELASTIC_WORKERS, plan=plan)
        return res, time.perf_counter() - t0

    t_launch = time.perf_counter()
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = [pool.submit(timed, cfg) for _, cfg in runs]
        launched = [f.result() for f in futures]
    print(f"elastic: {len(runs)} launches side by side, {ELASTIC_WORKERS} workers each, in "
          f"{time.perf_counter() - t_launch:.2f} s")

    launches, by_worker, replays, results = [], {}, {}, {}
    outside = []   # replay metrics outside their band, asserted at the end
    for (tag, cfg), (res, wall) in zip(runs, launched):
        assert np.array_equal(res.active_log, want_log), (tag, res.active_log.astype(int))
        assert res.epochs == want_epochs, (tag, res.epochs)
        assert len(res.resync_seconds) == 1, (tag, res.resync_seconds)

        # the replay in this process, through the kernels, plain on the card
        # and plain on the CPU (the card's index stream carried across)
        key = tuple(cfg.hyper)
        if key not in replays:
            api.reset_counters()
            t1 = time.perf_counter()
            ref = simulate_reference(cfg, res.active_log)
            torch.cuda.synchronize()
            replay_s = time.perf_counter() - t1
            ref_launches = api.launch_counts()
            api.reset_counters()
            with api.dispatch_mode("ref"):
                plain = simulate_reference(cfg, res.active_log)
            assert not api.launch_counts(), api.launch_counts()
            cpu = simulate_reference(cfg, res.active_log, device="cpu",
                                     index_fn=lambda s: cuda_idx(s).cpu())
            got = ref["metrics"]
            # the top-k run is held as phase 3 holds its config (CHOCO_BAND):
            # the Triton kernels' FMAs move the top-k input by ulps, which
            # swap near-ties at the k-th magnitude (consensus 6.6e-4 apart
            # from plain on the card and on the CPU, which agree to 1e-7)
            band = RUN_RTOL if tag == "dense" else CHOCO_RTOL
            bands = {"plain_cuda": band, "cpu": band}
            for other, run_ in (("plain_cuda", plain), ("cpu", cpu)):
                for k in ("train_loss", "consensus"):
                    v = run_["metrics"][k]
                    gap = abs(got[k] - v)
                    print(f"elastic {tag} replay, kernels vs {other}: {k} {got[k]!r} vs {v!r}, "
                          f"relative gap {gap / abs(v):.3g} (rtol {bands[other]})")
                    if gap > RUN_ATOL + bands[other] * abs(v):
                        outside.append((tag, other, k, got[k], v))
            print(f"elastic {tag} replay: {ELASTIC_ROUNDS * 4} steps in {replay_s:.3f} s "
                  f"({ELASTIC_ROUNDS * 4 / replay_s:.1f} steps/s) through the kernels, "
                  f"launches {json.dumps(ref_launches)}")
            replays[key] = (ref, ref_launches)
        ref, ref_launches = replays[key]
        ok, bad = leaves_equal(res.final_leaves, ref["wire_leaves"])
        assert ok, f"elastic {tag}: leaf {bad} differs from the on-card replay"
        assert int(res.final_key) == int(ref["key"]) == ELASTIC_ROUNDS * 4

        # every worker launched every op the replay launched
        per = {}
        for rec in res.worker_records:
            if rec.get("event") == "sample" and rec.get("stream") == "kernel_launches":
                per.setdefault(rec["run"]["process"], Counter())[rec["label"]] += int(rec["value"])
        assert sorted(per) == [f"worker:{w}" for w in range(ELASTIC_WORKERS)], sorted(per)
        for w, counts in per.items():
            missing = [op for op in ref_launches if not counts.get(op)]
            assert not missing, f"elastic {tag}: {w} launched no {missing}"
            for op, n in counts.items():
                by_worker.setdefault(op, Counter())[w] += n
        total = Counter()
        for counts in per.values():
            total.update(counts)
        launches.append(dict(total))
        sleeps = {rec["run"]["process"]: rec["value"] for rec in res.worker_records
                  if rec.get("stream") == "contrib_seconds" and rec.get("step") == ELASTIC_SLEEP_AT}
        assert sleeps["worker:0"] >= ELASTIC_SLEEP, sleeps
        results[tag] = res
        print(f"elastic {tag} ({smi}): {ELASTIC_ROUNDS} rounds over {ELASTIC_WORKERS} worker "
              f"processes, launch() {wall:.2f} s (spawn, rounds, kill, rejoin, shutdown; "
              f"beside the other launches); "
              f"start-up to every READY {res.startup_seconds:.2f} s, rejoin from spawn to "
              f"resync_ok {json.dumps(res.join_seconds)} s; "
              f"{res.rounds_per_sec:.2f} rounds/s; round seconds "
              f"{json.dumps([round(t, 4) for t in res.round_seconds])}; resync seconds "
              f"{json.dumps(res.resync_seconds)}; socket bytes {json.dumps(res.socket_bytes)}; "
              f"epochs {res.epochs}; active_log as planned; final leaves bit for bit the "
              f"on-card replay ({len(res.final_leaves)} leaves); round {ELASTIC_SLEEP_AT} "
              f"contrib seconds {json.dumps(sleeps)}")
        print(f"elastic {tag} launches by worker: "
              + json.dumps({w: dict(c) for w, c in sorted(per.items())}))
    on, off = results["packed"].socket_bytes, results["packed_off"].socket_bytes
    assert on["total"] < off["total"], (on, off)
    assert not outside, outside
    print(f"elastic packed protocol vs dense, one config ({smi}): framed socket bytes "
          f"{on['total']} vs {off['total']} ({on['total'] / off['total']:.4f}); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches, {op: dict(c) for op, c in by_worker.items()}


def shard_config(layers: int):
    """Phase 3e's model: Qwen2-VL-2B at full width, ``layers`` deep."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(VLM_ARCH), n_layers=layers, attn_impl="pallas")


def shard_batches(cfg, nodes: int) -> dict:
    """One round's batches for ``nodes`` nodes, ``(tau, N, 1, ...)``, drawn
    on the card from a fixed seed: the same for every run."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    shape = (SHARD_TAU, nodes, 1)
    return {
        "tokens": torch.randint(0, cfg.vocab_size, shape + (TRAIN_TEXT,), generator=gen,
                                device="cuda"),
        "vision_embeds": torch.randn(shape + (cfg.n_vision_tokens, cfg.d_model), generator=gen,
                                     device="cuda").to(torch.bfloat16),
        "targets": torch.randint(0, cfg.vocab_size, shape + (TRAIN_TEXT,), generator=gen,
                                 device="cuda"),
    }


# phase 3e's runs: tag -> (nodes, make_train_job keywords, dispatch mode)
SHARD_RUNS = {
    "roll": (SHARD_NODES, {}, "kernel"),
    "dense": (SHARD_NODES, dict(gossip="dense"), "kernel"),
    "roll_plain": (SHARD_NODES, {}, "ref"),
    "qsgd": (SHARD_QSGD_NODES, dict(compression="qsgd"), "kernel"),
    "choco": (SHARD_CHOCO_NODES, dict(channel="choco", compression=SHARD_TOP_K), "kernel"),
    "choco_dense": (SHARD_CHOCO_NODES, dict(channel="choco", compression=SHARD_TOP_K,
                                            wire_mode="dense"), "kernel"),
}


def node_fingerprint(tree) -> list:
    """:func:`fingerprint` per node: each leaf's exact int64 sums of its
    32-bit words, one a node row."""
    from repro_torch.tree import tree_leaves

    return [t.detach().view(torch.int32).reshape(t.shape[0], -1).sum(1, dtype=torch.int64)
            .tolist() for t in tree_leaves(tree)]


def sharded_run(api, mesh_of, tag: str, rounds: int, on_round=None, nodes=None) -> dict:
    """``rounds`` rounds of phase 3e's run ``tag`` through ``make_train_job``
    on ``mesh_of(nodes)`` (the run's own node count unless given): per-round
    wall ms (fenced), loss, launches by op, the mesh's bytes, peak memory;
    ``on_round(r, params)`` sees the params after round r (1-based)."""
    from repro_torch.launch.distributed import make_train_job, state_bytes

    run_nodes, kw, mode = SHARD_RUNS[tag]
    nodes = nodes or run_nodes
    cfg = shard_config(SHARD_LAYERS)
    mesh = mesh_of(nodes)
    job = make_train_job(cfg, mesh, tau=SHARD_TAU, lr=SHARD_LR, alpha=SHARD_ALPHA,
                         use_fused=True, **kw)
    abstract = state_bytes(job.abstract_state)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = job.init_state(0)
    batches = job.local_batch(shard_batches(cfg, nodes))
    api.reset_counters()
    mesh.reset_bytes()
    ms, losses = [], []
    for r in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with api.dispatch_mode(mode):
            state, metrics = job.step_fn(state, batches)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["loss"]))
        assert math.isfinite(losses[-1]), (tag, r, losses)
        if on_round is not None:
            on_round(r + 1, state.params)
    chan = job.algorithm.comm.resolved_channel()
    out = {"tag": tag, "nodes": nodes, "wire": repr(chan),
           "shifts": len(getattr(chan, "neighbor_shifts", ()) or ()),
           "buckets": api.bucket_count(job.abstract_state.params),
           "abstract_state_bytes": abstract, "ms": ms, "loss": losses,
           "launches": api.launch_counts(), "bytes": mesh.byte_counts(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "node_steps_per_s": mesh.n_local * SHARD_TAU * rounds / (sum(ms) / 1e3),
           "fingerprint": node_fingerprint(state.params)}
    out["n_leaves"] = len(out["fingerprint"])
    del state, batches
    torch.cuda.empty_cache()
    return out


def dse_launches(buckets: int, tau: int, rounds: int) -> dict:
    """DSE-MVR's update launches (fused z) over ``rounds`` rounds: a local
    step one axpby and one mvr_update, the comm step one dse_combine and two
    axpby, each once a ``tree_apply`` bucket."""
    return {"axpby": rounds * (tau + 1) * buckets, "mvr_update": rounds * (tau - 1) * buckets,
            "dse_combine": rounds * buckets}


def shard_gap(params, held: list) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)`` over every leaf,
    the held leaves (host copies) taken to the card one at a time: at most
    1 is within the band."""
    from repro_torch.tree import tree_leaves

    worst = 0.0
    for got, want in zip(tree_leaves(params), held):
        want = want.to(got.device)
        worst = max(worst, float(((got - want).abs() / (SHARD_ATOL + SHARD_RTOL * want.abs()))
                                 .max()))
        del want
    return worst


def shard_report(run: dict, smi: str) -> None:
    rounds = len(run["ms"])
    per_round = {op: {k: v // rounds for k, v in c.items()} for op, c in run["bytes"].items()
                 if any(c.values())}
    print(f"sharded {run['tag']} ({smi}): {SHARD_LAYERS} layers x {run['nodes']} nodes, "
          f"wire {run['wire']}; abstract state {run['abstract_state_bytes'] / 2**30:.2f} GiB, "
          f"peak memory {run['peak_gib']:.2f} GiB; ms a round "
          f"{json.dumps([round(t, 1) for t in run['ms']])}, node-steps/s "
          f"{run['node_steps_per_s']:.2f}; loss {run['loss']}; launches "
          f"{json.dumps(run['launches'])}; bytes a round {json.dumps(per_round)}")


def sharded_worker(world: int, rank: int, store: str, out: str) -> None:
    """One process of phase 3e's gloo group on the card (``world`` 1: the
    deterministic world-1 twin): the roll and CHOCO runs for
    rounds of ``SHARD_GROUP_RUNS``, results to ``out`` as JSON."""
    import datetime
    import warnings

    import torch.distributed as dist
    from repro_torch.kernels import api
    from repro_torch.launch.mesh import make_group_mesh, make_test_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    if world > 1:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=SHARD_DEADLINE))
        def mesh_of(nodes):
            return make_group_mesh(nodes, device="cuda")
    else:
        def mesh_of(nodes):
            return make_test_mesh(nodes, device="cuda")
    res = {"world": world, "rank": rank, "runs": {}}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for tag, (nodes, rounds) in SHARD_GROUP_RUNS.items():
            res["runs"][tag] = sharded_run(api, mesh_of, tag, rounds, nodes=nodes)
    res["nondeterministic"] = sorted({str(w.message)[:200] for w in caught})
    if world > 1:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))


def spawn_world(world: int, tag: str) -> list:
    """Phase 3e's ``world``-process run: one ``chip_smoke.py
    --sharded-worker`` process a rank, each its own CUDA context on the one
    card, deterministic cuBLAS, expandable allocator segments (two ranks
    share the card); their results by rank."""
    import gc
    import os

    tmp = ROOT / "build" / "sharded"
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / f"store_{tag}"
    store.unlink(missing_ok=True)
    # this process's freed blocks go back to the card before the ranks start
    gc.collect()
    torch.cuda.empty_cache()
    print(f"sharded {tag}: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved as it spawns")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, outs = [], []
    for rank in range(world):
        out = tmp / f"{tag}_rank{rank}.json"
        out.unlink(missing_ok=True)
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-worker", str(world),
             str(rank), str(store), str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + SHARD_DEADLINE
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [f"rank {rank} exited {p.returncode}:\n{log[-3000:]}"
           for rank, (p, log) in enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not bad, f"sharded {tag}: " + "\n".join(bad)
    return [json.loads(o.read_text()) for o in outs]


def sharded_path(api, smi: str) -> tuple:
    """Phase 3e: the sharded engine (``make_train_job`` over a ``NodeMesh``)
    training Qwen2-VL-2B at full width on the card.  Returns every run's
    launches (this process's and the spawned ranks') and each op's phase
    3e launches by process."""
    from repro_torch.compression import make_compressor
    from repro_torch.core import ring
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    print(f"device memory allocated as the phase starts: "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    def mesh_of(nodes):
        return make_test_mesh(nodes, device="cuda")

    n_tok = 256 + TRAIN_TEXT
    flash_case = ("qwen2_vl_train", 1, 12, 2, n_tok)
    assert flash_case in [c[:5] for c in FLASH_CASES], "no phase-2 flash case at this shape"
    runs, gaps, held = {}, {}, {}

    def hold(r, params):
        if r in (1, SHARD_ROUNDS):
            held[r] = [t.detach().cpu() for t in tree_leaves(params)]

    def held_to(tag):
        def at(r, params):
            if r in (1, SHARD_ROUNDS):
                gaps.setdefault(tag, {})[r] = shard_gap(params, held[r])
        return at

    # 1. roll through the kernels; dense and roll under the plain versions
    #    held to it; sync QSGD; CHOCO top-k on the neighbour wire, and on
    #    the dense wire held to it
    held_against = {"dense": "roll", "roll_plain": "roll", "choco_dense": "choco"}
    for tag in SHARD_RUNS:
        if tag in held_against.values():
            held.clear()
            on_round = hold
        else:
            on_round = held_to(tag) if tag in held_against else None
        runs[tag] = sharded_run(api, mesh_of, tag, SHARD_ROUNDS, on_round)
        shard_report(runs[tag], smi)
    held.clear()
    for tag, against in held_against.items():
        gap = gaps[tag]
        print(f"sharded {tag} vs {against} through the kernels ({smi}): {gap[1]:.4g} of the "
              f"band (rtol {SHARD_RTOL}, atol {SHARD_ATOL}) after round 1, "
              f"{gap[SHARD_ROUNDS]:.4g} after round {SHARD_ROUNDS}")
        assert gap[1] <= 1.0, (tag, gap)

    # launches: flash in every layer of every node's 5 forwards a round (2
    # gradients a local step, 1 at the comm step); the update ops as the
    # Simulator's DSE-MVR (fused z) issues them: a local step one axpby and
    # one mvr_update, a comm step one dse_combine and two axpby
    # (each whole-tree op once a tree_apply bucket: the leaves of 2**24
    # elements or more alone, the rest together)
    qsgd_shifts = len(ring(SHARD_QSGD_NODES).shifts)
    assert qsgd_shifts == 2, qsgd_shifts
    for tag, run in runs.items():
        fwd = SHARD_ROUNDS * run["nodes"] * (2 * (SHARD_TAU - 1) + 1)
        want = {} if tag == "roll_plain" else {
            "flash_attention": SHARD_LAYERS * fwd,
            **dse_launches(run["buckets"], SHARD_TAU, SHARD_ROUNDS)}
        n = run["n_leaves"]
        if tag == "qsgd":
            # per leaf of both buffers an event: a quantize, and a dequantize
            # for the node's own message and for each shift's (ring(4): two)
            want.update(qsgd_quantize=SHARD_ROUNDS * 2 * n,
                        qsgd_dequantize=SHARD_ROUNDS * 2 * n * (1 + qsgd_shifts))
        if tag in ("choco", "choco_dense"):
            # a pack per leaf of both buffers an event; an unpack for the
            # node's own replica and, on the neighbour wire, each shift's
            want.update(top_k_pack=SHARD_ROUNDS * 2 * n,
                        top_k_unpack=SHARD_ROUNDS * 2 * n * (1 + run["shifts"]))
        assert run["launches"] == want, (tag, run["launches"], want)
    assert runs["choco"]["shifts"] == len(ring(SHARD_CHOCO_NODES).shifts)
    assert runs["choco_dense"]["shifts"] == 0

    # bytes: the QSGD payload rolls whole, once a buffer and shift; the
    # neighbour wire moves at least 4x fewer node-link bytes than the dense
    msg = make_compressor("qsgd").tree_bytes(Model(shard_config(SHARD_LAYERS)).param_shapes())
    want_q = SHARD_ROUNDS * 2 * qsgd_shifts * SHARD_QSGD_NODES * msg
    got_q = runs["qsgd"]["bytes"]["roll"]["node_link"]
    print(f"sharded qsgd node-link bytes {got_q} over {SHARD_ROUNDS} rounds = 2 buffers x "
          f"{qsgd_shifts} shifts x {SHARD_QSGD_NODES} nodes x message_bytes {msg} a round: "
          f"{got_q == want_q}")
    assert got_q == want_q, (got_q, want_q)
    nb, db = runs["choco"]["bytes"]["roll"]["node_link"], \
        runs["choco_dense"]["bytes"]["roll"]["node_link"]
    print(f"sharded choco {SHARD_TOP_K} node-link bytes: neighbour wire {nb}, dense wire {db} "
          f"({db / nb:.2f}x)")
    assert db >= 4 * nb > 0, (db, nb)

    # 2. two ranks on the one card against world 1, both deterministic
    t0 = time.perf_counter()
    one = spawn_world(1, "world1")[0]
    two = spawn_world(2, "world2")
    group_s = time.perf_counter() - t0
    for tag in ("roll", "choco"):
        want = one["runs"][tag]["fingerprint"]
        got = [sum((r["runs"][tag]["fingerprint"][i] for r in two), []) for i in range(len(want))]
        same = got == want
        ms1 = one["runs"][tag]["ms"]
        rounds = SHARD_GROUP_RUNS[tag][1]
        ms2 = [max(r["runs"][tag]["ms"][k] for r in two) for k in range(rounds)]
        proc = [r["runs"][tag]["bytes"] for r in two]
        print(f"sharded {tag} on 2 gloo ranks vs world 1 ({smi}), {rounds} rounds: "
              f"final params bit for bit {same}; ms a round world 1 "
              f"{json.dumps([round(t, 1) for t in ms1])}, 2 ranks "
              f"{json.dumps([round(t, 1) for t in ms2])}; rank bytes {json.dumps(proc)}; "
              f"launches by rank {json.dumps([r['runs'][tag]['launches'] for r in two])}; "
              f"peak GiB by rank {[round(r['runs'][tag]['peak_gib'], 2) for r in two]}")
        assert same, f"sharded {tag}: 2 ranks differ from world 1"
        for r in two:
            assert r["runs"][tag]["bytes"]["roll"]["process"] > 0, tag
    warned = sorted(set(one["nondeterministic"]) | {w for r in two for w in r["nondeterministic"]})
    print(f"sharded group: nondeterministic-op warnings {json.dumps(warned)}; worlds spawned "
          f"and run in {group_s:.1f} s; phase {time.perf_counter() - t_phase:.1f} s")

    launches = [runs[t]["launches"] for t in SHARD_RUNS] + [
        res["runs"][t]["launches"] for res in [one, *two] for t in res["runs"]]
    by_process = {}
    for op in {op for c in launches for op in c}:
        by_process[op] = {"in_process": sum(runs[t]["launches"].get(op, 0) for t in SHARD_RUNS)}
        for name, res in [("world1", one)] + [(f"rank{r['rank']}", r) for r in two]:
            by_process[op][name] = sum(res["runs"][t]["launches"].get(op, 0)
                                       for t in res["runs"])
    return launches, by_process

def layout_config(arch: str):
    """Phase 3g's model: ``arch`` at full width on its first block unit,
    through the flash kernel (and an RWKV model through ``wkv_chunk``)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    rwkv = dict(rwkv_chunk=WKV_CHUNK, rwkv_pallas=True) if "rwkv" in cfg.block_unit else {}
    return dataclasses.replace(cfg, n_layers=len(cfg.block_unit), attn_impl="pallas", **rwkv)


def layout_batches(cfg, nodes: int, batch: int, text: int) -> dict:
    """One round's batches, ``(tau, N, batch, ...)``, drawn on the card from a
    fixed seed: the same in this process and in every rank.  An audio
    model takes ``text`` frames of its features (bf16) and frame targets."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    shape = (SHARD_TAU, nodes, batch)
    if cfg.audio_frontend_dim:
        frames = torch.randn(shape + (text, cfg.audio_frontend_dim), generator=gen,
                             device="cuda")
        return {"frames": frames.to(torch.bfloat16),
                "targets": torch.randint(0, cfg.vocab_size, shape + (text,), generator=gen,
                                         device="cuda")}
    out = {"tokens": torch.randint(0, cfg.vocab_size, shape + (text,), generator=gen,
                                   device="cuda")}
    if cfg.n_vision_tokens:
        out["vision_embeds"] = torch.randn(shape + (cfg.n_vision_tokens, cfg.d_model),
                                           generator=gen, device="cuda").to(torch.bfloat16)
    out["targets"] = torch.randint(0, cfg.vocab_size, shape + (text,), generator=gen,
                                   device="cuda")
    return out


@contextlib.contextmanager
def fp32_activations():
    """``Model.loss`` with fp32 activations whatever dtype the engine asks
    for (``LAYOUT_FP32``)."""
    from repro_torch.models import Model

    loss = Model.loss
    Model.loss = lambda self, p, b, dtype=None, tp=None: loss(self, p, b, torch.float32, tp)
    try:
        yield
    finally:
        Model.loss = loss


@contextlib.contextmanager
def recording_routes(routes: list):
    """Every MoE forward's routing decisions appended to ``routes`` as
    ``(experts, kept)``, both (G, T, k), on the host."""
    from repro_torch.models import mlp

    route = mlp._route

    def record(*args, **kw):
        out = route(*args, **kw)
        routes.append((out[3].cpu(), out[5].cpu()))
        return out

    mlp._route = record
    try:
        yield
    finally:
        mlp._route = route


def chunk_fingerprint(t: torch.Tensor, chunk: int = 4096) -> list:
    """A tensor's bytes as 32-bit words (zero-padded), in chunks of
    ``chunk`` words, each chunk's sum of word x (position mod 251 + 1) in
    int64: any change of a byte, or of the order within a chunk, moves a sum
    with near certainty."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    pad = (-b.numel()) % (4 * chunk)
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    words = b.view(torch.int32).reshape(-1, chunk).long()
    weights = torch.arange(chunk, device=t.device) % 251 + 1
    return (words * weights).sum(1).tolist()


@contextlib.contextmanager
def recording_payloads(fps: list, dims):
    """Every payload tree the node axis moves (``gossip.share_split``),
    fingerprinted into ``fps``: of each sharded leaf its tensors that are
    the whole node's (``shared``) and its per-node scalars (QSGD's scale,
    the adaptive level count), of each replicated leaf the whole payload,
    and bare tensors (send masks) whole: what every model rank of a node
    must hold the same."""
    from repro_torch.compression import gossip
    from repro_torch.compression.base import Packed
    from repro_torch.tree import tree_leaves

    split = gossip.share_split

    def record(tree, group):
        fp = []
        for i, p in enumerate(tree_leaves(tree)):
            if not isinstance(p, Packed):
                fp.append(chunk_fingerprint(p))
                continue
            keys = (sorted(p.data) if dims[i] is None
                    else sorted(set(p.shared) | ({"scale", "lv"} & set(p.data))))
            fp.append({k: chunk_fingerprint(p.data[k]) for k in keys})
        fps.append(fp)
        return split(tree, group)

    gossip.share_split = record
    try:
        yield
    finally:
        gossip.share_split = split


def layout_run(api, mesh, run: str, on_round, moved: bool = False) -> dict:
    """Phase 3g's run ``run`` on ``mesh`` (model 1 here, or a rank's mesh):
    ms a round (fenced, the step alone), loss, launches by op, the mesh's
    bytes, peak memory, each replicated leaf's fingerprint and, for a MoE,
    each round's routing decisions; ``on_round(r, job, state)`` sees the
    state after round r (1-based).  ``moved``: from the init one fp32 ulp
    up (the floor of a ``LAYOUT_FLOOR`` run)."""
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.scenarios import make_scenario
    from repro_torch.tree import tree_leaves, tree_map

    arch, profile, nodes, batch, text, rounds = LAYOUT_RUNS[run]
    cfg = layout_config(arch)
    kw, scen_name = LAYOUT_CODECS.get(run, ({}, None))
    scen = None if scen_name is None else make_scenario(scen_name, seed=0)
    job = make_train_job(cfg, mesh, profile=profile, tau=SHARD_TAU, lr=SHARD_LR,
                         alpha=SHARD_ALPHA, use_fused=True, scenario=scen, **kw)
    sched = None if scen is None else job.schedule_for(rounds)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = job.model.init(0, device=mesh.device)
    if moved:
        params = tree_map(lambda t: torch.nextafter(t, torch.full_like(t, math.inf)), params)
    state = job.init_state(0, params=params)
    del params
    batches = job.local_batch(layout_batches(cfg, nodes, batch, text))
    api.reset_counters()
    ms, losses, moved_bytes, routes, recorded = [], [], [], [], []
    streams, payloads = [], []
    with contextlib.ExitStack() as stack:
        if run in LAYOUT_FP32:
            stack.enter_context(fp32_activations())
        if "moe" in cfg.block_unit:
            stack.enter_context(recording_routes(recorded))
        if run in LAYOUT_CODECS and mesh.model_group is not None:
            stack.enter_context(recording_payloads(payloads, job.shard_dims))
        for r in range(rounds):
            mesh.reset_bytes()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if sched is None:
                state, metrics = job.step_fn(state, batches)
            else:
                state, metrics = job.step_fn(state, batches, job.round_ctx(sched, r))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            moved_bytes.append(mesh.byte_counts())
            streams.append({k: float(v) for k, v in metrics.items()})
            losses.append(float(metrics["loss"]))
            routes.append(recorded[:])
            recorded.clear()
            assert math.isfinite(losses[-1]), (run, r, losses)
            on_round(r + 1, job, state)
    replicated = [t for t, d in zip(tree_leaves(state.params), job.shard_dims) if d is None]
    out = {"run": run, "ms": ms, "loss": losses, "launches": api.launch_counts(),
           "bytes": moved_bytes, "routes": routes,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "host_peak_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
           "buckets": api.bucket_count(job.abstract_state.params),
           "n_local": mesh.n_local, "replicated": fingerprint({str(i): t for i, t in
                                                               enumerate(replicated)}),
           "sharded_leaves": sum(d is not None for d in job.shard_dims),
           "leaves": len(job.shard_dims), "shard_dims": job.shard_dims,
           "streams": streams, "payloads": payloads,
           "whole_shapes": [list(t.shape) for t in
                            tree_leaves(job.model.param_shapes(dtype=torch.float32))]}
    del state, batches
    torch.cuda.empty_cache()
    return out


def layout_rank(runs: str, out_dir: str) -> None:
    """One rank of a phase 3g group (``chip_smoke.py --layout-rank``), started
    by ``torch.distributed.run``: each run of the comma-separated ``runs``
    (one node count; stages separated by ``;``) on the data x model mesh;
    every rank writes its rows and shards of the parameters after round 1
    and the last round (and, for ``LAYOUT_FULL``, rank 0 the whole
    parameters ``TrainJob.full`` gathers over both axes), and its results as
    JSON.  Between stages the ranks wait for the smoke process, which holds
    a stage's runs against model 1 and deletes their files, so that one
    stage's files are on the disk at a time."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import api

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=LAYOUT_DEADLINE))
    rank, world = dist.get_rank(), dist.get_world_size()
    stages = runs.split(";")
    for i, stage in enumerate(stages):
        layout_stage(api, stage.split(","), out_dir, rank)
        if i < len(stages) - 1:
            # this process's device memory back, then wait until the smoke
            # process has held the stage's runs (and deleted their files)
            dist.barrier()
            torch.cuda.empty_cache()
            if rank == 0:
                (Path(out_dir) / f"stage{world}_{i}_done").write_text("")
            go = Path(out_dir) / f"stage{world}_{i}_go"
            while not go.exists():
                time.sleep(0.2)
            dist.barrier()
    dist.destroy_process_group()


def layout_stage(api, runs: list, out_dir: str, rank: int) -> None:
    """A rank's runs of one stage of a phase 3g group (``layout_rank``)."""
    import warnings

    from repro_torch.launch.mesh import make_group_mesh
    from repro_torch.tree import tree_leaves

    for run in runs:
        # a mesh a run: its model group's pinned staging buffers, kept for
        # the sizes a run repeats, go with it
        mesh = make_group_mesh(LAYOUT_RUNS[run][2], device="cuda", model=LAYOUT_MODEL)
        rounds = LAYOUT_RUNS[run][5]

        def on_round(r, job, state):
            if r in (1, rounds):
                torch.save([t.cpu() for t in tree_leaves(state.params)],
                           Path(out_dir) / f"{run}_round{r}_rank{rank}.pt")
            if r == rounds and run in LAYOUT_FULL:
                full = job.full(state.params)      # every rank takes part
                if rank == 0:
                    torch.save([t.cpu() for t in tree_leaves(full)],
                               Path(out_dir) / f"{run}_full.pt")
                del full

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = layout_run(api, mesh, run, on_round)
        res.update(rank=rank, node_rank=mesh.rank, index=mesh.model_group.index,
                   nondeterministic=sorted({str(w.message)[:200] for w in caught}))
        torch.save(res.pop("routes"), Path(out_dir) / f"{run}_routes_rank{rank}.pt")
        (Path(out_dir) / f"{run}_rank{rank}.json").write_text(json.dumps(res))
        if (run in LAYOUT_CODECS and mesh.rank == 0
                and not (Path(out_dir) / f"leaf_rank{rank}.json").exists()):
            # node block 0's model group, once: the codec-level check
            layout_leaf_rank(mesh, Path(out_dir), rank, res)
        del mesh, res


def layout_leaf(res: dict) -> tuple:
    """The codec-level check's leaf: the embedding's whole per-node shape
    and tp shard dim (from a run's result), and the leaf itself, drawn on
    the card from LAYOUT_LEAF_SEED (node-stacked, one node)."""
    shape = [tuple(s) for s in res["whole_shapes"]]
    i = max(range(len(shape)), key=lambda j: math.prod(shape[j]))
    gen = torch.Generator(device="cuda").manual_seed(LAYOUT_LEAF_SEED)
    return shape[i], res["shard_dims"][i], torch.randn((1,) + shape[i], generator=gen,
                                                       device="cuda")


def layout_leaf_codec(spec: str):
    from repro_torch.compression import make_compressor

    return make_compressor(spec, error_feedback=False)


def layout_leaf_rank(mesh, out_dir: Path, rank: int, res: dict) -> None:
    """Rank side of the codec-level check: this rank's shard of the leaf
    encoded and decoded by each codec bound to its shard; fingerprints of
    the payload gathered over the model group and of the decoded shard,
    encode + decode ms and the model group's codec bytes to
    ``leaf_rank<r>.json``."""
    from repro_torch.compression.base import AtShard, Shard

    whole, dim, leaf = layout_leaf(res)
    sh = Shard(mesh.model_group, dim, whole)
    x = leaf.narrow(dim + 1, sh.lo, sh.n).contiguous()
    del leaf
    out = {"whole": list(whole), "dim": dim}
    for spec in LAYOUT_LEAF_CODECS:
        bound = AtShard(inner=layout_leaf_codec(spec), shard=sh)
        before = mesh.model_group.byte_counts()["codec"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        packed = bound.encode(x, LAYOUT_LEAF_SEED)
        dec = bound.decode(packed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        moved = mesh.model_group.byte_counts()["codec"] - before
        whole_p = bound.whole(packed)
        out[spec] = {"ms": ms, "codec_bytes": moved, "decoded": chunk_fingerprint(dec),
                     "payload": {k: chunk_fingerprint(v) for k, v in whole_p.data.items()},
                     "shapes": {k: list(v.shape) for k, v in whole_p.data.items()}}
        del packed, dec, whole_p
    (out_dir / f"leaf_rank{rank}.json").write_text(json.dumps(out))
    del x
    torch.cuda.empty_cache()


def layout_leaf_check(out: Path, res: dict, smi: str) -> None:
    """The codec-level check, this process's side: the whole leaf encoded
    and decoded by each codec; node block 0's ranks' gathered payloads and
    decoded shards must be its, bit for bit (their fingerprints)."""
    whole, dim, leaf = layout_leaf(res)
    ranks = [json.loads((out / f"leaf_rank{k}.json").read_text()) for k in range(LAYOUT_MODEL)]
    for k in range(LAYOUT_MODEL):
        (out / f"leaf_rank{k}.json").unlink()
    n = whole[dim] // LAYOUT_MODEL
    for spec in LAYOUT_LEAF_CODECS:
        codec = layout_leaf_codec(spec)
        torch.cuda.synchronize()
        t = time.perf_counter()
        packed = codec.encode(leaf, LAYOUT_LEAF_SEED)
        dec = codec.decode(packed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        payload = {k: chunk_fingerprint(v) for k, v in packed.data.items()}
        for m, got in enumerate(ranks):
            assert got[spec]["shapes"] == {k: list(v.shape) for k, v in packed.data.items()}, \
                (spec, m, got[spec]["shapes"])
            assert got[spec]["payload"] == payload, (spec, m, "payload")
            assert got[spec]["decoded"] == chunk_fingerprint(
                dec.narrow(dim + 1, m * n, n).contiguous()), (spec, m, "decoded shard")
        print(f"layout leaf {spec} ({smi}): Qwen2-VL-2B's embedding {tuple(whole)} fp32, tp "
              f"shard dim {dim}: both model ranks' gathered payloads and decoded shards are "
              f"the whole leaf's, bit for bit; encode + decode ms whole {ms:.1f}, a rank's "
              f"shard {[round(r[spec]['ms'], 1) for r in ranks]}; the model group's codec "
              f"bytes a rank {[r[spec]['codec_bytes'] for r in ranks]}")
        del packed, dec
    del leaf
    torch.cuda.empty_cache()


def spawn_layout_group(stages: list, world: int) -> tuple:
    """Phase 3g's ``world``-rank group for ``stages`` (lists of runs, one
    after the other): ``torch.distributed.run`` starting this file as each
    rank's script, on the one card, its output to a log file; returns the
    runs' directory, the process, its start time and the log's path (see
    ``layout_stage_wait``)."""
    import gc
    import os

    out = ROOT / "build" / "layout"
    out.mkdir(parents=True, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, OMP_NUM_THREADS="2", CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(world), str(ROOT / "chip_smoke.py"), "--layout-rank",
           ";".join(",".join(runs) for runs in stages), str(out)]
    log = out / f"group{world}.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, env=env, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
    return out, proc, time.perf_counter(), log


def layout_stage_wait(proc, marker, t0: float, log: Path) -> float:
    """Wait for a stage's ``marker`` file (None: for the group to end);
    the group is killed, and this raises, if it fails or passes
    LAYOUT_DEADLINE.  Returns the seconds since the group started."""
    import os
    import signal

    while proc.poll() is None and (marker is None or not marker.exists()):
        if time.perf_counter() - t0 > LAYOUT_DEADLINE:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            break
        time.sleep(0.2)
    done = marker is not None and marker.exists()
    assert done or proc.returncode == 0, \
        f"layout group exited {proc.returncode}:\n{log.read_text()[-6000:]}"
    return time.perf_counter() - t0


def layout_gap(got: list, want: list) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)`` over every leaf
    (``got`` on the host, taken to the card a leaf at a time, or on the
    card; ``want`` on the card): at most 1 is within phase 3e's band."""
    worst = 0.0
    for g, w in zip(got, want):
        g = g.to(w.device)
        worst = max(worst, float(((g - w).abs() / (SHARD_ATOL + SHARD_RTOL * w.abs())).max()))
        del g
    return worst


def layout_rank_part(params, rank: int, n_local: int, dims) -> list:
    """Rank ``rank``'s rows and model shards of a whole node-stacked tree
    (its leaves; ``dims`` each leaf's model-sharded dim or None)."""
    from repro_torch.tree import tree_leaves

    d, m = divmod(rank, LAYOUT_MODEL)
    out = []
    for t, dim in zip(tree_leaves(params), dims):
        t = t[d * n_local:(d + 1) * n_local]
        if dim is not None:
            n = t.shape[dim + 1] // LAYOUT_MODEL
            t = t.narrow(dim + 1, m * n, n)
        out.append(t)
    return out


def layout_path(api, smi: str) -> tuple:
    """Phase 3g: the within-node layouts on the card.  The runs of one node
    count share a spawned group: the nodes x LAYOUT_MODEL gloo ranks run
    them in turn (each rank writes its rows and shards after round 1 and
    the last round to disk), then each runs at model 1 in this process,
    held leaf by leaf against those files as it goes, so that no run's
    parameters wait on the host and no rank gathers a whole tree.  A group
    runs in stages (``LAYOUT_STAGE_FIRST`` first): its ranks wait while this
    process holds a stage's runs, so that one stage's files are on the disk
    at a time.  Returns every run's launches and each op's launches by run
    and rank."""
    t_phase = time.perf_counter()
    launches, by_run = [], {}
    groups: dict = {}
    for run, spec in LAYOUT_RUNS.items():
        groups.setdefault(spec[2], []).append(run)
    for nodes, runs in groups.items():
        world = nodes * LAYOUT_MODEL
        # Qwen2-VL-2B's tp runs first, apart: one stage's rank files on the
        # disk at a time (the machine's disk limit)
        stages = [s for s in ([r for r in runs if r in LAYOUT_STAGE_FIRST],
                              [r for r in runs if r not in LAYOUT_STAGE_FIRST]) if s]
        out, proc, t0, log = spawn_layout_group(stages, world)
        for i, runs in enumerate(stages):
            marker = out / f"stage{world}_{i}_done" if i < len(stages) - 1 else None
            wall = layout_stage_wait(proc, marker, t0, log)
            print(f"layout group {runs}: {world} gloo ranks on the card, {wall:.1f} s wall with "
                  f"spawn and set-up since the group started")
            layout_stage_check(api, smi, runs, nodes, out, launches, by_run)
            if marker is not None:
                (out / f"stage{world}_{i}_go").write_text("")
    print(f"layout phase {time.perf_counter() - t_phase:.1f} s")
    return launches, by_run


def layout_stage_check(api, smi: str, runs: list, nodes: int, out: Path, launches: list,
                       by_run: dict) -> None:
    """The smoke process's side of one stage of a phase 3g group: each run
    at model 1 here, held against the ranks' files (and, for
    ``LAYOUT_FLOOR``, the floor), the files deleted as they are read."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tree import tree_leaves

    world = nodes * LAYOUT_MODEL
    for run in runs:
        rounds = LAYOUT_RUNS[run][5]
        ranks = [json.loads((out / f"{run}_rank{k}.json").read_text())
                 for k in range(world)]
        gaps, floor, twin, twin_run = {}, {}, {}, None
        if run in LAYOUT_FLOOR:
            # model 1 from its init one fp32 ulp up: the floor (its
            # parameters after round 1 and the last kept on the card)
            def keep(r, job, state):
                if r in (1, rounds):
                    twin[r] = [t.clone() for t in tree_leaves(state.params)]

            twin_run = layout_run(api, make_test_mesh(nodes, device="cuda"), run, keep,
                                  moved=True)

        def hold(r, job, state):
            if r in (1, rounds):
                gaps[r] = 0.0
                for k, res in enumerate(ranks):
                    path = out / f"{run}_round{r}_rank{k}.pt"
                    gaps[r] = max(gaps[r], layout_gap(
                        torch.load(path, mmap=True),
                        layout_rank_part(state.params, k, res["n_local"],
                                         res["shard_dims"])))
                    path.unlink()
                if r in twin:
                    floor[r] = layout_gap(twin.pop(r), tree_leaves(state.params))
            if r == rounds and run in LAYOUT_FULL:
                # TrainJob.full gathered the same tree over both axes
                path = out / f"{run}_full.pt"
                gaps["full"] = layout_gap(torch.load(path, mmap=True),
                                          tree_leaves(state.params))
                path.unlink()

        one = layout_run(api, make_test_mesh(nodes, device="cuda"), run, hold)
        launches += layout_check(run, one, out, gaps, smi, floor, twin_run)
        if run in LAYOUT_CODECS and (out / "leaf_rank0.json").exists():
            layout_leaf_check(out, ranks[0], smi)
        for op in {op for c in launches[-world - 1:] for op in c}:
            by_run.setdefault(op, {})[run] = {
                "model1" if k == 0 else f"rank{k - 1}": c.get(op, 0)
                for k, c in enumerate(launches[-world - 1:])}


def layout_kernels(cfg, nodes: int, forwards: int) -> dict:
    """A run's model-kernel launches: flash_attention once a causal attention
    layer and wkv_chunk once an RWKV layer, each a node's forward (a
    backward recomputes the plain version and launches none)."""
    attention = sum(k in ATTENTION_KINDS for k in cfg.block_unit) * cfg.causal
    per = {"flash_attention": attention, "wkv_chunk": cfg.block_unit.count("rwkv")}
    return {op: nodes * n * cfg.repeats * forwards for op, n in per.items() if n}


def layout_gathers(cfg, tokens: int, forwards: int, act_bytes: int) -> tuple:
    """The bytes a tp rank receives over its model group in ``forwards``
    forwards and backwards of one node by all-gather and by reduce-scatter:
    a MoE layer gathers its router's fp32 logits (the peers' experts'
    columns); a Mamba-2 layer its projection's columns (activations of
    ``act_bytes``) and its fp32 conv weights, and reduce-scatters their
    fp32 gradients."""
    peers = LAYOUT_MODEL - 1
    moe = cfg.block_unit.count("moe") * cfg.repeats
    gather = moe * tokens * (cfg.n_experts // LAYOUT_MODEL) * 4
    scatter = 0
    mamba = cfg.block_unit.count("mamba") * cfg.repeats
    if mamba:
        m = cfg.mamba_cfg()
        cols = (2 * m.d_inner + 2 * m.state_dim + m.n_heads) // LAYOUT_MODEL
        conv = m.conv_width * (m.d_inner + 2 * m.state_dim) // LAYOUT_MODEL * 4
        gather += mamba * (tokens * cols * act_bytes + conv)
        scatter += mamba * (tokens * cols * 4 + conv)
    return forwards * peers * gather, forwards * peers * scatter


def layout_shape(cfg, profile: str, tokens: int) -> str:
    """What a rank of a run computes, for the report."""
    m = LAYOUT_MODEL if profile == "tp" else 1
    parts = []
    if any(k in ATTENTION_KINDS for k in cfg.block_unit):
        how = "flash" if cfg.causal else "the plain bidirectional attention"
        parts.append(f"{how} at {cfg.n_heads // m} of {cfg.n_heads} heads on "
                     f"{cfg.n_kv_heads // m} KV heads (D {cfg.hd})")
    if "rwkv" in cfg.block_unit:
        h = cfg.rwkv_cfg().n_heads
        parts.append(f"wkv_chunk at {h // m} of {h} heads")
    if "mamba" in cfg.block_unit:
        h = cfg.mamba_cfg().n_heads
        parts.append(f"the SSD scan at {h // m} of {h} heads")
    if "moe" in cfg.block_unit:
        parts.append(f"{cfg.n_experts // m} of {cfg.n_experts} experts")
    return ", ".join(parts) + f" over {tokens} tokens"


def route_flips(got: list, want: list) -> int:
    """The routing decisions of one round's forwards (``recording_routes``)
    that differ between two runs: entries whose expert or kept bit
    differ."""
    assert len(got) == len(want), (len(got), len(want))
    return sum(int(((ge != we) | (gk != wk)).sum())
               for (ge, gk), (we, wk) in zip(got, want))


def layout_check(run: str, one: dict, out: Path, gaps: dict, smi: str, floor: dict,
                 twin: dict | None) -> list:
    """Phase 3g's checks of ``run``: its ranks (results under ``out``)
    against its model-1 run ``one`` and the gaps of their parameters after
    round 1 and the last round (for ``LAYOUT_FLOOR``, ``floor`` the gaps of
    model 1's ``twin`` from its init one ulp up); returns the launches,
    model 1's first, then by rank."""
    arch, profile, nodes, batch, text, rounds = LAYOUT_RUNS[run]
    world = nodes * LAYOUT_MODEL
    ranks = [json.loads((out / f"{run}_rank{r}.json").read_text()) for r in range(world)]
    cfg = layout_config(arch)
    n_tok = (cfg.n_vision_tokens + text) * (batch if profile == "tp" else
                                           batch // LAYOUT_MODEL)
    fwd = rounds * (2 * (SHARD_TAU - 1) + 1)       # a node's forwards
    per_round = [{k: {op: n for op, n in c.items() if n} for k, c in b.items()
                  if any(c.values())} for b in ranks[0]["bytes"]]
    routes = [torch.load(out / f"{run}_routes_rank{r}.pt") for r in range(world)]
    for r in range(world):
        (out / f"{run}_routes_rank{r}.pt").unlink()
    flips = ""
    if one["routes"][0]:
        # every rank routes every token of its nodes: the same decisions
        # on the model ranks of a node, and (one node) model 1's or not
        assert nodes == 1, run
        decisions = sum(e.numel() for e, _ in one["routes"][0])
        for rk in routes[1:]:
            assert all(route_flips(a, b) == 0 for a, b in zip(rk, routes[0])), run
        got = [route_flips(a, b) for a, b in zip(routes[0], one["routes"])]
        flips = (f"; routing decisions that differ from model 1's, by round, of {decisions} "
                 f"a round: the ranks {got}")
        if twin is not None:
            flips += f", model 1 from its init one ulp up " + str(
                [route_flips(a, b) for a, b in zip(twin["routes"], one["routes"])])
    held = (f"{LAYOUT_FLOOR_TIMES} times the floor, model 1 from its init one fp32 ulp up "
            f"{floor[1]:.4g} after round 1, {floor[rounds]:.4g} after round {rounds}"
            if run in LAYOUT_FLOOR else "the band")
    print(f"layout {run} ({smi}): {arch} {profile}, {nodes} nodes x model "
          f"{LAYOUT_MODEL} = {world} gloo ranks on the card, "
          f"{layout_shape(cfg, profile, n_tok)}, {'fp32' if run in LAYOUT_FP32 else 'bf16'} "
          f"activations; vs model 1 in this process: {gaps[1]:.4g} "
          f"of the band (rtol {SHARD_RTOL}, atol {SHARD_ATOL}) after round 1, "
          f"{gaps[rounds]:.4g} after round {rounds}"
          + (f" (the TrainJob.full gather {gaps['full']:.4g})" if "full" in gaps else "")
          + f"; held to {held}{flips}; ms a round model 1 "
          f"{json.dumps([round(t, 1) for t in one['ms']])}, by rank "
          f"{json.dumps([[round(t, 1) for t in r['ms']] for r in ranks])}; peak GiB model 1 "
          f"{one['peak_gib']:.2f}, by rank {[round(r['peak_gib'], 2) for r in ranks]}; host "
          f"peak RSS GiB so far, this process {one['host_peak_gib']:.1f}, by rank "
          f"{[round(r['host_peak_gib'], 1) for r in ranks]}; loss "
          f"model 1 {one['loss']}, rank 0 {ranks[0]['loss']}; rank 0's bytes a round "
          f"{json.dumps(per_round)}; launches model 1 {json.dumps(one['launches'])}, by rank "
          f"{json.dumps([r['launches'] for r in ranks])}; {ranks[0]['sharded_leaves']} of "
          f"{ranks[0]['leaves']} leaves sharded; nondeterministic-op warnings "
          f"{json.dumps(sorted({w for r in ranks for w in r['nondeterministic']}))}")
    if run in LAYOUT_FLOOR:
        assert all(gaps[r] <= LAYOUT_FLOOR_TIMES * floor[r] for r in (1, rounds)), \
            (run, gaps, floor)
    else:
        assert gaps[1] <= 1.0 and gaps[rounds] <= 1.0 and gaps.get("full", 0) <= 1.0, (run, gaps)
    # training: the loss falls from round to round, the same on every rank
    assert all(b < a for a, b in zip(one["loss"], one["loss"][1:])), (run, one["loss"])
    # exact launches: the model's kernels a node's forward, DSE-MVR's update
    # ops once a tree_apply bucket (the rank's shards)
    codec_ops = layout_codec_launches(run, one["leaves"], nodes, rounds)
    want1 = {**layout_kernels(cfg, nodes, fwd), **dse_launches(one["buckets"], SHARD_TAU, rounds),
             **codec_ops}
    assert one["launches"] == want1, (run, one["launches"], want1)
    if run in LAYOUT_CODECS:
        layout_codec_check(run, one, ranks, smi)
    for r in ranks:
        want = {**layout_kernels(cfg, r["n_local"], fwd),
                **dse_launches(r["buckets"], SHARD_TAU, rounds), **codec_ops}
        assert r["launches"] == want, (run, r["rank"], r["launches"], want)
        assert all(math.isfinite(v) for v in r["loss"]), (run, r["loss"])
        assert r["loss"] == ranks[0]["loss"], (run, r["rank"], r["loss"])
        assert all(b < a for a, b in zip(r["loss"], r["loss"][1:])), (run, r["loss"])
        moved = r["bytes"][0]["model"]
        if profile == "tp":
            gather, scatter = layout_gathers(cfg, n_tok, r["n_local"] * (2 * SHARD_TAU - 1),
                                             4 if run in LAYOUT_FP32 else 2)
            assert moved["all_reduce"] > 0, (run, moved)
            assert (moved["all_gather"], moved["reduce_scatter"]) == (gather, scatter), \
                (run, moved, gather, scatter)
        else:
            assert moved["all_gather"] > 0 and moved["reduce_scatter"] > 0, (run, moved)
        if nodes > 1:   # the roll, or the allgather wire's gathers
            assert (r["bytes"][0]["roll"]["process"]
                    + r["bytes"][0]["all_gather"]["process"]) > 0, (run, r["bytes"][0])
    # replicated leaves: the same bits on every model rank of a node
    for r in ranks:
        assert r["replicated"] == ranks[r["node_rank"] * LAYOUT_MODEL]["replicated"], \
            (run, r["rank"])
    print(f"layout {run}: replicated leaves bit for bit across the model ranks "
          f"({len(ranks[0]['replicated'])} leaves a rank)")
    return [one["launches"]] + [r["launches"] for r in ranks]


def layout_codec_launches(run: str, n_leaves: int, nodes: int, rounds: int) -> dict:
    """A codec run's codec launches a process (model 1, or a rank: the same
    count, once a leaf whether sharded or not): both buffers encode every
    leaf once an event (QSGD's quantize; top-k's pack, on a sharded leaf
    of its shard's candidates) and decode it once (the error feedback's,
    the replica update's, or the replicated wire's decode of the gathered
    set) and, on the roll and the neighbour wire, once more a shift."""
    from repro_torch.core import ring

    if run not in LAYOUT_CODECS:
        return {}
    kw, scen = LAYOUT_CODECS[run]
    per = 2 * n_leaves * rounds
    decodes = per if scen is not None else per * (1 + len(ring(nodes).shifts))
    if kw["compression"] == "qsgd":
        return {"qsgd_quantize": per, "qsgd_dequantize": decodes}
    return {"top_k_pack": per, "top_k_unpack": decodes}


def layout_codec_bytes(run: str, res: dict) -> tuple:
    """The byte rule of ``compression/gossip.py`` for a codec run:
    ``(P, R, S, mask, codec)``: a node's message at model 1 (the whole
    leaves' payloads), what the model ranks of a node move more a message
    each (the replicated leaves' payloads, QSGD's 4 B scale a sharded
    leaf), the shared bytes of a message the model group joins, the send
    mask's bytes a message, and the model group's codec bytes a rank
    receives a round (QSGD's scales, top-k's 8 B candidates, the async
    trigger's two sums, a node each)."""
    from repro_torch.compression import make_compressor

    kw, _ = LAYOUT_CODECS[run]
    comp = make_compressor(kw["compression"])
    inner = getattr(comp, "inner", comp)
    qsgd = kw["compression"] == "qsgd"
    shapes, dims = [tuple(x) for x in res["whole_shapes"]], res["shard_dims"]
    size = [comp.payload_bytes(x, torch.float32) for x in shapes]
    whole = sum(size)
    extra = sum(b for b, d in zip(size, dims) if d is None)
    shared = 0
    if qsgd:
        extra += 4 * sum(d is not None for d in dims)
    else:
        shared = sum(b for b, d in zip(size, dims) if d is not None)
    mask = 1 if kw.get("channel", "").startswith("async") else 0
    per_buffer = 0
    for x, d in zip(shapes, dims):
        if d is not None:
            d_shard = math.prod(x) // LAYOUT_MODEL
            per_buffer += 4 if qsgd else 8 * min(inner.k_for(math.prod(x)), d_shard)
    per_buffer += 2 * 4 * mask
    codec = 2 * per_buffer * res["n_local"] * (LAYOUT_MODEL - 1)
    return whole, extra, shared, mask, codec


def layout_codec_check(run: str, one: dict, ranks: list, smi: str) -> None:
    """A codec run's exact checks: node-link bytes over the ranks, the model
    group's payload and codec bytes a rank, to the byte; every model rank of
    a node moved the same payloads and send masks (fingerprints); the
    scenario streams the same on every rank and within the band of model
    1's."""
    whole, extra, shared, mask, codec = layout_codec_bytes(run, ranks[0])
    kw, scen = LAYOUT_CODECS[run]
    # beside the payloads, a scenario's round gathers over the node axis
    # each rank's rows of W_t (4 N B a row, for the streams' spectral gap)
    # and of the active mask twice (1 B a row: the gap, the replicated
    # wire's gate): none on model 1's one rank
    n_nodes, n_local = LAYOUT_RUNS[run][2], ranks[0]["n_local"]
    ctx_bytes = 0 if scen is None else n_local * (n_nodes - 1) * (4 * n_nodes + 2)
    for i in range(len(one["bytes"])):
        messages = 0
        for op in ("roll", "all_gather"):
            one_nl = one["bytes"][i][op]["node_link"]
            assert one_nl % (whole + mask) == 0, (run, op, one_nl, whole, mask)
            n = one_nl // (whole + mask)
            got = sum(r["bytes"][i][op]["node_link"] for r in ranks)
            ctx = len(ranks) * ctx_bytes if op == "all_gather" else 0
            assert got == one_nl + n * (LAYOUT_MODEL - 1) * (extra + mask) + ctx, \
                (run, op, i, got, one_nl, n, extra, mask, ctx)
            messages += n
        assert messages > 0, run
        joined = sum(r["bytes"][i]["model"]["payload"] for r in ranks)
        assert joined == messages * shared, (run, i, joined, messages, shared)
        for r in ranks:
            assert r["bytes"][i]["model"]["codec"] == codec, \
                (run, i, r["rank"], r["bytes"][i]["model"]["codec"], codec)
    for r in ranks:
        assert r["payloads"] and r["payloads"] == ranks[r["node_rank"] * LAYOUT_MODEL][
            "payloads"], (run, r["rank"], "payload")
    line = ""
    if scen is not None:
        keys = sorted(k for k in one["streams"][0] if k not in ("loss", "v_norm"))
        for r in ranks:
            for a, b in zip(r["streams"], ranks[0]["streams"]):
                assert all(a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k]))
                           for k in keys), (run, r["rank"], a, b)
        for a, b in zip(ranks[0]["streams"], one["streams"]):
            for k in keys:
                assert (math.isnan(a[k]) and math.isnan(b[k])) or abs(a[k] - b[k]) <= (
                    SHARD_ATOL + SHARD_RTOL * abs(b[k])), (run, k, a[k], b[k])
        line = (f"; streams (rank 0 / model 1) " + json.dumps(
            [{k: [a[k], b[k]] for k in keys} for a, b in zip(ranks[0]["streams"],
                                                           one["streams"])]))
    print(f"layout {run} ({smi}): {kw}{'' if scen is None else ' under ' + scen}; a round's "
          f"node-link bytes over the ranks {[sum(r['bytes'][i][op]['node_link'] for r in ranks for op in ('roll', 'all_gather')) for i in range(len(one['bytes']))]} "
          f"= model 1's {[sum(one['bytes'][i][op]['node_link'] for op in ('roll', 'all_gather')) for i in range(len(one['bytes']))]} "
          f"+ (M - 1) x {extra + mask} B a message; the model group's payload bytes a round "
          f"{[sum(r['bytes'][i]['model']['payload'] for r in ranks) for i in range(len(one['bytes']))]}, "
          f"codec bytes a rank-round {codec}; {len(ranks[0]['payloads'])} payloads a rank, the "
          f"same on both model ranks of a node" + line)


def serve_runs() -> list:
    """Phase 4g's runs: (arch, activations) in order."""
    return [(arch, act) for arch in SERVE_ARCHS
            for act in (("bf16", "fp32") if arch in SERVE_FP32 else ("bf16",))]


def serve_prompts(cfg) -> torch.Tensor:
    """Phase 4g's prompts, drawn on the card from SERVE_SEED: the same in
    this process and in every rank."""
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED)
    return torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                         device="cuda")


@contextlib.contextmanager
def fp32_serving(on: bool):
    """``Model.prefill`` and ``Model.decode_step`` in fp32 activations
    whatever dtype the job asks for (``on``), else as they are."""
    from repro_torch.models import Model

    prefill, decode = Model.prefill, Model.decode_step
    if on:
        Model.prefill = lambda self, p, b, dtype=None, tp=None, data=None: prefill(
            self, p, b, torch.float32, tp, data)
        Model.decode_step = lambda self, p, c, t, pos, dtype=None, tp=None, data=None: decode(
            self, p, c, t, pos, torch.float32, tp, data)
    try:
        yield
    finally:
        Model.prefill, Model.decode_step = prefill, decode


def serve_prefill(api, job, params, prompts) -> dict:
    """Phase 4g's prefill on ``job`` (a rank's or model 1's) of its data
    rank's rows of ``prompts``: a first call, then a timed one (fenced);
    the last-token logits (rows, V), tokens/s, the launches of the two
    calls and the peak memory."""
    batch = job.local_batch({"tokens": prompts})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    api.reset_counters()
    job.prefill_fn(params, batch, global_batch=SERVE_BATCH)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = job.prefill_fn(params, batch, global_batch=SERVE_BATCH)[0]
    torch.cuda.synchronize()
    s = time.perf_counter() - t
    return {"logits": logits[:, -1], "tokens_per_s": batch["tokens"].numel() / s,
            "ms": s * 1e3, "launches": api.launch_counts(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def serve_decode(api, job, params, prompts, stream=None) -> dict:
    """Phase 4g's SERVE_STEPS decode steps on ``job`` through a
    ``RequestDriver`` of SERVE_BATCH slots (a rank's job: its data rank's
    slots): each row's request is its prompt's first token and SERVE_STEPS
    new tokens, greedy; or, given ``stream`` (SERVE_BATCH, SERVE_STEPS),
    that token and the stream's first SERVE_STEPS - 1 tokens as its prompt
    and one new token, so that every step is fed the stream.  Each step's
    logits (SERVE_STEPS, rows, V), the greedy tokens (rows, SERVE_STEPS),
    ms a step, the model group's bytes a step and the launches."""
    from repro_torch.serving import RequestDriver

    steps: list = []

    def recording(p, c, t, pos, **kw):
        logits, c = job.decode_fn(p, c, t, pos, **kw)
        steps.append(logits[:, -1].clone())
        return logits, c

    rows = job.rows(SERVE_BATCH)
    driver = RequestDriver(job.model, slots=SERVE_BATCH, max_len=SERVE_STEPS + 1,
                           decode_fn=recording, job=job if job.mesh is not None else None,
                           device=job.device)
    first = prompts[:, :1].cpu()
    requests = [(first[r].tolist(), SERVE_STEPS) if stream is None else
                (first[r].tolist() + stream[r, :SERVE_STEPS - 1].tolist(), 1)
                for r in range(rows.start, rows.stop)]
    group = None if job.mesh is None else job.mesh.model_group
    if group is not None:
        job.mesh.reset_bytes()
    api.reset_counters()
    res = driver.run(params, requests)
    assert res["steps"] == SERVE_STEPS and res["completed"] == len(requests), res
    moved = {} if group is None else {k: v / SERVE_STEPS for k, v in group.byte_counts().items()
                                      if v}
    # over the data ranks: the MoE's per-expert counts, the driver's pending
    data = {} if group is None else {
        op: c["process"] / SERVE_STEPS for op, c in job.mesh.byte_counts().items()
        if op != "model" and c["process"]}
    greedy = torch.stack([torch.as_tensor(res["outputs"][i]) for i in range(len(requests))])
    return {"logits": torch.stack(steps), "greedy": greedy,
            "ms": res["elapsed_s"] / res["steps"] * 1e3, "bytes": moved, "data_bytes": data,
            "launches": api.launch_counts()}


def serve_rank(out_dir: str) -> None:
    """One rank of phase 4g's group (``chip_smoke.py --serve-rank``), started
    by ``torch.distributed.run``: the (SERVE_DATA, SERVE_MODEL) mesh once,
    then, once this process's model-1 runs are done (the ``go`` marker),
    each of ``serve_runs()`` in turn: the job's shards cut from the whole
    parameters, the prefill, then the decode steps fed model 1's stream;
    the logits to ``<run>_rank<r>.pt``, the rest to ``<run>_rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import api
    from repro_torch.launch.mesh import make_group_mesh
    from repro_torch.launch.serve import make_serve_job

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=SERVE_DEADLINE))
    rank = dist.get_rank()
    mesh = make_group_mesh(SERVE_DATA, device="cuda", model=SERVE_MODEL)
    out = Path(out_dir)
    t0 = time.perf_counter()
    while not (out / "go").exists():
        assert time.perf_counter() - t0 < SERVE_WAIT, "no go from the smoke process"
        time.sleep(0.5)
    for arch, act in serve_runs():
        tag = f"{arch}_{act}"
        cfg = layout_config(arch)
        job = make_serve_job(cfg, mesh, param_dtype=torch.float32)
        whole = job.init_params(SERVE_SEED)
        params = job.shard_params(whole)
        del whole
        prompts = serve_prompts(cfg)
        stream = torch.load(out / f"{tag}_stream.pt")
        with fp32_serving(act == "fp32"):
            pre = serve_prefill(api, job, params, prompts)
            dec = serve_decode(api, job, params, prompts, stream)
        torch.save({"prefill": pre.pop("logits").cpu(), "steps": dec.pop("logits").cpu(),
                    "greedy": dec.pop("greedy")}, out / f"{tag}_rank{rank}.pt")
        (out / f"{tag}_rank{rank}.json").write_text(json.dumps(
            {"prefill": pre, "decode": dec, "data": mesh.rank,
             "index": mesh.model_group.index}))
        del params, job
        torch.cuda.empty_cache()
    dist.destroy_process_group()


def spawn_serve_group() -> tuple:
    """Start phase 4g's group: ``torch.distributed.run`` starting this file
    as each of SERVE_DATA x SERVE_MODEL ranks' script on the one card, its
    output to a log file; returns the runs' directory, the process and its
    start time."""
    import os

    out = ROOT / "build" / "serve_layout"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(SERVE_DATA * SERVE_MODEL), str(ROOT / "chip_smoke.py"), "--serve-rank", str(out)]
    with open(out / "group.log", "w") as f:
        proc = subprocess.Popen(cmd, env=env, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
    return out, proc, time.perf_counter()


def serve_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)`` of two logit
    tensors in phase 3e's band (at most 1 is within it)."""
    got, want = got.float().to(want.device), want.float()
    return float(((got - want).abs() / (SHARD_ATOL + SHARD_RTOL * want.abs())).max())


def serve_expected(cfg) -> dict:
    """A rank's launches in phase 4g (two prefill calls, decode none):
    flash_attention once a causal attention layer a call, wkv_chunk once
    an RWKV layer."""
    att = sum(cfg.repeats for kind in cfg.block_unit if kind in ATTENTION_KINDS)
    rwkv = sum(cfg.repeats for kind in cfg.block_unit if kind == "rwkv")
    return {k: 2 * n for k, n in (("flash_attention", att), ("wkv_chunk", rwkv)) if n}


def serve_layout_path(api, smi: str, group: tuple) -> tuple:
    """Phase 4g: the mesh-sharded serve job on the card.  The group
    (``spawn_serve_group``'s) started with phase 4 and has set up since;
    this process runs model 1 (the one-device job on the whole batch) for
    every run: its prefill, its greedy decode steps (the stream the ranks
    are fed, written for them), and, in bf16, the same from the parameters
    one fp32 ulp up (the floor).  Then it gives the go and the ranks run
    alone, and each run is held against model 1.  Returns every run's
    launches and each op's launches by run and rank."""
    from repro_torch.launch.serve import make_serve_job
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    out, proc, t_spawn = group
    world = SERVE_DATA * SERVE_MODEL
    one, launches, by_run = {}, [], {}
    try:
        for arch, act in serve_runs():
            tag = f"{arch}_{act}"
            cfg = layout_config(arch)
            job = make_serve_job(cfg, device="cuda", param_dtype=torch.float32)
            params = job.init_params(SERVE_SEED)
            prompts = serve_prompts(cfg)
            with fp32_serving(act == "fp32"):
                pre = serve_prefill(api, job, params, prompts)
                dec = serve_decode(api, job, params, prompts)
                stream = dec["greedy"]
                torch.save(stream, out / f"{tag}_stream.tmp")
                (out / f"{tag}_stream.tmp").rename(out / f"{tag}_stream.pt")
                floor = None
                if act == "bf16":
                    up = tree_map(lambda t: torch.nextafter(t, torch.full_like(t, math.inf)),
                                  params)
                    floor = (serve_prefill(api, job, up, prompts)["logits"],
                             serve_decode(api, job, up, prompts, stream)["logits"])
                    floor = (serve_gap(floor[0], pre["logits"]),
                             serve_gap(floor[1], dec["logits"]))
                    del up
            launches.append(pre["launches"])
            one[tag] = {"prefill": pre["logits"].cpu(), "steps": dec["logits"].cpu(),
                        "stream": stream, "floor": floor,
                        "tokens_per_s": pre["tokens_per_s"], "ms": dec["ms"],
                        "peak_gib": pre["peak_gib"], "launches": pre["launches"]}
            del params, job, pre, dec
            torch.cuda.empty_cache()
        assert proc.poll() is None, f"serve group exited {proc.returncode} before its go"
        (out / "go").write_text("")
        t0 = time.perf_counter()
        print(f"serve layout: model 1's runs done {t0 - t_phase:.1f} s into the phase, "
              f"{t0 - t_spawn:.1f} s after the group started")
        proc.wait(timeout=SERVE_DEADLINE)
    finally:
        stop_group(proc)
    wall = time.perf_counter() - t0
    log = (out / "group.log").read_text()
    assert proc.returncode == 0, f"serve group exited {proc.returncode}:\n{log[-6000:]}"
    print(f"serve layout group: {world} gloo ranks on the card ({SERVE_DATA} data x model "
          f"{SERVE_MODEL}), {wall:.1f} s wall from the go")
    for arch, act in serve_runs():
        tag = f"{arch}_{act}"
        cfg = layout_config(arch)
        want = one.pop(tag)
        ranks = [json.loads((out / f"{tag}_rank{r}.json").read_text()) for r in range(world)]
        got = [torch.load(out / f"{tag}_rank{r}.pt") for r in range(world)]
        expected = serve_expected(cfg)
        gaps, flips = [], []
        for r, (res, g) in enumerate(zip(ranks, got)):
            d, m = res["data"], res["index"]
            assert (d, m) == divmod(r, SERVE_MODEL), (r, d, m)
            rows = slice(d * SERVE_BATCH // SERVE_DATA, (d + 1) * SERVE_BATCH // SERVE_DATA)
            first = got[d * SERVE_MODEL]
            for k in ("prefill", "steps", "greedy"):   # a data rank's model ranks: one answer
                assert torch.equal(g[k], first[k]), (tag, r, k)
            gaps.append((serve_gap(g["prefill"], want["prefill"][rows]),
                         serve_gap(g["steps"], want["steps"][:, rows])))
            # each step's greedy token against model 1's (its stream)
            flips.append(int((g["steps"].argmax(-1).T != want["stream"][rows]).sum()))
            assert torch.isfinite(g["prefill"]).all() and torch.isfinite(g["steps"]).all()
            pre_l = {k: v for k, v in res["prefill"]["launches"].items() if v}
            assert pre_l == expected, (tag, r, pre_l, expected)
            assert not res["decode"]["launches"], (tag, r, res["decode"]["launches"])
        assert {k: v for k, v in want["launches"].items() if v} == expected, \
            (tag, want["launches"])
        worst = [max(x[i] for x in gaps) for i in range(2)]
        if act == "bf16":
            bound = [LAYOUT_FLOOR_TIMES * f for f in want["floor"]]
            ok = all(w <= b for w, b in zip(worst, bound))
            print(f"serve layout {tag} ({smi}): gap to model 1 (band units) prefill "
                  f"{worst[0]:.4g}, decode steps {worst[1]:.4g}; floor (model 1 one fp32 ulp up) "
                  f"{want['floor'][0]:.4g}, {want['floor'][1]:.4g}; gap / floor "
                  f"{[round(w / f, 3) if f else None for w, f in zip(worst, want['floor'])]}; "
                  f"greedy disagreements with model 1's stream by rank {flips} of "
                  f"{SERVE_STEPS * SERVE_BATCH // SERVE_DATA}")
            assert ok, (tag, worst, bound)
        else:
            print(f"serve layout {tag} ({smi}): gap to model 1 (band units) prefill "
                  f"{worst[0]:.4g}, decode steps {worst[1]:.4g}; greedy disagreements {flips}")
            assert max(worst) <= 1.0 and not any(flips), (tag, worst, flips)
        print(f"serve layout {tag} ({smi}): prefill tokens/s by rank "
              f"{[round(r['prefill']['tokens_per_s'], 1) for r in ranks]} (model 1 "
              f"{want['tokens_per_s']:.1f} on {SERVE_BATCH} x {SERVE_PROMPT}); ms a decode step "
              f"by rank {[round(r['decode']['ms'], 2) for r in ranks]} (model 1 "
              f"{want['ms']:.2f}); peak GiB by rank "
              f"{[round(r['prefill']['peak_gib'], 2) for r in ranks]} (model 1 "
              f"{want['peak_gib']:.2f}); the model group's bytes a step by rank "
              f"{[r['decode']['bytes'] for r in ranks]}; the data ranks' bytes a step by rank "
              f"{[r['decode']['data_bytes'] for r in ranks]}; launches by rank "
              f"{[r['prefill']['launches'] for r in ranks]}")
        launches += [r["prefill"]["launches"] for r in ranks]
        for op in expected:
            by_run.setdefault(op, {})[tag] = {"model1": want["launches"].get(op, 0), **{
                f"rank{r}": res["prefill"]["launches"].get(op, 0)
                for r, res in enumerate(ranks)}}
    shutil.rmtree(out, ignore_errors=True)
    print(f"serve layout phase {time.perf_counter() - t_phase:.1f} s")
    return launches, by_run


def cli_model():
    """Phase 3f's model: the example's lm-100m, registered as a config module
    by the example's own ``register``, as a user registers a config."""
    example = load_example("decentralized_lm_torch")
    cfg = example.lm_100m()
    example.register(cfg)
    return cfg


def cli_shape(cfg, nodes: int) -> tuple:
    """``(tree_apply buckets, leaf count, the tree)`` of ``cfg``'s parameters
    stacked over ``nodes`` nodes, as meta tensors."""
    from repro_torch.kernels import api
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves, tree_map

    meta = tree_map(lambda s: torch.empty((nodes,) + tuple(s.shape), dtype=s.dtype,
                                          device="meta"),
                    Model(cfg).param_shapes(dtype=torch.float32))
    return api.bucket_count(meta), len(tree_leaves(meta)), meta


def train_rank(root: str, argv: list) -> None:
    """One rank of phase 3f's group (``chip_smoke.py --train-rank``), started
    by ``torch.distributed.run``: the gloo group joined once, then the CLI's
    ``main`` on the example's model for each run of ``CLI_GROUP_RUNS`` in
    turn (``main`` takes the group it finds and leaves it standing), each
    run's output under ``<root>/<run>`` and, after it, this rank's peak
    device memory, its job's shard dims and its shards' ``tree_apply``
    buckets to ``<root>/<run>/peak.rank<r>``.  Rank 0 marks each run's start
    in the log with a ``[cli-run] <run>`` line."""
    import gc

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cli_model()
    from repro_torch.kernels import api
    from repro_torch.launch import train

    dist.init_process_group("gloo")   # env://, as the CLI joins it
    rank = dist.get_rank()
    make, jobs = train.make_train_job, []

    def recorded(*a, **kw):
        jobs.append(make(*a, **kw))
        return jobs[-1]

    train.make_train_job = recorded
    for tag, extra in CLI_GROUP_RUNS.items():
        out = Path(root) / tag
        if rank == 0:
            print(f"[cli-run] {tag}", flush=True)
        jobs.clear()
        api.reset_counters()   # the CLI's telemetry counts launches from 0
        torch.cuda.reset_peak_memory_stats()
        train.main([*argv, "--out", str(out), "--telemetry-out", str(out / "tel.jsonl"), *extra])
        (out / f"peak.rank{rank}").write_text(json.dumps(
            {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "shard_dims": jobs[0].shard_dims,
             "buckets": api.bucket_count(jobs[0].abstract_state.params)}))
        jobs.clear()
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()


def read_telemetry(path: Path) -> dict:
    """A rank's telemetry JSONL: its losses by round, link bytes, kernel
    launches by op and round span seconds."""
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    samples = [r for r in recs if r["event"] == "sample"]
    launches: dict = {}
    for r in samples:
        if r["stream"] == "kernel_launches":
            launches[r["label"]] = launches.get(r["label"], 0) + int(r["value"])
    return {"loss": {r["step"]: r["value"] for r in samples if r["stream"] == "train_loss"},
            "link_bytes": sum(r["value"] for r in samples if r["stream"] == "link_bytes"),
            "launches": launches,
            "span_s": [r["seconds"] for r in recs if r["event"] == "span"]}


def spawn_cli_group() -> tuple:
    """Start phase 3f's ``CLI_WORLD``-rank group: ``torch.distributed.run``
    starting this file as each rank's script, on the one card, every run of
    ``CLI_GROUP_RUNS`` in the one group (``train_rank``), its output to a
    log file (nothing waits on a pipe while this process runs on); returns
    the runs' root, the process and its start time (see
    ``finish_cli_group``)."""
    import os

    root = ROOT / "build" / "cli" / "group"
    shutil.rmtree(root, ignore_errors=True)
    for tag in CLI_GROUP_RUNS:
        (root / tag).mkdir(parents=True)
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(CLI_WORLD), str(ROOT / "chip_smoke.py"), "--train-rank", str(root),
           *CLI_FLAGS, "--steps", str(CLI_GROUP_ROUNDS), "--tau", str(CLI_GROUP_TAU),
           "--ckpt-every", str(CLI_GROUP_ROUNDS)]
    with open(root / "group.log", "w") as f:
        proc = subprocess.Popen(cmd, env=env, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
    return root, proc, time.perf_counter()


def stop_group(proc) -> None:
    """Kill a spawned group's process session if it still runs."""
    import os
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def finish_cli_group(root: Path, proc, t0: float) -> tuple:
    """Wait for the group ``spawn_cli_group`` started (killed, and this
    raises, if it fails or passes ``CLI_DEADLINE``); returns its wall seconds
    and its log split by run."""
    try:
        proc.wait(timeout=max(1.0, CLI_DEADLINE - (time.perf_counter() - t0)))
    finally:
        stop_group(proc)
    wall = time.perf_counter() - t0
    log = (root / "group.log").read_text()
    assert proc.returncode == 0, f"cli group exited {proc.returncode}:\n{log[-6000:]}"
    logs, tag = {}, None
    for line in log.splitlines():
        if line.startswith("[cli-run] "):
            tag = line.split()[1]
        elif tag is not None:
            logs.setdefault(tag, []).append(line)
    assert sorted(logs) == sorted(CLI_GROUP_RUNS), (sorted(logs), log[-2000:])
    for tag, lines in logs.items():
        print("\n".join(f"cli {tag}: {line}" for line in lines if "[train]" in line))
    return wall, {tag: "\n".join(lines) for tag, lines in logs.items()}


def cli_twin(cfg, comp: dict, nodes: int, moved: bool = False) -> tuple:
    """A phase 3f group run at model 1 in this process: the same nodes,
    flags, init and token pipeline as the CLI (``moved``: the init one fp32
    ulp up, the floor); the losses by round and the whole parameters."""
    import numpy as np

    from repro_torch.data import TokenPipeline, make_lm_tokens
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tree import tree_leaves, tree_map

    job = make_train_job(cfg, make_test_mesh(nodes, device="cuda"), algorithm="dse_mvr",
                         tau=CLI_GROUP_TAU, lr=CLI_LR, alpha=0.05, gossip="roll",
                         use_fused=True, compression=comp.get("--compression"),
                         channel=comp.get("--channel"))
    params = job.model.init(0, device="cuda")
    if moved:
        params = tree_map(lambda t: torch.nextafter(t, torch.full_like(t, math.inf)), params)
    state = job.init_state(0, params=params)
    del params
    seq = int(CLI_FLAGS[CLI_FLAGS.index("--seq-len") + 1])
    batch = int(CLI_FLAGS[CLI_FLAGS.index("--global-batch") + 1])
    if cfg.vocab_size not in CLI_TOKENS:   # the CLI's stream, made once for every twin
        CLI_TOKENS[cfg.vocab_size] = make_lm_tokens(2_000_000, cfg.vocab_size, seed=0)
    pipe = TokenPipeline(CLI_TOKENS[cfg.vocab_size], seq, batch, seed=0)
    losses = []
    for _ in range(CLI_GROUP_ROUNDS):
        xs, ys = [], []
        for _ in range(job.round_len):
            x, y = pipe.batch()
            xs.append(x.reshape(nodes, batch // nodes, seq))
            ys.append(y.reshape(nodes, batch // nodes, seq))
        state, metrics = job.step_fn(state, job.local_batch({"tokens": np.stack(xs),
                                                             "targets": np.stack(ys)}))
        losses.append(float(metrics["loss"]))
    return losses, tree_leaves(job.full(state.params))


def cli_path(api, smi: str) -> tuple:
    """Phase 3f: the training CLI, the example and the sweep on the card.
    Returns every run's launches (this process's and the ranks') and each
    op's phase 3f launches by run."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.compression import link_bytes_per_round
    from repro_torch.core import make_algorithm, ring
    from repro_torch.experiments import sweep
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    cfg = cli_model()
    runs, by_run = [], {}
    # the CLI_WORLD-rank group starts first; the world-1 runs and the sweep
    # run in this process while its ranks start and train
    root, proc, t_group = spawn_cli_group()

    def count(name, launches):
        runs.append(launches)
        for op, n in launches.items():
            by_run.setdefault(op, {})[name] = n

    try:
        # 1. world 1: the example (DSE-MVR, tau 4) and GT-DSGD, in this process
        buckets1, _, _ = cli_shape(cfg, 1)
        torch.cuda.reset_peak_memory_stats()
        api.reset_counters()
        t = time.perf_counter()
        hist = load_example("decentralized_lm_torch").main(
            ["--full", "--steps", str(CLI_EXAMPLE_ROUNDS), "--use-fused", "--lr", str(CLI_LR),
             "--out", str(ROOT / "build" / "cli" / "example")])
        wall = time.perf_counter() - t
        got = api.launch_counts()
        losses = [h["loss"] for h in hist]
        print(f"cli example lm-100m world 1 ({smi}): {CLI_EXAMPLE_ROUNDS} rounds of tau 4 in "
              f"{wall:.1f} s (token stream included), s a round "
              f"{[round(b['t'] - a['t'], 3) for a, b in zip([{'t': 0.0}] + hist, hist)]}, loss "
              f"{losses}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
              f"{json.dumps(got)}; {buckets1} buckets")
        assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], losses
        assert got == dse_launches(buckets1, 4, CLI_EXAMPLE_ROUNDS), got
        count("example", got)

        api.reset_counters()
        t = time.perf_counter()
        hist = train.main(CLI_FLAGS + ["--algorithm", "gt_dsgd", "--steps", str(CLI_GT_STEPS)])
        got = api.launch_counts()
        print(f"cli gt_dsgd lm-100m world 1 ({smi}): {CLI_GT_STEPS} steps in "
              f"{time.perf_counter() - t:.1f} s, loss {[h['loss'] for h in hist]}, launches "
              f"{json.dumps(got)}")
        assert all(math.isfinite(h["loss"]) for h in hist)
        # a step one axpby (the x step) and one add_sub (the tracking
        # correction), each once a bucket
        assert got == {"axpby": CLI_GT_STEPS * buckets1, "add_sub": CLI_GT_STEPS * buckets1}, got
        count("gt_dsgd", got)

        # 2. the sweep at the reference's defaults, both engines, with and
        #    without QSGD
        api.reset_counters()
        t = time.perf_counter()
        out = ROOT / "build" / "cli" / "sweep"
        shutil.rmtree(out, ignore_errors=True)
        rows = sweep.main(["--engines", "sim,sharded", "--compressors", "identity,qsgd",
                           "--rounds", str(CLI_SWEEP_ROUNDS),
                           "--out", str(out), "--bench-out", str(out / "bench.json")])
        got = api.launch_counts()
        cells = {p.stem: json.loads(p.read_text()) for p in (out / "cells").glob("*.json")}
        summary = [json.loads(line) for line in (out / "summary.jsonl").read_text().splitlines()]
        bench = json.loads((out / "bench.json").read_text())
        print(f"cli sweep ({smi}): {len(rows)} cells in {time.perf_counter() - t:.1f} s, wall by "
              f"cell {json.dumps({r['cell_id']: r['wall_s'] for r in rows})}, launches "
              f"{json.dumps(got)}")
        assert len(rows) == len(cells) == len(summary) == len(bench) == 8
        assert {r["cell_id"] for r in summary} == set(cells)
        for cid, art in cells.items():
            assert set(art) == {"cell", "history", "streams", "schedule_gaps", "final", "wall_s"}
            final = art["final"]["train_loss" if cid.startswith("sim") else "loss"]
            assert final is not None and math.isfinite(final), (cid, art["final"])
        assert got.get("qsgd_quantize", 0) > 0 and got.get("qsgd_dequantize", 0) > 0, got
        count("sweep", got)
    except BaseException:
        stop_group(proc)
        raise
    # 3. CLI_WORLD gloo ranks on the card at the reference's layout (2 nodes
    #    x model 2, lm-100m's tp): roll, QSGD, CHOCO top-k; each against the
    #    same 2 nodes at model 1 in this process
    data, model = train.mesh_shape(CLI_WORLD)
    _, n_leaves, meta_all = cli_shape(cfg, data)
    per_node = tree_leaves(cli_shape(cfg, 1)[2])
    shifts = len(ring(data).shifts)
    wall, logs = finish_cli_group(root, proc, t_group)
    print(f"cli group {list(CLI_GROUP_RUNS)} lm-100m on {CLI_WORLD} gloo ranks, one "
          f"torch.distributed.run ({smi}): {wall:.1f} s wall (spawn, token streams, "
          f"{CLI_GROUP_ROUNDS} rounds of tau {CLI_GROUP_TAU} a run, beside this process's "
          f"world-1 runs and sweep)")
    for tag, extra in CLI_GROUP_RUNS.items():
        out, log = root / tag, logs[tag]
        assert f"mesh={{'data': {data}, 'model': {model}}}" in log, log[-2000:]
        ranks = [read_telemetry(out / ("tel.jsonl" if r == 0 else f"tel.jsonl.rank{r}"))
                 for r in range(CLI_WORLD)]
        info = [json.loads((out / f"peak.rank{r}").read_text()) for r in range(CLI_WORLD)]
        dims = info[0]["shard_dims"]
        comp = dict(zip(extra[::2], extra[1::2]))
        codec = comp.get("--compression")
        alg = make_algorithm("dse_mvr", lr=CLI_LR, tau=CLI_GROUP_TAU, compression=codec,
                             channel=comp.get("--channel"))
        # the byte rule (compression/gossip.py): model 1's link bytes plus,
        # a node and buffer, (M - 1) x the replicated leaves' message and
        # QSGD's 4 B scale a sharded leaf
        chan = alg.comm.resolved_channel()
        rep = {str(i): t[0] for i, (t, d) in enumerate(zip(per_node, dims)) if d is None}
        more = 0
        for i in range(len(alg.comm.buffers)):
            c = chan.for_buffer(i) if chan is not None else None
            msg = (sum(t.numel() * t.element_size() for t in rep.values()) if c is None
                   else c.message_bytes(rep))
            if codec == "qsgd":
                msg += 4 * sum(d is not None for d in dims)
            more += data * (model - 1) * msg
        link = (sum(link_bytes_per_round(alg.comm, meta_all).values()) + more) * CLI_GROUP_ROUNDS
        per_leaf = 2 * n_leaves * CLI_GROUP_ROUNDS   # both buffers, a leaf a rank
        codec_ops = {}
        if codec == "qsgd":
            codec_ops = dict(qsgd_quantize=per_leaf, qsgd_dequantize=per_leaf * (1 + shifts))
        elif codec:
            codec_ops = dict(top_k_pack=per_leaf, top_k_unpack=per_leaf * (1 + shifts))
        want = [{**dse_launches(x["buckets"], CLI_GROUP_TAU, CLI_GROUP_ROUNDS), **codec_ops}
                for x in info]
        losses = [ranks[0]["loss"].get(r) for r in range(1, CLI_GROUP_ROUNDS + 1)]
        got_link = sum(r["link_bytes"] for r in ranks)
        leaves = tree_leaves(load_checkpoint(str(out / "ckpt"), CLI_GROUP_ROUNDS,
                                             device="cpu")[0])
        # the same 2 nodes at model 1 (and from its init one ulp up: the floor)
        t = time.perf_counter()
        twin_loss, twin = cli_twin(cfg, comp, data)
        gap = layout_gap(leaves, twin)
        floor = None
        if codec:
            floor = layout_gap(cli_twin(cfg, comp, data, moved=True)[1], twin)
        twin_s = time.perf_counter() - t
        del twin
        held = ("the band" if floor is None else
                f"{LAYOUT_FLOOR_TIMES} times the floor {floor:.4g}")
        print(f"cli {tag} lm-100m on {CLI_WORLD} gloo ranks, {data} nodes x model {model} "
              f"({smi}): s a "
              f"round by rank {json.dumps([[round(x, 3) for x in r['span_s']] for r in ranks])}; "
              f"peak GiB by rank {[round(x['peak_gib'], 2) for x in info]}; loss {losses}, "
              f"model 1 {twin_loss}; rank 0's checkpoint {gap:.4g} of the band from model 1's "
              f"parameters, held to {held} (model 1 runs {twin_s:.1f} s); link bytes "
              f"{got_link:.0f} (the rule x rounds {link:.0f}); launches by rank "
              f"{json.dumps([r['launches'] for r in ranks])} (want {json.dumps(want)})")
        assert all(v is not None and math.isfinite(v) for v in losses), losses
        assert losses[-1] < losses[0], (tag, losses)
        assert all(abs(a - b) <= SHARD_RTOL * abs(b) for a, b in zip(losses, twin_loss)), \
            (tag, losses, twin_loss)
        assert gap <= (1.0 if floor is None else LAYOUT_FLOOR_TIMES * floor), (tag, gap, floor)
        for r in ranks[1:]:
            assert r["loss"] == ranks[0]["loss"], tag
        assert got_link == link, (tag, got_link, link)
        for r, w in zip(ranks, want):
            assert r["launches"] == w, (tag, r["launches"], w)
        assert len(leaves) == n_leaves and all(
            x.shape[0] == data and bool(torch.isfinite(x.float()).all()) for x in leaves)
        for rank, r in enumerate(ranks):
            count(f"{tag}_rank{rank}", r["launches"])

    print(f"cli phase {time.perf_counter() - t_phase:.1f} s")
    return runs, by_run


def main() -> int:
    # ---------------------------------------------------------------- 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from repro_torch.compression import link_bytes_per_round
    from repro_torch.core.simulate import default_comm_seed_fn
    from repro_torch.kernels import _cuda, api
    from repro_torch.paper_problem import make_algorithm, make_paper_problem, mlp_init, run_method

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    kind = torch.cuda.get_device_name(0)
    bw = hbm_bytes_per_s(kind)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"triton {importlib.metadata.version('triton')} on {kind}; "
          f"HBM bound at {bw / 1e12} TB/s; host CPU path "
          f"{torch.backends.cpu.get_cpu_capability()} x{torch.get_num_threads()}")
    t0 = time.perf_counter()

    def done(phase):
        print(f"smoke: phase {phase} done {time.perf_counter() - t0:.1f} s after the build began",
              flush=True)

    sources = ("top_k", "flash_attention", "wkv_chunk", "rms_norm")
    _cuda.build(sources)   # one nvcc per source, together
    print(f"nvcc built {', '.join(f'{name}.cu' for name in sources)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in sources:
        for fn, regs, spill, smem in ptxas_summary(_cuda.build_log(name)):
            print(f"ptxas {name}: {fn}: {regs} registers, {spill} bytes spill stores, "
                  f"{smem} bytes static shared memory")
    # the bf16 kernels at D=128 and 256 load by TMA and multiply by wgmma
    cuobjdump = Path(_cuda.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_cuda.build(["flash_attention"])[
        "flash_attention"])], capture_output=True, text=True, check=True, timeout=300).stdout
    for fn, counts in sass_counts(sass, ("UTMALDG", "HGMMA", "HMMA")).items():
        print(f"sass flash_attention: {fn}: " + json.dumps(counts))
        if "fa_hopper_kernel" in fn:
            assert counts["UTMALDG"] and counts["HGMMA"] and not counts["HMMA"], (fn, counts)

    # ---------------------------------------------------------------- 2
    spin_up()
    results = check_elementwise(api, bw)
    results.update(check_top_k(api, bw))
    results.update(check_attention_kernels(api, bw))
    results["wkv_chunk"] = check_wkv_kernel(api, bw)

    done("2")
    # ---------------------------------------------------------------- 3
    data, _ = make_paper_problem(OMEGA, seed=0)
    idx_cpu = torch.randint(
        0, data.samples_per_node, (STEPS, data.n_nodes, BATCH),
        generator=torch.Generator().manual_seed(1234),
    )
    idx_cuda = idx_cpu.cuda()
    seed_fn = default_comm_seed_fn(4321)   # the codec seeds, the same for every run
    kernel_runs = []                       # the runs through the kernels

    def run(name, device, steps=STEPS, mode="kernel", **kw):
        idx = idx_cuda if device == "cuda" else idx_cpu
        api.reset_counters()
        with api.dispatch_mode(mode):
            out = run_method(name, OMEGA, TAU, BATCH, steps, device=device,
                             index_fn=lambda s: idx[s], comm_seed_fn=seed_fn, **kw)
        out["launches"] = api.launch_counts()
        out["steps_per_s"] = steps / out["wall_s"]
        kept = {k: out.pop(k) for k in ("streams", "state") if k in out}
        shown = {k: "given" if k == "init_params" else
                 f"Telemetry(spans={v.spans})" if k == "telemetry" and v is not None else v
                 for k, v in kw.items()}
        print(f"run {name} device={device} mode={mode} steps={steps} {shown}: " + json.dumps(out))
        if out["launches"]:
            kernel_runs.append(out)
        return dict(out, **kept)

    def agree(a, b, what, rtol=RUN_RTOL, acc_tol=ACC_TOL):
        for k in ("train_loss", "consensus"):
            ok = abs(a[k] - b[k]) <= RUN_ATOL + rtol * abs(b[k])
            assert ok, f"{what}: {k} {a[k]} vs {b[k]}"
        assert abs(a["test_acc"] - b["test_acc"]) <= acc_tol, f"{what}: test_acc"
        for k in ("train_loss", "consensus", "test_acc"):
            assert a[k] == a[k] and abs(a[k]) < float("inf"), f"{what}: {k} not finite"

    # a short run on each path first keeps one-time set-up (cuBLAS handles,
    # autograd's worker threads) out of the timed runs
    for use_fused in (True, False):
        run_method("dse_mvr", OMEGA, TAU, BATCH, 8, device="cuda",
                   use_fused=use_fused, index_fn=lambda s: idx_cuda[s])
    fused = run("dse_mvr", "cuda", use_fused=True)
    plain_cuda = run("dse_mvr", "cuda", use_fused=False)
    plain_cpu = run("dse_mvr", "cpu", use_fused=False)
    assert not plain_cuda["launches"] and not plain_cpu["launches"]
    # the second half of a kernels, plain, plain, kernels turn for steps/s
    plain_cuda_2 = run("dse_mvr", "cuda", use_fused=False)
    fused_2 = run("dse_mvr", "cuda", use_fused=True)
    print("dse_mvr steps/s in turns: kernels %.1f %.1f, plain %.1f %.1f" % (
        fused["steps_per_s"], fused_2["steps_per_s"],
        plain_cuda["steps_per_s"], plain_cuda_2["steps_per_s"]))
    agree(fused_2, fused, "dse_mvr kernels, run to run")
    agree(plain_cuda_2, plain_cuda, "dse_mvr plain cuda, run to run")
    agree(fused, plain_cpu, "dse_mvr kernels vs cpu")
    agree(plain_cuda, plain_cpu, "dse_mvr plain cuda vs cpu")
    agree(fused, plain_cuda, "dse_mvr kernels vs plain cuda")
    for op in ("mvr_update", "axpby", "dse_combine_yh"):
        assert fused["launches"].get(op, 0) > 0, f"dse_mvr did not launch {op}"

    fused_z = run("dse_mvr", "cuda", use_fused=True, fuse_tracking_buffers=True)
    agree(fused_z, run("dse_mvr", "cpu", fuse_tracking_buffers=True), "fused-z")
    assert fused_z["launches"].get("dse_combine", 0) > 0, "fused-z did not launch dse_combine"

    sgd = run("dse_sgd", "cuda", use_fused=True)
    agree(sgd, run("dse_sgd", "cpu"), "dse_sgd")
    for op in ("axpby", "dse_combine_yh"):
        assert sgd["launches"].get(op, 0) > 0, f"dse_sgd did not launch {op}"

    # the paper's baselines, through the kernels against the CPU
    baseline_rate = {}
    for name in BASELINES:
        got = run(name, "cuda", use_fused=True)
        agree(got, run(name, "cpu"), f"{name} kernels vs cpu")
        assert got["launches"].get("axpby", 0) > 0, f"{name} did not launch axpby"
        if name in ("gt_dsgd", "gt_hsgd"):
            assert got["launches"].get("add_sub", 0) > 0, f"{name} did not launch add_sub"
        if name == "gt_hsgd":   # one axpby, mvr_update and add_sub per step
            want = {"axpby": STEPS, "mvr_update": STEPS, "add_sub": STEPS}
            assert got["launches"] == want, got["launches"]
        baseline_rate[name] = got["steps_per_s"]
    print("baselines steps/s through the kernels: " + json.dumps(baseline_rate))

    # QSGD-compressed gossip: kernels, plain on the card, plain on the CPU
    q_kernels = run("dse_mvr", "cuda", steps=QSGD_STEPS, use_fused=True, compression="qsgd")
    q_plain_cuda = run("dse_mvr", "cuda", steps=QSGD_STEPS, mode="ref", compression="qsgd")
    q_plain_cpu = run("dse_mvr", "cpu", steps=QSGD_STEPS, compression="qsgd")
    events = QSGD_STEPS // TAU   # 4 leaves x 2 buffers per communication event
    assert q_kernels["launches"]["qsgd_quantize"] == 8 * events, q_kernels["launches"]
    assert q_kernels["launches"]["qsgd_dequantize"] == 8 * events, q_kernels["launches"]
    assert not q_plain_cuda["launches"] and not q_plain_cpu["launches"]
    for a, b, what in ((q_kernels, q_plain_cpu, "kernels vs cpu"),
                       (q_plain_cuda, q_plain_cpu, "plain cuda vs cpu"),
                       (q_kernels, q_plain_cuda, "kernels vs plain cuda")):
        agree(a, b, f"dse_mvr qsgd {what}", rtol=QSGD_RTOL, acc_tol=QSGD_ACC_TOL)
    print("dse_mvr qsgd steps/s: kernels %.1f, plain cuda %.1f, plain cpu %.1f" % (
        q_kernels["steps_per_s"], q_plain_cuda["steps_per_s"], q_plain_cpu["steps_per_s"]))

    # the rest of compressed gossip: the sparsifying and low-rank codecs on
    # the sync, choco, async and per-buffer channels, and overlap
    params = {k: v.unsqueeze(0).repeat((data.n_nodes,) + (1,) * v.dim())
              for k, v in mlp_init(0).items()}
    raw_bytes = sum(link_bytes_per_round(
        make_algorithm("dse_mvr", 0.3, TAU, STEPS).comm, params).values())
    gossip_rates = {}
    for tag, channel, comp in gossip_configs():
        kw = dict(steps=QSGD_STEPS, compression=comp, channel=channel)
        got = run("dse_mvr", "cuda", use_fused=True, **kw)
        plain_card = run("dse_mvr", "cuda", mode="ref", **kw)
        cpu = run("dse_mvr", "cpu", **kw)
        assert not plain_card["launches"] and not cpu["launches"]
        rtol = CHOCO_RTOL if tag in CHOCO_BAND else QSGD_RTOL
        for a, b, what in ((got, cpu, "kernels vs cpu"), (plain_card, cpu, "plain cuda vs cpu"),
                           (got, plain_card, "kernels vs plain cuda")):
            print(f"gossip {tag} {what}: relative gap " + json.dumps(
                {k: abs(a[k] - b[k]) / abs(b[k]) for k in ("train_loss", "consensus")}))
            agree(a, b, f"dse_mvr {tag} {what}", rtol=rtol, acc_tol=QSGD_ACC_TOL)
        events = QSGD_STEPS // TAU
        if comp is not None and comp.startswith(("top_k", "rand_k")):
            # 4 leaves x 2 buffers: one pack and one unpack per leaf per event
            for op in ("top_k_pack", "top_k_unpack"):
                assert got["launches"].get(op) == 8 * events, (tag, got["launches"])
        link = link_bytes_per_round(
            make_algorithm("dse_mvr", 0.3, TAU, STEPS, channel=channel, compression=comp).comm,
            params)
        print(f"gossip {tag}: launches {json.dumps(got['launches'])}; link bytes per round "
              f"{sum(link.values()):.0f} {json.dumps(link)} (raw fp32 "
              f"{raw_bytes / sum(link.values()):.3f}x)")
        gossip_rates[tag] = (got["steps_per_s"], plain_card["steps_per_s"], cpu["steps_per_s"])
    print("gossip steps/s (kernels, plain cuda, plain cpu): " + json.dumps(gossip_rates))

    # identity compression and async:1 are structurally the uncompressed path
    uncompressed = run("dse_mvr", "cuda", use_fused=True)
    for kw in (dict(compression="identity"), dict(channel="async:1")):
        same = run("dse_mvr", "cuda", use_fused=True, **kw)
        for k in ("train_loss", "consensus", "test_acc"):
            assert same[k] == uncompressed[k], f"{kw} vs uncompressed: {k}"
        assert same["launches"] == uncompressed["launches"]

    link = {c: link_bytes_per_round(make_algorithm("dse_mvr", 0.3, TAU, STEPS,
                                                   compression=c).comm, params)
            for c in (None, "qsgd")}
    raw, qsgd = sum(link[None].values()), sum(link["qsgd"].values())
    print(f"link bytes per round (8 nodes, both buffers): raw fp32 {raw:.0f} "
          f"{json.dumps(link[None])}, qsgd {qsgd:.0f} {json.dumps(link['qsgd'])}, "
          f"ratio {raw / qsgd:.3f}")

    done("3")
    # --------------------------------------------------------------- 3b
    scenario_path(run, agree)

    done("3b")
    # --------------------------------------------------------------- 3c
    telemetry_path(run, idx_cuda, seed_fn, smi)

    done("3c")
    # --------------------------------------------------------------- 3d
    runs, elastic_launches = elastic_path(api, smi)
    kernel_runs += [{"launches": launches} for launches in runs]
    for name, by_worker in elastic_launches.items():
        results[name]["elastic_launches"] = by_worker

    done("3d")
    # --------------------------------------------------------------- 3e
    runs, sharded_launches = sharded_path(api, smi)
    kernel_runs += [{"launches": launches} for launches in runs]
    for name, by_process in sharded_launches.items():
        results[name]["sharded_launches"] = by_process

    done("3e")
    # --------------------------------------------------------------- 3f
    runs, cli_launches = cli_path(api, smi)
    kernel_runs += [{"launches": launches} for launches in runs]
    for name, by_run in cli_launches.items():
        results[name]["cli_launches"] = by_run

    done("3f")
    # --------------------------------------------------------------- 3g
    runs, layout_launches = layout_path(api, smi)
    kernel_runs += [{"launches": launches} for launches in runs]
    for name, by_run in layout_launches.items():
        results[name]["layout_launches"] = by_run

    done("3g")
    # phase 4g's group sets up while phases 4-4f run (its ranks idle, a
    # CUDA context each, until the go of phase 4g)
    serve_group = spawn_serve_group()
    try:
        # ------------------------------------------------------------ 4
        kernel_runs += [{"launches": launches} for launches in serving_path(api)]

        done("4")
        # ----------------------------------------------------------- 4b
        kernel_runs += [{"launches": launches} for launches in moe_serving_path(api)]

        done("4b")
        # ----------------------------------------------------------- 4c
        kernel_runs += [{"launches": launches} for launches in hybrid_serving_path(api)]

        done("4c")
        # ----------------------------------------------------------- 4d
        kernel_runs += [{"launches": launches} for launches in vlm_audio_path(api)]

        done("4d")
        # ----------------------------------------------------------- 4e
        kernel_runs += [{"launches": launches} for launches in training_path(api)]

        done("4e")
        # ----------------------------------------------------------- 4f
        runs, snapshot_rows = serve_while_training_path(api, bw)
        kernel_runs += [{"launches": launches} for launches in runs]
        for name, row in snapshot_rows.items():
            results[name]["snapshot"] = row

        done("4f")
    except BaseException:
        stop_group(serve_group[1])
        raise
    # --------------------------------------------------------------- 4g
    runs, serve_launches = serve_layout_path(api, smi, serve_group)
    kernel_runs += [{"launches": launches} for launches in runs]
    for name, by_run in serve_launches.items():
        results[name]["serve_layout_launches"] = by_run

    done("4g")
    # ---------------------------------------------------------------- 5
    kernel_runs += [{"launches": launches} for launches in rwkv_serving_path(api)]

    done("5")
    # ---------------------------------------------------------------- 6
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "bf16_max_abs_err",
            "flips", "mlp_ms", "mlp_plain_ms", "plain_chunked_ms", "group", "pass_ms",
            "bf16", "skew_ms", "windows", "windowed_ms", "one_pass_ms", "mlp_ms_p10_p90",
            "mlp_plain_ms_p10_p90",
            "ms_p10_p90", "library_ms_p10_p90", "on_path", "cases", "snapshot",
            "elastic_launches", "sharded_launches", "cli_launches", "layout_launches",
            "serve_layout_launches")
    kernels = []
    for name, row in results.items():
        row["launches"] = sum(r["launches"].get(name, 0) for r in kernel_runs)
        row["on_path"] = name not in OFF_PATH
        if row["on_path"]:
            assert row["launches"] > 0, f"{name} never launched on the main paths"
        else:
            assert row["launches"] == 0, f"{name} is on no path but launched"
        kernels.append({k: row.get(k) for k in keys})
    print(f"smoke: {time.perf_counter() - t0:.1f} s from the build to the kernels line")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-rank"]:
        train_rank(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    if sys.argv[1:2] == ["--serve-rank"]:
        serve_rank(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--layout-rank"]:
        layout_rank(sys.argv[2], sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["--sharded-worker"]:
        world, rank, store, out = sys.argv[2:6]
        sharded_worker(int(world), int(rank), store, out)
        sys.exit(0)
    sys.exit(main())
