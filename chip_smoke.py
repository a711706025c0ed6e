#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

Run from the root of a checkout, on a machine with the card:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero; no exception is caught):

  1. device  — the card's name, power limit and compute capability (9.0+).
  2. build   — the CUDA kernels from ``src/repro_torch/csrc`` (one
               ``nvcc`` per source, in parallel), with ptxas' register,
               shared-memory and spill report and the build time; then
               ``cuobjdump -sass`` of the library: the tensor-core
               instructions (``HGMMA``, ``HMMA``) of each kernel's
               functions, printed for every function whose name holds
               ``fused_ffn``, ``flash_attention`` or ``gemm_spmm``; fails
               when the bf16 or the f32 (3xTF32) FFN kernel, the bf16
               flash ``wgmma`` kernel or any instance of the GeMM-SpMM
               ``wgmma`` kernel or of its wide twin has no ``HGMMA``.  The
               hybrid SpMM's, the wide GeMM-SpMM's and the f32 FFN's
               functions print their registers and spills, and the build
               fails if any hybrid SpMM function
               holds a float atomic (``RED`` / ``ATOM*`` on F32, F16, BF16).
  3. kernels — each kernel against its plain PyTorch version at every
               shape the main path gives it (GCN layers 1 and 2, the
               power-law hybrid product, SpMM-SpMM; taken from the real
               schedules below, whose device copies the main path then
               reuses), f32
               and bf16: max abs / relative error, time (CUDA events), the
               bound (larger of compulsory bytes / 3.35 TB/s and operations
               / peak rate: nonzero entries, needed table rows and real
               output rows, each once; format padding is not counted; f32
               at 495 / 3 TFLOP/s, the rate of f32-accurate products as
               three TF32 products on the tensor cores, bf16 at 989), the
               plain version's time, and a library yardstick in f32:
               ``torch.sparse.mm`` for ``spmm_ell``; for the two fused
               kernels the unfused chain that computes the same ``(d1,
               rows0)`` (``kernels/ref.py``: ``torch.matmul`` or
               ``torch.sparse.mm`` for op 1, then ``torch.sparse.mm`` of
               the fused rows).  The GeMM-SpMM cases print the device
               function the launcher dispatched, and GCN layers 1 and 2
               must run ``tile_fused_gemm_spmm_wf0_wgmma_kernel`` in f32
               and bf16.  ``spmm_ell`` runs body-only at wavefront 1,
               then as the path runs it: banded wavefront 1
               at both layers with its tails, written in place at
               ``j_rows1``, and the power-law graph's whole hybrid product
               at 128 and 32 columns; each of those is timed beside the
               chain it replaced (body-only call, ``index_copy_`` where
               it applies, ``fused_ops._spill_add``) and ``torch.sparse.mm``
               of the same matrix (f32); its bound counts tail lanes like
               body entries.  The power-law cases must take the split-row
               path (``row+split``), and every whole hybrid product must
               give the same bits twice.  The backward's shapes, from the
               real transpose entries: GeMM-SpMM at the banded GCN's
               layer-2 ``dB`` (t 64, b_col 32, c_col 128, on the ``wgmma``
               kernel), and the banded ``Âᵀ`` hybrid product at 128 and
               32 columns (each layer's ``Âᵀ·Ḋ``).
  4. tile_fused_matmul on ``banded_spd(131072, 8)``, GeMM-SpMM and
               SpMM-SpMM at 128 columns: the ``auto`` pick must be
               ``cuda``; the result must match ``backend="torch"`` on the
               card and the numpy oracle on the host.  After the main path
               has been counted, both op pairs are timed on the fused arm
               (``backend="cuda"``) and on ``backend="unfused"`` (CUDA
               events over 20 calls after 3 warm-ups, and the profiler's
               device time of 5 calls), and the fused/unfused ratios are
               printed: the paper's Table 2 and Table 3 comparison on the
               card.  Gradients of both op pairs through the autograd
               Functions, on ``banded_spd(131072, 8)`` with ``(w·D).sum()``
               and on the same matrix with its even rows emptied
               (non-symmetric) with ``D.sum()``: ``auto`` against
               ``backend="torch"`` (rel. err ≤ 2e-3); each backward must
               launch its wavefront-0 kernel, and the transpose entry's
               pick is printed.
  5. GCN serving at the ``CONFIG`` widths (128 → 128 → 32) on two
               131,072-node graphs, 8 requests each: banded (fused arm) and
               power-law (unfused arm), under ``torch.inference_mode()``
               (serving records no graph).  Each answer is held to the
               ``backend="torch"`` forward.
  6. trace   — one more request per graph under ``torch.profiler``: device
               time by kernel and the device's busy share of the request;
               fails on any ``index_add_`` in either request, or on more
               ``index_copy_`` calls than fused layers (the scatter of
               wavefront 0's rows; wavefront 1 is written in place).
  7. LM kernels — flash attention, the fused FFN and the fused MoE FFN
               through their entry points (``kernels.ops``) at published
               widths (qwen2.5-3b prefill, hymba-1.5b's window, Whisper's
               ragged 1500-frame encoder, the granite-moe-3b,
               llama4-scout and minicpm3-4b prefills; stablelm-1.6b FFN
               widths;
               granite-moe-3b experts; minitron-8b FFN widths, bf16
               only: d 4096, two cluster groups), f32 and bf16, each
               against its plain version (each output row against its
               own largest value; bf16 within 2^-6, f32 within 1e-4):
               errors, time, bound (compulsory bytes, and
               operations over the unmasked (query, key) pairs only),
               plain time, and a library call as yardstick
               (``scaled_dot_product_attention``; the unfused
               ``matmul → act → matmul`` / ``bmm`` chains).  Flash K/V
               carry the models' own K/V heads (read in place), and the
               launcher's record of its dispatch names the device
               function each flash case ran: bf16 at head dim 64 or 128
               must run ``flash_attention_wgmma_kernel``; each FFN / MoE
               case prints its own (``fused_ffn.last_path``), and must run
               ``fused_ffn_wgmma_kernel`` in bf16 and
               ``fused_ffn_tf32_kernel`` (3xTF32) in f32.
  8. LM serving — qwen2.5-3b at full width in bf16 (weights from a seeded
               generator on the card): 4 prompts of 2048 tokens, one
               batched prefill, 32 greedy decode steps through
               ``launch.serve``'s step; prefill time and tokens/s (after
               ``empty_cache``, so with ``cudaMalloc``; then three more
               prefills with the allocator warm), decode p50 and max; the
               prefill logits held to the same model with
               the plain attention (``impl="torch"``); the first decode
               steps replayed on a fresh cache of the serve run's size:
               their greedy picks must be the served tokens, and their
               logits are held to a full forward over prompt + served
               tokens with the plain attention.
  9. trace   — one prefill and one decode step under ``torch.profiler``:
               device time by kernel, device kernels per step and the
               device's busy share.
 10. GCN training — the ``CONFIG`` model on both phase-5 graphs, f32,
               10 SGD steps at lr 0.3 through ``launch.steps
               .make_gcn_train_step``: step 1's weight gradients against
               ``backend="torch"`` on the card and a float64 host oracle
               (the same loss through ``torch.sparse.mm`` autograd), ≤
               2e-3; the loss must fall; no schedule-cache miss after step
               1, and one transpose entry a graph (layer 2's ``dB``); each
               step's launches (``spmm_ell`` for each layer's ``Âᵀ·Ḋ``
               beside the forward's; on the banded graph one GeMM-SpMM
               launch more than a request, the backward's ``dB`` on the
               ``wgmma`` kernel); two backward passes give the same bits;
               one step under the profiler (device time by kernel, busy
               share; fails on any ``index_add_``); step p50 and max
               beside two yardsticks: the same step with
               ``backend="unfused"`` and a ``torch.sparse.mm`` autograd
               step.

 11. schedule transforms and the hetero stack (``phase_11``).
               11a reorder: ``banded_spd(131072, 8)``, normalized, under a
               seeded symmetric permutation — bandwidth before and after
               ``rcm_order``; GeMM-SpMM (B 131072 × 128, C 128 × 128) and
               SpMM-SpMM at 128 columns must pick ``unfused`` without
               reorder and ``cuda`` with ``reorder="auto"``, launch their
               wavefront-0 kernel (GeMM-SpMM on the device function its
               rule picks), agree with ``backend="torch"`` and with the
               product on the unshuffled matrix, un-permuted; the fused and
               reordered arm timed against ``backend="unfused"``; both op
               pairs' gradients against ``backend="torch"``; the kernels at
               the reordered shapes against their plain versions; the
               power-law graph under ``reorder="auto"`` (no ordering
               expected to clear the floor).  11b autotune: the banded
               GCN's two layer shapes and the banded SpMM-SpMM under
               ``autotune=True`` (winner, candidates, sweep seconds, pick,
               device function; result against ``backend="torch"``; a
               second call must not sweep), and a ``GCN`` built with
               ``FusionSpec(autotune=True)`` serving 8 requests.  11c
               hetero: ``HeteroGCNLayer`` on a typed graph shaped like
               ogbn-mag at 1/8 of its node and edge counts (8 relations,
               935,520 stacked rows, b_col 1024): one stacked inspection
               and none in the forwards, the Eq-3 pick, ``backend="auto"``
               and ``"cuda"`` (the wide ``wgmma`` GeMM-SpMM kernel, which
               the rule must pick) against the per-relation loop
               and ``backend="torch"``, weight gradients, p50 of the stack
               (``auto`` and ``"cuda"``) against ``hetero_loop_matmul``,
               peak device memory, the
               kernels at the stack's shapes (the GeMM-SpMM beside the
               CUDA-core kernel's time there, cited); then a SpMM-SpMM
               stack of 16
               power-law relations of 8,192 nodes on ``backend="cuda"``
               against the loop on ``backend="torch"``, and the SpMM-SpMM
               kernel at the stack's own schedule and stacked op 1 against
               its plain version.
 12. the serving tier.  12a: 64 requests of the reference CLI's drift (at
               10 % a jump to another window, at 30 % ``n_rows // 50``
               rows re-sampled) over windows of 30,000 / 31,000 / 29,000
               rows of ``banded_spd(262144, 8)`` through
               ``ServingTier(b_col=128, c_col=128)`` (``cache_size``
               ``SERVE_GEMM_CACHE``), f32, ``backend="auto"``: the
               bucket decisions; per request how it was served (hit,
               incremental patch, rebuild) and Eq-3's pick, whose kernels
               it must launch (GeMM-SpMM on ``wgmma``); each result
               against ``backend="torch"`` on the same entry (rel ≤ 1e-4)
               and every 8th against an f64 host product (≤ 2e-3); the
               stream must hold a hit, a patch that moved rows into
               wavefront 1 and a rebuild on the fused arm, and one bucket
               entry; wall p50 / max by kind, launches and device
               functions, the tier's stats and ``schedule_cache_stats()``,
               host seconds of a patch against a full inspection; one
               profiled request of each kind (no ``index_add_``).  12b:
               the same with ``ServingTier(b_is_sparse=True, c_col=128)``,
               16 requests, ``tile_fused_matmul(a, a, c)`` semantics (one
               ``index_add_`` allowed: op 1's dense spill).  12c:
               ``launch.serve.main(["--subgraphs", "64", ...])``, the
               reference's power-law stream at 32,768 nodes, 128 → 128,
               4 a batch (the unfused arm, ``spmm_ell``), then the same
               front end on the banded windows (stacked 512 / 512, the
               wide GeMM-SpMM, features made on the card); each
               flushed output against a per-request ``backend="torch"``
               run (rel ≤ 1e-4).
 13. sharded tile fusion over meshes (``models.sharding.Mesh``) whose
               entries all name this one card (the shards run one after
               another; no speed-up is claimed).  13a: ``tile_fused_matmul``
               on the normalized ``banded_spd(131072, 8)`` with phase 4's
               B / C (GeMM-SpMM, GCN layer 1's entry) and C (SpMM-SpMM),
               meshes (4,) 1d, (2, 2) 1.5d and (2, 2, 2) 2.5d, each with
               ``psum`` and ``reduce_scatter``, overlap off and on: the
               entry's layout and shard counts, rel err ≤ 1e-4 against
               the one-device ``"cuda"`` arm and ≤ 2e-3 against the f64
               oracle, overlap against sync ≤ 1e-6 (bit for bit printed),
               per call one wavefront-0 launch and one ``spmm_ell`` call
               a device and no plain executor (they raise meanwhile), the
               collectives' counted bytes beside ``shard_comm_model``'s;
               ``build_sharded_schedule``'s host seconds; both op pairs'
               gradients on (4,) against one device (≤ 1e-4).  13b: the
               banded ``CONFIG`` GCN on (4,) with the knobs ``auto``, 8
               requests under ``torch.inference_mode()`` against the
               one-device request (≤ 1e-4), each layer's pick, p50 / max,
               one traced request.  13c: 3 SGD steps of phase 10's banded
               set-up with ``mesh=``: step-1 weight gradients against one
               device (≤ 1e-4), the loss falls, no miss after step 1, the
               transpose entries mesh-keyed and sharded.  13d: the
               power-law GeMM-SpMM on (4,): the pick, whether the layout
               pricing fell back to one device, launches, rel err.
 14. LM training: stablelm-1.6b with ``block_pattern="sparse-band"``
               (the reference's own use of the pattern) at its published
               widths.  14a: the band ``decay_band_csr(2048, 32)`` under
               ``ssm._BAND_SPEC``, its forward and transpose entries (Eq
               3's pick printed: ``unfused``; the mixer forces ``cuda``):
               GeMM-SpMM at b_col = c_col = 2048, f32, on both entries
               (must run the wide ``wgmma`` kernel; printed beside the
               CUDA-core kernel's earlier time, cited), the CUDA-core
               GeMM-SpMM where its rule still sends a shape (t 96, b_col
               1024), ``spmm_ell`` as both entries' wavefront 1 and as the
               ``Aᵀ`` hybrid product at 2048 columns, each against its
               plain version (≤ 1e-4), timed (CUDA events, and queued
               behind a sleep) beside its bound, share and the
               ``torch.matmul`` + ``torch.sparse.mm`` chain.  14b:
               ``band_mix_apply`` with B 4, S 2048, d 2048, f32:
               ``backend="cuda"`` against ``"torch"`` (≤ 1e-4) and
               both against an f64 dense oracle (≤ 2e-3), output and the
               gradients in x, wv, wz, w_down (the band is
               lower-triangular, so ``Aᵀ ≠ A``); per-call time of the
               ``cuda`` and ``unfused`` arms, forward and forward +
               backward.  14c: the 24-layer bf16 model from seed 0 (1.54
               B parameters), one fixed batch of 4 × 2048 tokens and
               labels, 6 steps of ``launch.steps.make_train_step`` (AdamW,
               lr 3e-4, warmup 1) under the config's ``remat="dots"``:
               finite losses and ``min(losses[2:]) < losses[0]``, no
               schedule-cache miss after step 1, each step 288 GeMM-SpMM
               and 384 ``spmm_ell`` launches (the recompute runs each
               block's forward kernels again) and no plain executor or
               unfused arm (they raise meanwhile); step p50 / max, peak
               device memory, one traced step (busy share, the
               GeMM-SpMM's share of the busy time), the ``inference_mode``
               forward of the batch; then a 2-layer f32 cut of the same
               widths: step-1 gradients of every parameter with
               ``impl="cuda"`` against ``impl="torch"`` (≤ 1e-4 per
               tensor), and under remat ``"full"`` and ``"dots"`` against
               ``"none"`` (≤ 1e-6 per tensor; whether bit for bit is
               printed), one forward's launches more.
 15. LM training: the dense decoder at full width (stablelm-1.6b's
               ``CONFIG``: 24 layers, d 2048, 32 heads of 64, d_ff 5632,
               vocab 100,352, bf16, ``remat="dots"``), whose attention
               trains through ``layers.scan_attention``, the reference's
               chunked XLA attention in plain PyTorch.  15a:
               ``scan_attention`` at B 4, H 32, S 2048, D 64, causal: on a
               (B 1, H 2) cut, f32 and bf16, forward and backward against
               an f64 dense oracle (f32 ≤ 2e-3, bf16 ≤ 2^-7); the bf16
               forward against the flash kernel under ``no_grad``, row by
               row (≤ 2^-6); forward and forward + backward times (CUDA
               events) beside ``F.scaled_dot_product_attention``'s (a
               yardstick, never on the path).  15b:
               ``launch.train.main(["--arch", "stablelm-1.6b", "--steps",
               "16", "--batch", "4", "--seq", "2048", "--log-every",
               "1"])`` in-process, weights from seed 0: every loss finite
               and ``min(losses[2:]) < losses[0]``, no kernel launch
               (the flash kernel serves only), step p50 / max over steps
               2-16, peak device memory, one traced step (busy share,
               device time by kernel, ``aten::bmm``'s share: the
               attention's f32 products, forward, recompute and
               backward).  15c: ``--arch qwen2.5-3b --reduced`` with a
               checkpoint directory under ``build/``:
               ``--simulate-preemption 6`` exits 17, the rerun resumes
               from step 6, and the step-8 leaves equal an uninterrupted
               run's bit for bit.
 16. MoE    — the gated MoE layer and the two MoE decoders, bf16, weights
               from seeds (``phase_16``, run after phases 1-15 have
               freed their tensors).  16a: granite's layer (B 4 x S 2048,
               d 1536, 40 experts top-8, f 512) and llama4-scout's (B 2 x
               S 2048, d 5120, 16 experts top-1 plus the shared expert, f
               8192): output and gradients (x, router, w1, w3, w2, the
               shared expert) against an f64 oracle evaluated on the
               run's own routing (its top-k sets and kept slots), row by
               row within 2^-6 (top-1's router gradient, 0 in exact
               arithmetic, is printed); the (token, k) picks where the
               f64 routing differs, with their gate gaps; two calls bit
               for bit; dispatch / expert products / combine times.  16b:
               granite-moe-3b at full width and depth served as phase 8
               serves qwen (4 x 2048 prompts, 32 decode steps): the flash
               kernel exactly 32 times a prefill and ``fused_moe_ffn``
               never, two prefills bit for bit, the replayed greedy
               picks = the served tokens, prefill and decode times; each
               layer's top-k sets recorded (``record_routes`` wraps
               ``layers._row_dispatch``) in the flash and the plain
               attention's prefill: the share that agrees and the drops
               by layer, the logits held within 5e-2 on each row's tokens
               before its first routing difference (earlier tokens route,
               drop and attend alike), and, printed, the plain run with
               the flash run's routing replayed (``replay_routes``), by
               block; decode against a full forward where both route and
               keep alike; a 2-layer f32 cut at full width (2 x 512):
               routing must agree, logits within 1e-3, 8 tokens decoded
               one at a time vs the forward (cap 8: nothing drops); the
               same tokens through all 32 layers in f32 with the routing
               replayed, within 1e-3.  16c: a traced prefill and decode
               step, device time of the ``record_function`` scopes
               ``moe.dispatch`` / ``moe.experts`` / ``moe.combine`` /
               ``attention`` and of the flash kernel, kernels a step.
               16d: llama4-scout at full width, depth cut to 8 of 48
               layers (the 107.8 B model does not fit one 80 GB card),
               16b's serving checks with 16 decode steps and 8 flash
               launches a prefill.  16e: granite training, 6 AdamW steps
               on one fixed 4 x 2048 batch under ``remat="dots"``: losses
               fall, no kernel launch, p50 / max, peak memory, a traced
               step.
 17. MLA and the attention + mamba hybrid, bf16, weights from seeds
               (``phase_17``, run after phase 16 has freed its tensors).
               17a: ``layers.mla_attention`` at minicpm3-4b's widths (d
               2560, 40 heads of 64, latent rank 256) and
               ``ssm.mamba_apply`` at hymba-1.5b's (d 1600, 25 heads of
               64, state 16), B 4 x S 2048: the training path's output and
               gradients (x and every weight) and the served path's
               output (MLA: the flash kernel) against f64 oracles written
               here (RoPE, a causal softmax, the recurrence one step at a
               time), row by row within 2^-6, and times; the chunked
               recurrence at hymba's head shape (B 4, S 2048, 25 heads, dk
               16, dv 64), without and with the normalizer, from a carried
               state, against the stepwise recurrence in f64 (output and
               final state within 2e-3 of the largest value).  17b / 17c:
               minicpm3-4b (4.358 B parameters) and hymba-1.5b (1.433 B)
               at full width and depth served as phase 8 serves qwen (4 x
               2048 prompts, 32 decode steps; hymba's prefill wraps its
               1024-slot ring): the flash kernel on each layer's own q, k,
               v against its plain version (row by row within 2^-6), the
               prefill logits against the plain attention (within 5e-2),
               the flash kernel exactly once a layer and nothing else,
               cold and warm prefill, decode p50 / max, the replayed picks
               = the served tokens, a traced prefill and decode step (the
               attention, mamba and recurrence scopes); then a 2-layer f32
               cut at full width: flash against plain, and 8 tokens
               decoded after the prefill (minicpm3 2 x 512, hymba 2 x 1536
               past its ring) against the forward, within 1e-3.  17d: 6
               AdamW steps of each under ``remat="dots"`` on one fixed
               batch (hymba 4 x 2048, minicpm3 2 x 2048: 4 rows do not
               fit the card): losses fall, no kernel launch, p50 / max,
               peak memory, a traced step.
 18. the xLSTM stack (xlstm-1.3b), bf16, weights from seeds (``phase_18``).
               18a: ``ssm.mlstm_apply`` and ``ssm.slstm_apply`` at published
               widths (d 2048, 4 heads of 512), B 4 x S 2048, output and
               gradients against f64 oracles written here (the mLSTM in
               its parallel form, the sLSTM one step at a time): f32
               within 1e-4; bf16 within 2^-6 against the oracle rounding
               to bf16 where the model rounds (the unrounded oracle's
               errors printed: the normalizer's ``max(|n|, 1)`` flips
               under bf16 q / k), row by row, the gate weights head by
               head; the normalized chunked recurrence at the mLSTM's
               head shape against the stepwise one in f64 (2e-3 of the
               largest value).  18b: served at full width and depth as
               phase 8 serves qwen (no kernel launches: attention-free),
               replayed picks, the sLSTM's host cost from profiles of a 4 x
               256 prefill, one sLSTM layer over it and a decode step; an
               8-layer f32 cut decoding 8 tokens against its forward
               within 1e-3.  18c: 6 AdamW steps at full width and depth on
               one fixed 4 x 2048 batch (no step traced).
 19. the encoder-decoder and the vision stub, bf16 (``phase_19``).  19a: the
               flash kernel at whisper-medium's shapes (the encoder's
               non-causal 1500 frames, the decoder's causal 416, the
               cross-attention's 416 and 1 queries over 1500 frames) and
               qwen2-vl-72b's prefill, against its plain version row by
               row within 2^-6, on ``flash_attention_wgmma_kernel``,
               timed beside SDPA.  19b: whisper-medium at full width and
               depth on seeded unit-normal frames (never zeros), 4 x 416
               tokens and 32 decode steps (72 flash launches a prefill, 48
               a decode step, which runs the encoder again), the kernel on
               each call's own q, k, v, the cross-attention's output norms
               (non-zero), the decode step split into the encoder and the
               rest, replayed picks, a traced decode step; a 2 + 2 layer
               f32 cut (flash vs plain, 8 decoded tokens vs the forward,
               1e-3).  19c: 6 AdamW steps at 4 x 448 over seeded frames.
               19d: qwen2-vl-72b at full width, 24 of 80 layers (the 72.8 B
               model does not fit one card), 4 x 2048 seeded embeddings,
               32 decode steps on tokens (24 flash launches), peak memory
               under 75 GiB; its 2-layer f32 cut.  19e: a 2-layer cut
               trained 6 steps on the ``"embeds"`` data kind at 2 x 2048.
 20. the LM over meshes whose entries all name the one card
               (``phase_20``).  20a: granite-moe-3b at full width and
               depth on a (2, 2) mesh, a 4 x 2048 prefill (the flash
               kernel on each member's 12 q / 4 kv heads, held on each
               call's own q, k, v: 128 launches) and 8 decode steps; f32
               held to the unsharded model on the mesh run's routing
               (``replay_picks``) within 1e-3, bf16 printed with its top-k
               agreement and timed against the unsharded model in turns.
               20b: qwen2.5-3b at full width on (1, 4) (2 kv heads over 4
               members: ``wk`` / ``wv`` gathered, the cache replicated and
               equal on every member), bf16 and f32: flash 144 launches a
               prefill, logits row by row against the unsharded model (f32
               1e-3; bf16 2.5e-2, the members' products round at other
               shapes, with a witness: the mesh run no farther than 1.5 x
               the unsharded run from an f32 run of the same weights).
               20c: stablelm-1.6b at full width, 8 of 24 layers, 2 ZeRO-1
               AdamW steps in f32 at 4 x 1024 on (2, 2) against the
               unsharded trainer (losses and grad norms 1e-4 relative,
               each parameter's change 1e-2 as a normwise relative gap),
               peak memory and collective bytes printed.
 21. the dry run against the card (``phase_21``).  qwen2.5-3b at full
               width, 4 of 36 layers, bf16, on a 1 x 1 mesh of the card: a
               4 x 2048 prefill and one AdamW training step, each counted
               first on a ``meta`` copy (``launch.dryrun``): the counted
               argument bytes must equal the step's inputs on the card,
               the counted peak over them must lie within 0.8-1.25 x the
               rise of ``max_memory_allocated`` over the step, and the
               step's median of 5 timed runs (CUDA events) must not beat
               its compute term (counted FLOPs / 989 TFLOP/s); the memory
               term, the time over it and the step's share of the bf16
               peak (the model's FLOPs) are printed beside the card's
               name and power limit.  Then ``python -m
               repro_torch.launch.dryrun --arch hymba-1.5b --shape
               long_500k`` (the reference test's cell on the single-pod
               mesh: 256 members; its seconds, memory and roofline line)
               and
               ``python -m repro_torch.roofline.report`` of its JSON.
 22. the split block patterns on meshes of the card (``phase_22``), at
               full width and a few layers, f32: minicpm3-4b (MLA, 4
               layers) on (1, 4), hymba-1.5b (4 layers) on (1, 5) (its 25
               heads split) and (1, 4) (they do not), xlstm-1.3b (one
               group) on (1, 4), whisper-medium (4 + 4 layers) on (2, 2),
               and the sparse-band stablelm-1.6b (2 layers) on (1, 4): a 4
               x 256 prefill and 4 decode steps (the band model a forward)
               against the unsharded model (1e-3); the flash kernel on each
               member's own q, k, v and the GeMM-SpMM / ``spmm_ell`` on
               each member's band columns against their plain versions
               (1e-4; a bf16 prefill holds flash at 2^-6 row by row); each
               member's launches equal to the unsharded run's (the band's
               scaled by the member's rows); each prefill's collective
               bytes equal to ``launch.dryrun._count``'s on a ``meta``
               mesh; then 2 ZeRO-1 steps of the band model on (2, 2)
               against the unsharded trainer, as 20c.
 23. the paper's prior-work baselines (``phase_23``, Figure 6):
               overlapped tiling (8 partitions, each with its dependencies'
               D1 rows replicated) and atomic tiling (32 tiles in 4 waves,
               a barrier after each) on phase 4's two graphs, f32, 128
               columns, each partition or tile one ``spmm_ell`` call on a
               hybrid ELL packed in the call; held to the same schedule
               on the plain version (1e-4) and to ``tile_fused_matmul``
               (2e-3); wall and CUDA-event times, the host packing time,
               fig 6's ratios, the overlapped redundancy, Figure 1's
               fused compute ratio and the block pattern's nonzeros
               printed.

Each path is driven with the launch counts set to 0 just before it and
read just after: phases 4-5 (the GCN path, gradients included) must
launch the three sparse kernels, ``spmm_ell`` in every request of both
graphs, phase 10's training runs ``spmm_ell`` and GeMM-SpMM, phase 11's
and phase 12's paths (each call counted on its own) add to the three
sparse kernels' launches, phase 13's sharded calls (each
counted on its own) add to them too, as do phase 14's mixer and
training steps (each counted on its own), phase 15's trainer launches
none of the six kernels (its counts must stay 0), phase 7's
entry-point calls the FFN and MoE kernels, phase 8 the flash kernel
exactly once per layer of the prefill, and so do phase 16's MoE
prefills, which never launch the MoE kernel (its training launches
none), and phase 17's MLA and hybrid prefills, which launch nothing else
(their training launches none); phase 18's xLSTM paths launch none of
the six kernels, and phase 19's whisper serve run launches flash 72
times a prefill and 48 times a decode step, qwen2-vl's 24 times a
prefill, and nothing else (their training launches none); phase 20's
mesh prefills launch flash once a layer on each member (granite 128,
qwen2.5-3b 144), its ZeRO-1 training none; phase 21's prefill launches
flash once a layer, its training step none; phase 22's members each
launch what the unsharded model launches; phase 23's baselines launch
``spmm_ell`` once a partition or tile (8 and 32) and nothing else.
Launches made to
compare a kernel with its plain version, or to time it, are not counted.
The last three lines are the card's ``nvidia-smi`` name and power limit,
the kernels' JSON record (with each kernel's tensor-core instruction count
from phase 2, the device function its record case ran (the FFN kernels'
in each dtype) and the LM kernels' f32 case beside the bf16 record) and
the result line.  float32 matrix products run
in true f32 (TF32 off).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_NODES = 131_072          # OGB scale (ogbn-arxiv has 169,343 nodes)
REQUESTS = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# f32: 495 TFLOP/s of TF32 over the three products of an f32-accurate
# 3xTF32 product (the card's fastest f32-accurate rate); bf16 tensor cores
PEAK_OPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_F32_CUDA_CORES = 67e12   # f32 outside the tensor cores (printed only)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}           # kernel vs plain, rel
# the LM kernels in bf16, each output row against its own largest value:
# flash attention two bf16 units in the last place (P is rounded to bf16
# before the PV product, as in the Pallas kernel, and the output once more);
# the FFN / MoE kernels one rounding of the output plus the bf16 rounding of
# H summed over f (tests/test_torch_lm_kernels.py grounds it)
LM_BF16_TOL = 2.0 ** -6
MAIN_TOL = 2e-3                                      # path vs references
# phase 3: the sleep kernel that the queued timings wait behind (about 10
# ms at the H100's clock), longer than the host takes to queue 20 calls
SLEEP_CYCLES = 20_000_000

# phase 7: (name, kernel, shape and options) at published widths
LM_CASES = [
    ("flash_attention (qwen2.5-3b prefill)", "flash_attention",
     dict(b=4, h=16, hkv=2, sq=2048, sk=2048, d=128, causal=True,
          window=0)),
    ("flash_attention (hymba-1.5b, window 1024)", "flash_attention",
     dict(b=1, h=25, hkv=5, sq=4096, sk=4096, d=64, causal=True,
          window=1024)),
    ("flash_attention (whisper-medium encoder)", "flash_attention",
     dict(b=4, h=16, hkv=16, sq=1500, sk=1500, d=64, causal=False,
          window=0)),
    # the MoE decoders' prefills (phase 16): granite-moe-3b's bf16 wgmma
    # D64 path and llama4-scout's D128 path under its 8192 window
    ("flash_attention (granite-moe-3b prefill)", "flash_attention",
     dict(b=4, h=24, hkv=8, sq=2048, sk=2048, d=64, causal=True,
          window=0)),
    ("flash_attention (llama4-scout prefill, window 8192)",
     "flash_attention",
     dict(b=4, h=40, hkv=8, sq=2048, sk=2048, d=128, causal=True,
          window=8192)),
    # minicpm3-4b's MLA prefill (phase 17): 40 query heads over 40
    # expanded K/V heads of 64 (rep 1), the bf16 wgmma D64 path
    ("flash_attention (minicpm3-4b prefill)", "flash_attention",
     dict(b=4, h=40, hkv=40, sq=2048, sk=2048, d=64, causal=True,
          window=0)),
    ("fused_ffn (stablelm-1.6b widths)", "fused_ffn",
     dict(e=0, m=8192, d=2048, f=5632, act="gelu")),
    # a 4096-token row, top-8 of 40 experts, capacity factor 1.25
    # (repro.models.layers.moe_apply): cap = 1.25 * 4096 * 8 / 40 = 1024
    ("fused_moe_ffn (granite-moe-3b experts)", "fused_moe_ffn",
     dict(e=40, m=1024, d=1536, f=512, act="silu")),
    # configs/minitron_8b.py FFN widths, 4096 tokens: d > 2048 takes two
    # cluster groups (X W1 computed twice); bf16 only
    ("fused_ffn (minitron-8b widths)", "fused_ffn",
     dict(e=0, m=4096, d=4096, f=16384, act="gelu", bf16_only=True)),
]
# the case whose numbers stand for each LM kernel in the JSON record
LM_RECORD = {"flash_attention": "flash_attention (qwen2.5-3b prefill)",
             "fused_ffn": "fused_ffn (stablelm-1.6b widths)",
             "fused_moe_ffn": "fused_moe_ffn (granite-moe-3b experts)"}
# the flash cases at the MoE prefills' shapes, also in the JSON record
LM_MOE_FLASH = ("flash_attention (granite-moe-3b prefill)",
                "flash_attention (llama4-scout prefill, window 8192)")
# the flash case at minicpm3-4b's prefill shape, also in the JSON record
LM_MLA_FLASH = "flash_attention (minicpm3-4b prefill)"
# phase 8: qwen2.5-3b at full width; 4 prompts of 2048 tokens, 32 decode
# steps after the prefill
LM_ARCH = "qwen2.5-3b"
LM_REDUCED = False
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 32
LM_TOL = 5e-2   # bf16 logits, served path vs plain attention, rel
LM_REPLAY = 4   # decode steps replayed against a full forward
# phase 10: SGD on the GCN
TRAIN_STEPS, TRAIN_LR = 10, 0.3
# phase 11: the seed of the banded graph's shuffle, and the typed graph
# shaped like ogbn-mag (OGB, Hu et al. 2020; node and edge counts of its
# four relations) cut to 1/MAG_CUT of its node and edge counts, so the
# average degrees are kept; every relation also runs reversed (8
# relations, as the RGCN of Schlichtkrull et al. 2018 runs them)
SHUFFLE_SEED = 11
MAG_CUT = 8
MAG_NODES = {"paper": 736_389, "author": 1_134_649, "institution": 8_740,
             "field_of_study": 59_965}
MAG_EDGES = {("author", "writes", "paper"): 7_145_660,
             ("paper", "cites", "paper"): 5_416_271,
             ("paper", "has_topic", "field_of_study"): 7_505_078,
             ("author", "affiliated_with", "institution"): 1_043_998}
MAG_WIDTH = 128            # input width of every node type, and the output
# the SpMM-SpMM stack: power-law relations of HETERO_NODES nodes each
HETERO_RELATIONS, HETERO_NODES = 16, 8_192
# phase 12: the serving tier.  Windows of banded_spd(SERVE_BASE_NODES, 8)
# (induced subgraphs of one base graph, as a neighbour sampler relabels its
# node set), each padded into the 32,768-row bucket; 128 columns, f32
SERVE_BASE_NODES = 262_144
SERVE_WINDOWS = ((0, 30_000), (32_768, 31_000), (98_304, 29_000))
SERVE_COLS = 128
SERVE_REQUESTS = {"gemm": 64, "spmm": 16}
SERVE_CHECK_EVERY = 8      # requests between f64 host products
# Algorithm 1's budget of the GeMM-SpMM tier (elements): the 64-row tiles
# that the uniform split stops at cost 1.17 M elements on these windows at
# 128 / 128 columns, over the default 600,000, and incremental_update bails
# on any patched tile over the budget, so at the default every patch would
# be a rebuild; twice the default fits those tiles and gives the same t
SERVE_GEMM_CACHE = 1.2e6
# 12c: the reference CLI's power-law stream, and the front end on the
# banded windows, 4 requests stacked a dispatch
SERVE_CLI_REQUESTS, SERVE_CLI_NODES, SERVE_BATCH = 64, 32_768, 4
SERVE_FE_REQUESTS = 16
# phase 14: LM training.  stablelm-1.6b at its published widths with the
# sparse-band block (the reference's own use of the pattern,
# tests/test_sparse_layers.py), 6 AdamW steps on one fixed batch of 4 x
# 2048 tokens; the band mixer's kernels also run alone at its shapes, and
# a 2-layer f32 cut of the same widths holds impl="cuda" to impl="torch"
BAND_ARCH = "stablelm-1.6b"
BAND_REDUCED = False
BAND_BATCH, BAND_SEQ = 4, 2048
BAND_STEPS = 6
BAND_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=20)
BAND_CUT_LAYERS = 2
# remat recomputes the same ops on the same inputs: its gradients within
# 1e-6 of remat="none"'s (per tensor, relative to its largest value)
REMAT_TOL = 1e-6
# phase 15: dense LM training at full width.  stablelm-1.6b's CONFIG as
# published (24 layers, d 2048, 32 heads of 64, d_ff 5632, vocab 100,352,
# bf16, remat "dots") through launch.train.main, 16 steps of 4 x 2048
# tokens from seed 0; the training attention alone at the step's shape
# (against an f64 oracle on the cut ATTN_CUT = (B, H) and the flash kernel
# in full); preemption and resume at --reduced
DENSE_ARCH = "stablelm-1.6b"
DENSE_REDUCED = False
DENSE_STEPS, DENSE_BATCH, DENSE_SEQ = 16, 4, 2048
ATTN_CUT = (1, 2)
# the cut against the f64 oracle, relative to each tensor's largest value:
# f32 within MAIN_TOL; bf16 within 2^-7, since the output and each gradient
# are rounded to bf16 once (half a unit in the last place, up to 2^-8 of a
# value) beside f32 arithmetic
ATTN_ORACLE_TOL = {"float32": MAIN_TOL, "bfloat16": 2.0 ** -7}
# the step's device memory reckoned for remat="dots" (ROADMAP Queue 1):
# parameters, gradients and AdamW moments ~19.7 GB, the kept products ~9.3
# GB, the f32 logits and their gradient ~8 GB, one block's recompute ~9 GB
DENSE_RECKONED_GB = 46
RESUME_ARGS = ["--arch", "qwen2.5-3b", "--reduced", "--steps", "8",
               "--batch", "2", "--seq", "64", "--ckpt-every", "3",
               "--log-every", "100"]
# phase 16: the gated MoE layer and the two MoE decoders.  16a: the layer
# alone at published widths, (arch, B, S), held row by row to an f64
# oracle on the run's own routing at two bf16 units in the last place,
# the output and (where the last field is True) the gradients.  S 1 is a
# served decode step's shape (cap 8), which runs no backward; there a row
# of dW2 is one slot's h[f] times its dy, and silu's relative condition
# |1 + a·(1 - sigmoid(a))|, about |a| in the negative tail (a's spread
# is sqrt(d / e) ≈ 6.2 at granite's widths under the experts' 1/sqrt(e)
# init), carries the bf16 rounding of a into the row whole: 5.5e-2 on
# the card
MOE_LAYER_CASES = (("granite-moe-3b-a800m", 4, 2048, True),
                   ("llama4-scout-17b-a16e", 2, 2048, True),
                   ("granite-moe-3b-a800m", 4, 1, False),
                   ("llama4-scout-17b-a16e", 4, 1, False))
MOE_ORACLE_TOL = 2.0 ** -6
MOE_REDUCED = False
# 16b-16e: granite-moe-3b at full width and depth, served as phase 8 serves
# qwen (4 prompts of 2048 tokens, 32 decode steps) and trained as 14c
# trains (6 AdamW steps, one fixed batch); llama4-scout at full width,
# depth cut to 8 of 48 layers (107.8 B parameters do not fit one 80 GB
# card; 8 layers are 19.7 B, 39.4 GB in bf16), 16 decode steps
MOE_ARCH, MOE_WIDE_ARCH, MOE_WIDE_LAYERS = ("granite-moe-3b-a800m",
                                            "llama4-scout-17b-a16e", 8)
MOE_BATCH, MOE_PROMPT, MOE_DECODE, MOE_WIDE_DECODE = 4, 2048, 32, 16
MOE_REPLAY = 4
# the f32 cut: 2 layers at full width, 2 x 512 tokens, flash against plain
# attention within 1e-3 (in f32 the router logits differ by about 1e-6),
# and 8 tokens decoded one at a time against its forward
MOE_CUT_LAYERS, MOE_CUT_BATCH, MOE_CUT_SEQ, MOE_CUT_TOL = 2, 2, 512, 1e-3
MOE_TRAIN_STEPS = 6
MOE_TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=20)
# parameters, gradients and f32 moments ~40.5 GB, activations and the
# remat recompute ~10 GB
MOE_RECKONED_GB = 50.5
# phase 16's trace scopes: the function of models.layers each wraps and
# the scope's name (a trace reads each scope's device time from its host
# event, and leaves the GPU-side annotation ranges out of the busy time)
SCOPES = {"_row_dispatch": "moe.dispatch", "_expert_ffn": "moe.experts",
          "_row_combine": "moe.combine", "chunked_attention": "attention",
          "decode_attention": "attention", "scan_attention": "attention",
          "mamba_apply": "mamba",
          "chunked_linear_recurrence": "recurrence",
          "linear_recurrence_step": "recurrence"}
# phase 17: multi-head latent attention (minicpm3-4b) and the attention +
# mamba hybrid (hymba-1.5b), bf16, weights from seeds.  17a: each layer
# alone at its model's published widths, B 4 x S 2048, output and
# gradients held row by row to an f64 oracle at two bf16 units in the last
# place; the chunked recurrence at hymba's head shape held to the stepwise
# recurrence in f64 at the parity bar, relative to the largest value
P17_MLA, P17_HYBRID = "minicpm3-4b", "hymba-1.5b"
P17_REDUCED = False
P17_LAYER_BATCH, P17_LAYER_SEQ = 4, 2048
P17_ORACLE_TOL = 2.0 ** -6
P17_RECURRENCE = dict(b=4, s=2048, h=25, dk=16, dv=64)
# 17b / 17c: each model at full width and depth served as phase 8 serves
# qwen (4 prompts of 2048 tokens, 32 decode steps); the f32 cuts: 2 layers
# at full width, (B, S) tokens, flash against the plain attention and 8
# tokens decoded after them against the forward, within 1e-3 (hymba's 1536
# tokens overfill its 1024-slot ring, so its decode reads a wrapped ring)
P17_BATCH, P17_PROMPT, P17_DECODE, P17_REPLAY = 4, 2048, 32, 4
# whether the bf16 prefill logits are held to the plain attention's at
# LM_TOL; both models' f32 logits are, at P17_CUT_TOL, through every layer.
# hymba-1.5b's bf16 logits are printed only: its blocks grow the
# difference between the two attentions 50-80 times over its 32 layers,
# in f32 (4.3e-7 after block 1, 3.4e-5 after block 32) as in bf16 (4.4e-3,
# 0.23), where minicpm3-4b's 62 grow it 2-6 times (PERF.md section 6):
# one bf16 unit a layer then reaches 0.24 at hymba's logits
P17_BF16_HELD = {P17_MLA: True, P17_HYBRID: False}
P17_CUT_LAYERS, P17_CUT_TOL, P17_CUT_DECODE = 2, 1e-3, 8
P17_CUT_SHAPE = {P17_MLA: (2, 512), P17_HYBRID: (2, 1536)}
# 17d: 6 AdamW steps of each model on one fixed batch of 2048-token rows
# under the config's remat="dots".  minicpm3-4b's batch is cut to 2 rows:
# its parameters, gradients and f32 moments are 52.3 GB, the kept products
# 0.42 GB a layer at 8,192 tokens (26 GB over 62 layers), so 4 rows pass
# the card's 80 GB; 2 rows are reckoned at ~72 GB.  hymba-1.5b: 17.2 GB
# of state, ~11.6 GB of kept products, one block's recompute ~7 GB
P17_TRAIN_STEPS = 6
P17_TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=20)
P17_TRAIN_BATCH = {P17_MLA: 2, P17_HYBRID: 4}
P17_RECKONED_GB = {P17_MLA: 72, P17_HYBRID: 37}
# phase 18: the xLSTM stack (xlstm-1.3b), bf16, weights from seeds.  18a:
# the mLSTM and sLSTM blocks alone at published widths (d 2048, 4 heads
# of 512), B 4 x S 2048, output and gradients against f64 oracles (f32
# within 1e-4, bf16 within two bf16 units, row by row); the normalized
# chunked recurrence at the mLSTM's head shape against the stepwise one
# in f64 at the parity bar
P18_ARCH = "xlstm-1.3b"
P18_REDUCED = False
P18_LAYER_BATCH, P18_LAYER_SEQ = 4, 2048
P18_ORACLE_TOL = 2.0 ** -6
# the mLSTM's gate weights (inner, heads), whose gradients are held head by
# head (their rows of 4 values hold no scale: one of 2048 rows of dw_i
# peaked at 6.5 where the median row peaks at 70, and read 2.8e-2 against
# a whole-tensor error of 2.9e-3, B 2 x S 1024 on the CPU)
P18_GATES = ("w_f", "w_i")
P18_RECURRENCE = dict(b=4, s=2048, h=4, dk=512, dv=512)
# 18b: served at full width and depth as phase 8 serves qwen (no kernel
# may launch: the stack is attention-free); the sLSTM's host cost read
# from a profile of a short prefill (4 x 256), never of a whole training
# step (~5 x 10^5 launches); an 8-layer (one group) f32 cut decodes 8
# tokens against its forward within 1e-3
P18_BATCH, P18_PROMPT, P18_DECODE, P18_REPLAY = 4, 2048, 32, 4
P18_PROFILE_SHAPE = (4, 256)
P18_CUT_LAYERS, P18_CUT_SHAPE, P18_CUT_DECODE = 8, (2, 512), 8
P18_CUT_TOL = 1e-3
# 18c: 6 AdamW steps at full width and depth on one fixed 4 x 2048 batch
# under remat="dots" (the mLSTM blocks; the sLSTM runs outside it).
# Reckoned: 1.49 B parameters, 17.9 GB of state; ~8 GB of kept mLSTM
# products; the sLSTM's graph ~1.6 GB a layer (6); one mLSTM block's
# recompute ~4 GB
P18_TRAIN_STEPS = 6
P18_TRAIN_SHAPE = (4, 2048)
P18_TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=20)
P18_RECKONED_GB = 36
# phase 19: the encoder-decoder (whisper-medium) and the vision stub
# (qwen2-vl-72b), bf16.  19a: the flash kernel at every shape these paths
# give it (bf16, the wgmma path), against its plain version row by row
# within 2^-6, timed beside SDPA: (label, b, h, hkv, sq, sk, d, causal)
P19_FLASH_CASES = (
    ("whisper encoder self-attention", 4, 16, 16, 1500, 1500, 64, False),
    ("whisper decoder self-attention", 4, 16, 16, 416, 416, 64, True),
    ("whisper cross-attention, prefill", 4, 16, 16, 416, 1500, 64, False),
    ("whisper cross-attention, decode step", 4, 16, 16, 1, 1500, 64,
     False),
    ("qwen2-vl-72b prefill", 4, 64, 8, 2048, 2048, 128, True),
)
# 19b: whisper-medium at full width and depth: seeded unit-normal frames
# (never zeros: an encoder on zeros gives zeros, and the cross-attention
# then adds nothing), 4 x 416 tokens, 32 decode steps (448 positions, the
# decoder's published context); flash 72 launches a prefill (24 encoder,
# 24 self, 24 cross) and 48 a decode step (24 encoder, 24 cross); a 2 + 2
# layer f32 cut.  19c: 6 AdamW steps at 4 x 448 with seeded frames
P19_WHISPER, P19_VL = "whisper-medium", "qwen2-vl-72b"
P19_REDUCED = False
P19_BATCH, P19_PROMPT, P19_DECODE, P19_REPLAY = 4, 416, 32, 4
P19_CUT_LAYERS, P19_CUT_SHAPE, P19_CUT_DECODE = 2, (2, 256), 8
P19_CUT_TOL = 1e-3
P19_TRAIN_STEPS = 6
P19_TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=20)
P19_TRAIN_SEQ = 448
# 19d: qwen2-vl-72b at full width, 24 of 80 layers: 0.878 B parameters a
# layer (1.76 GB in bf16) and 5.1 GB for the embedding, the head and
# frontend_proj, so the 80 layers (~145 GB) do not fit one 80 GB card and
# 24 are ~47 GB; 4 x 2048 seeded embeddings, then 32 decode steps on
# tokens; flash 24 launches a prefill.  19e: a 2-layer cut at full width
# trained 6 steps on the "embeds" data kind at 2 x 2048: ~52 GB of
# parameters, gradients and f32 moments
P19_VL_LAYERS, P19_VL_PROMPT = 24, 2048
P19_PEAK_GIB = 75
P19_VL_TRAIN_LAYERS, P19_VL_TRAIN_SHAPE = 2, (2, 2048)
P19_RECKONED_GB = {P19_WHISPER: 14, P19_VL: 60}
# phase 20: the LM over meshes whose entries all name the one card.  20a:
# granite-moe-3b at full width and depth on (2, 2): a 4 x 2048 prefill
# (flash on each member's 12 q / 4 kv heads: 32 layers x 4 members) and 8
# decode steps, f32 held to the unsharded model on the mesh run's routing,
# bf16 printed with its top-k agreement; 20b: qwen2.5-3b at full width on
# (1, 4) in bf16 (2 kv heads on 4 members: half a head a slice); 20c:
# stablelm-1.6b at full width, 8 of 24 layers, on (2, 2): 2 ZeRO-1 AdamW
# steps in f32 at 4 x 1024 against the unsharded trainer
P20_REDUCED = False
P20_MOE, P20_QWEN, P20_TRAIN = ("granite-moe-3b-a800m", "qwen2.5-3b",
                                "stablelm-1.6b")
P20_BATCH, P20_PROMPT, P20_DECODE = 4, 2048, 8
P20_TOL = 1e-3               # f32 mesh vs unsharded, relative
P20_TRAIN_LAYERS, P20_TRAIN_SHAPE, P20_TRAIN_STEPS = 8, (4, 1024), 2
P20_TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=20)
P20_LOSS_TOL = 1e-4          # relative, losses and grad norms
# 20b's bf16 logits, mesh vs unsharded, row rel: 1.5e-2 to 1.8e-2 read on
# the H100 before this bar was set; the witness holds the mesh run's
# distance from an f32 run of the same bf16 weights to at most
# P20_WITNESS_RATIO times the unsharded bf16 run's
P20_BF16_TOL, P20_WITNESS_RATIO = 2.5e-2, 1.5
# 20c: the normwise relative gap of each leaf's change over the steps,
# mesh vs unsharded.  An update left undone reads 1; sound runs on the CPU
# read 8.4e-5 (one step, the distribution tests) and 3.9e-4 (this phase's
# two steps at 2 layers and 4 x 16): AdamW moves every element by about
# lr whatever its gradient's size, so elements whose gradients nearly
# cancel carry the summation order's differences into the update
P20_UPDATE_TOL = 1e-2
# phase 21: the dry run against the card.  qwen2.5-3b at full width, 4 of
# its 36 layers, bf16, on a 1 x 1 mesh of the card: a 4 x 2048 prefill and
# one training step, each counted on a meta copy first; then the
# reference test's production cell through the CLI on the single-pod mesh
# (256 members: its multi-pod twin's 512 took 93-114 s of the run's limit)
P21_REDUCED = False
P21_ARCH, P21_LAYERS = "qwen2.5-3b", 4
P21_BATCH, P21_SEQ, P21_RUNS = 4, 2048, 5
P21_PEAK_RATIO = (0.8, 1.25)     # dry-run peak rise over the card's
P21_CLI = ["--arch", "hymba-1.5b", "--shape", "long_500k"]
P21_CLI_MEMBERS = 256
P21_CLI_TIMEOUT_S = 400
# phase 22: the block patterns other than the plain attn decoder split over
# meshes whose entries all name the one card, at full width and a few
# layers: (model, config replacements, mesh).  hymba's 25 heads split on
# (1, 5) and do not on (1, 4); xlstm-1.3b's 4 heads split on (1, 4)
P22_REDUCED = False
P22_CELLS = (
    ("minicpm3-4b", {"n_layers": 4}, (1, 4)),
    ("hymba-1.5b", {"n_layers": 4}, (1, 5)),
    ("hymba-1.5b", {"n_layers": 4}, (1, 4)),
    ("xlstm-1.3b", {"n_layers": 8}, (1, 4)),
    ("whisper-medium", {"n_layers": 4, "encoder_layers": 4}, (2, 2)),
    ("stablelm-1.6b", {"n_layers": 2, "block_pattern": "sparse-band"},
     (1, 4)),
)
# a prompt short enough that the per-call rule splits every prefill
P22_BATCH, P22_PROMPT, P22_DECODE = 4, 256, 4
P22_TRAIN_MESH, P22_TRAIN_SHAPE, P22_TRAIN_STEPS = (2, 2), (4, 256), 2
# phase 23: the paper's prior-work baselines (fig 6) on phase 4's graphs
P23_NODES = N_NODES
P23_COLS = 128             # b_col = c_col
P23_P, P23_WAVES = 8, 4
P23_LAUNCHES = {"overlapped": P23_P, "atomic": P23_P * P23_WAVES}
P23_TIMED = 3              # calls timed a path (medians)
P23_BLOCK, P23_CT = 128, 2048
GCN_KERNELS = ("spmm_ell", "tile_fused_gemm_spmm_wf0",
               "tile_fused_spmm_spmm_wf0")
# phase 2: the functions of each kernel in the library's SASS (a part of the
# mangled name); the FFN and MoE launchers share one kernel
KERNEL_FUNCTIONS = {"spmm_ell": "spmm_hybrid", "tile_fused_gemm_spmm_wf0":
                    "gemm_spmm", "tile_fused_spmm_spmm_wf0": "spmm_spmm",
                    "flash_attention": "flash_attention",
                    "fused_ffn": "fused_ffn", "fused_moe_ffn": "fused_ffn"}
TC_OPCODES = ("HGMMA", "HMMA")   # wgmma and mma.sync in SASS
FLOAT_ATOMIC_TYPES = ("F32", "F16", "BF16")
# the bf16 flash kernel on wgmma (head dim 64 or 128, aligned rows)
FLASH_WGMMA = "flash_attention_wgmma_kernel"
# the FFN / MoE-FFN device function each dtype must take at published
# widths: bf16 on wgmma, f32 as 3xTF32 on wgmma
FFN_PATHS = {"bfloat16": "fused_ffn_wgmma_kernel",
             "float32": "fused_ffn_tf32_kernel"}
# the phase-3 case whose numbers stand for spmm_ell in the JSON record: the
# power-law GCN's layer-1 hybrid product, body and tails (f32)
SPMM_RECORD = "spmm_ell (power-law hybrid, 128 columns)"
# the GeMM-SpMM kernel on wgmma (GCN layers 1 and 2 must run it), and its
# twin for B rows over 512 bytes (the sparse-band mixer, the hetero stack)
GEMM_WGMMA = "tile_fused_gemm_spmm_wf0_wgmma_kernel"
GEMM_WIDE = "tile_fused_gemm_spmm_wf0_wgmma_wide_kernel"
# the CUDA-core GeMM-SpMM's times at the shapes the wide kernel took over
# (PERF.md section 6: PR 21's final run at the band, PR 18's at the
# ogbn-mag-shaped stack; NVIDIA H100 80GB HBM3, 700 W), cited, not re-run
CORE_MS_BEFORE = {"band forward": 9.3003, "band dB": 9.2288,
                  "mag-shaped stack": 70.78}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_scan(library: Path) -> tuple:
    """``({function: HGMMA / HMMA instructions}, {function: float atomics})``
    over every function in ``cuobjdump -sass`` of the kernel library; a
    float atomic is a ``RED`` or ``ATOM*`` instruction on F32, F16 or
    BF16."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(library)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts, atomics, name = {}, {}, None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            name = line[len("Function : "):]
            counts[name] = atomics[name] = 0
        elif name is not None:
            if any(f" {op}." in line or f" {op} " in line
                   for op in TC_OPCODES):
                counts[name] += 1
            words = line.split("*/", 1)[-1].split()
            words = [w for w in words if not w.startswith("@")]
            op = words[0] if words else ""
            if (op.startswith(("RED", "ATOM"))
                    and any(t in op for t in FLOAT_ATOMIC_TYPES)):
                atomics[name] += 1
    return counts, atomics


def ptxas_report(log: str) -> dict:
    """{function: (registers, spill store bytes, spill load bytes)} from
    ``-Xptxas -v`` in the build log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def every_other_row(a):
    """``a`` with its even rows emptied (the parity matrix's empty-rows
    cell at size): ``Aᵀ != A``, and row and column degrees differ."""
    import numpy as np
    lens = np.diff(a.indptr)
    keep = np.arange(a.n_rows) % 2 == 1
    flat = np.repeat(keep, lens)
    indptr = np.concatenate([[0], np.cumsum(np.where(keep, lens, 0))])
    return type(a)(a.n_rows, a.n_cols, indptr.astype(a.indptr.dtype),
                   a.indices[flat], a.data[flat])


def mag_relation(rng, n_src: int, n_dst: int, n_edges: int):
    """``n_edges`` distinct ``(dst, src)`` edges as an ``(n_dst, n_src)``
    CSR of ones: sources drawn with Pareto(2) weights (heavy-tailed
    out-degrees), destinations uniform."""
    import numpy as np
    from repro_torch.core.sparse.formats import CSR
    w = rng.pareto(2.0, n_src) + 1.0
    p = w / w.sum()
    keys = np.zeros(0, np.int64)
    while keys.size < n_edges:
        m = int(1.25 * (n_edges - keys.size)) + 16
        src = rng.choice(n_src, m, p=p)
        dst = rng.integers(0, n_dst, m)
        keys = np.union1d(keys, dst.astype(np.int64) * n_src + src)
    keys = np.sort(rng.choice(keys, n_edges, replace=False))
    return CSR.from_coo(n_dst, n_src, keys // n_src, keys % n_src,
                        np.ones(n_edges, np.float32))


def mag_graph(seed: int = 0):
    """The typed graph shaped like ogbn-mag at 1/MAG_CUT of its node and
    edge counts: the four relations and their reverses."""
    import numpy as np
    from repro_torch.models.hetero_gcn import HeteroGraph
    rng = np.random.default_rng(seed)
    nodes = {t: int(n / MAG_CUT + 0.5) for t, n in MAG_NODES.items()}
    relations = {}
    for (src, name, dst), n in MAG_EDGES.items():
        a = mag_relation(rng, nodes[src], nodes[dst], int(n / MAG_CUT + 0.5))
        relations[(src, name, dst)] = a
        relations[(dst, "rev_" + name, src)] = a.transpose()
    return HeteroGraph(nodes, relations)


def time_ms(fn, iters=20):
    """ms a call: CUDA events around ``iters`` calls after 3 warm-ups."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want, rows=False):
    """(max abs error, relative error): relative to the largest |want|,
    or with ``rows`` the largest over rows of each row's error relative
    to that row's own largest |want| (a row is the last axis)."""
    import torch
    got, want = got.detach().float(), want.detach().float()
    if not torch.isfinite(got).all():
        fail("non-finite values in a result")
    diff = (got - want).abs()
    err = float(diff.max())
    if rows:
        return err, float((diff.amax(-1) / want.abs().amax(-1)
                           .clamp_min(1e-30)).max())
    return err, err / max(float(want.abs().max()), 1e-30)


def trace(tag, label, fn, warm=None, top=8, ops_device=None):
    """One call of ``fn`` under the profiler, after a traced warm-up
    call (of ``warm``, else of ``fn``: a session can drop its first
    ctypes launch): device time by kernel (the ``top`` largest) and the
    device's busy share of the call's wall time.  Returns ``(busy us,
    wall us, {op or kernel: calls}, {kernel: device us})`` of the
    profiled call; ``ops_device`` (a dict) receives each host op's
    device time, the kernels it launched (us)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    t_trace = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        (warm or fn)()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith("ProfilerStep")
              and e.key not in SCOPES.values()]
    busy = sum(e.self_device_time_total for e in events)
    print(f"[{tag} trace] {label}: device busy {busy / 1e3:.3f} ms, "
          f"{busy / wall_us:.3f} of the call's wall "
          f"({wall_us / 1e3:.3f} ms)")
    for e in sorted(events,
                    key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[{tag} trace] {label}:   {e.self_device_time_total:9.1f}"
              f" us  x{e.count:<3d} {e.key[:100]}")
    copies = {e.key: (e.count, e.self_device_time_total)
              for e in averages
              if e.key.startswith(("Memcpy", "Memset"))}
    print(f"[{tag} trace] {label}: memcpy / memset rows "
          f"{copies or 'none'}; the trace took "
          f"{time.perf_counter() - t_trace:.1f} s")
    if ops_device is not None:
        ops_device.update({e.key: e.device_time_total
                           for e in averages
                           if e.device_type == DeviceType.CPU})
    return (busy, wall_us,
            {e.key: e.count for e in averages},
            {e.key: e.self_device_time_total for e in events})


def phases_1_to_15(device: str) -> dict:
    """Phases 1-15; returns what the JSON record and phase 16 need (the
    phases' own tensors are freed when it returns)."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT} is not a checkout of the repository "
             f"(src/repro_torch is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.gcn import CONFIG
    from repro_torch.core.sparse.formats import csr_content_digest
    from repro_torch.core.sparse.random import banded_spd, powerlaw_graph
    from repro_torch.core.tilefusion import api, fused_ops, fused_ref
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_attention import (
        last_path as flash_last_path)
    from repro_torch.kernels.fused_ffn import last_path as ffn_last_path
    from repro_torch.kernels.spmm import last_path as spmm_last_path
    from repro_torch.kernels.tile_fused_gemm_spmm import (
        last_path as gemm_last_path)
    from repro_torch.launch import serve, steps
    from repro_torch.models.gcn import GCN

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    t_start = time.perf_counter()

    # ---- 1. device ----
    smi = nvidia_smi()
    device_kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[1 device] nvidia-smi: {smi}")
    print(f"[1 device] {device_kind}, compute capability {cap[0]}.{cap[1]}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__}"
          f" (CUDA {torch.version.cuda})")
    if cap < (9, 0):
        fail(f"compute capability {cap} < 9.0: the kernels are sm_90a")

    # ---- 2. build ----
    build = _build.build()
    _build.library()
    print(f"[2 build] {build.path.relative_to(ROOT)} in {build.seconds:.1f} s"
          f" (reused: {build.reused})")
    for line in build.log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "smem", "error", "C75")):
            print(f"[2 build] {line.strip()}")
    sass, float_atomics = sass_scan(build.path)
    for fn, (regs, st, ld) in ptxas_report(build.log).items():
        if ("spmm_hybrid" in fn or GEMM_WIDE in fn
                or FFN_PATHS["float32"] in fn):
            print(f"[2 build] ptxas {fn}: {regs} registers, spill stores "
                  f"{st} bytes, spill loads {ld} bytes")
    spmm_atomics = {f: n for f, n in float_atomics.items()
                    if KERNEL_FUNCTIONS["spmm_ell"] in f}
    print(f"[2 build] float atomics in the {len(spmm_atomics)} spmm "
          f"functions' SASS: {sum(spmm_atomics.values())}")
    if not spmm_atomics or any(spmm_atomics.values()):
        fail(f"spmm functions with float atomics (or none found): "
             f"{spmm_atomics}")
    tensor_core_ops = {k: sum(n for f, n in sass.items() if part in f)
                       for k, part in KERNEL_FUNCTIONS.items()}
    for fn, n in sass.items():
        if any(k in fn for k in ("fused_ffn", "flash_attention", "gemm_spmm")):
            print(f"[2 build] SASS {fn}: {n} tensor-core instructions "
                  f"({'/'.join(TC_OPCODES)})")
    print(f"[2 build] tensor-core instructions per kernel: {tensor_core_ops}")
    for label, part in (("FFN", FFN_PATHS["bfloat16"]),
                        ("f32 FFN", FFN_PATHS["float32"]),
                        ("flash", FLASH_WGMMA),
                        ("GeMM-SpMM", GEMM_WGMMA),
                        ("wide GeMM-SpMM", GEMM_WIDE)):
        counts = [n for f, n in sass.items() if part in f]
        if not counts or min(counts) == 0:
            fail(f"the {label} wgmma kernel holds no HGMMA instruction: "
                 f"{counts}")

    # ---- set-up: graphs, models and their inspections (host) ----
    t0 = time.perf_counter()
    banded = banded_spd(N_NODES, 8, seed=0)
    power = powerlaw_graph(N_NODES, 8, seed=0)
    cfg = dataclasses.replace(CONFIG, n_nodes=N_NODES)
    models = {"banded": GCN(cfg, banded, seed=0, device=dev),
              "powerlaw": GCN(cfg, power, seed=1, device=dev)}
    e_gemm = api.get_schedule(banded, b_col=128, c_col=128)
    e_spmm = api.get_schedule(banded, b_col=128, c_col=128, b_is_sparse=True)
    # the backward's dB of GCN layer 2 (Âᵀ·(Ḋ₂·W₂ᵀ): 32 -> 128 columns) on
    # the banded graph's transpose entry; training hits it from step 1 on
    e_db = api.get_schedule(
        models["banded"].adj, b_col=CONFIG.out_dim, c_col=CONFIG.hidden_dim,
        spec=dataclasses.replace(models["banded"].spec, transpose=True,
                                 dtype_bytes=4))
    print(f"[setup] graphs nnz banded={banded.nnz} powerlaw={power.nnz}; "
          f"{api.schedule_cache_stats()['misses']} inspections in "
          f"{time.perf_counter() - t0:.1f} s host")
    for name, e in [("gcn-banded L1", models["banded"].entries[0]),
                    ("gcn-banded L2", models["banded"].entries[1]),
                    ("gcn-powerlaw L1", models["powerlaw"].entries[0]),
                    ("banded gemm", e_gemm), ("banded spmm", e_spmm),
                    ("gcn-banded L2 dB (transpose)", e_db)]:
        ds = e.dsched
        print(f"[setup] {name}: t={ds.t_pad} T0={ds.n_tiles0} "
              f"j0_max={ds.j_rows0.shape[1]} w0={ds.ell_cols0.shape[2]} "
              f"wf1={tuple(ds.ell_cols1.shape)} "
              f"spill={ds.spill_rows1.size} "
              f"fused_ratio={e.sched.fused_ratio:.3f} "
              f"saving={e.traffic_model['traffic_saving']:.3f} "
              f"inspect={e.inspector_s:.2f}s")

    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32) * np.float32(scale)
        ).to(dev)

    def queued_ms(fn, iters=20):
        """Like ``time_ms``, with the calls queued behind a sleep kernel of
        about 10 ms, so the device never waits for the host's wrappers:
        the device's own pace for a call whose kernels are short."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    # ---- 3. kernels against their plain versions ----
    # The bound counts compulsory bytes only: the index and value of each
    # nonzero ELL entry (pad slots hold value 0 and are not needed), the
    # rows of a gathered table that a nonzero names, the output rows that
    # are real (pad rows of a fused-row block, index n_j, are not), and of
    # the SpMM-SpMM spill delta the rows that spill lanes touch.
    def nz_bytes(cols, vals):
        """Bytes of an ELL's nonzero entries: one index and one value."""
        nz = int((vals != 0).sum())
        return float(nz * (cols.element_size() + vals.element_size()))

    def row_bytes(n_rows, table):
        return float(n_rows * table.shape[1] * table.element_size())

    def gathered_bytes(cols, vals, table):
        """The rows of ``table`` a sparse product must read: the distinct
        rows that a nonzero value names (this run's data)."""
        return row_bytes(torch.unique(cols[vals != 0]).numel(), table)

    def real_rows(j_rows, n_j):
        return int((np.asarray(j_rows) != n_j).sum())

    def gemm_case(label, entry, dtype):
        ds = entry.dsched
        st = fused_ops.schedule_tensors(ds, dev, dtype)
        return gemm_tensor_case(label, st.cols0, st.vals0, ds.t_pad,
                                entry.b_col, entry.c_col, dtype, ds.n_i,
                                real_rows(ds.j_rows0, ds.n_j))

    def gemm_tensor_case(label, cols0, vals0, t, b_col, c_col, dtype,
                         n_i, n_rows0):
        """GeMM-SpMM on the tile-local fused rows ``(cols0, vals0)`` of
        ``n_i`` real rows of B (``n_rows0`` real fused rows), with B and C
        drawn here."""
        b = randn(cols0.shape[0] * t, b_col).to(dtype)
        c = randn(b_col, c_col, scale=b_col ** -0.5).to(dtype)
        nnz0 = int((vals0 != 0).sum())
        n_ops = 2.0 * n_i * b_col * c_col + 2.0 * nnz0 * c_col
        moved = (nz_bytes(cols0, vals0) + row_bytes(n_i, b)
                 + row_bytes(b_col, c) + row_bytes(n_i, c)       # d1
                 + row_bytes(n_rows0, c))                         # rows0
        lib = None
        if dtype == torch.float32:
            csr0 = ref.fused_rows_csr(cols0, vals0, t)
            lib = lambda: ref.gemm_spmm_wf0_library(csr0, b, c)  # noqa: E731
        return ("tile_fused_gemm_spmm_wf0" + label,
                lambda: ops.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, t=t),
                lambda: ref.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, t=t),
                moved, n_ops, lib)

    def sparse_mm(cols, vals, x):
        """``torch.sparse.mm`` over the ELL's nonzeros as a CSR: the
        library yardstick of ``spmm_ell`` (f32 only)."""
        if x.dtype != torch.float32:
            return None
        keep = vals != 0
        crow = torch.zeros(cols.shape[0] + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(keep.sum(1), 0)
        csr = torch.sparse_csr_tensor(crow, cols.long()[keep], vals[keep],
                                      (cols.shape[0], x.shape[0]),
                                      check_invariants=True)
        return lambda: torch.sparse.mm(csr, x)

    def wf1_case(label, entry, dtype):
        """``spmm_ell`` as wavefront 1 runs it: over the finished D1."""
        ds = entry.dsched
        st = fused_ops.schedule_tensors(ds, dev, dtype)
        x = randn(ds.n_i, entry.c_col).to(dtype)
        lib = sparse_mm(st.cols1, st.vals1, x)
        moved = (nz_bytes(st.cols1, st.vals1)
                 + gathered_bytes(st.cols1, st.vals1, x)
                 + row_bytes(real_rows(ds.j_rows1, ds.n_j), x))
        return ("spmm_ell" + label,
                lambda: ops.spmm_ell(st.cols1, st.vals1, x),
                lambda: ref.spmm_ell(st.cols1, st.vals1, x),
                moved, 2.0 * int((st.vals1 != 0).sum()) * x.shape[1], lib)

    def tail_rows(tails):
        """The row of each spill lane of a tail plan (lanes are sorted by
        row)."""
        r, ch = tails.ranges.long(), tails.chunks.long()
        counts = (r[:, 1] - r[:, 0]).clamp_min(0)
        counts.index_add_(0, ch[:, 0], ch[:, 2] - ch[:, 1])
        return torch.repeat_interleave(
            torch.arange(len(counts), device=dev), counts)

    def hybrid_moved(cols, vals, tails, x, n_written, out_rows=None):
        """Compulsory bytes of a hybrid product: each nonzero body entry and
        each tail lane (index and value, alike), the tail plan, the
        target-row map, the rows of x that a nonzero names, and the rows
        written."""
        plan = sum(t.numel() * t.element_size() for t in (
            tails.ranges, tails.chunks, tails.split_rows, tails.split_ptr))
        named = torch.unique(torch.cat([cols[vals != 0],
                                        tails.cols[tails.vals != 0]]))
        return (nz_bytes(cols, vals) + nz_bytes(tails.cols, tails.vals)
                + plan + (0 if out_rows is None else out_rows.numel() * 4)
                + row_bytes(named.numel(), x) + row_bytes(n_written, x))

    def hybrid_ops(vals, tails, c):
        return 2.0 * (int((vals != 0).sum())
                      + int((tails.vals != 0).sum())) * c

    def hybrid_library(cols, vals, tails, x):
        """``torch.sparse.mm`` of the same matrix (body nonzeros and tail
        lanes as one CSR; f32 only)."""
        if x.dtype != torch.float32:
            return None
        csr = ref.ell_csr(cols, vals, x.shape[0],
                          (tail_rows(tails), tails.cols, tails.vals))
        return lambda: torch.sparse.mm(csr, x)

    def wf1_hybrid_case(label, entry, dtype):
        """``spmm_ell`` as the kernel arms run wavefront 1: body and tails
        over the finished D1, written in place into D at ``j_rows1``; the
        chain it replaces is the body-only call, ``index_copy_`` and
        ``_spill_add``."""
        ds = entry.dsched
        st = fused_ops.schedule_tensors(ds, dev, dtype)
        n_j, c = ds.n_j, entry.c_col
        x = randn(ds.n_i, c).to(dtype)
        d0 = randn(n_j + 1, c).to(dtype)    # what wavefront 0 left in D
        outs = {k: d0.clone() for k in ("kernel", "plain", "chain")}
        kw = dict(tails=st.tails1, out_rows=st.j_rows1_32)

        def chain():
            d = outs["chain"]
            d.index_copy_(0, st.j_rows1, ops.spmm_ell(st.cols1, st.vals1, x))
            return fused_ops._spill_add(d, st.spill_rows1, st.spill_cols1,
                                        st.spill_vals1, x)[:n_j]
        return ("spmm_ell" + label,
                lambda: ops.spmm_ell(st.cols1, st.vals1, x,
                                     out=outs["kernel"][:n_j], **kw),
                lambda: ref.spmm_ell(st.cols1, st.vals1, x,
                                     out=outs["plain"][:n_j], **kw),
                hybrid_moved(st.cols1, st.vals1, st.tails1, x,
                             real_rows(ds.j_rows1, n_j), st.j_rows1_32),
                hybrid_ops(st.vals1, st.tails1, c),
                hybrid_library(st.cols1, st.vals1, st.tails1, x),
                # the library product has one row a packed slot (zeros for
                # pad slots): D's rows at j_rows1
                dict(chain=chain, lib_rows=lambda w: torch.cat(
                    [w, torch.zeros_like(w[:1])])[st.j_rows1]))

    def full_hybrid_case(label, a, c, dtype, **extra):
        """A whole full-matrix hybrid product of ``a`` (width cap auto), as
        the unfused arm and the backward's ``Âᵀ·Ḋ`` run it; the chain it
        replaces is the body-only call and ``_spill_add``."""
        cap = api._resolve_width_cap(a, "auto")
        hell = api._csr_ell(a, cap, dev, dtype)
        _, _, srows, scols, svals = fused_ops.csr_to_ell(
            a, cap).to_torch(dev, dtype)
        x = randn(a.n_cols, c).to(dtype)
        return (label,
                lambda: ops.spmm_ell(hell.cols, hell.vals, x,
                                     tails=hell.tails),
                lambda: ref.spmm_ell(hell.cols, hell.vals, x,
                                     tails=hell.tails),
                hybrid_moved(hell.cols, hell.vals, hell.tails, x, a.n_rows),
                hybrid_ops(hell.vals, hell.tails, c),
                hybrid_library(hell.cols, hell.vals, hell.tails, x),
                dict(chain=lambda: fused_ops._spill_add(
                    ops.spmm_ell(hell.cols, hell.vals, x), srows, scols,
                    svals, x), bitwise=True, **extra))

    def spmm_spmm_case(label, entry, a1, dtype):
        """The fused SpMM-SpMM kernel on ``entry``'s schedule with op 1
        ``a1`` (already in the schedule's row order)."""
        ds, c_col = entry.dsched, entry.c_col
        st = fused_ops.schedule_tensors(ds, dev, dtype)
        cs = randn(a1.n_cols, c_col, scale=0.1).to(dtype)
        ot = fused_ops.op1_tensors(a1, ds, dev, dtype)
        spill = fused_ops.op1_spill(ot, cs, ds.n_tiles0 * ds.t_pad)
        args = (ot.cols, ot.vals, spill, st.cols0, st.vals0, cs)
        spill_rows = torch.unique(ot.spill_flat).numel()
        ss_ops = (2.0 * int((ot.vals != 0).sum()) * c_col
                  + spill_rows * c_col
                  + 2.0 * int((st.vals0 != 0).sum()) * c_col)
        moved = (nz_bytes(ot.cols, ot.vals) + row_bytes(spill_rows, spill)
                 + nz_bytes(st.cols0, st.vals0)
                 + gathered_bytes(ot.cols, ot.vals, cs)
                 + row_bytes(ds.n_i, cs)                               # d1
                 + row_bytes(real_rows(ds.j_rows0, ds.n_j), cs))     # rows0
        lib = None
        if dtype == torch.float32:
            csr1 = ref.ell_csr(ot.cols, ot.vals, a1.n_cols,
                               (ot.spill_flat, ot.spill_cols, ot.spill_vals))
            csr0 = ref.fused_rows_csr(st.cols0, st.vals0, ds.t_pad)
            lib = lambda: ref.spmm_spmm_wf0_library(  # noqa: E731
                csr1, csr0, cs)
        return ("tile_fused_spmm_spmm_wf0" + label,
                lambda: ops.tile_fused_spmm_spmm_wf0(*args, t=ds.t_pad),
                lambda: ref.tile_fused_spmm_spmm_wf0(*args, t=ds.t_pad),
                moved, ss_ops, lib)

    def kernel_cases(dtype):
        """(name, kernel call, plain call, compulsory bytes, operations,
        library call or None[, extra]) at every shape the main path gives
        each kernel: GCN layers 1 and 2, the power-law hybrid product,
        SpMM-SpMM.  A library call returns what the kernel returns, the
        fused rows flattened to (T0 * j0_max, c_col).  ``extra`` may name
        the chain a kernel replaces (timed beside it), the path the
        launcher must record, and whether two calls must give the same
        bits."""
        layer1, layer2 = models["banded"].entries
        yield gemm_case("", layer1, dtype)
        yield gemm_case(" (GCN layer 2)", layer2, dtype)
        yield gemm_case(" (GCN layer 2 dB, backward)", e_db, dtype)
        yield wf1_case("", layer1, dtype)
        yield wf1_case(" (GCN layer 2 wf1)", layer2, dtype)
        yield wf1_hybrid_case(" (banded wf1 + tails, layer 1)", layer1,
                              dtype)
        yield wf1_hybrid_case(" (banded wf1 + tails, layer 2)", layer2,
                              dtype)
        for c in (128, 32):
            yield full_hybrid_case(f"spmm_ell (power-law hybrid, {c} columns)",
                                   models["powerlaw"].adj, c, dtype,
                                   path="row+split")
        # the backward's Âᵀ·Ḋ of the banded GCN, layers 1 and 2
        for c in (128, 32):
            yield full_hybrid_case(
                f"spmm_ell (banded Âᵀ hybrid, backward, {c} columns)",
                models["banded"].adj.transpose(), c, dtype)

        pl = models["powerlaw"]
        hell = api._csr_ell(pl.adj, api._resolve_width_cap(pl.adj, "auto"),
                            dev, dtype)
        x = randn(N_NODES, 128).to(dtype)
        yield ("spmm_ell (power-law unfused body)",
               lambda: ops.spmm_ell(hell.cols, hell.vals, x),
               lambda: ref.spmm_ell(hell.cols, hell.vals, x),
               nz_bytes(hell.cols, hell.vals)
               + gathered_bytes(hell.cols, hell.vals, x)
               + row_bytes(hell.cols.shape[0], x),
               2.0 * int((hell.vals != 0).sum()) * 128,
               sparse_mm(hell.cols, hell.vals, x))

        yield spmm_spmm_case("", e_spmm, banded, dtype)

    records = {}

    def check_case(name, kern, plain, moved, n_ops, lib, extra=None, *,
                   dtype, tag="3 kernels"):
        """One kernel case against its plain version: errors, the path
        the launcher took (GeMM-SpMM: ``extra["path"]``, the ``wgmma``
        kernel unless it says otherwise), times, bound and library
        yardstick; prints it under ``tag``, fails past the tolerance and
        returns its record."""
        extra = extra or {}
        dname = str(dtype).split(".")[1]
        got, want = kern(), plain()
        torch.cuda.synchronize()
        path = None
        if name.startswith("tile_fused_gemm_spmm_wf0"):
            path = gemm_last_path()
            want_path = extra.get("path", GEMM_WGMMA)
            print(f"[{tag}] {name} {dname}: ran {path}")
            if path != want_path:
                fail(f"{name} {dname}: ran {path}, not {want_path}")
        if name.startswith("spmm_ell"):
            path = spmm_last_path()
            print(f"[{tag}] {name} {dname}: ran {path}")
            if path != extra.get("path", path):
                fail(f"{name} {dname}: ran {path}, not {extra['path']}")
        if extra.get("bitwise"):
            again = kern()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"{name} {dname}: two calls differ")
            print(f"[{tag}] {name} {dname}: two calls give the same bits")
            del again
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        abs_err = max(e[0] for e in errs)
        rel = max(e[1] for e in errs)
        bound_bytes = moved / HBM_BYTES_PER_S * 1e3
        bound_ops = n_ops / PEAK_OPS[dname] * 1e3
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        lib_ms = None
        if lib is not None:
            lib_out = lib()
            if isinstance(lib_out, torch.Tensor):
                lib_out = (lib_out,)
            rows = extra.get("lib_rows", lambda w: w)
            lib_err = max(rel_err(g, rows(w).reshape(g.shape))[1]
                          for g, w in zip(lib_out, want))
            lib_ms = time_ms(lib)
        chain_ms = chain_note = None
        if "chain" in extra:
            chain_rel = rel_err(extra["chain"](), want[0])[1]
            chain_ms = time_ms(extra["chain"])
            # a short kernel is paced by its host wrapper: the same
            # calls queued behind a sleep give the device's pace
            chain_note = (f" replaced chain={chain_ms:.4f} ms (rel "
                          f"{chain_rel:.1e}); queued: kernel "
                          f"{queued_ms(kern):.4f} ms, chain "
                          f"{queued_ms(extra['chain']):.4f} ms")
        rec = dict(ms=ms, plain_ms=plain_ms,
                   bound_ms=max(bound_bytes, bound_ops),
                   bound_by="bytes" if bound_bytes >= bound_ops
                   else "operations", library_ms=lib_ms,
                   max_abs_err=abs_err, path=path,
                   replaced_chain_ms=chain_ms)
        cores = ""
        if dtype == torch.float32:
            at_67 = max(bound_bytes,
                        n_ops / PEAK_F32_CUDA_CORES * 1e3)
            cores = (f" (at 67 TFLOP/s: bound {at_67:.4f} ms, share "
                     f"{at_67 / ms:.3f})")
        print(f"[{tag}] {name} {dname}: max_abs={abs_err:.3e} "
              f"rel={rel:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms"
              f" bound={rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
              f"{moved / 1e6:.1f} MB, {n_ops / 1e9:.3f} Gop) "
              f"share={rec['bound_ms'] / ms:.3f}{cores}"
              + (f" library={lib_ms:.4f} ms (rel {lib_err:.1e})"
                 if lib_ms is not None else "") + (chain_note or ""))
        if rel > TOL[dname]:
            fail(f"{name} {dname}: rel err {rel:.3e} > {TOL[dname]}")
        return rec

    for dtype in (torch.float32, torch.bfloat16):
        for case in kernel_cases(dtype):
            records[(case[0], str(dtype).split(".")[1])] = check_case(
                *case, dtype=dtype)

    # ---- 4 + 5: the main path, with the launch counts from 0 ----
    ops.reset_launch_counts()

    # ---- 4. tile_fused_matmul, both op pairs ----
    b_np = rng.standard_normal((N_NODES, 128), np.float32)
    c_np = (rng.standard_normal((128, 128), np.float32)
            / np.float32(128 ** 0.5))
    cs_np = rng.standard_normal((N_NODES, 128), np.float32)
    cases = [("GeMM-SpMM", e_gemm, torch.from_numpy(b_np).to(dev),
              torch.from_numpy(c_np).to(dev),
              lambda: fused_ref.unfused_gemm_spmm(banded, b_np, c_np)),
             ("SpMM-SpMM", e_spmm, banded, torch.from_numpy(cs_np).to(dev),
              lambda: fused_ref.unfused_spmm_spmm(banded, banded, cs_np))]
    for name, entry, b_or_a1, c, oracle in cases:
        pick = api.select_backend(entry, dev)
        if pick != "cuda":
            fail(f"phase 4 {name}: auto picked {pick!r}, expected 'cuda'")
        before = ops.launch_counts()
        t0 = time.perf_counter()
        got = api.tile_fused_matmul(banded, b_or_a1, c)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
        want = api.tile_fused_matmul(banded, b_or_a1, c, backend="torch")
        host = torch.from_numpy(oracle())
        err_t = rel_err(got, want)[1]
        err_h = rel_err(got.cpu().double(), host)[1]
        print(f"[4 tile_fused_matmul] {name}: pick={pick} shape="
              f"{tuple(got.shape)} rel_err vs torch={err_t:.2e} vs host "
              f"oracle={err_h:.2e} launches={launched} wall={wall:.2f} ms")
        if max(err_t, err_h) > MAIN_TOL or got.shape != host.shape:
            fail(f"phase 4 {name}: result disagrees")
        if sum(launched.values()) == 0:
            fail(f"phase 4 {name}: no kernel launched")

    # ---- 4, gradients: both op pairs through the autograd Functions ----
    # the backward runs Aᵀ products off transpose entries; a symmetric A
    # hides a transpose bug, so a non-symmetric matrix runs too (with
    # D.sum(), whose cotangent has stride 0)
    nonsym = every_other_row(banded_spd(N_NODES, 8, seed=2))
    grad_rng = np.random.default_rng(3)
    grad_np = {"b": grad_rng.standard_normal((N_NODES, 128), np.float32),
               "c": (grad_rng.standard_normal((128, 128), np.float32)
                     / np.float32(128 ** 0.5)),
               "cs": grad_rng.standard_normal((N_NODES, 128), np.float32),
               "w": grad_rng.standard_normal((N_NODES, 128), np.float32)}
    w_dev = torch.from_numpy(grad_np["w"]).to(dev)

    def backward_run(a, sparse, weighted, backend):
        """(gradients, launches of the backward alone) of ``loss(D)``."""
        leaves = ([grad_np["cs"]] if sparse else [grad_np["b"], grad_np["c"]])
        leaves = [torch.from_numpy(v).to(dev).requires_grad_()
                  for v in leaves]
        d = (api.tile_fused_matmul(a, a, leaves[0], backend=backend)
             if sparse else
             api.tile_fused_matmul(a, *leaves, backend=backend))
        value = (w_dev * d).sum() if weighted else d.sum()
        torch.cuda.synchronize()
        before = ops.launch_counts()
        value.backward()
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
        return [x.grad for x in leaves], launched

    for aname, a, weighted in (("banded_spd", banded, True),
                               ("non-symmetric", nonsym, False)):
        for name, sparse, wf0 in (("GeMM-SpMM", False,
                                   "tile_fused_gemm_spmm_wf0"),
                                  ("SpMM-SpMM", True,
                                   "tile_fused_spmm_spmm_wf0")):
            got, launched = backward_run(a, sparse, weighted, "auto")
            want, _ = backward_run(a, sparse, weighted, "torch")
            err = max(rel_err(g, w)[1] for g, w in zip(got, want))
            e_t = api.get_schedule(a, b_col=128, c_col=128,
                                   b_is_sparse=sparse,
                                   spec=api.FusionSpec(transpose=True,
                                                       dtype_bytes=4))
            loss_name = "(w·D).sum()" if weighted else "D.sum()"
            print(f"[4 gradients] {name} on {aname} ({a.nnz} nnz), loss "
                  f"{loss_name}: transpose entry t={e_t.dsched.t_pad} "
                  f"T0={e_t.dsched.n_tiles0} saving="
                  f"{e_t.traffic_model['traffic_saving']:.3f} auto pick "
                  f"{api.select_backend(e_t, dev)!r}; grads rel_err vs "
                  f"torch={err:.2e}; backward launches {launched}")
            if err > MAIN_TOL:
                fail(f"phase 4 {name} on {aname}: gradients disagree "
                     f"({err:.2e})")
            if launched[wf0] == 0:
                fail(f"phase 4 {name} on {aname}: the backward launched no "
                     f"{wf0}")
            del got, want
    del nonsym

    # ---- 5. GCN serving ----
    expected_pick = {"banded": "cuda", "powerlaw": "unfused"}
    serve_p50_ms, serve_launches = {}, {}
    for gname, model in models.items():
        picks = model.layer_backends()
        print(f"[5 gcn] {gname}: layer picks {picks}")
        if picks[0] != expected_pick[gname]:
            fail(f"phase 5 {gname}: layer 1 picked {picks[0]!r}")
        lat, per_req = [], []
        req_rng = np.random.default_rng(100)
        for r in range(REQUESTS):
            x = torch.from_numpy(req_rng.standard_normal(
                (N_NODES, cfg.in_dim), np.float32)).to(dev)
            torch.cuda.synchronize()
            before = ops.launch_counts()
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits = model(x)
                torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            per_req.append({k: v - before[k]
                            for k, v in ops.launch_counts().items()})
            with torch.inference_mode():
                want = model(x, backend="torch")
            err = rel_err(logits, want)[1]
            if (tuple(logits.shape) != (N_NODES, cfg.out_dim)
                    or err > MAIN_TOL):
                fail(f"phase 5 {gname} request {r}: shape "
                     f"{tuple(logits.shape)}, rel err {err:.2e}")
        if any(p["spmm_ell"] == 0 for p in per_req):
            fail(f"phase 5 {gname}: a request launched no spmm_ell")
        serve_p50_ms[gname] = float(np.median(lat))
        serve_launches[gname] = per_req[-1]
        print(f"[5 gcn] {gname}: {REQUESTS} requests, p50="
              f"{float(np.median(lat)):.3f} ms max={max(lat):.3f} ms "
              f"(host clock around forward + synchronize, features already"
              f" on the card); launches per request {per_req[-1]}; "
              f"last rel err vs torch {err:.2e}")

    counts = ops.launch_counts()
    print(f"[main path] kernel launches in phases 4-5: {counts}")
    missing = [k for k in GCN_KERNELS if counts[k] == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    path_launches = {k: counts[k] for k in GCN_KERNELS}

    # ---- 4, continued: the fused arm against the unfused arm ----
    # (after the main path's counts were read: these launches are not
    # counted).  CUDA events time the stream, which waits for the host when
    # the host is slower than the device; the profiler's device time of the
    # same calls is the device's own work.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_ms(fn, calls=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3 / calls

    for name, entry, b_or_a1, c, _ in cases:
        arms = {}
        for arm in ("cuda", "unfused"):
            call = (lambda arm=arm: api.tile_fused_matmul(  # noqa: E731
                banded, b_or_a1, c, backend=arm))
            arms[arm] = (time_ms(call), device_ms(call))
        (ev_f, dev_f), (ev_u, dev_u) = arms["cuda"], arms["unfused"]
        print(f"[4 arms] {name}: per tile_fused_matmul call, fused arm "
              f"(backend='cuda') {ev_f:.4f} ms, unfused arm {ev_u:.4f} ms "
              f"(CUDA events, mean of 20 calls after 3 warm-ups); device "
              f"time {dev_f:.4f} ms and {dev_u:.4f} ms (profiler, mean of "
              f"5 calls)")
        dev_ratio = (f"{dev_f / dev_u:.3f}" if dev_f > 0 and dev_u > 0
                     else "not measured (the profiler saw no device time)")
        print(f"[4 arms] {name} fused/unfused = {ev_f / ev_u:.3f} "
              f"(events), {dev_ratio} (device time)")

    # ---- 6. trace: where one request's time goes ----
    for gname, model in models.items():
        x = torch.from_numpy(np.random.default_rng(200).standard_normal(
            (N_NODES, cfg.in_dim), np.float32)).to(dev)
        with torch.inference_mode():
            model(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only: an aten op's row repeats the time of
        # the kernels it launched, which would count them twice
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        device_us = sum(e.self_device_time_total for e in events)
        p50_us = serve_p50_ms[gname] * 1e3
        print(f"[6 trace] {gname}: device busy {device_us / 1e3:.3f} ms per "
              f"request: {device_us / wall_us:.3f} of the profiled wall "
              f"({wall_us / 1e3:.3f} ms), {device_us / p50_us:.3f} of the "
              f"phase-5 p50 ({p50_us / 1e3:.3f} ms)")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"[6 trace] {gname}:   {e.self_device_time_total:9.1f} us"
                  f"  x{e.count:<3d} {e.key[:90]}")
        # the spill lanes and wavefront 1 go through the hybrid kernel: no
        # scatter-add on either path, and index_copy_ only for the scatter
        # of wavefront 0's fused rows (one a fused layer)
        calls = {e.key: e.count for e in prof.key_averages()
                 if e.key in ("aten::index_add_", "aten::index_copy_")}
        fused_layers = model.layer_backends().count("cuda")
        print(f"[6 trace] {gname}: {calls or 'no index_add_ / index_copy_'}"
              f" ({fused_layers} fused layers)")
        if (calls.get("aten::index_add_", 0)
                or calls.get("aten::index_copy_", 0) > fused_layers):
            fail(f"phase 6 {gname}: {calls} in one request")

    # ---- 7. LM kernels through their entry points ----
    import torch.nn.functional as F

    def lm_inputs(kernel, dtype, b=0, h=0, hkv=0, sq=0, sk=0, d=0, e=0,
                  m=0, f=0, **_):
        if kernel == "flash_attention":
            return [randn(b, h, sq, d).to(dtype),
                    randn(b, hkv, sk, d).to(dtype),
                    randn(b, hkv, sk, d).to(dtype)]
        lead = (e,) if e else ()
        return [randn(*lead, m, d).to(dtype),
                randn(*lead, d, f, scale=d ** -0.5).to(dtype),
                randn(*lead, f, d, scale=f ** -0.5).to(dtype)]

    def lm_calls(kernel, args, opts):
        """(kernel call, plain call, library call, bytes, operations)."""
        moved = float(sum(a.numel() * a.element_size() for a in args)
                      + args[0].numel() * args[0].element_size())  # output
        if kernel == "flash_attention":
            q, k, v = args
            causal, window = opts["causal"], opts["window"]
            mask = ref.attention_mask(q.shape[2], k.shape[2], causal=causal,
                                      window=window, device=dev)
            pairs = int(mask.sum()) * q.shape[0] * q.shape[1]
            kw = dict(causal=causal, window=window)
            sdpa = dict(enable_gqa=k.shape[1] != q.shape[1])
            if window:
                sdpa["attn_mask"] = mask
            else:
                sdpa["is_causal"] = causal
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, **sdpa)
            return (lambda: ops.flash_attention(q, k, v, **kw),
                    lambda: ref.attention(q, k, v, **kw), lib, moved,
                    4.0 * q.shape[3] * pairs)
        x, w1, w2 = args
        act = opts["act"]
        act_fn = {"gelu": lambda t: F.gelu(t, approximate="tanh"),
                  "silu": F.silu, "none": lambda t: t}[act]
        n_ops = 4.0 * x.numel() * w1.shape[-1]
        if kernel == "fused_ffn":
            return (lambda: ops.fused_ffn(x, w1, w2, act=act),
                    lambda: ref.ffn(x, w1, w2, act=act),
                    lambda: torch.matmul(act_fn(torch.matmul(x, w1)), w2),
                    moved, n_ops)
        return (lambda: ops.fused_moe_ffn(x, w1, w2, act=act),
                lambda: ref.moe_ffn(x, w1, w2, act=act),
                lambda: torch.bmm(act_fn(torch.bmm(x, w1)), w2),
                moved, n_ops)

    lm_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, kernel, opts in LM_CASES:
            if opts.get("bf16_only") and dtype != torch.bfloat16:
                continue
            lm_cases.append((label, kernel, opts, dtype,
                             lm_inputs(kernel, dtype, **opts)))
    # the kernel entry point is the path of the FFN and MoE kernels (no
    # model calls them): drive it once per case with the counts from 0
    ops.reset_launch_counts()
    entry_out = [lm_calls(kernel, args, opts)[0]()
                 for _, kernel, opts, _, args in lm_cases]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"[7 lm kernels] launches through the entry points: {counts}")
    for k in ("fused_ffn", "fused_moe_ffn", "flash_attention"):
        if counts[k] == 0:
            fail(f"phase 7: {k} never launched through its entry point")
    path_launches.update(fused_ffn=counts["fused_ffn"],
                         fused_moe_ffn=counts["fused_moe_ffn"])
    flash_record_path = "none"
    for (label, kernel, opts, dtype, args), got in zip(lm_cases, entry_out):
        dname = str(dtype).split(".")[1]
        kern, plain, lib, moved, n_ops = lm_calls(kernel, args, opts)
        want = plain()
        # row by row: under a causal mask the first rows hold the largest
        # values, and a global scale would hide errors on the long rows
        abs_err, rel = rel_err(got, want, rows=True)
        tol = LM_BF16_TOL if dtype == torch.bfloat16 else TOL[dname]
        if got.shape != want.shape or rel > tol:
            fail(f"{label} {dname}: shape {tuple(got.shape)}, row rel err "
                 f"{rel:.3e} > {tol}")
        lib_err = rel_err(lib(), want, rows=True)[1]
        if kernel == "flash_attention":
            kern()
            torch.cuda.synchronize()
            ran = flash_last_path()
            print(f"[7 lm kernels] {label} {dname}: ran {ran}")
            if (label, dname) == (LM_RECORD["flash_attention"], "bfloat16"):
                flash_record_path = ran
            if (dtype == torch.bfloat16 and opts["d"] in (64, 128)
                    and ran != FLASH_WGMMA):
                fail(f"{label} {dname}: ran {ran}, not {FLASH_WGMMA}")
        else:
            kern()
            torch.cuda.synchronize()
            ran = ffn_last_path()
            print(f"[7 lm kernels] {label} {dname}: ran {ran}")
            if ran != FFN_PATHS[dname]:
                fail(f"{label} {dname}: ran {ran}, not {FFN_PATHS[dname]}")
        bound_bytes = moved / HBM_BYTES_PER_S * 1e3
        bound_ops = n_ops / PEAK_OPS[dname] * 1e3
        ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(lib)
        rec = dict(ms=ms, plain_ms=plain_ms,
                   bound_ms=max(bound_bytes, bound_ops),
                   bound_by="bytes" if bound_bytes >= bound_ops
                   else "operations", library_ms=lib_ms,
                   max_abs_err=abs_err, path=ran)
        print(f"[7 lm kernels] {label} {dname}: max_abs={abs_err:.3e} "
              f"row_rel={rel:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
              f"bound={rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
              f"{moved / 1e6:.1f} MB, {n_ops / 1e9:.3f} Gop) "
              f"share={rec['bound_ms'] / ms:.3f} library={lib_ms:.4f} ms "
              f"(rel {lib_err:.1e})")
        records[(label, dname)] = rec
    del lm_cases, entry_out
    torch.cuda.empty_cache()

    # ---- 8. LM serving: qwen2.5-3b, batched prefill + greedy decode ----
    lm_cfg = get_config(LM_ARCH, reduced=LM_REDUCED)
    t0 = time.perf_counter()
    lm, prompts = serve.build(lm_cfg, batch=LM_BATCH, prompt_len=LM_PROMPT,
                              seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"[8 lm serve] {lm_cfg.name}: {n_params / 1e9:.3f} B parameters "
          f"({lm_cfg.dtype}), {lm_cfg.n_layers} layers, d_model "
          f"{lm_cfg.d_model}, built on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    # prefill logits: flash kernel against the plain attention (this also
    # warms up the path; its launches are not counted)
    cache = lm.init_cache(LM_BATCH, LM_PROMPT + LM_DECODE + 1)
    got, _ = lm.decode_step(prompts, cache, 0)
    want, _ = lm.decode_step(prompts, cache, 0, impl="torch")
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, want)
    agree = float((got[:, -1].argmax(-1) == want[:, -1].argmax(-1))
                  .float().mean())
    print(f"[8 lm serve] prefill logits {tuple(got.shape)} vs impl=torch: "
          f"max_abs={abs_err:.3e} rel={rel:.3e} (tolerance {LM_TOL}); "
          f"next-token agreement {agree:.2f}")
    if rel > LM_TOL:
        fail(f"phase 8: prefill logits disagree with the plain attention "
             f"(rel {rel:.3e} > {LM_TOL})")
    del got, want, cache
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tokens, timing = serve.generate(lm, prompts, LM_DECODE + 1)
    counts = ops.launch_counts()
    dec_ms = [t * 1e3 for t in timing.decode_s]
    print(f"[8 lm serve] prefill {LM_BATCH} x {LM_PROMPT} tokens in "
          f"{timing.prefill_s * 1e3:.2f} ms "
          f"({LM_BATCH * LM_PROMPT / timing.prefill_s:.0f} tokens/s); "
          f"{len(dec_ms)} decode steps p50={float(np.median(dec_ms)):.3f} ms"
          f" max={max(dec_ms):.3f} ms "
          f"({LM_BATCH / (float(np.median(dec_ms)) / 1e3):.1f} tokens/s at "
          f"p50); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; host clock"
          f" around each step + synchronize")
    print(f"[8 lm serve] launches in the serve run: {counts}; "
          f"sample {tokens[0, :8].tolist()}")
    # the prefill above follows empty_cache(), so it also pays cudaMalloc
    # (which synchronizes); a serving process reuses its cached blocks:
    # time the prefill step again with the allocator warm
    serve_step = steps.make_serve_step(lm)
    warm_ms = []
    for _ in range(3):
        cache = lm.init_cache(LM_BATCH, LM_PROMPT + LM_DECODE + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve_step(prompts, cache, 0)
        torch.cuda.synchronize()
        warm_ms.append((time.perf_counter() - t0) * 1e3)
        del cache
    print(f"[8 lm serve] prefill with the allocator warm: "
          f"{', '.join(f'{t:.2f}' for t in warm_ms)} ms "
          f"({LM_BATCH * LM_PROMPT / (min(warm_ms) / 1e3):.0f} tokens/s at "
          f"the fastest)")
    if tuple(tokens.shape) != (LM_BATCH, LM_DECODE + 1) or not bool(
            ((tokens >= 0) & (tokens < lm_cfg.vocab_size)).all()):
        fail(f"phase 8: tokens {tuple(tokens.shape)} out of range")
    if counts["flash_attention"] != lm_cfg.n_layers:
        fail(f"phase 8: {counts['flash_attention']} flash launches for one "
             f"prefill of {lm_cfg.n_layers} layers")
    path_launches["flash_attention"] = counts["flash_attention"]
    # the decode path at full width: replay the first decode steps on a
    # cache of the serve run's size, fed the served tokens; each step's
    # greedy pick must be the served token, and its logits must match a
    # full forward over prompt + served tokens with the plain attention
    cache = lm.init_cache(LM_BATCH, LM_PROMPT + LM_DECODE + 1)
    logits, cache = lm.decode_step(prompts, cache, 0)
    picks, dec_logits = [logits[:, -1].argmax(-1)], []
    for i in range(LM_REPLAY):
        logits, cache = lm.decode_step(tokens[:, i:i + 1], cache,
                                       LM_PROMPT + i)
        dec_logits.append(logits[:, 0])
        picks.append(logits[:, 0].argmax(-1))
    picks = torch.stack(picks, dim=1).to(tokens.dtype)
    if not torch.equal(picks, tokens[:, :LM_REPLAY + 1]):
        fail(f"phase 8: replayed greedy picks {picks.tolist()} are not the "
             f"served tokens {tokens[:, :LM_REPLAY + 1].tolist()}")
    del cache, logits
    seq = torch.cat([prompts, tokens[:, :LM_REPLAY].to(prompts.dtype)], 1)
    with torch.inference_mode():
        want = lm(seq, impl="torch")[:, LM_PROMPT:]
    got = torch.stack(dec_logits, dim=1)
    abs_err, rel = rel_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"[8 lm serve] {LM_REPLAY} decode steps at cache capacity "
          f"{LM_PROMPT + LM_DECODE + 1}: greedy picks = served tokens; "
          f"logits {tuple(got.shape)} vs full forward (impl=torch): "
          f"max_abs={abs_err:.3e} rel={rel:.3e} (tolerance {LM_TOL}); "
          f"next-token agreement {agree:.2f}")
    if rel > LM_TOL:
        fail(f"phase 8: decode logits disagree with the full forward "
             f"(rel {rel:.3e} > {LM_TOL})")
    del got, want, seq, dec_logits
    torch.cuda.empty_cache()

    # ---- 9. trace: where one prefill's and one decode step's time goes ----
    cache = lm.init_cache(LM_BATCH, LM_PROMPT + 2)
    step = steps.make_serve_step(lm)
    for what, toks, cache_len in (("prefill", prompts, 0),
                                  ("decode step", tokens[:, :1], LM_PROMPT)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(toks, cache, cache_len)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        device_us = sum(e.self_device_time_total for e in events)
        launches = sum(e.count for e in events)
        print(f"[9 trace] {what}: device busy {device_us / 1e3:.3f} ms of "
              f"{wall_us / 1e3:.3f} ms profiled wall "
              f"({device_us / wall_us:.3f}), {launches} device kernels")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"[9 trace] {what}:   {e.self_device_time_total:10.1f} us "
                  f"({e.self_device_time_total / device_us:.3f}) "
                  f"x{e.count:<4d} {e.key[:80]}")
    del lm, cache
    torch.cuda.empty_cache()

    # ---- 10. GCN training: CONFIG widths, both phase-5 graphs, SGD ----
    import torch.nn.functional as F

    def sparse_mm_loss(adj, x, y, ws, masks=None):
        """``(loss, sign changes)``: the GCN loss through ``torch.sparse.mm``
        autograd, the f64 host oracle and the card's library yardstick
        (independent of the port's executors).  With ``masks`` (one bool
        tensor a hidden layer) each ReLU is the linear branch that the
        checked run took: where a pre-activation lies within f32 rounding
        of 0, f32 and f64 take different branches and the gradient jumps
        (one such entry moves ``dW1`` by ~1e-3 of its largest value); the
        second value counts those entries."""
        h, flips = x, 0
        for i, w in enumerate(ws):
            h = torch.sparse.mm(adj, h @ w)
            if i == len(ws) - 1:
                break
            if masks is None:
                h = torch.relu(h)
            else:
                flips += int((masks[i] != (h > 0)).sum())
                h = h * masks[i]
        logp = F.log_softmax(h, dim=-1)
        return -torch.take_along_dim(logp, y[:, None], dim=1).mean(), flips

    def sparse_adj(a, device, dtype):
        rows = np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
        idx = torch.from_numpy(np.stack([rows, a.indices]).astype(np.int64))
        return torch.sparse_coo_tensor(
            idx, torch.from_numpy(np.asarray(a.data, np.float64)),
            (a.n_rows, a.n_cols)).coalesce().to(device, dtype)

    def transpose_entries(adj):
        """``{(b_col, c_col): entry}`` of ``adj``'s live transpose
        entries."""
        digest = csr_content_digest(adj)
        return {(k[1], k[2]): e for k, e in api._schedule_cache.items()
                if e.transpose and k[0] == digest}

    def step_ms(step, x, y, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(x, y)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    train_launches = dict.fromkeys(GCN_KERNELS, 0)
    for gname, model in models.items():
        n_layers = len(model.weights)
        data_rng = np.random.default_rng(300)
        x = torch.from_numpy(data_rng.standard_normal(
            (N_NODES, cfg.in_dim), np.float32)).to(dev)
        y = torch.from_numpy(data_rng.integers(0, cfg.out_dim,
                                               N_NODES)).to(dev)
        w0 = [w.detach().clone() for w in model.weights]

        def grads_at(weights, backend):
            with torch.no_grad():
                for w, v in zip(model.weights, weights):
                    w.copy_(v)
            for w in model.weights:
                w.grad = None
            loss = model.loss(x, y, backend=backend)
            loss.backward()
            return float(loss), [w.grad.clone() for w in model.weights]

        # the references at the initial weights: the plain path on the
        # card, and the f64 oracle on the host, on the ReLU branches of the
        # run's own forward
        want_loss, want = grads_at(w0, "torch")
        masks, h = [], x
        with torch.no_grad():
            for w in w0[:-1]:
                z = api.tile_fused_matmul(model.adj, h, w)
                masks.append((z > 0).cpu())
                h = torch.relu(z)
        del h, z
        oracle_ws = [v.cpu().double().requires_grad_() for v in w0]
        oracle_loss, flips = sparse_mm_loss(
            sparse_adj(model.adj, "cpu", torch.float64), x.cpu().double(),
            y.cpu(), oracle_ws, masks)
        oracle_loss.backward()
        del masks

        # the training run, counted: 10 SGD steps from w0
        step = steps.make_gcn_train_step(model, lr=TRAIN_LR)
        misses = []
        ops.reset_launch_counts()
        losses, lat, per_step, bwd_path = [], [], [], []
        for i in range(TRAIN_STEPS):
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(x, y)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            per_step.append({k: v - before[k]
                             for k, v in ops.launch_counts().items()})
            losses.append(float(loss))
            misses.append(api.schedule_cache_stats()["misses"])
            if gname == "banded":
                bwd_path.append(gemm_last_path())
            if i == 0:
                got = [w.grad.clone() for w in model.weights]
                keys = sorted(transpose_entries(model.adj))
        counts = ops.launch_counts()
        for k in GCN_KERNELS:
            train_launches[k] += counts[k]

        err_t = max(rel_err(g, w)[1] for g, w in zip(got, want))
        err_o = max(rel_err(g.cpu().double(), w.grad)[1]
                    for g, w in zip(got, oracle_ws))
        print(f"[10 gcn train] {gname}: step-1 loss {losses[0]:.6f} (torch "
              f"{want_loss:.6f}, f64 oracle {float(oracle_loss):.6f}); "
              f"weight grads rel_err vs torch={err_t:.2e} vs f64 "
              f"torch.sparse.mm oracle={err_o:.2e} (on the run's ReLU "
              f"branches; {flips} of {N_NODES * cfg.hidden_dim} "
              f"pre-activations change sign in f64)")
        print(f"[10 gcn train] {gname}: losses "
              f"{', '.join(f'{v:.5f}' for v in losses)}")
        picks = [api.select_backend(e, dev)
                 for e in transpose_entries(model.adj).values()]
        print(f"[10 gcn train] {gname}: transpose entries after step 1 "
              f"{keys}, auto picks {picks}; schedule-cache misses after "
              f"each step {misses}")
        print(f"[10 gcn train] {gname}: launches per step {per_step[-1]} "
              f"(a serving request: {serve_launches[gname]}); "
              f"GeMM-SpMM path of each step's last launch (the backward's "
              f"dB) {sorted(set(bwd_path))}")
        if max(err_t, err_o) > MAIN_TOL:
            fail(f"phase 10 {gname}: step-1 gradients disagree "
                 f"({err_t:.2e} vs torch, {err_o:.2e} vs the oracle)")
        if not losses[-1] < losses[0]:
            fail(f"phase 10 {gname}: loss {losses[0]} -> {losses[-1]}")
        if len(set(misses)) != 1:
            fail(f"phase 10 {gname}: re-inspected after step 1: {misses}")
        if keys != [(cfg.out_dim, cfg.hidden_dim)]:
            fail(f"phase 10 {gname}: transpose entries {keys}, expected "
                 f"layer 2's dB only")
        for i, p in enumerate(per_step):
            # each layer's Âᵀ·Ḋ is one more spmm_ell call than serving makes
            if p["spmm_ell"] < serve_launches[gname]["spmm_ell"] + n_layers:
                fail(f"phase 10 {gname} step {i + 1}: {p['spmm_ell']} "
                     f"spmm_ell launches")
            if gname == "banded" and p["tile_fused_gemm_spmm_wf0"] != (
                    serve_launches[gname]["tile_fused_gemm_spmm_wf0"] + 1):
                fail(f"phase 10 {gname} step {i + 1}: "
                     f"{p['tile_fused_gemm_spmm_wf0']} GeMM-SpMM launches")
        if gname == "banded" and set(bwd_path) != {GEMM_WGMMA}:
            fail(f"phase 10 {gname}: the backward's dB ran {bwd_path}")

        # (not counted from here on) two backward passes from the same
        # weights give the same bits
        w_now = [w.detach().clone() for w in model.weights]
        _, g1 = grads_at(w_now, "auto")
        _, g2 = grads_at(w_now, "auto")
        if not all(torch.equal(a, b) for a, b in zip(g1, g2)):
            fail(f"phase 10 {gname}: two backward passes differ")
        print(f"[10 gcn train] {gname}: two backward passes from the same "
              f"weights give the same bits")

        # one step under the profiler: device time by kernel, busy share.
        # A step traced warm-up first (recorded, then dropped): a session's
        # first kernels launched through ctypes can go missing from its
        # trace, as the step's first GeMM-SpMM launch did without it
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=torch.profiler.schedule(
                         wait=0, warmup=1, active=1, repeat=1)) as prof:
            step(x, y)
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            step(x, y)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
        # kernels only: the schedule's step annotation spans the step on
        # the device's timeline too
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith("ProfilerStep")]
        device_us = sum(e.self_device_time_total for e in events)
        p50 = float(np.median(lat))
        print(f"[10 gcn train] {gname}: {TRAIN_STEPS} steps, p50="
              f"{p50:.3f} ms max={max(lat):.3f} ms (host clock around the "
              f"step + synchronize; step 1 {lat[0]:.3f} ms); device busy "
              f"{device_us / 1e3:.3f} ms per step: {device_us / wall_us:.3f}"
              f" of the profiled wall ({wall_us / 1e3:.3f} ms), "
              f"{device_us / 1e3 / p50:.3f} of the p50")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
            print(f"[10 gcn train] {gname}:   {e.self_device_time_total:9.1f}"
                  f" us  x{e.count:<3d} {e.key[:120]}")
        adds = sum(e.count for e in prof.key_averages()
                   if e.key == "aten::index_add_")
        if adds:
            fail(f"phase 10 {gname}: {adds} index_add_ in a training step")

        # the host time of Eq-3's pick, which every layer of every step
        # asks (Schedule.fused_ratio sums over the wavefront-0 tiles)
        t0 = time.perf_counter()
        for _ in range(20):
            for e in model.entries:
                api.select_backend(e, dev)
        print(f"[10 gcn train] {gname}: host time of one select_backend "
              f"call {(time.perf_counter() - t0) / 20 / n_layers * 1e6:.1f} "
              f"us ({model.entries[0].dsched.n_tiles0} wavefront-0 tiles "
              f"at layer 1)")

        # yardsticks: the unfused arm, and torch.sparse.mm autograd
        unfused = step_ms(steps.make_gcn_train_step(
            model, lr=TRAIN_LR, backend="unfused"), x, y, 5)
        adj_dev = sparse_adj(model.adj, dev, torch.float32)
        lib_ws = [v.clone().requires_grad_() for v in w0]

        def library_step(x, y):
            for w in lib_ws:
                w.grad = None
            sparse_mm_loss(adj_dev, x, y, lib_ws)[0].backward()
            with torch.no_grad():
                for w in lib_ws:
                    w.sub_(TRAIN_LR * w.grad)
        library = step_ms(library_step, x, y, 5)
        print(f"[10 gcn train] {gname}: step p50 {p50:.3f} ms; yardsticks "
              f"p50 over 5 steps: backend='unfused' "
              f"{float(np.median(unfused)):.3f} ms, torch.sparse.mm autograd"
              f" {float(np.median(library)):.3f} ms")
        del adj_dev, lib_ws, x, y
    print(f"[10 gcn train] kernel launches in the training runs: "
          f"{train_launches}")
    for k in ("spmm_ell", "tile_fused_gemm_spmm_wf0"):
        if train_launches[k] == 0:
            fail(f"phase 10: {k} never launched in training")
        path_launches[k] += train_launches[k]

    # ---- 11. schedule transforms and the hetero stack ----
    # the reorder and autotune transforms and the hetero stack on the card;
    # the counts are set to 0 around each counted call and add to the
    # phase's launches
    t11 = time.perf_counter()
    from repro_torch.core.tilefusion import hetero, reorder
    from repro_torch.kernels import tile_fused_gemm_spmm as gemm_wf0
    from repro_torch.models.gcn import normalize_adjacency
    from repro_torch.models.hetero_gcn import HeteroGCNLayer
    launches = dict.fromkeys(GCN_KERNELS, 0)

    def counted(fn):
        """``(fn(), launches)`` with the counts set to 0 just before and
        read just after; they add to the phase's launches."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: ops.launch_counts()[k] for k in GCN_KERNELS}
        for k, v in counts.items():
            launches[k] += v
        return out, counts

    def dev_tensor(gen, *shape, scale=1.0):
        return torch.from_numpy(gen.standard_normal(shape, np.float32)
                                * np.float32(scale)).to(dev)

    def shape_of(entry):
        ds = entry.dsched
        return (f"t={ds.t_pad} T0={ds.n_tiles0} j0_max={ds.j_rows0.shape[1]}"
                f" w0={ds.ell_cols0.shape[2]} fused_ratio="
                f"{entry.sched.fused_ratio:.3f} saving="
                f"{entry.traffic_model['traffic_saving']:.3f}")

    def gemm_path(entry, dtype=torch.float32):
        """(the path the launcher took, the path its rule picks)."""
        ds = entry.dsched
        return gemm_wf0.last_path(), gemm_wf0.choose_path(
            ds.t_pad, entry.b_col, entry.c_col, ds.j_rows0.shape[1],
            ds.ell_cols0.shape[2], dtype)

    def grads(a, b_or_a1, c, backend, spec):
        """Gradients of ``(w·D).sum()`` w.r.t. the dense operands, and the
        launches of the backward alone (counted)."""
        leaves = [x.detach().clone().requires_grad_()
                  for x in ((c,) if b_or_a1 is a else (b_or_a1, c))]
        d = api.tile_fused_matmul(a, a if b_or_a1 is a else leaves[0],
                                  leaves[-1], backend=backend, spec=spec)
        w = torch.linspace(-1.0, 1.0, d.numel(), device=dev).view(d.shape)
        value = (w * d).sum()
        if backend == "torch":
            value.backward()
            return [x.grad for x in leaves], None
        _, counts = counted(value.backward)
        return [x.grad for x in leaves], counts

    # ---- 11a. reorder: the shuffled banded graph ----
    rng11 = np.random.default_rng(110)
    t0 = time.perf_counter()
    plain_adj = normalize_adjacency(banded_spd(N_NODES, 8, seed=0))
    shuffle = np.random.default_rng(SHUFFLE_SEED).permutation(N_NODES)
    shuffled = reorder.permute_csr(plain_adj, shuffle)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, rcm_adj = api._ordering(shuffled, "rcm")
    t_rcm = time.perf_counter() - t0
    print(f"[11a reorder] banded_spd({N_NODES}, 8), normalized, under a "
          f"seeded symmetric permutation ({t_graph:.2f} s host): bandwidth "
          f"{reorder.bandwidth(plain_adj)} before the shuffle, "
          f"{reorder.bandwidth(shuffled)} shuffled, "
          f"{reorder.bandwidth(rcm_adj)} after rcm_order ({t_rcm:.2f} s "
          f"host)")
    spec_r = api.FusionSpec(reorder="auto")
    shuffle_t = torch.from_numpy(shuffle).to(dev)
    b = dev_tensor(rng11, N_NODES, 128)
    c = dev_tensor(rng11, 128, 128, scale=128 ** -0.5)
    cs = dev_tensor(rng11, N_NODES, 128)
    for name, sparse in (("GeMM-SpMM", False), ("SpMM-SpMM", True)):
        b_or_a1, cc = (shuffled, cs) if sparse else (b, c)
        t0 = time.perf_counter()
        plain = api.get_schedule(shuffled, b_col=128, c_col=128,
                                 b_is_sparse=sparse)
        t_plain = time.perf_counter() - t0
        t0 = time.perf_counter()
        entry = api.get_schedule(shuffled, b_col=128, c_col=128,
                                 b_is_sparse=sparse, spec=spec_r)
        t_auto = time.perf_counter() - t0
        picks = (api.select_backend(plain, dev),
                 api.select_backend(entry, dev))
        print(f"[11a reorder] {name}: reorder=None {shape_of(plain)} pick "
              f"{picks[0]!r} ({t_plain:.2f} s host); reorder='auto' applied "
              f"{entry.reorder!r}: {shape_of(entry)} pick {picks[1]!r} "
              f"({t_auto:.2f} s host: the orderings' candidate inspections; "
              f"inspector_s {entry.inspector_s:.2f})")
        if picks != ("unfused", "cuda"):
            fail(f"phase 11a {name}: picks {picks}, expected ('unfused', "
                 f"'cuda')")
        got, counts = counted(lambda: api.tile_fused_matmul(
            shuffled, b_or_a1, cc, spec=spec_r))
        wf0 = ("tile_fused_spmm_spmm_wf0" if sparse
               else "tile_fused_gemm_spmm_wf0")
        path = ""
        if not sparse:
            ran, rule = gemm_path(entry)
            path = f"; GeMM-SpMM ran {ran} (its rule: {rule})"
            if ran != rule:
                fail(f"phase 11a {name}: ran {ran}, the rule picks {rule}")
        if counts[wf0] == 0:
            fail(f"phase 11a {name}: {wf0} never launched")
        want = api.tile_fused_matmul(shuffled, b_or_a1, cc, backend="torch")
        # the same product on the unshuffled matrix: D_shuffled = D[shuffle]
        if sparse:
            c_orig = torch.empty_like(cs)
            c_orig[shuffle_t] = cs
            d_orig = api.tile_fused_matmul(plain_adj, plain_adj, c_orig)
        else:
            b_orig = torch.empty_like(b)
            b_orig[shuffle_t] = b
            d_orig = api.tile_fused_matmul(plain_adj, b_orig, c)
        err_t = rel_err(got, want)[1]
        err_u = rel_err(got, d_orig[shuffle_t])[1]
        print(f"[11a reorder] {name}: launches {counts}{path}; rel_err vs "
              f"torch={err_t:.2e} vs the unshuffled product={err_u:.2e}")
        if max(err_t, err_u) > MAIN_TOL:
            fail(f"phase 11a {name}: result disagrees")
        del want, d_orig
        arms = {}
        for arm, kw in (("fused, reordered", dict(spec=spec_r)),
                        ("unfused", dict(backend="unfused"))):
            call = (lambda kw=kw: api.tile_fused_matmul(  # noqa: E731
                shuffled, b_or_a1, cc, **kw))
            arms[arm] = (time_ms(call), device_ms(call))
        (ev_f, dv_f), (ev_u, dv_u) = arms.values()
        trace("11a", f"{name}, fused and reordered", lambda: (
            api.tile_fused_matmul(shuffled, b_or_a1, cc, spec=spec_r)))
        print(f"[11a reorder] {name}: per call, fused and reordered "
              f"{ev_f:.4f} ms, unfused without reorder {ev_u:.4f} ms (CUDA "
              f"events, 20 calls); device time {dv_f:.4f} / {dv_u:.4f} ms "
              f"(profiler, 5 calls); fused/unfused {ev_f / ev_u:.3f} "
              f"(events), "
              + (f"{dv_f / dv_u:.3f}" if dv_f > 0 and dv_u > 0 else
                 "not measured") + " (device time)")
        got_g, counts = grads(shuffled, b_or_a1, cc, "auto", spec_r)
        want_g, _ = grads(shuffled, b_or_a1, cc, "torch", api.FusionSpec())
        err = max(rel_err(g, w)[1] for g, w in zip(got_g, want_g))
        e_t = api.get_schedule(shuffled, b_col=128, c_col=128,
                               b_is_sparse=sparse, spec=api.FusionSpec(
                                   reorder="auto", transpose=True,
                                   dtype_bytes=4))
        print(f"[11a reorder] {name} gradients: transpose entry reorder "
              f"{e_t.reorder!r}, {shape_of(e_t)}, pick "
              f"{api.select_backend(e_t, dev)!r}; backward launches "
              f"{counts}; rel_err vs torch={err:.2e}")
        if err > MAIN_TOL:
            fail(f"phase 11a {name}: gradients disagree ({err:.2e})")
        if counts[wf0] == 0:
            fail(f"phase 11a {name}: the backward launched no {wf0}")
        del got, got_g, want_g
        # the kernel at the reordered schedule's shape, against its plain
        # version (not counted)
        for dtype in (torch.float32, torch.bfloat16):
            if sparse:
                a1 = reorder.permute_rows_cached(shuffled,
                                                 entry.reorder_perm)
                case = spmm_spmm_case(" (reordered shuffled banded)",
                                          entry, a1, dtype)
            else:
                case = gemm_case(" (reordered shuffled banded)", entry,
                                     dtype) + (dict(path=gemm_path(
                                         entry, dtype)[1]),)
            records[(case[0], str(dtype).split(".")[1])] = \
                check_case(*case, dtype=dtype, tag="11a kernels")
    del b, c, cs
    pl_adj = models["powerlaw"].adj
    t0 = time.perf_counter()
    entry = api.get_schedule(pl_adj, b_col=128, c_col=128, spec=spec_r)
    print(f"[11a reorder] power-law graph, reorder='auto': "
          + ("no ordering cleared the Eq-3 floor "
             f"({api.MIN_TRAFFIC_SAVING})" if entry.reorder is None
             else f"applied {entry.reorder!r}")
          + f"; {shape_of(entry)}, pick {api.select_backend(entry, dev)!r} "
          f"({time.perf_counter() - t0:.2f} s host)")

    # ---- 11b. autotune ----
    spec_a = api.FusionSpec(autotune=True)
    gcn_adj = models["banded"].adj
    rng11 = np.random.default_rng(111)
    for label, a, b_col, c_col, sparse in (
            ("banded GCN layer 1", gcn_adj, 128, 128, False),
            ("banded GCN layer 2", gcn_adj, 128, 32, False),
            ("banded SpMM-SpMM", banded, 128, 128, True)):
        stats = api.schedule_cache_stats()
        entry = api.get_schedule(a, b_col=b_col, c_col=c_col,
                                 b_is_sparse=sparse, spec=spec_a)
        after = api.schedule_cache_stats()
        sweeps = after["autotune_sweeps"]
        pick = api.select_backend(entry, dev)
        c = dev_tensor(rng11, a.n_cols if sparse else b_col, c_col,
                       scale=1.0 if sparse else b_col ** -0.5)
        b_or_a1 = a if sparse else dev_tensor(rng11, a.n_cols, b_col)
        got, counts = counted(lambda: api.tile_fused_matmul(
            a, b_or_a1, c, spec=spec_a))
        path = ""
        if not sparse and counts["tile_fused_gemm_spmm_wf0"]:
            ran, rule = gemm_path(entry)
            path = f"; GeMM-SpMM ran {ran} (its rule: {rule})"
            if ran != rule:
                fail(f"phase 11b {label}: ran {ran}, the rule picks {rule}")
        want = api.tile_fused_matmul(a, b_or_a1, c, backend="torch")
        err = rel_err(got, want)[1]
        again = api.get_schedule(a, b_col=b_col, c_col=c_col,
                                 b_is_sparse=sparse, spec=spec_a)
        print(f"[11b autotune] {label}: sweep {entry.inspector_s:.2f} s "
              f"host, {after['misses'] - stats['misses']} candidates "
              f"inspected, winner (ct_size, cache_size, width_cap) = "
              f"{entry.autotuned}; {shape_of(entry)}; pick {pick!r}; "
              f"launches {counts}{path}; rel_err vs torch={err:.2e}")
        if err > MAIN_TOL:
            fail(f"phase 11b {label}: result disagrees ({err:.2e})")
        if (again is not entry or entry.autotuned is None
                or api.schedule_cache_stats()["autotune_sweeps"] != sweeps):
            fail(f"phase 11b {label}: the sweep ran again")
        if sum(counts.values()) == 0:
            fail(f"phase 11b {label}: no kernel launched")
        del got, want
    sweeps = api.schedule_cache_stats()["autotune_sweeps"]
    model = GCN(cfg, banded, spec=spec_a, seed=0, device=dev)
    req_rng = np.random.default_rng(112)
    lat, per_req, errs = [], [], []
    for _ in range(REQUESTS):
        x = dev_tensor(req_rng, N_NODES, cfg.in_dim)
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, counts = counted(lambda: model(x))
            lat.append((time.perf_counter() - t0) * 1e3)
            want = model(x, backend="torch")
        per_req.append(counts)
        errs.append(rel_err(logits, want)[1])
    print(f"[11b autotune] GCN with FusionSpec(autotune=True): layer "
          f"winners {[e.autotuned for e in model.entries]}, picks "
          f"{model.layer_backends()}; {REQUESTS} requests p50="
          f"{float(np.median(lat)):.3f} ms; launches per request "
          f"{per_req[-1]}; max rel_err vs torch {max(errs):.2e}; sweeps "
          f"while building it {api.schedule_cache_stats()['autotune_sweeps'] - sweeps}")
    with torch.inference_mode():
        trace("11b", "autotuned GCN request", lambda: model(x))
    if max(errs) > MAIN_TOL:
        fail("phase 11b: an autotuned GCN request disagrees")
    if api.schedule_cache_stats()["autotune_sweeps"] != sweeps:
        fail("phase 11b: the GCN swept its layer shapes again")
    if any(p["spmm_ell"] == 0 for p in per_req):
        fail("phase 11b: an autotuned GCN request launched no spmm_ell")
    del model

    # ---- 11c. the hetero stack: a graph shaped like ogbn-mag ----
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph = mag_graph(seed=0)
    t_graph = time.perf_counter() - t0
    misses = api.schedule_cache_stats()["misses"]
    in_dims = dict.fromkeys(graph.node_counts, MAG_WIDTH)
    t0 = time.perf_counter()
    layer = HeteroGCNLayer(graph, in_dims, MAG_WIDTH, seed=0, device=dev)
    t_build = time.perf_counter() - t0
    inspections = api.schedule_cache_stats()["misses"] - misses
    entry, stack = layer.entry, layer.stack
    print(f"[11c hetero] ogbn-mag shape cut to 1/{MAG_CUT} of its node and "
          f"edge counts: nodes {graph.node_counts}, {len(graph.relations)} "
          f"relations, {sum(a.nnz for a in graph.relations.values())} edges"
          f" ({t_graph:.2f} s host); stack {stack.a.n_rows} rows, "
          f"{stack.a.nnz} nnz, b_col {entry.b_col}; {inspections} stacked "
          f"inspection ({t_build:.2f} s host to build the layer); "
          f"{shape_of(entry)}; Eq-3 pick {api.select_backend(entry, dev)!r}"
          f" (cut 1/{MAG_CUT})")
    if inspections != 1:
        fail(f"phase 11c: {inspections} inspections for one relation set")
    t0 = time.perf_counter()
    for _ in range(5):
        api.select_backend(entry, dev)
    pick_us = (time.perf_counter() - t0) / 5 * 1e6
    print(f"[11c hetero] host time of one select_backend call on the stack "
          f"{pick_us:.1f} us ({entry.dsched.n_tiles0} wavefront-0 tiles)")
    feat_rng = np.random.default_rng(113)
    feats = {t: dev_tensor(feat_rng, n, MAG_WIDTH)
             for t, n in graph.node_counts.items()}
    misses = api.schedule_cache_stats()["misses"]
    with torch.inference_mode():
        plain = layer(feats, backend="torch")
        loop = layer.reference(feats)
        for backend in ("auto", "cuda"):
            out, counts = counted(lambda: layer(feats, backend=backend))
            path = ""
            if backend == "cuda":
                ran, rule = gemm_path(entry)
                path = f"; GeMM-SpMM ran {ran} (its rule: {rule})"
                if counts["tile_fused_gemm_spmm_wf0"] == 0 or ran != rule:
                    fail(f"phase 11c: backend='cuda' launched "
                         f"{counts} and ran {ran}")
            errs = [max(rel_err(out[t], oracle[t])[1] for t in oracle)
                    for oracle in (loop, plain)]
            print(f"[11c hetero] HeteroGCNLayer backend={backend!r}: "
                  f"launches {counts}{path}; rel_err vs the loop "
                  f"(layer.reference) {errs[0]:.2e}, vs backend='torch' "
                  f"{errs[1]:.2e} (cut 1/{MAG_CUT})")
            if counts["spmm_ell"] == 0:
                fail(f"phase 11c {backend}: no spmm_ell launch")
            if max(errs) > MAIN_TOL:
                fail(f"phase 11c {backend}: result disagrees")
            del out
    del plain, loop
    misses = api.schedule_cache_stats()["misses"] - misses
    print(f"[11c hetero] schedule inspections in the forwards after the "
          f"layer was built: {misses}")
    if misses:
        fail(f"phase 11c: the forwards inspected {misses} schedules; the "
             f"layer's warm-up entry should serve them")
    wgrads = {}
    for backend in ("auto", "torch"):
        for w in layer.weights:
            w.grad = None

        def step():
            sum((v ** 2).sum() for v in layer(
                feats, backend=backend).values()).backward()
        if backend == "torch":
            step()
        else:
            _, counts = counted(step)
        wgrads[backend] = [w.grad.clone() for w in layer.weights]
    err = max(rel_err(g, w)[1] for g, w in zip(*wgrads.values()))
    print(f"[11c hetero] weight gradients (loss Σ out²), backend='auto' "
          f"vs 'torch': rel_err {err:.2e}; launches {counts} (cut "
          f"1/{MAG_CUT})")
    if err > MAIN_TOL:
        fail(f"phase 11c: weight gradients disagree ({err:.2e})")
    del wgrads
    for w in layer.weights:
        w.grad = None
    relations = [(layer.adjs[k], feats[k[0]], w)
                 for k, w in zip(layer.rel_keys, layer.weights)]

    def p50_ms(fn, calls=8):
        out = []
        for _ in range(calls):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return float(np.median(out))
    with torch.inference_mode():
        trace("11c", "stacked HeteroGCNLayer forward (auto)",
              lambda: layer(feats))
        trace("11c", "hetero_loop_matmul layer forward (auto)",
              lambda: layer.combine(hetero.hetero_loop_matmul(
                  relations, spec=layer.spec)))
        stacked_ms = p50_ms(lambda: layer(feats))
        layer(feats, backend="cuda")
        stacked_cuda_ms = p50_ms(lambda: layer(feats, backend="cuda"))
        layer.combine(hetero.hetero_loop_matmul(relations, spec=layer.spec))
        loop_ms = p50_ms(lambda: layer.combine(hetero.hetero_loop_matmul(
            relations, spec=layer.spec)))
    print(f"[11c hetero] stacked layer p50 {stacked_ms:.3f} ms (auto), "
          f"{stacked_cuda_ms:.3f} ms (backend='cuda': the wide GeMM-SpMM) vs "
          f"hetero_loop_matmul (8 dispatches) p50 {loop_ms:.3f} ms (CUDA "
          f"events, 8 calls each, after one warm-up); "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB (cut 1/{MAG_CUT})")
    # the stack's shapes of two kernels, against their plain versions (not
    # counted; f32, the layer's dtype)
    f32 = torch.float32
    if gemm_path(entry)[1] != GEMM_WIDE:
        fail(f"phase 11c: the rule picks {gemm_path(entry)[1]} for the "
             f"stack, not {GEMM_WIDE}")
    for case in (gemm_case(" (mag-shaped stack, b_col 1024)", entry, f32)
                 + (dict(path=gemm_path(entry)[1]),),
                 full_hybrid_case(
                     f"spmm_ell (mag-shaped stack hybrid, {MAG_WIDTH} "
                     f"columns)", stack.a, MAG_WIDTH, f32)):
        rec = records[(case[0], "float32")] = check_case(
            *case, dtype=f32, tag="11c kernels")
        if case[0].startswith("tile_fused_gemm_spmm_wf0"):
            print(f"[11c kernels] {case[0]}: {rec['ms']:.4f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), share "
                  f"{rec['bound_ms'] / rec['ms']:.3f}, plain "
                  f"{rec['plain_ms']:.4f} ms, matmul + sparse.mm "
                  f"{rec['library_ms']:.4f} ms; the CUDA-core kernel took "
                  f"{CORE_MS_BEFORE['mag-shaped stack']} ms here (PR 18, "
                  f"PERF.md; not re-run)")
    del layer, feats, relations
    torch.cuda.empty_cache()

    # the SpMM-SpMM stack: CSR op-1s, one fused dispatch
    rng11 = np.random.default_rng(114)
    rels = [(normalize_adjacency(powerlaw_graph(HETERO_NODES, 8, seed=r)),
             powerlaw_graph(HETERO_NODES, 8, seed=100 + r),
             dev_tensor(rng11, HETERO_NODES, 128))
            for r in range(HETERO_RELATIONS)]
    got, counts = counted(lambda: hetero.hetero_fused_matmul(
        rels, backend="cuda"))
    want = hetero.hetero_loop_matmul(rels, backend="torch")
    err = max(rel_err(g, w)[1] for g, w in zip(got, want))
    ss_stack = hetero.stack_adjacencies([r[0] for r in rels])
    st_entry = api.get_schedule(ss_stack.a, b_col=128, c_col=128,
                                b_is_sparse=True,
                                spec=api.FusionSpec(dtype_bytes=4))
    print(f"[11c hetero] SpMM-SpMM stack: {HETERO_RELATIONS} power-law "
          f"relations of {HETERO_NODES} nodes, "
          f"{HETERO_RELATIONS * HETERO_NODES} stacked rows, 128 columns, "
          f"backend='cuda': {shape_of(st_entry)}; launches {counts}; "
          f"rel_err vs the loop on backend='torch' {err:.2e}")
    if counts["tile_fused_spmm_spmm_wf0"] == 0 or err > MAIN_TOL:
        fail(f"phase 11c SpMM-SpMM stack: launches {counts}, rel err "
             f"{err:.2e}")
    del got, want
    # the kernel at the stack's shape, on the stack's own entry and stacked
    # op 1, against its plain version (not counted; f32, the inputs' dtype)
    case = spmm_spmm_case(" (power-law SpMM-SpMM stack)", st_entry,
                          hetero._stack_op1(ss_stack, [r[1] for r in rels]),
                          f32)
    records[(case[0], "float32")] = check_case(*case, dtype=f32,
                                               tag="11c kernels")
    print(f"[11] kernel launches in phase 11's counted paths: {launches}")
    for k, v in launches.items():
        if v == 0:
            fail(f"phase 11: {k} never launched")
        path_launches[k] += v
    print(f"[11] phase 11 took {time.perf_counter() - t11:.1f} s")

    # ---- 12. the serving tier ----
    # A stream of subgraph requests through ``ServingTier`` (12a GeMM-SpMM,
    # 12b SpMM-SpMM), then the CLI's ``--subgraphs`` stream and the same
    # front end on the banded windows (12c).  Each request is counted on
    # its own (counts set to 0 just before, read just after); the checks
    # against the plain executor and the host oracle are not counted.
    t12 = time.perf_counter()
    from repro_torch.core.sparse.random import induced_subgraph, perturb_rows
    from repro_torch.core.tilefusion import serving
    from repro_torch.core.tilefusion.cost_model import serving_bucket_price
    launches12 = dict.fromkeys(GCN_KERNELS, 0)
    t0 = time.perf_counter()
    base12 = banded_spd(SERVE_BASE_NODES, 8, seed=0)
    windows12 = [induced_subgraph(base12, s, n) for s, n in SERVE_WINDOWS]
    print(f"[12 setup] banded_spd({SERVE_BASE_NODES}, 8): nnz {base12.nnz}; "
          f"windows {[(w.n_rows, w.nnz) for w in windows12]} in "
          f"{time.perf_counter() - t0:.2f} s host")

    def drift(rng, windows, n_requests):
        """The reference CLI's drift: at 10 % a jump to another window, at
        30 % a re-sample of ``n_rows // 50`` rows, else the same pattern."""
        current = windows[0]
        for i in range(n_requests):
            r = rng.random()
            if r < 0.1 and i:
                current = windows[int(rng.integers(len(windows)))]
            elif r < 0.4:
                current = perturb_rows(
                    current, rng.choice(current.n_rows, current.n_rows // 50,
                                        replace=False),
                    seed=int(rng.integers(1 << 31)))
            yield current

    def served_as(tier, before):
        for how, key in (("hit", "exact_hits"), ("incremental", "incremental"),
                         ("rebuild", "rebuilds")):
            if tier.stats[key] != before[key]:
                return how
        fail("phase 12: a request was not counted by the tier")

    def wf1_rows(entry):
        wf1 = entry.sched.wavefronts[1]
        return set(np.concatenate([tl.j_rows for tl in wf1]).tolist()
                   if wf1 else [])

    def pct(values, q):
        return float(np.percentile(values, q))

    def report_by_kind(tag, rows):
        """Per-request wall p50 / max by how it was served and the arm
        Eq-3 picked, launches per request and the device functions
        taken."""
        for how, pick in itertools.product(("hit", "incremental", "rebuild"),
                                           ("cuda", "unfused")):
            mine = [r for r in rows if (r["how"], r["pick"]) == (how, pick)]
            if not mine:
                continue
            walls = [r["wall_ms"] for r in mine]
            kinds = sorted({tuple(sorted(r["launches"].items()))
                            for r in mine})
            paths = sorted({r["paths"] for r in mine})
            print(f"[{tag}] {how} on {pick}: {len(walls)} requests, wall p50 "
                  f"{pct(walls, 50):.3f} ms, max {max(walls):.3f} ms; launches "
                  f"per request {[dict(k) for k in kinds]}; device functions "
                  f"{paths}")

    def tier_phase(tag, op_pair, n_requests, seed):
        """12a / 12b: a drifting stream through a ``ServingTier`` at 128
        columns, f32, ``backend="auto"``."""
        sparse = op_pair == "spmm"
        wf0 = ("tile_fused_spmm_spmm_wf0" if sparse
               else "tile_fused_gemm_spmm_wf0")
        api.clear_schedule_cache()
        tier = serving.ServingTier(
            b_col=SERVE_COLS, c_col=SERVE_COLS, b_is_sparse=sparse,
            **({} if sparse else dict(cache_size=SERVE_GEMM_CACHE)))
        for w in windows12:
            bucket = tier.bucket_for(w)
            price = serving_bucket_price(
                n_rows=w.n_rows, n_pad=tier._quantize(w.n_rows), nnz=w.nnz,
                b_col=tier.b_col, c_col=tier.c_col,
                expected_reuse=tier.expected_reuse)
            print(f"[{tag} buckets] window {w.n_rows} rows, {w.nnz} nnz -> "
                  f"bucket {bucket}: pad {price['pad_elements_per_call']:.0f}"
                  f" elements a call vs inspection "
                  f"{price['inspect_elements_per_call']:.0f} a call "
                  f"(bucketed={price['bucketed']}, break-even reuse "
                  f"{price['break_even_reuse']:.2f})")
        rng12 = np.random.default_rng(seed)
        gen12 = torch.Generator(device=dev).manual_seed(seed)
        rows, resident_wf1, first_patch = [], {}, None
        for i, a in enumerate(drift(rng12, windows12, n_requests)):
            c = torch.randn((a.n_cols if sparse else SERVE_COLS, SERVE_COLS),
                            generator=gen12, device=dev)
            c *= SERVE_COLS ** -0.5
            op1 = a if sparse else torch.randn((a.n_cols, SERVE_COLS),
                                               generator=gen12, device=dev)
            before = dict(tier.stats)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            d = tier.matmul(a, op1, c)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = {k: ops.launch_counts()[k] for k in GCN_KERNELS}
            for k, v in counts.items():
                launches12[k] += v
            how = served_as(tier, before)
            bucket = tier.bucket_for(a)
            res = tier._residents[bucket]
            entry = res.entry
            paths = (spmm_last_path(),
                     "tile_fused_spmm_spmm_wf0_kernel" if sparse
                     else gemm_last_path())
            # a drifted pattern may fall below the Eq-3 floor and run the
            # unfused arm (hybrid products on spmm_ell); the kernels each
            # request launched are the ones its pick names
            pick = api.select_backend(entry, dev)
            fused = pick == "cuda"
            if (pick not in ("cuda", "unfused") or counts[wf0] != int(fused)
                    or counts["spmm_ell"] != (1 if fused else 1 + sparse)):
                fail(f"phase {tag} request {i}: pick {pick!r}, launches "
                     f"{counts}")
            if fused and not sparse and paths[1] != GEMM_WGMMA:
                fail(f"phase {tag} request {i}: GeMM-SpMM ran {paths[1]}")
            if i == 0 and not fused:
                fail(f"phase {tag}: the first window picked {pick!r}")
            moved = 0
            if how == "incremental":
                moved = len(wf1_rows(entry) - resident_wf1.get(bucket, set()))
            resident_wf1[bucket] = wf1_rows(entry)
            if how == "incremental" and first_patch is None:
                first_patch = (a, res.a)
            # backend="torch" on the same entry, operands padded as the
            # tier pads them (not counted)
            if sparse:
                cp = F.pad(c, (0, 0, 0, res.a.n_cols - c.shape[0]))
                want = fused_ops.fused_spmm_spmm(entry.dsched, res.a, cp)
            else:
                bp = F.pad(op1, (0, 0, 0, res.a.n_cols - op1.shape[0]))
                want = fused_ops.fused_gemm_spmm(entry.dsched, bp, c)
            err = rel_err(d, want[: a.n_rows])[1]
            if d.shape != (a.n_rows, SERVE_COLS) or err > TOL["float32"]:
                fail(f"phase {tag} request {i} ({how}): rel err {err:.2e} "
                     f"against backend='torch' on the same entry")
            err_h = None
            if i % SERVE_CHECK_EVERY == 0:
                c_np = c.double().cpu().numpy()
                host = (fused_ref.unfused_spmm_spmm(a, a, c_np) if sparse
                        else fused_ref.unfused_gemm_spmm(
                            a, op1.double().cpu().numpy(), c_np))
                err_h = rel_err(d.cpu().double(), torch.from_numpy(host))[1]
                if err_h > MAIN_TOL:
                    fail(f"phase {tag} request {i}: rel err {err_h:.2e} "
                         f"against the f64 host product")
            rows.append(dict(how=how, pick=pick, wall_ms=wall,
                             launches=counts, paths=paths if fused
                             else (paths[0], "none"), err=err, err_h=err_h,
                             moved=moved, inspect_s=entry.inspector_s,
                             saving=entry.traffic_model["traffic_saving"]))
        hows = [r["how"] for r in rows]
        served = " ".join(
            r["how"][0] + ("" if r["pick"] == "cuda" else "U")
            + f"{r['saving']:.2f}" for r in rows)
        print(f"[{tag}] served as: {served} (h hit, i incremental, r "
              f"rebuild; U: Eq-3 picked unfused; the entry's Eq-3 saving); "
              f"rows moved into wavefront 1 by each patch: "
              f"{[r['moved'] for r in rows if r['how'] == 'incremental']}")
        print(f"[{tag}] rel err vs backend='torch' max "
              f"{max(r['err'] for r in rows):.2e}; vs the f64 host product "
              f"max {max(r['err_h'] for r in rows if r['err_h'] is not None):.2e}"
              f" ({sum(r['err_h'] is not None for r in rows)} checked)")
        report_by_kind(tag, rows)
        st = api.schedule_cache_stats()
        print(f"[{tag}] tier stats {tier.stats}, hit rate "
              f"{tier.hit_rate():.3f}; schedule_cache_stats {st}")
        on_card = {r["how"] for r in rows if r["pick"] == "cuda"}
        if not ({"hit", "incremental", "rebuild"} <= on_card
                and any(r["moved"] and r["pick"] == "cuda" for r in rows)):
            fail(f"phase {tag}: the stream lacks a hit, a patch that moved "
                 f"rows into wavefront 1, or a rebuild on the fused arm: "
                 f"{hows}")
        if st["bucket_entries"] != 1:
            fail(f"phase {tag}: {st['bucket_entries']} bucket entries, "
                 f"expected 1")
        # host seconds: the patch against a full inspection of the same
        # pattern (content-keyed, so the bucket entry is not touched)
        patch_s = [r["inspect_s"] for r in rows if r["how"] == "incremental"]
        rebuild_s = [r["inspect_s"] for r in rows if r["how"] == "rebuild"]
        a_inc, ap_inc = first_patch
        t0 = time.perf_counter()
        full = api.get_schedule(ap_inc, b_col=tier.b_col, c_col=tier.c_col,
                                b_is_sparse=sparse, spec=tier._spec(
                                    width_cap=tier.bucket_for(a_inc)[2]))
        full_s = time.perf_counter() - t0
        print(f"[{tag}] host seconds: incremental_update p50 "
              f"{pct(patch_s, 50):.4f} (max {max(patch_s):.4f}); a rebuild's "
              f"inspection p50 {pct(rebuild_s, 50):.4f}; a full get_schedule "
              f"of a patched pattern {full_s:.4f} ({full.inspector_s:.4f} "
              f"inspecting)")
        # the host costs of every request and of a patched one: the bucket
        # digest (pad_csr + csr_content_digest of a fresh CSR object), and
        # the whole re-upload of a patched schedule (a fresh object of the
        # entry's arrays: device copies and the tail plan)
        fresh = type(a)(a.n_rows, a.n_cols, a.indptr, a.indices, a.data)
        bucket = tier.bucket_for(a)
        t0 = time.perf_counter()
        csr_content_digest(serving.pad_csr(fresh, bucket[0], bucket[1]))
        digest_ms = (time.perf_counter() - t0) * 1e3
        resident = tier._residents[bucket].entry
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = fused_ops.schedule_tensors(
            dataclasses.replace(resident.dsched), dev, torch.float32)
        _ = st.tails1, st.j_rows1_32
        torch.cuda.synchronize()
        upload_ms = (time.perf_counter() - t0) * 1e3
        print(f"[{tag}] host ms a request: pad_csr + digest of the padded "
              f"pattern {digest_ms:.2f}; re-upload of the resident "
              f"schedule with its tail plan {upload_ms:.2f}")
        # one profiled request of each kind, each after a hit as the
        # warm-up: a rebuild (a window of another row count), a patch of
        # it (fresh headroom), then that pattern again
        other = next(w for w in windows12 if w.n_rows != a.n_rows)
        patched = perturb_rows(other, rng12.choice(
            other.n_rows, other.n_rows // 50, replace=False), seed=seed)
        op1_o = other if sparse else torch.randn(
            (other.n_cols, SERVE_COLS), generator=gen12, device=dev)
        c_o = torch.randn((other.n_cols if sparse else SERVE_COLS,
                           SERVE_COLS), generator=gen12, device=dev)

        def request(pattern):
            return lambda: tier.matmul(pattern, pattern if sparse else op1_o,
                                       c_o)
        last = (a, op1, c)
        for how, warm, fn in (
                ("rebuild", lambda: tier.matmul(*last), request(other)),
                ("incremental", request(other), request(patched)),
                ("hit", request(patched), request(patched))):
            before = dict(tier.stats)
            _, _, calls, _ = trace(tag, f"a {how} request", fn,
                                   warm=warm)
            key = {"hit": "exact_hits", "incremental": "incremental",
                   "rebuild": "rebuilds"}[how]
            delta = {k: tier.stats[k] - before[k] for k in before}
            want = dict(requests=2, exact_hits=1 + (how == "hit"),
                        incremental=0, rebuilds=0)
            want[key] += how != "hit"
            # op 1's dense spill delta of the SpMM-SpMM kernel is the one
            # scatter-add left (fused_ops.op1_spill); wavefront 1's tails
            # run inside spmm_ell
            adds = calls.get("aten::index_add_", 0)
            print(f"[{tag} trace] a {how} request: tier counted {delta}; "
                  f"index_add_ x{adds}, index_copy_ x"
                  f"{calls.get('aten::index_copy_', 0)}")
            if delta != want:
                fail(f"phase {tag}: the profiled {how} request was served "
                     f"as {delta}")
            if adds > int(sparse):
                fail(f"phase {tag}: {adds} index_add_ in a {how} request")

    tier_phase("12a", "gemm", SERVE_REQUESTS["gemm"], 120)
    tier_phase("12b", "spmm", SERVE_REQUESTS["spmm"], 121)

    # ---- 12c. the CLI's --subgraphs stream, and the front end on the
    # banded windows ----
    def flush_checker(tag, state):
        """``on_flush`` for the CLI: each output against a per-request
        ``backend="torch"`` run (uncounted: the checks launch no kernel,
        which is checked), the dispatches' launches and the wall between
        flushes (the host's feature generation included)."""
        def on_flush(requests, outs):
            torch.cuda.synchronize()
            now = time.perf_counter()
            state["walls"].append((now - state["t"]) * 1e3)
            counts = {k: ops.launch_counts()[k] for k in GCN_KERNELS}
            state["launches"].append({k: v - state["seen"][k]
                                      for k, v in counts.items()})
            state["paths"].add(spmm_last_path())
            for (a, feats, w), out in zip(requests, outs):
                want = api.tile_fused_matmul(
                    a, torch.as_tensor(np.asarray(feats, np.float32)).to(dev),
                    torch.as_tensor(np.asarray(w, np.float32)).to(dev),
                    backend="torch")
                err = rel_err(out, want)[1]
                state["errs"].append(err)
                if out.shape != want.shape or err > TOL["float32"]:
                    fail(f"phase {tag}: a flushed output disagrees with "
                         f"backend='torch' (rel err {err:.2e})")
            torch.cuda.synchronize()
            if {k: ops.launch_counts()[k] for k in GCN_KERNELS} != counts:
                fail(f"phase {tag}: the checks launched a kernel")
            state["seen"] = counts
            state["t"] = time.perf_counter()
        return on_flush

    api.clear_schedule_cache()
    argv = ["--subgraphs", str(SERVE_CLI_REQUESTS), "--subgraph-nodes",
            str(SERVE_CLI_NODES), "--feat-dim", str(SERVE_COLS),
            "--out-dim", str(SERVE_COLS), "--max-batch", str(SERVE_BATCH),
            "--device", str(dev)]
    print(f"[12c] launch.serve.main({argv})")
    state = dict(walls=[], launches=[], paths=set(), errs=[],
                 seen=dict.fromkeys(GCN_KERNELS, 0))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    state["t"] = t0 = time.perf_counter()
    fe = serve.main(argv, on_flush=flush_checker("12c", state))
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = {k: ops.launch_counts()[k] for k in GCN_KERNELS}
    for k, v in counts.items():
        launches12[k] += v
    st = api.schedule_cache_stats()
    entry = next(r.entry for r in fe.tier._residents.values())
    print(f"[12c] CLI: {cli_s:.2f} s with its checks; {fe.batches} "
          f"dispatches for {fe.tier.stats['requests']} requests; tier stats "
          f"{fe.tier.stats}, hit rate {fe.tier.hit_rate():.3f}; buckets "
          f"{sorted(fe.tier._residents)}; pick "
          f"{api.select_backend(entry, dev)} (fused ratio "
          f"{entry.sched.fused_ratio:.4f}, saving "
          f"{entry.traffic_model['traffic_saving']:.4f}); "
          f"schedule_cache_stats {st}")
    print(f"[12c] CLI: flush-to-flush wall p50 {pct(state['walls'], 50):.2f}"
          f" ms, max {max(state['walls']):.2f} ms; launches per flush "
          f"{[tuple(c.values()) for c in state['launches']]} "
          f"{tuple(GCN_KERNELS)}; spmm_ell paths {sorted(state['paths'])}; "
          f"rel err vs backend='torch' max {max(state['errs']):.2e}")
    if counts["spmm_ell"] < fe.batches or len(state["errs"]) != \
            SERVE_CLI_REQUESTS:
        fail(f"phase 12c: CLI launches {counts} for {fe.batches} "
             f"dispatches, {len(state['errs'])} outputs checked")

    # the same front end on the banded windows: stacked 512 / 512, the
    # wide GeMM-SpMM; features made on the card (not copied)
    api.clear_schedule_cache()
    fe = serve.SubgraphFrontEnd(SERVE_COLS, SERVE_COLS, SERVE_BATCH,
                                device=dev)
    print(f"[12c banded] buckets at {fe.tier.b_col} / {fe.tier.c_col}: "
          f"{[fe.tier.bucket_for(w) for w in windows12]}")
    rng12 = np.random.default_rng(122)
    gen12 = torch.Generator(device=dev).manual_seed(122)
    stream = drift(rng12, windows12, SERVE_FE_REQUESTS)
    rows, errs = [], []
    for lo in range(0, SERVE_FE_REQUESTS, SERVE_BATCH):
        reqs = []
        for a in itertools.islice(stream, SERVE_BATCH):
            feats = torch.randn((a.n_cols, SERVE_COLS), generator=gen12,
                                device=dev)
            w = torch.randn((SERVE_COLS, SERVE_COLS), generator=gen12,
                            device=dev) * SERVE_COLS ** -0.5
            fe.submit(a, feats, w)
            if fe._queue[-1][1] is not feats:
                fail("phase 12c: the front end copied a device tensor")
            reqs.append((a, feats, w))
        before = dict(fe.tier.stats)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs = fe.flush()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = {k: ops.launch_counts()[k] for k in GCN_KERNELS}
        for k, v in counts.items():
            launches12[k] += v
        hows = {k: fe.tier.stats[k] - before[k] for k in before}
        rows.append(dict(wall_ms=wall, launches=tuple(counts.values()),
                         hows=tuple(hows.values())[1:],
                         path=gemm_last_path()
                         if counts["tile_fused_gemm_spmm_wf0"] else None))
        for (a, feats, w), out in zip(reqs, outs):
            want = api.tile_fused_matmul(a, feats, w, backend="torch")
            errs.append(rel_err(out, want)[1])
            if out.device.type != dev.type or out.shape != want.shape:
                fail("phase 12c banded: an output is not on the card")
        if rows[-1]["path"] not in (None, GEMM_WIDE):
            fail(f"phase 12c banded: GeMM-SpMM ran {rows[-1]['path']}")
    entry = next(r.entry for r in fe.tier._residents.values())
    print(f"[12c banded] {len(errs)} requests in {fe.batches} dispatches: "
          f"flush wall {[round(r['wall_ms'], 2) for r in rows]} ms; served "
          f"(hit, incremental, rebuild) {[r['hows'] for r in rows]}; "
          f"launches {[r['launches'] for r in rows]} {tuple(GCN_KERNELS)}; "
          f"device function {sorted({str(r['path']) for r in rows})}; pick "
          f"{api.select_backend(entry, dev)} (t {entry.dsched.t_pad}, fused "
          f"ratio {entry.sched.fused_ratio:.3f}); rel err vs backend='torch'"
          f" max {max(errs):.2e}; schedule_cache_stats "
          f"{api.schedule_cache_stats()}")
    wf0_runs = sum(r["path"] is not None for r in rows)
    if max(errs) > TOL["float32"] or not wf0_runs:
        fail(f"phase 12c banded: rel err {max(errs):.2e}, GeMM-SpMM in "
             f"{wf0_runs} flushes")

    print(f"[12] kernel launches in phase 12's counted paths: {launches12}")
    for k, v in launches12.items():
        if v == 0:
            fail(f"phase 12: {k} never launched")
        path_launches[k] += v
    print(f"[12] phase 12 took {time.perf_counter() - t12:.1f} s")

    # ---- 13. sharded tile fusion: meshes of shards that share the card ----
    # Every mesh repeats this one card, as the reference's forced host
    # platform repeats the CPU: the shards run one after another, so no
    # speed-up can come of them, and the walls below are what they are.
    # The counts are set to 0 around each counted call and add to the
    # phase's launches; the single-device arms and the oracles are not
    # counted.
    t13 = time.perf_counter()
    from repro_torch.models import sharding
    launches13 = dict.fromkeys(GCN_KERNELS, 0)
    card = f"cuda:{torch.cuda.current_device()}"
    print(f"[13] every mesh below repeats {card}: the shards share one card "
          f"and run one after another")

    def card_mesh(shape):
        return sharding.Mesh(np.full(shape, card, dtype=object),
                             ("x", "y", "z")[:len(shape)])

    def counted13(fn):
        """``(fn(), launches, collective bytes)``, counts set to 0 just
        before and read just after; a plain executor raises meanwhile."""
        plain = {n: getattr(fused_ops, n) for n in
                 ("fused_gemm_spmm", "fused_spmm_spmm", "_ell_rows")}

        def refuse(*args, **kwargs):
            fail("phase 13: a plain executor ran on the card")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        sharding.reset_comm_bytes()
        for n in plain:
            setattr(fused_ops, n, refuse)
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            for n, f in plain.items():
                setattr(fused_ops, n, f)
        counts = {k: ops.launch_counts()[k] for k in GCN_KERNELS}
        for k, v in counts.items():
            launches13[k] += v
        return out, counts, dict(sharding.comm_bytes)

    # ---- 13a. tile_fused_matmul on the three rungs ----
    adj13 = models["banded"].adj
    cases13 = [
        ("GeMM-SpMM", torch.from_numpy(b_np).to(dev),
         torch.from_numpy(c_np).to(dev), "tile_fused_gemm_spmm_wf0",
         lambda: fused_ref.unfused_gemm_spmm(adj13, b_np, c_np)),
        ("SpMM-SpMM", adj13, torch.from_numpy(cs_np).to(dev),
         "tile_fused_spmm_spmm_wf0",
         lambda: fused_ref.unfused_spmm_spmm(adj13, adj13, cs_np))]
    meshes13 = {"1d": ((4,), (4, 1, 1)), "1.5d": ((2, 2), (2, 2, 1)),
                "2.5d": ((2, 2, 2), (2, 2, 2))}
    build_s = []
    for name, b_or_a1, c, wf0, oracle in cases13:
        sparse = b_or_a1 is adj13
        want = api.tile_fused_matmul(adj13, b_or_a1, c, backend="cuda")
        # the f64 oracle, compared on the card in f32 as ``rel_err`` does
        host = torch.from_numpy(oracle()).to(dev, torch.float32)
        for layout, (shape, parts) in meshes13.items():
            outs = {}
            for combine, overlap in itertools.product(
                    ("psum", "reduce_scatter"), (False, True)):
                spec = api.FusionSpec(mesh=card_mesh(shape),
                                      shard_layout=layout,
                                      shard_combine=combine, overlap=overlap)
                t0 = time.perf_counter()
                entry = api.get_schedule(
                    adj13, b_col=128, c_col=128, b_is_sparse=sparse,
                    spec=dataclasses.replace(spec, dtype_bytes=4))
                build_s.append(time.perf_counter() - t0)
                sh = entry.shard
                got_parts = (sh.n_shards, sh.n_repl, sh.n_depth)
                if sh.layout != layout or got_parts != parts:
                    fail(f"phase 13a {name} {layout}: the entry is "
                         f"{sh.layout} {got_parts}, expected {parts}")
                if api.select_backend(entry, dev) != "sharded":
                    fail(f"phase 13a {name} {layout}: auto does not pick "
                         f"'sharded'")
                t0 = time.perf_counter()
                got, counts, comm = counted13(
                    lambda: api.tile_fused_matmul(adj13, b_or_a1, c,
                                                  spec=spec))
                wall = (time.perf_counter() - t0) * 1e3
                n_dev = int(np.prod(shape))
                n_wf1 = n_dev if sh.halo_size and sh.wf1_per_shard else 0
                err_d = rel_err(got, want)[1]
                err_h = rel_err(got, host)[1]
                cm = sh.comm_model
                arm_bytes = (cm["combine_bytes"] if combine == "psum"
                             else cm["combine_bytes_reduce_scatter"])
                print(f"[13a] {name} {layout} mesh {shape} {combine} "
                      f"overlap={overlap}: tiles/shard {sh.tiles_per_shard}"
                      f" wf1/group {sh.wf1_per_shard} halo {sh.halo_size} "
                      f"rows (send {sh.send_per_shard}/shard) spill lanes/"
                      f"group {sh.spill_per_shard}; launches {counts} "
                      f"(expected {wf0} {n_dev}, spmm_ell {n_wf1}); rel err "
                      f"vs cuda arm {err_d:.2e}, vs f64 oracle {err_h:.2e};"
                      f" wall {wall:.2f} ms (the entry's first call, with "
                      f"its shards' uploads)")
                print(f"[13a]   collective bytes counted: all_gather "
                      f"{comm['all_gather']} psum {comm['psum']} gather "
                      f"{comm['gather']}; shard_comm_model: halo_bytes "
                      f"{cm['halo_bytes']:.0f}, {combine} combine "
                      f"{arm_bytes:.0f}, depth_combine_bytes "
                      f"{cm['depth_combine_bytes']:.0f}")
                if counts[wf0] != n_dev or counts["spmm_ell"] != n_wf1:
                    fail(f"phase 13a {name} {layout} {combine}: launches "
                         f"{counts}")
                if err_d > TOL["float32"] or err_h > MAIN_TOL:
                    fail(f"phase 13a {name} {layout} {combine} overlap="
                         f"{overlap}: rel err {err_d:.2e} / {err_h:.2e}")
                outs[combine, overlap] = got
            for combine in ("psum", "reduce_scatter"):
                off, on = outs[combine, False], outs[combine, True]
                err = rel_err(on, off)[1]
                print(f"[13a] {name} {layout} {combine}: overlap vs sync "
                      f"rel {err:.2e}, bit for bit: {torch.equal(on, off)}")
                if err > 1e-6:
                    fail(f"phase 13a {name} {layout} {combine}: overlap "
                         f"and sync differ ({err:.2e})")
            del outs
        del want, host
    print(f"[13a] took {time.perf_counter() - t13:.1f} s; "
          f"build_sharded_schedule at {adj13.n_rows} rows: "
          f"{len(build_s)} entries, {min(build_s):.3f}-{max(build_s):.3f} s "
          f"each (host)")

    # gradients of both op pairs on the 1d mesh against the one-device arm
    mesh1d = card_mesh((4,))
    wgt = torch.linspace(-1.0, 1.0, N_NODES * 128, device=dev).view(
        N_NODES, 128)
    for name, b_or_a1, c, wf0, _ in cases13:
        sparse = b_or_a1 is adj13
        res = []
        for spec in (api.FusionSpec(mesh=mesh1d), api.FusionSpec()):
            leaves = [x.detach().clone().requires_grad_()
                      for x in ((c,) if sparse else (b_or_a1, c))]
            d = api.tile_fused_matmul(adj13, adj13 if sparse else leaves[0],
                                      leaves[-1], spec=spec)
            value = (wgt * d).sum()
            if spec.mesh is None:
                value.backward()
                counts = None
            else:
                _, counts, _ = counted13(value.backward)
            res.append(([x.grad for x in leaves], counts))
        err = max(rel_err(g, w)[1] for g, w in zip(res[0][0], res[1][0]))
        print(f"[13a gradients] {name} on mesh (4,): rel err vs one device "
              f"{err:.2e}; backward launches {res[0][1]}")
        if err > TOL["float32"] or res[0][1][wf0] == 0:
            fail(f"phase 13a {name}: sharded gradients disagree ({err:.2e})"
                 f" or launched no {wf0}")
        del res, d
    del cases13

    # ---- 13b. GCN serving on a mesh (CONFIG widths, knobs "auto") ----
    model = models["banded"]
    t0 = time.perf_counter()
    entries13 = model.layer_entries(mesh1d)
    print(f"[13b gcn] mesh (4,) entries built in "
          f"{time.perf_counter() - t0:.2f} s host: " + "; ".join(
              f"layer {i + 1} pick {api.select_backend(e, dev)!r} "
              + ("shard None (single-device fallback)" if e.shard is None
                 else f"{e.shard.layout} {e.shard.combine} overlap="
                      f"{e.shard.overlap} halo {e.shard.halo_size}")
              for i, e in enumerate(entries13)))
    lat13, per_req13 = [], []
    req_rng = np.random.default_rng(1300)
    for r in range(REQUESTS):
        x = torch.from_numpy(req_rng.standard_normal(
            (N_NODES, cfg.in_dim), np.float32)).to(dev)
        with torch.inference_mode():
            want = model(x)
            t0 = time.perf_counter()
            logits, counts, _ = counted13(lambda: model(x, mesh=mesh1d))
        lat13.append((time.perf_counter() - t0) * 1e3)
        per_req13.append(counts)
        err = rel_err(logits, want)[1]
        if tuple(logits.shape) != (N_NODES, cfg.out_dim) or err > TOL[
                "float32"]:
            fail(f"phase 13b request {r}: shape {tuple(logits.shape)}, rel "
                 f"err {err:.2e} vs the one-device request")
    print(f"[13b gcn] {REQUESTS} requests on mesh (4,): wall p50 "
          f"{float(np.median(lat13)):.3f} ms, max {max(lat13):.3f} ms "
          f"(phase 5 one device: p50 {serve_p50_ms['banded']:.3f} ms); "
          f"launches per request {per_req13[-1]}; last rel err vs the "
          f"one-device request {err:.2e}")
    with torch.inference_mode():
        trace("13b", "GCN request on mesh (4,)",
              lambda: model(x, mesh=mesh1d))

    # ---- 13c. GCN training on a mesh: phase 10's banded set-up ----
    data_rng = np.random.default_rng(300)
    x = torch.from_numpy(data_rng.standard_normal(
        (N_NODES, cfg.in_dim), np.float32)).to(dev)
    y = torch.from_numpy(data_rng.integers(0, cfg.out_dim, N_NODES)).to(dev)
    w0 = [w.detach().clone() for w in model.weights]
    for w in model.weights:
        w.grad = None
    model.loss(x, y).backward()
    want = [w.grad.clone() for w in model.weights]
    step = steps.make_gcn_train_step(model, lr=TRAIN_LR, mesh=mesh1d)
    losses, misses, lat, per_step = [], [], [], []
    for i in range(3):
        t0 = time.perf_counter()
        loss, counts, _ = counted13(lambda: step(x, y))
        lat.append((time.perf_counter() - t0) * 1e3)
        per_step.append(counts)
        losses.append(float(loss))
        misses.append(api.schedule_cache_stats()["misses"])
        if i == 0:
            got = [w.grad.clone() for w in model.weights]
    err = max(rel_err(g, w)[1] for g, w in zip(got, want))
    stats = api.schedule_cache_stats()
    t_meshed = [e for e in api._schedule_cache.values()
                if e.transpose and e.mesh_key is not None]
    print(f"[13c gcn train] mesh (4,): step-1 weight grads rel err vs one "
          f"device {err:.2e}; losses {', '.join(f'{v:.5f}' for v in losses)}"
          f"; misses after each step {misses}; mesh-keyed transpose entries "
          f"{len(t_meshed)} "
          f"({[e.shard.layout if e.shard else None for e in t_meshed]}), "
          f"mesh_entries {stats['mesh_entries']}; step walls "
          f"{', '.join(f'{v:.2f}' for v in lat)} ms; launches per step "
          f"{per_step[-1]}")
    if err > TOL["float32"]:
        fail(f"phase 13c: step-1 gradients disagree ({err:.2e})")
    if not losses[-1] < losses[0]:
        fail(f"phase 13c: loss {losses[0]} -> {losses[-1]}")
    if len(set(misses)) != 1:
        fail(f"phase 13c: re-inspected after step 1: {misses}")
    if not t_meshed or any(e.shard is None for e in t_meshed):
        fail(f"phase 13c: mesh-keyed transpose entries {len(t_meshed)}, "
             f"some without a shard")
    with torch.no_grad():
        for w, v in zip(model.weights, w0):
            w.copy_(v)
    del x, y, w0, want, got

    # ---- 13d. the power-law graph on the 1d mesh ----
    power_adj = models["powerlaw"].adj
    spec = api.FusionSpec(mesh=mesh1d)
    entry = api.get_schedule(power_adj, b_col=128, c_col=128,
                             spec=dataclasses.replace(spec, dtype_bytes=4))
    pick = api.select_backend(entry, dev)
    b = torch.from_numpy(b_np).to(dev)
    c = torch.from_numpy(c_np).to(dev)
    want = api.tile_fused_matmul(power_adj, b, c)
    got, counts, _ = counted13(
        lambda: api.tile_fused_matmul(power_adj, b, c, spec=spec))
    err = rel_err(got, want)[1]
    print(f"[13d] power-law GeMM-SpMM on mesh (4,): pick {pick!r}, shard "
          + ("None (the layout pricing's single-device fallback)"
             if entry.shard is None else
             f"{entry.shard.layout} {entry.shard.combine} halo "
             f"{entry.shard.halo_size} of {power_adj.n_rows} rows")
          + f"; launches {counts}; rel err vs one device {err:.2e}")
    if sum(counts.values()) == 0 or err > TOL["float32"]:
        fail(f"phase 13d: launches {counts}, rel err {err:.2e}")
    del b, c, got, want

    print(f"[13] kernel launches in phase 13's counted paths: {launches13}")
    for k, v in launches13.items():
        if v == 0:
            fail(f"phase 13: {k} never launched")
        path_launches[k] += v
    print(f"[13] phase 13 took {time.perf_counter() - t13:.1f} s")

    # ---- 14. LM training: the sparse-band block at stablelm's widths ----
    # The mixer is A·(X·Wv) with the band A as the sparse operand, forced
    # onto the fused kernel arm (backend="cuda", the twin of the
    # reference's forced "xla" arm); Eq 3 alone would pick the unfused arm.
    t14 = time.perf_counter()
    from repro_torch.kernels.tile_fused_gemm_spmm import (CORE_KERNEL,
                                                          choose_path)
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptConfig, adamw
    launches14 = dict.fromkeys(GCN_KERNELS, 0)
    band_cfg = dataclasses.replace(
        get_config(BAND_ARCH, reduced=BAND_REDUCED),
        block_pattern="sparse-band")
    width = band_cfg.d_model
    inner = band_cfg.n_heads * band_cfg.ssm_head_dim
    band = ssm.decay_band_csr(BAND_SEQ, band_cfg.band_window,
                              band_cfg.band_decay)
    band_spec = dataclasses.replace(ssm._BAND_SPEC, dtype_bytes=4)
    # the forward's entry (B = x_i, C = Wv) and the backward's dB entry
    # (B = Ḋ_i, C = Wvᵀ, against Aᵀ)
    e_band = api.get_schedule(band, b_col=width, c_col=inner,
                              spec=band_spec)
    e_band_t = api.get_schedule(
        band, b_col=inner, c_col=width,
        spec=dataclasses.replace(band_spec, transpose=True))
    for name, e in (("band forward", e_band), ("band dB (transpose)",
                                                e_band_t)):
        ds = e.dsched
        print(f"[14 band] {name}: {BAND_SEQ} rows, window "
              f"{band_cfg.band_window}, nnz {band.nnz}; t={ds.t_pad} "
              f"T0={ds.n_tiles0} j0_max={ds.j_rows0.shape[1]} "
              f"w0={ds.ell_cols0.shape[2]} wf1={tuple(ds.ell_cols1.shape)} "
              f"fused_ratio={e.sched.fused_ratio:.3f} "
              f"saving={e.traffic_model['traffic_saving']:.3f}; Eq 3's "
              f"auto pick {api.select_backend(e, dev)!r} (the mixer "
              f"forces 'cuda')")

    def counted14(fn):
        """``(fn(), launches)``, counts set to 0 just before and read just
        after; the plain executors and the unfused arm raise meanwhile."""
        plain = {n: getattr(fused_ops, n) for n in
                 ("fused_gemm_spmm", "fused_spmm_spmm", "_ell_rows",
                  "unfused_gemm_spmm")}

        def refuse(*args, **kwargs):
            fail("phase 14: a plain executor or the unfused arm ran")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for n in plain:
            setattr(fused_ops, n, refuse)
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            for n, f in plain.items():
                setattr(fused_ops, n, f)
        counts = {k: ops.launch_counts()[k] for k in GCN_KERNELS}
        for k, v in counts.items():
            launches14[k] += v
        return out, counts

    # ---- 14a. the two kernels at the band's shapes, f32 ----
    band_records = {}
    f32 = torch.float32
    # the CUDA-core GeMM-SpMM still takes t % 64 != 0: t 96 at b_col 1024
    # (the wide kernel's rows), random tile-local fused rows
    g14 = torch.Generator().manual_seed(141)
    t_core, n_core, j_core, w_core = 96, 128, 80, 8
    cols_core = torch.randint(0, t_core, (n_core, j_core, w_core),
                              generator=g14, dtype=torch.int32).to(dev)
    vals_core = torch.randn((n_core, j_core, w_core), generator=g14).to(dev)
    if choose_path(t_core, 1024, 128, j_core, w_core, f32) != CORE_KERNEL:
        fail("phase 14a: the t 96 case does not take the CUDA-core kernel")
    cases14 = [
        (*gemm_case(" (band forward)", e_band, f32), dict(path=GEMM_WIDE)),
        (*gemm_case(" (band dB, transpose)", e_band_t, f32),
         dict(path=GEMM_WIDE)),
        (*gemm_tensor_case(" (t 96, b_col 1024, CUDA cores)", cols_core,
                           vals_core, t_core, 1024, 128, f32,
                           n_core * t_core, n_core * j_core),
         dict(path=CORE_KERNEL)),
        wf1_hybrid_case(" (band wf1, forward)", e_band, f32),
        wf1_hybrid_case(" (band wf1, dB)", e_band_t, f32),
        full_hybrid_case(f"spmm_ell (band Aᵀ hybrid, dWv, {width} columns)",
                         band.transpose(), width, f32)]
    for case in cases14:
        rec = check_case(*case, dtype=f32, tag="14a")
        rec["queued_ms"] = queued_ms(case[1])
        band_records[case[0]] = rec
        before = next((f"; the CUDA-core kernel took {v} ms here (PR 21, "
                       f"PERF.md; not re-run)" for k, v in
                       CORE_MS_BEFORE.items() if f"({k}" in case[0]), "")
        print(f"[14a] {case[0]}: {rec['ms']:.4f} ms, queued behind a sleep "
              f"{rec['queued_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), share {rec['bound_ms'] / rec['ms']:.3f}"
              f", plain {rec['plain_ms']:.4f} ms, library "
              f"{rec['library_ms']} ms{before}")
    del cases14, cols_core, vals_core

    # ---- 14b. the mixer at full width: cuda arm, plain arm, f64 oracle --
    import torch.nn.functional as F
    mix_cfg = dataclasses.replace(band_cfg, dtype="float32")
    gen14 = torch.Generator(device=dev).manual_seed(14)
    pm = ssm.band_mix_init(gen14, mix_cfg, f32, dev)
    xm = torch.randn(BAND_BATCH, BAND_SEQ, width, device=dev, generator=gen14)
    wm = torch.randn(BAND_BATCH, BAND_SEQ, width, device=dev, generator=gen14)
    grad_names = ("x", "wv", "wz", "w_down")

    def mix_grads(backend):
        """The mixer's output and the gradients of ``(out · wm).sum()``
        in x, wv, wz, w_down."""
        leaves = {k: v.clone().requires_grad_() for k, v in pm.items()}
        xx = xm.clone().requires_grad_()
        out = ssm.band_mix_apply(leaves, mix_cfg, xx, band, backend=backend)
        (out * wm).sum().backward()
        return [out.detach(), xx.grad] + [leaves[k].grad
                                          for k in grad_names[1:]]

    got, counts = counted14(lambda: mix_grads("cuda"))
    want = mix_grads("torch")
    leaves = {k: v.double().requires_grad_() for k, v in pm.items()}
    x64 = xm.double().requires_grad_()
    a64 = torch.from_numpy(band.to_dense()).to(dev, torch.float64)
    out64 = ((a64 @ (x64 @ leaves["wv"])) * F.silu(x64 @ leaves["wz"])
             ) @ leaves["w_down"]
    (out64 * wm.double()).sum().backward()
    oracle = [out64.detach(), x64.grad] + [leaves[k].grad
                                           for k in grad_names[1:]]
    del out64, x64, leaves, a64
    names = ("out",) + tuple(f"d{k}" for k in grad_names)
    err_t = {n: rel_err(g, w)[1] for n, g, w in zip(names, got, want)}
    err_o = {n: rel_err(g, w)[1] for n, g, w in zip(names, got, oracle)}
    err_p = {n: rel_err(g, w)[1] for n, g, w in zip(names, want, oracle)}
    print(f"[14b mixer] B {BAND_BATCH} S {BAND_SEQ} d {width} inner {inner} "
          f"f32: cuda vs torch rel {', '.join(f'{k} {v:.2e}' for k, v in err_t.items())}")
    print(f"[14b mixer] vs the f64 dense oracle: cuda "
          f"{', '.join(f'{k} {v:.2e}' for k, v in err_o.items())}; torch "
          f"{', '.join(f'{k} {v:.2e}' for k, v in err_p.items())}; "
          f"launches of the cuda forward + backward {counts}")
    if max(err_t.values()) > TOL["float32"]:
        fail(f"phase 14b: the cuda arm disagrees with the plain arm {err_t}")
    if max(err_o.values()) > MAIN_TOL or max(err_p.values()) > MAIN_TOL:
        fail(f"phase 14b: the mixer disagrees with the f64 oracle "
             f"{err_o} / {err_p}")
    if counts != {**dict.fromkeys(GCN_KERNELS, 0),
                  "tile_fused_gemm_spmm_wf0": 2 * BAND_BATCH,
                  "spmm_ell": 3 * BAND_BATCH}:
        fail(f"phase 14b: launches {counts}")
    del got, want, oracle
    mix_ms = {}
    for backend in ("cuda", "unfused"):
        with torch.no_grad():
            fwd = time_ms(lambda: ssm.band_mix_apply(
                pm, mix_cfg, xm, band, backend=backend), iters=3)
        both = time_ms(lambda: mix_grads(backend), iters=3)
        mix_ms[backend] = (fwd, both)
    print(f"[14b mixer] per call (CUDA events, 3 calls after 3): "
          + "; ".join(f"backend={b!r} forward {f:.3f} ms, forward + "
                      f"backward {fb:.3f} ms" for b, (f, fb) in
                      mix_ms.items())
          + f"; Eq 3's pick {api.select_backend(e_band, dev)!r}")
    del pm, xm, wm

    # ---- 14c. full-width training: 6 AdamW steps ----
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = T.Transformer(band_cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"[14c train] {band_cfg.name} sparse-band: {n_params / 1e9:.3f} B "
          f"parameters ({band_cfg.param_count() / 1e9:.3f} B by "
          f"param_count), {band_cfg.n_layers} layers, d {width}, inner "
          f"{inner}, d_ff {band_cfg.d_ff}, vocab {band_cfg.vocab_size}, "
          f"{band_cfg.dtype}, band window {band_cfg.band_window} decay "
          f"{band_cfg.band_decay}; built in {time.perf_counter() - t0:.1f} s")
    gen_tok = torch.Generator(device=dev).manual_seed(140)
    batch = {k: torch.randint(0, band_cfg.vocab_size, (BAND_BATCH, BAND_SEQ),
                              device=dev, generator=gen_tok)
             for k in ("tokens", "labels")}
    step = steps.make_train_step(lm, OptConfig(**BAND_OPT))
    state = adamw.init(lm.parameters())
    # a batch row a layer: the forward's GeMM-SpMM and its wavefront-1
    # spmm_ell, run again by the remat recompute in the backward (the
    # config's remat="dots" recomputes the block, the mixer's autograd
    # Functions included), then one GeMM-SpMM for dB and two spmm_ell
    # calls (dB's wavefront 1, Aᵀ·Ḋ for dWv) (PERF.md §6)
    fwd_runs = 1 if band_cfg.remat == "none" else 2
    rows14 = BAND_BATCH * band_cfg.n_layers
    expect = {**dict.fromkeys(GCN_KERNELS, 0),
              "tile_fused_gemm_spmm_wf0": (fwd_runs + 1) * rows14,
              "spmm_ell": (fwd_runs + 2) * rows14}
    print(f"[14c train] remat {band_cfg.remat!r}: the forward's kernels run "
          f"{fwd_runs} time(s) a step; expected launches a step {expect}")
    losses, lat, per_step, misses = [], [], [], []
    for i in range(BAND_STEPS):
        t0 = time.perf_counter()
        (state, metrics), counts = counted14(lambda: step(state, batch))
        lat.append((time.perf_counter() - t0) * 1e3)
        per_step.append(counts)
        losses.append(float(metrics["loss"]))
        misses.append(api.schedule_cache_stats()["misses"])
        print(f"[14c train] step {i + 1}: loss {losses[-1]:.5f} grad_norm "
              f"{float(metrics['grad_norm']):.4f} lr {metrics['lr']:.3e} "
              f"wall {lat[-1]:.1f} ms launches {counts}")
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(lat[1:]))
    print(f"[14c train] {BAND_STEPS} steps of {BAND_BATCH} x {BAND_SEQ} "
          f"tokens: step p50 {p50:.1f} ms, max {max(lat[1:]):.1f} ms over "
          f"steps 2-{BAND_STEPS} (host clock around the step + "
          f"synchronize; step 1 {lat[0]:.1f} ms), "
          f"{BAND_BATCH * BAND_SEQ / (p50 / 1e3):.0f} tokens/s; peak "
          f"device memory {peak / 2**30:.2f} GiB; schedule-cache misses "
          f"after each step {misses}")
    if not all(np.isfinite(losses)) or not min(losses[2:]) < losses[0]:
        fail(f"phase 14c: losses {losses}")
    if len(set(misses)) != 1:
        fail(f"phase 14c: re-inspected after step 1: {misses}")
    for i, c in enumerate(per_step):
        if c != expect:
            fail(f"phase 14c step {i + 1}: launches {c}, expected {expect}")
    busy, wall, _, by_kernel = trace("14c", "sparse-band training step",
                                     lambda: step(state, batch), top=14)
    gemm_us = sum(us for k, us in by_kernel.items() if "gemm_spmm" in k)
    print(f"[14c train] traced step: device busy {busy / 1e3:.1f} ms of "
          f"{wall / 1e3:.1f} ms ({busy / wall:.3f}); GeMM-SpMM "
          f"{gemm_us / 1e3:.1f} ms of the busy time ({gemm_us / busy:.3f});"
          f" the traced and warm-up steps are not counted")
    fwd = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = lm(batch["tokens"])
            torch.cuda.synchronize()
            fwd.append((time.perf_counter() - t0) * 1e3)
    print(f"[14c train] prefill forward of the batch under inference_mode: "
          f"{', '.join(f'{v:.1f}' for v in fwd)} ms; logits "
          f"{tuple(logits.shape)} {logits.dtype}")
    del lm, state, step, logits, metrics
    torch.cuda.empty_cache()

    # the 2-layer f32 cut of the same widths: step-1 gradients of every
    # parameter, impl="cuda" against impl="torch" (both under the config's
    # remat), then remat "full" and "dots" against "none" on impl="cuda"
    cut_cfg = dataclasses.replace(band_cfg, n_layers=BAND_CUT_LAYERS,
                                  dtype="float32")
    cut_grads, cut_counts = {}, {}
    for impl, remat in (("cuda", cut_cfg.remat), ("torch", cut_cfg.remat),
                        ("cuda", "none"), ("cuda", "full"),
                        ("cuda", "dots")):
        cut = T.Transformer(dataclasses.replace(cut_cfg, remat=remat),
                            device=dev, seed=0)

        def cut_backward():
            logits = cut(batch["tokens"], impl=impl, train=True)
            steps.cross_entropy(logits, batch["labels"]).backward()
        if impl == "cuda":
            _, cut_counts[remat] = counted14(cut_backward)
        else:
            cut_backward()
        cut_grads[impl, remat] = {n: p.grad for n, p in
                                  cut.named_parameters()}
        del cut
    errs = {n: rel_err(g, cut_grads["torch", cut_cfg.remat][n])[1]
            for n, g in cut_grads["cuda", cut_cfg.remat].items()}
    worst = max(errs, key=errs.get)
    print(f"[14c cut] {BAND_CUT_LAYERS}-layer f32 cut: step-1 gradients of "
          f"{len(errs)} parameters, impl='cuda' vs impl='torch' (remat "
          f"{cut_cfg.remat!r}): largest rel err {errs[worst]:.2e} ({worst});"
          f" launches by remat {cut_counts}")
    if errs[worst] > TOL["float32"]:
        fail(f"phase 14c: the cut's gradients disagree ({worst} "
             f"{errs[worst]:.2e})")
    none_grads = cut_grads["cuda", "none"]
    for remat in ("full", "dots"):
        errs = {n: rel_err(g, none_grads[n])[1]
                for n, g in cut_grads["cuda", remat].items()}
        worst = max(errs, key=errs.get)
        same = all(torch.equal(g, none_grads[n])
                   for n, g in cut_grads["cuda", remat].items())
        print(f"[14c cut] remat {remat!r} vs 'none' on impl='cuda': "
              f"largest rel err {errs[worst]:.2e} ({worst}); equal bit for "
              f"bit: {same}")
        if errs[worst] > REMAT_TOL:
            fail(f"phase 14c: remat {remat!r} changes the gradients "
                 f"({worst} {errs[worst]:.2e})")
        # the recompute runs each block's forward once more: one
        # GeMM-SpMM and one spmm_ell a batch row a layer
        again = BAND_BATCH * BAND_CUT_LAYERS
        if cut_counts[remat] != {
                **cut_counts["none"],
                "tile_fused_gemm_spmm_wf0":
                    cut_counts["none"]["tile_fused_gemm_spmm_wf0"] + again,
                "spmm_ell": cut_counts["none"]["spmm_ell"] + again}:
            fail(f"phase 14c: remat {remat!r} launches {cut_counts[remat]}"
                 f", expected one more forward's than {cut_counts['none']}")
    del cut_grads, none_grads, batch
    torch.cuda.empty_cache()

    print(f"[14] kernel launches in phase 14's counted paths: {launches14}")
    for k in ("spmm_ell", "tile_fused_gemm_spmm_wf0"):
        if launches14[k] == 0:
            fail(f"phase 14: {k} never launched")
    for k, v in launches14.items():
        path_launches[k] += v
    print(f"[14] phase 14 took {time.perf_counter() - t14:.1f} s")

    # ---- 15. LM training: the dense decoder at full width ----
    # The training attention is layers.scan_attention, the reference's
    # chunked XLA attention in plain PyTorch; the flash kernel serves only
    # and its wrapper refuses grad, so this path launches none of the six
    # kernels, and its counts must stay 0.
    t15 = time.perf_counter()
    import contextlib
    import io
    import shutil

    from repro_torch.checkpoint import latest_step
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.launch import train as train_cli
    from repro_torch.models import layers as LM
    dense_cfg = get_config(DENSE_ARCH, reduced=DENSE_REDUCED)
    bf16 = torch.bfloat16
    heads, hd = dense_cfg.n_heads, dense_cfg.head_dim
    g15 = torch.Generator(device=dev).manual_seed(150)

    # ---- 15a. scan_attention at the training shape ----
    cb, ch = ATTN_CUT
    lower = torch.ones(DENSE_SEQ, DENSE_SEQ, dtype=torch.bool,
                       device=dev).tril()
    for dname, tol in ATTN_ORACLE_TOL.items():
        qkv = [torch.randn(cb, ch, DENSE_SEQ, hd, device=dev, generator=g15)
               .to(getattr(torch, dname)) for _ in range(3)]
        wc = torch.randn(cb, ch, DENSE_SEQ, hd, device=dev, generator=g15)
        leaves = [t.clone().requires_grad_() for t in qkv]
        out = LM.scan_attention(*leaves, causal=True)
        (out.float() * wc).sum().backward()
        o64 = [t.double().requires_grad_() for t in qkv]
        want = torch.softmax(
            (o64[0] @ o64[1].transpose(-1, -2) / hd ** 0.5)
            .masked_fill(~lower, float("-inf")), -1) @ o64[2]
        (want * wc.double()).sum().backward()
        errs15 = {n: rel_err(g, w)[1] for n, g, w in zip(
            ("out", "dq", "dk", "dv"), [out] + [t.grad for t in leaves],
            [want] + [t.grad for t in o64])}
        print(f"[15a attention] scan_attention {dname} causal, B {cb} H {ch}"
              f" S {DENSE_SEQ} D {hd}, forward and backward vs an f64 dense"
              f" oracle: rel err "
              f"{', '.join(f'{k} {v:.2e}' for k, v in errs15.items())} "
              f"(limit {tol:.2e})")
        if max(errs15.values()) > tol:
            fail(f"phase 15a: scan_attention {dname} disagrees with the f64 "
                 f"oracle {errs15}")
    del qkv, wc, leaves, out, o64, lower, want
    shape15 = (DENSE_BATCH, heads, DENSE_SEQ, hd)
    q15, k15, v15 = (torch.randn(shape15, device=dev, generator=g15).to(bf16)
                     for _ in range(3))
    dout15 = torch.randn(shape15, device=dev, generator=g15).to(bf16)
    with torch.no_grad():
        got = LM.scan_attention(q15, k15, v15, causal=True)
        flash = ops.flash_attention(q15, k15, v15, causal=True)
    err_abs, err_rows = rel_err(got, flash, rows=True)
    print(f"[15a attention] B {DENSE_BATCH} H {heads} S {DENSE_SEQ} D {hd} "
          f"bf16 causal: scan_attention vs the flash kernel ("
          f"{flash_last_path()}) under no_grad: max abs err {err_abs:.3e}, "
          f"row rel err {err_rows:.3e} (limit {LM_BF16_TOL:.3e})")
    if err_rows > LM_BF16_TOL:
        fail(f"phase 15a: scan_attention disagrees with the flash kernel "
             f"({err_rows:.3e})")
    del got, flash

    def fwd_bwd(attn):
        leaves = [t.detach().requires_grad_() for t in (q15, k15, v15)]
        attn(*leaves).backward(dout15)

    def scan(*t):
        return LM.scan_attention(*t, causal=True)

    def sdpa(*t):
        return F.scaled_dot_product_attention(*t, is_causal=True)
    attn_ms = {}
    for name, attn in (("scan_attention", scan), ("sdpa", sdpa)):
        with torch.no_grad():
            fwd = time_ms(lambda: attn(q15, k15, v15), iters=5)
        attn_ms[name] = (fwd, time_ms(lambda: fwd_bwd(attn), iters=5))
    with torch.no_grad():
        flash_ms = time_ms(lambda: ops.flash_attention(q15, k15, v15,
                                                       causal=True), iters=5)
    (s_f, s_fb), (y_f, y_fb) = attn_ms["scan_attention"], attn_ms["sdpa"]
    print(f"[15a attention] per call (CUDA events, 5 calls after 3): "
          f"scan_attention forward {s_f:.3f} ms, forward + backward "
          f"{s_fb:.3f} ms; F.scaled_dot_product_attention (a yardstick, "
          f"never on the path) forward {y_f:.3f} ms, forward + backward "
          f"{y_fb:.3f} ms; the flash kernel's forward {flash_ms:.3f} ms; "
          f"under remat the step runs the forward twice a layer: "
          f"{dense_cfg.n_layers} x ({s_f:.1f} + {s_fb:.1f}) = "
          f"{dense_cfg.n_layers * (s_f + s_fb):.1f} ms of attention a step "
          f"(SDPA's the same way {dense_cfg.n_layers * (y_f + y_fb):.1f} "
          f"ms)")
    del q15, k15, v15, dout15
    torch.cuda.empty_cache()

    # ---- 15b. the trainer: launch.train.main in-process, full width ----
    torch.cuda.reset_peak_memory_stats()
    held15 = torch.cuda.memory_allocated()
    argv15 = ["--arch", DENSE_ARCH, "--steps", str(DENSE_STEPS), "--batch",
              str(DENSE_BATCH), "--seq", str(DENSE_SEQ), "--log-every", "1"
              ] + ["--reduced"] * DENSE_REDUCED
    print(f"[15b train] launch.train.main({argv15}): {dense_cfg.name} "
          f"{dense_cfg.n_layers} layers, d {dense_cfg.d_model}, {heads} "
          f"heads of {hd}, d_ff {dense_cfg.d_ff}, vocab "
          f"{dense_cfg.vocab_size}, {dense_cfg.dtype}, remat "
          f"{dense_cfg.remat!r}", flush=True)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run = train_cli.main(argv15)
    torch.cuda.synchronize()
    wall15 = time.perf_counter() - t0
    launches15 = ops.launch_counts()
    peak15 = torch.cuda.max_memory_allocated()
    losses15 = run.losses
    lat15 = [t * 1e3 for t in run.step_s]
    p50_15 = float(np.median(lat15[1:]))
    n_params15 = sum(p.numel() for p in run.model.parameters())
    tokens15 = DENSE_BATCH * DENSE_SEQ
    model_tflops = 6 * n_params15 * tokens15 / (p50_15 / 1e3) / 1e12
    print(f"[15b train] {DENSE_STEPS} steps of {DENSE_BATCH} x {DENSE_SEQ} "
          f"tokens in {wall15:.1f} s (model built, steps, host data): "
          f"{n_params15 / 1e9:.3f} B parameters; losses "
          f"{', '.join(f'{v:.4f}' for v in losses15)}")
    print(f"[15b train] step p50 {p50_15:.1f} ms, max {max(lat15[1:]):.1f} "
          f"ms over steps 2-{DENSE_STEPS} (host clock around the step; "
          f"reading the loss waits for the device; step 1 {lat15[0]:.1f} "
          f"ms), {tokens15 / (p50_15 / 1e3):.0f} tokens/s, 6·N·tokens "
          f"{model_tflops:.1f} TFLOP/s ({model_tflops * 1e12 / PEAK_OPS['bfloat16']:.3f}"
          f" of the bf16 peak; attention not counted); peak device memory "
          f"{peak15 / 2**30:.2f} GiB, of it {held15 / 2**30:.2f} GiB held "
          f"by earlier phases: the run's own {(peak15 - held15) / 1e9:.2f}"
          f" GB (reckoned ~{DENSE_RECKONED_GB} GB); kernel launches "
          f"{launches15}")
    if not all(np.isfinite(losses15)) or not min(losses15[2:]) < losses15[0]:
        fail(f"phase 15b: losses {losses15}")
    if len(losses15) != DENSE_STEPS:
        fail(f"phase 15b: {len(losses15)} steps ran")
    if any(launches15.values()):
        fail(f"phase 15b: the dense training path launched {launches15}; "
             f"its attention is scan_attention, no flash kernel")
    stream15 = SyntheticStream(DataConfig(
        vocab_size=dense_cfg.vocab_size, seq_len=DENSE_SEQ,
        global_batch=DENSE_BATCH))
    batch15 = {k: torch.from_numpy(v).to(dev)
               for k, v in stream15.batch_at(DENSE_STEPS).items()}
    state15 = [run.opt_state]

    def dense_step():
        state15[0], _ = run.train_step(state15[0], batch15)
    ops15 = {}
    busy, wall, _, _ = trace("15b", "dense training step", dense_step,
                             top=14, ops_device=ops15)
    bmm_us, mm_us = ops15.get("aten::bmm", 0.0), ops15.get("aten::mm", 0.0)
    print(f"[15b train] traced step: device busy {busy / 1e3:.1f} ms of "
          f"{wall / 1e3:.1f} ms ({busy / wall:.3f}); the attention's f32 "
          f"products (aten::bmm: forward, remat recompute and backward; "
          f"the projections are aten::mm) {bmm_us / 1e3:.1f} ms of the busy "
          f"time ({bmm_us / busy:.3f}); aten::mm {mm_us / 1e3:.1f} ms "
          f"({mm_us / busy:.3f})")
    del run, state15, batch15
    torch.cuda.empty_cache()

    # ---- 15c. preemption and resume at --reduced ----
    ck15 = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck15, ignore_errors=True)
    d_cut, d_clean = ck15 / "interrupted", ck15 / "clean"
    try:
        train_cli.main(RESUME_ARGS + ["--ckpt-dir", str(d_cut),
                                      "--simulate-preemption", "6"])
        code = 0
    except SystemExit as e:
        code = e.code
    if code != 17 or latest_step(str(d_cut)) != 6:
        fail(f"phase 15c: the preempted run exited {code} with step "
             f"{latest_step(str(d_cut))} saved")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        train_cli.main(RESUME_ARGS + ["--ckpt-dir", str(d_cut)])
    print(log.getvalue(), end="")
    if "[restore] resumed from step 6" not in log.getvalue():
        fail("phase 15c: the rerun did not resume from step 6")
    train_cli.main(RESUME_ARGS + ["--ckpt-dir", str(d_clean)])
    leaf_names = sorted(f.name for f in (d_clean / "step_00000008").iterdir()
                        if f.suffix == ".npy")
    differ = []
    for f in leaf_names:
        a = np.load(d_cut / "step_00000008" / f)
        b = np.load(d_clean / "step_00000008" / f)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            differ.append(f"{f} {a.shape}")
    print(f"[15c resume] {' '.join(RESUME_ARGS)}: preempted at step 6 "
          f"(exit 17), resumed from step 6; step-8 leaves equal to an "
          f"uninterrupted run's bit for bit: {len(leaf_names) - len(differ)}"
          f" of {len(leaf_names)}")
    shutil.rmtree(ck15, ignore_errors=True)
    if differ or not leaf_names:
        fail(f"phase 15c: resumed leaves differ from the uninterrupted "
             f"run's: {differ}")
    print(f"[15] phase 15 took {time.perf_counter() - t15:.1f} s")
    return dict(records=records, band_records=band_records,
                path_launches=path_launches,
                tensor_core_ops=tensor_core_ops,
                flash_record_path=flash_record_path, device_kind=device_kind,
                t_start=t_start)


# ---------------------------------------------------------------- phase 16 --
@contextlib.contextmanager
def record_routes(layers, gaps=False):
    """While active, each call of ``layers._row_dispatch`` appends its
    ``Dispatch`` (and with ``gaps`` the gap between each token's k-th and
    (k+1)-th gate, recomputed from the call's inputs) to the yielded
    list: one entry a layer of a forward or decode step.  Wraps the
    module's function; nothing in the package changes."""
    import torch
    calls = []
    dispatch = layers._row_dispatch

    def record(cfg, x, router, cap):
        xe, route = dispatch(cfg, x, router, cap)
        gap = None
        if gaps:
            top = torch.softmax(x.float() @ router, -1).topk(
                min(cfg.moe_top_k + 1, cfg.n_experts), -1).values
            gap = top[..., -2] - top[..., -1]
        calls.append((route, gap))
        return xe, route
    layers._row_dispatch = record
    try:
        yield calls
    finally:
        layers._row_dispatch = dispatch


@contextlib.contextmanager
def replay_routes(layers, calls):
    """While active, the i-th call of ``layers._row_dispatch`` routes as
    the i-th recorded call (``record_routes``' list): the same top-k sets
    and kept slots, the gates recomputed from this call's router logits
    on those sets.  Two runs that round differently can then be held to
    each other through every layer without a flip between them."""
    import torch
    pending = iter(calls)
    dispatch = layers._row_dispatch

    def replay(cfg, x, router, cap):
        route, _ = next(pending)
        b, s, d = x.shape
        k = cfg.moe_top_k
        gates = torch.softmax(x.float() @ router, -1).gather(
            -1, route.experts)
        route = route._replace(
            gates=gates / gates.sum(-1, keepdim=True).clamp_min(1e-9))
        xe = layers._GatherRows.apply(x.reshape(b * s, d),
                                      (route.slot_pick // k)[:, None],
                                      route.tok_slot.view(b * s, k))
        return xe.view(cfg.n_experts, -1, d), route
    layers._row_dispatch = replay
    try:
        yield
    finally:
        layers._row_dispatch = dispatch


@contextlib.contextmanager
def held_attention(layers):
    """While active, each prefill attention (``layers.chunked_attention``,
    the flash kernel on the card) also runs its plain version
    (``impl="torch"``) on the same q, k and v, and appends ``(q's shape,
    the window, the row-wise error of the call's output against the plain
    one)`` to the yielded list: the kernel held on the main path's own
    inputs, one entry a layer."""
    calls = []
    attn = layers.chunked_attention

    def held(q, k, v, *, causal=True, window=0, impl="cuda"):
        out = attn(q, k, v, causal=causal, window=window, impl=impl)
        want = attn(q, k, v, causal=causal, window=window, impl="torch")
        calls.append((tuple(q.shape), window, rel_err(out, want,
                                                      rows=True)[1]))
        return out
    layers.chunked_attention = held
    try:
        yield calls
    finally:
        layers.chunked_attention = attn


@contextlib.contextmanager
def annotated(module):
    """While active, the functions of ``module`` named in ``SCOPES`` (the
    MoE layer's three steps and the attention in ``models.layers``; the
    mamba heads and the recurrence in ``models.ssm``) run inside their
    ``record_function`` scopes, so a trace can give each one's device time
    (forward and remat recompute; a backward runs outside them)."""
    from torch.profiler import record_function
    saved = {name: getattr(module, name) for name in SCOPES
             if hasattr(module, name)}

    def wrap(fn, label):
        def inner(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return inner
    for name, fn in saved.items():
        setattr(module, name, wrap(fn, SCOPES[name]))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def kept_of(route):
    """``(B, s, k)``: whether each token's pick kept its slot."""
    b, s, k = route.experts.shape
    return (route.tok_slot < route.slot_pick.numel()).view(b, s, k)


def routing_report(tag, label, runs_a, runs_b):
    """Per layer, the share of (token) top-k sets on which two runs agree
    and each run's dropped assignments; returns, per batch row, whether
    every token's set agrees in every layer (dispatch is per row, so rows
    do not affect each other's routing)."""
    import torch
    b, s, _ = runs_a[0][0].experts.shape
    rows = torch.ones(b, dtype=torch.bool, device=runs_a[0][0].experts.device)
    shares, drops = [], []
    for (ra, _), (rb, _) in zip(runs_a, runs_b, strict=True):
        same = (ra.experts == rb.experts).all(-1)
        shares.append(float(same.float().mean()))
        drops.append((int((~kept_of(ra)).sum()), int((~kept_of(rb)).sum())))
        rows &= same.all(-1)
    print(f"[{tag}] {label}: top-k sets agreeing by layer "
          f"{', '.join(f'{v:.4f}' for v in shares)}; dropped assignments by"
          f" layer (first run, second) {drops}; batch rows that route alike"
          f" in every layer: {int(rows.sum())} of {b}")
    return rows


def phase_16(dev) -> dict:
    """The gated MoE layer (16a), granite-moe-3b serving at full width and
    depth with its f32 cut (16b), a trace (16c), llama4-scout serving at
    full width, 8 of 48 layers (16d), and granite training (16e).
    Returns the phase's launches by path."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import last_path
    from repro_torch.launch import serve, steps
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptConfig, adamw
    t16 = time.perf_counter()
    bf16 = torch.bfloat16
    launches = {}

    def sub_time(label, t0):
        print(f"[16] {label} took {time.perf_counter() - t0:.1f} s",
              flush=True)

    def leaves(tree, prefix=""):
        """A (nested) weight dict as ``{"shared.w_up": tensor, ...}``."""
        out = {}
        for name, v in tree.items():
            if isinstance(v, dict):
                out.update(leaves(v, f"{prefix}{name}."))
            else:
                out[prefix + name] = v
        return out

    def nest(flat):
        """The inverse of ``leaves``."""
        tree = {}
        for name, v in flat.items():
            *path, last = name.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[last] = v
        return tree

    # ---- 16a. the layer alone at published widths ----
    for arch, b, s, backward in MOE_LAYER_CASES:
        t0 = time.perf_counter()
        cfg = get_config(arch, reduced=MOE_REDUCED)
        e, k, d, f = cfg.n_experts, cfg.moe_top_k, cfg.d_model, cfg.d_ff
        cap = L.moe_capacity(cfg, s)
        gen = torch.Generator(device=dev).manual_seed(160)
        p = L.moe_init(gen, cfg, bf16, dev)
        x = torch.randn(b, s, d, device=dev, generator=gen).to(bf16)
        wgt = torch.randn(b, s, d, device=dev, generator=gen)

        def layer_grads(dtype=None):
            flat = {n: (v if dtype is None else v.to(dtype)).detach()
                    .requires_grad_() for n, v in leaves(p).items()}
            xs = (x if dtype is None else x.to(dtype)).detach() \
                .requires_grad_()
            return flat, xs

        flat, xs = layer_grads()
        with record_routes(L) as calls:
            y = L.moe_apply(nest(flat), cfg, xs)
        route = calls[0][0]
        flat2, xs2 = layer_grads()
        y2 = L.moe_apply(nest(flat2), cfg, xs2)
        twice = torch.equal(y, y2)
        grads = {}
        if backward:
            (y.float() * wgt).sum().backward()
            (y2.float() * wgt).sum().backward()
            grads = {"x": xs.grad, **{n: v.grad for n, v in flat.items()}}
            twice = twice and torch.equal(xs.grad, xs2.grad) and all(
                torch.equal(v.grad, flat2[n].grad) for n, v in flat.items())
        del flat2, xs2, y2
        # the f64 oracle on the run's own routing: its top-k sets (gates
        # recomputed in f64, renormalized over the run's k picks) and its
        # kept slots; plain indexing, not the port's gather
        flat64, x64 = layer_grads(torch.float64)
        p64 = nest(flat64)
        n, n_slots = b * s, route.slot_pick.numel()
        gates64 = torch.softmax(x64.view(n, d) @ p64["router"], -1)
        g64 = gates64.gather(-1, route.experts.view(n, k))
        g64 = g64 / g64.sum(-1, keepdim=True).clamp_min(1e-9)
        ts = route.tok_slot
        src = torch.arange(n, device=dev).repeat_interleave(k)
        xe64 = x64.new_zeros(n_slots + 1, d).index_put(
            (ts,), x64.view(n, d)[src])[:-1].view(e, n_slots // e, d)
        act = L._act(cfg)
        h64 = act(xe64 @ p64["w1"]) * (xe64 @ p64["w3"])
        ye64 = torch.cat([(h64 @ p64["w2"]).view(n_slots, d),
                          x64.new_zeros(1, d)])
        y64 = (ye64[ts].view(n, k, d) * g64[..., None]).sum(1).view(b, s, d)
        if "shared" in p64:
            y64 = y64 + L.ffn_apply(p64["shared"], cfg, x64)
        want = {}
        if backward:
            (y64 * wgt.double()).sum().backward()
            want = {"x": x64.grad, **{nm: v.grad
                                      for nm, v in flat64.items()}}
        errs = {"out": rel_err(y, y64, rows=True)[1]}
        errs.update({nm: rel_err(grads[nm], want[nm], rows=True)[1]
                     for nm in grads if nm != "router" or k > 1})
        # top-1: the renormalized gate is 1 whatever the logits, so the
        # router's gradient is 0 in exact arithmetic and rounding noise in
        # both runs; it is printed, not held row by row
        noise = float(grads["router"].abs().max()) if grads and k == 1 \
            else None
        # where the f64 routing differs from the run's
        top64 = gates64.topk(min(k + 1, e), -1)
        e64 = top64.indices[:, :k].sort(-1).values
        run_e = route.experts.view(n, k)
        missing = ~(run_e[:, :, None] == e64[:, None, :]).any(-1)
        moved = missing.any(-1)
        gap64 = top64.values[:, k - 1] - top64.values[:, -1]
        dropped = int((~kept_of(route)).sum())
        print(f"[16a layer] {arch} B {b} x S {s}, d {d}, {e} experts top-"
              f"{k}{' + shared' if 'shared' in p else ''}, f {f}, cap {cap}"
              f" ({e * b * cap} slots for {n * k} picks), bf16: dropped "
              f"assignments {dropped}; vs an f64 oracle on the run's "
              f"routing{'' if backward else ' (forward only: a decode step'}"
              f"{'' if backward else ' runs no backward)'}, row rel err "
              + ", ".join(f"{nm} {v:.2e}" for nm, v in errs.items())
              + f" (limit {MOE_ORACLE_TOL:.2e})"
              + (f"; top-1, so the router's gradient is 0 in exact "
                 f"arithmetic: its largest magnitude {noise:.2e} (the "
                 f"oracle's {float(want['router'].abs().max()):.2e})"
                 if noise is not None else "")
              + f"; (token, k) picks of the "
              f"f64 routing that differ from the run's: "
              f"{int(missing.sum())} in {int(moved.sum())} tokens"
              + (f", their f64 gate gaps {gap64[moved][:8].tolist()}"
                 if bool(moved.any()) else "")
              + f"; two calls bitwise equal (output"
              f"{' and gradients' if backward else ''}): {twice}")
        if max(errs.values()) > MOE_ORACLE_TOL:
            fail(f"phase 16a {arch}: the layer disagrees with its f64 "
                 f"oracle {errs}")
        if not twice:
            fail(f"phase 16a {arch}: two calls differ")
        del flat, xs, y, grads, flat64, x64, p64, gates64, g64, xe64, h64
        del ye64, y64, want, top64
        torch.cuda.empty_cache()
        with torch.no_grad():
            xe, route = L._row_dispatch(cfg, x, p["router"], cap)
            ye = L._expert_ffn(cfg, xe, p["w1"], p["w3"], p["w2"])
            ms = {
                "dispatch": time_ms(lambda: L._row_dispatch(
                    cfg, x, p["router"], cap), iters=5),
                "experts": time_ms(lambda: L._expert_ffn(
                    cfg, xe, p["w1"], p["w3"], p["w2"]), iters=5),
                "combine": time_ms(lambda: L._row_combine(
                    ye, route, b, s, bf16), iters=5),
                "layer": time_ms(lambda: L.moe_apply(p, cfg, x), iters=5)}
        expert_flop = 6.0 * xe.shape[0] * xe.shape[1] * d * f
        print(f"[16a layer] {arch} per call (CUDA events, 5 calls after 3):"
              f" dispatch {ms['dispatch']:.3f} ms, expert products "
              f"{ms['experts']:.3f} ms ({expert_flop / 1e12:.3f} TFLOP, "
              f"{expert_flop / ms['experts'] / 1e9:.1f} TFLOP/s; bf16 peak "
              f"{PEAK_OPS['bfloat16'] / 1e12:.0f}), combine "
              f"{ms['combine']:.3f} ms, the layer {ms['layer']:.3f} ms "
              f"(the shared expert's products included)")
        del p, x, wgt, xe, ye, route
        torch.cuda.empty_cache()
        sub_time(f"16a {arch}", t0)

    # ---- 16b / 16d. serving at full width ----
    def serve_checks(tag, cfg, n_decode):
        """Phase 8's serving run on a MoE model, with the routing recorded
        where two runs round differently."""
        t0 = time.perf_counter()
        lm, prompts = serve.build(cfg, batch=MOE_BATCH,
                                  prompt_len=MOE_PROMPT, seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = sum(q.numel() for q in lm.parameters())
        print(f"[{tag}] {cfg.name}: {n_params / 1e9:.3f} B parameters "
              f"({cfg.param_count() / 1e9:.3f} B by param_count, "
              f"{cfg.param_count(active_only=True) / 1e9:.3f} B active), "
              f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} / "
              f"{cfg.n_kv_heads} heads of {cfg.head_dim}, {cfg.n_experts} "
              f"experts top-{cfg.moe_top_k}"
              f"{' + shared' if cfg.moe_shared_expert else ''}, f "
              f"{cfg.d_ff}, vocab {cfg.vocab_size}, window {cfg.window}, "
              f"{cfg.dtype}; built on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        total = MOE_PROMPT + n_decode + 1
        cache = lm.init_cache(MOE_BATCH, total)
        with record_routes(L) as flash_routes, held_attention(L) as attn:
            got, _ = lm.decode_step(prompts, cache, 0)
        ran = last_path()
        with record_routes(L) as plain_routes:
            lm.decode_step(prompts, cache, 0, impl="torch")
        again, _ = lm.decode_step(prompts, cache, 0)
        torch.cuda.synchronize()
        bitwise = torch.equal(got, again)
        del again
        # the whole model's logits are not held in bf16: a flip of a
        # near-tied top-k pick between the two runs changes that token's
        # output by a whole expert's share, and the flips spread with
        # depth; the f32 cut below holds them.  The flash kernel is held
        # on each layer's own q, k and v instead.
        routing_report(tag, "prefill, flash kernel vs plain attention",
                       flash_routes, plain_routes)
        worst = max(err for _, _, err in attn)
        shapes = sorted({(shape, window) for shape, window, _ in attn})
        print(f"[{tag}] prefill logits {tuple(got.shape)}; the flash kernel "
              f"({ran}) on each of the {len(attn)} layers' own q, k, v "
              f"{shapes} against its plain version: row rel err by layer "
              f"{', '.join(f'{err:.1e}' for _, _, err in attn)} (limit "
              f"{LM_BF16_TOL:.2e}); two prefills bitwise equal: {bitwise}")
        if len(attn) != cfg.n_layers or worst > LM_BF16_TOL:
            fail(f"phase {tag}: the flash kernel on the prefill's own inputs"
                 f" ({len(attn)} calls for {cfg.n_layers} layers) disagrees "
                 f"with its plain version ({worst:.3e})")
        if not bitwise:
            fail(f"phase {tag}: two prefills differ")
        del got, cache, flash_routes, plain_routes, attn
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        tokens, timing = serve.generate(lm, prompts, n_decode + 1)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        dec_ms = [t * 1e3 for t in timing.decode_s]
        p50 = float(np.median(dec_ms))
        print(f"[{tag}] prefill {MOE_BATCH} x {MOE_PROMPT} tokens in "
              f"{timing.prefill_s * 1e3:.2f} ms ("
              f"{MOE_BATCH * MOE_PROMPT / timing.prefill_s:.0f} tokens/s, "
              f"after empty_cache); {len(dec_ms)} decode steps p50 "
              f"{p50:.3f} ms max {max(dec_ms):.3f} ms ("
              f"{MOE_BATCH / (p50 / 1e3):.1f} tokens/s at p50); peak memory"
              f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; host "
              f"clock around each step + synchronize; launches in the serve"
              f" run {counts}; sample {tokens[0, :8].tolist()}", flush=True)
        if tuple(tokens.shape) != (MOE_BATCH, n_decode + 1) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            fail(f"phase {tag}: tokens {tuple(tokens.shape)} out of range")
        if counts["flash_attention"] != cfg.n_layers or \
                counts["fused_moe_ffn"] != 0:
            fail(f"phase {tag}: launches {counts} for one prefill of "
                 f"{cfg.n_layers} layers (expected that many flash "
                 f"launches and no fused_moe_ffn)")
        serve_step = steps.make_serve_step(lm)
        warm_ms = []
        for _ in range(3):
            cache = lm.init_cache(MOE_BATCH, total)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            serve_step(prompts, cache, 0)
            torch.cuda.synchronize()
            warm_ms.append((time.perf_counter() - t1) * 1e3)
            del cache
        print(f"[{tag}] prefill with the allocator warm: "
              f"{', '.join(f'{t:.2f}' for t in warm_ms)} ms "
              f"({MOE_BATCH * MOE_PROMPT / (min(warm_ms) / 1e3):.0f} "
              f"tokens/s at the fastest)")
        # replay: the same ops on a fresh cache give the served tokens
        cache = lm.init_cache(MOE_BATCH, total)
        logits, cache = lm.decode_step(prompts, cache, 0)
        picks = [logits[:, -1].argmax(-1)]
        for i in range(MOE_REPLAY):
            logits, cache = lm.decode_step(tokens[:, i:i + 1], cache,
                                           MOE_PROMPT + i)
            picks.append(logits[:, 0].argmax(-1))
        picks = torch.stack(picks, dim=1).to(tokens.dtype)
        if not torch.equal(picks, tokens[:, :MOE_REPLAY + 1]):
            fail(f"phase {tag}: replayed greedy picks {picks.tolist()} are "
                 f"not the served tokens "
                 f"{tokens[:, :MOE_REPLAY + 1].tolist()}")
        print(f"[{tag}] {MOE_REPLAY} replayed decode steps: greedy picks = "
              f"served tokens")
        del cache, logits
        torch.cuda.empty_cache()
        sub_time(tag, t0)
        return lm, prompts, tokens, counts

    cfg_g = get_config(MOE_ARCH, reduced=MOE_REDUCED)
    lm, prompts, tokens, counts = serve_checks("16b granite", cfg_g,
                                               MOE_DECODE)
    launches["granite prefill"] = counts

    # ---- 16c. trace: one granite prefill and one decode step ----
    t0 = time.perf_counter()
    cache = lm.init_cache(MOE_BATCH, MOE_PROMPT + 2)
    step = steps.make_serve_step(lm)
    for what, toks, cache_len in (("prefill", prompts, 0),
                                  ("decode step", tokens[:, :1],
                                   MOE_PROMPT)):
        ops_dev = {}
        with annotated(L):
            busy, wall, calls, by_kernel = trace(
                "16c", f"granite {what}",
                lambda: step(toks, cache, cache_len), top=12,
                ops_device=ops_dev)
        n_kernels = sum(calls.get(kn, 0) for kn in by_kernel)
        flash_us = sum(us for kn, us in by_kernel.items()
                       if "flash_attention" in kn)
        shares = {lab: ops_dev.get(lab, 0.0) for lab in (
            "moe.dispatch", "moe.experts", "moe.combine", "attention")}
        print(f"[16c trace] granite {what}: {n_kernels} device kernels; "
              f"device time of " + ", ".join(
                  f"{lab} {us / 1e3:.3f} ms ({us / max(busy, 1e-9):.3f})"
                  for lab, us in shares.items())
              + f"; the flash kernel {flash_us / 1e3:.3f} ms "
              f"({flash_us / max(busy, 1e-9):.3f}) of {busy / 1e3:.3f} ms "
              f"busy")
    del lm, prompts, tokens, cache, step
    torch.cuda.empty_cache()

    # ---- 16b. the f32 cut: 2 layers at full width ----
    cut_cfg = dataclasses.replace(cfg_g, n_layers=MOE_CUT_LAYERS,
                                  dtype="float32")
    cut = T.Transformer(cut_cfg, device=dev, seed=0)
    g_cut = torch.Generator(device=dev).manual_seed(161)
    toks = torch.randint(0, cut_cfg.vocab_size, (MOE_CUT_BATCH,
                                                 MOE_CUT_SEQ),
                         device=dev, generator=g_cut)
    with torch.inference_mode():
        with record_routes(L, gaps=True) as ra:
            got = cut(toks)
        ran = last_path()
        with record_routes(L, gaps=True) as rb:
            want = cut(toks, impl="torch")
    rows = routing_report("16b f32 cut", f"{MOE_CUT_LAYERS} layers, "
                          f"{MOE_CUT_BATCH} x {MOE_CUT_SEQ} tokens", ra, rb)
    for li, ((rta, gap), (rtb, _)) in enumerate(zip(ra, rb)):
        diff = ~(rta.experts == rtb.experts).all(-1)
        for r, t in diff.nonzero().tolist()[:8]:
            print(f"[16b f32 cut] layer {li} row {r} token {t}: sets "
                  f"{rta.experts[r, t].tolist()} / "
                  f"{rtb.experts[r, t].tolist()}, gate gap "
                  f"{float(gap[r, t]):.3e}")
    err = rel_err(got[rows], want[rows])[1] if bool(rows.any()) else 0.0
    print(f"[16b f32 cut] logits flash ({ran}) vs impl=torch on the "
          f"{int(rows.sum())} of {MOE_CUT_BATCH} rows whose routing agrees "
          f"everywhere: rel err {err:.3e} (tolerance {MOE_CUT_TOL})")
    if not bool(rows.any()) or err > MOE_CUT_TOL:
        fail(f"phase 16b: the f32 cut's logits disagree ({err:.3e}) or no "
             f"row routes alike")
    # the model's decode check: decode against forward where no capacity
    # drops, 8 tokens (cap 8); the served bf16 decode step's MoE layer is
    # held in 16a at its shape (S 1)
    short = toks[:, :8]
    with torch.inference_mode():
        full = cut(short)
        cache = cut.init_cache(MOE_CUT_BATCH, 8)
        dec = []
        for i in range(8):
            lg, cache = cut.decode_step(short[:, i:i + 1], cache, i)
            dec.append(lg[:, 0])
    err = rel_err(torch.stack(dec, 1), full)[1]
    print(f"[16b f32 cut] 8 tokens decoded one at a time vs the forward "
          f"(cap {L.moe_capacity(cut_cfg, 8)}: nothing dropped): rel err "
          f"{err:.3e} (tolerance {MOE_CUT_TOL})")
    if err > MOE_CUT_TOL:
        fail(f"phase 16b: the f32 cut's decode disagrees with its forward "
             f"({err:.3e})")
    del cut, got, want, ra, rb, full, cache, dec, lg
    # the same tokens through all of granite's layers in f32: with the
    # flash run's routing replayed in the plain run, the attention's f32
    # rounding, carried through the depth, stays within the cut's bar
    deep = T.Transformer(dataclasses.replace(cfg_g, dtype="float32"),
                         device=dev, seed=0)
    with torch.inference_mode():
        with record_routes(L) as ra:
            got = deep(toks)
        with record_routes(L) as rb:
            deep(toks, impl="torch")
        with replay_routes(L, ra):
            want = deep(toks, impl="torch")
    routing_report("16b f32 full depth", f"{cfg_g.n_layers} layers, "
                   f"{MOE_CUT_BATCH} x {MOE_CUT_SEQ} tokens", ra, rb)
    err = rel_err(got, want)[1]
    print(f"[16b f32 full depth] logits flash vs impl=torch with the flash "
          f"run's routing replayed: rel err {err:.3e} (tolerance "
          f"{MOE_CUT_TOL})")
    if err > MOE_CUT_TOL:
        fail(f"phase 16b: the f32 model's logits disagree on the flash "
             f"run's routing ({err:.3e})")
    del deep, toks, got, want, ra, rb
    torch.cuda.empty_cache()
    sub_time("16b f32 cut and 16c trace", t0)

    # ---- 16d. llama4-scout at full width, depth cut to fit one card ----
    cfg_l = get_config(MOE_WIDE_ARCH, reduced=MOE_REDUCED)
    cfg_l = dataclasses.replace(cfg_l, n_layers=min(cfg_l.n_layers,
                                                    MOE_WIDE_LAYERS))
    print(f"[16d llama4] depth cut to {cfg_l.n_layers} of "
          f"{get_config(MOE_WIDE_ARCH, reduced=MOE_REDUCED).n_layers} "
          f"layers (the whole model does not fit one 80 GB card); every "
          f"width as published", flush=True)
    lm, prompts, tokens, counts = serve_checks("16d llama4", cfg_l,
                                               MOE_WIDE_DECODE)
    launches["llama4 prefill"] = counts
    del lm, prompts, tokens
    torch.cuda.empty_cache()

    # ---- 16e. granite training at full width ----
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    lm = T.Transformer(cfg_g, device=dev, seed=0)
    gen_tok = torch.Generator(device=dev).manual_seed(162)
    batch = {kk: torch.randint(0, cfg_g.vocab_size, (MOE_BATCH, MOE_PROMPT),
                               device=dev, generator=gen_tok)
             for kk in ("tokens", "labels")}
    step = steps.make_train_step(lm, OptConfig(**MOE_TRAIN_OPT))
    state = adamw.init(lm.parameters())
    losses, lat, per_step = [], [], []
    for i in range(MOE_TRAIN_STEPS):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        lat.append((time.perf_counter() - t1) * 1e3)
        per_step.append(ops.launch_counts())
        print(f"[16e train] step {i + 1}: loss {losses[-1]:.5f} grad_norm "
              f"{float(metrics['grad_norm']):.4f} wall {lat[-1]:.1f} ms",
              flush=True)
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(lat[1:]))
    launches["granite train step"] = per_step[-1]
    print(f"[16e train] {cfg_g.name} {MOE_TRAIN_STEPS} steps of {MOE_BATCH}"
          f" x {MOE_PROMPT} tokens, remat {cfg_g.remat!r}: step p50 "
          f"{p50:.1f} ms, max {max(lat[1:]):.1f} ms over steps 2-"
          f"{MOE_TRAIN_STEPS} (host clock around the step; reading the loss "
          f"waits for the device; step 1 {lat[0]:.1f} ms), "
          f"{MOE_BATCH * MOE_PROMPT / (p50 / 1e3):.0f} tokens/s; peak "
          f"device memory {peak / 2**30:.2f} GiB, of it "
          f"{held / 2**30:.2f} GiB held before the phase: the run's own "
          f"{(peak - held) / 1e9:.2f} GB (reckoned ~{MOE_RECKONED_GB} GB); "
          f"kernel launches a step {per_step[-1]}")
    if not all(np.isfinite(losses)) or not min(losses[2:]) < losses[0]:
        fail(f"phase 16e: losses {losses}")
    if any(any(c.values()) for c in per_step):
        fail(f"phase 16e: the MoE training path launched {per_step}")
    ops_dev = {}
    with annotated(L):
        busy, wall, _, _ = trace(
            "16e", "granite training step",
            lambda: step(state, batch), top=12, ops_device=ops_dev)
    parts = {lab: ops_dev.get(lab, 0.0) for lab in (
        "moe.experts", "moe.dispatch", "moe.combine", "attention",
        "aten::bmm", "aten::mm")}
    print(f"[16e train] traced step: device busy {busy / 1e3:.1f} ms of "
          f"{wall / 1e3:.1f} ms ({busy / wall:.3f}); device time of "
          + ", ".join(f"{lab} {us / 1e3:.1f} ms ({us / busy:.3f})"
                      for lab, us in parts.items())
          + " (the moe.* and attention scopes hold the forward and its "
          "remat recompute; aten::bmm the expert products and the "
          "attention's einsums, forward, recompute and backward)")
    del lm, state, step, batch, metrics
    torch.cuda.empty_cache()
    sub_time("16e", t0)
    print(f"[16] phase 16 took {time.perf_counter() - t16:.1f} s; "
          f"launches by path {launches}", flush=True)
    return launches


def rope_f64(x, pos):
    """Interleaved-pair RoPE (θ = 10000) in f64: the oracles' own, written
    apart from the port's ``layers.apply_rope``."""
    import torch
    d = x.shape[-1]
    inv = 10000.0 ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                     device=x.device) / d)
    ang = pos.double()[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       -1).flatten(-2)


def mla_f64(p, cfg, x):
    """Multi-head latent attention in f64 without a cache: the latent
    expanded to K and V, RoPE on q and k, a causal softmax over the
    whole sequence."""
    import torch
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    pos = torch.arange(s, device=x.device)

    def heads(t):
        return t.view(b, s, h, dh).transpose(1, 2)
    q = rope_f64(heads(x @ p["wq"]), pos)
    lat = x @ p["w_dkv"]
    k = rope_f64(heads(lat @ p["w_uk"]), pos)
    v = heads(lat @ p["w_uv"])
    scores = (q @ k.transpose(-1, -2)) / dh ** 0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    return (att @ v).transpose(1, 2).reshape(b, s, h * dh) @ p["wo"]


def recurrence_f64(q, k, v, log_a, h0=None, normalize=False):
    """The linear recurrence one step at a time in f64: ``H_t = a_t H_{t-1}
    + k_tᵀ v_t``, ``o_t = q_t H_t`` (with ``normalize`` a ones column joins
    v and ``o = num / max(|n|, 1)``).  Returns ``(o, H_S)``."""
    import torch
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if normalize:
        v = torch.cat([v, v.new_ones(b, s, h, 1)], -1)
    state = q.new_zeros(b, h, dk, v.shape[-1]) if h0 is None else h0
    decay = torch.exp(log_a)[..., None, None]
    outs = []
    for t in range(s):
        state = state * decay[:, t] + k[:, t, :, :, None] * v[:, t, :, None]
        outs.append(torch.einsum("bhk,bhkv->bhv", q[:, t], state))
    o = torch.stack(outs, 1)
    if normalize:
        o = o[..., :dv] / o[..., dv:].abs().clamp_min(1.0)
    return o, state


def mamba_f64(p, cfg, x):
    """hymba's mamba heads in f64: the projections, dt and the decay, and
    ``recurrence_f64`` from a zero state (no normalizer)."""
    import torch.nn.functional as F
    b, s, _ = x.shape
    h, dh, n = cfg.n_heads, cfg.ssm_head_dim, cfg.ssm_state
    xin, z = (x @ p["w_in"]).chunk(2, -1)
    bc = (xin @ p["w_bc"]).view(b, s, h, 2 * n)
    dt = F.softplus(xin @ p["w_dt"])
    v = xin.view(b, s, h, dh) * dt[..., None]
    o, _ = recurrence_f64(bc[..., n:], bc[..., :n], v,
                          -dt * p["a_log"].exp())
    return (o.reshape(b, s, h * dh) * F.silu(z)) @ p["w_out_proj"]


def block_drift(lm, tokens):
    """The model's forward over ``tokens`` with the flash kernel and with
    the plain attention (``impl="torch"``): ``(the logits' rel err, each
    block's output rel err)``, read by forward hooks on the blocks."""
    import torch
    outs = {"cuda": [], "torch": []}

    def run(impl):
        hooks = [blk.register_forward_hook(
            lambda mod, args, out, impl=impl: outs[impl].append(out[0]))
            for blk in lm.blocks]
        try:
            with torch.inference_mode():
                return lm(tokens, impl=impl)
        finally:
            for h in hooks:
                h.remove()
    got, want = run("cuda"), run("torch")
    return rel_err(got, want)[1], [rel_err(a, b)[1] for a, b in
                                   zip(outs["cuda"], outs["torch"])]


def phase_17(dev) -> dict:
    """Multi-head latent attention and the attention + mamba hybrid: the
    layers and the recurrence alone (17a), minicpm3-4b (17b) and hymba-1.5b
    (17c) served at full width and depth with their f32 cuts and traces,
    and both trained (17d).  Returns the phase's launches by path."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import last_path
    from repro_torch.launch import serve, steps
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptConfig, adamw
    t17 = time.perf_counter()
    bf16, f64 = torch.bfloat16, torch.float64
    launches = {}
    cfgs = {arch: get_config(arch, reduced=P17_REDUCED)
            for arch in (P17_MLA, P17_HYBRID)}

    def sub_time(label, t0):
        print(f"[17] {label} took {time.perf_counter() - t0:.1f} s",
              flush=True)

    # ---- 17a. the layers alone at published widths ----
    b, s = P17_LAYER_BATCH, P17_LAYER_SEQ
    # (arch, init, layer, its f64 oracle, batch rows the oracle takes at
    # once: a row's f64 scores are 1.3 GB at 40 heads, and the stepwise
    # recurrence's launches do not grow with the rows)
    for arch, init, layer, oracle, rows in (
            (P17_MLA, L.mla_init, "mla_attention", mla_f64, 1),
            (P17_HYBRID, S.mamba_init, "mamba_apply", mamba_f64, b)):
        t0 = time.perf_counter()
        cfg = cfgs[arch]
        pos = torch.arange(s, device=dev)
        if layer == "mla_attention":
            def fwd(p_, x_, train):
                return L.mla_attention(p_, cfg, x_, pos=pos, train=train)[0]
        else:
            def fwd(p_, x_, train):
                return S.mamba_apply(p_, cfg, x_)[0]
        for dtype in (torch.float32, bf16):
            dname = str(dtype).split(".")[1]
            # the same draws in both dtypes (init_weight draws in f32 and
            # casts); the loss weights are bf16 values, so the upstream
            # gradient is the same in the run and in the oracle
            gen = torch.Generator(device=dev).manual_seed(170)
            p = init(gen, cfg, dtype, dev)
            x = torch.randn(b, s, cfg.d_model, device=dev,
                            generator=gen).to(dtype)
            wgt = torch.randn(b, s, cfg.d_model, device=dev,
                              generator=gen).to(bf16).float()
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            xs = x.detach().requires_grad_()
            y = fwd(leaves, xs, True)
            (y.float() * wgt).sum().backward()
            grads = {"x": xs.grad, **{k: v.grad for k, v in leaves.items()}}
            with torch.no_grad():
                served = fwd(p, x, False)
            # the oracle on the same (rounded) weights and inputs, ``rows``
            # batch rows at a time; weight gradients summed over them
            p64 = {k: v.detach().to(f64).requires_grad_()
                   for k, v in p.items()}
            y64, gx64 = [], []
            for r in range(0, b, rows):
                x64 = x[r:r + rows].to(f64).requires_grad_()
                yr = oracle(p64, cfg, x64)
                (yr * wgt[r:r + rows].double()).sum().backward()
                y64.append(yr.detach())
                gx64.append(x64.grad)
            y64 = torch.cat(y64)
            want = {"x": torch.cat(gx64),
                    **{k: v.grad for k, v in p64.items()}}
            errs = {"out (train path)": rel_err(y, y64, rows=True)[1],
                    "out (served path)": rel_err(served, y64, rows=True)[1]}
            errs.update({f"d{k}": rel_err(g, want[k], rows=True)[1]
                         for k, g in grads.items()})
            tol = P17_ORACLE_TOL if dtype == bf16 else TOL["float32"]
            print(f"[17a layer] {arch} {layer} B {b} x S {s}, d "
                  f"{cfg.d_model}, {cfg.n_heads} heads, {dname}, vs an f64 "
                  f"oracle, row rel err " + ", ".join(
                      f"{k} {v:.2e}" for k, v in errs.items())
                  + f" (limit {tol:.2e})", flush=True)
            if max(errs.values()) > tol:
                fail(f"phase 17a {arch}: {layer} in {dname} disagrees with "
                     f"its f64 oracle {errs}")
            del leaves, xs, y, grads, served, p64, y64, gx64, want
            torch.cuda.empty_cache()

            def train_call():
                ps = {k: v.detach().requires_grad_() for k, v in p.items()}
                (fwd(ps, x, True).float() * wgt).sum().backward()
            with torch.no_grad():
                fwd_ms = time_ms(lambda: fwd(p, x, False), iters=5)
            train_ms = time_ms(train_call, iters=5)
            print(f"[17a layer] {arch} {layer} {dname} per call (CUDA "
                  f"events, 5 calls after 3): served forward {fwd_ms:.3f} "
                  f"ms, training forward + backward {train_ms:.3f} ms")
            del p, x, wgt
        torch.cuda.empty_cache()
        sub_time(f"17a {arch}", t0)

    # the chunked recurrence at hymba's head shape against the stepwise
    # recurrence in f64, from a carried-in state
    t0 = time.perf_counter()
    rs = P17_RECURRENCE
    gen = torch.Generator(device=dev).manual_seed(171)

    def draw(*shape):
        return torch.randn(*shape, device=dev, generator=gen)
    q = draw(rs["b"], rs["s"], rs["h"], rs["dk"])
    k = draw(rs["b"], rs["s"], rs["h"], rs["dk"])
    v = draw(rs["b"], rs["s"], rs["h"], rs["dv"])
    log_a = -draw(rs["b"], rs["s"], rs["h"]).abs()
    for normalize in (False, True):
        h0 = draw(rs["b"], rs["h"], rs["dk"], rs["dv"] + normalize)
        with torch.no_grad():
            o, hf = S.chunked_linear_recurrence(q, k, v, log_a, h0=h0,
                                                normalize=normalize)
            o64, hf64 = recurrence_f64(q.double(), k.double(), v.double(),
                                       log_a.double(), h0.double(),
                                       normalize)
            ms = time_ms(lambda: S.chunked_linear_recurrence(
                q, k, v, log_a, h0=h0, normalize=normalize), iters=5)
        err_o, err_h = rel_err(o, o64)[1], rel_err(hf, hf64)[1]
        print(f"[17a recurrence] B {rs['b']} x S {rs['s']}, {rs['h']} heads,"
              f" dk {rs['dk']}, dv {rs['dv']}, normalize={normalize}, chunk "
              f"128, f32 vs the stepwise recurrence in f64: rel err output "
              f"{err_o:.3e}, h_final {err_h:.3e} (limit {MAIN_TOL}); "
              f"{ms:.3f} ms a call (CUDA events, 5 calls after 3)")
        if max(err_o, err_h) > MAIN_TOL:
            fail(f"phase 17a: the chunked recurrence disagrees with the "
                 f"stepwise one (normalize={normalize}: {err_o:.3e}, "
                 f"{err_h:.3e})")
    del q, k, v, log_a, h0, o, hf, o64, hf64
    torch.cuda.empty_cache()
    sub_time("17a recurrence", t0)

    # ---- 17b / 17c. serving at full width and depth ----
    def serve_checks(tag, cfg):
        """Phase 8's serving run: the flash kernel held on each layer's
        own q, k, v, the prefill logits against the plain attention,
        launches, times, the replayed picks and a trace."""
        t0 = time.perf_counter()
        lm, prompts = serve.build(cfg, batch=P17_BATCH,
                                  prompt_len=P17_PROMPT, seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = sum(q.numel() for q in lm.parameters())
        print(f"[{tag}] {cfg.name}: {n_params / 1e9:.3f} B parameters, "
              f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} / "
              f"{cfg.n_kv_heads} heads of {cfg.head_dim}, "
              + (f"MLA rank {cfg.mla_kv_rank}, " if cfg.mla else "")
              + (f"mamba state {cfg.ssm_state} x {cfg.ssm_head_dim}, "
                 if cfg.block_pattern == "attn+mamba" else "")
              + f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window "
              f"{cfg.window}, {cfg.dtype}; built on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        total = P17_PROMPT + P17_DECODE + 1
        cache = lm.init_cache(P17_BATCH, total)
        with held_attention(L) as attn:
            got, _ = lm.decode_step(prompts, cache, 0)
        ran = last_path()
        want, _ = lm.decode_step(prompts, lm.init_cache(P17_BATCH, total), 0,
                                 impl="torch")
        abs_err, rel = rel_err(got, want)
        agree = float((got[:, -1].argmax(-1) == want[:, -1].argmax(-1))
                      .float().mean())
        worst = max(err for _, _, err in attn)
        shapes = sorted({(shape, window) for shape, window, _ in attn})
        print(f"[{tag}] prefill logits {tuple(got.shape)} vs impl=torch: "
              f"max_abs={abs_err:.3e} rel={rel:.3e} (tolerance {LM_TOL}); "
              f"next-token agreement {agree:.2f}; the flash kernel ({ran}) "
              f"on each of the {len(attn)} layers' own q, k, v {shapes} "
              f"against its plain version: row rel err by layer "
              f"{', '.join(f'{err:.1e}' for _, _, err in attn)} (limit "
              f"{LM_BF16_TOL:.2e})", flush=True)
        if len(attn) != cfg.n_layers or worst > LM_BF16_TOL:
            fail(f"phase {tag}: the flash kernel on the prefill's own inputs"
                 f" ({len(attn)} calls for {cfg.n_layers} layers) disagrees "
                 f"with its plain version ({worst:.3e})")
        if P17_BF16_HELD[cfg.name] and rel > LM_TOL:
            fail(f"phase {tag}: bf16 prefill logits disagree with the plain "
                 f"attention (rel {rel:.3e} > {LM_TOL})")
        del got, want, cache, attn
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        tokens, timing = serve.generate(lm, prompts, P17_DECODE + 1)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        dec_ms = [t * 1e3 for t in timing.decode_s]
        p50 = float(np.median(dec_ms))
        print(f"[{tag}] prefill {P17_BATCH} x {P17_PROMPT} tokens in "
              f"{timing.prefill_s * 1e3:.2f} ms ("
              f"{P17_BATCH * P17_PROMPT / timing.prefill_s:.0f} tokens/s, "
              f"after empty_cache); {len(dec_ms)} decode steps p50 "
              f"{p50:.3f} ms max {max(dec_ms):.3f} ms ("
              f"{P17_BATCH / (p50 / 1e3):.1f} tokens/s at p50); peak memory"
              f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; host "
              f"clock around each step + synchronize; launches in the serve"
              f" run {counts}; sample {tokens[0, :8].tolist()}", flush=True)
        if tuple(tokens.shape) != (P17_BATCH, P17_DECODE + 1) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            fail(f"phase {tag}: tokens {tuple(tokens.shape)} out of range")
        if counts["flash_attention"] != cfg.n_layers or \
                sum(counts.values()) != cfg.n_layers:
            fail(f"phase {tag}: launches {counts} for one prefill of "
                 f"{cfg.n_layers} layers (expected that many flash "
                 f"launches and nothing else)")
        serve_step = steps.make_serve_step(lm)
        warm_ms = []
        for _ in range(3):
            cache = lm.init_cache(P17_BATCH, total)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            serve_step(prompts, cache, 0)
            torch.cuda.synchronize()
            warm_ms.append((time.perf_counter() - t1) * 1e3)
            del cache
        print(f"[{tag}] prefill with the allocator warm: "
              f"{', '.join(f'{t:.2f}' for t in warm_ms)} ms "
              f"({P17_BATCH * P17_PROMPT / (min(warm_ms) / 1e3):.0f} "
              f"tokens/s at the fastest)")
        cache = lm.init_cache(P17_BATCH, total)
        logits, cache = lm.decode_step(prompts, cache, 0)
        picks = [logits[:, -1].argmax(-1)]
        for i in range(P17_REPLAY):
            logits, cache = lm.decode_step(tokens[:, i:i + 1], cache,
                                           P17_PROMPT + i)
            picks.append(logits[:, 0].argmax(-1))
        picks = torch.stack(picks, dim=1).to(tokens.dtype)
        if not torch.equal(picks, tokens[:, :P17_REPLAY + 1]):
            fail(f"phase {tag}: replayed greedy picks {picks.tolist()} are "
                 f"not the served tokens "
                 f"{tokens[:, :P17_REPLAY + 1].tolist()}")
        print(f"[{tag}] {P17_REPLAY} replayed decode steps: greedy picks = "
              f"served tokens")
        del cache, logits
        # trace: one prefill and one decode step
        cache = lm.init_cache(P17_BATCH, P17_PROMPT + 2)
        for what, toks, cache_len in (("prefill", prompts, 0),
                                      ("decode step", tokens[:, :1],
                                       P17_PROMPT)):
            ops_dev = {}
            with annotated(L), annotated(S):
                busy, wall, calls, by_kernel = trace(
                    tag, f"{cfg.name} {what}",
                    lambda: serve_step(toks, cache, cache_len), top=12,
                    ops_device=ops_dev)
            n_kernels = sum(calls.get(kn, 0) for kn in by_kernel)
            flash_us = sum(us for kn, us in by_kernel.items()
                           if "flash_attention" in kn)
            shares = {lab: ops_dev.get(lab, 0.0)
                      for lab in ("attention", "mamba", "recurrence")}
            print(f"[{tag} trace] {cfg.name} {what}: {n_kernels} device "
                  f"kernels; device time of " + ", ".join(
                      f"{lab} {us / 1e3:.3f} ms ({us / max(busy, 1e-9):.3f})"
                      for lab, us in shares.items())
                  + f"; the flash kernel {flash_us / 1e3:.3f} ms "
                  f"({flash_us / max(busy, 1e-9):.3f}) of {busy / 1e3:.3f} "
                  f"ms busy")
        del cache
        # through the depth: each block's output with the flash kernel
        # against the plain attention (one prompt, the forward), bf16 and
        # then the same weights in f32, which is held
        for dtype in ("bfloat16", "float32"):
            if dtype == "float32":
                lm.float()
            err, by_block = block_drift(lm, prompts[:1])
            print(f"[{tag}] {dtype} at full depth, one prompt, flash vs "
                  f"impl=torch: logits rel err {err:.3e}; block outputs "
                  f"by block {', '.join(f'{e:.1e}' for e in by_block)}",
                  flush=True)
        if err > P17_CUT_TOL:
            fail(f"phase {tag}: the f32 model's logits disagree with the "
                 f"plain attention ({err:.3e} > {P17_CUT_TOL})")
        del lm, prompts, tokens, serve_step
        torch.cuda.empty_cache()
        sub_time(tag, t0)
        return counts

    def f32_cut(tag, cfg):
        """2 layers at full width in f32: the prefill's logits with the
        flash kernel against the plain attention, and 8 tokens decoded
        after the prefill against the forward over prompt + tokens."""
        t0 = time.perf_counter()
        cut_cfg = dataclasses.replace(cfg, n_layers=P17_CUT_LAYERS,
                                      dtype="float32")
        cut = T.Transformer(cut_cfg, device=dev, seed=0)
        nb, ns = P17_CUT_SHAPE[cfg.name]
        g = torch.Generator(device=dev).manual_seed(172)
        toks = torch.randint(0, cut_cfg.vocab_size,
                             (nb, ns + P17_CUT_DECODE), device=dev,
                             generator=g)
        with torch.inference_mode():
            full = cut(toks)
            ran = last_path()
            plain = cut(toks, impl="torch")
            cache = cut.init_cache(nb, ns + P17_CUT_DECODE)
            pre, cache = cut.decode_step(toks[:, :ns], cache, 0)
            dec = []
            for i in range(P17_CUT_DECODE):
                lg, cache = cut.decode_step(toks[:, ns + i:ns + i + 1],
                                            cache, ns + i)
                dec.append(lg[:, 0])
        errs = {"flash vs plain": rel_err(full, plain)[1],
                "prefill vs forward": rel_err(pre, full[:, :ns])[1],
                "decode vs forward": rel_err(torch.stack(dec, 1),
                                             full[:, ns:])[1]}
        print(f"[{tag} f32 cut] {P17_CUT_LAYERS} layers at full width, "
              f"{nb} x {ns} tokens + {P17_CUT_DECODE} decoded ({ran}"
              + (f"; the {cut_cfg.window}-slot ring wrapped"
                 if 0 < cut_cfg.window < ns else "")
              + "): rel err " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in errs.items())
              + f" (tolerance {P17_CUT_TOL})")
        if max(errs.values()) > P17_CUT_TOL:
            fail(f"phase {tag}: the f32 cut disagrees {errs}")
        del cut, toks, full, plain, cache, pre, dec, lg
        torch.cuda.empty_cache()
        sub_time(f"{tag} f32 cut", t0)

    for tag, arch in (("17b minicpm3", P17_MLA), ("17c hymba", P17_HYBRID)):
        launches[f"{arch} prefill"] = serve_checks(tag, cfgs[arch])
        f32_cut(tag, cfgs[arch])

    # ---- 17d. training at full width ----
    for arch in (P17_HYBRID, P17_MLA):
        t0 = time.perf_counter()
        cfg = cfgs[arch]
        nb = P17_TRAIN_BATCH[arch]
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        lm = T.Transformer(cfg, device=dev, seed=0)
        gen_tok = torch.Generator(device=dev).manual_seed(173)
        batch = {kk: torch.randint(0, cfg.vocab_size, (nb, P17_PROMPT),
                                   device=dev, generator=gen_tok)
                 for kk in ("tokens", "labels")}
        step = steps.make_train_step(lm, OptConfig(**P17_TRAIN_OPT))
        state = adamw.init(lm.parameters())
        losses, lat, per_step = [], [], []
        for i in range(P17_TRAIN_STEPS):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            lat.append((time.perf_counter() - t1) * 1e3)
            per_step.append(ops.launch_counts())
            print(f"[17d train] {arch} step {i + 1}: loss {losses[-1]:.5f} "
                  f"grad_norm {float(metrics['grad_norm']):.4f} wall "
                  f"{lat[-1]:.1f} ms", flush=True)
        peak = torch.cuda.max_memory_allocated()
        p50 = float(np.median(lat[1:]))
        launches[f"{arch} train step"] = per_step[-1]
        print(f"[17d train] {arch} {P17_TRAIN_STEPS} steps of {nb} x "
              f"{P17_PROMPT} tokens, remat {cfg.remat!r}: step p50 "
              f"{p50:.1f} ms, max {max(lat[1:]):.1f} ms over steps 2-"
              f"{P17_TRAIN_STEPS} (host clock around the step; reading the "
              f"loss waits for the device; step 1 {lat[0]:.1f} ms), "
              f"{nb * P17_PROMPT / (p50 / 1e3):.0f} tokens/s; peak device "
              f"memory {peak / 2**30:.2f} GiB, of it {held / 2**30:.2f} GiB "
              f"held before: the run's own {(peak - held) / 1e9:.2f} GB "
              f"(reckoned ~{P17_RECKONED_GB[arch]} GB); kernel launches a "
              f"step {per_step[-1]}")
        if not all(np.isfinite(losses)) or not min(losses[2:]) < losses[0]:
            fail(f"phase 17d {arch}: losses {losses}")
        if any(any(c.values()) for c in per_step):
            fail(f"phase 17d {arch}: the training path launched {per_step}")
        ops_dev = {}
        with annotated(L), annotated(S):
            # no warm-up call: six steps ran, and training launches no
            # ctypes kernel that a profiler session could drop
            busy, wall, _, _ = trace(
                "17d", f"{arch} training step", lambda: step(state, batch),
                warm=lambda: None, top=10, ops_device=ops_dev)
        parts = {lab: ops_dev.get(lab, 0.0) for lab in (
            "attention", "mamba", "recurrence", "aten::bmm", "aten::mm")}
        print(f"[17d train] {arch} traced step: device busy "
              f"{busy / 1e3:.1f} ms of {wall / 1e3:.1f} ms "
              f"({busy / wall:.3f}); device time of " + ", ".join(
                  f"{lab} {us / 1e3:.1f} ms ({us / busy:.3f})"
                  for lab, us in parts.items())
              + " (the attention, mamba and recurrence scopes hold the "
              "forward and its remat recompute)")
        del lm, state, step, batch, metrics
        torch.cuda.empty_cache()
        sub_time(f"17d {arch}", t0)
    print(f"[17] phase 17 took {time.perf_counter() - t17:.1f} s; "
          f"launches by path {launches}", flush=True)
    return launches


# ---------------------------------------------------------------- phase 18 --
def once_ms(fn):
    """ms of one call of ``fn`` on the host clock, synchronized on both
    sides: what a host-bound call costs (its launches paced by the host)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def mlstm_f64(p, cfg, x, rnd=None):
    """xLSTM's mLSTM block in f64, in the parallel form of its
    recurrence: ``o_t = Σ_{j<=t} exp(F_t - F_j) (q_t·k_j) v_j`` over the
    normalizer ``max(|Σ_j exp(F_t - F_j) q_t·k_j|, 1)``, ``F`` the running
    sum of the log forget gates, k scaled by ``1/sqrt(dh)`` and the input
    gate; gated by ``silu(gate)``.  ``rnd``, when given, is applied where a
    bf16 model rounds (each bf16 product, the scaled and gated k, the
    recurrence's output, the gate) and nowhere else."""
    import torch
    import torch.nn.functional as F
    rnd = rnd or (lambda t: t)
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.ssm_head_dim

    def heads(t):
        return t.view(b, s, h, dh).transpose(1, 2)
    main, gate = rnd(x @ p["w_up"]).chunk(2, -1)
    i_gate = torch.sigmoid(main @ p["w_i"]).transpose(1, 2)[..., None]
    q = heads(rnd(main @ p["wq"]))
    k = rnd(rnd(heads(rnd(main @ p["wk"])) / dh ** 0.5) * rnd(i_gate))
    v = heads(rnd(main @ p["wv"]))
    cum = F.logsigmoid(main @ p["w_f"]).transpose(1, 2).cumsum(-1)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    decay = (cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~causal, float("-inf"))
    w = (q @ k.transpose(-1, -2)) * torch.exp(decay)
    o = (w @ v) / w.sum(-1, keepdim=True).abs().clamp_min(1.0)
    o = rnd(o.transpose(1, 2).reshape(b, s, h * dh))
    return rnd(rnd(o * rnd(F.silu(gate))) @ p["w_down"])


def slstm_f64(p, cfg, x, rnd=None):
    """xLSTM's sLSTM block in f64, one step at a time from zeros: ``u =
    x_t·w_up + hid·w_rec``, ``c = σ(f)·c + σ(i)·tanh(z)``, ``hid =
    σ(o)·tanh(c)``.  ``rnd``, when given, is applied where a bf16 model
    rounds (the up-projection, the hidden states, the output)."""
    import torch
    rnd = rnd or (lambda t: t)
    b, s, _ = x.shape
    inner = cfg.n_heads * cfg.ssm_head_dim
    pre = rnd(x @ p["w_up"])
    c = x.new_zeros(b, inner)
    hid = x.new_zeros(b, inner)
    hs = []
    for t in range(s):
        z, i, f, o = (pre[:, t] + hid @ p["w_rec"]).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
        hid = torch.sigmoid(o) * torch.tanh(c)
        hs.append(hid)
    return rnd(rnd(torch.stack(hs, 1)) @ p["w_down"])


def train_steps(tag, lm, batch, opt, n_steps):
    """``n_steps`` AdamW steps of ``lm`` on one fixed ``batch`` with the
    launch counts from 0 before each: ``(losses, host ms a step, launches a
    step, peak device bytes)``; fails unless the losses are finite and
    fall (``min(losses[2:]) < losses[0]``) and no kernel launched."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.optim import OptConfig, adamw
    torch.cuda.reset_peak_memory_stats()
    step = steps.make_train_step(lm, OptConfig(**opt))
    state = adamw.init(lm.parameters())
    losses, lat, per_step = [], [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        lat.append((time.perf_counter() - t1) * 1e3)
        per_step.append(ops.launch_counts())
        print(f"[{tag}] step {i + 1}: loss {losses[-1]:.5f} grad_norm "
              f"{float(metrics['grad_norm']):.4f} wall {lat[-1]:.1f} ms",
              flush=True)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not min(losses[2:]) < losses[0]:
        fail(f"phase {tag}: losses {losses}")
    if any(any(c.values()) for c in per_step):
        fail(f"phase {tag}: the training path launched {per_step}")
    return losses, lat, per_step[-1], peak


def phase_18(dev) -> dict:
    """The xLSTM stack: the mLSTM and sLSTM blocks and the normalized
    recurrence alone (18a), xlstm-1.3b served at full width and depth with
    the sLSTM's host cost and an 8-layer f32 cut (18b), and trained (18c).
    Returns the phase's launches by path (all zero: attention-free)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, steps
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    t18 = time.perf_counter()
    bf16, f64 = torch.bfloat16, torch.float64
    cfg = get_config(P18_ARCH, reduced=P18_REDUCED)
    launches = {}

    def sub_time(label, t0):
        print(f"[18] {label} took {time.perf_counter() - t0:.1f} s",
              flush=True)

    # ---- 18a. the blocks alone at published widths ----
    b, s = P18_LAYER_BATCH, P18_LAYER_SEQ
    for layer, init, apply_fn, oracle in (
            ("mlstm_apply", S.mlstm_init, S.mlstm_apply, mlstm_f64),
            ("slstm_apply", S.slstm_init, S.slstm_apply, slstm_f64)):
        t0 = time.perf_counter()
        for dtype in (torch.float32, bf16):
            dname = str(dtype).split(".")[1]
            # the same draws in both dtypes; the loss weights are bf16
            # values, so the upstream gradient is the same in the oracle
            gen = torch.Generator(device=dev).manual_seed(180)
            p = init(gen, cfg, dtype, dev)
            x = torch.randn(b, s, cfg.d_model, device=dev,
                            generator=gen).to(dtype)
            wgt = torch.randn(b, s, cfg.d_model, device=dev,
                              generator=gen).to(bf16).float()
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            xs = x.detach().requires_grad_()
            y = apply_fn(leaves, cfg, xs)[0]
            (y.float() * wgt).sum().backward()
            grads = {"x": xs.grad, **{k: v.grad for k, v in leaves.items()}}
            def errors(rnd):
                """Row errors of the output and the gradients against the
                f64 oracle with the roundings ``rnd``."""
                p64 = {k: v.detach().to(f64).requires_grad_()
                       for k, v in p.items()}
                x64 = x.to(f64).requires_grad_()
                y64 = oracle(p64, cfg, x64, rnd)
                (y64 * wgt.double()).sum().backward()
                want = {"x": x64.grad,
                        **{k: v.grad for k, v in p64.items()}}
                errs = {"out": rel_err(y, y64, rows=True)[1]}
                # the gate weights (inner, heads) are held head by head:
                # a row of 4 gate gradients has no scale of its own
                errs.update({f"d{k}": rel_err(*((g.T, want[k].T)
                                                if k in P18_GATES
                                                else (g, want[k])),
                                              rows=True)[1]
                             for k, g in grads.items()})
                return errs
            if dtype == bf16:
                # the oracle as an f64 computation, unrounded: printed
                free = errors(None)
                print(f"[18a layer] {layer} bf16 vs the unrounded f64 "
                      f"oracle (printed), row rel err " + ", ".join(
                          f"{k} {v:.2e}" for k, v in free.items()))
            # held: the oracle rounding to the run's dtype where the model
            # rounds, in both directions (a bf16 cast rounds its gradient)
            errs = errors(None if dtype == torch.float32 else
                          (lambda t: t.to(dtype).to(f64)))
            tol = P18_ORACLE_TOL if dtype == bf16 else TOL["float32"]
            print(f"[18a layer] {layer} B {b} x S {s}, d {cfg.d_model}, "
                  f"{cfg.n_heads} heads of {cfg.ssm_head_dim}, {dname}, vs "
                  f"an f64 oracle" + (" rounding where the model rounds"
                                      if dtype == bf16 else "")
                  + ", row rel err " + ", ".join(
                      f"{k} {v:.2e}" for k, v in errs.items())
                  + f" (limit {tol:.2e})", flush=True)
            if max(errs.values()) > tol:
                fail(f"phase 18a: {layer} in {dname} disagrees with its "
                     f"f64 oracle {errs}")
            del leaves, xs, y, grads
            torch.cuda.empty_cache()

            def train_call():
                ps = {k: v.detach().requires_grad_() for k, v in p.items()}
                (apply_fn(ps, cfg, x)[0].float() * wgt).sum().backward()
            with torch.no_grad():
                fwd_ms = once_ms(lambda: apply_fn(p, cfg, x))
            train_ms = once_ms(train_call)
            print(f"[18a layer] {layer} {dname} one call (host clock, "
                  f"synchronized, after the checked call): forward "
                  f"{fwd_ms:.1f} ms, forward + backward {train_ms:.1f} ms")
            del p, x, wgt
        torch.cuda.empty_cache()
        sub_time(f"18a {layer}", t0)

    # the normalized chunked recurrence at the mLSTM's head shape against
    # the stepwise recurrence in f64, from a carried-in state
    t0 = time.perf_counter()
    rs = P18_RECURRENCE
    gen = torch.Generator(device=dev).manual_seed(181)

    def draw(*shape):
        return torch.randn(*shape, device=dev, generator=gen)
    q = draw(rs["b"], rs["s"], rs["h"], rs["dk"]) / rs["dk"] ** 0.5
    k = draw(rs["b"], rs["s"], rs["h"], rs["dk"]) / rs["dk"] ** 0.5
    v = draw(rs["b"], rs["s"], rs["h"], rs["dv"])
    log_a = -draw(rs["b"], rs["s"], rs["h"]).abs()
    h0 = draw(rs["b"], rs["h"], rs["dk"], rs["dv"] + 1)
    with torch.no_grad():
        o, hf = S.chunked_linear_recurrence(q, k, v, log_a, h0=h0)
        o64, hf64 = recurrence_f64(q.double(), k.double(), v.double(),
                                   log_a.double(), h0.double(), True)
        ms = time_ms(lambda: S.chunked_linear_recurrence(q, k, v, log_a,
                                                         h0=h0), iters=5)
    err_o, err_h = rel_err(o, o64)[1], rel_err(hf, hf64)[1]
    print(f"[18a recurrence] B {rs['b']} x S {rs['s']}, {rs['h']} heads, dk "
          f"{rs['dk']}, dv {rs['dv']}, normalize=True, chunk 128, f32 vs "
          f"the stepwise recurrence in f64: rel err output {err_o:.3e}, "
          f"h_final {err_h:.3e} (limit {MAIN_TOL}); {ms:.3f} ms a call "
          f"(CUDA events, 5 calls after 3)")
    if max(err_o, err_h) > MAIN_TOL:
        fail(f"phase 18a: the normalized chunked recurrence disagrees with "
             f"the stepwise one ({err_o:.3e}, {err_h:.3e})")
    del q, k, v, log_a, h0, o, hf, o64, hf64
    torch.cuda.empty_cache()
    sub_time("18a recurrence", t0)

    # ---- 18b. serving at full width and depth ----
    t0 = time.perf_counter()
    lm, prompts = serve.build(cfg, batch=P18_BATCH, prompt_len=P18_PROMPT,
                              seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm.parameters())
    inner = cfg.n_heads * cfg.ssm_head_dim
    print(f"[18b] {cfg.name}: {n_params / 1e9:.3f} B parameters, "
          f"{cfg.n_layers} layers ({len(lm.groups)} groups of 7 mLSTM + 1 "
          f"sLSTM), d {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.ssm_head_dim} (mLSTM state {cfg.ssm_head_dim} x "
          f"{cfg.ssm_head_dim + 1} f32 a head), sLSTM width {inner}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}; built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tokens, timing = serve.generate(lm, prompts, P18_DECODE + 1)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    launches[f"{cfg.name} serve"] = counts
    dec_ms = [t * 1e3 for t in timing.decode_s]
    p50 = float(np.median(dec_ms))
    print(f"[18b] prefill {P18_BATCH} x {P18_PROMPT} tokens in "
          f"{timing.prefill_s * 1e3:.2f} ms ("
          f"{P18_BATCH * P18_PROMPT / timing.prefill_s:.0f} tokens/s, after "
          f"empty_cache); {len(dec_ms)} decode steps p50 {p50:.3f} ms max "
          f"{max(dec_ms):.3f} ms ({P18_BATCH / (p50 / 1e3):.1f} tokens/s at "
          f"p50); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; host clock "
          f"around each step + synchronize; launches in the serve run "
          f"{counts}; sample {tokens[0, :8].tolist()}", flush=True)
    if tuple(tokens.shape) != (P18_BATCH, P18_DECODE + 1) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        fail(f"phase 18b: tokens {tuple(tokens.shape)} out of range")
    if any(counts.values()):
        fail(f"phase 18b: the attention-free stack launched {counts}")
    serve_step = steps.make_serve_step(lm)
    total = P18_PROMPT + P18_DECODE + 1
    cache = lm.init_cache(P18_BATCH, total)
    warm = once_ms(lambda: serve_step(prompts, cache, 0))
    print(f"[18b] prefill with the allocator warm: {warm:.2f} ms "
          f"({P18_BATCH * P18_PROMPT / (warm / 1e3):.0f} tokens/s)")
    cache = lm.init_cache(P18_BATCH, total)
    logits, cache = lm.decode_step(prompts, cache, 0)
    picks = [logits[:, -1].argmax(-1)]
    for i in range(P18_REPLAY):
        logits, cache = lm.decode_step(tokens[:, i:i + 1], cache,
                                       P18_PROMPT + i)
        picks.append(logits[:, 0].argmax(-1))
    picks = torch.stack(picks, dim=1).to(tokens.dtype)
    if not torch.equal(picks, tokens[:, :P18_REPLAY + 1]):
        fail(f"phase 18b: replayed greedy picks {picks.tolist()} are not "
             f"the served tokens {tokens[:, :P18_REPLAY + 1].tolist()}")
    print(f"[18b] {P18_REPLAY} replayed decode steps: greedy picks = served "
          f"tokens")
    del cache, logits
    # the sLSTM's host cost, from short windows: a 4 x 256 prefill of the
    # whole stack, one sLSTM layer alone over the same tokens, and a
    # decode step
    pb, ps = P18_PROFILE_SHAPE
    short = prompts[:pb, :ps]
    cache = lm.init_cache(pb, ps + 1)
    busy, wall, calls, by_kernel = trace(
        "18b", f"{cfg.name} prefill {pb} x {ps}",
        lambda: serve_step(short, cache, 0), top=10)
    n_prefill = sum(calls.get(kn, 0) for kn in by_kernel)
    grp = lm.groups[0]
    h_in = torch.randn(pb, ps, cfg.d_model, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(
                           182)).to(lm.dtype)
    with torch.inference_mode():
        s_busy, s_wall, s_calls, s_kernels = trace(
            "18b", f"one sLSTM layer over {pb} x {ps}",
            lambda: S.slstm_apply(grp.slstm, cfg, h_in), top=8)
    n_slstm = sum(s_calls.get(kn, 0) for kn in s_kernels)
    n_groups = len(lm.groups)
    cache = lm.init_cache(P18_BATCH, total)
    serve_step(prompts[:, :1], cache, 0)
    d_busy, d_wall, d_calls, d_kernels = trace(
        "18b", f"{cfg.name} decode step",
        lambda: serve_step(prompts[:, :1], cache, 1), top=8)
    n_decode = sum(d_calls.get(kn, 0) for kn in d_kernels)
    print(f"[18b host cost] prefill {pb} x {ps}: {n_prefill} device kernels "
          f"({n_prefill / ps:.1f} a token position), device busy "
          f"{busy / wall:.3f} of {wall / 1e3:.1f} ms; one sLSTM layer over "
          f"it: {n_slstm} kernels ({n_slstm / ps:.2f} a time step), "
          f"{s_wall / 1e3:.1f} ms wall ({s_wall / ps:.1f} us a time step), "
          f"device busy {s_busy / s_wall:.3f}; the {n_groups} sLSTM layers "
          f"are {n_groups * n_slstm / max(n_prefill, 1):.3f} of the "
          f"prefill's kernels and {n_groups * s_wall / wall:.3f} of its "
          f"wall; so a {P18_BATCH} x {P18_PROMPT} forward launches "
          f"~{n_groups * n_slstm / ps * P18_PROMPT:.0f} sLSTM kernels; a "
          f"decode step: {n_decode} kernels, device busy "
          f"{d_busy / d_wall:.3f} of {d_wall / 1e3:.2f} ms", flush=True)
    del lm, prompts, tokens, serve_step, cache, short, h_in, grp
    torch.cuda.empty_cache()
    sub_time("18b", t0)

    # the f32 cut: one group of 8 layers at full width
    t0 = time.perf_counter()
    cut_cfg = dataclasses.replace(cfg, n_layers=P18_CUT_LAYERS,
                                  dtype="float32")
    cut = T.Transformer(cut_cfg, device=dev, seed=0)
    nb, ns = P18_CUT_SHAPE
    toks = torch.randint(0, cut_cfg.vocab_size, (nb, ns + P18_CUT_DECODE),
                         device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             183))
    with torch.inference_mode():
        full = cut(toks)
        cache = cut.init_cache(nb, ns + P18_CUT_DECODE)
        pre, cache = cut.decode_step(toks[:, :ns], cache, 0)
        dec = []
        for i in range(P18_CUT_DECODE):
            lg, cache = cut.decode_step(toks[:, ns + i:ns + i + 1], cache,
                                        ns + i)
            dec.append(lg[:, 0])
    errs = {"prefill vs forward": rel_err(pre, full[:, :ns])[1],
            "decode vs forward": rel_err(torch.stack(dec, 1),
                                         full[:, ns:])[1]}
    print(f"[18b f32 cut] {P18_CUT_LAYERS} layers at full width, {nb} x "
          f"{ns} tokens + {P18_CUT_DECODE} decoded: rel err " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tolerance {P18_CUT_TOL})")
    if max(errs.values()) > P18_CUT_TOL:
        fail(f"phase 18b: the f32 cut disagrees {errs}")
    del cut, toks, full, cache, pre, dec, lg
    torch.cuda.empty_cache()
    sub_time("18b f32 cut", t0)

    # ---- 18c. training at full width and depth ----
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    lm = T.Transformer(cfg, device=dev, seed=0)
    nb, ns = P18_TRAIN_SHAPE
    gen_tok = torch.Generator(device=dev).manual_seed(184)
    batch = {kk: torch.randint(0, cfg.vocab_size, (nb, ns), device=dev,
                               generator=gen_tok)
             for kk in ("tokens", "labels")}
    losses, lat, per_step, peak = train_steps(
        "18c train", lm, batch, P18_TRAIN_OPT, P18_TRAIN_STEPS)
    launches[f"{cfg.name} train step"] = per_step
    p50 = float(np.median(lat[1:]))
    print(f"[18c train] {cfg.name} {P18_TRAIN_STEPS} steps of {nb} x {ns} "
          f"tokens, remat {cfg.remat!r} (the mLSTM blocks): step p50 "
          f"{p50:.1f} ms, max {max(lat[1:]):.1f} ms over steps 2-"
          f"{P18_TRAIN_STEPS} (host clock around the step; reading the loss "
          f"waits for the device; step 1 {lat[0]:.1f} ms), "
          f"{nb * ns / (p50 / 1e3):.0f} tokens/s; peak device memory "
          f"{peak / 2**30:.2f} GiB, of it {held / 2**30:.2f} GiB held "
          f"before: the run's own {(peak - held) / 1e9:.2f} GB (reckoned "
          f"~{P18_RECKONED_GB} GB); kernel launches a step {per_step}; no "
          f"step is traced (~5 x 10^5 launches)")
    del lm, batch
    torch.cuda.empty_cache()
    sub_time("18c", t0)
    print(f"[18] phase 18 took {time.perf_counter() - t18:.1f} s; launches "
          f"by path {launches}", flush=True)
    return launches


# ---------------------------------------------------------------- phase 19 --
@contextlib.contextmanager
def cross_norms(layers):
    """While active, each ``layers.cross_attention`` call appends the norm
    of its output to the yielded list: a cross-attention that adds nothing
    (an encoder on zeros) shows as 0."""
    norms = []
    xattn = layers.cross_attention

    def recorded(*args, **kwargs):
        out = xattn(*args, **kwargs)
        norms.append(float(out.float().norm()))
        return out
    layers.cross_attention = recorded
    try:
        yield norms
    finally:
        layers.cross_attention = xattn


def phase_19(dev) -> dict:
    """The encoder-decoder and the vision stub: the flash kernel at their
    shapes (19a), whisper-medium served at full width and depth with its
    f32 cut (19b) and trained (19c), qwen2-vl-72b served at full width,
    24 of 80 layers, with its f32 cut (19d), and a 2-layer cut of it
    trained on embeddings (19e).  Returns ``{"launches": by path,
    "flash": the 19a records}``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import last_path
    from repro_torch.launch import serve, steps
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    t19 = time.perf_counter()
    bf16 = torch.bfloat16
    launches, flash = {}, {}

    def sub_time(label, t0):
        print(f"[19] {label} took {time.perf_counter() - t0:.1f} s",
              flush=True)

    def randn(*shape, seed):
        return torch.randn(*shape, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               seed))

    # ---- 19a. the flash kernel at the paths' shapes ----
    t0 = time.perf_counter()
    for n, (label, b, h, hkv, sq, sk, d, causal) in enumerate(
            P19_FLASH_CASES):
        q = randn(b, h, sq, d, seed=190 + n).to(bf16)
        k = randn(b, hkv, sk, d, seed=290 + n).to(bf16)
        v = randn(b, hkv, sk, d, seed=390 + n).to(bf16)
        got = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ran = last_path()
        want = ref.attention(q, k, v, causal=causal)
        abs_err, rel = rel_err(got, want, rows=True)
        if ran != FLASH_WGMMA or rel > LM_BF16_TOL:
            fail(f"phase 19a: {label} ran {ran}, row rel err {rel:.3e} "
                 f"(expected {FLASH_WGMMA} within {LM_BF16_TOL:.2e})")
        pairs = int(ref.attention_mask(sq, sk, causal=causal, window=0,
                                       device=dev).sum()) * b * h
        moved = float(sum(t.numel() * t.element_size() for t in (q, k, v))
                      + q.numel() * q.element_size())
        bound_bytes = moved / HBM_BYTES_PER_S * 1e3
        bound_ops = 4.0 * d * pairs / PEAK_OPS["bfloat16"] * 1e3
        ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
        plain_ms = time_ms(lambda: ref.attention(q, k, v, causal=causal))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=hkv != h))
        rec = dict(ms=ms, plain_ms=plain_ms,
                   bound_ms=max(bound_bytes, bound_ops),
                   bound_by="bytes" if bound_bytes >= bound_ops
                   else "operations", library_ms=lib_ms,
                   max_abs_err=abs_err, path=ran)
        flash[f"flash_attention ({label})"] = rec
        print(f"[19a flash] {label}: q ({b}, {h}, {sq}, {d}), k/v ({b}, "
              f"{hkv}, {sk}, {d}), causal={causal}, bf16, ran {ran}: "
              f"max_abs={abs_err:.3e} row_rel={rel:.3e} (limit "
              f"{LM_BF16_TOL:.2e}) kernel={ms:.4f} ms plain={plain_ms:.4f} "
              f"ms bound={rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
              f"{moved / 1e6:.1f} MB, {4.0 * d * pairs / 1e9:.3f} Gop) "
              f"share={rec['bound_ms'] / ms:.3f} sdpa={lib_ms:.4f} ms",
              flush=True)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    sub_time("19a", t0)

    def f32_cut(tag, cfg, n_enc, inputs):
        """``n_enc`` + ``P19_CUT_LAYERS`` layers at full width in f32: the
        forward with the flash kernel against the plain attention on
        ``inputs`` (a batch dict of the cut's shape), and
        ``P19_CUT_DECODE`` tokens decoded after a prefill against the
        forward over the same tokens (and frames)."""
        t0 = time.perf_counter()
        cut_cfg = dataclasses.replace(cfg, n_layers=P19_CUT_LAYERS,
                                      encoder_layers=n_enc, dtype="float32")
        cut = T.Transformer(cut_cfg, device=dev, seed=0)
        nb, ns = P19_CUT_SHAPE
        toks = torch.randint(0, cut_cfg.vocab_size,
                             (nb, ns + P19_CUT_DECODE), device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(192))
        frames = {k: v for k, v in inputs.items() if k == "enc_embeds"}
        with torch.inference_mode():
            flash_out = cut(inputs)
            ran = last_path()
            plain = cut(inputs, impl="torch")
            full = cut({"tokens": toks, **frames})
            cache = cut.init_cache(nb, ns + P19_CUT_DECODE)
            pre, cache = cut.decode_step({"tokens": toks[:, :ns], **frames},
                                         cache, 0)
            dec = []
            for i in range(P19_CUT_DECODE):
                lg, cache = cut.decode_step(
                    {"tokens": toks[:, ns + i:ns + i + 1], **frames}, cache,
                    ns + i)
                dec.append(lg[:, 0])
        errs = {"flash vs plain": rel_err(flash_out, plain)[1],
                "prefill vs forward": rel_err(pre, full[:, :ns])[1],
                "decode vs forward": rel_err(torch.stack(dec, 1),
                                             full[:, ns:])[1]}
        print(f"[{tag} f32 cut] {n_enc} encoder + {P19_CUT_LAYERS} decoder "
              f"layers at full width, inputs "
              f"{ {k: tuple(v.shape) for k, v in inputs.items()} }, {nb} x "
              f"{ns} tokens + {P19_CUT_DECODE} decoded ({ran}): rel err "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tolerance {P19_CUT_TOL})", flush=True)
        if max(errs.values()) > P19_CUT_TOL:
            fail(f"phase {tag}: the f32 cut disagrees {errs}")
        del cut, toks, flash_out, plain, full, cache, pre, dec, lg
        torch.cuda.empty_cache()
        sub_time(f"{tag} f32 cut", t0)

    def replay(tag, lm, first, tokens, prompt_len, extra):
        """The served run's first greedy picks, again on a fresh cache."""
        cache = lm.init_cache(P19_BATCH, prompt_len + P19_REPLAY + 1)
        logits, cache = lm.decode_step(first, cache, 0)
        picks = [logits[:, -1].argmax(-1)]
        for i in range(P19_REPLAY):
            logits, cache = lm.decode_step(
                {"tokens": tokens[:, i:i + 1], **extra}, cache,
                prompt_len + i)
            picks.append(logits[:, 0].argmax(-1))
        picks = torch.stack(picks, dim=1).to(tokens.dtype)
        if not torch.equal(picks, tokens[:, :P19_REPLAY + 1]):
            fail(f"phase {tag}: replayed greedy picks {picks.tolist()} are "
                 f"not the served tokens "
                 f"{tokens[:, :P19_REPLAY + 1].tolist()}")
        print(f"[{tag}] {P19_REPLAY} replayed decode steps: greedy picks = "
              f"served tokens")

    # ---- 19b. whisper-medium served at full width and depth ----
    t0 = time.perf_counter()
    cfg = get_config(P19_WHISPER, reduced=P19_REDUCED)
    lm, prompts = serve.build(cfg, batch=P19_BATCH, prompt_len=P19_PROMPT,
                              seed=0, device=dev)
    frames = randn(P19_BATCH, cfg.encoder_seq, cfg.d_model, seed=193)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm.parameters())
    print(f"[19b] {cfg.name}: {n_params / 1e9:.3f} B parameters, "
          f"{cfg.encoder_layers} encoder + {cfg.n_layers} decoder layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; seeded "
          f"unit-normal frames {tuple(frames.shape)}; built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    first = {"tokens": prompts, "enc_embeds": frames}
    total = P19_PROMPT + P19_DECODE + 1
    with held_attention(L) as attn, cross_norms(L) as norms:
        got, _ = lm.decode_step(first, lm.init_cache(P19_BATCH, total), 0)
    ran = last_path()
    want, _ = lm.decode_step(first, lm.init_cache(P19_BATCH, total), 0,
                             impl="torch")
    n_flash = cfg.encoder_layers + 2 * cfg.n_layers
    worst = max(err for _, _, err in attn)
    print(f"[19b] prefill logits {tuple(got.shape)} vs impl=torch: rel "
          f"{rel_err(got, want)[1]:.3e} (printed); the flash kernel ({ran}) "
          f"on each of its {len(attn)} calls' own q, k, v "
          f"{sorted({shape for shape, _, _ in attn})} against its plain "
          f"version: worst row rel err {worst:.2e} (limit "
          f"{LM_BF16_TOL:.2e}); cross-attention output norms by layer "
          f"{', '.join(f'{x:.1f}' for x in norms)}", flush=True)
    if len(attn) != n_flash or worst > LM_BF16_TOL:
        fail(f"phase 19b: the flash kernel on the prefill's own inputs "
             f"({len(attn)} calls for {n_flash}) disagrees with its plain "
             f"version ({worst:.3e})")
    if len(norms) != cfg.n_layers or min(norms) <= 0.0:
        fail(f"phase 19b: cross-attention output norms {norms}")
    del got, want, attn
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tokens, timing = serve.generate(lm, prompts, P19_DECODE + 1,
                                    enc_embeds=frames)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    launches[f"{cfg.name} serve"] = counts
    dec_ms = [t * 1e3 for t in timing.decode_s]
    p50 = float(np.median(dec_ms))
    want_flash = n_flash + P19_DECODE * (cfg.encoder_layers + cfg.n_layers)
    print(f"[19b] prefill {P19_BATCH} x {P19_PROMPT} tokens over "
          f"{cfg.encoder_seq} frames in {timing.prefill_s * 1e3:.2f} ms; "
          f"{len(dec_ms)} decode steps (each runs the encoder again) p50 "
          f"{p50:.3f} ms max {max(dec_ms):.3f} ms "
          f"({P19_BATCH / (p50 / 1e3):.1f} tokens/s at p50); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; host clock "
          f"around each step + synchronize; launches in the serve run "
          f"{counts} (expected {want_flash} flash: {n_flash} a prefill, "
          f"{cfg.encoder_layers + cfg.n_layers} a decode step); sample "
          f"{tokens[0, :8].tolist()}", flush=True)
    if tuple(tokens.shape) != (P19_BATCH, P19_DECODE + 1) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        fail(f"phase 19b: tokens {tuple(tokens.shape)} out of range")
    if counts["flash_attention"] != want_flash or \
            sum(counts.values()) != want_flash:
        fail(f"phase 19b: launches {counts}, expected {want_flash} flash "
             f"launches and nothing else")
    # a decode step split: the encoder alone (its 24 layers over the
    # frames) and the rest of the step
    with torch.inference_mode():
        enc_ms = time_ms(lambda: lm._encoder(frames, "cuda", False),
                         iters=5)
    print(f"[19b] decode step p50 {p50:.3f} ms = the encoder {enc_ms:.3f} "
          f"ms (CUDA events, 5 calls after 3; "
          f"{enc_ms / p50:.3f} of the step) + the decoder and the rest "
          f"{p50 - enc_ms:.3f} ms", flush=True)
    replay("19b", lm, first, tokens, P19_PROMPT, {"enc_embeds": frames})
    serve_step = steps.make_serve_step(lm)
    cache = lm.init_cache(P19_BATCH, total)
    serve_step(first, cache, 0)
    step_in = {"tokens": tokens[:, :1], "enc_embeds": frames}
    busy, wall, calls, by_kernel = trace(
        "19b", f"{cfg.name} decode step",
        lambda: serve_step(step_in, cache, P19_PROMPT), top=10)
    flash_us = sum(us for kn, us in by_kernel.items()
                   if "flash_attention" in kn)
    print(f"[19b trace] {cfg.name} decode step: "
          f"{sum(calls.get(kn, 0) for kn in by_kernel)} device kernels; the "
          f"flash kernel {flash_us / 1e3:.3f} ms "
          f"({flash_us / max(busy, 1e-9):.3f}) of {busy / 1e3:.3f} ms busy")
    del lm, prompts, tokens, serve_step, cache, first, step_in
    torch.cuda.empty_cache()
    sub_time("19b", t0)
    nb, ns = P19_CUT_SHAPE
    f32_cut("19b", cfg, P19_CUT_LAYERS, {
        "tokens": torch.randint(0, cfg.vocab_size, (nb, ns), device=dev),
        "enc_embeds": randn(nb, cfg.encoder_seq, cfg.d_model, seed=194)})

    # ---- 19c. whisper-medium trained at full width and depth ----
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    lm = T.Transformer(cfg, device=dev, seed=0)
    gen_tok = torch.Generator(device=dev).manual_seed(195)
    batch = {kk: torch.randint(0, cfg.vocab_size,
                               (P19_BATCH, P19_TRAIN_SEQ), device=dev,
                               generator=gen_tok)
             for kk in ("tokens", "labels")}
    batch["enc_embeds"] = frames
    losses, lat, per_step, peak = train_steps(
        "19c train", lm, batch, P19_TRAIN_OPT, P19_TRAIN_STEPS)
    launches[f"{cfg.name} train step"] = per_step
    p50 = float(np.median(lat[1:]))
    print(f"[19c train] {cfg.name} {P19_TRAIN_STEPS} steps of {P19_BATCH} "
          f"x {P19_TRAIN_SEQ} tokens over {cfg.encoder_seq} seeded frames, "
          f"remat {cfg.remat!r}: step p50 {p50:.1f} ms, max "
          f"{max(lat[1:]):.1f} ms over steps 2-{P19_TRAIN_STEPS} (step 1 "
          f"{lat[0]:.1f} ms); peak device memory {peak / 2**30:.2f} GiB, of "
          f"it {held / 2**30:.2f} GiB held before (reckoned "
          f"~{P19_RECKONED_GB[P19_WHISPER]} GB); kernel launches a step "
          f"{per_step}")
    del lm, batch, frames
    torch.cuda.empty_cache()
    sub_time("19c", t0)

    # ---- 19d. qwen2-vl-72b served at full width, a depth cut ----
    t0 = time.perf_counter()
    vcfg = get_config(P19_VL, reduced=P19_REDUCED)
    if not P19_REDUCED:
        vcfg = dataclasses.replace(vcfg, n_layers=P19_VL_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    lm = T.Transformer(vcfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in lm.parameters())
    per_layer = sum(t.numel() for t in lm.blocks[0].parameters())
    full_params = n_params + (80 - vcfg.n_layers) * per_layer
    embeds = randn(P19_BATCH, P19_VL_PROMPT, vcfg.d_model, seed=196)
    print(f"[19d] {P19_VL} at full width, {vcfg.n_layers} of 80 layers: "
          f"{n_params / 1e9:.3f} B parameters ({per_layer / 1e9:.3f} B a "
          f"layer; all 80 would be {full_params / 1e9:.1f} B, "
          f"{full_params * 2 / 1e9:.0f} GB in bf16: more than the card's "
          f"80 GB), d {vcfg.d_model}, {vcfg.n_heads} / {vcfg.n_kv_heads} "
          f"heads of {vcfg.head_dim}, d_ff {vcfg.d_ff}, vocab "
          f"{vcfg.vocab_size}; seeded embeddings {tuple(embeds.shape)}; "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    total = P19_VL_PROMPT + P19_DECODE + 1
    first = {"embeds": embeds}
    with held_attention(L) as attn:
        got, _ = lm.decode_step(first, lm.init_cache(P19_BATCH, total), 0)
    ran = last_path()
    want, _ = lm.decode_step(first, lm.init_cache(P19_BATCH, total), 0,
                             impl="torch")
    worst = max(err for _, _, err in attn)
    print(f"[19d] prefill logits {tuple(got.shape)} on embeddings vs "
          f"impl=torch: rel {rel_err(got, want)[1]:.3e} (printed); the flash "
          f"kernel ({ran}) on each of the {len(attn)} layers' own q, k, v: "
          f"row rel err by layer {', '.join(f'{e:.1e}' for _, _, e in attn)}"
          f" (limit {LM_BF16_TOL:.2e})", flush=True)
    if len(attn) != vcfg.n_layers or worst > LM_BF16_TOL:
        fail(f"phase 19d: the flash kernel on the prefill's own inputs "
             f"({len(attn)} calls for {vcfg.n_layers} layers) disagrees with "
             f"its plain version ({worst:.3e})")
    del got, want, attn
    torch.cuda.empty_cache()
    serve_step = steps.make_serve_step(lm)
    ops.reset_launch_counts()
    cache = lm.init_cache(P19_BATCH, total)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    nxt, cache = serve_step(first, cache, 0)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    out, dec_ms = [nxt], []
    for i in range(P19_DECODE):
        t1 = time.perf_counter()
        nxt, cache = serve_step(nxt[:, None], cache, P19_VL_PROMPT + i)
        torch.cuda.synchronize()
        dec_ms.append((time.perf_counter() - t1) * 1e3)
        out.append(nxt)
    tokens = torch.stack(out, dim=1)
    counts = ops.launch_counts()
    launches[f"{P19_VL} serve, {vcfg.n_layers} layers"] = counts
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(dec_ms))
    print(f"[19d] prefill {P19_BATCH} x {P19_VL_PROMPT} embeddings in "
          f"{prefill_ms:.2f} ms "
          f"({P19_BATCH * P19_VL_PROMPT / (prefill_ms / 1e3):.0f} tokens/s); "
          f"{P19_DECODE} decode steps on tokens p50 {p50:.3f} ms max "
          f"{max(dec_ms):.3f} ms; peak device memory {peak / 2**30:.2f} GiB "
          f"(limit {P19_PEAK_GIB}); launches {counts}; sample "
          f"{tokens[0, :8].tolist()}", flush=True)
    if counts["flash_attention"] != vcfg.n_layers or \
            sum(counts.values()) != vcfg.n_layers:
        fail(f"phase 19d: launches {counts}, expected {vcfg.n_layers} flash "
             f"launches and nothing else")
    if peak > P19_PEAK_GIB * 2**30:
        fail(f"phase 19d: peak memory {peak / 2**30:.2f} GiB > "
             f"{P19_PEAK_GIB}")
    replay("19d", lm, first, tokens, P19_VL_PROMPT, {})
    del lm, serve_step, cache, first, tokens, nxt, out
    torch.cuda.empty_cache()
    sub_time("19d", t0)
    f32_cut("19d", vcfg, 0, {"embeds": embeds[:P19_CUT_SHAPE[0],
                                              :P19_CUT_SHAPE[1]]})
    del embeds

    # ---- 19e. a 2-layer cut of qwen2-vl-72b trained on embeddings ----
    t0 = time.perf_counter()
    tcfg = dataclasses.replace(vcfg, n_layers=P19_VL_TRAIN_LAYERS)
    held = torch.cuda.memory_allocated()
    lm = T.Transformer(tcfg, device=dev, seed=0)
    nb, ns = P19_VL_TRAIN_SHAPE
    raw = SyntheticStream(DataConfig(
        vocab_size=tcfg.vocab_size, seq_len=ns, global_batch=nb, seed=0,
        kind="embeds", d_model=tcfg.d_model)).batch_at(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    losses, lat, per_step, peak = train_steps(
        "19e train", lm, batch, P19_TRAIN_OPT, P19_TRAIN_STEPS)
    launches[f"{P19_VL} train step, {tcfg.n_layers} layers"] = per_step
    p50 = float(np.median(lat[1:]))
    print(f"[19e train] {P19_VL}, {tcfg.n_layers} layers at full width, "
          f"{P19_TRAIN_STEPS} steps on the 'embeds' data kind, {nb} x {ns}, "
          f"remat {tcfg.remat!r}: step p50 {p50:.1f} ms, max "
          f"{max(lat[1:]):.1f} ms over steps 2-{P19_TRAIN_STEPS} (step 1 "
          f"{lat[0]:.1f} ms); peak device memory {peak / 2**30:.2f} GiB, of "
          f"it {held / 2**30:.2f} GiB held before (reckoned "
          f"~{P19_RECKONED_GB[P19_VL]} GB); kernel launches a step "
          f"{per_step}")
    del lm, batch, raw
    torch.cuda.empty_cache()
    sub_time("19e", t0)
    print(f"[19] phase 19 took {time.perf_counter() - t19:.1f} s; launches "
          f"by path {launches}", flush=True)
    return {"launches": launches, "flash": flash}


# ---------------------------------------------------------------- phase 20 --
@contextlib.contextmanager
def replay_picks(layers, picks):
    """While active, the i-th call of ``layers._route`` picks the experts
    ``picks[i]`` (a token's k experts, ascending), its gates recomputed
    from the call's own router logits on them: a run held to another on
    that run's routing, whatever its batch split."""
    import torch
    pending = iter(picks)
    route = layers._route

    def forced(cfg, x, router):
        experts = next(pending)
        g = torch.softmax(x.float() @ router, -1).gather(-1, experts)
        return g / g.sum(-1, keepdim=True).clamp_min(1e-9), experts
    layers._route = forced
    try:
        yield
    finally:
        layers._route = route


def mesh_picks(calls, n_data, n_model):
    """The routing of a mesh run as one call a layer: ``record_routes``'
    calls come ``n_data * n_model`` a layer, members in (data, model)
    order; each data shard's experts (model member 0's) concatenated over
    the batch."""
    import torch
    per = n_data * n_model
    return [torch.cat([calls[i + j * n_model][0].experts
                       for j in range(n_data)])
            for i in range(0, len(calls), per)]


def phase_20(dev) -> dict:
    """The LM's distribution on meshes of the one card: granite-moe-3b at
    full width and depth served on (2, 2) (20a), qwen2.5-3b at full width
    on (1, 4) (20b), and stablelm-1.6b trained under ZeRO-1 on (2, 2)
    (20c).  Returns the launches by path."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.partitioning import make_rules
    from repro_torch.models import layers as L
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptConfig, adamw
    t20 = time.perf_counter()
    entry = (f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
             else "cpu")
    launches = {}

    def sub_time(label, t0):
        print(f"[20] {label} took {time.perf_counter() - t0:.1f} s",
              flush=True)

    def mesh(shape):
        return sharding.Mesh(np.full(shape, entry, dtype=object),
                             ("data", "model"))

    def sync():
        torch.cuda.synchronize()

    def serve_run(lm, prompts, rules, n_decode, feed=None):
        """A prefill and ``n_decode`` greedy decode steps (fed ``feed``'s
        tokens where given): the logits of each, the tokens fed, and the
        host times (ms, each ending in a synchronize)."""
        b, p = prompts.shape
        cache = lm.init_cache(b, p + n_decode, rules=rules)
        step = steps.make_serve_step(lm, rules=rules)
        run = step.executor.decode_step if rules is not None else \
            lm.decode_step
        outs, fed, times = [], [], []
        sync()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, cache = run(prompts, cache, 0)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            outs.append(logits[:, -1:])
            for i in range(n_decode):
                tok = (logits[:, -1].argmax(-1, keepdim=True) if feed is None
                       else feed[:, i:i + 1])
                fed.append(tok)
                t0 = time.perf_counter()
                logits, cache = run(tok, cache, p + i)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
                outs.append(logits)
        return outs, torch.cat(fed, 1), times, cache

    # ---- 20a. granite-moe-3b on (2, 2) ----
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(P20_MOE, reduced=P20_REDUCED),
                                  dtype=dtype)
        lm = T.Transformer(cfg, device=dev, seed=0)
        rules = make_rules(cfg, mesh((2, 2)))
        prompts = torch.randint(0, cfg.vocab_size, (P20_BATCH, P20_PROMPT),
                                device=dev, generator=torch.Generator(
                                    device=dev).manual_seed(20))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sharding.reset_comm_bytes()
        ops.reset_launch_counts()
        with record_routes(L) as calls, held_attention(L) as attn:
            got, fed, mesh_ms, _ = serve_run(lm, prompts, rules, P20_DECODE)
        counts = ops.launch_counts()
        comm = dict(sharding.comm_bytes)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches[f"granite (2, 2) serve, {dtype}"] = counts
        tol = LM_BF16_TOL if dtype == "bfloat16" else TOL["float32"]
        worst = max(err for _, _, err in attn)
        shapes = sorted({shape for shape, _, _ in attn})
        members = 4
        print(f"[20a] {cfg.name} {dtype} on a (2, 2) mesh of {entry}: "
              f"prefill {P20_BATCH} x {P20_PROMPT}, {P20_DECODE} decode "
              f"steps; the flash kernel on each member's q, k, v {shapes} "
              f"in {len(attn)} calls against its plain version: row rel "
              f"err up to {worst:.2e} (limit {tol:.2e}); launches {counts};"
              f" collective bytes {comm}; peak memory {peak:.2f} GiB",
              flush=True)
        want_flash = cfg.n_layers * members
        if len(attn) != want_flash or counts["flash_attention"] != \
                want_flash or worst > tol:
            fail(f"phase 20a {dtype}: {counts['flash_attention']} flash "
                 f"launches and {len(attn)} held calls for "
                 f"{want_flash}, worst {worst:.3e}")
        heads = (P20_BATCH // 2, cfg.n_heads // 2, P20_PROMPT,
                 cfg.head_dim)
        if any(shape != heads for shape in shapes):
            fail(f"phase 20a: q shapes {shapes}, expected {heads}")
        picks = mesh_picks(calls, 2, 2)
        if dtype == "float32":
            with replay_picks(L, picks):
                want, _, one_ms, _ = serve_run(lm, prompts, None,
                                               P20_DECODE, feed=fed)
            errs = [rel_err(g, w)[1] for g, w in zip(got, want)]
            print(f"[20a] f32 logits (last prompt position, then each "
                  f"decode step) against the unsharded model on the mesh "
                  f"run's routing: rel err "
                  f"{', '.join(f'{e:.1e}' for e in errs)} (limit "
                  f"{P20_TOL:.0e})", flush=True)
            if max(errs) > P20_TOL:
                fail(f"phase 20a: f32 mesh logits off by {max(errs):.3e}")
        else:
            with record_routes(L) as one_calls:
                want, _, one_ms, _ = serve_run(lm, prompts, None,
                                               P20_DECODE, feed=fed)
            n = cfg.n_layers
            shares = [float((a == b[0].experts).all(-1).float().mean())
                      for a, b in zip(picks[:n], one_calls[:n])]
            print(f"[20a] bf16 prefill: top-k sets agreeing between the "
                  f"(2, 2) mesh and the unsharded model by layer "
                  f"{', '.join(f'{v:.4f}' for v in shares)}", flush=True)
            errs = [rel_err(g, w, rows=True)[1] for g, w in zip(got, want)]
            same = [float((g[:, -1].argmax(-1) == w[:, -1].argmax(-1))
                          .float().mean()) for g, w in zip(got, want)]
            print(f"[20a] bf16 logits against the unsharded model (printed, "
                  f"not held: the routing differs): row rel err "
                  f"{', '.join(f'{e:.1e}' for e in errs)}; greedy picks "
                  f"agreeing {same}", flush=True)
        if dtype == "bfloat16":
            # timed without the checks' wrappers, in turns, the allocator
            # warm
            timed = {"mesh": [], "unsharded": []}
            for name in ("mesh", "unsharded", "mesh", "unsharded"):
                timed[name].append(serve_run(
                    lm, prompts, rules if name == "mesh" else None,
                    P20_DECODE, feed=fed)[2])
            for name, runs in timed.items():
                print(f"[20a] bf16 {name}: prefill "
                      f"{', '.join(f'{r[0]:.1f}' for r in runs)} ms, decode"
                      f" step p50 "
                      f"{', '.join(f'{np.median(r[1:]):.1f}' for r in runs)}"
                      f" ms (host clock + synchronize, two runs in turns)",
                      flush=True)
        del lm, got, want, calls, attn, picks
        torch.cuda.empty_cache()
        sub_time(f"20a {dtype}", t0)

    # ---- 20b. qwen2.5-3b on (1, 4): half a kv head a slice ----
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(P20_QWEN, reduced=P20_REDUCED),
                                  dtype=dtype)
        lm = T.Transformer(cfg, device=dev, seed=0)
        rules = make_rules(cfg, mesh((1, 4)))
        plan = T.MeshExecutor(lm, rules)
        print(f"[20b] {cfg.name} {dtype} on a (1, 4) mesh: {cfg.n_heads} q /"
              f" {cfg.n_kv_heads} kv heads of {cfg.head_dim}; wk / wv split "
              f"into {cfg.n_kv_heads * cfg.head_dim // 4} columns a member "
              f"(gathered before use: {plan.gather_kv}); each member's q "
              f"heads and the kv heads they read {plan.heads}", flush=True)
        del plan
        prompts = torch.randint(0, cfg.vocab_size, (P20_BATCH, P20_PROMPT),
                                device=dev, generator=torch.Generator(
                                    device=dev).manual_seed(21))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sharding.reset_comm_bytes()
        ops.reset_launch_counts()
        with held_attention(L) as attn:
            got, fed, mesh_ms, cache = serve_run(lm, prompts, rules,
                                                 P20_DECODE)
        counts = ops.launch_counts()
        comm = dict(sharding.comm_bytes)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches[f"qwen (1, 4) serve, {dtype}"] = counts
        replicas = all(torch.equal(part, next(iter(parts.values())))
                       for parts in cache.parts for part in parts.values())
        del cache
        want, _, one_ms, _ = serve_run(lm, prompts, None, P20_DECODE,
                                       feed=fed)
        # bf16: the members' products run at other shapes than the whole
        # model's (a q slice of 512 columns, f32 partials of wo and
        # w_down), so elements round the other way in each layer and 36
        # layers carry them.  The witness: an f32 run of the same bf16
        # weights, fed the same tokens, as the truth; the mesh run may lie
        # no farther from it than P20_WITNESS_RATIO times the unsharded
        # bf16 run does.  The flash kernel is held at 2^-6 on each
        # member's own q, k, v; f32 at P20_TOL
        bf16 = dtype == "bfloat16"
        tol = P20_BF16_TOL if bf16 else P20_TOL
        errs = [rel_err(g, w, rows=True)[1] for g, w in zip(got, want)]
        witness = None
        if bf16:
            truth_lm = T.Transformer(
                dataclasses.replace(cfg, dtype="float32"),
                device="meta").to_empty(device=dev)
            with torch.no_grad():
                for a, b_ in zip(truth_lm.parameters(), lm.parameters()):
                    a.copy_(b_.float())
            truth = serve_run(truth_lm, prompts, None, P20_DECODE,
                              feed=fed)[0]
            del truth_lm
            witness = ([rel_err(g, t, rows=True)[1]
                        for g, t in zip(got, truth)],
                       [rel_err(w, t, rows=True)[1]
                        for w, t in zip(want, truth)])
            del truth
            torch.cuda.empty_cache()
            print(f"[20b] bf16 witness, row rel err from an f32 run of the "
                  f"same weights (last prompt position, then each decode "
                  f"step): the (1, 4) mesh "
                  f"{', '.join(f'{e:.2e}' for e in witness[0])}; the "
                  f"unsharded model "
                  f"{', '.join(f'{e:.2e}' for e in witness[1])} (the mesh "
                  f"held to at most {P20_WITNESS_RATIO} x the unsharded "
                  f"model's largest)", flush=True)
        worst = max(err for _, _, err in attn)
        attn_tol = LM_BF16_TOL if bf16 else TOL["float32"]
        print(f"[20b] {dtype}: the flash kernel on each member's q, k, v "
              f"{sorted({shape for shape, _, _ in attn})} in {len(attn)} "
              f"calls: row rel err up to {worst:.2e} (limit "
              f"{attn_tol:.2e}); launches {counts}; the replicated KV cache"
              f" equal on every member: {replicas}; logits (last prompt "
              f"position, then each decode step) against the unsharded "
              f"model, row rel err {', '.join(f'{e:.1e}' for e in errs)} "
              f"(limit {tol:.2e}); collective bytes"
              f" {comm}; peak memory {peak:.2f} GiB; mesh prefill "
              f"{mesh_ms[0]:.1f} ms, decode p50 "
              f"{float(np.median(mesh_ms[1:])):.1f} ms; unsharded prefill "
              f"{one_ms[0]:.1f} ms, decode p50 "
              f"{float(np.median(one_ms[1:])):.1f} ms (the mesh run with "
              f"the held attention's plain calls)", flush=True)
        if counts["flash_attention"] != cfg.n_layers * 4 or \
                len(attn) != cfg.n_layers * 4 or worst > attn_tol:
            fail(f"phase 20b {dtype}: flash launches {counts}, {len(attn)} "
                 f"held, worst {worst:.3e}")
        if not replicas or max(errs) > tol or (witness is not None and max(
                witness[0]) > P20_WITNESS_RATIO * max(witness[1])):
            fail(f"phase 20b {dtype}: replicas equal {replicas}, logits "
                 f"{max(errs):.3e}, witness {witness}")
        del lm, got, want, attn
        torch.cuda.empty_cache()
        sub_time(f"20b {dtype}", t0)

    # ---- 20c. stablelm-1.6b trained under ZeRO-1 on (2, 2) ----
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(P20_TRAIN, reduced=P20_REDUCED),
                              dtype="float32")
    if not P20_REDUCED:
        cfg = dataclasses.replace(cfg, n_layers=P20_TRAIN_LAYERS)
    b, s = P20_TRAIN_SHAPE
    tok = torch.randint(0, cfg.vocab_size, (b, s + 1), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(22))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    opt = OptConfig(**P20_TRAIN_OPT)
    runs = {}
    before = None
    for name in ("unsharded", "(2, 2) mesh"):
        lm = T.Transformer(cfg, device=dev, seed=0)
        if before is None:
            before = [p.detach().clone() for p in lm.parameters()]
            names = [n for n, _ in lm.named_parameters()]
        rules = make_rules(cfg, mesh((2, 2))) if name != "unsharded" \
            else None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sharding.reset_comm_bytes()
        ops.reset_launch_counts()
        step = steps.make_train_step(lm, opt, rules=rules)
        state = adamw.init(lm.parameters())
        losses, norms, ms = [], [], []
        for _ in range(P20_TRAIN_STEPS):
            sync()
            t1 = time.perf_counter()
            state, m = step(state, batch)
            sync()
            ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        counts = ops.launch_counts()
        launches[f"stablelm train, {name}"] = counts
        # the mesh step writes its parameters back into the model
        runs[name] = dict(losses=losses, norms=norms, ms=ms,
                          params=[p.detach() for p in lm.parameters()],
                          peak=torch.cuda.max_memory_allocated() / 2**30,
                          comm=dict(sharding.comm_bytes), counts=counts)
        del step, state, lm
        print(f"[20c] {cfg.name} f32, {cfg.n_layers} layers, {b} x {s}, "
              f"{name}: losses {losses}, grad norms {norms}, step ms "
              f"{', '.join(f'{t:.1f}' for t in ms)} (host clock + "
              f"synchronize), peak memory {runs[name]['peak']:.2f} GiB, "
              f"collective bytes {runs[name]['comm']}, launches {counts}",
              flush=True)
    one, two = runs["unsharded"], runs["(2, 2) mesh"]
    loss_err = max(abs(a / b_ - 1) for a, b_ in
                   zip(one["losses"] + one["norms"],
                       two["losses"] + two["norms"]))
    # each leaf's change over the steps, not its value: 2 steps at lr 3e-4
    # move a weight by about 6e-4
    gaps = []
    for name, a, b_, p0 in zip(names, two["params"], one["params"],
                               before):
        want = (b_ - p0).double()
        gaps.append((float(((a - p0).double() - want).norm() /
                           want.norm().clamp_min(1e-30)), name))
    gaps.sort(reverse=True)
    print(f"[20c] ZeRO-1 on (2, 2) against the unsharded trainer: losses and"
          f" grad norms within {loss_err:.2e} relative (limit "
          f"{P20_LOSS_TOL:.0e}); each parameter's change over "
          f"{P20_TRAIN_STEPS} steps within a normwise relative gap of "
          f"{gaps[0][0]:.2e} (limit {P20_UPDATE_TOL:.0e}; the largest: "
          f"{', '.join(f'{n} {g:.2e}' for g, n in gaps[:4])})", flush=True)
    if loss_err > P20_LOSS_TOL or gaps[0][0] > P20_UPDATE_TOL or any(
            c for r in runs.values() for c in r["counts"].values()):
        fail(f"phase 20c: loss err {loss_err:.3e}, update gap "
             f"{gaps[0]}, launches {[r['counts'] for r in runs.values()]}")
    del runs, one, two, batch, tok, before
    torch.cuda.empty_cache()
    sub_time("20c", t0)

    print(f"[20] phase 20 took {time.perf_counter() - t20:.1f} s; launches "
          f"by path {launches}", flush=True)
    return launches


def phase_21(dev) -> dict:
    """The dry run against the card: qwen2.5-3b at full width and
    ``P21_LAYERS`` layers, bf16, a prefill and a training step on a 1 x 1
    mesh of the card, each first counted on a ``meta`` copy
    (``launch.dryrun._count``): the counted argument bytes must equal the
    step's inputs on the card, the counted peak's rise over them must lie
    within ``P21_PEAK_RATIO`` of the rise of ``max_memory_allocated`` over
    the step, and no measured step may beat its compute term.  Then the
    reference test's production cell through the CLI (``P21_CLI_MEMBERS``
    members) and the roofline report of its JSON.  Returns the launches
    by path."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, partitioning
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    from repro_torch.roofline import model_flops
    t21 = time.perf_counter()
    entry = (f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
             else "cpu")
    smi = nvidia_smi()
    cut = {"n_layers": P21_LAYERS}
    if P21_REDUCED:
        cut = dataclasses.asdict(dataclasses.replace(
            partitioning.get_config(P21_ARCH, reduced=True),
            n_layers=P21_LAYERS))
    launches = {}

    def mesh(device):
        return sharding.Mesh(np.full((1, 1), device, dtype=object),
                             ("data", "model"))

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    for kind in ("prefill", "train"):
        t0 = time.perf_counter()
        shape = ShapeConfig(f"p21_{kind}", P21_SEQ, P21_BATCH, kind)
        dry = dryrun._count(P21_ARCH, shape, mesh("meta"), cfg_replace=cut)
        mem = dry["members"][(0, 0)]
        flops, counted_bytes = dry["cost"]["flops"], \
            dry["cost"]["bytes accessed"]
        # the same step on the card
        pl_ = partitioning.plan(P21_ARCH, shape, mesh(entry),
                                cfg_replace=cut)
        cfg = pl_["cfg"]
        lm = T.Transformer(cfg, device=dev, seed=0)
        batch = dryrun._inputs(pl_["batch"], cfg, dev, seed=21)
        run, held = dryrun._step(pl_, lm, pl_["rules"], batch)
        args = nbytes(held[(0, 0)]) + nbytes(batch.values())
        print(f"[21] {cfg.name} {P21_LAYERS} layers bf16 {kind} "
              f"{P21_BATCH} x {P21_SEQ}: dry run (counted on meta in "
              f"{dry['compile_s']:.1f} s) {flops:.4e} FLOPs, "
              f"{counted_bytes:.4e} bytes accessed, arguments "
              f"{mem['argument_bytes']} B, peak {mem['peak_bytes']} B; the "
              f"card's arguments {args} B", flush=True)
        if args != mem["argument_bytes"]:
            fail(f"phase 21 {kind}: dry-run arguments "
                 f"{mem['argument_bytes']} B, the card's {args} B")
        out = run()                                   # warm-up
        del out
        for p in lm.parameters():
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        out = run()
        torch.cuda.synchronize()
        counts = launches[f"{cfg.name} {kind}"] = ops.launch_counts()
        rise = torch.cuda.max_memory_allocated() - base
        want = {k: 0 for k in counts}
        if kind == "prefill":
            want["flash_attention"] = P21_LAYERS
        if counts != want:
            fail(f"phase 21 {kind}: launches {counts}, expected {want}")
        del out
        dry_rise = mem["peak_bytes"] - mem["argument_bytes"]
        ratio = dry_rise / max(rise, 1)
        print(f"[21] {kind}: peak over the arguments, dry run {dry_rise} B,"
              f" card {rise} B (max_memory_allocated over the step): ratio "
              f"{ratio:.4f} (limits {P21_PEAK_RATIO}); peak with the "
              f"arguments, dry run {mem['peak_bytes']} B, card "
              f"{base + rise} B", flush=True)
        if not P21_PEAK_RATIO[0] <= ratio <= P21_PEAK_RATIO[1]:
            fail(f"phase 21 {kind}: dry-run peak rise {dry_rise} B against "
                 f"the card's {rise} B (ratio {ratio:.4f})")
        times = []
        for _ in range(P21_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            del out
        ms = float(np.median(times))
        compute_ms = flops / PEAK_FLOPS_BF16 * 1e3
        memory_ms = counted_bytes / HBM_BW * 1e3
        share = model_flops(cfg, shape) / (ms * 1e-3) / PEAK_FLOPS_BF16
        print(f"[21] {kind}: median step {ms:.4f} ms over {P21_RUNS} runs "
              f"(CUDA events; {', '.join(f'{t:.3f}' for t in times)}); "
              f"compute term {compute_ms:.4f} ms (counted FLOPs at 989 "
              f"TFLOP/s), memory term {memory_ms:.4f} ms (counted bytes at "
              f"3.35 TB/s), time over the memory term "
              f"{ms / memory_ms:.3f}; model FLOPs {model_flops(cfg, shape):.4e}"
              f" = {share:.4f} of the bf16 peak; card {smi}; launches "
              f"{launches[f'{cfg.name} {kind}']}", flush=True)
        if ms < compute_ms:
            fail(f"phase 21 {kind}: step {ms:.4f} ms beats its compute term "
                 f"{compute_ms:.4f} ms: the count is wrong")
        del lm, batch, run, held
        gc_collect()
        print(f"[21] {kind} took {time.perf_counter() - t0:.1f} s",
              flush=True)

    # the reference test's production cell through the CLI
    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun", *P21_CLI,
           "--out", str(out_dir)]
    res = subprocess.run(cli, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=P21_CLI_TIMEOUT_S)
    print(res.stdout[-3000:], flush=True)
    if res.returncode != 0:
        fail(f"phase 21: the dry-run CLI exited {res.returncode}: "
             f"{res.stderr[-3000:]}")
    tag = "_".join(P21_CLI[1:4:2])
    with open(out_dir / f"{tag}_{P21_CLI_MEMBERS}.json") as f:
        cell = json.load(f)
    if cell["n_devices"] != P21_CLI_MEMBERS or cell["memory_analysis"][
            "peak_bytes"] is None:
        fail(f"phase 21: the CLI cell reads n_devices {cell['n_devices']}, "
             f"peak {cell['memory_analysis']['peak_bytes']}")
    rep = subprocess.run([sys.executable, "-m", "repro_torch.roofline.report",
                          str(out_dir)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    print(rep.stdout, flush=True)
    if rep.returncode != 0:
        fail(f"phase 21: the report exited {rep.returncode}: "
             f"{rep.stderr[-2000:]}")
    rl = cell["roofline"]
    print(f"[21] the CLI cell {' '.join(P21_CLI)}: "
          f"{time.perf_counter() - t0:.1f} s in all (dry-run counts, no "
          f"card); the fullest of {P21_CLI_MEMBERS} members holds "
          f"{cell['memory_analysis']['argument_bytes']} B of arguments, "
          f"peak {cell['memory_analysis']['peak_bytes']} B; roofline per "
          f"member: compute {rl['compute_s']:.3e} s, memory "
          f"{rl['memory_s']:.3e} s, collective {rl['collective_s']:.3e} s, "
          f"bottleneck {rl['bottleneck']}", flush=True)
    print(f"[21] phase 21 took {time.perf_counter() - t21:.1f} s", flush=True)
    return launches


@contextlib.contextmanager
def held_band(api):
    """While active, each ``api.tile_fused_matmul`` call (the band mixer's
    GeMM-SpMM and ``spmm_ell`` on the card) also runs the plain fused
    executor (``backend="torch"``) on the same operands, and appends ``(the
    dense weight's shape, the relative error of the call's output against
    the plain one)`` to the yielded list: the kernels held on each member's
    own column slice."""
    calls = []
    fused = api.tile_fused_matmul

    def held(a, b, c, *, backend="auto", spec=None):
        out = fused(a, b, c, backend=backend, spec=spec)
        want = fused(a, b, c, backend="torch", spec=spec)
        calls.append((tuple(c.shape), rel_err(out, want)[1]))
        return out
    api.tile_fused_matmul = held
    try:
        yield calls
    finally:
        api.tile_fused_matmul = fused


@contextlib.contextmanager
def band_on_meta(api):
    """While active, ``api.tile_fused_matmul`` on ``meta`` tensors runs the
    plain fused executor (``backend="torch"``): the GeMM-SpMM's wrapper
    raises on ``meta``, and a dry run of the band mixer's collectives
    needs its shapes only."""
    fused = api.tile_fused_matmul

    def meta_plain(a, b, c, *, backend="auto", spec=None):
        if c.device.type == "meta":
            backend = "torch"
        return fused(a, b, c, backend=backend, spec=spec)
    api.tile_fused_matmul = meta_plain
    try:
        yield
    finally:
        api.tile_fused_matmul = fused


@contextlib.contextmanager
def launches_by_member(transformer, ops):
    """While active, the kernel launches made in each mesh member's turn
    (``MeshExecutor.on``), member -> {kernel: launches}."""
    per = {}
    on = transformer.MeshExecutor.on

    @contextlib.contextmanager
    def counted(self, who):
        with on(self, who):
            before = ops.launch_counts()
            try:
                yield
            finally:
                now = ops.launch_counts()
                mine = per.setdefault(who, dict.fromkeys(now, 0))
                for k in now:
                    mine[k] += now[k] - before[k]
    transformer.MeshExecutor.on = counted
    try:
        yield per
    finally:
        transformer.MeshExecutor.on = on


def phase_22(dev) -> dict:
    """The split blocks on meshes of the one card (``P22_CELLS``): MLA,
    the attention + mamba hybrid with its heads split and not, the xLSTM
    group, the encoder-decoder and the sparse-band block, at full width.
    For each: an f32 prefill and ``P22_DECODE`` greedy decode steps (the
    sparse-band block a forward) on the mesh against the unsharded model
    (``P20_TOL``); the flash kernel on each member's own q, k, v and the
    GeMM-SpMM on each member's column slice against their plain versions
    (f32 ``TOL``; a bf16 prefill holds flash at ``LM_BF16_TOL``); each
    member's launches against the unsharded run's; the collective bytes of
    an f32 prefill against the dry run's count of the same step on a
    ``meta`` mesh.  Then 2 ZeRO-1 steps of the sparse-band model on (2, 2)
    against the unsharded trainer, as phase 20c.  Returns the launches by
    path."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.tilefusion import api
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.partitioning import make_rules
    from repro_torch.models import layers as L
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptConfig, adamw
    t22 = time.perf_counter()
    smi = nvidia_smi()
    entry = (f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
             else "cpu")
    launches = {}

    def mesh(shape, device=entry):
        return sharding.Mesh(np.full(shape, device, dtype=object),
                             ("data", "model"))

    def serve(lm, batch, rules, feed=None):
        """The prefill and ``P22_DECODE`` greedy steps (fed ``feed``'s
        tokens where given) on the mesh of ``rules`` (None: unsharded):
        the logits of the last prompt position and of each step, the fed
        tokens, the host times (ms, each ending in a synchronize)."""
        b, p = batch["tokens"].shape
        cache = lm.init_cache(b, p + P22_DECODE, rules=rules)
        run = lm.decode_step if rules is None else \
            T.MeshExecutor(lm, rules).decode_step
        outs, fed, times = [], [], []
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        with torch.inference_mode():
            tok, at = batch["tokens"], 0
            for i in range(P22_DECODE + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = run({"tokens": tok, **extra}, cache, at)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                outs.append(logits[:, -1:])
                at += tok.shape[1]
                if i < P22_DECODE:
                    tok = (logits[:, -1].argmax(-1, keepdim=True)
                           if feed is None else feed[:, i:i + 1])
                    fed.append(tok)
        return outs, torch.cat(fed, 1) if fed else None, times

    def forward(lm, batch, rules):
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = lm(batch) if rules is None else \
                T.MeshExecutor(lm, rules).forward(batch)
            torch.cuda.synchronize()
        return [out], None, [(time.perf_counter() - t0) * 1e3]

    for arch, cut, shape in P22_CELLS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch, reduced=P22_REDUCED),
                                  **cut, dtype="float32")
        tag = f"{cfg.name}{' (band)' if 'block_pattern' in cut else ''} " \
            f"{shape}"
        lm = T.Transformer(cfg, device=dev, seed=0)
        rules = make_rules(cfg, mesh(shape))
        ex = T.MeshExecutor(lm, rules)
        rows = P22_BATCH // shape[0]
        prefix = "groups.0" if lm.xlstm else "blocks.0"
        forms = {"prefill": ex.split_form(prefix, rows, P22_PROMPT),
                 "decode step": ex.split_form(prefix, rows, 1)}
        if cfg.encoder_layers:
            forms["encoder"] = ex.split_form("enc_blocks.0", rows,
                                             cfg.encoder_seq)
        del ex
        gen = torch.Generator(device=dev).manual_seed(22)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (
            P22_BATCH, P22_PROMPT), device=dev, generator=gen)}
        if cfg.encoder_layers:
            batch["enc_embeds"] = torch.randn(
                P22_BATCH, cfg.encoder_seq, cfg.d_model, device=dev,
                generator=gen)
        print(f"[22] {tag}: {cfg.n_layers} layers f32, rules shard_heads "
              f"{rules.shard_heads}; split form (True) or gathered by the "
              f"rule for {P22_BATCH} x {P22_PROMPT}: {forms}", flush=True)
        if not (forms["prefill"] and forms["decode step"]):
            fail(f"phase 22 {tag}: the rule keeps the gathered form {forms}")
        run = forward if lm.sparse_band else serve
        ops.reset_launch_counts()
        want, fed, one_ms = run(lm, batch, None)
        one = ops.launch_counts()
        ops.reset_launch_counts()
        sharding.reset_comm_bytes()
        with held_attention(L) as attn, held_band(api) as band, \
                launches_by_member(T, ops) as per:
            got, _, mesh_ms = (run(lm, batch, rules) if lm.sparse_band
                               else serve(lm, batch, rules, feed=fed))
        counts = ops.launch_counts()
        launches[f"{tag} f32"] = counts
        errs = [rel_err(g, w)[1] for g, w in zip(got, want)]
        held = [e for _, _, e in attn] + [e for _, e in band]
        worst = max(held, default=0.0)
        # each member launches what the unsharded run launches: one flash
        # call per attention call whatever its rows, the band's kernels
        # once per batch row it holds
        expect = {k: (n * rows // P22_BATCH if k in GCN_KERNELS else n)
                  for k, n in one.items()}
        bad = {who: c for who, c in per.items() if c != expect}
        print(f"[22] {tag}: logits (last prompt position"
              f"{', then each decode step' if fed is not None else ''}) "
              f"against the unsharded model, rel err "
              f"{', '.join(f'{e:.1e}' for e in errs)} (limit "
              f"{P20_TOL:.0e}); flash on each member's q, k, v "
              f"{sorted({s for s, _, _ in attn})} in {len(attn)} calls and "
              f"the GeMM-SpMM on each member's column slice "
              f"{sorted({s for s, _ in band})} in {len(band)} calls against "
              f"their plain versions: rel err up to {worst:.2e} (limit "
              f"{TOL['float32']:.0e}); launches by member {per} (the "
              f"unsharded run's {one}); collective bytes "
              f"{dict(sharding.comm_bytes)}; mesh "
              f"{', '.join(f'{t:.1f}' for t in mesh_ms)} ms, unsharded "
              f"{', '.join(f'{t:.1f}' for t in one_ms)} ms (host clock + "
              f"synchronize, prefill then each step; the mesh run with its "
              f"held calls); card {smi}", flush=True)
        if max(errs) > P20_TOL or worst > TOL["float32"] or bad or \
                len(per) != len(sharding.Members(rules).all()) or \
                not any(expect.values()) and not lm.xlstm:
            fail(f"phase 22 {tag}: logits {max(errs):.3e}, held kernels "
                 f"{worst:.3e}, launches by member {per} for {expect}")
        # the collective bytes of one f32 prefill: the card's against the
        # dry run's count of the same step on a meta mesh
        step = steps.make_prefill_step(lm, rules=rules, gather=False)
        sharding.reset_comm_bytes()
        step(batch)
        torch.cuda.synchronize()
        card = dict(sharding.comm_bytes)
        del step
        with band_on_meta(api):
            dryrun._count(arch, ShapeConfig("p22", P22_PROMPT, P22_BATCH,
                                            "prefill"), mesh(shape, "meta"),
                          cfg_replace=dataclasses.asdict(cfg))
        meta = dict(sharding.comm_bytes)
        print(f"[22] {tag}: collective bytes of an f32 prefill, card {card},"
              f" dry run on a meta mesh {meta}", flush=True)
        if card != meta:
            fail(f"phase 22 {tag}: collective bytes {card} on the card, "
                 f"{meta} counted")
        del lm, got, want, attn, band
        gc_collect()
        if one["flash_attention"]:
            # bf16: a prefill on the mesh, flash held row by row
            cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
            lm = T.Transformer(cfg16, device=dev, seed=0)
            rules = make_rules(cfg16, mesh(shape))
            b16 = {"tokens": batch["tokens"][:, :P22_PROMPT],
                   **{k: v for k, v in batch.items() if k != "tokens"}}
            ops.reset_launch_counts()
            with held_attention(L) as attn, torch.inference_mode():
                cache = lm.init_cache(P22_BATCH, P22_PROMPT, rules=rules)
                T.MeshExecutor(lm, rules).decode_step(b16, cache, 0)
                torch.cuda.synchronize()
            counts = launches[f"{tag} bf16 prefill"] = ops.launch_counts()
            worst = max(e for _, _, e in attn)
            print(f"[22] {tag}: bf16 prefill on the mesh, flash on each "
                  f"member's q, k, v in {len(attn)} calls: row rel err up "
                  f"to {worst:.2e} (limit {LM_BF16_TOL:.2e}); launches "
                  f"{counts}", flush=True)
            if worst > LM_BF16_TOL or counts["flash_attention"] != len(attn):
                fail(f"phase 22 {tag} bf16: flash {worst:.3e}, {counts}")
            del lm, cache, attn
            gc_collect()
        print(f"[22] {tag} took {time.perf_counter() - t0:.1f} s",
              flush=True)

    # the sparse-band model trained under ZeRO-1, as phase 20c
    t0 = time.perf_counter()
    arch, cut, _ = P22_CELLS[-1]
    cfg = dataclasses.replace(get_config(arch, reduced=P22_REDUCED), **cut,
                              dtype="float32")
    b, s = P22_TRAIN_SHAPE
    tok = torch.randint(0, cfg.vocab_size, (b, s + 1), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(23))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    opt = OptConfig(**P20_TRAIN_OPT)
    runs, before = {}, None
    for name in ("unsharded", f"{P22_TRAIN_MESH} mesh"):
        lm = T.Transformer(cfg, device=dev, seed=0)
        if before is None:
            before = [p.detach().clone() for p in lm.parameters()]
            names = [n for n, _ in lm.named_parameters()]
        rules = None if name == "unsharded" else \
            make_rules(cfg, mesh(P22_TRAIN_MESH))
        ops.reset_launch_counts()
        step = steps.make_train_step(lm, opt, rules=rules)
        state = adamw.init(lm.parameters())
        losses, norms, ms = [], [], []
        for _ in range(P22_TRAIN_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        counts = launches[f"{cfg.name} (band) train, {name}"] = \
            ops.launch_counts()
        runs[name] = dict(losses=losses, norms=norms,
                          params=[p.detach() for p in lm.parameters()])
        print(f"[22] {cfg.name} (band) f32 {cfg.n_layers} layers, {b} x "
              f"{s}, {name}: losses {losses}, grad norms {norms}, step ms "
              f"{', '.join(f'{t:.1f}' for t in ms)} (host clock + "
              f"synchronize), launches {counts}; card {smi}", flush=True)
        del step, state, lm
    one, two = runs.values()
    loss_err = max(abs(x / y - 1) for x, y in zip(
        one["losses"] + one["norms"], two["losses"] + two["norms"]))
    gaps = sorted(((float(((a - p0).double() - (w - p0).double()).norm() /
                          (w - p0).double().norm().clamp_min(1e-30)), n)
                   for n, a, w, p0 in zip(names, two["params"],
                                          one["params"], before)),
                  reverse=True)
    print(f"[22] ZeRO-1 of the split band blocks on {P22_TRAIN_MESH} against "
          f"the unsharded trainer: losses and grad norms within "
          f"{loss_err:.2e} relative (limit {P20_LOSS_TOL:.0e}); each "
          f"parameter's change within a normwise gap of {gaps[0][0]:.2e} "
          f"(limit {P20_UPDATE_TOL:.0e}; the largest: "
          f"{', '.join(f'{n} {g:.2e}' for g, n in gaps[:3])})", flush=True)
    mesh_counts = launches[f"{cfg.name} (band) train, {P22_TRAIN_MESH} mesh"]
    if loss_err > P20_LOSS_TOL or gaps[0][0] > P20_UPDATE_TOL or \
            not mesh_counts["tile_fused_gemm_spmm_wf0"]:
        fail(f"phase 22 train: loss err {loss_err:.3e}, gap {gaps[0]}, "
             f"launches {mesh_counts}")
    del runs, one, two, batch, tok, before
    gc_collect()
    print(f"[22] training took {time.perf_counter() - t0:.1f} s; phase 22 "
          f"took {time.perf_counter() - t22:.1f} s; launches by path "
          f"{launches}", flush=True)
    return launches


def phase_23(dev) -> dict:
    """The paper's overlapped and atomic tiling baselines (Figure 6) on
    the card: ``fused_ops.overlapped_gemm_spmm`` and ``atomic_gemm_spmm``
    at ``P23_P`` partitions (``P23_WAVES`` waves) on phase 4's banded and
    power-law graphs, f32, ``b_col = c_col = P23_COLS``.  Each is held to
    the same schedule on ``spmm_ell``'s plain version (f32 ``TOL``) and
    to ``tile_fused_matmul`` (``backend="auto"``, ``MAIN_TOL``), and must
    launch ``spmm_ell`` once a partition or tile and nothing else.
    Printed, not held: wall and CUDA-event times (medians of
    ``P23_TIMED`` calls), the host packing time and the baselines' device
    work with their partitions packed ahead (``fused_ops.run_*``), fig
    6's ``vs_atomic`` / ``vs_overlapped`` (a baseline's wall over the
    fused call's) both ways, ``overlapped_redundancy``,
    ``fused_compute_ratio`` and the block pattern's nonzeros.  Returns
    the launches by path."""
    import numpy as np
    import torch

    from repro_torch.core.sparse import block_csr_pattern
    from repro_torch.core.sparse.random import banded_spd, powerlaw_graph
    from repro_torch.core.tilefusion import (api, fused_compute_ratio,
                                             fused_ops)
    from repro_torch.kernels import ops
    t23 = time.perf_counter()
    smi = nvidia_smi()
    launches = {}
    baselines = {"overlapped": (fused_ops.overlapped_tiles,
                                fused_ops.overlapped_gemm_spmm,
                                fused_ops.pack_overlapped,
                                fused_ops.run_overlapped),
                 "atomic": (functools.partial(fused_ops.atomic_tiles,
                                              n_waves=P23_WAVES),
                            fused_ops.atomic_gemm_spmm,
                            fused_ops.pack_atomic, fused_ops.run_atomic)}

    def timed(fn):
        """(wall ms, event ms): medians of ``P23_TIMED`` calls, each
        ending in a synchronize; the events include the host's gaps."""
        walls, events = [], []
        for _ in range(P23_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            events.append(start.elapsed_time(end))
        return float(np.median(walls)), float(np.median(events))

    rng = np.random.default_rng(230)
    for name, make in (("banded", banded_spd), ("power-law", powerlaw_graph)):
        t0 = time.perf_counter()
        a = make(P23_NODES, 8, seed=0)
        b = torch.from_numpy(rng.standard_normal(
            (P23_NODES, P23_COLS), np.float32)).to(dev)
        c = torch.from_numpy(rng.standard_normal(
            (P23_COLS, P23_COLS), np.float32)).to(dev)
        t_graph = time.perf_counter() - t0
        t0 = time.perf_counter()
        fused = api.tile_fused_matmul(a, b, c)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        pick = api.select_backend(
            api.get_schedule(a, b_col=P23_COLS, c_col=P23_COLS), dev)
        times = {"fused": timed(lambda: api.tile_fused_matmul(a, b, c))}
        print(f"[23] {name}: graph and operands {t_graph:.2f} s, first "
              f"tile_fused_matmul (inspection) {t_first:.2f} s", flush=True)
        ahead = {}
        for base, (tiles, run, pack, run_packed) in baselines.items():
            t0 = time.perf_counter()
            sched = tiles(a, P23_P)
            t_sched = (time.perf_counter() - t0) * 1e3
            # a partition with no deps, or a tile with no rows: no call
            want = (sum(1 for deps, _ in sched if deps.size)
                    if base == "overlapped" else
                    sum(1 for wave in sched for jr in wave if jr.size))
            ops.reset_launch_counts()
            got = run(a, sched, b, c)
            torch.cuda.synchronize()
            counts = launches[f"{name} {base}"] = ops.launch_counts()
            plain = run(a, sched, b, c, kernel=False)
            err_plain = rel_err(got, plain)
            err_fused = rel_err(got, fused)
            others = {k: n for k, n in counts.items()
                      if k != "spmm_ell" and n}
            pack_ms, _ = timed(lambda: pack(a, sched, dev, c.dtype))
            times[base] = timed(lambda: run(a, sched, b, c))
            # the device work alone, the partitions packed ahead
            packs = pack(a, sched, dev, c.dtype)
            ahead[base] = timed(lambda: run_packed(packs, a.n_rows, b, c))
            del packs
            print(f"[23] {name} {base}: spmm_ell launches "
                  f"{counts['spmm_ell']} (expected {want}, "
                  f"{P23_LAUNCHES[base]} partitions / tiles); vs its plain "
                  f"version max abs {err_plain[0]:.3e} rel "
                  f"{err_plain[1]:.3e} (limit {TOL['float32']:.0e}); vs "
                  f"tile_fused_matmul ({pick}) rel {err_fused[1]:.3e} "
                  f"(limit {MAIN_TOL:.0e}); wall {times[base][0]:.3f} ms, "
                  f"CUDA events {times[base][1]:.3f} ms (medians of "
                  f"{P23_TIMED}); schedule {t_sched:.3f} ms, host packing "
                  f"and upload {pack_ms:.3f} ms, packed ahead: wall "
                  f"{ahead[base][0]:.3f} ms, CUDA events "
                  f"{ahead[base][1]:.3f} ms; card {smi}", flush=True)
            if (counts["spmm_ell"] != want or want != P23_LAUNCHES[base]
                    or others or err_plain[1] > TOL["float32"]
                    or err_fused[1] > MAIN_TOL):
                fail(f"phase 23 {name} {base}: launches {counts} (expected "
                     f"{want}), errors {err_plain}, {err_fused}")
            del got, plain
        wall, event = times["fused"]
        print(f"[23] {name} tile fusion ({pick}): wall {wall:.3f} ms, CUDA "
              f"events {event:.3f} ms; vs_atomic "
              f"{times['atomic'][0] / wall:.3f} (events "
              f"{times['atomic'][1] / event:.3f}), vs_overlapped "
              f"{times['overlapped'][0] / wall:.3f} (events "
              f"{times['overlapped'][1] / event:.3f}); packed ahead "
              f"vs_atomic {ahead['atomic'][0] / wall:.3f} (events "
              f"{ahead['atomic'][1] / event:.3f}), vs_overlapped "
              f"{ahead['overlapped'][0] / wall:.3f} (events "
              f"{ahead['overlapped'][1] / event:.3f}); "
              f"overlapped_redundancy "
              f"{fused_ops.overlapped_redundancy(a, P23_P):.4f}, "
              f"fused_compute_ratio(ct_size={P23_CT}) "
              f"{fused_compute_ratio(a, ct_size=P23_CT):.4f}, "
              f"block_csr_pattern(a, {P23_BLOCK}).nnz "
              f"{block_csr_pattern(a, P23_BLOCK).nnz} (of {a.nnz}); card "
              f"{smi}", flush=True)
        del a, b, c, fused
    gc_collect()
    print(f"[23] phase 23 took {time.perf_counter() - t23:.1f} s; launches "
          f"by path {launches}", flush=True)
    return launches


def gc_collect() -> None:
    import gc

    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(device: str = "cuda") -> None:
    import gc

    import torch
    run = phases_1_to_15(device)
    from repro_torch.core.tilefusion import api
    api.clear_schedule_cache()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[16] device memory still allocated after phases 1-15: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    moe_launches = phase_16(torch.device(device))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[17] device memory still allocated after phase 16: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    p17_launches = phase_17(torch.device(device))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[18] device memory still allocated after phase 17: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    p18_launches = phase_18(torch.device(device))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[19] device memory still allocated after phase 18: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    p19 = phase_19(torch.device(device))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[20] device memory still allocated after phase 19: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    p20_launches = phase_20(torch.device(device))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[21] device memory still allocated after phase 20: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    phase_21(torch.device(device))
    gc.collect()
    torch.cuda.empty_cache()
    p22_launches = phase_22(torch.device(device))
    gc_collect()
    p23_launches = phase_23(torch.device(device))
    records, band_records = run["records"], run["band_records"]
    path_launches, tensor_core_ops = (run["path_launches"],
                                      run["tensor_core_ops"])
    flash_record_path, device_kind = (run["flash_record_path"],
                                      run["device_kind"])
    t_start = run["t_start"]

    sources = {
        "spmm_ell": ("src/repro_torch/csrc/spmm_ell.cu",
                     "src/repro/kernels/spmm.py:40"),
        "tile_fused_gemm_spmm_wf0": (
            "src/repro_torch/csrc/tile_fused_gemm_spmm.cu",
            "src/repro/kernels/tile_fused_gemm_spmm.py:80"),
        "tile_fused_spmm_spmm_wf0": (
            "src/repro_torch/csrc/tile_fused_spmm_spmm.cu",
            "src/repro/kernels/tile_fused_spmm_spmm.py:101"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:87"),
        "fused_ffn": ("src/repro_torch/csrc/fused_ffn.cu",
                      "src/repro/kernels/fused_ffn.py:54"),
        "fused_moe_ffn": ("src/repro_torch/csrc/fused_ffn.cu",
                          "src/repro/kernels/moe.py:53"),
    }
    # the device function each record's case ran (the launchers' records
    # for the kernels with several paths)
    paths = {"spmm_ell": records[(SPMM_RECORD, "float32")]["path"],
             "tile_fused_gemm_spmm_wf0": records[(
                 "tile_fused_gemm_spmm_wf0", "float32")]["path"],
             "tile_fused_spmm_spmm_wf0": "tile_fused_spmm_spmm_wf0_kernel",
             "flash_attention": flash_record_path,
             # the FFN kernels' device function in each dtype (phase 7)
             **{name: {dname: records[(LM_RECORD[name], dname)]["path"]
                       for dname in ("bfloat16", "float32")}
                for name in ("fused_ffn", "fused_moe_ffn")}}
    kernels = []
    for name, (source, replaces) in sources.items():
        # the GCN kernels' records are f32 (the GCN path's dtype), the LM
        # kernels' bf16 (the LM serving dtype)
        rec = (records[(LM_RECORD[name], "bfloat16")] if name in LM_RECORD
               else records[(SPMM_RECORD if name == "spmm_ell" else name,
                             "float32")])
        extra = ({} if name != "spmm_ell" else
                 dict(case=SPMM_RECORD,
                      replaced_chain_ms=rec["replaced_chain_ms"],
                      # phase 23: the prior-work baselines
                      baseline_launches={path: c[name] for path, c in
                                         p23_launches.items()}))
        if name in ("flash_attention", "fused_moe_ffn"):
            # phase 16: the MoE paths' launches (a granite / llama4
            # prefill; the MoE kernel launches on none of them)
            extra["moe_launches"] = {path: c[name]
                                     for path, c in moe_launches.items()}
        # phase 17: the MLA and hybrid paths' launches (a minicpm3-4b /
        # hymba-1.5b prefill, a training step of each)
        extra["mla_hybrid_launches"] = {path: c[name] for path, c in
                                        p17_launches.items()}
        # phases 18 and 19: the xLSTM paths' launches (none of the six
        # kernels) and the encoder-decoder's and vision stub's
        extra["xlstm_launches"] = {path: c[name] for path, c in
                                   p18_launches.items()}
        extra["encdec_launches"] = {path: c[name] for path, c in
                                    p19["launches"].items()}
        # phase 20: the paths over meshes of the card
        extra["mesh_launches"] = {path: c[name] for path, c in
                                  p20_launches.items()}
        # phase 22: the split blocks over meshes of the card
        extra["split_block_launches"] = {path: c[name] for path, c in
                                         p22_launches.items()}
        fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "max_abs_err")
        if name in LM_RECORD:
            # phase 7's f32 case beside the record's bf16 one
            extra["float32"] = {f: records[(LM_RECORD[name], "float32")][f]
                                for f in fields}
        if name == "flash_attention":
            # phase 7 at the MoE prefills' and minicpm3-4b's shapes (bf16)
            extra["moe_shapes"] = {label: {f: records[(label, "bfloat16")][f]
                                           for f in fields}
                                   for label in LM_MOE_FLASH}
            extra["mla_shape"] = {f: records[(LM_MLA_FLASH, "bfloat16")][f]
                                  for f in fields}
            # phase 19a: the encoder-decoder's and qwen2-vl's shapes
            extra["encdec_shapes"] = p19["flash"]
        band_keys = [k for k in band_records if k.startswith(name)]
        if band_keys:
            # phase 14a: the sparse-band mixer's shapes (f32)
            extra["band"] = {k: {f: band_records[k][f] for f in (
                "ms", "queued_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err", "path")} for k in band_keys}
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=path_launches[name],
                            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                            plain_ms=rec["plain_ms"],
                            bound_ms=rec["bound_ms"],
                            bound_by=rec["bound_by"],
                            library_ms=rec["library_ms"],
                            tensor_core_ops=tensor_core_ops[name],
                            path=paths[name], **extra))
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
