"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure exits non-zero before the result line:

1. build   - compile every kernel under src/repro_torch/csrc/ with nvcc for
             sm_90a (one nvcc per source, in parallel) and print the time
             and ptxas' register/spill report; the cycle model's Figure 8
             sweep (phase 7, host only) runs on a thread meanwhile.
2. kernels - call each kernel's wrapper on the card at the shapes the
             serving paths give it, fp32 and bf16, and hold it against its
             plain PyTorch version: dense_gemm at the unembedding;
             griffin_spmm at every compacted layer shape, dual off/on and
             balance on/off, at M 4/8/16/32 and in bf16 also at
             long_prefill's M 2048 and 4096, printing its cluster split per shape and
             holding rows 0 and 0:4 of a 32-row A bit-equal alone and in
             the full call (dual off/on); sparse_a at the four dense layer
             shapes (B row-major) and the unembedding (B = embed.T,
             strided), printing its route and cluster split per shape,
             holding row slices 0:1, 0:4, 3:7, 8:16, 16:32 of a 32-row A
             bit-equal alone and in the full call, with all-zero K blocks
             in A, several M tiles of different live counts (one with
             none) at block_m 8, and hand-cut metadata that drops a live
             block; its metadata kernel (sparse_a_meta) bit-equal to the
             plain metadata on every A above and on a ragged 7 x 300 A in
             8 x 16 blocks.  Tolerances: fp32 |err| <= 1e-5 * max|ref|
             (summation orders differ); bf16 |err| <= one bf16 ulp of the
             output plus the same fp32 term.  Times kernel, plain version
             and one library call (torch.matmul, a yardstick the port
             never calls), each with a 64 MB L2 flush before every launch
             and every launch queued behind a device-side sleep (twice the
             warm-up's host time, retaken at ~0.1 s where the device woke
             before the last launch was queued), and the bound: the larger of bytes / 3.35 TB/s and operations
             / the card's peak for the type (989 TFLOP/s bf16, 67 TFLOP/s
             fp32), counting only the blocks a sparse kernel must read for
             these inputs.  griffin_spmm is timed at M 4 and 32, bf16 dual
             off and on, fp32 dual off, and at M 4096, bf16 dual off; sparse_a at M 4 and 32, bf16,
             every block live and half of them dead.  griffin_spmm's dual walk
             is held bit-equal to its plain walk on every shape.  It is
             also held on w_up compacted at each block size of the
             autotune grid (16, 32, 64, 128, 512; unit 8): against its
             plain version, and bit-equal to the 128 x 128 / unit 32
             compaction's output (bf16 M 4 and 32, dual and not; fp32 M
             4); and timed at M 4, bf16, with its grid steps (N tiles x
             max_cnt) and the cost per grid step fitted from the 16 and
             128 rows (the constant tuning.search.STEP_OVERHEAD_HW comes
             from this line).  At xlstm-1.3b's shapes (``XLSTM_SPMM``:
             w_up, w_down, the sLSTM gates, w_ff1 with N 2730, w_ff2 with
             an A row 2730 wide, which takes the CUDA-core route, and the
             2048 x 50304 untied head) griffin_spmm is checked, held batch
             invariant and timed at M 4 and 32 (bf16; dual too at w_ff2;
             at w_down also fp32 A against the bf16 weight, the mLSTM
             block's input, dual and not), and dense_gemm's skinny route
             (bf16, fp32, fp32 A x bf16 weight) and sparse_a (bf16, fp32,
             and fp32 A x bf16 weight timed, with its metadata) at the
             (4096 x 4) mLSTM gate leaves, the N edge below one vector.
             At recurrentgemma-9b's shapes (``HYBRID_SPMM``: the MLPs'
             4096 x 12288 and 12288 x 4096, 4096 x 4096, the MQA 4096 x
             256 and the 4096 x 256000 untied head) griffin_spmm is
             checked, dual and not, held batch invariant and timed at M 4
             and 32 (bf16), with its route (below), and dense_gemm's wide
             route and sparse_a with its metadata at the rec blocks'
             dense 4096 x 4096 leaves in bf16 (w_x, w_out) and fp32 (the
             gates w_rg, w_ig).
             At mixtral-8x7b's shapes (``MOE_SPMM``: the experts' 4096 x
             14336 and 14336 x 4096, wq/wo 4096 x 4096, the GQA wk/wv 4096
             x 1024 and the 4096 x 32000 untied head) griffin_spmm is
             checked, dual and not, held batch invariant and timed at M 4
             and 32 (bf16), with its route (below), and timed dual on an
             all-zero A (an expert no token chose); the fp32 4096 x 8
             router through dense_gemm's skinny route and through sparse_a
             with its metadata, each checked, held batch invariant and
             timed.
             At whisper-large-v3's shapes (``WHISPER_SPMM``: 1280 x 1280,
             1280 x 5120, 5120 x 1280 and the 1280 x 51866 head, whose last
             N tile holds 26 columns) griffin_spmm is checked, dual and
             not, and timed at M 4 and 32 (bf16), and on the encoder's
             three shapes at M 1500 with fp32 A against the bf16 weight
             (the CUDA-core route; torch.matmul on the weight widened to
             fp32); held batch invariant at 1280 x 5120 (bf16 and fp32 A);
             and at the head, on integer-valued A and weight whose sums
             are exact in any order, bit-equal to its plain version in
             every column (bf16 M 4 and 32, dual and not; fp32 A M 4).
             At the K2 leaf shapes of stablelm-1.6b, minitron-8b and
             command-r-plus-104b (``DENSE_SPMM``, 14 shapes up to the
             12288 x 256000 head) and of chameleon-34b (``VLM_SPMM``: 8192
             x 8192, 8192 x 1024, 8192 x 22016, 22016 x 8192 and the 8192 x
             65536 head) griffin_spmm is checked at M 4 and 32
             (bf16), timed beside its bound and torch.matmul, held batch
             invariant at each config's w_down, and the route its Python
             mirror predicts (griffin_spmm.kernel.route: the tensor-core
             route's shared memory from the weight's grid depth against
             the card's 232,448 B) must be the route the launch took
             (griffin_spmm's launches per route, counted in its C++ entry:
             spmm_tc_kernel or spmm_core_kernel), as at the hybrid's and
             mixtral's shapes (non-dual).  sparse_a with its metadata at
             stablelm-1.6b's Mode.A shapes beyond llama's
             (``STABLELM_K3``): its FFN (2048 x 5632, 5632 x 2048, B
             row-major) at M 4/8/16/32 with two all-zero K blocks and
             with every block live, its dense 2048 x 100352 head at M 4
             and 32; and at every chameleon-34b leaf (``CHAMELEON_K3``) the
             same way; the metadata bit-equal to the plain metadata.
             The metadata kernel alone (``META_SHAPES``: 4 x 2048, 4 x
             4096, 32 x 4096, 128 x 8192, bf16, every block live) with its
             cluster
             split, timed (events, as above) beside its device duration
             under torch.profiler (20 back-to-back launches, warm L2) and
             the launch floor: a one-element fill timed both ways.
             The shard entries (``kernel_shards``): at llama's four
             SPMM_SHAPES (griffin_spmm, dual off and on, sparse_a and
             dense_gemm on the dense weight) and the tied head (dense_gemm
             and sparse_a on embed.T), at M 4 and 32 over 2 and 4 model
             ranks, and griffin_spmm at chameleon-34b's 22016 x 8192
             w_down, whose whole weight takes the CUDA-core route: each
             rank's columns gathered (K2: the inverse balance shuffle
             after) bit-equal to the whole kernel.
3. serve   - full-width llama3.2-1b (bf16, random weights from a seed)
             through repro_torch.launch.serve: 8 requests with prompt
             lengths 8/16/32 and generation lengths 4/8/16, decode_chunk
             8, in four paths (4 slots of the fixed arena unless said):
               sparse_b - block-pruned to 0.8 at 128x128 / unit 32 and
                          compacted: griffin_spmm 112x and dense_gemm 1x
                          per model call (prefill or decode step);
               mode_a   - dense weights, declared activation sparsity 0.5:
                          sparse_a 113x and sparse_a_meta 65x per model
                          call (the metadata built once per distinct
                          input: wq/wk/wv and w_gate/w_up share one);
               mode_ab  - pruned and compacted as sparse_b, declared
                          activation sparsity 0.5: griffin_spmm 112x, all
                          dual, and sparse_a and sparse_a_meta 1x each per
                          model call;
               sparse_b_paged - sparse_b's weights and kernels served
                          from the paged KV arena: 8 slots, up to 8
                          admissions a tick, 16-token pages, cache_len 49
                          rounded up to 64 (4 pages), 13 pages = 12 usable
                          + DUMP, i.e. 192 KV rows, no more than the 4 x 49
                          of sparse_b's fixed arena; its peak of active
                          slots must exceed the 4 those rows hold fixed;
               sparse_b_paged_int8 - the same with int8 pages: no oracle
                          parity (int8 is gated by a logit tolerance);
                          instead every request's tokens equal those of a
                          one-slot int8 paged engine serving it alone, the
                          teacher-forced relative logit gap of int8 to
                          same-dtype pages (one 24-token prompt, 48 steps)
                          is at most 0.02, the K/V pools plus scales take
                          (512 + 4) / 1024 of sparse_b_paged's bytes, and
                          the token match with sparse_b_paged is printed;
               mode_a_paged, mode_ab_paged - mode_a's and mode_ab's
                          weights and kernels on sparse_b_paged's arena;
               sparse_b_stepwise, sparse_b_static - sparse_b on the
                          stepwise path (fused=False, decode_chunk 1: one
                          decode step and one host sync per tick, one sync
                          per admission) with the continuous and the
                          static policy; their stats equal STEPWISE_STATS,
                          which tests/test_torch_stepwise.py holds on the
                          CPU for the same trace;
               mesh_2x2 - (after the paths above) sparse_b's trace,
                          weights, slots and chunk on a 2x2 ("data",
                          "model") mesh of four ranks spawned on the one
                          card (launch.serve.serve_on_mesh; gloo on CUDA
                          tensors, the backend line printed), each rank
                          drawing the seeded tree on the card and keeping
                          its share: per rank and model call griffin_spmm
                          112x through its shard entry on half of every
                          leaf's N tiles and dense_gemm 1x (the tied head's
                          64128-column shard), no GEMM replicated or
                          through the oracle; each rank's arena its data
                          row's 2 slots at its 4 of the 8 KV heads
                          (1,605,632 B of K/V), 113 gathers over "model"
                          a prefill and 129 a decode step (one more a
                          layer: the attention output of its heads);
                          tokens equal sparse_b's (no oracle pass), every
                          rank's host-state digest equal, at most 0.25
                          host syncs per token; each rank's tok/s beside
                          sparse_b's and its gathers per model call with
                          their host ms are printed;
               mesh_remesh - in the same spawn, on the weights each rank
                          drew for mesh_2x2: rank 3's device lost at the
                          decode poll due at step 3 (it fires at clock 4),
                          the ranks roll back and remesh onto 1x2 (ranks 0
                          and 1; rank 2 dropped) and replay: each survivor
                          takes data row 1's tick-start head share it
                          keeps (1,605,664 B with the counters), rank 0
                          from rank 2, rank 1 from lost rank 3's host
                          copy; gated on both survivors: those bytes and
                          senders, sparse_b's tokens, one
                          recovery logged as {"step": 4, "lost": [3],
                          "mesh": "1x2"}, 2 model calls replayed,
                          griffin_spmm 112x and dense_gemm 1x per model
                          call after the recovery, all through the shard
                          entries, at most 0.25 host syncs per token,
                          equal host-state digests; rank 3 "lost" and
                          rank 2 "dropped", neither launching a kernel or
                          dispatching a GEMM after the loss; each
                          survivor's recovery seconds (regroup, handover
                          with its bytes, reshard), replayed calls and
                          tok/s before and after the loss are printed.
             Launch counters are zeroed just before and read just after
             each engine run.  A later path of a family on the same seeded
             draw serves the first's weights (built once; a second build
             gives the same bits).  Each path checks: every request
             token-identical to the batch-1 greedy oracle (not int8; the
             oracle depends on the weights and the Mode alone, so the
             paged and stepwise paths' tokens must equal those of sparse_b,
             mode_a or mode_ab, which run it); no
             plain GEMM; its exact launch counts; at most 0.25 host syncs
             per token on the fused paths; a prefill (and on the paged
             paths an admission) and, on the fused paths, a fused chunk
             run under CUDA's sync debug mode; prefill logits finite and
             within 2% (relative L2) of the same model served through
             plain torch matmuls (the dense weights, or the compacted ones
             decompacted); both routes' gaps to the model widened to fp32
             are reported beside it, the kernel route's at most 1.25x the
             plain route's (``FP32_GAP_RATIO``).  ``--profile``
             adds a profiled engine run and one profiled decode step (a
             1-step chunk, the arena's cost apart from admission policy)
             after each path, and a profiled 4096-token prefill after
             long_prefill.
             Then full-width xlstm-1.3b (48 blocks, 6 groups of 7 mLSTM +
             1 sLSTM, d=2048, 4 heads, vocab 50304, untied head, bf16,
             seed 0) on the same trace and checks, in three paths
             (``XLSTM_PATHS``):
               xlstm_sparse_b - pruned 0.8 at 128x128 / unit 32 and
                          compacted, 4 slots: griffin_spmm 121x and
                          dense_gemm 84x (the 4096 x 4 gate leaves, below
                          the pruning's minimum width) per model call;
               xlstm_mode_ab - the same weights, declared activation
                          sparsity 0.5: griffin_spmm 121x dual, sparse_a
                          84x and sparse_a_meta 42x (wi and wf share one);
               xlstm_paged_degrades - xlstm_sparse_b with 16-token pages
                          asked for: the recurrent state does not track
                          cache_len, so no paged arena is built (as in the
                          reference) and the tokens equal xlstm_sparse_b's
                          (no oracle of its own).
             After xlstm_sparse_b, its weights prefill 32 and 256 tokens
             (seconds, memory rise within 3 GiB, the sLSTM blocks' share of
             the 32-token prefill).
             Then full-width whisper-large-v3 (32 encoder + 32 decoder
             layers, d=1280, 20 heads, d_ff 5120, GeLU, an untied
             51866-token head, bf16, seed 0; every request carries its
             1500 x 1280 fp32 frames) on the same trace, in three paths
             (``WHISPER_PATHS``), gated per (prefill, decode step):
               whisper_sparse_b - pruned 0.8 at 128x128 / unit 32 and
                          compacted, 4 slots: griffin_spmm 513 a prefill
                          (the encoder's 32 x 6, the decoder's 32 x 10, the
                          head), 256 of them on fp32 A (the encoder's GEMMs
                          and the cross wk/wv take the fp32 encoder stream
                          against the bf16 weights, as in the reference),
                          and 257 a decode step (32 x 8, the head), no
                          other kernel;
               whisper_mode_ab - the same weights, declared activation
                          sparsity 0.5: every griffin_spmm launch dual (held
                          bit-equal to the plain walk in phase 2), so its
                          tokens must equal whisper_sparse_b's (no oracle of
                          its own);
               whisper_paged - whisper_sparse_b's weights on
                          sparse_b_paged's arena: the decoder's k/v paged,
                          the cross K/V (1500 rows a slot) fixed beside the
                          pools; its tokens must equal whisper_sparse_b's
                          (it runs no oracle of its own).
             Their parity oracle is the engine's own computation: each
             request's bucketed prefill cache cast to init_cache's dtypes
             (the fp32 cross K/V rounded to bf16, as the admission writes
             them), then batch-1 greedy decoding; the uncast
             greedy_generate loop (the reference's oracle, fp32 cross K/V)
             is printed beside it, not gated: its differing tokens and the
             first step's largest logit gap.  Each path also checks the
             prefill's cross K/V fp32 and the arena's bf16, and one
             admission's memory rise (the encoder's attention over 1500
             frames included) within 3 GiB; the other checks are the llama
             paths', the gap to the fp32 twin included.
             Then full-width recurrentgemma-9b (38 blocks: 12 groups of
             (rec, rec, attn) and a tail of 2 rec blocks, each with its
             GeGLU MLP; d=4096, lru_width 4096, conv 4, 16 heads, MQA,
             head_dim 256, window 2048, d_ff 12288, vocab 256000, untied
             head, bf16, seed 0) on the same trace, with the same checks
             but the gaps to fp32 (its fp32 twin would not fit beside the
             served and the plain weights), in three paths
             (``HYBRID_PATHS``):
               hybrid_sparse_b - pruned 0.8 at 128x128 / unit 32 and
                          compacted, 4 slots: griffin_spmm 189x and
                          dense_gemm 104x (w_x, w_out in bf16; w_rg, w_ig
                          fp32 A against fp32 weights) per model call;
               hybrid_mode_ab - the same weights, declared activation
                          sparsity 0.5: griffin_spmm 189x dual, sparse_a
                          104x and sparse_a_meta 78x (w_x's input, the
                          gates' shared input and w_out's, per rec block);
               hybrid_paged - hybrid_sparse_b's weights on sparse_b_paged's
                          arena: k/v paged (window 2048 >= cache_len), the
                          recurrent and conv state fixed beside the pools;
                          its tokens must equal hybrid_sparse_b's (no oracle
                          of its own).
             After hybrid_sparse_b, hybrid_long_window: its weights prefill
             one 4200-token prompt with cache_len 4224 (the K/V cache
             keeps the last 2048 rows rolled by 4200 % 2048), then decode
             8 seeded tokens through the wrap; logits within 2% (relative
             L2) of the plain route at the prefill and at every step, every
             K/V cache row within 5%, launches exactly 9 model calls' worth,
             memory rise within 3 GiB, seconds printed.
             Then mixtral-8x7b at full width, its depth cut to
             ``MOE_LAYERS`` = 8 of its 32 layers (d=4096, 32 heads, GQA 8,
             head_dim 128, 8 experts top-2 with d_ff 14336, window 4096,
             vocab 32000, untied head, bf16, seed 0; at 32 layers 46.7 B
             parameters, 93 GB of bf16, built compacted to 71.43 GiB on the
             card in PR 29's runs; the cut keeps the smoke's wall within
             its limit, and tests/test_torch_moe.py holds the launch gates
             per model call on a depth-true 32-layer model on the CPU):
             every earlier model freed first, launch.serve builds its
             weights once for the three paths, compacted one
             matrix at a time (sparsity.init_sparse_params; the build's
             seconds, peak allocated bytes and resident bytes printed, the
             peak gated below the card's memory), on the same trace with the
             same checks, the plain route being ref.py on the compacted
             weights (no dense twin fits) and no gap to fp32, in three paths
             (``MOE_PATHS``):
               moe_sparse_b - pruned 0.8 at 128x128 / unit 32 and
                          compacted, 4 slots: griffin_spmm 28x a layer (wq,
                          wk, wv, wo and 8 experts x 3) + 1 (the head) and
                          dense_gemm 1x a layer (the router, fp32 A against
                          the weight upcast, skinny route) per model call
                          (``MOE_PATHS`` holds the 32-layer counts, 897 and
                          32; ``moe_at_depth`` scales them to the cut);
               moe_mode_ab - the same weights, declared activation sparsity
                          0.5: griffin_spmm dual, sparse_a and sparse_a_meta
                          1x a layer (the routers);
               moe_paged - moe_sparse_b's weights on sparse_b_paged's arena
                          (window 4096 >= cache_len); its tokens must equal
                          moe_sparse_b's (no oracle of its own);
               moe_full_depth - after them, the cut weights freed: the
                          streamed build at all 32 layers (seconds, peak
                          and resident bytes, the peak gated below the
                          card's memory) and one 16-token prefill through
                          it: 897 griffin_spmm + 32 dense_gemm launches, no
                          plain GEMM, finite logits within 2 % of the plain
                          route under the kernel route's routing.
             Each prints the experts no row chose per (layer, decode step)
             (what dual griffin_spmm skips whole) and, from one fused
             4-step chunk on the drained arena under torch.profiler
             (always, not only with ``--profile``), device ops per decode
             step, the device's busy share and griffin_spmm's device ms
             per decode step; Mode.AB's against Sparse.B's is printed
             after the three.  After
             moe_sparse_b, moe_long_window: as hybrid_long_window, one
             4200-token prompt with cache_len 4224 > window 4096 (the K/V
             cache keeps the last 4096 rows rolled by 104), 8 decode steps
             through the wrap, against the plain route on the same weights.
             After the llama paths, the dense family's other configs on
             the same trace and checks (``DENSE_PATHS``; bf16, seed 0,
             pruned 0.8 at 128x128 / unit 32):
               stablelm_sparse_b - full-width stablelm-1.6b (24 layers,
                          d 2048, 32 heads MHA, d_ff 5632, an untied
                          100352-token head), compacted, 4 slots:
                          griffin_spmm 169x per model call, no other kernel;
               stablelm_mode_a - its dense weights, declared activation
                          sparsity 0.5: sparse_a 169x and sparse_a_meta 97x
                          (4 builds a layer and the head);
               stablelm_paged - stablelm_sparse_b on sparse_b_paged's arena;
               minitron_sparse_b - full-width minitron-8b (32 layers, d 4096,
                          32 heads / 8 KV, head_dim 128, d_ff 16384, an
                          untied 256000-token head; ~9.9 B parameters built
                          by api.init then sparsify_params, its build's
                          seconds and memory printed and the peak gated
                          below the card's): griffin_spmm 225x;
               minitron_paged - minitron_sparse_b on the paged arena;
               command_r_cut - command-r-plus-104b at full width (d 12288,
                          96 heads / 8 KV, d_ff 33792, an untied 256000-token
                          head, rope_theta 75000) with num_layers cut 64 ->
                          2 (printed as a cut; 208 GB of bf16 fit no card):
                          griffin_spmm 15x, its build printed as minitron's.
             The paged paths' tokens must equal their _sparse_b path's
             (no oracle of their own); minitron's and command-r's plain
             route is ref.py on the served weights (no fp32 gap).  Each
             path prints every compacted leaf's K2 route by the Python
             mirror, counted by leaf, shape and route, with its grid depth,
             and griffin_spmm's launches per route over the run must be
             those slices times the model calls.  minitron_sparse_b also
             checks, route-gates and times layer 0's w_gate as served (at
             the stack's grid depth, its deepest layer's) at M 4 and 32.
             Then the vlm family (``VLM_PATHS``): full-width chameleon-34b
             (48 layers, d 8192, 64 heads / 8 KV at head_dim 128 with
             QK-norm, d_ff 22016, an untied 65536-token head; 34.3 B
             parameters, 68.6 GB of bf16), with these checks and a profiled
             one-step fused chunk (device ops a step, busy share, griffin_spmm,
             sparse_a and metadata device ms):
               chameleon_sparse_b - pruned 0.8 at 128x128 / unit 32 by the
                          streamed build (the dense tree and its compaction
                          do not fit together; its seconds, peak and
                          resident bytes printed, the peak gated below the
                          card's memory): griffin_spmm 337x a model call, no
                          other kernel; every stacked leaf whose served grid
                          depth differs from the kernel phase's draw checked,
                          route-gated and timed as served (layer 0);
               chameleon_mode_a - its dense weights (63.9 GiB, drawn in the
                          same order after the compacted tree is freed),
                          declared activation sparsity 0.5: sparse_a 337x
                          and sparse_a_meta 193x.
             Both take the plain route on the served weights and the fp32
             model a layer at a time (fp32_prefill), the kernel route at
             most 1.25x the plain route's gap to it; chameleon_mode_a's gap
             to the plain route is gated at 3 % (CHAMELEON_MODE_A_GAP: every
             bf16 route of that model is ~2.1 % from fp32).
4. long_prefill - after sparse_b, its weights prefill one 2048-token and
             one 4096-token prompt (cache_len = prompt length): seconds
             and the rise of torch.cuda.max_memory_allocated() over the
             level before each call, which must stay within 3 GiB
             (attention walks 512-key chunks in 64-row query tiles, so
             its transient does not grow with the prompt); griffin_spmm
             112x and dense_gemm 1x per call; last-token logits finite
             and within 2% (relative L2) of the plain-matmul route, and
             every (layer, position) row of the K/V cache within 5%.
4b. train  - after the serve families, the training path at full width
             through repro_torch.launch.train's CLI (``TRAIN``:
             llama3.2-1b, batch 8, seq 128, lr 3e-3, --prune-sparsity
             0.5, a checkpoint every 20 steps), one process.  Gates:
             (1) the flash backward at the model's head shapes (H 32, KVH
             8, hd 64, B 1; S 512 and 2048 causal, 2048 windowed, a
             ragged 2000) in fp32 within relative L2 1e-4 of autograd
             through the materialised attention, and at S 2048 its peak
             allocation rise below one B*H*S*S fp32 score matrix;
             (2) one train step in bf16 against the same step on the
             weights widened to fp32: loss within 1 %, grad norm within
             5 %; (3) 30 steps: every loss and grad norm finite, the mean
             loss of the last five below the first five's by 30 %
             (``TRAIN_DESCENT``; step ms, tokens/s and the peak
             allocation printed, not gated); (4) right after the step-25
             prune milestone every pruned leaf's layers hold exactly the
             share of all-zero 128 x 32 blocks block_prune leaves at the
             schedule's sparsity; (5) the step-20 checkpoint (bytes and
             seconds printed, in a temporary directory under build/
             removed after) restored by a second CLI run, whose steps
             20-29 give the uninterrupted run's losses and grad norms bit
             for bit; (6) the final state pruned and compacted by
             sparsify_params at 0.5 (128 x 128 / unit 32) with every
             decompacted layer equal to the pruned leaf, and one 4-row
             prefill through the kernels launching exactly griffin_spmm
             112 + dense_gemm 1 (its row in the kernels line's
             launches_by_path) within 2 % of the plain route.
5. fault   - after the serve paths, seven engine-level fault cells
             (FAULT_CELLS) through repro_torch.launch.serve with
             ``fault.inject = "kill:0@<at>:<phase>"``, each on one serve
             path's weights, engine and trace: fault_kill_admission,
             _prefill and _decode on sparse_b's (at clock 5),
             fault_kill_stepwise on sparse_b_stepwise's,
             fault_kill_paged_int8 on sparse_b_paged_int8's and
             fault_kill_mode_ab on mode_ab's (decode, clock 5), and
             fault_snapshot_dir on sparse_b_paged's with 4 requests
             (decode, clock 2) and every tick-start snapshot, the weights
             included, written through checkpoint.save under
             chiprun_out/fault_snapshots (the arrays are deleted after the
             cell, the manifests kept).  Each cell checks: the kill fired
             once at that clock; one recovery, logged as the reference
             logs it; the model calls the recovery replayed equal the CPU
             tests' count; launches exactly the path's per model call over
             every call made, the replayed ones included; no plain GEMM;
             tokens, stats (host syncs included: a capture is not one),
             Mode history and the final device state (arena, int8 pages
             and scales, page table, feedback tokens, counters; a paged
             arena's never-read DUMP page left out) bit-equal to the
             path's unfaulted run (the disk cell: an unfaulted engine on
             the same 4 requests), so also to the batch-1 oracle where
             that run has parity; the disk cell reads the scheduler and
             paging state back from its newest manifest.  It prints the
             recovery log, the model calls made and replayed, the median
             capture time and bytes per tick, the disk saves' seconds and
             tok/s (not gated) beside the card's name and power limit.
6. router  - after the fault cells, four cells of the SLO-aware
             multi-replica router through repro_torch.launch.serve.route
             (ROUTER_CELLS), every replica an engine over one shared set
             of weights:
               router_bounded - sparse_b's weights, 2 replicas x 4 slots,
                          cache_len 137, the reference benchmark's
                          48-request bursty heavy-tailed overload trace
                          with priorities and deadlines, queue bound 6 and
                          the degradation ladder;
               router_unbounded - the same trace without SLO fields, an
                          unbounded queue and no ladder;
               router_kill - mode_ab's weights, 2 x 2 slots, decode_chunk
                          2, 6 requests at tick 0; replica 1 killed at
                          tick 2 mid-decode and rejoined 3 ticks later;
               router_hedge - mode_a's weights, 3 x 3 slots,
                          decode_chunk 2, 5 of those requests, hedging
                          after 1 tick: both hedge losers (a primary and
                          a hedge copy) are cancelled mid-decode.
             Each cell checks: building the replicas raised the card's
             allocated memory by less than half the weights' bytes; every
             engine built (killed and rejoined ones too) stayed in the
             path's Mode; launches over all engines equal the path's per
             model call; no plain GEMM; the virtual-tick row equals the
             reference's (ROUTER_ROWS, the benchmark's committed router
             rows) or the router record equals the reference's
             (ROUTER_RECORDS); completed requests token-identical to the
             batch-1 oracle (router_unbounded: every third rid); every
             cancel of a hedge loser under CUDA's sync debug mode, and
             (router_hedge) a running request cancelled on the fixed and
             on the paged arena, then a new request admitted into its
             freed slot, token-identical to the oracle.  ``--profile``
             adds one profiled routed run per cell.
7. cycle_model - the paper's cycle model: the Figure 8 sweep
             (benchmarks/fig8_overall.py's eight designs, the four modes,
             CoreConfig(), seed 4, no cache) through the port's
             core.dse.sweep on the host, its rows (speedup, TOPS/W,
             TOPS/mm^2) equal to FIG8_ROWS within |rel| 1e-12, with the
             Griffin-vs-SparTen.AB TOPS/W ratios and sparsity taxes printed
             beside the paper's.  Every group the numpy engine scheduled
             cycles-only over full-length streams during the sweep is
             captured, split by config and run through
             schedule_batched(..., backend="torch"): the batch_eval kernel's
             integer cycles must equal the engine's on every row, one launch
             a stream (counters zeroed just before, read just after).  The
             wrapper (schedule_cycles on the card) equals the plain version
             and the engine on each config's largest full stream, the
             reference test's 8 x 3 random masks with and without shuffle,
             a T = 1 stream and a stream of empty chunks.  For each of the
             kernel's two routes (kernel.route: scan for d2 = d3 = 0, else
             chain) on its largest stream (ties: the deepest window): the
             kernel (median of 20 after a 64 MB L2 flush, and its device
             duration under torch.profiler), the plain version (median of
             5, one warm-up call) and the numpy engine (host wall time, median of 5), beside
             the bound (mask bytes / 3.35 TB/s) and the launch floor (a
             one-element fill); no PyTorch call computes the schedule, so
             no library time.
8. autotune - repro_torch.launch.autotune's pipeline for the dense family
             at full width (``AUTOTUNE``): 16 candidates enumerated from
             the seven GEMM shapes and scored by the cycle-model DSE
             sweep and the roofline of the compacted decode step (printed
             with grid steps and predicted seconds), 3 shortlisted; the
             default engine (128 x 128 / unit 32) and each shortlisted one
             serve the reference's tuning trace (6 requests, prompts 6/10,
             generations 4/8/16, 4 slots, decode_chunk 8; a warm run, then
             best of 3), then the grid's first candidate of every block
             size the shortlist left out (a warm and one timed run), so
             griffin_spmm runs at every granularity of the grid.  Each
             engine: launch counters zeroed just before and read just
             after its runs, 112 griffin_spmm + 1 dense_gemm per model
             call, no plain GEMM, tokens equal to the default's, and its
             logits bit-equal to the default's on a witness the random
             model's repetitive greedy tokens cannot give: a prefill of 8
             prompts of 12 seeded ids and 8 decode steps fed seeded ids
             (``WITNESS``; the largest |diff|, the argmax flips and the
             smallest top-1/top-2 margin are printed).  The
             plan goes to chiprun_out/kernel_plan_torch.json and is read
             back through load_plan, its rule the winner's.  tok/s and
             the winner are printed with the card line, not gated.

Every phase prints its wall seconds on a line of its own ("[phase] <name>
<seconds>s") as it ends.  The line before the last is the kernel summary
JSON, the one before it the card's name and power limit; the last line is
the result JSON.  The full
per-shape report goes to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
# "mixed": fp32 A against a bf16 weight, fp32 FMAs on the CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "mixed": 67e12}
# timed_ms's device-side sleep: cycles a second at the H100's 1.98 GHz
# boost clock (a sleep at a lower clock lasts longer), and its longest
SLEEP_CYCLES_PER_S = 1.98e9
MAX_SLEEP_CYCLES = 200_000_000
# (A, weight) dtypes of a kernel row, by its "dtype" label
PAIRS = {"bfloat16": ("bfloat16", "bfloat16"),
         "float32": ("float32", "float32"),
         "mixed": ("float32", "bfloat16")}
SPMM_SHAPES = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))
UNEMBED = (2048, 128256)
M_ROWS = (4, 8, 16, 32)          # decode slots, prefill buckets 8..32
A_SPARSITY = 0.5                 # the reference's category knob
SEED = 0                         # every serve path's random weights
FIXED = dict(num_slots=4)
PAGED = dict(num_slots=8, page_size=16, num_pages=13,
             max_admissions_per_step=8)
STEPWISE = dict(num_slots=4, fused=False, decode_chunk=1)
# the stepwise paths' counters on TRACE: they depend only on the trace
# and the scheduler (tests/test_torch_stepwise.py holds them on the CPU)
STEPWISE_STATS = {"decode_steps": 22, "prefill_calls": 8, "emitted": 52,
                  "host_syncs": 32}
SB = dict(sparsity=0.8, a_sparsity=None, mode="B",
          launches={"dense_gemm": 1, "griffin_spmm": 112, "sparse_a": 0,
                    "sparse_a_meta": 0, "batch_eval": 0}, dual=0)
# Mode.A builds the activation metadata once per distinct input: per layer
# wq/wk/wv, wo, w_gate/w_up and w_down, then the unembedding (16 x 4 + 1)
MODE_A = dict(sparsity=0.0, a_sparsity=A_SPARSITY, mode="A",
              launches={"dense_gemm": 0, "griffin_spmm": 0, "sparse_a": 113,
                        "sparse_a_meta": 65, "batch_eval": 0}, dual=0)
MODE_AB = dict(sparsity=0.8, a_sparsity=A_SPARSITY, mode="AB",
               launches={"dense_gemm": 0, "griffin_spmm": 112,
                         "sparse_a": 1, "sparse_a_meta": 1,
                         "batch_eval": 0}, dual=112)
SB_LAUNCHES = SB["launches"]
# per serve path: kernel -> launches per model call (a prefill or a decode
# step), dual griffin_spmm GEMMs per model call, the engine's arena and
# scheduler fields, and the stats a path must give exactly.  The oracle
# depends on the weights and the Mode alone, so a path on the weights and
# Mode of an earlier path (a paged arena in the cache's own dtype, a
# stepwise policy) runs none: its tokens must equal that path's, which
# holds them against the oracle.
PATHS = {
    "sparse_b": dict(SB, arena=FIXED),
    "mode_a": dict(MODE_A, arena=FIXED),
    "mode_ab": dict(MODE_AB, arena=FIXED),
    "sparse_b_paged": dict(SB, arena=PAGED, tokens_of="sparse_b"),
    "sparse_b_paged_int8": dict(SB, arena=dict(PAGED, kv_dtype="int8")),
    "mode_a_paged": dict(MODE_A, arena=PAGED, tokens_of="mode_a"),
    "mode_ab_paged": dict(MODE_AB, arena=PAGED, tokens_of="mode_ab"),
    "sparse_b_stepwise": dict(SB, arena=dict(STEPWISE, policy="continuous"),
                              stats=STEPWISE_STATS, tokens_of="sparse_b"),
    "sparse_b_static": dict(SB, arena=dict(STEPWISE, policy="static"),
                            stats=STEPWISE_STATS, tokens_of="sparse_b"),
}
TRACE = dict(requests=8, prompt_lens=(8, 16, 32), gen_lens=(4, 8, 16))
# mesh serving: sparse_b's weights, trace, slots and chunk on a 2x2 mesh of
# four ranks sharing the one card (gloo on CUDA tensors, launch.mesh's
# backend rule): the slots split over the two data rows, every weight
# GEMM's output columns and the arena's 8 KV heads over the two model
# ranks.  Per rank and model call (its data row's prefills and every decode
# step) griffin_spmm 112x, each through its shard entry on half the N
# tiles, and dense_gemm 1x (the tied head, a 64128-column shard of
# embed.T); 113 gathers over "model" a prefill (one a GEMM) and 129 a
# decode step (and one a layer for the attention output); each rank's K/V
# 2 slots x 49 rows x 16 layers x 4 heads x 64 x bf16, k and v; its tokens
# must equal sparse_b's.
MESH = dict(spec="2x2", sparsity=0.8, arena=FIXED, launches=SB_LAUNCHES,
            shard_gemms=113, tokens_of="sparse_b", max_syncs=0.25,
            kv_bytes=1_605_632, gathers={"prefill": 113, "decode": 129})
# remeshing (mesh_remesh): in the same spawn, after mesh_2x2's run and on
# the weights each rank drew for it, rank 3's device is lost at the decode
# poll due at step 3.  The trace's ticks start at clocks 0, 2 and 4, so the
# kill fires at clock 4, which the recovery logs, and the 2 model calls of
# that tick are replayed (tests/test_torch_remesh.py holds both on the
# CPU); the survivors plan 1x2 (ranks 0 and 1), rank 2 is dropped.  Each
# survivor keeps its model rank's heads and takes data row 1's share of
# them from its holder: (row 1, share 0) from rank 2, (row 1, share 1) from
# lost rank 3's host copy, each a rank's K/V and 32 B of counters.  Per
# survivor and model call after the recovery: griffin_spmm 112x and
# dense_gemm 1x, all through the shard entries.
MESH_REMESH = dict(inject="kill:3@3:decode", log=[{"step": 4, "lost": [3],
                                                   "mesh": "1x2"}],
                   replayed=2, left={2: "dropped", 3: "lost"},
                   handover_bytes=1_605_664,
                   sources={0: {(1, 0): 2}, 1: {(1, 1): 3}})
# the kernels' shard entries, each rank's columns gathered against the
# whole kernel (bit-equal): llama's four SPMM_SHAPES and the tied head at
# M 4 and 32, over 2 and 4 model ranks, and chameleon-34b's w_down (22016 x
# 8192), whose whole weight at 0.8 takes K2's CUDA-core route
MESH_SHARDS = (2, 4)
SHARD_CORE = (22016, 8192)
# the ssm family: full-width xlstm-1.3b (6 groups of 7 mLSTM + 1 sLSTM) on
# TRACE.  Per model call griffin_spmm runs its 121 compacted leaves (w_up
# and w_down x 42, the sLSTM's six x 6, the untied head) and its 84 plain
# (4096 x 4) mLSTM gate leaves go through dense_gemm, or in Mode.AB through
# sparse_a and its metadata, built once per mLSTM block for wi and wf
# (tests/test_torch_xlstm.py counts them on the CPU).  The paged config
# must degrade to the fixed arena (the recurrent state does not grow with
# the sequence), so its tokens must equal xlstm_sparse_b's, which holds
# the oracle.
XLSTM = "xlstm-1.3b"
XLSTM_SB = dict(sparsity=0.8, a_sparsity=None, mode="B",
                launches={"dense_gemm": 84, "griffin_spmm": 121,
                          "sparse_a": 0, "sparse_a_meta": 0,
                          "batch_eval": 0}, dual=0)
XLSTM_AB = dict(sparsity=0.8, a_sparsity=A_SPARSITY, mode="AB",
                launches={"dense_gemm": 0, "griffin_spmm": 121,
                          "sparse_a": 84, "sparse_a_meta": 42,
                          "batch_eval": 0}, dual=121)
XLSTM_PATHS = {
    "xlstm_sparse_b": dict(XLSTM_SB, arena=FIXED),
    "xlstm_mode_ab": dict(XLSTM_AB, arena=FIXED),
    "xlstm_paged_degrades": dict(XLSTM_SB, arena=dict(
        FIXED, page_size=16, num_pages=13), tokens_of="xlstm_sparse_b"),
}
# the hybrid family: full-width recurrentgemma-9b (12 groups of (rec, rec,
# attn) + a tail of 2 rec blocks, each block with its GeGLU MLP) on TRACE.
# Per model call griffin_spmm runs its 189 compacted leaves (per group the
# two rec blocks' w_gate, the attention block's four and the three MLPs'
# nine, per tail block its w_gate and MLP, and the untied head); the 26
# rec blocks' dense w_x and w_out (bf16) and the gate leaves w_rg and w_ig
# (fp32 A against their weights widened to fp32, as in the reference) go
# through dense_gemm, or in Mode.AB through sparse_a with its metadata
# built once per distinct input: w_x's, the shared w_rg/w_ig input and
# w_out's (tests/test_torch_rglru.py counts them on the CPU).  The paged
# path pages k/v (window 2048 >= cache_len) and keeps the recurrent state
# fixed; its tokens must equal hybrid_sparse_b's, which holds the oracle.
HYBRID = "recurrentgemma-9b"
HYBRID_SB = dict(sparsity=0.8, a_sparsity=None, mode="B",
                 launches={"dense_gemm": 104, "griffin_spmm": 189,
                           "sparse_a": 0, "sparse_a_meta": 0,
                           "batch_eval": 0}, dual=0)
HYBRID_AB = dict(sparsity=0.8, a_sparsity=A_SPARSITY, mode="AB",
                 launches={"dense_gemm": 0, "griffin_spmm": 189,
                           "sparse_a": 104, "sparse_a_meta": 78,
                           "batch_eval": 0}, dual=189)
HYBRID_PATHS = {
    "hybrid_sparse_b": dict(HYBRID_SB, arena=FIXED),
    "hybrid_mode_ab": dict(HYBRID_AB, arena=FIXED),
    "hybrid_paged": dict(HYBRID_SB, arena=PAGED,
                         tokens_of="hybrid_sparse_b"),
}
# hybrid_long_window, on hybrid_sparse_b's weights: one prompt longer than
# the window straight through the model's prefill (the keep-the-last-
# window-and-roll branch), then decode steps that wrap the rolling cache
HYBRID_LONG = dict(prompt=4200, cache_len=4224, steps=8)
# the moe family: full-width mixtral-8x7b (32 layers, 8 experts top-2,
# d_ff 14336, window 4096) on TRACE, its weights built compacted one
# matrix at a time (sparsity.init_sparse_params).  Per model call
# griffin_spmm runs its 897 compacted leaves (per layer wq, wk, wv, wo and
# the 8 experts' w_gate, w_up and w_down, then the untied head); the 32
# routers (fp32 A against the weight upcast to fp32, 4096 x 8) go through
# dense_gemm's skinny route, or in Mode.AB through sparse_a with one
# metadata build each (tests/test_torch_moe.py counts them on the CPU).
# The paged path's tokens must equal moe_sparse_b's, which holds the
# oracle; the three paths serve one build.
MOE = "mixtral-8x7b"
MOE_SB = dict(sparsity=0.8, a_sparsity=None, mode="B",
              launches={"dense_gemm": 32, "griffin_spmm": 897,
                        "sparse_a": 0, "sparse_a_meta": 0,
                        "batch_eval": 0}, dual=0)
MOE_AB = dict(sparsity=0.8, a_sparsity=A_SPARSITY, mode="AB",
              launches={"dense_gemm": 0, "griffin_spmm": 897,
                        "sparse_a": 32, "sparse_a_meta": 32,
                        "batch_eval": 0}, dual=897)
MOE_PATHS = {
    "moe_sparse_b": dict(MOE_SB, arena=FIXED),
    "moe_mode_ab": dict(MOE_AB, arena=FIXED),
    "moe_paged": dict(MOE_SB, arena=PAGED, tokens_of="moe_sparse_b"),
}
# moe_long_window, on moe_sparse_b's weights: one prompt longer than the
# window straight through the model's prefill, then decode steps that
# wrap the rolling cache
MOE_LONG = dict(prompt=4200, cache_len=4224, steps=8)
# the moe paths serve mixtral-8x7b at full width cut to MOE_LAYERS of its
# MOE_DEPTH layers (the smoke's wall; PR 29's runs served all 32): every
# count of MOE_PATHS but the head's one K2 launch is per layer
MOE_DEPTH, MOE_LAYERS = 32, 8
MOE_HEAD = {"griffin_spmm": 1}
# moe_full_depth: the 32-layer streamed build (the memory the cut does not
# show) and one prefill through it, after the cut paths
MOE_FULL = dict(prompt=16, cache_len=32)


def at_depth(count: int, head: int, full: int = MOE_DEPTH,
             layers: int = MOE_LAYERS) -> int:
    """A per-model-call ``count`` of a ``full``-layer model, ``head`` of it
    outside the layers, at ``layers`` layers."""
    if count == 0:
        return 0
    if (count - head) % full:
        raise ValueError(f"{count} - {head} is not {full} layers' worth")
    return (count - head) // full * layers + head


def moe_at_depth(path: dict) -> dict:
    """A ``MOE_PATHS`` entry at ``MOE_LAYERS``: its launch and dual gates
    scaled, its config cut (``phase_serve``'s ``layers``)."""
    launches = {k: at_depth(v, MOE_HEAD.get(k, 0))
                for k, v in path["launches"].items()}
    return dict(path, launches=launches, layers=MOE_LAYERS,
                dual=at_depth(path["dual"], MOE_HEAD["griffin_spmm"]))
# the audio family: full-width whisper-large-v3 (32 encoder + 32 decoder
# layers, d 1280, 20 heads, d_ff 5120, 1500 frames a request, vocab 51866,
# untied head) on TRACE, every request carrying its fp32 frames.  Every
# GEMM leaf is compacted, so griffin_spmm alone runs: a prefill launches
# 513 (the encoder's 32 x 6, the decoder's 32 x 10, the head), 256 of them
# on fp32 A (the encoder's six and the cross wk/wv take the fp32 encoder
# stream against the bf16 weights), a decode step 257 (32 x 8 and the
# head), all bf16 (tests/test_torch_whisper.py counts them on the CPU).
# Launches and dual GEMMs are (prefill, decode step) pairs.  The paged
# path pages the decoder's k/v and keeps the cross K/V fixed; its tokens
# must equal whisper_sparse_b's, which holds the oracle.  So must Mode.AB's:
# every GEMM there is griffin_spmm's dual walk, which the kernel phase
# holds bit-equal to the plain walk.  The engines measure no activation
# sparsity on this short trace (measure_every 64): the compacted head's K
# of 1280 is 10 blocks, so 0.8^10 = 10.7 % of its 32-column units lose
# every block and their logits are exact zeros, above the 0.05 category
# threshold, and a measurement would flip Sparse.B to Mode.AB mid-run, as
# the reference's engine does.
WHISPER = "whisper-large-v3"
WHISPER_K2 = (513, 257)
WHISPER_SB = dict(sparsity=0.8, a_sparsity=None, mode="B",
                  launches={"dense_gemm": 0, "griffin_spmm": WHISPER_K2,
                            "sparse_a": 0, "sparse_a_meta": 0,
                            "batch_eval": 0}, dual=0, fp32_a=(256, 0))
WHISPER_AB = dict(WHISPER_SB, a_sparsity=A_SPARSITY, mode="AB",
                  dual=WHISPER_K2)
WHISPER_PATHS = {
    "whisper_sparse_b": dict(WHISPER_SB, arena=dict(FIXED, measure_every=64)),
    "whisper_mode_ab": dict(WHISPER_AB, arena=dict(FIXED, measure_every=64),
                            tokens_of="whisper_sparse_b"),
    "whisper_paged": dict(WHISPER_SB, arena=dict(PAGED, measure_every=64),
                          tokens_of="whisper_sparse_b"),
}
# the dense family's other configs on TRACE: full-width stablelm-1.6b (24
# layers, MHA, d_ff 5632, an untied 100352-token head) and minitron-8b (32
# layers, GQA 4:1, head_dim 128, d_ff 16384, an untied 256000-token head),
# and command-r-plus-104b at full width with its 64 layers cut to 2 (208 GB
# of bf16 fit no card).  Per model call griffin_spmm runs the 7 x L + 1
# compacted leaves (wq, wk, wv, wo, w_gate, w_up, w_down, then the head):
# 169, 225 and 15; dense_gemm never runs (the head is untied and compacted).
# stablelm's Mode.A runs the 169 through sparse_a with 4 x 24 + 1 = 97
# metadata builds (wq/wk/wv, wo, w_gate/w_up, w_down, the head).  The paged
# paths' tokens must equal their _sparse_b path's, which holds the oracle
# (tests/test_torch_dense_configs.py counts them on the CPU).
STABLELM, MINITRON = "stablelm-1.6b", "minitron-8b"
COMMAND_R, COMMAND_R_LAYERS = "command-r-plus-104b", 2


def dense_sb(k2: int) -> dict:
    return dict(sparsity=0.8, a_sparsity=None, mode="B",
                launches={"dense_gemm": 0, "griffin_spmm": k2,
                          "sparse_a": 0, "sparse_a_meta": 0,
                          "batch_eval": 0}, dual=0)


# no dense twin fits beside minitron-8b's or command-r's served weights:
# the plain route runs on the served weights, no fp32 gap is taken, and
# the build (api.init, then sparsify_params) is measured
SERVED_REF = dict(fp32_gap=False, served_ref=True)
# the served weights by (arch, sparsity, layers), with the pruned twin's
# logits by prompt: a later path of the family on the same seeded draw
# serves the same tensors (a second build would give the same bits)
WEIGHTS = {}
KEEP_BYTES = 16 << 30            # a larger tree is dropped before a build

DENSE_PATHS = {
    "stablelm_sparse_b": dict(dense_sb(169), arch=STABLELM, arena=FIXED),
    "stablelm_mode_a": dict(
        sparsity=0.0, a_sparsity=A_SPARSITY, mode="A",
        launches={"dense_gemm": 0, "griffin_spmm": 0, "sparse_a": 169,
                  "sparse_a_meta": 97, "batch_eval": 0}, dual=0,
        arch=STABLELM, arena=FIXED),
    "stablelm_paged": dict(dense_sb(169), arch=STABLELM, arena=PAGED,
                           tokens_of="stablelm_sparse_b"),
    "minitron_sparse_b": dict(dense_sb(225), arch=MINITRON, arena=FIXED,
                              **SERVED_REF, as_served="w_gate"),
    "minitron_paged": dict(dense_sb(225), arch=MINITRON, arena=PAGED,
                           **SERVED_REF, tokens_of="minitron_sparse_b"),
    "command_r_cut": dict(dense_sb(15), arch=COMMAND_R, arena=FIXED,
                          **SERVED_REF, layers=COMMAND_R_LAYERS),
}
# the K2 leaf shapes (K x N) of the three configs, each at M 4 and 32: the
# kernel phase times them beside torch.matmul and gates the route the
# Python mirror (griffin_spmm.kernel.route) predicts against the route the
# launch took
DENSE_SPMM = {
    STABLELM: {"wq/wk/wv/wo": (2048, 2048), "w_gate/w_up": (2048, 5632),
               "w_down": (5632, 2048), "head": (2048, 100352)},
    MINITRON: {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
               "w_gate/w_up": (4096, 16384), "w_down": (16384, 4096),
               "head": (4096, 256000)},
    COMMAND_R: {"wq/wo": (12288, 12288), "wk/wv": (12288, 1024),
                "w_gate/w_up": (12288, 33792), "w_down": (33792, 12288),
                "head": (12288, 256000)},
}
# K3's shapes on stablelm-1.6b's Mode.A path beyond llama's SPMM_SHAPES
# (its 2048 x 2048 attention is one of them): the FFN and the dense untied
# head, B row-major
STABLELM_K3 = {"w_gate/w_up": (2048, 5632), "w_down": (5632, 2048),
               "head": (2048, 100352)}
# the vlm family: full-width chameleon-34b (48 layers, d 8192, 64 heads /
# 8 KV at head_dim 128 with QK-norm, d_ff 22016, an untied 65536-token
# head; 34.3 B parameters, 68.6 GB of bf16) on TRACE.  Its compacted
# weights come from the streamed build (sparsity.init_sparse_params: the
# dense tree and its compaction do not fit the card together); Mode.A
# serves the dense tree (63.9 GiB of layers) drawn in the same order, after
# the compacted one is freed.  Per model call griffin_spmm runs the 7 x 48
# + 1 = 337 compacted leaves, or in Mode.A sparse_a the same 337 GEMMs with
# 4 x 48 + 1 = 193 metadata builds (wq/wk/wv, wo, w_gate/w_up, w_down, the
# head); dense_gemm never runs (tests/test_torch_chameleon.py counts them
# on the CPU).  No fp32 twin fits beside either tree: the plain route runs
# on the served weights, and the fp32 model is computed one layer at a
# time (fp32_prefill).  Each stacked leaf whose served grid depth differs
# from the kernel phase's one draw at its shape is checked, route-gated and
# timed as served (layer 0).
# The kernel route's prefill logit gap to the plain route is gated at 3 %
# on chameleon_mode_a, not MAX_PLAIN_GAP's 2 %: its dense 48-layer,
# 8192-wide bf16 model rounds further from fp32 than 2 % lets any two bf16
# routes stay apart.  On an H100 every bf16 route (the kernels, the plain
# route through torch.matmul, sparse_a's own plain version in fp32 rounded
# once a GEMM) is 2.05-2.17 % from the fp32 model and any two are 2.59-2.70
# % apart on the trace's first three prompts; the fp32 gate (FP32_GAP_RATIO,
# on the layer-streamed fp32 model) is what tells a wrong kernel there.
CHAMELEON_MODE_A_GAP = 3e-2
CHAMELEON = "chameleon-34b"
STREAMED_REF = dict(SERVED_REF, fp32_gap="streamed")
VLM_PATHS = {
    "chameleon_sparse_b": dict(dense_sb(337), arch=CHAMELEON, arena=FIXED,
                               **STREAMED_REF, as_served=True),
    "chameleon_mode_a": dict(
        sparsity=0.0, a_sparsity=A_SPARSITY, mode="A",
        launches={"dense_gemm": 0, "griffin_spmm": 0, "sparse_a": 337,
                  "sparse_a_meta": 193, "batch_eval": 0}, dual=0,
        arch=CHAMELEON, arena=FIXED, **STREAMED_REF,
        max_gap=CHAMELEON_MODE_A_GAP),
}
VLM_SPMM = {
    CHAMELEON: {"wq/wo": (8192, 8192), "wk/wv": (8192, 1024),
                "w_gate/w_up": (8192, 22016), "w_down": (22016, 8192),
                "head": (8192, 65536)},
}
# K3's shapes on chameleon-34b's Mode.A path: every GEMM leaf, B row-major
CHAMELEON_K3 = VLM_SPMM[CHAMELEON]
# every served config's K2 leaf shapes (check_routes holds each served
# compacted leaf to one of them), and the grid depth of the kernel phase's
# one draw at each (arch, K, N), which a served stack's depth is held
# against
K2_LEAVES = {**DENSE_SPMM, **VLM_SPMM}
DRAW_DEPTH = {}
K2_ROUTES = ("tc", "core")      # spmm_tc_kernel, spmm_core_kernel
# the reference benchmark's int8 gate (benchmarks/bench_serve.py
# PAGED_INT8_TOL), on its teacher-forced recipe: one 24-token prompt, 48
# decode steps, pages of 16 in a cache of 128
INT8_TOL = 0.02
INT8_GAP = dict(cache_len=128, steps=48, plen=24)
# xlstm-1.3b's GEMM shapes (K x N): its compacted leaves, which
# griffin_spmm runs (w_ff1's N and w_ff2's K ragged, w_ff2's A row 2730
# wide, so its K2 takes the CUDA-core route), and the plain (din x heads)
# gate leaves, which dense_gemm (Sparse.B) or sparse_a (Mode.AB) runs
XLSTM_SPMM = {"w_up": (2048, 8192), "w_down": (4096, 2048),
              "gates": (2048, 2048), "w_ff1": (2048, 2730),
              "w_ff2": (2730, 2048), "head": (2048, 50304)}
XLSTM_GATE = (4096, 4)
XLSTM_ROWS = (4, 32)             # decode slots, the largest prefill bucket
# recurrentgemma-9b's GEMM shapes (K x N): the compacted leaves griffin_spmm
# runs (the MLPs' w_gate/w_up and w_down, the attention's wq/wo and the rec
# blocks' w_gate, the MQA wk/wv and the 256000-column untied head) and the
# rec blocks' dense leaves, which dense_gemm (Sparse.B) or sparse_a
# (Mode.AB) runs: w_x and w_out in bf16, the gates w_rg and w_ig in fp32
HYBRID_SPMM = {"w_gate/w_up": (4096, 12288), "w_down": (12288, 4096),
               "wq/wo/rec w_gate": (4096, 4096), "wk/wv": (4096, 256),
               "head": (4096, 256000)}
HYBRID_DENSE = (4096, 4096)
HYBRID_DENSE_LEAVES = {"bfloat16": "w_x/w_out", "float32": "w_rg/w_ig"}
# mixtral-8x7b's GEMM shapes (K x N): the compacted leaves griffin_spmm runs
# (the experts' w_gate/w_up and w_down, wq/wo, the GQA wk/wv and the
# 32000-column untied head) and the router, fp32 A against its weight
# upcast to fp32, which dense_gemm's skinny route (Sparse.B) or sparse_a
# (Mode.AB) runs
MOE_SPMM = {"w_gate/w_up": (4096, 14336), "w_down": (14336, 4096),
            "wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
            "head": (4096, 32000)}
MOE_ROUTER = (4096, 8)
# whisper-large-v3's GEMM shapes (K x N): every leaf compacted, at M 4 and
# 32 in bf16 (decode slots, the largest prefill bucket) and, on the
# encoder's three shapes, fp32 A at the encoder's M of 1500 frames; the
# head's N 51866 = 405 x 128 + 26 ends in a partial tile
WHISPER_SPMM = {"wq/wk/wv/wo": (1280, 1280), "w_up": (1280, 5120),
                "w_down": (5120, 1280), "head": (1280, 51866)}
WHISPER_ENC_ROWS = 1500
MAX_ADMIT_RISE = 3 << 30
# the metadata kernel alone: a decode step's A at llama's K 2048 and at
# xlstm's gate K 4096, a 32-row bucket at K 4096 and one full 128-row
# prefill tile at w_down's K 8192
META_SHAPES = ((4, 2048), (4, 4096), (32, 4096), (128, 8192))
LONG_PROMPTS = (2048, 4096)
MAX_PREFILL_RISE = 3 << 30
# per (layer, position) K/V row of a long prefill, kernel route against
# the plain route: bf16 rounding drift through 16 layers stays well under
# this, a wrong 32-row pass of griffin_spmm does not
MAX_ROW_GAP = 5e-2
# the kernel route's relative L2 gap to the model widened to fp32, at most
# this many times the plain route's: both routes round the same model to
# bf16, so a kernel that is right is about as far from fp32 as the plain
# version (0.97-1.04 x on every path with the fp32 twin on an H100), while
# the 2 % gap between the two routes grows with depth and width
FP32_GAP_RATIO = 1.25
# the kernel route's relative L2 gap to the plain route at the prefill
MAX_PLAIN_GAP = 2e-2
# the router phase (launch.serve.route): the reference benchmark's
# overload trace (benchmarks/bench_serve.py overload_trace: bursty,
# heavy-tailed, 48 requests, seed 11) and the smaller trace of the
# reference's replica-kill test, with the reference's cache_len of 137
OVERLOAD = dict(requests=48, trace_seed=11, prompt_lens=(8, 16, 24),
                gen_lens=(4, 8, 12, 16), arrival_process="bursty", rate=1.0,
                burst_rate=8.0, burst_switch=0.2, length_dist="heavy",
                max_gen=24)
OVERLOAD_SLO = dict(priorities=(0, 1), deadline_slack=4.0, ttft_deadline=6)
SMALL = dict(trace_seed=11, prompt_lens=(6, 10), gen_lens=(4, 6))
ROUTER_ARENA = dict(num_slots=4, cache_len=137, decode_chunk=8)
# the virtual-tick rows of benchmarks/out/BENCH_serve.json "router"; every
# routing decision depends on the trace and the tick only, so full width
# gives them exactly (tests/test_torch_router.py holds them on the CPU)
ROUTER_ROWS = {
    "router_bounded": {
        "requests": 48, "completed": 33, "shed": 15, "max_queue_depth": 6,
        "ticks": 21, "ttft_p50": 1, "ttft_p99": 8, "itl_p50": 1,
        "itl_p99": 1, "slo_attainment": 0.6667,
        "ladder_history": [[9, 1], [11, 2], [13, 3], [17, 2], [19, 1]]},
    "router_unbounded": {
        "requests": 48, "completed": 48, "shed": 0, "max_queue_depth": 29,
        "ticks": 33, "ttft_p50": 6, "ttft_p99": 19, "itl_p50": 1,
        "itl_p99": 1, "slo_attainment": None, "ladder_history": []},
}
# what the reference's RouterEngine gives on the small cells' traces
# (tests/test_torch_router.py holds them against it on the CPU): stats,
# ticks, health log, (attribution, winning replica) per rid, prefills per
# engine built and the hedge losers' cancels with what each found: rid 3's
# copy on replica 2 wins and its primary on replica 0 is cancelled
# mid-decode, rid 4's primary on replica 1 wins and its copy on replica 0
# is cancelled mid-decode
ROUTER_RECORDS = {
    "router_kill": dict(
        stats={"submitted": 6, "dispatches": 7, "completed": 6, "shed": 0,
               "retried": 1, "hedged": 0},
        ticks=7,
        health_log=[{"tick": 2, "event": "kill", "replica": 1,
                     "state": "decode", "drained": [3], "rejoin_at": 5},
                    {"tick": 5, "event": "rejoin", "replica": 1}],
        served={0: ("normal", 0), 1: ("normal", 1), 2: ("normal", 0),
                3: ("retried", 1), 4: ("normal", 0), 5: ("normal", 0)},
        cancels=[]),
    "router_hedge": dict(
        stats={"submitted": 5, "dispatches": 7, "completed": 5, "shed": 0,
               "retried": 0, "hedged": 2},
        ticks=4, health_log=[], prefills=[3, 2, 2],
        served={0: ("normal", 0), 1: ("normal", 1), 2: ("normal", 2),
                3: ("hedged", 2), 4: ("hedged", 1)},
        cancels=[(3, "running"), (4, "running")]),
}
# per router cell: the kernels' launches per model call (SB, MODE_A,
# MODE_AB above), the engines' and router's config fields, the trace, and
# the rids replayed through the oracle (None: every completed request)
ROUTER_CELLS = {
    "router_bounded": dict(
        SB, fields=dict(ROUTER_ARENA, replicas=2, queue_bound=6,
                        shed_policy="degrade"),
        trace=dict(OVERLOAD, **OVERLOAD_SLO), parity=None),
    "router_unbounded": dict(
        SB, fields=dict(ROUTER_ARENA, replicas=2, shed_policy="none"),
        trace=OVERLOAD, parity=range(0, 48, 3)),
    "router_kill": dict(
        MODE_AB, fields=dict(num_slots=2, cache_len=24, decode_chunk=2,
                             replicas=2, shed_policy="none",
                             inject="replica:1@2:decode:3"),
        trace=dict(SMALL, requests=6), parity=None),
    "router_hedge": dict(
        MODE_A, fields=dict(num_slots=3, cache_len=24, decode_chunk=2,
                            replicas=3, hedge_after=1, shed_policy="none"),
        trace=dict(SMALL, requests=5), parity=None),
}

# the train phase: launch.train's CLI at full width (llama3.2-1b, the CLI's
# defaults batch 8, seq 128, lr 3e-3, the prune schedule at 0.5), a
# checkpoint at step 20 and a restart from it; the flash backward at the
# full-width head shapes (B, S, window) against materialised attention
TRAIN = dict(arch="llama3.2-1b", steps=30, batch=8, seq=128, prune=0.5,
             ckpt_every=20)
TRAIN_FLASH = (("causal_512", 512, None), ("causal_2048", 2048, None),
               ("window_2048", 2048, 1000), ("ragged_2000", 2000, None))
TRAIN_FLASH_TOL = 1e-4            # relative L2 of dq, dk, dv in fp32
# bf16 step against the same step on the widened fp32 params
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL = 1e-2, 5e-2
# the mean loss of the last five steps must sit below the first five's by
# this fraction: the CPU run of the CLI's config, reduced, drops it by
# 39.2 % (tests/test_torch_train.py::test_cli_descends_and_prunes holds
# 30 %)
TRAIN_DESCENT = 0.30
TRAIN_PREFILL = dict(rows=4, prompt=32, seed=11)

# the fault phase: engine-level kills through launch.serve
# (fault.inject), each on one serve path's engine and trace and held
# against that path's unfaulted run: the kill fires at clock ``at``, one
# recovery, and the recovery replays ``replayed`` model calls (what the
# lost tick had launched).  Both depend on the trace and the scheduler
# only (tests/test_torch_fault.py holds them on the CPU).  The disk cell
# serves 4 of the 8 requests with tick-start snapshots written through
# checkpoint.save, the weights in each.
FAULT_CELLS = {
    "fault_kill_admission": dict(path="sparse_b", phase="admission", at=5,
                                 replayed=0),
    "fault_kill_prefill": dict(path="sparse_b", phase="prefill", at=5,
                               replayed=1),
    "fault_kill_decode": dict(path="sparse_b", phase="decode", at=5,
                              replayed=3),
    "fault_kill_stepwise": dict(path="sparse_b_stepwise", phase="decode",
                                at=5, replayed=2),
    "fault_kill_paged_int8": dict(path="sparse_b_paged_int8",
                                  phase="decode", at=5, replayed=1),
    "fault_kill_mode_ab": dict(path="mode_ab", phase="decode", at=5,
                               replayed=3),
    "fault_snapshot_dir": dict(path="sparse_b_paged", phase="decode", at=2,
                               replayed=1, requests=4,
                               snapshot_dir="chiprun_out/fault_snapshots"),
}

# the autotune phase: launch.autotune's dense pipeline at full width (the
# reference's tuning trace: 6 requests, prompts 6/10, generations 4/8/16,
# 4 slots, decode_chunk 8), 16 candidates, 3 shortlisted; every engine's
# launches per model call are SB's.  The kernel phase times griffin_spmm
# at each block size of the candidate grid.
AUTOTUNE = dict(sparsity=0.8, budget=16, shortlist_k=3, requests=6,
                repeats=3)
AUTOTUNE_PLAN = "chiprun_out/kernel_plan_torch.json"
GRANULARITIES = (16, 32, 64, 128, 512)
# each autotune engine's logits witness: a prefill of 8 prompts of 12
# seeded token ids, then 8 decode steps fed seeded ids, through the kernels
WITNESS = dict(batch=8, prompt=12, steps=8, seed=5)

# the cycle_model phase: the paper's Figure 8 sweep as
# benchmarks/fig8_overall.py runs it (its design list, the four modes,
# CoreConfig(), seed 4, no cache); (design, mode) -> (speedup, tops_w,
# tops_mm2) of the JAX package's own sweep (tests/test_torch_core.py holds
# them against it on the CPU)
FIG8_MODES = ("dense", "B", "A", "AB")
FIG8_SEED = 4
FIG8_REL_TOL = 1e-12
FIG8_ROWS = {
    ('Baseline', 'dense'):
        (1.0, 10.821664464993397, 7.532873563218391),
    ('Sparse.B*', 'dense'):
        (1.0, 7.983627326771271, 6.608924629861496),
    ('TCL.B', 'dense'):
        (1.0, 8.708130919604988, 6.411480557373047),
    ('Sparse.A*', 'dense'):
        (1.0, 6.80521888514698, 5.987078668108866),
    ('Sparse.AB*', 'dense'):
        (1.0, 5.64893834161734, 5.479979878198885),
    ('Griffin', 'dense'):
        (1.0, 5.613081110118347, 5.445562982934755),
    ('TDash.AB', 'dense'):
        (1.0, 5.498754188504167, 5.074293303072575),
    ('SparTen.AB', 'dense'):
        (1.0, 1.653279515640767, 1.4384547848990343),
    ('Baseline', 'B'):
        (1.0, 10.821664464993397, 7.532873563218391),
    ('Sparse.B*', 'B'):
        (2.597841667518951, 20.740199727429342, 17.168939780946456),
    ('TCL.B', 'B'):
        (2.24474132786699, 19.547501363713693, 14.392115379950962),
    ('Sparse.A*', 'B'):
        (1.0, 6.80521888514698, 5.987078668108866),
    ('Sparse.AB*', 'B'):
        (2.2575057978077484, 12.752511057659634, 12.371086346903782),
    ('Griffin', 'B'):
        (2.6588760756683194, 14.924487074479444, 14.479077133870227),
    ('TDash.AB', 'B'):
        (1.8564991725998217, 10.208432601287791, 9.42042131868305),
    ('SparTen.AB', 'B'):
        (1.644043988982991, 2.7180642497979135, 2.3648829425370783),
    ('Baseline', 'A'):
        (1.0, 10.821664464993397, 7.532873563218391),
    ('Sparse.B*', 'A'):
        (1.0, 7.983627326771271, 6.608924629861496),
    ('TCL.B', 'A'):
        (1.0, 8.708130919604988, 6.411480557373047),
    ('Sparse.A*', 'A'):
        (1.3634254908929377, 9.27840889911541, 8.162935672080966),
    ('Sparse.AB*', 'A'):
        (1.2437079656630432, 7.025629613008867, 6.815494626189146),
    ('Griffin', 'A'):
        (1.446998722396289, 8.122121195047992, 7.879722679035115),
    ('TDash.AB', 'A'):
        (1.2925118230297525, 7.107204800576009, 6.558584087741999),
    ('SparTen.AB', 'A'):
        (1.2526329531918423, 2.0709524021286723, 1.8018558652410135),
    ('Baseline', 'AB'):
        (1.0, 10.821664464993397, 7.532873563218391),
    ('Sparse.B*', 'AB'):
        (2.6718184661513553, 21.330802918538062, 17.657846867466457),
    ('TCL.B', 'AB'):
        (2.239950112156374, 19.50577883004158, 14.361396593576167),
    ('Sparse.A*', 'AB'):
        (1.3634254908929377, 9.27840889911541, 8.162935672080966),
    ('Sparse.AB*', 'AB'):
        (2.4687711293187684, 13.945935889086732, 13.528816112545188),
    ('Griffin', 'AB'):
        (2.4687711293187684, 13.857412591184717, 13.443848675156316),
    ('TDash.AB', 'AB'):
        (2.014089701496792, 11.074984182128592, 10.220081884092613),
    ('SparTen.AB', 'AB'):
        (4.6730856363236315, 7.725916757368958, 6.722022393812676),
}
PAPER_GRIFFIN_VS_SPARTEN = {"dense": 1.2, "B": 3.0, "A": 3.1, "AB": 1.4}
# sparsity tax, power and area (Section VI-F)
PAPER_TAX = {"Griffin": (0.29, 0.24), "SparTen.AB": (0.42, 0.80)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, iters: int = 20) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after a
    64 MB write that evicts the 50 MB L2 (the serving path reads each
    weight once per step, cold).  A device-side sleep is queued first so
    the host enqueues every launch before the device reaches it: the events
    then bracket device work only, not the wrapper's host time.  The sleep
    lasts twice the host time the launches took in the warm-up (three
    calls, one for a call of 50 ms or more), and the run is taken again
    under the longest sleep (~0.1 s) where the device woke before the host
    had queued the last launch."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    host = []
    while len(host) < 3 and sum(host) < 0.05:
        t0 = time.perf_counter()
        flush.zero_()
        fn()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = int(min(MAX_SLEEP_CYCLES, SLEEP_CYCLES_PER_S * (
        2 * iters * sorted(host)[len(host) // 2] + 1e-3)))
    while True:
        torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        times = []
        for _ in range(iters):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            times.append((start, end))
        queued = not slept.query()      # still asleep: all launches queued
        torch.cuda.synchronize()
        if queued or cycles >= MAX_SLEEP_CYCLES:
            break
        cycles = MAX_SLEEP_CYCLES
    ms = sorted(s.elapsed_time(e) for s, e in times)
    return ms[len(ms) // 2]


def device_ms(torch, fn, match: str, iters: int = 20):
    """Mean device duration (torch.profiler) of the kernels whose name
    holds ``match`` over ``iters`` back-to-back calls of ``fn`` (warm L2):
    the kernel's own time, without the events' ~4-5 us floor.  None where
    the profiler recorded no kernel at all in three tries (it happens,
    rarely): a measurement not taken, never a failed check."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        _, by_name, _ = profiled(torch, lambda: [fn() for _ in
                                                 range(iters)])
        if by_name:
            break
    else:
        print(f"[profile] no device kernel recorded for {match!r}: device "
              "duration not measured")
        return None
    mine = [(t, n) for k, (t, n) in by_name.items() if match in k]
    if not mine:
        fail(f"no device kernel named like {match!r} in {sorted(by_name)}")
    return sum(t for t, _ in mine) / sum(n for _, n in mine)


def launch_floor(torch) -> dict:
    """The floor of both ways of timing: a one-element fill, a kernel that
    does nothing but launch, by ``timed_ms`` and by its device duration."""
    tiny = torch.zeros(1, device="cuda")
    return {"ms": timed_ms(torch, tiny.zero_),
            "device_ms": device_ms(torch, tiny.zero_, "")}


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within_tol(torch, out, ref, dtype: str):
    """(max |err|, ok) under the stated tolerance."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    scale = float(r.abs().max())
    allowed = 1e-5 * scale
    if dtype == "bfloat16":
        mag = torch.maximum(o.abs(), r.abs()).clamp(min=1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        ok = bool((err <= ulp + allowed).all())
    else:
        ok = bool((err <= allowed).all())
    return float(err.max()), ok


def phase_build(build):
    t0 = time.perf_counter()
    logs = build.build_all(verbose=True)
    dt = time.perf_counter() - t0
    print(f"[build] {len(logs)} kernels built from src/repro_torch/csrc "
          f"for sm_90a in {dt:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    return dt


def phase_kernels(torch):
    from repro_torch.kernels import (dense_matmul, griffin_matmul,
                                     preprocess_weights)
    from repro_torch.kernels.dense_gemm.ref import dense_matmul_ref
    from repro_torch.kernels.griffin_spmm.kernel import split_plan
    from repro_torch.kernels.griffin_spmm.ref import griffin_spmm_ref
    from repro_torch.sparsity import block_prune

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, summary = [], {}

    # K1: the tied unembedding, A (M, 2048) x embed.T (2048, 128256)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        embed = torch.randn(128256, 2048, generator=gen, device=dev).to(dt)
        for m in (4, 1):
            a = torch.randn(m, 2048, generator=gen, device=dev).to(dt)
            out = dense_matmul(a, embed.T)
            ref = dense_matmul_ref(a, embed.T)
            torch.cuda.synchronize()
            err, ok = within_tol(torch, out, ref, dtype)
            row = {"kernel": "dense_gemm", "dtype": dtype, "m": m, "k": 2048,
                   "n": 128256, "max_abs_err": err, "ok": ok}
            if not ok:
                fail(f"dense_gemm disagrees with its plain version: {row}")
            if m == 4:
                esz = a.element_size()
                nbytes = (a.numel() + embed.numel() + m * 128256) * esz
                b_ms, b_by = bound(nbytes, 2.0 * m * 2048 * 128256, dtype)
                row.update(
                    ms=timed_ms(torch, lambda: dense_matmul(a, embed.T)),
                    plain_ms=timed_ms(torch,
                                      lambda: dense_matmul_ref(a, embed.T)),
                    library_ms=timed_ms(torch, lambda: torch.matmul(a,
                                                                    embed.T)),
                    bound_ms=b_ms, bound_by=b_by)
                if dtype == "bfloat16":
                    summary["dense_gemm"] = row
            rows.append(row)
            print(f"[kernels] {json.dumps(row)}")
        del embed

    # K2: every compacted GEMM shape of llama3.2-1b at 0.8 sparsity
    for (k, n) in SPMM_SHAPES:
        w32 = block_prune(torch.randn(k, n, generator=gen, device=dev), 0.8)
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            for balance in (True, False):
                gw = preprocess_weights(w32.to(dt), balance=balance)
                live = int(gw.cnt.sum())
                plan = None
                if dtype == "bfloat16":
                    plan = split_plan(k, n, gw.kidx.shape[0], gw.block_k,
                                      gw.block_n)
                if plan and balance:
                    blocks = gw.kidx.shape[0] * gw.block_n // plan.cols * \
                        plan.splits
                    print(f"[kernels] griffin_spmm plan {k}x{n} "
                          f"({gw.kidx.shape[0]} tiles, max_cnt "
                          f"{gw.kidx.shape[1]}): cluster split S="
                          f"{plan.splits}, {plan.cols}-column slices, "
                          f"{plan.chunk_rows}-row chunks, {blocks} blocks")
                    spmm_batch_invariance(torch, gen, gw)
                # bf16 also at long_prefill's M, one pass per 32 rows
                long = LONG_PROMPTS if dtype == "bfloat16" else ()
                for m in M_ROWS + long:
                    a = torch.randn(m, k, generator=gen, device=dev).to(dt)
                    a[:, :256] = 0      # two all-zero K blocks for dual
                    for dual in (False, True):
                        out = griffin_matmul(a, gw, dual=dual)
                        ref = griffin_spmm_ref(a, gw)
                        torch.cuda.synchronize()
                        err, ok = within_tol(torch, out, ref, dtype)
                        if dual and not torch.equal(out, plain_bits):
                            fail(f"griffin_spmm {k}x{n} {dtype} M {m}: dual "
                                 "is not bit-equal to the plain walk")
                        plain_bits = out
                        row = {"kernel": "griffin_spmm", "dtype": dtype,
                               "m": m, "k": k, "n": n, "balance": balance,
                               "dual": dual, "live_blocks": live,
                               "max_cnt": gw.kidx.shape[1],
                               "plan": plan and list(plan),
                               "max_abs_err": err, "ok": ok}
                        if not ok:
                            fail("griffin_spmm disagrees with its plain "
                                 f"version: {row}")
                        if balance and (m in (4, 32) and (
                                dtype == "bfloat16" or not dual)
                                or m == LONG_PROMPTS[-1] and not dual):
                            timed_spmm(torch, a, gw, dual, row)
                            if dtype == "bfloat16" and m == 4 and not dual \
                                    and (k, n) == (2048, 8192):
                                summary["griffin_spmm"] = row
                            print(f"[kernels] {json.dumps(row)}")
                        rows.append(row)
    rows += spmm_granularities(torch, gen, summary)
    rows += kernel_xlstm(torch, gen, summary)
    rows += kernel_hybrid(torch, gen, summary)
    rows += kernel_moe(torch, gen, summary)
    rows += kernel_whisper(torch, gen, summary)
    rows += kernel_dense_configs(torch, gen)
    rows += kernel_dense_configs(torch, gen, VLM_SPMM,
                                 ((CHAMELEON, CHAMELEON_K3),))
    rows += kernel_sparse_a(torch, gen, summary)
    rows += kernel_meta(torch, gen, summary)
    rows += kernel_shards(torch, gen)
    print(f"[kernels] {len(rows)} checks against the plain versions passed")
    return rows, summary


def spmm_granularities(torch, gen, summary):
    """griffin_spmm on w_up (2048 x 8192, pruned 0.8 at 128 / unit 32)
    compacted at every block size of the autotune candidate grid
    (``GRANULARITIES``, unit 8): held against its plain version, and bit
    for bit against the default 128 x 128 / unit 32 compaction's output
    (bf16 at M 4 and 32, dual and not, with two all-zero K blocks in A; fp32,
    the CUDA-core route, at M 4): every output's summation order is a
    function of (K, N) alone.  Timed as ``timed_spmm`` times (bf16, M 4),
    with its grid steps (N tiles x max_cnt).  The per-step cost
    ``tuning.search.STEP_OVERHEAD_HW`` is fitted from the 16 and 128 rows:
    delta ms over delta grid steps."""
    from repro_torch.kernels import griffin_matmul, preprocess_weights
    from repro_torch.kernels.griffin_spmm.kernel import split_plan
    from repro_torch.kernels.griffin_spmm.ref import griffin_spmm_ref
    from repro_torch.sparsity import block_prune

    k, n = 2048, 8192
    w32 = block_prune(torch.randn(k, n, generator=gen, device="cuda"), 0.8)
    w = w32.to(torch.bfloat16)
    inputs = []
    for m, dt in ((4, torch.bfloat16), (32, torch.bfloat16),
                  (4, torch.float32)):
        x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
        x[:, 512:768] = 0               # two all-zero 128-row K blocks
        for dual in ((False, True) if dt == torch.bfloat16 else (False,)):
            inputs.append((x, dual))
    default = {torch.bfloat16: preprocess_weights(w),   # 128 x 128 / u32
               torch.float32: preprocess_weights(w32)}
    base = [griffin_matmul(x, default[x.dtype], dual=d) for x, d in inputs]
    a = inputs[0][0]
    rows = []
    for bk in GRANULARITIES:
        gws = {dt: preprocess_weights(src, block_k=bk, block_n=bk, unit=8)
               for dt, src in ((torch.bfloat16, w), (torch.float32, w32))}
        gw = gws[torch.bfloat16]
        out = griffin_matmul(a, gw)
        ref = griffin_spmm_ref(a, gw)
        torch.cuda.synchronize()
        err, ok = within_tol(torch, out, ref, "bfloat16")
        nt, mc = gw.kidx.shape
        plan = split_plan(k, n, nt, bk, bk)
        differ = [int((griffin_matmul(x, gws[x.dtype], dual=d) != b).sum())
                  for (x, d), b in zip(inputs, base)]
        row = {"kernel": "griffin_spmm", "dtype": "bfloat16", "m": 4,
               "k": k, "n": n, "block": bk, "unit": 8,
               "grid_steps": nt * mc, "plan": plan and list(plan),
               "max_abs_err": err, "ok": ok,
               "bits_differ_from_default": differ}
        if not ok:
            fail(f"griffin_spmm disagrees with its plain version: {row}")
        if any(differ):
            fail("griffin_spmm at a block size of the candidate grid is not "
                 f"bit-equal to the default compaction (outputs differing "
                 "at bf16 M 4, M 4 dual, M 32, M 32 dual, fp32 M 4): "
                 f"{row}")
        timed_spmm(torch, a, gw, False, row)
        rows.append(row)
        print(f"[kernels] granularity {json.dumps(row)}")
    print(f"[kernels] griffin_spmm at blocks {list(GRANULARITIES)} (unit 8) "
          "bit-equal to the 128 x 128 / unit 32 compaction: bf16 M 4 and "
          "32, dual and not, and fp32 M 4")
    r16, r128 = rows[0], rows[GRANULARITIES.index(128)]
    fit = (r16["ms"] - r128["ms"]) * 1e-3 / (r16["grid_steps"]
                                             - r128["grid_steps"])
    summary["griffin_spmm_granularity"] = {
        "rows": rows, "step_overhead_s": fit,
        "step_overhead_fallback_s": r128["ms"] * 1e-3 / r128["grid_steps"]}
    print(f"[kernels] griffin_spmm per grid step on w_up, M 4: "
          f"({r16['ms']:.5f} - {r128['ms']:.5f}) ms / ({r16['grid_steps']} - "
          f"{r128['grid_steps']}) steps = {fit:.4g} s (128 x 128 alone: "
          f"{summary['griffin_spmm_granularity']['step_overhead_fallback_s']:.4g}"
          f" s a step)")
    return rows


def kernel_xlstm(torch, gen, summary):
    """griffin_spmm at xlstm-1.3b's compacted shapes (``XLSTM_SPMM``, bf16,
    pruned 0.8 at 128 x 128 / unit 32, balanced) and dense_gemm at its
    (4096 x 4) gate leaves, at M 4 and 32, each against its plain version
    and timed beside its bound and torch.matmul; griffin_spmm also dual at
    w_ff2 and held batch invariant (rows 0, 0:4 of 32) at every shape.
    w_down takes fp32 A against its bf16 weight (the mLSTM block's input,
    fp32 as in the reference): griffin_spmm's mixed entry, dual and not,
    is checked, held batch invariant and timed there too.  dense_gemm
    runs its skinny route at the gate shape in bf16, fp32 and fp32 A x
    bf16 weight, each checked, held batch invariant and timed.  sparse_a
    meets the gate shape in :func:`kernel_sparse_a`."""
    from repro_torch.kernels import (dense_matmul, griffin_matmul,
                                     preprocess_weights)
    from repro_torch.kernels.dense_gemm.kernel import route as k1_route
    from repro_torch.kernels.dense_gemm.kernel import skinny_slices
    from repro_torch.kernels.dense_gemm.ref import dense_matmul_ref
    from repro_torch.kernels.griffin_spmm.kernel import split_plan
    from repro_torch.kernels.griffin_spmm.ref import griffin_spmm_ref
    from repro_torch.sparsity import block_prune

    dev, dt = torch.device("cuda"), torch.bfloat16
    rows = []
    for leaf, (k, n) in XLSTM_SPMM.items():
        w = block_prune(torch.randn(k, n, generator=gen, device=dev), 0.8)
        gw = preprocess_weights(w.to(dt))
        del w
        plan = split_plan(k, n, gw.kidx.shape[0], gw.block_k, gw.block_n)
        route = "tensor-core" if k % 8 == 0 else "cuda-core"
        print(f"[kernels] xlstm griffin_spmm {leaf} {k}x{n} (padded "
              f"{gw.k}x{gw.b_comp.shape[1]}, max_cnt {gw.kidx.shape[1]}): "
              f"{route} route, plan {plan and list(plan)}")
        spmm_batch_invariance(torch, gen, gw, k)
        labels = ("bfloat16", "mixed") if leaf == "w_down" else ("bfloat16",)
        if leaf == "w_down":
            spmm_batch_invariance(torch, gen, gw, k, torch.float32)
        for label in labels:
            da = getattr(torch, PAIRS[label][0])
            for m in XLSTM_ROWS:
                a = torch.randn(m, k, generator=gen, device=dev).to(da)
                a[:, :256] = 0          # two all-zero K blocks for dual
                duals = (False, True) if leaf == "w_ff2" or \
                    label == "mixed" else (False,)
                for dual in duals:
                    out = griffin_matmul(a, gw, dual=dual)
                    ref = griffin_spmm_ref(a, gw)
                    torch.cuda.synchronize()
                    err, ok = within_tol(torch, out, ref, label)
                    row = {"kernel": "griffin_spmm", "model": XLSTM,
                           "leaf": leaf, "dtype": label, "m": m, "k": k,
                           "n": n, "route": "cuda-core"
                           if label == "mixed" else route, "dual": dual,
                           "max_cnt": gw.kidx.shape[1],
                           "plan": None if label == "mixed"
                           else plan and list(plan), "max_abs_err": err,
                           "ok": ok}
                    if not ok or out.dtype != da:
                        fail("griffin_spmm disagrees with its plain "
                             f"version: {row}, output {out.dtype}")
                    if dual and not torch.equal(out, griffin_matmul(a, gw)):
                        fail(f"griffin_spmm {leaf} {label}: dual is not "
                             "bit-equal to the plain walk")
                    timed_spmm(torch, a, gw, dual, row)
                    rows.append(row)
                    print(f"[kernels] {json.dumps(row)}")
        del gw
    k, n = XLSTM_GATE
    for label, (ta, tw) in PAIRS.items():
        da, dw = getattr(torch, ta), getattr(torch, tw)
        w = torch.randn(k, n, generator=gen, device=dev).to(dw)
        w_lib = w.to(da)                # torch.matmul takes one dtype
        for m in XLSTM_ROWS:
            a = torch.randn(m, k, generator=gen, device=dev).to(da)
            out = dense_matmul(a, w)
            ref = dense_matmul_ref(a, w)
            torch.cuda.synchronize()
            err, ok = within_tol(torch, out, ref, label)
            row = {"kernel": "dense_gemm", "model": XLSTM, "leaf": "wi/wf",
                   "dtype": label, "m": m, "k": k, "n": n,
                   "route": k1_route(n), "slices": skinny_slices(k),
                   "max_abs_err": err, "ok": ok}
            if not ok or out.dtype != da:
                fail(f"dense_gemm disagrees with its plain version: {row}, "
                     f"output {out.dtype}")
            for rows_ in (1, 4):
                if not torch.equal(dense_matmul(a[:rows_].contiguous(), w),
                                   out[:rows_]):
                    fail(f"dense_gemm is not batch invariant at {k}x{n} "
                         f"{label}: rows 0:{rows_} differ from the same "
                         f"rows of an {m}-row call")
            b_ms, b_by = bound((a.numel() + m * n) * a.element_size()
                               + w.numel() * w.element_size(),
                               2.0 * m * k * n, label)
            row.update(ms=timed_ms(torch, lambda: dense_matmul(a, w)),
                       plain_ms=timed_ms(torch,
                                         lambda: dense_matmul_ref(a, w)),
                       library_ms=timed_ms(torch,
                                           lambda: torch.matmul(a, w_lib)),
                       bound_ms=b_ms, bound_by=b_by)
            if label == "bfloat16" and m == XLSTM_ROWS[0]:
                summary["dense_gemm_skinny"] = row
            rows.append(row)
            print(f"[kernels] {json.dumps(row)}")
    print(f"[kernels] xlstm-1.3b: griffin_spmm at {len(XLSTM_SPMM)} shapes "
          f"(w_down with fp32 A too) and dense_gemm's skinny route at "
          f"{k}x{n} (bf16, fp32, fp32 x bf16) agree with their plain "
          "versions and are batch invariant")
    return rows


def kernel_hybrid(torch, gen, summary):
    """The kernels at recurrentgemma-9b's shapes, M 4 and 32 (decode slots,
    the largest prefill bucket): griffin_spmm at its five compacted shapes
    (``HYBRID_SPMM``, bf16, pruned 0.8 at 128 x 128 / unit 32, balanced),
    dual and not, against its plain version, held batch invariant and
    timed beside its bound and torch.matmul; dense_gemm's wide route and
    sparse_a (every block live, with its metadata, bit-equal to the plain
    metadata) at the rec blocks' dense 4096 x 4096 leaves in bf16 (w_x,
    w_out) and fp32 (the gates w_rg and w_ig, fp32 A against the weight
    widened to fp32, as the model runs them), each checked, held batch
    invariant and timed the same way."""
    from repro_torch.kernels import (compact_activations, dense_matmul,
                                     griffin_matmul, preprocess_weights,
                                     sparse_a_matmul)
    from repro_torch.kernels.dense_gemm.kernel import route as k1_route
    from repro_torch.kernels.dense_gemm.ref import dense_matmul_ref
    from repro_torch.kernels.griffin_spmm.kernel import split_plan
    from repro_torch.kernels.griffin_spmm.ref import griffin_spmm_ref
    from repro_torch.kernels.sparse_a.kernel import ROUTE_NAMES, route
    from repro_torch.kernels.sparse_a.ref import (compact_activations_ref,
                                                  sparse_a_ref)
    from repro_torch.sparsity import block_prune

    dev, dt = torch.device("cuda"), torch.bfloat16
    rows = []
    for leaf, (k, n) in HYBRID_SPMM.items():
        w = block_prune(torch.randn(k, n, generator=gen, device=dev), 0.8)
        gw = preprocess_weights(w.to(dt))
        del w
        plan = split_plan(k, n, gw.kidx.shape[0], gw.block_k, gw.block_n)
        print(f"[kernels] hybrid griffin_spmm {leaf} {k}x{n} (max_cnt "
              f"{gw.kidx.shape[1]}): plan {plan and list(plan)}")
        spmm_batch_invariance(torch, gen, gw)
        for m in XLSTM_ROWS:
            a = torch.randn(m, k, generator=gen, device=dev).to(dt)
            a[:, :256] = 0              # two all-zero K blocks for dual
            plain_bits = None
            for dual in (False, True):
                out = griffin_matmul(a, gw, dual=dual)
                ref = griffin_spmm_ref(a, gw)
                torch.cuda.synchronize()
                err, ok = within_tol(torch, out, ref, "bfloat16")
                row = {"kernel": "griffin_spmm", "model": HYBRID,
                       "leaf": leaf, "dtype": "bfloat16", "m": m, "k": k,
                       "n": n, "dual": dual, "max_cnt": gw.kidx.shape[1],
                       "plan": plan and list(plan), "max_abs_err": err,
                       "ok": ok}
                if not dual:
                    row.update(k2_route(torch, a, gw, f"{HYBRID} {leaf}"))
                if not ok:
                    fail(f"griffin_spmm disagrees with its plain version: "
                         f"{row}")
                if dual and not torch.equal(out, plain_bits):
                    fail(f"griffin_spmm {leaf}: dual is not bit-equal to "
                         "the plain walk")
                plain_bits = out
                timed_spmm(torch, a, gw, dual, row)
                rows.append(row)
                print(f"[kernels] {json.dumps(row)}")
        del gw
        torch.cuda.empty_cache()
    k, n = HYBRID_DENSE
    for label, leaf in HYBRID_DENSE_LEAVES.items():
        dtype = getattr(torch, label)
        w = torch.randn(k, n, generator=gen, device=dev).to(dtype)
        sparse_a_batch_invariance(torch, gen, w)
        for m in XLSTM_ROWS:
            a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            out = dense_matmul(a, w)
            ref = dense_matmul_ref(a, w)
            torch.cuda.synchronize()
            err, ok = within_tol(torch, out, ref, label)
            row = {"kernel": "dense_gemm", "model": HYBRID, "leaf": leaf,
                   "dtype": label, "m": m, "k": k, "n": n,
                   "route": k1_route(n), "max_abs_err": err, "ok": ok}
            if not ok:
                fail(f"dense_gemm disagrees with its plain version: {row}")
            for part in (1, 4):
                if not torch.equal(dense_matmul(a[:part].contiguous(), w),
                                   out[:part]):
                    fail(f"dense_gemm is not batch invariant at {k}x{n} "
                         f"{label}: rows 0:{part} differ")
            b_ms, b_by = bound((a.numel() + m * n) * a.element_size()
                               + w.numel() * w.element_size(),
                               2.0 * m * k * n, label)
            row.update(ms=timed_ms(torch, lambda: dense_matmul(a, w)),
                       plain_ms=timed_ms(torch,
                                         lambda: dense_matmul_ref(a, w)),
                       library_ms=timed_ms(torch,
                                           lambda: torch.matmul(a, w)),
                       bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            print(f"[kernels] {json.dumps(row)}")
            # K3 on the same leaf, every block live (the serving path's
            # activations), its metadata built on the card
            meta = compact_activations(a)
            kidx, cnt = compact_activations_ref(a, block_m=meta.block_m,
                                                block_k=meta.block_k)
            if not (torch.equal(meta.kidx, kidx)
                    and torch.equal(meta.cnt, cnt)):
                fail(f"sparse_a_meta differs from the plain metadata at "
                     f"{m} x {k} {label}")
            rows.append({"kernel": "sparse_a_meta", "model": HYBRID,
                         "dtype": label, "m": m, "k": k,
                         "block_m": meta.block_m, "block_k": meta.block_k,
                         "max_abs_err": 0.0, "ok": True})
            out = sparse_a_matmul(a, w, meta=meta)
            ref = sparse_a_ref(a, w, meta.kidx, meta.cnt,
                               block_m=meta.block_m, block_k=meta.block_k)
            torch.cuda.synchronize()
            err, ok = within_tol(torch, out, ref, label)
            row = {"kernel": "sparse_a", "model": HYBRID, "leaf": leaf,
                   "dtype": label, "m": m, "k": k, "n": n,
                   "block_m": meta.block_m,
                   "route": ROUTE_NAMES[route(a, w, meta.block_k)[0]],
                   "max_abs_err": err, "ok": ok}
            if not ok or out.dtype != dtype:
                fail(f"sparse_a disagrees with its plain version: {row}")
            timed_sparse_a(torch, a, w, meta, row)
            rows.append(row)
        del w
    print(f"[kernels] recurrentgemma-9b: griffin_spmm at {len(HYBRID_SPMM)} "
          f"shapes (dual and not), dense_gemm and sparse_a at {k}x{n} in "
          "bf16 and fp32 agree with their plain versions and are batch "
          "invariant")
    return rows


def kernel_moe(torch, gen, summary):
    """The kernels at mixtral-8x7b's shapes, M 4 and 32 (decode slots, the
    largest prefill bucket): griffin_spmm at its five compacted shapes
    (``MOE_SPMM``, bf16, pruned 0.8 at 128 x 128 / unit 32, balanced),
    dual and not, against its plain version, held batch invariant and
    timed beside its bound and torch.matmul; dual also on an all-zero A
    (an expert no token chose: no weight block is read).  The router's
    fp32 (4096 x 8) GEMM through dense_gemm's skinny route and through
    sparse_a with its metadata (every block live, bit-equal to the plain
    metadata), each checked, held batch invariant and timed the same
    way."""
    from repro_torch.kernels import (compact_activations, dense_matmul,
                                     griffin_matmul, preprocess_weights,
                                     sparse_a_matmul)
    from repro_torch.kernels.dense_gemm.kernel import route as k1_route
    from repro_torch.kernels.dense_gemm.kernel import skinny_slices
    from repro_torch.kernels.dense_gemm.ref import dense_matmul_ref
    from repro_torch.kernels.griffin_spmm.kernel import split_plan
    from repro_torch.kernels.griffin_spmm.ref import griffin_spmm_ref
    from repro_torch.kernels.sparse_a.kernel import ROUTE_NAMES, route
    from repro_torch.kernels.sparse_a.ref import (compact_activations_ref,
                                                  sparse_a_ref)
    from repro_torch.sparsity import block_prune

    dev, dt = torch.device("cuda"), torch.bfloat16
    rows = []
    for leaf, (k, n) in MOE_SPMM.items():
        w = block_prune(torch.randn(k, n, generator=gen, device=dev), 0.8)
        gw = preprocess_weights(w.to(dt))
        del w
        plan = split_plan(k, n, gw.kidx.shape[0], gw.block_k, gw.block_n)
        print(f"[kernels] moe griffin_spmm {leaf} {k}x{n} (max_cnt "
              f"{gw.kidx.shape[1]} of {gw.k // gw.block_k}): plan "
              f"{plan and list(plan)}")
        spmm_batch_invariance(torch, gen, gw)
        for m in XLSTM_ROWS:
            a = torch.randn(m, k, generator=gen, device=dev).to(dt)
            a[:, :256] = 0              # two all-zero K blocks for dual
            plain_bits = None
            for dual in (False, True):
                out = griffin_matmul(a, gw, dual=dual)
                ref = griffin_spmm_ref(a, gw)
                torch.cuda.synchronize()
                err, ok = within_tol(torch, out, ref, "bfloat16")
                row = {"kernel": "griffin_spmm", "model": MOE, "leaf": leaf,
                       "dtype": "bfloat16", "m": m, "k": k, "n": n,
                       "dual": dual, "max_cnt": gw.kidx.shape[1],
                       "plan": plan and list(plan), "max_abs_err": err,
                       "ok": ok}
                if not dual:
                    row.update(k2_route(torch, a, gw, f"{MOE} {leaf}"))
                if not ok:
                    fail(f"griffin_spmm disagrees with its plain version: "
                         f"{row}")
                if dual and not torch.equal(out, plain_bits):
                    fail(f"griffin_spmm {leaf}: dual is not bit-equal to "
                         "the plain walk")
                plain_bits = out
                timed_spmm(torch, a, gw, dual, row)
                rows.append(row)
                print(f"[kernels] {json.dumps(row)}")
        # an expert that no token chose: an all-zero A, which dual skips
        a = torch.zeros(XLSTM_ROWS[0], k, dtype=dt, device=dev)
        out = griffin_matmul(a, gw, dual=True)
        if not bool((out == 0).all()):
            fail(f"griffin_spmm {leaf}: dual on an all-zero A is not zero")
        row = {"kernel": "griffin_spmm", "model": MOE, "leaf": leaf,
               "dtype": "bfloat16", "m": a.shape[0], "k": k, "n": n,
               "dual": True, "a": "all-zero", "max_abs_err": 0.0, "ok": True}
        timed_spmm(torch, a, gw, True, row)
        rows.append(row)
        print(f"[kernels] {json.dumps(row)}")
        del gw
        torch.cuda.empty_cache()
    k, n = MOE_ROUTER
    w = torch.randn(k, n, generator=gen, device=dev)
    sparse_a_batch_invariance(torch, gen, w)
    for m in XLSTM_ROWS:
        a = torch.randn(m, k, generator=gen, device=dev)
        out = dense_matmul(a, w)
        ref = dense_matmul_ref(a, w)
        torch.cuda.synchronize()
        err, ok = within_tol(torch, out, ref, "float32")
        row = {"kernel": "dense_gemm", "model": MOE, "leaf": "router",
               "dtype": "float32", "m": m, "k": k, "n": n,
               "route": k1_route(n), "slices": skinny_slices(k),
               "max_abs_err": err, "ok": ok}
        if not ok or k1_route(n) != "skinny":
            fail(f"dense_gemm disagrees with its plain version or is off "
                 f"its skinny route: {row}")
        for part in (1, 4):
            if not torch.equal(dense_matmul(a[:part].contiguous(), w),
                               out[:part]):
                fail(f"dense_gemm is not batch invariant at the router "
                     f"{k}x{n}: rows 0:{part} differ")
        b_ms, b_by = bound((a.numel() + m * n + w.numel()) * 4,
                           2.0 * m * k * n, "float32")
        row.update(ms=timed_ms(torch, lambda: dense_matmul(a, w)),
                   plain_ms=timed_ms(torch, lambda: dense_matmul_ref(a, w)),
                   library_ms=timed_ms(torch, lambda: torch.matmul(a, w)),
                   bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        print(f"[kernels] {json.dumps(row)}")
        meta = compact_activations(a)
        kidx, cnt = compact_activations_ref(a, block_m=meta.block_m,
                                            block_k=meta.block_k)
        if not (torch.equal(meta.kidx, kidx) and torch.equal(meta.cnt, cnt)):
            fail(f"sparse_a_meta differs from the plain metadata at the "
                 f"router {m} x {k}")
        rows.append({"kernel": "sparse_a_meta", "model": MOE,
                     "dtype": "float32", "m": m, "k": k,
                     "block_m": meta.block_m, "block_k": meta.block_k,
                     "max_abs_err": 0.0, "ok": True})
        out = sparse_a_matmul(a, w, meta=meta)
        ref = sparse_a_ref(a, w, meta.kidx, meta.cnt, block_m=meta.block_m,
                           block_k=meta.block_k)
        torch.cuda.synchronize()
        err, ok = within_tol(torch, out, ref, "float32")
        row = {"kernel": "sparse_a", "model": MOE, "leaf": "router",
               "dtype": "float32", "m": m, "k": k, "n": n,
               "block_m": meta.block_m,
               "route": ROUTE_NAMES[route(a, w, meta.block_k)[0]],
               "max_abs_err": err, "ok": ok}
        if not ok:
            fail(f"sparse_a disagrees with its plain version: {row}")
        timed_sparse_a(torch, a, w, meta, row)
        rows.append(row)
    print(f"[kernels] mixtral-8x7b: griffin_spmm at {len(MOE_SPMM)} shapes "
          f"(dual and not, and dual on an all-zero A), dense_gemm's skinny "
          f"route and sparse_a at the fp32 {k}x{n} router agree with their "
          "plain versions and are batch invariant")
    return rows


def kernel_whisper(torch, gen, summary):
    """griffin_spmm at whisper-large-v3's compacted shapes
    (``WHISPER_SPMM``, pruned 0.8 at 128 x 128 / unit 32, balanced): in
    bf16 at M 4 and 32, dual and not, against its plain version, dual
    bit-equal to the plain walk, timed beside its bound, its plain version
    and torch.matmul; on the encoder's three shapes also fp32 A against the
    bf16 weight at M 1500 (the CUDA-core route), checked and timed the
    same way (torch.matmul on the decompacted weight widened to fp32).
    Batch invariance at 1280 x 5120, bf16 and fp32 A.  At the head (N
    51866, a 26-column partial last tile) an integer-valued A and weight,
    whose products and sums are exact in any order, give the plain
    version's bits in every column, the tail's included: bf16 at M 4 and
    32, dual and not, and fp32 A at M 4."""
    from repro_torch.kernels import griffin_matmul, preprocess_weights
    from repro_torch.kernels.griffin_spmm.kernel import split_plan
    from repro_torch.kernels.griffin_spmm.ref import griffin_spmm_ref
    from repro_torch.sparsity import block_prune

    dev, dt = torch.device("cuda"), torch.bfloat16
    rows = []
    for leaf, (k, n) in WHISPER_SPMM.items():
        w = block_prune(torch.randn(k, n, generator=gen, device=dev), 0.8)
        gw = preprocess_weights(w.to(dt))
        del w
        plan = split_plan(k, n, gw.kidx.shape[0], gw.block_k, gw.block_n)
        print(f"[kernels] whisper griffin_spmm {leaf} {k}x{n} (max_cnt "
              f"{gw.kidx.shape[1]} of {gw.k // gw.block_k}): plan "
              f"{plan and list(plan)}")
        if (k, n) == (1280, 5120):
            spmm_batch_invariance(torch, gen, gw)
            spmm_batch_invariance(torch, gen, gw, dtype=torch.float32)
        cases = [(m, "bfloat16") for m in XLSTM_ROWS]
        if leaf != "head":
            cases.append((WHISPER_ENC_ROWS, "mixed"))
        for m, label in cases:
            a = torch.randn(m, k, generator=gen, device=dev).to(
                getattr(torch, PAIRS[label][0]))
            a[:, :256] = 0              # two all-zero K blocks for dual
            plain_bits = None
            for dual in (False, True):
                out = griffin_matmul(a, gw, dual=dual)
                ref = griffin_spmm_ref(a, gw)
                torch.cuda.synchronize()
                err, ok = within_tol(torch, out, ref, label)
                row = {"kernel": "griffin_spmm", "model": WHISPER,
                       "leaf": leaf, "dtype": label, "m": m, "k": k, "n": n,
                       "dual": dual, "max_cnt": gw.kidx.shape[1],
                       "plan": (plan and list(plan)) if label == "bfloat16"
                       else None, "max_abs_err": err, "ok": ok}
                if not ok:
                    fail(f"griffin_spmm disagrees with its plain version: "
                         f"{row}")
                if dual and not torch.equal(out, plain_bits):
                    fail(f"griffin_spmm {leaf} {label} M {m}: dual is not "
                         "bit-equal to the plain walk")
                plain_bits = out
                timed_spmm(torch, a, gw, dual, row)
                rows.append(row)
                print(f"[kernels] {json.dumps(row)}")
        del gw
        torch.cuda.empty_cache()
    # the head's partial last tile, bit for bit on exact integer products
    k, n = WHISPER_SPMM["head"]
    w = block_prune(torch.randint(-3, 4, (k, n), generator=gen,
                                  device=dev).float(), 0.8)
    for wdt, adt, ms in ((dt, dt, XLSTM_ROWS), (dt, torch.float32, (4,))):
        gw = preprocess_weights(w.to(wdt))
        for m in ms:
            a = torch.randint(-2, 3, (m, k), generator=gen,
                              device=dev).to(adt)
            a[:, :256] = 0
            ref = griffin_spmm_ref(a, gw)
            for dual in ((False, True) if adt == dt else (False,)):
                out = griffin_matmul(a, gw, dual=dual)
                if not torch.equal(out, ref):
                    bad = (out != ref).any(0).nonzero().flatten()
                    fail(f"griffin_spmm at the head {k}x{n}, A {adt}, M {m}, "
                         f"dual {dual}: columns {bad[:8].tolist()} differ "
                         "from the plain version on exact products")
            rows.append({"kernel": "griffin_spmm", "model": WHISPER,
                         "leaf": "head exact", "dtype": str(adt)[6:],
                         "m": m, "k": k, "n": n, "max_abs_err": 0.0,
                         "ok": True})
        del gw
    print(f"[kernels] whisper-large-v3: griffin_spmm at {len(WHISPER_SPMM)} "
          f"shapes (bf16 M 4 and 32, dual and not; fp32 A at M "
          f"{WHISPER_ENC_ROWS} on the encoder's three) agrees with its plain "
          f"version; the head's {n % 128}-column tail tile bit-equal to it "
          "on exact products")
    return rows


def k2_route(torch, a, gw, what: str) -> dict:
    """The route the Python mirror (``griffin_spmm.kernel.route``)
    predicts for griffin_matmul(a, gw) and the route the launch took, as
    the C++ entry counts its launches per route
    (``griffin_spmm.kernel.route_launches``); fails unless they are the
    same.  (torch.profiler's kernel names say the same in a fresh
    process, ``tests/test_torch_gpu.py``, but after the earlier kernel
    checks the profiler drops the device records of every other session
    or more.)"""
    from repro_torch.kernels import griffin_matmul
    from repro_torch.kernels.griffin_spmm.kernel import route, route_launches

    want = route(a, gw.b_comp, gw.kidx, n=gw.n, block_k=gw.block_k,
                 block_n=gw.block_n)
    before = route_launches()
    griffin_matmul(a, gw)
    after = route_launches()
    taken = [r for r in K2_ROUTES for _ in range(after[r] - before[r])]
    if taken != [want.name]:
        fail(f"griffin_spmm {what} {gw.k}x{gw.n} M {a.shape[0]}: the mirror "
             f"predicts the {want.name} route ({want.smem} B of shared "
             f"memory at grid depth {gw.kidx.shape[-1]}), the launch took "
             f"{taken}")
    return {"route": want.name, "smem": want.smem, "route_taken": taken[0]}


def served_rows(torch, name: str, arch: str, leaf: str, gw) -> list:
    """griffin_matmul on ``gw``, layer 0's slice of a served stacked leaf:
    at the stack's grid depth (its deepest member's; the slice's extra
    ``kidx`` entries repeat its last live id over zero ``b_comp`` rows),
    against its plain version, its route gated (:func:`k2_route`) and
    timed at M 4 and 32."""
    from repro_torch.kernels import griffin_matmul
    from repro_torch.kernels.griffin_spmm.ref import griffin_spmm_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for m in XLSTM_ROWS:
        a = torch.randn(m, gw.k, generator=gen, device="cuda").to(
            gw.b_comp.dtype)
        out = griffin_matmul(a, gw)
        err, ok = within_tol(torch, out, griffin_spmm_ref(a, gw), "bfloat16")
        row = {"kernel": "griffin_spmm", "model": arch,
               "leaf": f"{leaf} as served", "dtype": "bfloat16", "m": m,
               "k": gw.k, "n": gw.n, "max_cnt": gw.kidx.shape[-1],
               "live_max": int(gw.cnt.max()),
               **k2_route(torch, a, gw, f"{arch} {leaf} as served"),
               "max_abs_err": err, "ok": ok}
        if not ok:
            fail(f"griffin_spmm disagrees with its plain version: {row}")
        timed_spmm(torch, a, gw, False, row, plain=False)
        rows.append(row)
        print(f"[serve {name}] {json.dumps(row)}")
    return rows


def served_deeper(tag: str, arch: str, params) -> list:
    """The stacked compacted leaves of ``params["layers"]`` whose grid
    depth (their deepest layer's) differs from that of the kernel phase's
    one draw at their shape (``DRAW_DEPTH``; every leaf where the kernel
    phase did not run), each depth printed."""
    from repro_torch.kernels import GriffinWeights

    out, depths = [], {}
    for leaf, gw in params["layers"].items():
        if not isinstance(gw, GriffinWeights):
            continue
        drawn = DRAW_DEPTH.get((arch, gw.k, gw.n))
        depths[leaf] = [gw.kidx.shape[-1], drawn]
        if gw.kidx.shape[-1] != drawn:
            out.append(leaf)
    print(f"{tag} grid depth by leaf, [served stack, the kernel phase's "
          f"draw]: {json.dumps(depths)}; checked as served: {out}")
    return out


def kernel_dense_configs(torch, gen, spmm=DENSE_SPMM,
                         k3=((STABLELM, STABLELM_K3),)):
    """griffin_spmm at every K2 leaf shape of stablelm-1.6b, minitron-8b
    and command-r-plus-104b (``DENSE_SPMM``; chameleon-34b's with
    ``VLM_SPMM``, bf16, pruned 0.8 at 128 x 128 / unit 32, balanced), at
    M 4 and 32, each draw's grid depth kept in ``DRAW_DEPTH``: against
    its plain version, timed
    beside its bound and torch.matmul on the decompacted weight (not its
    plain version: at command-r's head that decompacts 6.3 GB a call),
    with the route the Python mirror predicts (``griffin_spmm.kernel.
    route``, from the weight's grid depth) equal to the route the launch
    took (:func:`k2_route`).  Batch invariance at each config's w_down.
    Then sparse_a at each ``k3`` (arch, shapes) pair's Mode.A shapes
    (stablelm-1.6b's beyond llama's, ``STABLELM_K3``; chameleon-34b's
    every leaf, ``CHAMELEON_K3``; B row-major): each layer leaf at every
    bucket's M (``M_ROWS``) with two all-zero K blocks and with every
    block live, the dense head at M 4 and 32 with every block live; each
    A's metadata bit-equal to the plain metadata, each output within
    tolerance of the plain version, every block live timed at M 4 and
    32."""
    from repro_torch.kernels import (compact_activations, griffin_matmul,
                                     preprocess_weights, sparse_a_matmul)
    from repro_torch.kernels.griffin_spmm.kernel import split_plan
    from repro_torch.kernels.griffin_spmm.ref import griffin_spmm_ref
    from repro_torch.kernels.sparse_a.kernel import ROUTE_NAMES
    from repro_torch.kernels.sparse_a.kernel import route as k3_route
    from repro_torch.kernels.sparse_a.ref import (compact_activations_ref,
                                                  sparse_a_ref)
    from repro_torch.sparsity import block_prune

    dev, dt = torch.device("cuda"), torch.bfloat16
    rows = []
    for arch, leaves in spmm.items():
        for leaf, (k, n) in leaves.items():
            w = block_prune(torch.randn(k, n, generator=gen, device=dev),
                            0.8).to(dt)
            gw = preprocess_weights(w)
            del w
            torch.cuda.empty_cache()
            nt, depth = gw.kidx.shape
            DRAW_DEPTH[(arch, k, n)] = depth
            plan = split_plan(k, n, nt, gw.block_k, gw.block_n)
            if leaf == "w_down":
                spmm_batch_invariance(torch, gen, gw)
            for m in XLSTM_ROWS:
                a = torch.randn(m, k, generator=gen, device=dev).to(dt)
                out = griffin_matmul(a, gw)
                ref = griffin_spmm_ref(a, gw)
                torch.cuda.synchronize()
                err, ok = within_tol(torch, out, ref, "bfloat16")
                del out, ref
                row = {"kernel": "griffin_spmm", "model": arch, "leaf": leaf,
                       "dtype": "bfloat16", "m": m, "k": k, "n": n,
                       "max_cnt": depth, "of": gw.k // gw.block_k,
                       "plan": plan and list(plan),
                       **k2_route(torch, a, gw, f"{arch} {leaf}"),
                       "max_abs_err": err, "ok": ok}
                if not ok:
                    fail(f"griffin_spmm disagrees with its plain version: "
                         f"{row}")
                timed_spmm(torch, a, gw, False, row, plain=False)
                rows.append(row)
                print(f"[kernels] {json.dumps(row)}")
            del gw
            torch.cuda.empty_cache()
    print(f"[kernels] {', '.join(spmm)}: griffin_spmm at "
          f"{sum(map(len, spmm.values()))} shapes, M 4 and 32, agrees "
          "with its plain version and takes the route its Python mirror "
          "predicts")
    for arch, leaf, (k, n) in ((a, leaf, kn) for a, shapes in k3
                               for leaf, kn in shapes.items()):
        w = (torch.randn(k, n, generator=gen, device=dev) /
             math.sqrt(k)).to(dt)
        for m in XLSTM_ROWS if leaf == "head" else M_ROWS:
            a = torch.randn(m, k, generator=gen, device=dev).to(dt)
            cases = [("every block live", a)]
            if leaf != "head":
                dead = a.clone()
                dead[:, 128:384] = 0            # two all-zero K blocks
                cases.append(("two K blocks zero", dead))
            for live, x in cases:
                meta = compact_activations(x)
                kidx, cnt = compact_activations_ref(
                    x, block_m=meta.block_m, block_k=meta.block_k)
                if not (torch.equal(meta.kidx, kidx)
                        and torch.equal(meta.cnt, cnt)):
                    fail(f"sparse_a_meta differs from the plain metadata at "
                         f"{arch}'s {leaf}, {m} x {k}, {live}: cnt "
                         f"{meta.cnt.tolist()} vs {cnt.tolist()}")
                out = sparse_a_matmul(x, w, meta=meta)
                ref = sparse_a_ref(x, w, meta.kidx, meta.cnt,
                                   block_m=meta.block_m, block_k=meta.block_k)
                torch.cuda.synchronize()
                err, ok = within_tol(torch, out, ref, "bfloat16")
                row = {"kernel": "sparse_a", "model": arch, "leaf": leaf,
                       "a": live, "dtype": "bfloat16", "m": m, "k": k,
                       "n": n, "block_m": meta.block_m,
                       "cnt": meta.cnt.tolist(),
                       "route": ROUTE_NAMES[k3_route(x, w, meta.block_k)[0]],
                       "max_abs_err": err, "ok": ok}
                if not ok:
                    fail(f"sparse_a disagrees with its plain version: {row}")
                if m in XLSTM_ROWS and x is a:
                    timed_sparse_a(torch, x, w, meta, row)
                rows.append(row)
        del w
        torch.cuda.empty_cache()
    for arch, shapes in k3:
        print(f"[kernels] sparse_a and its metadata at {arch}'s "
              f"{', '.join(shapes)} agree with their plain versions (layer "
              "leaves at M " + "/".join(map(str, M_ROWS)) + " with two "
              "all-zero K blocks and with every block live)")
    return rows


def timed_spmm(torch, a, gw, dual: bool, row, plain: bool = True) -> None:
    """Time griffin_matmul, its plain version (unless ``plain`` is off)
    and torch.matmul on the decompacted weight; bound by the bytes of the
    live blocks this A needs (with dual, those whose A block is not all
    zero)."""
    from repro_torch.kernels import decompact_weights, griffin_matmul
    from repro_torch.kernels.griffin_spmm.ref import griffin_spmm_ref

    m, k = a.shape
    bk = gw.block_k
    needed = [True] * (gw.k // bk)
    if dual:
        needed = [bool(a[:, i * bk:(i + 1) * bk].any())
                  for i in range(gw.k // bk)]
    kidx, cnt = gw.kidx.tolist(), gw.cnt.tolist()
    blocks = sum(needed[kb] for ids, c in zip(kidx, cnt) for kb in ids[:c])
    esz = a.element_size()
    nbytes = (a.numel() + m * gw.n) * esz + \
        blocks * bk * gw.block_n * gw.b_comp.element_size() + 4 * (
            gw.kidx.numel() + gw.cnt.numel()
            + (0 if gw.perm is None else gw.perm.numel()))
    b_ms, b_by = bound(nbytes, 2.0 * m * blocks * bk * gw.block_n,
                       row["dtype"])
    # A may be narrower than gw.k; the library call takes A's dtype
    w_dense = decompact_weights(gw)[:k].to(a.dtype)
    row.update(
        ms=timed_ms(torch, lambda: griffin_matmul(a, gw, dual=dual)),
        plain_ms=timed_ms(torch, lambda: griffin_spmm_ref(a, gw))
        if plain else None,
        library_ms=timed_ms(torch, lambda: torch.matmul(a, w_dense)),
        bound_ms=b_ms, bound_by=b_by, needed_blocks=blocks)


def spmm_batch_invariance(torch, gen, gw, k=None, dtype=None) -> None:
    """Rows 0, 0:4 and 0:32 of one A (``k`` columns, default the padded K;
    ``dtype``, default the weight's) give bit-equal rows through
    griffin_matmul, dual and not, at this full-width shape."""
    from repro_torch.kernels import griffin_matmul

    a = torch.randn(32, k or gw.k, generator=gen, device="cuda").to(
        dtype or gw.b_comp.dtype)
    a[:16, :256] = 0                    # a dead K block in the first rows
    for dual in (False, True):
        full = griffin_matmul(a, gw, dual=dual)
        for rows in (1, 4):
            part = griffin_matmul(a[:rows].contiguous(), gw, dual=dual)
            if not torch.equal(part, full[:rows]):
                fail(f"griffin_spmm is not batch invariant at K x N "
                     f"{gw.k} x {gw.n}, dual {dual}, A {a.dtype}: rows "
                     f"0:{rows} differ from the same rows of a 32-row call")
    print(f"[kernels] griffin_spmm {gw.k}x{gw.n}: rows 0, 0:4 of a 32-row "
          f"{str(a.dtype)[6:]} A bit-equal alone and in the full call, dual "
          "and not")


def zero_k_blocks(a, bm: int, every: int):
    """Zero the (bm x 128) blocks (i, j) of ``a`` with (i + j) % every == 0
    and the whole first M tile, so the M tiles have different live K
    blocks and one has none."""
    for i in range(-(-a.shape[0] // bm)):
        for j in range(a.shape[1] // 128):
            if (i + j) % every == 0:
                a[i * bm:(i + 1) * bm, j * 128:(j + 1) * 128] = 0
    a[:bm] = 0
    return a


def timed_sparse_a(torch, a, w, meta, row) -> None:
    """Time sparse_a (metadata given), the plain GEMM and torch.matmul;
    bound by the bytes and operations of the visited blocks."""
    from repro_torch.kernels import sparse_a_matmul
    from repro_torch.kernels.sparse_a.ref import sparse_a_ref

    m, k = a.shape
    n = w.shape[1]
    bm, bk = meta.block_m, meta.block_k
    cnt = meta.cnt.tolist()
    listed = torch.zeros(meta.m // bm, meta.k // bk, dtype=torch.bool,
                         device=a.device)
    for i, c in enumerate(cnt):
        listed[i, meta.kidx[i, :c].long()] = True
    live_rows = min(int(listed.any(0).sum()) * bk, k)
    tile_rows = [min(bm, m - i * bm) for i in range(len(cnt))]
    esz = a.element_size()
    meta_bytes = 4 * (meta.kidx.numel() + meta.cnt.numel())
    nbytes = (a.numel() + m * n) * esz + live_rows * n * \
        w.element_size() + meta_bytes
    w_lib = w.to(a.dtype)           # torch.matmul takes one dtype
    flops = 2.0 * n * sum(r * min(c * bk, k)
                          for r, c in zip(tile_rows, cnt))
    b_ms, b_by = bound(nbytes, flops, row["dtype"])
    row.update(
        ms=timed_ms(torch, lambda: sparse_a_matmul(a, w, meta=meta)),
        plain_ms=timed_ms(torch, lambda: sparse_a_ref(
            a, w, meta.kidx, meta.cnt, block_m=bm, block_k=bk)),
        library_ms=timed_ms(torch, lambda: torch.matmul(a, w_lib)),
        bound_ms=b_ms, bound_by=b_by,
        live_blocks=f"{sum(cnt)}/{len(cnt) * (meta.k // bk)}")
    print(f"[kernels] {json.dumps(row)}")


def kernel_sparse_a(torch, gen, summary):
    """K3 at every serving shape (the four dense layer shapes with B
    row-major, the unembedding with B = embed.T, xlstm-1.3b's (4096 x 4)
    gate leaves), and its metadata kernel held bitwise against the plain
    metadata on every A it is given."""
    from repro_torch.kernels import (ActivationMeta, compact_activations,
                                     sparse_a_matmul)
    from repro_torch.kernels.sparse_a.kernel import ROUTE_NAMES, route
    from repro_torch.kernels.sparse_a.ref import (compact_activations_ref,
                                                  sparse_a_ref)

    dev = torch.device("cuda")
    rows = []

    def meta_of(a, block_m=128, block_k=128, **info):
        """compact_activations on the card, bit-equal to the plain
        metadata on the same A."""
        meta = compact_activations(a, block_m=block_m, block_k=block_k)
        kidx, cnt = compact_activations_ref(a, block_m=meta.block_m,
                                            block_k=meta.block_k)
        ok = torch.equal(meta.kidx, kidx) and torch.equal(meta.cnt, cnt)
        row = {"kernel": "sparse_a_meta", "dtype": str(a.dtype)[6:],
               "m": a.shape[0], "k": a.shape[1], "block_m": meta.block_m,
               "block_k": meta.block_k, "max_abs_err": 0.0, "ok": ok,
               **info}
        if not ok:
            fail(f"sparse_a_meta differs from the plain metadata: {row}, "
                 f"cnt {meta.cnt.tolist()} vs {cnt.tolist()}")
        rows.append(row)
        return meta

    def check(a, w, meta, **info):
        out = sparse_a_matmul(a, w, meta=meta)
        ref = sparse_a_ref(a, w, meta.kidx, meta.cnt, block_m=meta.block_m,
                           block_k=meta.block_k)
        torch.cuda.synchronize()
        dtype = "mixed" if a.dtype != w.dtype else str(a.dtype).split(".")[1]
        err, ok = within_tol(torch, out, ref, dtype)
        row = {"kernel": "sparse_a", "dtype": dtype, "m": a.shape[0],
               "k": a.shape[1], "n": w.shape[1], "block_m": meta.block_m,
               "route": ROUTE_NAMES[route(a, w, meta.block_k)[0]],
               "cnt": meta.cnt.tolist(), "max_abs_err": err, "ok": ok,
               **info}
        if not ok or out.dtype != a.dtype:
            fail(f"sparse_a disagrees with its plain version: {row}, output "
                 f"{out.dtype}")
        rows.append(row)
        return row

    for (k, n) in SPMM_SHAPES + (UNEMBED, XLSTM_GATE):
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            w = torch.randn(n, k, generator=gen, device=dev).to(dt).T
            layout = "embed.T"
            if (k, n) != UNEMBED:
                w, layout = w.contiguous(), "row-major"
            if dtype == "bfloat16":
                path, plan = route(torch.empty(4, k, dtype=dt, device=dev),
                                   w, 128)
                how = "no cluster split"
                if plan is not None:
                    how = (f"cluster split S={plan.splits}, {plan.cols}-"
                           f"column slices, {plan.chunk}-row chunks, "
                           f"{-(-n // plan.cols) * plan.splits} blocks per "
                           "32-row pass")
                print(f"[kernels] sparse_a plan {k}x{n} ({layout}): "
                      f"{ROUTE_NAMES[path]}, {how}")
                sparse_a_batch_invariance(torch, gen, w)
            for m in M_ROWS:
                a = torch.randn(m, k, generator=gen, device=dev).to(dt)
                dense_a = a.clone()
                a[:, 128:384] = 0               # two all-zero K blocks
                row = check(a, w, meta_of(a), layout=layout)
                if m in (4, 32) and dtype == "bfloat16":
                    # the serving path's activations: every block live
                    meta = meta_of(dense_a)
                    row = check(dense_a, w, meta, layout=layout)
                    timed_sparse_a(torch, dense_a, w, meta, row)
                    if (k, n) == UNEMBED and m == 4:
                        summary["sparse_a"] = row
                    half = dense_a.clone()
                    half[:, k // 2:] = 0        # half of the blocks dead
                    meta = meta_of(half)
                    timed_sparse_a(torch, half, w, meta,
                                   check(half, w, meta, layout=layout))
            # several M tiles of different live counts, one with none, then
            # hand-cut metadata that drops a live block
            a = zero_k_blocks(torch.randn(32, k, generator=gen,
                                          device=dev).to(dt), 8, 3)
            meta = meta_of(a, block_m=8)
            if len(set(meta.cnt.tolist())) < 3 or int(meta.cnt[0]) != 0:
                fail(f"sparse_a tiles not varied: cnt {meta.cnt.tolist()}")
            check(a, w, meta, layout=layout)
            cut_cnt = meta.cnt.clone()
            cut_cnt[-1] -= 1
            cut = ActivationMeta(meta.kidx, cut_cnt, meta.m, meta.k,
                                 meta.block_m, meta.block_k)
            row = check(a, w, cut, layout=layout, hand_cut=True)
            full = sparse_a_matmul(a, w, meta=meta)
            if torch.equal(full, sparse_a_matmul(a, w, meta=cut)):
                fail("hand-cut metadata did not change sparse_a's output")
            del w
    # fp32 A against the bf16 gate leaves (the mixed entry): checked, held
    # batch invariant and timed, every block live and half of them dead
    k, n = XLSTM_GATE
    w = torch.randn(k, n, generator=gen, device=dev).to(torch.bfloat16)
    sparse_a_batch_invariance(torch, gen, w, torch.float32)
    for m in XLSTM_ROWS:
        a = torch.randn(m, k, generator=gen, device=dev)
        meta = meta_of(a)
        timed_sparse_a(torch, a, w, meta,
                       check(a, w, meta, layout="row-major"))
        half = a.clone()
        half[:, k // 2:] = 0
        meta = meta_of(half)
        timed_sparse_a(torch, half, w, meta,
                       check(half, w, meta, layout="row-major"))
    del w
    # the ragged metadata case: M and K not whole blocks, dead blocks
    # inside and at the ragged K edge
    for dt in (torch.bfloat16, torch.float32):
        a = torch.randn(7, 300, generator=gen, device=dev).to(dt)
        a[:, 16:48] = 0
        a[:, 288:] = 0
        a[:4, 96:112] = 0
        meta_of(a, block_m=8, block_k=16, ragged=True)
    return rows


def kernel_shards(torch, gen) -> list:
    """The shard entries of K1, K2 and K3 (``MESH_SHARDS``): each model
    rank's columns, gathered in rank order (K2: then the whole weight's
    inverse balance shuffle, then the padding dropped), must equal the
    whole kernel's output bit for bit, and so sit within the stated
    tolerance of the plain version; K2's route (its Python mirror) must be
    the whole weight's, CUDA-core at ``SHARD_CORE``."""
    from repro_torch.kernels import (dense_matmul, griffin_matmul,
                                     preprocess_weights, sparse_a_matmul)
    from repro_torch.kernels.dense_gemm.ops import (DenseShard,
                                                    dense_matmul_shard)
    from repro_torch.kernels.dense_gemm.ref import dense_matmul_ref
    from repro_torch.kernels.griffin_spmm import kernel as k2
    from repro_torch.kernels.griffin_spmm.ops import griffin_matmul_shard
    from repro_torch.kernels.griffin_spmm.ref import griffin_spmm_ref
    from repro_torch.kernels.sparse_a.ops import sparse_a_matmul_shard
    from repro_torch.runtime.sharding import _griffin_share
    from repro_torch.sparsity import block_prune

    dev = torch.device("cuda")
    rows = []

    def check(kernel, parts, whole, plain, **info):
        out = torch.cat(parts, dim=1) if isinstance(parts, list) else parts
        torch.cuda.synchronize()
        err, ok = within_tol(torch, out, plain, "bfloat16")
        row = dict(kernel=kernel, dtype="bfloat16", max_abs_err=err,
                   bit_equal=bool(torch.equal(out, whole)), ok=ok, **info)
        if not (row["ok"] and row["bit_equal"]):
            fail(f"{kernel} shards differ from the whole kernel: {row}")
        rows.append(row)

    for k, n in SPMM_SHAPES + (SHARD_CORE,):
        w = (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5).to(
            torch.bfloat16)
        wp = block_prune(w, 0.8, 128, 32)
        del w
        gw = preprocess_weights(wp, block_k=128, block_n=128, unit=32)
        for m in (4, 32):
            a = torch.randn(m, k, generator=gen, device=dev).to(
                torch.bfloat16)
            a[:, 128:256] = 0           # a dead K block for the dual walk
            route = k2.route(a, gw.b_comp, gw.kidx, n=n, block_k=128,
                             block_n=128).name
            if route != ("core" if (k, n) == SHARD_CORE else "tc"):
                fail(f"griffin_spmm {k}x{n}: route {route}")
            plain = griffin_spmm_ref(a, gw)
            for shards in MESH_SHARDS:
                for dual in (False, True):
                    parts = [griffin_matmul_shard(a, _griffin_share(
                        gw, r, shards), dual=dual) for r in range(shards)]
                    out = torch.cat(parts, 1).index_select(
                        1, gw.inv_perm.long())[:, :n]
                    check("griffin_spmm", out,
                          griffin_matmul(a, gw, dual=dual), plain, m=m, k=k,
                          n=n, shards=shards, dual=dual, route=route)
                if (k, n) == SHARD_CORE:
                    continue
                per = n // shards
                cols = [DenseShard(wp[:, r * per:(r + 1) * per].contiguous(),
                                   n, shards) for r in range(shards)]
                ref = dense_matmul_ref(a, wp)
                check("sparse_a", [sparse_a_matmul_shard(a, c) for c in cols],
                      sparse_a_matmul(a, wp), ref, m=m, k=k, n=n,
                      shards=shards)
                check("dense_gemm", [dense_matmul_shard(a, c) for c in cols],
                      dense_matmul(a, wp), ref, m=m, k=k, n=n, shards=shards)
        del wp, gw
    V, D = UNEMBED[1], UNEMBED[0]
    emb = (torch.randn(V, D, generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    for m in (4, 32):
        a = torch.randn(m, D, generator=gen, device=dev).to(torch.bfloat16)
        ref = dense_matmul_ref(a, emb.T)
        for shards in MESH_SHARDS:
            rows_per = V // shards
            heads = [DenseShard(emb[r * rows_per:(r + 1) * rows_per].T, V,
                                shards) for r in range(shards)]
            check("dense_gemm", [dense_matmul_shard(a, h) for h in heads],
                  dense_matmul(a, emb.T), ref, m=m, k=D, n=V, shards=shards,
                  head=True)
            check("sparse_a", [sparse_a_matmul_shard(a, h) for h in heads],
                  sparse_a_matmul(a, emb.T), ref, m=m, k=D, n=V,
                  shards=shards, head=True)
    del emb
    by = {}
    for r in rows:
        by[r["kernel"]] = by.get(r["kernel"], 0) + 1
    print(f"[kernels] shard entries: {len(rows)} gathers bit-equal to the "
          f"whole kernel over {MESH_SHARDS} model ranks ({by}); "
          f"griffin_spmm {SHARD_CORE[0]}x{SHARD_CORE[1]} on the CUDA-core "
          "route with its shards")
    return rows


def _site_line(sites: dict) -> str:
    """A rank's gathers by call site: the count, the host ms a gather in
    all and until the local tensor was ready on the card (the rest waits
    for the peers and moves the bytes)."""
    return ", ".join(f"{k} {v['n']} x {1e3 * v['s'] / v['n']:.3f} ms "
                     f"(ready {1e3 * v['ready_s'] / v['n']:.3f})"
                     for k, v in sorted(sites.items()) if v["n"])


def phase_mesh(torch, card: str, want: dict, sb: dict):
    """``MESH`` and ``MESH_REMESH`` in one spawn of four ranks
    (``launch.serve.mesh_cells_on``): first sparse_b's trace, each rank
    drawing the seeded weights on the card and keeping its share, gated
    on every rank: tokens equal to sparse_b's, launches per model call
    exactly ``MESH["launches"]``, every weight GEMM through a shard entry
    (none replicated, none through the oracle), its K/V arena exactly
    ``MESH["kv_bytes"]``, its gathers over "model" exactly
    ``MESH["gathers"]`` a prefill and a decode step, at most
    ``max_syncs`` host syncs per token, and one host-state digest on all
    ranks.  Then
    :func:`check_remesh` on the same weights.  Prints the backend line,
    each rank's tok/s beside sparse_b's and its gathers per model call
    with their host ms, also by call site.  Returns both cells' records
    (mesh_2x2's, mesh_remesh's)."""
    from repro_torch.launch import serve as launch
    from repro_torch.launch.mesh import backend_line, serve_mesh
    from repro_torch.runtime.config import EngineConfig

    tag = "[serve mesh_2x2]"
    print(f"{tag} {backend_line(serve_mesh(MESH['spec']), 'cuda')}; {card}")
    config = EngineConfig().with_fields(decode_chunk=8, use_kernels=True,
                                        **MESH["arena"])
    cell = dict(arch="llama3.2-1b", sparsity=MESH["sparsity"], seed=SEED,
                config=config, **TRACE)
    faulted = dict(cell, config=config.with_fields(
        inject=MESH_REMESH["inject"]))
    t0 = time.perf_counter()
    recs, remesh = launch.mesh_cells_on(MESH["spec"], [cell, faulted],
                                        device="cuda")
    wall = time.perf_counter() - t0
    if len({r["digest"] for r in recs}) != 1:
        fail(f"mesh_2x2: the ranks' host states differ: "
             f"{[r['digest'] for r in recs]}")
    total = {k: 0 for k in recs[0]["launches"]}
    for rec in recs:
        st = rec["stats"]
        calls = rec["prefills_here"] + st["decode_steps"]
        want_l = {k: v * calls for k, v in MESH["launches"].items()}
        got = {k: rec["launches"][k] for k in want_l}
        d = rec["dispatch"]
        syncs = st["host_syncs"] / max(st["emitted"], 1)
        tps = st["emitted"] / max(rec["seconds"], 1e-9)
        g, gs = rec["gathers"], rec["gather_s"]
        mg = rec["model_gathers"]
        kv = rec["arena_bytes"]["k"] + rec["arena_bytes"]["v"]
        want_g = {"prefill": MESH["gathers"]["prefill"]
                  * rec["prefills_here"],
                  "decode": MESH["gathers"]["decode"] * st["decode_steps"]}
        print(f"{tag} rank {rec['rank']} ({rec['device']}, {rec['backend']}"
              f"): {st['emitted']} tokens in {rec['seconds']:.3f}s = "
              f"{tps:.1f} tok/s (sparse_b {sb['tokens_per_second']:.1f}); "
              f"{calls} model calls ({rec['prefills_here']} of its row's "
              f"prefills); launches {got}; dispatch {d}; {g['model']} "
              f"gathers over 'model' = {g['model'] / calls:.1f} a model call"
              f" ({mg['prefill']} in its prefills, {mg['decode']} in "
              f"{st['decode_steps']} decode steps), "
              f"{1e3 * gs['model'] / calls:.2f} ms a model call; "
              f"{g['data']} over 'data' ({1e3 * gs['data']:.1f} ms); "
              f"by site {_site_line(rec['gather_sites'])}; "
              f"K/V arena {kv} B ({rec['arena_bytes']}); "
              f"{syncs:.4f} host syncs/token; {rec['sharded_leaves']} "
              "sharded leaves")
        if kv != MESH["kv_bytes"]:
            fail(f"mesh_2x2 rank {rec['rank']}: K/V arena {kv} B, expected "
                 f"{MESH['kv_bytes']}")
        if mg != want_g:
            fail(f"mesh_2x2 rank {rec['rank']}: gathers over 'model' {mg}, "
                 f"expected {want_g}")
        if rec["tokens"] != want:
            fail(f"mesh_2x2 rank {rec['rank']}: tokens differ from "
                 f"{MESH['tokens_of']}'s")
        if got != want_l:
            fail(f"mesh_2x2 rank {rec['rank']}: launches {got}, expected "
                 f"{want_l}")
        if d.get("shard", 0) != MESH["shard_gemms"] * calls or \
                any(d.get(b, 0) for b in ("replicated", "spmd_oracle",
                                          "kernel", "plain")):
            fail(f"mesh_2x2 rank {rec['rank']}: dispatch {d}")
        if syncs > MESH["max_syncs"] or rec["mode"] != "B":
            fail(f"mesh_2x2 rank {rec['rank']}: {syncs} syncs/token, mode "
                 f"{rec['mode']}")
        for k, v in rec["launches"].items():
            total[k] += v
    print(f"{tag} 4 ranks equal to {MESH['tokens_of']} in tokens, one "
          f"host-state digest; wall {wall:.1f}s with the spawn, the "
          "ranks' weight builds and mesh_remesh")
    record = {"launches": total, "wall_s": wall,
              "ranks": [{k: r[k] for k in ("rank", "stats", "launches",
                                           "dispatch", "gathers", "gather_s",
                                           "gather_sites", "model_gathers",
                                           "arena_bytes",
                                           "seconds", "prefills_here",
                                           "digest")} for r in recs]}
    return record, check_remesh(card, want, sb, remesh)


def check_remesh(card: str, want: dict, sb: dict, recs: list) -> dict:
    """``MESH_REMESH``'s gates on its ranks' records: on each survivor
    sparse_b's tokens, one recovery logged as ``MESH_REMESH["log"]``,
    ``replayed`` model calls replayed, after the recovery exactly
    ``MESH["launches"]`` a model call and every weight GEMM through a
    shard entry (none replicated, none through the oracle), at most
    ``max_syncs`` host syncs per token, Mode.B, equal host-state digests,
    and the head shares it received: ``handover_bytes`` from the senders
    ``sources`` names; the departing ranks' status (``left``) with no
    launch and no GEMM after the loss.  Prints, ungated, each survivor's
    recovery seconds (regroup, handover with its bytes, reshard), the
    replayed calls and its tok/s before and after the loss."""
    tag = "[serve mesh_remesh]"
    served = [r for r in recs if r["status"] == "served"]
    left = {r["rank"]: r for r in recs if r["status"] != "served"}
    if {r: x["status"] for r, x in left.items()} != MESH_REMESH["left"]:
        fail(f"mesh_remesh: ranks left "
             f"{[(r, x['status']) for r, x in left.items()]}, expected "
             f"{MESH_REMESH['left']}")
    if len({r["digest"] for r in served}) != 1 or len(served) != 2:
        fail(f"mesh_remesh: the survivors' host states differ: "
             f"{[r['digest'] for r in served]}")
    total = {k: 0 for k in MESH["launches"]}
    for rank, rec in sorted(left.items()):
        after = {k: v for k, v in rec["launches_after_loss"].items() if v}
        moved = rec["remesh"][0]["transfers"] if rec["remesh"] else []
        sent = [(t["row"], t["share"], t["dst"], t["bytes"]) for t in moved]
        print(f"{tag} rank {rank} {rec['status']} at step {rec['step']}: "
              f"launches after the loss {after or 0}, GEMMs "
              f"{sum(rec['dispatch_after_loss'].values())}; sent (row, "
              f"share, to, bytes) {sent}")
        if after or any(rec["dispatch_after_loss"].values()):
            fail(f"mesh_remesh rank {rank}: launched after the loss: "
                 f"{rec['launches_after_loss']}, "
                 f"{rec['dispatch_after_loss']}")
        for k in total:
            total[k] += rec["launches"].get(k, 0)
    for rec in served:
        st = rec["stats"]
        calls = rec["calls_after"]
        want_l = {k: v * calls for k, v in MESH["launches"].items()}
        got = {k: rec["launches_after"].get(k, 0) for k in want_l}
        d = rec["dispatch_after"]
        syncs = st["host_syncs"] / max(st["emitted"], 1)
        (x,) = rec["remesh"]
        came = [t for t in x["transfers"] if t["dst"] == rec["rank"]]
        came_b = sum(t["bytes"] for t in came)
        sources = {(t["row"], t["share"]): t["src"] for t in came}
        print(f"{tag} rank {rec['rank']} -> {rec['final_mesh']} position "
              f"{rec['final_rank']}: recovery {rec['recovery_log']}; "
              f"regroup {1e3 * x['regroup_s']:.1f} ms, handover "
              f"{x['handover_bytes']} B in {1e3 * x['handover_s']:.1f} ms "
              f"(received {came_b} B, (row, share): sender {sources}), "
              f"reshard {1e3 * x['reshard_s']:.1f} ms; "
              f"{rec['replayed_calls']} model calls replayed; tok/s "
              f"{rec['tok_s_before']:.1f} before the loss, "
              f"{rec['tok_s_after']:.1f} after (sparse_b "
              f"{sb['tokens_per_second']:.1f}); the run {rec['seconds']:.2f}"
              f" s; {calls} model calls after: launches {got}, dispatch "
              f"{d}; {syncs:.4f} host syncs/token; {card}")
        if came_b != MESH_REMESH["handover_bytes"] or \
                sources != MESH_REMESH["sources"].get(rec["rank"]):
            fail(f"mesh_remesh rank {rec['rank']}: received {came_b} B "
                 f"from {sources}, expected "
                 f"{MESH_REMESH['handover_bytes']} B from "
                 f"{MESH_REMESH['sources'].get(rec['rank'])}")
        if rec["tokens"] != want:
            fail(f"mesh_remesh rank {rec['rank']}: tokens differ from "
                 f"{MESH['tokens_of']}'s")
        if rec["recoveries"] != 1 or \
                rec["recovery_log"] != MESH_REMESH["log"] or \
                rec["final_mesh"] != "1x2" or \
                rec["replayed_calls"] != MESH_REMESH["replayed"]:
            fail(f"mesh_remesh rank {rec['rank']}: {rec['recoveries']} "
                 f"recoveries, log {rec['recovery_log']}, final mesh "
                 f"{rec['final_mesh']}, {rec['replayed_calls']} replayed")
        if got != want_l:
            fail(f"mesh_remesh rank {rec['rank']}: launches after the "
                 f"recovery {got}, expected {want_l}")
        if d.get("shard", 0) != MESH["shard_gemms"] * calls or \
                any(d.get(b, 0) for b in ("replicated", "spmd_oracle",
                                          "kernel", "plain")):
            fail(f"mesh_remesh rank {rec['rank']}: dispatch after the "
                 f"recovery {d}")
        if syncs > MESH["max_syncs"] or rec["mode"] != "B":
            fail(f"mesh_remesh rank {rec['rank']}: {syncs} syncs/token, "
                 f"mode {rec['mode']}")
        for k in total:
            total[k] += rec["launches"][k]
    print(f"{tag} 2x2 -> 1x2 after rank 3's loss: both survivors equal to "
          f"{MESH['tokens_of']} in tokens, one host-state digest")
    return {"launches": total,
            "ranks": [{k: r.get(k) for k in (
                "rank", "status", "final_mesh", "recovery_log",
                "replayed_calls", "remesh", "launches_after",
                "dispatch_after", "calls_after", "tok_s_before",
                "tok_s_after", "launches_after_loss", "stats", "digest",
                "seconds")}
                for r in recs]}


def kernel_meta(torch, gen, summary):
    """The metadata kernel alone at the decode shape and the two tall ones
    (``META_SHAPES``, bf16, every block live): bit-equal to the plain
    metadata; its cluster split, ``timed_ms`` beside its device duration,
    the plain version's time and the byte bound; and the launch floor."""
    from repro_torch.kernels import compact_activations
    from repro_torch.kernels.sparse_a.kernel import meta_slices
    from repro_torch.kernels.sparse_a.ref import compact_activations_ref

    floor = launch_floor(torch)
    summary["launch_floor"] = floor
    print(f"[kernels] launch floor (a one-element fill): "
          f"{json.dumps(floor)}")
    rows = []
    for m, k in META_SHAPES:
        a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        meta = compact_activations(a)
        kidx, cnt = compact_activations_ref(a, block_m=meta.block_m,
                                            block_k=meta.block_k)
        if not (torch.equal(meta.kidx, kidx) and torch.equal(meta.cnt, cnt)):
            fail(f"sparse_a_meta differs from the plain metadata at "
                 f"{m} x {k}")
        meta_bytes = 4 * (meta.kidx.numel() + meta.cnt.numel())
        b_ms, b_by = bound(a.numel() * 2 + meta_bytes, a.numel(),
                           "bfloat16")
        row = {"kernel": "sparse_a_meta", "dtype": "bfloat16", "m": m,
               "k": k, "block_m": meta.block_m, "block_k": meta.block_k,
               "slices": meta_slices(min(m, meta.block_m), k,
                                     meta.block_k, 2),
               "max_abs_err": 0.0, "ok": True,
               "ms": timed_ms(torch, lambda: compact_activations(a)),
               "device_ms": device_ms(torch, lambda: compact_activations(a),
                                      "sparse_a_meta"),
               "plain_ms": timed_ms(torch, lambda: compact_activations_ref(
                   a, block_m=meta.block_m, block_k=meta.block_k)),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        print(f"[kernels] {json.dumps(row)}")
        rows.append(row)
    summary["sparse_a_meta"] = dict(rows[0], n=None)   # the decode shape
    return rows


def sparse_a_batch_invariance(torch, gen, w, dtype=None) -> None:
    """Row slices 0:1, 0:4, 3:7, 8:16 and 16:32 of one 32-row A (of
    ``dtype``, default the weight's) give bit-equal rows alone and in the
    full call, at block_m 8 and 128.  The
    rows have different live blocks, so a tile visits blocks a row alone
    skips; row 3 is live only in the last eighth of K, so with a split of
    8 every rank but the last has nothing live for it alone."""
    from repro_torch.kernels import sparse_a_matmul

    k = w.shape[0]
    a = torch.randn(32, k, generator=gen, device=w.device).to(
        dtype or w.dtype)
    for r in range(32):
        a[r, (r % 4) * (k // 4):(r % 4 + 1) * (k // 4)] = 0
    a[3, :k - k // 8] = 0
    for block_m in (8, 128):
        full = sparse_a_matmul(a, w, block_m=block_m)
        for rows in ((0, 1), (0, 4), (3, 7), (8, 16), (16, 32)):
            part = sparse_a_matmul(a[rows[0]:rows[1]].contiguous(), w,
                                   block_m=block_m)
            if not torch.equal(part, full[rows[0]:rows[1]]):
                fail(f"sparse_a is not batch invariant at K x N {k} x "
                     f"{w.shape[1]}, block_m {block_m}, A {a.dtype}: rows "
                     f"{rows} differ from the same rows of a 32-row call")
    print(f"[kernels] sparse_a {k}x{w.shape[1]}: row slices 0:1, 0:4, 3:7, "
          f"8:16, 16:32 of a 32-row {str(a.dtype)[6:]} A bit-equal alone "
          "and in the full call")


def pruned_twin(torch, api, sparsity: float):
    """The served weights as plain tensors: the same seeded draw pruned at
    the same granularity but not compacted (compaction keeps every value,
    so plain torch matmuls on this twin compute what the kernels should)."""
    from repro_torch.sparsity import prune_for, sparsify_params
    return sparsify_params(api.init(api.generator(SEED)), sparsity,
                           compact=False, **prune_for(False))


@contextlib.contextmanager
def plain_route(torch):
    """Every GEMM of the model through its plain PyTorch version on the
    served weights themselves: compacted leaves through griffin_spmm's
    ref.py (decompacted per call), dense ones as plain matmuls.  The
    route for a model whose dense twin does not fit beside its compacted
    weights (mixtral-8x7b's is 93 GB)."""
    from repro_torch.kernels.griffin_spmm.ref import griffin_spmm_ref
    from repro_torch.models import common

    real = common.griffin_matmul
    common.griffin_matmul = lambda a, gw, dual=False: griffin_spmm_ref(a, gw)
    try:
        with common.sparse_execution(use_kernels=False):
            yield
    finally:
        common.griffin_matmul = real


def fp32_prefill(torch, api, params, batch):
    """The last-token prefill logits of the transformer ``params`` with
    every leaf widened to fp32 (compacted ones decompacted) one layer at a
    time, through plain fp32 matmuls: the fp32 model's answer where no
    fp32 twin fits beside the served weights (chameleon-34b's would take
    137 GB); a layer's fp32 leaves are the only copy held."""
    from repro_torch.kernels import GriffinWeights, decompact_weights
    from repro_torch.models import transformer
    from repro_torch.models.common import (griffin_linear, length_mask,
                                           rms_norm, take_last)

    cfg = dataclasses.replace(api.cfg, dtype="float32")

    def wide(t):
        if isinstance(t, GriffinWeights):
            return decompact_weights(t)[:t.k].float()
        return t.float()

    tokens, lengths = batch["tokens"], batch.get("lengths")
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    valid = None if lengths is None else length_mask(lengths, S)
    x = params["embed"][tokens].float()
    with plain_route(torch):
        for i in range(cfg.num_layers):
            lp = {k: wide(v) for k, v in transformer._layer(params, i).items()}
            x = transformer.block_train(cfg, lp, x, positions, valid)[0]
            del lp
        x = rms_norm(x, params["final_norm"].float(), cfg.norm_eps)
        last = x[:, -1] if lengths is None else take_last(x, lengths)
        return griffin_linear(last, wide(transformer.unembed(cfg, params)))


@contextlib.contextmanager
def spied(module, attr: str, wrap):
    """``module.attr`` replaced by ``wrap(real)`` inside the scope."""
    real = getattr(module, attr)
    setattr(module, attr, wrap(real))
    try:
        yield
    finally:
        setattr(module, attr, real)


def build_spy(torch, record: dict):
    """A wrapper of ``sparsity.init_sparse_params`` that records the
    build's seconds, the peak of allocated bytes during it and the bytes
    resident after it."""
    def wrap(real):
        def build(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            record.update(seconds=time.perf_counter() - t0,
                          before_bytes=base,
                          peak_bytes=torch.cuda.max_memory_allocated(),
                          resident_bytes=torch.cuda.memory_allocated())
            return out
        return build
    return wrap


def route_spy(routed: list):
    """A wrapper of ``models.moe.route`` that keeps each drop-free
    (decode) call's expert ids on the device: a reference, so no device
    op and no host sync is added to the run."""
    def wrap(real):
        def route(p, x, moe, drop_free=False, valid=None):
            out = real(p, x, moe, drop_free, valid)
            if drop_free:
                routed.append(out[2])
            return out
        return route
    return wrap


def record_routing(records: list):
    """A wrapper of ``models.moe.top_k`` that keeps each call's chosen
    experts (a reference: no device op, no host sync)."""
    def wrap(real):
        def top_k(p, k):
            vals, idx = real(p, k)
            records.append(idx)
            return vals, idx
        return top_k
    return wrap


def replay_routing(torch, records: list, flips: list):
    """A wrapper of ``models.moe.top_k`` that, call by call, chooses the
    experts ``record_routing`` kept (their probabilities this route's
    own), so two routes are compared GEMM for GEMM under one routing:
    top-k is a step function, and a near tie that the two routes' bf16
    roundings break apart changes a token's experts (and, at the trained
    capacity, which tokens are dropped) where no kernel is wrong.  The
    (token, layer) choices that this route would have made otherwise are
    counted into ``flips``."""
    calls = iter(records)

    def wrap(real):
        def top_k(p, k):
            idx = next(calls)
            own = real(p, k)[1]
            flips.append(int((own != idx).any(-1).sum()))
            return p.gather(-1, idx), idx
        return top_k
    return wrap


def empty_experts(torch, routed: list, experts: int) -> dict:
    """Experts that no row chose, per (layer, decode step), over the
    decode calls ``route_spy`` kept (every slot of the arena routes, live
    or not): what Mode.AB's dual griffin_spmm skips whole."""
    empty = [int((torch.bincount(e, minlength=experts + 1)[:experts] == 0)
                 .sum()) for e in routed]
    if not empty:
        return {"layer_steps": 0}
    return {"layer_steps": len(empty), "mean": sum(empty) / len(empty),
            "min": min(empty), "max": max(empty),
            "share": sum(empty) / (len(empty) * experts)}


def per_calls(count, st) -> int:
    """A gate's total over a run: ``count`` per model call, or a
    (per prefill, per decode step) pair."""
    if isinstance(count, tuple):
        return count[0] * st["prefill_calls"] + count[1] * st["decode_steps"]
    return count * (st["prefill_calls"] + st["decode_steps"])


def fp32_a_spy(counter: list):
    """A wrapper of griffin_spmm's launch (``kernel.griffin_spmm``) that
    counts the launches whose A is fp32 (no device op, no host sync)."""
    def wrap(real):
        def launch(a, *args, **kw):
            counter[0] += a.element_size() == 4
            return real(a, *args, **kw)
        return launch
    return wrap


def phase_serve(torch, name: str, sparsity: float, a_sparsity, mode: str,
                launches: dict, dual, arena: dict, stats=None,
                paged_ref=None, states=None, arch: str = "llama3.2-1b",
                fp32_gap: bool = True, fp32_a=None, layers=None,
                tokens_of=None, served_ref: bool = False, as_served=None,
                max_gap: float = MAX_PLAIN_GAP):
    """Serve the trace on one path and check it: ``launches`` maps each
    kernel to its launches per model call (or per (prefill, decode step)
    pair, :func:`per_calls`), ``dual`` the dual griffin_spmm GEMMs per
    model call, ``fp32_a`` the griffin_spmm launches on fp32 A per
    (prefill, decode step) where given, ``mode`` the engine's Mode, ``arena`` the
    engine's arena and scheduler fields, ``stats`` the counters it must
    give; an int8 path is held against ``paged_ref``, the same-dtype paged
    path's record.  Given ``states``, the run's end state (:func:`end_state`,
    taken before the checks below reuse the engine) goes in it under
    ``name``, for a fault cell to equal.  ``fp32_gap`` off skips the
    routes' gaps to the model widened to fp32 (recurrentgemma-9b's fp32
    twin would take 42 GB beside the served weights and the bf16 twin);
    ``fp32_gap="streamed"`` takes them against the fp32 model computed a
    layer at a time (:func:`fp32_prefill`).  ``max_gap`` bounds the kernel
    route's prefill logit gap to the plain route.
    A family with a streamed build (mixtral-8x7b) reports the build's
    memory and the experts no row chose, and takes its plain route on the
    served weights (:func:`plain_route`); so does a path with
    ``served_ref`` (no dense twin fits beside its served weights), whose
    whole set-up (the build and the trace) is reported the same way.  An
    encoder-decoder (whisper) is held against the cast oracle and its own
    checks (:func:`check_encdec`).  ``layers`` cuts the config's
    depth (printed as a cut; the widths stay the source's).  A path with
    ``tokens_of`` runs no oracle: its caller holds its tokens equal to
    that path's (:func:`check_same_tokens`).  A dense config's compacted
    leaves' K2 routes are printed and gated (:func:`check_routes`), and
    the leaf ``as_served`` names (with True: each stacked leaf whose served
    grid depth differs from the kernel phase's draw, :func:`served_deeper`)
    is checked and timed as served (:func:`served_rows`)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.griffin_spmm import kernel as k2
    from repro_torch.launch import serve as launch
    from repro_torch.models import moe
    from repro_torch.models.common import sparse_execution
    from repro_torch.runtime.config import EngineConfig

    tag = f"[serve {name}]"
    fields = dict(decode_chunk=8, use_kernels=True, a_sparsity=a_sparsity)
    fields.update(arena)
    config = EngineConfig().with_fields(**fields)
    build, routed, f32 = {}, [], [0]
    real_config = launch.get_config

    def config_of(name):
        cfg = real_config(name)
        return cfg if layers is None else \
            dataclasses.replace(cfg, num_layers=layers)
    if layers is not None:
        print(f"{tag} {arch} at full width, num_layers cut "
              f"{real_config(arch).num_layers} -> {layers}")
    # a served_ref path's build (init then sparsify_params, not streamed)
    # is measured around the whole set-up
    build_fn = (launch, "_setup") if served_ref else \
        (launch, "init_sparse_params")
    key = (arch, sparsity, layers)
    kept = kept_weights(torch, key)
    t0 = time.perf_counter()
    with (spied(*build_fn, build_spy(torch, build)) if kept is None else
          contextlib.nullcontext()), \
            spied(launch, "get_config", lambda real: config_of), \
            spied(moe, "route", route_spy(routed)), \
            spied(k2, "griffin_spmm", fp32_a_spy(f32)):
        reset_launch_counts()
        routes0 = k2.route_launches()
        run = launch.serve(arch, sparsity=sparsity, seed=SEED,
                           device="cuda", config=config,
                           params=kept and kept["params"], **TRACE)
        got = launch_counts()
        routes1 = k2.route_launches()
    seconds = {"build and serve": time.perf_counter() - t0}
    kept = keep_weights(tag, key, name, run.params)
    eng = run.engine
    extra = {}
    if arch in K2_LEAVES:
        extra["k2_routes"] = check_routes(
            torch, name, tag, arch, run.params, eng.stats,
            {r: routes1[r] - routes0[r] for r in K2_ROUTES})
    if as_served is not None:
        extra["as_served"] = [
            row for leaf in ([as_served] if isinstance(as_served, str) else
                             served_deeper(tag, arch, run.params))
            for row in served_rows(torch, name, arch, leaf,
                                   run.params["layers"][leaf][0])]
    if layers is not None:
        extra["num_layers"] = eng.api.cfg.num_layers
        if eng.api.cfg.num_layers != layers:
            fail(f"{name}: served {eng.api.cfg.num_layers} layers, not the "
                 f"cut's {layers}")
    if build:
        total = torch.cuda.get_device_properties(0).total_memory
        what = ("streamed build (sparsity.init_sparse_params)"
                if sparsity > 0 and eng.api.draws is not None else
                "build (api.init, then sparsity.sparsify_params)"
                if sparsity > 0 else "build (api.init)")
        print(f"{tag} {what} "
              f"{build['seconds']:.1f}s: peak allocated "
              f"{build['peak_bytes'] / 2**30:.2f} GiB, resident after it "
              f"{build['resident_bytes'] / 2**30:.2f} GiB, of the card's "
              f"{total / 2**30:.2f} GiB")
        if build["peak_bytes"] >= total:
            fail(f"{name}: the build's peak {build['peak_bytes']} B reaches "
                 f"the card's {total} B")
        extra["build"] = build
    if routed:
        extra["empty_experts"] = empty_experts(torch, routed,
                                               eng.api.cfg.moe.num_experts)
        print(f"{tag} experts no row chose, per (layer, decode step): "
              f"{extra['empty_experts']}")
    del routed
    if states is not None:
        states[name] = end_state(eng)
    st = eng.stats
    calls = st["prefill_calls"] + st["decode_steps"]
    print(f"{tag} {arch} full width bf16, weight sparsity "
          f"{eng.b_sparsity:.3f}, declared activation sparsity "
          f"{a_sparsity}, mode {eng.mode.value}, policy {eng.sched.policy},"
          f" {'fused' if eng.fused else 'stepwise'}: {len(run.requests)} "
          f"requests / {st['emitted']} tokens in {run.seconds:.3f}s = "
          f"{run.tokens_per_second:.1f} tok/s; {st['decode_steps']} decode "
          f"steps in {st['chunk_calls']} chunks, {st['prefill_calls']} "
          f"prefills, {run.syncs_per_token:.4f} host syncs/token, peak "
          f"{eng.peak_active} of {eng.num_slots} slots active; launches "
          f"{got}; dispatch {run.dispatch}")
    if eng._paged is not None:
        check_paged_arena(eng)
        extra["kv_bytes"] = kv_bytes(eng)
    if eng.mode.value != mode or len(eng.mode_history) != 1:
        fail(f"{name}: mode {eng.mode_history}, expected {mode} throughout")
    if run.dispatch.get("plain", 0) != 0:
        fail(f"{name}: plain GEMMs on the main path: {run.dispatch}")
    want = {k: per_calls(v, st) for k, v in launches.items()}
    if got != want:
        fail(f"{name}: launches {got}, expected {want} ({calls} model "
             f"calls, {st['prefill_calls']} of them prefills)")
    if run.dispatch.get("dual", 0) != per_calls(dual, st):
        fail(f"{name}: {run.dispatch.get('dual', 0)} dual GEMMs, expected "
             f"{dual} per call over {calls} calls")
    if fp32_a is not None:
        if f32[0] != per_calls(fp32_a, st):
            fail(f"{name}: {f32[0]} griffin_spmm launches on fp32 A, "
                 f"expected {fp32_a} per (prefill, decode step)")
        extra["fp32_a_launches"] = f32[0]
        print(f"{tag} griffin_spmm launches on fp32 A: {f32[0]} = "
              f"{fp32_a[0]} x {st['prefill_calls']} prefills + {fp32_a[1]} "
              f"x {st['decode_steps']} decode steps")
    if eng.fused and run.syncs_per_token > 0.25:
        fail(f"{name}: {run.syncs_per_token:.3f} host syncs per token > "
             "0.25")
    if stats is not None:
        if {k: st[k] for k in stats} != stats:
            fail(f"{name}: stats {st}, expected {stats}")
        print(f"{tag} stats {stats} as on the CPU")
    if eng._paged is not None and eng._paged.kv_dtype == "int8":
        extra.update(check_int8(torch, run, paged_ref))
    elif eng.api.cfg.is_encdec:
        extra.update(check_encdec(torch, run, oracle=tokens_of is None))
    elif tokens_of is None:
        n = launch.check_parity(run)
        print(f"{tag} parity OK: all {n} requests token-identical to the "
              "batch-1 greedy oracle")
    seconds["checks and oracle"] = time.perf_counter() - t0 - \
        sum(seconds.values())

    # no hidden host sync on the hot path: a bucketed prefill (and on a
    # paged arena its admission) and on the fused path a chunk, under
    # CUDA's sync debug mode, which raises on any synchronising call (the
    # engine's one transfer per tick happens outside them)
    req = run.requests[0]
    batch = req.as_batch(eng.device, eng.bucket_for(req.prompt_len))
    prefill_fn, _, chunk_for = eng._fns()
    ids = ()
    if eng._paged is not None:
        eng._flush_dirty()
        ids = eng._page_alloc.reserve(eng._paged.max_pages)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with eng._scope():
            cache1, logits = prefill_fn(run.params, batch)
            if ids:
                eng._insert(0, cache1, logits, 1, ids)
            if eng.fused:
                chunk_for(eng.decode_chunk)(run.params, eng.cache,
                                            eng._tokens, eng._remaining)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"{tag} a prefill{', its admission' if ids else ''}"
          f"{' and a fused chunk' if eng.fused else ''} ran with no host "
          "sync")
    seconds["sync check"] = time.perf_counter() - t0 - sum(seconds.values())

    # what comes out is right: the kernel route's prefill logits against
    # the same model through plain torch matmuls
    routing, flips = [], []
    with eng._scope(), spied(moe, "top_k", record_routing(routing)):
        _, logits = eng.api.prefill(run.params, batch, cache_len=64)
    if eng.api.draws is not None or served_ref:
        # no dense twin fits beside the served weights, or it would crowd
        # the card: the plain versions on the served weights (under the
        # kernel route's routing, where experts route)
        truth = None
        with plain_route(torch), \
                spied(moe, "top_k", replay_routing(torch, routing, flips)):
            _, ref = eng.api.prefill(run.params, batch, cache_len=64)
        if routing:
            extra["routing_flips"] = sum(flips)
            print(f"{tag} the plain route under the kernel route's "
                  f"routing; on its own it would choose other experts for "
                  f"{sum(flips)} of {len(flips)} (layer) x "
                  f"{batch['tokens'].numel()} (token) routings")
    else:
        # the pruned twin's plain and fp32 logits: a later path on the
        # same weights and prompt reuses them
        rkey = (bool(fp32_gap), batch_key(torch, batch))
        if rkey not in kept["refs"]:
            twin = pruned_twin(torch, eng.api, sparsity)
            with sparse_execution(use_kernels=False):
                _, ref = eng.api.prefill(twin, batch, cache_len=64)
                truth = eng.api.prefill(widened(twin), batch,
                                        cache_len=64)[1] if fp32_gap else None
            del twin
            kept["refs"][rkey] = ref, truth
        ref, truth = kept["refs"][rkey]
    rel = rel_l2(logits, ref)
    if logits.shape != (1, eng.api.cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{name}: prefill logits shape {tuple(logits.shape)} or not "
             "finite")
    if rel > max_gap:
        fail(f"{name}: kernel-route logits differ from the plain route by "
             f"{rel:.4f} > {max_gap}")
    # how much of that gap each bf16 route owns: both against the same
    # model with every leaf widened to fp32
    gaps = {"plain": rel, "fp32_kernel": None, "fp32_plain": None}
    if fp32_gap == "streamed":
        truth = fp32_prefill(torch, eng.api, run.params, batch)
    if fp32_gap:
        gaps.update(fp32_kernel=rel_l2(logits, truth),
                    fp32_plain=rel_l2(ref, truth))
        if gaps["fp32_kernel"] > FP32_GAP_RATIO * gaps["fp32_plain"]:
            fail(f"{name}: the kernel route is {gaps['fp32_kernel']:.5f} "
                 f"from the fp32 model, more than {FP32_GAP_RATIO} x the "
                 f"plain route's {gaps['fp32_plain']:.5f}")
    fp32 = ("not measured" if not fp32_gap else
            f"kernel route {gaps['fp32_kernel']:.5f}, plain route "
            f"{gaps['fp32_plain']:.5f}")
    print(f"{tag} prefill logits finite, relative L2 gap to the plain route "
          f"{rel:.5f}; to fp32: {fp32}")
    seconds["logit gaps"] = time.perf_counter() - t0 - sum(seconds.values())
    extra["seconds"] = seconds
    print(f"{tag} seconds: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in seconds.items()))
    return run, got, gaps, extra


def batch_key(torch, batch: dict) -> tuple:
    """A prefill batch's tensors as bytes, to key what it gave."""
    return tuple((k, str(v.dtype), tuple(v.shape), v.cpu().contiguous()
                  .reshape(-1).view(torch.uint8).numpy().tobytes())
                 if isinstance(v, torch.Tensor) else (k, repr(v))
                 for k, v in sorted(batch.items()))


def kept_weights(torch, key: tuple):
    """``WEIGHTS``' entry for ``key`` (arch, sparsity, layers), or None
    once :func:`drop_weights` has made room for its build."""
    kept = WEIGHTS.get(key)
    if kept is None:
        drop_weights(torch, key[0])
    return kept


def keep_weights(tag: str, key: tuple, name: str, params) -> dict:
    """Keep path ``name``'s weights under ``key`` if none are kept yet;
    a later path serving the kept ones says whose they are."""
    kept = WEIGHTS.get(key)
    if kept is None:
        kept = WEIGHTS[key] = {"params": params, "path": name, "refs": {}}
    elif kept["params"] is params:
        print(f"{tag} serves {kept['path']}'s weights (the same seeded "
              "draw), built once")
    return kept


def drop_weights(torch, arch=None) -> None:
    """Before a build for ``arch``: drop the kept weights of every other
    arch, and every tree above ``KEEP_BYTES`` (two trees of a large
    model never share the card); with no ``arch``, all of them."""
    for key in list(WEIGHTS):
        if key[0] != arch or \
                param_bytes(torch, WEIGHTS[key]["params"]) > KEEP_BYTES:
            del WEIGHTS[key]
    gc.collect()
    torch.cuda.empty_cache()


def check_routes(torch, name: str, tag: str, arch: str, params, st,
                 taken: dict) -> dict:
    """The K2 route of every compacted leaf ``params`` serves, by the
    Python mirror (``griffin_spmm.kernel.route``) on a bf16 A as wide as
    the leaf's K: each layer slice of a stacked leaf shares the stack's
    grid depth (the deepest member's), so its route.  Counted by leaf,
    shape and route and printed; every leaf's shape is one the kernel
    phase holds the mirror against (``K2_LEAVES``).  Each slice runs once
    a model call, so ``taken``, the run's launches per route as the C++
    entry counts them, must be the slices on each route times the calls."""
    from repro_torch.kernels import GriffinWeights
    from repro_torch.kernels.griffin_spmm.kernel import MAX_SMEM, route

    shapes = set(K2_LEAVES[arch].values())
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                walk(sub, path + (key,))
            return
        if not isinstance(tree, GriffinWeights):
            return
        if (tree.k, tree.n) not in shapes:
            fail(f"{tag} leaf {'/'.join(path)} {tree.k}x{tree.n} is not a "
                 f"shape of the kernel phase's {sorted(shapes)}")
        lead = tree.b_comp.shape[:-2]
        members = [tree] if not lead else [tree[i] for i in range(lead[0])]
        a = torch.empty(1, tree.k, dtype=torch.bfloat16, device="cuda")
        for gw in members:
            r = route(a, gw.b_comp, gw.kidx, n=gw.n, block_k=gw.block_k,
                      block_n=gw.block_n)
            key = f"{path[-1]} {gw.k}x{gw.n}"
            row = out.setdefault(key, {"tc": 0, "core": 0,
                                       "depth": gw.kidx.shape[-1],
                                       "smem": r.smem})
            row[r.name] += 1

    walk(params, ())
    calls = st["prefill_calls"] + st["decode_steps"]
    want = {r: calls * sum(row[r] for row in out.values())
            for r in K2_ROUTES}
    print(f"{tag} K2 routes by leaf (layer slices on the tensor-core and "
          f"the CUDA-core route; grid depth; tensor-core shared memory of "
          f"{MAX_SMEM} B at most): {json.dumps(out)}; launches by route "
          f"{taken}, as predicted")
    if taken != want:
        fail(f"{name}: griffin_spmm launched {taken} by route, the mirror "
             f"predicts {want} over {calls} model calls")
    return {"leaves": out, "launches": taken}


def phase_dense_configs(torch, clock, serves: dict, paths=DENSE_PATHS,
                        profile_steps=None) -> None:
    """Serve ``paths`` (the dense configs', or ``VLM_PATHS``) in order,
    each path's record into ``serves`` and its seconds on the clock; a
    path with ``tokens_of`` runs no oracle of its own and must give that
    earlier path's tokens.  With ``profile_steps`` each path also profiles
    a fused chunk of that many decode steps (:func:`chunk_profile`)."""
    tokens = {}
    for name, path in paths.items():
        tokens_of = path.get("tokens_of")
        run, launches, gaps, extra = phase_serve(torch, name, **path)
        if profile_steps:
            extra["profile"] = chunk_profile(torch, name, run, profile_steps)
        if "--profile" in sys.argv[1:]:
            phase_profile(torch, name, run)
        serves[name] = serve_record(run, launches, gaps, extra)
        tokens[name] = {r: o.tokens for r, o in run.engine.outputs.items()}
        if tokens_of is not None:
            check_same_tokens(name, run, tokens[tokens_of], tokens_of)
        del run
        gc.collect()            # an engine's closures hold it in a cycle
        torch.cuda.empty_cache()
        clock.done(name)


def greedy_from(api, params, cache, first, steps: int):
    """``steps`` greedy tokens from a prefilled batch-1 ``cache`` whose
    prefill logits gave ``first`` (1, 1): the tokens and the first decode
    step's logits (None for one token).  Decoding writes ``cache``'s K/V
    in place."""
    toks, logits1 = [first], None
    for _ in range(steps - 1):
        logits, cache = api.decode_step(params, cache, toks[-1])
        if logits1 is None:
            logits1 = logits.float()
        toks.append(logits.argmax(-1)[:, None])
    return [int(t) for t in toks], logits1


def check_encdec(torch, run, oracle: bool = True) -> dict:
    """An encoder-decoder path's checks.  With ``oracle``, every
    request's tokens equal a batch-1 greedy oracle that decodes from its
    bucketed prefill's cache cast leaf by leaf to ``init_cache``'s dtypes,
    as the engine's admission writes it into the arena (the encoder's fp32
    cross K/V rounded to bf16): the engine's own computation.  Beside it,
    from the same prefill, the uncast loop of ``greedy_generate`` (the
    reference's oracle, which decodes the fp32 cross K/V) is printed, not
    gated: its tokens that differ and the first decode step's largest
    logit gap (:func:`encdec_oracle`; without ``oracle`` the caller holds
    the tokens equal to another path's).  Then the dtype flow (the
    prefill's cross K/V fp32, the arena's bf16) and one admission's memory
    rise over the allocated level before it, the encoder's attention over
    the frames included, within ``MAX_ADMIT_RISE``."""
    eng = run.engine
    api = eng.api
    tag = f"[serve {api.cfg.name}]"
    dts = {k: v.dtype for k, v in api.init_cache(
        1, eng.cache_len, device=torch.device("meta")).items()}
    record = encdec_oracle(torch, run, dts) if oracle else {}
    if eng.cache["xk"].dtype != dts["xk"] or dts["xk"] != torch.bfloat16:
        fail(f"{api.cfg.name}: the arena's cross K/V are "
             f"{eng.cache['xk'].dtype}, init_cache's {dts['xk']}")
    # one admission: the prefill (the encoder over every frame) and the
    # insert into a free slot
    req = run.requests[0]
    ids = ()
    if eng._paged is not None:
        eng._flush_dirty()
        ids = eng._page_alloc.reserve(eng._paged.pages_needed(
            req.prompt_len + req.max_new_tokens))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    cache1, logits = eng._prefill(req)
    if cache1["xk"].dtype != torch.float32:
        fail(f"{api.cfg.name}: the prefill's cross K/V are "
             f"{cache1['xk'].dtype}, not the encoder's fp32")
    eng._insert(0, cache1, logits, 1, ids)
    del cache1, logits
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t1
    rise = torch.cuda.max_memory_allocated() - base
    if ids:
        eng._page_alloc.free(ids)
    if rise > MAX_ADMIT_RISE:
        fail(f"{api.cfg.name}: one admission raised allocated memory by "
             f"{rise} B > {MAX_ADMIT_RISE}")
    print(f"{tag} dtype flow as the reference's: encoder GEMM inputs fp32, "
          f"the prefill's cross K/V fp32, the arena's {dts['xk']}; one "
          f"admission ({api.cfg.enc_frames} frames) {admit_s:.3f}s, memory "
          f"rise {rise / 2**30:.3f} GiB")
    return {**record, "admission_s": admit_s, "admission_rise_bytes": rise}


def encdec_oracle(torch, run, dts: dict) -> dict:
    """:func:`check_encdec`'s oracle: every request's tokens against the
    batch-1 greedy decode of its prefill's cache cast to ``dts`` (gated)
    and of the uncast cache (printed)."""
    eng = run.engine
    api, params = eng.api, run.params
    tag = f"[serve {api.cfg.name}]"
    differ, gaps, t0 = 0, [], time.perf_counter()
    for r in run.requests:
        batch = r.as_batch(eng.device, eng.bucket_for(r.prompt_len))
        with eng._scope():
            cache, logits = api.prefill(params, batch,
                                        cache_len=eng.cache_len)
            if cache["xk"].dtype != torch.float32:
                fail(f"{api.cfg.name}: the prefill's cross K/V are "
                     f"{cache['xk'].dtype}, not the encoder's fp32")
            first = logits.argmax(-1)[:, None]
            cast = {k: v.to(dts[k], copy=True) for k, v in cache.items()}
            want, cast1 = greedy_from(api, params, cast, first,
                                      r.max_new_tokens)
            del cast
            plain, plain1 = greedy_from(api, params, cache, first,
                                        r.max_new_tokens)
            del cache
        got = eng.outputs[r.rid].tokens
        if got != want:
            fail(f"{api.cfg.name}: request {r.rid} diverged from the cast "
                 f"oracle: {got} vs {want}")
        differ += sum(a != b for a, b in zip(plain, want))
        if cast1 is not None:
            gaps.append(float((cast1 - plain1).abs().max()))
    oracle_s = time.perf_counter() - t0
    n = sum(r.max_new_tokens for r in run.requests)
    print(f"{tag} parity OK: all {len(run.requests)} requests "
          f"token-identical to the batch-1 oracle on the cast cache "
          f"({oracle_s:.1f}s); the uncast greedy_generate loop (fp32 cross "
          f"K/V) gives {differ} of {n} tokens differently, first decode "
          f"step's largest logit gap {max(gaps, default=0.0):.5f}")
    return {"uncast_tokens_differ": differ, "uncast_first_step_gap":
            max(gaps, default=0.0), "oracle_s": oracle_s}


def serve_record(run, launches, gaps, extra) -> dict:
    """What the report keeps of one serve path."""
    return {"stats": run.engine.stats, "seconds": run.seconds,
            "tokens_per_second": run.tokens_per_second,
            "syncs_per_token": run.syncs_per_token,
            "peak_active": run.engine.peak_active, "launches": launches,
            "dispatch": run.dispatch, "logits_rel_l2": gaps, **extra}


def end_state(eng) -> dict:
    """What an engine run ended with, for a faulted run of the same trace
    to equal: tokens per rid, stats, Mode history, and host copies of the
    device state (arena, feedback tokens, owed-token counters) with the
    paged arena's DUMP page left out (writes from dead rows land there in
    no fixed order, and it is never read)."""
    spec = eng._paged
    dev = dict(eng.cache, tokens=eng._tokens, remaining=eng._remaining)
    for k, v in dev.items():
        if spec is not None and k.removesuffix("_scale") in spec.paged_keys:
            v = v[:, 1:]
        dev[k] = v.to("cpu", copy=True)
    return {"tokens": {rid: o.tokens for rid, o in eng.outputs.items()},
            "stats": dict(eng.stats),
            "mode_history": [(s, m.value) for s, m in eng.mode_history],
            "device": dev}


def phase_fault(torch, name: str, card: str, unfaulted: dict, path: str,
                phase: str, at: int, replayed: int, requests: int = 8,
                snapshot_dir=None) -> dict:
    """Serve one fault cell (FAULT_CELLS) through launch.serve with
    ``kill:0@<at>:<phase>`` and hold it: the kill fired once at clock
    ``at``, one recovery with the reference's log entry, ``replayed``
    model calls replayed; launches exactly the path's per model call over
    every call made (the replayed ones included); no plain GEMM; tokens,
    stats, Mode history and the final device state bit-equal to the
    unfaulted run's (``unfaulted``: the path's record; the disk cell runs
    its own unfaulted engine on the same requests).  The disk cell also
    reads the scheduler and paging state back from the newest snapshot's
    manifest; the snapshots' arrays are deleted at the end, the manifests
    kept."""
    import shutil
    import statistics

    from repro_torch.checkpoint import read_manifest
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import Scheduler, ServeEngine
    from repro_torch.runtime.paging import PageAllocator

    tag = f"[fault {name}]"
    cell = PATHS[path]
    inject = f"kill:0@{at}:{phase}"
    snap = ROOT / snapshot_dir if snapshot_dir is not None else None
    fields = dict(decode_chunk=8, use_kernels=True,
                  a_sparsity=cell["a_sparsity"], inject=inject,
                  snapshot_dir=None if snap is None else str(snap))
    fields.update(cell["arena"])
    config = EngineConfig().with_fields(**fields)
    t0 = time.perf_counter()
    if snap is not None:
        shutil.rmtree(snap, ignore_errors=True)
    key = ("llama3.2-1b", cell["sparsity"], None)
    kept = kept_weights(torch, key)
    reset_launch_counts()
    try:
        run = launch.serve("llama3.2-1b", sparsity=cell["sparsity"],
                           device="cuda", config=config,
                           params=kept and kept["params"],
                           **dict(TRACE, requests=requests))
        got = launch_counts()
        keep_weights(tag, key, name, run.params)
        eng = run.engine
        if snap is not None:
            man = read_manifest(str(snap))
            sched = Scheduler.from_state_dict(man["extra"]["scheduler"])
            alloc = PageAllocator.from_state_dict(
                man["extra"]["paging"]["allocator"])
            print(f"{tag} newest snapshot: step {man['step']}, "
                  f"{len(man['keys'])} arrays; manifest scheduler: "
                  f"{sched.num_slots} slots, {len(sched.running)} running, "
                  f"{sched.waiting_count} waiting; paging: "
                  f"{alloc.num_pages - 1 - alloc.free_pages} pages held")
            if sched.num_slots != eng.num_slots or \
                    alloc.num_pages != eng._paged.num_pages:
                fail(f"{name}: the manifest's scheduler or paging state "
                     "is not the engine's")
            fresh = ServeEngine(eng.api, run.params, eng.config.with_fields(
                inject=None, snapshot_dir=None))
            fresh.run(run.requests)
            unfaulted = end_state(fresh)
    except Exception as e:                  # noqa: BLE001 - any is a failure
        fail(f"{name}: the faulted run raised {e!r}")
    finally:
        if snap is not None:
            for npz in snap.glob("*/arrays.npz"):
                npz.unlink()
    st = eng.stats
    calls = st["prefill_calls"] + st["decode_steps"]
    made = calls + eng.replayed_calls
    inj = eng.faults
    cap_ms = statistics.median(eng.capture_s) * 1e3
    log = [{"step": at, "lost": [0], "mesh": "unsharded"}]
    save = (f", disk save median {statistics.median(eng.save_s):.3f} s "
            f"over {len(eng.save_s)} saves" if eng.save_s else "")
    print(f"{tag} {card}: {inject} on {path}'s engine, {len(run.requests)} "
          f"requests: fired at clock {inj.fired_at}, recovery_log "
          f"{eng.recovery_log}; {made} model calls made = {calls} kept + "
          f"{eng.replayed_calls} replayed; launches {got} = per call "
          f"{cell['launches']} x {made}; capture median {cap_ms:.3f} ms of "
          f"{eng.snapshot_bytes} B over {len(eng.capture_s)} ticks{save}; "
          f"{st['emitted']} tokens in {run.seconds:.3f}s = "
          f"{run.tokens_per_second:.1f} tok/s (not gated)")
    if inj.fired_at != at or eng.recoveries != 1 or eng.recovery_log != log:
        fail(f"{name}: fired at {inj.fired_at}, {eng.recoveries} "
             f"recoveries, log {eng.recovery_log}; expected {at}, 1, {log}")
    if eng.replayed_calls != replayed:
        fail(f"{name}: {eng.replayed_calls} model calls replayed, expected "
             f"{replayed}")
    want = {k: v * made for k, v in cell["launches"].items()}
    if got != want:
        fail(f"{name}: launches {got}, expected {want} ({made} model calls)")
    if run.dispatch.get("plain", 0) != 0:
        fail(f"{name}: plain GEMMs on the main path: {run.dispatch}")
    if run.dispatch.get("dual", 0) != cell["dual"] * made:
        fail(f"{name}: {run.dispatch.get('dual', 0)} dual GEMMs, expected "
             f"{cell['dual']} x {made}")
    end = end_state(eng)
    for key in ("stats", "mode_history"):
        if end[key] != unfaulted[key]:
            fail(f"{name}: {key} {end[key]}, unfaulted {unfaulted[key]}")
    for r in run.requests:
        if end["tokens"][r.rid] != unfaulted["tokens"][r.rid]:
            fail(f"{name}: request {r.rid} gave {end['tokens'][r.rid]}, "
                 f"unfaulted {unfaulted['tokens'][r.rid]}")
    for k, v in unfaulted["device"].items():
        if not torch.equal(end["device"][k], v):
            fail(f"{name}: device state {k!r} differs from the unfaulted "
                 "run's")
    print(f"{tag} tokens, stats {st}, Mode history and the final device "
          f"state ({', '.join(sorted(end['device']))}) bit-equal to the "
          f"unfaulted run's; phase {time.perf_counter() - t0:.1f}s")
    return {"launches": got, "recovery_log": eng.recovery_log,
            "model_calls": made, "replayed_calls": eng.replayed_calls,
            "capture_ms_median": cap_ms, "snapshot_bytes": eng.snapshot_bytes,
            "captures": len(eng.capture_s), "save_s": list(eng.save_s),
            "seconds": run.seconds,
            "tokens_per_second": run.tokens_per_second}


def kv_bytes(eng) -> int:
    """Bytes of the paged arena's K/V pools and their scales."""
    keys = [k for k in eng.cache
            if k.removesuffix("_scale") in eng._paged.paged_keys]
    return sum(eng.cache[k].numel() * eng.cache[k].element_size()
               for k in keys)


def check_int8(torch, run, paged_ref) -> dict:
    """The int8 path's gates in place of oracle parity: each request's
    tokens equal those of a one-slot int8 engine serving it alone (row
    quantization reads only its own row); the teacher-forced logit gap to
    same-dtype pages within INT8_TOL; the pools plus scales at (row + 4) /
    (row x the cache's element size) of the same-dtype arena's bytes, (512
    + 4) / 1024 at full width.  The token match with the
    same-dtype paged path is printed, not gated: top-2 ties are common at
    vocab 128256."""
    from repro_torch.runtime.engine import ServeEngine, int8_logit_gap

    eng = run.engine
    tag = "[serve int8]"
    alone = ServeEngine(eng.api, run.params, eng.config.with_fields(
        num_slots=1, num_pages=None, max_admissions_per_step=1))
    outs = alone.run(run.requests)
    for r in run.requests:
        if outs[r.rid].tokens != eng.outputs[r.rid].tokens:
            fail(f"int8 pages: request {r.rid} served alone gave "
                 f"{outs[r.rid].tokens}, in the batch "
                 f"{eng.outputs[r.rid].tokens}")
    print(f"{tag} every request token-identical to a one-slot int8 "
          f"engine serving it alone ({alone.stats['emitted']} tokens)")
    gap = int8_logit_gap(eng.api, run.params, eng.config.with_fields(
        cache_len=INT8_GAP["cache_len"], num_pages=None),
        steps=INT8_GAP["steps"], plen=INT8_GAP["plen"])
    print(f"{tag} teacher-forced relative logit gap to same-dtype pages "
          f"{gap:.6f} (limit {INT8_TOL})")
    if not gap <= INT8_TOL:
        fail(f"int8 pages: logit gap {gap} > {INT8_TOL}")
    match = sum(eng.outputs[r.rid].tokens == paged_ref["tokens"][r.rid]
                for r in run.requests) / len(run.requests)
    nbytes = kv_bytes(eng)
    ratio = nbytes / paged_ref["kv_bytes"]
    cfg = eng.api.cfg
    row = cfg.num_kv_heads * cfg.hd           # one K or V token row
    esz = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    want = (row + 4) / (row * esz)
    print(f"{tag} token match with same-dtype pages {match:.3f} (printed, "
          f"not gated); K/V pools + scales {nbytes} B against "
          f"{paged_ref['kv_bytes']} B = {ratio:.6f}")
    if ratio != want:
        fail(f"int8 pages: {ratio} of the same-dtype bytes, expected "
             f"{want}")
    return {"alone_tokens_equal": True, "logit_gap": gap,
            "token_match_same_dtype": match, "kv_bytes_ratio": ratio}


def check_paged_arena(eng) -> None:
    """The paged path holds more requests at once in no more KV rows than
    the fixed arena of sparse_b."""
    from repro_torch.runtime.config import EngineConfig

    spec = eng._paged
    fixed_len = EngineConfig.derive_cache_len(TRACE["prompt_lens"],
                                              TRACE["gen_lens"])
    fixed_rows = FIXED["num_slots"] * fixed_len
    rows = spec.usable_pages * spec.page_size
    print(f"[serve paged] {spec.num_pages} {spec.kv_dtype} pages of "
          f"{spec.page_size} ({spec.usable_pages} usable + DUMP) = {rows} "
          f"KV rows against {FIXED['num_slots']} x {fixed_len} = "
          f"{fixed_rows} fixed; cache_len {eng.cache_len} = "
          f"{spec.max_pages} pages; peak {eng.peak_active} slots active")
    if (eng.cache_len, spec.max_pages) != (64, 4) or rows > fixed_rows:
        fail(f"paged arena: cache_len {eng.cache_len}, {spec.max_pages} "
             f"pages per slot, {rows} KV rows against {fixed_rows} fixed")
    if eng.peak_active <= FIXED["num_slots"]:
        fail(f"paged arena peaked at {eng.peak_active} active slots, not "
             f"above the fixed arena's {FIXED['num_slots']}")


def check_paged_degrades(run, fixed_tokens) -> None:
    """A paged config on the xlstm family: no cache leaf tracks cache_len,
    so the engine keeps the fixed arena (as the reference's does) and
    serves the fixed arena's tokens."""
    eng = run.engine
    if eng.config.arena.page_size is None or eng._paged is not None or \
            "pages" in eng.cache:
        fail(f"xlstm_paged_degrades: page_size {eng.config.arena.page_size}"
             f", paged spec {eng._paged}")
    print(f"[serve xlstm_paged_degrades] page_size "
          f"{eng.config.arena.page_size} asked, no paged arena built (no "
          "cache leaf tracks cache_len)")
    check_same_tokens("xlstm_paged_degrades", run, fixed_tokens,
                      "xlstm_sparse_b")


def check_same_tokens(name: str, run, want: dict, of: str) -> None:
    """Every request's tokens on ``run`` equal ``want``, path ``of``'s."""
    tokens = {r: o.tokens for r, o in run.engine.outputs.items()}
    if tokens != want:
        fail(f"{name}: tokens differ from {of}'s")
    print(f"[serve {name}] all {len(tokens)} requests' tokens equal "
          f"{of}'s")


def phase_long_window(torch, run, name: str, long: dict, launches: dict,
                      sparsity: float, replay: bool = True):
    """A model past its window, on ``run``'s weights (recurrentgemma-9b's
    ``HYBRID_LONG``, mixtral-8x7b's ``MOE_LONG``): one ``long["prompt"]``-
    token prompt straight through the model's prefill with a cache_len
    above the window, so the K/V cache keeps the last window rolled by S %
    window, then decode steps fed seeded ids, which write slot pos %
    window and wrap the rolling cache.  The same calls on the plain route
    (the pruned weights uncompacted, or where that twin does not fit, the
    plain versions on the compacted weights): the logits within 2 %
    relative L2 at the prefill and at every step, every K/V cache row
    within MAX_ROW_GAP; seconds, the memory rise over the level before
    the calls (within 3 GiB) and ``launches`` per model call.  A moe
    model's plain route takes the kernel route's expert choices
    (:func:`replay_routing`); ``replay=False`` lets it route on its own
    and reports the gaps without gating them."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.common import sparse_execution

    eng = run.engine
    api = eng.api
    S, clen, steps = (long[k] for k in ("prompt", "cache_len", "steps"))
    from repro_torch.models import moe

    window = api.cfg.window
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = {"tokens": torch.randint(1, api.cfg.vocab_size, (1, S),
                                     generator=gen, device="cuda")}
    feed = torch.randint(1, api.cfg.vocab_size, (1, steps), generator=gen,
                         device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    routing, flips = [], []
    t0 = time.perf_counter()
    with eng._scope(), spied(moe, "top_k", record_routing(routing)):
        cache, logits = api.prefill(run.params, batch, cache_len=clen)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        outs = [logits]
        for t in range(steps):
            logits, cache = api.decode_step(run.params, cache,
                                            feed[:, t:t + 1])
            outs.append(logits)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rise = torch.cuda.max_memory_allocated() - base
    got = launch_counts()
    want = {k: v * (1 + steps) for k, v in launches.items()}
    if api.draws is not None:
        # the plain versions on the served weights, under the kernel
        # route's routing (:func:`replay_routing`)
        twin, plain = run.params, contextlib.ExitStack()
        plain.enter_context(plain_route(torch))
        if replay:
            plain.enter_context(spied(moe, "top_k", replay_routing(
                torch, routing, flips)))
    else:
        twin = pruned_twin(torch, api, sparsity)
        plain = sparse_execution(use_kernels=False)
    t1 = time.perf_counter()
    with plain:
        ref_cache, ref = api.prefill(twin, batch, cache_len=clen)
        gaps = [rel_l2(outs[0], ref)]
        for t in range(steps):
            ref, ref_cache = api.decode_step(twin, ref_cache,
                                             feed[:, t:t + 1])
            gaps.append(rel_l2(outs[t + 1], ref))
    plain_s = time.perf_counter() - t1
    del twin
    row_gap = max(rows_rel_l2(cache[t], ref_cache[t]) for t in "kv")
    print(f"[{name}] {S}-token prompt, cache_len {clen} > "
          f"window {window}: K/V cache {tuple(cache['k'].shape)} rolled by "
          f"{S % window}; prefill {prefill_s:.3f}s, with {steps} decode "
          f"steps (slots {(S) % window}..{(S + steps - 1) % window}) "
          f"{seconds:.3f}s (the plain route's {plain_s:.3f}s); memory rise "
          f"{rise / 2**30:.3f} GiB over "
          f"{base / 2**30:.3f} GiB; launches {got}; logits relative L2 "
          f"gap to the plain route: prefill {gaps[0]:.5f}, steps "
          f"{', '.join(f'{g:.5f}' for g in gaps[1:])}; largest per-row "
          f"gap of the K/V cache {row_gap:.5f}"
          + (f"; the plain route under the kernel route's routing, which "
             f"it would have left in {sum(flips)} (token, layer) choices of"
             f" {S + steps} x {len(flips) // (1 + steps)}" if flips else "")
          + ("" if replay else "; free routing: reported, not gated"))
    record = {"prompt": S, "cache_len": clen, "prefill_seconds": prefill_s,
              "seconds": seconds, "plain_seconds": plain_s,
              "memory_rise_bytes": rise,
              "memory_before_bytes": base, "launches": got,
              "logits_rel_l2": gaps, "cache_row_rel_l2": row_gap,
              "routing_flips": sum(flips) if flips else None}
    if not replay:
        return record
    if tuple(cache["k"].shape[1:3]) != (1, window) or \
            int(cache["pos"]) != S - 1 + steps:
        fail(f"{name}: cache {tuple(cache['k'].shape)}, pos "
             f"{int(cache['pos'])}")
    if rise > MAX_PREFILL_RISE:
        fail(f"{name}: memory rise {rise} B > "
             f"{MAX_PREFILL_RISE} B")
    if got != want:
        fail(f"{name}: launches {got}, expected {want}")
    if not all(bool(torch.isfinite(o).all()) for o in outs) or \
            outs[0].shape != (1, api.cfg.vocab_size):
        fail(f"{name}: logits not finite or of the wrong shape")
    if max(gaps) > 2e-2:
        fail(f"{name}: kernel-route logits differ from the "
             f"plain route by {max(gaps):.4f}")
    if row_gap > MAX_ROW_GAP:
        fail(f"{name}: a K/V cache row of the kernel route "
             f"differs from the plain route's by {row_gap:.4f}")
    return record


def phase_xlstm_prefill(torch, run):
    """xlstm-1.3b's prefill on ``run``'s weights at the trace's largest
    bucket (32 tokens, one chunk) and at 256 tokens (four 64-token
    chunks): seconds, the rise of max_memory_allocated over the level
    before the call (within the long_prefill gate's 3 GiB), and the
    sLSTM blocks' share of the 32-token prefill's wall time (each block
    bracketed by synchronisations in a second, instrumented call)."""
    from repro_torch.models import xlstm

    eng = run.engine
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for S in (32, 256):
        batch = {"tokens": torch.randint(1, eng.api.cfg.vocab_size, (1, S),
                                         generator=gen, device="cuda")}
        with eng._scope():
            eng.api.prefill(run.params, batch)          # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with eng._scope():
            _, logits = eng.api.prefill(run.params, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rise = torch.cuda.max_memory_allocated() - base
        if rise > MAX_PREFILL_RISE or not bool(torch.isfinite(logits).all()):
            fail(f"xlstm prefill {S}: memory rise {rise} B (gate "
                 f"{MAX_PREFILL_RISE} B) or logits not finite")
        out[S] = {"seconds": seconds, "memory_rise_bytes": rise}
    slstm_s = []
    seq = xlstm.slstm_seq

    def timed_slstm(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = seq(*args, **kw)
        torch.cuda.synchronize()
        slstm_s.append(time.perf_counter() - t)
        return res

    xlstm.slstm_seq = timed_slstm
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with eng._scope():
            eng.api.prefill(run.params, {"tokens": torch.randint(
                1, eng.api.cfg.vocab_size, (1, 32), generator=gen,
                device="cuda")})
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        xlstm.slstm_seq = seq
    out["slstm_share_32"] = sum(slstm_s) / total
    print(f"[xlstm prefill] 32 tokens: {out[32]['seconds']:.4f}s, memory "
          f"rise {out[32]['memory_rise_bytes'] / 2**30:.3f} GiB; 256 tokens "
          f"(4 chunks): {out[256]['seconds']:.4f}s, memory rise "
          f"{out[256]['memory_rise_bytes'] / 2**30:.3f} GiB; the "
          f"{len(slstm_s)} sLSTM blocks take {sum(slstm_s):.4f}s of "
          f"{total:.4f}s = {out['slstm_share_32']:.3f} of an instrumented "
          "32-token prefill")
    return out


def phase_long_prefill(torch, run):
    """Prefill 2048 and 4096 tokens at full width on ``run``'s weights:
    seconds, memory rise over the level before the call, launches, and
    the last-token logits against the plain-matmul route."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.common import sparse_execution

    eng = run.engine
    api = eng.api
    twin = pruned_twin(torch, api, SB["sparsity"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for S in LONG_PROMPTS:
        batch = {"tokens": torch.randint(1, api.cfg.vocab_size, (1, S),
                                         generator=gen, device="cuda")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launch_counts()
        t0 = time.perf_counter()
        with eng._scope():
            cache, logits = api.prefill(run.params, batch, cache_len=S)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rise = torch.cuda.max_memory_allocated() - base
        got = launch_counts()
        with sparse_execution(use_kernels=False):
            ref_cache, ref = api.prefill(twin, batch, cache_len=S)
        rel = rel_l2(logits, ref)
        row_gap = max(rows_rel_l2(cache[t], ref_cache[t]) for t in "kv")
        del cache, ref_cache
        print(f"[long_prefill] {S} tokens: {seconds:.3f}s, memory rise "
              f"{rise / 2**30:.3f} GiB over {base / 2**30:.3f} GiB, "
              f"launches {got}, logits relative L2 gap to the plain route "
              f"{rel:.5f}, largest per-row gap of the K/V cache "
              f"{row_gap:.5f}")
        if rise > MAX_PREFILL_RISE:
            fail(f"long_prefill {S}: memory rise {rise} B > "
                 f"{MAX_PREFILL_RISE} B")
        if got != SB_LAUNCHES:
            fail(f"long_prefill {S}: launches {got}, expected {SB_LAUNCHES}")
        if logits.shape != (1, api.cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            fail(f"long_prefill {S}: logits shape {tuple(logits.shape)} or "
                 "not finite")
        if rel > 2e-2:
            fail(f"long_prefill {S}: kernel-route logits differ from the "
                 f"plain route by {rel:.4f}")
        if row_gap > MAX_ROW_GAP:
            fail(f"long_prefill {S}: a K/V cache row of the kernel route "
                 f"differs from the plain route's by {row_gap:.4f}")
        out[S] = {"seconds": seconds, "memory_rise_bytes": rise,
                  "memory_before_bytes": base, "launches": got,
                  "logits_rel_l2": rel, "cache_row_rel_l2": row_gap}
    return out


def param_bytes(torch, tree) -> int:
    """Bytes of every tensor in a parameter tree (compacted leaves
    included)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(param_bytes(torch, v) for v in tree.values())
    if dataclasses.is_dataclass(tree):
        return sum(param_bytes(torch, getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


def phase_router(torch, name: str, sparsity: float, a_sparsity, mode: str,
                 launches: dict, dual: int, fields: dict, trace: dict,
                 parity):
    """Route one cell's trace through launch.serve.route and check it: the
    replicas share the weights; every engine built stays in ``mode``; the
    launches over every engine built equal ``launches`` per model call;
    the router's record equals ROUTER_ROWS or ROUTER_RECORDS; the
    completed requests (``parity``: those rids) equal the batch-1 oracle;
    every cancel the router makes runs under CUDA's sync debug mode and
    is logged as (rid, what it found: "running", "waiting" or "none")."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.config import EngineConfig
    from repro_torch.runtime.engine import ServeEngine

    tag = f"[router {name}]"
    config = EngineConfig().with_fields(use_kernels=True,
                                        a_sparsity=a_sparsity, **fields)
    cancels = []
    cancel = ServeEngine.cancel

    def guarded(self, rid):
        running = any(r.rid == rid for r in self.sched.running.values())
        torch.cuda.set_sync_debug_mode("error")
        try:
            hit = cancel(self, rid)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        cancels.append((rid, "running" if running else
                        "waiting" if hit else "none"))
        return hit

    key = ("llama3.2-1b", sparsity, None)
    kept = kept_weights(torch, key)
    t0 = time.perf_counter()
    ServeEngine.cancel = guarded
    reset_launch_counts()
    try:
        run = launch.route("llama3.2-1b", sparsity=sparsity, device="cuda",
                           config=config, params=kept and kept["params"],
                           **trace)
    except Exception as e:                  # noqa: BLE001 - any is a failure
        fail(f"{name}: the routed run raised {e!r}")
    finally:
        ServeEngine.cancel = cancel
    got = launch_counts()
    keep_weights(tag, key, name, run.params)
    router = run.router
    calls = run.model_calls
    summary = run.summary()
    wbytes = param_bytes(torch, run.params)
    print(f"{tag} llama3.2-1b full width bf16, weight sparsity "
          f"{run.engines[0].b_sparsity:.3f}, declared activation sparsity "
          f"{a_sparsity}, mode {run.engines[0].mode.value}: "
          f"{fields['replicas']} replicas x {fields['num_slots']} slots, "
          f"{len(run.requests)} requests over {router.clock} ticks in "
          f"{run.seconds:.3f}s; {run.delivered} tokens delivered = "
          f"{run.tokens_per_second:.1f} tok/s ({run.total('emitted')} "
          f"emitted = {run.total('emitted') / run.seconds:.1f} tok/s over "
          f"the engines); {len(run.engines)} engines "
          f"built, {calls} model calls, {run.syncs_per_token:.4f} host "
          f"syncs/token over the engines; stats {router.stats}; launches "
          f"{got}; dispatch {run.dispatch}")
    print(f"{tag} replicas took {run.build_bytes / 2**20:.1f} MiB over "
          f"{wbytes / 2**20:.1f} MiB of weights")
    if run.build_bytes >= wbytes / 2:
        fail(f"{name}: building the replicas took {run.build_bytes} B, not "
             f"less than half of the {wbytes} B of weights: the replicas "
             "do not share them")
    for eng in run.engines:
        if eng.mode.value != mode or len(eng.mode_history) != 1:
            fail(f"{name}: an engine ran {eng.mode_history}, expected "
                 f"{mode} throughout")
    if run.dispatch.get("plain", 0) != 0:
        fail(f"{name}: plain GEMMs on the main path: {run.dispatch}")
    want = {k: v * calls for k, v in launches.items()}
    if got != want:
        fail(f"{name}: launches {got}, expected {want} ({calls} model calls "
             f"over {len(run.engines)} engines)")
    if run.dispatch.get("dual", 0) != dual * calls:
        fail(f"{name}: {run.dispatch.get('dual', 0)} dual GEMMs, expected "
             f"{dual} x {calls}")
    if name in ROUTER_ROWS:
        row = {k: summary[k] for k in ROUTER_ROWS[name]}
        if row != ROUTER_ROWS[name]:
            fail(f"{name}: virtual-tick row {row}, expected "
                 f"{ROUTER_ROWS[name]}")
        print(f"{tag} virtual-tick row equal to the reference's: {row}")
    else:
        check_router_record(name, run, cancels)
    try:
        n = launch.check_route_parity(run, rids=parity)
    except Exception as e:                  # noqa: BLE001 - any is a failure
        fail(f"{name}: {e}")
    which = ("every completed request" if parity is None else
             f"the completed requests of rids {list(parity)}")
    print(f"{tag} parity OK: {n} requests ({which}) token-identical to the "
          "batch-1 greedy oracle")
    if name == "router_hedge":
        check_running_cancel(torch, run)
    found = [k for _, k in cancels]
    print(f"{tag} {len(cancels)} cancels under sync debug mode 'error' "
          f"({found.count('running')} of a running request, "
          f"{found.count('waiting')} of a waiting one, "
          f"{found.count('none')} of a finished one); phase "
          f"{time.perf_counter() - t0:.1f}s")
    return run, got, {"seconds": run.seconds,
                      "tokens_per_second": run.tokens_per_second,
                      "delivered": run.delivered,
                      "syncs_per_token": run.syncs_per_token,
                      "model_calls": calls, "engines": len(run.engines),
                      "stats": router.stats, "summary": summary,
                      "build_bytes": run.build_bytes, "weight_bytes": wbytes,
                      "cancels": cancels, "dispatch": run.dispatch}


def check_router_record(name: str, run, cancels) -> None:
    """The small cells' record against the reference's (ROUTER_RECORDS):
    stats, ticks, health log, (attribution, winning replica) per rid,
    prefills per engine, the hedge losers' cancels; every request finished
    with exactly its max_new_tokens; no engine still owns a hedged rid its
    replica lost."""
    rec = ROUTER_RECORDS[name]
    router = run.router
    got = dict(stats=router.stats, ticks=router.clock,
               health_log=router.health_log,
               served={rid: (o.attribution.value, o.replica)
                       for rid, o in router.outputs.items()})
    if "prefills" in rec:
        got["prefills"] = [e.stats["prefill_calls"] for e in run.engines]
    if "cancels" in rec:
        got["cancels"] = cancels
    if got != rec:
        fail(f"{name}: router record {got}, expected {rec}")
    for r in run.requests:
        o = router.outputs[r.rid]
        if o.finished < 0 or len(o.tokens) != r.max_new_tokens:
            fail(f"{name}: request {r.rid} finished at {o.finished} with "
                 f"{len(o.tokens)} of {r.max_new_tokens} tokens")
    for h in router.replicas:
        for o in router.outputs.values():
            if o.hedged and h.engine.outputs.get(o.rid) is not None \
                    and o.replica != h.index:
                fail(f"{name}: replica {h.index} still owns hedged request "
                     f"{o.rid}, which replica {o.replica} won")
    print(f"[router {name}] record equal to the reference's: {rec}")


def check_running_cancel(torch, run) -> None:
    """``ServeEngine.cancel`` of a *running* request at full width, on the
    cell's first engine (fixed arena) and on a paged engine over the same
    weights (pages of 16): a request is admitted and decoded part way, then
    cancelled under CUDA's sync debug mode; its slot is free and its
    owed-token counter 0 on the card.  A second request is then admitted
    into the freed slot (on the paged arena after the slot's pages came
    home, with its page-table row rewritten) and must equal the batch-1
    oracle; the paged pool is whole again at the end."""
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.engine import ServeEngine

    first = run.engines[0]
    paged = ServeEngine(first.api, run.params,
                        first.config.with_fields(page_size=16))
    for arena, eng in (("fixed", first), ("paged", paged)):
        tag = f"[router router_hedge] {arena} arena:"
        req = dataclasses.replace(run.requests[2], rid=10_000,
                                  arrival=eng.clock)
        eng.add(req)
        eng.step()
        slots = [s for s, r in eng.sched.running.items() if r.rid == req.rid]
        if not slots:
            fail(f"{arena} running cancel: the request finished in one tick")
        slot = slots[0]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            hit = eng.cancel(req.rid)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        left = int(eng._remaining[slot])
        if not hit or eng.sched.has_work() or left != 0:
            fail(f"{arena} running cancel: returned {hit}, engine has work "
                 f"{eng.sched.has_work()}, owed tokens on the card {left}")
        out = len(eng.outputs[req.rid].tokens)
        nxt = dataclasses.replace(run.requests[4], rid=10_001,
                                  arrival=eng.clock)
        eng.add(nxt)
        eng.step()
        owner = eng.sched.running.get(slot)
        if owner is None or owner.rid != nxt.rid:
            fail(f"{arena} running cancel: the next request was not "
                 f"admitted into the freed slot {slot}")
        while eng.sched.has_work():
            eng.step()
        try:
            launch.replay_oracle([eng], run.params, [nxt],
                                 {nxt.rid: eng.outputs[nxt.rid].tokens})
        except Exception as e:              # noqa: BLE001 - any is a failure
            fail(f"{arena} running cancel, then the freed slot: {e}")
        pool = ""
        if eng._paged is not None:
            eng.step()                      # the last slot's pages home
            free = eng._page_alloc.free_pages
            if free != eng._paged.num_pages - 1:
                fail(f"paged running cancel: {free} of "
                     f"{eng._paged.num_pages - 1} pages free at the end")
            pool = f"; all {free} pages free at the end"
        print(f"{tag} a running request ({out} of {req.max_new_tokens} "
              f"tokens out) cancelled with no host sync, its owed-token "
              f"counter 0; the next request took slot {slot} and equals "
              f"the batch-1 oracle{pool}")
    del paged


def phase_moe_depth(torch, card: str) -> dict:
    """mixtral-8x7b at its full ``MOE_DEPTH`` layers, which the serve
    paths cut: every earlier model freed, the streamed build launch.serve
    runs (``MOE_SB``'s pruning, seed ``SEED``; seconds, peak allocated and
    resident bytes, the peak gated below the card's memory), then one
    model call, a ``MOE_FULL["prompt"]``-token prefill of seeded ids,
    gated on ``MOE_SB``'s 32-layer launches per model call, no plain GEMM
    and finite logits, and held within 2 % relative L2 of the plain route
    on the served weights under the kernel route's routing."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as launch
    from repro_torch.models import build_model, moe
    from repro_torch.models.common import (kernel_dispatch_counts,
                                           sparse_execution)

    tag = "[serve moe_full_depth]"
    drop_weights(torch)
    api = build_model(launch.get_config(MOE), device="cuda")
    if api.cfg.num_layers != MOE_DEPTH:
        fail(f"{tag} {MOE} has {api.cfg.num_layers} layers, not "
             f"{MOE_DEPTH}")
    build = {}
    with spied(launch, "init_sparse_params", build_spy(torch, build)):
        params = launch._draw(api, MOE_SB["sparsity"], SEED, True, None,
                              False)
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"{tag} {MOE} at all {MOE_DEPTH} layers: streamed build "
          f"(sparsity.init_sparse_params) {build['seconds']:.1f}s: peak "
          f"allocated {build['peak_bytes'] / 2**30:.2f} GiB, resident after "
          f"it {build['resident_bytes'] / 2**30:.2f} GiB, of the card's "
          f"{total / 2**30:.2f} GiB; {card}")
    if build["peak_bytes"] >= total:
        fail(f"{tag} the build's peak {build['peak_bytes']} B reaches the "
             f"card's {total} B")
    S = MOE_FULL["prompt"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = {"tokens": torch.randint(1, api.cfg.vocab_size, (1, S),
                                     generator=gen, device="cuda")}
    routing, flips = [], []
    reset_launch_counts()
    d0 = kernel_dispatch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sparse_execution(use_kernels=True), \
            spied(moe, "top_k", record_routing(routing)):
        _, logits = api.prefill(params, batch, cache_len=MOE_FULL["cache_len"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launch_counts()
    d1 = kernel_dispatch_counts()
    dispatch = {k: d1.get(k, 0) - d0.get(k, 0) for k in d1}
    with plain_route(torch), \
            spied(moe, "top_k", replay_routing(torch, routing, flips)):
        _, ref = api.prefill(params, batch, cache_len=MOE_FULL["cache_len"])
    gap = rel_l2(logits, ref)
    print(f"{tag} one {S}-token prefill {seconds:.3f}s: launches {got}; "
          f"dispatch {dispatch}; logits {tuple(logits.shape)}, relative L2 "
          f"gap to the plain route {gap:.5f} (under the kernel route's "
          f"routing, which it would have left in {sum(flips)} choices)")
    if got != MOE_SB["launches"]:
        fail(f"{tag} launches {got}, expected {MOE_SB['launches']} a model "
             "call at 32 layers")
    if dispatch.get("plain", 0):
        fail(f"{tag} plain GEMMs on the kernel route: {dispatch}")
    if tuple(logits.shape) != (1, api.cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{tag} logits {tuple(logits.shape)} not finite of (1, V)")
    if not gap <= 0.02:
        fail(f"{tag} prefill logits {gap:.5f} from the plain route")
    record = {"build": build, "prefill_seconds": seconds, "launches": got,
              "logits_rel_l2": gap, "routing_flips": sum(flips)}
    del params, logits, ref, routing
    gc.collect()
    torch.cuda.empty_cache()
    return record


def rel_l2(x, ref) -> float:
    return float((x.float() - ref.float()).norm() / ref.float().norm())


def rows_rel_l2(x, ref) -> float:
    """The largest relative L2 gap of one (layer, batch row, position) of
    a (L, B, S, KVH, hd) cache to the same row of ``ref``."""
    d = (x.float() - ref.float()).flatten(3).norm(dim=-1)
    return float((d / ref.float().flatten(3).norm(dim=-1).clamp(
        min=1e-30)).max())


def widened(params):
    """The params with every leaf in fp32."""
    if isinstance(params, dict):
        return {k: widened(v) for k, v in params.items()}
    return params.float()


def profiled(torch, fn):
    """Run ``fn`` under torch.profiler: (wall ms, {kernel: (device ms,
    launches)}, device ops)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.device_time_total / 1e3, n + 1)
    return wall_ms, by_name, len(kernels)


def print_profile(tag: str, wall_ms: float, by_name, what: str) -> None:
    busy_ms = sum(t for t, _ in by_name.values())
    print(f"{tag} {what}; {wall_ms:.1f} ms wall (profiled), device busy "
          f"{busy_ms:.1f} ms = {busy_ms / wall_ms:.3f} of wall")
    for kname, (ms, n) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][0])[:10]:
        print(f"{tag} {ms:9.3f} ms {n:7d}x  {kname[:100]}")


def phase_profile(torch, name: str, run):
    """``--profile``: where the serving time goes.  Serves a fresh 8-request
    trace on the same weights under torch.profiler (engine.run only) and
    prints the device's busy share of the wall time, device time by kernel,
    and kernel launches per model call.  Returns (wall ms, {kernel: (device
    ms, launches)}) of the engine run."""
    from repro_torch.runtime.engine import ServeEngine, synthetic_trace

    eng0 = run.engine
    eng = ServeEngine(eng0.api, run.params, eng0.config)
    reqs = synthetic_trace(eng0.api.cfg, num_requests=8, seed=2,
                           prompt_lens=(8, 16, 32), gen_lens=(4, 8, 16))
    wall_ms, by_name, ops = profiled(torch, lambda: eng.run(reqs))
    st = eng.stats
    calls = st["prefill_calls"] + st["decode_steps"]
    print_profile(f"[profile {name}]", wall_ms, by_name,
                  f"engine run, {st['emitted']} tokens, {calls} model calls, "
                  f"{ops} device ops = {ops / calls:.2f} per model call")
    # one decode step alone (a 1-step chunk on the drained arena): the
    # arena's own cost, apart from the trace's prefill share and policy
    _, _, chunk_for = eng._fns()

    def step():
        with eng._scope():
            chunk_for(1)(run.params, eng.cache, eng._tokens, eng._remaining)

    step()
    _, _, step_ops = profiled(torch, step)
    print(f"[profile {name}] one decode step (a 1-step chunk, "
          f"{eng.num_slots} slots): {step_ops} device ops")
    return wall_ms, by_name


def chunk_profile(torch, name: str, run, steps: int = 4) -> dict:
    """On every moe and vlm path, not only with ``--profile``: one fused
    chunk of ``steps`` decode steps on the drained arena (every slot
    decodes) under torch.profiler with device activity only (a mixtral
    engine run under the full profiler takes minutes to process): device
    ops per model call, the device's busy share of the wall and the
    device ms per model call of griffin_spmm, sparse_a and its
    metadata kernel."""
    from torch.profiler import ProfilerActivity, profile

    eng = run.engine
    _, _, chunk_for = eng._fns()

    def chunk():
        with eng._scope():
            chunk_for(steps)(run.params, eng.cache, eng._tokens,
                             eng._remaining)

    chunk()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3

    def ms(*match, but="\0"):
        return sum(e.device_time_total for e in kernels
                   if any(m in e.name for m in match)
                   and but not in e.name) / 1e3 / steps

    record = {"steps": steps, "wall_ms": wall_ms,
              "ops_per_call": len(kernels) / steps,
              "busy_share": busy / wall_ms,
              "griffin_spmm_ms_per_call": ms("spmm_"),
              "sparse_a_ms_per_call": ms("sparse_a_", but="meta"),
              "sparse_a_meta_ms_per_call": ms("sparse_a_meta")}
    print(f"[profile {name}] a {steps}-step fused chunk, {eng.num_slots} "
          f"slots: {wall_ms:.1f} ms wall, {len(kernels) / steps:.1f} "
          f"device ops a step, device busy {busy:.1f} ms = "
          f"{busy / wall_ms:.3f} of wall; a step: griffin_spmm "
          f"{record['griffin_spmm_ms_per_call']:.3f} ms, sparse_a "
          f"{record['sparse_a_ms_per_call']:.3f} ms, sparse_a_meta "
          f"{record['sparse_a_meta_ms_per_call']:.3f} ms")
    return record


def phase_profile_router(torch, name: str, run) -> None:
    """``--profile``: the cell's trace routed again on the same weights by
    a fresh router (``launch.serve.build_router``) under torch.profiler:
    the device's busy share and device ops per model call over every
    engine built (the router itself only adds host bookkeeping)."""
    from repro_torch.launch import serve as launch

    eng0 = run.engines[0]
    router, engines = launch.build_router(eng0.api, run.params, eng0.config)
    wall_ms, by_name, ops = profiled(torch,
                                     lambda: router.run(run.requests))
    calls = sum(e.stats["prefill_calls"] + e.stats["decode_steps"]
                for e in engines)
    print_profile(f"[profile {name}]", wall_ms, by_name,
                  f"routed run, {calls} model calls over {len(engines)} "
                  f"engines, {ops} device ops = {ops / calls:.2f} per model "
                  "call")


def profile_long_prefill(torch, run, S: int) -> None:
    """``--profile``: where the time of one S-token prefill goes."""
    eng = run.engine
    batch = {"tokens": torch.randint(1, eng.api.cfg.vocab_size, (1, S),
                                     device="cuda")}

    def go():
        with eng._scope():
            eng.api.prefill(run.params, batch, cache_len=S)

    wall_ms, by_name, ops = profiled(torch, go)
    print_profile("[profile long_prefill]", wall_ms, by_name,
                  f"one {S}-token prefill, {ops} device ops")


def fig8_designs():
    """benchmarks/fig8_overall.py's design list, from the port's spec."""
    from repro_torch.core.spec import (DENSE_BASELINE, GRIFFIN, SPARSE_A_STAR,
                                       SPARSE_AB_STAR, SPARSE_B_STAR,
                                       SPARTEN_AB, TCL_B, TDASH_AB)
    return [DENSE_BASELINE, SPARSE_B_STAR, TCL_B, SPARSE_A_STAR,
            SPARSE_AB_STAR, GRIFFIN, TDASH_AB, SPARTEN_AB]


def fig8_sweep():
    """The port's Figure 8 sweep on the host (numpy engine), capturing every
    group the engine schedules cycles-only over full-length streams: (mask,
    d1, d2, d3, shuffle per row, the engine's cycles).  Returns the rows by
    (design, mode), the groups and the seconds."""
    from repro_torch.core import CoreConfig, Mode, scheduler
    from repro_torch.core.dse import sweep

    engine = scheduler._schedule_rows
    groups = []

    def capture(mask, d1v, d2v, d3v, shv, record, tl, has_t_len):
        out = engine(mask, d1v, d2v, d3v, shv, record, tl, has_t_len)
        if not record and not has_t_len:
            groups.append((mask.copy(), d1v.copy(), d2v.copy(), d3v.copy(),
                           shv.copy(), out.cycles.copy()))
        return out

    t0 = time.perf_counter()
    scheduler._schedule_rows = capture
    try:
        rows = {(r["design"], r["mode"]): r for mode in FIG8_MODES
                for r in sweep(fig8_designs(), Mode(mode), CoreConfig(),
                               seed=FIG8_SEED)}
    finally:
        scheduler._schedule_rows = engine
    return rows, groups, time.perf_counter() - t0


def split_by_config(groups):
    """[(config, mask, cycles)]: each group's rows split by their (d1, d2,
    d3, shuffle), the one shared config the kernel takes."""
    import numpy as np
    streams = []
    for mask, d1v, d2v, d3v, shv, cycles in groups:
        keys = np.stack([d1v, d2v, d3v, shv.astype(np.int64)], axis=1)
        for key in np.unique(keys, axis=0):
            sel = (keys == key).all(axis=1)
            streams.append((tuple(int(k) for k in key), mask[sel],
                            cycles[sel]))
    return streams


def check_fig8(rows) -> None:
    from repro_torch.core.efficiency import sparsity_tax
    from repro_torch.core.spec import GRIFFIN, SPARTEN_AB
    if set(rows) != set(FIG8_ROWS):
        fail(f"cycle_model: sweep rows {sorted(rows)}")
    worst = 0.0
    for key, want in FIG8_ROWS.items():
        got = tuple(rows[key][k] for k in ("speedup", "tops_w", "tops_mm2"))
        rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        worst = max(worst, rel)
        if rel > FIG8_REL_TOL:
            fail(f"cycle_model: {key} row {got}, expected {want}")
    print(f"[cycle_model] Figure 8 sweep: {len(rows)} rows (8 designs x 4 "
          f"modes) equal to FIG8_ROWS, largest |rel| {worst:.3g} "
          f"(limit {FIG8_REL_TOL:g})")
    for mode in FIG8_MODES:
        ratio = rows[("Griffin", mode)]["tops_w"] / \
            rows[("SparTen.AB", mode)]["tops_w"]
        print(f"[cycle_model] Griffin vs SparTen.AB TOPS/W, {mode:5s}: "
              f"{ratio:.2f}x (paper {PAPER_GRIFFIN_VS_SPARTEN[mode]}x)")
    for spec in (GRIFFIN, SPARTEN_AB):
        tax, paper = sparsity_tax(spec), PAPER_TAX[spec.name]
        print(f"[cycle_model] sparsity tax {spec.name}: power "
              f"{100 * tax['power_tax']:.0f}% / area "
              f"{100 * tax['area_tax']:.0f}% (paper {100 * paper[0]:.0f}% / "
              f"{100 * paper[1]:.0f}%)")


def host_ms(fn, iters: int = 20) -> float:
    """Median host wall time of ``fn`` over ``iters`` calls (for the numpy
    engine)."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def kernel_cases(streams):
    """The kernel against its plain version: each config's largest full
    stream with the numpy engine's captured cycles, the reference test's
    8 x 3 random masks (tests/test_batched_parity.py) with and without
    shuffle, a T = 1 stream, and a stream whose chunks are all empty (the
    engine's cycles computed here).  name -> (config, mask, cycles)."""
    import numpy as np
    from repro_torch.core.scheduler import schedule
    cases = {}
    for cfg, mask, want in sorted(streams, key=lambda s: -s[1].size):
        cases.setdefault(f"fig8 {cfg}", (cfg, mask, want))
    ref_mask = np.random.default_rng(11).random((6, 19, 8, 3)) < 0.3
    small = {f"8x3 {(d1, d2, d3, sh)}": ((d1, d2, d3, sh), ref_mask)
             for d1, d2, d3 in ((0, 0, 0), (2, 1, 0), (4, 0, 2))
             for sh in (0, 1)}
    small["T=1"] = ((2, 1, 1, 1),
                    np.random.default_rng(1).random((16, 1, 16, 2)) < 0.5)
    small["all empty"] = ((2, 1, 0, 0), np.zeros((8, 12, 16, 1), bool))
    for name, (cfg, mask) in small.items():
        cases[name] = (cfg, mask, schedule(mask, *cfg[:3],
                                           shuffle=bool(cfg[3])).cycles)
    return cases


def phase_cycle_model(torch, sweep=fig8_sweep):
    """The paper's cycle model: the Figure 8 sweep through the port's DSE
    engine on the host (``sweep()``: :func:`fig8_sweep`'s result, or the
    waiting end of :func:`in_background`'s run of it), then every
    cycles-only stream it scheduled through the batch_eval kernel on the
    card, its cycles held equal to the numpy engine's; the kernel against
    its plain version; times on the largest stream."""
    import numpy as np
    from repro_torch.core.scheduler import (schedule, schedule_batched,
                                            shuffle_lanes)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.batch_eval import kernel, schedule_cycles
    from repro_torch.kernels.batch_eval.ref import schedule_cycles_ref

    t_phase = time.perf_counter()
    rows, groups, sweep_s = sweep()
    print(f"[cycle_model] Figure 8 sweep (numpy engine, host"
          f"{'' if sweep is fig8_sweep else ', beside the kernel build'}): "
          f"{sweep_s:.1f}s, {len(groups)} cycles-only full-length groups "
          "captured")
    check_fig8(rows)

    streams = split_by_config(groups)
    nbytes = sum(m.nbytes for _, m, _ in streams)
    nrows = sum(len(c) for _, _, c in streams)
    t0 = time.perf_counter()
    reset_launch_counts()
    for cfg, mask, want in streams:
        got = schedule_batched(mask, *cfg[:3], shuffle=bool(cfg[3]),
                               backend="torch").cycles
        if not np.array_equal(got, want):
            bad = int(np.flatnonzero(got != want)[0])
            fail(f"cycle_model: config {cfg}, shape {mask.shape}: row {bad} "
                 f"{got[bad]} cycles on the card, {want[bad]} numpy")
    got = launch_counts()
    card_s = time.perf_counter() - t0
    want = {k: (len(streams) if k == "batch_eval" else 0) for k in got}
    if got != want:
        fail(f"cycle_model: launches {got}, expected {want}")
    configs = sorted({cfg for cfg, _, _ in streams})
    print(f"[cycle_model] {len(streams)} streams (groups split by config "
          f"(d1, d2, d3, shuffle): {configs}), {nrows} rows, {nbytes} mask "
          f"bytes: cycles on the card equal to the numpy engine's on every "
          f"row; {card_s:.2f}s with copies; launches {got}")

    checks = []
    for name, (cfg, mask, eng) in kernel_cases(streams).items():
        out = schedule_cycles(mask, *cfg[:3], shuffle=bool(cfg[3]))
        host = shuffle_lanes(mask, 1, 2) if cfg[3] else mask
        dev = torch.from_numpy(np.ascontiguousarray(host)).cuda()
        ref = schedule_cycles_ref(dev, *cfg[:3]).cpu().numpy()
        err = int(np.abs(out - ref).max())
        if err or not np.array_equal(out, eng):
            bad = int(np.flatnonzero((out != ref) | (out != eng))[0])
            fail(f"cycle_model: kernel {name} {cfg} {mask.shape}: row {bad} "
                 f"{out[bad]}, plain {ref[bad]}, numpy {eng[bad]}")
        checks.append({"kernel": "batch_eval", "case": name,
                       "config": list(cfg), "shape": list(mask.shape),
                       "max_abs_err": err})
    print(f"[cycle_model] batch_eval equal to its plain version and to the "
          f"numpy engine on {len(checks)} cases: "
          f"{[c['case'] for c in checks]}")

    floor = launch_floor(torch)
    print(f"[cycle_model] launch floor (a one-element fill): "
          f"{json.dumps(floor)}")
    by_route = {}
    for route in ("scan", "chain"):
        cfg, mask, want = max(
            (st for st in streams if kernel.route(*st[0][:3]) == route),
            key=lambda st: (st[1].size, st[0][0]))
        host = shuffle_lanes(mask, 1, 2) if cfg[3] else mask
        dev = torch.from_numpy(np.ascontiguousarray(host)).cuda()
        ms = timed_ms(torch, lambda: kernel.batch_eval(dev, *cfg[:3]))
        dev_ms = device_ms(torch, lambda: kernel.batch_eval(dev, *cfg[:3]),
                           f"batch_eval_{route}")
        plain_ms = timed_ms(torch, lambda: schedule_cycles_ref(dev,
                                                               *cfg[:3]),
                            iters=5)
        numpy_ms = host_ms(lambda: schedule(mask, *cfg[:3],
                                            shuffle=bool(cfg[3])), iters=5)
        bound_ms, bound_by = bound(mask.nbytes, 0, "float32")
        by_route[route] = {
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "numpy_ms": numpy_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shape": list(mask.shape), "config": list(cfg)}
        print(f"[cycle_model] batch_eval {route} route, its largest stream "
              f"{mask.shape} config {cfg} ({mask.nbytes} bytes, "
              f"{int(want.sum())} cycles over its tiles, at most "
              f"{int(want.max())}): kernel {ms:.6f} ms (device "
              f"{dev_ms} ms), plain {plain_ms:.2f} ms, numpy engine "
              f"{numpy_ms:.2f} ms (host), bound {bound_ms:.6f} ms "
              f"({bound_by}, below the launch floor {floor['ms']:.6f} / "
              f"{floor['device_ms']} ms), library none")
    phase_s = time.perf_counter() - t_phase
    print(f"[cycle_model] phase {phase_s:.1f}s")
    summary = by_route["scan"]        # the sweep's largest stream
    record = {"phase_s": phase_s, "sweep_s": sweep_s, "card_s": card_s,
              "streams": len(streams), "routes": by_route,
              "launch_floor": floor,
              "rows": nrows, "mask_bytes": nbytes, "configs": configs,
              "fig8_rows": {f"{d}/{m}": r for (d, m), r in rows.items()}}
    return got, checks, summary, record

def logits_witness(torch, api, params):
    """The model's logits under one engine's weights, (steps + 1, batch,
    vocab): a prefill of ``WITNESS`` prompts of seeded token ids, then
    decode steps fed seeded ids (no sampling, so every engine sees the
    same inputs), every GEMM through the kernels as the tuning engine runs
    them.  The ids vary, unlike the random-weight model's greedy
    continuations, so each step asks for a different argmax."""
    from repro_torch.models.common import sparse_execution

    g = torch.Generator(device="cuda").manual_seed(WITNESS["seed"])
    b, p, steps = WITNESS["batch"], WITNESS["prompt"], WITNESS["steps"]
    ids = torch.randint(0, api.cfg.vocab_size, (b, p + steps), generator=g,
                        device="cuda")
    out = []
    with torch.no_grad(), sparse_execution(use_kernels=True):
        cache, logits = api.prefill(params, {"tokens": ids[:, :p]},
                                    cache_len=p + steps)
        out.append(logits)
        for t in range(steps):
            logits, cache = api.decode_step(params, cache,
                                            ids[:, p + t:p + t + 1])
            out.append(logits)
    torch.cuda.synchronize()
    return torch.stack(out)


def phase_autotune(torch, card: str):
    """launch.autotune's pipeline for the dense family at full width: 16
    candidates scored (cycle-model DSE and roofline), the default and the
    3 shortlisted engines served with every kernel counted per engine
    (counters zeroed just before and read just after each engine's
    measured runs), every candidate's tokens equal to the default's and
    its logits witness (``logits_witness``, after the counters are read)
    bit-equal to the default's, the plan written to chiprun_out/ and read
    back.  Then the grid's first
    candidate of each block size the shortlist left out is served the
    same way (one warm and one timed run), so every granularity of the
    grid runs end to end.  tok/s is printed, not gated."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import autotune
    from repro_torch.models.common import (kernel_dispatch_counts,
                                           reset_kernel_dispatch)
    from repro_torch.sparsity import sparsify_params
    from repro_torch.tuning import load_plan
    from repro_torch.sparsity import prune_for
    from repro_torch.tuning.measure import tuning_workload

    t_phase = time.perf_counter()
    runs = []
    measure = autotune.measure_plan

    def counted(*args, **kw):
        torch.cuda.synchronize()
        reset_launch_counts()
        reset_kernel_dispatch()
        m = measure(*args, **kw)
        torch.cuda.synchronize()
        runs.append((kw.get("plan"), launch_counts(),
                     kernel_dispatch_counts(), m,
                     logits_witness(torch, args[0], args[1])))
        return m

    autotune.measure_plan = counted
    try:
        fp, summary = autotune.autotune_family("dense", device="cuda",
                                               **AUTOTUNE)
    except AssertionError as e:
        fail(f"autotune: {e}")
    finally:
        autotune.measure_plan = measure
    scored, short = summary["scored"], summary["shortlist"]
    sizes = {r["candidate"].block_k for r in short}
    extra = []
    for r in scored:
        if r["candidate"].block_k not in sizes:
            sizes.add(r["candidate"].block_k)
            extra.append(r)
    _, api, params, cache_len, trace = tuning_workload(
        "dense", requests=AUTOTUNE["requests"], device="cuda")
    for r in extra:
        fp_r = r["candidate"].family_plan("dense")
        p = sparsify_params(params, AUTOTUNE["sparsity"], compact=True,
                            plan=fp_r, **prune_for(False))
        counted(api, p, cache_len, trace, plan=fp_r, repeats=1)
        del p
    del params
    for r in scored:
        print(f"[autotune] candidate {r['name']}: grid_steps "
              f"{r['grid_steps']}, bound_s {r['bound_s']:.4g}, predicted_s "
              f"{r['predicted_s']:.4g}, dse_speedup {r['dse_speedup']}, "
              f"score {r['score']:.6g}")
    print(f"[autotune] shortlist {[r['name'] for r in short]}")
    if len(scored) != AUTOTUNE["budget"] or \
            len(short) != AUTOTUNE["shortlist_k"]:
        fail(f"autotune: {len(scored)} candidates scored, {len(short)} "
             "shortlisted")
    if len(runs) != 1 + len(short) + len(extra) or \
            sorted(sizes) != list(GRANULARITIES):
        fail(f"autotune: {len(runs)} engines measured, block sizes "
             f"{sorted(sizes)}")
    base, base_logits = runs[0][3], runs[0][4]
    print(f"[autotune] default tokens per request: {list(base['tokens'])}")
    top2 = base_logits.float().topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    total, witness = {}, []
    for plan, got, dispatch, m, logits in runs:
        label = plan.rules[0] if plan is not None else "default"
        calls = m["model_calls"]
        want = {k: SB_LAUNCHES.get(k, 0) * calls for k in got}
        if got != want:
            fail(f"autotune {label}: launches {got}, expected {want} "
                 f"({calls} model calls)")
        if dispatch.get("plain", 0) or dispatch.get("dual", 0):
            fail(f"autotune {label}: dispatch {dispatch}")
        gap = float((logits.float() - base_logits.float()).abs().max())
        flips = int((logits.argmax(-1) != base_logits.argmax(-1)).sum())
        witness.append({"max_abs_logit_diff": gap, "argmax_flips": flips})
        if not torch.equal(logits, base_logits):
            fail(f"autotune {label}: logits not bit-equal to the default's "
                 f"(max |diff| {gap}, {flips} argmax flips of "
                 f"{base_logits.shape[0] * base_logits.shape[1]}; smallest "
                 f"top-1/top-2 margin {margin})")
        if m["tokens"] != base["tokens"]:
            fail(f"autotune {label}: tokens differ from the default's")
        total = {k: total.get(k, 0) + v for k, v in got.items()}
    print(f"[autotune] logits witness: {len(runs)} engines x "
          f"{base_logits.shape[0]} model calls x {base_logits.shape[1]} "
          f"rows x {base_logits.shape[2]} logits bit-equal to the "
          f"default's; {len(set(base_logits.argmax(-1).flatten().tolist()))}"
          f" distinct argmax ids; smallest top-1/top-2 margin {margin}")
    name = {r["name"]: r for r in scored}
    repeats = [AUTOTUNE["repeats"]] * (1 + len(short)) + [1] * len(extra)
    for (plan, got, _, m, _), rep in zip(runs, repeats):
        tag = "default" if plan is None else \
            next(n for n, r in name.items()
                 if r["candidate"].family_plan("dense").rules == plan.rules)
        print(f"[autotune] {tag}: {m['tok_s']:.1f} tok/s (best of "
              f"{rep}, not gated), {m['tok_per_step']:.3f} "
              f"tok/step, mode {m['mode']}, {m['model_calls']} model calls, "
              f"launches {got['griffin_spmm']} griffin_spmm + "
              f"{got['dense_gemm']} dense_gemm; logits and tokens equal to "
              f"the default's; {card}")
    meta = {"tool": "repro_torch.launch.autotune", "device": "cuda",
            "reduced": False, "prune": prune_for(False), "card": card,
            **{k: v for k, v in AUTOTUNE.items() if k != "shortlist_k"},
            "shortlist": AUTOTUNE["shortlist_k"]}
    autotune.write_plan({fp.family: fp}, meta, str(ROOT / AUTOTUNE_PLAN))
    got_fp = load_plan(str(ROOT / AUTOTUNE_PLAN)).family("dense")
    winner = name[summary["winner"]]["candidate"]
    rule = got_fp.rules[0]
    if (rule.block_k, rule.block_n, rule.unit, rule.a_threshold) != \
            (winner.block_k, winner.block_n, winner.unit,
             winner.a_threshold) or got_fp.measured["winner"] != winner.name:
        fail(f"autotune: reloaded plan {got_fp} is not the winner "
             f"{winner}")
    phase_s = time.perf_counter() - t_phase
    ratio = got_fp.measured["winner_vs_default"]
    print(f"[autotune] winner {winner.name} ({ratio}x the default's "
          f"tok/s, not gated); plan "
          f"{AUTOTUNE_PLAN} written and read back; launches {total}; "
          f"phase {phase_s:.1f}s")
    record = {"phase_s": phase_s, "winner": winner.name,
              "measured": got_fp.measured,
              "scored": [{k: v for k, v in r.items() if k != "candidate"}
                         for r in scored],
              "shortlist": [r["name"] for r in short],
              "extra": [r["name"] for r in extra],
              "tok_s": [r[3]["tok_s"] for r in runs],
              "model_calls": [r[3]["model_calls"] for r in runs],
              "witness": witness, "witness_min_margin": margin}
    return total, record


def materialised_attention(torch, q, k, v, window):
    """Causal softmax attention with the (S x S) scores formed (optionally
    windowed; GQA by repeating the KV heads), the plain reference of the
    flash backward."""
    S, hd = q.shape[1], q.shape[-1]
    G = q.shape[2] // k.shape[2]
    kk, vv = (x.repeat_interleave(G, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vv)


def train_flash(torch) -> list:
    """Gate 1: the flash backward at llama3.2-1b's head shapes (H 32, KVH
    8, hd 64, B 1, kv_chunk 512) against autograd through the materialised
    attention, fp32; at S 2048 the backward's peak allocation rise stays
    below one B*H*S*S fp32 tensor, the score matrix it must not store."""
    from repro_torch.models.attention import attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for name, S, window in TRAIN_FLASH:
        q = torch.randn(1, S, 32, 64, generator=gen, device="cuda")
        k, v = (torch.randn(1, S, 8, 64, generator=gen, device="cuda")
                for _ in range(2))
        do = torch.randn(1, S, 32, 64, generator=gen, device="cuda")
        leaves = [x.requires_grad_() for x in (q, k, v)]
        out = attention(*leaves, causal=True, window=window, kv_chunk=512)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rise = torch.cuda.max_memory_allocated() - base
        ref = torch.autograd.grad(
            materialised_attention(torch, *leaves, window), leaves, do)
        errs = [rel_l2(g, r) for g, r in zip(grads, ref)]
        quad = 32 * S * S * 4
        print(f"[train flash] {name}: dq/dk/dv relative L2 "
              f"{', '.join(f'{e:.2e}' for e in errs)} to the materialised "
              f"attention; backward {seconds * 1e3:.1f} ms, peak allocation "
              f"rise {rise / 2**20:.1f} MiB (one score matrix "
              f"{quad / 2**20:.0f} MiB)")
        if max(errs) > TRAIN_FLASH_TOL:
            fail(f"train flash {name}: gradients differ from the "
                 f"materialised attention by {max(errs):.3e}")
        if S == 2048 and rise >= quad:
            fail(f"train flash {name}: backward allocated {rise} B, not "
                 f"below one score matrix ({quad} B)")
        rows.append({"case": name, "S": S, "window": window,
                     "rel_l2": errs, "backward_ms": seconds * 1e3,
                     "peak_rise_bytes": rise})
        del q, k, v, do, leaves, out, grads, ref
    torch.cuda.empty_cache()
    return rows


def train_widened_step(torch, opt_cfg, shape) -> dict:
    """Gate 2: one full-width train step in bf16 against the same step on
    the same weights widened to fp32: loss and grad norm."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import (TrainState, make_train_step,
                                           to_device)

    api = build_model(get_config(TRAIN["arch"]))
    batch = to_device(synth_batch(api.cfg, shape, DataConfig(seed=0), 0),
                      "cuda")
    step = make_train_step(api, opt_cfg)
    got = {}
    for label in ("bf16", "fp32"):
        params = api.init(api.generator(0))
        if label == "fp32":
            params = widened(params)
        state = TrainState(params, adamw.init(params),
                           torch.zeros((), dtype=torch.int32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        got[label] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "step_s": time.perf_counter() - t0}
        del params, state, m
        gc.collect()
        torch.cuda.empty_cache()
    b, f = got["bf16"], got["fp32"]
    dl = abs(b["loss"] - f["loss"]) / abs(f["loss"])
    dg = abs(b["grad_norm"] - f["grad_norm"]) / abs(f["grad_norm"])
    print(f"[train] bf16 step against fp32 on the widened weights: loss "
          f"{b['loss']:.6f} / {f['loss']:.6f} ({dl:.2e} relative), grad "
          f"norm {b['grad_norm']:.6f} / {f['grad_norm']:.6f} ({dg:.2e}); "
          f"fp32 step {f['step_s']:.2f}s")
    if not dl <= TRAIN_LOSS_TOL or not dg <= TRAIN_GNORM_TOL:
        fail(f"train: the bf16 step's loss ({dl:.3e}) or grad norm "
             f"({dg:.3e}) is off the fp32 step's")
    return dict(got, loss_rel=dl, grad_norm_rel=dg)


def zero_block_shares(torch, state, schedule, match) -> dict:
    """Per pruned leaf, each layer's share of all-zero (block_k x unit)
    blocks, and the share the schedule's block_prune leaves at the
    state's step (``nkeep = max(1, round(blocks * (1 - s)))`` kept)."""
    from repro_torch.checkpoint import keyed_leaves

    s = schedule.sparsity_at(int(state.step))
    out = {}
    for path, leaf in keyed_leaves(state.params):
        if leaf.dim() < 2 or not match(path):
            continue
        k, n = leaf.shape[-2:]
        bk, un = min(schedule.block_k, k), min(schedule.unit, n)
        blocks = leaf.reshape(-1, k // bk, bk, n // un, un) == 0
        shares = blocks.all(dim=4).all(dim=2).float().mean(dim=(1, 2))
        nb = (k // bk) * (n // un)
        want = 1 - max(1, int(round(nb * (1 - s)))) / nb
        out[path] = {"shares": shares.tolist(), "expected": want}
    return out


def train_kernels(torch, state, schedule, match) -> tuple:
    """Gate 6: the trained weights on the kernels.  The final state pruned
    at the schedule's milestone, then compacted by sparsify_params at its
    sparsity and granularity: every decompacted layer equals the pruned
    leaf bit for bit; one 4-row prefill through the kernels (counters
    zeroed just before, read just after) launches exactly griffin_spmm 112
    + dense_gemm 1 and its logits stay within 2 % of the plain route on
    the pruned weights."""
    from repro_torch.kernels import (decompact_weights, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels.griffin_spmm.ops import GriffinWeights
    from repro_torch.models import build_model
    from repro_torch.configs import get_config
    from repro_torch.models.common import sparse_execution
    from repro_torch.runtime.train import apply_prune
    from repro_torch.sparsity import sparsify_params

    state = apply_prune(state, schedule, match)
    params = state.params
    compacted = sparsify_params(params, schedule.final_sparsity,
                                block_k=schedule.block_k, block_n=128,
                                unit=schedule.unit)
    checked = 0
    for name, gw in compacted["layers"].items():
        if not isinstance(gw, GriffinWeights):
            continue
        for i in range(gw.b_comp.shape[0]):
            w = params["layers"][name][i]
            if not torch.equal(decompact_weights(gw[i])[:w.shape[0]], w):
                fail(f"train: compacting the trained {name}[{i}] changed "
                     "a weight")
            checked += 1
    api = build_model(get_config(TRAIN["arch"]))
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_PREFILL["seed"])
    toks = torch.randint(1, api.cfg.vocab_size, (TRAIN_PREFILL["rows"],
                                                 TRAIN_PREFILL["prompt"]),
                         generator=gen, device="cuda")
    torch.cuda.synchronize()
    reset_launch_counts()
    with sparse_execution(use_kernels=True):
        _, logits = api.prefill(compacted, {"tokens": toks})
    torch.cuda.synchronize()
    got = launch_counts()
    with sparse_execution(use_kernels=False):
        _, ref = api.prefill(params, {"tokens": toks})
    rel = rel_l2(logits, ref)
    print(f"[train] trained weights: {checked} layer slices compacted "
          f"without a changed weight; a {TRAIN_PREFILL['rows']}-row "
          f"prefill launched {got}, logits relative L2 {rel:.5f} to the "
          "plain route")
    if got != SB_LAUNCHES:
        fail(f"train: the prefill launched {got}, expected {SB_LAUNCHES}")
    if not bool(torch.isfinite(logits).all()) or rel > 2e-2:
        fail(f"train: kernel-route logits differ from the plain route by "
             f"{rel:.4f}")
    return got, {"slices_checked": checked, "logits_rel_l2": rel}


def phase_train(torch, card: str) -> tuple:
    """The training path at full width, through the CLI a user calls
    (repro_torch.launch.train.main): six gates, see the module docstring.
    Returns (the prefill's launches, the phase's record)."""
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.configs import ShapeConfig
    from repro_torch.sparsity import PruneSchedule

    t_phase = time.perf_counter()
    record = {"flash": train_flash(torch)}
    steps = TRAIN["steps"]
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=min(20, steps // 5),
                          total_steps=steps)
    shape = ShapeConfig("cli", TRAIN["seq"], TRAIN["batch"], "train")
    record["widened"] = train_widened_step(torch, opt_cfg, shape)
    schedule = PruneSchedule(TRAIN["prune"], begin_step=steps // 4,
                             ramp_steps=steps // 2, block_k=128, unit=32)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    free = shutil.disk_usage(build_dir).free
    tmp = tempfile.mkdtemp(prefix="train_ckpt_", dir=build_dir)
    argv = ["--arch", TRAIN["arch"], "--steps", str(steps), "--batch",
            str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
            "--prune-sparsity", str(TRAIN["prune"]), "--ckpt-dir", tmp,
            "--ckpt-every", str(TRAIN["ckpt_every"]), "--log-every", "5"]
    shares = {}

    def at_milestone(step, state, metrics):
        if step == 25:
            shares.update(zero_block_shares(torch, state, schedule,
                                            train_cli.prune_match))

    try:
        print(f"[train] checkpoints under {tmp} ({free / 2**30:.1f} GiB "
              "free)")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        first = train_cli.main(argv, on_step=at_milestone)
        peak = torch.cuda.max_memory_allocated() - base
        losses, gnorms = first["losses"], first["grad_norms"]
        step_ms = sorted(first["step_ms"][1:])[len(first["step_ms"]) // 2]
        tok_s = TRAIN["batch"] * TRAIN["seq"] / (step_ms / 1e3)
        head, tail = (sum(x) / 5 for x in (losses[:5], losses[-5:]))
        print(f"[train] {steps} steps: losses {[round(x, 4) for x in losses]}"
              f"; median step {step_ms:.1f} ms (first {first['step_ms'][0]:.0f}"
              f" ms), {tok_s:.0f} tokens/s, peak allocation "
              f"{peak / 2**30:.2f} GiB over {base / 2**30:.2f} GiB (not "
              f"gated); mean loss first five {head:.4f}, last five "
              f"{tail:.4f}; {card}")
        if not all(math.isfinite(x) for x in losses + gnorms):
            fail("train: a loss or grad norm is not finite")
        if not tail <= (1 - TRAIN_DESCENT) * head:
            fail(f"train: the mean loss fell from {head:.4f} to {tail:.4f}, "
                 f"less than {TRAIN_DESCENT:.0%}")
        want = {p: v["expected"] for p, v in shares.items()}
        bad = [p for p, v in shares.items()
               if any(x != v["expected"] for x in v["shares"])]
        print(f"[train] after the step-25 milestone (sparsity_at(25) = "
              f"{schedule.sparsity_at(25)}): all-zero 128 x 32 block share "
              f"per leaf {want}, every layer equal: {not bad}")
        if sorted(p.split("'")[-2] for p in shares) != \
                sorted(train_cli.PRUNED) or bad:
            fail(f"train: pruned leaves {sorted(shares)}, off the schedule "
                 f"at {bad}")
        (save_step, save_s, save_bytes), = first["saves"]
        print(f"[train] checkpoint at step {save_step}: {save_bytes} bytes "
              f"in {save_s:.2f}s")
        del first["state"]
        gc.collect()
        torch.cuda.empty_cache()
        second = train_cli.main(argv)
        print(f"[train] restart: restored step {second['start']} in "
              f"{second['restore_s']:.2f}s; losses "
              f"{[round(x, 4) for x in second['losses']]}")
        if second["start"] != save_step or \
                second["losses"] != losses[save_step:] or \
                second["grad_norms"] != gnorms[save_step:]:
            fail(f"train: the restarted run's losses "
                 f"{second['losses']} differ from the uninterrupted run's "
                 f"{losses[save_step:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches, kernel_record = train_kernels(
        torch, second["state"], schedule, train_cli.prune_match)
    phase_s = time.perf_counter() - t_phase
    print(f"[train] phase {phase_s:.1f}s")
    record.update(
        losses=losses, grad_norms=gnorms, step_ms=first["step_ms"],
        median_step_ms=step_ms, tokens_per_s=tok_s, peak_rise_bytes=peak,
        prune_shares=shares, save_step=save_step, save_s=save_s,
        save_bytes=save_bytes, restore_s=second["restore_s"],
        restart_losses=second["losses"], disk_free_bytes=free,
        phase_s=phase_s, **kernel_record)
    return launches, record


def in_background(fn):
    """Start ``fn()`` on a daemon thread; the returned callable waits for
    it and returns its result (or raises what it raised).  The host-only
    Figure 8 sweep runs so while the main thread waits on nvcc."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:          # noqa: BLE001 - re-raised
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["value"]
    return result


class PhaseClock:
    """Each phase's wall seconds, printed on a line of its own as the phase
    ends (a phase runs from the previous one's end)."""

    def __init__(self):
        self.seconds = {}
        self._last = time.perf_counter()

    def done(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._last
        self._last = now
        print(f"[phase] {name} {self.seconds[name]:.1f}s")


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail("run from a checkout of the repository (src/repro_torch "
             "missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    card = card_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    clock = PhaseClock()
    sweep = in_background(fig8_sweep)
    build_s = phase_build(build)
    clock.done("build")
    rows, summary = phase_kernels(torch)
    clock.done("kernels")
    serves, long_prefill, paged_ref, unfaulted = {}, None, None, {}
    tokens = {}
    for name, path in PATHS.items():
        keep = any(c["path"] == name and c.get("snapshot_dir") is None
                   for c in FAULT_CELLS.values())
        run, launches, gaps, extra = phase_serve(
            torch, name, **path, paged_ref=paged_ref,
            states=unfaulted if keep else None)
        if "--profile" in sys.argv[1:]:
            phase_profile(torch, name, run)
        serves[name] = serve_record(run, launches, gaps, extra)
        tokens[name] = {r: o.tokens for r, o in run.engine.outputs.items()}
        if path.get("tokens_of"):
            check_same_tokens(name, run, tokens[path["tokens_of"]],
                              path["tokens_of"])
        if name == "sparse_b_paged":
            paged_ref = {"kv_bytes": extra["kv_bytes"], "tokens": {
                r: o.tokens for r, o in run.engine.outputs.items()}}
        if name == "sparse_b":
            long_prefill = phase_long_prefill(torch, run)
            if "--profile" in sys.argv[1:]:
                profile_long_prefill(torch, run, LONG_PROMPTS[-1])
            serves["long_prefill"] = {"launches": {
                k: sum(p["launches"][k] for p in long_prefill.values())
                for k in SB_LAUNCHES}}
        del run
        torch.cuda.empty_cache()
        clock.done(name)
    serves["mesh_2x2"], serves["mesh_remesh"] = phase_mesh(
        torch, card, tokens[MESH["tokens_of"]], serves[MESH["tokens_of"]])
    clock.done("mesh_2x2")
    phase_dense_configs(torch, clock, serves)
    phase_dense_configs(torch, clock, serves, VLM_PATHS, profile_steps=1)
    xlstm_tokens = xlstm_prefill = None
    for name, path in XLSTM_PATHS.items():
        run, launches, gaps, extra = phase_serve(torch, name, arch=XLSTM,
                                                 **path)
        if "--profile" in sys.argv[1:]:
            phase_profile(torch, name, run)
        serves[name] = serve_record(run, launches, gaps, extra)
        if name == "xlstm_sparse_b":
            xlstm_tokens = {r: o.tokens
                            for r, o in run.engine.outputs.items()}
            xlstm_prefill = phase_xlstm_prefill(torch, run)
        if name == "xlstm_paged_degrades":
            check_paged_degrades(run, xlstm_tokens)
        del run
        gc.collect()            # an engine's closures hold it in a cycle
        torch.cuda.empty_cache()
        clock.done(name)
    whisper_tokens = None
    for name, path in WHISPER_PATHS.items():
        run, launches, gaps, extra = phase_serve(torch, name, arch=WHISPER,
                                                 **path)
        if "--profile" in sys.argv[1:]:
            phase_profile(torch, name, run)
        serves[name] = serve_record(run, launches, gaps, extra)
        if name == "whisper_sparse_b":
            whisper_tokens = {r: o.tokens
                              for r, o in run.engine.outputs.items()}
        if path.get("tokens_of"):
            check_same_tokens(name, run, whisper_tokens, path["tokens_of"])
        del run
        gc.collect()
        torch.cuda.empty_cache()
        clock.done(name)
    hybrid_tokens = hybrid_long = None
    for name, path in HYBRID_PATHS.items():
        run, launches, gaps, extra = phase_serve(
            torch, name, arch=HYBRID, fp32_gap=False, **path)
        if "--profile" in sys.argv[1:]:
            phase_profile(torch, name, run)
        serves[name] = serve_record(run, launches, gaps, extra)
        if name == "hybrid_sparse_b":
            hybrid_tokens = {r: o.tokens
                             for r, o in run.engine.outputs.items()}
            hybrid_long = phase_long_window(
                torch, run, "hybrid_long_window", HYBRID_LONG,
                HYBRID_SB["launches"], HYBRID_SB["sparsity"])
            serves["hybrid_long_window"] = {
                "launches": hybrid_long["launches"]}
        if name == "hybrid_paged":
            check_same_tokens(name, run, hybrid_tokens, "hybrid_sparse_b")
        del run
        gc.collect()
        torch.cuda.empty_cache()
        clock.done(name)
    moe_tokens = moe_long = None
    moe_profiles = {}
    for name, path in MOE_PATHS.items():
        run, launches, gaps, extra = phase_serve(
            torch, name, arch=MOE, fp32_gap=False, **moe_at_depth(path))
        clock.done(name)
        # always: device ops per model call, the device's busy share and
        # griffin_spmm's device time, Mode.AB's dual walk against Sparse.B's
        moe_profiles[name] = extra["profile"] = chunk_profile(torch, name,
                                                              run)
        if "--profile" in sys.argv[1:]:
            phase_profile(torch, name, run)
        serves[name] = serve_record(run, launches, gaps, extra)
        if name == "moe_sparse_b":
            moe_tokens = {r: o.tokens for r, o in run.engine.outputs.items()}
            moe_long = phase_long_window(
                torch, run, "moe_long_window", MOE_LONG,
                moe_at_depth(MOE_SB)["launches"], MOE_SB["sparsity"])
            serves["moe_long_window"] = {"launches": moe_long["launches"]}
        if name == "moe_paged":
            check_same_tokens(name, run, moe_tokens, "moe_sparse_b")
        del run
        gc.collect()
        torch.cuda.empty_cache()
        clock.done(f"{name} checks")
    sb, ab = (moe_profiles[p]["griffin_spmm_ms_per_call"]
              for p in ("moe_sparse_b", "moe_mode_ab"))
    print(f"[serve moe] griffin_spmm device ms per decode step (a 4-step "
          f"chunk): Mode.AB (dual) {ab:.3f}, Sparse.B {sb:.3f}, ratio "
          f"{ab / sb:.3f}; experts no row chose per (layer, decode step): "
          f"{serves['moe_mode_ab']['empty_experts']}; {card}")
    moe_full = phase_moe_depth(torch, card)
    serves["moe_full_depth"] = {"launches": moe_full["launches"]}
    clock.done("moe_full_depth")
    drop_weights(torch)
    launches, train_record = phase_train(torch, card)
    serves["train"] = {"launches": launches}
    gc.collect()
    torch.cuda.empty_cache()
    clock.done("train")
    for name, cell in FAULT_CELLS.items():
        serves[name] = phase_fault(torch, name, card,
                                   unfaulted.get(cell["path"]), **cell)
        torch.cuda.empty_cache()
    clock.done("fault")
    for name, cell in ROUTER_CELLS.items():
        run, launches, record = phase_router(torch, name, **cell)
        serves[name] = {"launches": launches, **record}
        if "--profile" in sys.argv[1:]:
            phase_profile_router(torch, name, run)
        del run
        torch.cuda.empty_cache()
    drop_weights(torch)
    clock.done("router")
    launches, cycle_checks, cycle_summary, cycle_model = \
        phase_cycle_model(torch, sweep)
    serves["cycle_model"] = {"launches": launches}
    rows += cycle_checks
    summary["batch_eval"] = cycle_summary
    clock.done("cycle_model")
    launches, autotune_record = phase_autotune(torch, card)
    serves["autotune"] = {"launches": launches}
    clock.done("autotune")

    kernels = []
    sources = {"dense_gemm": ("src/repro_torch/csrc/dense_gemm.cu",
                              "src/repro/kernels/dense_gemm/kernel.py:35"),
               "griffin_spmm": ("src/repro_torch/csrc/griffin_spmm.cu",
                                "src/repro/kernels/griffin_spmm/kernel.py:63"),
               "sparse_a": ("src/repro_torch/csrc/sparse_a.cu",
                            "src/repro/kernels/sparse_a/kernel.py:53"),
               "sparse_a_meta": ("src/repro_torch/csrc/sparse_a.cu",
                                 "src/repro/kernels/sparse_a/ops.py:80"),
               "batch_eval": ("src/repro_torch/csrc/batch_eval.cu",
                              "src/repro/kernels/batch_eval/ops.py:31")}
    for name, (src, replaces) in sources.items():
        row = summary[name]
        errs = [r["max_abs_err"] for r in rows if r["kernel"] == name]
        by_path = {p: sv["launches"][name] for p, sv in serves.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(errs), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row.get("device_ms"),
            "timed_shape": row["shape"] + row["config"]
            if name == "batch_eval" else
            [row["m"], row["k"], row["n"], row["dtype"]]})
        if name == "dense_gemm":      # its skinny route at xlstm's gates
            sk = summary["dense_gemm_skinny"]
            kernels[-1]["skinny"] = {
                key: sk[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}
            kernels[-1]["skinny"]["timed_shape"] = [sk["m"], sk["k"],
                                                    sk["n"], sk["dtype"]]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report = {"card": card, "build_s": build_s, "checks": rows,
              "serve": serves, "long_prefill": long_prefill,
              "xlstm_prefill": xlstm_prefill,
              "hybrid_long_window": hybrid_long,
              "moe_long_window": moe_long,
              "moe_full_depth": moe_full,
              "train": train_record,
              "phase_s": clock.seconds,
              "cycle_model": cycle_model,
              "autotune": autotune_record,
              "spmm_granularity": summary["griffin_spmm_granularity"],
              "kernels": kernels,
              "wall_s": time.perf_counter() - t0}
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"[done] wall {report['wall_s']:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
