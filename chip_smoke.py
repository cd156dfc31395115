"""Drive the PyTorch/CUDA port on one GPU: build, check, fit, report.

    python3 chip_smoke.py                  # the full run: one card, no arguments
    python3 chip_smoke.py --n-iter 300 --exaggeration-iters 150   # shorter descents
    python3 chip_smoke.py --sharded-only   # phases 1, 2, 5 and 13 (for several cards)
    python3 chip_smoke.py --mouse-only     # phases 1, 2, 14 and 15 (the mouse embedding only)
    python3 chip_smoke.py --lm-only        # phases 1, 2 and 17 (the LM serving path only)
    python3 chip_smoke.py --train-only     # phases 1, 2 and 18 (the LM training path only)
    python3 chip_smoke.py --moe-only       # phases 1, 2 and 19 (the MoE family only)
    python3 chip_smoke.py --recurrent-only # phases 1, 2, 20 and 21 (the ssm and hybrid families)
    python3 chip_smoke.py --multimodal-only # phases 1, 2, 22 and 23 (the audio and vlm families)
    python3 chip_smoke.py --dryrun-only    # phases 1, 2, 17, 18 and 24 (the dry-run's bounds)
    python3 chip_smoke.py --multidevice-only # phases 1, 2 and 25 (multi-device training)

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device   -- a CUDA device is required; prints the card's name and power
               limit as nvidia-smi reports them; TF32 off for matmul/cuDNN.
2. build    -- compiles every kernel in src/repro_torch/csrc (one nvcc per
               source, all in parallel) and prints the seconds it took.
3. kernels  -- each kernel's wrapper (the call the main path makes)
               against its plain PyTorch twin on the card at
               the main path's shapes (MNIST size, 70 000 x 784, K = 90),
               with the tolerance stated beside each check; CUDA-event
               timings (median of several runs) of kernel, plain version
               and, where one exists, a single PyTorch library call,
               and the kernel's device time from a torch.profiler trace.
               pairwise is also checked on ragged tiles (the main path's
               last block and chunk), on rows at no 16-byte boundary and
               at D = 781, at 1, 2 and 3 query rows (an embedding-service
               admission's) against a full 8 192-row chunk and the train
               split's ragged last chunk, and by the KNN of 4 096 queries
               from its tiles against the KNN from the plain tiles; the KNN of 100 rows
               five times each on the card must give the plain CPU KNN's
               indices (equal distances in index order); attractive with the
               rows' real lengths (p_len, as the fits call it) and over
               the full width W, both timed.  bsp is also checked on
               4 096 rows at every K where ops.bsp_plan changes its
               choice (1 .. 1024), rows of all-equal distances and of
               zeros among them, at 1 and 3 rows (K = 90, an admission's),
               and the chunked search must repeat the whole one bit for
               bit; its bound counts the SFU's exponentials.
               The FFT path's spread and gather are also checked at
               128 boxes and exactly on planted lattice-node points, boxes
               overhanging the lattice's edges included; both are checked
               for a bit-identical result from two calls (48 and 128
               boxes) and over every lattice size (n_boxes 1-128,
               N = 5 000; the gather also at N = 1, 31 and 33); the
               gather with real weights on boxes that overhang the
               lattice (its checked path); the spread on a compressed
               lattice (one far outlier puts the other points into the
               first band), which is timed.
               Device times from torch.profiler for every kernel row; the
               spread's also at 128 boxes.  bh_traverse (the Barnes-Hut
               walk: a pack kernel, then a thread a point over the
               packed node records) must repeat its plain twin bit for
               bit (force, z, steps) at N = 1, 31, 33, 1 000, 5 000 and
               70 000, theta 0.5 and 0.2 (and 0 up to N = 1 000), on
               compressed and uncompressed trees, at a random embedding,
               on duplicate and on coincident points, and on clusters
               1e4 apart whose warps straddle them (N = 69 997); its
               packed records must equal pack_nodes bit for bit.
4. gradient -- bh_gradient and fft_repulsion at a fixed y, N = 5 000, on
               the card against the port's own CPU path; and small fits
               (N = 500, Barnes-Hut and FFT) on the card against the same
               fits on the CPU.
5. fit      -- repro_torch.api.TSNE(method="barnes_hut",
               neighbor_method="exact", perplexity=30, random_state=0) on
               make_dataset("mnist") (70 000 x 784), with every kernel's
               launch count reset before and read after, the default
               1 000 descent steps (250 exaggerated); pairwise and bsp
               must be > 0, morton, attractive and bh_traverse launched
               once a step, every attractive launch must carry p_len, and
               the embedding and KL must be finite.  The fit is traced
               (trace= a path under build/): its spans fit, knn, bsp,
               symmetrize, gradient_descent (the four children of fit),
               early_exaggeration, main_phase and checkpoint; timings_ the
               spans' durations; a Chrome trace that json.load reads; the
               fit.iterations metric n_iter_.  Then bh_traverse at
               the fitted embedding: checked bit for bit as in 3 and timed
               (its kernels-line row, the pack's and the walk's device
               times apart), with the warps' mean union length against
               the mean walk of their longest lane.
6. breakdown -- one Barnes-Hut step at the fitted embedding, stage by
               stage (Morton, sort, tree, summaries, traversal,
               attractive, update), to show where a step's time goes,
               held against the backend's own gradient; and the card's
               idle share: kernel time from a torch.profiler trace of one
               descent step over the CUDA-event time a step of several
               run back to back with no sync, as the fit runs them.
7. fft fit  -- the same fit with method="fft" (48 boxes a dimension),
               also 1 000 steps (250 exaggerated); pairwise, bsp,
               attractive, fft_spread and fft_gather must be > 0, with
               spread = gather = attractive = steps run; traced and
               checked as in 5.  A second, untraced descent from the fit's
               graph and initial embedding (core.tsne.descend, the loop
               run_tsne runs) must give a bit-identical embedding and KL.
8. fft breakdown -- one FFT step at its fitted embedding, stage by stage
               (coords, spread, convolution, gather, attractive, update)
               through the functions fft_repulsion calls, held against
               the backend's own gradient; the spread and gather kernels'
               device times at the fitted embedding, alone and in the
               profiled step; and the idle share as in 6.

9. approx-knn -- rp_forest (default options) and then nn_descent on all of
               make_dataset("mouse_1p3m") (1 291 337 x 20, K = 90): the
               seconds of each, every row valid (in range, no self, no
               duplicate), the reported d2 the true distance on 4 096
               sampled rows, and the recall on those rows against their
               exact neighbours (pairwise kernel tiles, self masked).  At
               N = 20 000 of the same rows the card's rp_forest graph
               against the CPU's (the same draws): recall of one against
               the other >= 0.99, their recalls against exact within 0.01.
10. approx fit -- TSNE(method="barnes_hut", neighbor_method="rp_forest",
               perplexity=30, random_state=0) on MNIST's train split (the
               first 60 000 rows) with a forest of 32 trees of >= 128
               points (APPROX_FOREST), at the other fits' steps: pairwise
               must launch 0 times, bsp > 0, morton, attractive and
               bh_traverse once a step; the same fit on the exact graph
               must end within 0.15 of its KL.
11. transform -- the 10 000 held-out rows through the rp_forest fit's
               query_index_ and through an exact index over the train
               split (rows/s of each at the default batch of 128; the
               exact one must launch pairwise_sq_dists and bsp_search,
               the forest one bsp_search); the forest query's recall
               against exact >= 0.9 (the default forest's printed beside
               it); embedding-space 5-NN label accuracy >= the input-space
               baseline - 0.05; 256 rows on the card against the CPU
               through the same exact index (the tolerance in the
               phase); save then load must serve the same transform.
12. service  -- EmbeddingService(slots=64, max_k=96) on the card, caching
               10's two fits as "mnist_forest" (its forest index) and
               "mnist_exact" (the exact-graph fit, whose ExactIndex runs
               pairwise tiles), traced; 1 024 held-out rows submitted to
               each, alternating, and drained with run(): every request
               done and finite; completed 2 048, slot occupancy up to 64,
               queue depth >= 1, both gauges 0 at the end; the
               transform_step probe grown by exactly 1 (the [64, 96]
               step); bsp_search launched once an admission, pairwise 8
               tiles an exact admission and none for a forest one.  Each
               model's results against its TSNE.transform of the same rows,
               and 128 requests on a CPU service against the card's
               (median |dy| <= 1e-5 x span, >= 98% of rows within 1e-3 x
               span).  Prints requests/s, latency p50/p95/p99, steps, ticks
               and the service.admit / service.tick span totals; then runs
               python -m repro_torch.embed.service --smoke --trace
               build/service_trace.json, which must exit 0 and write a
               trace that loads.
13. sharded  -- the multi-device path (core/distributed.py) on
               Mesh((cuda:0,) * 4), four real shards on one card:
               bh_traverse at each shard's sorted positions bit for bit
               against the plain walk at those positions and the full
               walk's rows (N = 33, 5 000, 70 000; the BH fit's embedding
               and the far-apart clusters of 3), attractive_ell with each
               shard's row offset bit for bit against the full pass's
               rows; distributed_bh_gradient at the BH fit's embedding
               against bh_gradient (f_rep rows bit-identical, Z, KL and
               gradient to the partial sums' order), one sharded step
               against the single-device step, stage by stage, with its
               idle share; ring_knn on MNIST against the exact KNN (row
               sets >= 99.9%, d2 within pairwise's tolerance) and
               ring_knn_approx with its defaults on all of mouse_1p3m
               (seconds, validity, recall on phase 9's rows);
               launch.tsne_run.run_distributed on MNIST at the BH fit's
               steps, launch counts reset before and read after (morton,
               attractive, bh_traverse 4 a step; its KL with sum p log p
               added back within 2% of phase 5's).  With more than one
               card visible the gradient, both rings and the fit again on
               a mesh of every card.  Last, preprocess with
               TsneConfig(neighbor_method="sharded") on MNIST over the
               visible cards: the graph's invariants and seconds.
14. mouse    -- the paper's headline experiment through the port's example,
               python -m repro_torch.examples.mouse_pipeline's main with
               --n 1291337 --shards 4 --method barnes_hut --iters 300
               --ckpt_every 100 (into a temporary directory): all of
               mouse_1p3m (N is not cut; 300 steps, the reference
               docstring's million-point example, are the one cut), KNN
               by the sharded backend on Mesh((cuda:0,) * 4) (the forced
               mesh size), bsp and symmetrization in 100 000-row chunks.
               Launch counts set to 0 just before and read just after:
               bsp > 0, Morton, attractive and the walk 300 each.  Prints
               the knn / bsp / symmetrize seconds, the ELL width W, nnz,
               the graph's GiB, ms a step, the KL every 50 steps and the
               peak of torch.cuda.max_memory_allocated; the KL must be
               finite and lower at step 300 than at 250 (the last
               exaggerated step's read).  A second run from a copy of the
               step-200 checkpoint (the same graph) must end with the
               straight run's embedding bit for bit.  Then bsp (on a
               [100 000, 90] slice, the path's launch shape), Morton,
               attractive and the walk at the final embedding and graph:
               wrapper, device and plain ms beside the bound, the walk bit
               for bit against its plain twin.
15. naive    -- the paper's per-step rows (Tables 5/6) on the card, at the
               BH fit's MNIST embedding (phase 5) and at the mouse fit's
               final one: core.naive's level-by-level build and summaries
               against Morton + sort + build_quadtree + summarize, and
               naive_attractive (a loop over the W slots) against the
               attractive_ell kernel; each speedup printed.  Naive on the
               card against naive on the CPU (ids and counts equal,
               centres of mass and forces allclose(rtol=1e-5,
               atol=1e-6)), and the two attractive passes against each
               other at that tolerance.
16. contracts -- (run right after phase 2, before the profiler's other
               uses) python -m repro_torch.analysis --gate (the launch-contract
               pass over every kernel at K = 1024, 257 lattice nodes,
               D = 1024 and N = 1 291 337, on meta tensors, and the
               host-sync and concurrency passes) must report no new
               finding; then each of the seven kernels is launched once
               at a small shape under torch.profiler, and each kernel
               event's grid, block and dynamic shared memory (the trace's
               static + dynamic less ptxas's static) must equal
               ops.launch_plan's for the call's integer arguments;
               registers x threads <= 65 536 and shared memory <=
               232 448 B.  One line a kernel with the card's name and
               power limit; what the trace does not give is "not recorded".
17. lm       -- (run right after phase 16, while the card is empty) the LM
               serving path at full width: deepseek_7b (30 layers,
               d_model 4 096, 6.91 B parameters in float32) initialised
               by the port's own init from a seeded generator, on cuda:0
               with TF32 off.  (a) compute_dtype float32: prefill of 2 x 64
               tokens against 64 decode steps, last logits within
               rtol 1e-3 / atol 1e-4 (the reference's
               test_decode_matches_prefill) and the same argmax.  (b)
               bf16, one prompt of 1 300 tokens (three chunks of 512, the
               last ragged): the prefill's last logits through
               chunked_attention and through the plain attention core,
               each within LM_BF16_REL of the logits' scale of the float32
               model and of each other; the bf16 prefill timed.  (c)
               ServeEngine(slots=8, max_seq=512) in bf16 over 9 requests
               (prompts of 64-192 seeded tokens, 64 new tokens each): all
               complete inside the vocabulary; one request served alone
               gives its pooled run's first logits (LM_ALONE_REL); prints
               the median decode tick against its byte bound, generated
               tokens/s, the host's share of a tick (the kernel time of
               five profiled ticks of this run against the median of its
               other ticks), peak device memory and the serve.* snapshot.  (d) repro_torch.examples.lm_embedding_atlas
               at its defaults (the reduced deepseek_7b's prefill states,
               a Barnes-Hut TSNE, 32 points grown through the
               EmbeddingService), launch counts set to 0 just before and
               read just after: pairwise, bsp, Morton, attractive and the
               walk each launched; KL, intra / inter, the service's p50;
               then each of the five held against its plain twin on the
               atlas's own inputs (x_fit [96, 50], its KNN distances, the
               admissions' queries, the fitted embedding and graph), at
               phase 3's tolerances.  (e) at B = 1, S = 1 300, H = 32,
               dh = 128, bf16: chunked_attention against the plain core on
               the same q, k, v, causal and not, within LM_ATTN_REL of each
               row's scale, and three planted faults (causal mask dropped,
               diagonal dropped, ragged padding unmasked) each beyond it;
               F.scaled_dot_product_attention(is_causal=True) timed beside
               chunked_attention: the library yardstick, used nowhere.
18. train    -- (right after phase 17, its model freed) the LM training
               path.  (a) one layer's attention at the training shape (B
               1, S 4 096, 24 query heads over 8 KV heads of 128, causal,
               chunk 512), float32 and bf16: chunked_attention's custom
               backward (dq, dk, dv) against float64 autograd through a
               plain core, each within TRAIN_ATTN_REL of the gradient's
               scale; three planted faults (delta dropped: the backward
               given a zero forward output; the GQA group sum dropped: the
               backward over K and V repeated to 24 heads, the group's
               first head kept; the scale missing from ds: dq and dk times
               sqrt(dh)) each beyond it; forward + backward timed beside
               SDPA's (the library yardstick, used nowhere).  (b)
               phi4_mini_3p8b at full width (32 layers, d_model 3 072,
               24 / 8 heads of 128, d_ff 8 192, vocab 200 064, tied;
               3.84 B parameters in float32), random weights from seed 0,
               with the reference's own options bf16 moments, a factored
               second moment and 4 microbatches; TokenPipeline(vocab, 4,
               4 096, seed 0) through Trainer.run for 4 steps with one
               checkpoint (at step 4, into a temporary directory removed
               afterwards).  Cuts: train_4k's global batch 256 -> 4 and
               4 steps; widths, depth and sequence not cut.  Prints each
               step's loss and ms, tokens/s, each optimizer update's ms
               (CUDA events around adamw_update), peak GiB, the
               checkpoint's GB and seconds; the losses must be finite, the
               first equal to loss_fn apart on the initial parameters and
               step 0's microbatches bit for bit, and within LM_BF16_REL of
               the float32-compute model's; then one microbatch's forward
               and backward at the trained parameters, its wall and its
               kernel time by name (torch.profiler).  (c) the restart drill at
               examples/train_lm.py's default model (12 x 768, vocab
               32 768, float32), batch 8 x 256: 8 steps, a checkpoint every
               2, a failure at step 5 resumed by run_with_restarts; the
               parameters and optimizer state equal an uninterrupted run's
               bit for bit.  (d) python -m repro_torch.launch.train --arch
               phi4_mini_3p8b --reduced --steps 4 and python -m
               repro_torch.examples.train_lm --steps 10 on the card, from a
               scratch directory: exit 0 and a finite last loss.
19. moe      -- (right after phase 18, its model freed) the MoE family:
               deepseek_v2_lite_16b at full width and depth (27 layers,
               the first dense; 26 of 64 experts top-6 with 2 shared; MLA
               with kv_lora 512; vocab 102 400; 15.7 B parameters by
               param_count), the port's own init from a seeded
               generator, TF32 off.  (a) float32 storage and compute
               (58.5 GiB) with capacity_factor raised to 64, as the
               reference's test does: prefill of 2 x 64 tokens against 64
               decode steps (the absorbed decode against the latent cache
               against the materialised path), last logits within
               rtol 1e-3 / atol 1e-4 and the same argmax.  (b) bf16
               storage and compute at the published capacity_factor
               1.25 (each expert takes one token a tick at 8 slots):
               ServeEngine(slots=8, max_seq=512) over 8 requests (prompts
               of 64-192 seeded tokens, 64 new tokens each), all complete
               inside the vocabulary; prints the median decode tick
               against its byte bound, generated tokens/s, peak GiB and
               the latent cache's bytes against a per-head K/V cache's of
               the same shape.  Cut: storage float32 -> bf16 (float32
               storage plus the bf16 copy _cast makes every call would be
               94 GB).  (c) float32 storage, bf16 compute, depth 27 -> 4
               (one dense layer, three MoE; 2.26 B parameters), batch 4 x
               1 024 (TokenPipeline seed 0) through Trainer.run for 4
               steps: the losses finite, aux_loss finite and positive, the
               first loss equal to loss_fn apart on the initial
               parameters bit for bit (the combine sums each row's terms
               in a fixed order); prints step ms, tokens/s, peak GiB.  Cuts: depth 27 -> 4, train_4k's batch 256 x 4 096 ->
               4 x 1 024, 4 steps; its one checkpoint is not written
               (phase 18 writes one).  (d) the reduced deepseek_v3_671b
               (sigmoid_bias router with norm_topk_prob, q_lora, MTP, bf16
               factored moments, 8 microbatches): one train step with
               mtp_loss among its metrics, one ServeEngine run inside the
               vocabulary, and its float32 loss on the card against the
               CPU's (rtol 1e-4).  (e) tie order: the routed FFN at full
               width on 4 096 rows of planted exact ties (equal rows, and
               an under-full expert's zero gates): the top-6 and every
               capacity selection equal on the card and on the CPU.
20. ssm      -- (right after phase 19, its model freed) the ssm family:
               rwkv6_3b at full width and depth (32 RWKV-6 layers,
               d_model 2 560, 40 heads of 64, d_ff 8 960, vocab 65 536;
               3 075 770 880 parameters, param_count's estimate
               3 344 957 440), the port's init from a seeded generator,
               float32 storage, TF32 off.  (a) float32 compute: prefill
               of 2 x 64 tokens (the chunked WKV) against 64 decode steps
               (the one-step recurrence), last logits within rtol 1e-3 /
               atol 1e-4 and the same argmax.  (b) bf16 compute:
               ServeEngine(slots=8, max_seq=512) over phase 17's 9
               requests, all complete inside the vocabulary; request 8,
               which enters a slot another request left, served alone
               gives its pooled first logits to two bf16 epsilons (the
               engine zeroes a refilled slot's state); prints the median
               decode tick against its byte bound, tokens/s, the host's
               share of a tick, peak GiB and the state's bytes against a
               per-head K/V cache's of the same depth at 512.  (c) depth
               32 -> 4, batch 4 x 1 024 (TokenPipeline seed 0) through
               Trainer.run for 3 steps: losses and gradient norms finite,
               the first loss equal to loss_fn apart bit for bit; step
               ms, tokens/s, peak GiB.  (d) the chunked WKV against the
               sequential scan at B 1, T 1 024, H 40, P 64, decay
               uniform(0.05, 0.999): outputs and final state within rtol
               / atol 1e-4.  Cuts: (c)'s depth, batch and steps.
21. hybrid   -- (right after phase 20, its model freed) the hybrid
               family: zamba2_2p7b at full width and depth (54 Mamba-2
               layers, d_model 2 560, d_inner 5 120, 80 heads of 64,
               state 64, conv 4, chunk 128; the shared block of 32 heads
               of 80 and d_ff 10 240 applied 9 times; vocab 32 000;
               2 422 220 960 parameters, param_count 2 427 453 440):
               the published init's logits are all 0 (the reference's
               stack has no residual around a Mamba block and collapses
               to 0 past ~11 layers; printed), so each Mamba out_proj is
               scaled by sqrt(2 L) (unit_scale_mamba) for (a)-(c), and
               a compared logits scale of 0 fails the phase.  (a)-(c) as
               phase 20, (c) at depth 54 -> 12 (the shared block applied
               twice) at the published chunk of 128, the gradient norms
               finite; (d) _ssd_chunked at chunk 128, B 1,
               T 1 024, H 80, P 64, N 64, A = -1 and dt in [0.75, 0.9], so
               that the reference's exponent above the diagonal passes
               float32's exp limit (its gradient would be NaN): y and its
               gradient to x, B, C, dt, a_log against float64 autograd
               through the sequential recurrence within 1e-4 of each
               one's scale, the gradient finite.
22. audio    -- (right after phase 21, its model freed) the audio family:
               whisper_tiny at full width and depth (4 encoder + 4
               decoder layers, d_model 384, 6 heads of 64, d_ff 1 536,
               1 500 frames, vocab 51 865, tied; 41 157 888 parameters),
               the frontend a stub (frames [B, 1 500, 384] drawn from a
               seed), float32 storage.  (a) float32: prefill of 2 x 64
               tokens over the frames against 64 decode steps with the
               cache's cross pair filled by _cross_kv(_encoder(frames)),
               last logits within rtol 1e-3 / atol 1e-4 and the same
               argmax; against the zero cross pair (the reference's
               serving state: nothing fills it) the gap must be over 100x
               larger.  (b) bf16 compute: 16 requests drawn as phase 17's
               through ServeEngine(slots=8, max_seq=512), text only as in the
               reference (the cross pair stays zero); the median tick
               against its byte bound (8 B a parameter for the cast, the
               self cache and the 73.7 MB cross pair), tokens/s, host
               share, peak.  (c) FrontendPipeline frames [4, 1 500, 384]
               and 448 text tokens (whisper's decoder context) through
               Trainer.run for 4 steps: losses finite, the first bit for
               bit with loss_fn apart; step ms, tokens/s, peak.  (d) the
               encoder's non-causal chunked_attention at B 4, 1 500 keys
               (padded to 1 536), forward and backward against float64
               autograd (AUDIO_ATTN_REL), the padding counted as keys a
               planted fault beyond it; the reduced whisper's float32
               loss and prefill, card against CPU (rtol 1e-4).  Cuts:
               train batch 4 and 4 steps.
23. vlm      -- (right after phase 22) the vlm family: llava_next_34b at
               full width (60 layers, d_model 7 168, 56 query heads over
               8 KV heads of 128, d_ff 20 480, vocab 64 000, 2 880 patches
               [B, 2 880, 7 168] drawn from a seed; 34 388 917 248
               parameters).  (a) float32 at 8 layers (5.38 B parameters,
               21.5 GB): decode of 2 x 64 text tokens against the
               text-alone prefill of the same weights (rtol 1e-3 / atol
               1e-4, argmax); the prefill of 2 880 patches + 64 tokens
               finite and away from the text alone's; bf16 compute's
               within LM_BF16_REL of float32's scale.  (b) full depth in
               bf16 storage (68.78 GB): that prefill at batch 1 timed
               against its FLOP bound at 989 TFLOP/s; then 8 requests
               drawn as phase 17's are (64-192 prompt tokens, 64 new)
               through ServeEngine(slots=8, max_seq=512), text only as in
               the reference (one wave, no refill): the tick against its
               byte bound
               (2 B a parameter and the 1.0 GB cache), tokens/s, host
               share, peak.  (c) 2 layers, float32 storage: 2 x (2 880
               patches + 128 tokens) through Trainer.run for 4 steps,
               the first loss bit for bit; step ms, positions/s, peak.
               (d) the reduced llava's float32 loss and prefill, card
               against CPU.  Cuts: (a)'s depth 60 -> 8 (float32 storage
               at 60 is 137.6 GB), (b)'s storage float32 -> bf16 and its
               requests 16 -> 8 (time), (c)'s depth 60 -> 2, batch 2 and
               4 steps.

24. dryrun   -- (right after phase 23) the dry-run tooling against the
               card: phase 17's bf16 decode tick (deepseek_7b, 8 slots x
               512) and phase 18's train step (phi4_mini_3p8b, TRAIN_BATCH
               x TRAIN_SEQ, its options) built as launch.cell cells on a
               1 x 1 logical mesh and counted by launch.cost on meta
               tensors: FLOPs, unfused bytes, the bound at 989 TFLOP/s and
               3.35 TB/s and its dominant term, beside the phase's measured
               median.  The bound must not exceed the median (a bound above
               it is an overcounted operation), and the counted per-device
               argument bytes must equal the nbytes of the tensors the phase
               held (parameters, cache or optimizer moments, tokens).  Then
               python -m repro_torch.launch.dryrun --arch deepseek_7b
               --shape decode_32k as a subprocess: rc 0 and an ok record.
25. multidevice -- (right after phase 24) multi-device training on the
               single-controller mesh, four (or eight) shards of cuda:0
               (REPRO_TORCH_MESH_DEVICES).  (a) compressed_psum over 8
               shards of 1 M float32: every rank's bits equal, equal to the
               CPU's, within 8 x scale of the exact sum; pipelined over 4
               stages (8 microbatches of 256 x 1 024, tanh(x w + b))
               against the sequential apply of the same microbatches at
               rtol 1e-5, atol 1e-6.
               (b) deepseek_v2_lite_16b's MoE block at full width (64
               experts, top-6, d_model 2 048, expert_d_ff 1 408) on a 2
               data x 4 model mesh, x [4, 512, 2 048] and the router on
               grids where every logit is exact: at capacity factor 64 EP
               against the local branch (rtol 2e-4, atol 2e-5, the
               reference's), its aux_loss and expert_load data shard 0's;
               at the published 1.25 EP on the card against EP on the CPU.
               (c) phi4_mini_3p8b at full width, 2 layers (bf16 factored
               moments, 2 microbatches, batch 8 x 1 024) through
               launch.train's path on a 2 x 2 mesh (make_local_mesh, the
               Trainer under use_mesh_rules) for 4 steps against the
               single-device Trainer on the same batches: each step's loss
               and grad norm within 1e-4 of the single-device run's
               (relative), the final parameters and optimizer moments
               within MD_STATE_REL of each leaf's scale, and every data
               replica's parameters and optimizer state equal to replica
               0's bit for bit, with one replica a distinct card; both
               runs' step ms, tokens/s, peak memory and the bytes the
               collectives move between shards a step.  With four or more
               cards, (c) also on a mesh of four real cards (remat on, as
               the configuration has it).  Cuts: (c)'s depth 32 -> 2 and
               4 steps.

Every kernel must be launched by at least one of the two fits.  Each
driven path (the two fits, the service, the sharded fit, the mouse
pipeline and the LM atlas) has its launch counts set to 0 just before it
and read just after.

The line before the last is the kernels JSON object (each row's
``sharded_launches`` from the sharded fit, ``mouse_launches`` from the
mouse pipeline and, for its four kernels, ``mouse_*`` times at
N = 1 291 337, ``launch_contract``, phase 16's records, and for the atlas's
five kernels ``lm_atlas_launches`` and ``lm_atlas_max_abs_err``, phase
17's); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM data-sheet peaks (dense): fp32 outside the tensor cores, TF32
# on the tensor cores, HBM3, bf16 on the tensor cores; and the special-function units (MUFU: exp2,
# log2, reciprocal), 16 results a clock on each of 132 SMs at 1.98 GHz.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
PEAK_SFU_OPS = 132 * 16 * 1.98e9
PEAK_BF16_FLOPS = 989e12

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build"

# Main-path KNN blocks: larger than the JAX defaults (512 x 2048), which
# were sized for TPU VMEM; a [4096, 8192] fp32 tile is 128 MiB on the card.
KNN_BLOCK_Q = 4096
KNN_BLOCK_DB = 8192


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps: int = 5, inner: int = 3) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``inner`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS,
          sfu: float = 0.0) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the largest of flops at ``peak``, sfu
    special-function results (an expf is one) at the SFU rate, and nbytes
    at the HBM rate."""
    t_ops = max(flops / peak, sfu / PEAK_SFU_OPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> dict[str, str]:
    """Phase 2; returns each compiled source's -Xptxas -v report."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {len(logs)} kernels compiled in {time.perf_counter() - t0:.2f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "entry function" in line:
                log(f"  {name}: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line:
                log(f"  {name}:   {line.strip()}")
    log(f"  pairwise: {build.load('pairwise').pairwise_smem_bytes()} bytes of dynamic "
        "shared memory a block")
    return logs


def kernel_ms(fn, name: str, reps: int = 10) -> float | None:
    """Device milliseconds of one launch of the CUDA kernel whose name holds
    ``name`` (each wrapper launches one kernel a call): the mean over the
    launches that a torch.profiler trace of ``reps`` calls of ``fn``
    recorded.  The mean, not the sum over ``reps``: the trace can drop
    events.  None ("not measured") if three traces recorded no such launch."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):             # a trace that recorded no launch at all is taken again
        found = [us for k, durations in kernel_events(lambda: [fn() for _ in range(reps)]).items()
                 if name in k for us in durations]
        if len(found) != reps:
            log(f"device time of {name}: the trace recorded {len(found)} of {reps} launches")
        if found:
            return sum(found) * 1e-3 / len(found)
    return None


def pairwise_tol(d2, qn, cn):
    """The pairwise tolerance of a distance d2 between rows of squared norms
    qn and cn: the |q|^2+|c|^2-2qc form cancels, so its fp32 error scales
    with the norms."""
    return 2e-4 * d2.abs() + 1e-5 * (qn + cn)


def check_pairwise(what: str, q, c):
    """The kernel's tile against the plain version's (cuBLAS fp32) on the
    card; prints the error distribution and returns the largest error."""
    from repro_torch.core import _pairwise
    from repro_torch.kernels import ops
    qn, cn = torch.sum(q * q, 1), torch.sum(c * c, 1)
    out = ops.pairwise_sq_dists(q, c, qn, cn)
    ref = _pairwise.pairwise_sq_dists(q, c, qn, cn)
    err = (out - ref).abs()
    share = err / pairwise_tol(ref, qn[:, None], cn[None, :])
    sample = err.flatten()[::max(1, err.numel() // 1_000_000)].double()
    quant = torch.quantile(sample, torch.tensor([0.5, 0.99, 0.9999], dtype=torch.float64,
                                                device=sample.device)).tolist()
    log(f"pairwise {what}: [{q.shape[0]}, {q.shape[1]}] x [{c.shape[0]}, {c.shape[1]}], "
        f"byte offsets mod 16 {q.data_ptr() % 16} / {c.data_ptr() % 16}: max_abs_err "
        f"{float(err.max()):.3e} (|d| quantiles 50/99/99.99%: "
        f"{', '.join(f'{v:.3e}' for v in quant)}; largest distance {float(ref.max()):.3e}), "
        f"{float(share.max()):.3f} of the tolerance at most")
    if not bool((share <= 1.0).all()):
        fail(f"pairwise_sq_dists kernel disagrees with its plain version ({what})")
    return float(err.max())


def knn_rows(x, rows, k: int, dist):
    """K nearest neighbours of ``x[rows]`` among all rows of ``x`` (self
    excluded) from the tiles ``dist`` gives, in chunks of KNN_BLOCK_DB
    columns: (idx [R, k], d2 [R, k] ascending)."""
    n, nq = x.shape[0], rows.shape[0]
    q = x[rows].contiguous()
    q_sqn, sqn = torch.sum(q * q, 1), torch.sum(x * x, 1)
    big = torch.finfo(x.dtype).max
    best_d = torch.full((nq, k), big, dtype=x.dtype, device=x.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=x.device)
    for c0 in range(0, n, KNN_BLOCK_DB):
        c1 = min(c0 + KNN_BLOCK_DB, n)
        col = torch.arange(c0, c1, device=x.device)
        d2 = dist(q, x[c0:c1], q_sqn, sqn[c0:c1])
        d2 = d2.masked_fill(col[None, :] == rows[:, None], big)
        best_d, arg = torch.topk(torch.cat([best_d, d2], 1), k, dim=1, largest=False)
        best_i = torch.gather(torch.cat([best_i, col.expand(nq, -1)], 1), 1, arg)
    return best_i, best_d


def check_knn(x, k: int) -> None:
    """The KNN of the first KNN_BLOCK_Q rows from the kernel's tiles against
    the one from the plain tiles: every neighbour that one finds and the
    other does not must lie within the pairwise tolerance of the plain k-th
    distance (its own distance taken in float64)."""
    from repro_torch.core import _pairwise
    from repro_torch.kernels import ops
    nq = KNN_BLOCK_Q
    rows = torch.arange(nq, device=x.device)
    ik, _ = knn_rows(x, rows, k, ops.pairwise_sq_dists)
    ip, dp = knn_rows(x, rows, k, _pairwise.pairwise_sq_dists)
    sqn = torch.sum(x.double() ** 2, 1)
    worst = 0.0
    for mine, other in ((ik, ip), (ip, ik)):
        missed = ~(mine[:, :, None] == other[:, None, :]).any(-1)
        r, m = torch.nonzero(missed, as_tuple=True)
        j = mine[r, m]
        d_true = torch.sum((x[r].double() - x[j].double()) ** 2, 1)
        kth = dp[r, -1].double()
        if r.numel():
            tol = pairwise_tol(kth, sqn[r], sqn[j])
            worst = max(worst, float(((d_true - kth).abs() / tol).max()))
    shared = float((ik[:, :, None] == ip[:, None, :]).any(-1).float().mean())
    log(f"pairwise KNN check, {nq} queries x {k} neighbours: {shared:.6f} of the "
        f"neighbours shared; the others lie {worst:.3f} of the tolerance from the "
        f"plain k-th distance at most")
    if worst > 1.0:
        fail("the KNN from the kernel's tiles disagrees with the plain KNN")


def check_spread(what: str, g_k, g_p, quiet: bool = False) -> None:
    """The spread kernel's grid against the plain version's.  Both sum each
    node over the same products in other orders (the kernel's fixed
    in-order bands, the plain index_add_'s atomics on the card): rtol 1e-4
    with a floor at 1e-5 of the largest node value."""
    scale = float(g_p.abs().max())
    err = float((g_k - g_p).abs().max())
    if not torch.allclose(g_k, g_p, rtol=1e-4, atol=1e-5 * scale):
        fail(f"fft_spread kernel disagrees ({what}): max |d| {err:.3e} of max {scale:.3e}")
    if not quiet:
        log(f"fft_spread {what}: max_abs_err {err:.3e} (max {scale:.3e}; rtol 1e-4, "
            "atol 1e-5 x max)")


def check_bsp(what: str, p_k, b_k, p_p, b_p, quiet: bool = False) -> None:
    """The bsp kernel against the plain search: cond_p at rtol 1e-5 (atol
    1e-7), beta at rtol 1e-5, the Pallas kernel's parity target."""
    if not (torch.allclose(p_k, p_p, rtol=1e-5, atol=1e-7)
            and torch.allclose(b_k, b_p, rtol=1e-5)):
        fail(f"bsp_search kernel disagrees ({what}): max |dp| "
             f"{float((p_k - p_p).abs().max()):.3e}, max |dbeta|/beta "
             f"{float(((b_k - b_p).abs() / b_p.abs()).max()):.3e}")
    if not quiet:
        log(f"bsp_search {what}: max |dp| {float((p_k - p_p).abs().max()):.3e}, max "
            f"|dbeta|/beta {float(((b_k - b_p).abs() / b_p.abs()).nan_to_num().max()):.3e} "
            "(rtol 1e-5, atol 1e-7)")


def check_bsp_plans(gen, dev) -> None:
    """4 096 rows at every K where ops.bsp_plan changes its choice, and
    either side of it, with rows of all-equal distances and rows of zeros
    among them; perplexity K / 3, as the fits pick K, where that is above
    2 (K >= 7), and 1.5 below: at perplexity 1 or 2 the target entropy sits
    on the plateau of near-tied nearest neighbours (h tends to 0 or log 2
    as beta grows), where fp32 cannot decide the bisection (the plain
    search on the CPU and on the card disagree there in 15-502 of 4 096
    rows; chip_variants.py's bsp set, PERF.md)."""
    from repro_torch.core import bsp
    from repro_torch.kernels import ops
    changes = [k for k in range(2, ops.MAX_K + 1) if ops.bsp_plan(k) != ops.bsp_plan(k - 1)]
    ks = sorted({1, 5, 8, 16, 31, 32, 33, 64, 90, 96, 100, 128, 129, 256, 500, 1024}
                | set(changes) | {k - 1 for k in changes})
    for k in ks:
        d2 = torch.randn((4096, k), generator=gen).abs() * 4.0
        d2[::97] = 2.5           # all-equal distances
        d2[1::97] = 0.0          # zeros
        d2 = d2.to(dev)
        perp = k / 3.0 if k >= 7 else 1.5
        check_bsp(f"K = {k}", *ops.bsp_search(d2, perp),
                  *bsp.binary_search_perplexity_plain(d2, perp), quiet=True)
    log(f"bsp_search: K = {ks} (each side of every change of plan) on 4 096 rows, with "
        "all-equal and zero rows, within the tolerance")


def check_gather(what: str, ph_k, ph_p, quiet: bool = False) -> float:
    """The gather kernel against the plain gather: the same products and
    sum order, rtol 1e-5 with a floor at 1e-6 of the largest value where
    the 9 taps' signed Lagrange weights cancel.  Returns the largest error."""
    ph_scale = float(ph_p.abs().max()) if ph_p.numel() else 0.0
    err = float((ph_k - ph_p).abs().max()) if ph_p.numel() else 0.0
    if not torch.allclose(ph_k, ph_p, rtol=1e-5, atol=1e-6 * ph_scale):
        fail(f"fft_gather kernel disagrees ({what}): max |d| {err:.3e} of max {ph_scale:.3e}")
    if not quiet:
        log(f"fft_gather {what}: max_abs_err {err:.3e} (max {ph_scale:.3e}; rtol 1e-5, "
            "atol 1e-6 x max)")
    return err


def kernel_row(name, err, ms, plain_ms, flops, nbytes, library_ms=None,
               peak=PEAK_FP32_FLOPS, sfu=0.0, **extra) -> dict:
    """One entry of the kernels line (its launches are filled in after the
    fits), logged."""
    from repro_torch.kernels import ops
    b_ms, b_by = bound(flops, nbytes, peak, sfu)
    e = ops.kernel_registry()[name]
    log(f"kernel {name}: max_abs_err {err:.3e}  {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it)  "
        f"library {library_ms}" + "".join(f"  {k} {v}" for k, v in extra.items()))
    return dict(name=name, route="cuda", source=e["source"], replaces=e["replaces"],
                tpu_kernel=e["tpu"], launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms, **extra)


def check_knn_ties(x: torch.Tensor) -> None:
    """KNN of 100 rows, each five times (adjacent, and 100 rows apart):
    on the card, through the pairwise kernel, the indices must be those of
    the plain KNN on the CPU, equal distances in index order as lax.top_k
    keeps them (the kernel must give a row's copies equal distances)."""
    from repro_torch.core import knn
    rows = x[:100]
    for layout, xs in (("adjacent", rows.repeat_interleave(5, 0)), ("apart", rows.repeat(5, 1))):
        for bq, bdb in ((128, 256), (512, 2048)):
            idx, d2 = knn.knn(xs, 6, bq, bdb)
            idx_p, d2_p = knn.knn(xs.cpu(), 6, bq, bdb)
            if not torch.equal(idx.cpu(), idx_p):
                fail(f"KNN of duplicated rows ({layout}, blocks {bq} x {bdb}): the card's "
                     f"indices differ from the CPU's in "
                     f"{int((idx.cpu() != idx_p).any(1).sum())} of {xs.shape[0]} rows")
    log("knn ties: 100 rows x 5 copies (adjacent and apart), k = 6, blocks 128 x 256 and "
        "512 x 2048: the card's indices equal the plain KNN's on the CPU")


def walk_inputs(y: torch.Tensor, compress: bool = True, depth: int = 16):
    """(y_sorted, tree, summaries, perm) of embedding y, built as bh_gradient
    builds them."""
    from repro_torch.core import morton, quadtree
    from repro_torch.core.summarize import summarize
    from repro_torch.kernels import ops
    cent, r_span = morton.span_radius(y)
    codes_s, y_s, perm = quadtree.sort_points_by_code(
        y, ops.morton_encode(y, cent, r_span, depth))
    tree = quadtree.build_quadtree(codes_s, depth=depth, compress=compress)
    return y_s, tree, summarize(tree, y_s, r_span), perm


def far_clusters() -> dict[str, torch.Tensor]:
    """Two embeddings (on the CPU, N = 69 997, not a multiple of 32) whose
    Morton-consecutive points, the 32 of a warp, straddle far-apart
    clusters: every other point in one of two clusters 1e4 apart, and
    clusters of 7 points on a grid 1e4 apart."""
    gen = torch.Generator(device="cpu").manual_seed(19)
    two = torch.randn((69_997, 2), generator=gen)
    two[1::2] += 1e4
    cluster = torch.arange(69_997) // 7
    seven = torch.randn((69_997, 2), generator=gen) * 100.0 + 1e4 * torch.stack(
        [cluster % 100, cluster // 100], dim=1).to(torch.float32)
    return {"two clusters 1e4 apart": two, "7-point clusters 1e4 apart": seven}


def check_traverse(what: str, y: torch.Tensor) -> None:
    """bh_traverse against its plain twin on the card, bit for bit (force,
    z and steps), at N = 1, 31, 33, 1 000, 5 000 and all of y, theta 0.5
    and 0.2, and 0 (every walk visits every node) up to N = 1 000, on the
    compressed and the uncompressed tree; and the records its first kernel
    packs against pack_nodes, bit for bit, over the valid nodes."""
    from repro_torch.core.repulsive import RECORD_WORDS, bh_repulsion_sorted, pack_nodes
    from repro_torch.kernels import ops
    longest = 0
    sizes = sorted({min(m, y.shape[0]) for m in (1, 31, 33, 1000, 5000, y.shape[0])})
    for m in sizes:
        for compress in (True, False):
            y_s, tree, summ, _ = walk_inputs(y[:m].contiguous(), compress)
            n_nodes = int(tree.n_nodes)
            records = torch.full((tree.capacity, RECORD_WORDS), -1, dtype=torch.int32,
                                 device=y.device)
            ops.bh_traverse_cuda(y_s, tree, summ, 0.5, records=records)
            packed = pack_nodes(tree, summ)[:n_nodes]
            if not torch.equal(records[:n_nodes], packed):
                fail(f"bh_traverse's packed node records differ from pack_nodes ({what}, "
                     f"N = {m}, compress {compress}) at "
                     f"{int((records[:n_nodes] != packed).any(1).sum())} of {n_nodes} nodes")
            for theta in (0.5, 0.2, 0.0) if m <= 1000 else (0.5, 0.2):
                got = ops.bh_traverse(y_s, tree, summ, theta)
                ref = bh_repulsion_sorted(y_s, tree, summ, theta)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    fail(f"bh_traverse is not bit-identical to its plain twin ({what}, N = "
                         f"{m}, theta {theta}, compress {compress}): max |d force| "
                         f"{float((got.force - ref.force).abs().max()):.3e}, steps differ "
                         f"at {int((got.steps != ref.steps).sum())} points")
                longest = max(longest, int(ref.steps.max()))
    log(f"bh_traverse {what}: N = {', '.join(map(str, sizes))}; theta 0.5, 0.2 "
        f"(0 to N = 1 000); compressed and uncompressed trees: force, z and steps "
        f"bit-identical to the plain walk, packed records to pack_nodes (longest walk "
        f"{longest} steps)")


def phase_kernels(x: torch.Tensor, k: int, perplexity: float) -> list[dict]:
    from repro_torch.core import (
        _pairwise, attractive, bsp, fft_repulsion, knn, morton, similarity,
    )
    from repro_torch.kernels import ops

    dev = x.device
    n, d = x.shape
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = []

    def row(*args, **kwargs):
        rows.append(kernel_row(*args, **kwargs))

    # pairwise_sq_dists: one [KNN_BLOCK_Q, KNN_BLOCK_DB] x 784 tile of the KNN
    q = x[:KNN_BLOCK_Q].contiguous()
    c = x[KNN_BLOCK_Q:KNN_BLOCK_Q + KNN_BLOCK_DB].contiguous()
    qn, cn = torch.sum(q * q, 1), torch.sum(c * c, 1)
    err = check_pairwise("main tile", q, c)
    # ragged tiles: the main path's last query block and database chunk
    # (16-byte copies), and rows at no 16-byte boundary (4-byte copies): a
    # flat view one element in (x[1:1001] itself stays aligned at D = 784,
    # 3 136 bytes a row) and D = 781, not a multiple of 4
    check_pairwise("ragged last block", x[-(n % KNN_BLOCK_Q):], x[-(n % KNN_BLOCK_DB):])
    flat = x.reshape(-1)
    check_pairwise("misaligned flat view", flat[1:1 + 1000 * d].view(1000, d),
                   flat[5003 * d + 3:5003 * d + 3 + 3001 * d].view(3001, d))
    x781 = x[:, :781].contiguous()
    check_pairwise("D = 781", x781[1:1001], x781[5003:8004])
    # an admission's tiles: 1-3 held-out query rows against a full chunk
    # and the ragged last chunk of the train split
    last = TRAIN_ROWS // KNN_BLOCK_DB * KNN_BLOCK_DB
    for m in (1, 2, 3):
        qm = x[TRAIN_ROWS:TRAIN_ROWS + m]
        check_pairwise(f"{m} query rows, full chunk", qm, x[:KNN_BLOCK_DB])
        check_pairwise(f"{m} query rows, ragged last chunk", qm, x[last:TRAIN_ROWS])
    check_knn(x, k)
    nq, nc = q.shape[0], c.shape[0]
    log(f"pairwise yardstick: q @ c.T (cuBLAS fp32 product alone) "
        f"{cuda_ms(lambda: q @ c.T):.4f} ms")
    fp32_ms, _ = bound(2.0 * nq * nc * d + 3.0 * nq * nc,
                       4.0 * ((nq + nc) * d + nq + nc + nq * nc))
    ms = cuda_ms(lambda: ops.pairwise_sq_dists(q, c, qn, cn))
    # 3xTF32: three TF32 products on the tensor cores
    row("pairwise_sq_dists", err, ms, cuda_ms(lambda: _pairwise.pairwise_sq_dists(q, c, qn, cn)),
        flops=3 * 2.0 * nq * nc * d, nbytes=4.0 * ((nq + nc) * d + nq + nc + nq * nc),
        library_ms=cuda_ms(lambda: torch.cdist(q, c).square()), peak=PEAK_TF32_FLOPS,
        device_ms=kernel_ms(lambda: ops.pairwise_sq_dists(q, c, qn, cn), "pairwise"),
        bound_fp32_simt_ms=fp32_ms, fp32_simt_share=fp32_ms / ms)

    # bsp_search on the real [N, K] distances of the main path
    idx, d2 = knn.knn(x, k, KNN_BLOCK_Q, KNN_BLOCK_DB)
    p_k, b_k = ops.bsp_search(d2, perplexity)
    p_p, b_p = bsp.binary_search_perplexity_plain(d2, perplexity)
    check_bsp(f"[{n}, {k}], plan {tuple(ops.bsp_plan(k))}", p_k, b_k, p_p, b_p)
    # rows are independent and a row's arithmetic depends on K alone: the
    # chunked search (row slices at no 16-byte boundary) repeats it bit for bit
    p_c, b_c = bsp.binary_search_perplexity_chunked(d2, perplexity, chunk_size=10_007)
    if not (torch.equal(p_c, p_k) and torch.equal(b_c, b_k)):
        fail("bsp_search in chunks of 10 007 rows differs from the whole search")
    check_bsp_plans(torch.Generator(device="cpu").manual_seed(15), dev)
    # an admission's search: one row (and three), K = 90
    for rows_ in (d2[:1], d2[5:8]):
        check_bsp(f"[{rows_.shape[0]}, {k}]", *ops.bsp_search(rows_, perplexity),
                  *bsp.binary_search_perplexity_plain(rows_, perplexity))
    nk = d2.numel()
    fp32_ms, _ = bound(65.0 * 6.0 * nk, 0.0)
    row("bsp_search", float((p_k - p_p).abs().max()),
        cuda_ms(lambda: ops.bsp_search(d2, perplexity)),
        cuda_ms(lambda: bsp.binary_search_perplexity_plain(d2, perplexity), reps=3, inner=1),
        # 65 passes (64 bisection steps + the final one), each an expf (one
        # SFU result) and ~5 fp32 operations an entry; d2 read once,
        # cond_p written once
        flops=65.0 * 6.0 * nk, nbytes=4.0 * (2 * nk + n), sfu=65.0 * nk,
        device_ms=kernel_ms(lambda: ops.bsp_search(d2, perplexity), "bsp"),
        plan=list(ops.bsp_plan(k)), bound_fp32_ms=fp32_ms)

    check_knn_ties(x)

    # morton_encode on N points of an embedding-sized spread
    y = (torch.randn((n, 2), generator=gen) * 20.0).to(dev)
    cent, r_span = morton.span_radius(y)
    codes_k = ops.morton_encode(y, cent, r_span)
    codes_p = morton.morton_encode(y, cent, r_span)
    if not bool((codes_k == codes_p).all()):
        fail("morton_encode kernel is not bit-identical to its plain version")
    row("morton_encode", float((codes_k - codes_p).abs().max()),
        cuda_ms(lambda: ops.morton_encode(y, cent, r_span), inner=20),
        cuda_ms(lambda: morton.morton_encode(y, cent, r_span), inner=20),
        flops=6.0 * n, nbytes=8.0 * n + 8.0 * n + 12.0,
        device_ms=kernel_ms(lambda: ops.morton_encode(y, cent, r_span), "morton"))

    # bh_traverse on the same random embedding (its row, at the fitted
    # embedding, comes after the Barnes-Hut fit), on every third point
    # three times, on coincident points, and on far-apart clusters whose
    # Morton-consecutive points, the 32 of a warp, straddle them: every
    # other point in one of two clusters 1e4 apart, and clusters of 7
    # points on a grid 1e4 apart (N = 69 997, not a multiple of 32)
    check_traverse("random embedding", y)
    check_traverse("duplicate points", y[:n // 3].repeat_interleave(3, 0))
    check_traverse("coincident points", torch.zeros((33, 2), device=dev))
    for what, far in far_clusters().items():
        check_traverse(what, far.to(dev))

    # attractive_ell on the real symmetric graph of the main path, with the
    # rows' real lengths (as the fits call it) and over the full width
    sym_cols, sym_vals = similarity.symmetrize_ell(idx.cpu().numpy(), p_k.cpu().numpy())
    cols = torch.as_tensor(sym_cols, device=dev)
    vals = torch.as_tensor(sym_vals / sym_vals.sum(), device=dev).to(torch.float32)
    p_len = torch.as_tensor(similarity.ell_row_lengths(sym_cols), device=dev)
    nnz, w = int(p_len.sum()), cols.shape[1]
    log(f"graph: N={n} K={k} W={w} nnz={nnz} ({nnz / (n * w):.1%} of N x W), row length "
        f"mean {nnz / n:.2f} max {int(p_len.max())}")
    errs = {}
    for what, lens in (("p_len", p_len), ("full W", None)):
        f_k, kl_k = ops.attractive_ell(y, cols, vals, lens)
        f_p, kl_p = attractive.attractive_forces_ell(y, cols, vals, lens)
        # summation order differs (warp tree vs torch reduction): rtol 1e-4
        # with an absolute floor at 1e-5 of the largest force, KL to 1e-5
        f_scale = float(f_p.abs().max())
        if not (torch.allclose(f_k, f_p, rtol=1e-4, atol=1e-5 * f_scale)
                and abs(float(kl_k) - float(kl_p)) <= 1e-5 * abs(float(kl_p))):
            fail(f"attractive_ell kernel ({what}) disagrees with its plain version")
        errs[what] = float((f_k - f_p).abs().max())
    full_ms = cuda_ms(lambda: ops.attractive_ell(y, cols, vals), inner=10)
    full_dev = kernel_ms(lambda: ops.attractive_ell(y, cols, vals), "attractive")
    # real entries only: cols and vals of nnz entries, y and row_len read,
    # force and the KL partials written; ~13 operations an entry
    a_flops, a_bytes = 13.0 * nnz, 8.0 * nnz + 8.0 * n + 4.0 * n + 8.0 * n + 4.0 * n
    a_bound, _ = bound(a_flops, a_bytes)
    log(f"attractive_ell full W (row_len=None): max_abs_err {errs['full W']:.3e}  "
        f"{full_ms:.4f} ms ({full_dev} ms on the device)  {a_bound / full_ms:.1%} "
        f"of the bound counted on nnz")
    row("attractive_ell", errs["p_len"],
        cuda_ms(lambda: ops.attractive_ell(y, cols, vals, p_len), inner=10),
        cuda_ms(lambda: attractive.attractive_forces_ell(y, cols, vals, p_len)),
        flops=a_flops, nbytes=a_bytes,
        device_ms=kernel_ms(lambda: ops.attractive_ell(y, cols, vals, p_len), "attractive"),
        nnz=nnz, full_w_ms=full_ms, full_w_device_ms=full_dev)

    # fft_spread / fft_gather on the same N points: 48 boxes (97 x 97
    # nodes, the main path's) for the rows, 128 boxes (257 x 257) checked
    # and timed too
    spread_extra = {}
    for n_boxes in (48, fft_repulsion.MAX_N_BOXES):
        base, wx, wy, _ = fft_repulsion.interp_coords(y, n_boxes)
        charges = fft_repulsion.point_charges(y)
        nodes = fft_repulsion.lattice_nodes(n_boxes)
        g_k = ops.fft_spread(base, wx, wy, charges, nodes)
        g_p = fft_repulsion.spread_to_grid(base, wx, wy, charges, nodes)
        check_spread(f"{n_boxes} boxes", g_k, g_p)
        # fixed-order sums: a second call gives the same bits
        if not torch.equal(ops.fft_spread(base, wx, wy, charges, nodes), g_k):
            fail(f"fft_spread kernel is not bit-identical from call to call at {n_boxes} boxes")
        pot = torch.randn((nodes, nodes, 4), generator=gen).to(dev)
        ph_k = ops.fft_gather(pot, base, wx, wy)
        ph_p = fft_repulsion.gather_from_grid(pot, base, wx, wy)
        check_gather(f"{n_boxes} boxes", ph_k, ph_p)
        # one order a point: a second call gives the same bits
        if not torch.equal(ops.fft_gather(pot, base, wx, wy), ph_k):
            fail(f"fft_gather kernel is not bit-identical from call to call at {n_boxes} boxes")
        log(f"fft interp {n_boxes} boxes: spread plan {tuple(ops.spread_plan(n, nodes))}; "
            "spread and gather bit-identical on a second call")
        # boxes that overhang the lattice (the gather's checked path): the
        # real weights, every 7th point's box moved one node past an edge
        ob = base.clone()
        ob[::7, 0] = -1
        ob[3::7, 1] = nodes - 2
        check_gather(f"{n_boxes} boxes, {int((ob != base).any(1).sum())} boxes overhanging",
                     ops.fft_gather(pot, ob, wx, wy),
                     fft_repulsion.gather_from_grid(pot, ob, wx, wy))

        # planted lattice-node points: one-hot weights, integer charges;
        # every partial sum is an exact integer, so both must be exact.
        # Boxes from -1 to n_boxes overhang both edges: taps off the
        # lattice are skipped by kernel and plain version alike
        pb = torch.randint(-1, n_boxes + 1, (n, 2), generator=gen, dtype=torch.int32) * 2
        taps = torch.randint(0, 3, (n, 2), generator=gen)
        pwx = torch.nn.functional.one_hot(taps[:, 0], 3).float()
        pwy = torch.nn.functional.one_hot(taps[:, 1], 3).float()
        pch = torch.randint(1, 5, (n, 3), generator=gen).float()
        ppot = torch.randint(-9, 9, (nodes, nodes, 4), generator=gen).float()
        pb, pwx, pwy, pch, ppot = (t.to(dev) for t in (pb, pwx, pwy, pch, ppot))
        if not torch.equal(ops.fft_spread(pb, pwx, pwy, pch, nodes),
                           fft_repulsion.spread_to_grid(pb, pwx, pwy, pch, nodes)):
            fail(f"fft_spread kernel is not exact on planted nodes at {n_boxes} boxes")
        if not torch.equal(ops.fft_gather(ppot, pb, pwx, pwy),
                           fft_repulsion.gather_from_grid(ppot, pb, pwx, pwy)):
            fail(f"fft_gather kernel is not exact on planted nodes at {n_boxes} boxes")
        log(f"fft interp {n_boxes} boxes: planted-node spread and gather exact "
            "(boxes overhanging the lattice included)")

        if n_boxes == 48:
            row_48 = (base, wx, wy, charges, nodes, g_k, g_p, pot, ph_k, ph_p)
        else:
            spread_extra.update(
                ms_128=cuda_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes), inner=20),
                device_ms_128=kernel_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes),
                                        "spread"))

    # every lattice size, N = 5 000, at the same tolerance; the gather also
    # at N = 1, 31 and 33 (a chunk's ragged tail)
    for n_boxes in range(1, fft_repulsion.MAX_N_BOXES + 1):
        ys = y[:5000]
        base, wx, wy, _ = fft_repulsion.interp_coords(ys, n_boxes)
        charges = fft_repulsion.point_charges(ys)
        nodes = fft_repulsion.lattice_nodes(n_boxes)
        check_spread(f"{n_boxes} boxes, N = 5 000", ops.fft_spread(base, wx, wy, charges, nodes),
                     fft_repulsion.spread_to_grid(base, wx, wy, charges, nodes), quiet=True)
        pot = torch.randn((nodes, nodes, 4), generator=gen).to(dev)
        for m in (5000, 1, 31, 33):
            b, xw, yw = base[:m].contiguous(), wx[:m].contiguous(), wy[:m].contiguous()
            check_gather(f"{n_boxes} boxes, N = {m}", ops.fft_gather(pot, b, xw, yw),
                         fft_repulsion.gather_from_grid(pot, b, xw, yw), quiet=True)
    log("fft_spread and fft_gather: n_boxes 1-128 at N = 5 000 (the gather also at "
        "N = 1, 31, 33) within the tolerance")

    # a compressed lattice: one point 1e4 away squeezes the other N - 1
    # into the first band (and the first columns), the worst balance of
    # the work between the kernel's blocks
    y_far = y.clone()
    y_far[0] = 1e4
    base, wx, wy, _ = fft_repulsion.interp_coords(y_far, 48)
    charges = fft_repulsion.point_charges(y_far)
    nodes = fft_repulsion.lattice_nodes(48)
    first_band = int((base[:, 0] < ops.spread_plan(n, nodes).rows_per_band).sum())
    check_spread(f"compressed lattice ({first_band} of {n} points meet the first band)",
                 ops.fft_spread(base, wx, wy, charges, nodes),
                 fft_repulsion.spread_to_grid(base, wx, wy, charges, nodes))
    spread_extra.update(
        compressed_ms=cuda_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes), inner=20),
        compressed_device_ms=kernel_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes),
                                       "spread"))

    base, wx, wy, charges, nodes, g_k, g_p, pot, ph_k, ph_p = row_48
    row("fft_spread", float((g_k - g_p).abs().max()),
        cuda_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes), inner=20),
        cuda_ms(lambda: fft_repulsion.spread_to_grid(base, wx, wy, charges, nodes)),
        # 9 tap weights + 27 products + 27 adds a point; base, weights and
        # charges read once, the grid written once
        flops=63.0 * n, nbytes=44.0 * n + 4.0 * nodes * nodes * 3,
        device_ms=kernel_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes), "spread"),
        **spread_extra)
    row("fft_gather", float((ph_k - ph_p).abs().max()),
        cuda_ms(lambda: ops.fft_gather(pot, base, wx, wy), inner=20),
        cuda_ms(lambda: fft_repulsion.gather_from_grid(pot, base, wx, wy)),
        # 9 tap weights + 36 products + 36 adds a point; base and weights
        # read, phi written, the potential read once
        flops=81.0 * n, nbytes=32.0 * n + 16.0 * n + 4.0 * nodes * nodes * 4,
        device_ms=kernel_ms(lambda: ops.fft_gather(pot, base, wx, wy), "gather"))
    return rows


def phase_gradient(x: torch.Tensor) -> None:
    from repro_torch.api import TSNE
    from repro_torch.core.fft_repulsion import fft_repulsion
    from repro_torch.core.tsne import TsneConfig, bh_gradient, preprocess

    n = 5000
    cfg = TsneConfig(perplexity=30.0, knn_block_q=KNN_BLOCK_Q, knn_block_db=KNN_BLOCK_DB)
    graph, _ = preprocess(x[:n].contiguous(), cfg)
    rng = np.random.default_rng(0)
    y = rng.normal(size=(n, 2)).astype(np.float32) * 5.0

    def grad_on(dev):
        res = bh_gradient(torch.as_tensor(y, device=dev), graph.p_cols.to(dev),
                          graph.p_vals.to(dev), None, 0.5, 12.0, 16,
                          graph.p_logp.to(dev), p_len=graph.p_len.to(dev))
        return res.grad.cpu(), float(res.kl)

    g_gpu, kl_gpu = grad_on(x.device)
    g_cpu, kl_cpu = grad_on("cpu")
    rel = float(torch.linalg.norm(g_gpu - g_cpu) / torch.linalg.norm(g_cpu))
    # same tree on both devices (bit-identical codes, stable sort); only
    # summation order differs, which can flip a rare opening decision
    log(f"gradient N={n}: |g_gpu - g_cpu| / |g_cpu| = {rel:.3e}, "
        f"KL gpu {kl_gpu:.6f} cpu {kl_cpu:.6f}")
    if not rel < 1e-3 or not abs(kl_gpu - kl_cpu) <= 1e-4 * abs(kl_cpu):
        fail("bh_gradient on the card disagrees with the CPU path")

    def fft_on(dev):
        f, z = fft_repulsion(torch.as_tensor(y, device=dev), n_boxes=48)
        return f.cpu(), float(z)

    f_gpu, z_gpu = fft_on(x.device)
    f_cpu, z_cpu = fft_on("cpu")
    rel = float(torch.linalg.norm(f_gpu - f_cpu) / torch.linalg.norm(f_cpu))
    z_rel = abs(z_gpu - z_cpu) / abs(z_cpu)
    # cuFFT vs pocketfft and the spread's sum order: forces to 1e-4
    # relative, z to 1e-5
    log(f"fft_repulsion N={n}, 48 boxes: |f_gpu - f_cpu| / |f_cpu| = {rel:.3e}, "
        f"z gpu {z_gpu:.6f} cpu {z_cpu:.6f} (rel {z_rel:.3e})")
    if not rel <= 1e-4 or not z_rel <= 1e-5:
        fail("fft_repulsion on the card disagrees with the CPU path")

    xs = x[:500].cpu().numpy()
    y0 = 1e-4 * rng.normal(size=(500, 2)).astype(np.float32)
    def small_fit_kl(method, dev):
        est = TSNE(method=method, perplexity=15.0, n_iter=100, kl_every=50,
                   random_state=0, device=dev)
        return est.fit(xs, y0=y0).kl_divergence_

    for method in ("barnes_hut", "fft"):
        a, b = (small_fit_kl(method, dev) for dev in (x.device, "cpu"))
        log(f"small {method} fit N=500, 100 iterations: KL card {a} cpu {b}")
        # trajectories drift apart through float order only; 2% on the final KL
        if not (np.isfinite(a) and abs(a - b) <= 0.02 * abs(b)):
            fail(f"small {method} fit on the card disagrees with the CPU fit")


# PR 17's untraced fits of the same configuration (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md section 5), printed beside the traced ones
PR17_FITS = {
    "barnes_hut": dict(knn=0.389, symmetrize=3.558, gradient_descent=10.54, kl=3.596582),
    "fft": dict(knn=0.390, symmetrize=4.173, gradient_descent=2.177, kl=3.762970),
}
FIT_PHASES = ("knn", "bsp", "symmetrize", "gradient_descent")


def phase_fit(x_np: np.ndarray, method: str, n_iter: int, exag_iters: int,
              kl_every: int, neighbor_method: str = "exact",
              neighbor_options: dict | None = None, label: str | None = None,
              trace: bool = False):
    """One fit through the estimator, every launch count reset before it
    and read after it; ``label`` names it in the log (default: ``method``).
    ``trace`` fits with ``trace=`` a Chrome-trace path under build/ and
    checks the spans (check_trace).  Returns (estimator, launches)."""
    from repro_torch.api import TSNE
    from repro_torch.kernels import ops

    stats = []
    name = label or method
    trace_path = BUILD / f"fit_trace_{name}.json" if trace else None
    if trace_path is not None:
        BUILD.mkdir(exist_ok=True)
    est = TSNE(method=method, neighbor_method=neighbor_method,
               neighbor_options=neighbor_options, perplexity=30,
               random_state=0, n_iter=n_iter, kl_every=kl_every, verbose=1,
               callbacks=[stats.append],
               backend_options=dict(knn_block_q=KNN_BLOCK_Q, knn_block_db=KNN_BLOCK_DB,
                                    exaggeration_iters=exag_iters,
                                    momentum_switch_iter=exag_iters),
               trace=None if trace_path is None else str(trace_path))
    # every attractive launch of the fit must carry the rows' real lengths
    with_len = []
    launch_attractive = ops.attractive_ell_cuda

    def attractive_spy(y, cols, vals, row_len=None, row0=0):
        with_len.append(row_len is not None)
        return launch_attractive(y, cols, vals, row_len, row0)

    ops.attractive_ell_cuda = attractive_spy
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        est.fit(x_np)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ops.attractive_ell_cuda = launch_attractive
    launches = dict(ops.LAUNCHES)
    log(f"{name} fit: {sum(with_len)} of {len(with_len)} attractive_ell launches "
        "with the rows' real lengths (p_len)")
    if not all(with_len):
        fail(f"the {name} fit launched attractive_ell without p_len")
    t = est.timings_
    log(f"{name} fit phases (s){', traced' if trace else ''}: " + json.dumps(
        {k: t[k] for k in FIT_PHASES}))
    log(f"{name} fit: wall {wall:.2f} s, {t['gradient_descent'] / est.n_iter_:.6f} s "
        f"per descent step over {est.n_iter_} steps")
    log(f"{name} fit KL checkpoints: " + json.dumps(
        [[int(i), float(v)] for i, v in est.kl_history_]))
    log(f"{name} fit max_traversal: {max(s.max_traversal for s in stats)}")
    log(f"{name} fit launches: {json.dumps(launches)}")
    emb = est.embedding_
    if emb.shape != (x_np.shape[0], 2) or not np.isfinite(emb).all():
        fail(f"{name}: embedding not finite or of wrong shape {emb.shape}")
    if not np.isfinite(est.kl_divergence_):
        fail(f"{name}: final KL is not finite")
    if trace_path is not None:
        check_trace(name, est, trace_path, exag_iters)
    return est, launches


def check_trace(name: str, est, path: Path, exag_iters: int) -> None:
    """A traced fit's spans: fit, knn, bsp, symmetrize and gradient_descent
    (the four phases children of fit), early_exaggeration, main_phase
    (when the fit ran past the exaggeration) and checkpoint; timings_ the
    spans' durations; the Chrome trace at ``path`` loadable with those
    events; fit.iterations = n_iter_.  Prints the timings beside PR 17's
    untraced fit of the same configuration."""
    tr = est.tracer_
    want = {"fit", *FIT_PHASES, "early_exaggeration", "checkpoint"}
    if est.n_iter_ > exag_iters:
        want.add("main_phase")
    missing = want - {s.name for s in tr.spans}
    if missing:
        fail(f"the traced {name} fit has no span {sorted(missing)}")
    fit = tr.last("fit")
    if any(tr.last(p).parent != fit.index for p in FIT_PHASES):
        fail(f"the traced {name} fit's phase spans are not children of fit")
    d = tr.durations()
    if any(est.timings_[p] != d[p] for p in FIT_PHASES):
        fail(f"the traced {name} fit's timings_ are not its spans' durations")
    with open(path) as f:
        events = {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    if not want <= events:
        fail(f"the {name} fit's Chrome trace lacks {sorted(want - events)}")
    snap = est.metrics_.snapshot()
    if snap["fit.iterations"] != est.n_iter_:
        fail(f"the traced {name} fit counted {snap['fit.iterations']} iterations, ran "
             f"{est.n_iter_}")
    log(f"{name} fit traced: {len(tr.spans)} spans ({len(tr.find('checkpoint'))} "
        f"checkpoints) written to {path.name}; timings_ = span durations; "
        f"fit.iterations {snap['fit.iterations']}; fit span {d['fit']:.3f} s")
    ref = PR17_FITS.get(name)
    if ref is not None:
        log(f"{name} fit traced against PR 17's untraced (s): " + json.dumps(
            {p: [est.timings_[p], ref[p]] for p in ("knn", "symmetrize", "gradient_descent")})
            + f"; KL {est.kl_divergence_:.6f} against {ref['kl']}")


def check_launches(method: str, launches: dict, needed: tuple, per_step: tuple,
                   steps: int) -> None:
    """Each kernel of the path launched; the per-step kernels once a step."""
    missing = [k for k in needed if launches[k] <= 0]
    if missing:
        fail(f"the {method} fit never launched: {missing}")
    counts = {k: launches[k] for k in per_step}
    if any(v != steps for v in counts.values()):
        fail(f"the {method} fit ran {steps} steps but launched {counts}")


def phase_traverse(est) -> dict:
    """bh_traverse at the Barnes-Hut fit's embedding: checked bit for bit
    against the plain walk (check_traverse), then timed at the fit's
    settings (theta 0.5, depth 16, compressed tree): the kernels line's
    row, with the device times of its two kernels (pack, walk) apart and
    summed.  How far a warp's walks diverge: the union of its 32 walks
    (repulsive.warp_walk, a warp-shared schedule, which must give the
    kernel's bits) against its longest walk (the plain walk's steps).  Its
    bound counts the walks of this embedding: every visit's 15 fp32
    operations (the three an accepted node adds besides, and its
    reciprocal, not counted) at the fp32 rate, and each node's 40 bytes
    (start, end, skip, count, sum_y, side), the points and the outputs
    moved once; the packed records are the kernel's own scratch, not
    counted."""
    from repro_torch.core.repulsive import bh_repulsion_sorted, pack_nodes, warp_walk
    from repro_torch.kernels import ops
    y = torch.as_tensor(est.embedding_).cuda()
    check_traverse("fitted embedding", y)
    y_s, tree, summ, _ = walk_inputs(y)
    got = ops.bh_traverse(y_s, tree, summ, 0.5)
    n, visits, n_nodes = y.shape[0], int(got.steps.sum()), int(tree.n_nodes)
    sched, union = warp_walk(y_s, pack_nodes(tree, summ), summ.sum_y, tree.n_nodes, 0.5)
    if not all(torch.equal(a, b) for a, b in zip(sched, got)):
        fail("repulsive.warp_walk does not give bh_traverse's bits at the fitted embedding")
    steps = torch.zeros(union.shape[0] * 32, dtype=torch.int64, device=y.device)
    steps[:n] = got.steps
    longest = steps.view(-1, 32).amax(dim=1)
    walks = dict(warps=union.shape[0], union_mean=float(union.double().mean()),
                 longest_lane_mean=float(longest.double().mean()),
                 union_over_longest=float(union.sum()) / float(longest.sum()),
                 union_max=int(union.max()), longest_lane_max=int(longest.max()))
    log("bh_traverse warps at the fitted embedding: " + json.dumps(walks))
    pack_ms = kernel_ms(lambda: ops.bh_traverse(y_s, tree, summ, 0.5), "traverse_pack")
    walk_ms = kernel_ms(lambda: ops.bh_traverse(y_s, tree, summ, 0.5), "traverse_walk")
    return kernel_row(
        "bh_traverse", 0.0,
        cuda_ms(lambda: ops.bh_traverse(y_s, tree, summ, 0.5), inner=10),
        cuda_ms(lambda: bh_repulsion_sorted(y_s, tree, summ, 0.5), reps=3, inner=1),
        flops=15.0 * visits, nbytes=40.0 * n_nodes + 8.0 + (8.0 + 8.0 + 4.0 + 8.0) * n,
        device_ms=None if pack_ms is None or walk_ms is None else pack_ms + walk_ms,
        pack_device_ms=pack_ms, walk_device_ms=walk_ms,
        n_nodes=n_nodes, visits=visits, max_steps=int(got.steps.max()),
        mean_steps=visits / n, **walks)


def check_reproducible(est) -> None:
    """A second FFT descent from the fit's graph and initial embedding
    (core.tsne.descend, the loop run_tsne ran, with the fit's config and
    backend) must repeat the fit bit for bit: embedding and final KL."""
    from repro_torch.api import make_backend
    from repro_torch.core.tsne import descend, init_state
    config = est._build_config()
    n = est.embedding_.shape[0]
    t0 = time.perf_counter()
    state, kl, _, n_run = descend(init_state(n, config, "cuda"), est.neighbor_graph_, config,
                                  make_backend(config.method, config, n),
                                  config.resolve_lr(n), kl_every=est.kl_every)
    y = state.y.cpu().numpy()
    same = bool(np.array_equal(y, est.embedding_)) and kl == est.kl_divergence_
    log(f"{config.method} second descent, {n_run} steps in {time.perf_counter() - t0:.2f} s: "
        f"KL {kl} (fit {est.kl_divergence_}), max |d embedding| "
        f"{float(np.abs(y - est.embedding_).max()):.3e}, bit-identical {same}")
    if not same or n_run != est.n_iter_:
        fail(f"a second {config.method} descent from the same graph and initial embedding "
             "does not repeat the fit bit for bit")


def kernel_events(fn) -> dict[str, list[float]]:
    """Kernel name -> the durations (us) of its launches in one call of
    ``fn``, from a torch.profiler trace (the kernel events themselves: CPU
    ops' device time would count each kernel twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            events.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return events


def device_busy(fn) -> tuple[float, dict]:
    """Seconds of CUDA kernel time in one call of ``fn`` (the summed
    durations of its kernel events), and the same by kernel name (us)."""
    by_kernel = {k: sum(v) for k, v in kernel_events(fn).items()}
    return sum(by_kernel.values()) * 1e-6, by_kernel


def add_busy_share(out: dict, step, inner: int) -> dict:
    """out gains step_s (CUDA-event time of ``inner`` back-to-back calls of
    ``step`` with no sync between them, as the fit runs its steps, over
    ``inner``; median of 3), device_busy_s (kernel time of one profiled
    ``step``) and device_idle_share = 1 - busy / step_s.  Returns the
    profiled step's kernel time by kernel name (us)."""
    out["step_s"] = cuda_ms(step, reps=3, inner=inner) * 1e-3
    busy_s, by_kernel = device_busy(step)
    if busy_s > 0:
        if busy_s > out["step_s"]:
            fail(f"device busy {busy_s:.6f} s exceeds the step's {out['step_s']:.6f} s")
        out["device_busy_s"] = busy_s
        out["device_idle_share"] = 1.0 - busy_s / out["step_s"]
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        log("step device time by kernel (ms): " + json.dumps(
            {k[:70]: v * 1e-3 for k, v in top}))
    else:
        log("step device time: not measured (the profiler recorded no kernel)")
    return by_kernel


def check_same_step(what: str, res, ref, f_rep) -> None:
    """The breakdown's stage-by-stage GradResult ``res`` against the
    backend's own ``ref``: a breakdown that drifted from the step it times
    fails here.  The two calls run the same kernels on the same inputs;
    they can differ only where an operation sums in a run-dependent order.
    At a fitted embedding the gradient is a small difference of the
    attractive and repulsive terms, so its difference is measured against
    the repulsive term 4 F_rep / Z.  The FFT force y * phi0 - phi1 is
    itself a cancelling difference, which turns ~1e-7 of reordering noise
    in the lattice into ~5e-5 of the term; a drifted step differs by the
    order of the term.  So: below 1e-3, and Z to 1e-5."""
    term = float(torch.linalg.norm(4.0 * f_rep / res.z))
    rel = float(torch.linalg.norm(res.grad - ref.grad)) / term
    z_rel = abs(float(res.z) - float(ref.z)) / float(ref.z)
    log(f"{what} breakdown vs backend.gradient: |d grad| / |4 F_rep / Z| = {rel:.3e}, "
        f"Z relative {z_rel:.3e}, bit-identical {torch.equal(res.grad, ref.grad)}")
    if not (rel <= 1e-3 and z_rel <= 1e-5):
        fail(f"{what} breakdown's step differs from the backend's")


class Laps:
    """Seconds of consecutive stages, the device synchronised at each mark;
    a stage named again adds to its seconds."""

    def __init__(self):
        self.t: dict[str, float] = {}
        torch.cuda.synchronize()
        self.mark = time.perf_counter()

    def __call__(self, name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.t[name] = self.t.get(name, 0.0) + now - self.mark
        self.mark = now


def median_laps(runs: list[dict]) -> dict:
    out = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    out["total"] = sum(out.values())
    return out


def phase_breakdown(est) -> dict:
    """Seconds of each stage of one Barnes-Hut step at the fitted embedding
    (device synchronised around each stage; median of 3 steps)."""
    from repro_torch.api import make_backend
    from repro_torch.core import attractive, morton, quadtree
    from repro_torch.core.summarize import summarize
    from repro_torch.core.tsne import (
        TsneConfig, TsneState, combine_forces, gd_update, tsne_step,
    )
    from repro_torch.kernels import ops

    g = est.neighbor_graph_
    y = torch.as_tensor(est.embedding_).cuda()
    state = TsneState(y=y, velocity=torch.zeros_like(y), gains=torch.ones_like(y),
                      iteration=0)
    backend = make_backend("barnes_hut", TsneConfig(), y.shape[0])   # the fit's
    runs, max_traversal = [], 0
    for _ in range(3):
        lap = Laps()
        cent, r_span = morton.span_radius(y)
        codes = ops.morton_encode(y, cent, r_span, depth=backend.depth)
        lap("morton_encode")
        codes_s, y_s, perm = quadtree.sort_points_by_code(y, codes)
        lap("sort")
        tree = quadtree.build_quadtree(codes_s, depth=backend.depth,
                                       compress=backend.compress_tree)
        lap("build_quadtree")
        summ = summarize(tree, y_s, r_span)
        lap("summarize")
        rep = ops.bh_traverse(y_s, tree, summ, backend.theta)
        lap("traversal")
        f_rep = torch.empty_like(y)
        f_rep[perm] = rep.force
        f_attr, kl_attr = attractive.ell_forces(backend.attractive_impl)(
            y, g.p_cols, g.p_vals, g.p_len)
        lap("attractive")
        res = combine_forces(f_attr, kl_attr, f_rep, rep.z_per_point.sum(), 1.0,
                             g.p_logp, torch.max(rep.steps))
        gd_update(state, res.grad, est.learning_rate_, 0.8, 0.01)
        lap("combine_and_update")
        max_traversal = int(res.max_traversal)
        runs.append(lap.t)
    check_same_step("bh", res, backend.gradient(y, g, 1.0), f_rep)
    out = median_laps(runs)
    out["max_traversal"] = max_traversal
    out["traversal_share"] = out["traversal"] / out["total"]
    # the card's busy time over one whole descent step (gradient + update)
    add_busy_share(out, lambda: tsne_step(state, g, 1.0, 0.8, backend=backend,
                                          lr=est.learning_rate_, min_gain=0.01), inner=3)
    log("bh step breakdown at the fitted embedding (s): " + json.dumps(out))
    return out


def phase_fft_breakdown(est) -> dict:
    """Seconds of each stage of one FFT step at the fitted embedding
    (device synchronised around each stage; median of 10 steps)."""
    from repro_torch.api import make_backend
    from repro_torch.core import attractive
    from repro_torch.core import fft_repulsion as fr
    from repro_torch.core.tsne import (
        TsneConfig, TsneState, combine_forces, gd_update, tsne_step,
    )
    from repro_torch.kernels import ops

    g = est.neighbor_graph_
    y = torch.as_tensor(est.embedding_).cuda()
    state = TsneState(y=y, velocity=torch.zeros_like(y), gains=torch.ones_like(y),
                      iteration=0)
    backend = make_backend("fft", TsneConfig(), y.shape[0])   # the fit's: 48 boxes
    runs = []
    # fft_repulsion's stages, each through the function fft_repulsion calls
    for _ in range(10):
        lap = Laps()
        base, wx, wy, h = fr.interp_coords(y, backend.n_boxes)
        charges = fr.point_charges(y)
        lap("coords")
        grid = ops.fft_spread(base, wx, wy, charges, fr.lattice_nodes(backend.n_boxes))
        lap("spread")
        pot = fr.convolve(grid, h)
        lap("convolution")
        phi = ops.fft_gather(pot, base, wx, wy)
        lap("gather")
        f_attr, kl_attr = attractive.ell_forces(backend.attractive_impl)(
            y, g.p_cols, g.p_vals, g.p_len)
        lap("attractive")
        f_rep, z = fr.forces_from_potentials(y, phi)
        res = combine_forces(f_attr, kl_attr, f_rep, z, 1.0, g.p_logp)
        gd_update(state, res.grad, est.learning_rate_, 0.8, 0.01)
        lap("combine_and_update")
        runs.append(lap.t)
    check_same_step("fft", res, backend.gradient(y, g, 1.0), f_rep)
    out = median_laps(runs)
    nodes = fr.lattice_nodes(backend.n_boxes)
    out["spread_plan"] = list(ops.spread_plan(y.shape[0], nodes))
    out["spread_device_ms"] = kernel_ms(lambda: ops.fft_spread(base, wx, wy, charges, nodes),
                                        "spread")
    out["gather_device_ms"] = kernel_ms(lambda: ops.fft_gather(pot, base, wx, wy), "gather")
    # the card's busy time over one whole descent step (gradient + update)
    by_kernel = add_busy_share(out, lambda: tsne_step(state, g, 1.0, 0.8, backend=backend,
                                                      lr=est.learning_rate_, min_gain=0.01),
                               inner=20)
    # the spread and gather kernels' device time in the profiled step,
    # beside kernel_ms's
    for name in ("spread", "gather"):
        us = [v for k, v in by_kernel.items() if f"{name}_kernel" in k]
        out[f"{name}_step_device_ms"] = sum(us) * 1e-3 if us else None
    log("fft step breakdown at the fitted embedding (s): " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# The approximate neighbours and the out-of-sample transform
# ---------------------------------------------------------------------------

# The approximate fit's forest.  The defaults (8 trees, leaves of >= 64
# points: 118 at 60 000 rows) route the held-out rows to 59% of their 90
# exact neighbours (the port and the JAX package alike; PERF.md), below
# the reference's 0.9 query bar; 32 trees of >= 128 points (235) reach
# 0.99.
APPROX_FOREST = {"n_trees": 32, "leaf_size": 128}
RECALL_ROWS = 4096          # sampled rows whose exact neighbours are computed
TRAIN_ROWS = 60_000         # MNIST's own train split; the other 10 000 are new points


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def synced_seconds(fn):
    """(fn(), its seconds, every visible card synchronised at both ends)."""
    sync_all()
    t0 = time.perf_counter()
    out = fn()
    sync_all()
    return out, time.perf_counter() - t0


def check_graph(what: str, x: torch.Tensor, idx: torch.Tensor, d2: torch.Tensor,
                rows: torch.Tensor, ref_idx: torch.Tensor) -> float:
    """Every row of the graph valid (in range, no self, no duplicate); on
    the sampled ``rows`` the reported d2 the true squared distance (fp64),
    within pairwise_tol of the norms.  Returns the recall on ``rows``
    against their exact neighbours ``ref_idx``."""
    from repro_torch.neighbors import recall_at_k
    n, k = idx.shape
    i64 = idx.long()
    if not bool(((i64 >= 0) & (i64 < n)).all()):
        fail(f"{what}: a neighbour index out of range")
    if bool((i64 == torch.arange(n, device=x.device)[:, None]).any()):
        fail(f"{what}: a row lists itself")
    srt = torch.sort(i64, dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        fail(f"{what}: a row lists a neighbour twice")
    xs, nb = x[rows].double(), x[i64[rows]].double()
    true = torch.sum((xs[:, None, :] - nb) ** 2, -1)
    sqn = torch.sum(x.double() ** 2, 1)
    tol = pairwise_tol(true, sqn[rows][:, None], sqn[i64[rows]])
    share = float(((d2[rows].double() - true).abs() / tol).max())
    recall = recall_at_k(ref_idx.cpu().numpy(), idx[rows].cpu().numpy())
    log(f"{what}: {n} rows x {k} valid (in range, no self, no duplicate); d2 on "
        f"{rows.shape[0]} sampled rows {share:.3f} of the tolerance from the true distance "
        f"at most; recall on them {recall:.6f}")
    if share > 1.0:
        fail(f"{what}: reported distances are not the true ones")
    return recall


def mouse_sample(k: int):
    """All of mouse_1p3m on the card, RECALL_ROWS sampled rows and their
    exact K nearest neighbours (pairwise kernel tiles, self masked)."""
    from repro_torch.data.datasets import make_dataset
    from repro_torch.kernels import ops
    x = torch.as_tensor(make_dataset("mouse_1p3m")[0]).cuda()
    rows = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(17))
    rows = rows[:RECALL_ROWS].cuda()
    return x, rows, knn_rows(x, rows, k, ops.pairwise_sq_dists)[0]


def phase_approx_knn(k: int) -> dict:
    """rp_forest (default options) and nn_descent on all of mouse_1p3m
    (1 291 337 x 20) on the card: seconds, validity, recall on sampled
    rows.  Then at N = 20 000 the card's rp_forest graph against the CPU's
    (the same draws).  Returns (the summary, (the points on the card, the
    sampled rows, their exact neighbours)) for phase 13."""
    from repro_torch.core.knn import knn
    from repro_torch.neighbors import NNDescentNeighbors, RPForestNeighbors, recall_at_k

    x, rows, ref_idx = mouse_sample(k)
    n = x.shape[0]
    out = {}
    for backend in (RPForestNeighbors(), NNDescentNeighbors()):
        torch.cuda.reset_peak_memory_stats()
        (idx, d2), secs = synced_seconds(lambda: backend.neighbors(x, k))
        recall = check_graph(f"{backend.name} on mouse_1p3m [{n}, {x.shape[1]}], K = {k}",
                             x, idx, d2, rows, ref_idx)
        out[backend.name] = dict(seconds=secs, recall=recall,
                                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"{backend.name} on mouse_1p3m: {secs:.3f} s, recall {recall:.6f} on "
            f"{RECALL_ROWS} rows, peak {out[backend.name]['peak_gib']:.2f} GiB ({backend})")
        del idx, d2

    # the card's graph against the CPU's at N = 20 000: the same draws
    # (a CPU generator), so the two graphs differ only where float order
    # swaps near-tied neighbours
    m = 20_000
    xs = x[:m].contiguous()
    card, _ = RPForestNeighbors().neighbors(xs, k)
    cpu, _ = RPForestNeighbors().neighbors(xs.cpu(), k)
    exact, _ = knn(xs, k, KNN_BLOCK_Q, KNN_BLOCK_DB)
    exact = exact.cpu().numpy()
    same = recall_at_k(cpu.numpy(), card.cpu().numpy())
    r_card, r_cpu = recall_at_k(exact, card.cpu().numpy()), recall_at_k(exact, cpu.numpy())
    log(f"rp_forest at N = {m}: card's graph against the CPU's {same:.6f} (>= 0.99); "
        f"recall against exact: card {r_card:.6f}, cpu {r_cpu:.6f} (within 0.01)")
    if same < 0.99 or abs(r_card - r_cpu) > 0.01:
        fail("rp_forest on the card disagrees with the CPU's graph of the same draws")
    out["n20000"] = dict(card_vs_cpu=same, recall_card=r_card, recall_cpu=r_cpu)
    return out, (x, rows, ref_idx)


def phase_approx_fit(x_np: np.ndarray, n_iter: int, exag_iters: int, kl_every: int):
    """The Barnes-Hut fit on an rp_forest graph of MNIST's train split, and
    the same fit on the exact graph: KLs within 0.15 (the reference's bar,
    tests/test_neighbors.py::test_bh_kl_on_approximate_graph).  The
    approximate fit must launch no pairwise tile, bsp, and morton,
    attractive and bh_traverse once a step.  Returns (approximate fit,
    exact fit)."""
    train = x_np[:TRAIN_ROWS]
    steps = (n_iter, exag_iters, kl_every)
    est_rp, launches = phase_fit(train, "barnes_hut", *steps, neighbor_method="rp_forest",
                                 neighbor_options=APPROX_FOREST, label="rp_forest bh")
    if launches["pairwise_sq_dists"] != 0:
        fail(f"the rp_forest fit launched {launches['pairwise_sq_dists']} pairwise tiles")
    check_launches("rp_forest bh", launches, ("bsp_search",),
                   ("morton_encode", "attractive_ell", "bh_traverse"), est_rp.n_iter_)
    est_ex, _ = phase_fit(train, "barnes_hut", *steps, label="exact-graph bh (train split)")
    gap = abs(est_rp.kl_divergence_ - est_ex.kl_divergence_)
    log(f"approx fit: KL rp_forest {est_rp.kl_divergence_:.6f} (earlier runs: 3.479328), exact "
        f"graph {est_ex.kl_divergence_:.6f}, gap {gap:.6f} (< 0.15); knn "
        f"{est_rp.timings_['knn']:.3f} s "
        f"against {est_ex.timings_['knn']:.3f} s")
    if not gap < 0.15:
        fail("the rp_forest fit's KL is not within 0.15 of the exact-graph fit's")
    return est_rp, est_ex


def knn_labels(train_t: torch.Tensor, test_t: torch.Tensor, train_labels: np.ndarray,
               chunk: int = 1024) -> np.ndarray:
    """The 5-NN vote of each test row among the train rows (squared
    euclidean distance; ties of the vote to the smaller label, as
    np.bincount(...).argmax())."""
    idx = []
    for r0 in range(0, test_t.shape[0], chunk):
        d2 = torch.cdist(test_t[r0:r0 + chunk], train_t)
        idx.append(torch.topk(d2, 5, dim=1, largest=False).indices.cpu().numpy())
    votes = train_labels[np.concatenate(idx)]
    return np.array([np.bincount(v).argmax() for v in votes])


def query_rows(index, q: torch.Tensor, k: int, chunk: int = 128) -> np.ndarray:
    """index.query in chunks of ``chunk`` rows (a transform batch's)."""
    return np.concatenate([index.query(q[r0:r0 + chunk], k)[0].cpu().numpy()
                           for r0 in range(0, q.shape[0], chunk)])


class Replay:
    """A query index that answers with given (idx, d2), chunk after chunk,
    in the order transform_batch asks."""

    def __init__(self, idx: torch.Tensor, d2: torch.Tensor):
        self.idx, self.d2, self.at = idx, d2, 0

    def query(self, q: torch.Tensor, k: int):
        rows = slice(self.at, self.at + q.shape[0])
        self.at += q.shape[0]
        return self.idx[rows].to(q.device), self.d2[rows].to(q.device)


def phase_transform(est, x_np: np.ndarray, labels: np.ndarray) -> dict:
    """The held-out 10 000 rows through the rp_forest fit's query_index_
    and through an exact index over the train split: rows/s, the forest
    query's recall (>= 0.9), label accuracy against the input-space
    baseline, 256 rows on the card against the CPU, and save/load."""
    import tempfile

    from repro_torch.api import TSNE
    from repro_torch.embed.transform import TransformConfig, prepare_batch, transform_batch
    from repro_torch.kernels import ops
    from repro_torch.neighbors import (
        ExactNeighbors, RPForestNeighbors, build_query_index, recall_at_k,
    )

    cfg = TransformConfig()
    train_t = torch.as_tensor(x_np[:TRAIN_ROWS]).cuda()
    test_np = x_np[TRAIN_ROWS:]
    test_t = torch.as_tensor(test_np).cuda()
    y_ref = torch.as_tensor(est.embedding_).cuda()
    k, perp = est.query_k_, float(est.perplexity)
    out = {"batch_size": cfg.batch_size, "rows": test_np.shape[0], "k": k}

    forest, out["forest_build_s"] = synced_seconds(lambda: est.query_index_)
    exact_index = build_query_index(ExactNeighbors(), train_t)
    runs = {}
    for name, index in (("forest", forest), ("exact", exact_index)):
        transform_batch(test_t[:cfg.batch_size], index, y_ref, k=k, perplexity=perp,
                        config=cfg)                                 # warm-up batch
        ops.reset_launch_counts()
        (y, stats), secs = synced_seconds(lambda: transform_batch(
            test_t, index, y_ref, k=k, perplexity=perp, config=cfg))
        launches = dict(ops.LAUNCHES)
        runs[name] = y
        out[name] = dict(seconds=secs, rows_per_s=test_np.shape[0] / secs,
                         steps_mean=float(stats.n_steps.mean()),
                         launches={kk: v for kk, v in launches.items() if v})
        log(f"transform via the {name} index: {test_np.shape[0]} rows in batches of "
            f"{cfg.batch_size}: {secs:.3f} s, {out[name]['rows_per_s']:.1f} rows/s, "
            f"{out[name]['steps_mean']:.1f} steps a row on average; launches "
            f"{json.dumps(out[name]['launches'])}")
        if not np.isfinite(y).all():
            fail(f"the {name} transform is not finite")
    if out["exact"]["launches"].get("pairwise_sq_dists", 0) <= 0 or \
            out["exact"]["launches"].get("bsp_search", 0) <= 0 or \
            out["forest"]["launches"].get("bsp_search", 0) <= 0:
        fail("the transform did not launch pairwise_sq_dists (exact index) and bsp_search")

    exact_idx = query_rows(exact_index, test_t, k)
    out["forest_recall"] = recall_at_k(exact_idx, query_rows(forest, test_t, k))
    default = RPForestNeighbors(seed=0).build_index(train_t)
    out["default_forest_recall"] = recall_at_k(exact_idx, query_rows(default, test_t, k))
    log(f"forest query recall at k = {k} on {test_np.shape[0]} held-out rows: "
        f"{out['forest_recall']:.6f} (>= 0.9) with {APPROX_FOREST} ({tuple(forest.leaves.shape)}"
        f" leaves); the default forest ({tuple(default.leaves.shape)}): "
        f"{out['default_forest_recall']:.6f}")
    if out["forest_recall"] < 0.9:
        fail("the forest query's recall is below 0.9")

    train_labels, test_labels = labels[:TRAIN_ROWS], labels[TRAIN_ROWS:]
    base = float((knn_labels(train_t, test_t, train_labels) == test_labels).mean())
    for name, y in runs.items():
        acc = float((knn_labels(y_ref, torch.as_tensor(y).cuda(), train_labels)
                     == test_labels).mean())
        out[f"label_acc_{name}"] = acc
        log(f"5-NN label accuracy, {name} transform: embedding {acc:.4f}, input space "
            f"{base:.4f} (>= baseline - 0.05)")
        if acc < base - 0.05:
            fail(f"the {name} transform's points do not land in their own clusters")
    out["label_acc_input"] = base

    # 256 rows on the card against the CPU through the same exact index,
    # stage by stage.  (1) The query: the card's pairwise tile (3xTF32) is
    # not bit-identical to the CPU's fp32, so a row's neighbour set may
    # differ (<= 1% of rows) and the distances may differ within the
    # pairwise tolerance.  (2) prepare_batch from the same query answers
    # (the CPU's, replayed on the card): p within the bsp kernel's
    # tolerance on every row, y0 within 1e-4 of the fitted embedding's
    # span.  (3) The transformed points: median |dy| <= 1e-5 x span and
    # >= 98% of rows within 1e-3 x span.  A per-row bound on the output
    # does not hold: rows that stop at the step cap on a ridge between two
    # basins move far under last-bit differences (one moved 5.2 units on a
    # span of 190.8, and 0.034 under 1e-6 relative noise in p on the CPU
    # alone; PERF.md).
    m = 256
    cpu_index = build_query_index(ExactNeighbors(), train_t.cpu())
    q = test_t[:m]
    (i_card, d_card), (i_cpu, d_cpu) = exact_index.query(q, k), cpu_index.query(q.cpu(), k)
    o_card, o_cpu = torch.sort(i_card.cpu(), 1), torch.sort(i_cpu, 1)
    same_set = (o_card.values == o_cpu.values).all(1)
    sqn = torch.sum(train_t.cpu() ** 2, 1)
    d_c = torch.gather(d_card.cpu(), 1, o_card.indices)[same_set]
    d_p = torch.gather(d_cpu, 1, o_cpu.indices)[same_set]
    tol = pairwise_tol(d_p, torch.sum(q.cpu() ** 2, 1)[same_set][:, None],
                       sqn[o_cpu.values[same_set].long()])
    d_share = float(((d_c - d_p).abs() / tol).max())
    span = float(np.ptp(est.embedding_))
    p_card, _, y0_card = prepare_batch(q, Replay(i_cpu, d_cpu), y_ref, k, perp)
    p_cpu, _, y0_cpu = prepare_batch(q.cpu(), cpu_index, y_ref.cpu(), k, perp)
    p_err = float((p_card.cpu() - p_cpu).abs().max())
    y0_err = float((y0_card.cpu() - y0_cpu).abs().max())
    y_cpu, _ = transform_batch(q.cpu(), cpu_index, y_ref.cpu(), k=k, perplexity=perp, config=cfg)
    y_card, _ = transform_batch(q, exact_index, y_ref, k=k, perplexity=perp, config=cfg)
    dy = np.abs(y_card - y_cpu).max(1)
    out["card_vs_cpu"] = dict(
        other_sets=int((~same_set).sum()), d2_share=d_share, p_max_abs_err=p_err,
        y0_max_abs_err=y0_err, span=span, median_dy=float(np.median(dy)),
        max_dy=float(dy.max()), rows_over=int((dy > 1e-3 * span).sum()))
    log(f"transform card vs cpu, {m} rows, exact index: {int((~same_set).sum())} rows with "
        f"another neighbour set (<= 1%), distances {d_share:.3f} of the pairwise tolerance at "
        f"most; from the same query answers p max |d| {p_err:.3e} (rtol 1e-5, atol 1e-7), "
        f"y0 max |d| {y0_err:.3e} (<= 1e-4 x span {span:.3f}); transformed points median "
        f"|dy| {np.median(dy):.3e} (<= 1e-5 x span), max {dy.max():.3e}, "
        f"{int((dy > 1e-3 * span).sum())} rows over 1e-3 x span (<= 2%)")
    if (~same_set).float().mean() > 0.01 or d_share > 1.0 or \
            not torch.allclose(p_card.cpu(), p_cpu, rtol=1e-5, atol=1e-7) or \
            y0_err > 1e-4 * span or np.median(dy) > 1e-5 * span or \
            (dy > 1e-3 * span).mean() > 0.02:
        fail("the transform on the card disagrees with the CPU's")

    # save, then load: the loaded model serves the same transform (its
    # forest rebuilt from the same draws); the reference's round-trip bar
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "mnist_rp.npz"
        est.save(path)
        loaded = TSNE.load(path)
        again = loaded.transform(test_np[:m])
    first = est.transform(test_np[:m])
    err = float(np.abs(again - first).max())
    log(f"save/load: the loaded model's transform of {m} rows, max |dy| {err:.3e} "
        "(atol 1e-5)")
    if not np.allclose(again, first, atol=1e-5):
        fail("a saved and loaded model does not serve the same transform")
    log("transform summary: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# The embedding service
# ---------------------------------------------------------------------------

SERVICE_ROWS = 1024         # held-out rows submitted to each of the two models (cut from 2 048)
SERVICE_CPU_ROWS = 128      # requests replayed on a CPU service (cut from 256)


def service_bars(what: str, y: np.ndarray, y_ref: np.ndarray, span: float) -> dict:
    """Phase 11's distribution bars between two placements of the same
    rows: median |dy| <= 1e-5 x span, >= 98% of rows within 1e-3 x span
    (rows that stop at the step cap on a ridge between two basins move far
    under last-bit differences, so no per-row bound holds; PERF.md)."""
    dy = np.abs(y - y_ref).max(1)
    out = dict(median_dy=float(np.median(dy)), max_dy=float(dy.max()),
               rows_over=int((dy > 1e-3 * span).sum()), rows=int(dy.shape[0]), span=span)
    log(f"service {what}: {dy.shape[0]} rows, median |dy| {out['median_dy']:.3e} "
        f"(<= 1e-5 x span {span:.3f}), max {out['max_dy']:.3e}, {out['rows_over']} rows "
        "over 1e-3 x span (<= 2%)")
    if not (out["median_dy"] <= 1e-5 * span and (dy > 1e-3 * span).mean() <= 0.02):
        fail(f"the service's placements disagree ({what})")
    return out


def run_service(service, models: dict, rows: np.ndarray) -> tuple[list, float]:
    """Submit every row to each model in turn (request ids 0, 1, ... in that
    order) and drain with run(): (requests in id order, seconds)."""
    from repro_torch.embed import TransformRequest
    reqs = [TransformRequest(rid=len(models) * i + j, dataset=name, x=xi)
            for i, xi in enumerate(rows) for j, name in enumerate(models)]
    t0 = time.perf_counter()
    for r in reqs:
        service.submit(r)
    done = service.run()
    secs = time.perf_counter() - t0
    if sorted(r.rid for r in done) != list(range(len(reqs))):
        fail(f"the service completed {len(done)} of {len(reqs)} requests")
    return reqs, secs


def phase_service(est_forest, est_exact, x_np: np.ndarray) -> dict:
    """EmbeddingService(slots=64, max_k=96) on the card over phase 10's two
    fits; see the module docstring (phase 12)."""
    import tempfile

    from repro_torch import obs
    from repro_torch.api import TSNE
    from repro_torch.convert import forest_index_from_numpy
    from repro_torch.embed import EmbeddingService
    from repro_torch.embed.transform import RETRACE_PROBE
    from repro_torch.kernels import ops

    models = {"mnist_forest": est_forest, "mnist_exact": est_exact}
    rows = x_np[TRAIN_ROWS:TRAIN_ROWS + SERVICE_ROWS]
    for est in models.values():
        est.query_index_             # built before the run, not on a request's clock
    tracer = obs.Tracer()
    service = EmbeddingService(slots=64, max_k=96, tracer=tracer)
    for name, est in models.items():
        service.add_model(name, est)
    # pairwise launches by each model's admissions
    pairwise_by = dict.fromkeys(models, 0)
    admit = service._admit

    def counted_admit(slot, req):
        before = ops.LAUNCHES["pairwise_sq_dists"]
        admit(slot, req)
        pairwise_by[req.dataset] += ops.LAUNCHES["pairwise_sq_dists"] - before

    service._admit = counted_admit
    probe_before = RETRACE_PROBE.count
    ops.reset_launch_counts()
    reqs, secs = run_service(service, models, rows)
    launches = dict(ops.LAUNCHES)
    n_req = len(reqs)
    s = service.stats()
    spans = tracer.durations()
    index = est_exact.query_index_
    tiles = -(-TRAIN_ROWS // index.block_db) * -(-1 // index.block_q)
    out = dict(requests=n_req, seconds=secs, requests_per_s=n_req / secs,
               latency_s_p50=s["latency_s_p50"], latency_s_p95=s["latency_s_p95"],
               latency_s_p99=s["latency_s_p99"], latency_s_max=s["latency_s_max"],
               steps_mean=s["steps_mean"], steps_max=s["steps_max"], ticks=s["ticks"],
               admit_s=spans.get("service.admit", 0.0), tick_s=spans.get("service.tick", 0.0),
               launches={k: v for k, v in launches.items() if v},
               pairwise_by_model=pairwise_by, tiles_per_exact_admission=tiles,
               transform_step_shapes_added=RETRACE_PROBE.count - probe_before)
    log(f"service: {n_req} requests ({SERVICE_ROWS} rows x 2 models, 64 slots, max_k 96) in "
        f"{secs:.3f} s: {out['requests_per_s']:.1f} requests/s; latency p50/p95/p99 "
        f"{s['latency_s_p50']:.4f} / {s['latency_s_p95']:.4f} / {s['latency_s_p99']:.4f} s "
        f"(max {s['latency_s_max']:.4f}; every request queued at once); steps mean "
        f"{s['steps_mean']:.2f} (max {s['steps_max']}); {s['ticks']} ticks")
    admit_by = {name: sum(sp.duration_s for sp in tracer.find("service.admit")
                          if sp.attrs["dataset"] == name) for name in models}
    out["admit_s_by_model"] = admit_by
    log(f"service spans: service.admit {out['admit_s']:.3f} s over "
        f"{len(tracer.find('service.admit'))} admissions "
        f"({out['admit_s'] / n_req * 1e3:.3f} ms each; by model "
        + ", ".join(f"{k} {v:.3f} s, {v / SERVICE_ROWS * 1e3:.3f} ms each"
                    for k, v in admit_by.items())
        + f"), service.tick {out['tick_s']:.3f} s over {s['ticks']} ticks "
        f"({out['tick_s'] / s['ticks'] * 1e3:.3f} ms each); "
        f"{secs - out['admit_s'] - out['tick_s']:.3f} s outside both")
    log(f"service launches: {json.dumps(out['launches'])}; pairwise by model "
        f"{json.dumps(pairwise_by)} ({tiles} tiles an exact admission, blocks "
        f"{index.block_q} x {index.block_db}); transform_step shapes added "
        f"{out['transform_step_shapes_added']}")
    if not all(r.done and r.y is not None and np.isfinite(r.y).all() for r in reqs):
        fail("a service request finished without a finite result")
    m = service.metrics
    if s["completed"] != n_req or s["slot_occupancy_max"] != 64 or \
            s["queue_depth_max"] < 1 or m.gauge("service.queue_depth").value != 0 or \
            m.gauge("service.slot_occupancy").value != 0:
        fail(f"the service's telemetry is off: {json.dumps(s)}")
    if out["transform_step_shapes_added"] != 1:
        fail(f"the service added {out['transform_step_shapes_added']} transform_step "
             "shapes, not one ([64, 96])")
    if launches["bsp_search"] != n_req or pairwise_by["mnist_forest"] != 0 or \
            pairwise_by["mnist_exact"] != tiles * SERVICE_ROWS:
        fail(f"the admissions launched bsp {launches['bsp_search']} times (want {n_req}) "
             f"and pairwise {json.dumps(pairwise_by)} (want 0 and {tiles * SERVICE_ROWS})")

    # each model's placements against its batch transform of the same rows
    t0 = time.perf_counter()
    for j, (name, est) in enumerate(models.items()):
        y_srv = np.stack([r.y for r in reqs[j::len(models)]])
        out[f"vs_transform_{name}"] = service_bars(
            f"{name} against TSNE.transform", y_srv, est.transform(rows),
            float(np.ptp(est.embedding_)))

    log(f"service: the two batch transforms and their comparison took "
        f"{time.perf_counter() - t0:.1f} s")

    # the first SERVICE_CPU_ROWS requests on a CPU service: the same models
    # saved and loaded on the CPU, the forest model given the card's forest
    t0 = time.perf_counter()
    cpu_models = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, est in models.items():
            est.save(Path(tmp) / f"{name}.npz")
            cpu_models[name] = TSNE.load(Path(tmp) / f"{name}.npz", device="cpu")
    f = est_forest.query_index_
    cpu_models["mnist_forest"]._query_index = forest_index_from_numpy(
        f.x_ref.cpu().numpy(), f.leaves.cpu().numpy(), f.dirs.cpu().numpy(),
        [t.cpu().numpy() for t in f.thrs], device="cpu")
    cpu_service = EmbeddingService(slots=64, max_k=96, device="cpu")
    for name, est in cpu_models.items():
        cpu_service.add_model(name, est)
    cpu_reqs, cpu_secs = run_service(cpu_service, cpu_models,
                                     rows[:SERVICE_CPU_ROWS // len(models)])
    log(f"service on the CPU: {len(cpu_reqs)} requests in {cpu_secs:.3f} s (save, load "
        f"and run {time.perf_counter() - t0:.1f} s)")
    for j, (name, est) in enumerate(models.items()):
        out[f"card_vs_cpu_{name}"] = service_bars(
            f"{name}, card against CPU",
            np.stack([r.y for r in reqs[:SERVICE_CPU_ROWS][j::len(models)]]),
            np.stack([r.y for r in cpu_reqs[j::len(models)]]), float(np.ptp(est.embedding_)))

    # the smoke entry point, traced, as a user runs it
    trace = BUILD / "service_trace.json"
    BUILD.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.embed.service", "--smoke", "--trace", str(trace)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), capture_output=True,
        text=True, timeout=600)
    log(f"service smoke entry point: rc {proc.returncode} in {time.perf_counter() - t0:.1f} s: "
        f"{proc.stdout.strip()}")
    if proc.returncode != 0:
        fail(f"python -m repro_torch.embed.service --smoke failed:\n{proc.stderr[-4000:]}")
    with open(trace) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"}
    if not {"fit", "service.admit", "service.tick"} <= names:
        fail(f"the smoke's trace lacks service spans: {sorted(names)}")
    log("service summary: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# The multi-device path
# ---------------------------------------------------------------------------

SHARDS = 4                  # phase 13's mesh on one card: Mesh((cuda:0,) * SHARDS)
POS_SIZES = (33, 5000, 70_000)


def all_seconds(fn, reps: int = 3, inner: int = 5) -> float:
    """Median over ``reps`` of the host seconds of ``inner`` back-to-back
    calls of ``fn`` over ``inner``, every visible card synchronised before
    and after (a mesh's cards run at once: one card's events miss the
    others)."""
    fn()
    times = []
    for _ in range(reps):
        sync_all()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        sync_all()
        times.append((time.perf_counter() - t0) / inner)
    return float(np.median(times))


def issue_seconds(fn, reps: int = 3) -> float:
    """Median host seconds until one call of ``fn`` returns, every visible
    card idle before it and no synchronisation after: the time the host
    takes to queue the work.  Near the call's synchronised time, the host
    holds the cards back."""
    times = []
    for _ in range(reps):
        sync_all()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    sync_all()
    return float(np.median(times))


def shard_positions(perm: torch.Tensor, shards: int) -> list[torch.Tensor]:
    """The sorted positions of each of ``shards`` contiguous row blocks,
    ascending, int32: what core.distributed.local_bh_gradient walks."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return [torch.sort(block).values.to(torch.int32) for block in inv.tensor_split(shards)]


def check_pos_walk(what: str, y: torch.Tensor) -> None:
    """bh_traverse at each of SHARDS row blocks' sorted positions, bit for
    bit (force, z, steps) against the plain walk at the same positions and
    against the full walk's rows, at N = 33, 5 000 and all of y, theta 0.5."""
    from repro_torch.core.repulsive import bh_repulsion_sorted
    from repro_torch.kernels import ops
    sizes = sorted({min(m, y.shape[0]) for m in POS_SIZES})
    for m in sizes:
        y_s, tree, summ, perm = walk_inputs(y[:m].contiguous())
        full = ops.bh_traverse(y_s, tree, summ, 0.5)
        for r, pos in enumerate(shard_positions(perm, SHARDS)):
            got = ops.bh_traverse(y_s, tree, summ, 0.5, pos=pos)
            ref = bh_repulsion_sorted(y_s, tree, summ, 0.5, pos=pos)
            at = pos.long()
            if not all(torch.equal(a, b) and torch.equal(a, f[at])
                       for a, b, f in zip(got, ref, full)):
                fail(f"bh_traverse at positions ({what}, N = {m}, shard {r}) is not "
                     "bit-identical to the plain walk and the full walk's rows")
    log(f"bh_traverse at positions, {what}: N = {', '.join(map(str, sizes))}, "
        f"{SHARDS} shards' sorted positions, theta 0.5: force, z and steps bit-identical "
        "to the plain walk at the same positions and to the full walk's rows")


def check_row0(y: torch.Tensor, g) -> dict:
    """attractive_ell over each of SHARDS row blocks of the fit's graph with
    its row offset: bit for bit the full pass's rows (the same warp does
    the same work), and within phase 3's tolerance of the plain pass with
    the same offset.  Times the last shard's call."""
    from repro_torch.core import attractive
    from repro_torch.kernels import ops
    n = y.shape[0]
    full, _ = ops.attractive_ell(y, g.p_cols, g.p_vals, g.p_len)
    bounds = [(int(b[0]), int(b[-1]) + 1) for b in torch.arange(n).tensor_split(SHARDS)]
    for r0, r1 in bounds:
        args = (y, g.p_cols[r0:r1], g.p_vals[r0:r1], g.p_len[r0:r1])
        f_k, kl_k = ops.attractive_ell(*args, row0=r0)
        f_p, kl_p = attractive.attractive_forces_ell(*args, row0=r0)
        f_scale = float(f_p.abs().max())
        if not torch.equal(f_k, full[r0:r1]):
            fail(f"attractive_ell with row0 {r0} differs from the full pass's rows")
        if not (torch.allclose(f_k, f_p, rtol=1e-4, atol=1e-5 * f_scale)
                and abs(float(kl_k) - float(kl_p)) <= 1e-5 * abs(float(kl_p))):
            fail(f"attractive_ell with row0 {r0} disagrees with its plain version")
    r0, r1 = bounds[-1]
    ms = cuda_ms(lambda: ops.attractive_ell(y, g.p_cols[r0:r1], g.p_vals[r0:r1],
                                            g.p_len[r0:r1], row0=r0), inner=10)
    log(f"attractive_ell with row0, {SHARDS} row blocks of the BH fit's graph: bit-identical "
        f"to the full pass's rows, within rtol 1e-4 of the plain pass; one block "
        f"(row0 {r0}) {ms:.4f} ms")
    return dict(row0_ms=ms)


def sharded_parts(mesh, est):
    """The BH fit's embedding and graph, sharded row-wise over ``mesh``."""
    from repro_torch.core import distributed as dist
    g = est.neighbor_graph_
    y = torch.as_tensor(est.embedding_).cuda()
    if y.shape[0] % mesh.size:
        fail(f"{y.shape[0]} points do not split over {mesh.size} shards")
    return y, g, {k: dist.shard_rows(mesh, t) for k, t in
                  (("y", y), ("cols", g.p_cols), ("vals", g.p_vals), ("lens", g.p_len))}


def phase_sharded_gradient(est, mesh, label: str, breakdown: bool) -> dict:
    """distributed_bh_gradient at the BH fit's embedding against bh_gradient:
    every row of the repulsive force bit for bit (the same tree, the same
    positions); Z, the KL and the gradient differ only by the order of the
    per-shard partial sums: Z and the KL to 1e-5 and 1e-4 relative, the
    gradient to 1e-5 of the repulsive term 4 F_rep / Z (the fitted
    gradient is a small difference of the attractive and repulsive terms).
    Then one sharded descent step (launch.tsne_run.dist_step) against the
    single-device step, host seconds with every card synchronised; with
    ``breakdown`` the sharded step stage by stage (stages summed over the
    shards) and its idle share."""
    from repro_torch import convert
    from repro_torch.api import make_backend
    from repro_torch.core import distributed as dist, morton, quadtree
    from repro_torch.core.summarize import summarize
    from repro_torch.core.tsne import (
        GradResult, TsneConfig, TsneState, bh_gradient, combine_forces, tsne_step,
    )
    from repro_torch.kernels import ops
    from repro_torch.launch.tsne_run import dist_step

    y, g, sh = sharded_parts(mesh, est)
    n, n_loc = y.shape[0], y.shape[0] // mesh.size
    res = dist.distributed_bh_gradient(mesh, sh["y"], sh["cols"], sh["vals"], g.p_logp,
                                       theta=0.5, exaggeration=1.0, p_len=sh["lens"])
    ref = bh_gradient(y, g.p_cols, g.p_vals, None, 0.5, 1.0, 16, g.p_logp, p_len=g.p_len)
    y_s, tree, summ, perm = walk_inputs(y)
    f_rep = torch.empty_like(y)
    f_rep[perm] = ops.bh_traverse(y_s, tree, summ, 0.5).force
    local = [dist.local_bh_gradient(y.to(dev), r, n_loc, sh["cols"][r], sh["vals"][r],
                                    sh["lens"][r], theta=0.5)
             for r, dev in enumerate(mesh.devices)]
    same_rows = torch.equal(dist.gather_rows([p.f_rep for p in local], y.device), f_rep)
    grad = dist.gather_rows(res.grad, y.device)
    term = float(torch.linalg.norm(4.0 * f_rep / ref.z))
    rel = float(torch.linalg.norm(grad - ref.grad)) / term
    z_rel = abs(float(res.z) - float(ref.z)) / float(ref.z)
    kl_rel = abs(float(res.kl) - float(ref.kl)) / abs(float(ref.kl))
    log(f"sharded gradient ({label}) at the BH fit's embedding: f_rep rows bit-identical "
        f"{same_rows}; |d grad| / |4 F_rep / Z| {rel:.3e}, Z relative {z_rel:.3e}, KL "
        f"{float(res.kl):.6f} against {float(ref.kl):.6f} (relative {kl_rel:.3e})")
    if not same_rows or rel > 1e-5 or z_rel > 1e-5 or kl_rel > 1e-4:
        fail(f"the sharded gradient ({label}) disagrees with bh_gradient")

    lr = est.learning_rate_
    state = TsneState(y=y, velocity=torch.zeros_like(y), gains=torch.ones_like(y), iteration=0)
    states = convert.shard_state(mesh, state)
    backend = make_backend("barnes_hut", TsneConfig(), n)

    def single():
        return tsne_step(state, g, 1.0, 0.8, backend=backend, lr=lr, min_gain=0.01)

    def sharded():
        return dist_step(mesh, states, sh["cols"], sh["vals"], sh["lens"], theta=0.5,
                         exag=1.0, mom=0.8, lr=lr, min_gain=0.01)

    out = dict(shards=mesh.size, f_rep_bit_identical=same_rows, grad_rel=rel, z_rel=z_rel,
               kl_rel=kl_rel, single_step_s=all_seconds(single),
               sharded_step_s=all_seconds(sharded), single_issue_s=issue_seconds(single),
               sharded_issue_s=issue_seconds(sharded))
    out["sharded_over_single"] = out["sharded_step_s"] / out["single_step_s"]
    if breakdown:
        runs = []
        for _ in range(3):
            lap = Laps()
            y_full = dist.all_gather(mesh, sh["y"])
            lap("all_gather")
            parts = []
            for r in range(mesh.size):
                yf = y_full[r]
                cent, r_span = morton.span_radius(yf)
                codes = ops.morton_encode(yf, cent, r_span)
                lap("morton_encode")
                codes_s, ys, pm = quadtree.sort_points_by_code(yf, codes)
                lap("sort")
                tr = quadtree.build_quadtree(codes_s)
                lap("build_quadtree")
                sm = summarize(tr, ys, r_span)
                lap("summarize")
                inv = torch.empty_like(pm)
                inv[pm] = torch.arange(n, device=pm.device)
                pos, order = torch.sort(inv[r * n_loc:(r + 1) * n_loc])
                lap("positions")
                rep = ops.bh_traverse(ys, tr, sm, 0.5, pos=pos.to(torch.int32))
                fr = torch.empty_like(rep.force)
                fr[order] = rep.force
                lap("traversal")
                fa, kla = ops.attractive_ell(yf, sh["cols"][r], sh["vals"][r], sh["lens"][r],
                                             row0=r * n_loc)
                lap("attractive")
                parts.append((fr, fa, torch.sum(rep.z_per_point), kla))
            z = dist.psum(mesh, [p[2] for p in parts])
            kl_attr = dist.psum(mesh, [p[3] for p in parts])
            got = [combine_forces(p[1], kl_attr[r], p[0], z[r], 1.0, g.p_logp)
                   for r, p in enumerate(parts)]
            dist.gd_update_sharded(mesh, states, [r.grad for r in got], lr, 0.8, 0.01)
            lap("psum_combine_update")
            runs.append(lap.t)
        check_same_step("sharded", GradResult(dist.gather_rows([r.grad for r in got]),
                                              got[0].kl, got[0].z, got[0].max_traversal),
                        GradResult(grad, res.kl, res.z, res.max_traversal), f_rep)
        out["stages"] = median_laps(runs)
        out["stages"]["tree_share"] = (out["stages"]["build_quadtree"]
                                       + out["stages"]["summarize"]) / out["stages"]["total"]
        add_busy_share(out, sharded, inner=3)
    log(f"sharded step ({label}): " + json.dumps(out))
    return out


def phase_ring_knn(x: torch.Tensor, mesh, label: str, ref) -> dict:
    """ring_knn of MNIST over ``mesh`` against the main path's exact KNN
    (``ref``: its idx and d2): the row sets the same in >= 99.9% of rows
    (ties at the k-th distance fall in another order: the ring keeps the
    earlier hop's), the sorted distances within pairwise's tolerance."""
    from repro_torch.core import distributed as dist
    ref_i, ref_d = ref
    k = ref_i.shape[1]
    (idx, d2), secs = synced_seconds(
        lambda: dist.ring_knn(mesh, dist.shard_rows(mesh, x), k))
    idx, d2 = dist.gather_rows(idx, x.device), dist.gather_rows(d2, x.device)
    same = float((torch.sort(idx, 1).values == torch.sort(ref_i, 1).values).all(1)
                 .double().mean())
    sqn = torch.sum(x * x, 1)
    share = float(((d2 - ref_d).abs() / pairwise_tol(ref_d, sqn[:, None],
                                                      sqn[ref_i.long()])).max())
    out = dict(shards=mesh.size, seconds=secs, same_rows=same, d2_tol_share=share)
    log(f"ring_knn ({label}) on MNIST [{x.shape[0]}, {x.shape[1]}], K = {k}: {secs:.3f} s; "
        f"row sets equal to the exact KNN's in {same:.6f} of rows (>= 0.999); d2 "
        f"{share:.3f} of pairwise's tolerance at most")
    if same < 0.999 or share > 1.0:
        fail(f"ring_knn ({label}) disagrees with the exact KNN")
    return out


def phase_ring_knn_approx(mesh, label: str, mouse, k: int) -> dict:
    """ring_knn_approx with its defaults (8 trees of >= 64 points a shard,
    blocks of 4 096 rows) on all of mouse_1p3m over ``mesh``, zero-padded
    to a shard multiple as the sharded backend pads: seconds, peak memory,
    every row valid, d2 true and recall@K on phase 9's sampled rows."""
    from repro_torch.core import distributed as dist
    x, rows, ref_idx = mouse
    n = x.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, 0, (-n) % mesh.size))
    torch.cuda.reset_peak_memory_stats()
    (idx, d2), secs = synced_seconds(
        lambda: dist.ring_knn_approx(mesh, dist.shard_rows(mesh, xp), k, n_valid=n))
    idx, d2 = dist.gather_rows(idx, x.device)[:n], dist.gather_rows(d2, x.device)[:n]
    recall = check_graph(f"ring_knn_approx ({label}) on mouse_1p3m [{n}, {x.shape[1]}], "
                         f"K = {k}", x, idx, d2, rows, ref_idx)
    out = dict(shards=mesh.size, seconds=secs, recall=recall,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"ring_knn_approx ({label}): " + json.dumps(out))
    return out


def phase_collectives(x: torch.Tensor, mesh) -> dict:
    """The copies between cards behind the collectives: which pairs have
    peer access, one ring hop of MNIST's shards (ring_knn's hop, rank r
    receiving rank r - 1's [N / S, 784] rows) timed alone (bytes/s), and
    the host's seconds to issue that hop behind ~10 queued matrix
    products on every card (the hop waits for them on the cards; if it
    also holds the host, its issue time shows it)."""
    from repro_torch.core import distributed as dist
    idx = [d.index for d in mesh.devices]
    peer = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in idx] for i in idx]
    parts = dist.shard_rows(mesh, x)
    nbytes = sum(p.numel() * p.element_size() for p in parts)
    dist.ring_permute(mesh, parts)
    (_, hop_s) = synced_seconds(lambda: dist.ring_permute(mesh, parts))
    mats = [torch.randn((8192, 8192), device=d) for d in mesh.devices]
    sync_all()
    t0 = time.perf_counter()
    for _ in range(10):
        for m in mats:
            m @ m
    queued = time.perf_counter()
    dist.ring_permute(mesh, parts)
    issued = time.perf_counter()
    sync_all()
    out = dict(peer_access=peer, hop_bytes=nbytes, hop_s=hop_s, hop_gb_s=nbytes / hop_s / 1e9,
               queue_s=queued - t0, hop_issue_behind_queue_s=issued - queued,
               queue_done_s=time.perf_counter() - t0)
    log(f"collectives ({mesh.size} cards): " + json.dumps(out))
    return out


def phase_sharded_fit(mesh, label: str, x_np: np.ndarray, args, bh_kl: float) -> tuple:
    """launch.tsne_run.run_distributed over ``mesh`` on MNIST, the BH fit's
    steps and schedules, its launch counts reset before and read after:
    morton, attractive and bh_traverse once a shard a step, pairwise > 0,
    bsp once; the final KL with sum p log p added back within 2% of the BH
    fit's (phase 5).  Returns (summary, launches)."""
    from repro_torch.core.tsne import TsneConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.tsne_run import run_distributed
    cfg = TsneConfig(perplexity=30.0, exaggeration_iters=args.exaggeration_iters,
                     momentum_switch_iter=args.exaggeration_iters)
    ops.reset_launch_counts()
    run = run_distributed(mesh, x_np, cfg, args.n_iter)
    sync_all()
    launches = dict(ops.LAUNCHES)
    kl = run.kl + run.p_logp
    out = dict(shards=mesh.size, n=run.n, steps=args.n_iter, kl=kl, bh_fit_kl=bh_kl,
               kl_rel=abs(kl - bh_kl) / abs(bh_kl), **run.timings,
               step_s=run.timings["descent"] / args.n_iter, launches=launches,
               kl_history=[[i, v + run.p_logp] for i, v in run.kl_history])
    log(f"sharded fit ({label}): " + json.dumps(out))
    if not np.isfinite(run.y).all() or run.y.shape != (run.n, 2):
        fail(f"the sharded fit ({label}) gave a non-finite embedding")
    if out["kl_rel"] > 0.02:
        fail(f"the sharded fit's KL {kl} ({label}) is not within 2% of the BH fit's {bh_kl}")
    per_step = {k: launches[k] for k in ("morton_encode", "attractive_ell", "bh_traverse")}
    if any(v != mesh.size * args.n_iter for v in per_step.values()):
        fail(f"the sharded fit ({label}) ran {args.n_iter} steps on {mesh.size} shards but "
             f"launched {per_step}")
    if launches["pairwise_sq_dists"] <= 0 or launches["bsp_search"] != 1:
        fail(f"the sharded fit's graph ({label}) launched {launches}")
    return out, launches


def phase_sharded_preprocess(x: torch.Tensor) -> dict:
    """preprocess with TsneConfig(neighbor_method="sharded") (the approximate
    ring's defaults over every visible card) on MNIST: the graph's
    invariants and the seconds of each stage."""
    from repro_torch.core.tsne import TsneConfig, preprocess
    cfg = TsneConfig(perplexity=30.0, neighbor_method="sharded")
    (graph, timings), secs = synced_seconds(lambda: preprocess(x, cfg))
    cols, vals = graph.p_cols, graph.p_vals
    total = float(vals.double().sum())
    ok = (timings["neighbor_method"] == "sharded"
          and bool(((cols >= 0) & (cols < x.shape[0])).all())
          and bool(torch.isfinite(vals).all()) and bool((vals >= 0).all())
          and abs(total - 1.0) <= 1e-4)
    out = dict(seconds=secs, cards=torch.cuda.device_count(), p_sum=total,
               **{k: timings[k] for k in ("knn", "bsp", "symmetrize")})
    log("sharded preprocess through TsneConfig(neighbor_method='sharded'): " + json.dumps(out))
    if not ok:
        fail("the sharded preprocess broke the graph's invariants")
    return out


def phase_sharded(est, x: torch.Tensor, x_np: np.ndarray, mouse, args) -> tuple:
    """Phase 13 on Mesh((cuda:0,) * SHARDS), then (the gradient, the rings
    and the fit) on every card when more than one is visible.  Returns
    (the one-card mesh's fit launches, extra keys of the kernels line's
    rows)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.knn import knn
    from repro_torch.kernels import ops
    y = torch.as_tensor(est.embedding_).cuda()
    check_pos_walk("the BH fit's embedding", y)
    for what, far in far_clusters().items():
        check_pos_walk(what, far.cuda())
    extra = {"attractive_ell": check_row0(y, est.neighbor_graph_)}
    y_s, tree, summ, perm = walk_inputs(y)
    pos = shard_positions(perm, SHARDS)[-1]
    extra["bh_traverse"] = dict(pos_ms=cuda_ms(
        lambda: ops.bh_traverse(y_s, tree, summ, 0.5, pos=pos), inner=10))
    log(f"bh_traverse of one shard's {pos.shape[0]} positions at the BH fit's embedding: "
        f"{extra['bh_traverse']['pos_ms']:.4f} ms")

    one = dist.Mesh((torch.device("cuda", 0),) * SHARDS)
    label = f"{SHARDS} shards on cuda:0"
    ref = knn(x, est.n_neighbors_, KNN_BLOCK_Q, KNN_BLOCK_DB)     # the main path's exact KNN
    summary = dict(gradient=phase_sharded_gradient(est, one, label, breakdown=True),
                   ring_knn=phase_ring_knn(x, one, label, ref),
                   ring_knn_approx=phase_ring_knn_approx(one, label, mouse, est.n_neighbors_))
    summary["fit"], launches = phase_sharded_fit(one, label, x_np, args, est.kl_divergence_)
    if torch.cuda.device_count() > 1:
        every = dist.make_mesh(torch.cuda.device_count())
        label = f"{every.size} cards"
        summary["cards"] = dict(
            collectives=phase_collectives(x, every),
            gradient=phase_sharded_gradient(est, every, label, breakdown=False),
            ring_knn=phase_ring_knn(x, every, label, ref),
            ring_knn_approx=phase_ring_knn_approx(every, label, mouse, est.n_neighbors_),
            fit=phase_sharded_fit(every, label, x_np, args, est.kl_divergence_)[0])
    summary["preprocess"] = phase_sharded_preprocess(x)
    log("sharded summary: " + json.dumps(summary))
    return launches, extra


# ---------------------------------------------------------------------------
# The paper's million-point pipeline, and the naive baseline
# ---------------------------------------------------------------------------

MOUSE_N = 1_291_337         # all of mouse_1p3m: N is never cut
MOUSE_ITERS = 300           # the reference docstring's million-point example (the one cut)
MOUSE_SHARDS = 4            # --shards 4: Mesh((cuda:0,) * 4) on one card
MOUSE_CKPT_EVERY = 100
MOUSE_RESUME = 200          # the resumed run starts from this step's checkpoint
MOUSE_STEP_KERNELS = ("morton_encode", "attractive_ell", "bh_traverse")
MOUSE_KERNELS = ("bsp_search",) + MOUSE_STEP_KERNELS
BSP_CHUNK = 100_000         # the example's --chunk-size at N >= 200 000


def mouse_kernel_rows(run, perplexity: float) -> dict:
    """Each per-step kernel at the mouse fit's final embedding and graph
    (N = 1 291 337), and bsp_search on one of the path's [100 000, 90]
    slices: wrapper ms, device ms, the plain twin's ms and the bound,
    counted as phase 3 counts them.  The walk is held bit for bit against
    its plain twin at this N; the others to phase 3's tolerances.  The
    plain attractive pass runs in 100 000-row blocks (``row0``): its
    [rows, W, 2] gathers do not fit the card in one call at the graph's W.  bsp's
    input is sorted synthetic distances: its 65 passes do not depend on the
    values, and the pipeline does not return its d2."""
    from repro_torch.core import attractive, bsp, morton
    from repro_torch.core.repulsive import bh_repulsion_sorted
    from repro_torch.kernels import ops
    y = torch.as_tensor(run.y).cuda()
    g = run.graph
    n, k = y.shape[0], int(3 * perplexity)
    out = {}

    def put(name, ms, plain_ms, flops, nbytes, device_ms, sfu=0.0, **extra):
        b_ms, b_by = bound(flops, nbytes, sfu=sfu)
        out[name] = dict(mouse_ms=ms, mouse_device_ms=device_ms, mouse_plain_ms=plain_ms,
                         mouse_bound_ms=b_ms, mouse_bound_by=b_by, **extra)
        log(f"mouse kernel {name}: {ms:.4f} ms (device {device_ms} ms)  plain "
            f"{plain_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})"
            + "".join(f"  {key} {v}" for key, v in extra.items()))

    gen = torch.Generator(device="cpu").manual_seed(21)
    d2 = torch.sort(torch.rand((BSP_CHUNK, k), generator=gen) * 50.0, dim=1).values.cuda()
    p_k, b_k = ops.bsp_search(d2, perplexity)
    p_p, b_p = bsp.binary_search_perplexity_plain(d2, perplexity)
    check_bsp(f"[{BSP_CHUNK}, {k}]", p_k, b_k, p_p, b_p)
    nk = d2.numel()
    put("bsp_search", cuda_ms(lambda: ops.bsp_search(d2, perplexity)),
        cuda_ms(lambda: bsp.binary_search_perplexity_plain(d2, perplexity), reps=3, inner=1),
        65.0 * 6.0 * nk, 4.0 * (2 * nk + BSP_CHUNK),
        kernel_ms(lambda: ops.bsp_search(d2, perplexity), "bsp"), sfu=65.0 * nk,
        shape=[BSP_CHUNK, k])

    cent, r_span = morton.span_radius(y)
    if not torch.equal(ops.morton_encode(y, cent, r_span), morton.morton_encode(y, cent, r_span)):
        fail("morton_encode is not bit-identical to its plain version at the mouse embedding")
    put("morton_encode", cuda_ms(lambda: ops.morton_encode(y, cent, r_span), inner=20),
        cuda_ms(lambda: morton.morton_encode(y, cent, r_span), inner=20),
        6.0 * n, 16.0 * n + 12.0, kernel_ms(lambda: ops.morton_encode(y, cent, r_span), "morton"))

    cols, vals, p_len = g.p_cols, g.p_vals, g.p_len
    nnz = int(p_len.sum())

    def plain_attractive():
        # the plain twin's [rows, W, 2] gathers do not fit the card at the
        # mouse graph's width in one call: row blocks against the global y
        parts = [attractive.attractive_forces_ell(y, cols[r:r + BSP_CHUNK],
                                                  vals[r:r + BSP_CHUNK],
                                                  p_len[r:r + BSP_CHUNK], row0=r)
                 for r in range(0, n, BSP_CHUNK)]
        return torch.cat([f for f, _ in parts]), sum(kl for _, kl in parts)

    f_k, kl_k = ops.attractive_ell(y, cols, vals, p_len)
    (f_p, kl_p), plain_s = synced_seconds(plain_attractive)
    if not (torch.allclose(f_k, f_p, rtol=1e-4, atol=1e-5 * float(f_p.abs().max()))
            and abs(float(kl_k) - float(kl_p)) <= 1e-5 * abs(float(kl_p))):
        fail("attractive_ell disagrees with its plain version at the mouse graph")
    put("attractive_ell", cuda_ms(lambda: ops.attractive_ell(y, cols, vals, p_len), inner=10),
        plain_s * 1e3, 13.0 * nnz, 8.0 * nnz + 24.0 * n,
        kernel_ms(lambda: ops.attractive_ell(y, cols, vals, p_len), "attractive"),
        max_abs_err=float((f_k - f_p).abs().max()), nnz=nnz)

    y_s, tree, summ, _ = walk_inputs(y)
    got = ops.bh_traverse(y_s, tree, summ, 0.5)
    (ref, plain_s) = synced_seconds(lambda: bh_repulsion_sorted(y_s, tree, summ, 0.5))
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        fail("bh_traverse is not bit-identical to its plain walk at the mouse embedding")
    visits, n_nodes = int(got.steps.sum()), int(tree.n_nodes)
    pack_ms = kernel_ms(lambda: ops.bh_traverse(y_s, tree, summ, 0.5), "traverse_pack")
    walk_ms = kernel_ms(lambda: ops.bh_traverse(y_s, tree, summ, 0.5), "traverse_walk")
    put("bh_traverse", cuda_ms(lambda: ops.bh_traverse(y_s, tree, summ, 0.5), inner=5),
        plain_s * 1e3, 15.0 * visits, 40.0 * n_nodes + 8.0 + 28.0 * n,
        None if pack_ms is None or walk_ms is None else pack_ms + walk_ms,
        n_nodes=n_nodes, visits=visits, max_steps=int(got.steps.max()))
    return out


def phase_mouse(perplexity: float = 30.0) -> tuple:
    """Phase 14: repro_torch.examples.mouse_pipeline's main on all of
    mouse_1p3m, its launch counts set to 0 just before and read just after,
    then a resume from its step-200 checkpoint; see the module docstring.
    Returns (summary, launches, per-kernel extras, the run)."""
    from repro_torch.core.tsne import TsneConfig
    from repro_torch.device import MESH_DEVICES_ENV
    from repro_torch.examples import mouse_pipeline
    from repro_torch.kernels import ops
    from repro_torch.neighbors import sharded
    forced_before = os.environ.get(MESH_DEVICES_ENV)
    with tempfile.TemporaryDirectory(prefix="mouse_") as tmp:
        a, b = Path(tmp) / "a", Path(tmp) / "b"
        argv = ["--n", str(MOUSE_N), "--shards", str(MOUSE_SHARDS), "--method",
                "barnes_hut", "--iters", str(MOUSE_ITERS), "--perplexity", str(perplexity),
                "--ckpt_every", str(MOUSE_CKPT_EVERY), "--kl_every", "50"]
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        try:
            run, secs = synced_seconds(lambda: mouse_pipeline.main(
                argv + ["--ckpt_dir", str(a), "--out", str(a / "y.npy")]))
            launches = dict(ops.LAUNCHES)
            mesh = sharded.visible_devices(torch.device("cuda"))
            peak = torch.cuda.max_memory_allocated() / 2**30
            shutil.copytree(a / f"step_{MOUSE_RESUME:010d}", b / f"step_{MOUSE_RESUME:010d}")
            resumed, resume_secs = synced_seconds(lambda: mouse_pipeline.main(
                argv + ["--ckpt_dir", str(b), "--out", str(b / "y.npy")], graph=run.graph))
        finally:
            if forced_before is None:
                os.environ.pop(MESH_DEVICES_ENV, None)
    g = run.graph
    cards = torch.cuda.device_count()
    want_mesh = tuple(torch.device("cuda", i % cards) for i in range(MOUSE_SHARDS))
    w, nnz = int(g.p_cols.shape[1]), int(g.p_len.sum())
    gib = sum(t.numel() * t.element_size() for t in (g.p_cols, g.p_vals, g.p_len)) / 2**30
    t = run.timings
    summary = dict(
        n=MOUSE_N, steps=MOUSE_ITERS, seconds=secs, mesh=[str(d) for d in mesh],
        knn=t["knn"], bsp=t["bsp"], symmetrize=t["symmetrize"],
        gradient_descent=t["gradient_descent"], ms_per_step=run.ms_per_step,
        neighbor_method=t["neighbor_method"], chunk_size=t["chunk_size"],
        W=w, nnz=nnz, row_len_mean=nnz / MOUSE_N, row_len_max=int(g.p_len.max()),
        graph_gib=gib, peak_gib=peak, kl_history=run.kl_history,
        resume_from=resumed.start, resume_seconds=resume_secs,
        resume_ms_per_step=resumed.ms_per_step)
    log("mouse pipeline (phase 14): " + json.dumps(summary))
    log(f"mouse pipeline launches: {json.dumps(launches)}")
    if t["neighbor_method"] != "sharded" or mesh != want_mesh:
        fail(f"the mouse pipeline's KNN did not run on Mesh({want_mesh}): "
             f"{t['neighbor_method']} over {mesh}")
    if run.y.shape != (MOUSE_N, 2) or not np.isfinite(run.y).all():
        fail("the mouse embedding is not finite or of the wrong shape")
    missing = [kname for kname in MOUSE_KERNELS if launches[kname] <= 0]
    if missing:
        fail(f"the mouse pipeline never launched {missing}")
    check_launches("mouse", launches, MOUSE_KERNELS, MOUSE_STEP_KERNELS, MOUSE_ITERS)
    kls = dict(run.kl_history)
    if not np.isfinite(list(kls.values())).all():
        fail(f"the mouse fit's KL is not finite: {run.kl_history}")
    exag = TsneConfig().exaggeration_iters      # the example's schedule
    if not kls[MOUSE_ITERS] < kls[exag]:
        fail(f"the mouse fit's KL did not fall after the exaggerated steps: {run.kl_history}")
    if resumed.start != MOUSE_RESUME:
        fail(f"the resumed mouse run started at {resumed.start}, not {MOUSE_RESUME}")
    if not np.array_equal(resumed.y.view(np.uint32), run.y.view(np.uint32)):
        diff = np.abs(resumed.y - run.y)
        fail(f"the mouse run resumed from step {MOUSE_RESUME} differs from the straight run "
             f"at {int((diff > 0).any(1).sum())} points (max |dy| {float(diff.max()):.3e})")
    log(f"mouse resume from step {MOUSE_RESUME}: the embedding equals the straight run's "
        f"bit for bit (KL {resumed.kl:.6f} against {run.kl:.6f})")
    extra = mouse_kernel_rows(run, perplexity)
    for kname in extra:
        extra[kname]["mouse_launches"] = launches[kname]
    return summary, launches, extra, run


def phase_naive(label: str, y: torch.Tensor, graph) -> dict:
    """Phase 15 at one embedding: the paper's per-step rows (Tables 5/6),
    naive against optimised on the card.  The naive build and summaries
    (core.naive, 16 levels) against Morton + sort + build_quadtree +
    summarize (walk_inputs, as bh_gradient builds them); naive_attractive
    (a loop over the W slots) against the attractive_ell kernel.  Naive on
    the card against naive on the CPU: ids and counts equal, centres of
    mass and forces allclose(rtol=1e-5, atol=1e-6); the two attractive
    passes against each other at that tolerance."""
    from repro_torch.core.naive import naive_attractive, naive_build_and_summarize
    from repro_torch.kernels import ops
    tol = dict(rtol=1e-5, atol=1e-6)
    cols, vals, p_len = graph.p_cols, graph.p_vals, graph.p_len
    ids, coms, counts = naive_build_and_summarize(y)
    ids_c, coms_c, counts_c = naive_build_and_summarize(y.cpu())
    if not torch.equal(ids.cpu(), ids_c) or \
            not all(torch.equal(a.cpu(), b) for a, b in zip(counts, counts_c)):
        fail(f"naive build ({label}): the card's ids or counts differ from the CPU's")
    com_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(coms, coms_c))
    if not all(torch.allclose(a.cpu(), b, **tol) for a, b in zip(coms, coms_c)):
        fail(f"naive build ({label}): centres of mass differ from the CPU's "
             f"(max |d| {com_err:.3e})")
    f_n = naive_attractive(y, cols, vals)
    # the CPU copies column-major: the same values, and each slot's column
    # contiguous, so the CPU's loop over W slots (1 399 at the mouse graph)
    # reads no strided column
    f_c = naive_attractive(y.cpu(), cols.t().contiguous().cpu().t(),
                           vals.t().contiguous().cpu().t())
    f_k, _ = ops.attractive_ell(y, cols, vals, p_len)
    if not torch.allclose(f_n.cpu(), f_c, **tol):
        fail(f"naive_attractive ({label}): the card disagrees with the CPU")
    if not torch.allclose(f_n, f_k, **tol):
        fail(f"naive_attractive ({label}) disagrees with the attractive_ell kernel")
    out = dict(
        n=int(y.shape[0]), W=int(cols.shape[1]), com_max_abs_err=com_err,
        force_max_abs_err_cpu=float((f_n.cpu() - f_c).abs().max()),
        force_max_abs_err_kernel=float((f_n - f_k).abs().max()),
        force_max=float(f_k.abs().max()),
        naive_build_ms=cuda_ms(lambda: naive_build_and_summarize(y), reps=3, inner=1),
        build_ms=cuda_ms(lambda: walk_inputs(y), reps=5, inner=2),
        naive_attractive_ms=cuda_ms(lambda: naive_attractive(y, cols, vals), reps=3, inner=1),
        attractive_ms=cuda_ms(lambda: ops.attractive_ell(y, cols, vals, p_len), inner=10))
    out["build_speedup"] = out["naive_build_ms"] / out["build_ms"]
    out["attractive_speedup"] = out["naive_attractive_ms"] / out["attractive_ms"]
    log(f"naive vs optimised ({label}): " + json.dumps(out))
    return out


# registry name -> the CUDA kernels (function names in csrc/*.cu) of one
# wrapper call, in launch order
CONTRACT_KERNELS = {
    "pairwise_sq_dists": ("pairwise_kernel",), "bsp_search": ("bsp_kernel",),
    "morton_encode": ("morton_kernel",), "attractive_ell": ("attractive_kernel",),
    "fft_spread": ("spread_kernel",), "fft_gather": ("gather_kernel",),
    "bh_traverse": ("traverse_pack_kernel", "traverse_walk_kernel"),
}
REGISTERS_A_SM = 65_536


def ptxas_static_smem(logs: dict[str, str]) -> dict[str, int]:
    """Mangled kernel name -> static shared memory (bytes) from the builds'
    ``-Xptxas -v`` reports: each entry's "Used N registers" line, which
    names "M bytes smem" only where M > 0."""
    out, entry = {}, None
    for text in logs.values():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and "Used" in line and "registers" in line:
                out[entry] = int(line.split("bytes smem")[0].rsplit(",", 1)[-1]) \
                    if "bytes smem" in line else 0
                entry = None
    return out


def mangled_key(name: str) -> str | None:
    """The part of an Itanium-mangled name that identifies the kernel a
    profiler event names (``ns::bsp_kernel<8>(...)`` -> ``10bsp_kernelILi8EE``)."""
    m = re.search(r"(\w+)(?:<([^<>]*)>)?\(", name)
    if m is None:
        return None
    base, targ = m.groups()
    if targ is None:
        return f"{len(base)}{base}E"
    code = {"true": "Lb1E", "false": "Lb0E"}.get(targ.strip(), f"Li{targ.strip()}E")
    return f"{len(base)}{base}I{code}E"


def contract_events(fn, bases: tuple[str, ...], path: Path) -> list[dict]:
    """The first kernel event of each of ``bases`` (in order) in a
    torch.profiler trace of ``fn()``, exported as a Chrome trace to
    ``path``; three traces at most, since a trace can drop kernel events."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("cat") == "kernel"]
        found = [next((e for e in events if f"{b}<" in e["name"] or f"{b}(" in e["name"]),
                      None) for b in bases]
        if all(found):
            return found
    missing = [b for b, e in zip(bases, found) if e is None]
    fail(f"phase 16: three torch.profiler traces recorded no launch of {missing}")


def phase_contracts(smi: str, build_logs: dict[str, str]) -> dict[str, list[dict]]:
    """Phase 16: the static-analysis suite with --gate (the launch-contract
    pass over every kernel at the config's envelope, on meta tensors, and
    the host-sync and concurrency passes over src/repro_torch), then each
    of the seven kernels launched once at a small shape under
    torch.profiler.  From each kernel event: grid, block, registers a
    thread, shared memory (static + dynamic; static from ptxas -v) and the
    estimated achieved occupancy.  Grid, block and dynamic shared memory
    must equal ops.launch_plan's for the call's integer arguments;
    registers x threads <= 65 536 and static + dynamic <= SMEM_LIMIT.
    What the trace does not give is "not recorded"."""
    from repro_torch.analysis.cli import main as analysis_main
    from repro_torch.analysis.launch_contracts import record_launches
    from repro_torch.core import fft_repulsion
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    if analysis_main(["--gate"]) != 0:
        fail("phase 16: python -m repro_torch.analysis --gate reports new findings")
    log(f"contracts: analysis --gate clean in {time.perf_counter() - t0:.2f} s")
    static = ptxas_static_smem(build_logs)
    gen = torch.Generator(device="cpu").manual_seed(16)
    n, k, nodes = 5000, 90, 97

    def dev(*shape):
        return torch.rand(*shape, generator=gen).cuda()

    y = dev(n, 2) * 20 - 10
    cent, r_span = torch.tensor([0.0, 0.0]).cuda(), torch.tensor(10.0).cuda()
    cols = torch.randint(0, n, (n, k), generator=gen, dtype=torch.int32).cuda()
    p_len = torch.randint(0, k + 1, (n,), generator=gen, dtype=torch.int32).cuda()
    base, wx, wy, _ = fft_repulsion.interp_coords(y, (nodes - 1) // 2)
    y_s, tree, summ, _ = walk_inputs(y)
    calls = {
        "pairwise_sq_dists": lambda: ops.pairwise_sq_dists(dev(300, 64), dev(1000, 64)),
        "bsp_search": lambda: ops.bsp_search(dev(1000, k) * 10, 30.0),
        "morton_encode": lambda: ops.morton_encode(y, cent, r_span),
        "attractive_ell": lambda: ops.attractive_ell(y, cols, dev(n, k), p_len),
        "fft_spread": lambda: ops.fft_spread(base, wx, wy, dev(n, 3), nodes),
        "fft_gather": lambda: ops.fft_gather(dev(nodes, nodes, 4), base, wx, wy),
        "bh_traverse": lambda: ops.bh_traverse(y_s, tree, summ, 0.5),
    }
    out = {}
    for name, call in calls.items():
        records = []
        with record_launches(records):     # the call's integer arguments; nothing runs
            call()
        plans = ops.launch_plan(name, *records[0].values)
        if len(records) != 1 or len(plans) != len(CONTRACT_KERNELS[name]):
            fail(f"phase 16: {name}: {len(records)} C entry calls, {len(plans)} launch "
                 f"plans, expected 1 and {len(CONTRACT_KERNELS[name])}")
        events = contract_events(call, CONTRACT_KERNELS[name], BUILD / "contracts.json")
        rows = []
        for base_name, plan, ev in zip(CONTRACT_KERNELS[name], plans, events):
            args = ev.get("args", {})
            if "grid" not in args or "block" not in args:
                fail(f"phase 16: the trace's kernel events carry no grid/block; their "
                     f"argument names: {sorted(args)}")
            grid, block = tuple(args["grid"]), tuple(args["block"])
            regs = args.get("registers per thread")
            smem_total = args.get("shared memory")
            key = mangled_key(ev["name"])
            s_static = next((v for m, v in static.items() if key and key in m), None)
            dynamic = None if smem_total is None or s_static is None else smem_total - s_static
            row = dict(kernel=base_name, grid=list(grid), block=list(block),
                       plan_grid=list(plan.grid), plan_block=list(plan.block),
                       plan_smem_dynamic=plan.smem_bytes,
                       registers_per_thread=regs if regs is not None else "not recorded",
                       smem_static=s_static if s_static is not None else "not recorded",
                       smem_dynamic=dynamic if dynamic is not None else "not recorded",
                       smem_total=smem_total if smem_total is not None else "not recorded",
                       occupancy_pct=args.get("est. achieved occupancy %", "not recorded"),
                       card=smi)
            if grid != plan.grid or block != plan.block:
                fail(f"phase 16: {base_name} launched grid {grid} block {block}, "
                     f"launch_plan gives {plan.grid} {plan.block}")
            if dynamic is not None and dynamic != plan.smem_bytes:
                fail(f"phase 16: {base_name} took {dynamic} bytes of dynamic shared memory, "
                     f"launch_plan gives {plan.smem_bytes}")
            threads = block[0] * block[1] * block[2]
            if regs is not None and regs * threads > REGISTERS_A_SM:
                fail(f"phase 16: {base_name}: {regs} registers x {threads} threads > "
                     f"{REGISTERS_A_SM}")
            if smem_total is not None and smem_total > ops.SMEM_LIMIT:
                fail(f"phase 16: {base_name}: {smem_total} bytes of shared memory > "
                     f"{ops.SMEM_LIMIT}")
            log("contract: " + json.dumps(row))
            rows.append(row)
        out[name] = rows
    return out


BH_KERNELS = ("pairwise_sq_dists", "bsp_search", "morton_encode", "attractive_ell",
              "bh_traverse")
FFT_KERNELS = ("pairwise_sq_dists", "bsp_search", "attractive_ell", "fft_spread",
               "fft_gather")


# Phase 17: the LM serving path at full width.  deepseek_7b: 30 layers,
# d_model 4 096, 32 heads of 128 (MHA), d_ff 11 008, vocab 102 400:
# 6.91 B parameters stored in float32 (27.6 GB), computed in bf16.
LM_ARCH = "deepseek_7b"
LM_DECODE = (2, 64)           # (a) batch x tokens: prefill against decode, float32
LM_LONG = 1300                # (b), (e) prompt: three chunks of 512, the last ragged
LM_SLOTS, LM_MAX_SEQ = 8, 512
# 9 requests: the ninth enters a slot the first to finish left (278
# ticks; 16 requests took 461, which the script's 1 200 s could not hold
# beside phases 22-23)
LM_REQUESTS, LM_NEW = 9, 64
LM_PROMPT = (64, 192)         # prompt lengths drawn from [64, 192]
LM_ALONE_RID = 8              # the first admitted after the first wave: into a slot another left
LM_PROFILE_AT = 100           # the served tick that opens the profiled window (8 slots busy)
LM_PROFILED_TICKS = 5
# bf16 keeps 8 significant bits (a rounding costs up to 2^-8 = 0.4%) and
# 30 layers compound them: each bf16 prefill path must lie within 5% of
# the logits' scale of the float32 model, and so must the two paths of
# each other.  A request served alone must give its pooled run's first
# logits to two bf16 epsilons of their scale (the slots' rows are computed
# apart, so any leak would show far above that).
LM_BF16_REL = 0.05
LM_ALONE_REL = 2 * 2.0**-7
# One layer's attention core, chunked against plain on the same bf16 q, k
# and v: both round their output to bf16 once (half an ulp each, and one
# ulp where the float32 values straddle a rounding), so each row of
# dh = 128 values must agree to two bf16 epsilons of the row's largest.
# The controls (causal mask dropped, the diagonal dropped, the padding of
# the ragged last chunk not masked) must each exceed that limit.
LM_ATTN_REL = 2 * 2.0**-7


@contextlib.contextmanager
def plain_attention_core():
    """Prefill through the plain attention core (``layers.attention``, the
    whole [S, S] score matrix) in place of ``chunked_attention``."""
    from repro_torch.models import attention, layers
    chunked = attention.chunked_attention
    attention.chunked_attention = lambda q, k, v, *, causal, chunk: layers.attention(
        q, k, v, causal=causal)
    try:
        yield
    finally:
        attention.chunked_attention = chunked


def serve_profiled(eng, what: str) -> tuple[list[float], list[float], dict]:
    """Step ``eng`` until its queue and slots are empty.  Returns the wall
    seconds of each served tick, those of the LM_PROFILED_TICKS ticks from
    the LM_PROFILE_AT-th on, which run under torch.profiler, and that
    window's kernel events: the host's share of a tick is the window's
    kernel time against the median of the other ticks."""
    ticks, window = [], []
    events: dict = {}
    while eng.queue or any(a is not None for a in eng.active):
        if len(ticks) == LM_PROFILE_AT and not window:
            def profiled():
                for _ in range(LM_PROFILED_TICKS):
                    t0 = time.perf_counter()
                    eng.step()
                    window.append(time.perf_counter() - t0)
            events = kernel_events(profiled)
            continue
        t0 = time.perf_counter()
        eng.step()          # ends in the argmax's read-back: the tick is done
        ticks.append(time.perf_counter() - t0)
    if len(window) != LM_PROFILED_TICKS:
        fail(f"{what}: the serving run ended before its profiled window ({len(ticks)} ticks)")
    return ticks, window, events


def capture_first_logits(eng, rid: int) -> dict:
    """Wrap ``eng``'s step function so that the returned dict gets request
    ``rid``'s logits (float32, on the card) from the tick that consumes its
    last prompt token: the logits of its first generated token."""
    step, got = eng._step, {}

    def spy(params, cache, tok, pos):
        logits, cache = step(params, cache, tok, pos)
        for s, req in enumerate(eng.active):
            if req is not None and req.rid == rid and pos[s] == len(req.prompt) - 1:
                got["logits"] = logits[s].float().clone()
        return logits, cache

    eng._step = spy
    return got


def lm_tick_bounds(n_params: int, cfg) -> dict:
    """The least time of one decode tick at LM_SLOTS x LM_MAX_SEQ on this
    card, by bytes (ms): the parameters as the reference computes them
    (read in float32, written and read again in bf16: 8 B each), as a
    held bf16 copy would (2 B each), and the whole cache read (k and v of
    every layer over every slot's capacity, bf16)."""
    cache = 2 * cfg.n_layers * LM_SLOTS * LM_MAX_SEQ * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    return dict(cast_ms=8 * n_params / PEAK_HBM_BYTES * 1e3,
                bf16_copy_ms=2 * n_params / PEAK_HBM_BYTES * 1e3,
                cache_ms=cache / PEAK_HBM_BYTES * 1e3,
                tick_bound_ms=(8 * n_params + cache) / PEAK_HBM_BYTES * 1e3)


def row_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest max |a - b| of a row of the last axis over that row's
    max |b| (attention outputs [B, S, H, dh]: a row is one query's head)."""
    a, b = a.float(), b.float()
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


def check_lm_attention(q, k, v, chunk: int) -> dict:
    """Phase 17 (e)'s check: ``chunked_attention`` against the plain core
    ``attention`` on the same q, k, v (bf16, S not a multiple of ``chunk``),
    causal and not, within LM_ATTN_REL of each row's scale; and three
    planted faults that the limit must catch.  Returns the errors."""
    import torch.nn.functional as F
    from repro_torch.models import layers
    s = q.shape[1]
    pos = torch.arange(s, device=q.device)
    plain = {c: layers.attention(q, k, v, causal=c) for c in (True, False)}
    errs = {f"causal={c}": row_rel_err(layers.chunked_attention(q, k, v, causal=c, chunk=chunk),
                                       plain[c]) for c in (True, False)}
    padded = [F.pad(t, (0, 0, 0, 0, 0, (-s) % chunk)) for t in (k, v)]
    controls = {
        "causal mask dropped": row_rel_err(
            layers.chunked_attention(q, k, v, causal=False, chunk=chunk), plain[True]),
        "diagonal dropped": row_rel_err(
            layers.attention(q, k, v, causal=False, mask=pos[None, :] < pos[:, None]),
            plain[True]),
        "ragged padding unmasked": row_rel_err(
            layers.chunked_attention(q, *padded, causal=False, chunk=chunk), plain[False]),
    }
    log(f"lm (e) chunked_attention against the plain core at S = {s}, bf16: max |d| over "
        f"each row's max {json.dumps(errs)} (limit {LM_ATTN_REL}); planted faults "
        f"{json.dumps(controls)} (each must exceed it)")
    if max(errs.values()) > LM_ATTN_REL:
        fail(f"lm (e): chunked_attention disagrees with the plain core: {errs}")
    if min(controls.values()) <= LM_ATTN_REL:
        fail(f"lm (e): the limit does not catch every planted fault: {controls}")
    return dict(errs, **{f"control: {n}": e for n, e in controls.items()})


def atlas_kernel_checks(run) -> dict:
    """Phase 17 (d)'s check: each kernel the LM atlas launched, against
    its plain twin on the atlas's own inputs, at phase 3's tolerances:
    pairwise on the fit's tile (x_fit against itself) and on the
    admissions' queries (one, and all held-out rows) against x_fit; bsp on
    the fit's KNN distances and on the admissions' query distances at the
    service's perplexity; Morton, attractive and the walk (bit for bit, by
    check_traverse) at the fitted embedding and graph.  Returns each
    kernel's largest error."""
    from repro_torch.core import attractive, bsp, knn, morton
    from repro_torch.kernels import ops
    est, dev = run.est, torch.device("cuda")
    # float32, as the estimator and the service cast them
    x_fit = torch.as_tensor(run.x_fit, dtype=torch.float32, device=dev)
    x_new = torch.as_tensor(run.x_new, dtype=torch.float32, device=dev)
    errs = dict(pairwise_sq_dists=max(
        check_pairwise("LM atlas, the fit's tile", x_fit, x_fit),
        check_pairwise("LM atlas, an admission's query", x_new[:1], x_fit),
        check_pairwise("LM atlas, every held-out query", x_new, x_fit)))
    k, perp = int(est.n_neighbors_), float(est.perplexity)
    _, d2 = knn.knn(x_fit, k, KNN_BLOCK_Q, KNN_BLOCK_DB)
    kq = int(est.query_k_)
    _, dq = est.query_index_.query(x_new, kq)
    eff = min(perp, max(1.0, 0.5 * kq))            # embed.transform.prepare_batch's
    errs["bsp_search"] = 0.0
    for what, dd, pp in ((f"LM atlas, the fit's [{d2.shape[0]}, {k}]", d2, perp),
                         (f"LM atlas, an admission's [1, {kq}]", dq[:1], eff),
                         (f"LM atlas, the admissions' [{dq.shape[0]}, {kq}]", dq, eff)):
        p_k, b_k = ops.bsp_search(dd, pp)
        p_p, b_p = bsp.binary_search_perplexity_plain(dd, pp)
        check_bsp(what, p_k, b_k, p_p, b_p)
        errs["bsp_search"] = max(errs["bsp_search"], float((p_k - p_p).abs().max()))
    y = torch.as_tensor(est.embedding_, device=dev)
    cent, r_span = morton.span_radius(y)
    if not torch.equal(ops.morton_encode(y, cent, r_span), morton.morton_encode(y, cent, r_span)):
        fail("morton_encode is not bit-identical to its plain version at the LM atlas")
    errs["morton_encode"] = 0.0
    g = est.neighbor_graph_
    cols, vals, p_len = (t.to(dev) for t in (g.p_cols, g.p_vals, g.p_len))
    f_k, kl_k = ops.attractive_ell(y, cols, vals, p_len)
    f_p, kl_p = attractive.attractive_forces_ell(y, cols, vals, p_len)
    if not (torch.allclose(f_k, f_p, rtol=1e-4, atol=1e-5 * float(f_p.abs().max()))
            and abs(float(kl_k) - float(kl_p)) <= 1e-5 * abs(float(kl_p))):
        fail("attractive_ell disagrees with its plain version at the LM atlas's graph")
    errs["attractive_ell"] = float((f_k - f_p).abs().max())
    check_traverse("LM atlas, the fitted embedding", y)
    errs["bh_traverse"] = 0.0
    log(f"lm (d) the atlas's kernels against their plain twins on its inputs (x_fit "
        f"{list(x_fit.shape)}, W {cols.shape[1]}, nnz {int(p_len.sum())}): max_abs_err "
        + json.dumps(errs) + " (Morton and the walk bit for bit)")
    return errs


def phase_lm(smi: str) -> dict:
    """Phase 17: the LM serving path; see the module docstring.  Returns
    its summary, the atlas's launch counts among them."""
    import dataclasses

    import torch.nn.functional as F
    from repro_torch.configs import get_config, param_count
    from repro_torch.examples import lm_embedding_atlas
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    m16 = build_model(cfg)
    m32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
    dev = m16.device
    params, init_s = synced_seconds(lambda: m16.init(torch.Generator(dev).manual_seed(0)))
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != param_count(cfg)[0] + (2 * cfg.n_layers + 1) * cfg.d_model:
        fail(f"lm: {n_params} parameters, param_count says {param_count(cfg)[0]} + norms")
    out = dict(arch=LM_ARCH, n_params=n_params, init_s=init_s,
               bounds=lm_tick_bounds(n_params, cfg))
    log(f"lm (phase 17): {LM_ARCH} at full width, {n_params} parameters "
        f"({n_params * 4 / 2**30:.2f} GiB in float32) initialised in {init_s:.2f} s; {smi}")
    gen = torch.Generator(dev).manual_seed(1)
    vocab = cfg.vocab_size

    # (a) decode against prefill in float32
    b, s = LM_DECODE
    tokens = torch.randint(0, vocab, (b, s), generator=gen, device=dev)
    want = m32.prefill(params, {"tokens": tokens})
    cache = m32.init_cache(b, s)
    t0 = time.perf_counter()
    for t in range(s):
        logits, cache = m32.decode_step(params, cache, tokens[:, t],
                                        torch.full((b,), t, device=dev))
    torch.cuda.synchronize()
    out["f32_decode_ms"] = (time.perf_counter() - t0) / s * 1e3
    err = float((logits - want).abs().max())
    same = torch.equal(logits.argmax(-1), want.argmax(-1))
    log(f"lm (a) float32, {b} x {s} tokens: decode's last logits against prefill's max "
        f"|d| {err:.3e} (scale {float(want.abs().max()):.3f}; rtol 1e-3, atol 1e-4), "
        f"argmax equal {same}, {out['f32_decode_ms']:.2f} ms a float32 decode step")
    if not torch.allclose(logits, want, rtol=1e-3, atol=1e-4) or not same:
        fail("lm (a): float32 decode does not reproduce prefill's last logits")
    out["f32_decode_vs_prefill"] = err
    del cache, logits, want

    # (b) chunked against plain attention, bf16, against the float32 model
    long = torch.randint(0, vocab, (1, LM_LONG), generator=gen, device=dev)
    chunked = m16.prefill(params, {"tokens": long}).float()
    with plain_attention_core():
        plain = m16.prefill(params, {"tokens": long}).float()
    ref = m32.prefill(params, {"tokens": long})
    scale = float(ref.abs().max())
    errs = dict(chunked_plain=float((chunked - plain).abs().max()),
                chunked_f32=float((chunked - ref).abs().max()),
                plain_f32=float((plain - ref).abs().max()))
    out["prefill_ms"] = cuda_ms(lambda: m16.prefill(params, {"tokens": long}), reps=3, inner=1)
    log(f"lm (b) bf16 prefill of {LM_LONG} tokens: max |d| " + json.dumps(errs)
        + f" against {LM_BF16_REL} x scale {scale:.3f}; argmax chunked == plain "
        f"{bool(chunked.argmax() == plain.argmax())}; prefill {out['prefill_ms']:.3f} ms")
    if max(errs.values()) > LM_BF16_REL * scale:
        fail(f"lm (b): chunked and plain attention disagree beyond bf16's reach: {errs}")
    out["prefill_errs"] = errs
    del chunked, plain, ref

    # (c) serving in bf16: LM_REQUESTS requests through 8 slots
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, int(n)).tolist()
               for n in rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)]
    eng = ServeEngine(m16, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ, params=params)
    pooled_first = capture_first_logits(eng, LM_ALONE_RID)
    for r, prompt in enumerate(prompts):
        eng.submit(Request(rid=r, prompt=prompt, max_new_tokens=LM_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ticks, window, events = serve_profiled(eng, "lm (c)")
    serve_s = sum(ticks) + sum(window)
    peak = torch.cuda.max_memory_allocated() / 2**30
    done = sorted(eng.completed, key=lambda r: r.rid)
    if len(done) != LM_REQUESTS or any(
            len(r.generated) != LM_NEW or not all(0 <= t < vocab for t in r.generated)
            for r in done):
        fail(f"lm (c): {len(done)} of {LM_REQUESTS} requests completed, not all with "
             f"{LM_NEW} tokens inside the vocabulary")
    generated = sum(len(r.generated) for r in done)
    by_kernel = {k: sum(v) for k, v in events.items()}
    busy_s = sum(by_kernel.values()) * 1e-6
    # the same request alone: its first generated token's logits
    alone = ServeEngine(m16, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ, params=params)
    alone_first = capture_first_logits(alone, LM_ALONE_RID)
    alone.submit(Request(rid=LM_ALONE_RID, prompt=prompts[LM_ALONE_RID], max_new_tokens=1))
    alone.run()
    a, p = alone_first["logits"], pooled_first["logits"]
    alone_err = float((a - p).abs().max())
    tick_ms = float(np.median(ticks)) * 1e3
    n_ticks = len(ticks) + len(window)
    out.update(
        requests=LM_REQUESTS, ticks=n_ticks, generated=generated,
        prompt_tokens=sum(map(len, prompts)), serve_s=serve_s, tick_ms_median=tick_ms,
        tick_ms_p10_p90=[float(np.percentile(ticks, q)) * 1e3 for q in (10, 90)],
        profiled_tick_ms_median=float(np.median(window)) * 1e3,
        generated_tokens_per_s=generated / serve_s,
        all_tokens_per_s=(generated + sum(map(len, prompts))) / serve_s,
        device_busy_ms_a_tick=busy_s / LM_PROFILED_TICKS * 1e3 if busy_s > 0 else None,
        kernels_a_tick=sum(map(len, events.values())) / LM_PROFILED_TICKS,
        host_share=1 - busy_s / LM_PROFILED_TICKS / (tick_ms * 1e-3) if busy_s > 0 else None,
        peak_gib=peak, alone_vs_pooled=alone_err,
        alone_first_token_equal=alone.completed[0].generated[0] == done[LM_ALONE_RID].generated[0],
        serve_stats=eng.stats())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"lm (c) tick device time by kernel (ms, over served ticks {LM_PROFILE_AT}-"
        f"{LM_PROFILE_AT + LM_PROFILED_TICKS - 1}, profiled: median "
        f"{out['profiled_tick_ms_median']:.3f} ms a tick; "
        f"{out['kernels_a_tick']:.1f} kernel launches a tick): "
        + json.dumps({k[:70]: v * 1e-3 for k, v in top}))
    log(f"lm (c) serving, {LM_SLOTS} slots x {LM_MAX_SEQ}: {generated} tokens generated "
        f"({out['prompt_tokens']} prompt tokens fed by decode) in {n_ticks} ticks, "
        f"{serve_s:.3f} s")
    log(f"lm (c) decode tick: median {tick_ms:.3f} ms (p10 / p90 "
        f"{out['tick_ms_p10_p90'][0]:.3f} / {out['tick_ms_p10_p90'][1]:.3f}; the "
        f"{len(ticks)} ticks outside the profiled window); bound "
        f"{out['bounds']['tick_bound_ms']:.3f} ms (bytes) = cast {out['bounds']['cast_ms']:.3f} "
        f"+ cache {out['bounds']['cache_ms']:.3f}; with a held bf16 copy "
        f"{out['bounds']['bf16_copy_ms']:.3f} + cache")
    log(f"lm (c) generated tokens/s {out['generated_tokens_per_s']:.2f}, all tokens/s "
        f"{out['all_tokens_per_s']:.2f}; host share of a tick "
        + ("not measured (the profiler recorded no kernel)" if busy_s <= 0 else
           f"{out['host_share']:.4f} (device {out['device_busy_ms_a_tick']:.3f} ms a tick)")
        + f"; peak device memory {peak:.2f} GiB; {smi}")
    log(f"lm (c) request {LM_ALONE_RID} alone against pooled: first logits max |d| "
        f"{alone_err:.3e} (limit {LM_ALONE_REL} x {float(p.abs().max()):.3f}), first token "
        f"equal {out['alone_first_token_equal']}")
    log("lm (c) serve.* snapshot: " + json.dumps(out["serve_stats"]))
    if alone_err > LM_ALONE_REL * float(p.abs().max()):
        fail(f"lm (c): request {LM_ALONE_RID} alone and pooled disagree: {alone_err:.3e}")
    snap = out["serve_stats"]
    if (snap["serve.completed"], snap["serve.tokens"], snap["serve.ticks"]) != \
            (LM_REQUESTS, generated, n_ticks):
        fail(f"lm (c): the serve.* counters disagree with the run: {snap}")
    # phase 24 holds its counted argument bytes to what the tick's operands hold
    out["tick_held_bytes"] = (
        sum(t.nbytes for t in params.parameters())
        + sum(t.nbytes for t in tree_leaves(eng.cache) if isinstance(t, torch.Tensor))
        + eng.next_token.nbytes + eng.pos.nbytes)
    del eng, alone, params          # the spies close over their engines: collect the cycles
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the LM atlas at its defaults: the reduced model's states through the t-SNE kernels
    BUILD.mkdir(exist_ok=True)
    ops.reset_launch_counts()
    run, atlas_s = synced_seconds(
        lambda: lm_embedding_atlas.main(["--out", str(BUILD / "lm_atlas.npy")]))
    launches = dict(ops.LAUNCHES)
    out.update(atlas_launches=launches, atlas_s=atlas_s, atlas_fit_s=run.fit_s,
               atlas=dict(kl=run.kl, intra=run.intra, inter=run.inter,
                          intra_grown=run.intra_new, inter_grown=run.inter_new,
                          p50_s=run.service["latency_s_p50"]))
    log(f"lm (d) atlas: {atlas_s:.3f} s (fit {run.fit_s:.3f} s); " + json.dumps(out["atlas"])
        + f"; launches {json.dumps(launches)}")
    if run.service["completed"] != run.n_grow or not np.isfinite(run.kl) \
            or not np.isfinite(run.y).all():
        fail("lm (d): the atlas's growth did not complete or its KL is not finite")
    missing = [k for k in BH_KERNELS if launches[k] <= 0]
    if missing:
        fail(f"lm (d): the atlas never launched {missing}")
    out["atlas_max_abs_err"] = atlas_kernel_checks(run)
    del run

    # (e) the library yardstick: SDPA beside the port's chunked core (not on the path)
    q, k, v = (torch.randn(1, LM_LONG, cfg.n_heads, cfg.resolved_head_dim, generator=gen,
                           device=dev, dtype=torch.bfloat16) for _ in range(3))
    out["attention_errs"] = check_lm_attention(q, k, v, cfg.attn_chunk)
    port = layers.chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    lib = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in (q, k, v)),
                                         is_causal=True).transpose(1, 2)
    out["attention_ms"] = cuda_ms(
        lambda: layers.chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk))
    out["sdpa_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in (q, k, v)), is_causal=True))
    log(f"lm (e) one layer's attention core at B = 1, S = {LM_LONG}, H = {cfg.n_heads}, "
        f"dh = {cfg.resolved_head_dim}, bf16: chunked_attention {out['attention_ms']:.4f} ms, "
        f"SDPA (is_causal) {out['sdpa_ms']:.4f} ms (max |d| "
        f"{float((port.float() - lib.float()).abs().max()):.3e}); {smi}")
    out["phase_s"] = time.perf_counter() - t_phase
    log("lm (phase 17): " + json.dumps(out))
    return out


# Phase 18: the LM training path at full width.  phi4_mini_3p8b: 32
# layers, d_model 3 072, 24 query heads over 8 KV heads of 128, d_ff 8 192,
# vocab 200 064, tied embeddings: 3 835 822 080 parameters in float32, with
# the reference's own memory options (bf16 moments, the factored second
# moment, 4 microbatches).  Cuts: train_4k's global batch 256 -> 4 and
# 4 steps (cut from 6 for the script's time); widths, depth and the
# 4 096-token sequence are not cut.
TRAIN_ARCH = "phi4_mini_3p8b"
TRAIN_OPTIONS = dict(optimizer_dtype="bfloat16", optimizer_factored=True, grad_accum=4)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 4
# (a) one layer's attention at the training shape
TRAIN_ATTN = dict(b=1, s=4096, h=24, hkv=8, dh=128, chunk=512)
# Each gradient of the custom backward against float64 autograd through
# the plain core, relative to the gradient's scale: float32 sums 4 096
# terms a row in other orders (1e-4 leaves a wide margin over its ~1e-6);
# bf16 rounds each gradient once (dk, dv per chunk) and its delta reads
# the bf16 forward output: two bf16 epsilons.  Each planted fault must
# exceed the limit on at least one gradient.
TRAIN_ATTN_REL = {"float32": 1e-4, "bfloat16": 2 * 2.0**-7}
# (c) the restart drill at examples/train_lm.py's defaults
DRILL_BATCH, DRILL_SEQ, DRILL_STEPS, DRILL_CKPT, DRILL_FAIL = 8, 256, 8, 2, 5


def attention64(q, k, v, causal: bool = True):
    """Plain softmax attention in float64 (GQA by repeating K and V), the
    reference the custom backward is held against."""
    from repro_torch.models.layers import _repeat_kv
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    s = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def grad_rel_errs(got, want) -> dict:
    """max |got - want| over max |want|, for each of dq, dk, dv."""
    return {n: float((g.double() - w).abs().max() / w.abs().max())
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}


def check_train_attention(dtype: torch.dtype, gen) -> dict:
    """Phase 18 (a) in one dtype: the port's dq, dk, dv at the training
    shape against float64 autograd, three planted faults, and the forward
    + backward timed beside SDPA's (on K and V repeated to the query
    heads: the same GQA arithmetic)."""
    import torch.nn.functional as F
    from repro_torch.models import layers
    a = TRAIN_ATTN
    dev, name = torch.device("cuda"), str(dtype).split(".")[1]
    q = torch.randn(a["b"], a["s"], a["h"], a["dh"], generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(a["b"], a["s"], a["hkv"], a["dh"], generator=gen, device=dev).to(dtype)
            for _ in range(2))
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = layers.chunked_attention(*leaves, causal=True, chunk=a["chunk"])
    got = torch.autograd.grad(out, leaves, dout)
    ref_in = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention64(*ref_in), ref_in, dout.double())
    del ref_in
    errs = grad_rel_errs(got, want)
    out_d, lse = layers._fa_forward(q, k, v, True, a["chunk"])
    n_rep = a["h"] // a["hkv"]
    rep = [layers._repeat_kv(t, n_rep) for t in (k, v)]
    _, dk_h, dv_h = layers._fa_backward(q, *rep, out_d, lse, dout, True, a["chunk"])
    faults = {
        "delta dropped": grad_rel_errs(layers._fa_backward(
            q, k, v, torch.zeros_like(out_d), lse, dout, True, a["chunk"]), want),
        "GQA group sum dropped": grad_rel_errs(
            (got[0], dk_h[:, :, ::n_rep], dv_h[:, :, ::n_rep]), want),
        "scale missing": grad_rel_errs(
            (got[0].double() * a["dh"] ** 0.5, got[1].double() * a["dh"] ** 0.5, got[2]), want),
    }
    del want, dk_h, dv_h, rep
    limit = TRAIN_ATTN_REL[name]
    log(f"train (a) {name}: custom backward against float64 autograd, each gradient's "
        f"max |d| over its max: {json.dumps(errs)} (limit {limit}); planted faults "
        + json.dumps({f: max(e.values()) for f, e in faults.items()}) + " (each must exceed it)")
    if max(errs.values()) > limit:
        fail(f"train (a): the {name} attention backward disagrees with float64 autograd: {errs}")
    caught = {f: max(e.values()) > limit for f, e in faults.items()}
    if not all(caught.values()):
        fail(f"train (a): the {name} limit misses a planted fault: {faults}")

    def port():
        o = layers.chunked_attention(*leaves, causal=True, chunk=a["chunk"])
        torch.autograd.grad(o, leaves, dout)

    sdpa_in = [t.detach().requires_grad_(True) for t in (q, k, v)]

    def sdpa():
        kr, vr = (layers._repeat_kv(t, n_rep) for t in sdpa_in[1:])
        o = F.scaled_dot_product_attention(sdpa_in[0].transpose(1, 2), kr.transpose(1, 2),
                                           vr.transpose(1, 2), is_causal=True)
        torch.autograd.grad(o, sdpa_in, dout.transpose(1, 2))

    ms, sdpa_ms = cuda_ms(port, reps=3, inner=1), cuda_ms(sdpa, reps=3, inner=1)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: layers.chunked_attention(q, k, v, causal=True,
                                                          chunk=a["chunk"]), reps=3, inner=1)
    # least work: a causal forward (2 products) and backward (5, the scores
    # recomputed) over the S^2/2 pairs; the port computes every chunk of
    # the square (masked or not)
    pairs = a["b"] * a["h"] * a["s"] * a["s"]
    flops = 7 * 2 * pairs * a["dh"] / 2
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    bound_ms = bound(flops, nbytes, peak)[0]
    log(f"train (a) {name} forward + backward at B 1, S {a['s']}, H {a['h']} / {a['hkv']}, "
        f"dh {a['dh']}: chunked_attention {ms:.3f} ms (its forward alone {fwd_ms:.3f}), SDPA "
        f"{sdpa_ms:.3f} ms (the library yardstick, not on the path); bound {bound_ms:.3f} ms "
        f"({flops / 1e12:.3f} TFLOP causal at {peak / 1e12:.0f} TFLOP/s)")
    return dict(errs=errs, faults=faults, ms=ms, fwd_ms=fwd_ms, sdpa_ms=sdpa_ms,
                bound_ms=bound_ms)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def phase_train(smi: str) -> dict:
    """Phase 18: the LM training path; see the module docstring."""
    import dataclasses

    from repro_torch.configs import get_config, param_count
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.fault import run_with_restarts
    from repro_torch.examples.train_lm import lm100m_config
    from repro_torch.models.model import build_model
    from repro_torch.train import step as step_mod
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2)
    out = {"attention": {n: check_train_attention(dt, gen)
                         for n, dt in (("float32", torch.float32),
                                       ("bfloat16", torch.bfloat16))}}
    gc.collect()
    torch.cuda.empty_cache()

    # (b) phi4_mini_3p8b at full width through Trainer.run
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), **TRAIN_OPTIONS)
    model = build_model(cfg)
    m32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
    pipe = TokenPipeline(cfg.vocab_size, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0)
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        trainer = Trainer(model, pipe, TrainerConfig(
            n_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS, ckpt_dir=str(ckpt_dir), log_every=1))
        first, opt_events, saves = {}, [], []
        init_state, update, save = trainer.init_state, step_mod.adamw_update, trainer.ckpt.save

        def init_and_loss_apart(seed):
            """The run's initial state, and loss_fn apart on it at step 0's
            microbatches (bf16, and the float32-compute model)."""
            state, first["init_s"] = synced_seconds(lambda: init_state(seed))
            tokens = torch.as_tensor(pipe.batch(0)["tokens"], device=dev)
            micro = tokens.reshape(cfg.grad_accum, TRAIN_BATCH // cfg.grad_accum, -1)
            with torch.no_grad():
                first["bf16"] = torch.mean(torch.stack(
                    [model.loss_fn(state[0], {"tokens": mb})[0] for mb in micro]))
                first["f32"] = torch.mean(torch.stack(
                    [m32.loss_fn(state[0], {"tokens": mb})[0] for mb in micro]))
            return state

        def timed_update(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            res = update(*args, **kw)
            ev[1].record()
            opt_events.append(ev)
            return res

        def timed_save(step, tree, blocking=False):
            t0 = time.perf_counter()
            save(step, tree, blocking)
            saves.append((t0, time.perf_counter()))

        trainer.init_state = init_and_loss_apart
        step_mod.adamw_update = timed_update
        trainer.ckpt.save = timed_save
        torch.cuda.reset_peak_memory_stats()
        walls = []
        try:
            (params, opt_state, steps), run_s = synced_seconds(lambda: trainer.run(
                seed=0, callback=lambda s, m: walls.append(m["wall_s"])))
        finally:
            step_mod.adamw_update = update
        t_end = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() / 2**30
        ckpt_bytes = sum(p.stat().st_size for p in ckpt_dir.rglob("*") if p.is_file())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != param_count(cfg)[0] + (2 * cfg.n_layers + 1) * cfg.d_model:
        fail(f"train (b): {n_params} parameters, param_count says {param_count(cfg)[0]} + norms")
    # phase 24 holds its counted argument bytes to what the step's operands hold
    held_bytes = (sum(p.nbytes for p in params.parameters())
                  + sum(t.nbytes for t in tree_leaves((opt_state.m, opt_state.v)))
                  + pipe.batch(0)["tokens"].nbytes)
    losses = [m["loss_mean"] for m in trainer.metrics_log]
    step_ms = [1e3 * (b - a) for a, b in zip([0.0] + walls[:-1], walls)]
    opt_ms = [a.elapsed_time(b) for a, b in opt_events]
    tokens_step = TRAIN_BATCH * TRAIN_SEQ
    steady = float(np.median(step_ms[1:]))
    loss16, loss32 = float(first["bf16"]), float(first["f32"])
    out["phi4"] = dict(
        arch=TRAIN_ARCH, n_params=n_params, options=TRAIN_OPTIONS, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=steps, init_s=first["init_s"], run_s=run_s, losses=losses,
        step_ms=step_ms, step_ms_median_after_first=steady,
        tokens_per_s=tokens_step / (steady * 1e-3), optimizer_ms=opt_ms, peak_gib=peak,
        ckpt_snapshot_s=saves[0][1] - saves[0][0], ckpt_total_s=t_end - saves[0][0],
        ckpt_gb=ckpt_bytes / 1e9, first_loss_apart=loss16, first_loss_f32=loss32,
        model_tflop_a_step=6 * n_params * tokens_step / 1e12, step_held_bytes=held_bytes)
    log(f"train (b) {TRAIN_ARCH} at full width ({n_params} parameters, {json.dumps(TRAIN_OPTIONS)}"
        f", batch {TRAIN_BATCH} x {TRAIN_SEQ}): losses {json.dumps(losses)}; ms a step "
        f"{json.dumps([round(x, 1) for x in step_ms])} (median after the first {steady:.1f}: "
        f"{out['phi4']['tokens_per_s']:.1f} tokens/s); optimizer update ms "
        f"{json.dumps([round(x, 2) for x in opt_ms])}; peak {peak:.2f} GiB; checkpoint "
        f"{ckpt_bytes / 1e9:.2f} GB, snapshot {out['phi4']['ckpt_snapshot_s']:.2f} s, written "
        f"{out['phi4']['ckpt_total_s']:.2f} s after the save began; {smi}")
    log(f"train (b) first loss {losses[0]!r} against loss_fn apart {loss16!r} (bit for bit) "
        f"and the float32-compute model's {loss32!r} (|d| {abs(loss16 - loss32):.4g}, limit "
        f"{LM_BF16_REL} x {abs(loss32):.4g})")
    if steps != TRAIN_STEPS or len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        fail(f"train (b): {steps} steps, losses {losses}")
    if losses[0] != loss16:
        fail(f"train (b): the first step's loss {losses[0]!r} is not loss_fn's {loss16!r}")
    if abs(loss16 - loss32) > LM_BF16_REL * abs(loss32):
        fail(f"train (b): the bf16 loss {loss16} is far from the float32 model's {loss32}")
    if len(saves) != 1 or ckpt_bytes <= 0:
        fail(f"train (b): {len(saves)} checkpoint saves, {ckpt_bytes} bytes")
    # one microbatch's forward and backward at the trained parameters:
    # its wall, and its kernel time by name from a second, profiled call
    micro = {"tokens": torch.as_tensor(pipe.batch(0)["tokens"][:1], device=dev)}

    def one_micro():
        loss, _ = model.loss_fn(params, micro)
        torch.autograd.grad(loss, tree_leaves(params.reference_tree()))

    one_micro()
    _, micro_s = synced_seconds(one_micro)
    busy_s, by_kernel = device_busy(one_micro)
    by_name: dict[str, float] = {}          # names cut to 100 characters, summed
    for k, v in by_kernel.items():
        by_name[k[:100]] = by_name.get(k[:100], 0.0) + v * 1e-3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out["phi4"].update(micro_s=micro_s, micro_busy_s=busy_s, micro_top_kernels_ms=dict(top))
    log(f"train (b) one microbatch (1 x {TRAIN_SEQ}) forward + backward: {micro_s * 1e3:.1f} ms "
        f"wall, {busy_s * 1e3:.1f} ms of kernels (device idle "
        + (f"{1 - busy_s / micro_s:.3f}" if busy_s > 0 else "not measured: no kernel event")
        + "); kernel ms by name: " + json.dumps(out["phi4"]["micro_top_kernels_ms"]))
    del params, opt_state, trainer, model, m32, first
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the restart drill on the card
    dcfg = lm100m_config()
    dmodel = build_model(dcfg)
    dpipe = TokenPipeline(dcfg.vocab_size, DRILL_BATCH, DRILL_SEQ, seed=0)
    dopt = AdamWConfig(warmup_steps=min(100, DRILL_STEPS // 3))
    drill_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_drill_"))

    def make(path, fail_at=None):
        return Trainer(dmodel, dpipe, TrainerConfig(
            n_steps=DRILL_STEPS, ckpt_every=DRILL_CKPT, ckpt_dir=str(path), log_every=100,
            fail_at_step=fail_at), dopt)

    try:
        (clean, clean_state, _), clean_s = synced_seconds(
            lambda: make(drill_dir / "clean").run(seed=0))
        calls = []

        def supervisor():
            calls.append(len(calls))
            return make(drill_dir / "fault", DRILL_FAIL if len(calls) == 1 else None)

        (params, state, steps, failures), fault_s = synced_seconds(
            lambda: run_with_restarts(supervisor, seed=0))
    finally:
        shutil.rmtree(drill_dir, ignore_errors=True)
    differ = [n for (n, a), b in zip(clean.named_parameters(), params.parameters())
              if not same_bits(a, b)]
    differ += [f"opt leaf {i}" for i, (a, b) in enumerate(zip(
        tree_leaves((clean_state.m, clean_state.v)), tree_leaves((state.m, state.v))))
        if not same_bits(a, b)]
    out["drill"] = dict(params=sum(p.numel() for p in params.parameters()), steps=steps,
                        failures=failures, clean_s=clean_s, restarted_s=fault_s,
                        differing_leaves=differ)
    log(f"train (c) restart drill, {dcfg.n_layers}L x {dcfg.d_model} "
        f"({out['drill']['params']} parameters), batch {DRILL_BATCH} x {DRILL_SEQ}: "
        f"{steps} steps, {failures} failure at step {DRILL_FAIL} resumed from step "
        f"{DRILL_FAIL - DRILL_FAIL % DRILL_CKPT}; clean {clean_s:.2f} s, restarted {fault_s:.2f} s;"
        f" leaves that differ from the uninterrupted run: {differ or 'none'}")
    if steps != DRILL_STEPS or failures != 1 or differ:
        fail(f"train (c): the resumed run is not bit-identical to the clean one: {differ}")
    del clean, params, clean_state, state, dmodel
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the two entry points as a user runs them, from a scratch directory
    runs = {}
    for name, argv, last in (
            ("launch.train", ["-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH,
                              "--reduced", "--steps", "4"], "step 4 loss"),
            ("examples.train_lm", ["-m", "repro_torch.examples.train_lm", "--steps", "10"],
             "step    10  loss")):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as cwd:
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                                  capture_output=True, text=True, timeout=600)
            secs = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(last)]
        loss = float(lines[-1].split("loss")[1].split()[0]) if lines else float("nan")
        runs[name] = dict(rc=proc.returncode, seconds=secs, last_loss=loss)
        log(f"train (d) python {' '.join(argv)}: rc {proc.returncode}, {secs:.1f} s, "
            f"'{lines[-1] if lines else proc.stdout[-300:]}'")
        if proc.returncode != 0 or not np.isfinite(loss):
            fail(f"train (d): {name} failed: {proc.stderr[-2000:]}")
    out["entry_points"] = runs
    out["phase_s"] = time.perf_counter() - t_phase
    log("train (phase 18): " + json.dumps(out))
    return out


# Phase 19: the MoE family.  deepseek_v2_lite_16b: 27 layers (the first
# dense, d_ff 10 944; 26 MoE layers of 64 experts top-6 with d_ff 1 408
# and 2 shared), d_model 2 048, 16 heads of MLA (kv_lora 512, rope 64,
# nope 128, v 128), vocab 102 400: 15 706 357 760 parameters by
# param_count.  (a) float32 storage and compute (58.5 GiB) at
# capacity_factor 64, the reference's own decode-against-prefill setting;
# (b) bf16 storage and compute at the published capacity_factor 1.25;
# (c) float32 storage, bf16 compute, depth cut 27 -> 4.
MOE_ARCH = "deepseek_v2_lite_16b"
MOE_DECODE = (2, 64)          # (a) batch x tokens: prefill against decode, float32
MOE_SLOTS, MOE_MAX_SEQ = 8, 512
MOE_REQUESTS, MOE_NEW = 8, 64    # one wave (236 ticks; 16 took 461, too long beside 22-23)
MOE_PROMPT = (64, 192)        # prompt lengths drawn from [64, 192]
MOE_TRAIN_LAYERS = 4          # (c): one dense layer, three MoE layers
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 4, 1024, 4
MOE_V3_ARCH = "deepseek_v3_671b"
MOE_V3_BATCH = 8              # the reduced v3's grad_accum is 8
MOE_TIE_ROWS = 4096           # (e): the training step's t = 4 x 1 024 rows


def moe_tick_bounds(n_params: int, cfg) -> dict:
    """The least time of one MoE decode tick at MOE_SLOTS x MOE_MAX_SEQ on
    this card, by bytes (ms): every parameter read once in bf16 (the
    reference's routed FFN runs each expert over its capacity, so every
    expert's weights are read every tick), and the latent cache read
    (ckv and krope of every layer over every slot's capacity, bf16).
    Beside it the latent cache's bytes and those of a per-head KV cache of
    the same shape (K of qk_nope + qk_rope, V of v_head_dim, per head)."""
    m = cfg.mla
    rows = cfg.n_layers * MOE_SLOTS * MOE_MAX_SEQ
    latent = rows * (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    per_head = rows * cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim) * 2
    return dict(params_ms=2 * n_params / PEAK_HBM_BYTES * 1e3,
                cache_ms=latent / PEAK_HBM_BYTES * 1e3,
                tick_bound_ms=(2 * n_params + latent) / PEAK_HBM_BYTES * 1e3,
                latent_cache_bytes=latent, per_head_cache_bytes=per_head)


def moe_config(cfg, **kw):
    """``cfg`` with ``kw`` replaced; a ``capacity_factor`` goes into its
    MoE config."""
    import dataclasses
    cf = kw.pop("capacity_factor", None)
    cfg = dataclasses.replace(cfg, **kw)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def check_moe_ties(gen) -> dict:
    """Phase 19 (e): tie order on the card.  At full width (64 experts,
    top-6) on MOE_TIE_ROWS rows made of 585 distinct rows repeated 7 or 8
    times (interleaved), so that equal rows carry bit-equal router
    probabilities and gates by construction (the CPU routes the distinct
    rows once); the rows lie near one direction, so that some experts are
    over-full and at least one capacity cut falls inside a group of equal
    gates (the phase fails otherwise): the top-6 over experts and every
    expert's capacity selection, each on the card and on the CPU from the
    same tensors,
    must be equal index for index (the ties broken by index, as
    lax.top_k does), and the routed FFN's outputs within 1e-4 of their
    scale.  Prints how many experts are over-full with the capacity's
    boundary inside a group of equal gates, and on how many experts the
    tie-blind torch.topk would select other tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(MOE_ARCH)
    m, d, f = cfg.moe, cfg.d_model, cfg.moe.expert_d_ff
    cpu = torch.Generator().manual_seed(int(torch.randint(0, 2**31, (1,), generator=gen,
                                                          device=gen.device)))
    distinct = MOE_TIE_ROWS // 7
    # rows near one direction route alike: their top experts are over-full
    # and cut at capacity inside groups of equal gates
    xb = torch.randn(1, d, generator=cpu) + 0.3 * torch.randn(distinct, d, generator=cpu)
    perm = torch.randperm(MOE_TIE_ROWS, generator=cpu) % distinct
    w = torch.randn(d, m.n_experts, generator=cpu) * d**-0.5
    weights, idx_b, probs_b = moe._route(xb, w, torch.zeros(m.n_experts), cfg)
    gate_b = moe._gate_matrix(weights, idx_b, 0, m.n_experts)
    x, probs, gate = xb[perm], probs_b[perm], gate_b[perm]
    ws = [torch.randn(m.n_experts, a, b, generator=cpu) * a**-0.5
          for a, b in ((d, f), (d, f), (f, d))]
    capacity = max(1, int(MOE_TIE_ROWS * m.top_k / m.n_experts * m.capacity_factor))
    got = {}
    for where in ("cuda", "cpu"):
        got[where] = dict(
            idx=moe.top_k(probs.to(where), m.top_k)[1].cpu(),
            sel=moe.top_k(gate.T.to(where), capacity)[1].cpu(),
            y=moe._routed_ffn_local(x.to(where), gate.to(where), *(t.to(where) for t in ws),
                                    capacity).cpu())
    vals = torch.sort(gate.T, dim=-1, descending=True).values
    full = (vals[:, capacity] > 0)
    boundary_ties = int((full & (vals[:, capacity - 1] == vals[:, capacity])).sum())
    blind = torch.topk(gate.T.cuda(), capacity).indices.cpu()
    res = dict(rows=MOE_TIE_ROWS, distinct=distinct, capacity=capacity,
               over_full_experts=int(full.sum()), boundary_ties=boundary_ties,
               route_equal=torch.equal(got["cuda"]["idx"], got["cpu"]["idx"]),
               selection_equal=torch.equal(got["cuda"]["sel"], got["cpu"]["sel"]),
               topk_differs_on_experts=int((torch.sort(blind, -1).values != torch.sort(
                   got["cuda"]["sel"], -1).values).any(-1).sum()),
               y_max_abs_err=float((got["cuda"]["y"] - got["cpu"]["y"]).abs().max()),
               y_scale=float(got["cpu"]["y"].abs().max()))
    log(f"moe (e) planted ties, {MOE_TIE_ROWS} rows ({distinct} distinct, 7 or 8 copies each), "
        f"capacity {capacity}: {res['over_full_experts']} of {m.n_experts} experts over-full, "
        f"{boundary_ties} with the capacity's boundary inside equal gates; top-{m.top_k} over "
        f"experts equal card vs CPU {res['route_equal']}, capacity selection equal "
        f"{res['selection_equal']}; torch.topk's selection would differ on "
        f"{res['topk_differs_on_experts']} experts; routed FFN max |d| "
        f"{res['y_max_abs_err']:.3e} (scale {res['y_scale']:.3f}, limit 1e-4 x scale)")
    if boundary_ties == 0:
        fail("moe (e): no expert's capacity boundary falls inside a group of equal gates")
    if not (res["route_equal"] and res["selection_equal"]):
        fail("moe (e): the card selects other tokens than the CPU on planted ties")
    if res["y_max_abs_err"] > 1e-4 * res["y_scale"]:
        fail("moe (e): the routed FFN on the card disagrees with the CPU's")
    return res


def run_trainer_apart(model, pipe, n_steps: int, label: str):
    """``Trainer.run`` for ``n_steps`` steps from seed 0, with ``loss_fn``
    taken apart on the initial parameters (under no_grad) and the run's one
    checkpoint (at its last step) recorded, not written.  Returns (trainer,
    params, optimizer state, steps, run seconds, {"init_s", "loss",
    "metrics"} of the apart call, the log's wall seconds, the steps saved,
    peak GiB)."""
    from repro_torch.train.trainer import Trainer, TrainerConfig
    trainer = Trainer(model, pipe, TrainerConfig(
        n_steps=n_steps, ckpt_every=n_steps, log_every=1,
        ckpt_dir=tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")))
    first, init_state = {}, trainer.init_state
    saves = []

    def init_and_loss_apart(seed):
        state, first["init_s"] = synced_seconds(lambda: init_state(seed))
        with torch.no_grad():
            first["loss"], first["metrics"] = model.loss_fn(state[0], pipe.batch(0))
        return state

    trainer.init_state = init_and_loss_apart
    trainer.ckpt.save = lambda step, tree, blocking=False: saves.append(step)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    try:
        (params, opt_state, steps), run_s = synced_seconds(lambda: trainer.run(
            seed=0, callback=lambda s_, m_: walls.append(m_["wall_s"])))
    finally:
        shutil.rmtree(trainer.tcfg.ckpt_dir, ignore_errors=True)
    return (trainer, params, opt_state, steps, run_s, first, walls, saves,
            torch.cuda.max_memory_allocated() / 2**30)


def phase_moe(smi: str) -> dict:
    """Phase 19: the MoE family; see the module docstring."""
    from repro_torch.configs import get_config, get_reduced_config, param_count
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train import step as step_mod

    t_phase = time.perf_counter()
    free_card()
    dev = torch.device("cuda")
    full = get_config(MOE_ARCH)
    n_norms = lambda p: sum(t.numel() for n, t in p.named_parameters()      # noqa: E731
                            if n.rsplit(".", 1)[-1] in ("ln1", "ln2", "final_ln", "kv_ln", "bias"))
    out = {"arch": MOE_ARCH}

    # (a) decode against prefill, float32 storage and compute, capacity factor 64
    torch.cuda.reset_peak_memory_stats()
    cfg32 = moe_config(full, compute_dtype="float32", capacity_factor=64.0)
    m32 = build_model(cfg32)
    params, init_s = synced_seconds(lambda: m32.init(torch.Generator(dev).manual_seed(0)))
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != param_count(full)[0] + n_norms(params):
        fail(f"moe: {n_params} parameters, param_count says {param_count(full)[0]} + norms")
    log(f"moe (phase 19): {MOE_ARCH} at full width and depth, {n_params} parameters "
        f"({n_params * 4 / 2**30:.2f} GiB in float32) initialised in {init_s:.2f} s; {smi}")
    gen = torch.Generator(dev).manual_seed(1)
    b, s = MOE_DECODE
    tokens = torch.randint(0, full.vocab_size, (b, s), generator=gen, device=dev)
    want, prefill_s = synced_seconds(lambda: m32.prefill(params, {"tokens": tokens}))
    cache = m32.init_cache(b, s)
    t0 = time.perf_counter()
    for t in range(s):
        logits, cache = m32.decode_step(params, cache, tokens[:, t],
                                        torch.full((b,), t, device=dev))
    torch.cuda.synchronize()
    err = float((logits - want).abs().max())
    same = torch.equal(logits.argmax(-1), want.argmax(-1))
    out.update(n_params=n_params, init_s=init_s, f32_prefill_s=prefill_s,
               f32_decode_ms=(time.perf_counter() - t0) / s * 1e3, f32_decode_vs_prefill=err,
               f32_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"moe (a) float32, capacity factor 64, {b} x {s} tokens: decode's last logits against "
        f"prefill's max |d| {err:.3e} (scale {float(want.abs().max()):.3f}; rtol 1e-3, atol "
        f"1e-4), argmax equal {same}; prefill {prefill_s * 1e3:.1f} ms, "
        f"{out['f32_decode_ms']:.2f} ms a float32 decode step")
    if not torch.allclose(logits, want, rtol=1e-3, atol=1e-4) or not same:
        fail("moe (a): float32 decode does not reproduce prefill's last logits")
    del params, cache, logits, want, m32
    free_card()

    # (b) serving in bf16 at the published capacity factor: one wave through 8 slots
    cfg16 = moe_config(full, param_dtype="bfloat16")
    m16 = build_model(cfg16)
    params = m16.init(torch.Generator(dev).manual_seed(0))
    bounds = moe_tick_bounds(n_params, full)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, full.vocab_size, int(n)).tolist()
               for n in rng.integers(MOE_PROMPT[0], MOE_PROMPT[1] + 1, MOE_REQUESTS)]
    eng = ServeEngine(m16, batch_slots=MOE_SLOTS, max_seq=MOE_MAX_SEQ, params=params)
    for r, prompt in enumerate(prompts):
        eng.submit(Request(rid=r, prompt=prompt, max_new_tokens=MOE_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ticks, window, events = serve_profiled(eng, "moe (b)")
    serve_s = sum(ticks) + sum(window)
    by_kernel = {k: sum(v) for k, v in events.items()}
    busy_ms = sum(by_kernel.values()) * 1e-3 / LM_PROFILED_TICKS
    peak = torch.cuda.max_memory_allocated() / 2**30
    done = sorted(eng.completed, key=lambda r: r.rid)
    if len(done) != MOE_REQUESTS or any(
            len(r.generated) != MOE_NEW or not all(0 <= t < full.vocab_size
                                                   for t in r.generated) for r in done):
        fail(f"moe (b): {len(done)} of {MOE_REQUESTS} requests completed, not all with "
             f"{MOE_NEW} tokens inside the vocabulary")
    generated = sum(len(r.generated) for r in done)
    tick_ms = float(np.median(ticks)) * 1e3
    cache_bytes = sum(t.numel() * t.element_size() for part in eng.cache.values()
                      if part is not None for t in part.values())
    n_ticks = len(ticks) + len(window)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out["serve"] = dict(
        requests=MOE_REQUESTS, ticks=n_ticks, generated=generated,
        profiled_tick_ms_median=float(np.median(window)) * 1e3,
        device_busy_ms_a_tick=busy_ms if busy_ms > 0 else None,
        kernels_a_tick=sum(map(len, events.values())) / LM_PROFILED_TICKS,
        top_kernels_ms_a_tick={k[:70]: v * 1e-3 / LM_PROFILED_TICKS for k, v in top},
        prompt_tokens=sum(map(len, prompts)), serve_s=serve_s, tick_ms_median=tick_ms,
        tick_ms_p10_p90=[float(np.percentile(ticks, q)) * 1e3 for q in (10, 90)],
        generated_tokens_per_s=generated / serve_s,
        all_tokens_per_s=(generated + sum(map(len, prompts))) / serve_s, peak_gib=peak,
        cache_bytes=cache_bytes, bounds=bounds, serve_stats=eng.stats())
    m = cfg16.moe
    log(f"moe (b) serving bf16, capacity factor {m.capacity_factor} (capacity "
        f"{max(1, int(MOE_SLOTS * m.top_k / m.n_experts * m.capacity_factor))} a tick at "
        f"{MOE_SLOTS} slots), {MOE_SLOTS} slots x {MOE_MAX_SEQ}: {generated} tokens "
        f"generated ({out['serve']['prompt_tokens']} prompt tokens fed by decode) in "
        f"{n_ticks} ticks, {serve_s:.3f} s; generated tokens/s "
        f"{out['serve']['generated_tokens_per_s']:.2f}, all tokens/s "
        f"{out['serve']['all_tokens_per_s']:.2f}")
    log(f"moe (b) decode tick: median {tick_ms:.3f} ms (p10 / p90 "
        f"{out['serve']['tick_ms_p10_p90'][0]:.3f} / {out['serve']['tick_ms_p10_p90'][1]:.3f});"
        f" bound {bounds['tick_bound_ms']:.3f} ms (bytes) = every parameter in bf16 "
        f"{bounds['params_ms']:.3f} + latent cache {bounds['cache_ms']:.4f}; peak device "
        f"memory {peak:.2f} GiB; {smi}")
    log(f"moe (b) device time of a tick (served ticks {LM_PROFILE_AT}-"
        f"{LM_PROFILE_AT + LM_PROFILED_TICKS - 1}, profiled: median "
        f"{out['serve']['profiled_tick_ms_median']:.3f} ms a tick): "
        + ("not measured (the profiler recorded no kernel)" if busy_ms <= 0 else
           f"{busy_ms:.3f} ms of kernels in {out['serve']['kernels_a_tick']:.1f} launches, "
           f"host share {1 - busy_ms / tick_ms:.3f}; ms a tick by kernel "
           + json.dumps(out["serve"]["top_kernels_ms_a_tick"])))
    log(f"moe (b) latent cache {cache_bytes} bytes (ckv + krope, {full.n_layers} layers x "
        f"{MOE_SLOTS} x {MOE_MAX_SEQ}) against {bounds['per_head_cache_bytes']} for a per-head "
        f"K/V cache of the same shape ({bounds['per_head_cache_bytes'] / cache_bytes:.2f} x)")
    log("moe (b) serve.* snapshot: " + json.dumps(out["serve"]["serve_stats"]))
    if cache_bytes != bounds["latent_cache_bytes"]:
        fail(f"moe (b): the latent cache holds {cache_bytes} bytes, not "
             f"{bounds['latent_cache_bytes']}")
    snap = out["serve"]["serve_stats"]
    if (snap["serve.completed"], snap["serve.tokens"], snap["serve.ticks"]) != \
            (MOE_REQUESTS, generated, n_ticks):
        fail(f"moe (b): the serve.* counters disagree with the run: {snap}")
    del eng, params, m16
    free_card()

    # (c) training at full width, depth 27 -> 4, float32 storage, bf16 compute
    cfg_t = moe_config(full, n_layers=MOE_TRAIN_LAYERS)
    model = build_model(cfg_t)
    pipe = TokenPipeline(cfg_t.vocab_size, global_batch=MOE_TRAIN_BATCH,
                         seq_len=MOE_TRAIN_SEQ, seed=0)
    # the run's one checkpoint (at its last step, 27 GB with the moments)
    # is not written: phase 18 writes and times one
    trainer, tparams, opt_state, steps, run_s, first, walls, saves, peak = run_trainer_apart(
        model, pipe, MOE_TRAIN_STEPS, "moe")
    n_train = sum(p.numel() for p in tparams.parameters())
    log_ = trainer.metrics_log
    losses = [m_["loss_mean"] for m_ in log_]
    aux = [m_["aux_loss"] for m_ in log_]
    step_ms = [1e3 * (b_ - a_) for a_, b_ in zip([0.0] + walls[:-1], walls)]
    steady = float(np.median(step_ms[1:]))
    loss0 = float(first["loss"])
    out["train"] = dict(
        n_layers=MOE_TRAIN_LAYERS, n_params=n_train, batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ,
        steps=steps, init_s=first["init_s"], run_s=run_s, losses=losses, aux_losses=aux,
        step_ms=step_ms, step_ms_median_after_first=steady,
        tokens_per_s=MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (steady * 1e-3), peak_gib=peak,
        first_loss_apart=loss0, first_loss_bit_equal=losses[0] == loss0)
    log(f"moe (c) training {MOE_ARCH} at full width, {MOE_TRAIN_LAYERS} layers ({n_train} "
        f"parameters, float32 storage, bf16 compute), batch {MOE_TRAIN_BATCH} x "
        f"{MOE_TRAIN_SEQ}: losses {json.dumps(losses)}, aux losses {json.dumps(aux)}; ms a step "
        f"{json.dumps([round(x, 1) for x in step_ms])} (median after the first {steady:.1f}: "
        f"{out['train']['tokens_per_s']:.1f} tokens/s); peak {peak:.2f} GiB; {smi}")
    log(f"moe (c) first loss {losses[0]!r} against loss_fn apart {loss0!r} (bit for bit "
        f"{out['train']['first_loss_bit_equal']})")
    if steps != MOE_TRAIN_STEPS or len(losses) != MOE_TRAIN_STEPS \
            or not np.all(np.isfinite(losses)) or not all(np.isfinite(a) and a > 0 for a in aux):
        fail(f"moe (c): {steps} steps, losses {losses}, aux losses {aux}")
    if losses[0] != loss0:
        fail(f"moe (c): the first step's loss {losses[0]!r} is not loss_fn's {loss0!r}")
    if saves != [MOE_TRAIN_STEPS]:
        fail(f"moe (c): checkpoint saves at {saves}")
    del tparams, opt_state, trainer, model, first
    free_card()

    # (d) the reduced deepseek_v3_671b: sigmoid_bias router, q_lora and MTP
    v3 = get_reduced_config(MOE_V3_ARCH)
    mv3 = build_model(v3)
    p3 = mv3.init(torch.Generator(dev).manual_seed(0))
    opt = step_mod.opt_config_for(v3)
    batch = {"tokens": torch.randint(0, v3.vocab_size, (MOE_V3_BATCH, 65), generator=gen,
                                     device=dev)}
    p3, state3, metrics3 = step_mod.make_train_step(mv3, opt)(
        p3, step_mod.make_opt_init(mv3, opt)(p3), batch)
    metrics3 = {k: float(v) for k, v in metrics3.items()}
    eng = ServeEngine(mv3, batch_slots=4, max_seq=64, params=p3)
    for r in range(6):
        eng.submit(Request(rid=r, prompt=[1 + r, 2, 3, 4], max_new_tokens=8))
    v3_done = eng.run()
    # and its float32 loss on the card against the CPU's, the same parameters
    c32 = moe_config(v3, compute_dtype="float32")
    cpu_params = copy.deepcopy(p3).cpu()
    with torch.no_grad():
        l_card = float(build_model(c32).loss_fn(p3, batch)[0])
        l_cpu = float(build_model(c32, device="cpu").loss_fn(
            cpu_params, {"tokens": batch["tokens"].cpu()})[0])
    out["v3"] = dict(metrics=metrics3, served=len(v3_done),
                     tokens=sum(len(r.generated) for r in v3_done), f32_loss_card=l_card,
                     f32_loss_cpu=l_cpu)
    log(f"moe (d) reduced {MOE_V3_ARCH} (sigmoid_bias router, norm_topk_prob, q_lora "
        f"{v3.mla.q_lora_rank}, MTP; bf16 parameters, bf16 factored moments, grad_accum "
        f"{v3.grad_accum}): one train step, metrics {json.dumps(metrics3)}; ServeEngine served "
        f"{len(v3_done)} requests ({out['v3']['tokens']} tokens); float32 loss card "
        f"{l_card!r} against CPU {l_cpu!r} (rtol 1e-4)")
    if not {"mtp_loss", "aux_loss", "lm_loss"} <= set(metrics3) \
            or not all(np.isfinite(v) for v in metrics3.values()):
        fail(f"moe (d): the v3 train step's metrics {metrics3}")
    if len(v3_done) != 6 or any(len(r.generated) != 8 or not all(
            0 <= t < v3.vocab_size for t in r.generated) for r in v3_done):
        fail("moe (d): the v3 ServeEngine run did not complete inside the vocabulary")
    if abs(l_card - l_cpu) > 1e-4 * abs(l_cpu):
        fail(f"moe (d): the float32 v3 loss on the card {l_card} is not the CPU's {l_cpu}")
    del p3, state3, eng, mv3, cpu_params
    free_card()

    # (e) tie order on the card
    out["ties"] = check_moe_ties(gen)
    out["phase_s"] = time.perf_counter() - t_phase
    log("moe (phase 19): " + json.dumps(out))
    return out


# Phases 20 and 21: the recurrent families at full width and depth, each
# stored in float32.  rwkv6_3b (ssm): 32 RWKV-6 layers, d_model 2 560, 40
# heads of 64, d_ff 8 960, vocab 65 536; 3 075 770 880 parameters
# (param_count's estimate, the reference's formula: 3 344 957 440).
# zamba2_2p7b (hybrid): 54 Mamba-2 layers, d_model 2 560, d_inner 5 120,
# 80 heads of 64, state 64, conv 4, chunk 128, and one shared block (32
# heads of 80, d_ff 10 240) after every 6th layer: 9 applications; vocab
# 32 000; 2 422 220 960 parameters (param_count: 2 427 453 440).  Cuts:
# in (c) the depth (32 -> 4; 54 -> 12, so that the shared block runs
# twice), train_4k's batch 256 x 4 096 -> 4 x 1 024 and 3 steps.
#
# The reference's hybrid stack has no residual around a Mamba block, and
# its init scales out_proj by 1 / sqrt(2 L): at 54 layers each block's
# output is ~0.1 of its input's scale, and once y * silu(z) falls under
# rms_norm's eps the decay turns quadratic: the hidden state is exactly 0
# within ~11 layers and every logit is 0 (the reference's and the port's
# alike: tests/test_torch_hybrid.py).  So phase 21's (a) also runs at
# depth REC_HYBRID_LIVE (the published init for that depth: the shared
# block applied twice, the logits O(1)), and (b) serves with each Mamba
# out_proj scaled by sqrt(2 L) (unit_scale_mamba), so that its tokens and
# the refilled slot's check are not all zeros; at unit scale the stack is
# chaotic (a rounding grows ~2.5x a layer), which serving does not mind
# (a slot's row is computed apart from the others, bit for bit) but a
# decode-against-prefill check would.  A compared logits scale of 0 fails
# the phase.
SSM_ARCH, HYBRID_ARCH = "rwkv6_3b", "zamba2_2p7b"
REC_HYBRID_LIVE = 8
REC_TRAIN_LAYERS = {SSM_ARCH: 4, HYBRID_ARCH: 12}
REC_TRAIN_BATCH, REC_TRAIN_SEQ, REC_TRAIN_STEPS = 4, 1024, 3
# (d): one sequence of 1 024 at the full configs' heads: WKV (B, T, H, P),
# SSD (B, T, H, P, N) at zamba2's chunk of 128
REC_WKV_SHAPE = (1, 1024, 40, 64)
REC_SSD_SHAPE = (1, 1024, 80, 64, 64)
# (d): the chunked forms against the sequential recurrence on the same
# inputs: the reference's test_wkv_chunked_matches_scan limit (rtol 1e-4,
# atol 1e-4) for the WKV; 1e-4 of each quantity's scale for the SSD scan
# and its gradient against float64 autograd
REC_SCAN_REL = 1e-4


def recurrent_param_count(cfg) -> int:
    """The parameters the reference's init holds for an ssm or hybrid
    config (``param_count`` is an estimate for these families): untied
    embedding and unembed, final_ln, and per RWKV-6 layer six d x d
    weights, the FFN, the decay's low-rank pair and ten d-vectors (7 mixes,
    w0, u, ln_x); per Mamba-2 layer in_proj, w_bc, w_dt, the conv, the
    norm, out_proj and three head vectors; the shared block once."""
    d, L = cfg.d_model, cfg.n_layers
    total = 2 * cfg.vocab_size * d + d
    if cfg.family == "ssm":
        return total + L * (6 * d * d + 2 * d * cfg.d_ff + 2 * d * max(32, d // 32) + 10 * d)
    s = cfg.ssm
    din = s.expand * d
    h = din // s.head_dim
    mamba = 2 * d * din + 2 * d * s.state_dim + d * h + 3 * h + s.conv_width * din + din \
        + din * d
    hd = cfg.resolved_head_dim
    shared = 2 * d + d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d \
        + 3 * d * s.shared_d_ff
    return total + L * mamba + (shared if s.shared_stride else 0)


def recurrent_tick_bounds(n_params: int, cache: dict, cfg) -> dict:
    """The least time of one decode tick at LM_SLOTS slots on this card,
    by bytes (ms): the parameters as the reference computes them (read in
    float32, written and read again in bf16: 8 B each) or from a held bf16
    copy (2 B each); the whole cache read, and its recurrent part (RWKV's
    state and shift rows, Mamba's state and conv rows) written.  Beside
    it the cache's bytes and those of a per-head K/V cache of the same
    depth at LM_MAX_SEQ (bf16)."""
    from repro_torch.tree import tree_leaves
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree))  # noqa: E731
    read = nbytes(cache)
    written = nbytes(cache if cfg.family == "ssm" else cache["ssm"])
    kv = 2 * cfg.n_layers * LM_SLOTS * LM_MAX_SEQ * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    return dict(cast_ms=8 * n_params / PEAK_HBM_BYTES * 1e3,
                bf16_copy_ms=2 * n_params / PEAK_HBM_BYTES * 1e3,
                cache_ms=(read + written) / PEAK_HBM_BYTES * 1e3,
                tick_bound_ms=(8 * n_params + read + written) / PEAK_HBM_BYTES * 1e3,
                cache_bytes=read, recurrent_bytes=written, kv_cache_bytes=kv)


def unit_scale_mamba(params) -> None:
    """Scale each Mamba layer's out_proj by sqrt(2 L), in place: the
    reference's init divides it by that (its residual-stream scaling), but
    the hybrid stack has no residual around a Mamba block, so at the
    published depth the hidden state collapses to 0 (see the constants of
    phases 20-21)."""
    layers = params.layers.mamba
    with torch.no_grad():
        for layer in layers:
            layer["out_proj"].mul_((2 * len(layers)) ** 0.5)


def check_wkv_forms(gen) -> dict:
    """Phase 20 (d): ``_wkv_chunked_parallel`` against ``_wkv_scan`` at
    REC_WKV_SHAPE (rwkv6_3b's 40 heads of 64), a carried state, the
    reference test's decay range uniform(0.05, 0.999): outputs and final
    state to rtol / atol REC_SCAN_REL; both forms timed."""
    from repro_torch.models import rwkv
    b, t, h, p = REC_WKV_SHAPE
    r, k, v = (torch.randn(b, t, h, p, generator=gen, device=gen.device) for _ in range(3))
    w = 0.05 + 0.949 * torch.rand(b, t, h, p, generator=gen, device=gen.device)
    u = torch.randn(h, p, generator=gen, device=gen.device)
    s0 = torch.randn(b, h, p, p, generator=gen, device=gen.device)
    with torch.no_grad():
        o_c, s_c = rwkv._wkv_chunked_parallel(r, k, v, w, u, s0)
        o_s, s_s = rwkv._wkv_scan(r, k, v, w, u, s0)
        res = dict(out_max_abs_err=float((o_c - o_s).abs().max()),
                   out_scale=float(o_s.abs().max()),
                   state_max_abs_err=float((s_c - s_s).abs().max()),
                   state_scale=float(s_s.abs().max()),
                   chunked_ms=cuda_ms(lambda: rwkv._wkv_chunked_parallel(r, k, v, w, u, s0),
                                      reps=3, inner=1),
                   scan_ms=cuda_ms(lambda: rwkv._wkv_scan(r, k, v, w, u, s0), reps=3, inner=1))
        ok = torch.allclose(o_c, o_s, rtol=REC_SCAN_REL, atol=REC_SCAN_REL) and \
            torch.allclose(s_c, s_s, rtol=REC_SCAN_REL, atol=REC_SCAN_REL)
    log(f"ssm (d) chunked WKV against the sequential scan at B {b}, T {t}, H {h}, P {p}, "
        f"float32: " + json.dumps(res) + f" (rtol / atol {REC_SCAN_REL})")
    if not ok:
        fail("ssm (d): the chunked WKV disagrees with the sequential scan")
    return res


def ssd_sequential64(xh, bt, ct, dt, a_log):
    """The SSD recurrence step by step in float64: S_t = exp(dt_t A) S_{t-1}
    + dt_t B_t (x) x_t, y_t = C_t . S_t (A = -exp(a_log))."""
    a = -torch.exp(a_log)
    s = torch.zeros(xh.shape[0], xh.shape[2], bt.shape[-1], xh.shape[3], dtype=torch.float64,
                    device=xh.device)
    ys = []
    for t in range(xh.shape[1]):
        s = torch.exp(dt[:, t] * a)[:, :, None, None] * s \
            + dt[:, t, :, None, None] * bt[:, t, None, :, None] * xh[:, t, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", ct[:, t], s))
    return torch.stack(ys, dim=1)


def check_ssd_gradient(gen) -> dict:
    """Phase 21 (d): ``_ssd_chunked`` at zamba2's chunk of 128 and
    REC_SSD_SHAPE (its 80 heads of 64, state 64), A = -1 (a_log 0, as at
    init) and dt from [0.75, 0.9], so that the reference's exponent above
    the diagonal (a sum of up to 127 dt) passes float32's exp limit of
    88.72: y and the gradient of <y, g> (g random) to x, B, C, dt and
    a_log against float64 autograd through the sequential recurrence, to
    REC_SCAN_REL of each one's scale, the gradient finite."""
    from repro_torch.models import ssm
    (b, t, h, p, n), q = REC_SSD_SHAPE, 128
    dev = gen.device
    ins = dict(xh=torch.randn(b, t, h, p, generator=gen, device=dev),
               bt=torch.randn(b, t, n, generator=gen, device=dev) * n**-0.5,
               ct=torch.randn(b, t, n, generator=gen, device=dev) * n**-0.5,
               dt=0.75 + 0.15 * torch.rand(b, t, h, generator=gen, device=dev),
               a_log=torch.zeros(h, device=dev))
    cot = torch.randn(b, t, h, p, generator=gen, device=dev)
    # the reference's exponent where it masks after the exp: cla_i - cla_j, j > i
    cla = torch.cumsum((-ins["dt"]).reshape(b, t // q, q, h), dim=2)
    dd = cla[:, :, :, None, :] - cla[:, :, None, :, :]         # [.., i, j]: cla_i - cla_j
    upper = torch.triu(torch.ones(q, q, dtype=torch.bool, device=dev), 1)   # j > i
    dd_max = float(dd[:, :, upper].max())
    leaves = {k: v.clone().requires_grad_(True) for k, v in ins.items()}
    y, _ = ssm._ssd_chunked(**leaves, chunk=q)
    grads = torch.autograd.grad((y * cot).sum(), list(leaves.values()))
    ins64 = {k: v.double().requires_grad_(True) for k, v in ins.items()}
    y64 = ssd_sequential64(**ins64)
    grads64 = torch.autograd.grad((y64 * cot.double()).sum(), list(ins64.values()))
    y, y64 = y.detach(), y64.detach()
    errs = {"y": float((y.double() - y64).abs().max() / y64.abs().max())}
    for name, g, g64 in zip(ins, grads, grads64):
        errs[f"d{name}"] = float((g.double() - g64).abs().max() / g64.abs().max())
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    ms = cuda_ms(lambda: ssm._ssd_chunked(**ins, chunk=q), reps=3, inner=1)
    res = dict(masked_exponent_max=dd_max, exp_overflows=dd_max > 88.72, rel_errs=errs,
               grad_finite=finite, chunked_forward_ms=ms)
    log(f"hybrid (d) _ssd_chunked at chunk {q}, B {b}, T {t}, H {h}, P {p}, N {n}, dt in "
        f"[0.75, 0.9]: the reference's exponent above the diagonal reaches {dd_max:.2f} "
        f"(exp overflows past 88.72: {dd_max > 88.72}); y and the gradient against float64 "
        f"autograd of the sequential recurrence, max |d| over each one's scale "
        f"{json.dumps(errs)} (limit {REC_SCAN_REL}); gradient finite {finite}; the chunked "
        f"forward {ms:.3f} ms")
    del leaves, ins64, y64, grads, grads64, dd
    if dd_max <= 88.72:
        fail("hybrid (d): dt does not take the reference's exponent past float32's exp limit")
    if not finite or max(errs.values()) > REC_SCAN_REL:
        fail(f"hybrid (d): the SSD scan or its gradient disagrees with float64: {errs}")
    return res


def check_decode_prefill(tag: str, model, params, tokens) -> dict:
    """(a) of phases 20-21: ``model``'s float32 prefill of ``tokens`` [B,
    S] (the chunked scan) against S decode steps (the one-step
    recurrence): the last logits within rtol 1e-3 / atol 1e-4, the same
    argmax.  Returns the error, the logits' scale and the times."""
    b, s = tokens.shape
    dev = tokens.device
    want, prefill_s = synced_seconds(lambda: model.prefill(params, {"tokens": tokens}))
    cache = model.init_cache(b, s)
    t0 = time.perf_counter()
    for t in range(s):
        logits, cache = model.decode_step(params, cache, tokens[:, t],
                                          torch.full((b,), t, device=dev))
    torch.cuda.synchronize()
    err = float((logits - want).abs().max())
    same = torch.equal(logits.argmax(-1), want.argmax(-1))
    res = dict(prefill_s=prefill_s, decode_ms=(time.perf_counter() - t0) / s * 1e3,
               decode_vs_prefill=err, scale=float(want.abs().max()))
    log(f"{tag} (a) float32, {model.cfg.n_layers} layers, {b} x {s} tokens: decode's last "
        f"logits against prefill's max |d| {err:.3e} (scale {res['scale']!r}; rtol 1e-3, atol "
        f"1e-4), argmax equal {same}; prefill {prefill_s * 1e3:.1f} ms, "
        f"{res['decode_ms']:.2f} ms a float32 decode step")
    if not torch.allclose(logits, want, rtol=1e-3, atol=1e-4) or not same:
        fail(f"{tag} (a): float32 decode does not reproduce prefill's last logits")
    return res


def phase_recurrent(smi: str, arch: str) -> dict:
    """Phase 20 (``SSM_ARCH``) or 21 (``HYBRID_ARCH``): a recurrent family
    at full width and depth; see the module docstring."""
    import dataclasses

    from repro_torch.configs import get_config, param_count
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    t_phase = time.perf_counter()
    free_card()
    dev = torch.device("cuda")
    full = get_config(arch)
    tag, no = ("ssm", 20) if full.family == "ssm" else ("hybrid", 21)
    m16 = build_model(full)
    m32 = build_model(dataclasses.replace(full, compute_dtype="float32"))
    torch.cuda.reset_peak_memory_stats()
    params, init_s = synced_seconds(lambda: m16.init(torch.Generator(dev).manual_seed(0)))
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != recurrent_param_count(full):
        fail(f"{tag}: {n_params} parameters, the reference's init holds "
             f"{recurrent_param_count(full)}")
    out = dict(arch=arch, n_params=n_params, param_count=param_count(full)[0], init_s=init_s)
    log(f"{tag} (phase {no}): {arch} at full width and depth, {n_params} parameters "
        f"({n_params * 4 / 2**30:.2f} GiB in float32; param_count's estimate "
        f"{out['param_count']}) initialised in {init_s:.2f} s; {smi}")
    gen = torch.Generator(dev).manual_seed(1)
    vocab = full.vocab_size
    tokens = torch.randint(0, vocab, LM_DECODE, generator=gen, device=dev)

    # (a) float32: prefill (the chunked scan) against decode (the one-step
    # recurrence); for the hybrid also at the depth whose logits live
    out["f32"] = check_decode_prefill(tag, m32, params, tokens)
    if full.family == "hybrid":
        cut = build_model(dataclasses.replace(full, n_layers=REC_HYBRID_LIVE,
                                              compute_dtype="float32"))
        out["f32_live"] = check_decode_prefill(
            tag, cut, cut.init(torch.Generator(dev).manual_seed(0)), tokens)
        if out["f32_live"]["scale"] == 0:
            fail(f"{tag} (a): every logit is 0 at depth {REC_HYBRID_LIVE}")
        unit_scale_mamba(params)
        log(f"{tag} (a) the published init's logits at {full.n_layers} layers: scale "
            f"{out['f32']['scale']!r} (the stack's collapse); (b) serves with each Mamba "
            f"out_proj scaled by sqrt(2 L) = {(2 * full.n_layers) ** 0.5:.3f}")
        del cut
    elif out["f32"]["scale"] == 0:
        fail(f"{tag} (a): every logit is 0")

    # (b) serving in bf16: phase 17's requests through 8 slots; request
    # LM_ALONE_RID, the ninth, enters a slot another request left
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, int(n)).tolist()
               for n in rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)]
    eng = ServeEngine(m16, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ, params=params)
    pooled_first = capture_first_logits(eng, LM_ALONE_RID)
    for r, prompt in enumerate(prompts):
        eng.submit(Request(rid=r, prompt=prompt, max_new_tokens=LM_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ticks, window, events = serve_profiled(eng, f"{tag} (b)")
    serve_s = sum(ticks) + sum(window)
    peak = torch.cuda.max_memory_allocated() / 2**30
    done = sorted(eng.completed, key=lambda r: r.rid)
    if len(done) != LM_REQUESTS or any(
            len(r.generated) != LM_NEW or not all(0 <= t < vocab for t in r.generated)
            for r in done):
        fail(f"{tag} (b): {len(done)} of {LM_REQUESTS} requests completed, not all with "
             f"{LM_NEW} tokens inside the vocabulary")
    generated = sum(len(r.generated) for r in done)
    by_kernel = {k: sum(v) for k, v in events.items()}
    busy_ms = sum(by_kernel.values()) * 1e-3 / LM_PROFILED_TICKS
    tick_ms = float(np.median(ticks)) * 1e3
    bounds = recurrent_tick_bounds(n_params, eng.cache, full)
    alone = ServeEngine(m16, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ, params=params)
    alone_first = capture_first_logits(alone, LM_ALONE_RID)
    alone.submit(Request(rid=LM_ALONE_RID, prompt=prompts[LM_ALONE_RID], max_new_tokens=1))
    alone.run()
    a, p = alone_first["logits"], pooled_first["logits"]
    alone_err = float((a - p).abs().max())
    n_ticks = len(ticks) + len(window)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out["serve"] = dict(
        requests=LM_REQUESTS, ticks=n_ticks, generated=generated,
        prompt_tokens=sum(map(len, prompts)), serve_s=serve_s, tick_ms_median=tick_ms,
        tick_ms_p10_p90=[float(np.percentile(ticks, q)) * 1e3 for q in (10, 90)],
        profiled_tick_ms_median=float(np.median(window)) * 1e3,
        device_busy_ms_a_tick=busy_ms if busy_ms > 0 else None,
        host_share=1 - busy_ms / tick_ms if busy_ms > 0 else None,
        kernels_a_tick=sum(map(len, events.values())) / LM_PROFILED_TICKS,
        top_kernels_ms_a_tick={k[:70]: v * 1e-3 / LM_PROFILED_TICKS for k, v in top},
        generated_tokens_per_s=generated / serve_s,
        all_tokens_per_s=(generated + sum(map(len, prompts))) / serve_s, peak_gib=peak,
        bounds=bounds, alone_vs_pooled=alone_err,
        alone_first_token_equal=alone.completed[0].generated[0] == done[LM_ALONE_RID].generated[0],
        serve_stats=eng.stats())
    sv = out["serve"]
    log(f"{tag} (b) serving bf16 (float32 storage), {LM_SLOTS} slots x {LM_MAX_SEQ}: "
        f"{generated} tokens generated ({sv['prompt_tokens']} prompt tokens fed by decode) in "
        f"{n_ticks} ticks, {serve_s:.3f} s; generated tokens/s "
        f"{sv['generated_tokens_per_s']:.2f}, all tokens/s {sv['all_tokens_per_s']:.2f}")
    log(f"{tag} (b) decode tick: median {tick_ms:.3f} ms (p10 / p90 "
        f"{sv['tick_ms_p10_p90'][0]:.3f} / {sv['tick_ms_p10_p90'][1]:.3f}); bound "
        f"{bounds['tick_bound_ms']:.3f} ms (bytes) = cast {bounds['cast_ms']:.3f} + cache "
        f"{bounds['cache_ms']:.4f}; with a held bf16 copy {bounds['bf16_copy_ms']:.3f} + cache; "
        f"peak device memory {peak:.2f} GiB; {smi}")
    log(f"{tag} (b) device time of a tick (served ticks {LM_PROFILE_AT}-"
        f"{LM_PROFILE_AT + LM_PROFILED_TICKS - 1}, profiled: median "
        f"{sv['profiled_tick_ms_median']:.3f} ms a tick): "
        + ("not measured (the profiler recorded no kernel)" if busy_ms <= 0 else
           f"{busy_ms:.3f} ms of kernels in {sv['kernels_a_tick']:.1f} launches, host share "
           f"{sv['host_share']:.3f}; ms a tick by kernel "
           + json.dumps(sv["top_kernels_ms_a_tick"])))
    log(f"{tag} (b) the cache {bounds['cache_bytes']} bytes ({bounds['recurrent_bytes']} of it "
        f"recurrent state, written every tick) against {bounds['kv_cache_bytes']} for a "
        f"per-head K/V cache of the same depth at {LM_MAX_SEQ} "
        f"({bounds['kv_cache_bytes'] / bounds['cache_bytes']:.2f} x)")
    log(f"{tag} (b) request {LM_ALONE_RID} (into a refilled slot) alone against pooled: first "
        f"logits max |d| {alone_err:.3e} (limit {LM_ALONE_REL} x {float(p.abs().max()):.3f}), "
        f"first token equal {sv['alone_first_token_equal']}")
    log(f"{tag} (b) serve.* snapshot: " + json.dumps(sv["serve_stats"]))
    if alone_err > LM_ALONE_REL * float(p.abs().max()) or float(p.abs().max()) == 0:
        fail(f"{tag} (b): request {LM_ALONE_RID} alone and pooled disagree: {alone_err:.3e}")
    snap = sv["serve_stats"]
    if (snap["serve.completed"], snap["serve.tokens"], snap["serve.ticks"]) != \
            (LM_REQUESTS, generated, n_ticks):
        fail(f"{tag} (b): the serve.* counters disagree with the run: {snap}")
    del eng, alone, params, m16, m32        # the spies close over their engines
    free_card()

    # (c) training at full width, depth cut, float32 storage, bf16 compute
    layers = REC_TRAIN_LAYERS[arch]
    model = build_model(dataclasses.replace(full, n_layers=layers))
    pipe = TokenPipeline(full.vocab_size, global_batch=REC_TRAIN_BATCH,
                         seq_len=REC_TRAIN_SEQ, seed=0)
    trainer, tparams, opt_state, steps, run_s, first, walls, saves, peak = run_trainer_apart(
        model, pipe, REC_TRAIN_STEPS, tag)
    n_train = sum(p.numel() for p in tparams.parameters())
    log_ = trainer.metrics_log
    losses = [m_["loss_mean"] for m_ in log_]
    gnorms = [m_["grad_norm"] for m_ in log_]
    step_ms = [1e3 * (b_ - a_) for a_, b_ in zip([0.0] + walls[:-1], walls)]
    steady = float(np.median(step_ms[1:]))
    loss0 = float(first["loss"])
    out["train"] = dict(
        n_layers=layers, n_params=n_train, batch=REC_TRAIN_BATCH, seq=REC_TRAIN_SEQ,
        steps=steps, init_s=first["init_s"], run_s=run_s, losses=losses, grad_norms=gnorms,
        step_ms=step_ms, step_ms_median_after_first=steady,
        tokens_per_s=REC_TRAIN_BATCH * REC_TRAIN_SEQ / (steady * 1e-3), peak_gib=peak,
        first_loss_apart=loss0, first_loss_bit_equal=losses[0] == loss0)
    apps = "" if full.family == "ssm" else \
        f", the shared block applied {-(-layers // full.ssm.shared_stride)} times"
    log(f"{tag} (c) training {arch} at full width, {layers} layers{apps} ({n_train} parameters, "
        f"float32 storage, bf16 compute), batch {REC_TRAIN_BATCH} x {REC_TRAIN_SEQ}: losses "
        f"{json.dumps(losses)}, grad norms {json.dumps(gnorms)}; ms a step "
        f"{json.dumps([round(x, 1) for x in step_ms])} (median after the first {steady:.1f}: "
        f"{out['train']['tokens_per_s']:.1f} tokens/s); peak {peak:.2f} GiB; {smi}")
    log(f"{tag} (c) first loss {losses[0]!r} against loss_fn apart {loss0!r} (bit for bit "
        f"{out['train']['first_loss_bit_equal']})")
    if steps != REC_TRAIN_STEPS or len(losses) != REC_TRAIN_STEPS \
            or not np.all(np.isfinite(losses)) or not np.all(np.isfinite(gnorms)):
        fail(f"{tag} (c): {steps} steps, losses {losses}, grad norms {gnorms}")
    if losses[0] != loss0:
        fail(f"{tag} (c): the first step's loss {losses[0]!r} is not loss_fn's {loss0!r}")
    if saves != [REC_TRAIN_STEPS]:
        fail(f"{tag} (c): checkpoint saves at {saves}")
    del tparams, opt_state, trainer, model, first
    free_card()

    # (d) the chunked scan against the sequential recurrence
    out["scan"] = check_wkv_forms(gen) if full.family == "ssm" else check_ssd_gradient(gen)
    free_card()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"{tag} (phase {no}): " + json.dumps(out))
    return out


# Phases 22 and 23: the two multimodal families, each frontend a stub as
# in the reference (frames or patches come in as [B, n, d_model]
# embeddings, drawn from a seed).  whisper_tiny (audio): 4 encoder + 4
# decoder layers, d_model 384, 6 heads of 64, d_ff 1 536, 1 500 frames,
# vocab 51 865, tied; 41 157 888 parameters.  llava_next_34b (vlm): 60
# layers, d_model 7 168, 56 query heads over 8 KV heads of 128, d_ff
# 20 480, vocab 64 000, 2 880 patches; 34 388 917 248 parameters (68.78 GB
# in bf16 storage, 137.6 GB in float32).
AUDIO_ARCH, VLM_ARCH = "whisper_tiny", "llava_next_34b"
AUDIO_DECODE = (2, 64)        # (a) batch x text tokens: prefill against decode, float32
AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ, AUDIO_TRAIN_STEPS = 4, 448, 4   # 448: whisper's text context
VLM_F32_LAYERS = 8            # (a): 5.38 B parameters, 21.5 GB in float32
VLM_TEXT = 64                 # text tokens after the 2 880 patches
# (b)'s serving runs: whisper's 16 requests drawn as phase 17's are (461
# ticks of ~11 ms); llava's 8, one wave through the 8 slots (236 ticks of
# ~130 ms: 16 took 56.5 s, which the script's 1 200 s could not hold
# beside phases 3-21)
AUDIO_REQUESTS, VLM_REQUESTS = 16, 8
VLM_TRAIN_LAYERS, VLM_TRAIN_BATCH, VLM_TRAIN_TEXT, VLM_TRAIN_STEPS = 2, 2, 128, 4
# The encoder's attention, forward and backward, against float64: float32
# sums 1 500 terms a row in other orders (1e-4 leaves a wide margin over
# its ~1e-6); the planted fault (the 36 padded keys counted as real) must
# exceed it.
AUDIO_ATTN_REL = 1e-4


def tick_bounds(param_bytes: float, cache_bytes: float) -> dict:
    """The least time of one decode tick on this card, by bytes (ms): the
    parameters' bytes as the tick moves them and every cache leaf read
    once."""
    return dict(params_ms=param_bytes / PEAK_HBM_BYTES * 1e3,
                cache_ms=cache_bytes / PEAK_HBM_BYTES * 1e3,
                tick_bound_ms=(param_bytes + cache_bytes) / PEAK_HBM_BYTES * 1e3)


def serve_requests(tag: str, model, params, requests: int, bounds: dict, smi: str) -> dict:
    """Phase 17's serving run (``requests`` prompts of LM_PROMPT seeded
    tokens, drawn as phase 17 draws its own, LM_NEW new each,
    ServeEngine(LM_SLOTS, LM_MAX_SEQ)) through
    ``serve_profiled``: every request complete inside the vocabulary, the
    serve.* counters equal to the run's.  Logs and returns the median tick
    against ``bounds``, tokens/s, the host's share of a tick and peak
    memory."""
    from repro_torch.serve.engine import Request, ServeEngine
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, int(n)).tolist()
               for n in rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, requests)]
    eng = ServeEngine(model, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ, params=params)
    for r, prompt in enumerate(prompts):
        eng.submit(Request(rid=r, prompt=prompt, max_new_tokens=LM_NEW))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ticks, window, events = serve_profiled(eng, f"{tag} (b)")
    serve_s = sum(ticks) + sum(window)
    peak = torch.cuda.max_memory_allocated() / 2**30
    done = sorted(eng.completed, key=lambda r: r.rid)
    if len(done) != requests or any(
            len(r.generated) != LM_NEW or not all(0 <= t < vocab for t in r.generated)
            for r in done):
        fail(f"{tag} (b): {len(done)} of {requests} requests completed, not all with "
             f"{LM_NEW} tokens inside the vocabulary")
    generated = sum(len(r.generated) for r in done)
    by_kernel = {k: sum(v) for k, v in events.items()}
    busy_ms = sum(by_kernel.values()) * 1e-3 / LM_PROFILED_TICKS
    tick_ms = float(np.median(ticks)) * 1e3
    n_ticks = len(ticks) + len(window)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    sv = dict(
        requests=requests, ticks=n_ticks, generated=generated,
        prompt_tokens=sum(map(len, prompts)), serve_s=serve_s, tick_ms_median=tick_ms,
        tick_ms_p10_p90=[float(np.percentile(ticks, q)) * 1e3 for q in (10, 90)],
        profiled_tick_ms_median=float(np.median(window)) * 1e3,
        device_busy_ms_a_tick=busy_ms if busy_ms > 0 else None,
        host_share=1 - busy_ms / tick_ms if busy_ms > 0 else None,
        kernels_a_tick=sum(map(len, events.values())) / LM_PROFILED_TICKS,
        top_kernels_ms_a_tick={k[:70]: v * 1e-3 / LM_PROFILED_TICKS for k, v in top},
        generated_tokens_per_s=generated / serve_s,
        all_tokens_per_s=(generated + sum(map(len, prompts))) / serve_s, peak_gib=peak,
        bounds=bounds, serve_stats=eng.stats())
    log(f"{tag} (b) serving {model.cfg.compute_dtype} ({model.cfg.param_dtype} storage), "
        f"{LM_SLOTS} slots x {LM_MAX_SEQ}, text only: {generated} tokens generated "
        f"({sv['prompt_tokens']} prompt tokens fed by decode) in {n_ticks} ticks, "
        f"{serve_s:.3f} s; generated tokens/s {sv['generated_tokens_per_s']:.2f}, all tokens/s "
        f"{sv['all_tokens_per_s']:.2f}")
    log(f"{tag} (b) decode tick: median {tick_ms:.3f} ms (p10 / p90 "
        f"{sv['tick_ms_p10_p90'][0]:.3f} / {sv['tick_ms_p10_p90'][1]:.3f}); bound "
        f"{bounds['tick_bound_ms']:.3f} ms (bytes) = parameters {bounds['params_ms']:.3f} + "
        f"cache {bounds['cache_ms']:.4f}; peak device memory {peak:.2f} GiB; {smi}")
    log(f"{tag} (b) device time of a tick (served ticks {LM_PROFILE_AT}-"
        f"{LM_PROFILE_AT + LM_PROFILED_TICKS - 1}, profiled: median "
        f"{sv['profiled_tick_ms_median']:.3f} ms a tick): "
        + ("not measured (the profiler recorded no kernel)" if busy_ms <= 0 else
           f"{busy_ms:.3f} ms of kernels in {sv['kernels_a_tick']:.1f} launches, host share "
           f"{sv['host_share']:.3f}; ms a tick by kernel "
           + json.dumps(sv["top_kernels_ms_a_tick"])))
    log(f"{tag} (b) serve.* snapshot: " + json.dumps(sv["serve_stats"]))
    snap = sv["serve_stats"]
    if (snap["serve.completed"], snap["serve.tokens"], snap["serve.ticks"]) != \
            (requests, generated, n_ticks):
        fail(f"{tag} (b): the serve.* counters disagree with the run: {snap}")
    sv["cache"] = eng.cache
    return sv


def train_apart(tag: str, model, pipe, steps: int, tokens_a_step: int, smi: str) -> dict:
    """``run_trainer_apart`` for ``steps`` steps: the losses and gradient
    norms finite, the first loss equal to ``loss_fn`` apart bit for bit,
    the one checkpoint recorded at the last step.  Logs and returns step
    ms, tokens/s (``tokens_a_step`` positions a step) and peak memory."""
    trainer, tparams, opt_state, n, run_s, first, walls, saves, peak = run_trainer_apart(
        model, pipe, steps, tag)
    n_params = sum(p.numel() for p in tparams.parameters())
    losses = [m_["loss_mean"] for m_ in trainer.metrics_log]
    gnorms = [m_["grad_norm"] for m_ in trainer.metrics_log]
    step_ms = [1e3 * (b_ - a_) for a_, b_ in zip([0.0] + walls[:-1], walls)]
    steady = float(np.median(step_ms[1:]))
    loss0 = float(first["loss"])
    res = dict(n_layers=model.cfg.n_layers, n_params=n_params, steps=n, init_s=first["init_s"],
               run_s=run_s, losses=losses, grad_norms=gnorms, step_ms=step_ms,
               step_ms_median_after_first=steady,
               tokens_per_s=tokens_a_step / (steady * 1e-3), peak_gib=peak,
               first_loss_apart=loss0, first_loss_bit_equal=losses[0] == loss0)
    log(f"{tag} (c) training {model.cfg.name} at full width, {model.cfg.n_layers} layers "
        f"({n_params} parameters, {model.cfg.param_dtype} storage, {model.cfg.compute_dtype} "
        f"compute), {tokens_a_step} positions a step: losses {json.dumps(losses)}, grad norms "
        f"{json.dumps(gnorms)}; ms a step {json.dumps([round(x, 1) for x in step_ms])} (median "
        f"after the first {steady:.1f}: {res['tokens_per_s']:.1f} positions/s); peak "
        f"{peak:.2f} GiB; {smi}")
    log(f"{tag} (c) first loss {losses[0]!r} against loss_fn apart {loss0!r} (bit for bit "
        f"{res['first_loss_bit_equal']})")
    if n != steps or len(losses) != steps or not np.all(np.isfinite(losses)) \
            or not np.all(np.isfinite(gnorms)):
        fail(f"{tag} (c): {n} steps, losses {losses}, grad norms {gnorms}")
    if losses[0] != loss0:
        fail(f"{tag} (c): the first step's loss {losses[0]!r} is not loss_fn's {loss0!r}")
    if saves != [steps]:
        fail(f"{tag} (c): checkpoint saves at {saves}")
    return res


def decode_gap(model, params, cache, tokens, want) -> tuple[torch.Tensor, float]:
    """``model``'s last decode logits over ``tokens`` [B, S] from ``cache``
    (written in place) and their max |d| from ``want``."""
    b, s = tokens.shape
    for t in range(s):
        logits, cache = model.decode_step(params, cache, tokens[:, t],
                                          torch.full((b,), t, device=tokens.device))
    return logits, float((logits - want).abs().max())


def check_encoder_attention(gen) -> dict:
    """Phase 22 (d): whisper's encoder attention at its training shape (B
    4, 1 500 frames, 6 heads of 64, non-causal, chunk 512: the last chunk
    holds 476 real keys and 36 padded): chunked_attention's output and
    its custom backward (dq, dk, dv) against float64 autograd through the
    plain core, each within AUDIO_ATTN_REL of its scale; the padding
    counted as real keys (a planted fault) must exceed the limit."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    cfg = get_config(AUDIO_ARCH)
    f, h, dh = cfg.enc_dec.n_frames, cfg.n_heads, cfg.resolved_head_dim
    dev = torch.device("cuda")
    q, k, v, dout = (torch.randn(AUDIO_TRAIN_BATCH, f, h, dh, generator=gen, device=dev)
                     for _ in range(4))
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = layers.chunked_attention(*leaves, causal=False, chunk=cfg.attn_chunk)
    got = torch.autograd.grad(out, leaves, dout)
    ref_in = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    ref = attention64(*ref_in, causal=False)
    want = torch.autograd.grad(ref, ref_in, dout.double())
    ref = ref.detach()
    errs = dict(out=float((out.detach().double() - ref).abs().max() / ref.abs().max()),
                **grad_rel_errs(got, want))
    padded = [F.pad(t, (0, 0, 0, 0, 0, (-f) % cfg.attn_chunk)) for t in (k, v)]
    with torch.no_grad():
        fault = layers.chunked_attention(q, *padded, causal=False, chunk=cfg.attn_chunk)
    fault_err = float((fault.double() - ref).abs().max() / ref.abs().max())
    ms = cuda_ms(lambda: torch.autograd.grad(
        layers.chunked_attention(*leaves, causal=False, chunk=cfg.attn_chunk), leaves, dout),
        reps=3, inner=1)
    log(f"audio (d) the encoder's attention at B {AUDIO_TRAIN_BATCH}, {f} frames (chunk "
        f"{cfg.attn_chunk}, {(-f) % cfg.attn_chunk} padded keys), H {h}, dh {dh}, float32: "
        f"output and custom backward against float64 autograd, max |d| over max "
        f"{json.dumps(errs)} (limit {AUDIO_ATTN_REL}); the padding counted as keys "
        f"{fault_err:.3e} (must exceed it); forward + backward {ms:.3f} ms")
    if max(errs.values()) > AUDIO_ATTN_REL:
        fail(f"audio (d): the encoder's attention disagrees with float64 autograd: {errs}")
    if fault_err <= AUDIO_ATTN_REL:
        fail(f"audio (d): the limit misses the unmasked padding: {fault_err}")
    return dict(errs=errs, padding_fault=fault_err, fwd_bwd_ms=ms)


def check_reduced_card_vs_cpu(arch: str, gen) -> dict:
    """Phases 22-23 (d): the reduced ``arch`` in float32, its loss_fn and
    prefill (with its frontend stub) on the card against the CPU from the
    same parameters and inputs, within rtol 1e-4."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_reduced_config(arch), compute_dtype="float32")
    card, cpu = build_model(cfg), build_model(cfg, device="cpu")
    params = card.init(torch.Generator("cuda").manual_seed(0))
    cpu_params = copy.deepcopy(params).cpu()
    n, key = ((cfg.vlm.n_patches, "patches") if cfg.family == "vlm"
              else (cfg.enc_dec.n_frames, "frames"))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 17), generator=gen,
                                     device=gen.device),
             key: torch.randn(2, n, cfg.d_model, generator=gen, device=gen.device)}
    host = {k: v.cpu() for k, v in batch.items()}
    with torch.no_grad():
        res = dict(loss_card=float(card.loss_fn(params, batch)[0]),
                   loss_cpu=float(cpu.loss_fn(cpu_params, host)[0]))
    pre = {k: v[:, :16] if k == "tokens" else v for k, v in batch.items()}
    got = card.prefill(params, pre).cpu()
    want = cpu.prefill(cpu_params, {k: v.cpu() for k, v in pre.items()})
    res["prefill_max_abs_err"] = float((got - want).abs().max())
    res["prefill_scale"] = float(want.abs().max())
    log(f"{arch} (d) reduced, float32, card against CPU: loss {res['loss_card']!r} / "
        f"{res['loss_cpu']!r}, prefill max |d| {res['prefill_max_abs_err']:.3e} (scale "
        f"{res['prefill_scale']:.3f}; rtol 1e-4)")
    if abs(res["loss_card"] - res["loss_cpu"]) > 1e-4 * abs(res["loss_cpu"]) \
            or res["prefill_max_abs_err"] > 1e-4 * res["prefill_scale"]:
        fail(f"{arch} (d): the card disagrees with the CPU: {res}")
    return res


def phase_audio(smi: str) -> dict:
    """Phase 22: the audio family, whisper_tiny at full width and depth;
    see the module docstring."""
    import dataclasses

    from repro_torch.configs import get_config, param_count
    from repro_torch.data.pipeline import FrontendPipeline
    from repro_torch.models.model import _cross_kv, _encoder, build_model

    t_phase = time.perf_counter()
    free_card()
    dev = torch.device("cuda")
    full = get_config(AUDIO_ARCH)
    m32 = build_model(dataclasses.replace(full, compute_dtype="float32"))
    params, init_s = synced_seconds(lambda: m32.init(torch.Generator(dev).manual_seed(0)))
    n_params = sum(p.numel() for p in params.parameters())
    # param_count leaves out the norm scales: 2 an encoder layer, 3 a
    # decoder layer, the final one (41 157 888 in all, the reference's init)
    want = param_count(full)[0] + (2 * full.enc_dec.n_encoder_layers + 3 * full.n_layers
                                   + 1) * full.d_model
    if n_params != want:
        fail(f"audio: {n_params} parameters, the reference's init holds {want}")
    out = dict(arch=AUDIO_ARCH, n_params=n_params, init_s=init_s)
    log(f"audio (phase 22): {AUDIO_ARCH} at full width and depth ({full.enc_dec.n_encoder_layers}"
        f" + {full.n_layers} layers, {full.enc_dec.n_frames} frames), {n_params} parameters "
        f"initialised in {init_s:.2f} s; {smi}")
    gen = torch.Generator(dev).manual_seed(1)

    # (a) float32 decode against prefill, the cross cache from the encoder
    b, s = AUDIO_DECODE
    tokens = torch.randint(0, full.vocab_size, (b, s), generator=gen, device=dev)
    frames = torch.randn(b, full.enc_dec.n_frames, full.d_model, generator=gen, device=dev)
    want, prefill_s = synced_seconds(lambda: m32.prefill(params, {"tokens": tokens,
                                                                  "frames": frames}))
    cache, zero = m32.init_cache(b, s), m32.init_cache(b, s)
    with torch.no_grad():
        p = params.tree()           # float32 storage: the compute dtype's tree
        cache["cross"], cross_s = synced_seconds(lambda: _cross_kv(
            m32.cfg, p, _encoder(m32.cfg, p, frames)))
    t0 = time.perf_counter()
    logits, err = decode_gap(m32, params, cache, tokens, want)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / s * 1e3
    _, zero_err = decode_gap(m32, params, zero, tokens, want)
    same = torch.equal(logits.argmax(-1), want.argmax(-1))
    out["f32"] = dict(prefill_s=prefill_s, encoder_cross_s=cross_s, decode_ms=decode_ms,
                      decode_vs_prefill=err, zero_cross_vs_prefill=zero_err,
                      scale=float(want.abs().max()))
    log(f"audio (a) float32, {b} x {s} tokens over {full.enc_dec.n_frames} frames: decode's "
        f"last logits (the cross cache filled by _cross_kv(_encoder(frames)), "
        f"{cross_s * 1e3:.1f} ms) against prefill's max |d| {err:.3e} (scale "
        f"{out['f32']['scale']!r}; rtol 1e-3, atol 1e-4), argmax equal {same}; against the zero "
        f"cross cache (the reference's serving path) {zero_err:.3e}; prefill "
        f"{prefill_s * 1e3:.1f} ms, {decode_ms:.2f} ms a float32 decode step")
    if not torch.allclose(logits, want, rtol=1e-3, atol=1e-4) or not same:
        fail("audio (a): float32 decode does not reproduce prefill's last logits")
    if zero_err <= 100 * err:
        fail("audio (a): the zero cross cache gives prefill's logits: the decoder ignores "
             "the frames")
    del cache, zero, logits, want, m32, p
    free_card()

    # (b) serving in bf16 compute (float32 storage): the cast moves 8 B a
    # parameter; the self cache and the zero cross pair are read
    m16 = build_model(full)
    kv = 2 * full.n_layers * LM_SLOTS * full.n_kv_heads * full.resolved_head_dim * 2
    self_bytes, cross_bytes = kv * LM_MAX_SEQ, kv * full.enc_dec.n_frames
    sv = serve_requests("audio", m16, params, AUDIO_REQUESTS,
                        tick_bounds(8 * n_params, self_bytes + cross_bytes), smi)
    cache = sv.pop("cache")
    held = sum(t.numel() * t.element_size() for t in (*cache["self"].values(), *cache["cross"]))
    zero = all(not c.any() for c in cache["cross"])
    sv.update(self_bytes=self_bytes, cross_bytes=cross_bytes)
    log(f"audio (b) the cache {held} bytes: self {self_bytes}, cross pair {cross_bytes}; the "
        f"cross pair zero after the run {zero} (nothing fills it, as in the reference)")
    if held != self_bytes + cross_bytes or not zero:
        fail(f"audio (b): the cache holds {held} bytes, its cross pair zero {zero}")
    out["serve"] = sv
    del m16, params, cache
    free_card()

    # (c) training: FrontendPipeline's frames through the encoder
    model = build_model(full)
    pipe = FrontendPipeline(full.vocab_size, AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ, seed=0,
                            frontend_key="frames",
                            frontend_shape=(full.enc_dec.n_frames, full.d_model))
    out["train"] = train_apart("audio", model, pipe, AUDIO_TRAIN_STEPS,
                               AUDIO_TRAIN_BATCH * AUDIO_TRAIN_SEQ, smi)
    del model
    free_card()

    # (d) the encoder's attention; the reduced model, card against CPU
    out["attention"] = check_encoder_attention(gen)
    out["reduced"] = check_reduced_card_vs_cpu(AUDIO_ARCH, gen)
    free_card()
    out["phase_s"] = time.perf_counter() - t_phase
    log("audio (phase 22): " + json.dumps(out))
    return out


def phase_vlm(smi: str) -> dict:
    """Phase 23: the vlm family, llava_next_34b at full width; see the
    module docstring."""
    import dataclasses

    from repro_torch.configs import get_config, param_count
    from repro_torch.data.pipeline import FrontendPipeline
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    free_card()
    dev = torch.device("cuda")
    full = get_config(VLM_ARCH)
    n_patches, d = full.vlm.n_patches, full.d_model
    gen = torch.Generator(dev).manual_seed(1)
    out = {"arch": VLM_ARCH}

    # (a) float32 at 8 layers: decode against prefill over the text alone,
    # the patches' prefill, bf16 against float32
    cut = dataclasses.replace(full, n_layers=VLM_F32_LAYERS)
    m32 = build_model(dataclasses.replace(cut, compute_dtype="float32"))
    m16 = build_model(cut)
    dense = build_model(dataclasses.replace(cut, family="dense", compute_dtype="float32"))
    params, init_s = synced_seconds(lambda: m32.init(torch.Generator(dev).manual_seed(0)))
    n_cut = sum(p.numel() for p in params.parameters())
    b, s = AUDIO_DECODE
    text = torch.randint(0, full.vocab_size, (b, s), generator=gen, device=dev)
    alone = dense.prefill(params, {"tokens": text})
    logits, err = decode_gap(m32, params, m32.init_cache(b, s), text, alone)
    same = torch.equal(logits.argmax(-1), alone.argmax(-1))
    patches = torch.randn(1, n_patches, d, generator=gen, device=dev)
    batch = {"tokens": text[:1, :VLM_TEXT], "patches": patches}
    with_patches, f32_s = synced_seconds(lambda: m32.prefill(params, batch))
    bf16, bf16_s = synced_seconds(lambda: m16.prefill(params, batch))
    scale = float(with_patches.abs().max())
    moved = float((with_patches - alone[:1]).abs().max())
    bf16_err = float((bf16.float() - with_patches).abs().max())
    out["f32"] = dict(n_layers=VLM_F32_LAYERS, n_params=n_cut, init_s=init_s,
                      decode_vs_prefill=err, scale=float(alone.abs().max()),
                      patches_prefill_s=f32_s, bf16_prefill_s=bf16_s, patches_moved=moved,
                      bf16_vs_f32=bf16_err, patches_scale=scale)
    log(f"vlm (phase 23): {VLM_ARCH} at full width, {VLM_F32_LAYERS} of {full.n_layers} layers "
        f"({n_cut} parameters, {n_cut * 4 / 1e9:.2f} GB in float32) initialised in "
        f"{init_s:.2f} s; {smi}")
    log(f"vlm (a) float32, {b} x {s} text tokens: decode's last logits against the text-alone "
        f"prefill's max |d| {err:.3e} (scale {out['f32']['scale']!r}; rtol 1e-3, atol 1e-4), "
        f"argmax equal {same}; prefill of {n_patches} patches + {VLM_TEXT} tokens "
        f"{f32_s * 1e3:.1f} ms, its logits {moved:.3e} from the text alone's (scale "
        f"{scale:.3f}); bf16 prefill ({bf16_s * 1e3:.1f} ms) against float32 {bf16_err:.3e} "
        f"(limit {LM_BF16_REL} x scale)")
    if not torch.allclose(logits, alone, rtol=1e-3, atol=1e-4) or not same:
        fail("vlm (a): float32 decode does not reproduce the text-alone prefill's logits")
    if not torch.isfinite(with_patches).all() or moved <= 1e-2 * scale:
        fail("vlm (a): the patches' prefill is not finite or ignores the patches")
    if bf16_err > LM_BF16_REL * scale:
        fail(f"vlm (a): bf16 prefill {bf16_err:.3e} from float32 (scale {scale:.3f})")
    del params, m32, m16, dense, logits, alone
    free_card()

    # (b) full depth in bf16 storage: the patches' prefill, then serving
    m = build_model(dataclasses.replace(full, param_dtype="bfloat16"))
    torch.cuda.reset_peak_memory_stats()
    params, init_s = synced_seconds(lambda: m.init(torch.Generator(dev).manual_seed(0)))
    n_params = sum(p.numel() for p in params.parameters())
    want = param_count(full)[0] + (2 * full.n_layers + 1) * d    # 34 388 917 248
    if n_params != want:
        fail(f"vlm: {n_params} parameters, the reference's init holds {want}")
    init_gib = torch.cuda.max_memory_allocated() / 2**30
    t = n_patches + VLM_TEXT
    layer_params = n_params - full.vocab_size * d * 2 - d
    flops = 2 * layer_params * t + 2 * full.n_layers * full.n_heads * \
        full.resolved_head_dim * t * t + 2 * d * full.vocab_size
    prefill_ms = cuda_ms(lambda: m.prefill(params, batch), reps=3, inner=1)
    out["prefill"] = dict(n_params=n_params, init_s=init_s, init_peak_gib=init_gib,
                          positions=t, ms=prefill_ms, flops=flops,
                          bound_ms=flops / PEAK_BF16_FLOPS * 1e3,
                          param_estimate_bound_ms=2 * n_params * t / PEAK_BF16_FLOPS * 1e3,
                          finite=bool(torch.isfinite(m.prefill(params, batch)).all()))
    log(f"vlm (b) full depth, {n_params} parameters in bf16 ({2 * n_params / 1e9:.2f} GB) "
        f"initialised in {init_s:.2f} s (peak {init_gib:.2f} GiB); prefill of {n_patches} "
        f"patches + {VLM_TEXT} tokens: {prefill_ms:.1f} ms against its bound "
        f"{out['prefill']['bound_ms']:.1f} ms ({flops / 1e12:.1f} TFLOP at "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s: the layers' products, causal attention, one "
        f"head row; 2 x parameters x positions gives "
        f"{out['prefill']['param_estimate_bound_ms']:.1f} ms), finite "
        f"{out['prefill']['finite']}; {smi}")
    if not out["prefill"]["finite"]:
        fail("vlm (b): the full-depth prefill is not finite")
    cache_bytes = 2 * full.n_layers * LM_SLOTS * LM_MAX_SEQ * full.n_kv_heads * \
        full.resolved_head_dim * 2
    sv = serve_requests("vlm", m, params, VLM_REQUESTS, tick_bounds(2 * n_params, cache_bytes),
                        smi)
    sv.pop("cache")
    out["serve"] = sv
    del m, params
    free_card()

    # (c) training at 2 layers: FrontendPipeline's patches before the text
    model = build_model(dataclasses.replace(full, n_layers=VLM_TRAIN_LAYERS))
    pipe = FrontendPipeline(full.vocab_size, VLM_TRAIN_BATCH, VLM_TRAIN_TEXT, seed=0,
                            frontend_key="patches", frontend_shape=(n_patches, d))
    out["train"] = train_apart("vlm", model, pipe, VLM_TRAIN_STEPS,
                               VLM_TRAIN_BATCH * (n_patches + VLM_TRAIN_TEXT), smi)
    del model
    free_card()

    # (d) the reduced model, card against CPU
    out["reduced"] = check_reduced_card_vs_cpu(VLM_ARCH, gen)
    out["phase_s"] = time.perf_counter() - t_phase
    log("vlm (phase 23): " + json.dumps(out))
    return out


# Phase 24: the dry-run tooling against the card.  The steps phases 17
# and 18 measured, counted at their exact shapes on a 1 x 1 mesh.
DRYRUN_SUBPROCESS = ("--arch", "deepseek_7b", "--shape", "decode_32k")


def phase_dryrun(smi: str, lm: dict, train: dict) -> dict:
    """Phase 24: see the module docstring.  ``lm`` and ``train`` are phases
    17's and 18's summaries: their measured medians and held bytes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.cell import make_cell
    from repro_torch.launch.cost import cell_report
    from repro_torch.launch.mesh import LogicalMesh

    t_phase = time.perf_counter()
    one = LogicalMesh((1, 1), ("data", "model"))
    phi4 = train["phi4"]
    cases = {
        "lm_tick": (get_config(LM_ARCH), ShapeConfig("serve_tick", LM_MAX_SEQ, LM_SLOTS, "decode"),
                    lm["tick_ms_median"], lm["tick_held_bytes"]),
        "train_step": (dataclasses.replace(get_config(TRAIN_ARCH), **TRAIN_OPTIONS),
                       ShapeConfig("train_step", TRAIN_SEQ, TRAIN_BATCH, "train"),
                       phi4["step_ms_median_after_first"], phi4["step_held_bytes"]),
    }
    out = {}
    for name, (cfg, shape, median_ms, held) in cases.items():
        t0 = time.perf_counter()
        rep = cell_report(make_cell(cfg, shape, one))
        count_s = time.perf_counter() - t0
        roof, mem, glob = rep["roofline"], rep["memory"], rep["cost_global"]
        bound_ms = roof["bound_time_s"] * 1e3
        out[name] = dict(
            arch=cfg.name, batch=shape.global_batch, seq=shape.seq_len, kind=shape.kind,
            count_s=count_s, flops=glob["flops"], matmul_flops=glob["matmul_flops"],
            bytes=glob["bytes"], compute_ms=roof["compute_s"] * 1e3,
            memory_ms=roof["memory_s"] * 1e3, bound_ms=bound_ms, dominant=roof["dominant"],
            measured_median_ms=median_ms, bound_over_median=bound_ms / median_ms,
            argument_bytes=mem["argument_size_in_bytes"], held_bytes=held,
            peak_live_bytes=mem["peak_live_bytes_global"])
        log(f"dryrun (phase 24) {name}, {cfg.name} {shape.kind} at {shape.global_batch} x "
            f"{shape.seq_len}, counted in {count_s:.2f} s: {glob['flops']:.6e} FLOPs "
            f"({glob['matmul_flops']:.6e} in matmuls), {glob['bytes']:.6e} unfused bytes; "
            f"bound {bound_ms:.3f} ms ({roof['dominant']}; compute "
            f"{out[name]['compute_ms']:.3f}, memory {out[name]['memory_ms']:.3f}) against the "
            f"measured median {median_ms:.3f} ms: ratio {bound_ms / median_ms:.4f}; argument "
            f"bytes {mem['argument_size_in_bytes']} counted, {held} held; {smi}")
        if bound_ms > median_ms:
            fail(f"dryrun {name}: the counted bound {bound_ms:.3f} ms exceeds the measured "
                 f"median {median_ms:.3f} ms: an operation is overcounted")
        if mem["argument_size_in_bytes"] != held:
            fail(f"dryrun {name}: counted argument bytes {mem['argument_size_in_bytes']} are "
                 f"not the {held} bytes the phase holds")

    # the entry point as a user runs it, from a scratch directory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as cwd:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                               *DRYRUN_SUBPROCESS, "--out", "dry"], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
        recs = sorted(Path(cwd, "dry").glob("*.json"))
        rec = json.loads(recs[0].read_text()) if len(recs) == 1 else {}
    out["subprocess"] = dict(rc=proc.returncode, seconds=secs, ok=rec.get("ok"),
                             count_s=rec.get("count_s"),
                             bound_s=rec.get("roofline", {}).get("bound_time_s"),
                             dominant=rec.get("roofline", {}).get("dominant"))
    log(f"dryrun (phase 24) python -m repro_torch.launch.dryrun {' '.join(DRYRUN_SUBPROCESS)}: "
        f"rc {proc.returncode}, {secs:.1f} s, record " + json.dumps(out["subprocess"])
        + f"; {smi}")
    if proc.returncode != 0 or not rec.get("ok") or rec.get("skipped"):
        fail(f"dryrun: the entry point failed: {proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    out["phase_s"] = time.perf_counter() - t_phase
    log("dryrun (phase 24): " + json.dumps(out))
    return out

# phase 25: multi-device training on the single-controller mesh
MD_CPSUM_SHAPE = (8, 1 << 20)     # (a) 8 shards of 1 M float32 each
MD_PIPE = dict(stages=4, n_micro=8, rows=256, width=1024)
MD_MOE_X = (4, 512)               # (b) [B, S] rows of deepseek_v2_lite_16b's d_model
MD_MOE_MESH = (2, 4)              # (b) data x model
MD_MOE_REL = dict(rtol=2e-4, atol=2e-5)   # the reference's EP-against-local tolerance
MD_TRAIN_LAYERS = 2               # (c) phi4_mini_3p8b's depth 32 -> 2
MD_TRAIN_OPTIONS = dict(optimizer_dtype="bfloat16", optimizer_factored=True, grad_accum=2)
MD_TRAIN_BATCH, MD_TRAIN_SEQ, MD_TRAIN_STEPS = 8, 1024, 4
MD_TRAIN_MESH = (2, 2)
# (c) limits against the single-device run, relative: the sharded step
# sums in another order (measured on the H100: losses 9e-6 apart, grad
# norms 3e-5), and half a batch's gradient left out moves either by more
MD_LOSS_REL = 1e-4
MD_GNORM_REL = 1e-4
# the final state, leaf by leaf, |mesh - one device| / max|one device|:
# of the parameters' updates and of the moments.  The moments are bf16:
# two ulps of a leaf's largest element reach 2^-6 of its scale; half a
# batch's gradient left out moves each by about 1 (measured on the CPU at
# the reduced width)
MD_STATE_REL = {"params": 2.0**-5, "m": 2.0**-5, "v": 2.0**-5}


@contextlib.contextmanager
def forced_mesh_devices(n: int):
    """``REPRO_TORCH_MESH_DEVICES=n`` for the block: a mesh sees n shards of
    the visible cards, repeated."""
    from repro_torch.device import MESH_DEVICES_ENV
    prev = os.environ.get(MESH_DEVICES_ENV)
    os.environ[MESH_DEVICES_ENV] = str(n)
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(MESH_DEVICES_ENV, None)
        else:
            os.environ[MESH_DEVICES_ENV] = prev


def check_md_blocks(dev: torch.device) -> dict:
    """Phase 25 (a): compressed_psum on 8 shards of the card against the
    CPU bit for bit and the exact sum within 8 x scale; pipelined over 4
    stages on the card against the sequential apply."""
    from repro_torch.distributed.collectives import Mesh, make_mesh
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.distributed.pipeline import pipelined
    from repro_torch.launch.mesh import DeviceMesh

    rng = np.random.default_rng(25)
    x = rng.normal(size=MD_CPSUM_SHAPE).astype(np.float32)
    with forced_mesh_devices(MD_CPSUM_SHAPE[0]):
        mesh = make_mesh(MD_CPSUM_SHAPE[0], dev)
    shards = [torch.as_tensor(r, device=d_) for r, d_ in zip(x, mesh.devices)]
    got = compressed_psum(mesh, shards)
    want = compressed_psum(Mesh((torch.device("cpu"),) * len(x)), [torch.as_tensor(r) for r in x])
    ranks_equal = all(torch.equal(g.cpu(), got[0].cpu()) for g in got)
    bits_equal = torch.equal(got[0].cpu().view(torch.int32), want[0].view(torch.int32))
    where = sorted({str(d_) for d_ in mesh.devices})
    err = float(np.abs(got[0].cpu().numpy() - x.sum(0, dtype=np.float64)).max())
    scale = float(np.abs(x).max()) / 127.0
    cpsum_ms = cuda_ms(lambda: compressed_psum(mesh, shards))
    out = dict(cpsum=dict(shards=len(x), n=x.shape[1], ranks_equal=ranks_equal,
                          bits_equal_cpu=bits_equal, max_abs_err=err, limit=8 * scale,
                          ms=cpsum_ms))
    log(f"multidevice (a) compressed_psum over {mesh.size} shards of {where} x {x.shape[1]} "
        f"float32: ranks equal {ranks_equal}, bits equal the CPU's {bits_equal}, max |sum - "
        f"exact| {err:.4e} (limit 8 x scale {8 * scale:.4e}); {cpsum_ms:.3f} ms a call")
    if not (ranks_equal and bits_equal) or err > 8 * scale:
        fail("multidevice (a): compressed_psum")

    p = MD_PIPE
    gen = torch.Generator(dev).manual_seed(25)
    params = {"w": torch.randn(p["stages"], p["width"], p["width"], generator=gen, device=dev)
              * p["width"] ** -0.5,
              "b": torch.randn(p["stages"], p["width"], generator=gen, device=dev)}
    xb = torch.randn(p["n_micro"] * p["rows"], p["width"], generator=gen, device=dev)

    def stage(sp, v):
        return torch.tanh(v @ sp["w"] + sp["b"])

    with forced_mesh_devices(p["stages"]):
        pmesh = DeviceMesh((p["stages"],), ("pipe",), make_mesh(p["stages"], dev).devices)
    apply = pipelined(stage, pmesh, n_micro=p["n_micro"])

    def sequential(rows: int) -> torch.Tensor:
        """Every stage in turn, on blocks of ``rows`` rows."""
        outs = []
        for blk in xb.split(rows):
            for s in range(p["stages"]):
                blk = stage({"w": params["w"][s], "b": params["b"][s]}, blk)
            outs.append(blk)
        return torch.cat(outs)

    y = apply(params, xb)
    # the sequential apply a microbatch at a time (the pipeline's matmul
    # shapes: cuBLAS sums a 2 048-row product in another order)
    ref, whole = sequential(p["rows"]), sequential(len(xb))
    err = float((y - ref).abs().max())
    close = bool(torch.allclose(y, ref, rtol=1e-5, atol=1e-6))
    whole_err = float((y - whole).abs().max())
    pipe_ms = cuda_ms(lambda: apply(params, xb))
    seq_ms = cuda_ms(lambda: sequential(p["rows"]))
    out["pipeline"] = dict(**p, max_abs_err=err, close=close, whole_batch_max_abs_err=whole_err,
                           ms=pipe_ms, sequential_ms=seq_ms)
    log(f"multidevice (a) pipelined {p['stages']} stages x {p['n_micro']} microbatches of "
        f"{p['rows']} x {p['width']} on {sorted({str(d_) for d_ in pmesh.devices})}: max |d| {err:.3e} against the sequential apply "
        f"a microbatch at a time (rtol 1e-5, atol 1e-6: {close}; against the whole batch at "
        f"once {whole_err:.3e}); {pipe_ms:.3f} ms, sequential {seq_ms:.3f} ms")
    if not close:
        fail("multidevice (a): pipelined disagrees with the sequential apply")
    return out


def check_md_moe(dev: torch.device) -> dict:
    """Phase 25 (b): deepseek_v2_lite_16b's MoE block at full width on a
    2 x 4 mesh of the card: EP against the local branch at capacity factor
    64 (no token dropped), and at the published 1.25 against the same EP
    code on the CPU.  The router weight and the rows lie on grids (1/64,
    1/4) where every logit is exact in float32 in any summation order, so
    card and CPU route alike."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import use_mesh_rules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.moe import init_moe, moe_block
    from repro_torch.tree import tree_map

    cfg = get_config(MOE_ARCH)
    d, (b, s) = cfg.d_model, MD_MOE_X
    gen = torch.Generator(dev).manual_seed(26)
    params = init_moe(gen, cfg, torch.float32)
    params["router"]["w"] = torch.round(params["router"]["w"] * 64) / 64
    x = torch.round(torch.randn(b, s, d, generator=gen, device=dev) * 4) / 4
    with forced_mesh_devices(math.prod(MD_MOE_MESH)):
        mesh = make_local_mesh(*MD_MOE_MESH, device=dev)
    cpu_mesh = make_local_mesh(*MD_MOE_MESH, device="cpu")
    out = {}
    with torch.no_grad():
        c64 = moe_config(cfg, capacity_factor=64.0)
        y_local, aux_local = moe_block(params, x, c64)
        with use_mesh_rules(mesh):
            y_ep, aux_ep = moe_block(params, x, c64)
        _, aux_first = moe_block(params, x[:b // MD_MOE_MESH[0]], c64)
        err = float((y_ep - y_local).abs().max())
        close = bool(torch.allclose(y_ep, y_local, **MD_MOE_REL))
        load_first = torch.equal(aux_ep["expert_load"], aux_first["expert_load"])
        aux_rel = abs(float(aux_ep["aux_loss"]) / float(aux_first["aux_loss"]) - 1)
        out["cf64"] = dict(max_abs_err=err, scale=float(y_local.abs().max()), close=close,
                           aux_ep=float(aux_ep["aux_loss"]), aux_local=float(aux_local["aux_loss"]),
                           aux_data_shard0=float(aux_first["aux_loss"]),
                           load_is_data_shard0=load_first)
        log(f"multidevice (b) {MOE_ARCH} MoE block at full width ({cfg.moe.n_experts} experts, "
            f"top-{cfg.moe.top_k}, d_model {d}, expert_d_ff {cfg.moe.expert_d_ff}), x [{b}, {s}, "
            f"{d}], mesh {MD_MOE_MESH[0]} data x {MD_MOE_MESH[1]} model on "
            f"{sorted({str(d_) for d_ in mesh.devices})}, capacity "
            f"factor 64: EP against the local branch max |d| {err:.3e} (scale "
            f"{out['cf64']['scale']:.4f}, rtol 2e-4 atol 2e-5: {close}); aux_loss EP "
            f"{out['cf64']['aux_ep']!r}, local {out['cf64']['aux_local']!r}, data shard 0's rows "
            f"alone {out['cf64']['aux_data_shard0']!r}; expert_load data shard 0's {load_first}")
        if not close or not load_first or aux_rel > 1e-5:
            fail("multidevice (b): EP at capacity factor 64 against the local branch")
        del y_local, y_ep

        c125 = cfg                          # the published capacity factor
        with use_mesh_rules(mesh):
            y_card, aux_card = moe_block(params, x, c125)
            ep_ms = cuda_ms(lambda: moe_block(params, x, c125), reps=3, inner=2)
        local_ms = cuda_ms(lambda: moe_block(params, x, c125), reps=3, inner=2)
        y_drop, _ = moe_block(params, x, c125)
        p_cpu, x_cpu = tree_map(lambda t: t.cpu(), params), x.cpu()
        with use_mesh_rules(cpu_mesh):
            y_cpu, aux_cpu = moe_block(p_cpu, x_cpu, c125)
        err = float((y_card.cpu() - y_cpu).abs().max())
        close = bool(torch.allclose(y_card.cpu(), y_cpu, **MD_MOE_REL))
        load_equal = torch.equal(aux_card["expert_load"].cpu(), aux_cpu["expert_load"])
        aux_rel = abs(float(aux_card["aux_loss"]) / float(aux_cpu["aux_loss"]) - 1)
        gap = float((y_card - y_drop).abs().max())
        out["cf125"] = dict(capacity_factor=cfg.moe.capacity_factor, max_abs_err_cpu=err,
                            scale=float(y_cpu.abs().max()), close=close, load_equal=load_equal,
                            aux_rel_err=aux_rel, ep_vs_local_gap=gap, ep_ms=ep_ms,
                            local_ms=local_ms)
        log(f"multidevice (b) capacity factor {cfg.moe.capacity_factor}: EP on {dev} against EP "
            f"on the CPU max |d| {err:.3e} (scale {out['cf125']['scale']:.4f}, rtol 2e-4 atol "
            f"2e-5: {close}), expert_load equal {load_equal}, aux_loss rel {aux_rel:.2e}; EP "
            f"against the local branch max |d| {gap:.4f} (capacity per data shard drops other "
            f"tokens); EP block {ep_ms:.3f} ms, local block {local_ms:.3f} ms")
        if not close or not load_equal or aux_rel > 1e-5:
            fail("multidevice (b): EP at the published capacity factor, card against CPU")
    return out


def run_md_trainer(model, pipe, label: str):
    """``Trainer.run`` for MD_TRAIN_STEPS steps from seed 0 under whatever
    mesh rules are active, its one checkpoint recorded, not written.
    Returns (losses, grad norms, ms a step, peak GiB, the step's replicas
    [(params, opt_state)] a distinct device, the first the run's state)."""
    from repro_torch.train.trainer import Trainer, TrainerConfig
    trainer = Trainer(model, pipe, TrainerConfig(
        n_steps=MD_TRAIN_STEPS, ckpt_every=MD_TRAIN_STEPS, log_every=1,
        ckpt_dir=tempfile.mkdtemp(prefix=f"chip_smoke_{label}_")))
    saves = []
    trainer.ckpt.save = lambda step, tree, blocking=False: saves.append(step)
    torch.cuda.reset_peak_memory_stats()
    walls = []
    try:
        params, opt_state, _ = trainer.run(
            seed=0, callback=lambda s_, m_: walls.append(m_["wall_s"]))
    finally:
        shutil.rmtree(trainer.tcfg.ckpt_dir, ignore_errors=True)
    sync_all()
    if saves != [MD_TRAIN_STEPS]:
        fail(f"multidevice (c) {label}: checkpoint saves at {saves}")
    replicas = trainer.train_step.replicas()
    if replicas[0][0] is not params or replicas[0][1] is not opt_state:
        fail(f"multidevice (c) {label}: the step's replica 0 is not the run's state")
    step_ms = [1e3 * (b_ - a_) for a_, b_ in zip([0.0] + walls[:-1], walls)]
    return ([m_["loss_mean"] for m_ in trainer.metrics_log],
            [m_["grad_norm"] for m_ in trainer.metrics_log], step_ms,
            torch.cuda.max_memory_allocated() / 2**30, replicas)


def md_state_leaves(params, opt_state) -> dict:
    """{"params", "m", "v"}: the state's tensors in the reference's leaf
    order (a factored second moment's row and column means among v's)."""
    from repro_torch.tree import tree_leaves
    return {"params": tree_leaves(params.reference_tree()), "m": tree_leaves(opt_state.m),
            "v": tree_leaves(opt_state.v)}


def md_check_replicas(label: str, mesh, replicas) -> int:
    """Every data replica's parameters and optimizer state against replica
    0's, bit for bit, with one replica a distinct card among the data
    shards' first devices.  Returns the number of replicas."""
    from repro_torch.distributed.collectives import same_device
    homes = []
    for d_ in range(mesh.shape["data"]):
        h = mesh.device(data=d_, model=0)
        if not any(same_device(h, e) for e in homes):
            homes.append(h)
    if len(replicas) != len(homes) or not all(
            same_device(r[0].embedding.device, h) for r, h in zip(replicas, homes)):
        fail(f"multidevice (c) {label}: {len(replicas)} replicas for the data shards' "
             f"devices {[str(h) for h in homes]}")
    want = md_state_leaves(*replicas[0])
    for r, (p, st) in enumerate(replicas[1:], start=1):
        if st.step != replicas[0][1].step:
            fail(f"multidevice (c) {label}: replica {r} at step {st.step}")
        for kind, leaves in md_state_leaves(p, st).items():
            for i, (a, b) in enumerate(zip(leaves, want[kind], strict=True)):
                if not torch.equal(a.to(b.device), b):
                    fail(f"multidevice (c) {label}: replica {r}'s {kind} leaf {i} differs "
                         f"from replica 0's")
    return len(replicas)


def md_state_gaps(got: dict, want: dict, init: list) -> dict:
    """Per kind, the largest |got - want| / max|want| over its leaves, of
    the parameters' updates (from ``init``) and of the moments (which
    start at 0); ``want``'s and ``init``'s leaves on the host, compared
    on ``got``'s device."""
    out = {}
    for kind, leaves in want.items():
        worst = 0.0
        for i, (a, b) in enumerate(zip(got[kind], leaves, strict=True)):
            a, b = a.detach().float(), b.to(a.device, non_blocking=True).float()
            if kind == "params":
                p0 = init[i].to(a.device, non_blocking=True).float()
                a, b = a - p0, b - p0
            scale = max(float(b.abs().max()), 1e-30)
            worst = max(worst, float((a - b).abs().max()) / scale)
        out[kind] = worst
    return out


def check_md_train(dev: torch.device, smi: str) -> dict:
    """Phase 25 (c): phi4_mini_3p8b at full width and 2 layers through
    launch.train's path on a 2 x 2 mesh of the card (make_local_mesh under
    REPRO_TORCH_MESH_DEVICES=4, the Trainer under use_mesh_rules) against
    the single-device Trainer on the same batches; with four or more cards
    also on a mesh of four real cards."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import DEFAULT_RULES, use_mesh_rules
    from repro_torch.launch.mesh import DeviceMesh, make_local_mesh
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=MD_TRAIN_LAYERS,
                              **MD_TRAIN_OPTIONS)
    model = build_model(cfg, device=dev)
    pipe = TokenPipeline(cfg.vocab_size, MD_TRAIN_BATCH, MD_TRAIN_SEQ, seed=0)
    tokens = MD_TRAIN_BATCH * MD_TRAIN_SEQ
    out = {}
    n = math.prod(MD_TRAIN_MESH)
    if torch.cuda.device_count() == 1:      # launch.train's mesh on a one-card machine
        with forced_mesh_devices(n):
            one_card = make_local_mesh(*MD_TRAIN_MESH, device=dev)
    else:                                   # there the variable would name every card
        one_card = DeviceMesh(MD_TRAIN_MESH, ("data", "model"), (dev,) * n)
    runs = [("one_device", None), ("mesh_one_card", one_card)]
    if torch.cuda.device_count() >= n:
        runs.append(("mesh_cards", make_local_mesh(*MD_TRAIN_MESH, device=dev)))
    # the Trainer's initial parameters (seed 0), kept on the host
    init = [t.to("cpu") for t in
            tree_leaves(model.init(torch.Generator(dev).manual_seed(0)).reference_tree())]
    for label, mesh in runs:
        free_card()
        collectives.COPIED_BYTES["bytes"] = 0
        with use_mesh_rules(mesh, DEFAULT_RULES):      # None: no rules
            losses, gnorms, step_ms, peak, replicas = run_md_trainer(model, pipe, label)
        state = md_state_leaves(*replicas[0])
        if mesh is None:                               # the reference, kept on the host
            want_state = {k: [t.detach().to("cpu") for t in v] for k, v in state.items()}
            gaps, n_replicas = None, 1
        else:
            n_replicas = md_check_replicas(label, mesh, replicas)
            gaps = md_state_gaps(state, want_state, init)
        del replicas, state
        steady = float(np.median(step_ms[1:]))
        out[label] = dict(mesh=None if mesh is None else dict(mesh.shape),
                          devices=None if mesh is None else [str(d_) for d_ in mesh.devices],
                          losses=losses, grad_norms=gnorms, step_ms=step_ms,
                          step_ms_median_after_first=steady,
                          tokens_per_s=tokens / (steady * 1e-3), peak_gib=peak,
                          collective_bytes_per_step=collectives.COPIED_BYTES["bytes"]
                          / MD_TRAIN_STEPS, replicas=n_replicas,
                          state_rel_to_one_device=gaps)
        log(f"multidevice (c) {TRAIN_ARCH} at full width, {MD_TRAIN_LAYERS} layers, "
            f"{json.dumps(MD_TRAIN_OPTIONS)}, batch {MD_TRAIN_BATCH} x {MD_TRAIN_SEQ}, {label}"
            + ("" if mesh is None else f" (mesh {dict(mesh.shape)} on "
               f"{sorted({str(d_) for d_ in mesh.devices})})")
            + f": losses {json.dumps(losses)}, grad norms {json.dumps(gnorms)}; ms a step "
            f"{json.dumps([round(v, 1) for v in step_ms])} (median after the first "
            f"{steady:.1f}: {out[label]['tokens_per_s']:.1f} tokens/s); peak {peak:.2f} GiB; "
            f"collectives {out[label]['collective_bytes_per_step']:.6e} bytes a step between "
            f"shards; {smi}")
        if len(losses) != MD_TRAIN_STEPS or not np.all(np.isfinite(losses)) \
                or not np.all(np.isfinite(gnorms)):
            fail(f"multidevice (c) {label}: losses {losses}, grad norms {gnorms}")
    want = out["one_device"]
    for label, _ in runs[1:]:
        got = out[label]
        rel = {k: [abs(a / b - 1) for a, b in zip(got[k], want[k], strict=True)]
               for k in ("losses", "grad_norms")}
        got["loss_rel_to_one_device"] = rel["losses"]
        got["grad_norm_rel_to_one_device"] = rel["grad_norms"]
        log(f"multidevice (c) {label} against the single-device Trainer: relative gaps of "
            f"the losses {json.dumps(rel['losses'])} (limit {MD_LOSS_REL}), of the grad norms "
            f"{json.dumps(rel['grad_norms'])} (limit {MD_GNORM_REL}); the final state's gaps "
            f"by leaf scale {json.dumps(got['state_rel_to_one_device'])} (limits "
            f"{json.dumps(MD_STATE_REL)}); {got['replicas']} replicas equal bit for bit")
        if max(rel["losses"]) > MD_LOSS_REL or max(rel["grad_norms"]) > MD_GNORM_REL \
                or any(got["state_rel_to_one_device"][k] > v for k, v in MD_STATE_REL.items()):
            fail(f"multidevice (c): {label} parts from the single-device run")
    return out


def phase_multidevice(smi: str) -> dict:
    """Phase 25: see the module docstring."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    free_card()
    out = {"blocks": check_md_blocks(dev)}
    free_card()
    out["moe"] = check_md_moe(dev)
    free_card()
    out["train"] = check_md_train(dev, smi)
    free_card()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"multidevice (phase 25) {out['phase_s']:.1f} s: " + json.dumps(out) + f"; {smi}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-iter", type=int, default=1000,
                    help="descent steps of both fits (default: 1000, the estimator's)")
    ap.add_argument("--exaggeration-iters", type=int, default=250,
                    help="exaggerated steps of both fits (default: 250, the estimator's)")
    ap.add_argument("--kl-every", type=int, default=50)
    ap.add_argument("--sharded-only", action="store_true",
                    help="phases 1, 2, 5 (phase 13's input, untraced) and 13 alone, for a "
                         "machine with several cards; no kernels line")
    ap.add_argument("--mouse-only", action="store_true",
                    help="phases 1, 2, 14 and 15 (at the mouse embedding alone), for "
                         "iterating on the million-point pipeline; no kernels line")
    ap.add_argument("--lm-only", action="store_true",
                    help="phases 1, 2 and 17 (the LM serving path at full width and the "
                         "LM atlas), for iterating on it; no kernels line")
    ap.add_argument("--train-only", action="store_true",
                    help="phases 1, 2 and 18 (the LM training path, phi4_mini_3p8b at full "
                         "width), for iterating on it; no kernels line")
    ap.add_argument("--moe-only", action="store_true",
                    help="phases 1, 2 and 19 (the MoE family, deepseek_v2_lite_16b at full "
                         "width), for iterating on it; no kernels line")
    ap.add_argument("--recurrent-only", action="store_true",
                    help="phases 1, 2, 20 and 21 (the ssm and hybrid families, rwkv6_3b and "
                         "zamba2_2p7b at full width and depth); no kernels line")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="phases 1, 2, 17, 18 and 24 (the dry-run's counted bounds against "
                         "the LM phases' measured steps); no kernels line")
    ap.add_argument("--multimodal-only", action="store_true",
                    help="phases 1, 2, 22 and 23 (the audio and vlm families, whisper_tiny "
                         "and llava_next_34b at full width); no kernels line")
    ap.add_argument("--multidevice-only", action="store_true",
                    help="phases 1, 2 and 25 (multi-device training on four shards of the "
                         "card: compressed_psum, the pipeline, the MoE EP block, phi4_mini_3p8b "
                         "on a 2 x 2 mesh); no kernels line")
    args = ap.parse_args()

    t_run = time.perf_counter()
    smi = phase_device()
    from repro_torch.data.datasets import make_dataset
    from repro_torch.kernels import ops
    build_logs = phase_build()

    if args.recurrent_only or args.lm_only or args.train_only or args.moe_only \
            or args.multimodal_only or args.dryrun_only or args.multidevice_only:
        if args.multidevice_only:
            phase_multidevice(smi)
        elif args.dryrun_only:
            phase_dryrun(smi, phase_lm(smi), phase_train(smi))
        elif args.recurrent_only:
            phase_recurrent(smi, SSM_ARCH)
            phase_recurrent(smi, HYBRID_ARCH)
        elif args.multimodal_only:
            phase_audio(smi)
            phase_vlm(smi)
        else:
            (phase_lm if args.lm_only else phase_train if args.train_only else phase_moe)(smi)
        log(f"chip_smoke: {time.perf_counter() - t_run:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if args.mouse_only:
        _, _, _, mouse_run = phase_mouse()
        phase_naive("mouse_1p3m, the fit's final embedding",
                    torch.as_tensor(mouse_run.y).cuda(), mouse_run.graph)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    x_np, labels = make_dataset("mnist")
    x = torch.as_tensor(x_np).cuda()
    perplexity = 30.0
    fit_steps = (args.n_iter, args.exaggeration_iters, args.kl_every)
    if args.sharded_only:
        bh_est, _ = phase_fit(x_np, "barnes_hut", *fit_steps)
        phase_sharded(bh_est, x, x_np, mouse_sample(bh_est.n_neighbors_), args)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    # phase 16 first: late in a long run, torch.profiler on the card's
    # machine has recorded no kernel event at all (phase 14's device times)
    contracts = phase_contracts(smi, build_logs)
    # phases 17-23 next, while the card is empty: their models hold
    # 27.6 GB, 15.3 GB (with its optimizer, gradients and activations
    # ~55 GiB), 62.8 GB, 12.3 GB, 9.7 GB, 0.16 GB and 68.8 GB (llava at
    # full depth in bf16)
    lm = phase_lm(smi)
    train = phase_train(smi)
    phase_moe(smi)
    phase_recurrent(smi, SSM_ARCH)
    phase_recurrent(smi, HYBRID_ARCH)
    phase_audio(smi)
    phase_vlm(smi)
    phase_dryrun(smi, lm, train)
    phase_multidevice(smi)
    rows = phase_kernels(x, int(3 * perplexity), perplexity)
    phase_gradient(x)

    bh_est, bh_launches = phase_fit(x_np, "barnes_hut", *fit_steps, trace=True)
    check_launches("barnes_hut", bh_launches, BH_KERNELS,
                   ("morton_encode", "attractive_ell", "bh_traverse"), bh_est.n_iter_)
    rows.append(phase_traverse(bh_est))
    phase_breakdown(bh_est)
    est, fft_launches = phase_fit(x_np, "fft", *fit_steps, trace=True)
    check_launches("fft", fft_launches, FFT_KERNELS,
                   ("attractive_ell", "fft_spread", "fft_gather"), est.n_iter_)
    check_reproducible(est)
    fft_breakdown = phase_fft_breakdown(est)

    _, mouse = phase_approx_knn(int(3 * perplexity))
    est_rp, est_ex = phase_approx_fit(x_np, *fit_steps)
    phase_transform(est_rp, x_np, labels)
    service = phase_service(est_rp, est_ex, x_np)
    sharded_launches, sharded_extra = phase_sharded(bh_est, x, x_np, mouse, args)
    del mouse
    _, mouse_launches, mouse_extra, mouse_run = phase_mouse(perplexity)
    naive = dict(mnist=phase_naive("MNIST, the BH fit's embedding",
                                   torch.as_tensor(bh_est.embedding_).cuda(),
                                   bh_est.neighbor_graph_),
                 mouse=phase_naive("mouse_1p3m, the fit's final embedding",
                                   torch.as_tensor(mouse_run.y).cuda(), mouse_run.graph))
    log("naive vs optimised, speedups (build, attractive): " + json.dumps(
        {k: [v["build_speedup"], v["attractive_speedup"]] for k, v in naive.items()}))

    unlaunched = [k for k in ops.LAUNCHES if bh_launches[k] + fft_launches[k] == 0]
    if unlaunched:
        fail(f"neither fit launched {unlaunched}")
    for r in rows:
        path = "barnes_hut" if r["name"] in BH_KERNELS else "fft"
        r["path"] = path
        r["launches"] = (bh_launches if path == "barnes_hut" else fft_launches)[r["name"]]
        if r["name"] in ("pairwise_sq_dists", "bsp_search"):
            r["service_launches"] = service["launches"].get(r["name"], 0)
        if r["name"] in ("fft_spread", "fft_gather"):
            r["fitted_device_ms"] = fft_breakdown[f"{r['name'][4:]}_device_ms"]
        r["sharded_launches"] = sharded_launches[r["name"]]
        r.update(sharded_extra.get(r["name"], {}))
        r["mouse_launches"] = mouse_launches[r["name"]]
        r.update(mouse_extra.get(r["name"], {}))
        r["launch_contract"] = contracts[r["name"]]
        if r["name"] in BH_KERNELS:
            r["lm_atlas_launches"] = lm["atlas_launches"][r["name"]]
            r["lm_atlas_max_abs_err"] = lm["atlas_max_abs_err"][r["name"]]
    log(f"chip_smoke: {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
