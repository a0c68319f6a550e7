#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA H100.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``.
2. Kernel checks: hold each kernel against its plain PyTorch version on the
   card (quant_matmul bit for bit at qwen2-0.5b's seven projections for M =
   1, 8, 16, 37, 64, 65, 512 (the fleet loop's) and 4096, both sides of
   its regime bound, at
   recurrentgemma-2b's for M = 2 and 2048, at ragged edges of both regimes
   (M, K, N = 37, 100, 200 and 8, 4864, 200 split; 4096, 912, 200, 65,
   1040, 100 and 8, 144, 4100 wgmma) and at falcon-mamba's head, each with
   w_q held K-major and contiguous, its split calls alternating on two
   streams and its refusal to make a workspace inside a graph capture;
   flash_attention and flash_decode within 2e-5 in f32 and 2e-2 in bf16,
   mamba_scan and rglru_scan within 1e-4 in f32 on y and the last state,
   as the JAX package's kernel tests), including GQA cases in which h % HK
   and h // G give different answers, mamba_scan also at N = 4, 8, 16, 32
   and 5, S no multiple of its 32-step chunk and a bf16 u, flash_attention
   at B = 1 x 512 tokens (the fleet loop's, also in the model's layout),
   at head_dim 128 (causal and not, 40 and 512 tokens), MQA at head_dim 256 with a window
   of 2048 over 2304 positions and over a wrapped ring, at MLA's head dims
   (q/k 192 with v 128, and 48 with 32: 16 heads over 16 and over 4 kv
   heads, 40, 100 and 512 tokens, causal and not, window None and 64, f32
   and bf16, views of (B, S, H, D) tensors), flash_decode's
   split edges (a window of 96 in a wrapped 2048-slot ring, C = 200, G = 1,
   2, 7, 10 and 20), its split calls alternating on two streams (a
   workspace each) and its refusal to make a workspace inside a CUDA graph
   capture, and ragged scan lengths; rglru_scan in each regime of its plan
   (one chunk, 1 x 1 x 100; a walk of 32 chunks over one tile, 1 x 8192 x
   32; ragged tiles and chunks, 3 x 4099 x 2600 and 6 x 1000 x 2600, in
   8-warp and 4-warp chunks) and at the paths' shapes
   (RS_PATHS), two calls and two replays of a CUDA graph bit for bit;
   the cross-attention families' shapes: flash_attention without a mask
   at Sq != Skv (64/8 heads of 128 over 1601 media tokens at Sq = 1, 40
   and 512; 20/20 heads of 64 over 1500 frames at Sq = 1 and 448;
   whisper's encoder at Sq = Skv = 1500; a GQA case whose h % HK and h //
   G differ), flash_decode at G = 1 (20/20, D 64) over 448-slot rings and
   over full cross caches at pos = C - 1 (C 1601, D 128, G 8; C 1500, D
   64, G 1), and quant_matmul bit for bit at both families' w8 shapes.
   The training path's kernels (FA_BWD_CASES, f32 and bf16): the forward's
   log-sum-exp against the plain one within FA_TOL, and the backward
   kernel's dq, dk and dv against the plain backward (f32: within 2e-5 of
   each gradient's largest magnitude, both f32 versions also measured
   against the plain backward in f64; bf16: within 2e-2), two runs equal
   bit for bit, at qwen2-0.5b's training shape (8 x 14/2 x 512, D 64,
   causal), qwen3-0.6b's 16/8 heads at D 128, a window of 64 over 512,
   whisper's cross shape (448 queries over 1500 frames, no mask), ragged
   tiles, deepseek-v2-lite-16b's MLA training attention (4 x 16/16 x 512 at
   (D, Dv) = (192, 128)), GQA 16/4 at (192, 128) and the reduced (48, 32)
   ragged, causal and unmasked at Sq != Skv, each line naming the
   kernel's split (chunk, longest block, workspace slots); the split at
   least halving qwen2's longest dK/dV walk and leaving shapes that fill
   the card whole; a NaN in q giving NaN in the forward's output and lse
   and in the gradients exactly where the plain version gives it (f32 and
   bf16); its GQA map (kv head h % HK, not h // G); ``FlashAttentionFn``
   under autograd equal to the direct calls with one launch each; and
   recurrentgemma-2b's (256, 256) instance (its f32 sums in a device-memory
   workspace) at its train shape (4 x 10/1 x 512 under the 2048 window), a
   window of 64, ragged 40 over 100 unmasked and GQA 4/2. The scans'
   backward kernels: mamba_scan's (MS_BWD_CASES: the sweep's shapes and
   falcon-mamba-7b's train shape 4 x 512 x 8192, N 16) and rglru_scan's
   (RS_BWD_CASES: each regime of its plan and the paths', 4 x 512 x 2560
   the train shape), each with and without a gradient on the last state,
   within 2e-5 of each gradient's largest magnitude of the plain backward,
   two runs equal bit for bit, the forward's chunk-start states leaving
   its outputs as they were; ``MambaScanFn`` and ``RglruScanFn`` under
   autograd equal to the direct calls with one launch each. Phase 1 prints
   each backward instance's registers and spills.
3. Main path: full-width qwen2-0.5b (random weights from torch.Generator
   seed 0) served by ``SplitServingEngine``: 8 requests x 512 tokens for
   each version (bf16, w8, w4) at cuts 1, 12 and 24, with the kernels'
   launch counts read around the run (24 flash_attention launches per
   infer; 168 quant_matmul launches per w8 infer, 0 otherwise).
3a. Closed loop (the paper's): ``make_tpu_env(["qwen2-0.5b"], seq_len=512)``
   builds its tables on the card, equal to the CPU-built tables exactly;
   A2C trains on the card (60 updates of 8 envs x 96 slots, every loss
   finite, mean reward of the last 15 updates above the first 15, time per
   update printed); the trained weights, copied to the CPU, decide as on the
   card on 16 measured states, where ``price_actions`` on the card agrees
   with ``xp=numpy`` within 1e-6; then 6 slots of decide ->
   ``resolve_selection`` -> ``SplitServingEngine.infer`` (phase 3's engine)
   on 8 x 512 tokens -> ``env_step``, each slot's measured bytes equal to the
   table's (cut_bytes x batch, plus batch x seq x 4 of row scales for w8),
   24 flash_attention launches an infer and 168 quant_matmul launches a w8
   infer (else 0), logits finite; when the controller picks no w8, the w8
   version at greedy_oracle's cut is served too. ``decide`` is timed (median
   of 20, eager) and each slot's infer.
3c. Fleet loop: the ``tpu-execute`` preset's world (2 devices, Poisson 100
   rps a device, 1 s slots, SLO 0.05 s, 2,000 requests, seed 0) at full
   width, ``make_tpu_env(["qwen2-0.5b"] * 2, seq_len=512)`` on the card.
   An ``A2CPolicy`` trains on the card through ``make_task_sampler`` of the
   preset's training trace (30 updates of 8 envs, losses finite). For
   greedy_oracle, device_only, full_offload and a2c, ``simulate`` decides
   on the card each epoch and ``ExecuteBackend`` (sample 8, seq 512) serves
   sampled requests through phase 3's engine: bytes at the cut exact,
   logits finite, 24 flash_attention launches an executed infer (a warm and
   a timed infer a sample) and 168 quant_matmul launches a w8 infer (else
   0; when no policy picks w8, the w8 version at greedy_oracle's cut runs
   as a fifth policy); its SimResult equals the CPU's (tables on the CPU,
   ``AnalyticalBackend``, a2c weights copied) bit for bit, and the
   vectorized engine's on the card. Then ``paper-mmpp-burst`` with the
   three static policies on seeds 0, 2 and 4 at 20,000 requests, card
   equal to CPU bit for bit. Printed: wall time, epochs and simulated
   requests a second for each run, the median decide (measured_state +
   act + host copy, ``SimResult.decide_s`` of those runs) on the card and
   the CPU, each sample's wall time and
   the latency ratios (reported, not checked), the card's name and power
   limit.
3d. Drift loop: PPO (``core/ppo``) trains on the card on phase 3a's env (60
   updates of 8 envs, 4 surrogate passes each; losses finite, mean reward
   of the last 15 updates above the first 15, time per update printed); its
   decisions equal the CPU's on 16 measured states and 6 of them are served
   through phase 3's engine as in 3a (a w8 slot always). Then phase 3c's
   world (2 devices at full width, Poisson 100 rps a device, 1 s slots,
   analytical pricing) under ``link-brownout`` (onset epoch 30, recovery
   60, 18,000 requests): device_only, full_offload, greedy_oracle and 3c's
   A2C frozen, card = CPU bit for bit with ``adaptation`` (per-regime
   reward, oracle, regret, recovery epochs); the same A2C adapted online at
   the preset's ``OnlineConfig`` on the card and on the CPU: updates > 0,
   decisions equal through the first update, the parameters after it
   within 1e-5 (absolute plus relative), the frozen agent untouched; the
   rest and the ms per online update and per decide, card and CPU,
   reported. Host synchronizations an epoch are counted by torch's sync
   debug mode over an always-adapting run. The adapted agent of the
   brownout and of the recovered regime each decides a measured state
   drawn within that regime's bounds, served through phase 3's engine
   (bytes exact, launches counted); whether the cut moves is printed.
3e. Cluster loop: the ``edge-cluster`` preset's world (8 devices,
   hetero-4 x near-far x hysteresis) built on the card, the routers and
   baselines deciding on the card, card = CPU and vectorized = loop bit for
   bit at seeds 0-2; a routing A2C trained on the card (60 updates); then
   ``cluster-brownout`` at 60,000 requests x seeds 0-1, the routers and that
   A2C frozen card = CPU bit for bit, and the A2C adapted online against its
   CPU run. No kernel launches.
3f. Scan engine (``sim.megafleet.simulate_scan``): the ``megafleet``
   preset's world as defined (100,000 devices, diurnal 2 -> 8 rps a
   device, 1 s slots, SLO 1 s, 5,000,000 requests, seed 0) built on the
   card. For device_only, full_offload and greedy_oracle: the scan on the
   card twice (identical), on the CPU, and the vectorized engine deciding
   on the card; epochs, served, epoch-log arrivals and selection totals
   exact (the statics' histograms too), SLO attainment within 0.05, mean
   latency within 15 % and energy within 1 % (greedy_oracle's selection
   shares within 0.05; where two runs' server-queue paths part, epoch by
   epoch at an equal queue); zero host synchronizations inside the epoch
   loop (torch's sync debug mode, from one decide to the next), launches
   an epoch and the device busy time (``torch.profiler``), peak card
   memory, wall time, epochs/s and simulated requests/s of each engine.
   Then ``diurnal-fleet`` at 15,000 requests: device_only and an A2C
   trained on the card (10 updates) under the scan; the timeline on all
   three engines, each SimResult bit-identical with it on and off, the
   scan's percentile columns NaN and its arrivals the vectorized engine's,
   the file written and read back; ``cluster-brownout`` (60,000 requests,
   seed 0) with the timeline on: per-server series, autoscale
   annotations, SimResult bit-identical on and off. No kernel launches.
3g. A fleet of mixed models under the controller: ``make_tpu_env(
   ["qwen2-0.5b", "qwen3-0.6b", "starcoder2-3b"], seq_len=512)`` built on
   the card, every table equal to the CPU-built one exactly; ``simulate``
   over the ``tpu-execute`` world's traffic (2,000 requests, seed 0) for
   greedy_oracle, device_only and full_offload, device i serving model i,
   with ``ExecuteBackend`` (sample 4) over three full-width engines (phase
   3's qwen2 engine and two built here from seed 0). An epoch executes the
   request of its first device, so each policy runs three times with the
   devices' models rotated and every model takes that turn: each sampled
   request's bytes at the cut equal its own model's table entry, its
   launches follow its model's layer count (2 infers a sample), and each
   SimResult equals the CPU's (tables on the CPU, ``AnalyticalBackend``)
   bit for bit. When no policy picks w8, the w8 version at greedy_oracle's
   cut runs as a fourth policy, so quant_matmul runs for every model.
3h. The simulate CLI with no --scenario (``launch.simulate.main``, CLI_ARGV):
   the ad-hoc tpu world of 2 devices over mixtral-8x22b (400 requests,
   device_only and greedy_oracle, seed 0), its tables on the card and the
   sampled requests executed through reduced mixtral on the card: act
   bytes at the cut exact, launches those of the executed infers; the same
   argv with ``--device cpu`` gives every summary number identically. Then
   the same run over deepseek-v2-lite-16b (CLI_ARGV_MLA): reduced MLA on
   the card, its prefill attention through flash_attention's (48, 32)
   instance.
3b. Decode serving: ``ServingEngine`` generates 64 tokens greedily for
   8 x 512-token prompts (cache_len 576), 24 flash_attention launches per
   prefill and 24 flash_decode launches per decode step; one more generate
   on the w8 version (168 quant_matmul launches per prefill and per step);
   then ``ContinuousBatchingServer`` (max_batch 8, cache_len 512) serves 16
   requests of 64-256 prompt tokens and 16-48 new tokens, with 24
   flash_decode launches per decode step; a same-prompt cohort gives the
   engine's tokens.
4. Split equals full: ``split_forward`` against ``forward_logits`` at cut 12.
5. Card against CPU: the same port and weights with ``device="cpu"``, one
   128-token request per version at cut 12; then one 128-token request
   decoded for 16 tokens on the card, with the CPU's prefill and
   decode_step fed the card's tokens, logits compared step by step.
6. The second model, full-width full-depth falcon-mamba-7b (Mamba-1,
   7,272,665,088 parameters, f32, random weights from torch.Generator seed
   0): ``SplitServingEngine`` for bf16/w8/w4 at cuts 1, 32 and 64 on 2 x
   512 tokens (64 mamba_scan launches per infer, one quant_matmul per w8
   infer: the untied lm_head), split equals full at cut 32; then
   ``ServingEngine.generate`` of 32 tokens (64 mamba_scan launches in the
   prefill, none in the decode steps), teacher-forced ``decode_step``
   logits against the card's ``forward_logits``, and
   ``ContinuousBatchingServer`` with 4 requests of 64-200 prompt tokens
   (ragged left-padded prefills through the kernel); card against CPU at
   full width and depth 2 (split logits per version at cut 1, then 8
   decode steps). The model is freed when these phases end.
8. The third model, full-width full-depth recurrentgemma-2b (Griffin
   hybrid: 26 layers as 8 (rec, rec, attn) periods plus a 2-layer rec
   tail, MQA with head_dim 256 and a local window of 2048, GeGLU;
   2,894,574,080 parameters, f32, random weights from torch.Generator seed
   0): ``SplitServingEngine`` for bf16/w8/w4 at cuts ('period', 1),
   ('period', 4) and ('tail', 2) on 4 x 512 tokens (18 rglru_scan and 8
   flash_attention launches per infer, 110 quant_matmul per w8 infer),
   split equals full at ('period', 4), peak memory.
8b. Its decode: ``ServingEngine.generate`` of 32 tokens for 2 x 2304-token
   prompts, past the window (the prefill's flash_attention masks keys older
   than 2048, the rings of 2048 slots wrap; 18 rglru_scan and 8
   flash_attention launches in the prefill, 8 flash_decode and no
   rglru_scan per decode step), teacher-forced ``decode_step`` logits
   against the card's ``forward_logits``, and ``ContinuousBatchingServer``
   with 8 requests of 64-256 prompt tokens (ragged cohorts through the
   kernel).
8c. Card against CPU at full width and depth 5 (one period and the tail):
   split logits per version at ('period', 1), then 8 decode steps. The
   model is freed when these phases end.
9, 9b, 9c. The dense families at full width and full depth, f32, random
   weights from torch.Generator seed 0, one after another, each freed
   before the next: qwen3-0.6b (28 layers, d_model 1024, 16/8 heads of 128
   with qk_norm, SwiGLU 3072, tied; 596,049,920 parameters), starcoder2-3b
   (30 layers, d_model 3072, 24/2 heads of 128, LayerNorm, the plain gelu
   MLP of 12,288, QKV, o and MLP biases, window 4096, untied; 3,181,366,272
   parameters) and phi3-medium-14b (40 layers, d_model 5120, 40/10 heads of
   128, SwiGLU 17,920, untied head of 100,352; 14,659,507,200 parameters).
   ``SplitServingEngine`` for bf16/w8/w4 at three cuts (qwen3 8 x 512 at
   cuts 1, 14, 28; starcoder2 4 x 512 at 1, 15, 30; phi3 2 x 512 at 1, 20,
   40), each version's model built only while it serves (phi3's f32 model
   and its w8 copy fit the card together, all three do not): one
   flash_attention launch a layer an infer, quant_matmul 196, 181 and 281
   a w8 infer (7 or 6 projections a layer, plus an untied head), bytes at
   the cut exact, split equals full at the middle cut, peak memory; then
   ``ServingEngine.generate`` (qwen3 8 x 512 prompts, 64 new tokens;
   starcoder2 1 x 4608, 33 new, past its window over a wrapped 4096-slot
   ring; phi3 2 x 512, 32 new) with one flash_decode launch a layer a
   step, teacher-forced ``decode_step`` logits against the card's
   ``forward_logits``, qwen3's ``ContinuousBatchingServer`` (16 requests of
   64-256 tokens in 8 slots), and card against CPU at full width and depth
   2 (split logits per version at cut 1, then 8 decode steps). Each
   phase's seconds are printed.
9d. mixtral-8x22b through the same phases at its published widths (d_model
   6144, 48/8 heads of 128, 8 experts of d_ff 16,384, top-2, capacity
   factor 1.25, window 4096, untied head of 32,768), its depth cut to 4 of
   56 layers (10,418,903,040 parameters, 41.7 GB f32): split 1 x 2048 at
   cuts 1, 2, 4 (two 1024-token MoE chunks, C = 320; 4 flash_attention an
   infer, 17 quant_matmul a w8 infer: w8 leaves the experts whole), the
   share of (token, slot) pairs the first layer drops, one torch.profiler
   pass a version (expert GEMMs, dispatch and combine einsums, projections,
   flash_fwd, qmm); decode 1 x 4608 + 33 (one chunk, C = 1440, rings of
   4096 wrapped) and a scheduler of 4 requests in 4 slots; the
   teacher-forced check on the same weights at the non-dropping capacity
   n_experts / top_k (at 1.25 the prefill drops and a decode step never
   does); card against CPU at depth 1 over 64 tokens.
9e. deepseek-v2-lite-16b through the same phases at its published widths
   and full depth (27 layers: one dense, then 26 of 64 routed experts of
   1408, top-6, and 2 shared; MLA with 16 heads, q/k head dim 128 + rope
   64, v 128, a 512-wide latent; vocab 102,400, untied; 15,647,895,040
   parameters, 62.6 GB f32): split 4 x 512 at cuts ('dense0', 1), 13 and
   26 (27 flash_attention an infer at (192, 128), 58 quant_matmul a w8
   infer: MLA's wq and wo, the dense layer's MLP and the head), the first
   MoE layer's dropped share, one torch.profiler pass a version; decode 4 x
   512 + 32 in the expanded form and a scheduler of 8 requests in 4 slots
   (flash_attention in the prefills only, no flash_decode: MLA's decode is
   plain attention, as the reference's); the teacher-forced check at the
   non-dropping capacity; 8 absorbed decode steps (mla_absorb) against the
   expanded form from clones of one prefill cache; card against CPU at
   depth 2 over 64 tokens, with the first MoE layer's top-6 choices card
   against CPU and the probability gap at any flip.
9f. llama-3.2-vision-90b through the same phases at its published widths
   (d_model 8192, 64/8 heads of 128, SwiGLU 28,672, vocab 128,256,
   untied) with its depth cut from 100 to 11 layers: two periods of (4
   attn, 1 xattn) and a 1-layer attn tail, 11,513,552,900 parameters
   (46.05 GB f32), the gates drawn nonzero from a seed; split 2 x 512,
   each row with 1601 random media embeddings, at cuts ('period', 1),
   ('period', 2), ('tail', 1) (11 flash_attention an infer: 9 self, 2
   cross; 78 quant_matmul a w8 infer); decode 2 x 512 + 32 (11
   flash_attention in the prefill, 9 self flash_decode and 2 one-token
   cross steps through flash_decode a step) and 4 requests in 2 slots
   (zero media, as the reference feeds); the teacher-forced check; card
   against CPU at 2 layers with cross_attn_every 2 (one attn, one xattn;
   3,812,663,298 parameters built fresh) over 64 tokens.
9g. whisper-large-v3 through the same phases, whole (32 encoder and 32
   decoder layers, d_model 1280, 20/20 heads of 64, gelu 5120,
   LayerNorm, attention and MLP biases, sinusoidal positions, untied head
   of 51,866; 1,601,812,480 parameters): split 4 x 448 over 4 x 1500
   random frames at cuts 1, 16, 32 (128 flash_attention an infer: the
   encoder's 32 in the head and again in the tail, 32 self, 32 cross; 705
   quant_matmul a w8 infer); decode 4 x 416 + 32 (96 flash_attention in
   the prefill, 64 flash_decode a step: 32 self at G = 1 and 32 cross
   steps) and 8 requests in 4 slots (zero frames); the teacher-forced
   check; card against CPU at 2 + 2 layers over 64 tokens.
10. Training: full-width, full-depth qwen2-0.5b (494,032,768 parameters,
   f32, random weights from torch.Generator seed 0) takes 8 AdamW steps of
   ``launch.steps.make_train_step`` (remat on) on ``SyntheticLMDataset``
   batches of 8 x 512 tokens: every loss finite, the last below the first,
   and each step's launches exact (48 flash_attention: 24 layers and
   remat's recompute; 24 flash_attention_bwd; nothing else); ms a step
   (median), peak memory, one profiled step (device busy and idle share,
   time by kind of kernel). deepseek-v2-lite-16b at full width and depth 2
   (its dense layer and one MoE layer) likewise: 4 AdamW steps of 4 x 512
   tokens, MLA's attention through the (192, 128) instances, every loss
   finite and falling, 4 flash_attention and 2 flash_attention_bwd a step,
   peak memory. falcon-mamba-7b at full width and depth 2 (743,305,216
   parameters) and recurrentgemma-2b at full width and depth 3 (one (rec,
   rec, attn) period, 912,320,000 parameters) likewise: 4 AdamW steps of 4 x
   512 tokens each, every loss finite and falling, a step's launches exact
   (falcon-mamba: 4 mamba_scan, 2 mamba_scan_bwd; recurrentgemma: 4
   rglru_scan, 2 rglru_scan_bwd, 2 flash_attention and 1
   flash_attention_bwd at (256, 256)), ms a step, tokens/s, peak memory.
   Then card against CPU at full width (depth 2; recurrentgemma 3) for
   qwen2-0.5b, qwen3-0.6b (D 128, q/k norm), deepseek-v2-lite-16b,
   falcon-mamba-7b and recurrentgemma-2b: one ``forward_train`` over 2 x 64
   tokens and every exported gradient leaf; all ten archs at ``.reduced()``
   (deepseek at (48, 32)), none refused, each kernel's backward launched
   once for each of its forward launches; and two microbatches against one
   batch from the same weights
   (gradients, metrics, and the parameters after a step where Adam's update
   is well-conditioned).
11. Shardings and the dry run: (a) a process group of one rank over NCCL
   and ``make_host_mesh()`` on the card; full-width, full-depth qwen2-0.5b
   sharded by ``launch.steps.shard_model`` (DTensor parameters, the batch
   and caches placed by the resolved specs) takes SHARD_STEPS AdamW steps
   (8 x 512 tokens, remat, f32) against an unsharded copy from the same
   weights, then prefills 8 x 512 tokens and takes one serve step: the
   loss, every parameter after each step, the prefill's and the decode
   step's logits equal bit for bit (else the largest difference relative
   to each leaf's largest magnitude, within SHARD_TOL), and the launches of
   flash_attention, flash_attention_bwd and flash_decode equal the
   unsharded run's (the kernels ran on the local shards). (b) In
   subprocesses started first and run beside (a), on the card's host and
   without the card: ``python -m repro_torch.launch.dryrun`` for DRYRUN_COMBOS
   (qwen2-0.5b x train_4k x single, its prefill_32k for (c), and the JAX
   package's integration test's three combos), each ``ok`` with FLOPs,
   collectives and seconds. (c) ``make_dryrun_tpu_env(["qwen2-0.5b",
   "falcon-mamba-7b"])`` over those records builds its tables on the card
   equal to the CPU's exactly; an A2C trained briefly on them decides
   greedily, and a few ``env_step``s give finite rewards. (d) The scan
   engine sharded over that group: the megafleet world at its full 100,000
   devices and 5,000,000 requests through ``FleetConfig(engine="scan",
   shard=True)`` and ``shard=False`` on the card, equal bit for bit
   (summary, selection histogram, epoch log, timeline) for device_only,
   full_offload and greedy_oracle, the sharded run making one all-reduce an
   epoch and three after its loop; for full_offload no host
   synchronization inside the sharded loop (sync debug mode, as phase 3f),
   and launches and NCCL kernels an epoch, device busy time, epochs/s and
   wall of both.
7. Timing: each kernel at the main path's shapes beside its plain version,
   one PyTorch library call for the same function where there is one, and
   its bound; flash_attention and flash_decode also at recurrentgemma's
   head_dim 256, flash_attention also at recurrentgemma's 2304-token
   prefill under its 2048 window (its bound is that of 3xTF32 on the tensor
   cores, the arithmetic it runs; the f32 CUDA-core bound is printed beside
   it), flash_decode also as device time (a CUDA graph of the calls),
   quant_matmul at qwen2's layer for the split path (M = 4096) and the w8
   decode step (M = 8, also as device time, and ``ops.quantized_dense``
   with its activation quantization), recurrentgemma's w8 layer (M = 2048)
   and falcon-mamba's head, each beside ``torch._int_mm`` plus the rescale
   (at M = 8 on rows zero-padded to its least M, 17); mamba_scan's bound is the
   larger of its bytes and its exps on the SFU; rglru_scan at
   recurrentgemma's split path, its 2304-token prefill and a scheduler
   cohort (4 x 218), eager and as a CUDA graph. At head_dim 128:
   flash_attention at qwen3's split path (8 x 16/8 x 512) and starcoder2's
   4608-token prefill under its 4096 window, flash_decode at starcoder2's
   decode step (G = 12 over a wrapped 4096-slot ring, 30 layers in turn),
   quant_matmul at phi3's w8 layer and head (M = 1024). At mixtral-8x22b's
   shapes: flash_attention at its split path (1 x 48/8 x 2048, G = 6) and
   its 4608-token prefill under the 4096 window, flash_decode at its decode
   step (G = 6, a wrapped 4096-slot ring, 4 layers in turn), quant_matmul
   at its attention's four projections and its head (M = 2048). At
   deepseek-v2-lite-16b's: flash_attention at its split path (4 x 16/16 x
   512, q/k 192, v 128; SDPA with v of 128 as the library call),
   quant_matmul at MLA's wq and wo and its head (M = 2048). At the
   cross-attention families': flash_attention without a mask at the vlm
   image layer (2 x 64/8 x 512 over 1601 media tokens), whisper's encoder
   (4 x 20/20 x 1500 over 1500) and its cross-attention (448 over 1500),
   each beside SDPA; the one-token cross steps over full cross caches
   (flash_decode at pos = C - 1, the route the models take, beside
   flash_attention at Sq = 1 and SDPA); quant_matmul at the vlm w8 layer
   and head (M = 1024) and whisper's decoder layer and head (M = 1792).
   flash_attention's backward at qwen2-0.5b's, qwen3-0.6b's,
   deepseek-v2-lite-16b's and recurrentgemma-2b's training shapes
   (FA_BWD_PATHS), eager and as a CUDA graph, each of its kernels' device
   time by CUDA events recorded between its launches, beside the
   plain backward and the backward of SDPA (timed alone), with its 3xTF32
   bound (five products over the visible pairs, 2 (3 D + 2 Dv) FLOP a
   pair); in bf16 at qwen2's and recurrentgemma's shapes beside SDPA's bf16
   backward, eager and as device time (a CUDA graph). The scans' backward
   kernels at the train shapes (mamba_scan's at 4 x 512 x 8192, N 16;
   rglru_scan's at 4 x 512 x 2560), eager and as a CUDA graph, beside the
   plain backward and the bound (bytes: the inputs, the forward's states
   and the gradients moved once).
12. The perf harness (``repro_torch.bench``), after phase 7 and reading its
   rows: a ``Matrix`` of three cases run by ``bench.runner.run``, each timed
   by ``bench.stats.timeit`` (BENCH_REPS repetitions) and emitted through
   ``runner.emit``: qwen2-0.5b's w8 layer through ``ops.quantized_dense`` at
   M = 4096; flash_attention through ``ops.attention_bhsd`` at qwen2's split
   shape, CUDA inputs, the timed function returning None; ``simulate``
   through the scan on the megafleet world cut to BENCH_SCAN_REQUESTS (at
   most 4 epochs). Checked: BENCH_REPS samples a record, a median inside its
   CI, no error field; flash_attention's median within [0.9x, 3x] phase 7's
   time of the same call; the w8 layer's at least 0.9x phase 7's kernel
   device time and within [0.9x, 3x] of the same layer's own device and
   eager times (so the harness waits for the card); no ``nvcc`` build in a
   timed case (``tracemon.track_compiles``); the scan case's phases
   ``fleet.scan`` and ``fleet.scan.presample`` folded, ``bench`` not among
   them; the fingerprint naming the card and the power limit phase 1 read.
   In a temporary directory: the gate on the run's own history (every case
   ok; ``launch.benchgate.main`` exits 0), on a copy whose scan samples and
   spans are doubled (regression naming a ``fleet.scan*`` phase; the CLI
   exits 1), and against rows under the reference's fingerprint keys
   (fingerprint_mismatch, refused).

TF32 is switched off for matmuls and cuDNN, so float32 stays float32.
The second-to-last line of output is the ``{"kernels": [...]}`` record; the
last line is ``{"ok": true, "device": {...}}`` and is printed only when
every phase passed. Any failure exits non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (dense): HBM bytes/s, f32 CUDA-core FLOP/s,
# int8 tensor-core OP/s.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_INT8 = 1979e12
# torch._int_mm's least M (it refuses M <= 16): the library time of a
# smaller M is taken on rows zero-padded to it
INT_MM_MIN_M = 17

CUTS = (("main", 1), ("main", 12), ("main", 24))
VERSIONS = ("bf16", "w8", "w4")
BATCH, SEQ, CPU_SEQ = 8, 512, 128
# (K, N) of the seven w8 projections of one qwen2-0.5b layer
QMM_LAYER = ((896, 896), (896, 128), (896, 128), (896, 896),
             (896, 4864), (896, 4864), (4864, 896))
# quant_matmul's phase-2 rows: both sides of the small-M regime's bound
# (SPLIT_M_MAX = 64) and the decode step's M = 8, the fleet loop's 1 x 512
# (ExecuteBackend's batch) and the split path's 4096
QMM_ROWS = (1, 8, 16, 37, 64, 65, SEQ, BATCH * SEQ)
# (K, N) of recurrentgemma-2b's w8 projections: q and o, k and v (MQA),
# GeGLU gate and up, down; and a ragged shape (M, K, N)
RG_QMM_LAYER = ((2560, 2560), (2560, 256), (2560, 256), (2560, 2560),
                (2560, 7680), (2560, 7680), (7680, 2560))
QMM_RAGGED = (37, 100, 200)
# ragged edges that each regime takes (M, K, N, regime): K no multiple of
# the 64-deep split stage or the 128-deep TMA box, N of any tile width
QMM_EDGES = (QMM_RAGGED + ("split",), (8, 4864, 200, "split"), (4096, 912, 200, "wgmma"),
             (65, 1040, 100, "wgmma"), (8, 144, 4100, "wgmma"))
# H100 SXM special-function units: 16 results a clock an SM, 132 SMs at
# the 1.98 GHz boost clock (mamba_scan's exps)
PEAK_SFU = 16 * 132 * 1.98e9
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# flash_decode: tests/test_kernels.py::test_flash_decode_sweep's cases
# (B, H, HK, C, D, pos, window), then the qwen2 decode path's shape, then
# head_dim 256: recurrentgemma's MQA over full 2048-slot rings (wrapped at
# pos 3000) and a GQA case where h % HK and h // G differ
FD_CASES = ((2, 4, 2, 128, 64, 50, None), (2, 4, 2, 128, 64, 127, None),
            (1, 8, 1, 256, 64, 300, 128), (2, 2, 2, 200, 32, 450, 96),
            (1, 4, 4, 64, 128, 10, None),
            (8, 14, 2, 576, 64, 575, None), (8, 14, 2, 576, 64, 1000, 256),
            (2, 10, 1, 2048, 256, 2047, 2048), (2, 10, 1, 2048, 256, 3000, 2048),
            (1, 4, 2, 64, 256, 100, None),
            # the split kernel's edges: a window of 96 in a wrapped 2048-slot
            # ring (most of the ring masked, the visible arc across slot 0),
            # C = 200 (no multiple of any chunk), G = 1, 2 and 20 (two head
            # groups of at most 16)
            (2, 10, 1, 2048, 256, 3000, 96), (2, 10, 1, 2048, 64, 2050, 96),
            (2, 14, 2, 200, 64, 450, None), (2, 4, 4, 576, 64, 600, None),
            (2, 8, 4, 300, 128, 700, 256), (1, 40, 2, 256, 64, 300, None))
DEC_NEW, DEC_CACHE = 64, 576          # ServingEngine: new tokens, ring slots
SRV_REQUESTS, SRV_BATCH, SRV_CACHE = 16, 8, 512
CPU_NEW = 16
# the closed loop (phase 3a): A2C updates on the transformer env of qwen2-0.5b
# at the served 512 tokens, each over LOOP_ENVS environments at once (the
# reference's batch_envs), then the trained controller against its CPU copy
# on LOOP_STATES measured states, LOOP_SLOTS served slots, LOOP_DECIDES
# timed decisions; pricing card against numpy within LOOP_PRICE_TOL
# (relative and absolute, as np.allclose)
LOOP_EPISODES, LOOP_ENVS, LOOP_STATES, LOOP_SLOTS, LOOP_DECIDES = 60, 8, 16, 6, 20
LOOP_PRICE_TOL = 1e-6
# the fleet loop (phase 3c): the tpu-execute preset's devices at full width,
# A2C trained on the card for FLEET_EPISODES updates of FLEET_ENVS envs (the
# path, not learning)
FLEET_DEVICES, FLEET_EPISODES, FLEET_ENVS = 2, 30, 8
# the drift loop (phase 3d): PPO on phase 3a's env (LOOP_EPISODES updates of
# LOOP_ENVS envs, PPO_EPOCHS surrogate passes each); then phase 3c's world under
# link-brownout, its onset and recovery inside DRIFT_REQUESTS requests (200 an
# epoch); the online learner's first update on the card held against the CPU's
# within DRIFT_PARAM_TOL (absolute plus relative, as np.allclose);
# SYNC_REQUESTS requests of an always-adapting run counted for host
# synchronizations
PPO_EPOCHS = 4
DRIFT_ONSET, DRIFT_RECOVER, DRIFT_REQUESTS = 30, 60, 18_000
DRIFT_PARAM_TOL = 1e-5
SYNC_REQUESTS = 2_000
# the cluster loop (phase 3e): the edge-cluster preset's world, its routing A2C
# trained on the card for CLUSTER_EPISODES updates (the preset's 400 cut, so
# that the phase stays short: the path, not learning), CLUSTER_STATES measured
# states decided card against CPU
CLUSTER_EPISODES, CLUSTER_STATES = 60, 16
# the scan engine (phase 3f): the megafleet preset at its full size (100,000
# devices, 5,000,000 requests) for SCAN_POLICIES; diurnal-fleet at
# SCAN_SMALL_REQUESTS requests with an A2C trained on the card for
# SCAN_A2C_EPISODES updates (the path, not learning); the statistical limits
# of the reference's own scan contract (tests/test_megafleet.py): SLO
# attainment absolute, mean latency and energy relative, selection shares
# absolute (state-reading policies)
SCAN_POLICIES = ("device_only", "full_offload", "greedy_oracle")
SCAN_SMALL_REQUESTS, SCAN_A2C_EPISODES = 15_000, 10
SCAN_SLO_ABS, SCAN_MEAN_REL, SCAN_ENERGY_REL, SCAN_SHARE_ABS = 0.05, 0.15, 0.01, 0.05
# card vs CPU, f32 logits of order 1: sums run in other orders on the two
# devices through 24 blocks, hence 1e-3 for bf16 and w4. In w8 such a
# difference can also flip an int8 activation code (x / scale within
# rounding of a half), one quantization step, and one 128-token request
# quantizes ~31M activation codes through 24 layers, where such a step
# grows. So w8 is held against its own quantization error (w8 against bf16
# logits on the CPU): the card-CPU gap must stay within its max and within
# three quarters of its mean. (Measured on an H100 while weight scales
# still differed by an ulp between the devices: gap 0.49x the max and
# 0.53x the mean.) A kernel or wiring fault gives errors well above it.
CPU_TOL = 1e-3
W8_GAP_MAX, W8_GAP_MEAN = 1.0, 0.75
# the cross-attention families' w8 (compare_split_card_cpu's trace): a code
# that f32 rounding flips sits within this of a half-way point of x / scale
# (f32 sums in another order move x / scale by ~1e-5 of its range, 127)
FLIP_HALF = 1e-2
FM_ARCH, FM_BATCH, FM_SEQ = "falcon-mamba-7b", 2, 512
# mamba_scan: tests/test_kernels.py::test_mamba_scan_sweep's cases and
# tolerance (B, S, DI, N), a ragged one, then the path's shape
MS_CASES = ((1, 128, 128, 8), (2, 256, 256, 16), (1, 384, 128, 4),
            (2, 200, 384, 16), (2, 512, 8192, 16))
MS_TOL = 1e-4
# beyond them: S no multiple of the kernel's 32-step chunk, N of 4, 8, 16
# and 32 (one to eight lanes a channel), and N = 5 with DI = 100 (rows
# that are no whole 16-byte pieces, staged by plain loads); each in f32
# and with a bf16 u
MS_EXTRA = ((2, 77, 96, 4), (2, 45, 64, 8), (1, 100, 160, 16), (2, 77, 96, 32),
            (1, 45, 100, 5))
# mamba_scan's backward kernel (phase 2): the sweep's shapes, then the train
# path's (falcon-mamba-7b, 4 x 512 tokens; the last, timed in phase 7), each
# with and without a gradient on h_final, run twice (equal bit for bit);
# each gradient within MS_BWD_TOL of its largest magnitude of the plain
# backward (f32 sums in other orders over S steps, ex2.approx in the exps)
MS_BWD_CASES = MS_CASES[:-1] + MS_EXTRA + ((4, 512, 8192, 16),)
MS_BWD_TOL = 2e-5
# recurrentgemma-2b: split serving and decode shapes, cuts, expected size
RG_ARCH, RG_PARAMS = "recurrentgemma-2b", 2_894_574_080
RG_SPLIT_BATCH, RG_SPLIT_SEQ = 4, 512
RG_CUTS = (("period", 1), ("period", 4), ("tail", 2))
RG_BATCH, RG_SEQ, RG_NEW, RG_TF_STEPS = 2, 2304, 32, 8   # prompts past the 2048 window
RG_SRV_REQUESTS, RG_SRV_BATCH, RG_SRV_CACHE = 8, 4, 512
RG_CPU_LAYERS, RG_CPU_STEPS = 5, 8
RG_DECODE_TOL = 1e-3
# per infer or prefill: 2 rec layers of each of 8 periods + the 2-layer
# tail; 8 attention layers; w8: 26 MLPs x 3 + 8 attentions x 4 projections
RG_SCANS, RG_ATTN, RG_QMM = 18, 8, 110
# rglru_scan at the paths' shapes (B, S, W), W recurrentgemma-2b's LRU
# width: its split path, its 2304-token decode prefill and a scheduler
# cohort; timed in phase 7 (and by scripts/kernel_timing.py)
RS_PATHS = ((RG_SPLIT_BATCH, RG_SPLIT_SEQ, 2560), (RG_BATCH, RG_SEQ, 2560), (4, 218, 2560))
# rglru_scan: tests/test_kernels.py::test_rglru_scan_sweep's cases and
# tolerance (B, S, W), a ragged one, then the regimes of the kernel's plan (a
# single chunk; a long walk over one tile in 16-warp chunks; ragged tiles
# and chunks walked in 8-warp and in 4-warp chunks), then the paths'
RS_CASES = ((1, 128, 256), (2, 256, 512), (1, 384, 128), (2, 200, 320),
            (1, 1, 100), (1, 8192, 32), (3, 4099, 2600), (6, 1000, 2600)) + RS_PATHS
RS_TOL = 1e-4
# rglru_scan's backward kernel (phase 2): RS_CASES (the first of RS_PATHS,
# 4 x 512 x 2560, is recurrentgemma-2b's train shape, timed in phase 7),
# each with and without a gradient on h_last, run twice (equal bit for
# bit), within RS_BWD_TOL of each gradient's largest magnitude
RS_BWD_CASES = RS_CASES
RS_BWD_TOL = 2e-5
# flash_attention at head_dim 256 (B, H, HK, S, window), causal: MQA
# plain, windowed, the decode prompt's 2304 positions under the 2048
# window; a GQA case where h % HK and h // G differ
FA256_CASES = ((2, 10, 1, 40, None), (2, 10, 1, 256, 64), (2, 10, 1, 2304, 2048),
               (2, 4, 2, 100, None))
# flash_attention at head_dim 128 (B, H, HK, S, causal): GQA 14/2 (h % HK
# and h // G differ), a ragged and a full 512-token tile set
FA128_CASES = tuple((2, 14, 2, S, causal) for S in (40, 512) for causal in (True, False))
# flash_attention at MLA's head dims (D of q and k, Dv of v and the
# output): deepseek-v2-lite-16b's (192, 128) and its reduced (48, 32); (B, H,
# HK, S): H = HK = 16 as MLA expands k and v to every head, and GQA 16/4 at
# the new widths, over ragged (40, 100) and whole (512) tiles
FA_MLA_DIMS = ((192, 128), (48, 32))
FA_MLA_CASES = tuple((2, 16, HK, S) for HK in (16, 4) for S in (40, 100, 512))
# flash_attention's backward kernel (phase 2), (B, H, HK, Sq, Skv, D, Dv,
# causal, window), each in f32 and bf16, each run twice (equal bit for bit):
# qwen2-0.5b's training shape, qwen3-0.6b's 16/8 heads at D 128, a window
# of 64 over 512 tokens, whisper's cross-attention shape (no mask, 448
# queries over 1500 frames), ragged tiles (40 and 100 tokens; 40 queries
# over 100 keys) at both widths; deepseek-v2-lite-16b's MLA training
# attention (16/16 heads at (192, 128)), GQA 16/4 at (192, 128), and the
# reduced MLA width (48, 32) ragged, causal and unmasked at Sq != Skv; 14/2,
# 16/8 and 16/4 are GQA cases whose h % HK and h // G differ. qwen2's shape
# and the window split key tiles into parts (the reduce pass), the rest do
# not
FA_BWD_CASES = ((8, 14, 2, 512, 512, 64, 64, True, None),
                (8, 16, 8, 512, 512, 128, 128, True, None),
                (2, 14, 2, 512, 512, 64, 64, True, 64), (2, 20, 20, 448, 1500, 64, 64, False, None),
                (2, 14, 2, 40, 40, 64, 64, True, None), (2, 16, 8, 100, 100, 128, 128, True, None),
                (2, 14, 2, 100, 100, 64, 64, False, None),
                (2, 16, 8, 40, 100, 128, 128, False, None),
                (4, 16, 16, 512, 512, 192, 128, True, None),
                (2, 16, 4, 512, 512, 192, 128, True, None),
                (2, 16, 4, 100, 100, 48, 32, True, None), (2, 16, 4, 40, 100, 48, 32, False, None),
                # recurrentgemma-2b's (256, 256): its train shape (4 x 10/1 x 512
                # under the 2048 window), a window of 64, ragged 40 over 100
                # unmasked, GQA 4/2 (h % HK and h // G differ)
                (4, 10, 1, 512, 512, 256, 256, True, 2048),
                (2, 10, 1, 512, 512, 256, 256, True, 64),
                (2, 10, 1, 40, 100, 256, 256, False, None),
                (2, 4, 2, 100, 100, 256, 256, True, None))
FA_BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the backward's phase-7 shapes (B, H, HK, S, D, Dv, label), f32, causal:
# qwen2-0.5b's training attention (the first: the kernel row's own
# numbers), qwen3-0.6b's at D 128 and deepseek-v2-lite-16b's MLA
FA_BWD_PATHS = ((8, 14, 2, 512, 64, 64, "qwen2-0.5b"), (8, 16, 8, 512, 128, 128, "qwen3-0.6b"),
                (4, 16, 16, 512, 192, 128, "deepseek-v2-lite-16b"),
                # its 2048 window masks nothing at 512 tokens
                (4, 10, 1, 512, 256, 256, "recurrentgemma-2b"))
# the backward's phase-7 shapes timed in bf16 as well (beside SDPA's bf16
# backward, eager and as device time): qwen2-0.5b's and recurrentgemma-2b's
FA_BWD_BF16 = ("qwen2-0.5b", "recurrentgemma-2b")
# the train path (phase 10): qwen2-0.5b at full width and depth, TRAIN_STEPS
# AdamW steps of TRAIN_BATCH x TRAIN_SEQ synthetic tokens; card against CPU
# at depth TRAIN_CPU_LAYERS for TRAIN_CPU_ARCHS; the microbatch check
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen2-0.5b", 8, 512, 8
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
TRAIN_CPU_ARCHS = ("qwen2-0.5b", "qwen3-0.6b", "deepseek-v2-lite-16b", "falcon-mamba-7b",
                   "recurrentgemma-2b")
# the scan families' train paths (phase 10): full width at depth 2 for
# falcon-mamba-7b (two Mamba layers, ~743 M parameters with its untied
# 65,024 head) and 3 for recurrentgemma-2b (one (rec, rec, attn) period, ~0.91
# B with its tied 256,000 embedding), TRAIN_SCAN_STEPS AdamW steps of
# TRAIN_SCAN_BATCH x TRAIN_SCAN_SEQ tokens; the same depths card against CPU
TRAIN_SCAN_ARCHS = (("falcon-mamba-7b", 2), ("recurrentgemma-2b", 3))
TRAIN_SCAN_BATCH, TRAIN_SCAN_SEQ, TRAIN_SCAN_STEPS = 4, 512, 4
# deepseek-v2-lite-16b's train path (phase 10): full width at depth
# TRAIN_MLA_LAYERS (its dense layer and one MoE layer), TRAIN_MLA_STEPS
# AdamW steps of TRAIN_MLA_BATCH x TRAIN_MLA_SEQ tokens, MLA's attention
# through the (192, 128) instances
TRAIN_MLA_ARCH, TRAIN_MLA_LAYERS = "deepseek-v2-lite-16b", 2
TRAIN_MLA_BATCH, TRAIN_MLA_SEQ, TRAIN_MLA_STEPS = 4, 512, 4
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 2, 64
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_MB_TOL = 1e-4, 1e-4, 1e-5
TRAIN_MB_WELL, TRAIN_MB_PARAM_TOL = 1e-4, 1e-6
# the sharded path (phase 11): TRAIN_ARCH sharded at world size 1, SHARD_STEPS
# AdamW steps of TRAIN_BATCH x TRAIN_SEQ tokens beside the unsharded ones, a
# prefill and one serve step; a difference that is not bit for bit must stay
# within SHARD_TOL of each leaf's largest magnitude
SHARD_STEPS, SHARD_TOL = 2, 1e-6
# the dry runs of phase 11 (arch, shape, mesh), each in its own process on
# the card's host: qwen2's train and prefill (the env's calibration shape)
# on the single mesh, and the JAX package's integration test's three
DRYRUN_COMBOS = (("qwen2-0.5b", "train_4k", "single"), ("qwen2-0.5b", "prefill_32k", "single"),
                 ("qwen2-0.5b", "decode_32k", "single"), ("qwen2-0.5b", "long_500k", "multi"),
                 ("falcon-mamba-7b", "decode_32k", "multi"))
DRYRUN_TIMEOUT_S = 300
# phase 11d: the policy whose sharded scan is profiled and checked for host
# synchronizations (its offloaded tail work goes through the all-reduce)
SHARD_SCAN_PROFILED = "full_offload"
SHARD_A2C_UPDATES, SHARD_ENV_STEPS = 10, 4
# phase 12, the perf harness (repro_torch.bench): repetitions a case, calls a
# repetition for each case, and the scan case's megafleet world cut to
# BENCH_SCAN_REQUESTS requests (at most BENCH_SCAN_EPOCHS epochs)
BENCH_REPS = 7
BENCH_CALLS = {"quant_matmul": 20, "flash_attention": 50, "scan": 1}
BENCH_SCAN_REQUESTS, BENCH_SCAN_EPOCHS = 2_000_000, 4
# H100 SXM dense TF32 tensor-core rate; 3xTF32 runs three TF32 products for
# each f32 product
PEAK_3XTF32 = 495e12 / 3
PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core rate
# the attention kernels' serving-path shapes, timed in phase 7 (and by
# scripts/kernel_timing.py). flash_attention (B, H, HK, S, D, window),
# causal: qwen2-0.5b's split path, recurrentgemma-2b's split path (S within
# its window, so the window masks nothing) and its 2304-token prefill under
# the 2048 window. flash_decode (B, H, HK, C, D, layers, pos, window):
# qwen2-0.5b's decode step (24 layers) and recurrentgemma-2b's (8 attention
# layers, full 2048-slot rings, wrapped).
# the single-stack families at full width and depth, f32 (phase 6 for
# falcon-mamba-7b, phases 9, 9b, 9c for the dense ones): split (batch,
# prompt) at three cuts, decode (batch, prompt, new tokens), the scheduler
# (requests, slots, cache_len, prompt lengths, new tokens) or None, and the
# parameter count. starcoder2's 4608-token prompt runs past its 4096 window
# (rings of 4096 slots that the decode steps wrap).
FAMILIES = {
    FM_ARCH: dict(label="6", split=(FM_BATCH, FM_SEQ), cuts=(1, 32, 64),
                  decode=(FM_BATCH, FM_SEQ, 32),
                  srv=(4, 4, 256, (64, 200), (8, 16)), params=7_272_665_088),
    "qwen3-0.6b": dict(label="9", split=(8, 512), cuts=(1, 14, 28), decode=(8, 512, 64),
                       srv=(16, 8, 512, (64, 256), (16, 48)), params=596_049_920),
    "starcoder2-3b": dict(label="9b", split=(4, 512), cuts=(1, 15, 30), decode=(1, 4608, 33),
                          srv=None, params=3_181_366_272),
    "phi3-medium-14b": dict(label="9c", split=(2, 512), cuts=(1, 20, 40), decode=(2, 512, 32),
                            srv=None, params=14_659_507_200),
    # the published widths at 4 of 56 layers (41.7 GB of f32; all 56 are
    # 562.5 GB); the split path's 2048 tokens run as two 1024-token MoE
    # chunks, the 4608-token decode prompt as one (4608 % 1024 != 0), past
    # the 4096 window; the card-CPU comparison at depth 1 (11.6 GB of f32 on
    # the host) over 64 tokens
    "mixtral-8x22b": dict(label="9d", split=(1, 2048), cuts=(1, 2, 4), decode=(1, 4608, 33),
                          srv=(4, 4, 256, (64, 200), (8, 16)), params=10_418_903_040,
                          layers=4, cpu_layers=1, cpu_seq=64),
    # the published widths at full depth (62.6 GB of f32): one leading dense
    # layer (stack dense0), then 26 MoE layers of 64 routed experts (top-6)
    # and 2 shared; MLA attention, whose prefill runs flash_attention at (q/k
    # 192, v 128) and whose decode is plain attention (no flash_decode); the
    # split path's 512-token rows are one MoE chunk each (C 64); the card-CPU
    # comparison at depth 2 (dense0 and one MoE layer, 4.1 GB of f32)
    "deepseek-v2-lite-16b": dict(label="9e", split=(4, 512), cuts=(("dense0", 1), 13, 26),
                                 decode=(4, 512, 32), srv=(8, 4, 256, (64, 200), (8, 16)),
                                 params=15_647_895_040, cpu_seq=64),
    # the published widths (d_model 8192, 64/8 heads of 128, SwiGLU 28,672,
    # vocab 128,256) with the depth cut from 100 layers to 11: two periods of
    # (4 attn, 1 xattn) and a 1-layer attn tail, 46.05 GB of f32 (three
    # periods would be 59.7 GB plus ~14 GB of w8 codes, too close to 80 GB);
    # each row attends to one image tile of 1601 random media embeddings,
    # the gates drawn nonzero from a seed; the card-CPU comparison at 2
    # layers with cross_attn_every 2 (one attn, one xattn: 3,812,663,298
    # parameters, 15.3 GB of f32 on the host, built fresh)
    "llama-3.2-vision-90b": dict(label="9f", split=(2, 512),
                                 cuts=(("period", 1), ("period", 2), ("tail", 1)),
                                 decode=(2, 512, 32), srv=(4, 2, 256, (64, 200), (8, 16)),
                                 params=11_513_552_900, layers=11,
                                 cpu=dict(n_layers=2, cross_attn_every=2), cpu_seq=64),
    # the published model whole (32 encoder and 32 decoder layers, 6.41 GB of
    # f32): the decoder's published 448-token context over 1500 random frame
    # embeddings a row; the encoder runs in the head and again in the tail
    # of a split infer, as in the reference; the card-CPU comparison at 2 + 2
    # layers, built fresh
    "whisper-large-v3": dict(label="9g", split=(4, 448), cuts=(1, 16, 32), decode=(4, 416, 32),
                             srv=(8, 4, 448, (64, 200), (8, 16)), params=1_601_812_480,
                             cpu=dict(n_layers=2, n_encoder_layers=2), cpu_seq=64),
}
# the cross-attention families' new kernel shapes (phase 2): flash_attention
# without a mask, q of (B, H, Sq, D) against k, v over Skv media tokens or
# encoder frames, (B, H, HK, Sq, Skv, D): llama-3.2-vision's image layers
# (64/8 heads of 128 over 1601 media tokens) at one token, a short prompt
# and the split path's 512; whisper's cross-attention (20/20 heads of 64
# over 1500 frames) at one token and its 448-token context; whisper's
# encoder (Sq = Skv = 1500); a GQA case where h % HK and h // G differ
FA_CROSS_CASES = tuple((2, 64, 8, Sq, 1601, 128) for Sq in (1, 40, 512)) + tuple(
    (4, 20, 20, Sq, 1500, 64) for Sq in (1, 448)) + ((4, 20, 20, 1500, 1500, 64),
                                                     (2, 14, 2, 40, 100, 64))
# flash_decode at whisper's G = 1 over a ring (B, H, HK, C, D, pos, window):
# its decode step's 448-slot rings, and one wrapped; then the one-token
# cross step over full cross caches (pos = C - 1, every slot visible):
# llama-3.2-vision's 1601 media tokens at G 8, whisper's 1500 frames at G 1
FD_CROSS_CASES = ((4, 20, 20, 448, 64, 430, None), (4, 20, 20, 448, 64, 700, None),
                  (2, 64, 8, 1601, 128, 1600, None), (4, 20, 20, 1500, 64, 1499, None))
# quant_matmul at the cross-attention families' w8 shapes (M, (K, N)...):
# llama-3.2-vision's projections at the split path's 2 x 512 rows and the
# media's 2 x 1601 (the cross-attention's wk, wv), its head at 1024 rows;
# whisper's at the encoder's 4 x 1500 frames and the decoder's 4 x 448
# tokens, its head at 1792
VLM_QMM = ((8192, 8192), (8192, 1024), (8192, 28_672), (28_672, 8192))
WH_QMM = ((1280, 1280), (1280, 5120), (5120, 1280))
QMM_CROSS_CASES = ([(M, K, N) for M in (1024, 3202) for K, N in VLM_QMM]
                   + [(1024, 8192, 128_256)]
                   + [(M, K, N) for M in (6000, 1792) for K, N in WH_QMM]
                   + [(1792, 1280, 51_866)])
# the cross-attention families' attention shapes timed in phase 7 (and by
# scripts/kernel_timing.py), (B, H, HK, Sq, Skv, D), no mask: the vlm image
# layer at the split path's 512 tokens, whisper's encoder, whisper's cross
# attention at its 448-token context; and the one-token cross steps (B, H,
# HK, C, D, caches), each over full cross caches at pos = C - 1, read in
# turn: whisper's 32 cross layers; llama-3.2-vision's 2 read 4 times over,
# so that they do not sit in the 50 MB L2 (the path reads 9 self-attention
# rings between them)
FA_CROSS_PATHS = ((2, 64, 8, 512, 1601, 128), (4, 20, 20, 1500, 1500, 64),
                  (4, 20, 20, 448, 1500, 64))
FD_CROSS_PATHS = ((2, 64, 8, 1601, 128, 4), (4, 20, 20, 1500, 64, 32))
# teacher-forced decode against forward on the card: the same f32 function
# through the prefill's kernel and the decode step; the CPU comparison's
# depth (unless the family names its own) and decode steps
FAM_TF_STEPS, FAM_DECODE_TOL = 8, 1e-3
FAM_CPU_LAYERS, FAM_CPU_STEPS = 2, 8
# the simulate CLI on the card (phase 3h): no --scenario, the ad-hoc tpu
# world over mixtral-8x22b, executed through its reduced model
CLI_ARGV = ("--env", "tpu", "--arch", "mixtral-8x22b", "--execute", "--devices", "2",
            "--requests", "400", "--compare", "device_only,greedy_oracle", "--seeds", "0")
# the same run over deepseek-v2-lite-16b: reduced MLA on the card, through
# flash_attention's (48, 32) instance
CLI_ARGV_MLA = tuple("deepseek-v2-lite-16b" if a == "mixtral-8x22b" else a for a in CLI_ARGV)
# the mixed fleet (phase 3g): three dense archs, device i serving model i
# (rotated so that each model takes its turn on device 0, whose request is
# the one an epoch executes), sampled requests a run
MIX_ARCHS, MIX_SAMPLE = ("qwen2-0.5b", "qwen3-0.6b", "starcoder2-3b"), 4
FA_PATHS = ((BATCH, 14, 2, SEQ, 64, None), (RG_SPLIT_BATCH, 10, 1, RG_SPLIT_SEQ, 256, 2048),
            (RG_BATCH, 10, 1, RG_SEQ, 256, 2048),
            # qwen3-0.6b's split path (GQA 16/8 at head_dim 128), starcoder2-3b's
            # decode prefill (24/2, 4608 positions under its 4096 window)
            (8, 16, 8, 512, 128, None), (1, 24, 2, 4608, 128, 4096),
            # mixtral-8x22b's split path (48/8 heads, G = 6, 2048 tokens in its
            # 4096 window) and its decode prefill (4608 positions past it)
            (1, 48, 8, 2048, 128, 4096), (1, 48, 8, 4608, 128, 4096))
# deepseek-v2-lite-16b's split attention (B, H, HK, S, D, Dv), causal, no
# window: q and k of 192 (nope 128 + rope 64), v of 128, 16 heads each
FA_MLA_PATH = (4, 16, 16, 512, 192, 128)
FD_PATHS = ((BATCH, 14, 2, DEC_CACHE, 64, 24, DEC_CACHE - 1, None),
            (RG_BATCH, 10, 1, 2048, 256, RG_ATTN, RG_SEQ + 100, 2048),
            # starcoder2-3b's decode step: G = 12, one 4096-slot ring wrapped,
            # 30 layers
            (1, 24, 2, 4096, 128, 30, 4608 + 16, 4096),
            # mixtral-8x22b's decode step: G = 6, a wrapped 4096-slot ring, the
            # 4 layers it serves
            (1, 48, 8, 4096, 128, 4, 4608 + 16, 4096))

failures = []


def check(ok: bool, what: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        failures.append(what)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from repro_torch.kernels import _build
    print("== 1. build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"card (name, power limit): {smi}")
    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"built {list(seconds)} in {time.perf_counter() - t0:.2f} s "
          f"(per kernel, parallel: {json.dumps({k: round(v, 2) for k, v in seconds.items()})})")
    for name in _build.KERNELS:
        for fn, regs, spill in _ptxas_report(_build.build_log(name)):
            print(f"  ptxas {name}: {fn}: {regs} registers, {spill}")
    return smi


def _ptxas_report(log):
    """(function, registers, spill line) of each entry function in an
    ``nvcc -Xptxas -v`` log, the names demangled by the toolkit's cu++filt
    where it is found."""
    rows, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), ""
        elif "spill stores" in line:
            spill = line.strip()
        else:
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None:
                rows.append([fn, int(m.group(1)), spill])
                fn = None
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if rows and os.path.exists(filt):
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            for r, name in zip(rows, out):
                name = name.replace("(int)", "").replace("(anonymous namespace)::", "")
                r[0] = re.sub(r"\([^()]*\)$", "", name)
    return rows


def phase_kernel_checks(dev):
    import torch
    from repro_torch.kernels import flash_attention as fa
    print("== 2. kernel checks against the plain versions")
    g = torch.Generator(device=dev).manual_seed(1)
    qmm_err = check_quant_matmul(dev, g)

    H, HK, D = 14, 2, 64
    # B = 1 at S = 512: the fleet loop's executed infers (phase 3c)
    for B, S in ((2, 8), (2, 40), (2, 512), (1, SEQ), (2, 2048)):
        for causal in (True, False):
            for window in (None, 64):
                for dtype in (torch.float32, torch.bfloat16):
                    q = torch.randn(B, H, S, D, generator=g, device=dev).to(dtype)
                    k = torch.randn(B, HK, S, D, generator=g, device=dev).to(dtype)
                    v = torch.randn(B, HK, S, D, generator=g, device=dev).to(dtype)
                    out = fa.flash_attention(q, k, v, causal=causal, window=window)
                    ref = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
                    torch.cuda.synchronize()
                    tol = FA_TOL[str(dtype).split(".")[1]]
                    err = (out.float() - ref.float()).abs().max().item()
                    check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                          f"flash_attention {str(dtype)[6:]} B={B} H={H} HK={HK} S={S} "
                          f"causal={causal} window={window}: max_abs_err={err:.3g} (tol {tol})")

    # head mapping: kv head h % HK (the reference), not h // G
    G = H // HK
    q = torch.randn(2, H, 40, D, generator=g, device=dev)
    k = torch.randn(2, HK, 40, D, generator=g, device=dev)
    v = torch.randn(2, HK, 40, D, generator=g, device=dev)
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention_ref(q, k, v, causal=True)
    by_div = fa.flash_attention_ref(q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1),
                                    causal=True)
    torch.cuda.synchronize()
    e_mod = (out - ref).abs().max().item()
    e_div = (out - by_div).abs().max().item()
    check(e_mod <= 2e-5 and e_div > 0.1,
          f"flash_attention GQA head map: |out - ref(h % HK)| = {e_mod:.3g}, "
          f"|out - ref(h // G)| = {e_div:.3g}")
    check_flash_decode(dev, g)
    qmm_err = max(qmm_err, check_head_quant_matmul(dev, g))
    ms_err = check_mamba_scan(dev, g)
    check_flash_attention_wide(dev, g)
    check_flash_attention_mla(dev, g)
    qmm_err = max(qmm_err, check_cross_kernels(dev, g))
    rs_err = check_rglru_scan(dev, g)
    fa_bwd_err = check_flash_attention_bwd(dev, g)
    ms_bwd_err = check_mamba_scan_bwd(dev, g)
    rs_bwd_err = check_rglru_scan_bwd(dev, g)
    return qmm_err, ms_err, rs_err, fa_bwd_err, ms_bwd_err, rs_bwd_err


def check_cross_kernels(dev, g):
    """The cross-attention families' shapes: flash_attention without a mask
    at Sq != Skv (FA_CROSS_CASES, f32 and bf16, views of (B, S, H, D)
    tensors; the GQA case also against the h // G map), flash_decode at
    whisper's G = 1 and over full cross caches at pos = C - 1
    (FD_CROSS_CASES, (B, C, HK, D) caches viewed as (B, HK, C, D)), and
    quant_matmul bit for bit at both families' w8 shapes (QMM_CROSS_CASES,
    w_q K-major as a w8a8 leaf holds it), each line naming its plan.
    Returns quant_matmul's largest error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import quant_matmul as qmm
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, H, HK, Sq, Skv, D in FA_CROSS_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype).transpose(1, 2)
            k, v = (torch.randn(B, Skv, HK, D, generator=g, device=dev).to(dtype).transpose(1, 2)
                    for _ in range(2))
            out = fa.flash_attention(q, k, v, causal=False)
            ref = fa.flash_attention_ref(q, k, v, causal=False)
            torch.cuda.synchronize()
            tol = FA_TOL[str(dtype).split(".")[1]]
            err = (out.float() - ref.float()).abs().max().item()
            what = (f"flash_attention {str(dtype)[6:]} B={B} H={H} HK={HK} Sq={Sq} Skv={Skv} "
                    f"D={D} causal=False: max_abs_err={err:.3g} (tol {tol})")
            ok = tuple(out.shape) == (B, H, Sq, D) and torch.allclose(
                out.float(), ref.float(), rtol=tol, atol=tol)
            if H // HK not in (1, H) and dtype == torch.float32:
                G = H // HK
                by_div = fa.flash_attention_ref(q, k.repeat_interleave(G, 1),
                                                v.repeat_interleave(G, 1), causal=False)
                e_div = (out - by_div).abs().max().item()
                ok = ok and e_div > 0.1
                what += f"; |out - ref(h // G)| = {e_div:.3g}"
            check(ok, what)
    for B, H, HK, C, D, pos, window in FD_CROSS_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, D, generator=g, device=dev).to(dtype)
            k, v = (torch.randn(B, C, HK, D, generator=g, device=dev).to(dtype).transpose(1, 2)
                    for _ in range(2))
            out = fd.flash_decode(q, k, v, pos, window=window)
            ref = fd.flash_decode_ref(q, k, v, pos, window=window)
            torch.cuda.synchronize()
            tol = FA_TOL[str(dtype).split(".")[1]]
            err = (out.float() - ref.float()).abs().max().item()
            p = fd.plan(B, H, HK, C, D, pos, window, sms)
            full = pos == C - 1
            if full and dtype == torch.float32:
                # the cross step's contract: every slot visible, the
                # reference's unmasked softmax over all C keys
                plain = fa.flash_attention_ref(q[:, :, None], k, v, causal=False)[:, :, 0]
                err = max(err, (out - plain).abs().max().item())
            check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol) and err <= tol,
                  f"flash_decode {str(dtype)[6:]} B={B} H={H} HK={HK} C={C} D={D} pos={pos} "
                  f"{'(a full cross cache) ' if full else ''}window={window}: "
                  f"max_abs_err={err:.3g} (tol {tol}); plan {p}")
    err_max = 0.0
    for M, K, N in QMM_CROSS_CASES:
        xq, wq, xs, ws = _qmm_inputs(M, K, N, g, dev)
        ref = qmm.quant_matmul_ref(xq, wq, xs, ws)
        w = wq.t().contiguous().t()
        del wq
        out = qmm.quant_matmul(xq, w, xs, ws)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        err_max = max(err_max, err)
        p = qmm.plan(M, N, K, sms)
        check(torch.equal(out, ref),
              f"quant_matmul M={M} K={K} N={N} ({p.regime}, {p.tiles} tiles of {p.mt} x "
              f"{p.bn}, {p.splits} split(s), w_q K-major): bit-exact, max_abs_err={err}")
        del xq, w, ref, out
    _free()
    return err_max


def check_flash_attention_wide(dev, g):
    """flash_attention at head_dim 128, at recurrentgemma's 256, and at
    the fleet loop's qwen2 shape, in the model's (B, S, H, D) layout."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    cases = ([(B, H, HK, S, causal, None, 128) for B, H, HK, S, causal in FA128_CASES]
             + [(B, H, HK, S, True, window, 256) for B, H, HK, S, window in FA256_CASES]
             # the fleet loop's executed infer (phase 3c), in the model's layout
             + [(1, 14, 2, SEQ, True, None, 64)])
    for B, H, HK, S, causal, window, D in cases:
        for dtype in (torch.float32, torch.bfloat16):
            # the model's layout: (B, S, H, D) projections viewed as (B, H, S, D)
            q = torch.randn(B, S, H, D, generator=g, device=dev).to(dtype).transpose(1, 2)
            k = torch.randn(B, S, HK, D, generator=g, device=dev).to(dtype).transpose(1, 2)
            v = torch.randn(B, S, HK, D, generator=g, device=dev).to(dtype).transpose(1, 2)
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
            ref = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            tol = FA_TOL[str(dtype).split(".")[1]]
            err = (out.float() - ref.float()).abs().max().item()
            check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                  f"flash_attention {str(dtype)[6:]} B={B} H={H} HK={HK} S={S} D={D} "
                  f"causal={causal} window={window}: max_abs_err={err:.3g} (tol {tol})")


def check_flash_attention_mla(dev, g):
    """flash_attention with v's head dim apart from q's and k's, at MLA's
    (192, 128) and (48, 32): FA_MLA_CASES, causal and not, window None and
    64, f32 and bf16, q, k and v as views of (B, S, H, D) tensors."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    for D, Dv in FA_MLA_DIMS:
        for B, H, HK, S in FA_MLA_CASES:
            for causal in (True, False):
                for window in (None, 64):
                    for dtype in (torch.float32, torch.bfloat16):
                        q = torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
                        k = torch.randn(B, S, HK, D, generator=g, device=dev).to(dtype)
                        v = torch.randn(B, S, HK, Dv, generator=g, device=dev).to(dtype)
                        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
                        out = fa.flash_attention(q, k, v, causal=causal, window=window)
                        ref = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
                        torch.cuda.synchronize()
                        tol = FA_TOL[str(dtype).split(".")[1]]
                        err = (out.float() - ref.float()).abs().max().item()
                        check(tuple(out.shape) == (B, H, S, Dv)
                              and torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                              f"flash_attention {str(dtype)[6:]} B={B} H={H} HK={HK} S={S} "
                              f"D={D} Dv={Dv} causal={causal} window={window}: "
                              f"max_abs_err={err:.3g} (tol {tol})")


def _rglru_inputs(B, S, W, g, dev):
    """a on U[0.7, 0.999] and gx standard normal, as the JAX kernel sweep."""
    import torch
    return (torch.rand(B, S, W, generator=g, device=dev) * 0.299 + 0.7,
            torch.randn(B, S, W, generator=g, device=dev))


def check_rglru_scan(dev, g):
    """rglru_scan against its plain version at RS_CASES (each line names the
    plan); two calls and two replays of a CUDA graph bit for bit. Returns
    the largest error at the paths' shapes."""
    import torch
    from repro_torch.kernels import rglru_scan as rs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = 0.0
    for B, S, W in RS_CASES:
        path = (B, S, W) in RS_PATHS
        a, gx = _rglru_inputs(B, S, W, g, dev)
        y, h = rs.rglru_scan(a, gx)
        yr, hr = rs.rglru_scan_ref(a, gx)
        torch.cuda.synchronize()
        ey, eh = (y - yr).abs().max().item(), (h - hr).abs().max().item()
        if path:
            err = max(err, ey, eh)
        p = rs.plan(B, S, W, sms)
        check(y.dtype == h.dtype == torch.float32
              and torch.allclose(y, yr, rtol=RS_TOL, atol=RS_TOL)
              and torch.allclose(h, hr, rtol=RS_TOL, atol=RS_TOL) and torch.equal(h, y[:, -1]),
              f"rglru_scan f32 B={B} S={S} W={W}{' (path)' if path else ''} ({p.blocks} blocks: "
              f"{B} x {p.tiles} tiles x {p.chunks} chunk(s) of {p.chunk} steps): max_abs_err "
              f"h_seq {ey:.3g}, h_last {eh:.3g} (tol {RS_TOL}; max |h| {yr.abs().max().item():.3g})")

    # nothing outlives a launch, so every call runs the same FMAs in the
    # same order: two calls and two replays of a captured call give the
    # same bits (the prefill's walk of 18 chunks; a ragged tile and chunk)
    side = torch.cuda.Stream()
    for B, S, W in (RS_PATHS[1], (3, 4099, 2600)):
        a, gx = _rglru_inputs(B, S, W, g, dev)
        y1, h1 = rs.rglru_scan(a, gx)
        y2, h2 = rs.rglru_scan(a, gx)
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            yg, hg = rs.rglru_scan(a, gx)
        same = []
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            same.append(torch.equal(yg, y1) and torch.equal(hg, h1))
        check(torch.equal(y1, y2) and torch.equal(h1, h2) and all(same),
              f"rglru_scan B={B} S={S} W={W}: two calls and two graph replays bit for bit")
        del graph
    return err


def _qmm_inputs(M, K, N, g, dev):
    """int8 codes over the full range, positive scales."""
    import torch
    return (torch.randint(-128, 128, (M, K), dtype=torch.int8, generator=g, device=dev),
            torch.randint(-128, 128, (K, N), dtype=torch.int8, generator=g, device=dev),
            torch.rand(M, generator=g, device=dev) * 0.05 + 1e-4,
            torch.rand(N, generator=g, device=dev) * 0.05 + 1e-4)


def check_quant_matmul(dev, g):
    """quant_matmul bit for bit against its plain version at qwen2's and
    recurrentgemma's shapes on both sides of the regime bound and at
    ragged edges of each regime, with w_q held K-major (as a w8a8 leaf
    holds it) and contiguous (copied K-major by the call); its split
    calls alternating on two streams; its refusal to make a workspace in a
    graph capture. Returns the largest error."""
    import torch
    from repro_torch.kernels import quant_matmul as qmm
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = ([(M, K, N, None) for K, N in sorted(set(QMM_LAYER)) for M in QMM_ROWS]
             + [(M, K, N, None) for K, N in sorted(set(RG_QMM_LAYER))
                for M in (RG_BATCH, RG_SPLIT_BATCH * RG_SPLIT_SEQ)]
             + list(QMM_EDGES))
    err_max = 0.0
    for M, K, N, regime in cases:
        xq, wq, xs, ws = _qmm_inputs(M, K, N, g, dev)
        ref = qmm.quant_matmul_ref(xq, wq, xs, ws)
        p = qmm.plan(M, N, K, sms)
        if regime is not None:
            check(p.regime == regime, f"quant_matmul M={M} K={K} N={N} takes the "
                                      f"{regime} regime (plan: {p.regime})")
        for w, held in ((wq.t().contiguous().t(), "K-major"), (wq, "contiguous")):
            out = qmm.quant_matmul(xq, w, xs, ws)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            err_max = max(err_max, err)
            check(torch.equal(out, ref),
                  f"quant_matmul M={M} K={K} N={N} ({p.regime}, {p.tiles} tiles of "
                  f"{p.mt} x {p.bn}, {p.splits} split(s), w_q {held}): bit-exact, "
                  f"max_abs_err={err}")

    # the split workspace: calls alternating on two streams, each stream
    # with its own, and none made inside a graph capture
    M, K, N = 8, 4864, 896
    check(qmm.plan(M, N, K, sms).splits > 1, f"quant_matmul M={M} K={K} N={N} splits K")
    calls = [_qmm_inputs(M, K, N, g, dev) for _ in range(16)]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for i, args in enumerate(calls):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(qmm.quant_matmul(*args))
    torch.cuda.synchronize()
    check(all(torch.equal(o, qmm.quant_matmul_ref(*a)) for o, a in zip(outs, calls)),
          f"quant_matmul split calls (M={M} K={K} N={N}) alternating on two streams: bit-exact")
    fresh = torch.cuda.Stream()
    fresh.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            qmm.quant_matmul(*calls[0])
        refused = False
    except RuntimeError as e:
        refused = "no workspace" in str(e)
    torch.cuda.synchronize()
    check(refused, "quant_matmul refuses to make a stream's workspace inside a graph capture")
    return err_max


def check_head_quant_matmul(dev, g):
    """quant_matmul at falcon-mamba's w8 head: (B*S, d) x (d, V)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import quant_matmul as qmm
    cfg = get_config(FM_ARCH)
    M, K, N = FM_BATCH * FM_SEQ, cfg.d_model, cfg.vocab_size
    xq = torch.randint(-128, 128, (M, K), dtype=torch.int8, generator=g, device=dev)
    wq = torch.randint(-128, 128, (K, N), dtype=torch.int8, generator=g, device=dev)
    xs = torch.rand(M, generator=g, device=dev) * 0.05 + 1e-4
    ws = torch.rand(N, generator=g, device=dev) * 0.05 + 1e-4
    ref = qmm.quant_matmul_ref(xq, wq, xs, ws)
    err_max = 0.0
    for w, held in ((wq.t().contiguous().t(), "K-major"), (wq, "contiguous")):
        out = qmm.quant_matmul(xq, w, xs, ws)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        err_max = max(err_max, err)
        check(torch.equal(out, ref), f"quant_matmul M={M} K={K} N={N} ({FM_ARCH} head, "
                                     f"w_q {held}): bit-exact, max_abs_err={err}")
        del out
    return err_max


def _scan_inputs(B, S, DI, N, g, dev, falcon_a=False):
    """u, dt in the model's range (softplus around -4.6: 0.001-0.1), Bm and
    Cm as slices of one (B, S, R + 2N) projection, as the mixer passes
    them, and A = -exp(normal) or, for the path, falcon-mamba's -(1..N)."""
    import torch
    R = 16
    u = torch.randn(B, S, DI, generator=g, device=dev)
    dt = torch.rand(B, S, DI, generator=g, device=dev) * 0.099 + 0.001
    xdbc = torch.randn(B, S, R + 2 * N, generator=g, device=dev)
    if falcon_a:
        A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(DI, N).contiguous()
    else:
        A = -torch.exp(torch.randn(DI, N, generator=g, device=dev))
    return u, dt, xdbc[..., R:R + N], xdbc[..., R + N:], A


def check_mamba_scan(dev, g):
    """mamba_scan against its plain version; returns the path shape's error."""
    import torch
    from repro_torch.kernels import mamba_scan as ms
    err = 0.0
    for B, S, DI, N in MS_CASES:
        path = (B, S, DI, N) == MS_CASES[-1]
        u, dt, Bm, Cm, A = _scan_inputs(B, S, DI, N, g, dev, falcon_a=path)
        y, h = ms.mamba_scan(u, dt, Bm, Cm, A)
        yr, hr = ms.mamba_scan_ref(u, dt, Bm, Cm, A)
        torch.cuda.synchronize()
        ey, eh = (y - yr).abs().max().item(), (h - hr).abs().max().item()
        if path:
            err = max(ey, eh)
        check(y.dtype == u.dtype and h.dtype == torch.float32
              and torch.allclose(y, yr, rtol=MS_TOL, atol=MS_TOL)
              and torch.allclose(h, hr, rtol=MS_TOL, atol=MS_TOL),
              f"mamba_scan f32 B={B} S={S} DI={DI} N={N}{' (path)' if path else ''}: "
              f"max_abs_err y {ey:.3g}, h_final {eh:.3g} (tol {MS_TOL}; max |y| "
              f"{yr.abs().max().item():.3g})")
    for B, S, DI, N in MS_EXTRA:
        u, dt, Bm, Cm, A = _scan_inputs(B, S, DI, N, g, dev)
        y, h = ms.mamba_scan(u, dt, Bm, Cm, A)
        yr, hr = ms.mamba_scan_ref(u, dt, Bm, Cm, A)
        torch.cuda.synchronize()
        ey, eh = (y - yr).abs().max().item(), (h - hr).abs().max().item()
        check(torch.allclose(y, yr, rtol=MS_TOL, atol=MS_TOL)
              and torch.allclose(h, hr, rtol=MS_TOL, atol=MS_TOL),
              f"mamba_scan f32 B={B} S={S} DI={DI} N={N}: max_abs_err y {ey:.3g}, "
              f"h_final {eh:.3g} (tol {MS_TOL})")
    # a bf16 u: both versions read the same bf16 values and round y to bf16
    tol = FA_TOL["bfloat16"]
    for B, S, DI, N in ((2, 200, 384, 16),) + MS_EXTRA:
        u, dt, Bm, Cm, A = _scan_inputs(B, S, DI, N, g, dev)
        u = u.bfloat16()
        y, h = ms.mamba_scan(u, dt, Bm, Cm, A)
        yr, hr = ms.mamba_scan_ref(u, dt, Bm, Cm, A)
        torch.cuda.synchronize()
        ey = (y.float() - yr.float()).abs().max().item()
        check(y.dtype == torch.bfloat16
              and torch.allclose(y.float(), yr.float(), rtol=tol, atol=tol)
              and torch.allclose(h, hr, rtol=MS_TOL, atol=MS_TOL),
              f"mamba_scan bf16 u B={B} S={S} DI={DI} N={N}: max_abs_err y {ey:.3g} "
              f"(tol {tol}), h_final {(h - hr).abs().max().item():.3g}")
    return err


def check_flash_decode(dev, g):
    import torch
    from repro_torch.kernels import flash_decode as fd
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, H, HK, C, D, pos, window in FD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, D, generator=g, device=dev).to(dtype)
            # the model's cache layer (B, C, HK, D), viewed as (B, HK, C, D)
            k = torch.randn(B, C, HK, D, generator=g, device=dev).to(dtype).transpose(1, 2)
            v = torch.randn(B, C, HK, D, generator=g, device=dev).to(dtype).transpose(1, 2)
            out = fd.flash_decode(q, k, v, pos, window=window)
            ref = fd.flash_decode_ref(q, k, v, pos, window=window)
            torch.cuda.synchronize()
            tol = FA_TOL[str(dtype).split(".")[1]]
            err = (out.float() - ref.float()).abs().max().item()
            p = fd.plan(B, H, HK, C, D, pos, window, sms)
            check(out.dtype == dtype and torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                  f"flash_decode {str(dtype)[6:]} B={B} H={H} HK={HK} C={C} D={D} pos={pos} "
                  f"window={window} ({p.nvis} visible, {p.units * p.splits} blocks of "
                  f"{p.per_split} x {p.chunk} slots): max_abs_err={err:.3g} (tol {tol})")

    # head mapping: kv head h % HK (the reference), not h // G
    H, HK, C, D = 14, 2, 200, 64
    q = torch.randn(2, H, D, generator=g, device=dev)
    k = torch.randn(2, HK, C, D, generator=g, device=dev)
    v = torch.randn(2, HK, C, D, generator=g, device=dev)
    out = fd.flash_decode(q, k, v, 150)
    ref = fd.flash_decode_ref(q, k, v, 150)
    by_div = fd.flash_decode_ref(q, k.repeat_interleave(H // HK, 1),
                                 v.repeat_interleave(H // HK, 1), 150)
    torch.cuda.synchronize()
    e_mod = (out - ref).abs().max().item()
    e_div = (out - by_div).abs().max().item()
    check(e_mod <= 2e-5 and e_div > 0.1,
          f"flash_decode GQA head map: |out - ref(h % HK)| = {e_mod:.3g}, "
          f"|out - ref(h // G)| = {e_div:.3g}")

    # the merge counters: split calls on two streams at once, each stream
    # with its own workspace, and no workspace made inside a graph capture
    B, H, HK, C, D, _, pos, _ = FD_PATHS[0]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    calls = []
    for i in range(16):
        q = torch.randn(B, H, D, generator=g, device=dev)
        k, v = (torch.randn(B, HK, C, D, generator=g, device=dev) for _ in range(2))
        calls.append((q, k, v))
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for i, (q, k, v) in enumerate(calls):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(fd.flash_decode(q, k, v, pos))
    torch.cuda.synchronize()
    err = max((o - fd.flash_decode_ref(q, k, v, pos)).abs().max().item()
              for o, (q, k, v) in zip(outs, calls))
    check(err <= FA_TOL["float32"] and fd.plan(B, H, HK, C, D, pos, None, sms).splits > 1,
          f"flash_decode split calls alternating on two streams: max_abs_err={err:.3g}")
    fresh = torch.cuda.Stream()
    fresh.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            fd.flash_decode(*calls[0], pos)
        refused = False
    except RuntimeError as e:
        refused = "no workspace" in str(e)
    torch.cuda.synchronize()
    check(refused, "flash_decode refuses to make a stream's workspace inside a graph capture")


def _rel(a, b):
    """max |a - b| over the largest magnitude of b."""
    return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)


def check_mamba_scan_bwd(dev, g):
    """mamba_scan's backward kernel against the plain backward at
    MS_BWD_CASES, with and without a gradient on h_final, each run twice
    (equal bit for bit), the forward's chunk-start states not moving its y
    or h_final; then ``MambaScanFn`` under autograd: one forward and one
    backward launch, its gradients the direct calls'. Returns the largest
    relative gap at the train path's shape."""
    import torch
    from repro_torch.kernels import mamba_scan as ms
    worst = 0.0
    for B, S, DI, N in MS_BWD_CASES:
        path = (B, S, DI, N) == MS_BWD_CASES[-1]
        u, dt, Bm, Cm, A = _scan_inputs(B, S, DI, N, g, dev, falcon_a=path)
        y0, h0 = ms.mamba_scan(u, dt, Bm, Cm, A)
        y, h, hc = ms.mamba_scan(u, dt, Bm, Cm, A, chunk_states=True)
        dy = torch.randn(B, S, DI, generator=g, device=dev)
        dh = torch.randn(B, DI, N, generator=g, device=dev)
        for grad_h in (None, dh):
            got = ms.mamba_scan_bwd(u, dt, Bm, Cm, A, hc, dy, grad_h)
            again = ms.mamba_scan_bwd(u, dt, Bm, Cm, A, hc, dy, grad_h)
            plain = ms.mamba_scan_bwd_ref(u, dt, Bm, Cm, A, dy, grad_h)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            errs = [_rel(a, b) for a, b in zip(got, plain)]
            if path:
                worst = max(worst, *errs)
            check(same and max(errs) <= MS_BWD_TOL and torch.equal(y, y0) and torch.equal(h, h0)
                  and all(torch.isfinite(a).all() for a in got),
                  f"mamba_scan_bwd f32 B={B} S={S} DI={DI} N={N}{' (train path)' if path else ''} "
                  f"dh={'yes' if grad_h is not None else 'none'}: du/ddt/dBm/dCm/dA gaps "
                  f"{_fmt(errs)} of each largest |grad| (tol {MS_BWD_TOL}); two runs equal "
                  f"{same}; {hc.shape[1]} chunk states, y and h_final as without them")
        del u, dt, Bm, Cm, A, y, h, hc, dy, dh, got, again, plain
    # through autograd, as a train step calls it (ops.mamba_scan_full)
    from repro_torch.kernels import ops
    B, S, DI, N = 2, 77, 96, 16
    u, dt, Bm, Cm, A = _scan_inputs(B, S, DI, N, g, dev)
    a_log, d_skip = torch.log(-A), torch.randn(DI, generator=g, device=dev)
    A = -torch.exp(a_log)   # as ops.mamba_scan_full forms it
    dy = torch.randn(B, S, DI, generator=g, device=dev)
    leaves = [t.clone().requires_grad_() for t in (u, dt, Bm, Cm)]
    before = _counts()
    y, _ = ops.mamba_scan_full(*leaves, a_log, d_skip)
    y.backward(dy)
    delta = {n: c - before[n] for n, c in _counts().items()}
    _, _, hc = ms.mamba_scan(u, dt, Bm, Cm, A, chunk_states=True)
    want = ms.mamba_scan_bwd(u, dt, Bm, Cm, A, hc, dy)
    torch.cuda.synchronize()
    same = (torch.equal(leaves[0].grad, want[0] + dy * d_skip)
            and all(torch.equal(a.grad, b) for a, b in zip(leaves[1:], want[1:4])))
    check(same and delta == _launches(mamba_scan=1, mamba_scan_bwd=1),
          f"MambaScanFn under autograd (ops.mamba_scan_full): gradients equal to the direct "
          f"calls {same}, launches {delta}")
    return worst


def check_rglru_scan_bwd(dev, g):
    """rglru_scan's backward kernel against the plain backward at
    RS_BWD_CASES (each line names the backward's plan), with and without a
    gradient on h_last, each run twice (equal bit for bit); then
    ``RglruScanFn`` under autograd: one forward and one backward launch,
    its gradients the direct calls'. Returns the largest relative gap at the
    train shape."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    for B, S, W in RS_BWD_CASES:
        path = (B, S, W) == RS_PATHS[0]
        a, gx = _rglru_inputs(B, S, W, g, dev)
        y, _ = rs.rglru_scan(a, gx)
        dy = torch.randn(B, S, W, generator=g, device=dev)
        dh = torch.randn(B, W, generator=g, device=dev)
        p = rs.bwd_plan(B, S, W, sms)
        for grad_h in (None, dh):
            got = rs.rglru_scan_bwd(a, y, dy, grad_h)
            again = rs.rglru_scan_bwd(a, y, dy, grad_h)
            plain = rs.rglru_scan_bwd_ref(a, y, dy, grad_h)
            torch.cuda.synchronize()
            same = all(torch.equal(x, z) for x, z in zip(got, again))
            errs = [_rel(x, z) for x, z in zip(got, plain)]
            if path:
                worst = max(worst, *errs)
            check(same and max(errs) <= RS_BWD_TOL,
                  f"rglru_scan_bwd f32 B={B} S={S} W={W}{' (train shape)' if path else ''} "
                  f"dh={'yes' if grad_h is not None else 'none'} ({p.blocks} blocks of {p.warps} "
                  f"warps, {p.chunks} chunk(s) of {p.chunk} steps): da/dgx gaps {_fmt(errs)} of "
                  f"each largest |grad| (tol {RS_BWD_TOL}); two runs equal {same}")
    a, gx = _rglru_inputs(2, 300, 320, g, dev)
    dy = torch.randn(2, 300, 320, generator=g, device=dev)
    la, lg = a.clone().requires_grad_(), gx.clone().requires_grad_()
    before = _counts()
    y, _ = ops.rglru_scan_full(la, lg)
    y.backward(dy)
    delta = {n: c - before[n] for n, c in _counts().items()}
    want = rs.rglru_scan_bwd(a, rs.rglru_scan(a, gx)[0], dy)
    torch.cuda.synchronize()
    same = torch.equal(la.grad, want[0]) and torch.equal(lg.grad, want[1])
    check(same and delta == _launches(rglru_scan=1, rglru_scan_bwd=1),
          f"RglruScanFn under autograd (ops.rglru_scan_full): gradients equal to the direct "
          f"calls {same}, launches {delta}")
    return worst


def _kernel_counters():
    """{kernel: (its wrapper module, the name of its launch count there)}."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.kernels import rglru_scan as rs
    return {"flash_attention": (fa, "launches"), "flash_attention_bwd": (fa, "bwd_launches"),
            "flash_decode": (fd, "launches"), "mamba_scan": (ms, "launches"),
            "mamba_scan_bwd": (ms, "bwd_launches"), "quant_matmul": (qmm, "launches"),
            "rglru_scan": (rs, "launches"), "rglru_scan_bwd": (rs, "bwd_launches")}


def _counts():
    return {name: getattr(mod, attr) for name, (mod, attr) in _kernel_counters().items()}


def _reset_counts():
    for mod, attr in _kernel_counters().values():
        setattr(mod, attr, 0)


def _launches(**nonzero):
    """The expected launch counts: every kernel 0 unless named."""
    return {name: nonzero.get(name, 0) for name in _kernel_counters()}


def phase_main_path(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init
    from repro_torch.serving import SplitServingEngine
    print("== 3. main path: full-width qwen2-0.5b through SplitServingEngine")
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"init {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {n_params} params, {time.perf_counter() - t0:.2f} s")
    eng = SplitServingEngine(cfg, model, versions=VERSIONS)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    batch = {"tokens": tokens}
    for version in VERSIONS:          # build each version's model, warm up
        eng.infer(batch, ("main", 12), version)
    torch.cuda.synchronize()

    reps = 3
    want_fa = cfg.n_layers
    link_f32 = BATCH * SEQ * cfg.d_model * 4
    link_w8 = BATCH * SEQ * cfg.d_model + BATCH * SEQ * 4
    times = {}
    _reset_counts()
    for version in VERSIONS:
        want_qmm = 7 * cfg.n_layers if version == "w8" else 0
        for cut in CUTS:
            ms = []
            for _ in range(reps):
                before = _counts()
                t0 = time.perf_counter()
                logits, act_bytes = eng.infer(batch, cut, version)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                after = _counts()
                delta = {k: after[k] - before[k] for k in after}
            finite = bool(torch.isfinite(logits).all())
            shape_ok = tuple(logits.shape) == (BATCH, SEQ, cfg.vocab_size)
            want_bytes = link_w8 if version == "w8" else link_f32
            times[f"{version}@{cut[1]}"] = ms
            check(finite and shape_ok and act_bytes == want_bytes
                  and delta == _launches(flash_attention=want_fa, quant_matmul=want_qmm),
                  f"infer {version} cut={cut[1]}: act_bytes={act_bytes} "
                  f"ms={[round(t, 3) for t in ms]} launches/infer={delta} "
                  f"logits {tuple(logits.shape)} finite={finite}")
            del logits
    launches = _counts()
    n_infer = reps * len(VERSIONS) * len(CUTS)
    print(f"main path: {n_infer} infers, launches {launches}")
    check(launches["flash_attention"] == n_infer * want_fa
          and launches["quant_matmul"] == reps * len(CUTS) * 7 * cfg.n_layers,
          "launch counts over the main path run")
    return cfg, model, eng, batch, launches, times


def _serve_one(cfg, eng, batch, env_cfg, tables, state, actions, what, records):
    """Serve device 0's action through phase 3's engine
    (``launch/split_serving.serve_slot``) and hold it: bytes at the cut
    equal to the table's, logits finite, and 24 flash_attention launches
    (168 quant_matmul for w8, else 0) for the infer."""
    from repro_torch.core import pricing, transformer_profile
    from repro_torch.launch import split_serving as loop
    before = _counts()
    rec = loop.serve_slot(eng, cfg, transformer_profile(cfg, seq_len=SEQ), env_cfg, tables,
                          state, actions, batch, pricing.numpy_tables(tables).cut_bytes)
    delta = {k: v - before[k] for k, v in _counts().items()}
    want = _launches(flash_attention=cfg.n_layers,
                     quant_matmul=7 * cfg.n_layers if rec["version"] == "w8" else 0)
    check(not rec["terminal"] and rec["measured_bytes"] == rec["expected_bytes"]
          and rec["logits_finite"] and rec["logits_shape"] == (BATCH, SEQ, cfg.vocab_size)
          and delta == want,
          f"{loop.format_slot(len(records), rec)}  {what}, launches {delta}")
    records.append(rec)
    return rec


def _serve_slots(cfg, eng, batch, env_cfg, tables, decide_fn, what):
    """LOOP_SLOTS slots of ``decide_fn(state)`` -> ``_serve_one`` ->
    ``env_step`` from an ``env_reset`` state (generator seed 7); when the
    controller picked no w8, the w8 version at greedy_oracle's cut is
    served too, so the w8 path (quant_matmul) runs on every run. Returns
    the slots' records."""
    import torch
    from repro_torch.core import env_reset, env_step, transformer_profile
    from repro_torch.core.baselines import greedy_oracle
    from repro_torch.launch import split_serving as loop
    gen = torch.Generator(device=tables.device).manual_seed(7)
    state = env_reset(env_cfg, tables, gen)
    print(f"  {loop.HEADER}")
    records = []
    for _ in range(LOOP_SLOTS):
        actions = decide_fn(state)
        _serve_one(cfg, eng, batch, env_cfg, tables, state, actions, what, records)
        state, _, _ = env_step(env_cfg, tables, state, actions, gen)
    if not any(rec["version"] == "w8" for rec in records):
        actions = greedy_oracle(env_cfg, tables, state).clone()
        actions[:, 0] = [v.version for v in transformer_profile(cfg, seq_len=SEQ).versions
                         ].index("w8")
        _serve_one(cfg, eng, batch, env_cfg, tables, state, actions,
                   f"w8 at greedy_oracle's cut (the {what} chose no w8)", records)
    return records


def phase_closed_loop(dev, cfg, eng, batch):
    """3a. The paper's loop on the card: A2C trained on the transformer env
    of ``cfg`` at the served sequence length, its greedy decisions executed
    by phase 3's engine (its bf16/w8/w4 models), the bytes at the cut held
    against the table's."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import (A2CConfig, decide, make_tpu_env, measured_state, pricing,
                                  train_agent)
    from repro_torch.core.actor_critic import Agent
    print(f"== 3a. closed loop: A2C on the transformer env of full-width {cfg.name} "
          f"(seq {SEQ}), decisions served by SplitServingEngine on {BATCH} x {SEQ} tokens")

    env_cfg, tables = make_tpu_env([cfg.name], seq_len=SEQ, device=dev)
    _, cpu_tables = make_tpu_env([cfg.name], seq_len=SEQ, device="cpu")
    arrays = [f.name for f in dataclasses.fields(tables)
              if isinstance(getattr(tables, f.name), torch.Tensor)]
    check(tables.device == dev and all(
        torch.equal(getattr(tables, k).cpu(), getattr(cpu_tables, k)) for k in arrays),
        f"tables built on the card equal the CPU's exactly ({', '.join(arrays)}; "
        f"{tables.n_versions} versions x {tables.n_cuts} cuts)")

    ac = A2CConfig(episodes=LOOP_EPISODES, batch_envs=LOOP_ENVS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent, hist = train_agent(env_cfg, tables, ac, seed=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    rewards = [h["mean_reward"] for h in hist]
    first, last = statistics.mean(rewards[:15]), statistics.mean(rewards[-15:])
    finite = all(math.isfinite(h["loss"]) for h in hist)
    check(finite and last > first,
          f"A2C on the card: {LOOP_EPISODES} updates of {LOOP_ENVS} envs x "
          f"{env_cfg.episode_len} slots in {train_s:.2f} s "
          f"({train_s / LOOP_EPISODES * 1e3:.1f} ms an update), losses finite={finite}, "
          f"mean reward first 15 {first:+.5f} -> last 15 {last:+.5f}")

    # the trained controller on the CPU: same decisions, same prices
    cpu_agent = Agent({k: v.detach().cpu() for k, v in agent.flat_params().items()})
    r = np.random.default_rng(11)
    lp, pw = env_cfg.latency, env_cfg.power
    same, worst, states = 0, 0.0, []
    for _ in range(LOOP_STATES):
        kw = dict(battery_j=r.uniform(0.0, pw.battery_j, 1),
                  bandwidth=r.uniform(lp.bw_min_bps, lp.bw_max_bps, 1),
                  p_tx=r.uniform(pw.p_tx_min, pw.p_tx_max, 1),
                  queue_jobs=float(r.uniform(0.0, 15.0)), load=r.uniform(0.0, 1.0, 1))
        s_card = measured_state(env_cfg, tables, **kw)
        s_cpu = measured_state(env_cfg, cpu_tables, **kw)
        a_card = decide(agent, env_cfg, tables, s_card)
        a_cpu = decide(cpu_agent, env_cfg, cpu_tables, s_cpu)
        same += bool(torch.equal(a_card.cpu(), a_cpu))
        states.append((s_card, a_card))
        br = pricing.price_actions(env_cfg, tables, pricing.view_from_state(s_card), a_card)
        view = pricing.view_from_state({k: v.numpy() for k, v in s_cpu.items()})
        ref = pricing.price_actions(env_cfg, pricing.numpy_tables(cpu_tables), view,
                                    a_cpu.numpy(), xp=np)
        for f in dataclasses.fields(pricing.PricingBreakdown):
            got = getattr(br, f.name).cpu().numpy().astype(np.float64)
            want = np.asarray(getattr(ref, f.name), dtype=np.float64)
            err = np.abs(got - want) / (LOOP_PRICE_TOL + np.abs(want))
            worst = max(worst, float(err.max()))
    check(same == LOOP_STATES and worst <= LOOP_PRICE_TOL,
          f"{LOOP_STATES} measured states: decide on the card equals decide on the CPU "
          f"({same}/{LOOP_STATES}); price_actions card against xp=numpy: worst "
          f"|d| / ({LOOP_PRICE_TOL} + |numpy|) = {worst:.3g} (limit {LOOP_PRICE_TOL})")

    # serving: decide -> resolve -> infer -> price -> env_step
    _reset_counts()
    records = _serve_slots(cfg, eng, batch, env_cfg, tables,
                           lambda state: decide(agent, env_cfg, tables, state), "controller")
    launches = _counts()

    decide_ms = []
    for s_card, _ in (states * 2)[:LOOP_DECIDES]:
        t0 = time.perf_counter()
        decide(agent, env_cfg, tables, s_card)
        torch.cuda.synchronize()
        decide_ms.append((time.perf_counter() - t0) * 1e3)
    timing = {"train_s": train_s, "ms_per_update": train_s / LOOP_EPISODES * 1e3,
              "reward_first15": first, "reward_last15": last,
              "decide_ms_median": statistics.median(decide_ms),
              "slots": [{"version": rec["version"], "cut": list(rec["cut"]),
                         "infer_ms": rec["infer_ms"], "bytes": rec["measured_bytes"]}
                        for rec in records]}
    print(f"  decide (eager, {LOOP_DECIDES} calls): median {timing['decide_ms_median']:.3f} ms; "
          f"closed-loop launches {launches}")
    return launches, timing


def same_sim_result(a, b) -> bool:
    """Two SimResults bit for bit, the cross-check aside: summary,
    selection histogram, every epoch-log column, per-request latencies."""
    import numpy as np
    ca, cb = a.epoch_log.columns, b.epoch_log.columns
    return (a.summary == b.summary and np.array_equal(a.selection_hist, b.selection_hist)
            and set(ca) == set(cb) and all(np.array_equal(ca[k], cb[k]) for k in ca)
            and np.array_equal(a.metrics.latencies_s, b.metrics.latencies_s))


def phase_fleet_loop(dev, cfg, eng, smi):
    """3c. The fleet loop: the tpu-execute preset's world at full width,
    its traffic simulated by ``simulate`` with the policy deciding on the
    card each epoch and ``ExecuteBackend`` serving sampled requests
    through phase 3's engine; then card against CPU bit for bit, the
    vectorized engine against the loop, and paper-mmpp-burst."""
    import numpy as np
    import torch
    from repro_torch.core import make_tpu_env, transformer_profile
    from repro_torch.core.actor_critic import Agent
    from repro_torch.core.baselines import greedy_oracle
    from repro_torch.policies import A2CPolicy, StaticPolicy, build_policy
    from repro_torch.scenarios import get_scenario
    from repro_torch.sim import AnalyticalBackend, ExecuteBackend, FleetConfig, simulate
    sc = get_scenario("tpu-execute")
    print(f"== 3c. fleet loop: the {sc.name} world at full width ({FLEET_DEVICES} x "
          f"{cfg.name}, seq {SEQ}), {sc.trace} {sc.trace_kw} rps a device, "
          f"{sc.slot_seconds} s slots, SLO {sc.slo_s} s, {sc.n_requests} requests, seed "
          f"{sc.seeds[0]}; ExecuteBackend (sample {sc.sample}) over phase 3's engine")

    def world(device):
        env_cfg, tables = make_tpu_env([cfg.name] * FLEET_DEVICES, weights=sc.weights,
                                       reduced=False, seq_len=SEQ,
                                       slot_seconds=sc.slot_seconds, peak_rps=sc.peak_rps,
                                       device=device)
        return env_cfg, tables

    env_cfg, tables = world(dev)
    cpu_env, cpu_tables = world("cpu")
    profile = transformer_profile(cfg, seq_len=SEQ)
    mids = np.zeros(FLEET_DEVICES, np.int32)
    trace = sc.build_trace()
    fleet = FleetConfig(slo_s=sc.slo_s, engine="loop")

    a2c = A2CPolicy(env_cfg, tables, episodes=FLEET_EPISODES, batch_envs=FLEET_ENVS,
                    entropy_coef=sc.entropy_coef)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = a2c.train(seed=sc.train_seed, trace=sc.build_train_trace())
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    finite = all(math.isfinite(h["loss"]) for h in hist)
    check(finite and len(hist) == FLEET_EPISODES,
          f"A2CPolicy trained on the card through make_task_sampler({sc.build_train_trace()}): "
          f"{FLEET_EPISODES} updates of {FLEET_ENVS} envs in {train_s:.2f} s, losses "
          f"finite={finite}")
    cpu_a2c = A2CPolicy(cpu_env, cpu_tables).set_params(
        Agent({k: v.detach().cpu() for k, v in a2c.params.flat_params().items()}))
    names = ["greedy_oracle", "device_only", "full_offload", "a2c"]
    card = {n: a2c if n == "a2c" else build_policy(n, env_cfg, tables) for n in names}
    cpu = {n: cpu_a2c if n == "a2c" else build_policy(n, cpu_env, cpu_tables) for n in names}

    def w8_at_oracle_cut(env_, tables_, state, generator=None):
        actions = greedy_oracle(env_, tables_, state).clone()
        actions[:, 0] = [v.version for v in profile.versions].index("w8")
        return actions

    timing = {"card": smi, "a2c_train_s": train_s, "policies": {}}
    _reset_counts()
    w8_served = False
    for name in names:
        backend = ExecuteBackend(env_cfg, tables, [cfg], [profile], [eng], seq_len=SEQ,
                                 sample=sc.sample)
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulate(env_cfg, tables, card[name], trace, n_requests=sc.n_requests,
                       seed=sc.seeds[0], fleet=fleet, backend=backend, model_ids=mids)
        wall = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in _counts().items()}
        cc = res.cross_check or {}
        recs = cc.get("records", [])
        n_w8 = sum(r["version"] == "w8" for r in recs)
        w8_served |= n_w8 > 0
        want = _launches(flash_attention=2 * len(recs) * cfg.n_layers,
                         quant_matmul=2 * n_w8 * 7 * cfg.n_layers)
        ratios = [r["wall_s"] / r["est_s"] for r in recs]
        check(cc.get("bytes_exact") is True and cc["samples"] > 0
              and all(r["logits_finite"] for r in recs)
              and all(math.isfinite(x) for x in ratios + [cc["latency_ratio_median"],
                                                          cc["latency_ratio_max"]])
              and delta == want,
              f"{name}: {res.epochs} epochs, {res.served} requests in {wall:.3f} s "
              f"({res.served / wall:.0f} simulated requests/s), slo_attainment "
              f"{res.summary['slo_attainment']:.4f}; cross-check {cc.get('samples')} samples "
              f"({n_w8} w8) bytes_exact={cc.get('bytes_exact')} logits finite, launches "
              f"{delta} (2 infers a sample: {cfg.n_layers} flash_attention an infer, "
              f"{7 * cfg.n_layers} quant_matmul a w8 infer)")
        print(f"    samples (version, cut, bytes, wall_s): " + json.dumps(
            [(r["version"], r["cut"][1], r["measured_bytes"], round(r["wall_s"], 5))
             for r in recs]))
        print(f"    latency ratio (reported, not checked): median "
              f"{cc.get('latency_ratio_median')} max {cc.get('latency_ratio_max')} "
              f"within {cc.get('latency_tolerance')}x: {cc.get('latency_within_tolerance')}")
        ref = simulate(cpu_env, cpu_tables, cpu[name], trace, n_requests=sc.n_requests,
                       seed=sc.seeds[0], fleet=fleet,
                       backend=AnalyticalBackend(cpu_env, cpu_tables), model_ids=mids)
        vec = simulate(env_cfg, tables, card[name], trace, n_requests=sc.n_requests,
                       seed=sc.seeds[0], model_ids=mids,
                       fleet=FleetConfig(slo_s=sc.slo_s, engine="vectorized"))
        check(same_sim_result(res, ref) and same_sim_result(res, vec),
              f"{name}: card = CPU (tables on the CPU, AnalyticalBackend) and vectorized "
              f"= loop on the card, bit for bit (summary, selection_hist, epoch_log, "
              f"latencies)")
        timing["policies"][name] = {
            "epochs": res.epochs, "wall_s": wall, "requests_per_s": res.served / wall,
            "decide_ms_median": 1e3 * float(np.median(res.decide_s)),
            "cpu_decide_ms_median": 1e3 * float(np.median(ref.decide_s)),
            "sample_wall_s": [r["wall_s"] for r in recs],
            "latency_ratio_median": cc.get("latency_ratio_median"),
            "latency_ratio_max": cc.get("latency_ratio_max"),
            "latency_within_tolerance": cc.get("latency_within_tolerance")}
        print(f"    decide (measured_state + act + host copy, timed in these runs) median "
              f"{timing['policies'][name]['decide_ms_median']:.3f} ms an epoch on the card, "
              f"{timing['policies'][name]['cpu_decide_ms_median']:.3f} ms on the CPU")
        if name == names[-1] and not w8_served:
            # the w8 path (quant_matmul) runs in this phase on every run
            names.append("w8@greedy_oracle")
            card[names[-1]] = StaticPolicy(env_cfg, tables, w8_at_oracle_cut)
            cpu[names[-1]] = StaticPolicy(cpu_env, cpu_tables, w8_at_oracle_cut)
    launches = _counts()

    mm = get_scenario("paper-mmpp-burst")
    env_c, tab_c, mids_c, _ = mm.build_env(device=dev)
    env_h, tab_h, mids_h, _ = mm.build_env(device="cpu")
    same, t_card, epochs, decide_card, decide_cpu = 0, 0.0, 0, [], []
    for name in ("greedy_oracle", "device_only", "full_offload"):
        pc, ph = build_policy(name, env_c, tab_c), build_policy(name, env_h, tab_h)
        for seed in mm.seeds:
            t0 = time.perf_counter()
            a = simulate(env_c, tab_c, pc, mm.build_trace(), n_requests=mm.n_requests,
                         seed=seed, fleet=FleetConfig(slo_s=mm.slo_s), model_ids=mids_c)
            t_card += time.perf_counter() - t0
            epochs += a.epochs
            decide_card.append(a.decide_s)
            b = simulate(env_h, tab_h, ph, mm.build_trace(), n_requests=mm.n_requests,
                         seed=seed, fleet=FleetConfig(slo_s=mm.slo_s), model_ids=mids_h)
            same += same_sim_result(a, b)
            decide_cpu.append(b.decide_s)
    n_runs = 3 * len(mm.seeds)
    check(same == n_runs,
          f"{mm.name}: greedy_oracle, device_only, full_offload on seeds {list(mm.seeds)} at "
          f"{mm.n_requests} requests: card = CPU bit for bit in {same}/{n_runs} runs "
          f"({epochs} epochs on the card in {t_card:.2f} s, {epochs / t_card:.0f} epochs/s)")
    timing[mm.name] = {"epochs": epochs, "card_s": t_card,
                       "decide_ms_median": 1e3 * float(np.median(np.concatenate(decide_card))),
                       "cpu_decide_ms_median": 1e3 * float(np.median(np.concatenate(decide_cpu)))}
    print(f"    decide median {timing[mm.name]['decide_ms_median']:.3f} ms an epoch on the card, "
          f"{timing[mm.name]['cpu_decide_ms_median']:.3f} ms on the CPU")
    print(f"  fleet loop launches {launches}; card {smi}")
    world = {"card": (env_cfg, tables, a2c), "cpu": (cpu_env, cpu_tables, cpu_a2c),
             "scenario": sc, "model_ids": mids}
    return launches, timing, world


def _timed_updates(times):
    """Patch ``OnlineLearner._update`` so each update step it builds is
    timed between two card synchronizations (milliseconds into
    ``times``); returns the original, to restore."""
    import torch
    from repro_torch.online.adapt import OnlineLearner
    orig = OnlineLearner._update

    def _update(self, n):
        fn = orig(self, n)

        def timed(*args, **kw):
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed
    OnlineLearner._update = _update
    return orig


def _watch(policy):
    """Record a policy's decisions and the agents it is handed: each
    hot-swap's epoch (the number of decisions made so far) and a CPU copy
    of the agent's parameters."""
    log = {"decisions": [], "swaps": []}
    act, set_params = policy.act, policy.set_params

    def watched_act(state, generator=None):
        out = act(state, generator)
        log["decisions"].append(out.cpu().numpy().copy())
        return out

    def watched_set_params(agent):
        log["swaps"].append((len(log["decisions"]) - 1, {
            k: v.detach().cpu().clone() for k, v in agent.flat_params().items()}))
        return set_params(agent)
    policy.act, policy.set_params = watched_act, watched_set_params
    return log


def phase_drift_loop(dev, cfg, eng, batch, world):
    """3d. PPO on the card over phase 3a's env, its decisions served by
    phase 3's engine; then phase 3c's world at full width under
    link-brownout: static policies and the frozen A2C card = CPU bit for
    bit (adaptation included), the A2C adapted online at the preset's
    OnlineConfig against its CPU run, and the adapted decisions of the
    brownout and the recovered regime served by phase 3's engine."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.core import PPOConfig, decide, make_tpu_env, measured_state
    from repro_torch.core import ppo
    from repro_torch.core.actor_critic import Agent
    from repro_torch.online import OnlineConfig, get_schedule
    from repro_torch.online.adapt import OnlineLearner
    from repro_torch.policies import A2CPolicy, build_policy
    from repro_torch.scenarios import get_scenario
    from repro_torch.sim import FleetConfig, simulate
    print(f"== 3d. drift loop: PPO on the transformer env of full-width {cfg.name} (seq {SEQ}), "
          f"then phase 3c's world under link-brownout (onset {DRIFT_ONSET}, recovery "
          f"{DRIFT_RECOVER}, {DRIFT_REQUESTS} requests) with online adaptation")
    timing = {}

    # (a) PPO on the card
    env_cfg, tables = make_tpu_env([cfg.name], seq_len=SEQ, device=dev)
    _, cpu_tables = make_tpu_env([cfg.name], seq_len=SEQ, device="cpu")
    pc = PPOConfig(episodes=LOOP_EPISODES, batch_envs=LOOP_ENVS, epochs=PPO_EPOCHS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent, hist = ppo.train(env_cfg, tables, pc, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    rewards = [h["mean_reward"] for h in hist]
    first, last = statistics.mean(rewards[:15]), statistics.mean(rewards[-15:])
    finite = all(math.isfinite(h["loss"]) for h in hist)
    check(finite and last > first,
          f"PPO on the card: {LOOP_EPISODES} updates of {LOOP_ENVS} envs x "
          f"{env_cfg.episode_len} slots, {PPO_EPOCHS} surrogate passes each, in {train_s:.2f} s "
          f"({train_s / LOOP_EPISODES * 1e3:.1f} ms an update), losses finite={finite}, "
          f"mean reward first 15 {first:+.5f} -> last 15 {last:+.5f}")
    cpu_agent = Agent({k: v.detach().cpu() for k, v in agent.flat_params().items()})
    r = np.random.default_rng(12)
    lp, pw = env_cfg.latency, env_cfg.power
    same = 0
    for _ in range(LOOP_STATES):
        kw = dict(battery_j=r.uniform(0.0, pw.battery_j, 1),
                  bandwidth=r.uniform(lp.bw_min_bps, lp.bw_max_bps, 1),
                  p_tx=r.uniform(pw.p_tx_min, pw.p_tx_max, 1),
                  queue_jobs=float(r.uniform(0.0, 15.0)), load=r.uniform(0.0, 1.0, 1))
        same += bool(torch.equal(
            decide(agent, env_cfg, tables, measured_state(env_cfg, tables, **kw)).cpu(),
            decide(cpu_agent, env_cfg, cpu_tables, measured_state(env_cfg, cpu_tables, **kw))))
    check(same == LOOP_STATES, f"{LOOP_STATES} measured states: the PPO controller decides on "
          f"the card as on the CPU ({same}/{LOOP_STATES})")
    _reset_counts()
    records = _serve_slots(cfg, eng, batch, env_cfg, tables,
                           lambda state: decide(agent, env_cfg, tables, state), "PPO controller")
    timing.update(ppo_train_s=train_s, ppo_ms_per_update=train_s / LOOP_EPISODES * 1e3,
                  ppo_reward_first15=first, ppo_reward_last15=last,
                  ppo_slots=[(rec["version"], rec["cut"][1]) for rec in records])

    # (b) the drifting world: static policies and the frozen A2C, card = CPU
    sc = world["scenario"]
    mids = world["model_ids"]
    (w_env, w_tables, a2c), (c_env, c_tables, cpu_a2c) = world["card"], world["cpu"]
    sched = get_schedule("link-brownout", onset=DRIFT_ONSET, recover=DRIFT_RECOVER)
    regimes = sched.compile(w_env)
    fleet = FleetConfig(slo_s=sc.slo_s)
    kw = dict(n_requests=DRIFT_REQUESTS, seed=sc.seeds[0], fleet=fleet, model_ids=mids,
              schedule=sched)
    timing["policies"] = {}

    def regimes_of(res):
        return [{k: reg[k] for k in ("name", "start_epoch", "epochs", "mean_reward",
                                     "oracle_reward", "regret", "recovery_epochs")}
                for reg in res.adaptation["regimes"]]

    for name in ("device_only", "full_offload", "greedy_oracle", "a2c"):
        pc_, ph_ = ((a2c, cpu_a2c) if name == "a2c" else
                    (build_policy(name, w_env, w_tables), build_policy(name, c_env, c_tables)))
        t0 = time.perf_counter()
        res = simulate(w_env, w_tables, pc_, sc.build_trace(), **kw)
        wall = time.perf_counter() - t0
        ref = simulate(c_env, c_tables, ph_, sc.build_trace(), **kw)
        check(same_sim_result(res, ref) and res.adaptation == ref.adaptation
              and len(res.adaptation["regimes"]) == 3,
              f"{name} under link-brownout: {res.epochs} epochs, {res.served} requests in "
              f"{wall:.3f} s, card = CPU bit for bit (summary, selection_hist, epoch_log, "
              f"latencies, adaptation); regimes " + json.dumps(regimes_of(res)))
        timing["policies"][name] = {"regimes": regimes_of(res), "wall_s": wall,
                                    "decide_ms_median": 1e3 * float(np.median(res.decide_s)),
                                    "cpu_decide_ms_median": 1e3 * float(np.median(ref.decide_s))}

    # the A2C adapted online (the preset's OnlineConfig), on the card and on the CPU,
    # from the frozen agent; the learner must leave that agent as it was
    oc = get_scenario("link-brownout").build_online("a2c")
    frozen = {k: v.detach().clone() for k, v in a2c.params.flat_params().items()}
    runs, update_ms = {}, {}
    for where, (env_, tables_, base) in (("card", (w_env, w_tables, a2c)),
                                         ("cpu", (c_env, c_tables, cpu_a2c))):
        pol = A2CPolicy(env_, tables_).set_params(base.params)
        log = _watch(pol)
        update_ms[where] = []
        orig = _timed_updates(update_ms[where])
        try:
            t0 = time.perf_counter()
            res = simulate(env_, tables_, pol, sc.build_trace(), online=oc, **kw)
            wall = time.perf_counter() - t0
        finally:
            OnlineLearner._update = orig
        runs[where] = (res, log, pol, wall)
    (res, log, pol, wall), (ref, cpu_log, cpu_pol, _) = runs["card"], runs["cpu"]
    on, cpu_on = res.adaptation["online"], ref.adaptation["online"]
    first_up = log["swaps"][0][0] if log["swaps"] else None
    cpu_first_up = cpu_log["swaps"][0][0] if cpu_log["swaps"] else None
    n_same = next((i for i, (x, y) in enumerate(zip(log["decisions"], cpu_log["decisions"]))
                   if not np.array_equal(x, y)), min(len(log["decisions"]),
                                                     len(cpu_log["decisions"])))
    param_err = None
    if first_up is not None and cpu_first_up == first_up:
        p_card, p_cpu = log["swaps"][0][1], cpu_log["swaps"][0][1]
        param_err = max(float(((p_card[k] - p_cpu[k]).abs() / (1.0 + p_cpu[k].abs())).max())
                        for k in p_cpu)
    check(on["updates"] > 0 and first_up is not None and first_up == cpu_first_up
          and n_same > first_up and param_err is not None and param_err <= DRIFT_PARAM_TOL
          and all(torch.equal(v, frozen[k]) for k, v in a2c.params.flat_params().items()),
          f"a2c+online (gate {oc.gate}, explore_eps {oc.explore_eps}, window {oc.window}): "
          f"{res.epochs} epochs in {wall:.3f} s, learner {on} on the card, {cpu_on} on the CPU; "
          f"first update at epoch {first_up} (CPU {cpu_first_up}); decisions card = CPU for "
          f"the first {n_same} of {len(log['decisions'])} epochs; parameters after the first "
          f"update: worst |card - CPU| / (1 + |CPU|) = {param_err} (limit "
          f"{DRIFT_PARAM_TOL}); the frozen agent untouched")
    print(f"    a2c+online regimes on the card: {json.dumps(regimes_of(res))}")
    print(f"    a2c+online regimes on the CPU: {json.dumps(regimes_of(ref))}")
    print(f"    SimResult card = CPU after the first update (reported, not checked): "
          f"{same_sim_result(res, ref)}")
    timing["policies"]["a2c+online"] = {
        "regimes": regimes_of(res), "cpu_regimes": regimes_of(ref), "online": on,
        "cpu_online": cpu_on, "first_update_epoch": first_up,
        "decisions_equal_epochs": n_same, "epochs": res.epochs,
        "first_update_param_err": param_err, "wall_s": wall,
        "update_ms_median": statistics.median(update_ms["card"]) if update_ms["card"] else None,
        "cpu_update_ms_median": statistics.median(update_ms["cpu"]) if update_ms["cpu"] else None,
        "decide_ms_median": 1e3 * float(np.median(res.decide_s)),
        "cpu_decide_ms_median": 1e3 * float(np.median(ref.decide_s))}
    print(f"    online update (between two synchronizations) median "
          f"{timing['policies']['a2c+online']['update_ms_median']} ms on the card, "
          f"{timing['policies']['a2c+online']['cpu_update_ms_median']} ms on the CPU; decide "
          f"median {timing['policies']['a2c+online']['decide_ms_median']:.3f} ms on the card, "
          f"{timing['policies']['a2c+online']['cpu_decide_ms_median']:.3f} ms on the CPU")

    # host synchronizations an epoch, counted by torch's sync debug mode over an
    # always-adapting run (updates from the fourth epoch)
    spol = A2CPolicy(w_env, w_tables).set_params(a2c.params)
    marks = []
    act = spol.act

    def marked_act(state, generator=None):
        marks.append(len(caught))
        return act(state, generator)
    spol.act = marked_act
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            simulate(w_env, w_tables, spol, sc.build_trace(), n_requests=SYNC_REQUESTS,
                     seed=sc.seeds[0], fleet=fleet, model_ids=mids, schedule=sched,
                     online=OnlineConfig(gate="always", window=16, min_window=4))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [b - a for a, b in zip(marks, marks[1:])]
    timing["syncs_per_epoch"] = {"no_update": syncs[:3], "update": syncs[3:]}
    print(f"  host synchronizations an epoch (torch sync debug mode, from one decide to the "
          f"next): {syncs} (epochs 0-2 capture only, from epoch 3 an update too)")

    # (c) the adapted decisions served: the agent of the last update before the
    # recovery, on a measured state within the brownout's bounds; the final agent
    # on one within the recovered regime's
    brown = [p for e, p in log["swaps"] if e < DRIFT_RECOVER]
    served = {}
    r = np.random.default_rng(13)
    for what, params, reg in (("brownout", brown[-1] if brown else None, regimes[1]),
                              ("recovered", log["swaps"][-1][1] if log["swaps"] else None,
                               regimes[2])):
        check(params is not None, f"an adapted agent of the {what} regime")
        if params is None:
            continue
        adapted = Agent({k: v.to(dev) for k, v in params.items()})
        lp_, pw_ = reg.env_cfg.latency, reg.env_cfg.power
        state = measured_state(w_env, w_tables, battery_j=r.uniform(0.0, pw_.battery_j, 2),
                               bandwidth=r.uniform(lp_.bw_min_bps, lp_.bw_max_bps, 2),
                               p_tx=r.uniform(pw_.p_tx_min, pw_.p_tx_max, 2),
                               queue_jobs=float(r.uniform(0.0, 15.0)),
                               load=r.uniform(0.0, 1.0, 2), model_id=mids)
        actions = decide(adapted, w_env, w_tables, state)
        rec = _serve_one(cfg, eng, batch, reg.env_cfg, w_tables, state, actions,
                         f"adapted a2c in the {what} regime (bandwidth "
                         f"{float(state['bandwidth'][0]):.4g} b/s)", records)
        served[what] = (rec["version"], rec["cut"][1])
    moved = None if len(served) < 2 else served["brownout"][1] != served["recovered"][1]
    print(f"  adapted (version, cut): brownout {served.get('brownout')}, recovered "
          f"{served.get('recovered')}; the cut moves: {moved}")
    timing.update(adapted_served=served, cut_moved=moved)
    launches = _counts()
    print(f"  drift loop launches {launches}")
    return launches, timing


def phase_cluster_loop(dev, smi):
    """3e. The edge cluster: the edge-cluster preset's world (8 devices,
    hetero-4 x near-far x hysteresis) built on the card, the routers and
    baselines deciding on the card every epoch, card = CPU and vectorized =
    loop bit for bit; a routing A2C trained on the card (60 updates, the
    preset's 400 cut); then cluster-brownout at the preset's size, the
    routers and that A2C frozen card = CPU bit for bit, and the A2C adapted
    online against its CPU run. No kernel lies on this path: the routers
    price through the pricing core in torch, as the reference's do through
    ``jnp`` outside any Pallas kernel."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import measured_state
    from repro_torch.core.actor_critic import Agent
    from repro_torch.online.adapt import OnlineLearner
    from repro_torch.policies import A2CPolicy, build_policy
    from repro_torch.scenarios import get_scenario
    from repro_torch.sim import FleetConfig, simulate
    t_phase = time.perf_counter()
    sc = get_scenario("edge-cluster")
    print(f"== 3e. cluster loop: the {sc.name} world ({sc.devices} devices, {sc.pool} x "
          f"{sc.topology} x {sc.autoscale}, {sc.trace} {sc.trace_kw} rps a device, "
          f"{sc.slot_seconds} s slots, SLO {sc.slo_s} s, {sc.n_requests} requests at seeds "
          f"{list(sc.seeds)}); card {smi}")
    _reset_counts()
    env_cfg, tables, mids, _ = sc.build_env(device=dev)
    cpu_env, cpu_tables, _, _ = sc.build_env(device="cpu")
    arrays = [f.name for f in dataclasses.fields(tables)
              if isinstance(getattr(tables, f.name), torch.Tensor)]
    check(tables.device == dev and env_cfg == cpu_env and env_cfg.action_dim == 3 and all(
        torch.equal(getattr(tables, k).cpu(), getattr(cpu_tables, k)) for k in arrays),
        f"cluster env (S = {env_cfg.n_servers}, actions (version, cut, server)) built on the "
        f"card, its tables equal the CPU's exactly ({', '.join(arrays)})")
    timing = {"card": smi, "edge-cluster": {}, "cluster-brownout": {}}

    def same_cluster_result(a, b):
        return (same_sim_result(a, b) and np.array_equal(a.server_hist, b.server_hist)
                and a.adaptation == b.adaptation)

    def pool_of(res):
        return {k: res.summary[k] for k in ("slo_attainment", "server_energy_j",
                                            "scale_events", "mean_replicas")} | {
            "server_hist": res.server_hist.tolist()}

    def run_both(sc_, pols, envs, name, engines=("loop",), **kw):
        """Each seed on the card (each engine) and on the CPU; returns the
        card's loop runs, the wall seconds and whether every run equals."""
        (c_env, c_tab), (h_env, h_tab) = envs
        res, walls, same, dec_card, dec_cpu = [], [], True, [], []
        for seed in sc_.seeds:
            args = dict(n_requests=sc_.n_requests, seed=seed, model_ids=mids,
                        schedule=sc_.build_schedule(), autoscaler=sc_.build_autoscaler(), **kw)
            t0 = time.perf_counter()
            a = simulate(c_env, c_tab, pols[0], sc_.build_trace(),
                         fleet=FleetConfig(slo_s=sc_.slo_s), **args)
            walls.append(time.perf_counter() - t0)
            b = simulate(h_env, h_tab, pols[1], sc_.build_trace(),
                         fleet=FleetConfig(slo_s=sc_.slo_s), **args)
            same &= same_cluster_result(a, b)
            for engine in engines[1:]:
                v = simulate(c_env, c_tab, pols[0], sc_.build_trace(),
                             fleet=FleetConfig(slo_s=sc_.slo_s, engine=engine), **args)
                same &= same_cluster_result(a, v)
            res.append(a)
            dec_card.append(a.decide_s)
            dec_cpu.append(b.decide_s)
        epochs = sum(r.epochs for r in res)
        served = sum(r.served for r in res)
        t = {"wall_s": walls, "epochs_per_s": epochs / sum(walls),
             "requests_per_s": served / sum(walls),
             "decide_ms_median": 1e3 * float(np.median(np.concatenate(dec_card))),
             "cpu_decide_ms_median": 1e3 * float(np.median(np.concatenate(dec_cpu))),
             "per_seed": [pool_of(r) for r in res]}
        timing[sc_.name][name] = t
        print(f"    {name}: {epochs} epochs, {served} requests on the card in "
              f"{sum(walls):.3f} s ({t['epochs_per_s']:.0f} epochs/s, "
              f"{t['requests_per_s']:.0f} simulated requests/s); decide median "
              f"{t['decide_ms_median']:.3f} ms an epoch on the card, "
              f"{t['cpu_decide_ms_median']:.3f} ms on the CPU; per seed "
              + json.dumps(t["per_seed"]))
        return res, same

    # (a) the routers and the baselines decide on the card every epoch
    envs = ((env_cfg, tables), (cpu_env, cpu_tables))
    for name in ("round_robin", "join_shortest_queue", "local_only", "device_only",
                 "greedy_oracle"):
        pols = (build_policy(name, env_cfg, tables), build_policy(name, cpu_env, cpu_tables))
        res, same = run_both(sc, pols, envs, name, engines=("loop", "vectorized"))
        check(same and all(r.server_hist.sum() > 0 for r in res),
              f"{sc.name} {name} on seeds {list(sc.seeds)}: card = CPU and vectorized = loop "
              f"bit for bit (summary with the pool's energy, events and replicas, "
              f"selection_hist, server_hist, epoch_log, latencies)")

    # (b) a routing A2C trained on the card
    a2c = A2CPolicy(env_cfg, tables, episodes=CLUSTER_EPISODES, batch_envs=sc.batch_envs,
                    entropy_coef=sc.entropy_coef)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = a2c.train(seed=sc.train_seed, trace=sc.build_train_trace())
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    finite = all(math.isfinite(h["loss"]) for h in hist)
    cpu_a2c = A2CPolicy(cpu_env, cpu_tables).set_params(
        Agent({k: v.detach().cpu() for k, v in a2c.params.flat_params().items()}))
    r = np.random.default_rng(14)
    lp, pw = env_cfg.latency, env_cfg.power
    same, sampled = 0, set()
    g = torch.Generator().manual_seed(0)
    for t in range(CLUSTER_STATES):
        kw = dict(battery_j=r.uniform(0.0, pw.battery_j, sc.devices),
                  bandwidth=r.uniform(lp.bw_min_bps, lp.bw_max_bps, sc.devices),
                  p_tx=r.uniform(pw.p_tx_min, pw.p_tx_max, sc.devices),
                  queue_jobs=r.uniform(0.0, 25.0, env_cfg.n_servers),
                  load=r.uniform(0.0, 1.0, sc.devices), model_id=mids, t=t)
        s_card = measured_state(env_cfg, tables, **kw)
        same += bool(torch.equal(a2c.act(s_card).cpu(),
                                 cpu_a2c.act(measured_state(cpu_env, cpu_tables, **kw))))
        a2c.set_explore(1.0)
        sampled |= set(a2c.act(s_card, g)[:, 2].tolist())
        a2c.set_explore(0.0)
    check(finite and len(hist) == CLUSTER_EPISODES and len(sampled) > 1
          and same == CLUSTER_STATES,
          f"routing A2C on the card ({CLUSTER_EPISODES} updates of {sc.batch_envs} envs, "
          f"entropy {sc.entropy_coef}; the preset trains 400) in {train_s:.2f} s "
          f"({train_s / CLUSTER_EPISODES * 1e3:.1f} ms an update), losses finite={finite}, "
          f"mean reward first 15 {statistics.mean(h['mean_reward'] for h in hist[:15]):+.5f} "
          f"-> last 15 {statistics.mean(h['mean_reward'] for h in hist[-15:]):+.5f}; servers "
          f"sampled {sorted(sampled)}; decides on the card as on the CPU on "
          f"{same}/{CLUSTER_STATES} measured states")
    timing["a2c_train_s"] = train_s
    timing["a2c_ms_per_update"] = train_s / CLUSTER_EPISODES * 1e3
    res, same = run_both(sc, (a2c, cpu_a2c), envs, "a2c")
    check(same, f"{sc.name} a2c (trained on the card) on seeds {list(sc.seeds)}: card = CPU "
          f"bit for bit")

    # (c) cluster-brownout at the preset's size: routers and the A2C frozen
    bo = get_scenario("cluster-brownout")
    print(f"  {bo.name}: {bo.trace} {bo.trace_kw} rps a device, {bo.drift} {bo.drift_kw}, "
          f"{bo.n_requests} requests at seeds {list(bo.seeds)}")
    b_env, b_tables, b_mids, _ = bo.build_env(device=dev)
    h_env, h_tables, _, _ = bo.build_env(device="cpu")
    check(np.array_equal(b_mids, mids), f"{bo.name}: the fleet's models as {sc.name}'s")
    b_envs = ((b_env, b_tables), (h_env, h_tables))
    b_a2c = A2CPolicy(b_env, b_tables).set_params(a2c.params)
    h_a2c = A2CPolicy(h_env, h_tables).set_params(cpu_a2c.params)
    for name in ("round_robin", "join_shortest_queue", "local_only", "device_only", "a2c"):
        pols = ((b_a2c, h_a2c) if name == "a2c" else
                (build_policy(name, b_env, b_tables), build_policy(name, h_env, h_tables)))
        res, same = run_both(bo, pols, b_envs, name)
        regimes = [[reg["name"] for reg in x.adaptation["regimes"]] for x in res]
        check(same and all(len(names) >= 2 for names in regimes),
              f"{bo.name} {name}{' (frozen)' if name == 'a2c' else ''} on seeds "
              f"{list(bo.seeds)}: card = CPU bit for bit, adaptation included (regimes "
              f"reached {regimes})")

    # the A2C adapted online (the '+online' roster's OnlineConfig), card and CPU
    oc = bo.build_online("a2c")
    frozen = {k: v.detach().clone() for k, v in b_a2c.params.flat_params().items()}
    runs, update_ms = {}, {}
    for where, (env_, tables_, base) in (("card", (b_env, b_tables, b_a2c)),
                                         ("cpu", (h_env, h_tables, h_a2c))):
        pol = A2CPolicy(env_, tables_).set_params(base.params)
        log = _watch(pol)
        update_ms[where] = []
        orig = _timed_updates(update_ms[where])
        try:
            t0 = time.perf_counter()
            res = simulate(env_, tables_, pol, bo.build_trace(), n_requests=bo.n_requests,
                           seed=bo.seeds[0], model_ids=mids, fleet=FleetConfig(slo_s=bo.slo_s),
                           schedule=bo.build_schedule(), autoscaler=bo.build_autoscaler(),
                           online=oc)
            wall = time.perf_counter() - t0
        finally:
            OnlineLearner._update = orig
        runs[where] = (res, log, wall)
    (res, log, wall), (ref, cpu_log, _) = runs["card"], runs["cpu"]
    on, cpu_on = res.adaptation["online"], ref.adaptation["online"]
    first_up = log["swaps"][0][0] if log["swaps"] else None
    cpu_first_up = cpu_log["swaps"][0][0] if cpu_log["swaps"] else None
    n_same = next((i for i, (x, y) in enumerate(zip(log["decisions"], cpu_log["decisions"]))
                   if not np.array_equal(x, y)), min(len(log["decisions"]),
                                                     len(cpu_log["decisions"])))
    param_err = None
    if first_up is not None and cpu_first_up == first_up:
        p_card, p_cpu = log["swaps"][0][1], cpu_log["swaps"][0][1]
        param_err = max(float(((p_card[k] - p_cpu[k]).abs() / (1.0 + p_cpu[k].abs())).max())
                        for k in p_cpu)
    check(on["updates"] > 0 and first_up is not None and first_up == cpu_first_up
          and n_same > first_up and param_err is not None and param_err <= DRIFT_PARAM_TOL
          and all(torch.equal(v, frozen[k]) for k, v in b_a2c.params.flat_params().items()),
          f"{bo.name} a2c+online (gate {oc.gate}, explore_eps {oc.explore_eps}, window "
          f"{oc.window}) seed {bo.seeds[0]}: {res.epochs} epochs in {wall:.3f} s, learner {on} "
          f"on the card, {cpu_on} on the CPU; first update at epoch {first_up} (CPU "
          f"{cpu_first_up}); decisions card = CPU for the first {n_same} of "
          f"{len(log['decisions'])} epochs; parameters after the first update: worst "
          f"|card - CPU| / (1 + |CPU|) = {param_err} (limit {DRIFT_PARAM_TOL}); the frozen "
          f"agent untouched")
    timing["cluster-brownout"]["a2c+online"] = {
        "online": on, "cpu_online": cpu_on, "first_update_epoch": first_up,
        "decisions_equal_epochs": n_same, "epochs": res.epochs, "wall_s": wall,
        "first_update_param_err": param_err, **pool_of(res),
        "update_ms_median": statistics.median(update_ms["card"]) if update_ms["card"] else None,
        "cpu_update_ms_median": statistics.median(update_ms["cpu"]) if update_ms["cpu"] else None,
        "decide_ms_median": 1e3 * float(np.median(res.decide_s)),
        "cpu_decide_ms_median": 1e3 * float(np.median(ref.decide_s))}
    t = timing["cluster-brownout"]["a2c+online"]
    print(f"    a2c+online: slo_attainment {res.summary['slo_attainment']:.4f}, server_hist "
          f"{res.server_hist.tolist()}; online update median {t['update_ms_median']} ms on "
          f"the card, {t['cpu_update_ms_median']} ms on the CPU; decide median "
          f"{t['decide_ms_median']:.3f} ms on the card, {t['cpu_decide_ms_median']:.3f} ms on "
          f"the CPU; card {smi}")
    launches = _counts()
    check(launches == _launches(), f"cluster loop launches {launches}: no kernel lies on "
          f"this path")
    timing["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 3e took {timing['phase_s']:.1f} s")
    return launches, timing


def _scan_close(a, b, shares: bool) -> str:
    """Where ``a`` parts from ``b`` beyond the scan contract's statistical
    limits ('' when within them), with the numbers compared."""
    import numpy as np
    sa, sb = a.summary, b.summary
    bad = []
    if not abs(sa["slo_attainment"] - sb["slo_attainment"]) < SCAN_SLO_ABS:
        bad.append(f"slo {sa['slo_attainment']:.5f} vs {sb['slo_attainment']:.5f}")
    for k, rel in (("mean", SCAN_MEAN_REL), ("energy_j", SCAN_ENERGY_REL)):
        if not abs(sa[k] - sb[k]) <= rel * abs(sb[k]):
            bad.append(f"{k} {sa[k]:.6g} vs {sb[k]:.6g}")
    if shares:
        ha, hb = a.selection_hist, b.selection_hist
        gap = float(np.abs(ha / ha.sum() - hb / hb.sum()).max())
        if not gap <= SCAN_SHARE_ABS:
            bad.append(f"selection shares apart by {gap:.4f}")
    return "; ".join(bad)


def _scan_close_by_epoch(ta, tb) -> str:
    """Two timelines of one world held epoch by epoch where their
    decision-time server queue is equal: energy, SLO attainment and mean
    latency of each such epoch within the scan contract's limits. Returns
    (the queue paths and how many epochs were compared, '' when within
    the limits (at least one epoch compared) else where they part)."""
    import numpy as np
    qa, qb = ta.column("queue_jobs"), tb.column("queue_jobs")
    same = np.isclose(qa, qb, rtol=1e-6, atol=1e-6)
    ea, eb = ta.column("energy_wh")[same], tb.column("energy_wh")[same]
    sa = ta.column("slo_hits")[same] / np.maximum(ta.column("arrivals")[same], 1)
    sb = tb.column("slo_hits")[same] / np.maximum(tb.column("arrivals")[same], 1)
    ma, mb = ta.column("lat_mean")[same], tb.column("lat_mean")[same]
    bad = []
    if not same.any():
        bad.append("no epoch at an equal queue")
    if not np.all(np.abs(ea - eb) <= SCAN_ENERGY_REL * np.abs(eb)):
        bad.append(f"energy by epoch {ea.tolist()} vs {eb.tolist()}")
    if not np.all(np.abs(sa - sb) < SCAN_SLO_ABS):
        bad.append(f"slo by epoch {sa.tolist()} vs {sb.tolist()}")
    if not np.all(np.abs(ma - mb) <= SCAN_MEAN_REL * np.abs(mb)):
        bad.append(f"mean by epoch {ma.tolist()} vs {mb.tolist()}")
    note = (f"queue {qa.tolist()} vs {qb.tolist()}, {int(same.sum())} of {same.size} "
            f"epochs at an equal queue")
    return note, "; ".join(bad)


def _same_workload(a, b) -> bool:
    import numpy as np
    return ((a.epochs, a.served, a.duration_s) == (b.epochs, b.served, b.duration_s)
            and np.array_equal(a.epoch_log.column("arrivals"), b.epoch_log.column("arrivals"))
            and a.selection_hist.sum() == b.selection_hist.sum())


def _loop_syncs(pol, run):
    """``run()`` under torch's sync debug mode, ``pol.act`` marking each
    epoch's decide: (its result, the host synchronizations from one decide
    to the next, their messages)."""
    import warnings
    import torch
    marks, act = [], pol.act

    def marked_act(state, generator=None):
        marks.append(len(caught))
        return act(state, generator)
    pol.act = marked_act
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        pol.act = act
    syncs = [b - a for a, b in zip(marks, marks[1:])]
    msgs = sorted({str(w.message)[:120] for w in caught[marks[0]:marks[-1]]}) if marks else []
    return out, syncs, msgs


def _scan_profile(run, epochs: int) -> dict:
    """One scan run under torch.profiler and the obs recorder: kernel
    launches an epoch, the device busy time (kernels and copies, one
    stream) beside the wall, and the wall of the host's presample and of
    the loop (the ``fleet.scan.presample`` and ``fleet.scan`` spans)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            obs.recording() as rec:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = rec.report()["phases"]
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
    busy = sum(dev_us(e) for e in events if e.device_type == DeviceType.CUDA) / 1e6
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    nccl = sum(e.count for e in events
               if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower())
    top = sorted((e for e in events if e.device_type == DeviceType.CUDA), key=dev_us,
                 reverse=True)[:6]
    return {"profiled_wall_s": wall, "device_busy_s": busy,
            "presample_s": spans["fleet.scan.presample"]["total_s"],
            "loop_s": spans["fleet.scan"]["total_s"],
            "idle_share": 1 - busy / wall if wall > 0 else None,
            "launches_per_epoch": launches / epochs, "nccl_kernels_per_epoch": nccl / epochs,
            "top_kernels_ms_per_epoch": [(e.key[:60], dev_us(e) / 1e3 / epochs) for e in top]}


def phase_scan_engine(dev, smi):
    """3f. The scan engine (``sim.megafleet.simulate_scan``): the
    megafleet world (100,000 devices, 5,000,000 requests) built on the
    card, the three static policies through the scan on the card twice
    (identical), on the CPU and through the vectorized engine (deciding on
    the card), held to the scan contract; host synchronizations inside the
    scan's epoch loop (zero), launches an epoch, device busy time, peak
    memory. Then diurnal-fleet: device_only and a card-trained A2C under
    the scan, the timeline on all three engines recording-neutral and its
    file read back; cluster-brownout with the timeline on. No kernel lies
    on this path: the reference runs it as jnp inside jit."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.obs import read_timeline, write_timeline
    from repro_torch.policies import A2CPolicy, build_policy
    from repro_torch.scenarios import get_scenario
    from repro_torch.sim import FleetConfig, simulate
    t_phase = time.perf_counter()
    _reset_counts()
    sc = get_scenario("megafleet")
    print(f"== 3f. scan engine: the {sc.name} world ({sc.devices} devices, {sc.trace} "
          f"{sc.trace_kw} rps a device, {sc.slot_seconds} s slots, SLO {sc.slo_s} s, "
          f"{sc.n_requests} requests, seed {sc.seeds[0]}); card {smi}")
    env_cfg, tables, mids, _ = sc.build_env(device=dev)
    cpu_env, cpu_tables, _, _ = sc.build_env(device="cpu")
    check(tables.device == dev and env_cfg == cpu_env,
          f"{sc.name} env built on the card ({tables.device}), config equal to the CPU's")
    timing = {"card": smi, sc.name: {}}
    seed = sc.seeds[0]

    def run(env_, tables_, pol, engine, n_requests=sc.n_requests, sc_=sc, mids_=mids, **fl):
        t0 = time.perf_counter()
        res = simulate(env_, tables_, pol, sc_.build_trace(), n_requests=n_requests,
                       seed=sc_.seeds[0], model_ids=mids_,
                       fleet=FleetConfig(slo_s=sc_.slo_s, engine=engine, **fl))
        if tables_.device.type == "cuda":
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def rates(res, wall):
        return {"wall_s": wall, "epochs_per_s": res.epochs / wall,
                "requests_per_s": res.served / wall}

    # (a) the megafleet world: scan on the card (twice), on the CPU, vectorized
    for name in SCAN_POLICIES:
        pol = build_policy(name, env_cfg, tables)
        cpu_pol = build_policy(name, cpu_env, cpu_tables)
        # the scan's own peak: above what earlier phases left resident
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        s1, w1 = run(env_cfg, tables, pol, "scan")
        s2, w2 = run(env_cfg, tables, pol, "scan")
        peak = torch.cuda.max_memory_allocated(dev) - resident
        h, wh = run(cpu_env, cpu_tables, cpu_pol, "scan")
        v, wv = run(env_cfg, tables, pol, "vectorized")
        (s3, _), syncs, sync_msgs = _loop_syncs(
            pol, lambda: run(env_cfg, tables, pol, "scan", timeline=True))
        prof = _scan_profile(lambda: run(env_cfg, tables, pol, "scan"), s1.epochs)
        static = name != "greedy_oracle"
        same = s1.summary == s2.summary and np.array_equal(s1.selection_hist, s2.selection_hist)
        exact = (_same_workload(s1, v) and _same_workload(s1, h)
                 and (not static or (np.array_equal(s1.selection_hist, v.selection_hist)
                                     and np.array_equal(s1.selection_hist, h.selection_hist))))
        far_v, far_h = _scan_close(s1, v, not static), _scan_close(s1, h, not static)
        parted = {}
        if not static:
            # a state-reading policy also reads the server's one queue: a single
            # noise path (Poisson background arrivals) that the fleet's size
            # does not average, and each engine draws its own. Where two runs'
            # queue paths part, the run-level numbers may part with them: hold
            # the epochs at an equal decision-time queue, epoch by epoch
            for label, other, env_, tables_, pol_, engine in (
                    ("vectorized", v, env_cfg, tables, pol, "vectorized"),
                    ("CPU scan", h, cpu_env, cpu_tables, cpu_pol, "scan")):
                qa, qb = (x.epoch_log.column("queue_jobs") for x in (s3, other))
                if np.allclose(qa, qb, rtol=1e-6, atol=1e-6):
                    continue
                tb = run(env_, tables_, pol_, engine, timeline=True)[0].timeline
                parted[label], far = _scan_close_by_epoch(s3.timeline, tb)
                if label == "vectorized":
                    far_v = far
                else:
                    far_h = far
        t = {"scan_card": rates(s2, w2), "scan_card_first": rates(s1, w1),
             "scan_cpu": rates(h, wh), "vectorized": rates(v, wv),
             "epochs": s1.epochs, "requests": s1.served, "peak_bytes": peak,
             "resident_bytes": resident,
             "syncs_per_epoch": syncs, **prof, "queue_paths_part": parted,
             "decide_ms_median_vectorized": 1e3 * float(np.median(v.decide_s)),
             "summary": {k: s1.summary[k] for k in ("slo_attainment", "mean", "p95",
                                                   "energy_j")},
             "summary_cpu": {k: h.summary[k] for k in ("slo_attainment", "mean", "p95",
                                                      "energy_j")},
             "summary_vectorized": {k: v.summary[k] for k in ("slo_attainment", "mean",
                                                             "p95", "energy_j")}}
        timing[sc.name][name] = t
        check(same and s3.summary == s1.summary and exact and not far_v and not far_h
              and sum(syncs) == 0 and len(syncs) == s1.epochs - 1,
              f"{sc.name} {name}: scan on the card twice identical; epochs {s1.epochs}, "
              f"served {s1.served}, epoch-log arrivals and selection totals "
              f"{'and histogram ' if static else ''}equal to the vectorized engine's and "
              f"the CPU scan's; SLO/mean/energy{'/shares' if not static else ''} within "
              f"{SCAN_SLO_ABS}/{SCAN_MEAN_REL:.0%}/{SCAN_ENERGY_REL:.0%}"
              f"{f'/{SCAN_SHARE_ABS}' if not static else ''} of the vectorized engine's "
              f"({far_v or 'within'}) and the CPU scan's ({far_h or 'within'})"
              + (f"; queue paths part, held epoch by epoch at an equal queue: "
                 f"{json.dumps(parted)}" if parted else "") + f"; the timeline on: summary unchanged; host "
              f"synchronizations in the loop {syncs}" + (f" ({sync_msgs})" if sync_msgs else ""))
        print(f"    {name}: scan (card) {w2:.3f} s ({t['scan_card']['epochs_per_s']:.1f} "
              f"epochs/s, {t['scan_card']['requests_per_s']:.4g} requests/s; first run "
              f"{w1:.3f} s), scan (CPU) {wh:.3f} s ({t['scan_cpu']['epochs_per_s']:.2f} "
              f"epochs/s), vectorized {wv:.3f} s ({t['vectorized']['epochs_per_s']:.2f} "
              f"epochs/s, decide median {t['decide_ms_median_vectorized']:.3f} ms); "
              f"{prof['launches_per_epoch']:.1f} launches an epoch, device busy "
              f"{prof['device_busy_s']:.4f} s of {prof['profiled_wall_s']:.4f} s profiled "
              f"(idle {prof['idle_share']:.1%}; presample {prof['presample_s']:.4f} s, "
              f"loop and copies {prof['loop_s']:.4f} s); peak {peak} bytes above the "
              f"{resident} resident; summary card "
              f"{json.dumps(t['summary'])}, CPU {json.dumps(t['summary_cpu'])}, vectorized "
              f"{json.dumps(t['summary_vectorized'])}; top kernels "
              f"{json.dumps(prof['top_kernels_ms_per_epoch'])}")

    # (b) diurnal-fleet: device_only and a card-trained A2C under the scan
    df = get_scenario("diurnal-fleet")
    d_env, d_tables, d_mids, _ = df.build_env(device=dev)
    n_small = SCAN_SMALL_REQUESTS
    print(f"  {df.name}: {df.devices} devices, {df.trace} {df.trace_kw} rps a device, "
          f"{df.slot_seconds} s slots, SLO {df.slo_s} s, {n_small} requests")
    dev_only = build_policy("device_only", d_env, d_tables)
    a, _ = run(d_env, d_tables, dev_only, "scan", n_small, df, d_mids)
    v, _ = run(d_env, d_tables, dev_only, "vectorized", n_small, df, d_mids)
    far = _scan_close(a, v, False)
    check(_same_workload(a, v) and np.array_equal(a.selection_hist, v.selection_hist)
          and not far, f"{df.name} device_only: scan on the card against the vectorized "
          f"engine: workload and selection histogram exact, {far or 'within the limits'}")
    a2c = A2CPolicy(d_env, d_tables, episodes=SCAN_A2C_EPISODES, batch_envs=df.batch_envs,
                    entropy_coef=df.entropy_coef)
    hist = a2c.train(seed=df.train_seed, trace=df.build_train_trace())
    x1, wx = run(d_env, d_tables, a2c, "scan", n_small, df, d_mids)
    x2, _ = run(d_env, d_tables, a2c, "scan", n_small, df, d_mids)
    xv, _ = run(d_env, d_tables, a2c, "vectorized", n_small, df, d_mids)
    check(all(math.isfinite(h_["loss"]) for h_ in hist) and x1.summary == x2.summary
          and np.array_equal(x1.selection_hist, x2.selection_hist) and _same_workload(x1, xv)
          and x1.selection_hist.sum() == x1.served - x1.metrics.dropped,
          f"{df.name} a2c trained on the card ({SCAN_A2C_EPISODES} updates) under the scan: "
          f"{x1.epochs} epochs in {wx:.3f} s, twice identical, workload and selection total "
          f"equal to the vectorized engine's; slo {x1.summary['slo_attainment']:.4f} "
          f"(vectorized {xv.summary['slo_attainment']:.4f})")
    # the timeline on all three engines, recording-neutral, and its file
    tls = {}
    for engine in ("loop", "vectorized", "scan"):
        off, _ = run(d_env, d_tables, dev_only, engine, n_small, df, d_mids)
        on, _ = run(d_env, d_tables, dev_only, engine, n_small, df, d_mids, timeline=True)
        tls[engine] = on.timeline
        check(same_sim_result(off, on) and off.timeline is None and len(on.timeline) == on.epochs
              and on.timeline.slo_report is not None,
              f"{df.name} timeline on the {engine} engine: SimResult bit-identical on and off, "
              f"{len(on.timeline)} rows, SLO report attainment "
              f"{on.timeline.slo_report.attainment:.4f}")
    scan_tl = tls["scan"]
    check(all(np.isnan(scan_tl.column(k)).all() for k in ("lat_p50", "lat_p95", "lat_p99"))
          and np.array_equal(scan_tl.column("arrivals"), tls["vectorized"].column("arrivals"))
          and np.isfinite(tls["vectorized"].column("lat_p95")).all(),
          f"{df.name} scan timeline: percentile columns NaN (the scan-carry rule), arrivals "
          f"equal to the vectorized engine's")
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "flight.json")
        write_timeline(path, [{"policy": "device_only", "seed": df.seeds[0], "timeline": tl}
                              for tl in tls.values()], meta={"scenario": df.name})
        doc = read_timeline(path)
    check([r["timeline"]["engine"] for r in doc["runs"]] == list(tls)
          and all(r["timeline"] == tl.to_json() for r, tl in zip(doc["runs"], tls.values())),
          "write_timeline/read_timeline round trip of the three runs")

    # (c) cluster-brownout (phase 3e's size, seed 0) with the timeline on
    bo = get_scenario("cluster-brownout")
    b_env, b_tables, b_mids, _ = bo.build_env(device=dev)
    jsq = build_policy("join_shortest_queue", b_env, b_tables)
    kw = dict(n_requests=bo.n_requests, seed=bo.seeds[0], model_ids=b_mids,
              schedule=bo.build_schedule())
    off = simulate(b_env, b_tables, jsq, bo.build_trace(), fleet=FleetConfig(slo_s=bo.slo_s),
                   autoscaler=bo.build_autoscaler(), **kw)
    on = simulate(b_env, b_tables, jsq, bo.build_trace(),
                  fleet=FleetConfig(slo_s=bo.slo_s, timeline=True, slo_target=bo.slo_target),
                  autoscaler=bo.build_autoscaler(), **kw)
    tl = on.timeline
    kinds = {}
    for ann in tl.annotations:
        kinds[ann["kind"]] = kinds.get(ann["kind"], 0) + 1
    check(same_sim_result(off, on) and np.array_equal(off.server_hist, on.server_hist)
          and off.adaptation == on.adaptation
          and all(tl.column(k).shape == (len(tl), b_env.n_servers)
                  for k in ("srv_queue", "srv_dvfs", "srv_replicas", "srv_power_w"))
          and kinds.get("autoscale", 0) > 0,
          f"{bo.name} join_shortest_queue seed {bo.seeds[0]} ({bo.n_requests} requests) with "
          f"the timeline on the card: SimResult bit-identical on and off; per-server series "
          f"({len(tl)} x {b_env.n_servers}); annotations {kinds}")
    timing["diurnal-fleet"] = {"a2c_scan_wall_s": wx, "a2c_slo": x1.summary["slo_attainment"]}
    launches = _counts()
    check(launches == _launches(), f"scan engine launches {launches}: no kernel lies on "
          f"this path")
    timing["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 3f took {timing['phase_s']:.1f} s")
    return launches, timing


def phase_decode_serving(cfg, model, batch):
    import numpy as np
    import torch
    from repro_torch.models import prefill
    from repro_torch.quant import build_version_params
    from repro_torch.serving import (ContinuousBatchingServer, Request, ServeConfig,
                                     ServingEngine)
    print(f"== 3b. decode serving: full-width {cfg.name}, {BATCH} x {SEQ}-token prompts, "
          f"{DEC_NEW} new tokens, cache_len {DEC_CACHE}")
    L, V = cfg.n_layers, cfg.vocab_size
    steps = DEC_NEW - 1                  # token 0 comes from the prefill
    serve = ServeConfig(max_new_tokens=DEC_NEW, cache_len=DEC_CACHE)
    eng = ServingEngine(cfg, model, serve)
    w8 = ServingEngine(cfg, build_version_params(cfg, model, ("w8",))["w8"], serve)
    eng.generate(batch)                  # warm-up
    torch.cuda.synchronize()

    def in_range(t):
        return tuple(t.shape) == (BATCH, DEC_NEW) and 0 <= t.min().item() and t.max().item() < V

    _reset_counts()
    gen_ms = []
    for _ in range(3):
        before = _counts()
        t0 = time.perf_counter()
        toks = eng.generate(batch)
        torch.cuda.synchronize()
        gen_ms.append((time.perf_counter() - t0) * 1e3)
        delta = {k: v - before[k] for k, v in _counts().items()}
        check(in_range(toks) and delta == _launches(flash_attention=L, flash_decode=L * steps),
              f"generate f32: {gen_ms[-1]:.1f} ms, launches {delta}")
    before = _counts()
    t0 = time.perf_counter()
    toks8 = w8.generate(batch)
    torch.cuda.synchronize()
    w8_ms = (time.perf_counter() - t0) * 1e3
    delta = {k: v - before[k] for k, v in _counts().items()}
    check(in_range(toks8) and delta == _launches(flash_attention=L, flash_decode=L * steps,
                                                 quant_matmul=7 * L * (1 + steps)),
          f"generate w8: {w8_ms:.1f} ms, launches {delta}, "
          f"{(toks8 == toks).float().mean().item():.3f} of its tokens equal f32's")

    r = np.random.default_rng(5)
    reqs = [Request(rid=i, tokens=r.integers(0, V, int(r.integers(64, 257))),
                    max_new_tokens=int(r.integers(16, 49))) for i in range(SRV_REQUESTS)]
    srv = ContinuousBatchingServer(cfg, model, max_batch=SRV_BATCH, cache_len=SRV_CACHE)
    before = _counts()
    t0 = time.perf_counter()
    for q in reqs:
        srv.submit(q)
    done = srv.run()
    torch.cuda.synchronize()
    srv_s = time.perf_counter() - t0
    delta = {k: v - before[k] for k, v in _counts().items()}
    st = srv.stats
    n_tok = sum(len(q.out) for q in done)
    check(len(done) == SRV_REQUESTS and all(q.done and not q.truncated for q in done)
          and all(len(q.out) == q.max_new_tokens for q in done)
          and delta == _launches(flash_attention=L * st.prefills,
                                 flash_decode=L * st.decode_steps),
          f"scheduler: {len(done)} requests, {n_tok} tokens in {srv_s:.2f} s "
          f"({n_tok / srv_s:.1f} tokens/s), prefills {st.prefills}, decode steps "
          f"{st.decode_steps}, wall steps {st.wall_steps}, reclaims {st.slot_reclaims}, "
          f"launches {delta}")
    print(f"  scheduler latency (wall steps): {json.dumps(st.latency_summary())}")
    launches = _counts()

    # timed apart from the counted run: prefill alone, and a same-prompt cohort
    pre_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        with torch.inference_mode():
            prefill(cfg, model, batch, total_len=DEC_CACHE)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    prompts = batch["tokens"][:2, :128]
    want = ServingEngine(cfg, model, ServeConfig(max_new_tokens=8, cache_len=SRV_CACHE)
                         ).generate({"tokens": prompts}).tolist()
    srv = ContinuousBatchingServer(cfg, model, max_batch=2, cache_len=SRV_CACHE)
    for i in range(2):
        srv.submit(Request(rid=i, tokens=prompts[i].cpu().numpy(), max_new_tokens=8))
    got = [q.out for q in sorted(srv.run(), key=lambda q: q.rid)]
    check(got == want, "scheduler cohort of 2 x 128-token prompts equals ServingEngine's tokens")

    gen, pre = statistics.median(gen_ms), statistics.median(pre_ms)
    timing = {"generate_ms": gen_ms, "prefill_ms": pre_ms, "per_token_ms": (gen - pre) / steps,
              "w8_generate_ms": w8_ms, "scheduler_s": srv_s,
              "scheduler_tokens_per_s": n_tok / srv_s}
    print(f"  decode serving: generate {gen:.1f} ms, prefill {pre:.1f} ms (medians of 3), "
          f"per token (generate - prefill) / {steps} = {timing['per_token_ms']:.3f} ms")
    print(f"  decode path launches: {launches}")
    check(launches["flash_decode"] == L * steps * 4 + L * st.decode_steps,
          "flash_decode launch count over the decode path run")
    return launches, timing


def phase_split_equals_full(cfg, model, batch):
    import torch
    from repro_torch.core.partition import split_forward
    from repro_torch.models import forward_logits
    print("== 4. split_forward equals forward_logits (card, cut 12)")
    with torch.inference_mode():
        full = forward_logits(cfg, model, batch)
        split = split_forward(cfg, model, batch, ("main", 12))
    err = (full - split).abs().max().item()
    check(torch.allclose(split, full, rtol=2e-4, atol=2e-4),
          f"split vs full: max_abs_err={err:.3g} (tol 2e-4)")


@contextlib.contextmanager
def _recording_quantize_act(rec):
    """Every activation quantization of the port (the projections' in
    ``kernels.ops`` and the link's in ``serving.engine``) appended to
    ``rec`` in call order as host arrays (x, codes, scale)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import engine
    fn = ops.quantize_act

    def quantize_act(x):
        q, scale = fn(x)
        rec.append(tuple(t.detach().cpu().numpy() for t in (x, q, scale)))
        return q, scale
    ops.quantize_act = engine.quantize_act = quantize_act
    try:
        yield rec
    finally:
        ops.quantize_act = engine.quantize_act = fn


def _first_flip(card_rec, cpu_rec):
    """Where the int8 codes of two runs' activation quantizations first
    part, and how: (index or None, calls, inputs' max gap there, largest
    code step, largest distance of a moved code's x / scale from a half-way
    point). Codes that part by one step at a half-way point come from f32
    rounding (sums in another order); any other start is a fault."""
    import numpy as np
    if [r[1].shape for r in card_rec] != [r[1].shape for r in cpu_rec]:
        return -1, len(card_rec), math.inf, math.inf, math.inf
    for i, (a, b) in enumerate(zip(card_rec, cpu_rec)):
        moved = a[1] != b[1]
        if moved.any():
            steps = np.abs(a[1].astype(np.int32) - b[1].astype(np.int32))[moved]
            t = (b[0] / b[2])[moved]
            half = np.abs(np.abs(t - np.floor(t)) - 0.5)
            return (i, len(card_rec), float(np.abs(a[0] - b[0]).max()), int(steps.max()),
                    float(half.max()))
    return None, len(card_rec), 0.0, 0, 0.0


def compare_split_card_cpu(eng, cpu_eng, one, cut, trace_w8=False):
    """One request through every version at ``cut``, on the card and on the
    CPU: bf16 and w4 within CPU_TOL, w8 within its own quantization error.
    With ``trace_w8`` (the cross-attention families, whose media or
    frames feed every cross layer, so that one int8 code flipped by f32
    rounding cascades through every layer after it) w8 is held within the
    max of that error and by where its first flipped code comes from:
    every activation quantization traced on both devices, the first that
    parts must part by single steps at half-way points (within
    FLIP_HALF), or none parts."""
    import torch
    cpu_logits = {}
    for version in VERSIONS:
        traced = trace_w8 and version == "w8"
        card_rec, cpu_rec = [], []
        with _recording_quantize_act(card_rec) if traced else contextlib.nullcontext():
            gl, gb = eng.infer(one, cut, version)
        with _recording_quantize_act(cpu_rec) if traced else contextlib.nullcontext():
            cl, cb = cpu_eng.infer({k: v.cpu() for k, v in one.items()}, cut, version)
        cpu_logits[version] = cl
        diff = (gl.cpu() - cl).abs()
        err, mean = diff.max().item(), diff.mean().item()
        what = (f"{version}: act_bytes {gb} == {cb}; max_abs_err={err:.3g} "
                f"mean_abs_err={mean:.3g}; max |logit| {cl.abs().max().item():.3g}")
        if version == "w8":
            qerr = (cl - cpu_logits["bf16"]).abs()
            within_max = err <= W8_GAP_MAX * qerr.max().item()
            what += (f" (w8 quantization error on the CPU: max {qerr.max().item():.3g}, "
                     f"mean {qerr.mean().item():.3g}; limits x{W8_GAP_MAX}")
            if traced:
                first, n, x_gap, step, half = _first_flip(card_rec, cpu_rec)
                ok = within_max and (first is None or (
                    first >= 0 and step == 1 and half <= FLIP_HALF))
                what += (f"; mean at x{mean / qerr.mean().item():.2f} of it; the first of "
                         f"{n} activation quantizations whose codes part: {first} (inputs "
                         f"within {x_gap:.3g}, largest step {step}, moved codes within "
                         f"{half:.3g} of a half-way point, limit {FLIP_HALF}))")
            else:
                ok = within_max and mean <= W8_GAP_MEAN * qerr.mean().item()
                what += f", x{W8_GAP_MEAN})"
        else:
            ok = torch.allclose(gl.cpu(), cl, rtol=CPU_TOL, atol=CPU_TOL)
            what += f" (tol {CPU_TOL})"
        check(gb == cb and ok, what)


def phase_card_vs_cpu(cfg, model, eng, batch):
    from repro_torch.models import export_params, load_jax_params
    from repro_torch.serving import SplitServingEngine
    print(f"== 5. card against CPU: 1 x {CPU_SEQ} tokens per version, cut 12")
    t0 = time.perf_counter()
    cpu_model = load_jax_params(cfg, export_params(model), device="cpu")
    cpu_eng = SplitServingEngine(cfg, cpu_model, versions=VERSIONS, device="cpu")
    compare_split_card_cpu(eng, cpu_eng, {"tokens": batch["tokens"][:1, :CPU_SEQ]}, ("main", 12))
    print(f"  card vs CPU phase: {time.perf_counter() - t0:.1f} s")
    return cpu_model


def compare_decode_card_cpu(cfg, model, cpu_model, one, n_new, extra=None):
    """``n_new`` greedy tokens of the prompt ``one`` (1, S) on the card (with
    the media or frames of ``extra``, on the card, for a cross-attention
    family); then the prefill's logits and each decode step's, fed the
    card's tokens, on both devices, held within CPU_TOL step by step."""
    import torch
    from repro_torch.models import decode_step, prefill
    from repro_torch.serving import ServeConfig, ServingEngine
    S = one.shape[1]
    total = S + n_new
    extra = extra or {}
    toks = ServingEngine(cfg, model, ServeConfig(max_new_tokens=n_new, cache_len=total)
                         ).generate({"tokens": one, **extra}).cpu()

    @torch.inference_mode()
    def logits(m, device):
        lg, cache = prefill(cfg, m, {"tokens": one.to(device),
                                     **{k: v.to(device) for k, v in extra.items()}},
                            total_len=total)
        out = [lg]
        for j in range(n_new - 1):
            lg, cache = decode_step(cfg, m, cache, toks[:, j].to(device), S + j)
            out.append(lg)
        return torch.stack(out, 1).cpu()        # (1, n_new, V)

    gl, cl = logits(model, model.tok_embed.device), logits(cpu_model, "cpu")
    errs = (gl - cl).abs().amax(dim=(0, 2)).tolist()
    agree = int((cl.argmax(-1) == toks).sum())
    check(torch.equal(gl.argmax(-1), toks) and max(errs) <= CPU_TOL and agree == n_new,
          f"decode logits step by step: max_abs_err {max(errs):.3g} (tol {CPU_TOL}), "
          f"per step {[float(f'{e:.3g}') for e in errs]}; the CPU's greedy token equals "
          f"the card's at {agree} of {n_new} steps")


def phase_decode_card_vs_cpu(cfg, model, cpu_model, batch):
    print(f"== 5b. decode, card against CPU: 1 x {CPU_SEQ} tokens, {CPU_NEW} new, f32")
    t0 = time.perf_counter()
    compare_decode_card_cpu(cfg, model, cpu_model, batch["tokens"][:1, :CPU_SEQ], CPU_NEW)
    print(f"  decode card vs CPU phase: {time.perf_counter() - t0:.1f} s")


def _median_ms(fn, reps):
    """Median host ms of ``fn()`` up to ``torch.cuda.synchronize()``, and
    its last result."""
    import torch
    ms, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, out


def phase_rg_split(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.partition import cut_activation_bytes, split_forward
    from repro_torch.models import forward_logits, init
    from repro_torch.serving import SplitServingEngine
    print(f"== 8. {RG_ARCH}: full width and depth through SplitServingEngine, "
          f"{RG_SPLIT_BATCH} x {RG_SPLIT_SEQ} tokens")
    cfg = get_config(RG_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == RG_PARAMS,
          f"init {cfg.name}: {cfg.n_layers} layers {cfg.block_pattern}, d_model {cfg.d_model}, "
          f"lru_width {cfg.resolved_lru_width}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, window {cfg.local_window}, d_ff {cfg.d_ff} {cfg.mlp_act}, "
          f"vocab {cfg.vocab_size}, {n_params} params (want {RG_PARAMS}), "
          f"{time.perf_counter() - t0:.2f} s")
    eng = SplitServingEngine(cfg, model, versions=VERSIONS)
    tokens = torch.randint(0, cfg.vocab_size, (RG_SPLIT_BATCH, RG_SPLIT_SEQ), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    batch = {"tokens": tokens}
    for version in VERSIONS:          # build each version's model, warm up
        eng.infer(batch, RG_CUTS[1], version)
    torch.cuda.synchronize()

    reps = 3
    link = cut_activation_bytes(cfg, (RG_SPLIT_BATCH, RG_SPLIT_SEQ))
    link_w8 = RG_SPLIT_BATCH * RG_SPLIT_SEQ * (cfg.d_model + 4)
    times = {}
    _reset_counts()
    for version in VERSIONS:
        qmm = RG_QMM if version == "w8" else 0
        for cut in RG_CUTS:
            before = _counts()
            ms, (logits, act_bytes) = _median_ms(lambda: eng.infer(batch, cut, version), reps)
            delta = {k: v - before[k] for k, v in _counts().items()}
            want = _launches(rglru_scan=RG_SCANS * reps, flash_attention=RG_ATTN * reps,
                             quant_matmul=qmm * reps)
            finite = bool(torch.isfinite(logits).all())
            shape_ok = tuple(logits.shape) == (RG_SPLIT_BATCH, RG_SPLIT_SEQ, cfg.vocab_size)
            want_bytes = link_w8 if version == "w8" else link
            times[f"{version}@{cut[0]}{cut[1]}"] = ms
            check(finite and shape_ok and act_bytes == want_bytes and delta == want,
                  f"infer {version} cut={cut}: act_bytes={act_bytes} (want {want_bytes}) "
                  f"ms={[round(t, 3) for t in ms]} launches over {reps} infers={delta} "
                  f"logits {tuple(logits.shape)} finite={finite}")
            del logits
    launches = _counts()
    n_infer = reps * len(VERSIONS) * len(RG_CUTS)
    print(f"{RG_ARCH} split path: {n_infer} infers, launches {launches}")
    check(launches == _launches(rglru_scan=n_infer * RG_SCANS, flash_attention=n_infer * RG_ATTN,
                                quant_matmul=reps * len(RG_CUTS) * RG_QMM),
          f"launch counts over the {RG_ARCH} split path run")

    with torch.inference_mode():
        full = forward_logits(cfg, model, batch)
        split = split_forward(cfg, model, batch, RG_CUTS[1])
    err = (full - split).abs().max().item()
    check(torch.allclose(split, full, rtol=2e-4, atol=2e-4),
          f"{RG_ARCH} split vs full at cut {RG_CUTS[1]}: max_abs_err={err:.3g} (tol 2e-4)")
    del full, split
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  peak device memory after the split path: {peak / 2**30:.2f} GiB ({peak} bytes)")
    return cfg, model, eng, launches, times, peak


def phase_rg_decode(dev, cfg, model):
    import numpy as np
    import torch
    from repro_torch.models import decode_step, forward_logits, prefill
    from repro_torch.serving import (ContinuousBatchingServer, Request, ServeConfig,
                                     ServingEngine)
    print(f"== 8b. {RG_ARCH} decode: {RG_BATCH} x {RG_SEQ}-token prompts (past the "
          f"{cfg.local_window}-token window), {RG_NEW} new tokens")
    V = cfg.vocab_size
    steps = RG_NEW - 1
    batch = {"tokens": torch.randint(0, V, (RG_BATCH, RG_SEQ), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(4))}
    eng = ServingEngine(cfg, model, ServeConfig(max_new_tokens=RG_NEW))
    eng.generate(batch)                  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    gen_ms = []
    for _ in range(2):
        before = _counts()
        ms, toks = _median_ms(lambda: eng.generate(batch), 1)
        gen_ms += ms
        delta = {k: v - before[k] for k, v in _counts().items()}
        in_range = 0 <= toks.min().item() and toks.max().item() < V
        check(tuple(toks.shape) == (RG_BATCH, RG_NEW) and in_range
              and delta == _launches(rglru_scan=RG_SCANS, flash_attention=RG_ATTN,
                                     flash_decode=RG_ATTN * steps),
              f"generate f32: {ms[0]:.1f} ms, launches {delta} ({RG_SCANS} rglru_scan and "
              f"{RG_ATTN} flash_attention in the prefill, {RG_ATTN} flash_decode and no "
              f"rglru_scan in each of the {steps} decode steps)")

    r = np.random.default_rng(5)
    reqs = [Request(rid=i, tokens=r.integers(0, V, int(r.integers(64, 257))),
                    max_new_tokens=int(r.integers(16, 49))) for i in range(RG_SRV_REQUESTS)]
    srv = ContinuousBatchingServer(cfg, model, max_batch=RG_SRV_BATCH, cache_len=RG_SRV_CACHE)
    before = _counts()
    t0 = time.perf_counter()
    for q in reqs:
        srv.submit(q)
    done = srv.run()
    torch.cuda.synchronize()
    srv_s = time.perf_counter() - t0
    delta = {k: v - before[k] for k, v in _counts().items()}
    st = srv.stats
    n_tok = sum(len(q.out) for q in done)
    check(len(done) == RG_SRV_REQUESTS and all(q.done and not q.truncated for q in done)
          and all(len(q.out) == q.max_new_tokens for q in done)
          and delta == _launches(rglru_scan=RG_SCANS * st.prefills,
                                 flash_attention=RG_ATTN * st.prefills,
                                 flash_decode=RG_ATTN * st.decode_steps),
          f"scheduler: {len(done)} requests (prompts {[len(q.tokens) for q in reqs]}), "
          f"{n_tok} tokens in {srv_s:.2f} s ({n_tok / srv_s:.1f} tokens/s), prefills "
          f"{st.prefills}, decode steps {st.decode_steps}, wall steps {st.wall_steps}, "
          f"reclaims {st.slot_reclaims}, launches {delta}")
    launches = _counts()                 # the generate and scheduler runs only

    # teacher-forced decode against the forward pass that ran the kernels
    full_toks = torch.cat([batch["tokens"], toks[:, :RG_TF_STEPS]], dim=1)
    with torch.inference_mode():
        want = forward_logits(cfg, model, {"tokens": full_toks})
        lg, cache = prefill(cfg, model, batch)
        ring = tuple(cache["period"]["s2"]["k"].shape)
        errs = [(lg - want[:, RG_SEQ - 1]).abs().max().item()]
        for j in range(RG_TF_STEPS):
            lg, cache = decode_step(cfg, model, cache, toks[:, j], RG_SEQ + j)
            errs.append((lg - want[:, RG_SEQ + j]).abs().max().item())
    del want, cache
    check(max(errs) <= RG_DECODE_TOL and ring[2] == cfg.local_window,
          f"prefill + {RG_TF_STEPS} teacher-forced decode steps against forward_logits on "
          f"the card: max_abs_err {max(errs):.3g} (tol {RG_DECODE_TOL}), per step "
          f"{[float(f'{e:.3g}') for e in errs]}; rings {ring}")

    pre_ms, _ = _median_ms(lambda: torch.inference_mode()(prefill)(cfg, model, batch), 3)
    gen, pre = statistics.median(gen_ms), statistics.median(pre_ms)
    timing = {"generate_ms": gen_ms, "prefill_ms": pre_ms, "per_token_ms": (gen - pre) / steps,
              "scheduler_s": srv_s, "scheduler_tokens_per_s": n_tok / srv_s}
    print(f"  {RG_ARCH} decode: generate {gen:.1f} ms, prefill {pre:.1f} ms, per token "
          f"(generate - prefill) / {steps} = {timing['per_token_ms']:.3f} ms")
    return batch, launches, timing


def phase_rg_card_vs_cpu(dev, cfg, model, batch):
    """Full width at depth RG_CPU_LAYERS (the first period and the tail):
    the card model's embedding, final norm and those steps, on both
    devices."""
    import copy
    from torch import nn
    from repro_torch.models import export_params, load_jax_params
    from repro_torch.serving import SplitServingEngine
    small = cfg.with_overrides(n_layers=RG_CPU_LAYERS)
    cut = ("period", 1)
    print(f"== 8c. {RG_ARCH} card against CPU: full width, {RG_CPU_LAYERS} layers, 1 x "
          f"{CPU_SEQ} tokens per version at cut {cut}, then {RG_CPU_STEPS} decode steps")
    t0 = time.perf_counter()
    head = copy.copy(model)              # shares every tensor of the card model
    head._modules = dict(model._modules)
    head.stacks = nn.ModuleDict({"period": model.stacks["period"][:1],
                                 "tail": model.stacks["tail"]})
    head.cfg = small
    flat = export_params(head)
    del head
    card, cpu = load_jax_params(small, flat, device=dev), load_jax_params(small, flat, device="cpu")
    del flat
    one = {"tokens": batch["tokens"][:1, :CPU_SEQ]}
    compare_split_card_cpu(SplitServingEngine(small, card, versions=VERSIONS),
                           SplitServingEngine(small, cpu, versions=VERSIONS, device="cpu"),
                           one, cut)
    compare_decode_card_cpu(small, card, cpu, one["tokens"], RG_CPU_STEPS + 1)
    print(f"  {RG_ARCH} card vs CPU phase: {time.perf_counter() - t0:.1f} s")


def _w8_qmm(cfg):
    """quant_matmul launches a w8 infer: the attention's projections in
    every layer (q, k, v and o; MLA's q and o; a cross-attention's four
    more in a whisper decoder layer), the MLP's (three gated, two plain
    gelu) in every dense layer (an MoE model's leading dense layers; w8
    leaves the experts whole), the whisper encoder's layers twice (it runs
    in the head and in the tail), none in a Mamba layer, and an untied
    head."""
    if cfg.ssm:
        return int(not cfg.tie_embeddings)
    attn = 2 if cfg.use_mla else 4
    mlp = 2 if cfg.mlp_act == "gelu" else 3
    dense_layers = cfg.first_dense_layers if cfg.moe else cfg.n_layers
    enc = 2 * cfg.n_encoder_layers * (attn + mlp) if cfg.enc_dec else 0
    cross = attn * cfg.n_layers if cfg.enc_dec else 0
    return attn * cfg.n_layers + mlp * dense_layers + cross + enc + (not cfg.tie_embeddings)


def _family_launches(cfg):
    """The kernel launches of one split infer, one prefill and one decode
    step: a layer's scan or flash_attention (self or cross, every layer
    one) in an infer and a prefill, and one flash_decode a layer in a
    decode step (none for Mamba's plain one-token recurrence or MLA's plain
    decode attention); a whisper layer adds its cross-attention's launch
    to each, and its encoder's layers run twice an infer (head and tail)
    and once a prefill."""
    L = cfg.n_layers
    if cfg.ssm:
        return {"mamba_scan": L}, {"mamba_scan": L}, {}
    if cfg.use_mla:
        return {"flash_attention": L}, {"flash_attention": L}, {}
    if cfg.enc_dec:
        E = cfg.n_encoder_layers
        return ({"flash_attention": 2 * E + 2 * L}, {"flash_attention": E + 2 * L},
                {"flash_decode": 2 * L})
    return {"flash_attention": L}, {"flash_attention": L}, {"flash_decode": L}


def _times(counts, n):
    return {k: v * n for k, v in counts.items()}


def _cross_inputs(cfg, B, dev, seed):
    """Random media (B, n_media, d) for a vlm model or frames (B,
    encoder_seq, d) for an audio model, standard normal from ``seed``; {}
    for the other families."""
    import torch
    from repro_torch.models.model import zero_cross_inputs
    g = torch.Generator(device=dev).manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g, device=dev)
            for k, v in zero_cross_inputs(cfg, B, dev).items()}


def _nonzero_gates(model, seed):
    """Every xattn gate of ``model`` drawn from ``seed``: either sign, |gate|
    in [0.5, 1.5] (the init's zeros would switch the cross path off)."""
    import torch
    from repro_torch.models.blocks import XAttnBlock
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, XAttnBlock):
                for gate in (m.gate_attn, m.gate_mlp):
                    val = (torch.rand(gate.shape, generator=g) + 0.5) * (
                        torch.randint(0, 2, gate.shape, generator=g) * 2 - 1)
                    gate.copy_(val)


def _cut_label(cut):
    """A cut as the family phases print it: its index in ``main``, else
    stack:index."""
    return str(cut[1]) if cut[0] == "main" else f"{cut[0]}:{cut[1]}"


def _dense_layer_shapes(cfg):
    """(K, N) of one dense layer's w8 projections: q, k, v, o, then the
    MLP's."""
    d, f = cfg.d_model, cfg.d_ff
    hq, hk = cfg.n_heads * cfg.resolved_head_dim, cfg.n_kv_heads * cfg.resolved_head_dim
    mlp = ((d, f), (f, d)) if cfg.mlp_act == "gelu" else ((d, f), (d, f), (f, d))
    return ((d, hq), (d, hk), (d, hk), (hq, d)) + mlp


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _first_moe_drops(cfg, model, run):
    """The share of routed (token, slot) pairs that the capacity drops in
    the first MoE layer while ``run()`` runs the model, by the port's own
    ``_route`` on that layer's input, chunked as ``MoE.forward`` chunks it;
    and ``run()``'s result."""
    import torch
    from repro_torch.models.moe import MOE_CHUNK, _route
    moe = model.stacks["main"][0].blk.moe
    seen = []
    hook = moe.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    try:
        out = run()
    finally:
        hook.remove()
    x = seen[0]
    chunk = min(cfg.moe_chunk or MOE_CHUNK, x.shape[1])
    chunk = chunk if x.shape[1] % chunk == 0 else x.shape[1]
    keep = torch.cat([_route(cfg, moe.router, xc)[3] for xc in x.split(chunk, dim=1)], dim=1)
    return 1.0 - keep.float().mean().item(), int((~keep).sum()), keep.numel(), out


def _profile_moe_infer(cfg, fn, what):
    """One MoE infer or decode step under torch.profiler: device busy and
    idle share, kernel launches, and the device time of the expert GEMMs (bmm over the experts' stacked
    weights), the dispatch and combine einsums (every other bmm), the dense
    projections and head (mm), flash_fwd (flash_attention) and qmm_*
    (quant_matmul); the kernels by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e, total=False):
        names = (("device_time_total", "cuda_time_total") if total
                 else ("self_device_time_total", "self_cuda_time_total"))
        return next((getattr(e, n) for n in names if getattr(e, n, None)), 0.0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    ms = {"expert GEMMs (bmm)": 0.0, "dispatch and combine einsums (bmm)": 0.0,
          "dense projections and head (mm)": 0.0, "flash_fwd": 0.0, "qmm (quant_matmul)": 0.0}
    for e in prof.key_averages(group_by_input_shape=True):
        shapes = [list(sh) for sh in e.input_shapes if isinstance(sh, (list, tuple))]
        if e.key == "aten::bmm":
            expert = any(sh in ([E, d, f], [E, f, d]) for sh in shapes)
            ms["expert GEMMs (bmm)" if expert else "dispatch and combine einsums (bmm)"] += \
                dev_us(e, total=True) / 1e3
        elif e.key in ("aten::mm", "aten::addmm"):
            ms["dense projections and head (mm)"] += dev_us(e, total=True) / 1e3
    for e in kernels:           # "void (anonymous namespace)::flash_fwd<float, 128>(...)"
        if "::flash_fwd<" in e.key:
            ms["flash_fwd"] += dev_us(e) / 1e3
        elif "::qmm_" in e.key:
            ms["qmm (quant_matmul)"] += dev_us(e) / 1e3
    ms["other"] = busy - sum(ms.values())
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    n_kernels = sum(e.count for e in kernels)
    print(f"  profile of one {what}: wall {wall:.2f} ms, device busy {busy:.2f} ms (idle "
          f"{1 - busy / wall:.1%}), {n_kernels} kernel launches; by operator: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items()))
    for e in top:
        print(f"    {dev_us(e) / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    return {"wall_ms": wall, "device_busy_ms": busy, "kernel_launches": n_kernels,
            "by_operator_ms": ms}


def phase_family_split(dev, arch, label):
    """A single-stack family at full width and depth (or the depth its spec
    serves) through SplitServingEngine: every version at three cuts, each
    version's model built only while it serves (phi3-medium-14b's f32 model
    and its w8 copy fit the card together, all three versions do not). An
    MoE family also prints the share of (token, slot) pairs its first layer
    drops and one profiled infer a version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.partition import cut_activation_bytes, split_forward
    from repro_torch.models import forward_logits, init
    from repro_torch.serving import SplitServingEngine
    spec = FAMILIES[arch]
    B, S = spec["split"]
    cuts = tuple(c if isinstance(c, tuple) else ("main", c) for c in spec["cuts"])
    cfg = get_config(arch)
    depth = "full depth"
    if "layers" in spec:
        depth = f"depth cut to {spec['layers']} of {cfg.n_layers} layers"
        cfg = cfg.with_overrides(n_layers=spec["layers"])
    print(f"== {label}. {arch}: full width, {depth}, through SplitServingEngine, {B} x {S} "
          f"tokens")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    _nonzero_gates(model, 1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    L, qmm = cfg.n_layers, _w8_qmm(cfg)
    per_infer = _family_launches(cfg)[0]
    shape = (f"d_inner {cfg.d_inner}, N {cfg.ssm_state}, dt_rank {cfg.resolved_dt_rank}"
             if cfg.ssm else
             f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff} "
             f"{cfg.mlp_act}, {cfg.norm}, qk_norm {cfg.qk_norm}, qkv_bias {cfg.qkv_bias}, "
             f"attn_bias {cfg.attn_bias}, window {cfg.sliding_window}")
    if cfg.use_mla:
        shape = (f"MLA: {cfg.n_heads} heads, q/k head dim {cfg.qk_nope_head_dim} + rope "
                 f"{cfg.qk_rope_head_dim}, v {cfg.v_head_dim}, kv_lora_rank "
                 f"{cfg.kv_lora_rank}, d_ff {cfg.d_ff} {cfg.mlp_act}, {cfg.norm}")
    if cfg.cross_attn_every:
        shape += (f", an xattn layer every {cfg.cross_attn_every} (gated cross-attention over "
                  f"{cfg.n_media_tokens} media tokens, gates drawn nonzero)")
    if cfg.enc_dec:
        shape += (f", {cfg.n_encoder_layers} encoder layers over {cfg.encoder_seq} frames, "
                  f"cross-attention in every decoder layer, sinusoidal positions")
    if cfg.moe:
        shape += (f", {cfg.n_experts} experts of d_ff {cfg.moe_d_ff} top-{cfg.top_k}, "
                  f"{cfg.n_shared_experts} shared, {cfg.first_dense_layers} leading dense "
                  f"layer(s), capacity factor {cfg.capacity_factor}, {cfg.moe_impl} dispatch "
                  f"in chunks of {cfg.moe_chunk}")
    check(n_params == spec["params"],
          f"init {cfg.name}: {L} layers, d_model {cfg.d_model}, {shape}, vocab "
          f"{cfg.vocab_size}, tied {cfg.tie_embeddings}, {n_params} params (want "
          f"{spec['params']}), {time.perf_counter() - t0:.2f} s")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(2)),
             **_cross_inputs(cfg, B, dev, 3)}
    reps = 3
    link = cut_activation_bytes(cfg, (B, S))
    link_w8 = B * S * (cfg.d_model + 4)
    times, launches, profiles = {}, _launches(), {}
    for version in VERSIONS:
        eng = SplitServingEngine(cfg, model, versions=(version,))
        eng.infer(batch, cuts[1], version)       # builds the version's model, warms up
        torch.cuda.synchronize()
        _reset_counts()
        for cut in cuts:
            before = _counts()
            ms, (logits, act_bytes) = _median_ms(lambda: eng.infer(batch, cut, version), reps)
            delta = {k: v - before[k] for k, v in _counts().items()}
            want = _launches(**_times(per_infer, reps),
                             quant_matmul=qmm * reps if version == "w8" else 0)
            finite = bool(torch.isfinite(logits).all())
            shape_ok = tuple(logits.shape) == (B, S, cfg.vocab_size)
            want_bytes = link_w8 if version == "w8" else link
            times[f"{version}@{_cut_label(cut)}"] = ms
            check(finite and shape_ok and act_bytes == want_bytes and delta == want,
                  f"infer {version} cut={_cut_label(cut)}: act_bytes={act_bytes} "
                  f"(want {want_bytes}) "
                  f"ms={[round(t, 3) for t in ms]} launches over {reps} infers={delta} "
                  f"logits {tuple(logits.shape)} finite={finite}")
            del logits
        launches = {k: launches[k] + v for k, v in _counts().items()}
        if cfg.moe:
            with torch.inference_mode():
                profiles[version] = _profile_moe_infer(
                    cfg, lambda: eng.infer(batch, cuts[1], version),
                    f"{version} infer at cut {_cut_label(cuts[1])}")
        print(f"  peak device memory with the {version} model: "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        del eng
        _free()
    n_infer = reps * len(VERSIONS) * len(cuts)
    print(f"{arch} split path: {n_infer} infers, launches {launches}")
    check(launches == _launches(**_times(per_infer, n_infer), quant_matmul=reps * len(cuts) * qmm),
          f"launch counts over the {arch} split path run ({per_infer} an infer, {qmm} "
          f"quant_matmul a w8 infer)")
    with torch.inference_mode():
        if cfg.moe:
            share, n_drop, n_pairs, full = _first_moe_drops(
                cfg, model, lambda: forward_logits(cfg, model, batch))
            print(f"  capacity drops in the first MoE layer of the split batch: {n_drop} of "
                  f"{n_pairs} routed (token, slot) pairs, share {share:.6f}")
            profiles["dropped_share"] = share
        else:
            full = forward_logits(cfg, model, batch)
        split = split_forward(cfg, model, batch, cuts[1])
    err = (full - split).abs().max().item()
    check(torch.allclose(split, full, rtol=2e-4, atol=2e-4),
          f"{arch} split vs full at cut {_cut_label(cuts[1])}: max_abs_err={err:.3g} "
          f"(tol 2e-4)")
    del full, split
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  peak device memory of the split path: {peak / 2**30:.2f} GiB ({peak} bytes); "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return cfg, model, launches, times, peak, profiles


def phase_family_decode(dev, cfg, model, label):
    """ServingEngine.generate and, where the spec names one, the scheduler,
    with launch counts; their launches are the path's. Then teacher-forced
    decode against the card's forward_logits (across a wrapped window ring
    for starcoder2-3b), MLA's absorbed decode against its expanded one and
    an MoE model's profiled decode step, which the path's counts leave
    out."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step, forward_logits, prefill
    from repro_torch.serving import (ContinuousBatchingServer, Request, ServeConfig,
                                     ServingEngine)
    spec = FAMILIES[cfg.name]
    B, S, new = spec["decode"]
    L, V = cfg.n_layers, cfg.vocab_size
    steps = new - 1
    _, per_prefill, per_step = _family_launches(cfg)
    print(f"== {label}. {cfg.name} decode: {B} x {S}-token prompts, {new} new tokens"
          + (f" (past the {cfg.sliding_window}-token window)"
             if cfg.sliding_window and S > cfg.sliding_window else ""))
    t_phase = time.perf_counter()
    batch = {"tokens": torch.randint(0, V, (B, S), device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(4)),
             **_cross_inputs(cfg, B, dev, 5)}
    eng = ServingEngine(cfg, model, ServeConfig(max_new_tokens=new))
    eng.generate(batch)                  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    gen_ms = []
    for _ in range(2):
        before = _counts()
        ms, toks = _median_ms(lambda: eng.generate(batch), 1)
        gen_ms += ms
        delta = {k: v - before[k] for k, v in _counts().items()}
        in_range = 0 <= toks.min().item() and toks.max().item() < V
        check(tuple(toks.shape) == (B, new) and in_range
              and delta == _launches(**_times(per_prefill, 1), **_times(per_step, steps)),
              f"generate f32: {ms[0]:.1f} ms, launches {delta} ({per_prefill} in the prefill, "
              + (f"{per_step} in each" if per_step else "no kernel in any")
              + f" of the {steps} decode steps)")
    timing = {}
    if spec["srv"] is not None:
        n_req, slots_srv, cache_len, prompt, n_new = spec["srv"]
        r = np.random.default_rng(5)
        reqs = [Request(rid=i, tokens=r.integers(0, V, int(r.integers(prompt[0], prompt[1] + 1))),
                        max_new_tokens=int(r.integers(n_new[0], n_new[1] + 1)))
                for i in range(n_req)]
        srv = ContinuousBatchingServer(cfg, model, max_batch=slots_srv, cache_len=cache_len)
        before = _counts()
        t0 = time.perf_counter()
        for q in reqs:
            srv.submit(q)
        done = srv.run()
        torch.cuda.synchronize()
        srv_s = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in _counts().items()}
        st = srv.stats
        n_tok = sum(len(q.out) for q in done)
        check(len(done) == n_req and all(q.done and not q.truncated for q in done)
              and all(len(q.out) == q.max_new_tokens for q in done)
              and delta == _launches(**_times(per_prefill, st.prefills),
                                     **_times(per_step, st.decode_steps)),
              f"scheduler: {len(done)} requests (prompts {[len(q.tokens) for q in reqs]}), "
              f"{n_tok} tokens in {srv_s:.2f} s ({n_tok / srv_s:.1f} tokens/s), prefills "
              f"{st.prefills}, decode steps {st.decode_steps}, wall steps {st.wall_steps}, "
              f"reclaims {st.slot_reclaims}, launches {delta}")
        timing.update(scheduler_s=srv_s, scheduler_tokens_per_s=n_tok / srv_s)
    launches = _counts()                 # the generate and scheduler runs only

    # teacher-forced decode against the forward pass that ran the kernels;
    # for an MoE model on the same weights at the capacity that drops
    # nothing: at its own capacity the prefill drops pairs and a one-token
    # decode step (C >= top_k) never does, so the two differ by design
    full_toks = torch.cat([batch["tokens"], toks[:, :FAM_TF_STEPS]], dim=1)
    nd, tf_note = contextlib.nullcontext(), ""
    if cfg.moe:
        factor = cfg.n_experts / cfg.top_k
        nd = _moe_capacity(model, factor)
        tf_note = (f" (on the same weights at capacity factor n_experts / top_k = {factor}, "
                   f"the rule of .reduced(): no pair dropped; at {cfg.capacity_factor} the "
                   f"prefill drops and a decode step never does)")
    with torch.inference_mode(), nd:
        want = forward_logits(cfg, model, {**batch, "tokens": full_toks})
        lg, cache = prefill(cfg, model, batch, total_len=S + FAM_TF_STEPS)
        ring = _ring_slots(cache)
        errs = [(lg - want[:, S - 1]).abs().max().item()]
        for j in range(FAM_TF_STEPS):
            lg, cache = decode_step(cfg, model, cache, toks[:, j], S + j)
            errs.append((lg - want[:, S + j]).abs().max().item())
    del want, cache
    slots = min(S + FAM_TF_STEPS, cfg.sliding_window or S + FAM_TF_STEPS)
    check(max(errs) <= FAM_DECODE_TOL and (ring is None or ring == slots),
          f"prefill + {FAM_TF_STEPS} teacher-forced decode steps against forward_logits on "
          f"the card{tf_note}: max_abs_err {max(errs):.3g} (tol {FAM_DECODE_TOL}), per step "
          f"{[float(f'{e:.3g}') for e in errs]}; ring slots {ring}")
    if cfg.use_mla:
        timing.update(_mla_absorbed_vs_expanded(cfg, model, batch, toks, S))
    if cfg.moe:                          # where an MoE decode step's time goes
        with torch.inference_mode():
            _, cache = prefill(cfg, model, batch, total_len=S + 2)
            decode_step(cfg, model, cache, toks[:, 0], S)           # warm
            timing["decode_profile"] = _profile_moe_infer(
                cfg, lambda: decode_step(cfg, model, cache, toks[:, 1], S + 1), "decode step")
        del cache

    pre_ms, _ = _median_ms(lambda: torch.inference_mode()(prefill)(cfg, model, batch), 3)
    gen, pre_med = statistics.median(gen_ms), statistics.median(pre_ms)
    timing.update(generate_ms=gen_ms, prefill_ms=pre_ms, per_token_ms=(gen - pre_med) / steps,
                  peak_bytes=torch.cuda.max_memory_allocated(dev))
    print(f"  {cfg.name} decode: generate {gen:.1f} ms, prefill {pre_med:.1f} ms, per token "
          f"(generate - prefill) / {steps} = {timing['per_token_ms']:.3f} ms; peak device "
          f"memory of the split and decode phases {timing['peak_bytes'] / 2**30:.2f} GiB; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return batch, launches, timing


def _ring_slots(cache):
    """The slots of the first attention ring in a cache tree (MLA's ring
    holds the latent), or None where there is none (Mamba's states)."""
    for stack in cache.values():
        for leaves in stack.values():
            if "k" in leaves:
                return leaves["k"].shape[-3]       # (..., B, C, HK, Dh)
            if "ckv" in leaves:
                return leaves["ckv"].shape[-2]     # (..., B, C, R)
    return None


def _mla_absorb(model, on):
    """Every MLA layer of ``model`` set to the absorbed (``on``) or the
    expanded decode form."""
    from repro_torch.models.attention import MLAttention
    for m in model.modules():
        if isinstance(m, MLAttention):
            m.absorb = on


def _mla_absorbed_vs_expanded(cfg, model, batch, toks, S):
    """FAM_TF_STEPS decode steps in the absorbed form (``mla_absorb``) from a
    clone of the prefill cache that the expanded form steps from, fed the
    same tokens: logits within FAM_DECODE_TOL (the two contract in another
    order; the reference holds them to 2e-4 at reduced size), and each
    form's ms a step."""
    import torch
    from repro_torch.models import decode_step, prefill
    errs, ms = [], {"expanded": [], "absorbed": []}
    with torch.inference_mode():
        _, cache = prefill(cfg, model, batch, total_len=S + FAM_TF_STEPS)
        twin = {s: {b: {n: t.clone() for n, t in d.items()} for b, d in x.items()}
                for s, x in cache.items()}
        try:
            for j in range(FAM_TF_STEPS):
                t, (base, cache) = _median_ms(
                    lambda: decode_step(cfg, model, cache, toks[:, j], S + j), 1)
                ms["expanded"] += t
                _mla_absorb(model, True)
                t, (absorbed, twin) = _median_ms(
                    lambda: decode_step(cfg, model, twin, toks[:, j], S + j), 1)
                _mla_absorb(model, False)
                ms["absorbed"] += t
                errs.append((absorbed - base).abs().max().item())
        finally:
            _mla_absorb(model, False)
    del cache, twin
    med = {k: statistics.median(v) for k, v in ms.items()}
    check(max(errs) <= FAM_DECODE_TOL and max(errs) > 0,
          f"{FAM_TF_STEPS} absorbed decode steps (mla_absorb) against the expanded form from "
          f"clones of one prefill cache: max_abs_err {max(errs):.3g} (tol {FAM_DECODE_TOL}), "
          f"per step {[float(f'{e:.3g}') for e in errs]}; median ms a step: expanded "
          f"{med['expanded']:.2f}, absorbed {med['absorbed']:.2f}")
    return {"expanded_step_ms": ms["expanded"], "absorbed_step_ms": ms["absorbed"],
            "absorbed_max_abs_err": max(errs)}


def _moe_capacity(model, factor):
    """A context in which every MoE layer of ``model`` routes at capacity
    factor ``factor``: the same weights under another config."""
    from repro_torch.models.moe import MoE
    moes = [m for m in model.modules() if isinstance(m, MoE)]

    @contextlib.contextmanager
    def swap():
        cfgs = [m.cfg for m in moes]
        for m in moes:
            m.cfg = m.cfg.with_overrides(capacity_factor=factor)
        try:
            yield
        finally:
            for m, c in zip(moes, cfgs):
                m.cfg = c
    return swap()


def phase_family_card_vs_cpu(dev, cfg, model, batch, label):
    """Full width at depth FAM_CPU_LAYERS (or the family's own): the card
    model's embedding, head, final norm and first layers, on both devices.
    The CPU model takes over the exported arrays, so the host holds that
    depth's weights once. A family whose spec names a ``cpu`` config (the
    cross-attention families: another period, or an encoder to cut too)
    gets a model of that config built fresh on the card from seed 0, its
    gates drawn nonzero, after the big one is freed (``model`` None)."""
    import copy
    import torch
    from torch import nn
    from repro_torch.configs import get_config
    from repro_torch.core.partition import cut_points
    from repro_torch.models import CausalLM, export_params, init, load_jax_params, stack_defs
    from repro_torch.serving import SplitServingEngine
    spec = FAMILIES[cfg.name]
    layers, seq = spec.get("cpu_layers", FAM_CPU_LAYERS), spec.get("cpu_seq", CPU_SEQ)
    small = (get_config(cfg.name).with_overrides(**spec["cpu"]) if "cpu" in spec
             else cfg.with_overrides(n_layers=layers))
    cut = cut_points(small)[0]           # after the first step
    print(f"== {label}. {cfg.name} card against CPU: full width, {small.n_layers} layer(s)"
          + (f" and {small.n_encoder_layers} encoder layer(s)" if small.enc_dec else "")
          + f", 1 x {seq} tokens per version at cut {_cut_label(cut)}, then "
          f"{FAM_CPU_STEPS} decode steps")
    t0 = time.perf_counter()
    if model is None:
        card = init(small, torch.Generator(device=dev).manual_seed(0), device=dev)
        _nonzero_gates(card, 1)
        flat = export_params(card)
        print(f"  {sum(p.numel() for p in card.parameters())} parameters")
    else:
        head = copy.copy(model)          # shares every tensor of the card model
        head._modules = dict(model._modules)
        head.stacks = nn.ModuleDict({s.name: model.stacks[s.name][:s.length]
                                     for s in stack_defs(small)})
        head.cfg = small
        flat = export_params(head)
        del head
        card = load_jax_params(small, flat, device=dev)
    cpu = CausalLM(small, {k: torch.from_numpy(flat.pop(k)) for k in sorted(flat)})
    one = {k: v[:1, :seq] if k == "tokens" else v[:1] for k, v in batch.items()}
    if cfg.moe:
        _route_gaps(small, card, cpu, one)
    compare_split_card_cpu(SplitServingEngine(small, card, versions=VERSIONS),
                           SplitServingEngine(small, cpu, versions=VERSIONS, device="cpu"),
                           one, cut, trace_w8=bool(small.cross_attn_every or small.enc_dec))
    compare_decode_card_cpu(small, card, cpu, one["tokens"], FAM_CPU_STEPS + 1,
                            extra={k: v for k, v in one.items() if k != "tokens"})
    print(f"  {cfg.name} card vs CPU phase: {time.perf_counter() - t0:.1f} s")


def _route_gaps(cfg, card, cpu, one):
    """The first MoE layer's routing of ``one`` on the card and on the CPU:
    how many tokens choose other top-k experts on the two devices, the
    probability gap between the k-th and the (k+1)-th expert at each such
    flip (a flip at a gap above 1e-6 is no rounding tie), and the smallest
    gap over all tokens."""
    import torch
    seen = {}

    def probs(model, key):
        moe = model.stacks["main"][0].blk.moe
        hook = moe.register_forward_pre_hook(lambda mod, args: seen.__setitem__(key, args[0]))
        try:
            with torch.inference_mode():
                model(one["tokens"].to(model.tok_embed.device))
        finally:
            hook.remove()
        x = seen[key].float()
        return torch.softmax(x @ moe.router.float(), dim=-1).cpu()

    pg, pc = probs(card, "card"), probs(cpu, "cpu")
    K = cfg.top_k
    sc, _ = torch.sort(pc, dim=-1, descending=True)
    gap = (sc[..., K - 1] - sc[..., K]).flatten()
    eg = torch.topk(pg, K, dim=-1).indices.sort(-1).values
    ec = torch.topk(pc, K, dim=-1).indices.sort(-1).values
    flips = (eg != ec).any(-1).flatten()
    at_flips = gap[flips].tolist()
    check(all(g_ <= 1e-6 for g_ in at_flips),
          f"first MoE layer's top-{K} routing, card against CPU: {int(flips.sum())} of "
          f"{flips.numel()} tokens choose other experts, gaps at those flips "
          f"{[float(f'{x:.3g}') for x in at_flips]} (a flip above 1e-6 is a fault); smallest "
          f"k-th to (k+1)-th probability gap {gap.min().item():.3g}; max |p card - p CPU| "
          f"{(pg - pc).abs().max().item():.3g}")


def phase_family(dev, arch):
    """Phases 6 and 9-9g: one family's split path, decode path and card-CPU
    comparison; its model is freed at the end."""
    label = FAMILIES[arch]["label"]
    t0 = time.perf_counter()
    cfg, model, split_launches, times, peak, profiles = phase_family_split(dev, arch, label)
    batch, dec_launches, dec_timing = phase_family_decode(dev, cfg, model, label + " decode")
    if "cpu" in FAMILIES[arch]:          # its CPU comparison builds a model of its own
        del model
        _free()
        model = None
    phase_family_card_vs_cpu(dev, cfg, model, batch, label + " card vs CPU")
    del model, batch
    _free()
    seconds = time.perf_counter() - t0
    print(f"  phase {label} ({arch}) in all: {seconds:.1f} s")
    return {"split": split_launches, "decode": dec_launches, "times": times, "peak": peak,
            "decode_timing": dec_timing, "seconds": seconds, "profiles": profiles}


def phase_mixed_fleet(dev, q2_cfg, q2_eng, smi):
    """3g. A fleet of mixed models under the controller: the transformer env
    of qwen2-0.5b, qwen3-0.6b and starcoder2-3b at full width built on the
    card (tables = CPU), then ``simulate`` for three policies with
    ``ExecuteBackend`` over three full-width engines, device i serving model
    i, the devices' models rotated so that each takes its turn on device 0
    (the device whose request an epoch executes)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import make_tpu_env, transformer_profile
    from repro_torch.core.baselines import greedy_oracle
    from repro_torch.models import init
    from repro_torch.policies import StaticPolicy, build_policy
    from repro_torch.scenarios import get_scenario
    from repro_torch.serving import SplitServingEngine
    from repro_torch.sim import AnalyticalBackend, ExecuteBackend, FleetConfig, simulate
    sc = get_scenario("tpu-execute")
    print(f"== 3g. mixed fleet: {list(MIX_ARCHS)} at full width (seq {SEQ}), one device each, "
          f"the {sc.name} world's traffic ({sc.trace} {sc.trace_kw} rps a device, "
          f"{sc.n_requests} requests); ExecuteBackend (sample {MIX_SAMPLE}) over three engines")
    t_phase = time.perf_counter()

    def world(device):
        return make_tpu_env(list(MIX_ARCHS), weights=sc.weights, reduced=False, seq_len=SEQ,
                            slot_seconds=sc.slot_seconds, peak_rps=sc.peak_rps, device=device)

    env_cfg, tables = world(dev)
    cpu_env, cpu_tables = world("cpu")
    same = all(torch.equal(getattr(tables, f.name).cpu(), getattr(cpu_tables, f.name))
               if isinstance(getattr(tables, f.name), torch.Tensor)
               else getattr(tables, f.name) == getattr(cpu_tables, f.name)
               for f in dataclasses.fields(tables))
    check(same and tables.device.type == "cuda" and tables.n_models == len(MIX_ARCHS),
          f"make_tpu_env({list(MIX_ARCHS)}, seq_len={SEQ}) on the card: every table equals "
          f"the CPU-built one exactly ({tables.n_models} models x {tables.n_versions} "
          f"versions x {tables.n_cuts} cuts)")
    cfgs, engines = [q2_cfg], [q2_eng]
    for arch in MIX_ARCHS[1:]:
        cfg = get_config(arch)
        cfgs.append(cfg)
        engines.append(SplitServingEngine(
            cfg, init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
            versions=VERSIONS))
    profiles = [transformer_profile(c, seq_len=SEQ) for c in cfgs]
    by_name = {c.name: c for c in cfgs}
    trace, fleet = sc.build_trace(), FleetConfig(slo_s=sc.slo_s)
    w8 = [v.version for v in profiles[0].versions].index("w8")

    def w8_at_oracle_cut(env_, tables_, state, generator=None):
        actions = greedy_oracle(env_, tables_, state).clone()
        actions[:, 0] = w8
        return actions

    def policy(name, env_, tables_):
        if name == "w8@greedy_oracle":
            return StaticPolicy(env_, tables_, w8_at_oracle_cut)
        return build_policy(name, env_, tables_)

    served, w8_served = {c.name: 0 for c in cfgs}, False
    timing = {"card": smi, "runs": {}}
    _reset_counts()
    names = ["greedy_oracle", "device_only", "full_offload"]
    for name in names:
        for rot in range(len(MIX_ARCHS)):
            mids = np.roll(np.arange(len(MIX_ARCHS), dtype=np.int32), -rot)
            backend = ExecuteBackend(env_cfg, tables, cfgs, profiles, engines, seq_len=SEQ,
                                     sample=MIX_SAMPLE)
            before = _counts()
            t0 = time.perf_counter()
            res = simulate(env_cfg, tables, policy(name, env_cfg, tables), trace,
                           n_requests=sc.n_requests, seed=sc.seeds[0], fleet=fleet,
                           backend=backend, model_ids=mids)
            wall = time.perf_counter() - t0
            delta = {k: v - before[k] for k, v in _counts().items()}
            cc = res.cross_check or {"records": [], "samples": 0}
            recs = cc["records"]
            want = _launches(
                flash_attention=sum(2 * by_name[r["model"]].n_layers for r in recs),
                quant_matmul=sum(2 * _w8_qmm(by_name[r["model"]])
                                 for r in recs if r["version"] == "w8"))
            for r in recs:
                served[r["model"]] += 1
            w8_served |= any(r["version"] == "w8" for r in recs)
            ref = simulate(cpu_env, cpu_tables, policy(name, cpu_env, cpu_tables), trace,
                           n_requests=sc.n_requests, seed=sc.seeds[0], fleet=fleet,
                           backend=AnalyticalBackend(cpu_env, cpu_tables), model_ids=mids)
            check((not recs or cc.get("bytes_exact") is True)
                  and all(r["logits_finite"] for r in recs) and delta == want
                  and same_sim_result(res, ref),
                  f"{name}, model_ids {mids.tolist()}: {res.epochs} epochs, {res.served} "
                  f"requests in {wall:.3f} s, slo_attainment "
                  f"{res.summary['slo_attainment']:.4f}; {len(recs)} samples "
                  f"{[(r['model'], r['version'], r['cut'][1], r['measured_bytes']) for r in recs]}"
                  f" bytes = each model's own table entry, launches {delta} (2 infers a "
                  f"sample, each model's layers); SimResult card = CPU bit for bit")
            timing["runs"][f"{name}@{rot}"] = {"epochs": res.epochs, "wall_s": wall,
                                               "samples": len(recs)}
        if name == names[-1] and not w8_served:
            # the w8 path (quant_matmul, starcoder2's untied head too) runs
            # in this phase on every run
            names.append("w8@greedy_oracle")
    launches = _counts()
    check(all(n > 0 for n in served.values()),
          f"every model of the fleet served sampled requests through its engine: {served}")
    del engines[1:]
    _free()
    timing["seconds"] = time.perf_counter() - t_phase
    print(f"  mixed fleet launches {launches}; phase {timing['seconds']:.1f} s")
    return launches, timing


def phase_cli(dev, smi, argv=CLI_ARGV):
    """3h. The simulate CLI with no --scenario (``argv``): the ad-hoc tpu
    world over mixtral-8x22b (CLI_ARGV) or deepseek-v2-lite-16b
    (CLI_ARGV_MLA), its tables built on the card and the sampled requests
    executed through the reduced model on the card; then the same argv with
    ``--device cpu``. The act bytes at the cut exact, the launches those of
    the executed infers, every SimResult number card = CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch import simulate as cli
    print(f"== 3h. the simulate CLI without --scenario on the card: {' '.join(argv)}; "
          f"then with --device cpu")
    t0 = time.perf_counter()
    _reset_counts()
    card = cli.main([*argv, "--quiet"])
    launches = _counts()
    card_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    cpu = cli.main([*argv, "--quiet", "--device", "cpu"])
    cpu_s = time.perf_counter() - t1
    small = get_config(argv[argv.index("--arch") + 1]).reduced()
    for name, r in card.results.items():
        c = cpu.results[name]
        check(r.per_seed == c.per_seed and r.mean == c.mean,
              f"{name}: {r.mean['requests']:.0f} requests, slo_attainment "
              f"{r.mean['slo_attainment']:.4f}, energy/request "
              f"{r.mean['energy_per_request_j']:.6g} J; every summary number card = CPU")
    cc, cpu_cc = card.results["greedy_oracle"].cross_check, cpu.results["greedy_oracle"].cross_check
    recs = cc["records"] if cc else []
    want = _launches(flash_attention=2 * small.n_layers * len(recs),
                     quant_matmul=sum(2 * _w8_qmm(small) for r in recs if r["version"] == "w8"))
    check(bool(recs) and cc["bytes_exact"] and all(r["logits_finite"] for r in recs)
          and cpu_cc is not None and cpu_cc["bytes_exact"]
          and cpu_cc["samples"] == cc["samples"] and launches == want,
          f"execute cross-check through reduced {small.name} on the card: {len(recs)} samples "
          f"{[(r['version'], r['cut'][1], r['measured_bytes'], r['expected_bytes']) for r in recs]}"
          f", act bytes exact; the CPU run's {cpu_cc and cpu_cc['samples']} samples exact too; "
          f"launches {launches} (2 infers a sample)")
    timing = {"card_s": card_s, "cpu_s": cpu_s, "samples": len(recs), "card": smi}
    print(f"  CLI phase: card {card_s:.1f} s, CPU {cpu_s:.1f} s")
    return launches, timing


# --------------------------------------------------------------------------
# the backward kernel (phase 2) and the train path (phase 10)
# --------------------------------------------------------------------------

def check_flash_attention_bwd(dev, g):
    """flash_attention's log-sum-exp and its backward kernel against the
    plain versions on the card (FA_BWD_CASES, f32 and bf16, views of (B, S,
    H, D) tensors as the model passes them): the lse within FA_TOL, the
    gradients within FA_BWD_TOL (f32 also against the plain backward in f64,
    which both f32 versions are measured against); the GQA map (kv head h %
    HK, not h // G); and ``FlashAttentionFn`` under autograd equal to the
    direct calls, one forward and one backward launch. Returns the largest
    f32 gradient gap to the plain version."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    worst = 0.0
    for B, H, HK, Sq, Skv, D, Dv, causal, window in FA_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype).transpose(1, 2)
            do = torch.randn(B, Sq, H, Dv, generator=g, device=dev).to(dtype).transpose(1, 2)
            k = torch.randn(B, Skv, HK, D, generator=g, device=dev).to(dtype).transpose(1, 2)
            v = torch.randn(B, Skv, HK, Dv, generator=g, device=dev).to(dtype).transpose(1, 2)
            kw = dict(causal=causal, window=window)
            o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True, **kw)
            _, lse_ref = fa.flash_attention_ref(q, k, v, with_lse=True, **kw)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            plain = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            plan = fa.bwd_plan(B, H, HK, Sq, Skv, D, Dv, dtype, causal, window,
                               _build.sm_count(q.device))
            name = str(dtype).split(".")[1]
            tol = FA_BWD_TOL[name]
            e_lse = (lse - lse_ref).abs().max().item()
            errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, plain)]
            scale = [b.float().abs().max().item() for b in plain]
            # f32: relative to the gradient's largest magnitude (see FA_BWD_TOL);
            # bf16: the forward's absolute and relative 2e-2
            ok = same and e_lse <= FA_TOL[name] and all(
                torch.allclose(a.float(), b.float(), rtol=tol,
                               atol=tol * m if dtype == torch.float32 else tol)
                for a, b, m in zip(got, plain, scale))
            extra = ""
            if dtype == torch.float32:
                worst = max(worst, *errs)
                f64 = fa.flash_attention_bwd_ref(*(t.double() for t in (q, k, v, o, lse, do)),
                                                 **kw)
                e_k = [(a.double() - c).abs().max().item() for a, c in zip(got, f64)]
                e_p = [(b.double() - c).abs().max().item() for b, c in zip(plain, f64)]
                extra = (f"; against the f64 plain backward: kernel {_fmt(e_k)}, plain f32 "
                         f"{_fmt(e_p)}")
                del f64
            check(ok, f"flash_attention_bwd {name} B={B} H={H} HK={HK} Sq={Sq} Skv={Skv} D={D} "
                      f"Dv={Dv} causal={causal} window={window} (chunk {plan.chunk}, longest block "
                      f"{plan.longest} tiles, {plan.slots} slots): lse err {e_lse:.3g}, "
                      f"dq/dk/dv max_abs_err {_fmt(errs)} (largest |grad| {_fmt(scale)}, tol {tol}"
                      + (" x largest" if dtype == torch.float32 else "") + f"), two runs "
                      f"equal {same}{extra}")

    # the kernel's split of the dK/dV pass: at qwen2's training shape (f32)
    # the first key tile walks 7 heads x 8 query tiles, the last 7, and the
    # split at least halves the longest walk; shapes with more key tiles
    # than the card has places are not split
    sms = _build.sm_count(dev)
    q2 = fa.bwd_plan(8, 14, 2, 512, 512, 64, 64, torch.float32, True, None, sms)
    full = [fa.bwd_plan(B, H, HK, 512, 512, D, Dv, torch.float32, True, None, sms)
            for B, H, HK, D, Dv in ((8, 16, 8, 128, 128), (4, 16, 16, 192, 128))]
    check(q2.longest <= 56 // 2 and q2.slots > 0 and all(p.slots == 0 and p.longest == p.chunk
                                                         for p in full),
          f"flash_attention_bwd split on {sms} SMs: qwen2-0.5b's training shape {q2} (no "
          f"split: 56 tiles), qwen3-0.6b's and deepseek-v2-lite-16b's {full}")

    # a NaN in q (0 / 0, made on the card) reaches the output, the lse and the
    # gradients as in the plain version: the last query row of head 1 sees
    # every key, so dk and dv of its kv head are NaN throughout
    for dtype in (torch.float32, torch.bfloat16):
        B, H, HK, S, D = 1, 4, 2, 100, 64
        q, do = (torch.randn(B, S, H, D, generator=g, device=dev).to(dtype).transpose(1, 2)
                 for _ in range(2))
        k, v = (torch.randn(B, S, HK, D, generator=g, device=dev).to(dtype).transpose(1, 2)
                for _ in range(2))
        zero = torch.zeros((), device=dev)
        q[0, 1, S - 1, 3] = zero / zero
        o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, with_lse=True)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do)
        plain = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do)
        torch.cuda.synchronize()
        pairs = list(zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *got), (o_ref, lse_ref, *plain)))
        same = {n: torch.equal(a.isnan(), b.isnan()) for n, a, b in pairs}
        n_nan = {n: int(a.isnan().sum()) for n, a, _ in pairs}
        check(all(same.values()) and all(n_nan.values()),
              f"flash_attention forward and backward {str(dtype).split('.')[1]}, a NaN in q: "
              f"NaN where the plain version's is {same}, NaN elements {n_nan}")

    # kv head h % HK: dk and dv summed over the heads h = hk, hk + HK, ...
    B, H, HK, S, D = 2, 14, 2, 40, 64
    G = H // HK
    q, do = (torch.randn(B, H, S, D, generator=g, device=dev) for _ in range(2))
    k, v = (torch.randn(B, HK, S, D, generator=g, device=dev) for _ in range(2))
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    _, dk, _ = fa.flash_attention_bwd(q, k, v, o, lse, do)
    ki, vi = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    oi, lsei = fa.flash_attention_ref(q, ki, vi, with_lse=True)
    dk_div = fa.flash_attention_bwd_ref(q, ki, vi, oi, lsei, do)[1].reshape(B, HK, G, S, D).sum(2)
    dk_mod = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)[1]
    torch.cuda.synchronize()
    e_mod, e_div = ((dk - dk_mod).abs().max().item(), (dk - dk_div).abs().max().item())
    check(e_mod <= FA_BWD_TOL["float32"] * dk_mod.abs().max().item() and e_div > 0.1,
          f"flash_attention_bwd GQA head map: |dk - ref(h % HK)| = {e_mod:.3g}, "
          f"|dk - ref(h // G)| = {e_div:.3g}")

    # through autograd, as a train step calls it: one forward with its lse and
    # one backward, and the gradients of the direct calls bit for bit
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    before = _counts()
    out = ops.attention_bhsd(qg, kg, vg, causal=True)
    out.backward(do)
    delta = {n: c - before[n] for n, c in _counts().items()}
    want = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    same = all(torch.equal(a.grad, b) for a, b in zip((qg, kg, vg), want))
    check(same and torch.equal(out, o)
          and delta == _launches(flash_attention=1, flash_attention_bwd=1),
          f"FlashAttentionFn under autograd: gradients equal to the direct calls {same}, "
          f"launches {delta}")
    return worst


def _fmt(xs):
    return "[" + ", ".join(f"{x:.3g}" for x in xs) + "]"


def _profile_train_step(fn):
    """One train step under torch.profiler: wall, device busy and idle
    share, kernel launches, and device time by kind: the GEMMs (cuBLAS),
    the flash attention forward (flash_fwd) and backward (bwd_dkdv, bwd_dq,
    bwd_delta, bwd_reduce) kernels, and the rest (elementwise, reductions, the
    optimizer, copies); the kernels by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return next((getattr(e, n) for n in ("self_device_time_total", "self_cuda_time_total")
                     if getattr(e, n, None)), 0.0)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    kinds = {"GEMMs (cuBLAS)": ("gemm", "xmma", "cutlass"), "flash_fwd": ("::flash_fwd<",),
             "bwd_dkdv": ("::bwd_dkdv<",), "bwd_dq": ("::bwd_dq<",),
             "bwd_delta": ("::bwd_delta<",), "bwd_reduce": ("::bwd_reduce<",)}
    ms = {k: 0.0 for k in kinds}
    for e in kernels:
        kind = next((k for k, keys in kinds.items() if any(x in e.key.lower() for x in keys)),
                    None)
        if kind is not None:
            ms[kind] += dev_us(e) / 1e3
    ms["other"] = busy - sum(ms.values())
    n_kernels = sum(e.count for e in kernels)
    print(f"  profile of one train step: wall {wall:.2f} ms, device busy {busy:.2f} ms (idle "
          f"{1 - busy / wall:.1%}), {n_kernels} kernel launches; by kind: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items()))
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        print(f"    {dev_us(e) / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "kernel_launches": n_kernels, "by_kind_ms": ms}


def _train_launches(cfg):
    """The launches of one train step of ``cfg`` (remat on, one microbatch):
    each layer's kernel forward once and again in remat's recompute, its
    backward kernel once; nothing else. Mamba layers run mamba_scan,
    recurrentgemma's rec layers rglru_scan, every other layer
    flash_attention."""
    L = cfg.n_layers
    if cfg.ssm:
        return _launches(mamba_scan=2 * L, mamba_scan_bwd=L)
    if cfg.block_pattern:
        rec = cfg.layer_kinds().count("rec")
        return _launches(rglru_scan=2 * rec, rglru_scan_bwd=rec, flash_attention=2 * (L - rec),
                         flash_attention_bwd=L - rec)
    return _launches(flash_attention=2 * L, flash_attention_bwd=L)


def _cpu_depth(arch):
    return dict(TRAIN_SCAN_ARCHS).get(arch, TRAIN_CPU_LAYERS)


def _train_steps(dev, cfg, batch, seq, steps):
    """``steps`` AdamW steps (``launch.steps.make_train_step``, remat on) of
    ``cfg`` from random weights (seed 0) over ``SyntheticLMDataset``
    batches of batch x seq tokens: every loss finite and the last below the
    first, the launches of each step exact (``_train_launches``: each
    layer's forward kernel once and again in remat's recompute, its backward
    kernel once, nothing else). The counts are set to 0 just before the first step and
    read after the last. Returns (launches, ms a step, losses, peak bytes,
    model, optimizer state, the step, one more batch)."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLMDataset, to_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init, param_tree
    from repro_torch.optim import AdamWConfig, adamw_init
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    print(f"  {cfg.name} at {cfg.n_layers} layers: {sum(p.numel() for p in model.parameters())} "
          f"parameters, f32")
    opt = AdamWConfig(**{**TRAIN_OPT, "total_steps": steps})
    state = adamw_init(param_tree(model))
    step = make_train_step(cfg, opt, remat=True)
    ds = SyntheticLMDataset(cfg, DataConfig(batch_size=batch, seq_len=seq))
    batches = [to_device(ds.batch(i), dev) for i in range(steps + 1)]
    per_step = _train_launches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = [], []
    _reset_counts()
    for i in range(steps):
        before = _counts()
        t0 = time.perf_counter()
        model, state, m = step(model, state, batches[i])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        delta = {n: c - before[n] for n, c in _counts().items()}
        m = {k: float(v) for k, v in m.items()}
        losses.append(m["loss"])
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) and delta == per_step,
              f"{cfg.name} train step {i}: loss {m['loss']:.4f} grad_norm {m['grad_norm']:.3f} "
              f"lr {m['lr']:.3g}, {ms[-1]:.1f} ms, launches {delta}")
    launches = _counts()
    check(launches == {n: c * steps for n, c in per_step.items()},
          f"{cfg.name} train path launches over {steps} steps: {launches}")
    check(losses[-1] < losses[0], f"{cfg.name} train loss falls: {losses[0]:.4f} -> "
                                  f"{losses[-1]:.4f}")
    peak = torch.cuda.max_memory_allocated(dev)
    return launches, ms, losses, peak, model, state, step, batches[steps]


def phase_train(dev, smi):
    """Phase 10: full-width, full-depth qwen2-0.5b trained for TRAIN_STEPS
    AdamW steps (``_train_steps``), ms a step, peak memory, one profiled
    step; deepseek-v2-lite-16b at full width and depth TRAIN_MLA_LAYERS
    likewise for TRAIN_MLA_STEPS steps; falcon-mamba-7b and
    recurrentgemma-2b at full width and the depths of TRAIN_SCAN_ARCHS for
    TRAIN_SCAN_STEPS steps (their scans through mamba_scan's and
    rglru_scan's backward kernels, recurrentgemma's attention through the
    (256, 256) instances); then card against CPU for TRAIN_CPU_ARCHS (loss
    and every gradient leaf), every arch reduced, and a step over two
    microbatches against one over the whole batch. Returns the launches of
    qwen2's, deepseek's and the scan families' train paths."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    print(f"== 10. training: full-width {cfg.name} ({cfg.n_layers} layers), {TRAIN_STEPS} "
          f"AdamW steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat on")
    launches, ms, losses, peak, model, state, step, extra = _train_steps(
        dev, cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS)
    profile = _profile_train_step(lambda: step(model, state, extra))
    timing = {"ms_per_step": ms, "median_ms": statistics.median(ms), "peak_bytes": peak,
              "losses": losses, "profile": profile, "card": smi}
    print(f"  {cfg.name} train step: median {timing['median_ms']:.1f} ms of {ms}, peak "
          f"{peak} bytes, {TRAIN_BATCH * TRAIN_SEQ * 1e3 / timing['median_ms']:.0f} tokens/s "
          f"({smi})")
    del model, state, step, extra
    _free()

    mla = get_config(TRAIN_MLA_ARCH).with_overrides(n_layers=TRAIN_MLA_LAYERS)
    print(f"  {mla.name}: full width at depth {TRAIN_MLA_LAYERS}, {TRAIN_MLA_STEPS} AdamW steps "
          f"of {TRAIN_MLA_BATCH} x {TRAIN_MLA_SEQ} tokens, remat on")
    mla_launches, ms, losses, peak, model, state, step, extra = _train_steps(
        dev, mla, TRAIN_MLA_BATCH, TRAIN_MLA_SEQ, TRAIN_MLA_STEPS)
    timing["mla"] = {"arch": mla.name, "layers": TRAIN_MLA_LAYERS, "ms_per_step": ms,
                     "median_ms": statistics.median(ms), "peak_bytes": peak, "losses": losses}
    print(f"  {mla.name} train step: median {timing['mla']['median_ms']:.1f} ms of {ms}, peak "
          f"{peak} bytes, {TRAIN_MLA_BATCH * TRAIN_MLA_SEQ * 1e3 / timing['mla']['median_ms']:.0f}"
          f" tokens/s ({smi})")
    del model, state, step, extra
    _free()
    scan_launches = {}
    for arch, layers in TRAIN_SCAN_ARCHS:
        c = get_config(arch).with_overrides(n_layers=layers)
        print(f"  {c.name}: full width at depth {layers}, {TRAIN_SCAN_STEPS} AdamW steps of "
              f"{TRAIN_SCAN_BATCH} x {TRAIN_SCAN_SEQ} tokens, remat on")
        scan_launches[arch], ms, losses, peak, model, state, step, extra = _train_steps(
            dev, c, TRAIN_SCAN_BATCH, TRAIN_SCAN_SEQ, TRAIN_SCAN_STEPS)
        med = statistics.median(ms)
        timing[arch] = {"layers": layers, "ms_per_step": ms, "median_ms": med,
                        "peak_bytes": peak, "losses": losses,
                        "tokens_per_s": TRAIN_SCAN_BATCH * TRAIN_SCAN_SEQ * 1e3 / med}
        print(f"  {c.name} train step: median {med:.1f} ms of {ms}, peak {peak} bytes, "
              f"{timing[arch]['tokens_per_s']:.0f} tokens/s ({smi})")
        del model, state, step, extra
        _free()
    for arch in TRAIN_CPU_ARCHS:
        train_card_vs_cpu(dev, arch)
    train_reduced_card_vs_cpu(dev)
    train_microbatches(dev)
    timing["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 10: {timing['seconds']:.1f} s")
    return launches, mla_launches, scan_launches, timing


def train_card_vs_cpu(dev, arch):
    """Full width at depth TRAIN_CPU_LAYERS (the scan families at their
    TRAIN_SCAN_ARCHS depth), the same weights on both devices: one ``forward_train`` and its gradients (remat on the card, off
    on the CPU) over TRAIN_CPU_BATCH x TRAIN_CPU_SEQ tokens; the loss within
    TRAIN_LOSS_TOL and every exported gradient leaf within TRAIN_GRAD_TOL of
    its largest magnitude."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset, to_device
    from repro_torch.launch.steps import _attention_head_dims, accumulate_grads
    from repro_torch.models import export_params, init, load_jax_params
    cfg = get_config(arch).with_overrides(n_layers=_cpu_depth(arch))
    t0 = time.perf_counter()
    card = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    cpu = load_jax_params(cfg, export_params(card), device="cpu")
    b = SyntheticLMDataset(cfg, DataConfig(batch_size=TRAIN_CPU_BATCH, seq_len=TRAIN_CPU_SEQ,
                                           seed=1)).batch(0)
    before = _counts()
    g_card, l_card, m_card = accumulate_grads(cfg, card, to_device(b, dev), remat=True)
    torch.cuda.synchronize()
    delta = {n: c - before[n] for n, c in _counts().items()}
    g_cpu, l_cpu, _ = accumulate_grads(cfg, cpu, to_device(b, "cpu"), remat=False)
    e_loss = abs(float(l_card) - float(l_cpu))
    worst, worst_key = 0.0, None
    for key, gc in g_cpu.items():
        scale = gc.abs().max().item()
        ratio = (g_card[key].cpu() - gc).abs().max().item() / max(scale, 1e-30)
        if ratio > worst:
            worst, worst_key = ratio, key
    L = cfg.n_layers
    check(e_loss <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL and delta == _train_launches(cfg),
          f"{arch} train card vs CPU at depth {L} ((D, Dv) {_attention_head_dims(cfg)}"
          + (", q/k norm" if cfg.qk_norm else "") + f"), {TRAIN_CPU_BATCH} x {TRAIN_CPU_SEQ} "
          f"tokens: loss {float(l_card):.6f} vs {float(l_cpu):.6f} (gap {e_loss:.3g}, tol "
          f"{TRAIN_LOSS_TOL}); {len(g_cpu)} gradient leaves, largest gap {worst:.3g} of the "
          f"leaf's largest magnitude ({worst_key}; tol {TRAIN_GRAD_TOL}); launches {delta}; "
          f"{time.perf_counter() - t0:.1f} s")
    del card, cpu
    _free()


def train_reduced_card_vs_cpu(dev):
    """Every arch at ``.reduced()`` (none is refused: ``kernels_without_backward``
    is empty for all ten): one ``forward_train`` and its gradients on the card
    (remat on) against the CPU (remat off) over 2 x 32 tokens of the
    synthetic data (with its random media or frames), the vlm's gates drawn
    nonzero: the loss within TRAIN_LOSS_TOL, every gradient leaf within
    TRAIN_GRAD_TOL of its largest magnitude, and for each kernel a no-grad
    forward launches (flash_attention for every self- and cross-attention,
    mamba_scan, rglru_scan) one backward launch for each of its forward
    launches, nothing else."""
    import torch
    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset, to_device
    from repro_torch.launch.steps import accumulate_grads, kernels_without_backward
    from repro_torch.models import export_params, forward_train, init, load_jax_params
    pairs = {"flash_attention": "flash_attention_bwd", "mamba_scan": "mamba_scan_bwd",
             "rglru_scan": "rglru_scan_bwd"}
    for arch in ALL_ARCHS:
        cfg = get_config(arch).reduced()
        missing = kernels_without_backward(get_config(arch)) + kernels_without_backward(cfg)
        card = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        _nonzero_gates(card, 1)
        b = SyntheticLMDataset(cfg, DataConfig(batch_size=2, seq_len=32, seed=3)).batch(0)
        cpu = load_jax_params(cfg, export_params(card), device="cpu")
        before = _counts()
        with torch.no_grad():
            forward_train(cfg, card, to_device(b, dev), remat=False)
        calls = {k: _counts()[k] - before[k] for k in pairs}
        before = _counts()
        g_card, l_card, _ = accumulate_grads(cfg, card, to_device(b, dev), remat=True)
        torch.cuda.synchronize()
        delta = {n: c - before[n] for n, c in _counts().items()}
        g_cpu, l_cpu, _ = accumulate_grads(cfg, cpu, to_device(b, "cpu"), remat=False)
        worst = max((g_card[k].cpu() - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                    for k, g in g_cpu.items())
        e_loss = abs(float(l_card) - float(l_cpu))
        launches_ok = (sum(calls.values()) > 0
                       and all(delta[bwd] == calls[fwd]
                               and calls[fwd] <= delta[fwd] <= 2 * calls[fwd]
                               and (calls[fwd] == 0 or delta[fwd] > calls[fwd])
                               for fwd, bwd in pairs.items())
                       and all(delta[n] == 0 for n in delta
                               if n not in pairs and n not in pairs.values()))
        check(not missing and e_loss <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL
              and launches_ok,
              f"{arch} reduced, train card vs CPU: loss {float(l_card):.6f} (gap {e_loss:.3g}), "
              f"{len(g_cpu)} gradient leaves within {worst:.3g} of their largest magnitude; "
              f"kernel calls a forward {calls}, launches {delta}; kernels without a backward "
              f"{missing}")
        del card, cpu
    _free()


def train_microbatches(dev):
    """Two microbatches against one over the whole batch, from the same
    weights (qwen2-0.5b at full width, depth TRAIN_CPU_LAYERS, 4 x
    TRAIN_CPU_SEQ tokens): the accumulated gradients (each leaf within
    TRAIN_MB_TOL of its largest magnitude), then one train step each: loss
    and grad_norm within TRAIN_MB_TOL (relative) and the parameters after
    the step equal within TRAIN_MB_PARAM_TOL (of max(|p|, 1)) wherever the
    gradient exceeds TRAIN_MB_WELL. Adam's first update is g' / (|g'| + eps)
    per element (g' the clipped gradient, eps 1e-8), whose slope eps / (|g'|
    + eps)^2 turns the summation-order gap of the two gradients (measured
    ~3e-6 of a leaf's largest magnitude) into an update gap of up to lr
    where |g'| is near eps; above TRAIN_MB_WELL the slope is below ~35 and
    the update gap below ~2e-5 of lr. The share of elements above it is
    printed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset, to_device
    from repro_torch.launch.steps import accumulate_grads, make_train_step
    from repro_torch.models import export_params, init, load_jax_params, param_tree
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_config(TRAIN_ARCH).with_overrides(n_layers=TRAIN_CPU_LAYERS)
    one = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    two = load_jax_params(cfg, export_params(one), device=dev)
    b = to_device(SyntheticLMDataset(cfg, DataConfig(batch_size=4, seq_len=TRAIN_CPU_SEQ,
                                                     seed=2)).batch(0), dev)
    g1, _, _ = accumulate_grads(cfg, one, b, remat=True, microbatches=1)
    g2, _, _ = accumulate_grads(cfg, two, b, remat=True, microbatches=2)
    g_gap = max(((g2[k] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                for k, g in g1.items())
    opt = AdamWConfig(**TRAIN_OPT)
    out = []
    for model, n in ((one, 1), (two, 2)):
        _, _, m = make_train_step(cfg, opt, remat=True, microbatches=n)(
            model, adamw_init(param_tree(model)), b)
        out.append(({k: float(v) for k, v in m.items()}, param_tree(model)))
    (m1, p1), (m2, p2) = out
    rel = {k: abs(m2[k] - m1[k]) / max(abs(m1[k]), 1e-30) for k in ("loss", "grad_norm")}
    p_gap, n_well, n_all = 0.0, 0, 0
    for k, v in p1.items():
        well = g1[k].abs() > TRAIN_MB_WELL
        n_well, n_all = n_well + int(well.sum()), n_all + well.numel()
        if well.any():
            p_gap = max(p_gap, ((p2[k] - v).abs()[well] / v.abs()[well].clamp_min(1.0)).max().item())
    check(g_gap <= TRAIN_MB_TOL and max(rel.values()) <= TRAIN_MB_TOL
          and p_gap <= TRAIN_MB_PARAM_TOL,
          f"train step over 2 microbatches vs 1: gradients within {g_gap:.3g} of each leaf's "
          f"largest magnitude; loss {m2['loss']:.6f} vs {m1['loss']:.6f}, grad_norm "
          f"{m2['grad_norm']:.6f} vs {m1['grad_norm']:.6f} (relative gaps {_fmt(rel.values())}; "
          f"tol {TRAIN_MB_TOL}); parameters after the step within {p_gap:.3g} (tol "
          f"{TRAIN_MB_PARAM_TOL}) where |g| > {TRAIN_MB_WELL} ({n_well / n_all:.1%} of "
          f"{n_all} elements)")
    del one, two
    _free()


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _start_dryruns(out_dir):
    """DRYRUN_COMBOS' dry runs, one process each, without the card (they
    count shapes on the CPU), their output in a log beside their records:
    [(combo, its records file, the process)]."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    out = []
    for arch, shape, mesh in DRYRUN_COMBOS:
        path = out_dir / f"dryrun_{arch}_{shape}_{mesh}.jsonl"
        path.unlink(missing_ok=True)
        with open(path.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                 shape, "--mesh", mesh, "--out", str(path)], cwd=ROOT, env=env,
                stdout=log, stderr=subprocess.STDOUT)
        out.append(((arch, shape, mesh), path, proc))
    return out


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _same(a, b):
    """(bit for bit, the largest difference relative to b's largest
    magnitude)."""
    import torch
    a, b = _full(a), _full(b)
    if torch.equal(a, b):
        return True, 0.0
    return False, float(((a.double() - b.double()).abs().max()
                         / b.double().abs().max().clamp_min(1e-30)))


def _sharded_steps(dev):
    """11a: the sharded train and serve steps at world size 1 against the
    unsharded ones. Returns ({path: launches}, timing)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset, to_device
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import cache_axes, init, param_tree
    from repro_torch.optim import AdamWConfig, adamw_init

    mesh = make_host_mesh()
    cfg = get_config(TRAIN_ARCH)
    rules = sh.logical_rules(cfg, mesh)
    ref = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    model = st.shard_model(init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
                           mesh)
    print(f"  {cfg.name}: {len(list(model.parameters()))} DTensor parameters on {mesh}")
    opt = AdamWConfig(**{**TRAIN_OPT, "total_steps": SHARD_STEPS})
    step = st.make_train_step(cfg, opt, remat=True)
    ds = SyntheticLMDataset(cfg, DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    batches = [{k: v for k, v in to_device(ds.batch(i), dev).items() if k in ("tokens", "targets")}
               for i in range(SHARD_STEPS)]
    b_sh = sh.tree_shardings(mesh, st.batch_axes(cfg), batches[0], rules)
    ref_state = adamw_init(param_tree(ref))
    with st.on_mesh(model):
        state = adamw_init(param_tree(model))
    paths, timing = {}, {"train_ms": [], "sharded_train_ms": []}
    for name, m, s_, key in (("unsharded", ref, ref_state, "train_ms"),
                             ("sharded", model, state, "sharded_train_ms")):
        _reset_counts()
        losses = []
        for b in batches:
            b = b if name == "unsharded" else sh.distribute(b, b_sh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m, s_, met = step(m, s_, b)
            torch.cuda.synchronize()
            timing[key].append((time.perf_counter() - t0) * 1e3)
            losses.append(_full(met["loss"]))
        paths[f"{cfg.name} {name} train"] = _counts()
        timing[f"{name}_losses"] = losses
    same, worst = [], 0.0
    for i in range(SHARD_STEPS):
        eq, d = _same(timing["sharded_losses"][i], timing["unsharded_losses"][i])
        same.append(eq)
        worst = max(worst, d)
    want, got = param_tree(ref), param_tree(model)
    leaves_eq = 0
    for k in want:
        eq, d = _same(got[k], want[k])
        leaves_eq += eq
        worst = max(worst, d)
    u, s_counts = paths[f"{cfg.name} unsharded train"], paths[f"{cfg.name} sharded train"]
    kern = ("flash_attention", "flash_attention_bwd")
    check(worst <= SHARD_TOL and all(u[k] == s_counts[k] > 0 for k in kern),
          f"sharded train ({SHARD_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}) against "
          f"unsharded: losses bit for bit {same}, {leaves_eq}/{len(want)} parameter leaves bit "
          f"for bit, largest relative difference {worst:.3g} (limit {SHARD_TOL}); launches "
          f"sharded {s_counts} unsharded {u}; ms a step sharded {_fmt(timing['sharded_train_ms'])}"
          f" unsharded {_fmt(timing['train_ms'])}")
    timing["train_worst"] = worst
    timing["train_losses_bit_for_bit"] = all(same)
    timing["train_leaves_bit_for_bit"] = leaves_eq
    del timing["sharded_losses"], timing["unsharded_losses"]

    prompt = batches[0]["tokens"]
    dprompt = sh.distribute({"tokens": prompt}, sh.tree_shardings(
        mesh, st.prefill_batch_axes(cfg), {"tokens": prompt}, rules))
    pf, sv = st.make_prefill_step(cfg), st.make_serve_step(cfg)
    out = {}
    for name, m, b in (("unsharded", ref, {"tokens": prompt}), ("sharded", model, dprompt)):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = pf(m, b)
        token = _full(logits).argmax(-1)
        if name == "sharded":
            token = sh.distribute(token, sh.tree_shardings(mesh, ("batch",), token, rules))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec, _ = sv(m, cache, token, TRAIN_SEQ)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[name] = (logits, dec)
        paths[f"{cfg.name} {name} serve"] = _counts()
        timing[f"{name}_prefill_ms"] = (t1 - t0) * 1e3
        timing[f"{name}_serve_ms"] = (t2 - t1) * 1e3
    u, s_counts = paths[f"{cfg.name} unsharded serve"], paths[f"{cfg.name} sharded serve"]
    eq_p, d_p = _same(out["sharded"][0], out["unsharded"][0])
    eq_d, d_d = _same(out["sharded"][1], out["unsharded"][1])
    check(max(d_p, d_d) <= SHARD_TOL
          and all(u[k] == s_counts[k] > 0 for k in ("flash_attention", "flash_decode")),
          f"sharded prefill ({TRAIN_BATCH} x {TRAIN_SEQ}) and serve step against unsharded: "
          f"logits bit for bit {eq_p} / {eq_d}, largest relative difference {d_p:.3g} / "
          f"{d_d:.3g} (limit {SHARD_TOL}); launches sharded {s_counts} unsharded {u}; prefill "
          f"ms {timing['sharded_prefill_ms']:.1f} / {timing['unsharded_prefill_ms']:.1f}, serve "
          f"step ms {timing['sharded_serve_ms']:.1f} / {timing['unsharded_serve_ms']:.1f} "
          f"(sharded / unsharded)")
    timing["serve_worst"] = max(d_p, d_d)
    timing["cache_placements"] = str(next(iter(cache.values()))["blk"]["k"].placements)
    return paths, timing


def _check_dryruns(runs, results):
    """11b: each dry run exited 0 with an ok record; their records joined
    into ``results``. Returns {combo: seconds}."""
    seconds = {}
    lines = []
    for combo, path, proc in runs:
        try:
            proc.wait(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log = path.with_suffix(".log").read_text()
        recs = [json.loads(x) for x in path.read_text().splitlines()] if path.exists() else []
        rec = recs[-1] if recs else {}
        ok = (proc.returncode == 0 and rec.get("status") == "ok" and rec.get("jaxpr_flops", 0) > 0
              and "collectives" in rec)
        seconds[" x ".join(combo)] = rec.get("total_s")
        check(ok, f"dry run {' x '.join(combo)}: exit {proc.returncode}, status "
                  f"{rec.get('status')}, {rec.get('devices')} devices, "
                  f"{rec.get('jaxpr_flops', 0):.4g} FLOPs, "
                  f"collectives {json.dumps(rec.get('collectives'))}, "
                  f"{rec.get('argument_size_in_bytes')} argument bytes a device, "
                  f"{rec.get('total_s')} s"
                  + ("" if ok else f"; {rec.get('error', '')[:300]} {log[-1500:]}"))
        lines += [json.dumps(r) for r in recs]
    results.write_text("".join(x + "\n" for x in lines))
    return seconds


def _priced_env(dev, results):
    """11c: the EdgeRL env priced from the dry run's records, on the card
    and on the CPU."""
    import dataclasses
    import torch
    from repro_torch.core import (A2CConfig, decide, env_reset, env_step, make_dryrun_tpu_env,
                                  train_agent)
    from repro_torch.core.roofline_env import _load_records
    archs = ["qwen2-0.5b", "falcon-mamba-7b"]
    env_cfg, tables = make_dryrun_tpu_env(archs, results=str(results), device=dev)
    _, cpu_tables = make_dryrun_tpu_env(archs, results=str(results), device="cpu")
    arrays = [f.name for f in dataclasses.fields(tables)
              if isinstance(getattr(tables, f.name), torch.Tensor)]
    calibrated = sorted(a for a, s in _load_records(str(results)) if s == "prefill_32k")
    check(tables.device == dev and all(
        torch.equal(getattr(tables, k).cpu(), getattr(cpu_tables, k)) for k in arrays)
        and calibrated == ["qwen2-0.5b"],
        f"make_dryrun_tpu_env({archs}) tables on the card equal the CPU's exactly "
        f"({tables.n_versions} versions x {tables.n_cuts} cuts; calibrated to the dry run: "
        f"{calibrated}, analytic: falcon-mamba-7b)")
    agent, hist = train_agent(env_cfg, tables, A2CConfig(episodes=SHARD_A2C_UPDATES,
                                                         batch_envs=4), seed=0)
    gen = torch.Generator(device=dev).manual_seed(7)
    state = env_reset(env_cfg, tables, gen)
    rewards, chosen = [], []
    for _ in range(SHARD_ENV_STEPS):
        actions = decide(agent, env_cfg, tables, state)
        valid = bool(tables.version_valid[state["model_id"], actions[:, 0]].all())
        state, reward, _ = env_step(env_cfg, tables, state, actions, gen)
        rewards.append(float(reward.sum()))
        chosen.append((actions.cpu().tolist(), valid))
    check(all(math.isfinite(r) for r in rewards) and all(v for _, v in chosen)
          and all(math.isfinite(h["loss"]) for h in hist),
          f"A2C ({SHARD_A2C_UPDATES} updates) decides greedily on the priced env: actions "
          f"{[a for a, _ in chosen]}, rewards {_fmt(rewards)}")
    return rewards


def _sharded_scan(dev, smi):
    """11d: the scan engine's device axis sharded over the group of one: the
    megafleet world at its full size through the scan with shard=True and
    with shard=False on the card, equal bit for bit (summary, selection
    histogram, epoch log, timeline) for SCAN_POLICIES; all-reduces a
    sharded run (one an epoch, three after the loop); for
    SHARD_SCAN_PROFILED host synchronizations inside the sharded loop (0),
    launches and NCCL kernels an epoch and device busy time of both. Returns
    timing."""
    import torch
    import torch.distributed as dist
    from repro_torch.policies import build_policy
    from repro_torch.scenarios import get_scenario
    from repro_torch.sim import FleetConfig, simulate
    sc = get_scenario("megafleet")
    env_cfg, tables, mids, _ = sc.build_env(device=dev)
    print(f"  11d. {sc.name} ({sc.devices} devices, {sc.n_requests} requests) through the "
          f"scan, shard=True over the group of {dist.get_world_size()} against shard=False; "
          f"card {smi}")
    calls, all_reduce = [0], dist.all_reduce

    def counted(*a, **kw):
        calls[0] += 1
        return all_reduce(*a, **kw)

    def run(pol, shard):
        calls[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulate(env_cfg, tables, pol, sc.build_trace(), n_requests=sc.n_requests,
                       seed=sc.seeds[0], model_ids=mids,
                       fleet=FleetConfig(slo_s=sc.slo_s, engine="scan", shard=shard,
                                         timeline=True))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, calls[0]

    timing = {"card": smi}
    dist.all_reduce = counted
    try:
        for name in SCAN_POLICIES:
            pol = build_policy(name, env_cfg, tables)
            u, wu, cu = run(pol, False)
            s, ws, cs = run(pol, True)
            same = (same_sim_result(s, u) and (s.epochs, s.served) == (u.epochs, u.served)
                    and s.timeline.to_json() == u.timeline.to_json())
            t = {"epochs": s.epochs, "requests": s.served, "all_reduce": cs,
                 "sharded": {"wall_s": ws, "epochs_per_s": s.epochs / ws},
                 "unsharded": {"wall_s": wu, "epochs_per_s": u.epochs / wu}}
            syncs, msgs = [0] * (s.epochs - 1), []
            if name == SHARD_SCAN_PROFILED:
                (s2, _, _), syncs, msgs = _loop_syncs(pol, lambda: run(pol, True))
                same = same and same_sim_result(s2, u)
                for label, shard in (("unsharded", False), ("sharded", True)):
                    prof = _scan_profile(lambda: run(pol, shard), s.epochs)
                    t[label].update({k: prof[k] for k in (
                        "launches_per_epoch", "nccl_kernels_per_epoch", "device_busy_s",
                        "profiled_wall_s", "idle_share")})
                t["syncs_per_epoch"] = syncs
            timing[name] = t
            check(same and cu == 0 and cs == s.epochs + 3 and sum(syncs) == 0
                  and len(syncs) == s.epochs - 1,
                  f"{sc.name} {name}: scan shard=True (group of {dist.get_world_size()}) = "
                  f"shard=False bit for bit (summary, selection histogram, epoch log, "
                  f"timeline); {s.epochs} epochs, {s.served} requests; all-reduces {cs} "
                  f"(one an epoch and 3 after the loop; shard=False {cu})"
                  + (f"; host synchronizations in the sharded loop {syncs}"
                     + (f" ({msgs})" if msgs else "") if name == SHARD_SCAN_PROFILED else ""))
            print(f"    {name}: sharded {ws:.3f} s ({s.epochs / ws:.1f} epochs/s), unsharded "
                  f"{wu:.3f} s ({u.epochs / wu:.1f} epochs/s)" + "".join(
                      f"; {k} {t[k]['launches_per_epoch']:.1f} launches and "
                      f"{t[k]['nccl_kernels_per_epoch']:.1f} NCCL kernels an epoch, device busy "
                      f"{t[k]['device_busy_s']:.4f} s of {t[k]['profiled_wall_s']:.4f} s"
                      for k in ("unsharded", "sharded") if "launches_per_epoch" in t[k])
                  + f"; card {smi}")
    finally:
        dist.all_reduce = all_reduce
    return timing


def phase_sharded(dev, smi):
    """Phase 11: the sharded steps at world size 1 on the card (11a), the
    dry runs on its host (11b, started first and run beside 11a), the env
    priced from their records (11c), the sharded scan engine (11d). Returns
    ({path: launches}, timing)."""
    import torch.distributed as dist
    t_phase = time.perf_counter()
    print(f"== 11. shardings and the dry run: full-width {TRAIN_ARCH} sharded at world size 1 "
          f"(NCCL), {len(DRYRUN_COMBOS)} dry runs on the host, the env priced from them")
    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = _start_dryruns(out_dir)
    try:
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                                rank=0, world_size=1, device_id=dev)
        paths, timing = _sharded_steps(dev)
        timing["sharded_steps_s"] = time.perf_counter() - t_phase
        results = out_dir / "dryrun.jsonl"
        timing["dryrun_s"] = _check_dryruns(runs, results)
        timing["env_rewards"] = _priced_env(dev, results)
        t_scan = time.perf_counter()
        timing["scan"] = _sharded_scan(dev, smi)
        timing["scan"]["seconds"] = time.perf_counter() - t_scan
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for _, _, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    _free()
    timing["seconds"] = time.perf_counter() - t_phase
    timing["card"] = smi
    print(f"  phase 11: {timing['seconds']:.1f} s")
    return paths, timing


def _bwd_kernel_ms(fa, args, iters=10):
    """Device ms a call of the backward's kernels, by kernel (the delta
    pre-pass, dK/dV, the reduce pass, dQ; the reduce 0 where no key tile is
    split), by CUDA events that ``flash_attention_bwd`` records between its
    launches, the mean over ``iters`` calls."""
    import torch
    names = ("bwd_delta", "bwd_dkdv", "bwd_reduce", "bwd_dq")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    fa.flash_attention_bwd(*args, events=ev)
    ms = dict.fromkeys(names, 0.0)
    for _ in range(iters):
        fa.flash_attention_bwd(*args, events=ev)
        ev[-1].synchronize()
        for i, name in enumerate(names):
            ms[name] += ev[i].elapsed_time(ev[i + 1]) / iters
    return ms


def _scan_bwd_kernel_ms(ms, args, iters=10):
    """Device ms a call of mamba_scan's backward, by kernel (the walk, the
    reduce pass), by CUDA events that ``mamba_scan_bwd`` records between
    its launches, the mean over ``iters`` calls."""
    import torch
    names = ("mamba_scan_bwd", "mamba_scan_bwd_reduce")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ms.mamba_scan_bwd(*args, events=ev)
    out = dict.fromkeys(names, 0.0)
    for _ in range(iters):
        ms.mamba_scan_bwd(*args, events=ev)
        ev[-1].synchronize()
        for i, name in enumerate(names):
            out[name] += ev[i].elapsed_time(ev[i + 1]) / iters
    return out


def time_flash_attention_bwd(dev, g, err, launches):
    """The backward kernel at FA_BWD_PATHS (f32, causal, views of (B, S, H,
    D) tensors; qwen2-0.5b's shape first, its numbers the row's own, then
    qwen3-0.6b's and deepseek-v2-lite-16b's under ``qwen3_`` and ``mla_``):
    eager and as a CUDA graph (device time), each kernel's device time by
    CUDA events between its launches, beside the plain backward, the
    backward of SDPA (``sdpa_bwd_ms``) and its bound (``fa_bwd_bound``: five
    products over the visible pairs, Q.K^T, dO.V^T, dS.K, dS^T.Q and
    P^T.dO, at the 3xTF32 rate)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "none: no Pallas backward exists (the JAX package differentiates its "
                       "jnp attention, src/repro/kernels/ops.py:65)",
           "launches": launches["flash_attention_bwd"], "max_abs_err": err}
    for (B, H, HK, S, D, Dv, label), pre in zip(FA_BWD_PATHS, ("", "qwen3_", "mla_", "rg_")):
        q = torch.randn(B, S, H, D, generator=g, device=dev).transpose(1, 2)
        do = torch.randn(B, S, H, Dv, generator=g, device=dev).transpose(1, 2)
        k = torch.randn(B, S, HK, D, generator=g, device=dev).transpose(1, 2)
        v = torch.randn(B, S, HK, Dv, generator=g, device=dev).transpose(1, 2)
        o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        run = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)  # noqa: E731
        by_kernel = _bwd_kernel_ms(fa, (q, k, v, o, lse, do))
        ms = cuda_ms(run, 20)
        dev_ms = graph_ms(run, 20)
        plain = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do), 5)
        lib, lib_dev = sdpa_bwd_ms(q, k, v, do), sdpa_bwd_device_ms(q, k, v, do)
        bound, by, nops, nbytes, pairs = fa_bwd_bound(B, H, HK, S, D, Dv, torch.float32)
        plan = fa.bwd_plan(B, H, HK, S, S, D, Dv, torch.float32, True, None,
                           _build.sm_count(q.device))
        print(f"  flash_attention_bwd at {label}'s training shape ({B} x {H}/{HK} x {S}, "
              f"(D, Dv) = ({D}, {Dv})): {ms:.4f} ms eager, {dev_ms:.4f} ms device, "
              f"{bound / dev_ms:.1%} of its 3xTF32 bound {bound:.4f} ms ({by}; "
              f"{nops / 1e9:.2f} GFLOP over {pairs} visible pairs, {nbytes / 1e6:.1f} MB); by "
              f"kernel (CUDA events, ms) " + ", ".join(f"{n} {t:.4f}" for n, t in by_kernel.items())
              + f"; plain {plain:.4f} ms, SDPA backward {lib:.4f} ms eager, {lib_dev:.4f} ms device; "
              f"split: chunk "
              f"{plan.chunk}, longest block {plan.longest} tiles, {plan.slots} slots")
        row.update({f"{pre}ms": ms, f"{pre}plain_ms": plain, f"{pre}bound_ms": bound,
                    f"{pre}bound_by": by, f"{pre}library_ms": lib,
                    f"{pre}library_device_ms": lib_dev, f"{pre}device_ms": dev_ms,
                    f"{pre}kernel_ms": by_kernel,
                    f"{pre}shape": f"f32 q ({B},{H},{S},{D}) k ({B},{HK},{S},{D}) v "
                                   f"({B},{HK},{S},{Dv}) causal, per call, {label}'s training "
                                   f"shape"})
        del q, k, v, o, lse, do
        if label in FA_BWD_BF16:
            row.update(_prefixed(f"{pre}bf16_", time_flash_attention_bwd_bf16(
                dev, g, B, H, HK, S, D, Dv, label)))
    return row


def time_flash_attention_bwd_bf16(dev, g, B, H, HK, S, D, Dv, label):
    """The backward kernel in bf16 at one of FA_BWD_PATHS: eager and as a
    CUDA graph, beside the plain backward, SDPA's bf16 backward eager and as
    device time (``sdpa_bwd_device_ms``) and the bf16 tensor-core bound."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    dt = torch.bfloat16
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(dt).transpose(1, 2)
    do = torch.randn(B, S, H, Dv, generator=g, device=dev).to(dt).transpose(1, 2)
    k = torch.randn(B, S, HK, D, generator=g, device=dev).to(dt).transpose(1, 2)
    v = torch.randn(B, S, HK, Dv, generator=g, device=dev).to(dt).transpose(1, 2)
    o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
    run = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)  # noqa: E731
    ms, dev_ms = cuda_ms(run, 20), graph_ms(run, 20)
    by_kernel = _bwd_kernel_ms(fa, (q, k, v, o, lse, do))
    plain = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do), 5)
    lib, lib_dev = sdpa_bwd_ms(q, k, v, do), sdpa_bwd_device_ms(q, k, v, do)
    bound, by, _, _, _ = fa_bwd_bound(B, H, HK, S, D, Dv, dt)
    print(f"  flash_attention_bwd bf16 at {label}'s training shape: {ms:.4f} ms eager, "
          f"{dev_ms:.4f} ms device, bound {bound:.4f} ms ({by}); by kernel (CUDA events, ms) "
          + ", ".join(f"{n} {t:.4f}" for n, t in by_kernel.items())
          + f"; plain {plain:.4f} ms; SDPA backward {lib:.4f} ms eager, {lib_dev:.4f} ms device")
    return {"ms": ms, "device_ms": dev_ms, "kernel_ms": by_kernel, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib, "library_device_ms": lib_dev,
            "shape": f"bf16 q ({B},{H},{S},{D}) k ({B},{HK},{S},{D}) v ({B},{HK},{S},{Dv}) "
                     f"causal, per call, {label}'s training shape"}


def sdpa_bwd_ms(q, k, v, do, iters=20):
    """Mean ms of the backward of causal SDPA under autograd at the
    backward kernel's inputs, timed alone (k and v repeated to q's heads as
    leaves, so no repeat's backward is in it)."""
    import torch
    import torch.nn.functional as F
    G = q.shape[1] // k.shape[1]
    qs = q.detach().clone().requires_grad_()
    kr, vr = (t.repeat(1, G, 1, 1).detach().requires_grad_() for t in (k, v))
    out = F.scaled_dot_product_attention(qs, kr, vr, is_causal=True)
    return cuda_ms(lambda: torch.autograd.grad(out, (qs, kr, vr), do, retain_graph=True), iters)


def sdpa_bwd_device_ms(q, k, v, do, iters=20):
    """Device ms of the backward that ``sdpa_bwd_ms`` times, replayed as one
    CUDA graph: the forward runs on the capturing stream, so that autograd
    runs its backward there. Where the capture is refused, the device time
    of its kernels summed by ``torch.profiler`` (said in the output)."""
    import torch
    import torch.nn.functional as F
    G = q.shape[1] // k.shape[1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qs = q.detach().clone().requires_grad_()
        kr, vr = (t.repeat(1, G, 1, 1).detach().requires_grad_() for t in (k, v))
        out = F.scaled_dot_product_attention(qs, kr, vr, is_causal=True)
        grad = lambda: torch.autograd.grad(out, (qs, kr, vr), do, retain_graph=True)  # noqa: E731
        for _ in range(2):
            grad()
    torch.cuda.current_stream().wait_stream(side)
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            grad()
        ms = cuda_ms(graph.replay, iters)
        del graph
        return ms
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"  SDPA backward not captured ({str(e)[:80]}); its device time from "
              f"torch.profiler")
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                grad()
            torch.cuda.synchronize()
        return sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3 / iters


def fa_bwd_bound(B, H, HK, S, D, Dv, dtype):
    """The causal backward's bound at (B, H, HK, S, D, Dv): five products
    over the visible pairs, 2 (3 D + 2 Dv) FLOP a pair, at the 3xTF32 rate
    (f32) or the bf16 rate, against q, k, v, o, dO and the three gradients
    in ``dtype`` and the f32 lse moved once. Returns (ms, what bounds it,
    FLOP, bytes, visible pairs)."""
    import torch
    size = torch.empty((), dtype=dtype).element_size()
    pairs = B * H * S * (S + 1) // 2
    nops = 2 * (3 * D + 2 * Dv) * pairs
    nbytes = (size * (B * H * S * (2 * D + 2 * Dv) + B * HK * S * (2 * D + 2 * Dv))
              + 4 * B * H * S)
    bound, by = _bound(nbytes, nops, PEAK_3XTF32 if dtype == torch.float32 else PEAK_BF16)
    return bound, by, nops, nbytes, pairs


def phase_timing(dev, qmm_err, ms_err, rs_err, fa_bwd_err, ms_bwd_err, rs_bwd_err, launches):
    import torch
    print("== 7. kernel timing at the main path's shapes (CUDA events)")
    g = torch.Generator(device=dev).manual_seed(3)
    bwd_row = time_flash_attention_bwd(dev, g, fa_bwd_err, launches)
    qmm_row = time_quant_matmul(dev, g, qmm_err, launches)

    fa_main, fa_split, fa_prefill, fa_qwen3, fa_sc2, fa_mix, fa_mix_prefill = FA_PATHS
    fa_row = time_attention(dev, g, *fa_main, "")
    fa_row.update(_d256(time_attention(dev, g, *fa_split, f" ({RG_ARCH} split path)")))
    fa_row.update(_prefixed("prefill_", time_attention(dev, g, *fa_prefill,
                                                       f" ({RG_ARCH} prefill)")))
    fa_row.update(_prefixed("qwen3_", time_attention(dev, g, *fa_qwen3,
                                                     " (qwen3-0.6b split path)")))
    fa_row.update(_prefixed("sc2_", time_attention(dev, g, *fa_sc2,
                                                   " (starcoder2-3b decode prefill)")))
    fa_row.update(_prefixed("mix_", time_attention(dev, g, *fa_mix,
                                                   " (mixtral-8x22b split path)")))
    fa_row.update(_prefixed("mix_prefill_", time_attention(dev, g, *fa_mix_prefill,
                                                           " (mixtral-8x22b decode prefill)")))
    B, H, HK, S, D, Dv = FA_MLA_PATH
    fa_row.update(_prefixed("mla_", time_attention(
        dev, g, B, H, HK, S, D, None, " (deepseek-v2-lite-16b split path, MLA)", Dv=Dv)))
    vlm_x, wh_enc, wh_x = FA_CROSS_PATHS
    fa_row.update(_prefixed("vlm_x_", time_cross_attention(
        dev, g, *vlm_x, " (llama-3.2-vision-90b image layer, split path)")))
    fa_row.update(_prefixed("wh_enc_", time_cross_attention(
        dev, g, *wh_enc, " (whisper-large-v3 encoder)")))
    fa_row.update(_prefixed("wh_x_", time_cross_attention(
        dev, g, *wh_x, " (whisper-large-v3 cross-attention, split path)")))
    fd_main, fd_rg, fd_sc2, fd_mix = FD_PATHS
    fd_row = time_decode(dev, g, *fd_main, "")
    fd_row.update(_d256(time_decode(dev, g, *fd_rg, f" ({RG_ARCH} decode path)")))
    fd_row.update(_prefixed("sc2_", time_decode(dev, g, *fd_sc2,
                                                " (starcoder2-3b decode path)")))
    fd_row.update(_prefixed("mix_", time_decode(dev, g, *fd_mix,
                                                " (mixtral-8x22b decode path)")))
    vlm_step, wh_step = FD_CROSS_PATHS
    fd_row.update(_prefixed("vlm_x_", time_cross_step(
        dev, g, *vlm_step, " (llama-3.2-vision-90b one-token cross step)")))
    fd_row.update(_prefixed("wh_x_", time_cross_step(
        dev, g, *wh_step, " (whisper-large-v3 one-token cross step)")))

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:103",
         "launches": launches["flash_attention"], **fa_row},
        bwd_row,
        qmm_row,
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:98",
         "launches": launches["flash_decode"], **fd_row},
        time_mamba_scan(dev, g, ms_err, launches),
        time_rglru_scan(dev, g, rs_err, launches),
        time_mamba_scan_bwd(dev, g, ms_bwd_err, launches),
        time_rglru_scan_bwd(dev, g, rs_bwd_err, launches),
    ]
    for kern in kernels:
        print(f"  {kern['name']}: ms={kern['ms']:.4f} plain_ms={kern['plain_ms']:.4f} "
              f"library_ms={kern['library_ms']} bound_ms={kern['bound_ms']:.4f} "
              f"({kern['bound_by']}) [{kern['shape']}]")
        for pre in ("d256_", "prefill_", "cohort_", "decode_", "rg_", "head_", "qwen3_", "sc2_",
                    "phi3_", "phi3_head_", "mix_", "mix_prefill_", "mix_head_", "mla_", "ds_",
                    "ds_head_", "vlm_x_", "wh_enc_", "wh_x_", "vlm_", "vlm_head_", "wh_",
                    "wh_head_", "bf16_", "rg_bf16_"):
            if f"{pre}ms" in kern:
                print(f"  {kern['name']} {pre[:-1]}: ms={kern[pre + 'ms']:.4f} "
                      f"plain_ms={kern[pre + 'plain_ms']:.4f} "
                      f"library_ms={kern[pre + 'library_ms']} "
                      f"bound_ms={kern[pre + 'bound_ms']:.4f} ({kern[pre + 'bound_by']}) "
                      f"[{kern[pre + 'shape']}]")
        for pre in ("", "d256_", "prefill_", "cohort_", "decode_", "sc2_", "phi3_",
                    "phi3_head_", "mix_", "mix_head_", "ds_", "ds_head_", "vlm_x_", "wh_x_",
                    "vlm_", "vlm_head_", "wh_", "wh_head_", "qwen3_", "mla_", "rg_", "bf16_",
                    "rg_bf16_"):
            if f"{pre}device_ms" in kern:
                print(f"  {kern['name']} {pre[:-1] or 'main'} device time (CUDA graph) "
                      f"{kern[pre + 'device_ms']:.4f} ms")
    return kernels


def _bound(nbytes, nops, peak_ops=PEAK_F32):
    """(bound ms, what bounds it) for ``nbytes`` moved and ``nops`` done."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, nops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def _prefixed(prefix, row):
    """A timing row's keys under ``prefix``."""
    return {f"{prefix}{k}": v for k, v in row.items()}


def _d256(row):
    """A timing row's keys under the ``d256_`` prefix (head_dim 256)."""
    return _prefixed("d256_", row)


def graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()``, replayed as one CUDA graph, so
    no host work sits between its launches (the eager ``cuda_ms`` of a small
    kernel times the host's launch path when that is the slower)."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the stream it warmed up on (flash_decode makes its
    # workspace for a stream on the first call there, never in a capture)
    with torch.cuda.graph(graph, stream=side):
        fn()
    ms = cuda_ms(graph.replay, iters)
    del graph
    return ms


def time_attention(dev, g, B, H, HK, S, D, window, path, Dv=None):
    """flash_attention per call (one layer), f32, causal, q and k/v as views
    of the model's (B, S, H, D) projections, v of head dim Dv (default D):
    its time, error, plain and SDPA time and bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    Dv = D if Dv is None else Dv
    q = torch.randn(B, S, H, D, generator=g, device=dev).transpose(1, 2)
    k = torch.randn(B, S, HK, D, generator=g, device=dev).transpose(1, 2)
    v = torch.randn(B, S, HK, Dv, generator=g, device=dev).transpose(1, 2)
    err = (fa.flash_attention(q, k, v, causal=True, window=window)
           - fa.flash_attention_ref(q, k, v, causal=True, window=window)).abs().max().item()
    dims = f"D={D}" + (f", Dv={Dv}" if Dv != D else "")
    check(err <= FA_TOL["float32"],
          f"flash_attention at {dims}, the path shape{path}: max_abs_err={err:.3g}")
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True, window=window), 50)
    plain = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, causal=True, window=window), 10)
    # SDPA groups heads as h // G; expanding k, v to H heads as h % HK
    # makes it compute the same function. Where the window masks keys, SDPA
    # gets the same causal-and-window boolean mask.
    kr, vr = k.repeat(1, H // HK, 1, 1), v.repeat(1, H // HK, 1, 1)
    i = torch.arange(S, device=dev)
    visible = i[None, :] <= i[:, None]
    if window is not None and window < S:
        visible &= i[:, None] - i[None, :] < window
    try:
        if window is not None and window < S:
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=visible),
                          50)
        else:
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True), 50)
    except RuntimeError as e:    # a v head dim apart from q's that no backend takes
        lib = None
        print(f"  SDPA refuses q/k {D}, v {Dv}: {str(e).splitlines()[0]}")
    # QK^T (D) and PV (Dv) over the visible pairs, at the rate of the
    # arithmetic the kernel runs them in: 3xTF32 on the tensor cores (the
    # f32 CUDA-core bound only printed, for comparison with the kernel's
    # first design)
    nbytes = 4 * (B * H * S * (D + Dv) + B * HK * S * (D + Dv))
    nops = 2 * B * H * (D + Dv) * int(visible.sum())
    bound, by = _bound(nbytes, nops, PEAK_3XTF32)
    print(f"  flash_attention at {dims}{path}: 3xTF32 bound {bound:.4f} ms ({by}), "
          f"{bound / ms:.1%} of it reached; f32 CUDA-core bound {_bound(nbytes, nops)[0]:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib,
            "shape": f"f32 q ({B},{H},{S},{D}) k ({B},{HK},{S},{D}) v ({B},{HK},{S},{Dv}) "
                     f"causal, window {window}, per call{path}"}


def time_cross_attention(dev, g, B, H, HK, Sq, Skv, D, path):
    """flash_attention per call without a mask at Sq queries over Skv keys
    (a cross-attention layer, or whisper's encoder at Sq = Skv), f32, q, k
    and v as views of (B, S, H, D) projections: its time, error, plain and
    SDPA time and its 3xTF32 bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).transpose(1, 2)
    k, v = (torch.randn(B, Skv, HK, D, generator=g, device=dev).transpose(1, 2)
            for _ in range(2))
    err = (fa.flash_attention(q, k, v, causal=False)
           - fa.flash_attention_ref(q, k, v, causal=False)).abs().max().item()
    check(err <= FA_TOL["float32"],
          f"flash_attention without a mask, the path shape{path}: max_abs_err={err:.3g}")
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=False), 50)
    plain = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, causal=False), 10)
    # SDPA groups heads as h // G; k, v repeated to H heads read kv head h % HK
    kr, vr = k.repeat(1, H // HK, 1, 1), v.repeat(1, H // HK, 1, 1)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, kr, vr), 50)
    # q read and the output written once, k and v read once; QK^T and PV
    # over every (query, key) pair at the 3xTF32 rate
    nbytes = 4 * (2 * B * H * Sq * D + 2 * B * HK * Skv * D)
    bound, by = _bound(nbytes, 4 * B * H * Sq * Skv * D, PEAK_3XTF32)
    print(f"  flash_attention without a mask{path}: 3xTF32 bound {bound:.4f} ms ({by}), "
          f"{bound / ms:.1%} of it reached")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib,
            "shape": f"f32 q ({B},{H},{Sq},{D}) k/v ({B},{HK},{Skv},{D}), no mask, per "
                     f"call{path}"}


def time_cross_step(dev, g, B, H, HK, C, D, L, path):
    """The one-token cross step at a decode path's shape, over L full cross
    caches in turn (one per cross-attention layer): the route the model
    takes (flash_decode at pos = C - 1, every slot visible) with its plain
    and SDPA times and bound (time_decode), and beside it the other route,
    flash_attention at Sq = 1 without a mask over the same caches."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    row = time_decode(dev, g, B, H, HK, C, D, L, C - 1, None, path)
    q = torch.randn(B, H, 1, D, generator=g, device=dev)
    kv = [tuple(torch.randn(B, C, HK, D, generator=g, device=dev).transpose(1, 2)
                for _ in range(2)) for _ in range(L)]
    row["fa_ms"] = cuda_ms(lambda: [fa.flash_attention(q, k, v, causal=False) for k, v in kv],
                           50) / L
    row["fa_device_ms"] = graph_ms(
        lambda: [fa.flash_attention(q, k, v, causal=False) for k, v in kv], 50) / L
    print(f"  one-token cross step{path}: flash_decode {row['ms']:.4f} ms (device "
          f"{row['device_ms']:.4f}), flash_attention at Sq = 1 {row['fa_ms']:.4f} ms (device "
          f"{row['fa_device_ms']:.4f}), SDPA {row['library_ms']:.4f} ms a call")
    return row


def time_decode(dev, g, B, H, HK, C, D, L, pos, window, path):
    """flash_decode per call at a decode path's shape, over L caches in turn
    (one per attention layer; more bytes than the 50 MB L2 holds), as the
    path reads them: its time, error, plain and SDPA time and bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.attention import slot_positions
    q = torch.randn(B, H, D, generator=g, device=dev)
    kv = [tuple(torch.randn(B, C, HK, D, generator=g, device=dev).transpose(1, 2)
                for _ in range(2)) for _ in range(L)]
    err = max((fd.flash_decode(q, k, v, pos, window=window)
               - fd.flash_decode_ref(q, k, v, pos, window=window)).abs().max().item()
              for k, v in kv)
    check(err <= FA_TOL["float32"],
          f"flash_decode at D={D}, the path shape{path}: max_abs_err={err:.3g}")

    def per_layer(fn, args):
        return lambda: [fn(*a) for a in args]

    ms = cuda_ms(per_layer(lambda k, v: fd.flash_decode(q, k, v, pos, window=window), kv),
                 50) / L
    device = graph_ms(per_layer(lambda k, v: fd.flash_decode(q, k, v, pos, window=window), kv),
                      50) / L
    p = fd.plan(B, H, HK, C, D, pos, window,
                torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"  flash_decode at D={D}{path}: {p.units * p.splits} blocks, plan {p}")
    plain = cuda_ms(per_layer(lambda k, v: fd.flash_decode_ref(q, k, v, pos, window=window),
                              kv), 10) / L
    # SDPA groups heads as h // G; k, v repeated to H heads read kv head h % HK
    held = slot_positions(pos, C, device=dev)
    visible = (held >= 0) & ((pos - held < window) if window else True)
    mask = visible.view(1, 1, 1, C)
    rep = [(k.repeat(1, H // HK, 1, 1), v.repeat(1, H // HK, 1, 1)) for k, v in kv]
    lib = cuda_ms(per_layer(lambda k, v: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask), rep), 50) / L
    n_vis = int(visible.sum())
    # q.k and p.v over the visible slots
    bound, by = _bound(4 * (2 * B * HK * n_vis * D + 2 * B * H * D), 4 * B * H * n_vis * D)
    return {"max_abs_err": err, "ms": ms, "device_ms": device, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
            "shape": f"f32 q ({B},{H},{D}) k/v ({B},{HK},{C},{D}) as (B,C,HK,D) views, "
                     f"pos {pos}, window {window}, per call, {L} caches in turn{path}"}


def _time_rglru(dev, g, B, S, W, what):
    """rglru_scan per call at (B, S, W): eager, as a CUDA graph, its plain
    version's time and its bound."""
    import torch
    from repro_torch.kernels import rglru_scan as rs
    a, gx = _rglru_inputs(B, S, W, g, dev)
    p = rs.plan(B, S, W, torch.cuda.get_device_properties(dev).multi_processor_count)
    # a and gx read once, h_seq and h_last written once; one FMA per (b, t, w)
    bound, by = _bound(4 * (3 * B * S * W + B * W), 2 * B * S * W)
    return {"ms": cuda_ms(lambda: rs.rglru_scan(a, gx), 50),
            "device_ms": graph_ms(lambda: rs.rglru_scan(a, gx), 50),
            "plain_ms": cuda_ms(lambda: rs.rglru_scan_ref(a, gx), 10),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": f"f32 a, gx ({B},{S},{W}), per call ({what}); {p.blocks} blocks of "
                     f"{p.warps} warps, {p.chunks} chunk(s) of {p.chunk} steps a tile"}


def time_rglru_scan(dev, g, err, launches):
    """rglru_scan at recurrentgemma's split path shape (the row's main
    numbers), its 2304-token prefill and a scheduler cohort, per call (one
    rec layer)."""
    split, prefill, cohort = RS_PATHS
    row = {"name": "rglru_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
           "replaces": "src/repro/kernels/rglru_scan.py:53",
           "launches": launches["rglru_scan"], "max_abs_err": err,
           **_time_rglru(dev, g, *split, "one rec layer, split path")}
    row.update(_prefixed("prefill_", _time_rglru(dev, g, *prefill, "one rec layer, prefill")))
    row.update(_prefixed("cohort_", _time_rglru(dev, g, *cohort, "one rec layer, a cohort")))
    return row


def _int_mm_ms(ops, iters):
    """``torch._int_mm`` plus the rescale over ``ops``, its rows zero-padded
    to INT_MM_MIN_M where there are fewer (it takes M > 16; the padding is
    built outside the timing), or None where it refuses a shape (K, N no
    multiples of 8)."""
    import torch
    padded = []
    for x, w, xs, ws, _ in ops:
        pad = max(INT_MM_MIN_M - x.shape[0], 0)
        padded.append((torch.cat([x, x.new_zeros(pad, x.shape[1])]),
                       w, torch.cat([xs, xs.new_zeros(pad)]), ws))
    try:
        return cuda_ms(lambda: [torch._int_mm(x, w).float() * xs[:, None] * ws[None, :]
                                for x, w, xs, ws in padded], iters)
    except RuntimeError as e:
        print(f"  torch._int_mm unavailable: {str(e).splitlines()[0]}")
        return None


def _time_qmm(dev, g, M, shapes, what, iters=20):
    """quant_matmul over ``shapes`` at M rows, as the path calls it (with
    the weights held K-major): its time a set of calls, eager and as a
    CUDA graph, its plain version's, the library call's and its bound."""
    import torch
    from repro_torch.kernels import quant_matmul as qmm
    ops = []
    for K, N in shapes:
        x, w, xs, ws = _qmm_inputs(M, K, N, g, dev)
        ops.append((x, w, xs, ws, w.t().contiguous().t()))

    def call():
        return [qmm.quant_matmul(x, wk, xs, ws) for x, _, xs, ws, wk in ops]

    err = max((o - qmm.quant_matmul_ref(*a[:4])).abs().max().item() for o, a in zip(call(), ops))
    check(err == 0.0, f"quant_matmul at {what}: bit-exact")
    bound, by = _bound(sum(M * K + K * N + 4 * M + 4 * N + 4 * M * N for K, N in shapes),
                       sum(2 * M * K * N for K, N in shapes), PEAK_INT8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = sorted({f"{p.regime} {p.tiles}x{p.splits}"
                    for p in (qmm.plan(M, N, K, sms) for K, N in shapes)})
    row = {"ms": cuda_ms(call, iters), "device_ms": graph_ms(call, iters),
           "plain_ms": cuda_ms(lambda: [qmm.quant_matmul_ref(*a[:4]) for a in ops], 5),
           "library_ms": _int_mm_ms(ops, iters), "bound_ms": bound, "bound_by": by,
           "shape": f"{what}: M={M}, (K,N) {list(shapes)}, plans {plans}"}
    if M < INT_MM_MIN_M:
        row["library_padded_m"] = INT_MM_MIN_M
        row["shape"] += f"; library_ms: torch._int_mm on rows zero-padded to M={INT_MM_MIN_M}"
    return row


def time_quant_matmul(dev, g, err, launches):
    """quant_matmul at the paths' shapes: qwen2-0.5b's layer at the split
    path's M = 4096 (the row's main numbers) and at the w8 decode step's M
    = 8 (also ``ops.quantized_dense`` there, quantize_act included),
    recurrentgemma-2b's w8 layer at M = 2048, falcon-mamba-7b's w8 head."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models.layers import Dense
    from repro_torch.quant.quantize import quantize
    fm = get_config(FM_ARCH)
    row = {"name": "quant_matmul", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
           "replaces": "src/repro/kernels/quant_matmul.py:78",
           "launches": launches["quant_matmul"], "max_abs_err": err,
           **_time_qmm(dev, g, BATCH * SEQ, QMM_LAYER, "qwen2-0.5b w8 layer, split path")}
    row.update(_prefixed("decode_", _time_qmm(dev, g, BATCH, QMM_LAYER,
                                              "qwen2-0.5b w8 layer, decode step", 50)))
    row.update(_prefixed("rg_", _time_qmm(dev, g, RG_SPLIT_BATCH * RG_SPLIT_SEQ, RG_QMM_LAYER,
                                          f"{RG_ARCH} w8 layer, split path")))
    row.update(_prefixed("head_", _time_qmm(dev, g, FM_BATCH * FM_SEQ,
                                            ((fm.d_model, fm.vocab_size),),
                                            f"{FM_ARCH} w8 lm_head, split path")))
    phi3 = get_config("phi3-medium-14b")
    m = math.prod(FAMILIES[phi3.name]["split"])
    row.update(_prefixed("phi3_", _time_qmm(dev, g, m, _dense_layer_shapes(phi3),
                                            f"{phi3.name} w8 layer, split path", 10)))
    row.update(_prefixed("phi3_head_", _time_qmm(dev, g, m, ((phi3.d_model, phi3.vocab_size),),
                                                 f"{phi3.name} w8 lm_head, split path", 10)))
    # mixtral's w8 layer is its attention's four projections (the experts
    # stay f32)
    mix = get_config("mixtral-8x22b")
    m = math.prod(FAMILIES[mix.name]["split"])
    row.update(_prefixed("mix_", _time_qmm(dev, g, m, _dense_layer_shapes(mix)[:4],
                                           f"{mix.name} w8 layer (attention), split path", 10)))
    row.update(_prefixed("mix_head_", _time_qmm(dev, g, m, ((mix.d_model, mix.vocab_size),),
                                                f"{mix.name} w8 lm_head, split path", 10)))
    # deepseek's w8 layer is MLA's wq and wo (the latent's projections and
    # the experts stay f32)
    ds = get_config("deepseek-v2-lite-16b")
    m = math.prod(FAMILIES[ds.name]["split"])
    hq = ds.n_heads * (ds.qk_nope_head_dim + ds.qk_rope_head_dim)
    row.update(_prefixed("ds_", _time_qmm(dev, g, m, ((ds.d_model, hq),
                                                      (ds.n_heads * ds.v_head_dim, ds.d_model)),
                                          f"{ds.name} w8 layer (MLA wq, wo), split path", 10)))
    row.update(_prefixed("ds_head_", _time_qmm(dev, g, m, ((ds.d_model, ds.vocab_size),),
                                               f"{ds.name} w8 lm_head, split path", 10)))
    # the cross-attention families' w8 layers and heads: llama-3.2-vision's
    # attention and MLP at its split path's 2 x 512 rows (an xattn layer
    # has the same seven shapes), whisper's decoder layer (self and cross
    # attention, the gelu MLP) at 4 x 448 rows
    vlm = get_config("llama-3.2-vision-90b")
    m = math.prod(FAMILIES[vlm.name]["split"])
    row.update(_prefixed("vlm_", _time_qmm(dev, g, m, _dense_layer_shapes(vlm),
                                           f"{vlm.name} w8 layer, split path", 5)))
    row.update(_prefixed("vlm_head_", _time_qmm(dev, g, m, ((vlm.d_model, vlm.vocab_size),),
                                                f"{vlm.name} w8 lm_head, split path", 5)))
    wh = get_config("whisper-large-v3")
    m = math.prod(FAMILIES[wh.name]["split"])
    shapes = _dense_layer_shapes(wh)
    row.update(_prefixed("wh_", _time_qmm(dev, g, m, shapes[:4] + shapes,
                                          f"{wh.name} w8 decoder layer, split path", 10)))
    row.update(_prefixed("wh_head_", _time_qmm(dev, g, m, ((wh.d_model, wh.vocab_size),),
                                               f"{wh.name} w8 lm_head, split path", 10)))
    # the decode step's projections as the model runs them: per-row
    # activation quantization (its launches) and the kernel, the leaves as
    # the model holds them, K-major
    dense = [(torch.randn(BATCH, K, generator=g, device=dev),
              Dense(quantize(torch.randn(K, N, generator=g, device=dev) * 0.02, "w8a8")).w)
             for K, N in QMM_LAYER]

    def dense_layer():
        return [kops.quantized_dense(x, w) for x, w in dense]

    row["decode_dense_ms"] = cuda_ms(dense_layer, 50)
    row["decode_dense_device_ms"] = graph_ms(dense_layer, 50)
    print(f"  quant_matmul decode layer: kernel eager {row['decode_ms']:.4f} ms, device "
          f"{row['decode_device_ms']:.4f} ms; ops.quantized_dense (quantize_act + kernel) "
          f"eager {row['decode_dense_ms']:.4f} ms, device {row['decode_dense_device_ms']:.4f} ms")
    return row


def time_mamba_scan(dev, g, err, launches):
    """mamba_scan at falcon-mamba's path shape, per call (one layer)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_scan as ms
    cfg = get_config(FM_ARCH)
    B, S, DI, N = FM_BATCH, FM_SEQ, cfg.d_inner, cfg.ssm_state
    args = _scan_inputs(B, S, DI, N, g, dev, falcon_a=True)
    kernel = cuda_ms(lambda: ms.mamba_scan(*args), 20)
    plain = cuda_ms(lambda: ms.mamba_scan_ref(*args), 1, warmup=1)
    # each input read once (u, dt, Bm, Cm, A), y and h_final written once;
    # one exp per (b, t, d, n) on the SFU (16 a clock an SM); the f32
    # arithmetic (dt*A, dA*h + (dt*u)*B, h*C and the sum over n, 6 per
    # element, and dt*u) at the CUDA-core rate is below both
    nbytes = 4 * (3 * B * S * DI + 2 * B * S * N + DI * N + B * DI * N)
    t_bytes, t_sfu = nbytes / PEAK_BYTES * 1e3, B * S * DI * N / PEAK_SFU * 1e3
    bound, by = max(t_bytes, t_sfu, B * S * DI * (6 * N + 1) / PEAK_F32 * 1e3), \
        "bytes" if t_bytes >= t_sfu else "operations"
    print(f"  mamba_scan bound: bytes {t_bytes:.4f} ms, SFU exps {t_sfu:.4f} ms "
          f"({B * S * DI * N} exps)")
    return {"name": "mamba_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan.py:69",
            "launches": launches["mamba_scan"], "max_abs_err": err,
            "ms": kernel, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
            "shape": f"f32 u, dt ({B},{S},{DI}), Bm, Cm ({B},{S},{N}) slices of a "
                     f"({B},{S},{16 + 2 * N}) tensor, A ({DI},{N}), per call (one layer)"}


def time_mamba_scan_bwd(dev, g, err, launches):
    """mamba_scan's backward kernel at falcon-mamba-7b's train shape
    (TRAIN_SCAN_BATCH x TRAIN_SCAN_SEQ, DI 8192, N 16), per call (one
    layer): eager and as a CUDA graph, beside the plain backward and its
    bound, and the forward's device time at the same shape with and without
    the chunk-start states it saves for the backward (a layer's scan costs
    the forward with states plus the backward)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba_scan as ms
    cfg = get_config(FM_ARCH)
    B, S, DI, N = TRAIN_SCAN_BATCH, TRAIN_SCAN_SEQ, cfg.d_inner, cfg.ssm_state
    u, dt, Bm, Cm, A = _scan_inputs(B, S, DI, N, g, dev, falcon_a=True)
    _, _, hc = ms.mamba_scan(u, dt, Bm, Cm, A, chunk_states=True)
    dy = torch.randn(B, S, DI, generator=g, device=dev)
    run = lambda: ms.mamba_scan_bwd(u, dt, Bm, Cm, A, hc, dy)  # noqa: E731
    kernel, dev_ms = cuda_ms(run, 20), graph_ms(run, 20)
    by_kernel = _scan_bwd_kernel_ms(ms, (u, dt, Bm, Cm, A, hc, dy))
    fwd_ms = graph_ms(lambda: ms.mamba_scan(u, dt, Bm, Cm, A), 20)
    fwd_states_ms = graph_ms(lambda: ms.mamba_scan(u, dt, Bm, Cm, A, chunk_states=True), 20)
    plain = cuda_ms(lambda: ms.mamba_scan_bwd_ref(u, dt, Bm, Cm, A, dy), 1, warmup=1)
    # read once: u, dt, dy, Bm, Cm, A; written once: du, ddt, dBm, dCm, dA.
    # The chunk-start states are left out: how many the forward saves is the
    # design's choice (its source note), and the function needs none. One
    # exp a (b, t, d, n) on the SFU; the gradient's f32 arithmetic, ~13
    # operations an element, below both
    elems = B * S * DI * N
    nbytes = 4 * (5 * B * S * DI + 4 * B * S * N + 2 * DI * N)
    t_bytes, t_sfu, t_f32 = (nbytes / PEAK_BYTES * 1e3, elems / PEAK_SFU * 1e3,
                             13 * elems / PEAK_F32 * 1e3)
    bound = max(t_bytes, t_sfu, t_f32)
    by = "bytes" if t_bytes >= max(t_sfu, t_f32) else "operations"
    print(f"  mamba_scan_bwd bound: bytes {t_bytes:.4f} ms ({nbytes / 1e6:.1f} MB; the "
          f"{hc.shape[1]} chunk states, {4 * hc.numel() / 1e6:.1f} MB, not counted), SFU exps "
          f"{t_sfu:.4f} ms, f32 arithmetic {t_f32:.4f} ms; device ms by kernel (CUDA events) "
          + ", ".join(f"{n} {t:.4f}" for n, t in by_kernel.items())
          + f"; the forward {fwd_ms:.4f} ms device, {fwd_states_ms:.4f} with the states: a "
          f"layer's scan {fwd_states_ms + dev_ms:.4f} ms")
    return {"name": "mamba_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
            "replaces": "none: no Pallas backward exists (the JAX package differentiates its "
                        "jnp scan, src/repro/models/ssm.py:60)",
            "launches": launches["mamba_scan_bwd"], "max_abs_err": err,
            "ms": kernel, "device_ms": dev_ms, "kernel_ms": by_kernel, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "fwd_device_ms": fwd_ms, "fwd_states_device_ms": fwd_states_ms,
            "shape": f"f32 u, dt, dy ({B},{S},{DI}), Bm, Cm ({B},{S},{N}) slices of a "
                     f"({B},{S},{16 + 2 * N}) tensor, A ({DI},{N}), {hc.shape[1]} chunk states, "
                     f"per call (one layer of {FM_ARCH}'s train step); max_abs_err relative to "
                     f"each gradient's largest magnitude"}


def time_rglru_scan_bwd(dev, g, err, launches):
    """rglru_scan's backward kernel at recurrentgemma-2b's train shape
    (RS_PATHS[0], 4 x 512 x 2560), per call (one rec layer): eager and as a
    CUDA graph, beside the plain backward and its bound."""
    import torch
    from repro_torch.kernels import rglru_scan as rs
    B, S, W = RS_PATHS[0]
    a, gx = _rglru_inputs(B, S, W, g, dev)
    y, _ = rs.rglru_scan(a, gx)
    dy = torch.randn(B, S, W, generator=g, device=dev)
    p = rs.bwd_plan(B, S, W, torch.cuda.get_device_properties(dev).multi_processor_count)
    run = lambda: rs.rglru_scan_bwd(a, y, dy)  # noqa: E731
    # a, h_seq and dy read once, da and dgx written once; two FMAs a (b, t, w)
    bound, by = _bound(4 * 5 * B * S * W, 4 * B * S * W)
    return {"name": "rglru_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "none: no Pallas backward exists (the JAX package differentiates its "
                        "jnp scan, src/repro/kernels/ref.py:30)",
            "launches": launches["rglru_scan_bwd"], "max_abs_err": err,
            "ms": cuda_ms(run, 50), "device_ms": graph_ms(run, 50),
            "plain_ms": cuda_ms(lambda: rs.rglru_scan_bwd_ref(a, y, dy), 3),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": f"f32 a, h_seq, dy ({B},{S},{W}), per call (one rec layer of {RG_ARCH}'s "
                     f"train step); {p.blocks} blocks of {p.warps} warps, {p.chunks} chunk(s) of "
                     f"{p.chunk} steps a tile; max_abs_err relative to each gradient's largest "
                     f"magnitude"}


def phase_bench(dev, smi, kernels):
    """12. The perf harness (``repro_torch.bench``) on the card: a matrix of
    three cases run by ``bench.runner.run``, each timed by
    ``bench.stats.timeit`` and emitted through ``runner.emit``: qwen2-0.5b's
    w8 layer through ``ops.quantized_dense`` at M = 4096, flash_attention
    through ``ops.attention_bhsd`` at qwen2's split shape (CUDA inputs, the
    timed function returns None), and ``simulate`` through the scan on the
    megafleet world cut to at most BENCH_SCAN_EPOCHS epochs. The harness's
    medians are held against phase 7's times of the same kernels (``kernels``,
    its rows); the gate and its CLI run on the records in a temporary
    directory."""
    import copy
    import tempfile
    import torch
    from repro_torch.bench import Matrix, gate_records, history, runner, stats
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import benchgate
    from repro_torch.models.layers import Dense
    from repro_torch.obs import tracemon
    from repro_torch.policies import build_policy
    from repro_torch.quant.quantize import quantize
    from repro_torch.scenarios import get_scenario
    from repro_torch.sim import FleetConfig, simulate
    t_phase = time.perf_counter()
    print(f"== 12. the perf harness on the card: {BENCH_REPS} repetitions a case, calls a "
          f"repetition {json.dumps(BENCH_CALLS)}; card {smi}")
    rows = {kern["name"]: kern for kern in kernels}
    g = torch.Generator(device=dev).manual_seed(12)
    dense = [(torch.randn(BATCH * SEQ, K, generator=g, device=dev),
              Dense(quantize(torch.randn(K, N, generator=g, device=dev) * 0.02, "w8a8")).w)
             for K, N in QMM_LAYER]
    B, H, HK, S, D, window = FA_PATHS[0]
    q = torch.randn(B, S, H, D, generator=g, device=dev).transpose(1, 2)
    k, v = (torch.randn(B, S, HK, D, generator=g, device=dev).transpose(1, 2) for _ in range(2))
    sc = get_scenario("megafleet")
    env_cfg, tables, mids, _ = sc.build_env(device=dev)
    policy = build_policy("device_only", env_cfg, tables)
    builds, epochs = {}, []

    def timed(name, fn):
        with tracemon.track_compiles() as delta:
            t = stats.timeit(fn, n=BENCH_CALLS[name], reps=BENCH_REPS)
        builds[name] = delta.get("nvcc_build_n", 0)
        runner.emit(name, t, f"n={BENCH_CALLS[name]}")

    def qmm_layer():
        return [kops.quantized_dense(x, w) for x, w in dense]

    def attention():
        kops.attention_bhsd(q, k, v, causal=True, window=window)

    def scan():
        res = simulate(env_cfg, tables, policy, sc.build_trace(),
                       n_requests=BENCH_SCAN_REQUESTS, seed=sc.seeds[0], model_ids=mids,
                       fleet=FleetConfig(slo_s=sc.slo_s, engine="scan"))
        epochs.append(res.epochs)

    m = Matrix()
    m.add(lambda: timed("quant_matmul", qmm_layer), name="quant_matmul")
    m.add(lambda: timed("flash_attention", attention), name="flash_attention")
    m.add(lambda: timed("scan", scan), name="scan")
    run = runner.run(m.cases(), echo=False)
    recs = {r["name"]: r for r in run.records}
    check(run.errors == 0 and list(recs) == ["quant_matmul", "flash_attention", "scan"]
          and all(len(r.get("samples", ())) == BENCH_REPS and 0 < r["n"] <= BENCH_REPS
                  and r["ci_lo"] <= r["median"] <= r["ci_hi"] and "error" not in r
                  and r["case"] == r["name"] for r in run.records),
          f"harness records: {BENCH_REPS} samples each (kept after outlier rejection "
          f"{ {n: r.get('n') for n, r in recs.items()} }), a median inside its bootstrap CI, "
          f"no error field, the case named")
    # the wait: a harness that timed launches would fall below the device
    # time. Phase 7 times flash_attention's call as the case makes it, and
    # quant_matmul's kernels alone; the case's layer also quantizes its
    # activations (most of its device time), so phase 12 times that layer
    # itself, as a CUDA graph and eager, and phase 7's kernel time bounds
    # it from below only
    qmm, fa = rows["quant_matmul"], rows["flash_attention"]
    layer_device_ms, layer_ms = graph_ms(qmm_layer, 20), cuda_ms(qmm_layer, 20)
    med = recs["quant_matmul"]["median"]
    check(max(0.9 * qmm["device_ms"], 0.9 * layer_device_ms) * 1e3 <= med <= 3 * layer_ms * 1e3,
          f"quant_matmul: harness median {med} us a call, at least 0.9 x phase 7's kernels "
          f"({qmm['device_ms'] * 1e3:.4g} us device) and within [0.9 x "
          f"{layer_device_ms * 1e3:.4g}, 3 x {layer_ms * 1e3:.4g}] us of the same "
          f"ops.quantized_dense layer (a CUDA graph; eager by CUDA events)")
    med = recs["flash_attention"]["median"]
    check(0.9 * fa["ms"] * 1e3 <= med <= 3 * fa["ms"] * 1e3,
          f"flash_attention: harness median {med} us a call, within [0.9 x, 3 x] phase 7's "
          f"{fa['ms'] * 1e3:.4g} us (CUDA events over 50 calls of the same call)")
    check(all(n == 0 for n in builds.values()),
          f"no nvcc build inside a timed case: {builds}")
    phases = recs["scan"].get("phases", {})
    check(all(phases.get(n, {}).get("count", 0) >= 1
              for n in ("fleet.scan", "fleet.scan.presample"))
          and "bench" not in phases and epochs and max(epochs) <= BENCH_SCAN_EPOCHS,
          f"scan case: {sc.name} cut to {BENCH_SCAN_REQUESTS} requests, {max(epochs or [0])} "
          f"epochs a run; phases folded {json.dumps(phases)}")
    fp = history.fingerprint()
    check(fp["device"] == torch.cuda.get_device_name()
          and fp["power_limit"] == smi.rsplit(", ", 1)[-1],
          f"fingerprint names the card ({fp['device']}) and its power limit "
          f"({fp['power_limit']}), as nvidia-smi printed them in phase 1")

    slow = copy.deepcopy(run.records)
    for r in slow:     # the scan case twice as slow: its samples and its spans
        if r["name"] == "scan":
            r["samples"] = [2 * x for x in r["samples"]]
            r["phases"] = {n: dict(p, total_s=2 * p["total_s"]) for n, p in r["phases"].items()}
    ref_fp = {**{key: fp[key] for key in ("host", "machine", "cpu_count", "python")},
              "jax": "none", "backend": "none", "pallas": "0"}
    with tempfile.TemporaryDirectory() as d:

        def results(name, records):
            path = os.path.join(d, name)
            with open(path, "w") as f:
                json.dump({"schema": 2, "unix_time": time.time(), "git_sha": history.git_sha(),
                           "fingerprint": fp, "rows": records}, f)
            return path

        hist = os.path.join(d, "history.jsonl")
        history.append(hist, history.stamp(run.records, run_id="phase12", t_unix=time.time(),
                                           fp=fp))
        same = gate_records(run.records, history.load(hist), fp)
        worse = gate_records(slow, history.load(hist), fp)
        foreign = gate_records(run.records, history.stamp(
            run.records, run_id="reference", t_unix=0.0, sha="reference", fp=ref_fp), fp)
        cli_same = benchgate.main([results("same.json", run.records), "--history", hist])
        cli_slow = benchgate.main([results("slow.json", slow), "--history", hist])
    status = {v.name: v.status for v in worse.verdicts}
    scan_v = next(v for v in worse.verdicts if v.name == "scan")
    check(not same.failed and {v.status for v in same.verdicts} == {"ok"} and cli_same == 0,
          f"the gate on the run's own history: {same.counts()}; the CLI exits {cli_same}")
    check(worse.failed and status == {"quant_matmul": "ok", "flash_attention": "ok",
                                      "scan": "regression"}
          and (scan_v.phase or "").startswith("fleet.scan") and cli_slow == 1,
          f"the scan case's samples and spans x 2: {status}, dominant phase {scan_v.phase} "
          f"{scan_v.phase_detail}; the CLI exits {cli_slow}")
    check(foreign.refused and {v.status for v in foreign.verdicts} == {"fingerprint_mismatch"},
          f"a history under the reference's fingerprint keys: {foreign.counts()}, refused")
    medians = {n: r["median"] for n, r in recs.items()}
    timing = {"card": smi, "medians_us": medians, "quant_matmul_layer_device_ms": layer_device_ms,
              "quant_matmul_layer_ms": layer_ms, "fingerprint": fp,
              "phase_s": time.perf_counter() - t_phase}
    print(f"  phase 12 medians (us a call): {json.dumps(medians)}; phase 7: quant_matmul "
          f"kernels {qmm['device_ms'] * 1e3:.4g} us device, {qmm['ms'] * 1e3:.4g} eager; the "
          f"quantized_dense layer {layer_device_ms * 1e3:.4g} device, {layer_ms * 1e3:.4g} eager; "
          f"flash_attention {fa['ms'] * 1e3:.4g}; fingerprint {json.dumps(fp)}; card {smi}")
    print(f"  phase 12 took {timing['phase_s']:.1f} s")
    return timing


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import repro_torch ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda", torch.cuda.current_device())
    t_start = time.perf_counter()

    smi = phase_build()
    qmm_err, ms_err, rs_err, fa_bwd_err, ms_bwd_err, rs_bwd_err = phase_kernel_checks(dev)
    cfg, model, eng, batch, launches, times = phase_main_path(dev)
    loop_launches, loop_timing = phase_closed_loop(dev, cfg, eng, batch)
    fleet_launches, fleet_timing, fleet_world = phase_fleet_loop(dev, cfg, eng, smi)
    drift_launches, drift_timing = phase_drift_loop(dev, cfg, eng, batch, fleet_world)
    cluster_launches, cluster_timing = phase_cluster_loop(dev, smi)
    scan_launches, scan_timing = phase_scan_engine(dev, smi)
    mix_launches, mix_timing = phase_mixed_fleet(dev, cfg, eng, smi)
    cli_launches, cli_timing = phase_cli(dev, smi)
    cli_mla_launches, cli_mla_timing = phase_cli(dev, smi, CLI_ARGV_MLA)
    dec_launches, dec_timing = phase_decode_serving(cfg, model, batch)
    phase_split_equals_full(cfg, model, batch)
    cpu_model = phase_card_vs_cpu(cfg, model, eng, batch)
    phase_decode_card_vs_cpu(cfg, model, cpu_model, batch)
    del cpu_model, eng, model

    families = {FM_ARCH: phase_family(dev, FM_ARCH)}   # frees its 29 GB at the end

    rg_cfg, rg_model, rg_eng, rg_launches, rg_times, rg_peak = phase_rg_split(dev)
    del rg_eng
    rg_batch, rg_dec_launches, rg_dec_timing = phase_rg_decode(dev, rg_cfg, rg_model)
    phase_rg_card_vs_cpu(dev, rg_cfg, rg_model, rg_batch)
    del rg_model
    _free()

    families.update({arch: phase_family(dev, arch) for arch in FAMILIES if arch != FM_ARCH})
    train_launches, mla_train_launches, scan_train_launches, train_timing = phase_train(dev, smi)
    fm_train, rg_train = (scan_train_launches[arch] for arch, _ in TRAIN_SCAN_ARCHS)
    shard_paths, shard_timing = phase_sharded(dev, smi)

    kernels = phase_timing(dev, qmm_err, ms_err, rs_err, fa_bwd_err, ms_bwd_err, rs_bwd_err, {
        **{k: launches[k] + loop_launches[k] + fleet_launches[k] + drift_launches[k]
           for k in launches},
        "flash_attention_bwd": train_launches["flash_attention_bwd"],
        "flash_decode": dec_launches["flash_decode"],
        "mamba_scan": families[FM_ARCH]["split"]["mamba_scan"],
        "rglru_scan": rg_launches["rglru_scan"],
        "mamba_scan_bwd": fm_train["mamba_scan_bwd"],
        "rglru_scan_bwd": rg_train["rglru_scan_bwd"]})
    paths = {f"{cfg.name} split": launches, f"{cfg.name} closed loop": loop_launches,
             f"{cfg.name} fleet loop": fleet_launches,
             f"{cfg.name} drift loop": drift_launches,
             "edge-cluster loop": cluster_launches, "megafleet scan": scan_launches,
             f"{cfg.name} decode": dec_launches,
             f"{RG_ARCH} split": rg_launches, f"{RG_ARCH} decode": rg_dec_launches,
             "mixed fleet": mix_launches, "simulate CLI (mixtral-8x22b execute)": cli_launches,
             "simulate CLI (deepseek-v2-lite-16b execute)": cli_mla_launches,
             f"{TRAIN_ARCH} train": train_launches,
             f"{TRAIN_MLA_ARCH} train (depth {TRAIN_MLA_LAYERS})": mla_train_launches,
             **{f"{arch} train (depth {layers})": scan_train_launches[arch]
                for arch, layers in TRAIN_SCAN_ARCHS}}
    for arch, d in families.items():
        paths.update({f"{arch} split": d["split"], f"{arch} decode": d["decode"]})
    paths.update(shard_paths)
    for kern in kernels:
        kern["launches_by_path"] = {p: n.get(kern["name"], 0) for p, n in paths.items()}
    bench_timing = phase_bench(dev, smi, kernels)

    print(f"{cfg.name} per-infer ms (median of 3), {BATCH} x {SEQ} tokens: " + json.dumps(
        {k: statistics.median(v) for k, v in times.items()}))
    print(f"{cfg.name} closed loop: " + json.dumps(loop_timing))
    print(f"{cfg.name} fleet loop: " + json.dumps(fleet_timing))
    print(f"{cfg.name} drift loop: " + json.dumps(drift_timing))
    print("edge-cluster loop: " + json.dumps(cluster_timing))
    print("scan engine: " + json.dumps(scan_timing))
    print(f"{cfg.name} decode serving: " + json.dumps(dec_timing))
    print(f"{RG_ARCH} per-infer ms (median of 3), {RG_SPLIT_BATCH} x {RG_SPLIT_SEQ} tokens: "
          + json.dumps({k: statistics.median(v) for k, v in rg_times.items()}))
    print(f"{RG_ARCH} decode serving: " + json.dumps(rg_dec_timing))
    print(f"{RG_ARCH} peak device memory: {rg_peak} bytes")
    print("mixed fleet: " + json.dumps(mix_timing))
    print("simulate CLI: " + json.dumps(cli_timing))
    print("simulate CLI (deepseek-v2-lite-16b): " + json.dumps(cli_mla_timing))
    print(f"{TRAIN_ARCH} training: " + json.dumps(train_timing))
    print("shardings and the dry run: " + json.dumps(shard_timing))
    print("perf harness: " + json.dumps(bench_timing))
    for arch, d in families.items():
        B, S = FAMILIES[arch]["split"]
        print(f"{arch} per-infer ms (median of 3), {B} x {S} tokens: " + json.dumps(
            {k: statistics.median(v) for k, v in d["times"].items()}))
        print(f"{arch} decode serving: " + json.dumps(d["decode_timing"]))
        print(f"{arch} peak device memory: {d['peak']} bytes; phase {d['seconds']:.1f} s")
        if d["profiles"]:
            print(f"{arch} split infer profiles: " + json.dumps(d["profiles"]))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
