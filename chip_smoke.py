"""Smoke test of the PyTorch port on one NVIDIA card (H100, sm_90a).

Run from the root of a checkout on a machine with a card and the CUDA
toolkit::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version, drives the main paths of the
port on a full-width Llama-1B — the paged serving engine, the causal-LM
trainer (and under its options: schedules, clipping, accumulation, EMA,
the bf16 update rules, the callbacks), the trainer at long context (S 8192, block remat, the
two-sweep flash backward), KV-cache decoding through ``generate`` (with
a sliding-window ring cache), the resident-row serving engine,
speculative serving and decoding (n-gram drafts and a draft model),
multi-tenant serving (LoRA adapters and grammar constraints), and fault
recovery, preemption, the host KV tier, sliced prefill, drain/restore
and request tracing in the engine — on a
full-width, full-depth ResNet-50, the reference's own workload (and its
trainer's fault recovery, verified checkpoints, resume and prefetch; its
pretrained mode from Keras weights, trained from packed files through
the native loader), on
GPT-2-small (training, ``generate``, both engines, speculation), on
ResNet-50 under the reference's distribution modes (world size 1 on
NCCL, and two processes sharing the card over gloo), on
int8 weights (Llama-1B and GPT-2-small served through
``param_transform=dequantize``), on ViT-S/16 (training), and under
tensor, expert, sequence and pipeline parallelism (two processes sharing
the card over gloo), and prints one line per phase:

1. device — ``nvidia-smi``'s card name and power limit;
2. build — every kernel compiled by ``nvcc``, one process per source, all
   started together (seconds);
3. paged_decode vs plain — max-abs error at Llama-1B's decode shape
   (bf16 and f32, with and without a window), an odd shape (rep 3,
   D 128), the CPU tests' tiny shape, and the edges of K4's split of the
   table: depths at a split boundary and one past it, a window across
   it, a table far wider than the rows, rep 1 and rep 8, D 256 with bs
   64, table entries outside [0, N), GPT-2-small's tick (H 12/12, rep
   1); two runs bitwise equal at the Llama-1B shape; then the kernel's
   time, the plain version's, an SDPA yardstick's and the bound, on CUDA
   events, at four shapes (mixed depths, the engine's steady tick, one
   row at depth 4095, GPT-2-small's tick at mixed depths);
4. flash_fwd vs plain — K1 with and without its LSE write at Llama-1B's
   training shape (B 4, H 32/8, S 2048, D 64, bf16, causal), with a
   512 window, MHA, rep 3 at D 128, a ragged S of 1000, offset keys, f32,
   and the edges of the bf16 kernel's tiles (S 129, no mask with Sq 200 x
   Sk 136, a window of 6) and of the kv sweep's 128-key blocks (S 257,
   with and without a window of 12), and at the GPT-2-small (B 8, H 12/12,
   S 1024, causal) and ViT-S/16 (B 256, H 6/6, S 196, non-causal) train
   shapes; two K1 runs bitwise equal (remat relies on it);
   then times and bound at the Llama-1B shape (SDPA the yardstick), and
   K1's and K2's at the GPT and ViT shapes (``flash_new_shapes_time``);
5. flash_bwd vs plain — K2's dq, dk, dv at the same shapes (two of them
   with an LSE cotangent too), relative to each gradient's max-abs; two K2
   runs' dk and dv bitwise equal at Llama-1B's shape; then times and bound
   (SDPA forward+backward minus forward the yardstick);
5b. flash_bwd_two_sweep vs plain — K3a's dq and K3b's dk, dv at
   Llama-1B's long shape (B 1, H 32/8, S 8192, D 64, bf16, causal: 8 MiB
   of fused dq accumulator, so the branch by the JAX package's test) and
   at K2's odd shapes with the test's threshold at 0; K3 against K2 at the
   long shape; two runs bitwise equal there: K3a's dq, K3b's and K2's dk
   and dv; then the times of K3a, K3b,
   their wrapper, K2 at the same shape, SDPA's backward and the plain
   version, K1 with and without its LSE beside SDPA's forward, and the
   bounds;
6. engine parity — full-width Llama-1B at depth 2 in f32 (TF32 off), one
   seeded weight set in an engine on the card (kernel) and one on the
   CPU (plain version), 4 greedy requests x 16 tokens, token-exact
   unless the CPU's top-2 logit margin at the divergence is < 1e-3 (a
   tie);
7. engine serve — full-width, full-depth Llama-1B in bf16, 24 requests
   of 384 prompt tokens (256 shared) x 32 new tokens on 8 slots:
   tokens/s, TTFT p50, peak device memory (the serving path's launches);
8. train parity — full-width Llama-1B at depth 2 in f32 (TF32 off), one
   seeded weight set trained by the port's Trainer on the card (kernels)
   and on the CPU (plain versions), 1 adamw step (losses within rtol
   1e-4, parameters within 2·lr·steps), then 1 sgd step (losses within
   rtol 1e-5, each parameter's last-step gradient within 1e-3 of its
   max-abs: the check that holds K2's gradients on the training path),
   then 1 sgd step with ``remat="dots"`` and the backward's threshold at
   0 on both sides (the same check for K3a, K3b and remat);
9. train converge — a width-64 tiny Llama with flash attention learns
   the synthetic next-token task on the card (last loss < 0.7 x first);
10. train step — full-width, full-depth Llama-1B, bf16 compute over f32
    parameters, adamw, B 4 x S 2048: 2 warm-up then 5 timed steps through
    ``Trainer.fit`` and one ``evaluate`` batch: tokens/s, ms/step, 6ND
    MFU, peak device memory, the losses, and the launches of each flash
    kernel (the training path's launches);
11. train long — the same model with ``remat="dots"`` at B 1 x S 8192:
    2 warm-up then 5 timed steps through ``Trainer.fit``, the same
    figures, and per step 16 K3a, 16 K3b, no K2 and 32 K1 with the LSE
    (16 in the forward, 16 in the remat recompute) — the long-context
    path's launches;
12. fused loss — full-width Llama-1B at depth 2, B 1 x S 8192, one
    forward+backward through ``fused_lm_loss`` against one through the
    materialized logits and the trainer's cross-entropy: the losses'
    relative difference (within 2e-3), each parameter gradient's error
    relative to its max-abs (within 2e-2: bf16 logits there, f32 here),
    the ms and the peak device memory of each;
13. resnet parity — full-width, full-depth ResNet-50 in f32 (TF32 off,
    ``torch.backends.cudnn.benchmark`` False), one seeded weight set
    trained by the port's Trainer on the card (cuDNN) and on the CPU with
    SGD at lr 0.005 and the gradient norm logged, B 4 x 224, for each
    stem: 1 free-running step (gated: a BatchNorm net at init parts the
    two sides' free runs after it), then 2 steps each from
    the CPU's state copied to the card: losses within rtol 1e-4, gradient
    norms within 1e-3 relative, parameters within 2·lr·steps, each
    BatchNorm buffer within 1e-4 of its max-abs;
14. resnet converge — ``tiny_resnet`` through ``Trainer.fit`` on synthetic
    32x32 images with ``standard_augment(crop=32)``,
    ``standard_eval_transform(crop=32)``, validation data,
    ``ReduceLROnPlateau`` and ``EarlyStopping`` (last loss < 0.7 x
    first);
15. resnet train — ``bench.py``'s step through ``Trainer.train_step`` on a
    batch resident on the card: ResNet-50, bf16 compute over f32
    parameters, BatchNorm in train mode, adam at 1e-3, B 256 x 224, with
    ``torch.backends.cudnn.benchmark`` True: 2 warm-up then 10 timed
    steps with the Keras stem, then 3 warm-up and 20 timed steps with the
    space-to-depth stem (bench.py's default): images/s, ms/step, peak
    device memory, the last loss, the forward's multiply-accumulates per
    image (from the model's conv and dense shapes) and the MFU of
    6 x MACs per image;
15e. keras roundtrip — the reference's pretrained mode through the
    mapping layer of ``ckpt/keras_import.py`` (no h5py on the card):
    ResNet-50 f32 (TF32 off, cuDNN deterministic), a seeded model's Keras
    weight dict into a model of another seed (state_dicts and eval logits
    on 8 x 224 bitwise equal), into a space-to-depth model (logits within
    1e-4 of the largest) and, without ``predictions``, into a 10-class
    model (backbone equal, head kept; ``require_head=True`` raises): the
    export and load ms, no kernel launched;
15f. native loader — the loader's library built from
    ``pddl_tpu_torch/data/csrc/`` with the host compiler (seconds, path),
    a seeded packed file of 2,048 x 224 x 224 x 3 uint8 (308 MB) under
    ``build/``, one shuffled epoch holding every sample once with the
    file's bytes and labels, then an epoch's read time (warm);
15g. resnet host fed — phase 15's space-to-depth step (bf16, adam, B 256)
    on notop Keras weights with a fresh head, through ``Trainer.fit`` from
    the ``NativeLoader`` at ``prefetch`` 0 and 2 in turns: images/s, the
    step wall, the losses, the device's idle share (a profiled epoch's,
    and the steady step's), beside phase 15's card-resident images/s; no
    kernel launched; the file is deleted and every loader closed;
15b. dp parity — the reference's distribution modes at world size 1 on
    NCCL (a process group of one over the card): full-width ResNet-50 in
    f32 (TF32 off, cuDNN deterministic), B 32 x 224, 3 SGD steps and 1
    Adam step through ``Trainer.fit`` under ``single``, ``mirrored``,
    ``multiworker``, ``ps`` (min 256 KiB) and the hvd workflow
    (``DistributedOptimizer``, broadcast, metric-average and warmup
    callbacks), each bitwise ``strategy=None`` in its losses, parameters
    and BatchNorm buffers;
15c. dp parity gloo2 — two processes on the one card joined over gloo
    with CUDA tensors (``--dp-gloo2-child``), mirrored and ps at 2 x 16
    rows against the single-device step at 32 rows (1 SGD, 1 Adam step):
    the loss, gradient norm, parameter and buffer errors against their
    stated tolerances, both processes' states equal, ps's optimizer-state
    bytes a process against mirrored's and its capped leaves;
15h. dp ckpt gloo2 — checkpoints of a strategy over processes: phase
    15c's two processes (``ps``, ResNet-50 f32, cuDNN deterministic,
    adam, 2 x 16 rows) run 4 steps, then 2 under ``CheckpointEveryN``
    (rank 0 writes one world-size free save at step 2, the Adam slices
    gathered whole); fresh processes (``--dp-ckpt-child``) resume it to
    step 4, each process's state bitwise the uninterrupted run's; the same
    save restores into this one process (moments whole, the state as
    saved) and 2 more steps land within 3·lr a step of ``strategy=None``'s
    4: the save's MB, the runs' seconds, the restore's ms;
15d. dp train — phase 15's space-to-depth step under ``mirrored`` at
    world size 1 beside ``strategy=None`` in turns: images/s of each and
    their ratio (a record);
15i. hf llama roundtrip — full Llama-1B (bf16) through ``export_hf_llama``
    (``LlamaForCausalLM`` keys, f32 numpy, no ``transformers`` here) and
    ``load_hf_llama`` into a model of another seed: state_dicts bitwise;
    the imported model's paged engine (K4 once a layer a tick) emits the
    source model's tokens for phase 6's 4 requests x 16; export and
    import ms, host bytes;
15j. k1 op cost — K1 with the LSE at the decode artifacts' ring prefill
    and at phase 10's shape, three ways in turns: the eager
    ``flash_forward`` (a direct ``ctypes`` launch), the ``torch.library``
    op ``pddl_tpu_torch::flash_fwd`` that exported programs call, and the
    wrapper as before the registration: the outputs bitwise equal, ms a
    call each;
15k. export artifacts — ``ckpt/export.py`` on the card: ResNet-50 (f32,
    eval, B 8 x 224) as an inference artifact exported on the card
    (logits within 1e-6 of the largest) and on the CPU listing the card,
    moved at load (within 1e-4); Llama-1B decode artifacts at depth 2
    (bf16, B 2, prompt 128, 32 new, greedy), full and sliding-window (window 1024,
    ``max_len`` 4096): tokens equal to ``generate``'s (the bf16 tie rule),
    the zip's bytes against the weights', export, load, prefill and
    decode ms, and the windowed prefill launching K1 once a layer through
    the op;
16. generate parity — ``generate`` on the card against the CPU, greedy,
    full-width Llama-1B at depth 2 in f32 (TF32 off): a full-length cache
    (B 2, prompt 64, 32 new) and a sliding window of 256 (ring 256 under
    ``max_len`` 1024; B 1, prompt 384, 64 new: the ring wraps in the
    prefill and in decode, and the prefill runs K1 with its LSE on the
    card, once a layer); token-exact unless a tie, as in phase 6;
17. generate decode — ``benchmarks/decode_bench.py``'s configuration
    (full Llama-1B, vocab 128256, ``max_len`` 1024, bf16, prompt 64,
    greedy; 64 new, the bench's 256 cut for time) at B 1 and B 8: new
    tokens/s, ms per token, peak device
    memory, and at B 1 the weight-read bound (the weights' bytes and the
    live K/V over HBM bandwidth) and the ratio to it; no hand-written
    kernel runs there;
17b. generate spec — phase 17's B 1 leg (same model and prompt) through
    ``generate_speculative`` (``draft_len`` 7, ``ngram`` 3) beside that
    leg's ``generate``: tokens/s, ms per token, ticks, tokens per tick;
    tokens equal unless a tie (the card's top-2 margin at the divergence
    under 8 bf16 ulps of the top logit);
18. generate swa — a sliding-window Llama-1B (window 1024, ``max_len``
    4096), bf16, B 1, prompt 2048, 128 new: tokens/s, the prefill's wall,
    16 K1 launches with the LSE in the run (the sliding-window path's
    launches), the ring's cache bytes against a full-length cache's; K1
    at this shape against its plain version, with its times and bound;
19. engine row parity — phase 6's wave through ``ServeEngine(paged=False)``
    with the prefix cache on and at ``prefix_cache_blocks=0``;
20. engine row serve — phase 7's wave through ``ServeEngine(paged=False)``
    (run right after phase 7, on its model):
    tokens/s, TTFT, the tick, the prefix cache's gather and donation
    copy bytes and ``resident_kv_report`` beside the paged engine's; no
    hand-written kernel runs there;
21. engine spec serve — phase 7's wave with 32 new tokens through the
    row and paged engines at ``spec_k`` 0 and 4 and the paged engine with
    a depth-2 self-draft (the model's embedding, first 2 blocks, final
    norm and head): tokens/s, TTFT, the decode tick, tokens per tick and
    per slot window, the acceptance rate, the streams equal to
    ``spec_k=0``'s and the top-2 margins where they part (no speed gate);
    K4 launched exactly 2 x 5 times a window on the draft leg (the draft
    model's single-token steps), never on the n-gram legs (the verify is
    multi-token);
22. engine spec parity — speculative serving, ``spec_k`` 4, greedy,
    full-width Llama-1B at depth 1 in f32 (TF32 off, ``max_len`` 304):
    4 repetitive prompts x 48 new tokens, one of them ending at
    ``max_len`` (its windows reach past the cache), on the row engine,
    the paged engine with n-gram drafts and the paged engine with a
    depth-1 self-draft: card against CPU and against the card's
    ``spec_k=0`` engine, token-exact unless a tie as in phase 6, the
    acceptance counters, K4's launches; then ``generate_speculative``
    against ``generate`` at B 2 (and the CPU);
23. engine tenant serve — phase 7's wave in both modes, ``tenant=None``
    and ``tenant=TenantConfig(...)`` one wave each: 16 rank-8 LoRA adapters
    (``register_random``, seeds 100-115, scale 0.05) on a pool
    auto-sized to 12 rows, every 4th request on the base model and the
    rest on 4 popular adapters and a tail of 12, every 3rd request under
    a JSON schema over a seeded 128,256-string grammar vocabulary (the
    FSM's states and compile seconds, compiled before the waves):
    tokens/s, TTFT p50/p99, the tick's p50 and its ratio to the plain
    tick (over the two waves, and over 48 ticks of each engine in
    turns: ``engine_tenant_cost``), adapter hits, loads and evictions, mask restages a tick, the pool's and a tick's
    gathered factor bytes, K4 exactly once a layer a tick on the paged
    legs; then a profiled window of 4 ticks of each engine a mode
    (``profile_plain_*``, ``profile_tenant_*``): device busy, idle share
    and the LoRA delta's device time a tick;
24. engine tenant parity — multi-tenant serving card against CPU,
    Llama-1B width at depth 2 in f32 (TF32 off), phase 6's prompts as a
    base request, an adapter, an adapter under a bounded JSON schema and
    the schema alone, both modes: token-exact unless a tie under the
    slot's adapter and mask, the base slot's logits bitwise equal to the
    card's ``tenant=None`` engine's, the adapter stream equal to
    ``generate`` over the merged head, the constrained streams complete
    (GRAMMAR, accepted), a ``spec_k=4`` leg equal to ``spec_k=0``, K4
    exactly once a layer a tick on the paged leg;
25. gpt parity — GPT-2-small width at depth 2 in f32 (TF32 off), card
    against CPU: 3 adamw ``Trainer`` steps (losses within rtol 1e-4,
    parameters within 2·lr·steps, K1 and K2 once a layer a step),
    ``generate`` (B 4, prompt 64) and both engine modes on phase 6's
    prompts x 16 tokens (token-exact unless a tie; K4 once a layer a paged
    tick), and ``spec_k=4`` n-gram legs in both modes at ``max_len`` 304,
    one stream ending there, against the CPU and ``spec_k=0``;
26. gpt serve — full GPT-2-small (HF ``gpt2``'s configuration: 768 wide,
    12 layers, 12 heads, 1024 positions, LayerNorm eps 1e-5, vocabulary
    50257 padded to 50304), bf16, seeded weights: phase 7's wave on the
    row and the paged engine (tokens/s, TTFT p50/p99, tick p50, K4 once a
    layer a paged tick), then ``generate`` at B 1, prompt 64, 128 new
    against the weight-read bound (``gpt_generate``);
27. gpt train — the same model, bf16 compute over f32 parameters, adamw,
    B 8 x S 1024 through ``Trainer.fit``: 2 warm-up then 5 timed steps;
    tokens/s, ms a step, 6ND MFU (N the blocks and the LM head's weight,
    123.7 M), peak memory, exactly 12 K1 and 12 K2 a step;
28. int8 serve — Llama-1B and GPT-2-small in bf16 with
    ``quantize_int8(min_elems=65536)`` and ``param_transform=dequantize``:
    ``quantized_bytes`` against the dense tree and the ``memory_allocated``
    the model and a paged engine on it add, int8 against bf16
    (``int8_memory``: the int8 model within 1% of its tree, the saving at
    least 95% of the trees' difference); the serve wave on both engines,
    bf16 and int8 in turns (each wave's peak less the other model's bytes,
    int8's no higher than bf16's); the tick's p50 ratio and B 1 ``generate``
    (prompt 64, 64 new) int8 against bf16 (``int8_cost``);
29. int8 parity — depth 2 in f32 on both widths: the card's int8 tree
    bitwise the CPU's; the paged int8 engine card against CPU
    (token-exact unless a tie) and equal to the card's engine over the
    dense dequantized weights; on Llama a tenant leg (two adapters) under
    int8, card against CPU; K4 once a layer a tick;
30. vit — ViT-S/16 (1000 classes): at depth 2 in f32, B 4 x 224, the eval
    logits card against CPU within 1e-4 and 3 adam steps (losses within
    rtol 1e-4, parameters within 2·lr·steps); then bf16 compute over f32
    parameters, adam, B 256 x 224 on a batch resident on the card through
    ``Trainer.train_step``, 2 warm-up and 10 timed steps: images/s, MFU of
    6 x the forward's MACs, exactly 12 non-causal K1 and 12 K2 a step;
30b. train options parity — the trainer's options card against the
    port's CPU run, f32 with TF32 off: every schedule name with and without
    warmup (the rate at each step equal), Llama-1B width at depth 2 under
    a cosine schedule, a clip at 1.0, 2-step accumulation and an EMA at 0.9
    (4 micro-steps, then eval on the shadows: losses within rtol 1e-4,
    parameters and shadows within 2·lr·updates), 2 x B 2 accumulated
    against one B 4 step on the card (sgd, the updates within 1e-3 of the
    largest, the train parity legs' gradient tolerance), bf16 storage (f32 moments under ``plain``, ``f32_master``'s
    stored parameters exactly the cast of the master) and
    ``stochastic_round`` on the card (on the two bf16 neighbours, the mean
    of 4,096 draws within 4 sigma, bitwise the CPU's rounding given the
    bits);
30c. train options step — phase 10's model and tokens a step (B 4 x S 2048
    as 2 x B 2 micro-batches) under warmup_cosine, a clip at 1.0, an EMA at
    0.999 and the CSVLogger, TensorBoard, Timing and ModelSummary
    callbacks, bf16 storage under ``plain``, ``stochastic_round`` and
    ``f32_master`` in turns beside f32 storage: tokens/s, ms an update,
    peak memory, optimizer-state, EMA and total bytes a parameter, exactly
    depth x 2 K1 and K2 an update;
30d. train resilience — ResNet-50 f32, B 32, cuDNN deterministic, adam, 8
    steps with a verified save every 2: a transient retried in place,
    spent retries (restore and replay), an injected OOM, a torn newest save
    (the previous one restored, 3 steps replayed) and a child process
    SIGKILLed at step 5 then ``fit(resume=)``, each bitwise the clean run
    in the losses and every leaf of ``Trainer.state_dict()``; each save's
    MB, ms and GB/s and a restore's ms; host-fed images/s of phase 15's
    step at B 64 (cuDNN's search off) with ``prefetch`` 0 and 2 in turns;
31. engine fault parity — fault recovery card against CPU, Llama-1B width
    at depth 2 in f32 (TF32 off), phase 6's prompts x 16: a scheduled tick
    exhaustion (every live slot replays) in both modes, an OOM at the
    first donation (degraded, flushed, re-armed under a fake clock), a
    seeded mixed plan with a verify exhaustion at ``spec_k`` 4 (the forced
    re-feeds), a tenant leg and a preemption leg: the injections equal card
    against CPU, the streams token-exact card against CPU and equal to the
    fault-free engine's unless a tie, K4 exactly 2 x the paged ticks;
32. engine fault serve — phase 7's wave in both modes fault-free, under a
    seeded plan (transient, OOM and latency faults with the real backoff),
    under a tick exhaustion at step 6 and with a real
    ``torch.OutOfMemoryError`` from the allocator: the injections by kind,
    retries, replays, degraded entries, tokens/s and TTFT p99 against
    fault-free, the streams equal unless a bf16 tie (8 ulps), the K4
    launches beyond the fault-free wave's;
33. host tier serve — 32 distinct 384-token prompts in 2 rounds of 16 new
    through pools too small for them (paged: 514 blocks; row: 193) over a
    512 MiB host tier: spills, hits, promotions, each promotion's bytes,
    ms (CUDA events) and GB/s, the demotion's host ms, the TTFT p50 of
    round 2 against the untiered engine (recompute), the streams equal
    to a pool that holds every chain unless a bf16 tie;
34. engine preempt serve — 8 best-effort serve prompts x 128 new, then 8
    interactive 64-token prompts x 32 after 4 steps, at ``preempt_cap`` 2,
    then 0: the interactive TTFT p50/p99, the best-effort
    completion wall, preemptions, the best-effort streams equal;
35. engine drain restore — phase 7's wave drained at step 10 to a file
    under ``build/`` and restored into a fresh engine (row, paged,
    ``spec_k=4`` n-gram, a row snapshot into a paged engine): the
    snapshot's bytes, the drain's ms, the restore's seconds to the first
    resumed token, every request finished, the tokens streamed before the
    drain kept, the streams equal to the undrained wave's (bf16 tie rule),
    K4 once a layer a paged restore tick; then an f32 depth-2 leg
    token-exact against the undrained engine and the CPU's restore;
36. engine trace serve — phase 7's wave on the paged engine with a
    ``RequestTracer`` and with ``NULL_TRACER`` in turns: the tokens/s and
    tick p50 ratios, 24 finished spans holding their streams' tokens; the
    f32 depth-2 run's span events per request equal to the CPU's;
37. engine slice serve — Llama-1B bf16 at ``max_len`` 8192, ``prefill_len``
    4096: 7 streams of 384 prompt tokens x 96 new and a cold 4096-token
    prompt at step 16, with ``prefill_slice_tokens`` 512 and ``None`` in
    both modes: the running streams' largest gap between tokens during
    the cold admission and its p99, the cold TTFT, tokens/s, K4's
    launches, the streams equal (bf16 tie rule);
38. engine slice parity — sliced prefill card against CPU, Llama-1B width
    at depth 2 in f32 (TF32 off), phase 6's prompts at
    ``prefill_slice_tokens=8``: row, paged, ``spec_k=4`` with a depth-1
    draft model (its tree sliced in lockstep) and a tenant engine;
    token-exact against the CPU and against whole-prompt admission, K4
    exactly 2 x the paged ticks (the draft leg: its draft steps);
38b. tp ep gloo2 — tensor and expert parallelism, two processes sharing
    the card over gloo (``--tp-gloo2-child``), f32 with TF32 off:
    ``tp_parity_gloo2``, full-width, full-depth Llama-1B at B 1 x S 1024
    under ``TensorParallelStrategy(2, rules=LLAMA_TP_RULES)`` (16 query
    and 4 KV heads a process: K1/K2 at H 16/4), one SGD step against one
    process's (loss within 1e-4 relative, gradient norm within 1e-3, every
    local block within 2·lr), each process's parameter bytes, the
    collectives a step as counted; ``tp_decode_gloo2``, ``generate`` B 2 x
    prompt 128 x 16 new and ``generate_speculative`` under TP2
    token-exact with one process's ``generate`` (the tie rule of phase
    6), the top-2 margin, ms a token of each; ``ep_parity_gloo2``, the
    routed Llama (8 experts, top-2, every 4th block from the back) at
    depth 8 under ``ExpertParallelStrategy(2, rules=LLAMA_EP_RULES)``
    (4 experts a process) with the same gates and the expert bytes a
    process; (the TP-local K1/K2 shape is held to its plain version and
    timed among phases 4–5: ``tp_kernels``)
38c. moe parity — the routed Llama at Llama-1B's width and depth 4, f32,
    card against CPU: block 3's router choices, kept set and queue
    positions exact (or ties), eval logits within 1e-4, one SGD step's
    loss within rtol 1e-5 and gradients within 1e-3 of their max-abs;
38d. mixtral roundtrip — that model through ``export_hf_llama`` and
    ``load_hf_mixtral`` bitwise (the router's bias aside: Mixtral has
    none);
38e. moe train — the routed Llama at full depth (2.91 B parameters),
    bf16 compute over f32 parameters, adamw, B 2 x S 2048: tokens/s, MFU
    over the parameters a token meets, losses, ``moe_drop_rate``, the aux
    loss, peak memory, K1/K2 once a layer a step;
38f. sp kernels — K1 with its LSE and K2 with an LSE cotangent at a
    ring rotation's shapes for Llama-1B at seq 2 (B 1, H 32/8, Sq = Sk =
    4096, D 64, bf16): the diagonal (causal), a past shard (no mask) and
    a windowed rotation (window 4096, ``k_offset`` -4096), each against
    its plain version and timed beside it, SDPA and the bound over the
    pairs its mask keeps;
38g. sp parity gloo2 — sequence parallelism, two processes sharing the
    card over gloo (``--sp-pp-gloo2-child``), f32 with TF32 off: a
    mirrored strategy over a ``data`` 1 x ``seq`` 2 mesh, one SGD step of
    Llama-1B's width at depth 2, B 1 x S 2048, ``ring_flash`` and
    ``ring``, with and without a window of 512, and of ViT-S/16 at depth 2
    under ``ring_flash``, against one process (attention ``flash``) from
    the same weights drawn on the card, with phase 38b's gates on the
    loss and gradient norm and each part's parameters within 1e-3 of its
    update plus two f32 ulps; K1/K2
    launches by rank (rank 0's later shard has weight 0 and runs none);
38h. sp train gloo2 — full Llama-1B, bf16 compute over f32 parameters,
    ``remat="dots"``, ``ring_flash`` over seq 2 at B 1 x S 8192 (4096
    tokens a process), adamw, 1 warm-up and 2 timed steps: tokens/s, s a
    step and each process's peak memory beside ``train_long``'s, the
    ring's hops and bytes a step, K1/K2 launches;
38i. pp parity gloo2 — ``GPipeLlama`` at Llama-1B's widths and
    ``GPipeViT`` at ViT-S/16's, 2 stages x 1 block, M 2, f32, attention
    ``flash``, one SGD step under ``PipelineStrategy(2)`` against one
    process's ``apply_sequential`` (built whole on the mesh's
    ``shape_only`` record): the gates of 38b on the loss and the gradient
    norm, each part's parameters (embed, each stage, head) within 1e-3 of
    its update plus two f32 ulps; each process lays out its stage only;
38j. pp train gloo2 — ``GPipeLlama`` at full Llama-1B (2 stages x 8
    blocks), bf16 compute over f32 parameters, ``flash``, adamw at B 4 x
    S 2048 and M 2 and M 4: tokens/s, s a step, parameter bytes, the
    bytes each process's construction lays out (its stage only) and peak
    memory a process, the activation hops, the share of the step each
    stage's host is blocked in the schedule, and each process's device
    idle share (one more step under ``torch.profiler``: 1 - its kernel
    time over the timed step wall) beside the bubble (S-1)/(M+S-1);
38k. fleet local — the serving fleet in one process: a ``FleetRouter``
    over two ``LocalReplica``s, each a paged engine of full-width
    GPT-2-small in f32 built by the fleet worker's ``build_engine``
    (vocab 50257, ``max_len`` 1024, 768 wide, 12 layers and heads, a 256
    MiB host tier, blocks of 8), serving phase 7's wave (24 prompts of
    384 tokens, 256 shared, x 32 new, greedy, 8 slots a replica): the
    streams token-equal to one engine's (the tie rule), K4 exactly 12 x
    the ticks summed over the replicas, fleet tokens/s and TTFT p50/p99;
    then one chain pull — a new prefix exported from the replica that
    holds it and imported into the other's host tier: the chain's bytes,
    export and import ms and GB/s, the next request there token-equal
    and K4 on its promoted ticks;
38l. fleet process — the same wave through two port worker processes
    time-sharing the card (framed transport, ``device`` the card): the
    spawn-to-ready seconds, fleet tokens/s, TTFT p50/p99, every
    replica's census (``compile_counts``) all 1 after the wave; a SIGTERM
    drain of one worker mid-wave restored on the survivor (the drain's
    ms, the restore's seconds to the first resumed token); a SIGKILL of
    one worker mid-wave replayed from the router's mirrors (replays);
    then one chaos campaign over two workers (a storage storm, a hard
    kill and a router crash with journal recovery), every invariant
    held; every stream token-exact against one in-process engine (the
    tie rule; the campaign's check is exact). Two processes sharing one
    card, not a multi-card fleet;
39. kernels — one JSON object: every ported kernel with its launches on
    its main paths (phases 7, 10, 11, 15i, 15k, 18, 21, 23, 26, 27, 28,
    30, 30c, 32-34, 35-37, 38b, 38e and 38k;
    K4's, K1's and K2's by path under ``launches_by_path``, the parity
    legs' included there for K4), error, times and bound (K3b's
    library time is SDPA's backward, which computes dq, dk and dv, as
    ``library_computes`` says; other timing shapes under ``shapes``: K4's
    and, for K1 and K2, the GPT and ViT train shapes, one TP2 process's
    Llama-1B heads and the ring rotation's three shapes; the sequence-
    and pipeline-parallel paths of 38g-38j under ``launches_by_path``,
    both processes' launches summed); the ResNet path,
    the Keras import and export and the loader add none (the JAX package
    runs no Pallas kernel there);

Phases 21, 23, 28 and 32-37 serve full-width models cut to depth 4
(``SERVE_DEPTH``; GPT-2-small's too in phase 28): their ticks are
host-bound, and the script has a time limit. Phase 7 and 20 serve the
full depth.

and, as its last line, ``{"ok": true, "device": {...}}``. Any failure
raises: the script exits non-zero and prints no result. It needs the
repository beside it and a card (``torch.cuda.is_available()``).
``--profile DIR`` adds a profiled decode window after phase 7, one
profiled train step after each of phases 10, 11 and 15 (the last with
its device time by kernel class: convolutions, BatchNorm, elementwise
ops and casts, adam, ...), one profiled B 1 ``generate`` of 64 tokens
in phase 17 (its idle share), a profiled window of the row engine's
ticks after phase 20 and of two speculative engines' ticks after phase
21 (row with n-gram drafts; paged with the depth-2 self-draft), and
writes their kernel tables to DIR. Phase 23's profiled tenant windows
run with or without it; their tables go to DIR, or to
``build/profiles``.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import copy
import gc
import itertools
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

import pddl_tpu_torch.compat.hvd as hvd
import pddl_tpu_torch.serve.engine as engine_mod
from pddl_tpu_torch.data.synthetic import (
    SyntheticImageClassification,
    SyntheticLanguageModeling,
)
from pddl_tpu_torch.models.gpt import (
    GPT_Small,
    decode_cache,
    fused_lm_loss,
    generate,
)
from pddl_tpu_torch.models.llama import GPipeLlama, Llama_1B, tiny_llama
from pddl_tpu_torch.models.speculative import generate_speculative
from pddl_tpu_torch.models.resnet import Conv, ResNet50, tiny_resnet
from pddl_tpu_torch.models.vit import GPipeViT, ViT_S16
from pddl_tpu_torch.obs import RequestTracer
from pddl_tpu_torch.ops import _kernels
from pddl_tpu_torch.ops import attention as tatt
from pddl_tpu_torch.ops.augment import standard_augment, standard_eval_transform
from pddl_tpu_torch.ops.lora import merge_lora_into_head
from pddl_tpu_torch.ops.moe import sown
from pddl_tpu_torch.ops.quant import (
    dequantize,
    install_params,
    quantize_int8,
    quantized_bytes,
)
from pddl_tpu_torch.ckpt import (
    CheckpointEveryN,
    Checkpointer,
    export_hf_llama,
    load_decode_artifact,
    load_hf_llama,
    load_inference_artifact,
    save_decode_artifact,
    save_inference_artifact,
    tree_checksums,
)
from pddl_tpu_torch.ckpt.checkpoint import local_state
from pddl_tpu_torch.ckpt.keras_import import (
    keras_weights_from_resnet,
    keras_weights_to_resnet,
)
from pddl_tpu_torch.data.native_loader import (
    NativeLoader,
    build_native,
    write_packed,
)
from pddl_tpu_torch.core import collectives
from pddl_tpu_torch.ckpt import load_hf_mixtral
from pddl_tpu_torch.core.mesh import MeshConfig
from pddl_tpu_torch.parallel import MirroredStrategy, get_strategy
from pddl_tpu_torch.parallel.pipeline import PipelineStrategy
from pddl_tpu_torch.parallel.tensor_parallel import (
    LLAMA_EP_RULES,
    LLAMA_TP_RULES,
    ExpertParallelStrategy,
    TensorParallelStrategy,
)
from pddl_tpu_torch.chaos import ChaosConductor, ReplicaChaos
from pddl_tpu_torch.serve.engine import ServeEngine as _ServeEngine
from pddl_tpu_torch.serve.faults import FaultKind, FaultPlan, FaultSpec
from pddl_tpu_torch.serve.fleet import (
    FleetRouter,
    LocalReplica,
    ProcessReplica,
)
from pddl_tpu_torch.serve.fleet.worker import build_engine
from pddl_tpu_torch.serve.kvcache import HostTierConfig, pool_nbytes
from pddl_tpu_torch.serve.request import FinishReason, Priority
from pddl_tpu_torch.serve.tenant import (
    AdapterRegistry,
    TenantConfig,
    compile_constraint,
)
from pddl_tpu_torch.train.callbacks import (
    Callback,
    CSVLogger,
    EarlyStopping,
    LambdaCallback,
    ModelSummary,
    ReduceLROnPlateau,
    TensorBoard,
    Timing,
)
from pddl_tpu_torch.train.faults import TrainFaultPlan
from pddl_tpu_torch.train.loop import Trainer
from pddl_tpu_torch.train.mixed_precision import _sr_to_bf16, stochastic_round
from pddl_tpu_torch.train.state import (
    get_learning_rate,
    make_optimizer,
    make_schedule,
    optimizer_state_bytes,
)
from pddl_tpu_torch.train.metrics import sparse_categorical_crossentropy
from pddl_tpu_torch.utils.faults import StorageFaultPlan

HBM_BYTES_PER_S = 3.35e12              # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.float32: 67e12}    # f32 outside the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}  # of max |grad|
VOCAB, MAX_LEN = 128256, 1024          # as benchmarks/decode_bench.py builds it
DEV = torch.device("cuda", 0)
BUILD = pathlib.Path(__file__).resolve().parent / "build"
_T0 = time.perf_counter()
SMI = "not read"  # nvidia-smi's card name and power limit, set by main


def ServeEngine(*args, **kwargs):
    """The port's engine, warmed where it is built, as a server warms
    before it takes traffic (the fleet worker does): a phase's counted
    window then holds its traffic's launches only."""
    eng = _ServeEngine(*args, **kwargs)
    eng.warmup()
    return eng


def phase(tag: str, **fields) -> None:
    """One result line, ending with the script's seconds so far."""
    fields["at_s"] = f"{time.perf_counter() - _T0:.1f}"
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


# ------------------------------------------------------------ phase 1-2
def device_line() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def build_kernels() -> float:
    t0 = time.perf_counter()
    _kernels.build(extra_flags=("-Xptxas", "-v"))
    for name in _kernels.SOURCES:
        _kernels.library(name)
    return time.perf_counter() - t0


# -------------------------------------------------------------- phase 3
def paged_case(gen, *, b, h, hkv, d, bs, t, depths, dtype):
    """Random pools, a random permutation of block ids as the tables
    (the kernel must follow the indirection), q, per-row depths."""
    n = 1 + b * t
    kp = torch.randn(n, hkv, bs, d, generator=gen, device=DEV).to(dtype)
    vp = torch.randn(n, hkv, bs, d, generator=gen, device=DEV).to(dtype)
    table = (torch.randperm(n - 1, generator=gen, device=DEV)[:b * t] + 1)
    q = torch.randn(b, h, 1, d, generator=gen, device=DEV).to(dtype)
    index = torch.tensor(depths, dtype=torch.int32, device=DEV)
    return q, kp, vp, table.view(b, t).to(torch.int32), index


def compare(case, window):
    got = tatt.paged_decode_attention_kernel(*case, window=window)
    ref = tatt.paged_decode_attention(*case, window=window, kernel=False)
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise RuntimeError("paged_decode kernel produced non-finite output")
    return float((got.float() - ref.float()).abs().max())


def cuda_ms(fn, n_copies: int, iters: int = 200) -> float:
    """Mean ms per call on CUDA events, cycling over ``n_copies`` input
    sets so the working set exceeds the 50 MB L2 (as in the tick, where
    16 layers' pools and the weights stream between two launches)."""
    for i in range(2 * n_copies):
        fn(i % n_copies)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_copies)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n_copies: int, calls: int = 32, reps: int = 200) -> float:
    """Device ms per call: ``calls`` calls (cycling over ``n_copies`` input
    sets) captured in one CUDA graph, replayed ``reps`` times after 50
    warm-up replays, on CUDA events. Where a call's device work is
    shorter than its wrapper's host time, eager launches leave the card
    idle between calls and :func:`cuda_ms` measures the host; the graph
    replays the same launches back to back."""
    for i in range(n_copies):
        fn(i)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_copies)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i % n_copies)
    for _ in range(50):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def decode_bound_ms(case):
    """Least time for one call and what sets it: the bytes it must move
    (q, the live K/V prefix of every row, the table entries it follows,
    the index and the output) over HBM bandwidth, or its flops over the
    dtype's peak — whichever is larger. Returns ``(ms, "bytes" |
    "operations")``."""
    q, kp, _, table, index = case
    b, h, _, d = q.shape
    _, hkv, bs, _ = kp.shape
    live = index.long().cpu() + 1                     # tokens per row
    isz = q.element_size()
    nbytes = (2 * q.numel() * isz                      # q in, out
              + int(live.sum()) * 2 * hkv * d * isz    # K and V
              + int(((live + bs - 1) // bs).sum()) * 4 + b * 4)
    flops = 4 * h * d * int(live.sum())
    return _bound(nbytes, flops, q.dtype)


def _bound(nbytes, flops, dtype):
    byte_s = nbytes / HBM_BYTES_PER_S
    op_s = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(byte_s, op_s), "bytes" if byte_s >= op_s else "operations"


def sdpa_fn(cases):
    """The library yardstick: SDPA over each case's K/V gathered dense
    (gather done here, untimed), masked to each row's depth. Used only
    to time; the port never calls it."""
    dense = []
    for q, kp, vp, table, index in cases:
        b, h, _, d = q.shape
        _, hkv, bs, _ = kp.shape
        t = table.shape[1]
        ids = table.long()
        k = kp[ids].permute(0, 2, 1, 3, 4).reshape(b, hkv, t * bs, d)
        v = vp[ids].permute(0, 2, 1, 3, 4).reshape(b, hkv, t * bs, d)
        k = k.repeat_interleave(h // hkv, dim=1).contiguous()
        v = v.repeat_interleave(h // hkv, dim=1).contiguous()
        pos = torch.arange(t * bs, device=DEV)
        mask = (pos[None, :] <= index[:, None].long())[:, None, None, :]
        dense.append((q, k, v, mask))

    def fn(i):
        q, k, v, mask = dense[i]
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return fn


# K4's timing shapes (bf16): Llama-1B's decode shape at the agreement
# case's mixed depths; the engine's steady tick (8 rows at depth 390); one
# row at Llama_1B's max_len 4096 (T 256), where one block per (row, kv
# head) would leave most of the card idle.
LLAMA_DECODE = dict(b=8, h=32, hkv=8, d=64, bs=16, t=64)
MIXED_DEPTHS = [0, 7, 16, 100, 391, 512, 777, 64 * 16 - 1]
# GPT-2-small's paged tick: MHA (rep 1), 12 heads, the same table.
GPT_DECODE = dict(b=8, h=12, hkv=12, d=64, bs=16, t=64, depths=MIXED_DEPTHS)
PAGED_TIMING = {
    "mixed": dict(LLAMA_DECODE, depths=MIXED_DEPTHS),
    "tick": dict(LLAMA_DECODE, depths=[390] * 8),
    "long_row": dict(LLAMA_DECODE, b=1, t=256, depths=[4095]),
    "gpt2_small_mixed": GPT_DECODE,
}


def paged_split_edges(gen):
    """Agreement cases at the edges of K4's split of the table (the plan
    the wrapper takes on this card): depths at a split boundary and one
    past it, a window from one split into the next, a table far wider
    than the deepest row, rep 1 and rep 8, D 256 with bs 64, and table
    entries outside [0, N), which read block 0 (held against the plain
    version on the table with those entries at 0). ``name -> (err, tol)``."""
    sms = tatt._sm_count(DEV.index or 0)
    n_split, per = tatt.paged_split_plan(8, 8, 64, 16, sms)
    edge = per * 16                       # first position of split 1
    depths = [edge - 1, edge, edge + 1, 2 * edge - 1, 2 * edge, 0, 390,
              64 * 16 - 1]
    cases = {
        "split_edges": (dict(LLAMA_DECODE, depths=depths), (None, 100)),
        "wide_table": (dict(LLAMA_DECODE, b=4, t=256, depths=[0, 15, 16, 40]),
                       (None, 6)),
        "rep1": (dict(LLAMA_DECODE, b=4, hkv=32, depths=[0, 127, 128, 1000]),
                 (None, 100)),
        "rep8": (dict(LLAMA_DECODE, b=4, hkv=4, depths=[1, 127, 128, 1023]),
                 (None, 100)),
        "d256_bs64": (dict(b=2, h=8, hkv=2, d=256, bs=64, t=16,
                           depths=[63, 1023]), (None, 100)),
    }
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        for name, (shape, windows) in cases.items():
            case = paged_case(gen, dtype=dtype, **shape)
            for window in windows:
                errs[f"{name}_{dn}_w{window}"] = (compare(case, window),
                                                  TOL[dtype])
        q, kp, vp, table, index = paged_case(gen, dtype=dtype,
                                             **PAGED_TIMING["mixed"])
        bad = table.clone()
        bad[0, 0], bad[3, 5], bad[7, 60] = -7, kp.shape[0], kp.shape[0] + 11
        got = tatt.paged_decode_attention_kernel(q, kp, vp, bad, index)
        sink = torch.where((bad >= 0) & (bad < kp.shape[0]), bad, 0)
        ref = tatt.paged_decode_attention(q, kp, vp, sink, index,
                                          kernel=False)
        torch.cuda.synchronize()
        errs[f"table_out_of_range_{dn}"] = (
            float((got.float() - ref.float()).abs().max()), TOL[dtype])
    return n_split, per, errs


def time_paged(gen, shape):
    """K4's time at one shape on 8 copies of the inputs (~134 MB at the
    Llama shape, so every launch reads K/V from HBM as in the tick, where
    16 layers' pools and the weights stream between launches): ``ms`` and
    the SDPA yardstick's ``library_ms`` are device times from a CUDA graph
    (:func:`graph_ms`); ``eager_ms`` times the same wrapper calls launched
    one by one (:func:`cuda_ms`), which is the wrapper's host time where
    that is the longer; the plain version (``plain_ms``, eager: it reads
    the depths on the host) and the bound beside them."""
    cases = [paged_case(gen, dtype=torch.bfloat16, **shape)
             for _ in range(8)]

    def kernel(i):
        return tatt.paged_decode_attention_kernel(*cases[i])

    ms = graph_ms(kernel, 8)
    eager_ms = cuda_ms(kernel, 8)
    plain_ms = cuda_ms(lambda i: tatt.paged_decode_attention(
        *cases[i], kernel=False), 8, iters=50)
    library_ms = graph_ms(sdpa_fn(cases), 8)
    bound_ms, bound_by = decode_bound_ms(cases[0])
    return {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_paged_decode():
    gen = torch.Generator(device=DEV).manual_seed(0)
    llama = PAGED_TIMING["mixed"]
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = "bf16" if dtype == torch.bfloat16 else "f32"
        case = paged_case(gen, dtype=dtype, **llama)
        for window in (None, 128):
            errs[f"llama1b_{dn}_w{window}"] = (compare(case, window),
                                               TOL[dtype])
        odd = paged_case(gen, b=4, h=12, hkv=4, d=128, bs=16, t=8,
                         depths=[0, 5, 70, 127], dtype=dtype)
        errs[f"rep3_d128_{dn}"] = (compare(odd, None), TOL[dtype])
        gpt = paged_case(gen, dtype=dtype, **GPT_DECODE)
        for window in (None, 128):
            errs[f"gpt2_small_{dn}_w{window}"] = (compare(gpt, window),
                                                  TOL[dtype])
    tiny = paged_case(gen, b=3, h=4, hkv=2, d=8, bs=4, t=6,
                      depths=[23, 0, 9], dtype=torch.float32)
    for window in (None, 6):
        errs[f"tiny_f32_w{window}"] = (compare(tiny, window),
                                       TOL[torch.float32])
    n_split, per, edge_errs = paged_split_edges(gen)
    errs.update(edge_errs)
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    phase("paged_decode", cases=len(errs),
          split_plan=f"{n_split}x{per}_entries",
          errors=" ".join(f"{k}:{e:.3g}/{tol:g}" for k, (e, tol)
                          in errs.items()))
    if bad:
        raise RuntimeError(f"paged_decode kernel disagrees with plain: {bad}")

    # Two runs bitwise equal at the Llama-1B shape: the splits merge in a
    # fixed order.
    case = paged_case(gen, dtype=torch.bfloat16, **llama)
    first = tatt.paged_decode_attention_kernel(*case)
    second = tatt.paged_decode_attention_kernel(*case)
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise RuntimeError("paged_decode: two runs differ at the Llama-1B "
                           "shape")
    phase("paged_decode_bitwise", shape="B8_H32_Hkv8_D64_bs16_T64_bf16",
          equal=True)

    timings = {}
    for name, shape in PAGED_TIMING.items():
        timings[name] = t = time_paged(gen, shape)
        phase("paged_decode_time", case=name,
              shape=f"B{shape['b']}_H{shape['h']}_Hkv{shape['hkv']}_"
                    f"D{shape['d']}_bs{shape['bs']}_T{shape['t']}_bf16",
              depths="/".join(map(str, shape["depths"])),
              split_plan="x".join(map(str, tatt.paged_split_plan(
                  shape["b"], shape["hkv"], shape["t"], shape["bs"],
                  tatt._sm_count(DEV.index or 0)))),
              **{k: (f"{v:.5f}" if isinstance(v, float) else v)
                 for k, v in t.items()})
    err = max(e for k, (e, _) in errs.items() if k.startswith("llama1b_bf16"))
    timings["gpt2_small_mixed"]["max_abs_err"] = max(
        e for k, (e, _) in errs.items() if k.startswith("gpt2_small_bf16"))
    return {**timings["mixed"], "max_abs_err": err,
            "shapes": {k: v for k, v in timings.items() if k != "mixed"}}


# ---------------------------------------------------------- phase 4-5
# (b, h, hkv, sq, sk, d, dtype, causal, window, k_offset)
FLASH_CASES = {
    "llama1b": (4, 32, 8, 2048, 2048, 64, torch.bfloat16, True, None, 0),
    "llama1b_w512": (4, 32, 8, 2048, 2048, 64, torch.bfloat16, True, 512, 0),
    "mha": (2, 16, 16, 2048, 2048, 64, torch.bfloat16, True, None, 0),
    "rep3_d128": (2, 12, 4, 1024, 1024, 128, torch.bfloat16, True, None, 0),
    "ragged1000": (2, 8, 2, 1000, 1000, 64, torch.bfloat16, True, None, 0),
    "k_offset": (2, 8, 2, 512, 512, 64, torch.bfloat16, True, 384, -256),
    "f32": (2, 8, 2, 1024, 1024, 64, torch.float32, True, None, 0),
    "s129": (2, 8, 2, 129, 129, 64, torch.bfloat16, True, None, 0),
    "full_bf16": (2, 4, 2, 200, 136, 64, torch.bfloat16, False, None, 0),
    "window6": (2, 8, 2, 300, 300, 64, torch.bfloat16, True, 6, 0),
    "sk257": (2, 8, 2, 257, 257, 64, torch.bfloat16, True, None, 0),
    "sk257_window12": (2, 8, 2, 257, 257, 64, torch.bfloat16, True, 12, 0),
    # The GPT-2-small and ViT-S/16 train steps (MHA; ViT non-causal).
    "gpt2_small": (8, 12, 12, 1024, 1024, 64, torch.bfloat16, True, None, 0),
    "vit_s16": (256, 6, 6, 196, 196, 64, torch.bfloat16, False, None, 0),
    # One process's heads of Llama-1B under TP2 (16 query, 4 KV heads).
    "llama1b_tp2": (1, 16, 4, 2048, 2048, 64, torch.bfloat16, True, None, 0),
}
WITH_DLSE = ("llama1b", "k_offset")


def flash_case(gen, b, h, hkv, sq, sk, d, dtype, causal, window, k_offset):
    q, do = (torch.randn(b, h, sq, d, generator=gen, device=DEV).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, sk, d, generator=gen, device=DEV).to(dtype)
            for _ in range(2))
    dlse = torch.randn(b, h, sq, generator=gen, device=DEV)
    kw = dict(causal=causal, scale=d ** -0.5, window=window,
              k_offset=k_offset)
    return (q, k, v), do, dlse, kw


def flash_fwd_bound_ms(q, k, want_lse=True, causal=True):
    """Least time of one forward and what sets it: 2·B·H·S²·D flops
    causal (4·B·H·S²·D full) over the bf16 tensor-core peak, or the bytes
    of q, k, v read once and o (and lse) written once over HBM
    bandwidth."""
    b, h, s, d = q.shape
    nbytes = ((2 * q.numel() + 2 * k.numel()) * q.element_size()
              + (b * h * s * 4 if want_lse else 0))
    flops = (2 if causal else 4) * b * h * s * s * d
    return _bound(nbytes, flops, q.dtype)


def flash_bwd_bound_ms(q, k, causal=True):
    """As :func:`flash_fwd_bound_ms` for the backward: 5·B·H·S²·D causal
    flops (10·B·H·S²·D full); q, o, do read and dq written, k, v read and
    dk, dv written, lse read."""
    b, h, s, d = q.shape
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + b * h * s * 4
    flops = (5 if causal else 10) * b * h * s * s * d
    return _bound(nbytes, flops, q.dtype)


def phase_flash_fwd():
    gen = torch.Generator(device=DEV).manual_seed(1)
    errs = {}
    for name, shape in FLASH_CASES.items():
        qkv, _, _, kw = flash_case(gen, *shape)
        ref_o, ref_lse = tatt.flash_forward_plain(*qkv, **kw)
        for want_lse in (True, False):
            o, lse = tatt.flash_forward(*qkv, want_lse=want_lse, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(o.float()).all():
                raise RuntimeError(f"flash_fwd {name}: non-finite output")
            err = float((o.float() - ref_o.float()).abs().max())
            if want_lse:
                err = max(err, float((lse - ref_lse).abs().max()))
            errs[f"{name}_{'lse' if want_lse else 'nolse'}"] = (
                err, TOL[qkv[0].dtype])
        del qkv, ref_o, ref_lse
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    phase("flash_fwd", cases=len(errs),
          errors=" ".join(f"{k}:{e:.3g}/{tol:g}" for k, (e, tol)
                          in errs.items()))
    if bad:
        raise RuntimeError(f"flash_fwd kernel disagrees with plain: {bad}")

    # Times at Llama-1B's training shape: two input sets (~100 MB). First,
    # two runs on one set must agree bit for bit (no atomics; the remat
    # recompute relies on it).
    cases = [flash_case(gen, *FLASH_CASES["llama1b"]) for _ in range(2)]
    kw = cases[0][3]
    first, second = (tatt.flash_forward(*cases[0][0], **kw) for _ in range(2))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(first, second))
    phase("flash_fwd_bitwise", shape="B4_H32_Hkv8_S2048_D64_bf16_causal",
          o_and_lse_equal=bitwise)
    if not bitwise:
        raise RuntimeError("two K1 runs gave different o or lse")
    del first, second
    ms = cuda_ms(lambda i: tatt.flash_forward(*cases[i][0], **kw), 2,
                 iters=20)
    ms_nolse = cuda_ms(lambda i: tatt.flash_forward(
        *cases[i][0], want_lse=False, **kw), 2, iters=20)
    plain_ms = cuda_ms(lambda i: tatt.flash_forward_plain(*cases[i][0], **kw),
                       2, iters=4)
    library_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
        *cases[i][0], is_causal=True, enable_gqa=True), 2, iters=20)
    bound_ms, bound_by = flash_fwd_bound_ms(*cases[0][0][:2])
    nolse_bound_ms, nolse_bound_by = flash_fwd_bound_ms(*cases[0][0][:2],
                                                        want_lse=False)
    phase("flash_fwd_time", shape="B4_H32_Hkv8_S2048_D64_bf16_causal",
          ms=f"{ms:.5f}", ms_nolse=f"{ms_nolse:.5f}",
          plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
          bound_ms=f"{bound_ms:.5f}", bound_by=bound_by)
    common = {"plain_ms": plain_ms, "library_ms": library_ms}
    return {
        "flash_fwd": {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "max_abs_err": errs["llama1b_lse"][0], **common},
        "flash_fwd_nolse": {"ms": ms_nolse, "bound_ms": nolse_bound_ms,
                            "bound_by": nolse_bound_by,
                            "max_abs_err": errs["llama1b_nolse"][0],
                            **common}}


def phase_flash_bwd():
    gen = torch.Generator(device=DEV).manual_seed(2)
    errs, abs_errs = {}, {}
    for name, shape in FLASH_CASES.items():
        qkv, do, dlse, kw = flash_case(gen, *shape)
        o, lse = tatt.flash_forward_plain(*qkv, **kw)
        for cot in ((None, dlse) if name in WITH_DLSE else (None,)):
            got = tatt.flash_backward(*qkv, o, lse, do, cot, **kw)
            want = tatt.flash_backward_plain(*qkv, o, lse, do, cot, **kw)
            torch.cuda.synchronize()
            tag = name + ("_dlse" if cot is not None else "")
            rel = []
            for g, w, x in zip(got, want, qkv):
                if g.shape != x.shape or g.dtype != x.dtype or not \
                        torch.isfinite(g.float()).all():
                    raise RuntimeError(f"flash_bwd {tag}: bad gradient")
                err = float((g.float() - w.float()).abs().max())
                rel.append(err / float(w.float().abs().max()))
                abs_errs[tag] = max(abs_errs.get(tag, 0.0), err)
            errs[tag] = (max(rel), GRAD_TOL[qkv[0].dtype])
            del got, want
        del qkv, do, o, lse
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    phase("flash_bwd", cases=len(errs), relative_errors=" ".join(
        f"{k}:{e:.3g}/{tol:g}" for k, (e, tol) in errs.items()))
    if bad:
        raise RuntimeError(f"flash_bwd kernel disagrees with plain: {bad}")

    cases = []
    for _ in range(2):
        qkv, do, _, kw = flash_case(gen, *FLASH_CASES["llama1b"])
        o, lse = tatt.flash_forward(*qkv, **kw)
        cases.append((qkv, o, lse, do))
    # dk and dv are summed inside one block and written once: two K2 runs
    # on one set agree bit for bit (dq, added with atomics, need not).
    first, second = (tatt.flash_backward(*cases[0][0], *cases[0][1:], **kw)
                     for _ in range(2))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(first[1:], second[1:]))
    phase("flash_bwd_bitwise", shape="B4_H32_Hkv8_S2048_D64_bf16_causal",
          dk_and_dv_equal=bitwise)
    if not bitwise:
        raise RuntimeError("two K2 runs gave different dk or dv")
    del first, second
    ms = cuda_ms(lambda i: tatt.flash_backward(
        *cases[i][0], *cases[i][1:], **kw), 2, iters=10)
    plain_ms = cuda_ms(lambda i: tatt.flash_backward_plain(
        *cases[i][0], *cases[i][1:], **kw), 2, iters=2)
    leaves = [[x.detach().requires_grad_() for x in c[0]] for c in cases]

    def sdpa(i, backward):
        o = F.scaled_dot_product_attention(*leaves[i], is_causal=True,
                                           enable_gqa=True)
        if backward:
            o.backward(cases[i][3])
    sdpa_fb = cuda_ms(lambda i: sdpa(i, True), 2, iters=10)
    sdpa_f = cuda_ms(lambda i: sdpa(i, False), 2, iters=10)
    library_ms = sdpa_fb - sdpa_f
    bound_ms, bound_by = flash_bwd_bound_ms(*cases[0][0][:2])
    phase("flash_bwd_time", shape="B4_H32_Hkv8_S2048_D64_bf16_causal",
          ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          library_ms=f"{library_ms:.5f}",
          sdpa_fwd_bwd_ms=f"{sdpa_fb:.5f}", bound_ms=f"{bound_ms:.5f}",
          bound_by=bound_by)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "max_abs_err": max(v for k, v in abs_errs.items()
                               if k.startswith("llama1b"))}


# ------------------------------------------------------------- phase 5b
# Llama-1B at long context: rep 4 · S 8192 · D 64 · 4 bytes = 8 MiB of
# fused dq accumulator, above the JAX package's 6 MiB, so its backward
# takes the two sweeps K3a/K3b with nothing patched.
LONG = (1, 32, 8, 8192, 8192, 64, torch.bfloat16, True, None, 0)
TWO_SWEEP_ODD = ("llama1b_w512", "mha", "rep3_d128", "ragged1000",
                 "k_offset", "f32", "s129", "full_bf16", "window6", "sk257",
                 "sk257_window12")


@contextlib.contextmanager
def dispatch_threshold(nbytes):
    """Set the backward's K2/K3 dispatch threshold for the block: 0 sends
    every shape to K3a/K3b, a huge one every shape to K2."""
    old = tatt._FUSED_BWD_DQ_BYTES
    tatt._FUSED_BWD_DQ_BYTES = nbytes
    try:
        yield
    finally:
        tatt._FUSED_BWD_DQ_BYTES = old


def two_sweep_bound_ms(q, k, sweep):
    """Least time of K3a (``dq``: 3 products per causal tile pair; q, do,
    k, v, lse and di read, dq written) or K3b (``dkv``: 4 products; the
    same read, dk and dv written), each product 2·B·H·S²·D/2 causal
    flops."""
    b, h, s, d = q.shape
    products, q_like, k_like = {"dq": (3, 3, 2), "dkv": (4, 2, 4)}[sweep]
    nbytes = ((q_like * q.numel() + k_like * k.numel()) * q.element_size()
              + 2 * b * h * s * 4)
    return _bound(nbytes, products * b * h * s * s * d, q.dtype)


def rel_errs(got, want):
    """Each gradient's max-abs error relative to the reference's max-abs."""
    return [float((g.float() - w.float()).abs().max())
            / float(w.float().abs().max()) for g, w in zip(got, want)]


def check_flash_fwd_long(qkv, kw, ref_o, ref_lse):
    """K1 at the long shape against the plain forward's o and lse, with
    and without its LSE, and two runs on the same inputs bitwise equal."""
    errs, bitwise = {}, {}
    for want_lse in (True, False):
        tag = "lse" if want_lse else "nolse"
        runs = [tatt.flash_forward(*qkv, want_lse=want_lse, **kw)
                for _ in range(2)]
        torch.cuda.synchronize()
        o, lse = runs[0]
        if not torch.isfinite(o.float()).all():
            raise RuntimeError(f"flash_fwd llama1b_s8192_{tag}: non-finite")
        err = float((o.float() - ref_o.float()).abs().max())
        if want_lse:
            err = max(err, float((lse - ref_lse).abs().max()))
        errs[tag] = err
        bitwise[tag] = all(a is None and b is None or torch.equal(a, b)
                           for a, b in zip(*runs))
        del runs, o, lse
    tol = TOL[torch.bfloat16]
    phase("flash_fwd_long", shape="B1_H32_Hkv8_S8192_D64_bf16_causal",
          errors=" ".join(f"{k}:{e:.3g}/{tol:g}" for k, e in errs.items()),
          bitwise_equal=" ".join(f"{k}:{v}" for k, v in bitwise.items()))
    if not max(errs.values()) <= tol:
        raise RuntimeError(f"flash_fwd disagrees with plain at S 8192: {errs}")
    if not all(bitwise.values()):
        raise RuntimeError(f"two K1 runs at S 8192 differ: {bitwise}")


def phase_flash_bwd_two_sweep():
    gen = torch.Generator(device=DEV).manual_seed(4)
    errs, long_abs = {}, {}
    cases = [("llama1b_s8192", LONG)] + [(n, FLASH_CASES[n])
                                         for n in TWO_SWEEP_ODD]
    for name, shape in cases:
        qkv, do, dlse, kw = flash_case(gen, *shape)
        with (contextlib.nullcontext() if name == "llama1b_s8192"
              else dispatch_threshold(0)):
            if not tatt.takes_two_sweeps(*qkv[:2]):
                raise RuntimeError(f"{name} does not take the two sweeps")
            o, lse = tatt.flash_forward_plain(*qkv, **kw)
            if name == "llama1b_s8192":
                check_flash_fwd_long(qkv, kw, o, lse)
            for cot in ((None, dlse) if name in WITH_DLSE else (None,)):
                before = dict(_kernels.launch_counts)
                got = tatt.flash_backward(*qkv, o, lse, do, cot, **kw)
                torch.cuda.synchronize()
                moved = {k: _kernels.launch_counts[k] - before[k]
                         for k in before if _kernels.launch_counts[k]
                         != before[k]}
                if moved != {"flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
                    raise RuntimeError(f"two-sweep {name} launched {moved}")
                want = tatt.flash_backward_plain(*qkv, o, lse, do, cot, **kw)
                torch.cuda.synchronize()
                tag = name + ("_dlse" if cot is not None else "")
                for g, x in zip(got, qkv):
                    if g.shape != x.shape or g.dtype != x.dtype or not \
                            torch.isfinite(g.float()).all():
                        raise RuntimeError(f"two-sweep {tag}: bad gradient")
                if name == "llama1b_s8192":
                    long_abs = {"dq": float((got[0].float() - want[0].float())
                                            .abs().max()),
                                "dkv": max(float((g.float() - w.float())
                                                 .abs().max()) for g, w
                                           in zip(got[1:], want[1:]))}
                errs[tag] = (max(rel_errs(got, want)),
                             GRAD_TOL[qkv[0].dtype])
                del got, want
        del qkv, do, o, lse
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    phase("flash_bwd_two_sweep", cases=len(errs), relative_errors=" ".join(
        f"{k}:{e:.3g}/{tol:g}" for k, (e, tol) in errs.items()))
    if bad:
        raise RuntimeError(f"K3a/K3b disagree with plain: {bad}")

    # At the long shape: K3 against K2 (the same function), K3a twice
    # (bitwise), then times on two input sets.
    sets = []
    for _ in range(2):
        qkv, do, _, kw = flash_case(gen, *LONG)
        o, lse = tatt.flash_forward(*qkv, **kw)
        sets.append((qkv, o, lse, do, tatt._row_term(o, do)))
    qkv, o, lse, do, di = sets[0]
    k3 = tatt.flash_backward(*qkv, o, lse, do, **kw)
    with dispatch_threshold(1 << 62):
        k2 = tatt.flash_backward(*qkv, o, lse, do, **kw)
        k2_again = tatt.flash_backward(*qkv, o, lse, do, **kw)
    vs_k2 = rel_errs(k3, k2)
    dq_again = tatt.flash_backward_dq(*qkv, do, lse, di, **kw)
    dkv_again = tatt.flash_backward_dkv(*qkv, do, lse, di, **kw)
    torch.cuda.synchronize()
    bitwise = {"k3a_dq": bool(torch.equal(dq_again, k3[0])),
               "k3b_dk_dv": all(torch.equal(a, b)
                                for a, b in zip(dkv_again, k3[1:])),
               "k2_dk_dv": all(torch.equal(a, b)
                               for a, b in zip(k2_again[1:], k2[1:]))}
    phase("flash_bwd_two_sweep_vs_k2", shape="B1_H32_Hkv8_S8192_D64_bf16",
          dq=f"{vs_k2[0]:.3g}", dk=f"{vs_k2[1]:.3g}", dv=f"{vs_k2[2]:.3g}",
          tol=f"{GRAD_TOL[torch.bfloat16]:g}", bitwise_equal=" ".join(
              f"{k}:{v}" for k, v in bitwise.items()))
    if not max(vs_k2) <= GRAD_TOL[torch.bfloat16]:
        raise RuntimeError(f"K3 and K2 disagree: {vs_k2}")
    if not all(bitwise.values()):
        raise RuntimeError(f"two runs differ at S 8192: {bitwise}")
    del k3, k2, k2_again, dq_again, dkv_again

    dq_ms = cuda_ms(lambda i: tatt.flash_backward_dq(
        *sets[i][0], sets[i][3], sets[i][2], sets[i][4], **kw), 2, iters=10)
    dkv_ms = cuda_ms(lambda i: tatt.flash_backward_dkv(
        *sets[i][0], sets[i][3], sets[i][2], sets[i][4], **kw), 2, iters=10)
    pair_ms = cuda_ms(lambda i: tatt.flash_backward(
        *sets[i][0], *sets[i][1:4], **kw), 2, iters=10)
    with dispatch_threshold(1 << 62):
        k2_ms = cuda_ms(lambda i: tatt.flash_backward(
            *sets[i][0], *sets[i][1:4], **kw), 2, iters=10)
    plain_ms = cuda_ms(lambda i: tatt.flash_backward_plain(
        *sets[i][0], *sets[i][1:4], **kw), 2, iters=2)
    leaves = [[x.detach().requires_grad_() for x in c[0]] for c in sets]

    def sdpa(i, backward):
        o = F.scaled_dot_product_attention(*leaves[i], is_causal=True,
                                           enable_gqa=True)
        if backward:
            o.backward(sets[i][3])
    sdpa_fb = cuda_ms(lambda i: sdpa(i, True), 2, iters=10)
    sdpa_f = cuda_ms(lambda i: sdpa(i, False), 2, iters=10)
    sdpa_bwd = sdpa_fb - sdpa_f
    k1_ms = cuda_ms(lambda i: tatt.flash_forward(*sets[i][0], **kw), 2,
                    iters=10)
    k1_nolse_ms = cuda_ms(lambda i: tatt.flash_forward(
        *sets[i][0], want_lse=False, **kw), 2, iters=10)
    q, k = sets[0][0][:2]
    k1_bound, _ = flash_fwd_bound_ms(q, k)
    dq_bound, dq_by = two_sweep_bound_ms(q, k, "dq")
    dkv_bound, dkv_by = two_sweep_bound_ms(q, k, "dkv")
    phase("flash_bwd_two_sweep_time", shape="B1_H32_Hkv8_S8192_D64_bf16",
          dq_ms=f"{dq_ms:.5f}", dkv_ms=f"{dkv_ms:.5f}",
          sum_ms=f"{dq_ms + dkv_ms:.5f}", wrapper_ms=f"{pair_ms:.5f}",
          k2_ms=f"{k2_ms:.5f}", sdpa_bwd_ms=f"{sdpa_bwd:.5f}",
          sdpa_fwd_ms=f"{sdpa_f:.5f}", k1_ms=f"{k1_ms:.5f}",
          k1_nolse_ms=f"{k1_nolse_ms:.5f}",
          k1_bound_ms=f"{k1_bound:.5f}",
          plain_ms=f"{plain_ms:.5f}", dq_bound_ms=f"{dq_bound:.5f}",
          dkv_bound_ms=f"{dkv_bound:.5f}", bound_by=f"{dq_by}/{dkv_by}")
    # No PyTorch call computes dq alone or dk, dv alone: SDPA's backward,
    # which computes all three, is K3b's yardstick and that of the pair.
    return {"flash_bwd_dq": {"ms": dq_ms, "bound_ms": dq_bound,
                             "bound_by": dq_by, "plain_ms": plain_ms,
                             "max_abs_err": long_abs["dq"],
                             "library_ms": None},
            "flash_bwd_dkv": {"ms": dkv_ms, "bound_ms": dkv_bound,
                              "bound_by": dkv_by, "plain_ms": plain_ms,
                              "max_abs_err": long_abs["dkv"],
                              "library_ms": sdpa_bwd,
                              "library_computes": "dq, dk and dv (the "
                              "yardstick of flash_bwd_dq and flash_bwd_dkv "
                              "together)"}}


# -------------------------------------------------------------- phase 6
def top2_margin(model, tokens) -> float:
    with torch.no_grad():
        logits = model(torch.tensor([tokens], device=model.device))[0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def cpu_copy(gpu_model, factory=Llama_1B, **cfg):
    """A model of ``cfg`` on the CPU holding ``gpu_model``'s weights: built
    on ``meta`` (nothing drawn), laid out on the host and loaded. The
    parity pairs draw their seeded weights on the card, in milliseconds;
    the host's generator takes seconds a copy at Llama-1B's width."""
    cpu_model = factory(**cfg, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict(gpu_model.state_dict())
    return cpu_model


def _parity_pair(**cfg):
    """One seeded full-width Llama-1B weight set at ``cfg``, drawn on the
    card and copied to the CPU, f32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(vocab_size=VOCAB, dtype=torch.float32, seed=1, **cfg)
    gpu_model = Llama_1B(**cfg, device=DEV)
    return gpu_model, cpu_copy(gpu_model, **cfg)


def check_streams(what, streams_gpu, streams_cpu, prompts, cpu_model, n):
    """Token-exact card against CPU, unless the CPU's top-2 logit margin
    at the first divergence is < 1e-3 (a tie). Returns ``(exact, ties)``;
    raises on any other divergence or a short stream."""
    exact, ties = 0, []
    for i, prompt in enumerate(prompts):
        a, b = list(streams_gpu[i]), list(streams_cpu[i])
        if len(a) != n or len(b) != n:
            raise RuntimeError(f"{what} {i} emitted {len(a)}/{len(b)} tokens")
        diverge = next((j for j in range(n) if a[j] != b[j]), None)
        if diverge is None:
            exact += 1
            continue
        margin = top2_margin(cpu_model, list(prompt) + b[:diverge])
        if margin >= 1e-3:
            raise RuntimeError(
                f"{what} {i} diverges at token {diverge} "
                f"(cuda {a[diverge]}, cpu {b[diverge]}) with a CPU top-2 "
                f"margin of {margin:.3g} >= 1e-3")
        ties.append((i, diverge, margin))
    return exact, ";".join(f"req{i}@{j}:margin={m:.3g}" for i, j, m in ties
                           ) or "none"


def parity_prompts(vocab: int = VOCAB):
    """The parity legs' 4 prompts: two share a 32-token prefix."""
    rng = np.random.RandomState(4)
    shared = rng.randint(0, vocab, 32)
    return [np.concatenate([shared, rng.randint(0, vocab, 16)]),
            rng.randint(0, vocab, 80),
            np.concatenate([shared, rng.randint(0, vocab, 32)]),
            rng.randint(0, vocab, 100)]


def engine_parity_legs(tag, legs):
    """4 greedy requests x 16 tokens through engines on the card and on
    the CPU (Llama-1B width, depth 2, f32), one line per leg of engine
    keywords."""
    gpu_model, cpu_model = _parity_pair(max_len=MAX_LEN, depth=2)
    prompts = parity_prompts()
    for leg, engine_kw in legs:
        streams = {}
        for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
            eng = ServeEngine(model, device=model.device, max_slots=4,
                              prefill_len=128, prefix_block_size=16,
                              **engine_kw)
            handles = [eng.submit(p, 16) for p in prompts]
            eng.run(max_steps=200)
            streams[name] = [h.tokens for h in handles]
        exact, ties = check_streams("request", streams["cuda"],
                                    streams["cpu"], prompts, cpu_model, 16)
        phase(tag, **({"leg": leg} if leg else {}),
              model="Llama_1B_depth2_f32", allow_tf32=False,
              requests=len(prompts), token_exact=exact, ties=ties)
    del cpu_model, gpu_model


def phase_engine_parity():
    engine_parity_legs("engine_parity", [(None, {"paged": True})])


# -------------------------------------------------------------- phase 7
def serve_wave(model, prompts, paged: bool, new: int = 32, submit_kw=None,
               prepare=None, **engine_kw):
    """``engine_serve``'s wave through one engine: 24 greedy requests x
    ``new`` new tokens on 8 slots (``engine_kw``: the speculative or the
    tenant options; ``submit_kw``: each request's adapter and constraint,
    a constrained stream may end GRAMMAR before ``new`` tokens).
    Returns the launches, the metrics snapshot, the engine, the handles,
    the wall, the live-slot ticks, the pure decode ticks' walls (steps that
    admitted nothing), the largest ``blocks_shared`` and the
    ``resident_kv_report`` at the step with the most live tokens.
    ``prepare(engine)``, if given, runs before the first submit."""
    eng = ServeEngine(model, paged=paged, max_slots=8, prefix_block_size=16,
                      **engine_kw)
    if prepare is not None:
        prepare(eng)
    host = {"draft": 0.0, "verify": 0.0}
    if eng.spec_enabled:
        # Host seconds inside the speculative tick's two halves: drafting
        # (the n-gram lookup, or the draft model's launches) and the
        # verify (its launches and the wait for its one device-to-host
        # copy). Wrapped here; the engine carries no timers.
        for part, attr in (("draft", "_draft_tokens"), ("verify", "_verify")):
            def timed(*args, _fn=getattr(eng, attr), _part=part):
                t = time.perf_counter()
                out = _fn(*args)
                host[_part] += time.perf_counter() - t
                return out
            setattr(eng, attr, timed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    submit_kw = submit_kw or [{}] * len(prompts)
    handles = [eng.submit(p, new, **kw) for p, kw in zip(prompts, submit_kw)]
    max_shared, kv = 0, {"tokens_resident": -1}
    tick_s = []
    while eng.has_work:
        admitted = eng.metrics.ttft_s.count
        eng.step()
        rec = eng.telemetry.last()
        if rec["live_slots"] and eng.metrics.ttft_s.count == admitted:
            tick_s.append(rec["tick_wall_s"])
        max_shared = max(max_shared, eng.metrics.blocks_shared)
        report = eng.resident_kv_report()
        if report["tokens_resident"] > kv["tokens_resident"]:
            kv = report
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    ticks = sum(1 for r in eng.telemetry.snapshot() if r["live_slots"] > 0)
    if eng.telemetry.total_appended > eng.telemetry.capacity:
        raise RuntimeError("telemetry ring wrapped; ticks undercounted")
    for i, h in enumerate(handles):
        grammar = (submit_kw[i].get("constraint") is not None
                   and h.finish_reason is FinishReason.GRAMMAR)
        if not (grammar or h.finish_reason is FinishReason.LENGTH) or (
                len(h.tokens) > new or not grammar and len(h.tokens) != new):
            raise RuntimeError(f"request {i}: {h.finish_reason} with "
                               f"{len(h.tokens)} tokens")
        if not all(0 <= tok < model.vocab_size for tok in h.tokens):
            raise RuntimeError(f"request {i} emitted a token outside vocab")
    return dict(launches=launches, snap=eng.metrics.snapshot(), eng=eng,
                handles=handles, wall=wall, ticks=ticks, tick_s=tick_s,
                max_shared=max_shared, kv=kv, host=host,
                peak=torch.cuda.max_memory_allocated())


def serve_fields(run):
    snap, handles, wall = run["snap"], run["handles"], run["wall"]
    tokens = sum(len(h.tokens) for h in handles)
    return dict(requests=len(handles), tokens=tokens, wall_s=f"{wall:.4f}",
                tokens_per_s=f"{tokens / wall:.2f}",
                ttft_p50_s=f"{snap['ttft_p50_s']:.5f}",
                ttft_p99_s=f"{snap['ttft_p99_s']:.5f}", ticks=run["ticks"],
                decode_tick_ms_p50=(
                    f"{1e3 * float(np.median(run['tick_s'])):.4f}"))


def serve_prompts(vocab: int = VOCAB):
    """The serve wave: 24 prompts of 384 tokens, 256 of them shared."""
    rng = np.random.RandomState(5)
    shared = rng.randint(0, vocab, 256)
    return [np.concatenate([shared, rng.randint(0, vocab, 128)])
            for _ in range(24)]


# The serving phases after phase 7's (20 excepted) run Llama-1B at full
# width cut to this depth: their ticks are host-bound, about a layer's
# launches a layer, and the script has a time limit.
SERVE_DEPTH = 4


def serve_model_and_prompts(depth: int = 16):
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, max_len=MAX_LEN, depth=depth,
                     dtype=torch.bfloat16, device=DEV, seed=0)
    return model, serve_prompts()


def serve_label(model) -> str:
    """A bf16 Llama-1B's name in the phase lines, with its depth when cut."""
    cut = "" if model.depth == 16 else f"_depth{model.depth}"
    return f"Llama_1B{cut}_bf16"


def phase_engine_serve(model=None, prompts=None):
    """Phase 7 (``serve_tick_ab.py`` runs it alone, with no arguments).
    Returns the launches and the ``resident_kv_report`` at the step with
    the most live tokens."""
    if model is None:
        model, prompts = serve_model_and_prompts()
    run = serve_wave(model, prompts, paged=True)
    launches, snap = run["launches"], run["snap"]
    if run["max_shared"] <= 0:
        raise RuntimeError("no pool block was ever shared between slots")
    ticks = run["ticks"]
    if launches["paged_decode"] < model.depth * ticks or ticks == 0:
        raise RuntimeError(f"paged_decode launched {launches} times over "
                           f"{ticks} ticks of a {model.depth}-layer model")
    fields = serve_fields(run)
    phase("engine_serve", model="Llama_1B_bf16", **{
        k: fields[k] for k in ("requests", "tokens", "wall_s", "tokens_per_s",
                               "ttft_p50_s", "ttft_p99_s", "ticks",
                               "decode_tick_ms_p50")},
          paged_decode_launches=launches["paged_decode"],
          max_blocks_shared=run["max_shared"],
          prefix_hits=snap["prefix_hits"],
          peak_mem_gib=f"{run['peak'] / 2**30:.3f}")
    return launches, run["kv"]


def device_kernels(prof):
    """The profile's device kernels, largest device time first; user
    annotations (``record_function`` ranges such as the optimizer's step)
    carry device time too but span kernels already counted."""
    cuda = torch.autograd.DeviceType.CUDA
    return sorted((e for e in prof.key_averages() if e.device_type == cuda
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: -e.self_device_time_total)


def profile_decode(model, prompts, out_dir: str, n_ticks: int = 8,
                   paged: bool = True, tag: Optional[str] = None,
                   submit_kw=None, **engine_kw) -> dict:
    """``--profile``: the wall time of one step that admits 8 requests,
    then a window of steady decode ticks (8 slots live at depth ~390)
    under ``torch.profiler``, for the paged engine (``profile_decode``)
    or the row engine (``profile_row_decode``), or with ``engine_kw`` a
    speculative one (``tag`` names it). Prints the tick's wall
    time, the device-busy share of the window, K4's device time and
    kernel launches per tick (its split and merge kernels; none in the
    row engine) and the largest kernels by device time; writes the whole
    kernel table to ``out_dir``. A tenant engine (``submit_kw``: the
    requests' adapters and constraints) adds the LoRA delta's device time
    a tick: the profiler's device time of a ``record_function`` range
    wrapped around the tick's ``batched_lora_delta`` here (the engine
    carries no annotation). Returns the printed fields."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tag = tag or ("profile_decode" if paged else "profile_row_decode")
    eng = ServeEngine(model, paged=paged, max_slots=8, prefix_block_size=16,
                      **engine_kw)
    for p, kw in zip(prompts[:8], submit_kw or [{}] * 8):
        eng.submit(p, 32, **kw)
    real_delta = engine_mod.batched_lora_delta

    def annotated_delta(*args):
        with record_function("lora_delta"):
            return real_delta(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()  # admits all 8 (one cold prompt, seven prefix hits), ticks
    torch.cuda.synchronize()
    admit_ms = 1e3 * (time.perf_counter() - t0)
    eng.step()
    torch.cuda.synchronize()
    before = eng.metrics.tokens_emitted
    engine_mod.batched_lora_delta = annotated_delta
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_ticks):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        engine_mod.batched_lora_delta = real_delta
    kern = device_kernels(prof)
    cuda = torch.autograd.DeviceType.CUDA
    lora_us = sum(e.device_time_total for e in prof.key_averages()
                  if e.key == "lora_delta" and e.device_type == cuda)
    busy_us = sum(e.self_device_time_total for e in kern)
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    (pathlib.Path(out_dir) / f"{tag}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=60))
    top = ";".join(f"{e.key[:60]}:{e.self_device_time_total / n_ticks:.1f}us"
                   f"x{e.count // n_ticks}" for e in kern[:8])
    k4 = [e for e in kern if "paged_decode" in e.key]
    k4_ms = sum(e.self_device_time_total for e in k4) / 1e3 / n_ticks
    fields = dict(
        admit_step_ms=f"{admit_ms:.4f}", ticks=n_ticks,
        tokens_per_tick=(
            f"{(eng.metrics.tokens_emitted - before) / n_ticks:.4f}"),
        tick_ms=f"{1e3 * wall / n_ticks:.4f}",
        device_busy_ms_per_tick=f"{busy_us / 1e3 / n_ticks:.4f}",
        paged_decode_ms_per_tick=f"{k4_ms:.4f}",
        paged_decode_kernels_per_tick=sum(e.count for e in k4) // n_ticks,
        device_idle_share=(f"{1 - busy_us / 1e6 / wall:.4f}" if busy_us
                           else "not measured"))
    if eng.tenant_enabled:
        fields["lora_delta_device_ms_per_tick"] = (
            f"{lora_us / 1e3 / n_ticks:.4f}" if lora_us else "not measured")
    phase(tag, **fields, top_kernels_per_tick=top)
    return fields


# ---------------------------------------------------------- phase 8-10
FLASH_COUNTERS = ("flash_fwd", "flash_fwd_nolse", "flash_bwd_fused",
                  "flash_bwd_dq", "flash_bwd_dkv")
LM_KEYS = dict(input_key="tokens", target_key="targets")


def _train_both(optimizer: str, lr: float, steps: int, factory=None,
                **model_kw):
    """One seeded model (``factory``, default Llama-1B; depth 2, f32;
    drawn on the card and copied to the CPU: :func:`cpu_copy`)
    trained ``steps`` steps by the port's Trainer on the card (kernels)
    and on the CPU (plain versions), on the same batches. Returns the
    per-step losses of each, their largest relative difference and, per
    parameter, the card's and the CPU's trained value and last step's
    gradient."""
    factory = factory or Llama_1B
    cfg = dict(dict(vocab_size=VOCAB, depth=2, dtype=torch.float32),
               **model_kw)
    gpu_model = factory(**cfg, device=DEV, seed=2)
    cpu_model = cpu_copy(gpu_model, factory, **cfg, seed=2)
    data = SyntheticLanguageModeling(batch_size=2, seq_len=256,
                                     vocab_size=cfg["vocab_size"], seed=1)
    losses = {}
    for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        tr = Trainer(model, optimizer=optimizer, learning_rate=lr,
                     device=model.device, **LM_KEYS)
        hist = tr.fit(data, epochs=steps, steps_per_epoch=1, verbose=0)
        losses[name] = hist.history["loss"]
    cpu_params = dict(cpu_model.named_parameters())
    params = {n: (p.detach().cpu(), cpu_params[n].detach(), p.grad.cpu(),
                  cpu_params[n].grad)
              for n, p in gpu_model.named_parameters()}
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(losses["cuda"], losses["cpu"]))
    return losses, rel, params


def phase_train_parity(steps: int = 1, lr: float = 1e-4, sgd_lr: float = 1e-2):
    """AdamW (the optimizer path), then plain SGD, which keeps the two
    sides' parameters closest: the last step's gradient of every
    parameter on the card must equal the CPU's within GRAD_TOL of its
    max-abs, which a wrong dq, dk or dv from K2 breaks (AdamW's ±lr
    steps would hide it). Gradients are compared, not updates: an RMSNorm
    scale near 1 stores a 1e-5 update to within f32's 6e-8 rounding, so
    its update carries rounding of ~1e-3 relative."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    losses, rel, params = _train_both("adamw", lr, steps)
    max_diff = max(float((g - c).abs().max())
                   for g, c, _, _ in params.values())
    phase("train_parity", model="Llama_1B_depth2_f32", allow_tf32=False,
          optimizer="adamw", lr=lr, steps=steps,
          losses_cuda="/".join(f"{x:.7f}" for x in losses["cuda"]),
          losses_cpu="/".join(f"{x:.7f}" for x in losses["cpu"]),
          max_loss_rel_diff=f"{rel:.3g}",
          max_param_diff=f"{max_diff:.3g}",
          param_bound=f"{2 * lr * steps:g}")
    if not rel <= 1e-4:
        raise RuntimeError(f"train losses disagree: {losses}")
    if not max_diff <= 2 * lr * steps:
        raise RuntimeError(f"trained parameters differ by {max_diff}")
    del params
    _sgd_leg(steps, sgd_lr, "fused")
    # The long-context path at parity size: remat, and every backward
    # through K3a/K3b.
    with dispatch_threshold(0):
        _kernels.reset_launch_counts()
        _sgd_leg(steps, sgd_lr, "two_sweep_remat_dots", remat="dots")
    want = {"flash_fwd": 2 * 2 * steps, "flash_fwd_nolse": 0,
            "flash_bwd_fused": 0, "flash_bwd_dq": 2 * steps,
            "flash_bwd_dkv": 2 * steps}
    got = {k: _kernels.launch_counts[k] for k in want}
    if got != want:
        raise RuntimeError(f"remat parity leg launched {got}, want {want}")


def _sgd_leg(steps, lr, leg, **model_kw):
    """Train with sgd on the card and on the CPU; every parameter's
    last-step gradient must agree within GRAD_TOL of its max-abs."""
    losses, rel, params = _train_both("sgd", lr, steps, **model_kw)
    grad_rel = {}
    for name, (_, _, g, c) in params.items():
        scale = float(c.abs().max())
        if scale == 0.0:
            raise RuntimeError(f"{name} has a zero gradient on the CPU")
        grad_rel[name] = float((g - c).abs().max()) / scale
    worst = max(grad_rel, key=grad_rel.get)
    phase("train_parity", model="Llama_1B_depth2_f32", allow_tf32=False,
          optimizer="sgd", leg=leg, lr=lr, steps=steps,
          losses_cuda="/".join(f"{x:.7f}" for x in losses["cuda"]),
          losses_cpu="/".join(f"{x:.7f}" for x in losses["cpu"]),
          max_loss_rel_diff=f"{rel:.3g}",
          max_grad_rel_diff=f"{grad_rel[worst]:.3g}", worst_leaf=worst,
          grad_bound=f"{GRAD_TOL[torch.float32]:g}")
    if not rel <= 1e-5:
        raise RuntimeError(f"sgd train losses disagree ({leg}): {losses}")
    if not grad_rel[worst] <= GRAD_TOL[torch.float32]:
        raise RuntimeError(f"sgd gradients disagree ({leg}): {worst} by "
                           f"{grad_rel[worst]:.3g} of its max-abs")


def phase_train_converge():
    model = tiny_llama(vocab_size=64, embed_dim=64, attention="flash",
                       device=DEV, seed=0)
    tr = Trainer(model, optimizer="adamw", learning_rate=3e-3, device=DEV,
                 **LM_KEYS)
    _kernels.reset_launch_counts()
    hist = tr.fit(SyntheticLanguageModeling(batch_size=32, seq_len=64,
                                            vocab_size=64, seed=0),
                  epochs=3, steps_per_epoch=8, verbose=0)
    loss = hist.history["loss"]
    launches = {k: _kernels.launch_counts[k] for k in FLASH_COUNTERS}
    phase("train_converge", model="tiny_llama_E64_D2_H4/2_flash",
          steps=24, epoch_losses="/".join(f"{x:.5f}" for x in loss),
          epoch_accuracy="/".join(f"{x:.4f}" for x in
                                  hist.history["accuracy"]),
          launches=launches)
    if not loss[-1] < 0.7 * loss[0]:
        raise RuntimeError(f"tiny Llama did not learn: epoch losses {loss}")
    if launches["flash_fwd"] != 2 * 24 or launches["flash_bwd_fused"] != 48:
        raise RuntimeError(f"training did not run the flash kernels: "
                           f"{launches}")


def matmul_params(model) -> int:
    """N of 6ND: every parameter but the embeddings (Llama-1B's 1.236 B);
    for a GPT the blocks and the LM head's weight (GPT-2-small's
    123.7 M: 12 x 7.088 M + 768 x 50,304)."""
    if hasattr(model.stem, "token_embed"):
        return (sum(p.numel() for p in model.blocks.parameters())
                + model.head.lm_head.weight.numel())
    return (sum(p.numel() for p in model.parameters())
            - model.stem.embed.weight.numel())


def _timed_fit(model, batch: int, seq: int, warmup: int, steps: int):
    """adamw at lr 1e-4 on the synthetic LM task: ``warmup`` steps, then
    ``steps`` timed ones (host clock around ``Trainer.fit``, ending in a
    sync) with the launch counts set to 0 just before and the peak memory
    reset. Returns the trainer, the data, the history, the wall seconds,
    the launches, tokens/s, the 6ND MFU over :func:`matmul_params` and
    the peak memory."""
    n_matmul = matmul_params(model)
    tr = Trainer(model, optimizer="adamw", learning_rate=1e-4, device=DEV,
                 **LM_KEYS)
    data = SyntheticLanguageModeling(batch_size=batch, seq_len=seq,
                                     vocab_size=model.vocab_size, seed=0)
    tr.fit(data, epochs=1, steps_per_epoch=warmup, verbose=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = tr.fit(data.with_offset(warmup), epochs=steps, steps_per_epoch=1,
                  verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_kernels.launch_counts)
    tokens_s = batch * seq * steps / wall
    mfu = 6 * n_matmul * tokens_s / PEAK_FLOPS[torch.bfloat16]
    return (tr, data, hist, wall, counts, tokens_s, mfu,
            torch.cuda.max_memory_allocated())


def _train_fields(model, batch, seq, steps, hist, wall, counts, tokens_s,
                  mfu, peak):
    n_params = sum(p.numel() for p in model.parameters())
    return dict(params=n_params, matmul_params=matmul_params(model),
                batch=batch, seq=seq, steps=steps,
                wall_s=f"{wall:.4f}", ms_per_step=f"{1e3 * wall / steps:.3f}",
                tokens_per_s=f"{tokens_s:.2f}", mfu_6nd=f"{mfu:.4f}",
                peak_mem_gib=f"{peak / 2**30:.3f}",
                losses="/".join(f"{x:.5f}" for x in hist.history["loss"]),
                flash_per_step="/".join(f"{k}:{counts[k] / steps:g}"
                                        for k in FLASH_COUNTERS))


def phase_train_step(batch: int = 4, seq: int = 2048, warmup: int = 2,
                     steps: int = 5):
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, dtype=torch.bfloat16,
                     param_dtype=torch.float32, device=DEV, seed=0)
    tr, data, hist, wall, train_counts, tokens_s, mfu, peak = _timed_fit(
        model, batch, seq, warmup, steps)
    val = tr.evaluate(data.with_offset(warmup + steps), steps=1)
    launches = dict(_kernels.launch_counts)
    losses = hist.history["loss"] + [val["loss"]]
    depth = model.depth
    PHASE_FIGURES["train_step"] = _train_fields(
        model, batch, seq, steps, hist, wall, train_counts, tokens_s, mfu,
        peak)
    phase("train_step", model="Llama_1B_bf16_compute_f32_params",
          **PHASE_FIGURES["train_step"],
          eval_loss=f"{val['loss']:.5f}",
          eval_flash_fwd_nolse=launches["flash_fwd_nolse"])
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite training losses {losses}")
    want = {"flash_fwd": depth * steps, "flash_bwd_fused": depth * steps,
            "flash_fwd_nolse": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    got = {k: train_counts[k] for k in want}
    if got != want or launches["flash_fwd_nolse"] != depth or any(
            launches[k] != train_counts[k] for k in ("flash_fwd",
                                                     "flash_bwd_fused")):
        raise RuntimeError(f"flash launches {train_counts} over {steps} "
                           f"steps, {launches} after one eval batch, of a "
                           f"{depth}-layer model")
    return launches, tr, data


def phase_train_long(batch: int = 1, seq: int = 8192, warmup: int = 2,
                     steps: int = 5):
    """Long-context training: full Llama-1B with ``remat="dots"`` at
    B 1 x S 8192, whose backward takes the two sweeps."""
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, remat="dots", dtype=torch.bfloat16,
                     param_dtype=torch.float32, device=DEV, seed=0)
    tr, data, hist, wall, counts, tokens_s, mfu, peak = _timed_fit(
        model, batch, seq, warmup, steps)
    depth = model.depth
    PHASE_FIGURES["train_long"] = _train_fields(
        model, batch, seq, steps, hist, wall, counts, tokens_s, mfu, peak)
    phase("train_long", model="Llama_1B_remat_dots_bf16_compute_f32_params",
          **PHASE_FIGURES["train_long"])
    losses = hist.history["loss"]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite long-context losses {losses}")
    # K1 runs in the forward and again in the remat recompute; the
    # backward is K3a + K3b in every layer, never K2.
    want = {"flash_fwd": 2 * depth * steps, "flash_fwd_nolse": 0,
            "flash_bwd_fused": 0, "flash_bwd_dq": depth * steps,
            "flash_bwd_dkv": depth * steps}
    if {k: counts[k] for k in want} != want:
        raise RuntimeError(f"long-context launches {counts} over {steps} "
                           f"steps of a {depth}-layer model, want {want}")
    return counts, tr, data


def phase_fused_loss(seq: int = 8192, reps: int = 3):
    """``fused_lm_loss`` against the materialized logits and the trainer's
    cross-entropy on one forward+backward of Llama-1B at depth 2: the
    loss, every gradient, the ms (mean of ``reps`` after one warm-up) and
    the peak memory of each."""
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, depth=2, dtype=torch.bfloat16,
                     param_dtype=torch.float32, device=DEV, seed=3)
    batch = SyntheticLanguageModeling(batch_size=1, seq_len=seq,
                                      vocab_size=VOCAB, seed=2).batch(0)
    x = torch.as_tensor(batch["tokens"]).to(DEV)
    y = torch.as_tensor(batch["targets"]).to(DEV)
    paths = {"materialized": lambda: sparse_categorical_crossentropy(
                 model(x), y),
             "fused": lambda: fused_lm_loss(model, x, y)}
    out = {}
    for name, loss_fn in paths.items():
        model.zero_grad(set_to_none=True)
        loss_fn().backward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wall = 0.0
        for _ in range(reps):
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = loss_fn()
            loss.backward()
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
        out[name] = (loss.item(), 1e3 * wall / reps,
                     torch.cuda.max_memory_allocated(),
                     {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()})
        del loss
    ref, got = out["materialized"], out["fused"]
    rel = abs(got[0] - ref[0]) / abs(ref[0])
    grad_rel = {n: float((got[3][n] - g).abs().max()) / float(g.abs().max())
                for n, g in ref[3].items()}
    worst = max(grad_rel, key=grad_rel.get)
    phase("fused_loss", model="Llama_1B_depth2_bf16_compute_f32_params",
          batch=1, seq=seq, loss_materialized=f"{ref[0]:.6f}",
          loss_fused=f"{got[0]:.6f}", loss_rel_diff=f"{rel:.3g}",
          max_grad_rel_diff=f"{grad_rel[worst]:.3g}", worst_leaf=worst,
          ms_materialized=f"{ref[1]:.3f}", ms_fused=f"{got[1]:.3f}",
          peak_gib_materialized=f"{ref[2] / 2**30:.3f}",
          peak_gib_fused=f"{got[2] / 2**30:.3f}")
    if not (np.isfinite(got[0]) and rel <= 2e-3):
        raise RuntimeError(f"fused loss {got[0]} vs materialized {ref[0]}")
    if not grad_rel[worst] <= GRAD_TOL[torch.bfloat16]:
        raise RuntimeError(f"fused-loss gradients disagree: {worst} by "
                           f"{grad_rel[worst]:.3g} of its max-abs")


# --------------------------------------------------------- phase 13-15
def resnet_macs(model, image: int) -> int:
    """Multiply-accumulates of one image's forward at ``image`` x
    ``image``, from the model's own conv and dense shapes: each conv's
    output elements times its ``in x kh x kw`` taps (hooks on a batch-1
    inference forward, which leaves the BatchNorm buffers alone), plus
    the head's ``in x out``."""
    macs = []
    hooks = [m.register_forward_hook(
        lambda mod, _, out: macs.append(out[0].numel()
                                        * mod.weight[0].numel()))
        for m in model.modules() if isinstance(m, Conv)]
    with torch.no_grad():
        model(torch.zeros(1, image, image, 3, device=model.device),
              train=False)
    for h in hooks:
        h.remove()
    return sum(macs) + (model.head.weight.numel() if model.num_classes
                        else 0)


def phase_resnet_parity(steps: int = 2, lr: float = 0.005, batch: int = 4):
    """Full-width, full-depth ResNet-50 in f32 (TF32 off, cuDNN's
    algorithm search off), one seeded weight set trained by the port's
    Trainer on the card (cuDNN/ATen) and on the CPU with SGD at
    ``_train_1step``'s rate and the gradient norm logged, for each stem.

    First one free-running step on each side, gated: a BatchNorm net at
    init amplifies the two sides' rounding (cuDNN's and oneDNN's convs
    differ by ~1e-7), so after the first step free-running runs part, as
    ``__graft_entry__._train_1step`` notes of multi-step trajectories.
    Then ``steps`` steps each from one
    state, the CPU model's copied to the card, all gated: losses within
    rtol 1e-4, gradient norms within 1e-3 relative, parameters within
    2·lr·steps, each BatchNorm buffer within 1e-4 of its max-abs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    data = SyntheticImageClassification(batch_size=batch, image_size=224,
                                        num_classes=1000, seed=1)
    for stem in ("keras", "space_to_depth"):
        cpu_model = ResNet50(num_classes=1000, stem=stem, device="cpu",
                             seed=3)
        gpu_model = ResNet50(num_classes=1000, stem=stem, device=DEV)
        gpu_model.load_state_dict(cpu_model.state_dict())
        trainers = {m: Trainer(m, optimizer="sgd", learning_rate=lr,
                               log_grad_norm=True, device=m.device)
                    for m in (gpu_model, cpu_model)}
        free = {"loss": [], "grad_norm": []}
        synced = {"loss": [], "grad_norm": [], "param": [], "buffer": []}
        for step in range(1 + steps):
            if step >= 1:  # from here on each step starts from one state
                gpu_model.load_state_dict(cpu_model.state_dict())
            b = data.batch(step)
            g, c = (trainers[m].train_step(b) for m in (gpu_model, cpu_model))
            rel = {k: abs(float(g[k]) - float(c[k])) / abs(float(c[k]))
                   for k in ("loss", "grad_norm")}
            out = free if step < 1 else synced
            for k in rel:
                out[k].append((float(g[k]), float(c[k]), rel[k]))
            if step < 1:
                continue
            cpu_sd = cpu_model.state_dict()
            synced["param"].append(max(
                float((p.detach().cpu() - cpu_sd[n]).abs().max())
                for n, p in gpu_model.named_parameters()))
            synced["buffer"].append(max(
                (float((b_.cpu() - cpu_sd[n]).abs().max())
                 / float(cpu_sd[n].abs().max()), n)
                for n, b_ in gpu_model.named_buffers()))

        def seq(rows, i, fmt):
            return "/".join(format(r[i], fmt) for r in rows)

        worst = {k: max(r[2] for r in synced[k])
                 for k in ("loss", "grad_norm")}
        buf_rel, buf_name = max(synced["buffer"])
        param_diff = max(synced["param"])
        phase("resnet_parity", model="ResNet50_f32", stem=stem,
              allow_tf32=False, cudnn_benchmark=False, batch=batch,
              image=224, optimizer="sgd", lr=lr,
              free_losses_cuda=seq(free["loss"], 0, ".7f"),
              free_losses_cpu=seq(free["loss"], 1, ".7f"),
              free_grad_norms_cuda=seq(free["grad_norm"], 0, ".5f"),
              free_grad_norms_cpu=seq(free["grad_norm"], 1, ".5f"),
              free_loss_rel_diffs=seq(free["loss"], 2, ".3g"),
              free_grad_norm_rel_diffs=seq(free["grad_norm"], 2, ".3g"),
              synced_steps=steps,
              synced_losses_cuda=seq(synced["loss"], 0, ".7f"),
              synced_losses_cpu=seq(synced["loss"], 1, ".7f"),
              max_loss_rel_diff=f"{worst['loss']:.3g}", loss_rtol="1e-4",
              max_grad_norm_rel_diff=f"{worst['grad_norm']:.3g}",
              grad_norm_rtol="1e-3", max_param_diff=f"{param_diff:.3g}",
              param_bound=f"{2 * lr * steps:g}",
              max_buffer_rel_diff=f"{buf_rel:.3g}", worst_buffer=buf_name,
              buffer_bound="1e-4 of its max-abs")
        first = {k: free[k][0][2] for k in ("loss", "grad_norm")}
        if not (first["loss"] <= 1e-4 and worst["loss"] <= 1e-4):
            raise RuntimeError(f"ResNet-50 losses disagree ({stem}): "
                               f"{free['loss']} {synced['loss']}")
        if not (first["grad_norm"] <= 1e-3 and worst["grad_norm"] <= 1e-3):
            raise RuntimeError(f"ResNet-50 gradient norms disagree ({stem})"
                               f": {free['grad_norm']} "
                               f"{synced['grad_norm']}")
        if not param_diff <= 2 * lr * steps:
            raise RuntimeError(f"ResNet-50 parameters differ by "
                               f"{param_diff} ({stem})")
        if not buf_rel <= 1e-4:
            raise RuntimeError(f"ResNet-50 BatchNorm buffer {buf_name} "
                               f"differs by {buf_rel:.3g} of its max-abs")
        del cpu_model, gpu_model, trainers


def phase_resnet_converge(epochs: int = 8, steps: int = 16):
    """``tiny_resnet`` through ``Trainer.fit`` with the reference's
    augmentation and eval transform at 32x32, validation data and the
    reference's two callbacks (shortened patience). BatchNorm momentum
    0.5: at Keras' 0.99 the running averages of a 100-step run still
    carry their initial values, and the validation loss would measure
    that (``pddl_tpu/models/resnet.py``'s note on ``bn_momentum``)."""
    model = tiny_resnet(num_classes=10, bn_momentum=0.5, device=DEV, seed=0)
    tr = Trainer(model, optimizer="momentum", learning_rate=0.05,
                 device=DEV, augment=standard_augment(crop=32),
                 eval_transform=standard_eval_transform(crop=32))
    data = SyntheticImageClassification(batch_size=32, image_size=32,
                                        num_classes=10, seed=0)
    plateau = ReduceLROnPlateau(factor=0.5, patience=1)
    stop = EarlyStopping(patience=2, restore_best_weights=True)
    hist = tr.fit(data, epochs=epochs, steps_per_epoch=steps,
                  validation_data=data.with_offset(10**6),
                  validation_steps=2, callbacks=[plateau, stop], verbose=0)
    h = hist.history
    phase("resnet_converge", model="tiny_resnet_bn_momentum_0.5",
          image=32, batch=32, steps_per_epoch=steps,
          epochs_run=len(h["loss"]), stopped_epoch=stop.stopped_epoch,
          final_lr=f"{tr.optimizer.param_groups[0]['lr']:g}",
          epoch_losses="/".join(f"{x:.4f}" for x in h["loss"]),
          val_losses="/".join(f"{x:.4f}" for x in h["val_loss"]),
          val_accuracy="/".join(f"{x:.4f}" for x in h["val_accuracy"]))
    if not h["loss"][-1] < 0.7 * h["loss"][0]:
        raise RuntimeError(f"tiny ResNet did not learn: {h['loss']}")


def _timed_resnet(stem: str, batch: int, warmup: int, steps: int,
                  image: int = 224, strategy=None):
    """``bench.py``'s step through ``Trainer.train_step``: ResNet-50, bf16
    compute over f32 parameters, BatchNorm in train mode, adam at 1e-3,
    on a batch resident on the card; ``warmup`` steps, then ``steps``
    timed ones (host clock, ending in a sync)."""
    torch.cuda.empty_cache()
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, stem=stem,
                     device=DEV, seed=0)
    macs = resnet_macs(model, image)
    tr = Trainer(model, optimizer="adam", learning_rate=1e-3, metrics=(),
                 device=DEV, strategy=strategy)
    gen = torch.Generator(device=DEV).manual_seed(0)
    batch_d = {"image": torch.randn(batch, image, image, 3, generator=gen,
                                    device=DEV),
               "label": torch.randint(0, 1000, (batch,), generator=gen,
                                      device=DEV, dtype=torch.int32)}
    for _ in range(warmup):
        tr.train_step(batch_d)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        logs = tr.train_step(batch_d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss = float(logs["loss"])
    images_s = batch * steps / wall
    flops = 6 * macs  # 2 x MACs forward, x 3 for forward + backward
    fields = dict(model="ResNet50_bf16_compute_f32_params", stem=stem,
                  bn_mode="train", optimizer="adam", lr=1e-3, batch=batch,
                  image=image, warmup=warmup, steps=steps,
                  cudnn_benchmark=torch.backends.cudnn.benchmark,
                  wall_s=f"{wall:.4f}", ms_per_step=f"{1e3 * wall / steps:.3f}",
                  images_per_s=f"{images_s:.2f}",
                  peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
                  last_loss=f"{loss:.5f}", fwd_gmac_per_image=f"{macs / 1e9:.4f}",
                  train_gflop_per_image=f"{flops / 1e9:.4f}",
                  mfu=f"{flops * images_s / PEAK_FLOPS[torch.bfloat16]:.4f}")
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite ResNet-50 loss {loss} ({stem})")
    return tr, batch_d, fields


def phase_resnet_train(batch: int = 256):
    """``bench.py``'s configuration at B 256 x 224: a shorter leg with the
    Keras stem (2 warm-up and 10 timed steps), then the space-to-depth
    stem (bench.py's default; 3 warm-up and 20 timed steps), whose trainer
    and batch it returns with its images/s. cuDNN's algorithm search is on
    (``torch.backends.cudnn.benchmark = True``): every step has the same
    shapes, so the search runs in the warm-up."""
    torch.backends.cudnn.benchmark = True
    _, _, fields = _timed_resnet("keras", batch, 2, 10)
    phase("resnet_train", **fields)
    tr, batch_d, fields = _timed_resnet("space_to_depth", batch, 3, 20)
    phase("resnet_train", **fields)
    return tr, batch_d, float(fields["images_per_s"])


# Kernel classes of the ResNet step's profile, by kernel name; the first
# class whose words appear in a kernel's name takes it. The generic
# elementwise class holds the conv biases' adds (cuDNN adds the bias in a
# kernel of its own), the ReLUs, the residual adds and the casts.
RESNET_CLASSES = (
    ("batchnorm", ("batch_norm",)),
    ("adam", ("multi_tensor_apply",)),
    ("pooling", ("pool",)),
    ("reductions_and_loss", ("reduce_kernel", "softmax", "SoftMax", "nll")),
    ("elementwise_and_casts", ("elementwise", "copy", "fill", "Memset")),
    ("convolutions_and_gemm", ("conv", "xmma", "cudnn", "cutlass", "gemm",
                               "nvjet", "nhwc", "implicit")),
)


def profile_resnet(tr, batch_d, out_dir: str) -> None:
    """``--profile``: one ResNet-50 train step under ``torch.profiler``:
    its wall time, the device-busy share, device time by kernel class
    (convolutions, BatchNorm, elementwise and casts, adam, ...) and the
    largest kernels; the whole kernel table goes to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(batch_d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kern)
    by_class, other = {}, {}
    for e in kern:
        cls = next((c for c, words in RESNET_CLASSES
                    if any(w in e.key for w in words)), "other")
        ms, n = by_class.get(cls, (0.0, 0))
        by_class[cls] = (ms + e.self_device_time_total / 1e3, n + e.count)
        if cls == "other":
            other[e.key[:50]] = e.self_device_time_total / 1e3
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    (pathlib.Path(out_dir) / "profile_resnet.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=80))
    top = ";".join(f"{e.key[:60]}:{e.self_device_time_total / 1e3:.3f}ms"
                   f"x{e.count}" for e in kern[:10])
    phase("profile_resnet", model="ResNet50_bf16_s2d", batch=len(
              batch_d["label"]), step_ms=f"{1e3 * wall:.3f}",
          device_busy_ms=f"{busy_us / 1e3:.3f}",
          device_idle_share=(f"{1 - busy_us / 1e6 / wall:.4f}" if busy_us
                             else "not measured"),
          by_class=";".join(f"{c}:{ms:.3f}ms/{n}" for c, (ms, n) in
                            sorted(by_class.items(), key=lambda x: -x[1][0])),
          other=";".join(f"{k}:{v:.3f}ms" for k, v in other.items()),
          top_kernels=top)


# ------------------------------------------------------------ phase 15e-g
LOADER_SAMPLES = 2048     # 2,048 x 224 x 224 x 3 uint8: 308 MB of samples
LOADER_IMAGE = 224
HOST_FED_BATCH = 256      # bench.py's batch


def phase_keras_roundtrip(batch: int = 8):
    """The reference's pretrained mode at full width and depth: ResNet-50,
    1000 classes, f32 (TF32 off, cuDNN deterministic), on the card,
    through the mapping layer of ``ckpt/keras_import.py`` (no h5py: the
    file layer is the CPU tests'). A seeded model's Keras weight dict
    loads into a model of another seed: state_dicts and eval logits on a
    seeded batch of ``batch`` x 224 bitwise equal. The same dict loads
    into a space-to-depth model through ``s2d_stem_kernel``: logits within
    1e-4 of the largest logit (the same function in f32, the 4x4 stem
    summing the 7x7 taps in another order; the rounding differences, ~1e-7
    of a value, do not grow past 1e-5 through eval-mode BatchNorm). The
    dict without ``predictions`` loads into ``ResNet50(num_classes=10)``:
    the backbone equal, the head its own initialisation; with
    ``require_head=True`` it raises. Returns the notop dict."""
    _deterministic()
    torch.cuda.empty_cache()
    src = ResNet50(num_classes=1000, device=DEV, seed=0).eval()
    dst = ResNet50(num_classes=1000, device=DEV, seed=1).eval()
    _kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    weights = keras_weights_from_resnet(src)
    export_ms = 1e3 * (time.perf_counter() - t0)
    nbytes = sum(a.nbytes for w in weights.values() for a in w.values())
    t0 = time.perf_counter()
    keras_weights_to_resnet(weights, dst, require_head=True)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    bad = [k for k, v in dst.state_dict().items()
           if not torch.equal(v, src.state_dict()[k])]
    if bad:
        raise RuntimeError(f"keras round trip changed {len(bad)} tensors: "
                           f"{bad[:5]}")
    gen = torch.Generator(device=DEV).manual_seed(0)
    x = torch.rand(batch, 224, 224, 3, generator=gen, device=DEV)
    with torch.no_grad():
        ref = src(x, train=False)
        got = dst(x, train=False)
        s2d = keras_weights_to_resnet(weights, ResNet50(
            num_classes=1000, stem="space_to_depth", device=DEV,
            seed=2).eval())
        s2d_out = s2d(x, train=False)
    if not torch.equal(ref, got):
        raise RuntimeError("keras round trip: logits not bitwise equal")
    scale = float(ref.abs().max())
    s2d_err = float((s2d_out - ref).abs().max())
    if not s2d_err <= 1e-4 * max(1.0, scale):
        raise RuntimeError(f"space-to-depth import: logits {s2d_err:.3e} "
                           f"from the Keras stem's (scale {scale:.3e})")
    notop = {k: v for k, v in weights.items() if k != "predictions"}
    head10 = ResNet50(num_classes=10, device=DEV, seed=3)
    head = {k: v.clone() for k, v in head10.head.state_dict().items()}
    keras_weights_to_resnet(notop, head10)
    backbone = [k for k, v in head10.state_dict().items()
                if not k.startswith("head.")
                and not torch.equal(v, src.state_dict()[k])]
    head_kept = all(torch.equal(v, head[k])
                    for k, v in head10.head.state_dict().items())
    if backbone or not head_kept:
        raise RuntimeError(f"notop import: backbone differs at "
                           f"{backbone[:5]}, head kept {head_kept}")
    try:
        keras_weights_to_resnet(notop, head10, require_head=True)
    except ValueError as e:
        refused = str(e)
    else:
        raise RuntimeError("require_head=True accepted notop weights")
    launches = sum(_kernels.launch_counts.values())
    if launches:
        raise RuntimeError(f"the keras path launched {launches} kernels")
    phase("keras_roundtrip", model="ResNet50_f32", classes=1000,
          layers=len(weights), mbytes=f"{nbytes / 1e6:.2f}",
          export_ms=f"{export_ms:.2f}", load_ms=f"{load_ms:.2f}",
          state_bitwise=True, logits_bitwise=True, batch=batch,
          logit_scale=f"{scale:.4e}", s2d_max_abs_err=f"{s2d_err:.3e}",
          s2d_tol=f"{1e-4 * max(1.0, scale):.3e}", notop_backbone_equal=True,
          notop_head_kept=True, require_head_raises=refused[-40:],
          kernel_launches=launches)
    del src, dst, s2d, head10
    torch.cuda.empty_cache()
    return notop


def write_loader_file(path: str, n: int = LOADER_SAMPLES,
                      image: int = LOADER_IMAGE):
    """A seeded packed file of ``n`` samples: sample ``i``'s first 4 bytes
    are ``i`` (little-endian) and its label is ``i`` mod 1000 (a class of
    ResNet-50's head); the rest is random. Returns the images."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (n, image, image, 3), np.uint8)
    images.reshape(n, -1)[:, :4] = np.arange(n, dtype="<u4").view(
        np.uint8).reshape(n, 4)
    write_packed(path, images, np.arange(n, dtype=np.int32) % 1000)
    return images


def phase_native_loader(path: str, batch: int = HOST_FED_BATCH,
                        workers: int = 4):
    """Builds the loader's library from ``pddl_tpu_torch/data/csrc/``,
    writes the packed file at ``path`` (``LOADER_SAMPLES`` x 224 x 224 x 3
    uint8) and reads one shuffled epoch: every sample exactly once, with
    the file's bytes and label (its index in its first bytes). A second
    epoch, unchecked, times the loader alone (the file in the page
    cache: a warm read)."""
    t0 = time.perf_counter()
    lib = build_native()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    images = write_loader_file(path)
    write_s = time.perf_counter() - t0
    seen = []
    with NativeLoader([path], batch_size=batch, shuffle=True, seed=0,
                      num_workers=workers) as loader:
        for b in loader:
            index = b["image"].reshape(len(b["label"]), -1)[:, :4].copy(
            ).view("<u4")[:, 0].astype(np.int64)
            if not (np.array_equal(b["image"], images[index])
                    and np.array_equal(b["label"], index % 1000)):
                raise RuntimeError("native loader: a batch's bytes or "
                                   "labels differ from the file's")
            seen.append(index)
        t0 = time.perf_counter()
        n_read = sum(len(b["label"]) for b in loader)
        epoch_s = time.perf_counter() - t0
        shape = loader.image_shape
    seen = np.concatenate(seen)
    if not np.array_equal(np.sort(seen), np.arange(len(images))):
        raise RuntimeError(f"native loader: an epoch gave {len(seen)} "
                           f"samples, {len(np.unique(seen))} distinct")
    if np.array_equal(seen, np.arange(len(images))):
        raise RuntimeError("native loader: shuffle=True kept file order")
    nbytes = n_read * images[0].nbytes
    phase("native_loader", library=str(lib), build_s=f"{build_s:.2f}",
          samples=len(images), shape="x".join(map(str, shape)),
          file_mb=f"{os.path.getsize(path) / 1e6:.2f}",
          write_s=f"{write_s:.3f}", batch=batch, workers=workers,
          timed_epoch_s=f"{epoch_s:.3f}",
          host_gb_s=f"{nbytes / epoch_s / 1e9:.3f}",
          every_sample_once=True, bytes_equal=True)


def _host_fed_leg(tr, loader, prefetch: int, prof=None):
    """One epoch of ``tr.fit`` from ``loader``: images/s and the step wall
    between the first and the last batch end, and the last loss."""
    stamps = []
    torch.cuda.synchronize()
    hist = tr.fit(loader, epochs=1, verbose=0, prefetch=prefetch,
                  callbacks=[LambdaCallback(
                      on_train_batch_end=lambda s, logs: stamps.append(
                          time.perf_counter()))])
    torch.cuda.synchronize()
    wall = stamps[-1] - stamps[0]
    return (loader.batch_size * (len(stamps) - 1) / wall,
            wall / (len(stamps) - 1), hist.history["loss"][-1])


def _idle_share(tr, loader, prefetch: int):
    """One profiled epoch: the share of its wall with no kernel on the
    device (copies, which overlap kernels at ``prefetch`` > 0, are
    counted apart), its kernel and copy ms and its wall. The wall holds
    the epoch's start (the loader's reset and first batch) and the
    profiler's own cost."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.fit(loader, epochs=1, verbose=0, prefetch=prefetch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = device_kernels(prof)
    copy_us = sum(e.self_device_time_total for e in kern
                  if e.key.startswith(("Memcpy", "Memset")))
    busy_us = sum(e.self_device_time_total for e in kern) - copy_us
    return (f"{1 - busy_us / 1e6 / wall:.4f}" if busy_us else
            "not measured"), busy_us / 1e3, copy_us / 1e3, wall


def phase_resnet_host_fed(path: str, notop: dict, resident_images_s: float,
                          workers: int = 4):
    """The reference's pretrained fine-tune from packed files: a notop
    Keras dict (``phase_keras_roundtrip``'s) loads into bench.py's model
    (ResNet-50, bf16 compute over f32 parameters, space-to-depth stem,
    1000 classes, a fresh head), and ``Trainer.fit`` (adam at 1e-3) takes
    the ``NativeLoader``'s uint8 batches of 256 from ``path`` at
    ``prefetch`` 0 and 2 in turns (0, 2, 2, 0), one epoch each after a
    warm-up epoch: images/s, the step wall and the loss, then one
    profiled epoch at each: its idle share, and the steady step's (its
    kernel ms a step against the legs' step wall). Beside them, the
    card-resident figure of ``resnet_train`` in this run."""
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    torch.cuda.empty_cache()
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     stem="space_to_depth", device=DEV, seed=0)
    head = model.head.weight.detach().clone()
    t0 = time.perf_counter()
    keras_weights_to_resnet(notop, model)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(model.head.weight, head):
        raise RuntimeError("notop import changed the fresh head")
    tr = Trainer(model, optimizer="adam", learning_rate=1e-3, metrics=(),
                 device=DEV)
    rates = {0: [], 2: []}
    walls = {0: [], 2: []}
    losses = []
    _kernels.reset_launch_counts()
    with NativeLoader([path], batch_size=HOST_FED_BATCH, shuffle=True,
                      seed=0, num_workers=workers) as loader:
        _host_fed_leg(tr, loader, 0)  # warm-up: cuDNN's search, the pool
        for depth in (0, 2, 2, 0):
            rate, wall, loss = _host_fed_leg(tr, loader, depth)
            rates[depth].append(rate)
            walls[depth].append(wall)
            losses.append(loss)
        idle = {depth: _idle_share(tr, loader, depth) for depth in (0, 2)}
        steps = loader.batches_per_epoch
    launches = sum(_kernels.launch_counts.values())
    if launches:
        raise RuntimeError(f"the host-fed path launched {launches} kernels")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite host-fed losses {losses}")
    fields = {}
    for depth in (0, 2):
        share, busy_ms, copy_ms, wall = idle[depth]
        # The steady step's idle share: the profiled epoch's kernel time a
        # step against the unprofiled legs' step wall.
        step_idle = "/".join(f"{1 - busy_ms / 1e3 / steps / x:.4f}"
                             for x in walls[depth]) if busy_ms else (
                                 "not measured")
        fields.update({
            f"idle_share_step_prefetch{depth}": step_idle,
            f"images_per_s_prefetch{depth}": "/".join(
                f"{x:.2f}" for x in rates[depth]),
            f"step_ms_prefetch{depth}": "/".join(
                f"{1e3 * x:.3f}" for x in walls[depth]),
            f"idle_share_profiled_epoch_prefetch{depth}": share,
            f"profiled_epoch_s_prefetch{depth}": f"{wall:.3f}",
            f"kernel_ms_prefetch{depth}": f"{busy_ms:.3f}",
            f"copy_ms_prefetch{depth}": f"{copy_ms:.3f}"})
    best = max(rates[0] + rates[2])
    phase("resnet_host_fed", model="ResNet50_bf16_compute_f32_params",
          stem="space_to_depth", init="keras_notop_fresh_head",
          load_ms=f"{load_ms:.2f}", optimizer="adam", lr=1e-3,
          batch=HOST_FED_BATCH, image=LOADER_IMAGE, workers=workers,
          steps_per_epoch=steps, **fields,
          losses="/".join(f"{x:.5f}" for x in losses),
          resident_images_per_s=f"{resident_images_s:.2f}",
          host_fed_over_resident=f"{best / resident_images_s:.4f}",
          kernel_launches=launches)
    del tr, model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 15b-d
DP_STRATEGIES = ("single", "mirrored", "multiworker", "ps", "hvd")
DP_RUNS = (("sgd", 0.005, 3), ("adam", 1e-3, 1))
DP_WARMUP_EPOCHS = 2  # the hvd workflow's LearningRateWarmupCallback


@contextlib.contextmanager
def nccl_group_of_one():
    """The default process group, NCCL over this one card (world size 1):
    the data-parallel strategies' collectives run on it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
        device_id=DEV)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def dp_batches(n: int, rows: int, start: int = 0):
    """``n`` card-resident batches of ``rows`` 224² images (the synthetic
    set of phase 13), rows ``start`` to ``start + rows`` of each global
    batch of 32."""
    data = SyntheticImageClassification(batch_size=32, image_size=224,
                                        num_classes=1000, seed=1)
    return [{k: torch.from_numpy(v[start:start + rows]).to(DEV)
             for k, v in data.batch(i).items()} for i in range(n)]


def dp_strategy(name: str, backend=None):
    """The strategy ``name``, and the hvd workflow's optimizer wrapper and
    callbacks (``imagenet-resnet50-hvd.py``: ``DistributedOptimizer``,
    broadcast, metric average, warmup) when ``name`` is ``hvd``."""
    if name == "hvd":
        hvd.init(device=DEV, backend=backend)
        return MirroredStrategy(device=DEV, backend=backend)
    return get_strategy(name, device=DEV, **(
        {"backend": backend} if name in ("mirrored", "multiworker", "ps")
        else {}))


def dp_fit(strategy, name, opt, lr, steps, batches, log_grad_norm=False):
    """ResNet-50 (f32, seed 3) through ``Trainer.fit``, one batch an
    epoch; the hvd workflow (and its reference, ``name`` ``hvd_ref``) with
    the warmup callback. Returns the trainer and the loss history."""
    model = ResNet50(num_classes=1000, device=strategy.device
                     if strategy is not None else DEV, seed=3)
    optimizer = opt
    callbacks = []
    if name in ("hvd", "hvd_ref"):
        callbacks = [hvd.callbacks.LearningRateWarmupCallback(
            warmup_epochs=DP_WARMUP_EPOCHS)]
    if name == "hvd":
        optimizer = hvd.DistributedOptimizer(opt, learning_rate=lr)
        callbacks = [hvd.callbacks.BroadcastGlobalVariablesCallback(0),
                     hvd.callbacks.MetricAverageCallback()] + callbacks
    tr = Trainer(model, optimizer=optimizer, learning_rate=lr,
                 device=model.device, strategy=strategy,
                 log_grad_norm=log_grad_norm)
    hist = tr.fit(batches, epochs=steps, steps_per_epoch=1,
                  callbacks=callbacks, verbose=0)
    return tr, hist.history


def phase_dp_parity(batch: int = 32):
    """The reference's distribution modes at world size 1 on NCCL, each
    bitwise ``strategy=None``: full-width ResNet-50 in f32 (TF32 off,
    cuDNN deterministic), B ``batch`` x 224, 3 SGD steps and 1 Adam step
    through ``Trainer.fit`` under ``single``, ``mirrored``,
    ``multiworker``, ``ps`` (min 256 KiB, the reference's) and the hvd
    workflow (``DistributedOptimizer`` with its three callbacks, against
    ``strategy=None`` with the same warmup): the loss history, every
    parameter and every BatchNorm buffer. ``strategy=None`` runs twice
    first: the bitwise gate needs the step to repeat itself."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    batches = dp_batches(3, batch)
    try:
        for opt, lr, steps in DP_RUNS:
            refs = {}
            for name in ("none", "none_again", "hvd_ref"):
                tr, hist = dp_fit(None, name, opt, lr, steps, batches)
                refs[name] = (hist["loss"], tr.model.state_dict())
                del tr
            ok_repeat = _bitwise(refs["none"], refs["none_again"])
            results = {}
            for name in DP_STRATEGIES:
                strategy = dp_strategy(name)
                tr, hist = dp_fit(strategy, name, opt, lr, steps, batches)
                ref = refs["hvd_ref" if name == "hvd" else "none"]
                results[name] = _bitwise(ref, (hist["loss"],
                                               tr.model.state_dict()))
                del tr
            phase("dp_parity", model="ResNet50_f32", allow_tf32=False,
                  cudnn_deterministic=True, world_size=1, backend="nccl",
                  batch=batch, image=224, optimizer=opt, lr=lr, steps=steps,
                  ref_losses="/".join(f"{x:.7f}" for x in refs["none"][0]),
                  ref_repeats_bitwise=ok_repeat,
                  **{f"{k}_bitwise": v for k, v in results.items()})
            bad = [k for k, v in results.items() if not v]
            if not ok_repeat or bad:
                raise RuntimeError(
                    f"dp_parity ({opt}): not bitwise strategy=None's: "
                    f"{bad or 'strategy=None against itself'}")
    finally:
        torch.backends.cudnn.deterministic = False
    del batches
    torch.cuda.empty_cache()


def _bitwise(a, b) -> bool:
    (la, sa), (lb, sb) = a, b
    return la == lb and sa.keys() == sb.keys() and all(
        torch.equal(sa[k], sb[k]) for k in sa)


def _rel_buffers(sd, ref) -> float:
    return max(float((sd[k] - ref[k]).abs().max() / ref[k].abs().max())
               for k in ref if "running" in k)


def dp_gloo2_child(rank: int, port: int, out_dir: str) -> None:
    """One of two processes on the one card, joined over gloo with CUDA
    tensors: mirrored and ps (min 256 KiB), 1 SGD step and 1 Adam step at
    16 rows each (``rank``'s half of the global 32), from the same seeded
    ResNet-50; rank 0 also takes the single-device step at 32 rows. Writes
    what it saw to ``out_dir/dp_gloo2_{rank}.json``; then runs
    ``dp_ckpt_runs("run")`` for ``dp_ckpt_gloo2``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
        rank=rank)
    out = {"rank": rank}
    # Mirrored's one feeder: every process reads the global batch and
    # takes its rows; ps's processes each read their part.
    feeds = {"mirrored": dp_batches(1, 32),
             "ps": dp_batches(1, 16, start=16 * rank)}
    try:
        for opt, lr, _ in DP_RUNS:
            ref = None
            if rank == 0:
                tr, hist = dp_fit(None, "none", opt, lr, 1,
                                  feeds["mirrored"], log_grad_norm=True)
                ref = (hist, {k: v.clone() for k, v in
                              tr.model.state_dict().items()})
                out[f"{opt}_state_bytes_single"] = optimizer_state_bytes(
                    tr.optimizer)
                del tr
            for name in ("mirrored", "ps"):
                strategy = dp_strategy(name, backend="gloo")
                tr, hist = dp_fit(strategy, name, opt, lr, 1, feeds[name],
                                  log_grad_norm=True)
                sd = tr.model.state_dict()
                # Both processes end with the same state (gloo gathers
                # host tensors only).
                sums = torch.stack([v.double().sum()
                                    for v in sd.values()]).cpu()
                both = [torch.empty_like(sums) for _ in range(2)]
                torch.distributed.all_gather(both, sums)
                tag = f"{name}_{opt}"
                out[f"{tag}_ranks_equal"] = bool(torch.equal(*both))
                out[f"{tag}_state_bytes"] = optimizer_state_bytes(
                    tr.optimizer)
                if name == "ps":
                    out[f"{tag}_capped_leaves"] = strategy.capped_leaves
                    out[f"{tag}_sharded_leaves"] = sum(
                        pl.count > 1 for pl in strategy.placements(
                            tr.model).values())
                if ref is not None:
                    rh, rsd = ref
                    out[f"{tag}_loss_rel"] = abs(
                        hist["loss"][0] - rh["loss"][0]) / rh["loss"][0]
                    out[f"{tag}_grad_norm_rel"] = abs(
                        hist["grad_norm"][0] - rh["grad_norm"][0]) / \
                        rh["grad_norm"][0]
                    out[f"{tag}_param_diff"] = max(
                        float((sd[k] - rsd[k]).abs().max())
                        for k in rsd if "running" not in k)
                    out[f"{tag}_buffer_rel"] = _rel_buffers(sd, rsd)
                del tr
        # dp_ckpt_gloo2's uninterrupted and cut runs, in these processes.
        dp_ckpt_runs("run", rank, out_dir)
    finally:
        torch.distributed.destroy_process_group()
    path = pathlib.Path(out_dir) / f"dp_gloo2_{rank}.json"
    path.write_text(json.dumps(out))


def phase_dp_parity_gloo2(out_dir: str, timeout: float = 300.0):
    """Two processes on the one card over gloo with CUDA tensors
    (``dp_gloo2_child``), mirrored and ps against the single-device step:
    the loss within rtol 1e-4; the gradient norm within 5e-2 relative
    (``__graft_entry__._assert_matches_oracle``'s: a BatchNorm net at init
    amplifies the reduction order's f32 noise into ~1e-3 of the norm);
    every parameter within 2·lr (SGD) or 3·lr (Adam: a near-zero gradient
    whose sign flips moves its parameter 2·lr); each BatchNorm buffer
    within 1e-3 of its max-abs; both processes' states equal; ps's
    optimizer-state bytes a process against mirrored's, and its capped
    leaves. A child that fails fails the phase. The children also run
    ``dp_ckpt_gloo2``'s first runs into ``out_dir``."""
    out_dir = pathlib.Path(out_dir)
    _two_processes(lambda rank, port: ("--dp-gloo2-child", str(rank),
                                       str(port), str(out_dir)),
                   timeout, "dp_parity_gloo2")
    seen = [json.loads((out_dir / f"dp_gloo2_{r}.json").read_text())
            for r in range(2)]
    bad = []
    for opt, lr, _ in DP_RUNS:
        for name in ("mirrored", "ps"):
            tag = f"{name}_{opt}"
            r0 = seen[0]
            gates = {"loss_rel": 1e-4, "grad_norm_rel": 5e-2,
                     "param_diff": 3 * lr if opt == "adam" else 2 * lr,
                     "buffer_rel": 1e-3}
            fields = {k: f"{r0[f'{tag}_{k}']:.3g}" for k in gates}
            extra = {}
            if name == "ps":
                extra = dict(
                    capped_leaves=r0[f"{tag}_capped_leaves"],
                    sharded_leaves=r0[f"{tag}_sharded_leaves"],
                    state_bytes_per_rank="/".join(
                        str(x[f"{tag}_state_bytes"]) for x in seen),
                    mirrored_state_bytes=r0[f"mirrored_{opt}_state_bytes"])
            phase("dp_parity_gloo2", model="ResNet50_f32", processes=2,
                  backend="gloo", device="cuda:0 (shared)", rows=16,
                  global_batch=32, strategy=name, optimizer=opt, lr=lr,
                  steps=1, ranks_equal=all(x[f"{tag}_ranks_equal"]
                                           for x in seen),
                  **fields, **{f"{k}_bound": f"{v:g}"
                               for k, v in gates.items()}, **extra)
            bad += [f"{tag}_{k}" for k, lim in gates.items()
                    if not r0[f"{tag}_{k}"] <= lim]
            bad += [f"{tag}_ranks_equal" for x in seen
                    if not x[f"{tag}_ranks_equal"]]
    if bad:
        raise RuntimeError(f"dp_parity_gloo2 out of tolerance: {bad}")


def phase_dp_train(batch: int = 256, warmup: int = 3, steps: int = 10):
    """Phase 15's space-to-depth step at B ``batch`` under ``mirrored`` at
    world size 1 on NCCL beside ``strategy=None``, in turns (none,
    mirrored, mirrored, none): images/s of each and their ratio, the cost
    of the gradient all-reduce over a group of one and the rest of the
    strategy's step. A record, not a claim."""
    torch.backends.cudnn.benchmark = True
    rates = {"none": [], "mirrored": []}
    for name in ("none", "mirrored", "mirrored", "none"):
        strategy = None if name == "none" else MirroredStrategy(device=DEV)
        tr, _, fields = _timed_resnet("space_to_depth", batch, warmup, steps,
                                      strategy=strategy)
        rates[name].append(float(fields["images_per_s"]))
        phase("dp_train_leg", strategy=name, **fields)
        del tr
    mean = {k: sum(v) / len(v) for k, v in rates.items()}
    phase("dp_train", model="ResNet50_bf16_compute_f32_params",
          stem="space_to_depth", batch=batch, world_size=1, backend="nccl",
          images_per_s_none="/".join(f"{x:.2f}" for x in rates["none"]),
          images_per_s_mirrored="/".join(f"{x:.2f}"
                                         for x in rates["mirrored"]),
          ratio_mirrored_over_none=f"{mean['mirrored'] / mean['none']:.4f}")


def profile_train(tr, data, out_dir: str, tag: str = "train") -> None:
    """``--profile``: one train step under ``torch.profiler``: its wall
    time, the device-busy share and the largest kernels by device time;
    the whole kernel table goes to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(data.batch(100))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kern)
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    (pathlib.Path(out_dir) / f"profile_{tag}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=60))
    top = ";".join(f"{e.key[:60]}:{e.self_device_time_total / 1e3:.2f}ms"
                   f"x{e.count}" for e in kern[:12])
    phase(f"profile_{tag}", step_ms=f"{1e3 * wall:.3f}",
          device_busy_ms=f"{busy_us / 1e3:.3f}",
          device_idle_share=(f"{1 - busy_us / 1e6 / wall:.4f}" if busy_us
                             else "not measured"),
          top_kernels=top)


# ---------------------------------------------------------- phase 16-20
def phase_generate_parity():
    """``generate`` card against CPU, greedy, Llama-1B width at depth 2,
    f32 (TF32 off): a full-length cache (``max_len`` 1024, B 2, prompt 64,
    32 new) and a ring (``sliding_window=256``: ring 256 under 1024, B 1,
    prompt 384, 64 new — the ring wraps in the prefill and in decode, and
    the prefill runs K1 with its LSE on the card, once a layer)."""
    legs = (("full_cache", dict(max_len=MAX_LEN), 2, 64, 32),
            ("ring256", dict(max_len=MAX_LEN, sliding_window=256), 1, 384,
             64))
    rng = np.random.RandomState(6)
    for leg, cfg, batch, plen, new in legs:
        gpu_model, cpu_model = _parity_pair(depth=2, **cfg)
        prompt = rng.randint(0, VOCAB, (batch, plen))
        _kernels.reset_launch_counts()
        out = generate(gpu_model, prompt, new)
        torch.cuda.synchronize()
        launches = dict(_kernels.launch_counts)
        ref = generate(cpu_model, prompt, new)
        exact, ties = check_streams("row", out[:, plen:].cpu().tolist(),
                                    ref[:, plen:].tolist(), prompt.tolist(),
                                    cpu_model, new)
        want = gpu_model.depth if gpu_model.uses_ring_cache else 0
        if launches["flash_fwd"] != want or sum(launches.values()) != want:
            raise RuntimeError(f"generate_parity {leg}: launches {launches}, "
                               f"want {want} K1 with the LSE")
        phase("generate_parity", leg=leg, model="Llama_1B_depth2_f32",
              allow_tf32=False, batch=batch, prompt=plen, new=new,
              ring=gpu_model.uses_ring_cache, rows=batch, token_exact=exact,
              ties=ties, flash_fwd_launches=launches["flash_fwd"])
        del gpu_model, cpu_model


def weight_read_bound_tokens_s(model, prompt_len: int, new: int) -> float:
    """``decode_bench._roofline_tokens_per_sec`` for the card: every
    decoded token reads each matmul weight once (the embedding table is
    gathered, one row a token) and the live K/V prefix, averaged over the
    decode, at the HBM rate. An int8 model's weights count at their
    stored bytes (int8 and the f32 scales)."""
    params = sum(p.numel() * p.element_size()
                 for name, p in itertools.chain(model.named_parameters(),
                                                model.named_buffers())
                 if "embed" not in name)
    item = torch.finfo(model.dtype).bits // 8
    kv = (2 * model.depth * model.num_kv_heads * model.head_dim * item
          * (prompt_len + new / 2))
    return HBM_BYTES_PER_S / (params + model.embed_dim * item + kv)


def timed_generate(model, prompt, new, repeats):
    """Median wall of ``repeats`` greedy ``generate`` calls after one
    warm-up (host clock, ending in a sync), the output of the last one,
    and the launches of one call."""
    out = generate(model, prompt, new)
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = generate(model, prompt, new)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out = out.cpu()
    plen = prompt.shape[1]
    if out.shape != (prompt.shape[0], plen + new) or not (
            (out[:, plen:] >= 0) & (out[:, plen:] < model.vocab_size)).all():
        raise RuntimeError(f"generate gave {tuple(out.shape)} or a token "
                           "outside the vocabulary")
    return float(np.median(walls)), out, dict(_kernels.launch_counts)


def phase_generate_decode(profile_dir=None, new: int = 64,
                          plen: int = 64):
    """``benchmarks/decode_bench.py``'s configuration: Llama-1B, vocab
    128256, ``max_len`` 1024, bf16 parameters and compute, prompt 64,
    greedy, B 1 and B 8, with 64 new tokens (the bench's 256, cut for
    time); one timed call after a warm-up. The
    full-length row cache runs no hand-written kernel (the JAX package's
    decode runs none either). Returns the model and B 1's prompt,
    wall and tokens, for ``generate_spec``."""
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, max_len=MAX_LEN, dtype=torch.bfloat16,
                     device=DEV, seed=0)
    bound = weight_read_bound_tokens_s(model, plen, new)
    rng = np.random.RandomState(7)
    for batch in (1, 8):
        prompt = rng.randint(0, VOCAB, (batch, plen))
        torch.cuda.reset_peak_memory_stats()
        wall, out, launches = timed_generate(model, prompt, new, 1)
        if sum(launches.values()):
            raise RuntimeError(f"generate_decode launched {launches}")
        if batch == 1:
            b1 = (prompt, wall, out)
        tokens_s = batch * new / wall
        fields = dict(model="Llama_1B_bf16", max_len=MAX_LEN, batch=batch,
                      prompt=plen, new=new, wall_s=f"{wall:.4f}",
                      new_tokens_per_s=f"{tokens_s:.2f}",
                      ms_per_token=f"{1e3 * wall / new:.4f}",
                      peak_mem_gib=(
                          f"{torch.cuda.max_memory_allocated() / 2**30:.3f}"))
        if batch == 1:
            fields.update(weight_read_bound_tokens_per_s=f"{bound:.2f}",
                          ratio_to_bound=f"{tokens_s / bound:.4f}")
        phase("generate_decode", **fields)
    if profile_dir:
        profile_generate(model, rng.randint(0, VOCAB, (1, plen)), 64,
                         profile_dir)
    return (model,) + b1


def profile_generate(model, prompt, new, out_dir):
    """``--profile``: one B 1 ``generate`` of ``new`` tokens under
    ``torch.profiler``: the device-busy share of its wall and the largest
    kernels by device time; the kernel table goes to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    generate(model, prompt, 4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(model, prompt, new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kern)
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    (pathlib.Path(out_dir) / "profile_generate.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=60))
    top = ";".join(f"{e.key[:50]}:{e.self_device_time_total / new:.1f}us"
                   f"x{e.count // new}" for e in kern[:8])
    phase("profile_generate", batch=prompt.shape[0], new=new,
          ms_per_token=f"{1e3 * wall / new:.4f}",
          device_busy_ms_per_token=f"{busy_us / 1e3 / new:.4f}",
          device_idle_share=(f"{1 - busy_us / 1e6 / wall:.4f}" if busy_us
                             else "not measured"),
          top_kernels_per_token=top)


def windowed_fwd_bound_ms(q, k, window):
    """Least time of one causal windowed forward: 4·D flops for each
    (query, key) pair in the band, or q, k, v, o and lse moved once."""
    b, h, s, d = q.shape
    pairs = sum(min(i + 1, window) for i in range(s))
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + b * h * s * 4
    return _bound(nbytes, 4 * b * h * d * pairs, q.dtype)


def phase_generate_swa(plen: int = 2048, new: int = 128,
                       window: int = 1024, max_len: int = 4096):
    """A sliding-window Llama-1B (window 1024, ``max_len`` 4096: ring 1024),
    bf16, B 1, prompt 2048, 128 new: the prefill runs K1 with its LSE once
    a layer (16 launches, counted from zero around the call) merged with
    the pre-write ring's history. Prints tokens/s, the prefill's wall,
    K1's launches, the ring's cache bytes against a full-length cache's,
    and K1 at this shape (B 1, H 32/8, S 2048, D 64, window 1024) against
    its plain version, with its times. Returns the launches."""
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, max_len=max_len, sliding_window=window,
                     dtype=torch.bfloat16, device=DEV, seed=0)
    if not model.uses_ring_cache:
        raise RuntimeError("the sliding-window model has no ring cache")
    prompt = np.random.RandomState(8).randint(0, VOCAB, (1, plen))
    prefill_s, _, _ = timed_generate(model, prompt, 1, 3)
    torch.cuda.reset_peak_memory_stats()
    wall, _, launches = timed_generate(model, prompt, new, 1)
    if launches["flash_fwd"] != model.depth or sum(launches.values()) != \
            model.depth:
        raise RuntimeError(f"generate_swa launched {launches}; want "
                           f"{model.depth} K1 with the LSE")
    ring_bytes = pool_nbytes(decode_cache(model, 1))
    full_bytes = ring_bytes * max_len // model.blocks[0].attn.ring
    # K1 at the ring prefill's shape, against its plain version.
    gen = torch.Generator(device=DEV).manual_seed(9)
    qkv, _, _, kw = flash_case(gen, 1, 32, 8, plen, plen, 64, torch.bfloat16,
                               True, window, 0)
    o, lse = tatt.flash_forward(*qkv, **kw)
    ref_o, ref_lse = tatt.flash_forward_plain(*qkv, **kw)
    torch.cuda.synchronize()
    err = max(float((o.float() - ref_o.float()).abs().max()),
              float((lse - ref_lse).abs().max()))
    if not (torch.isfinite(o.float()).all() and err <= TOL[torch.bfloat16]):
        raise RuntimeError(f"K1 at the ring prefill's shape: error {err}")
    ms = cuda_ms(lambda i: tatt.flash_forward(*qkv, **kw), 1, iters=50)
    plain_ms = cuda_ms(lambda i: tatt.flash_forward_plain(*qkv, **kw), 1,
                       iters=4)
    pos = torch.arange(plen, device=DEV)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    library_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
        *qkv, attn_mask=band, enable_gqa=True), 1, iters=20)
    bound_ms, bound_by = windowed_fwd_bound_ms(qkv[0], qkv[1], window)
    phase("generate_swa", model=f"Llama_1B_bf16_window{window}",
          max_len=max_len,
          ring=model.blocks[0].attn.ring, batch=1, prompt=plen, new=new,
          wall_s=f"{wall:.4f}", new_tokens_per_s=f"{new / wall:.2f}",
          prefill_ms=f"{1e3 * prefill_s:.3f}",
          flash_fwd_launches=launches["flash_fwd"],
          ring_cache_bytes=ring_bytes, full_cache_bytes=full_bytes,
          peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    phase("generate_swa_k1",
          shape=f"B1_H32_Hkv8_S{plen}_D64_bf16_window{window}",
          max_abs_err=f"{err:.3g}", tol=TOL[torch.bfloat16],
          ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
          library_ms=f"{library_ms:.5f}", bound_ms=f"{bound_ms:.5f}",
          bound_by=bound_by)
    del model
    return launches


def phase_engine_row_parity():
    """``engine_parity``'s wave through the resident-row engine
    (``paged=False``), card against CPU: with the prefix cache and with
    ``prefix_cache_blocks=0``."""
    engine_parity_legs("engine_row_parity", [
        ("prefix_cache", {"paged": False}),
        ("prefix_off", {"paged": False, "prefix_cache_blocks": 0})])


def phase_engine_row_serve(model, prompts, paged_kv):
    """``engine_serve``'s wave with ``paged=False``: tokens/s, TTFT, the
    tick, the prefix cache's gather and donation copies, and
    ``resident_kv_report`` at the step with the most live tokens, beside
    the paged engine's at its own such step. The row path launches no
    hand-written kernel."""
    run = serve_wave(model, prompts, paged=False)
    if sum(run["launches"].values()):
        raise RuntimeError(f"the row engine launched {run['launches']}")
    metrics, kv = run["eng"].metrics, run["kv"]
    phase("engine_row_serve", model=serve_label(model), paged=False,
          **serve_fields(run), prefix_hits=run["snap"]["prefix_hits"],
          copy_bytes_gathered=metrics.copy_bytes_gathered,
          copy_bytes_donated=metrics.copy_bytes_donated,
          tokens_resident=kv["tokens_resident"],
          kv_bytes_used=kv["kv_bytes_used"],
          kv_bytes_allocated=kv["kv_bytes_allocated"],
          paged_tokens_resident=paged_kv["tokens_resident"],
          paged_kv_bytes_used=paged_kv["kv_bytes_used"],
          paged_kv_bytes_allocated=paged_kv["kv_bytes_allocated"],
          peak_mem_gib=f"{run['peak'] / 2**30:.3f}")


# ---------------------------------------------------------- phase 21-23
SPEC_K = 4
SPEC_MAX_LEN = 304      # the parity engines' cache: 256 + 48 ends at it
SPEC_ENGINE = dict(max_slots=4, prefill_len=256, prefix_block_size=16,
                   prefix_chunk=32)


def self_draft(model, depth: int):
    """The draft model of the speculative legs: ``model``'s embedding, its
    first ``depth`` blocks, final norm and head, copied into a
    depth-``depth`` Llama on the same device and in the same dtype."""
    draft = Llama_1B(vocab_size=model.vocab_size, max_len=model.max_len,
                     depth=depth, dtype=model.dtype, device=model.device)
    draft.load_state_dict({
        k: v for k, v in model.state_dict().items()
        if not k.startswith("blocks.") or int(k.split(".")[1]) < depth})
    return draft


def spec_parity_prompts(vocab: int = VOCAB):
    """4 repetitive prompts (a short random motif repeated, one with a
    random tail); the last is 256 tokens, so with 48 new tokens it ends
    at the cache's end and its last windows reach past it."""
    rng = np.random.RandomState(10)

    def loop(n):
        return np.resize(rng.randint(0, vocab, rng.randint(3, 8)), n)
    return [loop(40), loop(64),
            np.concatenate([loop(24), rng.randint(0, vocab, 24)]), loop(256)]


def spec_streams(model, prompts, new, **kw):
    """One engine on ``model``'s device over the parity prompts; returns
    the engine and the streams, every one run to LENGTH."""
    eng = ServeEngine(model, device=model.device, **SPEC_ENGINE, **kw)
    handles = [eng.submit(p, new) for p in prompts]
    eng.run(max_steps=1000)
    for i, h in enumerate(handles):
        if h.finish_reason is not FinishReason.LENGTH:
            raise RuntimeError(f"spec request {i}: {h.finish_reason}")
    return eng, [h.tokens for h in handles]


def spec_fields(snap):
    return dict(spec_ticks=snap["spec_ticks"],
                spec_drafted_tokens=snap["spec_drafted_tokens"],
                spec_accepted_tokens=snap["spec_accepted_tokens"],
                spec_acceptance_rate=(
                    "none" if snap["spec_acceptance_rate"] is None
                    else f"{snap['spec_acceptance_rate']:.4f}"))


def phase_engine_spec_parity(new: int = 48):
    """Speculative serving card against CPU and against the card's
    ``spec_k=0`` engine, greedy, Llama-1B width at depth 1 in f32 (TF32
    off), ``max_len`` 304: 4 repetitive prompts x 48 new tokens, ``spec_k``
    4, on the row engine, the paged engine with n-gram drafts and the
    paged engine with a draft model (the target's embedding, first block,
    final norm and head as a depth-1 Llama). Token-exact unless the CPU's
    top-2 margin at the divergence is < 1e-3. The draft leg's K4 launches
    are its draft model's single-token steps, ``(spec_k + 1)`` a layer a
    window; the n-gram legs launch none (the verify is multi-token). Then
    ``generate_speculative`` against ``generate`` at B 2. Returns the
    draft leg's launches."""
    gpu_model, cpu_model = _parity_pair(max_len=SPEC_MAX_LEN, depth=1)
    prompts = spec_parity_prompts()
    if len(prompts[-1]) + new != SPEC_MAX_LEN:
        raise RuntimeError("the edge request does not end at max_len")
    drafts = {"cuda": self_draft(gpu_model, 1), "cpu": self_draft(cpu_model, 1)}
    base = {}
    for paged in (False, True):
        _, base[paged] = spec_streams(gpu_model, prompts, new, paged=paged)
    draft_launches = None
    for leg, paged, with_draft in (("row", False, False),
                                   ("paged", True, False),
                                   ("draft", True, True)):
        streams, snaps = {}, {}
        for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
            kw = dict(paged=paged, spec_k=SPEC_K)
            if with_draft:
                kw["spec_draft_model"] = drafts[name]
            _kernels.reset_launch_counts()
            eng, streams[name] = spec_streams(model, prompts, new, **kw)
            if name == "cuda":
                torch.cuda.synchronize()
                launches = dict(_kernels.launch_counts)
            snaps[name] = eng.metrics.snapshot()
        # The draft leg's engine warms inside the window (it is built
        # there): its dead window runs the draft model's steps once more.
        want = (drafts["cuda"].depth * (SPEC_K + 1)
                * (snaps["cuda"]["spec_ticks"] + 1) if with_draft else 0)
        if launches["paged_decode"] != want or sum(launches.values()) != want:
            raise RuntimeError(f"engine_spec_parity {leg}: launches "
                               f"{launches}, want {want} paged_decode")
        if with_draft:
            draft_launches = launches
        exact, ties = check_streams(f"{leg} request", streams["cuda"],
                                    streams["cpu"], prompts, cpu_model, new)
        exact0, ties0 = check_streams(f"{leg} vs spec_k=0 request",
                                      streams["cuda"], base[paged], prompts,
                                      cpu_model, new)
        phase("engine_spec_parity", leg=leg, model="Llama_1B_depth1_f32",
              allow_tf32=False, max_len=SPEC_MAX_LEN, spec_k=SPEC_K,
              requests=len(prompts), new=new,
              edge_request_tokens=len(prompts[-1]) + len(streams["cuda"][-1]),
              token_exact_vs_cpu=exact, ties_vs_cpu=ties,
              token_exact_vs_spec0=exact0, ties_vs_spec0=ties0,
              paged_decode_launches=launches["paged_decode"],
              **spec_fields(snaps["cuda"]),
              cpu_spec_accepted_tokens=snaps["cpu"]["spec_accepted_tokens"])
    # The one-shot loop, B 2: against generate on the card, and the CPU.
    prompt = np.stack([np.resize(prompts[0], 64), np.resize(prompts[1], 64)])
    out, stats = generate_speculative(gpu_model, prompt, new,
                                      return_stats=True)
    ref = generate(gpu_model, prompt, new)
    cpu_out = generate_speculative(cpu_model, prompt, new)
    exact, ties = check_streams("generate_speculative row",
                                out[:, 64:].cpu().tolist(),
                                ref[:, 64:].cpu().tolist(), prompt.tolist(),
                                cpu_model, new)
    exact_cpu, ties_cpu = check_streams(
        "generate_speculative cpu row", out[:, 64:].cpu().tolist(),
        cpu_out[:, 64:].tolist(), prompt.tolist(), cpu_model, new)
    phase("engine_spec_parity", leg="generate_speculative",
          model="Llama_1B_depth1_f32", batch=2, prompt=64, new=new,
          draft_len=7, ngram=3, token_exact_vs_generate=exact,
          ties_vs_generate=ties, token_exact_vs_cpu=exact_cpu,
          ties_vs_cpu=ties_cpu, ticks=stats["ticks"],
          tokens_per_tick=f"{stats['tokens_per_tick']:.4f}")
    del gpu_model, cpu_model, drafts
    return draft_launches


def parted_streams(model, prompts, streams, base):
    """Streams equal to ``base``'s, and the card model's top-2 logit margin
    at each first divergence (the size of the near-tie where bf16's
    window and one-token computations parted)."""
    equal, margins = 0, []
    for prompt, a, b in zip(prompts, streams, base):
        j = next((i for i in range(len(b)) if a[i] != b[i]), None)
        if j is None:
            equal += 1
        else:
            margins.append(top2_margin(model, list(prompt) + b[:j]))
    return equal, (";".join(f"{m:.4g}" for m in margins) or "none")


def phase_engine_spec_serve(model, prompts, new: int = 32):
    """Phase 7's wave (Llama-1B bf16 at ``SERVE_DEPTH``, 24 requests of 384
    prompt tokens, 256 shared, on 8 slots, ``max_len`` 1024) with ``new``
    tokens: the row and paged engines at ``spec_k`` 0 and 4, and the paged
    engine with a depth-2 self-draft. Tokens/s, TTFT p50, the decode tick's
    p50, tokens per tick and per slot window, the acceptance rate, the
    streams equal to ``spec_k=0``'s and the margins where they part. The
    draft leg's K4 launches are exactly the draft's ``2 x (spec_k + 1)`` a
    window; no speed gate. Returns the draft leg's launches."""
    draft = self_draft(model, 2)
    runs = {}
    for leg, paged, kw in (
            ("row_spec0", False, {}),
            ("row_spec4", False, dict(spec_k=SPEC_K)),
            ("paged_spec0", True, {}),
            ("paged_spec4", True, dict(spec_k=SPEC_K)),
            ("paged_draft4", True, dict(spec_k=SPEC_K,
                                        spec_draft_model=draft))):
        run = serve_wave(model, prompts, paged, new=new,
                         telemetry_capacity=4096, **kw)
        runs[leg] = run
        snap, launches = run["snap"], run["launches"]
        decode_tokens = snap["tokens_emitted"] - len(prompts)
        fields = serve_fields(run)
        spec = {}
        if kw:
            windows = snap["spec_drafted_tokens"] // SPEC_K
            base = runs[leg.replace("spec4", "spec0").replace(
                "draft4", "spec0")]
            equal, margins = parted_streams(
                model, prompts, [h.tokens for h in run["handles"]],
                [h.tokens for h in base["handles"]])
            n = snap["spec_ticks"]
            spec = dict(**spec_fields(snap),
                        tokens_per_slot_window=(
                            f"{(windows + snap['spec_accepted_tokens']) / windows:.4f}"),
                        draft_host_ms_per_tick=(
                            f"{1e3 * run['host']['draft'] / n:.4f}"),
                        verify_host_ms_per_tick=(
                            f"{1e3 * run['host']['verify'] / n:.4f}"),
                        streams_equal_spec0=f"{equal}/{len(prompts)}",
                        parted_margins=margins)
        # K4 runs the paged one-token tick and the draft model's steps;
        # the verify and every prefill are multi-token (plain path).
        if leg == "paged_spec0":
            ok = launches["paged_decode"] >= model.depth * run["ticks"] > 0
        elif leg == "paged_draft4":
            ok = launches["paged_decode"] == (
                draft.depth * (SPEC_K + 1) * snap["spec_ticks"]) > 0
        else:
            ok = launches["paged_decode"] == 0
        if not ok or sum(launches.values()) != launches["paged_decode"]:
            raise RuntimeError(f"engine_spec_serve {leg}: launches "
                               f"{launches} over {run['ticks']} ticks")
        phase("engine_spec_serve", leg=leg, model=serve_label(model),
              new=new, **{k: fields[k] for k in (
                  "requests", "tokens", "wall_s", "tokens_per_s",
                  "ttft_p50_s", "ticks", "decode_tick_ms_p50")},
              tokens_per_tick=f"{decode_tokens / run['ticks']:.4f}",
              paged_decode_launches=launches["paged_decode"], **spec,
              peak_mem_gib=f"{run['peak'] / 2**30:.3f}")
    del draft
    return runs["paged_draft4"]["launches"]


def phase_generate_spec(model, prompt, wall, ref):
    """``generate_decode``'s B 1 leg (Llama-1B bf16, prompt 64, 64 new,
    the same model and prompt) through ``generate_speculative``
    (``draft_len`` 7, ``ngram`` 3), one timed call after a warm-up,
    beside that leg's ``generate`` (its ``wall`` and
    tokens ``ref``, timed just before): tokens/s, ms per token, ticks,
    tokens per tick. Tokens equal unless a tie: the card model's top-2
    margin at the divergence under 8 bf16 ulps of its top logit."""
    plen = prompt.shape[1]
    new = ref.shape[1] - plen
    spec_out, stats = generate_speculative(model, prompt, new,
                                           return_stats=True)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    spec_out, stats = generate_speculative(model, prompt, new,
                                           return_stats=True)
    torch.cuda.synchronize()
    spec_wall = time.perf_counter() - t0
    if sum(_kernels.launch_counts.values()):
        raise RuntimeError(f"generate_spec launched {_kernels.launch_counts}")
    a, b = spec_out[0, plen:].cpu().tolist(), ref[0, plen:].tolist()
    j = next((i for i in range(new) if a[i] != b[i]), None)
    margin = "none"
    if j is not None:
        with torch.no_grad():
            logits = model(torch.tensor([list(prompt[0]) + b[:j]],
                                        device=DEV))[0, -1].float()
        top = torch.topk(logits, 2).values
        ulp = 2.0 ** (np.floor(np.log2(abs(float(top[0])))) - 7)
        margin = float(top[0] - top[1])
        if margin >= 8 * ulp:
            raise RuntimeError(
                f"generate_speculative parts from generate at token {j} "
                f"with a top-2 margin of {margin:.4g} >= 8 bf16 ulps "
                f"({8 * ulp:.4g})")
    phase("generate_spec", model="Llama_1B_bf16", max_len=MAX_LEN, batch=1,
          prompt=plen, new=new, draft_len=7, ngram=3,
          wall_s=f"{spec_wall:.4f}", new_tokens_per_s=f"{new / spec_wall:.2f}",
          ms_per_token=f"{1e3 * spec_wall / new:.4f}", ticks=stats["ticks"],
          tokens_per_tick=f"{stats['tokens_per_tick']:.4f}",
          generate_wall_s=f"{wall:.4f}",
          generate_new_tokens_per_s=f"{new / wall:.2f}",
          equal_to_generate=j is None, parted_at=j, parted_margin=margin)


# ---------------------------------------------------------- phase 24-25
TENANT_RANK = 8
VOCAB32 = (list("0123456789") + list('{}[]":,.-') + ["true", "false"]
           + list("abcdefghijk"))   # tests/test_serve_tenant.py's
# The serve wave's schema; its integer is open-ended, so a stream may end
# at LENGTH mid-document. The parity legs' schema is bounded: every
# stream completes (GRAMMAR) within 32 tokens.
SERVE_SCHEMA = {"type": "object", "properties": {
    "id": {"type": "integer"}, "ok": {"type": "boolean"}}}
PARITY_SCHEMA = {"type": "object", "properties": {
    "id": {"enum": [7, 42]}, "ok": {"type": "boolean"}}}


def tenant_token_strings(vocab: int = VOCAB) -> list:
    """A token-id -> string vocabulary for every id of ``vocab``:
    ``VOCAB32`` first, then seeded strings of 1-4 printable ASCII
    characters."""
    rng = np.random.RandomState(32)
    chars = np.array([chr(c) for c in range(32, 127)])
    n = vocab - len(VOCAB32)
    lens = rng.randint(1, 5, n)
    picks = rng.randint(0, len(chars), (n, 4))
    return VOCAB32 + ["".join(chars[picks[i, :k]])
                      for i, k in enumerate(lens)]


def tenant_registry(model, n: int) -> AdapterRegistry:
    reg = AdapterRegistry(model.embed_dim, model.vocab_size,
                          rank=TENANT_RANK)
    for i in range(n):
        reg.register_random(f"adapter{i}", seed=100 + i, scale=0.05)
    return reg


def tenant_margin(model, registry, kw, prompt, prefix) -> float:
    """The top-2 margin of the logits a tenant slot samples from after
    ``prompt + prefix``: the merged head for an adapter, masked by the
    constraint's state there."""
    if kw.get("adapter"):
        ad = registry.get(kw["adapter"])
        model = merge_lora_into_head(model, ad.a, ad.b)
    with torch.no_grad():
        logits = model(torch.tensor([list(prompt) + list(prefix)],
                                    device=model.device))[0, -1].float()
    if kw.get("constraint"):
        fsm = compile_constraint(kw["constraint"], tenant_token_strings())
        mask = fsm.allow_row(fsm.advance_many(prefix))
        logits[~torch.from_numpy(mask).to(logits.device)] = -torch.inf
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def check_tenant_streams(what, streams, ref, prompts, kws, cpu_model,
                         registry):
    """Token-exact, unless the CPU's top-2 margin (under the slot's
    adapter and mask) at the first divergence is < 1e-3 (a tie). Streams
    of unequal length that agree throughout fail."""
    exact, ties = 0, []
    for i, (a, b) in enumerate(zip(streams, ref)):
        j = next((t for t in range(min(len(a), len(b))) if a[t] != b[t]),
                 None)
        if j is None:
            if len(a) != len(b):
                raise RuntimeError(f"{what} {i}: {len(a)} against "
                                   f"{len(b)} tokens")
            exact += 1
            continue
        margin = tenant_margin(cpu_model, registry, kws[i], prompts[i],
                               b[:j])
        if margin >= 1e-3:
            raise RuntimeError(f"{what} {i} diverges at token {j} with a "
                               f"CPU top-2 margin of {margin:.3g} >= 1e-3")
        ties.append(f"req{i}@{j}:margin={margin:.3g}")
    return exact, ";".join(ties) or "none"


def tenant_engine(model, registry, strings, **kw):
    return ServeEngine(model, device=model.device, max_slots=4,
                       prefill_len=128, prefix_block_size=16,
                       tenant=TenantConfig(registry=registry,
                                           token_strings=strings), **kw)


def recorded_run(eng, prompts, kws, news):
    """Run one engine over the requests, recording every logits tensor it
    samples from (admissions ``[1, V]``, ticks ``[S, V]``) and its K4
    launches; returns ``(streams, finishes, logits, launches, ticks)``."""
    log = []
    real = engine_mod.sample_logits_batched

    def spy(rng, logits, **skw):
        log.append(logits.detach().clone())
        return real(rng, logits, **skw)
    engine_mod.sample_logits_batched = spy
    try:
        _kernels.reset_launch_counts()
        handles = [eng.submit(p, n, **kw)
                   for p, kw, n in zip(prompts, kws, news)]
        eng.run(max_steps=400)
        launches = dict(_kernels.launch_counts)
    finally:
        engine_mod.sample_logits_batched = real
    ticks = sum(1 for r in eng.telemetry.snapshot() if r["live_slots"] > 0)
    return ([h.tokens for h in handles], [h.finish_reason for h in handles],
            log, launches, ticks)


def phase_engine_tenant_parity():
    """Multi-tenant serving card against CPU, greedy, Llama-1B width at
    depth 2 in f32 (TF32 off), ``engine_parity``'s 4 prompts: a base
    request, an adapter, an adapter under a bounded JSON schema and the
    schema alone (rank-8 adapters, scale 0.05, the seeded 128,256-string
    grammar vocabulary), in both modes. Token-exact card against CPU
    (unless a tie under the slot's adapter and mask); the base slot's
    logits bitwise equal to the card's ``tenant=None`` engine's at its
    admission and at every tick before a stream ends; the adapted
    streams equal ``generate`` over the merged head; the constrained
    streams complete their grammar; a ``spec_k=4`` n-gram leg equal to
    ``spec_k=0``; K4 launched exactly once a layer a tick on the paged
    legs (none in the speculative leg: its verify is multi-token).
    Returns the paged legs' launches."""
    gpu_model, cpu_model = _parity_pair(max_len=MAX_LEN, depth=2)
    strings = tenant_token_strings()
    registry = tenant_registry(gpu_model, 2)
    prompts = parity_prompts()
    spec = {"kind": "json_schema", "schema": PARITY_SCHEMA}
    kws = [{}, {"adapter": "adapter0"},
           {"adapter": "adapter1", "constraint": spec}, {"constraint": spec}]
    news = [16, 16, 32, 32]
    fsm = compile_constraint(spec, strings)
    paged_launches = {}
    for paged in (False, True):
        mode = "paged" if paged else "row"
        plain = ServeEngine(gpu_model, device=DEV, max_slots=4,
                            prefill_len=128, prefix_block_size=16,
                            paged=paged)
        p_streams, _, p_log, _, _ = recorded_run(plain, prompts,
                                                 [{}] * 4, news)
        eng = tenant_engine(gpu_model, registry, strings, paged=paged)
        streams, finishes, t_log, launches, ticks = recorded_run(
            eng, prompts, kws, news)
        torch.cuda.synchronize()
        want = gpu_model.depth * ticks if paged else 0
        if launches["paged_decode"] != want or sum(launches.values()) != want:
            raise RuntimeError(f"engine_tenant_parity {mode}: launches "
                               f"{launches}, want {want} paged_decode")
        if paged:
            paged_launches = launches
        # The base request holds slot 0 and is admitted first in both.
        if not torch.equal(t_log[0], p_log[0]):
            raise RuntimeError(f"{mode}: the base admission's logits differ "
                               "from the tenant=None engine's")
        first_end = min(len(t) for t in streams)
        compared = 0
        for step, (a, b) in enumerate(zip(t_log[4:], p_log[4:])):
            if step + 2 > first_end:  # a stream ended: the batches differ
                break
            if not torch.equal(a[0], b[0]):
                raise RuntimeError(f"{mode}: the base slot's tick {step} "
                                   "logits differ from tenant=None's")
            compared += 1
        if compared < 8 or p_streams[0] != streams[0]:
            raise RuntimeError(f"{mode}: {compared} ticks compared")
        cpu_eng = tenant_engine(cpu_model, registry, strings, paged=paged)
        cpu_streams = recorded_run(cpu_eng, prompts, kws, news)[0]
        exact, ties = check_tenant_streams(
            f"{mode} request", streams, cpu_streams, prompts, kws,
            cpu_model, registry)
        # The unconstrained adapter stream against generate() over the
        # merged head, on the card.
        ad = registry.get(kws[1]["adapter"])
        m = merge_lora_into_head(gpu_model, ad.a, ad.b)
        out = generate(m, torch.tensor(prompts[1][None], device=DEV),
                       news[1])
        merged = [out[0, len(prompts[1]):].cpu().tolist()]
        del m
        exact_m, ties_m = check_tenant_streams(
            f"{mode} merged-head", streams[1:2], merged, prompts[1:2],
            kws[1:2], cpu_model, registry)
        for i in (2, 3):
            if finishes[i] is not FinishReason.GRAMMAR or not fsm.accepts(
                    streams[i], eos_token=eng.eos_token):
                raise RuntimeError(f"{mode} constrained request {i}: "
                                   f"{finishes[i]}, {len(streams[i])} tokens")
        _kernels.reset_launch_counts()
        spec_eng = tenant_engine(gpu_model, registry, strings, paged=paged,
                                 spec_k=SPEC_K)
        spec_streams = recorded_run(spec_eng, prompts, kws, news)[0]
        torch.cuda.synchronize()
        if _kernels.launch_counts["paged_decode"]:
            raise RuntimeError(f"{mode} spec leg launched "
                               f"{_kernels.launch_counts}")
        exact_s, ties_s = check_tenant_streams(
            f"{mode} spec_k=4 vs spec_k=0", spec_streams, streams, prompts,
            kws, cpu_model, registry)
        snap = eng.metrics.snapshot()
        phase("engine_tenant_parity", mode=mode, model="Llama_1B_depth2_f32",
              allow_tf32=False, requests=len(prompts),
              adapters=len(registry), rank=TENANT_RANK,
              token_exact_vs_cpu=exact, ties_vs_cpu=ties,
              base_logits_bitwise_ticks=compared,
              adapter_exact_vs_merged_generate=exact_m,
              ties_vs_merged=ties_m,
              grammar_complete=sum(f is FinishReason.GRAMMAR
                                   for f in finishes),
              constrained_tokens=",".join(str(len(streams[i]))
                                          for i in (2, 3)),
              spec4_token_exact_vs_spec0=exact_s, ties_vs_spec0=ties_s,
              spec_accepted_tokens=spec_eng.metrics.spec_accepted_tokens,
              adapter_loads=snap["adapter_loads"],
              paged_decode_launches=launches["paged_decode"], ticks=ticks)
    del gpu_model, cpu_model
    return paged_launches


def tenant_submit_kw(n: int) -> list:
    """The tenant wave's requests: every 4th on the base model, the rest
    alternately on 4 popular adapters and on a tail of 12 others (13
    distinct adapters over the wave, more than the 12-row pool's 11
    usable rows: popular adapters hit, the tail evicts), every 3rd under
    ``SERVE_SCHEMA``."""
    kws, k = [], 0
    for i in range(n):
        kw = {}
        if i % 4:
            kw["adapter"] = (f"adapter{(k // 2) % 4}" if k % 2 == 0
                             else f"adapter{4 + (k // 2) % 12}")
            k += 1
        if i % 3 == 0:
            kw["constraint"] = {"kind": "json_schema",
                                "schema": SERVE_SCHEMA}
        kws.append(kw)
    return kws


def tenant_tick_pairs(model, prompts, paged: bool, strings,
                      pairs: int = 48):
    """The tenant tick's host cost against the plain tick's, paired: a
    plain engine and a tenant engine, each with 8 of the wave's requests
    live (the tenant one with the wave's adapters, and in place of its
    schema the open-ended ``([0-9][a-z])+``, whose state alternates, so
    its mask row changes and restages every tick and no stream ends
    early), step in turns; returns the median step wall of each over
    ``pairs`` pairs after 3 warm-up steps (every step is a pure decode
    tick ending in the tick's device-to-host copy), and the tenant
    engine's mask restages."""
    loop = {"kind": "regex", "pattern": "([0-9][a-z])+"}
    kws = [dict(kw, constraint=loop) if "constraint" in kw else kw
           for kw in tenant_submit_kw(8)]
    engines = {
        "plain": ServeEngine(model, paged=paged, max_slots=8,
                             prefix_block_size=16),
        "tenant": ServeEngine(model, paged=paged, max_slots=8,
                              prefix_block_size=16, tenant=TenantConfig(
                                  registry=tenant_registry(model, 16),
                                  token_strings=strings))}
    for name, eng in engines.items():
        for p, kw in zip(prompts[:8], kws):
            eng.submit(p, pairs + 8, **(kw if name == "tenant" else {}))
        for _ in range(3):
            eng.step()
    walls = {name: [] for name in engines}
    for i in range(pairs):
        order = ("plain", "tenant") if i % 2 == 0 else ("tenant", "plain")
        for name in order:
            eng = engines[name]
            t0 = time.perf_counter()
            eng.step()
            walls[name].append(time.perf_counter() - t0)
            if eng.live_slots != 8:
                raise RuntimeError(f"{name}: {eng.live_slots} slots live")
    restages = engines["tenant"].metrics.mask_restages
    del engines
    return ({name: 1e3 * float(np.median(w)) for name, w in walls.items()},
            restages)


def phase_engine_tenant_serve(model, prompts, out_dir: str):
    """Phase 7's wave (Llama-1B at ``SERVE_DEPTH``, bf16, ``max_len``
    1024, 24 greedy
    requests of 384 prompt tokens, 256 shared, x 32 new on 8 slots) in
    both modes, ``tenant=None`` and a tenant engine, one wave each: 16
    rank-8 adapters, the pool auto-sized to 12
    rows, every 4th request on the base model and every 3rd under a JSON
    schema, over the seeded 128,256-string vocabulary (the FSM compiled
    and timed before the waves). Per wave: tokens/s, the tick's p50, TTFT
    p50/p99, K4's launches (exactly one a layer a tick on the paged
    legs); per tenant wave: adapter hits, loads and evictions (the mix
    must hit and evict), mask restages a tick, the pool's and the tick's
    gathered factor bytes, the base streams equal to the plain wave's and
    the margins where they part. Then per mode the tenant tick's median
    against the plain tick's, over 48 ticks of each in turns
    (:func:`tenant_tick_pairs`) and over the two waves, and a
    profiled window of 4 ticks of each engine (device busy, idle share,
    the LoRA delta's device time). Constrained streams are mask-legal, and
    accepted when they end GRAMMAR. Returns the first paged tenant wave's
    launches."""
    strings = tenant_token_strings()
    spec = {"kind": "json_schema", "schema": SERVE_SCHEMA}
    t0 = time.perf_counter()
    fsm = compile_constraint(spec, strings)
    compile_s = time.perf_counter() - t0
    kws = tenant_submit_kw(len(prompts))
    base_ids = [i for i, kw in enumerate(kws) if not kw]
    launches_out = None
    for paged in (False, True):
        mode = "paged" if paged else "row"
        runs = {"plain": [], "tenant": []}
        for leg in ("plain", "tenant"):
            registry = tenant_registry(model, 16)
            tkw = ({} if leg == "plain" else dict(
                submit_kw=kws, tenant=TenantConfig(registry=registry,
                                                   token_strings=strings)))
            run = serve_wave(model, prompts, paged, **tkw)
            runs[leg].append(run)
            eng, snap, launches = run["eng"], run["snap"], run["launches"]
            want = model.depth * run["ticks"] if paged else 0
            if launches["paged_decode"] != want or \
                    sum(launches.values()) != want:
                raise RuntimeError(f"engine_tenant_serve {mode} {leg}: "
                                   f"launches {launches}, want {want}")
            fields = serve_fields(run)
            extra = {}
            if leg == "tenant":
                done = 0
                for h, kw in zip(run["handles"], kws):
                    if kw.get("constraint") is None:
                        continue
                    state = fsm.advance_many(h.tokens)  # raises if illegal
                    if h.finish_reason is FinishReason.GRAMMAR:
                        done += 1
                        if not fsm.accepting[state]:
                            raise RuntimeError("a GRAMMAR stream is not "
                                               "accepted")
                equal, margins = parted_streams(
                    model, [prompts[i] for i in base_ids],
                    [run["handles"][i].tokens for i in base_ids],
                    [runs["plain"][0]["handles"][i].tokens
                     for i in base_ids])
                extra = dict(
                    adapters=len(registry), pool_rows=eng._apool.slots,
                    adapter_hits=snap["adapter_hits"],
                    adapter_loads=snap["adapter_loads"],
                    adapter_evictions=snap["adapter_evictions"],
                    constrained_requests=snap["constrained_requests"],
                    grammar_complete=done,
                    fsm_states=fsm.n_states,
                    fsm_compile_s=f"{compile_s:.4f}",
                    mask_restages=eng.metrics.mask_restages,
                    mask_restages_per_tick=(
                        f"{eng.metrics.mask_restages / run['ticks']:.4f}"),
                    pool_bytes=(eng._apool_a.nbytes + eng._apool_b.nbytes),
                    tick_gathered_b_bytes=(eng.max_slots * TENANT_RANK
                                           * model.vocab_size * 4),
                    base_streams_equal_plain=f"{equal}/{len(base_ids)}",
                    base_parted_margins=margins)
                if launches_out is None and paged:
                    launches_out = launches
            phase("engine_tenant_serve", mode=mode, leg=leg,
                  model=serve_label(model), **{k: fields[k] for k in (
                      "requests", "tokens", "wall_s", "tokens_per_s",
                      "ttft_p50_s", "ttft_p99_s", "ticks",
                      "decode_tick_ms_p50")},
                  paged_decode_launches=launches["paged_decode"], **extra,
                  peak_mem_gib=f"{run['peak'] / 2**30:.3f}")
            if leg == "tenant" and (snap["adapter_evictions"] < 1
                                    or snap["adapter_hits"] < 1):
                raise RuntimeError(f"the tenant wave evicted "
                                   f"{snap['adapter_evictions']} adapters "
                                   f"and hit {snap['adapter_hits']}")
        wave_tick = {leg: 1e3 * float(np.median(
            [t for r in rs for t in r["tick_s"]])) for leg, rs in runs.items()}
        rate = {leg: float(np.mean([float(serve_fields(r)["tokens_per_s"])
                                    for r in rs])) for leg, rs in runs.items()}
        tick, pair_restages = tenant_tick_pairs(model, prompts, paged,
                                                strings)
        profiled = {}
        for leg in ("plain", "tenant"):
            tkw = ({} if leg == "plain" else dict(
                submit_kw=kws, tenant=TenantConfig(
                    registry=tenant_registry(model, 16),
                    token_strings=strings)))
            profiled[leg] = profile_decode(model, prompts, out_dir,
                                           n_ticks=4, paged=paged,
                                           tag=f"profile_{leg}_{mode}", **tkw)
        busy = {leg: float(f["device_busy_ms_per_tick"])
                for leg, f in profiled.items()}
        phase("engine_tenant_cost", mode=mode, model=serve_label(model),
              paired_ticks=48,
              tick_ms_p50_plain=f"{tick['plain']:.4f}",
              tick_ms_p50_tenant=f"{tick['tenant']:.4f}",
              tenant_tick_vs_plain=f"{tick['tenant'] / tick['plain']:.4f}",
              paired_mask_restages=pair_restages,
              wave_tick_ms_p50_plain=f"{wave_tick['plain']:.4f}",
              wave_tick_ms_p50_tenant=f"{wave_tick['tenant']:.4f}",
              tokens_per_s_plain=f"{rate['plain']:.2f}",
              tokens_per_s_tenant=f"{rate['tenant']:.2f}",
              device_busy_ms_per_tick_plain=f"{busy['plain']:.4f}",
              device_busy_ms_per_tick_tenant=f"{busy['tenant']:.4f}",
              lora_delta_device_ms_per_tick=profiled["tenant"][
                  "lora_delta_device_ms_per_tick"])
    return launches_out

# ------------------------------------------------------- phases 25-30
# GPT-2 small as HF `gpt2`'s config.json gives it: n_embd 768, n_layer 12,
# n_head 12, n_positions 1024, layer_norm_epsilon 1e-5, vocabulary 50257
# (the head padded to 50304).
GPT_VOCAB = 50257
GPT_CFG = dict(vocab_size=GPT_VOCAB, vocab_multiple=128, max_len=1024,
               ln_eps=1e-5)
INT8_MIN_ELEMS = 65536   # quantize_int8's default
# The new train paths' K1/K2 shapes, timed beside their plain versions.
NEW_FLASH_SHAPES = {"gpt2_small_train": "gpt2_small",
                    "vit_s16_train": "vit_s16",
                    "llama1b_tp2_local": "llama1b_tp2"}


def time_flash_shapes():
    """K1 (with and without its LSE) and K2 at the GPT-2-small and
    ViT-S/16 train shapes (``FLASH_CASES``' agreement cases hold their
    errors): each kernel's time on CUDA events over two input sets, the
    plain version's, SDPA's (forward; forward+backward minus forward for
    K2) and the bound, causal or not. Returns ``{kernel: {shape:
    fields}}``."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    out = {"flash_fwd": {}, "flash_fwd_nolse": {}, "flash_bwd_fused": {}}
    for tag, case in NEW_FLASH_SHAPES.items():
        shape = FLASH_CASES[case]
        causal = shape[7]
        cases = []
        for _ in range(2):
            qkv, do, _, kw = flash_case(gen, *shape)
            o, lse = tatt.flash_forward(*qkv, **kw)
            cases.append((qkv, o, lse, do))
        ref_o, ref_lse = tatt.flash_forward_plain(*cases[0][0], **kw)
        got = tatt.flash_backward(*cases[0][0], ref_o, ref_lse, cases[0][3],
                                  **kw)
        want = tatt.flash_backward_plain(*cases[0][0], ref_o, ref_lse,
                                         cases[0][3], **kw)
        nolse_o, _ = tatt.flash_forward(*cases[0][0], want_lse=False, **kw)
        torch.cuda.synchronize()
        errs = {
            "flash_fwd": max(float((cases[0][1].float() - ref_o.float())
                                   .abs().max()),
                             float((cases[0][2] - ref_lse).abs().max())),
            "flash_fwd_nolse": float((nolse_o.float() - ref_o.float())
                                     .abs().max()),
            "flash_bwd_fused": max(float((g.float() - w.float()).abs().max())
                                   for g, w in zip(got, want))}
        del got, want, ref_o, ref_lse, nolse_o
        fwd = {
            "flash_fwd": cuda_ms(lambda i: tatt.flash_forward(
                *cases[i][0], **kw), 2, iters=20),
            "flash_fwd_nolse": cuda_ms(lambda i: tatt.flash_forward(
                *cases[i][0], want_lse=False, **kw), 2, iters=20)}
        plain_fwd = cuda_ms(lambda i: tatt.flash_forward_plain(
            *cases[i][0], **kw), 2, iters=4)
        sdpa_f = cuda_ms(lambda i: F.scaled_dot_product_attention(
            *cases[i][0], is_causal=causal, enable_gqa=True), 2, iters=20)
        bwd = cuda_ms(lambda i: tatt.flash_backward(
            *cases[i][0], *cases[i][1:], **kw), 2, iters=10)
        plain_bwd = cuda_ms(lambda i: tatt.flash_backward_plain(
            *cases[i][0], *cases[i][1:], **kw), 2, iters=2)
        leaves = [[x.detach().requires_grad_() for x in c[0]] for c in cases]

        def sdpa(i, backward):
            o = F.scaled_dot_product_attention(*leaves[i], is_causal=causal,
                                               enable_gqa=True)
            if backward:
                o.backward(cases[i][3])
        sdpa_fb = cuda_ms(lambda i: sdpa(i, True), 2, iters=10)
        q, k = cases[0][0][:2]
        for name in ("flash_fwd", "flash_fwd_nolse"):
            bound_ms, bound_by = flash_fwd_bound_ms(
                q, k, want_lse=name == "flash_fwd", causal=causal)
            out[name][tag] = dict(ms=fwd[name], plain_ms=plain_fwd,
                                  library_ms=sdpa_f, bound_ms=bound_ms,
                                  bound_by=bound_by, max_abs_err=errs[name])
        bound_ms, bound_by = flash_bwd_bound_ms(q, k, causal=causal)
        out["flash_bwd_fused"][tag] = dict(
            ms=bwd, plain_ms=plain_bwd, library_ms=sdpa_fb - sdpa_f,
            bound_ms=bound_ms, bound_by=bound_by,
            max_abs_err=errs["flash_bwd_fused"])
        b, h, hkv, sq = shape[:4]
        phase("flash_new_shapes_time", shape=f"{tag}_B{b}_H{h}_Hkv{hkv}_"
              f"S{sq}_D{shape[5]}_bf16_{'causal' if causal else 'full'}",
              **{f"{n}_{k}": (f"{v:.5f}" if isinstance(v, float) else v)
                 for n in out for k, v in out[n][tag].items()})
        del cases, leaves
    return out


def gpt_parity_pair(max_len: int = SPEC_MAX_LEN):
    """One seeded GPT-2-small weight set at depth 2, drawn on the card and
    copied to the CPU, f32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(GPT_CFG, max_len=max_len, depth=2, dtype=torch.float32, seed=1)
    gpu_model = GPT_Small(device=DEV, **kw)
    return gpu_model, cpu_copy(gpu_model, GPT_Small, **kw)


def engine_streams(model, prompts, new, **kw):
    """Greedy streams of ``prompts`` x ``new`` through one engine on the
    model's device (4 slots, prefill 128, blocks of 16), every one run to
    LENGTH; with the launches and the ticks of the run."""
    eng = ServeEngine(model, device=model.device, max_slots=4,
                      prefill_len=128, prefix_block_size=16, **kw)
    _kernels.reset_launch_counts()
    handles = [eng.submit(p, new) for p in prompts]
    eng.run(max_steps=400)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    for i, h in enumerate(handles):
        if h.finish_reason is not FinishReason.LENGTH:
            raise RuntimeError(f"request {i}: {h.finish_reason}")
    ticks = sum(1 for r in eng.telemetry.snapshot() if r["live_slots"] > 0)
    return [h.tokens for h in handles], dict(_kernels.launch_counts), ticks


def check_launches(what, launches, **want):
    """Every counter as ``want`` names it, the rest 0."""
    got = {k: v for k, v in launches.items() if v or k in want}
    if got != want:
        raise RuntimeError(f"{what}: launches {got}, want {want}")


def phase_gpt_parity(steps: int = 3, lr: float = 1e-4, new: int = 16):
    """GPT-2-small width at depth 2 in f32 (TF32 off), one seeded weight
    set on the card (kernels) and on the CPU (plain versions): 3 adamw
    ``Trainer`` steps (losses within rtol 1e-4, parameters within
    2·lr·steps; K1 with its LSE and K2 once a layer a step); ``generate``
    (B 4, prompt 64) and both engine modes over the parity prompts x 16
    tokens, token-exact unless a tie (K4 once a layer a paged tick, none
    elsewhere); then ``spec_k=4`` n-gram legs in both modes over the spec
    prompts at ``max_len`` 304, the last stream ending there (its windows
    reach past the cache, where the position lookup is clamped), against
    the CPU and the card's ``spec_k=0`` engine. Returns the paged engine
    leg's launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.reset_launch_counts()
    losses, rel, params = _train_both(
        "adamw", lr, steps, factory=GPT_Small,
        **dict(GPT_CFG, max_len=SPEC_MAX_LEN))
    check_launches("gpt_parity train", dict(_kernels.launch_counts),
                   flash_fwd=2 * steps, flash_bwd_fused=2 * steps)
    max_diff = max(float((g - c).abs().max())
                   for g, c, _, _ in params.values())
    phase("gpt_parity", leg="train_adamw", model="GPT_Small_depth2_f32",
          allow_tf32=False, lr=lr, steps=steps,
          losses_cuda="/".join(f"{x:.7f}" for x in losses["cuda"]),
          losses_cpu="/".join(f"{x:.7f}" for x in losses["cpu"]),
          max_loss_rel_diff=f"{rel:.3g}", max_param_diff=f"{max_diff:.3g}",
          param_bound=f"{2 * lr * steps:g}", flash_fwd_launches=2 * steps,
          flash_bwd_fused_launches=2 * steps)
    if not rel <= 1e-4:
        raise RuntimeError(f"GPT train losses disagree: {losses}")
    if not max_diff <= 2 * lr * steps:
        raise RuntimeError(f"GPT trained parameters differ by {max_diff}")
    del params
    gpu_model, cpu_model = gpt_parity_pair()
    prompts = parity_prompts(GPT_VOCAB)
    batch = np.stack([np.resize(p, 64) for p in prompts])
    _kernels.reset_launch_counts()
    out = generate(gpu_model, batch, new)
    torch.cuda.synchronize()
    check_launches("gpt_parity generate", dict(_kernels.launch_counts))
    ref = generate(cpu_model, batch, new)
    exact, ties = check_streams("GPT generate row", out[:, 64:].cpu().tolist(),
                                ref[:, 64:].tolist(), batch.tolist(),
                                cpu_model, new)
    phase("gpt_parity", leg="generate", model="GPT_Small_depth2_f32",
          batch=len(batch), prompt=64, new=new, token_exact=exact, ties=ties)
    paged_launches = None
    for leg, kw in (("engine_row", {}), ("engine_paged", {"paged": True})):
        streams, launches, ticks = engine_streams(gpu_model, prompts, new,
                                                  **kw)
        want = gpu_model.depth * ticks if kw else 0
        check_launches(f"gpt_parity {leg}", launches,
                       **({"paged_decode": want} if want else {}))
        if kw:
            paged_launches = launches
        cpu_streams = engine_streams(cpu_model, prompts, new, **kw)[0]
        exact, ties = check_streams(f"GPT {leg} request", streams,
                                    cpu_streams, prompts, cpu_model, new)
        phase("gpt_parity", leg=leg, model="GPT_Small_depth2_f32",
              requests=len(prompts), new=new, token_exact=exact, ties=ties,
              ticks=ticks, paged_decode_launches=launches["paged_decode"])
    sprompts = spec_parity_prompts(GPT_VOCAB)
    for leg, paged in (("spec_row", False), ("spec_paged", True)):
        _kernels.reset_launch_counts()
        eng, streams = spec_streams(gpu_model, sprompts, 48, paged=paged,
                                    spec_k=SPEC_K)
        torch.cuda.synchronize()
        check_launches(f"gpt_parity {leg}", dict(_kernels.launch_counts))
        _, base = spec_streams(gpu_model, sprompts, 48, paged=paged)
        _, cpu_streams = spec_streams(cpu_model, sprompts, 48, paged=paged,
                                      spec_k=SPEC_K)
        exact, ties = check_streams(f"GPT {leg} request", streams,
                                    cpu_streams, sprompts, cpu_model, 48)
        exact0, ties0 = check_streams(f"GPT {leg} vs spec_k=0 request",
                                      streams, base, sprompts, cpu_model, 48)
        edge = len(sprompts[-1]) + len(streams[-1])
        if edge != SPEC_MAX_LEN:
            raise RuntimeError(f"the edge stream ends at {edge}")
        phase("gpt_parity", leg=leg, model="GPT_Small_depth2_f32",
              max_len=SPEC_MAX_LEN, spec_k=SPEC_K, requests=len(sprompts),
              new=48, edge_request_tokens=edge, token_exact_vs_cpu=exact,
              ties_vs_cpu=ties, token_exact_vs_spec0=exact0,
              ties_vs_spec0=ties0, **spec_fields(eng.metrics.snapshot()))
    del gpu_model, cpu_model
    return paged_launches


def gpt_serve_model():
    torch.cuda.empty_cache()
    return GPT_Small(**GPT_CFG, dtype=torch.bfloat16, device=DEV, seed=0)


def serve_wave_fields(run, model, paged: bool):
    """One wave's line: the serve fields, K4's launches (exactly once a
    layer a tick on a paged engine, none on a row one) and the peak."""
    launches, ticks = run["launches"], run["ticks"]
    want = model.depth * ticks if paged else 0
    check_launches(f"serve wave paged={paged}", launches,
                   **({"paged_decode": want} if want else {}))
    return dict(serve_fields(run), paged=paged,
                paged_decode_launches=launches["paged_decode"],
                prefix_hits=run["snap"]["prefix_hits"],
                peak_mem_gib=f"{run['peak'] / 2**30:.3f}")


def phase_gpt_serve(new: int = 128, plen: int = 64):
    """Full GPT-2-small (HF ``gpt2``'s configuration, seeded weights) in
    bf16: the serve wave (24 requests of 384 prompt tokens, 256 shared,
    x 32 new on 8 slots) on the row and the paged engine, then
    ``generate`` at B 1, prompt 64, 128 new (one warm-up, one timed call)
    against the weight-read bound. Returns the paged wave's launches."""
    model = gpt_serve_model()
    prompts = serve_prompts(GPT_VOCAB)
    paged_launches = None
    for paged in (False, True):
        run = serve_wave(model, prompts, paged=paged)
        phase("gpt_serve", model="GPT_Small_bf16",
              **serve_wave_fields(run, model, paged))
        if paged:
            paged_launches = run["launches"]
        del run
    bound = weight_read_bound_tokens_s(model, plen, new)
    prompt = np.random.RandomState(7).randint(0, GPT_VOCAB, (1, plen))
    wall, _, launches = timed_generate(model, prompt, new, 1)
    check_launches("gpt generate", launches)
    tokens_s = new / wall
    phase("gpt_generate", model="GPT_Small_bf16", batch=1, prompt=plen,
          new=new, wall_s=f"{wall:.4f}", new_tokens_per_s=f"{tokens_s:.2f}",
          ms_per_token=f"{1e3 * wall / new:.4f}",
          weight_read_bound_tokens_per_s=f"{bound:.2f}",
          ratio_to_bound=f"{tokens_s / bound:.4f}")
    del model
    return paged_launches


def phase_gpt_train(batch: int = 8, seq: int = 1024, warmup: int = 2,
                    steps: int = 5):
    """Full GPT-2-small, bf16 compute over f32 parameters, adamw, B 8 x
    S 1024 through ``Trainer.fit``: 2 warm-up and 5 timed steps; tokens/s,
    ms a step, 6ND MFU (N = the blocks and the LM head's weight), the peak
    memory, and exactly 12 K1 (with its LSE) and 12 K2 a step."""
    torch.cuda.empty_cache()
    model = GPT_Small(**GPT_CFG, dtype=torch.bfloat16,
                      param_dtype=torch.float32, device=DEV, seed=0)
    tr, data, hist, wall, counts, tokens_s, mfu, peak = _timed_fit(
        model, batch, seq, warmup, steps)
    check_launches("gpt_train", counts, flash_fwd=model.depth * steps,
                   flash_bwd_fused=model.depth * steps)
    phase("gpt_train", model="GPT_Small_bf16_compute_f32_params",
          **_train_fields(model, batch, seq, steps, hist, wall, counts,
                          tokens_s, mfu, peak))
    if not all(np.isfinite(hist.history["loss"])):
        raise RuntimeError(f"GPT train losses {hist.history['loss']}")
    del tr, data, model
    return counts


def int8_install(model):
    """Quantize ``model`` (``min_elems`` 65536) and install the int8 tree
    with ``param_transform=dequantize``, in place; returns the tree's
    ``quantized_bytes``."""
    q = quantize_int8(model, min_elems=INT8_MIN_ELEMS)
    stats = quantized_bytes(q)
    install_params(model, q, dequantize)
    return stats


INT8_FAMILIES = {
    f"Llama_1B_depth{SERVE_DEPTH}": lambda: Llama_1B(
        vocab_size=VOCAB, max_len=MAX_LEN, depth=SERVE_DEPTH,
        dtype=torch.bfloat16, device=DEV, seed=0),
    f"GPT_Small_depth{SERVE_DEPTH}": lambda: GPT_Small(
        **GPT_CFG, depth=SERVE_DEPTH, dtype=torch.bfloat16, device=DEV,
        seed=0),
}


def int8_serve_family(name, build):
    """One family's int8 legs (see :func:`phase_int8_serve`); returns the
    paged int8 wave's launches."""
    gc.collect()
    torch.cuda.empty_cache()
    a0 = torch.cuda.memory_allocated()
    dense = build()
    a1 = torch.cuda.memory_allocated()
    dense_bytes = quantized_bytes(dense.state_dict())["bytes"]
    eng = ServeEngine(dense, paged=True, max_slots=8, prefix_block_size=16)
    engine_bf16 = torch.cuda.memory_allocated() - a0
    del eng
    gc.collect()
    a2 = torch.cuda.memory_allocated()
    int8 = build()
    stats = int8_install(int8)
    gc.collect()
    a3 = torch.cuda.memory_allocated()
    eng = ServeEngine(int8, paged=True, max_slots=8, prefix_block_size=16)
    engine_int8 = torch.cuda.memory_allocated() - a2
    del eng
    gc.collect()
    model_bf16, model_int8 = a1 - a0, a3 - a2
    want = dense_bytes - stats["bytes"]
    phase("int8_memory", model=f"{name}_bf16", min_elems=INT8_MIN_ELEMS,
          quantized_leaves=stats["quantized_leaves"],
          dense_tree_bytes=dense_bytes, int8_tree_bytes=stats["bytes"],
          tree_bytes_saved=want, model_bytes_bf16=model_bf16,
          model_bytes_int8=model_int8,
          model_bytes_saved=model_bf16 - model_int8,
          engine_bytes_bf16=engine_bf16, engine_bytes_int8=engine_int8,
          engine_bytes_saved=engine_bf16 - engine_int8,
          int8_param_dtypes=",".join(sorted({
              str(p.dtype).split(".")[1] for p in int8.parameters()})))
    # The card holds the int8 tree and nothing dense beside it (the
    # allocator rounds each tensor up to 512 bytes: within 1%), and the
    # model saves what the trees differ by (the bf16 build may leave a few
    # MB of the allocator's own beside its tree: at least 95%).
    if not (model_int8 <= 1.01 * stats["bytes"]
            and model_bf16 - model_int8 >= 0.95 * want):
        raise RuntimeError(f"{name}: the int8 model holds {model_int8} "
                           f"bytes (its tree {stats['bytes']}) against the "
                           f"bf16 one's {model_bf16}; the trees differ by "
                           f"{want}")
    prompts = serve_prompts(dense.vocab_size)
    ticks, footprint = {}, {}
    paged_launches = None
    # In turns across the modes: row bf16, row int8, paged int8, paged bf16.
    # Both models stay resident, so a wave's own peak is its peak less the
    # other model's bytes.
    other_bytes = {"bf16": model_int8, "int8": model_bf16}
    for paged, order in ((False, ("bf16", "int8")), (True, ("int8", "bf16"))):
        for kind in order:
            model = int8 if kind == "int8" else dense
            run = serve_wave(model, prompts, paged=paged)
            ticks[(paged, kind)] = float(np.median(run["tick_s"]))
            footprint[(paged, kind)] = run["peak"] - other_bytes[kind]
            phase("int8_serve", model=f"{name}_{kind}",
                  peak_without_other_model_gib=(
                      f"{footprint[(paged, kind)] / 2**30:.3f}"),
                  **serve_wave_fields(run, model, paged))
            if paged and kind == "int8":
                paged_launches = run["launches"]
            del run
    # int8 is there to save memory: at its peak too (each leaf's dense
    # copy is made at its product, block by block, and freed after it).
    for paged in (False, True):
        if footprint[(paged, "int8")] > footprint[(paged, "bf16")]:
            raise RuntimeError(
                f"{name} paged={paged}: the int8 wave peaks at "
                f"{footprint[(paged, 'int8')]} bytes, the bf16 one at "
                f"{footprint[(paged, 'bf16')]}")
    plen, new = 64, 64
    prompt = np.random.RandomState(7).randint(0, dense.vocab_size, (1, plen))
    walls = {}
    for kind, model in (("bf16", dense), ("int8", int8)):
        walls[kind], _, launches = timed_generate(model, prompt, new, 1)
        check_launches(f"{name} {kind} generate", launches)
    ratio = {paged: ticks[(paged, "int8")] / ticks[(paged, "bf16")]
             for paged in (False, True)}
    phase("int8_cost", model=name, tick_ratio_row=f"{ratio[False]:.4f}",
          tick_ratio_paged=f"{ratio[True]:.4f}",
          generate_b1_tokens_per_s_bf16=f"{new / walls['bf16']:.2f}",
          generate_b1_tokens_per_s_int8=f"{new / walls['int8']:.2f}",
          generate_ratio=f"{walls['int8'] / walls['bf16']:.4f}",
          generate_new=new,
          int8_weight_read_bound_tokens_per_s=(
              f"{weight_read_bound_tokens_s(int8, plen, new):.2f}"))
    del dense, int8
    return paged_launches


def phase_int8_serve():
    """int8 serving on Llama-1B and GPT-2-small at full width and
    ``SERVE_DEPTH`` (bf16 compute,
    ``quantize_int8(min_elems=65536)``, ``param_transform=dequantize``):
    ``quantized_bytes`` of the int8 tree against the dense tree's, and the
    ``memory_allocated`` that the model adds (the int8 model within 1% of
    its tree, the saving at least 95% of the trees' difference) and the
    model with a paged engine, int8 against bf16; the serve wave
    on the row and the paged engine, bf16 and int8 in turns (K4 once a
    layer a paged tick; each wave's peak less the other model's bytes,
    int8's no higher than bf16's); the tick p50 ratio int8 / bf16 per
    mode; then
    ``generate`` at B 1 (prompt 64, 64 new), bf16 then int8. Returns the
    paged int8 waves' launches by family."""
    return {name: int8_serve_family(name, build)
            for name, build in INT8_FAMILIES.items()}


def dense_twin(model, qtree):
    """A model of ``model``'s configuration on its device holding the
    dense dequantized weights of ``qtree``."""
    twin = copy.deepcopy(model)
    return install_params(twin, dequantize(qtree))


def phase_int8_parity(new: int = 4):
    """int8 at depth 2 in f32 (TF32 off), ``min_elems`` 65536, on
    Llama-1B and GPT-2-small widths: the card's int8 tree bitwise the
    CPU's; the paged int8 engine on the card against the CPU's (token-exact
    unless a tie) and bitwise the card's engine over the dense dequantized
    weights (the same weights, so the same streams); K4 once a layer a
    tick. Then, on Llama, a tenant leg under int8: a base request and two
    adapters, card against CPU. Returns the paged legs' launches."""
    launches_all = {}
    pairs = (("Llama_1B_depth2_f32",
              lambda: _parity_pair(max_len=MAX_LEN, depth=2), VOCAB),
             ("GPT_Small_depth2_f32",
              lambda: gpt_parity_pair(max_len=MAX_LEN), GPT_VOCAB))
    for name, pair, vocab in pairs:
        gpu_model, cpu_model = pair()
        qg = quantize_int8(gpu_model, min_elems=INT8_MIN_ELEMS)
        qc = quantize_int8(cpu_model, min_elems=INT8_MIN_ELEMS)
        leaves = [k for k, v in qc.items() if isinstance(v, dict)]
        same = all(torch.equal(qg[k][f].cpu(), qc[k][f]) for k in leaves
                   for f in ("qvalue", "scale"))
        if not same:
            raise RuntimeError(f"{name}: the card's int8 tree differs")
        twin = dense_twin(gpu_model, qg)
        cpu_twin = dense_twin(cpu_model, qc)
        install_params(gpu_model, qg, dequantize)
        install_params(cpu_model, qc, dequantize)
        prompts = parity_prompts(vocab)
        streams, launches, ticks = engine_streams(gpu_model, prompts, new,
                                                  paged=True)
        check_launches(f"int8_parity {name}", launches,
                       paged_decode=gpu_model.depth * ticks)
        launches_all[name] = launches
        cpu_streams = engine_streams(cpu_model, prompts, new, paged=True)[0]
        dense_streams = engine_streams(twin, prompts, new, paged=True)[0]
        exact, ties = check_streams(f"{name} int8 request", streams,
                                    cpu_streams, prompts, cpu_twin, new)
        if streams != dense_streams:
            raise RuntimeError(f"{name}: the int8 engine's streams differ "
                               "from the dense dequantized engine's")
        phase("int8_parity", model=name, allow_tf32=False, paged=True,
              quantized_leaves=len(leaves), card_tree_equals_cpu=same,
              requests=len(prompts), new=new, token_exact_vs_cpu=exact,
              ties_vs_cpu=ties, equal_to_dense_dequantized=True, ticks=ticks,
              paged_decode_launches=launches["paged_decode"])
        if vocab == VOCAB:
            strings = tenant_token_strings(vocab)
            registry = tenant_registry(gpu_model, 2)
            kws = [{}, {"adapter": "adapter0"}, {"adapter": "adapter1"}, {}]
            news = [new] * 4
            eng = tenant_engine(gpu_model, registry, strings, paged=True)
            t_streams, _, _, t_launches, t_ticks = recorded_run(
                eng, prompts, kws, news)
            torch.cuda.synchronize()
            check_launches(f"int8_parity {name} tenant", t_launches,
                           paged_decode=gpu_model.depth * t_ticks)
            launches_all[name + "_tenant"] = t_launches
            cpu_eng = tenant_engine(cpu_model, registry, strings, paged=True)
            c_streams = recorded_run(cpu_eng, prompts, kws, news)[0]
            exact, ties = check_tenant_streams(
                f"{name} int8 tenant request", t_streams, c_streams, prompts,
                kws, cpu_twin, registry)
            phase("int8_parity", model=name, leg="tenant", paged=True,
                  adapters=len(registry), rank=TENANT_RANK,
                  token_exact_vs_cpu=exact, ties_vs_cpu=ties,
                  adapter_loads=eng.metrics.snapshot()["adapter_loads"],
                  paged_decode_launches=t_launches["paged_decode"],
                  ticks=t_ticks)
        del gpu_model, cpu_model, twin, cpu_twin, qg, qc
    return launches_all


def vit_macs(model, image: int = 224) -> int:
    """Multiply-accumulates of one image's forward, from the model's
    shapes: the patch embed, each block's q, k, v, out and MLP products
    and its two attention products (``QKᵀ`` and ``PV``), the head."""
    p, e = model.patch_size, model.embed_dim
    n = (image // p) ** 2
    block = 4 * n * e * e + 2 * n * n * e + 2 * n * e * (4 * e)
    return n * p * p * 3 * e + model.depth * block + e * model.num_classes


def phase_vit_parity(steps: int = 3, lr: float = 1e-4, batch: int = 4):
    """ViT-S/16 (1000 classes) at depth 2 in f32 (TF32 off), one seeded
    weight set on the card (K1, K2) and on the CPU (plain versions), B 4 x
    224: the eval logits at init within 1e-4 (K1 without its LSE, once a
    layer), then 3 adam steps through ``Trainer.fit`` (losses within rtol
    1e-4, parameters within 2·lr·steps; K1 with its LSE and K2 once a
    layer a step)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(depth=2, num_classes=1000, dtype=torch.float32, seed=2)
    cpu_model = ViT_S16(device="cpu", **cfg)
    gpu_model = ViT_S16(device=DEV, **cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    data = SyntheticImageClassification(batch_size=batch, image_size=224,
                                        num_classes=1000, seed=1)
    images = data.batch(0)["image"]
    _kernels.reset_launch_counts()
    with torch.no_grad():
        got = gpu_model(torch.as_tensor(images, device=DEV), train=False)
        torch.cuda.synchronize()
        check_launches("vit_parity eval", dict(_kernels.launch_counts),
                       flash_fwd_nolse=gpu_model.depth)
        want = cpu_model(torch.as_tensor(images), train=False)
    logit_err = float((got.cpu() - want).abs().max())
    losses = {}
    for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        tr = Trainer(model, optimizer="adam", learning_rate=lr,
                     device=model.device)
        _kernels.reset_launch_counts()
        losses[name] = tr.fit(data, epochs=steps, steps_per_epoch=1,
                              verbose=0).history["loss"]
        if name == "cuda":
            torch.cuda.synchronize()
            check_launches("vit_parity train", dict(_kernels.launch_counts),
                           flash_fwd=gpu_model.depth * steps,
                           flash_bwd_fused=gpu_model.depth * steps)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    cpu_params = dict(cpu_model.named_parameters())
    max_diff = max(float((p.detach().cpu() - cpu_params[n].detach())
                         .abs().max())
                   for n, p in gpu_model.named_parameters())
    phase("vit_parity", model="ViT_S16_depth2_f32", allow_tf32=False,
          batch=batch, image=224, logits_max_abs_err=f"{logit_err:.3g}",
          optimizer="adam", lr=lr, steps=steps,
          losses_cuda="/".join(f"{x:.7f}" for x in losses["cuda"]),
          losses_cpu="/".join(f"{x:.7f}" for x in losses["cpu"]),
          max_loss_rel_diff=f"{rel:.3g}", max_param_diff=f"{max_diff:.3g}",
          param_bound=f"{2 * lr * steps:g}")
    if not logit_err <= 1e-4:
        raise RuntimeError(f"ViT logits differ by {logit_err}")
    if not rel <= 1e-4 or not max_diff <= 2 * lr * steps:
        raise RuntimeError(f"ViT training disagrees: {losses}, {max_diff}")
    del gpu_model, cpu_model


def phase_vit_train(batch: int = 256, warmup: int = 2, steps: int = 10):
    """ViT-S/16 (1000 classes), bf16 compute over f32 parameters, adam at
    1e-3, B 256 x 224 on a batch resident on the card, through
    ``Trainer.train_step``: 2 warm-up then 10 timed steps; images/s, ms a
    step, the peak memory and the MFU of 6 x the forward's MACs per image;
    exactly 12 non-causal K1 (with the LSE) and 12 K2 a step."""
    torch.cuda.empty_cache()
    model = ViT_S16(num_classes=1000, dtype=torch.bfloat16,
                    param_dtype=torch.float32, device=DEV, seed=0)
    macs = vit_macs(model)
    tr = Trainer(model, optimizer="adam", learning_rate=1e-3, metrics=(),
                 device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    batch_d = {"image": torch.randn(batch, 224, 224, 3, generator=gen,
                                    device=DEV),
               "label": torch.randint(0, 1000, (batch,), generator=gen,
                                      device=DEV, dtype=torch.int32)}
    for _ in range(warmup):
        tr.train_step(batch_d)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        logs = tr.train_step(batch_d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_kernels.launch_counts)
    check_launches("vit_train", counts, flash_fwd=model.depth * steps,
                   flash_bwd_fused=model.depth * steps)
    loss = float(logs["loss"])
    images_s = batch * steps / wall
    phase("vit_train", model="ViT_S16_bf16_compute_f32_params",
          optimizer="adam", lr=1e-3, batch=batch, image=224, warmup=warmup,
          steps=steps, wall_s=f"{wall:.4f}",
          ms_per_step=f"{1e3 * wall / steps:.3f}",
          images_per_s=f"{images_s:.2f}",
          peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
          last_loss=f"{loss:.5f}", fwd_gmac_per_image=f"{macs / 1e9:.4f}",
          mfu=f"{6 * macs * images_s / PEAK_FLOPS[torch.bfloat16]:.4f}",
          flash_per_step="/".join(f"{k}:{counts[k] / steps:g}"
                                  for k in FLASH_COUNTERS))
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite ViT loss {loss}")
    del tr, batch_d, model
    return counts


# -------------------------------------------------------- phase 30b-30d
# The schedules held card against CPU: every name, with and without
# warmup (tests/test_torch_train_options.py holds them against optax).
SCHEDULE_CASES = (
    ("cosine", dict(decay_steps=10, alpha=0.1)),
    ("cosine", dict(decay_steps=10, warmup_steps=3)),
    ("warmup_cosine", dict(decay_steps=12, warmup_steps=4)),
    ("exponential", dict(decay_steps=3, decay_rate=0.5)),
    ("exponential", dict(decay_steps=3, decay_rate=0.7, warmup_steps=2)),
    ("linear", dict(decay_steps=10, end_value=0.01)),
    ("linear", dict(decay_steps=10, warmup_steps=4)),
    ("piecewise", dict(boundaries_and_scales={3: 0.5, 7: 0.1})),
    ("piecewise", dict(warmup_steps=2, boundaries_and_scales={4: 0.3})),
    ("constant", {}),
    ("constant", dict(warmup_steps=5)),
)


def _options_parity_schedules(steps: int = 12) -> None:
    for name, kw in SCHEDULE_CASES:
        want = [float(make_schedule(name, 0.3, **kw)(i)) for i in range(steps)]
        for dev in (DEV, torch.device("cpu")):
            p = torch.nn.Parameter(torch.ones(4, device=dev))
            opt = make_optimizer([p], "sgd", 0.3, schedule=name,
                                 schedule_options=kw)
            seen = []
            for _ in range(steps):
                p.grad = torch.ones_like(p)
                opt.step()
                seen.append(get_learning_rate(opt))
            if seen != want:
                raise RuntimeError(f"schedule {name} {kw} on {dev}: {seen} "
                                   f"!= {want}")
    phase("train_options_parity", leg="schedules",
          cases=len(SCHEDULE_CASES), steps=steps, equal_card_cpu=True)


def _options_parity_chain(lr: float = 1e-4) -> None:
    """A cosine schedule, a clip at 1.0 (a prebuilt optimizer), 2-step
    accumulation and an EMA at 0.9, Llama-1B width at depth 2 in f32: 4
    micro-steps (2 updates) and one eval batch on the shadows, card against
    CPU."""
    cfg = dict(vocab_size=VOCAB, depth=2, dtype=torch.float32, seed=2)
    gpu_model = Llama_1B(**cfg, device=DEV)
    cpu_model = cpu_copy(gpu_model, **cfg)
    data = SyntheticLanguageModeling(batch_size=2, seq_len=128,
                                     vocab_size=VOCAB, seed=1)
    val = data.with_offset(100)
    out = {}
    for side, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        tr = Trainer(model, optimizer=lambda p: make_optimizer(
            p, "adamw", lr, schedule="cosine",
            schedule_options=dict(decay_steps=4), grad_clip_norm=1.0),
            gradient_accumulation_steps=2,
            ema_decay=0.9, log_grad_norm=True, device=model.device,
            **LM_KEYS)
        lrs = []
        hist = tr.fit(data, epochs=2, steps_per_epoch=2, verbose=0,
                      callbacks=[LambdaCallback(
                          on_train_batch_end=lambda s, logs, tr=tr:
                          lrs.append(get_learning_rate(tr.optimizer)))])
        out[side] = dict(loss=hist.history["loss"],
                         grad_norm=hist.history["grad_norm"], lrs=lrs,
                         val=tr.evaluate(val, steps=1)["loss"],
                         params={n: p.detach().cpu() for n, p in
                                 model.named_parameters()},
                         ema={n: t.cpu() for n, t in tr.ema.items()})
        del tr
    g, c = out["cuda"], out["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(g["loss"] + [g["val"]],
                                                  c["loss"] + [c["val"]]))
    diff = {k: max(float((g[k][n] - c[k][n]).abs().max()) for n in g[k])
            for k in ("params", "ema")}
    bound = 2 * lr * 2
    phase("train_options_parity", leg="schedule_clip_accumulation_ema",
          model="Llama_1B_depth2_f32", allow_tf32=False, optimizer="adamw",
          lr=lr, micro_steps=4, updates=2,
          losses_cuda="/".join(f"{x:.7f}" for x in g["loss"]),
          losses_cpu="/".join(f"{x:.7f}" for x in c["loss"]),
          grad_norm_cuda="/".join(f"{x:.5f}" for x in g["grad_norm"]),
          eval_on_ema_cuda=f"{g['val']:.7f}", eval_on_ema_cpu=f"{c['val']:.7f}",
          lrs="/".join(f"{x:.4g}" for x in g["lrs"]),
          max_loss_rel_diff=f"{rel:.3g}",
          max_param_diff=f"{diff['params']:.3g}",
          max_ema_diff=f"{diff['ema']:.3g}", bound=f"{bound:g}")
    if g["lrs"] != c["lrs"] or not rel <= 1e-4 or not max(
            diff.values()) <= bound:
        raise RuntimeError(f"options leg disagrees: lrs {g['lrs']} / "
                           f"{c['lrs']}, rel {rel}, {diff}")


def _options_parity_accumulation(lr: float = 1e-2) -> None:
    """2 x B 2 accumulated against one B 4 step (sgd), on the card: the
    updates (lr x the gradients) agree within the train parity legs'
    gradient tolerance, GRAD_TOL of the largest (the f32 flash kernels
    and the GEMMs sum the two batches' rows in another order; a sum where
    the mean belongs would be 100% off)."""
    batch = SyntheticLanguageModeling(batch_size=4, seq_len=256,
                                      vocab_size=VOCAB, seed=1).batch(0)
    runs = []
    for acc, parts in ((2, [slice(0, 2), slice(2, 4)]), (None, [slice(0, 4)])):
        model = Llama_1B(vocab_size=VOCAB, depth=2, dtype=torch.float32,
                         device=DEV, seed=2)
        start = [p.detach().clone() for p in model.parameters()]
        tr = Trainer(model, optimizer="sgd", learning_rate=lr,
                     gradient_accumulation_steps=acc, device=DEV, **LM_KEYS)
        for part in parts:
            tr.train_step({k: v[part] for k, v in batch.items()})
        runs.append([p.detach() - s for p, s in zip(model.parameters(),
                                                    start)])
        del tr, model, start
    scale = max(float(d.abs().max()) for d in runs[1])
    err = max(float((a - b).abs().max()) for a, b in zip(*runs)) / scale
    bound = GRAD_TOL[torch.float32]
    phase("train_options_parity", leg="accumulation_2xB2_vs_B4",
          optimizer="sgd", lr=lr, max_update=f"{scale:.4g}",
          max_rel_update_diff=f"{err:.3g}", bound=f"{bound:g}")
    if not err <= bound:
        raise RuntimeError(f"accumulated update off by {err:.3g}")
    del runs


def _options_parity_bf16(n: int = 4096) -> None:
    """bf16 storage on the card: ``plain`` keeps f32 moments (the repair),
    ``f32_master``'s stored parameters are exactly the cast of its master
    after 2 adamw steps; ``stochastic_round`` lands on a value's two bf16
    neighbours with a mean within 4 sigma over 4,096 draws, and with given
    bits equals the CPU's rounding bit for bit."""
    data = SyntheticLanguageModeling(batch_size=2, seq_len=256,
                                     vocab_size=VOCAB, seed=1)
    fields = {}
    for mode in ("plain", "f32_master"):
        model = Llama_1B(vocab_size=VOCAB, depth=2, param_dtype=torch.bfloat16,
                         device=DEV, seed=2)
        tr = Trainer(model, optimizer="adamw", learning_rate=1e-3,
                     param_update=mode, device=DEV, **LM_KEYS)
        tr.fit(data, epochs=2, steps_per_epoch=1, verbose=0)
        dtypes = {t.dtype for s in tr.optimizer.state.values()
                  for t in s.values()
                  if isinstance(t, torch.Tensor) and t.ndim}
        fields[f"{mode}_moment_dtypes"] = ",".join(sorted(map(str, dtypes)))
        if dtypes != {torch.float32}:
            raise RuntimeError(f"{mode}: optimizer state in {dtypes}")
        if mode == "f32_master":
            masters = tr.optimizer.masters()
            cast = all(torch.equal(p, masters[p].to(torch.bfloat16))
                       for p in model.parameters())
            fields["master_count"] = len(masters)
            fields["stored_is_cast_of_master"] = cast
            if not cast or len(masters) != len(list(model.parameters())):
                raise RuntimeError("f32_master: stored != cast(master)")
        del tr, model
    ulp = float(np.spacing(np.float32(1.0))) * 2 ** 16
    x = torch.full((n,), float(np.float32(1.0 + 0.3 * ulp)), device=DEV)
    r = stochastic_round(x, torch.Generator(device=DEV).manual_seed(0))
    r = r.float().cpu()
    sigma = ulp * float(np.sqrt(0.3 * 0.7 / n))
    mean_err = abs(float(r.mean()) - float(x[0]))
    neighbours = set(r.unique().tolist()) <= {1.0, 1.0 + ulp}
    gen = torch.Generator().manual_seed(1)
    vals = torch.randn(1 << 20, generator=gen) * torch.exp(
        torch.randn(1 << 20, generator=gen) * 8)
    bits = torch.randint(0, 1 << 16, vals.shape, generator=gen,
                         dtype=torch.int32)
    bitwise = torch.equal(_sr_to_bf16(vals.to(DEV), bits.to(DEV)).cpu(),
                          _sr_to_bf16(vals, bits))
    phase("train_options_parity", leg="bf16_storage", **fields,
          sr_draws=n, sr_mean_err=f"{mean_err:.3g}",
          sr_4sigma=f"{4 * sigma:.3g}", sr_on_neighbours=neighbours,
          sr_given_bits_bitwise_cpu=bitwise, sr_values=vals.numel())
    if not (neighbours and mean_err < 4 * sigma and bitwise):
        raise RuntimeError("stochastic_round on the card failed its gates")


def phase_train_options_parity() -> None:
    """The trainer's options on the card against the port's CPU run, f32
    with TF32 off: the schedules, the clip, accumulation and EMA (eval on
    the shadows), accumulation against a big batch, bf16 storage's update
    rules and stochastic rounding."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _options_parity_schedules()
    _options_parity_chain()
    _options_parity_accumulation()
    _options_parity_bf16()
    torch.cuda.empty_cache()


def _options_step(param_dtype, mode: str, log_dir: str, warmup: int = 1,
                  updates: int = 3):
    """Full-width Llama-1B, bf16 compute over ``param_dtype`` storage,
    adamw at 1e-4 under warmup_cosine and a clip at 1.0, B 4 x S 2048 as
    2 x B 2 micro-batches, EMA 0.999, ``param_update=mode``, with
    CSVLogger, TensorBoard, Timing and ModelSummary: ``warmup`` updates,
    then ``updates`` timed ones through ``Trainer.fit``."""
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, dtype=torch.bfloat16,
                     param_dtype=param_dtype, device=DEV, seed=0)
    n = sum(p.numel() for p in model.parameters())
    tr = Trainer(model, optimizer=lambda p: make_optimizer(
        p, "adamw", 1e-4, schedule="warmup_cosine",
        schedule_options=dict(decay_steps=1000, warmup_steps=10),
        grad_clip_norm=1.0), gradient_accumulation_steps=2,
        param_update=mode, ema_decay=0.999, device=DEV, **LM_KEYS)
    data = SyntheticLanguageModeling(batch_size=2, seq_len=2048,
                                     vocab_size=VOCAB, seed=0)
    tr.fit(data, epochs=warmup, steps_per_epoch=2, verbose=0)
    tag = f"{str(param_dtype).split('.')[-1]}_{mode}"
    timing = Timing(verbose=0)
    callbacks = [CSVLogger(f"{log_dir}/{tag}.csv"),
                 TensorBoard(f"{log_dir}/{tag}"), timing, ModelSummary()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = tr.fit(data.with_offset(2 * warmup), epochs=updates,
                  steps_per_epoch=2, verbose=0, callbacks=callbacks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_kernels.launch_counts)
    check_launches(f"train_options_step {tag}", counts,
                   flash_fwd=model.depth * 2 * updates,
                   flash_bwd_fused=model.depth * 2 * updates)
    state = optimizer_state_bytes(tr.optimizer)
    ema = sum(t.numel() * t.element_size() for t in tr.ema.values())
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    losses = hist.history["loss"]
    csv_rows = len(open(f"{log_dir}/{tag}.csv").read().splitlines())
    tb_bytes = sum(os.path.getsize(os.path.join(root, f))
                   for root, _, files in os.walk(f"{log_dir}/{tag}")
                   for f in files)
    fields = dict(
        storage=str(param_dtype).split(".")[-1], param_update=mode,
        micro_batch=2, accumulate=2, seq=2048, updates=updates,
        wall_s=f"{wall:.4f}", ms_per_step=f"{1e3 * wall / updates:.3f}",
        tokens_per_s=f"{4 * 2048 * updates / wall:.2f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
        params=n, opt_state_bytes_per_param=f"{state / n:.4f}",
        ema_bytes_per_param=f"{ema / n:.4f}",
        total_bytes_per_param=f"{(params + state + ema) / n:.4f}",
        losses="/".join(f"{x:.5f}" for x in losses),
        last_lr=f"{get_learning_rate(tr.optimizer):.4g}",
        timing_total_s=f"{timing.total:.4f}", csv_rows=csv_rows,
        tensorboard_bytes=tb_bytes,
        flash_fwd=counts["flash_fwd"], flash_bwd_fused=counts["flash_bwd_fused"])
    if not all(np.isfinite(losses)) or csv_rows != updates + 1 or not tb_bytes:
        raise RuntimeError(f"train_options_step {tag}: {fields}")
    del tr, model
    return counts, fields


def phase_train_options_step():
    """Phase 10's model and tokens a step under the trainer's options
    (:func:`_options_step`), bf16 storage under each ``param_update`` mode
    in turns beside f32 storage (f32, plain, stochastic_round, f32_master,
    f32). Returns the flash launches of all five runs."""
    total = {}
    with tempfile.TemporaryDirectory(dir=BUILD) as log_dir:
        for dtype, mode in ((torch.float32, "plain"),
                            (torch.bfloat16, "plain"),
                            (torch.bfloat16, "stochastic_round"),
                            (torch.bfloat16, "f32_master"),
                            (torch.float32, "plain")):
            counts, fields = _options_step(dtype, mode, log_dir)
            phase("train_options_step", model="Llama_1B_bf16_compute",
                  **fields)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    return total


RESILIENCE_EPOCHS, RESILIENCE_SPE = 2, 4  # 8 steps, saves every 2


def _resilience_trainer(**kw):
    model = ResNet50(num_classes=1000, device=DEV, seed=3)
    return Trainer(model, optimizer="adam", learning_rate=1e-3, device=DEV,
                   retry_sleep=lambda s: None, **kw)


def _resilience_fit(tr, batches, directory, extra=(), **fit_kw):
    """8 steps with a save every 2; the per-step losses by step, and the
    saves' (bytes, wall s, host copy s, write s) in order."""
    losses, saves = {}, []
    cb = CheckpointEveryN(directory, every_n_steps=2, async_save=False)

    def record(step, logs):
        losses[tr.step - 1] = float(logs["loss"])
        if cb.saves > len(saves):
            saves.append((cb.ckpt.last_save_bytes, cb.last_save_wall_s,
                          cb.ckpt.last_copy_s, cb.ckpt.last_write_s))

    tr.fit(batches, epochs=RESILIENCE_EPOCHS,
           steps_per_epoch=RESILIENCE_SPE, verbose=0,
           callbacks=[cb, *extra, LambdaCallback(on_train_batch_end=record)],
           **fit_kw)
    return losses, saves


def resilience_child(directory: str) -> None:
    """``--resilience-child DIR``: the clean run in a process of its own,
    which SIGKILLs itself at the end of step 5 (saves at 2 and 4); its
    losses so far go to ``DIR/losses.json`` as it runs."""
    _deterministic()
    tr = _resilience_trainer()
    losses = {}

    def record(step, logs):
        losses[tr.step - 1] = float(logs["loss"])
        with open(os.path.join(directory, "losses.json"), "w") as f:
            json.dump(losses, f)
        if tr.step == 5:
            os.kill(os.getpid(), signal.SIGKILL)

    tr.fit(dp_batches(8, 32), epochs=RESILIENCE_EPOCHS,
           steps_per_epoch=RESILIENCE_SPE, verbose=0, callbacks=[
               CheckpointEveryN(os.path.join(directory, "ckpt"),
                                every_n_steps=2, async_save=False),
               LambdaCallback(on_train_batch_end=record)])


def _deterministic() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


@contextlib.contextmanager
def deterministic_block():
    """:func:`_deterministic`'s settings for a block, and the TF32 and
    cuDNN flags as they were after it (the later timed phases')."""
    flags = (torch.backends.cuda.matmul, "allow_tf32"), \
        (torch.backends.cudnn, "allow_tf32"), \
        (torch.backends.cudnn, "benchmark"), \
        (torch.backends.cudnn, "deterministic")
    saved = [getattr(obj, name) for obj, name in flags]
    _deterministic()
    try:
        yield
    finally:
        for (obj, name), value in zip(flags, saved):
            setattr(obj, name, value)


def _prefetch_rates(batch: int = 64, steps: int = 4) -> dict:
    """Host-fed images/s: ``bench.py``'s step (bf16 compute, s2d stem,
    adam) fed from ``SyntheticImageClassification``'s host batches through
    ``Trainer.fit`` at ``prefetch`` 0 and 2, in turns (0, 2). The
    host makes each batch in a few hundred ms, so cuDNN's algorithm search
    stays off: it would cost more than the window it could speed up."""
    torch.backends.cudnn.benchmark = False
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     stem="space_to_depth", device=DEV, seed=0)
    tr = Trainer(model, optimizer="adam", learning_rate=1e-3, metrics=(),
                 device=DEV)
    data = SyntheticImageClassification(batch_size=batch, image_size=224,
                                        num_classes=1000, seed=0)
    tr.fit(data, steps_per_epoch=2, verbose=0)
    rates = {0: [], 2: []}
    offset = 2
    for depth in (0, 2):
        stamps = []
        torch.cuda.synchronize()
        tr.fit(data.with_offset(offset), steps_per_epoch=steps, verbose=0,
               prefetch=depth, callbacks=[LambdaCallback(
                   on_train_batch_end=lambda s, logs: stamps.append(
                       time.perf_counter()))])
        # Between the first and the last batch end: the lookahead's fill
        # and the batches it stages past the end are outside the window.
        rates[depth].append(batch * (steps - 1) / (stamps[-1] - stamps[0]))
        offset += steps
    t0 = time.perf_counter()
    data.batch(0)
    gen_s = time.perf_counter() - t0
    del tr, model
    torch.cuda.empty_cache()
    return dict(batch=batch, steps=steps,
                host_batch_gen_s=f"{gen_s:.4f}",
                images_per_s_prefetch0="/".join(f"{x:.2f}" for x in rates[0]),
                images_per_s_prefetch2="/".join(f"{x:.2f}" for x in rates[2]))


def phase_train_resilience() -> None:
    """ResNet-50 f32, B 32 (``dp_parity``'s setup, cuDNN deterministic),
    adam, 8 steps with ``CheckpointEveryN(every_n_steps=2)``: a transient
    retried in place, spent retries (restore and replay), an injected OOM,
    a torn newest save (the previous one restored), and a child process
    SIGKILLed at step 5 then ``fit(resume=)`` here; each bitwise the clean
    run in its losses and every leaf of ``Trainer.state_dict()``. Then the
    saves' MB, ms and GB/s, a restore's ms, and the host-fed images/s at
    prefetch 0 and 2."""
    _deterministic()
    batches = dp_batches(8, 32)
    os.makedirs(BUILD, exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=BUILD) as root:
            tr = _resilience_trainer()
            want_losses, saves = _resilience_fit(tr, batches, f"{root}/clean")
            want = tree_checksums(tr.state_dict())
            del tr
            t0 = time.perf_counter()
            state, _ = Checkpointer(f"{root}/clean").restore()
            fresh = _resilience_trainer()
            fresh.load_state_dict(state)
            torch.cuda.synchronize()
            restore_ms = 1e3 * (time.perf_counter() - t0)
            del fresh, state

            class Tear(Callback):
                def on_train_batch_end(self, step, logs):
                    if self.trainer.step == 6:
                        path = f"{root}/torn_newest/6/state.pt"
                        with open(path, "r+b") as f:
                            f.truncate(os.path.getsize(path) // 2)

            legs = {
                "transient_retried": ([FaultSpec(3, "train_step",
                                                 FaultKind.TRANSIENT, 2)], ()),
                "retries_spent": ([FaultSpec(5, "train_step",
                                             FaultKind.TRANSIENT, 4)], ()),
                "oom": ([FaultSpec(7, "train_step", FaultKind.OOM)], ()),
                "torn_newest": ([FaultSpec(7, "train_step", FaultKind.OOM)],
                                (Tear(),)),
            }
            results = {}
            for name, (specs, extra) in legs.items():
                tr = _resilience_trainer(
                    fault_plan=TrainFaultPlan(scheduled=specs))
                losses, _ = _resilience_fit(tr, batches, f"{root}/{name}",
                                            extra)
                ok = (losses == want_losses
                      and tree_checksums(tr.state_dict()) == want)
                stats = tr.fault_stats
                results[name] = (ok, int(stats["retries"]),
                                 int(stats["recoveries"]),
                                 int(stats["replayed_steps"]))
                del tr
            child_dir = f"{root}/child"
            os.makedirs(child_dir)
            proc = subprocess.run(
                [sys.executable, __file__, "--resilience-child", child_dir],
                timeout=600)
            with open(f"{child_dir}/losses.json") as f:
                child_losses = {int(k): v for k, v in json.load(f).items()}
            tr = _resilience_trainer()
            resumed, _ = _resilience_fit(tr, batches, f"{child_dir}/ckpt",
                                         resume=f"{child_dir}/ckpt")
            ok = ({**child_losses, **resumed} == want_losses
                  and tree_checksums(tr.state_dict()) == want)
            results["sigkill_resume"] = (ok, proc.returncode,
                                         min(resumed), len(resumed))
            del tr
    finally:
        torch.backends.cudnn.deterministic = False
    del batches
    torch.cuda.empty_cache()
    phase("train_resilience", model="ResNet50_f32", batch=32, image=224,
          optimizer="adam", lr=1e-3, steps=8, every_n_steps=2,
          cudnn_deterministic=True,
          losses="/".join(f"{want_losses[s]:.7f}" for s in sorted(want_losses)),
          **{f"{k}_bitwise": v[0] for k, v in results.items()},
          **{f"{k}_retries_recoveries_replayed": f"{v[1]}/{v[2]}/{v[3]}"
             for k, v in results.items() if k != "sigkill_resume"},
          child_returncode=results["sigkill_resume"][1],
          resumed_from_step=results["sigkill_resume"][2],
          resumed_steps=results["sigkill_resume"][3])
    for i, (nbytes, wall, copy_s, write_s) in enumerate(saves):
        phase("train_resilience_save", save=i + 1, mb=f"{nbytes / 1e6:.2f}",
              ms=f"{1e3 * wall:.2f}", gb_per_s=f"{nbytes / wall / 1e9:.3f}",
              host_copy_ms=f"{1e3 * copy_s:.2f}",
              write_ms=f"{1e3 * write_s:.2f}")
    phase("train_resilience_restore", ms=f"{restore_ms:.2f}")
    phase("train_resilience_prefetch", model="ResNet50_bf16_s2d",
          **_prefetch_rates())
    bad = [k for k, v in results.items() if not v[0]]
    if bad or results["sigkill_resume"][1] != -signal.SIGKILL:
        raise RuntimeError(f"train_resilience: not bitwise the clean run: "
                           f"{bad}; child exit {results['sigkill_resume'][1]}")


# ---------------------------------------------------------- phase 31-34
FAULT_NEW = 16
TICK_EXHAUST = [(3, "tick", "transient", 4)]  # max_retries 3, then replay


def recording_plan(spec, sleep_fn=time.sleep):
    """A seeded ``FaultPlan`` from ``spec`` (its keywords, ``scheduled`` as
    ``(step, site, kind, count)`` tuples) whose latency faults wait with
    ``sleep_fn``, and the list its ``on_inject`` fills with ``(step, site,
    kind)``."""
    spec = dict(spec)
    plan = FaultPlan(sleep_fn=sleep_fn, scheduled=[
        FaultSpec(step, site, FaultKind(kind), count)
        for step, site, kind, count in spec.pop("scheduled", ())], **spec)
    log = []
    plan.on_inject = lambda step, site, kind: log.append((step, site, kind))
    return plan, log


def faulted_run(model, prompts, spec=None, kws=None, late=(), new=FAULT_NEW,
                **engine_kw):
    """``engine_parity``'s engine shape (4 slots, prefill 128, blocks of
    16) under a fault plan (``spec``; ``None`` for none), a no-op backoff
    and a fake clock a second a step; ``late`` submits ``(step, prompt,
    new, keywords)`` at that step. Returns the streams of the requests in
    submit order (``late`` last), the injections, the snapshot, the K4
    launches and the ticks that ran (the telemetry's ``tick`` site), the
    handles (a speculative window counts as a tick) and the steps that
    ended with a sliced admission parked."""
    plan, log = (recording_plan(spec, lambda s: None) if spec is not None
                 else (None, []))
    clock = [0.0]
    eng = ServeEngine(model, device=model.device, max_slots=4,
                      prefill_len=128, prefix_block_size=16, fault_plan=plan,
                      backoff_sleep=lambda s: None, clock=lambda: clock[0],
                      **engine_kw)
    kws = kws or [{}] * len(prompts)
    _kernels.reset_launch_counts()
    handles = [eng.submit(p, new, **kw) for p, kw in zip(prompts, kws)]
    late = list(late)
    parked = 0
    for step in range(400):
        for when, p, n, kw in late:
            if when == step:
                handles.append(eng.submit(p, n, **kw))
        if not eng.has_work and step > max((w for w, *_ in late),
                                           default=-1):
            break
        eng.step()
        parked += eng._slice is not None
        clock[0] += 1.0
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    ticks = sum(1 for r in eng.telemetry.snapshot()
                if {"tick", "verify"} & set(r["site_wall_s"]))
    if eng.telemetry.total_appended > eng.telemetry.capacity:
        raise RuntimeError("telemetry ring wrapped; ticks undercounted")
    return dict(streams=[list(h.tokens) for h in handles], log=log,
                snap=eng.metrics.snapshot(), eng=eng, handles=handles,
                launches=dict(_kernels.launch_counts), ticks=ticks,
                parked=parked)


def phase_engine_fault_parity():
    """Fault recovery card against CPU, greedy, Llama-1B width at depth 2
    in f32 (TF32 off), ``engine_parity``'s 4 prompts x 16 tokens: a
    scheduled tick exhaustion (4 transients past ``max_retries`` 3: every
    live slot replays) in both modes; an OOM at the first donation (row:
    degraded, flushed, re-armed under the fake clock); a rate-drawn mixed
    plan (seed 0) with a scheduled verify exhaustion at ``spec_k=4``
    (n-gram, paged: forced re-feeds); a tenant leg (an adapter, an adapter
    under the bounded schema, the schema alone) under the tick
    exhaustion; a preemption leg (4 best-effort streams, an interactive
    arrival at step 2). Gates: the injections equal card against CPU, the
    streams token-exact card against CPU and equal to the card's
    fault-free engine (unless a tie, the CPU's top-2 margin < 1e-3), K4
    exactly twice a paged tick that ran (none on the speculative leg).
    Returns the paged legs' launches."""
    gpu_model, cpu_model = _parity_pair(max_len=MAX_LEN, depth=2)
    prompts = parity_prompts()
    strings = tenant_token_strings()
    registry = tenant_registry(gpu_model, 2)
    schema = {"kind": "json_schema", "schema": PARITY_SCHEMA}
    tenant_kws = [{}, {"adapter": "adapter0"},
                  {"adapter": "adapter1", "constraint": schema},
                  {"constraint": schema}]
    tenant = dict(tenant=TenantConfig(registry=registry,
                                      token_strings=strings))
    base = faulted_run(gpu_model, prompts, paged=True)["streams"]
    tbase = faulted_run(gpu_model, prompts, kws=tenant_kws, paged=True,
                        **tenant)["streams"]
    be = [{"priority": Priority.BEST_EFFORT}] * 4
    legs = [
        ("tick_exhaust_row", dict(scheduled=TICK_EXHAUST), {},
         dict(paged=False)),
        ("tick_exhaust_paged", dict(scheduled=TICK_EXHAUST), {},
         dict(paged=True)),
        ("donate_oom_row", dict(scheduled=[(0, "donate", "oom", 1)]), {},
         dict(paged=False, degraded_cooldown_s=5.0)),
        ("mixed_spec_ngram", dict(
            seed=0, transient_rate=0.05, oom_rate=0.02, latency_rate=0.1,
            latency_s=1e-4, max_random_injections=20,
            scheduled=[(3, "verify", "transient", 4)]), {},
         dict(paged=True, spec_k=SPEC_K)),
        ("tenant_paged", dict(scheduled=TICK_EXHAUST),
         dict(kws=tenant_kws), dict(paged=True, **tenant)),
        ("preempt_paged", None, dict(kws=be, late=[
            (2, prompts[1], FAULT_NEW, {"priority": Priority.INTERACTIVE})]),
         dict(paged=True)),
    ]
    paged_launches = {"paged_decode": 0}
    for leg, spec, run_kw, engine_kw in legs:
        runs = {name: faulted_run(model, prompts, spec, **run_kw,
                                  **engine_kw)
                for name, model in (("cuda", gpu_model), ("cpu", cpu_model))}
        gpu, cpu = runs["cuda"], runs["cpu"]
        if gpu["log"] != cpu["log"]:
            raise RuntimeError(f"engine_fault_parity {leg}: injections "
                               f"{gpu['log']} on the card, {cpu['log']} on "
                               "the CPU")
        n = len(gpu["streams"])
        if leg == "tenant_paged":
            exact, ties = check_tenant_streams(
                f"{leg} request", gpu["streams"], cpu["streams"], prompts,
                tenant_kws, cpu_model, registry)
            exact_b, ties_b = check_tenant_streams(
                f"{leg} vs fault-free", gpu["streams"], tbase, prompts,
                tenant_kws, cpu_model, registry)
        else:
            want = base + [base[1]] * (n - len(base))
            all_prompts = list(prompts) + [prompts[1]] * (n - len(prompts))
            exact, ties = check_streams(f"{leg} request", gpu["streams"],
                                        cpu["streams"], all_prompts,
                                        cpu_model, FAULT_NEW)
            exact_b, ties_b = check_streams(f"{leg} vs fault-free",
                                            gpu["streams"], want,
                                            all_prompts, cpu_model,
                                            FAULT_NEW)
        snap, eng = gpu["snap"], gpu["eng"]
        launches = gpu["launches"]["paged_decode"]
        want_k4 = (0 if not engine_kw["paged"] or "spec_k" in engine_kw
                   else gpu_model.depth * gpu["ticks"])
        if launches != want_k4 or sum(gpu["launches"].values()) != launches:
            raise RuntimeError(f"engine_fault_parity {leg}: launches "
                               f"{gpu['launches']}, want {want_k4} K4")
        if engine_kw["paged"]:
            paged_launches["paged_decode"] += launches
        checks = {
            "tick_exhaust_row": snap["replays"] == 4,
            "tick_exhaust_paged": snap["replays"] == 4,
            "donate_oom_row": (snap["degraded_entries"] == 1
                               and snap["degraded_time_s"] > 0
                               and not eng.degraded and snap["replays"] >= 1),
            "mixed_spec_ngram": snap["replays"] > 0 and len(gpu["log"]) > 4,
            "tenant_paged": (snap["replays"] == 4
                             and snap["requests_by_adapter"]
                             == {"adapter0": 1, "adapter1": 1}),
            "preempt_paged": snap["preemptions"] > 0,
        }
        if not checks[leg] or snap["requests_failed"]:
            raise RuntimeError(f"engine_fault_parity {leg}: {snap}")
        kinds = {}
        for _, _, kind in gpu["log"]:
            kinds[kind] = kinds.get(kind, 0) + 1
        phase("engine_fault_parity", leg=leg, model="Llama_1B_depth2_f32",
              allow_tf32=False, requests=n, injections=len(gpu["log"]),
              by_kind=",".join(f"{k}:{v}" for k, v in sorted(kinds.items()))
              or "none", injections_equal_cpu=True,
              token_exact_vs_cpu=exact, ties_vs_cpu=ties,
              equal_fault_free=exact_b, ties_vs_fault_free=ties_b,
              retries=snap["retries"], replays=snap["replays"],
              preemptions=snap["preemptions"],
              degraded_entries=snap["degraded_entries"],
              degraded_time_s=snap["degraded_time_s"],
              paged_decode_launches=launches, ticks=gpu["ticks"])
    del gpu_model, cpu_model
    return paged_launches


def bf16_ties(model, prompts, streams, base, what):
    """Streams equal to ``base``'s, and each first divergence's top-2
    margin on the card model; a divergence whose margin reaches 8 bf16
    ulps of the top logit raises (the script's bf16 tie rule)."""
    equal, ties = 0, []
    for i, (prompt, a, b) in enumerate(zip(prompts, streams, base)):
        if len(a) != len(b):
            raise RuntimeError(f"{what} {i}: {len(a)} against {len(b)}")
        j = next((t for t in range(len(b)) if a[t] != b[t]), None)
        if j is None:
            equal += 1
            continue
        with torch.no_grad():
            logits = model(torch.tensor([list(prompt) + b[:j]],
                                        device=DEV))[0, -1].float()
        top = torch.topk(logits, 2).values
        ulp = 2.0 ** (np.floor(np.log2(abs(float(top[0])))) - 7)
        margin = float(top[0] - top[1])
        if margin >= 8 * ulp:
            raise RuntimeError(f"{what} {i} parts at token {j} with a top-2 "
                               f"margin of {margin:.4g} >= 8 bf16 ulps")
        ties.append(f"req{i}@{j}:margin={margin:.4g}")
    return equal, ";".join(ties) or "none"


def oom_on_tick(n: int):
    """A ``serve_wave`` hook: the engine's ``n``-th tick first allocates
    more than the card holds (its cached free segments could satisfy a
    request sized by ``mem_get_info``'s free bytes), so the caching
    allocator raises a real ``torch.OutOfMemoryError`` inside the guarded
    call."""
    def prepare(eng):
        real, calls = eng._tick, [0]
        total = torch.cuda.get_device_properties(DEV).total_memory

        def tick():
            calls[0] += 1
            if calls[0] == n:
                torch.empty(total + (1 << 30), dtype=torch.uint8, device=DEV)
            return real()
        eng._tick = tick
    return prepare


SERVE_FAULTS = dict(seed=0, transient_rate=0.03, oom_rate=0.01,
                    latency_rate=0.02, latency_s=0.002,
                    max_random_injections=24)


def phase_engine_fault_serve(model, prompts):
    """Phase 7's wave (Llama-1B bf16 at ``SERVE_DEPTH``, 24 x 384 prompt
    tokens, 256 shared, x 32 new, 8 slots) in both modes, with the engine's
    real backoff and latency sleeps: fault-free, under the seeded
    ``SERVE_FAULTS`` plan, under a scheduled tick exhaustion at step 6 and
    with a real ``torch.OutOfMemoryError`` raised by the allocator at the
    6th tick.
    Gates: every stream equal to the fault-free wave's (bf16 tie rule,
    reported); the real OOM comes out as a degraded entry with no request
    failed; K4 once a layer a paged tick that ran. Prints the injections
    by kind, retries by site, replays, degraded entries and time, tokens/s
    and TTFT p99 against fault-free, and the K4 launches beyond the
    fault-free wave's. Returns the paged legs' launches and the fault-free
    waves' streams by mode (``engine_drain_restore``'s undrained waves)."""
    total = {"paged_decode": 0}
    clean_streams = {}
    for paged in (False, True):
        mode = "paged" if paged else "row"
        runs = {}
        for leg, spec, prepare in (
                ("fault_free", None, None),
                ("seeded_plan", SERVE_FAULTS, None),
                ("tick_exhaust", dict(scheduled=[(6, "tick", "transient",
                                                  4)]), None),
                ("real_oom", None, oom_on_tick(6))):
            plan, log = (recording_plan(spec) if spec is not None
                         else (None, []))
            run = serve_wave(model, prompts, paged, fault_plan=plan,
                             prepare=prepare, telemetry_capacity=4096)
            runs[leg] = run
            snap, launches = run["snap"], run["launches"]
            ticks_ran = sum(1 for r in run["eng"].telemetry.snapshot()
                            if "tick" in r["site_wall_s"])
            want = model.depth * ticks_ran if paged else 0
            if (launches["paged_decode"] != want
                    or sum(launches.values()) != want):
                raise RuntimeError(f"engine_fault_serve {mode} {leg}: "
                                   f"launches {launches}, want {want}")
            total["paged_decode"] += launches["paged_decode"]
            if snap["requests_failed"]:
                raise RuntimeError(f"engine_fault_serve {mode} {leg}: "
                                   f"{snap['requests_failed']} failed")
            if leg == "real_oom" and snap["degraded_entries"] < 1:
                raise RuntimeError(f"engine_fault_serve {mode}: the real "
                                   "OOM did not degrade the engine")
            if leg == "tick_exhaust" and snap["replays"] < 1:
                raise RuntimeError(f"engine_fault_serve {mode}: no replay")
            equal, ties = bf16_ties(
                model, prompts, [h.tokens for h in run["handles"]],
                [h.tokens for h in runs["fault_free"]["handles"]],
                f"engine_fault_serve {mode} {leg} request")
            kinds = {}
            for _, _, kind in log:
                kinds[kind] = kinds.get(kind, 0) + 1
            fields = serve_fields(run)
            clean = runs["fault_free"]
            phase("engine_fault_serve", mode=mode, leg=leg,
                  model=serve_label(model), **{k: fields[k] for k in (
                      "requests", "tokens", "wall_s", "tokens_per_s",
                      "ttft_p50_s", "ttft_p99_s", "ticks")},
                  tokens_per_s_fault_free=serve_fields(clean)["tokens_per_s"],
                  ttft_p99_s_fault_free=serve_fields(clean)["ttft_p99_s"],
                  injections=len(log),
                  by_kind=",".join(f"{k}:{v}" for k, v in
                                   sorted(kinds.items())) or "none",
                  retries=snap["retries"],
                  retry_sites=",".join(f"{k}:{v}" for k, v in sorted(
                      snap["retry_sites"].items())) or "none",
                  replays=snap["replays"],
                  degraded_entries=snap["degraded_entries"],
                  degraded_time_s=snap["degraded_time_s"],
                  degraded_at_end=run["eng"].degraded,
                  equal_fault_free=f"{equal}/{len(prompts)}", ties=ties,
                  paged_decode_launches=launches["paged_decode"],
                  k4_beyond_fault_free=(launches["paged_decode"]
                                        - clean["launches"]["paged_decode"]),
                  ticks_ran=ticks_ran)
        clean_streams[paged] = [h.tokens for h in runs["fault_free"]
                                ["handles"]]
    return total, clean_streams


def tier_prompts(vocab: int = VOCAB):
    """32 distinct 384-token prompts: 24-block chains, 768 KiB of bf16 K/V
    a layer each at Llama-1B's width."""
    rng = np.random.RandomState(6)
    return [rng.randint(0, vocab, 384) for _ in range(32)]


def tier_run(model, prompts, paged, rounds=2, new=16, promote=None,
             demote=None, **engine_kw):
    """The prompts served in ``rounds`` rounds, 8 at a time (one slot-full,
    run to empty before the next 8, so TTFT is the admission's own time).
    ``promote`` / ``demote`` collect each promotion's (bytes, CUDA-event
    ms) and each reclaim's demotion host ms. Returns the streams, the TTFT
    per round, the engine, the K4 launches per round and the ticks."""
    eng = ServeEngine(model, paged=paged, max_slots=8, prefix_block_size=16,
                      telemetry_capacity=4096, **engine_kw)
    if promote is not None:
        real_promote = eng._promote_rows

        def timed_promote(rows, ids):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            real_promote(rows, ids)
            end.record()
            end.synchronize()
            promote.append((rows.numel() * rows.element_size(),
                            start.elapsed_time(end)))
        eng._promote_rows = timed_promote
    if demote is not None:
        real_demote = eng._prefix.on_evict

        def timed_demote(victims):
            t0 = time.perf_counter()
            real_demote(victims)
            demote.append(1e3 * (time.perf_counter() - t0))
        eng._prefix.on_evict = timed_demote
    streams, ttft, launches, ticks = [], [], [], []
    for _ in range(rounds):
        _kernels.reset_launch_counts()
        before = eng.telemetry.total_appended
        handles = []
        for i in range(0, len(prompts), 8):
            wave = [eng.submit(p, new) for p in prompts[i:i + 8]]
            eng.run()
            handles += wave
        torch.cuda.synchronize()
        streams.append([h.tokens for h in handles])
        ttft.append([h.ttft_s for h in handles])
        launches.append(_kernels.launch_counts["paged_decode"])
        ticks.append(sum(1 for r in eng.telemetry.snapshot()[
            before - eng.telemetry.total_appended:] if r["live_slots"]))
    return dict(streams=streams, ttft=ttft, eng=eng, launches=launches,
                ticks=ticks)


def phase_host_tier_serve(model, budget: int = 512 << 20):
    """The host KV tier at full width (Llama-1B bf16 at ``SERVE_DEPTH``,
    ``max_len`` 1024):
    32 distinct 384-token prompts in 2 rounds of 16 new tokens on 8 slots,
    a 512 MiB host budget, device pools too small for them (paged: its
    floor + 1, 514 blocks; row: 193 blocks, 8 chains and scratch). Gates:
    every stream equal to the same engine's over a pool that holds every
    chain (bf16 tie rule, reported); spills, hits and promotions > 0, no
    host pin outstanding; K4 once a layer a paged tick. Prints each
    promotion's bytes and CUDA-event ms and their GB/s, the demotion's
    host ms per reclaim, the TTFT p50 of round 2 against the untiered
    engine of the same pool (recompute), in turns, and the K4 launches of
    round 2 (over promoted blocks). Returns the paged tiered run's K4
    launches."""
    prompts = tier_prompts()
    total = {"paged_decode": 0}
    for paged, small, big in ((False, 193, 32 * 24 + 32),
                              (True, 8 * 64 + 2, None)):
        mode = "paged" if paged else "row"
        ref = tier_run(model, prompts, paged, prefix_cache_blocks=big)
        promote, demote = [], []
        tiered = tier_run(model, prompts, paged, promote=promote,
                          demote=demote, prefix_cache_blocks=small,
                          host_tier=HostTierConfig(byte_budget=budget))
        untiered = tier_run(model, prompts, paged, prefix_cache_blocks=small)
        eng = tiered["eng"]
        snap = eng.metrics.snapshot()
        if not (snap["host_tier_spills"] > 0 and snap["host_tier_hits"] > 0
                and snap["host_tier_promotions"] > 0
                and eng._host.pins_outstanding == 0):
            raise RuntimeError(f"host_tier_serve {mode}: {snap}")
        ties_all = []
        for r in range(len(tiered["streams"])):
            equal, ties = bf16_ties(model, prompts, tiered["streams"][r],
                                    ref["streams"][r],
                                    f"host_tier_serve {mode} round {r}")
            if ties != "none":
                ties_all.append(f"r{r}:{ties}")
        for r, (k4, ticks) in enumerate(zip(tiered["launches"],
                                            tiered["ticks"])):
            want = model.depth * ticks if paged else 0
            if k4 != want:
                raise RuntimeError(f"host_tier_serve {mode} round {r}: "
                                   f"{k4} K4 launches, want {want}")
        if paged:
            total["paged_decode"] += sum(tiered["launches"])
        nbytes = sum(b for b, _ in promote)
        ms = sum(t for _, t in promote)
        late = [t for r in tiered["ttft"][1:] for t in r]
        late_u = [t for r in untiered["ttft"][1:] for t in r]
        phase("host_tier_serve", mode=mode, model=serve_label(model),
              prompts=len(prompts), prompt_tokens=384,
              rounds=len(tiered["streams"]), new=16,
              device_pool_blocks=small, host_budget_mib=budget >> 20,
              spills=snap["host_tier_spills"], hits=snap["host_tier_hits"],
              promotions=snap["host_tier_promotions"],
              promote_tokens_charged=snap["host_tier_promote_tokens_charged"],
              host_bytes_resident=snap["host_tier_bytes_resident"],
              prefix_evictions=snap["prefix_evictions"],
              promote_calls=len(promote), promote_bytes=nbytes,
              promote_ms_p50=(
                  f"{float(np.median([t for _, t in promote])):.4f}"),
              promote_gb_per_s=f"{nbytes / ms / 1e6:.3f}",
              demote_reclaims=len(demote),
              demote_host_ms_p50=f"{float(np.median(demote)):.4f}",
              demote_host_ms_max=f"{max(demote):.4f}",
              ttft_p50_revisit_s=f"{float(np.median(late)):.5f}",
              ttft_p50_revisit_untiered_s=f"{float(np.median(late_u)):.5f}",
              equal_full_pool="all" if not ties_all else "ties",
              ties=";".join(ties_all) or "none",
              paged_decode_launches_revisit=sum(tiered["launches"][1:]),
              ticks_revisit=sum(tiered["ticks"][1:]))
        del ref, tiered, untiered, eng
        gc.collect()
        torch.cuda.empty_cache()
    return total


def phase_engine_preempt_serve(model, prompts, be_new: int = 128,
                               ia_new: int = 32):
    """Preemption at full width (Llama-1B bf16 at ``SERVE_DEPTH``, the
    paged engine, 8 slots): 8 BEST_EFFORT serve prompts x 128 new fill the
    slots; after 4 steps 8 INTERACTIVE 64-token prompts x 32 new arrive. At
    ``preempt_cap=2`` (the default), then 0. Gates:
    the best-effort streams equal across the runs (bf16 tie rule),
    ``preemptions > 0`` at the default and 0 at 0, K4 once a layer a tick.
    Prints the interactive TTFT p50/p99, the best-effort completion wall,
    preemptions and replays. Returns the K4 launches of the default runs."""
    rng = np.random.RandomState(7)
    ia_prompts = [rng.randint(0, VOCAB, 64) for _ in range(8)]
    be_prompts = prompts[:8]
    total, runs = {"paged_decode": 0}, {}
    for i, cap in enumerate((2, 0)):
        eng = ServeEngine(model, paged=True, max_slots=8,
                          prefix_block_size=16, preempt_cap=cap,
                          telemetry_capacity=4096)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        be = [eng.submit(p, be_new, priority=Priority.BEST_EFFORT)
              for p in be_prompts]
        for _ in range(4):
            eng.step()
        ia = [eng.submit(p, ia_new, priority=Priority.INTERACTIVE)
              for p in ia_prompts]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = eng.metrics.snapshot()
        ticks = sum(1 for r in eng.telemetry.snapshot() if r["live_slots"])
        launches = _kernels.launch_counts["paged_decode"]
        if launches != model.depth * ticks:
            raise RuntimeError(f"engine_preempt_serve: {launches} K4 over "
                               f"{ticks} ticks")
        if (snap["preemptions"] > 0) != (cap > 0) or snap["requests_failed"]:
            raise RuntimeError(f"engine_preempt_serve cap {cap}: {snap}")
        for h, n in [(h, be_new) for h in be] + [(h, ia_new) for h in ia]:
            if h.finish_reason is not FinishReason.LENGTH or len(
                    h.tokens) != n:
                raise RuntimeError(f"engine_preempt_serve: {h}")
        if cap:
            total["paged_decode"] += launches
        runs.setdefault("cap2", [h.tokens for h in be])
        equal, ties = bf16_ties(model, be_prompts, [h.tokens for h in be],
                                runs["cap2"], "engine_preempt_serve "
                                f"cap {cap} best-effort vs cap 2")
        ia_ttft = [h.ttft_s for h in ia]
        be_wall = [h.finish_s - h.arrival_s for h in be]
        phase("engine_preempt_serve", turn=i, preempt_cap=cap,
              model=serve_label(model), best_effort=len(be), best_effort_new=
              be_new, interactive=len(ia), interactive_new=ia_new,
              wall_s=f"{wall:.4f}",
              interactive_ttft_p50_s=f"{float(np.median(ia_ttft)):.5f}",
              interactive_ttft_p99_s=(
                  f"{float(np.percentile(ia_ttft, 99)):.5f}"),
              best_effort_wall_mean_s=f"{float(np.mean(be_wall)):.4f}",
              best_effort_wall_max_s=f"{max(be_wall):.4f}",
              preemptions=snap["preemptions"], replays=snap["replays"],
              best_effort_equal_cap2=f"{equal}/{len(be)}", ties=ties,
              paged_decode_launches=launches, ticks=ticks)
    return total


# ---------------------------------------------------------- phase 35-38
SLICE_TOKENS = 8         # engine_slice_parity: at most one 32-token chunk a step
SLICE_SERVE = dict(max_slots=8, prefill_len=4096, prefix_block_size=16,
                   prefix_chunk=512, telemetry_capacity=4096)
DRAIN_STEP = 10
# engine_slice_serve's running streams' new tokens: the cold prompt's
# admission (steps 16-24 sliced at 512) and its 16 new tokens end by step
# ~40, well inside them.
SLICE_RUNNING_NEW = 96


def phase_engine_slice_parity(pair):
    """Sliced prefill card against CPU, greedy, Llama-1B width at depth 2
    in f32 (TF32 off), ``engine_parity``'s 4 prompts x 16 tokens at
    ``prefill_slice_tokens=8`` (one 32-token chunk a step, the tick between
    slices): the row and the paged engine, ``spec_k=4`` with a depth-1
    self-draft (paged; its tree advancing chunk for chunk) and a tenant
    engine (paged: a base stream, an adapter stream, a constrained one).
    Gates: token-exact card against CPU and sliced against the card's
    whole-prompt engine (unless a tie: the CPU's top-2 margin < 1e-3),
    admissions parked across steps, K4 exactly 2 x the paged ticks that
    ran (the draft leg: exactly its draft steps, ``(spec_k + 1)`` a
    window, none on the verify). Returns the paged legs' launches."""
    gpu_model, cpu_model = pair
    prompts = parity_prompts()
    registry = tenant_registry(gpu_model, 1)
    strings = tenant_token_strings()
    schema = {"kind": "json_schema", "schema": PARITY_SCHEMA}
    tenant_kws = [{}, {"adapter": "adapter0"}, {"constraint": schema}, {}]
    drafts = {"cuda": self_draft(gpu_model, 1),
              "cpu": self_draft(cpu_model, 1)}
    total = {"paged_decode": 0}
    for leg, kws, engine_kw in (
            ("row", None, dict(paged=False)),
            ("paged", None, dict(paged=True)),
            ("spec_draft_paged", None, dict(paged=True, spec_k=SPEC_K)),
            ("tenant_paged", tenant_kws, dict(paged=True))):
        runs = {}
        for name, model, sliced in (("cuda", gpu_model, SLICE_TOKENS),
                                    ("cpu", cpu_model, SLICE_TOKENS),
                                    ("whole", gpu_model, None)):
            ekw = dict(engine_kw, prefill_slice_tokens=sliced)
            if leg.startswith("spec"):
                ekw["spec_draft_model"] = drafts["cpu" if name == "cpu"
                                                 else "cuda"]
            if leg.startswith("tenant"):
                ekw["tenant"] = TenantConfig(registry=registry,
                                             token_strings=strings)
            runs[name] = faulted_run(model, prompts, kws=kws, **ekw)
        gpu = runs["cuda"]
        if kws is None:
            exact, ties = check_streams(f"{leg} request", gpu["streams"],
                                        runs["cpu"]["streams"], prompts,
                                        cpu_model, FAULT_NEW)
            exact_w, ties_w = check_streams(
                f"{leg} sliced vs whole", gpu["streams"],
                runs["whole"]["streams"], prompts, cpu_model, FAULT_NEW)
        else:
            exact, ties = check_tenant_streams(
                f"{leg} request", gpu["streams"], runs["cpu"]["streams"],
                prompts, kws, cpu_model, registry)
            exact_w, ties_w = check_tenant_streams(
                f"{leg} sliced vs whole", gpu["streams"],
                runs["whole"]["streams"], prompts, kws, cpu_model, registry)
        snap, launches = gpu["snap"], gpu["launches"]
        if leg.startswith("spec"):
            want = drafts["cuda"].depth * (SPEC_K + 1) * snap["spec_ticks"]
        else:
            want = gpu_model.depth * gpu["ticks"] if engine_kw["paged"] \
                else 0
        if launches["paged_decode"] != want or sum(launches.values()) != want:
            raise RuntimeError(f"engine_slice_parity {leg}: launches "
                               f"{launches}, want {want} paged_decode")
        if gpu["parked"] < len(prompts) or snap["requests_failed"]:
            raise RuntimeError(f"engine_slice_parity {leg}: {gpu['parked']} "
                               f"parked steps, {snap}")
        if engine_kw["paged"]:
            total["paged_decode"] += launches["paged_decode"]
        phase("engine_slice_parity", leg=leg, model="Llama_1B_depth2_f32",
              allow_tf32=False, prefill_slice_tokens=SLICE_TOKENS,
              requests=len(prompts), token_exact_vs_cpu=exact,
              ties_vs_cpu=ties, equal_whole_prompt=exact_w,
              ties_vs_whole=ties_w, parked_steps=gpu["parked"],
              whole_parked_steps=runs["whole"]["parked"],
              paged_decode_launches=launches["paged_decode"],
              ticks=gpu["ticks"], spec_ticks=snap["spec_ticks"])
    del drafts
    return total


def slice_serve_prompts(vocab: int = VOCAB):
    """7 running prompts of 384 tokens (256 shared) and one cold 4096-token
    prompt."""
    rng = np.random.RandomState(8)
    shared = rng.randint(0, vocab, 256)
    running = [np.concatenate([shared, rng.randint(0, vocab, 128)])
               for _ in range(7)]
    return running, rng.randint(0, vocab, 4096)


def slice_serve_run(model, running, cold, paged, slice_tokens,
                    new=SLICE_RUNNING_NEW,
                    cold_new=16, arrive=16):
    """The running prompts decode ``new`` tokens each; the cold prompt is
    submitted before step ``arrive``. Host times of every token (the tick
    copies the tokens to the host) give each running stream's gaps; the
    gaps that end between the cold submit and its first token are the
    admission's. Returns the streams, the gaps, TTFT, tokens/s, launches,
    ticks and the telemetry record of the admission's slowest step."""
    eng = ServeEngine(model, paged=paged, prefill_slice_tokens=slice_tokens,
                      **SLICE_SERVE)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [eng.submit(p, new) for p in running]
    stamps = [[] for _ in handles]
    cold_h, t_cold, t_first, step = None, None, None, 0
    while eng.has_work or cold_h is None:
        if step == arrive:
            cold_h = eng.submit(cold, cold_new)
            t_cold = time.perf_counter()
        eng.step()
        now = time.perf_counter()
        step += 1
        for s, h in zip(stamps, handles):
            s.extend([now] * (len(h.tokens) - len(s)))
        if cold_h is not None and cold_h.tokens and t_first is None:
            t_first, first_step = now, step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gaps = [b - a for s in stamps for a, b in zip(s, s[1:])
            if t_cold < b <= t_first]
    all_gaps = [b - a for s in stamps for a, b in zip(s, s[1:])]
    handles.append(cold_h)
    for h in handles:
        if h.finish_reason is not FinishReason.LENGTH:
            raise RuntimeError(f"engine_slice_serve: {h} {h.finish_reason}")
    records = eng.telemetry.snapshot()
    ticks = sum(1 for r in records if "tick" in r["site_wall_s"])
    # The slowest step of the cold admission, by its host ms a site.
    slowest = max((r for r in records if arrive <= r["step"] < first_step),
                  key=lambda r: r["tick_wall_s"])
    return dict(streams=[h.tokens for h in handles], gaps=gaps,
                slowest=slowest,
                all_gaps=all_gaps, ttft=cold_h.ttft_s, wall=wall,
                tokens=sum(len(h.tokens) for h in handles),
                launches=dict(_kernels.launch_counts), ticks=ticks,
                peak=torch.cuda.max_memory_allocated())


def phase_engine_slice_serve():
    """Sliced prefill at full width: Llama-1B bf16 at ``SERVE_DEPTH``,
    ``max_len`` 8192,
    ``prefill_len`` 4096, ``prefix_chunk`` 512, 8 slots. 7 streams of 384
    prompt tokens (256 shared) decode ``SLICE_RUNNING_NEW`` tokens; a cold
    4096-token prompt arrives at step 16. ``prefill_slice_tokens=512``
    against ``None``, in
    turns (row: sliced, whole; paged: whole, sliced). Gates: sliced
    streams equal whole-prompt ones unless a bf16 tie (reported), K4 once a
    layer a paged tick. Prints the running streams' largest gap between
    tokens during the cold admission and its p99 there, the cold request's
    TTFT, tokens/s and K4's launches. Returns the paged runs' launches."""
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, max_len=8192, depth=SERVE_DEPTH,
                     dtype=torch.bfloat16, device=DEV, seed=0)
    running, cold = slice_serve_prompts()
    total = {"paged_decode": 0}
    for paged, order in ((False, (512, None)), (True, (None, 512))):
        mode = "paged" if paged else "row"
        runs = {}
        for slice_tokens in order:
            run = slice_serve_run(model, running, cold, paged, slice_tokens)
            runs[slice_tokens] = run
            want = model.depth * run["ticks"] if paged else 0
            if (run["launches"]["paged_decode"] != want
                    or sum(run["launches"].values()) != want):
                raise RuntimeError(f"engine_slice_serve {mode}: launches "
                                   f"{run['launches']}, want {want}")
            total["paged_decode"] += run["launches"]["paged_decode"]
        for slice_tokens in (512, None):
            run = runs[slice_tokens]
            equal, ties = bf16_ties(
                model, running + [cold], run["streams"],
                runs[None]["streams"], f"engine_slice_serve {mode} request")
            phase("engine_slice_serve", mode=mode,
                  prefill_slice_tokens=slice_tokens, model=serve_label(model),
                  max_len=8192, running=len(running),
                  running_new=SLICE_RUNNING_NEW,
                  cold_prompt=len(cold), tokens=run["tokens"],
                  wall_s=f"{run['wall']:.4f}",
                  tokens_per_s=f"{run['tokens'] / run['wall']:.2f}",
                  cold_ttft_s=f"{run['ttft']:.5f}",
                  admission_gaps=len(run["gaps"]),
                  admission_gap_max_ms=f"{1e3 * max(run['gaps']):.3f}",
                  admission_gap_p99_ms=(
                      f"{1e3 * float(np.percentile(run['gaps'], 99)):.3f}"),
                  gap_p50_ms=(
                      f"{1e3 * float(np.median(run['all_gaps'])):.3f}"),
                  equal_whole=f"{equal}/{len(run['streams'])}", ties=ties,
                  paged_decode_launches=run["launches"]["paged_decode"],
                  ticks=run["ticks"],
                  peak_mem_gib=f"{run['peak'] / 2**30:.3f}",
                  slowest_admission_step_ms=(
                      f"{1e3 * run['slowest']['tick_wall_s']:.3f}"),
                  its_host_ms_by_site=",".join(
                      f"{k}:{1e3 * v:.3f}" for k, v in sorted(
                          run["slowest"]["site_wall_s"].items())))
    del model
    return total


def drained_run(model, prompts, paged, path, new=32, **engine_kw):
    """The serve wave on one engine, drained at step ``DRAIN_STEP`` to
    ``path``; returns the tokens each request had then, the drain's ms and
    the snapshot's bytes."""
    eng = ServeEngine(model, paged=paged, max_slots=8, prefix_block_size=16,
                      **engine_kw)
    handles = [eng.submit(p, new) for p in prompts]
    for _ in range(DRAIN_STEP):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = eng.drain(path)
    drain_ms = 1e3 * (time.perf_counter() - t0)
    running = sum(1 for e in snap["requests"] if e["tokens"])
    if not eng.drained or running == 0 or eng.step() != 0:
        raise RuntimeError(f"engine_drain_restore: drained {running} running")
    return ([list(h.tokens) for h in handles], drain_ms,
            pathlib.Path(path).stat().st_size, running)


def restored_run(model, prompts, paged, path, **engine_kw):
    """A fresh engine restores ``path`` and runs to the end; returns the
    streams in ``prompts``' order, the seconds from the restore call to the
    first token a resumed stream emits, the launches and the ticks (a
    speculative window counts as one)."""
    eng = ServeEngine(model, device=model.device, paged=paged, max_slots=8,
                      prefix_block_size=16, telemetry_capacity=4096,
                      **engine_kw)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    restored = eng.restore(path)
    resumed = {id(h): len(h.tokens) for h in restored if h.tokens}
    first = None
    while eng.has_work:
        eng.step()
        if first is None and any(len(h.tokens) > resumed[id(h)]
                                 for h in restored if id(h) in resumed):
            first = time.perf_counter() - t0
    torch.cuda.synchronize()
    by_prompt = {tuple(int(t) for t in h.request.prompt): h
                 for h in restored}
    handles = [by_prompt[tuple(int(t) for t in p)] for p in prompts]
    for h in handles:
        if not h.done or h.finish_reason is not FinishReason.LENGTH:
            raise RuntimeError(f"engine_drain_restore: {h} unfinished")
    ticks = sum(1 for r in eng.telemetry.snapshot()
                if {"tick", "verify"} & set(r["site_wall_s"]))
    return ([list(h.tokens) for h in handles], first,
            dict(_kernels.launch_counts), ticks)


def phase_engine_drain_restore(model, prompts, pair, ref,
                               out_dir="build"):
    """Drain and restore at full width: phase 7's wave (Llama-1B bf16 at
    ``SERVE_DEPTH``, 24 x 384 prompt tokens, 256 shared, x 32 new, 8 slots)
    drained at step 10 to a file under ``build/`` and restored into a fresh
    engine: row, paged, ``spec_k=4`` n-gram (paged), and the row snapshot
    into a paged engine. Gates: every request finished with 32 tokens, the
    tokens emitted before the drain kept, the streams equal to the
    undrained wave's unless a bf16 tie (reported), K4 once a layer a paged
    restore tick. Prints the snapshot's bytes, the drain's ms and the
    restore's seconds to the first resumed token. Then an f32 depth-2 leg
    (``engine_parity``'s prompts x 16, paged, drained at step 3): restored
    streams token-exact against the undrained card engine and against the
    CPU's drained-and-restored engine. ``ref``: the undrained wave's
    streams by mode (``paged``), from ``engine_fault_serve``'s fault-free
    waves. Returns the paged restores' launches."""
    total = {"paged_decode": 0}
    drained = {}
    for leg, source, restore_paged, engine_kw in (
            ("row", "row", False, {}),
            ("paged", "paged", True, {}),
            ("spec_ngram_paged", "spec_ngram_paged", True,
             dict(spec_k=SPEC_K)),
            ("row_to_paged", "row", True, {})):
        path = str(pathlib.Path(out_dir) / f"drain_{source}.json")
        if source not in drained:
            drained[source] = drained_run(model, prompts, leg != "row",
                                          path, **engine_kw)
        partial, drain_ms, nbytes, running = drained[source]
        streams, first, launches, ticks = restored_run(
            model, prompts, restore_paged, path, **engine_kw)
        for part, s in zip(partial, streams):
            if s[:len(part)] != part:
                raise RuntimeError(f"engine_drain_restore {leg}: a resumed "
                                   "stream re-sampled a streamed token")
        want = model.depth * ticks if restore_paged and not engine_kw else 0
        if (launches["paged_decode"] != want
                or sum(launches.values()) != want):
            raise RuntimeError(f"engine_drain_restore {leg}: launches "
                               f"{launches}, want {want}")
        total["paged_decode"] += launches["paged_decode"]
        equal, ties = bf16_ties(model, prompts, streams, ref[restore_paged],
                                f"engine_drain_restore {leg} request")
        phase("engine_drain_restore", leg=leg, model=serve_label(model),
              requests=len(prompts), drain_step=DRAIN_STEP, source=source,
              running_at_drain=running, snapshot_bytes=nbytes,
              drain_ms=f"{drain_ms:.3f}",
              restore_to_first_token_s=f"{first:.4f}",
              finished=f"{len(streams)}/{len(prompts)}",
              equal_undrained=f"{equal}/{len(prompts)}", ties=ties,
              paged_decode_launches=launches["paged_decode"], ticks=ticks)
    # f32 depth 2: card against CPU, and against the undrained card.
    gpu_model, cpu_model = pair
    f32_prompts = parity_prompts()
    f32_path = str(pathlib.Path(out_dir) / "drain_snapshot_f32.json")
    undrained = faulted_run(gpu_model, f32_prompts, paged=True)["streams"]
    streams = {}
    for name, model_ in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng = ServeEngine(model_, device=model_.device, paged=True,
                          max_slots=4, prefill_len=128, prefix_block_size=16)
        for p in f32_prompts:
            eng.submit(p, FAULT_NEW)
        for _ in range(3):
            eng.step()
        eng.drain(f32_path)
        fresh = ServeEngine(model_, device=model_.device, paged=True,
                            max_slots=4, prefill_len=128,
                            prefix_block_size=16, telemetry_capacity=4096)
        _kernels.reset_launch_counts()
        restored = fresh.restore(f32_path)
        fresh.run(max_steps=400)
        by_prompt = {tuple(int(t) for t in h.request.prompt): h.tokens
                     for h in restored}
        streams[name] = [by_prompt[tuple(int(t) for t in p)]
                         for p in f32_prompts]
        if name == "cuda":
            torch.cuda.synchronize()
            launches = dict(_kernels.launch_counts)
            ticks = sum(1 for r in fresh.telemetry.snapshot()
                        if "tick" in r["site_wall_s"])
    if launches["paged_decode"] != gpu_model.depth * ticks:
        raise RuntimeError(f"engine_drain_restore f32: launches {launches} "
                           f"over {ticks} ticks")
    exact, ties = check_streams("drain f32 request", streams["cuda"],
                                streams["cpu"], f32_prompts, cpu_model,
                                FAULT_NEW)
    exact_u, ties_u = check_streams("drain f32 vs undrained",
                                    streams["cuda"], undrained, f32_prompts,
                                    cpu_model, FAULT_NEW)
    phase("engine_drain_restore", leg="f32_paged",
          model="Llama_1B_depth2_f32", allow_tf32=False,
          requests=len(f32_prompts), drain_step=3, token_exact_vs_cpu=exact,
          ties_vs_cpu=ties, equal_undrained=exact_u, ties_vs_undrained=ties_u,
          paged_decode_launches=launches["paged_decode"], ticks=ticks)
    return total


def traced_parity_names(pair):
    """The event names of each request's span, card and CPU, paged, f32 at
    depth 2 (``engine_parity``'s prompts x 16); equal or it raises."""
    names = {}
    for name, model in zip(("cuda", "cpu"), pair):
        tracer = RequestTracer()
        eng = ServeEngine(model, device=model.device, paged=True,
                          max_slots=4, prefill_len=128, prefix_block_size=16,
                          tracer=tracer)
        handles = [eng.submit(p, FAULT_NEW) for p in parity_prompts()]
        eng.run(max_steps=400)
        spans = {s["request_id"]: s for s in tracer.finished}
        names[name] = [[e["name"] for e in spans[h.request.request_id]
                        ["events"]] for h in handles]
    if names["cuda"] != names["cpu"]:
        raise RuntimeError("engine_trace_serve: the card's span events "
                           f"{names['cuda']} differ from the CPU's")
    return sum(len(n) for n in names["cuda"])


def phase_engine_trace_serve(model, prompts, pair):
    """Tracing at full width: phase 7's wave (at ``SERVE_DEPTH``) on the
    paged engine with a
    ``RequestTracer`` (a list sink) and with the default ``NULL_TRACER``,
    two waves each in turns (null, traced, traced, null): the tokens/s and
    decode-tick p50 ratios, traced over null. Gates: 24 finished spans
    reach the sink, each with its stream's tokens (``tokens_emitted``, and
    one ``decode`` event a token after the first, within the per-span
    decode budget); K4 once a layer a tick; the f32 depth-2 card run's
    event names per request equal the CPU run's. Returns the traced waves'
    launches."""
    runs = {"null": [], "traced": []}
    total = {"paged_decode": 0}
    order = ("null", "traced", "traced", "null")
    for kind in order:
        sink = []
        tracer = RequestTracer(sink=sink.append) if kind == "traced" else None
        run = serve_wave(model, prompts, paged=True, tracer=tracer,
                         telemetry_capacity=4096)
        if run["launches"]["paged_decode"] != model.depth * run["ticks"]:
            raise RuntimeError(f"engine_trace_serve: launches "
                               f"{run['launches']} over {run['ticks']} ticks")
        runs[kind].append(run)
        if kind == "null":
            continue
        total["paged_decode"] += run["launches"]["paged_decode"]
        spans = [r for r in sink if r["kind"] == "span"]
        by_id = {s["request_id"]: s for s in spans}
        budget = tracer._max_decode
        for h in run["handles"]:
            span = by_id[h.request.request_id]
            decode = sum(e["name"] == "decode" for e in span["events"])
            if (span["attrs"]["tokens_emitted"] != len(h.tokens)
                    or decode != min(len(h.tokens) - 1, budget)
                    or span["finish_reason"] != "length"):
                raise RuntimeError(f"engine_trace_serve: span {span}")
        if len(spans) != len(prompts) or tracer.spans_finished != len(prompts):
            raise RuntimeError(f"engine_trace_serve: {len(spans)} spans")
    events = traced_parity_names(pair)

    def mean(kind, fn):
        return float(np.mean([fn(r) for r in runs[kind]]))

    def tokens_s(run):
        return sum(len(h.tokens) for h in run["handles"]) / run["wall"]

    def tick_p50(run):
        return float(np.median(run["tick_s"]))

    equal, ties = bf16_ties(model, prompts,
                            [h.tokens for h in runs["traced"][0]["handles"]],
                            [h.tokens for h in runs["null"][0]["handles"]],
                            "engine_trace_serve request")
    waves = iter(runs["null"][:1] + runs["traced"] + runs["null"][1:])
    phase("engine_trace_serve", model=serve_label(model),
          requests=len(prompts),
          tokens_per_s_by_wave=",".join(
              f"{kind}:{tokens_s(next(waves)):.2f}" for kind in order),
          tokens_per_s_null=f"{mean('null', tokens_s):.2f}",
          tokens_per_s_traced=f"{mean('traced', tokens_s):.2f}",
          tokens_per_s_ratio=(
              f"{mean('traced', tokens_s) / mean('null', tokens_s):.4f}"),
          tick_ms_p50_null=f"{1e3 * mean('null', tick_p50):.4f}",
          tick_ms_p50_traced=f"{1e3 * mean('traced', tick_p50):.4f}",
          tick_p50_ratio=(
              f"{mean('traced', tick_p50) / mean('null', tick_p50):.4f}"),
          spans_finished=len(prompts), equal_null=f"{equal}/{len(prompts)}",
          ties=ties, f32_span_events_equal_cpu=events,
          paged_decode_launches=total["paged_decode"])
    return total


# ------------------------------------------- checkpoint formats (40-42)
class _StateDictHolder:
    """What ``load_hf_llama`` reads from a source with no config: its
    ``state_dict()`` (here ``export_hf_llama``'s numpy dict)."""

    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd


def phase_hf_llama_roundtrip(new: int = 16):
    """Llama-1B at full width and depth (bf16, ``max_len`` 1024): a seeded
    model through ``export_hf_llama`` (``LlamaForCausalLM`` keys, f32
    numpy) and back through ``load_hf_llama`` (a state-dict holder: no
    ``transformers`` here) into a model of another seed, state_dicts
    bitwise equal; then the imported model serves phase 6's 4 requests x
    ``new`` through ``ServeEngine(paged=True)`` (K4 once a layer a tick),
    token-equal to the source model's. Prints the export and import ms and
    the host bytes. Returns the imported model's launches."""
    torch.cuda.empty_cache()
    src = Llama_1B(vocab_size=VOCAB, max_len=MAX_LEN, dtype=torch.bfloat16,
                   device=DEV, seed=0)
    dst = Llama_1B(vocab_size=VOCAB, max_len=MAX_LEN, dtype=torch.bfloat16,
                   device=DEV, seed=7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = export_hf_llama(src)
    export_ms = 1e3 * (time.perf_counter() - t0)
    host_bytes = sum(a.nbytes for a in sd.values())
    t0 = time.perf_counter()
    load_hf_llama(_StateDictHolder(sd), dst)
    torch.cuda.synchronize()
    import_ms = 1e3 * (time.perf_counter() - t0)
    n_keys = len(sd)
    del sd
    gc.collect()
    want_sd = src.state_dict()
    bad = [k for k, v in dst.state_dict().items()
           if not torch.equal(v, want_sd[k])]
    if bad:
        raise RuntimeError(f"hf round trip changed {len(bad)} tensors: "
                           f"{bad[:5]}")
    prompts = parity_prompts()
    want, _, _ = engine_streams(src, prompts, new, paged=True)
    got, launches, ticks = engine_streams(dst, prompts, new, paged=True)
    check_launches("hf_llama_roundtrip", launches,
                   paged_decode=dst.depth * ticks)
    if got != want:
        raise RuntimeError("the imported model's streams differ from the "
                           "source model's")
    phase("hf_llama_roundtrip", model="Llama_1B_bf16", keys=n_keys,
          host_mbytes=f"{host_bytes / 1e6:.2f}", export_ms=f"{export_ms:.2f}",
          import_ms=f"{import_ms:.2f}", state_bitwise=True,
          requests=len(prompts), new=new, streams_equal=True,
          paged_decode_launches=launches["paged_decode"], ticks=ticks)
    del src, dst
    torch.cuda.empty_cache()
    return launches


def _k1_before(q, k, v, *, causal, scale, window, k_offset):
    """``flash_forward`` as it was before the op's registration: the
    checks, then the launch through ``ctypes``."""
    return tatt._flash_fwd_launch(q, k, v, bool(causal), float(scale),
                                  int(window or 0), int(k_offset), True)


def _k1_op(q, k, v, *, causal, scale, window, k_offset):
    """K1 through the registered op, as an exported program calls it."""
    return torch.ops.pddl_tpu_torch.flash_fwd(
        q, k, v, bool(causal), float(scale), int(window or 0), int(k_offset))


def _k1_call_ms(qkv, kw, calls: int = 200):
    """Wall ms of one K1 call with the LSE, launched ``calls`` times back
    to back (host and device), in turns: the eager ``flash_forward``, the
    registered op and the wrapper as before the registration."""
    fns = {"eager": lambda: tatt.flash_forward(*qkv, **kw),
           "op": lambda: _k1_op(*qkv, **kw),
           "before": lambda: _k1_before(*qkv, **kw)}
    out = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            out[name].append(1e3 * (time.perf_counter() - t0) / calls)
    return {name: min(v) for name, v in out.items()}


def phase_k1_op_cost():
    """K1's call three ways, in turns in this process: the eager
    ``flash_forward`` (a direct ``ctypes`` launch), the ``torch.library``
    op that exported programs call, and the wrapper as it was before the
    registration; at the decode artifacts' ring prefill (B 2, H 32/8, S
    128, D 64, window 1024) and at phase 10's training shape. The three
    outputs bitwise equal."""
    gen = torch.Generator(device=DEV).manual_seed(17)
    fields = {}
    for tag, shape in (("prefill", (2, 32, 8, 128, 128, 64, torch.bfloat16,
                                    True, 1024, 0)),
                       ("train", (4, 32, 8, 2048, 2048, 64, torch.bfloat16,
                                  True, None, 0))):
        qkv, _, _, kw = flash_case(gen, *shape)
        ref = _k1_before(*qkv, **kw)
        for fn in (tatt.flash_forward, _k1_op):
            got = fn(*qkv, **kw)
            if not (torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1])):
                raise RuntimeError(f"K1 through {fn.__name__} differs at "
                                   f"{tag}")
        ms = _k1_call_ms(qkv, kw, calls=200 if tag == "prefill" else 50)
        for name, v in ms.items():
            fields[f"{tag}_{name}_ms"] = f"{v:.5f}"
        fields[f"{tag}_op_extra_us"] = \
            f"{1e3 * (ms['op'] - ms['before']):.2f}"
    phase("k1_op_cost", op="pddl_tpu_torch::flash_fwd", bitwise=True,
          **fields)


def _resnet_artifact_leg(tag, model, x, ref, export_device, tol_rel):
    """One ResNet-50 inference artifact: exported on ``export_device``
    (the CPU's listing the card too), saved under ``build/``, loaded onto
    the card; its logits against the card's eager ``ref``."""
    cpu = export_device == "cpu"
    src = copy.deepcopy(model).to("cpu") if cpu else model
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        path = os.path.join(tmp, "resnet50.pt2")
        t0 = time.perf_counter()
        save_inference_artifact(path, src, None, tuple(x.shape),
                                platforms=("cpu", "cuda") if cpu else None)
        export_ms = 1e3 * (time.perf_counter() - t0)
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        call, _ = load_inference_artifact(path, device=DEV)
        load_ms = 1e3 * (time.perf_counter() - t0)
    got = call(x)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if not (torch.isfinite(got).all() and err <= tol_rel * max(1.0, scale)):
        raise RuntimeError(f"resnet artifact ({tag}): logits {err:.3e} from "
                           f"the eager forward's (scale {scale:.3e})")
    phase("export_artifacts", leg=tag, model="ResNet50_f32", batch=x.shape[0],
          image=x.shape[1], exported_on=export_device, loaded_on="cuda",
          artifact_mbytes=f"{nbytes / 1e6:.2f}", export_ms=f"{export_ms:.2f}",
          load_ms=f"{load_ms:.2f}", max_abs_err=f"{err:.3e}",
          tol=f"{tol_rel * max(1.0, scale):.3e}", bitwise=err == 0.0)
    del src


def _decode_artifact_leg(tag, model, prompt, new):
    """A greedy decode artifact of ``model`` exported on the card, saved
    under ``build/`` and loaded: its tokens against eager ``generate``'s
    (the bf16 tie rule where they part; its wall beside the loaded
    programs', the first call of each), the zip's bytes against the
    weights', and the K1 launches of the loaded prefill alone."""
    params = dict(model.state_dict())
    weights = sum(t.numel() * t.element_size() for t in params.values())
    plen = prompt.shape[1]
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        path = os.path.join(tmp, f"{tag}.zip")
        t0 = time.perf_counter()
        save_decode_artifact(path, model, None, batch=prompt.shape[0],
                             prompt_len=plen, max_new_tokens=new)
        export_ms = 1e3 * (time.perf_counter() - t0)
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        prefill, decode, manifest = load_decode_artifact(path, device=DEV)
        load_ms = 1e3 * (time.perf_counter() - t0)
    tokens = torch.as_tensor(prompt, dtype=torch.int32, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = generate(model, tokens, new)[:, plen:].cpu().tolist()
    eager_ms = 1e3 * (time.perf_counter() - t0)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cache, logits = prefill(params, tokens)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    prefill_launches = dict(_kernels.launch_counts)
    t0 = time.perf_counter()
    out = decode(params, cache, logits, 0)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(_kernels.launch_counts)
    got = out.cpu().tolist()
    equal, ties = bf16_ties(model, prompt.tolist(), got, ref,
                            f"decode artifact {tag}")
    if nbytes >= weights:
        raise RuntimeError(f"the {tag} decode artifact holds {nbytes} bytes, "
                           f"the weights {weights}")
    phase("export_artifacts", leg=tag, batch=prompt.shape[0], prompt=plen,
          new=new, zip_mbytes=f"{nbytes / 1e6:.2f}",
          weights_mbytes=f"{weights / 1e6:.2f}",
          export_ms=f"{export_ms:.2f}", load_ms=f"{load_ms:.2f}",
          prefill_ms=f"{prefill_ms:.2f}", decode_ms=f"{decode_ms:.2f}",
          ms_per_token=f"{decode_ms / new:.3f}",
          eager_generate_ms=f"{eager_ms:.2f}", streams_equal=equal,
          ties=ties, needs_pddl_tpu_torch=manifest["needs_pddl_tpu_torch"],
          prefill_flash_fwd_launches=prefill_launches["flash_fwd"],
          launches=sum(launches.values()))
    return prefill_launches


def phase_export_artifacts(batch: int = 8, prompt_len: int = 128,
                           new: int = 32, window: int = 1024,
                           depth: int = 2):
    """The serving artifacts of ``ckpt/export.py`` on the card. ResNet-50
    (1000 classes, f32, TF32 off, cuDNN deterministic), eval, B ``batch``
    x 224: an inference artifact exported on the card (its logits within
    1e-6 of the largest: the same ATen graph, so expected bitwise) and one
    exported on the CPU listing the card, moved there at load (within 1e-4
    of the largest: the CPU traces a strided 1x1 conv as a subsample then
    a 1x1 conv, ``models/resnet.py``, the same function in another cuDNN
    algorithm, ~1e-7 relative a layer through 53 eval-mode layers, as in
    ``keras_roundtrip``'s gate). Then greedy decode artifacts of Llama-1B
    at ``depth`` (bf16, ``max_len`` 1024) and of a sliding-window
    Llama-1B at ``depth`` (window 1024, ``max_len`` 4096: the ring), B 2,
    prompt ``prompt_len``,
    ``new`` new tokens: tokens equal to ``generate``'s (the bf16 tie rule
    where they part), the zip smaller than the weights, and the
    sliding-window prefill launching K1 once a layer through the
    registered op. Returns the sliding-window prefill's launches."""
    torch.cuda.empty_cache()
    with deterministic_block():
        model = ResNet50(num_classes=1000, device=DEV, seed=0).eval()
        gen = torch.Generator(device=DEV).manual_seed(3)
        x = torch.rand(batch, 224, 224, 3, generator=gen, device=DEV)
        with torch.no_grad():
            ref = model(x, train=False)
        _resnet_artifact_leg("resnet_card", model, x, ref, "cuda", 1e-6)
        _resnet_artifact_leg("resnet_cpu_moved", model, x, ref, "cpu", 1e-4)
    del model, ref, x
    torch.cuda.empty_cache()
    prompt = np.random.RandomState(21).randint(0, VOCAB, (2, prompt_len))
    llama = Llama_1B(vocab_size=VOCAB, max_len=MAX_LEN, dtype=torch.bfloat16,
                     device=DEV, seed=0, depth=depth)
    launches = _decode_artifact_leg(f"llama1b_depth{depth}_decode", llama,
                                    prompt, new)
    check_launches("llama1b decode artifact prefill", launches)
    del llama
    torch.cuda.empty_cache()
    swa = Llama_1B(vocab_size=VOCAB, max_len=4096, sliding_window=window,
                   dtype=torch.bfloat16, device=DEV, seed=0, depth=depth)
    launches = _decode_artifact_leg(
        f"llama1b_depth{depth}_window{window}_decode", swa, prompt, new)
    check_launches("sliding-window decode artifact prefill", launches,
                   flash_fwd=swa.depth)
    del swa
    torch.cuda.empty_cache()
    return launches


DP_CKPT_STEPS, DP_CKPT_SAVE, DP_CKPT_LR = 4, 2, 1e-3


class _Stopped(Exception):
    """The end of a run cut short on purpose."""


class _StopAt(Callback):
    def __init__(self, n):
        self.n = n

    def on_train_batch_end(self, step, logs):
        if self.trainer.step == self.n:
            raise _Stopped


def _dp_ckpt_trainer(strategy):
    return Trainer(ResNet50(num_classes=1000, device=DEV, seed=3),
                   optimizer="adam", learning_rate=DP_CKPT_LR, device=DEV,
                   strategy=strategy)


def dp_ckpt_runs(mode: str, rank: int, out_dir: str) -> None:
    """One of two processes on the card over gloo (the group open) under
    ``ps`` (min 256 KiB), ResNet-50 f32 (cuDNN deterministic), adam,
    ``rank``'s 16 rows of each global 32. ``run`` (in
    ``dp_gloo2_child``'s processes, after its parity legs): 4 steps
    uninterrupted, then 2 under ``CheckpointEveryN`` (stopped after its
    save at step 2); ``resume`` (fresh processes, ``dp_ckpt_child``): a
    fresh trainer through ``fit(resume=)`` to step 4. Writes the
    checksums of its state to ``out_dir``."""
    _deterministic()
    batches = dp_batches(DP_CKPT_STEPS, 16, start=16 * rank)
    directory = os.path.join(out_dir, "ckpt")
    out = {}
    fit = dict(epochs=1, steps_per_epoch=DP_CKPT_STEPS, verbose=0)
    if mode == "run":
        clean = _dp_ckpt_trainer(dp_strategy("ps", backend="gloo"))
        clean.fit(batches, **fit)
        out["clean"] = tree_checksums(clean.state_dict())
        del clean
        cut = _dp_ckpt_trainer(dp_strategy("ps", backend="gloo"))
        t0 = time.perf_counter()
        try:
            cut.fit(batches, callbacks=[
                CheckpointEveryN(directory, every_n_steps=DP_CKPT_SAVE,
                                 async_save=False),
                _StopAt(DP_CKPT_SAVE)], **fit)
            raise RuntimeError("the cut run was not stopped")
        except _Stopped:
            pass
        out["cut_s"] = time.perf_counter() - t0
    else:
        resumed = _dp_ckpt_trainer(dp_strategy("ps", backend="gloo"))
        t0 = time.perf_counter()
        resumed.fit(batches, resume=directory, **fit)
        out["resume_s"] = time.perf_counter() - t0
        out["resumed"] = tree_checksums(resumed.state_dict())
        out["step"] = resumed.step
    pathlib.Path(out_dir, f"dp_ckpt_{mode}_{rank}.json").write_text(
        json.dumps(out))


def dp_ckpt_child(rank: int, port: int, out_dir: str) -> None:
    """``--dp-ckpt-child RANK PORT DIR``: a fresh process of the two that
    resume ``dp_ckpt_runs``'s save."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
        rank=rank)
    try:
        dp_ckpt_runs("resume", rank, out_dir)
    finally:
        torch.distributed.destroy_process_group()


def _two_processes(args, timeout: float, what: str) -> None:
    """Two children of this script, under one deadline that kills every
    survivor; a child that fails fails the phase."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, *args(rank, port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(
                    timeout=max(0.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                logs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log_) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{what}: process {rank} exited "
                               f"{p.returncode}:\n{log_[-4000:]}")


def phase_dp_ckpt_gloo2(out_dir: str, timeout: float = 300.0):
    """Checkpoints of a strategy over two processes (``dp_ckpt_runs``):
    two processes share the card over gloo under ``ps`` (``dp_parity_gloo2``'s,
    which ran the uninterrupted and the cut run into ``out_dir``); the save
    at step 2 is rank 0's, world-size free (ps's Adam slices gathered
    whole). Fresh processes resume from it to step 4: each process's state
    bitwise the uninterrupted run's. The same save restores into this one
    process (``strategy=None``): every Adam moment whole, the state as
    saved, then 2 steps on the global batch of 32, its parameters within
    3·lr a step of a ``strategy=None`` run of the 4 steps
    (``dp_parity_gloo2``'s Adam bound: a near-zero gradient whose sign
    flips moves its parameter 2·lr). Prints the save's MB, the runs'
    seconds and the restore's ms."""
    _two_processes(lambda rank, port: (
        "--dp-ckpt-child", str(rank), str(port), out_dir),
        timeout, "dp_ckpt_gloo2 resume")
    seen = {(mode, r): json.loads(pathlib.Path(
        out_dir, f"dp_ckpt_{mode}_{r}.json").read_text())
        for mode in ("run", "resume") for r in range(2)}
    bitwise = [seen[("run", r)]["clean"] == seen[("resume", r)]["resumed"]
               for r in range(2)]
    if not all(bitwise) or seen[("resume", 0)]["step"] != DP_CKPT_STEPS:
        raise RuntimeError(f"dp_ckpt_gloo2: resumed run bitwise {bitwise}")
    ckpt = Checkpointer(os.path.join(out_dir, "ckpt"), read_only=True)
    steps = ckpt.all_steps()
    if steps != [DP_CKPT_SAVE]:
        raise RuntimeError(f"dp_ckpt_gloo2: saves {steps}")
    save_mb = sum(f.stat().st_size for f in pathlib.Path(
        ckpt.directory, str(DP_CKPT_SAVE)).iterdir()) / 1e6
    with deterministic_block():
        one = _dp_ckpt_trainer(None)
        t0 = time.perf_counter()
        state, meta = ckpt.restore(step=DP_CKPT_SAVE)
        one.load_state_dict(local_state(one, state, meta))
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        params = dict(one.model.named_parameters())
        whole = all(one.optimizer.state[p]["exp_avg"].shape == p.shape
                    for p in params.values())
        as_saved = tree_checksums(one.state_dict()) == tree_checksums(state)
        if not (whole and as_saved):
            raise RuntimeError(f"dp_ckpt_gloo2 into one process: moments "
                               f"whole {whole}, state as saved {as_saved}")
        one.fit(dp_batches(DP_CKPT_STEPS, 32)[DP_CKPT_SAVE:], epochs=1,
                steps_per_epoch=DP_CKPT_STEPS - DP_CKPT_SAVE, verbose=0)
        ref = _dp_ckpt_trainer(None)
        ref.fit(dp_batches(DP_CKPT_STEPS, 32), epochs=1,
                steps_per_epoch=DP_CKPT_STEPS, verbose=0)
        sd, rsd = one.model.state_dict(), ref.model.state_dict()
        diff = max(float((sd[k] - rsd[k]).abs().max()) for k in rsd
                   if "running" not in k and rsd[k].is_floating_point())
        bound = 3 * DP_CKPT_LR * DP_CKPT_STEPS
        if not diff <= bound:
            raise RuntimeError(f"dp_ckpt_gloo2 into one process: parameters "
                               f"{diff:.3g} from strategy=None's run")
    phase("dp_ckpt_gloo2", model="ResNet50_f32", processes=2,
          backend="gloo", device="cuda:0 (shared)", strategy="ps",
          optimizer="adam", steps=DP_CKPT_STEPS, saved_at=DP_CKPT_SAVE,
          resumed_bitwise=True, owners=len(meta.get("param_state", {})),
          save_mbytes=f"{save_mb:.2f}",
          cut_run_s=f"{seen[('run', 0)]['cut_s']:.3f}",
          resume_run_s=f"{seen[('resume', 0)]['resume_s']:.3f}",
          restore_ms=f"{restore_ms:.2f}", one_process_moments_whole=True,
          one_process_param_diff=f"{diff:.3g}",
          one_process_bound=f"{bound:g}")
    del one, ref
    torch.cuda.empty_cache()

# ------------------------------------------ tensor and expert parallelism
# The routed Llama: Llama-1B's widths with Mixtral's routing (8 experts,
# top-2) in every 4th block from the back (blocks 15, 11, 7, 3): one
# card's memory holds its f32 weights, gradients and Adam moments
# (~2.91 B parameters, ~46.5 GB), where Mixtral's every block would not.
MOE_CFG = dict(moe_experts=8, moe_top_k=2, moe_every=4)
TP_LR, TP_STEPS, TP_SEQ = 1e-2, 1, 1024
EP_DEPTH = 8                      # the EP parity model: blocks 7 and 3 routed
TP_DECODE = dict(batch=2, prompt=128, new=16, draft_len=4)
MOE_PARITY_DEPTH, MOE_PARITY_SEQ = 4, 64


def _tp_batches(seq: int = TP_SEQ, seed: int = 4):
    data = SyntheticLanguageModeling(batch_size=1, seq_len=seq,
                                     vocab_size=VOCAB, seed=seed)
    return [{k: torch.from_numpy(v).to(DEV) for k, v in data.batch(i).items()}
            for i in range(TP_STEPS)]


def _reference_run(factory, batches):
    """The single-process SGD run of ``factory()``: its losses, gradient
    norms and trained state (on the card)."""
    tr = Trainer(factory(), optimizer="sgd", learning_rate=TP_LR,
                 device=DEV, log_grad_norm=True, **LM_KEYS)
    hist = tr.fit(batches, epochs=TP_STEPS, steps_per_epoch=1, verbose=0)
    state = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    del tr
    torch.cuda.empty_cache()
    return hist.history, state


def _sharded_run(tag, factory, strategy, batches, ref, out):
    """``factory()`` under ``strategy`` (SGD, the same batches): its
    losses and gradient norm against the reference's, every local block
    against the reference's block, the bytes a process holds, the
    launches and the collectives a step makes. Fills ``out``."""
    model = factory()
    whole = sum(p.numel() * p.element_size() for p in model.parameters())
    experts = sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters() if ".moe.w" in n)
    tr = Trainer(model, optimizer="sgd", learning_rate=TP_LR, device=DEV,
                 strategy=strategy, log_grad_norm=True, **LM_KEYS)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    collectives.reset_tp_counts()
    t0 = time.perf_counter()
    hist = tr.fit(batches, epochs=TP_STEPS, steps_per_epoch=1, verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    counts = {k: v for k, v in collectives.TP_COUNTS.items()}
    ref_hist, ref_state = ref
    local = tr.model.state_dict()
    diff = max(float((local[k] - strategy.local_state(k, ref_state[k]))
                     .abs().max()) for k in local)
    out[tag] = dict(
        loss=hist.history["loss"], ref_loss=ref_hist["loss"],
        loss_rel=max(abs(a - b) / abs(b) for a, b in zip(
            hist.history["loss"], ref_hist["loss"])),
        grad_norm_rel=max(abs(a - b) / abs(b) for a, b in zip(
            hist.history["grad_norm"], ref_hist["grad_norm"])),
        param_diff=diff, whole_bytes=whole, expert_bytes_whole=experts,
        depth=model.depth,
        local_bytes=sum(p.numel() * p.element_size()
                        for p in tr.model.parameters()),
        local_expert_bytes=sum(p.numel() * p.element_size()
                               for n, p in tr.model.named_parameters()
                               if ".moe.w" in n),
        step_s=wall / TP_STEPS,
        launches={k: launches[k] for k in FLASH_COUNTERS},
        collectives_per_step={k: [v[0] / TP_STEPS, v[1] / TP_STEPS]
                              for k, v in counts.items()})
    del tr, model
    torch.cuda.empty_cache()


def _decode_leg(rank, out):
    """``generate`` and ``generate_speculative`` of full-width, full-depth
    Llama-1B in f32 under TP2 against the single process's, with ms a
    token on both and the top-2 margins of the reference's decoded
    positions."""
    cfg = TP_DECODE
    model = Llama_1B(vocab_size=VOCAB, dtype=torch.float32, device=DEV,
                     seed=6)
    gen = np.random.default_rng(8)
    prompt = torch.from_numpy(gen.integers(
        0, VOCAB, (cfg["batch"], cfg["prompt"])).astype(np.int32)).to(DEV)
    tp = TensorParallelStrategy(2, rules=LLAMA_TP_RULES, device=DEV,
                                backend="gloo")
    sharded = tp.shard_model(model)
    timed = {}
    for tag, fn in (
            ("single", lambda: generate(model, prompt, cfg["new"])),
            ("tp2", lambda: generate(sharded, prompt, cfg["new"],
                                     strategy=tp)),
            ("spec_single", lambda: generate_speculative(
                model, prompt, cfg["new"], draft_len=cfg["draft_len"])),
            ("spec_tp2", lambda: generate_speculative(
                sharded, prompt, cfg["new"], draft_len=cfg["draft_len"],
                strategy=tp))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed[tag] = fn()
        torch.cuda.synchronize()
        out[f"decode_{tag}_ms_per_token"] = (
            1e3 * (time.perf_counter() - t0) / cfg["new"])
    ref = timed["single"]
    with torch.no_grad():
        logits = model(ref[:, :-1], train=False)[:, cfg["prompt"] - 1:]
    top = logits.topk(2, dim=-1).values
    margins = (top[..., 0] - top[..., 1]).cpu()
    for tag in ("tp2", "spec_single", "spec_tp2"):
        got = timed[tag]
        same = (got == ref).cpu()
        exact = bool(same.all())
        tie = False
        if not exact:
            # A divergence is a tie when the reference's top-2 margin at
            # the first differing position is under 1e-3.
            rows = (~same).any(dim=1).nonzero().flatten()
            tie = all(float(margins[r, int((~same[r]).nonzero()[0])
                                    - cfg["prompt"]]) < 1e-3 for r in rows)
        out[f"decode_{tag}_exact"] = exact
        out[f"decode_{tag}_tie"] = tie
    out["decode_min_margin"] = float(margins.min())
    out["decode_cache_heads"] = sharded.cache_kv_heads
    del model, sharded
    torch.cuda.empty_cache()


def tp_gloo2_child(rank: int, port: int, out_dir: str) -> None:
    """``--tp-gloo2-child RANK PORT DIR``: one of two processes sharing the
    card over gloo. Full-width, full-depth Llama-1B (f32, TF32 off) at
    B 1 x S 1024: one SGD step single-process, then under
    ``TensorParallelStrategy(2, rules=LLAMA_TP_RULES)``; then the TP2
    decode; then the routed Llama at depth 8 (blocks 7 and 3 routed) the
    same way under ``ExpertParallelStrategy(2, rules=LLAMA_EP_RULES)``
    (4 experts a process). Writes what it saw to
    ``out_dir/tp_gloo2_{rank}.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
        rank=rank)
    out = {"rank": rank}
    batches = _tp_batches()
    try:
        def dense():
            return Llama_1B(vocab_size=VOCAB, dtype=torch.float32,
                            device=DEV, seed=5)

        def routed():
            return Llama_1B(vocab_size=VOCAB, dtype=torch.float32,
                            device=DEV, seed=7, depth=EP_DEPTH, **MOE_CFG)

        _sharded_run("tp", dense, TensorParallelStrategy(
            2, rules=LLAMA_TP_RULES, device=DEV, backend="gloo"), batches,
            _reference_run(dense, batches), out)
        _decode_leg(rank, out)
        _sharded_run("ep", routed, ExpertParallelStrategy(
            2, rules=LLAMA_EP_RULES, device=DEV, backend="gloo"), batches,
            _reference_run(routed, batches), out)
    finally:
        torch.distributed.destroy_process_group()
    pathlib.Path(out_dir, f"tp_gloo2_{rank}.json").write_text(
        json.dumps(out))


def phase_tp_gloo2(out_dir: str, timeout: float = 420.0):
    """``tp_parity_gloo2``, ``tp_decode_gloo2`` and ``ep_parity_gloo2``
    (``tp_gloo2_child``'s two processes): each process's loss within 1e-4
    relative of the single-process step's, the gradient norm within 1e-3
    relative, every local block within 2·lr of the single process's
    trained block; the decode token-exact (or a tie). Returns each
    sharded run's launches."""
    out_dir = pathlib.Path(out_dir)
    _two_processes(lambda rank, port: ("--tp-gloo2-child", str(rank),
                                       str(port), str(out_dir)),
                   timeout, "tp_gloo2")
    seen = [json.loads((out_dir / f"tp_gloo2_{r}.json").read_text())
            for r in range(2)]
    gates = {"loss_rel": 1e-4, "grad_norm_rel": 1e-3,
             "param_diff": 2 * TP_LR}
    bad = []
    for tag, name, model in (
            ("tp", "tp_parity_gloo2", "Llama_1B_f32"),
            ("ep", "ep_parity_gloo2",
             f"Llama_1B_moe8_top2_every4_depth{EP_DEPTH}_f32")):
        runs = [x[tag] for x in seen]
        worst = {k: max(r[k] for r in runs) for k in gates}
        r0 = runs[0]
        per_step = ",".join(f"{k}:{v[0]:g}calls/{v[1] / 1e6:.2f}MB"
                            for k, v in
                            sorted(r0["collectives_per_step"].items()))
        phase(name, model=model, processes=2, backend="gloo",
              device="cuda:0 (shared)", batch=1, seq=TP_SEQ,
              optimizer="sgd", lr=TP_LR, steps=TP_STEPS,
              losses="/".join(f"{x:.7f}" for x in r0["loss"]),
              ref_losses="/".join(f"{x:.7f}" for x in r0["ref_loss"]),
              **{k: f"{v:.3g}" for k, v in worst.items()},
              **{f"{k}_bound": f"{v:g}" for k, v in gates.items()},
              whole_param_bytes=r0["whole_bytes"],
              param_bytes_per_rank="/".join(str(r["local_bytes"])
                                           for r in runs),
              expert_bytes_whole=r0["expert_bytes_whole"],
              expert_bytes_per_rank="/".join(str(r["local_expert_bytes"])
                                            for r in runs),
              step_s=f"{r0['step_s']:.3f}",
              flash_per_step="/".join(f"{k}:{v / TP_STEPS:g}" for k, v
                                      in r0["launches"].items()),
              collectives_per_step=per_step)
        bad += [f"{tag}_{k}" for k, lim in gates.items()
                if not worst[k] <= lim]
        want = r0["depth"] * TP_STEPS
        if (r0["launches"]["flash_fwd"] != want
                or r0["launches"]["flash_bwd_fused"] != want):
            bad.append(f"{tag}_launches {r0['launches']}")
    r0 = seen[0]
    phase("tp_decode_gloo2", model="Llama_1B_f32", processes=2,
          strategy="tensor_parallel", batch=TP_DECODE["batch"],
          prompt=TP_DECODE["prompt"], new=TP_DECODE["new"],
          draft_len=TP_DECODE["draft_len"],
          cache_kv_heads_per_rank=r0["decode_cache_heads"],
          **{f"{t}_exact": r0[f"decode_{t}_exact"]
             for t in ("tp2", "spec_single", "spec_tp2")},
          **{f"{t}_tie": r0[f"decode_{t}_tie"]
             for t in ("tp2", "spec_single", "spec_tp2")},
          min_top2_margin=f"{r0['decode_min_margin']:.3g}",
          **{f"{t}_ms_per_token": f"{r0[f'decode_{t}_ms_per_token']:.3f}"
             for t in ("single", "tp2", "spec_single", "spec_tp2")})
    for t in ("tp2", "spec_single", "spec_tp2"):
        if not (r0[f"decode_{t}_exact"] or r0[f"decode_{t}_tie"]):
            bad.append(f"decode_{t}")
    if bad:
        raise RuntimeError(f"tp_gloo2 out of tolerance: {bad}")
    return {tag: seen[0][tag]["launches"] for tag in ("tp", "ep")}


def _routing_diff(gpu_model, cpu_model, tokens):
    """The routed block 3's training-mode choices on the card and on the
    CPU for the CPU's block input (captured by a hook in the CPU's eval
    forward): ``(exact, ties, capacity, the CPU's eval logits)`` — a
    choice that differs is a tie when the CPU's probabilities at it
    differ by under 1e-5."""
    seen = {}
    blk = MOE_PARITY_DEPTH - 1

    def keep(module, args):  # returns None: the call's arguments stand
        seen["h"] = args[0].detach()

    hook = cpu_model.blocks[blk].moe.register_forward_pre_hook(keep)
    with torch.no_grad():
        logits = cpu_model(tokens, train=False)
    hook.remove()
    h = seen["h"]
    with torch.no_grad():
        rc = cpu_model.blocks[blk].moe.routing(h, True)
        rg = gpu_model.blocks[blk].moe.routing(h.to(DEV), True)
    exact, ties = True, 0
    for j in range(len(rc.expert)):
        for field in ("expert", "kept", "position"):
            a = getattr(rc, field)[j]
            b = getattr(rg, field)[j].cpu()
            if not torch.equal(a, b):
                exact = False
    if not exact:
        probs = rc.probs.sort(dim=-1, descending=True).values
        gaps = (probs[..., :-1] - probs[..., 1:]).amin(dim=-1)
        ties = int((gaps < 1e-5).sum())
    return exact, ties, rc.capacity, logits


def phase_moe_parity(lr: float = 1e-2):
    """The routed Llama at Llama-1B's width and depth 4 (block 3 routed),
    f32 with TF32 off, one seeded weight set on the card (kernels) and on
    the CPU (plain versions): block 3's router choices, kept set and
    queue positions on the same input exact (or ties); eval logits
    within 1e-4; one SGD step's loss within rtol 1e-5 and every
    parameter's gradient within 1e-3 of its max-abs. Returns the card
    model (for ``mixtral_roundtrip``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(vocab_size=VOCAB, depth=MOE_PARITY_DEPTH, dtype=torch.float32,
              seed=9, **MOE_CFG)
    gpu_model = Llama_1B(device=DEV, **kw)
    cpu_model = cpu_copy(gpu_model, **kw)
    data = SyntheticLanguageModeling(batch_size=2, seq_len=MOE_PARITY_SEQ,
                                     vocab_size=VOCAB, seed=2).batch(0)
    tokens = torch.from_numpy(data["tokens"])
    exact, ties, capacity, lc = _routing_diff(gpu_model, cpu_model, tokens)
    with torch.no_grad():
        lg = gpu_model(tokens.to(DEV), train=False).cpu()
    logit_err = float((lg - lc).abs().max())
    losses, grad_rel = {}, {}
    for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        tr = Trainer(model, optimizer="sgd", learning_rate=lr,
                     device=model.device, **LM_KEYS)
        logs = tr.train_step(data)
        losses[name] = (float(logs["loss"]), float(logs["moe_drop_rate"]))
    cpu_params = dict(cpu_model.named_parameters())
    for n, p in gpu_model.named_parameters():
        c = cpu_params[n].grad
        grad_rel[n] = float((p.grad.cpu() - c).abs().max()) / float(
            c.abs().max())
    worst = max(grad_rel, key=grad_rel.get)
    rel = abs(losses["cuda"][0] - losses["cpu"][0]) / losses["cpu"][0]
    phase("moe_parity", model=f"Llama_1B_moe8_top2_depth{MOE_PARITY_DEPTH}"
          "_f32", allow_tf32=False, batch=2, seq=MOE_PARITY_SEQ,
          capacity=capacity,
          routing_exact=exact, routing_ties=ties,
          logits_max_abs_err=f"{logit_err:.3g}", logits_bound="1e-4",
          loss_cuda=f"{losses['cuda'][0]:.7f}",
          loss_cpu=f"{losses['cpu'][0]:.7f}", loss_rel=f"{rel:.3g}",
          drop_rate_cuda=f"{losses['cuda'][1]:.6f}",
          drop_rate_cpu=f"{losses['cpu'][1]:.6f}",
          max_grad_rel_diff=f"{grad_rel[worst]:.3g}", worst_leaf=worst,
          grad_bound=f"{GRAD_TOL[torch.float32]:g}")
    if not (exact or ties):
        raise RuntimeError("moe_parity: routing differs away from a tie")
    if not (logit_err <= 1e-4 and rel <= 1e-5
            and grad_rel[worst] <= GRAD_TOL[torch.float32]
            and losses["cuda"][1] == losses["cpu"][1]):
        raise RuntimeError(f"moe_parity out of tolerance: {losses} "
                           f"logits {logit_err} {worst} {grad_rel[worst]}")
    del cpu_model
    return gpu_model


def phase_mixtral_roundtrip(model):
    """``export_hf_llama`` then ``load_hf_mixtral`` of the routed Llama
    (the card's machine has no ``transformers``: the state dict's round
    trip), bitwise but the router's bias (Mixtral has none), every routed
    block's experts in Mixtral's keys."""
    t0 = time.perf_counter()
    sd = export_hf_llama(model)
    export_ms = 1e3 * (time.perf_counter() - t0)
    back = Llama_1B(vocab_size=VOCAB, depth=MOE_PARITY_DEPTH,
                    dtype=torch.float32, device=DEV, seed=10, **MOE_CFG)

    class _Holder:
        def state_dict(self):
            return sd

    t0 = time.perf_counter()
    load_hf_mixtral(_Holder(), back)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    # Mixtral's gate has no bias: the router's bias is not exported (as
    # in the JAX package) and keeps the loading model's.
    a, b = model.state_dict(), back.state_dict()
    bitwise = all(torch.equal(a[k], b[k]) for k in a
                  if not k.endswith("router.bias"))
    experts = sum(1 for k in sd if ".block_sparse_moe.experts." in k)
    phase("mixtral_roundtrip", model=f"Llama_1B_moe8_top2_depth"
          f"{MOE_PARITY_DEPTH}_f32", hf_keys=len(sd), expert_keys=experts,
          bitwise=bitwise, export_ms=f"{export_ms:.1f}",
          load_ms=f"{load_ms:.1f}")
    if not bitwise or experts != 8 * 3:
        raise RuntimeError("mixtral_roundtrip: not bitwise")
    del back, sd


def phase_moe_train(batch: int = 2, seq: int = 2048, warmup: int = 1,
                    steps: int = 3):
    """The routed Llama at full depth (blocks 15, 11, 7, 3 routed), bf16
    compute over f32 parameters, adamw, B 2 x S 2048 through
    ``Trainer.fit``: tokens/s, the 6ND MFU over the parameters a token
    meets (the dense ones and 2 of 8 experts), the losses with their aux
    terms, ``moe_drop_rate``, peak memory, and K1/K2 launches (one each a
    layer a step)."""
    torch.cuda.empty_cache()
    model = Llama_1B(vocab_size=VOCAB, dtype=torch.bfloat16,
                     param_dtype=torch.float32, device=DEV, seed=11,
                     **MOE_CFG)
    n_params = sum(p.numel() for p in model.parameters())
    experts = sum(p.numel() for n, p in model.named_parameters()
                  if ".moe.w" in n)
    active = (n_params - model.stem.embed.weight.numel() - experts
              + experts * MOE_CFG["moe_top_k"] // MOE_CFG["moe_experts"])
    tr, data, hist, wall, counts, tokens_s, _, peak = _timed_fit(
        model, batch, seq, warmup, steps)
    mfu = 6 * active * tokens_s / PEAK_FLOPS[torch.bfloat16]
    with torch.no_grad():
        model(torch.from_numpy(data.batch(warmup + steps)["tokens"]).to(DEV))
    aux = sum(float(v) for v in sown(model)["losses"]["moe_aux_loss"])
    losses = hist.history["loss"]
    phase("moe_train", model="Llama_1B_moe8_top2_every4_bf16_compute_f32"
          "_params", params=n_params, expert_params=experts,
          active_matmul_params=active, batch=batch, seq=seq, steps=steps,
          wall_s=f"{wall:.4f}", ms_per_step=f"{1e3 * wall / steps:.3f}",
          tokens_per_s=f"{tokens_s:.2f}", mfu_6nd_active=f"{mfu:.4f}",
          peak_mem_gib=f"{peak / 2**30:.3f}",
          losses="/".join(f"{x:.5f}" for x in losses),
          moe_drop_rate="/".join(f"{x:.5f}" for x in
                                 hist.history["moe_drop_rate"]),
          last_aux_loss=f"{aux:.6f}",
          flash_per_step="/".join(f"{k}:{counts[k] / steps:g}"
                                  for k in FLASH_COUNTERS))
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"moe_train: non-finite losses {losses}")
    want = {"flash_fwd": model.depth * steps,
            "flash_bwd_fused": model.depth * steps, "flash_fwd_nolse": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if {k: counts[k] for k in want} != want:
        raise RuntimeError(f"moe_train launches {counts}, want {want}")
    del tr, data, model
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------ phases 38f-38j: SP and PP
# One ring rotation of Llama-1B at seq 2 (B 1 x S 8192 over two
# processes: 4096 tokens a process): the diagonal (causal), a past shard
# (no mask), and a windowed rotation (window 4096, keys 4096 back).
SP_SHAPES = {
    "sp_ring_diag": (1, 32, 8, 4096, 4096, 64, torch.bfloat16, True, None, 0),
    "sp_ring_past": (1, 32, 8, 4096, 4096, 64, torch.bfloat16, False, None,
                     0),
    "sp_ring_window": (1, 32, 8, 4096, 4096, 64, torch.bfloat16, True, 4096,
                       -4096),
}
SP_LR, SP_PARITY_SEQ, SP_WINDOW = 1e-2, 2048, 512
# One warm-up and one timed step (a step is ~9 s of gloo-staged
# gradient all-reduce): the script's time limit.
SP_TRAIN = dict(batch=1, seq=8192, warmup=1, steps=1)
PP_PARITY = dict(batch=2, seq=512, images=4, microbatches=2)
PP_TRAIN = dict(batch=4, seq=2048, warmup=1, steps=2, blocks=8)
# remat_stages in pp_train_gloo2: without it each process's 8 blocks keep
# B 4 x S 2048's activations beside the head's 4.2 GB of f32 logits on
# every stage, and the pair ran out of the card's 80 GB.
PP_REMAT = True
GLOO2_GATES = {"loss_rel": 1e-4, "grad_norm_rel": 1e-3}   # phase 38b's
# The SGD parity legs' parameter gate, a share of each part's update
# (``_one_process_step``): the gradient norm's 1e-3.
PARAM_STEP_REL = 1e-3
# The GPipe models' widths: Llama-1B's and ViT-S/16's.
GPIPE_LLAMA_WIDTHS = dict(embed_dim=2048, num_heads=32, num_kv_heads=8,
                          intermediate_dim=8192, rope_theta=500000.0)
GPIPE_VIT_WIDTHS = dict(patch_size=16, embed_dim=384, num_heads=6,
                        num_classes=1000)
# The train phases' figures for the comparisons of the new ones.
PHASE_FIGURES: dict = {}


def masked_pairs(sq: int, sk: int, causal: bool, window, k_offset: int) -> int:
    """The (query, key) pairs a flash call's mask keeps: what this
    call's work is."""
    if not causal:
        return sq * sk
    t = torch.arange(sq)[:, None]
    j = torch.arange(sk)[None, :] + k_offset
    keep = t >= j
    if window is not None:
        keep &= j > t - window
    return int(keep.sum())


def _ring_bounds(q, k, pairs):
    """K1's (with LSE) and K2's (with ``dlse``) bounds for ``pairs`` kept
    pairs: 4·B·H·pairs·D forward flops and 10·B·H·pairs·D backward over
    the bf16 peak, or their tensors' bytes once (K2 also reads dlse)."""
    b, h, s, d = q.shape
    row = b * h * s * 4
    fwd = _bound((2 * q.numel() + 2 * k.numel()) * q.element_size() + row,
                 4 * b * h * pairs * d, q.dtype)
    bwd = _bound((4 * q.numel() + 4 * k.numel()) * q.element_size()
                 + 2 * row, 10 * b * h * pairs * d, q.dtype)
    return fwd, bwd


def phase_sp_kernels():
    """K1 with its LSE and K2 with an LSE cotangent at a ring rotation's
    shapes (``SP_SHAPES``): each against its plain version (K1 within
    TOL, K2 within GRAD_TOL of each gradient's max-abs; a row that sees
    no key is held to an lse at NEG_INF and gets the ring's zero
    cotangents), then timed on
    CUDA events beside the plain version, SDPA (a boolean mask for the
    windowed rotation) and the bound over the pairs the mask keeps.
    Returns ``{kernel: {shape: fields}}``."""
    gen = torch.Generator(device=DEV).manual_seed(19)
    out = {"flash_fwd": {}, "flash_bwd_fused": {}}
    bad = []
    for tag, shape in SP_SHAPES.items():
        b, h, hkv, sq, sk, d, dtype, causal, window, k_off = shape
        cases = []
        for _ in range(2):
            qkv, do, dlse, kw = flash_case(gen, *shape)
            o, lse = tatt.flash_forward(*qkv, **kw)
            cases.append((qkv, o, lse, do, dlse))
        c = cases[0]
        ref_o, ref_lse = tatt.flash_forward_plain(*c[0], **kw)
        # A row whose keys all lie outside the window (the windowed
        # rotation's last) has no softmax: its lse is NEG_INF and the
        # ring's merge weighs it 0, so its o is not a result and its
        # cotangents are 0 (``ops/ring_attention.py``), as here.
        live = ref_lse > -1e29
        empty = int((~live).sum())
        for cs_ in cases:
            cs_[3].mul_(live[..., None].to(cs_[3].dtype))
            cs_[4].mul_(live)
        got = tatt.flash_backward(*c[0], ref_o, ref_lse, c[3], c[4], **kw)
        want = tatt.flash_backward_plain(*c[0], ref_o, ref_lse, c[3], c[4],
                                         **kw)
        torch.cuda.synchronize()
        if not (torch.isfinite(c[1].float()).all()
                and all(torch.isfinite(g.float()).all() for g in got)):
            raise RuntimeError(f"sp_kernels {tag}: non-finite output")
        if empty and not bool((c[2][~live] <= -1e29).all()):
            bad.append(f"{tag}_flash_fwd lse of an empty row above -1e29")
        fwd_err = max(float((c[1].float() - ref_o.float())[live].abs().max()),
                      float((c[2] - ref_lse)[live].abs().max()))
        bwd_abs = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
        bwd_rel = max(float((g.float() - w.float()).abs().max())
                      / float(w.float().abs().max())
                      for g, w in zip(got, want))
        del got, want, ref_o, ref_lse
        if not fwd_err <= TOL[dtype]:
            bad.append(f"{tag}_flash_fwd {fwd_err:.3g}")
        if not bwd_rel <= GRAD_TOL[dtype]:
            bad.append(f"{tag}_flash_bwd_dlse {bwd_rel:.3g}")
        fwd_ms = cuda_ms(lambda i: tatt.flash_forward(*cases[i][0], **kw), 2,
                         iters=20)
        plain_fwd = cuda_ms(lambda i: tatt.flash_forward_plain(
            *cases[i][0], **kw), 2, iters=2)
        bwd_ms = cuda_ms(lambda i: tatt.flash_backward(
            *cases[i][0], *cases[i][1:], **kw), 2, iters=10)
        plain_bwd = cuda_ms(lambda i: tatt.flash_backward_plain(
            *cases[i][0], *cases[i][1:], **kw), 2, iters=2)
        mask = None
        if causal and (window is not None or k_off):
            t = torch.arange(sq, device=DEV)[:, None]
            j = torch.arange(sk, device=DEV)[None, :] + k_off
            mask = (t >= j) & (j > t - window)
        leaves = [[x.detach().requires_grad_() for x in cs[0]]
                  for cs in cases]

        def sdpa(i, backward):
            o = F.scaled_dot_product_attention(
                *leaves[i], attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
            if backward:
                o.backward(cases[i][3])
        sdpa_f = cuda_ms(lambda i: sdpa(i, False), 2, iters=10)
        sdpa_fb = cuda_ms(lambda i: sdpa(i, True), 2, iters=10)
        q, k = c[0][:2]
        pairs = masked_pairs(sq, sk, causal, window, k_off)
        (fb, fby), (bb, bby) = _ring_bounds(q, k, pairs)
        out["flash_fwd"][tag] = dict(ms=fwd_ms, plain_ms=plain_fwd,
                                     library_ms=sdpa_f, bound_ms=fb,
                                     bound_by=fby, max_abs_err=fwd_err)
        out["flash_bwd_fused"][tag] = dict(
            ms=bwd_ms, plain_ms=plain_bwd, library_ms=sdpa_fb - sdpa_f,
            bound_ms=bb, bound_by=bby, max_abs_err=bwd_abs, with_dlse=True)
        phase("sp_kernels", shape=f"{tag}_B{b}_H{h}_Hkv{hkv}_S{sq}_D{d}_bf16"
              f"_{'causal' if causal else 'full'}_window{window}_koff{k_off}",
              pairs=pairs, empty_rows=empty, k1_err=f"{fwd_err:.3g}",
              k1_tol=TOL[dtype],
              k2_dlse_rel_err=f"{bwd_rel:.3g}", k2_tol=GRAD_TOL[dtype],
              **{f"{n}_{key}": (f"{v:.5f}" if isinstance(v, float) else v)
                 for n in out for key, v in out[n][tag].items()
                 if key != "max_abs_err"})
        del cases, leaves
    if bad:
        raise RuntimeError(f"sp_kernels disagree with plain: {bad}")
    return out


def _launches():
    return {k: _kernels.launch_counts[k] for k in FLASH_COUNTERS}


def _tp_counts():
    """A copy of the collectives' counts (their lists go on counting)."""
    return {k: list(v) for k, v in collectives.TP_COUNTS.items()}


def _part_of(name: str) -> str:
    """A parameter's part for the per-part gates: its top module, a
    pipeline stage by its index."""
    part = name.split(".")[0]
    return "stage" + name.split(".")[1] if part == "stages" else part


def _step_record(strategy, tr, logs, ref, whole):
    """The gates' numbers of one sharded step against one process's:
    ``ref`` = (loss, grad_norm, state, param_bound_by_part) on the
    reference's holder (else None), ``whole`` the sharded run's whole
    state."""
    loss = float(collectives.pmean(logs["loss"], strategy.batch_group))
    gn = float(logs["grad_norm"])
    rec = dict(loss=loss, grad_norm=gn)
    if ref is not None:
        rloss, rgn, rstate, bounds = ref
        rec.update(ref_loss=rloss, ref_grad_norm=rgn,
                   loss_rel=abs(loss - rloss) / abs(rloss),
                   grad_norm_rel=abs(gn - rgn) / abs(rgn))
        by_part: dict = {}
        for name, t in whole.items():
            part = _part_of(name)
            diff = float((t.float() - rstate[name].float()).abs().max())
            by_part[part] = max(by_part.get(part, 0.0), diff)
        rec["param_diff_by_part"] = by_part
        rec["param_diff"] = max(by_part.values())
        rec["param_bound_by_part"] = bounds
    return rec


def _one_process_step(model, batch, keys, forward=None):
    """One SGD step of ``model`` alone (``forward`` replaces its forward,
    the GPipe models' ``apply_sequential``): (loss, grad_norm, state,
    the parameter gate by part). A part's gate is :data:`PARAM_STEP_REL`
    of its largest update (lr·max|g|, so a gradient counted twice moves
    the part by its whole update) plus two f32 ulps of its largest
    parameter (the rounding of ``p - lr·g`` on either side)."""
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    run = model
    if forward is not None:
        class _Run(torch.nn.Module):
            def __init__(self, inner):
                super().__init__()
                self.inner = inner

            def forward(self, x, *, train=True):
                return forward(x)

        run = _Run(model)
    tr = Trainer(run, optimizer="sgd", learning_rate=SP_LR, device=DEV,
                 log_grad_norm=True, **keys)
    logs = tr.train_step(batch)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step: dict = {}
    scale: dict = {}
    for name, t in state.items():
        part = _part_of(name)
        step[part] = max(step.get(part, 0.0), float(
            (t.float() - before[name].float()).abs().max()))
        scale[part] = max(scale.get(part, 0.0), float(t.abs().max()))
    bounds = {part: PARAM_STEP_REL * step[part]
              + 2 * float(np.spacing(np.float32(scale[part])))
              for part in step}
    out = (float(logs["loss"]), float(logs["grad_norm"]), state, bounds)
    del tr, run, before
    return out


def _sp_strategy():
    return MirroredStrategy(device=DEV, backend="gloo",
                            mesh_config=MeshConfig(data=1, seq=2))


def _sp_parity_legs(rank: int, out: dict) -> None:
    """Phase 38g's legs (f32, TF32 off): Llama-1B's width at depth 2,
    B 1 x S 2048, ring_flash and ring, with and without a window of 512;
    ViT-S/16 at depth 2 under ring_flash, against one-process references
    (attention "flash") that the two processes run first, split between
    them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = SyntheticLanguageModeling(batch_size=1, seq_len=SP_PARITY_SEQ,
                                     vocab_size=VOCAB, seed=5)
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in data.batch(0).items()}
    rng = np.random.default_rng(6)
    images = {"image": torch.from_numpy(rng.normal(size=(
        4, 224, 224, 3)).astype(np.float32)).to(DEV),
        "label": torch.from_numpy(rng.integers(0, 1000, 4)).to(DEV)}

    def llama(attention, window, mesh=None):
        return Llama_1B(vocab_size=VOCAB, depth=2, dtype=torch.float32,
                        sliding_window=window, attention=attention,
                        mesh=mesh, device=DEV, seed=11)

    def vit(attention, mesh=None):
        return ViT_S16(depth=2, attention=attention, mesh=mesh,
                       dtype=torch.float32, device=DEV, seed=12)

    legs = [("llama_ring_flash", "ring_flash", None),
            ("llama_ring", "ring", None),
            ("llama_ring_flash_w512", "ring_flash", SP_WINDOW),
            ("llama_ring_w512", "ring", SP_WINDOW),
            ("vit_s16_ring_flash", "ring_flash", None)]
    # The one-process references, split over the two processes (the
    # parameters are replicated: either process's hold a leg's result).
    mine = {0: (None, "vit"), 1: (SP_WINDOW,)}[rank]
    refs = {}
    for key in mine:
        refs[key] = (_one_process_step(vit("flash"), images, {})
                     if key == "vit" else
                     _one_process_step(llama("flash", key), batch, LM_KEYS))
        torch.cuda.empty_cache()
    strategy = _sp_strategy()
    for tag, attention, window in legs:
        is_vit = tag.startswith("vit")
        model = (vit(attention, strategy.mesh) if is_vit
                 else llama(attention, window, strategy.mesh))
        tr = Trainer(model, optimizer="sgd", learning_rate=SP_LR,
                     strategy=strategy, device=DEV, log_grad_norm=True,
                     **({} if is_vit else LM_KEYS))
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        collectives.reset_tp_counts()
        logs = tr.train_step(images if is_vit else batch)
        torch.cuda.synchronize()
        launches = _launches()
        counts = _tp_counts()
        ref = refs.get("vit" if is_vit else window)
        out[tag] = dict(_step_record(strategy, tr, logs, ref,
                                     tr.model.state_dict()),
                        launches=launches, collectives=counts)
        del tr, model
        torch.cuda.empty_cache()
    del refs
    torch.cuda.empty_cache()


def _sp_train_leg(rank: int, out: dict) -> None:
    """Phase 38h: full Llama-1B, bf16 compute over f32 parameters,
    ``remat="dots"``, ring_flash over seq 2, adamw at B 1 x S 8192 (4096
    tokens a process): the timed steps' wall, launches and hops."""
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = SP_TRAIN
    strategy = _sp_strategy()
    model = Llama_1B(vocab_size=VOCAB, remat="dots", dtype=torch.bfloat16,
                     param_dtype=torch.float32, attention="ring_flash",
                     mesh=strategy.mesh, device=DEV, seed=0)
    tr = Trainer(model, optimizer="adamw", learning_rate=1e-4,
                 strategy=strategy, device=DEV, **LM_KEYS)
    data = SyntheticLanguageModeling(batch_size=cfg["batch"],
                                     seq_len=cfg["seq"], vocab_size=VOCAB,
                                     seed=0)
    tr.fit(data, epochs=1, steps_per_epoch=cfg["warmup"], verbose=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    collectives.reset_tp_counts()
    t0 = time.perf_counter()
    hist = tr.fit(data.with_offset(cfg["warmup"]), epochs=cfg["steps"],
                  steps_per_epoch=1, verbose=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["sp_train"] = dict(
        wall_s=wall, step_s=wall / cfg["steps"],
        tokens_s=cfg["batch"] * cfg["seq"] * cfg["steps"] / wall,
        peak=torch.cuda.max_memory_allocated(), losses=hist.history["loss"],
        launches=_launches(), collectives=_tp_counts(),
        depth=model.depth)
    del tr, model
    torch.cuda.empty_cache()


def _pp_parity_legs(rank: int, out: dict) -> None:
    """Phase 38i (f32, TF32 off): GPipeLlama at Llama-1B's widths and
    GPipeViT at ViT-S/16's, 2 stages x 1 block, M 2, attention "flash",
    one SGD step under ``PipelineStrategy(2)`` against one process's
    ``apply_sequential`` from the same weights (rank 0)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = PP_PARITY
    data = SyntheticLanguageModeling(batch_size=cfg["batch"],
                                     seq_len=cfg["seq"], vocab_size=VOCAB,
                                     seed=7)
    tokens = {k: torch.from_numpy(v).to(DEV)
              for k, v in data.batch(0).items()}
    rng = np.random.default_rng(8)
    images = {"image": torch.from_numpy(rng.normal(size=(
        cfg["images"], 224, 224, 3)).astype(np.float32)).to(DEV),
        "label": torch.from_numpy(rng.integers(0, 1000, cfg["images"]))
        .to(DEV)}
    legs = (
        ("gpipe_llama", GPipeLlama, dict(vocab_size=VOCAB,
                                          **GPIPE_LLAMA_WIDTHS),
         tokens, LM_KEYS),
        ("gpipe_vit", GPipeViT, GPIPE_VIT_WIDTHS, images, {}))
    for tag, cls, kw, batch, keys in legs:
        strategy = PipelineStrategy(2, device=DEV, backend="gloo")
        kw = dict(kw, n_stages=2, blocks_per_stage=1,
                  n_microbatches=cfg["microbatches"], mesh=strategy.mesh,
                  attention="flash", dtype=torch.float32, device=DEV, seed=13)
        ref = None
        if rank == 0:
            whole = cls(**dict(kw, mesh=strategy.mesh.shape_only()))
            ref = _one_process_step(whole, batch, keys,
                                    forward=whole.apply_sequential)
            del whole
        whole_bytes = _param_bytes(cls(**dict(
            kw, mesh=strategy.mesh.shape_only(), device="meta")))
        held = _quiet_allocated()
        model = cls(**kw)
        built_bytes = torch.cuda.max_memory_allocated() - held
        tr = Trainer(model, optimizer="sgd", learning_rate=SP_LR,
                     strategy=strategy, device=DEV, log_grad_norm=True,
                     **keys)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        collectives.reset_tp_counts()
        logs = tr.train_step(batch)
        torch.cuda.synchronize()
        launches = _launches()
        counts = _tp_counts()
        whole_state = strategy.gather_state_dict(tr.model)
        out[tag] = dict(_step_record(strategy, tr, logs, ref, whole_state),
                        launches=launches, collectives=counts,
                        whole_bytes=whole_bytes, built_bytes=built_bytes,
                        local_bytes=_param_bytes(tr.model))
        del tr, model, whole_state, ref
        torch.cuda.empty_cache()


def _quiet_allocated() -> int:
    """The card's allocated bytes with the earlier legs' garbage freed
    and the peak reset to them: the peak above this after a build is
    the most the build held at once."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


@contextlib.contextmanager
def _blocked_in_schedule(acc: list):
    """Add to ``acc[0]`` the host seconds spent in the pipeline
    schedule's receives, its send waits and its outputs' broadcast
    (``ops/pipeline.py`` calls them through ``collectives``)."""
    names = ("recv_counted", "wait_sends", "broadcast_counted")
    saved = {n: getattr(collectives, n) for n in names}

    def timed(fn):
        def inner(*args, **kwargs):
            if fn is saved["broadcast_counted"] and args[-1] != \
                    "pp_outputs_fwd":
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[0] += time.perf_counter() - t0
        return inner

    for n in names:
        setattr(collectives, n, timed(saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(collectives, n, fn)


def _profiled_step(tr, data):
    """One training step under ``torch.profiler``: this process's kernel
    ms and copy ms on the device, and the step's wall (s)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.fit(data, epochs=1, steps_per_epoch=1, verbose=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = device_kernels(prof)
    copy_us = sum(e.self_device_time_total for e in kern
                  if e.key.startswith(("Memcpy", "Memset")))
    busy_us = sum(e.self_device_time_total for e in kern) - copy_us
    return busy_us / 1e3, copy_us / 1e3, wall


def _pp_train_legs(rank: int, out: dict) -> None:
    """Phase 38j: GPipeLlama at full Llama-1B (2 stages x 8 blocks), bf16
    compute over f32 parameters, attention "flash", adamw at B 4 x
    S 2048, at M 2 and M 4: each timed step's wall, the host seconds the
    stage waits in the schedule, launches, hops, bytes and peak memory."""
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = PP_TRAIN
    data = SyntheticLanguageModeling(batch_size=cfg["batch"],
                                     seq_len=cfg["seq"], vocab_size=VOCAB,
                                     seed=0)
    for m in (2, 4):
        strategy = PipelineStrategy(2, device=DEV, backend="gloo")
        kw = dict(vocab_size=VOCAB, n_stages=2,
                  blocks_per_stage=cfg["blocks"], n_microbatches=m,
                  mesh=strategy.mesh, **GPIPE_LLAMA_WIDTHS,
                  attention="flash", remat_stages=PP_REMAT,
                  dtype=torch.bfloat16, param_dtype=torch.float32,
                  device=DEV, seed=0)
        whole_bytes = _param_bytes(GPipeLlama(**dict(
            kw, mesh=strategy.mesh.shape_only(), device="meta")))
        held = _quiet_allocated()
        model = GPipeLlama(**kw)
        built_bytes = torch.cuda.max_memory_allocated() - held
        tr = Trainer(model, optimizer="adamw", learning_rate=1e-4,
                     strategy=strategy, device=DEV, **LM_KEYS)
        tr.fit(data, epochs=1, steps_per_epoch=cfg["warmup"], verbose=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        collectives.reset_tp_counts()
        blocked = [0.0]
        t0 = time.perf_counter()
        with _blocked_in_schedule(blocked):
            hist = tr.fit(data.with_offset(cfg["warmup"]),
                          epochs=cfg["steps"], steps_per_epoch=1, verbose=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches, counts = _launches(), _tp_counts()
        # One more step under the profiler: this process's kernel time.
        busy_ms, copy_ms, prof_wall = _profiled_step(
            tr, data.with_offset(cfg["warmup"] + cfg["steps"]))
        step_s = wall / cfg["steps"]
        out[f"pp_train_m{m}"] = dict(
            wall_s=wall, step_s=step_s,
            tokens_s=cfg["batch"] * cfg["seq"] * cfg["steps"] / wall,
            host_blocked_share=blocked[0] / wall, bubble=1 / (m + 1),
            kernel_ms=busy_ms, copy_ms=copy_ms, profiled_step_s=prof_wall,
            idle_share=(1 - busy_ms / 1e3 / step_s) if busy_ms else None,
            whole_bytes=whole_bytes, built_bytes=built_bytes,
            local_bytes=_param_bytes(tr.model), peak=peak,
            losses=hist.history["loss"], launches=launches,
            collectives=counts)
        del tr, model
        torch.cuda.empty_cache()


def sp_pp_gloo2_child(rank: int, port: int, out_dir: str) -> None:
    """``--sp-pp-gloo2-child RANK PORT DIR``: one of two processes sharing
    the card over gloo: the legs of phases 38g-38j in turn. Writes what
    it saw to ``out_dir/sp_pp_gloo2_{rank}.json``."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
        rank=rank)
    out = {"rank": rank}
    try:
        for name, fn in (("sp_parity", _sp_parity_legs),
                         ("sp_train", _sp_train_leg),
                         ("pp_parity", _pp_parity_legs),
                         ("pp_train", _pp_train_legs)):
            t0 = time.perf_counter()
            before = set(out)
            fn(rank, out)
            out[f"{name}_seconds"] = time.perf_counter() - t0
            print(json.dumps({k: out[k] for k in set(out) - before},
                             default=str), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    pathlib.Path(out_dir, f"sp_pp_gloo2_{rank}.json").write_text(
        json.dumps(out))


def _built_whole(tag: str, runs) -> list:
    """A stage's process must lay out its own stage, the embed and the
    head and no more: the most its construction held on the card at
    once within 1 MiB (the allocator's rounding) above its parameters'
    bytes, which are below the whole model's."""
    return [f"{tag}_built_bytes {r['built_bytes']} of {r['local_bytes']}"
            for r in runs
            if not r["local_bytes"] <= r["built_bytes"]
            <= r["local_bytes"] + (1 << 20)
            or not r["local_bytes"] < r["whole_bytes"]]


def _per_step(counts: dict, steps: int) -> str:
    return ",".join(f"{k}:{v[0] / steps:g}calls/{v[1] / steps / 1e6:.2f}MB"
                    for k, v in sorted(counts.items()))


def _sum_launches(runs, key="launches"):
    return {k: sum(r[key][k] for r in runs) for k in FLASH_COUNTERS}


def phase_sp_pp_gloo2(out_dir: str, timeout: float = 600.0):
    """Phases 38g-38j from ``sp_pp_gloo2_child``'s two processes: the
    parity gates (phase 38b's: loss within 1e-4 relative, gradient norm within
    1e-3; each part's parameters within 1e-3 of its update plus two f32
    ulps, ``_one_process_step``), the launch
    counts each leg must show, and the train legs' figures beside
    ``train_long``'s and ``train_step``'s. Returns the launches (both
    processes summed) by path."""
    out_dir = pathlib.Path(out_dir)
    _two_processes(lambda rank, port: ("--sp-pp-gloo2-child", str(rank),
                                       str(port), str(out_dir)),
                   timeout, "sp_pp_gloo2")
    seen = [json.loads((out_dir / f"sp_pp_gloo2_{r}.json").read_text())
            for r in range(2)]
    bad = []
    paths = {}

    def gate(phase_name, tag, depth, want_k1, want_k2, **extra):
        r0, r1 = seen[0][tag], seen[1][tag]
        ref = r0 if "ref_loss" in r0 else r1   # the reference's holder
        bounds = ref["param_bound_by_part"]
        fields = {k: f"{ref[k]:.3g}" for k in GLOO2_GATES}
        phase(phase_name, leg=tag, processes=2, backend="gloo",
              device="cuda:0 (shared)", optimizer="sgd", lr=SP_LR, steps=1,
              loss=f"{ref['loss']:.7f}", ref_loss=f"{ref['ref_loss']:.7f}",
              reference_rank=0 if ref is r0 else 1,
              **fields, param_diff=f"{ref['param_diff']:.3g}",
              param_diff_by_part=",".join(
                  f"{k}:{v:.3g}" for k, v in ref["param_diff_by_part"].items()),
              **{f"{k}_bound": f"{v:g}" for k, v in GLOO2_GATES.items()},
              param_diff_bound_by_part=",".join(
                  f"{k}:{v:.3g}" for k, v in bounds.items()),
              launches_per_rank="/".join(
                  f"k1:{r['launches']['flash_fwd']},k2:"
                  f"{r['launches']['flash_bwd_fused']}" for r in (r0, r1)),
              collectives_rank0=_per_step(r0["collectives"], 1),
              collectives_rank1=_per_step(r1["collectives"], 1), **extra)
        bad.extend(f"{tag}_{k}" for k, lim in GLOO2_GATES.items()
                   if not ref[k] <= lim)
        bad.extend(f"{tag}_param_diff_{k}"
                   for k, v in ref["param_diff_by_part"].items()
                   if not v <= bounds[k])
        got = [(r["launches"]["flash_fwd"], r["launches"]["flash_bwd_fused"])
               for r in (r0, r1)]
        if got != [(want_k1[0], want_k2[0]), (want_k1[1], want_k2[1])]:
            bad.append(f"{tag}_launches {got}")
        if want_k1[0] or want_k1[1]:
            paths[phase_name + "_" + tag] = _sum_launches((r0, r1))

    # Ring flash at seq 2 (causal): rank 0 runs the diagonal only (the
    # later shard has weight 0), rank 1 the diagonal and the past shard;
    # the plain ring launches nothing.
    for tag in ("llama_ring_flash", "llama_ring_flash_w512"):
        gate("sp_parity_gloo2", tag, 2, (2, 4), (2, 4),
             model="Llama_1B_depth2_f32", batch=1, seq=SP_PARITY_SEQ)
    for tag in ("llama_ring", "llama_ring_w512"):
        gate("sp_parity_gloo2", tag, 2, (0, 0), (0, 0),
             model="Llama_1B_depth2_f32", batch=1, seq=SP_PARITY_SEQ)
    # ViT: non-causal, both rotations on both ranks.
    gate("sp_parity_gloo2", "vit_s16_ring_flash", 2, (4, 4), (4, 4),
         model="ViT_S16_depth2_f32", batch=4, image=224)
    for tag in ("gpipe_llama", "gpipe_vit"):
        r0, r1 = seen[0][tag], seen[1][tag]
        m = PP_PARITY["microbatches"]
        gate("pp_parity_gloo2", tag, 1, (m, m), (m, m),
             model=("GPipeLlama_Llama1B_widths" if tag == "gpipe_llama"
                    else "GPipeViT_ViT_S16_widths") + "_2x1_f32",
             microbatches=m,
             param_bytes_per_rank=f"{r0['local_bytes']}/{r1['local_bytes']}",
             built_bytes_per_rank=f"{r0['built_bytes']}/{r1['built_bytes']}",
             whole_param_bytes=r0["whole_bytes"])
        bad.extend(_built_whole(tag, (r0, r1)))

    # 38h: the sequence-parallel train step beside train_long's.
    st = [s["sp_train"] for s in seen]
    steps, depth = SP_TRAIN["steps"], st[0]["depth"]
    long_fig = PHASE_FIGURES.get("train_long", {})
    phase("sp_train_gloo2", model="Llama_1B_remat_dots_bf16_compute_f32_params",
          attention="ring_flash", processes=2, seq_axis=2,
          batch=SP_TRAIN["batch"], seq=SP_TRAIN["seq"],
          tokens_per_process=SP_TRAIN["seq"] // 2, steps=steps,
          step_s=f"{st[0]['step_s']:.4f}", tokens_per_s=f"{st[0]['tokens_s']:.2f}",
          peak_mem_gib_per_rank="/".join(f"{s['peak'] / 2**30:.3f}"
                                         for s in st),
          train_long_ms_per_step=long_fig.get("ms_per_step", "not measured"),
          train_long_tokens_per_s=long_fig.get("tokens_per_s",
                                               "not measured"),
          train_long_peak_mem_gib=long_fig.get("peak_mem_gib",
                                               "not measured"),
          losses="/".join(f"{x:.5f}" for x in st[0]["losses"]),
          flash_per_step_per_rank="/".join(
              ",".join(f"{k}:{s['launches'][k] / steps:g}"
                       for k in FLASH_COUNTERS) for s in st),
          collectives_per_step_rank0=_per_step(st[0]["collectives"], steps),
          collectives_per_step_rank1=_per_step(st[1]["collectives"], steps))
    # K1 runs in the forward and again in the remat recompute: rank 0 the
    # diagonal only, rank 1 both rotations; K2 once a rotation.
    want = [(2 * depth * steps, depth * steps),
            (4 * depth * steps, 2 * depth * steps)]
    got = [(s["launches"]["flash_fwd"], s["launches"]["flash_bwd_fused"])
           for s in st]
    if got != want:
        bad.append(f"sp_train_launches {got} want {want}")
    if not all(np.isfinite(x) for s in st for x in s["losses"]):
        bad.append("sp_train_losses")
    paths["sp_train_gloo2"] = _sum_launches(st)

    # 38j: the pipeline train step at M 2 and M 4.
    for m in (2, 4):
        pt = [s[f"pp_train_m{m}"] for s in seen]
        steps = PP_TRAIN["steps"]
        step_fig = PHASE_FIGURES.get("train_step", {})
        phase("pp_train_gloo2", model="GPipeLlama_Llama1B_2x8_bf16_compute_"
              "f32_params", attention="flash", processes=2, stages=2,
              microbatches=m, remat_stages=PP_REMAT, batch=PP_TRAIN["batch"],
              seq=PP_TRAIN["seq"], steps=steps,
              step_s=f"{pt[0]['step_s']:.4f}",
              tokens_per_s=f"{pt[0]['tokens_s']:.2f}",
              train_step_ms_per_step=step_fig.get("ms_per_step",
                                                  "not measured"),
              train_step_tokens_per_s=step_fig.get("tokens_per_s",
                                                   "not measured"),
              whole_param_bytes=pt[0]["whole_bytes"],
              param_bytes_per_rank="/".join(str(p["local_bytes"])
                                           for p in pt),
              built_bytes_per_rank="/".join(str(p["built_bytes"])
                                           for p in pt),
              peak_mem_gib_per_rank="/".join(f"{p['peak'] / 2**30:.3f}"
                                             for p in pt),
              host_blocked_share_per_rank="/".join(
                  f"{p['host_blocked_share']:.4f}" for p in pt),
              kernel_ms_profiled_step_per_rank="/".join(
                  f"{p['kernel_ms']:.3f}" for p in pt),
              copy_ms_profiled_step_per_rank="/".join(
                  f"{p['copy_ms']:.3f}" for p in pt),
              profiled_step_s_per_rank="/".join(
                  f"{p['profiled_step_s']:.4f}" for p in pt),
              idle_share_per_rank="/".join(
                  "not measured" if p["idle_share"] is None else
                  f"{p['idle_share']:.4f}" for p in pt),
              bubble=f"{pt[0]['bubble']:.4f}",
              losses="/".join(f"{x:.5f}" for x in pt[0]["losses"]),
              flash_per_step_per_rank="/".join(
                  ",".join(f"{k}:{p['launches'][k] / steps:g}"
                           for k in FLASH_COUNTERS) for p in pt),
              collectives_per_step_rank0=_per_step(pt[0]["collectives"],
                                                   steps),
              collectives_per_step_rank1=_per_step(pt[1]["collectives"],
                                                   steps))
        per = PP_TRAIN["blocks"] * m * steps * (2 if PP_REMAT else 1)
        got = [(p["launches"]["flash_fwd"], p["launches"]["flash_bwd_fused"])
               for p in pt]
        if got != [(per, PP_TRAIN["blocks"] * m * steps)] * 2:
            bad.append(f"pp_train_m{m}_launches {got}")
        if not all(np.isfinite(x) for p in pt for x in p["losses"]):
            bad.append(f"pp_train_m{m}_losses")
        bad.extend(_built_whole(f"pp_train_m{m}", pt))
        paths[f"pp_train_gloo2_m{m}"] = _sum_launches(pt)
    phase("phase_seconds_sp_pp", **{
        k: f"{v:.2f}" for k, v in seen[0].items() if k.endswith("_seconds")})
    if bad:
        raise RuntimeError(f"sp_pp_gloo2 out of tolerance: {bad}")
    return paths

# -------------------------------------------------------- phases 38k-38l
# The fleet's replicas: the fleet worker's flat configuration at
# GPT-2-small's full width (its one model family), paged, f32, a 256 MiB
# host tier; the worker's engines keep the engine's blocks of 8 (no
# worker key sets them), and ``prefill_len`` 512 admits the wave's
# 384-token prompts.
FLEET_CFG = dict(vocab=GPT_VOCAB, max_len=1024, embed_dim=768, depth=12,
                 heads=12, param_seed=0, engine_seed=0, slots=8,
                 prefill_len=512, max_queue_depth=64, paged=True,
                 host_tier_bytes=256 << 20, device="cuda")
# Prefix affinity over the shadow radix (blocks of 8) with the
# interactive escape at 12 in flight: the wave's shared prefix would
# otherwise send all 24 requests to one replica.
FLEET_ROUTER = dict(affinity_block_size=8, affinity_blocks=1,
                    respawn=False, interactive_reroute_load=12)
FLEET_NEW = 32
FLEET_READY_S = 300.0
FLEET_DEADLINE_S = 300.0


def fleet_oracle():
    """One in-process engine of the fleet's configuration on the card,
    built as a worker builds its own: the streams every fleet leg is held
    to."""
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = build_engine(FLEET_CFG)
    eng.warmup()
    return eng


def oracle_streams(eng, prompts, new=FLEET_NEW):
    handles = [eng.submit([int(t) for t in p], new) for p in prompts]
    eng.run()
    return [list(h.tokens) for h in handles]


def fleet_submit(fleet, prompts, new=FLEET_NEW):
    return [fleet.submit([int(t) for t in p], new) for p in prompts]


def fleet_until(fleet, done, what, sleep_s=0.0):
    """Step ``fleet`` until ``done()``; raises at the deadline."""
    deadline = time.monotonic() + FLEET_DEADLINE_S
    while not done():
        if time.monotonic() > deadline:
            raise RuntimeError(f"{what}: the fleet did not get there in "
                               f"{FLEET_DEADLINE_S:.0f} s")
        fleet.step()
        if sleep_s:
            time.sleep(sleep_s)


def fleet_fields(handles, wall):
    """Tokens/s over the wall, TTFT p50/p99 on the router's clock."""
    tokens = sum(len(h.tokens) for h in handles)
    ttft = np.array([h.ttft_s for h in handles], dtype=np.float64)
    return dict(requests=len(handles), tokens=tokens, wall_s=f"{wall:.4f}",
                tokens_per_s=f"{tokens / wall:.2f}",
                ttft_p50_s=f"{np.percentile(ttft, 50):.5f}",
                ttft_p99_s=f"{np.percentile(ttft, 99):.5f}")


def check_fleet_streams(what, handles, want, prompts, oracle, n=FLEET_NEW):
    """Every handle FINISHED, its stream token-equal to the oracle's unless
    a tie (the oracle's top-2 margin below 1e-3 at the divergence)."""
    for i, h in enumerate(handles):
        if h.state.value != "finished":
            raise RuntimeError(f"{what} {i}: {h.state} {h.finish_reason}")
    return check_streams(what, [h.tokens for h in handles], want, prompts,
                         oracle.model, n)


def census_ones(what, counts):
    if not counts or set(counts.values()) != {1}:
        raise RuntimeError(f"{what}: compile_counts {counts}, want all 1")


def phase_fleet_local(oracle, prompts, want):
    """Phase 38k. Returns K4's launches: the wave's and the chain pull's."""
    reps = [LocalReplica(i, lambda: build_engine(FLEET_CFG))
            for i in range(2)]
    fleet = FleetRouter(reps, **FLEET_ROUTER)
    fleet.warmup()
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    handles = fleet_submit(fleet, prompts)
    fleet_until(fleet, lambda: not fleet.has_work, "fleet_local wave")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    engines = {s.replica_id: s.driver.engine for s in fleet.replicas}
    for eng in engines.values():
        if eng.telemetry.total_appended > eng.telemetry.capacity:
            raise RuntimeError("telemetry ring wrapped; ticks undercounted")
    ticks = {r: sum(1 for rec in e.telemetry.snapshot() if rec["live_slots"])
             for r, e in engines.items()}
    depth = FLEET_CFG["depth"]
    check_launches("fleet_local wave", launches,
                   paged_decode=depth * sum(ticks.values()))
    routed = {r: sum(h.replica_id == r for h in handles) for r in engines}
    if min(routed.values()) == 0:
        raise RuntimeError(f"fleet_local: one replica served nothing: "
                           f"{routed}")
    exact, ties = check_fleet_streams("fleet_local request", handles, want,
                                      prompts, oracle)
    census_ones("fleet_local", fleet.compile_counts())
    phase("fleet_local", card=SMI, model="GPT_Small_f32", replicas=2,
          in_process=True, **fleet_fields(handles, wall),
          routed="/".join(str(routed[r]) for r in sorted(routed)),
          ticks="/".join(str(ticks[r]) for r in sorted(ticks)),
          paged_decode_launches=launches["paged_decode"],
          token_exact=exact, ties=ties,
          migrations=fleet.metrics.requests_migrated)
    # One chain pull: a new prefix, cached where the router put it, is
    # exported there and imported into the other replica's host tier;
    # the next request for it there promotes it.
    rng = np.random.RandomState(11)
    shared = rng.randint(0, GPT_VOCAB, 256)
    first, second = (np.concatenate([shared, rng.randint(0, GPT_VOCAB, 128)])
                     for _ in range(2))
    (h1,) = fleet_submit(fleet, [first])
    fleet_until(fleet, lambda: h1.done, "fleet_local chain source")
    src = next(s for s in fleet.replicas if s.replica_id == h1.replica_id)
    dst = next(s for s in fleet.replicas if s is not src)
    t0 = time.perf_counter()
    entry = src.driver.export_chain([int(t) for t in second])
    t1 = time.perf_counter()
    stored = dst.driver.import_chain(entry)
    t2 = time.perf_counter()
    blocks = len(shared) // 8
    if entry is None or stored != blocks:
        raise RuntimeError(f"chain pull: {stored} blocks stored, want "
                           f"{blocks}")
    kv_bytes = sum(len(base64.b64decode(leaf["b64"]))
                   for block in entry["blocks"] for leaf in block.values())
    wire_bytes = len(json.dumps(entry))
    eng = dst.driver.engine
    promoted0 = eng.metrics.host_tier_promotions
    before = eng.telemetry.total_appended
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    h2 = eng.submit([int(t) for t in second], FLEET_NEW)
    eng.run()
    torch.cuda.synchronize()
    pull_launches = dict(_kernels.launch_counts)
    pull_ticks = sum(1 for rec in eng.telemetry.snapshot()[
        before - eng.telemetry.total_appended:] if rec["live_slots"])
    check_launches("fleet_local chain pull", pull_launches,
                   paged_decode=depth * pull_ticks)
    promoted = eng.metrics.host_tier_promotions - promoted0
    if promoted < blocks:
        raise RuntimeError(f"chain pull: {promoted} blocks promoted, want "
                           f">= {blocks}")
    exact2, ties2 = check_streams(
        "fleet_local chain pull", [h2.tokens],
        oracle_streams(oracle, [second]), [second], oracle.model, FLEET_NEW)
    phase("fleet_chain_pull", card=SMI, model="GPT_Small_f32",
          from_replica=src.replica_id, to_replica=dst.replica_id,
          blocks=stored, kv_bytes=kv_bytes, wire_bytes=wire_bytes,
          export_ms=f"{1e3 * (t1 - t0):.3f}",
          import_ms=f"{1e3 * (t2 - t1):.3f}",
          kv_gb_per_s=f"{kv_bytes / (t2 - t0) / 1e9:.4f}",
          promoted_blocks=promoted, ticks=pull_ticks,
          paged_decode_launches=pull_launches["paged_decode"],
          token_exact=exact2, ties=ties2)
    fleet.close()
    return launches["paged_decode"] + pull_launches["paged_decode"]


def spawn_workers(ids):
    """Port worker processes of the fleet's configuration on the card,
    started together; returns them ready, with the spawn-to-ready wall."""
    t0 = time.perf_counter()
    reps = [ProcessReplica(i, dict(FLEET_CFG, replica_id=i),
                           python=sys.executable, wait_ready=False,
                           ready_timeout_s=FLEET_READY_S) for i in ids]
    try:
        for rep in reps:
            rep.wait_ready()
    except BaseException:
        for rep in reps:
            rep.kill()
            rep.close()
        raise
    for rep in reps:
        census_ones(f"worker {rep.replica_id} ready",
                    rep.ready_compile_counts)
    return reps, time.perf_counter() - t0


def phase_fleet_process(oracle, prompts, want):
    """Phase 38l: two worker processes time-sharing the card."""
    workers = []
    try:
        # Six workers start together: the fleet's two, the SIGKILL leg's
        # replacement, and the campaign's first partner and two fresh
        # workers for its recovered router (started here, they are ready
        # when the crash comes: a warm pool, not a cold spawn).
        reps, spawn_s = spawn_workers((0, 1, 2, 3, 20, 21))
        workers += reps
        fleet = FleetRouter(reps[:2], **FLEET_ROUTER)
        t0 = time.perf_counter()
        handles = fleet_submit(fleet, prompts)
        fleet_until(fleet, lambda: not fleet.has_work, "fleet_process wave",
                    sleep_s=0.0005)
        wall = time.perf_counter() - t0
        exact, ties = check_fleet_streams("fleet_process request", handles,
                                          want, prompts, oracle)
        census_ones("fleet_process wave", fleet.compile_counts())
        phase("fleet_process", card=SMI, leg="wave", model="GPT_Small_f32",
              processes=2, sharing="one card", spawn_to_ready_s=(
                  f"{spawn_s:.3f}"), workers_started=len(reps),
              **fleet_fields(handles, wall), token_exact=exact, ties=ties)
        # SIGTERM one worker mid-wave: its snapshot restores on the other.
        part = prompts[:8]
        handles = fleet_submit(fleet, part)
        fleet_until(fleet, lambda: sum(len(h.tokens) for h in handles) >= 24,
                    "fleet_process drain leg", sleep_s=0.0005)
        victim = max(fleet.replicas, key=lambda s: s.load)
        moved = [h for h in handles
                 if h.replica_id == victim.replica_id and not h.done]
        t0 = time.perf_counter()
        migrated = fleet.scale_down(victim.replica_id)
        t1 = time.perf_counter()
        # The capture applied the victim's last events; the first token
        # after it comes from the survivor.
        resumed = [(h, len(h.tokens)) for h in moved if not h.done]
        fleet_until(fleet, lambda: not resumed or any(
            len(h.tokens) > n for h, n in resumed),
                    "fleet_process restore", sleep_s=0.0005)
        t2 = time.perf_counter()
        fleet_until(fleet, lambda: not fleet.has_work,
                    "fleet_process drain leg", sleep_s=0.0005)
        if not moved or migrated < len(moved) \
                or fleet.metrics.migrated_via_drain < 1:
            raise RuntimeError(f"drain leg: {migrated} migrated of "
                               f"{len(moved)} in flight")
        exact, ties = check_fleet_streams("fleet_process drained", handles,
                                          want[:8], part, oracle)
        phase("fleet_process", card=SMI, leg="sigterm_drain",
              victim=victim.replica_id, in_flight=len(moved),
              migrated=migrated, drain_ms=f"{1e3 * (t1 - t0):.3f}",
              restore_to_first_token_s=(f"{t2 - t1:.4f}" if resumed
                                        else "none left running"),
              via_drain=fleet.metrics.migrated_via_drain,
              token_exact=exact, ties=ties)
        # SIGKILL one worker mid-wave: its streams replay from the
        # router's mirrors on the survivor.
        fleet.scale_up(reps[2])
        part = prompts[8:16]
        handles = fleet_submit(fleet, part)
        fleet_until(fleet, lambda: sum(len(h.tokens) for h in handles) >= 24,
                    "fleet_process kill leg", sleep_s=0.0005)
        victim = max(fleet.replicas, key=lambda s: s.load)
        victim.driver.kill()
        fleet_until(fleet, lambda: not fleet.has_work,
                    "fleet_process kill leg", sleep_s=0.0005)
        replays = fleet.metrics.migrated_via_replay
        if fleet.metrics.replica_down_events < 1 or replays < 1:
            raise RuntimeError("kill leg: no replica death or no replay")
        exact, ties = check_fleet_streams("fleet_process killed", handles,
                                          want[8:16], part, oracle)
        survivor = next(s for s in fleet.replicas if s is not victim)
        census_ones("fleet_process survivor",
                    survivor.driver.compile_counts())
        phase("fleet_process", card=SMI, leg="sigkill_replay",
              victim=victim.replica_id, replays=replays,
              replica_down_events=fleet.metrics.replica_down_events,
              token_exact=exact, ties=ties)
        fleet_campaign(oracle, [survivor.driver, reps[3]], reps[4:6])
    finally:
        for rep in workers:
            rep.kill()
            rep.close()


def fleet_campaign(oracle, first, fresh):
    """One chaos campaign over two workers (``first``): a storage storm, a
    hard kill and a router crash recovered from the journal over two
    fresh, ready workers (``fresh``); the referee's invariants all hold,
    its streams exact."""
    pools = [list(first), list(fresh)]

    def make_replicas():
        if not pools:
            raise RuntimeError("fleet campaign: a second router crash")
        return pools.pop(0)

    def make_chaos(fleet):
        return [ReplicaChaos(replica_id=int(s.replica_id),
                             slow_fn=s.driver.set_tick_delay,
                             kill_fn=s.driver.kill)
                for s in fleet.replicas]

    rng = np.random.RandomState(13)
    workload = [(rng.randint(0, GPT_VOCAB, 64), 8) for _ in range(4)]
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        cond = ChaosConductor(
            make_replicas, make_chaos,
            lambda p, n: oracle_streams(oracle, [p], n)[0],
            journal_dir=os.path.join(tmp, "wal"),
            storage_plan=StorageFaultPlan(seed=0),
            router_kw=dict(FLEET_ROUTER),
            journal_kw=dict(fsync_batch_records=2, retry_limit=1,
                            retry_backoff_s=0.0, rearm_interval_s=0.0,
                            sleep_fn=lambda _: None),
            recovery_bound_s=FLEET_DEADLINE_S, seed=0)
        t0 = time.perf_counter()
        report = cond.run(workload, planes=("storage", "kill", "router"),
                          horizon=20, kills=1, pace_s=0.01,
                          max_wall_s=FLEET_DEADLINE_S)
        wall = time.perf_counter() - t0
    kinds = [a.kind for a in report.actions]
    if not report.ok or len(kinds) < 3 or "router_crash" not in kinds:
        raise RuntimeError(f"fleet campaign: actions {kinds}, violations "
                           f"{report.violations}")
    phase("fleet_process", card=SMI, leg="campaign", actions=",".join(kinds),
          invariants=",".join(f"{k}={v}" for k, v in
                              sorted(report.invariants.items())),
          recovery_s=f"{report.recovery_s:.3f}", steps=report.steps,
          storage_injected=report.injected.get("storage", 0),
          wall_s=f"{wall:.3f}")


def phase_fleet():
    """Phases 38k and 38l over one oracle and the serve wave's prompts.
    Returns K4's launches in the in-process fleet."""
    oracle = fleet_oracle()
    prompts = serve_prompts(GPT_VOCAB)
    t0 = time.perf_counter()
    want = oracle_streams(oracle, prompts)
    phase("fleet_oracle", card=SMI, model="GPT_Small_f32",
          requests=len(prompts), new=FLEET_NEW,
          wall_s=f"{time.perf_counter() - t0:.4f}")
    launches = phase_fleet_local(oracle, prompts, want)
    gc.collect()
    torch.cuda.empty_cache()
    phase_fleet_process(oracle, prompts, want)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dp-gloo2-child", nargs=3, metavar=("RANK", "PORT",
                                                           "DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--resilience-child", metavar="DIR",
                    help=argparse.SUPPRESS)
    ap.add_argument("--dp-ckpt-child", nargs=3,
                    metavar=("RANK", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-gloo2-child", nargs=3,
                    metavar=("RANK", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--sp-pp-gloo2-child", nargs=3,
                    metavar=("RANK", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile a window of decode ticks after "
                         "phases 7, 20 and 21 (the last two speculative: "
                         "row n-gram and paged draft model), one train "
                         "step after each of phases 10, 11 and 15 and one "
                         "B 1 generate in phase 17, and write their "
                         "kernel tables to DIR")
    args = ap.parse_args(argv)
    if args.dp_gloo2_child:
        rank, port, out_dir = args.dp_gloo2_child
        dp_gloo2_child(int(rank), int(port), out_dir)
        return 0
    if args.resilience_child:
        resilience_child(args.resilience_child)
        return 0
    if args.dp_ckpt_child:
        rank, port, out_dir = args.dp_ckpt_child
        dp_ckpt_child(int(rank), int(port), out_dir)
        return 0
    if args.tp_gloo2_child:
        rank, port, out_dir = args.tp_gloo2_child
        tp_gloo2_child(int(rank), int(port), out_dir)
        return 0
    if args.sp_pp_gloo2_child:
        rank, port, out_dir = args.sp_pp_gloo2_child
        sp_pp_gloo2_child(int(rank), int(port), out_dir)
        return 0
    global SMI
    smi = SMI = device_line()
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, host_threads=torch.get_num_threads(),
          host_cpus=os.cpu_count())
    phase("build", kernels=",".join(_kernels.SOURCES),
          seconds=f"{build_kernels():.2f}")
    timing = {"paged_decode": phase_paged_decode(), **phase_flash_fwd(),
              "flash_bwd_fused": phase_flash_bwd(),
              **phase_flash_bwd_two_sweep()}
    for name, shapes in time_flash_shapes().items():
        timing[name]["shapes"] = shapes
    # One process's attention under TP2 (H 16/4): K1 and K2 held against
    # their plain versions (FLASH_CASES' llama1b_tp2) and timed.
    phase("tp_kernels", shape="B1_H16_Hkv4_S2048_D64_bf16_causal", **{
        f"{n}_{k}": (f"{v:.5f}" if isinstance(v, float) else v)
        for n in ("flash_fwd", "flash_bwd_fused")
        for k, v in timing[n]["shapes"]["llama1b_tp2_local"].items()})
    phase_engine_parity()
    model, prompts = serve_model_and_prompts()
    serve_launches, paged_kv = phase_engine_serve(model, prompts)
    if args.profile:
        profile_decode(model, prompts, args.profile)
    phase_engine_row_serve(model, prompts, paged_kv)
    if args.profile:
        profile_decode(model, prompts, args.profile, paged=False)
    del model
    phase_train_parity()
    phase_train_converge()
    train_launches, tr, data = phase_train_step()
    if args.profile:
        profile_train(tr, data, args.profile)
    del tr, data
    long_launches, tr, data = phase_train_long()
    if args.profile:
        profile_train(tr, data, args.profile, tag="train_long")
    del tr, data
    phase_fused_loss()
    phase_resnet_parity()
    phase_resnet_converge()
    tr, batch_d, resident_images_s = phase_resnet_train()
    if args.profile:
        profile_resnet(tr, batch_d, args.profile)
    del tr, batch_d
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    notop = phase_keras_roundtrip()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        packed = os.path.join(tmp, "train.pdl")
        phase_native_loader(packed)
        phase_resnet_host_fed(packed, notop, resident_images_s)
    del notop
    phase("phase_seconds", name="keras_loader_host_fed",
          seconds=f"{time.perf_counter() - t0:.2f}")
    with nccl_group_of_one(), tempfile.TemporaryDirectory(dir=BUILD) as dp:
        for name, fn in (
                ("dp_parity", phase_dp_parity),
                ("dp_parity_gloo2", lambda: phase_dp_parity_gloo2(dp)),
                ("dp_ckpt_gloo2", lambda: phase_dp_ckpt_gloo2(dp)),
                ("dp_train", phase_dp_train)):
            t0 = time.perf_counter()
            fn()
            phase("phase_seconds", name=name,
                  seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    hf_launches = phase_hf_llama_roundtrip()
    phase_k1_op_cost()
    artifact_launches = phase_export_artifacts()
    phase("phase_seconds", name="checkpoint_formats",
          seconds=f"{time.perf_counter() - t0:.2f}")
    phase_generate_parity()
    model, *b1 = phase_generate_decode(args.profile)
    phase_generate_spec(model, *b1)
    del model
    swa_launches = phase_generate_swa()
    phase_engine_row_parity()
    model, prompts = serve_model_and_prompts(SERVE_DEPTH)
    spec_serve_launches = phase_engine_spec_serve(model, prompts)
    tenant_serve_launches = phase_engine_tenant_serve(
        model, prompts, args.profile or "build/profiles")
    t0 = time.perf_counter()
    fault_serve_launches, undrained = phase_engine_fault_serve(model,
                                                               prompts)
    phase("phase_seconds", name="engine_fault_serve",
          seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    tier_launches = phase_host_tier_serve(model)
    phase("phase_seconds", name="host_tier_serve",
          seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    preempt_launches = phase_engine_preempt_serve(model, prompts)
    phase("phase_seconds", name="engine_preempt_serve",
          seconds=f"{time.perf_counter() - t0:.2f}")
    if args.profile:
        profile_decode(model, prompts, args.profile, paged=False,
                       tag="profile_row_spec_decode", spec_k=SPEC_K)
        draft = self_draft(model, 2)
        profile_decode(model, prompts, args.profile,
                       tag="profile_draft_spec_decode", spec_k=SPEC_K,
                       spec_draft_model=draft)
        del draft
    pair = _parity_pair(max_len=MAX_LEN, depth=2)
    t0 = time.perf_counter()
    drain_launches = phase_engine_drain_restore(model, prompts, pair,
                                                undrained)
    phase("phase_seconds", name="engine_drain_restore",
          seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    trace_launches = phase_engine_trace_serve(model, prompts, pair)
    phase("phase_seconds", name="engine_trace_serve",
          seconds=f"{time.perf_counter() - t0:.2f}")
    del model
    t0 = time.perf_counter()
    slice_serve_launches = phase_engine_slice_serve()
    phase("phase_seconds", name="engine_slice_serve",
          seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    slice_parity_launches = phase_engine_slice_parity(pair)
    phase("phase_seconds", name="engine_slice_parity",
          seconds=f"{time.perf_counter() - t0:.2f}")
    del pair
    spec_parity_launches = phase_engine_spec_parity()
    tenant_parity_launches = phase_engine_tenant_parity()
    t0 = time.perf_counter()
    fault_parity_launches = phase_engine_fault_parity()
    phase("phase_seconds", name="engine_fault_parity",
          seconds=f"{time.perf_counter() - t0:.2f}")
    gpt_parity_launches = phase_gpt_parity()
    gpt_serve_launches = phase_gpt_serve()
    t0 = time.perf_counter()
    fleet_launches = phase_fleet()
    phase("phase_seconds", name="fleet",
          seconds=f"{time.perf_counter() - t0:.2f}")
    gpt_train_launches = phase_gpt_train()
    int8_serve_launches = phase_int8_serve()
    int8_parity_launches = phase_int8_parity()
    phase_vit_parity()
    vit_train_launches = phase_vit_train()
    t0 = time.perf_counter()
    phase_train_options_parity()
    phase("phase_seconds", name="train_options_parity",
          seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    options_launches = phase_train_options_step()
    phase("phase_seconds", name="train_options_step",
          seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    phase_train_resilience()
    phase("phase_seconds", name="train_resilience",
          seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD) as tp_dir:
        tp_launches = phase_tp_gloo2(tp_dir)
    phase("phase_seconds", name="tp_ep_gloo2",
          seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    moe_model = phase_moe_parity()
    phase_mixtral_roundtrip(moe_model)
    del moe_model
    moe_launches = phase_moe_train()
    phase("phase_seconds", name="moe",
          seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    for name, shapes in phase_sp_kernels().items():
        timing[name]["shapes"].update(shapes)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=BUILD) as sp_dir:
        sp_pp_launches = phase_sp_pp_gloo2(sp_dir)
    phase("phase_seconds", name="sp_pp",
          seconds=f"{time.perf_counter() - t0:.2f}")
    src = "pddl_tpu_torch/ops/csrc/"
    att = "pddl_tpu/ops/attention.py:"
    # Each kernel's launches by main path (the Llama, GPT and ViT train
    # steps, the serve waves: Llama's, GPT's and the int8 ones).
    k4_paths = {
        "engine_serve": serve_launches["paged_decode"],
        "engine_spec_serve_draft": spec_serve_launches["paged_decode"],
        "engine_tenant_serve": tenant_serve_launches["paged_decode"],
        "gpt_serve": gpt_serve_launches["paged_decode"],
        "fleet_local": fleet_launches,
        **{f"int8_serve_{name}": launches["paged_decode"]
           for name, launches in int8_serve_launches.items()},
        "engine_fault_serve": fault_serve_launches["paged_decode"],
        "host_tier_serve": tier_launches["paged_decode"],
        "engine_preempt_serve": preempt_launches["paged_decode"],
        "engine_slice_serve": slice_serve_launches["paged_decode"],
        "engine_drain_restore": drain_launches["paged_decode"],
        "engine_trace_serve": trace_launches["paged_decode"],
        "hf_llama_roundtrip": hf_launches["paged_decode"]}
    k1_paths = {"train_step": train_launches["flash_fwd"],
                "train_long": long_launches["flash_fwd"],
                "generate_swa": swa_launches["flash_fwd"],
                "export_artifacts_swa_prefill":
                    artifact_launches["flash_fwd"],
                "gpt_train": gpt_train_launches["flash_fwd"],
                "vit_train": vit_train_launches["flash_fwd"],
                "train_options_step": options_launches["flash_fwd"],
                "tp_parity_gloo2": tp_launches["tp"]["flash_fwd"],
                "ep_parity_gloo2": tp_launches["ep"]["flash_fwd"],
                "moe_train": moe_launches["flash_fwd"],
                **{p: n["flash_fwd"] for p, n in sp_pp_launches.items()}}
    k2_paths = {"train_step": train_launches["flash_bwd_fused"],
                "gpt_train": gpt_train_launches["flash_bwd_fused"],
                "vit_train": vit_train_launches["flash_bwd_fused"],
                "train_options_step": options_launches["flash_bwd_fused"],
                "tp_parity_gloo2": tp_launches["tp"]["flash_bwd_fused"],
                "ep_parity_gloo2": tp_launches["ep"]["flash_bwd_fused"],
                "moe_train": moe_launches["flash_bwd_fused"],
                **{p: n["flash_bwd_fused"]
                   for p, n in sp_pp_launches.items()}}
    # (name, source, TPU kernel's line, launches on the main paths: the
    # paged serve runs, the train steps (Llama, GPT, ViT) with the Llama
    # eval batch, the long-context run, or the sliding-window generate; K1
    # with the LSE runs on every training path and in the ring prefill).
    rows = [
        ("paged_decode", "paged_decode.cu", 1221, sum(k4_paths.values())),
        ("flash_fwd", "flash_fwd.cu", 183, sum(k1_paths.values())),
        ("flash_fwd_nolse", "flash_fwd.cu", 389,
         train_launches["flash_fwd_nolse"]),
        ("flash_bwd_fused", "flash_bwd.cu", 617, sum(k2_paths.values())),
        ("flash_bwd_dq", "flash_bwd.cu", 551, long_launches["flash_bwd_dq"]),
        ("flash_bwd_dkv", "flash_bwd.cu", 578,
         long_launches["flash_bwd_dkv"]),
    ]
    kernels = [{"name": name, "route": "cuda", "source": src + file,
                "replaces": f"{att}{line}", "launches": launches,
                **timing[name]} for name, file, line, launches in rows]
    # K4's launches by path: the paged ticks of the serve, tenant, GPT and
    # int8 serve runs and the draft model's steps in the speculative serve
    # run (the parity legs' too, outside the total).
    kernels[0]["launches_by_path"] = {
        **k4_paths,
        "engine_spec_parity_draft": spec_parity_launches["paged_decode"],
        "engine_tenant_parity": tenant_parity_launches["paged_decode"],
        "gpt_parity_paged": gpt_parity_launches["paged_decode"],
        "engine_fault_parity": fault_parity_launches["paged_decode"],
        "engine_slice_parity": slice_parity_launches["paged_decode"],
        **{f"int8_parity_{name}": launches["paged_decode"]
           for name, launches in int8_parity_launches.items()}}
    kernels[1]["launches_by_path"] = k1_paths
    kernels[3]["launches_by_path"] = k2_paths
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
