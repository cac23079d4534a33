#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

  python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

  1. env     — card name and power limit, torch/CUDA versions, the seven
               CUDA kernels built from ``src/repro_torch/kernels/csrc``
               (build seconds, ptxas register report).
  2. kernel  — the paged MoBA decode kernels (route, split-page
               attention, merge) against their plain PyTorch versions at
               moba-340m decode shapes (B=8, H=Hkv=16, d=64, page 128,
               top_k 8, a 320-page pool, shuffled block tables, ragged
               kv_len with 0, 1, an exact page boundary and a table
               shorter than top_k), a G=2, d=128 geometry, the same
               shapes at d 128 (``g1-d128``: qwen2-moe-a2.7b's G 1 at d
               128; its bf16 call timed as the main one), and page 16
               with top_k 64 and with top_k 128 over 512-page tables (G=2:
               the route's running top-k across four 128-page chunks; at
               top_k 128 its lists hold 256 slots a row in dynamic shared
               memory), and G=8 at d 128 with top_k 200 over 512-page
               tables (the route's static and dynamic shared memory
               together past 48 KB, each record giving both); q in bf16
               and fp32 (TF32 off), pools in q's dtype and int8 and fp8
               (the dequant path) filled from the same keys and values.
               Each check reads the route tables of the decode call it
               checks (``launch`` returns them), and the public wrapper's
               output must equal that call's bit for bit.  The route's
               selections against ``moba_paged_route``: equal except on
               near-ties (sorted selected scores within 1e-5·max(1, |s|)
               on ``paged_route_scores``), the count printed; its union
               tables equal ``decode_tables`` on its own selections.  The
               attention against the plain attention
               (``moba_paged_attend``) on those selections (bf16 3e-2,
               fp32 1e-3), inactive rows zero; quantized pools also
               against the unquantized plain attention on the same q and
               K/V (int8 5e-2, fp8 2e-1).  Times per pool dtype at the
               main shapes with bf16 q (``call_cost``: device ms from
               CUDA events, median of 25, a spin kernel then a 256 MB
               write before each, so the host is hidden and L2 is cold;
               µs a call in loops of 20; their larger as ``ms``): the
               decode call, the plain version and
               ``scaled_dot_product_attention`` over the gathered (and
               dequantized) pages as the library call; device ms of the
               three launches alone, also after a read flush (clean L2);
               the bytes bound from this run's inputs at 3.35 TB/s; and,
               with torch.profiler over one call, the port's kernel
               launches (exactly 3, device µs each) and any other
               operator that ran device work (none allowed); a trace
               with no device event at all is retaken, up to 3 times.
               Then the route kernel with per-head budgets (adaptive
               routing's ``head_top_k``, 1..top_k dealt unequally over a
               GQA group) from bf16 and int8 pools at moba-340m's shape
               (G 1, d 64), G 2 at d 128, G 8 at d 128 with top_k 200
               and G 8 over 100-page tables (npg < top_k) with a kv_len 0
               row: selections against ``moba_paged_route`` with the same
               budgets (near-ties only), tables equal to
               ``route_tables_plain``'s (or ``decode_tables``' on the
               kernel's own selections where a near-tie flipped one), no
               head past its budget, the attention against the plain
               attention on those selections (3e-2), and a union smaller
               than the static call's; and at the main shape the call with
               and without budgets (``call_cost``, the launches alone,
               the bytes bound from the union each read, mean
               ``n_uniq``).  Then ``zero_ties``: queries with every
               component negative against centroids whose every other
               row is zero (scores tie at exactly 0.0; the rest exact
               and far apart), through Flash TopK (block 128 / top_k 8,
               bf16 and fp32; block 16 / top_k 64, bf16) and the decode
               route at moba-340m's decode shape: selections equal the
               plain versions' exactly (``lax.top_k``'s order: the
               float's total order, then the lower index), and some rows
               are cut inside a tie.  Then signed zeros: fp32 Flash TopK
               and the decode route on rows whose every product
               underflows, which their fused multiply-add chains score
               -0.0: each must order them below the +0.0 rows as
               ``lax.top_k`` does, or, had no -0.0 arisen, as on +0.0
               (``ordered_as`` reports which).
  3. serve   — moba-340m at full width (bf16, random weights from a
               seeded torch.Generator) through ``Engine`` on the ``flash``
               backend: 8 prompts of 1024..4095 tokens, 64 new tokens
               each.  Every request must finish with 64 tokens, the decode
               call must have run exactly 12 times (one per MoBA layer) per
               decode step and launched exactly 3 kernels each time.  Then
               the same cell from int8 and from fp8 pools
               (``serve_quantized``, 32 new tokens):
               the same checks, decode tokens/s and step ms, and the
               pools' bytes against the bf16 run's.  Then
               ``serve_key_conv``: moba-340m-kconv3 (key convolution of
               width 3 on the MoBA layers) with the same prompts, 32 new
               tokens, ``prefill_chunk`` 1000 (chunk edges inside conv
               windows and off page edges), from bf16 and from int8
               pools: the same checks, and the per-slot ring
               ``key_conv_state`` bf16 of shape (12, 8, 16, 2, 64) in
               both.
  4. logits  — the same model in fp32 (TF32 off): one shared paged
               prefill, then one decode step under ``flash`` and one under
               ``xla`` from cloned caches; logits within 2e-3 and equal
               greedy tokens.  The flash run records the selections each
               decode call's route kernel made, in every MoBA layer; the
               xla run replays them, and each may differ from xla's own
               routing only on a near-tie (counted).  Repeated from int8
               and from fp8 pools.  Then ``key_conv_logits``: the kconv3
               model in fp32 after a prefill in chunks of 1000; every
               sequence's ring row must equal the last 2 of the raw keys
               its chunks computed (recomputed one-shot) bit for bit,
               pages and centroids a one-shot prefill's within 2e-4, and
               the decode step passes phase 4's check; then a swap
               check at 4 layers (full width, fp32): four prompts just
               under a page boundary in a pool one page larger than
               they take, so growth preempts by swap (at least one
               restore); every restored ring row equals its snapshot
               bit for bit, and each greedy stream equals an engine's
               with room for all up to its first step whose top-2
               logit gap (teacher-forced, ``reference``) is at most
               1e-3 (counted).  Then ``serve_qwen3``: qwen3-0.6b at
               full width and depth (28 MoBA layers, d 128, 16 heads on
               8 kv heads, tied 151,936-token embeddings, qk-norm),
               bf16, 4 of the prompts, 16 new tokens: every request
               finishes, 28 decode calls and 84 kernel launches a step,
               decode tokens/s, step ms, peak memory and a profiled
               window; then phase 4's check on this model in fp32.  Then
               ``serve_adaptive``: moba-340m (bf16) on ``flash`` with
               phase 3's prompts and 32 new tokens under static routing,
               (a) ``route_policy="snr:pfail=0.01"`` (calibrated at engine
               build: the profile's summary and the calibration's
               seconds) and (b) a non-uniform profile (every other head at
               budget 1, the rest cycling through 2..top_k) saved to a
               temporary file and loaded with ``profile:PATH``; (b) again
               on ``xla`` and from an int8 pool; then phase 4's fp32 check
               under (b).  Under (b): every request finishes, 12 decode
               calls and 36 kernels a step, the stream differs from
               static's, flash and xla streams part only where either
               run's top-2 bf16 logit gap is at most 0.0625, and a
               profiled step's launch calls equal static's; static and
               (b) each print the profiled step ms, device busy ms, idle
               share and mean ``n_uniq`` a (sequence, kv head).  Then
               ``serve_prefix``: the radix-tree prefix cache on
               ``flash``, moba-340m (bf16): 8 prompts sharing a
               2,048-token prefix, each with a distinct suffix of
               64..1,024 tokens, 32 new tokens, 2 admitted a step; then
               a 2,085-token shared prefix (a hit copies the partial
               page); that traffic from int8 pools (whole pages only);
               kconv3 on the first traffic; each against the same engine
               with the cache off.  Gates: the hit, hit-token and COW
               counts ``expected_prefix_stats`` implies, streams equal
               up to the first teacher-forced top-2 gap <= 1e-2, 12
               decode calls and 36 kernels a step, a profiled decode
               step's launch calls equal the no-cache engine's (bf16);
               kconv3: every hit row's ring, as its conv read it, equal
               bit for bit to the raw keys the tree's page holder
               computed before the match; a second turn (turn 1's
               prompt, its output and 64 tokens) hits turn 1's cache and
               holds against a fresh engine: its stream, and the logits
               of the 65 positions it prefills on top of the hit (the
               COW-copied page's keys feed every one) within 5e-2
               relative.  Then the serve CLI's other modes, each through
               its entry point in ``launch/serve.py`` on moba-340m at
               full width (bf16, seed-0 weights), ``flash``:
               ``serve_fixed`` (the dense-cache fixed loop, batch 8, a
               2,048-token prompt, 64 new tokens; each step call timed
               between syncs with the kernels it launched: 12 each of
               centroids, Flash TopK and ``moba_fwd`` in the prefill,
               none in a decode step; its streams beside ``serve()``'s
               paged engine on the same prompts, the partings and their
               top-2 gaps reported; then in fp32, batch 2, 8 new tokens,
               flash against xla: prefill and decode logits within 2e-3,
               greedy tokens equal, xla replaying flash's prefill and
               decode selections by the near-tie rule, and the paged
               engine's streams equal the fixed loop's up to a top-2
               gap <= 1e-3);
               ``serve_stream`` (16 requests, Poisson arrivals at 4
               req/s, prompts 1,024..4,095 tokens, 16..64 new tokens, 8
               slots, realtime: every metric it returns; every request
               finishes, 12 decode calls and 36 kernels a step, streams
               equal a ``dispatch_ahead=0`` batch run's up to the
               near-tie rule); ``serve_openloop`` (the same ranges, one
               arrival every 4 decode steps, ``dispatch_ahead`` 1 then
               0: sustained tokens/s, TTFT and TPOT p50/p99, the
               pipeline depth peak; the two runs' streams equal up to the
               near-tie rule, the same launch gates); ``serve_http`` (the
               CLI with ``--http`` in a subprocess; 3 concurrent clients
               POST 1,024..2,048-token prompts for 32 tokens each, one
               GETs ``/stats``: each stream equals its final record,
               ``ttft_ms`` present, decode steps counted, exit code 0 on
               SIGINT).  Then ``serve_sharded``: the sharded engine on
               ``flash`` with 2 shards sharing cuda:0 (the logic and
               launch counts of 2 shards; no transfer between cards, no
               speed-up from more cards).  In fp32, 4 prompts of
               1,024..2,047 tokens, 16 new, on 2 shards x 2 slots: the
               streams equal the single-device engine's (4 slots); a
               6,144-token prompt that no shard's 4,096-token sequences
               can page goes through the context-parallel fallback (its
               MoBA K/V and centroids one segment a shard, the ``sp``
               backend): its stream equals the dense fixed loop's on
               ``reference``, and each of its decode steps moves between
               shards exactly ``moba_sp.cp_decode_bytes`` plus the
               appended token (printed beside ``moba_sp.py``'s
               (nb + tp·k·(d+2))-floats formula and the dense K/V it
               does not move), partings allowed only at a teacher-forced
               top-2 gap <= 1e-3; shard 1's first decode call, recorded,
               passes phase 2's checks on its own tensors.  In bf16,
               phase 3's 8 prompts with 32 new tokens on 2 shards x 4
               slots and on the single-device engine with 8 slots:
               decode tokens/s, step ms, prefill s, 12 decode calls and
               36 kernels a shard step (24 a fleet step), a profiled
               window (launch calls a step, idle share), peak memory,
               ``shard_stats``, shard 1's first decode call checked
               again; the pair once more in the other order, timed only
               (the spread of the step-time ratio); the bf16 streams
               equal a witness's, the single-device engine at 4 slots (a
               shard's rows), up to a top-2 gap <= 1e-2; their partings
               from the 8-slot engine's are reported (not gated: 4-row
               and 8-row GEMMs round differently in bf16) beside the
               witness's own.
               Then the MoE, SSM and hybrid families:
               ``serve_moe`` (qwen2-moe-a2.7b at full width and depth,
               53.33 GiB of fp32 weights, bf16 compute, through
               ``Engine`` on ``flash`` from bf16 pools: phase 3's
               prompts, 32 new tokens, 2 prompts a prefill; every
               request finishes, 24 decode calls and 72 kernels a step,
               decode and prefill tokens/s, peak memory, a profiled
               window, the (token, slot) pairs its prefills dropped past
               the expert capacity; then in fp32 at 2 rows of 1,500 and
               700 tokens, flash against xla decode logits within 2e-3
               and greedy tokens equal on the rows whose expert choices
               agree, xla replaying flash's block selections, each
               differing expert choice counted and required to start at
               a router top-k gap <= 1e-5); ``serve_ssm`` (mamba2-780m
               and zamba2-1.2b at full width and depth through
               ``serve()``'s fallback to the fixed loop, 8 × 2,048
               tokens, 32 new: prefill s, decode step ms, tokens/s, peak
               memory, no MoBA kernel launched; in fp32 at 2 × 512, 8
               new, the recurrent decode's logits against one
               ``lm_apply`` over prompt and tokens within 2e-3, greedy
               tokens equal).  Then the encoder-decoder and vision
               families through ``serve()``'s fallback to the fixed loop
               on ``flash``, bf16 on fp32 seed-0 weights, the stub
               inputs drawn by the entry point after its prompts:
               ``serve_encdec`` (seamless-m4t-medium at full width and
               depth, 12 + 12 layers, 0.978 B params; 8 × 2,048 decoder
               tokens, 1,024 frames, 32 new) and ``serve_vlm``
               (llama-3.2-vision-90b at full width, cut to 10 of 100
               layers: 8 MoBA and 2 cross, 10.66 B params; 4 × 2,048
               tokens, 1,601 image tokens, 16 new).  Each: prefill s,
               decode step ms, tokens/s, peak memory; exact launches of
               centroids, Flash TopK and ``moba_fwd`` in the prefill (one
               each per MoBA layer of encoder and decoder) and in every
               decode step (one each per encoder layer: the stub encoder
               reruns in each, as in the reference; no decode kernel);
               a profiled decode step (idle share; the encoder profiled
               alone, and its share of the step's device time); the
               served streams teacher-forced through the fixed loop
               against ``lm_apply`` (the ``serve_fixed`` gate); in fp32
               at 2 × 2,048, 8 new (llama-vision 5 layers deep), flash
               against xla (xla replaying flash's selections, the
               encoder's too) and the cached decode against one
               ``lm_apply`` onto the same memory, logits within 2e-3 and
               greedy tokens equal.
  5. train_kernels — the four FlashMoBA training kernels (centroids, Flash
               TopK, forward, backward) against their plain PyTorch
               versions at the moba-340m training shapes (B=1, H=Hkv=16,
               N=Nq=8192, d=64, block 128, top_k 8, q tile 128) in bf16
               and fp32, plus G=2/d=128, G=1/d=128 (``g1-d128``,
               qwen2-moe-a2.7b's MoBA at N 4096, its bf16 kernels timed
               as the main ones), G=8/d=128 (``g8-d128``: 64 query heads
               on 8 KV heads, llama-3.2-vision's MoBA, at N 4096, bf16,
               timed likewise), a ragged N=8000, a query suffix
               Nq=1000, the paper's small blocks (``small-blocks``: block
               32, top_k 32, bf16 and fp32) and original MoBA's blocks
               (``block-512``: block 512, top_k 2, bf16: the forward's
               K/V ring and four backward key splits; ``block-512-d128``:
               the same at G=2, d 128, N 4096), Flash TopK's register
               bucket 16 (``top_k-16``: block 64, bf16) and its
               shared-memory lists (``top_k-64``: block 16, N 4096, bf16
               and fp32), and Flash TopK alone at its limit
               (``top_k-1024``: one head, N 32768, block 16, bf16).  The
               forward and backward run on a layout
               built from the plain routing; Flash TopK may differ from
               the plain routing only on near-ties (sorted selected scores
               within 1e-5·max(1, |s|)).  Tolerances: centroids bf16 1e-2,
               fp32 1e-5; forward (o, m, l) bf16 3e-2, fp32 2e-4; backward
               max |Δ| over the leaf's max |g|, bf16 3e-2, fp32 5e-3.
               The backward takes dO in q's dtype and must give
               bit-equal dQ/dK/dV on a second call with the same inputs.
               ``flash_moba`` forward and grads against the ``xla`` path
               (fp32 2e-4 / 5e-3; rows whose routing flipped on a near-tie
               are left out and counted).  First, a tensor-core audit of
               the Flash TopK, forward and backward libraries: per kernel
               function the registers and stack bytes (``cuobjdump
               -res-usage``) and the count of ``HMMA``/``HGMMA``
               instructions in its SASS; a bf16 instantiation with none,
               or a FlashMoBA one with a stack frame (a spill) at d 64,
               fails.  Per kernel at the main
               bf16 shapes: ``call_cost`` (as in phase 2) of the wrapper,
               the plain version and the library call where one computes
               the same thing (centroids: a mean), and the device ms of
               the launch alone; bytes, FLOPs and the bound from this
               run's tensors; centroids also after a read flush (clean
               L2) and, with the mean, under each placement of the spin
               kernel (``by_hold``); causal SDPA at the same shape as a
               yardstick (not the same function) for the forward and
               backward; the backward launch with runs cut into segments
               of 4, 8 and 16 tiles.  Flash TopK is timed at the main and
               the small-block shapes (``call_cost``, alone, plain, the
               bytes/FLOPs bound) beside a yardstick that is not the same
               function (its tie order differs): ``torch.topk`` over the
               masked ``torch.bmm`` scores; its launch alone and bound
               also at ``top_k-16``, ``top_k-64`` and ``top_k-1024``.
  6. train   — moba-340m at full width and depth (bf16, random weights
               from a seeded torch.Generator), batch 1, seq 8192, 4
               ``make_train_step`` steps on ``flash`` with remat; losses
               finite, each training kernel launched exactly as often as
               the path implies (per step: centroids, topk and forward 24
               — 12 MoBA layers, forward plus recompute — backward 12;
               the SWA layers' ``swa`` forward 24 and ``swa_bwd`` 12).
               Step time, tokens/s, peak memory, then one step under
               torch.profiler.  Then the same 4 steps on ``xla`` from the
               same weights and batches: each step's loss within 2e-2 of
               flash's (the kernels round P, dS and dO to bf16; xla
               multiplies in fp32, and its SWA layers run dense fp32
               scores).  Then ``train_small_blocks``: the
               same model at block 32, top_k 32, 3 steps on ``flash``
               (counts zeroed just before, read just after): finite
               losses, exact launch counts, step ms, peak memory.  Then
               ``train_key_conv``: moba-340m-kconv3, 3 steps on
               ``flash`` as phase 6's (counts zeroed just before, read
               just after): finite losses, phase 6's launch counts,
               every MoBA layer's ``key_conv`` gradient finite and
               nonzero in every step, the conv weights moved; step ms,
               tokens/s and peak memory beside phase 6's; then the same
               steps on ``xla``, each loss within 2e-2 of flash's.  Then
               ``train_accum``: one step at batch 2 x 8192 with 2
               microbatches, then with ``accum_in_loss``, then at once,
               from the same weights and batch, in bf16 (step ms, peak
               memory) and in fp32: losses within 2e-4 relative of the
               one-shot step's, in fp32 every gradient leaf within 5e-3
               of its max, exact launch counts.  Then ``train_resume``:
               4 steps through ``launch/train.py::train`` uninterrupted,
               then 2 that save and stop and ``resume="auto"`` for the
               rest (a temporary directory, 1 checkpoint kept): losses
               and params within rtol 1e-5 (bit-equality reported); the
               snapshot, the write, the bytes and the restore timed.
               Then multi-device training, each group's shards sharing
               cuda:0 (the logic, bytes and memory of the shards; no
               transfer between cards).  ``train_sp``: the ``sp`` backend
               under a 2-shard ``CPGroup``, 3 steps from phase 6's
               weights and batches with remat: losses within 2e-2 of
               phase 6's ``xla`` losses, each step's bytes between
               shards by kind (forward and ``_grad``) equal to
               ``moba_sp.sp_attention_bytes`` over the MoBA layers; the
               params and moments saved after step 2 and restored: step
               3 on the same group bit-equal, on a 4-shard group through
               ``restore(devices=...)`` within 2e-2 (its bytes the
               4-shard formula); step ms and peak memory, peaks at 4
               layers with remat on and off, one layer's attention
               forward and backward with and without the per-shard
               recompute (peak, ms), and the fp32 loss and gradients at
               full width and 4 layers against ``xla`` (2e-4 / 5e-3 of
               each leaf's max).  ``train_dp_compressed``: 2 shards each
               take the ``flash`` gradient of one 8,192-token row, two
               rounds through ``optim/compression.py::compressed_psum``
               with carried residuals: both shards' means bit-equal,
               every element within one scale of the fp64 mean, the
               error-feedback identity within 1e-5 of 127·s, exact
               launches of the four training kernels and the two SWA
               kernels (4 gradients), the
               bytes by kind against an fp32 star reduce's.
               ``pipeline``: the 12 (swa, moba) groups over 2 stages
               (``distributed/pipeline.py::pipeline_forward``, 6 groups a
               stage through ``apply_block`` on ``flash``), 4
               microbatches of 1 × 4,096 bf16 hidden states: bit-equal
               to the stages applied microbatch by microbatch, within
               3e-2 of the whole batch, 5 ticks and 8 stage calls, exact
               forward launches (48 each, ``swa``'s too), the
               activations' bytes.
               ``examples``, right after phase 6: each script of
               ``examples_torch/`` as a user runs it on the card, all
               four in subprocesses started together (``python3
               examples_torch/<name>.py``, each with its own timeout):
               ``quickstart.py``; ``train_lm.py --full --steps 30`` into
               a temporary checkpoint directory (moba-340m at full width
               and depth, ``sparse``); ``serve_decode.py --attn-backend
               flash --full`` (qwen3-0.6b at full width: the decode
               kernel takes head dims 64 and 128 only); and
               ``longcontext_niah.py``.  Gates: quickstart's reference
               vs sparse and reference vs kernel errors <= 2e-4 (fp32);
               train_lm's final loss below its first; serve_decode's
               token array (4, 16); the NIAH table's 4 rows of 3
               accuracies in [0, 1]; every exit code 0.  Meanwhile in
               this process, counts zeroed just before and read just
               after: quickstart's ``run`` on the card (one centroids,
               Flash TopK and ``moba_fwd`` launch, no SWA kernel, errors
               <= 2e-4) and
               serve_decode's ``main`` with the same arguments (decode
               calls a multiple of qwen3-0.6b's 28 MoBA layers, three
               kernels each).  Then ``models/api.py``'s
               ``param_count`` and ``active_param_count`` of every
               config, and phase 6's ``model_flops`` per token (6·N, N
               the active parameters less the untied embedding) with
               the share of ``BF16_FLOPS`` it implies at phase 6's
               median step, beside the card's name and power limit.
  7. train_grads — the same weights in fp32 (TF32 off), batch 1, seq
               2048: ``lm_loss`` and every gradient leaf under ``flash``
               against ``xla`` (loss 2e-4 relative, each leaf max |Δ| /
               max |g| <= 5e-3), the xla run replaying the flash run's
               block selections; each layer's selections must differ
               from the plain routing only on near-ties.  Run at block
               128, top_k 8, again at block 32, top_k 32, and on the
               kconv3 model (the ``key_conv`` leaves among the checked).
               Then ``train_moe``: qwen2-moe-a2.7b at full width and 2 of
               its 24 layers (1.76 B params), batch 1 × 4,096, 3 steps on
               ``flash`` with remat and on ``xla`` (losses within 2e-2;
               per step 4 centroids, Flash TopK and ``moba_fwd``, 2
               ``moba_bwd``), step ms, peak memory; then this phase's
               fp32 check on that model.  Then ``train_encdec``:
               seamless-m4t-medium at full width and depth, batch 2 ×
               4,096 decoder tokens plus 1,024 frames, 3 steps on
               ``flash`` with remat and on ``xla`` (losses within 2e-2;
               per step 36 centroids, Flash TopK and ``moba_fwd`` — the
               decoder's 12 forward and recomputed, the encoder's 12,
               which is not rematted — and 24 ``moba_bwd``), step ms,
               peak memory; then this phase's fp32 check on that model
               (the encoder's leaves among the checked).
               llama-3.2-vision-90b is not trained on the card: 5 layers
               at full width already need about 102 GB with AdamW.
  8. swa     — a tensor-core audit of the ``swa`` and ``swa_bwd``
               libraries first (as in phase 5: every bf16 instantiation
               has ``HMMA`` in its SASS, none has a stack frame at d 64;
               d 128's registers and stack reported).
               ``swa_attention``'s CUDA kernel against its plain version
               in bf16 (the tensor-core body, 3e-2) and fp32 (the SIMT
               body, 2e-4) at moba-340m's SWA shapes (N
               8192, window 256, 16 heads, d 64) and the same at d 128,
               GQA geometries (H 16 on Hkv 8 and, ``gqa-g8``, 2 x 32
               heads on 4, both d 128), window 100 with q_tile 128 /
               k_tile 64, a window >= N, window 1 and N 96 (a ragged
               tile).  At the moba-340m shapes, d 64 and d 128, bf16 and
               fp32: the launch alone, ``call_cost`` of the wrapper, the
               plain version and causal SDPA with a band mask as the
               library call, the bound from these tensors (bf16 tensor-core or
               fp32 peak); in bf16 also ``flex_attention`` with a
               sliding-window ``BlockMask``, compiled once, as a second
               yardstick (its error instead if it cannot be built).  Then
               training's kernels in bf16 (``SWAAttention``): at 2 x 16
               heads of 64 over N 8192, window 256 (a moba-340m
               microbatch's SWA layer), d 128 at G 2 and G 8, window 100
               over a ragged N 1000, a window >= N, N 96 and window 1:
               the forward's o bit-equal with and without its
               log-sum-exp, the log-sum-exp within 2e-3 of
               ``swa_lse_plain``, and the backward's dq, dk and dv
               against autograd of the plain version (max |Δ| over the
               leaf's max |g|, 3e-2), bit-equal on a rerun.  At the first
               two: the backward's two passes alone, the forward with its
               log-sum-exp alone, the plain backward, the bound (q, k, v,
               o and dO read, dq, dk and dv written; 10·d flops a query
               head and key) and, without GQA, causal SDPA's backward
               (dense) as a yardstick.  Then ``banded_attention``, the
               model's entry to them, on 4-D tensors laid out as the
               model's ((B, H, N, d) views of (B, N, H, d)) at 2 x 16
               heads of 64 and at d 128 / G 2, N 8192, window 256: one
               launch of each kernel, o within 3e-2 of
               ``dense_attention``'s and the gradients within 3e-2 of
               each leaf's max |g| of autograd of ``dense_attention``.
               Phase 6 counts the kernels' launches on the training
               path.
  9. dryrun  — the dry run (``repro_torch.launch.dryrun``) held to the
               card.  Its CLI costs moba-340m × train_4k and qwen3-0.6b
               × decode_32k on the 16 × 16 layout in two subprocesses
               (meta tensors, no card) and their tables are printed;
               meanwhile ``cost_cell`` costs phase 6's step (moba-340m,
               1 × 8,192, remat, AdamW) on the ``xla`` backend on a 1 × 1
               layout.  Then that step runs on the card under
               ``FlopCounterMode`` after ``reset_peak_memory_stats()``:
               the FLOPs must equal the prediction exactly (the same
               aten ops) and the predicted peak (state + traced
               activations) must lie within 15% of
               ``max_memory_allocated()`` less what was allocated before
               the step's inputs were built.  Two more steps are timed
               (inputs built, card synchronised, then the step) against
               the 1 × 1 roofline bound.

Then each phase's wall seconds and the script's total, the card's name
and power limit, the kernel line (the seven kernels,
the decode kernels once per pool dtype; Flash TopK also with its
small-block times and its times alone at top_k 16, 64 and 1024;
``swa_attention`` also at d 128 and in fp32, ``swa_attention_bwd`` also
at d 128 / G 2; ``launches_also``: each
kernel's launches on the other paths, ``serve_key_conv``,
``serve_qwen3``, ``serve_adaptive`` (its (b) run), ``serve_prefix``
(each case with the cache on), ``serve_stream``, ``serve_openloop``
(each ``dispatch_ahead``), ``serve_sharded`` (its bf16 run) and
``serve_moe`` and ``examples_serve_decode`` for the decode kernels,
whose bf16 entry also holds ``with_budgets`` and its times at
``g1-d128``; ``serve_fixed``'s prefill, ``train_small_blocks``,
``train_key_conv``, ``train_accum``'s two accumulating bf16 steps,
``train_dp_compressed``, ``pipeline``, ``train_moe``, ``serve_encdec``,
``serve_vlm``, ``train_encdec`` and ``examples_quickstart`` for the
training kernels, each with its times at ``g1-d128`` and
``g8-d128``), and as the last line
``{"ok": true, "device": {...}}``.

  python3 chip_smoke.py --ab DIR

runs none of the phases.  It times the checkout at DIR (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists) and this one, each tree in a process of its own,
in the order DIR, this, this, DIR: the decode call on the phase-2 case
at moba-340m's shapes (bf16 q and pool, built by that tree's own
prefill append; ``call_cost`` of the call and of the library call, and
the CUDA-event reading without the spin kernel); the Flash TopK launch
(through its wrapper, whose only device work it is), ``moba_fwd.launch``
and ``moba_bwd.launch`` alone on the phase-5 moba-340m bf16 case (dO in
the dtype that tree's backward wrapper takes, read from its
``check_contract``), and the Flash TopK launch again at block 32 /
top_k 32, at phase 5's ``top_k-64`` shape (its shared-memory lists) and
in fp32; ``swa_attention`` through
its public wrapper at moba-340m's SWA shape (bf16 and fp32 at d 64, bf16
at d 128); and the phase-6 median training step (steps 2–4).
The last line holds each tree's medians and the ratio DIR / this.

Without a usable card, or run from a directory that lacks the
repository's ``src/repro_torch``, it exits non-zero before printing any
result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12                # H100 SXM, dense bf16 tensor cores
CSRC = "src/repro_torch/kernels/csrc"
KERNEL_SOURCE = f"{CSRC}/moba_decode.cu"
TPU_KERNEL = "src/repro/kernels/moba_decode.py:347"
# training kernels: line name -> (port module, source, TPU kernel replaced)
TRAIN_KERNELS = {
    "block_centroids": ("centroids", f"{CSRC}/centroids.cu",
                        "src/repro/kernels/centroids.py:33"),
    "flash_topk": ("flash_topk", f"{CSRC}/flash_topk.cu",
                   "src/repro/kernels/flash_topk.py:247"),
    "moba_fwd": ("moba_fwd", f"{CSRC}/moba_fwd.cu",
                 "src/repro/kernels/moba_fwd.py:139"),
    "moba_bwd": ("moba_bwd", f"{CSRC}/moba_bwd.cu",
                 "src/repro/kernels/moba_bwd.py:167"),
}
SWA_KERNEL = ("swa_attention", f"{CSRC}/swa.cu", "src/repro/kernels/swa.py:77")
SWA_BWD_KERNEL = ("swa_attention_bwd", f"{CSRC}/swa_bwd.cu")
# the layers of the port's profiler ranges (``repro_torch/tracing.py``)
PORT_RANGES = ("train.", "model.", "kernel.", "engine.")
MOBA_LAYERS = 12                   # moba-340m: 24 layers, swa/moba
SWA_LAYERS = 12
# the banded backward in bf16: max |kernel - plain| over max |plain| of
# each gradient, as moba_bwd's (P and dS go to bf16 for the products and
# the gradients are bf16); the log-sum-exp, absolute (natural log; fp32
# sums in another order, ex2.approx)
SWA_BWD_TOL = 3e-2
SWA_LSE_TOL = 2e-3
TRAIN_SEQ = 8192                   # the paper's training context
TRAIN_STEPS = 4
# flash vs xla loss of each training step in bf16: the kernels round P,
# dS and dO to bf16 where the xla path multiplies in fp32 (it rounds only
# P before P V), and AdamW carries the difference into the later steps
TRAIN_LOSS_TOL = 2e-2
KV_DTYPES = ("fp32", "int8", "fp8")
# quantized decode vs the unquantized plain version on the same K/V
# (tests/test_quantized_pages.py:41)
QUANT_TOL = {"int8": 5e-2, "fp8": 2e-1}
QUANT_NEW_TOKENS = 32
HOLD_CYCLES = 1_000_000            # ~0.5 ms of card time before a timed run


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_events_ms(fn, reps: int = 25, flush=None, clean: bool = False,
                   hold: str = "first") -> float:
    """Median device time of ``fn`` from CUDA events; ``flush`` (a large
    tensor) is overwritten before each run so L2 starts cold, as it does
    for one layer's decode inside a full model step.  The overwrite
    leaves L2 full of dirty lines that ``fn``'s reads must write back;
    ``clean`` reads the tensor instead, so L2 holds clean lines.
    ``hold`` places a spin kernel (``HOLD_CYCLES``): "first" runs it
    before the flush, so the host has enqueued the flush and ``fn`` by
    the time the flush ends and the span is ``fn``'s device time;
    "after_flush" runs it between the flush and ``fn``; "none" runs no
    spin, so the span also holds whatever part of ``fn``'s host time
    outlasts the flush."""
    import torch
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        if hold == "first":
            torch.cuda._sleep(HOLD_CYCLES)
        if flush is not None and clean:
            flush.sum()
        elif flush is not None:
            flush.zero_()
        if hold == "after_flush":
            torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def loop_us(fn, calls: int = 20, reps: int = 5) -> float:
    """µs a call in a loop: the median over ``reps`` loops of ``calls``
    back-to-back calls and one synchronize.  That is the host's time per
    call where the host is slower than the card, else the card's (with a
    warm L2)."""
    import torch
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    return float(np.median(per_call))


def call_cost(fn, flush, prefix: str = "") -> dict:
    """A call's cost on one yardstick: its device time with L2 flushed
    (``device_ms``), its µs a call in a back-to-back loop
    (``loop_us``), and ``ms``, the larger of the two: a call can go no
    faster than either the card or the host that issues it."""
    dev = cuda_events_ms(fn, flush=flush)
    loop = loop_us(fn)
    return {f"{prefix}ms": max(dev, loop / 1e3), f"{prefix}device_ms": dev,
            f"{prefix}loop_us": loop}


# ------------------------------------------------------------------ phase 1
def phase_env():
    import torch
    from repro_torch.kernels import runtime
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    reports = runtime.build(runtime.KERNELS)
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in rep.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, rep in reports.items()}
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "nvcc": runtime.nvcc_path(), "build_s": round(build_s, 3),
          "ptxas": ptxas})
    return smi


# ------------------------------------------------------------------ phase 2
def _paged_case(*, b, h, hkv, d, ps, npg, num_pages, kv_lens, dtype, seed,
                kv_dtype="fp32"):
    """A pool filled through the port's own prefill append (so centroids
    and, for int8/fp8 pools, payloads and scales are the engine's),
    shuffled physical pages, ragged lengths.  Pages no sequence owns keep
    finite garbage (and stale scales 3.0), as in a recycled pool.  One
    seed gives the same keys, values and queries for every ``kv_dtype``."""
    import torch
    from repro_torch.core import quantization as Q
    from repro_torch.serving import paged_cache as PC
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    junk = [torch.randn((num_pages, ps, hkv, d), generator=gen, device=dev)
            for _ in range(2)]
    if kv_dtype == "fp32":
        pool = {"pages_k": junk[0].to(dtype), "pages_v": junk[1].to(dtype)}
    else:
        pool = {"pages_k": Q.quantize(junk[0], 0.05, kv_dtype),
                "pages_v": Q.quantize(junk[1], 0.05, kv_dtype),
                "scales_k": torch.full((num_pages, hkv), 3.0, device=dev),
                "scales_v": torch.full((num_pages, hkv), 3.0, device=dev)}
    pool["centroids"] = torch.zeros((num_pages, hkv, d), device=dev)
    perm = torch.randperm(num_pages, generator=gen, device=dev).tolist()
    table = np.full((b, npg), -1, np.int32)
    for i, n in enumerate(kv_lens):
        for j in range(-(-n // ps)):
            table[i, j] = perm.pop()
    table = torch.as_tensor(table, device=dev)
    kv = torch.as_tensor(kv_lens, dtype=torch.int32, device=dev)
    k_new = torch.randn((b, hkv, npg * ps, d), generator=gen, device=dev)
    v_new = torch.randn((b, hkv, npg * ps, d), generator=gen, device=dev)
    PC.paged_append_prefill(pool, table, kv, k_new.to(dtype),
                            v_new.to(dtype))
    q = torch.randn((b, h, 1, d), generator=gen, device=dev).to(dtype)
    return q, pool, table, kv


def _scales(pool) -> dict:
    return {k: pool[k] for k in ("scales_k", "scales_v") if k in pool}


def _decode_bytes_and_flops(q, pool, table, kv, idx, sel_valid, tables):
    """Bytes the decode function must move for these inputs (each read
    once, the output written once: the K/V rows of the valid tokens of
    each row's union pages and, for a quantized pool, their two scales,
    the centroid rows of the assigned table entries, q, the output, the
    tables) and its operations."""
    phys, base, n_uniq = tables
    b, h, _, d = q.shape
    _, ps, hkv, _ = pool["pages_k"].shape
    npg = table.shape[1]
    esz = pool["pages_k"].element_size()
    kvl = kv.long().repeat_interleave(hkv)[:, None, None]    # (B*Hkv,1,1)
    uslot = (np.arange(phys.shape[1])[None, :]
             < n_uniq.cpu().numpy()[:, None])                # (B*Hkv,U)
    page_base = base.min(dim=1).values.long()                # (B*Hkv,U)
    valid_tok = (kvl[:, 0] - page_base).clamp(0, ps).cpu().numpy()
    kv_tokens = float((valid_tok * uslot).sum())
    head_tokens = float(((kvl - base.long()).clamp(0, ps)).sum())
    nbytes = (2 * kv_tokens * d * esz                        # K and V rows
              + (2 * 4 * float(uslot.sum()) if "scales_k" in pool else 0)
              + int((table >= 0).sum()) * hkv * d * 4        # centroid rows
              + table.numel() * 4 + kv.numel() * 4
              + 2 * q.numel() * q.element_size())            # q in, o out
    flops = (2 * b * h * npg * d                             # routing
             + 4 * head_tokens * d)                          # QK and PV
    return nbytes, flops


def _route_near_ties(q, centroids, table, kv, ps, sel, idx, sel_valid):
    """The route kernel's selections ``sel`` (B·Hkv, G, k; -1 invalid)
    against the plain route ``idx``/``sel_valid`` on the plain route's own
    masked scores: (rows differing, the largest gap, all differences
    near-ties)."""
    import torch
    from repro_torch.core import moba as CM
    npg, k = table.shape[1], sel.shape[-1]
    masked = CM.paged_route_scores(q, centroids, table, kv,
                                   ps).reshape(-1, npg)
    masked = torch.cat([masked, torch.full_like(masked[:, :1],
                                                CM.NEG_INF)], -1)
    got = torch.where(sel >= 0, sel.long(), npg).reshape(-1, k)
    want = torch.where(sel_valid, idx, npg).reshape(-1, k)
    return _near_ties(masked, got, want)


def _kernel_selection(rt, q, centroids):
    """The route kernel's selections as ``moba_paged_route`` returns its
    own: (idx, sel_valid), (B, Hkv, G, 1, k), invalid slots 0."""
    b, h = q.shape[:2]
    hkv = centroids.shape[1]
    sel = rt.sel.long().view(b, hkv, h // hkv, 1, -1)
    return sel.clamp(min=0), sel >= 0


def _decode_launch(q, pool, table, kv, cfg, head_top_k=None):
    """One decode call through the wrapper's own checks and launch:
    the output and the route tables that call attended with."""
    from repro_torch.kernels import moba_decode as MD
    sc = _scales(pool)
    MD.check_contract(q, pool["pages_k"], pool["pages_v"], **sc,
                      centroids=pool["centroids"], block_table=table,
                      kv_len=kv, top_k=cfg.top_k, head_top_k=head_top_k)
    return MD.launch(q, pool["pages_k"], pool["pages_v"], pool["centroids"],
                     table, kv, cfg.top_k, q.shape[-1] ** -0.5,
                     sc.get("scales_k"), sc.get("scales_v"), head_top_k)


def budget_table(hkv: int, g: int, top_k: int):
    """Per-head budgets for the kernel checks: 1 to top_k spread evenly
    over the H = hkv·G heads, dealt so that the heads of a GQA group get
    unequal budgets; (Hkv, G) int32 on the card."""
    import torch
    vals = np.linspace(1, top_k, hkv * g).round().astype(np.int32)
    return torch.as_tensor(vals.reshape(g, hkv).T.copy(), device="cuda")


def _mean_n_uniq(n_uniq, kv_len) -> float:
    """Mean union size over the (sequence, kv head) rows of sequences
    with ``kv_len`` > 0 (a kv_len 0 row still routes to its page 0)."""
    live = n_uniq[kv_len.repeat_interleave(n_uniq.numel() // kv_len.numel())
                  > 0]
    return float(live.float().mean()) if live.numel() else 0.0


def _check_budgets(name, geom, cfg, kv_dtype):
    """The route kernel with per-head budgets (bf16 q, a bf16 or int8
    pool): its selections against the plain route truncated to the same
    budgets (``moba_paged_route``; near-ties only), its tables equal to
    ``route_tables_plain``'s where the selections are equal (else to
    ``decode_tables`` on its own selections), no head past its budget,
    the attention against the plain attention on those selections, the
    public wrapper's output equal to the launch's, and no row's union
    larger than the static call's on the same inputs (``union_shrank``:
    smaller somewhere; a union that takes every page may not shrink)."""
    import torch
    from repro_torch.core.moba import moba_paged_attend, moba_paged_route
    from repro_torch.kernels import moba_decode as MD
    q, pool, table, kv = _paged_case(dtype=torch.bfloat16, seed=7,
                                     kv_dtype=kv_dtype, **geom)
    sc = _scales(pool)
    cents, ps = pool["centroids"], pool["pages_k"].shape[1]
    htk = budget_table(geom["hkv"], geom["h"] // geom["hkv"], cfg.top_k)
    out, rt = _decode_launch(q, pool, table, kv, cfg, htk)
    _, rt0 = _decode_launch(q, pool, table, kv, cfg)
    call_equal = bool(torch.equal(out, MD.moba_paged_decode(
        q, pool["pages_k"], pool["pages_v"], cents, table, kv, cfg, **sc,
        head_top_k=htk)))
    plain = MD.route_tables_plain(q, cents, table, kv, cfg.top_k, ps,
                                  head_top_k=htk)
    idx, sel_valid = moba_paged_route(q, cents, table, kv, cfg,
                                      page_size=ps, head_top_k=htk)
    rows, gap, ties_ok = _route_near_ties(q, cents, table, kv, ps, rt.sel,
                                          idx, sel_valid)
    k_idx, k_valid = _kernel_selection(rt, q, cents)
    sel_equal = bool(torch.equal(rt.sel, plain.sel))
    want = ((plain.phys, plain.base, plain.n_uniq) if sel_equal else
            MD.decode_tables(q, pool["pages_k"], table, k_idx, k_valid))
    tables_equal = all(bool(torch.equal(a, b)) for a, b in
                       zip((rt.phys, rt.base, rt.n_uniq), want))
    b = q.shape[0]
    within = bool(((rt.sel >= 0).sum(-1)
                   <= htk.repeat(b, 1)).all())               # (B·Hkv, G)
    ref = moba_paged_attend(q, pool["pages_k"], pool["pages_v"], table, kv,
                            k_idx, k_valid, **sc)
    torch.cuda.synchronize()
    act = kv > 0
    err = float((out[act].float() - ref[act].float()).abs().max())
    close = bool(torch.allclose(out[act].float(), ref[act].float(),
                                atol=3e-2, rtol=3e-2))
    zeros = bool((out[~act] == 0).all())
    not_grown = bool((rt.n_uniq <= rt0.n_uniq).all())
    ok = (ties_ok and tables_equal and call_equal and within and close
          and zeros and not_grown)
    return {"geometry": name, "kv_dtype": kv_dtype, "dtype": "bf16",
            "top_k": cfg.top_k, "npg": geom["npg"],
            "budgets": sorted(set(htk.flatten().tolist())),
            "route_rows_differing": rows, "route_max_gap": gap,
            "route_near_ties_ok": ties_ok,
            "selections_equal_plain": sel_equal,
            "tables_equal": tables_equal, "within_budgets": within,
            "call_equals_launch": call_equal, "max_abs_err": err,
            "tol": 3e-2, "inactive_rows_zero": zeros,
            "mean_n_uniq": _mean_n_uniq(rt.n_uniq, kv),
            "mean_n_uniq_static": _mean_n_uniq(rt0.n_uniq, kv),
            "union_not_grown": not_grown,
            "union_shrank": int(rt.n_uniq.sum()) < int(rt0.n_uniq.sum()),
            "ok": ok}


def _time_budgets(geom, cfg, flush) -> dict:
    """The decode call with and without per-head budgets on the phase-2
    moba-340m case (bf16 q and pool), each as a call's cost, the
    launches alone, and the bytes bound from the union that call
    read."""
    import torch
    from repro_torch.kernels import moba_decode as MD
    q, pool, table, kv = _paged_case(dtype=torch.bfloat16, seed=7, **geom)
    htk = budget_table(geom["hkv"], geom["h"] // geom["hkv"], cfg.top_k)
    args = (q, pool["pages_k"], pool["pages_v"], pool["centroids"], table,
            kv)
    res = {}
    for label, h in (("static", None), ("budgets", htk)):
        _, rt = MD.launch(*args, cfg.top_k, q.shape[-1] ** -0.5,
                          head_top_k=h)
        nbytes, flops = _decode_bytes_and_flops(
            q, pool, table, kv, None, None, (rt.phys, rt.base, rt.n_uniq))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOPS * 1e3
        res[label] = {
            **call_cost(lambda h=h: MD.moba_paged_decode(*args, cfg,
                                                         head_top_k=h),
                        flush),
            "kernel_only_ms": cuda_events_ms(
                lambda h=h: MD.launch(*args, cfg.top_k,
                                      q.shape[-1] ** -0.5, head_top_k=h),
                flush=flush),
            "mean_n_uniq": _mean_n_uniq(rt.n_uniq, kv),
            "union_pages": int(rt.n_uniq.sum()), "bytes": nbytes,
            "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    return res


def phase_kernel():
    """Unquantized pools first, then int8 and fp8 pools from the same
    keys and values.  The route kernel against the plain route (near-ties
    only); its tables against ``decode_tables`` on its own selections;
    the decode call against the plain attention on those selections, on
    its own pool and, quantized, against the unquantized pool of that q
    dtype.  Geometries: moba-340m's decode shapes; G=2 at d 128; and the
    small-block regime (page 16, top_k 64 = n/(8·bs) at an 8K context,
    ``benchmarks/fig3_efficiency.py``), whose 512-page tables take the
    route kernel's running top-k across four 128-page chunks, and the
    same tables at top_k 128 (G 2: 256 list slots a row, past the route's
    old 64-slot cap); G 8 at d 128 with top_k 200, where the route's
    static and dynamic shared memory together pass 48 KB."""
    import torch
    from repro_torch.configs.base import MoBAConfig
    from repro_torch.core.moba import moba_paged_attend, moba_paged_route
    from repro_torch.kernels import moba_decode as MD

    main_cfg = MoBAConfig(block_size=128, top_k=8)
    main = dict(b=8, h=16, hkv=16, d=64, ps=128, npg=33, num_pages=320,
                kv_lens=[0, 1, 128, 100, 1500, 3000, 4224, 2777])
    g2 = dict(b=4, h=16, hkv=8, d=128, ps=128, npg=12, num_pages=64,
              kv_lens=[0, 700, 1536, 129])
    g1 = dict(main, d=128)          # qwen2-moe-a2.7b: H = Hkv 16, d 128
    k64 = dict(b=4, h=16, hkv=8, d=64, ps=16, npg=512, num_pages=1100,
               kv_lens=[8192, 6000, 2049, 0])
    # G 8 at d 128, top_k 200: the route's lists (44,800 bytes) fit the
    # 48 KB a block gets unasked, its static arrays on top do not
    g8 = dict(b=2, h=16, hkv=2, d=128, ps=16, npg=512, num_pages=900,
              kv_lens=[8192, 5001])
    geoms = (("moba-340m", main, main_cfg), ("g2-d128", g2, main_cfg),
             ("g1-d128", g1, main_cfg),
             ("page16-k64", k64, MoBAConfig(block_size=16, top_k=64)),
             ("page16-k128", k64, MoBAConfig(block_size=16, top_k=128)),
             ("g8-k200-d128", g8, MoBAConfig(block_size=16, top_k=200)))
    tols = {torch.bfloat16: 3e-2, torch.float32: 1e-3}
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    checks, timing = [], {}
    for name, geom, cfg in geoms:
        unquantized = {}
        for kv_dtype in KV_DTYPES:
            for dtype in (torch.bfloat16, torch.float32):
                q, pool, table, kv = _paged_case(dtype=dtype, seed=7,
                                                 kv_dtype=kv_dtype, **geom)
                sc = _scales(pool)
                ps = pool["pages_k"].shape[1]
                args = (q, pool["pages_k"], pool["pages_v"],
                        pool["centroids"], table, kv, cfg)
                out, rt = _decode_launch(q, pool, table, kv, cfg)
                call_equal = bool(torch.equal(
                    out, MD.moba_paged_decode(*args, **sc)))
                idx, sel_valid = moba_paged_route(q, pool["centroids"],
                                                  table, kv, cfg,
                                                  page_size=ps)
                rows, gap, ties_ok = _route_near_ties(
                    q, pool["centroids"], table, kv, ps, rt.sel, idx,
                    sel_valid)
                k_idx, k_valid = _kernel_selection(rt, q, pool["centroids"])
                want = MD.decode_tables(q, pool["pages_k"], table, k_idx,
                                        k_valid)
                tables_equal = all(bool(torch.equal(a, b)) for a, b in
                                   zip((rt.phys, rt.base, rt.n_uniq), want))
                ref = moba_paged_attend(q, pool["pages_k"], pool["pages_v"],
                                        table, kv, k_idx, k_valid, **sc)
                torch.cuda.synchronize()
                act = kv > 0
                err = float((out[act].float() - ref[act].float()).abs().max())
                tol = tols[dtype]
                ok = bool(torch.allclose(out[act].float(), ref[act].float(),
                                         atol=tol, rtol=tol))
                zeros = bool((out[~act] == 0).all())
                rec = {"geometry": name, "kv_dtype": kv_dtype,
                       "dtype": str(dtype), "top_k": cfg.top_k,
                       "route_smem_bytes": MD.route_smem_bytes(
                           geom["h"] // geom["hkv"], cfg.top_k,
                           geom["npg"], geom["d"]),
                       "max_abs_err": err, "tol": tol,
                       "route_rows_differing": rows,
                       "route_rows": int(rt.sel.shape[0] * rt.sel.shape[1]),
                       "route_max_gap": gap, "route_near_ties_ok": ties_ok,
                       "tables_equal": tables_equal,
                       "call_equals_launch": call_equal,
                       "inactive_rows_zero": zeros}
                ok = ok and ties_ok and tables_equal and call_equal
                if kv_dtype == "fp32":
                    unquantized[dtype] = (k_idx, k_valid, pool)
                else:
                    u_idx, u_valid, u_pool = unquantized[dtype]
                    plain_u = moba_paged_attend(
                        q, u_pool["pages_k"], u_pool["pages_v"], table, kv,
                        u_idx, u_valid)
                    qerr = float((out[act].float() - plain_u[act].float())
                                 .abs().max())
                    rec.update(vs_unquantized_err=qerr,
                               vs_unquantized_tol=QUANT_TOL[kv_dtype])
                    ok = ok and qerr <= QUANT_TOL[kv_dtype]
                rec["ok"] = ok
                checks.append(rec)
                if not (ok and zeros):
                    emit({"phase": "kernel", "checks": checks})
                    raise SystemExit(f"decode kernels disagree with their "
                                     f"plain versions: {checks[-1]}")
                if name == "moba-340m" and dtype == torch.bfloat16:
                    timing[kv_dtype] = _time_decode(q, pool, table, kv, cfg,
                                                    args, err, flush)
                if (name == "g1-d128" and dtype == torch.bfloat16
                        and kv_dtype == "fp32"):
                    timing[name] = _time_decode(q, pool, table, kv, cfg,
                                                args, err, flush)
    # per-head budgets (adaptive routing): G 1 at d 64 (moba-340m), G 2
    # at d 128 (qwen3-0.6b), G 8 at d 128 with budgets 1..200, and G 8
    # over tables shorter than top_k (npg 100 < 200) with a kv_len 0 row
    g8_short = dict(b=3, h=16, hkv=2, d=128, ps=16, npg=100,
                    num_pages=250, kv_lens=[1600, 0, 700])
    budget_checks = []
    for name, geom, cfg in (
            ("moba-340m", main, main_cfg), ("g2-d128", g2, main_cfg),
            ("g8-k200-d128", g8, MoBAConfig(block_size=16, top_k=200)),
            ("g8-short-table", g8_short,
             MoBAConfig(block_size=16, top_k=200))):
        for kv_dtype in ("fp32", "int8"):
            budget_checks.append(_check_budgets(name, geom, cfg, kv_dtype))
            if not budget_checks[-1]["ok"]:
                emit({"phase": "kernel", "budget_checks": budget_checks})
                raise SystemExit(f"the route kernel with per-head budgets "
                                 f"disagrees with its plain version: "
                                 f"{budget_checks[-1]}")
    if not all(c["union_shrank"] for c in budget_checks
               if c["geometry"] == "moba-340m"):
        raise SystemExit("per-head budgets did not shrink the union at "
                         "moba-340m's decode shape")
    timing["budgets"] = _time_budgets(main, main_cfg, flush)
    emit({"phase": "kernel", "checks": checks,
          "budget_checks": budget_checks, "timing": timing})
    bad = {k: t["profile"] for k, t in timing.items()
           if k in KV_DTYPES and (t["profile"]["port_kernels"] != 3
                                  or t["profile"]["other_device_ops"])}
    if bad:
        raise SystemExit(f"a decode call did not run exactly the 3 port "
                         f"kernels and no other device work: {bad}")
    return timing


def _device_rows(avgs) -> list:
    """The device rows of a profile's ``key_averages()``: its kernels and
    copies, without the port's own ranges (``repro_torch/tracing.py``),
    which the profiler lays on the device timeline too, as annotations
    over the kernels they hold."""
    import torch
    return [a for a in avgs
            if a.device_type == torch.autograd.DeviceType.CUDA
            and not a.key.startswith(PORT_RANGES)]


def _profile_call(fn, attempts: int = 3) -> dict:
    """The device work of one call of ``fn`` under torch.profiler: the
    port's decode kernels (count and device µs each) and every other
    device operator.  A trace that holds no device event at all missed
    its capture (the call always launches kernels) and is taken again,
    up to ``attempts`` times; ``captures`` says how many it took."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for capture in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = _device_rows(prof.key_averages())
        if dev:
            break
    port = [e for e in dev if "moba_decode_" in e.key]
    return {"port_kernels": sum(e.count for e in port),
            "port_kernel_us": {e.key.split("<")[0]: e.self_device_time_total
                               for e in port},
            "other_device_ops": [e.key for e in dev
                                 if "moba_decode_" not in e.key],
            "captures": capture}


def decode_library(q, pool, table, kv, idx, sel_valid):
    """The decode's library call: ``scaled_dot_product_attention`` over
    the selected pages, gathered (and dequantized) beforehand, with a
    mask of their valid tokens."""
    import torch
    from repro_torch.core import quantization as Q
    sc = _scales(pool)
    b, h, _, d = q.shape
    _, ps, hkv, _ = pool["pages_k"].shape
    phys = table.clamp(min=0).long()[
        torch.arange(b, device=q.device)[:, None, None, None, None], idx]
    heads = torch.arange(hkv, device=q.device)[None, :, None, None, None]
    kg = pool["pages_k"].permute(2, 0, 1, 3)[heads, phys]  # (B,Hkv,G,1,k,ps,d)
    vg = pool["pages_v"].permute(2, 0, 1, 3)[heads, phys]
    if sc:
        kg = Q.dequantize(kg, sc["scales_k"][phys, heads][..., None, None])
        vg = Q.dequantize(vg, sc["scales_v"][phys, heads][..., None, None])
    kg = kg.reshape(b, h, -1, d).to(q.dtype)
    vg = vg.reshape(b, h, -1, d).to(q.dtype)
    pos = idx[..., None] * ps + torch.arange(ps, device=q.device)
    mask = ((pos < kv[:, None, None, None, None, None])
            & sel_valid[..., None]).reshape(b, h, 1, -1)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, kg, vg, attn_mask=mask)
    return library


def _time_decode(q, pool, table, kv, cfg, args, err, flush):
    from repro_torch.core.moba import moba_paged_decode_attention as plain
    from repro_torch.core.moba import moba_paged_route
    from repro_torch.kernels import moba_decode as MD
    sc = _scales(pool)
    cents = pool["centroids"]
    d = q.shape[-1]
    ps = pool["pages_k"].shape[1]
    idx, sel_valid = moba_paged_route(q, cents, table, kv, cfg,
                                      page_size=ps)
    tables = MD.decode_tables(q, pool["pages_k"], table, idx, sel_valid)
    scale = d ** -0.5

    def call():
        return MD.moba_paged_decode(*args, **sc)

    def launches():
        return MD.launch(q, pool["pages_k"], pool["pages_v"], cents, table,
                         kv, cfg.top_k, scale, sc.get("scales_k"),
                         sc.get("scales_v"))

    library = decode_library(q, pool, table, kv, idx, sel_valid)
    act = kv > 0
    ref = plain(*args, **sc)
    sdpa_err = float((library()[act].float() - ref[act].float()).abs().max())
    nbytes, flops = _decode_bytes_and_flops(q, pool, table, kv, idx,
                                            sel_valid, tables)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    return {**call_cost(call, flush),
            "kernel_only_ms": cuda_events_ms(launches, flush=flush),
            "kernel_only_ms_clean_l2": cuda_events_ms(launches, flush=flush,
                                                      clean=True),
            **call_cost(lambda: plain(*args, **sc), flush, "plain_"),
            **call_cost(library, flush, "library_"),
            "library_max_abs_err": sdpa_err,
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_us": max(bytes_ms, ops_ms) * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err, "profile": _profile_call(call)}


def _tie_values(rows: int):
    """Row values for the signed-zero tie check: every other row 0.0 (its
    score is exactly 0.0, a tie), the rest ±(1..13)/4 (exact scores, far
    apart), so queries with negative components rank a quarter of the
    rows above the zeros and a quarter below."""
    import torch
    j = torch.arange(rows, device="cuda")
    return torch.where(j % 2 == 0, 0.0, torch.where(j % 4 == 1, 1.0, -1.0)
                       * (((j * 7) % 13) + 1).float() * 0.25)


def _ties_cut(masked, sel) -> int:
    """Rows whose selection ``sel`` (indices into ``masked``'s last axis)
    takes some but not all of the row's candidates scoring exactly 0.0:
    there the tie order decided which."""
    zero_sel = (masked.gather(-1, sel) == 0).sum(-1)
    zero_all = (masked == 0).sum(-1)
    return int(((zero_sel > 0) & (zero_all > zero_sel)).sum())


def phase_zero_ties():
    """Top-k ties at exactly 0.0 on the card: queries with every component
    negative (bf16-representable, so every product is exact) against
    centroids whose every other row is zero (:func:`_tie_values`),
    through Flash TopK (block 128 / top_k 8, the register list, bf16 and
    fp32; block 16 / top_k 64, the shared-memory list, bf16) and the
    decode route (moba-340m's decode shape, bf16 q).  Selections must
    equal the plain versions' (``flash_topk_ref``,
    ``route_tables_plain``) exactly, ties included: both order on the
    float's total order, then the lower index.  The rows whose selection
    a tie at 0.0 cut (:func:`_ties_cut`) are counted; there must be
    some."""
    import torch
    from repro_torch.configs.base import MoBAConfig
    from repro_torch.core import moba as CM
    from repro_torch.kernels import flash_topk as KT
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(13)

    def negative(shape, dtype):
        x = -(torch.rand(shape, generator=gen, device="cuda") + 0.05)
        return x.to(torch.bfloat16).to(dtype)

    recs, ok = [], True
    for bs, top_k, dtype in ((128, 8, torch.bfloat16),
                             (128, 8, torch.float32),
                             (16, 64, torch.bfloat16)):
        h, hkv, n, d = 4, 2, 2048, 64
        nb = n // bs
        q = negative((h, n, d), dtype)
        cents = torch.zeros((hkv, nb, d), device="cuda", dtype=dtype)
        cents[:, :, 0] = _tie_values(nb).to(dtype)
        got = KT.flash_topk(q, cents, top_k, bs, group=h // hkv,
                            num_q_heads=h)
        want = ref.flash_topk_ref(q, cents, top_k, bs, group=h // hkv,
                                  num_q_heads=h)
        masked = _masked_scores(q, cents[ref.kv_rows(h, h, h // hkv,
                                                     q.device)], n, bs)
        cut = _ties_cut(masked, want.long())
        equal = bool(torch.equal(got, want))
        recs.append({"kernel": "flash_topk", "block_size": bs,
                     "top_k": top_k, "dtype": str(dtype), "n": n,
                     "equal": equal, "rows_cut_in_a_zero_tie": cut,
                     "rows": int(want.shape[0] * want.shape[1])})
        ok &= equal and cut > 0
    # the decode route at moba-340m's decode shape, bf16 q
    cfg = MoBAConfig(block_size=128, top_k=8)
    q, pool, table, kv = _paged_case(
        b=8, h=16, hkv=16, d=64, ps=128, npg=33, num_pages=320,
        kv_lens=[0, 1, 128, 100, 1500, 3000, 4224, 2777],
        dtype=torch.bfloat16, seed=7)
    q = negative(q.shape, torch.bfloat16)
    pool["centroids"].zero_()
    pool["centroids"][:, :, 0] = _tie_values(
        pool["centroids"].shape[0])[:, None]
    _, rt = _decode_launch(q, pool, table, kv, cfg)
    plain = MD.route_tables_plain(q, pool["centroids"], table, kv, cfg.top_k,
                                  128)
    masked = CM.paged_route_scores(q, pool["centroids"], table, kv,
                                   128)[..., 0, :].reshape(rt.sel.shape[0],
                                                           -1, table.shape[1])
    masked = torch.cat([masked, torch.full_like(masked[..., :1],
                                                CM.NEG_INF)], -1)
    sel = plain.sel.long()
    cut = _ties_cut(masked, torch.where(sel >= 0, sel, table.shape[1]))
    equal = bool(torch.equal(rt.sel, plain.sel))
    recs.append({"kernel": "moba_paged_decode (route)", "block_size": 128,
                 "top_k": 8, "dtype": "torch.bfloat16", "equal": equal,
                 "rows_cut_in_a_zero_tie": cut,
                 "rows": int(sel.shape[0] * sel.shape[1])})
    ok &= equal and cut > 0
    signed = _signed_zero_checks(negative, q.shape, pool, table, kv, cfg)
    ok &= all(r["ok"] for r in signed)
    recs += signed
    emit({"phase": "zero_ties", "checks": recs, "ok": ok})
    if not ok:
        raise SystemExit("zero_ties: a kernel's selections differ from its "
                         "plain version's on ties at 0.0, or no tie was "
                         "selected, or a kernel ordered -0.0 against +0.0 "
                         "other than lax.top_k does")


# a query component of about -1e-30 times a centroid component of 1e-20:
# the product (~-1e-50) is below fp32's least subnormal
SIGNED_Q_SCALE = 1e-30
SIGNED_TINY = 1e-20


def _signed_centroids(rows: int, d: int):
    """fp32 centroid rows for the signed-zero check, and two row masks:
    rows 4i are zero (a score of +0.0), rows 4i+2 hold
    :data:`SIGNED_TINY` in every component (``tiny``), odd rows
    :func:`_tie_values`' exact values in component 0."""
    import torch
    j = torch.arange(rows, device="cuda")
    c = torch.zeros((rows, d), device="cuda")
    c[:, 0] = _tie_values(rows)
    tiny = j % 4 == 2
    c[tiny] = SIGNED_TINY
    return c, tiny, j % 4 == 0


def _signed_zero_checks(negative, q_shape, pool, table, kv, cfg) -> list:
    """-0.0 on the card: queries of negative components about -1e-30
    against :func:`_signed_centroids`.  Each product of a tiny row
    underflows, and a fused multiply-add whose exact result is nonzero
    and rounds to zero keeps that result's sign, so the kernels' fp32
    chains score a tiny row -0.0 while a zero row stays +0.0.  The plain
    versions' einsum need not round the same way, so the expected
    selections come from the plain selection code on the scores with the
    tiny rows set to -0.0 (``neg``: ``lax.top_k`` ranks them below the
    zero rows) and to +0.0 (``pos``: what a float compare, which ties
    the two zeros, selects on -0.0 scores too).  Each kernel must equal
    one of the two; ``ordered_as`` says which, and ``rows_where_sign_
    decides`` counts the rows where they differ (there must be some).
    Through Flash TopK in fp32 (block 128 / top_k 8) and the decode
    route (fp32 centroids, bf16 q)."""
    import torch
    from repro_torch.core import moba as CM
    from repro_torch.core import routing
    from repro_torch.kernels import flash_topk as KT
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.kernels import ref

    def result(kernel, got, want, extra):
        eq = {z: bool(torch.equal(got, w)) for z, w in want.items()}
        differ = int((want["neg"] != want["pos"]).reshape(
            want["neg"].shape[0], -1).any(-1).sum())
        return {"kernel": kernel, "signed": True, **extra,
                "ordered_as": ("-0.0 below +0.0" if eq["neg"] else
                               "+0.0" if eq["pos"] else "neither"),
                "rows_where_sign_decides": differ,
                "rows": int(want["neg"].shape[0]),
                "ok": (eq["neg"] or eq["pos"]) and differ > 0}

    out = []
    h, hkv, n, d, bs, top_k = 4, 2, 2048, 64, 128, 8
    nb = n // bs
    q = negative((h, n, d), torch.float32) * SIGNED_Q_SCALE
    c, tiny, zero = _signed_centroids(nb, d)
    cents = c.expand(hkv, nb, d).contiguous()
    got = KT.flash_topk(q, cents, top_k, bs, group=h // hkv, num_q_heads=h)
    scores = routing.routing_scores(
        q, cents[ref.kv_rows(h, h, h // hkv, q.device)])
    pos = torch.arange(n, device="cuda")
    scores = torch.where(zero, torch.zeros_like(scores), scores)
    want = {z: routing.select_blocks(
        torch.where(tiny, torch.full_like(scores, v), scores), top_k, bs,
        pos) for z, v in (("neg", -0.0), ("pos", 0.0))}
    out.append(result("flash_topk", got.reshape(h * n, -1),
                      {z: w.reshape(h * n, -1) for z, w in want.items()},
                      {"block_size": bs, "top_k": top_k,
                       "dtype": "torch.float32", "n": n,
                       "plain_equal": bool(torch.equal(got, ref.flash_topk_ref(
                           q, cents, top_k, bs, group=h // hkv,
                           num_q_heads=h)))}))
    # the decode route: the page's physical id picks its centroid row
    c, tiny, zero = _signed_centroids(pool["centroids"].shape[0],
                                      pool["centroids"].shape[-1])
    pool["centroids"].copy_(c[:, None, :].expand_as(pool["centroids"]))
    q = (negative(q_shape, torch.float32) * SIGNED_Q_SCALE).to(torch.bfloat16)
    _, rt = _decode_launch(q, pool, table, kv, cfg)
    masked = CM.paged_route_scores(q, pool["centroids"], table, kv, 128)
    live = masked.abs() < 1e29
    ent = table.clamp(min=0).long()
    tiny_pg = (tiny[ent] & (table >= 0))[:, None, None, None, :] & live
    masked = torch.where((zero[ent] & (table >= 0))[:, None, None, None, :]
                         & live, torch.zeros_like(masked), masked)
    want, scores_fn = {}, MD.paged_route_scores
    try:
        for z, v in (("neg", -0.0), ("pos", 0.0)):
            crafted = torch.where(tiny_pg, torch.full_like(masked, v), masked)
            MD.paged_route_scores = lambda *a, _m=crafted: _m
            want[z] = MD.route_tables_plain(q, pool["centroids"], table, kv,
                                            cfg.top_k, 128).sel
    finally:
        MD.paged_route_scores = scores_fn
    plain = MD.route_tables_plain(q, pool["centroids"], table, kv, cfg.top_k,
                                  128)
    out.append(result("moba_paged_decode (route)", rt.sel, want,
                      {"block_size": 128, "top_k": cfg.top_k,
                       "dtype": "torch.bfloat16",
                       "plain_equal": bool(torch.equal(rt.sel, plain.sel))}))
    return out


# ------------------------------------------------------------------ phase 3
def _moba_layers(cfg) -> int:
    """MoBA self-attention layers of the decoder stack: ``moba`` slots,
    and ``decoder`` slots of a MoBA model."""
    from repro_torch.models import transformer as T
    return cfg.num_layers // len(cfg.layer_pattern) * sum(
        T._self_kind(cfg, k) == "moba" for k in cfg.layer_pattern)


def _recording(eng, gaps: list, n_uniq: list):
    """Patches for a measured run: every decode step's top-2 logit gap
    and pre-step length per slot with the slot's request id
    (``gaps``), and every decode call's union sizes with its lengths
    (``n_uniq``: views of the call's own tables and inputs, no copy, no
    launch).  Returns the undo."""
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.models import transformer as T
    decode, launch = T.decode_step, MD._launch

    def decode_rec(params, token, cfg, caches, **kw):
        logits, caches = decode(params, token, cfg, caches, **kw)
        top2 = logits[:, -1].float().topk(2, dim=-1).values
        gaps.append(({r.slot: r.rid for r in eng.sched.running
                      if r.slot >= 0}, kw["page_state"]["kv_len"].clone(),
                     top2[:, 0] - top2[:, 1]))
        return logits, caches

    def launch_rec(*a, **kw):
        out, scratch, p = launch(*a, **kw)
        n_uniq.append((scratch[-p.rows:], a[5]))         # a[5]: kv_len
        return out, scratch, p

    T.decode_step, MD._launch = decode_rec, launch_rec

    def undo():
        T.decode_step, MD._launch = decode, launch
    return undo


def _moe_drops(drops: list):
    """Patch ``models/moe.py::expert_slots`` to keep, for every call over
    more than 64 tokens (a prefill's shared capacity), the count of
    (token, slot) pairs past the capacity as a device tensor (read after
    the run, so no step syncs) and the pairs routed.  Returns the
    undo."""
    from repro_torch.models import moe as MOE
    slots = MOE.expert_slots

    def counted(top_e, num_experts, cap):
        onehot, pos, keep = slots(top_e, num_experts, cap)
        if top_e.shape[0] > 64:
            drops.append(((~keep).sum(), keep.numel()))
        return onehot, pos, keep

    MOE.expert_slots = counted

    def undo():
        MOE.expert_slots = slots
    return undo


def _gaps_by_token(gaps: list, reqs) -> dict:
    """rid -> {token index j: the top-2 logit gap of the decode step that
    produced token j} (token 0 comes from prefill; the step that produces
    token j starts at length prompt + j - 1)."""
    plen = {r.rid: len(r.prompt) for r in reqs}
    out = {r.rid: {} for r in reqs}
    for slots, kv, gap in gaps:
        kv, gap = kv.cpu().numpy(), gap.cpu().numpy()
        for s, rid in slots.items():
            out[rid][int(kv[s]) - plen[rid] + 1] = float(gap[s])
    return out


def phase_serve(kv_dtype: str = "fp32", new_tokens: int = 64,
                bf16_pool_bytes: int = 0, *, arch: str = "moba-340m",
                key_conv_width: int = 0, prefill_chunk: int = 0,
                prompts: int = 8, phase: str = "",
                route_policy: str = "static", backend: str = "flash",
                record: bool = False, profile: bool = True):
    """The serve cell on ``backend`` (``flash``: the decode kernels) from
    ``kv_dtype`` pools: ``arch`` (with key conv of ``key_conv_width``) at
    full width and depth, ``prompts`` requests of 1024..4095 tokens,
    routed by ``route_policy``.  ``record`` keeps each decode step's
    top-2 logit gaps and each decode call's union sizes; ``profile`` adds
    the profiled window.  An MoE model's record counts the (token, slot)
    pairs its prefills dropped past the expert capacity.  Returns the
    decode calls and the decode kernels' launches in the measured run,
    the pools' bytes and the record (with the streams and, if recorded,
    the gaps by token)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig

    phase = phase or ("serve" if kv_dtype == "fp32" else "serve_quantized")
    cfg = get_config(arch, **({"key_conv_width": key_conv_width}
                              if key_conv_width else {}))
    moba_layers = _moba_layers(cfg)
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = Engine(cfg, params, EngineConfig(
        max_seqs=8, max_prefill_batch=2, max_seq_len=4224,
        attn_backend=backend, kv_dtype=kv_dtype,
        prefill_chunk=prefill_chunk, route_policy=route_policy),
        device="cuda")
    pool_bytes = sum(t.numel() * t.element_size()
                     for pool in eng.caches.values() for t in pool.values())
    rng = np.random.default_rng(0)
    lens = rng.integers(1024, 4096, 8)[:prompts]
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, int(n),
                                    dtype=np.int32), max_new_tokens=new_tokens)
            for n in lens]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gaps, n_uniq, drops = [], [], []
    undo = _recording(eng, gaps, n_uniq) if record else None
    undo_drops = _moe_drops(drops) if cfg.family == "moe" else None
    MD.LAUNCHES = MD.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        eng.run()
        torch.cuda.synchronize()
    finally:
        for u in (undo, undo_drops):
            if u is not None:
                u()
    wall = time.perf_counter() - t0
    launches, kernel_launches = MD.LAUNCHES, MD.KERNEL_LAUNCHES
    st = dict(eng.stats)           # the profile window below adds steps
    outs_ok = all(len(r.out) == new_tokens and r.done for r in reqs)
    toks = np.concatenate([np.asarray(r.out) for r in reqs])
    in_vocab = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    rec = {"phase": phase,
           "arch": cfg.name, "dtype": cfg.dtype, "kv_dtype": kv_dtype,
           "backend": backend, "route_policy": route_policy,
           "prefill_chunk": prefill_chunk,
           "prompt_lens": [int(n) for n in lens], "new_tokens": new_tokens,
           "requests_done": sum(r.done for r in reqs),
           "prefill_tokens": st["prefill_tokens"],
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tokens": st["decode_tokens"],
           "decode_steps": st["decode_steps"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "decode_step_ms": st["decode_s"] / st["decode_steps"] * 1e3,
           "wall_s": wall, "preemptions": st["preemptions"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "pool_bytes": pool_bytes,
           "decode_calls": launches,
           "decode_calls_per_step": launches / max(st["decode_steps"], 1),
           "kernel_launches": kernel_launches,
           "kernel_launches_per_step":
               kernel_launches / max(st["decode_steps"], 1)}
    if bf16_pool_bytes:
        rec["pool_bytes_vs_bf16"] = pool_bytes / bf16_pool_bytes
    if drops:
        rec["prefill_moe_calls"] = len(drops)
        rec["prefill_pairs"] = sum(n for _, n in drops)
        rec["prefill_pairs_dropped"] = int(sum(d for d, _ in drops))
    ring = next((pool["key_conv_state"] for pool in eng.caches.values()
                 if "key_conv_state" in pool), None)
    want = (cfg.num_layers // len(cfg.layer_pattern), 8, cfg.num_kv_heads,
            key_conv_width - 1, cfg.resolved_head_dim)
    ring_ok = ring is None and not key_conv_width
    if ring is not None:
        rec["ring"] = {"shape": list(ring.shape), "dtype": str(ring.dtype),
                       "expected_shape": list(want)}
        ring_ok = tuple(ring.shape) == want and ring.dtype == torch.bfloat16
    if eng.route_profile is not None:
        rec["route_profile"] = eng.route_profile.summary()
    if n_uniq:
        rec["mean_n_uniq"] = _mean_n_uniq(*(torch.cat(x) for x in
                                            zip(*n_uniq)))
    if profile:
        rec["profile"] = _profile_decode(eng, cfg, rng)
    emit(rec)
    rec["streams"] = [list(r.out) for r in reqs]
    if record:
        rec["gaps"] = _gaps_by_token(gaps, reqs)
    # the engine sits in a reference cycle (its scheduler's preemption
    # hook), so only the collector frees its pools before the next phase
    # resets the peak-memory counter
    del eng, params, ring
    gc.collect()
    torch.cuda.empty_cache()
    what = f"{phase} ({cfg.name}, {kv_dtype}, {backend}, {route_policy})"
    if not outs_ok or not in_vocab:
        raise SystemExit(f"{what}: a request did not finish with "
                         f"{new_tokens} tokens in the vocabulary")
    # the plain backends launch no decode kernel
    if backend == "flash" and (
            launches == 0 or launches != moba_layers * st["decode_steps"]):
        raise SystemExit(f"{what}: {launches} decode calls for "
                         f"{st['decode_steps']} decode steps, expected "
                         f"{moba_layers} per step")
    if kernel_launches != 3 * launches:
        raise SystemExit(f"{what}: {kernel_launches} decode "
                         f"kernel launches for {launches} calls, expected 3 "
                         f"per call")
    if not ring_ok:
        raise SystemExit(f"{what}: the key-conv ring is missing or is not "
                         f"bf16 of shape {want}: {rec.get('ring')}")
    return launches, kernel_launches, pool_bytes, rec


def _profile_decode(eng, cfg, rng, steps: int = 6):
    """Where a decode step's time goes, after the measured run: 8 fresh
    1024-token requests staged in, then ``steps`` generate_step calls
    under torch.profiler (:func:`_profile_summary`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    reqs = [eng.make_request(rng.integers(0, cfg.vocab_size, 1024,
                                          dtype=np.int32), steps + 4)
            for _ in range(8)]
    for r in reqs:
        if not eng.insert(eng.prefill(r)):
            raise SystemExit("profile: a staged request went stale")
    eng.generate_step()                       # fill the pipeline
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.generate_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()                                 # finish the window's requests
    return {"batch": len(reqs), **_profile_summary(prof, wall, steps)}


def _profile_summary(prof, wall: float, steps: int) -> dict:
    """Per-step device busy time, idle share, kernel and launch counts and
    the top device and host rows of a profiled window of ``steps`` steps
    that took ``wall`` seconds.  Device busy share = summed kernel time
    over the window's wall time (one stream, so kernels do not overlap);
    the profiler's own host cost lengthens the wall time a little."""
    avgs = prof.key_averages()
    # kernel rows only: an operator's row repeats its kernels' time
    dev = sorted(((a.key, a.self_device_time_total, a.count)
                  for a in _device_rows(avgs)), key=lambda r: -r[1])
    device_us = sum(t for _, t, _ in dev)
    host = sorted(((a.key, a.self_cpu_time_total, a.count) for a in avgs),
                  key=lambda r: -r[1])
    launch_calls = sum(c for k, _, c in host if k.startswith("cudaLaunch"))
    return {"steps": steps, "step_ms": wall / steps * 1e3,
            "device_busy_ms_per_step": device_us / steps / 1e3,
            "device_idle_share": 1.0 - device_us / (wall * 1e6),
            "kernels_per_step": sum(c for _, _, c in dev) / steps,
            "launch_calls_per_step": launch_calls / steps,
            "top_device": [{"op": k, "us_per_step": t / steps,
                            "calls_per_step": c / steps}
                           for k, t, c in dev[:8]],
            "top_host": [{"op": k, "us_per_step": t / steps,
                          "calls_per_step": c / steps}
                         for k, t, c in host[:8]]}


# ------------------------------------------------------------------ phase 4
LOGITS_LENS = (1500, 900, 2000, 300)      # phase 4's four sequences


def _logits_case(cfg, kv_dtype: str = "fp32", seed: int = 1,
                 lens=LOGITS_LENS, npg: int = 33):
    """fp32 weights from ``seed`` and the paged-prefill inputs of phase 4:
    sequences of ``lens`` tokens (default :data:`LOGITS_LENS`) on
    shuffled 128-token pages, ``npg`` a table, each at the sequence slot
    of its row.  Returns (params, device inputs, host tokens, a factory
    of empty caches with one key-conv ring row a sequence)."""
    import torch
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    params = T.init_lm(torch.Generator(device=dev).manual_seed(seed), cfg)
    ps = 128
    lens = np.array(lens, np.int32)
    b = len(lens)
    rng = np.random.default_rng(seed)
    pages = rng.permutation(b * npg)
    table = np.full((b, npg), -1, np.int32)
    for i, n in enumerate(lens):
        m = -(-(int(n) + 1) // ps)
        table[i, :m] = pages[i * npg:i * npg + m]
    tokens = np.zeros((b, 2048), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, cfg.vocab_size, n)

    def caches():
        return T.init_paged_caches(cfg, b * npg, ps, dtype=torch.float32,
                                   device=dev, kv_dtype=kv_dtype,
                                   max_seqs=b)

    t = {k: torch.as_tensor(v, device=dev) for k, v in dict(
        tokens=tokens, table=table, kv0=np.zeros(b, np.int32), lens=lens,
        slots=np.arange(b, dtype=np.int32),
        active=np.ones(b, bool)).items()}
    return params, t, tokens, caches


def _decode_flash_vs_xla(cfg, params, caches, t, first,
                         route_map=None, keep_logits: bool = False) -> dict:
    """One decode step under ``flash`` and one under ``xla`` from clones
    of the prefilled ``caches`` (per-head budgets from ``route_map``, if
    given).  The flash run records the route kernel's selections in every
    MoBA layer; the xla run replays them, each held to xla's own routing
    by the near-tie rule (the kernel sums its fp32 dot products in
    another order than the plain einsum, so a near-tie can flip a page).
    Returns the record's fields and ``ok`` (``keep_logits``: also each
    run's last logits and tokens, under ``_logits`` and ``_tokens``)."""
    import torch
    from repro_torch.core import moba as CM
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T

    moba_layers = _moba_layers(cfg)
    page_state = {"block_table": t["table"], "kv_len": t["lens"],
                  "q_len": t["active"].to(torch.int32),
                  "active": t["active"]}
    decode, plain_route = MD.moba_paged_decode, CM.moba_paged_route
    recorded, audit = [], []

    def record(q, pages_k, pages_v, centroids, table, kv, mcfg, scale=None,
               grid="grouped", scales_k=None, scales_v=None,
               head_top_k=None):
        """The decode call itself, keeping the route tables it wrote."""
        MD.check_contract(q, pages_k, pages_v, scales_k, scales_v,
                          centroids=centroids, block_table=table, kv_len=kv,
                          top_k=mcfg.top_k, head_top_k=head_top_k)
        out, rt = MD.launch(q, pages_k, pages_v, centroids, table, kv,
                            mcfg.top_k,
                            q.shape[-1] ** -0.5 if scale is None else scale,
                            scales_k, scales_v, head_top_k)
        recorded.append(rt)
        return out

    def replay(q, centroids, table, kv, mcfg, page_size=None,
               head_top_k=None):
        idx, sel_valid = plain_route(q, centroids, table, kv, mcfg,
                                     page_size=page_size,
                                     head_top_k=head_top_k)
        rt = recorded[len(audit)]
        audit.append(_route_near_ties(q, centroids, table, kv, page_size,
                                      rt.sel, idx, sel_valid))
        return _kernel_selection(rt, q, centroids)

    def clone():
        return {s: {k: v.clone() for k, v in pool.items()}
                for s, pool in caches.items()}

    logits, toks = {}, {}
    try:
        for backend in ("flash", "xla"):
            MD.moba_paged_decode, CM.moba_paged_route = (
                (record, plain_route) if backend == "flash"
                else (decode, replay))
            lg, _ = T.decode_step(params, first[:, None], cfg, clone(),
                                  backend=backend, page_state=page_state,
                                  route_map=route_map)
            step_tok, _ = S.make_paged_decode_step(
                cfg, backend, route_map=route_map)(
                params, first, clone(), t["table"], t["lens"], t["active"])
            logits[backend] = lg[:, -1]
            toks[backend] = step_tok
    finally:
        MD.moba_paged_decode, CM.moba_paged_route = decode, plain_route
    torch.cuda.synchronize()
    routing_ok = (len(audit) == len(recorded) == 2 * moba_layers
                  and all(ok for _, _, ok in audit))
    diff = float((logits["flash"] - logits["xla"]).abs().max())
    close = bool(torch.allclose(logits["flash"], logits["xla"], atol=2e-3,
                                rtol=2e-3))
    finite = bool(torch.isfinite(logits["flash"]).all())
    same = bool(torch.equal(toks["flash"], toks["xla"])
                and torch.equal(toks["flash"],
                                logits["flash"].argmax(-1).to(torch.int32)))
    rec = {"vocab": cfg.vocab_size, "max_abs_diff": diff, "tol": 2e-3,
           "allclose": close, "finite": finite, "greedy_equal": same,
           "routing_rows_differing_per_layer": [r for r, _, _ in audit],
           "routing_max_gap": max((g for _, g, _ in audit), default=0.0),
           "routing_near_ties_ok": routing_ok,
           "ok": close and finite and same and routing_ok}
    if keep_logits:
        rec.update(_logits=logits, _tokens=toks)
    return rec


def phase_logits(kv_dtype: str = "fp32", arch: str = "moba-340m",
                 phase: str = "logits", nonuniform: bool = False):
    """flash against xla for one decode step in fp32 after one shared
    paged prefill (:func:`_decode_flash_vs_xla`); ``nonuniform`` routes
    both (and the prefill) by :func:`nonuniform_profile`'s budgets."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    rmap = (S.as_route_map(nonuniform_profile(cfg).route_map(), "cuda")
            if nonuniform else None)
    params, t, _, new_caches = _logits_case(cfg, kv_dtype)
    first, caches = S.make_paged_prefill_step(
        cfg, "xla", chunked=True, route_map=rmap)(
        params, t["tokens"], new_caches(), t["table"], t["kv0"], t["lens"],
        t["slots"], t["active"])
    rec = _decode_flash_vs_xla(cfg, params, caches, t, first, rmap)
    emit({"phase": phase, "arch": cfg.name, "dtype": "float32",
          "kv_dtype": kv_dtype, "batch": len(LOGITS_LENS),
          "kv_lens": list(LOGITS_LENS), "nonuniform_profile": nonuniform,
          **rec})
    del params, caches
    torch.cuda.empty_cache()
    if not rec["ok"]:
        raise SystemExit(f"{phase} ({kv_dtype}): flash and xla decode steps "
                         f"disagree, or a routing difference is no "
                         f"near-tie")


# ------------------------------------------------------- adaptive routing
# a top-2 gap of the bf16 decode logits at or below which two backends'
# greedy streams may part: 4 bf16 steps at logits in [2, 4)
BF16_GAP_TOL = 0.0625


def nonuniform_profile(cfg):
    """The routing profile the card serves to make truncation bite:
    ``RoutingProfile.uniform(cfg)`` with every other head at budget 1
    (its own page only) and the rest cycling through 2..top_k."""
    from repro_torch.core import adaptive as AD
    prof = AD.RoutingProfile.uniform(cfg)
    k = prof.k_max
    for arr in prof.top_k.values():
        flat = arr.reshape(-1)
        for i in range(flat.size):
            flat[i] = 1 if i % 2 == 0 else min(2 + (i // 2) % max(k - 1, 1),
                                               k)
    return prof


def _streams_vs(a: dict, b: dict) -> dict:
    """Greedy streams of two serve records: where each request first
    parts, and whether every parting is at a near-tie (the top-2 gap of
    either run's logits at that token at most :data:`BF16_GAP_TOL`)."""
    parted, explained = [], True
    for rid, (sa, sb) in enumerate(zip(a["streams"], b["streams"])):
        j = next((j for j, (x, y) in enumerate(zip(sa, sb)) if x != y),
                 None)
        if j is None:
            continue
        gap = min(a["gaps"][rid].get(j, np.inf),
                  b["gaps"][rid].get(j, np.inf))
        parted.append({"request": rid, "token": j, "gap": gap})
        explained &= gap <= BF16_GAP_TOL
    return {"streams_equal": len(a["streams"]) - len(parted),
            "parted": parted, "gap_tol": BF16_GAP_TOL,
            "near_ties_ok": explained}


def phase_serve_adaptive():
    """moba-340m at full width (bf16) with SNR-guided adaptive routing on
    ``flash``: phase 3's prompts, 32 new tokens, under static routing,
    (a) ``snr:pfail=0.01`` calibrated at engine build, and (b) the
    non-uniform :func:`nonuniform_profile` loaded from a file, then (b)
    on ``xla`` and (b) from an int8 pool; then phase 4's fp32 flash vs
    xla decode check under (b).  Gates under (b): every request
    finishes, 12 decode calls and 36 kernels a step, the launch calls of
    a profiled step equal static's, the stream differs from static's,
    flash and xla streams part only at near-ties.  Returns the decode
    calls and kernel launches of (b)'s flash run and the record."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import adaptive as AD

    cfg = get_config("moba-340m")
    n = QUANT_NEW_TOKENS
    runs = {"static": phase_serve("fp32", n, phase="serve_adaptive",
                                  record=True)[3]}
    calibrate, calib = AD.calibrate_profile, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = calibrate(*a, **kw)
        torch.cuda.synchronize()
        calib.append(time.perf_counter() - t0)
        return prof

    AD.calibrate_profile = timed
    try:
        runs["snr"] = phase_serve("fp32", n, phase="serve_adaptive",
                                  route_policy="snr:pfail=0.01",
                                  record=True, profile=False)[3]
    finally:
        AD.calibrate_profile = calibrate
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "routing_profile.json")
        nonuniform_profile(cfg).save(path)
        policy = f"profile:{path}"
        calls, kernels, _, runs["b"] = phase_serve(
            "fp32", n, phase="serve_adaptive", route_policy=policy,
            record=True)
        runs["b_xla"] = phase_serve("fp32", n, phase="serve_adaptive",
                                    route_policy=policy, backend="xla",
                                    record=True, profile=False)[3]
        int8 = phase_serve("int8", n, phase="serve_adaptive",
                           route_policy=policy, profile=False)
    phase_logits(phase="serve_adaptive_logits", nonuniform=True)
    st, b = runs["static"], runs["b"]
    vs_xla = _streams_vs(b, runs["b_xla"])
    differs = b["streams"] != st["streams"]
    same_launch_calls = (b["profile"]["launch_calls_per_step"]
                         == st["profile"]["launch_calls_per_step"])
    rec = {"phase": "serve_adaptive", "arch": cfg.name,
           "new_tokens": n, "calibration_s": calib,
           "snr_profile": runs["snr"]["route_profile"],
           "snr_streams_equal_static": runs["snr"]["streams"]
           == st["streams"],
           "b_profile": b["route_profile"],
           "b_int8_decode_calls_per_step": int8[3]["decode_calls_per_step"],
           "b_differs_from_static": differs,
           "b_flash_vs_xla": vs_xla,
           "launch_calls_per_step_equal_static": same_launch_calls,
           "compare": {name: {
               "decode_step_ms": r["profile"]["step_ms"],
               "device_busy_ms": r["profile"]["device_busy_ms_per_step"],
               "device_idle_share": r["profile"]["device_idle_share"],
               "launch_calls_per_step":
                   r["profile"]["launch_calls_per_step"],
               "run_decode_step_ms": r["decode_step_ms"],
               "mean_n_uniq": r["mean_n_uniq"]}
               for name, r in (("static", st), ("b", b))},
           "snr_mean_n_uniq": runs["snr"]["mean_n_uniq"]}
    emit(rec)
    if not (differs and vs_xla["near_ties_ok"] and same_launch_calls
            and len(calib) == 1):
        raise SystemExit("serve_adaptive: the non-uniform profile did not "
                         "change the stream, flash and xla parted off a "
                         "near-tie, a step's launch calls differ from "
                         "static's, or calibration did not run once")
    return calls, kernels, rec


# ------------------------------------------------------- key-conv logits
KEY_CONV_WIDTH = 3                          # the paper's kconv3
GAP_TOL = 1e-3          # a top-2 logit gap at or below which a greedy
#                         stream may part from another path's (fp32)


def phase_key_conv_logits(chunk: int = 1000):
    """moba-340m-kconv3 in fp32 (TF32 off), phase 4's sequences: a
    chunked prefill (chunks of ``chunk``) whose rings must hold each
    sequence's last W-1 raw keys bit for bit (recomputed one-shot from
    the raw keys every chunk computed), pools within 2e-4 of a one-shot
    prefill's, then :func:`_decode_flash_vs_xla` from the chunked caches;
    then the swap check (:func:`_key_conv_swap`)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import key_conv as KC
    from repro_torch.launch import steps as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(
        get_config("moba-340m", key_conv_width=KEY_CONV_WIDTH),
        dtype="float32")
    groups = cfg.num_layers // len(cfg.layer_pattern)
    params, t, tokens, new_caches = _logits_case(cfg)
    step = S.make_paged_prefill_step(cfg, "flash", chunked=True)
    _, one = step(params, t["tokens"], new_caches(), t["table"], t["kv0"],
                  t["lens"], t["slots"], t["active"])
    conv, raw, takes = KC.apply_key_conv_with_state, [], []

    def recording(weights, k, state):
        raw.append(k.clone())
        return conv(weights, k, state)

    lens = np.array(LOGITS_LENS, np.int32)
    b = len(lens)
    chunked = new_caches()
    first = torch.zeros(b, dtype=torch.int32, device=dev)
    KC.apply_key_conv_with_state = recording
    try:
        for s0 in range(0, int(lens.max()), chunk):
            q = np.clip(lens - s0, 0, chunk).astype(np.int32)
            kv = np.minimum(lens, s0).astype(np.int32)
            dv = {k: torch.as_tensor(v, device=dev) for k, v in dict(
                tok=np.ascontiguousarray(tokens[:, s0:s0 + chunk]), q=q,
                kv=kv, active=q > 0, last=(q > 0) & (kv + q == lens)).items()}
            out, chunked = step(params, dv["tok"], chunked, t["table"],
                                dv["kv"], dv["q"], t["slots"], dv["active"])
            first = torch.where(dv["last"], out, first)
            takes.append(q)
    finally:
        KC.apply_key_conv_with_state = conv
    torch.cuda.synchronize()
    # the rings against the last W-1 of the raw keys the chunks computed
    ring_equal = len(raw) == groups * len(takes)
    for g in range(groups):
        full = torch.zeros((b, cfg.num_kv_heads, int(lens.max()),
                            cfg.resolved_head_dim), device=dev)
        for c, q in enumerate(takes):
            k = raw[c * groups + g]
            for i in range(b):
                full[i, :, c * chunk:c * chunk + q[i]] = k[i, :, :q[i]]
        want = KC.key_conv_state_update(
            torch.zeros_like(full[:, :, :KEY_CONV_WIDTH - 1]), full,
            t["lens"])
        ring_equal &= bool(torch.equal(
            chunked["slot_1"]["key_conv_state"][g], want))
    del raw
    pools = {f"{sname}/{leaf}": float((x - one[sname][leaf]).abs().max())
             for sname, pool in chunked.items() for leaf, x in pool.items()}
    pools_close = all(
        bool(torch.allclose(x, one[sname][leaf], atol=2e-4, rtol=2e-4))
        for sname, pool in chunked.items() for leaf, x in pool.items()
        if leaf in ("pages_k", "pages_v", "centroids"))
    del one
    torch.cuda.empty_cache()
    rec = _decode_flash_vs_xla(cfg, params, chunked, t, first)
    del params, chunked
    torch.cuda.empty_cache()
    swap = _key_conv_swap()
    ok = ring_equal and pools_close and rec["ok"] and swap["ok"]
    emit({"phase": "key_conv_logits", "arch": cfg.name, "dtype": "float32",
          "batch": b, "kv_lens": list(LOGITS_LENS), "prefill_chunk": chunk,
          "rings_equal_last_raw_keys": ring_equal,
          "chunked_vs_one_shot_max_abs": pools,
          "pools_within_2e-4": pools_close, "decode": rec, "swap": swap,
          "ok": ok})
    if not ok:
        raise SystemExit("key_conv_logits: a ring is not the last raw "
                         "keys, chunked and one-shot pools differ, flash "
                         "and xla disagree, or the swap check failed")


def _key_conv_swap(layers: int = 4, new_tokens: int = 32) -> dict:
    """Swap preemption under key conv at full width, depth cut to
    ``layers`` (fp32): four prompts just under a page boundary in a pool
    of one page more than they take, so growing past it preempts by
    swap.  Every restored ring row must equal its snapshot bit for bit,
    and each greedy stream equal the stream of an engine with room for
    all up to its first step whose top-2 logit gap (teacher-forced,
    ``reference``) is at most :data:`GAP_TOL`."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import paged_cache as PC
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(
        get_config("moba-340m", key_conv_width=KEY_CONV_WIDTH),
        dtype="float32", num_layers=layers)
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(2), cfg)
    rng = np.random.default_rng(2)
    lens = (1020, 1010, 1015, 1000)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in lens]
    scatter, restored = PC.scatter_ring_rows, []

    def checked(caches, slot, data):
        caches = scatter(caches, slot, data)
        restored.append(all(
            torch.equal(caches[s][leaf][:, slot].cpu(), x)
            for (s, leaf), x in data.items()))
        return caches

    outs, stats = {}, {}
    for name, pages in (("roomy", 0), ("tight", 33)):
        eng = Engine(cfg, params, EngineConfig(
            max_seqs=4, max_seq_len=1152, num_pages=pages,
            attn_backend="flash"), device="cuda")
        reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        PC.scatter_ring_rows = checked
        try:
            eng.run()
        finally:
            PC.scatter_ring_rows = scatter
        outs[name] = [list(r.out) for r in reqs]
        stats[name] = {k: eng.stats[k] for k in (
            "preemptions", "swap_saves", "swap_restores", "decode_steps")}
        del eng
        gc.collect()               # as in phase_serve
    # teacher-forced top-2 gaps along the roomy streams
    first_tie, ties, diverged, explained = [], 0, 0, True
    for p, want, got in zip(prompts, outs["roomy"], outs["tight"]):
        seq = torch.as_tensor(np.concatenate([p, want[:-1]]),
                              device="cuda")[None]
        with torch.no_grad():
            lg, _, _ = T.lm_apply(params, seq, cfg, backend="reference")
        top2 = lg[0, len(p) - 1:].topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        tie = next((j for j, g in enumerate(gaps) if g <= GAP_TOL), None)
        ties += int((gaps <= GAP_TOL).sum())
        first_tie.append(tie)
        d = next((j for j, (a, c) in enumerate(zip(want, got)) if a != c),
                 None)
        if d is not None:
            diverged += 1
            explained &= tie is not None and tie <= d
    ok = (stats["tight"]["swap_restores"] > 0 and bool(restored)
          and all(restored) and stats["roomy"]["preemptions"] == 0
          and explained)
    return {"num_layers": layers, "prompt_lens": list(lens),
            "new_tokens": new_tokens, "stats": stats,
            "ring_restores_checked": len(restored),
            "ring_restores_equal": sum(restored),
            "streams_equal": sum(a == c for a, c in zip(outs["roomy"],
                                                       outs["tight"])),
            "streams_diverged": diverged, "near_tie_steps": ties,
            "first_near_tie_step": first_tie, "gap_tol": GAP_TOL, "ok": ok}


# ------------------------------------------------------------ prefix cache
PREFIX_SHARED = 2048            # the shared system prompt: 16 whole pages
PREFIX_COW_EXTRA = 37           # the variant's prefix ends 37 tokens into
#                                 page 17, so a hit copies that page (COW)
PREFIX_GAP_TOL = 1e-2           # a teacher-forced top-2 logit gap at or
#                                 below which a bf16 stream may part


def prefix_prompts(vocab: int, shared: int, n: int = 8, seed: int = 0):
    """``n`` prompts sharing one prefix of ``shared`` tokens, each then a
    distinct suffix of 64..1024 tokens (``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, shared, dtype=np.int32)
    lens = rng.integers(64, 1025, n)
    return [np.concatenate([prefix, rng.integers(0, vocab, int(s),
                                                 dtype=np.int32)])
            for s in lens]


def expected_prefix_stats(prompts, page_size: int, batch: int,
                          full_only: bool) -> dict:
    """The prefix-cache counts the scheduler's plan implies for
    ``prompts`` submitted at once to an empty engine with room for all
    and ``max_prefill_batch`` = ``batch``: request i is admitted in step
    i // batch, so the first step's requests miss; a later request
    matches its longest common prefix with a request admitted in an
    earlier step, up to that request's whole pages cached by then (its
    prompt at its prefill, then one token a step), capped at its own
    length - 1 and, with ``full_only`` (quantized or key-conv pools),
    rounded down to whole pages; a match that ends mid-page costs one
    COW copy."""
    hits = tokens = cow = 0
    for i, p in enumerate(prompts):
        wave, best = i // batch, 0
        for j in range(wave * batch):
            q = prompts[j]
            n = min(len(p), len(q))
            diff = np.flatnonzero(p[:n] != q[:n])
            lcp = int(diff[0]) if diff.size else n
            cached = len(q) + wave - j // batch
            best = max(best, min(lcp, cached - cached % page_size))
        best = min(best, len(p) - 1)
        if full_only:
            best -= best % page_size
        hits += best > 0
        tokens += best
        cow += best % page_size != 0
    return {"prefix_hits": hits, "prefix_hit_tokens": tokens,
            "cow_copies": cow}


PREFIX_STATS = ("prefix_hits", "prefix_hit_tokens", "prefix_prompt_tokens",
                "cow_copies", "tree_evictions", "preemptions")


def _prefix_serve(cfg, params, prompts, new_tokens: int, *,
                  device="cuda", record_conv: bool = False, **ekw):
    """One engine on ``flash`` (max_seqs 8, max_prefill_batch 2) serving
    ``prompts``, all submitted at once, ``new_tokens`` each; the decode
    kernels' counts are zeroed just before ``run()`` and read just after.
    ``record_conv`` keeps each prefill step's rows (request id, cached
    length before it) and, for each of its MoBA layers in order, the raw
    keys and the ring state that layer's conv read.  Returns the record
    (streams included), the engine, the steps and the conv records."""
    import torch
    from repro_torch.core import key_conv as KC
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.serving.engine import Engine, EngineConfig
    eng = Engine(cfg, params, EngineConfig(
        max_seqs=8, max_prefill_batch=2, max_seq_len=4224,
        attn_backend="flash", **ekw), device=device)
    reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    steps, convs = [], []
    run_prefill, conv = eng._run_prefill, KC.apply_key_conv_with_state

    def prefill_rec(rs, now):
        steps.append([(r.rid, r.cache_len) for r in rs])
        return run_prefill(rs, now)

    def conv_rec(weights, k, state):
        convs.append((k.clone(), state.clone()))
        return conv(weights, k, state)

    if record_conv:
        eng._run_prefill, KC.apply_key_conv_with_state = prefill_rec, conv_rec
    if device == "cuda":
        torch.cuda.synchronize()
    MD.LAUNCHES = MD.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        eng.run()
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        eng._run_prefill, KC.apply_key_conv_with_state = run_prefill, conv
    wall = time.perf_counter() - t0
    st = dict(eng.stats)
    rec = {"prefix_cache": eng.ecfg.prefix_cache,
           "kv_dtype": eng.ecfg.kv_dtype,
           "requests_done": sum(r.done and len(r.out) == new_tokens
                                for r in reqs),
           "prefill_tokens": st["prefill_tokens"],
           "prefill_s": st["prefill_s"],
           "decode_steps": st["decode_steps"],
           "decode_step_ms": st["decode_s"] / max(st["decode_steps"], 1)
           * 1e3,
           "wall_s": wall, "decode_calls": MD.LAUNCHES,
           "kernel_launches": MD.KERNEL_LAUNCHES,
           **{k: st[k] for k in PREFIX_STATS},
           "streams": [list(r.out) for r in reqs]}
    return rec, eng, steps, convs


def _teacher_gaps(cfg, params, prompts, streams, device="cuda"):
    """Top-2 logit gaps at each token of ``streams``, teacher-forced:
    one ``lm_apply`` on ``flash`` over each prompt and its stream (the
    gap at token j is that of the logits that chose it)."""
    import torch
    from repro_torch.models import transformer as T
    out = []
    for p, s in zip(prompts, streams):
        seq = torch.as_tensor(np.concatenate([p, np.asarray(s[:-1],
                                                            np.int32)]),
                              device=device)[None]
        with torch.no_grad():
            logits, _, _ = T.lm_apply(params, seq, cfg, backend="flash")
        top2 = logits[0, len(p) - 1:].float().topk(2, dim=-1).values
        out.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
    return out


def _parted(cfg, params, prompts, want, got,
            tol: float = PREFIX_GAP_TOL) -> dict:
    """Where each ``got`` stream first parts from ``want``; a parting is
    explained when ``want``'s teacher-forced top-2 gaps
    (:func:`_teacher_gaps`, computed for parted requests only) reach
    ``tol`` at or before it."""
    parted, ok = [], True
    for i, (a, b) in enumerate(zip(want, got)):
        d = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if d is None:
            continue
        g = _teacher_gaps(cfg, params, [prompts[i]], [a])[0]
        tie = next((j for j, v in enumerate(g) if v <= tol), None)
        parted.append({"request": i, "token": d, "first_near_tie": tie,
                       "gap_at_token": float(g[d])})
        ok &= tie is not None and tie <= d
    return {"streams_equal": len(want) - len(parted), "parted": parted,
            "gap_tol": tol, "ok": ok}


def _ring_loads_equal(steps, convs, groups: int, page_size: int) -> dict:
    """For every prefix-hit prefill row (cached length > 0 before its
    step), the ring state each MoBA layer's conv read must equal, bit for
    bit, the raw keys that the first step's first row (the request whose
    pages the tree holds) computed at the W-1 positions before the
    match: the tail its pages recorded, loaded into the ring."""
    import torch
    hits, equal = 0, True
    for s, rows in enumerate(steps):
        for r, (_, cached) in enumerate(rows):
            if cached == 0:
                continue
            hits += 1
            equal &= cached % page_size == 0
            for g in range(groups):
                k0 = convs[g][0][0]                         # step 0, row 0
                state = convs[s * groups + g][1][r]
                w = state.shape[1]
                equal &= bool(torch.equal(state,
                                          k0[:, cached - w:cached]))
    return {"hit_rows": hits, "rings_equal_publisher_raw_keys": equal,
            "conv_calls": len(convs), "prefill_steps": len(steps)}


def phase_serve_prefix():
    """moba-340m at full width (bf16, seed-0 weights) with the radix-tree
    prefix cache on ``flash``: 8 prompts sharing a 2,048-token prefix (16
    whole pages) with distinct 64..1,024-token suffixes, 32 new tokens,
    then the variant whose prefix is 2,085 tokens (a hit copies its
    partial page), then that traffic from int8 pools (whole pages only),
    then moba-340m-kconv3 on the first traffic (the suffix prefill's
    rings from the page tails), then a second turn (turn 1's prompt, its
    output and 64 new tokens).  Each against the same engine with
    ``prefix_cache=False`` on the same traffic (a fresh engine for the
    second turn): streams equal up to the first teacher-forced near-tie
    (:data:`PREFIX_GAP_TOL`), the hit and COW counts those
    :func:`expected_prefix_stats` implies, 12 decode calls and 36
    kernels a step, and, in a profiled window, the launch calls of a
    decode step equal to the no-cache engine's.  Returns the decode
    counts of the bf16, int8 and kconv3 runs with the cache on, and the
    record."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    n = QUANT_NEW_TOKENS
    rec, counts, bad = {"phase": "serve_prefix", "new_tokens": n}, {}, []
    vocab = get_config("moba-340m").vocab_size
    traffic = {"aligned": prefix_prompts(vocab, PREFIX_SHARED),
               "cow": prefix_prompts(vocab, PREFIX_SHARED + PREFIX_COW_EXTRA)}
    cases = (("bf16", "moba-340m", "aligned", "fp32"),
             ("bf16_cow", "moba-340m", "cow", "fp32"),
             ("int8_cow", "moba-340m", "cow", "int8"),
             ("kconv3", "moba-340m-kconv3", "aligned", "fp32"))
    for name, arch, tname, kv_dtype in cases:
        kconv = arch.endswith("kconv3")
        cfg = get_config("moba-340m", **({"key_conv_width": KEY_CONV_WIDTH}
                                          if kconv else {}))
        params = T.init_lm(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
        prompts = traffic[tname]
        runs = {}
        for on in (False, True):
            r, eng, steps, convs = _prefix_serve(
                cfg, params, prompts, n, kv_dtype=kv_dtype,
                prefix_cache=on, record_conv=kconv and on)
            if name == "bf16":
                r["profile"] = _profile_decode(eng, cfg,
                                               np.random.default_rng(1))
            if name == "bf16" and on:
                r["second_turn"] = _second_turn(cfg, params, eng, prompts[0],
                                                r["streams"][0], n)
            if convs:
                r["rings"] = _ring_loads_equal(steps, convs,
                                               _moba_layers(cfg),
                                               eng.page_size)
            runs["on" if on else "off"] = r
            del eng, steps, convs
            gc.collect()
            torch.cuda.empty_cache()
        off, on = runs["off"], runs["on"]
        want = expected_prefix_stats(prompts, 128, 2,
                                     full_only=kv_dtype != "fp32" or kconv)
        got = {k: on[k] for k in want}
        case = {"arch": cfg.name, "kv_dtype": kv_dtype,
                "shared_prefix": {"aligned": PREFIX_SHARED,
                                  "cow": PREFIX_SHARED
                                  + PREFIX_COW_EXTRA}[tname],
                "prompt_lens": [len(p) for p in prompts],
                "expected": want, "got": got,
                "streams_vs_no_cache": _parted(cfg, params, prompts,
                                               off["streams"],
                                               on["streams"]),
                **{f"{w}_{k}": runs[w][k] for w in ("off", "on") for k in (
                    "prefill_tokens", "prefill_s", "decode_step_ms",
                    "wall_s", "decode_calls", "kernel_launches",
                    "decode_steps", "requests_done", "preemptions")},
                **{k: on[k] for k in ("rings", "second_turn") if k in on}}
        if name == "bf16":
            case["profile"] = {w: {k: runs[w]["profile"][k] for k in (
                "step_ms", "device_busy_ms_per_step", "device_idle_share",
                "launch_calls_per_step", "kernels_per_step")}
                for w in ("off", "on")}
        rec[name] = case
        counts[name] = (on["decode_calls"], on["kernel_launches"])
        ml = _moba_layers(cfg)
        for w, r in runs.items():
            if r["requests_done"] != len(prompts):
                bad.append(f"{name}/{w}: a request did not finish")
            if r["decode_calls"] != ml * r["decode_steps"] \
                    or r["kernel_launches"] != 3 * r["decode_calls"]:
                bad.append(f"{name}/{w}: {r['decode_calls']} decode calls, "
                           f"{r['kernel_launches']} kernels for "
                           f"{r['decode_steps']} steps")
        if got != want:
            bad.append(f"{name}: prefix counts {got} != expected {want}")
        if not case["streams_vs_no_cache"]["ok"]:
            bad.append(f"{name}: a stream parted from the no-cache "
                       f"engine's off a near-tie")
        if kv_dtype != "fp32" and (on["cow_copies"]
                                   or on["prefix_hit_tokens"] % 128):
            bad.append(f"{name}: a quantized pool shared a partial page")
        if "rings" in case and not (
                case["rings"]["rings_equal_publisher_raw_keys"]
                and case["rings"]["hit_rows"] == want["prefix_hits"]):
            bad.append(f"{name}: a ring loaded from the tails is not the "
                       f"publisher's raw keys")
        if "second_turn" in case and not case["second_turn"]["ok"]:
            bad.append(f"{name}: the second turn missed its hit, parted "
                       f"from a fresh engine off a near-tie, or its suffix "
                       f"logits are not the fresh engine's")
        if name == "bf16" and (
                case["profile"]["on"]["launch_calls_per_step"]
                != case["profile"]["off"]["launch_calls_per_step"]):
            bad.append("bf16: a decode step's launch calls differ with "
                       "the prefix cache on")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    rec["ok"] = not bad
    rec["failures"] = bad
    emit(rec)
    if bad:
        raise SystemExit("serve_prefix: " + "; ".join(bad))
    return counts, rec


# the second turn's suffix logits, cached engine against a fresh one:
# ||a - b|| / ||b|| over every logit of the suffix.  bf16 rounding moves
# it by about 1e-2; K/V from a wrong page moves every suffix position
# (all of them attend the COW-copied page, their own block) by O(1).
SECOND_TURN_REL_TOL = 5e-2


def _prefill_logits(m: int):
    """Patch ``T.prefill`` to keep, for each call, the fp32 logits of its
    row 0 at that row's last ``m`` valid positions.  Returns (the list
    they go into, the undo)."""
    from repro_torch.models import transformer as T
    prefill, got = T.prefill, []

    def rec(*a, **kw):
        logits, caches = prefill(*a, **kw)
        q = int(kw["page_state"]["q_len"][0])
        got.append(logits[0, max(q - m, 0):q].float().clone())
        return logits, caches

    T.prefill = rec

    def undo():
        T.prefill = prefill
    return got, undo


def _second_turn(cfg, params, eng, prompt, out, n: int) -> dict:
    """Turn 2 on ``eng`` (whose tree holds turn 1): turn 1's prompt, its
    output and 64 new tokens.  Turn 1's cache (its prompt and all but its
    last token, the partial tail page included at finish) must be the
    hit; the stream is held against a fresh engine's, teacher-forced, and
    so are the logits of every position the cached engine prefills on top
    of the hit (:data:`SECOND_TURN_REL_TOL`; the one-shot ``lm_apply``'s
    distance from the fresh engine is reported beside it)."""
    import torch
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(2)
    turn2 = np.concatenate([prompt, np.asarray(out, np.int32),
                            rng.integers(0, cfg.vocab_size, 64,
                                         dtype=np.int32)])
    want_hit = len(prompt) + n - 1
    m = len(turn2) - want_hit                    # the suffix prefilled
    before = {k: eng.stats[k] for k in ("prefix_hit_tokens", "cow_copies")}
    got, undo = _prefill_logits(m)
    try:
        req = eng.submit(turn2, max_new_tokens=n)
        eng.run()
        fresh, feng, _, _ = _prefix_serve(cfg, params, [turn2], n)
    finally:
        undo()
    del feng
    gc.collect()
    hit = eng.stats["prefix_hit_tokens"] - before["prefix_hit_tokens"]
    vs = _parted(cfg, params, [turn2], fresh["streams"], [list(req.out)])
    cached, ref = got[0], got[-1]
    with torch.no_grad():
        one, _, _ = T.lm_apply(params, torch.as_tensor(turn2, device="cuda")
                               [None], cfg, backend="flash")
    one = one[0, -m:].float()

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    logits = {"positions": m, "rel_err": rel(cached, ref),
              "max_abs_err": float((cached - ref).abs().max()),
              "max_abs_logit": float(ref.abs().max()),
              "argmax_equal": int((cached.argmax(-1)
                                   == ref.argmax(-1)).sum()),
              "one_shot_rel_err": rel(one, ref),
              "tol": SECOND_TURN_REL_TOL}
    logits["ok"] = (len(got) == 2 and cached.shape == ref.shape
                    and logits["rel_err"] <= SECOND_TURN_REL_TOL)
    return {"prompt_len": len(turn2), "hit_tokens": hit,
            "expected_hit_tokens": want_hit,
            "cow_copies": eng.stats["cow_copies"] - before["cow_copies"],
            "vs_fresh": vs, "suffix_logits": logits,
            "ok": hit == want_hit and vs["ok"] and logits["ok"]}


# ------------------------------------------------------------------ phase 5
# ---------------------------------------- the serve CLI's remaining modes
FIXED_CASE = dict(batch=8, prompt_len=2048, gen=64)
FIXED_FP32_CASE = dict(batch=2, prompt_len=2048, gen=8)
# the stream / open-loop scenarios: 16 requests of 1024..4095 prompt
# tokens and 16..64 new tokens on 8 slots (numpy's upper bounds exclusive)
STREAM_CASE = dict(n_requests=16, prompt_range=(1024, 4096),
                   gen_range=(16, 65), max_seqs=8)
STREAM_RATE = 4.0                  # req/s, Poisson (seeded)
OPENLOOP_EVERY = 4                 # one arrival every 4 decode steps
HTTP_CLIENTS, HTTP_NEW_TOKENS = 3, 32
# the bf16 fixed loop: FlashMoBA's output in its prefill against the fp32
# reference on the same inputs and selections (largest error over the
# largest |reference|), and its teacher-forced logits against a one-shot
# lm_apply (per-position relative L2 error: the largest, and the median
# over that of two one-shot paths)
FIXED_BF16_OUT_TOL = 1e-2
FIXED_TF_REL_TOL = 1e-1
FIXED_TF_MEDIAN_RATIO = 1.5


def _capture_engines():
    """Patch ``launch/serve.py::_make_engine`` to keep every engine the
    entry points build (they return metrics or tokens, not requests).
    Returns the list and the undo."""
    from repro_torch.launch import serve as TS
    made, make = [], TS._make_engine

    def keep(*a, **kw):
        made.append(make(*a, **kw))
        return made[-1]

    TS._make_engine = keep

    def undo():
        TS._make_engine = make
    return made, undo


def _timed_steps(times: list, counts: list):
    """Patch ``launch/steps.py``'s dense-cache step builders so each step
    call is timed between two syncs, with the port kernels it launched
    (:func:`_counts` and the decode kernels' calls, read around it).
    Returns the undo."""
    import torch
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.launch import steps as S
    builders = S.make_prefill_step, S.make_decode_step

    def wrap(builder):
        def build(*a, **kw):
            fn = builder(*a, **kw)

            def call(*args, **kw):
                torch.cuda.synchronize()
                c0, d0 = _counts(), MD.LAUNCHES
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                c1 = _counts()
                counts.append({**{k: c1[k] - c0[k] for k in c1},
                               "moba_paged_decode": MD.LAUNCHES - d0})
                return out
            return call
        return build

    S.make_prefill_step, S.make_decode_step = map(wrap, builders)

    def undo():
        S.make_prefill_step, S.make_decode_step = builders
    return undo


def _finished_streams(eng):
    """(prompts, streams, max_new_tokens) of an engine's finished
    requests, in submission order."""
    reqs = sorted(eng.finished, key=lambda r: r.rid)
    return ([r.prompt for r in reqs], [list(r.out) for r in reqs],
            [r.max_new_tokens for r in reqs])


def _decode_gate(what: str, calls: int, kernels: int, steps: int,
                 moba_layers: int) -> list:
    if calls == 0 or calls != moba_layers * steps or kernels != 3 * calls:
        return [f"{what}: {calls} decode calls and {kernels} kernels for "
                f"{steps} decode steps, expected {moba_layers} and "
                f"{3 * moba_layers} a step"]
    return []


def _replay_selection(recorded: list, audit: list, plain_selection,
                      compare=None, own: bool = False):
    """A stand-in for ``core/moba.py::moba_selection`` that returns the
    next of ``recorded``'s selections (B·H, Nq_p, k), or with ``own`` the
    plain routing of its own q and k, first holding the one to the other
    by ``compare(masked scores, recorded, plain)`` (:func:`_near_ties` by
    default), whose result ``audit`` gets."""
    compare = compare or _near_ties
    from repro_torch.core import routing
    from repro_torch.kernels import ref

    def replay(q, k, moba_cfg, q_positions=None, head_top_k=None):
        assert head_top_k is None
        b, h, nq, d = q.shape
        hkv, n = k.shape[1], k.shape[2]
        sel = recorded[len(audit)][:, :nq]
        mine = plain_selection(q, k, moba_cfg, q_positions)
        kv = ref.kv_rows(b * h, h, h // hkv, q.device)
        cents = routing.block_centroids(k, moba_cfg.block_size)
        masked = _masked_scores(q.reshape(b * h, nq, d),
                                cents.reshape(b * hkv, -1, d)[kv], n,
                                moba_cfg.block_size)
        audit.append(compare(masked, sel, mine.reshape(b * h, nq, -1)))
        return mine if own else sel.reshape(b, h, nq, -1)
    return replay


def _flash_then_xla(run) -> dict:
    """``run(backend)`` under ``flash``, recording each Flash TopK
    selection and each dense-cache decode route it makes, then under
    ``xla``, replaying them in the same order; each replayed selection is
    held to the xla run's own routing of its q and k by the near-tie rule
    (Flash TopK's and the plain decode route's inputs differ in the last
    bits between the runs).  Returns each run's output, the audits
    ((rows differing, largest gap, ok) per replay), what was recorded
    (``rec_sel``, ``rec_route``) and its counts."""
    import torch
    from repro_torch.core import moba as CM
    from repro_torch.kernels import ops

    flash_topk, plain_selection = ops.flash_topk, CM.moba_selection
    decode_route = CM.moba_decode_route
    rec_sel, rec_route, audit, route_audit = [], [], [], []

    def record_topk(*args, **kw):
        rec_sel.append(flash_topk(*args, **kw))
        return rec_sel[-1]

    def record_route(*args, **kw):
        rec_route.append(decode_route(*args, **kw))
        return rec_route[-1]

    def replay_route(q, k_cache, kv_len, mcfg, centroids=None):
        idx, valid = rec_route[len(route_audit)]
        own_idx, own_valid = decode_route(q, k_cache, kv_len, mcfg,
                                          centroids)
        nb = -(-k_cache.shape[2] // mcfg.block_size)
        masked = CM.moba_decode_scores(q, k_cache, kv_len, mcfg,
                                       centroids).reshape(-1, 1, nb)
        masked = torch.cat([masked, torch.full_like(masked[..., :1],
                                                    CM.NEG_INF)], -1)
        k = idx.shape[-1]
        route_audit.append(_near_ties(
            masked, torch.where(valid, idx, nb).reshape(-1, 1, k),
            torch.where(own_valid, own_idx, nb).reshape(-1, 1, k)))
        return idx, valid

    out = {}
    try:
        ops.flash_topk, CM.moba_decode_route = record_topk, record_route
        out["flash"] = run("flash")
        ops.flash_topk = flash_topk
        CM.moba_selection = _replay_selection(rec_sel, audit,
                                              plain_selection)
        CM.moba_decode_route = replay_route
        out["xla"] = run("xla")
    finally:
        ops.flash_topk, CM.moba_selection = flash_topk, plain_selection
        CM.moba_decode_route = decode_route
    torch.cuda.synchronize()
    out.update(audit=audit, route_audit=route_audit, rec_sel=rec_sel,
               rec_route=rec_route, selections=len(rec_sel),
               routes=len(rec_route))
    return out


def _routing_record(runs: dict) -> dict:
    """What :func:`_flash_then_xla`'s audits found: every recorded
    selection replayed, each differing only on a near-tie."""
    audit, route_audit = runs["audit"], runs["route_audit"]
    return {"prefill_routing_rows_differing_per_layer":
            [r for r, _, _ in audit],
            "decode_routing_rows_differing":
                sum(r for r, _, _ in route_audit),
            "routing_max_gap": max((g for _, g, _ in audit + route_audit),
                                   default=0.0),
            "routing_near_ties_ok": (
                len(audit) == runs["selections"]
                and len(route_audit) == runs["routes"]
                and all(ok for _, _, ok in audit + route_audit))}


def _fixed_flash_vs_xla() -> dict:
    """The fixed loop in fp32 (TF32 off) at full width, batch 2, a
    2,048-token prompt, 8 new tokens: ``flash`` then ``xla`` from the
    entry points' seed-0 weights and prompts.  The prefill's last logits
    and each decode step's logits within 2e-3, greedy tokens equal.  The
    xla run replays the flash run's selections (:func:`_flash_then_xla`):
    Flash TopK's in the prefill, and the dense-cache decode route's (the
    same plain function on both backends, whose inputs differ in the last
    bits).  Then the paged engine on ``flash``, built as ``serve()``
    builds it, on the same prompts: its streams equal the flash fixed
    loop's up to the first teacher-forced top-2 gap <= :data:`GAP_TOL`."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = FIXED_FP32_CASE
    cfg = dataclasses.replace(get_config("moba-340m"), dtype="float32")
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    host_prompts = list(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (c["batch"], c["prompt_len"])).astype(np.int32))
    prompts = torch.as_tensor(np.stack(host_prompts), device="cuda")

    def run(backend):
        caches = T.init_caches(cfg, c["batch"], c["prompt_len"] + c["gen"],
                               dtype=torch.float32, device="cuda")
        with torch.no_grad():
            lg, caches = T.prefill(params, prompts, cfg, caches,
                                   backend=backend)
            logits = [lg[:, -1]]
            for _ in range(c["gen"] - 1):
                tok = logits[-1].argmax(-1)[:, None].to(torch.int32)
                lg, caches = T.decode_step(params, tok, cfg, caches,
                                           backend=backend)
                logits.append(lg[:, -1])
        return torch.stack(logits, 1)                        # (B, gen, V)

    runs = _flash_then_xla(run)
    fl, xl = runs["flash"], runs["xla"]
    ml = _moba_layers(cfg)
    diffs = (fl - xl).abs().amax(dim=(0, 2)).tolist()
    close = bool(torch.allclose(fl, xl, atol=2e-3, rtol=2e-3))
    same = bool(torch.equal(fl.argmax(-1), xl.argmax(-1)))
    routing = _routing_record(runs)
    routing_ok = (routing["routing_near_ties_ok"]
                  and runs["selections"] == ml
                  and runs["routes"] == ml * (c["gen"] - 1))
    finite = bool(torch.isfinite(fl).all())
    fixed_streams = fl.argmax(-1).tolist()
    del runs, fl, xl
    eng = Engine(cfg, params, EngineConfig(
        max_seqs=c["batch"], max_prefill_batch=c["batch"],
        max_seq_len=-(-(c["prompt_len"] + c["gen"]) // 16) * 16,
        attn_backend="flash"), device="cuda")
    reqs = [eng.submit(p, max_new_tokens=c["gen"]) for p in host_prompts]
    eng.run()
    engine_streams = [list(r.out) for r in reqs]
    del eng, reqs
    gc.collect()
    vs_engine = _parted(cfg, params, host_prompts, engine_streams,
                        fixed_streams, tol=GAP_TOL)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"dtype": "float32", **c, "tol": 2e-3,
            "max_abs_diff_prefill": diffs[0],
            "max_abs_diff_decode_steps": diffs[1:],
            "allclose": close, "greedy_equal": same, "finite": finite,
            **routing, "routing_near_ties_ok": routing_ok,
            "streams_vs_engine": vs_engine,
            "ok": close and same and finite and routing_ok
            and vs_engine["ok"]}


def _record_flash_moba(at=(0,)):
    """Patch ``kernels/ops.py`` so that the FlashMoBA forwards numbered
    ``at`` (0: the first, layer 0 of a prefill) keep copies of their
    inputs and of what their centroids kernel, Flash TopK and the whole
    forward returned (each forward calls each kernel once, so the n-th
    calls belong together).  Returns (a dict of one such dict per number,
    the undo)."""
    from repro_torch.kernels import ops
    fm, bc, ft = ops.flash_moba, ops.block_centroids_kernel, ops.flash_topk
    kept, seen = {i: {} for i in at}, {"out": 0, "cents": 0, "sel": 0}

    def mine(key):
        i = seen[key]
        seen[key] += 1
        return kept.get(i)

    def moba(q, k, v, mcfg, **kw):
        out = fm(q, k, v, mcfg, **kw)
        rec = mine("out")
        if rec is not None:
            rec.update(q=q.detach().clone(), k=k.detach().clone(),
                       v=v.detach().clone(), cfg=mcfg,
                       scale=kw.get("scale"), out=out.detach().clone())
        return out

    def cents(*a, **kw):
        out = bc(*a, **kw)
        rec = mine("cents")
        if rec is not None:
            rec["cents"] = out.clone()
        return out

    def topk(*a, **kw):
        out = ft(*a, **kw)
        rec = mine("sel")
        if rec is not None:
            rec["sel"] = out.clone()
        return out

    ops.flash_moba, ops.block_centroids_kernel, ops.flash_topk = \
        moba, cents, topk

    def undo():
        ops.flash_moba, ops.block_centroids_kernel, ops.flash_topk = \
            fm, bc, ft
    return kept, undo


def _check_forward_kernels(kept: dict) -> dict:
    """The three kernels of one bf16 FlashMoBA forward of a model, each on
    the inputs it got there (:func:`_record_flash_moba`): the
    centroids against ``ref.centroids_ref`` (both bf16, 1e-2 as phase 6);
    Flash TopK's selection against ``ref.flash_topk_ref`` on the same q
    and centroids by the near-tie rule; the forward's output against
    ``moba_attention_reference`` in fp32 on the same q, k, v and
    selections, within :data:`FIXED_BF16_OUT_TOL` of its largest |value|.
    Beside it, the same reference with one block fewer (top_k - 1): the
    distance of the smallest routing fault, which the tolerance must
    stay below."""
    import torch
    from repro_torch.core import moba as CM
    from repro_torch.kernels import ops, ref
    if set(kept) != {"q", "k", "v", "cfg", "scale", "out", "cents", "sel"}:
        return {"kept": sorted(kept), "ok": False}
    q, k, v, mcfg = kept["q"], kept["k"], kept["v"], kept["cfg"]
    b, h, nq, d = q.shape
    hkv, n = k.shape[1], k.shape[2]
    bs, top_k, g = mcfg.block_size, mcfg.top_k, h // hkv
    rec = {"shape": {"B": b, "H": h, "Hkv": hkv, "Nq": nq, "N": n, "d": d,
                     "block_size": bs, "top_k": top_k},
           "dtype": str(q.dtype).replace("torch.", "")}
    want_c = ref.centroids_ref(k.reshape(b * hkv, n, d), bs)
    got_c = kept["cents"]
    rec["block_centroids"] = {
        "max_abs_err": float((got_c.float() - want_c.float()).abs().max()),
        "tol": 1e-2, "ok": got_c.shape == want_c.shape and bool(
            torch.allclose(got_c.float(), want_c.float(), atol=1e-2,
                           rtol=1e-2))}
    qf = ops.padded_queries(q, min(128, nq))
    sel = kept["sel"]
    want_s = ref.flash_topk_ref(qf, got_c, top_k, bs, group=g,
                                num_q_heads=h, q_pos_offset=n - nq)
    rows, gap, ties_ok = _topk_near_ties(
        dict(qf=qf, cents=got_c, sel=want_s, h=h, g=g, n=n, nq=nq, bs=bs),
        sel)
    rec["flash_topk"] = {"rows_differing": rows, "rows": b * h * nq,
                         "max_gap": gap, "ok": ties_ok}
    plain = CM.moba_selection
    mine = sel[:, :nq].reshape(b, h, nq, top_k)
    CM.moba_selection = lambda *a, **kw: mine
    try:
        with torch.no_grad():
            want = CM.moba_attention_reference(q.float(), k.float(),
                                               v.float(), mcfg,
                                               scale=kept["scale"])
    finally:
        CM.moba_selection = plain
    with torch.no_grad():
        short = CM.moba_attention_reference(
            q.float(), k.float(), v.float(),
            dataclasses.replace(mcfg, top_k=top_k - 1), scale=kept["scale"])
    big = float(want.abs().max())
    err = float((kept["out"].float() - want).abs().max())
    fault = float((short - want).abs().max())
    rec["moba_fwd"] = {"max_abs_err": err, "max_abs_ref": big,
                       "rel_err": err / big, "tol": FIXED_BF16_OUT_TOL,
                       "one_block_short_rel": fault / big,
                       "ok": kept["out"].shape == want.shape
                       and err <= FIXED_BF16_OUT_TOL * big
                       and fault > FIXED_BF16_OUT_TOL * big}
    del want, short
    rec["ok"] = all(rec[x]["ok"] for x in ("block_centroids", "flash_topk",
                                           "moba_fwd"))
    return rec


def _memory(cfg, params, extras: dict, backend: str):
    """The cross-attention memory of the stub inputs ``extras``, as a
    step computes it (``launch/steps.py::_cross_kv``)."""
    from repro_torch.launch import steps as S
    return S._cross_kv(params, cfg, backend, extras.get("cross_kv"),
                       extras.get("src_embeds"))


def _fixed_teacher_forced(cfg, params, prompts, streams,
                          extras=None) -> dict:
    """The engine's ``streams`` teacher-forced through the fixed loop's
    bf16 path: one dense-cache prefill and a plain decode step per token
    on ``flash``, as ``serve_fixed`` runs them.  Each position's logits
    are held against a one-shot ``lm_apply`` on ``flash`` over the prompt
    and the stream by their relative L2 error: the largest within
    :data:`FIXED_TF_REL_TOL`, the median within
    :data:`FIXED_TF_MEDIAN_RATIO` times that of ``lm_apply`` on
    ``reference`` against ``flash`` (the spread of two one-shot paths,
    measured here).  The same loop with each decode step's MoBA one
    block short (top_k - 1) must fail that median bound: the gate's
    power, measured in the same run.  Where the fixed loop's argmax is
    not the engine's token, the logit gap between the two is
    reported.  ``extras``: the stub inputs of the vision and
    encoder-decoder families (:func:`_memory`), the same in every
    step."""
    import torch
    from repro_torch.core import backends as B
    from repro_torch.models import transformer as T
    extras = extras or {}
    b, p, gen = len(prompts), len(prompts[0]), len(streams[0])
    toks = torch.as_tensor(np.asarray(streams, np.int32), device="cuda")
    pt = torch.as_tensor(np.stack(prompts), device="cuda")

    def fixed_loop():
        caches = T.init_caches(cfg, b, p + gen,
                               dtype=getattr(torch, cfg.dtype),
                               device="cuda")
        with torch.no_grad():
            mem = _memory(cfg, params, extras, "flash")
            lg, caches = T.prefill(params, pt, cfg, caches, backend="flash",
                                   cross_kv=mem)
            out = [lg[:, -1].float()]
            for j in range(gen - 1):
                lg, caches = T.decode_step(params, toks[:, j:j + 1], cfg,
                                           caches, backend="flash",
                                           cross_kv=mem)
                out.append(lg[:, -1].float())
        return torch.stack(out, 1)                           # (B, gen, V)

    fixed = fixed_loop()
    decode = B.moba_decode_attention
    B.moba_decode_attention = lambda q, k, v, kv_len, mcfg, **kw: decode(
        q, k, v, kv_len, dataclasses.replace(mcfg, top_k=mcfg.top_k - 1),
        **kw)
    try:
        short = fixed_loop()
    finally:
        B.moba_decode_attention = decode
    seq = torch.cat([pt, toks[:, :-1]], 1)
    one = {}
    for backend in ("flash", "reference"):
        with torch.no_grad():
            lg, _, _ = T.lm_apply(params, seq, cfg, backend=backend,
                                  cross_kv=_memory(cfg, params, extras,
                                                   backend))
        one[backend] = lg[:, p - 1:].float()
        del lg
        gc.collect()
        torch.cuda.empty_cache()

    def rel(a, ref_):
        return ((a - ref_).norm(dim=-1) / ref_.norm(dim=-1)).flatten()
    r_fixed, r_short = rel(fixed, one["flash"]), rel(short, one["flash"])
    r_one = rel(one["reference"], one["flash"])
    median_tol = FIXED_TF_MEDIAN_RATIO * float(r_one.median())
    off = fixed.argmax(-1) != toks
    lost = (fixed.amax(-1) - fixed.gather(-1, toks.long()[..., None])[..., 0])
    rec = {"positions": int(r_fixed.numel()), "tol": FIXED_TF_REL_TOL,
           "median_tol": median_tol,
           "rel_err_max": float(r_fixed.max()),
           "rel_err_median": float(r_fixed.median()),
           "vs_reference_rel_err_max":
               float(rel(fixed, one["reference"]).max()),
           "one_shot_reference_vs_flash_rel_err_max": float(r_one.max()),
           "one_shot_reference_vs_flash_rel_err_median":
               float(r_one.median()),
           "decode_one_block_short_rel_err_max": float(r_short.max()),
           "decode_one_block_short_rel_err_median":
               float(r_short.median()),
           "argmax_equal_engine_tokens": int((~off).sum()),
           "max_logit_gap_where_not": float(lost[off].max())
           if bool(off.any()) else 0.0,
           "finite": bool(torch.isfinite(fixed).all())}
    rec["ok"] = (rec["finite"] and rec["rel_err_max"] <= FIXED_TF_REL_TOL
                 and rec["rel_err_median"] <= median_tol
                 and rec["decode_one_block_short_rel_err_median"]
                 > median_tol)
    return rec


def phase_serve_fixed():
    """``serve_fixed`` on moba-340m at full width (bf16, seed-0 weights)
    on ``flash``: batch 8, one 2,048-token prompt length (``default_rng
    (0)``), 64 new tokens, through the entry point.  Each step call is
    timed between syncs with the port kernels it launched: the prefill
    must launch 12 each of centroids, Flash TopK and ``moba_fwd`` (and
    no backward or decode kernel), each decode step none; layer 0's
    three kernels are held against their plain versions on the inputs
    the prefill gave them (:func:`_check_forward_kernels`).  Then
    ``serve()`` on the same prompts and weights (the paged engine), whose
    streams are teacher-forced through the fixed loop's bf16 prefill and
    decode steps and held against ``lm_apply``
    (:func:`_fixed_teacher_forced`: greedy streams of two paths that
    round differently in bf16 part at near-ties, so the logits are
    gated, not the tokens).  Then :func:`_fixed_flash_vs_xla` in fp32,
    which holds the fixed loop to the engine token for token.  Returns
    the prefill's kernel counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.launch import serve as TS
    from repro_torch.models import transformer as T

    cfg = get_config("moba-340m")
    ml = _moba_layers(cfg)
    kw = dict(smoke=False, attn_backend="flash", device="cuda", **FIXED_CASE)
    times, counts, bad = [], [], []
    undo = _timed_steps(times, counts)
    kept, unrecord = _record_flash_moba()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        fixed = TS.serve_fixed("moba-340m", **kw)
    finally:
        unrecord()
        undo()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    prefill_counts, decode_counts = counts[0], counts[1:]
    want = {"block_centroids": ml, "flash_topk": ml, "moba_fwd": ml,
            "moba_bwd": 0, "swa": 0, "swa_bwd": 0, "moba_paged_decode": 0}
    if prefill_counts != want:
        bad.append(f"prefill launched {prefill_counts}, expected {want}")
    if any(any(d.values()) for d in decode_counts):
        bad.append("a decode step launched a port kernel")
    b, g = FIXED_CASE["batch"], FIXED_CASE["gen"]
    dec_s = sum(times[1:])
    rec = {"phase": "serve_fixed", "arch": cfg.name, "dtype": cfg.dtype,
           "backend": "flash", **FIXED_CASE, "wall_s": wall,
           "prefill_s": times[0], "decode_steps": len(times) - 1,
           "decode_tok_s": b * (len(times) - 1) / dec_s,
           "decode_step_ms": dec_s / (len(times) - 1) * 1e3,
           "decode_step_ms_median": float(np.median(times[1:])) * 1e3,
           "peak_mem_gib": peak, "prefill_launches": prefill_counts,
           "decode_step_launches": {k: sum(d[k] for d in decode_counts)
                                    for k in want}}
    ok_shape = fixed.shape == (b, g) and fixed.dtype == np.int32 \
        and bool(((fixed >= 0) & (fixed < cfg.vocab_size)).all())
    if not ok_shape:
        bad.append(f"tokens of shape {fixed.shape} {fixed.dtype}")
    rec["prefill_kernels"] = _check_forward_kernels(kept[0])
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    if not rec["prefill_kernels"]["ok"]:
        bad.append("a prefill kernel disagrees with its plain version "
                   "at the bf16 fixed-loop shape")

    made, undo = _capture_engines()
    MD.LAUNCHES = MD.KERNEL_LAUNCHES = 0
    try:
        engine = TS.serve("moba-340m", **kw)
    finally:
        undo()
    eng = made[0]
    st = dict(eng.stats)
    rec["engine"] = {"prefill_s": st["prefill_s"],
                     "decode_tok_s": st["decode_tokens"] / st["decode_s"],
                     "decode_step_ms": st["decode_s"] / st["decode_steps"]
                     * 1e3, "decode_steps": st["decode_steps"],
                     "decode_calls": MD.LAUNCHES,
                     "kernel_launches": MD.KERNEL_LAUNCHES}
    bad += _decode_gate("serve_fixed's engine run", MD.LAUNCHES,
                        MD.KERNEL_LAUNCHES, st["decode_steps"], ml)
    del eng, made
    gc.collect()
    torch.cuda.empty_cache()
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    prompts = list(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, FIXED_CASE["prompt_len"])).astype(np.int32))
    rec["streams_equal_engine_bf16"] = sum(
        list(a) == list(e) for a, e in zip(fixed.tolist(), engine.tolist()))
    rec["teacher_forced_vs_lm_apply"] = _fixed_teacher_forced(
        cfg, params, prompts, engine.tolist())
    if not rec["teacher_forced_vs_lm_apply"]["ok"]:
        bad.append("bf16: the fixed loop's teacher-forced logits are not "
                   "within tolerance of lm_apply's")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rec["fp32_flash_vs_xla"] = _fixed_flash_vs_xla()
    if not rec["fp32_flash_vs_xla"]["ok"]:
        bad.append("fp32: flash and xla fixed loops disagree, or a routing "
                   "difference is no near-tie")
    rec["ok"], rec["failures"] = not bad, bad
    emit(rec)
    if bad:
        raise SystemExit("serve_fixed: " + "; ".join(bad))
    return prefill_counts


def phase_serve_stream():
    """``serve_stream`` at full width (bf16, seed-0 weights) on ``flash``:
    :data:`STREAM_CASE` with Poisson arrivals at :data:`STREAM_RATE`
    req/s (seeded), ``realtime=True``; every metric it returns.  Gates:
    every request finishes with its count, 12 decode calls and 36
    kernels a step (counts zeroed just before, read just after), and the
    streams equal a ``dispatch_ahead=0`` batch run of the same prompts
    (an ``Engine`` built as the entry point builds it) up to the first
    teacher-forced top-2 gap <= 1e-2.  Returns the decode counts."""
    import torch
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.launch import serve as TS
    from repro_torch.serving.engine import Engine

    made, undo = _capture_engines()
    MD.LAUNCHES = MD.KERNEL_LAUNCHES = 0
    try:
        m = TS.serve_stream("moba-340m", rate=STREAM_RATE, smoke=False,
                            attn_backend="flash", realtime=True,
                            device="cuda", **STREAM_CASE)
    finally:
        undo()
    calls, kernels = MD.LAUNCHES, MD.KERNEL_LAUNCHES
    eng = made[0]
    cfg, params = eng.cfg, eng.params
    prompts, streams, news = _finished_streams(eng)
    bad = _decode_gate("serve_stream", calls, kernels, m["decode_steps"],
                       _moba_layers(cfg))
    if len(streams) != STREAM_CASE["n_requests"] or any(
            len(s) != n for s, n in zip(streams, news)):
        bad.append("a request did not finish with its count")
    base = Engine(cfg, params, dataclasses.replace(eng.ecfg,
                                                   dispatch_ahead=0),
                  device="cuda")
    del eng, made
    gc.collect()
    reqs = [base.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    base.run()
    want = [list(r.out) for r in reqs]
    del base, reqs
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"phase": "serve_stream", "arch": cfg.name, "dtype": cfg.dtype,
           "backend": "flash", "rate": STREAM_RATE, **STREAM_CASE,
           "realtime": True, **m, "decode_calls": calls,
           "kernel_launches": kernels,
           "prompt_lens": [len(p) for p in prompts], "new_tokens": news,
           "streams_vs_batch": _parted(cfg, params, prompts, want,
                                       streams)}
    if not rec["streams_vs_batch"]["ok"]:
        bad.append("a stream parted from the batch run's off a near-tie")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rec["ok"], rec["failures"] = not bad, bad
    emit(rec)
    if bad:
        raise SystemExit("serve_stream: " + "; ".join(bad))
    return calls, kernels


def phase_serve_openloop():
    """``serve_openloop`` at full width (bf16, seed-0 weights) on
    ``flash``: :data:`STREAM_CASE`'s ranges (its own seeded draws), one
    arrival every :data:`OPENLOOP_EVERY` decode steps, ``dispatch_ahead``
    1 then 0: sustained tokens/s, TTFT and TPOT p50/p99, the pipeline
    depth peak.  Gates: 12 decode calls and 36 kernels a step in each
    run, every request finishes with its count, and the two runs'
    streams equal up to the first teacher-forced top-2 gap <= 1e-2.
    Returns the decode counts by run."""
    import torch
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.launch import serve as TS
    from repro_torch.models import transformer as T

    rec, out, bad, counts = {"phase": "serve_openloop"}, {}, [], {}
    for da in (1, 0):
        made, undo = _capture_engines()
        MD.LAUNCHES = MD.KERNEL_LAUNCHES = 0
        try:
            m = TS.serve_openloop("moba-340m", every=OPENLOOP_EVERY,
                                  smoke=False, attn_backend="flash",
                                  dispatch_ahead=da, device="cuda",
                                  **STREAM_CASE)
        finally:
            undo()
        key = f"dispatch_ahead_{da}"
        counts[f"serve_openloop_da{da}"] = (MD.LAUNCHES, MD.KERNEL_LAUNCHES)
        eng = made[0]
        cfg = eng.cfg
        prompts, streams, news = _finished_streams(eng)
        out[da] = streams
        bad += _decode_gate(f"serve_openloop ({key})", MD.LAUNCHES,
                            MD.KERNEL_LAUNCHES, m["decode_steps"],
                            _moba_layers(cfg))
        if len(streams) != STREAM_CASE["n_requests"] or any(
                len(s) != n for s, n in zip(streams, news)):
            bad.append(f"{key}: a request did not finish with its count")
        rec[key] = {**m, "decode_calls": MD.LAUNCHES,
                    "kernel_launches": MD.KERNEL_LAUNCHES}
        del eng, made
        gc.collect()
        torch.cuda.empty_cache()
    rec.update({"arch": cfg.name, "dtype": cfg.dtype, "backend": "flash",
                "every": OPENLOOP_EVERY, **STREAM_CASE,
                "prompt_lens": [len(p) for p in prompts],
                "new_tokens": news})
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    rec["streams_da1_vs_da0"] = _parted(cfg, params, prompts, out[0],
                                        out[1])
    if not rec["streams_da1_vs_da0"]["ok"]:
        bad.append("dispatch-ahead 1 and 0 streams parted off a near-tie")
    if rec["dispatch_ahead_1"]["dispatch_depth_peak"] < 1:
        bad.append("dispatch-ahead never held a step in flight")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rec["ok"], rec["failures"] = not bad, bad
    emit(rec)
    if bad:
        raise SystemExit("serve_openloop: " + "; ".join(bad))
    return counts


def _http(port: int, method: str, path: str, body=None) -> list:
    """One request to the local server (``Connection: close`` framing);
    returns the body's JSON lines."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body)
        return [json.loads(line) for line in
                conn.getresponse().read().splitlines()]
    finally:
        conn.close()


def phase_serve_http():
    """The port's serve CLI with ``--http`` in a subprocess (moba-340m at
    full width, bf16, ``flash``, 4 slots, 2,112 positions each) on a free
    local port: :data:`HTTP_CLIENTS` concurrent clients POST
    ``/generate`` with prompts of 1,024..2,048 tokens and 32 new tokens
    each, then one GETs ``/stats``; then SIGINT.  Gates: each stream's
    tokens equal its final record's ``tokens``, 32 of them; ``ttft_ms``
    in every final record; ``/stats`` shows decode steps; the server
    exits 0 on SIGINT."""
    import signal
    import socket
    import threading

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve",
         "--arch", "moba-340m", "--attn-backend", "flash",
         "--http", str(port), "--max-seqs", "4", "--max-seq-len", "2112"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    watchdog = threading.Timer(600, proc.kill)
    watchdog.start()
    rec, bad = {"phase": "serve_http", "port": port}, []
    try:
        line = proc.stdout.readline()
        rec["startup_s"] = time.perf_counter() - t0
        rec["banner"] = line.strip()
        if f"127.0.0.1:{port}" not in line:
            raise SystemExit(f"serve_http: the server did not start: "
                             f"{line!r}")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 32000, int(n), dtype=np.int32)
                   for n in rng.integers(1024, 2049, HTTP_CLIENTS)]
        records, walls = [None] * HTTP_CLIENTS, [0.0] * HTTP_CLIENTS

        def client(i):
            c0 = time.perf_counter()
            records[i] = _http(port, "POST", "/generate", json.dumps(
                {"prompt": prompts[i].tolist(),
                 "max_new_tokens": HTTP_NEW_TOKENS}))
            walls[i] = time.perf_counter() - c0

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(HTTP_CLIENTS)]
        c0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        rec["clients_wall_s"] = time.perf_counter() - c0
        if any(t.is_alive() for t in threads):
            raise SystemExit("serve_http: a client did not finish")
        stats = _http(port, "GET", "/stats")[0]
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = proc.stderr.read()
    clients = []
    for i, r in enumerate(records):
        if not r:
            bad.append(f"client {i}: no response")
            continue
        toks, final = [x.get("token") for x in r[:-1]], r[-1]
        ok = (final.get("done") and toks == final.get("tokens")
              and len(toks) == HTTP_NEW_TOKENS and "ttft_ms" in final)
        clients.append({"prompt_len": len(prompts[i]),
                        "tokens": len(toks), "ttft_ms": final.get("ttft_ms"),
                        "wall_s": walls[i], "ok": bool(ok)})
        if not ok:
            bad.append(f"client {i}: stream and final record disagree")
    rec.update({"clients": clients, "exit_code": rc,
                "stats": {k: stats.get(k) for k in (
                    "decode_steps", "decode_tokens", "prefill_tokens",
                    "prefill_s", "decode_s", "dispatch_depth_peak",
                    "preemptions")}})
    if not stats.get("decode_steps"):
        bad.append("/stats shows no decode step")
    if rc != 0:
        bad.append(f"SIGINT: exit code {rc}: {err[-2000:]}")
    rec["ok"], rec["failures"] = not bad, bad
    emit(rec)
    if bad:
        raise SystemExit("serve_http: " + "; ".join(bad))


# ------------------------------------------------------- sharded serving
SHARDS = 2                   # all on cuda:0: one card rehearses the fleet
SHARDED_NOTE = ("2 shards on one card (cuda:0): the logic and launch "
                "counts of 2 shards; no transfer between cards and no "
                "speed-up from more cards is measured")
SHARDED_GATE = dict(prompts=4, lens=(1024, 2048), new_tokens=16,
                    slots=2, max_seq_len=4096)
SHARDED_CP = dict(prompt_len=6144, new_tokens=16)   # > one shard's 4096
SHARDED_TIMING = dict(prompts=8, new_tokens=32, slots=4, max_seq_len=4224)


def _record_decode_call(eng, shard: int):
    """Patch ``kernels/moba_decode.py::moba_paged_decode`` so that the
    first call on shard ``shard``'s pools (told apart by their storage)
    keeps copies of its inputs and its output.  Returns (the record, the
    undo)."""
    from repro_torch.kernels import moba_decode as MD
    mine = {p["pages_k"].untyped_storage().data_ptr()
            for p in eng.caches[shard].values()}
    call, rec = MD.moba_paged_decode, {}

    def kept(q, pages_k, pages_v, centroids, block_table, kv_len, cfg,
             **kw):
        out = call(q, pages_k, pages_v, centroids, block_table, kv_len, cfg,
                   **kw)
        if not rec and pages_k.untyped_storage().data_ptr() in mine:
            pool = {"pages_k": pages_k.clone(), "pages_v": pages_v.clone(),
                    "centroids": centroids.clone()}
            for k in ("scales_k", "scales_v"):
                if kw.get(k) is not None:
                    pool[k] = kw[k].clone()
            rec.update(q=q.clone(), pool=pool, table=block_table.clone(),
                       kv=kv_len.clone(), cfg=cfg, out=out.clone(),
                       scale=kw.get("scale"))
        return out

    MD.moba_paged_decode = kept

    def undo():
        MD.moba_paged_decode = call
    return rec, undo


def _check_decode_call(rec: dict) -> dict:
    """The decode kernels on one recorded call's own tensors, as phase 2
    checks them: a relaunch returns the recorded output bit for bit; the
    route's selections against ``moba_paged_route`` (near-ties only);
    its tables against ``decode_tables``; the attention against
    ``moba_paged_attend`` on those selections (bf16 3e-2, fp32 1e-3)."""
    import torch
    from repro_torch.core.moba import moba_paged_attend, moba_paged_route
    from repro_torch.kernels import moba_decode as MD
    if not rec:
        return {"ok": False, "recorded": False}
    q, pool, table, kv, cfg = (rec[k] for k in ("q", "pool", "table", "kv",
                                                "cfg"))
    sc = _scales(pool)
    ps = pool["pages_k"].shape[1]
    out, rt = _decode_launch(q, pool, table, kv, cfg)
    idx, sel_valid = moba_paged_route(q, pool["centroids"], table, kv, cfg,
                                      page_size=ps)
    rows, gap, ties_ok = _route_near_ties(q, pool["centroids"], table, kv,
                                          ps, rt.sel, idx, sel_valid)
    k_idx, k_valid = _kernel_selection(rt, q, pool["centroids"])
    want = MD.decode_tables(q, pool["pages_k"], table, k_idx, k_valid)
    tables_equal = all(bool(torch.equal(a, b)) for a, b in
                       zip((rt.phys, rt.base, rt.n_uniq), want))
    plain = moba_paged_attend(q, pool["pages_k"], pool["pages_v"], table, kv,
                              k_idx, k_valid, **sc)
    act = kv > 0
    tol = 3e-2 if q.dtype == torch.bfloat16 else 1e-3
    err = float((out[act].float() - plain[act].float()).abs().max())
    res = {"dtype": str(q.dtype).replace("torch.", ""),
           "shape": {"B": q.shape[0], "H": q.shape[1], "d": q.shape[-1],
                     "pages": pool["pages_k"].shape[0],
                     "table": table.shape[1], "page": ps,
                     "top_k": cfg.top_k},
           "active_rows": int(act.sum()),
           "relaunch_equal": bool(torch.equal(out, rec["out"])),
           "route_rows_differing": rows, "route_max_gap": gap,
           "route_near_ties_ok": ties_ok, "tables_equal": tables_equal,
           "max_abs_err": err, "tol": tol}
    res["default_scale"] = rec["scale"] is None    # _decode_launch's
    res["ok"] = (res["relaunch_equal"] and ties_ok and tables_equal
                 and err <= tol and res["default_scale"])
    return res


def _sharded_gate() -> dict:
    """fp32 (TF32 off): 4 prompts of 1,024..2,047 tokens, 16 new, on 2
    shards x 2 slots against the single-device engine with 4 slots, and
    one 6,144-token prompt that no shard's 4,096-token sequences can page,
    through the context-parallel fallback, against the dense-cache fixed
    loop on ``reference``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import moba_sp as SP
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.sharded import ShardedEngine
    g = SHARDED_GATE
    cfg = dataclasses.replace(get_config("moba-340m"), dtype="float32")
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
               for n in rng.integers(*g["lens"], g["prompts"])]
    long_prompt = rng.integers(0, cfg.vocab_size, SHARDED_CP["prompt_len"],
                               dtype=np.int32)
    ecfg = EngineConfig(max_seqs=g["slots"], max_prefill_batch=2,
                        max_seq_len=g["max_seq_len"], attn_backend="flash")
    sh = ShardedEngine(cfg, params, ecfg, devices=["cuda:0"] * SHARDS)
    rec, undo = _record_decode_call(sh, 1)
    try:
        reqs = [sh.submit(p, g["new_tokens"]) for p in prompts]
        cp = sh.submit(long_prompt, SHARDED_CP["new_tokens"])
        sh.run()
        torch.cuda.synchronize()
    finally:
        undo()
    got = [list(r.out) for r in reqs]
    one = Engine(cfg, params, dataclasses.replace(
        ecfg, max_seqs=g["slots"] * SHARDS), device="cuda")
    base = [one.submit(p, g["new_tokens"]) for p in prompts]
    one.run()
    want = [list(r.out) for r in base]
    del one, base
    # the oracle: the dense-cache fixed loop on ``reference``
    n_cp = SHARDED_CP["prompt_len"] + SHARDED_CP["new_tokens"]
    caches = T.init_caches(cfg, 1, n_cp, dtype=torch.float32, device="cuda")
    logits, caches = S.make_prefill_step(cfg, backend="reference")(
        params, torch.as_tensor(long_prompt[None], device="cuda"), caches)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    oracle = [int(tok)]
    decode = S.make_decode_step(cfg, backend="reference")
    while len(oracle) < SHARDED_CP["new_tokens"]:
        tok, caches = decode(params, tok, caches)
        oracle.append(int(tok))
    del caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    cpr = sh.cp_record
    steps = max(cpr["decode_steps"], 1)
    per_step = {k: n / steps for k, n in cpr["decode_bytes"].items()}
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    m = cfg.attention.moba
    layers = _moba_layers(cfg)
    formula = {k: n * layers for k, n in SP.cp_decode_bytes(
        1, h, d, m.top_k, SHARDS, 4).items()}
    # the token appended at position p >= n_local goes to shard 1
    formula["append"] = 2 * hkv * d * 4 * layers
    max_len = cp.cache_len              # the last step's kv_len
    n_local = -(-(n_cp) // (SHARDS * m.block_size)) * m.block_size
    nb = -(-(n_local * SHARDS) // m.block_size)
    out = {"shards": SHARDS, "note": SHARDED_NOTE, "dtype": "float32",
           "prompt_lens": [len(p) for p in prompts],
           "new_tokens": g["new_tokens"], "slots_per_shard": g["slots"],
           "paged_vs_single": _parted(cfg, params, prompts, want, got,
                                      tol=GAP_TOL),
           "shard_of_request": [r.shard for r in reqs],
           "shard_stats": sh.shard_stats,
           "cp": {"shard": cp.shard, "prompt_len": len(long_prompt),
                  "cp_requests": sh.stats["cp_requests"],
                  "cp_tokens": sh.stats["cp_tokens"],
                  "segment_tokens": n_local,
                  "prefill_s": cpr["prefill_s"],
                  "decode_step_ms": cpr["decode_s"] / steps * 1e3,
                  "decode_steps": cpr["decode_steps"],
                  "prefill_bytes": dict(cpr["prefill_bytes"]),
                  "decode_bytes_per_step": per_step,
                  "decode_bytes_per_step_total": sum(per_step.values()),
                  "formula_bytes_per_step": formula,
                  "reference_formula_bytes_per_step":
                      layers * h * (nb + SHARDS * m.top_k * (d + 2)) * 4,
                  "dense_kv_bytes_per_step":
                      layers * 2 * hkv * d * 4 * (max_len - n_local),
                  "vs_oracle": _parted(cfg, params, [long_prompt], [oracle],
                                       [list(cp.out)], tol=GAP_TOL)},
           "decode_call": _check_decode_call(rec)}
    out["cp"]["bytes_equal_formula"] = per_step == {
        k: float(v) for k, v in formula.items()}
    del sh, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sharded_timed(cfg, params, make, prompts, rng,
                   full: bool = True) -> dict:
    """One bf16 run of ``prompts`` (32 new tokens) through the engine
    ``make()`` builds: counts zeroed just before, read just after; with
    ``full``, shard 1's first decode call recorded and checked, then a
    profiled window (phase 3's) and the peak memory."""
    import torch
    from repro_torch.kernels import moba_decode as MD
    eng = make()
    sharded = hasattr(eng, "shard_stats")
    rec, undo = ((_record_decode_call(eng, 1)) if sharded and full
                 else ({}, lambda: None))
    reqs = [eng.submit(p, SHARDED_TIMING["new_tokens"]) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    MD.LAUNCHES = MD.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        eng.run()
        torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    calls, kernels = MD.LAUNCHES, MD.KERNEL_LAUNCHES
    st = dict(eng.stats)
    out = {"wall_s": wall, "requests_done": sum(r.done for r in reqs),
           "prefill_tokens": st["prefill_tokens"],
           "prefill_s": st["prefill_s"],
           "decode_tokens": st["decode_tokens"],
           "decode_steps": st["decode_steps"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "decode_step_ms": st["decode_s"] / st["decode_steps"] * 1e3,
           "decode_calls": calls, "kernel_launches": kernels,
           "decode_calls_per_step": calls / st["decode_steps"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "streams": [list(r.out) for r in reqs]}
    if sharded:
        out["shard_stats"] = [dict(s) for s in eng.shard_stats]
    if full:
        if sharded:
            out["decode_call"] = _check_decode_call(rec)
        out["profile"] = _profile_decode(eng, cfg, rng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_sharded():
    """The sharded engine at moba-340m's full width and depth (24 layers,
    d_model 1,024, 16 heads of 64, block 128, top_k 8; seed-0 weights) on
    ``flash``, 2 shards sharing cuda:0.  Gate in fp32 (:func:`_sharded_gate`):
    the paged streams equal the single-device engine's and the
    context-parallel request's the fixed loop's (up to a teacher-forced
    top-2 gap <= 1e-3); shard 1's first decode call's tensors pass phase
    2's checks; a context-parallel decode step moves the formula's bytes.
    Timing in bf16: phase 3's 8 prompts, 32 new tokens, on 2 shards x 4
    slots and on the single-device engine with 8 slots, each with its
    decode tokens/s, step ms, prefill s, decode calls a step (12 a shard
    step), a profiled window (launch calls a step, idle share) and peak
    memory; shard 1's first decode call again passes phase 2's checks;
    the pair again in the other order (single, then sharded), timed only,
    for the spread of the step-time ratio.  The bf16 streams equal those
    of a witness, the single-device engine at 4 slots (a shard's decode
    rows), up to a teacher-forced top-2 gap <= 1e-2; their partings from
    the 8-slot engine's are reported with their gaps, not gated, beside
    the witness's own partings from it.  Returns the sharded run's
    decode calls and kernels."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.sharded import ShardedEngine
    bad = []
    gate = _sharded_gate()
    if not gate["paged_vs_single"]["ok"]:
        bad.append("a sharded stream parted from the single-device "
                   "engine's off a near-tie")
    cp = gate["cp"]
    if cp["shard"] != -1 or cp["cp_requests"] != 1 \
            or cp["cp_tokens"] != SHARDED_CP["new_tokens"]:
        bad.append(f"the long request did not take the context-parallel "
                   f"fallback: {cp['shard']}, {cp['cp_requests']}")
    if not cp["vs_oracle"]["ok"]:
        bad.append("the context-parallel stream parted from the fixed "
                   "loop's off a near-tie")
    if not cp["bytes_equal_formula"]:
        bad.append("a context-parallel decode step moved other bytes than "
                   "the formula's")
    if not gate["decode_call"]["ok"]:
        bad.append(f"shard 1's decode call disagrees with the plain "
                   f"version: {gate['decode_call']}")
    cfg = get_config("moba-340m")
    layers = _moba_layers(cfg)
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
               for n in rng.integers(1024, 4096, SHARDED_TIMING["prompts"])]
    t = SHARDED_TIMING
    ecfg = EngineConfig(max_seqs=t["slots"], max_prefill_batch=2,
                        max_seq_len=t["max_seq_len"], attn_backend="flash")
    runs = {
        "sharded": _sharded_timed(cfg, params, lambda: ShardedEngine(
            cfg, params, ecfg, devices=["cuda:0"] * SHARDS), prompts, rng),
        "single": _sharded_timed(cfg, params, lambda: Engine(
            cfg, params, dataclasses.replace(
                ecfg, max_seqs=t["slots"] * SHARDS), device="cuda"),
            prompts, rng)}
    sh, one = runs["sharded"], runs["single"]
    again = {"single": _sharded_timed(cfg, params, lambda: Engine(
        cfg, params, dataclasses.replace(ecfg, max_seqs=t["slots"] * SHARDS),
        device="cuda"), prompts, rng, full=False)}
    again["sharded"] = _sharded_timed(cfg, params, lambda: ShardedEngine(
        cfg, params, ecfg, devices=["cuda:0"] * SHARDS), prompts, rng,
        full=False)
    # the witness: the single-device engine with a shard's 4 decode rows
    witness = _sharded_timed(cfg, params, lambda: Engine(
        cfg, params, ecfg, device="cuda"), prompts, rng, full=False)
    shard_steps = sum(s["decode_steps"] for s in sh["shard_stats"])
    sh["decode_calls_per_shard_step"] = sh["decode_calls"] / shard_steps
    for name, r in runs.items():
        if r["requests_done"] != t["prompts"] or any(
                len(s) != t["new_tokens"] for s in r["streams"]):
            bad.append(f"{name}: a request did not finish with its count")
        steps = shard_steps if name == "sharded" else r["decode_steps"]
        bad += _decode_gate(name, r["decode_calls"], r["kernel_launches"],
                            steps, layers)
    for name, r in (("single again", again["single"]),
                    ("sharded again", again["sharded"]),
                    ("witness", witness)):
        if r["requests_done"] != t["prompts"]:
            bad.append(f"{name}: a request did not finish")
    if not sh["decode_call"]["ok"]:
        bad.append(f"shard 1's bf16 decode call disagrees with the plain "
                   f"version: {sh['decode_call']}")
    # against the 8-slot engine reported, not gated: a shard's GEMMs take
    # 4 rows where its take 8, and bf16 rounds the two differently; the
    # witness parts from it the same way, and the fleet is gated on the
    # witness, the single-device engine with a shard's 4 rows
    vs = _parted(cfg, params, prompts, one["streams"], sh["streams"])
    w_vs = _parted(cfg, params, prompts, one["streams"], witness["streams"])
    sh_vs_w = _parted(cfg, params, prompts, witness["streams"],
                      sh["streams"])
    if not sh_vs_w["ok"]:
        bad.append(f"a bf16 sharded stream parted from the 4-slot "
                   f"single-device engine's off a near-tie: {sh_vs_w}")
    for r in (*runs.values(), *again.values(), witness):
        del r["streams"]
    rec = {"phase": "serve_sharded", "arch": cfg.name, "note": SHARDED_NOTE,
           "gate_fp32": gate, "timing_bf16": runs,
           "bf16_streams_vs_single": vs,
           "bf16_witness_4_vs_8_slots": w_vs,
           "bf16_sharded_vs_witness": sh_vs_w,
           "timing_bf16_again": again, "witness_4_slots": witness,
           "step_ms_ratio": sh["decode_step_ms"] / one["decode_step_ms"],
           "step_ms_ratio_again": (again["sharded"]["decode_step_ms"]
                                   / again["single"]["decode_step_ms"]),
           "launch_calls_ratio": (
               sh["profile"]["launch_calls_per_step"]
               / one["profile"]["launch_calls_per_step"])}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rec["ok"], rec["failures"] = not bad, bad
    emit(rec)
    if bad:
        raise SystemExit("serve_sharded: " + "; ".join(bad))
    return sh["decode_calls"], sh["kernel_launches"]


# ----------------------------------------- the MoE, SSM and hybrid families
MOE_ARCH = "qwen2-moe-a2.7b"         # 14,315,587,584 fp32 params, 53.33 GiB
MOE_NEW_TOKENS = 32
MOE_LOGITS_LENS = (1500, 700)        # the fp32 decode check's two rows
ROUTER_GAP_TOL = 1e-5                # an expert choice may flip only here
MOE_TRAIN = dict(arch=MOE_ARCH, layers=2, seq=4096)
MOE_TRAIN_STEPS = 3
SSM_ARCHS = ("mamba2-780m", "zamba2-1.2b")
SSM_CASE = dict(batch=8, prompt_len=2048, gen=32)
SSM_FP32_CASE = dict(batch=2, prompt_len=512, gen=8)
ENCDEC_ARCH = "seamless-m4t-medium"   # 0.978 B params, 3.64 GiB in fp32
VLM_ARCH = "llama-3.2-vision-90b"     # 87.7 B params at full depth
VLM_LAYERS = 10                       # of 100: two pattern groups (8 MoBA,
#                                       2 cross), 10.66 B params, 39.7 GiB
# the bf16 serving cells (layers 0: full depth) and the fp32 gates' smaller
# size (2 rows; llama-vision one pattern group deep)
SERVE_CROSS = {ENCDEC_ARCH: dict(layers=0, batch=8, prompt_len=2048, gen=32),
               VLM_ARCH: dict(layers=VLM_LAYERS, batch=4, prompt_len=2048,
                              gen=16)}
CROSS_FP32 = {ENCDEC_ARCH: dict(layers=0, batch=2, prompt_len=2048, gen=8),
              VLM_ARCH: dict(layers=5, batch=2, prompt_len=2048, gen=8)}
# a routing near-tie between two whole-model paths (a cached decode and a
# one-shot lm_apply): their q and k differ by the rounding of every layer
# before, not by one kernel's.  On an H100, llama-vision's (5 layers,
# fp32) differ at gaps up to 2.46e-5, which the kernel rule (1e-5·max(1,
# |s|)) fails; one wrong block fails this rule in every decoder layer
# (_cross_fp32 reports both)
CROSS_PATH_TIE_TOL = 1e-4
ENCDEC_TRAIN = dict(arch=ENCDEC_ARCH, batch=2, seq=4096)
ENCDEC_TRAIN_STEPS = 3


def _router_records(records: list):
    """Patch ``models/moe.py::route`` to keep every call's router
    probabilities and experts.  Returns the undo."""
    from repro_torch.models import moe as MOE
    route = MOE.route

    def rec(router, xf, k):
        probs, top_p, top_e = route(router, xf, k)
        records.append((probs, top_e))
        return probs, top_p, top_e

    MOE.route = rec

    def undo():
        MOE.route = route
    return undo


def _expert_flips(flash: list, xla: list, k: int) -> dict:
    """Rows whose expert choice differs between two runs' router records
    (one per layer, in order), the layer where each row's choice first
    differs and the router's top-k gap there (its k-th largest
    probability less the next, on the flash run's probabilities): a flip
    must start at a near-tie; later layers of a row that already flipped
    see other inputs and are counted, not gated."""
    import torch
    first, gaps, counts = {}, [], []
    for layer, ((pf, ef), (_, ex)) in enumerate(zip(flash, xla)):
        differ = (ef.sort(-1).values != ex.sort(-1).values).any(-1)
        counts.append(int(differ.sum()))
        top = pf.sort(-1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        for row in torch.nonzero(differ).flatten().tolist():
            if row not in first:
                first[row] = layer
                gaps.append(float(gap[row]))
    return {"expert_choices_differing_per_layer": counts,
            "rows_flipped": sorted(first),
            "first_flip_router_gaps": gaps,
            "flips_near_ties_ok": all(g <= ROUTER_GAP_TOL for g in gaps)}


def phase_moe_logits() -> dict:
    """qwen2-moe-a2.7b at full width and depth in fp32 (TF32 off): a
    shared paged prefill of :data:`MOE_LOGITS_LENS` (on ``xla``), then
    :func:`_decode_flash_vs_xla`'s decode step under ``flash`` and
    ``xla``, xla replaying flash's block selections in all 24 layers.  Any
    expert choice that differs between the two runs is counted and must
    start at a router top-k gap of at most :data:`ROUTER_GAP_TOL`; the
    logits (2e-3) and greedy tokens are held on the rows where no choice
    differs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S

    cfg = dataclasses.replace(get_config(MOE_ARCH), dtype="float32")
    npg = -(-(max(MOE_LOGITS_LENS) + 1) // 128)
    params, t, _, new_caches = _logits_case(cfg, lens=MOE_LOGITS_LENS,
                                            npg=npg)
    first, caches = S.make_paged_prefill_step(cfg, "xla", chunked=True)(
        params, t["tokens"], new_caches(), t["table"], t["kv0"], t["lens"],
        t["slots"], t["active"])
    records = []
    undo = _router_records(records)
    try:
        rec = _decode_flash_vs_xla(cfg, params, caches, t, first,
                                   keep_logits=True)
    finally:
        undo()
    logits, toks = rec.pop("_logits"), rec.pop("_tokens")
    n = cfg.num_layers          # runs: flash step, flash S, xla, xla S
    flips = _expert_flips(records[:n], records[2 * n:3 * n],
                          cfg.moe.top_k)
    again = _expert_flips(records[n:2 * n], records[3 * n:], cfg.moe.top_k)
    rows = torch.ones(len(MOE_LOGITS_LENS), dtype=torch.bool, device="cuda")
    rows[sorted(set(flips["rows_flipped"]) | set(again["rows_flipped"]))] \
        = False
    a, b = logits["flash"][rows], logits["xla"][rows]
    close = bool(torch.allclose(a, b, atol=2e-3, rtol=2e-3))
    same = bool(torch.equal(toks["flash"][rows], toks["xla"][rows])
                and torch.equal(toks["flash"][rows],
                                a.argmax(-1).to(torch.int32)))
    out = {"phase": "serve_moe_logits", "arch": cfg.name, "dtype": "float32",
           "kv_lens": list(MOE_LOGITS_LENS), "rows_compared": int(rows.sum()),
           **rec, **flips,
           "rows_max_abs_diff": float((a - b).abs().max()) if len(a) else 0.0,
           "rows_allclose": close, "rows_greedy_equal": same}
    out["ok"] = (rec["finite"] and rec["routing_near_ties_ok"] and close
                 and same and flips["flips_near_ties_ok"]
                 and again["flips_near_ties_ok"] and bool(rows.any()))
    emit(out)
    del params, caches, records, logits
    gc.collect()
    torch.cuda.empty_cache()
    if not out["ok"]:
        raise SystemExit("serve_moe_logits: flash and xla decode logits "
                         "disagree on rows with equal expert choices, or a "
                         "block or expert choice differs off a near-tie")
    return out


def phase_serve_moe():
    """qwen2-moe-a2.7b at full width and depth (bf16 compute on fp32
    weights, seed 0) through ``Engine`` on ``flash`` from bf16 pools:
    phase 3's 8 prompts, 32 new tokens, 8 slots, 2 prompts a prefill.
    Every request finishes; 24 decode calls and 72 kernel launches a
    step (phase 3's gates, through :func:`phase_serve`); the record
    counts the (token, slot) pairs the prefills dropped.  Then the fp32
    decode check (:func:`phase_moe_logits`).  Returns the decode calls
    and kernel launches of the measured run."""
    calls, kernels, _, _ = phase_serve(
        arch=MOE_ARCH, new_tokens=MOE_NEW_TOKENS, phase="serve_moe")
    phase_moe_logits()
    return calls, kernels


def _ssm_fp32(arch: str) -> dict:
    """``arch`` at full width and depth in fp32 (TF32 off, seed-0
    weights): a dense-cache prefill of :data:`SSM_FP32_CASE` prompts and
    its recurrent greedy decode, against one ``lm_apply`` over each
    prompt and the tokens fed back: logits within 2e-3, greedy tokens
    equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    b, n, gen = (SSM_FP32_CASE[k] for k in ("batch", "prompt_len", "gen"))
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, n)), dtype=torch.int32, device="cuda")
    caches = T.init_caches(cfg, b, n + gen, dtype=torch.float32,
                           device="cuda")
    with torch.no_grad():
        logits, caches = T.prefill(params, prompts, cfg, caches,
                                   backend="flash")
        steps = [logits[:, -1]]
        toks = [steps[-1].argmax(-1).to(torch.int32)]
        for _ in range(gen - 1):
            logits, caches = T.decode_step(params, toks[-1][:, None], cfg,
                                           caches, backend="flash")
            steps.append(logits[:, -1])
            toks.append(steps[-1].argmax(-1).to(torch.int32))
        fed = torch.cat([prompts, torch.stack(toks[:-1], 1)], 1)
        want = T.lm_apply(params, fed, cfg, backend="flash")[0][:, n - 1:]
    got = torch.stack(steps, 1)
    rec = {"batch": b, "prompt_len": n, "gen": gen,
           "max_abs_diff": float((got - want).abs().max()), "tol": 2e-3,
           "allclose": bool(torch.allclose(got, want, atol=2e-3,
                                           rtol=2e-3)),
           "greedy_equal": bool(torch.equal(torch.stack(toks, 1),
                                            want.argmax(-1).to(
                                                torch.int32))),
           "finite": bool(torch.isfinite(got).all())}
    rec["ok"] = rec["allclose"] and rec["greedy_equal"] and rec["finite"]
    return rec


def phase_serve_ssm():
    """mamba2-780m and zamba2-1.2b at full width and depth (bf16 compute,
    seed-0 weights) through ``serve()``, which falls back to the
    fixed-batch loop (the engine refuses ``ssm`` slots): 8 prompts of
    2,048 tokens, 32 new tokens, ``flash``.  Each step call timed between
    syncs (:func:`_timed_steps`): prefill s, decode step ms, tokens/s,
    peak memory; no MoBA kernel may launch (zamba2's shared block runs
    dense attention, as JAX resolves it).  Then :func:`_ssm_fp32`."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as TS
    from repro_torch.serving.engine import engine_supported

    bad = []
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        times, counts = [], []
        undo = _timed_steps(times, counts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            toks = TS.serve(arch, smoke=False, attn_backend="flash",
                            device="cuda", **SSM_CASE)
        finally:
            undo()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gc.collect()
        torch.cuda.empty_cache()
        launched = {k: sum(c[k] for c in counts) for k in counts[0]}
        dec_s = sum(times[1:])
        b, g = SSM_CASE["batch"], SSM_CASE["gen"]
        rec = {"phase": "serve_ssm", "arch": cfg.name, "family": cfg.family,
               "dtype": cfg.dtype, "backend": "flash", **SSM_CASE,
               "engine_supported": engine_supported(cfg), "wall_s": wall,
               "prefill_s": times[0],
               "prefill_tok_s": b * SSM_CASE["prompt_len"] / times[0],
               "decode_steps": len(times) - 1,
               "decode_step_ms": dec_s / (len(times) - 1) * 1e3,
               "decode_tok_s": b * (len(times) - 1) / dec_s,
               "peak_mem_gib": peak, "kernel_launches": launched,
               "fp32": _ssm_fp32(arch)}
        gc.collect()
        torch.cuda.empty_cache()
        emit(rec)
        what = f"serve_ssm ({cfg.name})"
        if rec["engine_supported"] or len(times) != g:
            bad.append(f"{what}: took {len(times)} fixed-loop steps, "
                       f"expected {g} (engine_supported "
                       f"{rec['engine_supported']})")
        if any(launched.values()):
            bad.append(f"{what}: a MoBA kernel launched: {launched}")
        if toks.shape != (b, g) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            bad.append(f"{what}: tokens of shape {toks.shape}")
        if not rec["fp32"]["ok"]:
            bad.append(f"{what}: fp32 recurrent decode disagrees with "
                       f"lm_apply: {rec['fp32']}")
    if bad:
        raise SystemExit("; ".join(bad))


@contextlib.contextmanager
def _depth(arch: str, layers: int):
    """``repro_torch.configs.get_config`` with ``arch`` cut to ``layers``
    (0: as published), so the entry points build the cut model; yields
    its config."""
    from repro_torch import configs
    get = configs.get_config

    def cut(a, **kw):
        cfg = get(a, **kw)
        if a == arch and layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        return cfg

    configs.get_config = cut
    try:
        yield cut(arch)
    finally:
        configs.get_config = get


def _encoder_moba_layers(cfg) -> int:
    from repro_torch.models import transformer as T
    return (cfg.num_encoder_layers
            if cfg.num_encoder_layers and T._encoder_kind(cfg) == "moba"
            else 0)


def _n_params(cfg) -> int:
    from repro_torch.models import transformer as T

    def count(t):
        return (sum(count(v) for v in t.values()) if isinstance(t, dict)
                else int(np.prod(t)))
    return count(T.param_shapes(cfg))


def _profile_fixed_decode(cfg, params, prompts, extras: dict,
                          steps: int = 2) -> dict:
    """A fixed-loop decode step under torch.profiler, as ``serve_fixed``
    runs it (the step builders, bf16, ``flash``): a prefill and one warm
    step, then ``steps`` profiled steps (:func:`_profile_summary`).  With
    frame embeddings, also one ``apply_encoder`` profiled alone, and its
    device busy time over a step's: the share of a decode step's device
    time that goes to rerunning the encoder."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    b, p = prompts.shape
    caches = T.init_caches(cfg, b, p + steps + 2,
                           dtype=getattr(torch, cfg.dtype), device="cuda")
    prefill = S.make_prefill_step(cfg, backend="flash")
    decode = S.make_decode_step(cfg, backend="flash")
    lg, caches = prefill(params, prompts, caches, **extras)
    tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
    tok, caches = decode(params, tok, caches, **extras)
    torch.cuda.synchronize()

    def window(fn, n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return _profile_summary(prof, wall, n)

    state = {"tok": tok, "caches": caches}

    def step():
        state["tok"], state["caches"] = decode(params, state["tok"],
                                               state["caches"], **extras)

    rec = window(step, steps)
    del state, caches
    if "src_embeds" in extras:
        with torch.no_grad():
            enc = window(lambda: T.apply_encoder(
                params, extras["src_embeds"], cfg, backend="flash"), 1)
        rec["encoder_alone"] = {k: enc[k] for k in (
            "step_ms", "device_busy_ms_per_step", "kernels_per_step",
            "launch_calls_per_step")}
        busy = rec["device_busy_ms_per_step"]
        rec["encoder_share_of_device_time"] = (
            enc["device_busy_ms_per_step"] / busy if busy else None)
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _cross_fp32(arch: str) -> dict:
    """``arch`` in fp32 (TF32 off) at :data:`CROSS_FP32`'s smaller size,
    seed-0 weights, prompts then stub inputs from ``default_rng(0)``: the
    fixed loop's prefill and greedy decode on ``flash`` and on ``xla``,
    xla replaying flash's selections (:func:`_flash_then_xla`; the
    encoder's too), decode logits within 2e-3 and greedy tokens equal;
    then the flash run's logits against one ``lm_apply`` on
    ``reference`` over each prompt and the tokens fed back, the encoder
    rerun over the frames: within 2e-3, greedy tokens equal.  The
    one-shot run replays the flash run's selections (the encoder's and
    the prefill's from Flash TopK, each decode position's from its
    decode route), each held to the one-shot's own routing by the
    near-tie rule at :data:`CROSS_PATH_TIE_TOL` and, reported beside it,
    at the kernel rule's 1e-5; the rule's power is shown on each decoder
    layer by one wrong block (:func:`_swap_one_block`), which it must
    fail.  Then the one-shot on its own routing: its logits may leave
    2e-3 of the flash run's only at and after the first position whose
    routing differs (a flipped near-tie moves every later position)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import moba as CM
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T

    c = dict(CROSS_FP32[arch])
    layers = c.pop("layers")
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    b, n, gen = c["batch"], c["prompt_len"], c["gen"]
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, n)),
                              dtype=torch.int32, device="cuda")
    extras = S.stub_frontend_inputs(cfg, rng, b, "cuda")

    def run(backend):
        caches = T.init_caches(cfg, b, n + gen, dtype=torch.float32,
                               device="cuda")
        with torch.no_grad():
            mem = _memory(cfg, params, extras, backend)
            lg, caches = T.prefill(params, prompts, cfg, caches,
                                   backend=backend, cross_kv=mem)
            logits = [lg[:, -1]]
            for _ in range(gen - 1):
                tok = logits[-1].argmax(-1)[:, None].to(torch.int32)
                lg, caches = T.decode_step(params, tok, cfg, caches,
                                           backend=backend, cross_kv=mem)
                logits.append(lg[:, -1])
        return torch.stack(logits, 1)                        # (B, gen, V)

    runs = _flash_then_xla(run)
    fl, xl = runs["flash"], runs["xla"]
    toks = fl.argmax(-1).to(torch.int32)
    routing = _routing_record(runs)
    moba, enc = _moba_layers(cfg), _encoder_moba_layers(cfg)
    routing["routing_near_ties_ok"] = (
        routing["routing_near_ties_ok"]
        and runs["selections"] == moba + enc
        and runs["routes"] == moba * (gen - 1))
    # the one-shot's selections: the encoder's as recorded; a decoder
    # layer's prefill rows, then each decode step's route
    sel, routes = runs.pop("rec_sel"), runs.pop("rec_route")
    rows, k = b * cfg.num_heads, cfg.attention.moba.top_k
    replayed = sel[:enc] + [torch.cat([sel[enc + li][:, :n], torch.stack(
        [routes[st * moba + li][0].reshape(rows, k)
         for st in range(gen - 1)], 1).to(sel[enc + li].dtype)], 1)
        for li in range(moba)]
    routes_valid = all(bool(v.all()) for _, v in routes)
    del sel, routes
    plain = CM.moba_selection
    fed = torch.cat([prompts, toks[:, :-1]], 1)

    def one_shot(audit, compare, own=False):
        CM.moba_selection = _replay_selection(replayed, audit, plain,
                                              compare, own)
        try:
            with torch.no_grad():
                return T.lm_apply(params, fed, cfg, backend="reference",
                                  cross_kv=_memory(cfg, params, extras,
                                                   "reference")
                                  )[0][:, n - 1:]
        finally:
            CM.moba_selection = plain

    def judge(masked, got, mine):
        rows_, gap, kernel_ok = _near_ties(masked, got, mine)
        path_ok = _near_ties(masked, got, mine, tol=CROSS_PATH_TIE_TOL)[2]
        wrong = _swap_one_block(masked, got)
        return {"rows": rows_, "gap": gap, "kernel_rule_ok": kernel_ok,
                "path_rule_ok": path_ok,
                "wrong_block_passes": None if wrong is None else
                _near_ties(masked, wrong, mine, tol=CROSS_PATH_TIE_TOL)[2]}

    def differing(masked, got, mine):                        # (B, Nq)
        d = (_canonical(masked, got) != _canonical(masked, mine)).any(-1)
        return d.reshape(b, -1, d.shape[-1]).any(1)

    audit, where = [], []
    want = one_shot(audit, judge)
    own = one_shot(where, differing, own=True)
    # each batch row's first position whose routing differs in any layer
    # (anywhere in the encoder: every position reads its output)
    first = torch.full((b,), n + gen, device="cuda")
    for li, d in enumerate(where):
        pos = torch.where(d, torch.arange(d.shape[1], device="cuda"), n + gen)
        first = torch.minimum(first, torch.where(
            d.any(1), 0, n + gen) if li < enc else pos.amin(1))
    off = ~torch.isclose(own, fl, atol=2e-3, rtol=2e-3).all(-1)  # (B, gen)
    after = (torch.arange(gen, device="cuda")[None] + n - 1) >= first[:, None]
    before = (~after)[..., None].expand_as(fl)
    one_shot_ok = (routes_valid and len(audit) == enc + moba
                   and all(a["path_rule_ok"] for a in audit)
                   and all(a["wrong_block_passes"] is False
                           for a in audit[enc:]))
    rec = {"dtype": "float32", "layers": cfg.num_layers, **c,
           "tol": 2e-3,
           "flash_vs_xla_max_abs_diff": float((fl - xl).abs().max()),
           "flash_vs_xla_allclose": bool(torch.allclose(
               fl, xl, atol=2e-3, rtol=2e-3)),
           "flash_vs_xla_greedy_equal": bool(torch.equal(
               fl.argmax(-1), xl.argmax(-1))),
           **routing,
           "cached_vs_lm_apply_max_abs_diff": float((fl - want).abs().max()),
           "cached_vs_lm_apply_allclose": bool(torch.allclose(
               fl, want, atol=2e-3, rtol=2e-3)),
           "cached_vs_lm_apply_greedy_equal": bool(torch.equal(
               toks, want.argmax(-1).to(torch.int32))),
           "one_shot_routing_rows_differing_per_layer":
               [a["rows"] for a in audit],
           "one_shot_routing_max_gap_per_layer": [a["gap"] for a in audit],
           "one_shot_tie_tol": CROSS_PATH_TIE_TOL,
           "one_shot_near_ties_at_kernel_rule_1e-5":
               all(a["kernel_rule_ok"] for a in audit),
           "one_shot_wrong_block_passes_per_decoder_layer":
               [a["wrong_block_passes"] for a in audit[enc:]],
           "one_shot_routing_near_ties_ok": one_shot_ok,
           "own_routing_rows_differing_per_layer":
               [int(d.sum()) for d in where],
           "own_routing_first_differing_position":
               [int(x) if x < n + gen else None for x in first.tolist()],
           "own_routing_max_abs_diff": float((own - fl).abs().max()),
           "own_routing_max_abs_diff_before_first_difference":
               float(((own - fl).abs() * before).max()),
           "own_routing_off_only_after_a_difference":
               not bool((off & ~after).any()),
           "finite": bool(torch.isfinite(fl).all())}
    rec["ok"] = all(rec[key] for key in (
        "flash_vs_xla_allclose", "flash_vs_xla_greedy_equal",
        "routing_near_ties_ok", "cached_vs_lm_apply_allclose",
        "cached_vs_lm_apply_greedy_equal", "one_shot_routing_near_ties_ok",
        "own_routing_off_only_after_a_difference", "finite"))
    del params, runs, fl, xl, want, own, replayed
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_serve_cross(arch: str) -> dict:
    """``arch`` (seamless-m4t-medium at full width and depth, or
    llama-3.2-vision-90b at full width cut to :data:`VLM_LAYERS` layers)
    in bf16 compute on fp32 seed-0 weights through ``serve()``, which
    falls back to the fixed loop (the engine refuses ``decoder`` and
    ``cross`` slots, as in JAX), on ``flash``, :data:`SERVE_CROSS`'s
    traffic.  The stub inputs come from the entry point's own generator
    (frames for the encoder, image tokens for the cross layers).  Each
    step call timed between syncs with the kernels it launched
    (:func:`_timed_steps`): the prefill must launch one centroids, Flash
    TopK and ``moba_fwd`` per MoBA layer of the encoder and the decoder,
    each decode step one each per encoder MoBA layer (the stub encoder
    reruns in every step, as in the reference) and no decode kernel (the
    dense-cache decode is the plain gather).  The three kernels of the
    prefill's first MoBA layer of the encoder and of the decoder are held
    to their plain versions on the inputs they got there
    (:func:`_check_forward_kernels`).  Then a profiled decode
    step (:func:`_profile_fixed_decode`), the bf16 gate on the served
    streams teacher-forced through the fixed loop against ``lm_apply``
    (:func:`_fixed_teacher_forced`), and the fp32 gates
    (:func:`_cross_fp32`).  Returns the run's launches of the four
    training kernels."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as TS
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import engine_supported

    case = dict(SERVE_CROSS[arch])
    layers = case.pop("layers")
    b, p, g = case["batch"], case["prompt_len"], case["gen"]
    full_layers = get_config(arch).num_layers
    bad = []
    with _depth(arch, layers) as cfg:
        phase = "serve_encdec" if cfg.family == "encdec" else "serve_vlm"
        enc, dec = _encoder_moba_layers(cfg), _moba_layers(cfg)
        times, counts = [], []
        undo = _timed_steps(times, counts)
        # the prefill's first forward of the encoder (if any) and of the
        # decoder: their kernels held to their plain versions below
        first = {"decoder_layer_0": enc}
        if enc:
            first["encoder_layer_0"] = 0
        kept, unrecord = _record_flash_moba(tuple(first.values()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            toks = TS.serve(arch, smoke=False, attn_backend="flash",
                            device="cuda", **case)
        finally:
            unrecord()
            undo()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gc.collect()
        torch.cuda.empty_cache()
        want_prefill = {"block_centroids": enc + dec, "flash_topk": enc + dec,
                        "moba_fwd": enc + dec, "moba_bwd": 0, "swa": 0,
                        "swa_bwd": 0, "moba_paged_decode": 0}
        want_decode = {k: (enc if v else 0) for k, v in want_prefill.items()}
        if counts[0] != want_prefill:
            bad.append(f"prefill launched {counts[0]}, expected "
                       f"{want_prefill}")
        if any(c != want_decode for c in counts[1:]):
            bad.append(f"decode steps launched {counts[1:]}, expected "
                       f"{want_decode} each")
        if engine_supported(cfg) or len(times) != g:
            bad.append(f"took {len(times)} fixed-loop steps, expected {g}")
        if toks.shape != (b, g) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            bad.append(f"tokens of shape {toks.shape}")
        dec_s = sum(times[1:])
        rec = {"phase": phase, "arch": cfg.name, "family": cfg.family,
               "dtype": cfg.dtype, "backend": "flash", **case,
               "layers": cfg.num_layers,
               "encoder_layers": cfg.num_encoder_layers,
               "params": _n_params(cfg),
               "weights_gib_fp32": _n_params(cfg) * 4 / 2 ** 30,
               "memory_tokens": cfg.num_audio_frames or cfg.num_image_tokens,
               "engine_supported": engine_supported(cfg), "wall_s": wall,
               "prefill_s": times[0], "prefill_tok_s": b * p / times[0],
               "decode_steps": len(times) - 1,
               "decode_step_ms": dec_s / (len(times) - 1) * 1e3,
               "decode_step_ms_median": float(np.median(times[1:])) * 1e3,
               "decode_tok_s": b * (len(times) - 1) / dec_s,
               "peak_mem_gib": peak, "prefill_launches": counts[0],
               "decode_step_launches": counts[1],
               "expected_prefill": want_prefill,
               "expected_decode_step": want_decode}
        if layers:
            rec["reduced"] = (f"depth cut to {layers} of {full_layers} "
                              f"layers (full width): the full model does "
                              f"not fit one card")
        rec["prefill_kernels"] = {
            name: _check_forward_kernels(kept[i]) for name, i in first.items()}
        del kept
        gc.collect()
        torch.cuda.empty_cache()
        for name, r in rec["prefill_kernels"].items():
            if not r["ok"]:
                bad.append(f"{name}'s prefill kernels disagree with their "
                           f"plain versions: {r}")
        params = T.init_lm(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
        rng = np.random.default_rng(0)      # as serve_fixed draws them
        prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, p)),
                                  dtype=torch.int32, device="cuda")
        extras = S.stub_frontend_inputs(cfg, rng, b, "cuda")
        rec["profile"] = _profile_fixed_decode(cfg, params, prompts, extras)
        rec["teacher_forced_vs_lm_apply"] = _fixed_teacher_forced(
            cfg, params, list(prompts.cpu().numpy()), toks.tolist(), extras)
        if not rec["teacher_forced_vs_lm_apply"]["ok"]:
            bad.append("bf16: the fixed loop's teacher-forced logits are "
                       "not within tolerance of lm_apply's")
        del params, extras
        gc.collect()
        torch.cuda.empty_cache()
    rec["fp32"] = _cross_fp32(arch)
    if not rec["fp32"]["ok"]:
        bad.append(f"fp32: {rec['fp32']}")
    rec["ok"], rec["failures"] = not bad, bad
    emit(rec)
    if bad:
        raise SystemExit(f"{phase}: " + "; ".join(bad))
    return {k: sum(c[k] for c in counts) for k in _counts()}


def phase_train_encdec():
    """seamless-m4t-medium at full width and depth (AdamW, about 15.6 GB
    of weights, grads and moments), batch 2 × 4,096 decoder tokens plus
    1,024 stub frames a row (``train()``'s ``default_rng(0)`` draw): 3
    steps on ``flash`` with remat (counts zeroed just before, read just
    after), then on ``xla`` from the same weights and batches (losses
    within 2e-2); exact launches a step: the decoder's 12 MoBA layers
    launch centroids, Flash TopK and ``moba_fwd`` twice (forward and
    remat's recompute) and ``moba_bwd`` once, the encoder's 12 (not
    rematted, as in the reference) once each; the forward kernels of
    decoder layer 0 in step 1 held to their plain versions on its inputs
    (:func:`_check_forward_kernels`).  Then the fp32 loss and
    gradients, flash against xla, every leaf (the encoder's too) within
    5e-3 of its max (:func:`phase_train_grads`).  Returns the flash run's
    launches."""
    import torch
    from repro_torch.configs import get_config
    enc = _encoder_moba_layers(get_config(ENCDEC_ARCH))
    kept, unrecord = _record_flash_moba((enc,))   # decoder layer 0, step 1
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    try:
        cfg, state, losses, step_s = _train_run("flash", ENCDEC_TRAIN_STEPS,
                                                **ENCDEC_TRAIN)
    finally:
        unrecord()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state
    gc.collect()
    torch.cuda.empty_cache()
    forward_kernels = _check_forward_kernels(kept[enc])
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    _, state, xla_losses, xla_s = _train_run("xla", ENCDEC_TRAIN_STEPS,
                                             **ENCDEC_TRAIN)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    dec, enc = _moba_layers(cfg), _encoder_moba_layers(cfg)
    want = {"block_centroids": 2 * dec + enc, "flash_topk": 2 * dec + enc,
            "moba_fwd": 2 * dec + enc, "moba_bwd": dec + enc}
    gap = max(abs(a - b) for a, b in zip(losses, xla_losses))
    steady = float(np.median(step_s[1:]))
    tokens = ENCDEC_TRAIN["batch"] * ENCDEC_TRAIN["seq"]
    rec = {"phase": "train_encdec", "arch": cfg.name, "dtype": cfg.dtype,
           "layers": cfg.num_layers,
           "encoder_layers": cfg.num_encoder_layers,
           "params": _n_params(cfg), "batch": ENCDEC_TRAIN["batch"],
           "seq": ENCDEC_TRAIN["seq"], "frames": cfg.num_audio_frames,
           "remat": True, "backend": "flash", "losses": losses,
           "step_ms": [t * 1e3 for t in step_s],
           "median_step_ms_steps_2_3": steady * 1e3,
           "decoder_tokens_per_s": tokens / steady, "peak_mem_gib": peak,
           "launches": launches, "expected_per_step": want,
           "xla_losses": xla_losses, "xla_step_ms": [t * 1e3 for t in xla_s],
           "flash_vs_xla_max_loss_gap": gap,
           "flash_vs_xla_loss_tol": TRAIN_LOSS_TOL,
           "decoder_layer_0_forward_kernels": forward_kernels}
    emit(rec)
    if not forward_kernels["ok"]:
        raise SystemExit("train_encdec: decoder layer 0's forward kernels "
                         "disagree with their plain versions")
    if not all(np.isfinite(losses + xla_losses)):
        raise SystemExit(f"train_encdec: a loss is not finite: {losses} / "
                         f"{xla_losses}")
    for k, per_step in want.items():
        if launches[k] != per_step * ENCDEC_TRAIN_STEPS:
            raise SystemExit(f"train_encdec: {k} launched {launches[k]} "
                             f"times in {ENCDEC_TRAIN_STEPS} steps, "
                             f"expected {per_step} per step")
    if gap > TRAIN_LOSS_TOL:
        raise SystemExit(f"train_encdec: flash and xla losses differ by "
                         f"{gap} > {TRAIN_LOSS_TOL}: {losses} / "
                         f"{xla_losses}")
    phase_train_grads(arch=ENCDEC_ARCH, phase="train_encdec_grads")
    return launches


def phase_train_moe():
    """qwen2-moe-a2.7b at full width, 2 of its 24 layers (1.76 B params,
    AdamW), batch 1 × 4,096: 3 steps on ``flash`` with remat (counts
    zeroed just before, read just after), then on ``xla`` from the same
    weights and batches (losses within 2e-2); exact launches a step (4
    centroids, Flash TopK and ``moba_fwd``, forward and recompute, and 2
    ``moba_bwd``); step ms and peak memory.  Then the fp32 loss and
    gradients, flash against xla (:func:`phase_train_grads`).  Returns
    the flash run's launches."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    cfg, state, losses, step_s = _train_run("flash", MOE_TRAIN_STEPS,
                                            **MOE_TRAIN)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state
    gc.collect()
    torch.cuda.empty_cache()
    _, state, xla_losses, xla_s = _train_run("xla", MOE_TRAIN_STEPS,
                                             **MOE_TRAIN)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    ml = _moba_layers(cfg)
    want = {"block_centroids": 2 * ml, "flash_topk": 2 * ml,
            "moba_fwd": 2 * ml, "moba_bwd": ml}
    gap = max(abs(a - b) for a, b in zip(losses, xla_losses))
    steady = float(np.median(step_s[1:]))
    rec = {"phase": "train_moe", "arch": cfg.name, "dtype": cfg.dtype,
           "layers": cfg.num_layers, "batch": 1, "seq": MOE_TRAIN["seq"],
           "remat": True, "backend": "flash", "losses": losses,
           "step_ms": [t * 1e3 for t in step_s],
           "median_step_ms_steps_2_3": steady * 1e3,
           "tokens_per_s": MOE_TRAIN["seq"] / steady, "peak_mem_gib": peak,
           "launches": launches, "expected_per_step": want,
           "xla_losses": xla_losses, "xla_step_ms": [t * 1e3 for t in xla_s],
           "flash_vs_xla_max_loss_gap": gap,
           "flash_vs_xla_loss_tol": TRAIN_LOSS_TOL}
    emit(rec)
    if not all(np.isfinite(losses + xla_losses)):
        raise SystemExit(f"train_moe: a loss is not finite: {losses} / "
                         f"{xla_losses}")
    for k, per_step in want.items():
        if launches[k] != per_step * MOE_TRAIN_STEPS:
            raise SystemExit(f"train_moe: {k} launched {launches[k]} times "
                             f"in {MOE_TRAIN_STEPS} steps, expected "
                             f"{per_step} per step")
    if gap > TRAIN_LOSS_TOL:
        raise SystemExit(f"train_moe: flash and xla losses differ by {gap} "
                         f"> {TRAIN_LOSS_TOL}: {losses} / {xla_losses}")
    phase_train_grads(arch=MOE_ARCH, layers=MOE_TRAIN["layers"],
                      phase="train_moe_grads")
    return launches


def _bound(nbytes: float, flops: float, flops_rate: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_rate * 1e3
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _max_rel(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _topk_case(*, h, hkv, n, nq, d, dtype, seed, bs=128, top_k=8,
               tile=128, dv=None):
    """Random q, k, v on the card (v ``dv`` wide, default d), the
    centroids and the plain routing."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    q, k, v = rnd(1, h, nq, d, scale=0.5), rnd(1, hkv, n, d, scale=0.5), \
        rnd(1, hkv, n, dv or d)
    g = h // hkv
    kf = k.reshape(hkv, n, d)
    cents = ref.centroids_ref(kf, bs)
    tile = min(tile, nq)
    qf = ops.padded_queries(q, tile)
    sel = ref.flash_topk_ref(qf, cents, top_k, bs, group=g, num_q_heads=h,
                             q_pos_offset=n - nq)
    return dict(q=q, k=k, v=v, kf=kf, cents=cents, qf=qf, sel=sel,
                tile=tile, top_k=top_k, bs=bs, nb=-(-n // bs), g=g, h=h,
                n=n, nq=nq, gen=gen)


def _train_case(**kw):
    """``_topk_case`` and the sorted layout built from its routing, as
    ``kernels/ops.py`` builds it."""
    from repro_torch.kernels import ops
    c = _topk_case(**kw)
    n, bs = c["n"], c["bs"]
    lay, q_sorted, q_pos = ops.sorted_layout(c["qf"], c["sel"], c["nq"],
                                             c["nb"], c["tile"], n - c["nq"])
    c.update(lay=lay, q_sorted=q_sorted, q_pos=q_pos,
             k_blocks=ops.flatten_kv_blocks(c["k"], bs)[0],
             v_blocks=ops.flatten_kv_blocks(c["v"], bs)[0],
             kw=dict(scale=c["q"].shape[-1] ** -0.5, block_size=bs,
                     n_tokens=n, num_q_heads=c["h"], group=c["g"]))
    return c


def _masked_scores(q_rows, cent_rows, n: int, bs: int):
    """Plain causal routing scores of queries q_rows (BH, Nq, d), the
    suffix of n keys, against cent_rows (BH, nb, d): future blocks -1e30,
    the own block +1e30, and a sentinel column nb at -1e30."""
    import torch
    from repro_torch.core import routing
    nq = q_rows.shape[1]
    scores = routing.routing_scores(q_rows, cent_rows)       # (BH, Nq, nb)
    own = (torch.arange(nq, device=q_rows.device) + n - nq) // bs
    blk = torch.arange(scores.shape[-1], device=q_rows.device)
    masked = torch.where(blk[None] > own[:, None], routing.NEG_INF, scores)
    masked = torch.where(blk[None] == own[:, None], routing.POS_INF, masked)
    return torch.cat([masked, torch.full_like(masked[..., :1],
                                              routing.NEG_INF)], dim=-1)


def _canonical(masked, sel):
    """Selection ``sel`` as a sorted set of block ids, each id that
    ``masked`` scores -1e30 (a block in the query's future: padding,
    whose id depends on the key count) taken as the sentinel column."""
    import torch
    from repro_torch.core import routing
    x = sel.long()
    x = torch.where(masked.gather(-1, x) <= routing.NEG_INF / 2,
                    masked.shape[-1] - 1, x)
    return x.sort(-1).values


def _near_ties(masked, sel, ref_sel, tol: float = 1e-5):
    """Rows where selection ``sel`` differs from the plain ``ref_sel`` as a
    set (:func:`_canonical`), and the largest gap between the two rows'
    sorted selected scores.  A difference is a near-tie when every gap is
    <= tol·max(1, |s|)."""
    a, b = _canonical(masked, sel), _canonical(masked, ref_sel)
    got = masked.gather(-1, a).sort(-1, descending=True).values
    want = masked.gather(-1, b).sort(-1, descending=True).values
    gap = (got - want).abs()
    return (int((a != b).any(-1).sum()), float(gap.max()),
            bool((gap <= tol * want.abs().clamp(min=1.0)).all()))


def _swap_one_block(masked, sel):
    """``sel`` (rows, Nq, k) with one routing fault in the last query of
    row 0: its best-scoring selected block other than its own swapped for
    the worst-scoring unselected block of its past; None where that query
    selects every past block."""
    import torch
    from repro_torch.core import routing
    s, row = masked[0, -1], sel[0, -1].long()
    picked = torch.zeros_like(s, dtype=torch.bool)
    picked[row] = True
    past = (s > routing.NEG_INF / 2) & (s < routing.POS_INF / 2)
    if not bool((past & picked).any()) or not bool((past & ~picked).any()):
        return None
    best = int(torch.where(past & picked, s, -float("inf")).argmax())
    worst = int(torch.where(past & ~picked, s, float("inf")).argmin())
    out = sel.clone()
    out[0, -1, int((row == best).nonzero()[0, 0])] = worst
    return out


def _topk_near_ties(c, s_k):
    """Flash TopK's selection on case ``c`` against the plain routing."""
    from repro_torch.kernels import ref
    nq = c["nq"]
    qf = c["qf"][:, :nq]
    kv = ref.kv_rows(qf.shape[0], c["h"], c["g"], qf.device)
    masked = _masked_scores(qf, c["cents"][kv], c["n"], c["bs"])
    return _near_ties(masked, s_k[:, :nq], c["sel"][:, :nq])


def _do_dtype(KB, c):
    """The dO dtype the backward wrapper ``KB`` takes on case ``c``: q's
    where its ``check_contract`` accepts that (the tensor-core backward),
    else fp32 (the trees before it)."""
    import torch
    qs, lse = c["q_sorted"], torch.zeros(c["q_pos"].shape, device="cuda")
    do = qs[..., :c["v"].shape[-1]]
    try:
        KB.check_contract(qs, do, lse, lse, c["k_blocks"], c["v_blocks"],
                          c["lay"].tile_block, c["q_pos"], c["tile"], c["h"],
                          c["g"])
    except ValueError:
        return torch.float32
    return qs.dtype


def _check_flash_topk(c) -> dict:
    """Flash TopK on case ``c`` against the plain routing."""
    from repro_torch.kernels import flash_topk as KT
    s_k = KT.flash_topk(c["qf"], c["cents"], c["top_k"], c["bs"],
                        group=c["g"], num_q_heads=c["h"],
                        q_pos_offset=c["n"] - c["nq"], q_tile=c["tile"])
    rows, gap, ok = _topk_near_ties(c, s_k)
    return {"rows_differing": rows, "rows": s_k.shape[0] * c["nq"],
            "max_abs_err": gap, "ok": ok}


def _check_train_kernels(c, dtype) -> dict:
    """Each training kernel against its plain version on case ``c``."""
    import torch
    from repro_torch.kernels import centroids as KC, flash_topk as KT
    from repro_torch.kernels import moba_bwd as KB, moba_fwd as KF, ref
    bf16 = dtype == torch.bfloat16
    lay, kw = c["lay"], c["kw"]
    rec = {}
    cent = KC.block_centroids_kernel(c["kf"], c["bs"])
    tol = 1e-2 if bf16 else 1e-5
    rec["block_centroids"] = {
        "max_abs_err": float((cent.float() - c["cents"].float()).abs().max()),
        "tol": tol, "ok": bool(torch.allclose(cent.float(),
                                              c["cents"].float(), atol=tol,
                                              rtol=tol))}
    rec["flash_topk"] = _check_flash_topk(c)
    args = (lay.tile_block, c["q_sorted"], c["q_pos"], c["k_blocks"],
            c["v_blocks"])
    o_k = KF.moba_fwd(*args, q_tile=c["tile"], **kw)
    o_p = ref.moba_partials_ref(*args, **kw)
    tol = 3e-2 if bf16 else 2e-4
    rec["moba_fwd"] = {
        "max_abs_err": max(float((a - b).abs().max())
                           for a, b in zip(o_k, o_p)),
        "tol": tol, "ok": all(bool(torch.allclose(a, b, atol=tol, rtol=tol))
                              for a, b in zip(o_k, o_p))}
    # per-slot lse of the slot's own partial keeps p <= 1
    lse = (o_p[1].clamp(min=-5e29)
           + torch.log(o_p[2].clamp(min=1e-30)))
    do = torch.randn(c["q_sorted"].shape[:-1] + c["v"].shape[-1:],
                     generator=c["gen"], device="cuda").to(_do_dtype(KB, c))
    delta = torch.randn(lse.shape, generator=c["gen"], device="cuda") * 0.1
    bargs = (lay.tile_block, c["q_sorted"], c["q_pos"], do, lse, delta,
             c["k_blocks"], c["v_blocks"])
    g_k = KB.moba_bwd(*bargs, q_tile=c["tile"], **kw)
    g_again = KB.moba_bwd(*bargs, q_tile=c["tile"], **kw)
    g_p = ref.moba_bwd_ref(*bargs, **kw)
    tol = 3e-2 if bf16 else 5e-3
    rels = [_max_rel(a, b) for a, b in zip(g_k, g_p)]
    same = all(bool(torch.equal(a, b)) for a, b in zip(g_k, g_again))
    rec["moba_bwd"] = {
        "max_abs_err": max(float((a - b).abs().max())
                           for a, b in zip(g_k, g_p)),
        "max_rel_err": max(rels), "tol": tol, "do_dtype": str(do.dtype),
        "bit_equal_rerun": same, "ok": max(rels) <= tol and same}
    c.update(o_p=o_p, do=do, lse=lse, delta=delta)
    return rec


def _time_train_kernels(c, flush) -> dict:
    """Kernel alone, wrapper and plain version of each training kernel on
    case ``c`` (CUDA-event medians), with bytes, FLOPs and the bound from
    this case's tensors, and a library call where one exists."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import centroids as KC
    from repro_torch.kernels import moba_bwd as KB, moba_fwd as KF, ref
    lay, kw, tile, bs, d = c["lay"], c["kw"], c["tile"], c["bs"], \
        c["q"].shape[-1]
    rate = BF16_FLOPS if c["q"].dtype == torch.bfloat16 else FP32_FLOPS
    active = lay.tile_block < c["nb"]
    n_active = int(active.sum())
    kv = ref.kv_rows(lay.tile_block.shape[0], c["h"], c["g"], "cuda")
    # each (kv row, visited block) pair's K and V read once
    pairs = torch.unique((kv[:, None] * (c["nb"] + 1)
                          + lay.tile_block.long())[active]).numel()
    kv_bytes = 2 * pairs * bs * d * c["k"].element_size()
    out = {}

    def timed(name, kernel, wrapper, plain, bound, library=None,
              yardstick=None):
        out[name] = {**call_cost(wrapper, flush),
                     "kernel_only_ms": cuda_events_ms(kernel, flush=flush),
                     **call_cost(plain, flush, "plain_"),
                     **(call_cost(library, flush, "library_") if library
                        else {"library_ms": None}), **bound}
        if yardstick:
            out[name]["sdpa_yardstick_ms"] = cuda_events_ms(yardstick,
                                                            flush=flush)

    kf, nb = c["kf"], c["nb"]
    cent = c["cents"]

    def mean():
        return kf.view(kf.shape[0], nb, bs, d).mean(2)

    timed("block_centroids", lambda: KC.launch(kf, bs),
          lambda: KC.block_centroids_kernel(kf, bs),
          lambda: ref.centroids_ref(kf, bs),
          _bound(_nbytes(kf, cent), kf.numel(), FP32_FLOPS), library=mean)
    out["block_centroids"]["kernel_only_ms_clean_l2"] = cuda_events_ms(
        lambda: KC.launch(kf, bs), flush=flush, clean=True)
    # the kernel and the library mean under each placement of the spin
    out["block_centroids"]["by_hold"] = {
        f"{what}_{hold}": cuda_events_ms(fn, flush=flush, hold=hold)
        for what, fn in (("kernel", lambda: KC.launch(kf, bs)),
                         ("library", mean))
        for hold in ("first", "after_flush", "none")}
    out["flash_topk"] = _time_flash_topk(c, flush)
    args = (lay.tile_block, c["q_sorted"], c["q_pos"], c["k_blocks"],
            c["v_blocks"])
    fkw = {k: v for k, v in kw.items() if k != "block_size"}
    o, m, l = c["o_p"]
    q4 = c["q"]
    k4 = c["k"].repeat_interleave(c["g"], dim=1)
    v4 = c["v"].repeat_interleave(c["g"], dim=1)
    timed("moba_fwd",
          lambda: KF.launch(*args, q_tile=tile, kb_tile=min(bs, 128),
                            causal=True, **fkw),
          lambda: KF.moba_fwd(*args, q_tile=tile, **kw),
          lambda: ref.moba_partials_ref(*args, **kw),
          _bound(_nbytes(lay.tile_block, c["q_sorted"], c["q_pos"], o, m, l)
                 + kv_bytes, 4.0 * n_active * tile * bs * d, rate),
          yardstick=lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                           is_causal=True))
    tables = KB.segments(lay.tile_block, nb)
    bargs = (c["q_sorted"], c["q_pos"], c["do"], c["lse"], c["delta"],
             c["k_blocks"], c["v_blocks"])
    grad_bytes = 4 * (c["do"].numel()                         # dq, fp32
                      + 2 * lay.tile_block.shape[0] * nb * bs * d)  # dk, dv
    qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_g = torch.randn_like(sdpa_out)
    timed("moba_bwd",
          lambda: KB.launch(tables, *bargs, q_tile=tile, causal=True,
                            **fkw),
          lambda: KB.moba_bwd(lay.tile_block, *bargs, q_tile=tile, **kw),
          lambda: ref.moba_bwd_ref(lay.tile_block, *bargs, **kw),
          _bound(_nbytes(*tables, *bargs[:5]) + grad_bytes + kv_bytes,
                 10.0 * n_active * tile * bs * d, rate),
          yardstick=lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg),
                                                sdpa_g, retain_graph=True))
    # the launch alone with runs cut into segments of 4, 8 and 16 tiles
    out["moba_bwd"]["kernel_only_ms_by_run_tiles"] = {
        rt: cuda_events_ms(lambda t=KB.segments(lay.tile_block, nb, rt):
                           KB.launch(t, *bargs, q_tile=tile, causal=True,
                                     **fkw), flush=flush)
        for rt in (4, 8, 16)}
    out["moba_bwd"]["run_tiles"] = KB.RUN_TILES
    return out


def _time_flash_topk(c, flush, full: bool = True, reps: int = 25) -> dict:
    """Flash TopK on case ``c``: the launch alone (median of ``reps``), the
    bound (bytes: q, centroids and the ids once; FLOPs: 2·d a scored
    (query, block) pair); with ``full``, also ``call_cost`` of the wrapper
    and of the plain version, and as a yardstick — not the same function:
    ``torch.topk`` promises no tie order — ``torch.topk`` over the masked
    ``torch.bmm`` scores."""
    import torch
    from repro_torch.kernels import flash_topk as KT, ref
    qf, cent, bs, tk, nb = c["qf"], c["cents"], c["bs"], c["top_k"], c["nb"]
    d = qf.shape[-1]
    off = c["n"] - c["nq"]
    rate = BF16_FLOPS if qf.dtype == torch.bfloat16 else FP32_FLOPS
    # the kernel scores every block before the query's own (causal)
    pos = torch.arange(qf.shape[1], device="cuda") + off
    own = pos // bs
    scored = float(own.clamp(max=nb).sum()) * qf.shape[0]
    rec = {"kernel_only_ms": cuda_events_ms(lambda: KT.launch(
               qf, cent, tk, bs, group=c["g"], causal=True,
               q_pos_offset=off), reps=reps, flush=flush),
           "shape": {"bh": qf.shape[0], "nq": qf.shape[1], "nb": nb,
                     "d": d, "block_size": bs, "top_k": tk,
                     "dtype": str(qf.dtype)},
           **_bound(_nbytes(qf, cent, c["sel"]), 2 * d * scored, rate)}
    if not full:
        return rec
    cent_rows = cent[ref.kv_rows(qf.shape[0], c["h"], c["g"], "cuda")]
    blk = torch.arange(nb, device="cuda")
    future, is_own = blk[None] > own[:, None], blk[None] == own[:, None]

    def yardstick():
        sc = torch.bmm(qf, cent_rows.transpose(1, 2)).float()
        sc = sc.masked_fill(future, float("-inf")).masked_fill(
            is_own, float("inf"))
        return torch.topk(sc, min(tk, nb), dim=-1)

    return {**call_cost(lambda: KT.flash_topk(
                qf, cent, tk, bs, group=c["g"], num_q_heads=c["h"],
                q_pos_offset=off, q_tile=c["tile"]), flush),
            **rec,
            **call_cost(lambda: ref.flash_topk_ref(
                qf, cent, tk, bs, group=c["g"], num_q_heads=c["h"],
                q_pos_offset=off), flush, "plain_"),
            "library_ms": None,
            **call_cost(yardstick, flush, "topk_yardstick_")}


def _flash_vs_xla(c) -> dict:
    """``flash_moba`` forward and grads against the ``xla`` path on case
    ``c`` (fp32).  Rows whose Flash TopK routing differs from the plain
    routing (near-ties) get a zero upstream gradient and are left out of
    the forward comparison, so both sides see the same function."""
    import torch
    from repro_torch.configs.base import MoBAConfig
    from repro_torch.kernels import flash_topk as KT, ops, ref
    cfg = MoBAConfig(block_size=c["bs"], top_k=c["top_k"])
    b, h, nq, d = c["q"].shape
    s_k = KT.flash_topk(c["qf"], c["cents"], c["top_k"], c["bs"],
                        group=c["g"], num_q_heads=h,
                        q_pos_offset=c["n"] - nq, q_tile=c["tile"])
    same = ~(s_k[:, :nq] != c["sel"][:, :nq]).any(-1)        # (BH, Nq)
    same = same.reshape(b, h, nq, 1)
    g_out = torch.randn(c["q"].shape, generator=c["gen"],
                        device="cuda") * same
    res = {}
    for name, fn in (("flash", ops.flash_moba), ("xla", ref.moba_sparse_xla)):
        qkv = [x.detach().requires_grad_() for x in (c["q"], c["k"], c["v"])]
        o = fn(*qkv, cfg)
        res[name] = (o.detach(), torch.autograd.grad(o, qkv, g_out))
    (o_f, g_f), (o_x, g_x) = res["flash"], res["xla"]
    fwd_err = float(((o_f - o_x) * same).abs().max())
    rels = [_max_rel(a, b) for a, b in zip(g_f, g_x)]
    return {"rows_left_out": int((~same).sum()), "fwd_max_abs_err": fwd_err,
            "grad_max_rel_err": max(rels), "fwd_tol": 2e-4, "grad_tol": 5e-3,
            "ok": fwd_err <= 2e-4 + 2e-4 * float(o_x.abs().max())
            and max(rels) <= 5e-3}


def _time_flash_moba(c, flush) -> dict:
    """``flash_moba`` forward and forward+backward against causal SDPA at
    the same shape (a yardstick: dense attention, not the same
    function)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import MoBAConfig
    from repro_torch.kernels import ops
    cfg = MoBAConfig(block_size=c["bs"], top_k=c["top_k"])
    g = c["g"]
    qkv = [x.detach().requires_grad_() for x in (c["q"], c["k"], c["v"])]
    dense = [x.detach().requires_grad_() for x in (
        c["q"], c["k"].repeat_interleave(g, 1),
        c["v"].repeat_interleave(g, 1))]
    grad = torch.randn_like(c["q"])

    def fwd_bwd(fn, xs):
        torch.autograd.grad(fn(*xs), xs, grad)

    with torch.no_grad():
        fwd = cuda_events_ms(lambda: ops.flash_moba(c["q"], c["k"], c["v"],
                                                    cfg), flush=flush)
        sdpa = cuda_events_ms(lambda: F.scaled_dot_product_attention(
            *dense, is_causal=True), flush=flush)
    return {"flash_moba_fwd_ms": fwd,
            "flash_moba_fwd_bwd_ms": cuda_events_ms(
                lambda: fwd_bwd(lambda *x: ops.flash_moba(*x, cfg), qkv),
                flush=flush),
            "sdpa_causal_fwd_ms_yardstick": sdpa,
            "sdpa_causal_fwd_bwd_ms_yardstick": cuda_events_ms(
                lambda: fwd_bwd(lambda *x: F.scaled_dot_product_attention(
                    *x, is_causal=True), dense), flush=flush)}


def _tensor_core_audit(phase: str, libs) -> dict:
    """Per kernel function of the built libraries ``libs``: registers and
    stack bytes (``cuobjdump -res-usage``; a spill needs a stack frame)
    and the count of tensor-core instructions in its SASS
    (``HMMA``/``HGMMA``, ``cuobjdump -sass``).  Fails if a bf16
    instantiation (``*_mma<D, ...>``, or ``flash_topk_kernel<bf16,
    ...>``) has none, if an ``*_mma`` one has a stack frame at d 64, or
    if a library shows no bf16 instantiation."""
    import re
    from repro_torch.kernels import runtime
    tool = os.path.join(os.path.dirname(runtime.nvcc_path()), "cuobjdump")
    funcs = {}
    for lib in libs:
        path = str(runtime.library_path(lib))
        for flag in ("-res-usage", "-sass"):
            text = subprocess.run([tool, flag, path], capture_output=True,
                                  text=True, timeout=300, check=True).stdout
            cur = None
            for ln in text.splitlines():
                m = re.search(r"Function\s*:?\s*(\w+)", ln)
                if m:
                    cur = funcs.setdefault(m.group(1), {"library": lib,
                                                        "tensor_core": 0})
                    continue
                m = re.search(r"REG:(\d+) STACK:(\d+)", ln)
                if m and cur is not None:
                    cur["registers"] = int(m.group(1))
                    cur["stack_bytes"] = int(m.group(2))
                if flag == "-sass" and cur is not None and \
                        re.search(r"\bHG?MMA\b", ln):
                    cur["tensor_core"] += 1
    bf16 = {n: f for n, f in funcs.items()
            if re.search(r"_mmaILi\d+E|flash_topk_kernelI13__nv_bfloat16", n)}
    bad = [n for n, f in bf16.items()
           if not f["tensor_core"] or (
               re.search(r"_mmaILi64E", n) and f.get("stack_bytes", 1) != 0)]
    rec = {"functions": funcs, "bf16_functions": len(bf16),
           "ok": {f["library"] for f in bf16.values()} == set(libs)
           and not bad}
    if not rec["ok"]:
        emit({"phase": phase, "tensor_core_audit": rec})
        raise SystemExit(f"{phase}: a bf16 kernel of {list(libs)} has no "
                         f"tensor-core instruction, or an mma one spills at "
                         f"d 64 (or none was found): {bad or sorted(funcs)}")
    return rec


def phase_train_kernels():
    import torch
    audit = _tensor_core_audit("train_kernels",
                               ("flash_topk", "moba_fwd", "moba_bwd"))
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    geoms = [("moba-340m", dict(h=16, hkv=16, n=TRAIN_SEQ, nq=TRAIN_SEQ,
                                d=64), (torch.bfloat16, torch.float32)),
             ("g2-d128", dict(h=16, hkv=8, n=4096, nq=4096, d=128),
              (torch.bfloat16, torch.float32)),
             ("g1-d128", dict(h=16, hkv=16, n=4096, nq=4096, d=128),
              (torch.bfloat16, torch.float32)),
             ("g8-d128", dict(h=64, hkv=8, n=4096, nq=4096, d=128),
              (torch.bfloat16,)),
             ("ragged-n", dict(h=16, hkv=16, n=8000, nq=8000, d=64),
              (torch.bfloat16,)),
             ("suffix-nq", dict(h=16, hkv=16, n=TRAIN_SEQ, nq=1000, d=64),
              (torch.bfloat16,)),
             ("small-blocks", dict(h=16, hkv=16, n=TRAIN_SEQ, nq=TRAIN_SEQ,
                                   d=64, bs=32, top_k=32),
              (torch.bfloat16, torch.float32)),
             ("block-512", dict(h=16, hkv=16, n=TRAIN_SEQ, nq=TRAIN_SEQ,
                                d=64, bs=512, top_k=2), (torch.bfloat16,)),
             ("block-512-d128", dict(h=16, hkv=8, n=4096, nq=4096, d=128,
                                     bs=512, top_k=2), (torch.bfloat16,)),
             ("top_k-16", dict(h=16, hkv=16, n=TRAIN_SEQ, nq=TRAIN_SEQ,
                               d=64, bs=64, top_k=16), (torch.bfloat16,)),
             ("top_k-64", dict(h=16, hkv=16, n=4096, nq=4096, d=64, bs=16,
                               top_k=64), (torch.bfloat16, torch.float32))]
    checks, timing, main_err, topk_more = [], None, {}, {}
    for name, geom, dtypes in geoms:
        for dtype in dtypes:
            c = _train_case(dtype=dtype, seed=11, **geom)
            rec = _check_train_kernels(c, dtype)
            torch.cuda.synchronize()
            checks.append({"geometry": name, "dtype": str(dtype), **rec})
            if not all(r["ok"] for r in rec.values()):
                emit({"phase": "train_kernels", "checks": checks})
                raise SystemExit(f"train_kernels: a kernel disagrees with "
                                 f"its plain version: {checks[-1]}")
            if name == "moba-340m" and dtype == torch.bfloat16:
                main_err = {k: r["max_abs_err"] for k, r in rec.items()}
                timing = _time_train_kernels(c, flush)
                timing["flash_moba"] = _time_flash_moba(c, flush)
            if name == "g1-d128" and dtype == torch.bfloat16:
                g1 = _time_train_kernels(c, flush)
            if name == "g8-d128":
                g8 = _time_train_kernels(c, flush)
            if name == "small-blocks" and dtype == torch.bfloat16:
                small_topk = _time_flash_topk(c, flush)
            if name.startswith("top_k-") and dtype == torch.bfloat16:
                topk_more[name] = _time_flash_topk(c, flush, full=False)
            if name == "moba-340m" and dtype == torch.float32:
                vs_xla = _flash_vs_xla(c)
                if not vs_xla["ok"]:
                    emit({"phase": "train_kernels", "checks": checks,
                          "flash_vs_xla": vs_xla})
                    raise SystemExit(f"train_kernels: flash_moba disagrees "
                                     f"with the xla path: {vs_xla}")
            del c
            torch.cuda.empty_cache()
    # Flash TopK alone at its limit, top_k 1024 (shared-memory lists, 16
    # rows a CTA): one head, so the plain routing's scores stay 0.27 GB
    c = _topk_case(h=1, hkv=1, n=32768, nq=32768, d=64,
                   dtype=torch.bfloat16, seed=11, bs=16, top_k=1024)
    rec = {"flash_topk": _check_flash_topk(c)}
    checks.append({"geometry": "top_k-1024", "dtype": str(c["q"].dtype),
                   **rec})
    if not rec["flash_topk"]["ok"]:
        emit({"phase": "train_kernels", "checks": checks})
        raise SystemExit(f"train_kernels: Flash TopK disagrees with the "
                         f"plain routing: {checks[-1]}")
    topk_more["top_k-1024"] = _time_flash_topk(c, flush, full=False, reps=5)
    del c
    torch.cuda.empty_cache()
    timing["flash_topk_small_blocks"] = small_topk
    timing["flash_topk_more"] = topk_more
    timing["g1-d128"] = g1
    timing["g8-d128"] = g8
    emit({"phase": "train_kernels", "tensor_core_audit": audit,
          "checks": checks, "flash_vs_xla": vs_xla, "timing": timing})
    return timing, main_err


# ------------------------------------------- latent attention (q/k 192, v 128)
MLA_GEOM = dict(h=16, hkv=16, n=TRAIN_SEQ, nq=TRAIN_SEQ, d=192, dv=128)


def _mla_functions(audit: dict) -> dict:
    """The audit's q/k 192 instantiations: registers, stack bytes and
    tensor-core instructions."""
    return {n: f for n, f in audit["functions"].items() if "192" in n}


def _time_mla_kernels(c, flush) -> dict:
    """Each training kernel alone and through its wrapper at q/k 192 / v
    128 (CUDA-event medians), with the bytes and FLOPs of this case and
    the bound they give: each tensor read or written once; the forward
    2·(d_qk + d_v) FLOPs a query slot and key of its block, the backward
    2·(2·d_qk + 3·d_v) (S and dP recomputed, dV, dK, dQ)."""
    from repro_torch.kernels import centroids as KC, flash_topk as KT
    from repro_torch.kernels import moba_bwd as KB, moba_fwd as KF, ref
    lay, kw, tile, bs = c["lay"], c["kw"], c["tile"], c["bs"]
    dqk, dv = c["q"].shape[-1], c["v"].shape[-1]
    kf, qf, cents = c["kf"], c["qf"], c["cents"]
    args = (lay.tile_block, c["q_sorted"], c["q_pos"], c["k_blocks"],
            c["v_blocks"])
    bargs = (c["q_sorted"], c["q_pos"], c["do"], c["lse"], c["delta"],
             c["k_blocks"], c["v_blocks"])
    tables = KB.segments(lay.tile_block, c["nb"])
    slots = int((lay.q_index >= 0).sum())        # (query, block) pairs
    keys = slots * bs                            # at most, causal aside
    q_b = _nbytes(c["q"])
    kv_b = _nbytes(c["k"]) + _nbytes(c["v"])
    o_b = q_b // dqk * dv
    launch_kw = {k: kw[k] for k in ("scale", "n_tokens", "num_q_heads",
                                    "group")}
    cases = {
        "block_centroids": (
            lambda: KC.launch(kf, bs),
            lambda: KC.block_centroids_kernel(kf, bs),
            _bound(_nbytes(kf, cents), kf.numel(), FP32_FLOPS)),
        "flash_topk": (
            lambda: KT.launch(qf, cents, c["top_k"], bs, group=c["g"],
                              causal=True, q_pos_offset=c["n"] - c["nq"]),
            lambda: KT.flash_topk(qf, cents, c["top_k"], bs, group=c["g"],
                                  num_q_heads=c["h"],
                                  q_pos_offset=c["n"] - c["nq"]),
            _bound(_nbytes(qf, cents), qf.numel() * cents.shape[1],
                   BF16_FLOPS)),
        "moba_fwd": (
            lambda: KF.launch(*args, q_tile=tile, kb_tile=bs, causal=True,
                              **launch_kw),
            lambda: KF.moba_fwd(*args, q_tile=tile, **kw),
            _bound(q_b + kv_b + o_b, keys * 2 * (dqk + dv), BF16_FLOPS)),
        "moba_bwd": (
            lambda: KB.launch(tables, *bargs, q_tile=tile, causal=True,
                              **launch_kw),
            lambda: KB.moba_bwd(lay.tile_block, *bargs, q_tile=tile, **kw),
            _bound(2 * (q_b + kv_b) + 2 * o_b, keys * 2 * (2 * dqk + 3 * dv),
                   BF16_FLOPS)),
    }
    out = {"shape": {"rows": c["q_sorted"].shape[0], "n": c["n"],
                     "d_qk": dqk, "d_v": dv, "block": bs,
                     "top_k": c["top_k"], "dtype": str(c["q"].dtype)}}
    for name, (kernel, wrapper, bound) in cases.items():
        out[name] = {"kernel_only_ms": cuda_events_ms(kernel, flush=flush),
                     **call_cost(wrapper, flush), **bound}
    out["moba_fwd"]["plain_ms"] = cuda_events_ms(
        lambda: ref.moba_partials_ref(*args, **kw), reps=3)
    return out


def _flash_moba_vs_dense(dtype, seed: int = 5, n: int = 4096) -> dict:
    """``flash_moba`` at q/k 192 / v 128 (the kernels) against autograd of
    masked dense attention on the kernels' own selections, in fp32 from
    the same inputs: the output and dq, dk, dv, each as max |err| / max
    |ref|."""
    import torch
    from repro_torch.configs.base import MoBAConfig
    from repro_torch.core.moba import moba_selection
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, bs = 16, 128
    cfg = MoBAConfig(block_size=bs, top_k=8)
    q, k = (torch.randn(1, h, n, 192, generator=gen, device="cuda") * 0.5
            for _ in range(2))
    v = torch.randn(1, h, n, 128, generator=gen, device="cuda")
    g = torch.randn(1, h, n, 128, generator=gen, device="cuda")
    xs = [x.to(dtype).requires_grad_() for x in (q, k, v)]
    out = ops.flash_moba(*xs, cfg)
    grads = torch.autograd.grad(out, xs, g.to(dtype))
    with torch.no_grad():
        sel = moba_selection(xs[0], xs[1], cfg, torch.arange(
            n, device="cuda")).long()
    nb = n // bs
    blk = torch.zeros(1, h, n, nb + 1, dtype=torch.bool, device="cuda")
    blk.scatter_(-1, sel.clamp(max=nb), True)
    pos = torch.arange(n, device="cuda")
    mask = blk[..., :nb].repeat_interleave(bs, -1) & (pos[None]
                                                       <= pos[:, None])
    ref_x = [x.detach().float().requires_grad_() for x in xs]
    s = (ref_x[0] @ ref_x[1].transpose(-1, -2)) * 192 ** -0.5
    ref = torch.softmax(s.masked_fill(~mask, -float("inf")), -1) @ ref_x[2]
    ref_g = torch.autograd.grad(ref, ref_x, g)
    rec = {"out": _max_rel(out, ref)}
    rec.update({f"d{nm}": _max_rel(a, b)
                for nm, a, b in zip("qkv", grads, ref_g)})
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    return {"n": n, "dtype": str(dtype), "max_rel_err": rec, "tol": tol,
            "ok": max(rec.values()) <= tol}


def phase_train_mla_kernels():
    """The four FlashMoBA kernels at latent attention's widths (q/k 192,
    v 128: Moonlight-16B-A3B's heads) against their plain versions, in
    bf16 (tensor cores) and fp32 (SIMT), at 16 heads x 8,192, block 128,
    top_k 8: errors, each wrapper's launches, the bf16 backward's
    bit-equal rerun; ``flash_moba`` end to end against autograd of
    masked dense attention; registers and spills of every 192
    instantiation; the first card timings."""
    import torch
    from repro_torch.kernels import (centroids, flash_topk, moba_bwd,
                                     moba_fwd)
    audit = _tensor_core_audit("train_mla_kernels",
                               ("flash_topk", "moba_fwd", "moba_bwd"))
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    mods = {"block_centroids": centroids, "flash_topk": flash_topk,
            "moba_fwd": moba_fwd, "moba_bwd": moba_bwd}
    checks, timing = [], None
    for dtype in (torch.bfloat16, torch.float32):
        c = _train_case(dtype=dtype, seed=11, **MLA_GEOM)
        before = {k: m.LAUNCHES for k, m in mods.items()}
        rec = _check_train_kernels(c, dtype)
        torch.cuda.synchronize()
        launched = {k: m.LAUNCHES - before[k] for k, m in mods.items()}
        checks.append({"dtype": str(dtype), "launches": launched, **rec})
        if not all(r["ok"] for r in rec.values()) or launched != {
                "block_centroids": 1, "flash_topk": 1, "moba_fwd": 1,
                "moba_bwd": 2}:
            emit({"phase": "train_mla_kernels", "checks": checks})
            raise SystemExit(f"train_mla_kernels: a kernel disagrees "
                             f"with its plain version: {checks[-1]}")
        if dtype == torch.bfloat16:
            timing = _time_mla_kernels(c, flush)
        del c
        torch.cuda.empty_cache()
    dense = [_flash_moba_vs_dense(dt) for dt in (torch.float32,
                                                 torch.bfloat16)]
    rec = {"phase": "train_mla_kernels", "geometry": MLA_GEOM,
           "functions_192": _mla_functions(audit), "checks": checks,
           "vs_dense_autograd": dense, "timing": timing}
    emit(rec)
    if not all(x["ok"] for x in dense):
        raise SystemExit(f"train_mla_kernels: flash_moba at 192/128 "
                         f"disagrees with dense autograd: {dense}")
    return rec


def phase_train_mla(steps: int = 3, rows: int = 4, microbatch: int = 2):
    """Moonlight-16B-A3B at its published widths and depth, one chip's
    share (8 of 64 experts, 20,480 ids), through ``make_train_step`` on
    ``flash`` with remat: ``rows`` x 8,192 a step in ``microbatch``
    chunks, bf16, ``steps`` steps.  Losses, step seconds, exact launches
    a step (each attention layer's centroids, Flash TopK and forward
    twice a microbatch under remat, its backward once), the routing
    counters and the peak memory."""
    import math

    import torch
    from repro_torch.configs import moonlight_16b_a3b as ML
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps as S
    from repro_torch.models import moe, transformer as T
    from repro_torch.optim import adamw
    cfg = ML.get_config(held_count=8, vocab_size=20480)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_latent_lm(torch.Generator(device="cuda").manual_seed(0),
                              cfg)
    state = T.init_router_state(cfg, "cuda")
    opt = adamw.adamw_init(params)
    n_params = sum(p.numel() for _, p in adamw.tree_leaves(params))
    tcfg = TrainConfig(global_batch_size=rows, seq_len=TRAIN_SEQ,
                       microbatch=microbatch)
    step = S.make_train_step(cfg, tcfg, backend="flash", remat=True,
                             state=state)
    gen = torch.Generator(device="cuda").manual_seed(1)
    losses, step_s, per_step, retaken = [], [], [], []
    counts = torch.zeros_like(state["expert_counts"])
    for _ in range(steps):
        tok = torch.randint(0, cfg.vocab_size, (rows, TRAIN_SEQ + 1),
                            generator=gen, device="cuda")
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, out = step(params, opt, {"tokens": tok})
        losses.append(float(out["loss"]))
        step_s.append(time.perf_counter() - t0)
        per_step.append(_counts())
        retaken.append(out["retaken"])
        counts += out["expert_counts"]
    layers = cfg.num_layers * microbatch
    want = {"block_centroids": 2 * layers, "flash_topk": 2 * layers,
            "moba_fwd": 2 * layers, "moba_bwd": layers, "swa": 0,
            "swa_bwd": 0}
    routing = moe.routing_counters(counts, state["router_bias"],
                                   cfg.held_experts)
    routing.pop("held_by_layer")
    rec = {"phase": "train_mla", "params": n_params, "losses": losses,
           "step_s": step_s, "launches": per_step[-1], "want": want,
           "routing": routing, "retaken": retaken,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(rec)
    if any(c != {k: v * (1 + r) for k, v in want.items()}
           for c, r in zip(per_step, retaken)) or not all(
            math.isfinite(x) for x in losses):
        raise SystemExit(f"train_mla: launches {per_step} (want {want}) "
                         f"or losses {losses}")
    return rec


# ------------------------------------------------------------------ phase 6
def _counts():
    from repro_torch.kernels import (centroids, flash_topk, moba_bwd,
                                     moba_fwd, swa)
    return {"block_centroids": centroids.LAUNCHES,
            "flash_topk": flash_topk.LAUNCHES, "moba_fwd": moba_fwd.LAUNCHES,
            "moba_bwd": moba_bwd.LAUNCHES, "swa": swa.LAUNCHES,
            "swa_bwd": swa.BWD_LAUNCHES}


def _zero_counts():
    from repro_torch.kernels import (centroids, flash_topk, moba_bwd,
                                     moba_fwd, swa)
    for mod in (centroids, flash_topk, moba_fwd, moba_bwd, swa):
        mod.LAUNCHES = 0
    swa.BWD_LAUNCHES = 0


def _train_run(backend: str, steps: int = TRAIN_STEPS, *,
               arch: str = "moba-340m", layers: int = 0,
               seq: int = TRAIN_SEQ, batch: int = 1, remat: bool = True,
               **moba):
    """``arch`` (moba-340m) at full width and depth, or ``layers`` deep
    (bf16, random weights from a seeded torch.Generator), ``batch`` rows
    (1) of seq ``seq`` (8192), with the stub inputs ``train()`` draws for
    the vision and encoder-decoder families: ``steps`` steps of
    ``make_train_step`` with ``remat`` (on) on ``backend``, from the same
    weights and batches on every call; ``moba`` (block_size, top_k,
    key_conv_width) overrides the config's MoBA settings.  Returns the
    state for one more step, each step's loss and seconds (each loss read
    waits for its step)."""
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    cfg = get_config(arch, **moba)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    tcfg = TrainConfig(global_batch_size=batch, seq_len=seq,
                       total_steps=TRAIN_STEPS + 1, warmup_steps=1)
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adamw.adamw_init(params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=seq, global_batch=batch, seed=0))
    extras = S.stub_frontend_inputs(cfg, np.random.default_rng(0), batch,
                                    "cuda")
    batches = [{"tokens": torch.as_tensor(data.batch_at(i)["tokens"],
                                          device="cuda"), **extras}
               for i in range(TRAIN_STEPS + 1)]
    step_fn = S.make_train_step(cfg, tcfg, backend=backend, remat=remat)
    torch.cuda.synchronize()
    losses, step_s = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batches[i])
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    return cfg, (step_fn, params, opt, batches[steps]), losses, step_s


def phase_train():
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    cfg, (step_fn, params, opt, batch), losses, step_s = _train_run("flash")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        wall = time.perf_counter() - t0
    del step_fn, params, opt, batch
    torch.cuda.empty_cache()
    # the same steps on xla (TRAIN_LOSS_TOL says why they may differ)
    _, _, xla_losses, xla_s = _train_run("xla")
    torch.cuda.empty_cache()
    loss_gap = max(abs(a - b) for a, b in zip(losses, xla_losses))
    steady = float(np.median(step_s[1:]))
    want = {"block_centroids": 2 * MOBA_LAYERS, "flash_topk": 2 * MOBA_LAYERS,
            "moba_fwd": 2 * MOBA_LAYERS, "moba_bwd": MOBA_LAYERS,
            "swa": 2 * SWA_LAYERS, "swa_bwd": SWA_LAYERS}
    rec = {"phase": "train", "arch": cfg.name, "dtype": cfg.dtype,
           "batch": 1, "seq": TRAIN_SEQ, "remat": True, "backend": "flash",
           "losses": losses, "step_ms": [t * 1e3 for t in step_s],
           "median_step_ms_steps_2_4": steady * 1e3,
           "tokens_per_s": TRAIN_SEQ / steady, "peak_mem_gib": peak,
           "launches": launches,
           "launches_per_step": {k: v / TRAIN_STEPS
                                 for k, v in launches.items()},
           "expected_per_step": want,
           "xla_losses": xla_losses, "xla_step_ms": [t * 1e3 for t in xla_s],
           "flash_vs_xla_max_loss_gap": loss_gap,
           "flash_vs_xla_loss_tol": TRAIN_LOSS_TOL,
           "profile": _profile_summary(prof, wall, 1)}
    emit(rec)
    if not all(np.isfinite(losses + xla_losses)):
        raise SystemExit(f"train: a loss is not finite: {losses} / "
                         f"{xla_losses}")
    for k, per_step in want.items():
        if launches[k] != per_step * TRAIN_STEPS:
            raise SystemExit(f"train: {k} launched {launches[k]} times in "
                             f"{TRAIN_STEPS} steps, expected {per_step} "
                             f"per step")
    if loss_gap > TRAIN_LOSS_TOL:
        raise SystemExit(f"train: flash and xla losses differ by "
                         f"{loss_gap} > {TRAIN_LOSS_TOL}: {losses} / "
                         f"{xla_losses}")
    return launches, rec


def phase_train_small_blocks(steps: int = 3):
    """The paper's small-block setting on the same model: block 32, top_k
    32 (the same 1,024 keys a query as block 128, top_k 8), 3 steps on
    ``flash``: finite losses, exact launch counts, step ms, peak memory.
    The counts are zeroed just before this run and read just after."""
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    cfg, _, losses, step_s = _train_run("flash", steps, block_size=32,
                                        top_k=32)
    launches = _counts()
    want = {"block_centroids": 2 * MOBA_LAYERS, "flash_topk": 2 * MOBA_LAYERS,
            "moba_fwd": 2 * MOBA_LAYERS, "moba_bwd": MOBA_LAYERS,
            "swa": 2 * SWA_LAYERS, "swa_bwd": SWA_LAYERS}
    rec = {"phase": "train_small_blocks", "arch": cfg.name,
           "block_size": 32, "top_k": 32, "batch": 1, "seq": TRAIN_SEQ,
           "remat": True, "backend": "flash", "losses": losses,
           "step_ms": [t * 1e3 for t in step_s],
           "median_step_ms_steps_2_3": float(np.median(step_s[1:])) * 1e3,
           "tokens_per_s": TRAIN_SEQ / float(np.median(step_s[1:])),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "expected_per_step": want}
    emit(rec)
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        raise SystemExit(f"train_small_blocks: a loss is not finite: "
                         f"{losses}")
    for k, per_step in want.items():
        if launches[k] != per_step * steps:
            raise SystemExit(f"train_small_blocks: {k} launched "
                             f"{launches[k]} times in {steps} steps, "
                             f"expected {per_step} per step")
    return rec


def phase_train_key_conv(train_rec: dict, steps: int = 3):
    """moba-340m-kconv3 at full width and depth, phase 6's batches, 3
    steps on ``flash`` with remat (counts zeroed just before, read just
    after): finite losses, phase 6's launch counts, every MoBA layer's
    ``key_conv`` gradient finite and nonzero in every step, the conv
    weights moved; step ms, tokens/s and peak memory beside phase 6's.
    Then the same steps on ``xla``: each loss within TRAIN_LOSS_TOL."""
    import torch
    from repro_torch.optim import adamw
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    update, grads, start = adamw.adamw_update, [], {}

    def recording(params, g, state, tcfg, lr_fn=None):
        """The step's own update, keeping the conv leaves' gradients and
        (on the first step) weights."""
        if not start:
            start.update({p: x.detach().clone() for p, x in
                          adamw.tree_leaves(params) if p.endswith("key_conv")})
        grads.append({p: x.detach().clone() for p, x in adamw.tree_leaves(g)
                      if p.endswith("key_conv")})
        return update(params, g, state, tcfg, lr_fn)

    adamw.adamw_update = recording
    try:
        _zero_counts()
        cfg, (_, params, _, _), losses, step_s = _train_run(
            "flash", steps, key_conv_width=KEY_CONV_WIDTH)
        launches = _counts()
    finally:
        adamw.adamw_update = update
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    leaves = dict(adamw.tree_leaves(params))
    moved = {p: [float(x) for x in
                 (leaves[p].detach() - w).flatten(1).abs().amax(1)]
             for p, w in start.items()}
    grad_max = [{p: [float(x) for x in g.flatten(1).abs().amax(1)]
                 for p, g in step.items()} for step in grads]
    grads_ok = bool(grads) and all(
        torch.isfinite(g).all() and (g.flatten(1).abs().amax(1) > 0).all()
        for step in grads for g in step.values())
    del params, leaves, start, grads
    torch.cuda.empty_cache()
    _, _, xla_losses, xla_s = _train_run("xla", steps,
                                         key_conv_width=KEY_CONV_WIDTH)
    torch.cuda.empty_cache()
    loss_gap = max(abs(a - b) for a, b in zip(losses, xla_losses))
    steady = float(np.median(step_s[1:]))
    want = {"block_centroids": 2 * MOBA_LAYERS, "flash_topk": 2 * MOBA_LAYERS,
            "moba_fwd": 2 * MOBA_LAYERS, "moba_bwd": MOBA_LAYERS,
            "swa": 2 * SWA_LAYERS, "swa_bwd": SWA_LAYERS}
    rec = {"phase": "train_key_conv", "arch": cfg.name, "dtype": cfg.dtype,
           "batch": 1, "seq": TRAIN_SEQ, "remat": True, "backend": "flash",
           "losses": losses, "step_ms": [t * 1e3 for t in step_s],
           "median_step_ms_steps_2_3": steady * 1e3,
           "tokens_per_s": TRAIN_SEQ / steady, "peak_mem_gib": peak,
           "train_phase": {k: train_rec[k] for k in (
               "median_step_ms_steps_2_4", "tokens_per_s", "peak_mem_gib")},
           "launches": launches, "expected_per_step": want,
           "key_conv_grad_max_per_layer": grad_max,
           "key_conv_grads_finite_nonzero": grads_ok,
           "key_conv_moved_per_layer": moved,
           "xla_losses": xla_losses, "xla_step_ms": [t * 1e3 for t in xla_s],
           "flash_vs_xla_max_loss_gap": loss_gap,
           "flash_vs_xla_loss_tol": TRAIN_LOSS_TOL,
           "conv_alone": _time_key_conv()}
    emit(rec)
    if not all(np.isfinite(losses + xla_losses)):
        raise SystemExit(f"train_key_conv: a loss is not finite: {losses} / "
                         f"{xla_losses}")
    for k, per_step in want.items():
        if launches[k] != per_step * steps:
            raise SystemExit(f"train_key_conv: {k} launched {launches[k]} "
                             f"times in {steps} steps, expected {per_step} "
                             f"per step")
    if not grads_ok or not moved or not all(
            min(v) > 0 for v in moved.values()):
        raise SystemExit("train_key_conv: a key_conv gradient is not finite "
                         "or is zero, or the conv weights did not move")
    if loss_gap > TRAIN_LOSS_TOL:
        raise SystemExit(f"train_key_conv: flash and xla losses differ by "
                         f"{loss_gap} > {TRAIN_LOSS_TOL}: {losses} / "
                         f"{xla_losses}")
    return launches


def _time_key_conv() -> dict:
    """The conv alone at its main-path shapes, as ``call_cost``s: one
    MoBA layer's training forward and backward (k 1 x 16 x 8192 x 64
    bf16, weights fp32; a step runs the forward twice under remat and
    the backward once) and one decode layer's conv and ring write (k 8 x
    16 x 1 x 64, the ring 8 x 16 x 2 x 64 bf16: ``apply_key_conv_decode``
    then the ``where``/``copy_`` of ``_paged_attend``)."""
    import torch
    from repro_torch.core import key_conv as KC
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    w = KC.init_key_conv(gen, KEY_CONV_WIDTH, 16, 64).requires_grad_()
    k = torch.randn((1, 16, TRAIN_SEQ, 64), generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    dk = torch.randn_like(k)
    ring = torch.randn((8, 16, KEY_CONV_WIDTH - 1, 64), generator=gen,
                       device="cuda", dtype=torch.bfloat16)
    k_new = torch.randn((8, 16, 1, 64), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    active = torch.ones(8, dtype=torch.bool, device="cuda")

    def forward():
        with torch.no_grad():
            KC.apply_key_conv(w, k)

    def forward_backward():
        torch.autograd.grad(KC.apply_key_conv(w, k), (k, w), dk)

    def decode():
        with torch.no_grad():
            _, stepped = KC.apply_key_conv_decode(w, k_new, ring)
            ring.copy_(torch.where(active[:, None, None, None], stepped,
                                   ring))

    return {"train_forward": call_cost(forward, flush),
            "train_forward_backward": call_cost(forward_backward, flush),
            "decode_layer": call_cost(decode, flush)}


# ---------------------------------------------------------------- examples
EXAMPLES = os.path.join(ROOT, "examples_torch")
EXAMPLE_TIMEOUT_S = 300
EXAMPLE_TOL = 2e-4                 # fp32, as tests/test_kernels.py
SERVE_DECODE_ARGS = ["--attn-backend", "flash", "--full"]


def _example_module(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_gates(out: dict) -> dict:
    """What each example printed, read back: quickstart's two errors,
    train_lm's first and final loss, serve_decode's token array shape,
    the NIAH table's rows."""
    import re
    got = {}
    errs = re.findall(r"max err: (\S+)", out["quickstart"])
    got["quickstart_errors"] = [float(e) for e in errs]
    m = re.search(r"final loss: (\S+) \(start (\S+)\)", out["train_lm"])
    got["train_lm_loss"] = (None if m is None
                            else {"first": float(m.group(2)),
                                  "final": float(m.group(1))})
    tail = out["serve_decode"].partition("generated token ids (greedy):")[2]
    rows = [r.split() for r in re.findall(r"\[([^\[\]]*)\]", tail)]
    got["serve_decode_shape"] = ([len(rows), len(rows[0])]
                                 if rows and len({len(r) for r in rows}) == 1
                                 else None)
    got["niah_rows"] = {
        ln.split()[0]: [float(a) for a in ln.split()[1:]]
        for ln in out["longcontext_niah"].splitlines()
        if ln.startswith(("B256", "B128", "B64"))}
    return got


def phase_examples(smi: str, train_rec: dict):
    """The four ``examples_torch/`` scripts in subprocesses on the card,
    quickstart's and serve_decode's paths in this process with their
    launch counts, the model sizes and phase 6's model FLOPs share.
    Returns (quickstart's training-kernel counts, serve_decode's (decode
    calls, kernel launches))."""
    import tempfile

    import torch
    from repro_torch import configs
    from repro_torch.kernels import moba_decode as MD
    from repro_torch.launch import steps as S
    from repro_torch.models import api

    t0 = time.perf_counter()
    bad = []
    with tempfile.TemporaryDirectory() as ckpt:
        runs = {"quickstart": [],
                "train_lm": ["--full", "--steps", "30", "--ckpt-dir", ckpt],
                "serve_decode": SERVE_DECODE_ARGS,
                "longcontext_niah": []}
        env = dict(os.environ, PYTHONPATH=SRC)
        procs = {name: subprocess.Popen(
            [sys.executable, os.path.join(EXAMPLES, f"{name}.py"), *args],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for name, args in runs.items()}
        try:
            # quickstart's path in this process: the three forward kernels
            qs = _example_module("quickstart")
            _zero_counts()
            q_out = qs.run(*qs.inputs(), device="cuda")
            torch.cuda.synchronize()
            q_counts = _counts()
            # serve_decode's path in this process: the decode kernel
            sd = _example_module("serve_decode")
            MD.LAUNCHES = MD.KERNEL_LAUNCHES = 0
            toks = sd.main(SERVE_DECODE_ARGS)
            torch.cuda.synchronize()
            d_calls, d_kernels = MD.LAUNCHES, MD.KERNEL_LAUNCHES
            gc.collect()
            torch.cuda.empty_cache()
            results = {}
            for name, proc in procs.items():
                out, err = proc.communicate(
                    timeout=max(1.0, EXAMPLE_TIMEOUT_S
                                - (time.perf_counter() - t0)))
                results[name] = {"rc": proc.returncode, "stdout": out,
                                 "stderr_tail": err[-2000:]}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    got = _example_gates({k: r["stdout"] for k, r in results.items()})
    for name, r in results.items():
        if r["rc"] != 0:
            bad.append(f"{name} exited {r['rc']}: {r['stderr_tail']}")
    errs = got["quickstart_errors"]
    if len(errs) != 2 or not max(errs) <= EXAMPLE_TOL:
        bad.append(f"quickstart's errors {errs} (want two <= "
                   f"{EXAMPLE_TOL})")
    loss = got["train_lm_loss"]
    if loss is None or not loss["final"] < loss["first"]:
        bad.append(f"train_lm's loss did not fall: {loss}")
    if got["serve_decode_shape"] != [4, 16]:
        bad.append(f"serve_decode printed tokens of shape "
                   f"{got['serve_decode_shape']}, want [4, 16]")
    rows = got["niah_rows"]
    if list(rows) != [c[0] for c in _example_module(
            "longcontext_niah").CONFIGS] or not all(
            len(a) == 3 and all(0 <= x <= 1 for x in a)
            for a in rows.values()):
        bad.append(f"the NIAH table is not 4 rows of 3 accuracies: {rows}")
    in_errs = [q_out["err_sparse"], q_out["err_kernel"]]
    if not max(in_errs) <= EXAMPLE_TOL:
        bad.append(f"quickstart in process: errors {in_errs}")
    want = {"block_centroids": 1, "flash_topk": 1, "moba_fwd": 1,
            "moba_bwd": 0, "swa": 0, "swa_bwd": 0}
    if q_counts != want:
        bad.append(f"quickstart launched {q_counts}, want {want}")
    layers = _moba_layers(configs.get_config("qwen3-0.6b"))
    if tuple(toks.shape) != (4, 16) or d_calls == 0 \
            or d_calls % layers or d_kernels != 3 * d_calls:
        bad.append(f"serve_decode in process: tokens {tuple(toks.shape)}, "
                   f"{d_calls} decode calls / {d_kernels} kernels (a "
                   f"multiple of {layers} calls, 3 kernels each)")
    # the model-level API: sizes of every config, phase 6's FLOPs share
    sizes = {}
    for arch in sorted(configs.ARCHS):
        cfg = configs.get_config(arch)
        sizes[arch] = {"param_count": api.param_count(cfg),
                       "active_param_count": api.active_param_count(cfg)}
    cfg = configs.get_config("moba-340m")
    info = configs.ASSIGNED_SHAPES["train_4k"]
    per_token = S.model_flops(cfg, "train_4k") / (info["seq_len"]
                                                  * info["global_batch"])
    step_s = train_rec["median_step_ms_steps_2_4"] / 1e3
    share = per_token * TRAIN_SEQ / step_s / BF16_FLOPS
    flops = {"arch": cfg.name, "model_flops_per_token": per_token,
             "tokens_per_step": TRAIN_SEQ, "median_step_ms": step_s * 1e3,
             "model_tflops_per_s": per_token * TRAIN_SEQ / step_s / 1e12,
             "peak_tflops_per_s": BF16_FLOPS / 1e12,
             "share_of_bf16_peak": share,
             "counts": "6·N a token, N the active parameters less the "
                       "untied embedding; attention's own FLOPs are not "
                       "in N"}
    rec = {"phase": "examples", "nvidia_smi": smi, "gates": got,
           "exit_codes": {k: r["rc"] for k, r in results.items()},
           "train_lm_stdout_tail": results["train_lm"]["stdout"][-600:],
           "niah_stdout": results["longcontext_niah"]["stdout"],
           "quickstart_in_process": {
               "errors": in_errs, "launches": q_counts,
               "selection_query_300": q_out["selection"].tolist()},
           "serve_decode_in_process": {
               "args": SERVE_DECODE_ARGS, "tokens_shape": list(toks.shape),
               "decode_calls": d_calls, "kernel_launches": d_kernels},
           "param_counts": sizes, "train_model_flops": flops,
           "ok": not bad, "failures": bad}
    emit(rec)
    print(f"{smi}: {cfg.name} trains at {flops['model_tflops_per_s']:.1f} "
          f"model TFLOP/s ({per_token:.4g} FLOPs a token, "
          f"{step_s * 1e3:.1f} ms a {TRAIN_SEQ}-token step), "
          f"{share:.4f} of {BF16_FLOPS / 1e12:.0f} TFLOP/s", flush=True)
    for arch, n in sizes.items():
        print(f"{smi}: {arch} {n['param_count']:,} params, "
              f"{n['active_param_count']:,} active", flush=True)
    if bad:
        raise SystemExit("examples: " + "; ".join(bad))
    return q_counts, (d_calls, d_kernels)


# ------------------------------------------------- accumulation and resume
ACCUM_MODES = ("microbatch", "accum_in_loss", "one_shot")
ACCUM_LOSS_RTOL = 2e-4
ACCUM_GRAD_TOL = 5e-3          # of each leaf's max, tests/test_kernels.py


def _accum_step(mode: str, tokens, dtype: str) -> tuple:
    """One ``make_train_step`` step of moba-340m (full width and depth,
    computing in ``dtype``, seed-0 weights, remat, ``flash``) on
    ``tokens`` (2 x 8193): in 2 microbatches (``microbatch``: a backward
    each; ``accum_in_loss``: one loss over both, each under
    ``torch.utils.checkpoint``) or at once.  The training kernels' counts
    are zeroed just before the step and read just after.  Returns the
    record and the first moment after the step (0.1 x the clipped
    gradient)."""
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_config("moba-340m"), dtype=dtype)
    tcfg = TrainConfig(global_batch_size=2, seq_len=TRAIN_SEQ,
                       total_steps=TRAIN_STEPS + 1, warmup_steps=1,
                       microbatch=0 if mode == "one_shot" else 2)
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adamw.adamw_init(params)
    step_fn = S.make_train_step(cfg, tcfg, backend="flash", remat=True,
                                accum_in_loss=mode == "accum_in_loss")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    params, opt, m = step_fn(params, opt, {"tokens": tokens})
    loss = float(m["loss"])
    torch.cuda.synchronize()
    rec = {"mode": mode, "dtype": dtype, "loss": loss,
           "grad_norm": float(m["grad_norm"]),
           "step_ms": (time.perf_counter() - t0) * 1e3,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": _counts()}
    mu = opt.mu
    del params, opt, step_fn
    return rec, mu


def phase_train_accum():
    """Gradient accumulation at full width: one step at global batch 2 x
    8192 with ``microbatch=2``, then with ``accum_in_loss``, then at once,
    each from the seed-0 weights and the same batch (TF32 off), first
    computing in bf16 (the trained configuration: step ms, peak memory,
    losses), then in fp32 (the gradients).  Gates: each loss within 2e-4
    relative of the one-shot step's in the same dtype; in fp32 every
    gradient leaf (through the first moment) within 5e-3 of its max, the
    port's fp32 gradient tolerance (bf16's gap is reported: bf16 rounds
    differently in GEMMs of another shape); finite; the training kernels
    launched as the path implies: per chunk, the forward's three kernels
    twice under remat (three times inside the loss's checkpoint) and the
    backward once, and the SWA layers' ``swa`` and ``swa_bwd`` as often
    in bf16 (in fp32 they keep dense attention and launch neither).
    Returns the bf16 launches of the two accumulating
    modes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    data = SyntheticLM(DataConfig(
        vocab_size=get_config("moba-340m").vocab_size, seq_len=TRAIN_SEQ,
        global_batch=2, seed=0))
    tokens = torch.as_tensor(data.batch_at(0)["tokens"], device="cuda")
    forwards = {"microbatch": 2 * 2, "accum_in_loss": 2 * 3, "one_shot": 2}
    backwards = {"microbatch": 2, "accum_in_loss": 2, "one_shot": 1}
    rec, bad = {"phase": "train_accum", "arch": "moba-340m", "batch": 2,
                "seq": TRAIN_SEQ, "remat": True, "backend": "flash",
                "loss_rtol": ACCUM_LOSS_RTOL,
                "grad_tol_fp32": ACCUM_GRAD_TOL}, []
    for dtype in ("bfloat16", "float32"):
        recs, mus = {}, {}
        for mode in ACCUM_MODES:
            recs[mode], mus[mode] = _accum_step(mode, tokens, dtype)
        ref = dict(adamw.tree_leaves(mus["one_shot"]))
        for mode in ACCUM_MODES:
            r = recs[mode]
            want = {k: forwards[mode] * MOBA_LAYERS for k in (
                "block_centroids", "flash_topk", "moba_fwd")}
            want["moba_bwd"] = backwards[mode] * MOBA_LAYERS
            # the SWA layers' banded kernels take bf16 only
            swa_layers = SWA_LAYERS if dtype == "bfloat16" else 0
            want["swa"] = forwards[mode] * swa_layers
            want["swa_bwd"] = backwards[mode] * swa_layers
            r["expected_launches"] = want
            if r["launches"] != want:
                bad.append(f"{dtype} {mode}: launches {r['launches']} != "
                           f"{want}")
            if not np.isfinite(r["loss"]):
                bad.append(f"{dtype} {mode}: loss {r['loss']}")
            if mode == "one_shot":
                continue
            errs = {p: float((x - ref[p]).abs().max()
                             / ref[p].abs().max().clamp(min=1e-30))
                    for p, x in adamw.tree_leaves(mus[mode])}
            worst = max(errs, key=errs.get)
            r["loss_rel_vs_one_shot"] = abs(
                r["loss"] - recs["one_shot"]["loss"]) / abs(
                recs["one_shot"]["loss"])
            r["grad_worst_leaf_vs_one_shot"] = {
                "leaf": worst, "err_over_max": errs[worst]}
            r["grads_finite"] = all(bool(torch.isfinite(x).all())
                                    for _, x in adamw.tree_leaves(mus[mode]))
            if r["loss_rel_vs_one_shot"] > ACCUM_LOSS_RTOL:
                bad.append(f"{dtype} {mode}: loss {r['loss']} vs one-shot "
                           f"{recs['one_shot']['loss']}")
            if not r["grads_finite"] or (dtype == "float32"
                                         and errs[worst] > ACCUM_GRAD_TOL):
                bad.append(f"{dtype} {mode}: gradient leaf {worst} off by "
                           f"{errs[worst]} of its max")
        rec[dtype] = recs
        del mus, ref
        gc.collect()
        torch.cuda.empty_cache()
    rec["ok"], rec["failures"] = not bad, bad
    emit(rec)
    if bad:
        raise SystemExit("train_accum: " + "; ".join(bad))
    return {m: rec["bfloat16"][m]["launches"]
            for m in ("microbatch", "accum_in_loss")}


def phase_train_resume(steps: int = 4):
    """Kill and resume at full width through ``launch/train.py::train``
    (moba-340m, batch 1 x 8192, remat, ``flash``, seed 0): ``steps``
    steps uninterrupted; then, in a fresh temporary directory, 2 steps
    that save and stop (``stop_at_step``), and ``resume="auto"`` for the
    rest.  Losses and final params must equal the uninterrupted run's
    within rtol 1e-5 (bit-equality reported).  The manager keeps 1
    checkpoint; its blocking snapshot, its write on the writer thread,
    its bytes and the restore are timed.  The directory is deleted."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import manager as CM
    from repro_torch.launch import train as TR
    from repro_torch.optim import adamw

    times = {"snapshot_ms": [], "write_s": [], "restore_s": [],
             "bytes": []}

    class Timed(CM.CheckpointManager):
        def __init__(self, directory, keep=3, async_writes=True):
            super().__init__(directory, keep=1, async_writes=async_writes)

        def save(self, step, tree, extra=None, block=False):
            t0 = time.perf_counter()
            super().save(step, tree, extra, block)
            times["snapshot_ms"].append((time.perf_counter() - t0) * 1e3)

        def _write(self, payload):
            t0 = time.perf_counter()
            super()._write(payload)
            times["write_s"].append(time.perf_counter() - t0)
            times["bytes"].append(os.path.getsize(os.path.join(
                self.dir, f"step_{payload[0]:08d}", "arrays.npz")))

        def restore(self, template, step=None):
            t0 = time.perf_counter()
            out = super().restore(template, step)
            torch.cuda.synchronize()
            times["restore_s"].append(time.perf_counter() - t0)
            return out

    kw = dict(steps=steps, batch=1, seq=TRAIN_SEQ, smoke=False,
              attn_backend="flash", remat=True, seed=0, log_every=steps,
              save_interval=2, device="cuda")
    params_a, losses_a = TR.train("moba-340m", **kw)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="train_resume_")
    manager = TR.CheckpointManager
    TR.CheckpointManager = Timed
    try:
        _, first = TR.train("moba-340m", ckpt_dir=tmp, stop_at_step=2, **kw)
        torch.cuda.empty_cache()
        params_b, rest = TR.train("moba-340m", ckpt_dir=tmp, resume="auto",
                                  **kw)
        kept = sorted(os.listdir(tmp))
    finally:
        TR.CheckpointManager = manager
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = dict(adamw.tree_leaves(params_a)), dict(adamw.tree_leaves(
        params_b))
    close = all(bool(torch.allclose(b[p], a[p], rtol=1e-5, atol=1e-6))
                for p in a)
    bit_equal = all(bool(torch.equal(b[p], a[p])) for p in a)
    losses_b = first + rest
    losses_close = bool(np.allclose(losses_b, losses_a, rtol=1e-5, atol=0))
    rec = {"phase": "train_resume", "arch": "moba-340m", "batch": 1,
           "seq": TRAIN_SEQ, "steps": steps, "save_interval": 2, "keep": 1,
           "losses_uninterrupted": losses_a, "losses_resumed": losses_b,
           "losses_within_rtol_1e-5": losses_close,
           "losses_bit_equal": losses_b == losses_a,
           "params_within_rtol_1e-5": close, "params_bit_equal": bit_equal,
           "kept": kept, **times,
           "checkpoint_gb": [n / 1e9 for n in times["bytes"]]}
    emit(rec)
    del params_a, params_b, a, b
    gc.collect()
    torch.cuda.empty_cache()
    if not (losses_close and close and len(losses_b) == steps
            and len(times["restore_s"]) == 1 and kept == [
                f"step_{steps:08d}"]):
        raise SystemExit("train_resume: the resumed run differs from the "
                         "uninterrupted one, or the checkpoints were not "
                         "saved, kept and restored as asked")
    return rec


# ------------------------------------------------ multi-device training
SP_SHARDS = 2                  # all on cuda:0: one card rehearses the group
SP_TRAIN_STEPS = 3
SP_GRAD_LAYERS = 4             # the fp32 gradient check: full width
SP_PEAK_LAYERS = 4             # remat off does not fit at full depth
SP_GRAD_TOL = 5e-3             # of each leaf's max, tests/test_kernels.py
EF_TOL = 1e-5                  # of 127·s, the leaf's largest |g + r|
PIPE_STAGES = 2
PIPE_MICROBATCHES = 4
PIPE_SEQ = 4096
PIPE_TOL = 3e-2                # bf16: the schedule against the whole batch


def _sp_step_bytes(cfg, seq: int, shards: int, remat: bool = True) -> dict:
    """What one ``sp`` training step of batch 1 moves between shards, by
    kind: ``sp_attention_bytes`` of each MoBA layer (q, k, v in
    ``cfg.dtype``, int64 positions), the forward's kinds twice under
    remat (the backward recomputes each layer group, sends included),
    the gradients' once."""
    from repro_torch.distributed import moba_sp as SP
    once = SP.sp_attention_bytes(
        1, cfg.num_heads, cfg.num_kv_heads, seq, seq, cfg.resolved_head_dim,
        shards, 2 if cfg.dtype == "bfloat16" else 4, positions_itemsize=8)
    return {k: n * _moba_layers(cfg) * (2 if remat and not
                                        k.endswith("_grad") else 1)
            for k, n in once.items()}


def _sp_attention_alone(shards: int) -> dict:
    """One MoBA layer's attention at moba-340m's training shape (bf16,
    batch 1, 16 heads, 8,192 tokens, d 64), forward and backward: through
    ``moba_attention_sp`` (each shard recomputes its tiles in the
    backward) against the same shards' ``moba_sparse_xla`` calls without
    the recompute.  Peak GiB above the inputs, ms (host clock around a
    synchronised run, the second of two), and how far the outputs and
    gradients of the two are apart."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import moba_sp as SP
    from repro_torch.kernels import ref as kref

    cfg = get_config("moba-340m")
    mcfg, d = cfg.attention.moba, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (1, cfg.num_heads, TRAIN_SEQ, d)
    qkv = [torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3)]
    dout = torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    rows = TRAIN_SEQ // shards

    def sp(q, k, v):
        return SP.moba_attention_sp(q, k, v, mcfg,
                                    group=SP.CPGroup(["cuda:0"] * shards))

    def no_recompute(q, k, v):
        return torch.cat([kref.moba_sparse_xla(
            q[:, :, s * rows:(s + 1) * rows], k, v, mcfg,
            q_positions=torch.arange(rows, device="cuda") + s * rows)
            for s in range(shards)], dim=2)

    out = {}
    for name, fn in (("sp", sp), ("no_recompute", no_recompute)):
        for _ in range(2):
            xs = [x.detach().requires_grad_() for x in qkv]
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            o = fn(*xs)
            grads = torch.autograd.grad(o, xs, dout)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        out[name] = (o.detach(), grads, ms, peak)
        del o, grads, xs
    a, b = out["sp"], out["no_recompute"]
    return {"shape": list(shape), "shards": shards,
            "sp_ms": a[2], "no_recompute_ms": b[2],
            "sp_peak_gib": a[3], "no_recompute_peak_gib": b[3],
            "out_max_abs_diff": float((a[0].float() - b[0].float()).abs()
                                      .max()),
            "grad_max_rel_diff": max(_max_rel(x, y)
                                     for x, y in zip(a[1], b[1]))}


def _sp_grads(group) -> dict:
    """fp32 (TF32 off) loss and every gradient leaf of moba-340m at full
    width and ``SP_GRAD_LAYERS`` layers, batch 1 × 2,048 with remat,
    ``sp`` under ``group`` against ``xla``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import moba_sp as SP
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    seq = 2048
    cfg = dataclasses.replace(get_config("moba-340m"), dtype="float32",
                              num_layers=SP_GRAD_LAYERS)
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=1, seed=1)).batch_at(0)
    batch = {"tokens": torch.as_tensor(tokens["tokens"], device="cuda")}
    out = {}
    with SP.use_group(group):
        for backend in ("xla", "sp"):
            leaves = [leaf.detach().requires_grad_() for _, leaf in
                      adamw.tree_leaves(params)]
            loss, _ = T.lm_loss(adamw.tree_like(params, leaves), batch, cfg,
                                backend=backend, remat=True)
            out[backend] = (float(loss.detach()),
                            torch.autograd.grad(loss, leaves))
    names = [p for p, _ in adamw.tree_leaves(params)]
    rels = {n: _max_rel(a, b) for n, a, b in zip(names, out["sp"][1],
                                                 out["xla"][1])}
    worst = max(rels, key=rels.get)
    return {"layers": SP_GRAD_LAYERS, "seq": seq, "dtype": "float32",
            "loss_sp": out["sp"][0], "loss_xla": out["xla"][0],
            "loss_rel_err": abs(out["sp"][0] - out["xla"][0])
            / abs(out["xla"][0]), "loss_tol": 2e-4,
            "worst_leaf": worst, "worst_leaf_rel_err": rels[worst],
            "grad_tol": SP_GRAD_TOL, "leaves": len(rels)}


def phase_train_sp(xla_losses):
    """Sequence-parallel training through the ``sp`` backend under a
    2-shard group on cuda:0 (``CPGroup(["cuda:0"] * 2)``: the logic,
    bytes and memory of 2 shards; no transfer between cards).  moba-340m
    at full width and depth, bf16, batch 1 × 8,192, remat, 3 steps from
    the weights and batches of phase 6's ``xla`` run: each loss within
    ``TRAIN_LOSS_TOL`` of that run's.  The bytes of each step by kind
    must equal ``_sp_step_bytes``.  After step 2 the params and moments
    are saved (``CheckpointManager``, a temporary directory); restored
    into the same group, step 3's loss must be bit-equal; restored with
    ``restore(devices=...)`` and stepped under a 4-shard group, within
    ``TRAIN_LOSS_TOL`` (its bytes the 4-shard formula).  Then peaks at 4
    layers with remat on and off, one layer's attention alone with and
    without the per-shard recompute, and the fp32 gradient check
    (``_sp_grads``)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import moba_sp as SP
    from repro_torch.optim import adamw

    group = SP.CPGroup(["cuda:0"] * SP_SHARDS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="train_sp_")
    try:
        with SP.use_group(group):
            cfg, (step_fn, params, opt, batch), losses, step_s = _train_run(
                "sp", SP_TRAIN_STEPS - 1)
            two_steps = dict(group.bytes)
            mgr = CheckpointManager(tmp, keep=1, async_writes=False)
            template = {"params": params, "mu": opt.mu, "nu": opt.nu}
            t0 = time.perf_counter()
            mgr.save(SP_TRAIN_STEPS - 1, template)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        resumed = {}
        for shards in (SP_SHARDS, 2 * SP_SHARDS):
            devices = (None if shards == SP_SHARDS else adamw.tree_like(
                template, [group.devices[0]] * len(adamw.tree_leaves(
                    template))))
            t0 = time.perf_counter()
            tree, _, ck = mgr.restore(template, devices=devices)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            state = adamw.AdamWState(
                torch.tensor(ck, dtype=torch.int32, device="cuda"),
                tree["mu"], tree["nu"])
            g = SP.CPGroup(["cuda:0"] * shards)
            with SP.use_group(g):
                _, _, m = step_fn(tree["params"], state, batch)
            resumed[shards] = {"loss": float(m["loss"]),
                               "restore_s": restore_s,
                               "bytes": dict(g.bytes)}
            del tree, state, m
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del step_fn, params, opt, batch, template
    gc.collect()
    torch.cuda.empty_cache()
    peaks = {}
    for remat in (True, False):
        torch.cuda.reset_peak_memory_stats()
        with SP.use_group(group):
            _, state, _, s = _train_run("sp", 1, layers=SP_PEAK_LAYERS,
                                        remat=remat)
        peaks[f"remat_{str(remat).lower()}"] = {
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "step_ms": s[0] * 1e3}
        del state
        gc.collect()
        torch.cuda.empty_cache()
    alone = _sp_attention_alone(SP_SHARDS)
    grads = _sp_grads(group)
    want = _sp_step_bytes(cfg, TRAIN_SEQ, SP_SHARDS)
    want4 = _sp_step_bytes(cfg, TRAIN_SEQ, 2 * SP_SHARDS)
    n = SP_TRAIN_STEPS - 1
    gap = max(abs(a - b) for a, b in zip(losses, xla_losses))
    rec = {"phase": "train_sp", "arch": cfg.name, "dtype": cfg.dtype,
           "batch": 1, "seq": TRAIN_SEQ, "remat": True, "backend": "sp",
           "shards": SP_SHARDS, "devices": [str(d) for d in group.devices],
           "losses": losses, "xla_losses": xla_losses[:SP_TRAIN_STEPS],
           "sp_vs_xla_max_loss_gap": gap, "loss_tol": TRAIN_LOSS_TOL,
           "step_ms": [t * 1e3 for t in step_s], "peak_mem_gib": peak,
           "bytes_per_step": {k: v / n for k, v in two_steps.items()},
           "bytes_per_step_formula": want,
           "bytes_per_step_total": sum(want.values()),
           "checkpoint_save_s": save_s,
           "resume_same_group": resumed[SP_SHARDS],
           "resume_same_group_bit_equal":
               resumed[SP_SHARDS]["loss"] == losses[-1],
           "resume_4_shards": resumed[2 * SP_SHARDS],
           "resume_4_shards_loss_gap":
               abs(resumed[2 * SP_SHARDS]["loss"] - losses[-1]),
           "bytes_4_shards_formula": want4,
           f"peaks_{SP_PEAK_LAYERS}_layers": peaks,
           "attention_alone": alone, "grads": grads}
    emit(rec)
    if not all(np.isfinite(losses)) or gap > TRAIN_LOSS_TOL:
        raise SystemExit(f"train_sp: losses {losses} not finite or off "
                         f"xla's {xla_losses} by more than "
                         f"{TRAIN_LOSS_TOL}")
    if two_steps != {k: v * n for k, v in want.items()} \
            or resumed[2 * SP_SHARDS]["bytes"] != want4:
        raise SystemExit("train_sp: the bytes between shards are not the "
                         "formula's")
    if not rec["resume_same_group_bit_equal"] \
            or rec["resume_4_shards_loss_gap"] > TRAIN_LOSS_TOL:
        raise SystemExit("train_sp: a resumed step 3 differs from the "
                         "uninterrupted one")
    if grads["loss_rel_err"] > 2e-4 \
            or grads["worst_leaf_rel_err"] > SP_GRAD_TOL:
        raise SystemExit("train_sp: sp and xla losses or gradients "
                         "disagree in fp32")
    return rec


def phase_train_dp_compressed():
    """The int8 error-feedback gradient reduce at full width: 2 shards on
    cuda:0 each take the moba-340m gradient (fp32 master weights, bf16
    compute, remat) on ``flash`` of one 8,192-token row of a batch of 2,
    in two rounds (batches 0 and 1, the same weights), and
    ``compressed_psum`` reduces each round with the residuals carried.
    Gates: both shards' means bit-equal; every element within one scale
    (the larger of this round's and the last's) of the plain mean (fp64);
    the error-feedback identity Σ rounds (mean − true mean) = −mean of
    the final residuals, within ``EF_TOL`` of 127·s per leaf; the four
    FlashMoBA kernels' and the two SWA kernels' exact launches (a training
    step's per gradient).
    Reports the bytes by kind against an fp32 star reduce's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import moba_sp as SP
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.optim import compression as C

    cfg = get_config("moba-340m")
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    names = [p for p, _ in adamw.tree_leaves(params)]
    leaves = [leaf.requires_grad_() for _, leaf in adamw.tree_leaves(params)]
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ, global_batch=2, seed=0))
    group = SP.CPGroup(["cuda:0"] * 2)
    rounds = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _zero_counts()
    for r in range(2):
        tokens = torch.as_tensor(data.batch_at(r)["tokens"], device="cuda")
        trees = []
        for s in range(2):
            loss, _ = T.lm_loss(params, {"tokens": tokens[s:s + 1]}, cfg,
                                backend="flash", remat=True)
            trees.append(adamw.tree_like(params, torch.autograd.grad(
                loss, leaves)))
        rounds.append(trees)
    launches = _counts()
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    for leaf in leaves:
        leaf.requires_grad_(False)
    res = [C.init_residuals(params) for _ in range(2)]
    drift = {n: 0.0 for n in names}
    prev = {n: 0.0 for n in names}
    top = {n: 0.0 for n in names}
    psum_ms, bytes_rounds, err_over_scale = [], [], 0.0
    equal = True
    for trees in rounds:
        g = [dict(adamw.tree_leaves(t)) for t in trees]
        r = [dict(adamw.tree_leaves(t)) for t in res]
        scale = {n: max(float((g[s][n] + r[s][n]).abs().max())
                        for s in range(2)) / 127 for n in names}
        before = dict(group.bytes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means, res = C.compressed_psum(trees, res, group)
        torch.cuda.synchronize()
        psum_ms.append((time.perf_counter() - t0) * 1e3)
        bytes_rounds.append({k: v - before.get(k, 0)
                             for k, v in group.bytes.items()})
        means = [dict(adamw.tree_leaves(t)) for t in means]
        for n in names:
            equal &= bool(torch.equal(means[0][n], means[1][n]))
            err = means[0][n].double() - (g[0][n].double()
                                          + g[1][n].double()) / 2
            bound = max(prev[n], scale[n])
            err_over_scale = max(err_over_scale,
                                 float(err.abs().max()) / max(bound, 1e-30))
            drift[n] = drift[n] + err
            prev[n] = scale[n]
            top[n] = max(top[n], scale[n])
        del means, g, r
    r = [dict(adamw.tree_leaves(t)) for t in res]
    ef_gap = max(float((drift[n] + (r[0][n].double()
                                    + r[1][n].double()) / 2).abs().max())
                 / max(127 * top[n], 1e-30) for n in names)
    n_params = sum(int(p.numel()) for _, p in adamw.tree_leaves(params))
    fp32_star = 2 * n_params * 4     # shard 1's fp32 grads in, the mean out
    want = {"block_centroids": 4 * 2 * MOBA_LAYERS,
            "flash_topk": 4 * 2 * MOBA_LAYERS,
            "moba_fwd": 4 * 2 * MOBA_LAYERS, "moba_bwd": 4 * MOBA_LAYERS,
            "swa": 4 * 2 * SWA_LAYERS, "swa_bwd": 4 * SWA_LAYERS}
    rec = {"phase": "train_dp_compressed", "arch": cfg.name,
           "dtype": cfg.dtype, "shards": 2, "rows_per_shard": 1,
           "seq": TRAIN_SEQ, "rounds": 2, "params": n_params,
           "leaves": len(names), "grads_s": grad_s, "psum_ms": psum_ms,
           "means_bit_equal_across_shards": equal,
           "max_err_over_scale": err_over_scale,
           "ef_identity_gap_over_127s": ef_gap, "ef_tol": EF_TOL,
           "bytes_per_round": bytes_rounds,
           "bytes_per_round_total": [sum(b.values()) for b in bytes_rounds],
           "fp32_star_reduce_bytes_per_round": fp32_star,
           "payload_vs_fp32_in": [b.get("payload", 0) / (n_params * 4)
                                  for b in bytes_rounds],
           "launches": launches, "expected_launches": want}
    emit(rec)
    if not equal or err_over_scale > 1 + EF_TOL * 127 or ef_gap > EF_TOL:
        raise SystemExit("train_dp_compressed: the shards' means differ, "
                         "a mean is off the true mean by more than a "
                         "scale, or the error-feedback identity fails")
    if launches != want:
        raise SystemExit(f"train_dp_compressed: launches {launches}, "
                         f"expected {want}")
    return launches


def phase_pipeline():
    """GPipe forward through ``distributed/pipeline.py``: moba-340m's 12
    (swa, moba) groups (full width, bf16, seed-0 weights) split over 2
    stages on cuda:0 (6 groups a stage, ``apply_block`` on ``flash``), 4
    microbatches of 1 × 4,096 hidden states.  Gates: bit-equal to the
    same stages applied microbatch by microbatch without the schedule,
    within ``PIPE_TOL`` (max |Δ| / max |y|) of the whole batch through
    them; 8 stage calls (S·M: the bubble's ticks skipped) over S + M − 1
    = 5 ticks; exact launches of centroids, Flash TopK and ``moba_fwd``
    (one each a MoBA layer a microbatch), none of ``moba_bwd``; the
    activations' bytes between stages."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import moba_sp as SP
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.models import transformer as T

    cfg = get_config("moba-340m")
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    pattern = cfg.layer_pattern
    per_stage = cfg.num_layers // len(pattern) // PIPE_STAGES

    def stack(tree):
        return {k: stack(v) if isinstance(v, dict) else v.reshape(
            PIPE_STAGES, per_stage, *v.shape[1:]) for k, v in tree.items()}

    stacked = stack(params["blocks"])
    calls = [0]

    def stage_fn(p, h):
        calls[0] += 1
        for gi in range(per_stage):
            for i, kind in enumerate(pattern):
                h, _, _ = T.apply_block(T._group(p[f"slot_{i}"], gi), h, cfg,
                                        kind, backend="flash")
        return h

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(PIPE_MICROBATCHES, PIPE_SEQ, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)
    group = SP.CPGroup(["cuda:0"] * PIPE_STAGES)
    with torch.no_grad():
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        out = pipeline_forward(stage_fn, stacked, x, group,
                               num_microbatches=PIPE_MICROBATCHES)
        torch.cuda.synchronize()
        pipe_ms = (time.perf_counter() - t0) * 1e3
        launches = _counts()
        stage_calls = calls[0]
        stages = [T._group(stacked, s) for s in range(PIPE_STAGES)]

        def through(h):
            for p in stages:
                h = stage_fn(p, h)
            return h

        t0 = time.perf_counter()
        plain = torch.cat([through(x[i:i + 1])
                           for i in range(PIPE_MICROBATCHES)])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        whole = through(x)
        torch.cuda.synchronize()
        whole_ms = (time.perf_counter() - t0) * 1e3
    per_mb = x[:1].numel() * x.element_size()
    want = {"block_centroids": PIPE_MICROBATCHES * MOBA_LAYERS,
            "flash_topk": PIPE_MICROBATCHES * MOBA_LAYERS,
            "moba_fwd": PIPE_MICROBATCHES * MOBA_LAYERS, "moba_bwd": 0,
            "swa": PIPE_MICROBATCHES * SWA_LAYERS, "swa_bwd": 0}
    want_bytes = {"act": (PIPE_STAGES - 1) * PIPE_MICROBATCHES * per_mb,
                  "out": PIPE_MICROBATCHES * per_mb}
    rel = _max_rel(out, whole)
    rec = {"phase": "pipeline", "arch": cfg.name, "dtype": "bfloat16",
           "stages": PIPE_STAGES, "groups_per_stage": per_stage,
           "microbatches": PIPE_MICROBATCHES, "microbatch": [1, PIPE_SEQ],
           "ticks": PIPE_STAGES + PIPE_MICROBATCHES - 1,
           "stage_calls": stage_calls,
           "bit_equal_to_microbatch_loop": bool(torch.equal(out, plain)),
           "max_rel_vs_whole_batch": rel, "tol": PIPE_TOL,
           "finite": bool(torch.isfinite(out).all()),
           "pipeline_ms": pipe_ms, "microbatch_loop_ms": plain_ms,
           "whole_batch_ms": whole_ms, "bytes": dict(group.bytes),
           "expected_bytes": want_bytes, "launches": launches,
           "expected_launches": want}
    emit(rec)
    if not (rec["bit_equal_to_microbatch_loop"] and rec["finite"]
            and rel <= PIPE_TOL
            and stage_calls == PIPE_STAGES * PIPE_MICROBATCHES
            and dict(group.bytes) == want_bytes and launches == want):
        raise SystemExit("pipeline: the schedule's output, stage calls, "
                         "bytes or launches are not as expected")
    return launches


# ------------------------------------------------------------------ phase 7
def phase_train_grads(block_size: int = 128, top_k: int = 8,
                      key_conv_width: int = 0, *, arch: str = "moba-340m",
                      layers: int = 0, phase: str = "train_grads"):
    """flash against xla through the whole model in fp32 (``arch``,
    ``layers`` deep when nonzero).  The xla run
    replays the flash run's block selections layer by layer, so both
    sides compute the same function; each replayed selection is held to
    the plain routing of the xla run's own q and k by the near-tie rule
    (a near-tie could otherwise flip one query's blocks between the two
    runs, since their inputs differ in the last bits)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import moba as CM
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    seq = 2048
    cfg = dataclasses.replace(get_config(
        arch, block_size=block_size, top_k=top_k,
        key_conv_width=key_conv_width), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=1, seed=1)).batch_at(0)
    batch = {"tokens": torch.as_tensor(tokens["tokens"], device="cuda"),
             **S.stub_frontend_inputs(cfg, np.random.default_rng(0), 1,
                                      "cuda")}
    flash_topk, plain_selection = ops.flash_topk, CM.moba_selection
    recorded, audit = [], []

    def record(*args, **kw):
        sel = flash_topk(*args, **kw)
        recorded.append(sel)
        return sel

    replay = _replay_selection(recorded, audit, plain_selection)
    out = {}
    try:
        for backend in ("flash", "xla"):
            ops.flash_topk, CM.moba_selection = (
                (record, plain_selection) if backend == "flash"
                else (flash_topk, replay))
            leaves = [leaf.detach().requires_grad_() for _, leaf in
                      adamw.tree_leaves(params)]
            loss, _ = T.lm_loss(adamw.tree_like(params, leaves), batch, cfg,
                                backend=backend)
            out[backend] = (float(loss.detach()),
                            torch.autograd.grad(loss, leaves))
    finally:
        ops.flash_topk, CM.moba_selection = flash_topk, plain_selection
    names = [p for p, _ in adamw.tree_leaves(params)]
    rels = {n: _max_rel(a, b) for n, a, b in zip(names, out["flash"][1],
                                                 out["xla"][1])}
    worst = max(rels, key=rels.get)
    loss_rel = abs(out["flash"][0] - out["xla"][0]) / abs(out["xla"][0])
    routing_ok = len(audit) == _moba_layers(cfg) + _encoder_moba_layers(
        cfg) and all(ok for _, _, ok in audit)
    ok = loss_rel <= 2e-4 and rels[worst] <= 5e-3 and routing_ok
    emit({"phase": phase, "arch": cfg.name, "dtype": "float32",
          "layers": cfg.num_layers,
          "seq": seq, "block_size": block_size, "top_k": top_k,
          "key_conv_width": key_conv_width,
          "loss_flash": out["flash"][0], "loss_xla": out["xla"][0],
          "loss_rel_err": loss_rel, "loss_tol": 2e-4,
          "worst_leaf": worst, "worst_leaf_rel_err": rels[worst],
          "key_conv_leaf_rel_err": {n: r for n, r in rels.items()
                                    if n.endswith("key_conv")},
          "encoder_leaf_worst_rel_err": max(
              (r for n, r in rels.items() if n.startswith("encoder/")),
              default=None),
          "grad_tol": 5e-3, "leaves": len(rels),
          "routing_rows_differing_per_layer": [r for r, _, _ in audit],
          "routing_max_gap": max((g for _, g, _ in audit), default=0.0),
          "routing_near_ties_ok": routing_ok, "ok": ok})
    if not ok:
        raise SystemExit(f"{phase}: flash and xla losses or gradients "
                         f"disagree, or a routing difference is no "
                         f"near-tie")


# ------------------------------------------------------------------ phase 8
def _swa_inputs(*, b, h, hkv, n, d, dtype, seed):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b * h, n, d), generator=gen, device="cuda") * 0.5
    k = torch.randn((b * hkv, n, d), generator=gen, device="cuda") * 0.5
    v = torch.randn((b * hkv, n, d), generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _flex_yardstick(q4, k4, v4, w: int, scale: float, ref, flush) -> dict:
    """``torch.nn.attention.flex_attention`` with a sliding-window
    ``BlockMask`` (it skips the blocks outside the band), compiled once
    and then timed: one PyTorch call for the same function, a yardstick
    the port never calls.  If it cannot be built, the error instead."""
    import torch
    try:
        import torch._inductor.config as inductor_config
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        build = os.path.join(SRC, "repro_torch", "kernels", "build")
        os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                              os.path.join(build, "inductor"))
        os.environ.setdefault("TRITON_CACHE_DIR",
                              os.path.join(build, "triton"))
        inductor_config.compile_threads = 1      # no worker processes
        n = q4.shape[2]
        mask = create_block_mask(
            lambda b, h, qi, ki: (qi >= ki) & (qi - ki < w), B=None, H=None,
            Q_LEN=n, KV_LEN=n, device="cuda")
        flex = torch.compile(flex_attention, dynamic=False)
        t0 = time.perf_counter()
        out = flex(q4, k4, v4, block_mask=mask, scale=scale)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
    except Exception as e:          # a yardstick: record why, time none
        return {"flex_error": f"{type(e).__name__}: {e}"[:600]}
    return {"flex_ms": cuda_events_ms(
                lambda: flex(q4, k4, v4, block_mask=mask, scale=scale),
                flush=flush),
            "flex_compile_s": compile_s,
            "flex_max_abs_err": float((out[0].float() - ref.float())
                                      .abs().max())}


def _time_swa(KS, q, k, v, w: int, kw: dict, flush) -> dict:
    """At one shape: the kernel launch alone, the wrapper, the plain
    version and band SDPA as calls, flex in bf16, and the bound from
    these tensors."""
    import torch
    import torch.nn.functional as F
    n, d = q.shape[1], q.shape[2]
    scale = d ** -0.5
    pos = torch.arange(n, device="cuda")
    band = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < w)
    pairs = float(band.sum()) * q.shape[0]       # (query, key) pairs kept
    q4, k4, v4 = (x[None] for x in (q, k, v))    # (1, H, N, d)

    bf16 = q.dtype == torch.bfloat16
    rec = {"kernel_only_ms": cuda_events_ms(
               lambda: KS.launch(q, k, v, w, kw["num_q_heads"], kw["group"],
                                 scale, 128, 128), flush=flush),
           **call_cost(lambda: KS.swa_attention(q, k, v, w, **kw), flush),
           **call_cost(lambda: KS.swa_attention_plain(q, k, v, w, **kw),
                       flush, "plain_"),
           **call_cost(lambda: F.scaled_dot_product_attention(
               q4, k4, v4, attn_mask=band), flush, "library_"),
           **_bound(4 * q.numel() * q.element_size(), 4.0 * pairs * d,
                    BF16_FLOPS if bf16 else FP32_FLOPS)}
    if bf16:
        ref = KS.swa_attention_plain(q, k, v, w, **kw)
        rec.update(_flex_yardstick(q4, k4, v4, w, scale, ref, flush))
    return rec


def _check_swa_train(KS, name: str, shape: dict, window: int,
                     seed: int = 7):
    """``SWAAttention``'s kernels on one bf16 geometry: the forward with
    its log-sum-exp (o bit-equal to the launch without it, lse against
    ``swa_lse_plain``), and the backward's dq, dk and dv against autograd
    of the plain version (``SWA_BWD_TOL`` of each leaf's max |g|, or of
    the largest leaf's where a leaf's is zero), rerun bit-equal.  Returns
    the record and the tensors for timing."""
    import torch
    q, k, v = _swa_inputs(dtype=torch.bfloat16, seed=seed, **shape)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    h, group = shape["h"], shape["h"] // shape["hkv"]
    scale = q.shape[-1] ** -0.5
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device="cuda")
    o = KS.launch(q, k, v, window, h, group, scale, 128, 128, lse=lse)
    same_o = bool(torch.equal(o, KS.launch(q, k, v, window, h, group,
                                           scale, 128, 128)))
    lse_err = float((lse - KS.swa_lse_plain(q, k, window, num_q_heads=h,
                                            group=group)).abs().max())
    torch.cuda.empty_cache()
    got = KS.launch_bwd(q, k, v, o, lse, do, window, h, group, scale)
    again = KS.launch_bwd(q, k, v, o, lse, do, window, h, group, scale)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        KS.swa_attention_plain(*leaves, window, num_q_heads=h, group=group),
        leaves, do)
    del leaves
    torch.cuda.empty_cache()
    # a leaf whose reference is exactly zero (window 1: a row's one key
    # takes all its weight, so dS = 0) is held to the largest leaf's scale
    top = max(float(w.float().abs().max()) for w in want)
    rels = {n: (_max_rel(a, b) if float(b.float().abs().max()) > 0 else
                float((a.float() - b.float()).abs().max()) / top)
            for n, a, b in zip(("dq", "dk", "dv"), got, want)}
    rerun = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    rec = {"geometry": name, **shape, "window": window,
           "o_equal_without_lse": same_o, "lse_max_abs_err": lse_err,
           "lse_tol": SWA_LSE_TOL, "max_rel_err": rels,
           "tol": SWA_BWD_TOL, "bit_equal_rerun": rerun,
           "ok": same_o and lse_err <= SWA_LSE_TOL and rerun
           and max(rels.values()) <= SWA_BWD_TOL}
    return rec, (q, k, v, o, lse, do, window, h, group, scale)


def _check_banded_grads(name: str, shape: dict, window: int,
                        seed: int = 11) -> dict:
    """``banded_attention``, the model's entry to the training kernels
    (reshape, ``SWAAttention``'s checks, saved tensors, dO made
    contiguous), on 4-D bf16 CUDA tensors laid out as ``apply_attention``
    hands them over: q, k, v and dO (B, H, N, d) views of (B, N, H, d)
    tensors.  o against ``dense_attention`` (max |Δ|, 3e-2) and the
    gradients of the three tensors against autograd of
    ``dense_attention`` on the same views (``SWA_BWD_TOL`` of each leaf's
    max |g|)."""
    import torch
    from repro_torch.core.attention import dense_attention
    from repro_torch.kernels import swa as KS
    b, h, hkv, n, d = (shape[x] for x in ("b", "h", "hkv", "n", "d"))
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rows(heads, mul=1.0):
        x = torch.randn((b, n, heads, d), generator=gen, device="cuda")
        return (x * mul).bfloat16().requires_grad_()

    bases = [rows(h, 0.5), rows(hkv, 0.5), rows(hkv)]
    do = rows(h).detach().permute(0, 2, 1, 3)

    def heads_first():
        return [t.permute(0, 2, 1, 3) for t in bases]

    KS.LAUNCHES = KS.BWD_LAUNCHES = 0
    o = KS.banded_attention(*heads_first(), window)
    got = torch.autograd.grad(o, bases, do)
    launched = (KS.LAUNCHES, KS.BWD_LAUNCHES)
    o, got = o.detach(), [g.detach() for g in got]
    torch.cuda.empty_cache()
    o_ref = dense_attention(*heads_first(), causal=True, window=window)
    want = torch.autograd.grad(o_ref, bases, do)
    o_err = float((o.float() - o_ref.detach().float()).abs().max())
    del o_ref
    torch.cuda.empty_cache()
    rels = {n_: _max_rel(a, w) for n_, a, w in zip(("dq", "dk", "dv"), got,
                                                   want)}
    return {"geometry": name, **shape, "window": window,
            "layout": "(B, H, N, d) views of (B, N, H, d)",
            "launches": list(launched), "o_max_abs_err": o_err,
            "o_tol": 3e-2, "max_rel_err": rels, "tol": SWA_BWD_TOL,
            "ok": launched == (1, 1) and o_err <= 3e-2
            and max(rels.values()) <= SWA_BWD_TOL}


def _time_swa_bwd(KS, case, flush) -> dict:
    """At one shape: the backward's two passes alone, the forward with its
    log-sum-exp alone, the plain backward, causal SDPA's backward (dense,
    a yardstick the port never calls) and the backward's bound (q, k, v,
    o, dO read, dq, dk, dv written; 10·d flops a query head and key)."""
    import torch
    import torch.nn.functional as F
    q, k, v, o, lse, do, window, h, group, scale = case
    bh, n, d = q.shape
    pairs = bh * sum(min(t + 1, window) for t in range(n))
    args = (q, k, v, o, lse, do, window, h, group, scale)
    rec = {"kernel_only_ms": cuda_events_ms(lambda: KS.launch_bwd(*args),
                                            flush=flush),
           "fwd_lse_kernel_only_ms": cuda_events_ms(
               lambda: KS.launch(q, k, v, window, h, group, scale, 128, 128,
                                 lse=lse), flush=flush),
           "plain_device_ms": cuda_events_ms(
               lambda: KS.swa_backward_plain(q, k, v, o, lse, do, window,
                                             num_q_heads=h, group=group,
                                             scale=scale),
               reps=5, flush=flush),
           **_bound(_nbytes(q, k, v, o, do) + _nbytes(q, k, v),
                    10.0 * pairs * d, BF16_FLOPS)}
    torch.cuda.empty_cache()
    if group == 1:
        q4, k4, v4 = (x.detach()[None].requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        rec["library_ms"] = cuda_events_ms(
            lambda: torch.autograd.grad(out, (q4, k4, v4), do[None],
                                        retain_graph=True), flush=flush)
    return rec


def phase_swa():
    """``swa_attention``'s CUDA kernel against its plain version
    (``dense_attention`` with the window) in bf16 (the tensor-core body,
    3e-2) and fp32 (the SIMT body, 2e-4): moba-340m's SWA shapes (one
    sequence of 8192 tokens, 16 heads of 64, window 256) and the same at
    d 128, GQA (16 heads on 8 kv heads at d 128; 32 on 4 at d 128),
    window 100 with q_tile 128 / k_tile 64, a window at least N, window
    1, and N 96 (a ragged tile).  First the tensor-core audit of the
    forward's and the backward's libraries.  Then times at the moba-340m
    shapes, d 64 and d 128, bf16 and fp32 (``_time_swa``).  Then the
    training kernels, bf16 (``_check_swa_train``, ``_time_swa_bwd``):
    the forward's log-sum-exp and the backward at a moba-340m
    microbatch's SWA shape (2 x 16 heads) and six more geometries; and
    ``banded_attention`` on the model's layout against autograd of
    ``dense_attention`` (``_check_banded_grads``).  Phase 6 counts the
    training path's launches."""
    import torch
    from repro_torch.kernels import swa as KS
    audit = _tensor_core_audit("swa", ("swa", "swa_bwd"))
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [("moba-340m", dict(b=1, h=16, hkv=16, n=TRAIN_SEQ, d=64),
              dict(window=256)),
             ("gqa-d128", dict(b=2, h=16, hkv=8, n=2048, d=128),
              dict(window=256)),
             ("window-100", dict(b=1, h=16, hkv=16, n=4096, d=64),
              dict(window=100, q_tile=128, k_tile=64)),
             ("window-ge-n", dict(b=2, h=4, hkv=4, n=1024, d=64),
              dict(window=1500)),
             ("n-96", dict(b=1, h=4, hkv=4, n=96, d=64), dict(window=40)),
             ("window-1", dict(b=1, h=16, hkv=16, n=2048, d=64),
              dict(window=1)),
             ("moba-340m-d128", dict(b=1, h=16, hkv=16, n=TRAIN_SEQ, d=128),
              dict(window=256)),
             ("gqa-g8", dict(b=2, h=32, hkv=4, n=4096, d=128),
              dict(window=256))]
    timed = ("moba-340m", "moba-340m-d128")
    tols = {bf16: 3e-2, fp32: 2e-4}
    checks, mains = [], {}
    KS.LAUNCHES = 0
    for name, shape, opts in cases:
        for dtype in (bf16, fp32):
            q, k, v = _swa_inputs(dtype=dtype, seed=5, **shape)
            kw = dict(num_q_heads=shape["h"],
                      group=shape["h"] // shape["hkv"])
            out = KS.swa_attention(q, k, v, **opts, **kw)
            ref = KS.swa_attention_plain(q, k, v, opts["window"], **kw)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            tol = tols[dtype]
            ok = bool(torch.allclose(out.float(), ref.float(), atol=tol,
                                     rtol=tol)) and out.dtype == dtype
            checks.append({"geometry": name, "dtype": str(dtype),
                           **opts, "max_abs_err": err, "tol": tol,
                           "ok": ok})
            if not ok:
                emit({"phase": "swa", "checks": checks})
                raise SystemExit(f"swa: the kernel disagrees with its plain "
                                 f"version: {checks[-1]}")
            if name in timed:
                mains[name, dtype] = (q, k, v, opts["window"], kw, err)
            del out, ref
            torch.cuda.empty_cache()
    launches = KS.LAUNCHES
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    timing = {}
    for (name, dtype), (q, k, v, w, kw, err) in mains.items():
        timing[f"{name}:{str(dtype).split('.')[-1]}"] = {
            **_time_swa(KS, q, k, v, w, kw, flush), "max_abs_err": err,
            "shape": [1, q.shape[0], q.shape[1], q.shape[2]], "window": w}
    del mains
    torch.cuda.empty_cache()
    # training: the forward's log-sum-exp and the backward, bf16
    train_cases = [("moba-340m-train", dict(b=2, h=16, hkv=16, n=TRAIN_SEQ,
                                            d=64), 256),
                   ("gqa-d128", dict(b=2, h=16, hkv=8, n=2048, d=128), 256),
                   ("gqa-g8", dict(b=2, h=32, hkv=4, n=2048, d=128), 256),
                   ("window-100-ragged", dict(b=1, h=4, hkv=2, n=1000,
                                              d=64), 100),
                   ("window-ge-n", dict(b=2, h=4, hkv=4, n=1024, d=64), 1500),
                   ("n-96", dict(b=1, h=4, hkv=4, n=96, d=64), 40),
                   ("window-1", dict(b=1, h=16, hkv=16, n=2048, d=64), 1)]
    train_checks, train_timing = [], {}
    KS.BWD_LAUNCHES = 0
    for name, shape, w in train_cases:
        rec, case = _check_swa_train(KS, name, shape, w)
        torch.cuda.synchronize()
        train_checks.append(rec)
        if not rec["ok"]:
            emit({"phase": "swa", "train_checks": train_checks})
            raise SystemExit(f"swa: the training kernels disagree with the "
                             f"plain version: {rec}")
        if name in ("moba-340m-train", "gqa-d128"):
            train_timing[name] = {
                **_time_swa_bwd(KS, case, flush),
                "shape": list(case[0].shape), "window": w}
        del case
        torch.cuda.empty_cache()
    # the model's entry (banded_attention) on the model's layout
    wrapper_checks = [
        _check_banded_grads("moba-340m-train", dict(b=2, h=16, hkv=16,
                                                    n=TRAIN_SEQ, d=64), 256),
        _check_banded_grads("gqa-d128", dict(b=2, h=16, hkv=8, n=TRAIN_SEQ,
                                             d=128), 256)]
    torch.cuda.empty_cache()
    if not all(r["ok"] for r in wrapper_checks):
        emit({"phase": "swa", "wrapper_checks": wrapper_checks})
        raise SystemExit(f"swa: banded_attention's output or gradients "
                         f"disagree with dense_attention's: "
                         f"{wrapper_checks}")
    emit({"phase": "swa", "replaces": "src/repro/kernels/swa.py:77",
          "tensor_core_audit": audit, "cta_rows": KS.CTA_ROWS,
          "key_chunk": KS.KEY_CHUNK, "row_slice": KS.ROW_SLICE,
          "checks": checks, "launches": launches, "timing": timing,
          "train_checks": train_checks, "train_timing": train_timing,
          "wrapper_checks": wrapper_checks})
    return launches, timing, train_timing


# ------------------------------------------------------------------- --ab
# ------------------------------------------------------------------ phase 9
DRYRUN_CELLS = (("moba-340m", "train_4k"), ("qwen3-0.6b", "decode_32k"))
DRYRUN_PEAK_TOL = 0.15             # predicted peak against the card's
DRYRUN_TIMED_STEPS = 2
DRYRUN_TIMEOUT_S = 300


def phase_dryrun():
    """Phase 9: the CLI's two cells, and phase 6's step costed on a 1 × 1
    layout then run on the card: FLOPs equal, peak within 15%, step ms
    against the roofline bound."""
    import tempfile

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Layout
    from repro_torch.launch import dryrun as DR

    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--archs", arch,
         "--shapes", shape, "--mesh", "single", "--out", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for arch, shape in DRYRUN_CELLS]
    try:
        cfg = get_config("moba-340m")
        shape = (TRAIN_SEQ, 1, "train")
        t0 = time.perf_counter()
        rl = DR.cost_cell("moba-340m", shape, Layout((1, 1),
                                                     ("data", "model")),
                          cfg=cfg, verbose=False)
        cost_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()

        def reset(_params):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

        with FlopCounterMode(display=False) as fc:
            DR.run_step(cfg, shape, device="cuda", on_params=reset)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        flops = fc.get_total_flops()
        step_ms = []
        for _ in range(DRYRUN_TIMED_STEPS):
            gc.collect()
            torch.cuda.empty_cache()
            marks = {}

            def start(_params):
                torch.cuda.synchronize()
                marks["t0"] = time.perf_counter()

            DR.run_step(cfg, shape, device="cuda", on_params=start)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - marks["t0"]) * 1e3)
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        cli = []
        for (arch, cell), proc in zip(DRYRUN_CELLS, procs):
            try:
                out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            cli.append((arch, cell, proc.returncode, out, err))
    for arch, cell, rc, out, err in cli:
        print(out[out.find("arch "):].split("\n\nwall")[0], flush=True)
    bound_ms = max(rl.t_compute, rl.t_memory, rl.t_collective) * 1e3
    measured = peak - base
    median = float(np.median(step_ms))
    rec = {"phase": "dryrun", "cost_cell_s": cost_s,
           "cli": {f"{a}__{c}": {"rc": rc, "json": os.path.exists(
               os.path.join(out_dir, f"{a}__{c}__single.json")),
               "wall": out[out.rfind("wall "):].split("\n")[0]}
               for a, c, rc, out, _ in cli},
           "step": {"arch": cfg.name, "batch": 1, "seq": TRAIN_SEQ,
                    "backend": DR.BACKEND, "remat": True, "layout": "1x1"},
           "flops_predicted": rl.flops_per_device, "flops_card": flops,
           "peak_predicted_bytes": rl.peak_memory_bytes,
           "peak_state_bytes": rl.detail["state_bytes"],
           "peak_activation_bytes": rl.detail["activation_peak_per_device"],
           "max_memory_allocated": peak, "allocated_before": base,
           "peak_card_bytes": measured,
           "peak_ratio": rl.peak_memory_bytes / measured,
           "peak_tol": DRYRUN_PEAK_TOL, "step_ms": step_ms,
           "median_step_ms": median, "bound_ms": bound_ms,
           "bound_by": rl.bottleneck,
           "t_compute_ms": rl.t_compute * 1e3,
           "t_memory_ms": rl.t_memory * 1e3,
           "share_of_bound": bound_ms / median,
           "bytes_predicted": rl.bytes_per_device,
           "model_flops": rl.model_flops}
    emit(rec)
    for arch, cell, rc, out, err in cli:
        if rc != 0 or "costed OK" not in out:
            raise SystemExit(f"dryrun: the CLI on {arch} × {cell} exited "
                             f"{rc}: {out[-1500:]} {err[-1500:]}")
    if flops != rl.flops_per_device:
        raise SystemExit(f"dryrun: the card's step ran {flops} FLOPs, the "
                         f"meta trace predicted {rl.flops_per_device}")
    if abs(rl.peak_memory_bytes - measured) > DRYRUN_PEAK_TOL * measured:
        raise SystemExit(f"dryrun: predicted peak {rl.peak_memory_bytes} "
                         f"is not within {DRYRUN_PEAK_TOL:.0%} of the "
                         f"card's {measured}")
    return rec


def _ab_decode() -> dict:
    """The decode call at the moba-340m phase-2 case with bf16 q and pool:
    ``call_cost`` of the call and of the library call, and the reading
    without the spin."""
    import torch
    from repro_torch.configs.base import MoBAConfig
    from repro_torch.core.moba import moba_paged_route
    from repro_torch.kernels import moba_decode as MD
    cfg = MoBAConfig(block_size=128, top_k=8)
    q, pool, table, kv = _paged_case(
        b=8, h=16, hkv=16, d=64, ps=128, npg=33, num_pages=320,
        kv_lens=[0, 1, 128, 100, 1500, 3000, 4224, 2777],
        dtype=torch.bfloat16, seed=7)

    def call():
        return MD.moba_paged_decode(q, pool["pages_k"], pool["pages_v"],
                                    pool["centroids"], table, kv, cfg)

    idx, sel_valid = moba_paged_route(q, pool["centroids"], table, kv, cfg)
    library = decode_library(q, pool, table, kv, idx, sel_valid)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    out = call()
    torch.cuda.synchronize()
    return {"finite": bool(torch.isfinite(out).all()),
            **call_cost(call, flush),
            "ms_no_hold": cuda_events_ms(call, flush=flush, hold="none"),
            **call_cost(library, flush, "library_")}


def _ab_train_kernels() -> dict:
    """Device ms of the Flash TopK launch, ``moba_fwd.launch`` and
    ``moba_bwd.launch`` alone on the phase-5 moba-340m bf16 case, dO in
    the dtype the tree's backward wrapper takes; Flash TopK also at the
    small-block shape (block 32, top_k 32: the register list's largest
    bucket), at phase 5's ``top_k-64`` shape (the shared-memory lists)
    and in fp32 (the SIMT body)."""
    import torch
    from repro_torch.kernels import flash_topk as KT
    from repro_torch.kernels import moba_bwd as KB, moba_fwd as KF, ref
    c = _train_case(h=16, hkv=16, n=TRAIN_SEQ, nq=TRAIN_SEQ, d=64,
                    dtype=torch.bfloat16, seed=11)
    lay, kw, tile = c["lay"], c["kw"], c["tile"]
    fkw = {k: v for k, v in kw.items() if k != "block_size"}
    args = (lay.tile_block, c["q_sorted"], c["q_pos"], c["k_blocks"],
            c["v_blocks"])
    _, m, l = ref.moba_partials_ref(*args, **kw)
    lse = m.clamp(min=-5e29) + torch.log(l.clamp(min=1e-30))
    do = torch.randn(c["q_sorted"].shape[:-1] + c["v"].shape[-1:],
                     generator=c["gen"], device="cuda").to(_do_dtype(KB, c))
    delta = torch.randn(lse.shape, generator=c["gen"], device="cuda") * 0.1
    tables = KB.segments(lay.tile_block, c["nb"])
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    # the register list at its largest bucket (the small-block shape), the
    # shared-memory lists (phase 5's top_k-64 shape) and the fp32 body
    more = {"k32": dict(n=TRAIN_SEQ, dtype=torch.bfloat16, bs=32,
                        top_k=32),
            "k64": dict(n=4096, dtype=torch.bfloat16, bs=16, top_k=64),
            "fp32": dict(n=TRAIN_SEQ, dtype=torch.float32)}
    rec = {"do_dtype": str(do.dtype)}
    for key, kw in more.items():
        ck = _topk_case(h=16, hkv=16, nq=kw["n"], d=64, seed=11, **kw)
        # Flash TopK through its wrapper, whose only device work is the
        # launch (the trees' ``launch`` signatures differ)
        rec[f"flash_topk_{key}_ms"] = cuda_events_ms(
            lambda: KT.flash_topk(ck["qf"], ck["cents"], ck["top_k"],
                                  ck["bs"], group=1, num_q_heads=16,
                                  q_tile=ck["tile"]), flush=flush)
    return {**rec,
            "flash_topk_ms": cuda_events_ms(
                lambda: KT.flash_topk(c["qf"], c["cents"], c["top_k"],
                                      c["bs"], group=c["g"],
                                      num_q_heads=c["h"], q_tile=tile),
                flush=flush),
            "moba_fwd_ms": cuda_events_ms(
                lambda: KF.launch(*args, q_tile=tile, kb_tile=128,
                                  causal=True, **fkw), flush=flush),
            "moba_bwd_ms": cuda_events_ms(
                lambda: KB.launch(tables, c["q_sorted"], c["q_pos"], do, lse,
                                  delta, c["k_blocks"], c["v_blocks"],
                                  q_tile=tile, causal=True, **fkw),
                flush=flush)}


def _ab_swa() -> dict:
    """Device ms of ``swa_attention`` through its public wrapper (whose
    API both trees share; its only device work is the launch and the
    output's allocation) at moba-340m's SWA shape: bf16 and fp32 at d 64,
    bf16 at d 128."""
    import torch
    from repro_torch.kernels import swa as KS
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    rec = {}
    for key, d, dtype in (("swa_bf16_ms", 64, torch.bfloat16),
                          ("swa_fp32_ms", 64, torch.float32),
                          ("swa_d128_ms", 128, torch.bfloat16)):
        q, k, v = _swa_inputs(b=1, h=16, hkv=16, n=TRAIN_SEQ, d=d,
                              dtype=dtype, seed=5)
        rec[key] = cuda_events_ms(
            lambda: KS.swa_attention(q, k, v, 256, num_q_heads=16),
            flush=flush)
    return rec


def _ab_one() -> dict:
    """One tree's numbers for ``--ab`` (its ``src`` first on the path)."""
    import torch
    from repro_torch.kernels import moba_decode
    rec = {"module": moba_decode.__file__, **_ab_decode(),
           **_ab_train_kernels(), **_ab_swa()}
    torch.cuda.empty_cache()
    _, _, losses, step_s = _train_run("flash")
    rec.update(train_losses=losses,
               train_median_step_ms=float(np.median(step_s[1:])) * 1e3)
    rec["finite"] = rec["finite"] and bool(np.isfinite(losses).all())
    return rec


AB_KEYS = ("ms", "device_ms", "loop_us", "ms_no_hold", "library_ms",
           "library_device_ms", "library_loop_us", "flash_topk_ms",
           "flash_topk_k32_ms", "flash_topk_k64_ms", "flash_topk_fp32_ms",
           "moba_fwd_ms", "moba_bwd_ms", "swa_bf16_ms", "swa_fp32_ms",
           "swa_d128_ms", "train_median_step_ms")


def ab(other: str) -> int:
    """The decode call, the FlashMoBA forward and backward launches,
    ``swa_attention`` and the training step of the checkout at ``other``
    and of this one, each in a process of its own, in the order other,
    this, this, other, so a drift of the card shows.  One JSON line a
    process, then each tree's medians and the ratio other / this."""
    trees = {"other": os.path.abspath(other), "this": ROOT}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    runs = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--ab-one", trees[which]],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        emit({"which": which, "tree": trees[which], **rec})
        if not rec["finite"]:
            return 1
        runs[which].append(rec)
    med = {w: {k: float(np.median([r[k] for r in rs])) for k in AB_KEYS}
           for w, rs in runs.items()}
    emit({"nvidia_smi": smi, "median": med,
          "other_over_this": {k: med["other"][k] / med["this"][k]
                              for k in AB_KEYS}})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port "
                                 "on one NVIDIA card and check it.")
    ap.add_argument("--ab", metavar="DIR",
                    help="instead of the phases, time the decode call, the "
                         "FlashMoBA forward and backward, swa_attention and "
                         "the training step of the checkout at DIR and of "
                         "this one")
    ap.add_argument("--ab-one", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from the "
              f"repository root", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ab_one:
        sys.path.insert(0, os.path.join(args.ab_one, "src"))
        emit(_ab_one())
        return 0
    sys.path.insert(0, SRC)
    if args.ab:
        return ab(args.ab)
    t_start, seconds = time.perf_counter(), {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    smi = timed("env", phase_env)
    timing = timed("kernel", phase_kernel)
    timed("kernel", phase_zero_ties)
    launches, kernel_launches = {}, {}
    launches["fp32"], kernel_launches["fp32"], bf16_bytes, _ = timed(
        "serve", phase_serve)
    for kv_dtype in KV_DTYPES[1:]:
        launches[kv_dtype], kernel_launches[kv_dtype], _, _ = timed(
            "serve_quantized", phase_serve, kv_dtype, QUANT_NEW_TOKENS,
            bf16_bytes)
    # key conv and qwen3-0.6b: the decode calls of each path (counts
    # zeroed inside phase_serve just before its run, read just after)
    decode_also = {}
    for kv_dtype, key in (("fp32", "serve_key_conv"),
                          ("int8", "serve_key_conv_int8")):
        decode_also[key] = timed(
            "serve_key_conv", phase_serve, kv_dtype, QUANT_NEW_TOKENS,
            key_conv_width=KEY_CONV_WIDTH, prefill_chunk=1000,
            phase="serve_key_conv")[:2]
    for kv_dtype in KV_DTYPES:
        timed("logits", phase_logits, kv_dtype)
    timed("key_conv_logits", phase_key_conv_logits)
    decode_also["serve_qwen3"] = timed(
        "serve_qwen3", phase_serve, arch="qwen3-0.6b", prompts=4,
        new_tokens=16, phase="serve_qwen3")[:2]
    timed("serve_qwen3", phase_logits, arch="qwen3-0.6b",
          phase="serve_qwen3_logits")
    decode_also["serve_adaptive"] = timed("serve_adaptive",
                                          phase_serve_adaptive)[:2]
    prefix_counts, _ = timed("serve_prefix", phase_serve_prefix)
    for case, key in (("bf16", "serve_prefix"),
                      ("bf16_cow", "serve_prefix_cow"),
                      ("kconv3", "serve_prefix_kconv3"),
                      ("int8_cow", "serve_prefix_int8")):
        decode_also[key] = prefix_counts[case]
    fixed_counts = timed("serve_fixed", phase_serve_fixed)
    decode_also["serve_stream"] = timed("serve_stream", phase_serve_stream)
    decode_also.update(timed("serve_openloop", phase_serve_openloop))
    timed("serve_http", phase_serve_http)
    decode_also["serve_sharded"] = timed("serve_sharded",
                                         phase_serve_sharded)
    decode_also["serve_moe"] = timed("serve_moe", phase_serve_moe)
    timed("serve_ssm", phase_serve_ssm)
    cross = {"serve_encdec": timed("serve_encdec", phase_serve_cross,
                                   ENCDEC_ARCH),
             "serve_vlm": timed("serve_vlm", phase_serve_cross, VLM_ARCH)}
    train_timing, train_err = timed("train_kernels", phase_train_kernels)
    train_launches, train_rec = timed("train", phase_train)
    examples_counts, decode_also["examples_serve_decode"] = timed(
        "examples", phase_examples, smi, train_rec)
    small_blocks = timed("train_small_blocks", phase_train_small_blocks)
    train_also = {"serve_fixed": fixed_counts,
                  "train_small_blocks": small_blocks["launches"],
                  "train_key_conv": timed("train_key_conv",
                                          phase_train_key_conv, train_rec)}
    accum = timed("train_accum", phase_train_accum)
    train_also["train_accum_microbatch"] = accum["microbatch"]
    train_also["train_accum_in_loss"] = accum["accum_in_loss"]
    timed("train_resume", phase_train_resume)
    timed("train_sp", phase_train_sp, train_rec["xla_losses"])
    train_also["train_dp_compressed"] = timed("train_dp_compressed",
                                              phase_train_dp_compressed)
    train_also["pipeline"] = timed("pipeline", phase_pipeline)
    timed("train_grads", phase_train_grads)
    timed("train_grads", phase_train_grads, block_size=32, top_k=32)
    timed("train_key_conv", phase_train_grads,
          key_conv_width=KEY_CONV_WIDTH)
    train_also["train_moe"] = timed("train_moe", phase_train_moe)
    timed("train_mla_kernels", phase_train_mla_kernels)
    timed("train_mla", phase_train_mla)
    train_also.update(cross)
    train_also["train_encdec"] = timed("train_encdec", phase_train_encdec)
    train_also["examples_quickstart"] = examples_counts
    _, swa_timing, swa_train_timing = timed("swa", phase_swa)
    timed("dryrun", phase_dryrun)
    emit({"phase_seconds": seconds,
          "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    kernels = []
    for kv_dtype in KV_DTYPES:
        t = timing[kv_dtype]
        budgets = ({"with_budgets": {
            k: {f: v[f] for f in ("ms", "device_ms", "loop_us",
                                  "kernel_only_ms", "mean_n_uniq",
                                  "bytes", "bound_ms", "bound_by")}
            for k, v in timing["budgets"].items()}}
            if kv_dtype == "fp32" else {})
        kernels.append({
            "name": "moba_paged_decode" + ("" if kv_dtype == "fp32"
                                           else f":{kv_dtype}"),
            "route": "cuda", "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "pool": "bf16" if kv_dtype == "fp32" else kv_dtype,
            "launches": launches[kv_dtype],
            "launches_are": "decode calls, each launching the route, "
                            "attention and merge kernels",
            "kernel_launches": kernel_launches[kv_dtype],
            **({"launches_also": {
                k: {"calls": c, "kernel_launches": n}
                for k, (c, n) in decode_also.items()
                if k.endswith("_int8") == (kv_dtype == "int8")}}
               if kv_dtype in ("fp32", "int8") else {}),
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "device_ms": t["device_ms"],
            "loop_us": t["loop_us"], "kernel_only_ms": t["kernel_only_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"], **budgets,
            **({"also_at": {"g1-d128": {
                k: timing["g1-d128"][k] for k in (
                    "ms", "device_ms", "kernel_only_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "max_abs_err")}}}
               if kv_dtype == "fp32" else {}),
            "checked": True})
    for name, (_, source, replaces) in TRAIN_KERNELS.items():
        t = train_timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_launches[name],
            "launches_also": {k: v[name] for k, v in train_also.items()},
            "max_abs_err": train_err[name], "ms": t["ms"],
            "device_ms": t["device_ms"], "kernel_only_ms": t["kernel_only_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **({"sdpa_yardstick_ms": t["sdpa_yardstick_ms"]}
               if "sdpa_yardstick_ms" in t else {}),
            **({"topk_yardstick_ms": t["topk_yardstick_ms"],
                "small_blocks": {
                    k: train_timing["flash_topk_small_blocks"][k]
                    for k in ("ms", "kernel_only_ms", "plain_ms",
                              "bound_ms", "bound_by", "topk_yardstick_ms",
                              "shape")},
                "alone_at": {
                    g: {k: r[k] for k in ("kernel_only_ms", "bound_ms",
                                          "bound_by", "shape")}
                    for g, r in train_timing["flash_topk_more"].items()}}
               if name == "flash_topk" else {}),
            "also_at": {g: {
                k: train_timing[g][name][k] for k in (
                    "ms", "kernel_only_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by")}
                for g in ("g1-d128", "g8-d128")},
            "checked": True})
    name, source, replaces = SWA_KERNEL
    t = swa_timing["moba-340m:bfloat16"]
    kernels.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": train_launches["swa"],
        "launches_also": {k: v["swa"] for k, v in train_also.items()
                          if isinstance(v, dict) and "swa" in v},
        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "device_ms": t["device_ms"], "kernel_only_ms": t["kernel_only_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        **{k: t[k] for k in ("flex_ms", "flex_error") if k in t},
        "also_at": {g: {k: r[k] for k in (
            "kernel_only_ms", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err", "shape", "flex_ms", "flex_error")
            if k in r}
            for g, r in swa_timing.items() if g != "moba-340m:bfloat16"},
        "checked": True})
    name, source = SWA_BWD_KERNEL
    t = swa_train_timing["moba-340m-train"]
    kernels.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": "none: the TPU kernel is forward only",
        "launches": train_launches["swa_bwd"],
        "launches_also": {k: v["swa_bwd"] for k, v in train_also.items()
                          if isinstance(v, dict) and "swa_bwd" in v},
        **{k: t[k] for k in ("kernel_only_ms", "fwd_lse_kernel_only_ms",
                             "plain_device_ms", "bound_ms", "bound_by",
                             "library_ms", "shape")},
        "also_at": {g: {k: r[k] for k in ("kernel_only_ms", "bound_ms",
                                          "bound_by", "shape")}
                    for g, r in swa_train_timing.items()
                    if g != "moba-340m-train"},
        "checked": True})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
