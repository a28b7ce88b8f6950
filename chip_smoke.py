"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without its
result line):
  1. device    — the card's name and power limit; TF32 off.
  2. build     — compile the eleven hand-written CUDA kernels (one nvcc
                 each, in parallel) from the sources in this checkout;
                 log the registers, spills and shared memory of the
                 tensor-core prefill bodies (prefill_mma.cuh, bf16, with
                 and without the logsumexp, at head_dim 64, 128, 192 and
                 MLA's; prefill_tf32.cuh, split TF32, 64, 128 and 192,
                 with and without the logsumexp) per head_dim and K/V
                 type, of the tensor-core backwards (backward_mma.cuh:
                 delta, dq, dk/dv, rope sum; 64, 128, 192 and MLA's;
                 backward_tf32.cuh, f32 in split TF32: delta, dk/dv, dq
                 at 64 and 128), of the split decode body
                 (decode_body.cuh), of the MLA decode body
                 (decode_mla.cuh) and of the tensor-core decode body
                 (decode_gqa_mma.cuh: bf16, f32 and f32 q over int8 K/V
                 at 64, 128 and 192, its layout and residency as the
                 card reports them; none may spill).
  3. kernels   — each kernel against its plain PyTorch version at the
                 served shapes, with its time beside the plain version's,
                 one library call's (where one exists) and its bound:
                 paged decode / prefill attention (K1/K2) at smollm-360m
                 heads (15/5, head_dim 64; batch 4 and 8, lengths up to
                 ~600) and at jamba heads (32/8, head_dim 128); the
                 launch floor (a one-thread kernel under the same Timer);
                 the selective scan (B5) at d_inner 8192, d_state 16, B/C
                 as split views of one x_proj output: batch 8, T = 1 and
                 32, cold and with carried state and t_valid, and cold at
                 T = 512 (batch 8 and 1), then its slab entry in place at
                 batch 8, T = 1 and 32 (a fresh row, idle rows on a live
                 row's and an unowned slab, the dump row; unowned slabs
                 bit-identical); the top-k gating (B6) at 8 and 256
                 tokens x 16 experts, top-2, a tie-laden case, and 256
                 tokens x 4 (top-4), 64 and 256 experts (top-8); the
                 dense engine's contiguous flash
                 prefill (B2) at batch 8, S = 512, causal and with a
                 128-token window, f32 and bf16, smollm and jamba heads
                 (bf16 K2 and B2 must run their tensor-core entries, the
                 ``*_mma`` ones, f32 ones the ``*_tf32`` ones), and its
                 dense decode (B4)
                 at batch 8, a 584-slot cache, smollm and jamba heads, a
                 partly filled cache and a full (wrapped) ring; the int8
                 paged decode (B3) and int8 paged prefill (K2q) at smollm
                 heads, f32 q over int8 pools with per-row scales (batch 4
                 and 8; B3 on its tensor-core entry
                 ``paged_decode_attention_quant_f32_tf32``, decode_body.cuh's
                 timed beside it; T = 32 for K2q, on its ``_tf32`` entry); the fused
                 transform (B7) at e4's (64, 224, 224, 3) uint8 -> f32 and
                 uint8 -> uint8, bit-exact.  Then the split decode body at
                 its split boundaries (K1, B3: rows of 0, 1, one split, one
                 split + 1 and all P * bs keys in one batch; B4: n_valid 1,
                 one split, one more, the whole cache, and its MLA entry
                 at B = 2, where 128 heads split), each decode entry
                 twice (the same bits), and the split-TF32 body's edges
                 (lengths 0, page straddles, T = 5 and 17; windows 16 and
                 128 at S = 77).  K2 also at the speculative verify shape
                 (smollm heads, B = 8, T = 5, bf16, ``_mma``) and the
                 draft's T = 2 catch-up, timed.  B2 contiguous and B4 at
                 DeepSeek-V3's MLA heads on MLA's own operands (128 heads,
                 q 192 = 128 + 64, k_nope and V 128 per head, one rope key
                 of 64 per token shared by every head; B = 8, S = 512
                 causal; a 640-slot latent cache, 576 valid, its rope keys
                 read in place; bf16) through their MLA entries
                 (``flash_attention_mla_bf16_mma``, the tensor-core body
                 at q/k 192 and V 128; ``decode_attention_mla_bf16``),
                 SDPA on the broadcast rope key and V beside, and the
                 numbers of the padded-operand form logged beside.  Then
                 B2 and B4 at the shapes phases 15 and 16 serve: B2
                 without the causal mask at whisper-tiny's encoder (6/6
                 heads of 64, B = 8, S = T = 1500, timed), with more
                 queries than keys (S = 100, T = 64) and at hd 128 (S =
                 T = 300), bf16 on ``_mma`` and f32 on ``_tf32``; B2
                 causal at qwen2-vl-72b's heads (64/8, hd 128, S = 1152,
                 timed); B4 over whisper's 1500-slot cross cache and at
                 qwen2-vl's heads (1183 of 1184 slots), timed in bf16.
                 Then B2's backward (``flash_backward.cu``; no TPU kernel:
                 the JAX package differentiates attention through XLA):
                 dq, dk, dv against torch.autograd of the plain version at
                 smollm heads, B = 8, S = 512, causal, bf16 and f32; jamba
                 heads; a 128-token window; MLA's heads on their own
                 operands; whisper's encoder without the mask (S = T =
                 1500); 100 queries over 64 keys (each of those in bf16
                 and f32); nemotron-4-340b's heads (96/8 of 192); each
                 row's entry checked (bf16: the tensor-core ``*_mma``
                 ones; f32 at 64 and 128: the split-TF32
                 ``flash_attention_backward_f32_tf32``, each timed beside
                 the CUDA-core f32 entry it replaces; head dim 48: the
                 CUDA-core one), two launches equal bit for bit, the MLA
                 backward's peak memory (no (B, T, H, 192) tensor); timed
                 against the plain version, SDPA's backward and 2.5x the
                 forward's operations.  Then the ``*_lse`` forward
                 entries (smollm, jamba, nemotron heads in bf16 and f32;
                 MLA heads): out equal to the served entries' bit for
                 bit, the logsumexp within 1e-5 of the plain version,
                 both timed.  Then the kernels at
                 nemotron-4-340b's heads (96/8, head_dim 192 = V, bf16,
                 G = 12) at phase 19's shapes: B2 at B = 8, S = T = 512
                 causal and K2 at T = 32 ending at position 512 through
                 the tensor-core body at 192, K1 and B4 over 544 keys,
                 each against its plain version and timed; B2 and K2
                 also through the earlier CUDA-core entries (on K/V
                 repeated to the 96 query heads: their blocks do not fit
                 G = 12 at 192) and B2' through its CUDA-core entry, in
                 the same call; then the same kernels in f32 (phase
                 20(b)'s types): B2 through ``flash_attention_f32_tf32``
                 (the split-TF32 body in 8-warp blocks at 192) beside the
                 CUDA-core f32 entry on K/V repeated to 96 heads, K2 with
                 f32 q over f32 and over bf16 pools and K2q over int8
                 pools (the ``_tf32`` entries), K1 and B4 over 544 keys.
                 Then B5's backward (B5',
                 ``selective_scan_backward.cu``; no TPU kernel: the JAX
                 package differentiates its scan through XLA): all seven
                 gradients against ``selective_scan_backward_plain`` at
                 jamba's training shape (B = 8, T = 512, d_inner 8192,
                 d_state 16, Bc/Cc split views at ldbc 288) in bf16 and
                 f32, at B = 1, at a ragged T = 300, and with a non-zero
                 h0 and an incoming dh_last; two launches the same bits;
                 timed against the plain version and its bound (no one
                 PyTorch call computes it), each row's device time split
                 between its scan and its sum of the partials (one
                 ``torch.profiler`` trace) and its partials' bytes (from
                 the grid that trace saw launched); the kernel's layout
                 as it reports it, registers and spills a thread, blocks
                 and clusters resident on the card, and from its compiled
                 code (``cuobjdump``, where the toolkit has it) its
                 MUFU.EX2 instructions a state value and its compute
                 passes' instructions a lane and step.
                 B5's checkpointing twin (``selective_scan_ckpt_bf16``):
                 y and h_last equal the served entry's bit for bit, both
                 timed.
  4. engine    — small f32 models serve the same prompts on the GPU
                 (through the kernels) and on the CPU (plain path); the
                 greedy tokens must be equal.  Paged: 2 layers at
                 smollm-360m's head geometry (K1, K2), and one jamba
                 period at smoke width (8 layers, 4 experts; K1, K2, B5,
                 B6), and the smollm-shaped model over an int8 pool (B3,
                 K2q; K1/K2 must not launch).  Dense (paged=False): the
                 same smollm-shaped model (B2, B4), with a 48-token sliding
                 window whose ring wraps (B2, B4), and the smoke jamba (B2,
                 B4, B5, B6); the paged kernels must not launch there.  B5
                 runs its slab entry in the paged step and the dense
                 decode, its plain entry only in the dense prefill wave.
  5. main path — ``repro_torch.launch.serve`` serves smollm-360m at full
                 width (random weights from seed 0, bf16 KV) through the
                 stream pipeline; K1 and K2 must have launched, K2 only
                 through its tensor-core entry.  Then a
                 profiler trace of the same engine: device busy share, the
                 kernels that take the device time, and the device-to-host
                 copies per step (2.22; under 2.5 checked: no decode call
                 reads a device tensor on the host).
  6. jamba     — the engine serves jamba-v0.1 at full width, one period
                 (8 layers: 1 attention + 7 mamba, 4 MoE with 16 experts
                 top-2; bf16, random weights from seed 0 made on the
                 card), 16 requests of 512 prompt tokens, 32 new tokens,
                 batch 8; the four paged-path kernels must have launched
                 and the dense ones must not, B5 only through its slab
                 entry.  Then a profiler trace of the same engine (as
                 every trace: device operations per device step).
  7. dense     — ``repro_torch.launch.serve --paged off`` serves
                 smollm-360m at full width and depth through the stream
                 pipeline on the dense engine (bf16 cache, batch 8,
                 capacity 584 as the launcher derives it, 16 requests of
                 up to 512 prompt tokens, 64 new, burst 8); B2
                 (contiguous, only through its tensor-core entry) and B4
                 must have launched and K1/K2 must not.  Then a profiler
                 trace.
  8. int8      — smollm-360m at full width and depth with f32 weights
                 (random, seed 0) serves phase 5's 16 requests through the
                 pipeline over an int8 pool (batch 8, chunk 32, burst 8);
                 B3 (only through ``paged_decode_attention_quant_f32_tf32``)
                 and K2q (only through its ``_tf32`` entry) must have
                 launched and K1/K2 must not.  Then
                 the same model over an f32 pool (K2 only through
                 ``paged_prefill_attention_f32_f32_tf32``): greedy-token agreement
                 logged, bytes per block f32/int8 = 512/136 asserted.
                 Then a profiler trace of the int8 engine.
  9. preproc   — ``videotestsrc ! tensor_converter ! tensor_transform
                 option=<e4 chain> backend=fused ! tensor_sink`` parsed
                 and run at 224x224x3 frames, then batched by
                 ``tensor_aggregator`` to e4's (64, 224, 224, 3); outputs
                 equal the numpy chain within 1e-6 and B7 must have
                 launched; frames per second and the host copies against
                 B7's device time are logged.
 10. front door — (a) at phase 4's size (the 2-layer f32 smollm-headed
                 model, the same over an int8 pool, the smoke jamba): the
                 requests go on the batch lane under one schedule, a
                 decoding slot preempted (spilled to host, restored into
                 other blocks), a mid-prefill slot preempted (restarted)
                 and one ``engine_step`` fault (every survivor spilled,
                 the pools rebuilt); the card's tokens must equal the CPU
                 port's under the same schedule and its own run without
                 it, and each path's kernels must launch (K1/K2; B3/K2q;
                 K1/K2, B5's slab entry, B6).  (b) smollm-360m at full
                 width and depth (bf16, bf16 pool; batch 8, chunk 32,
                 burst 8) behind a ``TensorQueryServer`` on
                 127.0.0.1:0: one client sends 8 batch-lane requests
                 (512-token prompts, 64 new) and, once all 8 stream, 8
                 interactive ones (128-512 tokens), which preempt batch
                 slots; all 16 must end ok with 64 tokens, every
                 preempted request restored, the pool clean after
                 ``drain``, K1 and K2 (``_mma``) launched.  TTFT by lane
                 (p50/p99, the client's clock), tok/s and peak memory are
                 logged, with the share of tokens equal to a direct run
                 without the server (bf16 need not be batch-invariant).
                 Then a second engine serves the 8 batch prompts with an
                 ``engine_step`` fault mid-decode (one restart), and a
                 full-width gather -> scatter -> gather of 37 blocks of
                 every layer's pool must be bit-exact.
 11. sampling and speculation — (a) at phase 4's size (the 2-layer f32
                 smollm-headed model; the draft is its first layer, the
                 same embedding and head): seeded sampling (temperature
                 0.8, top_k 16, seed 11) paged and dense, the card's
                 tokens equal to the CPU port's and paged == dense on the
                 card (B2/B4 in the dense run, K1/K2 in the paged); greedy
                 speculation (spec_k 4) equal to the CPU port's and to the
                 card's own non-speculative run, sampled speculation equal
                 to the CPU port's, K1 and K2 launched.  (b) smollm-360m at
                 full width (bf16, bf16 pool; batch 8, chunk 32; 16
                 requests of up to 512 prompt tokens, 64 new): the
                 launcher's pipeline at ``--temperature 0.8 --top-k 50
                 --seed 0`` (tok/s beside phase 5's greedy tok/s; the
                 sampler's device operations and ms per call at (8,
                 49152), the greedy argmax's beside them; a profiler trace
                 of the sampled engine); the engine directly with a
                 self-draft at spec_k 4, greedy (accept rate, tokens per
                 round, tok/s against the same prompts without
                 speculation, the share of equal tokens logged; K2 must
                 run at T = 5, through ``_mma``); the launcher at
                 ``--spec-k 4 --draft-config smollm-360m --temperature
                 0.8`` (all 16 ok, accept rate logged).
 12. xLSTM     — (a) the 2-layer f32 xlstm-350m smoke stack (one mLSTM,
                 one sLSTM) paged and dense: the card's greedy tokens equal
                 the CPU port's; no kernel launches (the blocks are plain
                 torch, as the reference's).  (b) xlstm-350m at full width
                 and depth (24 layers, d 1024, 4 heads of 512, 21 mLSTM +
                 3 sLSTM; bf16 over the default f32 cache_dtype, random
                 weights from seed 0): 8 requests of 128 prompt tokens, 16
                 new, through the launcher's pipeline, paged (batch 8,
                 chunk 32, burst 8, 8 slabs); tok/s, the slab bytes per
                 slot, then a profiler trace (device operations per step,
                 busy share); then request 0 preempted after two tokens
                 and restored through the batch lane, its tokens equal to
                 an unpreempted run's; then ``--arch xlstm-350m`` through
                 the launcher (paged, 8 requests).
 13. MLA       — (a) the deepseek-v3 smoke model (2 layers, f32, q/k head
                 48, v head 32, 4 experts) on the dense engine in both
                 decode forms: the card's tokens equal the CPU port's (B2,
                 B6, and B4 in the expanded form); the two forms' decode
                 logits on the card within 2e-3 (the reference's bound).
                 (b) deepseek-v3-671b at full width (d 7168, 128 heads,
                 q rank 1536, kv rank 512, vocab 129280) cut to 4 of its
                 61 layers: the 3 dense-prefix layers (d_ff 18432) and 1
                 MoE layer (256 experts top-8, 1 shared), plus the MTP
                 leaves (~16B bf16 parameters, ~32 GB): 8 requests of 128
                 prompt tokens, 16 new, batch 8, bf16 latent cache, in the
                 expanded form (B2 through ``flash_attention_mla_bf16_mma``,
                 B4 through ``decode_attention_mla_bf16``, B6) with a
                 profiler trace (and the operand-building copies), then
                 the absorbed form (B2, B6); then layer 0's served
                 operands through B2 (S = 128) and B4 (129 and 144 valid
                 slots) against their plain versions with phase 3's MLA
                 tolerances, and timed.  (a) runs the GQA entries over
                 the concatenated operands (f32, other dims).
 14. forward   — (a) ``apply`` (the full-sequence forward) of phase 4's
                 f32 models (the 2-layer smollm-headed stack; the jamba,
                 deepseek and xLSTM smoke stacks) on the card against the
                 CPU port, logits and aux within 1e-3 of the largest
                 logit, each path's kernels launched (B2; B5, B6; none
                 for xLSTM); ``SingleShot(model="smollm-360m:smoke",
                 framework="torch")`` on the card against the CPU.  (b)
                 smollm-360m at full width and depth (bf16): ``apply``
                 on (8, 512) tokens through ``SingleShot(fn=...,
                 framework="torch")``, B2 once a layer through ``_mma``;
                 its last row's argmax against ``prefill``'s.
 15. whisper   — whisper-tiny at full width and depth (4 + 4 layers, d
                 384, 6 heads, 1500 frames, vocab 51865, bf16; no cut) on
                 the dense engine: ``generate_batch`` of 8 x 4-token
                 prompts with (8, 1500, 384) frames from numpy seed 0, 64
                 new tokens; B2 through ``_mma`` 3 times a layer (the
                 encoder's and the cross-attention without the causal
                 mask), B4 twice a layer and step (self, and cross over
                 all 1500 slots).  The smoke config in f32: card tokens
                 equal the CPU port's.  Then a trace.
 16. VLM       — qwen2-vl-72b at full width (d 8192, 64/8 heads of 128,
                 M-RoPE, d_ff 29568, vocab 152064, bf16) cut to 8 of 80
                 layers (~9.5B random parameters made on the card):
                 ``generate_batch`` of 8 requests of 1024 patch rows and
                 128 text tokens, 32 new; B2 (``_mma``) once a layer, B4
                 once a layer and step.  Then a trace.
 17. training  — (a) the f32 smoke configs of smollm, dbrx, deepseek-v3,
                 whisper-tiny and xlstm train 3 steps on the card and on the
                 CPU port from the same weights and ``TokenStream`` batches:
                 loss and grad norm per step within 1e-4 relative; B2's
                 forward and backward launch (B6 for the MoE configs,
                 nothing for xLSTM) through the entries the head dim
                 picks (64: ``flash_attention_f32_tf32_lse`` and
                 ``flash_attention_backward_f32_tf32``; deepseek's GQA
                 form at 48: the served forward and the CUDA-core
                 backward); so does the
                 jamba smoke stack (8 layers, 7 mamba), B5 only through
                 its checkpointing twin and B5' once a mamba layer and
                 step, each card step held to the CPU port at the card's
                 weights (``FORCED_ARCHS``: free-running, the two part
                 whatever the kernels do; logged), then again with
                 ``remat=True``: the twin twice a layer and step, the
                 losses equal bit for bit.  (b) ``python -m
                 repro_torch.launch.train --arch smollm-360m --steps 30
                 --batch 8 --seq 512`` at full width and depth (32 layers,
                 bf16; no cut) in process: finite, falling loss, B2's
                 forward (only ``_mma_lse``) and backward (only
                 ``_bf16_mma``) once a layer and step, ms per step,
                 tokens/s, peak memory, the checkpoint restored bit for
                 bit, a trace of one step; then the same run with
                 ``--remat``: the forward launches twice a layer and step,
                 the losses equal the plain run's bit for bit, the peak
                 memory is lower.  (c) jamba-v0.1 at full width, one
                 period (phase 6's model, bf16): ``model.loss`` and the
                 gradients of every leaf on 8 x 512 tokens, 3 steps of
                 plain SGD in place (the port's AdamW does not fit one
                 card at 13.30B parameters): loss and gradients finite,
                 the loss falling; B5's twin and B5' 7 times a step, B2
                 (``_mma_lse``) and B2' (``_bf16_mma``) once, B6 4 times;
                 tokens/s, ms a step, peak memory, a trace of one step
                 (B5''s share), and layer 0's scan operands, captured in
                 the step, through B5' against its plain version.
 18. tensor-parallel serving — the paged engine over a two-rank mesh on
                 the one card (``make_serving_mesh(2, ["cuda:0"] * 2)``:
                 one thread per rank, the same SMs).  (a) The launcher's
                 four f32 families (transformer, mamba, xlstm, hybrid):
                 the mesh's greedy tokens equal the card's ``mesh=None``
                 engine's and the CPU port's two-rank mesh's; every rank
                 launches K1/K2 (attention families) and B5 (mamba
                 families).  (b) smollm-360m at full width (32 layers, d
                 960, 15/5 heads split 9/3 and 6/2, vocab 49152), f32
                 weights over an f32 pool (phase 8's model), 8 requests of
                 512 tokens and 32 new: the greedy tokens equal
                 ``mesh=None``'s and every logit is within
                 ``MESH_F32_TOL`` of the largest; then the same at bf16
                 over a bf16 pool through K1/K2's ``_mma``-served entries:
                 first-step logits within ``MESH_BF16_TOL`` of the
                 largest, the share of equal tokens logged.  Each rank's
                 launches by C entry, tok/s, peak memory, per-rank weight
                 and pool bytes.  (c) jamba-v0.1, one period at full width
                 (phase 6's model), 4 x 128 tokens, 16 new, mesh 2, B6 (8
                 experts a rank) on each rank: its bf16 weights computing
                 in f32 (B5's f32 slab entry at d_inner 4096, K2's
                 ``_tf32``): tokens equal, logits within ``MESH_F32_TOL``
                 of the largest; then in bf16 (B5's bf16 slab entry, K1/K2
                 at 16/4 heads, 8/2 a rank) with every expert tied to
                 expert 0 and capacity factor 8 (dropless), so that a
                 route flipped by rounding moves no output: first-step
                 logits within ``MESH_BF16_TOL`` of the largest, the
                 share of equal tokens logged.  In (b) and (c) every
                 rank launches each kernel, C entry by C entry, as often
                 as the engine without a mesh.  Then
                 ``launch.serve --smoke --mesh 1`` on the card.
 19. nemotron-4-340b — at full width (d 18432, 96/8 heads of 192,
                 layernorm, squared ReLU, rotary on half of each head,
                 d_ff 73728, vocab 256000, untied head; bf16, random
                 weights from seed 0 made on the card) cut to 4 of its 96
                 layers (~23.25B parameters, ~46.5 GB): (a) the paged
                 engine (bf16 pool, batch 8, chunk 32, burst 8) serves 8
                 requests of 512 tokens, 32 new: K2 only through
                 ``paged_prefill_attention_bf16_bf16_mma`` (the
                 tensor-core body at 192) once a layer and mixed step, K1
                 once a layer and decode step; tok/s, TTFT, peak memory,
                 a trace; (b) the dense engine, the same prompts: B2
                 through ``flash_attention_bf16_mma`` once a layer, B4
                 once a layer and decode step; (c) layer 0's q, k, v from
                 (b)'s prefill wave through B2 and B2' (the ``*_lse``
                 forward, then ``flash_attention_backward_bf16_mma``)
                 against their plain versions; (d) cut to 1 layer
                 (~12.9B parameters), 3 steps of plain SGD on 4 x 512
                 ``TokenStream`` tokens (AdamW's moments fit no card):
                 every loss and gradient finite, B2 through
                 ``_mma_lse`` and B2' through ``_bf16_mma`` once a step;
                 training tokens/s, ms a step, peak memory, a trace.
 20. f32       — (a) smollm-360m at full width and depth in f32 (32
                 layers, no cut; f32 weights from seed 0, GEMMs in plain
                 f32) trains 10 steps of 8 x 512 tokens with AdamW: B2
                 only through ``flash_attention_f32_tf32_lse`` and B2'
                 only through ``flash_attention_backward_f32_tf32`` (split
                 TF32 at head dim 64), once a layer and step; every loss
                 finite, the last 3 steps' mean below the first 3's; ms a
                 step, tokens/s, peak memory, a trace of one more step
                 (B2''s device time and share, the busy share); then 3
                 steps from the same weights with ``remat=True``: the
                 forward twice a layer and step, the losses equal the
                 plain run's bit for bit.  (b) nemotron-4-340b at full
                 width in f32 cut to 1 of 96 layers (~12.9B parameters,
                 51.6 GB, drawn on the card from seed 0): 4 prompts of 512
                 tokens, 16 new, over f32 pools, paged (K2 only through
                 ``paged_prefill_attention_f32_f32_tf32``, K1 through
                 ``paged_decode_attention_f32_f32_tf32``) and dense (B2
                 through ``flash_attention_f32_tf32``, B4 through
                 ``decode_attention_f32_f32_tf32``), launches against
                 layers x steps; layer 0's q, k, v from the dense prefill
                 through B2 against its plain version; tok/s, TTFT, peak
                 memory.
 21. glm4-9b   — (a) glm4-9b's heads (32/2, G = 16, head_dim 64, QKV
                 bias, half rotary) at d 256, 2 layers, f32: the card's
                 greedy tokens equal the CPU port's, paged and dense, K1
                 and B4 through the ``*_f32_f32_tf32`` entries.  (b)/(c)
                 glm4-9b at full width and depth (40 layers, ~9.4B random
                 bf16 parameters, no cut): 8 requests of 4096-token
                 prompts, 32 new, batch 8, paged (chunk 256: K2 through
                 ``_mma`` at G = 16, K1 through
                 ``paged_decode_attention_bf16_bf16_mma``) and dense (B2
                 through ``flash_attention_bf16_mma``, B4 through
                 ``decode_attention_bf16_bf16_mma``), launches against
                 layers x steps; tok/s, TTFT, peak memory, a trace each
                 (busy share, K1/K2 and B2/B4 device time).  (d)
                 glm4-9b at full width and depth in f32 (~9.4B
                 parameters, 37.6 GB, no cut) serves the same 8 requests
                 paged over an int8 pool, then over an f32 pool: B3 40 x
                 31 times, all through
                 ``paged_decode_attention_quant_f32_tf32``, K2q 40 x 16
                 through its ``_tf32`` entry, no other attention kernel
                 (f32 pool: K1/K2's ``_f32_f32_tf32``); tok/s, TTFT, peak
                 memory, a trace each (busy share, B3's device time
                 against f32 K1's), the greedy tokens' agreement with the
                 f32 pool logged (not gated), bytes per block f32/int8 =
                 1024/264.
Phase 3 also times K1 and B4 through both decode bodies
(``decode_body.cuh`` and the tensor-core ``decode_gqa_mma.cuh``) at G = 1,
3, 4, 8, 12 and 16 (whisper-tiny's, smollm-360m's, jamba's, qwen2-vl's,
nemotron's and glm4's heads; B = 8, 544 keys, bf16 and f32), and at
nemotron's heads over 8192 keys and glm4's over 4160 and 8192 (bf16),
each against its plain version, SDPA and the bound: the rows that set
the dispatch's rule; wherever the dispatch now picks the tensor-core
body, the earlier body is timed beside it (``earlier_ms``).  B3 the same
way over int8 pools quantized from the f32 rows' pools (G = 1 to 16 over
544 keys, glm4's heads over 4160 and 8192; a row with no keys 0, two
launches the same bits), with f32 K1 on the keys it was quantized from
(``f32_k1_ms``).  And K2 (B = 8, T = 256 at positions 3840-4095) and B2
(B = 8, S = T = 4096, causal; its plain version at B = 1, whose f32
scores take 17.2 GB at B = 8) at glm4's heads, bf16.
Phases 4-16 (serving) must launch no backward entry, no ``*_lse``
forward entry and no checkpointing scan: every reset of the launch counts
checks it.
Two lines before the last is a JSON object with one entry per kernel
(K1/K2 launches from phase 5, B5/B6 from phase 6, B2-contiguous/B4 from
phase 7, B3/K2q from phase 8, B7 from phase 9; ``launches_phase11``:
phase 11's gated card runs; ``launches_phase13``: phase 13(b)'s two
runs; ``mla_heads``: B2's and B4's phase-3 rows at the MLA heads;
``mla_served``: the same at phase 13(b)'s shapes; ``launches_phase14``
to ``launches_phase16``: those phases' runs; ``slice_shapes``: B2's and
B4's phase-3 rows at phases 15 and 16's shapes; B2's backward: its
launches from phase 17(b), ``training_shapes`` its phase-3 rows (with
the ``*_lse`` forward rows under ``lse_entries``); B5's backward: its
launches from phase 17(c), ``training_shapes`` its phase-3 rows and the
twin's; ``launches_phase17``/``_phase17a``/``_phase17c`` every kernel's
in 17(b)/(a)/(c); ``launches_phase18`` every kernel's in phase 18's
mesh runs, ``launches_phase18_by_rank`` the same per rank;
``launches_phase19`` every kernel's in phase 19's runs,
``launches_phase20`` in phase 20's, ``launches_phase21`` in phase 21's;
``entries``: every C entry's launches summed over phases 4-21 (which body
served); ``nemotron_heads``: the phase-3 rows at nemotron-4-340b's heads,
the earlier CUDA-core body's time as ``earlier_ms``, the f32 rows under
``float32``; ``gqa_heads``: K1's, B4's and B3's rows by group size, the
other body's time as ``other_ms``, B3's with f32 K1's as ``f32_k1_ms``;
``slice_shapes`` also holds K2's and B2's rows at glm4's heads); then
the card's name and power limit; the last line is ``{"ok": true,
"device": {...}}``.  The whole run takes ~14 minutes on one H100, the
build included.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import importlib
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOL_REASON = ("bf16: the plain version rounds q*scale, the scores and the "
              "normalized probabilities to bf16 as the reference does; the "
              "kernel keeps scores in f32 and rounds the unnormalized "
              "probabilities; outputs are bf16 (8 significant bits)")
# bf16 tolerances of the dense engine's kernels, each just above the
# largest error seen on the card at these inputs: B2's outputs reach
# |out| ~ 3, where one bf16 ulp is 1.56e-2, and it differs by one ulp;
# B4's, averaged over 544+ keys, stay below 0.5, where an ulp is
# 1.95e-3, and it differs by up to two
DENSE_BF16_TOL = {"flash_attention": 2e-2, "decode_attention": 6e-3}
SCAN_TOL = 1e-4
SCAN_TOL_REASON = ("scan outputs are f32 of magnitude ~10: the kernel's "
                   "expf and fused multiply-adds against torch's exp and "
                   "separate products, and its sequential d_state sum "
                   "against einsum's")
PAGED_KERNELS = ("paged_decode_attention", "paged_prefill_attention")
DENSE_KERNELS = ("flash_attention", "decode_attention")
QUANT_KERNELS = ("paged_decode_attention_quant",
                 "paged_prefill_attention_quant")
ATTN_KERNELS = PAGED_KERNELS + DENSE_KERNELS + QUANT_KERNELS
# a CUDA trace also records the runtime calls that issue the device work
# (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...)
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")
E4_CHAIN = "typecast:float32,divide:255.0,subtract:0.5,clamp:-0.5:0.5"
SMOLLM_HEADS = dict(H=15, KV=5, hd=64)   # smollm-360m: 15 query, 5 KV heads
JAMBA_HEADS = dict(H=32, KV=8, hd=128)   # jamba-v0.1: 32 query, 8 KV heads
# nemotron-4-340b: 96 query heads, 8 KV heads (G = 12), head_dim 192, V 192
NEMOTRON_HEADS = dict(H=96, KV=8, hd=192)
NEMOTRON_CTX = 512      # phase 19's prompts: K2's last chunk ends here
NEMOTRON_CAP = 544      # and their capacity, 512 + 32 new
BS, P, MAX_LEN = 16, 40, 600       # block size, pages per slot, lengths
SPEC_K = 4                         # phase 11's draft tokens per round
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/decode_attention/kernel.py:195",
    "paged_prefill_attention": "src/repro/kernels/flash_attention/kernel.py:67",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:67",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:240",
    "selective_scan": "src/repro/kernels/ssm_scan/kernel.py:53",
    "gating_topk": "src/repro/kernels/moe_gating/kernel.py:35",
    "paged_decode_attention_quant":
        "src/repro/kernels/decode_attention/kernel.py:141",
    # the int8 form of K2 (the reference dequantizes in XLA for T > 1)
    "paged_prefill_attention_quant":
        "src/repro/kernels/flash_attention/kernel.py:67",
    "fused_transform": "src/repro/kernels/transform/kernel.py:31",
    # B2's gradient: no TPU kernel computes it (the JAX package
    # differentiates attention through XLA); B2's forward is the function
    "flash_attention_backward":
        "src/repro/kernels/flash_attention/kernel.py:67",
    # B5's gradient (B5'), likewise left to XLA by the JAX package
    "selective_scan_backward": "src/repro/kernels/ssm_scan/kernel.py:53"}
# phase 18: a two-rank mesh against no mesh, logits as a share of the
# largest logit.  f32: the ranks' partial sums add in another order than
# one device's matmul (rounding only); bf16: the partials are rounded to
# bf16 before they are summed, and a served step holds bf16 activations.
# jamba in bf16: at random weights its router is near uniform over 16
# experts, so bf16 rounding flips top-2 routes (each flip a jump; the
# engine without a mesh parts from itself by 7.2e-1 between prefill
# chunks of 16 and 32, PERF.md); its bf16 run ties every expert to expert
# 0 and drops nothing, so that a flipped route moves no output, and the
# model's own experts are checked computing in f32
MESH_F32_TOL = 1e-4
MESH_BF16_TOL = 5e-2
# the kernels only training launches, and the training entries of the
# others (*_lse forwards, B5's checkpointing twin)
BACKWARD_KERNELS = ("flash_attention_backward", "selective_scan_backward")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# serving (phases 4-16) must launch no backward entry, no *_lse forward
# entry and no checkpointing (*_ckpt_*) scan: only training's autograd
# Functions do.  While this is on, every reset first checks the launches
# since the last one.
SERVING_ONLY = {"on": False, "resets": 0}


def check_serving_launches(kernels, tag: str) -> None:
    for k in kernels:
        bad = {e: n for e, n in k.entry_launches.items() if n and (
            k.name in BACKWARD_KERNELS or e.endswith("_lse")
            or "_ckpt_" in e)}
        check(not bad, f"[{tag}] serving launched training entries {bad}")


# every C entry's launches summed over phases 4-21, each run's added at
# the reset after it (the JSON line's ``entries``: which body served)
ENTRY_TOTALS: dict = {}
COUNT_ENTRIES = {"on": False}


def reset(kernels) -> None:
    if SERVING_ONLY["on"]:
        check_serving_launches(kernels, "serving")
        SERVING_ONLY["resets"] += 1
    for k in kernels:
        if COUNT_ENTRIES["on"]:
            tot = ENTRY_TOTALS.setdefault(k.name, dict.fromkeys(k.entries, 0))
            for e, n in k.entry_launches.items():
                tot[e] += n
        k.reset_launches()


def check_served_by(kernels, name: str, entry: str, tag: str) -> None:
    """Every launch of kernel ``name`` since the last reset was of its C
    entry ``entry`` (which body served the run), and there was one."""
    k = next(k for k in kernels if k.name == name)
    check(k.launches > 0 and k.entry_launches[entry] == k.launches,
          f"{tag}: {name} launched {k.entry_launches}, not all {entry}")
    log(f"[{tag}] {name} launches by entry: "
        f"{ {e: n for e, n in k.entry_launches.items() if n} }")


# -- phase 1 --------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# -- phase 2 --------------------------------------------------------------------

def phase_build(kernels) -> None:
    from repro_torch.kernels.build import load_all
    t0 = time.perf_counter()
    paths = load_all(kernels)
    log(f"[build] {len(paths)} kernels built in "
        f"{time.perf_counter() - t0:.2f}s")
    for k, p in zip(kernels, paths):
        text = p.with_suffix(".log").read_text()
        report = [ln.strip() for ln in text.splitlines()
                  if "registers" in ln or "spill" in ln]
        log(f"[build] {k.name}: {p.relative_to(ROOT)}; "
            + " | ".join(report[:6]))
        _log_body_build(k.name, text)
    # what the card makes of the tensor-core decode body
    from repro_torch.kernels.decode_attention import ops as dops
    for k in (dops.KERNEL, dops.DENSE_KERNEL, dops.QUANT_KERNEL):
        for dt, hd in ((dt, hd) for dt in (
                ("int8",) if k is dops.QUANT_KERNEL else ("bf16", "f32"))
                for hd in dops.MMA_HEAD_DIMS):
            occ = dops.gqa_decode_occupancy(k, dt, hd)
            check(occ["spill_bytes"] == 0,
                  f"{k.name} tensor-core decode body {dt} hd {hd} spills")
            log(f"[build] {k.name} tensor-core decode body {dt} hd {hd}: "
                f"{occ}")


# the tensor-core backward's kernels (backward_mma.cuh)
BWD_MMA_KERNELS = ("delta_kernel", "dq_kernel", "dkdv_kernel",
                   "rope_sum_kernel")


def _log_body_build(name: str, text: str) -> None:
    """The redesigned bodies' instantiations in a ptxas report, registers
    and spills each: the tensor-core backward (backward_mma.cuh: its
    delta, dq, dk/dv and rope-sum kernels with their head dims and ring
    stages); B5''s scan kernel by its type and lanes a channel; the
    tensor-core bodies (prefill_mma.cuh, bf16;
    prefill_tf32.cuh, split TF32) with head_dim (q/k and V: they differ
    for MLA), ring stages and warps a block from the mangled template
    arguments and the
    dynamic shared memory the launch asks for (K and V tiles x stages x
    keys x padded rows, plus the int8 row scales, and q at head_dim 128
    in the TF32 body), the split decode body (decode_body.cuh) by its
    types and row policy, and the MLA decode body (decode_mla.cuh)."""
    elt = {"f": 4, "13__nv_bfloat16": 2, "a": 1}
    fn, props = None, []
    for ln in text.splitlines() + ["Compiling entry function 'end'"]:
        if "Compiling entry function" in ln:
            if fn and "prefill_mma_kernel" in fn:
                targs = fn.split("prefill_mma_kernel", 1)[1]
                hd, vd, stages, warps = map(int, re.findall(r"Li(\d+)E",
                                                            targs))
                # the ring, and q after it where it does not fit a stage
                # or is reread at every tile (V 192)
                stage, q = 64 * ((hd + 8) + (vd + 8)), warps * 16 * (hd + 8)
                smem = 2 * (stages * stage
                            + (q if q > stage or vd > 128 else 0))
                form = "MLA " if "MlaRows" in targs else ""
                form += "(+ logsumexp, the *_lse entries) " \
                    if "Lb1E" in targs else ""
                log(f"[build] {name} tensor-core body {form}hd {hd} v {vd}: "
                    f"{warps} warps, {stages} ring stages, {smem} bytes of "
                    f"dynamic shared memory; " + " | ".join(props))
            elif fn and "prefill_tf32_kernel" in fn:
                targs = fn.split("prefill_tf32_kernel", 1)[1]
                hd, stages = map(int, re.findall(r"Li(\d+)E", targs)[-2:])
                kv = next(t for t in ("13__nv_bfloat16", "f", "a")
                          if targs.startswith("I" + t))
                quant = "RowScales" in targs
                warps = 8 if hd > 128 else 4
                # the ring, and q (16 rows a warp x hd + 4 f32) at hd 128
                # and 192
                smem = stages * (2 * 32 * (hd * elt[kv] + 16)
                                 + (2 * 32 * 4 if quant else 0)) \
                    + (4 * warps * 16 * (hd + 4) if hd > 64 else 0)
                form = "(+ logsumexp, the *_lse entry) " \
                    if "Lb1E" in targs else ""
                log(f"[build] {name} split-TF32 body {form}kv "
                    f"{ {'f': 'f32', 'a': 'int8'}.get(kv, 'bf16')} hd {hd}: "
                    f"{warps} warps, {stages} ring stages, {smem} bytes of "
                    f"dynamic shared memory; " + " | ".join(props))
            elif fn and "bwd_tf32" in fn:
                kind = next(k for k in BWD_MMA_KERNELS if k in fn)
                hd = re.findall(r"Li(\d+)E", fn.split(kind, 1)[1])[0]
                log(f"[build] {name} split-TF32 backward {kind} hd {hd}: "
                    + " | ".join(props))
            elif fn and "bwd_mma" in fn:
                kind = next(k for k in BWD_MMA_KERNELS if k in fn)
                args = re.findall(r"Li(\d+)E", fn.split(kind, 1)[1])
                what = (f"hd {args[0]} v {args[1]} rope {args[2]}, "
                        f"{args[3]} ring stages, {args[4]} warps"
                        if len(args) == 5 else f"width {args[0]}")
                log(f"[build] {name} tensor-core backward {kind} {what}: "
                    + " | ".join(props))
            elif fn and "scan_backward_kernel" in fn:
                targs = fn.split("scan_backward_kernel", 1)[1]
                kind = "bf16" if targs.startswith("I13__nv_bfloat16") \
                    else "f32"
                lanes = re.findall(r"Li(\d+)E", targs)[0]
                log(f"[build] {name} B5' scan kernel {kind}, {lanes} lanes "
                    f"a channel: " + " | ".join(props))
            elif fn and "mla_decode_kernel" in fn:
                log(f"[build] {name} MLA decode body (decode_mla.cuh): "
                    + " | ".join(props))
            elif fn and "decode_gqa_kernel" in fn:
                targs = fn.split("decode_gqa_kernel", 1)[1]
                kind = "bf16" if targs.startswith("I13__nv_bfloat16") \
                    else "f32 q over int8" if "RowScales" in targs \
                    else "f32"
                hd = re.findall(r"Li(\d+)E", targs)[-1]
                rows = "paged" if "PagedRows" in targs else "contiguous"
                log(f"[build] {name} tensor-core decode body "
                    f"(decode_gqa_mma.cuh) {kind} hd {hd} {rows}: "
                    + " | ".join(props))
            elif fn and "decode_kernel" in fn:
                targs = fn.split("decode_kernel", 1)[1]
                names = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "int8"}
                qt, kvt = re.match(r"I(13__nv_bfloat16|f)(S2_|13__nv_bfloat16"
                                   r"|f|a)", targs).groups()
                rows = "paged" if "PagedRows" in targs else "contiguous"
                log(f"[build] {name} split decode body q {names[qt]} kv "
                    f"{names.get(kvt, names[qt])} {rows}: "
                    + " | ".join(props))
            fn, props = ln, []
        elif "registers" in ln or "spill" in ln:
            props.append(ln.strip())


# -- phase 3 --------------------------------------------------------------------

class Timer:
    """Mean device time of ``fn`` over ``iters`` launches, each on a cold
    L2 (a 64 MB buffer is rewritten before every launch: in serving, the
    other layers' weights and K/V pass through the 50 MB L2 between two
    calls for the same layer).  Before each launch the GPU spins for
    ~1 ms, so the host has enqueued the whole launch before the start
    event runs and the interval holds device time only, not the
    wrapper's Python."""

    SPIN_CYCLES = 2_000_000

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 30, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(iters):
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in events) / iters


def _attn_case(seed, B, T, qdt, kvdt, heads, pages=P):
    """Served-shape inputs: shuffled page tables of ``pages`` pages over a
    pool with spare blocks, cached lengths spread from one page up to
    MAX_LEN."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    H, KV, hd = heads["H"], heads["KV"], heads["hd"]
    nb = B * pages + 7
    q = torch.randn((B, T, H, hd), generator=g).to("cuda", qdt)
    k = torch.randn((nb, BS, KV, hd), generator=g).to("cuda", kvdt)
    v = torch.randn((nb, BS, KV, hd), generator=g).to("cuda", kvdt)
    pt = torch.stack([torch.randperm(nb, generator=g)[:pages]
                      for _ in range(B)]).to("cuda", torch.int32)
    # at least one page per slot: a slot with two or three keys outputs
    # nearly one V row, where one bf16 ulp of |v| ~ 4 exceeds the tolerance
    lengths = torch.linspace(BS, MAX_LEN - T, B).round().to(torch.int32)
    lengths = lengths[torch.randperm(B, generator=g)].to("cuda")
    return q, k, v, pt, lengths


def _visible_keys(lengths, T, decode: bool):
    """(B, T) keys each query row attends to, from this run's data."""
    cap = P * BS
    if decode:                            # lengths = valid keys
        return lengths.clamp(max=cap)[:, None]
    t = torch.arange(T, device=lengths.device)[None, :]
    return (lengths[:, None] + t + 1).clamp(max=cap)


def _bound(n_bytes: float, ops: float, dtype):
    """The larger of bytes over HBM bandwidth and operations over the
    peak rate for ``dtype``, in ms, and which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _attn_bound_ms(q, k, lengths, T, decode, heads):
    """Least time for the same work: the bytes it must move (q, the K/V
    rows of the keys this data makes visible, the page-table entries they
    sit in, lengths, out) and its operations (QK and PV, multiply and
    add) at the peak rate for the K/V type."""
    B, H, hd, KV = q.shape[0], heads["H"], heads["hd"], heads["KV"]
    vis = _visible_keys(lengths, T, decode)
    keys = vis.max(dim=1).values                      # rows read per slot
    kv_bytes = int(keys.sum()) * KV * hd * k.element_size() * 2
    pages = int(((keys + BS - 1) // BS).sum()) * 4
    qo_bytes = q.numel() * (q.element_size() + k.element_size())
    return _bound(kv_bytes + pages + qo_bytes + B * 4,
                  4 * H * hd * int(vis.sum()), k.dtype)


def _attn_library_call(q, k, v, pt, lengths, T, decode, heads):
    """One PyTorch call computing the same function (timed only as a
    yardstick; the port never calls it): SDPA over K/V gathered through
    the page table and expanded to the query heads beforehand."""
    from repro_torch.models.attention import paged_gather
    G = heads["H"] // heads["KV"]
    B = q.shape[0]
    kg = paged_gather(k, pt).transpose(1, 2).repeat_interleave(G, dim=1)
    vg = paged_gather(v, pt).transpose(1, 2).repeat_interleave(G, dim=1)
    qh = q.reshape(B, T, heads["H"], heads["hd"]).transpose(1, 2)
    qh = qh.to(kg.dtype)
    kpos = torch.arange(kg.shape[2], device=q.device)[None, None, :]
    last = (lengths - 1)[:, None] if decode else \
        lengths[:, None] + torch.arange(T, device=q.device)[None, :]
    mask = (kpos <= last[:, :, None])[:, None]        # (B, 1, T, C)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kg, vg, attn_mask=mask)


def _time_row(timer, kern, plain, args, library, bound):
    ms = timer.ms(lambda: kern(*args))
    plain_ms = timer.ms(lambda: plain(*args))
    lib_ms = timer.ms(library) if library is not None else None
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=lib_ms)


def _fmt(row) -> str:
    lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    return (f" kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={lib} bound_ms={row['bound_ms']:.5f} "
            f"({row['bound_by']})")


def phase_attention(timer: Timer):
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    specs = [
        ("paged_decode_attention", dops.paged_decode_attention,
         dops.paged_decode_attention_plain, 1, True, dops.KERNEL),
        ("paged_prefill_attention", fops.paged_prefill_attention,
         fops.paged_prefill_attention_plain, 32, False, fops.KERNEL)]
    f32, bf16 = torch.float32, torch.bfloat16
    geometries = [("smollm", SMOLLM_HEADS, (4, 8),
                   [(f32, f32), (f32, bf16), (bf16, bf16)]),
                  ("jamba", JAMBA_HEADS, (8,), [(f32, f32), (bf16, bf16)])]
    def case(name, kern, plain, T, decode, handle, geo, heads, B, qdt,
             kvdt):
        """Check one shape against the plain version (and that it ran its
        entry); time it where q and K/V share a type.  Returns (max abs
        error, timing row or None)."""
        q, k, v, pt, lengths = _attn_case(B * 7 + T, B, T, qdt, kvdt, heads)
        if decode:
            q = q[:, 0].contiguous()
        args = (q, k, v, pt, lengths)
        n0 = handle.launches
        entry = dops.decode_entry(name, qdt, kvdt,
                                  heads["H"] // heads["KV"], heads["hd"]) \
            if decode else fops.paged_prefill_entry(qdt, kvdt, heads["hd"])
        e0 = handle.entry_launches.get(entry, 0)
        out = kern(*args)
        torch.cuda.synchronize()
        check(handle.launches == n0 + 1, f"{name} did not launch")
        check(handle.entry_launches[entry] == e0 + 1,
              f"{name} did not launch {entry}")
        want = plain(*args)
        check(torch.isfinite(out.float()).all().item(),
              f"{name}: non-finite output")
        err = (out.float() - want.float()).abs().max().item()
        tol = TOL[kvdt]
        tag = (f"{name} {geo} heads {heads['H']}/{heads['KV']} "
               f"hd {heads['hd']} B={B} T={T} q={str(qdt)[6:]} "
               f"kv={str(kvdt)[6:]} [{entry}]")
        check(err <= tol, f"{tag}: max_abs_err {err} > {tol}")
        line = f"[kernels] {tag}: max_abs_err={err:.3e} (tol {tol})"
        row = None
        if qdt == kvdt:
            row = _time_row(timer, kern, plain, args,
                            _attn_library_call(*args, T, decode, heads),
                            _attn_bound_ms(q, k, lengths, T, decode, heads))
            line += _fmt(row)
        log(line)
        if row is not None and entry.endswith(("_mma", "_tf32")) and decode:
            # decode_body.cuh's entry on the same operands
            _earlier(timer, row, _decode_entry_run(
                dops, f"{name}_{dops._NAMES[qdt]}_{dops._NAMES[kvdt]}",
                args), want, tol, f"[kernels] {tag}")
        return err, row

    served = {}
    for name, kern, plain, T, decode, handle in specs:
        for geo, heads, batches, combos in geometries:
            for B in batches:
                for qdt, kvdt in combos:
                    err, row = case(name, kern, plain, T, decode, handle,
                                    geo, heads, B, qdt, kvdt)
                    if row is not None and geo == "smollm" and B == 8 \
                            and kvdt == bf16:
                        served[name] = dict(max_abs_err=err, **row)
    # the speculative verify step: T = spec_k + 1 = 5 tokens per row
    # (phase 11's shape), and the draft's T = 2 catch-up
    for T in (SPEC_K + 1, 2):
        case("paged_prefill_attention", fops.paged_prefill_attention,
             fops.paged_prefill_attention_plain, T, False, fops.KERNEL,
             "smollm", SMOLLM_HEADS, 8, bf16, bf16)
    log(f"[kernels] attention tolerance: f32 1e-5; {TOL_REASON}")
    return served


JAMBA_DT_RANK = 256      # jamba-v0.1: ceil(4096 / 16)


def _split_bc(Bc, Cc, dtr=JAMBA_DT_RANK):
    """Bc, Cc as the served path hands them to the scan: ``torch.split``
    views of one (B, T, dt_rank + 2N) x_proj output."""
    B, T, N = Bc.shape
    proj = torch.cat([torch.zeros((B, T, dtr), dtype=Bc.dtype,
                                  device=Bc.device), Bc, Cc], dim=-1)
    _, b, c = torch.split(proj, [dtr, N, N], dim=-1)
    return b, c


def _scan_case(seed, B, T, di, N, dtype, carried):
    """Selective-scan inputs as a Mamba layer makes them: dt from a
    softplus, A = -(1..N) per channel (the init's A_log), D = 1, Bc and
    Cc split views of one projection; with ``carried``, a random state
    slab and t_valid spread over [0, T]."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn((B, T, di), generator=g))
    xs = torch.randn((B, T, di), generator=g)
    Bc = torch.randn((B, T, N), generator=g)
    Cc = torch.randn((B, T, N), generator=g)
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(di, N)
    D = torch.ones(di)
    if carried:
        h0 = torch.randn((B, di, N), generator=g)
        t_valid = torch.randint(0, T + 1, (B,), generator=g, dtype=torch.int32)
        t_valid[0], t_valid[-1] = 0, T
    else:
        h0 = torch.zeros((B, di, N))
        t_valid = torch.full((B,), T, dtype=torch.int32)
    dt, xs, Bc, Cc = (a.to("cuda", dtype) for a in (dt, xs, Bc, Cc))
    return (dt, xs) + _split_bc(Bc, Cc) + tuple(
        a.contiguous().to("cuda") for a in (A, D, h0, t_valid))


def _scan_bound_ms(dt, xs, Bc, Cc, A, D, t_valid, state_in: int,
                   state_out: int, extra: int = 0):
    """Bytes: dt, xs, the B and C columns, A, D and t_valid read once,
    ``state_in`` state slabs read (0 for a cold start) and ``state_out``
    written, y written, plus ``extra`` (row indices); operations: per
    valid position, channel and state element the exp, the dt*A and
    dt*x*B products, the state update and the C dot product (~7 f32
    operations), plus D*x."""
    B, T, di = dt.shape
    N = Bc.shape[-1]
    ins = [dt, xs, A, D, t_valid]
    n_bytes = sum(a.numel() * a.element_size() for a in ins) \
        + 2 * B * T * N * Bc.element_size() \
        + (state_in + state_out) * di * N * 4 + B * T * di * 4 + extra
    positions = int(t_valid.clamp(max=T).sum())
    return _bound(n_bytes, positions * di * (7 * N + 3), torch.float32)


def _slab_case(seed, T, dtype):
    """The served slab step (B = 8, d_inner 8192, d_state 16): a pool of
    8 slabs plus the dump row; rows 0-5 live (row 0 fresh: lengths 0,
    row 2 partly valid), row 6 idle on row 1's slab (a stale slot id),
    row 7 idle on slab 6, which no live row owns; rows 6 and 7 both
    write the dump.  Returns (scan operands, pool, read, write, live
    rows, slabs no row may touch)."""
    B, di, N = 8, 8192, 16
    dt, xs, Bc, Cc, A, D, _, _ = _scan_case(seed, B, T, di, N, dtype, False)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    pool = torch.randn((B + 1, di, N), generator=g).to("cuda")
    slots = torch.tensor([3, 0, 5, 1, 7, 2, 0, 6])
    lengths = torch.tensor([0, 100, 37, 500, 5, 200, 64, 9])
    t_valid = torch.tensor([T, T, max(T // 2, 1), T, T, T, 0, 0],
                           dtype=torch.int32)
    dump = B
    read = torch.where(lengths == 0, -1, slots)
    write = torch.where(t_valid > 0, slots, dump)
    ops = (dt, xs, Bc, Cc, A, D)
    return (ops, pool, read.to("cuda"), write.to("cuda"),
            t_valid.to("cuda"), list(range(6)), [4, 6])


def phase_scan(timer: Timer, floor_ms: float):
    """B5 through both entries.  The plain entry: T = 1 and 32, cold and
    carried (bf16 timed, f32 checked at T = 32 carried), and cold at
    T = 512 (the dense engine's prefill wave at B = 8, and B = 1, where
    the grid is 256 blocks: the case a time-split scan would serve).
    The slab entry at the served step shapes (T = 1 decode, T = 32
    chunk) in place, with a fresh row, idle rows on a live row's and on
    an unowned slab, and the dump row.  Returns the T = 32 slab row: the
    main path's entry."""
    from repro_torch.kernels.ssm_scan import ops as sops
    cases = [(8, T, carried, dtype) for T in (1, 32)
             for carried in (False, True)
             for dtype in (torch.bfloat16, torch.float32)
             if dtype == torch.bfloat16 or (carried and T == 32)]
    cases += [(8, 512, False, torch.bfloat16), (1, 512, False, torch.bfloat16)]
    for B, T, carried, dtype in cases:
        args = _scan_case(T + carried + B, B, T, 8192, 16, dtype, carried)
        n0 = sops.KERNEL.launches
        y, h = sops.selective_scan(*args)
        torch.cuda.synchronize()
        check(sops.KERNEL.launches == n0 + 1, "selective_scan did not launch")
        wy, wh = sops.selective_scan_plain(*args)
        check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
              "selective_scan: non-finite output")
        err = max((y - wy).abs().max().item(), (h - wh).abs().max().item())
        tag = (f"selective_scan B={B} T={T} di=8192 N=16 {str(dtype)[6:]} "
               + ("carried h0 + t_valid" if carried else "cold")
               + ", Bc/Cc split views")
        check(err <= SCAN_TOL, f"{tag}: max_abs_err {err}")
        line = f"[kernels] {tag}: max_abs_err={err:.3e} (tol {SCAN_TOL})"
        if dtype == torch.bfloat16:
            dt, xs, Bc, Cc, A, D, h0, t_valid = args
            row = _time_row(timer, sops.selective_scan,
                            sops.selective_scan_plain, args, None,
                            _scan_bound_ms(dt, xs, Bc, Cc, A, D, t_valid,
                                           B if carried else 0, B))
            line += _fmt(row)
        log(line)
    served = None
    for T in (1, 32):
        ops, pool, read, write, t_valid, live, untouched = _slab_case(
            T, T, torch.bfloat16)
        got, want = pool.clone(), pool.clone()
        entry = "selective_scan_slab_bf16"
        n0 = sops.KERNEL.entry_launches[entry]
        y = sops.selective_scan_slab(*ops, got, read, write, t_valid)
        torch.cuda.synchronize()
        check(sops.KERNEL.entry_launches[entry] == n0 + 1,
              f"{entry} did not launch")
        wy = sops.selective_scan_slab_plain(*ops, want, read, write, t_valid)
        check(bool(torch.isfinite(y).all() and torch.isfinite(got).all()),
              "selective_scan_slab: non-finite output")
        slabs = write[live].tolist()
        err = max((y[live] - wy[live]).abs().max().item(),
                  (got[slabs] - want[slabs]).abs().max().item())
        tag = (f"selective_scan_slab B=8 T={T} di=8192 N=16 bfloat16 in "
               f"place, read {read.tolist()} write {write.tolist()}")
        check(err <= SCAN_TOL, f"{tag}: max_abs_err {err}")
        check(all(torch.equal(got[i], pool[i]) for i in untouched),
              f"{tag}: a slab no live row owns changed")

        def run(*a, _pool=pool.clone()):
            return sops.selective_scan_slab(*a[:6], _pool, *a[6:])

        def plain(*a, _pool=pool.clone()):
            return sops.selective_scan_slab_plain(*a[:6], _pool, *a[6:])

        args = ops + (read, write, t_valid)
        reads = len({r for r in read.tolist() if r >= 0})
        row = _time_row(timer, run, plain, args, None, _scan_bound_ms(
            *ops, t_valid, reads, len(set(write.tolist())), 2 * 8 * 8))
        log(f"[kernels] {tag}: max_abs_err={err:.3e} (tol {SCAN_TOL}); "
            f"slabs {untouched} bit-identical" + _fmt(row)
            + (f" launch_floor_ms={floor_ms:.4f}" if T == 1 else ""))
        if T == 32:
            served = dict(max_abs_err=err, **row)
    log(f"[kernels] scan tolerance: {SCAN_TOL}; {SCAN_TOL_REASON}")
    return served


# B5' against its plain version: each gradient's largest error over its
# largest magnitude (f32: the kernel's ex2.approx and fused multiply-adds
# against torch's exp, its sums over steps, lanes and channel blocks in
# another order; bf16: d_dt, d_xs, d_Bc, d_Cc are rounded to bf16 once,
# one bf16 ulp of the largest is 2^-8)
SCAN_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
# f32 operations a state value, counting the state itself (its decay exp
# once), g, the terms of ddt, dx, dA, dB, dC and the carry
SCAN_BWD_OPS = 20


def _scan_grad_err(got, want, dtype) -> float:
    """The largest ratio of a gradient's error (over its largest
    magnitude) to its tolerance: the model-type gradients at the dtype's,
    dA, dD, dh0 (f32) at f32's."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        tol = SCAN_GRAD_TOL[dtype if i < 4 else torch.float32]
        err = (g.float() - w.float()).abs().max().item() \
            / max(w.float().abs().max().item(), 1e-30)
        worst = max(worst, err / tol)
    return worst


def _scan_bwd_bound(dt, Bc, carried: bool):
    """Least time of the unmasked scan's gradient: the bytes it must move
    (dt, xs in the model type, dy f32 read; d_dt, d_xs written; Bc, Cc
    read and d_Bc, d_Cc written; A, D read and dA, dD written; h0 and
    dh_last read where given, dh0 written) and ``SCAN_BWD_OPS`` f32
    operations a state value."""
    B, T, di = dt.shape
    N = Bc.shape[-1]
    e = dt.element_size()
    n_bytes = B * T * di * (4 * e + 4) + 4 * B * T * N * e \
        + 2 * (di * N + di) * 4 + (3 if carried else 1) * B * di * N * 4
    return _bound(n_bytes, SCAN_BWD_OPS * B * T * di * N, torch.float32)


def scan_backward_check(ops_in, dy, dh, tag):
    """B5' on ``ops_in`` (dt, xs, Bc, Cc, A, D, h0) and cotangents (dy,
    dh_last or None): the checkpointing twin, then exactly one launch of
    the backward entry of the model type; its gradients against
    ``selective_scan_backward_plain`` within ``SCAN_GRAD_TOL``, finite, a
    second launch the same bits.  Returns (states, gradients, the largest
    absolute error, the worst error over its tolerance)."""
    from repro_torch.kernels.ssm_scan import ops as sops
    dtype = ops_in[0].dtype
    entry = f"selective_scan_backward_{sops._NAMES[dtype]}"
    _, _, states = sops.selective_scan_ckpt(*ops_in)
    n0 = sops.BACKWARD_KERNEL.entry_launches[entry]
    got = sops.selective_scan_backward(*ops_in[:6], states, dy, dh)
    torch.cuda.synchronize()
    check(sops.BACKWARD_KERNEL.entry_launches[entry] == n0 + 1,
          f"{tag}: {entry} did not launch")
    check(all(torch.isfinite(g.float()).all().item() for g in got),
          f"{tag}: non-finite gradients")
    want = sops.selective_scan_backward_plain(*ops_in, dy, dh)
    worst = _scan_grad_err(got, want, dtype)
    check(worst <= 1.0, f"{tag}: gradient error {worst:.3f} x its tolerance")
    again = sops.selective_scan_backward(*ops_in[:6], states, dy, dh)
    torch.cuda.synchronize()
    check(_same_bits(got, again), f"{tag}: two launches differ")
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    return states, got, err, worst


# phase 3's B5' rows: (B, T, dtype, non-zero h0 and a dh_last); di 8192,
# N 16, Bc/Cc split views at ldbc 288 (jamba-v0.1's training shape)
SCAN_BACKWARD_CASES = ((8, 512, torch.bfloat16, False),
                       (8, 512, torch.float32, False),
                       (1, 512, torch.bfloat16, False),
                       (8, 300, torch.bfloat16, False),
                       (8, 512, torch.bfloat16, True))


def scan_backward_split(fn, calls: int = 3) -> dict:
    """B5''s device time a call (``fn`` runs it once) split between its
    two kernels, the scan and the sum of the partials: each kernel's mean
    over its ``calls`` launches in one ``torch.profiler`` trace, after a
    warm-up call (L2 warm from the call before).  The trace opens with a
    ~10 ms spin of the card, so that it records from the first call.
    ``grid`` is the scan kernel's launch grid as the trace records it."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    got = {k: [(e.self_device_time_total, e.count)
               for e in prof.key_averages() if pat in e.key]
           for k, pat in (("scan", "scan_backward_kernel"),
                          ("reduce", "scan_backward_reduce"))}
    counts = {k: sum(c for _, c in v) for k, v in got.items()}
    check(all(c == calls for c in counts.values()),
          f"the trace holds {counts} launches of B5''s kernels, want {calls}")
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(str(Path(d) / "trace.json"))
        events = json.loads((Path(d) / "trace.json").read_text())
    grids = {tuple(e["args"]["grid"]) for e in events.get("traceEvents", [])
             if "scan_backward_kernel" in str(e.get("name", ""))
             and "grid" in (e.get("args") or {})}
    check(len(grids) == 1, f"B5''s scan traced at grids {sorted(grids)}")
    return {**{f"{k}_ms": sum(us for us, _ in v) / calls / 1e3
               for k, v in got.items()}, "grid": grids.pop()}


def scan_backward_sass(lib: Path, layout: dict) -> dict:
    """What the compiled B5' kernel that serves bf16 at N = 16
    (``scan_backward_kernel<bf16, 4>``) does, from ``cuobjdump -sass``:
    its ``MUFU.EX2`` instructions over the state values a thread walks in
    one pass of its chunk loop (``layout``, the kernel's own
    ``sops.backward_layout``: steps a chunk x values a thread), which is
    exps a state value while the chunk loop is unrolled and holds the
    kernel's only exps; and the instructions of its three compute passes
    (the code between its second and third block barrier in a chunk) a
    lane and step, by opcode.  Empty without the tool."""
    import collections
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    body = next((f for f in re.split(r"\n\s*Function : ", sass)
                 if f.startswith("_Z") and
                 "scan_backward_kernelI13__nv_bfloat16Li4E" in
                 f.split("\n", 1)[0]), None)
    if body is None:
        return {}
    full = [m.group(2) for m in (
        re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)", ln)
        for ln in body.splitlines()) if m]
    ops = [op.split(".")[0] for op in full]
    bars = [i for i, op in enumerate(ops) if op == "BAR"]
    passes = collections.Counter(ops[bars[1] + 1:bars[2]]) \
        if len(bars) >= 3 else collections.Counter()
    steps = layout["chunk_steps"]
    ex2 = sum(op.startswith("MUFU.EX2") for op in full)
    return dict(ex2_per_state_value=ex2 / (steps
                                           * layout["values_per_thread"]),
                pass_instructions_per_lane_step=sum(passes.values()) / steps,
                pass_mix_per_lane_step={k: v / steps
                                        for k, v in passes.most_common(8)})


def phase_scan_backward(timer: Timer):
    """B5' (``selective_scan_backward.cu``; no TPU kernel: the JAX package
    differentiates its scan through XLA) against its plain version at
    ``SCAN_BACKWARD_CASES``, as ``mamba_forward`` trains (h0 zero, no
    dh_last) and once with both; timed alone from the twin's states
    against the plain version (which recomputes from h0) and the bound;
    no one PyTorch call computes it.  Each row's device time split
    between its two kernels (``scan_backward_split``) and its partials'
    bytes; the kernel's registers, spills, residency, ex2 count and
    instruction mix (``scan_backward_sass``).
    Then B5's checkpointing twin at the training shape: y and h_last
    equal the served entry's bit for bit, both timed.  Returns (the
    training shape's bf16 row, the rows by tag)."""
    from repro_torch.kernels.ssm_scan import ops as sops
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        occ = sops.backward_occupancy(dtype, 16)
        rows[f"occupancy {str(dtype)[6:]} N=16"] = occ
        log(f"[kernels] selective_scan_backward {str(dtype)[6:]} at N = 16: "
            f"{occ['registers']} registers and {occ['spill_bytes']} bytes "
            f"of local memory (spills) a thread, {occ['smem_bytes']} bytes "
            f"of shared memory a block of 128 threads, "
            f"{occ['blocks_per_sm']} blocks resident an SM, "
            f"{occ['clusters']} clusters resident on the card")
    layout = sops.backward_layout(8192, 16)
    rows["layout (di = 8192, N = 16)"] = layout
    log(f"[kernels] selective_scan_backward at di = 8192, N = 16, as the "
        f"built kernel reports it: {layout['chunk_steps']}-step chunks, "
        f"{layout['channels_per_block']} channels a block, "
        f"{layout['values_per_thread']} state values a thread, "
        f"{layout['clusters']} clusters of {layout['cluster']} blocks "
        f"along di")
    sass = scan_backward_sass(sops.BACKWARD_KERNEL.library_path, layout)
    rows["compiled (bf16, N = 16)"] = sass
    log(f"[kernels] selective_scan_backward bf16 at N = 16, compiled: "
        + (f"{sass['ex2_per_state_value']:g} MUFU.EX2 a state value; its "
           f"three passes {sass['pass_instructions_per_lane_step']:.1f} "
           f"instructions a lane and step (4 state values): "
           + ", ".join(f"{k} {v:g}" for k, v in
                       sass["pass_mix_per_lane_step"].items())
           if sass else "not measured (no cuobjdump)"))
    for B, T, dtype, carried in SCAN_BACKWARD_CASES:
        *ops_in, _ = _scan_case(B * T + carried, B, T, 8192, 16, dtype,
                                carried)
        g = torch.Generator(device="cpu").manual_seed(T + B)
        dy = torch.randn((B, T, 8192), generator=g).to("cuda")
        dh = torch.randn((B, 8192, 16), generator=g).to("cuda") \
            if carried else None
        tag = (f"selective_scan_backward B={B} T={T} di=8192 N=16 "
               f"{str(dtype)[6:]} " + ("h0 + dh_last" if carried else
                                       "h0 = 0, no dh_last")
               + f", Bc/Cc split views (ldbc {ops_in[2].stride(1)})")
        states, _, err, worst = scan_backward_check(ops_in, dy, dh, tag)
        ms = timer.ms(lambda: sops.selective_scan_backward(
            *ops_in[:6], states, dy, dh))
        plain_ms = timer.ms(lambda: sops.selective_scan_backward_plain(
            *ops_in, dy, dh), iters=3, warmup=1)
        bound = _scan_bwd_bound(ops_in[0], ops_in[2], carried)
        split = scan_backward_split(lambda: sops.selective_scan_backward(
            *ops_in[:6], states, dy, dh))
        # the partials of d_Bc and d_Cc, f32 (B, T, N) a cluster, from
        # the grid the trace saw launched
        grid = split.pop("grid")
        want = (layout["clusters"] * layout["cluster"], B, 1)
        check(grid == want, f"{tag}: traced grid {grid}, the kernel's "
              f"layout says {want}")
        partial_mb = 2 * B * T * (grid[0] // layout["cluster"]) * 16 * 4 / 1e6
        row = dict(max_abs_err=err, err_over_tol=worst, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                   library_ms=None, **split, partial_mb=partial_mb)
        rows[tag] = row
        log(f"[kernels] {tag}: max_abs_err={err:.3e}, worst error "
            f"{worst:.3f} x its tolerance, two launches equal" + _fmt(row)
            + f"; traced (warm L2) scan {split['scan_ms']:.4f} ms + sum "
            f"{split['reduce_ms']:.4f} ms; partials {partial_mb:.1f} MB "
            f"(grid {grid})")
    # the checkpointing twin beside the served entry, training's shape
    *ops_in, _ = _scan_case(3, 8, 512, 8192, 16, torch.bfloat16, False)
    y, h_last = sops.selective_scan(*ops_in)
    y2, h2, states = sops.selective_scan_ckpt(*ops_in)
    torch.cuda.synchronize()
    tag = ("selective_scan_ckpt_bf16 B=8 T=512 di=8192 N=16, Bc/Cc split "
           "views")
    check(_same_bits([y, h_last], [y2, h2]),
          f"{tag}: y/h_last differ from the served entry's")
    served_ms = timer.ms(lambda: sops.selective_scan(*ops_in))
    ckpt_ms = timer.ms(lambda: sops.selective_scan_ckpt(*ops_in))
    n_bytes = sum(a.numel() * a.element_size() for a in ops_in[:2]) \
        + 2 * 8 * 512 * 16 * 2 + (8192 * 17 + 8 * 8192 * 16) * 4 \
        + (y.numel() + h_last.numel() + states.numel()) * 4
    bound = _bound(n_bytes, 512 * 8 * 8192 * (7 * 16 + 3), torch.float32)
    rows[tag] = dict(served_ms=served_ms, ms=ckpt_ms, bound_ms=bound[0],
                     bound_by=bound[1], states_mb=states.numel() * 4 / 1e6)
    log(f"[kernels] {tag}: y and h_last equal the served entry's bit for "
        f"bit; {states.numel() * 4 / 1e6:.1f} MB of states "
        f"({states.shape[1]} per row); {ckpt_ms:.4f} ms against the served "
        f"entry's {served_ms:.4f}, bound {bound[0]:.5f} ({bound[1]})")
    log(f"[kernels] scan backward tolerance: {SCAN_GRAD_TOL} of each "
        f"gradient's largest magnitude (bf16 for the model-type gradients, "
        f"f32 for dA, dD, dh0); bound: {SCAN_BWD_OPS} f32 operations a "
        f"state value at {PEAK_OPS_PER_S[torch.float32] / 1e12:.0f} TFLOP/s "
        f"against its bytes")
    served = next(row for row in rows.values()
                  if isinstance(row, dict) and "plain_ms" in row)
    return served, rows


def phase_floor(timer: Timer) -> float:
    """The launch floor: one one-thread kernel (``torch.cuda._sleep(1)``)
    under the same Timer, the least any launch can read here."""
    ms = timer.ms(lambda: torch.cuda._sleep(1))
    log(f"[kernels] launch floor: a one-thread kernel under the same "
        f"Timer, {ms:.4f} ms")
    return ms


def phase_gating(timer: Timer, floor_ms: float):
    from repro_torch.kernels.moe_gating import ops as gops
    served = None
    cases = [(8, 16, 2, False), (256, 16, 2, False), (256, 16, 2, True),
             (256, 4, 4, False), (256, 64, 8, False), (256, 256, 8, False)]
    for T, E, k, tied in cases:
        g = torch.Generator(device="cpu").manual_seed(T + tied + E)
        if tied:   # a 3-level grid: most rows hold exact ties
            scores = torch.randint(0, 3, (T, E), generator=g).float() / 4
        else:
            scores = torch.softmax(torch.randn((T, E), generator=g), dim=-1)
        scores = scores.to("cuda")
        n0 = gops.KERNEL.launches
        vals, idx = gops.gating_topk(scores, k)
        torch.cuda.synchronize()
        check(gops.KERNEL.launches == n0 + 1, "gating_topk did not launch")
        wv, wi = gops.gating_topk_plain(scores, k)
        exact = torch.equal(vals, wv) and torch.equal(idx, wi)
        tag = f"gating_topk T={T} E={E} k={k}" + (" ties" if tied else "")
        check(exact, f"{tag}: kernel and plain version differ")
        err = (vals - wv).abs().max().item()
        row = _time_row(timer, gops.gating_topk, gops.gating_topk_plain,
                        (scores, k), lambda: torch.topk(scores, k),
                        _bound(T * E * 4 + T * k * 8, 2 * T * k * E,
                               torch.float32))
        log(f"[kernels] {tag}: exact (values and indices)" + _fmt(row)
            + f" launch_floor_ms={floor_ms:.4f}")
        if (T, E, tied) == (256, 16, False):
            served = dict(max_abs_err=err, **row)
    log("[kernels] gating tolerance: exact; library call: torch.topk")
    return served


def _dense_qkv(seed, B, S, T, heads, dtype):
    g = torch.Generator(device="cpu").manual_seed(seed)
    H, KV, hd = heads["H"], heads["KV"], heads["hd"]
    return tuple(torch.randn(shape, generator=g).to("cuda", dtype)
                 for shape in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))


def _sdpa(q, k, v, G, mask=None, causal=False):
    """One SDPA call on (B, S, H, hd) q and K/V expanded to the query
    heads beforehand (the yardstick; the port never calls it)."""
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kh, vh, attn_mask=mask, is_causal=causal)


def phase_dense_kernels(timer: Timer):
    """The dense engine's kernels at its served shapes: the contiguous
    flash prefill (B2) at B=8, S=T=512 and the dense decode (B4) at B=8
    over a 584-slot cache, the capacity phase 7 serves at."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    served = {}
    B, S = 8, 512
    cases = [(geo, heads, dt, w)
             for geo, heads in (("smollm", SMOLLM_HEADS), ("jamba", JAMBA_HEADS))
             for dt in (torch.float32, torch.bfloat16) for w in (0, 128)]
    for geo, heads, dtype, window in cases:
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        seed = S + window if geo == "smollm" else S + window + hd
        q, k, v = _dense_qkv(seed, B, S, S, heads, dtype)
        n0 = fops.FLASH_KERNEL.launches
        entry = fops.flash_entry(dtype, hd)
        e0 = fops.FLASH_KERNEL.entry_launches[entry]
        out = fops.flash_attention(q, k, v, causal=True,
                                   sliding_window=window)
        torch.cuda.synchronize()
        check(fops.FLASH_KERNEL.launches == n0 + 1
              and fops.FLASH_KERNEL.entry_launches[entry] == e0 + 1,
              f"flash_attention did not launch {entry}")
        want = fops.flash_attention_plain(q, k, v, causal=True,
                                          sliding_window=window)
        check(torch.isfinite(out.float()).all().item(),
              "flash_attention: non-finite output")
        err = (out.float() - want.float()).abs().max().item()
        tol = TOL[dtype] if dtype == torch.float32 \
            else DENSE_BF16_TOL["flash_attention"]
        tag = (f"flash_attention (contiguous) {geo} heads {H}/{KV} hd "
               f"{hd} B={B} S=T={S} causal"
               + (f" window {window}" if window else "")
               + f" {str(dtype)[6:]} [{entry}]")
        check(err <= tol, f"{tag}: max_abs_err {err} > {tol}")
        pos = torch.arange(S, device="cuda")
        visible = (pos[None, :] <= pos[:, None])
        if window:
            visible &= pos[None, :] > pos[:, None] - window
        # q, k, v read once; out (q's shape and type) written once
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) \
            * q.element_size()
        ops = 4 * B * H * hd * int(visible.sum())
        library = _sdpa(q, k, v, H // KV, mask=None if not window
                        else visible, causal=not window)
        row = _time_row(timer, lambda *a: fops.flash_attention(
                            *a, causal=True, sliding_window=window),
                        lambda *a: fops.flash_attention_plain(
                            *a, causal=True, sliding_window=window),
                        (q, k, v), library,
                        _bound(n_bytes, ops, dtype))
        log(f"[kernels] {tag}: max_abs_err={err:.3e} (tol {tol})"
            + _fmt(row))
        if geo == "smollm" and dtype == torch.bfloat16 and not window:
            served["flash_attention"] = dict(max_abs_err=err, **row)
    C = 584
    for geo, heads in (("smollm", SMOLLM_HEADS), ("jamba", JAMBA_HEADS)):
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        for n_valid, fill in ((544, "partly filled"), (C, "wrapped ring")):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = _dense_qkv(n_valid + hd, B, 1, C, heads, dtype)
                q = q[:, 0].contiguous()
                n0 = dops.DENSE_KERNEL.launches
                out = dops.decode_attention(q, k, v, n_valid)
                torch.cuda.synchronize()
                check(dops.DENSE_KERNEL.launches == n0 + 1,
                      "decode_attention did not launch")
                want = dops.decode_attention_plain(q, k, v, n_valid)
                check(torch.isfinite(out.float()).all().item(),
                      "decode_attention: non-finite output")
                err = (out.float() - want.float()).abs().max().item()
                tol = TOL[dtype] if dtype == torch.float32 \
                    else DENSE_BF16_TOL["decode_attention"]
                tag = (f"decode_attention (dense) {geo} heads {H}/{KV} hd "
                       f"{hd} B={B} C={C} n_valid={n_valid} ({fill}) "
                       f"{str(dtype)[6:]}")
                check(err <= tol, f"{tag}: max_abs_err {err} > {tol}")
                es = k.element_size()
                n_bytes = (q.numel() * (q.element_size() + es)
                           + 2 * B * n_valid * KV * hd * es)
                mask = (torch.arange(C, device="cuda") < n_valid)
                library = _sdpa(q[:, None], k, v, H // KV,
                                mask=mask[None, None, None, :])
                row = _time_row(timer, dops.decode_attention,
                                dops.decode_attention_plain,
                                (q, k, v, n_valid), library,
                                _bound(n_bytes, 4 * B * H * hd * n_valid,
                                       dtype))
                log(f"[kernels] {tag}: max_abs_err={err:.3e} (tol {tol})"
                    + _fmt(row))
                entry = dops.decode_entry("decode_attention", dtype, dtype,
                                          H // KV, hd)
                if entry.endswith(("_mma", "_tf32")):
                    # decode_body.cuh's entry on the same operands
                    _earlier(timer, row, _decode_entry_run(
                        dops, f"decode_attention_{dops._NAMES[dtype]}_"
                        f"{dops._NAMES[dtype]}", (q, k, v, n_valid)), want,
                        tol, f"[kernels] {tag} [{entry}]")
                    row["entry"] = entry
                if geo == "smollm" and n_valid == 544 \
                        and dtype == torch.bfloat16:
                    served["decode_attention"] = dict(max_abs_err=err, **row)
    log(f"[kernels] dense attention tolerance: f32 1e-5; bf16 "
        f"{DENSE_BF16_TOL} (the kernels round scores and probabilities "
        f"where the plain version does, but the unnormalized probabilities "
        f"of an online softmax; outputs are bf16)")
    return served


MLA_HEADS = dict(H=128, KV=128, hd=192, v_hd=128)  # deepseek-v3: 128 + 64


def _bf16_ulp(want) -> float:
    """One bf16 ulp at the largest magnitude of ``want`` (8 significant
    bits): the MLA rows' tolerance unit, since their outputs reach
    |out| > 4 (one ulp 3.1e-2), past the smollm rows' |out| ~ 3."""
    amax = want.float().abs().max().item()
    return 2.0 ** (np.floor(np.log2(amax)) - 7) if amax > 0 else 0.0


def _mla_bound(H, n_scores, qk, vd, q_rows, kv_rows, rope=0):
    """Bytes (q at the q/k head and the output at v_head_dim; per visible
    key its K rows and V rows, bf16, each once) and operations (QK at qk,
    PV at v_head_dim, multiply and add).  ``rope``: the width of the rope
    key that every head of a token shares, counted once per token as the
    MLA entries read it; 0 counts it per head, as the padded operands
    (the key broadcast to every head) held it."""
    k_row = H * qk if not rope else H * (qk - rope) + rope
    n_bytes = 2 * (q_rows * H * (qk + vd) + kv_rows * (k_row + H * vd))
    return _bound(n_bytes, 2 * H * (qk + vd) * n_scores, torch.bfloat16)


# The MLA rows of the padded-operand form (the rope key broadcast to every
# head, V zero-padded to 192, the CUDA-core prefill body), measured on an
# "NVIDIA H100 80GB HBM3, 700.00 W" card (PERF.md §6): logged beside this
# run's
PADDED_MLA = {"phase 3 B2": "16.1882 ms, plain 4.8346, SDPA 0.2755",
            "phase 3 B4": "0.2156 ms, plain 1.5519, SDPA 0.1638",
            "served B2": "1.2561 ms, plain 0.6327, SDPA 0.0708",
            "served B4": "0.0791 ms (144 valid), plain 0.3329, SDPA 0.0625"}


def _mla_flash_row(timer, q, k_nope, k_rope, v, tag, padded):
    """B2's MLA entry on these operands (q (B, S, H, 192), k_nope and V
    (B, S, H, 128), the shared rope key (B, S, 64); causal, S = T): one
    launch of ``flash_attention_mla_bf16_mma``, the output within one bf16
    ulp of the plain version's largest, then timed beside the plain
    version and SDPA (on K with the rope key broadcast beforehand, V
    unpadded: the padded form's yardstick call).  The bound counts the
    rope key once per token; the padded form's, per head, is logged beside
    it, and so are ``padded``, that form's numbers."""
    from repro_torch.kernels.flash_attention import ops as fops
    B, S, H, hd = q.shape
    rope, vd = k_rope.shape[-1], v.shape[-1]
    entry = "flash_attention_mla_bf16_mma"
    check(fops.mla_flash_entry((q.dtype, k_nope.dtype, k_rope.dtype,
                                v.dtype), (hd - rope, rope, vd)) == entry,
          f"{tag}: the MLA operands do not go to {entry}")
    e0 = fops.FLASH_KERNEL.entry_launches[entry]
    out = fops.mla_flash_attention(q, k_nope, k_rope, v)
    torch.cuda.synchronize()
    check(fops.FLASH_KERNEL.entry_launches[entry] == e0 + 1,
          f"{tag}: flash_attention did not launch {entry}")
    want = fops.mla_flash_attention_plain(q, k_nope, k_rope, v)
    check(out.shape == want.shape == (B, S, H, vd)
          and torch.isfinite(out.float()).all().item(),
          f"{tag}: non-finite output or shape {tuple(out.shape)}")
    diff = (out.float() - want.float()).abs()
    err = diff.max().item()
    at = want.flatten()[diff.flatten().argmax()].float().item()
    # one ulp, as the smollm rows (the kernel rounds the unnormalized
    # probabilities, the plain version the normalized ones)
    tol = max(DENSE_BF16_TOL["flash_attention"], _bf16_ulp(want))
    tag = (f"{tag} [{entry}]; the largest error at |out| = {abs(at):.3f} "
           f"(|out| <= {want.float().abs().max().item():.3f})")
    check(err <= tol, f"{tag}: max_abs_err {err} > {tol}")
    del out, want, diff
    k_full = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, rope)],
                       dim=-1)
    n_scores = B * S * (S + 1) // 2
    row = _time_row(timer, fops.mla_flash_attention,
                    fops.mla_flash_attention_plain, (q, k_nope, k_rope, v),
                    _sdpa(q, k_full, v, 1, causal=True),
                    _mla_bound(H, n_scores, hd, vd, B * S, B * S, rope))
    old = _mla_bound(H, n_scores, hd, vd, B * S, B * S)[0]
    log(f"{tag}: max_abs_err={err:.3e} (tol {tol})" + _fmt(row)
        + f"; bound with the rope key per head {old:.5f}; padded operands: {padded}")
    return dict(max_abs_err=err, bound_ms_padded=old, **row)


def _mla_decode_row(timer, q, k_nope, kr_cache, v, n_valid, tag, padded):
    """B4's MLA entry on these operands (q (B, H, 192), k_nope and V
    (B, T, H, 128), the latent cache's rope keys (B, C, 64), C >= T):
    one launch of ``decode_attention_mla_bf16``, the output within two
    bf16 ulps of the plain version's largest, then timed beside the plain
    version and SDPA (K with the rope key broadcast beforehand, V
    unpadded, a mask only where slots past ``n_valid`` exist: the padded
    form's yardstick calls).  Bounds and ``padded`` as
    ``_mla_flash_row``'s.  The body's registers, spills, shared memory and
    resident blocks an SM (``mla_decode_occupancy``) are logged and
    returned; a spill fails the row."""
    from repro_torch.kernels.decode_attention import ops as dops
    occ = dops.mla_decode_occupancy()
    check(occ["spill_bytes"] == 0,
          f"{tag}: decode_attention_mla_bf16 spills {occ['spill_bytes']} "
          f"bytes a thread")
    B, H, hd = q.shape
    T, rope, vd = k_nope.shape[1], kr_cache.shape[-1], v.shape[-1]
    entry = "decode_attention_mla_bf16"
    check(dops.mla_entry((q.dtype, k_nope.dtype, kr_cache.dtype, v.dtype),
                         (hd - rope, rope, vd)) == entry,
          f"{tag}: the MLA operands do not go to {entry}")
    e0 = dops.DENSE_KERNEL.entry_launches[entry]
    out = dops.mla_decode_attention(q, k_nope, kr_cache, v, n_valid)
    torch.cuda.synchronize()
    check(dops.DENSE_KERNEL.entry_launches[entry] == e0 + 1,
          f"{tag}: decode_attention did not launch {entry}")
    want = dops.mla_decode_attention_plain(q, k_nope, kr_cache, v, n_valid)
    check(out.shape == want.shape == (B, H, vd)
          and torch.isfinite(out.float()).all().item(),
          f"{tag}: non-finite output or shape {tuple(out.shape)}")
    err = (out.float() - want.float()).abs().max().item()
    tol = max(DENSE_BF16_TOL["decode_attention"], 2 * _bf16_ulp(want))
    tag = f"{tag} [{entry}]"
    check(err <= tol, f"{tag}: max_abs_err {err} > {tol}")
    k_full = torch.cat([k_nope, kr_cache[:, :T, None].expand(B, T, H, rope)],
                       dim=-1)
    mask = None if n_valid == T else \
        (torch.arange(T, device="cuda") < n_valid)[None, None, None, :]
    row = _time_row(timer, dops.mla_decode_attention,
                    dops.mla_decode_attention_plain,
                    (q, k_nope, kr_cache, v, n_valid),
                    _sdpa(q[:, None], k_full, v, 1, mask=mask),
                    _mla_bound(H, B * n_valid, hd, vd, B, B * n_valid, rope))
    old = _mla_bound(H, B * n_valid, hd, vd, B, B * n_valid)[0]
    log(f"{tag}: max_abs_err={err:.3e} (tol {tol})" + _fmt(row)
        + f"; bound with the rope key per head {old:.5f}; padded operands: "
        f"{padded}; decode_mla.cuh: {occ['registers']} registers and "
        f"{occ['spill_bytes']} spill bytes a thread, {occ['smem_bytes']} "
        f"bytes of shared memory a block of {occ['warps']} warps, "
        f"{occ['blocks_per_sm']} blocks resident an SM, {occ['stages']} "
        f"stages of {occ['tile_keys']}-key tiles a warp")
    return dict(max_abs_err=err, bound_ms_padded=old, body=occ, **row)


def phase_mla_kernels(timer: Timer):
    """B2 contiguous and B4 at DeepSeek-V3's MLA heads (phase 13's path)
    on MLA's own operands, bf16: H = 128 heads, q (192 = 128 + 64), k_nope
    and V (128) per head, one rope key (64) per token shared by every
    head.  B2 at B = 8, S = T = 512, causal, through
    ``flash_attention_mla_bf16_mma`` (the tensor-core body at q/k 192, V
    128); B4 at B = 8 over a 640-slot latent cache, 576 valid, through
    ``decode_attention_mla_bf16`` (decode_mla.cuh, every warp on its own
    keys, the rope key read in place).  SDPA, the yardstick, takes K with
    the rope key broadcast and the unpadded V, as for the padded
    operands."""
    H, hd, vd = MLA_HEADS["H"], MLA_HEADS["hd"], MLA_HEADS["v_hd"]
    rope = hd - vd
    g = torch.Generator(device="cpu").manual_seed(192)
    B, S = 8, 512

    def rand(*shape):
        return torch.randn(shape, generator=g).to("cuda", torch.bfloat16)

    rows = {"flash_attention": _mla_flash_row(
        timer, rand(B, S, H, hd), rand(B, S, H, vd), rand(B, S, rope),
        rand(B, S, H, vd),
        f"[kernels] flash_attention (contiguous) MLA heads {H}/{H} q/k {hd} "
        f"(rope {rope} shared) V {vd} B={B} S=T={S} causal bfloat16",
        PADDED_MLA["phase 3 B2"])}
    C, n_valid = 640, 576
    rows["decode_attention"] = _mla_decode_row(
        timer, rand(B, H, hd), rand(B, C, H, vd), rand(B, C, rope),
        rand(B, C, H, vd), n_valid,
        f"[kernels] decode_attention (dense) MLA heads {H}/{H} q/k {hd} "
        f"(rope {rope} in place) V {vd} B={B} C={C} n_valid={n_valid} "
        f"bfloat16", PADDED_MLA["phase 3 B4"])
    return rows


WHISPER_HEADS = dict(H=6, KV=6, hd=64)       # whisper-tiny: 6 heads of 64
QWEN2VL_HEADS = dict(H=64, KV=8, hd=128)     # qwen2-vl-72b: 64 query, 8 KV


def phase_slice_kernels(timer: Timer):
    """B2 and B4 at the shapes phases 15 and 16 serve, against their plain
    versions, each on the entry the dispatch picks: B2 without the causal
    mask at whisper-tiny's encoder (B = 8, S = T = 1500, no multiple of a
    64-key tile: the tensor-core bodies mask kpos >= T alone), its
    decoder's cross-attention with more queries than keys (S = 100 over
    T = 64, the smoke encoder) and at jamba's hd 128 (S = T = 300), bf16
    on ``_mma`` and f32 on ``_tf32``; B2 causal at qwen2-vl-72b's heads
    (64/8, hd 128, S = 1152: 1024 patch rows and 128 text tokens); B4
    over whisper's whole cross cache (1500 of 1500 slots, one query, no
    mask) and at qwen2-vl's heads (1183 of 1184 slots, the last decode
    step).  The bf16 rows at the served shapes are timed beside the plain
    version, SDPA and the bound.  Returns {kernel: {shape: row}}."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {"flash_attention": {}, "decode_attention": {}}
    B = 8
    flash_cases = [  # (tag, heads, S, T, causal, dtype, timed)
        ("whisper encoder", WHISPER_HEADS, 1500, 1500, False, bf16, True),
        ("whisper encoder", WHISPER_HEADS, 1500, 1500, False, f32, False),
        ("cross S > T", WHISPER_HEADS, 100, 64, False, bf16, False),
        ("cross S > T", WHISPER_HEADS, 100, 64, False, f32, False),
        ("jamba heads bidirectional", JAMBA_HEADS, 300, 300, False, bf16,
         False),
        ("jamba heads bidirectional", JAMBA_HEADS, 300, 300, False, f32,
         False),
        ("qwen2-vl causal", QWEN2VL_HEADS, 1152, 1152, True, bf16, True)]
    for tag, heads, S, T, causal, dtype, timed in flash_cases:
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        q, k, v = _dense_qkv(S + T + hd, B, S, T, heads, dtype)
        entry = fops.flash_entry(dtype, hd)
        e0 = dict(fops.FLASH_KERNEL.entry_launches)
        out = fops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        e1 = fops.FLASH_KERNEL.entry_launches
        check({e: e1[e] - e0[e] for e in e1} == {e: int(e == entry)
                                                 for e in e1},
              f"flash_attention {tag}: launched {e1}, not one {entry}")
        want = fops.flash_attention_plain(q, k, v, causal=causal)
        check(torch.isfinite(out.float()).all().item(),
              f"flash_attention {tag}: non-finite output")
        err = (out.float() - want.float()).abs().max().item()
        tol = TOL[f32] if dtype == f32 else DENSE_BF16_TOL["flash_attention"]
        line = (f"flash_attention (contiguous) {tag}: heads {H}/{KV} hd {hd} "
                f"B={B} S={S} T={T} {'causal' if causal else 'no mask'} "
                f"{str(dtype)[6:]} [{entry}]")
        check(err <= tol, f"{line}: max_abs_err {err} > {tol}")
        line = f"[kernels] {line}: max_abs_err={err:.3e} (tol {tol})"
        if timed:
            n_scores = B * H * (S * (S + 1) // 2 if causal else S * T)
            n_bytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            row = _time_row(
                timer, lambda *a: fops.flash_attention(*a, causal=causal),
                lambda *a: fops.flash_attention_plain(*a, causal=causal),
                (q, k, v), _sdpa(q, k, v, H // KV, causal=causal),
                _bound(n_bytes, 4 * hd * n_scores, dtype))
            line += _fmt(row)
            rows["flash_attention"][f"{tag} B={B} S={S} T={T}"] = dict(
                max_abs_err=err, **row)
        log(line)
    for tag, heads, C, n_valid in (("whisper cross", WHISPER_HEADS, 1500,
                                    1500),
                                   ("qwen2-vl", QWEN2VL_HEADS, 1184, 1183)):
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        for dtype in (f32, bf16):
            q, k, v = _dense_qkv(C + n_valid, B, 1, C, heads, dtype)
            q = q[:, 0].contiguous()
            entry = dops.decode_entry("decode_attention", dtype, dtype,
                                      H // KV, hd)
            e0 = dict(dops.DENSE_KERNEL.entry_launches)
            out = dops.decode_attention(q, k, v, n_valid)
            torch.cuda.synchronize()
            e1 = dops.DENSE_KERNEL.entry_launches
            check({e: e1[e] - e0[e] for e in e1} == {e: int(e == entry)
                                                     for e in e1},
                  f"decode_attention {tag}: launched {e1}, not one {entry}")
            want = dops.decode_attention_plain(q, k, v, n_valid)
            check(torch.isfinite(out.float()).all().item(),
                  f"decode_attention {tag}: non-finite output")
            err = (out.float() - want.float()).abs().max().item()
            tol = TOL[f32] if dtype == f32 \
                else DENSE_BF16_TOL["decode_attention"]
            label = (f"decode_attention (dense) {tag}: heads {H}/{KV} hd "
                     f"{hd} B={B} C={C} n_valid={n_valid} {str(dtype)[6:]} "
                     f"[{entry}]")
            check(err <= tol, f"{label}: max_abs_err {err} > {tol}")
            line = f"[kernels] {label}: max_abs_err={err:.3e} (tol {tol})"
            if dtype == bf16:
                es = k.element_size()
                n_bytes = (q.numel() * (q.element_size() + es)
                           + 2 * B * n_valid * KV * hd * es)
                mask = (torch.arange(C, device="cuda") < n_valid)
                row = _time_row(timer, dops.decode_attention,
                                dops.decode_attention_plain,
                                (q, k, v, n_valid),
                                _sdpa(q[:, None], k, v, H // KV,
                                      mask=mask[None, None, None, :]),
                                _bound(n_bytes, 4 * B * H * hd * n_valid,
                                       dtype))
                line += _fmt(row)
                if entry.endswith("_mma"):     # decode_body.cuh's entry
                    _earlier(timer, row, _decode_entry_run(
                        dops, "decode_attention_bf16_bf16",
                        (q, k, v, n_valid)), want, tol, f"[kernels] {label}")
                rows["decode_attention"][f"{tag} B={B} C={C} "
                                         f"n_valid={n_valid}"] = dict(
                    entry=entry, max_abs_err=err, **row)
            log(line)
    _glm4_prefill_rows(timer, rows)
    return rows


def _glm4_prefill_rows(timer: Timer, rows: dict) -> None:
    """K2 and B2 at glm4-9b's heads (32/2, G = 16, hd 128, bf16) at phase
    21's shapes, each against its plain version, timed beside it, SDPA
    and the bound: K2's last prefill chunk of a 4096-token prompt (B = 8,
    T = 256 at positions 3840-4095, over a shuffled page table) and B2
    causal over the whole prompt (B = 8, S = T = 4096).  B2's plain
    version runs at B = 1 only (``plain_batch``): its f32 scores alone
    take B * 32 * 4096^2 * 4 bytes, 17.2 GB at B = 8."""
    from repro_torch.kernels.flash_attention import ops as fops
    bf16, B, heads = torch.bfloat16, 8, GLM4_HEADS
    H, KV, hd = heads["H"], heads["KV"], heads["hd"]
    T, ctx = GLM4_CHUNK, GLM4_CTX
    g = torch.Generator(device="cpu").manual_seed(ctx + T)
    pages = ctx // BS
    nb = B * pages + 7
    q = torch.randn((B, T, H, hd), generator=g).to("cuda", bf16)
    kp, vp = (torch.randn((nb, BS, KV, hd), generator=g).to("cuda", bf16)
              for _ in range(2))
    pt = torch.stack([torch.randperm(nb, generator=g)[:pages]
                      for _ in range(B)]).to("cuda", torch.int32)
    lengths = torch.full((B,), ctx - T, dtype=torch.int32, device="cuda")
    args = (q, kp, vp, pt, lengths)
    entry = fops.paged_prefill_entry(bf16, bf16, hd)
    tag = (f"paged_prefill_attention (K2) glm4 heads {H}/{KV} (G = "
           f"{H // KV}) hd {hd} B={B} T={T} at positions {ctx - T}-"
           f"{ctx - 1} bfloat16 [{entry}]")
    e0 = dict(fops.KERNEL.entry_launches)
    out = fops.paged_prefill_attention(*args)
    torch.cuda.synchronize()
    e1 = fops.KERNEL.entry_launches
    check({e: e1[e] - e0[e] for e in e1} == {e: int(e == entry) for e in e1},
          f"{tag}: launched {e1}, not one {entry}")
    err = (out.float() - fops.paged_prefill_attention_plain(*args).float()
           ).abs().max().item()
    check(torch.isfinite(out.float()).all().item() and err <= TOL[bf16],
          f"{tag}: max_abs_err {err} > {TOL[bf16]}")
    n_vis = B * (T * (ctx - T) + T * (T + 1) // 2)
    row = _time_row(timer, fops.paged_prefill_attention,
                    fops.paged_prefill_attention_plain, args,
                    _attn_library_call(*args, T, False, heads),
                    _bound(2 * q.numel() * 2 + 2 * B * ctx * KV * hd * 2
                           + B * pages * 4 + B * 4, 4 * H * hd * n_vis, bf16))
    log(f"[kernels] {tag}: max_abs_err={err:.3e} (tol {TOL[bf16]})"
        + _fmt(row))
    rows["paged_prefill_attention"] = {
        f"glm4 B={B} T={T} at {ctx - T}-{ctx - 1}": dict(
            entry=entry, max_abs_err=err, **row)}
    del args, q, kp, vp, out
    S = ctx
    q, k, v = _dense_qkv(S + hd + 1, B, S, S, heads, bf16)
    entry = fops.flash_entry(bf16, hd)
    tag = (f"flash_attention (B2, contiguous) glm4 heads {H}/{KV} hd {hd} "
           f"B={B} S=T={S} causal bfloat16 [{entry}]")
    e0 = dict(fops.FLASH_KERNEL.entry_launches)
    out = fops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    e1 = fops.FLASH_KERNEL.entry_launches
    check({e: e1[e] - e0[e] for e in e1} == {e: int(e == entry) for e in e1},
          f"{tag}: launched {e1}, not one {entry}")
    one = (q[:1], k[:1], v[:1])
    want = fops.flash_attention_plain(*one, causal=True)
    err = (out[:1].float() - want.float()).abs().max().item()
    tol = DENSE_BF16_TOL["flash_attention"]
    check(torch.isfinite(out.float()).all().item() and err <= tol,
          f"{tag}: max_abs_err {err} > {tol} (row 0)")
    del want
    n_scores = B * H * S * (S + 1) // 2
    bound = _bound((2 * q.numel() + k.numel() + v.numel()) * 2,
                   4 * hd * n_scores, bf16)
    row = dict(ms=timer.ms(lambda: fops.flash_attention(q, k, v,
                                                        causal=True)),
               plain_ms=timer.ms(lambda: fops.flash_attention_plain(
                   *one, causal=True), iters=5, warmup=1),
               plain_batch=1, bound_ms=bound[0], bound_by=bound[1],
               library_ms=timer.ms(_sdpa(q, k, v, H // KV, causal=True)))
    log(f"[kernels] {tag}: max_abs_err={err:.3e} (tol {tol}; row 0 against "
        f"the plain version at B = 1, whose f32 scores take 17.2 GB at B = "
        f"8)" + _fmt(row) + " (plain_ms at B = 1)")
    rows["flash_attention"][f"glm4 causal B={B} S=T={S}"] = dict(
        entry=entry, max_abs_err=err, **row)


# B2's backward against torch.autograd of its plain version: each
# gradient's largest error over its largest magnitude, just above what
# the card gave in the kernel tests (f32 1.5e-6; bf16 7.5e-3, one to two
# bf16 ulps of the largest gradient)
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
GRAD_TOL_REASON = ("f32: sums in another order than autograd's; bf16: the "
                   "plain version rounds every intermediate product to "
                   "bf16, the kernel keeps them in f32 and rounds the "
                   "gradients once")


def _grad_err(got, want) -> float:
    """The largest of dq's, dk's and dv's max error over max magnitude."""
    return max((g.float() - w.float()).abs().max().item()
               / max(w.float().abs().max().item(), 1e-30)
               for g, w in zip(got, want))


def _n_visible(S, T, causal, window) -> int:
    """Query-key pairs the masks leave (query s at position s)."""
    s = torch.arange(S)[:, None]
    t = torch.arange(T)[None, :]
    vis = torch.ones((S, T), dtype=torch.bool)
    if causal:
        vis &= t <= s
    if window:
        vis &= t > s - window
    return int(vis.sum())


def _backward_bound(B, H, n_vis, hd, hdv, n_bytes, dtype):
    """2.5 times the forward's operations: five S x T products a head
    (scores, dP at hdv, dV at hdv, dQ and dK at hd), multiply and add, at
    the peak rate for the type; against the bytes it must move."""
    ops = 2 * B * H * n_vis * (3 * hd + 2 * hdv)
    return _bound(n_bytes, ops, dtype)


def _sdpa_backward_ms(timer, q, k, v, dout, G, mask=None, causal=False):
    """SDPA's backward, the yardstick: its forward plus backward under
    autograd (K/V expanded to the query heads beforehand) less its
    forward.  The port never calls it."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    kh, vh = (t.repeat_interleave(G, dim=1) for t in (kh, vh))
    leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
    doh = dout.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd():
        return sdpa(*leaves, attn_mask=mask, is_causal=causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, doh)
    return timer.ms(fwd_bwd) - timer.ms(fwd)


def _same_bits(a, b) -> bool:
    return all(torch.equal(x.view(torch.int16 if x.element_size() == 2
                                  else torch.int32),
                           y.view(torch.int16 if y.element_size() == 2
                                  else torch.int32))
               for x, y in zip(a, b))


def _check_backward_entry(fops, before, entry, tag) -> None:
    """Exactly one backward launch since ``before``, of ``entry``."""
    after = dict(fops.BACKWARD_KERNEL.entry_launches)
    got = {e: n - before[e] for e, n in after.items() if n - before[e]}
    check(got == {entry: 1}, f"{tag}: backward launches {got}, not one "
          f"of {entry}")


def _backward_row(timer, q, k, v, tag, *, causal=True, window=0, mask=None):
    """B2's backward on (q, k, v) and a random dout through
    ``flash_attention_backward`` as a caller without the logsumexp calls
    it (the tensor-core entry takes it from the ``*_lse`` forward):
    exactly one launch of the entry ``flash_backward_entry`` picks; dq,
    dk, dv against ``flash_attention_backward_plain`` within ``GRAD_TOL``;
    a second launch gives the same bits.  Then timed as autograd runs
    it (the tensor-core entry given the forward's logsumexp) against the
    plain version, SDPA's backward and its bound."""
    from repro_torch.kernels.flash_attention import ops as fops
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = torch.Generator(device="cpu").manual_seed(S + T)
    dout = torch.randn(q.shape, generator=g).to("cuda", q.dtype)
    out = fops.flash_attention(q, k, v, causal=causal, sliding_window=window)
    kw = dict(causal=causal, sliding_window=window)
    entry = fops.flash_backward_entry((q.dtype,), hd, hd)
    before = dict(fops.BACKWARD_KERNEL.entry_launches)
    got = fops.flash_attention_backward(q, k, v, out, dout, **kw)
    torch.cuda.synchronize()
    _check_backward_entry(fops, before, entry, tag)
    check(all(torch.isfinite(t.float()).all().item() for t in got),
          f"{tag}: non-finite gradients")
    want = fops.flash_attention_backward_plain(q, k, v, out, dout, **kw)
    err = _grad_err(got, want)
    tol = GRAD_TOL[q.dtype]
    check(err <= tol, f"{tag}: relative gradient error {err} > {tol}")
    lse = None
    if fops.backward_takes_lse(q, v):
        _, lse = fops._flash_forward(q, k, v, causal, window, lse=True)
    again = fops.flash_attention_backward(q, k, v, out, dout, lse=lse, **kw)
    torch.cuda.synchronize()
    check(_same_bits(got, again), f"{tag}: two launches differ")
    n_bytes = 2 * (q.numel() + k.numel() + v.numel()) * q.element_size() \
        + 2 * out.numel() * q.element_size()
    bound = _backward_bound(B, H, _n_visible(S, T, causal, window), hd, hd,
                            n_bytes, q.dtype)
    ms = timer.ms(lambda: fops.flash_attention_backward(q, k, v, out, dout,
                                                         lse=lse, **kw))
    plain_ms = timer.ms(lambda: fops.flash_attention_backward_plain(
        q, k, v, out, dout, **kw))
    lib = _sdpa_backward_ms(timer, q, k, v, dout, H // KV, mask=mask,
                            causal=causal and not window)
    row = dict(entry=entry,
               max_abs_err=max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(got, want)),
               rel_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
               bound_by=bound[1], library_ms=lib)
    log(f"{tag}: {entry}, relative error {err:.3e} (tol {tol}), two launches "
        f"equal" + _fmt(row))
    return row


def _mla_backward_row(timer, B, S, H):
    """B2's backward at DeepSeek-V3's MLA heads on MLA's own operands
    (q/k 128 + 64 with one rope key a token shared by every head, V 128,
    bf16): the gradient of ``mla_flash_attention`` (the MLA ``*_lse``
    forward, then ``flash_attention_backward_mla_bf16_mma``, which reads
    the rope key in place and sums its gradient over the heads) against
    torch.autograd of its plain version; a second launch gives the same
    bits; the backward's peak memory above what the forward left: its
    four gradients and delta, nothing else (no broadcast K, no (B, T, H,
    192) dk, no f32 copy of the rope columns; the rope partials live in
    dq's storage); timed as that autograd backward."""
    from repro_torch.kernels.flash_attention import ops as fops
    nope, rope, vd = 128, 64, 128
    g = torch.Generator(device="cpu").manual_seed(S + H)
    ops_in = [torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
              for shape in ((B, S, H, nope + rope), (B, S, H, nope),
                            (B, S, rope), (B, S, H, vd))]
    dout = torch.randn((B, S, H, vd), generator=g).to("cuda", torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in ops_in]
    tag = (f"[kernels] flash_attention_backward MLA heads {H}/{H} q/k "
           f"{nope + rope} (rope {rope} shared) V {vd} B={B} S=T={S} causal "
           f"bfloat16")
    before = dict(fops.FLASH_KERNEL.entry_launches)
    out = fops.mla_flash_attention(*leaves)
    torch.cuda.synchronize()
    check(fops.FLASH_KERNEL.entry_launches["flash_attention_mla_bf16_mma_lse"]
          == before["flash_attention_mla_bf16_mma_lse"] + 1,
          f"{tag}: the forward did not launch its *_lse entry")
    entry = "flash_attention_backward_mla_bf16_mma"
    before = dict(fops.BACKWARD_KERNEL.entry_launches)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    _check_backward_entry(fops, before, entry, tag)
    # the four gradients (the operands' sizes) and delta (B, H, S) f32
    own = sum(t.numel() for t in ops_in) * 2 + B * H * S * 4
    check(peak <= own + (2 << 20),
          f"{tag}: backward peak {peak} bytes above the forward's, its "
          f"gradients and delta take {own}")
    again = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    torch.cuda.synchronize()
    check(_same_bits(got, again), f"{tag}: two launches differ")
    plain_leaves = [t.clone().requires_grad_() for t in ops_in]
    want = torch.autograd.grad(fops.mla_flash_attention_plain(*plain_leaves),
                               plain_leaves, dout)
    err = _grad_err(got, want)
    tol = GRAD_TOL[torch.bfloat16]
    check(err <= tol, f"{tag}: relative gradient error {err} > {tol}")
    n_bytes = 2 * sum(t.numel() for t in ops_in) * 2 + 2 * out.numel() * 2
    bound = _backward_bound(B, H, _n_visible(S, S, True, 0), nope + rope, vd,
                            n_bytes, torch.bfloat16)
    ms = timer.ms(lambda: torch.autograd.grad(out, leaves, dout,
                                              retain_graph=True))

    def plain():
        ls = [t.clone().requires_grad_() for t in ops_in]
        torch.autograd.grad(fops.mla_flash_attention_plain(*ls), ls, dout)
    plain_ms = timer.ms(plain)
    k = torch.cat([ops_in[1], ops_in[2][:, :, None].expand(B, S, H, rope)],
                  dim=-1)
    lib = _sdpa_backward_ms(timer, ops_in[0], k, ops_in[3], dout, 1,
                            causal=True)
    row = dict(entry=entry,
               max_abs_err=max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(got, want)),
               rel_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
               bound_by=bound[1], library_ms=lib, peak_mib=peak / 2**20)
    log(f"{tag}: {entry}, relative error {err:.3e} (tol {tol}), two launches "
        f"equal; peak {peak / 2**20:.1f} MiB above the forward's (gradients "
        f"and delta {own / 2**20:.1f}; PR 23's design also held a broadcast "
        f"K, its (B, T, H, 192) dk and an f32 copy of the rope columns)"
        + _fmt(row))
    return row


def _lse_rows(timer):
    """The ``*_lse`` forward entries beside the served ones at phase 3's
    backward shapes (smollm, jamba and nemotron heads, B = 8, S = 512,
    causal, bf16 and f32; MLA's heads on their own operands): the same
    out bit for bit (random normal operands); the logsumexp within 1e-5
    of ``flash_attention_lse_plain`` on operands in {-1, 0, 1} (bf16:
    every score exact in f32 in any summation order, so both round the
    same scores; f32: sums of +-scale, each to f32 rounding); timed beside
    the served entry, the plain version, SDPA's forward and the bound (the
    served entry's plus the logsumexp's bytes)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    B, S = 8, 512
    rows = {}

    def signs(seed, shape, dtype=torch.bfloat16):
        g = torch.Generator(device="cpu").manual_seed(seed)
        return torch.randint(-1, 2, shape, generator=g).to("cuda", dtype)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("smollm", SMOLLM_HEADS, bf16), ("jamba", JAMBA_HEADS, bf16),
             ("nemotron", NEMOTRON_HEADS, bf16), ("mla", None, bf16),
             ("smollm", SMOLLM_HEADS, f32), ("jamba", JAMBA_HEADS, f32),
             ("nemotron", NEMOTRON_HEADS, f32)]
    for geo, heads, dtype in cases:
        if heads is None:
            H, (nope, rope, vd) = MLA_HEADS["H"], dops.MLA_DIMS
            shapes = ((B, S, H, nope + rope), (B, S, H, nope), (B, S, rope),
                      (B, S, H, vd))
            g = torch.Generator(device="cpu").manual_seed(7)
            ins = [torch.randn(sh, generator=g).to("cuda", torch.bfloat16)
                   for sh in shapes]
            ones = [signs(i, sh) for i, sh in enumerate(shapes)]
            fwd = fops._mla_flash_forward
            served = "flash_attention_mla_bf16_mma"
            k, vp = dops.mla_gqa_operands(*ones[1:])
            plain = (ones[0], k, vp)
            tag = (f"MLA heads {H}/{H} q/k {nope + rope} (rope shared) V "
                   f"{vd}")
            kb = torch.cat([ins[1], ins[2][:, :, None].expand(
                B, S, H, rope)], dim=-1)
            library = _sdpa(ins[0], kb, ins[3], 1, causal=True)

            def plain_call():
                k_, vp_ = dops.mla_gqa_operands(*ins[1:])
                return fops.flash_attention_lse_plain(ins[0], k_, vp_,
                                                      causal=True)
            ops = 2 * B * H * _n_visible(S, S, True, 0) * (nope + rope + vd)
        else:
            H, KV, hd = heads["H"], heads["KV"], heads["hd"]
            ins = list(_dense_qkv(hd, B, S, S, heads, dtype))
            shapes = ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))
            ones = [signs(i, sh, dtype) for i, sh in enumerate(shapes)]

            def fwd(*a, lse=False):
                return fops._flash_forward(*a, True, 0, lse=lse)
            served = fops.flash_entry(dtype, hd)
            plain = ones
            tag = f"{geo} heads {H}/{KV} hd {hd} {str(dtype)[6:]}"
            library = _sdpa(*ins, H // KV, causal=True)

            def plain_call():
                return fops.flash_attention_lse_plain(*ins, causal=True)
            ops = 4 * B * H * hd * _n_visible(S, S, True, 0)
        lse_entry = fops.LSE_ENTRIES[served]
        want = fwd(*ins)
        before = dict(fops.FLASH_KERNEL.entry_launches)
        got, _ = fwd(*ins, lse=True)
        _, lse = fwd(*ones, lse=True)
        torch.cuda.synchronize()
        check(fops.FLASH_KERNEL.entry_launches[lse_entry]
              == before[lse_entry] + 2, f"{lse_entry} did not launch")
        check(_same_bits([got], [want]),
              f"{lse_entry}: out differs from {served}'s")
        _, lse_want = fops.flash_attention_lse_plain(*plain, causal=True)
        err = (lse - lse_want).abs().max().item()
        check(err <= 1e-5, f"{lse_entry} {tag}: logsumexp error {err}")
        # operands read once, out and the logsumexp written once
        n_bytes = (sum(t.numel() for t in ins) + got.numel()) \
            * got.element_size() + lse.numel() * 4
        bound = _bound(n_bytes, ops, dtype)
        served_ms = timer.ms(lambda: fwd(*ins))
        row = dict(served_ms=served_ms, lse_max_abs_err=err,
                   **_time_row(timer, lambda: fwd(*ins, lse=True),
                               plain_call, (), library, bound))
        rows[f"{lse_entry} {tag}"] = row
        log(f"[kernels] {lse_entry} {tag} B={B} S=T={S} causal: out equal "
            f"to {served}'s bit for bit, logsumexp error {err:.3e} (tol "
            f"1e-5), served entry {served_ms:.4f} ms" + _fmt(row))
    return rows


# 4 heads of 48 (a head dim outside the tensor-core bodies')
SMOKE48_HEADS = dict(H=4, KV=4, hd=48)
# phase 3's backward rows (geometry, heads, dtype, S, T, causal, window),
# B = 8; kernel_ab.py --backward times the same.  f32 at 64 and 128 runs
# the split-TF32 body, each of those rows timed beside the CUDA-core one
BACKWARD_CASES = (
    ("smollm", SMOLLM_HEADS, torch.bfloat16, 512, 512, True, 0),
    ("smollm", SMOLLM_HEADS, torch.float32, 512, 512, True, 0),
    ("jamba", JAMBA_HEADS, torch.bfloat16, 512, 512, True, 0),
    ("jamba", JAMBA_HEADS, torch.float32, 512, 512, True, 0),
    ("smollm", SMOLLM_HEADS, torch.bfloat16, 512, 512, True, 128),
    ("smollm", SMOLLM_HEADS, torch.float32, 512, 512, True, 128),
    ("whisper encoder", WHISPER_HEADS, torch.bfloat16, 1500, 1500, False, 0),
    ("whisper encoder", WHISPER_HEADS, torch.float32, 1500, 1500, False, 0),
    ("cross", WHISPER_HEADS, torch.bfloat16, 100, 64, False, 0),
    ("cross", WHISPER_HEADS, torch.float32, 100, 64, False, 0),
    ("smoke", SMOKE48_HEADS, torch.bfloat16, 512, 512, True, 0),
    ("nemotron", NEMOTRON_HEADS, torch.bfloat16, 512, 512, True, 0))


def backward_case(geo, heads, dtype, S, T, causal, window, B=8):
    """One of ``BACKWARD_CASES``: its tag, random (q, k, v) on the card and
    SDPA's mask for the window (None without one)."""
    H, KV, hd = heads["H"], heads["KV"], heads["hd"]
    qkv = _dense_qkv(S + T + window + hd, B, S, T, heads, dtype)
    mask = None
    if window:
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)
    tag = (f"[kernels] flash_attention_backward {geo} heads {H}/{KV} hd "
           f"{hd} B={B} S={S} T={T} " + ("causal" if causal else "no mask")
           + (f" window {window}" if window else "") + f" {str(dtype)[6:]}")
    return tag, qkv, mask


def phase_backward_kernels(timer: Timer):
    """B2's backward (``flash_backward.cu``; the JAX package has no TPU
    kernel for it) against its plain version at the shapes training
    gives it: smollm-360m's heads at B = 8, S = 512 causal in bf16 (phase
    17(b)'s shape) and f32 (phase 20(a)'s), jamba's heads causal, a
    128-token window, DeepSeek-V3's MLA heads on their own operands,
    whisper-tiny's encoder without the mask (S = T = 1500, no multiple of
    the 64-key tile), and a cross case, 100 queries over 64 keys without
    the mask (each of those in bf16 and f32), bf16 at head dim 48 and at
    nemotron-4-340b's heads (96/8, 192, causal); bf16 rows at a head dim
    of ``MMA_HEAD_DIMS`` must launch the bf16 tensor-core entry, f32 rows
    at ``TF32_BACKWARD_HEAD_DIMS`` the split-TF32 one (each timed beside
    the CUDA-core f32 entry it replaces, as ``earlier_ms``), head dim 48
    the CUDA-core entry of its type.  Then the ``*_lse`` forward entries
    beside the served ones.  Returns the rows by tag (the ``*_lse`` rows
    under "lse_entries"); the served row is phase 17(b)'s shape."""
    from repro_torch.kernels.flash_attention import ops as fops
    rows = {}
    for case in BACKWARD_CASES:
        tag, (q, k, v), mask = backward_case(*case)
        dtype, causal, window = case[2], case[5], case[6]
        rows[tag] = _backward_row(timer, q, k, v, tag, causal=causal,
                                  window=window, mask=mask)
        bf16, hd = dtype == torch.bfloat16, case[1]["hd"]
        want = ("flash_attention_backward_bf16"
                + ("_mma" if hd in fops.MMA_HEAD_DIMS else "")) if bf16 \
            else ("flash_attention_backward_f32"
                  + ("_tf32" if hd in fops.TF32_BACKWARD_HEAD_DIMS else ""))
        check(rows[tag]["entry"] == want,
              f"{tag}: served by {rows[tag]['entry']}, not {want}")
        if want == "flash_attention_backward_f32_tf32":
            # the CUDA-core f32 body it replaces, on the same operands
            g = torch.Generator(device="cpu").manual_seed(case[3] + case[4])
            dout = torch.randn(q.shape, generator=g).to("cuda", dtype)
            kw = dict(causal=causal, sliding_window=window)
            out = fops.flash_attention(q, k, v, **kw)
            _earlier(timer, rows[tag],
                     _core_backward(fops, q, k, v, out, dout, causal, window),
                     fops.flash_attention_backward_plain(q, k, v, out, dout,
                                                         **kw),
                     GRAD_TOL[dtype], tag, rel=True)
    rows["mla"] = _mla_backward_row(timer, 8, 512, MLA_HEADS["H"])
    rows["lse_entries"] = _lse_rows(timer)
    log(f"[kernels] backward tolerance: {GRAD_TOL} of each gradient's "
        f"largest magnitude ({GRAD_TOL_REASON}); bound: 2.5 x the "
        f"forward's operations at {PEAK_OPS_PER_S[torch.bfloat16] / 1e12:.0f} "
        f"(bf16) / {PEAK_OPS_PER_S[torch.float32] / 1e12:.0f} (f32) TFLOP/s")
    served = next(r for t, r in rows.items()
                  if "smollm" in t and "bfloat16" in t and "window" not in t)
    return served, rows



def _scale_stream(hd: int):
    return (ctypes.c_float(1.0 / np.sqrt(hd)),
            torch.cuda.current_stream().cuda_stream)


def _core_flash(fops, q, k, v):
    """The CUDA-core forward of q's type (``flash_attention_bf16`` or
    ``_f32``, prefill_body.cuh) on K/V repeated to every query head (G =
    1): at G = 12 and head_dim 192 its block needs 446 KB of shared
    memory and is refused, so the earlier body is timed on the operands
    it can take."""
    B, S, H, hd = q.shape
    kr, vr = (t.repeat_interleave(H // k.shape[2], dim=2).contiguous()
              for t in (k, v))
    out = torch.empty_like(q)
    entry = "flash_attention_" + \
        ("bf16" if q.dtype == torch.bfloat16 else "f32")

    def run():
        fops.FLASH_KERNEL.launch(
            entry, q.data_ptr(), kr.data_ptr(),
            vr.data_ptr(), out.data_ptr(), B, S, k.shape[1], H, H, hd, 1, 0,
            *_scale_stream(hd))
        return out
    return run


def _core_paged_prefill(fops, q, k, v, pt, lengths):
    """K2's CUDA-core entry (``paged_prefill_attention_bf16_bf16``) over
    pools repeated to every query head (G = 1; at G = 12 its block needs
    272 KB of shared memory)."""
    B, T, H, hd = q.shape
    kr, vr = (t.repeat_interleave(H // k.shape[2], dim=2).contiguous()
              for t in (k, v))
    out = torch.empty_like(q)

    def run():
        fops.KERNEL.launch(
            "paged_prefill_attention_bf16_bf16", q.data_ptr(), kr.data_ptr(),
            vr.data_ptr(), pt.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, T, H, H, hd, kr.shape[1], pt.shape[1], *_scale_stream(hd))
        return out
    return run


def _core_backward(fops, q, k, v, out, dout, causal=True, window=0):
    """B2''s CUDA-core entry of q's type (``flash_attention_backward_bf16``
    or ``_f32``, three passes; it takes G = 12 as it is)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    lse, delta = (torch.empty((B, H, S), dtype=torch.float32,
                              device=q.device) for _ in range(2))
    grads = [torch.empty_like(t) for t in (q, k, v)]
    entry = "flash_attention_backward_" + \
        ("bf16" if q.dtype == torch.bfloat16 else "f32")

    def run():
        fops.BACKWARD_KERNEL.launch(
            entry, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            *(g.data_ptr() for g in grads), lse.data_ptr(), delta.data_ptr(),
            B, S, T, H, KV, hd, hd, int(causal), int(window),
            *_scale_stream(hd))
        return grads
    return run


def _earlier(timer, row, run, want, tol, tag, rel=False) -> None:
    """Check the earlier (CUDA-core) body against the plain version, time
    it beside the new one's row (``earlier_ms``) and log both."""
    got = run()
    torch.cuda.synchronize()
    err = _grad_err(got, want) if rel else \
        (got.float() - want.float()).abs().max().item()
    check(err <= tol, f"{tag}, the earlier body: error {err} > {tol}")
    row["earlier_ms"] = timer.ms(run)
    row["earlier_err"] = err
    log(f"{tag}: the earlier CUDA-core body {row['earlier_ms']:.4f} ms "
        f"(error {err:.3e}, tol {tol}) against {row['ms']:.4f}: "
        f"{row['earlier_ms'] / row['ms']:.1f}x; SDPA "
        f"{row['library_ms']:.4f}, {row['ms'] / row['library_ms']:.2f}x")


def phase_nemotron_kernels(timer: Timer, backward_rows: dict):
    """The kernels at nemotron-4-340b's heads (96/8, head_dim 192 with V
    192: G = 12), bf16, at phase 19's shapes, each against its plain
    version, timed beside the plain version, SDPA and the bound: B2
    contiguous at B = 8, S = T = 512, causal (``flash_attention_bf16_mma``,
    the tensor-core body at 192); K2 at B = 8, T = 32, the last chunk of
    512-token prompts (lengths 480; ``paged_prefill_attention_bf16_bf16_
    mma``); K1 at B = 8 over 544 valid keys of a paged pool; B4 at B = 8
    over a 544-slot cache, all valid.  B2 and K2 also through the earlier
    CUDA-core entries on K/V repeated to the 96 query heads (what they can
    take: their blocks do not fit G = 12 at 192), in the same call, and
    B2' (``BACKWARD_CASES``' nemotron row, in ``backward_rows``) through
    its CUDA-core entry, that time added to the row.  Returns {kernel:
    row}."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    heads, bf16 = NEMOTRON_HEADS, torch.bfloat16
    H, KV, hd = heads["H"], heads["KV"], heads["hd"]
    B, S, G = 8, NEMOTRON_CTX, heads["H"] // heads["KV"]
    rows = {}
    tag0 = f"nemotron heads {H}/{KV} hd {hd} B={B}"

    # B2, contiguous, causal
    q, k, v = _dense_qkv(S + hd, B, S, S, heads, bf16)
    entry = fops.flash_entry(bf16, hd)
    e0 = fops.FLASH_KERNEL.entry_launches[entry]
    out = fops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    check(fops.FLASH_KERNEL.entry_launches[entry] == e0 + 1
          and entry == "flash_attention_bf16_mma",
          f"B2 at nemotron heads did not launch {entry}")
    want = fops.flash_attention_plain(q, k, v, causal=True)
    err = (out.float() - want.float()).abs().max().item()
    tol = DENSE_BF16_TOL["flash_attention"]
    tag = f"[kernels] flash_attention (contiguous) {tag0} S=T={S} causal " \
          f"bfloat16 [{entry}]"
    check(torch.isfinite(out.float()).all().item() and err <= tol,
          f"{tag}: max_abs_err {err} > {tol}")
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    row = _time_row(timer, lambda *a: fops.flash_attention(*a, causal=True),
                    lambda *a: fops.flash_attention_plain(*a, causal=True),
                    (q, k, v), _sdpa(q, k, v, G, causal=True),
                    _bound(n_bytes, 4 * B * H * hd * _n_visible(S, S, True, 0),
                           bf16))
    log(f"{tag}: max_abs_err={err:.3e} (tol {tol})" + _fmt(row))
    _earlier(timer, row, _core_flash(fops, q, k, v), want, tol, tag)
    rows["flash_attention"] = dict(max_abs_err=err, **row)
    del q, k, v, out, want

    # K2 (T = 32, the last chunk of a 512-token prompt) and K1 (544 valid)
    g = torch.Generator(device="cpu").manual_seed(hd + 19)
    nb = B * P + 7
    kp, vp = (torch.randn((nb, BS, KV, hd), generator=g).to("cuda", bf16)
              for _ in range(2))
    pt = torch.stack([torch.randperm(nb, generator=g)[:P]
                      for _ in range(B)]).to("cuda", torch.int32)
    for name, T, n in (("paged_prefill_attention", 32, S - 32),
                       ("paged_decode_attention", 1, NEMOTRON_CAP)):
        decode = T == 1
        lengths = torch.full((B,), n, dtype=torch.int32, device="cuda")
        q = torch.randn((B, T, H, hd), generator=g).to("cuda", bf16)
        if decode:
            q = q[:, 0].contiguous()
            kern, plain, handle = (dops.paged_decode_attention,
                                   dops.paged_decode_attention_plain,
                                   dops.KERNEL)
            entry = dops.decode_entry("paged_decode_attention", bf16, bf16,
                                      G, hd)
        else:
            kern, plain, handle = (fops.paged_prefill_attention,
                                   fops.paged_prefill_attention_plain,
                                   fops.KERNEL)
            entry = fops.paged_prefill_entry(bf16, bf16, hd)
        args = (q, kp, vp, pt, lengths)
        e0 = handle.entry_launches[entry]
        got = kern(*args)
        torch.cuda.synchronize()
        check(handle.entry_launches[entry] == e0 + 1,
              f"{name} at nemotron heads did not launch {entry}")
        want = plain(*args)
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[bf16]
        tag = (f"[kernels] {name} {tag0} T={T} "
               + (f"over {n} valid keys" if decode else
                  f"at positions {n}..{n + T - 1}") + f" bfloat16 [{entry}]")
        check(torch.isfinite(got.float()).all().item() and err <= tol,
              f"{tag}: max_abs_err {err} > {tol}")
        row = _time_row(timer, kern, plain, args,
                        _attn_library_call(*args, T, decode, heads),
                        _attn_bound_ms(q, kp, lengths, T, decode, heads))
        log(f"{tag}: max_abs_err={err:.3e} (tol {tol})" + _fmt(row))
        if not decode:
            _earlier(timer, row, _core_paged_prefill(fops, *args), want, tol,
                     tag)
        else:   # decode_body.cuh's entry
            _earlier(timer, row, _decode_entry_run(
                dops, "paged_decode_attention_bf16_bf16", args), want, tol,
                tag)
        rows[name] = dict(entry=entry, max_abs_err=err, **row)
    del kp, vp

    # B4 over a 544-slot cache, all valid
    C = NEMOTRON_CAP
    q, k, v = _dense_qkv(C + hd, B, 1, C, heads, bf16)
    q = q[:, 0].contiguous()
    entry = dops.decode_entry("decode_attention", bf16, bf16, G, hd)
    n0 = dops.DENSE_KERNEL.entry_launches[entry]
    got = dops.decode_attention(q, k, v, C)
    torch.cuda.synchronize()
    check(dops.DENSE_KERNEL.entry_launches[entry] == n0 + 1,
          f"decode_attention at nemotron heads did not launch {entry}")
    want = dops.decode_attention_plain(q, k, v, C)
    err = (got.float() - want.float()).abs().max().item()
    tol = DENSE_BF16_TOL["decode_attention"]
    tag = f"[kernels] decode_attention (dense) {tag0} C={C} n_valid={C} " \
          f"bfloat16 [{entry}]"
    check(torch.isfinite(got.float()).all().item() and err <= tol,
          f"{tag}: max_abs_err {err} > {tol}")
    n_bytes = q.numel() * 4 + 2 * B * C * KV * hd * 2
    row = _time_row(timer, dops.decode_attention, dops.decode_attention_plain,
                    (q, k, v, C), _sdpa(q[:, None], k, v, G),
                    _bound(n_bytes, 4 * B * H * hd * C, bf16))
    log(f"{tag}: max_abs_err={err:.3e} (tol {tol})" + _fmt(row))
    _earlier(timer, row, _decode_entry_run(
        dops, "decode_attention_bf16_bf16", (q, k, v, C)), want, tol, tag)
    rows["decode_attention"] = dict(entry=entry, max_abs_err=err, **row)

    # B2': the CUDA-core entry on BACKWARD_CASES' nemotron operands, its
    # time added to that case's row (phase_backward_kernels)
    case = next(c for c in BACKWARD_CASES if c[0] == "nemotron")
    tag, (q, k, v), _ = backward_case(*case)
    gd = torch.Generator(device="cpu").manual_seed(case[3] + case[4])
    dout = torch.randn(q.shape, generator=gd).to("cuda", bf16)
    out = fops.flash_attention(q, k, v, causal=True)
    want = fops.flash_attention_backward_plain(q, k, v, out, dout)
    row = backward_rows[tag]
    _earlier(timer, row, _core_backward(fops, q, k, v, out, dout), want,
             GRAD_TOL[bf16], tag, rel=True)
    # where the new body's time goes: each kernel's mean over the launches
    # one trace of 4 calls holds (warm L2; the trace may miss the first)
    from torch.profiler import ProfilerActivity, profile
    _, lse = fops._flash_forward(q, k, v, True, 0, lse=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(4):
            fops.flash_attention_backward(q, k, v, out, dout, lse=lse)
        torch.cuda.synchronize()
    got = {n: [(e.self_device_time_total, e.count)
               for e in prof.key_averages() if n in e.key]
           for n in ("delta_kernel", "dkdv_kernel", "dq_kernel")}
    counts = {n: sum(c for _, c in v) for n, v in got.items()}
    check(all(c >= 2 for c in counts.values()),
          f"{tag}: the trace holds {counts} launches, want 2 to 4 of each")
    row["traced_ms"] = {n: sum(us for us, _ in v) / counts[n] / 1e3
                        for n, v in got.items()}
    log(f"{tag}: traced (warm L2; launches {counts}) "
        + ", ".join(f"{n} {ms:.4f} ms" for n, ms in row["traced_ms"].items()))
    del q, k, v, out, dout, want, lse
    _nemotron_f32_rows(timer, rows)
    return rows


def _nemotron_f32_rows(timer: Timer, rows: dict) -> None:
    """The same kernels in f32 at nemotron-4-340b's heads (phase 20(b)'s
    types): B2 contiguous at B = 8, S = T = 512, causal
    (``flash_attention_f32_tf32``: the split-TF32 body in 8-warp blocks
    at 192) beside the earlier CUDA-core f32 entry on K/V repeated to the
    96 query heads; K2 at T = 32 ending at position 512 with f32 q over
    f32 pools (``paged_prefill_attention_f32_f32_tf32``) and over bf16
    pools (``_f32_bf16_tf32``); K2q over int8 pools made from the f32
    ones (``paged_prefill_attention_quant_f32_tf32``); K1 over 544 keys
    of the f32 pools; B4 over a 544-slot f32 cache.  Each launch's entry
    checked, each against its plain version (``TOL`` of its output
    type), timed beside it, one library call and the bound; added to
    ``rows`` under "float32" ("float32_bf16_pools" for K2 over bf16
    pools; K2q under its own kernel)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.attention import dequantize_kv
    heads, f32, bf16 = NEMOTRON_HEADS, torch.float32, torch.bfloat16
    H, KV, hd = heads["H"], heads["KV"], heads["hd"]
    B, S, G = 8, NEMOTRON_CTX, heads["H"] // heads["KV"]
    tag0 = f"nemotron heads {H}/{KV} hd {hd} B={B}"

    def launched(handle, entry, run):
        e0 = handle.entry_launches[entry]
        got = run()
        torch.cuda.synchronize()
        check(handle.entry_launches[entry] == e0 + 1,
              f"{entry} did not launch at nemotron heads")
        return got

    # B2, contiguous, causal
    q, k, v = _dense_qkv(S + hd + 1, B, S, S, heads, f32)
    entry = fops.flash_entry(f32, hd)
    check(entry == "flash_attention_f32_tf32",
          f"B2 in f32 at nemotron heads picks {entry}")
    out = launched(fops.FLASH_KERNEL, entry,
                   lambda: fops.flash_attention(q, k, v, causal=True))
    want = fops.flash_attention_plain(q, k, v, causal=True)
    err = (out - want).abs().max().item()
    tol = TOL[f32]
    tag = f"[kernels] flash_attention (contiguous) {tag0} S=T={S} causal " \
          f"float32 [{entry}]"
    check(torch.isfinite(out).all().item() and err <= tol,
          f"{tag}: max_abs_err {err} > {tol}")
    row = _time_row(timer, lambda *a: fops.flash_attention(*a, causal=True),
                    lambda *a: fops.flash_attention_plain(*a, causal=True),
                    (q, k, v), _sdpa(q, k, v, G, causal=True),
                    _bound((2 * q.numel() + k.numel() + v.numel()) * 4,
                           4 * B * H * hd * _n_visible(S, S, True, 0), f32))
    log(f"{tag}: max_abs_err={err:.3e} (tol {tol})" + _fmt(row))
    _earlier(timer, row, _core_flash(fops, q, k, v), want, tol, tag)
    rows["flash_attention"]["float32"] = dict(entry=entry, max_abs_err=err,
                                              **row)
    del q, k, v, out, want

    # K2 (T = 32 ending at 512) over f32, bf16 and int8 pools; K1 (544)
    g = torch.Generator(device="cpu").manual_seed(hd + 20)
    nb = B * P + 7
    kp, vp = (torch.randn((nb, BS, KV, hd), generator=g).to("cuda", f32)
              for _ in range(2))
    pt = torch.stack([torch.randperm(nb, generator=g)[:P]
                      for _ in range(B)]).to("cuda", torch.int32)
    for name, T, n, kvdt, key in (
            ("paged_prefill_attention", 32, S - 32, f32, "float32"),
            ("paged_prefill_attention", 32, S - 32, bf16,
             "float32_bf16_pools"),
            ("paged_prefill_attention_quant", 32, S - 32, torch.int8,
             "float32"),
            ("paged_decode_attention", 1, NEMOTRON_CAP, f32, "float32")):
        decode = T == 1
        lengths = torch.full((B,), n, dtype=torch.int32, device="cuda")
        q = torch.randn((B, T, H, hd), generator=g).to("cuda", f32)
        if decode:
            q = q[:, 0].contiguous()
        if kvdt == torch.int8:
            kq, vq, ks, vs = _quant_pools(kp, vp)
            args = (q, kq, vq, ks, vs, pt, lengths)
            kern, plain, handle = (fops.paged_prefill_attention_quant,
                                   fops.paged_prefill_attention_quant_plain,
                                   fops.QUANT_KERNEL)
            entry = fops.quant_prefill_entry(hd)
            library = _attn_library_call(
                q, dequantize_kv(kq, ks), dequantize_kv(vq, vs), pt, lengths,
                T, decode, heads)
            bound = _quant_bound_ms(q, lengths, T, decode, heads)
        else:
            args = (q, kp.to(kvdt), vp.to(kvdt), pt, lengths)
            if decode:
                kern, plain, handle = (dops.paged_decode_attention,
                                       dops.paged_decode_attention_plain,
                                       dops.KERNEL)
                entry = dops.decode_entry("paged_decode_attention", f32, f32,
                                          G, hd)
            else:
                kern, plain, handle = (fops.paged_prefill_attention,
                                       fops.paged_prefill_attention_plain,
                                       fops.KERNEL)
                entry = fops.paged_prefill_entry(f32, kvdt, hd)
            library = _attn_library_call(*args, T, decode, heads)
            bound = _attn_bound_ms(q, args[1], lengths, T, decode, heads)
        check(decode or entry.endswith("_tf32"),
              f"{name} f32 q at nemotron heads picks {entry}")
        got = launched(handle, entry, lambda: kern(*args))
        want = plain(*args)
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[bf16 if kvdt == bf16 else f32]
        tag = (f"[kernels] {name} {tag0} T={T} "
               + (f"over {n} valid keys" if decode else
                  f"at positions {n}..{n + T - 1}")
               + f" q=float32 kv={str(kvdt)[6:]} [{entry}]")
        check(torch.isfinite(got.float()).all().item() and err <= tol,
              f"{tag}: max_abs_err {err} > {tol}")
        row = _time_row(timer, kern, plain, args, library, bound)
        log(f"{tag}: max_abs_err={err:.3e} (tol {tol})" + _fmt(row))
        if decode:      # decode_body.cuh's entry
            _earlier(timer, row, _decode_entry_run(
                dops, "paged_decode_attention_f32_f32", args), want, tol,
                tag)
        rows.setdefault(name, {})[key] = dict(entry=entry, max_abs_err=err,
                                              **row)
        del args, got, want
    del kp, vp

    # B4 over a 544-slot f32 cache, all valid
    C = NEMOTRON_CAP
    q, k, v = _dense_qkv(C + hd + 1, B, 1, C, heads, f32)
    q = q[:, 0].contiguous()
    entry = dops.decode_entry("decode_attention", f32, f32, G, hd)
    got = launched(dops.DENSE_KERNEL, entry,
                   lambda: dops.decode_attention(q, k, v, C))
    want = dops.decode_attention_plain(q, k, v, C)
    err = (got - want).abs().max().item()
    tol = TOL[f32]
    tag = f"[kernels] decode_attention (dense) {tag0} C={C} n_valid={C} " \
          f"float32 [{entry}]"
    check(torch.isfinite(got).all().item() and err <= tol,
          f"{tag}: max_abs_err {err} > {tol}")
    row = _time_row(timer, dops.decode_attention, dops.decode_attention_plain,
                    (q, k, v, C), _sdpa(q[:, None], k, v, G),
                    _bound(q.numel() * 8 + 2 * B * C * KV * hd * 4,
                           4 * B * H * hd * C, f32))
    log(f"{tag}: max_abs_err={err:.3e} (tol {tol})" + _fmt(row))
    _earlier(timer, row, _decode_entry_run(
        dops, "decode_attention_f32_f32", (q, k, v, C)), want, tol, tag)
    rows["decode_attention"]["float32"] = dict(entry=entry, max_abs_err=err,
                                               **row)


# the group sizes phase 3 times both decode bodies at (G = 1, 3, 4, 8,
# 12, 16), B = 8 over 544 valid keys: whisper-tiny, smollm-360m,
# jamba-v0.1, qwen2-vl-72b, nemotron-4-340b and glm4-9b's heads
GLM4_HEADS = dict(H=32, KV=2, hd=128)        # glm4-9b: 32 query, 2 KV
GQA_GEOMETRIES = (("whisper", dict(H=6, KV=6, hd=64)),
                  ("smollm", SMOLLM_HEADS), ("jamba", JAMBA_HEADS),
                  ("qwen2-vl", dict(H=64, KV=8, hd=128)),
                  ("nemotron", NEMOTRON_HEADS), ("glm4", GLM4_HEADS))
# the long-context rows: (tag, heads, keys), B = 8, bf16
GQA_LONG = (("nemotron", NEMOTRON_HEADS, 8192), ("glm4", GLM4_HEADS, 4160),
            ("glm4", GLM4_HEADS, 8192))
# phase_gqa_decode's bf16 rows are held within this many bf16 ulps of the
# plain version's largest |out| as well as phase 3's tolerance: randn
# operands average out to |out| ~ sqrt(e / keys) (0.018 at 8192 keys,
# under the fixed 2e-2), and the largest error seen on the card was
# three ulps (K1 at nemotron's heads over 544 keys, whose plain version
# rounds the normalized probabilities)
GQA_BF16_ULPS = 4


def _decode_entry_run(dops, entry, args, split=None):
    """A callable that launches C entry ``entry`` of K1 (args q, pools,
    page table, lengths) or B4 (args q, caches, n_valid) on ``args``, with
    the split plan that entry's wrapper would give it (or ``split``, a
    (split_keys, n_split) pair): the body the dispatch did not pick, timed
    on the same operands."""
    q = args[0]
    B, H, hd = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    scale = ctypes.c_float(1.0 / np.sqrt(hd))
    out = torch.empty(q.shape, dtype=args[1].dtype, device=q.device)
    KV = args[1].shape[2]
    max_keys = args[1].shape[1] * args[3].shape[1] if len(args) == 5 \
        else args[3]

    def split_args():
        if split is None:
            return dops._split_args(q, max_keys, KV, entry=entry)
        ws, cnt = dops.workspace(q.device, B * KV * split[1] * (H // KV)
                                 * (hd + 2), B * KV)
        return (*split, ws.data_ptr(), cnt.data_ptr())
    if len(args) == 5:
        _, kp, vp, pt, lengths = args
        bs, P = kp.shape[1], pt.shape[1]

        def run():
            dops.KERNEL.launch(
                entry, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                pt.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, H, KV,
                hd, bs, P, scale, *split_args(), stream)
            return out
    else:
        _, k, v, n_valid = args
        C = k.shape[1]

        def run():
            dops.DENSE_KERNEL.launch(
                entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), B, C, H, KV, hd, n_valid, scale,
                *split_args(), stream)
            return out
    return run


def _quant_entry_run(dops, entry, args, split=None):
    """A callable that launches B3's C entry ``entry`` on ``args`` (q,
    int8 pools, their scales, page table, lengths) with the split plan
    that entry's wrapper would give it (or ``split``, a (split_keys,
    n_split) pair): the body the dispatch did not pick, or another plan,
    timed on the same operands."""
    q, kq, vq, ks, vs, pt, lengths = args
    B, H, hd = q.shape
    KV, bs, P = kq.shape[2], kq.shape[1], pt.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(q)

    def split_args():
        if split is None:
            return dops._split_args(q, P * bs, KV, entry=entry,
                                    kv_dtype=torch.int8)
        ws, cnt = dops.workspace(q.device, B * KV * split[1] * (H // KV)
                                 * (hd + 2), B * KV)
        return (*split, ws.data_ptr(), cnt.data_ptr())

    def run():
        dops.QUANT_KERNEL.launch(
            entry, q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), pt.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, KV, hd, bs, P, ctypes.c_float(1.0 / np.sqrt(hd)),
            *split_args(), stream)
        return out
    return run


def _decode_bound(q, kv_dtype, KV, n_keys, paged: bool):
    """Least time of one decode call: q read, the output written, n_keys
    K and V rows of each (row, KV head), the page-table entries they sit
    in and the lengths (paged); 4 * H * hd operations a key and row.  Over
    int8 pools (B3) each key's K and V rows also carry two f32 scales, and
    the output and the operations are f32's (the reference dequantizes to
    f32 and computes in f32)."""
    B, H, hd = q.shape
    quant = kv_dtype == torch.int8
    es = torch.empty((), dtype=kv_dtype).element_size()
    n_bytes = q.numel() * (q.element_size() + (4 if quant else es)) \
        + B * n_keys * KV * (2 * hd * es + (8 if quant else 0))
    if paged:
        n_bytes += B * (-(-n_keys // BS)) * 4 + B * 4
    return _bound(n_bytes, 4 * B * H * hd * n_keys,
                  torch.float32 if quant else kv_dtype)


def _gqa_decode_case(dops, paged, heads, B, n_keys, dtype, seed):
    """K1's (paged: a shuffled page table over a pool with spare blocks,
    every row n_keys long) or B4's (a cache of n_keys slots, all valid)
    operands, with their kernel, plain version, kernel handle and one
    library call (SDPA over K/V expanded to the query heads)."""
    H, KV, hd = heads["H"], heads["KV"], heads["hd"]
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g).to("cuda", dtype)
    if paged:
        pages = -(-n_keys // BS)
        nb = B * pages + 7
        kp, vp = (torch.randn((nb, BS, KV, hd), generator=g).to("cuda", dtype)
                  for _ in range(2))
        pt = torch.stack([torch.randperm(nb, generator=g)[:pages]
                          for _ in range(B)]).to("cuda", torch.int32)
        lengths = torch.full((B,), n_keys, dtype=torch.int32, device="cuda")
        args = (q, kp, vp, pt, lengths)
        return (args, dops.paged_decode_attention,
                dops.paged_decode_attention_plain, dops.KERNEL,
                _attn_library_call(*args, 1, True, heads))
    k, v = (torch.randn((B, n_keys, KV, hd), generator=g).to("cuda", dtype)
            for _ in range(2))
    args = (q, k, v, n_keys)
    return (args, dops.decode_attention, dops.decode_attention_plain,
            dops.DENSE_KERNEL, _sdpa(q[:, None], k, v, H // KV))


def phase_gqa_decode(timer: Timer) -> dict:
    """K1 and B4 by group size: at each of ``GQA_GEOMETRIES`` (G = 1, 3,
    4, 8, 12, 16), B = 8 over 544 valid keys, bf16 and f32, the entry the
    dispatch picks (``decode_entry``) against its plain version (phase
    3's tolerances), launched once and checked, twice the same bits, then
    timed beside the other body's entry on the same operands (both
    checked against the plain version), SDPA and the bound: the rows that
    set the dispatch's rule.  bf16 rows are also held within
    ``GQA_BF16_ULPS`` bf16 ulps of the plain version's largest.  Then
    the long-context rows (``GQA_LONG``:
    nemotron's heads over 8192 keys, glm4's over 4160 and 8192; B = 8,
    bf16), each body timed.  Returns {kernel: {shape: row}}."""
    from repro_torch.kernels.decode_attention import ops as dops
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {"paged_decode_attention": {}, "decode_attention": {}}
    B = 8
    cases = [(geo, heads, 544, dt) for geo, heads in GQA_GEOMETRIES
             for dt in (bf16, f32)] + \
        [(geo, heads, n, bf16) for geo, heads, n in GQA_LONG]
    for geo, heads, n_keys, dtype in cases:
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        G = H // KV
        for paged in (True, False):
            name = "paged_decode_attention" if paged else "decode_attention"
            args, kern, plain, handle, library = _gqa_decode_case(
                dops, paged, heads, B, n_keys, dtype, seed=n_keys + G + hd)
            entry = dops.decode_entry(name, dtype, dtype, G, hd)
            other = (f"{name}_{dops._NAMES[dtype]}_{dops._NAMES[dtype]}"
                     if entry.endswith(("_mma", "_tf32")) else
                     f"{name}_{dops._NAMES[dtype]}_{dops._NAMES[dtype]}"
                     + ("_mma" if dtype == bf16 else "_tf32"))
            e0 = dict(handle.entry_launches)
            got = kern(*args)
            again = kern(*args)
            torch.cuda.synchronize()
            e1 = handle.entry_launches
            check({e: e1[e] - e0[e] for e in e1} == {e: 2 * (e == entry)
                                                     for e in e1},
                  f"{name} {geo}: launched {e1}, not twice {entry}")
            want = plain(*args)
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[f32] if dtype == f32 else min(
                TOL[bf16] if paged else DENSE_BF16_TOL["decode_attention"],
                GQA_BF16_ULPS * _bf16_ulp(want))
            tag = (f"[kernels] {name} {geo} heads {H}/{KV} (G = {G}) hd {hd} "
                   f"B={B} over {n_keys} keys {str(dtype)[6:]} [{entry}]")
            check(torch.isfinite(got.float()).all().item() and err <= tol,
                  f"{tag}: max_abs_err {err} > {tol}")
            check(torch.equal(got, again), f"{tag}: two launches differ")
            row = _time_row(timer, kern, plain, args, library,
                            _decode_bound(args[0], dtype, KV, n_keys, paged))
            log(f"{tag}: max_abs_err={err:.3e} (tol {tol})" + _fmt(row))
            run = _decode_entry_run(dops, other, args)
            got = run()
            torch.cuda.synchronize()
            err_o = (got.float() - want.float()).abs().max().item()
            check(err_o <= tol, f"{tag}: {other} error {err_o} > {tol}")
            row.update(entry=entry, max_abs_err=err, other_entry=other,
                       other_ms=timer.ms(run), other_err=err_o)
            log(f"{tag}: {other} {row['other_ms']:.4f} ms (error "
                f"{err_o:.3e}): {entry} takes "
                f"{row['ms'] / row['other_ms']:.2f}x its time; "
                f"{100 * row['bound_ms'] / row['ms']:.1f}% of the bound")
            rows[name][f"{geo} G={G} hd={hd} B={B} keys={n_keys} "
                       f"{str(dtype)[6:]}"] = row
            del args, got, again, want, library
    rows["paged_decode_attention_quant"] = _quant_gqa_rows(timer)
    return rows


# B3's phase-3 rows over int8 pools: (tag, heads, keys), B = 8
QUANT_GQA = tuple((geo, heads, 544) for geo, heads in GQA_GEOMETRIES) + (
    ("glm4", GLM4_HEADS, 4160), ("glm4", GLM4_HEADS, 8192))


def _quant_gqa_rows(timer: Timer) -> dict:
    """B3 by group size: at each of ``QUANT_GQA`` (G = 1, 3, 4, 8, 12 and
    16 over 544 keys, glm4-9b's heads over 4160 and 8192; B = 8, f32 q),
    over int8 pools quantized from ``_gqa_decode_case``'s f32 pools, the
    entry ``quant_decode_entry`` picks against the plain version (1e-5),
    launched once, twice the same bits, a row with no keys 0; timed beside
    decode_body.cuh's entry (``other_ms``), f32 K1 over the f32 pools it
    was quantized from (``f32_k1_ms``: the same keys, four times the
    bytes), SDPA over the dequantized cache and the bound."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.models.attention import dequantize_kv
    f32, B, rows = torch.float32, 8, {}
    other = "paged_decode_attention_quant_f32"
    for geo, heads, n_keys in QUANT_GQA:
        H, KV, hd = heads["H"], heads["KV"], heads["hd"]
        G = H // KV
        f32_args, *_ = _gqa_decode_case(dops, True, heads, B, n_keys, f32,
                                        seed=n_keys + G + hd + 1)
        q, kp, vp, pt, lengths = f32_args
        kq, vq, ks, vs = _quant_pools(kp, vp)
        args = (q, kq, vq, ks, vs, pt, lengths)
        entry = dops.quant_decode_entry(G, hd)
        tag = (f"[kernels] paged_decode_attention_quant (B3) {geo} heads "
               f"{H}/{KV} (G = {G}) hd {hd} B={B} over {n_keys} keys, f32 "
               f"q over int8 [{entry}]")
        e0 = dict(dops.QUANT_KERNEL.entry_launches)
        got = dops.paged_decode_attention_quant(*args)
        torch.cuda.synchronize()
        e1 = dops.QUANT_KERNEL.entry_launches
        check({e: e1[e] - e0[e] for e in e1} == {e: int(e == entry)
                                                 for e in e1},
              f"{tag}: launched {e1}, not one {entry}")
        again = dops.paged_decode_attention_quant(*args)
        want = dops.paged_decode_attention_quant_plain(*args)
        empty = lengths.clone()
        empty[0] = 0
        zero = dops.paged_decode_attention_quant(*args[:-1], empty)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.isfinite(got).all().item() and err <= TOL[f32],
              f"{tag}: max_abs_err {err} > {TOL[f32]}")
        check(torch.equal(got, again), f"{tag}: two launches differ")
        check(not zero[0].any().item() and torch.equal(zero[1:], got[1:]),
              f"{tag}: a row with no keys is not 0")
        row = _time_row(timer, dops.paged_decode_attention_quant,
                        dops.paged_decode_attention_quant_plain, args,
                        _attn_library_call(q, dequantize_kv(kq, ks),
                                           dequantize_kv(vq, vs), pt,
                                           lengths, 1, True, heads),
                        _decode_bound(q, torch.int8, KV, n_keys, True))
        log(f"{tag}: max_abs_err={err:.3e} (tol {TOL[f32]}); bitwise "
            f"repeatable; empty row 0;" + _fmt(row))
        run = _quant_entry_run(dops, other, args)
        got_o = run()
        torch.cuda.synchronize()
        err_o = (got_o - want).abs().max().item()
        check(err_o <= TOL[f32], f"{tag}: {other} error {err_o}")
        row.update(entry=entry, max_abs_err=err, other_entry=other,
                   other_ms=timer.ms(run), other_err=err_o,
                   f32_k1_ms=timer.ms(
                       lambda: dops.paged_decode_attention(*f32_args)))
        log(f"{tag}: {other} {row['other_ms']:.4f} ms (error {err_o:.3e}), "
            f"f32 K1 over the f32 pools {row['f32_k1_ms']:.4f} ms: {entry} "
            f"takes {row['ms'] / row['other_ms']:.2f}x and "
            f"{row['ms'] / row['f32_k1_ms']:.2f}x their times, "
            f"{row['ms'] / row['library_ms']:.2f}x SDPA's; "
            f"{100 * row['bound_ms'] / row['ms']:.1f}% of the bound")
        rows[f"{geo} G={G} hd={hd} B={B} keys={n_keys} int8"] = row
        del args, f32_args, got, again, want, zero, kq, vq, kp, vp
    return rows


def _quant_pools(k, v):
    """int8 pools and their f32 per-row scales from f32 pools, by the
    port's quantizer (the reference's arithmetic)."""
    from repro_torch.models.attention import quantize_kv
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return kq, vq, ks, vs


def _quant_bound_ms(q, lengths, T, decode, heads):
    """Least time for the int8 kernels' work: q (f32) read and out (f32)
    written once; per visible row one int8 K and V row of KV x hd and
    their 2 x KV f32 scales, the page-table entries and lengths; the QK
    and PV operations (multiply and add) at the f32 peak: the reference
    dequantizes to f32 and computes in f32."""
    B, H, hd, KV = q.shape[0], heads["H"], heads["hd"], heads["KV"]
    vis = _visible_keys(lengths, T, decode)
    keys = vis.max(dim=1).values
    kv_bytes = int(keys.sum()) * KV * (2 * hd + 2 * 4)
    pages = int(((keys + BS - 1) // BS).sum()) * 4
    return _bound(kv_bytes + pages + 2 * q.numel() * 4 + B * 4,
                  4 * H * hd * int(vis.sum()), torch.float32)


def phase_quant_kernels(timer: Timer):
    """B3 (T = 1) and K2q (T = 32) at smollm heads over int8 pools made
    from _attn_case's f32 pools, f32 q; the library call is SDPA over the
    cache dequantized and gathered beforehand."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.attention import dequantize_kv
    served = {}
    specs = [("paged_decode_attention_quant",
              dops.paged_decode_attention_quant,
              dops.paged_decode_attention_quant_plain, 1, True,
              dops.QUANT_KERNEL),
             ("paged_prefill_attention_quant",
              fops.paged_prefill_attention_quant,
              fops.paged_prefill_attention_quant_plain, 32, False,
              fops.QUANT_KERNEL)]
    f32 = torch.float32
    heads = SMOLLM_HEADS
    for name, kern, plain, T, decode, handle in specs:
        for B in (4, 8):
            q, k, v, pt, lengths = _attn_case(B * 7 + T + 1, B, T, f32, f32,
                                              heads)
            if decode:
                q = q[:, 0].contiguous()
            kq, vq, ks, vs = _quant_pools(k, v)
            args = (q, kq, vq, ks, vs, pt, lengths)
            n0 = handle.launches
            entry = dops.quant_decode_entry(
                heads["H"] // heads["KV"], heads["hd"]) if decode \
                else fops.quant_prefill_entry(heads["hd"])
            e0 = handle.entry_launches.get(entry, 0)
            out = kern(*args)
            torch.cuda.synchronize()
            check(handle.launches == n0 + 1, f"{name} did not launch")
            check(handle.entry_launches[entry] == e0 + 1,
                  f"{name} did not launch {entry}")
            want = plain(*args)
            check(out.dtype == f32 and torch.isfinite(out).all().item(),
                  f"{name}: non-finite or non-f32 output")
            err = (out - want).abs().max().item()
            tol = TOL[f32]
            tag = (f"{name} smollm heads 15/5 hd 64 B={B} T={T} q=float32 "
                   f"kv=int8 (+f32 row scales) [{entry}]")
            check(err <= tol, f"{tag}: max_abs_err {err} > {tol}")
            row = _time_row(
                timer, kern, plain, args,
                _attn_library_call(q, dequantize_kv(kq, ks),
                                   dequantize_kv(vq, vs), pt, lengths, T,
                                   decode, heads),
                _quant_bound_ms(q, lengths, T, decode, heads))
            log(f"[kernels] {tag}: max_abs_err={err:.3e} (tol {tol})"
                + _fmt(row))
            if decode:       # decode_body.cuh's entry on the same operands
                _earlier(timer, row, _quant_entry_run(
                    dops, "paged_decode_attention_quant_f32", args), want,
                    tol, f"[kernels] {tag}")
            if B == 8:
                served[name] = dict(max_abs_err=err, entry=entry, **row)
    log("[kernels] int8 attention tolerance: 1e-5 (f32 outputs; the "
        "kernels dequantize each row with one f32 product, as the plain "
        "version does, and sum in another order)")
    return served


def _split_pages(entry: str, hd: int, kv_dtype) -> int:
    """Pages of BS keys a row takes for ``entry``'s plan to split it: P
    for decode_body.cuh's entries, three of the tensor-core body's splits
    (``MMA_SPLIT_BYTES`` of K/V of ``kv_dtype`` each) for its own."""
    from repro_torch.kernels.decode_attention import ops as dops
    if not entry.endswith(("_mma", "_tf32")):
        return P
    return -(-3 * dops.MMA_SPLIT_BYTES[kv_dtype] //
             (BS * dops.key_bytes(kv_dtype, hd)))


def phase_splits() -> None:
    """The split decode bodies at their split boundaries and the split-TF32
    prefill body at its edges, each against its plain version: K1 (the
    entry the dispatch picks) and B3 (both bodies: the tensor-core entry
    the dispatch picks here, and decode_body.cuh's, launched directly),
    each at the boundaries of its own split plan,
    with rows of 0, 1, one split's keys, one more and the whole page table
    in one batch (a row with no keys outputs 0; the tensor-core entries'
    page tables hold three of their splits, ``_split_pages``), B4 at
    n_valid 1, one split, one more and the whole cache (a cache of three
    splits of the tensor-core body's; its MLA entry at B = 2, 128 heads,
    too); every entry runs more than one split there;
    two launches of each decode entry must give the same bits.  f32 K2 and K2q with a slot that has nothing
    cached, a chunk straddling a page and T = 5 and 17; f32 B2 with 16-
    and 128-token windows and S = 77."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    f32, bf16 = torch.float32, torch.bfloat16
    B = 8
    sms = dops.sm_count(torch.device("cuda"))
    for geo, heads in (("smollm", SMOLLM_HEADS), ("jamba", JAMBA_HEADS)):
        KV, G, hd = heads["KV"], heads["H"] // heads["KV"], heads["hd"]
        cases = [(qdt, kvdt, dops.decode_entry("paged_decode_attention",
                                               qdt, kvdt, G, hd))
                 for qdt, kvdt in ((f32, f32), (f32, bf16), (bf16, bf16))]
        cases += [("q8", f32, dops.quant_decode_entry(G, hd)),
                  ("q8", f32, "paged_decode_attention_quant_f32")]
        for qdt, kvdt, entry in cases:
            # the boundaries of the split plan this entry runs with
            plan_dt = torch.int8 if qdt == "q8" else kvdt
            pages = _split_pages(entry, hd, plan_dt)
            n_split, split_keys = dops.entry_split_plan(
                entry, pages * BS, B * KV, plan_dt, hd, sms)
            check(n_split > 1, f"[splits] {entry} {geo} over {pages} pages: "
                  f"one split")
            edge = torch.tensor([0, 1, split_keys, split_keys + 1,
                                 pages * BS, 7, 300, 555], dtype=torch.int32,
                                device="cuda")
            q, k, v, pt, _ = _attn_case(17 + KV, B, 1, f32 if qdt == "q8"
                                        else qdt, kvdt, heads, pages)
            q = q[:, 0].contiguous()
            handle = dops.QUANT_KERNEL if qdt == "q8" else dops.KERNEL
            e0 = handle.entry_launches[entry]
            if qdt == "q8":
                plain = dops.paged_decode_attention_quant_plain
                kq, vq, ks, vs = _quant_pools(k, v)
                args, tol, what = (q, kq, vq, ks, vs, pt, edge), TOL[f32], \
                    "paged_decode_attention_quant (B3) f32/int8"
                kern = dops.paged_decode_attention_quant \
                    if entry == dops.quant_decode_entry(G, hd) else \
                    lambda *a: _quant_entry_run(dops, entry, a)()
            else:
                kern, plain = (dops.paged_decode_attention,
                               dops.paged_decode_attention_plain)
                args, tol, what = (q, k, v, pt, edge), TOL[kvdt], \
                    f"paged_decode_attention (K1) {str(qdt)[6:]}/{str(kvdt)[6:]}"
            out, again = kern(*args), kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            check(handle.entry_launches[entry] == e0 + 2,
                  f"{what}: {entry} did not launch")
            check(torch.equal(out, again), f"{what}: two launches differ")
            check(not out[0].any().item(), f"{what}: a row with no keys "
                  "is not 0")
            err = (out[1:].float() - want[1:].float()).abs().max().item()
            check(err <= tol, f"{what} {geo} split boundaries: max_abs_err "
                  f"{err} > {tol}")
            log(f"[splits] {what} {geo} B={B} lengths {edge.tolist()} "
                f"({n_split} splits of {split_keys}, [{entry}]): "
                f"max_abs_err={err:.3e} (tol {tol}); bitwise repeatable; "
                f"empty row 0")
        for dtype in (f32, bf16):
            # a cache the entry's plan splits: the tensor-core body's
            # splits move ~MMA_SPLIT_BYTES of K/V, so three of them
            entry = dops.decode_entry("decode_attention", dtype, dtype, G,
                                      hd)
            C = 3 * dops.MMA_SPLIT_BYTES[dtype] // (2 * hd * dtype.itemsize) \
                if entry.endswith(("_mma", "_tf32")) else 584
            n_split, split_keys = dops.entry_split_plan(entry, C, B * KV,
                                                        dtype, hd, sms)
            check(n_split > 1, f"[splits] {entry} at C = {C}: one split")
            tol = TOL[f32] if dtype == f32 \
                else DENSE_BF16_TOL["decode_attention"]
            errs = []
            for n_valid in (1, split_keys, split_keys + 1, C):
                q, k, v = _dense_qkv(n_valid + 3, B, 1, C, heads, dtype)
                q = q[:, 0].contiguous()
                out = dops.decode_attention(q, k, v, n_valid)
                again = dops.decode_attention(q, k, v, n_valid)
                want = dops.decode_attention_plain(q, k, v, n_valid)
                torch.cuda.synchronize()
                check(torch.equal(out, again),
                      f"decode_attention n_valid {n_valid}: launches differ")
                errs.append((out.float() - want.float()).abs().max().item())
                check(errs[-1] <= tol, f"decode_attention (B4) {geo} "
                      f"n_valid {n_valid}: max_abs_err {errs[-1]} > {tol}")
            log(f"[splits] decode_attention (B4) {geo} {str(dtype)[6:]} "
                f"n_valid 1/{split_keys}/{split_keys + 1}/{C} ({n_split} "
                f"splits of {split_keys} at C, [{entry}]): max_abs_err "
                f"{max(errs):.3e} (tol {tol}); bitwise repeatable")
    # B4's MLA entry where its 128 heads leave splits (B = 2: 256 pairs):
    # partials V-wide (128) beside a 192-wide q, the rope key in place
    B, H, C = 2, MLA_HEADS["H"], 640
    n_split, split_keys = dops.split_plan(C, B * H)
    g = torch.Generator(device="cpu").manual_seed(21)
    errs, tols = [], []
    for n_valid in (1, split_keys, split_keys + 1, C):
        q, kn, kr, v = (torch.randn(shape, generator=g).to("cuda", bf16)
                        for shape in ((B, H, 192), (B, C, H, 128), (B, C, 64),
                                      (B, C, H, 128)))
        out = dops.mla_decode_attention(q, kn, kr, v, n_valid)
        again = dops.mla_decode_attention(q, kn, kr, v, n_valid)
        want = dops.mla_decode_attention_plain(q, kn, kr, v, n_valid)
        torch.cuda.synchronize()
        check(torch.equal(out, again),
              f"mla_decode_attention n_valid {n_valid}: launches differ")
        errs.append((out.float() - want.float()).abs().max().item())
        tols.append(max(DENSE_BF16_TOL["decode_attention"],
                        2 * _bf16_ulp(want)))
        check(errs[-1] <= tols[-1], f"decode_attention (B4, MLA) n_valid "
              f"{n_valid}: max_abs_err {errs[-1]} > {tols[-1]}")
    log(f"[splits] decode_attention (B4, MLA entry) B={B} heads {H} "
        f"n_valid 1/{split_keys}/{split_keys + 1}/{C} ({n_split} splits of "
        f"{split_keys} at C): max_abs_err {max(errs):.3e} (tol "
        f"{min(tols):.3e} and up); bitwise repeatable")
    # the split-TF32 prefill body at its edges
    for geo, heads in (("smollm", SMOLLM_HEADS), ("jamba", JAMBA_HEADS)):
        for T in (5, 17):
            for kvdt in (f32, bf16, "int8"):
                q, k, v, pt, lengths = _attn_case(
                    T + heads["hd"], 4, T, f32, f32 if kvdt == "int8"
                    else kvdt, heads)
                lengths[0], lengths[1] = 0, 2 * BS - 3
                if kvdt == "int8":
                    kq, vq, ks, vs = _quant_pools(k, v)
                    args = (q, kq, vq, ks, vs, pt, lengths)
                    kern, plain, handle, entry = (
                        fops.paged_prefill_attention_quant,
                        fops.paged_prefill_attention_quant_plain,
                        fops.QUANT_KERNEL,
                        fops.quant_prefill_entry(heads["hd"]))
                else:
                    args = (q, k, v, pt, lengths)
                    kern, plain, handle, entry = (
                        fops.paged_prefill_attention,
                        fops.paged_prefill_attention_plain, fops.KERNEL,
                        fops.paged_prefill_entry(f32, kvdt, heads["hd"]))
                e0 = handle.entry_launches[entry]
                out = kern(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                check(entry.endswith("_tf32")
                      and handle.entry_launches[entry] == e0 + 1,
                      f"{entry} did not launch")
                err = (out.float() - want.float()).abs().max().item()
                tol = TOL[bf16 if kvdt == bf16 else f32]
                check(err <= tol, f"[{entry}] {geo} T={T}: max_abs_err "
                      f"{err} > {tol}")
                log(f"[splits] {entry} {geo} B=4 T={T} lengths "
                    f"{lengths.tolist()}: max_abs_err={err:.3e} (tol {tol})")
        for window in (16, 128):
            q, k, v = _dense_qkv(77 + window, 2, 77, 77, heads, f32)
            e0 = fops.FLASH_KERNEL.entry_launches["flash_attention_f32_tf32"]
            out = fops.flash_attention(q, k, v, causal=True,
                                       sliding_window=window)
            want = fops.flash_attention_plain(q, k, v, causal=True,
                                              sliding_window=window)
            torch.cuda.synchronize()
            check(fops.FLASH_KERNEL.entry_launches["flash_attention_f32_tf32"]
                  == e0 + 1, "flash_attention_f32_tf32 did not launch")
            err = (out - want).abs().max().item()
            check(err <= TOL[f32], f"flash_attention_f32_tf32 {geo} window "
                  f"{window}: max_abs_err {err}")
            log(f"[splits] flash_attention_f32_tf32 {geo} B=2 S=T=77 window "
                f"{window}: max_abs_err={err:.3e} (tol {TOL[f32]})")


def phase_transform(timer: Timer):
    """B7 at e4's pre-processing shape, (64, 224, 224, 3) uint8: the e4
    chain to f32 (scale 1/255, bias -0.5, clip +-0.5) and a uint8 ->
    uint8 affine that saturates; bit-exact against the plain version."""
    from repro_torch.kernels.transform import ops as tops
    g = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randint(0, 256, (64, 224, 224, 3), generator=g,
                      dtype=torch.uint8).to("cuda")
    served = None
    for tag, kw in (
            ("uint8 -> float32, e4 chain (scale 1/255, bias -0.5, "
             "clip +-0.5)",
             dict(scale=1 / 255.0, bias=-0.5, lo=-0.5, hi=0.5,
                  out_dtype=torch.float32)),
            ("uint8 -> uint8 (scale 1.5, bias -20, saturating)",
             dict(scale=1.5, bias=-20.0, out_dtype=torch.uint8))):
        n0 = tops.KERNEL.launches
        out = tops.fused_transform(x, **kw)
        torch.cuda.synchronize()
        check(tops.KERNEL.launches == n0 + 1, "fused_transform did not launch")
        want = tops.fused_transform_plain(x, **kw)
        check(out.dtype == want.dtype and torch.equal(out, want),
              f"fused_transform {tag}: kernel and plain version differ")
        err = (out.float() - want.float()).abs().max().item()
        n = x.numel()
        row = _time_row(timer, lambda a: tops.fused_transform(a, **kw),
                        lambda a: tops.fused_transform_plain(a, **kw), (x,),
                        None, _bound(n * (1 + out.element_size()), 4 * n,
                                     torch.float32))
        log(f"[kernels] fused_transform (64, 224, 224, 3) {tag}: exact"
            + _fmt(row))
        if served is None:
            served = dict(max_abs_err=err, **row)
    log("[kernels] fused_transform tolerance: exact; no single PyTorch "
        "call computes it (library_ms null)")
    return served


# -- phase 4 --------------------------------------------------------------------

def phase_engine(kernels) -> None:
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    smollm2 = get_config("smollm-360m").replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    jamba = get_config("jamba-v0.1-52b", smoke=True)
    scan_gate = ("selective_scan", "gating_topk")
    cases = [
        ("paged 2-layer f32 smollm heads", smollm2, True, None,
         PAGED_KERNELS),
        ("paged 2-layer f32 smollm heads, int8 KV", smollm2, True, "int8",
         QUANT_KERNELS),
        ("paged jamba-v0.1 smoke (8 layers, 4 experts, f32)", jamba, True,
         None, PAGED_KERNELS + scan_gate),
        ("dense 2-layer f32 smollm heads", smollm2, False, None,
         DENSE_KERNELS),
        ("dense 2-layer f32 smollm heads, 48-token window (ring wraps)",
         smollm2.replace(sliding_window=48), False, None, DENSE_KERNELS),
        ("dense jamba-v0.1 smoke (8 layers, 4 experts, f32)", jamba, False,
         None, DENSE_KERNELS + scan_gate)]
    for tag, cfg, paged, kv_dtype, path in cases:
        kw = dict(batch_size=4, capacity=128, max_new_tokens=8, burst=4,
                  paged=paged, kv_dtype=kv_dtype)
        if paged:
            kw.update(prefill_chunk=32, block_size=16)
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (37, 5, 70, 18, 33, 50)]
        cpu_model = build_model(cfg, device="cpu")
        cpu_params = cpu_model.init(seed=0)
        want = ServeEngine(cpu_model, cpu_params, device="cpu",
                           **kw).serve(prompts)
        gpu_model = build_model(cfg, device="cuda")
        gpu_params = bridge.to_torch(cpu_params, "cuda")
        reset(kernels)
        eng = ServeEngine(gpu_model, gpu_params, device="cuda", **kw)
        got = eng.serve(prompts)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        check(eng.n_step_failures == 0,
              f"{tag}: {eng.n_step_failures} failed steps")
        for a, b in zip(want, got):
            check(b.status == "ok", f"{tag} request {b.request_id}: {b.status}")
            check(np.array_equal(a.tokens, b.tokens),
                  f"{tag} request {a.request_id}: cpu {a.tokens} != "
                  f"cuda {b.tokens}")
        check(all(launches[n] > 0 for n in path),
              f"{tag}: engine run missed a kernel: {launches}")
        other = [n for n in ATTN_KERNELS if n not in path]
        check(all(launches[n] == 0 for n in other),
              f"{tag}: another path's attention kernels launched: "
              f"{launches}")
        if "selective_scan" in path:
            # the paged step and the dense decode run the slab entry; the
            # dense prefill wave the plain entry's cold start
            scan = next(k for k in kernels if k.name == "selective_scan")
            e = scan.entry_launches
            check(e["selective_scan_slab_f32"] > 0
                  and (e["selective_scan_f32"] > 0) != paged,
                  f"{tag}: selective_scan entries {e}")
            log(f"[engine] {tag}: selective_scan launches by entry "
                f"{ {n: c for n, c in e.items() if c} }")
        log(f"[engine] {tag}: {len(prompts)} requests, greedy tokens on "
            f"cuda == cpu ({sum(len(r.tokens) for r in got)} tokens); "
            f"launches {launches}")


# -- phase 5 --------------------------------------------------------------------

def phase_main_path(kernels):
    from repro_torch.launch import serve
    argv = ["--arch", "smollm-360m", "--kv-dtype", "bf16", "--requests", "16",
            "--batch", "8", "--prompt-len", "512", "--max-new", "64",
            "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    out = serve.main(argv)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    eng = out["engine"]
    check(out["n_results"] == 16 and out["total_tokens"] == 16 * 64,
          f"served {out['n_results']} requests / {out['total_tokens']} tokens")
    # (a short micro-batch is padded to its power-of-2 bucket with zero
    # rows, which the engine serves too)
    check(eng.n_evictions >= 16, f"{eng.n_evictions} requests finished")
    check(all(launches[n] > 0 for n in PAGED_KERNELS),
          f"main path missed a kernel: {launches}")
    check(all(launches[n] == 0 for n in DENSE_KERNELS + QUANT_KERNELS),
          f"the paged bf16 path launched another path's kernel: {launches}")
    check_served_by(kernels, "paged_prefill_attention",
                    "paged_prefill_attention_bf16_bf16_mma", "main")
    check_served_by(kernels, "paged_decode_attention",
                    "paged_decode_attention_bf16_bf16_mma", "main")
    decoded = eng.n_device_steps
    log(f"[main] smollm-360m full width (32 layers, d 960, 15/5 heads, "
        f"vocab 49152, bf16): {out['total_tokens'] / out['wall_s']:.1f} tok/s "
        f"({out['total_tokens']} tokens in {out['wall_s']:.2f}s, pipeline)")
    per_tok = {n: round(c / out["total_tokens"], 3) for n, c in launches.items()}
    log(f"[main] launches {launches} ({per_tok} per served token) over "
        f"{decoded} device steps "
        f"({eng.n_prefill_chunks} mixed, {decoded - eng.n_prefill_chunks} "
        f"decode) x 32 layers; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, eng, out["total_tokens"] / out["wall_s"]


def phase_trace(eng, tag: str, n: int = 8, prompt_len: int = 512):
    """Where the device time goes: the engine serves ``n`` more requests
    (``prompt_len``-token prompts, its max_new_tokens each, direct) under
    a CUDA-only profiler trace; device busy share = summed kernel time
    over the wall time of the serve (one stream: kernels do not
    overlap).  Returns ``_report_trace``'s triple."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, eng.model.cfg.vocab_size,
                            prompt_len).astype(np.int32) for _ in range(n)]
    steps0, waves0 = eng.n_device_steps, eng.n_prefills
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = eng.serve(prompts, timeout_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(all(r.status == "ok" and len(r.tokens) == eng.max_new_tokens
              for r in res), f"[{tag}] traced serve failed")
    steps = eng.n_device_steps - steps0
    waves = "" if eng.paged else \
        f" + {eng.n_prefills - waves0} prefill waves"
    return _report_trace(prof, wall, steps, tag,
                         f"{n} x {prompt_len}-token prompts, "
                         f"{eng.max_new_tokens} new tokens, direct", waves)


def _report_trace(prof, wall: float, steps: int, tag: str, what: str,
                  waves: str = ""):
    """Log a CUDA trace of ``steps`` device steps over ``wall`` seconds:
    busy share, the kernels that take the device time, the operand
    copies, the hand-written kernels, device-to-host copies and device
    operations per step.  Returns (device-to-host copies per step,
    {device operation: calls per step}, {device operation: (device ms,
    calls)})."""
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    check(busy_us > 0, "the profiler recorded no device time")
    log(f"[{tag}] trace: {what}: wall "
        f"{wall * 1e3:.1f} ms over {steps} device steps{waves} "
        f"({wall * 1e3 / steps:.2f} ms/step), device busy "
        f"{busy_us / 1e3:.1f} ms = {busy_us / 1e4 / wall:.1f}% "
        f"(idle {100 - busy_us / 1e4 / wall:.1f}%)")
    for key, us, cnt in rows[:10]:
        log(f"[{tag}]   {us / 1e3:9.2f} ms {cnt:7d} calls  {key[:90]}")
    # the copies that build operands around the kernels, each
    # concatenation kernel (template) on its own
    for what, pat in (("concatenations", "CatArrayBatchedCopy"),
                      ("elementwise copies", "direct_copy_kernel"),
                      ("fills", "FillFunctor")):
        sel = [(key, us, cnt) for key, us, cnt in rows if pat in key]
        log(f"[{tag}] {what} ({pat}): "
            f"{sum(us for _, us, _ in sel) / 1e3:.2f} ms over "
            f"{sum(cnt for *_, cnt in sel)} calls")
        if what == "concatenations":
            for key, us, cnt in sel:
                log(f"[{tag}]   {us / 1e3:9.2f} ms {cnt:7d} calls  "
                    f"{key[key.index(pat):][:140]}")
    # the hand-written kernels, wherever they rank
    for key, us, cnt in rows:
        if any(n in key for n in ("kern::", "selective_scan_kernel",
                                  "gating_topk_kernel")):
            log(f"[{tag}]   kernel {us / 1e3:9.2f} ms {cnt:7d} calls  "
                f"{key[:90]}")
    d2h = sum(cnt for key, _, cnt in rows if "DtoH" in key)
    log(f"[{tag}] device-to-host copies (host syncs): {d2h} = "
        f"{d2h / steps:.2f} per device step")
    ops = {key: cnt for key, _, cnt in rows if not RUNTIME_CALL.match(key)}
    n_ops = sum(ops.values())
    log(f"[{tag}] device operations (kernels, copies, fills): {n_ops} = "
        f"{n_ops / steps:.1f} per device step")
    return (d2h / steps, {key: cnt / steps for key, cnt in ops.items()},
            {key: (us / 1e3, cnt) for key, us, cnt in rows})


# -- phase 6 --------------------------------------------------------------------

JAMBA_PLEN, JAMBA_NEW = 512, 32


def jamba_engine(pkg: str = "repro_torch", params=None):
    """Phase 6's model and engine: jamba-v0.1 at full width, one period
    of its layer pattern, batch 8, prefill chunk 32, burst 8, one state
    slab per slot, from the port package importable as ``pkg``
    (kernel_ab.py builds another checkout's the same way).  ``params``:
    random bf16 weights made on the card from seed 0 when not given.
    Returns (engine, params)."""
    configs, models, serving = (importlib.import_module(f"{pkg}.{m}")
                                for m in ("configs", "models", "serving"))
    cfg = configs.get_config("jamba-v0.1-52b").replace(n_layers=8)
    model = models.build_model(cfg, device="cuda")
    if params is None:
        params = model.init(seed=0)
    eng = serving.ServeEngine(
        model, params, batch_size=8, capacity=JAMBA_PLEN + JAMBA_NEW,
        max_new_tokens=JAMBA_NEW, prefill_chunk=32, block_size=16, burst=8,
        kv_dtype="bf16", num_state_slots=8, device="cuda")
    return eng, params


def jamba_prompts(vocab_size: int):
    """Phase 6's 16 requests of ``JAMBA_PLEN`` prompt tokens."""
    rng = np.random.default_rng(6)
    return [rng.integers(0, vocab_size, JAMBA_PLEN).astype(np.int32)
            for _ in range(16)]


def phase_jamba(kernels):
    """jamba-v0.1 at full width, one period of its layer pattern (the
    whole 32-layer model, ~104 GB in bf16, does not fit one 80 GB card):
    16 requests of 512 prompt tokens, 32 new tokens each, batch 8,
    prefill chunk 32, burst 8, one state slab per slot."""
    t0 = time.perf_counter()
    eng, params = jamba_engine()
    torch.cuda.synchronize()
    model, max_new = eng.model, JAMBA_NEW
    cfg = model.cfg
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[jamba] {cfg.arch_id} one period: 8 layers "
        f"{[d for d in model.period_descs]}, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.moe.n_experts} experts "
        f"top-{cfg.moe.top_k}, d_expert {cfg.moe.d_expert}, vocab "
        f"{cfg.vocab_size}, bf16: {n_params / 1e9:.2f}B parameters made on "
        f"the card with the engine in {time.perf_counter() - t0:.1f}s")
    prompts = jamba_prompts(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    res = eng.serve(prompts, timeout_s=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    check(all(r.status == "ok" and len(r.tokens) == max_new for r in res),
          f"jamba: {[(r.status, len(r.tokens)) for r in res]}")
    check(all(int(r.tokens.min()) >= 0 and int(r.tokens.max()) < cfg.vocab_size
              for r in res), "jamba: token outside the vocab")
    check(all(launches[n] > 0 for n in PAGED_KERNELS
              + ("selective_scan", "gating_topk")),
          f"jamba path missed a kernel: {launches}")
    check(all(launches[n] == 0 for n in DENSE_KERNELS),
          f"the paged path launched a dense kernel: {launches}")
    check_served_by(kernels, "paged_prefill_attention",
                    "paged_prefill_attention_bf16_bf16_mma", "jamba")
    check_served_by(kernels, "selective_scan", "selective_scan_slab_bf16",
                    "jamba")
    total = sum(len(r.tokens) for r in res)
    steps, mixed = eng.n_device_steps, eng.n_prefill_chunks
    per_tok = {n: round(c / total, 3) for n, c in launches.items()}
    log(f"[jamba] served {len(res)}/16 requests ok, {total} tokens in "
        f"{wall:.2f}s = {total / wall:.1f} tok/s (direct); {steps} device "
        f"steps ({mixed} mixed, {steps - mixed} decode), "
        f"{wall * 1e3 / steps:.1f} ms/step")
    log(f"[jamba] launches {launches} ({per_tok} per served token); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; slabs "
        f"{eng.pool_stats()['num_state_slots']}")
    return launches, eng


# -- phase 7 --------------------------------------------------------------------

def phase_dense(kernels):
    """smollm-360m at full width and depth on the dense engine, through
    the stream pipeline: bf16 cache, batch 8, 16 requests of up to 512
    prompt tokens (left-padded by the pipeline to the longest), 64 new
    tokens, burst 8; the launcher sizes the cache at prompt-len + max-new
    + 8 = 584 positions."""
    from repro_torch.launch import serve
    argv = ["--arch", "smollm-360m", "--kv-dtype", "bf16", "--paged", "off",
            "--requests", "16", "--batch", "8", "--prompt-len", "512",
            "--max-new", "64", "--burst", "8",
            "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    out = serve.main(argv)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    eng = out["engine"]
    check(not eng.paged and eng.capacity == 512 + 64 + 8,
          f"the dense phase ran paged={eng.paged}, capacity {eng.capacity}")
    check(out["n_results"] == 16 and out["total_tokens"] == 16 * 64,
          f"served {out['n_results']} requests / {out['total_tokens']} tokens")
    check(all(launches[n] > 0 for n in DENSE_KERNELS),
          f"dense path missed a kernel: {launches}")
    check(all(launches[n] == 0 for n in PAGED_KERNELS),
          f"the dense path launched a paged kernel: {launches}")
    check_served_by(kernels, "flash_attention", "flash_attention_bf16_mma",
                    "dense")
    check(eng.n_step_failures == 0 and eng.n_restarts == 0,
          f"dense: {eng.n_step_failures} failed steps, {eng.n_restarts} "
          "restarts")
    ls = eng.loop_stats()
    cache_mb = sum(a.numel() * a.element_size()
                   for a in _leaves(eng._cache)) / 1e6
    log(f"[dense] smollm-360m full width (32 layers, d 960, 15/5 heads, "
        f"vocab 49152, bf16), dense engine: "
        f"{out['total_tokens'] / out['wall_s']:.1f} tok/s "
        f"({out['total_tokens']} tokens in {out['wall_s']:.2f}s, pipeline)")
    per_tok = {n: round(c / out["total_tokens"], 3) for n, c in launches.items()}
    log(f"[dense] {ls['n_device_steps']} device steps, {eng.n_prefills} "
        f"prefill waves, {eng.n_joins} joins, {ls['n_bursts']} bursts, "
        f"{ls['n_host_syncs']} host syncs (token drains) + "
        f"{ls['n_flag_reads']} blocking reads of the active flags, "
        f"{ls['n_state_uploads']} state uploads; dense cache "
        f"{eng.capacity} positions, {cache_mb:.1f} MB; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[dense] launches {launches} ({per_tok} per served token)")
    return launches, eng


# -- phase 8 --------------------------------------------------------------------

def phase_int8(kernels):
    """smollm-360m at full width and depth with f32 weights (a bf16 model
    cannot serve over an int8 pool, in the reference either) serving
    phase 5's requests through the pipeline over an int8 pool, then over
    an f32 pool for the token agreement and the bytes per block."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("smollm-360m").replace(param_dtype="float32",
                                            compute_dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    requests = serve.make_requests(cfg.vocab_size, 16, 512)
    kw = dict(batch_size=8, capacity=512 + 64 + 8, max_new_tokens=64,
              prefill_chunk=32, block_size=16, burst=8, device="cuda")
    tokens, engines = {}, {}
    for kv_dtype in ("int8", "f32"):
        eng = ServeEngine(model, params, kv_dtype=kv_dtype, **kw)
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        t0 = time.perf_counter()
        out = serve.serve_pipeline(eng, requests, batch=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        total = sum(np.asarray(b.data).size for b in out)
        check(len(out) == 16 and total == 16 * 64,
              f"int8 phase ({kv_dtype}): {len(out)} results, {total} tokens")
        tokens[kv_dtype] = {b.meta["request"]: np.asarray(b.data)
                            for b in out}
        engines[kv_dtype] = eng
        path = QUANT_KERNELS if kv_dtype == "int8" else PAGED_KERNELS
        check(all(launches[n] > 0 for n in path),
              f"{kv_dtype} pool: path missed a kernel: {launches}")
        check(all(launches[n] == 0 for n in ATTN_KERNELS if n not in path),
              f"{kv_dtype} pool: another path's kernel launched: {launches}")
        if kv_dtype == "f32":
            check_served_by(kernels, "paged_prefill_attention",
                            "paged_prefill_attention_f32_f32_tf32", "int8")
        else:
            check_served_by(kernels, "paged_prefill_attention_quant",
                            "paged_prefill_attention_quant_f32_tf32", "int8")
            check_served_by(kernels, "paged_decode_attention_quant",
                            "paged_decode_attention_quant_f32_tf32", "int8")
        ls, ps = eng.loop_stats(), eng.pool_stats()
        per_tok = {n: round(c / total, 3) for n, c in launches.items()}
        log(f"[int8] smollm-360m full width (32 layers, d 960, 15/5 heads, "
            f"vocab 49152, f32 weights), {ps['kv_dtype']} pool: "
            f"{total / wall:.1f} tok/s ({total} tokens in {wall:.2f}s, "
            f"pipeline); {ls['n_device_steps']} device steps "
            f"({eng.n_prefill_chunks} mixed), {ls['n_host_syncs']} host "
            f"syncs + {ls['n_flag_reads']} flag reads; "
            f"{ps['bytes_per_block']} bytes/block, "
            f"{ps['pool_bytes'] / 1e6:.1f} MB pool; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"[int8] launches {launches} ({per_tok} per served token)")
        if kv_dtype == "int8":
            launches8 = launches
    agree = sum(int((tokens["int8"][i] == tokens["f32"][i]).sum())
                for i in range(16))
    first = sum(int(tokens["int8"][i][0] == tokens["f32"][i][0])
                for i in range(16))
    log(f"[int8] greedy tokens equal to the f32 pool's: {agree}/{16 * 64} "
        f"({100 * agree / (16 * 64):.1f}%); first tokens {first}/16 "
        f"(logged, not gated: int8 KV is a bounded drift, not identity)")
    b8 = engines["int8"].kv_bytes_per_block()
    b32 = engines["f32"].kv_bytes_per_block()
    hd = cfg.resolved_head_dim
    check(b32 * (2 * hd + 2 * 4) == b8 * (2 * hd * 4),
          f"bytes per block f32/int8 = {b32}/{b8}, not 512/136")
    log(f"[int8] bytes per block f32/int8 = {b32}/{b8} = {b32 / b8:.4f} "
        f"(= 512/136: 2 x 64 x 4 bytes against 2 x 64 + 2 x 4)")
    del engines["f32"]
    return launches8, engines["int8"]


# -- phase 9 --------------------------------------------------------------------

def phase_preproc(kernels):
    """The e4 pre-processing chain on B7 through the port's parser: one
    frame at a time, then 64 frames stacked by tensor_aggregator."""
    from repro_torch.core import parse_pipeline
    from repro_torch.core.elements.sources import VideoTestSrc
    from repro_torch.core.elements.transform import (apply_chain_numpy,
                                                     parse_chain)
    from repro_torch.kernels.transform import ops as tops
    chain = parse_chain(E4_CHAIN)
    src = VideoTestSrc("ref")
    frames = {}

    def frame(i):
        if i not in frames:
            frames[i] = src.create(i).data
        return frames[i]

    launches = 0
    for tag, n_frames, batch in (("per frame", 64, 0), ("batched", 128, 64)):
        agg = (f"tensor_aggregator frames_in={batch} stack=true ! "
               if batch else "")
        pipe = parse_pipeline(
            f"videotestsrc num_buffers={n_frames} ! tensor_converter ! {agg}"
            f"tensor_transform option={E4_CHAIN} backend=fused ! "
            "tensor_sink name=out keep=true")
        reset(kernels)
        t0 = time.perf_counter()
        pipe.start()
        try:
            check(pipe["out"].eos_seen.wait(timeout=300),
                  f"preproc {tag}: pipeline did not drain")
            pipe.check_bus()
        finally:
            pipe.stop()
        wall = time.perf_counter() - t0
        outs = [np.asarray(b.data) for b in pipe["out"].buffers]
        n_out = n_frames // batch if batch else n_frames
        check(len(outs) == n_out, f"preproc {tag}: {len(outs)} outputs")
        err = 0.0
        for j, out in enumerate(outs):
            idx = range(j * batch, (j + 1) * batch) if batch else [j]
            want = (np.stack([frame(i) for i in idx]) if batch
                    else frame(j))
            want = apply_chain_numpy(want, chain)
            check(out.shape == want.shape and out.dtype == np.float32,
                  f"preproc {tag}: {out.shape} {out.dtype}")
            err = max(err, float(np.abs(out - want).max()))
        check(err <= 1e-6, f"preproc {tag}: max_abs_err {err} > 1e-6")
        launches += tops.KERNEL.launches
        check(tops.KERNEL.launches == n_out,
              f"preproc {tag}: B7 launched {tops.KERNEL.launches} times")
        log(f"[preproc] {tag}: {n_frames} frames of 224x224x3 uint8 -> "
            f"{outs[0].shape} f32 through the parsed pipeline in "
            f"{wall:.3f}s = {n_frames / wall:.1f} frames/s; max_abs_err "
            f"vs the numpy chain {err:.3e} (tol 1e-6); B7 launches "
            f"{tops.KERNEL.launches}")
    # what one batch costs the element: upload, kernel, download
    x = np.stack([frame(i) for i in range(64)])
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xd = torch.from_numpy(x).to("cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # the spin keeps the start event behind the enqueued launch, so the
    # interval holds device time only (as Timer does)
    torch.cuda._sleep(Timer.SPIN_CYCLES)
    events[0].record()
    y = tops.fused_transform(xd, scale=1 / 255.0, bias=-0.5, lo=-0.5,
                             hi=0.5, out_dtype=torch.float32)
    events[1].record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    y.cpu().numpy()
    t3 = time.perf_counter()
    log(f"[preproc] one (64, 224, 224, 3) batch: host-to-device copy "
        f"{(t1 - t0) * 1e3:.3f} ms (9.6 MB), B7 "
        f"{events[0].elapsed_time(events[1]):.4f} ms on the device, "
        f"device-to-host copy {(t3 - t2) * 1e3:.3f} ms (38.5 MB)")
    return launches


# -- phase 10 -------------------------------------------------------------------

FRONT_PLEN, FRONT_NEW = 512, 64
FAULT_STEP_A = 6        # phase 10(a): the engine_step fault's arrival
FAULT_STEP_B = 20       # phase 10(b): 16 mixed steps of prefill, then bursts


def serve_scheduled(eng, prompts, decode_rid: int, prefill_rid: int):
    """Serve ``prompts`` on the batch lane through ``eng.step()``,
    preempting ``prefill_rid`` while it is still mid-prefill and
    ``decode_rid`` once it holds two tokens (either may be None); the
    schedule depends on the step count alone, so the card and the CPU run
    the same one.  Returns the results in request order."""
    rids = [eng.submit(p, lane="batch") for p in prompts]
    todo = {decode_rid, prefill_rid} - {None}
    for _ in range(10000):
        if not eng.has_work:
            break
        for s in list(eng._slots):
            if s is None or s.rid not in todo:
                continue
            prefilled = s.prefill_off >= len(s.prompt)
            if (s.rid == prefill_rid and not prefilled) or (
                    s.rid == decode_rid and prefilled and len(s.tokens) >= 2):
                check(eng.preempt(s.rid), f"preempt {s.rid} refused")
                todo.discard(s.rid)
        eng.step()
    check(not eng.has_work and not todo,
          f"scheduled serve: work left {eng.has_work}, not preempted {todo}")
    return eng.wait(rids, timeout_s=60)


def phase_front_door_small(kernels) -> None:
    """Phase 10(a): preemption, restore and a paged restart at phase 4's
    size, on the card against the CPU port under the same schedule."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Fault, FaultPlan, ServeEngine
    smollm2 = get_config("smollm-360m").replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    jamba = get_config("jamba-v0.1-52b", smoke=True)
    scan_gate = ("selective_scan", "gating_topk")
    cases = [("2-layer f32 smollm heads", smollm2, None, PAGED_KERNELS),
             ("2-layer f32 smollm heads, int8 KV", smollm2, "int8",
              QUANT_KERNELS),
             ("jamba-v0.1 smoke (8 layers, 4 experts, f32)", jamba, None,
              PAGED_KERNELS + scan_gate)]
    kw = dict(batch_size=4, capacity=128, max_new_tokens=8, burst=4,
              prefill_chunk=32, block_size=16)
    for tag, cfg, kv_dtype, path in cases:
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (37, 5, 70, 18, 33, 50)]
        cpu_model = build_model(cfg, device="cpu")
        cpu_params = cpu_model.init(seed=0)

        def plan():
            return FaultPlan([Fault(point="engine_step", nth=FAULT_STEP_A)])
        want = serve_scheduled(
            ServeEngine(cpu_model, cpu_params, device="cpu",
                        kv_dtype=kv_dtype, fault_plan=plan(), **kw),
            prompts, decode_rid=0, prefill_rid=2)
        gpu_model = build_model(cfg, device="cuda")
        gpu_params = bridge.to_torch(cpu_params, "cuda")
        plain = ServeEngine(gpu_model, gpu_params, device="cuda",
                            kv_dtype=kv_dtype, **kw).serve(prompts,
                                                           lane="batch")
        reset(kernels)
        eng = ServeEngine(gpu_model, gpu_params, device="cuda",
                          kv_dtype=kv_dtype, fault_plan=plan(), **kw)
        got = serve_scheduled(eng, prompts, decode_rid=0, prefill_rid=2)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        for a, b, c in zip(want, got, plain):
            check(a.status == b.status == c.status == "ok",
                  f"[front] {tag} request {b.request_id}: {a.status} "
                  f"{b.status} {c.status}")
            check(np.array_equal(a.tokens, b.tokens),
                  f"[front] {tag} request {a.request_id}: cpu {a.tokens} "
                  f"!= cuda {b.tokens} under the schedule")
            check(np.array_equal(b.tokens, c.tokens),
                  f"[front] {tag} request {b.request_id}: preempted "
                  f"{b.tokens} != plain {c.tokens}")
        check(eng.n_restarts == 1 and eng.n_preemptions >= 2
              and eng.n_restores >= 1,
              f"[front] {tag}: restarts {eng.n_restarts}, preemptions "
              f"{eng.n_preemptions}, restores {eng.n_restores}")
        ps = eng.pool_stats()
        check(ps["n_live"] == ps["n_reserved"] == 0
              and ps.get("n_state_live", 0) == 0, f"[front] {tag}: {ps}")
        check(all(launches[n] > 0 for n in path),
              f"[front] {tag}: the run missed a kernel: {launches}")
        check(all(launches[n] == 0 for n in ATTN_KERNELS if n not in path),
              f"[front] {tag}: another path's kernel launched: {launches}")
        if "selective_scan" in path:
            e = next(k for k in kernels
                     if k.name == "selective_scan").entry_launches
            check(e["selective_scan_slab_f32"] > 0
                  and e["selective_scan_f32"] == 0,
                  f"[front] {tag}: selective_scan entries {e}")
        log(f"[front] {tag}: {len(prompts)} batch-lane requests, "
            f"{eng.n_preemptions} preemptions ({eng.n_restores} restored), "
            f"{eng.n_restarts} restart; tokens on cuda == cpu under the "
            f"schedule == cuda without it; launches "
            f"{ {n: c for n, c in launches.items() if c} }")


def _percentiles(xs):
    return (f"p50 {np.percentile(xs, 50) * 1e3:.1f} ms, "
            f"p99 {np.percentile(xs, 99) * 1e3:.1f} ms")


def phase_front_door(kernels, card: str) -> None:
    """Phase 10(b): smollm-360m at full width behind the tensor-query
    server, with interactive requests preempting batch-lane slots; then
    a paged restart mid-decode on a second engine, and a full-width spill
    round trip."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import (Fault, FaultPlan, ServeEngine,
                                     TensorQueryClient, TensorQueryServer)
    cfg = get_config("smollm-360m")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    kw = dict(batch_size=8, capacity=FRONT_PLEN + FRONT_NEW + 8,
              max_new_tokens=FRONT_NEW, prefill_chunk=32, block_size=16,
              burst=8, kv_dtype="bf16", device="cuda")
    rng = np.random.default_rng(10)
    batch = [rng.integers(0, cfg.vocab_size, FRONT_PLEN).astype(np.int32)
             for _ in range(8)]
    inter = [rng.integers(0, cfg.vocab_size,
                          int(rng.integers(128, FRONT_PLEN + 1)))
             .astype(np.int32) for _ in range(8)]
    eng = ServeEngine(model, params, **kw)
    srv = TensorQueryServer(eng, port=0, max_wait_ms=5.0,
                            pad_to=FRONT_PLEN).start()
    # what earlier phases left allocated (reference cycles freed first)
    # counts in the peak too: log it beside the peak
    gc.collect()
    base = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    try:
        cli = TensorQueryClient("127.0.0.1", srv.port)
        try:
            bq = [cli.submit(p, lane="batch") for p in batch]
            deadline = time.monotonic() + 300
            while not all(cli._requests[q].stream for q in bq):
                check(time.monotonic() < deadline,
                      "[front] the batch-lane requests never streamed")
                time.sleep(0.005)
            iq = [cli.submit(p, lane="interactive") for p in inter]
            results = [cli.result(q, timeout=600) for q in bq + iq]
        finally:
            cli.close()
        wall = time.perf_counter() - t0
        drained = srv.drain(timeout=60)
    finally:
        srv.stop()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(r.status == "ok" and len(r.tokens) == FRONT_NEW
              for r in results),
          f"[front] {[(r.lane, r.status, len(r.tokens)) for r in results]}")
    check(eng.n_preemptions >= 1 and eng.n_restores == eng.n_preemptions,
          f"[front] preemptions {eng.n_preemptions}, restores "
          f"{eng.n_restores}")
    ps = eng.pool_stats()
    check(drained and ps["n_live"] == ps["n_reserved"] == 0,
          f"[front] drained {drained}, pool {ps}")
    check(all(launches[n] > 0 for n in PAGED_KERNELS),
          f"[front] the served path missed a kernel: {launches}")
    check_served_by(kernels, "paged_prefill_attention",
                    "paged_prefill_attention_bf16_bf16_mma", "front")
    total = sum(len(r.tokens) for r in results)
    ttft = {lane: [r.ttft_s for r in results if r.lane == lane]
            for lane in ("batch", "interactive")}
    log(f"[front] smollm-360m full width (32 layers, bf16, bf16 pool) "
        f"behind TensorQueryServer on 127.0.0.1: 8 batch + 8 interactive "
        f"requests, {total} tokens in {wall:.2f}s = {total / wall:.1f} "
        f"tok/s; TTFT batch {_percentiles(ttft['batch'])}, interactive "
        f"{_percentiles(ttft['interactive'])}; preemptions "
        f"{eng.n_preemptions}, restores {eng.n_restores}, restarts "
        f"{eng.n_restarts}; engine requests {eng.n_requests} (bucket "
        f"padding rows included); peak memory {peak:.2f} GiB "
        f"({base:.2f} GiB allocated when the phase began); {card}")
    log(f"[front] launches {launches}")
    # the same prompts direct, no server, no preemption
    direct = eng.serve(batch + inter, timeout_s=600)
    same = sum(int((a.tokens == b.tokens).sum())
               for a, b in zip(direct, results))
    log(f"[front] tokens equal to a direct run without the server: "
        f"{same}/{16 * FRONT_NEW} (logged, not gated: bf16 at full width "
        f"need not be batch-invariant)")
    n = eng.allocator.blocks_for(FRONT_PLEN + FRONT_NEW)
    top = eng.allocator.num_blocks
    with torch.inference_mode():
        src = torch.arange(n, device="cuda")
        dst = torch.arange(top - n, top, device="cuda")
        first = model.gather_paged_pages(eng._paged_cache, src, 0)
        model.scatter_paged_pages(eng._paged_cache, first, dst, 0)
        again = model.gather_paged_pages(eng._paged_cache, dst, 0)
        check(all(torch.equal(a, b)
                  for a, b in zip(_leaves(first), _leaves(again))),
              "[front] full-width gather -> scatter -> gather differs")
    mb = sum(a.numel() * a.element_size() for a in _leaves(first)) / 1e6
    log(f"[front] full-width spill round trip: {n} blocks x 32 layers "
        f"(K and V, {mb:.1f} MB) gathered, scattered to other blocks, "
        "gathered again: bit-exact")
    del eng, direct
    feng = ServeEngine(model, params,
                       fault_plan=FaultPlan([Fault(point="engine_step",
                                                   nth=FAULT_STEP_B)]),
                       **kw)
    t0 = time.perf_counter()
    fres = feng.serve(batch, timeout_s=600)
    wall = time.perf_counter() - t0
    check(all(r.status == "ok" and len(r.tokens) == FRONT_NEW
              for r in fres),
          f"[front] fault run {[(r.status, len(r.tokens)) for r in fres]}")
    ps = feng.pool_stats()
    check(feng.n_restarts == 1 and feng.n_step_failures == 1
          and ps["n_live"] == ps["n_reserved"] == 0,
          f"[front] fault run: restarts {feng.n_restarts}, pool {ps}")
    same = sum(int((a.tokens == b.tokens).sum())
               for a, b in zip(fres, results[:8]))
    log(f"[front] engine_step fault at step {FAULT_STEP_B} (mid-decode): "
        f"1 restart, {feng.n_preemptions} slots spilled and "
        f"{feng.n_restores} restored, 8/8 ok in {wall:.2f}s; tokens equal "
        f"to the server run's batch lane: {same}/{8 * FRONT_NEW} (logged)")


# -- phase 11 -------------------------------------------------------------------

SAMPLED = dict(temperature=0.8, top_k=16, seed=11)   # phase 11(a)


def _tally(kernels, acc) -> dict:
    """This run's launches (added to ``acc``, phase 11's total); the
    counts are reset for the next run."""
    launches = {k.name: k.launches for k in kernels}
    for n, c in launches.items():
        acc[n] = acc.get(n, 0) + c
    reset(kernels)
    return launches


def _first_layers(params, n: int):
    """The params of the stack's first ``n`` layers (periodic leaves carry
    a leading layer axis): the draft of phase 11(a) is the target cut to
    one layer, sharing its embedding, norms and head."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n].contiguous()
    return dict(params, blocks=cut(params["blocks"]))


def phase_sampling_spec_small(kernels, acc) -> None:
    """Phase 11(a): seeded sampling and speculative decoding at phase 4's
    size, the card against the CPU port."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("smollm-360m").replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    dcfg = cfg.replace(arch_id="smollm-360m-1layer", n_layers=1)
    models = {}
    for dev in ("cpu", "cuda"):
        m, d = build_model(cfg, device=dev), build_model(dcfg, device=dev)
        models[dev] = (m, d)
    params = {"cpu": models["cpu"][0].init(seed=0)}
    params["cuda"] = bridge.to_torch(params["cpu"], "cuda")
    dparams = {dev: _first_layers(p, 1) for dev, p in params.items()}
    rng = np.random.default_rng(11)
    # equal lengths and one per slot: the dense engine prefills one
    # un-padded wave, so both modes decode at the same positions
    wave = [rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
            for _ in range(4)]
    rng = np.random.default_rng(4)
    mixed = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in (37, 5, 70, 18, 33, 50)]

    def serve(dev, prompts, spec=False, **kw):
        model, draft = models[dev]
        kw = dict(dict(batch_size=4, capacity=128, max_new_tokens=8,
                       burst=4, prefill_chunk=32, block_size=16), **kw)
        if spec:
            kw.update(draft_model=draft, draft_params=dparams[dev],
                      spec_k=SPEC_K)
        eng = ServeEngine(model, params[dev], device=dev, **kw)
        res = eng.serve(prompts)
        check(all(r.status == "ok" for r in res) and eng.n_step_failures == 0,
              f"[sample] {dev} {kw.get('paged')} spec={spec}: "
              f"{[r.status for r in res]}")
        if dev == "cuda":
            torch.cuda.synchronize()
        return eng, [r.tokens.tolist() for r in res]

    toks = {}
    for paged, path in ((True, PAGED_KERNELS), (False, DENSE_KERNELS)):
        _, want = serve("cpu", wave, paged=paged, **SAMPLED)
        reset(kernels)
        _, got = serve("cuda", wave, paged=paged, **SAMPLED)
        launches = _tally(kernels, acc)
        check(got == want, f"[sample] paged={paged}: cuda {got} != cpu {want}")
        check(all(launches[n] > 0 for n in path)
              and all(launches[n] == 0 for n in ATTN_KERNELS
                      if n not in path),
              f"[sample] paged={paged}: launches {launches}")
        toks[paged] = got
        log(f"[sample] 2-layer f32 smollm heads, paged={paged}, temperature "
            f"0.8, top_k 16, seed 11: 4 x 40-token prompts, sampled tokens "
            f"on cuda == cpu; launches "
            f"{ {n: c for n, c in launches.items() if c} }")
    check(toks[True] == toks[False],
          f"[sample] paged {toks[True]} != dense {toks[False]} on cuda")
    _, greedy = serve("cuda", wave)
    reset(kernels)
    check(greedy != toks[True], "[sample] the sampled run drew the greedy "
          "tokens")
    log("[sample] paged == dense on cuda; sampled != greedy")
    for tag, kw in (("greedy", {}), ("sampled", SAMPLED)):
        _, want = serve("cpu", mixed, spec=True, **kw)
        _, plain = serve("cuda", mixed, **kw)
        reset(kernels)
        eng, got = serve("cuda", mixed, spec=True, **kw)
        launches = _tally(kernels, acc)
        check(got == want, f"[spec] {tag}: cuda {got} != cpu {want}")
        check(tag != "greedy" or got == plain,
              f"[spec] greedy spec {got} != non-spec {plain} on cuda")
        check(all(launches[n] > 0 for n in PAGED_KERNELS),
              f"[spec] {tag}: launches {launches}")
        ls = eng.loop_stats()
        log(f"[spec] 2-layer f32 smollm heads, 1-layer draft (the target's "
            f"first layer), spec_k {SPEC_K}, {tag}: {len(mixed)} requests, "
            f"tokens on cuda == cpu"
            + (" == cuda non-spec" if tag == "greedy" else "")
            + f"; {ls['n_spec_rounds']} rounds -> {ls['n_spec_tokens']} "
            f"tokens, accept rate {ls['spec_accept_rate']:.3f}, hist "
            f"{ls['spec_accept_hist']}; launches "
            f"{ {n: c for n, c in launches.items() if c} }")


def _sampler_cost(sample, B: int, V: int, tag: str) -> None:
    """The device operations and the time of one sampler call at the
    served shape (the sampled engine calls it once per device step):
    operations from a profiler trace, ms per call from CUDA events around
    20 calls back to back (host-bound: it holds the launch gaps)."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cpu").manual_seed(0)
    logits = (torch.randn((B, V), generator=g) * 3).to("cuda")
    rids = torch.arange(B, dtype=torch.int32, device="cuda")
    steps = torch.full((B,), 17, dtype=torch.int32, device="cuda")
    for _ in range(3):
        sample(logits, rids, steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sample(logits, rids, steps)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if not RUNTIME_CALL.match(e.key)]
    n_ops = sum(r[2] for r in rows)
    busy = sum(r[1] for r in rows) / 1e3
    s, e = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(20):
        sample(logits, rids, steps)
    e.record()
    torch.cuda.synchronize()
    log(f"[{tag}] sampler at ({B}, {V}): {n_ops} device operations per "
        f"call (= per device step), {busy:.4f} ms of device time, "
        f"{s.elapsed_time(e) / 20:.4f} ms per call back to back")


def phase_sampling_spec(kernels, acc, card: str, greedy_tok_s: float):
    """Phase 11(b): smollm-360m at full width: seeded sampling through the
    launcher's pipeline, then greedy speculation with a self-draft on the
    engine directly, then sampled speculation through the launcher with
    a second smollm-360m (seed 1) as the draft."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import serve
    from repro_torch.serving import ServeEngine
    argv = ["--arch", "smollm-360m", "--kv-dtype", "bf16", "--requests",
            "16", "--batch", "8", "--prompt-len", str(FRONT_PLEN),
            "--max-new", str(FRONT_NEW), "--device", "cuda"]
    reset(kernels)
    out = serve.main(argv + ["--temperature", "0.8", "--top-k", "50",
                             "--seed", "0"])
    torch.cuda.synchronize()
    launches = _tally(kernels, acc)
    check(out["n_results"] == 16 and out["total_tokens"] == 16 * FRONT_NEW,
          f"[sample] served {out['n_results']} / {out['total_tokens']}")
    check(all(launches[n] > 0 for n in PAGED_KERNELS),
          f"[sample] launches {launches}")
    tok_s = out["total_tokens"] / out["wall_s"]
    log(f"[sample] smollm-360m full width through the pipeline, "
        f"temperature 0.8, top_k 50, seed 0: {tok_s:.1f} tok/s against "
        f"phase 5's greedy {greedy_tok_s:.1f} (this call); {card}")
    eng = out["engine"]
    # the launcher's model (seed 0) serves the self-draft run below too
    model, params = eng.model, eng.params
    _sampler_cost(eng._sample, 8, eng.model.cfg.vocab_size, "sample")
    greedy_sample = importlib.import_module(
        "repro_torch.serving.steps").greedy_sample
    _sampler_cost(lambda l, r, t: greedy_sample(l), 8,
                  eng.model.cfg.vocab_size, "greedy")
    reset(kernels)
    phase_trace(eng, "sample")
    reset(kernels)
    del eng, out
    gc.collect()
    torch.cuda.empty_cache()

    prompts = serve.make_requests(model.cfg.vocab_size, 16, FRONT_PLEN)
    kw = dict(batch_size=8, capacity=FRONT_PLEN + FRONT_NEW + 8,
              max_new_tokens=FRONT_NEW, prefill_chunk=32, block_size=16,
              burst=8, kv_dtype="bf16", device="cuda")
    t0 = time.perf_counter()
    plain = ServeEngine(model, params, **kw).serve(prompts, timeout_s=600)
    plain_s = time.perf_counter() - t0
    reset(kernels)
    real, shapes = fops.paged_prefill_attention, {}

    def spy(q, *args, **kwargs):
        shapes[q.shape[1]] = shapes.get(q.shape[1], 0) + 1
        return real(q, *args, **kwargs)
    fops.paged_prefill_attention = spy
    try:
        eng = ServeEngine(model, params, draft_model=model,
                          draft_params=params, spec_k=SPEC_K, **kw)
        t0 = time.perf_counter()
        res = eng.serve(prompts, timeout_s=600)
        torch.cuda.synchronize()
        spec_s = time.perf_counter() - t0
    finally:
        fops.paged_prefill_attention = real
    check_served_by(kernels, "paged_prefill_attention",
                    "paged_prefill_attention_bf16_bf16_mma", "spec")
    launches = _tally(kernels, acc)
    check(all(r.status == "ok" and len(r.tokens) == FRONT_NEW
              for r in res + plain), "[spec] self-draft run failed")
    check(shapes.get(SPEC_K + 1, 0) > 0
          and launches["paged_decode_attention"] > 0,
          f"[spec] K2 calls by T {shapes}, launches {launches}")
    ls = eng.loop_stats()
    total = sum(len(r.tokens) for r in res)
    same = sum(int((a.tokens == b.tokens).sum()) for a, b in zip(res, plain))
    log(f"[spec] smollm-360m full width, self-draft, spec_k {SPEC_K}, "
        f"greedy, engine direct: {ls['n_spec_rounds']} rounds -> "
        f"{ls['n_spec_tokens']} tokens "
        f"({ls['n_spec_tokens'] / max(1, ls['n_spec_rounds']):.2f} per "
        f"round), accept rate {ls['spec_accept_rate']:.3f}, hist "
        f"{ls['spec_accept_hist']}; {total / spec_s:.1f} tok/s against "
        f"{16 * FRONT_NEW / plain_s:.1f} without speculation (direct, same "
        f"call); tokens equal to the non-spec run {same}/{16 * FRONT_NEW} "
        f"(logged, not gated: bf16 need not be batch-invariant); K2 calls "
        f"by T {dict(sorted(shapes.items()))}; launches "
        f"{ {n: c for n, c in launches.items() if c} }; {card}")
    del eng, res, plain, model, params
    gc.collect()
    torch.cuda.empty_cache()

    out = serve.main(argv + ["--spec-k", str(SPEC_K), "--draft-config",
                             "smollm-360m", "--temperature", "0.8"])
    torch.cuda.synchronize()
    launches = _tally(kernels, acc)
    check(out["n_results"] == 16 and out["total_tokens"] == 16 * FRONT_NEW,
          f"[spec] launcher served {out['n_results']} / "
          f"{out['total_tokens']}")
    check(all(launches[n] > 0 for n in PAGED_KERNELS),
          f"[spec] launcher launches {launches}")
    ls = out["engine"].loop_stats()
    log(f"[spec] launcher, --spec-k {SPEC_K} --draft-config smollm-360m "
        f"(random, seed 1) --temperature 0.8: 16 requests ok, "
        f"{out['total_tokens'] / out['wall_s']:.1f} tok/s, accept rate "
        f"{ls['spec_accept_rate']:.3f}, "
        f"{ls['n_spec_tokens'] / max(1, ls['n_spec_rounds']):.2f} tokens "
        f"per round; launches { {n: c for n, c in launches.items() if c} }")


# -- phase 12 -------------------------------------------------------------------

XLSTM_PLEN, XLSTM_NEW = 128, 16


def _small_prompts(vocab_size: int):
    """Phase 4's six prompt lengths, from its seed."""
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab_size, n).astype(np.int32)
            for n in (37, 5, 70, 18, 33, 50)]


def phase_xlstm_small(kernels) -> None:
    """Phase 12(a): the 2-layer f32 xLSTM smoke stack (one mLSTM, one
    sLSTM; TF32 off) paged and dense: the card's greedy tokens equal the
    CPU port's.  The blocks are plain torch (the reference has no xLSTM
    kernel), so no attention kernel may launch."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("xlstm-350m", smoke=True)
    prompts = _small_prompts(cfg.vocab_size)
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = cpu_model.init(seed=0)
    gpu_model = build_model(cfg, device="cuda")
    gpu_params = bridge.to_torch(cpu_params, "cuda")
    for paged in (True, False):
        kw = dict(batch_size=4, capacity=128, max_new_tokens=8, burst=4,
                  paged=paged)
        if paged:
            kw.update(prefill_chunk=32, block_size=16)
        want = ServeEngine(cpu_model, cpu_params, device="cpu",
                           **kw).serve(prompts)
        reset(kernels)
        eng = ServeEngine(gpu_model, gpu_params, device="cuda", **kw)
        got = eng.serve(prompts)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        tag = f"xlstm-350m smoke (2 layers, d 256, f32), paged={paged}"
        check(eng.paged == paged, f"[xlstm] {tag}: ran paged={eng.paged}")
        for a, b in zip(want, got):
            check(a.status == b.status == "ok",
                  f"[xlstm] {tag} request {b.request_id}: {b.status}")
            check(np.array_equal(a.tokens, b.tokens),
                  f"[xlstm] {tag} request {a.request_id}: cpu {a.tokens} "
                  f"!= cuda {b.tokens}")
        check(not any(launches.values()),
              f"[xlstm] {tag}: a kernel launched on an xLSTM stack: "
              f"{launches}")
        log(f"[xlstm] {tag}: {len(prompts)} requests, greedy tokens on "
            f"cuda == cpu ({sum(len(r.tokens) for r in got)} tokens)")


def xlstm_engine(params=None):
    """Phase 12(b)'s model and engine: xlstm-350m at full width and depth
    (24 layers, 21 mLSTM + 3 sLSTM, bf16; random weights made on the card
    from the generator of seed 0 when ``params`` is None) on the paged
    engine over the default f32 ``cache_dtype`` (the xLSTM carries are
    f32 whatever it is): batch 8, chunk 32, burst 8, one slab per slot.
    Returns (engine, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    model = build_model(get_config("xlstm-350m"), device="cuda")
    if params is None:
        params = model.init(seed=0)
    eng = ServeEngine(model, params, batch_size=8,
                      capacity=XLSTM_PLEN + XLSTM_NEW,
                      max_new_tokens=XLSTM_NEW, prefill_chunk=32,
                      block_size=16, burst=8, num_state_slots=8,
                      device="cuda")
    return eng, params


def phase_xlstm(kernels, card: str) -> None:
    """Phase 12(b): xlstm-350m at full width served paged through the
    launcher's pipeline (8 requests of 128 prompt tokens, 16 new), then a
    profiler trace, then the same prompts with request 0 preempted after
    two tokens (its slabs spilled to host) and restored through the batch
    lane: its tokens must equal the unpreempted run's."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    eng, params = xlstm_engine()
    torch.cuda.synchronize()
    cfg, model = eng.model.cfg, eng.model
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[xlstm] {cfg.arch_id} full width: {cfg.n_layers} layers "
        f"{model.period_descs} x {model.n_periods}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {2 * cfg.d_model // cfg.n_heads}, vocab "
        f"{cfg.vocab_size}, bf16 over an f32 cache_dtype: "
        f"{n_params / 1e9:.3f}B parameters made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, XLSTM_PLEN).astype(np.int32)
               for _ in range(8)]
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    bufs = serve.serve_pipeline(eng, prompts, batch=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    piped = {int(b.meta["request"]): np.asarray(b.data) for b in bufs}
    check(sorted(piped) == list(range(8))
          and all(len(t) == XLSTM_NEW for t in piped.values()),
          f"[xlstm] pipeline: {[(i, len(t)) for i, t in piped.items()]}")
    check(all(int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size
              for t in piped.values()), "[xlstm] token outside the vocab")
    check(not any(launches.values()),
          f"[xlstm] a kernel launched on an xLSTM stack: {launches}")
    total = 8 * XLSTM_NEW
    slabs = [a for st in eng._paged_cache["blocks"].values()
             for a in st.values()]         # (layers, slots + 1, ...) each
    slab_bytes = sum(a[:, 0].numel() * a.element_size() for a in slabs)
    check(all(a.dtype == torch.float32 for a in slabs),
          "[xlstm] a slab is not f32")
    log(f"[xlstm] served 8 requests / {total} tokens through the pipeline "
        f"in {wall:.2f}s = {total / wall:.1f} tok/s; {eng.n_device_steps} "
        f"device steps ({eng.n_prefill_chunks} mixed); slabs "
        f"{slab_bytes / 1e6:.1f} MB per slot x "
        f"{eng.pool_stats()['num_state_slots']} + the dump row; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    phase_trace(eng, "xlstm", n=8, prompt_len=XLSTM_PLEN)
    plain = eng.serve(prompts, lane="batch")
    pre, _ = xlstm_engine(params)
    got = serve_scheduled(pre, prompts, decode_rid=0, prefill_rid=None)
    torch.cuda.synchronize()
    check(pre.n_preemptions == pre.n_restores == 1,
          f"[xlstm] preemptions {pre.n_preemptions}, restores "
          f"{pre.n_restores}")
    check(all(r.status == "ok" for r in got), "[xlstm] preempted run failed")
    check(np.array_equal(got[0].tokens, plain[0].tokens),
          f"[xlstm] restored request 0: {got[0].tokens} != unpreempted "
          f"{plain[0].tokens}")
    same = sum(np.array_equal(a.tokens, b.tokens) for a, b in zip(got, plain))
    ps = pre.pool_stats()
    check(ps["n_state_live"] == 0 and ps["n_live"] == 0, f"[xlstm] {ps}")
    log(f"[xlstm] request 0 preempted after 2 tokens (its slabs spilled to "
        f"host), restored through the batch lane: its tokens equal the "
        f"unpreempted run's; {same}/8 requests "
        f"equal; the direct run's tokens equal the pipeline's for "
        f"{sum(np.array_equal(piped[i], plain[i].tokens) for i in range(8))}"
        f"/8")
    del eng, pre
    gc.collect()
    torch.cuda.empty_cache()
    # the launcher's own path: --arch xlstm-350m, default (f32) kv dtype
    out = serve.main(["--arch", "xlstm-350m", "--requests", "8", "--batch",
                      "8", "--prompt-len", str(XLSTM_PLEN), "--max-new",
                      str(XLSTM_NEW), "--device", "cuda"])
    check(out["engine"].paged and out["n_results"] == 8
          and out["total_tokens"] == 8 * XLSTM_NEW,
          f"[xlstm] launcher: paged={out['engine'].paged}, "
          f"{out['n_results']} results / {out['total_tokens']} tokens")
    log(f"[xlstm] launcher --arch xlstm-350m: 8 requests served paged "
        f"through the pipeline, "
        f"{out['total_tokens'] / out['wall_s']:.1f} tok/s")


# -- phase 13 -------------------------------------------------------------------

MLA_PLEN, MLA_NEW = 128, 16
MLA_KERNELS = ("flash_attention", "decode_attention", "gating_topk")


def phase_mla_small(kernels, acc) -> None:
    """Phase 13(a): the deepseek-v3 smoke model (2 layers, f32, q/k head
    48, v head 32, 4 experts; TF32 off) on the dense engine in both MLA
    decode forms: the card's greedy tokens equal the CPU port's (B2, B6,
    and B4 in the expanded form, launched); then the model's decode logits
    in the two forms after one prefill on the card, within the reference's
    own bound (2e-3)."""
    import dataclasses
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("deepseek-v3-671b", smoke=True)
    prompts = _small_prompts(cfg.vocab_size)
    cpu_params = build_model(cfg, device="cpu").init(seed=0)
    gpu_params = bridge.to_torch(cpu_params, "cuda")
    kw = dict(batch_size=4, capacity=128, max_new_tokens=8, burst=4)
    for absorb in (False, True):
        want = ServeEngine(build_model(cfg, device="cpu", mla_absorb=absorb),
                           cpu_params, device="cpu", **kw).serve(prompts)
        reset(kernels)
        eng = ServeEngine(build_model(cfg, device="cuda", mla_absorb=absorb),
                          gpu_params, device="cuda", **kw)
        got = eng.serve(prompts)
        torch.cuda.synchronize()
        tag = f"deepseek-v3 smoke (2 layers, f32), mla_absorb={absorb}"
        _check_mla_entries(kernels, cfg, torch.float32, absorb, f"mla {tag}")
        launches = _tally(kernels, acc)
        check(not eng.paged, f"[mla] {tag}: ran paged")
        for a, b in zip(want, got):
            check(a.status == b.status == "ok",
                  f"[mla] {tag} request {b.request_id}: {b.status}")
            check(np.array_equal(a.tokens, b.tokens),
                  f"[mla] {tag} request {a.request_id}: cpu {a.tokens} != "
                  f"cuda {b.tokens}")
        path = ("flash_attention", "gating_topk") + \
            (() if absorb else ("decode_attention",))
        check(all(launches[n] > 0 for n in path)
              and all(launches[n] == 0 for n in ATTN_KERNELS
                      if n not in path),
              f"[mla] {tag}: launches {launches}")
        log(f"[mla] {tag}: {len(prompts)} requests on the dense engine, "
            f"greedy tokens on cuda == cpu; launches "
            f"{ {n: c for n, c in launches.items() if c} }")
    mcfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (4, 40)).astype(np.int32)).to("cuda")
    logits = []
    for absorb in (False, True):
        model = build_model(mcfg, device="cuda", mla_absorb=absorb)
        _, cache = model.prefill(gpu_params, tokens[:, :39], capacity=48,
                                 cache_dtype=torch.float32)
        logits.append(model.decode_step(gpu_params, cache, tokens[:, 39:],
                                        39)[0])
    err = (logits[0] - logits[1]).abs().max().item()
    _tally(kernels, acc)
    check(err < 2e-3, f"[mla] absorbed vs expanded decode logits {err}")
    log(f"[mla] absorbed vs expanded decode logits on the card: max abs "
        f"diff {err:.3e} (the reference's bound 2e-3)")


def _check_mla_entries(kernels, cfg, dtype, absorb: bool, tag: str) -> None:
    """Every B2 (and, expanded, B4) launch since the last reset was of the
    entry the MLA dispatch picks for ``dtype`` operands at ``cfg``'s dims:
    the MLA entries for bf16 at DeepSeek-V3's, the GQA entries over the
    concatenated operands otherwise (the f32 smoke model)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    m = cfg.mla
    dims = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim)
    check_served_by(kernels, "flash_attention",
                    fops.mla_flash_entry((dtype,) * 4, dims), tag)
    if not absorb:
        check_served_by(kernels, "decode_attention",
                        dops.mla_entry((dtype,) * 4, dims), tag)


def mla_engine(absorb: bool, params=None, pkg: str = "repro_torch"):
    """Phase 13(b)'s model and engine: deepseek-v3-671b at full width, cut
    to its 3 dense-prefix layers and 1 MoE layer (plus the MTP leaves;
    bf16, random weights made on the card from seed 0 when ``params`` is
    None), on the dense engine (MLA serves dense only), bf16 latent cache,
    batch 8, burst 8, from the port package importable as ``pkg``
    (kernel_ab.py builds another checkout's the same way).  Returns
    (engine, params)."""
    configs, models, serving = (importlib.import_module(f"{pkg}.{m}")
                                for m in ("configs", "models", "serving"))
    cfg = configs.get_config("deepseek-v3-671b").replace(n_layers=4)
    model = models.build_model(cfg, device="cuda", mla_absorb=absorb)
    if params is None:
        params = model.init(seed=0)
    eng = serving.ServeEngine(model, params, batch_size=8,
                      capacity=MLA_PLEN + MLA_NEW, max_new_tokens=MLA_NEW,
                      burst=8, kv_dtype="bf16", device="cuda")
    return eng, params


def mla_prompts(vocab_size: int):
    """Phase 13(b)'s 8 requests of ``MLA_PLEN`` prompt tokens."""
    rng = np.random.default_rng(13)
    return [rng.integers(0, vocab_size, MLA_PLEN).astype(np.int32)
            for _ in range(8)]


def phase_mla(kernels, card: str):
    """Phase 13(b): deepseek-v3-671b at full width, 4 of its 61 layers, on
    the dense engine: 8 requests of 128 prompt tokens, 16 new, in the
    expanded decode form (B2, B4, B6) and the absorbed one (B2, B6), then
    a profiler trace of the expanded engine, and B2/B4 on layer 0's
    served operands (``phase_mla_served_kernels``).  Returns the launches
    of both runs and the served-operand rows."""
    t0 = time.perf_counter()
    eng, params = mla_engine(False)
    torch.cuda.synchronize()
    cfg, model = eng.model.cfg, eng.model
    n_params = sum(p.numel() for p in _leaves(params))
    m = cfg.mla
    log(f"[mla] {cfg.arch_id} full width, 4 of 61 layers: "
        f"{model.prefix_descs + model.period_descs}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads (q/k {m.qk_nope_head_dim}+"
        f"{m.qk_rope_head_dim}, v {m.v_head_dim}), q rank {m.q_lora_rank}, "
        f"kv rank {m.kv_lora_rank}, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k} + {cfg.moe.n_shared} shared, vocab "
        f"{cfg.vocab_size}, MTP leaves {'mtp' in params}, bf16: "
        f"{n_params / 1e9:.2f}B parameters made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    prompts = mla_prompts(cfg.vocab_size)
    total, runs = {}, {}
    for absorb in (False, True):
        if absorb:
            eng, _ = mla_engine(True, params)
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        t0 = time.perf_counter()
        res = eng.serve(prompts, timeout_s=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
        tag = f"mla_absorb={absorb}"
        check(not eng.paged, f"[mla] {tag}: ran paged")
        check(all(r.status == "ok" and len(r.tokens) == MLA_NEW
                  and 0 <= int(r.tokens.min())
                  and int(r.tokens.max()) < cfg.vocab_size for r in res),
              f"[mla] {tag}: {[(r.status, len(r.tokens)) for r in res]}")
        path = ("flash_attention", "gating_topk") + \
            (() if absorb else ("decode_attention",))
        check(all(launches[n] > 0 for n in path)
              and all(launches[n] == 0 for n in ATTN_KERNELS
                      if n not in path),
              f"[mla] {tag}: launches {launches}")
        _check_mla_entries(kernels, cfg, torch.bfloat16, absorb, "mla")
        runs[absorb] = res
        n_tok = sum(len(r.tokens) for r in res)
        log(f"[mla] {tag}: served 8 requests / {n_tok} tokens on the dense "
            f"engine in {wall:.2f}s = {n_tok / wall:.1f} tok/s (direct; "
            f"{eng.n_device_steps} decode steps, {eng.n_batches} prefill "
            f"waves); launches { {n: c for n, c in launches.items() if c} }; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB; {card}")
        if not absorb:
            phase_trace(eng, "mla", n=8, prompt_len=MLA_PLEN)
    same = sum(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(runs[False], runs[True]))
    log(f"[mla] absorbed vs expanded: {same}/8 requests with equal tokens "
        f"(bf16: the two forms round differently)")
    return total, phase_mla_served_kernels(eng.model, params, prompts)


def phase_mla_served_kernels(model, params, prompts) -> dict:
    """B2 and B4 on the operands phase 13(b) gives them, against their
    plain versions with phase 3's MLA tolerances, then timed: layer 0's
    q, k_nope, rope key and V of the 8 served prompts (S = MLA_PLEN,
    causal), and its expanded decode at the first and the last decode
    step's valid slots (MLA_PLEN + 1 and MLA_PLEN + MLA_NEW) over the
    latent cache's rope keys in place, the latents of 16 more random
    tokens after each prompt standing in for the generated ones.  These
    launches are not the main path's (its counts were read).  Returns
    {kernel: row} (the last decode shape's row)."""
    from repro_torch.models import attention as A
    from repro_torch.models.common import make_norm
    cfg, m = model.cfg, model.cfg.mla
    vd, hd = m.v_head_dim, m.qk_nope_head_dim + m.qk_rope_head_dim
    H, S, C = cfg.n_heads, MLA_PLEN, MLA_PLEN + MLA_NEW
    rng = np.random.default_rng(14)
    tokens = torch.from_numpy(np.concatenate(
        [np.stack(prompts), rng.integers(0, cfg.vocab_size, (8, MLA_NEW))],
        1).astype(np.int32)).to("cuda")
    p = params["prefix"][0]
    h = make_norm(cfg.norm)[1](p["norm1"], model._embed(params, tokens))
    pos = torch.arange(C, dtype=torch.int32, device="cuda").expand(8, C)
    q, _, c_kv, k_rope = A._mla_qkv(p["attn"], cfg, h, pos)
    kr_cache = k_rope.reshape(8, C, m.qk_rope_head_dim).contiguous()
    timer = Timer()
    k_nope, v = A._mla_expand_kv(p["attn"], cfg, c_kv[:, :S])
    rows = {"flash_attention": _mla_flash_row(
        timer, q[:, :S].contiguous(), k_nope, kr_cache[:, :S].contiguous(),
        v, f"[mla] served B2 operands: layer 0, B=8 S={S} causal, heads "
        f"{H}/{H} q/k {hd} V {vd} {str(q.dtype)[6:]}",
        PADDED_MLA["served B2"])}
    for n in (S + 1, C):
        k_nope, v = A._mla_expand_kv(p["attn"], cfg, c_kv[:, :n])
        rows["decode_attention"] = dict(n_valid=n, **_mla_decode_row(
            timer, q[:, n - 1].contiguous(), k_nope, kr_cache, v, n,
            f"[mla] served B4 operands: layer 0, B=8, {n} valid of "
            f"capacity {C}, heads {H}/{H} q/k {hd} V {vd} "
            f"{str(q.dtype)[6:]}", PADDED_MLA["served B4"]))
    return rows


# -- phase 14 -------------------------------------------------------------------

FWD_TOL = 1e-3          # x max(1, max|logits|): f32 card vs CPU, TF32 off


def phase_forward_small(kernels, acc) -> None:
    """Phase 14(a): ``apply`` (the full-sequence forward) of phase 4's
    f32 models (the 2-layer smollm-headed stack, and the jamba, deepseek
    and xLSTM smoke stacks) on the card against the CPU port, logits and
    MoE aux loss within ``FWD_TOL`` relative to the largest logit; each
    path's kernels launched and no other attention kernel.  Then
    ``SingleShot(model="smollm-360m:smoke", framework="torch")`` on the
    card against the same on the CPU (its loader draws the weights on the
    CPU, so both hold the same numbers)."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.single import SingleShot
    smollm2 = get_config("smollm-360m").replace(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    cases = [
        ("2-layer f32 smollm heads", smollm2, ("flash_attention",)),
        ("jamba-v0.1 smoke (8 layers, 4 experts)",
         get_config("jamba-v0.1-52b", smoke=True),
         ("flash_attention", "selective_scan", "gating_topk")),
        ("deepseek-v3 smoke (MLA, 4 experts)",
         get_config("deepseek-v3-671b", smoke=True),
         ("flash_attention", "gating_topk")),
        ("xlstm-350m smoke", get_config("xlstm-350m", smoke=True), ())]
    for tag, cfg, path in cases:
        tokens = torch.from_numpy(np.random.default_rng(14).integers(
            0, cfg.vocab_size, (4, 70)).astype(np.int32))
        cpu_model = build_model(cfg, device="cpu")
        cpu_params = cpu_model.init(seed=0)
        want, want_aux = cpu_model.apply(cpu_params, tokens)
        gpu_model = build_model(cfg, device="cuda")
        gpu_params = bridge.to_torch(cpu_params, "cuda")
        reset(kernels)
        with torch.inference_mode():
            got, aux = gpu_model.apply(gpu_params, tokens.to("cuda"))
        torch.cuda.synchronize()
        launches = _tally(kernels, acc)
        err = (got.cpu() - want).abs().max().item()
        tol = FWD_TOL * max(1.0, want.abs().max().item())
        aux_err = abs(aux.item() - want_aux.item())
        check(err <= tol and aux_err <= tol,
              f"[forward] {tag}: logits max_abs_err {err}, aux {aux_err} "
              f"> {tol}")
        check(all(launches[n] > 0 for n in path)
              and all(launches[n] == 0 for n in ATTN_KERNELS
                      if n not in path)
              and (path or not any(launches.values())),
              f"[forward] {tag}: launches {launches}")
        log(f"[forward] {tag}: apply (4, 70) on cuda vs cpu: logits "
            f"max_abs_err {err:.3e}, aux {aux_err:.3e} (tol {tol:.3e}); "
            f"launches { {n: c for n, c in launches.items() if c} }")
    tokens = np.random.default_rng(15).integers(0, 512, (4, 40)).astype(
        np.int32)
    want, _ = SingleShot(model="smollm-360m:smoke", framework="torch",
                         device="cpu").invoke(tokens)
    reset(kernels)
    single = SingleShot(model="smollm-360m:smoke", framework="torch")
    got, _ = single.invoke(tokens)
    launches = _tally(kernels, acc)
    err = float(np.abs(got - want).max())
    tol = FWD_TOL * max(1.0, float(np.abs(want).max()))
    check(err <= tol and launches["flash_attention"] == 2,
          f"[forward] SingleShot smollm-360m:smoke: max_abs_err {err} > "
          f"{tol} or launches {launches}")
    log(f"[forward] SingleShot(model='smollm-360m:smoke', framework='torch') "
        f"cuda vs cpu: logits {got.shape} max_abs_err {err:.3e} (tol "
        f"{tol:.3e}), {single.mean_latency_s * 1e3:.1f} ms a call")


def phase_forward(kernels, acc, card: str) -> None:
    """Phase 14(b): smollm-360m at full width and depth (bf16, random
    weights from seed 0 made on the card): ``apply`` on (8, 512) tokens
    through ``SingleShot(fn=..., framework="torch")`` (numpy in and out);
    B2 through its tensor-core entry, once a layer.  Its last row against
    ``prefill``'s logits on the same tokens: argmax equal on every row
    whose top two logits lie further apart than the two differ (bf16: one
    GEMM over 4096 rows, the other over 8, may round apart)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.single import SingleShot
    cfg = get_config("smollm-360m")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    tokens = np.random.default_rng(14).integers(
        0, cfg.vocab_size, (8, 512)).astype(np.int32)
    single = SingleShot(fn=lambda t: model.apply(params, t),
                        framework="torch")
    reset(kernels)
    t0 = time.perf_counter()
    logits, aux = single.invoke(tokens)
    wall = time.perf_counter() - t0
    check_served_by(kernels, "flash_attention", "flash_attention_bf16_mma",
                    "forward")
    launches = _tally(kernels, acc)
    check(logits.shape == (8, 512, cfg.vocab_size)
          and np.isfinite(logits).all() and float(aux) == 0.0,
          f"[forward] smollm-360m apply: {logits.shape}, aux {aux}")
    check(launches["flash_attention"] == cfg.n_layers
          and all(launches[n] == 0 for n in ATTN_KERNELS
                  if n != "flash_attention"),
          f"[forward] smollm-360m apply launches {launches}")
    with torch.inference_mode():
        last, _ = model.prefill(params, torch.from_numpy(tokens).to("cuda"),
                                capacity=512, cache_dtype=torch.bfloat16)
    _tally(kernels, acc)
    last = last.float().cpu().numpy()
    row = logits[:, -1]
    err = float(np.abs(last - row).max())
    top2 = np.sort(row, axis=1)[:, -2:]
    same = row.argmax(1) == last.argmax(1)
    check(all(same[r] or top2[r, 1] - top2[r, 0] <= err for r in range(8)),
          f"[forward] apply's last row vs prefill: argmax {row.argmax(1)} "
          f"vs {last.argmax(1)}, max_abs_err {err}")
    log(f"[forward] smollm-360m full width (32 layers, bf16): apply (8, 512) "
        f"through SingleShot(fn=, framework='torch') in {wall * 1e3:.1f} ms "
        f"(numpy in, {logits.nbytes / 2**20:.0f} MiB f32 logits out); B2 "
        f"{launches['flash_attention']} launches, `_mma`; last row vs "
        f"prefill: argmax equal on {int(same.sum())}/8 rows, max_abs_err "
        f"{err:.3e} (bf16 logits up to {float(np.abs(row).max()):.2f}); "
        f"{card}")


# -- phase 15 -------------------------------------------------------------------

WHISPER_PLEN, WHISPER_NEW = 4, 64


def _whisper_frames(cfg, batch: int):
    """Encoder frames (batch, enc_seq, d_model) from numpy seed 0."""
    return (np.random.default_rng(0).standard_normal(
        (batch, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)


def _trace_generate(eng, prompts, extra, tag: str) -> None:
    """A CUDA trace of one more ``generate_batch`` (a prefill and
    max_new_tokens - 1 decode steps: one device step per new token)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate_batch(prompts, extra_embeds=extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report_trace(prof, wall, eng.max_new_tokens, tag,
                  f"generate_batch of {prompts.shape[0]} x "
                  f"{prompts.shape[1]}-token prompts, "
                  f"{eng.max_new_tokens} new tokens (prefill + "
                  f"{eng.max_new_tokens - 1} decode steps)")


def phase_whisper(kernels, acc, card: str) -> None:
    """Phase 15: whisper-tiny at full width and depth (4 + 4 layers, d
    384, 6 heads, 1500 encoder frames, vocab 51865, bf16, random weights
    from seed 0 made on the card; no cut) on the dense engine:
    ``generate_batch`` of 8 prompts of 4 tokens with (8, 1500, 384) frames
    from numpy seed 0, 64 new tokens.  B2 (``_mma``) launches 3 times a
    layer: the encoder's bidirectional self-attention, the decoder's
    causal one and its cross-attention (no mask); B4 (``_mma``, G = 1)
    twice a layer and decode step (self, and cross over all 1500 slots).
    Then the smoke
    config in f32: the card's tokens equal the CPU port's.  Then a trace
    of the full-width run."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("whisper-tiny")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    eng = ServeEngine(model, params, batch_size=8,
                      capacity=WHISPER_PLEN + WHISPER_NEW,
                      max_new_tokens=WHISPER_NEW, kv_dtype="bf16",
                      device="cuda")
    frames = _whisper_frames(cfg, 8)
    prompts = np.random.default_rng(15).integers(
        0, cfg.vocab_size, (8, WHISPER_PLEN)).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    gen = eng.generate_batch(prompts, extra_embeds=frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_served_by(kernels, "flash_attention", "flash_attention_bf16_mma",
                    "whisper")
    check_served_by(kernels, "decode_attention",
                    "decode_attention_bf16_bf16_mma", "whisper")
    launches = _tally(kernels, acc)
    L = cfg.n_layers
    check(gen.shape == (8, WHISPER_NEW) and 0 <= int(gen.min())
          and int(gen.max()) < cfg.vocab_size,
          f"[whisper] generated {gen.shape}, range {gen.min()}..{gen.max()}")
    check(launches["flash_attention"] == cfg.n_enc_layers + 2 * L
          and launches["decode_attention"] == 2 * L * (WHISPER_NEW - 1)
          and all(launches[n] == 0 for n in ATTN_KERNELS
                  if n not in DENSE_KERNELS),
          f"[whisper] launches {launches}")
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[whisper] whisper-tiny full width and depth ({cfg.n_enc_layers} + "
        f"{L} layers, d {cfg.d_model}, {cfg.n_heads} heads, enc_seq "
        f"{cfg.enc_seq}, vocab {cfg.vocab_size}, bf16, "
        f"{n_params / 1e6:.1f}M parameters): generate_batch 8 x "
        f"{WHISPER_PLEN} tokens + (8, {cfg.enc_seq}, {cfg.d_model}) frames, "
        f"{WHISPER_NEW} new: {gen.size / wall:.1f} tok/s ({wall:.2f}s, "
        f"{wall * 1e3 / WHISPER_NEW:.2f} ms per new token); B2 "
        f"{launches['flash_attention']} launches (encoder "
        f"{cfg.n_enc_layers} bidirectional, {L} causal, {L} cross), B4 "
        f"{launches['decode_attention']} ({L} self + {L} cross a step); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{card}")
    scfg = get_config("whisper-tiny", smoke=True)
    cpu_model = build_model(scfg, device="cpu")
    cpu_params = cpu_model.init(seed=0)
    kw = dict(batch_size=4, capacity=WHISPER_PLEN + 16, max_new_tokens=16,
              kv_dtype="f32")
    sframes = _whisper_frames(scfg, 4)
    sprompts = prompts[:4] % scfg.vocab_size
    want = ServeEngine(cpu_model, cpu_params, device="cpu",
                       **kw).generate_batch(sprompts, extra_embeds=sframes)
    reset(kernels)
    got = ServeEngine(build_model(scfg, device="cuda"),
                      bridge.to_torch(cpu_params, "cuda"), device="cuda",
                      **kw).generate_batch(sprompts, extra_embeds=sframes)
    launches = _tally(kernels, acc)
    check(np.array_equal(want, got),
          f"[whisper] smoke f32: cpu {want} != cuda {got}")
    check(launches["flash_attention"] == scfg.n_enc_layers
          + 2 * scfg.n_layers and launches["decode_attention"] > 0,
          f"[whisper] smoke launches {launches}")
    log(f"[whisper] whisper-tiny smoke (2 + 2 layers, d 256, 64 frames, "
        f"f32): generate_batch tokens on cuda == cpu ({got.size} tokens); "
        f"launches { {n: c for n, c in launches.items() if c} }")
    _trace_generate(eng, prompts, frames, "whisper")
    reset(kernels)


# -- phase 16 -------------------------------------------------------------------

VLM_TEXT, VLM_NEW, VLM_LAYERS = 128, 32, 8


def phase_vlm(kernels, acc, card: str) -> None:
    """Phase 16: qwen2-vl-72b at full width (d 8192, 64/8 heads of 128,
    M-RoPE sections (16, 24, 24), d_ff 29568, vocab 152064, bf16) cut to 8
    of its 80 layers (random weights from seed 0 made on the card) on the
    dense engine: ``generate_batch`` of 8 requests of 1024 patch rows
    (``fake_vision_patches`` from a card generator seeded 16) plus 128 text
    tokens, 32 new tokens.  B2 (``_mma``, causal, hd 128) launches once a
    layer, B4 once a layer and decode step.  Then a trace."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, frontends
    from repro_torch.serving import ServeEngine
    t0 = time.perf_counter()
    cfg = get_config("qwen2-vl-72b").replace(n_layers=VLM_LAYERS)
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    S = cfg.vision_seq + VLM_TEXT
    eng = ServeEngine(model, params, batch_size=8, capacity=S + VLM_NEW,
                      max_new_tokens=VLM_NEW, kv_dtype="bf16", device="cuda")
    patches = frontends.fake_vision_patches(
        cfg, 8, torch.Generator(device="cuda").manual_seed(16),
        dtype=torch.bfloat16)
    prompts = np.random.default_rng(16).integers(
        0, cfg.vocab_size, (8, S)).astype(np.int32)
    log(f"[vlm] qwen2-vl-72b full width, {VLM_LAYERS} of 80 layers: d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, mrope {cfg.mrope_sections}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, bf16: {n_params / 1e9:.2f}B "
        f"parameters made on the card in {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    gen = eng.generate_batch(prompts, extra_embeds=patches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_served_by(kernels, "flash_attention", "flash_attention_bf16_mma",
                    "vlm")
    check_served_by(kernels, "decode_attention",
                    "decode_attention_bf16_bf16_mma", "vlm")
    launches = _tally(kernels, acc)
    check(gen.shape == (8, VLM_NEW) and 0 <= int(gen.min())
          and int(gen.max()) < cfg.vocab_size,
          f"[vlm] generated {gen.shape}, range {gen.min()}..{gen.max()}")
    check(launches["flash_attention"] == VLM_LAYERS
          and launches["decode_attention"] == VLM_LAYERS * (VLM_NEW - 1)
          and all(launches[n] == 0 for n in ATTN_KERNELS
                  if n not in DENSE_KERNELS),
          f"[vlm] launches {launches}")
    log(f"[vlm] generate_batch 8 x ({cfg.vision_seq} patch rows + "
        f"{VLM_TEXT} text tokens), {VLM_NEW} new: {gen.size / wall:.1f} "
        f"tok/s ({wall:.2f}s, {wall * 1e3 / VLM_NEW:.2f} ms per new token); "
        f"B2 {launches['flash_attention']} launches, B4 "
        f"{launches['decode_attention']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    _trace_generate(eng, prompts, patches, "vlm")
    reset(kernels)


# -- phase 17 -------------------------------------------------------------------

TRAIN_RTOL = 1e-4       # card vs CPU port, loss and grad norm per step (f32)
TRAIN_STEPS = 3
# phase 17(a)'s smoke configs and the kernels each must launch
TRAIN_ARCHS = (
    ("smollm-360m", ("flash_attention", "flash_attention_backward")),
    ("dbrx-132b", ("flash_attention", "flash_attention_backward",
                   "gating_topk")),
    ("deepseek-v3-671b", ("flash_attention", "flash_attention_backward",
                          "gating_topk")),
    ("whisper-tiny", ("flash_attention", "flash_attention_backward")),
    ("xlstm-350m", ()),
    ("jamba-v0.1-52b", ("flash_attention", "flash_attention_backward",
                        "gating_topk", "selective_scan",
                        "selective_scan_backward")))
FULL_TRAIN = dict(steps=30, batch=8, seq=512)      # phase 17(b)
# smoke configs whose free-running card and CPU runs can part by more
# than TRAIN_RTOL at the third step whatever the kernels do: differences
# in the last bits of the weights grow along the trajectory, so the
# distance varies from call to call, and a card run with the plain torch
# scan in place of B5 and B5' parts from the CPU port as a run with them
# does (``_log_forced`` logs both, and the CPU port against itself from
# weights moved by 1e-6 relative).  Each card step is held to the CPU
# port's loss and grad norm at the card's own weights and batch instead,
# every step within TRAIN_RTOL.
FORCED_ARCHS = ("jamba-v0.1-52b",)


def _port_metrics(model, params, batch) -> dict:
    """The CPU port's loss and grad norm (the trainer's metrics) at
    ``params`` on ``batch``."""
    from repro_torch.optim import global_norm
    from repro_torch.training.trainer import trainable
    from repro_torch.tree import tree_leaves, tree_map
    p = trainable(tree_map(lambda t: t.detach().to("cpu", copy=True),
                           params))
    leaves = [t for t in tree_leaves(p) if t.is_floating_point()]
    loss = model.loss(p, {k: torch.from_numpy(np.asarray(v))
                          for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {"loss": loss.item(), "grad_norm": global_norm(list(grads)).item()}


def _train_batches(cfg, batch: int = 4, seq: int = 64):
    """The seeded ``TokenStream`` (seed 0); an encoder-decoder's frames
    from numpy seed 0 as ``extra_embeds``."""
    from repro_torch.data import TokenStream
    extra = _whisper_frames(cfg, batch) if cfg.family == "audio" else None
    for b in TokenStream(cfg.vocab_size, seq, batch, seed=0):
        yield b if extra is None else dict(b, extra_embeds=extra)


def _rel_errs(got, want):
    return [max(abs(g[k] - w[k]) / abs(w[k]) for k in ("loss", "grad_norm"))
            for g, w in zip(got, want)]


def _log_forced(arch, cfg, params, kw, got, want) -> None:
    """Why ``arch`` is held step by step (``FORCED_ARCHS``), logged: how
    far the free-running card run parts from the CPU port's; how far the
    CPU port parts from itself from weights moved by 1e-6 relative; and
    how far a card run with the plain torch scan in place of B5 and B5'
    parts from the CPU port (launches not counted)."""
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.models import build_model
    from repro_torch.training import Trainer
    from repro_torch.tree import tree_map
    g = torch.Generator(device="cpu").manual_seed(1)
    moved = tree_map(lambda t: t * (1 + 1e-6 * torch.randn(
        t.shape, generator=g)) if t.is_floating_point() else t, params)
    cpu_moved = Trainer(build_model(cfg, device="cpu"), device="cpu",
                        params=moved, **kw).fit(_train_batches(cfg),
                                                TRAIN_STEPS, log_fn=None)
    served = sops.selective_scan
    sops.selective_scan = lambda *a: sops.selective_scan_plain(*a, None)
    try:
        card_plain = Trainer(build_model(cfg, device="cuda"), params=params,
                             **kw).fit(_train_batches(cfg), TRAIN_STEPS,
                                       log_fn=None)
    finally:
        sops.selective_scan = served
    log(f"[train] {arch} smoke: each card step held to the CPU port at the "
        f"card's weights and batch (FORCED_ARCHS); free-running, the card "
        f"parts from the CPU port by {_rel_errs(got, want)} (loss or grad "
        f"norm, relative, per step), the CPU port from itself with weights "
        f"moved by 1e-6 by {_rel_errs(cpu_moved, want)}, a card run with "
        f"the plain torch scan for B5 and B5' from the CPU port by "
        f"{_rel_errs(card_plain, want)}")


def phase_train_small(kernels, acc) -> None:
    """Phase 17(a): the f32 smoke configs of smollm, dbrx (softmax router,
    B6), deepseek-v3 (MLA, ``sigmoid_bias`` router, MTP), whisper-tiny,
    xLSTM and jamba (8 layers: 7 mamba, 4 MoE of 4 experts) train
    ``TRAIN_STEPS`` steps from the same weights (drawn on the CPU from
    seed 0) and batches on the card and on the CPU port: loss and grad
    norm per step within ``TRAIN_RTOL`` (for ``FORCED_ARCHS`` against
    the CPU port at the card's weights of that step); on the card B2's
    forward and backward launch (B6 too for the MoE configs, nothing for
    xLSTM; for jamba also B5, only through its checkpointing twin, and
    B5' once a mamba layer and step), each through the entries its head
    dim picks (64: ``flash_attention_f32_tf32_lse`` and the split-TF32
    backward; deepseek's GQA form at 48: the served forward and the
    CUDA-core backward).  Then the jamba stack again with
    ``build_model(cfg, remat=True)``: the twin twice a layer and step,
    every loss equal to the plain card run's bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import build_model
    from repro_torch.training import Trainer
    kw = dict(peak_lr=1e-3, warmup=1, total_steps=TRAIN_STEPS)
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    train_kernels = ATTN_KERNELS + ("flash_attention_backward",
                                    "gating_topk", "selective_scan",
                                    "selective_scan_backward")
    for arch, path in TRAIN_ARCHS:
        cfg = get_config(arch, smoke=True).replace(**f32)
        cpu_model = build_model(cfg, device="cpu")
        params = cpu_model.init(seed=0)
        want = Trainer(cpu_model, device="cpu", params=params, **kw).fit(
            _train_batches(cfg), TRAIN_STEPS, log_fn=None)
        card_model = build_model(cfg, device="cuda")
        # B5 and B5' launch once a mamba layer and step
        n_mamba = getattr(card_model, "n_periods", 0) * sum(
            d[0] == "mamba" for d in getattr(card_model, "period_descs", ()))
        reset(kernels)
        card = Trainer(card_model, params=params, **kw)
        batches, forced = _train_batches(cfg), []
        for _, batch in zip(range(TRAIN_STEPS), _train_batches(cfg)):
            if arch in FORCED_ARCHS:  # the port at the card's weights
                forced.append(_port_metrics(cpu_model, card.state.params,
                                            batch))
            card.fit(batches, 1, log_fn=None)
        got = card.history
        entries = {k.name: {e: n for e, n in k.entry_launches.items() if n}
                   for k in kernels if k.name in ("flash_attention",
                                                  "flash_attention_backward",
                                                  "selective_scan")}
        # f32 at the split-TF32 backward's head dims: its entry after the
        # *_lse forward; elsewhere the CUDA-core backward after the served
        # forward (the GQA head dim: MLA's nope + rope, V padded to it)
        hd = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
              if cfg.mla else cfg.resolved_head_dim)
        bwd = fops.flash_backward_entry((torch.float32,), hd, hd)
        fwd = fops.flash_entry(torch.float32, hd)
        fwd = fops.LSE_ENTRIES[fwd] if bwd in fops.LSE_BACKWARDS else fwd
        check(not entries["flash_attention_backward"] or (
            set(entries["flash_attention_backward"]) == {bwd}
            and set(entries["flash_attention"]) == {fwd}),
              f"[train] {arch} smoke (head dim {hd}): entries {entries}, "
              f"want {bwd} after {fwd}")
        check(entries["selective_scan"] == (
            {"selective_scan_ckpt_f32": n_mamba * TRAIN_STEPS}
            if n_mamba else {}), f"[train] {arch} smoke: B5 entries {entries}")
        launches = _tally(kernels, acc)
        check(launches["selective_scan_backward"] == n_mamba * TRAIN_STEPS,
              f"[train] {arch} smoke: launches {launches}")
        errs = _rel_errs(got, forced if arch in FORCED_ARCHS else want)
        check(max(errs) <= TRAIN_RTOL,
              f"[train] {arch} smoke: card vs cpu relative errors {errs}")
        if arch in FORCED_ARCHS:
            _log_forced(arch, cfg, params, kw, got, want)
        check(all(launches[n] > 0 for n in path)
              and all(launches[n] == 0 for n in train_kernels
                      if n not in path),
              f"[train] {arch} smoke: launches {launches}")
        log(f"[train] {arch} smoke (f32, {TRAIN_STEPS} steps, 4 x 64 "
            f"tokens): card vs cpu loss "
            f"{[round(g['loss'], 5) for g in got]} vs "
            f"{[round(w['loss'], 5) for w in want]}, largest relative error "
            f"(loss, grad norm) {max(errs):.2e} (tol {TRAIN_RTOL}); "
            f"launches { {n: c for n, c in launches.items() if c} }; B2/B5 "
            f"entries {entries}")
    # the loop ends on jamba; again under remat: each period checkpointed,
    # so its forward (and the twin) runs twice a step; B5' has no atomics,
    # the losses must not move
    check(arch == "jamba-v0.1-52b" and n_mamba == 7,
          f"[train] the remat run needs jamba's smoke stack, not {arch}")
    reset(kernels)
    remat = Trainer(build_model(cfg, device="cuda", remat=True),
                    params=params, **kw).fit(_train_batches(cfg), TRAIN_STEPS,
                                             log_fn=None)
    launches = _tally(kernels, acc)
    check(launches["selective_scan"] == 2 * n_mamba * TRAIN_STEPS
          and launches["selective_scan_backward"] == n_mamba * TRAIN_STEPS,
          f"[train] {arch} smoke --remat: launches {launches}")
    check([r["loss"] for r in remat] == [g["loss"] for g in got],
          f"[train] {arch} smoke --remat losses {remat} against {got}")
    log(f"[train] {arch} smoke with remat: losses equal the plain card "
        f"run's bit for bit; B5 {launches['selective_scan']} twin launches "
        f"(twice a mamba layer and step), B5' "
        f"{launches['selective_scan_backward']}")


def phase_train(kernels, acc, card: str) -> None:
    """Phase 17(b): ``python -m repro_torch.launch.train --arch
    smollm-360m --steps 30 --batch 8 --seq 512`` in process, at full
    width and depth (32 layers, bf16, random weights from seed 0; no
    cut), with ``--ckpt-dir`` under a temporary directory.  Finite loss
    at every step, the last 5 steps' mean below the first 5's; B2's
    forward (only ``flash_attention_bf16_mma_lse``) and its backward (only
    ``flash_attention_backward_bf16_mma``) launch once a layer and step;
    the checkpoint restores bit for bit.  Logged: ms per step, training
    tokens/s (steps 1-29's tokens over their summed time), peak memory,
    and a trace of one more step (busy share, the kernels that take the
    device time, the backward's kernels and their share).  Then the same
    run with ``--remat``: B2's forward launches twice a layer and step
    (the recompute), the same entries, every loss equal to the plain
    run's bit for bit (the backward has no atomics), and the peak memory
    is lower."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.data import TokenStream
    from repro_torch.launch import train as launch_train
    from repro_torch.tree import tree_leaves
    steps, B, S = FULL_TRAIN["steps"], FULL_TRAIN["batch"], FULL_TRAIN["seq"]
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        t0 = time.perf_counter()
        trainer = launch_train.main(
            ["--arch", "smollm-360m", "--steps", str(steps), "--batch",
             str(B), "--seq", str(S), "--ckpt-dir", ckpt,
             "--log-every", "5"])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_served_by(kernels, "flash_attention",
                        "flash_attention_bf16_mma_lse", "train")
        check_served_by(kernels, "flash_attention_backward",
                        "flash_attention_backward_bf16_mma", "train")
        launches = _tally(kernels, acc)
        L = trainer.model.cfg.n_layers
        check(launches["flash_attention"] == L * steps
              and launches["flash_attention_backward"] == L * steps
              and all(launches[n] == 0 for n in ATTN_KERNELS
                      if n != "flash_attention"),
              f"[train] smollm-360m launches {launches}")
        losses = [h["loss"] for h in trainer.history]
        check(all(np.isfinite(losses)) and np.mean(losses[-5:])
              < np.mean(losses[:5]),
              f"[train] smollm-360m losses {losses}")
        params = trainer.state.params
        back = restore_checkpoint(ckpt, steps, params)
        same = all(torch.equal(a.detach().view(torch.int16),
                               b.view(torch.int16))
                   for a, b in zip(tree_leaves(params), tree_leaves(back)))
        check(same, "[train] the checkpoint does not restore bit for bit")
    times = [h["step_time_s"] for h in trainer.history[1:]]
    n_params = sum(p.numel() for p in tree_leaves(params))
    log(f"[train] smollm-360m full width and depth ({L} layers, "
        f"{n_params / 1e6:.1f}M bf16 parameters), {steps} steps of {B} x "
        f"{S} tokens through the launcher in {wall:.1f}s: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (first 5 mean "
        f"{np.mean(losses[:5]):.4f}, last 5 {np.mean(losses[-5:]):.4f}); "
        f"{B * S * len(times) / sum(times):.0f} training tokens/s (steps "
        f"1-{steps - 1}: {sum(times):.3f} s in all), per step median "
        f"{np.median(times) * 1e3:.2f} ms, max {max(times) * 1e3:.2f} ms "
        f"(step 0 {trainer.history[0]['step_time_s'] * 1e3:.1f} ms); peak "
        f"memory {peak:.2f} GiB; B2 {launches['flash_attention']} forward "
        f"launches (`_mma_lse`), {launches['flash_attention_backward']} "
        f"backward (`_bf16_mma`); the checkpoint restores bit for bit; "
        f"{card}")
    stream = TokenStream(trainer.model.cfg.vocab_size, S, B, seed=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(stream, 1, log_fn=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report_trace(prof, wall, 1, "train", f"one training step of {B} x {S} "
                  f"tokens")
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()]
    busy = sum(us for _, us in rows)
    bwd = {kind: sum(us for key, us in rows
                     if "bwd_mma" in key and kind in key)
           for kind in BWD_MMA_KERNELS}
    check(not any("flash_bwd" in key for key, _ in rows),
          "[train] the CUDA-core backward ran in the bf16 step")
    fwd = sum(us for key, us in rows if "prefill_mma" in key)
    log(f"[train] B2's backward kernels (bwd_mma::delta/dq/dkdv) "
        f"{sum(bwd.values()) / 1e3:.2f} ms = "
        f"{100 * sum(bwd.values()) / busy:.1f}% of the step's device time ("
        + ", ".join(f"{k} {us / 1e3:.2f}" for k, us in bwd.items() if us)
        + f"), its forward {fwd / 1e3:.2f} ms = {100 * fwd / busy:.1f}%; "
        f"{card}")
    _tally(kernels, {})
    del trainer, params, back, prof
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    remat = launch_train.main(
        ["--arch", "smollm-360m", "--steps", str(steps), "--batch", str(B),
         "--seq", str(S), "--log-every", str(steps), "--remat"])
    peak_r = torch.cuda.max_memory_allocated() / 2**30
    check_served_by(kernels, "flash_attention",
                    "flash_attention_bf16_mma_lse", "train --remat")
    check_served_by(kernels, "flash_attention_backward",
                    "flash_attention_backward_bf16_mma", "train --remat")
    launches_r = _tally(kernels, {})
    losses_r = [h["loss"] for h in remat.history]
    check(remat.model.remat and launches_r["flash_attention"] == 2 * L * steps
          and launches_r["flash_attention_backward"] == L * steps,
          f"[train] --remat launches {launches_r}")
    check(losses_r == losses,
          f"[train] --remat losses {losses_r} against {losses}")
    check(peak_r < peak, f"[train] --remat peak {peak_r:.2f} GiB, plain "
          f"{peak:.2f}")
    times_r = [h["step_time_s"] for h in remat.history[1:]]
    log(f"[train] smollm-360m --remat (each of the {L} periods "
        f"checkpointed), the same {steps} steps: losses equal bit for bit; "
        f"{B * S * len(times_r) / sum(times_r):.0f} training tokens/s, "
        f"per step median {np.median(times_r) * 1e3:.2f} ms; peak memory "
        f"{peak_r:.2f} GiB against {peak:.2f}; B2 "
        f"{launches_r['flash_attention']} forward launches (the recompute "
        f"twice), {launches_r['flash_attention_backward']} backward; "
        f"{card}")


JAMBA_TRAIN = dict(steps=3, batch=8, seq=512, lr=1e-2)    # phase 17(c)


def jamba_train_step(model, params, leaves, batch, lr: float):
    """One step of phase 17(c): ``model.loss``, the gradients of every
    leaf, then plain SGD in place (``p.add_(g, alpha=-lr)``, no optimizer
    state).  Returns (loss, gradients, seconds of forward and backward)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    fb = time.perf_counter() - t0
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            if g is not None:
                p.add_(g, alpha=-lr)
    return loss.detach(), grads, fb


def jamba_trainer(pkg: str = "repro_torch"):
    """Phase 17(c)'s model from the port package importable as ``pkg``
    (kernel_ab.py builds another checkout's the same way): jamba-v0.1,
    one period at full width, through ``sgd_trainer`` with
    ``JAMBA_TRAIN``'s batches.  Returns (cfg, model, params, leaves,
    batch)."""
    return sgd_trainer("jamba-v0.1-52b", 8, JAMBA_TRAIN["batch"],
                       JAMBA_TRAIN["seq"], pkg)


def train_step_shares(prof) -> tuple:
    """A traced training step's device time (ms) and that of B5''s scan,
    its sum of the partials and B5's twin (ms each)."""
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()]
    share = {name: sum(us for key, us in rows if pat in key) / 1e3
             for name, pat in (("B5' scan", "scan_backward_kernel"),
                               ("B5' sum", "scan_backward_reduce"),
                               ("B5 twin", "selective_scan_kernel"))}
    return sum(us for _, us in rows) / 1e3, share


def phase_train_jamba(kernels, acc, card: str) -> None:
    """Phase 17(c): jamba-v0.1 at full width, one period (phase 6's
    model: 8 layers, 1 attention + 7 mamba, 4 MoE of 16 experts top-2;
    bf16, random weights from seed 0 made on the card) trains
    ``JAMBA_TRAIN["steps"]`` steps on 8 x 512-token ``TokenStream``
    batches: ``model.loss``, the gradients of every leaf, plain SGD in
    place (the port's AdamW holds ~16 bytes a parameter, ~213 GB for the
    period's 13.30B, more than one card).  Checks: every loss and
    gradient finite, the loss falling; B5 through its checkpointing twin
    and B5' once a mamba layer and step, B2 (``_mma_lse``) and B2'
    (``_bf16_mma``) once a step, B6 once a MoE layer and step.  Logged:
    training tokens/s of forward plus backward, ms a step, peak memory;
    a trace of one more step (busy share, B5''s share, the top device
    operations); then layer 0's scan operands and the gradient that
    reached its y, captured in step 0, through B5' against its plain
    version."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssm_scan import ops as sops
    steps, B, S, lr = (JAMBA_TRAIN[k] for k in ("steps", "batch", "seq",
                                                "lr"))
    t0 = time.perf_counter()
    cfg, model, params, leaves, batch = jamba_trainer()
    descs = model.period_descs
    n_mamba = model.n_periods * sum(d[0] == "mamba" for d in descs)
    n_attn = model.n_periods * sum(d[0] == "attn" for d in descs)
    n_moe = model.n_periods * sum(d[1] == "moe" for d in descs)
    torch.cuda.synchronize()
    log(f"[train-jamba] {cfg.arch_id} one period at full width ({descs}): "
        f"{sum(p.numel() for p in leaves) / 1e9:.2f}B bf16 parameters made "
        f"on the card in {time.perf_counter() - t0:.1f}s; {steps} steps of "
        f"{B} x {S} tokens, SGD lr {lr}")

    # layer 0's scan operands and the gradient that reaches its y
    captured = {}
    served_scan = sops.selective_scan

    def keep_dy(g):
        captured["dy"] = g.detach()

    def capture(*a):
        out = served_scan(*a)
        if not captured:
            captured["ops"] = [t.detach() for t in a]
            out[0].register_hook(keep_dy)
        return out

    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    losses, fb_s, step_s, unused = [], [], [], 0
    for step in range(steps):
        t0 = time.perf_counter()
        sops.selective_scan = capture if step == 0 else served_scan
        try:
            loss, grads, fb = jamba_train_step(model, params, leaves, batch(),
                                               lr)
        finally:
            sops.selective_scan = served_scan
        finite = torch.stack([torch.isfinite(loss)] + [
            torch.isfinite(g).all() for g in grads if g is not None]).all()
        losses.append(loss.item())
        check(bool(finite.item()), f"[train-jamba] step {step}: a non-finite "
              f"loss or gradient (loss {losses[-1]})")
        unused = sum(g is None for g in grads)
        del grads
        torch.cuda.synchronize()
        fb_s.append(fb)
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_served_by(kernels, "selective_scan", "selective_scan_ckpt_bf16",
                    "train-jamba")
    check_served_by(kernels, "flash_attention",
                    "flash_attention_bf16_mma_lse", "train-jamba")
    check_served_by(kernels, "flash_attention_backward",
                    "flash_attention_backward_bf16_mma", "train-jamba")
    launches = _tally(kernels, acc)
    want = {"selective_scan": n_mamba, "selective_scan_backward": n_mamba,
            "flash_attention": n_attn, "flash_attention_backward": n_attn,
            "gating_topk": n_moe}
    check(all(launches[n] == c * steps for n, c in want.items())
          and all(c == 0 for n, c in launches.items() if n not in want),
          f"[train-jamba] launches {launches}, want {want} a step")
    check(losses[-1] < losses[0], f"[train-jamba] losses {losses}")
    tok_s = B * S * (steps - 1) / sum(fb_s[1:])
    log(f"[train-jamba] losses {[round(x, 4) for x in losses]} (finite, "
        f"falling), every gradient finite ({unused} leaves the loss does "
        f"not reach); forward + backward {[round(x * 1e3, 1) for x in fb_s]} "
        f"ms = {tok_s:.0f} training tokens/s (steps 1-{steps - 1}), a step "
        f"with SGD {[round(x * 1e3, 1) for x in step_s]} ms; peak memory "
        f"{peak:.2f} GiB; launches a step "
        f"{ {n: launches[n] // steps for n in want} }; {card}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, grads, _ = jamba_train_step(model, params, leaves, batch(), lr)
        del grads
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _tally(kernels, {})
    _report_trace(prof, wall, 1, "train-jamba",
                  f"one training step of {B} x {S} tokens (SGD)")
    busy, share = train_step_shares(prof)
    log(f"[train-jamba] device time a step {busy:.2f} ms: "
        + ", ".join(f"{n} {ms:.2f} ms = {100 * ms / busy:.1f}%"
                    for n, ms in share.items()) + f"; {card}")
    # layer 0's operands through B5' against the plain version
    ops_in, dy = captured["ops"], captured["dy"].float().contiguous()
    tag = (f"[train-jamba] layer 0's scan operands (B={B} T={S} di "
           f"{cfg.d_inner} N {cfg.ssm.d_state}, Bc/Cc views at ldbc "
           f"{ops_in[2].stride(1)})")
    _, _, err, worst = scan_backward_check(ops_in, dy, None, tag)
    _tally(kernels, {})
    log(f"{tag}: B5' against its plain version, max_abs_err {err:.3e}, "
        f"worst error {worst:.3f} x its tolerance, two launches equal")
    del params, leaves, model, captured, ops_in, dy, prof


# -- phase 18 -------------------------------------------------------------------

def _rank_launches(kernels) -> dict:
    """{kernel: {rank: {C entry: launches}}} since the last reset."""
    out: dict = {}
    for k in kernels:
        for (r, e), n in sorted(k.rank_launches.items()):
            out.setdefault(k.name, {}).setdefault(r, {})[e] = n
    return out


def _tally_ranks(kernels, acc, by_rank) -> None:
    """Add this run's launches to ``acc`` and, per rank, to ``by_rank``
    (phase 18's totals)."""
    for k in kernels:
        acc[k.name] = acc.get(k.name, 0) + k.launches
    for name, ranks in _rank_launches(kernels).items():
        for r, entries in ranks.items():
            by_rank.setdefault(name, {}).setdefault(r, 0)
            by_rank[name][r] += sum(entries.values())


def _check_each_rank(kernels, names, n_ranks: int, tag: str) -> dict:
    by_rank = _rank_launches(kernels)
    for name in names:
        got = by_rank.get(name, {})
        check(all(sum(got.get(r, {}).values()) > 0 for r in range(n_ranks)),
              f"[{tag}] {name} did not launch on every rank: {got}")
    log(f"[{tag}] launches by rank and C entry: {by_rank}")
    return by_rank


def _one_device_launches(kernels, names, tag: str) -> dict:
    """{kernel: {C entry: launches}} of the engine without a mesh since
    the last reset, logged."""
    out = {k.name: {e: n for e, n in k.entry_launches.items() if n}
           for k in kernels if k.name in names}
    log(f"[{tag}] without a mesh, launches by C entry: {out}")
    return out


def _check_as_one_device(by_rank, one: dict, tag: str) -> None:
    """Every rank launched each kernel, entry by entry, as often as the
    engine without a mesh did (the same steps, each rank on its shard)."""
    for name, entries in one.items():
        check(all(by_rank.get(name, {}).get(r) == entries for r in (0, 1)),
              f"[{tag}] {name}: ranks {by_rank.get(name)} vs one device "
              f"{entries}")


def _serve_traced(eng, prompts):
    """Serve ``prompts`` direct on a fresh engine; returns ({rid:
    tokens}, wall s)."""
    t0 = time.perf_counter()
    res = eng.serve(prompts, timeout_s=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(r.status == "ok" for r in res),
          f"mesh serve: {[r.status for r in res]}")
    return {r.request_id: np.asarray(r.tokens) for r in res}, wall


def _logit_gap(a_trace, b_trace, first_only: bool):
    """Largest |logit difference| over two engines' logit traces (the
    first step of each request, or every step), and the largest |logit|."""
    gap = top = 0.0
    for rid, ta in a_trace.items():
        tb = b_trace[rid]
        for x, y in list(zip(ta, tb))[:1 if first_only else None]:
            gap = max(gap, float(np.abs(x - y).max()))
            top = max(top, float(np.abs(x).max()))
    return gap, top


def _bytes(tree) -> int:
    return sum(a.numel() * a.element_size() for a in _leaves(tree))


def phase_mesh_small(kernels, acc, by_rank) -> None:
    """18(a): the launcher's four f32 families over a two-rank mesh on
    the card, against the card without a mesh and the CPU port's
    two-rank mesh."""
    from repro_torch import bridge
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve import FAMILY_CONFIGS
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    kw = dict(batch_size=2, capacity=64, max_new_tokens=8, block_size=4,
              prefill_chunk=4)
    for family, cfg in FAMILY_CONFIGS.items():
        rng = np.random.default_rng(18)
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                   for n in (4, 12, 6, 11, 8)]
        cpu_model = build_model(cfg, device="cpu")
        cpu_params = cpu_model.init(seed=0)
        want = ServeEngine(cpu_model, cpu_params, device="cpu",
                           mesh=make_serving_mesh(2, ["cpu"] * 2),
                           **kw).serve(prompts)
        gpu_model = build_model(cfg, device="cuda")
        gpu_params = bridge.to_torch(cpu_params, "cuda")
        single = ServeEngine(gpu_model, gpu_params, device="cuda",
                             **kw).serve(prompts)
        reset(kernels)
        eng = ServeEngine(gpu_model, gpu_params,
                          mesh=make_serving_mesh(2, ["cuda:0"] * 2), **kw)
        got = eng.serve(prompts)
        torch.cuda.synchronize()
        for a, b, c in zip(want, single, got):
            check(c.status == "ok", f"[mesh {family}] {c.status}")
            check(np.array_equal(a.tokens, c.tokens)
                  and np.array_equal(b.tokens, c.tokens),
                  f"[mesh {family}] request {c.request_id}: cpu mesh "
                  f"{a.tokens}, card {b.tokens}, card mesh {c.tokens}")
        path = {"transformer": PAGED_KERNELS, "mamba": ("selective_scan",),
                "xlstm": (), "hybrid": PAGED_KERNELS + ("selective_scan",)}
        _check_each_rank(kernels, path[family], 2, f"mesh {family}")
        _tally_ranks(kernels, acc, by_rank)
        log(f"[mesh] {family}: {len(prompts)} requests, two-rank mesh "
            "tokens on the card == the card without a mesh == the CPU "
            "port's two-rank mesh")


def phase_mesh(kernels, acc, by_rank, card: str) -> None:
    """18(b) and (c): smollm-360m at full width, f32 then bf16, and one
    jamba-v0.1 period, each over a two-rank mesh on the card against
    the engine without a mesh."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    mesh = make_serving_mesh(2, ["cuda:0"] * 2)

    # (b) smollm-360m, f32 then bf16
    rng = np.random.default_rng(18)
    kw = dict(batch_size=8, capacity=512 + 32 + 8, max_new_tokens=32,
              prefill_chunk=32, block_size=16, burst=8, trace_logits=True)
    for dt, tol in (("f32", MESH_F32_TOL), ("bf16", MESH_BF16_TOL)):
        cfg = get_config("smollm-360m")
        if dt == "f32":
            cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
        model = build_model(cfg, device="cuda")
        params = model.init(seed=0)
        prompts = [rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
                   for _ in range(8)]
        tag = f"mesh smollm {dt}"
        reset(kernels)
        ref = ServeEngine(model, params, kv_dtype=dt, device="cuda", **kw)
        want, wall0 = _serve_traced(ref, prompts)
        one = _one_device_launches(kernels, PAGED_KERNELS, tag)
        ref_trace, ref_pool = ref.logit_trace, _bytes(ref._paged_cache)
        del ref
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        eng = ServeEngine(model, params, kv_dtype=dt, mesh=mesh, **kw)
        got, wall = _serve_traced(eng, prompts)
        ranks = _check_each_rank(kernels, PAGED_KERNELS, 2, tag)
        _check_as_one_device(ranks, one, tag)
        if dt == "bf16":
            # each rank's group (9/3 and 6/2 heads) is the model's (15/5)
            k1 = dops.decode_entry(
                "paged_decode_attention", torch.bfloat16, torch.bfloat16,
                cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim)
            for name, entry in (("paged_prefill_attention",
                                 "paged_prefill_attention_bf16_bf16_mma"),
                                ("paged_decode_attention", k1)):
                check(all(set(ranks[name][r]) == {entry} for r in (0, 1)),
                      f"[{tag}] {name} entries {ranks[name]}")
        _tally_ranks(kernels, acc, by_rank)
        gap, top = _logit_gap(ref_trace, eng.logit_trace,
                              first_only=(dt == "bf16"))
        total = sum(len(t) for t in got.values())
        agree = sum(int((got[i] == want[i]).sum()) for i in want)
        check(gap <= tol * top, f"[{tag}] logits differ by {gap:.3e}, "
              f"{gap / top:.2e} of the largest |logit| {top:.2f} > {tol}")
        if dt == "f32":
            check(agree == total, f"[{tag}] {agree}/{total} tokens equal")
        w_rank = [_bytes(p) for p in eng.params]
        pool_rank = [_bytes(c) for c in eng._paged_cache]
        log(f"[{tag}] {card}: smollm-360m full width (32 layers, d 960, "
            f"heads 9/3 and 6/2 a rank, vocab 49152 split), 8 x 512-token "
            f"prompts, 32 new: mesh 2 {total / wall:.1f} tok/s vs "
            f"{total / wall0:.1f} without a mesh (direct; the two ranks "
            f"share the card's SMs); logits "
            f"{'first step' if dt == 'bf16' else 'every step'} within "
            f"{gap:.3e} = {gap / top:.2e} of the largest |logit| "
            f"{top:.2f} (gate {tol}); greedy tokens equal "
            f"{agree}/{total} ({100 * agree / total:.1f}%"
            f"{'' if dt == 'f32' else ', logged, not gated'}); peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"weights per rank {[round(b / 2**20, 1) for b in w_rank]} MiB "
            f"of {_bytes(params) / 2**20:.1f}, pool per rank "
            f"{[round(b / 2**20, 1) for b in pool_rank]} MiB of "
            f"{ref_pool / 2**20:.1f}")
        del eng, model, params
        gc.collect()
        torch.cuda.empty_cache()

    # (c) jamba-v0.1, one period at full width: its bf16 weights computing
    # in f32 (routes and all: tokens equal), then in bf16 with every
    # expert a copy of expert 0 and no capacity drops, so that a top-2
    # route flipped by bf16 rounding moves no output (MESH_BF16_TOL)
    t0 = time.perf_counter()
    cfg = get_config("jamba-v0.1-52b").replace(n_layers=8)
    params = build_model(cfg, device="cuda").init(seed=0)
    whole = _bytes(params)
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
               for _ in range(4)]
    kw = dict(batch_size=4, capacity=128 + 16 + 8, max_new_tokens=16,
              prefill_chunk=32, block_size=16, burst=8, num_state_slots=4,
              trace_logits=True)
    # capacity per expert ceil(32 * 2 / 16 * 8) = 32 = the chunk: dropless
    dropless = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                   capacity_factor=8.0))
    for compute, kv, scan, run_cfg in (
            ("float32", "f32", "selective_scan_slab_f32", cfg),
            ("bfloat16", "bf16", "selective_scan_slab_bf16", dropless)):
        f32 = kv == "f32"
        if not f32:
            with torch.no_grad():
                for sub in params["blocks"].values():
                    for name in ("w_gate", "w_up", "w_down"):
                        if "moe" in sub:
                            w = sub["moe"][name]    # (periods, E, ...)
                            w[:, 1:].copy_(w[:, :1].expand_as(w[:, 1:]))
        model = build_model(run_cfg.replace(compute_dtype=compute),
                            device="cuda")
        tag = f"mesh jamba {kv}"
        reset(kernels)
        ref = ServeEngine(model, params, kv_dtype=kv, device="cuda", **kw)
        want, wall0 = _serve_traced(ref, prompts)
        paths = PAGED_KERNELS + ("selective_scan", "gating_topk")
        one = _one_device_launches(kernels, paths, tag)
        ref_trace = ref.logit_trace
        del ref
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset(kernels)
        eng = ServeEngine(model, params, kv_dtype=kv, mesh=mesh, **kw)
        got, wall = _serve_traced(eng, prompts)
        ranks = _check_each_rank(kernels, paths, 2, tag)
        _check_as_one_device(ranks, one, tag)
        check(all(set(ranks["selective_scan"][r]) == {scan} for r in (0, 1)),
              f"[{tag}] B5 entries {ranks['selective_scan']}")
        check([c.d_inner for c in eng.model.rank_cfgs] == [4096, 4096]
              and [p["blocks"]["s1"]["moe"]["w_up"].shape[1]
                   for p in eng.params] == [8, 8],
              f"[{tag}] rank shapes: d_inner "
              f"{[c.d_inner for c in eng.model.rank_cfgs]}")
        _tally_ranks(kernels, acc, by_rank)
        gap, top = _logit_gap(ref_trace, eng.logit_trace, first_only=not f32)
        total = sum(len(t) for t in got.values())
        agree = sum(int((got[i] == want[i]).sum()) for i in want)
        check(np.isfinite(gap) and all(
            0 <= int(t.min()) and int(t.max()) < cfg.vocab_size
            for t in got.values()), f"[{tag}] logits or tokens out of range")
        tol = MESH_F32_TOL if f32 else MESH_BF16_TOL
        check(gap <= tol * top and (agree == total or not f32),
              f"[{tag}] {agree}/{total} tokens equal; logits differ by "
              f"{gap:.3e} = {gap / top:.2e} of the largest |logit| > {tol}")
        log(f"[{tag}] {card}: one period (8 layers), bf16 weights, "
            f"{compute} compute"
            f"{'' if f32 else ', experts tied to expert 0, dropless'}, "
            f"d_inner 4096 and 8 of 16 experts a rank, 4 x 128-token "
            f"prompts, 16 new: mesh 2 {total / wall:.1f} tok/s vs "
            f"{total / wall0:.1f} without a mesh; logits "
            f"{'every step' if f32 else 'first step'} within {gap:.3e} = "
            f"{gap / top:.2e} of the largest |logit| {top:.2f} (gate "
            f"{tol}); tokens equal {agree}/{total}"
            f"{'' if f32 else ' (logged, not gated)'}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; weights "
            f"per rank {[round(_bytes(p) / 2**30, 2) for p in eng.params]} "
            f"GiB of {whole / 2**30:.2f}")
        del eng, model
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mesh jamba] phase (c) {time.perf_counter() - t0:.1f}s")

    # the launcher over a one-device mesh
    out = serve.main(["--smoke", "--mesh", "1", "--requests", "4",
                      "--batch", "2", "--max-new", "4", "--direct"])
    check(out["n_results"] == 4 and out["engine"].model.mesh.size == 1,
          f"launch.serve --mesh 1: {out['n_results']} results")
    log("[mesh] launch.serve --smoke --mesh 1 served 4 requests on the card")


# -- phase 19 -------------------------------------------------------------------

NEMOTRON_LAYERS = 4     # 19(a)-(c): 4 of 96 layers, ~23.25B parameters
NEMOTRON_NEW = 32
# 19(d): 1 of 96 layers (~12.9B), 3 SGD steps of 4 x 512 tokens
NEMOTRON_TRAIN = dict(layers=1, steps=3, batch=4, seq=512, lr=1e-3)


def nemotron_prompts(vocab_size: int):
    """Phase 19's 8 requests of ``NEMOTRON_CTX`` prompt tokens."""
    rng = np.random.default_rng(19)
    return [rng.integers(0, vocab_size, NEMOTRON_CTX).astype(np.int32)
            for _ in range(8)]


def _serve_nemotron(kernels, eng, prompts, tag: str, card: str,
                    new: int = NEMOTRON_NEW):
    """Serve the prompts (their ``new`` tokens each, direct): every
    request ok, its tokens in the vocab; tok/s, TTFT and peak memory
    logged.  The launch counts are reset before.  Returns the results."""
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    res = eng.serve(prompts, timeout_s=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vocab = eng.model.cfg.vocab_size
    check(all(r.status == "ok" and len(r.tokens) == new
              and 0 <= int(r.tokens.min()) and int(r.tokens.max()) < vocab
              for r in res),
          f"[{tag}] {[(r.status, len(r.tokens)) for r in res]}")
    ttft = sorted(r.ttft_s for r in res)
    n_tok = sum(len(r.tokens) for r in res)
    log(f"[{tag}] served {len(res)} x {len(prompts[0])}-token prompts, "
        f"{new} new: {n_tok} tokens in {wall:.2f}s = "
        f"{n_tok / wall:.1f} tok/s (direct); TTFT p50 "
        f"{1e3 * ttft[len(ttft) // 2]:.1f} ms, max {1e3 * ttft[-1]:.1f} "
        f"ms; {eng.n_device_steps} device steps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    return res


def phase_nemotron(kernels, acc, card: str) -> None:
    """Phase 19: nemotron-4-340b at full width (d 18432, 96/8 heads of
    192, layernorm, squared ReLU, rotary on half of each head, d_ff 73728,
    vocab 256000 with an untied head; bf16) cut to ``NEMOTRON_LAYERS`` of
    its 96 layers (random weights made on the card from seed 0).  (a) The
    paged engine (bf16 pool, batch 8, chunk 32, burst 8) serves 8
    requests of 512 tokens, 32 new: K2 only through
    ``paged_prefill_attention_bf16_bf16_mma`` (the tensor-core body at
    192) once a layer and mixed step, K1 once a layer and decode step;
    then a trace.  (b) The dense engine on the same prompts: B2 through
    ``flash_attention_bf16_mma`` once a layer (one prefill wave), B4 once
    a layer and decode step; layer 0's q, k, v captured from the wave.
    (c) B2 and B2' on those operands against their plain versions, timed.
    (d) is ``phase_train_nemotron``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    L = NEMOTRON_LAYERS
    t0 = time.perf_counter()
    cfg = get_config("nemotron-4-340b").replace(n_layers=L)
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[nemotron] {cfg.arch_id} full width, {L} of 96 layers: d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, {cfg.norm}, {cfg.mlp_act}, rope_pct "
        f"{cfg.rope_pct}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (head "
        f"untied: {not cfg.tie_embeddings}), bf16: {n_params / 1e9:.2f}B "
        f"parameters made on the card in {time.perf_counter() - t0:.1f}s")
    prompts = nemotron_prompts(cfg.vocab_size)
    kw = dict(batch_size=8, capacity=NEMOTRON_CAP,
              max_new_tokens=NEMOTRON_NEW, burst=8, kv_dtype="bf16",
              device="cuda")

    # (a) paged
    eng = ServeEngine(model, params, prefill_chunk=32, block_size=16, **kw)
    check(eng.paged, "[nemotron-paged] the engine is not paged")
    _serve_nemotron(kernels, eng, prompts, "nemotron-paged", card)
    check_serving_launches(kernels, "nemotron-paged")
    check_served_by(kernels, "paged_prefill_attention",
                    "paged_prefill_attention_bf16_bf16_mma", "nemotron-paged")
    check_served_by(kernels, "paged_decode_attention",
                    "paged_decode_attention_bf16_bf16_mma", "nemotron-paged")
    mixed, steps = eng.n_prefill_chunks, eng.n_device_steps
    launches = _tally(kernels, acc)
    want = {"paged_prefill_attention": L * mixed,
            "paged_decode_attention": L * (steps - mixed)}
    check(all(launches[n] == want.get(n, 0) for n in launches),
          f"[nemotron-paged] launches {launches}, want {want} ({L} layers, "
          f"{mixed} mixed and {steps - mixed} decode steps)")
    log(f"[nemotron-paged] launches {want}: {L} layers x {mixed} mixed "
        f"steps (K2) and x {steps - mixed} decode steps (K1)")
    phase_trace(eng, "nemotron-paged", n=8, prompt_len=NEMOTRON_CTX)
    reset(kernels)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # (b) dense, layer 0's B2 operands captured from the prefill wave
    eng = ServeEngine(model, params, paged=False, **kw)
    check(not eng.paged, "[nemotron-dense] the engine is paged")
    captured = {}
    served_flash = fops.flash_attention

    def capture(q, k, v, **kwargs):
        if not captured:
            captured["qkv"] = (q, k, v)
        return served_flash(q, k, v, **kwargs)
    fops.flash_attention = capture
    try:
        _serve_nemotron(kernels, eng, prompts, "nemotron-dense", card)
    finally:
        fops.flash_attention = served_flash
    check_serving_launches(kernels, "nemotron-dense")
    check_served_by(kernels, "flash_attention", "flash_attention_bf16_mma",
                    "nemotron-dense")
    check_served_by(kernels, "decode_attention",
                    "decode_attention_bf16_bf16_mma", "nemotron-dense")
    launches = _tally(kernels, acc)
    want = {"flash_attention": L, "decode_attention": L * (NEMOTRON_NEW - 1)}
    check(all(launches[n] == want.get(n, 0) for n in launches),
          f"[nemotron-dense] launches {launches}, want {want} (one wave)")
    log(f"[nemotron-dense] launches {want}: B2 once a layer, B4 once a "
        f"layer and decode step")
    del eng, model, params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) layer 0's served operands through B2 and B2'
    # (copies made outside the engine's inference mode, so that autograd
    # may take them)
    _nemotron_served_kernels(fops, *(t.clone() for t in captured.pop("qkv")))


def _nemotron_served_kernels(fops, q, k, v) -> None:
    """Phase 19(c): B2 (``flash_attention_bf16_mma``) and B2' (the
    ``*_lse`` forward, then ``flash_attention_backward_bf16_mma``) on
    layer 0's q, k, v from 19(b)'s prefill wave (B = 8, S = 512, causal)
    and a seeded random dout, against their plain versions with phase 3's
    tolerances, each launch's entry checked, then timed.  These launches
    are not the main path's (its counts were read)."""
    B, S, H, hd = q.shape
    timer = Timer()
    tag = (f"[nemotron-served] layer 0's operands: heads {H}/{k.shape[2]} "
           f"hd {hd} B={B} S=T={S} causal {str(q.dtype)[6:]}")
    e0 = dict(fops.FLASH_KERNEL.entry_launches)
    out = fops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    check(fops.FLASH_KERNEL.entry_launches["flash_attention_bf16_mma"]
          == e0["flash_attention_bf16_mma"] + 1,
          f"{tag}: B2 did not launch flash_attention_bf16_mma")
    want = fops.flash_attention_plain(q, k, v, causal=True)
    err = (out.float() - want.float()).abs().max().item()
    tol = DENSE_BF16_TOL["flash_attention"]
    check(torch.isfinite(out.float()).all().item() and err <= tol,
          f"{tag}: B2 max_abs_err {err} > {tol} (largest |out| "
          f"{want.float().abs().max().item():.3f})")
    ms = timer.ms(lambda: fops.flash_attention(q, k, v, causal=True))
    log(f"{tag}: B2 max_abs_err={err:.3e} (tol {tol}; largest |out| "
        f"{want.float().abs().max().item():.3f}), {ms:.4f} ms")
    g = torch.Generator(device="cpu").manual_seed(19)
    dout = torch.randn(q.shape, generator=g).to("cuda", q.dtype)
    before = dict(fops.BACKWARD_KERNEL.entry_launches)
    got = fops.flash_attention_backward(q, k, v, out, dout)
    torch.cuda.synchronize()
    _check_backward_entry(fops, before, "flash_attention_backward_bf16_mma",
                          tag)
    check(all(torch.isfinite(t.float()).all().item() for t in got),
          f"{tag}: non-finite gradients")
    rel = _grad_err(got, fops.flash_attention_backward_plain(
        q, k, v, out, dout))
    tol = GRAD_TOL[torch.bfloat16]
    check(rel <= tol, f"{tag}: B2' relative gradient error {rel} > {tol}")
    _, lse = fops._flash_forward(q, k, v, True, 0, lse=True)
    ms = timer.ms(lambda: fops.flash_attention_backward(q, k, v, out, dout,
                                                        lse=lse))
    log(f"{tag}: B2' relative gradient error {rel:.3e} (tol {tol}), "
        f"{ms:.4f} ms (given the *_lse forward's logsumexp)")


def sgd_trainer(arch: str, n_layers: int, batch_size: int, seq: int,
                pkg: str = "repro_torch"):
    """A model of ``arch`` cut to ``n_layers`` at full width from the
    port package importable as ``pkg``, random bf16 weights made on the
    card from seed 0, its trainable leaves, and batches of ``batch_size``
    x ``seq`` tokens from a seed-0 ``TokenStream``.  Returns (cfg, model,
    params, leaves, batch), ``batch()`` the next batch on the card."""
    configs, models, data, trainer, tree = (
        importlib.import_module(f"{pkg}.{m}") for m in (
            "configs", "models", "data", "training.trainer", "tree"))
    cfg = configs.get_config(arch).replace(n_layers=n_layers)
    model = models.build_model(cfg, device="cuda")
    params = trainer.trainable(model.init(seed=0))
    leaves = [p for p in tree.tree_leaves(params) if p.requires_grad]
    stream = data.TokenStream(cfg.vocab_size, seq, batch_size, seed=0)

    def batch():
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in next(stream).items()}
    return cfg, model, params, leaves, batch


def phase_train_nemotron(kernels, acc, card: str) -> None:
    """Phase 19(d): nemotron-4-340b at full width cut to
    ``NEMOTRON_TRAIN["layers"]`` of 96 layers (~12.9B bf16 parameters, the
    untied embedding and head 9.4B of them; random, seed 0, made on the
    card) trains ``NEMOTRON_TRAIN["steps"]`` steps on 4 x 512-token
    ``TokenStream`` batches: ``model.loss``, the gradients of every leaf,
    plain SGD in place (AdamW's moments, ~16 bytes a parameter, fit no
    card).  Checks: every loss and gradient finite; B2 only through
    ``flash_attention_bf16_mma_lse`` and B2' only through
    ``flash_attention_backward_bf16_mma``, once a layer and step, nothing
    else launched.  Logged: training tokens/s of forward plus backward, ms
    a step, peak memory, a trace of one more step."""
    from torch.profiler import ProfilerActivity, profile
    n_layers, steps, B, S, lr = (NEMOTRON_TRAIN[k] for k in (
        "layers", "steps", "batch", "seq", "lr"))
    held = torch.cuda.memory_allocated()
    log(f"[train-nemotron] {held / 2**30:.2f} GiB held on the card before "
        f"the model is made")
    if held > 2**30:   # what an earlier phase left behind, largest first
        with warnings.catch_warnings():  # isinstance on deprecated names
            warnings.simplefilter("ignore", FutureWarning)
            big = sorted(((o.numel() * o.element_size(), tuple(o.shape),
                           o.dtype) for o in gc.get_objects()
                          if isinstance(o, torch.Tensor) and o.is_cuda),
                         key=lambda r: -r[0])[:8]
        log(f"[train-nemotron] largest live tensors: {big}")
    t0 = time.perf_counter()
    cfg, model, params, leaves, batch = sgd_trainer(
        "nemotron-4-340b", n_layers, B, S)
    torch.cuda.synchronize()
    log(f"[train-nemotron] {cfg.arch_id} full width, {n_layers} of 96 "
        f"layers: {sum(p.numel() for p in leaves) / 1e9:.2f}B bf16 "
        f"parameters made on the card in {time.perf_counter() - t0:.1f}s; "
        f"{steps} steps of {B} x {S} tokens, SGD lr {lr}")
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    losses, fb_s, step_s = [], [], []
    for step in range(steps):
        t0 = time.perf_counter()
        loss, grads, fb = jamba_train_step(model, params, leaves, batch(), lr)
        # in chunks: a bool copy of the 4.7e9-element embedding's gradient
        # would take 4.4 GiB
        finite = torch.stack([torch.isfinite(loss)] + [
            torch.isfinite(c).all() for g in grads if g is not None
            for c in g.view(-1).split(1 << 28)]).all()
        losses.append(loss.item())
        check(bool(finite.item()), f"[train-nemotron] step {step}: a "
              f"non-finite loss or gradient (loss {losses[-1]})")
        unused = sum(g is None for g in grads)
        del grads
        torch.cuda.synchronize()
        fb_s.append(fb)
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_served_by(kernels, "flash_attention",
                    "flash_attention_bf16_mma_lse", "train-nemotron")
    check_served_by(kernels, "flash_attention_backward",
                    "flash_attention_backward_bf16_mma", "train-nemotron")
    launches = _tally(kernels, acc)
    want = {"flash_attention": n_layers * steps,
            "flash_attention_backward": n_layers * steps}
    check(all(launches[n] == want.get(n, 0) for n in launches),
          f"[train-nemotron] launches {launches}, want {want}")
    tok_s = B * S * (steps - 1) / sum(fb_s[1:])
    log(f"[train-nemotron] losses {[round(x, 4) for x in losses]} (finite), "
        f"every gradient finite ({unused} leaves the loss does not reach); "
        f"forward + backward {[round(x * 1e3, 1) for x in fb_s]} ms = "
        f"{tok_s:.0f} training tokens/s (steps 1-{steps - 1}), a step with "
        f"SGD {[round(x * 1e3, 1) for x in step_s]} ms; peak memory "
        f"{peak:.2f} GiB; launches {want}; {card}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, grads, _ = jamba_train_step(model, params, leaves, batch(), lr)
        del grads
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _tally(kernels, {})
    _report_trace(prof, wall, 1, "train-nemotron",
                  f"one training step of {B} x {S} tokens (SGD)")
    del params, leaves, model, prof


# -- phase 20 -------------------------------------------------------------------

F32_TRAIN = dict(steps=10, remat_steps=3, batch=8, seq=512)   # phase 20(a)
# 20(b): nemotron-4-340b in f32, 1 of 96 layers (~12.9B, 51.6 GB), 4
# prompts of NEMOTRON_CTX tokens, 16 new
NEMOTRON_F32 = dict(layers=1, prompts=4, new=16)


def phase_train_f32(kernels, acc, card: str) -> None:
    """Phase 20(a): smollm-360m at full width and depth (32 layers, no
    cut) in f32 (``get_config("smollm-360m")`` with f32 parameters and
    compute; GEMMs in plain f32, TF32 off), random weights from seed 0, a
    ``Trainer`` with AdamW, ``F32_TRAIN["steps"]`` steps of 8 x 512
    ``TokenStream`` tokens.  Checks: B2 only through
    ``flash_attention_f32_tf32_lse`` and B2' only through
    ``flash_attention_backward_f32_tf32`` (the split-TF32 bodies at head
    dim 64), once a layer and step, nothing else launched; every loss
    finite, the last 3 steps' mean below the first 3's.  Logged: ms a
    step, training tokens/s, peak memory, and from a trace of one more
    step B2''s device time and the device's busy share.  Then
    ``F32_TRAIN["remat_steps"]`` steps from the same weights with
    ``remat=True``: the forward twice a layer and step, the losses equal
    the plain run's first ones bit for bit (no atomics in either
    body)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.training import Trainer
    from repro_torch.tree import tree_leaves
    steps, n_remat, B, S = (F32_TRAIN[k] for k in ("steps", "remat_steps",
                                                   "batch", "seq"))
    cfg = get_config("smollm-360m").replace(param_dtype="float32",
                                            compute_dtype="float32")
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=steps)
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    n_params = sum(p.numel() for p in tree_leaves(params))
    L = cfg.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    trainer = Trainer(model, params=params, **kw)
    t0 = time.perf_counter()
    hist = trainer.fit(TokenStream(cfg.vocab_size, S, B, seed=0), steps,
                       log_fn=None)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_served_by(kernels, "flash_attention",
                    "flash_attention_f32_tf32_lse", "train-f32")
    check_served_by(kernels, "flash_attention_backward",
                    "flash_attention_backward_f32_tf32", "train-f32")
    launches = _tally(kernels, acc)
    want = {"flash_attention": L * steps,
            "flash_attention_backward": L * steps}
    check(all(launches[n] == want.get(n, 0) for n in launches),
          f"[train-f32] launches {launches}, want {want}")
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses))
          and np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"[train-f32] losses {losses}")
    times = [h["step_time_s"] for h in hist[1:]]
    log(f"[train-f32] smollm-360m full width and depth ({L} layers, "
        f"{n_params / 1e6:.1f}M f32 parameters, AdamW), {steps} steps of "
        f"{B} x {S} tokens in {wall:.1f}s: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (first 3 mean {np.mean(losses[:3]):.4f}, last 3 "
        f"{np.mean(losses[-3:]):.4f}); {B * S * len(times) / sum(times):.0f} "
        f"training tokens/s (steps 1-{steps - 1}), per step median "
        f"{np.median(times) * 1e3:.2f} ms (step 0 "
        f"{hist[0]['step_time_s'] * 1e3:.1f} ms); peak memory {peak:.2f} "
        f"GiB; launches {want}: B2 through `_f32_tf32_lse`, B2' through "
        f"`_f32_tf32`; {card}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(TokenStream(cfg.vocab_size, S, B, seed=1), 1,
                    log_fn=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _tally(kernels, {})
    _report_trace(prof, wall, 1, "train-f32", f"one f32 training step of "
                  f"{B} x {S} tokens")
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()]
    busy = sum(us for _, us in rows)
    bwd = {kind: sum(us for key, us in rows
                     if "bwd_tf32" in key and kind in key)
           for kind in ("delta_kernel", "dkdv_kernel", "dq_kernel")}
    fwd = sum(us for key, us in rows if "prefill_tf32" in key)
    check(all(bwd.values()) and not any("flash_bwd" in key
                                        for key, _ in rows),
          f"[train-f32] the trace's backward kernels {bwd}, or the "
          f"CUDA-core backward ran")
    log(f"[train-f32] B2's backward (bwd_tf32::delta/dkdv/dq) "
        f"{sum(bwd.values()) / 1e3:.2f} ms = "
        f"{100 * sum(bwd.values()) / busy:.1f}% of the step's device time "
        f"({busy / 1e3:.1f} ms, busy {busy / 1e4 / wall:.1f}% of "
        f"{wall * 1e3:.1f} ms; "
        + ", ".join(f"{k} {us / 1e3:.2f}" for k, us in bwd.items())
        + f"), its forward (the *_lse twin) {fwd / 1e3:.2f} ms = "
        f"{100 * fwd / busy:.1f}%; {card}")
    del trainer, prof
    gc.collect()
    torch.cuda.empty_cache()
    remat = Trainer(build_model(cfg, device="cuda", remat=True),
                    params=params, **kw).fit(
        TokenStream(cfg.vocab_size, S, B, seed=0), n_remat, log_fn=None)
    check_served_by(kernels, "flash_attention",
                    "flash_attention_f32_tf32_lse", "train-f32 remat")
    check_served_by(kernels, "flash_attention_backward",
                    "flash_attention_backward_f32_tf32", "train-f32 remat")
    launches = _tally(kernels, acc)
    check(launches["flash_attention"] == 2 * L * n_remat
          and launches["flash_attention_backward"] == L * n_remat,
          f"[train-f32] remat launches {launches}")
    losses_r = [h["loss"] for h in remat]
    check(losses_r == losses[:n_remat],
          f"[train-f32] remat losses {losses_r} against {losses[:n_remat]}")
    log(f"[train-f32] with remat ({n_remat} steps from the same weights): "
        f"losses equal the plain run's bit for bit; B2 "
        f"{launches['flash_attention']} forward launches (twice a layer "
        f"and step), B2' {launches['flash_attention_backward']}")


def phase_nemotron_f32(kernels, acc, card: str) -> None:
    """Phase 20(b): nemotron-4-340b at full width in f32 (f32 parameters
    and compute, random weights drawn on the card from seed 0) cut to
    ``NEMOTRON_F32["layers"]`` of its 96 layers (~12.9B parameters, 51.6
    GB): 4 of phase 19's 512-token prompts, 16 new tokens each, over f32
    pools.  (a) The paged engine (batch 4, chunk 32, burst 8): K2 only
    through ``paged_prefill_attention_f32_f32_tf32`` (the split-TF32 body
    in 8-warp blocks at 192, G = 12) once a layer and mixed step, K1
    (``paged_decode_attention_f32_f32_tf32``, the split-TF32 decode body)
    once a layer and decode step.
    (b) The dense engine (``paged=False``) on the same prompts: B2 through
    ``flash_attention_f32_tf32`` once a layer, B4
    (``decode_attention_f32_f32_tf32``) once a layer and decode step; layer
    0's q, k, v from the prefill wave through B2 against its plain
    version, within ``TOL[f32]`` of the largest |out| (at least 1).
    tok/s, TTFT and peak memory of each."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    L, n, new = (NEMOTRON_F32[k] for k in ("layers", "prompts", "new"))
    t0 = time.perf_counter()
    cfg = get_config("nemotron-4-340b").replace(
        n_layers=L, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    n_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    log(f"[nemotron-f32] {cfg.arch_id} full width, {L} of 96 layers, f32: "
        f"{n_params / 1e9:.2f}B parameters ({n_bytes / 1e9:.1f} GB) made "
        f"on the card in {time.perf_counter() - t0:.1f}s")
    prompts = nemotron_prompts(cfg.vocab_size)[:n]
    kw = dict(batch_size=n, capacity=NEMOTRON_CTX + new, max_new_tokens=new,
              burst=8, kv_dtype="f32", device="cuda")

    # (a) paged
    eng = ServeEngine(model, params, prefill_chunk=32, block_size=16, **kw)
    check(eng.paged, "[nemotron-f32-paged] the engine is not paged")
    _serve_nemotron(kernels, eng, prompts, "nemotron-f32-paged", card, new)
    check_served_by(kernels, "paged_prefill_attention",
                    "paged_prefill_attention_f32_f32_tf32",
                    "nemotron-f32-paged")
    check_served_by(kernels, "paged_decode_attention",
                    "paged_decode_attention_f32_f32_tf32",
                    "nemotron-f32-paged")
    mixed, steps = eng.n_prefill_chunks, eng.n_device_steps
    launches = _tally(kernels, acc)
    want = {"paged_prefill_attention": L * mixed,
            "paged_decode_attention": L * (steps - mixed)}
    check(all(launches[k] == want.get(k, 0) for k in launches),
          f"[nemotron-f32-paged] launches {launches}, want {want}")
    log(f"[nemotron-f32-paged] launches {want}: {L} layer x {mixed} mixed "
        f"steps (K2) and x {steps - mixed} decode steps (K1)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # (b) dense, layer 0's B2 operands captured from the prefill wave
    eng = ServeEngine(model, params, paged=False, **kw)
    check(not eng.paged, "[nemotron-f32-dense] the engine is paged")
    captured = {}
    served_flash = fops.flash_attention

    def capture(q, k, v, **kwargs):
        if not captured:
            captured["qkv"] = tuple(t.clone() for t in (q, k, v))
        return served_flash(q, k, v, **kwargs)
    fops.flash_attention = capture
    try:
        _serve_nemotron(kernels, eng, prompts, "nemotron-f32-dense", card,
                        new)
    finally:
        fops.flash_attention = served_flash
    check_served_by(kernels, "flash_attention", "flash_attention_f32_tf32",
                    "nemotron-f32-dense")
    check_served_by(kernels, "decode_attention",
                    "decode_attention_f32_f32_tf32",
                    "nemotron-f32-dense")
    launches = _tally(kernels, acc)
    want = {"flash_attention": L, "decode_attention": L * (new - 1)}
    check(all(launches[k] == want.get(k, 0) for k in launches),
          f"[nemotron-f32-dense] launches {launches}, want {want}")
    del eng, model, params
    gc.collect()
    torch.cuda.empty_cache()
    q, k, v = captured.pop("qkv")
    out = fops.flash_attention(q, k, v, causal=True)
    want_out = fops.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    _tally(kernels, {})
    big = max(1.0, want_out.abs().max().item())
    err = (out - want_out).abs().max().item()
    tol = TOL[torch.float32] * big
    check(torch.isfinite(out).all().item() and err <= tol,
          f"[nemotron-f32] layer 0's B2 max_abs_err {err} > {tol}")
    log(f"[nemotron-f32] layer 0's served operands ({tuple(q.shape)}, "
        f"causal): B2 (flash_attention_f32_tf32) against its plain version "
        f"max_abs_err {err:.3e} (tol {TOL[torch.float32]} x {big:.3f}, the "
        f"largest |out|); launches {want}; {card}")


# -- phase 21 -------------------------------------------------------------------

GLM4_CTX, GLM4_NEW = 4096, 32    # 21(b)/(c): 8 prompts of 4096 tokens, 32 new
GLM4_CHUNK = 256                 # paged prefill chunk: 16 mixed steps a prompt
# 21(a): glm4-9b's heads (32/2, G = 16) at a tiny width, f32
GLM4_SMALL = dict(n_layers=2, d_model=256, n_heads=32, n_kv_heads=2,
                  head_dim=64)


def glm4_prompts(vocab_size: int, n: int = 8, length: int = GLM4_CTX):
    rng = np.random.default_rng(21)
    return [rng.integers(0, vocab_size, length).astype(np.int32)
            for _ in range(n)]


def phase_glm4_small(kernels, acc) -> None:
    """Phase 21(a): glm4-9b's smoke config widened to its own heads (32/2,
    G = 16, head_dim 64, QKV bias, half rotary; 2 layers, d 256, f32, TF32
    off), paged and dense: the card's greedy tokens equal the CPU port's;
    decode through the split-TF32 tensor-core entries
    (``*_f32_f32_tf32``), prefill through K2's and B2's ``_tf32``
    entries."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    cfg = get_config("glm4-9b", smoke=True).replace(**GLM4_SMALL)
    prompts = _small_prompts(cfg.vocab_size)
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = cpu_model.init(seed=0)
    gpu_model = build_model(cfg, device="cuda")
    gpu_params = bridge.to_torch(cpu_params, "cuda")
    for paged in (True, False):
        kw = dict(batch_size=4, capacity=128, max_new_tokens=8, burst=4,
                  paged=paged)
        if paged:
            kw.update(prefill_chunk=32, block_size=16)
        want = ServeEngine(cpu_model, cpu_params, device="cpu",
                           **kw).serve(prompts)
        reset(kernels)
        eng = ServeEngine(gpu_model, gpu_params, device="cuda", **kw)
        got = eng.serve(prompts)
        torch.cuda.synchronize()
        tag = (f"glm4-9b heads 32/2 of 64 (G = 16), 2 layers, d 256, f32, "
               f"paged={paged}")
        check(eng.paged == paged, f"[glm4] {tag}: ran paged={eng.paged}")
        for a, b in zip(want, got):
            check(a.status == b.status == "ok",
                  f"[glm4] {tag} request {b.request_id}: {b.status}")
            check(np.array_equal(a.tokens, b.tokens),
                  f"[glm4] {tag} request {a.request_id}: cpu {a.tokens} != "
                  f"cuda {b.tokens}")
        if paged:
            check_served_by(kernels, "paged_prefill_attention",
                            "paged_prefill_attention_f32_f32_tf32", "glm4")
            check_served_by(kernels, "paged_decode_attention",
                            "paged_decode_attention_f32_f32_tf32", "glm4")
        else:
            check_served_by(kernels, "flash_attention",
                            "flash_attention_f32_tf32", "glm4")
            check_served_by(kernels, "decode_attention",
                            "decode_attention_f32_f32_tf32", "glm4")
        launches = _tally(kernels, acc)
        log(f"[glm4] {tag}: {len(prompts)} requests, greedy tokens on cuda "
            f"== cpu ({sum(len(r.tokens) for r in got)} tokens); launches "
            f"{ {n: c for n, c in launches.items() if c} }")


def phase_glm4(kernels, acc, card: str) -> None:
    """Phase 21(b)/(c): glm4-9b at full width and depth, no cut (40
    layers, d 4096, 32/2 heads of 128: G = 16, QKV bias, half rotary,
    d_ff 13696, vocab 151552; random bf16 weights made on the card from
    seed 0): 8 requests of ``GLM4_CTX`` prompt tokens, ``GLM4_NEW`` new,
    batch 8.  (b) The paged engine (bf16 pool, chunk ``GLM4_CHUNK``,
    burst 8): K2 through ``paged_prefill_attention_bf16_bf16_mma`` once a
    layer and mixed step, K1 through ``paged_decode_attention_bf16_bf16_
    mma`` (the tensor-core decode body) once a layer and decode step; then
    a trace.  (c) The dense engine on the same prompts: B2 through
    ``flash_attention_bf16_mma`` once a layer (one prefill wave of 8 x
    4096), B4 through ``decode_attention_bf16_bf16_mma`` once a layer and
    decode step; then a trace.  tok/s, TTFT, peak memory and the device's
    busy share of each; the device is freed before the next phase."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    t0 = time.perf_counter()
    cfg = get_config("glm4-9b")
    L = cfg.n_layers
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[glm4] {cfg.arch_id} full width and depth ({L} layers, no cut): d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.resolved_head_dim} (G = {cfg.n_heads // cfg.n_kv_heads}), "
        f"qkv_bias {cfg.qkv_bias}, rope_pct {cfg.rope_pct}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, bf16: {n_params / 1e9:.2f}B "
        f"parameters made on the card in {time.perf_counter() - t0:.1f}s")
    prompts = glm4_prompts(cfg.vocab_size)
    kw = dict(batch_size=8, capacity=GLM4_CTX + GLM4_NEW,
              max_new_tokens=GLM4_NEW, burst=8, kv_dtype="bf16",
              device="cuda")
    for paged in (True, False):
        tag = "glm4-paged" if paged else "glm4-dense"
        eng = ServeEngine(model, params, paged=paged,
                          **(dict(prefill_chunk=GLM4_CHUNK, block_size=16)
                             if paged else {}), **kw)
        check(eng.paged == paged, f"[{tag}] ran paged={eng.paged}")
        _serve_nemotron(kernels, eng, prompts, tag, card, GLM4_NEW)
        check_serving_launches(kernels, tag)
        steps = eng.n_device_steps
        if paged:
            check_served_by(kernels, "paged_prefill_attention",
                            "paged_prefill_attention_bf16_bf16_mma", tag)
            check_served_by(kernels, "paged_decode_attention",
                            "paged_decode_attention_bf16_bf16_mma", tag)
            mixed = eng.n_prefill_chunks
            want = {"paged_prefill_attention": L * mixed,
                    "paged_decode_attention": L * (steps - mixed)}
        else:
            check_served_by(kernels, "flash_attention",
                            "flash_attention_bf16_mma", tag)
            check_served_by(kernels, "decode_attention",
                            "decode_attention_bf16_bf16_mma", tag)
            want = {"flash_attention": L,
                    "decode_attention": L * (GLM4_NEW - 1)}
        launches = _tally(kernels, acc)
        check(all(launches[n] == want.get(n, 0) for n in launches),
              f"[{tag}] launches {launches}, want {want}")
        log(f"[{tag}] launches {want} ({L} layers, {steps} device steps)")
        phase_trace(eng, tag, n=8, prompt_len=GLM4_CTX)
        reset(kernels)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()


def phase_glm4_int8(kernels, acc, card: str) -> None:
    """Phase 21(d): glm4-9b at full width and depth in f32 (40 layers, no
    cut; ~9.4B random f32 parameters, 37.6 GB, made on the card from seed
    0: the reference serves an f32 model, not a bf16 one, over an int8
    pool) serves 21(b)'s 8 requests of ``GLM4_CTX`` prompt tokens,
    ``GLM4_NEW`` new (batch 8, paged, chunk ``GLM4_CHUNK``, block 16,
    burst 8), first over an int8 pool, then over an f32 pool.  int8: B3
    exactly once a layer and decode step (40 x 31), all through
    ``paged_decode_attention_quant_f32_tf32`` (the tensor-core body over
    int8 tiles), K2q once a layer and mixed step through its ``_tf32``
    entry, no other attention kernel; f32: K1 and K2 the same through
    their ``_f32_f32_tf32`` entries.  Per pool tok/s, TTFT, peak memory
    and a trace (busy share; B3's device time against f32 K1's, the same
    serve's shapes); the greedy tokens' agreement with the f32 pool
    logged, not gated (int8 KV is a bounded drift, not identity); bytes
    per block f32/int8 = (2 x 128 x 4)/(2 x 128 + 2 x 4) checked.  The
    device is freed before and after."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = get_config("glm4-9b").replace(param_dtype="float32",
                                        compute_dtype="float32")
    L, hd = cfg.n_layers, cfg.resolved_head_dim
    model = build_model(cfg, device="cuda")
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[glm4-int8] {cfg.arch_id} full width and depth ({L} layers, no "
        f"cut), f32 weights and compute: {n_params / 1e9:.2f}B parameters "
        f"({4 * n_params / 1e9:.1f} GB) made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    prompts = glm4_prompts(cfg.vocab_size)
    kw = dict(batch_size=8, capacity=GLM4_CTX + GLM4_NEW,
              max_new_tokens=GLM4_NEW, burst=8, paged=True,
              prefill_chunk=GLM4_CHUNK, block_size=16, device="cuda")
    tokens, per_block, decode_ms = {}, {}, {}
    for kv_dtype in ("int8", "f32"):
        tag = f"glm4-f32-{kv_dtype}"
        eng = ServeEngine(model, params, kv_dtype=kv_dtype, **kw)
        check(eng.paged, f"[{tag}] ran paged={eng.paged}")
        res = _serve_nemotron(kernels, eng, prompts, tag, card, GLM4_NEW)
        check_serving_launches(kernels, tag)
        tokens[kv_dtype] = [np.asarray(r.tokens) for r in res]
        steps, mixed = eng.n_device_steps, eng.n_prefill_chunks
        if kv_dtype == "int8":
            decode, prefill = ("paged_decode_attention_quant",
                               "paged_prefill_attention_quant")
            check_served_by(kernels, decode,
                            "paged_decode_attention_quant_f32_tf32", tag)
            check_served_by(kernels, prefill,
                            "paged_prefill_attention_quant_f32_tf32", tag)
        else:
            decode, prefill = ("paged_decode_attention",
                               "paged_prefill_attention")
            check_served_by(kernels, decode,
                            "paged_decode_attention_f32_f32_tf32", tag)
            check_served_by(kernels, prefill,
                            "paged_prefill_attention_f32_f32_tf32", tag)
        want = {decode: L * (steps - mixed), prefill: L * mixed}
        launches = _tally(kernels, acc)
        check(all(launches[n] == want.get(n, 0) for n in launches)
              and want[decode] == L * (GLM4_NEW - 1),
              f"[{tag}] launches {launches}, want {want}")
        log(f"[{tag}] launches {want} ({L} layers, {steps} device steps, "
            f"{mixed} mixed); {eng.pool_stats()['pool_bytes'] / 1e9:.2f} GB "
            f"pool")
        per_block[kv_dtype] = eng.kv_bytes_per_block()
        *_, times = phase_trace(eng, tag, n=8, prompt_len=GLM4_CTX)
        body = [(ms, n) for key, (ms, n) in times.items()
                if "decode_gqa_kernel" in key]
        check(len(body) == 1, f"[{tag}] decode kernels traced: {body}")
        decode_ms[kv_dtype] = body[0]
        reset(kernels)
        del eng, res
        gc.collect()
        torch.cuda.empty_cache()
    (b3_ms, b3_n), (k1_ms, k1_n) = decode_ms["int8"], decode_ms["f32"]
    log(f"[glm4-int8] traced decode attention: B3 (int8 pool) {b3_ms:.2f} "
        f"ms over {b3_n} calls = {b3_ms / b3_n:.4f} ms a call; f32 K1 (f32 "
        f"pool) {k1_ms:.2f} ms over {k1_n} = {k1_ms / k1_n:.4f}; B3 takes "
        f"{b3_ms / k1_ms:.2f}x f32 K1's device time; {card}")
    n_tok = sum(len(t) for t in tokens["f32"])
    agree = sum(int((a == b).sum())
                for a, b in zip(tokens["int8"], tokens["f32"]))
    first = sum(int(a[0] == b[0])
                for a, b in zip(tokens["int8"], tokens["f32"]))
    log(f"[glm4-int8] greedy tokens equal to the f32 pool's: {agree}/{n_tok} "
        f"({100 * agree / n_tok:.1f}%); first tokens {first}/{len(prompts)} "
        f"(logged, not gated: int8 KV is a bounded drift, not identity)")
    b8, b32 = per_block["int8"], per_block["f32"]
    check(b32 * (2 * hd + 2 * 4) == b8 * (2 * hd * 4),
          f"bytes per block f32/int8 = {b32}/{b8}, not 1024/264")
    log(f"[glm4-int8] bytes per block f32/int8 = {b32}/{b8} = "
        f"{b32 / b8:.4f} (= 1024/264: 2 x 128 x 4 bytes against 2 x 128 + "
        f"2 x 4)")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.moe_gating import ops as gops
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.transform import ops as tops
    kernels = [dops.KERNEL, fops.KERNEL, sops.KERNEL, gops.KERNEL,
               fops.FLASH_KERNEL, dops.DENSE_KERNEL, dops.QUANT_KERNEL,
               fops.QUANT_KERNEL, tops.KERNEL, fops.BACKWARD_KERNEL,
               sops.BACKWARD_KERNEL]
    t_start = time.perf_counter()

    def mark(tag: str) -> None:
        log(f"[time] {tag} done at {time.perf_counter() - t_start:.1f}s")
    card = phase_device()
    phase_build(kernels)
    timer = Timer()
    served = phase_attention(timer)
    floor_ms = phase_floor(timer)
    served["selective_scan"] = phase_scan(timer, floor_ms)
    served["selective_scan_backward"], scan_backward_rows = \
        phase_scan_backward(timer)
    served["gating_topk"] = phase_gating(timer, floor_ms)
    served.update(phase_dense_kernels(timer))
    mla_rows = phase_mla_kernels(timer)
    slice_rows = phase_slice_kernels(timer)
    served["flash_attention_backward"], backward_rows = \
        phase_backward_kernels(timer)
    nemotron_rows = phase_nemotron_kernels(timer, backward_rows)
    gqa_rows = phase_gqa_decode(timer)
    served.update(phase_quant_kernels(timer))
    phase_splits()
    served["fused_transform"] = phase_transform(timer)
    mark("phases 1-3")
    del timer
    reset(kernels)
    COUNT_ENTRIES["on"] = True
    SERVING_ONLY["on"] = True
    phase_engine(kernels)
    launches5, eng, tok_s5 = phase_main_path(kernels)
    d2h, *_ = phase_trace(eng, "main")
    # the split decode reads no device tensor on the host: 2.22 copies per
    # step before and after it (a read per decode call would add 32)
    check(d2h < 2.5, f"[main] {d2h:.3f} device-to-host copies per step")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches6, eng = phase_jamba(kernels)
    phase_trace(eng, "jamba", n=8, prompt_len=512)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches7, eng = phase_dense(kernels)
    phase_trace(eng, "dense", n=8, prompt_len=512)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches8, eng = phase_int8(kernels)
    phase_trace(eng, "int8", n=8, prompt_len=512)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches9 = phase_preproc(kernels)
    mark("phases 4-9")
    gc.collect()
    torch.cuda.empty_cache()
    phase_front_door_small(kernels)
    phase_front_door(kernels, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches11: dict = {}
    phase_sampling_spec_small(kernels, launches11)
    phase_sampling_spec(kernels, launches11, card, tok_s5)
    gc.collect()
    torch.cuda.empty_cache()
    phase_xlstm_small(kernels)
    phase_xlstm(kernels, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_mla_small(kernels, {})
    launches13, mla_served = phase_mla(kernels, card)
    mark("phases 10-13")
    gc.collect()
    torch.cuda.empty_cache()
    launches14: dict = {}
    launches15: dict = {}
    launches16: dict = {}
    launches17: dict = {}
    launches17a: dict = {}
    launches17c: dict = {}
    launches18: dict = {}
    launches18r: dict = {}
    launches19: dict = {}
    launches20: dict = {}
    launches21: dict = {}
    for tag, run in (("14", lambda: (phase_forward_small(kernels, launches14),
                                     phase_forward(kernels, launches14,
                                                   card))),
                     ("15", lambda: phase_whisper(kernels, launches15, card)),
                     ("16", lambda: phase_vlm(kernels, launches16, card)),
                     ("17", lambda: (phase_train_small(kernels, launches17a),
                                     phase_train(kernels, launches17, card),
                                     gc.collect(), torch.cuda.empty_cache(),
                                     phase_train_jamba(kernels, launches17c,
                                                       card))),
                     ("18", lambda: (phase_mesh_small(kernels, launches18,
                                                      launches18r),
                                     phase_mesh(kernels, launches18,
                                                launches18r, card))),
                     ("19", lambda: (phase_nemotron(kernels, launches19,
                                                    card),
                                     gc.collect(), torch.cuda.empty_cache(),
                                     phase_train_nemotron(kernels,
                                                          launches19,
                                                          card))),
                     ("20", lambda: (phase_train_f32(kernels, launches20,
                                                     card),
                                     gc.collect(), torch.cuda.empty_cache(),
                                     phase_nemotron_f32(kernels, launches20,
                                                        card))),
                     ("21", lambda: (phase_glm4_small(kernels, launches21),
                                     phase_glm4(kernels, launches21, card),
                                     phase_glm4_int8(kernels, launches21,
                                                     card)))):
        t0 = time.perf_counter()
        if tag == "17":
            check_serving_launches(kernels, "phase 16")
            SERVING_ONLY["on"] = False
            log(f"[serving] phases 4-16 launched no backward and no *_lse "
                f"entry ({SERVING_ONLY['resets']} runs checked)")
        run()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[phase {tag}] {time.perf_counter() - t0:.1f}s")
    launches = {"paged_decode_attention": launches5["paged_decode_attention"],
                "paged_prefill_attention": launches5["paged_prefill_attention"],
                "selective_scan": launches6["selective_scan"],
                "gating_topk": launches6["gating_topk"],
                "flash_attention": launches7["flash_attention"],
                "decode_attention": launches7["decode_attention"],
                "fused_transform": launches9,
                # the training path's own kernels: phase 17(b)'s run, and
                # jamba's at full width (17(c)) for B5'
                "flash_attention_backward":
                    launches17["flash_attention_backward"],
                "selective_scan_backward":
                    launches17c["selective_scan_backward"]}
    launches.update({n: launches8[n] for n in QUANT_KERNELS})
    reset(kernels)      # the last run's entries into ENTRY_TOTALS
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    rows = [dict(name=k.name, route="cuda",
                 source=str(k.source.relative_to(ROOT)),
                 replaces=REPLACES[k.name], launches=launches[k.name],
                 launches_phase11=launches11.get(k.name, 0),
                 launches_phase13=launches13.get(k.name, 0),
                 launches_phase14=launches14.get(k.name, 0),
                 launches_phase15=launches15.get(k.name, 0),
                 launches_phase16=launches16.get(k.name, 0),
                 launches_phase17=launches17.get(k.name, 0),
                 launches_phase17a=launches17a.get(k.name, 0),
                 launches_phase17c=launches17c.get(k.name, 0),
                 launches_phase18=launches18.get(k.name, 0),
                 launches_phase19=launches19.get(k.name, 0),
                 launches_phase20=launches20.get(k.name, 0),
                 launches_phase21=launches21.get(k.name, 0),
                 entries=ENTRY_TOTALS.get(k.name,
                                          dict.fromkeys(k.entries, 0)),
                 launches_phase18_by_rank={
                     str(r): n for r, n in launches18r.get(k.name,
                                                           {}).items()},
                 **served[k.name]) for k in kernels]
    for row in rows:
        if row["name"] in mla_rows:
            row["mla_heads"] = mla_rows[row["name"]]
            row["mla_served"] = mla_served[row["name"]]
        if row["name"] in slice_rows:
            row["slice_shapes"] = slice_rows[row["name"]]
        if row["name"] in nemotron_rows:
            row["nemotron_heads"] = nemotron_rows[row["name"]]
        if row["name"] in gqa_rows:
            row["gqa_heads"] = gqa_rows[row["name"]]
        if row["name"] == "flash_attention_backward":
            row["training_shapes"] = backward_rows
        if row["name"] == "selective_scan_backward":
            row["training_shapes"] = scan_backward_rows
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
