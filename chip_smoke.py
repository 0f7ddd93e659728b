#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (umbrella_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero); each prints
lines tagged with its name:
  build            compile every kernel in umbrella_tpu_torch/csrc/ with nvcc.
  kernels          call each kernel's wrapper at the main paths' shapes and hold
                   it against its plain PyTorch version on the card; time the
                   kernel, the plain version and a PyTorch library yardstick,
                   and compute the card's bound for the same work. Includes
                   every check of `w4a16` and of `w4a8`, and the offload
                   configs' shapes: W4A16 at the four 70B layer shapes at
                   S=256 and 257 (the dynamic verify), attention at the 70B
                   257-row verify q [257,64,128] and a 1B draft level
                   q [16,32,64]; and the 70B's tensor-parallel shard shapes
                   (4 shards): W4A16 on shards cut from whole weights
                   (column wq [8192,2048], wk [8192,256], gate [8192,7168],
                   bf16 out; repacked row wo [2048,8192], down [7168,8192],
                   fp32 out) at S=1, 24, 127, 300, rows bitwise across S,
                   and attention q [127,16,128] over 2 kv heads.
  w4a16            (only when named in --phases; part of `kernels`) the W4A16
                   family alone: the plain mode at the four 8B layer shapes,
                   S=1, 24, 48, 127, 160, 224 and 300 (every token width of
                   the kernel), bf16/fp32 x, scales and out, timed at S=24,
                   127 and 224; the group size 32; eye(K) @ W equal to the
                   dequantized weight bit for bit; the fused gate-up-SiLU;
                   the layered mode on 4-layer stacks at each 70B layer shape
                   (split K and not), bit for bit the plain mode on each
                   layer, and an index past the stack must trap (in a child
                   process); row j of S=300 equal to row j at each other row
                   count, bitwise, for plain, layered and fused, bf16 and
                   fp32 x.
  w4a8             (only when named in --phases; part of `kernels`) the int8 W4
                   family (csrc/w4a8.cu) alone: the fused quantizer bit for bit
                   the plain quantizers (Int4F x * a with row sums, AWQ x with
                   sums per group of 128 and 32); w4a8f_matmul at the four 8B
                   layer shapes and the lm_head, bf16 and fp32 out, S=1, 24,
                   48, 127, 160, 224, 300 and 384 (every token width 32-256
                   and a second super-tile); w4a8_matmul at 8B gate_up and
                   down (K split), g128 and g32, bf16 and fp32 x and scales,
                   integer zeros and zeros + 0.5 (the two fix-ups), S=1, 24,
                   48, 127, 160, 224, 300 and 512: both exact against
                   their plain versions (max abs err 0.0), and the rows of
                   every S bit for bit the rows of the largest S; the same
                   for both at K/2 = 160 (a last stage of one k32 step;
                   AWQ g32 and g160); timings.
  attention        (only when named in --phases; part of `kernels`) the
                   attention kernels (csrc/tree_attention.cu) alone: each
                   wrapper at the serving and verify shapes and the 70B verify
                   shape q [127, 64, 128] (groups 8) against its plain version,
                   timed beside SDPA and its bound; fp32 q and head dim 32 take
                   the scalar kernel, bf16 q the tensor-core kernel; for bf16
                   and int8 KV: rows of S=1, 24 and 127 bit for bit the same
                   rows of S=512 (single slot, and one slot through `slots`),
                   each slot of a B=32 launch bit for bit the slot alone, 1e6 /
                   127 past a slot's kv_limit changes nothing, soft cap 30.0,
                   rows with no live slot and kv_limit 0 exactly 0.
  multi-card       the static and the batched engine built on the last card
                   while cuda:0 is current: 16 tokens each, through APIServer
                   and a ContinuousBatcher (threads that start on cuda:0) and
                   directly, must equal the same engines' tokens on cuda:0
                   (needs a host with 2+ cards; on one card it prints
                   "skipped: 1 card" and passes).
  lossless         full widths, 4 layers, early exit 2, fp32 activations:
                   greedy static-tree generate() must equal the port's own
                   greedy autoregressive decode for 64 tokens.
  lossless-int8    the same on an int8 KV cache (both decodes).
  lossless-w4a8    the same with awq_act="int8" (the W4 layers run W4A8).
  batched-lossless fp32, 4 layers, B=4 slots, 7 requests of staggered prompt
                   lengths: BatchedStaticEngine.run() must give each request
                   the single-slot StaticEngine's tokens (48 or more).
  pp-lossless      full Llama-3.3-70B width, 8 AWQ layers, early-exit draft
                   of 2 layers; the target staged in 4 stages of 2 layers
                   (pipeline_parallel 4) and decoded on the graphed loop:
                   fp32, fp32 with int8 KV, and bf16.
                   generate() must equal the unstaged engine's tokens for 64
                   tokens, and the AR decode's (fp32, bf16), or part from it
                   only at a near tie (int8 KV); the KV rows of the spec and
                   the AR decode are compared layer by layer as the witness.
  tp-lossless      full Llama-3.3-70B width, a separate 2-layer draft at
                   Llama-3.2-1B widths; the target sharded in 4 on this card
                   (tensor_parallel 4, graphed, one segment a step): 4 dense
                   fp32 layers, and 8 AWQ layers in the tensor-parallel
                   layout in fp32 and in bf16. generate() equals the AR
                   decode over the sharded target (layer 0's KV rows bit for
                   bit). Dense fp32 equals the unsharded engine's tokens
                   exactly. The W4A16 kernel splits K by each shard's N and
                   K, so the AWQ cases are held exactly to a mirror, the
                   unsharded forward over the shards' own products: equal
                   tokens, the prompt's logits bit for bit, the shards
                   reassembling the unsharded weights bit for bit, and two
                   planted all_reduce faults parting the logits; where they
                   part from the unsharded engine is reported. On four
                   cards, one shard a card gives the one-card tokens, the
                   port's kernels on every card.
  tp-serve         the batched engine with tensor_parallel 4 (B=4, 3x4, fp32):
                   8B width, 4 dense fp32 layers, and Gemma-2-9B width, 2
                   layers (sums before the post norms): run() equals the
                   unsharded batched engine's tokens; on four cards the
                   one-card ones.
  dynamic-lossless full widths, 4 layers, early exit 2, fp32: the dynamic engine
                   (the default engine; the shipped offload configs' 16 x 16
                   tree of 24 beams, graphed) and an offload target's
                   pipelined decode over the same weights (2 layers resident,
                   2 streamed from pinned memory; the draft phase and the
                   tail graphed), static 24x6 and dynamic, must each equal
                   the AR decode for 64 tokens.
  offload-lossless full Llama-3.3-70B widths, 6 AWQ layers, bf16: the offload
                   runtime (2 layers resident, 4 streamed) gives the resident
                   forward's logits bit for bit at a 128-token prefill and a
                   257-row dynamic verify, twice in a row; the dynamic engine
                   over it commits the resident engine's tokens, its step
                   graphed and again all eager.
  train            draft/config.json at full width (174M params), bf16,
                   packed, B 8 x seq 1024, lr 3e-4, 30 steps through
                   training/train_draft's functions on a seeded stream that
                   repeats a 61-token phrase: the loss must fall by 1 nat or
                   more (first step against the mean of the last five) and
                   each step launch embed_gather once; first, one step
                   through the lookup kernel against the same step through
                   the plain lookup (bf16 and fp32): the forward bit for
                   bit, every other gradient within 2^-7 x its max, the
                   embedding's gradient non-zero, in fp32 within 1e-3 x its
                   max, in bf16 its fp32 sum cast once (that sum within 1e-3
                   x max of an fp64 sum; the plain lookup's bf16 backward
                   rounds at each repeat of a row, reported); ms a step,
                   tok/s, peak GB, the forward and backward's ms with bf16
                   products and with fp32 norm sums (what the fp32 upcast
                   and the fp64 sums cost); then the trained params (fp32)
                   served by the static engine (24x6, an early-exit draft of
                   2 layers): 64 greedy tokens equal the AR decode's, and
                   how many follow the phrase.
  train-dp         the same step in fp32 with dp 2 (two replicas on this
                   card, one a card on a host with two or more) against dp 1,
                   three steps: losses within 1e-5, params within 1e-3 x the
                   second update's rate but for 1e-4 of them at most.
  pp-train         draft width, fp32, 4 stages (one a card on four cards,
                   else all on this card), 4 microbatches: the loss and
                   every gradient against the unstaged step's (1e-5, 1e-4 x
                   max); ms a step staged and unstaged.
  moe-train        Mixtral-8x7B widths, 2 of its 32 layers, bf16, B 2 x seq
                   256, 3 steps: finite losses and aux loss, ms a step; one
                   fp32 step at 1 layer (experts narrowed to 1024) through
                   the lookup kernel against the plain lookup.
  tp-train         draft/config.json at full width and depth over 4 shards
                   (on this card, or one a card on four), B 8 x seq 1024:
                   fp32, one step's loss and every gradient against the
                   unsharded step's (1e-5, 1e-4 x max); SP equal to TP bit
                   for bit (the step's loss and gradients, and 3 steps'
                   losses and params); 3 steps of TP, SP and the (data 2,
                   model 2) grid against 3 unsharded steps (losses 1e-5,
                   params as [train-dp]); bf16 ms a step sharded and
                   unsharded, peak GB a card, embed_gather once a step; the
                   TP-trained params, gathered, served (fp32, static engine,
                   early-exit draft of 2 layers, 32 tokens): spec == AR.
  ep-train         Mixtral-8x7B widths, 2 of its 32 layers, bf16, experts
                   sharded in 4 (this card, or one a card), B 2 x seq 256, 3
                   steps: finite losses, ms a step, peak GB a card,
                   embed_gather once a step; one fp32 step at 1 layer
                   (experts narrowed to 1024) sharded against unsharded: the
                   loss within 1e-5, every gradient within 1e-4 x max.
  multihost        umbrella_tpu_torch/examples/multihost_demo.launch spawns
                   two worker processes: both on this card (gloo), or two
                   cards each on a host with four (NCCL); the backend is
                   printed. Each trains the (data 2, model 2) grid at
                   draft/config.json's width (fp32, B 4 x 256, 3 steps, the
                   gradient sum across the processes), then decodes with a
                   static engine with tensor_parallel 4 across them (2
                   shards each) over a random AWQ Llama-3.3-70B at full width
                   and 8 layers (bf16, from one seed) with a 2-layer draft at
                   Llama-3.2-1B widths, 24 tokens, and the batched engine
                   (B=2, four requests in priority order). Losses identical
                   on both and equal to the one-process grid's; greedy tokens
                   identical on both and the one-process tensor_parallel 4
                   engine's, the prompt's logits bit for bit; batched tokens
                   identical on both. Spawn-to-ready s, ms a decode step,
                   gathers a forward and launches a step by process.
                   Every training phase fails on autograd's warning of a
                   gradient made on another card's stream (pp-train too).
  main             the 8B AWQ target (32 layers, damped tail, Int4F shared
                   prefix of 3 layers + lm_head) with its early-exit draft, a
                   Sequoia 24x6 tree, through AutoEngine.from_config ->
                   initialize -> generate(): graphed (the device-resident
                   decode loop, its step replayed as a CUDA graph) and
                   stepwise (build_tree(); verify(), one host read a step)
                   side by side, each with tok/s, step ms, TTFT and a
                   profile (idle share, host ops a step, replays, no-op
                   replays, capture ms, graph pool GB); equal tokens.
  graph            graphed against stepwise tokens: the static engine on the
                   fp32 lossless model, on the bf16 8B main path (greedy, and
                   stochastic from one seed) and the batched engine at B=32
                   with int8 KV; every replay inside no_host_sync (the
                   replaying thread's check; the process-wide sync debug
                   mode left alone); a graph captured
                   and replayed in each graphed run; a registered generator
                   draws anew at each replay; a step that reads the host must
                   fail its capture (no stepwise fallback).
  dynamic          the dynamic engine on the 8B target with a random bf16
                   draft at Llama-3.2-1B widths, the 16 x 16 x 24 tree,
                   greedy and stochastic (0.6 / 0.9 / 1.05): graphed and
                   stepwise tokens equal from one seed; tok/s, step ms,
                   accept, a profiled request (host ops a step, idle share,
                   traced launches a step = the captured step's).
  dynamic-pp       the dynamic engine (16 x 16 x 24, greedy, 12 tokens) over
                   an 8B AWQ target staged in 4 stages (pipeline_parallel 4)
                   with the 1B draft: graphed, stepwise and the unstaged
                   target's decode give the same tokens.
  serve            the same models behind engine="batched_static": B=32, int8
                   KV, 2x3 tree, 64 requests through run() and then through the
                   pipelined ContinuousBatcher; tok/s, accept, step ms, TTFT,
                   TPOT, peak memory, launches per step, device idle share;
                   then run() and the profiled segment again with the steps
                   dispatched eagerly (stepwise), the same tokens.
  serve-bf16       B=8, bf16 KV, 3x4 tree, 16 requests through run().
  serve-stochastic B=32 int8 KV at temperature 0.6, top-p 0.9.
  checkpoint       write synthetic checkpoints under build/ (deleted at the
                   end) in the published on-disk formats: an AutoAWQ GEMM
                   Llama-3.1-8B target at 8 of its 32 layers (the depth cut
                   keeps the script inside its time limit; two safetensors
                   shards; a second
                   directory over the same files says awq_act "int8") and a
                   bf16 Llama-3.2-1B draft; load both through
                   AutoModelLM.from_pretrained (time, host RSS, device
                   memory); the target's logits must equal the in-memory
                   conversion's bit for bit.
  code-config      configs/code_config_8b_awq_v5e.json as shipped (model,
                   draft_model and growmap_path rewritten; 64 new tokens):
                   greedy 24x6, W4 draft and head from quantize_draft.
  code-config-w4a8 the same on the awq_act "int8" target (w4a8_matmul).
  serve-config     configs/serve_batched_8b_awq_int8kv_v5e.json as shipped:
                   B=32, int8 KV, Int4F draft, 2x3 tree, temperature 0.6.
  api-serve        the same config served through APIServer on port 0 with its
                   "scheduler": {} key (make_scheduler's 40 workers in front
                   of a ContinuousBatcher over [serve-config]'s engine): 64
                   client threads send one request each (128 prompt and 40
                   new tokens, priorities 1/10/20; 16 stream, 16 greedy),
                   then get_metrics; the same requests through run() and the
                   direct batcher (the batcher and the server twice, in
                   turn), then through the server with a worker a request
                   and without the scheduler key (the loop thread sends).
                   Greedy tokens equal run()'s on every route, stream frames
                   grow into the result; tok/s of each path, client TTFT,
                   slot admission times, frames a stream, host ms a segment
                   in the loop's callbacks, the scheduler's metrics.
  api-chat         configs/chat_config_8b_awq_v5e.json as shipped (static
                   engine, 24x6, W4 1B draft, stochastic) built and served by
                   APIServer's single-engine worker: a greedy request equals
                   the direct generate(), a streamed one gives its text, two
                   stochastic ones complete; tok/s, TPOT, accept, time to the
                   first frame.
  pp-config        configs/chat_config_70b_awq_pp4.json as shipped: a random
                   AWQ Llama-3.3-70B at full widths and 32 of its 80 layers
                   (PP_CONFIG_LAYERS; the cut keeps the script inside its
                   time limit) staged in 4
                   stages (one per card on a host with 4, else all on this
                   card), the 8B AutoAWQ directory above as its draft,
                   temperature 0.6, top-p 0.9, repetition penalty 1.05, 24x6
                   tree, max_length 8192; graphed and stepwise from one
                   generator state, the same tokens: TTFT, step ms, tok/s,
                   accept, peak memory, launches per step (160 layered W4A16
                   a step), capture ms, pool GB by card, segments a step,
                   and each loop's decode profiled alone ([pp-profile],
                   [pp-profile-stepwise]; host ops a decode step, graphed
                   under a tenth of stepwise).
  tp-config        configs/chat_config_70b_awq_pod.json as shipped
                   (tensor_parallel 4, static 24x6, 0.6 / 0.9 / 1.05,
                   max_length 8192): a random AWQ Llama-3.3-70B at full
                   widths and PP_CONFIG_LAYERS of its 80 layers sharded in 4
                   (on this card, or one a card on a host with 4), the 8B
                   AutoAWQ directory as draft: TTFT, a sampled request
                   graphed and stepwise (equal tokens), a greedy one, both
                   guarded against degenerate decodes; [tp-profile] (host
                   ops, busy ms and idle share a step), peak and pool GB,
                   segments a step; an eager forward at the verify width
                   timed bare and inside the host-read check (its cost).
  offload-checkpoint the 8B AutoAWQ directory loaded with offload: true and
                   num_cache_layers half its layers (4 of 8): logits equal
                   the resident load's bit for bit.
  offload-config   configs/greedy_config_v5e.json and chat_config_v5e_16gb.json
                   as shipped (the dynamic engine over a random AWQ
                   Llama-3.3-70B at full widths and 24 of its 80 layers
                   (OFFLOAD_CONFIG_LAYERS), 16 on the card and the
                   rest streamed from pinned host memory, depth cut further
                   where MemAvailable cannot hold 8 streamed layers; the 1B draft
                   directory above): one request each on the graphed step
                   (TTFT, step ms, tok/s, accept), greedy again all eager
                   (the same tokens), streamed_forward_traced at the 257-row
                   verify (compute and exposed stream ms a layer, H2D GB/s a
                   streamed layer) and each loop's decode profiled alone
                   ([offload-profile], whose host-to-device copies must
                   overlap compute kernels, and [offload-profile-eager]);
                   peak device GB and pinned host GB.
  gemma-lossless   Gemma-2-9B widths, 4 layers, fp32, tail post norms damped,
                   early-exit draft of 2: the static engine (graphed and
                   stepwise) and the dynamic engine equal the AR decode for
                   64 tokens; the batched engine (B=4, 2x3, graphed and
                   stepwise) gives 5 requests the single-slot engine's tokens.
  gemma-config     synthetic google/gemma-2-9b-it (42 layers) and -2b-it (26)
                   directories written under build/ (bf16 HF safetensors,
                   23.7 GB, deleted after the Gemma phases) through
                   configs/chat_config_8b_v5e.json's keys (static 5x6, 0.6 /
                   0.9 / 1.05, max_length 8192, template gemma2-it): a sampled
                   24-token request and a greedy one on a 4,200-token prompt
                   (past the 4,096-slot window), each graphed and stepwise
                   from one generator state (the stepwise loop's 8 tokens
                   equal); TTFT; [gemma-profile] (the greedy decode alone,
                   traced launches = the captured step's); attend_flash at
                   the 9B verify past the window (head dim 256, soft cap 50,
                   window and full masks), attend_flash_batched at the B=8
                   verify and embed_gather from the 256000-row table, each
                   against its plain version; then the default dynamic
                   engine over the same models (graphed; stepwise equal).
                   The checkpoints' embedding is drawn at 0.02 / sqrt(3584)
                   (the tied, sqrt(hidden)-scaled embedding would otherwise
                   echo the input token), and every decode is guarded
                   (check_not_degenerate): few echoes, many distinct tokens,
                   and an independent draft's accept below 0.9 of the most.
  gemma-serve      configs/serve_batched_8b_v5e.json's keys (B=8, bf16 KV,
                   3x4, max_length 4096) over the same models: greedy
                   requests through run() and the pipelined batcher, one
                   profiled segment; run() equals the single-slot engine or
                   parts from it only where both tokens are near the top
                   logit (within 2^-7 max|logit| or twice the row-count
                   noise measured there, itself within 2^-3 max|logit|).
  moe-checkpoint   synthetic mistralai/Mistral-7B-Instruct-v0.3 (32 layers)
                   and Mixtral-8x7B-Instruct-v0.1 (full widths, 2 layers)
                   directories (20.8 GB, deleted after the MoE phases): the
                   Mixtral directory's logits equal the same tensors built in
                   memory, bit for bit; the Mistral one loads as a draft.
  moe-config       configs/chat_config_mixtral_ep.json as shipped
                   (expert_parallel 4, static 24x6, 0.6 / 0.9 / 1.05): a
                   random bf16 MoE target at Mixtral widths expert-sharded in
                   4, on this card at 16 of its 32 layers (12 if the card
                   runs short), one shard a card at all 32 on a host with
                   4 cards, the Mistral directory as the
                   draft (V = 32768 against 32000): a sampled 24-token
                   request graphed and stepwise (8 tokens equal); TTFT;
                   [moe-profile]; attend_flash, attend_flash_batched_int8 and
                   embed_gather at this family's shapes.
  moe-serve        configs/serve_batched_mixtral_ep.json as shipped
                   (expert_parallel 4, B=8, int8 KV, 3x4, 8-step segments)
                   over the same models: greedy requests through run() and the
                   pipelined batcher, one profiled segment; run() equals the
                   single-slot engine or parts from it at a near tie of the
                   logits or of the router on the rows before the parting
                   (router_margins); then fp32 at Mixtral widths (2 layers,
                   int8 KV): run() equals the single-slot engine, and with
                   expert_parallel 4 both equal the unsharded engines.
  spec-bench       configs/chat_config_8b_v5e.json as shipped (static 5x6,
                   0.6 / 0.9 / top-k 32 / 1.05) over its own pair: a bf16
                   meta-llama/Llama-3.1-8B-Instruct directory (untied head, 8
                   of its 32 layers, written under build/ only for this phase
                   and the next bf16 one) and the Llama-3.2-1B directory, with
                   WordTokenizer: examples/spec_generate once, then
                   examples/spec_bench over umbrella_tpu_torch/data/
                   question.jsonl (3 questions, 6 turns, 32 new tokens each):
                   per-category and total tok/s, TPOT and accept; decodes
                   guarded (check_not_degenerate); embed_gather and the
                   tensor-core attend_flash launched, no W4 kernel.
  spec-bench-code  configs/code_config_8b_awq_v5e.json over the 8B AutoAWQ
                   directory (W4 draft from quantize_draft) through
                   examples/spec_bench_python's five default prompts (32 new
                   tokens each; all kept, WordTokenizer gives 20+ tokens).
  serve-config-bf16 configs/serve_batched_8b_v5e.json as shipped (batched, B=8,
                   3x4, 0.6 / 0.9 / 32, its "scheduler": {} key) over the
                   bf16 pair: 16 requests of 24 new tokens through
                   make_scheduler in front of a ContinuousBatcher.
  generate         examples/generate.autoregressive_decode on the 1B directory
                   (all 16 layers): 64 greedy tokens on its captured step,
                   equal to the plain stepwise AR decode, TPOT; 16 sampled
                   tokens start with the prefill's argmax (the JAX example's
                   quirk); then examples/bench.bench_step on the 1B (prefix
                   512, 32 tokens, one CUDA graph) and on the 8B AutoAWQ
                   directory with offload (4 layers resident, 4 streamed).
  construct-sequoia examples/construct_sequoia.measure_acceptance: the 1B
                   draft against the 8B AutoAWQ target over DEFAULT_TEXTS
                   (WordTokenizer ids), 8 beams; the 5x6 tree written to
                   build/, loaded through speculation/tree.GrowMap, drives a
                   static-engine request of 16 tokens.
  bench-70b        examples/bench_70b.measure() at Llama-3.x-70B width: the
                   slope-timed W4 layer (S=128) and lm_head, each count of
                   layers one CUDA graph; its JSON line (extrapolation with
                   the H100's HBM and NVLink rates, the draft term left out).
  serve-soak       examples/serve_soak --model-class awq8b --batch 32: 64
                   requests of 32-63 new tokens (prompts 32-256), 20 ms apart,
                   through make_scheduler and the pipelined ContinuousBatcher,
                   every 4th streaming; its JSON line (tok/s, latency p50/p90/
                   p99, TTFT, frame cadence).
  report           one JSON line of kernels, the card's name and power limit,
                   and the final {"ok": true, ...} line.
The static, dynamic and batched engines decode through CUDA graphs in every
phase (each phase checks it): a step is one graph on one card, one graph a
run of phases on one card for a target staged across cards, and two graphs
around the eager streamed forward for an offload target (its pipelined
loop); a replay adds the captured step's launches to the kernels' counts.
Every kernel must have launched in the phase that its `launches` is read
from; in [main], [serve], [serve-bf16], [code-config], [serve-config] and
[pp-config] (bf16) every attention launch must be the tensor-core kernel's,
in [lossless], [lossless-int8] and [lossless-w4a8] (fp32) the scalar
kernel's. `--phases a,b` runs a subset (no report).

Weights are random (seeded). The script needs CUDA and the repository's
umbrella_tpu_torch package beside it; without either it exits with code 2.
The whole script is kept well under its 1,200 s limit on one H100, the
kernels' build (20-30 s) included, so that a slower host stays inside the
limit: 942 s on an H100 80GB HBM3 at 700 W with this docstring's token
counts, while torch built its FunctionEvents for every profiled window,
which read_trace now skips (PERF.md gives the later runs); `--phases
w4a16` about a minute, `--phases w4a8` about 45 s, `--phases attention`
about a minute.
"""
import bisect
import contextlib
import gc
import json
import os
import subprocess
import sys
import threading
import time
import traceback
import weakref

PROMPT_LEN = 128
MAIN_NEW_TOKENS = 64  # cut from 128 to keep the script inside its time limit
LOSSLESS_NEW_TOKENS = 64
BATCHED_LOSSLESS_TOKENS = 48
SERVE_NEW_TOKENS = 80  # cut from 160 to keep the script inside its time limit
STOCHASTIC_NEW_TOKENS = 64
SEGMENT_STEPS = 8
MAX_LEN = 2048
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
CFG_8B = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
              num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
              rope_theta=500000.0, max_position_embeddings=MAX_LEN,
              tie_word_embeddings=False, eos_token_id=-100)
ACC_24x6 = [0.55, 0.2, 0.1, 0.06, 0.05, 0.04]
LAYER_SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "gate_up": (4096, 28672),
                "down": (14336, 4096)}
LAYER_SHAPES_70B = {"wqkv": (8192, 10240), "wo": (8192, 8192), "gate_up": (8192, 57344),
                    "down": (28672, 8192)}
LLAMA3_EOS = [128001, 128008, 128009]
# meta-llama/Llama-3.3-70B-Instruct's config.json: the shapes of the pp4
# config's target (an AutoAWQ g128 checkpoint of it)
CFG_70B = dict(vocab_size=128256, hidden_size=8192, intermediate_size=28672,
               num_hidden_layers=80, num_attention_heads=64, num_key_value_heads=8,
               rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=131072,
               rope_scaling=dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                                 original_max_position_embeddings=8192, rope_type="llama3"),
               tie_word_embeddings=False, eos_token_id=LLAMA3_EOS)
PP_STAGES = 4


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, iters=20, warmup=3, graph=True):
    """Mean time of fn() in ms. graph=True, how every kernel's `ms` and
    `library_ms` are timed (`timed_by` in the kernels line): `iters` calls
    captured in one CUDA graph and replayed between CUDA events, so the host's
    launch time is not counted (a kernel shorter than its launch would
    otherwise time the host); a call that cannot be captured raises.
    graph=False: CUDA events around `iters` back-to-back calls, which count
    the host's time per call where it is longer than the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if not graph:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


# how the kernels line's times were taken
TIMED_BY = ("cuda_graph: ms, plain_ms and library_ms are the mean of 20 calls captured in one "
            "CUDA graph, replayed between CUDA events (device time, no host launch cost)")


def library_ms(torch, fn):
    """cuda_ms of a library call, or None (with the reason printed) where this
    PyTorch build refuses the call at these shapes."""
    try:
        return cuda_ms(torch, fn)
    except RuntimeError as e:
        log(f"[kernels] library call unavailable: {e}")
        return None


def bound(bytes_moved, ops, op_type):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(torch, mask, limits, nH, KVH, D, int8):
    """bound() of masked attention: q [B, S, nH, D] read and out written in
    bf16, each slot's K and V columns below its limit read once (int8 plus an
    fp32 scale a column, or bf16) with their mask bytes; 4 * nH * D operations
    for each live query-key pair (mask true, column below the limit), since a
    causal or tree mask needs only those. mask [B, S, L] or [S, L]; limits
    one int a slot."""
    m = mask.reshape(-1, *mask.shape[-2:])
    B, S, L = m.shape
    below = torch.arange(L, device=m.device) < torch.as_tensor(
        limits, device=m.device).reshape(B, 1, 1)
    pairs = int((m & below).sum())
    cols = float(sum(limits))
    kv_b = 1 + 4 / D if int8 else 2  # bytes per cached value
    return bound(2 * B * S * nH * D * 2 + 2 * cols * KVH * D * kv_b + S * cols,
                 4 * nH * D * pairs, "bf16")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def check_tc_route(counts, tag):
    """Every attention launch of a bf16 path took the tensor-core kernel."""
    n = sum(counts[k] for k in ("attend_flash", "attend_flash_int8", "attend_flash_batched",
                                "attend_flash_batched_int8"))
    check(n > 0 and counts["attend_flash_scalar"] == 0,
          f"{tag}: {counts['attend_flash_scalar']} of {n} attention launches took the scalar "
          f"kernel (bf16 q must take the tensor-core kernel)")


def graph_stats(eng):
    """An engine's CUDA graphs of its decode step: how many steps were
    captured, their replays, capture ms, memory pool GB (in all and by
    device) and segments a step (one graph a run of phases on one device,
    or an eager run; the most of any captured step), and, for the static
    and dynamic engines, the no-op replays and the blocks of replays, each
    one host read."""
    graphs = list(getattr(eng, "_decode_graphs", getattr(eng, "_segment_graphs", {})).values())
    by_device = {}
    for g in graphs:
        for d, n in g.pool_bytes_by_device.items():
            by_device[str(d)] = by_device.get(str(d), 0.0) + n / 2**30
    res = dict(graphs=len(graphs), replays=sum(g.replays for g in graphs),
               capture_ms=sum(g.capture_ms for g in graphs),
               pool_gb=sum(g.pool_bytes for g in graphs) / 2**30, pool_gb_by_device=by_device,
               segments=max((g.segments for g in graphs), default=0))
    if hasattr(eng, "decode_stats"):
        res.update(noop_replays=eng.decode_stats["noop_replays"],
                   blocks=eng.decode_stats["blocks"])
    return res


# an offload target's captured step (JAX's `_offload_step`): the draft phase one
# graph, the streamed forward eager, the tail one graph reading the logits
# from a static buffer: (eager, phases, hops) of each segment
OFFLOAD_PLAN = [(False, ("draft",), ()), (True, ("streamed_forward",), ()),
                (False, ("commit", "compact0", "update"), ("logits",))]


def offload_plan(eng):
    """Every captured step of an engine is the offload plan."""
    return all([(e, n, h) for _, e, n, h in g.plan] == OFFLOAD_PLAN
               for g in eng._decode_graphs.values())


def check_graphed(eng, tag):
    """The engine decoded through captured CUDA graphs (a stepwise run fails)."""
    st = graph_stats(eng)
    check(st["graphs"] > 0 and st["replays"] > 0,
          f"{tag}: no CUDA graph was captured and replayed (the decode ran stepwise): {st}")
    return st


def stepwise(eng):
    """Make an engine take its eager loop, for a comparison with the graphs:
    a static or dynamic engine its stepwise loop (build_tree(); verify(), one
    host read a step), over an offload target its pipelined loop with the
    step's phases run eagerly (`_eager_decode_steps`), a batched engine its
    eager segments; `graphed(eng)` undoes it (call it before dropping an
    offload engine: the bound method would keep the engine in a cycle)."""
    if getattr(eng, "_offload", False):
        eng._run_decode_steps = eng._eager_decode_steps
    elif hasattr(eng, "_decode_graphs"):
        eng._can_decode_fused = lambda: False
    else:
        eng._run_segment = eng._segment_eager
    return eng


def graphed(eng):
    for name in ("_run_decode_steps", "_can_decode_fused", "_run_segment"):
        eng.__dict__.pop(name, None)
    return eng


# ---------------------------------------------------------------- phase 2


def kernel_checks(torch, dev):
    import torch.nn.functional as F

    from umbrella_tpu_torch.ops.kernels.embed_gather import embed_gather, embed_gather_ref

    gen, randn, err = kernel_inputs(torch, dev)
    bf16, f32 = torch.bfloat16, torch.float32
    report = {}

    # -- embed_gather: exact (a copy)
    V, H = CFG_8B["vocab_size"], CFG_8B["hidden_size"]
    embed = randn(V, H, scale=0.02)
    e_max = 0.0
    for S in (1, 24, 127, 128):
        ids = torch.randint(0, V, (S,), generator=gen, device=dev, dtype=torch.int32)
        e, _ = err(embed_gather(embed, ids), embed_gather_ref(embed, ids))
        check(e == 0.0, f"embed_gather S={S}: max abs err {e} (must be exact)")
        e_max = max(e_max, e)
    ids = torch.randint(0, V, (127,), generator=gen, device=dev, dtype=torch.int32)
    by, _ = bound(2 * 127 * H * 2 + 127 * 4, 0, "bf16")
    report["embed_gather"] = dict(
        shape="[128256,4096] bf16, S=127", tolerance="exact", max_abs_err=e_max,
        ms=cuda_ms(torch, lambda: embed_gather(embed, ids)),
        plain_ms=cuda_ms(torch, lambda: embed_gather_ref(embed, ids)),
        library_ms=cuda_ms(torch, lambda: F.embedding(ids, embed)),
        bound_ms=by, bound_by="bytes", launch_floor_ms=launch_floor_ms(torch, dev, 127))
    del embed
    report["embed_gather"]["training_shape"] = embed_gather_training_shape(torch, dev, gen, randn,
                                                                          err)
    log(f"[kernels] embed_gather {report['embed_gather']}")

    report.update(attention_checks(torch, dev, gen, randn, err))

    report.update(w4a8_checks(torch, dev, gen, randn, err))
    report.update(w4a16_checks(torch, dev, gen, randn, err))
    tp = tp_kernel_checks(torch, dev, gen, randn, err)
    w = report["w4a16_matmul"]
    w["per_shape"].update(tp["w4a16"])
    w["max_abs_err"] = max(w["max_abs_err"], tp["w4a16_max_abs_err"])
    w["max_rel_err"] = max(w["max_rel_err"], tp["w4a16_max_rel_err"])
    report["attend_flash"]["per_shape"].update(tp["attention"])
    return report


def embed_gather_training_shape(torch, dev, gen, randn, err):
    """embed_gather at [train]'s lookup (draft/config.json's [32768, 1280]
    bf16 table, B 8 x seq 1024 = 8,192 ids): exact, timed beside its bound,
    the plain version and F.embedding; and the backward
    (embed_gather_backward, plain torch) beside its bound and
    aten.embedding_dense_backward, for random ids and for ids of [train]'s
    periodic stream (TRAIN_PERIOD distinct rows, each repeated ~134 times)."""
    import torch.nn.functional as F

    from umbrella_tpu_torch.ops.kernels.embed_gather import (embed_gather,
                                                             embed_gather_backward,
                                                             embed_gather_ref)

    V, H, S = 32768, 1280, TRAIN_BATCH * TRAIN_SEQ
    table = randn(V, H, scale=0.02)
    ids = torch.randint(0, V, (S,), generator=gen, device=dev, dtype=torch.int32)
    e, _ = err(embed_gather(table, ids), embed_gather_ref(table, ids))
    check(e == 0.0, f"embed_gather training shape: max abs err {e} (must be exact)")
    upstream = randn(S, H)
    periodic = torch.from_numpy(period_stream(V, S)).to(dev)
    by, _ = bound(2 * S * H * 2 + S * 4, 0, "bf16")
    # the backward reads the upstream gradient and the ids, writes the [V, H] table
    # gradient once; S * H adds
    bb, bb_by = bound(S * H * 2 + S * 4 + V * H * 2, S * H, "bf16")
    res = dict(shape=f"[{V},{H}] bf16, S={S}", tolerance="exact", max_abs_err=e,
               ms=cuda_ms(torch, lambda: embed_gather(table, ids)),
               plain_ms=cuda_ms(torch, lambda: embed_gather_ref(table, ids)),
               library_ms=cuda_ms(torch, lambda: F.embedding(ids, table)),
               bound_ms=by, bound_by="bytes",
               backward_ms=cuda_ms(torch, lambda: embed_gather_backward(upstream, ids, V,
                                                                        torch.bfloat16)),
               backward_ms_periodic_ids=cuda_ms(torch, lambda: embed_gather_backward(
                   upstream, periodic, V, torch.bfloat16)),
               backward_bound_ms=bb, backward_bound_by=bb_by,
               backward_library_ms=library_ms(
                   torch, lambda: torch.ops.aten.embedding_dense_backward(upstream, ids.long(), V,
                                                                          -1, False)))
    return res


def empty_kernel(torch, dev, S, n=1):
    """A function that launches n times a kernel that does nothing
    (csrc/embed_gather.cu `empty_launch`, `empty_rows`: S blocks of 256
    threads, embed_gather's launch at S rows) on dev's current stream."""
    import ctypes

    from umbrella_tpu_torch.ops.kernels import build

    fn = build.library("embed_gather").empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    anchor = torch.zeros(1, device=dev)

    def launch():
        with build.on_device(anchor) as st:
            for _ in range(n):
                build.check(fn(S, st), "empty_launch")

    return launch


def launch_floor_ms(torch, dev, S):
    """cuda_ms of the empty kernel launched as embed_gather launches at S
    rows, timed as every kernel is: the floor of one launch."""
    return cuda_ms(torch, empty_kernel(torch, dev, S))


def attention_phase(torch, dev):
    """The attention kernels alone (phase `attention`): the cheap loop for them."""
    gen, randn, err = kernel_inputs(torch, dev)
    return attention_checks(torch, dev, gen, randn, err)


def attention_checks(torch, dev, gen, randn, err):
    """The tree_attention family (csrc/tree_attention.cu): attend_flash at the
    verify shape (and the 70B verify shape), the int8 and batched kernels at
    the serving shapes, each against its plain version with timings; then
    the tensor-core kernel's properties: rows bit for bit the same across S
    and B, limit isolation, soft cap, empty rows, and the kernel each dtype
    takes."""
    import torch.nn.functional as F

    from umbrella_tpu_torch.ops.kernels.tree_attention import attend_dense, attend_flash
    from umbrella_tpu_torch.ops.masks import causal_mask_rows, tree_mask_rows
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    report = {}
    # -- attend_flash: bf16, layered [4, 8, 2048, 128] cache, odd kv_limit
    nH, KVH, D = 32, 8, 128
    kc = randn(4, KVH, MAX_LEN, D)
    vc = randn(4, KVH, MAX_LEN, D)
    gm = growmap_from_spec(24, 6, acc=ACC_24x6)
    bitmap = torch.as_tensor(gm.bitmap, device=dev)
    nn = 301  # committed prefix: kv_limit = nn + S is odd for even S
    a_max, a_rel = 0.0, 0.0
    cases = {1: "causal", 24: "causal", gm.size: "tree", 512: "causal"}
    for S, kind in cases.items():
        q = randn(S, nH, D)
        mask = (tree_mask_rows(nn, bitmap, MAX_LEN) if kind == "tree"
                else causal_mask_rows(nn, S, MAX_LEN, device=dev))
        for layer in (0, 3):
            got = attend_flash(q, kc, vc, mask, nn + S, layer)
            ref = attend_dense(q, kc[layer], vc[layer], mask)
            e, m = err(got, ref)
            check(e <= 2e-2 * m, f"attend_flash S={S} layer={layer}: err {e} vs max {m}")
            a_max, a_rel = max(a_max, e), max(a_rel, e / m)
    S = gm.size
    kv_limit = nn + S
    q = randn(S, nH, D)
    mask = tree_mask_rows(nn, bitmap, MAX_LEN)
    qs = q.transpose(0, 1)[None]
    ks, vs = kc[3:4, :, :kv_limit], vc[3:4, :, :kv_limit]
    ms_ = mask[None, None, :, :kv_limit]

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=ms_, enable_gqa=True)

    by, bb = attention_bound(torch, mask, [kv_limit], nH, KVH, D, False)
    report["attend_flash"] = dict(
        shape=f"q [{S},32,128] bf16 vs [4,8,2048,128] cache, tree mask, kv_limit={kv_limit}",
        tolerance="max abs err <= 2e-2 * max|plain| (bf16 output; p rounded at other points)",
        max_abs_err=a_max, max_rel_err=a_rel,
        ms=cuda_ms(torch, lambda: attend_flash(q, kc, vc, mask, kv_limit, 3)),
        plain_ms=cuda_ms(torch, lambda: attend_dense(q, kc[3], vc[3], mask)),
        library_ms=library_ms(torch, sdpa), bound_ms=by, bound_by=bb)
    log(f"[kernels] attend_flash {report['attend_flash']}")
    del kc, vc
    torch.cuda.empty_cache()
    report["attend_flash"]["per_shape"] = {"70B verify q [127,64,128]": attention_70b_verify(
        torch, dev, randn, err), **attention_dynamic_shapes(torch, dev, randn, err)}
    torch.cuda.empty_cache()
    report.update(attention_int8_and_batched_checks(torch, dev, gen, randn, err))
    report["attend_flash"]["tensor_core_checks"] = attention_tc_checks(torch, dev, gen, randn, err)
    return report


def kernel_inputs(torch, dev):
    """The kernel checks' seeded generator, a randn(*shape, scale, dtype) on the
    card, and err(got, ref) -> (max abs err, max |ref|)."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()

    return gen, randn, err


def w4a16_phase(torch, dev):
    """The W4A16 family alone (phase `w4a16`): the cheap loop for its kernel."""
    gen, randn, err = kernel_inputs(torch, dev)
    return w4a16_checks(torch, dev, gen, randn, err)


def w4a16_checks(torch, dev, gen, randn, err):
    """The W4A16 kernel family (plain, layered, fused gate-up-SiLU), each held
    against its plain version, row invariance bitwise, and timings."""
    report = {}
    report.update(w4a16_plain_checks(torch, dev, gen, randn, err))
    report.update(gate_up_silu_checks(torch, dev, gen, randn, err))
    report.update(layered_kernel_checks(torch, dev, gen, randn, err))
    report["w4a16_matmul"]["row_invariance"] = w4a16_row_invariance(torch, dev, gen, randn)
    return report


def w4a16_bound(K, N, S, out_cols, G):
    """Least time for x [S, K] bf16 @ W4 [K, N] g128 -> [S, out_cols] bf16:
    packed weights, scales and zeros, x and y once; 2*S*K*N bf16 operations."""
    return bound(K // 2 * N + 2 * G * N * 2 + S * K * 2 + S * out_cols * 2, 2 * S * K * N,
                 "bf16")


# row counts that reach every token width the W4A16 kernel has: 32 (S <= 32),
# 64, 128, 192 and 256, and a second super-tile (S > 256)
W4A16_ROWS = (1, 24, 48, 127, 160, 224, 300)


def w4a16_plain_checks(torch, dev, gen, randn, err):
    """w4a16_matmul at the four 8B AWQ layer shapes, at every W4A16_ROWS row
    count, against the plain version with bf16 and fp32 output, and fp32 x
    with fp32 scales (the lossless phases' dtypes); the group size 32 at one
    shape (K split); times at S=24 (a draft level), 127 (a verify pass) and
    224 ([serve]'s rows), by graph replay (`ms`) and by events around
    back-to-back calls (`events_ms`, the host's launch cost included); the
    four 70B layer shapes at S=256 and 257 (the offload configs' verify),
    held and timed too.
    Library yardstick: torch.matmul on the pre-dequantized bf16 weight."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import (_dequant_halves_bf16, _plan, w4a16_matmul,
                                                      w4a16_matmul_ref)
    from umbrella_tpu_torch.quantization.awq import quantize_pack_device

    bf16, f32 = torch.bfloat16, torch.float32
    w_max, w_rel, shapes_ms = 0.0, 0.0, {}
    for name, (K, N) in LAYER_SHAPES.items():
        q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128, bf16)
        for S in W4A16_ROWS:
            x = randn(S, K)
            for od, tol in ((f32, 1e-4), (bf16, 2 ** -7)):
                got = w4a16_matmul(x, q, out_dtype=od)
                ref = w4a16_matmul_ref(x, q, out_dtype=od)
                e, m = err(got, ref)
                check(e <= tol * m, f"w4a16 {name} S={S} {od}: err {e} vs max {m}")
                w_max, w_rel = max(w_max, e), max(w_rel, e / m)
        q32 = q._replace(scales=q.scales.float(), zeros=q.zeros.float())
        for S in W4A16_ROWS:
            x = randn(S, K, dtype=f32)
            e, m = err(w4a16_matmul(x, q32), w4a16_matmul_ref(x, q32))
            check(e <= 1e-4 * m, f"w4a16 {name} S={S} fp32 x/scales: err {e} vs max {m}")
            w_max, w_rel = max(w_max, e), max(w_rel, e / m)
        del q32
        w_deq = _dequant_halves_bf16(q)
        for S in (24, 127, 224):
            x = randn(S, K)
            by, bb = w4a16_bound(K, N, S, N, K // 128)
            shapes_ms[f"{name} S={S}"] = dict(
                splits=_plan(S, K, N, 1, 128)["splits"],
                ms=cuda_ms(torch, lambda: w4a16_matmul(x, q)),
                events_ms=cuda_ms(torch, lambda: w4a16_matmul(x, q), graph=False),
                plain_ms=cuda_ms(torch, lambda: w4a16_matmul_ref(x, q), iters=5),
                library_ms=cuda_ms(torch, lambda: torch.matmul(x, w_deq)),
                bound_ms=by, bound_by=bb)
            log(f"[kernels] w4a16_matmul {name} K={K} N={N} S={S} {shapes_ms[f'{name} S={S}']}")
        del q, w_deq
    torch.cuda.empty_cache()
    for name, (K, N) in LAYER_SHAPES_70B.items():  # the offload configs' verify: 257 rows
        q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128, bf16)
        w_deq = _dequant_halves_bf16(q)
        for S in (256, 257):
            x = randn(S, K)
            e, m = err(w4a16_matmul(x, q), w4a16_matmul_ref(x, q))
            check(e <= 2 ** -7 * m, f"w4a16 70B {name} S={S}: err {e} vs max {m}")
            w_max, w_rel = max(w_max, e), max(w_rel, e / m)
            by, bb = w4a16_bound(K, N, S, N, K // 128)
            shapes_ms[f"70B {name} S={S}"] = dict(
                splits=_plan(S, K, N, 1, 128)["splits"],
                ms=cuda_ms(torch, lambda: w4a16_matmul(x, q)),
                plain_ms=cuda_ms(torch, lambda: w4a16_matmul_ref(x, q), iters=5),
                library_ms=cuda_ms(torch, lambda: torch.matmul(x, w_deq)),
                bound_ms=by, bound_by=bb)
            log(f"[kernels] w4a16_matmul 70B {name} K={K} N={N} S={S} "
                f"{shapes_ms[f'70B {name} S={S}']}")
        del q, w_deq
    torch.cuda.empty_cache()
    g32 = w4a16_group32_checks(torch, dev, gen, randn, err)
    w_max, w_rel = max(w_max, g32["max_abs_err"]), max(w_rel, g32["max_rel_err"])
    exact = w4a16_dequant_exact(torch, dev, gen)
    return {"w4a16_matmul": dict(
        dequant_bit_exact=exact, group_size_32=g32,
        shape="x [127,4096] bf16 @ W4 [4096,28672] (gate_up), bf16 out",
        tolerance="max abs err <= 1e-4 * max|plain| (fp32 out), 2**-7 * max|plain| (bf16 out)",
        max_abs_err=w_max, max_rel_err=w_rel, per_shape=shapes_ms,
        **shapes_ms["gate_up S=127"])}


def w4a16_group32_checks(torch, dev, gen, randn, err):
    """The group size 32 (a group is half a stage): w4a16_matmul at the 8B wqkv
    shape (K split) and w4a16_gate_up_silu on the same weight as a gate|up
    pair, S=1, 24, 127 and 300, bf16 x with bf16 scales and fp32 x with fp32
    scales, against the plain versions."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import (_plan, w4a16_gate_up_silu,
                                                      w4a16_gate_up_silu_ref, w4a16_matmul,
                                                      w4a16_matmul_ref)
    from umbrella_tpu_torch.quantization.awq import quantize_pack_device

    bf16, f32 = torch.bfloat16, torch.float32
    K, N = LAYER_SHAPES["wqkv"]
    q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 32, bf16)
    check(q.scales.shape[0] == K // 32, "w4a16 g32: the weight is not in groups of 32")
    forms = {bf16: q, f32: q._replace(scales=q.scales.float(), zeros=q.zeros.float())}
    e_max, e_rel = 0.0, 0.0
    for S in (1, 24, 127, 300):
        for xd, qq in forms.items():
            x = randn(S, K, dtype=xd)
            tol = 2 ** -7 if xd == bf16 else 1e-4
            for form, fn, ref in (("plain", w4a16_matmul, w4a16_matmul_ref),
                                  ("fused", w4a16_gate_up_silu, w4a16_gate_up_silu_ref)):
                e, m = err(fn(x, qq), ref(x, qq))
                check(e <= tol * m, f"w4a16 g32 {form} S={S} {xd}: err {e} vs max {m}")
                e_max, e_rel = max(e_max, e), max(e_rel, e / m)
    held = dict(shape=f"8B wqkv [{K},{N}] g32", splits=_plan(127, K, N, 1, 32)["splits"],
                max_abs_err=e_max, max_rel_err=e_rel)
    log(f"[kernels] w4a16 group size 32 (plain and fused, S=1, 24, 127, 300): {held}")
    return held


def w4a16_dequant_exact(torch, dev, gen):
    """eye(K) @ W through the kernel (fp32 out) equals the plain version's
    dequantized weight bit for bit: with bf16 scales and integer zeros (the
    kernel's packed bf16x2 form), the same in groups of 32, fp32 scales, and
    bf16 scales with zeros off the integers (both the fp32 form) -- at the 8B
    wo shape."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import _dequant_halves_bf16, w4a16_matmul
    from umbrella_tpu_torch.quantization.awq import quantize_pack_device

    K, N = LAYER_SHAPES["wo"]
    q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128,
                             torch.bfloat16)
    eye = torch.eye(K, device=dev, dtype=torch.bfloat16)
    forms = {"bf16 scales, integer zeros": q,
             "bf16 scales, integer zeros, g32": quantize_pack_device(
                 torch.randn((K, N), generator=gen, device=dev) * 0.02, 32, torch.bfloat16),
             "fp32 scales": q._replace(scales=q.scales.float(), zeros=q.zeros.float()),
             "bf16 scales, zeros + 0.5": q._replace(zeros=q.zeros + 0.5)}
    held = {}
    for name, qq in forms.items():
        got = w4a16_matmul(eye, qq, out_dtype=torch.float32)
        held[name] = bool(torch.equal(got, _dequant_halves_bf16(qq).float()))
        check(held[name], f"w4a16 eye(K) @ W ({name}) differs from the dequantized weight")
    log(f"[kernels] w4a16 dequantization bit for bit (eye(K) @ W, 8B wo): {held}")
    return held


def w4a16_row_invariance(torch, dev, gen, randn):
    """Row j of S=300 equals row j at every other W4A16_ROWS count (each token
    width of the kernel), bitwise, for the
    plain mode, the layered mode (layer 1 of a stack of 2) and the fused
    gate-up-SiLU, with bf16 and fp32 x, at the 8B gate_up shape (unsplit) and
    the 70B wo shape (K split; for the fused form a gate|up pair of its
    width)."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import _plan, w4a16_gate_up_silu, w4a16_matmul
    from umbrella_tpu_torch.quantization.awq import AwqTensor, quantize_pack_device

    shapes = {"8B gate_up": LAYER_SHAPES["gate_up"], "70B wo": LAYER_SHAPES_70B["wo"]}
    held = {}
    for name, (K, N) in shapes.items():
        stack = [quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128,
                                      torch.bfloat16) for _ in range(2)]
        stack = AwqTensor(*(torch.stack([q[f] for q in stack]) for f in range(3)))
        plain = AwqTensor(*(t[1] for t in stack))
        idx = torch.tensor(1, dtype=torch.int32, device=dev)
        forms = {"plain": lambda x: w4a16_matmul(x, plain),
                 "layered": lambda x: w4a16_matmul(x, stack, layer_idx=idx),
                 "fused": lambda x: w4a16_gate_up_silu(x, plain)}
        for xd in (torch.bfloat16, torch.float32):
            x = randn(W4A16_ROWS[-1], K, dtype=xd)
            for form, fn in forms.items():
                whole = fn(x)
                for S in W4A16_ROWS[:-1]:
                    check(torch.equal(fn(x[:S].contiguous()), whole[:S]),
                          f"w4a16 {form} {name} {xd}: rows of S={S} differ from S=300's")
        held[name] = dict(splits=_plan(300, K, N, 1, 128)["splits"],
                          fused_splits=_plan(300, K, N // 2, 2, 128)["splits"])
        del stack, plain
        torch.cuda.empty_cache()
    check(any(v["splits"] > 1 for v in held.values()),
          "w4a16 row invariance: no shape splits K")
    rows = f"S={', '.join(map(str, W4A16_ROWS[:-1]))} vs {W4A16_ROWS[-1]}"
    log(f"[kernels] w4a16 row invariance held ({rows}; plain, layered, fused; bf16 and fp32 "
        f"x): {held}")
    return dict(rows=rows, forms=["plain", "layered", "fused"],
                x_dtypes=["bf16", "fp32"], shapes=held)


def gate_up_silu_checks(torch, dev, gen, randn, err):
    """w4a16_gate_up_silu at the 8B gate_up shape [4096, 28672], at every
    W4A16_ROWS row count, bf16 and fp32 x, against its plain version; times at
    S=24, 127 and 224 beside the plain mode's on the same weight (graph
    replay, and `events_ms` by events around back-to-back calls). Library
    yardstick: torch.matmul on the pre-dequantized bf16 weight + F.silu * mul."""
    import torch.nn.functional as F

    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.ops.kernels.w4a16 import (_dequant_halves_bf16, w4a16_gate_up_silu,
                                                      w4a16_gate_up_silu_ref, w4a16_matmul)
    from umbrella_tpu_torch.quantization.awq import awq_gate_up_silu, quantize_pack_device

    bf16, f32 = torch.bfloat16, torch.float32
    K, N = LAYER_SHAPES["gate_up"]
    I, G = N // 2, K // 128
    q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128, bf16)
    w_deq = _dequant_halves_bf16(q)
    s_max, s_rel = 0.0, 0.0
    for S in W4A16_ROWS:
        for xd in (bf16, f32):
            x = randn(S, K, dtype=xd)
            e, m = err(w4a16_gate_up_silu(x, q), w4a16_gate_up_silu_ref(x, q))
            tol = 2 ** -7 if xd == bf16 else 1e-4
            check(e <= tol * m, f"w4a16_gate_up_silu S={S} {xd}: err {e} vs max {m}")
            s_max, s_rel = max(s_max, e), max(s_rel, e / m)
    xs = {S: randn(S, K) for S in (24, 127, 224)}
    gs_ms = {}
    for S, x in xs.items():
        def lib():
            gu = torch.matmul(x, w_deq)
            return F.silu(gu[:, :I]) * gu[:, I:]

        by, bb = w4a16_bound(K, N, S, I, G)
        gs_ms[f"S={S}"] = dict(
            ms=cuda_ms(torch, lambda: w4a16_gate_up_silu(x, q)),
            events_ms=cuda_ms(torch, lambda: w4a16_gate_up_silu(x, q), graph=False),
            plain_mode_ms=cuda_ms(torch, lambda: w4a16_matmul(x, q)),
            plain_ms=cuda_ms(torch, lambda: w4a16_gate_up_silu_ref(x, q), iters=5),
            library_ms=cuda_ms(torch, lib), bound_ms=by, bound_by=bb)
    log(f"[kernels] w4a16_gate_up_silu gate_up {gs_ms}")
    # no shipped config reaches the fused form (nor does the JAX package's
    # default): its launches come from awq_gate_up_silu(fused=True), the opt-in
    reset_launch_counts()
    for x in xs.values():
        awq_gate_up_silu(x, q, fused=True)
    torch.cuda.synchronize()
    fused_counts = launch_counts()
    check(fused_counts["w4a16_gate_up_silu"] == len(xs),
          f"awq_gate_up_silu(fused=True) launched {fused_counts['w4a16_gate_up_silu']} kernels")
    del q, w_deq
    torch.cuda.empty_cache()
    return {"w4a16_gate_up_silu": dict(
        shape="x [127,4096] bf16 @ packed W4 gate|up [4096,28672] -> [127,14336] bf16",
        tolerance="max abs err <= 2**-7 * max|plain| (bf16 out), 1e-4 * max|plain| (fp32 x)",
        max_abs_err=s_max, max_rel_err=s_rel, per_shape=gs_ms, launches=fused_counts,
        launches_per_step={"w4a16_gate_up_silu": None}, **gs_ms["S=127"])}


def layered_kernel_checks(torch, dev, gen, randn, err):
    """w4a16_matmul's layered mode on a stack of 4 layers at each of the 70B
    layer shapes (wqkv, wo, gate_up, down; g128), S=127 (a verify pass) and
    S=24 (a draft level): on every layer equal to the plain mode on that layer
    bit for bit, and within 2**-7 x max|y| of the plain version (bf16 out).
    wo and down split K over blocks (partial sums, then a fixed-order
    reduction), wqkv and gate_up do not: both routes are held. An index past
    the stack traps (in a child process: a trap ends the CUDA context). Times
    beside the plain mode's on the same layer; library yardstick: torch.matmul
    on the pre-dequantized bf16 layer; `events_ms` by events around
    back-to-back calls (the host's launch cost included). The reported row is
    gate_up."""
    from umbrella_tpu_torch.ops.kernels.w4a16 import (_dequant_halves_bf16, _plan, select_layer,
                                                      w4a16_matmul, w4a16_matmul_ref)
    from umbrella_tpu_torch.quantization.awq import AwqTensor, quantize_pack_device

    bf16 = torch.bfloat16
    n = 4
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    e_max, e_rel, per_shape = 0.0, 0.0, {}
    for name, (K, N) in LAYER_SHAPES_70B.items():
        G = K // 128
        splits = _plan(127, K, N, 1, 128)["splits"]
        stacked = [quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02,
                                        128, bf16) for _ in range(n)]
        stacked = AwqTensor(*(torch.stack([q[f] for q in stacked]) for f in range(3)))
        for S in (127, 24):
            x = randn(S, K)
            for i in range(n):
                got = w4a16_matmul(x, stacked, layer_idx=idx[i])
                plain = w4a16_matmul(x, AwqTensor(*(t[i] for t in stacked)))
                check(torch.equal(got, plain), f"w4a16 layered {name} S={S} layer {i}: differs "
                      "from the plain mode on that layer")
                e, m = err(got, w4a16_matmul_ref(x, select_layer(stacked, idx[i])))
                check(e <= 2 ** -7 * m, f"w4a16 layered {name} S={S} layer {i}: err {e} vs "
                      f"max {m}")
                e_max, e_rel = max(e_max, e), max(e_rel, e / m)
            layer2 = AwqTensor(*(t[2] for t in stacked))
            w_deq = _dequant_halves_bf16(layer2)
            by, bb = w4a16_bound(K, N, S, N, G)
            per_shape[f"{name} S={S}"] = dict(
                K=K, N=N, splits=splits,
                ms=cuda_ms(torch, lambda: w4a16_matmul(x, stacked, layer_idx=idx[2])),
                events_ms=cuda_ms(torch, lambda: w4a16_matmul(x, stacked, layer_idx=idx[2]),
                                  graph=False),
                plain_mode_ms=cuda_ms(torch, lambda: w4a16_matmul(x, layer2)),
                plain_ms=cuda_ms(torch,
                                 lambda: w4a16_matmul_ref(x, select_layer(stacked, idx[2])),
                                 iters=5),
                library_ms=cuda_ms(torch, lambda: torch.matmul(x, w_deq)), bound_ms=by,
                bound_by=bb)
            log(f"[kernels] w4a16_matmul_layered {name} 70B S={S} {per_shape[f'{name} S={S}']}")
            del w_deq
        del stacked
        torch.cuda.empty_cache()
    check(any(v["splits"] > 1 for v in per_shape.values())
          and any(v["splits"] == 1 for v in per_shape.values()),
          "w4a16 layered: the 70B shapes no longer cover both the split-K and the unsplit route")
    trapped = layered_index_trap()
    log(f"[kernels] w4a16_matmul_layered index past the stack: {trapped}")
    check(trapped.startswith("trapped"), "w4a16 layered: an index past the stack did not trap")
    return {"w4a16_matmul_layered": dict(
        shape="x [127,8192] bf16 @ layer 2 of a W4 stack [4,8192,57344] (70B gate_up), bf16 out",
        tolerance="equal to the plain mode on the same layer bit for bit, on each of 4 layers "
                  "at all four 70B layer shapes, S=127 and S=24; max abs err <= "
                  "2**-7 * max|plain| (bf16 out)",
        max_abs_err=e_max, max_rel_err=e_rel, bitwise_equal_to_plain_mode=True,
        out_of_range_index=trapped, per_shape=per_shape, **per_shape["gate_up S=127"])}


_TRAP_CHILD = """
import os, sys, torch
sys.path.insert(0, os.getcwd())
from umbrella_tpu_torch.ops.kernels.w4a16 import w4a16_matmul
from umbrella_tpu_torch.quantization.awq import AwqTensor
dev = torch.device("cuda:0")
q = AwqTensor(torch.zeros((2, 128, 256), dtype=torch.int8, device=dev),
              torch.ones((2, 2, 256), device=dev), torch.zeros((2, 2, 256), device=dev))
x = torch.ones((4, 256), device=dev)
try:
    w4a16_matmul(x, q, layer_idx=torch.tensor(2, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    print("ran", flush=True)
except RuntimeError as e:
    print("trapped:", str(e).splitlines()[0], flush=True)
os._exit(0)
"""


def layered_index_trap():
    """Launch the layered kernel with layer index 2 on a stack of 2 in a child
    process; returns what it printed ("trapped: <the CUDA error>" when the
    kernel stopped at the index)."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", _TRAP_CHILD], cwd=here, capture_output=True,
                         text=True, timeout=300)
    lines = (out.stdout + out.stderr).strip().splitlines()
    return next((ln for ln in lines if ln.startswith(("trapped", "ran"))),
                f"rc {out.returncode}: {lines[-1] if lines else ''}")


def w4a8_phase(torch, dev):
    """The int8 W4 kernels alone (phase `w4a8`): the cheap loop for them."""
    gen, randn, err = kernel_inputs(torch, dev)
    return w4a8_checks(torch, dev, gen, randn, err)


# row counts that reach every token width of the int8 kernel (Int4F 32, 64,
# 128, 192 and 256; AWQ 32 and 64) and its super-tiles; Int4F up to
# INT8_KERNEL_MAX_TOKENS, AWQ up to a 512-token prefill chunk
W4A8F_ROWS = (1, 24, 48, 127, 160, 224, 300, 384)
W4A8_ROWS = (1, 24, 48, 127, 160, 224, 300, 512)


def w4a8_checks(torch, dev, gen, randn, err):
    """The int8 W4 kernel family (csrc/w4a8.cu): the fused quantizer, the Int4F
    and the AWQ products, each held bit for bit against its plain version, rows
    of every S bit for bit the same rows of the largest S, and timings."""
    report = {}
    report.update(w4a8_quantize_checks(torch, dev, gen, randn))
    report.update(w4a8f_checks(torch, dev, gen, randn, err))
    report.update(w4a8_awq_checks(torch, dev, gen, randn, err))
    report["w4a8_matmul"]["ragged_k"] = w4a8_ragged_k_checks(torch, dev, gen, randn, err)
    return report


def w4a8_ragged_k_checks(torch, dev, gen, randn, err):
    """K/2 = 160: the last stage holds one k32 step of two. w4a8f_matmul and
    w4a8_matmul (g32, and g160: groups of 5 steps, which start and end
    half-way through stages) at [320, 256], every row count of W4A8F_ROWS /
    W4A8_ROWS: bit for bit the plain versions, rows of every S equal to the
    largest S's."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import w4a8_matmul, w4a8_matmul_ref
    from umbrella_tpu_torch.ops.kernels.w4a8f import w4a8f_matmul, w4a8f_matmul_ref
    from umbrella_tpu_torch.quantization.awq import quantize_pack_device
    from umbrella_tpu_torch.quantization.int4f import quantize_int4f

    K, N = 320, 256
    w = torch.randn((K, N), generator=gen, device=dev) * 0.02
    cases = {"int4f": (w4a8f_matmul, w4a8f_matmul_ref, quantize_int4f(w, 32, refine=0),
                       W4A8F_ROWS)}
    for gs in (32, 160):
        cases[f"awq g{gs}"] = (w4a8_matmul, w4a8_matmul_ref,
                               quantize_pack_device(w, gs, torch.bfloat16), W4A8_ROWS)
    for name, (fn, ref_fn, q, rows) in cases.items():
        x = randn(rows[-1], K)
        ref, whole = ref_fn(x, q), fn(x, q)
        for S in rows:
            got = whole if S == rows[-1] else fn(x[:S].contiguous(), q)
            check(torch.equal(got, ref[:S]), f"w4a8 ragged K {name} S={S}: max abs err "
                  f"{err(got, ref[:S])[0]} (must be exact)")
            check(torch.equal(got, whole[:S]), f"w4a8 ragged K {name} S={S}: rows differ")
    held = f"[{K},{N}]: {', '.join(cases)} exact and row-invariant"
    log(f"[kernels] w4a8 ragged K/2 (last stage one step): {held}")
    return held


def w4a8_quantize_checks(torch, dev, gen, randn):
    """The fused quantizer (one launch: xq, sx and the row sums) bit for bit
    the plain quantizers: x * a with the whole row's sum (Int4F) and x with
    sums per group of 128 and 32 (AWQ), K = 4096 and 14336, bf16 and fp32 x,
    S = 1, 24, 127 and 384. Timed at the Int4F lm_head's call, x [127, 4096]
    bf16."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import (group_rowsums, quantize_activations_w4a8,
                                                     quantize_rows)
    from umbrella_tpu_torch.ops.kernels.w4a8f import quantize_activations_int8

    held = 0
    for K in (4096, 14336):
        a = torch.rand(K, generator=gen, device=dev) + 0.5
        for S in (1, 24, 127, 384):
            for xd in (torch.bfloat16, torch.float32):
                x = randn(S, K, dtype=xd) * torch.rand(S, 1, generator=gen, device=dev).to(xd) * 8
                xq, sx, rs = quantize_rows(x, a)
                rq, rsx, rrs = quantize_activations_int8(x, a)
                check(torch.equal(xq, rq) and torch.equal(sx, rsx[:, 0]) and torch.equal(rs, rrs),
                      f"w4a8_quantize Int4F K={K} S={S} {xd}: differs from the plain version")
                rq, rsx = quantize_activations_w4a8(x)
                for gs in (128, 32):
                    xq, sx, rs = quantize_rows(x, None, gs)
                    check(torch.equal(xq, rq) and torch.equal(sx, rsx[:, 0])
                          and torch.equal(rs, group_rowsums(rq, gs)),
                          f"w4a8_quantize AWQ g{gs} K={K} S={S} {xd}: differs from the plain "
                          "version")
                held += 3
    S, K = 127, 4096
    x, a = randn(S, K), torch.rand(K, generator=gen, device=dev) + 0.5
    by, bb = bound(S * K * 2 + K * 4 + S * K + S * 4 + S * 4, 0, "int8")
    row = dict(
        shape="x [127,4096] bf16 * a -> xq int8, sx fp32, rowsum int32 (the Int4F lm_head's call)",
        tolerance="bit for bit (xq, sx and the row sums equal the plain quantizer's)",
        max_abs_err=0.0, cases_held=held,
        ms=cuda_ms(torch, lambda: quantize_rows(x, a)),
        events_ms=cuda_ms(torch, lambda: quantize_rows(x, a), graph=False),
        plain_ms=cuda_ms(torch, lambda: quantize_activations_int8(x, a)),
        library_ms=None, bound_ms=by, bound_by=bb)
    log(f"[kernels] w4a8_quantize {row}")
    return {"w4a8_quantize": row}


def w4a8f_checks(torch, dev, gen, randn, err):
    """w4a8f_matmul at the four 8B layer shapes and the lm_head, bf16 x with fp32
    and bf16 output at every W4A8F_ROWS count, and fp32 x at S=1, 127 and 384:
    equal to the plain version bit for bit (exact integer sums, the same fp32
    epilogue), and the rows of every S equal to the same rows of S=384. Times
    at S=24 (a draft level), 127 (a verify pass) and 224 ([serve-config]'s
    rows), by graph replay (`ms`) and by events around back-to-back calls
    (`events_ms`, the host's time per call included). Library yardstick:
    torch._int_mm on the unpacked int8 weight."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import _plan
    from umbrella_tpu_torch.ops.kernels.w4a8f import (quantize_activations_int8, w4a8f_matmul,
                                                      w4a8f_matmul_ref)
    from umbrella_tpu_torch.quantization.int4f import quantize_int4f

    bf16, f32 = torch.bfloat16, torch.float32
    big = W4A8F_ROWS[-1]
    per_shape, splits = {}, {}
    for name, (K, N) in dict(LAYER_SHAPES, lm_head=(4096, CFG_8B["vocab_size"])).items():
        q = quantize_int4f(torch.randn((K, N), generator=gen, device=dev) * 0.02, refine=0)
        splits[name] = _plan(1, K, N)["splits"]
        cases = [(bf16, f32, W4A8F_ROWS), (bf16, bf16, W4A8F_ROWS), (f32, f32, (1, 127, big))]
        for xd, od, rows in cases:
            x = randn(big, K, dtype=xd)
            ref = w4a8f_matmul_ref(x, q, out_dtype=od)
            whole = w4a8f_matmul(x, q, out_dtype=od)
            for S in rows:
                got = whole if S == big else w4a8f_matmul(x[:S].contiguous(), q, out_dtype=od)
                check(torch.equal(got, ref[:S]), f"w4a8f {name} S={S} x {xd} out {od}: max abs "
                      f"err {err(got, ref[:S])[0]} (must be exact)")
                check(torch.equal(got, whole[:S]),
                      f"w4a8f {name} S={S} x {xd} out {od}: rows differ from S={big}'s")
            del ref, whole
        w32 = q.w8.to(torch.int32)
        w_int8 = torch.cat([(w32 & 0xF) - 8, ((w32 >> 4) & 0xF) - 8]).to(torch.int8)
        del w32
        od = f32 if name == "lm_head" else bf16
        for S in (24, 127, 224):
            x = randn(S, K)
            xq = quantize_activations_int8(x, q.a)[0]
            by, bb = bound(S * K * 2 + K // 2 * N + N * 4 + K * 4 + S * N * od.itemsize,
                           2 * S * K * N, "int8")
            per_shape[f"{name} S={S}"] = dict(
                splits=splits[name], token_width=_plan(S, K, N)["token_width"],
                ms=cuda_ms(torch, lambda: w4a8f_matmul(x, q, out_dtype=od)),
                events_ms=cuda_ms(torch, lambda: w4a8f_matmul(x, q, out_dtype=od), graph=False),
                plain_ms=cuda_ms(torch, lambda: w4a8f_matmul_ref(x, q, out_dtype=od), iters=3,
                                 warmup=1),
                library_ms=library_ms(torch, lambda: torch._int_mm(xq, w_int8)),
                bound_ms=by, bound_by=bb)
            log(f"[kernels] w4a8f_matmul {name} K={K} N={N} S={S} {per_shape[f'{name} S={S}']}")
        del q, w_int8
        torch.cuda.empty_cache()
    check(any(v > 1 for v in splits.values()) and any(v == 1 for v in splits.values()),
          "w4a8f: the shapes no longer cover both the split-K and the unsplit route")
    rows = f"S={', '.join(map(str, W4A8F_ROWS))}"
    log(f"[kernels] w4a8f_matmul exact and row-invariant ({rows}; splits {splits})")
    return {"w4a8f_matmul": dict(
        shape="x [24,4096] bf16 @ Int4F [4096,128256] (lm_head at a draft level), fp32 out",
        tolerance=f"bit for bit the plain version (max abs err 0.0) at the 8B layer shapes and "
                  f"the lm_head, {rows}, bf16 and fp32 out; rows of every S equal to S={big}'s",
        max_abs_err=0.0, max_rel_err=0.0, splits_by_shape=splits, row_invariance=rows,
        per_shape=per_shape, **per_shape["lm_head S=24"])}


def w4a8_awq_checks(torch, dev, gen, randn, err):
    """w4a8_matmul at the 8B gate_up shape and the 8B down shape (K split 4
    ways), group sizes 128 and 32, bf16 and fp32 scales, fp32 zeros off the
    integers (the kernel's other fix-up), bf16 and fp32 x (out in x's dtype),
    at every W4A8_ROWS count: equal to the plain version bit for
    bit (exact integer products, the same fp32 fix-up order and split order),
    and the rows of every S equal to the same rows of S=512. Times at gate_up
    g128 S=24 and 127 (graph replay and events), beside w4a16_matmul on the
    same weight. Library yardstick: torch.matmul on the pre-dequantized bf16
    weight."""
    from umbrella_tpu_torch.ops.kernels.w4a8 import _plan, w4a8_matmul, w4a8_matmul_ref
    from umbrella_tpu_torch.ops.kernels.w4a16 import _dequant_halves_bf16, w4a16_matmul
    from umbrella_tpu_torch.quantization.awq import quantize_pack_device

    bf16, f32 = torch.bfloat16, torch.float32
    big = W4A8_ROWS[-1]
    splits, held = {}, 0
    for name in ("gate_up", "down"):
        K, N = LAYER_SHAPES[name]
        for gs in (128, 32):
            qb = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, gs,
                                      bf16)
            splits[f"{name} g{gs}"] = _plan(1, K, N, gs)["splits"]
            # integer zeros go into the weight bytes; zeros off the integers take
            # the kernel's row-sum fix-up
            forms = {"bf16": qb, "fp32": qb._replace(scales=qb.scales.float(),
                                                     zeros=qb.zeros.float()),
                     "fp32, zeros + 0.5,": qb._replace(scales=qb.scales.float(),
                                                       zeros=qb.zeros.float() + 0.5)}
            for sd, q in forms.items():
                for xd in (bf16, f32):
                    x = randn(big, K, dtype=xd)
                    ref = w4a8_matmul_ref(x, q)
                    whole = w4a8_matmul(x, q)
                    for S in W4A8_ROWS:
                        got = whole if S == big else w4a8_matmul(x[:S].contiguous(), q)
                        tag = f"w4a8 {name} g{gs} {sd} scales, x {xd}, S={S}"
                        check(torch.equal(got, ref[:S]),
                              f"{tag}: max abs err {err(got, ref[:S])[0]} (must be exact)")
                        check(torch.equal(got, whole[:S]), f"{tag}: rows differ from S={big}'s")
                        held += 1
                    del ref, whole
            del qb, forms
            torch.cuda.empty_cache()
    check(any(v > 1 for v in splits.values()) and any(v == 1 for v in splits.values()),
          "w4a8: the shapes no longer cover both the split-K and the unsplit route")
    K, N = LAYER_SHAPES["gate_up"]
    G = K // 128
    q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128, bf16)
    w_deq = _dequant_halves_bf16(q)
    w8_ms = {}
    for S in (24, 127):
        x = randn(S, K)
        by, bb = bound(K // 2 * N + 2 * G * N * 2 + S * K * 2 + S * N * 2, 2 * S * K * N, "int8")
        w8_ms[f"S={S}"] = dict(
            token_width=_plan(S, K, N, 128)["token_width"], splits=splits["gate_up g128"],
            ms=cuda_ms(torch, lambda: w4a8_matmul(x, q)),
            events_ms=cuda_ms(torch, lambda: w4a8_matmul(x, q), graph=False),
            plain_ms=cuda_ms(torch, lambda: w4a8_matmul_ref(x, q), iters=3, warmup=1),
            library_ms=cuda_ms(torch, lambda: torch.matmul(x, w_deq)),
            w4a16_ms=cuda_ms(torch, lambda: w4a16_matmul(x, q)),
            bound_ms=by, bound_by=bb)
    log(f"[kernels] w4a8_matmul gate_up {w8_ms}")
    del q, w_deq
    torch.cuda.empty_cache()
    rows = f"S={', '.join(map(str, W4A8_ROWS))}"
    log(f"[kernels] w4a8_matmul exact and row-invariant ({held} cases, {rows}; splits {splits})")
    return {"w4a8_matmul": dict(
        shape="x [127,4096] bf16 @ W4 [4096,28672] g128 (gate_up), int8 activations, bf16 out",
        tolerance=f"bit for bit the plain version (max abs err 0.0) at 8B gate_up and down, "
                  f"g128 and g32, bf16 and fp32 scales and x, integer zeros and zeros + 0.5, "
                  f"{rows}; rows of every S equal to S={big}'s",
        max_abs_err=0.0, max_rel_err=0.0, cases_held=held, splits_by_shape=splits,
        row_invariance=rows, per_shape=w8_ms, **w8_ms["S=127"])}


def attention_int8_and_batched_checks(torch, dev, gen, randn, err):
    """attend_flash_int8, attend_flash_batched and attend_flash_batched_int8 at
    the serving paths' shapes, each against its plain version on the same
    inputs. Library yardstick: F.scaled_dot_product_attention with a bool mask
    over the live columns (one call), after a dequantizing call for int8 KV
    (two calls, timed together)."""
    import torch.nn.functional as F

    from umbrella_tpu_torch.models.kv_cache import _quantize_block
    from umbrella_tpu_torch.ops.kernels.tree_attention import (
        attend_flash_batched, attend_flash_batched_ref, attend_flash_int8, attend_flash_ref)
    from umbrella_tpu_torch.ops.masks import (causal_mask_rows, tree_mask_rows,
                                              tree_mask_rows_batched)
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    nH, KVH, D, L = 32, 8, 128, MAX_LEN
    tol = "max abs err <= 2e-2 * max|plain| (bf16 output; p rounded at other points)"
    report = {}

    def cache(shape, int8):
        """Random K or V at `shape` (+D): bf16, or int8 with fp32 per-row scales."""
        x = randn(*shape, D)
        if not int8:
            return x, None
        q, s = _quantize_block(x)
        return q, s

    def check_pair(name, got, ref):
        e, m = err(got, ref)
        check(e <= 2e-2 * m, f"{name}: err {e} vs max {m}")
        return e, e / m

    def library(q, k, v, ks, vs, mask, live):
        """F.scaled_dot_product_attention over the first `live` columns of one
        layer's per-slot caches [B, KVH, L, D] (dequantized first for int8)."""
        qs = q.transpose(1, 2)
        msk = mask[:, None, :, :live]

        def deq():
            if ks is None:
                return k[:, :, :live], v[:, :, :live]
            return ((k[:, :, :live].float() * ks[:, :, :live, None]).to(q.dtype),
                    (v[:, :, :live].float() * vs[:, :, :live, None]).to(q.dtype))

        def run():
            kd, vd = deq()
            return F.scaled_dot_product_attention(qs, kd, vd, attn_mask=msk, enable_gqa=True)

        return library_ms(torch, run)

    def bound_of(mask, limits, int8):
        return attention_bound(torch, mask, limits, nH, KVH, D, int8)

    # -- attend_flash_int8: single slot, q [127, 32, 128] at kv_limit 428 (row 1's shape)
    gm = growmap_from_spec(24, 6, acc=ACC_24x6)
    nn, S = 301, gm.size
    kq, ks = cache((2, KVH, L), True)
    vq, vs = cache((2, KVH, L), True)
    mask = tree_mask_rows(nn, torch.as_tensor(gm.bitmap, device=dev), L)
    a_max, a_rel = 0.0, 0.0
    for S_, msk in ((S, mask), (1, causal_mask_rows(nn, 1, L, device=dev))):
        q = randn(S_, nH, D)
        for layer in (0, 1):
            got = attend_flash_int8(q, kq, vq, ks, vs, msk, nn + S_, layer)
            ref = attend_flash_ref(q, kq[layer], vq[layer], msk, nn + S_,
                                   k_scale=ks[layer], v_scale=vs[layer])
            e, r = check_pair(f"attend_flash_int8 S={S_} layer={layer}", got, ref)
            a_max, a_rel = max(a_max, e), max(a_rel, r)
    q = randn(S, nH, D)
    limit = nn + S
    by, bb = bound_of(mask, [limit], True)
    report["attend_flash_int8"] = dict(
        shape=f"q [{S},32,128] bf16 vs int8 [2,8,2048,128] cache + fp32 scales, tree mask, "
              f"kv_limit={limit}",
        tolerance=tol, max_abs_err=a_max, max_rel_err=a_rel,
        ms=cuda_ms(torch, lambda: attend_flash_int8(q, kq, vq, ks, vs, mask, limit, 1)),
        plain_ms=cuda_ms(torch, lambda: attend_flash_ref(q, kq[1], vq[1], mask, limit,
                                                         k_scale=ks[1], v_scale=vs[1]),
                         graph=False),
        # the plain version copies a host tensor, which a CUDA graph cannot capture
        plain_timed_by="events around 20 back-to-back calls (host time included)",
        library_ms=library(q[None], kq[1][None], vq[1][None], ks[1][None], vs[1][None],
                           mask[None], limit),
        library="dequantize (1 call) + scaled_dot_product_attention (1 call)",
        bound_ms=by, bound_by=bb)
    log(f"[kernels] attend_flash_int8 {report['attend_flash_int8']}")
    del kq, vq, ks, vs

    def batched_case(name, B, Bc, tree, int8, slot_S):
        """Decode shape (B slots, a `tree` growmap per slot, kv limits spread over
        135-300) and the one-slot prefill shape (q [1, slot_S] through `slots`)."""
        g = growmap_from_spec(*tree)
        T = g.size
        kc, ksc = cache((2, Bc, KVH, L), int8)
        vc, vsc = cache((2, Bc, KVH, L), int8)
        limits = torch.randint(135, 301, (B,), generator=gen, device=dev, dtype=torch.int32)
        nn = limits - T
        mask = tree_mask_rows_batched(nn, torch.as_tensor(g.bitmap, device=dev), L)
        q = randn(B, T, nH, D)
        scales = dict(k_scale=ksc, v_scale=vsc) if int8 else {}
        m_max, m_rel = 0.0, 0.0
        for layer in (0, 1):
            got = attend_flash_batched(q, kc, vc, mask, limits, layer, **scales)
            ref = attend_flash_batched_ref(q, kc, vc, mask, limits, layer, **scales)
            e, r = check_pair(f"{name} B={B} layer={layer}", got, ref)
            m_max, m_rel = max(m_max, e), max(m_rel, r)
        # prefill through the slot indirection: q [1, slot_S] into cache row 5
        qp = randn(1, slot_S, nH, D)
        pm = causal_mask_rows(0, slot_S, L, device=dev)[None]
        lim1 = torch.full((1,), slot_S, dtype=torch.int32, device=dev)
        slot = torch.full((1,), 5, dtype=torch.int32, device=dev)
        got = attend_flash_batched(qp, kc, vc, pm, lim1, 1, slots=slot, **scales)
        ref = attend_flash_batched_ref(qp, kc, vc, pm, lim1, 1, slots=slot, **scales)
        e, r = check_pair(f"{name} slots prefill S={slot_S}", got, ref)
        m_max, m_rel = max(m_max, e), max(m_rel, r)

        lims = limits.tolist()
        live = max(lims)
        per_slot = lambda t: None if t is None else t[1]  # noqa: E731
        by, bb = bound_of(mask, lims, int8)
        dec = dict(
            ms=cuda_ms(torch, lambda: attend_flash_batched(q, kc, vc, mask, limits, 1, **scales)),
            plain_ms=cuda_ms(torch, lambda: attend_flash_batched_ref(q, kc, vc, mask, limits, 1,
                                                                     **scales)),
            library_ms=library(q, kc[1], vc[1], per_slot(ksc), per_slot(vsc), mask, live),
            bound_ms=by, bound_by=bb)
        pby, pbb = bound_of(pm, [slot_S], int8)
        pick = (lambda t: None if t is None else t[1, 5:6])  # noqa: E731
        pre = dict(
            ms=cuda_ms(torch, lambda: attend_flash_batched(qp, kc, vc, pm, lim1, 1, slots=slot,
                                                           **scales)),
            plain_ms=cuda_ms(torch, lambda: attend_flash_batched_ref(qp, kc, vc, pm, lim1, 1,
                                                                     slots=slot, **scales)),
            library_ms=library(qp, kc[1, 5:6], vc[1, 5:6], pick(ksc), pick(vsc), pm, slot_S),
            bound_ms=pby, bound_by=pbb)
        kind = "int8 [2,%d,8,2048,128] + fp32 scales" % Bc if int8 else \
            "bf16 [2,%d,8,2048,128]" % Bc
        res = dict(
            shape=f"q [{B},{T},32,128] bf16 vs {kind} cache, {tree[0]}x{tree[1]} tree masks, "
                  f"kv_limits {min(lims)}-{max(lims)}",
            tolerance=tol, max_abs_err=m_max, max_rel_err=m_rel,
            library=("dequantize (1 call) + scaled_dot_product_attention (1 call)" if int8
                     else "scaled_dot_product_attention (1 call), bool mask"),
            per_shape={"decode": dec, f"prefill q [1,{slot_S}] via slots": pre}, **dec)
        log(f"[kernels] {name} {res}")
        return res

    report["attend_flash_batched_int8"] = batched_case(
        "attend_flash_batched_int8", 32, 32, (2, 3), True, 512)
    torch.cuda.empty_cache()
    report["attend_flash_batched"] = batched_case(
        "attend_flash_batched", 8, 8, (3, 4), False, 512)
    torch.cuda.empty_cache()
    return report


def attention_at(torch, dev, randn, err, tag, nH, KVH, D, L, mask, limit):
    """attend_flash at one shape: q [S, nH, D] bf16 against a [2, KVH, L, D]
    bf16 cache (layers 0 and 1 held against the plain version, 2e-2 of its
    max), timed beside its plain version, SDPA and its bound."""
    import torch.nn.functional as F

    from umbrella_tpu_torch.ops.kernels.tree_attention import attend_dense, attend_flash

    S = mask.shape[0]
    kc, vc = randn(2, KVH, L, D), randn(2, KVH, L, D)
    q = randn(S, nH, D)
    e_max, e_rel = 0.0, 0.0
    for layer in (0, 1):
        e, m = err(attend_flash(q, kc, vc, mask, limit, layer),
                   attend_dense(q, kc[layer], vc[layer], mask))
        check(e <= 2e-2 * m, f"attend_flash {tag} layer={layer}: err {e} vs max {m}")
        e_max, e_rel = max(e_max, e), max(e_rel, e / m)
    qs = q.transpose(0, 1)[None]
    ks, vs, ms_ = kc[1:2, :, :limit], vc[1:2, :, :limit], mask[None, None, :, :limit]
    by, bb = attention_bound(torch, mask, [limit], nH, KVH, D, False)
    res = dict(
        shape=f"q [{S},{nH},{D}] bf16 vs [2,{KVH},{L},{D}] cache (groups {nH // KVH}), "
              f"kv_limit={limit}",
        max_abs_err=e_max, max_rel_err=e_rel,
        ms=cuda_ms(torch, lambda: attend_flash(q, kc, vc, mask, limit, 1)),
        plain_ms=cuda_ms(torch, lambda: attend_dense(q, kc[1], vc[1], mask)),
        library_ms=library_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=ms_, enable_gqa=True)),
        bound_ms=by, bound_by=bb)
    log(f"[kernels] attend_flash {tag} {res}")
    return res


def attention_70b_verify(torch, dev, randn, err):
    """attend_flash at the 70B verify shape that [pp-config] runs 80 times a
    step: q [127, 64, 128] against 8 kv heads (groups 8) of a [2, 8, 8192, 128]
    bf16 cache (the pp4 config's max_length), the 24x6 tree mask at kv_limit
    428."""
    from umbrella_tpu_torch.ops.masks import tree_mask_rows
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    gm = growmap_from_spec(24, 6, acc=ACC_24x6)
    nn = 301
    mask = tree_mask_rows(nn, torch.as_tensor(gm.bitmap, device=dev), 8192)
    return attention_at(torch, dev, randn, err, "70B verify", CFG_70B["num_attention_heads"],
                        CFG_70B["num_key_value_heads"], 128, 8192, mask, nn + gm.size)


def attention_dynamic_shapes(torch, dev, randn, err):
    """attend_flash at the offload configs' shapes (max_length 8192, the
    prompt's 128 slots committed): the 70B target's 257-row verify over a
    16 x 16 dynamic tree, q [257, 64, 128], and a 1B draft level of 16 rows
    (level 8 of that tree), q [16, 32, 64] against 8 kv heads of head dim 64."""
    from umbrella_tpu_torch.ops.masks import tree_level_mask_rows, tree_mask_rows

    W, Dp = DYN_TREE["width"], DYN_TREE["depth"]
    bm = dynamic_bitmap(torch, dev, W, Dp, 2)
    nn, T = PROMPT_LEN, W * Dp + 1
    lvl = 8
    start = 1 + (lvl - 1) * W
    return {
        "70B dynamic verify q [257,64,128]": attention_at(
            torch, dev, randn, err, "70B dynamic verify", CFG_70B["num_attention_heads"],
            CFG_70B["num_key_value_heads"], 128, 8192, tree_mask_rows(nn, bm, 8192), nn + T),
        "1B draft level q [16,32,64]": attention_at(
            torch, dev, randn, err, "1B draft level", CFG_1B["num_attention_heads"],
            CFG_1B["num_key_value_heads"], CFG_1B["head_dim"], 8192,
            tree_level_mask_rows(nn, bm, start, W, 8192), nn + start + W)}


def attention_tc_checks(torch, dev, gen, randn, err):
    """What the tensor-core kernel (bf16 q) must hold beyond its tolerance,
    each for bf16 and int8 KV (8B widths, [2, (Bc,) 8, 2048, 128] caches):
    - which kernel: fp32 q and head dim 32 take the scalar kernel, bf16 q at
      head dim 128 the tensor-core kernel;
    - row invariance, bitwise: rows of S = 1, 24 and 127 equal the same rows
      of S = 512 (single slot, and one batched slot through `slots`) under
      the same mask rows and kv_limit; the mask lets even positions see only
      columns < 128, so a short launch skips KV tiles that the long one runs
      for the rows beside them. Each slot's rows of a B=32 decode launch
      equal the slot launched alone through `slots`;
    - limit isolation: 1e6 (bf16) or 127 with scales 1e6 (int8) past a slot's
      kv_limit, and its mask set past the limit, leave the output as it was,
      and so does a mask that starts 1 byte past a 16-byte boundary;
    - soft cap 30.0 at the verify shape (scores reach +-40), and a cache of
      odd length L = 301, within tolerance;
    - empty rows: rows with no live slot, and kv_limit 0, give exactly 0;
    - head dims 64 and 256 (attention_head_dim_checks)."""
    from umbrella_tpu_torch.models.kv_cache import _quantize_block
    from umbrella_tpu_torch.ops.kernels import tree_attention as ta
    from umbrella_tpu_torch.ops.masks import causal_mask_rows, tree_mask_rows, \
        tree_mask_rows_batched
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    nH, KVH, D, L = 32, 8, 128, MAX_LEN
    held = {}

    def caches(shape, head_dim=D):
        """bf16 K and V at `shape` + (head_dim,), and their int8 forms with fp32
        scales."""
        k, v = randn(*shape, head_dim), randn(*shape, head_dim)
        (kq, ks), (vq, vs) = _quantize_block(k), _quantize_block(v)
        return {"bf16": (k, v, {}), "int8": (kq, vq, dict(k_scale=ks, v_scale=vs))}

    def close(name, got, ref):
        e, m = err(got, ref)
        check(e <= 2e-2 * m, f"{name}: err {e} vs max {m}")

    # -- which kernel each dtype takes
    small = torch.randn((2, KVH, 256, D), generator=gen, device=dev)
    q32 = torch.randn((24, nH, D), generator=gen, device=dev)
    m24 = causal_mask_rows(100, 24, 256, device=dev)
    routes = {}
    for name, args in (("fp32 D=128", (q32, small, small)),
                       ("bf16 D=128", (q32.bfloat16(), small.bfloat16(), small.bfloat16())),
                       ("bf16 D=32", (q32[..., :32].bfloat16().contiguous(),
                                      small[..., :32].bfloat16().contiguous(),
                                      small[..., :32].bfloat16().contiguous()))):
        n0, s0 = ta.attend_flash.launches, ta.attend_flash.scalar_launches
        got = ta.attend_flash(*args, m24, 124, 1)
        close(f"route {name}", got, ta.attend_flash_ref(args[0], args[1][1], args[2][1], m24, 124))
        check(ta.attend_flash.launches == n0 + 1, f"route {name}: not counted")
        routes[name] = "scalar" if ta.attend_flash.scalar_launches == s0 + 1 else "tensor-core"
    check(routes == {"fp32 D=128": "scalar", "bf16 D=128": "tensor-core", "bf16 D=32": "scalar"},
          f"kernel routes {routes}")
    held["routes"] = routes
    del small

    # -- single slot: row invariance, soft cap, empty rows, limit isolation
    nn, S_big = 301, 512
    limit = nn + S_big
    band = causal_mask_rows(nn, S_big, L, device=dev)
    band[0::2, 128:] = False
    gm = growmap_from_spec(24, 6, acc=ACC_24x6)
    tree = tree_mask_rows(nn, torch.as_tensor(gm.bitmap, device=dev), L)
    T = gm.size
    q = randn(S_big, nH, D)
    for kind, (k, v, sc) in caches((2, KVH, L)).items():
        ref_sc = {n: t[1] for n, t in sc.items()}
        whole = ta.attend_flash(q, k, v, band, limit, 1, **sc)
        close(f"band mask {kind} S={S_big}", whole,
              ta.attend_flash_ref(q, k[1], v[1], band, limit, **ref_sc))
        for S in (1, 24, 127):
            got = ta.attend_flash(q[:S].contiguous(), k, v, band[:S].contiguous(), limit, 1,
                                  **sc)
            check(torch.equal(got, whole[:S]), f"attend_flash {kind}: rows of S={S} differ "
                  f"from S={S_big}'s (max {err(got, whole[:S])[0]})")
        qv = randn(T, nH, D, scale=8.0)  # scores reach +-40: the cap bites
        close(f"soft cap 30 {kind}",
              ta.attend_flash(qv, k, v, tree, nn + T, 1, soft_cap=30.0, **sc),
              ta.attend_flash_ref(qv, k[1], v[1], tree, nn + T, soft_cap=30.0, **ref_sc))
        dead = tree.clone()
        dead[[0, 3, T - 1]] = False
        got = ta.attend_flash(qv, k, v, dead, nn + T, 1, **sc)
        check(torch.count_nonzero(got[[0, 3, T - 1]]) == 0, f"empty rows {kind}: not 0")
        close(f"empty rows {kind}", got, ta.attend_flash_ref(qv, k[1], v[1], dead, nn + T,
                                                             **ref_sc))
        check(torch.count_nonzero(ta.attend_flash(qv, k, v, tree, 0, 1, **sc)) == 0,
              f"kv_limit 0 {kind}: not 0")
        base = ta.attend_flash(qv, k, v, tree, nn + T, 1, **sc)
        k2, v2 = k.clone(), v.clone()
        k2[1, :, nn + T:] = 127 if kind == "int8" else 1e6
        v2[1, :, nn + T:] = 127 if kind == "int8" else 1e6
        sc2 = {n: t.clone() for n, t in sc.items()}
        for t in sc2.values():
            t[1, :, nn + T:] = 1e6
        wide_mask = tree.clone()
        wide_mask[:, nn + T:] = True
        got = ta.attend_flash(qv, k2, v2, wide_mask, nn + T, 1, **sc2)
        check(torch.equal(got, base), f"limit isolation {kind}: output moved (max "
              f"{err(got, base)[0]})")
        # the same mask rows from an address 1 byte past a 16-byte boundary
        flat = torch.zeros(tree.numel() + 16, dtype=torch.bool, device=dev)
        shifted = flat[1:1 + tree.numel()].view(tree.shape)
        shifted.copy_(tree)
        got = ta.attend_flash(qv, k, v, shifted, nn + T, 1, **sc)
        check(torch.equal(got, base), f"misaligned mask {kind}: output moved")
        del k2, v2, sc2
    # an odd cache length: TMA zero-fills past L, and the mask and scale
    # windows start off the rows' 16-byte boundaries
    odd = causal_mask_rows(270, 24, 301, device=dev)
    q_odd = randn(24, nH, D)
    for kind, (k, v, sc) in caches((2, KVH, 301)).items():
        close(f"L=301 {kind}", ta.attend_flash(q_odd, k, v, odd, 294, 1, **sc),
              ta.attend_flash_ref(q_odd, k[1], v[1], odd, 294, **{n: t[1] for n, t in sc.items()}))
    held["single_slot"] = (f"bf16 and int8 KV: rows of S=1, 24, 127 equal S={S_big}'s bitwise "
                           f"(band mask, kv_limit {limit}); soft cap 30 within tolerance; rows "
                           f"with no live slot and kv_limit 0 exactly 0; 1e6 / 127 past the "
                           f"limit (mask set there), and a mask 1 byte off a 16-byte boundary, "
                           f"leave the output bit for bit; L=301 within tolerance")
    torch.cuda.empty_cache()

    # -- batched: a B=32 launch's slots vs each slot alone; prefill rows through slots
    B, g = 32, growmap_from_spec(2, 3)
    T = g.size
    limits = torch.randint(135, 301, (B,), generator=gen, device=dev, dtype=torch.int32)
    mask = tree_mask_rows_batched(limits - T, torch.as_tensor(g.bitmap, device=dev), L)
    q = randn(B, T, nH, D)
    qp = randn(1, S_big, nH, D)
    slot5 = torch.full((1,), 5, dtype=torch.int32, device=dev)
    lim5 = torch.full((1,), limit, dtype=torch.int32, device=dev)
    for kind, (k, v, sc) in caches((2, B, KVH, L)).items():
        whole = ta.attend_flash_batched(q, k, v, mask, limits, 1, **sc)
        close(f"batched {kind}", whole, ta.attend_flash_batched_ref(q, k, v, mask, limits, 1,
                                                                    **sc))
        for b in (0, 5, B - 1):
            one = torch.full((1,), b, dtype=torch.int32, device=dev)
            got = ta.attend_flash_batched(q[b:b + 1].contiguous(), k, v,
                                          mask[b:b + 1].contiguous(), limits[b:b + 1].contiguous(),
                                          1, slots=one, **sc)
            check(torch.equal(got, whole[b:b + 1]), f"batched {kind}: slot {b} alone differs "
                  f"from the B={B} launch (max {err(got, whole[b:b + 1])[0]})")
        pre = ta.attend_flash_batched(qp, k, v, band[None], lim5, 1, slots=slot5, **sc)
        for S in (1, 24, 127):
            got = ta.attend_flash_batched(qp[:, :S].contiguous(), k, v,
                                          band[None, :S].contiguous(), lim5, 1, slots=slot5,
                                          **sc)
            check(torch.equal(got, pre[:, :S]), f"batched {kind}: rows of S={S} differ from "
                  f"S={S_big}'s")
        b = 3
        lim_b = int(limits[b])
        k2, v2 = k.clone(), v.clone()
        k2[1, b, :, lim_b:] = 127 if kind == "int8" else 1e6
        v2[1, b, :, lim_b:] = 127 if kind == "int8" else 1e6
        sc2 = {n: t.clone() for n, t in sc.items()}
        for t in sc2.values():
            t[1, b, :, lim_b:] = 1e6
        wide_mask = mask.clone()
        wide_mask[b, :, lim_b:] = True
        got = ta.attend_flash_batched(q, k2, v2, wide_mask, limits, 1, **sc2)
        check(torch.equal(got, whole), f"batched limit isolation {kind}: output moved")
        del k2, v2, sc2
        zl = limits.clone()
        zl[[2, 7]] = 0
        got = ta.attend_flash_batched(q, k, v, mask, zl, 1, **sc)
        check(torch.count_nonzero(got[[2, 7]]) == 0, f"batched kv_limit 0 {kind}: not 0")
        close(f"batched kv_limit 0 {kind}", got,
              ta.attend_flash_batched_ref(q, k, v, mask, zl, 1, **sc))
        del k, v, sc
        torch.cuda.empty_cache()
    held["batched"] = (f"bf16 and int8 KV: slots 0, 5, {B - 1} of a B={B} decode launch equal "
                       f"each slot alone through slots, bitwise; prefill rows of S=1, 24, 127 "
                       f"equal S={S_big}'s through slots; limit isolation bit for bit; "
                       f"kv_limit 0 slots exactly 0")
    held["head_dims"] = attention_head_dim_checks(torch, dev, gen, randn, err, ta, caches, close)
    log(f"[kernels] attention tensor-core checks held: {json.dumps(held)}")
    return held


def attention_head_dim_checks(torch, dev, gen, randn, err, ta, caches, close):
    """The tensor-core kernel's other head dims, bf16 and int8 KV: D = 64 at
    Llama-3.2-1B's 32/8 heads and D = 256 at Gemma-2-9B's 16/8 (one consumer
    warpgroup, no combine, its own ring depth). Each takes the tensor-core
    kernel; single slot at the verify shape (with and without soft cap 30)
    and a 512-row band mask within tolerance of the plain version, rows of
    S = 1, 24, 127 equal to S = 512's bitwise; batched B = 8 decode within
    tolerance, and slots 0 and 7 alone equal to the launch's rows bitwise.
    `caches(shape, D)` and `close` are attention_tc_checks'."""
    from umbrella_tpu_torch.ops.masks import causal_mask_rows, tree_mask_rows, \
        tree_mask_rows_batched
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    KVH, L, nn, S_big = 8, MAX_LEN, 301, 512
    limit = nn + S_big
    band = causal_mask_rows(nn, S_big, L, device=dev)
    band[0::2, 128:] = False
    gm = growmap_from_spec(24, 6, acc=ACC_24x6)
    tree = tree_mask_rows(nn, torch.as_tensor(gm.bitmap, device=dev), L)
    T = gm.size
    B, g = 8, growmap_from_spec(3, 4)
    limits = torch.randint(135, 301, (B,), generator=gen, device=dev, dtype=torch.int32)
    bmask = tree_mask_rows_batched(limits - g.size, torch.as_tensor(g.bitmap, device=dev), L)
    held = {}
    for D, nH in ((64, 32), (256, 16)):
        q = randn(S_big, nH, D)
        qv = randn(T, nH, D, scale=8.0)  # scores reach +-40: the cap bites
        qb = randn(B, g.size, nH, D)
        for kind, (k, v, sc) in caches((2, KVH, L), D).items():
            ref_sc = {n: t[1] for n, t in sc.items()}
            s0 = ta.attend_flash.scalar_launches + ta.attend_flash_int8.scalar_launches
            whole = ta.attend_flash(q, k, v, band, limit, 1, **sc)
            check(ta.attend_flash.scalar_launches + ta.attend_flash_int8.scalar_launches == s0,
                  f"D={D} {kind}: bf16 q took the scalar kernel")
            close(f"D={D} band mask {kind}", whole,
                  ta.attend_flash_ref(q, k[1], v[1], band, limit, **ref_sc))
            for S in (1, 24, 127):
                got = ta.attend_flash(q[:S].contiguous(), k, v, band[:S].contiguous(), limit, 1,
                                      **sc)
                check(torch.equal(got, whole[:S]), f"D={D} {kind}: rows of S={S} differ from "
                      f"S={S_big}'s (max {err(got, whole[:S])[0]})")
            for cap in (0.0, 30.0):
                close(f"D={D} verify {kind} soft cap {cap}",
                      ta.attend_flash(qv, k, v, tree, nn + T, 1, soft_cap=cap, **sc),
                      ta.attend_flash_ref(qv, k[1], v[1], tree, nn + T, soft_cap=cap, **ref_sc))
            del k, v, sc
            kb, vb, scb = caches((2, B, KVH, L), D)[kind]
            full = ta.attend_flash_batched(qb, kb, vb, bmask, limits, 1, **scb)
            close(f"D={D} batched {kind}", full,
                  ta.attend_flash_batched_ref(qb, kb, vb, bmask, limits, 1, **scb))
            for b in (0, B - 1):
                one = torch.full((1,), b, dtype=torch.int32, device=dev)
                got = ta.attend_flash_batched(qb[b:b + 1].contiguous(), kb, vb,
                                              bmask[b:b + 1].contiguous(),
                                              limits[b:b + 1].contiguous(), 1, slots=one, **scb)
                check(torch.equal(got, full[b:b + 1]), f"D={D} batched {kind}: slot {b} alone "
                      f"differs from the B={B} launch")
            del kb, vb, scb
            torch.cuda.empty_cache()
        held[f"D={D}"] = (f"{nH}/{KVH} heads, bf16 and int8 KV: tensor-core kernel; band mask "
                          f"S={S_big} and verify (soft cap 0 and 30) within tolerance, rows of "
                          f"S=1, 24, 127 equal S={S_big}'s bitwise; B={B} decode within "
                          f"tolerance, slots 0 and {B - 1} alone equal the launch's rows bitwise")
    return held


# ---------------------------------------------------------------- phases 3-4


def build_target(torch, dev, n_layers, exit_layer, dtype, awq_act="bf16"):
    """bench.py's primary target: random W4 weights, tail wo/down scales damped
    x0.05, shared prefix (exit_layer layers + lm_head) converted to Int4F;
    awq_act="int8" runs the W4 layers through W4A8."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import (ModelRuntime, early_exit_runtime,
                                                      random_awq_runtime)
    from umbrella_tpu_torch.quantization.int4f import hybridize_shared_prefix

    cfg = ModelConfig(**dict(CFG_8B, num_hidden_layers=n_layers, awq_act=awq_act))
    t = random_awq_runtime(cfg, MAX_LEN, dtype=dtype, seed=2, quantize_lm_head=True,
                           device=dev)
    params = hybridize_shared_prefix(
        dict(t.params, layers=damp_tail(t.params["layers"], exit_layer)), exit_layer, refine=0)
    target = ModelRuntime(cfg, params, MAX_LEN, dtype=dtype, device=dev)
    return target, early_exit_runtime(target, exit_layer=exit_layer)


def make_engine(torch, dev, target, draft, dtype, kv_dtype=None, tree=None, **kw):
    """The single-slot static engine (Sequoia 24x6 tree unless `tree` is a
    growmap_from_spec spec)."""
    from umbrella_tpu_torch.sequoia import growmap_from_spec
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    gm = growmap_from_spec(24, 6, acc=ACC_24x6) if tree is None else growmap_from_spec(*tree)
    eng = AutoEngine.from_config(
        device=dev, engine="static", model=target, draft_model=draft, growmap=gm,
        max_length=MAX_LEN, temperature=0.0, eos_token_ids=kw.pop("eos_token_ids", [-100]),
        dtype=dtype, kv_dtype=kv_dtype, **kw)
    eng.initialize()
    return eng


def greedy_ar_decode(torch, runtime, prompt, n_new, kv_dtype=None, keep_kv=False):
    """Plain autoregressive greedy decode with the port's own forward (on an
    int8 KV cache for kv_dtype="int8"). Returns (tokens, gaps, runner_ups,
    scales): at step i, the top-1 minus top-2 logit, the top-2 token and the
    row's max |logit|; and the KV cache after the decode, where keep_kv."""
    from umbrella_tpu_torch.ops.masks import causal_mask_rows

    dev = runtime.device
    kv = runtime.init_kv(kv_dtype=kv_dtype)
    S = len(prompt)
    logits, kv = runtime.forward(runtime.params, kv, torch.tensor(prompt, device=dev),
                                 torch.arange(S, device=dev),
                                 causal_mask_rows(0, S, MAX_LEN, device=dev), 0)
    row = logits[-1]
    out, gaps, runner_ups, scales = [], [], [], []
    for t in range(S, S + n_new):
        top = torch.topk(row, 2)
        out.append(int(top.indices[0]))
        gaps.append(float(top.values[0] - top.values[1]))
        runner_ups.append(int(top.indices[1]))
        scales.append(float(row.abs().max()))
        if len(out) == n_new:
            break
        lg, kv = runtime.forward(runtime.params, kv, torch.tensor([out[-1]], device=dev),
                                 torch.tensor([t], device=dev),
                                 causal_mask_rows(t, 1, MAX_LEN, device=dev), t)
        row = lg[0]
    return (out, gaps, runner_ups, scales) + ((kv,) if keep_kv else ())


def first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def lossless_check(torch, dev, prompt, kv_dtype=None, awq_act="bf16"):
    """Static-tree generate() against the port's own AR decode (both on an int8
    KV cache when kv_dtype="int8"). The first LOSSLESS_NEW_TOKENS tokens must
    be identical; where the two decodes part later (generate() may overshoot by
    up to a tree path), the AR top-1/top-2 logit gap at that step is reported.
    Exact equality needs every op but attention to compute a row the same way
    whatever rows share the call (see ops/norms.py); int8 KV rounding and the
    W4A8 layers' int8 activations would turn any last-bit difference into a
    quantum. awq_act="int8": the W4 layers past the Int4F prefix run W4A8."""
    from umbrella_tpu_torch.ops.kernels import launch_counts

    tag = ("[lossless-w4a8]" if awq_act == "int8" else
           "[lossless]" if kv_dtype is None else f"[lossless-{kv_dtype}]")
    target, draft = build_target(torch, dev, n_layers=4, exit_layer=2, dtype=torch.float32,
                                 awq_act=awq_act)
    eng = make_engine(torch, dev, target, draft, torch.float32, kv_dtype=kv_dtype)
    start = {}

    def request():  # the counts before each profiled window (the last one counts)
        start.update(launch_counts())
        return eng.generate(input_ids=prompt, max_new_tokens=LOSSLESS_NEW_TOKENS)

    trace, out = profile_window(  # the kernels' launches traced and held against the counts
        torch, f"{tag[:-1]}-trace]", request, request_steps)
    counts = {k: n - start[k] for k, n in launch_counts().items()}
    check(trace is not None, f"{tag} the kernels' launches were not traced")
    graphs = check_graphed(eng, tag)
    toks = out["generated_tokens"]
    ar, gaps, _, _ = greedy_ar_decode(torch, target, prompt, len(toks), kv_dtype=kv_dtype)
    same = first_difference(toks, ar)
    steps = request_steps(out)
    res = dict(tokens=len(toks), identical_prefix=same, avg_accept_tokens=out["avg_accept_tokens"],
               min_ar_gap=min(gaps),
               gap_at_first_difference=gaps[same] if same < len(toks) else None,
               launches=counts, launches_per_step={k: n / steps for k, n in counts.items()},
               launches_traced=trace["launches_traced"], graphs=graphs)
    log(f"{tag} {json.dumps(res)}")
    check(len(toks) >= LOSSLESS_NEW_TOKENS, f"{tag} too few tokens")
    check(same >= LOSSLESS_NEW_TOKENS,
          f"{tag} spec and AR decode differ at token {same}: {toks} vs {ar}")
    attn = "attend_flash_int8" if kv_dtype == "int8" else "attend_flash"
    w4 = "w4a8_matmul" if awq_act == "int8" else "w4a16_matmul"
    for name in (attn, w4, "w4a8f_matmul", "w4a8_quantize", "embed_gather"):
        check(counts[name] > 0, f"{tag} kernel {name} was never launched")
    check(counts["attend_flash_scalar"] == counts[attn], f"{tag}: fp32 q must take the scalar "
          f"attention kernel ({counts['attend_flash_scalar']} of {counts[attn]})")
    return res


def stage_devices(torch, dev):
    """PP_STAGES stage devices: cuda:0..3 on a host with that many cards, else
    every stage on `dev` (shard_runtime_pp takes a device more than once)."""
    if torch.cuda.device_count() >= PP_STAGES:
        return [torch.device("cuda", i) for i in range(PP_STAGES)]
    return [dev] * PP_STAGES


def damp_tail(layers, first):
    """bench.py's damped tail: wo and down scales x0.05 from layer `first` on
    (new per-layer tuples; the packed bytes are shared)."""
    layers = dict(layers)
    for k in ("wo", "down"):
        layers[k] = tuple(q._replace(scales=q.scales * 0.05) if i >= first else q
                          for i, q in enumerate(layers[k]))
    return layers


# where the int8 KV cache lets a spec decode part from the AR decode, the AR
# step must be a near tie: top-1 minus top-2 at most NEAR_TIE x max|logit|
# (about 3x the one parting seen on an H100, a gap of 0.0027 at max|logit|
# 8.05), and the spec decode must have taken the AR's top-2 token
NEAR_TIE = 2 ** -10


def keep_target_kv(eng):
    """A dict that holds a copy of the engine's target KV cache as each
    generate() leaves it (generate() ends with reset(), which zeroes the
    cache in place)."""
    kept, reset = {}, eng.reset

    from umbrella_tpu_torch.models.kv_cache import KVCache, kv_parts

    def copy(kv):
        if not isinstance(kv, KVCache):  # a staged or sharded model's caches
            return type(kv)(tuple(copy(s) for s in kv_parts(kv)))
        return type(kv)(*(None if t is None else t.clone() for t in kv))

    def keep_then_reset():
        kept["kv"] = copy(eng.kv_target)
        reset()

    eng.reset = keep_then_reset
    return kept


def kv_rows(torch, kv, n):
    """(k, v, k_scale, v_scale) at slots [0, n) of every layer of a KV cache
    (a staged cache's stages concatenated over layers, a sharded cache's
    shards over kv heads, on the first one's device); the scales are None
    unless the cache is int8."""
    from umbrella_tpu_torch.models.kv_cache import ShardedKVCache, kv_parts

    parts = kv_parts(kv)
    axis = 1 if isinstance(kv, ShardedKVCache) else 0
    d0 = parts[0].k.device
    return tuple(None if parts[0][f] is None else
                 torch.cat([s[f][:, :, :n].to(d0) for s in parts], dim=axis) for f in range(4))


def kv_witness(torch, spec, ar, ref=None):
    """How far the spec decode's KV rows lie from the AR decode's (same tokens
    at these slots), layer by layer: the largest difference in int8 codes, or
    relative to the layer's max |row| for a float cache, and whether layer 0
    is bit for bit the same (its rows pass no attention). With `ref` (an fp32
    cache's rows at the same slots), the largest distance of either int8
    cache's dequantized rows from it, in quanta of the row's own scale."""
    out = dict(layer0_equal=all(torch.equal(a[0], b[0]) for a, b in zip(spec, ar)
                                if a is not None))
    if spec[2] is None:
        out["rel_diff"] = [max(float((a[li].float() - b[li].float()).abs().max()
                                     / b[li].float().abs().max()) for a, b in zip(spec[:2], ar[:2]))
                           for li in range(spec[0].shape[0])]
        return out
    out["code_diff"] = [max(int((a[li].int() - b[li].int()).abs().max())
                            for a, b in zip(spec[:2], ar[:2])) for li in range(spec[0].shape[0])]
    out["codes_differing"] = sum(int((a.int() != b.int()).sum()) for a, b in zip(spec[:2], ar[:2]))
    out["codes"] = 2 * spec[0].numel()
    if ref is not None:
        m = ref[0].shape[2]
        out["fp32_slots"] = m
        for tag, rows in (("spec", spec), ("ar", ar)):
            out[f"{tag}_quanta_from_fp32"] = [
                max(float(((c[li, :, :m].float() * s[li, :, :m, None] - r[li]).abs()
                           / s[li, :, :m, None]).max())
                    for c, s, r in ((rows[0], rows[2], ref[0]), (rows[1], rows[3], ref[1])))
                for li in range(spec[0].shape[0])]
    return out


def pp_lossless_check(torch, dev, prompt):
    """Full Llama-3.3-70B width, 8 random AWQ layers (damped tail), W4 head,
    and its early-exit draft of 2 layers. The target is staged by
    shard_runtime_pp over PP_STAGES stages (2 layers each, so the layered index
    takes both values) and run through pipeline_parallel, on the
    device-resident loop (its step captured as CUDA graphs: one on one card,
    one a run of phases on one card across cards). Three cases: fp32
    activations with an fp32 KV cache, fp32 with int8 KV, and bf16 activations
    and KV (the pp4 config's dtype). In each, the staged engine's greedy
    generate() of LOSSLESS_NEW_TOKENS tokens must equal the unstaged engine's
    (the same kernels on the same rows). Against the port's AR decode: fp32
    and bf16 must be identical for LOSSLESS_NEW_TOKENS tokens; int8 KV too,
    or part from it only at a near tie (NEAR_TIE) where the spec decode took
    the AR's top-2. The witness for that rounding: the KV rows both decodes
    wrote over the tokens they share. Layer 0's rows, which no attention
    precedes, must be bit for bit the same (the ops outside attention compute
    a row alike in a verify pass and an AR step); from layer 1 on the rows
    differ by rounding (a verify row reads its ancestors at tree slots, the
    AR row the same keys at contiguous slots, so the attention kernel's block
    sums round differently, and the W4A16 kernel's bf16 rounding of its input
    widens that to bf16 steps), which an int8 row turns into whole quanta:
    fewer, layer by layer, than int8 rounding moves a row from the fp32
    cache's."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import (ModelRuntime, early_exit_runtime,
                                                      random_awq_runtime)
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.parallel.pipeline import shard_runtime_pp

    cfg = ModelConfig(**dict(CFG_70B, num_hidden_layers=8, max_position_embeddings=MAX_LEN))
    P = len(prompt)
    res, fp32_ref = {}, None
    for case, dtype, kv_dtype in (("fp32", torch.float32, None),
                                  ("int8", torch.float32, "int8"),
                                  ("bf16", torch.bfloat16, None)):
        if case != "int8":  # int8 KV reuses the fp32 models
            target = draft = staged = None
            torch.cuda.empty_cache()
            params = random_awq_runtime(cfg, MAX_LEN, dtype=dtype, seed=3,
                                        quantize_lm_head=True, device=dev).params
            params = dict(params, layers=damp_tail(params["layers"], 2))
            target = ModelRuntime(cfg, params, MAX_LEN, dtype=dtype, device=dev)
            draft = early_exit_runtime(target, 2)
            staged = shard_runtime_pp(ModelRuntime(cfg, dict(params), MAX_LEN, dtype=dtype,
                                                   device=dev), stage_devices(torch, dev))
            del params
        eng = make_engine(torch, dev, staged, draft, dtype, kv_dtype=kv_dtype,
                          pipeline_parallel=PP_STAGES)
        kept = keep_target_kv(eng)
        reset_launch_counts()
        out = eng.generate(input_ids=prompt, max_new_tokens=LOSSLESS_NEW_TOKENS)
        counts = launch_counts()
        check(eng._can_decode_fused(), "[pp-lossless]: the staged engine does not take the "
              "device-resident loop")
        graphs = check_graphed(eng, f"[pp-lossless] {case}")
        del eng
        toks = out["generated_tokens"]
        unstaged = make_engine(torch, dev, target, draft, dtype, kv_dtype=kv_dtype).generate(
            input_ids=prompt, max_new_tokens=LOSSLESS_NEW_TOKENS)["generated_tokens"]
        ar, gaps, runner_ups, scales, ar_kv = greedy_ar_decode(
            torch, target, prompt, len(toks), kv_dtype=kv_dtype, keep_kv=True)
        same, same_ar = first_difference(toks, unstaged), first_difference(toks, ar)
        parted = same_ar < min(len(toks), LOSSLESS_NEW_TOKENS)
        # slots whose token both decodes share (and both wrote the KV of)
        n = P + min(same_ar, len(ar) - 1, len(toks) - 1)
        spec_rows, ar_rows = kv_rows(torch, kept["kv"], n), kv_rows(torch, ar_kv, n)
        del kept, ar_kv
        ref = None
        if case == "int8":  # the fp32-KV decode of the same models, where its tokens agree
            m = min(n, P + first_difference(toks, fp32_ref[0]))
            ref = tuple(t[:, :, :m] for t in fp32_ref[1][:2])
        witness = kv_witness(torch, spec_rows, ar_rows, ref)
        if case == "fp32":
            fp32_ref = (ar, ar_rows)
        del spec_rows, ar_rows, ref
        r = dict(case=case, tokens=len(toks), identical_to_unstaged=same,
                 identical_to_ar=same_ar, avg_accept_tokens=out["avg_accept_tokens"],
                 min_ar_gap=min(gaps), stages=[str(d) for d in staged.stage_devices],
                 kv_slots_compared=n, kv_witness=witness, launches=counts, graphs=graphs)
        if parted:
            r["ar_at_first_difference"] = dict(
                gap=gaps[same_ar], max_abs_logit=scales[same_ar], spec_token=toks[same_ar],
                ar_top1=ar[same_ar], ar_top2=runner_ups[same_ar])
        log(f"[pp-lossless] {json.dumps(r)}")
        tag = f"[pp-lossless] {case}"
        check(len(toks) >= LOSSLESS_NEW_TOKENS, f"{tag}: too few tokens")
        check(same >= LOSSLESS_NEW_TOKENS, f"{tag}: staged {toks} vs unstaged {unstaged}")
        check(witness["layer0_equal"], f"{tag}: layer 0's KV rows differ between the spec and "
              "the AR decode (an op outside attention computes a row differently by batch)")
        if case == "int8":
            check(all(d < q for d, q in zip(witness["code_diff"][1:],
                                            witness["spec_quanta_from_fp32"][1:])),
                  f"{tag}: spec and AR KV rows differ by as much as int8 rows differ from fp32 "
                  f"rows: {witness}")
        near_tie = parted and case == "int8" and toks[same_ar] == runner_ups[same_ar] \
            and gaps[same_ar] <= NEAR_TIE * scales[same_ar]
        check(not parted or near_tie, f"{tag}: staged {toks} vs AR {ar}")
        attn = "attend_flash_int8" if kv_dtype == "int8" else "attend_flash"
        for name in (attn, "w4a16_matmul", "w4a16_matmul_layered", "embed_gather"):
            check(counts[name] > 0, f"{tag}: kernel {name} was never launched")
        res[case] = r
    return res


def build_70b(torch, dev, devices, max_length):
    """A random AWQ Llama-3.3-70B at full widths and PP_CONFIG_LAYERS of its 80
    layers (g128, bf16 scales, bf16 embedding and untied head, tail wo/down
    scales x0.05 from layer 3 on), built on `dev` and staged by
    shard_runtime_pp over `devices`. No reference to the per-layer tensors
    outlives this function's locals, so staging frees them as it stacks."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import ModelRuntime, random_awq_runtime
    from umbrella_tpu_torch.parallel.pipeline import shard_runtime_pp

    cfg = ModelConfig(**dict(CFG_70B, num_hidden_layers=PP_CONFIG_LAYERS))
    params = random_awq_runtime(cfg, max_length, dtype=torch.bfloat16, seed=4,
                                device=dev).params
    rt = ModelRuntime(cfg, dict(params, layers=damp_tail(params["layers"], 3)), max_length,
                      dtype=torch.bfloat16, device=dev)
    del params
    return shard_runtime_pp(rt, devices)


def main_path(torch, dev, prompt, target, draft):
    """The 8B static main path through generate(): graphed (the device-resident
    loop, its step replayed as a CUDA graph) and stepwise (build_tree();
    verify(), one host read a step) side by side on one engine: tok/s, step
    ms and TTFT each, a profiled 64-token request each, the same tokens. The
    kernels' launches are read from the graphed run; in each profiled request
    the kernels the profiler traced must be the wrappers' counts, and the
    graphed request's launches a step, as traced ((traced - prefill) /
    replays), must equal the stepwise loop's as counted and the captured
    step's."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    eng = make_engine(torch, dev, target, draft, torch.bfloat16)
    eng.generate(input_ids=prompt, max_new_tokens=16)  # warm-up: captures the greedy step
    graph = eng._decode_graphs[(True, eng.topk, False)]
    res = {}
    for mode in ("graphed", "stepwise"):
        (graphed if mode == "graphed" else stepwise)(eng)
        reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        assert eng._prefill(prompt)
        torch.cuda.synchronize()
        ttft_ms = 1000 * (time.time() - t1)
        prefill_counts = launch_counts()
        eng.reset()
        reset_launch_counts()
        before = graph_stats(eng)
        out = eng.generate(input_ids=prompt, max_new_tokens=MAIN_NEW_TOKENS)
        counts = launch_counts()
        after = graph_stats(eng)
        toks = out["generated_tokens"]
        steps = round(len(toks) / out["avg_accept_tokens"])
        r = dict(tokens=len(toks), steps=steps, tok_per_s=1000.0 / out["time_per_output_token"],
                 decode_step_ms=out["time_per_output_token"] * len(toks) / steps,
                 avg_accept_tokens=out["avg_accept_tokens"], ttft_ms_prefill128=ttft_ms,
                 replays=after["replays"] - before["replays"],
                 noop_replays=after["noop_replays"] - before["noop_replays"],
                 host_reads=after["blocks"] - before["blocks"] + 1 if mode == "graphed"
                 else steps, launches=counts,
                 prefill_launches=prefill_counts,
                 launches_per_step={k: (counts[k] - prefill_counts[k]) / steps for k in counts})

        def request():  # the replays before each profiled window (the last one counts)
            nonlocal before
            before = graph_stats(eng)
            return eng.generate(input_ids=prompt, max_new_tokens=64)

        r["profile"], _ = profile_window(torch, f"[profile] {mode}", request, request_steps)
        after = graph_stats(eng)
        check(r["profile"] is not None, f"[profile] {mode}: the kernels' launches were not "
              "traced (the profiler saw no device time)")
        r["profile"].update(replays=after["replays"] - before["replays"],
                            noop_replays=after["noop_replays"] - before["noop_replays"],
                            capture_ms=graph.capture_ms, graph_pool_gb=after["pool_gb"])
        res[mode] = r
        res.setdefault("tokens", toks)
    graphed(eng)
    g, sw = res["graphed"], res["stepwise"]
    check(g["replays"] >= g["steps"] > 0 and sw["replays"] == 0,
          f"main path: graphed {g['replays']} replays, stepwise {sw['replays']}")
    traced, replays = g["profile"]["launches_traced"], g["profile"]["replays"]
    check(replays > 0, "[profile] graphed: no replay")
    g["launches_traced"] = {k: traced[k] for k in MAIN_KERNELS}
    g["launches_per_step"] = {k: (traced[k] - g["prefill_launches"][k]) / replays
                              for k in MAIN_KERNELS}
    check(all(g["launches_per_step"][k] == sw["launches_per_step"][k] == graph.launches[k]
              for k in MAIN_KERNELS),
          f"main path: launches a step traced in the graphed request {g['launches_per_step']}, "
          f"counted in the stepwise one {sw['launches_per_step']}, captured {graph.launches}")
    check(sw["tokens"] == g["tokens"], "main path: stepwise and graphed decodes differ")
    toks = res.pop("tokens")
    for name in MAIN_KERNELS:
        check(g["launches"][name] > 0, f"main path: kernel {name} was never launched")
    check_tc_route(g["launches"], "main path")
    ar, gaps, _, _ = greedy_ar_decode(torch, target, prompt, len(toks))
    prefix = first_difference(toks, ar)
    res.update(g)  # the graphed run is the main path's result
    res.update(spec_vs_ar_common_prefix=prefix,
               ar_gap_at_first_difference=gaps[prefix] if prefix < len(toks) else None,
               graph=graph_stats(eng), peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"[main] {json.dumps(res)}")
    check(all(0 <= t < CFG_8B["vocab_size"] for t in toks), "main path: token out of range")
    del eng
    return res


GRAPH_NEW_TOKENS = 64


def graph_phase(torch, dev, prompt, target, draft):
    """The decode loops as CUDA graphs against their stepwise forms, on one
    engine each: the static engine on the fp32 lossless model (4 layers) and
    on the bf16 8B main path (generate(), GRAPH_NEW_TOKENS tokens), the
    batched engine at B=32 with int8 KV (32 requests through run()); the
    tokens must be equal, also in a request that follows one stopped by an
    EOS inside a block. Each graphed run must have captured and replayed a
    graph (a silent stepwise run fails), with every replay inside
    cuda_graphs.no_host_sync on its thread and the process-wide sync debug
    mode at its default (0, so that other threads' host reads go through);
    two replays of a stochastic step draw different numbers (the second
    one's again after a rewind), and the stochastic static decode equals
    the stepwise one for one seed; a
    step that reads the host during its capture must raise, not fall back to
    stepwise."""
    from umbrella_tpu_torch.cuda_graphs import host_reads_checked

    modes = []
    real_replay = torch.cuda.CUDAGraph.replay

    def replay(graph):  # record the checks every replay runs under
        modes.append((host_reads_checked() > 0, torch.cuda.get_sync_debug_mode()))
        return real_replay(graph)

    res = {}
    small, small_draft = build_target(torch, dev, n_layers=4, exit_layer=2, dtype=torch.float32)
    torch.cuda.CUDAGraph.replay = replay
    try:
        res["generator"] = replays_draw_anew(torch, dev)
        for name, (t, d, dtype, sampling) in {
                "static-fp32": (small, small_draft, torch.float32, {}),
                "static-bf16-8b": (target, draft, torch.bfloat16, {}),
                "static-bf16-8b-stochastic": (target, draft, torch.bfloat16,
                                              dict(temperature=0.6, topp=0.9))}.items():
            outs = []
            for mode in ("graphed", "stepwise"):
                eng = make_engine(torch, dev, t, d, dtype, seed=11)
                if mode == "stepwise":
                    stepwise(eng)
                outs.append(eng.generate(input_ids=prompt, max_new_tokens=GRAPH_NEW_TOKENS,
                                         **sampling)["generated_tokens"])
                if mode == "graphed":
                    stats = check_graphed(eng, f"[graph] {name}")
                del eng
            res[name] = dict(tokens=len(outs[0]), equal=outs[0] == outs[1], graphs=stats)
            check(outs[0] == outs[1], f"[graph] {name}: graphed {outs[0]} vs stepwise {outs[1]}")
        res["eos-inside-a-block"] = eos_inside_a_block(torch, dev, prompt, small, small_draft)
        reqs = random_requests(13, 32, 32)
        outs = []
        for mode in ("graphed", "stepwise"):
            eng = batched_engine(torch, dev, target, draft, 32, (2, 3), "int8", torch.bfloat16)
            if mode == "stepwise":
                stepwise(eng)
            outs.append([o["generated_tokens"] for o in eng.run(reqs)])
            if mode == "graphed":
                res["batched-int8-b32"] = dict(graphs=check_graphed(eng, "[graph] batched"))
            del eng
        same = sum(a == b for a, b in zip(*outs))
        res["batched-int8-b32"].update(requests=len(reqs), equal=same)
        check(same == len(reqs), f"[graph] batched: {same} of {len(reqs)} requests equal")
    finally:
        torch.cuda.CUDAGraph.replay = real_replay
    res["replay_checks"] = [dict(no_host_sync=a, sync_debug_mode=b)
                            for a, b in sorted(set(modes))]
    check(modes and set(modes) == {(True, 0)},
          f"[graph] replays ran under (no_host_sync, sync debug mode) {set(modes)}")
    check(res["generator"]["differ"] and res["generator"]["equal_to_eager"]
          and res["generator"]["rewound"],
          f"[graph] replays of a registered generator's draw: {res['generator']}")
    # a host read inside the step fails the capture; nothing runs stepwise instead
    eng = make_engine(torch, dev, small, small_draft, torch.float32)
    build = eng._build

    def build_with_a_host_read(nn, cont=None):
        nn.item()
        return build(nn, cont)

    eng._build = build_with_a_host_read
    try:
        eng.generate(input_ids=prompt, max_new_tokens=8)
        raised = None
    except RuntimeError as e:
        raised = str(e).splitlines()[0][:200]
    res["capture_failure"] = raised
    check(raised is not None and graph_stats(eng)["replays"] == 0,
          "[graph] a step that reads the host was captured or ran stepwise")
    log(f"[graph] {json.dumps(res)}")
    return res


def eos_inside_a_block(torch, dev, prompt, target, draft):
    """Two requests on one engine, the first stopped by an EOS token a few
    steps into a block of replays, so that the block ends in no-op replays
    (they write no committed KV, and their random draws are taken back):
    graphed equal to stepwise in both requests, greedy and stochastic (one
    seed)."""
    res = {}
    for name, sampling in (("greedy", {}), ("stochastic", dict(temperature=0.6, topp=0.9))):
        free = make_engine(torch, dev, target, draft, torch.float32, seed=11).generate(
            input_ids=prompt, max_new_tokens=GRAPH_NEW_TOKENS, **sampling)["generated_tokens"]
        # the latest token new at its index in the first half of the decode
        eos = free[max(i for i in range(1, len(free) // 2 + 1) if free[i] not in free[:i])]
        outs = []
        for mode in ("graphed", "stepwise"):
            eng = make_engine(torch, dev, target, draft, torch.float32, seed=11,
                              eos_token_ids=[eos])
            if mode == "stepwise":
                stepwise(eng)
            outs.append([eng.generate(input_ids=prompt, max_new_tokens=GRAPH_NEW_TOKENS,
                                      **sampling)["generated_tokens"] for _ in range(2)])
            if mode == "graphed":
                noop = eng.decode_stats["noop_replays"]
            del eng
        check(outs[0][0][-1] == eos and noop > 0,
              f"[graph] eos-inside-a-block {name}: the first request did not stop at the EOS "
              f"inside a block ({len(outs[0][0])} tokens, {noop} no-op replays)")
        check(outs[0] == outs[1], f"[graph] eos-inside-a-block {name}: graphed {outs[0]} vs "
              f"stepwise {outs[1]}")
        res[name] = dict(eos_at=len(outs[0][0]) - 1, noop_replays=noop,
                         tokens=[len(o) for o in outs[0]], equal=True)
    return res


def replays_draw_anew(torch, dev):
    """A step that draws from a torch.Generator, captured as the engines
    capture theirs (the generator registered, its state restored after the
    warm-up): two replays draw different numbers, the same numbers as two
    eager calls from the same state, and a replay after rewind(1) draws the
    second replay's numbers again."""
    from umbrella_tpu_torch.cuda_graphs import Phase, StepGraph

    gen = torch.Generator(device=dev).manual_seed(5)
    out = torch.zeros(8, device=dev)

    def step():
        out.copy_(torch.rand(8, generator=gen, device=dev))

    state, eager, got = gen.get_state(), [], []
    for _ in range(2):
        step()
        eager.append(out.clone())
    gen.set_state(state)
    graph = StepGraph.capture([Phase("draw", dev, step)], {}, generators=(gen,))
    for _ in range(2):
        graph.replay(1)
        got.append(out.clone())
    graph.rewind(1)
    graph.replay(1)
    return dict(differ=not torch.equal(got[0], got[1]),
                equal_to_eager=all(torch.equal(a, b) for a, b in zip(got, eager)),
                rewound=torch.equal(out, got[1]))


def request_steps(out):
    """The target steps of a generate() result."""
    return max(1, round(len(out["generated_tokens"]) / out["avg_accept_tokens"]))


# the port's __global__ kernels as the profiler names them, each with the
# counters of every wrapper that launches it: a counted launch is one launch
# of that kernel (split-K sums and the empty kernel are not counted)
TRACED_KERNELS = (
    (("gather_rows",), ("embed_gather",)),
    (("flash_tc_kernel", "flash_attend_kernel"),
     ("attend_flash", "attend_flash_int8", "attend_flash_batched", "attend_flash_batched_int8")),
    (("flash_attend_kernel",), ("attend_flash_scalar",)),
    (("w4a16_kernel",), ("w4a16_matmul", "w4a16_matmul_layered", "w4a16_gate_up_silu")),
    (("w4a8_kernel",), ("w4a8f_matmul", "w4a8_matmul")),
    (("quantize_rows",), ("w4a8_quantize",)),
)


def traced_launches(tag, kernel_counts, counted):
    """Hold the launches of each kernel in the trace (kernel_counts: the
    profiler's kernel names and counts) against the wrappers' counts over the
    same window; return each wrapper's launches as traced, where it was the
    only wrapper of its kernel that the window ran."""
    traced, wrong = trace_against_counts(kernel_counts, counted)
    if wrong:
        log(f"{tag} kernels traced: {json.dumps({k[:100]: c for k, c in kernel_counts.items()})}")
    check(not wrong, f"{tag}: the profiler's trace and the wrappers' counts differ: {wrong}")
    return traced


def trace_against_counts(kernel_counts, counted):
    """(each wrapper's launches as traced, the kernels whose traced launches
    differ from the wrappers' counts)."""
    traced, wrong = {}, []
    for patterns, names in TRACED_KERNELS:
        n = sum(c for k, c in kernel_counts.items() if any(p in k for p in patterns))
        want = sum(counted[name] for name in names)
        if n != want:
            wrong.append(f"{patterns[0]}: traced {n}, counted {want} "
                         f"({ {k: counted[k] for k in names} })")
        for name in names:
            if counted[name] == want:
                traced[name] = n
    return traced, wrong


# the profiler loses a prefix of a window's device records (on the card, from
# one to ~1,600 kernels, and in two whole-script runs the prefill's kernels
# after 10,000 empty launches made back to back): a window opens with
# PAD_ROUNDS rounds of PAD_LAUNCHES launches of the empty kernel, each round
# synchronized and followed by PAD_WAIT_S of host time, which every count and
# time below leaves out; `pad_traced` says how many of them the trace kept
PAD_ROUNDS, PAD_LAUNCHES, PAD_WAIT_S = 10, 1000, 0.03
PROFILE_ATTEMPTS = 3  # windows run where the profiler dropped records (profile_window)
PAD_KERNEL = "empty_rows"


# names torch's profiler drops from its events (torch.autograd.profiler_util._filter_name)
TRACE_DROPPED = {"[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                 "profiler::_record_function_enter_new", "profiler::_record_function_exit",
                 "aten::is_leaf", "aten::output_nr", "aten::_version"}
_trace_checked = []


def read_trace(prof, torch):
    """A profiler window's records, read from its kineto result directly:
    {"device": [(kernel or copy name, start us, end us, async)], "host_ops":
    PyTorch ops called from Python (aten:: ops inside no other op on their
    thread), "pad_records": records of the pad kernel}. torch's own reading
    (prof.events(), one FunctionEvent a record and their tree) costs ~60 us a
    record on the host: 20-30 s for a window of a stepwise or eager loop. The
    same fields come out: the process's first window is also read torch's
    way, and the two must agree."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    names, device, host, pad, async_ops = {}, [], [], 0, 0
    for e in result.events():
        raw = e.name()
        if raw in TRACE_DROPPED or getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = names.get(raw)
        if name is None:
            name = names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        pad += PAD_KERNEL in name
        is_async = e.is_async() or e.start_thread_id() != e.end_thread_id()
        if e.device_type() == cuda:
            device.append((name, (e.start_ns() - t0) / 1000, (e.end_ns() - t0) / 1000, is_async))
        elif e.device_type() == cpu and not is_async:
            host.append((e.start_thread_id(), e.start_ns(), -e.end_ns(), len(host), name))
        else:
            async_ops += name.startswith("aten::")
    # an op is nested where an earlier op on its thread spans it (EventList's tree)
    host_ops, stack, thread = async_ops, [], None
    for th, start, neg_end, _, name in sorted(host):
        if th != thread:
            stack, thread = [], th
        while stack and (start >= stack[-1] or -neg_end > stack[-1]):
            stack.pop()
        host_ops += not stack and name.startswith("aten::")
        stack.append(-neg_end)
    out = dict(device=device, host_ops=host_ops, pad_records=pad)
    if not _trace_checked:
        events = prof.events()
        want = sorted((e.name, e.time_range.start, e.time_range.end, e.is_async)
                      for e in events if e.device_type == cuda)
        want_ops = sum(1 for e in events if e.device_type != cuda and e.cpu_parent is None
                       and e.name.startswith("aten::"))
        check(sorted(device) == want and host_ops == want_ops,
              f"the trace read from kineto ({len(device)} device records, {host_ops} host "
              f"ops) is not torch's ({len(want)}, {want_ops})")
        _trace_checked.append(True)
    return out


def profile_window(torch, tag, fn, count_steps, attempts=None):
    """fn() once under torch.profiler: device time by kernel name (summed over
    launches), device busy and wall time, host ops and kernels per step
    (count_steps(fn's result) steps), and each wrapper's launches as the
    profiler traced them (`launches_traced`; inside CUDA graph replays too),
    which must equal the wrappers' counts over the window (the window
    opens with PAD_ROUNDS x PAD_LAUNCHES empty launches, left out). Returns (the
    profile, or None where the profiler saw no device time; fn's result).
    Host-to-device copies are left out of the device busy time and reported
    apart: their ms, and the ms of them that overlap a kernel. With
    `attempts` (PROFILE_ATTEMPTS by default; fn must be repeatable, and a
    caller that counts around the window counts inside fn), a window whose
    trace differs from the counts runs again: the profiler also drops
    records inside a window now and then (one of 624 attention launches in
    a 3-step window, 112 of 3,616 in a 32-token request, on the card). The
    counts must equal one window's whole trace, and the earlier windows'
    differences are reported (`lost_in_earlier_windows`)."""
    from torch.profiler import ProfilerActivity, profile

    from umbrella_tpu_torch.ops.kernels import launch_counts

    pad = empty_kernel(torch, torch.device("cuda", torch.cuda.current_device()), 1,
                       PAD_LAUNCHES)
    lost, attempts = [], attempts or PROFILE_ATTEMPTS
    for attempt in range(attempts):
        torch.cuda.synchronize()
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD_ROUNDS):
                pad()
                torch.cuda.synchronize()
                time.sleep(PAD_WAIT_S)
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = 1000 * (time.time() - t0)
        counted = {k: v - before[k] for k, v in launch_counts().items()}
        trace = read_trace(prof, torch)
        by_name, kernel_counts = {}, {}
        pad_traced = trace["pad_records"]
        for name, start, end, is_async in trace["device"]:
            # kernels only: CPU ops repeat the device time of the kernels they launch,
            # and host-to-device copies run on the copy engines (h2d_overlap below)
            if PAD_KERNEL in name or name.startswith("Memcpy HtoD"):
                continue
            kernel_counts[name] = kernel_counts.get(name, 0) + 1
            if not is_async and end > start:
                by_name[name] = by_name.get(name, 0.0) + (end - start) / 1000.0
        if not by_name:
            log(f"{tag} the profiler recorded no device time: not measured")
            return None, out
        wrong = trace_against_counts(kernel_counts, counted)[1]
        if not wrong or attempt == attempts - 1:
            break
        lost.append(dict(pad_traced=pad_traced, differ=wrong))
        log(f"{tag} window {attempt + 1}: the trace lost device records ({wrong}); again")
    launches = traced_launches(f"{tag} (pad records traced {pad_traced} of "
                               f"{PAD_ROUNDS * PAD_LAUNCHES})", kernel_counts, counted)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    host_ops = trace["host_ops"]
    kernels = sum(1 for name, *_ in trace["device"] if PAD_KERNEL not in name)
    steps = count_steps(out)
    # the W4A16 family's kernels (w4a16_kernel and w4a16_sum_partials); the
    # int8 W4 family's (w4a8_kernel, w4a8_sum_partials, quantize_rows); the
    # attention kernels (flash_tc_kernel, flash_attend_kernel)
    w4a16 = sum(v for k, v in by_name.items() if "w4a16" in k)
    w4a8 = sum(v for k, v in by_name.items() if "w4a8" in k or "quantize_rows" in k)
    attn = sum(v for k, v in by_name.items() if "flash_tc_kernel" in k
               or "flash_attend_kernel" in k)
    res = dict(steps=steps, wall_ms=wall_ms, device_busy_ms=busy,
               device_busy_ms_per_step=busy / steps, w4a16_device_ms_per_step=w4a16 / steps,
               w4a8_device_ms_per_step=w4a8 / steps, attention_device_ms_per_step=attn / steps,
               device_idle_share=1.0 - busy / wall_ms, host_ops_per_step=host_ops / steps,
               device_kernels_per_step=kernels / steps, launches_traced=launches,
               top_kernels_ms={k[:90]: v for k, v in top}, pad_traced=pad_traced,
               lost_in_earlier_windows=lost, **h2d_overlap(trace["device"]))
    log(f"{tag} {json.dumps(res)}")
    return res, out


# ---------------------------------------------------------------- phases 5-9: serving


def batched_engine(torch, dev, target, draft, batch, tree, kv_dtype, dtype, **kw):
    from umbrella_tpu_torch.sequoia import growmap_from_spec
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    eng = AutoEngine.from_config(
        device=dev, engine="batched_static", model=target, draft_model=draft, batch_size=batch,
        growmap=growmap_from_spec(*tree), max_length=MAX_LEN, eos_token_ids=[-100],
        segment_steps=SEGMENT_STEPS, kv_dtype=kv_dtype, dtype=dtype, **kw)
    eng.initialize()
    return eng


def random_requests(seed, n, new_tokens, prompt_len=PROMPT_LEN, **sampling):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [dict(input_ids=rng.integers(0, 120000, size=prompt_len).astype(np.int32).tolist(),
                 max_new_tokens=new_tokens, **sampling) for _ in range(n)]


def batched_lossless_check(torch, dev):
    """fp32, 4 layers, B=4 slots, more requests than slots, staggered prompt
    lengths: every request's greedy tokens from BatchedStaticEngine.run() equal
    the single-slot StaticEngine's tokens for the same prompt."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    tree = (2, 3)
    target, draft = build_target(torch, dev, n_layers=4, exit_layer=2, dtype=torch.float32)
    reqs = [dict(r, input_ids=r["input_ids"][:PROMPT_LEN - PROMPT_LEN // 8 * i])
            for i, r in enumerate(random_requests(3, 7, BATCHED_LOSSLESS_TOKENS))]
    eng = batched_engine(torch, dev, target, draft, 4, tree, None, torch.float32)
    reset_launch_counts()
    outs = eng.run(reqs)
    counts = launch_counts()
    graphs = check_graphed(eng, "[batched-lossless]")
    del eng
    single = make_engine(torch, dev, target, draft, torch.float32, tree=tree)
    same, vs_ar, gaps, parted = [], [], [], []
    for r, o in zip(reqs, outs):
        want = single.generate(input_ids=r["input_ids"],
                               max_new_tokens=BATCHED_LOSSLESS_TOKENS)["generated_tokens"]
        got = o["generated_tokens"]
        same.append(first_difference(got, want))
        ar, g, _, _ = greedy_ar_decode(torch, target, r["input_ids"], len(got))
        vs_ar.append((first_difference(got, ar), first_difference(want, ar)))
        if same[-1] < BATCHED_LOSSLESS_TOKENS:
            gaps.append(g[same[-1]])
            parted.append(dict(batched=got, single=want, ar=ar))
    res = dict(requests=len(reqs), slots=4, prompt_lens=[len(r["input_ids"]) for r in reqs],
               identical_prefix=same, batched_and_single_vs_ar=vs_ar,
               ar_gaps_where_they_part=gaps,
               avg_accept_tokens=[o["avg_accept_tokens"] for o in outs], launches=counts,
               graphs=graphs)
    log(f"[batched-lossless] {json.dumps(res)}")
    check(min(same) >= BATCHED_LOSSLESS_TOKENS,
          f"[batched-lossless] batched and single-slot tokens differ: {same} {parted}")
    for name in ("attend_flash_batched", "w4a16_matmul", "w4a8f_matmul", "w4a8_quantize",
                 "embed_gather"):
        check(counts[name] > 0, f"[batched-lossless] kernel {name} was never launched")
    return res


MULTI_CARD_TOKENS = 16


def multi_card_phase(torch, dev):
    """The static and the batched engine built on the last card while cuda:0
    is current (4 layers, bf16; the batched engine with int8 KV, B=4): 16
    tokens from each must equal the same engines' tokens on cuda:0, with every
    kernel of the path launched on the last card (the ctypes kernels launch
    on their tensors' card, not the current one). The static engine serves
    its first request through APIServer (the worker thread captures the
    decode graph) and the batched engine through a ContinuousBatcher (its
    loop thread): both threads start on cuda:0, and their tokens must equal
    the direct calls'. Skipped on one card."""
    from umbrella_tpu_torch.api.server import APIServer
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.serving.batched_engine import ContinuousBatcher

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log("[multi-card] skipped: 1 card")
        return dict(skipped="1 card")
    torch.cuda.set_device(0)
    prompt = random_requests(5, 1, MULTI_CARD_TOKENS)[0]["input_ids"]
    reqs = random_requests(6, 4, MULTI_CARD_TOKENS)
    tokens, counts = {}, {}
    for d in (dev, torch.device("cuda", n_cards - 1)):
        target, draft = build_target(torch, d, n_layers=4, exit_layer=2, dtype=torch.bfloat16)
        reset_launch_counts()
        eng = make_engine(torch, d, target, draft, torch.bfloat16)
        # first through the server, whose worker thread (on cuda:0 when it
        # starts) captures the decode graph, then directly
        server = APIServer({}, device=d, port=0, engine=eng)
        server.start()
        try:
            served = client_request(server.port, "get", dict(
                input_ids=prompt, max_new_tokens=MULTI_CARD_TOKENS))[0]["generated_tokens"]
        finally:
            server.shutdown()
        static = eng.generate(input_ids=prompt,
                              max_new_tokens=MULTI_CARD_TOKENS)["generated_tokens"]
        del eng, server
        eng = batched_engine(torch, d, target, draft, 4, (2, 3), "int8", torch.bfloat16)
        batcher = ContinuousBatcher(eng)  # its loop thread starts on cuda:0 too
        batcher.start()
        try:
            via_batcher = [f.result(timeout=300)["generated_tokens"]
                           for f in [batcher.submit(**dict(r)) for r in reqs]]
        finally:
            batcher.shutdown()
        batched = [o["generated_tokens"] for o in eng.run(reqs)]
        torch.cuda.synchronize(d)
        check(torch.cuda.current_device() == 0, "[multi-card] an engine changed the current card")
        tokens[str(d)], counts[str(d)] = dict(static=static, served=served, batched=batched,
                                              batcher=via_batcher), launch_counts()
        del eng, target, draft
        torch.cuda.empty_cache()
    first, last = tokens.values()
    res = dict(cards=n_cards, current=0, tokens=tokens, launches=counts)
    log(f"[multi-card] {json.dumps(res)}")
    check(first == last, "[multi-card] the engines on the last card give other tokens than on "
          "cuda:0")
    check(all(t["served"] == t["static"] and t["batcher"] == t["batched"]
              for t in tokens.values()),
          "[multi-card] the server or the batcher gave other tokens than the direct calls")
    for name in ("embed_gather", "attend_flash", "attend_flash_batched_int8", "w4a16_matmul",
                 "w4a8f_matmul", "w4a8_quantize"):
        check(list(counts.values())[-1][name] > 0,
              f"[multi-card] kernel {name} never launched on the last card")
    return res


def decode_segment(torch, eng, reqs, tag, profile_steps=SEGMENT_STEPS):
    """Admit B requests, then time one synced segment of SEGMENT_STEPS steps
    at full occupancy (ms per step, kernel launches per step); profile a
    second one of `profile_steps` steps."""
    for b, r in enumerate(reqs):
        check(eng.admit(b, r["input_ids"]), "admission failed")
    stop = [int(eng.num_nodes[b]) + 10**6 for b in range(eng.batch_size)]
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    eng.step_many(SEGMENT_STEPS, stop)  # warm
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    steps = eng.step_many(SEGMENT_STEPS, stop)
    ms = 1000 * (time.time() - t0) / SEGMENT_STEPS
    per_step = {k: n / SEGMENT_STEPS for k, n in launch_counts().items()}
    check(int(steps.min()) == SEGMENT_STEPS, "decode segment ran short")
    prof, _ = profile_window(torch, tag, lambda: eng.step_many(profile_steps, stop),
                             lambda _: profile_steps)
    eng.active[:] = False
    return ms, per_step, prof


def pct(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


def serve_phase(torch, dev, target, draft, tag, batch, tree, kv_dtype, n_requests,
                attn_kernel, pipelined=True, stepwise_too=False):
    """bench.py's serving rows: a warm-up run() of B requests, then n_requests
    through run(), then (optionally) all of them submitted at once to the
    pipelined ContinuousBatcher; then one profiled decode segment; all with
    the segment step replayed as a CUDA graph. stepwise_too: run() and the
    profiled segment again with the steps dispatched eagerly, side by side
    (the same tokens)."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.serving.batched_engine import ContinuousBatcher

    torch.cuda.reset_peak_memory_stats(dev)
    eng = batched_engine(torch, dev, target, draft, batch, tree, kv_dtype, torch.bfloat16)
    reqs = random_requests(5, n_requests, SERVE_NEW_TOKENS)
    eng.run(reqs[:batch])  # warm-up
    reset_launch_counts()
    steps0 = eng.steps_dispatched
    torch.cuda.synchronize()
    t0 = time.time()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    steps = eng.steps_dispatched - steps0
    for name in (attn_kernel, "w4a16_matmul", "w4a8f_matmul", "w4a8_quantize", "embed_gather"):
        check(counts[name] > 0, f"{tag} kernel {name} was never launched")
    check_tc_route(counts, tag)
    for r, o in zip(reqs, outs):
        toks = o["generated_tokens"]
        check(r["max_new_tokens"] <= len(toks) <= r["max_new_tokens"] + 1,
              f"{tag} request got {len(toks)} tokens")
        check(all(0 <= t < CFG_8B["vocab_size"] for t in toks), f"{tag} token out of range")
    total = sum(len(o["generated_tokens"]) for o in outs)
    res = dict(batch=batch, tree=f"{tree[0]}x{tree[1]}", kv_dtype=kv_dtype or "bf16",
               requests=n_requests, new_tokens=SERVE_NEW_TOKENS,
               run_tok_per_s=total / wall, run_s=wall, run_steps=steps,
               avg_accept_tokens=sum(o["avg_accept_tokens"] for o in outs) / len(outs),
               run_ttft_ms_p50=pct([o["ttft_ms"] for o in outs], 50),
               run_tpot_ms_p50=pct([o["time_per_output_token"] for o in outs], 50),
               launches=counts)
    if pipelined:
        batcher = ContinuousBatcher(eng)
        batcher.start()
        try:
            t0 = time.time()
            futs = [batcher.submit(**dict(r)) for r in reqs]
            pouts = [f.result(timeout=600) for f in futs]
            pwall = time.time() - t0
        finally:
            batcher.shutdown()
        same = sum(p["generated_tokens"] == o["generated_tokens"] for p, o in zip(pouts, outs))
        res.update(
            pipelined_tok_per_s=sum(len(p["generated_tokens"]) for p in pouts) / pwall,
            pipelined_s=pwall, pipelined_equal_to_run=same,
            ttft_ms_p50=pct([p["ttft_ms"] for p in pouts], 50),
            ttft_ms_p95=pct([p["ttft_ms"] for p in pouts], 95),
            tpot_ms_p50=pct([p["time_per_output_token"] for p in pouts], 50))
    step_ms, per_step, prof = decode_segment(torch, eng, reqs[:batch], f"{tag[:-1]}-profile]")
    check(prof is not None, f"{tag} the kernels' launches were not traced")
    res.update(decode_step_ms=step_ms, launches_per_step=per_step, profile=prof,
               launches_traced=prof["launches_traced"], graphs=check_graphed(eng, tag))
    if stepwise_too:  # the same requests with every segment step dispatched eagerly
        stepwise(eng)
        torch.cuda.synchronize()
        t0 = time.time()
        souts = eng.run(reqs)
        torch.cuda.synchronize()
        swall = time.time() - t0
        sstep_ms, _, sprof = decode_segment(torch, eng, reqs[:batch],
                                            tag=f"{tag[:-1]}-profile stepwise]")
        graphed(eng)
        same = sum(a["generated_tokens"] == b["generated_tokens"] for a, b in zip(souts, outs))
        res["stepwise"] = dict(run_tok_per_s=sum(len(o["generated_tokens"]) for o in souts) / swall,
                               run_s=swall, equal_to_graphed=same, decode_step_ms=sstep_ms,
                               profile=sprof)
        check(same == len(outs), f"{tag} stepwise and graphed segments gave other tokens "
              f"({same} of {len(outs)} requests equal)")
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"{tag} {json.dumps(res)}")
    del eng
    torch.cuda.empty_cache()
    return res


def stochastic_phase(torch, dev, target, draft):
    """B=32 int8 KV at temperature 0.6, top-p 0.9: the stochastic verify branch
    runs, every token is in range and every request finishes its budget."""
    eng = batched_engine(torch, dev, target, draft, 32, (2, 3), "int8", torch.bfloat16)
    reqs = random_requests(7, 32, STOCHASTIC_NEW_TOKENS, temperature=0.6, topp=0.9)
    t0 = time.time()
    outs = eng.run(reqs)
    wall = time.time() - t0
    for o in outs:
        toks = o["generated_tokens"]
        check(STOCHASTIC_NEW_TOKENS <= len(toks) <= STOCHASTIC_NEW_TOKENS + 1,
              f"[serve-stochastic] request got {len(toks)} tokens")
        check(all(0 <= t < CFG_8B["vocab_size"] for t in toks),
              "[serve-stochastic] token out of range")
    res = dict(requests=len(reqs), temperature=0.6, topp=0.9,
               tok_per_s=sum(len(o["generated_tokens"]) for o in outs) / wall,
               avg_accept_tokens=sum(o["avg_accept_tokens"] for o in outs) / len(outs),
               graphs=check_graphed(eng, "[serve-stochastic]"))
    log(f"[serve-stochastic] {json.dumps(res)}")
    del eng
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- checkpoints


# config.json of the checkpoints the shipped 8B configs name, as published:
# hugging-quants/Meta-Llama-3.1-8B-Instruct-AWQ-INT4 (AutoAWQ GEMM, fp16) and
# meta-llama/Llama-3.2-1B-Instruct (bf16, tied embeddings)
TARGET_HF_CONFIG = dict(
    architectures=["LlamaForCausalLM"], model_type="llama", vocab_size=128256, hidden_size=4096,
    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=131072,
    rope_scaling=dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                      original_max_position_embeddings=8192, rope_type="llama3"),
    tie_word_embeddings=False, bos_token_id=128000, eos_token_id=LLAMA3_EOS,
    hidden_act="silu", torch_dtype="float16",
    quantization_config=dict(quant_method="awq", bits=4, group_size=128, version="gemm",
                             zero_point=True))
DRAFT_HF_CONFIG = dict(
    architectures=["LlamaForCausalLM"], model_type="llama", vocab_size=128256, hidden_size=2048,
    intermediate_size=8192, num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
    head_dim=64, rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=131072,
    rope_scaling=dict(factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
                      original_max_position_embeddings=8192, rope_type="llama3"),
    tie_word_embeddings=True, bos_token_id=128000, eos_token_id=LLAMA3_EOS,
    hidden_act="silu", torch_dtype="bfloat16")
# meta-llama/Llama-3.1-8B-Instruct's config.json: the bf16 target of
# chat_config_8b_v5e.json and serve_batched_8b_v5e.json
TARGET_BF16_HF_CONFIG = dict({k: v for k, v in TARGET_HF_CONFIG.items()
                              if k != "quantization_config"}, torch_dtype="bfloat16")
CONFIG_NEW_TOKENS = 64  # cut from 128 to keep the script inside its time limit
CONFIG_TRACE_TOKENS = 16  # the traced request's; cut from 32 (the trace's records cost host time)
# the 8B checkpoint directory's depth, a quarter of the published 32 (its
# phases, [code-config] to [api-chat] and [pp-config]'s draft, then fit the
# script's time limit beside the Gemma2 and MoE phases)
CHECKPOINT_TARGET_LAYERS = 8
SERVE_CONFIG_REQUESTS = 32
SERVE_CONFIG_NEW_TOKENS = 64
_ST_CODES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16", "int32": "I32",
             "int64": "I64", "int8": "I8", "uint8": "U8"}


def write_safetensors(path, specs):
    """Write a safetensors file. specs: [(name, torch dtype, shape, make)] in
    file order; make() returns that tensor (on any device). Tensors are made
    and written one at a time, so host memory holds one tensor."""
    import math
    import struct

    import torch

    header, off = {}, 0
    for name, dtype, shape, _ in specs:
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        header[name] = dict(dtype=_ST_CODES[str(dtype).split(".")[-1]], shape=list(shape),
                            data_offsets=[off, off + n])
        off += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, dtype, shape, make in specs:
            t = make()
            check(t.dtype == dtype and tuple(t.shape) == tuple(shape), f"{name}: made {t.dtype} "
                  f"{tuple(t.shape)}, declared {dtype} {tuple(shape)}")
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())


def _proj_shapes(hf):
    """(HF projection name, in, out) of one decoder layer."""
    H, I = hf["hidden_size"], hf["intermediate_size"]
    D = hf.get("head_dim") or H // hf["num_attention_heads"]
    Hq, KV = hf["num_attention_heads"] * D, hf["num_key_value_heads"] * D
    return [("self_attn.q_proj", H, Hq), ("self_attn.k_proj", H, KV), ("self_attn.v_proj", H, KV),
            ("self_attn.o_proj", Hq, H), ("mlp.gate_proj", H, I), ("mlp.up_proj", H, I),
            ("mlp.down_proj", I, H)]


def target_specs(torch, dev, gen, hf):
    """AutoAWQ GEMM tensors of the 8B target: random packed words (nibbles
    0..15), zeros 6..9, fp16 scales U(0.0035, 0.005) so weights have std ~0.02;
    from layer 3 on the o_proj/down_proj scales are x0.05 (bench.py's damped
    tail), which keeps the residual stream near the first layers' scale."""
    f16, i32 = torch.float16, torch.int32
    H, V, g = hf["hidden_size"], hf["vocab_size"], hf["quantization_config"]["group_size"]

    def normal(shape, dtype):
        return lambda: (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    def ones(n):
        return lambda: torch.ones(n, dtype=f16, device=dev)

    def words(rows, n, lo=0, hi=16):
        def make():
            nib = torch.randint(lo, hi, (rows, n // 8, 8), generator=gen, device=dev)
            w = (nib << (4 * torch.arange(8, device=dev))).sum(-1)
            return (w - ((w >> 31) << 32)).to(i32)  # uint32 bits as int32
        return make

    def scales(rows, n, damp):
        return lambda: ((torch.rand((rows, n), generator=gen, device=dev) * 0.0015 + 0.0035)
                        * damp).to(f16)

    specs = [("model.embed_tokens.weight", f16, (V, H), normal((V, H), f16))]
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        specs += [(p + "input_layernorm.weight", f16, (H,), ones(H)),
                  (p + "post_attention_layernorm.weight", f16, (H,), ones(H))]
        for name, k, n in _proj_shapes(hf):
            damp = 0.05 if i >= 3 and name in ("self_attn.o_proj", "mlp.down_proj") else 1.0
            specs += [(p + name + ".qweight", i32, (k, n // 8), words(k, n)),
                      (p + name + ".qzeros", i32, (k // g, n // 8), words(k // g, n, 6, 10)),
                      (p + name + ".scales", f16, (k // g, n), scales(k // g, n, damp))]
    specs += [("model.norm.weight", f16, (H,), ones(H)),
              ("lm_head.weight", f16, (V, H), normal((V, H), f16))]
    return specs


def draft_specs(torch, dev, gen, hf):
    """bf16 tensors of the 1B draft: N(0, 0.02) weights, unit norms, tied head."""
    bf16 = torch.bfloat16
    H, V = hf["hidden_size"], hf["vocab_size"]

    def normal(shape):
        return lambda: (torch.randn(shape, generator=gen, device=dev) * 0.02).to(bf16)

    def ones():
        return lambda: torch.ones(H, dtype=bf16, device=dev)

    specs = [("model.embed_tokens.weight", bf16, (V, H), normal((V, H)))]
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        specs += [(p + "input_layernorm.weight", bf16, (H,), ones()),
                  (p + "post_attention_layernorm.weight", bf16, (H,), ones())]
        specs += [(p + name + ".weight", bf16, (n, k), normal((n, k)))
                  for name, k, n in _proj_shapes(hf)]
    return specs + [("model.norm.weight", bf16, (H,), ones())]


def spec_bytes(torch, specs):
    import math

    return sum(math.prod(s) * torch.empty((), dtype=d).element_size() for _, d, s, _ in specs)


def _write_dir(path, hf, shards):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    for i, specs in enumerate(shards):
        write_safetensors(os.path.join(
            path, f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
            if len(shards) > 1 else "model.safetensors"), specs)


def write_checkpoints(torch, dev, root, bf16=False):
    """The target (two shards, as published) at CHECKPOINT_TARGET_LAYERS of
    its 32 layers, a second target directory with `"awq_act": "int8"` over
    the same files, and the draft; with `bf16`, also the bf16
    Llama-3.1-8B-Instruct target at the same depth (dirs["target-bf16"]).
    If the disk cannot hold them, the targets' depth is cut further (never
    a width)."""
    import shutil

    free = shutil.disk_usage(root).free
    target_hf = dict(TARGET_HF_CONFIG, num_hidden_layers=CHECKPOINT_TARGET_LAYERS)
    gen = torch.Generator(device=dev)
    d_bytes = spec_bytes(torch, draft_specs(torch, dev, gen, DRAFT_HF_CONFIG))
    while True:
        t_bytes = spec_bytes(torch, target_specs(torch, dev, gen, target_hf))
        b_hf = dict(TARGET_BF16_HF_CONFIG, num_hidden_layers=target_hf["num_hidden_layers"])
        b_bytes = spec_bytes(torch, dense_specs(torch, dev, gen, b_hf)) if bf16 else 0
        if t_bytes + b_bytes + d_bytes + 2e9 <= free or target_hf["num_hidden_layers"] <= 4:
            break
        target_hf["num_hidden_layers"] -= 4
    log(f"[checkpoint] free disk {free / 1e9:.1f} GB; target {t_bytes / 1e9:.2f} GB at "
        f"{target_hf['num_hidden_layers']} layers, bf16 target {b_bytes / 1e9:.2f} GB, "
        f"draft {d_bytes / 1e9:.2f} GB")
    check(t_bytes + b_bytes + d_bytes + 2e9 <= free,
          "[checkpoint] not enough disk even at 4 layers")
    dirs = {k: os.path.join(root, k) for k in ("target", "target-w4a8", "draft")}
    t0 = time.time()
    specs = target_specs(torch, dev, gen.manual_seed(11), target_hf)
    half = 1 + 23 * (target_hf["num_hidden_layers"] // 2)  # embed + half the layers | the rest
    _write_dir(dirs["target"], target_hf, [specs[:half], specs[half:]])
    os.makedirs(dirs["target-w4a8"])
    for f in os.listdir(dirs["target"]):
        if f.endswith(".safetensors"):
            os.symlink(os.path.join(dirs["target"], f), os.path.join(dirs["target-w4a8"], f))
    with open(os.path.join(dirs["target-w4a8"], "config.json"), "w") as f:
        json.dump(dict(target_hf, awq_act="int8"), f, indent=1)
    t_write = time.time() - t0
    t0 = time.time()
    _write_dir(dirs["draft"], DRAFT_HF_CONFIG,
               [draft_specs(torch, dev, gen.manual_seed(12), DRAFT_HF_CONFIG)])
    d_write = time.time() - t0
    if bf16:  # two shards, as the AWQ target (meta-llama's own directory has four)
        dirs["target-bf16"] = os.path.join(root, "target-bf16")
        specs = dense_specs(torch, dev, gen.manual_seed(13), b_hf)
        half = 1 + 9 * (b_hf["num_hidden_layers"] // 2)  # embed + half the layers | the rest
        _write_dir(dirs["target-bf16"], b_hf, [specs[:half], specs[half:]])
    torch.cuda.empty_cache()
    return dict(dirs=dirs, target_hf=target_hf, target_gb=t_bytes / 1e9, draft_gb=d_bytes / 1e9,
                bf16_target_gb=b_bytes / 1e9,
                target_layers=target_hf["num_hidden_layers"], free_disk_gb=free / 1e9,
                target_write_s=t_write, draft_write_s=d_write)


def _rss_gb():
    """The process's resident set now, from /proc/self/statm (None where absent)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30
    except (OSError, ValueError, IndexError):
        return None


def _timed_load(torch, dev, path, **kw):
    """AutoModelLM.from_pretrained(path), timed, with the host RSS sampled every
    5 ms by a thread during the load (its peak and its rise over the start)."""
    import threading

    from umbrella_tpu_torch.models.auto_model import AutoModelLM

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    rss0, peak, done = _rss_gb(), [_rss_gb() or 0.0], threading.Event()

    def sample():
        while not done.wait(0.005):
            peak[0] = max(peak[0], _rss_gb() or 0.0)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.time()
    try:
        rt = AutoModelLM.from_pretrained(path, device=dev, **kw)
        torch.cuda.synchronize()
    finally:
        done.set()
        sampler.join()
    return rt, dict(load_s=time.time() - t0,
                    host_rss_gb_before=rss0, peak_host_rss_gb=peak[0] if rss0 else None,
                    device_gb=(torch.cuda.memory_allocated(dev) - base) / 2**30,
                    peak_device_gb=(torch.cuda.max_memory_allocated(dev) - base) / 2**30)


def checkpoint_phase(torch, dev, ckpt):
    """Load both checkpoints through AutoModelLM.from_pretrained (timed, with
    peak host RSS and device memory); the target's logits for a 16-token
    prompt must equal, bit for bit, those of the same tensors converted in
    memory (regenerated from the seed on the card)."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import ModelRuntime
    from umbrella_tpu_torch.ops.masks import causal_mask_rows
    from umbrella_tpu_torch.quantization.awq import AwqTensor
    from umbrella_tpu_torch.quantization.loader import awq_params_from_hf_state_dict

    L = 256
    target, t_load = _timed_load(torch, dev, ckpt["dirs"]["target"], max_length=L)
    log(f"[checkpoint] target loaded {t_load}")
    check(isinstance(target.params["layers"]["gate_up"][0], AwqTensor)
          and target.params["lm_head"].dtype == torch.bfloat16 and target.cfg.eos_token_ids ==
          LLAMA3_EOS and target.cfg.rope_scaling["rope_type"] == "llama3",
          "[checkpoint] target loaded in the wrong form")
    ids = torch.arange(100, 116, device=dev)
    pos = torch.arange(16, device=dev)
    mask = causal_mask_rows(0, 16, L, device=dev)

    def logits(rt):
        return rt.forward(rt.params, rt.init_kv(), ids, pos, mask, 0)[0]

    got = logits(target)
    del target
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(11)
    sd = {name: make() for name, _, _, make in target_specs(torch, dev, gen, ckpt["target_hf"])}
    cfg = ModelConfig.from_dict(ckpt["target_hf"])
    mem = ModelRuntime(cfg, awq_params_from_hf_state_dict(sd, cfg, L, device=dev), L, device=dev)
    del sd
    want = logits(mem)
    del mem
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(got).all()), "[checkpoint] target logits not finite")
    check(torch.equal(got, want), "[checkpoint] loaded target's logits differ from the in-memory "
          f"conversion: max abs diff {(got - want).abs().max().item()}")
    draft, d_load = _timed_load(torch, dev, ckpt["dirs"]["draft"], max_length=L)
    log(f"[checkpoint] draft loaded {d_load}")
    hf = DRAFT_HF_CONFIG
    qkv = (hf["num_attention_heads"] + 2 * hf["num_key_value_heads"]) * hf["head_dim"]
    check("lm_head" not in draft.params and draft.args.head_dim == hf["head_dim"]
          and draft.params["layers"]["wqkv"].shape == (hf["num_hidden_layers"],
                                                       hf["hidden_size"], qkv),
          "[checkpoint] draft loaded in the wrong form")
    d_logits = logits(draft)
    check(bool(torch.isfinite(d_logits).all()), "[checkpoint] draft logits not finite")
    del draft
    torch.cuda.empty_cache()
    res = dict({k: v for k, v in ckpt.items() if k not in ("dirs", "target_hf")},
               target=t_load, draft=d_load, logits_equal_in_memory=True)
    log(f"[checkpoint] {json.dumps(res)}")
    return res


def shipped_config(name, ckpt, target="target"):
    """A shipped config file with only model, draft_model and growmap_path
    rewritten (the checkpoints written above; the port's copy of the tree)."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", name)) as f:
        cfg = json.load(f)
    tree = os.path.join(here, "umbrella_tpu_torch", "trees", os.path.basename(cfg["growmap_path"]))
    return dict(cfg, model=ckpt["dirs"][target], draft_model=ckpt["dirs"]["draft"],
                growmap_path=tree)


def code_config_phase(torch, dev, ckpt, prompt, tag, target):
    """configs/code_config_8b_awq_v5e.json as shipped (greedy, 24x6 tree, W4
    draft with a W4 head from quantize_draft: true) through AutoEngine ->
    initialize -> generate(); CONFIG_NEW_TOKENS new tokens in place of 512."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.quantization.awq import AwqTensor
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    cfg = shipped_config("code_config_8b_awq_v5e.json", ckpt, target)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    eng = AutoEngine.from_config(device=dev, **cfg)
    eng.initialize()
    torch.cuda.synchronize()
    init_s = time.time() - t0
    w4a8 = target == "target-w4a8"
    check(eng.target_model.args.awq_act_int8 == w4a8, f"{tag} awq_act not taken from config.json")
    check(isinstance(eng.draft_model.params["layers"]["wqkv"][0], AwqTensor)
          and isinstance(eng.draft_model.params["lm_head"], AwqTensor),
          f"{tag} quantize_draft: true did not give a W4 draft and head")
    eng.generate(input_ids=prompt, max_new_tokens=16)  # warm-up
    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.time()
    check(eng._prefill(prompt), f"{tag} prefill refused")
    torch.cuda.synchronize()
    ttft_ms = 1000 * (time.time() - t1)
    prefill_counts = launch_counts()
    eng.reset()
    reset_launch_counts()
    out = eng.generate(input_ids=prompt, max_new_tokens=CONFIG_NEW_TOKENS)
    counts = launch_counts()
    toks = out["generated_tokens"]
    steps = max(1, round(len(toks) / out["avg_accept_tokens"]))
    eos = set(eng.eos_token_ids)
    check(len(toks) >= CONFIG_NEW_TOKENS or toks[-1] in eos, f"{tag} stopped early: {len(toks)}")
    check(all(0 <= t < 128256 for t in toks), f"{tag} token out of range")
    kernels = ("embed_gather", "attend_flash", "w4a16_matmul") + (
        ("w4a8_matmul", "w4a8_quantize") if w4a8 else ())
    for name in kernels:
        check(counts[name] > 0, f"{tag} kernel {name} was never launched")
    check_tc_route(counts, tag)
    check(w4a8 or counts["w4a8_matmul"] == 0, f"{tag} a W4A16 target ran W4A8")
    graphs = check_graphed(eng, tag)
    (graph,) = eng._decode_graphs.values()
    # a traced request: the captured step's launches against the replays' in the trace
    before = {}

    def request():  # the replays before each profiled window (the last one counts)
        before["replays"] = graph.replays
        return eng.generate(input_ids=prompt, max_new_tokens=CONFIG_TRACE_TOKENS)

    trace, _ = profile_window(torch, f"{tag[:-1]}-trace]", request, request_steps)
    check(trace is not None, f"{tag} the kernels' launches were not traced")
    replays = graph.replays - before["replays"]
    traced = trace["launches_traced"]
    per_step = {k: (n - prefill_counts[k]) / replays for k, n in traced.items()}
    check(all(per_step[k] == graph.launches[k] for k in per_step),
          f"{tag} launches a step traced {per_step}, captured {graph.launches}")
    res = dict(tokens=len(toks), steps=steps, tok_per_s=1000.0 / out["time_per_output_token"],
               decode_step_ms=out["time_per_output_token"] * len(toks) / steps,
               avg_accept_tokens=out["avg_accept_tokens"], ttft_ms_prefill128=ttft_ms,
               init_s=init_s, launches=counts, launches_per_step=graph.launches,
               launches_traced=traced, launches_per_step_traced=per_step, graphs=graphs,
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"{tag} {json.dumps(res)}")
    del eng
    torch.cuda.empty_cache()
    return res


def serve_config_phase(torch, dev, ckpt, shared=None):
    """configs/serve_batched_8b_awq_int8kv_v5e.json as shipped (B=32, int8 KV,
    Int4F draft, 2x3 tree, temperature 0.6, segment_steps 16): 32 requests of
    PROMPT_LEN random tokens and SERVE_CONFIG_NEW_TOKENS new ones through run()."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.quantization.int4f import Int4FTensor
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    cfg = shipped_config("serve_batched_8b_awq_int8kv_v5e.json", ckpt)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    eng = AutoEngine.from_config(device=dev, **cfg)
    eng.initialize()
    torch.cuda.synchronize()
    init_s = time.time() - t0
    check(eng.kv_target.quantized and isinstance(eng.draft_model.params["lm_head"], Int4FTensor),
          "[serve-config] int8 KV / Int4F draft not set up from the config")
    reqs = random_requests(9, SERVE_CONFIG_REQUESTS, SERVE_CONFIG_NEW_TOKENS)
    eng.run([dict(r, max_new_tokens=8) for r in reqs[:4]])  # warm-up
    reset_launch_counts()
    steps0 = eng.steps_dispatched
    torch.cuda.synchronize()
    t0 = time.time()
    outs = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    eos = set(eng.eos_token_ids)
    for o in outs:
        toks = o["generated_tokens"]
        check(len(toks) <= SERVE_CONFIG_NEW_TOKENS + 1 and (
            len(toks) >= SERVE_CONFIG_NEW_TOKENS or toks[-1] in eos),
            f"[serve-config] request got {len(toks)} tokens")
        check(all(0 <= t < 128256 for t in toks), "[serve-config] token out of range")
    for name in ("attend_flash_batched_int8", "w4a16_matmul", "w4a8f_matmul", "w4a8_quantize",
                 "embed_gather"):
        check(counts[name] > 0, f"[serve-config] kernel {name} was never launched")
    check_tc_route(counts, "[serve-config]")
    graphs = check_graphed(eng, "[serve-config]")
    steps = eng.steps_dispatched - steps0
    res = dict(batch=eng.batch_size, requests=len(reqs), new_tokens=SERVE_CONFIG_NEW_TOKENS,
               temperature=eng.temperature, init_s=init_s,
               tok_per_s=sum(len(o["generated_tokens"]) for o in outs) / wall, run_s=wall,
               run_steps=steps,
               avg_accept_tokens=sum(o["avg_accept_tokens"] for o in outs) / len(outs),
               ttft_ms_p50=pct([o["ttft_ms"] for o in outs], 50), launches=counts,
               launches_per_step={k: n / max(steps, 1) for k, n in counts.items()},
               graphs=graphs, peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"[serve-config] {json.dumps(res)}")
    if shared is not None:  # [api-serve] serves this engine next
        shared["serve-config"] = eng
    del eng
    torch.cuda.empty_cache()
    return res


class WordTokenizer:
    """A stand-in tokenizer for the synthetic checkpoints (they ship none, and
    the card's machine has no `transformers`): one word a token, a token
    divisible by 13 ends its word with a period (so that the streaming
    loop's sentence-complete stop runs); encode maps characters to ids."""

    def encode(self, text):
        return [128000] + [ord(c) % 120000 for c in text]

    def decode(self, ids, **kw):
        return " ".join(f"w{i}." if i % 13 == 0 else f"w{i}" for i in ids)


API_SERVE_REQUESTS = 64
API_NEW_TOKENS = 40  # cut from 128, then 96, 80, to keep the script inside its time limit
API_PRIORITIES = (1, 10, 20)


def frames_grow(texts):
    """Each streamed frame's text extends the one before."""
    return all(b.startswith(a.rstrip()) for a, b in zip(texts, texts[1:]))


def client_request(port, kind, req):
    """One client connection and request: `kind` "stream" reads the frames
    (stream_output), else one answer (get_output). Returns the result, the
    frames' texts, the seconds to the first frame (or answer) and to the
    result."""
    from umbrella_tpu_torch.api.client import APIClient

    client = APIClient(port=port, retry_seconds=0.2)
    client.run()
    t0 = time.time()
    texts, first = [], None
    if kind == "stream":
        for frame in client.stream_output(**req):
            first = first or time.time() - t0
            if frame.get("partial"):
                texts.append(frame["generated_text"])
            else:
                result = frame
    else:
        result = client.get_output(**req)
        first = time.time() - t0
    done = time.time() - t0
    client.close()
    return result, texts, first, done


def timed_callbacks(be):
    """Wrap the serving loop's host callbacks (the stream frames of
    `_SlotTracker.emit_partials`, the futures resolved by `_resolve`, which
    run their done-callbacks inline) to sum their seconds; count the synced
    segments. Returns (stats, undo)."""
    stats = dict(emit_s=0.0, resolve_s=0.0, segments=0, max_call_ms=0.0)
    emit, resolve, sync = be._SlotTracker.emit_partials, be._resolve, \
        be.BatchedStaticEngine.sync_segment

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                stats[key] += dt
                stats["max_call_ms"] = max(stats["max_call_ms"], 1000 * dt)
        return run

    def counted(*a, **k):
        stats["segments"] += 1
        return sync(*a, **k)

    be._SlotTracker.emit_partials = timed(emit, "emit_s")
    be._resolve = timed(resolve, "resolve_s")
    be.BatchedStaticEngine.sync_segment = counted

    def undo():
        be._SlotTracker.emit_partials, be._resolve = emit, resolve
        be.BatchedStaticEngine.sync_segment = sync
    return stats, undo


def check_released(engine, threads, tag):
    """Every thread started since `threads` was taken has ended (the servers'
    listeners, connections and workers, the batchers' loops), and the engine
    behind the weak reference `engine` has been freed with them."""
    for t in set(threading.enumerate()) - threads:
        t.join(timeout=10)
    gc.collect()
    check(engine() is None, f"{tag} the engine outlived its servers (a thread still holds it)")


def serve_clients(eng, cfg, dev, reqs, kinds):
    """Serve `reqs` to one client thread each through an APIServer built from
    `cfg` over a new ContinuousBatcher on `eng` (with its scheduler key, the
    scheduler's route, and then the metrics; without, the batcher's route,
    where the loop thread sends each result and frame itself). Returns the
    clients' (result, frame texts, first, done), the wall seconds, the
    metrics, the scheduler's workers, each request's arrival and slot
    admission (seconds from the start) and the loop's callback times
    (timed_callbacks)."""
    from concurrent.futures import ThreadPoolExecutor

    from umbrella_tpu_torch.api.server import APIServer
    from umbrella_tpu_torch.serving import batched_engine as be
    from umbrella_tpu_torch.serving.scheduler import BatcherBackend

    server = APIServer(cfg, device=dev, port=0, batcher=be.ContinuousBatcher(eng),
                       max_client=len(reqs))
    server.start()
    sched, arrived, admitted, t0 = server.scheduler, [], [], time.time()
    if sched is not None:
        submit, on_admission = sched.submit, sched._on_slot_admission
        sched.submit = lambda **kw: arrived.append(time.time() - t0) or submit(**kw)
        sched._on_slot_admission = \
            lambda *a: admitted.append(time.time() - t0) or on_admission(*a)
    stats, undo = timed_callbacks(be)
    try:
        with ThreadPoolExecutor(max_workers=len(reqs)) as pool:
            t0 = time.time()
            futs = [pool.submit(client_request, server.port, kind, dict(r, req_id=i))
                    for i, (r, kind) in enumerate(zip(reqs, kinds))]
            served = [f.result(timeout=600) for f in futs]
            wall = time.time() - t0
        metrics = sched and client_request(server.port, "get_metrics",
                                           dict(get_metrics=True))[0]
    finally:
        undo()
        server.shutdown()
    return dict(served=served, s=wall, metrics=metrics, workers=len(sched.engines) if sched else 0,
                batcher_backends=bool(sched) and all(isinstance(w, BatcherBackend)
                                                     for w in sched.engines),
                arrived=arrived, admitted=admitted, stats=stats)


def api_serve_phase(torch, dev, ckpt, shared):
    """configs/serve_batched_8b_awq_int8kv_v5e.json as shipped, served through
    APIServer on port 0: `"scheduler": {}` puts make_scheduler's 40 workers
    (B=32) in front of a ContinuousBatcher over [serve-config]'s engine.
    API_SERVE_REQUESTS client threads send one request each (PROMPT_LEN
    prompt tokens, API_NEW_TOKENS new ones, priorities 1/10/20; 16 stream
    their frames, 16 are greedy, the rest sample at the config's 0.6 / 0.9),
    then one get_metrics request. The same requests go through run() and the
    direct ContinuousBatcher (the batcher and the server twice, in turn).
    Greedy tokens through the server equal
    run()'s; stream frames grow and end in the result; the kernels launched;
    the decode was graphed. Then the same requests again with a worker a
    request (`"scheduler": {"workers": 64}`), which puts every request in the
    batcher's FIFO as the direct run does, and without the scheduler key
    (the batcher's route: the loop thread sends results and frames)."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.serving import batched_engine as be
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    threads = set(threading.enumerate())
    cfg = shipped_config("serve_batched_8b_awq_int8kv_v5e.json", ckpt)
    check(cfg.get("scheduler") == {}, "[api-serve] the shipped config has no scheduler key")
    eng = shared.pop("serve-config", None)
    if eng is None:  # run without [serve-config]
        eng = AutoEngine.from_config(device=dev, **{k: v for k, v in cfg.items()
                                                    if k != "scheduler"})
        eng.initialize()
    eng.tokenizer = WordTokenizer()
    torch.cuda.reset_peak_memory_stats(dev)
    reqs = random_requests(11, API_SERVE_REQUESTS, API_NEW_TOKENS)
    kinds = ["greedy" if i % 4 == 0 else "stream" if i % 4 == 1 else "sampled"
             for i in range(len(reqs))]
    for r, kind, i in zip(reqs, kinds, range(len(reqs))):
        r["priority"] = API_PRIORITIES[i % len(API_PRIORITIES)]
        if kind == "greedy":
            r["temperature"] = 0.0
    plain = [{k: v for k, v in r.items() if k != "priority"} for r in reqs]
    eng.run([dict(r, max_new_tokens=8) for r in plain[:eng.batch_size]])  # warm-up

    def tokens_of(outs):
        return sum(len(o["generated_tokens"]) for o in outs)

    torch.cuda.synchronize()
    t0 = time.time()
    run_outs = eng.run([dict(r) for r in plain])
    torch.cuda.synchronize()
    run_s = time.time() - t0
    def batch_direct():
        """All requests submitted at once to a ContinuousBatcher of this thread."""
        batcher, admit = be.ContinuousBatcher(eng), []
        batcher.start()
        try:
            t0 = time.time()
            futs = [batcher.submit(_admit_cb=lambda _d: admit.append(time.time() - t0),
                                   **dict(r)) for r in plain]
            outs = [f.result(timeout=600) for f in futs]
            return outs, time.time() - t0, admit
        finally:
            batcher.shutdown()

    # the direct batcher and the server (the config's scheduler key in front of
    # a new batcher on the same engine) in turn, twice
    direct, direct_s, direct_admit = batch_direct()
    reset_launch_counts()
    shipped = serve_clients(eng, cfg, dev, reqs, kinds)
    counts = launch_counts()
    check(shipped["workers"] == 40 and shipped["batcher_backends"],
          "[api-serve] the scheduler key did not put 40 BatcherBackend workers in front")
    direct2, direct2_s, _ = batch_direct()
    shipped2 = serve_clients(eng, cfg, dev, reqs, kinds)
    # again with a worker a request: every request waits inside the batcher's
    # FIFO, as in the direct run (the shipped lookahead is B // 4 = 8)
    every = serve_clients(eng, dict(cfg, scheduler={"workers": len(reqs)}), dev, reqs, kinds)
    # and without the scheduler key: the batcher's route (JSON and sendall on the loop thread)
    direct_route = serve_clients(eng, {k: v for k, v in cfg.items() if k != "scheduler"}, dev,
                                 reqs, kinds)
    served, server_s, metrics, stats = (shipped[k] for k in ("served", "s", "metrics", "stats"))
    results = [s[0] for s in served]
    check(all(r.get("processed") is True for r in results),
          f"[api-serve] {sum(r.get('processed') is not True for r in results)} requests failed")
    check([r["req_id"] for r in results] == list(range(len(reqs))), "[api-serve] req_id lost")
    eos = set(eng.eos_token_ids)
    for r in results:
        toks = r["generated_tokens"]
        check(len(toks) <= API_NEW_TOKENS + 1 and (len(toks) >= API_NEW_TOKENS or toks[-1] in eos)
              and all(0 <= t < 128256 for t in toks), f"[api-serve] request got {len(toks)} tokens")
    greedy = [i for i, k in enumerate(kinds) if k == "greedy"]
    equal = sum(results[i]["generated_tokens"] == run_outs[i]["generated_tokens"]
                == direct[i]["generated_tokens"] == every["served"][i][0]["generated_tokens"]
                == direct_route["served"][i][0]["generated_tokens"]
                == direct2[i]["generated_tokens"] == shipped2["served"][i][0]["generated_tokens"]
                for i in greedy)
    check(equal == len(greedy), f"[api-serve] greedy tokens through the server (each route) "
          f"equal run()'s and the batcher's for {equal} of {len(greedy)} requests")
    check(all(r.get("processed") is True for r, *_ in every["served"] + direct_route["served"]
              + shipped2["served"]),
          "[api-serve] a request failed with a worker a request or without the scheduler")
    streams = [i for i, k in enumerate(kinds) if k == "stream"]
    frames = [len(served[i][1]) for i in streams]
    for i in streams:
        texts, result = served[i][1], results[i]
        check(len(texts) >= 2 and frames_grow(texts) and texts[-1] == result["generated_text"]
              == eng.tokenizer.decode(result["generated_tokens"]),
              f"[api-serve] request {i}: stream frames do not grow into the result")
    for name in ("attend_flash_batched_int8", "w4a16_matmul", "w4a8f_matmul", "w4a8_quantize",
                 "embed_gather"):
        check(counts[name] > 0, f"[api-serve] kernel {name} was never launched")
    check_tc_route(counts, "[api-serve]")
    graphs = check_graphed(eng, "[api-serve]")
    check(metrics["requests"] == len(reqs) and metrics["tokens"] == tokens_of(results)
          and set(metrics["by_priority"]) == {str(p) for p in API_PRIORITIES},
          f"[api-serve] scheduler metrics {metrics}")
    client_ttft = [1000 * served[i][2] for i in streams]
    res = dict(
        requests=len(reqs), new_tokens=API_NEW_TOKENS, greedy=len(greedy), streams=len(streams),
        workers=shipped["workers"], server_tok_per_s=tokens_of(results) / server_s,
        server_s=server_s, batcher_tok_per_s=tokens_of(direct) / direct_s, batcher_s=direct_s,
        server2_tok_per_s=tokens_of([r for r, *_ in shipped2["served"]]) / shipped2["s"],
        batcher2_tok_per_s=tokens_of(direct2) / direct2_s,
        run_tok_per_s=tokens_of(run_outs) / run_s, run_s=run_s, greedy_equal_to_run=equal,
        client_ttft_ms_p50=pct(client_ttft, 50), client_ttft_ms_p95=pct(client_ttft, 95),
        server_ttft_ms_p50=pct([r["ttft_ms"] for r in results], 50),
        server_ttft_ms_p95=pct([r["ttft_ms"] for r in results], 95),
        batcher_ttft_ms_p50=pct([r["ttft_ms"] for r in direct], 50),
        client_s_p50=pct([s[3] for s in served], 50),
        arrival_s_p50=pct(shipped["arrived"], 50), arrival_s_max=max(shipped["arrived"]),
        admitted_s_p50=pct(shipped["admitted"], 50), admitted_s_p95=pct(shipped["admitted"], 95),
        batcher_admitted_s_p50=pct(direct_admit, 50),
        batcher_admitted_s_p95=pct(direct_admit, 95),
        frames_per_stream=sum(frames) / len(frames), segments=stats["segments"],
        callback_ms_per_segment=1000 * (stats["emit_s"] + stats["resolve_s"])
        / max(stats["segments"], 1),
        emit_ms_per_segment=1000 * stats["emit_s"] / max(stats["segments"], 1),
        callback_max_ms=stats["max_call_ms"],
        scheduler={k: metrics[k] for k in ("requests", "tokens", "expired",
                                           "priority_inversions", "queue_seconds",
                                           "busy_seconds", "by_priority")},
        worker_a_request=dict(
            workers=every["workers"],
            server_tok_per_s=tokens_of([r for r, *_ in every["served"]]) / every["s"],
            server_s=every["s"],
            server_ttft_ms_p50=pct([r["ttft_ms"] for r, *_ in every["served"]], 50),
            admitted_s_p50=pct(every["admitted"], 50), admitted_s_p95=pct(every["admitted"], 95),
            priority_inversions=every["metrics"]["priority_inversions"]),
        batcher_route=dict(
            server_tok_per_s=tokens_of([r for r, *_ in direct_route["served"]])
            / direct_route["s"], server_s=direct_route["s"],
            server_ttft_ms_p50=pct([r["ttft_ms"] for r, *_ in direct_route["served"]], 50),
            callback_ms_per_segment=1000 * (direct_route["stats"]["emit_s"]
                                            + direct_route["stats"]["resolve_s"])
            / max(direct_route["stats"]["segments"], 1),
            callback_max_ms=direct_route["stats"]["max_call_ms"],
            segments=direct_route["stats"]["segments"]),
        launches=counts, graphs=graphs,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"[api-serve] {json.dumps(res)}")
    engine = weakref.ref(eng)
    del eng
    check_released(engine, threads, "[api-serve]")
    torch.cuda.empty_cache()
    return res


def api_chat_phase(torch, dev, ckpt, prompt):
    """configs/chat_config_8b_awq_v5e.json as shipped (the static engine, 24x6
    tree, the 1B draft W4-quantized, temperature 0.6 / top-p 0.9 /
    repetition penalty 1.05) served by APIServer on port 0, which builds the
    engine from the config; its single worker runs the requests (and
    captures the decode graphs) on its own thread. One greedy request through
    the server equals the direct generate(); a streamed greedy request's
    text is those tokens' (up to its sentence stop); two stochastic requests
    complete."""
    from umbrella_tpu_torch.api.server import APIServer
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    threads = set(threading.enumerate())
    cfg = dict(shipped_config("chat_config_8b_awq_v5e.json", ckpt), tokenizer=WordTokenizer())
    torch.cuda.reset_peak_memory_stats(dev)
    server = APIServer(cfg, device=dev, port=0)
    t0 = time.time()
    server.start()
    init_s = time.time() - t0
    eng = server.engine
    check(server.scheduler is None and server.batcher is None and eng is not None,
          "[api-chat] the chat config must take the single-engine path")
    greedy = dict(input_ids=prompt, max_new_tokens=API_NEW_TOKENS, temperature=0.0)
    sampled = dict(input_ids=prompt, max_new_tokens=API_NEW_TOKENS, temperature=0.6, topp=0.9,
                   repetition_penalty=1.05)
    try:
        client_request(server.port, "get", dict(greedy, max_new_tokens=16))  # warm-up
        reset_launch_counts()
        served, _, _, served_s = client_request(server.port, "get", dict(greedy))
        counts = launch_counts()
        # served and direct (on this thread, nothing in flight) in turn, twice
        runs = {"served": [(served, served_s)], "direct": []}
        for i in range(3):
            if i:
                runs["served"].append(client_request(server.port, "get", dict(greedy))[::3])
            torch.cuda.synchronize()
            t0 = time.time()
            out = eng.generate(**dict(greedy))
            torch.cuda.synchronize()
            runs["direct"].append((out, time.time() - t0))
        direct = runs["direct"][0][0]
        stream, texts, first_s, stream_s = client_request(server.port, "stream", dict(greedy))
        stochastic = [client_request(server.port, "get", dict(sampled))[0] for _ in range(2)]
    finally:
        server.shutdown()
    toks = served["generated_tokens"]
    eos = set(eng.eos_token_ids)

    def finished(t):
        return len(t) >= API_NEW_TOKENS or (len(t) > 0 and t[-1] in eos)

    check(served.get("processed") is True and finished(toks),
          f"[api-chat] the greedy request got {len(toks)} tokens")
    for out, _ in runs["served"] + runs["direct"]:
        check(out["generated_tokens"] == direct["generated_tokens"],
              f"[api-chat] the server's greedy tokens differ from generate()'s at "
              f"{first_difference(out['generated_tokens'], direct['generated_tokens'])}")
    words = stream["generated_text"].split()
    want = eng.tokenizer.decode(toks).split()
    check(stream.get("processed") is True and frames_grow(texts) and len(texts) >= 1
          and (len(words) >= API_NEW_TOKENS - eng.stop_distance or toks[-1] in eos)
          and words[:len(want)] == want[:len(words)],
          "[api-chat] the streamed greedy text is not the greedy tokens'")
    for r in stochastic:
        t = r["generated_tokens"]
        check(r.get("processed") is True and finished(t)
              and all(0 <= x < 128256 for x in t), "[api-chat] a stochastic request failed")
    for name in ("embed_gather", "attend_flash", "w4a16_matmul"):
        check(counts[name] > 0, f"[api-chat] kernel {name} was never launched")
    check_tc_route(counts, "[api-chat]")
    graphs = check_graphed(eng, "[api-chat]")
    walls = {k: [w for _, w in v] for k, v in runs.items()}
    tpots = {k: [o["time_per_output_token"] for o, _ in v] for k, v in runs.items()}
    res = dict(
        init_s=init_s, tokens=len(toks), server_tok_per_s=len(toks) / pct(walls["served"], 50),
        direct_tok_per_s=len(toks) / pct(walls["direct"], 50), server_s=walls["served"],
        direct_s=walls["direct"], tpot_ms=pct(tpots["served"], 50),
        direct_tpot_ms=pct(tpots["direct"], 50), tpot_ms_served=tpots["served"],
        tpot_ms_direct=tpots["direct"],
        avg_accept_tokens=served["avg_accept_tokens"],
        stochastic_accept=[r["avg_accept_tokens"] for r in stochastic],
        first_frame_ms=1000 * first_s, stream_s=stream_s, stream_frames=len(texts),
        stream_words=len(words), launches=counts, graphs=graphs,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"[api-chat] {json.dumps(res)}")
    engine = weakref.ref(eng)
    del eng, server
    check_released(engine, threads, "[api-chat]")
    torch.cuda.empty_cache()
    return res


PP_CONFIG_NEW_TOKENS = 32  # cut from 64 to keep the script inside its time limit
# the depth of [pp-config]'s and [tp-config]'s 70B (32 of the published 80)
# and of [offload-config]'s (16 cached + 8 streamed), so that the whole
# script, with the Gemma2, MoE and tensor-parallel phases, stays inside its
# time limit
PP_CONFIG_LAYERS, OFFLOAD_CONFIG_LAYERS = 32, 24
# the decode-only profiles of [pp-config]: tokens of the graphed and of the stepwise loop
PP_PROFILE_TOKENS, PP_PROFILE_STEPWISE_TOKENS = 8, 3


def decode_profile(torch, eng, prompt, tag, decode, attempts=None):
    """A profile of a decode loop alone: the prompt prefilled outside the
    window, then decode(eng), which returns its steps, profiled (host ops
    and busy ms a step are the decode's); the engine reset after."""
    check(eng._prefill(prompt), f"{tag} prefill refused")
    prof, _ = profile_window(torch, tag, lambda: decode(eng), lambda steps: steps, attempts)
    eng.reset()
    check(prof is not None, f"{tag}: the kernels' launches were not traced")
    return prof


def pp_config_phase(torch, dev, ckpt, prompt):
    """configs/chat_config_70b_awq_pp4.json as shipped (pipeline_parallel 4,
    temperature 0.6, top-p 0.9, repetition penalty 1.05, top-k 32, 24x6 tree,
    max_length 8192) through AutoEngine -> initialize -> generate(). `model` is
    build_70b's staged random 70B (4 stages: on cuda:0..3 where there are 4
    cards, else all on this card); `draft_model` is the synthetic
    Meta-Llama-3.1-8B-Instruct-AWQ-INT4 directory written above, the format of
    the config's own draft. TTFT of a PROMPT_LEN prompt, then
    PP_CONFIG_NEW_TOKENS new tokens on the device-resident loop (the step
    captured as CUDA graphs) and again on the stepwise loop from the same
    generator state, which must give the same tokens: step ms, tok/s,
    accept, peak device memory, launches per step, capture ms, graph pool GB
    by device and segments a step. Each loop's decode is profiled alone
    ([pp-profile]: PP_PROFILE_TOKENS tokens graphed; [pp-profile-stepwise]:
    PP_PROFILE_STEPWISE_TOKENS stepwise): host ops a decode step (the
    graphed loop's must be under a tenth of the stepwise loop's), idle share
    and busy ms a step, traced launches equal to the counted ones."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    cards = range(torch.cuda.device_count())
    torch.cuda.synchronize()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    base = sum(torch.cuda.memory_allocated(c) for c in cards)
    t0 = time.time()
    cfg = shipped_config("chat_config_70b_awq_pp4.json", ckpt)
    target = build_70b(torch, dev, stage_devices(torch, dev), cfg["max_length"])
    torch.cuda.synchronize()
    build_s = time.time() - t0
    cfg.update(model=target, draft_model=ckpt["dirs"]["target"])
    del target
    t0 = time.time()
    eng = AutoEngine.from_config(device=dev, **cfg)
    eng.initialize()
    torch.cuda.synchronize()
    init_s = time.time() - t0
    resident_gb = (sum(torch.cuda.memory_allocated(c) for c in cards) - base) / 2**30
    stages = eng.target_model.stage_devices
    check(len(stages) == PP_STAGES and eng.pipeline_parallel == PP_STAGES
          and (eng.temperature, eng.topp, eng.repetition_penalty) == (0.6, 0.9, 1.05),
          "[pp-config] the engine did not take the config as shipped")
    check(eng._can_decode_fused(), "[pp-config] the staged engine does not take the "
          "device-resident loop")
    eng.generate(input_ids=prompt, max_new_tokens=8)  # warm-up: captures the step
    (graph,) = eng._decode_graphs.values()
    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.time()
    check(eng._prefill(prompt), "[pp-config] prefill refused")
    torch.cuda.synchronize()
    ttft_ms = 1000 * (time.time() - t1)
    prefill_counts = launch_counts()
    eng.reset()
    runs, state, eos = {}, eng._gen.get_state(), set(eng.eos_token_ids)
    for loop in ("graphed", "stepwise"):
        (graphed if loop == "graphed" else stepwise)(eng)
        eng._gen.set_state(state)
        reset_launch_counts()
        replays = graph.replays
        out = eng.generate(input_ids=prompt, max_new_tokens=PP_CONFIG_NEW_TOKENS)
        counts = launch_counts()
        toks = out["generated_tokens"]
        steps = request_steps(out)
        runs[loop] = dict(tokens=len(toks), steps=steps,
                          tok_per_s=1000.0 / out["time_per_output_token"],
                          decode_step_ms=out["time_per_output_token"] * len(toks) / steps,
                          avg_accept_tokens=out["avg_accept_tokens"],
                          replays=graph.replays - replays, launches=counts,
                          launches_per_step={k: (counts[k] - prefill_counts[k]) / steps
                                             for k in counts})
        runs.setdefault("tokens", {})[loop] = toks
        check(len(toks) >= PP_CONFIG_NEW_TOKENS or toks[-1] in eos,
              f"[pp-config] {loop} stopped early: {len(toks)}")
    graphed(eng)
    toks = runs.pop("tokens")
    g, sw = runs["graphed"], runs["stepwise"]
    check(toks["graphed"] == toks["stepwise"],
          f"[pp-config] graphed {toks['graphed']} vs stepwise {toks['stepwise']}")
    check(g["replays"] >= g["steps"] > 0 and sw["replays"] == 0,
          f"[pp-config] graphed {g['replays']} replays, stepwise {sw['replays']}")
    check(all(0 <= t < CFG_70B["vocab_size"] for t in toks["graphed"]),
          "[pp-config] token out of range")
    counts = g["launches"]
    for name in ("embed_gather", "attend_flash", "w4a16_matmul", "w4a16_matmul_layered"):
        check(counts[name] > 0, f"[pp-config] kernel {name} was never launched")
    check_tc_route(counts, "[pp-config]")
    products = 4 * PP_CONFIG_LAYERS
    check(graph.launches["w4a16_matmul_layered"] == products
          and sw["launches_per_step"]["w4a16_matmul_layered"] == products
          and prefill_counts["w4a16_matmul_layered"] == products,
          f"[pp-config] {graph.launches['w4a16_matmul_layered']} layered launches a captured "
          f"step, {sw['launches_per_step']['w4a16_matmul_layered']} a stepwise one, "
          f"{prefill_counts['w4a16_matmul_layered']} in the prefill; want {products}")
    check(all(sw["launches_per_step"][k] == graph.launches[k] for k in graph.launches),
          f"[pp-config] launches a step: stepwise {sw['launches_per_step']}, captured "
          f"{graph.launches}")
    g["profile"] = decode_profile(torch, eng, prompt, "[pp-profile]",
                                  lambda e: e._decode_fused(PP_PROFILE_TOKENS))
    stepwise(eng)
    sw["profile"] = decode_profile(torch, eng, prompt, "[pp-profile-stepwise]",
                                   lambda e: e._decode_stepwise(PP_PROFILE_STEPWISE_TOKENS))
    graphed(eng)
    host_ops = {k: r["profile"]["host_ops_per_step"] for k, r in runs.items()}
    check(10 * host_ops["graphed"] < host_ops["stepwise"],
          f"[pp-config] host ops a decode step, graphed {host_ops['graphed']} against stepwise "
          f"{host_ops['stepwise']}: not under a tenth")
    stats = graph_stats(eng)
    res = dict(stage_devices=[str(d) for d in stages], distinct_cards=len(set(stages)),
               draft_layers=eng.draft_model.args.n_layers, tokens=g["tokens"], steps=g["steps"],
               tok_per_s=g["tok_per_s"], decode_step_ms=g["decode_step_ms"],
               avg_accept_tokens=g["avg_accept_tokens"], ttft_ms_prefill128=ttft_ms,
               build_and_stage_s=build_s, init_s=init_s, resident_gb=resident_gb,
               peak_mem_gb=(sum(torch.cuda.max_memory_allocated(c) for c in cards) - base)
               / 2**30, launches=counts, launches_per_step=graph.launches,
               graphed_equal_stepwise=True, capture_ms=graph.capture_ms,
               pool_gb_by_device=stats["pool_gb_by_device"], segments=graph.segments,
               plan=[(str(d), eager, list(names), list(hops)) for d, eager, names, hops
                     in graph.plan],
               graphed=g, stepwise=sw, profile=g["profile"],
               launches_traced=g["profile"]["launches_traced"])
    log(f"[pp-config] {json.dumps(res)}")
    del eng
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- tensor parallelism

TP_SHARDS = 4  # chat_config_70b_awq_pod.json's tensor_parallel
TP_LOSSLESS_LAYERS, TP_DENSE_LAYERS = 8, 4
TP_CONFIG_NEW_TOKENS = 32  # cut from 64 to keep the script inside its time limit
TP_SERVE_TOKENS = 32
# the port's __global__ kernels (TRACED_KERNELS' names): those a sharded
# forward runs on each shard's card
PORT_KERNEL_NAMES = ("w4a16_kernel", "flash_tc_kernel", "flash_attend_kernel", "gather_rows")


def tp_target(torch, dev, cfg, dtype, seed, max_length, damp_from=None):
    """A random AWQ llama at `cfg`'s widths in the tensor-parallel layout
    (q/k/v and gate/up quantized apart), its dense head untied, built on
    `dev`; wo/down scales x0.05 from layer `damp_from` on."""
    from umbrella_tpu_torch.models.auto_model import ModelRuntime, random_awq_runtime

    params = random_awq_runtime(cfg, max_length, dtype=dtype, seed=seed, packed=False,
                                device=dev).params
    if damp_from is not None:
        params = dict(params, layers=damp_tail(params["layers"], damp_from))
    return ModelRuntime(cfg, params, max_length, dtype=dtype, device=dev)


def tp_copy(torch, rt, devices):
    """A runtime over `rt`'s weights sharded by shard_runtime over `devices`
    (rt itself unsharded)."""
    from umbrella_tpu_torch.models.auto_model import ModelRuntime
    from umbrella_tpu_torch.parallel.mesh import shard_runtime

    copy = ModelRuntime(rt.cfg, dict(rt.params), rt.max_length, dtype=rt.dtype,
                        family=rt.family, n_layers=rt.args.n_layers, device=rt.device)
    return shard_runtime(copy, devices)


def across_cards(torch):
    """TP_SHARDS distinct cards, or None on a host with fewer."""
    if torch.cuda.device_count() < TP_SHARDS:
        return None
    return [torch.device("cuda", i) for i in range(TP_SHARDS)]


def kernels_by_card(torch, fn):
    """fn() under torch.profiler: each card's device kernels in the trace,
    in all and the port's own (PORT_KERNEL_NAMES). The profiler may drop a
    prefix of the records: a card with none kept reads 0."""
    from torch.profiler import ProfilerActivity, profile

    for c in range(torch.cuda.device_count()):
        torch.cuda.synchronize(c)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        for c in range(torch.cuda.device_count()):
            torch.cuda.synchronize(c)
    cards = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            card = cards.setdefault(str(e.device_index), dict(kernels=0, port=0))
            card["kernels"] += 1
            card["port"] += any(p in e.name for p in PORT_KERNEL_NAMES)
    return cards


def check_every_card(cards, devices, key, tag):
    """Every card of `devices` ran kernels (`key`: "port" or "kernels")."""
    check(all(cards.get(str(d.index), {}).get(key, 0) > 0 for d in devices),
          f"{tag} not every card ran {key}: {cards}")


def small_draft(torch, dev, dtype, max_length):
    """A random dense draft at Llama-3.2-1B's widths and 2 layers, independent
    of the target."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import random_runtime

    cfg = ModelConfig(**dict(CFG_1B, num_hidden_layers=2, max_position_embeddings=max_length))
    return random_runtime(cfg, max_length, dtype=dtype, seed=7, device=dev)


def tp_dense_target(torch, dev, cfg, seed, max_length):
    """A random fp32 dense llama at `cfg`'s widths, q/k/v and gate/up apart
    (no W4 weight: every product stays in fp32)."""
    from umbrella_tpu_torch.models.auto_model import ModelRuntime
    from umbrella_tpu_torch.models.llama import init_llama_params

    params = init_llama_params(cfg, torch.Generator(device=dev).manual_seed(seed), max_length,
                               torch.float32, packed=False, device=dev)
    return ModelRuntime(cfg, params, max_length, dtype=torch.float32, device=dev)


def tp_mirror(torch, sharded):
    """A runtime that computes the unsharded forward over a tensor-parallel
    runtime's own shard weights, on its card: one KV cache over every kv
    head, each attention over every head, the residual and norms as
    unsharded, and each product as the shards compute it -- a column
    entry's shard products side by side, a row entry's K-block partials in
    fp32 added in shard order and rounded once, an untied head's vocab
    shards side by side. Written here, apart from parallel/mesh.py and
    parallel/collectives.py, so that a fault in the sharded forward's KV,
    attention, broadcasts or collectives parts its logits from the mirror's;
    the W4A16 kernel splits K by the shard's N and K, so only a forward
    built from the same products can be held to the sharded one bit for
    bit."""
    from umbrella_tpu_torch.models.auto_model import ModelRuntime
    from umbrella_tpu_torch.models.llama import (_linear, cache_attend_fn, kv_limit_of,
                                                 lm_head_logits)
    from umbrella_tpu_torch.ops.norms import rms_norm
    from umbrella_tpu_torch.ops.select import embed_lookup
    from umbrella_tpu_torch.quantization.awq import AwqTensor, awq_matmul

    shards = sharded.params["tp_shards"]
    args = sharded.args
    a8 = args.awq_act_int8

    def cols(x, lws, key, bias=None):
        return torch.cat([_linear(x, lw[key], lw.get(bias) if bias else None, act_int8=a8)
                          for lw in lws], dim=-1)

    def rows(x, lws, key):
        total = None
        for b, lw in zip(x.chunk(len(lws), dim=-1), lws):
            b, w = b.contiguous(), lw[key]
            part = (awq_matmul(b, w, out_dtype=torch.float32, act_int8=a8)
                    if isinstance(w, AwqTensor) else b.float() @ w.float())
            total = part if total is None else total + part
        return total.to(x.dtype)

    def fwd(params, kv, input_ids, position_ids, attn_mask, write_offset):
        limit = kv_limit_of(write_offset, input_ids.shape[0], kv)
        hidden = embed_lookup(params["embed"], input_ids, params["final_norm"].dtype)
        for i in range(args.n_layers):
            lw0 = {k: v[i] for k, v in params["layers"].items()}
            lws = [{k: v[i] for k, v in sh.layers.items()} for sh in shards]
            attend = cache_attend_fn(args, kv, i, position_ids, attn_mask, write_offset,
                                     params["rope_inv_freq"], params["rope_scale"], limit)
            x = rms_norm(hidden, lw0["input_norm"], args.rms_eps)
            out = attend(cols(x, lws, "wq", "bq"), cols(x, lws, "wk", "bk"),
                         cols(x, lws, "wv", "bv"))
            hidden = hidden + rows(out, lws, "wo")
            x = rms_norm(hidden, lw0["post_norm"], args.rms_eps)
            hidden = hidden + rows(torch.nn.functional.silu(cols(x, lws, "gate"))
                                   * cols(x, lws, "up"), lws, "down")
        x = rms_norm(hidden, params["final_norm"], args.rms_eps)
        if shards[0].lm_head is None:
            return lm_head_logits(params, x), kv
        return torch.cat([lm_head_logits({"lm_head": sh.lm_head}, x) for sh in shards],
                         dim=-1), kv

    class Mirror(ModelRuntime):
        @property
        def forward(self):
            return fwd

    params = {k: v for k, v in sharded.params.items() if k != "tp_shards"}
    return Mirror(sharded.cfg, params, sharded.max_length, dtype=sharded.dtype,
                  n_layers=args.n_layers, device=sharded.device)


def tp_layout_equal(torch, sharded, whole):
    """Whether the shards reassemble the unsharded weights bit for bit: each
    column entry's shards (w8, scales, zeros; or the dense columns) side by
    side, each row entry's shards dequantized (the repacked bytes) one
    above the other, the head's vocab shards side by side; every layer."""
    from umbrella_tpu_torch.quantization.awq import AwqTensor, dequantize

    shards, layers = sharded.params["tp_shards"], whole.params["layers"]
    same = True
    for k, v in layers.items():
        if k not in shards[0].layers:
            continue
        for i in range(len(v) if isinstance(v, tuple) else v.shape[0]):
            pieces = [sh.layers[k][i] for sh in shards]
            if not isinstance(v[i], AwqTensor):
                same &= torch.equal(torch.cat(pieces, dim=0 if k in ("wo", "down") else -1),
                                    v[i])
            elif k in ("wo", "down"):
                same &= torch.equal(torch.cat([dequantize(q, torch.float32) for q in pieces]),
                                    dequantize(v[i], torch.float32))
            else:
                same &= all(torch.equal(torch.cat([q[f] for q in pieces], dim=-1), v[i][f])
                            for f in range(len(v[i])))
    head = whole.params.get("lm_head")
    if head is not None:
        same &= torch.equal(torch.cat([sh.lm_head for sh in shards], dim=-1), head)
    return bool(same)


def planted_all_reduce(torch, fault):
    """A faulty all_reduce for the controls: "bf16_per_add" rounds the
    running sum to bf16 after each add, "dropped_partial" leaves out the
    last shard's partial."""
    def all_reduce(partials, device, dtype, span=None):
        if span is not None:
            partials = span.gather(partials, device)
        if fault == "dropped_partial":
            partials = partials[:-1]
        total = partials[0].to(device).float()
        for p in partials[1:]:
            total = total + p.to(device).float()
            if fault == "bf16_per_add":
                total = total.to(torch.bfloat16).float()
        return total.to(dtype)

    return all_reduce


def tp_logits_against_mirror(torch, sharded, mirror, ids):
    """`ids` through the sharded forward and the mirror's, eagerly, each on a
    fresh cache: whether their fp32 logits are the same bits, and the same
    with each planted all_reduce fault in the sharded forward (controls:
    each must part from the mirror), with the largest difference."""
    import umbrella_tpu_torch.parallel.mesh as mesh
    from umbrella_tpu_torch.ops.masks import causal_mask_rows

    dev, S = mirror.device, len(ids)
    args = (torch.tensor(ids, device=dev), torch.arange(S, device=dev),
            causal_mask_rows(0, S, MAX_LEN, device=dev), 0)
    want = mirror.forward(mirror.params, mirror.init_kv(), *args)[0]

    def against(label):
        got = sharded.forward(sharded.params, sharded.init_kv(), *args)[0]
        return label, dict(equal=torch.equal(got, want),
                           max_abs_diff=float((got - want).abs().max()))

    out = dict([against("sharded")])
    real = mesh.all_reduce
    try:
        for fault in ("bf16_per_add", "dropped_partial"):
            mesh.all_reduce = planted_all_reduce(torch, fault)
            out.update([against(fault)])
    finally:
        mesh.all_reduce = real
    out["max_abs_logit"] = float(want.abs().max())
    return out


def tp_lossless_check(torch, dev, prompt):
    """Full Llama-3.3-70B width, a separate small draft (small_draft), the
    target sharded by shard_runtime over TP_SHARDS shards on this card and
    run through tensor_parallel on the graphed loop (one segment a step).
    Three cases: TP_DENSE_LAYERS dense fp32 layers, and TP_LOSSLESS_LAYERS
    random AWQ layers in the tensor-parallel layout in fp32 and in bf16.
    In each, generate() of LOSSLESS_NEW_TOKENS tokens must equal the AR
    decode over the same sharded target exactly (the same forward; the
    witness: layer 0's KV rows of the two decodes bit for bit the same,
    where the W4A16 kernel computes them: cuBLAS's dense fp32 products are
    not row-invariant).
    Against the unsharded model: the dense fp32 case must give the
    unsharded engine's and AR decode's tokens exactly (every product stays
    in fp32; only the summation order differs). The W4A16 kernel splits K by
    its weight's N and K and rounds its input to bf16, so an AWQ shard's
    products are not the unsharded entry's last bits, and the later layers
    carry a last-bit difference on as bf16 steps: the AWQ cases are held,
    in fp32 and bf16 alike, to tp_mirror -- the unsharded forward over the
    same products -- whose engine's tokens the sharded engine must give
    exactly and whose logits on the prompt the sharded forward must give
    bit for bit; the shards must reassemble the unsharded weights bit for
    bit (tp_layout_equal); and two planted all_reduce faults (a sum rounded
    to bf16 after each add, a dropped partial) must part the logits from
    the mirror's. Where the AWQ decode parts from the unsharded engine's,
    the place and the unsharded AR's logit gap there are reported.
    On a host with TP_SHARDS cards the same weights sharded one a card must
    give the one-card tokens exactly (the collectives sum in one order
    wherever the shards are) and run the port's kernels on every card."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    tag = "[tp-lossless]"
    P, N, res = len(prompt), LOSSLESS_NEW_TOKENS, {}
    for case, dtype, layers in (("fp32-dense", torch.float32, TP_DENSE_LAYERS),
                                ("fp32", torch.float32, TP_LOSSLESS_LAYERS),
                                ("bf16", torch.bfloat16, TP_LOSSLESS_LAYERS)):
        target = draft = one = None
        torch.cuda.empty_cache()
        cfg = ModelConfig(**dict(CFG_70B, num_hidden_layers=layers,
                                 max_position_embeddings=MAX_LEN))
        dense = case == "fp32-dense"
        target = (tp_dense_target(torch, dev, cfg, 3, MAX_LEN) if dense
                  else tp_target(torch, dev, cfg, dtype, 3, MAX_LEN))
        draft = small_draft(torch, dev, dtype, MAX_LEN)
        one = tp_copy(torch, target, [dev] * TP_SHARDS)
        eng = make_engine(torch, dev, one, draft, dtype, tensor_parallel=TP_SHARDS)
        kept = keep_target_kv(eng)
        reset_launch_counts()
        out = eng.generate(input_ids=prompt, max_new_tokens=N)
        counts = launch_counts()
        graphs = check_graphed(eng, f"{tag} {case}")
        segments = eng._decode_graphs[(True, eng.topk, False)].segments
        del eng
        # keep_target_kv's patch ties the engine in a cycle: free its graphs
        # now, not by a collection inside a later capture (which fails it)
        gc.collect()
        toks = out["generated_tokens"]
        unsharded = make_engine(torch, dev, target, draft, dtype).generate(
            input_ids=prompt, max_new_tokens=N)["generated_tokens"]
        ar, _, _, _, ar_kv = greedy_ar_decode(torch, one, prompt, len(toks), keep_kv=True)
        ar_u, gaps, runner_ups, scales = greedy_ar_decode(torch, target, prompt, len(toks))
        same_ar, same_u = first_difference(toks, ar), first_difference(toks, unsharded)
        j = first_difference(toks, ar_u)
        n = P + min(same_ar, len(ar) - 1, len(toks) - 1)
        witness = kv_witness(torch, kv_rows(torch, kept["kv"], n), kv_rows(torch, ar_kv, n))
        del kept, ar_kv
        r = dict(case=case, layers=layers, tokens=len(toks), identical_to_sharded_ar=same_ar,
                 identical_to_unsharded=same_u, identical_to_unsharded_ar=j,
                 avg_accept_tokens=out["avg_accept_tokens"], kv_witness=witness,
                 segments=segments, launches=counts, graphs=graphs,
                 step_ms=out["time_per_output_token"] * len(toks) / request_steps(out))
        parted = j < min(len(toks), N)
        if parted:
            r["unsharded_ar_at_first_difference"] = dict(
                gap=gaps[j], ar_max_abs_logit=scales[j], near_tie=NEAR_TIE * scales[j],
                tp_token=toks[j], ar_top1=ar_u[j], ar_top2=runner_ups[j])
        if not dense:
            mirror = tp_mirror(torch, one)
            r["mirror"] = dict(
                identical=first_difference(toks, make_engine(torch, dev, mirror, draft, dtype)
                                           .generate(input_ids=prompt, max_new_tokens=N)
                                           ["generated_tokens"]),
                layout_equal=tp_layout_equal(torch, one, target),
                logits=tp_logits_against_mirror(torch, one, mirror, prompt))
            del mirror
        cards = across_cards(torch)
        if cards is not None:
            across = tp_copy(torch, target, cards)
            eng4 = make_engine(torch, dev, across, draft, dtype, tensor_parallel=TP_SHARDS)
            r["four_cards"] = dict(by_card=kernels_by_card(torch, lambda: eng4.generate(
                input_ids=prompt, max_new_tokens=8)))
            out4 = eng4.generate(input_ids=prompt, max_new_tokens=N)
            g4 = eng4._decode_graphs[(True, eng4.topk, False)]
            r["four_cards"].update(
                identical_to_one_card=first_difference(out4["generated_tokens"], toks),
                segments=g4.segments, plan=[(str(d), e, list(p)) for d, e, p, _ in g4.plan],
                step_ms=out4["time_per_output_token"] * len(out4["generated_tokens"])
                / request_steps(out4))
            del eng4, across
        log(f"{tag} {json.dumps(r)}")
        check(len(toks) >= N, f"{tag} {case}: too few tokens")
        check(same_ar >= N, f"{tag} {case}: spec {toks} vs AR over the sharded target {ar}")
        # cuBLAS's fp32 products are not row-invariant; the W4A16 kernel's are
        check(witness["layer0_equal"] or dense, f"{tag} {case}: layer 0's KV "
              "rows differ between the spec and the AR decode over the sharded target")
        check(segments == 1, f"{tag} {case}: {segments} segments a step on one card")
        if dense:
            check(same_u >= N and not parted,
                  f"{tag} {case}: sharded {toks} vs unsharded {unsharded} / AR {ar_u}")
        else:
            mr = r["mirror"]
            check(mr["layout_equal"], f"{tag} {case}: the shards do not reassemble the "
                  "unsharded weights")
            check(mr["logits"]["sharded"]["equal"], f"{tag} {case}: the sharded forward's "
                  f"logits are not the mirror's: {mr['logits']}")
            check(mr["identical"] >= N, f"{tag} {case}: sharded {toks} parts from the mirror "
                  f"at {mr['identical']}")
            check(not any(mr["logits"][f]["equal"] for f in ("bf16_per_add", "dropped_partial")),
                  f"{tag} {case}: a planted all_reduce fault kept the mirror's logits: "
                  f"{mr['logits']}")
        if cards is not None:
            check(r["four_cards"]["identical_to_one_card"] >= N,
                  f"{tag} {case}: four cards part from one card: {r['four_cards']}")
            check_every_card(r["four_cards"]["by_card"], cards, "port", f"{tag} {case}")
        for name in ("attend_flash", "embed_gather") + (() if dense else ("w4a16_matmul",)):
            check(counts[name] > 0, f"{tag} {case}: kernel {name} was never launched")
        res[case] = r
    return res


def build_70b_tp(torch, dev, devices, max_length):
    """A random AWQ Llama-3.3-70B at full widths and PP_CONFIG_LAYERS of its 80
    layers in the tensor-parallel layout (g128, bf16, dense untied head,
    tail wo/down scales x0.05 from layer 3 on), built on `dev` and sharded
    by shard_runtime over `devices` (row entries repacked and every entry
    cut a layer at a time, each per-layer tensor released as it is cut)."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.parallel.mesh import shard_runtime

    cfg = ModelConfig(**dict(CFG_70B, num_hidden_layers=PP_CONFIG_LAYERS))
    return shard_runtime(tp_target(torch, dev, cfg, torch.bfloat16, 4, max_length, damp_from=3),
                         devices)


def host_check_cost(torch, rt, rows, rounds=3):
    """What the host-read check costs an eager forward: wall ms of `rt`'s
    forward over `rows` rows from slot 0 on a fresh cache, every card
    synchronized before and after, run bare and inside
    cuda_graphs.no_host_sync (a torch function mode, which takes every torch
    call made inside it), in turn after one warm-up each; the least of
    `rounds` each, and the check's share of the checked time. A graphed
    step runs its eager segments (a forward across cards) bare."""
    from umbrella_tpu_torch.cuda_graphs import no_host_sync
    from umbrella_tpu_torch.ops.masks import causal_mask_rows

    dev, kv = rt.device, rt.init_kv()
    args = (torch.arange(rows, device=dev), torch.arange(rows, device=dev),
            causal_mask_rows(0, rows, rt.max_length, device=dev), 0)

    def timed(checked):
        for c in range(torch.cuda.device_count()):
            torch.cuda.synchronize(c)
        t0 = time.perf_counter()
        with no_host_sync() if checked else contextlib.nullcontext():
            rt.forward(rt.params, kv, *args)
        for c in range(torch.cuda.device_count()):
            torch.cuda.synchronize(c)
        return 1000 * (time.perf_counter() - t0)

    ms = {False: [], True: []}
    for checked in (False, True) + (False, True, True, False) * rounds:
        ms[checked].append(timed(checked))
    del kv
    bare, checked = min(ms[False][1:]), min(ms[True][1:])
    return dict(rows=rows, bare_ms=bare, checked_ms=checked, check_share=1 - bare / checked)


def tp_config_phase(torch, dev, ckpt, prompt):
    """configs/chat_config_70b_awq_pod.json as shipped (tensor_parallel 4,
    static 24x6, temperature 0.6, top-p 0.9, repetition penalty 1.05,
    max_length 8192) through AutoEngine -> initialize -> generate(). `model` is
    build_70b_tp's sharded random 70B (4 shards: on cuda:0..3 where there
    are 4 cards, else all on this card); `draft_model` the synthetic
    Meta-Llama-3.1-8B-Instruct-AWQ-INT4 directory written above (the
    config's own draft), whole on this card. TTFT of a PROMPT_LEN prompt; a
    sampled request of TP_CONFIG_NEW_TOKENS graphed and its first tokens
    stepwise from the same generator state (equal), and a greedy one; both
    guarded against degenerate decodes; the greedy decode profiled alone
    ([tp-profile]: busy ms and idle share a step, host ops a step); peak and
    pool GB, segments a step, kernels launched; on four cards, the port's
    kernels on every card."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    tag = "[tp-config]"
    cards = range(torch.cuda.device_count())
    torch.cuda.synchronize()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    base = sum(torch.cuda.memory_allocated(c) for c in cards)
    devices = stage_devices(torch, dev)
    cfg = shipped_config("chat_config_70b_awq_pod.json", ckpt)
    t0 = time.time()
    target = build_70b_tp(torch, dev, devices, cfg["max_length"])
    torch.cuda.synchronize()
    build_s = time.time() - t0
    cfg.update(model=target, draft_model=ckpt["dirs"]["target"])
    del target
    t0 = time.time()
    eng = AutoEngine.from_config(device=dev, **cfg)
    eng.initialize()
    torch.cuda.synchronize()
    init_s = time.time() - t0
    resident_gb = (sum(torch.cuda.memory_allocated(c) for c in cards) - base) / 2**30
    t = eng.target_model
    check(eng.tensor_parallel == TP_SHARDS and t.shard_devices == tuple(devices)
          and eng.draft_model.shard_devices is None and not cfg["offload"]
          and (eng.temperature, eng.topp, eng.repetition_penalty) == (0.6, 0.9, 1.05)
          and eng.tree_size == shipped_tree("sequoia_tree-24x6.json").size,
          f"{tag} the engine did not take the config as shipped")
    check(eng._can_decode_fused(), f"{tag} the sharded engine does not take the "
          "device-resident loop")
    warm_up(eng, prompt)
    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.time()
    check(eng._prefill(prompt), f"{tag} prefill refused")
    torch.cuda.synchronize()
    ttft_ms = 1000 * (time.time() - t1)
    prefill_counts = launch_counts()
    eng.reset()
    res = dict(shard_devices=[str(d) for d in devices], distinct_cards=len(set(devices)),
               target_layers=t.args.n_layers, draft_layers=eng.draft_model.args.n_layers,
               build_and_shard_s=build_s, init_s=init_s, resident_gb=resident_gb,
               ttft_ms_prefill128=ttft_ms, prefill_launches=prefill_counts)
    res["sampled"] = graphed_and_stepwise(
        torch, eng, f"{tag} sampled", input_ids=prompt, max_new_tokens=TP_CONFIG_NEW_TOKENS,
        temperature=0.6, topp=0.9, repetition_penalty=1.05)
    sampled = res["sampled"].pop("tokens")
    reset_launch_counts()
    out = eng.generate(input_ids=prompt, max_new_tokens=TP_CONFIG_NEW_TOKENS, temperature=0.0)
    counts = launch_counts()
    greedy = out["generated_tokens"]
    steps = request_steps(out)
    res["greedy"] = dict(tokens=len(greedy), steps=steps,
                         tok_per_s=1000.0 / out["time_per_output_token"],
                         decode_step_ms=out["time_per_output_token"] * len(greedy) / steps,
                         avg_accept_tokens=out["avg_accept_tokens"],
                         degenerate_guard=check_not_degenerate(
                             f"{tag} greedy", [(prompt, greedy)], out["avg_accept_tokens"],
                             eng.max_step_advance))
    check(all(0 <= x < CFG_70B["vocab_size"] for x in sampled + greedy),
          f"{tag} token out of range")
    for name in ("embed_gather", "attend_flash", "w4a16_matmul"):
        check(counts[name] > 0, f"{tag} kernel {name} was never launched")
    check_tc_route(counts, tag)
    res["host_check"] = host_check_cost(torch, t, eng.tree_size)
    graph = eng._decode_graphs[(True, eng.topk, abs(eng.repetition_penalty - 1.0) > 0.01)]
    res["profile"] = decode_profile(torch, eng, prompt, "[tp-profile]",
                                    lambda e: e._decode_fused(PP_PROFILE_TOKENS))
    if res["distinct_cards"] > 1:
        res["by_card"] = kernels_by_card(torch, lambda: eng.generate(
            input_ids=prompt, max_new_tokens=8, temperature=0.0))
        check_every_card(res["by_card"], devices, "port", tag)
    stats = graph_stats(eng)
    g = res["sampled"]["graphed"]
    res.update(tok_per_s=g["tok_per_s"], decode_step_ms=g["decode_step_ms"],
               avg_accept_tokens=g["avg_accept_tokens"], launches=counts,
               # the captured step's; across cards the eager forward's are not in it
               launches_per_step=graph.launches if res["distinct_cards"] == 1 else
               {k: n / steps for k, n in counts.items()}, segments=graph.segments,
               plan=[(str(d), e, list(p)) for d, e, p, _ in graph.plan],
               capture_ms=stats["capture_ms"], pool_gb_by_device=stats["pool_gb_by_device"],
               peak_mem_gb=(sum(torch.cuda.max_memory_allocated(c) for c in cards) - base)
               / 2**30)
    log(f"{tag} {json.dumps(res)}")
    del eng
    torch.cuda.empty_cache()
    return res


def tp_serve_phase(torch, dev):
    """The batched engine with tensor_parallel 4 (B=4, 3x4 tree, fp32): at 8B
    width over 4 random dense fp32 layers (every product in fp32, so only
    the summation order differs; the W4A16 kernel would round its input to
    bf16, [tp-lossless]), the draft its first 2 layers, run() of 6 requests
    of staggered prompt lengths gives the unsharded batched engine's tokens
    exactly; then a Gemma-2-9B-width runtime of 2 layers (its row partials
    summed before the post norms) the same way. On a host with TP_SHARDS
    cards the shards one a card give the one-card tokens, with the port's
    kernels on every card."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import early_exit_runtime
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    tag = "[tp-serve]"
    res = {}
    cards = across_cards(torch)
    llama = tp_dense_target(torch, dev, ModelConfig(**dict(CFG_8B, num_hidden_layers=4)), 5,
                            MAX_LEN)
    gemma = family_runtime(torch, dev, dict(GEMMA_9B_HF, num_hidden_layers=2), 63, torch.float32,
                           MAX_LEN, damp_from=1)
    for name, target, vocab, attn in (("llama", llama, CFG_8B["vocab_size"],
                                       "attend_flash_batched"),
                                      ("gemma2", gemma, GEMMA_9B_HF["vocab_size"],
                                       "attend_flash_batched")):
        draft = early_exit_runtime(target, target.args.n_layers // 2)
        reqs = [dict(r, input_ids=r["input_ids"][:PROMPT_LEN - PROMPT_LEN // 8 * i])
                for i, r in enumerate(family_requests(9, 6, TP_SERVE_TOKENS, vocab))]

        def run(rt, **kw):
            eng = batched_engine(torch, dev, rt, draft, 4, (3, 4), None, torch.float32, **kw)
            reset_launch_counts()
            outs = [o["generated_tokens"] for o in eng.run([dict(r) for r in reqs])]
            return eng, outs, launch_counts()

        eng, want, _ = run(target)
        del eng
        eng, got, counts = run(tp_copy(torch, target, [dev] * TP_SHARDS),
                               tensor_parallel=TP_SHARDS)
        r = dict(identical_prefix=[first_difference(a, b) for a, b in zip(got, want)],
                 graphs=check_graphed(eng, f"{tag} {name}"), launches=counts)
        del eng
        if cards is not None:
            eng4, got4, _ = run(tp_copy(torch, target, cards), tensor_parallel=TP_SHARDS)
            r["four_cards"] = dict(
                identical_to_one_card=[first_difference(a, b) for a, b in zip(got4, got)],
                by_card=kernels_by_card(torch, lambda: eng4.run([dict(q, max_new_tokens=8)
                                                                 for q in reqs[:4]])))
            del eng4
        log(f"{tag} {name} {json.dumps(r)}")
        check(got == want, f"{tag} {name}: sharded run() {r['identical_prefix']} vs unsharded")
        check(all(len(o) >= TP_SERVE_TOKENS for o in got), f"{tag} {name}: too few tokens")
        for k in (attn, "embed_gather"):
            check(counts[k] > 0, f"{tag} {name}: kernel {k} was never launched")
        if cards is not None:
            check(min(r["four_cards"]["identical_to_one_card"]) >= TP_SERVE_TOKENS,
                  f"{tag} {name}: four cards part from one card: {r['four_cards']}")
            check_every_card(r["four_cards"]["by_card"], cards, "port", f"{tag} {name}")
        res[name] = r
    return res


# the 70B's entries (whole K, whole N, row-parallel) whose shard of TP_SHARDS
# the tensor-parallel forward runs: wv's shard is wk's shape, up's gate's
TP_W4A16_SHAPES = {"wq": (8192, 8192, False), "wk": (8192, 1024, False),
                   "gate": (8192, 28672, False), "wo": (8192, 8192, True),
                   "down": (28672, 8192, True)}
TP_ROWS = (1, 24, 127, 300)


def tp_kernel_checks(torch, dev, gen, randn, err):
    """The kernels at the 70B's tensor-parallel shard shapes (TP_SHARDS
    shards; [tp-config]'s path). w4a16_matmul on shard 1 of each entry, cut
    from the whole quantized weight as shard_runtime cuts it (a row entry
    repacked first; the shard dequantizes to its block of the whole
    weight's rows or columns, bit for bit): the column shards wq [8192,2048],
    wk [8192,256] and gate [8192,7168] with bf16 out, the row shards wo
    [2048,8192] and down [7168,8192] with fp32 out (the partials that
    all_reduce sums); against the plain version (2**-7 / 1e-4 of max|plain|)
    at S=1, 24, 127 and 300, every S's rows bit for bit S=300's, timed at
    S=127 beside the bf16 matmul on the pre-dequantized shard and the bound.
    attend_flash at a shard's 70B verify: q [127,16,128] over 2 kv heads of
    an 8192-slot cache (24x6 tree at kv_limit 428), and rows of S=1, 24, 127
    bit for bit those of S=512 (causal)."""
    from umbrella_tpu_torch.ops.kernels.tree_attention import attend_flash
    from umbrella_tpu_torch.ops.kernels.w4a16 import (_dequant_halves_bf16, _plan, w4a16_matmul,
                                                      w4a16_matmul_ref)
    from umbrella_tpu_torch.ops.masks import causal_mask_rows, tree_mask_rows
    from umbrella_tpu_torch.parallel.mesh import _column, _rows
    from umbrella_tpu_torch.quantization.awq import (AwqTensor, quantize_pack_device,
                                                     repack_row_shards)
    from umbrella_tpu_torch.sequoia import growmap_from_spec

    bf16, f32 = torch.bfloat16, torch.float32
    shapes, e_max, e_rel = {}, 0.0, 0.0
    for name, (K, N, row) in TP_W4A16_SHAPES.items():
        q = quantize_pack_device(torch.randn((K, N), generator=gen, device=dev) * 0.02, 128, bf16)
        whole = _dequant_halves_bf16(q)
        if row:
            piece = _rows(repack_row_shards(q, TP_SHARDS), TP_SHARDS, 1)
        else:
            piece = _column(q, TP_SHARDS, 1)
        piece = AwqTensor(*(t.contiguous() for t in piece))
        k, n = piece.k, piece.n
        w_deq = _dequant_halves_bf16(piece)
        check(torch.equal(w_deq, whole[k:2 * k] if row else whole[:, n:2 * n]),
              f"w4a16 TP shard {name}: the shard is not its block of the whole weight")
        del q, whole
        od, tol = (f32, 1e-4) if row else (bf16, 2 ** -7)
        x_all = randn(TP_ROWS[-1], k)
        y_all = w4a16_matmul(x_all, piece, out_dtype=od)
        for S in TP_ROWS:
            x = x_all[:S].contiguous()
            got = w4a16_matmul(x, piece, out_dtype=od)
            e, m = err(got, w4a16_matmul_ref(x, piece, out_dtype=od))
            check(e <= tol * m, f"w4a16 TP shard {name} S={S}: err {e} vs max {m}")
            check(torch.equal(got, y_all[:S]), f"w4a16 TP shard {name}: rows of S={S} differ "
                  f"from S={TP_ROWS[-1]}'s")
            e_max, e_rel = max(e_max, e), max(e_rel, e / m)
        x = x_all[:127].contiguous()
        by, bb = w4a16_bound(k, n, 127, n * (2 if od == f32 else 1), k // 128)
        key = f"70B TP4 {name} [{k},{n}] S=127"
        shapes[key] = dict(out=str(od).split(".")[-1], splits=_plan(127, k, n, 1, 128)["splits"],
                           ms=cuda_ms(torch, lambda: w4a16_matmul(x, piece, out_dtype=od)),
                           plain_ms=cuda_ms(torch, lambda: w4a16_matmul_ref(x, piece,
                                                                            out_dtype=od),
                                            iters=5),
                           library_ms=cuda_ms(torch, lambda: torch.matmul(x, w_deq)),
                           bound_ms=by, bound_by=bb)
        log(f"[kernels] w4a16_matmul {key} {shapes[key]}")
        del piece, w_deq, x_all, y_all
    torch.cuda.empty_cache()
    gm = growmap_from_spec(24, 6, acc=ACC_24x6)
    nn, nH, KVH = 301, CFG_70B["num_attention_heads"] // TP_SHARDS, \
        CFG_70B["num_key_value_heads"] // TP_SHARDS
    attn = attention_at(torch, dev, randn, err, "70B TP4 verify", nH, KVH, 128, 8192,
                        tree_mask_rows(nn, torch.as_tensor(gm.bitmap, device=dev), 8192),
                        nn + gm.size)
    kc, vc, q = randn(1, KVH, 8192, 128), randn(1, KVH, 8192, 128), randn(512, nH, 128)
    mask = causal_mask_rows(nn, 512, 8192, device=dev)
    full = attend_flash(q, kc, vc, mask, nn + 512, 0)
    for S in (1, 24, 127):
        check(torch.equal(attend_flash(q[:S].contiguous(), kc, vc, mask[:S], nn + 512, 0),
                          full[:S]), f"attend_flash TP shard: rows of S={S} differ from S=512's")
    attn["rows_equal_across_S"] = True
    return dict(w4a16=shapes, w4a16_max_abs_err=e_max, w4a16_max_rel_err=e_rel,
                attention={"70B TP4 verify q [127,16,128]": attn})


# ---------------------------------------------------------------- the dynamic engine and offload

# configs/greedy_config_v5e.json's (and chat_config_v5e_16gb.json's) tree: 257 nodes
DYN_TREE = dict(width=16, num_beams=24, depth=16)
DYN_NEW_TOKENS = 12  # cut from 32, then 24, to keep the script inside its time limit
# meta-llama/Llama-3.2-1B-Instruct's config.json: the offload configs' draft
CFG_1B = {k: v for k, v in DRAFT_HF_CONFIG.items()
          if k not in ("architectures", "hidden_act", "torch_dtype", "bos_token_id")}
OFFLOAD_LOSSLESS_LAYERS, OFFLOAD_LOSSLESS_CACHED = 6, 2
OFFLOAD_CACHED = 16  # the offload configs' num_cache_layers, for the 8B directory
OFFLOAD_NEW_TOKENS = 16
# host memory kept free beside the pinned layers (the process, the draft
# directory's reads, the 8B checkpoint files)
HOST_RESERVE_BYTES = 24 * 2**30


def dynamic_engine(torch, dev, target, draft, dtype, **kw):
    """The dynamic engine (the default: no `engine` key) with the shipped
    configs' 16 x 16 tree of 24 beams."""
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine
    from umbrella_tpu_torch.speculation.dynamic_engine import DynamicEngine

    eng = AutoEngine.from_config(
        device=dev, model=target, draft_model=draft, max_length=kw.pop("max_length", MAX_LEN),
        temperature=0.0, eos_token_ids=kw.pop("eos_token_ids", [-100]), dtype=dtype,
        **dict(DYN_TREE, **kw))
    check(isinstance(eng, DynamicEngine), "from_config without an engine key: not dynamic")
    eng.initialize()
    return eng


def dynamic_bitmap(torch, dev, width, depth, seed):
    """The ancestor bitmap of a random dynamic tree as the engine builds one:
    each node of a level under a node of the level before, its row its
    parent's row and itself."""
    import numpy as np

    rng = np.random.default_rng(seed)
    T = width * depth + 1
    bm = np.eye(T, dtype=bool)
    for lvl in range(depth):
        lo, n_prev = (0, 1) if lvl == 0 else (1 + (lvl - 1) * width, width)
        for j in range(width):
            v = 1 + lvl * width + j
            bm[v] |= bm[lo + rng.integers(n_prev)]
    return torch.as_tensor(bm, device=dev)


def dynamic_lossless_check(torch, dev, prompt):
    """fp32, full 8B widths, 4 layers (as [lossless]): dynamic spec decode
    (graphed) and an offload target's pipelined decode (its draft phase and
    tail graphed, the streamed forward eager between them), static (24x6)
    and dynamic, over the same weights (2 layers resident, 2 streamed) must
    each equal the AR decode for LOSSLESS_NEW_TOKENS tokens."""
    from umbrella_tpu_torch.offload.streaming import OffloadModelRuntime
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    tag = "[dynamic-lossless]"
    target, draft = build_target(torch, dev, n_layers=4, exit_layer=2, dtype=torch.float32)
    off = OffloadModelRuntime.from_params(target.params, target.cfg, MAX_LEN, dtype=torch.float32,
                                          num_cache_layers=2, device=dev)
    check((off.n_resident, off.n_streamed) == (2, 2), f"{tag} offload split {off.n_resident}")
    res, decodes = {}, {}
    for name, (t, kind) in {"dynamic": (target, "dynamic"), "offload-static": (off, "static"),
                            "offload-dynamic": (off, "dynamic")}.items():
        eng = (dynamic_engine(torch, dev, t, draft, torch.float32) if kind == "dynamic"
               else make_engine(torch, dev, t, draft, torch.float32))
        check(eng._offload == (t is off) and eng._can_decode_fused() == (t is target),
              f"{tag} {name}: wrong decode loop")
        reset_launch_counts()
        out = eng.generate(input_ids=prompt, max_new_tokens=LOSSLESS_NEW_TOKENS)
        counts = launch_counts()
        decodes[name] = out["generated_tokens"]
        steps = request_steps(out)
        res[name] = dict(tokens=len(out["generated_tokens"]),
                         avg_accept_tokens=out["avg_accept_tokens"], launches=counts,
                         launches_per_step={k: n / steps for k, n in counts.items()})
        res[name]["graphs"] = check_graphed(eng, f"{tag} {name}")
        check(t is target or offload_plan(eng), f"{tag} {name}: not the offload step's plan")
        for k in ("attend_flash", "w4a16_matmul", "w4a8f_matmul", "embed_gather"):
            check(counts[k] > 0, f"{tag} {name}: kernel {k} was never launched")
        del eng
    n = max(len(v) for v in decodes.values())
    ar, gaps, _, _ = greedy_ar_decode(torch, target, prompt, n)
    for name, toks in decodes.items():
        same = first_difference(toks, ar)
        res[name].update(identical_prefix=same,
                         gap_at_first_difference=gaps[same] if same < len(toks) else None)
        check(len(toks) >= LOSSLESS_NEW_TOKENS and same >= LOSSLESS_NEW_TOKENS,
              f"{tag} {name} and the AR decode differ at token {same}: {toks} vs {ar}")
    log(f"{tag} {json.dumps(res)}")
    res["identical_prefix"] = min(r["identical_prefix"] for r in res.values())
    return res


def build_draft_1b(torch, dev, max_length):
    """A random bf16 draft at Llama-3.2-1B's widths (16 layers, tied head)."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import random_runtime

    return random_runtime(ModelConfig(**CFG_1B), max_length, dtype=torch.bfloat16, seed=5,
                          device=dev)


def dynamic_phase(torch, dev, prompt, target, draft):
    """The dynamic engine on the 8B AWQ target (32 layers, resident) with a
    random bf16 1B draft, the shipped configs' tree (16 x 16, 24 beams):
    greedy and stochastic (temperature 0.6, top-p 0.9, repetition penalty
    1.05). Graphed (the step replayed as a CUDA graph) and stepwise decodes
    from one seed give the same tokens; tok/s, step ms, accept; a profiled
    3-token request each (host ops a step, device idle share), whose traced
    launches a step equal the captured step's."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    res = {}
    for mode, sampling in (("greedy", {}), ("stochastic", dict(
            temperature=0.6, topp=0.9, repetition_penalty=1.05))):
        tag = f"[dynamic] {mode}"
        outs, r = {}, {}
        for loop in ("graphed", "stepwise"):
            eng = dynamic_engine(torch, dev, target, draft, torch.bfloat16, seed=11)
            if loop == "stepwise":
                stepwise(eng)
            reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.time()
            check(eng._prefill(prompt), f"{tag} prefill refused")
            torch.cuda.synchronize()
            ttft_ms = 1000 * (time.time() - t1)
            prefill_counts = launch_counts()
            eng.reset()
            reset_launch_counts()
            out = eng.generate(input_ids=prompt, max_new_tokens=DYN_NEW_TOKENS, **sampling)
            counts = launch_counts()
            toks = out["generated_tokens"]
            steps = request_steps(out)
            outs[loop] = toks
            r[loop] = dict(tokens=len(toks), steps=steps,
                           tok_per_s=1000.0 / out["time_per_output_token"],
                           decode_step_ms=out["time_per_output_token"] * len(toks) / steps,
                           avg_accept_tokens=out["avg_accept_tokens"], ttft_ms_prefill128=ttft_ms)
            if loop == "graphed":
                r[loop]["graphs"] = check_graphed(eng, tag)
                (graph,) = eng._decode_graphs.values()
                before = {}

                def request():  # the replays before each profiled window (the last counts)
                    before["replays"] = graph.replays
                    return eng.generate(input_ids=prompt, max_new_tokens=3, **sampling)

                # ~21,000 kernels a step: a window of 3 steps keeps the trace small (an
                # 8-step window, ~170,000 kernel records, lost ~100 of them in one run)
                prof, _ = profile_window(torch, f"[dynamic-profile] {mode}", request,
                                         request_steps)
                check(prof is not None, f"{tag}: the kernels' launches were not traced")
                replays = graph.replays - before["replays"]
                per_step = {k: (n - prefill_counts[k]) / replays
                            for k, n in prof["launches_traced"].items()}
                check(all(per_step[k] == graph.launches[k] for k in per_step),
                      f"{tag} launches a step traced {per_step}, captured {graph.launches}")
                r[loop].update(profile=prof, launches=counts, launches_per_step=graph.launches,
                               launches_per_step_traced=per_step, capture_ms=graph.capture_ms)
                for k in MAIN_KERNELS:
                    check(counts[k] > 0, f"{tag}: kernel {k} was never launched")
                check_tc_route(counts, tag)
            del eng
        check(outs["graphed"] == outs["stepwise"],
              f"{tag}: graphed {outs['graphed']} vs stepwise {outs['stepwise']}")
        check(len(outs["graphed"]) >= DYN_NEW_TOKENS
              and all(0 <= t < CFG_8B["vocab_size"] for t in outs["graphed"]),
              f"{tag}: {len(outs['graphed'])} tokens or a token out of range")
        r["graphed_equal_stepwise"] = True
        res[mode] = r
        log(f"{tag} {json.dumps(r)}")
    g = res["greedy"]["graphed"]
    res.update({k: g[k] for k in ("tok_per_s", "decode_step_ms", "avg_accept_tokens",
                                  "launches", "launches_per_step")})
    return res


def dynamic_pp_phase(torch, dev, prompt, draft):
    """The dynamic engine (the shipped offload configs' 16 x 16 tree of 24
    beams, greedy) over the [dynamic] path's 8B AWQ target staged in
    PP_STAGES stages (pipeline_parallel; one card a stage where there are 4,
    else all on this card) with the random 1B draft: DYN_NEW_TOKENS tokens on
    the device-resident loop (graphed), on the stepwise loop, and on the
    unstaged target (graphed), all equal. The target is random_awq_runtime's
    8B with [dynamic]'s damped tail and W4 head, without its Int4F shared
    prefix (staging takes AWQ and dense layers only)."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import ModelRuntime, random_awq_runtime
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.parallel.pipeline import shard_runtime_pp

    tag = "[dynamic-pp]"
    cfg = ModelConfig(**CFG_8B)
    params = random_awq_runtime(cfg, MAX_LEN, dtype=torch.bfloat16, seed=2,
                                quantize_lm_head=True, device=dev).params
    params = dict(params, layers=damp_tail(params["layers"], 3))
    unstaged = ModelRuntime(cfg, params, MAX_LEN, dtype=torch.bfloat16, device=dev)
    staged = shard_runtime_pp(ModelRuntime(cfg, dict(params), MAX_LEN, dtype=torch.bfloat16,
                                           device=dev), stage_devices(torch, dev))
    del params
    outs, res = {}, {}
    for name, target, loop in (("graphed", staged, graphed), ("stepwise", staged, stepwise),
                               ("unstaged", unstaged, graphed)):
        kw = dict(pipeline_parallel=PP_STAGES) if target is staged else {}
        eng = dynamic_engine(torch, dev, target, draft, torch.bfloat16, seed=11, **kw)
        check(eng._can_decode_fused(), f"{tag} {name}: not on the device-resident loop")
        loop(eng)
        reset_launch_counts()
        out = eng.generate(input_ids=prompt, max_new_tokens=DYN_NEW_TOKENS)
        counts = launch_counts()
        outs[name] = out["generated_tokens"]
        steps = request_steps(out)
        res[name] = dict(tokens=len(outs[name]), steps=steps,
                         tok_per_s=1000.0 / out["time_per_output_token"],
                         decode_step_ms=out["time_per_output_token"] * len(outs[name]) / steps,
                         avg_accept_tokens=out["avg_accept_tokens"])
        if loop is graphed:
            res[name]["graphs"] = check_graphed(eng, f"{tag} {name}")
            for k in ("embed_gather", "attend_flash", "w4a16_matmul"):
                check(counts[k] > 0, f"{tag} {name}: kernel {k} was never launched")
            check_tc_route(counts, f"{tag} {name}")
        if target is staged:
            check(counts["w4a16_matmul_layered"] > 0, f"{tag} {name}: the layered kernel was "
                  "never launched")
            res[name]["stages"] = [str(d) for d in eng.target_model.stage_devices]
        del eng
    for name in ("stepwise", "unstaged"):
        check(outs[name] == outs["graphed"], f"{tag} graphed {outs['graphed']} vs {name} "
              f"{outs[name]}")
    check(len(outs["graphed"]) >= DYN_NEW_TOKENS
          and all(0 <= t < CFG_8B["vocab_size"] for t in outs["graphed"]),
          f"{tag} {len(outs['graphed'])} tokens or a token out of range")
    res["graphed_equal_stepwise_and_unstaged"] = True
    log(f"{tag} {json.dumps(res)}")
    return res


def offload_lossless_check(torch, dev, prompt):
    """Full Llama-3.3-70B widths, OFFLOAD_LOSSLESS_LAYERS AWQ layers (tail damped
    from layer 2), bf16: the offload runtime over the same weights
    (OFFLOAD_LOSSLESS_CACHED layers resident, the rest streamed) gives the
    resident forward's logits bit for bit at a 128-token prefill and at the
    dynamic tree's 257-row verify, twice in a row; the dynamic engine over
    it (the pipelined loop: its step's draft phase and tail graphed, the
    streamed forward eager between them, and again with the whole step
    eager) commits the resident engine's (graphed) tokens with the target's
    2-layer early-exit draft."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import (ModelRuntime, early_exit_runtime,
                                                      random_awq_runtime)
    from umbrella_tpu_torch.offload.streaming import OffloadModelRuntime
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.ops.masks import causal_mask_rows, tree_mask_rows

    tag = "[offload-lossless]"
    cfg = ModelConfig(**dict(CFG_70B, num_hidden_layers=OFFLOAD_LOSSLESS_LAYERS))
    p = random_awq_runtime(cfg, MAX_LEN, dtype=torch.bfloat16, seed=6, device=dev).params
    resident = ModelRuntime(cfg, dict(p, layers=damp_tail(p["layers"], 2)), MAX_LEN,
                            dtype=torch.bfloat16, device=dev)
    del p
    off = OffloadModelRuntime.from_params(resident.params, cfg, MAX_LEN, dtype=torch.bfloat16,
                                          num_cache_layers=OFFLOAD_LOSSLESS_CACHED, device=dev)
    check(all(t.is_pinned() for lw in off.host_layers[OFFLOAD_LOSSLESS_CACHED:]
              for v in lw.values() for t in (v if isinstance(v, tuple) else (v,))),
          f"{tag} streamed layers not in pinned memory")
    T = DYN_TREE["width"] * DYN_TREE["depth"] + 1
    bm = dynamic_bitmap(torch, dev, DYN_TREE["width"], DYN_TREE["depth"], 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    res = {}
    for name, S, offset, mask in (
            ("prefill128", PROMPT_LEN, 0, causal_mask_rows(0, PROMPT_LEN, MAX_LEN, device=dev)),
            ("verify257", T, PROMPT_LEN, tree_mask_rows(PROMPT_LEN, bm, MAX_LEN))):
        ids = torch.randint(0, cfg.vocab_size, (S,), generator=gen, device=dev)
        pos = offset + torch.arange(S, device=dev)
        want, _ = resident.forward(resident.params, resident.init_kv(), ids, pos, mask, offset)
        reset_launch_counts()
        kv = off.init_kv()
        for _ in range(2):
            got, kv = off.streamed_forward(kv, ids, pos, mask,
                                           torch.tensor(offset, dtype=torch.int32, device=dev))
            check(torch.equal(got, want), f"{tag} {name}: streamed logits differ from resident: "
                  f"max abs diff {(got - want).abs().max().item()}")
        counts = launch_counts()
        res[name] = dict(rows=S, bit_equal=True, launches_two_forwards={
            k: counts[k] for k in ("embed_gather", "attend_flash", "w4a16_matmul")})
        check(counts["w4a16_matmul"] > 0 and counts["attend_flash"] > 0,
              f"{tag} {name}: kernels not launched")
    draft = early_exit_runtime(resident, 2)
    toks = {}
    for name, t, loop in (("resident", resident, graphed), ("offload", off, graphed),
                          ("offload-eager", off, stepwise)):
        eng = loop(dynamic_engine(torch, dev, t, draft, torch.bfloat16))
        out = eng.generate(input_ids=prompt, max_new_tokens=32)
        toks[name] = out["generated_tokens"]
        res[f"{name}_decode"] = dict(tokens=len(toks[name]),
                                     avg_accept_tokens=out["avg_accept_tokens"],
                                     ms_per_token=out["time_per_output_token"])
        if loop is graphed:
            res[f"{name}_decode"]["graphs"] = check_graphed(eng, f"{tag} {name}")
            check(t is resident or offload_plan(eng), f"{tag}: not the offload step's plan")
        else:
            check(graph_stats(eng)["graphs"] == 0, f"{tag} {name}: a graph was captured")
        graphed(eng)  # no bound method left to keep the engine in a cycle
        del eng
    same = min(first_difference(toks["resident"], toks[k]) for k in ("offload", "offload-eager"))
    res["decode_identical_prefix"] = same
    log(f"{tag} {json.dumps(res)}")
    check(len(toks["offload"]) >= 32 and toks["offload"] == toks["resident"]
          and toks["offload-eager"] == toks["resident"],
          f"{tag} offload (graphed, eager) and resident decodes differ at token {same}")
    return res


def host_available_bytes():
    """MemAvailable from /proc/meminfo."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def build_offload_70b(torch, dev, max_length, cached):
    """A random AWQ Llama-3.3-70B at full widths (g128, bf16 scales, bf16
    embedding and untied head; tail wo/down scales x0.05 from layer 3 on) as
    an OffloadModelRuntime with `cached` layers on the card: each layer
    is made on the card and a streamed one moved to pinned host memory before
    the next, so the model is never whole on the card. Depth:
    OFFLOAD_CONFIG_LAYERS of the 80 where MemAvailable, less
    HOST_RESERVE_BYTES, holds the streamed ones; fewer otherwise (the cut is
    reported)."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.offload.streaming import OffloadModelRuntime, map_layer, to_host
    from umbrella_tpu_torch.ops.rope import rope_params
    from umbrella_tpu_torch.quantization.awq import concat_awq, quantize_pack_device

    cfg = ModelConfig(**CFG_70B)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    D = cfg.resolved_head_dim
    Hq, KV = cfg.num_attention_heads * D, cfg.num_key_value_heads * D
    gen = torch.Generator(device=dev).manual_seed(7)

    def q(k_dim, n_dim, scale=1.0):
        parts = [quantize_pack_device(torch.randn((k_dim, min(8192, n_dim - n0)), generator=gen,
                                                  device=dev) * 0.02, 128, dtype=torch.bfloat16)
                 for n0 in range(0, n_dim, 8192)]
        t = parts[0] if len(parts) == 1 else concat_awq(parts)
        return t._replace(scales=t.scales * scale) if scale != 1.0 else t

    shapes = [(H, Hq + 2 * KV), (Hq, H), (H, 2 * I), (I, H)]
    layer_bytes = sum(k // 2 * n + 2 * (k // 128) * n * 2 for k, n in shapes) + 2 * H * 2
    avail = host_available_bytes()
    n_layers = min(OFFLOAD_CONFIG_LAYERS,
                   cached + max(0, (avail - HOST_RESERVE_BYTES) // layer_bytes))
    t0 = time.time()
    layers, pin = [], dev.type == "cuda"
    for i in range(n_layers):
        damp = 0.05 if i >= 3 else 1.0
        lw = {"input_norm": torch.ones(H, dtype=torch.bfloat16, device=dev),
              "post_norm": torch.ones(H, dtype=torch.bfloat16, device=dev),
              "wqkv": q(H, Hq + 2 * KV), "wo": q(Hq, H, damp), "gate_up": q(H, 2 * I),
              "down": q(I, H, damp)}
        layers.append(lw if i < cached else map_layer(lambda t: to_host(t, pin), lw))
        del lw
    top = {"embed": (torch.randn((V, H), generator=gen, device=dev) * 0.02).to(torch.bfloat16),
           "lm_head": (torch.randn((H, V), generator=gen, device=dev) * 0.02).to(torch.bfloat16),
           "final_norm": torch.ones(H, dtype=torch.bfloat16, device=dev),
           **rope_params(cfg, device=dev)}
    off = OffloadModelRuntime(cfg, top, layers, max_length, dtype=torch.bfloat16,
                              num_cache_layers=cached, device=dev)
    check(off.streamed_layer_bytes == layer_bytes,
          f"streamed layer {off.streamed_layer_bytes} bytes, expected {layer_bytes}")
    info = dict(n_layers=n_layers, published_layers=cfg.num_hidden_layers,
                n_resident=off.n_resident, n_streamed=off.n_streamed,
                streamed_layer_gb=layer_bytes / 1e9,
                pinned_host_gb=off.n_streamed * layer_bytes / 1e9,
                host_available_gb_before=avail / 1e9, build_s=time.time() - t0)
    return off, info


def h2d_overlap(device_records):
    """From a profiler trace's device records (read_trace): the host-to-device
    copies' total ms and the ms of them that overlap a kernel (any kernel but
    the pad), and their count."""
    h2d, kern = [], []
    for name, start, end, _ in device_records:
        if name.startswith("Memcpy HtoD"):
            h2d.append((start, end))
        elif not name.startswith(("Memcpy", "Memset")) and PAD_KERNEL not in name:
            kern.append((start, end))
    union = []
    for s, t in sorted(kern):
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], t)
        else:
            union.append([s, t])
    starts = [u[0] for u in union]
    overlapped = 0.0
    for s, t in h2d:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(union) and union[i][0] < t:
            overlapped += max(0.0, min(t, union[i][1]) - max(s, union[i][0]))
            i += 1
    return dict(h2d_copies=len(h2d), h2d_ms=sum(t - s for s, t in h2d) / 1000.0,
                h2d_overlapped_ms=overlapped / 1000.0)


def pipelined_steps(eng, max_new_tokens):
    """The offload engine's pipelined loop from its prefilled prompt; returns
    the steps it ran (the committed ones and the one in flight at the stop)."""
    before = eng.decode_stats["replays"]
    eng._decode_offload_pipelined(max_new_tokens)
    return eng.decode_stats["replays"] - before


def offload_config_phase(torch, dev, ckpt, prompt):
    """configs/greedy_config_v5e.json and configs/chat_config_v5e_16gb.json as
    shipped (offload, num_cache_layers 16, dynamic 16 x 16 tree of 24 beams,
    max_length 8192; greedy, and temperature 0.6 / top-p 0.9 / penalty 1.05),
    `model` the random offloaded 70B of build_offload_70b, `draft_model` the
    synthetic Llama-3.2-1B bf16 directory written above, through
    AutoEngine.from_config -> initialize -> generate(): one request of
    OFFLOAD_NEW_TOKENS new tokens each on the captured step (the draft phase
    and the tail as CUDA graphs, the streamed forward eager between them;
    TTFT, step ms, tok/s, accept, capture ms); for the greedy config, the
    same request with the whole step eager (the same tokens, its step ms),
    streamed_forward_traced at the 257-row verify (compute and exposed stream
    ms per layer, H2D GB/s per streamed layer), and 2 tokens of each loop's
    decode profiled alone (host ops a step; [offload-profile], the graphed
    one, whose host-to-device copies must overlap compute kernels, and
    [offload-profile-eager]); peak device GB and pinned host GB."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.ops.masks import tree_mask_rows
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine
    from umbrella_tpu_torch.speculation.dynamic_engine import DynamicEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    here = os.path.dirname(os.path.abspath(__file__))
    cfgs = {}
    for name in ("greedy_config_v5e.json", "chat_config_v5e_16gb.json"):
        with open(os.path.join(here, "configs", name)) as f:
            cfgs[name] = json.load(f)
    (cached,) = {c["num_cache_layers"] for c in cfgs.values()}
    (max_length,) = {c["max_length"] for c in cfgs.values()}
    off, info = build_offload_70b(torch, dev, max_length, cached)
    log(f"[offload-config] target {json.dumps(info)}")
    res = dict(target=info)
    for name, cfg in cfgs.items():
        tag = f"[offload-config] {name}"
        eng = AutoEngine.from_config(device=dev, **dict(cfg, model=off,
                                                        draft_model=ckpt["dirs"]["draft"]))
        eng.initialize()
        check(isinstance(eng, DynamicEngine) and eng._offload and eng.tree_size == 257
              and eng.target_model.n_resident == cfg["num_cache_layers"],
              f"{tag}: not a dynamic engine over the offloaded target")
        reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        check(eng._prefill(prompt), f"{tag} prefill refused")
        torch.cuda.synchronize()
        ttft_ms = 1000 * (time.time() - t1)
        prefill_counts = launch_counts()
        eng.reset()
        greedy, use_pen = eng._sampling_mode()
        graph = eng._decode_graph(greedy, eng.topk, use_pen)  # captured before the timed request
        check(offload_plan(eng), f"{tag}: not the offload step's plan: {graph.plan}")
        reset_launch_counts()
        out = eng.generate(input_ids=prompt, max_new_tokens=OFFLOAD_NEW_TOKENS)
        counts = launch_counts()
        toks = out["generated_tokens"]
        steps = request_steps(out)
        check(len(toks) >= OFFLOAD_NEW_TOKENS or toks[-1] in set(eng.eos_token_ids),
              f"{tag} stopped early: {len(toks)}")
        check(all(0 <= t < CFG_70B["vocab_size"] for t in toks), f"{tag} token out of range")
        for k in ("embed_gather", "attend_flash", "w4a16_matmul"):
            check(counts[k] > 0, f"{tag}: kernel {k} was never launched")
        check_tc_route(counts, tag)
        r = dict(tokens=len(toks), steps=steps, tok_per_s=1000.0 / out["time_per_output_token"],
                 decode_step_ms=out["time_per_output_token"] * len(toks) / steps,
                 avg_accept_tokens=out["avg_accept_tokens"], ttft_ms_prefill128=ttft_ms,
                 temperature=eng.temperature, launches=counts,
                 launches_per_step={k: (n - prefill_counts[k]) / steps
                                    for k, n in counts.items()},
                 graphs=check_graphed(eng, tag), capture_ms=graph.capture_ms,
                 launches_per_step_graphs=graph.launches)
        if name.startswith("greedy"):
            # the verify's streamed forward, layer by layer
            gen = torch.Generator(device=dev).manual_seed(9)
            ids = torch.randint(0, CFG_70B["vocab_size"], (eng.tree_size,), generator=gen,
                                device=dev)
            bm = dynamic_bitmap(torch, dev, eng.tree_width, eng.tree_depth, 1)
            pos = PROMPT_LEN + eng._depth
            mask = tree_mask_rows(PROMPT_LEN, bm, max_length)
            _, _, stats = off.streamed_forward_traced(eng.kv_target, ids, pos, mask, PROMPT_LEN)
            per = stats.pop("per_layer")
            stats.pop("per_layer_head")
            streamed = [p for p in per if "copy_ms" in p]
            resident_rows = [p for p in per if "copy_ms" not in p]
            gbps = [p["h2d_gbps"] for p in streamed if p["h2d_gbps"] is not None] or [None]
            stats.update(
                resident_compute_ms_mean=sum(p["compute_ms"] for p in resident_rows)
                / max(len(resident_rows), 1),
                streamed_compute_ms_mean=sum(p["compute_ms"] for p in streamed)
                / max(len(streamed), 1),
                streamed_exposed_ms_mean=sum(p["stream_exposed_ms"] for p in streamed)
                / max(len(streamed), 1),
                h2d_gbps_min=min(gbps, key=lambda g: g or 0),
                h2d_gbps_max=max(gbps, key=lambda g: g or 0),
                per_layer=[{k: round(v, 4) if isinstance(v, float) else v for k, v in p.items()}
                           for p in per])
            r["traced_forward_verify257"] = stats
            log(f"{tag} streamed_forward_traced {json.dumps(stats)}")
            eng.reset()
            # the same request with the whole step eager (PR 10's loop): the same tokens
            stepwise(eng)
            eager = eng.generate(input_ids=prompt, max_new_tokens=OFFLOAD_NEW_TOKENS)
            check(eager["generated_tokens"] == toks,
                  f"{tag}: graphed {toks} vs eager {eager['generated_tokens']}")
            r["eager"] = dict(decode_step_ms=eager["time_per_output_token"] * len(toks)
                              / request_steps(eager),
                              tok_per_s=1000.0 / eager["time_per_output_token"],
                              equal_to_graphed=True)
            # the decode alone, prefill outside the window: every step run (the
            # in-flight one too)
            r["profile_eager"] = decode_profile(torch, eng, prompt, "[offload-profile-eager]",
                                                lambda e: pipelined_steps(e, 2))
            graphed(eng)
            prof = decode_profile(torch, eng, prompt, "[offload-profile]",
                                  lambda e: pipelined_steps(e, 2))
            r["profile"] = prof
            check(prof["h2d_copies"] > 0 and prof["h2d_overlapped_ms"] > 0,
                  f"{tag}: the streamed layers' copies did not overlap compute kernels: "
                  f"{ {k: prof[k] for k in ('h2d_copies', 'h2d_ms', 'h2d_overlapped_ms')} }")
        res[name] = r
        log(f"{tag} {json.dumps({k: v for k, v in r.items() if not k.startswith('profile')})}")
        del eng
        gc.collect()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    res["pinned_host_gb"] = info["pinned_host_gb"]
    log(f"[offload-config] peak device {res['peak_mem_gb']:.2f} GB, pinned host "
        f"{res['pinned_host_gb']:.2f} GB")
    g = res["greedy_config_v5e.json"]
    res.update(launches=g["launches"], launches_per_step=g["launches_per_step"])
    del off
    return res


def offload_checkpoint_phase(torch, dev, ckpt):
    """The 8B AutoAWQ directory loaded with offload: true, num_cache_layers 16
    (16 layers on the card, 16 streamed from pinned memory; half the layers
    each where [checkpoint] cut the depth): its logits for a PROMPT_LEN prompt
    equal the resident load's bit for bit."""
    from umbrella_tpu_torch.models.auto_model import AutoModelLM
    from umbrella_tpu_torch.offload.streaming import OffloadModelRuntime
    from umbrella_tpu_torch.ops.masks import causal_mask_rows

    L = 256
    path = ckpt["dirs"]["target"]
    cached = min(OFFLOAD_CACHED, ckpt["target_layers"] // 2)
    t0 = time.time()
    off = AutoModelLM.from_pretrained(path, offload=True, num_cache_layers=cached, max_length=L,
                                      device=dev)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    check(isinstance(off, OffloadModelRuntime)
          and (off.n_resident, off.n_streamed) == (cached, ckpt["target_layers"] - cached),
          f"[offload-checkpoint] not an offload runtime with {cached} resident layers")
    res_rt = AutoModelLM.from_pretrained(path, max_length=L, device=dev)
    ids = torch.arange(PROMPT_LEN, device=dev) * 7 % res_rt.cfg.vocab_size
    pos = torch.arange(PROMPT_LEN, device=dev)
    mask = causal_mask_rows(0, PROMPT_LEN, L, device=dev)
    want, _ = res_rt.forward(res_rt.params, res_rt.init_kv(), ids, pos, mask, 0)
    got, _ = off.streamed_forward(off.init_kv(), ids, pos, mask, 0)
    check(bool(torch.isfinite(got).all()), "[offload-checkpoint] logits not finite")
    check(torch.equal(got, want), "[offload-checkpoint] offload logits differ from the resident "
          f"load's: max abs diff {(got - want).abs().max().item()}")
    res = dict(load_s=load_s, n_resident=off.n_resident, n_streamed=off.n_streamed,
               pinned_host_gb=off.n_streamed * off.streamed_layer_bytes / 1e9,
               logits_equal_resident=True)
    log(f"[offload-checkpoint] {json.dumps(res)}")
    del off, res_rt
    return res


# ---------------------------------------------------------------- the Gemma2 and MoE families

# the published config.json of google/gemma-2-9b-it and google/gemma-2-2b-it
GEMMA_9B_HF = dict(
    architectures=["Gemma2ForCausalLM"], model_type="gemma2", vocab_size=256000,
    hidden_size=3584, intermediate_size=14336, num_hidden_layers=42, num_attention_heads=16,
    num_key_value_heads=8, head_dim=256, rms_norm_eps=1e-6, rope_theta=10000.0,
    max_position_embeddings=8192, query_pre_attn_scalar=256, sliding_window=4096,
    attn_logit_softcapping=50.0, final_logit_softcapping=30.0, tie_word_embeddings=True,
    hidden_activation="gelu_pytorch_tanh", bos_token_id=2, eos_token_id=1, pad_token_id=0,
    torch_dtype="bfloat16")
GEMMA_2B_HF = dict(GEMMA_9B_HF, hidden_size=2304, intermediate_size=9216, num_hidden_layers=26,
                   num_attention_heads=8, num_key_value_heads=4)
# ... of mistralai/Mixtral-8x7B-Instruct-v0.1 and mistralai/Mistral-7B-Instruct-v0.3
MIXTRAL_HF = dict(
    architectures=["MixtralForCausalLM"], model_type="mixtral", vocab_size=32000,
    hidden_size=4096, intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, num_local_experts=8, num_experts_per_tok=2, rms_norm_eps=1e-5,
    rope_theta=1e6, max_position_embeddings=32768, sliding_window=None,
    tie_word_embeddings=False, bos_token_id=1, eos_token_id=2, torch_dtype="bfloat16")
MISTRAL_HF = dict(
    architectures=["MistralForCausalLM"], model_type="mistral", vocab_size=32768,
    hidden_size=4096, intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, head_dim=128, rms_norm_eps=1e-5, rope_theta=1e6,
    max_position_embeddings=32768, sliding_window=None, tie_word_embeddings=False,
    bos_token_id=1, eos_token_id=2, torch_dtype="bfloat16")
FAMILY_MAX_LEN = 8192  # the single-slot configs' max_length
LONG_PROMPT_LEN = 4200  # past Gemma-2's 4,096-slot window
FAMILY_NEW_TOKENS = 24  # cut from 64, then 48, to keep the script inside its time limit
# the random pairs accept ~1 token a step, so every token is a step: these
# counts keep the six phases inside the script's time limit
FAMILY_STEPWISE_TOKENS = 8  # the stepwise loop's share of a graphed request, compared
FAMILY_DYN_TOKENS, FAMILY_DYN_STEPWISE_TOKENS = 8, 4
FAMILY_SERVE_REQUESTS, FAMILY_SERVE_TOKENS, FAMILY_SINGLE_CHECKED = 12, 16, 3
# steps in a profiled window: at 16,000-22,500 kernels a step, an 8-step
# window (130,000-180,000 kernel records) lost records in some runs
FAMILY_PROFILE_TOKENS = FAMILY_PROFILE_STEPS = 3
MOE_LAYERS, MOE_LAYERS_CUT = 16, 12  # of Mixtral's 32 (all 32 need EP over 4 cards)
MOE_CHECKPOINT_LAYERS = 2
MOE_SINGLE_CHECKED = 2  # [moe-serve] requests held to the single-slot engine
MOE_EMBED_STD = 4.0  # build_moe_target's embedding
PEAK_LIMIT_BYTES = 75e9


def dense_specs(torch, dev, gen, hf, dtype=None, std=0.02, damp_from=None):
    """The HF tensors of a llama/mistral, gemma2 or mixtral checkpoint in file
    order, [(name, dtype, shape, make)]: N(0, std) weights made on the card
    from `gen`, unit norms (gemma2 stores w of its 1 + w scale: zeros).
    Gemma2's embedding is drawn at std / sqrt(hidden): the model multiplies
    it by sqrt(hidden) (59.75 at 9B width) and ties its head to it, so at
    std the input token's own row would win every logit row (by ~40 against
    ~1) and the model would echo its last input token; at std / sqrt(hidden)
    the scaled input has std `std` and the layers decide the next token. From
    layer `damp_from` on the layers' output is damped x0.05 (bench.py's
    damped tail): gemma2's post norms (which would undo a damped o_proj),
    the others' o_proj and down (Mixtral's experts' w2)."""
    dtype = dtype or torch.bfloat16
    H, I, V = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    gemma, moe = hf["model_type"] == "gemma2", hf["model_type"] == "mixtral"

    def normal(shape, scale=1.0):
        return lambda: (torch.randn(shape, generator=gen, device=dev) * (std * scale)).to(dtype)

    def full(value):
        return lambda: torch.full((H,), value, dtype=dtype, device=dev)

    def add(name, shape, make):
        specs.append((name, dtype, shape, make))

    specs = []
    add("model.embed_tokens.weight", (V, H), normal((V, H), H ** -0.5 if gemma else 1.0))
    norms = ("input_layernorm", "post_attention_layernorm") + (
        ("pre_feedforward_layernorm", "post_feedforward_layernorm") if gemma else ())
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        damp = 0.05 if damp_from is not None and i >= damp_from else 1.0
        for n in norms:
            add(p + n + ".weight", (H,), full((damp if n.startswith("post") else 1.0) - 1.0
                                              if gemma else 1.0))
        for name, k, o in _proj_shapes(hf)[:4]:
            add(p + name + ".weight", (o, k),
                normal((o, k), damp if name.endswith("o_proj") and not gemma else 1.0))
        if moe:
            E = hf["num_local_experts"]
            add(p + "block_sparse_moe.gate.weight", (E, H), normal((E, H)))
            for e in range(E):
                for w, shape in (("w1", (I, H)), ("w2", (H, I)), ("w3", (I, H))):
                    add(p + f"block_sparse_moe.experts.{e}.{w}.weight", shape,
                        normal(shape, damp if w == "w2" else 1.0))
        else:
            for name, k, o in _proj_shapes(hf)[4:]:
                add(p + name + ".weight", (o, k),
                    normal((o, k), damp if name.endswith("down_proj") and not gemma else 1.0))
    add("model.norm.weight", (H,), full(0.0 if gemma else 1.0))
    if not hf["tie_word_embeddings"]:
        add("lm_head.weight", (V, H), normal((V, H)))
    return specs


def family_runtime(torch, dev, hf, seed, dtype, max_length, damp_from=None, spec_dtype=None):
    """A ModelRuntime of the config's family over dense_specs(seed) built in
    memory on the card (no checkpoint directory), through the family's HF
    conversion."""
    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.auto_model import ModelRuntime, resolve_family
    from umbrella_tpu_torch.models.gemma import gemma_params_from_hf_state_dict
    from umbrella_tpu_torch.models.moe import moe_params_from_hf_state_dict
    from umbrella_tpu_torch.models.weights import params_from_hf_state_dict

    cfg = ModelConfig.from_dict(hf)
    family = resolve_family("", cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sd = {name: make() for name, _, _, make in dense_specs(
        torch, dev, gen, hf, dtype=spec_dtype or dtype, damp_from=damp_from)}
    if family == "gemma2":
        params = gemma_params_from_hf_state_dict(sd, cfg, max_length, dtype, device=dev)
    elif family == "moe":
        params = moe_params_from_hf_state_dict(sd, cfg, dtype, device=dev)
    else:
        params = params_from_hf_state_dict(sd, cfg, max_length, dtype, device=dev)
    del sd
    torch.cuda.empty_cache()
    return ModelRuntime(cfg, params, max_length, dtype=dtype, family=family, device=dev)


def write_family_dirs(torch, dev, root, models, tag):
    """Write HF-format checkpoint directories, [(name, hf, seed, shards)] ->
    {name: dict(dir, hf, gb, layers, write_s)}, tensor by tensor
    (dense_specs, bf16). Where the disk cannot hold them all, the first
    model's depth is cut, 2 layers at a time (never a width), and the cut
    is reported."""
    import shutil

    free = shutil.disk_usage(root).free
    gen = torch.Generator(device=dev)
    hfs = [dict(hf) for _, hf, _, _ in models]

    def total():
        return sum(spec_bytes(torch, dense_specs(torch, dev, gen, hf)) for hf in hfs)

    while total() + 2e9 > free and hfs[0]["num_hidden_layers"] > 2:
        hfs[0]["num_hidden_layers"] -= 2
    check(total() + 2e9 <= free, f"{tag} not enough disk ({free / 1e9:.1f} GB free)")
    out = {}
    for (name, hf0, seed, shards), hf in zip(models, hfs):
        path = os.path.join(root, name)
        t0 = time.time()
        specs = dense_specs(torch, dev, gen.manual_seed(seed), hf)
        per = -(-len(specs) // shards)
        _write_dir(path, hf, [specs[i:i + per] for i in range(0, len(specs), per)])
        out[name] = dict(dir=path, hf=hf, gb=spec_bytes(torch, specs) / 1e9,
                         layers=hf["num_hidden_layers"], seed=seed,
                         depth_cut=hf["num_hidden_layers"] != hf0["num_hidden_layers"],
                         write_s=time.time() - t0)
        torch.cuda.empty_cache()
    log(f"{tag} free disk {free / 1e9:.1f} GB; wrote {json.dumps(dir_report(out))}")
    return out


def dir_report(dirs):
    return {k: {f: v[f] for f in ("gb", "layers", "depth_cut", "write_s")}
            for k, v in dirs.items()}


def family_config(name, target, draft, **overrides):
    """A shipped config with its model and draft_model replaced (paths or
    runtimes), growmap_path pointed at the port's copy of its tree, and
    `overrides` applied (None drops a key)."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", name)) as f:
        cfg = json.load(f)
    cfg.update(model=target, draft_model=draft)
    if "growmap_path" in cfg:
        cfg["growmap_path"] = os.path.join(here, "umbrella_tpu_torch", "trees",
                                           os.path.basename(cfg["growmap_path"]))
    for k, v in overrides.items():
        if v is None:
            cfg.pop(k, None)
        else:
            cfg[k] = v
    return cfg


def family_requests(seed, n, new_tokens, vocab, prompt_len=PROMPT_LEN, **sampling):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [dict(input_ids=rng.integers(3, vocab, size=prompt_len).astype(np.int32).tolist(),
                 max_new_tokens=new_tokens, **sampling) for _ in range(n)]


def family_kernel_shapes(torch, dev, family):
    """The attention and embedding kernels at the shapes this family's
    configs give them, each against its plain version on the same inputs,
    timed beside it, its bound and (where PyTorch has one call for the same
    function) the library call. gemma2: attend_flash at the Gemma-2-9B
    verify of the 5x6 tree at position 4,300 (past the 4,096-slot window:
    the even layers' window mask leaves the first three 64-slot KV tiles
    fully masked) and the odd layers' full mask, head dim 256, soft cap 50,
    scale 256 ** -0.5; attend_flash_batched at [gemma-serve]'s B=8 3x4
    verify; embed_gather from the 256000 x 3584 table. moe: attend_flash at
    the Mixtral 24x6 verify (head dim 128), attend_flash_batched_int8 at
    [moe-serve]'s B=8 3x4 verify, embed_gather from the 32000 and 32768 x
    4096 tables. Soft-capped attention has no library call
    (scaled_dot_product_attention takes no cap): its SDPA time without the
    cap is reported apart (`sdpa_without_cap_ms`)."""
    import torch.nn.functional as F

    from umbrella_tpu_torch.models.gemma import sliding_mask
    from umbrella_tpu_torch.models.kv_cache import _quantize_block
    from umbrella_tpu_torch.ops.kernels.embed_gather import embed_gather, embed_gather_ref
    from umbrella_tpu_torch.ops.kernels.tree_attention import (
        attend_flash, attend_flash_batched, attend_flash_batched_ref, attend_flash_ref)
    from umbrella_tpu_torch.ops.masks import tree_mask_rows, tree_mask_rows_batched

    tag = f"[{'gemma' if family == 'gemma2' else 'moe'}-kernels]"
    gen = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()

    tol = "max abs err <= 2e-2 * max|plain| (bf16 output; p rounded at other points)"
    out = {}
    if family == "gemma2":
        nH, KVH, D, cap, scale, window = 16, 8, 256, 50.0, 256 ** -0.5, 4096
        single_tree, nn = "5x6", LONG_PROMPT_LEN + 100
    else:
        nH, KVH, D, cap, scale, window = 32, 8, 128, 0.0, None, 0
        single_tree, nn = "24x6", 300
    # -- attend_flash: the single-slot verify at nn over an 8192-slot cache
    gm = shipped_tree(f"sequoia_tree-{single_tree}.json")
    L, S = FAMILY_MAX_LEN, gm.size
    bitmap = torch.as_tensor(gm.bitmap, device=dev)
    full = tree_mask_rows(nn, bitmap, L)
    pos = nn + torch.as_tensor(gm.depth, device=dev)
    masks = {"full mask": full}
    if window:
        masks = {"window mask": sliding_mask(full, pos, window), **masks}
    kc, vc = randn(2, KVH, L, D), randn(2, KVH, L, D)
    q = randn(S, nH, D)
    limit = nn + S
    for what, mask in masks.items():
        e_max, e_rel = 0.0, 0.0
        for layer in (0, 1):
            e, m = err(attend_flash(q, kc, vc, mask, limit, layer, scale=scale, soft_cap=cap),
                       attend_flash_ref(q, kc[layer], vc[layer], mask, limit, scale=scale,
                                        soft_cap=cap))
            check(e <= 2e-2 * m, f"{tag} attend_flash {what} layer={layer}: err {e} vs max {m}")
            e_max, e_rel = max(e_max, e), max(e_rel, e / m)
        dead = int((~mask[:, :limit].any(0)).sum())
        qs = q.transpose(0, 1)[None]
        ks, vs, ms_ = kc[1:2, :, :limit], vc[1:2, :, :limit], mask[None, None, :, :limit]

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=ms_, enable_gqa=True,
                                                  scale=scale)

        by, bb = attention_bound(torch, mask, [limit], nH, KVH, D, False)
        r = dict(shape=f"q [{S},{nH},{D}] bf16 vs [2,{KVH},{L},{D}] cache, {single_tree} "
                       f"tree at slot {nn}, {what}, soft cap {cap}",
                 tolerance=tol, max_abs_err=e_max, max_rel_err=e_rel,
                 slots_masked_for_every_row=dead,
                 ms=cuda_ms(torch, lambda: attend_flash(q, kc, vc, mask, limit, 1, scale=scale,
                                                        soft_cap=cap)),
                 plain_ms=cuda_ms(torch, lambda: attend_flash_ref(
                     q, kc[1], vc[1], mask, limit, scale=scale, soft_cap=cap), graph=False),
                 plain_timed_by="events around 20 back-to-back calls (host time included)",
                 bound_ms=by, bound_by=bb)
        if cap:
            r.update(library_ms=None, sdpa_without_cap_ms=library_ms(torch, sdpa))
        else:
            r.update(library_ms=library_ms(torch, sdpa))
        out[f"attend_flash {what}"] = r
        log(f"{tag} attend_flash {what} {json.dumps(r)}")
    del kc, vc
    # -- attend_flash_batched: B=8 slots of the 3x4 tree over a 4096-slot cache
    gm = shipped_tree("sequoia_tree-3x4.json")
    B, L, S = 8, 4096, gm.size
    int8 = family == "moe"
    nn_b = torch.arange(B, device=dev, dtype=torch.int32) * 97 + 135
    mask = tree_mask_rows_batched(nn_b, torch.as_tensor(gm.bitmap, device=dev), L)
    limits = (nn_b + S).to(torch.int32)
    k, v = randn(2, B, KVH, L, D), randn(2, B, KVH, L, D)
    ksc = vsc = None
    if int8:
        (k, ksc), (v, vsc) = _quantize_block(k), _quantize_block(v)
    q = randn(B, S, nH, D)
    name = "attend_flash_batched_int8" if int8 else "attend_flash_batched"
    e_max, e_rel = 0.0, 0.0
    for layer in (0, 1):
        e, m = err(attend_flash_batched(q, k, v, mask, limits, layer, scale=scale, soft_cap=cap,
                                        k_scale=ksc, v_scale=vsc),
                   attend_flash_batched_ref(q, k, v, mask, limits, layer, scale=scale,
                                            soft_cap=cap, k_scale=ksc, v_scale=vsc))
        check(e <= 2e-2 * m, f"{tag} {name} layer={layer}: err {e} vs max {m}")
        e_max, e_rel = max(e_max, e), max(e_rel, e / m)
    live = int(limits.max())

    def lib():
        kd, vd = k[1, :, :, :live], v[1, :, :, :live]
        if int8:
            kd = (kd.float() * ksc[1, :, :, :live, None]).to(q.dtype)
            vd = (vd.float() * vsc[1, :, :, :live, None]).to(q.dtype)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kd, vd,
                                              attn_mask=mask[:, None, :, :live],
                                              enable_gqa=True, scale=scale)

    by, bb = attention_bound(torch, mask, limits.tolist(), nH, KVH, D, int8)
    r = dict(shape=f"q [{B},{S},{nH},{D}] bf16 vs {'int8' if int8 else 'bf16'} "
                   f"[2,{B},{KVH},{L},{D}] caches, 3x4 tree a slot, "
                   f"kv limits {limits.tolist()}, soft cap {cap}",
             tolerance=tol, max_abs_err=e_max, max_rel_err=e_rel,
             ms=cuda_ms(torch, lambda: attend_flash_batched(
                 q, k, v, mask, limits, 1, scale=scale, soft_cap=cap, k_scale=ksc, v_scale=vsc)),
             plain_ms=cuda_ms(torch, lambda: attend_flash_batched_ref(
                 q, k, v, mask, limits, 1, scale=scale, soft_cap=cap, k_scale=ksc,
                 v_scale=vsc)),
             bound_ms=by, bound_by=bb)
    if cap:
        r.update(library_ms=None, sdpa_without_cap_ms=library_ms(torch, lib))
    else:
        r.update(library_ms=library_ms(torch, lib),
                 library="dequantize (1 call) + scaled_dot_product_attention (1 call)"
                 if int8 else "scaled_dot_product_attention")
    out[name] = r
    log(f"{tag} {name} {json.dumps(r)}")
    del k, v, ksc, vsc
    # -- embed_gather: the verify's rows from the family's tables
    tables = ((256000, 3584),) if family == "gemma2" else ((32000, 4096), (32768, 4096))
    S = shipped_tree(f"sequoia_tree-{single_tree}.json").size
    for V, H in tables:
        table = randn(V, H)
        ids = torch.randint(0, V, (S,), generator=gen, device=dev, dtype=torch.int32)
        e, _ = err(embed_gather(table, ids), embed_gather_ref(table, ids))
        check(e == 0.0, f"{tag} embed_gather {V}x{H}: err {e}")
        by, bb = bound(2 * S * H * 2 + 4 * S, 0, "bf16")
        r = dict(shape=f"[{V},{H}] bf16 table, {S} ids", tolerance="exact", max_abs_err=e,
                 ms=cuda_ms(torch, lambda: embed_gather(table, ids)),
                 plain_ms=cuda_ms(torch, lambda: embed_gather_ref(table, ids)),
                 library_ms=library_ms(torch, lambda: F.embedding(ids.long(), table)),
                 bound_ms=by, bound_by=bb)
        out[f"embed_gather {V}x{H}"] = r
        log(f"{tag} embed_gather {json.dumps(r)}")
        del table
    torch.cuda.empty_cache()
    return out


# a decode whose tokens repeat the token before them this often, or hold
# fewer distinct tokens than this share of their count, is degenerate (a
# random pair that echoes its input passes every token-equality check)
ECHO_SHARE, DISTINCT_SHARE = 0.25, 0.25
ACCEPT_SHARE = 0.9  # of the most one step commits, for a draft independent of its target


def check_not_degenerate(tag, decodes, accept=None, max_accept=None):
    """`decodes`: [(prompt ids, generated tokens)]. Fails where the tokens
    echo the token before them (the prompt's last for the first) in more
    than ECHO_SHARE of the places or hold fewer than DISTINCT_SHARE distinct
    tokens, or (with `accept`) where an independent draft's accept rate
    reaches ACCEPT_SHARE of the most a step commits. Returns the shares."""
    echo = distinct = n = 0
    for prompt, toks in decodes:
        prev = [prompt[-1]] + list(toks[:-1])
        echo += sum(a == b for a, b in zip(toks, prev))
        distinct += len(set(toks))
        n += len(toks)
    out = dict(echo_share=echo / max(n, 1), distinct_share=distinct / max(n, 1))
    check(n > 0 and out["echo_share"] <= ECHO_SHARE and out["distinct_share"] >= DISTINCT_SHARE,
          f"{tag} degenerate decode (it echoes its input or repeats itself): {out}")
    if accept is not None:
        out.update(accept=accept, max_accept=max_accept)
        check(accept < ACCEPT_SHARE * max_accept,
              f"{tag} accept {accept} at the tree's most ({max_accept}): an independent "
              "draft cannot agree with its target that often")
    return out


def warm_up(eng, prompt):
    """Capture the decode step of both sampling modes (a graph each)."""
    eng.generate(input_ids=prompt, max_new_tokens=3, temperature=0.0)
    eng.generate(input_ids=prompt, max_new_tokens=3, temperature=0.6, topp=0.9,
                 repetition_penalty=1.05)


def graphed_and_stepwise(torch, eng, tag, **request):
    """One request on the graphed loop and again stepwise, for its first
    FAMILY_STEPWISE_TOKENS tokens, from the same generator state: each
    loop's tokens, tok/s, step ms and accept; the stepwise tokens must be
    the graphed ones."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    runs, toks, state = {}, {}, eng._gen.get_state()
    for loop in ("graphed", "stepwise"):
        (graphed if loop == "graphed" else stepwise)(eng)
        eng._gen.set_state(state)
        reset_launch_counts()
        out = eng.generate(**dict(request, max_new_tokens=request["max_new_tokens"] if loop
                                  == "graphed" else FAMILY_STEPWISE_TOKENS))
        toks[loop] = out["generated_tokens"]
        steps = request_steps(out)
        runs[loop] = dict(tokens=len(toks[loop]), steps=steps,
                          tok_per_s=1000.0 / out["time_per_output_token"],
                          decode_step_ms=out["time_per_output_token"] * len(toks[loop]) / steps,
                          avg_accept_tokens=out["avg_accept_tokens"], launches=launch_counts())
    graphed(eng)
    runs["degenerate_guard"] = check_not_degenerate(
        tag, [(request["input_ids"], toks["graphed"])], runs["graphed"]["avg_accept_tokens"],
        eng.max_step_advance)
    n = min(len(toks["graphed"]), len(toks["stepwise"]))
    check(n >= min(FAMILY_STEPWISE_TOKENS, len(toks["graphed"]))
          and toks["graphed"][:n] == toks["stepwise"][:n],
          f"{tag} graphed {toks['graphed']} vs stepwise {toks['stepwise']}")
    check(len(toks["graphed"]) >= request["max_new_tokens"]
          or toks["graphed"][-1] in set(eng.eos_token_ids), f"{tag} stopped early")
    runs["graphed_equal_stepwise"] = n
    runs["tokens"] = toks["graphed"]
    return runs


def single_engine_report(torch, dev, eng, prompt, tag, kernels):
    """TTFT of `prompt`, then a [<family>-profile] window over the greedy
    decode alone (the prompt prefilled outside it, FAMILY_PROFILE_TOKENS
    tokens on the graphed loop), whose traced launches a step must equal
    the captured step's: busy ms a step, idle share, host ops a step; peak
    and pool GB."""
    from umbrella_tpu_torch.ops.kernels import reset_launch_counts

    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.time()
    check(eng._prefill(prompt), f"{tag} prefill refused")
    torch.cuda.synchronize()
    ttft_ms = 1000 * (time.time() - t1)
    eng.reset()
    graphs = check_graphed(eng, tag)
    eng.update_generation_args(temperature=0.0)
    profile_tag = f"{tag[:tag.index('-')]}-profile]"
    before = {}

    def decode(e):  # the replays before each profiled window (the last one counts)
        before.update({k: g.replays for k, g in e._decode_graphs.items()})
        return e._decode_fused(FAMILY_PROFILE_TOKENS)

    prof = decode_profile(torch, eng, prompt, profile_tag, decode)
    (key,) = [k for k, g in eng._decode_graphs.items() if g.replays > before.get(k, 0)]
    graph = eng._decode_graphs[key]
    replays = graph.replays - before[key]
    per_step = {k: n / replays for k, n in prof["launches_traced"].items()}
    check(all(per_step[k] == graph.launches[k] for k in per_step),
          f"{profile_tag} launches a step traced {per_step}, captured {graph.launches}")
    for name in kernels:
        check(graph.launches[name] > 0, f"{tag} kernel {name} is not in the captured step")
    return dict(ttft_ms_prefill128=ttft_ms, launches_per_step=graph.launches,
                launches_per_step_traced=per_step, profile=prof, graphs=graphs,
                capture_ms=graph.capture_ms, pool_gb_by_device=graphs["pool_gb_by_device"],
                peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)


def gemma_lossless_check(torch, dev, prompt):
    """Gemma-2-9B widths, 4 layers, fp32, the last 2 layers' post norms damped
    x0.05 and the draft the first 2 (early exit): the static engine (graphed,
    and stepwise) and the dynamic engine (graphed) each equal the AR decode
    for LOSSLESS_NEW_TOKENS tokens; the batched engine (B=4, 2x3 tree,
    graphed and stepwise) gives each of 5 requests of staggered lengths the
    single-slot engine's tokens."""
    from umbrella_tpu_torch.models.auto_model import early_exit_runtime
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    tag = "[gemma-lossless]"
    target = family_runtime(torch, dev, dict(GEMMA_9B_HF, num_hidden_layers=4), 21,
                            torch.float32, MAX_LEN, damp_from=2)
    draft = early_exit_runtime(target, 2)
    check(target.family == "gemma2" and target.gemma_args.attn_scale
          == GEMMA_9B_HF["query_pre_attn_scalar"] ** -0.5,
          f"{tag} not a Gemma2 runtime")
    res, decodes = {}, {}
    for name in ("static", "static-stepwise", "dynamic"):
        eng = (dynamic_engine(torch, dev, target, draft, torch.float32) if name == "dynamic"
               else make_engine(torch, dev, target, draft, torch.float32))
        if name == "static-stepwise":
            stepwise(eng)
        reset_launch_counts()
        out = eng.generate(input_ids=prompt, max_new_tokens=LOSSLESS_NEW_TOKENS)
        counts = launch_counts()
        decodes[name] = out["generated_tokens"]
        res[name] = dict(tokens=len(out["generated_tokens"]),
                         avg_accept_tokens=out["avg_accept_tokens"])
        if name != "static-stepwise":
            res[name]["graphs"] = check_graphed(eng, f"{tag} {name}")
        for k in ("attend_flash", "embed_gather"):
            check(counts[k] > 0, f"{tag} {name}: kernel {k} was never launched")
        check(counts["attend_flash_scalar"] == counts["attend_flash"],
              f"{tag} {name}: fp32 q must take the scalar attention kernel")
        del eng
    check(decodes["static"] == decodes["static-stepwise"],
          f"{tag} static graphed {decodes['static']} vs stepwise {decodes['static-stepwise']}")
    n = max(len(v) for v in decodes.values())
    ar, gaps, _, _ = greedy_ar_decode(torch, target, prompt, n)
    # the draft is the target's first layers (the rest damped): a high
    # accept rate is by design, so only the tokens are guarded
    guard = check_not_degenerate(tag, [(prompt, ar)])
    for name, toks in decodes.items():
        same = first_difference(toks, ar)
        res[name].update(identical_prefix=same,
                         gap_at_first_difference=gaps[same] if same < len(toks) else None)
        check(len(toks) >= LOSSLESS_NEW_TOKENS and same >= LOSSLESS_NEW_TOKENS,
              f"{tag} {name} and the AR decode differ at token {same}: {toks} vs {ar}")
    reqs = [dict(r, input_ids=r["input_ids"][:PROMPT_LEN - PROMPT_LEN // 8 * i])
            for i, r in enumerate(family_requests(3, 5, BATCHED_LOSSLESS_TOKENS,
                                                  GEMMA_9B_HF["vocab_size"]))]
    beng = batched_engine(torch, dev, target, draft, 4, (2, 3), None, torch.float32)
    reset_launch_counts()
    outs = beng.run(reqs)
    counts = launch_counts()
    res["batched"] = dict(graphs=check_graphed(beng, f"{tag} batched"))
    check(counts["attend_flash_batched"] > 0, f"{tag} batched: attention never launched")
    stepwise(beng)
    souts = beng.run(reqs)
    graphed(beng)
    del beng
    check(all(a["generated_tokens"] == b["generated_tokens"] for a, b in zip(outs, souts)),
          f"{tag} batched graphed and stepwise segments gave other tokens")
    single = make_engine(torch, dev, target, draft, torch.float32, tree=(2, 3))
    same = []
    for r, o in zip(reqs, outs):
        want = single.generate(input_ids=r["input_ids"],
                               max_new_tokens=BATCHED_LOSSLESS_TOKENS)["generated_tokens"]
        same.append(first_difference(o["generated_tokens"], want))
    del single
    res["batched"].update(identical_prefix=same, prompt_lens=[len(r["input_ids"]) for r in reqs],
                          avg_accept_tokens=[o["avg_accept_tokens"] for o in outs])
    check(min(same) >= BATCHED_LOSSLESS_TOKENS,
          f"{tag} batched and single-slot tokens differ: {same}")
    res["identical_prefix"] = min(min(r["identical_prefix"] for k, r in res.items()
                                      if k != "batched"), min(same))
    res["degenerate_guard"] = guard
    log(f"{tag} {json.dumps(res)}")
    return res


def gemma_config_phase(torch, dev, dirs, prompt, shared):
    """configs/chat_config_8b_v5e.json's keys over the Gemma-2-9B directory
    (target) and the Gemma-2-2B directory (draft), "template": "gemma2-it",
    max_length 8192: the static engine with the 5x6 tree at 0.6 / 0.9 /
    1.05. A stochastic request (FAMILY_NEW_TOKENS new tokens) and a greedy
    one with a LONG_PROMPT_LEN-token prompt, past the window, each graphed
    and stepwise from one generator state (graphed_and_stepwise: equal
    tokens); TTFT, the kernels
    at this family's shapes (family_kernel_shapes) and a [gemma-profile]
    window. Then the same runtimes under the default dynamic engine: a
    greedy request graphed, and stepwise for its first tokens."""
    import numpy as np

    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine
    from umbrella_tpu_torch.speculation.dynamic_engine import DynamicEngine
    from umbrella_tpu_torch.speculation.static_engine import StaticEngine

    tag = "[gemma-config]"
    cfg = family_config("chat_config_8b_v5e.json", dirs["gemma-2-9b"]["dir"],
                        dirs["gemma-2-2b"]["dir"], template="gemma2-it",
                        max_length=FAMILY_MAX_LEN)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    eng = AutoEngine.from_config(device=dev, **cfg)
    eng.initialize()
    torch.cuda.synchronize()
    init_s = time.time() - t0
    t, d = eng.target_model, eng.draft_model
    check(isinstance(eng, StaticEngine) and t.family == d.family == "gemma2"
          and (t.args.n_layers, d.args.n_layers) == (dirs["gemma-2-9b"]["layers"],
                                                      dirs["gemma-2-2b"]["layers"])
          and (eng.temperature, eng.topp, eng.repetition_penalty) == (0.6, 0.9, 1.05)
          and t.gemma_args.sliding_window == GEMMA_9B_HF["sliding_window"]
          and t.gemma_args.attn_softcap == GEMMA_9B_HF["attn_logit_softcapping"],
          f"{tag} the engine did not take the config and the directories as shipped")
    resident_gb = torch.cuda.memory_allocated(dev) / 2**30
    vocab = GEMMA_9B_HF["vocab_size"]
    long_prompt = np.random.default_rng(7).integers(3, vocab, LONG_PROMPT_LEN).tolist()
    warm_up(eng, prompt)
    res = dict(init_s=init_s, resident_gb=resident_gb, dirs=dir_report(dirs))
    res["stochastic"] = graphed_and_stepwise(
        torch, eng, f"{tag} stochastic", input_ids=prompt, max_new_tokens=FAMILY_NEW_TOKENS,
        temperature=0.6, topp=0.9, repetition_penalty=1.05)
    res["greedy_long"] = graphed_and_stepwise(
        torch, eng, f"{tag} greedy {LONG_PROMPT_LEN}-token prompt", input_ids=long_prompt,
        max_new_tokens=FAMILY_NEW_TOKENS, temperature=0.0)
    torch.cuda.synchronize()
    t1 = time.time()
    check(eng._prefill(long_prompt), f"{tag} long prefill refused")
    torch.cuda.synchronize()
    res["ttft_ms_prefill4200"] = 1000 * (time.time() - t1)
    eng.reset()
    for r in ("stochastic", "greedy_long"):
        check(all(0 <= x < vocab for x in res[r].pop("tokens")), f"{tag} token out of range")
        counts = res[r]["graphed"]["launches"]
        for k in ("embed_gather", "attend_flash"):
            check(counts[k] > 0, f"{tag} {r}: kernel {k} was never launched")
        check_tc_route(counts, f"{tag} {r}")
    res.update(single_engine_report(torch, dev, eng, prompt, tag,
                                    ("embed_gather", "attend_flash")))
    g = res["stochastic"]["graphed"]
    res.update(tok_per_s=g["tok_per_s"], decode_step_ms=g["decode_step_ms"],
               avg_accept_tokens=g["avg_accept_tokens"], launches=g["launches"])
    res["kernel_shapes"] = family_kernel_shapes(torch, dev, "gemma2")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the default engine (no `engine` key, its default tree) over the same runtimes
    torch.cuda.reset_peak_memory_stats(dev)
    deng = AutoEngine.from_config(device=dev, **family_config(
        "chat_config_8b_v5e.json", t, d, engine=None, growmap_path=None,
        template="gemma2-it", max_length=FAMILY_MAX_LEN))
    deng.initialize()
    check(isinstance(deng, DynamicEngine), f"{tag} no engine key: not the dynamic engine")
    deng.generate(input_ids=prompt, max_new_tokens=4, temperature=0.0)  # warm-up
    out = deng.generate(input_ids=prompt, max_new_tokens=FAMILY_DYN_TOKENS, temperature=0.0)
    toks = out["generated_tokens"]
    steps = request_steps(out)
    stepwise(deng)
    sw = deng.generate(input_ids=prompt, max_new_tokens=FAMILY_DYN_STEPWISE_TOKENS,
                       temperature=0.0)
    graphed(deng)
    n = len(sw["generated_tokens"])
    check(toks[:n] == sw["generated_tokens"],
          f"{tag} dynamic graphed {toks[:n]} vs stepwise {sw['generated_tokens']}")
    guard = check_not_degenerate(f"{tag} dynamic", [(prompt, toks)], out["avg_accept_tokens"],
                                 deng.max_step_advance)
    res["dynamic"] = dict(
        tree=(deng.tree_width, deng.num_beams, deng.tree_depth), tokens=len(toks), steps=steps,
        tok_per_s=1000.0 / out["time_per_output_token"],
        decode_step_ms=out["time_per_output_token"] * len(toks) / steps,
        avg_accept_tokens=out["avg_accept_tokens"], graphs=check_graphed(deng, f"{tag} dynamic"),
        stepwise_tok_per_s=1000.0 / sw["time_per_output_token"], graphed_equal_stepwise=n,
        degenerate_guard=guard,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"{tag} {json.dumps(res)}")
    del deng
    shared["runtimes"] = (t, d)
    return res


# run() and the single-slot engine compute a slot's rows in products of other
# row counts (B x tree rows against tree rows): in bf16 the dense products'
# last bits differ, so the two decodes may part where both tokens' logits
# are near the top. A parting passes where the batched and the single-slot
# tokens are both within SERVE_NEAR_TIE of max|logit|, or within twice the
# noise that the row count puts on that row's logits, of the top logit
# (next_token_gap). The noise is measured between the single-slot engine's
# row counts and the batched engine's forwards over the same tokens, and
# must itself stay within SERVE_FORM_TOL of max|logit| for a dense target (a
# wrong batched form would be far outside it). A random Gemma2 pair's
# logits are flat (max ~0.09 over 256,000 tokens), so its top tokens lie
# within that noise.
SERVE_NEAR_TIE = 2 ** -7
SERVE_FORM_TOL = 2 ** -3
# an MoE target's rows may also part where the router's k-th and (k+1)-th
# logits are this close (the same share of the row's max|router logit|): a
# last-bit difference before the router then swaps an expert
ROUTER_TIE = 2 ** -7


def next_token_gap(torch, runtime, ids, token, single, batch, rows):
    """The target's greedy choice after `ids`, computed as the single-slot
    engine does: the prefix in one forward, then the last `rows` rows (a
    verify's row count) in another; from that row, top-1 minus top-2 logit
    (`gap`), top-1 minus `token`'s and `single`'s logits (`token_gap`,
    `single_gap`), max|logit| and whether `token` is the runner-up. `form_noise`: max|difference| of those
    rows' logits from the batched engine's forwards (model_forwards) over
    `batch` copies of `ids`, each slot's prefix through the slot form (as
    the batched engine prefills) and the last `rows` rows of every slot in
    one batched forward (batch x rows against rows)."""
    from umbrella_tpu_torch.models.batched import init_batched_kv, model_forwards
    from umbrella_tpu_torch.ops.masks import causal_mask_rows

    dev, S, P = runtime.device, len(ids), runtime.params
    n0 = S - rows
    x = torch.tensor(ids, device=dev, dtype=torch.int32)
    pos = torch.arange(S, device=dev, dtype=torch.int32)
    kv = runtime.init_kv()
    runtime.forward(P, kv, x[:n0], pos[:n0], causal_mask_rows(0, n0, runtime.max_length,
                                                              device=dev), 0)
    logits, _ = runtime.forward(P, kv, x[n0:], pos[n0:],
                                causal_mask_rows(n0, rows, runtime.max_length, device=dev), n0)
    row = logits[-1]
    del kv
    L = -(-S // 64) * 64
    kv = init_batched_kv(runtime.cfg, batch, L, runtime.dtype, num_layers=runtime.args.n_layers,
                         device=dev)
    batched_fwd, slot_fwd = model_forwards(runtime)
    for b in range(batch):
        slot_fwd(P, kv, x[:n0], pos[:n0], causal_mask_rows(0, n0, L, device=dev), b, 0)
    many, _ = batched_fwd(
        P, kv, x[n0:].expand(batch, rows).contiguous(), pos[n0:].expand(batch, rows).contiguous(),
        causal_mask_rows(n0, rows, L, device=dev).expand(batch, rows, L).contiguous(),
        torch.full((batch,), n0, dtype=torch.int32, device=dev))
    noise = float((many - logits).abs().max())
    del many, kv, logits
    top = torch.topk(row, 2)
    torch.cuda.empty_cache()
    return dict(gap=float(top.values[0] - top.values[1]),
                token_gap=float(top.values[0] - row[token]),
                single_gap=float(top.values[0] - row[single]), form_noise=noise,
                max_abs_logit=float(row.abs().max()), runner_up=int(top.indices[1]) == token)


def router_margins(torch, runtime, ids, prompt_len):
    """Why an MoE decode may part at the row after `ids`: the target's router
    logits at every layer for the rows the engines computed in other row
    counts (from the prompt's last row, prompt_len - 1, to the last), from
    one forward over all of `ids` and again from two (the rows before, then
    these rows): two row counts. A row's top-k margin is its k-th minus its
    (k+1)-th router logit over max|router logit|; `tie` where the least
    margin of the two computations is within ROUTER_TIE, a bf16 ulp-scale
    tie that a last-bit difference before the router can swap. Also: the
    (layer, row) of the least margin, the top-k sets that the two row counts
    already swap, and the share of the prompt's rows' decisions within
    ROUTER_TIE (how often a tie turns up by chance)."""
    from umbrella_tpu_torch.models import moe
    from umbrella_tpu_torch.ops.masks import causal_mask_rows

    dev, S, L, n = runtime.device, len(ids), runtime.max_length, runtime.args.n_layers
    k, lo = runtime.cfg.num_experts_per_tok, prompt_len - 1
    real_route = moe.route

    def router_logits(splits):
        logged = []

        def route(lw, x, top_k):
            logged.append((x.float() @ lw["router"].float()).reshape(-1, lw["router"].shape[-1]))
            return real_route(lw, x, top_k)

        kv = runtime.init_kv()
        moe.route = route
        try:
            for a, b in splits:
                runtime.forward(runtime.params, kv, torch.tensor(ids[a:b], device=dev),
                                torch.arange(a, b, device=dev),
                                causal_mask_rows(a, b - a, L, device=dev), a)
        finally:
            moe.route = real_route
        del kv
        return torch.stack([torch.cat(logged[l::n]) for l in range(n)])  # [n, S, E]

    def shares(logits):
        top = torch.sort(logits, dim=-1, descending=True, stable=True)
        return (top.values[..., k - 1] - top.values[..., k]) / logits.abs().amax(-1), \
            top.indices[..., :k].sort(-1).values

    whole, whole_sets = shares(router_logits([(0, S)]))
    split, split_sets = shares(router_logits([(0, lo), (lo, S)]))
    window = torch.minimum(whole[:, lo:], split[:, lo:])
    least = float(window.min())
    layer, row = divmod(int(window.argmin()), window.shape[1])
    swapped = (whole_sets[:, lo:] != split_sets[:, lo:]).any(-1)
    torch.cuda.empty_cache()
    return dict(tie=least <= ROUTER_TIE, least_margin=least, at_layer=layer,
                at_position=lo + row, rows=S - lo, decisions=window.numel(),
                swapped_by_row_count=int(swapped.sum()),
                prompt_tie_rate=float((whole[:, :lo] <= ROUTER_TIE).float().mean()))


def family_serve_phase(torch, dev, tag, cfg, vocab, attn_kernel, router_ties=False,
                       single_checked=FAMILY_SINGLE_CHECKED):
    """A shipped batched config over runtimes already loaded (EOS off, so that
    every request decodes its budget and a profiled segment runs whole):
    greedy requests (FAMILY_SERVE_REQUESTS, FAMILY_SERVE_TOKENS new tokens
    each) through run() and through the pipelined ContinuousBatcher (the
    same tokens, reported); one profiled segment; the first
    `single_checked` requests against the single-slot static engine
    over the same runtimes and tree: they must equal it or part from it only
    at a near tie of the target's logits (SERVE_NEAR_TIE), or, with
    `router_ties` (an MoE target), where router_margins finds a router tie
    on the rows before the parting."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.serving.batched_engine import ContinuousBatcher
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    torch.cuda.reset_peak_memory_stats(dev)
    eng = AutoEngine.from_config(device=dev, **cfg)
    eng.initialize()
    B = eng.batch_size
    reqs = family_requests(17, FAMILY_SERVE_REQUESTS, FAMILY_SERVE_TOKENS, vocab,
                           temperature=0.0)
    eng.run([dict(r, max_new_tokens=8) for r in reqs[:B]])  # warm-up
    reset_launch_counts()
    steps0 = eng.steps_dispatched
    torch.cuda.synchronize()
    t0 = time.time()
    outs = eng.run([dict(r) for r in reqs])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    steps = eng.steps_dispatched - steps0
    for name in (attn_kernel, "embed_gather"):
        check(counts[name] > 0, f"{tag} kernel {name} was never launched")
    check_tc_route(counts, tag)
    for r, o in zip(reqs, outs):
        toks = o["generated_tokens"]
        check(r["max_new_tokens"] <= len(toks) <= r["max_new_tokens"] + 1
              or toks[-1] in set(eng.eos_token_ids), f"{tag} request got {len(toks)} tokens")
        check(all(0 <= x < vocab for x in toks), f"{tag} token out of range")
    batcher = ContinuousBatcher(eng)
    batcher.start()
    try:
        t0 = time.time()
        futs = [batcher.submit(**dict(r)) for r in reqs]
        pouts = [f.result(timeout=600) for f in futs]
        pwall = time.time() - t0
    finally:
        batcher.shutdown()
    same = sum(p["generated_tokens"] == o["generated_tokens"] for p, o in zip(pouts, outs))
    step_ms, per_step, prof = decode_segment(torch, eng, reqs[:B], f"{tag[:-1]}-profile]",
                                             FAMILY_PROFILE_STEPS)
    check(prof is not None, f"{tag} the kernels' launches were not traced")
    res = dict(batch=B, kv_dtype=eng.kv_dtype or "bf16", tree=eng.tree_size,
               segment_steps=eng.segment_steps, requests=len(reqs),
               run_tok_per_s=sum(len(o["generated_tokens"]) for o in outs) / wall,
               run_s=wall, run_steps=steps,
               pipelined_tok_per_s=sum(len(p["generated_tokens"]) for p in pouts) / pwall,
               pipelined_equal_to_run=same,
               avg_accept_tokens=sum(o["avg_accept_tokens"] for o in outs) / len(outs),
               ttft_ms_p50=pct([p["ttft_ms"] for p in pouts], 50),
               tpot_ms_p50=pct([p["time_per_output_token"] for p in pouts], 50),
               decode_step_ms=step_ms, launches=counts, launches_per_step=per_step,
               profile=prof, launches_traced=prof["launches_traced"],
               graphs=check_graphed(eng, tag))
    t, d = eng.target_model, eng.draft_model
    gm = eng.growmap
    res["degenerate_guard"] = check_not_degenerate(
        tag, [(r["input_ids"], o["generated_tokens"]) for r, o in zip(reqs, outs)],
        res["avg_accept_tokens"], int(gm.node_in_path.max()))
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    del eng, batcher
    gc.collect()
    torch.cuda.empty_cache()
    single = AutoEngine.from_config(device=dev, engine="static", model=t, draft_model=d,
                                    growmap=gm, max_length=t.max_length, temperature=0.0,
                                    eos_token_ids=cfg.get("eos_token_ids"), dtype=torch.bfloat16,
                                    kv_dtype=cfg.get("kv_dtype"))
    single.initialize()
    firsts, partings = [], []
    for r, o in zip(reqs[:single_checked], outs):
        want = single.generate(input_ids=r["input_ids"], max_new_tokens=FAMILY_SERVE_TOKENS,
                               temperature=0.0)["generated_tokens"]
        got = o["generated_tokens"]
        j = first_difference(got, want)
        firsts.append(j)
        if j < FAMILY_SERVE_TOKENS:
            ids = r["input_ids"] + want[:j]
            p = dict(request=len(firsts) - 1, token=j, batched=got[j], single=want[j],
                     **next_token_gap(torch, t, ids, got[j], want[j], B, gm.size))
            m = p["max_abs_logit"]
            p["logit_near_tie"] = max(p["token_gap"], p["single_gap"]) <= max(
                SERVE_NEAR_TIE * m, 2 * p["form_noise"])
            check(router_ties or p["form_noise"] <= SERVE_FORM_TOL * m,
                  f"{tag} the batched form's logits differ from the plain forward's by "
                  f"{p['form_noise']} (max|logit| {m})")
            if router_ties:
                p["router"] = router_margins(torch, t, ids, len(r["input_ids"]))
            partings.append(p)
    del single
    res.update(single_slot_identical_prefix=firsts, partings=partings)
    log(f"{tag} {json.dumps(res)}")
    check(all(p["logit_near_tie"] or (router_ties and p["router"]["tie"]) for p in partings),
          f"{tag} run() and the single-slot engine part away from a near tie"
          f"{' of the logits or the router' if router_ties else ''}: {partings}")
    return res


def gemma_serve_phase(torch, dev, dirs, shared):
    """configs/serve_batched_8b_v5e.json's keys (B=8, bf16 KV, 3x4 tree,
    max_length 4096) over [gemma-config]'s Gemma-2-9B / 2B runtimes (the
    directories loaded again where that phase did not run)."""
    from umbrella_tpu_torch.models.auto_model import AutoModelLM

    t, d = shared.get("runtimes") or [AutoModelLM.from_pretrained(
        dirs[k]["dir"], max_length=FAMILY_MAX_LEN, device=dev) for k in ("gemma-2-9b",
                                                                        "gemma-2-2b")]
    cfg = family_config("serve_batched_8b_v5e.json", t, d, template="gemma2-it",
                        eos_token_ids=[-100])
    return family_serve_phase(torch, dev, "[gemma-serve]", cfg, GEMMA_9B_HF["vocab_size"],
                              "attend_flash_batched")


def moe_checkpoint_phase(torch, dev, dirs):
    """The Mixtral-8x7B-format directory (full widths, MOE_CHECKPOINT_LAYERS
    layers, two shards) through AutoModelLM.from_pretrained: family moe, the
    expert stacks' shapes, and logits for a 16-token prompt equal bit for bit
    to those of the same tensors built in memory; the Mistral-7B-v0.3
    directory loads as a mistral draft with finite logits over its 32768-token
    vocabulary."""
    from umbrella_tpu_torch.ops.masks import causal_mask_rows

    tag = "[moe-checkpoint]"
    L = 256
    mix = dirs["mixtral-8x7b"]
    target, t_load = _timed_load(torch, dev, mix["dir"], max_length=L)
    E, H, I = (MIXTRAL_HF[k] for k in ("num_local_experts", "hidden_size", "intermediate_size"))
    lw = target.params["layers"]
    check(target.family == "moe" and lw["expert_gate"].shape == (mix["layers"], E, H, I)
          and lw["expert_down"].shape == (mix["layers"], E, I, H)
          and lw["router"].shape == (mix["layers"], H, E)
          and lw["expert_up"].dtype == torch.bfloat16, f"{tag} target loaded in the wrong form")
    ids = torch.arange(100, 116, device=dev)
    pos = torch.arange(16, device=dev)
    mask = causal_mask_rows(0, 16, L, device=dev)

    def logits(rt):
        return rt.forward(rt.params, rt.init_kv(), ids, pos, mask, 0)[0]

    got = logits(target)
    del target, lw
    torch.cuda.empty_cache()
    mem = family_runtime(torch, dev, mix["hf"], mix["seed"], torch.bfloat16, L)
    want = logits(mem)
    del mem
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(got).all()), f"{tag} logits not finite")
    check(torch.equal(got, want), f"{tag} the loaded directory's logits differ from the "
          f"in-memory build: max abs diff {(got - want).abs().max().item()}")
    draft, d_load = _timed_load(torch, dev, dirs["mistral-7b-v0.3"]["dir"], max_length=L)
    check(draft.family == "mistral" and draft.params["embed"].shape[0] == MISTRAL_HF["vocab_size"]
          and draft.params["lm_head"].shape == (H, MISTRAL_HF["vocab_size"]),
          f"{tag} draft loaded in the wrong form")
    d_logits = logits(draft)
    check(bool(torch.isfinite(d_logits).all())
          and d_logits.shape[-1] == MISTRAL_HF["vocab_size"],
          f"{tag} draft logits")
    del draft
    torch.cuda.empty_cache()
    res = dict(target=t_load, draft=d_load, target_layers=mix["layers"],
               logits_equal_in_memory=True, dirs=dir_report(dirs))
    log(f"{tag} {json.dumps(res)}")
    return res


def build_moe_target(torch, dev, n_layers, devices):
    """A random bf16 MoE runtime at Mixtral-8x7B's widths, n_layers deep,
    expert-sharded over `devices` (shard_runtime_ep: the configs'
    expert_parallel 4), its embedding scaled to MOE_EMBED_STD: drawn Glorot
    (std 0.0074 at 32000 x 4096) the input token is lost against the layers'
    outputs (RMS ~1.3 each), and the greedy decode collapses onto a few
    repeated tokens (on the card, 61% of tokens repeated the one before and
    14% were distinct; at std 1, 34% and 36%). On one card: built from
    init_moe_llama_params and sharded in place (the shards are views).
    Across cards: each shard's experts drawn on its own card (32 layers'
    would not fit on one), the rest on `dev`, Glorot-normal as
    init_moe_llama_params draws them."""
    import itertools

    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.moe import (ExpertShard, ShardedExperts,
                                               init_moe_llama_params, moe_runtime,
                                               shard_runtime_ep)
    from umbrella_tpu_torch.ops.rope import rope_params

    cfg = ModelConfig.from_dict(dict(MIXTRAL_HF, num_hidden_layers=n_layers))
    E, H, I, V = (cfg.num_local_experts, cfg.hidden_size, cfg.intermediate_size,
                  cfg.vocab_size)
    embed_scale = MOE_EMBED_STD * ((V + H) / 2) ** 0.5
    if len(set(devices)) == 1:
        params = init_moe_llama_params(cfg, torch.Generator(device=dev).manual_seed(41), E,
                                       torch.bfloat16, device=dev)
        params["embed"] *= embed_scale
        return shard_runtime_ep(moe_runtime(cfg, params, FAMILY_MAX_LEN, dtype=torch.bfloat16,
                                            top_k=cfg.num_experts_per_tok, device=dev), devices)

    def glorot(gen, device, *shape):
        std = (2.0 / (shape[-2] + shape[-1])) ** 0.5
        out = torch.empty(shape, dtype=torch.bfloat16, device=device)
        for idx in itertools.product(*map(range, shape[:-2])):
            out[idx] = torch.randn(shape[-2:], generator=gen, device=device) * std
        return out

    n, D = n_layers, cfg.resolved_head_dim
    Hq, KV = cfg.num_attention_heads * D, cfg.num_key_value_heads * D
    gen = torch.Generator(device=dev).manual_seed(41)
    ones = torch.ones((n, H), dtype=torch.bfloat16, device=dev)
    layers = dict(input_norm=ones, post_norm=ones.clone(), wq=glorot(gen, dev, n, H, Hq),
                  wk=glorot(gen, dev, n, H, KV), wv=glorot(gen, dev, n, H, KV),
                  wo=glorot(gen, dev, n, Hq, H), router=glorot(gen, dev, n, H, E))
    per = E // len(devices)
    shards = []
    for s, d in enumerate(devices):
        g = torch.Generator(device=d).manual_seed(42 + s)
        shards.append(ExpertShard(d, glorot(g, d, n, per, H, I), glorot(g, d, n, per, H, I),
                                  glorot(g, d, n, per, I, H)))
    layers["expert_shards"] = ShardedExperts(shards)
    params = dict(embed=glorot(gen, dev, V, H) * embed_scale,
                  final_norm=torch.ones((H,), dtype=torch.bfloat16, device=dev), layers=layers,
                  lm_head=glorot(gen, dev, H, V), **rope_params(cfg, device=dev))
    return moe_runtime(cfg, params, FAMILY_MAX_LEN, dtype=torch.bfloat16,
                       top_k=cfg.num_experts_per_tok, device=dev)


def moe_config_phase(torch, dev, dirs, prompt, shared):
    """configs/chat_config_mixtral_ep.json as shipped (the static engine,
    expert_parallel 4, 24x6 tree, 0.6 / 0.9 / 1.05): the target a random MoE
    runtime at Mixtral-8x7B's widths expert-sharded in 4 (build_moe_target):
    on one card all four shards on it, at MOE_LAYERS of its 32 layers
    (MOE_LAYERS_CUT where the card runs out of memory or the peak passes
    PEAK_LIMIT_BYTES); on a host with four cards one shard a card, at all
    32. The draft the Mistral-7B-v0.3 directory (its 32768-token vocabulary
    wider than the target's 32000). A stochastic request graphed and
    stepwise from one generator state (graphed_and_stepwise: equal tokens);
    TTFT, the kernels at this family's shapes and a [moe-profile] window
    (greedy); on four cards, device kernels on every card."""
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine
    from umbrella_tpu_torch.speculation.static_engine import StaticEngine

    tag = "[moe-config]"
    vocab = MIXTRAL_HF["vocab_size"]
    devices = stage_devices(torch, dev)
    across = len(set(devices)) > 1
    res, eng = {}, None
    for layers in ((MIXTRAL_HF["num_hidden_layers"],) if across else (MOE_LAYERS, MOE_LAYERS_CUT)):
        for c in set(devices):
            torch.cuda.reset_peak_memory_stats(c)
        try:
            t0 = time.time()
            target = build_moe_target(torch, dev, layers, devices)
            torch.cuda.synchronize()
            res["build_s"] = time.time() - t0
            cfg = family_config("chat_config_mixtral_ep.json", target,
                                dirs["mistral-7b-v0.3"]["dir"], max_length=FAMILY_MAX_LEN)
            del target
            t0 = time.time()
            eng = AutoEngine.from_config(device=dev, **cfg)
            eng.initialize()
            torch.cuda.synchronize()
            res["init_s"] = time.time() - t0
            warm_up(eng, prompt)
            peak = torch.cuda.max_memory_allocated(dev)
        except torch.cuda.OutOfMemoryError as e:
            log(f"{tag} {layers} layers: out of memory ({str(e).splitlines()[0]})")
            eng = target = peak = None
        if peak is not None and (peak <= PEAK_LIMIT_BYTES or layers != MOE_LAYERS):
            break
        log(f"{tag} {layers} layers: peak {peak and peak / 1e9} GB; cut to {MOE_LAYERS_CUT}")
        eng = target = None
        gc.collect()
        torch.cuda.empty_cache()
    check(eng is not None, f"{tag} no depth fits the card")
    t, d = eng.target_model, eng.draft_model
    check(isinstance(eng, StaticEngine) and t.family == "moe" and d.family == "mistral"
          and eng.expert_parallel == 4 and t.shard_devices == tuple(devices)
          and d.shard_devices is None
          and (eng.temperature, eng.topp, eng.repetition_penalty) == (0.6, 0.9, 1.05)
          and eng.tree_size == shipped_tree("sequoia_tree-24x6.json").size,
          f"{tag} the engine did not take the config as shipped")
    res.update(target_layers=t.args.n_layers, shard_devices=[str(x) for x in devices],
               depth_cut=t.args.n_layers != (MIXTRAL_HF["num_hidden_layers"] if across
                                             else MOE_LAYERS),
               resident_gb=sum(torch.cuda.memory_allocated(c) for c in set(devices)) / 2**30)
    res["stochastic"] = graphed_and_stepwise(
        torch, eng, f"{tag} stochastic", input_ids=prompt, max_new_tokens=FAMILY_NEW_TOKENS,
        temperature=0.6, topp=0.9, repetition_penalty=1.05)
    check(all(0 <= x < vocab for x in res["stochastic"].pop("tokens")),
          f"{tag} token out of range")
    counts = res["stochastic"]["graphed"]["launches"]
    for k in ("embed_gather", "attend_flash"):
        check(counts[k] > 0, f"{tag}: kernel {k} was never launched")
    check_tc_route(counts, tag)
    if across:  # the eager forward's kernels are not in the captured step
        res["by_card"] = kernels_by_card(torch, lambda: eng.generate(
            input_ids=prompt, max_new_tokens=8, temperature=0.0))
        check_every_card(res["by_card"], devices, "kernels", tag)
        res["peak_mem_gb_by_card"] = {str(c): torch.cuda.max_memory_allocated(c) / 2**30
                                      for c in devices}
    else:
        res.update(single_engine_report(torch, dev, eng, prompt, tag,
                                        ("embed_gather", "attend_flash")))
    g = res["stochastic"]["graphed"]
    res.update(tok_per_s=g["tok_per_s"], decode_step_ms=g["decode_step_ms"],
               avg_accept_tokens=g["avg_accept_tokens"], launches=g["launches"])
    res["kernel_shapes"] = family_kernel_shapes(torch, dev, "moe")
    log(f"{tag} {json.dumps(res)}")
    shared["runtimes"] = (t, d)
    del eng
    return res


def shipped_tree(name):
    """A shipped Sequoia tree (the port's copy of umbrella_tpu/trees/`name`)."""
    from umbrella_tpu_torch.speculation.tree import GrowMap

    here = os.path.dirname(os.path.abspath(__file__))
    return GrowMap.from_json(os.path.join(here, "umbrella_tpu_torch", "trees", name))


def moe_batched_lossless(torch, dev):
    """fp32, Mixtral-8x7B widths, 2 layers (the second's o_proj and experts'
    w2 damped x0.05), the draft the first layer (early exit), int8 KV, B=4,
    3x4 tree: BatchedStaticEngine.run() gives each of 5 requests of staggered
    prompt lengths the single-slot engine's tokens (BATCHED_LOSSLESS_TOKENS
    or more). Then expert_parallel 4 over the same weights (the target
    expert-sharded over stage_devices, the MoE draft sharded by the engine):
    run() and the single-slot engine give the unsharded engines' tokens."""
    from umbrella_tpu_torch.models.auto_model import early_exit_runtime
    from umbrella_tpu_torch.models.moe import moe_runtime, shard_runtime_ep
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    tag = "[moe-serve] fp32"
    target = family_runtime(torch, dev, dict(MIXTRAL_HF, num_hidden_layers=2), 61,
                            torch.float32, MAX_LEN, damp_from=1)
    draft = early_exit_runtime(target, 1)
    reqs = [dict(r, input_ids=r["input_ids"][:PROMPT_LEN - PROMPT_LEN // 8 * i])
            for i, r in enumerate(family_requests(3, 5, BATCHED_LOSSLESS_TOKENS,
                                                  MIXTRAL_HF["vocab_size"]))]
    eng = batched_engine(torch, dev, target, draft, 4, (3, 4), "int8", torch.float32)
    reset_launch_counts()
    outs = eng.run(reqs)
    counts = launch_counts()
    graphs = check_graphed(eng, tag)
    check(counts["attend_flash_batched_int8"] > 0, f"{tag} attention never launched")
    del eng
    single = make_engine(torch, dev, target, draft, torch.float32, kv_dtype="int8", tree=(3, 4))
    singles = [single.generate(input_ids=r["input_ids"], max_new_tokens=BATCHED_LOSSLESS_TOKENS)[
        "generated_tokens"] for r in reqs]
    same = [first_difference(o["generated_tokens"], w) for o, w in zip(outs, singles)]
    del single
    devices = stage_devices(torch, dev)
    ep_target = shard_runtime_ep(moe_runtime(target.cfg, target.params, MAX_LEN,
                                             dtype=torch.float32, top_k=target.cfg.
                                             num_experts_per_tok, device=dev), devices)
    ep_draft = early_exit_runtime(target, 1)
    eng = batched_engine(torch, dev, ep_target, ep_draft, 4, (3, 4), "int8", torch.float32,
                         expert_parallel=4)
    check(eng.draft_model.shard_devices == tuple(devices), f"{tag} the MoE draft is not sharded")
    ep_outs = eng.run(reqs)
    ep = dict(run_identical_prefix=[first_difference(e["generated_tokens"], o["generated_tokens"])
                                    for e, o in zip(ep_outs, outs)],
              graphs=graph_stats(eng))
    if len(set(devices)) > 1:
        ep["by_card"] = kernels_by_card(torch, lambda: eng.run([dict(r, max_new_tokens=4)
                                                                for r in reqs[:4]]))
        check_every_card(ep["by_card"], devices, "kernels", tag)
    del eng
    single = make_engine(torch, dev, ep_target, ep_draft, torch.float32, kv_dtype="int8",
                         tree=(3, 4), expert_parallel=4)
    ep["single_identical_prefix"] = [first_difference(single.generate(
        input_ids=r["input_ids"], max_new_tokens=BATCHED_LOSSLESS_TOKENS)["generated_tokens"], w)
        for r, w in zip(reqs[:2], singles)]
    del single, target, draft, ep_target, ep_draft
    res = dict(identical_prefix=same, prompt_lens=[len(r["input_ids"]) for r in reqs],
               avg_accept_tokens=[o["avg_accept_tokens"] for o in outs], graphs=graphs,
               expert_parallel=ep)
    log(f"{tag} {json.dumps(res)}")
    check(min(same) >= BATCHED_LOSSLESS_TOKENS,
          f"{tag} batched and single-slot tokens differ: {same}")
    check(min(ep["run_identical_prefix"] + ep["single_identical_prefix"])
          >= BATCHED_LOSSLESS_TOKENS, f"{tag} expert_parallel 4 parts from the unsharded "
          f"engines: {ep}")
    return res


def moe_serve_phase(torch, dev, dirs, shared):
    """configs/serve_batched_mixtral_ep.json as shipped (expert_parallel 4,
    B=8, int8 KV, 3x4 tree, 8-step segments, max_length 4096) over
    [moe-config]'s expert-sharded runtimes (built and loaded again where
    that phase did not run). In bf16 a slot's rows in run() and in the single-slot engine go
    through products of other row counts, and a last-bit difference before
    the router can swap an expert (a jump in the logits, not a near tie):
    the first MOE_SINGLE_CHECKED requests may part from the single-slot
    engine only at a near tie of the logits or of the router on the rows
    before the parting (router_margins). run() is held to the single-slot
    engine exactly in fp32 (moe_batched_lossless)."""
    from umbrella_tpu_torch.models.auto_model import AutoModelLM

    devices = stage_devices(torch, dev)
    t, d = shared.get("runtimes") or (build_moe_target(
        torch, dev, MIXTRAL_HF["num_hidden_layers"] if len(set(devices)) > 1 else MOE_LAYERS,
        devices), AutoModelLM.from_pretrained(dirs["mistral-7b-v0.3"]["dir"],
                                              max_length=FAMILY_MAX_LEN, device=dev))
    check(t.shard_devices == tuple(devices), "[moe-serve] the target is not expert-sharded")
    cfg = family_config("serve_batched_mixtral_ep.json", t, d, eos_token_ids=[-100])
    del t, d
    res = family_serve_phase(torch, dev, "[moe-serve]", cfg, MIXTRAL_HF["vocab_size"],
                             "attend_flash_batched_int8", router_ties=True,
                             single_checked=MOE_SINGLE_CHECKED)
    del cfg
    shared.clear()
    gc.collect()
    torch.cuda.empty_cache()
    res["fp32"] = moe_batched_lossless(torch, dev)
    return res


def family_phases(torch, dev, phase, phases, prompt):
    """The Gemma2 phases, then the MoE phases; each family's checkpoint
    directories are written under build/ before its phases and deleted
    after them."""
    import shutil
    import tempfile

    from umbrella_tpu_torch.ops.kernels import build

    phase("gemma-lossless", gemma_lossless_check, torch, dev, prompt)
    moe_prompt = family_requests(0, 1, 0, MIXTRAL_HF["vocab_size"])[0]["input_ids"]
    for family, names, models in (
            ("gemma", GEMMA_PHASES[1:], [("gemma-2-9b", GEMMA_9B_HF, 51, 2),
                                          ("gemma-2-2b", GEMMA_2B_HF, 52, 1)]),
            ("moe", MOE_PHASES, [("mistral-7b-v0.3", MISTRAL_HF, 54, 2),
                                  ("mixtral-8x7b", dict(MIXTRAL_HF,
                                                        num_hidden_layers=MOE_CHECKPOINT_LAYERS),
                                   53, 2)])):
        if not set(names) & set(phases):
            continue
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        root = tempfile.mkdtemp(prefix=f"{family}-checkpoints-", dir=build.BUILD_DIR)
        shared = {}
        try:
            dirs = write_family_dirs(torch, dev, root, models, f"[{family}-checkpoints]")
            if family == "gemma":
                phase("gemma-config", gemma_config_phase, torch, dev, dirs, prompt, shared)
                phase("gemma-serve", gemma_serve_phase, torch, dev, dirs, shared)
            else:
                phase("moe-checkpoint", moe_checkpoint_phase, torch, dev, dirs)
                phase("moe-config", moe_config_phase, torch, dev, dirs, moe_prompt, shared)
                phase("moe-serve", moe_serve_phase, torch, dev, dirs, shared)
        finally:
            shared.clear()
            shutil.rmtree(root, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()


GEMMA_PHASES = ("gemma-lossless", "gemma-config", "gemma-serve")
MOE_PHASES = ("moe-checkpoint", "moe-config", "moe-serve")


# ---------------------------------------------------------------- phases: training

TRAIN_CONFIG = "draft/config.json"  # the shipped draft's config, beside this script
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 1024, 30, 3e-4
TRAIN_PERIOD = 61  # the synthetic stream repeats a random phrase of this many tokens
TRAIN_EXIT = 2  # the early-exit draft of the trained model in [train]'s serving check
TRAIN_NEW_TOKENS = 64
PP_TRAIN_MICRO = 4
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 2, 2, 256, 3
MOE_NARROW_I = 1024  # [moe-train]'s fp32 kernel-vs-plain check: experts narrowed to this


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(torch, dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gb(torch, dev):
    """Peak device memory since reset_peak, GB (None off the card)."""
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


def train_cfg(**over):
    """draft/config.json as the port's ModelConfig (fields overridden by `over`)."""
    from umbrella_tpu_torch.config import ModelConfig

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), TRAIN_CONFIG)) as f:
        return ModelConfig.from_dict(dict(json.load(f), **over))


def period_stream(vocab, n_tokens, seed=15):
    """n_tokens of a stream that repeats one random TRAIN_PERIOD-token phrase:
    what a working trainer learns in a few steps (each next token follows
    from the one before once the phrase is learnt)."""
    import numpy as np

    phrase = np.random.default_rng(seed).integers(0, vocab, TRAIN_PERIOD)
    return np.tile(phrase, n_tokens // TRAIN_PERIOD + 1)[:n_tokens].astype(np.int32)


def train_batches(torch, dev, windows, n, seed):
    """n batches of TRAIN_BATCH random windows (train_draft's sampling)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(windows[rng.integers(0, len(windows), TRAIN_BATCH)]).to(dev)
            for _ in range(n)]


@contextlib.contextmanager
def patched(attrs):
    """Set (module, name, value) attributes for the block, then restore them."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in attrs]
    for m, n, v in attrs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def plain_lookup(torch):
    """The training forwards' lookup as the plain version (embed[ids] and its
    autograd) instead of the kernel, for the kernel-vs-plain checks; the port
    itself has no such switch."""
    from umbrella_tpu_torch.ops.kernels.embed_gather import embed_gather_ref
    from umbrella_tpu_torch.training import draft_trainer

    return patched([(draft_trainer, "embed_lookup", lambda embed, ids, dtype=None:
                     embed_gather_ref(embed, ids).to(dtype or embed.dtype))])


def named_leaves(params, prefix=""):
    """(path, tensor) of every leaf of a param tree, in param_leaves' order."""
    if isinstance(params, dict):
        for k, v in params.items():
            yield from named_leaves(v, f"{prefix}/{k}")
    elif isinstance(params, (tuple, list)):
        for i, v in enumerate(params):
            yield from named_leaves(v, f"{prefix}/{i}")
    elif hasattr(params, "dim"):
        yield prefix, params


def step_with_lookup_out(torch, fn, params):
    """fn() -> (loss, *outputs) once, with the embedding lookup's output
    captured: (outputs, grads of every leaf by path, the lookup's ids and
    the loss's gradient at the lookup's output)."""
    from umbrella_tpu_torch.training import draft_trainer

    real, seen = draft_trainer.embed_lookup, {}

    def spy(embed, ids, dtype=None):
        seen["ids"], seen["out"] = ids, real(embed, ids, dtype)
        return seen["out"]

    with patched([(draft_trainer, "embed_lookup", spy)]):
        out = fn()
    names, leaves = zip(*named_leaves(params))
    grads = torch.autograd.grad(out[0], list(leaves) + [seen["out"]])
    return out, dict(zip(names, grads[:-1])), seen["ids"], grads[-1], seen["out"]


def kernel_vs_plain(torch, dev, tag, fn, params, embed_tol, other_tol):
    """One step through the lookup kernel against the same step through the
    plain lookup: fn()'s outputs (the loss, the logits, ...) bit for bit, the
    embedding's gradient non-zero and within embed_tol x its max (None:
    reported only), every other gradient within other_tol x its max. On the card the kernel path
    launches the kernel, returns a tensor with a grad_fn, and the plain path
    launches nothing. Returns the report and the kernel path's capture."""
    from umbrella_tpu_torch.ops.kernels import launch_counts

    n0 = launch_counts()["embed_gather"]
    k_out, k_grads, ids, upstream, looked_up = step_with_lookup_out(torch, fn, params)
    n1 = launch_counts()["embed_gather"]
    with plain_lookup(torch):
        p_out, p_grads, _, _, _ = step_with_lookup_out(torch, fn, params)
    n2 = launch_counts()["embed_gather"]
    if dev.type == "cuda":
        check(n1 > n0 and n2 == n1, f"{tag} kernel path launched {n1 - n0} embed_gather, "
              f"the plain path {n2 - n1}")
    check(looked_up.grad_fn is not None, f"{tag} the kernel's lookup has no grad_fn")
    same = [bool(torch.equal(a, b)) for a, b in zip(k_out, p_out)]
    check(all(same), f"{tag} forward outputs differ between kernel and plain lookup: {same}")
    errs = {}
    for name, g in k_grads.items():
        scale = float(p_grads[name].float().abs().max())
        errs[name] = float((g.float() - p_grads[name].float()).abs().max()) / max(scale, 1e-30)
        tol = embed_tol if name == "/embed" else other_tol
        check(tol is None or errs[name] <= tol,
              f"{tag} gradient {name}: {errs[name]} x max (tolerance {tol})")
    check(float(k_grads["/embed"].abs().max()) > 0, f"{tag} the embedding's gradient is zero")
    return dict(forward_bitwise=True, loss=float(k_out[0].detach()),
                embed_grad_rel_err=errs["/embed"],
                max_other_grad_rel_err=max(v for k, v in errs.items() if k != "/embed"),
                launches_kernel_path=n1 - n0), (k_grads, ids, upstream)


def timed_steps(torch, dev, step, state, batches):
    """Run the train steps over two or more batches; ms a step over all but
    the first (which pays first-call costs), the losses read after the last
    step."""
    losses = []
    for i, b in enumerate(batches):
        if i == 1:
            sync(torch, dev)
            t0 = time.time()
        state, loss = step(state, b)
        losses.append(loss)
    sync(torch, dev)
    return state, [float(x) for x in losses], (time.time() - t0) * 1e3 / (len(batches) - 1)


def fwd_bwd_ms(torch, dev, fn, leaves, n=3):
    """ms of fn()'s loss and its gradient at every leaf (no update), mean of n
    after one warm-up."""
    for i in range(n + 1):
        if i == 1:
            sync(torch, dev)
            t0 = time.time()
        torch.autograd.grad(fn(), leaves)
    sync(torch, dev)
    return (time.time() - t0) * 1e3 / n


def upcast_costs(torch, dev, fn, leaves):
    """What the fp32 upcast in llama._linear and the fp64 norm sums cost a
    train step's forward and backward: its ms as it is, with every dense
    product a bf16 matmul (fp32 accumulation inside cuBLAS), and with the
    norms' sums in fp32 (both patched here for the measurement only)."""
    from umbrella_tpu_torch.models import llama
    from umbrella_tpu_torch.training import draft_trainer

    def bf16_linear(x, w, b=None, act_int8=False):
        y = x @ w.to(x.dtype)
        return y if b is None else y + b.to(x.dtype)

    def fp32_norm(x, w, eps):
        x32 = x.float()
        return (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps) * w.float()
                ).to(x.dtype)

    res = {"as_is_ms": fwd_bwd_ms(torch, dev, fn, leaves)}
    with patched([(llama, "_linear", bf16_linear), (draft_trainer, "_linear", bf16_linear)]):
        res["bf16_products_ms"] = fwd_bwd_ms(torch, dev, fn, leaves)
    with patched([(draft_trainer, "rms_norm", fp32_norm)]):
        res["fp32_norm_sums_ms"] = fwd_bwd_ms(torch, dev, fn, leaves)
    res["upcast_share"] = 1 - res["bf16_products_ms"] / res["as_is_ms"]
    res["fp64_norm_share"] = 1 - res["fp32_norm_sums_ms"] / res["as_is_ms"]
    return res


def train_phase(torch, dev):
    """[train]: draft/config.json at full width, bf16, packed, B 8 x seq 1024,
    lr 3e-4, TRAIN_STEPS steps through train_draft's functions on a periodic
    token stream; the kernel-vs-plain lookup step; then the trained params
    served by the static engine against the AR decode."""
    import numpy as np

    from umbrella_tpu_torch.models.auto_model import ModelRuntime, early_exit_runtime
    from umbrella_tpu_torch.models.convert import serving_params
    from umbrella_tpu_torch.models.llama import StaticModelArgs
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.ops.kernels.embed_gather import embed_gather_backward
    from umbrella_tpu_torch.training import train_draft
    from umbrella_tpu_torch.training.draft_trainer import (lm_loss, map_params, param_leaves,
                                                           train_forward)

    tag = "[train]"
    cfg = train_cfg()
    args = StaticModelArgs.from_config(cfg)
    stream = period_stream(cfg.vocab_size, 64 * TRAIN_SEQ)
    windows = train_draft.windows_of(stream, TRAIN_SEQ)
    t0 = time.time()
    params = train_draft.init_train_params(cfg, TRAIN_SEQ, dev, torch.bfloat16, packed=True,
                                           seed=0)
    sync(torch, dev)
    init_s = time.time() - t0
    n_params = sum(t.numel() for t in param_leaves(params))
    batches = train_batches(torch, dev, windows, TRAIN_STEPS, seed=0)
    ids = batches[0]

    def fn(p=params):
        logits = train_forward(p, args, ids)
        return lm_loss(logits, ids), logits

    # the kernel path against the plain lookup, bf16: the embedding's gradient
    # is checked before its one cast (the plain lookup's bf16 backward rounds
    # at every repeat of a row); then the same step in fp32
    bf16, (k_grads, k_ids, upstream) = kernel_vs_plain(torch, dev, tag + " bf16", fn, params,
                                                       None, 2 ** -7)
    summed = embed_gather_backward(upstream, k_ids, cfg.vocab_size, torch.float32)
    check(torch.equal(summed.to(torch.bfloat16), k_grads["/embed"]),
          f"{tag} the embedding's gradient is not its fp32 sum cast once")
    exact = torch.zeros(summed.shape, dtype=torch.float64, device=dev).index_add_(
        0, k_ids.long(), upstream.double())
    bf16["embed_fp32_sum_rel_err"] = float((summed.double() - exact).abs().max() /
                                           exact.abs().max())
    check(bf16["embed_fp32_sum_rel_err"] <= 1e-3, f"{tag} embed gradient sum: "
          f"{bf16['embed_fp32_sum_rel_err']} x max from the fp64 sum")
    del k_grads, summed, exact, upstream
    p32 = map_params(lambda t: t.detach().float().requires_grad_(), params)
    fp32, _ = kernel_vs_plain(torch, dev, tag + " fp32", lambda: fn(p32), p32, 1e-3, 2 ** -7)
    del p32
    gc.collect()
    torch.cuda.empty_cache()

    state, step = train_draft.make_trainer(cfg, params, TRAIN_LR, TRAIN_STEPS, [dev])
    reset_peak(torch, dev)
    reset_launch_counts()
    state, losses, ms = timed_steps(torch, dev, step, state, batches)
    counts = launch_counts()
    peak = peak_gb(torch, dev)
    check(all(np.isfinite(losses)), f"{tag} non-finite loss: {losses}")
    drop = losses[0] - float(np.mean(losses[-5:]))
    check(drop >= 1.0, f"{tag} the loss fell {drop} nats (at least 1): {losses}")
    check(dev.type != "cuda" or counts["embed_gather"] == TRAIN_STEPS,
          f"{tag} embed_gather launched "
          f"{counts['embed_gather']} times in {TRAIN_STEPS} steps (one lookup a step)")
    costs = upcast_costs(torch, dev, lambda: lm_loss(train_forward(params, args, ids), ids),
                         list(param_leaves(params)))

    # the trained params served: the static engine's greedy decode against the AR decode
    served = map_params(lambda t: t.float(), serving_params(state.params))
    del state, step
    target = ModelRuntime(cfg, served, MAX_LEN, dtype=torch.float32, device=dev)
    draft = early_exit_runtime(target, exit_layer=TRAIN_EXIT)
    eng = make_engine(torch, dev, target, draft, torch.float32)
    start = 7
    prompt = stream[start:start + PROMPT_LEN].tolist()
    out = eng.generate(input_ids=prompt, max_new_tokens=TRAIN_NEW_TOKENS)
    graphs = check_graphed(eng, tag) if dev.type == "cuda" else None
    toks = out["generated_tokens"]
    ar, gaps, _, _ = greedy_ar_decode(torch, target, prompt, len(toks))
    same = first_difference(toks, ar)
    follows = sum(int(t == stream[start + PROMPT_LEN + i])
                  for i, t in enumerate(toks[:TRAIN_NEW_TOKENS]))
    res = dict(params_m=n_params / 1e6, config=TRAIN_CONFIG, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               steps=TRAIN_STEPS, lr=TRAIN_LR, period=TRAIN_PERIOD, losses=losses,
               loss_drop=drop, step_ms=ms, tok_per_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
               peak_mem_gb=peak, kernel_vs_plain_bf16=bf16, kernel_vs_plain_fp32=fp32,
               fwd_bwd_costs=costs, launches=counts,
               launches_per_step={k: n / TRAIN_STEPS for k, n in counts.items()},
               serve=dict(tokens=len(toks), identical_to_ar=same, follow_the_period=follows,
                          avg_accept_tokens=out["avg_accept_tokens"], min_ar_gap=min(gaps),
                          graphs=graphs),
               init_s=init_s)
    log(f"{tag} {json.dumps(res)}")
    check(same >= TRAIN_NEW_TOKENS, f"{tag} spec and AR decode of the trained model differ at "
          f"token {same}: {toks} vs {ar}")
    del eng, draft, target, served
    return res


def train_dp_phase(torch, dev):
    """[train-dp]: [train]'s step in fp32 with dp 2 (two replicas on this
    card, or one a card on a host with two or more) against dp 1: two steps
    from the same params on the same batches; losses within fp32 reordering,
    params after the second step (the first update is at rate 0) within
    1e-3 of that update's rate but for at most 1e-4 of the elements (a
    gradient at fp32's noise may take Adam's step of either sign)."""
    import numpy as np

    from umbrella_tpu_torch.models.convert import trainable_params
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.training import train_draft
    from umbrella_tpu_torch.training.draft_trainer import make_optimizer

    tag = "[train-dp]"
    cfg = train_cfg()
    n_cards = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(2)] if n_cards >= 2 else [dev, dev])
    windows = train_draft.windows_of(period_stream(cfg.vocab_size, 64 * TRAIN_SEQ), TRAIN_SEQ)
    batches = train_batches(torch, dev, windows, 3, seed=1)
    base = train_draft.init_train_params(cfg, TRAIN_SEQ, dev, torch.float32, packed=True,
                                         seed=0)
    runs = {}
    for dp in (1, 2):
        params = trainable_params(base)
        state, step = train_draft.make_trainer(cfg, params, TRAIN_LR, TRAIN_STEPS,
                                               devices[:dp])
        reset_launch_counts()
        state, losses, ms = timed_steps(torch, dev, step, state, batches)
        runs[dp] = dict(losses=losses, step_ms=ms, params=params,
                        launches=launch_counts()["embed_gather"])
        del state, step
    lr1 = make_optimizer(lr=TRAIN_LR, total_steps=TRAIN_STEPS).schedule(1)
    worst, off, n = params_off(torch, dict(named_leaves(runs[2]["params"])),
                               dict(named_leaves(runs[1]["params"])), lr1)
    loss_rel = max(abs(x - y) / abs(x) for x, y in zip(runs[1]["losses"], runs[2]["losses"]))
    res = dict(devices=[str(d) for d in devices], dtype="fp32", losses_dp1=runs[1]["losses"],
               losses_dp2=runs[2]["losses"], max_loss_rel_diff=loss_rel,
               max_param_diff=worst, params_off_by_over_a_thousandth_of_the_rate=off, params=n,
               step_ms_dp1=runs[1]["step_ms"], step_ms_dp2=runs[2]["step_ms"],
               embed_gather_launches_dp2=runs[2]["launches"])
    log(f"{tag} {json.dumps(res)}")
    check(all(np.isfinite(runs[2]["losses"])), f"{tag} non-finite loss")
    check(loss_rel <= 1e-5, f"{tag} dp 2 losses differ from dp 1's by {loss_rel} (relative)")
    check(worst <= 2 * 1.5 * TRAIN_LR and off <= 1e-4 * n,
          f"{tag} params after dp 2 differ from dp 1's: max {worst}, {off} of {n} off by more "
          f"than 1e-3 x the rate {lr1}")
    check(dev.type != "cuda" or runs[2]["launches"] == 2 * len(batches),
          f"{tag} embed_gather launched "
          f"{runs[2]['launches']} times (one a replica a step)")
    return res


def pp_train_phase(torch, dev):
    """[pp-train]: draft width in fp32 over PP_STAGES stages (one a card on a
    host with four, else all on this card), n_micro PP_TRAIN_MICRO: the loss
    and every gradient of one step against the unstaged step's; then ms a
    step of the staged and the unstaged train steps."""
    from umbrella_tpu_torch.models.llama import StaticModelArgs
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.parallel.pipeline import (make_pp_forward, make_pp_train_step,
                                                      shard_params_pp, unstage_params)
    from umbrella_tpu_torch.training import train_draft
    from umbrella_tpu_torch.training.draft_trainer import (causal_lm_loss, init_train_state,
                                                           lm_loss, make_optimizer,
                                                           make_train_step, map_params,
                                                           param_leaves)

    tag = "[pp-train]"
    cfg = train_cfg()
    args = StaticModelArgs.from_config(cfg)
    devices = stage_devices(torch, dev)
    windows = train_draft.windows_of(period_stream(cfg.vocab_size, 64 * TRAIN_SEQ), TRAIN_SEQ)
    batches = train_batches(torch, dev, windows, 3, seed=2)
    params = train_draft.init_train_params(cfg, TRAIN_SEQ, dev, torch.float32, packed=True,
                                           seed=0)
    staged = shard_params_pp(params, devices)
    ids = batches[0]
    reset_launch_counts()
    warned = []
    with no_stream_mismatch(tag, warned):
        loss = lm_loss(make_pp_forward(args, devices, PP_TRAIN_MICRO)(staged, ids), ids)
        loss.backward()
    launches = launch_counts()["embed_gather"]
    ref = causal_lm_loss(params, args, ids)
    ref.backward()
    loss, ref = float(loss.detach()), float(ref.detach())
    loss_rel = abs(loss - ref) / abs(ref)
    errs = rel_errs(dict(named_leaves(unstage_params(staged, lambda t: t.grad))),
                    dict(named_leaves(map_params(lambda t: t.grad, params))))
    for t in list(param_leaves(staged)) + list(param_leaves(params)):
        t.grad = None
    timing = {}
    for name, p, make in (
            ("staged", staged, lambda: make_pp_train_step(args, None, devices, PP_TRAIN_MICRO)),
            ("unstaged", params, lambda: make_train_step(args, None))):
        state = init_train_state(p, make_optimizer(lr=TRAIN_LR, total_steps=TRAIN_STEPS))
        with no_stream_mismatch(tag, warned):
            state, losses, ms = timed_steps(torch, dev, make(), state, batches)
        timing[name] = dict(step_ms=ms, losses=losses)
        del state
    res = dict(stages=[str(d) for d in devices], n_micro=PP_TRAIN_MICRO, dtype="fp32",
               loss=loss, loss_rel_diff=loss_rel, max_grad_rel_err=max(errs.values()),
               grad_rel_err=errs, embed_gather_launches=launches, warnings_seen=sum(warned),
               **timing)
    log(f"{tag} {json.dumps(res)}")
    check(loss_rel <= 1e-5, f"{tag} staged loss differs by {loss_rel} (relative)")
    bad = {k: v for k, v in errs.items() if v > 1e-4}
    check(not bad, f"{tag} gradients off the unstaged step's by more than 1e-4 x max: {bad}")
    check(dev.type != "cuda" or launches == 1,
          f"{tag} embed_gather launched {launches} times in one forward")
    return res


def moe_train_phase(torch, dev):
    """[moe-train]: Mixtral-8x7B widths, MOE_TRAIN_LAYERS of its 32 layers,
    bf16, B 2 x seq 256, MOE_TRAIN_STEPS steps: finite losses and aux loss,
    ms a step; then one fp32 step at 1 layer with experts narrowed to
    MOE_NARROW_I held against the plain lookup."""
    import numpy as np

    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.convert import trainable_params
    from umbrella_tpu_torch.models.llama import StaticModelArgs
    from umbrella_tpu_torch.models.moe import (init_moe_llama_params, make_moe_train_step,
                                               moe_train_forward)
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.training.draft_trainer import (init_train_state, lm_loss,
                                                           make_optimizer)

    tag = "[moe-train]"
    E = MIXTRAL_HF["num_local_experts"]
    cfg = ModelConfig.from_dict(dict(MIXTRAL_HF, num_hidden_layers=MOE_TRAIN_LAYERS))
    args = StaticModelArgs.from_config(cfg)
    gen = torch.Generator(device=dev).manual_seed(21)
    params = trainable_params(init_moe_llama_params(cfg, gen, E, dtype=torch.bfloat16,
                                                    device=dev))
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)).astype(np.int32)).to(dev)
    with torch.no_grad():
        _, aux = moe_train_forward(params, args, ids)
    aux = float(aux)
    state = init_train_state(params, make_optimizer(lr=TRAIN_LR, total_steps=MOE_TRAIN_STEPS))
    reset_peak(torch, dev)
    reset_launch_counts()
    state, losses, ms = timed_steps(torch, dev, make_moe_train_step(args, None), state,
                                    [ids] * MOE_TRAIN_STEPS)
    launches = launch_counts()["embed_gather"]
    peak = peak_gb(torch, dev)
    del state, params
    gc.collect()
    torch.cuda.empty_cache()

    cfg1 = ModelConfig.from_dict(dict(MIXTRAL_HF, num_hidden_layers=1,
                                      intermediate_size=MOE_NARROW_I))
    args1 = StaticModelArgs.from_config(cfg1)
    p1 = trainable_params(init_moe_llama_params(cfg1, gen, E, dtype=torch.float32, device=dev))

    def fn():
        logits, a = moe_train_forward(p1, args1, ids)
        return lm_loss(logits, ids) + 0.01 * a, logits, a

    fp32, _ = kernel_vs_plain(torch, dev, tag + " fp32", fn, p1, 1e-5, 1e-5)
    res = dict(layers=MOE_TRAIN_LAYERS, experts=E, batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ,
               losses=losses, aux_at_init=aux, step_ms=ms, peak_mem_gb=peak,
               embed_gather_launches=launches, kernel_vs_plain_fp32=fp32)
    log(f"{tag} {json.dumps(res)}")
    check(all(np.isfinite(losses)) and np.isfinite(aux) and aux > 0,
          f"{tag} losses {losses}, aux {aux}")
    check(dev.type != "cuda" or launches == MOE_TRAIN_STEPS,
          f"{tag} embed_gather launched {launches} times")
    return res


STREAM_WARNING = "AccumulateGrad node's stream"
TP_TRAIN_STEPS = 3
TP_TRAIN_NEW_TOKENS = 32
MULTIHOST_TRAIN_BATCH = (4, 256)
MULTIHOST_NEW_TOKENS = 24
MULTIHOST_MAX_LEN = 256
MULTIHOST_TIMEOUT = 360  # seconds for both workers, spawn to exit


@contextlib.contextmanager
def no_stream_mismatch(tag, seen_out=None):
    """Record the block's warnings; fail on autograd's "AccumulateGrad
    node's stream does not match" (a leaf handed a gradient made on another
    card's stream). `seen_out` (a list) gets how many warnings were seen."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        yield
    bad = [str(w.message)[:160] for w in seen if STREAM_WARNING in str(w.message)]
    if seen_out is not None:
        seen_out.append(len(seen))
    check(not bad, f"{tag} autograd warned of a stream mismatch: {bad}")


def tp_devices(torch, dev):
    """TP_SHARDS shard devices: one a card on a host with that many, else
    every shard on `dev`."""
    return across_cards(torch) or [dev] * TP_SHARDS


def rel_errs(got: dict, want: dict) -> dict:
    """max |got - want| / max |want| of each leaf (by path)."""
    return {k: float((got[k].float() - w.float()).abs().max()) / max(float(w.abs().max()), 1e-30)
            for k, w in want.items()}


def params_off(torch, got: dict, want: dict, rate: float):
    """(largest difference, elements off by more than 1e-3 x rate, elements)
    of two param trees by path ([train-dp]'s rule)."""
    worst, off, n = 0.0, 0, 0
    for k, w in want.items():
        d = (got[k].detach().float() - w.detach().float()).abs()
        worst = max(worst, float(d.max()))
        off += int((d > 1e-3 * rate).sum())
        n += d.numel()
    return worst, off, n


def card_peaks(torch, devices):
    """Peak GB since the last reset of each distinct card."""
    return {str(d): torch.cuda.max_memory_allocated(d) / 2**30 for d in dict.fromkeys(devices)
            if d.type == "cuda"}


def multihost_launches(res, name):
    """{"multihost_launches_per_step": {process: launches a decode step}} of a
    kernel in [multihost]'s workers' static decode, or {}."""
    got = {p["process"]: p["launches_per_step"][name] for p in res["processes"]
           if p["launches_per_step"].get(name)}
    return {"multihost_launches_per_step": got} if got else {}


def tp_train_phase(torch, dev):
    """[tp-train]: draft/config.json at full width and depth over TP_SHARDS
    shards (on this card, or one a card on four): in fp32, one step's loss and
    every gradient against the unsharded step's (1e-5, 1e-4 x max), SP equal
    to TP bit for bit (the loss, every gradient, three steps' losses and
    params), three steps of TP, SP and the (data 2, model 2) grid against
    three unsharded steps (losses 1e-5, params by [train-dp]'s rule); in bf16,
    ms a step sharded and unsharded, peak GB a card, embed_gather once a
    step; the TP-trained params, gathered, served (fp32, static engine, an
    early-exit draft): spec == AR. On four cards no step warns of a gradient
    on another card's stream."""
    import numpy as np

    from umbrella_tpu_torch.models.auto_model import ModelRuntime, early_exit_runtime
    from umbrella_tpu_torch.models.convert import serving_params, trainable_params
    from umbrella_tpu_torch.models.llama import StaticModelArgs
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.parallel.mesh import gather_train_params, shard_train_params
    from umbrella_tpu_torch.training import train_draft
    from umbrella_tpu_torch.training.data_parallel import make_dp_train_step
    from umbrella_tpu_torch.training.draft_trainer import (causal_lm_loss, init_train_state,
                                                           make_optimizer, make_train_step,
                                                           map_params)

    tag = "[tp-train]"
    cfg = train_cfg()
    args = StaticModelArgs.from_config(cfg)
    devices = tp_devices(torch, dev)
    grid = [devices[:2], devices[2:]] if devices[1] != devices[0] else [[dev] * 2] * 2
    stream = period_stream(cfg.vocab_size, 64 * TRAIN_SEQ)
    windows = train_draft.windows_of(stream, TRAIN_SEQ)
    batches = train_batches(torch, dev, windows, TP_TRAIN_STEPS, seed=4)
    base = train_draft.init_train_params(cfg, TRAIN_SEQ, dev, torch.float32, packed=False,
                                         seed=0)
    ids = batches[0]
    warned = []

    def whole(params):
        return gather_train_params(params) if "tp_shards" in params else \
            map_params(lambda t: t.detach(), params)

    def one_step(params, sp=False):
        loss = causal_lm_loss(params, args, ids, sequence_parallel=sp)
        loss.backward()
        grads = (gather_train_params(params, lambda t: t.grad) if "tp_shards" in params
                 else map_params(lambda t: t.grad, params))
        return loss.detach(), dict(named_leaves(grads))

    ref_loss, ref_grads = one_step(trainable_params(base))
    with no_stream_mismatch(tag, warned):
        tp_loss, tp_grads = one_step(shard_train_params(base, devices))
        sp_loss, sp_grads = one_step(shard_train_params(base, devices), sp=True)
    grad_errs = rel_errs(tp_grads, ref_grads)
    loss_rel = abs(float(tp_loss) - float(ref_loss)) / abs(float(ref_loss))
    sp_same = bool(torch.equal(tp_loss, sp_loss)) and all(
        torch.equal(g, sp_grads[k]) for k, g in tp_grads.items())
    del ref_grads, tp_grads, sp_grads
    gc.collect()
    torch.cuda.empty_cache()

    runs = {}
    for name, make in (
            ("unsharded", lambda: (trainable_params(base), make_train_step(args, None))),
            ("tp", lambda: (shard_train_params(base, devices), make_train_step(args, None))),
            ("sp", lambda: (shard_train_params(base, devices),
                            make_train_step(args, None, sequence_parallel=True))),
            ("grid", lambda: (shard_train_params(base, grid[0]),
                              make_dp_train_step(args, None, grid)))):
        params, step = make()
        state = init_train_state(params, make_optimizer(lr=TRAIN_LR, total_steps=TRAIN_STEPS))
        with no_stream_mismatch(tag, warned):
            state, losses, ms = timed_steps(torch, dev, step, state, batches)
        tree = whole(state.params)
        runs[name] = dict(losses=losses, step_ms=ms, params=dict(named_leaves(tree)),
                          tree=tree if name == "tp" else None)
        del state, step, params
        gc.collect()
        torch.cuda.empty_cache()
    lr1 = make_optimizer(lr=TRAIN_LR, total_steps=TRAIN_STEPS).schedule(1)
    want = runs["unsharded"]
    steps_res = {}
    for name in ("tp", "sp", "grid"):
        r = runs[name]
        worst, off, n = params_off(torch, r["params"], want["params"], lr1)
        steps_res[name] = dict(losses=r["losses"], step_ms=r["step_ms"], max_param_diff=worst,
                               params_off=off, params=n, max_loss_rel_diff=max(
                                   abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                                       want["losses"])))
    sp_steps_same = runs["sp"]["losses"] == runs["tp"]["losses"] and all(
        torch.equal(t, runs["sp"]["params"][k]) for k, t in runs["tp"]["params"].items())
    trained = runs["tp"]["tree"]
    del runs
    gc.collect()
    torch.cuda.empty_cache()

    # bf16: ms a step sharded and not, peak GB a card, the lookup once a step
    timing = {}
    for name in ("unsharded", "tp"):
        p16 = train_draft.init_train_params(cfg, TRAIN_SEQ, dev, torch.bfloat16, packed=False,
                                            seed=0)
        if name == "tp":
            p16 = shard_train_params(p16, devices)
        state = init_train_state(p16, make_optimizer(lr=TRAIN_LR, total_steps=TRAIN_STEPS))
        for d in dict.fromkeys(devices):
            reset_peak(torch, d)
        reset_launch_counts()
        with no_stream_mismatch(tag, warned):
            state, losses, ms = timed_steps(torch, dev, make_train_step(args, None), state,
                                            batches)
        timing[name] = dict(step_ms=ms, tok_per_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
                            losses=losses, peak_gb_by_card=card_peaks(torch, devices),
                            embed_gather=launch_counts()["embed_gather"])
        del state, p16
        gc.collect()
        torch.cuda.empty_cache()
    launches = timing["tp"]["embed_gather"]

    # the TP-trained params, gathered, served: spec == AR
    target = ModelRuntime(cfg, serving_params(trained), MAX_LEN, dtype=torch.float32, device=dev)
    draft = early_exit_runtime(target, exit_layer=TRAIN_EXIT)
    eng = make_engine(torch, dev, target, draft, torch.float32)
    start = 11
    prompt = stream[start:start + PROMPT_LEN].tolist()
    out = eng.generate(input_ids=prompt, max_new_tokens=TP_TRAIN_NEW_TOKENS)
    if dev.type == "cuda":
        check_graphed(eng, tag)
    toks = out["generated_tokens"]
    ar, _, _, _ = greedy_ar_decode(torch, target, prompt, len(toks))
    same = first_difference(toks, ar)
    del eng, draft, target, trained
    res = dict(devices=[str(d) for d in devices], grid=[[str(d) for d in r] for r in grid],
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TP_TRAIN_STEPS,
               one_step=dict(loss=float(ref_loss), tp_loss_rel_diff=loss_rel,
                             max_grad_rel_err=max(grad_errs.values()), grad_rel_err=grad_errs,
                             sp_bitwise_tp=sp_same),
               three_steps=dict(steps_res, unsharded_losses=want["losses"],
                                unsharded_step_ms=want["step_ms"],
                                sp_bitwise_tp=sp_steps_same),
               bf16=timing, embed_gather_launches=launches,
               launches_per_step={"embed_gather": launches / TP_TRAIN_STEPS},
               warnings_seen=sum(warned),
               serve=dict(tokens=len(toks), identical_to_ar=same,
                          avg_accept_tokens=out["avg_accept_tokens"]))
    log(f"{tag} {json.dumps(res)}")
    check(loss_rel <= 1e-5, f"{tag} TP loss {float(tp_loss)} vs {float(ref_loss)}")
    bad = {k: v for k, v in grad_errs.items() if v > 1e-4}
    check(not bad, f"{tag} TP gradients off the unsharded step's by more than 1e-4 x max: {bad}")
    check(sp_same and sp_steps_same, f"{tag} SP is not TP bit for bit")
    for name, r in steps_res.items():
        check(all(np.isfinite(r["losses"])) and r["max_loss_rel_diff"] <= 1e-5,
              f"{tag} {name} losses {r['losses']} vs {want['losses']}")
        check(r["max_param_diff"] <= 2 * 1.5 * TRAIN_LR and r["params_off"] <= 1e-4 * r["params"],
              f"{tag} {name} params after {TP_TRAIN_STEPS} steps: {r}")
    check(dev.type != "cuda" or launches == TP_TRAIN_STEPS,
          f"{tag} embed_gather launched {launches} times in "
          f"{TP_TRAIN_STEPS} steps (one lookup a step)")
    check(same >= TP_TRAIN_NEW_TOKENS, f"{tag} the TP-trained draft: spec {toks} vs AR {ar}")
    return res


def ep_train_phase(torch, dev):
    """[ep-train]: Mixtral-8x7B widths, MOE_TRAIN_LAYERS of its 32 layers,
    bf16, experts sharded in TP_SHARDS (on this card, or one a card on four),
    B 2 x 256, MOE_TRAIN_STEPS steps: finite losses, ms a step, peak GB a card,
    embed_gather once a step; then one fp32 step at 1 layer (experts narrowed
    to MOE_NARROW_I) expert-sharded against unsharded: the loss within 1e-5,
    every gradient within 1e-4 x max."""
    import numpy as np

    from umbrella_tpu_torch.config import ModelConfig
    from umbrella_tpu_torch.models.convert import trainable_params
    from umbrella_tpu_torch.models.llama import StaticModelArgs
    from umbrella_tpu_torch.models.moe import (gather_params_ep, init_moe_llama_params,
                                               make_moe_train_step, moe_train_forward,
                                               shard_params_ep)
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.training.draft_trainer import (init_train_state, lm_loss,
                                                           make_optimizer, map_params)

    tag = "[ep-train]"
    E = MIXTRAL_HF["num_local_experts"]
    devices = tp_devices(torch, dev)
    cfg = ModelConfig.from_dict(dict(MIXTRAL_HF, num_hidden_layers=MOE_TRAIN_LAYERS))
    args = StaticModelArgs.from_config(cfg)
    gen = torch.Generator(device=dev).manual_seed(21)
    params = shard_params_ep(trainable_params(init_moe_llama_params(
        cfg, gen, E, dtype=torch.bfloat16, device=dev)), devices)
    gc.collect()
    torch.cuda.empty_cache()
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)).astype(np.int32)).to(dev)
    state = init_train_state(params, make_optimizer(lr=TRAIN_LR, total_steps=MOE_TRAIN_STEPS))
    for d in dict.fromkeys(devices):
        reset_peak(torch, d)
    reset_launch_counts()
    warned = []
    with no_stream_mismatch(tag, warned):
        state, losses, ms = timed_steps(torch, dev, make_moe_train_step(args, None), state,
                                        [ids] * MOE_TRAIN_STEPS)
    launches = launch_counts()["embed_gather"]
    peaks = card_peaks(torch, devices)
    del state, params
    gc.collect()
    torch.cuda.empty_cache()

    cfg1 = ModelConfig.from_dict(dict(MIXTRAL_HF, num_hidden_layers=1,
                                      intermediate_size=MOE_NARROW_I))
    args1 = StaticModelArgs.from_config(cfg1)
    base = init_moe_llama_params(cfg1, gen, E, dtype=torch.float32, device=dev)
    out = {}
    for name in ("unsharded", "ep"):
        p = trainable_params(base)
        if name == "ep":
            p = shard_params_ep(p, devices)
        with no_stream_mismatch(tag, warned):
            logits, aux = moe_train_forward(p, args1, ids)
            loss = lm_loss(logits, ids) + 0.01 * aux
            loss.backward()
        grads = gather_params_ep(p, lambda t: t.grad) if name == "ep" else \
            map_params(lambda t: t.grad, p)
        out[name] = (float(loss.detach()), dict(named_leaves(grads)))
        del p, logits, aux, loss
    loss_rel = abs(out["ep"][0] - out["unsharded"][0]) / abs(out["unsharded"][0])
    errs = rel_errs(out["ep"][1], out["unsharded"][1])
    res = dict(devices=[str(d) for d in devices], layers=MOE_TRAIN_LAYERS, experts=E,
               batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ, losses=losses, step_ms=ms,
               peak_gb_by_card=peaks, embed_gather_launches=launches,
               launches_per_step={"embed_gather": launches / MOE_TRAIN_STEPS},
               fp32_one_layer=dict(loss=out["unsharded"][0], loss_rel_diff=loss_rel,
                                   max_grad_rel_err=max(errs.values()), grad_rel_err=errs),
               warnings_seen=sum(warned))
    log(f"{tag} {json.dumps(res)}")
    check(all(np.isfinite(losses)), f"{tag} losses {losses}")
    check(dev.type != "cuda" or launches == MOE_TRAIN_STEPS,
          f"{tag} embed_gather launched {launches} times")
    check(loss_rel <= 1e-5, f"{tag} EP loss {out['ep'][0]} vs {out['unsharded'][0]}")
    bad = {k: v for k, v in errs.items() if v > 1e-4}
    check(not bad, f"{tag} EP gradients off the unsharded step's by more than 1e-4 x max: {bad}")
    return res


def multihost_phase(torch, dev):
    """[multihost]: the port's launcher (examples/multihost_demo.launch)
    spawns two workers (examples/multihost_worker.py): two cards each on a
    host with four (NCCL), both on this card otherwise (gloo). Each trains
    the (data 2, model 2) grid at draft/config.json's width (fp32, B 4 x 256,
    3 steps; the data axis across the processes), then runs a static engine
    with tensor_parallel 4 across the processes (2 shards each) over a random
    AWQ Llama-3.3-70B at full width and TP_LOSSLESS_LAYERS layers (bf16, from
    one seed, as [tp-lossless]) with a 2-layer draft at Llama-3.2-1B widths,
    and the batched engine (B=2) over the same models. Losses identical on
    both and the one-process grid's; greedy tokens identical on both and the
    one-process tensor_parallel 4 engine's, the prompt's logits bit for bit;
    batched tokens identical on both."""
    import tempfile

    from umbrella_tpu_torch.examples import multihost_worker as worker
    from umbrella_tpu_torch.examples.multihost_demo import launch
    from umbrella_tpu_torch.ops.kernels import build

    tag = "[multihost]"
    per = (["cuda:0,cuda:1", "cuda:2,cuda:3"] if torch.cuda.device_count() >= 4
           else [f"{dev},{dev}"] * 2)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="multihost-", dir=build.BUILD_DIR)
    tcfg = dict(CFG_70B, num_hidden_layers=TP_LOSSLESS_LAYERS)
    dcfg = dict(CFG_1B, num_hidden_layers=2)
    paths = {}
    for name, c in (("target", tcfg), ("draft", dcfg)):
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(c, f)
    train_config = os.path.join(os.path.dirname(os.path.abspath(__file__)), TRAIN_CONFIG)
    batch = ",".join(map(str, MULTIHOST_TRAIN_BATCH))
    t0 = time.time()
    r0, r1 = launch(["--train-config", train_config, "--train-batch", batch,
                     "--random-target", paths["target"], "--random-draft", paths["draft"],
                     "--dtype", "bfloat16", "--tensor-parallel", str(TP_SHARDS),
                     "--max-length", str(MULTIHOST_MAX_LEN),
                     "--new-tokens", str(MULTIHOST_NEW_TOKENS)], per, root,
                    timeout=MULTIHOST_TIMEOUT,
                    # both workers are on this host: NCCL's bootstrap on the loopback
                    env=dict(os.environ, NCCL_SOCKET_IFNAME="lo"))
    wall = time.time() - t0
    for r in (r0, r1):
        log(f"{tag} process {r['process_id']}: backend {r['backend']} on {r['devices']}")

    # one process: the same grid, and the same engines over the same weights
    rows = [[torch.device(d) for d in p.split(",")] for p in per]
    grid_one = worker.train_grid(train_cfg(), rows, None, MULTIHOST_TRAIN_BATCH, 3)
    losses = grid_one["losses"]
    gc.collect()
    torch.cuda.empty_cache()
    target, draft = worker.random_models(tcfg, dcfg, [d for r in rows for d in r], None,
                                         torch.bfloat16, MULTIHOST_MAX_LEN)
    one = worker.static_decode(target, draft, TP_SHARDS, dev, torch.bfloat16, MULTIHOST_MAX_LEN,
                               MULTIHOST_NEW_TOKENS)
    batched = worker.batched_decode(target, draft, TP_SHARDS, dev, torch.bfloat16,
                                    MULTIHOST_MAX_LEN)
    del target, draft
    logits_equal = [bool(torch.equal(torch.load(os.path.join(root, f"worker{i}.json.logits.pt")),
                                     one["logits"])) for i in (0, 1)]
    per_proc = [dict(process=r["process_id"], backend=r["backend"], devices=r["devices"],
                     spawn_to_ready_s=r["spawn_to_ready_s"], train_s=r["train_s"],
                     train_step_ms=r["train_step_ms"],
                     decode_step_ms=r["static"]["step_ms"], steps=r["static"]["steps"],
                     gathers_per_forward=r["static"]["gathers_per_forward"],
                     gathers_per_step=r["static"]["gathers_in_generate"] / r["static"]["steps"],
                     launches_per_step={k: n / r["static"]["steps"]
                                        for k, n in r["static"]["launches"].items()})
                for r in (r0, r1)]
    res = dict(layout=per, wall_s=wall, processes=per_proc, losses=r0["losses"],
               one_process_losses=losses, one_process_train_step_ms=grid_one["step_ms"],
               tokens=len(r0["committed"]),
               identical_across_processes=r0["committed"] == r1["committed"],
               identical_to_one_process=first_difference(r0["committed"], one["tokens"]),
               prompt_logits_bitwise=logits_equal,
               one_process_decode_step_ms=one["step_ms"],
               batched_identical_across_processes=r0["batched"] == r1["batched"],
               batched_identical_to_one_process=r0["batched"] == batched)
    log(f"{tag} {json.dumps(res)}")
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    check(r0["backend"] == ("nccl" if len(set(per)) > 1 else "gloo"),
          f"{tag} backend {r0['backend']} for the layout {per}")
    check(r0["losses"] == r1["losses"] == losses,
          f"{tag} losses {r0['losses']} / {r1['losses']} vs one process {losses}")
    check(res["identical_across_processes"] and
          res["identical_to_one_process"] >= len(one["tokens"]) == len(r0["committed"]),
          f"{tag} tokens {r0['committed']} / {r1['committed']} vs one process {one['tokens']}")
    check(all(logits_equal), f"{tag} the prompt's logits are not the one-process bits")
    check(res["batched_identical_across_processes"] and all(len(t) > 0 for t in r0["batched"]),
          f"{tag} batched tokens {r0['batched']} / {r1['batched']}")
    for p in per_proc if dev.type == "cuda" else ():
        for name in ("attend_flash", "w4a16_matmul", "embed_gather"):
            check(p["launches_per_step"].get(name, 0) > 0,
                  f"{tag} process {p['process']} never launched {name}")
    return res


TRAIN_PHASES = ("train", "train-dp", "pp-train", "moe-train", "tp-train", "ep-train", "multihost")


# ---------------------------------------------------------------- the example scripts

# umbrella_tpu_torch/examples/: each phase calls an example's measuring function
# on an engine or runtime built here (the checkpoints above, WordTokenizer)
EXAMPLE_NEW_TOKENS = 32  # spec_bench's and spec_bench_python's (the scripts' 256 / 512)
SPEC_BENCH_QUESTIONS = 3  # --limit 3: 6 turns over 3 categories
SERVE_BF16_REQUESTS, SERVE_BF16_NEW_TOKENS = 16, 24
AR_NEW_TOKENS = 64  # the AR baseline's (the script's 128)
BENCH_PREFIX, BENCH_DECODE, BENCH_ITERS = 512, 32, 20
BENCH_OFFLOAD_CACHED = 4  # of the 8B AutoAWQ directory's 8 layers
SEQUOIA_BEAMS, SEQUOIA_TREE, SEQUOIA_NEW_TOKENS = 8, (5, 6), 16
SOAK_BATCH, SOAK_REQUESTS, SOAK_NEW_TOKENS = 32, 64, 64  # the script's: 8, 32, 128
SOAK_PROMPTS = (32, 256)


def example_engine(torch, dev, name, ckpt, target):
    """A shipped config's engine (model, draft_model and growmap_path
    rewritten) as the examples build it, with WordTokenizer: (engine, the
    config's template, its scheduler key or None, init s)."""
    from umbrella_tpu_torch.examples import engine_config
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine

    cfg = shipped_config(name, ckpt, target)
    template = cfg.pop("template", "meta-llama3")
    sched_cfg = cfg.pop("scheduler", None)
    for k in ("generation_length", "max_turns"):
        cfg.pop(k, None)
    t0 = time.time()
    eng = AutoEngine.from_config(device=dev, tokenizer=WordTokenizer(), **engine_config(cfg))
    eng.initialize()
    torch.cuda.synchronize()
    return eng, template, sched_cfg, time.time() - t0


def recorded_decodes(eng):
    """Wrap eng.speculative_decoding to keep (context ids, new tokens) of
    each call, for check_not_degenerate."""
    decodes, decode = [], eng.speculative_decoding

    def record(n):
        start = eng.num_nodes
        dec_len, elapsed, steps = decode(n)
        decodes.append((eng.tokens_host[:start].tolist(),
                        eng.tokens_host[start:start + dec_len].tolist()))
        return dec_len, elapsed, steps

    eng.speculative_decoding = record
    return decodes


def check_decodes(tag, decodes, eos, n_new, vocab=128256):
    for _, toks in decodes:
        check(len(toks) >= n_new or toks[-1] in eos, f"{tag} a decode stopped at {len(toks)}")
        check(all(0 <= t < vocab for t in toks), f"{tag} token out of range")


def check_launched(tag, counts, names, bf16=True):
    for name in names:
        check(counts[name] > 0, f"{tag} kernel {name} was never launched")
    if bf16:
        check_tc_route(counts, tag)


def dense_bf16_target(torch, tag, eng, ckpt):
    from umbrella_tpu_torch.quantization.awq import has_awq_layers

    t = eng.target_model
    check(not has_awq_layers(t.params["layers"]) and t.params["lm_head"].dtype == torch.bfloat16
          and t.args.n_layers == ckpt["target_layers"]
          and t.cfg.hidden_size == TARGET_BF16_HF_CONFIG["hidden_size"],
          f"{tag} the target is not the bf16 Llama-3.1-8B directory")


def spec_bench_phase(torch, dev, ckpt):
    """configs/chat_config_8b_v5e.json as shipped over the bf16 Llama-3.1-8B
    directory and the Llama-3.2-1B one: spec_generate once, then spec_bench
    over the port's question.jsonl (3 questions, 6 turns)."""
    from umbrella_tpu_torch.examples import DATA_DIR
    from umbrella_tpu_torch.examples.spec_bench import load_questions, spec_bench
    from umbrella_tpu_torch.examples.spec_generate import spec_generate
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    tag = "[spec-bench]"
    torch.cuda.reset_peak_memory_stats(dev)
    eng, template, _, init_s = example_engine(torch, dev, "chat_config_8b_v5e.json", ckpt,
                                              "target-bf16")
    dense_bf16_target(torch, tag, eng, ckpt)
    check(type(eng).__name__ == "StaticEngine" and eng.tree_size == 31
          and (eng.temperature, eng.topp, eng.topk, eng.repetition_penalty)
          == (0.6, 0.9, 32, 1.05), f"{tag} the config was not taken as shipped")
    decodes = recorded_decodes(eng)
    reset_launch_counts()
    gen = spec_generate(eng, template, "Explain the idea of speculative decoding.",
                        EXAMPLE_NEW_TOKENS)
    gen_counts = launch_counts()
    eng.reset()
    questions = load_questions(os.path.join(DATA_DIR, "question.jsonl"))[:SPEC_BENCH_QUESTIONS]
    reset_launch_counts()
    stats = spec_bench(eng, questions, template, EXAMPLE_NEW_TOKENS)
    counts = launch_counts()
    for c in (gen_counts, counts):
        check_launched(tag, c, ("embed_gather", "attend_flash"))
        check(c["w4a16_matmul"] == 0, f"{tag} a W4 kernel ran on the bf16 pair")
    cats = sorted(q["category"] for q in questions)
    check(sorted(stats["categories"]) == cats and len(decodes) == 1 + 2 * len(questions),
          f"{tag} categories {sorted(stats['categories'])} from {len(decodes)} decodes")
    check_decodes(tag, decodes, set(eng.eos_token_ids), EXAMPLE_NEW_TOKENS)
    total = stats["total"]
    guard = check_not_degenerate(tag, decodes, accept=total["avg_accept_tokens"],
                                 max_accept=eng.tree_depth)
    graphs = check_graphed(eng, tag)
    res = dict(config="chat_config_8b_v5e.json", init_s=init_s, spec_generate=gen,
               categories=stats["categories"], total=total, degenerate_guard=guard,
               launches=counts, launches_spec_generate=gen_counts,
               launches_per_step={k: n / max(total["steps"], 1) for k, n in counts.items()},
               graphs=graphs, peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"{tag} {json.dumps(res)}")
    del eng
    return res


def spec_bench_code_phase(torch, dev, ckpt):
    """configs/code_config_8b_awq_v5e.json over the 8B AutoAWQ directory
    (quantize_draft: a W4 1B draft), through spec_bench_python's five
    default prompts."""
    from umbrella_tpu_torch.examples.spec_bench_python import DEFAULT_PROMPTS, spec_bench_python
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    tag = "[spec-bench-code]"
    torch.cuda.reset_peak_memory_stats(dev)
    eng, template, _, init_s = example_engine(torch, dev, "code_config_8b_awq_v5e.json", ckpt,
                                              "target")
    decodes = recorded_decodes(eng)
    reset_launch_counts()
    stats = spec_bench_python(eng, DEFAULT_PROMPTS, template, EXAMPLE_NEW_TOKENS)
    counts = launch_counts()
    check(stats["kept"] == list(range(len(DEFAULT_PROMPTS))) and len(decodes) == 5,
          f"{tag} prompts kept {stats['kept']}")
    check_launched(tag, counts, ("embed_gather", "attend_flash", "w4a16_matmul"))
    check_decodes(tag, decodes, set(eng.eos_token_ids), EXAMPLE_NEW_TOKENS)
    guard = check_not_degenerate(tag, decodes, accept=stats["avg_accept_tokens"],
                                 max_accept=eng.tree_depth)
    graphs = check_graphed(eng, tag)
    res = dict(config="code_config_8b_awq_v5e.json", init_s=init_s, stats=stats,
               degenerate_guard=guard, launches=counts,
               launches_per_step={k: n / max(stats["steps"], 1) for k, n in counts.items()},
               graphs=graphs, peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"{tag} {json.dumps(res)}")
    del eng
    return res


def serve_config_bf16_phase(torch, dev, ckpt):
    """configs/serve_batched_8b_v5e.json as shipped (batched_static, B=8,
    3x4, temperature 0.6, top-p 0.9, top-k 32, its "scheduler" key) over the
    bf16 Llama-3.1-8B / Llama-3.2-1B pair: requests through make_scheduler
    in front of a ContinuousBatcher."""
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.serving.batched_engine import ContinuousBatcher
    from umbrella_tpu_torch.serving.scheduler import make_scheduler

    tag = "[serve-config-bf16]"
    torch.cuda.reset_peak_memory_stats(dev)
    eng, _, sched_cfg, init_s = example_engine(torch, dev, "serve_batched_8b_v5e.json", ckpt,
                                               "target-bf16")
    dense_bf16_target(torch, tag, eng, ckpt)
    check(type(eng).__name__ == "BatchedStaticEngine" and eng.batch_size == 8
          and eng.tree_size == 13 and not eng.kv_target.quantized and sched_cfg == {}
          and (eng.temperature, eng.topp, eng.topk) == (0.6, 0.9, 32),
          f"{tag} the config was not taken as shipped")
    reqs = random_requests(17, SERVE_BF16_REQUESTS, SERVE_BF16_NEW_TOKENS)
    eng.run([dict(r, max_new_tokens=4) for r in reqs[:2]])  # warm-up: captures the segment
    batcher = ContinuousBatcher(eng)
    batcher.start()
    sched = make_scheduler(batcher=batcher, workers=sched_cfg.get("workers"))
    sched.start()
    reset_launch_counts()
    steps0 = eng.steps_dispatched
    t0 = time.time()
    futs = [sched.submit(priority=1 + i % 3, **r) for i, r in enumerate(reqs)]
    outs = [f.result(timeout=300) for f in futs]
    wall = time.time() - t0
    counts = launch_counts()
    metrics = sched.snapshot_metrics()
    sched.shutdown(wait=False)
    batcher.shutdown()
    steps = eng.steps_dispatched - steps0
    eos = set(eng.eos_token_ids)
    for o in outs:
        toks = o["generated_tokens"]
        check(len(toks) <= SERVE_BF16_NEW_TOKENS + 1 and (
            len(toks) >= SERVE_BF16_NEW_TOKENS or toks[-1] in eos),
            f"{tag} request got {len(toks)} tokens")
        check(all(0 <= t < 128256 for t in toks), f"{tag} token out of range")
    check_launched(tag, counts, ("embed_gather", "attend_flash_batched"))
    check(counts["w4a16_matmul"] == 0, f"{tag} a W4 kernel ran on the bf16 pair")
    guard = check_not_degenerate(tag, [(r["input_ids"], o["generated_tokens"])
                                       for r, o in zip(reqs, outs)])
    graphs = check_graphed(eng, tag)
    res = dict(config="serve_batched_8b_v5e.json", init_s=init_s, requests=len(reqs),
               tok_per_s=sum(len(o["generated_tokens"]) for o in outs) / wall, wall_s=wall,
               steps=steps, avg_accept_tokens=sum(o["avg_accept_tokens"] for o in outs) / len(outs),
               ttft_ms_p50=pct([o["ttft_ms"] for o in outs], 50),
               scheduler={k: metrics[k] for k in ("requests", "priority_inversions")},
               degenerate_guard=guard, launches=counts,
               launches_per_step={k: n / max(steps, 1) for k, n in counts.items()},
               graphs=graphs, peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"{tag} {json.dumps(res)}")
    del eng, batcher, sched
    return res


def generate_phase(torch, dev, ckpt):
    """The AR baseline (examples/generate.autoregressive_decode) on the
    Llama-3.2-1B directory at its full 16 layers: 64 greedy tokens, graphed,
    equal to the plain stepwise AR decode; 16 sampled ones start with the
    prefill's argmax. Then examples/bench's step: the 1B resident (prefix
    512, 32 tokens, one CUDA graph) and the 8B AutoAWQ directory with offload
    (4 layers resident, the rest streamed)."""
    from umbrella_tpu_torch.examples.bench import bench_step
    from umbrella_tpu_torch.examples.generate import autoregressive_decode
    from umbrella_tpu_torch.models.auto_model import AutoModelLM
    from umbrella_tpu_torch.offload.streaming import OffloadModelRuntime
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    tag = "[generate]"
    rt = AutoModelLM.from_pretrained(ckpt["dirs"]["draft"], max_length=MAX_LEN, device=dev)
    check(rt.args.n_layers == DRAFT_HF_CONFIG["num_hidden_layers"], f"{tag} not the whole 1B")
    ids = WordTokenizer().encode("Tell me what you know about Reinforcement Learning in 100 "
                                 "words.")
    reset_launch_counts()
    toks, tpot = autoregressive_decode(rt, ids, max_new_tokens=AR_NEW_TOKENS)
    ar_counts = launch_counts()
    want = greedy_ar_decode(torch, rt, ids, AR_NEW_TOKENS)[0]
    check(toks == want, f"{tag} the graphed AR decode parts from the stepwise one at token "
          f"{first_difference(toks, want)}")
    check_decodes(tag, [(ids, toks)], set(), AR_NEW_TOKENS)
    sampled, _ = autoregressive_decode(rt, ids, max_new_tokens=16, greedy=False)
    check(sampled[0] == toks[0] and len(sampled) == 16, f"{tag} sampled decode's first token")
    # forwards: the prefill, the capture's eager run, 63 replays
    check_launched(tag, ar_counts, ("embed_gather", "attend_flash"))
    reset_launch_counts()
    step = bench_step(rt, BENCH_PREFIX, BENCH_DECODE, BENCH_ITERS)
    step_counts = launch_counts()
    check_launched(tag, step_counts, ("embed_gather", "attend_flash"))
    del rt
    torch.cuda.empty_cache()
    cached = min(BENCH_OFFLOAD_CACHED, ckpt["target_layers"] // 2)
    off = AutoModelLM.from_pretrained(ckpt["dirs"]["target"], offload=True, max_length=MAX_LEN,
                                      num_cache_layers=cached, device=dev)
    check(isinstance(off, OffloadModelRuntime) and off.n_resident == cached and off.n_streamed,
          f"{tag} --offload did not give an offload runtime")
    reset_launch_counts()
    off_step = bench_step(off, BENCH_PREFIX, BENCH_DECODE, BENCH_ITERS)
    off_counts = launch_counts()
    check_launched(tag, off_counts, ("embed_gather", "attend_flash", "w4a16_matmul"))
    res = dict(tokens=len(toks), tpot_ms=tpot, ar_tok_per_s=1000 / tpot, identical_to_ar=True,
               launches=ar_counts,
               launches_per_step={k: n / (AR_NEW_TOKENS + 1) for k, n in ar_counts.items()},
               bench=step, bench_launches=step_counts,
               bench_offload=dict(off_step, n_resident=off.n_resident,
                                  n_streamed=off.n_streamed),
               bench_offload_launches=off_counts)
    log(f"{tag} {json.dumps(res)}")
    del off
    return res


def construct_sequoia_phase(torch, dev, ckpt):
    """examples/construct_sequoia: the 1B draft's positional acceptance
    against the 8B AutoAWQ target over DEFAULT_TEXTS (WordTokenizer ids), 8
    beams; the 5x6 tree built from it into build/, loaded through
    speculation/tree.GrowMap, drives one static-engine request."""
    from umbrella_tpu_torch.examples.construct_sequoia import DEFAULT_TEXTS, measure_acceptance
    from umbrella_tpu_torch.models.auto_model import AutoModelLM
    from umbrella_tpu_torch.ops.kernels import build, launch_counts, reset_launch_counts
    from umbrella_tpu_torch.sequoia import generate_sequoia_tree
    from umbrella_tpu_torch.speculation.auto_engine import AutoEngine
    from umbrella_tpu_torch.speculation.tree import GrowMap

    tag = "[construct-sequoia]"
    L = 1024
    target = AutoModelLM.from_pretrained(ckpt["dirs"]["target"], max_length=L, device=dev)
    draft = AutoModelLM.from_pretrained(ckpt["dirs"]["draft"], max_length=L, device=dev)
    seqs = [WordTokenizer().encode(t) for t in DEFAULT_TEXTS]
    reset_launch_counts()
    t0 = time.time()
    acc = measure_acceptance(draft, target, seqs, num_beams=SEQUOIA_BEAMS, max_len=L)
    measure_s = time.time() - t0
    counts = launch_counts()
    check(len(acc) == SEQUOIA_BEAMS and all(0.0 <= a <= 1.0 for a in acc) and sum(acc) <= 1.0,
          f"{tag} acceptance vector {acc}")
    check_launched(tag, counts, ("embed_gather", "attend_flash", "w4a16_matmul"))
    w, d = SEQUOIA_TREE
    path = os.path.join(build.BUILD_DIR, f"sequoia_tree-{w}x{d}.json")
    tree = generate_sequoia_tree(w, d, acc=acc, json_file=path)
    gm = GrowMap.from_json(path)
    gm.validate()
    check(gm.size == tree["size"] == 1 + w * d, f"{tag} tree of {gm.size} nodes")
    eng = AutoEngine.from_config(device=dev, engine="static", model=target, draft_model=draft,
                                 growmap_path=path, max_length=L, temperature=0.0)
    eng.initialize()
    reset_launch_counts()
    out = eng.generate(input_ids=seqs[1], max_new_tokens=SEQUOIA_NEW_TOKENS)
    eng_counts = launch_counts()
    check_decodes(tag, [(seqs[1], out["generated_tokens"])], set(eng.eos_token_ids),
                  SEQUOIA_NEW_TOKENS)
    check_launched(tag, eng_counts, ("embed_gather", "attend_flash", "w4a16_matmul"))
    check_graphed(eng, tag)
    res = dict(acceptance=acc, tokens_measured=sum(len(s) for s in seqs), measure_s=measure_s,
               tree=os.path.relpath(path, os.path.dirname(os.path.abspath(__file__))),
               tree_size=gm.size, request_tokens=len(out["generated_tokens"]),
               request_accept=out["avg_accept_tokens"], launches=counts,
               launches_per_sequence={k: n / len(seqs) for k, n in counts.items()},
               engine_launches=eng_counts)
    log(f"{tag} {json.dumps(res)}")
    del eng, target, draft
    return res


def bench_70b_phase(torch, dev):
    """examples/bench_70b.measure() at Llama-3.x-70B width on this card:
    its JSON line, slope-timed layer and head."""
    import math

    from umbrella_tpu_torch.examples.bench_70b import measure
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    tag = "[bench-70b]"
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.time()
    res = measure(device=dev)
    wall = time.time() - t0
    counts = launch_counts()
    log(f"{tag} {json.dumps(res)}")
    d = res["detail"]
    check(res["value"] > 0 and d["lm_head_ms"] > 0 and d["platform"].startswith("gpu ")
          and all(math.isfinite(v["verify_ms"]) and v["verify_ms"] > 0
                  for v in d["extrapolated_verify_step"].values()),
          f"{tag} a time is not positive: {res}")
    check_launched(tag, counts, ("attend_flash", "w4a16_matmul"))
    out = dict(wall_s=wall, peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"{tag} {json.dumps(dict(out, launches={k: n for k, n in counts.items() if n}))}")
    return dict(res, **out, launches=counts)


def serve_soak_phase(torch, dev):
    """examples/serve_soak --model-class awq8b --batch 32: the flagship 8B
    AWQ composition (int8 KV, 2x3, early-exit Int4F draft), 64 requests 20 ms
    apart through make_scheduler and the pipelined ContinuousBatcher, every
    4th streaming; its JSON line."""
    from umbrella_tpu_torch.examples.serve_soak import build_models, soak
    from umbrella_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from umbrella_tpu_torch.serving.batched_engine import BatchedStaticEngine

    tag = "[serve-soak]"
    torch.cuda.reset_peak_memory_stats(dev)
    target, draft, gm, kv_dtype, dtype = build_models("awq8b", MAX_LEN, dev)
    eng = BatchedStaticEngine(draft_model_name=draft, target_model_name=target,
                              batch_size=SOAK_BATCH, dtype=dtype, growmap=gm, max_length=MAX_LEN,
                              eos_token_ids=[-100], segment_steps=SEGMENT_STEPS,
                              kv_dtype=kv_dtype, device=dev)
    eng.initialize()
    reset_launch_counts()
    steps0 = eng.steps_dispatched
    res = soak(eng, SOAK_REQUESTS, SOAK_NEW_TOKENS, *SOAK_PROMPTS, model_class="awq8b")
    counts = launch_counts()
    outs = res.pop("outputs")
    log(f"{tag} {json.dumps(res)}")
    d = res["detail"]
    check(len(outs) == SOAK_REQUESTS
          and d["total_tokens"] == sum(len(o["generated_tokens"]) for o in outs),
          f"{tag} {len(outs)} results, {d['total_tokens']} tokens")
    for o in outs:
        toks = o["generated_tokens"]
        check(1 <= len(toks) <= SOAK_NEW_TOKENS + 1 and all(0 <= t < 128256 for t in toks),
              f"{tag} a request got {len(toks)} tokens or one out of range")
    check_launched(tag, counts, ("embed_gather", "attend_flash_batched_int8", "w4a16_matmul",
                                 "w4a8f_matmul", "w4a8_quantize"))
    steps = eng.steps_dispatched - steps0
    out = dict(steps=steps, launches_per_step={k: n / max(steps, 1) for k, n in counts.items()
                                               if n},
               graphs=check_graphed(eng, tag),
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"{tag} {json.dumps(out)}")
    return dict(res, **out, launches=counts)


EXAMPLE_PHASES = ("spec-bench", "spec-bench-code", "serve-config-bf16", "generate",
                  "construct-sequoia")


# ---------------------------------------------------------------- main

KERNEL_META = {
    "embed_gather": ("umbrella_tpu_torch/csrc/embed_gather.cu",
                     "umbrella_tpu/ops/pallas/embed_gather.py:60"),
    # the tree_attention family: each kernel's own pallas_call (attend_flash
    # launches both _flash_kernel and _flash_kernel_q)
    "attend_flash": ("umbrella_tpu_torch/csrc/tree_attention.cu",
                     "umbrella_tpu/ops/pallas/tree_attention.py:449"),
    "attend_flash_int8": ("umbrella_tpu_torch/csrc/tree_attention.cu",
                          "umbrella_tpu/ops/pallas/tree_attention.py:438"),
    "attend_flash_batched": ("umbrella_tpu_torch/csrc/tree_attention.cu",
                             "umbrella_tpu/ops/pallas/tree_attention.py:349"),
    "attend_flash_batched_int8": ("umbrella_tpu_torch/csrc/tree_attention.cu",
                                  "umbrella_tpu/ops/pallas/tree_attention.py:338"),
    "w4a16_matmul": ("umbrella_tpu_torch/csrc/w4a16.cu", "umbrella_tpu/ops/pallas/w4a16.py:233"),
    "w4a8f_matmul": ("umbrella_tpu_torch/csrc/w4a8.cu", "umbrella_tpu/ops/pallas/w4a8f.py:97"),
    "w4a16_gate_up_silu": ("umbrella_tpu_torch/csrc/w4a16.cu",
                           "umbrella_tpu/ops/pallas/w4a16.py:158"),
    "w4a8_matmul": ("umbrella_tpu_torch/csrc/w4a8.cu", "umbrella_tpu/ops/pallas/w4a8.py:85"),
    # the int8 W4 kernels' fused quantizer: the activation quantization that the
    # jitted w4a8f_matmul runs before its pallas_call (w4a8_matmul's at :100-102)
    "w4a8_quantize": ("umbrella_tpu_torch/csrc/w4a8.cu", "umbrella_tpu/ops/pallas/w4a8f.py:105"),
    # w4a16_matmul's layered mode: the same function's scalar-prefetch pallas_call
    "w4a16_matmul_layered": ("umbrella_tpu_torch/csrc/w4a16.cu",
                             "umbrella_tpu/ops/pallas/w4a16.py:303"),
}
# the kernels of the static main path (phase 4)
MAIN_KERNELS = ("embed_gather", "attend_flash", "w4a16_matmul", "w4a8f_matmul", "w4a8_quantize")
# the phase whose run a kernel's `launches` is read from: its main path. No
# shipped config reaches w4a16_gate_up_silu (nor does the JAX package's default
# routing): its launches are awq_gate_up_silu(fused=True)'s, in [kernels]
LAUNCHES_FROM = {"attend_flash_int8": "lossless-int8", "attend_flash_batched": "serve-bf16",
                 "attend_flash_batched_int8": "serve", "w4a8_matmul": "code-config-w4a8",
                 "w4a16_gate_up_silu": "kernels", "w4a16_matmul_layered": "pp-config"}
# the phases of the dynamic engine and the offload tier: each kernel's launches a
# step there (the dynamic main path's from its captured step)
NEW_PATHS = ("dynamic", "offload-config", "gemma-config", "gemma-serve", "moe-config",
             "moe-serve", "tp-config")
# the per-shape timings of the offload configs' shapes ([kernels]): W4A16 at the
# 70B layer shapes at S=256 and 257, attention at the 257-row verify and a 1B level
NEW_SHAPES = ("70B wqkv S=25", "70B wo S=25", "70B gate_up S=25", "70B down S=25",
              "70B dynamic verify", "1B draft level")
# the profiled window of each phase in which the profiler counted the
# kernels' launches (held there against the wrappers' counts)
TRACED_IN = {"main": "[profile] graphed: a 64-token generate()",
             "lossless-int8": "[lossless-int8]: its generate()",
             "serve": "[serve-profile]: one segment of 8 steps",
             "serve-bf16": "[serve-bf16-profile]: one segment of 8 steps",
             "code-config-w4a8": "[code-config-w4a8-trace]: a 32-token generate()",
             "pp-config": "[pp-profile]: 8 tokens of the graphed decode loop (prefill "
                          "outside the window)"}
CHECKPOINT_PHASES = ("checkpoint", "code-config", "code-config-w4a8", "serve-config",
                     "api-serve", "api-chat", "pp-config", "tp-config", "offload-checkpoint",
                     "offload-config") + EXAMPLE_PHASES
PHASES = ("kernels", "multi-card", "lossless", "lossless-int8", "lossless-w4a8",
          "batched-lossless", "pp-lossless", "tp-lossless", "tp-serve", "dynamic-lossless",
          "offload-lossless") + TRAIN_PHASES + ("main",
          "graph", "dynamic", "dynamic-pp", "serve", "serve-bf16",
          "serve-stochastic") + CHECKPOINT_PHASES + ("bench-70b", "serve-soak") + GEMMA_PHASES \
    + MOE_PHASES
# phases that run only when named in --phases: `w4a16`, `w4a8` and
# `attention` are subsets of `kernels`
SUBSET_PHASES = ("w4a16", "w4a8", "attention")


# each kernel's entries in [gemma-config]'s and [moe-config]'s kernel_shapes
FAMILY_SHAPES = {"attend_flash": ("attend_flash window mask", "attend_flash full mask"),
                 "attend_flash_batched": ("attend_flash_batched",),
                 "attend_flash_batched_int8": ("attend_flash_batched_int8",),
                 "embed_gather": ("embed_gather 256000x3584", "embed_gather 32000x4096",
                                  "embed_gather 32768x4096")}


def family_shapes(results, name):
    """{"family_shapes": {"<phase> <shape>": timings}} of a kernel, or {}."""
    shapes = {f"{p} {k}": results[p]["kernel_shapes"][k] for p in ("gemma-config", "moe-config")
              for k in FAMILY_SHAPES.get(name, ()) if k in results[p]["kernel_shapes"]}
    return {"family_shapes": shapes} if shapes else {}


def run(torch, phases):
    import numpy as np

    from umbrella_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    log(f"[card] {torch.cuda.get_device_name(0)}; {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t_all = time.time()

    t0 = time.time()
    build.build_all(verbose=True)
    log(f"[build] {len(build.sources())} kernel sources in {time.time() - t0:.1f} s")

    results = {}

    def phase(name, fn, *args):
        if name not in phases:
            return None
        t0 = time.time()
        results[name] = fn(*args)
        log(f"[{name}] done in {time.time() - t0:.1f} s")
        gc.collect()  # engines the phase dropped, with their graphs' memory pools
        torch.cuda.empty_cache()
        return results[name]

    prompt = np.random.default_rng(0).integers(0, 120000, size=PROMPT_LEN).astype(np.int32)
    report = phase("kernels", kernel_checks, torch, dev)
    phase("w4a16", w4a16_phase, torch, dev)
    phase("w4a8", w4a8_phase, torch, dev)
    phase("attention", attention_phase, torch, dev)
    phase("multi-card", multi_card_phase, torch, dev)
    phase("lossless", lossless_check, torch, dev, prompt.tolist())
    phase("lossless-int8", lossless_check, torch, dev, prompt.tolist(), "int8")
    phase("lossless-w4a8", lossless_check, torch, dev, prompt.tolist(), None, "int8")
    phase("batched-lossless", batched_lossless_check, torch, dev)
    phase("pp-lossless", pp_lossless_check, torch, dev, prompt.tolist())
    phase("tp-lossless", tp_lossless_check, torch, dev, prompt.tolist())
    phase("tp-serve", tp_serve_phase, torch, dev)
    phase("dynamic-lossless", dynamic_lossless_check, torch, dev, prompt.tolist())
    phase("offload-lossless", offload_lossless_check, torch, dev, prompt.tolist())
    phase("train", train_phase, torch, dev)
    phase("train-dp", train_dp_phase, torch, dev)
    phase("pp-train", pp_train_phase, torch, dev)
    phase("moe-train", moe_train_phase, torch, dev)
    phase("tp-train", tp_train_phase, torch, dev)
    phase("ep-train", ep_train_phase, torch, dev)
    phase("multihost", multihost_phase, torch, dev)

    if {"main", "graph", "dynamic", "dynamic-pp", "serve", "serve-bf16",
            "serve-stochastic"} & set(phases):
        t0 = time.time()
        target, draft = build_target(torch, dev, n_layers=32, exit_layer=3, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"[setup] 8B target and draft built in {time.time() - t0:.1f} s")
        phase("main", main_path, torch, dev, prompt.tolist(), target, draft)
        phase("graph", graph_phase, torch, dev, prompt.tolist(), target, draft)
        if {"dynamic", "dynamic-pp"} & set(phases):
            draft_1b = build_draft_1b(torch, dev, MAX_LEN)
            phase("dynamic", dynamic_phase, torch, dev, prompt.tolist(), target, draft_1b)
            phase("dynamic-pp", dynamic_pp_phase, torch, dev, prompt.tolist(), draft_1b)
            del draft_1b
        phase("serve", serve_phase, torch, dev, target, draft, "[serve]", 32, (2, 3), "int8",
              64, "attend_flash_batched_int8", True, True)
        phase("serve-bf16", serve_phase, torch, dev, target, draft, "[serve-bf16]", 8, (3, 4),
              None, 16, "attend_flash_batched", False)
        phase("serve-stochastic", stochastic_phase, torch, dev, target, draft)
        del target, draft
        torch.cuda.empty_cache()

    if set(CHECKPOINT_PHASES) & set(phases):
        import shutil
        import tempfile

        os.makedirs(build.BUILD_DIR, exist_ok=True)
        root = tempfile.mkdtemp(prefix="checkpoints-", dir=build.BUILD_DIR)
        try:
            ckpt = write_checkpoints(torch, dev, root,
                                     bf16=bool({"spec-bench", "serve-config-bf16"} & set(phases)))
            phase("checkpoint", checkpoint_phase, torch, dev, ckpt)
            phase("code-config", code_config_phase, torch, dev, ckpt, prompt.tolist(),
                  "[code-config]", "target")
            phase("code-config-w4a8", code_config_phase, torch, dev, ckpt, prompt.tolist(),
                  "[code-config-w4a8]", "target-w4a8")
            shared = {} if "api-serve" in phases else None
            phase("serve-config", serve_config_phase, torch, dev, ckpt, shared)
            phase("api-serve", api_serve_phase, torch, dev, ckpt, shared or {})
            shared = None
            phase("api-chat", api_chat_phase, torch, dev, ckpt, prompt.tolist())
            phase("pp-config", pp_config_phase, torch, dev, ckpt, prompt.tolist())
            phase("tp-config", tp_config_phase, torch, dev, ckpt, prompt.tolist())
            phase("offload-checkpoint", offload_checkpoint_phase, torch, dev, ckpt)
            phase("offload-config", offload_config_phase, torch, dev, ckpt, prompt.tolist())
            phase("spec-bench", spec_bench_phase, torch, dev, ckpt)
            phase("spec-bench-code", spec_bench_code_phase, torch, dev, ckpt)
            phase("serve-config-bf16", serve_config_bf16_phase, torch, dev, ckpt)
            phase("generate", generate_phase, torch, dev, ckpt)
            phase("construct-sequoia", construct_sequoia_phase, torch, dev, ckpt)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    phase("bench-70b", bench_70b_phase, torch, dev)
    phase("serve-soak", serve_soak_phase, torch, dev)
    family_phases(torch, dev, phase, phases, prompt.tolist())

    if set(phases) != set(PHASES):
        log(f"[partial] phases {sorted(phases)} passed in {time.time() - t_all:.1f} s on {card}")
        return
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        src = LAUNCHES_FROM.get(name, "main")
        r = report[name]
        path = r if src == "kernels" else results[src]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path["launches"][name], max_abs_err=r["max_abs_err"], matched=True,
            tolerance=r["tolerance"], shape=r["shape"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            timed_by=TIMED_BY,
            **{k: r[k] for k in ("plain_timed_by", "events_ms", "launch_floor_ms") if k in r},
            launches_per_step=path["launches_per_step"][name],
            launches_from=("kernels: awq_gate_up_silu(fused=True), which no shipped config "
                           "reaches" if src == "kernels" else src),
            launches_traced=(None if src == "kernels" else
                             path["launches_traced"].get(name)),
            launches_traced_in=TRACED_IN.get(src),
            launches_per_step_in={p: results[p]["launches_per_step"][name]
                                  for p in NEW_PATHS if results[p]["launches_per_step"][name]},
            **({"offload_config_shapes": {k: v for k, v in r["per_shape"].items()
                                          if k.startswith(NEW_SHAPES)},
                "tp_shard_shapes": {k: v for k, v in r["per_shape"].items() if "TP4" in k}}
               if "per_shape" in r else {}),
            **family_shapes(results, name),
            **({"training": dict(r["training_shape"], launches=results["train"]["launches"][name],
                                 launches_per_step=results["train"]["launches_per_step"][name],
                                 launches_from="train",
                                 launches_per_step_in={p: results[p]["launches_per_step"][name]
                                                       for p in ("tp-train", "ep-train")})}
               if "training_shape" in r else {}),
            **multihost_launches(results["multihost"], name),
            launches_in_examples={p: results[p]["launches"][name]
                                  for p in EXAMPLE_PHASES + ("bench-70b", "serve-soak")
                                  if results[p]["launches"][name]}))
    main, serve = results["main"], results["serve"]
    summary = {k: main[k] for k in ("tok_per_s", "decode_step_ms", "avg_accept_tokens",
                                    "ttft_ms_prefill128", "spec_vs_ar_common_prefix")}
    if main["profile"]:
        summary["device_idle_share"] = main["profile"]["device_idle_share"]
    summary["serve"] = {k: serve[k] for k in (
        "run_tok_per_s", "pipelined_tok_per_s", "avg_accept_tokens", "decode_step_ms",
        "ttft_ms_p50", "ttft_ms_p95", "tpot_ms_p50", "peak_mem_gb")}
    summary["serve-bf16"] = {k: results["serve-bf16"][k] for k in (
        "run_tok_per_s", "avg_accept_tokens", "decode_step_ms")}

    def idle(prof):
        return prof and {k: prof[k] for k in ("device_idle_share", "host_ops_per_step",
                                              "device_busy_ms_per_step")}

    # graphed (the decode loop's step replayed as a CUDA graph) beside stepwise
    summary["graphed_vs_stepwise"] = {
        "main": {mode: dict({k: main[mode][k] for k in (
            "tok_per_s", "decode_step_ms", "ttft_ms_prefill128", "replays", "noop_replays",
            "host_reads")}, profile=main[mode]["profile"] and dict(
                idle(main[mode]["profile"]), **{k: main[mode]["profile"].get(k) for k in (
                    "replays", "noop_replays", "capture_ms", "graph_pool_gb")}))
            for mode in ("graphed", "stepwise")},
        "serve": {"graphed": dict(run_tok_per_s=serve["run_tok_per_s"],
                                  decode_step_ms=serve["decode_step_ms"],
                                  profile=idle(serve["profile"]), graphs=serve["graphs"]),
                  "stepwise": dict({k: serve["stepwise"][k] for k in (
                      "run_tok_per_s", "decode_step_ms", "equal_to_graphed")},
                      profile=idle(serve["stepwise"]["profile"]))},
        "graph": {k: v for k, v in results["graph"].items()}}
    summary["lossless"] = results["lossless"]["identical_prefix"]
    summary["lossless-int8"] = results["lossless-int8"]["identical_prefix"]
    summary["batched-lossless"] = results["batched-lossless"]["identical_prefix"]
    summary["lossless-w4a8"] = results["lossless-w4a8"]["identical_prefix"]
    summary["checkpoint"] = {k: results["checkpoint"][k] for k in (
        "target_write_s", "draft_write_s", "target", "draft", "target_layers")}
    for name in ("code-config", "code-config-w4a8"):
        summary[name] = {k: results[name][k] for k in (
            "tok_per_s", "decode_step_ms", "avg_accept_tokens", "ttft_ms_prefill128")}
    summary["code-config-w4a8"]["w4a8_launches_per_step"] = \
        results["code-config-w4a8"]["launches_per_step"]["w4a8_matmul"]
    summary["serve-config"] = {k: results["serve-config"][k] for k in (
        "tok_per_s", "avg_accept_tokens", "peak_mem_gb")}
    api = results["api-serve"]
    summary["api-serve"] = {k: api[k] for k in (
        "server_tok_per_s", "batcher_tok_per_s", "server2_tok_per_s", "batcher2_tok_per_s",
        "run_tok_per_s", "client_ttft_ms_p50", "client_ttft_ms_p95", "server_ttft_ms_p50",
        "frames_per_stream", "callback_ms_per_segment", "greedy_equal_to_run", "peak_mem_gb")}
    summary["api-serve"].update(
        priority_inversions=api["scheduler"]["priority_inversions"],
        worker_a_request_tok_per_s=api["worker_a_request"]["server_tok_per_s"],
        batcher_route_tok_per_s=api["batcher_route"]["server_tok_per_s"],
        batcher_route_callback_ms_per_segment=api["batcher_route"]["callback_ms_per_segment"])
    summary["api-chat"] = {k: results["api-chat"][k] for k in (
        "server_tok_per_s", "direct_tok_per_s", "tpot_ms", "avg_accept_tokens",
        "first_frame_ms", "peak_mem_gb")}
    summary["pp-lossless"] = {kv: (r["identical_to_unstaged"], r["identical_to_ar"])
                              for kv, r in results["pp-lossless"].items()}
    pp = results["pp-config"]
    summary["pp-config"] = {k: pp[k] for k in (
        "tok_per_s", "decode_step_ms", "avg_accept_tokens", "ttft_ms_prefill128",
        "peak_mem_gb", "distinct_cards", "capture_ms", "pool_gb_by_device", "segments")}
    summary["pp-config"]["device_idle_share"] = pp["profile"]["device_idle_share"]
    summary["graphed_vs_stepwise"]["pp-config"] = {
        loop: dict({k: pp[loop][k] for k in ("tok_per_s", "decode_step_ms", "replays")},
                   profile=idle(pp[loop]["profile"])) for loop in ("graphed", "stepwise")}
    # device ms a step in each profile: the attention kernels, W4A16, the int8 W4 family
    profiles = {"profile": main["profile"], "serve-profile": serve["profile"],
                "pp-profile": results["pp-config"]["profile"]}
    summary["device_ms_per_step"] = {
        tag: {k: prof[f"{k}_device_ms_per_step"] for k in ("attention", "w4a16", "w4a8")}
        for tag, prof in profiles.items() if prof}
    dyn = results["dynamic"]
    summary["dynamic"] = {mode: dict({k: dyn[mode]["graphed"][k] for k in (
        "tok_per_s", "decode_step_ms", "avg_accept_tokens", "ttft_ms_prefill128")},
        stepwise_tok_per_s=dyn[mode]["stepwise"]["tok_per_s"],
        graphed_equal_stepwise=dyn[mode]["graphed_equal_stepwise"],
        profile=idle(dyn[mode]["graphed"]["profile"])) for mode in ("greedy", "stochastic")}
    summary["dynamic-pp"] = {k: {m: r[m] for m in ("tok_per_s", "decode_step_ms", "stages")
                                 if m in r}
                             for k, r in results["dynamic-pp"].items() if isinstance(r, dict)}
    summary["dynamic-lossless"] = results["dynamic-lossless"]["identical_prefix"]
    summary["offload-lossless"] = results["offload-lossless"]["decode_identical_prefix"]
    summary["offload-checkpoint"] = results["offload-checkpoint"]["logits_equal_resident"]
    oc = results["offload-config"]
    summary["offload-config"] = dict(
        target=oc["target"], peak_mem_gb=oc["peak_mem_gb"], pinned_host_gb=oc["pinned_host_gb"],
        **{name: {k: oc[name][k] for k in ("tok_per_s", "decode_step_ms", "avg_accept_tokens",
                                           "ttft_ms_prefill128")}
           for name in ("greedy_config_v5e.json", "chat_config_v5e_16gb.json")})
    g = oc["greedy_config_v5e.json"]
    summary["offload-config"]["verify257"] = {k: g["traced_forward_verify257"][k] for k in (
        "compute_ms", "stream_exposed_ms", "stream_ms", "h2d_gbps", "h2d_gbps_min",
        "h2d_gbps_max", "streamed_exposed_ms_mean", "streamed_compute_ms_mean")}
    summary["offload-config"]["profile"] = dict(idle(g["profile"]), **{
        k: g["profile"][k] for k in ("h2d_copies", "h2d_ms", "h2d_overlapped_ms")})
    summary["graphed_vs_stepwise"]["offload-config"] = {
        "graphed": dict(decode_step_ms=g["decode_step_ms"], capture_ms=g["capture_ms"],
                        profile=idle(g["profile"])),
        "eager": dict(decode_step_ms=g["eager"]["decode_step_ms"],
                      profile=idle(g["profile_eager"]))}
    summary["gemma-lossless"] = results["gemma-lossless"]["identical_prefix"]
    summary["moe-checkpoint"] = results["moe-checkpoint"]["logits_equal_in_memory"]
    for name in ("gemma-config", "moe-config"):
        r = results[name]
        summary[name] = dict({k: r[k] for k in (
            "tok_per_s", "decode_step_ms", "avg_accept_tokens", "ttft_ms_prefill128",
            "peak_mem_gb", "pool_gb_by_device", "capture_ms")}, profile=idle(r["profile"]))
    summary["gemma-config"].update(ttft_ms_prefill4200=results["gemma-config"][
        "ttft_ms_prefill4200"], dynamic={k: results["gemma-config"]["dynamic"][k] for k in (
            "tok_per_s", "decode_step_ms", "avg_accept_tokens", "stepwise_tok_per_s")})
    summary["moe-config"]["target_layers"] = results["moe-config"]["target_layers"]
    summary["tp-lossless"] = {case: dict({k: r[k] for k in (
        "identical_to_sharded_ar", "identical_to_unsharded", "identical_to_unsharded_ar",
        "segments")}, **({"identical_to_mirror": r["mirror"]["identical"]} if "mirror" in r
                         else {})) for case, r in results["tp-lossless"].items()}
    tpc = results["tp-config"]
    summary["tp-config"] = dict({k: tpc[k] for k in (
        "tok_per_s", "decode_step_ms", "avg_accept_tokens", "ttft_ms_prefill128", "peak_mem_gb",
        "resident_gb", "capture_ms", "pool_gb_by_device", "segments", "target_layers")},
        stepwise=tpc["sampled"]["stepwise"]["decode_step_ms"], greedy=tpc["greedy"],
        profile=idle(tpc["profile"]))
    summary["tp-serve"] = {k: r["identical_prefix"] for k, r in results["tp-serve"].items()}
    for name in ("gemma-serve", "moe-serve"):
        summary[name] = {k: results[name][k] for k in (
            "run_tok_per_s", "pipelined_tok_per_s", "avg_accept_tokens", "decode_step_ms",
            "ttft_ms_p50", "peak_mem_gb")}
    tr = results["train"]
    summary["train"] = dict({k: tr[k] for k in (
        "params_m", "step_ms", "tok_per_s", "peak_mem_gb", "loss_drop", "fwd_bwd_costs")},
        first_loss=tr["losses"][0], last_loss=tr["losses"][-1],
        spec_identical_to_ar=tr["serve"]["identical_to_ar"],
        follow_the_period=tr["serve"]["follow_the_period"])
    summary["train-dp"] = {k: results["train-dp"][k] for k in (
        "max_loss_rel_diff", "max_param_diff", "step_ms_dp1", "step_ms_dp2")}
    summary["pp-train"] = dict(max_grad_rel_err=results["pp-train"]["max_grad_rel_err"],
                               staged_step_ms=results["pp-train"]["staged"]["step_ms"],
                               unstaged_step_ms=results["pp-train"]["unstaged"]["step_ms"])
    summary["moe-train"] = {k: results["moe-train"][k] for k in (
        "losses", "aux_at_init", "step_ms", "peak_mem_gb")}
    tpt = results["tp-train"]
    summary["tp-train"] = dict(
        max_grad_rel_err=tpt["one_step"]["max_grad_rel_err"],
        sp_bitwise_tp=tpt["one_step"]["sp_bitwise_tp"] and tpt["three_steps"]["sp_bitwise_tp"],
        fp32_step_ms={k: tpt["three_steps"][k]["step_ms"] for k in ("tp", "sp", "grid")},
        fp32_unsharded_step_ms=tpt["three_steps"]["unsharded_step_ms"],
        bf16={k: {m: v[m] for m in ("step_ms", "tok_per_s", "peak_gb_by_card")}
              for k, v in tpt["bf16"].items()},
        served_identical_to_ar=tpt["serve"]["identical_to_ar"])
    summary["ep-train"] = {k: results["ep-train"][k] for k in (
        "losses", "step_ms", "peak_gb_by_card")}
    summary["ep-train"]["fp32_max_grad_rel_err"] = \
        results["ep-train"]["fp32_one_layer"]["max_grad_rel_err"]
    mh = results["multihost"]
    summary["multihost"] = dict(
        {k: mh[k] for k in ("layout", "wall_s", "identical_to_one_process",
                            "prompt_logits_bitwise", "one_process_decode_step_ms")},
        processes=[{k: p[k] for k in ("backend", "spawn_to_ready_s", "decode_step_ms",
                                      "gathers_per_step")} for p in mh["processes"]])
    sb, code = results["spec-bench"], results["spec-bench-code"]["stats"]
    summary["spec-bench"] = dict({k: sb["total"][k] for k in (
        "tok_per_s", "tpot_ms", "avg_accept_tokens", "tokens")},
        spec_generate_tok_per_s=sb["spec_generate"]["tok_per_s"])
    summary["spec-bench-code"] = {k: code[k] for k in ("tok_per_s", "tpot_ms",
                                                       "avg_accept_tokens", "tokens")}
    summary["serve-config-bf16"] = {k: results["serve-config-bf16"][k] for k in (
        "tok_per_s", "avg_accept_tokens", "ttft_ms_p50", "peak_mem_gb")}
    gen = results["generate"]
    summary["generate"] = dict(tpot_ms=gen["tpot_ms"], bench_step_ms=gen["bench"]["step_ms"],
                               bench_offload_step_ms=gen["bench_offload"]["step_ms"])
    summary["construct-sequoia"] = {k: results["construct-sequoia"][k] for k in (
        "acceptance", "tree_size", "request_accept")}
    b70 = results["bench-70b"]
    summary["bench-70b"] = dict(layer_ms=b70["value"], lm_head_ms=b70["detail"]["lm_head_ms"],
                                tp1_verify_ms=b70["detail"]["extrapolated_verify_step"]["tp1"][
                                    "verify_ms"])
    soak = results["serve-soak"]["detail"]
    summary["serve-soak"] = dict({k: soak[k] for k in (
        "latency_p50_ms", "latency_p99_ms", "ttft_p50_ms", "ttft_p99_ms", "wall_s")},
        tok_per_s=results["serve-soak"]["value"])
    summary["seconds"] = time.time() - t_all
    log(f"[summary] {json.dumps(summary)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card[0] if card else "nvidia-smi: no card", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def main():
    phases = PHASES
    if len(sys.argv) > 2 and sys.argv[1] == "--phases":  # a subset, for debugging
        phases = tuple(sys.argv[2].split(","))
        unknown = set(phases) - set(PHASES) - set(SUBSET_PHASES)
        if unknown:
            print(f"chip_smoke: unknown phases {sorted(unknown)}", file=sys.stderr)
            return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import umbrella_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: umbrella_tpu_torch not found beside this script", file=sys.stderr)
        return 2
    try:
        run(torch, phases)
    except Exception:  # report the failed phase and exit non-zero
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # skip interpreter teardown, which can stall after CUDA work
