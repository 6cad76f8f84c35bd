#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (grove_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # one card, no arguments
    python3 chip_smoke.py --phases slice,serve [--tree DIR]
    python3 chip_smoke.py --phases cards,cards_steps   # on 4 cards

The second form runs phases 0-1 and then only phase 3 (slice) and / or
9 (serve), from DIR's chip_smoke.py and package (this checkout by
default), and prints no result line: an A/B of the decode and engine-tick
times of two checkouts, run in turns in one call. The third runs the
parallel paths across 4 cards over NCCL (`phase_cards`: the driver, the
pipeline one stage a card, and the pipeline under data parallelism, 2
stages x 2 replicas, in fp32 against data parallelism and at full width;
`phase_cards_steps`: fp32 steps against the unsharded one, DP, TP x DP
with and without sequence parallelism, FSDP2 and ZeRO-2, and the demo).

Phases, each printing its own line; any failure exits non-zero:
  0  device: requires CUDA (there is no CPU path) and prints the card's
     name and power limit as nvidia-smi reports them; then whether the
     repo's native libav decoder (native/libgrove_video.so) loads, and if
     not, which shared objects are missing: phases 3 and 4 then hand
     GroveProcessor SyntheticVideo frames instead of the .y4m files, and
     say so ("decoder" in the JSON line);
  1  build: compiles grove_tpu_torch/csrc with nvcc for sm_90a;
  2  kernels: each hand-written kernel against its plain torch twin on the
     card, at the full-width shapes of the main paths in bf16 (max-abs
     error <= 2e-2 of the output's max-abs; the LSE of K4 and K9's
     forward from their SIMT entries too, from their tensor-core entries
     <= 1e-4, since K4b and K9's backward recompute P from it) and at small
     fp32 shapes (<= 1e-4), with median CUDA-event times of both. One fp32
     K1 case and one fp32 K1q case, and two bf16 edges of each tensor-core
     entry, carry an all-underflow row, which must come out as exact zeros
     (the TPU kernel's EXP2_SHIFT contract). The int8 outputs are held in
     LSBs: K8a, K8b and K8c |diff| <= 1 on at most 0.1% of the elements (a
     residual sum of the int8's shape bit-equal, K8c's per-token scales
     within 1e-6 relative), K7c bit-equal, K1q <= 2 LSB on at most 0.1% in
     bf16 and <= 1 LSB on at most 0.01% in fp32: its SIMT entry against
     the fp32 twin, its tensor-core entry against the twin with that
     body's rounding points (P in bf16 before P.V; its distance from the
     fp32 twin is printed).
     K6, K7a-K7c, K8a-K8c take microseconds and read inputs that are cold
     in the model (every layer has its own cache, weights or
     activations), so they are timed as CUDA-graph replays over copies of
     more than 64 MiB, beyond the 50 MB L2 (eager calls between events
     would time the host's launch overhead); each graph holds at least 8
     calls, cycling over the copies (with one copy more than 64 MiB needs
     where they are fewer than 8, so that the others read 64 MiB between
     two reads of one copy), and its replay is divided by its calls: a
     graph of 3 calls carried its own cost. K7a, K7b and K7c have three
     full-width shapes each (the q/k/v/o, gate/up and down projections of
     LLaMA-7B), K8a two (the CLIP and SAM norm sites); their JSON times are
     the sums. K7a's shapes are also timed one call alone, with its launch
     plan (`ops.int4_matmul._plan`: cluster, CTAs an SM, copy width, shared
     memory); its edges, fp32 and bf16, reach every instantiation's kind
     (1 to 37 rows, 4-byte copies, a cluster of 1, x read from global
     memory); its yardstick is `torch.matmul` on
     the bf16 dequantized (K, N) weight built outside the timed call (four
     times K7a's bytes), both ways too; and K7a at the fused widths (2,
     4096, 12288) and (2, 4096, 22016), fp32 and bf16, must be bit-equal to
     its unfused parts on the same column slices. K6's small shapes and
     edges, fp32 and bf16, include the continuous engine's tick of phase 9
     at (4, 32, 32, 2432, 128), each slot with its own left pad (1471 to
     1537 columns) and the columns past the tick masked; K6 prints its
     launch (`ops.decode_attention._plan`) at every shape, and the shared
     memory that plan sizes must equal the library's. Its kernels' registers
     and spills are printed from nvcc -Xptxas -v (a spill fails). K7c and
     K8c also print their launch (`ops.int4_matmul._requant_plan`,
     `ops.fused_ln._rms_plan`), which must equal the one the library
     reports (`grove_*_plan`), at every shape; their edges reach 64-row and
     64-column K7c tiles, more tiles than CTAs, and K8c rows of 256 to 8192
     on both instantiations with fewer rows than CTAs; K7c's view of each
     fused width must be bit-equal to its parts' views; their registers
     and spills are printed the same way. Beside
     each kernel the phase prints its bound, the least
     time the card could take for the same work: the larger of its bytes
     (inputs read once, outputs written once) over 3.35 TB/s and its
     operations over the H100's peak for their type (989 TFLOP/s bf16,
     1979 TOP/s int8, 67 TFLOP/s fp32 off the tensor cores; K14's bytes
     are those a correct call must move: the valid pixels read, every output
     byte written; a time under its bound fails), and, for K1-K5
     and K10, the time of the one PyTorch call that computes the same
     function (`F.scaled_dot_product_attention`, rel-pos terms and pads as a
     mask), which the port never calls, and the yardsticks of K6 (SDPA of
     the query over a bf16 cache of the same shape, the bias as its mask)
     and K7b (K7a's, on the dequantized activations), which compute
     neighbouring functions and are labeled so. K1, K1q, K2, K3, K4, K4b (dq,
     dkv), K5, K9 (forward, dq, dkv), K10, K11, K12, K12q8 and K13 (v1, v2)
     have two entries each:
     the tensor-core one (`_tc`, attention_tc.cuh; for K9's and K4b's dq
     and dkv attention_bwd_tc.cuh), which
     the wrappers take for bf16 at head dim 64, 80 or 128, held through the
     wrapper at full width and at bf16 edge cases within 2e-2 of max-abs
     (K5: pads of 0, 5, 37, 64, 100 and 150, whole key tiles inside the
     pad, S of 1 to 640, every row inside a pad equal to its own v row and
     every output finite, as for its SIMT entry, and at full width within
     2e-2 of the fp32 twin; K9's dq and dkv: grids of
     2 x 2 to 32 x 32 against the twins with the body's rounding points, P
     and dS in bf16 as the TPU kernel rounds them, and at full width within
     2e-2 of the fp32 twins too (dq, d_rh and d_rw each of its own
     max-abs); K4b's dq and dkv: S of 3 to 704, causal and not, against
     the twin with the body's rounding points (dS, and for dkv P, in bf16,
     where the TPU K4b keeps fp32), dq, dk and dv each also row by row
     (each query's or key's row within 1e-2 of its own max-abs: late
     causal rows average over many keys, late keys see few queries; a row
     zero in exact arithmetic, the first of a causal dq, below 1e-5 of the
     output's max-abs), and at full width within 2e-2 of the fp32 twin;
     K3: S of 1, 63, 65, 129 and 577;
     K10: also
     causal Sq < Sk and Sq > Sk and cross lengths; K4: S of 1, 63, 65, 129
     and 704, causal and not, its LSE within 1e-4; K2 and K11: grids of 2
     x 2, 4 x 4, 12 x 12, 14 x 14 and 32 x 32, K11, K13 v1 and K13 v2 (no
     model path; K13 v2 in the raw (B, S, H D) layout) at full width against
     K2's body's arithmetic and within 2e-2 of the fp32 twin; K1, K1q, K12
     (no model path, split q, k, v) and K9's forward: grids of 2 x 2,
     4 x 4, 7 x 7, 14 x 14, 16 x 16 and 32 x 32, K1q in LSBs, K1, K1q and
     K12 also with an all-underflow row (exact zeros), K12 at full width
     within 2e-2 of the fp32 twin, K9's LSE within 1e-4; every head dim;
     B.H > 1); and the SIMT one, held in fp32
     at the small cases and called directly in bf16 at full width, so that
     both bodies, SDPA and the plain twin are timed in the same call (each
     call alone between CUDA events, as every kernel is, and the two
     bodies and SDPA also 20 calls back to back, the device time without
     the host's launch gap). Each tensor-core kernel's registers and spills
     (nvcc -Xptxas -v; a spill fails) and its count of HGMMA instructions
     (cuobjdump -sass of the built library; 0 fails) are printed at D 64,
     80 and 128. K10 is held at the
     training driver's (1, 2111, 32, 128) bf16 causal and at small fp32
     cases with Sq != Sk both ways (causal top-left), its bf16 outputs also
     row by row (each query's head vector within 1e-2 of its own max-abs,
     since the late causal rows are small beside the first); then one
     causal attention call at that ragged S = 2111, forward and backward, is
     timed by the three routes the port has for it: K5 + the torch-ops
     recompute backward, K10 (its tensor-core entry) + the same backward
     (the JAX route, taken), K4 + K4b; and SDPA's forward and backward
     beside them. K11-K14, which no model path runs,
     at the shapes SAM ViT-H would give them (16 frames): K11 at the global
     (16, 1024, 16, 80) on 32 x 32 and the windowed (144, 196, 16, 80) on
     14 x 14 (times summed), K12 and K12q8 at (144, 196, 1280) x 3 (K12q8
     in LSBs like K1q, its tensor-core entry also within 1 LSB on at most
     3% of the fp32 twin's outputs, fp32 cases with an all-underflow row
     like K1), K13 v1 and v2 at the windowed shape, K14 both ways at
     (16, 32, 32, 1280), win 14 (padded to 42 inside the kernel),
     bit-equal, timed as K6-K8c (its 41.94 MB input fits the L2), and at
     small shapes on both of its bodies (the bulk one, and the vector one
     for pixels off 16 bytes) in fp32, bf16 and int8, its launch
     (`window_copy_plan`: the body, the CTAs and every row's bytes) equal
     to the library's row for row at every shape; their library call is
     SDPA with the rel terms as a mask (K14: torch's own pad + view +
     permute copy, labeled so). Last, the
     trainable forms card vs CPU in fp32: `sam_window_attention_raw`
     (forward K12, backward K9) within 1e-3 of max-abs, the K14 pair and
     its backward bit-equal; then K14's one-call times at full width
     (torch's pad alone, each wrapper, each kernel alone, a contiguous
     copy_ of the grid), each with the bytes it moves (`copy_ms` in the
     JSON rows);
  3  slice: GroveConfig() (CLIP ViT-L/336, SAM ViT-H/512, LLaMA-7B) built
     on the card from a seed (GroveForCausalLM.from_pretrained), first in
     bf16, then quantized in place (quantize(bits=4): int4 projections,
     int8 lm_head) and run with the int8 KV cache, then with the towers
     W8A8 too (ops.quant.quantize_vision_ in place, GroveForCausalLM.
     calibrate on one synthetic clip: static activation scales), then the
     flagship configuration of the JAX package's bench.py with the LLM's
     activations int8 as well (quantize(bits=4, act_quant=True), switched
     in place: W4A8). Each run drives infer_clips_batched on 2 synthetic
     24-frame clips with two different questions (their prompts left-padded
     to 640 tokens, which the int8-cache prefill runs through K5; 64 new
     tokens) and ground_clip_with_caption with the
     launch counts zeroed just before and read just after; outputs must
     carry the JAX package's keys and be finite; no run may launch the SIMT
     entries of K1, K1q, K2, K3, K4, K4b, K5, K9 or K10 (bf16
     takes the tensor-core entries of K1, K1q, K2, K3, K4 and K5; the
     int4 and the flagship runs launch K5's exactly 32 times, once a layer
     of the one prefill); the bf16 run
     must launch K1-K4, the int4 run K1-K7a, the W8A8-static run K2-K7a,
     K8b and K1q,
     the flagship K2-K6, K7b, K7c, K8b, K8c (both entries) and K1q and no
     K7a (decode takes K7b, as the JAX dispatch does). Then a timed replay
     of the stages, peak device memory and weight bytes of each, and how
     many greedy tokens the quantized replays share with the bf16 one; the
     bf16 model also drives the [DET] branch of infer_clips_batched
     (`infer.sliding._finish_clip`) with a caption tagged at two phrases,
     which random weights never generate: pack_text, forward_boxes over the
     non-center windows (K4), postprocess_window;
     the bf16 model then runs the main path's entry:
     `GroveProcessor.generate_batch` on two 24-frame 640 x 360 .y4m clips
     written at 5 fps (`y4m_clip`; where phase 0 found no libav, no file
     and SyntheticVideo frames) with two questions, printing the decode
     (or SyntheticVideo's frames) and host preprocessing ms and the
     end-to-end ms per clip, K1-K3 required; the raw uint8 mode
     (`infer_clips_batched` with one 640 x 360 stack per clip as both
     towers' input, resized on the card) and the packed-YUV420 mode
     (`encode_video` + `encode_grounding`); the bf16 replay's CLIP
     `encode_video` is printed beside its time with K3's SIMT body, its SAM
     `encode_grounding` and teacher-forced `forward_boxes` beside theirs
     with K1's, the W8A8-static SAM beside its own with K1q's; the
     bf16 run's launch counts
     in the JSON line are those of the run before them;
     last, the flagship's `lm_forward` with its W8A8 lm_head (N = 32007,
     2 x 634 and 9 rows, zero-padded for `torch._int_mm`): finite logits,
     the int8 GEMM bit-equal to float64;
  4  parity: GroveConfig.small() in fp32, one set of weights, on the card
     with the kernels and on the CPU with the plain versions (TF32 off):
     teacher-forced boxes and objectness within 1e-3, greedy token
     agreement, the [DET] branch on a 24-frame clip (boxes over the frame
     size and objectness probabilities within 1e-3), `GroveProcessor.
     generate` on a 16-frame 640 x 360 clip (identical greedy ids; that
     clip's decoded, preprocessed frames through the [DET] branch with a
     tagged caption: boxes and objectness within 1e-3, and at least one
     compared), the raw and YUV420 normalizers on 640 x
     360 frames (the resize within 2e-3 levels before rounding, at most 1
     level apart on at most 0.5% after); then the same with the
     LLM quantized to int4: boxes within
     1e-3, and the CPU's greedy ids fed to both through prefill and 16
     decode steps over an int8 cache, each step's hidden states within
     1e-2 of their max-abs (one int8 LSB of K/V may flip between the two);
     then the towers W8A8-static with quant_ln_kernel=True, calibrated
     once on the CPU and deep-copied to the card: boxes and objectness
     within 1e-2, and the run must launch K8a, K8b and K1q. Whole-tower
     outputs (video tokens, SAM embeddings) are printed beside what inputs
     moved by 1e-6 (relative) do to them on the CPU, for information only:
     an int8 LSB that flips at one site cascades through the later ones.
     So every quant site of the card's towers (each LayerNormQuant, i.e.
     K8a, K8b or the chain; each SamAttention, i.e. K1q or K2 and a static
     quantize; each Int8Linear and Int8Conv3d) is then fed the CPU's input
     to that site: int8 activations <= 1 LSB on at most 0.1% of a site's,
     float outputs within 1e-5 of the CPU's max-abs. Last, the LLM W4A8
     (quantize_llama_(..., act_quant=True)) with the CPU taking the card's
     branches through the `models.layers._on_card` seam (otherwise it
     would compute another function: the generic path never quantizes the
     activations): boxes and objectness within 1e-2, the CPU's greedy ids
     through prefill and 16 decode steps within 1e-2 of max-abs, the card
     launching K7b, K7c and K8c and no K7a; then `fuse()` on the card:
     fused and unfused hidden states of the prompt within 1e-5 of max-abs,
     of 16 int8-cache decode steps bit-equal (K7b splits K by K and G
     alone), and their 64 greedy tokens equal.
  5  training: a fresh bf16 GroveConfig() with max_seq_len=129 (S = 129 +
     575 = 704 tokens, the JAX package's full-scale training shape) built
     from a seed, one batch from `data.collate.build_batch` (one synthetic
     clip of 8 frames, a three-phrase caption whose three [DET] tokens must
     survive the text budget), the default freeze policy and
     OptimizerConfig(warmup_steps=1); three `train.step.make_train_step`
     steps with the launch counts zeroed before each: every loss term
     finite, exactly 32 launches of K4's tensor-core entry and of K4b's
     two (dq, dkv), 24 of each of K9's three tensor-core entries
     (forward, dq, dkv), 28 of K1's tensor-core entry and 4 of K2's per
     step, none of a SIMT entry of K1, K1q, K2, K3, K4, K4b, K5, K9 or
     K10; step 1 (lr(0) = 0)
     leaves every parameter bit-equal and gives every trainable group
     (TRAIN_GROUPS) a finite, nonzero gradient; after step 3 the frozen
     parameters are bit-equal and every trainable group moved. Prints the
     trainable parameter count, the median of steps 2-3 (beside the step
     with K1 and K9's forward on their SIMT bodies) and peak device
     memory. Then one step
     at the default max_seq_len (S = 2111, ragged: K10 forward with the
     torch-ops recompute backward in every layer, exactly 32 launches of
     K10's tensor-core entry and none of its SIMT entry, K5 or K4), finite
     losses, its ms and peak memory beside those of K10's SIMT body. Then,
     that model freed,
     the QLoRA recipe of `benchmarks/train_finetune_scale.py`: a fresh
     GroveConfig() with lora_r=8 built with remat, GroveForCausalLM.
     quantize(bits=4), OptimizerConfig(moment_dtype="bf16",
     warmup_steps=1), updates applied with stochastic rounding from a
     seeded generator; two steps at S = 704 and one at S = 2111, each with
     exact launches (`_step_launches`: remat runs each LLaMA layer's K4 or
     K10 tensor-core entry twice, 64 a step, K2's tensor-core entry 7
     times and K1's 49; no K5, K7a, K7b, K7c, nor a SIMT entry);
     581,683,189 trainable parameters; step 1 bit-equal, lora_B's
     gradients nonzero and lora_A's zero; every trainable group moved by
     step 2, lora_A by step 3; every frozen tensor, the int4 bytes and
     scales included, bit-equal at the end; ms per step and peak memory
     printed;
  6  training parity: GroveConfig.small() (max_seq_len=129) in fp32, one
     set of weights and one batch, one step with warmup_steps=0 on the
     card (kernels, TF32 off; the SIMT entries of K4, K4b and K9)
     and on the CPU (plain
     versions): every loss
     term within 1e-4 relative, every trainable tensor's gradient within
     1e-3 of its max-abs (or of 1e-3 of the largest gradient's max-abs,
     for a tensor whose gradient is zero up to rounding); then the same for
     one QLoRA step (lora_r=8, remat, int4 LLM, bf16 moments) with the CPU
     in the card's Int4Linear branch (`models.layers._on_card`);
  7  loader: GroveForCausalLM.from_pretrained(tokenizer=) on a .bin of
     GroveConfig.small() with PEFT names and LoRA pairs on every layer's
     q_proj and v_proj, and SAM's pos_embed and global rel_pos tables on
     twice the grid, with a SentencePiece tokenizer written by the port's
     pure-Python writer: the config's special ids are the tokenizer's, the
     load onto the card is bit-equal to the same load onto the CPU (the
     pairs merged, the tables resized), and the loaded SAM's embeddings on
     the card are within 1e-3 of the CPU's max-abs (fp32);
  8  driver: `train.driver.main` in this process (`--max_restarts 0`, a
     fresh temporary log directory). At full width: `--model_size full
     --synthetic --model_max_length 129` (bf16, S = 704), batch 1, 2
     epochs x 2 steps, giou validation, 2 loader workers; each step's
     kernel launches (the counts set to 0 just before it) equal phase 5's
     at S = 704, every loss term finite, only trainable tensors moved by
     step 4 and every trainable group did, the saves of steps 2 and 4 and
     one best marker made, the checkpoint files not written (the machine's
     disk takes 45 GiB of writes a run; one step is 18.3 GiB). The checkpoint half
     at GroveConfig.small() in bf16: the same run, steps 2 and 4 kept,
     step 4 restored bit-equal to the card's parameters and optimizer
     state, one best marker; then `--auto_resume --epochs 3` resumes at
     epoch 2 from step 4 (the state on the card bit-equal to the
     checkpoint before its first step) and takes two steps, each with the
     launches `_step_launches` gives. Then GroveConfig.small() in
     fp32 (the driver's dtype patched from bf16) with
     `--grad_accumulation_steps 2`, 4 micro-steps from one `.bin` loaded
     by `--version`, on the card and on the CPU: loss terms within 1e-4
     relative, the moments within 1e-3 of their max-abs, the trainable
     parameters within 1e-3 of their update's max-abs weighted by |mu| /
     max|mu| at each element, the frozen ones bit-equal;
  9  serving: a fresh bf16 GroveConfig() from a seed. Sampling
     (`greedy_decode`, temperature 0.7, top-k 50, top-p 0.9, 32 new tokens)
     on phase 3's two prompts: the same seed twice gives the same tokens,
     every pick lies in its step's filtered support (`filter_logits`
     recomputed on the recorded logits), and on those logits with the same
     injected noise the card's filter and draw equal the CPU's (tokens and
     -inf masks; rows whose nucleus lies within 1e-6 of top_p, where the
     order of a reduction decides, are counted apart). Beam search, 2
     clips, bf16 cache: num_beams=1 bit-equal to greedy_decode, num_beams=4
     the same ids and scores with early_exit on and off, ms per step and
     peak memory. The continuous engine (`serve.continuous.
     ContinuousEngine`, 4 slots, the default capacity of 2367 columns, 64
     new tokens) on 6 requests admitted 2, then 2 after 5 ticks, then as
     slots free, in the bf16 and then the int8 cache: each request's tokens
     held to an offline greedy_decode of its prompt at batch 1 up to the
     first that differs: every logit finite, the logits within 5e-2 of
     their max-abs up to and at it, and there the offline top-two logit
     gap at most twice the max-abs difference of the two runs' logits; at
     least 3 of 6 requests equal in full and 70% of the tokens in the
     equal prefixes; the int8 run launches
     K5's tensor-core entry exactly 32 times an admission, K6 32 times a
     tick, no SIMT entry; ms per tick and admission, peak memory. Then
     `serve.serve` with GroveProcessor(decoder_factory=open_video) over
     two 24-frame 640 x 360 .npy clips on 127.0.0.1:0: /healthz, four
     concurrent /generate posts (two greedy, one sampled with a seed, one
     with 2 beams) run as 3 batches, each response equal to generate_batch
     over its group called again directly; then ContinuousService behind
     a second server, three concurrent greedy posts and a 400 for
     temperature. Last, GroveConfig.small() in fp32 (TF32 off): beam
     search card vs CPU, ids identical and scores within 1e-4 relative,
     and the continuous engine's tokens all equal to offline
     greedy_decode's on the card;
  10 task drivers and evals: the port's synthetic set of each task written
     into a temporary directory (`.npy` clips: iground 8 clips of 16
     frames, vidstg 2 clips, the two pointing tasks 2 clips of 20 frames,
     anet 2 segments of 10 frames), then `infer.drivers.main` (`--task ...
     --model_size full --device cuda`) for all five tasks and iground again
     with `--kv_cache_dtype int8`, on one bf16 GroveConfig() built on the
     card once and handed to each run through a wrapper of the driver's
     `build_model` (`_InferSpy`), which also records each stage call of
     the model (CLIP, SAM, the cache-free LLaMA pass and its S, the
     prefill and its S and cache, each decode step) and sets every launch
     count to 0 just before the run's inference. Each run's launches must
     equal the launches those calls make by the port's routes
     (`_infer_launches`: K3 24, K1 28 and K2 4 a CLIP or SAM call, K4 32 a
     teacher-forced pass at S a multiple of 64, K5 32 an int8-cache prefill
     at S % 8 == 0, K6 32 an int8-cache decode step), with no other entry,
     SIMT or not; each pickle must carry the JAX driver's entries, one per
     clip, with finite boxes and probabilities; iground's prefetched
     outputs (two groups of 4, the second loaded and uploaded on a side
     stream during the first) must equal two inline `infer_clips_batched`
     calls on the same groups bit for bit; each pickle goes through the
     port's evals (`evals.run_iground.main` for iground, `evals.run_all.
     main` for the others), which must return the JAX evals' metric keys
     with finite numbers. Then GroveConfig.small() in fp32 (TF32 off), one
     set of weights on the CPU and its copy on the card, the five tasks
     through `main` on each (16 new tokens; sets of fewer and shorter
     clips, `INFER_SMALL_SETS`, for the CPU's sake): the same pickles,
     text and ids equal, boxes within 1e-3 of their array's largest
     coordinate (about the frame's side) and probabilities within 1e-3.
     Last, `tools.run_experiment.main` (anet, synthetic, small(), on the
     card: infer, then the evals) and `python -m grove_tpu_torch.serve
     --help` in a subprocess, rc 0. Prints each run's wall seconds,
     clips/s and peak memory;
  11 region encoder and SAM mask path: on phase 10's bf16 GroveConfig(),
     8 SyntheticVideo frames (640 x 360, host-resized to 336 and 512)
     through `encode_video`, then `encode_regions` on its four CLIP levels
     with 8 RoIs over the frames (one straddling the image's edge, one
     partly outside the [-1, size] band of every level), `splice_regions`
     of the queries into a prompt with 8 <bbox> tokens after the video
     splice (padded to S a multiple of 64), the cache-free LLaMA pass and
     lm_head; `encode_grounding` of the same frames, then `segment` with
     two points and a box a frame, and again with two points and the
     first run's masks as the mask input, single-mask and multimask. Every
     launch count is set to 0 just before and read just after: they must
     be REGION_LAUNCHES exactly (K3 24, K1 28, K2 4, K4 32; the region
     encoder and the mask path run torch ops only). Prints each stage's
     CUDA-event ms and the peak memory; the <bbox> rows must equal the
     queries, every output finite and of its shape. `roi_align` on the
     card against the CPU in fp32 on level 1's grid (within 1e-5 of
     max-abs). Then GroveConfig.small() in fp32 (TF32 off), one set of
     weights on the CPU and its copy on the card, fed the same CPU-made
     CLIP levels and SAM embeddings: `encode_regions`, `splice_regions`
     (bit-equal, more <bbox> tokens than rows), `segment` with six prompt
     mixes and `predict_masks` with a text prompt, single-mask and
     multimask, each within 1e-3 of the CPU's max-abs;
  12 parallel training (`grove_tpu_torch.parallel`): on phase 10's bf16
     GroveConfig(), a batch of 2 rows at S = 704, one untimed step, then
     one `train.step.make_pipelined_train_step` step with the LLaMA stack
     GPipe-scheduled over 2 stages on [cuda:0, cuda:0] in 2 microbatches
     and one `make_train_step` step, each with a fresh optimizer (lr(0) =
     0: no weight moves) and every launch count set to 0 just before and
     read just after: the sequential step must launch phase 5's kernels
     exactly, the pipelined one the same but K4 and K4b's dq and dkv once
     a microbatch (2 x 32); their loss terms within 2e-2 relative and
     every trainable gradient within 2e-2 of its max-abs (or of 1e-3 of
     the largest); ms and peak memory of each beside phase 5's. Then
     `train.driver.main --multihost` at small() bf16 (2 steps, validation,
     a checkpoint of finite tensors) under a world-1 NCCL group from
     torchrun's environment, set here and restored after; the driver
     leaves no process group behind. Then the pipeline one stage a
     process (`parallel.pipeline.RankPipe`): two processes on the one card
     over gloo (messages through pinned host buffers), each building
     phase 10's GroveConfig() from its seed with only its stage's 16
     layers (the others on the meta device; each tensor's bits summed as
     integers equal to the model's here), one row of the same 2-row batch
     a rank, 2 microbatches: one warm step, then one with the launch counts set to
     0 just before and read just after in each process: each rank's
     launches exact (phase 5's, K4 and K4b's per rank and microbatch),
     the loss terms within 2e-2 relative and every trainable gradient
     within 2e-2 of its max-abs of the same step computed here a row at a
     time (each row's loss with the batch's normalizers, the gradients
     summed in bf16: the ranks' arithmetic); their distance from the
     sequential step on both rows printed beside that step's a row at a
     time; each rank's step ms, peak memory and busy share (CUDA events
     around its microbatch work). Then the same comparison, the batched
     step against the step a row at a time, at GroveConfig()'s widths with
     2 LLaMA layers: in fp32 (TF32 off) every trainable gradient within
     2e-3 of its max-abs, the same draws in bf16 printed beside it. Then
     two processes on the one card
     over gloo (`parallel.launch`): the multi-host demo (`--device cuda`,
     disjoint shards, the same loss on both ranks at every step), and a
     TP = 2 small() fp32 step (`parallel.workers.train_step`, TF32 off)
     against the unsharded step here: loss terms within 1e-4 relative,
     each first-step gradient within 2e-3 of its max-abs. Last, the
     pipeline under data parallelism: four processes on the one card over
     gloo as 2 stages x 2 replicas (`pipeline_step(replicas=2)`), small()
     fp32 (TF32 off), one row a rank, 2 microbatches a replica, 2 steps,
     and data parallelism over four processes on the same shards
     (`train_step`), launched at once: each step's loss terms and every
     trainable parameter after the steps within 2e-5 (1 + |x|) (those
     whose gradient is zero up to rounding left out), the first step's
     gradients within 2e-3 of their max-abs, each rank's launches exact
     on the SIMT entries, the replicas' copies of each stage bit-equal;
  13 the JAX package's model directories (`checkpoint.flax_msgpack`,
     `checkpoint.convert.load_jax_tree`): phase 10's bf16 GroveConfig()
     written as one (`save_jax_pretrained`: config.json and
     flax_model.msgpack, the layout `grove_tpu`'s `save_pretrained`
     writes) and read back with `GroveForCausalLM.from_pretrained(dir)`
     on the card: every tensor of the state bit-equal; then
     `infer_clips_batched` over 4 clips of phase 10's iground maker on
     both models, every launch count set to 0 just before each run and
     read just after: the greedy tokens identical, every output bit-equal,
     the launches equal. The same for the flagship (the model quantized in
     place to W4A8 with W8A8 towers, calibrated on one clip; the int8 KV
     cache). Each directory is deleted after use; bytes written and read,
     write and load seconds, the process's peak RSS (`resource.getrusage`)
     and the phase's own peak (sampled from /proc/self/statm), peak device
     memory. Then a training run written as the JAX package's Orbax run
     (`checkpoint.orbax_write`): a fresh bf16 GroveConfig() with the
     LLaMA cut to WITNESS_LAYERS layers at S = 704, the default trainable
     set, a warm step and a counted step (launches exact), then
     `save_step` and `save_best` straight from the card and
     `orbax_read.restore` with tensorstore made unimportable: every
     parameter, moment and count bit-equal to the state on the card;
     bytes written, write and read seconds, GB/s, host RSS peaks, and
     the phase's storage writes (the cut keeps them under the machine's
     45 GiB a command). JAX's Orbax layouts that need tensorstore cannot
     be read here: tests/test_torch_orbax.py holds them on the CPU.
Phase 2 also holds the five training kernels (K4b dq and dkv at LLaMA's
(1, 704, 32, 128) causal; K9's forward with its LSE, dq with d_rh and d_rw,
and dkv at SAM's windowed (72, 196, 16, 80) and global (8, 1024, 16, 80)
shapes, times summed) with SDPA's backward alone as their `library_ms` (its
forward for K9's forward entry), and the zero-padded int8 GEMM at lm_head's
(704 x 4096 x 32007) and at M = 2, bit-equal to a float64 product.

The line before the last is a JSON object with each kernel's measurements
(`launches`: the tensor-core entries of K1, K2, K3 and K4 from the bf16
run of phase 3, K5's tensor-core entry, K6 and K7a from the int4 one, K8b
and K1q's tensor-core entry from the W8A8-static one, K7b, K7c and K8c
from the flagship one, K8a and the SIMT entries of K1q, K2, K3 and K4
from phase 4's fp32 W8A8-static model path, K1's SIMT entry from its fp32
float one, the tensor-core entries of K4b's two and K9's three from step 3
of phase 5, K10's tensor-core entry from its bf16 S = 2111 step, the SIMT
entries of K4b's two and K9's three from phase 6's fp32 step;
the SIMT entries of K5 and K10, which no model path runs in fp32, and
K11-K14 (both entries of K11, K12, K12q8 and K13), which run on no model
path, show 0)
and `phase2_launches`, the launches of phase 2's checks and timings, and
`serve_launches`, those of phase 9's int8-cache continuous-engine run
(K5's tensor-core entry and K6), and `infer_launches`, those of each of
phase 10's full-width driver runs by task ("iground_int8": the int8-cache
run), and `region_launches`, those of phase 11's full-width region and
mask path, and `parallel_launches`, those of phase 12's pipelined step,
and `ranks_launches`, each rank's of phase 12's pipeline one stage a
process,
and `jax_dir_launches`, those of phase 13's runs on the models read back
from the JAX package's directories (bf16 and flagship, summed), and
`orbax_step_launches`, those of phase 13's counted step before the Orbax
write;
the
tensor-core rows also carry `simt_ms`, the SIMT entry's bf16 time at the
same shape; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import pickle
import re
import shutil
import stat
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FULL_TOL = 2e-2          # bf16, relative to the plain output's max-abs
ROW_TOL = 1e-2           # bf16, each row relative to its own max-abs
ZERO_ROW = 1e-5          # a row zero in exact arithmetic, of max-abs
LSE_TOL = 1e-4           # K4's bf16 LSE, relative to its max-abs
FP32_TOL = 1e-4          # fp32, absolute
ROUTE_TOL = 5e-2         # phase 2's ragged-S routes vs SDPA, fwd and bwd
PARITY_TOL = 1e-3        # phase 4 boxes / objectness
RESIZE_TOL = 2e-3        # phase 4 raw-frame resize card vs CPU, levels
FLIP_SHARE = 5e-3        # phase 4 normalized values 1 level apart, share
STEP_TOL = 1e-2          # phase 4 int8-cache decode steps, of max-abs
W8A8_TOL = 1e-2          # phase 4 W8A8-static towers: boxes / objectness
SITE_TOL = 1e-5          # phase 4 float outputs of a quant site, of max-abs
W4A8_TOL = 1e-2          # phase 4 W4A8 LLM: boxes / objectness
FUSE_TOL = 1e-5          # phase 4 fused vs unfused hidden states, of max-abs
LSB_SHARE = 1e-3         # share of int8 outputs allowed off (K8a-c, K1q)
FP32_LSB_SHARE = 1e-4    # the same for K1q in fp32
# K12q8's tensor-core entry against the fp32 twin: the body's bf16 P moves
# 1.1-1.3% of the int8 outputs by one LSB on the CPU's model of it
# (tests/test_torch_sam_v2.py; K1q's 1.1-2.2%, tests/test_torch_flash.py)
TC_TWIN_LSB = (1, 3e-2)
SX_REL = 1e-6            # K8c's per-token scales, relative
COLD_BYTES = 64 * 2**20  # inputs cycled past the L2 when timing cold kernels
# the fewest calls a cold replay's graph holds: with fewer, the graph's own
# cost a node sits in the time of the kernels whose copies of COLD_BYTES
# are few (K6 and the 11008-wide K7a-K7c)
COLD_NODES = 8
# the int8-cache prefill's K5 runs its tensor-core entry (bf16, D = 128),
# once in each of the 32 LLaMA layers of a prefill
QUANT_KERNELS = ("prefill_attention_tc", "int8_decode_attention",
                 "int4_matmul")
W8A8_KERNELS = ("add_layernorm_quant", "sam_window_attention_q8_tc")
FLAGSHIP_KERNELS = ("int4_matmul_a8", "int4_requant_int8", "rmsnorm_quant",
                    "add_rmsnorm_quant")
LN_KERNEL = "layernorm_quant"             # phase 4's quant_ln_kernel path
# the training kernels, launched per bf16 step of phase 5 exactly this
# often: K4 (its tensor-core entry) in the 32 LLaMA layers' forward, K4b
# (the tensor-core entries of its dq and dkv) in their backward, K9's three
# entries (their tensor-core ones) in the backward of the 21 windowed and 3
# global SAM blocks after the first trainable adapter
TRAIN_LAUNCHES = {"flash_forward_lse_tc": 32, "flash_backward_dq_tc": 32,
                  "flash_backward_dkv_tc": 32, "relpos_flash_fwd_lse_tc": 24,
                  "relpos_flash_dq_tc": 24, "relpos_flash_dkv_tc": 24}
# the fp32 steps of phase 6 launch the same kernels with the SIMT entries
# of K4, K4b's two and K9's three
FP32_TRAIN_KERNELS = tuple(k.removesuffix("_tc") for k in TRAIN_LAUNCHES)
# the training kernels whose launches the JSON line takes from phase 5: K4b
# and K9 from its S = 704 steps, K10 (its tensor-core entry) from its
# S = 2111 step (no serving path of phase 3 runs K10: their lengths are
# multiples of 64 or go to K5)
TRAIN_KERNELS = tuple(k for k in TRAIN_LAUNCHES
                      if k != "flash_forward_lse_tc") + ("flash_attention_tc",)
# the SIMT entries of K1, K1q, K2, K3, K4, K4b's two, K5, K9's three and
# K10: bf16 at head dim 64, 80 or 128 takes their tensor-core entries
# (`ops.attention._tc_takes`), so no bf16 path of phases 3 and 5 may launch
# them; fp32 does (phase 2's small cases; K1q, K2, K3 and K4 in phase 4's
# W8A8-static path and K1 in its float one, where the JSON line takes their
# launches from; K4b's two and K9's three in phase 6's fp32 step; no fp32
# model path runs K5 or K10 (phase 4's prompts are too short for K5), so
# their SIMT entries show 0 there)
SIMT_ENTRIES = ("grouped_plain_attention", "flash_attention",
                "flash_forward_lse", "sam_global_attention",
                "sam_window_attention", "sam_window_attention_q8",
                "relpos_flash_fwd_lse", "prefill_attention",
                "relpos_flash_dq", "relpos_flash_dkv", "flash_backward_dq",
                "flash_backward_dkv")
# the SIMT entries whose JSON launches come from phase 6's fp32 step
FP32_STEP_SIMT = ("relpos_flash_fwd_lse", "relpos_flash_dq",
                  "relpos_flash_dkv", "flash_backward_dq",
                  "flash_backward_dkv")
FP32_SIMT = ("grouped_plain_attention", "flash_forward_lse",
             "sam_global_attention", "sam_window_attention_q8")
# the tensor-core entries: phase 2 prints their registers, spills and
# HGMMA count (nvcc -Xptxas -v, cuobjdump -sass of the built library); K12's,
# K12q8's and K13's are K1's, K1q's and K2's instantiations under other names
TC_SOURCES = {"flash_attention_tc": "flash_attention.cu",
              "grouped_plain_attention_tc": "grouped_plain_attention.cu",
              "flash_forward_lse_tc": "flash_forward_lse.cu",
              "sam_global_attention_tc": "sam_global_attention.cu",
              "sam_window_attention_tc": "sam_window_attention.cu",
              "sam_window_attention_q8_tc": "sam_window_attention.cu",
              "relpos_flash_fwd_lse_tc": "relpos_flash_attention.cu",
              "prefill_attention_tc": "prefill_attention.cu",
              "relpos_flash_dkv_tc": "relpos_flash_attention.cu",
              "relpos_flash_dq_tc": "relpos_flash_attention.cu",
              "flash_backward_dkv_tc": "flash_backward.cu",
              "flash_backward_dq_tc": "flash_backward.cu",
              "flash_attention_relpos_tc": "streamed_relpos_attention.cu",
              "sam_window_attention_v2_tc": "sam_window_attention_v2.cu",
              "sam_window_attention_v2_q8_tc": "sam_window_attention_v2.cu",
              "folded_window_attention_tc": "folded_window_attention.cu",
              "folded_window_attention_v2_tc": "folded_window_attention.cu"}
# the entry macro names a kernel and its `_smem` export after its first
# argument, not after the extern entry: K13 v2's `_tc` entry runs the
# instantiation named for K13's file (`folded_window_attention_tc_kernel`),
# whose name K13 v1's `_tc` entry has
TC_INSTANCES = {"folded_window_attention_v2_tc": "folded_window_attention_tc"}
# the sources of K7a, K7b (both on `int4_matmul.cuh`) and K6, whose
# instantiations phase 2 prints ptxas's report of too
INT4_SOURCES = ("int4_matmul.cu", "int4_matmul_a8.cu")
K6_SOURCE = "int8_decode_attention.cu"
# K6 as the continuous engine of phase 9 calls it at full width: 4 slots
# over the default capacity of 2367 columns (padded to 2432), a tick at
# column 2432 - K6_ENGINE_TAIL, each slot's left pad col - Lb + pad as
# staggered admissions of 640-column buckets leave them
K6_ENGINE = (4, 32, 32, 2432, 128, "engine")
K6_ENGINE_TAIL = 300
K6_ENGINE_PADS = (1471, 1500, 1513, 1537)
# K7c's and K8c's sources, whose kernels phase 2 reports too
K7C_SOURCE = "int4_requant.cu"
K8C_SOURCE = "rmsnorm_quant.cu"
# K14's, whose two bodies phase 2 reports too
K14_SOURCE = "window_partition.cu"
PTXAS_SOURCES = sorted(set(TC_SOURCES.values()) | set(INT4_SOURCES)
                       | {K6_SOURCE, K7C_SOURCE, K8C_SOURCE, K14_SOURCE})
TRAIN_SEQ = 129          # max_seq_len: 129 + 575 spliced = 704 tokens
# K11-K14: public ops of the JAX package that no model path runs (nor do
# their JAX originals), each entry on both bodies where it has two; held in
# phase 2, launched 0 times on every path of phases 3-6 (phase 3's
# `_run_path`, `_check_off_path` in phases 4 and 6, `_step_launches` in
# phase 5)
OFF_PATH_KERNELS = ("flash_attention_relpos", "flash_attention_relpos_tc",
                    "sam_window_attention_v2", "sam_window_attention_v2_tc",
                    "sam_window_attention_v2_q8",
                    "sam_window_attention_v2_q8_tc", "folded_window_attention",
                    "folded_window_attention_tc", "folded_window_attention_v2",
                    "folded_window_attention_v2_tc", "window_partition",
                    "window_unpartition")
# the bf16 step at S = 2111 on the route the port took before K10 (K5
# forward, torch-ops backward): ms and peak GiB on one H100 80GB HBM3 at
# 700 W, printed beside this run's K10-route step
K5_ROUTE_S2111 = (1044.6, 34.27)
# the same step and the QLoRA one at S = 2111 with K10 on its SIMT body,
# and the bf16 CLIP encode_video (2 clips x 8 frames) with K3 on its SIMT
# body: ms on one H100 80GB HBM3 at 700 W, printed beside this run's
SIMT_S2111_MS = 1141.2
SIMT_QLORA_S2111_MS = 2003.0
SIMT_CLIP_MS = 67.4
# the bf16 and W8A8-static SAM encode_grounding and the bf16 teacher-forced
# forward_boxes (2 clips x 8 frames) with K1 and K1q on their SIMT bodies
# (K2 and K4 on the tensor-core one): ms on one H100 80GB HBM3 at 700 W,
# printed beside this run's
SIMT_K1_SAM_MS = {"bf16": 165.3, "W8A8-static": 360.8}
SIMT_K1_TEACHER_MS = 269.4
# the training steps with K1 and K9's forward on their SIMT bodies: the
# bf16 S = 704 step (median of steps 2-3) and S = 2111 step, the QLoRA
# steps (S = 704 twice, then 2111), ms on one H100 80GB HBM3 at 700 W,
# printed beside this run's
SIMT_K1_STEP_MS = {"bf16 S = 704": 519.2, "bf16 S = 2111": 983.6,
                   "QLoRA": (1315.5, 1093.7, 1674.1)}
# the QLoRA recipe (`benchmarks/train_finetune_scale.py`): LoRA rank, and
# the trainable parameters of GroveConfig() under it, 708,589,557 of the
# default freeze policy - 131,100,672 (lm_head, int8 and frozen) +
# 4,194,304 (LoRA: 32 layers x 2 x (4096 x 8 + 8 x 4096))
QLORA_R = 8
PHASE5_STEP = {}         # phase 5's median step ms and peak, for phase 12
QLORA_TRAINABLE = 581_683_189
# kernels a QLoRA step must not launch: K5 (the driver's ragged S takes
# K10), and the int4 decode kernels K7a-K7c (the frozen LLM's backward
# runs the recomputed bf16 view)
QLORA_NEVER = ("prefill_attention", "prefill_attention_tc", "int4_matmul",
               "int4_matmul_a8", "int4_requant_int8")
# phase 3's two clips ask different questions, so their prompts are
# left-padded to 640 tokens: the int8-cache prefill then takes K5 (the JAX
# rule: S % 8 == 0, 128 <= S <= 1100), with a left pad
PROMPTS = (None, "describe what happens in the video please")
# the [DET] branch of infer_clips_batched (`infer.sliding._finish_clip`)
# is driven with this caption tagged at two phrases: a man / bread
DET_CAPTION = "a man slices bread on a wooden board"
DET_SPANS = [(0, 5), (13, 18)]
TRAIN_LOSS_REL = 1e-4    # phase 6 loss terms card vs CPU, relative
TRAIN_GRAD_TOL = 1e-3    # phase 6 gradients, of each tensor's max-abs
# ... or of this share of the largest gradient's max-abs, where a tensor's
# own gradient is zero up to rounding (the attention k_proj biases of the
# box decoder: softmax ignores a shift shared by all keys)
TRAIN_GRAD_FLOOR = 1e-3
# the trainable groups of the default freeze policy that must get a
# gradient (the CLIP adapters sit behind the tower's no-grad)
TRAIN_GROUPS = {
    "SAM adapters": r"image_encoder\.adapters\.",
    "box head": r"mask_decoder\.bbox_prediction_head\.",
    "objectness head": r"mask_decoder\.temporal_objectness_head\.",
    "rest of the mask decoder":
        r"mask_decoder\.(?!bbox_prediction_head|temporal_objectness_head)",
    "text_hidden_fcs": r"text_hidden_fcs\.",
    "mm_projector": r"mm_projector\.",
    "lm_head": r"^lm_head\.",
    "embed_tokens": r"embed_tokens\.",
}
TRAIN_CAPTION = "a man slices bread on a wooden board"
TRAIN_SPANS = [(0, 5), (13, 18), (22, 36)]   # a man / bread / a wooden board
# one H100 SXM (NVIDIA's data sheet, dense): device memory and peak rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
CAPTION = "a person is slicing tomatoes on a wooden board"


class PhaseError(RuntimeError):
    pass


def write_y4m(path, packed, fps: int):
    """Write packed YUV420P frames, (T, 3H/2, W) uint8 (Y rows, then U and
    V side by side, the layout of `VideoDecoder.decode_at_yuv`), as a
    YUV4MPEG2 file at `fps`: a text header, then each frame's Y, U and V
    planes after a FRAME line. libavformat demuxes it as raw yuv420p."""
    t, h32, w = packed.shape
    h = h32 * 2 // 3
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C420jpeg\n".encode())
        for frame in packed:
            f.write(b"FRAME\n")
            f.write(frame[:h].tobytes())
            f.write(frame[h:, :w // 2].tobytes())
            f.write(frame[h:, w // 2:].tobytes())


def y4m_clip(path, seed: int, frames: int = 24, width: int = 640,
             height: int = 360, fps: int = 5):
    """A seeded clip written with `write_y4m`: a random image rolled 3
    pixels a frame (`SyntheticVideo`'s motion), in YUV420P. Returns the
    packed frames."""
    from grove_tpu_torch.data.preprocess import rgb_to_yuv420
    base = np.random.default_rng(seed).integers(0, 256, (height, width, 3),
                                                 dtype=np.uint8)
    packed = rgb_to_yuv420(np.stack([np.roll(base, 3 * i, axis=1)
                                     for i in range(frames)]))
    write_y4m(path, packed, fps)
    return packed


def say(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# phase 0 / 1
# ---------------------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is false: this script "
                         "needs an NVIDIA GPU; there is no CPU path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    gpu = smi.stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    say(0, f"device {torch.cuda.get_device_name(0)}, "
           f"count {torch.cuda.device_count()}, torch {torch.__version__}, "
           f"cuda {torch.version.cuda}")
    return gpu


def phase_decoder():
    """Whether the repo's native libav decoder (`native/libgrove_video.so`)
    loads on this machine, and if not, why (the shared objects `ldd` does
    not find). Returns "libav" or "synthetic": the decoder phase 3 and 4
    give `GroveProcessor`."""
    from grove_tpu_torch.data.video import LIB_PATH, probe_library
    why = probe_library()
    if why is None:
        say(0, f"{LIB_PATH.relative_to(ROOT)} loads: GroveProcessor decodes "
               "the .y4m clips with libav")
        return "libav"
    missing = ""
    try:
        ldd = subprocess.run(["ldd", str(LIB_PATH)], capture_output=True,
                             text=True, timeout=60).stdout
        missing = ", ".join(line.split()[0] for line in ldd.splitlines()
                            if "not found" in line)
    except (OSError, subprocess.SubprocessError):
        pass
    say(0, f"{LIB_PATH.relative_to(ROOT)} does not load ({why}; missing: "
           f"{missing or 'not listed'}): GroveProcessor runs on "
           "SyntheticVideo frames instead")
    return "synthetic"


def phase_build(compiles):
    """Build the library; first start `_tc_compiles` into `compiles`."""
    from grove_tpu_torch import _kernels
    t0 = time.perf_counter()
    compiles.update(_tc_compiles())
    path = _kernels.build()
    _kernels.load()
    say(1, f"built {path.name} from {len(_kernels.sources())} sources in "
           f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _cases(torch):
    """name -> dict(fn, plain, make(gen, dtype, shape) -> args, full
    shapes, small fp32 shapes, cold, int8 limits, ops(args) -> (count,
    peak key), library(args) -> a call of PyTorch's own, or None)."""
    import torch.nn.functional as F
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.models import layers
    from grove_tpu_torch.ops import (attention, decode_attention,
                                     flash_backward, fused_ln, int4_matmul,
                                     sam_attention, sam_attention_bwd,
                                     window_ops)

    def randn(gen, shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    def uniform(gen, shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device="cuda")

    def int8s(gen, shape, lo=-127):
        return torch.randint(lo, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def k1_inputs(gen, dtype, shape):
        nw, win, heads, d = shape[:4]
        s, c = win * win, heads * d
        qkv = randn(gen, (nw, s, 3 * c), dtype)
        rel = randn(gen, (nw, s, heads * 2 * win), dtype)
        if len(shape) > 4:
            # row 0 of window 0: every logit near -800 in log2 units, far
            # below EXP2_SHIFT - 126, so the TPU kernel returns 0 there
            kq = qkv[0].view(s, 3, heads, d)
            kq[:, 1] = 1.0 + 0.3 * randn(gen, (s, heads, d), dtype)
            kq[0, 0] = -73.0
            rel[0, 0] = 0.0
        return (qkv, rel, (win, win), heads)

    def k2_inputs(gen, dtype, shape):
        b, g, heads, d = shape
        s = g * g
        q, k, v = (randn(gen, (b, s, heads, d), dtype) for _ in range(3))
        rh = randn(gen, (b, heads, s, g), dtype)
        rw = randn(gen, (b, heads, s, g), dtype)
        return (q, k, v, rh, rw, (g, g))

    def qkv_inputs(gen, dtype, shape):
        return tuple(randn(gen, shape, dtype) for _ in range(3))

    def k2_simt(q, k, v, rh, rw, hw):
        return sam_attention._launch_grid(
            "sam_global_attention", "sam_global_attention", q, k, v, rh, rw,
            hw, q.shape[2], q.shape[3])

    # K11's SIMT entry, called directly, so that bf16 reaches it too
    def k11_simt(q, k, v, rh, rw, hw):
        return sam_attention._launch_grid(
            "flash_attention_relpos", "flash_attention_relpos", q, k, v, rh,
            rw, hw, q.shape[2], q.shape[3])

    # K2's tensor-core body's arithmetic, which K11 runs (P to bf16 before
    # P.V, the TPU kernel's rounding point)
    def k11_tc_plain(q, k, v, rh, rw, hw):
        return attention.tc_attention_torch(
            q, k, v, scale=q.shape[-1] ** -0.5, bias=(rh, rw, hw[1]))

    def k4_inputs(gen, dtype, shape):
        b, s, heads, d, causal = shape
        return (*qkv_inputs(gen, dtype, (b, s, heads, d)), causal)

    def k4(q, k, v, causal):
        return flash_backward.flash_forward_lse(
            q, k, v, causal=causal, scale=q.shape[-1] ** -0.5)

    def k4_simt(q, k, v, causal):
        return flash_backward._lse_launch("flash_forward_lse", q, k, v,
                                          causal, q.shape[-1] ** -0.5)

    def k4_plain(q, k, v, causal):
        return flash_backward.flash_forward_lse_torch(
            q, k, v, causal=causal, scale=q.shape[-1] ** -0.5)

    # K4b's cases: (b, s, h, d) causal, (b, s, h, d, False) not; lse and D
    # from the plain forward, as the backward receives them
    def k4b_inputs(gen, dtype, shape):
        causal = shape[4] if len(shape) > 4 else True
        q, k, v, g = (randn(gen, shape[:4], dtype) for _ in range(4))
        out, lse = flash_backward.flash_forward_lse_torch(
            q, k, v, causal=causal, scale=shape[3] ** -0.5)
        return (q, k, v, g, lse, flash_backward.row_dot(out, g), causal)

    def k4b_dq(q, k, v, g, lse, dc, causal):
        return flash_backward.flash_backward_dq(
            q, k, v, g, lse, dc, causal=causal, scale=q.shape[-1] ** -0.5)

    def k4b_dq_plain(q, k, v, g, lse, dc, causal):
        return flash_backward.flash_backward_dq_torch(
            q, k, v, g, lse, dc, causal=causal, scale=q.shape[-1] ** -0.5)

    # K4b's dq SIMT entry, called directly, so that bf16 reaches it too
    def k4b_dq_simt(q, k, v, g, lse, dc, causal):
        return flash_backward._dq_launch("flash_backward_dq", q, k, v, g,
                                         lse, dc, causal,
                                         q.shape[-1] ** -0.5)

    # the tensor-core dq body's arithmetic (dS to bf16 before dS.K, where
    # the TPU K4b keeps it in fp32)
    def k4b_dq_tc_plain(q, k, v, g, lse, dc, causal):
        return flash_backward.flash_backward_dq_tc_torch(
            q, k, v, g, lse, dc, causal=causal, scale=q.shape[-1] ** -0.5)

    def k4b_dkv_plain(q, k, v, g, lse, dc, causal):
        return flash_backward.flash_backward_dkv_torch(
            q, k, v, g, lse, dc, causal=causal, scale=q.shape[-1] ** -0.5)

    # K4b's dkv SIMT entry, called directly, so that bf16 reaches it too
    def k4b_dkv_simt(q, k, v, g, lse, dc, causal):
        return flash_backward._dkv_launch("flash_backward_dkv", q, k, v, g,
                                          lse, dc, causal,
                                          q.shape[-1] ** -0.5)

    def k4b_dkv_tc(q, k, v, g, lse, dc, causal):
        return flash_backward.flash_backward_dkv(
            q, k, v, g, lse, dc, causal=causal, scale=q.shape[-1] ** -0.5)

    # the tensor-core body's arithmetic (P and dS to bf16 before the
    # products, where the TPU K4b keeps them in fp32)
    def k4b_dkv_tc_plain(q, k, v, g, lse, dc, causal):
        return flash_backward.flash_backward_dkv_tc_torch(
            q, k, v, g, lse, dc, causal=causal, scale=q.shape[-1] ** -0.5)

    def k9_inputs(gen, dtype, shape):
        return (*k2_inputs(gen, dtype, shape), shape[-1] ** -0.5)

    def k9_bwd_inputs(gen, dtype, shape):
        q, k, v, rh, rw, hw, scale = k9_inputs(gen, dtype, shape)
        g = randn(gen, q.shape, dtype)
        out, lse = sam_attention_bwd.relpos_flash_fwd_lse_torch(
            q, k, v, rh, rw, hw, scale)
        return (q, k, v, rh, rw, g, lse, flash_backward.row_dot(out, g), hw,
                scale)

    def k10_inputs(gen, dtype, shape):
        b, sq, sk, heads, d, causal = shape
        if not attention._flash_takes_kernel(sq, sk, causal,
                                             attention.DEFAULT_BLOCK_K):
            raise PhaseError(f"flash_attention {shape}: takes xla_attention")
        q = randn(gen, (b, sq, heads, d), dtype)
        k, v = (randn(gen, (b, sk, heads, d), dtype) for _ in range(2))
        return (q, k, v, causal)

    def k10(q, k, v, causal):
        return attention.flash_attention(q, k, v, causal=causal)

    # the SIMT entries called directly, so that bf16 reaches them too
    def k10_simt(q, k, v, causal):
        return attention._flash_launch("flash_attention", q, k, v, causal,
                                       q.shape[-1] ** -0.5)

    def k3_simt(q, k, v):
        return attention._grouped_plain_launch(
            "grouped_plain_attention", q, k, v, q.shape[-1] ** -0.5)

    def k10_plain(q, k, v, causal):
        return attention.flash_attention_torch(q, k, v, causal=causal)

    def k5_inputs(gen, dtype, shape):
        b, s, heads, d, pad = shape
        q, k, v = (randn(gen, (b, s, heads * d), dtype) for _ in range(3))
        pads = torch.tensor([0, pad][:b], device="cuda", dtype=torch.int32)
        return (q, k, v, pads, heads, d ** -0.5)

    # K5's SIMT entry, called directly, so that bf16 reaches it too
    def k5_simt(q, k, v, pads, heads, scale):
        return attention._prefill_launch("prefill_attention", q, k, v, pads,
                                         heads, scale)

    # the tensor-core body's arithmetic with K5's pad (P to bf16 before
    # P.V, the TPU kernel's rounding point), in the raw layout
    def k5_tc_plain(q, k, v, pads, heads, scale):
        b, s, c = q.shape
        q, k, v = (t.view(b, s, heads, c // heads) for t in (q, k, v))
        out = attention.tc_attention_torch(q, k, v, scale=scale, causal=True,
                                           pad=pads)
        return out.reshape(b, s, c)

    def k5_pad_rows(args, got):
        # a row inside its batch's pad attends to itself only: its output
        # is its own v row, exactly; no value is NaN or inf
        q, v, pads = args[0], args[2], args[3]
        if not bool(torch.isfinite(got).all()):
            raise PhaseError(f"prefill_attention {tuple(q.shape)}: an "
                             "output is not finite")
        rows = 0
        for i, p in enumerate(pads.tolist()):
            if not torch.equal(got[i, :p], v[i, :p]):
                raise PhaseError(f"prefill_attention {tuple(q.shape)}: a "
                                 f"row inside batch {i}'s pad of {p} is "
                                 "not its own v row")
            rows += p
        return f"; the {rows} rows inside the pads equal their v rows"

    def k6_inputs(gen, dtype, shape):
        b, h, hkv, c, d = shape[:5]
        q = randn(gen, (b, h, d), dtype)
        kt, vt = int8s(gen, (b, hkv, c, d)), int8s(gen, (b, hkv, c, d))
        ks, vs = (uniform(gen, (b, hkv, c), 0.001, 0.02).to(torch.bfloat16)
                  for _ in range(2))
        bias = torch.zeros((b, c), device="cuda")
        if shape[5:] == ("engine",):
            # a continuous-engine tick (`serve/continuous.py`): each slot's
            # own left pad col - Lb + pad, the columns up to col written,
            # the rest (and the pad past the capacity) not yet
            col = c - K6_ENGINE_TAIL
            for i in range(b):
                bias[i, :K6_ENGINE_PADS[i % len(K6_ENGINE_PADS)]] = \
                    decode_attention.NEG_INF
            bias[:, col + 1:] = decode_attention.NEG_INF
            return (q, kt, vt, ks, vs, bias)
        bias[0, c - 60:] = decode_attention.NEG_INF       # unwritten tail
        if b > 1:
            bias[1, :9] = decode_attention.NEG_INF        # a left pad
            bias[1, c - 100:] = decode_attention.NEG_INF
        if len(shape) > 5:
            # "masked": the last rank of batch 0 and the first of batch 1
            # all masked (a tail past half the cache, a long left pad)
            bias[0, c // 2:] = decode_attention.NEG_INF
            bias[-1, :c // 2 + 3] = decode_attention.NEG_INF
        return (q, kt, vt, ks, vs, bias)

    def k7a_inputs(gen, dtype, shape):
        m, k, n, g = shape
        return (randn(gen, (m, k), dtype), int8s(gen, (k // 2, n), -128),
                uniform(gen, (k // g, n), 0.001, 0.02))

    def k7b_inputs(gen, dtype, shape):
        # dtype is the output's: the activations arrive int8
        m, k, n, g = shape
        return (int8s(gen, (m, k)), uniform(gen, (m, 1), 0.002, 0.02),
                int8s(gen, (k // 2, n), -128),
                uniform(gen, (k // g, n), 0.001, 0.02), dtype)

    def k7c_inputs(gen, dtype, shape):
        k, n, g = shape
        scale = uniform(gen, (k // g, n), 0.001, 0.02)
        return (int8s(gen, (k // 2, n), -128),
                int4_matmul.requant_multipliers(scale)[1])

    def k1q_inputs(gen, dtype, shape):
        qkv, rel, hw, heads = k1_inputs(gen, dtype, shape)
        # an act scale that puts the outputs across the int8 range
        inv = torch.full((1,), 64.0, device="cuda")
        return (qkv, rel, hw, heads, inv)

    def k1q(qkv, rel, hw, heads, inv):
        return sam_attention.grouped_window_attention_relpos_v3(
            qkv, rel, hw, heads, inv_scale=inv)

    def k1q_plain(qkv, rel, hw, heads, inv):
        return sam_attention.grouped_window_attention_relpos_v3_q8_torch(
            qkv, rel, inv, hw, heads)

    # K1q's plain version with the tensor-core body's rounding points (P
    # in bf16 before P.V): one rounding of P apart, the fp32 twin differs
    # from it by an LSB on about 2% of the int8 outputs
    def k1q_tc_plain(qkv, rel, hw, heads, inv):
        return sam_attention.grouped_window_attention_relpos_v3_tc_torch(
            qkv, rel, hw, heads, inv_scale=inv)

    # the SIMT entries of K1, K1q and K9's forward, called directly, so
    # that bf16 reaches them too
    def k1_simt(qkv, rel, hw, heads):
        return sam_attention._window_launch("sam_window_attention", qkv,
                                            rel, hw, heads)

    def k1q_simt(qkv, rel, hw, heads, inv):
        return sam_attention._window_launch("sam_window_attention_q8", qkv,
                                            rel, hw, heads, inv)

    def k9_simt(q, k, v, rh, rw, hw, scale):
        return sam_attention_bwd._fwd_launch("relpos_flash_fwd_lse", q, k, v,
                                             rh, rw, hw, scale)

    def k9_dkv_simt(*args):
        return sam_attention_bwd._dkv_launch("relpos_flash_dkv", *args)

    def k9_dq_simt(*args):
        return sam_attention_bwd._dq_launch("relpos_flash_dq", *args)

    # the SIMT entries of K12 and K13, called directly, so that bf16
    # reaches them too
    def k12_simt(q, k, v, rel, hw, heads):
        return sam_attention._split_launch("sam_window_attention_v2", q, k, v,
                                           rel, hw, heads)

    def k12q_simt(q, k, v, rel, inv, hw, heads):
        return sam_attention._split_launch("sam_window_attention_v2_q8", q, k,
                                           v, rel, hw, heads, inv)

    def k13_simt(q, k, v, rh, rw, hw):
        return sam_attention._launch_grid(
            "folded_window_attention", "folded_window_attention_relpos", q, k,
            v, rh, rw, hw, q.shape[2], q.shape[3])

    def k13v2_simt(q, k, v, rh, rw, hw, heads):
        return sam_attention._launch_grid(
            "folded_window_attention_v2", "folded_window_attention_relpos_v2",
            q, k, v, rh, rw, hw, heads, q.shape[2] // heads)

    def k12_inputs(gen, dtype, shape):
        # K1's inputs (the all-underflow row included), q / k / v split
        qkv, rel, hw, heads = k1_inputs(gen, dtype, shape)
        c = qkv.shape[-1] // 3
        return (*(qkv[..., i * c:(i + 1) * c].contiguous()
                  for i in range(3)), rel, hw, heads)

    def k12q_inputs(gen, dtype, shape):
        q, k, v, rel, hw, heads = k12_inputs(gen, dtype, shape)
        return (q, k, v, rel, torch.full((1,), 64.0, device="cuda"), hw,
                heads)

    def k13v2_inputs(gen, dtype, shape):
        q, k, v, rh, rw, hw = k2_inputs(gen, dtype, shape)
        b, s, h, d = q.shape
        return (*(t.view(b, s, h * d) for t in (q, k, v)), rh, rw, hw, h)

    def k14_dtype(shape, dtype):
        return getattr(torch, shape[5]) if len(shape) > 5 else dtype

    def k14_grid(gen, dtype, shape):
        b, h, w, c, win = shape[:5]
        dt = k14_dtype(shape, dtype)
        x = (int8s(gen, (b, h, w, c)) if dt == torch.int8
             else randn(gen, (b, h, w, c), dt))
        return (x, win)

    def k14_windows(gen, dtype, shape):
        b, h, w, c, win = shape[:5]
        dt = k14_dtype(shape, dtype)
        n = b * -(-h // win) * -(-w // win)
        wins = (int8s(gen, (n, win, win, c)) if dt == torch.int8
                else randn(gen, (n, win, win, c), dt))
        return (wins, win, (h, w))

    # K14's launch, as `window_copy_plan` makes it (its rows, their CTAs and
    # the body); the library's must agree row for row
    def k14_plan(args, got):
        src, win = args[0], args[1]
        unpart = len(args) == 3
        b, h, w, c = got.shape if unpart else src.shape
        sms = _kernels.sm_count(src.device)
        dims = (b, h, w, c, win, src.element_size(), sms, int(unpart))
        p = window_ops.window_copy_plan(*dims[:7], unpart)
        lib = _lib_plan("grove_window_copy_plan", 6, *dims)
        want = (window_ops.BODIES.index(p.body), p.slots, p.smem, p.per_sm,
                p.ctas, p.rows)
        rows = _lib_rows(dims, p.rows)
        mine = np.stack([p.src, p.dst, p.valid, p.zero, p.cta], 1)
        if lib != want or not np.array_equal(rows, mine):
            raise PhaseError(f"{'un' * unpart}partition {dims[:5]}: the "
                             f"library plans {lib}, window_copy_plan {want}"
                             f"; rows equal: {np.array_equal(rows, mine)}")
        return (f"; plan: the {p.body} body, {p.ctas} CTAs over {p.rows} "
                f"rows" + (f", {p.per_sm} an SM, {p.slots} row slots, "
                           f"{p.smem} B shared a CTA"
                           if p.body == "bulk" else "")
                + f" (the library's the same, row for row), {sms} SMs")

    # the bytes a correct K14 call must move: the valid pixels read once,
    # every output byte written once (the partition's zeros included)
    def k14_bytes(args, out):
        src, win = args[0], args[1]
        unpart = len(args) == 3
        b, h, w, c = out.shape if unpart else src.shape
        p = window_ops.window_copy_plan(b, h, w, c, win,
                                        src.element_size(), 1, unpart)
        return int(p.valid.sum()) + out.numel() * out.element_size()

    # K14's plain versions: torch's own pad + view + permute copy (also
    # its library_ms, labeled so)
    def k14_part_plain(x, win):
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, (-w) % win, 0, (-h) % win))
        return window_ops.window_partition_torch(x, win)

    def k14_unpart_plain(wins, win, hw):
        h, w = hw
        hp, wp = -(-h // win) * win, -(-w // win) * win
        b = wins.shape[0] // ((hp // win) * (wp // win))
        out = window_ops.window_unpartition_torch(wins, win, b, hp, wp)
        return out[:, :h, :w]

    def ln_inputs(gen, dtype, shape, add=False):
        rows, c = shape
        x = (randn(gen, (rows, c), torch.float32) * 2 + 0.3).to(dtype)
        s = 0.03                  # saturates the largest few outputs
        gs = uniform(gen, (c,), 0.5, 1.5) / s
        bs = 0.1 * randn(gen, (c,), torch.float32) / s
        if add:
            return (x, randn(gen, (rows, c), dtype), gs, bs, 1e-6)
        return (x, gs, bs, 1e-5)

    def rms_inputs(gen, dtype, shape, add=False):
        rows, c = shape
        x = (randn(gen, (rows, c), torch.float32) * 2 + 0.3).to(dtype)
        w = uniform(gen, (c,), 0.5, 1.5)
        if add:
            return (x, randn(gen, (rows, c), dtype), w, 1e-6)
        return (x, w, 1e-6)

    def rms(x, w, eps):
        return fused_ln.add_rmsnorm_quant_dyn(x, None, w, eps=eps)

    def rms_plain(x, w, eps):
        return fused_ln.add_rmsnorm_quant_dyn_torch(x, None, w, eps)

    def add_rms(a, b, w, eps):
        return fused_ln.add_rmsnorm_quant_dyn(a, b, w, eps=eps)

    def add_rms_plain(a, b, w, eps):
        return fused_ln.add_rmsnorm_quant_dyn_torch(a, b, w, eps)

    # operation counts: an attention pair of (query, key) costs 2 * 2 * D
    # flops (the QK dot and the PV update); the norms count ~8 fp32
    # operations per element; K7c only moves and shifts bytes
    def attn_ops(b, h, d, pairs):
        return 4 * b * h * d * pairs

    def k1_ops(a):
        qkv, heads = a[0], a[3]
        nw, s, c3 = qkv.shape
        return attn_ops(nw, heads, c3 // 3 // heads, s * s), "bf16"

    def bshd_ops(a, causal=False):
        b, s, h, d = a[0].shape
        return attn_ops(b, h, d, s * (s + 1) // 2 if causal else s * s), \
            "bf16"

    def bwd_ops(a, matmuls, causal=False):
        # as the TPU kernels count it: 3 matmuls in dq (q.k, dO.v, ds.k), 4
        # in dkv (q.k, dO.v, p.dO, ds.q), each 2 * D flops per pair
        b, s, h, d = a[0].shape
        pairs = s * (s + 1) // 2 if causal else s * s
        return 2 * matmuls * b * h * d * pairs, "bf16"

    def raw_ops(a, heads):
        # q (B, S, H*D) raw projection layout
        b, s, c = a[0].shape
        return attn_ops(b, heads, c // heads, s * s), "bf16"

    def k5_ops(a):
        q, pads, heads = a[0], a[3], a[4]
        b, s, c = q.shape
        # row r attends keys [pad, r], and a pad row only itself
        pairs = sum(p + (s - p) * (s - p + 1) // 2
                    for p in pads.tolist())
        return attn_ops(1, heads, c // heads, pairs), "bf16"

    def k10_ops(a):
        # causal is top-left aligned: row i attends keys 0..min(i, Sk - 1)
        q, k, causal = a[0], a[1], a[3]
        b, sq, h, d = q.shape
        sk = k.shape[1]
        pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
                 else sq * sk)
        return attn_ops(b, h, d, pairs), "bf16"

    def k6_ops(a):
        b, h, d = a[0].shape
        return attn_ops(b, h, d, a[1].shape[2]), "int8"

    def k7a_ops(a):                         # (x, wp, scale)
        m, k = a[0].shape
        return 2 * m * k * a[1].shape[1], "bf16"

    # K7a's yardstick: one bf16 GEMM on the dequantized (K, N) weight (the
    # view the port's int4 prefill multiplies by), built outside the call
    def k7a_library(x, wp, scale):
        view = layers._int4_view(wp, scale, x.shape[1] // scale.shape[0],
                                 x.dtype)
        return lambda: torch.matmul(x, view)

    # the launch of K7a and K7b at each shape, as `_plan` makes it
    def int4_plan(x, wp, scale):
        m, k = x.shape
        n, g = wp.shape[1], k // scale.shape[0]
        sms = _kernels.sm_count(x.device)
        p = int4_matmul._plan(m, k, n, g, sms, x.element_size())
        return (f"; plan: {p.ctas} CTAs ({p.tiles} tiles x cluster "
                f"{p.cluster} x {p.row_blocks} row blocks of {p.mt}), at "
                f"most {p.per_sm} an SM of {sms}, {p.vec}-byte copies, x "
                f"{'staged' if p.staged else 'from global'}, {p.smem} B "
                f"shared a CTA")

    def k7a_plan(args, got):
        return int4_plan(*args)

    def k7b_plan(args, got):                # (xq, sx, wp, scale, dtype)
        return int4_plan(args[0], *args[2:4])

    # K7c's launch, as `_requant_plan` makes it; the library's must agree
    def k7c_plan(args, got):
        wp, mult = args
        kh, n = wp.shape
        g = 2 * kh // mult.shape[0]
        sms = _kernels.sm_count(wp.device)
        p = int4_matmul._requant_plan(kh, n, g, sms)
        lib = _lib_plan("grove_int4_requant_int8_plan", 5, kh, n, g, sms)
        if lib != (p.rows, p.tiles, p.ctas, p.stages, p.smem):
            raise PhaseError(f"int4_requant_int8 {(kh, n, g)}: the library "
                             f"plans {lib}, _requant_plan {p}")
        return (f"; plan: {p.ctas} CTAs over {p.tiles} tiles of {p.rows} "
                f"packed rows x {int4_matmul.REQUANT_TILE_N} columns, "
                f"{p.stages} stages, {p.smem} B shared a CTA (the "
                f"library's the same), {sms} SMs")

    # K8c's launch, as `_rms_plan` makes it; the library's must agree
    def k8c_plan(args, got):
        a, add = args[0], len(args) == 4
        rows, c = a.numel() // a.shape[-1], a.shape[-1]
        sms = _kernels.sm_count(a.device)
        p = fused_ln._rms_plan(rows, c, sms, a.element_size(), add)
        lib = _lib_plan("grove_rmsnorm_quant_plan", 4, rows, c,
                        _kernels.dtype_code("rmsnorm_quant", a), int(add),
                        sms)
        if lib != (p.slots, p.smem, p.per_sm, p.ctas):
            raise PhaseError(f"rmsnorm_quant {(rows, c, add)}: the library "
                             f"plans {lib}, _rms_plan {p}")
        return (f"; plan: {p.ctas} CTAs, {p.per_sm} an SM, {p.slots} row "
                f"slots, {p.smem} B shared a CTA (the library's the same), "
                f"{sms} SMs")

    # K6's launch, as `_plan` makes it
    def k6_plan(args, got):
        q, kt = args[0], args[1]
        b, h, d = q.shape
        hkv, c = kt.shape[1:3]
        sms = _kernels.sm_count(q.device)
        p = decode_attention._plan(b, h, hkv, c, d, sms)
        return (f"; plan: {p.ctas} CTAs ({b * hkv} clusters of {p.cluster}, "
                f"ranks of {p.span} slots at most), {p.ring} bulk-copy "
                f"buffers of {decode_attention.CHUNK} slots, {p.smem} B "
                f"shared a CTA, {sms} SMs")

    def k7b_ops(a):                         # (xq, sx, wp, scale, dtype)
        m, k = a[0].shape
        return 2 * m * k * a[2].shape[1], "int8"

    # K7b's yardstick, K7a's: one bf16 GEMM of the dequantized activations
    # on the dequantized (K, N) weight, both built outside the call
    def k7b_library(xq, sx, wp, scale, dtype):
        x = (xq.float() * sx).to(torch.bfloat16)
        return k7a_library(x, wp, scale)

    # K6's yardstick: SDPA of the one query over a bf16 cache of the same
    # (B, H, C, D), the bias as its mask (what a bf16-cache decode step
    # reads: twice K6's bytes), the cache built outside the call
    def k6_library(q, kt, vt, ks, vs, bias):
        group = q.shape[1] // kt.shape[1]
        k, v = ((t.float() * sc[..., None].float()).to(q.dtype)
                .repeat_interleave(group, 1) for t, sc in ((kt, ks),
                                                           (vt, vs)))
        mask = bias[:, None, None, :].to(q.dtype)
        return lambda: F.scaled_dot_product_attention(q[:, :, None], k, v,
                                                      attn_mask=mask)

    def norm_ops(a):
        return 8 * a[0].numel(), "fp32"

    # one PyTorch call computing the same function, for its time only
    def sdpa(q, k, v, **kw):
        return lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)

    def k1_library(qkv, rel, hw, heads):
        q, k, v = sam_attention._split_heads(qkv, heads)
        nw, s = qkv.shape[:2]
        r = rel.reshape(nw, s, heads, hw[0] + hw[1]).permute(0, 2, 1, 3)
        bias = sam_attention._expand_bias(r[..., :hw[0]], r[..., hw[0]:])
        return sdpa(q, k, v, attn_mask=bias.to(qkv.dtype))

    def k2_library(q, k, v, rh, rw, hw):
        bias = sam_attention._expand_bias(rh, rw)
        return sdpa(q, k, v, attn_mask=bias.to(q.dtype))

    def k12_library(q, k, v, rel, hw, heads, *inv):
        nw, s, c = q.shape
        return k1_library(torch.cat([q, k, v], dim=-1), rel, hw, heads)

    def k13v2_library(q, k, v, rh, rw, hw, heads):
        b, s, c = q.shape
        return k2_library(*(t.view(b, s, heads, c // heads)
                            for t in (q, k, v)), rh, rw, hw)

    def sdpa_grad(q, k, v, g, **kw):
        # SDPA's backward alone: one forward kept, autograd.grad timed
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
        gt = g.transpose(1, 2)
        return lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                           retain_graph=True)

    def k4b_library(q, k, v, g, lse, dc, causal):
        return sdpa_grad(q, k, v, g, is_causal=causal)

    def k9_library(q, k, v, rh, rw, hw, scale):
        return k2_library(q, k, v, rh, rw, hw)

    def k9_bwd_library(q, k, v, rh, rw, g, lse, dc, hw, scale):
        bias = sam_attention._expand_bias(rh, rw)
        return sdpa_grad(q, k, v, g, attn_mask=bias.to(q.dtype))

    def k5_library(q, k, v, pads, heads, scale):
        b, s, c = q.shape
        pos = torch.arange(s, device=q.device)
        qp, kp = pos[:, None], pos[None, :]
        pad = pads.long()[:, None, None, None]
        mask = (kp <= qp) & ((kp >= pad) | (kp == qp))
        q, k, v = (t.view(b, s, heads, c // heads) for t in (q, k, v))
        return sdpa(q, k, v, attn_mask=mask, scale=scale)

    # full-width shapes of the main paths: 16 frames (2 clips x 8) of SAM
    # (9 windows each) and CLIP, 2 teacher-forced windows of LLaMA-7B, the
    # int8-cache prefill (2 x 640 tokens) and decode step of the quantized
    # runs (M = 2 rows, a 768-slot cache), and the W4A8 projections
    def case(fn, plain, make, full, small, ops, cold=False, int8=None,
             library=None, rows=False, exact=False, library_is=None,
             edges=(), simt=None, tols=None, against=None, check=None,
             against_lsb=None, nbytes=None):
        """int8: (LSB, share) limits of an int8 output, full bf16 and small
        fp32, instead of the float error limits. rows: every full bf16
        output (and each of `edges`') held row by row as well
        (`_check_rows`).
        exact: every output bit-equal to the plain version's (a copy).
        library_is: what the library call is, where it is not SDPA.
        edges: small bf16 shapes held within FULL_TOL, untimed. simt: the
        SIMT entry of a tensor-core case, timed beside it back to back
        (`_queued_ms`) with the library call. tols: each output's bf16
        limit, of its max-abs, where not FULL_TOL for all. against: the
        fp32 twin of a tensor-core case whose plain version has the body's
        rounding points; it holds each full-width float output within
        FULL_TOL of its own max-abs, and of an int8 output prints how many
        LSB apart on what share (and holds it within `against_lsb`, (LSB,
        share), where given). nbytes(args, out): the bytes a correct call
        moves, where not every input read whole and every output written
        (`_bound`).
        check(args, got) -> note: a further check of the kernel's
        output at every shape, raising PhaseError where it fails. An int8
        case holds its edges in LSBs at its full limits; an edge or small
        shape ending in "underflow" carries an all-underflow row (row 0 of
        window 0), which must be exactly 0."""
        return dict(fn=fn, plain=plain, make=make, full=full, small=small,
                    cold=cold, int8=int8, ops=ops, library=library,
                    rows=rows, exact=exact, library_is=library_is,
                    edges=edges, simt=simt, tols=tols, against=against,
                    check=check, against_lsb=against_lsb, nbytes=nbytes)

    proj_shapes = [(4096, 4096), (4096, 11008), (11008, 4096)]
    # K7a's edges, fp32 and bf16: one row, a row block of 5, 5 row blocks,
    # N % 16 != 0 (4-byte copies), K = 2G (a cluster of 1); and apart, K
    # ranges too long for shared memory at 7 rows (x read from global
    # memory: fp32 from K = 12288, bf16 from 24576)
    k7a_edges = [(1, 512, 384, 128), (5, 512, 384, 128), (37, 768, 256, 32),
                 (3, 1024, 68, 64), (3, 256, 96, 128)]
    # K7b takes the same edges (int8 x from global memory past K = 47360
    # at 7 rows). K6's, fp32 and bf16: GQA (2, 3, 4 and 8 query heads a kv
    # head), D 64 and 128, C 128 to 768 (ranks of 64 to 384 slots, C / 128
    # not a multiple of the ranks), "masked": a rank whose slots are all
    # masked in each batch row
    k6_small = [(2, 8, 2, 256, 64), (2, 4, 4, 128, 128), (1, 12, 12, 640, 64),
                (2, 12, 4, 128, 64), (2, 8, 2, 384, 128, "masked"),
                (2, 16, 2, 768, 128, "masked"), (2, 6, 3, 640, 64, "masked"),
                (2, 32, 32, 768, 128, "masked"), K6_ENGINE]
    # the training step's shapes: LLaMA-7B at S = 704 (batch 1); SAM's 21
    # windowed blocks (8 frames x 9 windows of 14 x 14) and 3 global ones
    # (8 frames of 32 x 32) after the first trainable adapter
    k9_full = [(72, 14, 16, 80), (8, 32, 16, 80)]
    k9_small = [(2, 4, 2, 8), (3, 14, 2, 64), (1, 8, 4, 80)]
    k4b_small = [(2, 192, 4, 64), (1, 45, 4, 8), (2, 130, 2, 80)]
    # the bf16 edges of K4b's dq and dkv on the tensor-core body: S of 3 to
    # 704, ragged last tiles, causal and not, every head dim, B.H > 1
    k4b_edges = [(2, 3, 2, 64), (1, 63, 2, 128), (2, 65, 2, 64),
                 (1, 129, 4, 128), (1, 200, 2, 80), (1, 704, 2, 128),
                 (1, 100, 2, 64, False), (2, 257, 2, 128, False),
                 (1, 130, 2, 80, False)]
    # the bf16 edges of K1, K1q and K9's forward on the tensor-core body:
    # grids of 2 x 2 (one partial key tile) to 32 x 32 (16 tiles), 7 x 7
    # and 14 x 14 ragged, 16 x 16 whole tiles; every head dim; B.H > 1; K1
    # and K1q also with an all-underflow row (exact zeros)
    window_edges = [(b, g, 2, d) for g, b in ((2, 4), (4, 2), (7, 1),
                                              (14, 2), (16, 1), (32, 1))
                    for d in (64, 80, 128)]
    window_edges += [(2, g, 2, d, "underflow") for g, d in ((14, 80),
                                                            (7, 64))]
    # the bf16 edges of K2 and K11: grids of 2 x 2 to 32 x 32 (12 x 12 and
    # 14 x 14 cut grid rows anywhere in a 64-key tile and leave a ragged
    # last tile), every head dim, B.H > 1
    k2_edges = [(b, g, 2, d) for g, b in ((2, 2), (4, 1), (12, 1), (14, 2),
                                          (32, 1))
                for d in (64, 80, 128)]
    # K14's small shapes (b, h, w, c, win[, dtype]; fp32 where none is
    # named): the vector body, then the bulk body
    k14_small = [(2, 10, 10, 8, 4, "int8"), (2, 7, 9, 3, 4, "int8"),
                 (1, 30, 30, 20, 14, "bfloat16"), (1, 8, 8, 16, 4),
                 (2, 30, 30, 64, 14, "bfloat16"), (1, 20, 34, 16, 7, "int8"),
                 (2, 28, 28, 32, 14)]
    return {
        # K1's SIMT entry, called directly in bf16 at full width (for its
        # time beside the tensor-core entry's) and in fp32 as the wrapper
        # calls it
        "sam_window_attention": case(
            k1_simt, sam_attention.grouped_window_attention_relpos_v3_torch,
            k1_inputs, [(144, 14, 16, 80)],
            [(4, 8, 6, 64), (3, 2, 4, 8), (2, 4, 2, 64, "underflow")],
            k1_ops, library=k1_library),
        # K1's tensor-core entry, through the wrapper (bf16, D 64 / 80 /
        # 128)
        "sam_window_attention_tc": case(
            sam_attention.grouped_window_attention_relpos_v3,
            sam_attention.grouped_window_attention_relpos_v3_torch,
            k1_inputs, [(144, 14, 16, 80)], [], k1_ops, library=k1_library,
            edges=window_edges, simt=k1_simt),
        # K2's SIMT entry, called directly in bf16 at full width (for its
        # time beside the tensor-core entry's) and in fp32 as the wrapper
        # calls it
        "sam_global_attention": case(
            k2_simt, sam_attention.grouped_window_attention_relpos_torch,
            k2_inputs, [(16, 32, 16, 80)], [(2, 16, 6, 64), (2, 4, 4, 8)],
            bshd_ops, library=k2_library),
        # K2's tensor-core entry, through the wrapper (bf16, D 64 / 80 /
        # 128)
        "sam_global_attention_tc": case(
            sam_attention.grouped_window_attention_relpos,
            sam_attention.grouped_window_attention_relpos_torch,
            k2_inputs, [(16, 32, 16, 80)], [], bshd_ops, library=k2_library,
            edges=k2_edges, simt=k2_simt),
        # K3's SIMT entry, called directly in bf16 at full width (for its
        # time beside the tensor-core entry's) and in fp32 as the wrapper
        # calls it
        "grouped_plain_attention": case(
            k3_simt, attention.grouped_plain_attention_torch,
            qkv_inputs, [(16, 577, 16, 64)],
            [(2, 257, 8, 64), (2, 5, 4, 8)], bshd_ops, library=sdpa),
        # K3's tensor-core entry, through the wrapper (bf16, D 64 / 128);
        # edges: one row, partial last tiles, several of them, 577, B.H > 1
        "grouped_plain_attention_tc": case(
            attention.grouped_plain_attention,
            attention.grouped_plain_attention_torch,
            qkv_inputs, [(16, 577, 16, 64)], [], bshd_ops, library=sdpa,
            edges=[(1, 1, 2, 64), (2, 63, 2, 128), (1, 65, 3, 64),
                   (2, 129, 2, 128), (1, 577, 2, 64), (1, 577, 2, 128),
                   (1, 65, 2, 80), (2, 577, 2, 80)],
            simt=k3_simt),
        # K4's SIMT entry, called directly in bf16 at full width (for its
        # time beside the tensor-core entry's) and in fp32 as the wrapper
        # calls it
        "flash_forward_lse": case(
            k4_simt, k4_plain, k4_inputs, [(2, 704, 32, 128, True)],
            [(2, 192, 12, 64, True), (1, 45, 4, 8, True)],
            lambda a: bshd_ops(a, causal=a[3]),
            library=lambda q, k, v, causal: sdpa(q, k, v, is_causal=causal)),
        # K4's tensor-core entry, through the wrapper (bf16, D 64 / 80 /
        # 128): the output within FULL_TOL (and row by row), the LSE, which
        # K4b's exp(s - lse) reads, within LSE_TOL; edges: one row, partial
        # last tiles, several tiles, the full S, causal and not, B.H > 1
        "flash_forward_lse_tc": case(
            k4, k4_plain, k4_inputs, [(2, 704, 32, 128, True)], [],
            lambda a: bshd_ops(a, causal=a[3]),
            library=lambda q, k, v, causal: sdpa(q, k, v, is_causal=causal),
            rows=True, tols=(FULL_TOL, LSE_TOL),
            edges=[(b, s, 2, d, causal)
                   for b, s in ((1, 1), (1, 63), (2, 65), (1, 129), (1, 704))
                   for d in (64, 128) for causal in (True, False)],
            simt=k4_simt),
        # K5's SIMT entry, called directly in bf16 at full width (for its
        # time beside the tensor-core entry's) and in fp32 as the wrapper
        # calls it
        "prefill_attention": case(
            k5_simt, attention.prefill_attention_raw_torch,
            k5_inputs, [(2, 640, 32, 128, 37)],
            [(2, 130, 4, 64, 5), (1, 45, 2, 128, 3), (2, 24, 4, 8, 5)],
            k5_ops, library=k5_library, check=k5_pad_rows),
        # K5's tensor-core entry, through the wrapper (bf16, D 64 / 80 /
        # 128), held to the body's arithmetic with the pad (the TPU
        # kernel's rounding points: P to bf16 before P.V), within FULL_TOL
        # and row by row, since the late causal rows are small beside the
        # pad rows and row 0, which set the max-abs, and to the fp32 twin
        # within FULL_TOL; edges: a pad covering whole key tiles, a pad
        # past the last row's tile start, ragged last tiles, one row, every
        # head dim
        "prefill_attention_tc": case(
            attention.prefill_attention_raw, k5_tc_plain,
            k5_inputs, [(2, 640, 32, 128, 37)], [], k5_ops,
            library=k5_library, check=k5_pad_rows, simt=k5_simt, rows=True,
            against=attention.prefill_attention_raw_torch,
            edges=[(2, 130, 4, 64, 100), (2, 200, 2, 80, 150),
                   (2, 128, 2, 128, 64), (2, 24, 2, 64, 5),
                   (1, 1, 2, 64, 0), (2, 640, 2, 128, 37),
                   (2, 333, 3, 80, 0)]),
        "int8_decode_attention": case(
            decode_attention.int8_cache_decode_attention,
            decode_attention.int8_cache_decode_attention_torch,
            k6_inputs, [(2, 32, 32, 768, 128)], k6_small,
            k6_ops, cold=True, library=k6_library, edges=k6_small,
            check=k6_plan,
            library_is="SDPA of the query over a bf16 cache of the same "
                       "(B, H, C, D), the bias as its mask: a yardstick "
                       "reading twice K6's bytes, not K6's function"),
        "int4_matmul": case(
            int4_matmul.int4_matmul, int4_matmul.int4_matmul_torch,
            k7a_inputs, [(2, k, n, 128) for k, n in proj_shapes],
            k7a_edges + [(7, 12288, 64, 128)], k7a_ops, cold=True,
            edges=k7a_edges + [(7, 24576, 64, 128)],
            library=k7a_library, check=k7a_plan,
            library_is="torch.matmul on the bf16 dequantized (K, N) "
                       "weight, four times K7a's bytes"),
        # 16 frames of CLIP (577 tokens, C 1024) and of SAM (32 x 32, 1280)
        "layernorm_quant": case(
            fused_ln.layernorm_quant_folded,
            fused_ln.layernorm_quant_folded_torch, ln_inputs,
            [(16 * 577, 1024), (16 * 1024, 1280)],
            [(300, 256), (37, 384), (5, 2048)], norm_ops, cold=True,
            int8={"full": (1, LSB_SHARE), "small": (1, LSB_SHARE)}),
        "add_layernorm_quant": case(
            fused_ln.add_layernorm_quant_folded,
            fused_ln.add_layernorm_quant_folded_torch,
            lambda g, d, sh: ln_inputs(g, d, sh, add=True),
            [(16 * 1024, 1280)], [(300, 256), (37, 512)], norm_ops,
            cold=True,
            int8={"full": (1, LSB_SHARE), "small": (1, LSB_SHARE)}),
        # K1q's SIMT entry, called directly in bf16 at full width and in
        # fp32 as the wrapper calls it, held to the fp32 twin
        "sam_window_attention_q8": case(
            k1q_simt, k1q_plain, k1q_inputs, [(144, 14, 16, 80)],
            [(4, 8, 6, 64), (3, 2, 4, 8), (2, 4, 2, 64, "underflow")],
            k1_ops,
            int8={"full": (2, LSB_SHARE), "small": (1, FP32_LSB_SHARE)}),
        # K1q's tensor-core entry, through the wrapper, held to the plain
        # version with its rounding points (`k1q_tc_plain`) at the same
        # limit; its distance from the fp32 twin is printed. No PyTorch
        # call quantizes (K1's row has SDPA's time at this shape).
        "sam_window_attention_q8_tc": case(
            k1q, k1q_tc_plain, k1q_inputs, [(144, 14, 16, 80)], [], k1_ops,
            int8={"full": (2, LSB_SHARE), "small": (1, FP32_LSB_SHARE)},
            edges=window_edges, simt=k1q_simt, against=k1q_plain),
        "int4_matmul_a8": case(
            int4_matmul.int4_matmul_a8, int4_matmul.int4_matmul_a8_torch,
            k7b_inputs, [(2, k, n, 128) for k, n in proj_shapes],
            k7a_edges + [(2, 512, 384, 128), (7, 49152, 64, 128)], k7b_ops,
            cold=True, edges=k7a_edges + [(7, 49152, 64, 128)],
            library=k7b_library, check=k7b_plan,
            library_is="torch.matmul of the bf16 dequantized activations "
                       "on the bf16 dequantized (K, N) weight: a yardstick "
                       "reading four times K7b's weight bytes, not K7b's "
                       "function"),
        # K7c's edges (K, N, G): fewer tiles than CTAs (the small ones),
        # 64-row tiles (G = 64, and G = 192: three a super-group), a last
        # tile of 64 columns (N % 128 == 64), 272 tiles on 264 CTAs
        "int4_requant_int8": case(
            int4_matmul.int4_requant_int8,
            int4_matmul.int4_requant_int8_torch, k7c_inputs,
            [(k, n, 128) for k, n in proj_shapes],
            [(512, 256, 128), (1024, 384, 256), (768, 128, 64)],
            lambda a: (0, "int8"), cold=True,
            int8={"full": (0, 0.0), "small": (0, 0.0)},
            edges=[(1024, 320, 128), (1024, 192, 64), (768, 256, 192),
                   (4096, 2176, 128)], check=k7c_plan),
        # the W4A8 prefill's norm sites: 2 x 640 tokens of C 4096; small
        # and edges (fp32 and bf16): C 256 to 8192 on the run-time
        # instantiation, 4096 on the compile-time one, rows fewer than CTAs
        # and 997 (off the grid's multiple)
        "rmsnorm_quant": case(
            rms, rms_plain, rms_inputs, [(1280, 4096)],
            [(300, 256), (37, 768), (5, 8192), (300, 4096), (3, 4096)],
            norm_ops, cold=True,
            int8={"full": (1, LSB_SHARE), "small": (1, LSB_SHARE)},
            edges=[(300, 256), (37, 768), (5, 8192), (997, 4096),
                   (3, 4096)], check=k8c_plan),
        "add_rmsnorm_quant": case(
            add_rms, add_rms_plain,
            lambda g, d, sh: rms_inputs(g, d, sh, add=True),
            [(1280, 4096)],
            [(300, 256), (37, 768), (70, 4096), (5, 8192), (3, 4096)],
            norm_ops, cold=True,
            int8={"full": (1, LSB_SHARE), "small": (1, LSB_SHARE)},
            edges=[(37, 768), (70, 4096), (5, 8192), (997, 4096),
                   (3, 4096)], check=k8c_plan),
        # K4b's dq, its SIMT entry called directly in bf16 at full width
        # and in fp32 as the wrapper calls it
        "flash_backward_dq": case(
            k4b_dq_simt, k4b_dq_plain, k4b_inputs, [(1, 704, 32, 128)],
            k4b_small, lambda a: bwd_ops(a, 3, causal=a[6]),
            library=k4b_library),
        # its tensor-core entry (attention_bwd_tc.cuh's dq body without the
        # bias), through the wrapper (bf16, D 64 / 80 / 128), held to the
        # plain version with the body's rounding points (dS to bf16), each
        # query's row also on its own (late causal rows average over many
        # keys and are small beside the first ones), and to the fp32 twin;
        # edges as K4b's dkv
        "flash_backward_dq_tc": case(
            k4b_dq, k4b_dq_tc_plain, k4b_inputs, [(1, 704, 32, 128)],
            [], lambda a: bwd_ops(a, 3, causal=a[6]), library=k4b_library,
            edges=k4b_edges, simt=k4b_dq_simt, against=k4b_dq_plain,
            rows=True),
        # K4b's dkv, its SIMT entry called directly in bf16 at full width
        # and in fp32 as the wrapper calls it
        "flash_backward_dkv": case(
            k4b_dkv_simt, k4b_dkv_plain, k4b_inputs, [(1, 704, 32, 128)],
            k4b_small, lambda a: bwd_ops(a, 4, causal=a[6]),
            library=k4b_library),
        # its tensor-core entry (attention_bwd_tc.cuh without the bias),
        # through the wrapper (bf16, D 64 / 80 / 128), held to the plain
        # version with the body's rounding points (P and dS to bf16), dk
        # and dv each also row by row (a late key sees few queries, so its
        # row is small beside key 0's, which sets the max-abs), and to the
        # fp32 twin; edges: S of 3 to 704, ragged last tiles, causal and
        # not, every head dim, B.H > 1
        "flash_backward_dkv_tc": case(
            k4b_dkv_tc, k4b_dkv_tc_plain, k4b_inputs, [(1, 704, 32, 128)],
            [], lambda a: bwd_ops(a, 4, causal=a[6]), library=k4b_library,
            edges=k4b_edges, simt=k4b_dkv_simt, against=k4b_dkv_plain,
            rows=True),
        # K9's forward, its SIMT entry called directly in bf16 at full
        # width and in fp32 as the wrapper calls it
        "relpos_flash_fwd_lse": case(
            k9_simt, sam_attention_bwd.relpos_flash_fwd_lse_torch, k9_inputs,
            k9_full, k9_small, bshd_ops, library=k9_library),
        # its tensor-core entry, through the wrapper (bf16, D 64 / 80 / 128):
        # out within FULL_TOL, the LSE, which K9's dq and dkv read back as
        # exp(s - lse), within LSE_TOL
        "relpos_flash_fwd_lse_tc": case(
            sam_attention_bwd.relpos_flash_fwd_lse,
            sam_attention_bwd.relpos_flash_fwd_lse_torch, k9_inputs, k9_full,
            [], bshd_ops, library=k9_library, tols=(FULL_TOL, LSE_TOL),
            edges=[(b, g, 2, d) for g, b in ((2, 4), (4, 2), (7, 1),
                                             (14, 2), (16, 1), (32, 1))
                   for d in (64, 80, 128)],
            simt=k9_simt),
        # K9's dq, its SIMT entry called directly in bf16 at full width and
        # in fp32 as the wrapper calls it
        "relpos_flash_dq": case(
            k9_dq_simt, sam_attention_bwd.relpos_flash_dq_torch,
            k9_bwd_inputs, k9_full, k9_small, lambda a: bwd_ops(a, 3),
            library=k9_bwd_library),
        # its tensor-core entry (attention_bwd_tc.cuh, `dq_block_tc`),
        # through the wrapper (bf16, D 64 / 80 / 128), held to the plain
        # version with the body's rounding points (dS to bf16 before dS.K
        # and the bucket sums, the TPU kernel's) and to the fp32 twin: dq,
        # d_rh and d_rw each of its own max-abs; edges as K9's dkv
        "relpos_flash_dq_tc": case(
            sam_attention_bwd.relpos_flash_dq,
            sam_attention_bwd.relpos_flash_dq_tc_torch, k9_bwd_inputs,
            k9_full, [], lambda a: bwd_ops(a, 3), library=k9_bwd_library,
            edges=[(b, g, 2, d) for g, b in ((2, 4), (12, 1),
                                             (14, 2), (16, 1), (32, 1))
                   for d in (64, 80, 128)],
            simt=k9_dq_simt, against=sam_attention_bwd.relpos_flash_dq_torch),
        # K9's dkv, its SIMT entry called directly in bf16 at full width
        # and in fp32 as the wrapper calls it
        "relpos_flash_dkv": case(
            k9_dkv_simt, sam_attention_bwd.relpos_flash_dkv_torch,
            k9_bwd_inputs, k9_full, k9_small, lambda a: bwd_ops(a, 4),
            library=k9_bwd_library),
        # its tensor-core entry (attention_bwd_tc.cuh), through the wrapper
        # (bf16, D 64 / 80 / 128), held to the plain version with the
        # body's rounding points, which are the TPU kernel's (P and dS to
        # bf16 before the products); edges: grids of 2 x 2 (one partial
        # query tile) to 32 x 32, ragged 12 x 12 and 14 x 14, every head
        # dim, B.H > 1 (an odd grid takes the SIMT entry:
        # `_odd_grid_routes`)
        "relpos_flash_dkv_tc": case(
            sam_attention_bwd.relpos_flash_dkv,
            sam_attention_bwd.relpos_flash_dkv_tc_torch, k9_bwd_inputs,
            k9_full, [], lambda a: bwd_ops(a, 4), library=k9_bwd_library,
            edges=[(b, g, 2, d) for g, b in ((2, 4), (12, 1),
                                             (14, 2), (16, 1), (32, 1))
                   for d in (64, 80, 128)],
            simt=k9_dkv_simt),
        # the training driver's S = 1536 + 575 = 2111 through LLaMA-7B,
        # K10's SIMT entry called directly in bf16 (its time beside the
        # tensor-core entry's); small fp32, as the wrapper calls it: cross
        # lengths both ways, causal Sq < Sk (top-left), a ragged tail over
        # several tiles, head dims 8 / 64 / 80 / 128
        "flash_attention": case(
            k10_simt, k10_plain, k10_inputs,
            [(1, 2111, 2111, 32, 128, True)],
            [(1, 45, 130, 4, 64, False), (2, 200, 200, 4, 8, True),
             (1, 64, 128, 2, 128, True), (1, 130, 64, 2, 80, False),
             (1, 1030, 1030, 2, 64, True)],
            k10_ops, library=lambda q, k, v, causal: sdpa(q, k, v,
                                                          is_causal=causal),
            rows=True),
        # K10's tensor-core entry, through the wrapper (bf16, D 64 / 128);
        # edges (b, sq, sk, heads, d, causal): one row, partial last tiles,
        # several tiles, causal Sq < Sk (top-left) and Sq > Sk with no key
        # pad, non-causal cross lengths both ways, B.H > 1
        "flash_attention_tc": case(
            k10, k10_plain, k10_inputs, [(1, 2111, 2111, 32, 128, True)],
            [], k10_ops,
            library=lambda q, k, v, causal: sdpa(q, k, v, is_causal=causal),
            rows=True,
            edges=[(1, 1, 1, 2, 64, True), (1, 63, 63, 2, 128, True),
                   (2, 65, 65, 2, 64, True), (1, 129, 129, 4, 128, True),
                   (1, 100, 200, 2, 128, True), (1, 300, 130, 2, 64, True),
                   (2, 70, 190, 2, 64, False), (1, 129, 65, 3, 128, False),
                   (1, 1, 64, 2, 128, False), (1, 129, 129, 2, 80, True),
                   (1, 70, 190, 2, 80, False)],
            simt=k10_simt),
        # K11-K14: public ops of the JAX package that no model path runs,
        # held at the shapes they would take in SAM ViT-H (16 frames)
        # K11, its SIMT entry called directly in bf16 at full width and in
        # fp32 as the wrapper calls it
        "flash_attention_relpos": case(
            k11_simt, sam_attention.grouped_window_attention_relpos_torch,
            k2_inputs, [(16, 32, 16, 80), (144, 14, 16, 80)],
            [(2, 16, 6, 64), (2, 4, 4, 8)], bshd_ops, library=k2_library),
        # its tensor-core entry (K2's body), through the wrapper (bf16, D 64
        # / 80 / 128), held to K2's body's arithmetic and to the fp32 twin;
        # edges as K2's
        "flash_attention_relpos_tc": case(
            sam_attention.flash_attention_relpos, k11_tc_plain, k2_inputs,
            [(16, 32, 16, 80), (144, 14, 16, 80)], [], bshd_ops,
            library=k2_library, edges=k2_edges, simt=k11_simt,
            against=sam_attention.grouped_window_attention_relpos_torch),
        # K12, its SIMT entry called directly in bf16 at full width and in
        # fp32 as the wrapper calls it
        "sam_window_attention_v2": case(
            k12_simt, sam_attention.grouped_window_attention_relpos_v2_torch,
            k12_inputs, [(144, 14, 16, 80)],
            [(4, 8, 6, 64), (3, 2, 4, 8), (2, 4, 2, 64, "underflow")],
            lambda a: raw_ops(a, a[5]), library=k12_library),
        # its tensor-core entry (K1's body), through the wrapper (bf16, D 64
        # / 80 / 128), held to K1's body's arithmetic on split inputs and to
        # the fp32 twin; edges as K1's, all-underflow rows included
        "sam_window_attention_v2_tc": case(
            sam_attention.grouped_window_attention_relpos_v2,
            sam_attention.grouped_window_attention_relpos_v2_tc_torch,
            k12_inputs, [(144, 14, 16, 80)], [],
            lambda a: raw_ops(a, a[5]), library=k12_library,
            edges=window_edges, simt=k12_simt,
            against=sam_attention.grouped_window_attention_relpos_v2_torch),
        # K12q8's SIMT entry, called directly in bf16 at full width and in
        # fp32 as the wrapper calls it, held to the fp32 twin
        "sam_window_attention_v2_q8": case(
            k12q_simt,
            sam_attention.grouped_window_attention_relpos_v2_q8_torch,
            k12q_inputs, [(144, 14, 16, 80)],
            [(4, 8, 6, 64), (3, 2, 4, 8), (2, 4, 2, 64, "underflow")],
            lambda a: raw_ops(a, a[6]),
            int8={"full": (2, LSB_SHARE), "small": (1, FP32_LSB_SHARE)}),
        # its tensor-core entry (K1q's body), through the wrapper (bf16, D 64
        # / 80 / 128), held to K1q's body's arithmetic on split inputs at
        # K1q's limits and to the fp32 twin within TC_TWIN_LSB; edges as
        # K1q's, all-underflow rows included
        "sam_window_attention_v2_q8_tc": case(
            sam_attention.grouped_window_attention_relpos_v2_q8,
            sam_attention.grouped_window_attention_relpos_v2_q8_tc_torch,
            k12q_inputs, [(144, 14, 16, 80)], [],
            lambda a: raw_ops(a, a[6]),
            int8={"full": (2, LSB_SHARE), "small": (1, FP32_LSB_SHARE)},
            edges=window_edges, simt=k12q_simt,
            against=sam_attention.grouped_window_attention_relpos_v2_q8_torch,
            against_lsb=TC_TWIN_LSB),
        # K13 v1, its SIMT entry called directly in bf16 at full width and
        # in fp32 as the wrapper calls it
        "folded_window_attention": case(
            k13_simt, sam_attention.grouped_window_attention_relpos_torch,
            k2_inputs, [(144, 14, 16, 80)], [(4, 8, 6, 64), (2, 4, 4, 8)],
            bshd_ops, library=k2_library),
        # its tensor-core entry (K2's body), through the wrapper (bf16, D 64
        # / 80 / 128), held to K2's body's arithmetic and to the fp32 twin;
        # edges as K2's
        "folded_window_attention_tc": case(
            sam_attention.folded_window_attention_relpos,
            sam_attention.folded_window_attention_relpos_tc_torch,
            k2_inputs, [(144, 14, 16, 80)], [], bshd_ops,
            library=k2_library, edges=k2_edges, simt=k13_simt,
            against=sam_attention.grouped_window_attention_relpos_torch),
        # K13 v2, its SIMT entry called directly in bf16 at full width and
        # in fp32 as the wrapper calls it
        "folded_window_attention_v2": case(
            k13v2_simt, sam_attention.folded_window_attention_relpos_v2_torch,
            k13v2_inputs, [(144, 14, 16, 80)],
            [(4, 8, 6, 64), (2, 4, 4, 8)], lambda a: raw_ops(a, a[6]),
            library=k13v2_library),
        # its tensor-core entry (K2's body), through the wrapper (bf16, D 64
        # / 80 / 128), held to K2's body's arithmetic on the raw layout and
        # to the fp32 twin; edges as K2's, in the raw layout
        "folded_window_attention_v2_tc": case(
            sam_attention.folded_window_attention_relpos_v2,
            sam_attention.folded_window_attention_relpos_v2_tc_torch,
            k13v2_inputs, [(144, 14, 16, 80)], [],
            lambda a: raw_ops(a, a[6]), library=k13v2_library,
            edges=k2_edges, simt=k13v2_simt,
            against=sam_attention.folded_window_attention_relpos_v2_torch),
        # the SAM grid of 16 frames, padded 32 -> 42 for 9 windows of 14,
        # timed as K6-K8c are (its input, 41.94 MB, fits the L2); small:
        # the vector body (int8 at C = 8 and 3, bf16 at C = 20: rows of 8, 3
        # and 40 bytes a pixel) and the bulk body (fp32 at C = 16, bf16 at
        # C = 64, int8 at C = 16, fp32 at C = 32), exact divisors, pads on
        # one axis and both, more rows than CTAs
        "window_partition": case(
            window_ops.window_partition_fused, k14_part_plain, k14_grid,
            [(16, 32, 32, 1280, 14)], k14_small, lambda a: (0, "bf16"),
            cold=True, exact=True, check=k14_plan, nbytes=k14_bytes,
            library=lambda *a: (lambda: k14_part_plain(*a)),
            library_is="torch pad + view + permute copy"),
        "window_unpartition": case(
            window_ops.window_unpartition_fused, k14_unpart_plain,
            k14_windows, [(16, 32, 32, 1280, 14)], k14_small,
            lambda a: (0, "bf16"), cold=True, exact=True, check=k14_plan,
            nbytes=k14_bytes,
            library=lambda *a: (lambda: k14_unpart_plain(*a)),
            library_is="torch view + permute copy + slice"),
    }


def _time_ms(torch, fn, arg_sets, reps=10):
    """Median CUDA-event time of one call, cycling over `arg_sets`."""
    for i in range(2):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*arg_sets[i % len(arg_sets)])
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _queued_ms(torch, fn, args, n=20, reps=5):
    """Median over `reps` of the mean device time of one call among `n`
    calls enqueued back to back between two CUDA events: the queue stays
    ahead of the card, so the host's time to launch each call (which
    `_time_ms`, one call between its events, counts where the card waits
    for it) drops out. For the sub-millisecond attention calls compared
    with SDPA."""
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def _cold_copies(nbytes):
    """Copies of a call's inputs of `nbytes` that a cold replay cycles
    over: enough for COLD_BYTES; where those are fewer than COLD_NODES, one
    more, so that between two reads of one copy the others read at least
    COLD_BYTES (the L2 holds 50 MB)."""
    copies = -(-COLD_BYTES // nbytes)
    return copies + 1 if copies < COLD_NODES else copies


def _cycle(items, n):
    """`items` repeated in order to max(n, len(items)) entries."""
    return [items[i % len(items)] for i in range(max(n, len(items)))]


def _graph_ms(torch, fn, arg_sets, reps=20):
    """Median device time of one call: every set of `arg_sets` called once
    inside a captured CUDA graph, the graph replayed between CUDA events,
    its time divided by the calls. For kernels of a few microseconds, where
    timing eager calls would measure the host's launch overhead instead;
    phase 2 gives it at least COLD_NODES calls (`_cycle`)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(arg_sets))
    del graph
    return statistics.median(times)


def _max_err(got, want):
    if isinstance(got, tuple):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return float((got.float() - want.float()).abs().max())


def _int8_diff(got, want):
    """(max |diff| in LSBs, share of elements that differ) of int8
    outputs."""
    d = (got.int() - want.int()).abs()
    return int(d.max()), float((d > 0).float().mean())


def _check_int8(name, label, got, want, limits):
    """Raise unless every output of an int8 kernel is within `limits`
    (LSB, share); a float output of the int8's shape (K8b's and K8c's
    residual sum) must be bit-equal, another (K8c's per-token scales)
    within SX_REL of the twin's, relative. Returns the worst (LSB,
    share)."""
    lsb_lim, share_lim = limits
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    q_shape = next(g.shape for g in got if not g.dtype.is_floating_point)
    worst = (0, 0.0)
    for g, w in zip(got, want):
        if g.dtype.is_floating_point and g.shape == q_shape:
            err = _max_err(g, w)
            if err != 0:
                raise PhaseError(f"{name} {label}: residual sum differs "
                                 f"from the plain twin's by {err:.3e}")
            continue
        if g.dtype.is_floating_point:
            rel = float(((g.float() - w.float()).abs()
                         / w.float().abs()).max())
            if not rel <= SX_REL:
                raise PhaseError(f"{name} {label}: scales differ from the "
                                 f"plain twin's by {rel:.3e} relative > "
                                 f"{SX_REL}")
            continue
        lsb, share = _int8_diff(g, w)
        if not (lsb <= lsb_lim and share <= share_lim):
            raise PhaseError(f"{name} {label}: int8 outputs {lsb} LSB apart "
                             f"on {share:.3e} of them (limit {lsb_lim} LSB "
                             f"on {share_lim})")
        worst = max(worst, (lsb, share))
    return worst


def _nbytes(torch, args):
    return sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))


def _check_full(name, full, got, want, tols=None):
    """Every float output of a full-width bf16 call (flash_forward_lse:
    out and LSE) within its limit of its own max-abs: `tols`, one limit
    per output, or FULL_TOL for all; returns [(max-abs error, relative
    error)]."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    out = []
    for g, w, tol in zip(got, want, tols or (FULL_TOL,) * len(got)):
        err = _max_err(g, w)
        scale = float(w.float().abs().max())
        if not (np.isfinite(err) and err <= tol * scale):
            raise PhaseError(f"{name} bf16 {full}: max-abs error "
                             f"{err:.3e} > {tol} x {scale:.3e}")
        out.append((err, err / scale))
    return out


def _zero_rows(w):
    """The rows (the last axis) of `w` whose max-abs lies below ZERO_ROW of
    w's: zero in exact arithmetic (the first row of a causal dq, where
    dS_00 = P_00 (dP_00 - D_0) = 0), so they carry only rounding noise."""
    return w.abs().amax(-1) < ZERO_ROW * w.abs().max()


def _row_share(got, want):
    """For each output of a call: the largest distance of a row (the last
    axis) of `got` from `want`, of that row's max-abs in `want`; rows zero
    in exact arithmetic (`_zero_rows`) left out."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    out = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        live = ~_zero_rows(w)
        share = ((g - w).abs().amax(-1)[live]
                 / w.abs().amax(-1)[live].clamp_min(1e-30))
        out.append(float(share.max()) if share.numel() else 0.0)
    return out


def _check_rows(name, full, got, want):
    """Every output of a full-width bf16 attention call row by row: each
    row (one query, or one key of K4b's dk and dv, of one head: D values;
    of K4's LSE, one head's S values) within ROW_TOL of that row's own
    max-abs. Causal rows far down average over thousands of keys, and in
    causal dk and dv the late keys see few queries, so they are small
    beside the first rows, which set the output's max-abs; FULL_TOL alone
    would pass a kernel wrong there or in the ragged last key tile. One
    bf16 rounding apart is at most 2^-7 of a row's max-abs. A row zero in
    exact arithmetic (`_zero_rows` of the plain output) is held below
    ZERO_ROW of the output's max-abs instead, in the kernel's output too.
    Returns the worst row's share of each output."""
    rel = _row_share(got, want)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for i, (r, g, w) in enumerate(zip(rel, got, want)):
        if not r <= ROW_TOL:
            raise PhaseError(f"{name} bf16 {full}: a row of output {i} "
                             f"differs by {r:.3e} of its own max-abs > "
                             f"{ROW_TOL}")
        zero = _zero_rows(w.float())
        noise = g.float().abs().amax(-1)[zero]
        limit = ZERO_ROW * float(w.float().abs().max())
        if noise.numel() and not float(noise.max()) < limit:
            raise PhaseError(f"{name} bf16 {full}: a row of output {i} "
                             f"that is zero in exact arithmetic reaches "
                             f"{float(noise.max()):.3e} >= {limit:.3e}")
    return rel


def _rows_note(rel):
    """The phase's note on `_row_share`'s list."""
    return (f", worst row {', '.join(f'{r:.2e}' for r in rel)} of its own "
            f"max-abs")


def _check_underflow(name, shape, got, want):
    """Where `shape` carries an all-underflow row (K1's and K1q's cases:
    row 0 of window 0), raise unless the kernel and the plain version both
    give exact zeros there; returns a note for the phase's line."""
    if "underflow" not in shape:
        return ""
    row_k = float(got[0, 0].float().abs().max())
    row_p = float(want[0, 0].float().abs().max())
    if row_k != 0.0 or row_p != 0.0:
        raise PhaseError(f"{name} {shape}: all-underflow row gives "
                         f"{row_k:.3e} (kernel), {row_p:.3e} (plain), not 0")
    return "; the all-underflow row is exactly 0 in both"


def _bound(torch, c, args, out):
    """(ms, "bytes" or "operations") the card needs at least for one call:
    every input read once and every output written once at HBM_BYTES_PER_S
    (or the case's own `nbytes`, K14's: only the bytes a correct call must
    move), or the call's operations at the peak rate of their type,
    whichever is longer. An output that is one of the inputs (K8c hands `a`
    back unchanged) is not written."""
    if c["nbytes"]:
        nbytes = c["nbytes"](args, out)
    else:
        outs = [o for o in _tensors(out) if not any(o is a for a in args)]
        nbytes = _nbytes(torch, args) + _nbytes(torch, outs)
    t_bytes = nbytes / HBM_BYTES_PER_S
    ops, kind = c["ops"](args)
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else \
        (t_ops * 1e3, "operations")


def _check_exact(name, shape, got, want):
    if got.dtype != want.dtype or got.shape != want.shape or not bool(
            (got == want).all()):
        raise PhaseError(f"{name} {shape}: {got.dtype} {tuple(got.shape)} "
                         f"not bit-equal to the plain version's "
                         f"{want.dtype} {tuple(want.shape)}")


def phase_kernels(torch, gpu, compiles):
    """Returns each kernel's row of the JSON line, with `phase2_launches`:
    the launches this phase made (checks, timing, the trainable forms).
    `compiles`: `_tc_compiles`' processes, read by `_tc_build_report`."""
    from grove_tpu_torch import _kernels
    _kernels.reset_launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, c in _cases(torch).items():
        fn, plain, make, int8 = c["fn"], c["plain"], c["make"], c["int8"]
        before = _kernels.KERNELS[name].launches
        for shape in c["small"]:
            args = make(gen, torch.float32, shape)
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            if int8:
                lsb, share = _check_int8(name, f"fp32 {shape}", got, want,
                                         int8["small"])
                note = f"{lsb} LSB on {share:.2e} of the int8 outputs"
            elif c["exact"]:
                _check_exact(name, shape, got, want)
                note = f"bit-equal ({got.dtype})"
            else:
                err = _max_err(got, want)
                if not err <= FP32_TOL:
                    raise PhaseError(f"{name} fp32 {shape}: max-abs error "
                                     f"{err:.3e} > {FP32_TOL}")
                note = f"max-abs error {err:.3e}"
            note += _check_underflow(name, shape, got, want)
            if c["check"]:
                note += c["check"](args, got)
            say(2, f"{name} fp32 {shape}: {note}")
        for shape in c["edges"]:
            args = make(gen, torch.bfloat16, shape)
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            if int8:
                lsb, share = _check_int8(name, f"bf16 edge {shape}", got,
                                         want, int8["full"])
                note = f"{lsb} LSB on {share:.2e} of the int8 outputs"
            else:
                errs = _check_full(name, shape, got, want, c["tols"])
                note = (f"max-abs error "
                        f"{', '.join(f'{e:.3e}' for e, _ in errs)} (relative "
                        f"{', '.join(f'{r:.2e}' for _, r in errs)})")
            if c["rows"]:
                note += _rows_note(_check_rows(name, shape, got, want))
            note += _check_underflow(name, shape, got, want)
            if c["check"]:
                note += c["check"](args, got)
            say(2, f"{name} bf16 edge {shape}: {note}")
        errs, ms, plain_ms, one_ms = [], 0.0, 0.0, 0.0
        bound = {"bytes": 0.0, "operations": 0.0}
        queued = {}
        library_ms = 0.0 if c["library"] else None
        for full in c["full"]:
            args = make(gen, torch.bfloat16, full)
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            b_ms, b_by = _bound(torch, c, args, got)
            bound[b_by] += b_ms
            if int8:
                lsb, share = _check_int8(name, f"bf16 {full}", got, want,
                                         int8["full"])
                new = [(float(lsb), share)]
                what = f"int8 outputs {lsb} LSB apart on {share:.2e} of them"
                if c["against"] and c["against_lsb"]:
                    lsb, share = _check_int8(f"{name} (fp32 twin)",
                                             f"bf16 {full}", got,
                                             c["against"](*args),
                                             c["against_lsb"])
                    what += (f" (from the fp32 twin {lsb} LSB on "
                             f"{share:.2e}, held within "
                             f"{c['against_lsb']})")
                elif c["against"]:
                    lsb, share = _int8_diff(got, c["against"](*args))
                    what += (f" (from the fp32 twin, printed, not held: "
                             f"{lsb} LSB on {share:.2e})")
            elif c["exact"]:
                _check_exact(name, full, got, want)
                new, what = [(0.0, 0.0)], "bit-equal"
            else:
                new = _check_full(name, full, got, want, c["tols"])
                what = (f"max-abs error "
                        f"{', '.join(f'{e:.3e}' for e, _ in new)} (relative "
                        f"{', '.join(f'{r:.2e}' for _, r in new)})")
                if c["rows"]:
                    what += _rows_note(_check_rows(name, full, got, want))
                if c["against"]:
                    other = c["against"](*args)
                    held = _check_full(f"{name} (fp32 twin)", full, got,
                                       other)
                    what += (f"; from the fp32 twin "
                             f"{', '.join(f'{r:.2e}' for _, r in held)} of "
                             f"its max-abs (held within {FULL_TOL})"
                             + _rows_note(_row_share(got, other)))
                    del other
            if c["check"]:
                what += c["check"](args, got)
            errs += new
            del got, want
            distinct, timer, how = [args], _time_ms, ""
            sets = distinct
            if c["cold"]:
                copies = _cold_copies(_nbytes(torch, args))
                distinct += [make(gen, torch.bfloat16, full)
                             for _ in range(copies - 1)]
                sets = _cycle(distinct, COLD_NODES)
                timer = _graph_ms
                how = (f" (CUDA graph of {len(sets)} calls over {copies} "
                       f"cold copies)")
            t, tp = timer(torch, fn, sets), timer(torch, plain, sets)
            if c["cold"]:
                t_one = _time_ms(torch, fn, [args])
                one_ms += t_one
                how += f", {t_one:.4f} ms one call alone"
            lib, call = "", None
            if c["library"]:
                call = c["library"](*args)
                t_lib = _time_ms(torch, call, [()])
                lib = (f", one PyTorch call "
                       f"({c['library_is'] or 'SDPA'}) {t_lib:.4f} ms")
                if c["cold"]:
                    # the same cold copies, replayed as the kernel's
                    calls = [call] + [c["library"](*a)
                                      for a in distinct[1:]]
                    t_lib = _graph_ms(torch, lambda f: f(),
                                      [(f,) for f in _cycle(calls,
                                                            len(sets))])
                    lib += f" alone, {t_lib:.4f} ms cold"
                    del calls
                library_ms += t_lib
            if c["simt"]:
                # back to back, summed over the full shapes
                timed = {"queued_ms": fn, "simt_queued_ms": c["simt"]}
                if call:
                    timed["library_queued_ms"] = lambda *a: call()
                here = {k: _queued_ms(torch, f, args)
                        for k, f in timed.items()}
                for k, t_q in here.items():
                    queued[k] = queued.get(k, 0.0) + t_q
                lib += ("; back to back (device time, no host gap): "
                        f"tensor-core {here['queued_ms']:.4f} ms, "
                        f"SIMT {here['simt_queued_ms']:.4f} ms"
                        + (f", SDPA {here['library_queued_ms']:.4f} ms"
                           if call else ""))
            del call
            say(2, f"{name} bf16 {full}: {what}; kernel {t:.4f} ms{how}, "
                   f"plain {tp:.4f} ms{lib}; bound {b_ms:.4f} ms by {b_by} "
                   f"({100 * b_ms / t:.1f}% of it) on {gpu}")
            if b_ms > t:
                raise PhaseError(f"{name} bf16 {full}: {t:.4f} ms is faster "
                                 f"than its bound {b_ms:.4f} ms: the bound "
                                 f"or the timing is wrong")
            ms += t
            plain_ms += tp
            del args, sets, distinct
            torch.cuda.empty_cache()
        if _kernels.KERNELS[name].launches == before:
            raise PhaseError(f"{name}: its case never launched it")
        # int8 kernels: the error in LSBs and the share of outputs off
        second = "lsb_share" if int8 else "rel_err"
        rows[name] = {"max_abs_err": max(e for e, _ in errs),
                      second: max(r for _, r in errs), "ms": ms,
                      "plain_ms": plain_ms,
                      "bound_ms": bound["bytes"] + bound["operations"],
                      "bound_by": max(bound, key=bound.get),
                      "library_ms": library_ms, **queued}
        if c["cold"]:
            rows[name]["one_call_ms"] = one_ms
        simt = name.removesuffix("_tc")
        if simt != name:
            rows[name]["simt_ms"] = rows[simt]["ms"]
            sdpa = (f"SDPA {library_ms:.4f} ms, " if library_ms is not None
                    else "")
            say(2, f"{name}: tensor-core body {ms:.4f} ms, SIMT body (bf16) "
                   f"{rows[simt]['ms']:.4f} ms, {sdpa}bound "
                   f"{rows[name]['bound_ms']:.4f} ms on {gpu}")
    _tc_build_report(gpu, compiles)
    _int8_matmul_padded(torch, gpu)
    _int4_fused_widths(torch, gpu)
    _ragged_routes(torch, gpu)
    _odd_grid_routes(torch, gpu)
    _trainable_forms(torch, gpu)
    _k14_breakdown(torch, gpu, rows)
    for name, row in rows.items():
        row["phase2_launches"] = _kernels.KERNELS[name].launches
    return rows


def _tc_compiles():
    """Start one `nvcc -Xptxas -v` of each tensor-core entry's source and
    of K7a's (the library's own flags), so that its registers, stack and
    spills can be read; they run beside the build and phase 2. Returns the
    processes by source, and "dir", their output directory."""
    from grove_tpu_torch import _kernels
    out = tempfile.mkdtemp()
    procs = {src: subprocess.Popen(
        [_kernels.find_nvcc(), *_kernels.COMPILE_FLAGS, "-Xptxas", "-v",
         "-c", str(_kernels.CSRC / src), "-o", str(Path(out) / (src + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in PTXAS_SOURCES}
    return {"dir": out, **procs}


def _tc_build_report(gpu, compiles):
    """For each tensor-core entry's kernels (D 64, 80 and 128; the entry
    macros name them after the C symbol, `grove_X_tc` -> `X_tc_kernel`,
    or as TC_INSTANCES says):
    registers,
    stack frame and spills as ptxas reports them (`_tc_compiles`), the
    dynamic shared memory its launch asks for (`_tc_smem`, from the built
    library) and the HGMMA instructions in `cuobjdump -sass` of it.
    Fails where ptxas failed, a kernel spills, or a kernel has no HGMMA
    (then it would not run on the tensor cores)."""
    from grove_tpu_torch import _kernels
    ptxas = {}
    for src in PTXAS_SOURCES:
        proc = compiles.pop(src)
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise PhaseError(f"nvcc -Xptxas -v {src} failed:\n{log}")
        fn = None
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
                ptxas[fn] = []
            elif fn and ("spill" in line or "registers" in line):
                ptxas[fn].append(line.split(":", 1)[-1].strip())
    sass = subprocess.run(
        [str(Path(_kernels.find_nvcc()).parent / "cuobjdump"), "-sass",
         str(_kernels.library_path())], capture_output=True, text=True,
        timeout=300, check=True).stdout
    hgmma, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            if "_tc_kernel" in fn:
                hgmma[fn] = 0
        elif fn in hgmma and "HGMMA" in line:
            hgmma[fn] += 1
    for name in TC_SOURCES:
        stem = _tc_instance(name)
        for d in _kernels.TC_HEAD_DIMS:
            tag = f"{stem}_kernelILi{d}E"
            fns = [f for f in hgmma if tag in f]
            lines = [x for f in ptxas if tag in f for x in ptxas[f]]
            n = sum(hgmma[f] for f in fns)
            say(2, f"{name} D = {d}: ptxas {'; '.join(lines) or 'no report'}"
                   f"; its launch asks for {_tc_smem(name, d)} bytes of "
                   f"dynamic shared memory (tables of 32 x 32); {n} HGMMA "
                   f"instructions in the library's SASS ({gpu})")
            if not fns or not n:
                raise PhaseError(f"{name} D = {d}: no HGMMA instruction in "
                                 f"the built library ({fns})")
            if not lines:
                raise PhaseError(f"{name} D = {d}: no ptxas report")
            if _spills(lines):
                raise PhaseError(f"{name} D = {d} spills: {lines}")
    _int4_build_report(gpu, ptxas)
    _k6_build_report(gpu, ptxas)
    _k7c_k8c_build_report(gpu, ptxas)
    _k14_build_report(gpu, ptxas)
    _stop_tc_compiles(compiles)


def _spills(lines):
    return re.search(r"\b[1-9]\d* bytes spill", " ".join(lines))


def _int4_build_report(gpu, ptxas):
    """Registers and spills of each instantiation of the int4 template
    (K7a's Dots, fp32 x on FFMAs or bf16 x on mma.sync; K7b's, int8 x on
    the int8 mma.sync; rows of x a CTA, bytes a weight copy, x staged or
    read from global memory, the output's dtype) as ptxas reports them;
    fails where one spills or either entry has none reported."""
    fns = {f: lines for f, lines in ptxas.items()
           if "int4_matmul_kernel" in f}
    kinds = {"SimtDot": ("int4_matmul", "fp32 x, FFMA"),
             "TcDot": ("int4_matmul", "bf16 x, mma"),
             "I8Dot": ("int4_matmul_a8", "int8 x, int8 mma")}
    seen = set()
    for fn, lines in sorted(fns.items()):
        m = re.search(r"(SimtDot|TcDot|I8Dot)ELi(\d+)ELi(\d+)ELb([01])E"
                      r"(f|13__nv_bfloat16)E", fn)
        name, label = kinds[m[1]] if m else ("int4 template", fn)
        if m:
            seen.add(name)
            label += (f", MT {m[2]}, {m[3]}-byte copies, x "
                      f"{'staged' if m[4] == '1' else 'from global'}, out "
                      f"{'fp32' if m[5] == 'f' else 'bf16'}")
        say(2, f"{name} ({label}): ptxas "
               f"{'; '.join(lines) or 'no report'} ({gpu})")
        if _spills(lines):
            raise PhaseError(f"{name} ({label}) spills: {lines}")
    if seen != {"int4_matmul", "int4_matmul_a8"}:
        raise PhaseError(f"{INT4_SOURCES}: ptxas reported "
                         f"int4_matmul_kernel of {sorted(seen)} only")


def _k7c_k8c_build_report(gpu, ptxas):
    """K7c's kernels (tiles of 128 and of 64 packed rows) and K8c's (fp32
    or bf16 rows, with or without the residual, C = 4096 at compile time or
    any C at run time): registers and spills as ptxas reports them; fails
    where one spills or any of the 2 + 8 is missing."""
    labels = {}
    for fn, lines in ptxas.items():
        m = re.search(r"requant_kernelILi(\d+)E", fn)
        if m:
            labels[f"int4_requant_int8 ({m[1]}-row tiles)"] = lines
        m = re.search(r"rmsnorm_quant_kernelI(f|13__nv_bfloat16)Lb([01])ELi"
                      r"(\d+)E", fn)
        if m:
            name = "add_rmsnorm_quant" if m[2] == "1" else "rmsnorm_quant"
            labels[f"{name} ({'fp32' if m[1] == 'f' else 'bf16'}, C "
                   f"{m[3] if m[3] != '0' else 'at run time'})"] = lines
    if len(labels) != 10:
        raise PhaseError(f"{K7C_SOURCE}, {K8C_SOURCE}: ptxas reported "
                         f"{sorted(labels)}")
    for label, lines in sorted(labels.items()):
        say(2, f"{label}: ptxas {'; '.join(lines)} ({gpu})")
        if _spills(lines):
            raise PhaseError(f"{label} spills: {lines}")


def _k14_build_report(gpu, ptxas):
    """K14's kernels (the bulk body; the vector body at 16-, 8-, 4-, 2- and
    1-byte accesses): registers and spills as ptxas reports them; fails
    where one spills or any of the 6 is missing."""
    labels = {}
    for fn, lines in ptxas.items():
        if "window_bulk" in fn:
            labels["window_partition / unpartition (bulk body)"] = lines
        m = re.search(r"window_vectorI(\w+?)EEv", fn)
        if m:
            width = {"h": 1, "t": 2, "j": 4, "5uint2": 8, "5uint4": 16}
            labels[f"window_partition / unpartition (vector body, "
                   f"{width.get(m[1], m[1])}-byte accesses)"] = lines
    if len(labels) != 6:
        raise PhaseError(f"{K14_SOURCE}: ptxas reported {sorted(labels)}")
    for label, lines in sorted(labels.items()):
        say(2, f"{label}: ptxas {'; '.join(lines)} ({gpu})")
        if _spills(lines):
            raise PhaseError(f"{label} spills: {lines}")


def _lib_rows(dims, rows):
    """K14's rows as the library computes them (`grove_window_copy_rows`,
    the kernels' own `row_of`): (rows, 5) int64 of source byte, destination
    byte, bytes copied, zero bytes after them, CTA."""
    import ctypes

    from grove_tpu_torch import _kernels
    fn = _kernels.load().grove_window_copy_rows
    fn.argtypes = [ctypes.c_int] * len(dims) + [ctypes.c_void_p]
    out = np.zeros((rows, 5), np.int64)
    code = fn(*dims, out.ctypes.data)
    if code != 0:
        raise PhaseError(f"grove_window_copy_rows{dims}: error {code}")
    return out


def _lib_plan(symbol, fields, *args):
    """The launch a library entry reports (`grove_*_plan`): `fields` ints,
    for the int arguments `args`."""
    import ctypes

    from grove_tpu_torch import _kernels
    fn = getattr(_kernels.load(), symbol)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * fields)()
    code = fn(*args, out)
    if code != 0:
        raise PhaseError(f"{symbol}{args}: error {code}")
    return tuple(out)


def _k6_build_report(gpu, ptxas):
    """K6's kernels (q in fp32 and bf16; 1 query head a kv head, or 4 a
    pass): registers and spills as ptxas reports them (a spill fails), and
    the shared memory of two launches (the full width; GQA at D 64) as the
    library sizes it, which `_plan`'s `_smem` must equal."""
    import ctypes

    from grove_tpu_torch import _kernels
    from grove_tpu_torch.ops import decode_attention
    fns = {}
    for fn, lines in ptxas.items():
        m = re.search(r"decode_kernelI(f|13__nv_bfloat16)Li(\d+)E", fn)
        if m:
            fns[f"{'fp32' if m[1] == 'f' else 'bf16'} q, {m[2]} query "
                f"head{'s' if m[2] != '1' else ''} a pass"] = lines
    if len(fns) != 4:
        raise PhaseError(f"{K6_SOURCE}: ptxas reported {sorted(fns)}")
    for label, lines in sorted(fns.items()):
        say(2, f"int8_decode_attention ({label}): ptxas "
               f"{'; '.join(lines)} ({gpu})")
        if _spills(lines):
            raise PhaseError(f"int8_decode_attention ({label}) spills: "
                             f"{lines}")
    fn = _kernels.load().grove_int8_decode_attention_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    for b, h, hkv, c, d in ((2, 32, 32, 768, 128), (2, 8, 2, 384, 64),
                            K6_ENGINE[:5]):
        p = decode_attention._plan(b, h, hkv, c, d, 132)
        lib = fn(p.ring, p.span, h // hkv, d)
        if lib != p.smem:
            raise PhaseError(f"int8_decode_attention {(b, h, hkv, c, d)}: "
                             f"the library sizes {lib} B of shared memory, "
                             f"_plan {p.smem}")
        say(2, f"int8_decode_attention {(b, h, hkv, c, d)}: its launch asks "
               f"for {lib} B of shared memory, as _plan says ({gpu})")


def _int4_fused_widths(torch, gpu):
    """K7a and K7b at LLaMA-7B's fused decode widths, (2, 4096, 12288)
    (q/k/v) and (2, 4096, 22016) (gate/up), in fp32 and bf16 (K7b: its
    output's dtype), bit-equal to the concatenation of their calls on the
    unfused parts' column slices: `_plan` splits K by K and G alone and a
    column's arithmetic does not depend on its place, so both sum every
    column in one order. K7c's int8 view of each fused weight likewise
    against its parts' views."""
    from grove_tpu_torch.ops import int4_matmul
    gen = torch.Generator(device="cuda").manual_seed(15)
    xq = torch.randint(-127, 128, (2, 4096), generator=gen, device="cuda",
                       dtype=torch.int8)
    sx = 0.002 + 0.018 * torch.rand((2, 1), generator=gen, device="cuda")
    for n, parts in ((12288, 3), (22016, 2)):
        wp = torch.randint(-128, 128, (2048, n), generator=gen,
                           device="cuda", dtype=torch.int8)
        scale = 0.001 + 0.019 * torch.rand((32, n), generator=gen,
                                           device="cuda")
        w = n // parts
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((2, 4096), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype)
            calls = {
                "int4_matmul": lambda wp, scale: int4_matmul.int4_matmul(
                    x, wp, scale),
                "int4_matmul_a8": lambda wp, scale:
                    int4_matmul.int4_matmul_a8(xq, sx, wp, scale, dtype)}
            for name, call in calls.items():
                whole = call(wp, scale)
                cat = torch.cat([call(
                    wp[:, i * w:(i + 1) * w].contiguous(),
                    scale[:, i * w:(i + 1) * w].contiguous())
                    for i in range(parts)], dim=1)
                torch.cuda.synchronize()
                if not torch.equal(whole, cat):
                    diff = float((whole.float() - cat.float()).abs().max())
                    raise PhaseError(f"{name} (2, 4096, {n}) {dtype}: not "
                                     f"bit-equal to its {parts} parts (max "
                                     f"|diff| {diff:.3e})")
                say(2, f"{name} fused (2, 4096, {n}) {dtype}: bit-equal to "
                       f"{parts} calls on its (2, 4096, {w}) column slices "
                       f"({gpu})")
        # K7c: the int8 view of the fused weight against its parts' views
        mult = int4_matmul.requant_multipliers(scale)[1]
        whole = int4_matmul.int4_requant_int8(wp, mult)
        cat = torch.cat([int4_matmul.int4_requant_int8(
            wp[:, i * w:(i + 1) * w].contiguous(),
            mult[:, i * w:(i + 1) * w].contiguous())
            for i in range(parts)], dim=1)
        torch.cuda.synchronize()
        if not torch.equal(whole, cat):
            raise PhaseError(f"int4_requant_int8 (4096, {n}): not bit-equal "
                             f"to its {parts} parts")
        say(2, f"int4_requant_int8 fused (4096, {n}): bit-equal to {parts} "
               f"calls on its (4096, {w}) column slices ({gpu})")


def _tc_instance(name):
    """The name of a tensor-core entry's instantiation (`X_tc` for its
    `X_tc_kernel` and `grove_X_tc_smem`): its symbol's, unless
    TC_INSTANCES names another."""
    from grove_tpu_torch import _kernels
    return TC_INSTANCES.get(
        name, _kernels.KERNELS[name].symbol.removeprefix("grove_"))


def _tc_smem(name, d):
    """The dynamic shared memory a tensor-core entry's launch asks for at
    head dim d, in bytes, as the library's `grove_<name>_smem` returns it
    (the function its dispatcher sizes the launch with), with the term
    tables of SAM's 32 x 32 grid (gh + gw = 64, the widest) where it takes
    them."""
    import ctypes

    from grove_tpu_torch import _kernels
    fn = getattr(_kernels.load(), f"grove_{_tc_instance(name)}_smem")
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn(d, 32, 32)


def _stop_tc_compiles(compiles):
    """Kill what is left of `_tc_compiles` (a phase failed before its
    report) and remove its output directory."""
    for key, proc in list(compiles.items()):
        if key != "dir" and proc.poll() is None:
            proc.kill()
            proc.wait()
    if "dir" in compiles:
        shutil.rmtree(compiles.pop("dir"), ignore_errors=True)


def _k14_breakdown(torch, gpu, rows):
    """K14's wrapper time at the full-width (16, 32, 32, 1280) bf16 grid,
    win 14, one call each between CUDA events (host launch included):
    torch's zero pad (`F.pad`, 32 -> 42, the pass the wrappers no longer
    run), each wrapper (its kernel pads or drops the pad itself), each
    kernel alone (`_copy` into a preallocated output), and a contiguous
    device-to-device `copy_` of the grid's bytes (what the card moves at
    this size with no relayout). Each with the bytes it moves and the rate
    that gives. Adds `copy_ms` (the kernel alone) to both K14 rows."""
    import torch.nn.functional as F
    from grove_tpu_torch.ops import window_ops
    b, h, win, c, hp = 16, 32, 14, 1280, 42
    x = torch.randn((b, h, h, c), device="cuda", dtype=torch.bfloat16)
    wins = window_ops.window_partition_fused(x, win)
    grid = torch.empty_like(x)
    one = 2 * b * h * h * c                    # bytes of one (B, 32, 32, C)
    pad = 2 * b * hp * hp * c                  # ... of the padded grid
    parts = {
        "F.pad 32 -> 42 alone": (
            lambda: F.pad(x, (0, 0, 0, hp - h, 0, hp - h)), one + pad),
        "window_partition_fused": (
            lambda: window_ops.window_partition_fused(x, win), one + pad),
        "partition kernel alone": (
            lambda: window_ops._copy("window_partition", x,
                                     torch.empty_like(wins), b, h, h, win),
            one + pad),
        "window_unpartition_fused": (
            lambda: window_ops.window_unpartition_fused(wins, win, (h, h)),
            2 * one),
        "unpartition kernel alone": (
            lambda: window_ops._copy("window_unpartition", wins, grid, b, h,
                                     h, win), 2 * one),
        "contiguous copy_ of the grid": (lambda: grid.copy_(x), 2 * one),
    }
    notes, times = [], {}
    for what, (fn, nbytes) in parts.items():
        times[what] = t = _time_ms(torch, fn, [()])
        notes.append(f"{what} {t:.4f} ms for {nbytes / 1e6:.2f} MB "
                     f"({nbytes / t / 1e6:.0f} GB/s)")
    rows["window_partition"]["copy_ms"] = times["partition kernel alone"]
    rows["window_unpartition"]["copy_ms"] = times["unpartition kernel alone"]
    say(2, f"K14 split, bf16 ({b}, {h}, {h}, {c}), win {win}, one call "
           f"each: {'; '.join(notes)} on {gpu}")


def _trainable_forms(torch, gpu):
    """The trainable forms of K12 and K14 on the card against the CPU at a
    small fp32 shape: `sam_window_attention_raw` (forward K12, backward
    K9) output and gradients of q, k, v and both tables within
    TRAIN_GRAD_TOL of the CPU's max-abs; the K14 pair (each the other's
    backward) bit-equal, forward and backward, on a grid that needs a
    pad."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.ops import sam_attention, window_ops
    gen = torch.Generator().manual_seed(6)
    nw, s, heads, d = 3, 196, 2, 64
    raw = [torch.randn((nw, s, heads * d), generator=gen) for _ in range(4)]
    tables = [0.5 * torch.randn((27, d), generator=gen) for _ in range(2)]

    def attention(dev):
        leaves = [t.to(dev).requires_grad_() for t in raw[:3] + tables]
        out = sam_attention.sam_window_attention_raw(*leaves, (14, 14),
                                                     heads)
        grads = torch.autograd.grad(out, leaves, raw[3].to(dev))
        return [t.detach().cpu() for t in (out, *grads)]

    before = {k: v.launches for k, v in _kernels.KERNELS.items()}
    card = attention("cuda")
    used = {k: v.launches - before[k] for k, v in _kernels.KERNELS.items()
            if v.launches > before[k]}
    host = attention("cpu")
    rel = max(_max_err(a, b) / float(b.abs().max())
              for a, b in zip(card, host))
    if not rel <= TRAIN_GRAD_TOL or not {"sam_window_attention_v2",
                                         "relpos_flash_dq"} <= set(used):
        raise PhaseError(f"sam_window_attention_raw card vs CPU {rel:.3e} "
                         f"of max-abs (limit {TRAIN_GRAD_TOL}), kernels "
                         f"{used}")
    x = torch.randn((2, 30, 30, 16), generator=gen)
    g_win = torch.randn((18, 14, 14, 16), generator=gen)

    def pair(dev):
        xa = x.to(dev).requires_grad_()
        wa = g_win.to(dev).requires_grad_()
        part = window_ops.window_partition_fused(xa, 14)
        unpart = window_ops.window_unpartition_fused(wa, 14, (30, 30))
        (dx,) = torch.autograd.grad(part, xa, g_win.to(dev))
        (dw,) = torch.autograd.grad(unpart, wa, x.to(dev))
        return [t.detach().cpu() for t in (part, unpart, dx, dw)]

    for a, b in zip(pair("cuda"), pair("cpu")):
        _check_exact("window_partition / unpartition (trainable)",
                     tuple(a.shape), a, b)
    say(2, f"trainable forms card vs CPU (fp32): sam_window_attention_raw "
           f"({nw}, {s}, {heads * d}) out and 5 gradients within {rel:.2e} "
           f"of max-abs (kernels {used}); window_partition_fused / "
           "window_unpartition_fused (2, 30, 30, 16), win 14, and their "
           f"backwards bit-equal on {gpu}")


def _ragged_routes(torch, gpu):
    """One causal attention call at the training driver's (1, 2111, 32,
    128) bf16, forward and backward (`torch.autograd.grad` of q, k, v), by
    the three routes the port has for a ragged S: K5 with the torch-ops
    recompute backward (the port's route before K10), K10 with the same
    backward (the JAX route, which the port takes now; bf16 at D = 128
    runs K10's tensor-core entry), K4 with K4b (its kernels both ways);
    and SDPA's forward and backward, for comparison
    only. Each route's output and gradients within ROUTE_TOL of SDPA's
    max-abs (bf16 gradients through two different softmax backwards);
    median CUDA-event ms of each printed."""
    import torch.nn.functional as F
    from grove_tpu_torch.ops import attention, flash_backward
    b, s, h, d = 1, 2111, 32, 128
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, g = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))

    def raw(t):
        return t.reshape(b, s, h * d)

    routes = {
        "K5 (tensor-core body) + torch backward": lambda q, k, v: attention.
        prefill_attention_trainable(raw(q), raw(k), raw(v), h, scale)
        .reshape(b, s, h, d),
        "K10 (tensor-core body) + torch backward": lambda q, k, v:
        attention._flash_with_vjp(q, k, v, True, scale),
        "K4 + K4b": lambda q, k, v: flash_backward.flash_attention_trainable(
            q, k, v, True, scale),
        "SDPA (library)": lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True).transpose(1, 2),
    }
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def fwd_bwd(route):
        out = route(*leaves)
        return (out, *torch.autograd.grad(out, leaves, g))

    want = fwd_bwd(routes["SDPA (library)"])
    notes = []
    for name, route in routes.items():
        got = fwd_bwd(route)
        rel = max(_max_err(x.detach(), w.detach())
                  / float(w.detach().float().abs().max())
                  for x, w in zip(got, want))
        if not rel <= ROUTE_TOL:
            raise PhaseError(f"{name} at (1, 2111, 32, 128): output or "
                             f"gradient {rel:.3e} of SDPA's max-abs > "
                             f"{ROUTE_TOL}")
        ms = _time_ms(torch, lambda: fwd_bwd(route), [()])
        notes.append(f"{name} {ms:.4f} ms (out, dq, dk, dv within "
                     f"{rel:.2e} of SDPA's max-abs)")
        del got
    say(2, "causal attention forward + backward at the ragged S = 2111 "
           f"(1, 2111, 32, 128) bf16: {'; '.join(notes)} on {gpu}")


def _odd_grid_routes(torch, gpu):
    """K9's dq and dkv in bf16 at D = 64 on a 7 x 7 grid, whose term
    tables' (batch, head) blocks of 49 x 7 values are not 16-byte aligned:
    each wrapper launches its SIMT entry once and its tensor-core one
    never, and dq, d_rh, d_rw, dk, dv lie within FULL_TOL of the plain
    twins' max-abs."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.ops import flash_backward, sam_attention_bwd
    gen = torch.Generator(device="cuda").manual_seed(4)
    hw, scale = (7, 7), 64 ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, g = (randn(2, 49, 2, 64) for _ in range(4))
    rh, rw = randn(2, 2, 49, 7), randn(2, 2, 49, 7)
    out, lse = sam_attention_bwd.relpos_flash_fwd_lse_torch(q, k, v, rh, rw,
                                                            hw, scale)
    args = (q, k, v, rh, rw, g, lse, flash_backward.row_dot(out, g), hw,
            scale)
    notes = []
    for name, fn, plain in (
            ("relpos_flash_dq", sam_attention_bwd.relpos_flash_dq,
             sam_attention_bwd.relpos_flash_dq_torch),
            ("relpos_flash_dkv", sam_attention_bwd.relpos_flash_dkv,
             sam_attention_bwd.relpos_flash_dkv_torch)):
        names = (name, name + "_tc")
        before = [_kernels.KERNELS[n].launches for n in names]
        got = fn(*args)
        torch.cuda.synchronize()
        ran = tuple(_kernels.KERNELS[n].launches - b
                    for n, b in zip(names, before))
        if ran != (1, 0):
            raise PhaseError(f"{name} bf16 on a 7 x 7 grid launched (SIMT, "
                             f"tensor-core) {ran} times, not (1, 0)")
        errs = _check_full(name, "7 x 7 route", got, plain(*args))
        notes.append(f"{name} the SIMT entry, within "
                     f"{', '.join(f'{r:.2e}' for _, r in errs)}")
    say(2, f"K9 bf16 on a 7 x 7 grid (unaligned term tables): "
           f"{'; '.join(notes)} of the plain twins' max-abs on {gpu}")


def _int8_matmul_padded(torch, gpu):
    """The W8A8 int8 GEMM at shapes `torch._int_mm` refuses, zero-padded by
    `ops.int8_matmul`: lm_head's (704 x 4096) x (4096 x 32007) with the
    weight padded once in its storage (`column_major`) and again with a
    weight that has no room (padded per call), a decode row block (M = 2)
    and a K that is no multiple of 8. Each product is bit-equal to a
    float64 product on the card (exact: |sums| < 2^53)."""
    from grove_tpu_torch.ops.int8_matmul import column_major, int8_matmul
    gen = torch.Generator(device="cuda").manual_seed(1)

    def int8s(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    lm = int8s((4096, 32007))
    notes = []
    for m, b, what in ((704, column_major(lm), "padded once"),
                       (704, lm.t().contiguous().t(), "padded per call"),
                       (2, column_major(lm), "M = 2"),
                       (5, column_major(int8s((100, 37))), "K = 100")):
        a = int8s((m, b.shape[0]))
        got = int8_matmul(a, b)
        want = torch.matmul(a.double(), b.double())
        diff = int((got.double() - want).abs().max())
        if got.dtype != torch.int32 or got.shape != want.shape or diff:
            raise PhaseError(f"int8_matmul {what} {tuple(a.shape)} x "
                             f"{tuple(b.shape)}: {got.dtype} "
                             f"{tuple(got.shape)}, max diff {diff}")
        t = _time_ms(torch, int8_matmul, [(a, b)])
        notes.append(f"{what} ({m} x {b.shape[0]} x {b.shape[1]}) "
                     f"{t:.4f} ms")
        del a, got, want
    say(2, "int8_matmul (torch._int_mm, zero-padded) bit-equal to a float64 "
           f"product: {'; '.join(notes)} on {gpu}")


# ---------------------------------------------------------------------------
# phase 3: the full-width slice
# ---------------------------------------------------------------------------

CLIP_KEYS = {"text", "text_tagged", "phrases", "center_frame_indices",
             "frame_indices", "bboxes", "labels_per_frame",
             "probs_temp_objectness", "original_size"}
GROUND_KEYS = {"frame_indices", "bboxes", "probs_temp_objectness",
               "original_size"}


def _synthetic_clips(cfg, n, frames, seed):
    rng = np.random.default_rng(seed)
    c, s = cfg.clip.image_size, cfg.sam_enc.img_size
    return [{"frames_clip": rng.integers(0, 256, (frames, c, c, 3), np.uint8),
             "frames_sam": rng.integers(0, 256, (frames, s, s, 3), np.uint8),
             "original_size": (640, 480)} for _ in range(n)]


def _check_output(out, keys, t_total, what):
    if set(out) != keys:
        raise PhaseError(f"{what}: keys {sorted(out)} != {sorted(keys)}")
    if sorted(out["frame_indices"]) != list(range(t_total)):
        raise PhaseError(f"{what}: frames covered {out['frame_indices']}")
    for field in ("bboxes", "probs_temp_objectness"):
        for a in out[field]:
            if not np.all(np.isfinite(np.asarray(a, np.float64))):
                raise PhaseError(f"{what}: non-finite {field}")


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _model_bytes(model):
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


def _run_path(torch, gpu, model, cfg, tok, clips, t_total, label, need,
              decode_kwargs=None):
    """One main-path run: infer_clips_batched then
    ground_clip_with_caption, launch counts zeroed just before and read
    just after; every kernel in `need` must have launched."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.infer.sliding import (ground_clip_with_caption,
                                               infer_clips_batched)
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    outs, ms_batched = _timed(torch, lambda: infer_clips_batched(
        model, cfg, tok, clips, instruction=list(PROMPTS), max_new_tokens=64,
        decode_kwargs=decode_kwargs))
    ground, ms_ground = _timed(torch, lambda: ground_clip_with_caption(
        model, cfg, tok, clips[0]["frames_clip"], clips[0]["frames_sam"],
        clips[0]["original_size"], caption=CAPTION, use_objectness=True))
    launches = {k: v.launches for k, v in _kernels.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    say(3, f"{label}: infer_clips_batched (2 clips x {t_total} frames, 64 "
           f"new tokens) {ms_batched:.1f} ms; ground_clip_with_caption "
           f"{ms_ground:.1f} ms; kernel launches {launches}; peak "
           f"{peak / 2**30:.2f} GiB, weights "
           f"{_model_bytes(model) / 2**30:.2f} GiB on {gpu}")
    for i, out in enumerate(outs):
        _check_output(out, CLIP_KEYS, t_total, f"{label} clip {i}")
        say(3, f"{label} clip {i}: {len(out['phrases'])} phrases, caption "
               f"{out['text'][:80]!r}")
    _check_output(ground, GROUND_KEYS, t_total,
                  f"{label} ground_clip_with_caption")
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        raise PhaseError(f"{label}: kernels never launched on the main "
                         f"path: {missing}")
    off = {k: launches[k] for k in OFF_PATH_KERNELS + SIMT_ENTRIES
           if launches[k]}
    if off:
        raise PhaseError(f"{label}: kernels of no model path, or the SIMT "
                         f"entries of K2 / K3 / K4 / K10 in bf16, launched: "
                         f"{off}")
    return launches


def _det_branch(torch, model, cfg, tok, clip, threshold):
    """`infer.sliding._finish_clip`, the [DET] branch of
    `infer_clips_batched`, on one clip with a caption that holds two
    phrases and two [DET]s (`text.tagging.tag_caption`), as if the center
    window had generated it: `pack_text` of the answer, `forward_boxes`
    over the non-center windows, `postprocess_window`. The center window's
    own boxes are zeros (the greedy path would hand its ground() output
    there). Returns the output dict, checked for the JAX package's keys,
    every frame, two phrases and finite values."""
    from grove_tpu_torch.data.sampling import (center_window_index,
                                               sliding_segment_with_mask)
    from grove_tpu_torch.infer.sliding import _finish_clip, postprocess_window
    from grove_tpu_torch.text import tagging
    text = tagging.tag_caption(DET_CAPTION, DET_SPANS)
    parsed = tagging.parse_generation(text)
    phrases = parsed["phrases"]
    t_total = clip["frames_clip"].shape[0]
    windows, masks = sliding_segment_with_mask(t_total, cfg.num_frames)
    ci = center_window_index(masks)
    if len(phrases) != 2 or len(windows) < 2:
        raise PhaseError(f"[DET] branch: {phrases}, {len(windows)} windows")
    nf, p = cfg.num_frames, cfg.max_phrases
    center = postprocess_window(np.zeros((nf, p, 4), np.float32),
                                np.zeros((nf, p), np.float32), phrases, 2,
                                clip["original_size"], threshold)
    with torch.inference_mode():
        out = _finish_clip(model, cfg, tok, clip["frames_clip"],
                           clip["frames_sam"], clip["original_size"],
                           windows, masks, ci, windows[ci], text, parsed,
                           phrases, 2, threshold, None, *center)
    _check_output(out, CLIP_KEYS, t_total, "[DET] branch")
    if out["phrases"] != phrases or any(len(pr) != 2 for pr in
                                        out["probs_temp_objectness"]):
        raise PhaseError(f"[DET] branch: phrases {out['phrases']}, "
                         "probabilities not two per frame")
    return out


def _replay(torch, gpu, model, cfg, tok, clips, label, cache_dtype,
            encoders: bool):
    """Timed replay of the stages on the first call's inputs; returns the
    stage times and the greedy ids of the 64-step decode. The prefill
    stage is the path's: the two PROMPTS left-padded to 2 x 640 tokens,
    which an int8 cache sends through K5 in every layer (checked); the
    64-step decode follows the two unpadded default prompts (2 x 634
    tokens, whose prefill takes the plain attention) and is timed net of
    their prefill."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.infer.generate import greedy_decode
    from grove_tpu_torch.infer.sliding import center_prompts
    from grove_tpu_torch.models.llama import init_kv_caches
    dev, nf = "cuda", cfg.num_frames
    fc = torch.from_numpy(np.stack([c["frames_clip"][:nf] for c in clips])
                          ).to(dev)
    fs = torch.from_numpy(np.stack([c["frames_sam"][:nf] for c in clips])
                          ).to(dev)
    stages = {}
    with torch.inference_mode():
        (emb, _), t_clip = _timed(torch, lambda: model.encode_video(fc))
        img, t_sam = _timed(torch, lambda: model.encode_grounding_auto(fs))
        if encoders:
            stages.update(clip=t_clip, sam=t_sam)
        pids, pstarts, pads = center_prompts(cfg, tok, list(PROMPTS))
        pids_t = torch.from_numpy(pids).to(dev)
        pads_t = torch.from_numpy(pads).to(dev)
        caches = init_kv_caches(cfg.llama, 2, pids.shape[1],
                                dtype=cache_dtype, device=dev)
        k5 = ("prefill_attention_tc", "prefill_attention")
        before = [_kernels.KERNELS[k].launches for k in k5]
        _, stages["prefill"] = _timed(torch, lambda: model.prefill(
            pids_t, emb, pstarts, caches, pad_lens=pads_t))
        ran = sum(_kernels.KERNELS[k].launches - b
                  for k, b in zip(k5, before))
        if cache_dtype == torch.int8 and ran != cfg.llama.num_layers:
            raise PhaseError(f"{label} replay: the prefill of "
                             f"{tuple(pids.shape)} tokens launched K5 {ran} "
                             f"times, not {cfg.llama.num_layers}")
        del caches
        ids, starts, _ = center_prompts(cfg, tok, [None, None])
        ids_t = torch.from_numpy(ids).to(dev)
        caches = init_kv_caches(cfg.llama, 2, ids.shape[1] + 64,
                                dtype=cache_dtype, device=dev)
        _, t_pre = _timed(
            torch, lambda: model.prefill(ids_t, emb, starts, caches))
        (gen, hidden), ms_gen = _timed(torch, lambda: greedy_decode(
            model, ids_t, emb, starts, max_new_tokens=64,
            eos_id=cfg.tokens.eos, cache_dtype=cache_dtype,
            early_exit=False))
        stages["decode_64"] = ms_gen - t_pre
        det = torch.arange(cfg.max_phrases, device=dev)[None].expand(2, -1)
        if encoders:
            _, stages["ground"] = _timed(
                torch, lambda: model.ground(hidden, det, img))
        # a 32-token answer after the prompt, bucketed to 64 like
        # _finish_clip does
        pad = -(-(ids.shape[1] + 32) // 64) * 64 - ids.shape[1]
        batch = {"frames_clip": fc, "frames_sam": fs,
                 "input_ids": torch.nn.functional.pad(ids_t, (0, pad)),
                 "video_start": starts, "det_positions": det}
        _, stages["teacher_forced_2x8"] = _timed(
            torch, lambda: model.forward_boxes(batch))
    say(3, f"{label} stage ms (2 clips x 8 frames, replay): "
           + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
           + f"; decode {stages['decode_64'] / 64:.2f} ms/step on {gpu}")
    return stages, gen.cpu().numpy()


def phase_slice(torch, gpu, decoder):
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.api import GroveForCausalLM
    from grove_tpu_torch.ops.quant import quantize_vision_
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer

    t0 = time.perf_counter()
    lm = GroveForCausalLM.from_pretrained(None, "full", device="cuda",
                                          dtype=torch.bfloat16, seed=0)
    cfg, model = lm.cfg, lm.model
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    assert tok.token_id("[DET]") == cfg.tokens.det
    n_params = sum(p.numel() for p in model.parameters())
    say(3, f"bf16 model: {n_params / 1e9:.3f} B parameters built on "
           f"the card in {time.perf_counter() - t0:.1f} s, "
           f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    t_total = 24
    clips = _synthetic_clips(cfg, 2, t_total, seed=1)
    quant = set(QUANT_KERNELS)
    bf16 = [k for k in _kernels.KERNELS
            if k not in quant | set(W8A8_KERNELS) | set(FLAGSHIP_KERNELS)
            | {LN_KERNEL} | set(TRAIN_KERNELS) | set(OFF_PATH_KERNELS)
            | set(SIMT_ENTRIES)]
    launches = _run_path(torch, gpu, model, cfg, tok, clips, t_total,
                         "bf16", bf16)
    st_bf16, gen_bf16 = _replay(torch, gpu, model, cfg, tok, clips, "bf16",
                                torch.bfloat16, encoders=True)
    say(3, f"bf16 CLIP encode_video (2 clips x 8 frames, 24 launches of "
           f"K3's tensor-core entry): {st_bf16['clip']:.1f} ms; with K3 on "
           f"its SIMT body it took {SIMT_CLIP_MS} ms on an H100 80GB HBM3 "
           f"at 700 W (this run: {gpu})")
    say(3, f"bf16 SAM encode_grounding (2 clips x 8 frames, 28 launches of "
           f"K1's and 4 of K2's tensor-core entries): {st_bf16['sam']:.1f} "
           f"ms; teacher-forced forward_boxes (the same SAM, 32 launches of "
           f"K4's tensor-core entry): {st_bf16['teacher_forced_2x8']:.1f} "
           f"ms; with K1 on its SIMT body they took {SIMT_K1_SAM_MS['bf16']} "
           f"and {SIMT_K1_TEACHER_MS} ms on an H100 80GB HBM3 at 700 W (this "
           f"run: {gpu})")
    _kernels.reset_launch_counts()
    det, ms = _timed(torch, lambda: _det_branch(
        torch, model, cfg, tok, clips[0], cfg.temp_objectness_threshold))
    kept = sum(len(b) for b in det["bboxes"])
    used = {k: v.launches for k, v in _kernels.KERNELS.items() if v.launches}
    say(3, f"bf16 [DET] branch (`_finish_clip`, caption {DET_CAPTION!r} "
           f"tagged at 2 phrases, {t_total} frames, the non-center windows "
           f"teacher-forced): {ms:.1f} ms, {kept} boxes kept over "
           f"{len(det['frame_indices'])} frames, kernel launches {used} on "
           f"{gpu}")
    if not used.get("flash_forward_lse_tc"):
        raise PhaseError("[DET] branch: the teacher-forced windows ran no "
                         "K4 tensor-core entry")
    _processor_path(torch, gpu, model, cfg, tok, decoder)

    t0 = time.perf_counter()
    lm = lm.quantize(bits=4)
    torch.cuda.synchronize()
    cfg, model = lm.cfg, lm.model
    say(3, f"quantize(bits=4) in place on the card in "
           f"{time.perf_counter() - t0:.1f} s: weights "
           f"{_model_bytes(model) / 2**30:.2f} GiB")
    int8_kv = {"cache_dtype": torch.int8}
    q_launches = _run_path(torch, gpu, model, cfg, tok, clips, t_total,
                           "int4 + int8 KV", bf16 + list(quant),
                           decode_kwargs=int8_kv)
    _check_prefill(q_launches, cfg, "int4 + int8 KV")
    launches.update({k: q_launches[k] for k in quant})
    st_q, gen_q = _replay(torch, gpu, model, cfg, tok, clips,
                       "int4 + int8 KV", torch.int8, encoders=False)
    _same_tokens(gen_q, gen_bf16, "int4 + int8 KV")

    # the towers W8A8 too, calibrated on the first 8 frames of one clip
    t0 = time.perf_counter()
    quantize_vision_(model)
    nf = cfg.num_frames
    lm.calibrate(clips[0]["frames_clip"][None, :nf],
                 clips[0]["frames_sam"][None, :nf])
    torch.cuda.synchronize()
    cfg = lm.cfg
    label = "int4 + int8 KV + W8A8-static towers"
    say(3, f"towers quantized in place and calibrated on the card in "
           f"{time.perf_counter() - t0:.1f} s: weights "
           f"{_model_bytes(model) / 2**30:.2f} GiB")
    need = [k for k in _kernels.KERNELS
            if k not in ("sam_window_attention_tc", LN_KERNEL)
            + FLAGSHIP_KERNELS + TRAIN_KERNELS + OFF_PATH_KERNELS
            + SIMT_ENTRIES]
    w_launches = _run_path(torch, gpu, model, cfg, tok, clips, t_total,
                           label, need, decode_kwargs=int8_kv)
    launches.update({k: w_launches[k] for k in W8A8_KERNELS})
    st_w, gen_w = _replay(torch, gpu, model, cfg, tok, clips, label,
                          torch.int8, encoders=True)
    say(3, f"encoder stages, W8A8-static vs bf16 (2 clips x 8 frames): "
           f"CLIP {st_w['clip']:.1f} vs {st_bf16['clip']:.1f} ms, SAM "
           f"{st_w['sam']:.1f} vs {st_bf16['sam']:.1f} ms on {gpu}; the "
           f"W8A8-static SAM with K1q on its SIMT body took "
           f"{SIMT_K1_SAM_MS['W8A8-static']} ms on an H100 80GB HBM3 at "
           f"700 W")
    _same_tokens(gen_w, gen_bf16, label)

    # the flagship of the JAX package's bench.py: the LLM's activations
    # int8 too, switched on in place (the int4 bytes stay)
    t0 = time.perf_counter()
    lm.quantize(bits=4, act_quant=True)
    torch.cuda.synchronize()
    cfg = lm.cfg
    label = "W4A8 + int8 KV + W8A8-static towers (flagship)"
    say(3, f"quantize(bits=4, act_quant=True) in place in "
           f"{time.perf_counter() - t0:.1f} s: weights "
           f"{_model_bytes(model) / 2**30:.2f} GiB")
    need = [k for k in _kernels.KERNELS
            if k not in ("sam_window_attention_tc", LN_KERNEL,
                         "int4_matmul")
            + TRAIN_KERNELS + OFF_PATH_KERNELS + SIMT_ENTRIES]
    f_launches = _run_path(torch, gpu, model, cfg, tok, clips, t_total,
                           label, need, decode_kwargs=int8_kv)
    if f_launches["int4_matmul"]:
        raise PhaseError(f"{label}: K7a launched {f_launches['int4_matmul']}"
                         " times; W4A8 decode takes K7b")
    _check_prefill(f_launches, cfg, label)
    launches.update({k: f_launches[k] for k in FLAGSHIP_KERNELS})
    st_f, gen_f = _replay(torch, gpu, model, cfg, tok, clips, label,
                          torch.int8, encoders=True)
    say(3, f"LLaMA stages, W4A8 vs W4A16 (both with W8A8-static towers): "
           f"prefill {st_f['prefill']:.1f} vs {st_w['prefill']:.1f} ms, "
           f"decode {st_f['decode_64'] / 64:.2f} vs "
           f"{st_w['decode_64'] / 64:.2f} ms/step, teacher-forced "
           f"{st_f['teacher_forced_2x8']:.1f} vs "
           f"{st_w['teacher_forced_2x8']:.1f} ms on {gpu}")
    _same_tokens(gen_f, gen_bf16, label)
    say(3, f"int8-cache prefill (2 x 640 tokens, 32 launches of K5's "
           f"tensor-core entry): int4 + int8 KV {st_q['prefill']:.1f} ms, "
           f"flagship {st_f['prefill']:.1f} ms on {gpu}")
    _lm_forward_w8a8(torch, gpu, model, cfg, tok, clips)
    del model, lm
    torch.cuda.empty_cache()
    return launches


def _check_prefill(launches, cfg, label):
    """One int8-cache prefill of the two left-padded prompts per run: K5's
    tensor-core entry exactly once in each LLaMA layer, its SIMT entry
    never (bf16 at D = 128)."""
    want = cfg.llama.num_layers
    got = (launches["prefill_attention_tc"], launches["prefill_attention"])
    if got != (want, 0):
        raise PhaseError(f"{label}: K5 launched {got} times (tensor-core, "
                         f"SIMT), not ({want}, 0)")


def _clip_sources(decoder: str, tmp: str, seeds, frames: int = 24):
    """(paths, decoder_factory) for GroveProcessor: where phase 0 found
    libav, .y4m clips written under `tmp` (`y4m_clip`, one per seed) and
    the native decoder; else no file at all and SyntheticVideo frames of the
    same size, one seed per path name (GroveProcessor itself never
    chooses)."""
    from grove_tpu_torch.data.video import SyntheticVideo, VideoDecoder
    paths = [str(Path(tmp) / f"clip{seed}.y4m") for seed in seeds]
    if decoder == "libav":
        for path, seed in zip(paths, seeds):
            y4m_clip(path, seed=seed, frames=frames)
        return paths, VideoDecoder
    by_path = dict(zip(paths, seeds))
    return paths, lambda path: SyntheticVideo(
        num_frames=frames, width=640, height=360, seed=by_path[path])


def _processor_path(torch, gpu, model, cfg, tok, decoder):
    """The main path's entry on the bf16 model: two 24-frame 640 x 360
    .y4m clips at 5 fps (written here, `y4m_clip`) through
    `GroveProcessor.generate_batch` with two questions (decode, host
    preprocessing bit-equal to the JAX package's PIL transforms, the
    sliding windows); then the raw uint8 mode through
    `infer_clips_batched` (the decoded 640 x 360 frames passed as both
    towers' input, resized on the card) and the packed-YUV420 mode through
    `encode_video` + `encode_grounding`. Launch counts are zeroed before
    each and printed after; the tensor-core entries of K1, K2 and K3
    must run in the first two, and no SIMT entry of K2, K3, K4 or K10 nor
    any of OFF_PATH_KERNELS in any."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.api import GroveProcessor
    from grove_tpu_torch.data.preprocess import (preprocess_frames,
                                                 rgb_to_yuv420)
    from grove_tpu_torch.infer.sliding import infer_clips_batched
    need = ("sam_window_attention_tc", "sam_global_attention_tc",
            "grouped_plain_attention_tc")
    shown = need + ("flash_forward_lse_tc",) + SIMT_ENTRIES

    def counts(label):
        used = {k: _kernels.KERNELS[k].launches for k in shown}
        missing = [k for k in need if not used[k]]
        if missing or any(used[k] for k in SIMT_ENTRIES):
            raise PhaseError(f"{label}: kernels never launched: {missing}, "
                             f"or a SIMT entry in bf16: {used}")
        _check_off_path(label)
        return used

    with tempfile.TemporaryDirectory() as tmp:
        paths, factory = _clip_sources(decoder, tmp, (20, 21))
        proc = GroveProcessor(tok, cfg, decoder_factory=factory)
        ms_decode = ms_prep = 0.0
        for path in paths:
            t0 = time.perf_counter()
            frames = proc.decode_video(path)
            t1 = time.perf_counter()
            fc, fs = preprocess_frames(frames, cfg.clip.image_size,
                                       cfg.sam_enc.img_size)
            ms_decode += (t1 - t0) * 1e3 / len(paths)
            ms_prep += (time.perf_counter() - t1) * 1e3 / len(paths)
        _kernels.reset_launch_counts()
        outs, ms = _timed(torch, lambda: proc.generate_batch(
            model, paths, instructions=list(PROMPTS), max_new_tokens=64))
        used = counts("GroveProcessor.generate_batch")
    for i, out in enumerate(outs):
        _check_output(out, CLIP_KEYS, 24, f"GroveProcessor clip {i}")
        if tuple(out["original_size"]) != (640, 360):
            raise PhaseError(f"GroveProcessor clip {i}: original_size "
                             f"{out['original_size']}")
    shape = fc.shape, fs.shape
    if decoder == "libav":
        source, first = "2 .y4m clips", f"decode {ms_decode:.1f} ms"
    else:
        source = "2 SyntheticVideo clips (no libav, no file written)"
        first = (f"SyntheticVideo's in-memory frames (no decode) "
                 f"{ms_decode:.1f} ms")
    say(3, f"GroveProcessor.generate_batch (decoder: {decoder}; {source} "
           f"of 24 frames at 640 x 360, 5 fps, two questions, 64 new "
           f"tokens): {ms:.1f} ms, {ms / 2:.1f} ms per clip end to end, of "
           f"which per clip {first} + host preprocessing {ms_prep:.1f} ms "
           f"(frames {shape[0]} / {shape[1]}); K1-K4 launches {used}; "
           f"captions {[o['text'][:40] for o in outs]} on {gpu}")

    raw = [{"frames_clip": frames, "frames_sam": frames,
            "original_size": (640, 360)} for _ in range(2)]
    _kernels.reset_launch_counts()
    outs, ms = _timed(torch, lambda: infer_clips_batched(
        model, cfg, tok, raw, instruction=list(PROMPTS), max_new_tokens=16))
    used = counts("raw uint8 mode")
    for i, out in enumerate(outs):
        _check_output(out, CLIP_KEYS, len(frames), f"raw mode clip {i}")
    nf = cfg.num_frames
    packed = torch.from_numpy(np.stack([rgb_to_yuv420(frames[:nf])] * 2)
                              ).to("cuda")
    _kernels.reset_launch_counts()
    with torch.inference_mode():
        (emb, img), ms_yuv = _timed(torch, lambda: (
            model.encode_video(packed)[0], model.encode_grounding(packed)))
    yuv_used = {k: _kernels.KERNELS[k].launches for k in shown}
    for what, t in (("video tokens", emb), ("SAM embeddings", img)):
        if t.shape[0] != (2 if what == "video tokens" else 2 * nf) or \
                not bool(torch.isfinite(t).all()):
            raise PhaseError(f"YUV420 mode: {what} {tuple(t.shape)} or not "
                             "finite")
    say(3, f"raw uint8 mode (infer_clips_batched, one 640 x 360 stack per "
           f"clip for both towers, uploaded once and resized on the card, "
           f"16 new tokens): {ms:.1f} ms, launches {used}; packed YUV420 "
           f"mode (2 x {nf} frames (540, 640) uint8 -> encode_video + "
           f"encode_grounding): {ms_yuv:.1f} ms, video tokens "
           f"{tuple(emb.shape)}, SAM {tuple(img.shape)}, launches "
           f"{yuv_used} on {gpu}")


def _lm_forward_w8a8(torch, gpu, model, cfg, tok, clips):
    """`GroveModel.lm_forward` of the flagship, whose lm_head is W8A8
    (`torch._int_mm` at N = 32007, zero-padded by `ops.int8_matmul`), on
    the two center prompts (M = 2 x 634 rows) and on a 9-token prompt:
    finite logits, and each call's int32 product bit-equal to a float64
    product of the same int8 operands."""
    from grove_tpu_torch.infer.sliding import center_prompts
    from grove_tpu_torch.models.layers import quant_act
    from grove_tpu_torch.ops.int8_matmul import int8_matmul
    head = model.lm_head
    seen = []
    hook = head.register_forward_hook(lambda m, a, out: seen.append(a[0]))
    nf = cfg.num_frames
    fc = torch.from_numpy(np.stack([c["frames_clip"][:nf] for c in clips])
                          ).to("cuda")
    try:
        with torch.inference_mode():
            emb, _ = model.encode_video(fc)
            ids, starts, _ = center_prompts(cfg, tok, [None, None])
            ids_t = torch.from_numpy(ids).to("cuda")
            outs = [model.lm_forward(ids_t, emb, starts)[1],
                    model.lm_forward(ids_t[:1, :9], emb[:1], [-1])[1]]
    finally:
        hook.remove()
    notes = []
    for x, logits in zip(seen, outs):
        if not bool(torch.isfinite(logits).all()):
            raise PhaseError(f"lm_forward W8A8: non-finite logits "
                             f"{tuple(logits.shape)}")
        with torch.inference_mode():
            xq = quant_act(x)[0].reshape(-1, head.in_features).contiguous()
            acc = int8_matmul(xq, head.kernel_q)
            want = torch.matmul(xq.double(), head.kernel_q.double())
            diff = float((acc.double() - want).abs().max())
        if diff:
            raise PhaseError(f"lm_forward W8A8: lm_head's int8 GEMM at M = "
                             f"{xq.shape[0]} differs from float64 by {diff}")
        notes.append(f"M = {xq.shape[0]} -> logits {tuple(logits.shape)}")
        del acc, want
    say(3, "lm_forward with the W8A8 lm_head (N = "
           f"{head.out_features}): {', '.join(notes)}, finite, int8 GEMM "
           f"bit-equal to float64 on {gpu}")


def _same_tokens(gen, gen_bf16, label):
    same = int((gen == gen_bf16).sum())
    first = (int(np.argmax((gen != gen_bf16).any(0)))
             if same < gen.size else gen.shape[1])
    say(3, f"greedy tokens of the {label} replay equal to the bf16 "
           f"replay's: {same} of {gen.size} (identical prefix {first} "
           "steps; random weights, informational)")


# ---------------------------------------------------------------------------
# phase 4: fp32 parity kernels vs plain at GroveConfig.small()
# ---------------------------------------------------------------------------

def _tower_outputs(torch, model, clip, noise=0.0):
    """(video tokens, SAM embeddings) of one clip on the model's device,
    from normalized frames scaled by (1 + noise * N(0, 1))."""
    dev = model.device
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        out = []
        for key, encode in (("frames_clip", model.encode_video),
                            ("frames_sam", model.encode_grounding)):
            frames = torch.from_numpy(clip[key][None]).to(dev)
            x = (model._norm_clip(frames) if key == "frames_clip"
                 else model._norm_sam(frames))
            if noise:
                x = x * (1 + noise * torch.randn(x.shape, generator=gen)
                         .to(dev))
            y = encode(x)
            out.append((y[0] if isinstance(y, tuple) else y).float().cpu()
                       .numpy())
    return out


def _rel_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _quant_sites(model):
    """name -> module of every W8A8 quant site of the towers: each
    LayerNormQuant (K8a, K8b or the torch chain), Int8Linear and
    Int8Conv3d, and each SamAttention of a W8A8 tower (K1q, or K2 and a
    static quantize, then proj's int8 input)."""
    from grove_tpu_torch.models.layers import (Int8Conv3d, Int8Linear,
                                               LayerNormQuant)
    from grove_tpu_torch.models.sam_encoder import SamAttention
    from grove_tpu_torch.ops.quant import vision_towers
    kinds = (LayerNormQuant, Int8Linear, Int8Conv3d, SamAttention)
    return {f"{t}.{n}": m for t, tower in vision_towers(model).items()
            for n, m in tower.named_modules() if isinstance(m, kinds)}


def _record_sites(model):
    """Forward hooks that keep every call's (inputs, outputs) of each quant
    site; returns ({name: [(args, out)]}, hook handles)."""
    calls, handles = {}, []
    for name, mod in _quant_sites(model).items():
        def hook(mod, args, out, name=name):
            calls.setdefault(name, []).append((args, out))
        handles.append(mod.register_forward_hook(hook))
    return calls, handles


def _int8_out(torch, name, out, calls, i):
    """The int8 activation a site hands on: a norm's int8 output; for a
    SamAttention its proj's int8 input in the same (i-th) call."""
    if name + ".proj" in calls:
        return calls[name + ".proj"][i][0][0]
    return next(t for t in _tensors(out) if t.dtype == torch.int8)


def _site_parity(torch, cpu, gpu, clip, label):
    """Every quant site of the card's towers fed the CPU's input to that
    site, so no int8 flip of an earlier site reaches it: its int8 output
    at most 1 LSB off on at most LSB_SHARE of the elements (as phase 2
    holds K8a, K8b and K1q), its float outputs (a norm's residual sum, a
    linear's or conv's epilogue) within SITE_TOL of the CPU's max-abs."""
    from grove_tpu_torch.models.layers import LayerNormQuant
    from grove_tpu_torch.models.sam_encoder import SamAttention
    host, handles = _record_sites(cpu)
    try:
        _tower_outputs(torch, cpu, clip)
    finally:
        for h in handles:
            h.remove()
    sites = _quant_sites(gpu)
    card, handles = _record_sites(gpu)
    worst = {"int8": (0, 0.0), "float": 0.0}
    flipped = elems = 0
    try:
        with torch.inference_mode():
            for name, host_calls in host.items():
                mod = sites[name]
                for i, (args, want) in enumerate(host_calls):
                    got = mod(*(a.to(gpu.device)
                                if isinstance(a, torch.Tensor) else a
                                for a in args))
                    if isinstance(mod, (LayerNormQuant, SamAttention)):
                        g = _int8_out(torch, name, got, card,
                                      len(card.get(name + ".proj", [])) - 1)
                        c = _int8_out(torch, name, want, host, i)
                        d = (g.cpu().int() - c.int()).abs()
                        lsb, n = int(d.max()), int((d > 0).sum())
                        if not (lsb <= 1 and n <= LSB_SHARE * d.numel()):
                            raise PhaseError(
                                f"{label}: {name} fed the CPU's input: int8 "
                                f"{lsb} LSB apart on {n} of {d.numel()} "
                                f"(limit 1 LSB on {LSB_SHARE})")
                        worst["int8"] = max(worst["int8"],
                                            (lsb, n / d.numel()))
                        flipped, elems = flipped + n, elems + d.numel()
                    if isinstance(mod, SamAttention):
                        continue        # proj is a site of its own
                    for g, c in zip(_tensors(got), _tensors(want)):
                        if c.dtype == torch.int8 or c.dim() == 0:
                            continue    # the int8 output, the act scale
                        err = _rel_max(g.float().cpu().numpy(),
                                       c.float().numpy())
                        if not err <= SITE_TOL:
                            raise PhaseError(
                                f"{label}: {name} fed the CPU's input: "
                                f"output {err:.2e} of max-abs from the "
                                f"CPU's > {SITE_TOL}")
                        worst["float"] = max(worst["float"], err)
    finally:
        for h in handles:
            h.remove()
    lsb, share = worst["int8"]
    say(4, f"{label}, each of {len(host)} quant sites fed the CPU's input: "
           f"int8 activations (norms, K1q / K2 -> proj) at most {lsb} LSB "
           f"apart on at most {share:.2e} of a site's, {flipped} of "
           f"{elems} in all; float outputs within {worst['float']:.2e} of "
           "max-abs")


def _tensors(out):
    return out if isinstance(out, tuple) else (out,)


def _boxes_on(torch, model, clip, ap):
    """Teacher-forced boxes and objectness of one clip on the model's
    device, as numpy."""
    dev = model.device
    batch = {
        "frames_clip": torch.from_numpy(clip["frames_clip"][None]).to(dev),
        "frames_sam": torch.from_numpy(clip["frames_sam"][None]).to(dev),
        "input_ids": torch.from_numpy(ap.input_ids[None].astype(
            np.int64)).to(dev),
        "video_start": np.asarray([int(ap.video_start)]),
        "det_positions": torch.from_numpy(ap.det_positions[None].astype(
            np.int64)).to(dev)}
    with torch.inference_mode():
        out = model.forward_boxes(batch)
    return (out["pred_boxes"].float().cpu().numpy(),
            out["objectness_logits"].float().cpu().numpy())


def _boxes_parity(torch, clip, ap, cpu, gpu, label, tol):
    """Teacher-forced boxes and objectness card vs CPU within `tol`;
    returns the kernels the card's pass launched."""
    from grove_tpu_torch import _kernels
    before = {k: v.launches for k, v in _kernels.KERNELS.items()}
    (b_gpu, o_gpu) = _boxes_on(torch, gpu, clip, ap)
    used = [k for k, v in _kernels.KERNELS.items() if v.launches > before[k]]
    b_cpu, o_cpu = _boxes_on(torch, cpu, clip, ap)
    eb = float(np.abs(b_gpu - b_cpu).max())
    eo = float(np.abs(o_gpu - o_cpu).max())
    say(4, f"{label} teacher-forced: boxes max-abs diff {eb:.2e}, "
           f"objectness {eo:.2e} (card kernels {used} vs CPU plain)")
    if not (eb <= tol and eo <= tol):
        raise PhaseError(f"{label} teacher-forced parity {eb:.2e}/{eo:.2e} "
                         f"> {tol}")
    return used


def _parity_pass(torch, cfg, tok, clip, ap, cpu, gpu, label, cache_dtype):
    """Teacher-forced boxes and objectness card vs CPU (within 1e-3), then
    the greedy-token agreement; returns the CPU's greedy ids."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.infer.generate import generate_grounded
    from grove_tpu_torch.infer.sliding import center_prompts

    _boxes_parity(torch, clip, ap, cpu, gpu, label, PARITY_TOL)

    p_ids, starts, _ = center_prompts(cfg, tok, [None])
    gens = []
    before = {k: v.launches for k, v in _kernels.KERNELS.items()}
    for model in (gpu, cpu):
        dev = model.device
        g = generate_grounded(
            model, cfg, tok, p_ids, starts,
            torch.from_numpy(clip["frames_clip"][None]).to(dev),
            torch.from_numpy(clip["frames_sam"][None]).to(dev),
            max_new_tokens=64, early_exit=False, cache_dtype=cache_dtype)
        gens.append(g["generated_ids"][0])
    used = [k for k, v in _kernels.KERNELS.items() if v.launches > before[k]]
    agree = float(np.mean(gens[0] == gens[1]))
    first = int(np.argmax(gens[0] != gens[1])) if agree < 1 else 64
    say(4, f"{label} greedy tokens card vs CPU: {agree * 100:.1f}% of 64 "
           f"agree, identical prefix {first} (card kernels {used})")
    return p_ids, starts, gens[1]


def _int8_steps(torch, cfg, clip, model, p_ids, starts, tokens, noise=0.0):
    """Hidden states of the prefill's last row and of len(tokens) decode
    steps fed `tokens`, over an int8 cache; the video embeddings scaled by
    (1 + noise * N(0, 1))."""
    from grove_tpu_torch.models.llama import init_kv_caches
    dev = model.device
    ls = p_ids.shape[1]
    ids = torch.from_numpy(p_ids).to(dev)
    with torch.inference_mode():
        emb, _ = model.encode_video(
            torch.from_numpy(clip["frames_clip"][None]).to(dev))
        if noise:
            gen = torch.Generator().manual_seed(0)
            emb = emb * (1 + noise * torch.randn(emb.shape, generator=gen)
                         .to(dev))
        caches = init_kv_caches(cfg.llama, 1, ls + len(tokens),
                                dtype=torch.int8, device=dev)
        h, _, caches = model.prefill(ids, emb, starts, caches)
        out = [h[0, -1].float().cpu().numpy()]
        for i, t in enumerate(tokens):
            h, _, caches = model.decode_step(
                torch.tensor([[int(t)]], device=dev), ls + i, caches)
            out.append(h[0, 0].float().cpu().numpy())
    return out


def phase_parity(torch, decoder):
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.models.grove import init_grove_params
    from grove_tpu_torch.ops.quant import (calibrate_vision_, quantize_llama_,
                                           quantize_vision_)
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch.text.packing import pack_text
    from grove_tpu_torch.text.prompts import (grounding_prompt,
                                              tokenize_with_video)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # quant_ln_kernel: once the towers are W8A8, every norm site without a
    # residual branch takes K8a (the flag does nothing to float towers)
    cfg = GroveConfig.small()
    cfg = dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, quant_ln_kernel=True),
        sam_enc=dataclasses.replace(cfg.sam_enc, quant_ln_kernel=True))
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    float_cfg = cfg
    cpu = init_grove_params(cfg, device="cpu", dtype=torch.float32, seed=2)
    gpu = copy.deepcopy(cpu).to("cuda")
    clip = _synthetic_clips(cfg, 1, cfg.num_frames, seed=3)[0]

    ids = tokenize_with_video(grounding_prompt(
        answer=f"<p> {CAPTION} </p> [DET]"), tok)
    spliced = len(ids) - 1 + cfg.num_video_tokens
    ap = pack_text(ids, None, tok, num_video_tokens=cfg.num_video_tokens,
                   max_spliced_len=-(-spliced // 64) * 64,
                   det_token_id=cfg.tokens.det, max_phrases=cfg.max_phrases,
                   pad_id=tok.pad_token_id, with_labels=False)
    _kernels.reset_launch_counts()
    _parity_pass(torch, cfg, tok, clip, ap, cpu, gpu,
                 "GroveConfig.small() fp32", cpu.dtype)
    # K1's SIMT entry: the float towers' windowed blocks in fp32
    k1_fp32 = _kernels.KERNELS["sam_window_attention"].launches
    if not k1_fp32:
        raise PhaseError("GroveConfig.small() fp32: K1's SIMT entry never "
                         "launched")
    _det_branch_parity(torch, cfg, tok, cpu, gpu)
    _entry_parity(torch, cfg, tok, cpu, gpu, decoder)

    # the same weights with the LLM quantized to int4, on both devices
    quantize_llama_(cpu, 4)
    gpu = copy.deepcopy(cpu).to("cuda")
    cfg = cpu.cfg
    p_ids, starts, cpu_ids = _parity_pass(
        torch, cfg, tok, clip, ap, cpu, gpu,
        "GroveConfig.small() fp32, int4 LLM + int8 KV", torch.int8)
    before = {k: v.launches for k, v in _kernels.KERNELS.items()}
    card = _int8_steps(torch, cfg, clip, gpu, p_ids, starts, cpu_ids[:16])
    used = [k for k, v in _kernels.KERNELS.items() if v.launches > before[k]]
    host = _int8_steps(torch, cfg, clip, cpu, p_ids, starts, cpu_ids[:16])
    rels = [float(np.abs(g - c).max() / np.abs(c).max())
            for g, c in zip(card, host)]
    say(4, f"int4 + int8 KV, the CPU's greedy ids through prefill + 16 "
           f"decode steps: hidden-state max-abs diff of each step relative "
           f"to its max-abs, worst {max(rels):.2e}, last {rels[-1]:.2e} "
           f"(card kernels {used})")
    if not max(rels) <= STEP_TOL:
        raise PhaseError(f"int8-cache decode steps card vs CPU: "
                         f"{max(rels):.2e} > {STEP_TOL} of max-abs")

    # the towers W8A8-static, calibrated once on the CPU
    quantize_vision_(cpu)
    calibrate_vision_(cpu, clip["frames_clip"][None], clip["frames_sam"][None])
    gpu = copy.deepcopy(cpu).to("cuda")
    _check_off_path("GroveConfig.small() fp32, float and int4 LLM")
    label = "GroveConfig.small() fp32, W8A8-static towers (quant_ln_kernel)"
    _kernels.reset_launch_counts()
    _boxes_parity(torch, clip, ap, cpu, gpu, label, W8A8_TOL)
    outs = [_tower_outputs(torch, gpu, clip)]
    launches = {k: v.launches for k, v in _kernels.KERNELS.items()}
    missing = [k for k in (LN_KERNEL, "add_layernorm_quant", *FP32_SIMT)
               if launches[k] <= 0]
    if missing:
        raise PhaseError(f"{label}: kernels never launched: {missing}")
    outs.append(_tower_outputs(torch, cpu, clip))
    # the CPU's own spread: the same towers on inputs moved by 1e-6
    outs.append(_tower_outputs(torch, cpu, clip, noise=1e-6))
    names = ("video tokens", "SAM embeddings")
    for n, g, c in zip(names, outs[0], outs[1]):
        if g.shape != c.shape or not np.all(np.isfinite(g)):
            raise PhaseError(f"{label}: {n} {g.shape} on the card, "
                             f"{c.shape} on the CPU, or not finite")
    # information only: one int8 LSB that flips at a site moves its output
    # by 1/127 of the site's range and the flips cascade through the
    # blocks, so whole towers differ as much as float noise moves them;
    # _site_parity holds each quant site on its own
    say(4, f"{label}: whole towers card vs CPU relative to max-abs: "
           + ", ".join(f"{n} {_rel_max(g, c):.2e}"
                       for n, g, c in zip(names, outs[0], outs[1]))
           + "; the CPU against itself on inputs moved by 1e-6: "
           + ", ".join(f"{n} {_rel_max(g, c):.2e}"
                       for n, g, c in zip(names, outs[2], outs[1]))
           + f" (informational); kernel launches {launches}")
    _site_parity(torch, cpu, gpu, clip, label)
    _check_off_path(label)
    del cpu, gpu
    _w4a8_parity(torch, float_cfg, tok, clip, ap)
    _check_off_path("GroveConfig.small() fp32, W4A8 LLM")
    launches["sam_window_attention"] = k1_fp32
    return launches


def _det_branch_parity(torch, cfg, tok, cpu, gpu):
    """The [DET] branch (`_det_branch`) on a 24-frame clip at
    GroveConfig.small() fp32, card vs CPU, every box kept (threshold 0):
    boxes, normalized by the frame size, and objectness probabilities
    within PARITY_TOL."""
    clip = _synthetic_clips(cfg, 1, 24, seed=4)[0]
    w, h = clip["original_size"]
    outs = [_det_branch(torch, m, cfg, tok, clip, 0.0) for m in (gpu, cpu)]
    norm = np.array([w, h, w, h], np.float32)
    eb = max(float(np.abs((g - c) / norm).max())
             for g, c in zip(outs[0]["bboxes"], outs[1]["bboxes"]))
    ep = max(float(np.abs(g - c).max()) for g, c in
             zip(outs[0]["probs_temp_objectness"],
                 outs[1]["probs_temp_objectness"]))
    say(4, f"GroveConfig.small() fp32 [DET] branch (`_finish_clip`, 2 "
           f"phrases, 24 frames): boxes card vs CPU within {eb:.2e} of the "
           f"frame size, objectness probabilities within {ep:.2e}")
    if not (eb <= PARITY_TOL and ep <= PARITY_TOL):
        raise PhaseError(f"[DET] branch card vs CPU {eb:.2e}/{ep:.2e} > "
                         f"{PARITY_TOL}")


@contextlib.contextmanager
def _recorded_ids():
    """Record the greedy ids of every `generate_grounded` call that
    `infer.sliding` makes (the output dict carries only the text)."""
    from grove_tpu_torch.infer import sliding
    seen, inner = [], sliding.generate_grounded

    def record(*a, **kw):
        out = inner(*a, **kw)
        seen.append(out["generated_ids"])
        return out
    sliding.generate_grounded = record
    try:
        yield seen
    finally:
        sliding.generate_grounded = inner


def _entry_parity(torch, cfg, tok, cpu, gpu, decoder):
    """The main path's entry at GroveConfig.small() fp32, card vs CPU:
    `GroveProcessor.generate` on one 16-frame 640 x 360 clip (identical
    greedy ids and text); the same decoded, preprocessed clip through the
    [DET] branch (`_det_branch`: random weights emit no [DET], so a caption
    tagged at two phrases stands in for the generated one), boxes over the
    frame size and objectness probabilities within PARITY_TOL, and it
    fails if no box was compared; then the raw and YUV420 normalizers
    on 640 x 360 frames: the card's resize within RESIZE_TOL levels of the
    CPU's before rounding, the normalized values at most 1 level apart on
    at most FLIP_SHARE of them."""
    from grove_tpu_torch.api import GroveProcessor
    from grove_tpu_torch.data.preprocess import (CLIP_MEAN, CLIP_STD,
                                                 SAM_MEAN, SAM_STD,
                                                 rgb_to_yuv420)
    from grove_tpu_torch.models.grove import _resize_frames
    with tempfile.TemporaryDirectory() as tmp:
        (path,), factory = _clip_sources(decoder, tmp, (30,), frames=16)
        proc = GroveProcessor(tok, cfg, decoder_factory=factory)
        outs, ids = [], []
        for model in (gpu, cpu):
            with _recorded_ids() as seen:
                outs.append(proc.generate(model, path, max_new_tokens=16,
                                          temp_objectness_threshold=0.0))
            ids.append(seen[0])
        sample = proc._sample(path)        # generate's decode + preprocess
    if not np.array_equal(ids[0], ids[1]):
        raise PhaseError(f"GroveProcessor.generate card vs CPU: greedy ids "
                         f"{ids[0].tolist()} != {ids[1].tolist()}")
    dets = [_det_branch(torch, m, cfg, tok, sample, 0.0) for m in (gpu, cpu)]
    w, h = outs[1]["original_size"]
    norm = np.array([w, h, w, h], np.float32)
    compared = {"bboxes": 0, "probs_temp_objectness": 0}

    def worst(field, scale=1.0):
        pairs = [p for pair in (outs, dets)
                 for p in zip(pair[0][field], pair[1][field])]
        if any(np.shape(g) != np.shape(c) for g, c in pairs):
            raise PhaseError(f"GroveProcessor.generate card vs CPU: {field} "
                             "of other shapes")
        compared[field] = sum(int(np.size(c)) for _, c in pairs)
        return max([float(np.abs((g - c) / scale).max())
                    for g, c in pairs if np.size(c)] or [0.0])
    eb, ep = worst("bboxes", norm), worst("probs_temp_objectness")
    if not all(compared.values()):
        raise PhaseError(f"GroveProcessor.generate card vs CPU: nothing "
                         f"compared ({compared})")
    if not (eb <= PARITY_TOL and ep <= PARITY_TOL
            and outs[0]["text"] == outs[1]["text"]):
        raise PhaseError(f"GroveProcessor.generate card vs CPU: boxes "
                         f"{eb:.2e}, objectness {ep:.2e} (limit "
                         f"{PARITY_TOL}), texts {outs[0]['text']!r} / "
                         f"{outs[1]['text']!r}")

    rng = np.random.default_rng(31)
    rgb = rng.integers(0, 256, (1, 2, 360, 640, 3), dtype=np.uint8)
    yuv = rgb_to_yuv420(rgb[0])[None]
    notes = []
    for size, method in ((cfg.clip.image_size, "bicubic"),
                         (cfg.sam_enc.img_size, "bilinear")):
        scale = size / (360 if method == "bicubic" else 640)
        out_hw = (round(360 * scale), round(640 * scale))
        got = _resize_frames(torch.from_numpy(rgb).cuda(), out_hw, method)
        want = _resize_frames(torch.from_numpy(rgb), out_hw, method)
        err = float((got.cpu() - want).abs().max())
        if not err <= RESIZE_TOL:
            raise PhaseError(f"{method} resize to {out_hw} card vs CPU: "
                             f"{err:.3e} levels > {RESIZE_TOL}")
        notes.append(f"{method} resize to {out_hw} within {err:.2e} levels")
    for name, frames in (("raw", rgb), ("YUV420", yuv)):
        for method, mean, std in (("_norm_clip", CLIP_MEAN * 255,
                                   CLIP_STD * 255),
                                  ("_norm_sam", SAM_MEAN, SAM_STD)):
            levels = []
            with torch.inference_mode():
                for model in (gpu, cpu):
                    x = getattr(model, method)(
                        torch.from_numpy(frames).to(model.device))
                    levels.append(np.round(x.float().cpu().numpy() * std
                                           + mean))
            diff = np.abs(levels[0] - levels[1])
            share = float((diff > 0).mean())
            if not (diff.max() <= 1 and share <= FLIP_SHARE):
                raise PhaseError(f"{name} {method} card vs CPU: {diff.max()} "
                                 f"levels apart on {share:.2e} of the values")
            notes.append(f"{name} {method} {int(diff.max())} level apart on "
                         f"{share:.2e}")
    say(4, f"GroveConfig.small() fp32 GroveProcessor.generate (decoder: "
           f"{decoder}, 16 frames of 640 x 360): greedy ids identical card "
           f"vs CPU ({ids[0].shape[1]} steps); with the [DET] branch on its "
           f"decoded clip ({compared['bboxes'] // 4} boxes, "
           f"{compared['probs_temp_objectness']} objectness probabilities "
           f"compared) boxes within {eb:.2e} of the frame size, objectness "
           f"probabilities within {ep:.2e}; "
           f"normalizers on 640 x 360 frames card vs CPU: {'; '.join(notes)}")


@contextlib.contextmanager
def _card_branches_on_cpu():
    """CPU tensors take the card's branches too (`models.layers._on_card`,
    the port's one seam for them), so that the CPU computes the function
    the card does, with the kernels' plain twins."""
    from grove_tpu_torch.models import layers
    on_card = layers._on_card
    layers._on_card = lambda x: True
    try:
        yield
    finally:
        layers._on_card = on_card


def _hidden_on(torch, model, clip, p_ids, starts):
    """The LLaMA's hidden states of the prompt, teacher-forced, as numpy."""
    dev = model.device
    with torch.inference_mode():
        emb, _ = model.encode_video(
            torch.from_numpy(clip["frames_clip"][None]).to(dev))
        h = model._lm_hidden(torch.from_numpy(p_ids).to(dev), emb, starts)
    return h.float().cpu().numpy()


def _llm_sites(model):
    """name -> module of every W4A8 quant site of a GroveModel's LLaMA: each
    RMSNorm (K8c when called with quant_dyn) and each Int4Linear (K7b, or
    K7c and the int8 GEMM)."""
    from grove_tpu_torch.models.layers import Int4Linear, RMSNorm
    return {n: m for n, m in model.model.layers.named_modules()
            if isinstance(m, (Int4Linear, RMSNorm))}


def _llm_site_parity(torch, cfg, clip, cpu, gpu, p_ids, starts, tokens,
                     label):
    """Every W4A8 quant site of the card's LLaMA fed the CPU's input to
    that site in the CPU's prefill and decode steps over `tokens` (the CPU
    in the card's branches), so no int8 flip of an earlier site reaches
    it: a K8c norm's int8 output at most 1 LSB off on at most LSB_SHARE of
    it, its scales within SX_REL, its residual sum bit-equal; an Int4Linear's
    output within SITE_TOL of the CPU's max-abs."""
    from grove_tpu_torch.models.layers import RMSNorm
    calls, handles = {}, []
    for name, mod in _llm_sites(cpu).items():
        def hook(mod, args, kwargs, out, name=name):
            if not isinstance(mod, RMSNorm) or kwargs.get("quant_dyn"):
                calls.setdefault(name, []).append((args, kwargs, out))
        handles.append(mod.register_forward_hook(hook, with_kwargs=True))
    try:
        _int8_steps(torch, cfg, clip, cpu, p_ids, starts, tokens)
    finally:
        for h in handles:
            h.remove()
    sites = _llm_sites(gpu)
    worst = {"lsb": (0, 0.0), "sx": 0.0, "float": 0.0}
    flipped = elems = n = 0
    with torch.inference_mode():
        for name, recs in calls.items():
            for args, kwargs, want in recs:
                n += 1
                got = sites[name](*(a.to("cuda") if isinstance(
                    a, torch.Tensor) else a for a in args), **kwargs)
                if isinstance(want, tuple):           # K8c: resid, q8, sx
                    if _max_err(got[0].cpu(), want[0]) != 0:
                        raise PhaseError(f"{label}: {name} resid differs")
                    d = (got[1].cpu().int() - want[1].int()).abs()
                    lsb, k = int(d.max()), int((d > 0).sum())
                    sx = float(((got[2].cpu() - want[2]).abs()
                                / want[2].abs()).max())
                    if not (lsb <= 1 and k <= LSB_SHARE * d.numel()
                            and sx <= SX_REL):
                        raise PhaseError(
                            f"{label}: {name} fed the CPU's input: int8 "
                            f"{lsb} LSB apart on {k} of {d.numel()}, scales "
                            f"{sx:.2e} relative")
                    worst["lsb"] = max(worst["lsb"], (lsb, k / d.numel()))
                    worst["sx"] = max(worst["sx"], sx)
                    flipped, elems = flipped + k, elems + d.numel()
                    continue
                err = _rel_max(got.float().cpu().numpy(),
                               want.float().numpy())
                if not err <= SITE_TOL:
                    raise PhaseError(f"{label}: {name} fed the CPU's input: "
                                     f"output {err:.2e} of max-abs from the "
                                     f"CPU's > {SITE_TOL}")
                worst["float"] = max(worst["float"], err)
    lsb, share = worst["lsb"]
    say(4, f"{label}, each of {len(calls)} quant sites fed the CPU's input "
           f"({n} calls: prefill and {len(tokens)} decode steps): K8c int8 "
           f"at most {lsb} LSB apart on at most {share:.2e} of a call's, "
           f"{flipped} of {elems} in all, scales within {worst['sx']:.2e} "
           f"relative, resid bit-equal; Int4Linear outputs (K7b, K7c + the "
           f"int8 GEMM) within {worst['float']:.2e} of max-abs")


def _w4a8_parity(torch, cfg, tok, clip, ap):
    """The small model's LLM W4A8 (`quantize_llama_(..., act_quant=True)`,
    float towers) on the card and on the CPU in the card's branches:
    teacher-forced boxes within W4A8_TOL; every quant site fed the CPU's
    input (`_llm_site_parity`); K7b, K7c and K8c launched and K7a not. The
    CPU's greedy ids through prefill and 16 int8-cache decode steps are
    printed beside the CPU's own spread under 1e-6 input noise, for
    information: per-token int8 flips cascade through the layers as in the
    W8A8 towers. Then `fuse()` on the card: the prompt's hidden states
    within FUSE_TOL of the unfused model's (the int8-view path sums
    exactly in int32), the hidden states of 16 int8-cache decode steps
    (K7b at the fused widths) bit-equal to the unfused model's, since
    K7b splits K by K and G alone, and the two models' 64 greedy tokens
    equal."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.infer.generate import generate_grounded
    from grove_tpu_torch.infer.sliding import center_prompts
    from grove_tpu_torch.models.fuse import fuse_llama_
    from grove_tpu_torch.models.grove import init_grove_params
    from grove_tpu_torch.ops.quant import quantize_llama_
    cpu = init_grove_params(cfg, device="cpu", dtype=torch.float32, seed=2)
    quantize_llama_(cpu, 4, act_quant=True)
    gpu = copy.deepcopy(cpu).to("cuda")
    cfg = cpu.cfg
    label = "GroveConfig.small() fp32, W4A8 LLM + int8 KV"
    p_ids, starts, _ = center_prompts(cfg, tok, [None])
    _kernels.reset_launch_counts()
    with _card_branches_on_cpu():
        _boxes_parity(torch, clip, ap, cpu, gpu, label, W4A8_TOL)
        g = generate_grounded(
            cpu, cfg, tok, p_ids, starts,
            torch.from_numpy(clip["frames_clip"][None]),
            torch.from_numpy(clip["frames_sam"][None]), max_new_tokens=64,
            early_exit=False, cache_dtype=torch.int8)
        ids = g["generated_ids"][0][:16]
        card = _int8_steps(torch, cfg, clip, gpu, p_ids, starts, ids)
        host = _int8_steps(torch, cfg, clip, cpu, p_ids, starts, ids)
        noisy = _int8_steps(torch, cfg, clip, cpu, p_ids, starts, ids,
                            noise=1e-6)
        launches = {k: v.launches for k, v in _kernels.KERNELS.items()}
        _llm_site_parity(torch, cfg, clip, cpu, gpu, p_ids, starts, ids[:2],
                         label)
    missing = [k for k in FLAGSHIP_KERNELS if launches[k] <= 0]
    if missing or launches["int4_matmul"]:
        raise PhaseError(f"{label}: kernels never launched {missing}, or "
                         f"K7a launched {launches['int4_matmul']} times")
    rels = [_rel_max(g, c) for g, c in zip(card, host)]
    spread = [_rel_max(g, c) for g, c in zip(noisy, host)]
    say(4, f"{label}, the CPU's greedy ids through prefill + 16 decode "
           f"steps: hidden states card vs CPU relative to max-abs, worst "
           f"{max(rels):.2e}, last {rels[-1]:.2e}; the CPU against itself "
           f"on video embeddings moved by 1e-6: worst {max(spread):.2e}, "
           f"last {spread[-1]:.2e} (informational); card kernel launches "
           f"{launches}")
    del cpu
    fused = copy.deepcopy(gpu)
    fuse_llama_(fused)
    h_unfused = _hidden_on(torch, gpu, clip, p_ids, starts)
    h_fused = _hidden_on(torch, fused, clip, p_ids, starts)
    err = _rel_max(h_fused, h_unfused)
    steps = [_int8_steps(torch, cfg, clip, model, p_ids, starts, ids)
             for model in (gpu, fused)]
    same = sum(bool(np.array_equal(a, b)) for a, b in zip(*steps))
    gens = []
    for model in (gpu, fused):
        g = generate_grounded(
            model, cfg, tok, p_ids, starts,
            torch.from_numpy(clip["frames_clip"][None]).to("cuda"),
            torch.from_numpy(clip["frames_sam"][None]).to("cuda"),
            max_new_tokens=64, early_exit=False, cache_dtype=torch.int8)
        gens.append(g["generated_ids"][0])
    agree = int(np.sum(gens[0] == gens[1]))
    say(4, f"{label}, fuse() on the card: prompt hidden states fused vs "
           f"unfused {err:.2e} of max-abs; prefill + {len(ids)} int8-cache "
           f"decode steps: {same} of {len(steps[0])} hidden states "
           f"bit-equal; greedy tokens fused vs unfused: {agree} of "
           f"{len(gens[0])} agree")
    if not err <= FUSE_TOL:
        raise PhaseError(f"{label}: fused vs unfused {err:.2e} > "
                         f"{FUSE_TOL} of max-abs")
    if same != len(steps[0]) or agree != len(gens[0]):
        raise PhaseError(f"{label}: fused vs unfused decode differs ({same}"
                         f" of {len(steps[0])} steps bit-equal, {agree} of "
                         f"{len(gens[0])} tokens)")


# ---------------------------------------------------------------------------
# phases 5 and 6: the training step
# ---------------------------------------------------------------------------

def _train_batch(cfg, tok, seed, n=1):
    """One `data.collate.build_batch` batch of `n` rows: each a synthetic
    clip of cfg.num_frames uint8 frames, TRAIN_CAPTION with its three
    phrases, and random boxes (cxcywh) and objectness for every phrase
    slot."""
    from grove_tpu_torch.data.collate import build_batch
    rng = np.random.default_rng(seed)
    t, p = cfg.num_frames, cfg.max_phrases
    c, s = cfg.clip.image_size, cfg.sam_enc.img_size
    samples = [{
        "frames_clip": rng.integers(0, 256, (t, c, c, 3), np.uint8),
        "frames_sam": rng.integers(0, 256, (t, s, s, 3), np.uint8),
        "caption": TRAIN_CAPTION, "tokens_positive": TRAIN_SPANS,
        "gt_boxes": rng.uniform(0.2, 0.6, (t, p, 4)).astype(np.float32),
        "gt_objectness": (rng.uniform(size=(t, p)) < 0.7).astype(
            np.float32)} for _ in range(n)]
    batch, _ = build_batch(samples, tok, cfg, rng)
    phrases = int(batch["phrase_mask"].sum()) // n
    if phrases != len(TRAIN_SPANS):
        raise PhaseError(f"build_batch kept {phrases} of the caption's "
                         f"{len(TRAIN_SPANS)} [DET] tokens in "
                         f"{cfg.max_seq_len} text tokens")
    return batch


def _train_setup(torch, model, warmup_steps):
    """The default freeze policy on `model` and a train step over it;
    returns (trainable parameters by name, step)."""
    from grove_tpu_torch.train.step import (OptimizerConfig, make_optimizer,
                                            make_train_step,
                                            partition_params, trainable_mask)
    oc = OptimizerConfig(warmup_steps=warmup_steps)
    params = partition_params(model, trainable_mask(model, oc))
    return params, make_train_step(model, make_optimizer(params, oc))


def _check_losses(out, label):
    losses = {k: float(v) for k, v in out.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise PhaseError(f"{label}: non-finite loss terms {losses}")
    return losses


def _groups(params, groups=None):
    """TRAIN_GROUPS (or `groups`) -> the trainable (name, parameter) pairs
    of each."""
    out = {}
    for group, rx in (groups or TRAIN_GROUPS).items():
        out[group] = [(n, p) for n, p in params.items() if re.search(rx, n)]
        if not out[group]:
            raise PhaseError(f"no trainable parameter in the group {group}")
    return out


def _check_grads(torch, params, groups=None):
    """Every trainable group (TRAIN_GROUPS, or `groups`) holds a finite
    gradient that is not all zero (tensors the path does not use, as the
    mask decoder's mask heads, get none); returns each group's gradient
    norm."""
    norms = {}
    for group, pairs in _groups(params, groups).items():
        grads = [p.grad for _, p in pairs if p.grad is not None]
        sq = sum(float(g.float().pow(2).sum()) for g in grads)
        if not grads or not np.isfinite(sq) or sq == 0.0:
            raise PhaseError(f"{group}: gradient missing, zero or not "
                             f"finite (norm^2 {sq})")
        norms[group] = sq ** 0.5
    return norms


def _changed(torch, model, snap):
    """Names of the parameters that differ from the host snapshot."""
    return [n for n, p in model.named_parameters()
            if not torch.equal(p.detach(), snap[n].to(p.device))]


def phase_train(torch, gpu):
    """Three steps of `train.step.make_train_step` on a fresh bf16
    `GroveConfig()` at S = 704, then one at the default S = 2111."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.models.grove import init_grove_params
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch.train.step import batch_to_device

    base = GroveConfig()
    cfg = dataclasses.replace(base, max_seq_len=TRAIN_SEQ)
    t0 = time.perf_counter()
    model = init_grove_params(cfg, device="cuda", dtype=torch.bfloat16,
                              seed=5)
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    batch = _train_batch(cfg, tok, seed=6)
    seq = batch["input_ids"].shape[1]
    params, step = _train_setup(torch, model, warmup_steps=1)
    n_train = sum(p.numel() for p in params.values())
    snap = {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}
    say(5, f"bf16 GroveConfig(max_seq_len={TRAIN_SEQ}) built in "
           f"{time.perf_counter() - t0:.1f} s: {len(params)} trainable "
           f"tensors, {n_train} trainable parameters of "
           f"{sum(p.numel() for p in model.parameters())}; batch of 1 clip "
           f"x {cfg.num_frames} frames, {seq} tokens, "
           f"{len(TRAIN_SPANS)} phrases")
    if seq != 704:
        raise PhaseError(f"the training batch has {seq} tokens, not 704")

    b = batch_to_device(batch, "cuda")
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], None
    for i in range(3):
        _kernels.reset_launch_counts()
        out, ms = _timed(torch, lambda: step(b))
        launches = {k: _kernels.KERNELS[k].launches for k in TRAIN_LAUNCHES}
        losses = _check_losses(out, f"step {i + 1}")
        times.append(ms)
        say(5, f"step {i + 1}: {ms:.1f} ms, losses "
               + ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
               + f", launches {launches} on {gpu}")
        if launches != TRAIN_LAUNCHES:
            raise PhaseError(f"step {i + 1} launched {launches}, not "
                             f"{TRAIN_LAUNCHES}")
        _check_launches(f"step {i + 1}", _step_launches(cfg, seq, False))
        if i == 0:
            changed = _changed(torch, model, snap)
            if changed:
                raise PhaseError(f"step 1 (lr(0) = 0) changed "
                                 f"{len(changed)} parameters: {changed[:4]}")
            norms = _check_grads(torch, params)
            say(5, "step 1 left every parameter bit-equal; gradient norm by "
                   "trainable group: " + ", ".join(
                       f"{k} {v:.3e}" for k, v in norms.items()))
    peak = torch.cuda.max_memory_allocated()
    PHASE5_STEP.update(ms=statistics.median(times[1:]), peak=peak)
    changed = set(_changed(torch, model, snap))
    frozen = [n for n, p in model.named_parameters()
              if not p.requires_grad and n in changed]
    if frozen:
        raise PhaseError(f"steps 2-3 changed {len(frozen)} frozen "
                         f"parameters: {frozen[:4]}")
    still = [g for g, pairs in _groups(params).items()
             if not any(n in changed for n, _ in pairs)]
    if still:
        raise PhaseError(f"trainable groups unchanged after 3 steps: {still}")
    say(5, f"after 3 steps the frozen parameters are bit-equal and every "
           f"trainable group moved ({len(changed)} of {len(params)} "
           "trainable tensors differ: a bf16 weight drops an update below "
           "half its ULP); median step (steps 2-3) "
           f"{statistics.median(times[1:]):.1f} ms (with K1 and K9's "
           f"forward on their SIMT bodies "
           f"{SIMT_K1_STEP_MS['bf16 S = 704']} ms on an H100 80GB HBM3 at "
           f"700 W), peak device memory {peak / 2**30:.2f} GiB, {n_train} "
           f"trainable parameters on {gpu}")

    # the driver's default length: 1536 + 575 = 2111 tokens, a ragged S,
    # so each layer runs K10 forward (its tensor-core entry, bf16 at
    # D = 128) with the torch-ops recompute backward
    batch = batch_to_device(_train_batch(base, tok, seed=6), "cuda")
    _kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out, ms = _timed(torch, lambda: step(batch))
    used = {k: v.launches for k, v in _kernels.KERNELS.items() if v.launches}
    losses = _check_losses(out, "S = 2111 step")
    seq = batch["input_ids"].shape[1]
    say(5, f"S = {seq} step: {ms:.1f} ms, peak "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the K5 "
           f"route took {K5_ROUTE_S2111[0]} ms, {K5_ROUTE_S2111[1]} GiB, "
           f"K10 on its SIMT body {SIMT_S2111_MS} ms, K1 and K9's forward "
           f"on theirs {SIMT_K1_STEP_MS['bf16 S = 2111']} ms, on an H100 "
           "80GB HBM3 at 700 W), losses "
           + ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
           + f", launches {used} on {gpu}")
    _check_launches(f"S = {seq} step", _step_launches(base, seq, False))
    launches["flash_attention_tc"] = _kernels.KERNELS[
        "flash_attention_tc"].launches
    del model, step, params, snap, b, batch, out
    torch.cuda.empty_cache()
    phase_qlora(torch, gpu)
    return launches


def _step_launches(cfg, s, remat):
    """The exact launches of one bf16 training step of `cfg` at S tokens
    (the default freeze policy, or the QLoRA recipe's, which trains the
    same SAM adapters): the LLaMA layers' attention as the JAX package
    routes it, stated here and not read from the port: at S = 704, a
    multiple of 64, K4's tensor-core entry (bf16, D = 128) with K4b behind
    it (the tensor-core entries of its dq and dkv); at the ragged
    S = 2111, K10's tensor-core entry; once a layer forward (twice with
    remat: the checkpointed layer runs again in the backward); K2's
    tensor-core entry (D = 80) once in each global SAM block's forward and
    K1's in each windowed one, each with remat again in the blocks after
    the first trainable adapter; K9's three tensor-core entries once in the
    backward of every SAM block after that adapter (K9's forward with LSE
    runs there, after the recomputed K1 or K2 forward); no SIMT entry of
    K1, K1q, K2, K3, K4, K4b, K9 or K10, no K1q, K5, K7a, K7b or K7c, and
    none of OFF_PATH_KERNELS."""
    n = cfg.llama.num_layers
    route = {704: "flash_forward_lse_tc", 2111: "flash_attention_tc"}[s]
    sam_cfg = cfg.sam_enc
    globs = sam_cfg.global_attn_indexes
    after = range(min(globs) + 1, sam_cfg.depth)   # behind the first adapter
    out = {k: 0 for k in ("flash_forward_lse_tc", "flash_backward_dq_tc",
                          "flash_backward_dkv_tc", "flash_attention_tc",
                          "sam_window_attention_q8_tc", *SIMT_ENTRIES,
                          *QLORA_NEVER, *OFF_PATH_KERNELS)}
    out.update({k: len(after) for k in ("relpos_flash_fwd_lse_tc",
                                        "relpos_flash_dq_tc",
                                        "relpos_flash_dkv_tc")})
    out["sam_global_attention_tc"] = len(globs) + (
        sum(i in globs for i in after) if remat else 0)
    out["sam_window_attention_tc"] = sam_cfg.depth - len(globs) + (
        sum(i not in globs for i in after) if remat else 0)
    out[route] = n * (2 if remat else 1)
    if route == "flash_forward_lse_tc":
        out["flash_backward_dq_tc"] = out["flash_backward_dkv_tc"] = n
    return out


def _check_off_path(label):
    """Raise if a kernel of OFF_PATH_KERNELS was launched since the counts
    were last set to 0."""
    from grove_tpu_torch import _kernels
    off = {k: _kernels.KERNELS[k].launches for k in OFF_PATH_KERNELS
           if _kernels.KERNELS[k].launches}
    if off:
        raise PhaseError(f"{label}: kernels of no model path launched: "
                         f"{off}")


def _check_launches(label, want):
    from grove_tpu_torch import _kernels
    got = {k: _kernels.KERNELS[k].launches for k in want}
    if got != want:
        raise PhaseError(f"{label} launched {got}, not {want}")


def _qlora_step(torch, model, params, optimizer, generator):
    """The QLoRA step as `benchmarks/train_finetune_scale.py:200-211`
    composes it: forward_train, backward, the bf16-moment AdamW's updates,
    applied with stochastic rounding (`train.lowmem.apply_updates_sr`)."""
    from grove_tpu_torch.train.lowmem import apply_updates_sr

    def step(batch):
        optimizer.zero_grad()
        out = model.forward_train(batch)
        out["loss"].backward()
        apply_updates_sr(params, optimizer.update(), generator)
        return {k: v.detach() for k, v in out.items()}
    return step


def _qlora_model(torch, cfg, device, dtype, seed):
    """A fresh `cfg` with LoRA on q/v at QLORA_R, built from `seed` with
    remat and quantized to int4 in place (`GroveForCausalLM.quantize(
    bits=4)`); returns (its config, the model)."""
    from grove_tpu_torch.api import GroveForCausalLM
    from grove_tpu_torch.models.grove import init_grove_params
    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, lora_r=QLORA_R))
    model = init_grove_params(cfg, device=device, dtype=dtype, seed=seed,
                              remat=True)
    lm = GroveForCausalLM(cfg, model).quantize(bits=4)
    return lm.cfg, lm.model


def _qlora_setup(torch, model, warmup_steps, generator):
    """The recipe's trainable set and optimizer (bf16 moments) on `model`;
    returns (trainable parameters by name, optimizer, step)."""
    from grove_tpu_torch.train.step import (OptimizerConfig, make_optimizer,
                                            partition_params, trainable_mask)
    oc = OptimizerConfig(moment_dtype="bf16", warmup_steps=warmup_steps)
    params = partition_params(model, trainable_mask(model, oc))
    opt = make_optimizer(params, oc)
    return params, opt, _qlora_step(torch, model, params, opt, generator)


def _frozen_state(model):
    """Host copies of every frozen tensor: the parameters that do not
    train and the quantized modules' buffers (the int4 bytes and scales,
    lm_head's int8)."""
    out = {n: p.detach().to("cpu", copy=True)
           for n, p in model.named_parameters() if not p.requires_grad}
    out.update({n: b.to("cpu", copy=True) for n, b in model.named_buffers()
                if n.rsplit(".", 1)[-1] in ("kernel_q4p", "kernel_q",
                                            "scale")})
    return out


def phase_qlora(torch, gpu):
    """The QLoRA recipe of `benchmarks/train_finetune_scale.py` at full
    width: GroveConfig() with LoRA r = 8 on q/v, remat, the LLM quantized
    to int4 (frozen, its views recomputed in the backward), bf16 moments,
    stochastic rounding with a seeded generator; two steps at S = 704 and
    one at S = 2111, each with exact launch counts. Checks: QLORA_TRAINABLE
    trainable parameters; step 1 (lr(0) = 0) leaves every parameter
    bit-equal, gives lora_B a nonzero gradient and lora_A a zero one (lora_B
    starts at zero) and every trainable group a gradient; after step 2
    every group moved; after step 3 lora_A moved too, and every frozen
    tensor, the int4 bytes and scales included, is bit-equal."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch.train.step import batch_to_device
    t0 = time.perf_counter()
    cfg, model = _qlora_model(torch, GroveConfig(), "cuda", torch.bfloat16,
                              seed=9)
    gen = torch.Generator(device="cuda").manual_seed(10)
    params, opt, step = _qlora_setup(torch, model, 1, gen)
    n_train = sum(p.numel() for p in params.values())
    n_layers = cfg.llama.num_layers
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    frozen = _frozen_state(model)
    snap = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    say(5, f"QLoRA GroveConfig(lora_r={QLORA_R}), remat, quantize(bits=4) "
           f"built in {time.perf_counter() - t0:.1f} s: weights "
           f"{_model_bytes(model) / 2**30:.2f} GiB, {len(params)} trainable "
           f"tensors, {n_train} trainable parameters on {gpu}")
    if n_train != QLORA_TRAINABLE:
        raise PhaseError(f"QLoRA: {n_train} trainable parameters, not "
                         f"{QLORA_TRAINABLE}")
    groups = {g: rx for g, rx in TRAIN_GROUPS.items() if g != "lm_head"}
    groups["LoRA"] = r"_lora\."
    short = dataclasses.replace(cfg, max_seq_len=TRAIN_SEQ)
    runs = [(short, seed) for seed in (11, 12)] + [(cfg, 13)]
    times = {}
    for i, (c, seed) in enumerate(runs):
        batch = batch_to_device(_train_batch(c, tok, seed=seed), "cuda")
        seq = batch["input_ids"].shape[1]
        if i != 1:
            torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        out, ms = _timed(torch, lambda: step(batch))
        losses = _check_losses(out, f"QLoRA step {i + 1}")
        times.setdefault(seq, []).append(ms)
        used = {k: v.launches for k, v in _kernels.KERNELS.items()
                if v.launches}
        say(5, f"QLoRA step {i + 1} at S = {seq}: {ms:.1f} ms, peak "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB since "
               f"S = {seq}'s first step, losses "
               + ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
               + f", launches {used} on {gpu}")
        _check_launches(f"QLoRA step {i + 1}", _step_launches(c, seq, True))
        if i == 0:
            moved = [n for n, p in params.items()
                     if not torch.equal(p.detach().cpu(), snap[n])]
            if moved:
                raise PhaseError(f"QLoRA step 1 (lr(0) = 0) moved {moved[:4]}")
            a_grads = [float(p.grad.abs().max()) for n, p in params.items()
                       if "lora_A" in n]
            b_zero = [n for n, p in params.items() if "lora_B" in n
                      and not float(p.grad.abs().max()) > 0]
            if any(a_grads) or b_zero or len(a_grads) != 2 * n_layers:
                raise PhaseError(f"QLoRA step 1: lora_A gradients "
                                 f"{max(a_grads)}, lora_B without one "
                                 f"{b_zero[:4]}")
            norms = _check_grads(torch, params, groups)
            say(5, f"QLoRA step 1 left every parameter bit-equal; "
                   f"{2 * n_layers} lora_B gradients nonzero, "
                   f"{2 * n_layers} lora_A gradients exactly zero; "
                   "gradient norm by group: " + ", ".join(
                       f"{k} {v:.3e}" for k, v in norms.items()))
        if i == 1:
            moved = {n for n, p in params.items()
                     if not torch.equal(p.detach().cpu(), snap[n])}
            still = [g for g, rx in groups.items()
                     if not any(re.search(rx, n) for n in moved)]
            if still:
                raise PhaseError(f"QLoRA: groups unchanged after step 2: "
                                 f"{still}")
            say(5, f"after QLoRA step 2 every trainable group moved "
                   f"({len(moved)} of {len(params)} trainable tensors "
                   "differ, stochastic rounding)")
        del batch, out
    moved_a = [n for n, p in params.items() if "lora_A" in n
               and not torch.equal(p.detach().cpu(), snap[n])]
    changed = [n for n, t in _frozen_state(model).items()
               if not torch.equal(t, frozen[n])]
    if not moved_a or changed:
        raise PhaseError(f"QLoRA after step 3: {len(moved_a)} lora_A moved, "
                         f"frozen tensors changed {changed[:4]}")
    per = "; ".join(f"S = {k}: {', '.join(f'{t:.1f}' for t in v)}"
                    for k, v in times.items())
    say(5, f"after QLoRA step 3 {len(moved_a)} of {2 * n_layers} lora_A "
           f"moved and all {len(frozen)} frozen tensors (int4 bytes and "
           f"scales included) are bit-equal; ms per step: {per} (at "
           f"S = 2111 with K10 on its SIMT body: {SIMT_QLORA_S2111_MS} ms; "
           f"steps 1-3 with K1 and K9's forward on theirs: "
           f"{', '.join(map(str, SIMT_K1_STEP_MS['QLoRA']))} ms on an H100 "
           f"80GB HBM3 at 700 W) on {gpu}")
    del model, params, opt, step, frozen, snap
    torch.cuda.empty_cache()


def phase_train_parity(torch):
    """One step at GroveConfig.small() (S = 704) in fp32, one set of
    weights and one batch, on the card with the kernels and on the CPU with
    the plain versions (TF32 off), first with the default recipe, then with
    the QLoRA recipe (LoRA r = 8, remat, the LLM int4, bf16 moments), the
    CPU taking the card's `Int4Linear` branch (the recomputed view) through
    the `models.layers._on_card` seam: loss terms within TRAIN_LOSS_REL
    relative, each trainable tensor's gradient within TRAIN_GRAD_TOL of its
    max-abs (`_step_parity`). Returns the card's launches in the default
    recipe's step."""
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.models.grove import init_grove_params
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(GroveConfig.small(), max_seq_len=TRAIN_SEQ)
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    cpu = init_grove_params(cfg, device="cpu", dtype=torch.float32, seed=7)
    card = copy.deepcopy(cpu).to("cuda")
    batch = _train_batch(cfg, tok, seed=8)
    launches = _step_parity(
        torch, "GroveConfig.small() fp32 train step", cpu, card, batch,
        lambda m, dev: _train_setup(torch, m, 0), contextlib.nullcontext)
    del cpu, card
    qcfg, cpu = _qlora_model(torch, cfg, "cpu", torch.float32, seed=14)
    card = copy.deepcopy(cpu).to("cuda")
    used = _step_parity(
        torch, f"GroveConfig.small() fp32 QLoRA step (lora_r={QLORA_R}, "
        "remat, int4 LLM, bf16 moments)", cpu, card, batch,
        lambda m, dev: _qlora_setup(torch, m, 0, torch.Generator(
            device=dev).manual_seed(15))[::2], _card_branches_on_cpu)
    if any(used.get(k) for k in QLORA_NEVER):
        raise PhaseError(f"QLoRA parity: the card launched {used}")
    del cpu, card
    return launches


def _step_parity(torch, label, cpu, card, batch, setup, cpu_context):
    """One step of `setup(model, device) -> (params, step)` on the card and
    on the CPU (inside `cpu_context()`): loss terms within TRAIN_LOSS_REL
    relative, each trainable tensor's gradient within TRAIN_GRAD_TOL of its
    max-abs, or of TRAIN_GRAD_FLOOR of the largest gradient's max-abs for a
    tensor whose gradient is zero up to rounding; the card must launch
    every kernel of FP32_TRAIN_KERNELS (the SIMT entries of K4 and K9's
    forward in place of their tensor-core ones). Returns the card's
    launches."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.train.step import batch_to_device
    runs = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        params, step = setup(model, dev)
        _kernels.reset_launch_counts()
        with (cpu_context() if dev == "cpu" else contextlib.nullcontext()):
            (out, ms) = _timed(torch, lambda: step(batch_to_device(batch,
                                                                   dev)))
        runs.append((_check_losses(out, dev), params, ms))
        if dev == "cuda":
            launches = {k: v.launches for k, v in _kernels.KERNELS.items()
                        if v.launches}
            _check_off_path(label)
    (l_card, p_card, ms_card), (l_cpu, p_cpu, ms_cpu) = runs
    missing = [k for k in FP32_TRAIN_KERNELS if k not in launches]
    if missing:
        raise PhaseError(f"{label}: kernels never launched on the card: "
                         f"{missing}")
    rel = {k: abs(l_card[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-30)
           for k in l_cpu}
    grads = {}
    for name, p in p_cpu.items():
        gc, gg = p.grad, p_card[name].grad
        if (gc is None) != (gg is None):
            raise PhaseError(f"{label}: {name} has a gradient on one device "
                             "only")
        if gc is not None:
            grads[name] = (gg.cpu(), gc)
    floor = TRAIN_GRAD_FLOOR * max(float(c.abs().max())
                                   for _, c in grads.values())
    worst, floored = 0.0, []
    for name, (gg, gc) in grads.items():
        own = float(gc.abs().max())
        if own < floor:
            floored.append(name)
        scale = max(own, floor)
        err = float((gg - gc).abs().max())
        if not err <= TRAIN_GRAD_TOL * scale:
            raise PhaseError(f"{label}: {name} gradient {err:.3e} > "
                             f"{TRAIN_GRAD_TOL} x {scale:.3e}")
        worst = max(worst, err / scale)
    say(6, f"{label} card vs CPU: loss terms relative "
           + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
           + f"; {len(grads)} gradients, worst {worst:.2e} of its max-abs "
           f"({len(floored)} under {TRAIN_GRAD_FLOOR} of the largest, held "
           f"at that floor: {floored}); card {ms_card:.0f} ms, CPU "
           f"{ms_cpu:.0f} ms; card kernel launches {launches}")
    if not max(rel.values()) <= TRAIN_LOSS_REL:
        raise PhaseError(f"{label}: loss terms {rel} > {TRAIN_LOSS_REL} "
                         "relative")
    return launches


# ---------------------------------------------------------------------------
# phase 7: the loader
# ---------------------------------------------------------------------------

def _sp_tokenizer(path):
    """A unigram SentencePiece model with byte fallback written to `path`
    by the port's pure-Python writer, read back by `load_grove_tokenizer`
    (the GROVE tokens appended after its 263 pieces, so their ids differ
    from the config's defaults)."""
    from grove_tpu_torch.text import sentencepiece as sp
    from grove_tpu_torch.text.tokenizer import load_grove_tokenizer
    pieces = ([("<unk>", 0.0, sp.UNKNOWN), ("<s>", 0.0, sp.CONTROL),
               ("</s>", 0.0, sp.CONTROL)]
              + [(f"<0x{b:02X}>", 0.0, sp.BYTE) for b in range(256)]
              + [("\u2581a", -1.0, sp.NORMAL), ("\u2581man", -2.0, sp.NORMAL),
                 ("\u2581video", -2.0, sp.NORMAL), ("s", -4.0, sp.NORMAL)])
    path.write_bytes(sp.serialize_model(sp.SpModel(
        pieces, model_type=sp.UNIGRAM, byte_fallback=True)))
    return load_grove_tokenizer(str(path))


def _reference_checkpoint(torch, cfg, seed):
    """A reference-named state dict of GroveConfig.small() as the reference
    exports it after LoRA training at another SAM size: SAM built on twice
    the grid (pos_embed and the global blocks' rel_pos tables on it, the
    windowed blocks' at the same window), every key under PEFT's
    `base_model.model.`, each LLaMA layer's q_proj and v_proj as a
    `.base_layer.` weight beside a rank-8 LoRA pair. Returns (the dict, the
    float model it came from)."""
    from grove_tpu_torch.models.grove import init_grove_params
    src = init_grove_params(cfg, device="cpu", dtype=torch.float32, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    enc = cfg.sam_enc
    sam = "model.grounding_encoder.image_encoder."
    sd = dict(src.state_dict())
    sd[sam + "pos_embed"] = 0.02 * torch.randn(
        (1, 2 * enc.grid, 2 * enc.grid, enc.embed_dim), generator=gen)
    for i in enc.global_attn_indexes:
        for t in "hw":
            key = f"{sam}blocks.{i}.attn.rel_pos_{t}"
            sd[key] = 0.02 * torch.randn((4 * enc.grid - 1,
                                          sd[key].shape[1]), generator=gen)
    out = {}
    for k, v in sd.items():
        base = k.removesuffix(".weight")
        if k.startswith("model.layers.") and base.endswith(("q_proj",
                                                            "v_proj")):
            out[f"base_model.model.{base}.base_layer.weight"] = v
            out[f"base_model.model.{base}.lora_A.default.weight"] = (
                0.01 * torch.randn((8, v.shape[1]), generator=gen))
            out[f"base_model.model.{base}.lora_B.default.weight"] = (
                0.01 * torch.randn((v.shape[0], 8), generator=gen))
        else:
            out[f"base_model.model.{k}"] = v
    return out, src


def phase_loader(torch, gpu):
    """`GroveForCausalLM.from_pretrained` with a tokenizer and a PEFT-named
    `.bin` whose SAM is on another grid, onto the card and onto the CPU:
    the config's special-token ids are the tokenizer's; the card's state
    dict is bit-equal to the CPU's (the LoRA pairs merged, pos_embed resized
    bicubic and the global tables linearly); the loaded SAM runs on the
    card within PARITY_TOL of the CPU's max-abs (fp32, TF32 off)."""
    from grove_tpu_torch.api import GroveForCausalLM
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.text.tokenizer import special_token_ids_from

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GroveConfig.small()
    with tempfile.TemporaryDirectory() as tmp:
        tok = _sp_tokenizer(Path(tmp) / "tokenizer.model")
        sd, src = _reference_checkpoint(torch, cfg, seed=16)
        path = Path(tmp) / "grove.bin"
        torch.save(sd, path)
        t0 = time.perf_counter()
        card = GroveForCausalLM.from_pretrained(
            str(path), "small", tokenizer=tok, dtype=torch.float32,
            device="cuda")
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        host = GroveForCausalLM.from_pretrained(
            str(path), "small", tokenizer=tok, dtype=torch.float32,
            device="cpu")
    tokens = special_token_ids_from(tok)
    if card.cfg.tokens != tokens or tokens.det == cfg.tokens.det:
        raise PhaseError(f"from_pretrained(tokenizer=): tokens "
                         f"{card.cfg.tokens}, the tokenizer's {tokens}, the "
                         f"defaults' {cfg.tokens}")
    want = host.model.state_dict()
    for key, val in card.model.state_dict().items():
        if not torch.equal(val.cpu(), want[key]):
            raise PhaseError(f"loader: {key} on the card differs from the "
                             "CPU's load")
    sam = "model.grounding_encoder.image_encoder."
    old = src.state_dict()
    moved = [k for k in (sam + "pos_embed",
                         f"{sam}blocks.{cfg.sam_enc.global_attn_indexes[0]}"
                         ".attn.rel_pos_h",
                         "model.layers.0.self_attn.q_proj.weight")
             if want[k].shape == old[k].shape and torch.equal(want[k], old[k])]
    if moved:
        raise PhaseError(f"loader: {moved} not resized or merged")
    clip = _synthetic_clips(cfg, 1, cfg.num_frames, seed=17)[0]
    frames = torch.from_numpy(clip["frames_sam"][None])
    got = card.get_grounding_encoder_embs(frames).float().cpu()
    ref = host.get_grounding_encoder_embs(frames).float()
    rel = _max_err(got, ref) / float(ref.abs().max())
    if not (bool(torch.isfinite(got).all()) and rel <= PARITY_TOL):
        raise PhaseError(f"loader: SAM embeddings of the resized tables card "
                         f"vs CPU {rel:.3e} of max-abs > {PARITY_TOL}")
    say(7, f"from_pretrained of a PEFT-named .bin ({len(sd)} keys, LoRA "
           f"pairs on {cfg.llama.num_layers} x 2 projections, SAM pos_embed "
           f"{2 * cfg.sam_enc.grid}^2 -> {cfg.sam_enc.grid}^2 and global "
           f"tables {4 * cfg.sam_enc.grid - 1} -> {2 * cfg.sam_enc.grid - 1} "
           f"rows) with a SentencePiece tokenizer ([DET] = {tokens.det}, "
           f"default {cfg.tokens.det}) onto the card in {load_ms:.0f} ms: "
           f"bit-equal to the CPU's load; SAM embeddings card vs CPU "
           f"{rel:.2e} of max-abs on {gpu}")
    del card, host
    torch.cuda.empty_cache()
    _full_sam_load(torch, gpu)


def _full_sam_load(torch, gpu, cfg=None, device="cuda"):
    """The main path's SAM at full width (`GroveConfig()`: 32 blocks of
    1280 channels, 16 heads of 80) exported as the reference trains it, at
    1024 pixels: pos_embed on a 64 x 64 grid, the global blocks' rel_pos
    tables at 127 rows, the windowed blocks' at 27, every tensor bf16 in a
    `.bin`. Read the loader's way (`api.model.read_checkpoint`: fp32 numpy)
    and copied strictly (`checkpoint.convert.load_reference_state_dict`:
    pos_embed bicubic to 32 x 32, the global tables linearly to 63 rows)
    into the image encoder in fp32, on the card and on the CPU: the card's
    tensors bit-equal to the CPU's; one frame through each within
    PARITY_TOL of the CPU's max-abs (TF32 off). The whole model's `.bin`
    (16 GB in bf16, 32 GB as fp32 numpy) is not written here: this is the
    part of it that the grid changes."""
    from grove_tpu_torch.api.model import read_checkpoint
    from grove_tpu_torch.checkpoint.convert import load_reference_state_dict
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.models.grove import init_params_
    from grove_tpu_torch.models.sam_encoder import SamImageEncoder

    cfg = cfg or GroveConfig()
    enc = cfg.sam_enc
    pre = "model.grounding_encoder.image_encoder."

    def holder(dev):
        # the encoder under the model's names, with the config the loader
        # reads the grid from
        m = torch.nn.Module()
        m.cfg = cfg
        m.model = torch.nn.Module()
        m.model.grounding_encoder = torch.nn.Module()
        m.model.grounding_encoder.image_encoder = SamImageEncoder(
            enc, device="meta", dtype=torch.float32)
        return m.to_empty(device=dev)

    src = holder(device)
    gen = torch.Generator(device=device).manual_seed(18)
    init_params_(src, gen)
    sd = {k: v.to(torch.bfloat16).cpu() for k, v in src.state_dict().items()}
    del src
    big = 2 * enc.grid
    sd[pre + "pos_embed"] = (0.02 * torch.randn(
        (1, big, big, enc.embed_dim), generator=gen, device=device)
        ).to(torch.bfloat16).cpu()
    for i in enc.global_attn_indexes:
        for t in "hw":
            key = f"{pre}blocks.{i}.attn.rel_pos_{t}"
            sd[key] = (0.02 * torch.randn(
                (2 * big - 1, sd[key].shape[1]), generator=gen,
                device=device)).to(torch.bfloat16).cpu()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "sam.bin"
        torch.save(sd, path)
        mib = path.stat().st_size / 2**20
        del sd
        t0 = time.perf_counter()
        arrays = read_checkpoint(str(path))
    card = load_reference_state_dict(holder(device), arrays)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    host = load_reference_state_dict(holder("cpu"), arrays)
    del arrays
    want = host.state_dict()
    for key, val in card.state_dict().items():
        if not torch.equal(val.cpu(), want[key]):
            raise PhaseError(f"full-width SAM load: {key} on the card "
                             "differs from the CPU's load")
    glob = f"{pre}blocks.{enc.global_attn_indexes[0]}.attn.rel_pos_h"
    shapes = (tuple(want[pre + "pos_embed"].shape), tuple(want[glob].shape))
    if shapes != ((1, enc.grid, enc.grid, enc.embed_dim),
                  (2 * enc.grid - 1, enc.embed_dim // enc.num_heads)):
        raise PhaseError(f"full-width SAM load: pos_embed, global rel_pos_h "
                         f"{shapes}")
    gen = torch.Generator().manual_seed(19)
    frames = torch.randn((1, 1, enc.img_size, enc.img_size, 3),
                         generator=gen)
    with torch.inference_mode():
        got = card.model.grounding_encoder.image_encoder(
            frames.to(device)).cpu()
        ref = host.model.grounding_encoder.image_encoder(frames)
    rel = _max_err(got, ref) / float(ref.abs().max())
    if not (bool(torch.isfinite(got).all()) and rel <= PARITY_TOL):
        raise PhaseError(f"full-width SAM load: one frame card vs CPU "
                         f"{rel:.3e} of max-abs > {PARITY_TOL}")
    say(7, f"full-width SAM image encoder ({enc.depth} blocks of "
           f"{enc.embed_dim}) exported at a {big} x {big} grid ({mib:.0f} "
           f"MiB bf16 .bin): read and loaded onto the card in {load_s:.1f} s "
           f"(pos_embed {big}^2 -> {enc.grid}^2, global tables "
           f"{2 * big - 1} -> {2 * enc.grid - 1} rows), bit-equal to the "
           f"CPU's load; one {enc.img_size} x {enc.img_size} frame card vs "
           f"CPU {rel:.2e} of max-abs (fp32) on {gpu}")
    del card, host
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 8: the training driver
# ---------------------------------------------------------------------------

# `python -m grove_tpu_torch.train.driver` at full width: GroveConfig() in
# bf16 at S = 129 + 575 = 704 (phase 5's TRAIN_SEQ), the synthetic dataset,
# validation in giou mode; warmup 1, so the second update moves the bf16
# weights as phase 5's do (lr(0) = 0)
DRIVER_FULL = ["--model_size", "full", "--synthetic", "--model_max_length",
               str(TRAIN_SEQ), "--batch_size", "1", "--steps_per_epoch", "2",
               "--val_mode", "giou", "--num_workers", "2", "--warmup_steps",
               "1", "--max_restarts", "0", "--device", "cuda"]
# the same driver on GroveConfig.small() in fp32, card against CPU: two
# updates of two accumulated micro-batches from one `.bin` of weights
DRIVER_SMALL = ["--model_size", "small", "--synthetic", "--model_max_length",
                str(TRAIN_SEQ), "--grad_accumulation_steps", "2",
                "--steps_per_epoch", "4", "--epochs", "1", "--num_workers",
                "1", "--warmup_steps", "1", "--max_restarts", "0"]
# the card's machine stops a command once it has written 45 GiB to its
# disk, deleted files included (a run was stopped at 47.6 GiB inside the
# full-width run's first saves); a full-width run of 2 epochs writes two
# steps of 18.32 GiB and two best copies of 15.68 GiB. So the full-width
# run's checkpoints are counted and checked on the card but not written
# (`_unwritten_checkpoints`), and the checkpoint half of the driver (save,
# restore bit for bit, resume) runs at GroveConfig.small() in bf16
# (DRIVER_RESUME, 0.85 GiB a step), as the same code at another width
DRIVER_RESUME = ["--model_size", "small"] + DRIVER_FULL[2:]


class _Tee:
    """Write to the real stdout and keep a copy (the driver's log)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


class _DriverSpy:
    """Wrap `train.driver.make_train_step` for one driver run: keep the
    run's model and optimizer, call `first(model, optimizer)` before its
    first step, and for each step record the ms, the loss terms and the
    kernel launches (every count set to 0 just before the step and read
    just after)."""

    def __init__(self, torch, first=None):
        self.torch, self.first = torch, first
        self.model = self.opt = self.first_out = None
        self.steps = []

    def __enter__(self):
        from grove_tpu_torch.train import driver
        self._driver, self._real = driver, driver.make_train_step
        driver.make_train_step = self._make
        return self

    def __exit__(self, *exc):
        self._driver.make_train_step = self._real

    def _make(self, model, optimizer, *mesh):
        from grove_tpu_torch import _kernels
        torch, inner = self.torch, self._real(model, optimizer, *mesh)
        self.model, self.opt = model, optimizer
        cuda = model.device.type == "cuda"

        def step(batch):
            if self.first is not None and not self.steps:
                self.first_out = self.first(model, optimizer)
            if cuda:
                torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = inner(batch)
            if cuda:
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            self.steps.append((ms, {k: v.launches for k, v in
                                    _kernels.KERNELS.items() if v.launches},
                               _check_losses(out, f"driver step "
                                             f"{len(self.steps) + 1}")))
            return out
        return step


def _run_driver(torch, argv, first=None):
    """`train.driver.main(argv)` in this process with its stdout kept;
    returns (its best metric, the spy, its log, seconds)."""
    from grove_tpu_torch.train import driver
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with _DriverSpy(torch, first) as spy, contextlib.redirect_stdout(tee):
        best = driver.main(argv)
    return best, spy, tee.text(), time.perf_counter() - t0


def _meter_times(log):
    """(secs/batch, data_secs) of each step the driver's ProgressMeter
    printed."""
    return [(float(a), float(b)) for a, b in re.findall(
        r"secs/batch ([\d.]+) \([\d.]+\)\tdata_secs ([\d.]+)", log)]


def _state_equal(torch, model, opt, saved, label):
    """The model's state dict and the optimizer's state bit-equal to a
    restored checkpoint (on the CPU); returns the bytes compared."""
    nbytes = 0

    def same(got, want, where):
        nonlocal nbytes
        if isinstance(want, dict):
            if set(got) != set(want):
                raise PhaseError(f"{label}: {where} keys differ")
            for k in want:
                same(got[k], want[k], f"{where}/{k}")
        elif isinstance(want, torch.Tensor):
            if (got.dtype != want.dtype or got.shape != want.shape
                    or not torch.equal(got, want.to(got.device))):
                raise PhaseError(f"{label}: {where} differs from the "
                                 "checkpoint")
            nbytes += want.numel() * want.element_size()
        elif got != want:
            raise PhaseError(f"{label}: {where} {got} != {want}")
    same(model.state_dict(), saved["params"], "params")
    same(opt.state_dict(), saved["opt_state"], "opt_state")
    return nbytes


def _check_driver_steps(spy, cfg, label, n, full=True):
    """The driver run took `n` steps, each launching the kernels
    `_step_launches` gives for `cfg` at S = 704 (at full width also
    TRAIN_LAUNCHES: phase 5's steps)."""
    if len(spy.steps) != n:
        raise PhaseError(f"{label} took {len(spy.steps)} steps, not {n}")
    want = _step_launches(cfg, 704, False)
    for i, (ms, launches, losses) in enumerate(spy.steps):
        got = {k: launches.get(k, 0) for k in want}
        train = {k: launches.get(k, 0) for k in TRAIN_LAUNCHES}
        if got != want or (full and train != TRAIN_LAUNCHES):
            raise PhaseError(f"{label} step {i + 1} launched {launches}, "
                             f"not phase 5's {want}")


def _checkpoint_bytes(torch, cfg):
    """Bytes of one driver checkpoint of `cfg` in bf16 and of its
    parameters alone (a meta-device model: no memory)."""
    from grove_tpu_torch.models.grove import GroveModel
    from grove_tpu_torch.train.step import OptimizerConfig, trainable_mask
    meta = GroveModel(cfg, device="meta", dtype=torch.bfloat16)
    params = sum(t.numel() * t.element_size()
                 for t in meta.state_dict().values())
    mask = trainable_mask(meta, OptimizerConfig())
    moments = sum(2 * p.numel() * p.element_size()
                  for n, p in meta.named_parameters() if mask[n])
    return params + moments, params


def phase_driver(torch, gpu):
    """The training driver in this process: at full width (steps,
    validation, the checkpoints checked but not written), its checkpoint
    half at small in bf16 (save, restore, resume), and in fp32 at small
    with accumulation, card against CPU."""
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="grove_driver_"))
    try:
        _driver_full(torch, gpu, tmp)
        torch.cuda.empty_cache()
        _driver_resume(torch, gpu, tmp)
        torch.cuda.empty_cache()
        _driver_small(torch, gpu, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(8, f"phase 8 took {time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def _unwritten_checkpoints(on_save):
    """`checkpoint.manager` with the write left out: each save hands
    `on_save(path, state)` the live tensors (no copy to the host, no
    file); the markers are still written."""
    from grove_tpu_torch.checkpoint import manager
    real = manager._write_dir, manager.to_cpu
    manager._write_dir, manager.to_cpu = on_save, (lambda tree: tree)
    try:
        yield
    finally:
        manager._write_dir, manager.to_cpu = real


def _moved(torch, snap, params, trainable, label):
    """Names of the tensors that moved from `snap`; raises if a frozen one
    did or a trainable group did not."""
    moved = {n for n, t in snap.items()
             if not torch.equal(t, params[n].to(t.device))}
    if moved - trainable:
        raise PhaseError(f"{label} moved frozen tensors: "
                         f"{sorted(moved - trainable)[:4]}")
    still = [g for g, pairs in _groups({n: None for n in trainable}).items()
             if not any(n in moved for n, _ in pairs)]
    if still:
        raise PhaseError(f"{label}: trainable groups unchanged: {still}")
    return moved


def _losses_text(spy):
    return "; ".join(", ".join(f"{k} {v:.4f}" for k, v in losses.items())
                     for _, _, losses in spy.steps)


def _driver_full(torch, gpu, tmp):
    """`--model_size full` at S = 704: two epochs of two steps with giou
    validation; each step's launches equal phase 5's at S = 704, every
    loss finite, only trainable tensors moved by step 4, the saves at steps
    2 and 4 and the best marker made, the checkpoint files not written."""
    from grove_tpu_torch.config import GroveConfig
    cfg = dataclasses.replace(GroveConfig(), max_seq_len=TRAIN_SEQ)
    step_bytes, param_bytes = _checkpoint_bytes(torch, cfg)
    snap, saves, moved = {}, [], {}

    def first(model, opt):
        snap.update({k: v.detach().clone()
                     for k, v in model.state_dict().items()})

    def on_save(path, state):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        saves.append(Path(path).relative_to(tmp / "full").as_posix())
        if saves[-1] == "ckpt_model/4":
            moved["trainable"] = set(state["opt_state"]["mu"])
            moved["moved"] = _moved(torch, snap, state["params"],
                                    moved["trainable"],
                                    "driver at full width")

    argv = DRIVER_FULL + ["--epochs", "2", "--log_base_dir", str(tmp),
                          "--exp_name", "full"]
    with _unwritten_checkpoints(on_save):
        best, spy, log, secs = _run_driver(torch, argv, first)
    _check_driver_steps(spy, cfg, "driver at full width", 4)
    snap.clear()
    markers = sorted(f.name for f in (tmp / "full" / "ckpt_model_best")
                     .glob("*.marker"))
    if (saves[-1] != "ckpt_model/4" or "ckpt_model/2" not in saves
            or len(markers) != 1
            or not markers[0].endswith(f"_{best:.4f}.marker")):
        raise PhaseError(f"driver at full width: saves {saves}, markers "
                         f"{markers}, best {best}")
    times = _meter_times(log)
    say(8, f"driver --model_size full (bf16, S = 704, batch 1, 2 epochs x "
           f"2 steps, giou validation, 2 loader threads) in {secs:.1f} s: "
           f"losses by step {_losses_text(spy)}; step ms "
           + ", ".join(f"{ms:.1f}" for ms, _, _ in spy.steps)
           + "; the driver's secs/batch / data_secs "
           + ", ".join(f"{a:.2f}/{b:.2f}" for a, b in times)
           + f"; each step's launches equal phase 5's at S = 704 "
           f"({spy.steps[-1][1]}); "
           f"{len(moved['moved'])} of {len(moved['trainable'])} trainable "
           f"tensors moved by step "
           f"4, every frozen one bit-equal; saves {saves} and marker "
           f"{markers[0]} made, the files ({step_bytes / 2**30:.2f} GiB a "
           f"step, {param_bytes / 2**30:.2f} GiB a best copy) not written: "
           f"the machine's disk takes 45 GiB of writes a run; on {gpu}")
    del spy
    shutil.rmtree(tmp / "full")


def _driver_resume(torch, gpu, tmp):
    """The checkpoint half at GroveConfig.small() in bf16: two epochs of
    two steps (the launches per step `_step_launches` gives at S = 704),
    steps 2 and 4 kept, step 4 restored bit-equal to the card's parameters
    and optimizer state, only trainable tensors moved, one best marker;
    then `--auto_resume --epochs 3` resumes at epoch 2 from step 4 with
    the state on the card bit-equal to the checkpoint before its first
    step, and takes two steps."""
    from grove_tpu_torch.checkpoint.manager import CheckpointManager
    from grove_tpu_torch.config import GroveConfig
    cfg = dataclasses.replace(GroveConfig.small(), max_seq_len=TRAIN_SEQ)
    snap = {}

    def first(model, opt):
        snap.update({k: v.detach().clone()
                     for k, v in model.state_dict().items()})

    argv = DRIVER_RESUME + ["--log_base_dir", str(tmp), "--exp_name",
                            "resume"]
    best, spy, log, secs = _run_driver(torch, argv + ["--epochs", "2"],
                                       first)
    _check_driver_steps(spy, cfg, "driver run 1 at small", 4, full=False)
    mgr = CheckpointManager(str(tmp / "resume"))
    if mgr.steps() != [2, 4]:
        raise PhaseError(f"driver run 1 saved steps {mgr.steps()}, not "
                         "[2, 4]")
    saved = mgr.restore(4)
    nbytes = _state_equal(torch, spy.model, spy.opt, saved, "step 4")
    trainable = {n for n, p in spy.model.named_parameters()
                 if p.requires_grad}
    moved = _moved(torch, snap, saved["params"], trainable,
                   "driver run 1 at small")
    snap.clear()
    markers = [f for f in os.listdir(mgr.best_dir) if f.endswith(".marker")]
    if (len(markers) != 1
            or mgr.best_metric_from_marker() != round(best, 4)):
        raise PhaseError(f"best marker {markers}, best {best}")
    say(8, f"driver --model_size small (bf16, S = 704, 2 epochs x 2 steps, "
           f"giou validation, checkpoints written) in {secs:.1f} s: losses "
           f"{_losses_text(spy)}; each step's launches as "
           f"`_step_launches` at S = 704; {len(moved)} of {len(trainable)} "
           f"trainable tensors moved, every frozen one bit-equal; steps "
           f"{mgr.steps()} kept, step 4 restored ({nbytes / 2**30:.2f} GiB) "
           f"bit-equal to the card's parameters and optimizer state; best "
           f"marker {markers[0]}")
    del spy

    def resumed(model, opt):
        return _state_equal(torch, model, opt, saved, "resumed step 4")

    best2, spy, log, secs = _run_driver(
        torch, argv + ["--epochs", "3", "--auto_resume"], resumed)
    if "resumed from step 4 (epoch 2)" not in log:
        raise PhaseError("driver run 2 did not resume at step 4")
    _check_driver_steps(spy, cfg, "driver run 2 at small", 2, full=False)
    if mgr.steps() != [4, 6] or spy.opt.state_dict()["count"] != 6:
        raise PhaseError(f"driver run 2: steps {mgr.steps()}, count "
                         f"{spy.opt.state_dict()['count']}")
    times = _meter_times(log)
    say(8, f"driver --auto_resume --epochs 3 at small in {secs:.1f} s: "
           f"resumed at epoch 2 from step 4, the model and optimizer state "
           f"on the card bit-equal to the checkpoint before its first step "
           f"({spy.first_out / 2**30:.2f} GiB); losses {_losses_text(spy)}; "
           "step ms " + ", ".join(f"{ms:.1f}" for ms, _, _ in spy.steps)
           + "; secs/batch / data_secs "
           + ", ".join(f"{a:.2f}/{b:.2f}" for a, b in times)
           + f"; steps kept {mgr.steps()}, best {best2:.4f} on {gpu}")
    del saved, spy
    shutil.rmtree(tmp / "resume")


def _driver_small(torch, gpu, tmp):
    """Two accumulated updates at GroveConfig.small() in fp32 from one
    `.bin`, card and CPU: every micro-step's loss terms within
    TRAIN_LOSS_REL, the moments of every trainable tensor within
    TRAIN_GRAD_TOL of their max-abs (phase 6's gradient tolerance, with its
    floor), and each trainable parameter's difference, over its update's
    max-abs and weighted by |mu| / max|mu| at the element (max|mu| held at
    phase 6's floor for a gradient zero up to rounding), within
    TRAIN_GRAD_TOL (Adam's m / sqrt(v) turns an element's gradient error
    relative to the tensor into one relative to that element); the frozen
    ones bit-equal to the `.bin`."""
    from grove_tpu_torch.checkpoint.manager import CheckpointManager
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.models.grove import init_grove_params
    from grove_tpu_torch.train import driver
    torch.backends.cuda.matmul.allow_tf32 = False     # as phase 6
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(GroveConfig.small(), max_seq_len=TRAIN_SEQ)
    src = init_grove_params(cfg, device="cpu", dtype=torch.float32, seed=18)
    init = {k: v.clone() for k, v in src.state_dict().items()}
    torch.save(init, tmp / "small.bin")
    del src
    runs = {}
    real_dtype = driver.model_dtype
    # the driver builds `small` in bf16; phase 6's comparison is in fp32
    driver.model_dtype = lambda size: torch.float32
    try:
        for dev in ("cuda", "cpu"):
            _, spy, log, secs = _run_driver(torch, DRIVER_SMALL + [
                "--version", str(tmp / "small.bin"), "--device", dev,
                "--log_base_dir", str(tmp), "--exp_name", f"small_{dev}"])
            if "missing=0 mismatched=0" not in log:
                raise PhaseError(f"--version on {dev}: {log[-300:]}")
            runs[dev] = (CheckpointManager(str(tmp / f"small_{dev}"))
                         .restore(4), spy.steps, secs,
                         re.findall(r"val_giou=(\S+)", log))
    finally:
        driver.model_dtype = real_dtype
    (card, card_steps, card_s, card_val), (cpu, cpu_steps, cpu_s,
                                           cpu_val) = runs["cuda"], runs["cpu"]
    for i, ((_, _, a), (_, _, b)) in enumerate(zip(card_steps, cpu_steps,
                                                   strict=True)):
        for k, w in b.items():
            if abs(a[k] - w) > TRAIN_LOSS_REL * abs(w):
                raise PhaseError(f"small driver micro-step {i + 1} {k}: "
                                 f"card {a[k]}, CPU {w}")
    inner = [r["opt_state"]["inner_opt_state"] for r in (card, cpu)]
    if ([i["count"] for i in inner] != [2, 2]
            or [r["opt_state"]["gradient_step"] for r in (card, cpu)]
            != [2, 2]):
        raise PhaseError(f"small driver: counts {[i['count'] for i in inner]}")
    worst = {}
    for key in ("mu", "nu"):
        want = inner[1][key]
        floor = TRAIN_GRAD_FLOOR * max(float(t.abs().max())
                                       for t in want.values())
        for name, t in want.items():
            tol = TRAIN_GRAD_TOL * max(float(t.abs().max()), floor)
            err = float((inner[0][key][name] - t).abs().max())
            if err > tol:
                raise PhaseError(f"small driver {key}[{name}] card vs CPU "
                                 f"{err:.3e} > {tol:.3e}")
            worst[key] = max(worst.get(key, 0.0), err / tol * TRAIN_GRAD_TOL)
    mu = inner[1]["mu"]
    upd = {n: (cpu["params"][n] - init[n]).abs() for n in mu}
    floor = TRAIN_GRAD_FLOOR * max(float(u.max()) for u in upd.values())
    # Adam divides each element's moment by its own scale, so an element's
    # update carries its gradient's error relative to that element: weight
    # the difference by |mu| over the tensor's max-abs, or over phase 6's
    # floor where the tensor's gradient is zero up to rounding
    mu_floor = TRAIN_GRAD_FLOOR * max(float(t.abs().max())
                                      for t in mu.values())
    plain, scaled, moved, bad = 0.0, 0.0, 0, {}
    for name, u in upd.items():
        diff = ((card["params"][name] - cpu["params"][name]).abs()
                / max(float(u.max()), floor))
        weight = mu[name].abs() / max(float(mu[name].abs().max()), mu_floor)
        err = float((diff * weight).max())
        plain, scaled = max(plain, float(diff.max())), max(scaled, err)
        if err > TRAIN_GRAD_TOL:
            bad[name] = err
        moved += bool(u.max() > 0)
    if bad:
        raise PhaseError(f"small driver: {len(bad)} trainable tensors card "
                         f"vs CPU beyond {TRAIN_GRAD_TOL} of their update's "
                         f"max-abs weighted by |mu|: {bad}")
    frozen = [n for n in init if n not in mu
              and not (torch.equal(card["params"][n], init[n])
                       and torch.equal(cpu["params"][n], init[n]))]
    if frozen or not moved:
        raise PhaseError(f"small driver: frozen tensors moved {frozen[:4]}, "
                         f"{moved} trainable moved")
    say(8, f"GroveConfig.small() fp32 driver, 2 updates of 2 accumulated "
           f"micro-batches from one .bin, card vs CPU: {len(card_steps)} "
           f"micro-steps' loss terms within {TRAIN_LOSS_REL} relative; "
           f"moments of {len(mu)} trainable tensors within "
           f"{worst['mu']:.2e} (mu) and {worst['nu']:.2e} (nu) of "
           f"their max-abs (limit {TRAIN_GRAD_TOL}); {moved} tensors moved, "
           f"the parameters within {scaled:.2e} of their update's max-abs "
           f"weighted by |mu| / max|mu| (limit {TRAIN_GRAD_TOL}; unweighted "
           f"{plain:.2e}); frozen bit-equal; val_giou card {card_val}, CPU "
           f"{cpu_val}; card run {card_s:.1f} s, CPU run {cpu_s:.1f} s on "
           f"{gpu}")


# ---------------------------------------------------------------------------
# phase 9: serving
# ---------------------------------------------------------------------------

# sampled and beam decodes at full width: new tokens, the sampler's knobs,
# the generator's seed
SERVE_STEPS = 32
# the card phase 9 runs on (a CPU rehearsal of its control flow sets "cpu")
SAMPLING = {"temperature": 0.7, "top_k": 50, "top_p": 0.9}
SAMPLE_SEED = 1234
# a nucleus row is held card against CPU only where no `cum - probs` lies
# within this of top_p (past the top token): closer, the order of the
# reductions decides
NUCLEUS_MARGIN = 1e-6
BEAM_SCORE_REL = 1e-4    # small() fp32 beam scores, card vs CPU, relative
# the continuous engine: slots, requests, admitted 2, then 2 after
# SERVE_STAGGER ticks, then as slots free; up to and at the first engine
# token that differs from the offline greedy_decode's, their logits agree
# within SERVE_LOGIT_TOL of the offline max-abs, and where one differs, the
# offline top-two gap is at most twice their max-abs difference. At least
# SERVE_MIN_FULL requests equal the offline tokens in full, and at least
# SERVE_MIN_EQUAL of all tokens lie in the equal prefixes (the bf16 and
# int8 runs at full width gave 4 of 6 and 309 / 310 of 384)
SERVE_SLOTS = 4
SERVE_REQUESTS = 6
SERVE_STAGGER = 5
SERVE_LOGIT_TOL = 5e-2
SERVE_MIN_FULL = 3
SERVE_MIN_EQUAL = 0.7
SMALL_NEW = 16           # new tokens of the small() fp32 engine and beams
HTTP_FRAMES = 24


@contextlib.contextmanager
def _lm_head_outputs(model):
    """Every lm_head output of the block, in call order."""
    outs = []
    hook = model.lm_head.register_forward_hook(
        lambda m, a, out: outs.append(out.detach()))
    try:
        yield outs
    finally:
        hook.remove()


def _nucleus_margins(torch, logits, temperature, top_k, top_p):
    """Per row, min |cum - probs - top_p| of the nucleus past the top
    token (on the CPU, in fp32)."""
    from grove_tpu_torch.infer.generate import filter_logits
    l = filter_logits(logits.cpu(), temperature, top_k)
    probs = torch.softmax(torch.sort(l, -1, descending=True).values, -1)
    cum = torch.cumsum(probs, -1)
    return (cum - probs - top_p).abs()[:, 1:].amin(-1)


def phase_serve(torch, gpu, decoder):
    """Returns the launches of the int8-cache continuous-engine run."""
    from grove_tpu_torch.api import GroveForCausalLM
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    t_phase = time.perf_counter()
    lm = GroveForCausalLM.from_pretrained(None, "full", device="cuda",
                                          dtype=torch.bfloat16, seed=0)
    cfg, model = lm.cfg, lm.model
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    nf = cfg.num_frames
    clips = _synthetic_clips(cfg, 3, nf, seed=9)
    with torch.inference_mode():
        emb, _ = model.encode_video(torch.from_numpy(np.stack(
            [c["frames_clip"] for c in clips])).to("cuda"))
        img = model.encode_grounding_auto(torch.from_numpy(np.stack(
            [c["frames_sam"] for c in clips])).to("cuda"))
    say(9, f"GroveConfig() bf16 built, 3 clips of {nf} frames encoded on "
           f"{gpu}")
    _serve_sampling(torch, gpu, model, cfg, tok, emb[:2])
    _serve_beams(torch, gpu, model, cfg, tok, emb[:2])
    _serve_engine(torch, gpu, model, cfg, tok, emb, img, torch.bfloat16)
    launches = _serve_engine(torch, gpu, model, cfg, tok, emb, img,
                             torch.int8)
    del emb, img
    _serve_http(torch, gpu, model, cfg, tok)
    del model, lm
    torch.cuda.empty_cache()
    _serve_small(torch, gpu)
    say(9, f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _serve_sampling(torch, gpu, model, cfg, tok, emb):
    """greedy_decode sampling on phase 3's two prompts (left-padded to
    640): the same seed twice gives the same tokens; every pick lies in its
    step's filtered support; on the recorded logits and the same injected
    noise the card's filter and draw equal the CPU's."""
    from grove_tpu_torch.infer import generate as tgen
    from grove_tpu_torch.infer.sliding import center_prompts
    ids, starts, pads = center_prompts(cfg, tok, list(PROMPTS))
    ids_t = torch.from_numpy(ids).to("cuda")
    pads_t = torch.from_numpy(pads).to("cuda")
    picks, pick = [], tgen.next_tokens

    def recording(logits, step, *a, **kw):
        out = pick(logits, step, *a, **kw)
        picks.append((step, logits.float().clone(), out.clone()))
        return out

    def run():
        gen = torch.Generator(device="cuda").manual_seed(SAMPLE_SEED)
        return tgen.greedy_decode(
            model, ids_t, emb, starts, pad_lens=pads_t,
            max_new_tokens=SERVE_STEPS, eos_id=cfg.tokens.eos,
            early_exit=False, generator=gen, **SAMPLING)[0]

    tgen.next_tokens = recording
    try:
        first, ms = _timed(torch, run)
        recorded = list(picks)
        second = run()
    finally:
        tgen.next_tokens = pick
    if not torch.equal(first, second):
        raise PhaseError("sampling: the same seed gave other tokens")
    outside = sum(int((~torch.isfinite(tgen.filter_logits(
        l, **SAMPLING))).gather(1, t[:, None]).sum()) for _, l, t in recorded)
    if outside or len(recorded) != SERVE_STEPS + 1:
        raise PhaseError(f"sampling: {outside} picks outside their step's "
                         f"filtered support ({len(recorded)} steps)")
    cpu_gen = torch.Generator().manual_seed(SAMPLE_SEED)
    held = skipped = 0
    for step, logits, _ in recorded:
        g = tgen.gumbel_noise(logits.shape, cpu_gen, "cpu")
        keep = _nucleus_margins(torch, logits, **SAMPLING) > NUCLEUS_MARGIN
        got = [tgen.next_tokens(x, step, _noise=lambda s: g, **SAMPLING)
               for x in (logits, logits.cpu())]
        masks = [torch.isfinite(tgen.filter_logits(x, **SAMPLING)).cpu()
                 for x in (logits, logits.cpu())]
        if not (torch.equal(got[0].cpu()[keep], got[1][keep])
                and torch.equal(masks[0][keep], masks[1][keep])):
            raise PhaseError(f"sampling step {step}: the card's filter or "
                             f"draw differs from the CPU's: tokens "
                             f"{got[0].tolist()} vs {got[1].tolist()}")
        held += int(keep.sum())
        skipped += int((~keep).sum())
    if held < skipped:
        raise PhaseError(f"sampling: only {held} rows held card vs CPU")
    kept = [int(torch.isfinite(tgen.filter_logits(l, **SAMPLING)).sum(-1)
                .max()) for _, l, _ in recorded]
    say(9, f"sampling {SAMPLING}, seed {SAMPLE_SEED}, 2 x {ids.shape[1]}-"
           f"token prompts, {SERVE_STEPS} new tokens: {ms:.1f} ms; the same "
           f"seed twice identical; every pick in its filtered support (at "
           f"most {max(kept)} tokens kept a step); card filter and draw "
           f"equal the CPU's on {held} rows of the recorded logits with the "
           f"same noise ({skipped} rows within {NUCLEUS_MARGIN} of top_p "
           f"not held) on {gpu}")


def _serve_beams(torch, gpu, model, cfg, tok, emb):
    """beam_decode on the two prompts: num_beams=1 bit-equal to
    greedy_decode; num_beams=4 the same ids and scores with early_exit on
    and off; ms per step and peak memory."""
    from grove_tpu_torch.infer.beam import beam_decode
    from grove_tpu_torch.infer.generate import greedy_decode
    from grove_tpu_torch.infer.sliding import center_prompts
    from grove_tpu_torch.models.llama import init_kv_caches
    ids, starts, pads = center_prompts(cfg, tok, list(PROMPTS))
    kw = dict(max_new_tokens=SERVE_STEPS, eos_id=cfg.tokens.eos,
              pad_lens=torch.from_numpy(pads).to("cuda"))
    ids_t = torch.from_numpy(ids).to("cuda")
    greedy = greedy_decode(model, ids_t, emb, starts, early_exit=False,
                           **kw)[0]
    one = beam_decode(model, ids_t, emb, starts, num_beams=1, **kw)[0]
    if not torch.equal(one, greedy):
        raise PhaseError(f"beams: num_beams=1 {one.tolist()} differs from "
                         f"greedy_decode {greedy.tolist()}")
    with torch.inference_mode():
        caches = init_kv_caches(cfg.llama, 2, ids.shape[1],
                                device="cuda", dtype=torch.bfloat16)
        _, ms_prefill = _timed(torch, lambda: model.prefill(
            ids_t, emb, starts, caches, kw["pad_lens"]))
        del caches
    torch.cuda.reset_peak_memory_stats()
    (a_ids, _, a_scores), ms = _timed(torch, lambda: beam_decode(
        model, ids_t, emb, starts, num_beams=4, early_exit=True, **kw))
    peak = torch.cuda.max_memory_allocated()
    b_ids, _, b_scores = beam_decode(model, ids_t, emb, starts, num_beams=4,
                                     early_exit=False, **kw)
    if not (torch.equal(a_ids, b_ids) and torch.equal(a_scores, b_scores)):
        raise PhaseError("beams: early_exit on and off differ")
    if not bool(torch.isfinite(a_scores).all()):
        raise PhaseError(f"beams: scores {a_scores.tolist()}")
    say(9, f"beam search, 2 clips x 4 beams, bf16 cache, {SERVE_STEPS} "
           f"steps: num_beams=1 bit-equal to greedy_decode; num_beams=4 "
           f"identical with early_exit on and off; {ms:.1f} ms, "
           f"{(ms - ms_prefill) / SERVE_STEPS:.2f} ms per step net of the "
           f"{ms_prefill:.1f} ms prefill; peak {peak / 2**30:.2f} GiB; "
           f"scores {[round(float(s), 4) for s in a_scores[:, 0]]} on {gpu}")


def _engine_requests(torch, cfg, tok, emb, img):
    """SERVE_REQUESTS requests over the clips and the two PROMPTS: each its
    unpadded center prompt, video start, video tokens and SAM embeddings."""
    from grove_tpu_torch.infer.sliding import center_prompts
    nf, n = cfg.num_frames, emb.shape[0]
    reqs = []
    for r in range(SERVE_REQUESTS):
        ids, starts, _ = center_prompts(cfg, tok, [PROMPTS[r % 2]])
        c = r % n
        reqs.append({"ids": ids[0], "vstart": int(starts[0]),
                     "ve": emb[c:c + 1], "img": img[c * nf:(c + 1) * nf]})
    return reqs


def _run_engine(torch, eng, reqs):
    """The staggered schedule: 2 admitted, 2 more after SERVE_STAGGER
    ticks, the rest as slots free. Returns each request's result and the
    logits its tokens came from (the prefill's, then its ticks'), the
    launches, the tick times and the admissions' times."""
    from grove_tpu_torch import _kernels
    logits = {r: [] for r in range(len(reqs))}
    slot_of, pending = {}, list(range(len(reqs)))
    tick_ms, admit_ms = [], []
    _kernels.reset_launch_counts()
    with _lm_head_outputs(eng.model) as outs:
        def admit(n):
            for _ in range(n):
                r = pending.pop(0)
                q = reqs[r]
                slot, ms = _timed(torch, lambda: eng.admit(
                    r, q["ids"], q["ve"], q["vstart"], q["img"]))
                admit_ms.append(ms)
                slot_of[slot] = r
                logits[r].append(outs[-1][0, -1].float())

        def tick():
            before = {s: r for s, r in slot_of.items()
                      if eng._slots[s].active}
            done, ms = _timed(torch, eng.tick)
            tick_ms.append(ms)
            for s, r in before.items():
                logits[r].append(outs[-1][s, -1].float())
            return done

        admit(2)
        for _ in range(SERVE_STAGGER):
            tick()
        admit(2)
        while pending or eng.active():
            if pending and eng.can_admit(-(-len(reqs[pending[0]]["ids"])
                                           // eng.bucket) * eng.bucket):
                admit(1)
                continue
            if not eng.active():
                raise PhaseError("engine: idle with requests pending")
            tick()
    launches = {k: v.launches for k, v in _kernels.KERNELS.items()}
    results = {r: eng.pop_result(r) for r in range(len(reqs))}
    return results, logits, launches, tick_ms, admit_ms


def _offline_logits(torch, model, cfg, q, max_new, cache_dtype):
    """An offline greedy_decode of one request at batch 1 (its unpadded
    prompt): its tokens and the logits each came from."""
    from grove_tpu_torch.infer.generate import greedy_decode
    with _lm_head_outputs(model) as outs:
        gen, _ = greedy_decode(model, q["ids"][None], q["ve"], [q["vstart"]],
                               max_new_tokens=max_new, eos_id=cfg.tokens.eos,
                               cache_dtype=cache_dtype, early_exit=False)
    return gen[0].cpu().numpy(), [o[0, -1].float() for o in outs]


def _divergence(torch, eng_tok, eng_logits, off_tok, off_logits, label):
    """The engine's tokens against the offline ones up to the first that
    differs: every logit of both runs finite; up to and at it, logits
    within SERVE_LOGIT_TOL of the offline max-abs; at it, also the offline
    top-two gap at most twice the max-abs logit difference. Returns
    (tokens equal, the worst relative logit difference up to there)."""
    for name, rows in (("engine", eng_logits), ("offline", off_logits)):
        bad = [j for j, row in enumerate(rows)
               if not bool(torch.isfinite(row).all())]
        if bad:
            raise PhaseError(f"{label}: {name} logits not finite at steps "
                             f"{bad}")
    worst = 0.0
    for j, (e, o) in enumerate(zip(eng_tok, off_tok)):
        diff = float((eng_logits[j] - off_logits[j]).abs().max())
        rel = diff / max(float(off_logits[j].abs().max()), 1e-30)
        worst = max(worst, rel)
        if rel > SERVE_LOGIT_TOL:
            raise PhaseError(f"{label}: step {j} logits {rel:.3g} of max-abs "
                             f"off the offline decode's (limit "
                             f"{SERVE_LOGIT_TOL})")
        if e != o:
            top2 = torch.topk(off_logits[j], 2).values
            gap = float(top2[0] - top2[1])
            if gap > 2 * diff:
                raise PhaseError(f"{label}: token {j} is {e}, offline {o}, "
                                 f"with an offline top-two gap {gap:.4g} > 2 "
                                 f"x the logit difference {diff:.4g}")
            return j, worst
    return len(eng_tok), worst


def _serve_engine(torch, gpu, model, cfg, tok, emb, img, cache_dtype,
                  exact=False, max_new=64):
    """The continuous engine at n_slots=4 and the default capacity on the
    staggered schedule, each request held to an offline greedy_decode;
    with an int8 cache, the exact launches of its route."""
    from grove_tpu_torch.serve.continuous import ContinuousEngine
    label = (f"continuous engine ({cfg.llama.hidden_size}-wide, "
             f"{str(cache_dtype).split('.')[-1]} cache)")
    reqs = _engine_requests(torch, cfg, tok, emb, img)
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousEngine(model, cfg, n_slots=SERVE_SLOTS,
                           max_new_tokens=max_new, cache_dtype=cache_dtype)
    results, logits, launches, tick_ms, admit_ms = _run_engine(torch, eng,
                                                               reqs)
    peak = torch.cuda.max_memory_allocated()
    capacity, start = eng.capacity, eng.start_col
    del eng
    full = prefix = 0
    worst = 0.0
    for r, q in enumerate(reqs):
        res = results[r]
        boxes = None if res is None else res["pred_boxes"]
        if boxes is None or boxes.shape != (
                cfg.num_frames, cfg.max_phrases, 4) or not np.all(
                np.isfinite(boxes)):
            raise PhaseError(f"{label}: request {r}: boxes "
                             f"{None if boxes is None else boxes.shape}, "
                             "or not finite")
        off_tok, off_logits = _offline_logits(torch, model, cfg, q, max_new,
                                              cache_dtype)
        n, w = _divergence(torch, res["generated_ids"].tolist(), logits[r],
                           off_tok.tolist(), off_logits, f"{label} request "
                           f"{r}")
        worst = max(worst, w)
        full += n == res["steps"]
        prefix += n
        if exact and n != res["steps"]:
            raise PhaseError(f"{label}: request {r} leaves the offline "
                             f"tokens at step {n}")
    tokens = sum(results[r]["steps"] for r in range(len(reqs)))
    if full < SERVE_MIN_FULL or prefix < SERVE_MIN_EQUAL * tokens:
        raise PhaseError(f"{label}: {full} of {len(reqs)} requests equal the "
                         f"offline decode in full (at least {SERVE_MIN_FULL})"
                         f", {prefix} of {tokens} tokens in the equal "
                         f"prefixes (at least {SERVE_MIN_EQUAL:.0%})")
    ticks = len(tick_ms)
    if cache_dtype == torch.int8:
        _check_engine_launches(launches, cfg, len(reqs), ticks, label)
    used = {k: v for k, v in launches.items() if v}
    say(9, f"{label}: {len(reqs)} requests on {SERVE_SLOTS} slots, capacity "
           f"{capacity} (start column {start}), {len(admit_ms)} admissions "
           f"{statistics.median(admit_ms):.1f} ms median, {ticks} ticks "
           f"{statistics.median(tick_ms):.2f} ms median "
           f"({sum(tick_ms) / ticks:.2f} mean); {full} of {len(reqs)} "
           f"requests equal the offline greedy_decode in full ({prefix} of "
           f"{tokens} tokens in the equal prefixes; logits up to a "
           f"divergence within "
           f"{worst:.2e} of max-abs); peak {peak / 2**30:.2f} GiB; launches "
           f"{used} on {gpu}")
    return launches


def _check_engine_launches(launches, cfg, admissions, ticks, label):
    """The int8-cache route: K5's tensor-core entry in each LLaMA layer of
    each admission's prefill (its 640-token bucket), K6 in each layer of
    each tick, no SIMT entry and no off-path kernel."""
    nl = cfg.llama.num_layers
    want = {"prefill_attention_tc": nl * admissions, "prefill_attention": 0,
            "int8_decode_attention": nl * ticks}
    got = {k: launches[k] for k in want}
    simt = {k: launches[k] for k in SIMT_ENTRIES + OFF_PATH_KERNELS
            if launches[k]}
    if got != want or simt:
        raise PhaseError(f"{label}: launches {got}, want {want}; SIMT or "
                         f"off-path entries {simt}")


def _serve_small(torch, gpu):
    """GroveConfig.small() in fp32, TF32 off: beam search card vs CPU
    (identical ids, scores within BEAM_SCORE_REL), and the continuous
    engine's tokens all equal to offline greedy_decode on the card."""
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.infer.beam import beam_decode
    from grove_tpu_torch.infer.sliding import center_prompts
    from grove_tpu_torch.models.grove import init_grove_params
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GroveConfig.small()
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    cpu = init_grove_params(cfg, device="cpu", dtype=torch.float32,
                            seed=5).eval()
    card = copy.deepcopy(cpu).to("cuda")
    clips = _synthetic_clips(cfg, 3, cfg.num_frames, seed=10)
    with torch.inference_mode():
        emb, _ = cpu.encode_video(torch.from_numpy(np.stack(
            [c["frames_clip"] for c in clips])))
        img = cpu.encode_grounding_auto(torch.from_numpy(np.stack(
            [c["frames_sam"] for c in clips])))
    ids, starts, pads = center_prompts(cfg, tok, list(PROMPTS))
    kw = dict(max_new_tokens=SMALL_NEW, eos_id=cfg.tokens.eos, num_beams=4,
              pad_lens=pads, cache_dtype=cpu.dtype)
    want = beam_decode(cpu, ids, emb[:2], starts, **kw)
    got = beam_decode(card, ids, emb[:2].to("cuda"), starts, **kw)
    rel = float(((got[2].cpu() - want[2]).abs()
                 / want[2].abs().clamp_min(1e-30)).max())
    if not torch.equal(got[0].cpu(), want[0]) or rel > BEAM_SCORE_REL:
        raise PhaseError(f"small() fp32 beams: ids {got[0].tolist()} vs "
                         f"{want[0].tolist()}, scores {rel:.2e} relative")
    say(9, f"GroveConfig.small() fp32 beam search (2 clips x 4 beams, "
           f"{SMALL_NEW} steps) card vs CPU: ids identical, scores within "
           f"{rel:.2e} relative (limit {BEAM_SCORE_REL}) on {gpu}")
    _serve_engine(torch, gpu, card, cfg, tok, emb.to("cuda"),
                  img.to("cuda"), torch.float32, exact=True,
                  max_new=SMALL_NEW)


class _RecordingProcessor:
    """A GroveProcessor whose generate_batch calls are kept (paths,
    instructions, knobs), so that each can be repeated directly."""

    def __init__(self, proc):
        self.proc, self.cfg, self.calls = proc, proc.cfg, []

    def generate_batch(self, model, paths, instructions=None, **kw):
        self.calls.append((list(paths), instructions, dict(kw)))
        return self.proc.generate_batch(model, paths,
                                        instructions=instructions, **kw)

    def __getattr__(self, name):
        return getattr(self.proc, name)


def _post_json(base, payload, timeout=600):
    import urllib.request
    req = urllib.request.Request(
        f"{base}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class _Front:
    """One engine behind a GroveServer on 127.0.0.1:0. `call` returns
    (status, body)."""

    def __init__(self, engine, name):
        import threading

        from grove_tpu_torch.serve.server import GroveServer
        self.engine = engine
        try:
            self.server = GroveServer(("127.0.0.1", 0), engine, name)
        except BaseException:
            engine.close()
            raise
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        host, port = self.server.server_address[:2]
        self.base = f"http://{host}:{port}"

    def health(self):
        import urllib.request
        with urllib.request.urlopen(f"{self.base}/healthz",
                                    timeout=60) as r:
            return json.loads(r.read())

    def call(self, payload):
        import urllib.error
        try:
            return 200, _post_json(self.base, payload)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(60)
        self.engine.close()


def _concurrent(calls):
    """Run the callables in threads started together; their results."""
    import threading
    out = [None] * len(calls)

    def run(i):
        try:
            out[i] = calls[i]()
        except Exception as e:                      # noqa: BLE001
            out[i] = e
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if any(t.is_alive() for t in threads):
        raise PhaseError("HTTP: a request thread did not finish")
    errors = [r for r in out if isinstance(r, Exception)]
    if errors:
        raise PhaseError(f"HTTP: {errors[0]!r}")
    return out


def _serve_http(torch, gpu, model, cfg, tok):
    """`serve(...)` with GroveProcessor(decoder_factory=open_video) over two
    24-frame 640 x 360 .npy clips: /healthz, then four concurrent
    /generate posts in three knob groups (two greedy, one sampled with a
    seed, one with num_beams=2), each response equal to generate_batch
    over its group called directly; then ContinuousService behind a second
    server: three concurrent greedy posts and a 400 for temperature."""
    from grove_tpu_torch.api import GroveProcessor
    from grove_tpu_torch.data.synthetic import clip_frames
    from grove_tpu_torch.data.video import open_video, write_npy_clip
    from grove_tpu_torch.serve.continuous import ContinuousService
    from grove_tpu_torch.serve.server import (_KNOBS, BatchingEngine,
                                              _jsonable)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(2):
            p = str(Path(tmp) / f"serve{i}.npy")
            write_npy_clip(p, clip_frames(HTTP_FRAMES, 640, 360,
                                          np.random.default_rng(30 + i)),
                           5.0)
            paths.append(p)
        proc = GroveProcessor(tok, cfg, decoder_factory=open_video)
        rec = _RecordingProcessor(proc)
        front = _Front(BatchingEngine(rec, model, max_batch=4,
                                      batch_timeout_ms=3000.0),
                       "grove-full")
        try:
            if front.health()["status"] != "ok":
                raise PhaseError("HTTP: /healthz")
            payloads = [
                {"video_path": paths[0], "max_new_tokens": SERVE_STEPS},
                {"video_path": paths[1], "instruction": PROMPTS[1],
                 "max_new_tokens": SERVE_STEPS},
                {"video_path": paths[0], "max_new_tokens": SERVE_STEPS,
                 "seed": 5, **SAMPLING},
                {"video_path": paths[1], "max_new_tokens": SERVE_STEPS,
                 "num_beams": 2}]
            before = front.engine.batches_run
            replies, ms = _timed(torch, lambda: _concurrent(
                [lambda p=p: front.call(p) for p in payloads]))
            batches = front.engine.batches_run - before
            for p, (code, body) in zip(payloads, replies):
                if code != 200:
                    raise PhaseError(f"HTTP: {code} {body} for {p}")
                _check_output(body, CLIP_KEYS, HTTP_FRAMES, f"HTTP {p}")
            if batches != 3 or len(rec.calls) != 3:
                raise PhaseError(f"HTTP: {batches} batches, {len(rec.calls)} "
                                 "generate_batch calls, not 3")
            held = 0
            for call_paths, instructions, kw in rec.calls:
                direct = proc.generate_batch(model, call_paths,
                                             instructions=instructions, **kw)
                for i, path in enumerate(call_paths):
                    ins = instructions[i] if instructions else None
                    for p, (_, body) in zip(payloads, replies):
                        knobs = {k: p[k] for k in _KNOBS
                                 if k != "instruction" and k in p}
                        if (p["video_path"], p.get("instruction"),
                                knobs) != (path, ins, kw):
                            continue
                        if json.loads(json.dumps(_jsonable(direct[i]))) \
                                != body:
                            raise PhaseError(f"HTTP: the response to {p} "
                                             "differs from generate_batch "
                                             "called directly")
                        held += 1
            if held != len(payloads):
                raise PhaseError(f"HTTP: {held} responses matched a group")
            say(9, f"batch engine (HTTP on 127.0.0.1): /healthz ok; 4 concurrent "
                   f"/generate posts ({HTTP_FRAMES}-frame 640 x 360 .npy "
                   f"clips, {SERVE_STEPS} new tokens: two greedy, one sampled "
                   f"with a seed, one with 2 beams) in {ms:.1f} ms as "
                   f"{batches} batches, each response equal to generate_batch "
                   f"over its group called directly; captions "
                   f"{[b['text'][:30] for _, b in replies]} on {gpu}")
        finally:
            front.close()

        front = _Front(ContinuousService(proc, model, n_slots=SERVE_SLOTS),
                       "grove-full-continuous")
        try:
            payloads = [{"video_path": paths[0]},
                        {"video_path": paths[1], "instruction": PROMPTS[1]},
                        {"video_path": paths[1]}]
            replies, ms = _timed(torch, lambda: _concurrent(
                [lambda p=p: front.call(p) for p in payloads]))
            for p, (code, body) in zip(payloads, replies):
                if code != 200:
                    raise PhaseError(f"continuous HTTP: {code} {body}")
                _check_output(body, CLIP_KEYS, HTTP_FRAMES,
                              f"continuous HTTP {p}")
            code, body = front.call({"video_path": paths[0],
                                     "temperature": 0.7})
            if code != 400:
                raise PhaseError(f"continuous HTTP: temperature gave {code}")
            served = front.engine.requests_served
            say(9, f"ContinuousService (HTTP on 127.0.0.1, {SERVE_SLOTS} slots, 64 new "
                   f"tokens): 3 concurrent greedy posts in {ms:.1f} ms, "
                   f"{served} served, {front.engine.batches_run} ticks; "
                   f"temperature rejected with {code} on {gpu}")
        finally:
            front.close()



# ---------------------------------------------------------------------------
# phase 10: the task drivers and the evals
# ---------------------------------------------------------------------------

INFER_TASKS = ("iground", "vidstg", "groundingyoutube",
               "youcookinteractions", "anet")
# the synthetic sets' makers' arguments at full width: iground 8 clips of
# 16 frames, two groups of 4, so that the prefetch thread loads and
# uploads the second group while the first generates; the others the
# makers' defaults (vidstg 2 clips of 23 frames in their tubes, the
# pointing tasks 2 clips of 20 frames, anet 2 segments of 10 frames)
INFER_SETS = {"iground": {"num_videos": 8}}
# and for the small() fp32 card-vs-CPU runs, whose CPU side takes most of
# their time: fewer and shorter clips (iground one group of 4 clips of 8
# frames, vidstg 11 frames, the pointing tasks 10; anet's 10 frames are
# the task's)
INFER_SMALL_SETS = {"iground": {"num_videos": 4, "num_frames": 8},
                    "vidstg": {"num_frames": 12},
                    "groundingyoutube": {"num_frames": 10},
                    "youcookinteractions": {"num_frames": 10}}
INFER_SMALL_NEW = 16     # new tokens of the small() fp32 card-vs-CPU runs
# the entries of each task's pickle (`grove_tpu/infer/drivers.py`; held to
# the JAX driver's by tests/test_torch_drivers.py)
INFER_ENTRY_KEYS = {
    "iground": {"pred_bboxes", "pred_labels", "pred_phrases", "pred_text",
                "pred_text_tagged", "probs_temp_objectness", "original_size",
                "frame_indices"},
    "vidstg": {"frame_ids", "boxes", "qtype"},
    "groundingyoutube": {"pts_to_bbox", "final_boxes", "selected_pts"},
    "youcookinteractions": {"pts_to_bbox", "final_boxes", "selected_pts"},
    "anet": {"clss", "idx_in_sent", "bbox_for_all_frames", "pred_text"},
}
# the metrics the evals return for each task (`evals/run_iground.py`,
# `evals/run_all.py`; held to the JAX evals' by tests/test_torch_evals.py);
# SPICE is None by design (no CoreNLP), the *_variant and backend entries
# are labels
INFER_METRICS = {
    "iground": {"AP", "AP50", "AP75", "AP_video", "mIoU_flatten",
                "mIoU_video", "recall_flatten", "recall_video", "Bleu_1",
                "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr", "METEOR",
                "METEOR_exact_stem", "METEOR_variant", "SPICE", "SPICE_rule",
                "SPICE_variant", "text_sim_backend"},
    "vidstg": {f"{q}_gt_viou{t}" for q in ("declarative", "interrogative")
               for t in ("", "@0.3", "@0.5")},
    "groundingyoutube": {"pointing_accuracy", "correct", "valid"},
    "youcookinteractions": {"pointing_accuracy", "correct", "valid"},
    "anet": {"localization_accuracy", "num_classes", "precision_all",
             "recall_all", "f1_all"},
}
INFER_LABELS = ("SPICE", "METEOR_variant", "SPICE_variant",
                "text_sim_backend")


def _infer_sets(root, makers):
    """The port's synthetic set of each task under `root` (`.npy` clips),
    its maker given `makers[task]`: {task: (annotations, video dir, frame
    timestamps or None, the pointing ground truth's pickle or None)}."""
    from grove_tpu_torch.infer.drivers import make_synthetic
    sets = {}
    for task in INFER_TASKS:
        sub = os.path.join(root, task)
        os.makedirs(sub)
        ann, videos, fts, gt = make_synthetic(task, sub,
                                              **makers.get(task, {}))
        gt_path = None
        if gt is not None:
            gt_path = os.path.join(sub, "pointing_gt.pkl")
            with open(gt_path, "wb") as f:
                pickle.dump(gt, f)
        sets[task] = (ann, videos, fts, gt_path)
    return sets


def _infer_argv(task, sets, out, device, size="full", extra=()):
    ann, videos, fts, _ = sets[task]
    argv = ["--task", task, "--model_size", size, "--ann_dir", ann,
            "--video_dir", videos, "--output", out, "--device", device]
    if fts:
        argv += ["--frame_timestamps", fts]
    return argv + list(extra)


class _InferSpy:
    """Wrap `infer.drivers.build_model` for driver runs: hand the driver
    `pick(cfg, device)`'s model instead of building one, record every
    call of that model's stages (CLIP, SAM, the cache-free LLaMA pass with
    its S, the prefill with its S and cache, each decode step), and set
    every launch count to 0 just before the driver's inference starts."""

    def __init__(self, torch, pick):
        self.torch, self.pick = torch, pick
        self.calls, self.model, self.cfg = [], None, None

    def __enter__(self):
        from grove_tpu_torch.infer import drivers
        self._drivers, self._real = drivers, drivers.build_model
        drivers.build_model = self._build
        return self

    def __exit__(self, *exc):
        self._drivers.build_model = self._real
        if self.model is not None:
            for name in ("encode_video", "encode_grounding", "_lm_hidden",
                         "prefill", "decode_step"):
                self.model.__dict__.pop(name, None)

    def _build(self, args, cfg, device):
        from grove_tpu_torch import _kernels
        model = self.pick(cfg, device)
        if model.cfg != cfg:
            raise PhaseError(f"the driver asked for {cfg}, not the model's "
                             f"{model.cfg}")
        self.model, self.cfg, calls = model, cfg, self.calls

        def record(name, tag):
            real = getattr(model, name)

            def call(*a, **kw):
                calls.append(tag(*a, **kw))
                return real(*a, **kw)
            model.__dict__[name] = call
        record("encode_video", lambda *a, **k: ("clip",))
        record("encode_grounding", lambda *a, **k: ("sam",))
        record("_lm_hidden", lambda ids, *a, **k: ("lm", ids.shape[1]))
        record("prefill", lambda ids, emb, vs, caches, *a, **k: (
            "prefill", ids.shape[1], "k_s" in caches[0]))
        record("decode_step", lambda tok, pos, caches, *a, **k: (
            "decode", "k_s" in caches[0]))
        if device.type == "cuda":
            self.torch.cuda.synchronize()
            self.torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        return model


def _infer_launches(cfg, calls):
    """The launches the recorded stage calls make at full width in bf16,
    by the routes the port takes (JAX's): CLIP's self-attention on K3, 4
    global and 28 windowed SAM blocks on K2 and K1, a cache-free LLaMA pass
    (teacher-forced windows) on K4 where S is a multiple of 64 (a flash
    block divides it), on K5 where S % 8 == 0 and 128 <= S <= 1100
    otherwise, else on K10 (`models/llama.py:228-236`,
    `ops.attention.attention_route`); a prefill over the int8 cache on K5
    where S % 8 == 0 and 128 <= S <= 1100 (else the plain path), each
    decode step over it on K6; a bf16 cache's prefill and decode take the
    plain path. Every count is per layer."""
    from collections import Counter
    n_global = len(cfg.sam_enc.global_attn_indexes)
    layers = cfg.llama.num_layers
    want = Counter()

    def k5_takes(s):
        return s % 8 == 0 and 128 <= s <= 1100
    for call in calls:
        if call[0] == "clip":
            want["grouped_plain_attention_tc"] += cfg.clip.num_layers
        elif call[0] == "sam":
            want["sam_window_attention_tc"] += cfg.sam_enc.depth - n_global
            want["sam_global_attention_tc"] += n_global
        elif call[0] == "lm":
            s = call[1]
            if s % 64 == 0 and s >= 128:
                want["flash_forward_lse_tc"] += layers
            elif k5_takes(s):
                want["prefill_attention_tc"] += layers
            elif s >= 128:
                want["flash_attention_tc"] += layers
        elif call[0] == "prefill" and call[2] and k5_takes(call[1]):
            want["prefill_attention_tc"] += layers
        elif call[0] == "decode" and call[1]:
            want["int8_decode_attention"] += layers
    return want


def _frames_of(task, preds, uid):
    """The frame count of one entry of a task's predictions."""
    entry = preds[uid]
    if task == "iground":
        return len(entry["frame_indices"])
    if task == "vidstg":
        return len(entry["frame_ids"])
    if task == "anet":
        return 10
    return len(entry["pts_to_bbox"])


def _check_preds(task, preds, makers, what):
    """The pickle's entries carry the JAX driver's keys; every box and
    probability is finite; one entry per clip of the set (each maker
    writes 2 clips by default, iground's 4)."""
    entries = ([e for segs in preds.values() for e in segs.values()]
               if task == "anet" else list(preds.values()))
    want_n = makers.get(task, {}).get("num_videos",
                                      4 if task == "iground" else 2)
    if len(entries) != want_n:
        raise PhaseError(f"{what}: {len(entries)} entries, not {want_n}")
    for e in entries:
        if set(e) != INFER_ENTRY_KEYS[task]:
            raise PhaseError(f"{what}: keys {sorted(e)}")
        for key in ("pred_bboxes", "probs_temp_objectness", "boxes",
                    "final_boxes", "bbox_for_all_frames"):
            for a in e.get(key, []):
                if not np.all(np.isfinite(np.asarray(a, np.float64))):
                    raise PhaseError(f"{what}: non-finite {key}")
        for a in e.get("pts_to_bbox", {}).values():
            if not np.all(np.isfinite(np.asarray(a, np.float64))):
                raise PhaseError(f"{what}: non-finite pts_to_bbox")
    return entries


def _same_preds(got, want, tol, where, boxes=False):
    """Equal structure and values; floats and arrays within `tol`, boxes
    (under a key naming them) within `tol` of their array's largest
    coordinate (about the frame's side, at least 1), everything else equal.
    Returns the largest difference seen over its limit's unit."""
    worst = 0.0
    if isinstance(want, dict):
        if list(got) != list(want):
            raise PhaseError(f"{where}: keys {list(got)} != {list(want)}")
        for k in want:
            worst = max(worst, _same_preds(
                got[k], want[k], tol, f"{where}/{k}",
                boxes or k in ("pred_bboxes", "boxes", "final_boxes",
                               "pts_to_bbox", "bbox_for_all_frames")))
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise PhaseError(f"{where}: {len(got)} != {len(want)} items")
        for i, (g, w) in enumerate(zip(got, want)):
            worst = max(worst, _same_preds(g, w, tol, f"{where}[{i}]",
                                           boxes))
    elif isinstance(want, (np.ndarray, float, np.floating)):
        g, w = (np.asarray(x, np.float64) for x in (got, want))
        if g.shape != w.shape:
            raise PhaseError(f"{where}: shape {g.shape} != {w.shape}")
        if not g.size:
            return 0.0
        scale = max(1.0, float(np.abs(w).max())) if boxes else 1.0
        err = float(np.abs(g - w).max()) / scale
        if not err <= tol:
            raise PhaseError(f"{where}: card vs CPU {err:.3e} > {tol:.3e}"
                             f" (of {scale:.4g})")
        worst = err
    elif got != want:
        raise PhaseError(f"{where}: {got!r} != {want!r}")
    return worst


def phase_infer(torch, gpu):
    """The task drivers and the evals. Returns the full-width runs'
    launches, {task: {kernel: launches}} (iground's int8-cache run as
    "iground_int8"), and the full-width bf16 model they ran on (phase 11
    reuses it)."""
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="grove_infer_"))
    try:
        launches, model = _infer_full(torch, gpu, _infer_sets(
            str(tmp / "sets"), INFER_SETS), tmp)
        torch.cuda.empty_cache()
        _infer_small(torch, gpu, _infer_sets(str(tmp / "small_sets"),
                                             INFER_SMALL_SETS), tmp)
        _infer_experiment(torch, gpu, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(10, f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return launches, model


def _infer_full(torch, gpu, sets, tmp):
    """GroveConfig() in bf16, built once on the card: every task through
    `infer.drivers.main`, then iground with the int8 cache; the launches
    each run makes equal `_infer_launches` of its recorded stage calls;
    iground's prefetched outputs bit-equal to inline `infer_clips_batched`
    calls on the same groups; each pickle scored by the evals. Returns
    (launches by run, the model)."""
    from grove_tpu_torch.infer import drivers
    build, built = drivers.build_model, {}

    def pick(cfg, device):
        if "model" not in built:
            t0 = time.perf_counter()
            built["model"] = build(
                argparse.Namespace(model_size="full", seed=0, version=None),
                cfg, device)
            say(10, f"GroveConfig() bf16 built on the card from a seed in "
                    f"{time.perf_counter() - t0:.1f} s")
        return built["model"]

    out = {}
    runs = [(t, t, ()) for t in INFER_TASKS]
    runs.append(("iground_int8", "iground", ("--kv_cache_dtype", "int8")))
    for label, task, extra in runs:
        path = str(tmp / f"{label}.pkl")
        with _InferSpy(torch, pick) as spy:
            t0 = time.perf_counter()
            preds = drivers.main(_infer_argv(task, sets, path, "cuda",
                                             extra=extra))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        from grove_tpu_torch import _kernels
        got = {k: v.launches for k, v in _kernels.KERNELS.items()
               if v.launches}
        peak = torch.cuda.max_memory_allocated()
        with open(path, "rb") as f:
            if pickle.load(f).keys() != preds.keys():
                raise PhaseError(f"{label}: the pickle is not the run's")
        entries = _check_preds(task, preds, INFER_SETS, f"driver {label}")
        want = dict(_infer_launches(spy.cfg, spy.calls))
        if got != want:
            raise PhaseError(f"driver {label}: launches {got}, not the "
                             f"stage calls' {want}")
        from collections import Counter
        calls = Counter(c[0] for c in spy.calls)
        lm = sorted({c[1] for c in spy.calls if c[0] in ("lm", "prefill")})
        frames = sum(_frames_of(task, preds, u) for u in preds)
        say(10, f"driver --task {task} --model_size full"
                f"{' ' + ' '.join(extra) if extra else ''}: {len(entries)} "
                f"clips, {frames} frames in {secs:.2f} s "
                f"({len(entries) / secs:.3f} clips/s), peak "
                f"{peak / 2**30:.2f} GiB; stage calls {dict(calls)} at S "
                f"{lm}; launches {got} (= the calls' routes); captions "
                f"{[e.get('pred_text', '')[:40] for e in entries][:2]} on "
                f"{gpu}")
        out[label] = got
        if label == "iground":
            _infer_inline(torch, gpu, spy.model, spy.cfg, sets, preds)
        _infer_eval(task, sets, path, gpu)
    return out, built["model"]


def _infer_inline(torch, gpu, model, cfg, sets, preds):
    """iground's groups run again, each in one inline `infer_clips_batched`
    call (no prefetch thread, no side stream): every output bit-equal to
    the prefetched run's."""
    from grove_tpu_torch.api.processor import _decode_kwargs
    from grove_tpu_torch.infer.drivers import FullClipIGroundDataset
    from grove_tpu_torch.infer.sliding import infer_clips_batched
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    ann, videos, _, _ = sets["iground"]
    ds = FullClipIGroundDataset(ann, videos, cfg)
    tok = MockTokenizer(model_max_length=cfg.max_seq_len)
    t0 = time.perf_counter()
    for g in range(0, len(ds), 4):
        samples = [ds[i] for i in range(g, min(g + 4, len(ds)))]
        outs = infer_clips_batched(
            model, cfg, tok, samples, max_new_tokens=64,
            decode_kwargs=_decode_kwargs(None, True, device=model.device))
        for s, o in zip(samples, outs):
            uid = f"{s['video_id']}_{s['clip_id']}"
            # tolerance 0: bit-equal (every value was checked finite)
            _same_preds(preds[uid], {
                "pred_bboxes": o["bboxes"],
                "pred_labels": o["labels_per_frame"],
                "pred_phrases": o["phrases"], "pred_text": o["text"],
                "pred_text_tagged": o["text_tagged"],
                "probs_temp_objectness": o["probs_temp_objectness"],
                "original_size": o["original_size"],
                "frame_indices": o["frame_indices"]}, 0.0,
                f"iground {uid}")
    torch.cuda.synchronize()
    say(10, f"iground: the prefetched run's {len(ds)} outputs bit-equal to "
            f"{-(-len(ds) // 4)} inline infer_clips_batched calls on the same "
            f"groups ({time.perf_counter() - t0:.2f} s) on {gpu}")


def _infer_eval(task, sets, path, gpu):
    """The task's pickle through the evals (`run_iground.main` for iground,
    `run_all.main` for the others): the metrics the JAX evals return, each
    number finite."""
    from grove_tpu_torch.evals import run_all, run_iground
    ann, videos, _, gt = sets[task]
    with contextlib.redirect_stdout(sys.stderr):
        if task == "iground":
            metrics = run_iground.main(["--ann_dir", ann, "--video_dir",
                                        videos, "--pred", path])
        elif task in ("vidstg", "anet"):
            metrics = run_all.main([task, "--ann", ann, "--pred", path])
        else:
            from grove_tpu_torch.infer.drivers import pointing_keys
            metrics = run_all.main(["pointing", "--ann", gt, "--pred", path,
                                    "--segment_key", pointing_keys(task)[0]])
    if set(metrics) != INFER_METRICS[task]:
        raise PhaseError(f"{task} evals: metrics {sorted(metrics)}")
    bad = [k for k, v in metrics.items() if k not in INFER_LABELS
           and not (isinstance(v, (int, float)) and math.isfinite(v))]
    if bad or metrics.get("SPICE", None) is not None:
        raise PhaseError(f"{task} evals: not finite {bad}")
    say(10, f"{task} scored by the port's evals: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in metrics.items() if k not in INFER_LABELS) + f" on {gpu}")


def _infer_small(torch, gpu, sets, tmp):
    """GroveConfig.small() in fp32 (TF32 off), one set of weights built on
    the CPU and deep-copied to the card: every task through
    `infer.drivers.main` on each, the pickles equal (token ids and text
    equal, boxes within PARITY_TOL of their largest coordinate, objectness
    within PARITY_TOL)."""
    from grove_tpu_torch.infer import drivers
    from grove_tpu_torch.models.grove import init_grove_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = {}

    def pick(cfg, device):
        if "cpu" not in built:
            built["cpu"] = init_grove_params(cfg, device="cpu",
                                             dtype=torch.float32, seed=21)
            built["cuda"] = copy.deepcopy(built["cpu"]).to("cuda")
        return built[device.type]

    extra = ("--max_new_tokens", str(INFER_SMALL_NEW))
    for task in INFER_TASKS:
        preds, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            with _InferSpy(torch, pick):
                preds[dev] = drivers.main(_infer_argv(
                    task, sets, str(tmp / f"small_{task}_{dev}.pkl"), dev,
                    "small", extra if task in ("iground", "anet") else ()))
            secs[dev] = time.perf_counter() - t0
        _check_preds(task, preds["cuda"], INFER_SMALL_SETS,
                     f"small {task} card")
        worst = _same_preds(preds["cuda"], preds["cpu"], PARITY_TOL,
                            f"small {task}")
        say(10, f"GroveConfig.small() fp32 --task {task}: card vs CPU "
                f"equal (text and ids), largest difference {worst:.2e} of "
                f"a box array's largest coordinate / of a probability "
                f"(limit {PARITY_TOL}); "
                f"card {secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s on "
                f"{gpu}")
    del built


def _infer_experiment(torch, gpu, tmp):
    """`tools.run_experiment.main` once at small() on the card (synthetic
    anet: infer, then the evals), and `python -m grove_tpu_torch.serve
    --help` in a subprocess."""
    from grove_tpu_torch.tools.run_experiment import main as run_experiment
    t0 = time.perf_counter()
    metrics = run_experiment(["--task", "anet", "--synthetic", "--model_size",
                              "small", "--device", "cuda", "--workdir",
                              str(tmp / "experiment"), "--max_new_tokens",
                              str(INFER_SMALL_NEW)])
    if set(metrics) != INFER_METRICS["anet"] or not all(
            math.isfinite(v) for v in metrics.values()):
        raise PhaseError(f"run_experiment anet: {metrics}")
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "grove_tpu_torch.serve",
                           "--help"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0 or "--model_size" not in proc.stdout:
        raise PhaseError(f"python -m grove_tpu_torch.serve --help: rc "
                         f"{proc.returncode}, {proc.stderr[-500:]}")
    say(10, f"run_experiment --task anet --synthetic --model_size small on "
            f"the card in {secs:.1f} s: {metrics}; python -m "
            f"grove_tpu_torch.serve --help rc 0 in "
            f"{time.perf_counter() - t0:.1f} s on {gpu}")


# ---------------------------------------------------------------------------
# phase 11: the region encoder, RoIAlign and the SAM mask path
# ---------------------------------------------------------------------------

REGION_FRAMES = 8
# normalized xyxy and frame of each RoI: the last but one straddles the
# image's right edge, the last lies partly outside the [-1, size] band of
# every level (224 / stride is 2/3 of each level's grid)
REGION_ROIS = (((0.10, 0.10, 0.45, 0.50), 0), ((0.30, 0.20, 0.90, 0.70), 1),
               ((0.05, 0.55, 0.40, 0.95), 2), ((0.50, 0.05, 0.95, 0.35), 3),
               ((0.20, 0.30, 0.60, 0.80), 4), ((0.60, 0.50, 0.98, 0.92), 5),
               ((0.85, 0.60, 1.10, 0.95), 6), ((1.30, -0.20, 1.70, 0.30), 7))
REGION_QUESTION = ("how do " + " and ".join(["<bbox>"] * len(REGION_ROIS))
                   + " move in the video")
# one CLIP call (K3 a layer), one SAM call (K1 28, K2 4) and one cache-free
# LLaMA pass at S a multiple of 64 (K4 32), as phase 10's `_infer_launches`
REGION_LAUNCHES = {"grouped_plain_attention_tc": 24,
                   "sam_window_attention_tc": 28,
                   "sam_global_attention_tc": 4, "flash_forward_lse_tc": 32}
ROI_CARD_TOL = 1e-5      # fp32 roi_align card vs CPU, of max-abs
# the small() fp32 prompt mixes of `segment`
REGION_MIXES = (("points",), ("boxes",), ("points", "boxes"),
                ("points", "masks"), ("boxes", "masks"),
                ("points", "boxes", "masks"))


def _event_ms(torch, fn):
    """fn() and its CUDA-event time in ms."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _region_rois(torch, device):
    rois = torch.tensor([r for r, _ in REGION_ROIS], dtype=torch.float32,
                        device=device)
    return rois, torch.tensor([f for _, f in REGION_ROIS], device=device)


def _mask_prompts(torch, cfg, n, kinds, seed, device):
    """Seeded SAM prompts for n instances: two points (one positive, one
    negative), a box, a low-resolution mask input (N, 4g, 4g, 1)."""
    rng = np.random.default_rng(seed)
    size = cfg.sam_dec.input_image_size
    g4 = 4 * cfg.sam_dec.image_embedding_size
    out = {}
    if "points" in kinds:
        out["points"] = rng.uniform(0, size, (n, 2, 2))
        out["point_labels"] = np.tile(np.array([[1, 0]]), (n, 1))
    if "boxes" in kinds:
        lo = rng.uniform(0, size / 2, (n, 2))
        out["boxes"] = np.concatenate(
            [lo, lo + rng.uniform(size / 8, size / 2, (n, 2))], 1)
    if "masks" in kinds:
        out["mask_inputs"] = rng.normal(size=(n, g4, g4, 1))
    return {k: torch.from_numpy(v.astype(np.int64 if k == "point_labels"
                                         else np.float32)).to(device)
            for k, v in out.items()}


def _finite(torch, what, t, shape):
    if tuple(t.shape) != tuple(shape) or not bool(torch.isfinite(t).all()):
        raise PhaseError(f"region path: {what} {tuple(t.shape)} (want "
                         f"{tuple(shape)}) or not finite")


def phase_region(torch, gpu, model):
    """The region encoder and the SAM mask path: at full width on phase
    10's bf16 model, then GroveConfig.small() fp32 card vs CPU. Returns the
    full-width path's launches by kernel."""
    t_phase = time.perf_counter()
    launches = _region_full(torch, gpu, model)
    del model
    torch.cuda.empty_cache()
    _region_small(torch, gpu)
    say(11, f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _region_full(torch, gpu, model):
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.data.preprocess import preprocess_frames_uint8
    from grove_tpu_torch.data.video import SyntheticVideo
    from grove_tpu_torch.infer.sliding import center_prompts
    from grove_tpu_torch.ops.roi_align import roi_align
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    cfg = model.cfg
    d, g = cfg.llama.hidden_size, cfg.sam_dec.image_embedding_size
    # the model's special ids come from the tokenizer it was made with
    # (phase 10's `infer.drivers.main`: a MockTokenizer whose extra
    # tokens start at vid_start)
    tok = MockTokenizer(base_vocab_size=cfg.tokens.vid_start)
    if tok.token_id("<bbox>") != cfg.tokens.bbox:
        raise PhaseError(f"<bbox> is {tok.token_id('<bbox>')} in the "
                         f"tokenizer, {cfg.tokens.bbox} in the model")
    video = SyntheticVideo(num_frames=REGION_FRAMES, width=640, height=360,
                           seed=21)
    fc, fs, valid = preprocess_frames_uint8(
        video.decode_at(np.arange(REGION_FRAMES) / video.fps),
        cfg.clip.image_size, cfg.sam_enc.img_size)
    fc, fs = (torch.from_numpy(f[None]).to("cuda") for f in (fc, fs))
    valid = torch.from_numpy(valid[None]).to("cuda")
    rois, bidx = _region_rois(torch, "cuda")
    ids, starts, _ = center_prompts(cfg, tok, [REGION_QUESTION])
    bbox_at = np.nonzero(ids[0] == cfg.tokens.bbox)[0]
    if len(bbox_at) != len(REGION_ROIS):
        raise PhaseError(f"region prompt holds {len(bbox_at)} <bbox>")
    s = -(-ids.shape[1] // 64) * 64             # K4's route: S % 64 == 0
    ids = torch.from_numpy(np.pad(ids, ((0, 0), (0, s - ids.shape[1])),
                                  constant_values=tok.pad_token_id))
    ids = ids.to("cuda")
    n = REGION_FRAMES
    prompts = _mask_prompts(torch, cfg, n, ("points", "boxes"), 22, "cuda")
    pos = torch.arange(s, device="cuda")[None]

    @torch.inference_mode()
    def run():
        """The path once -> (outputs, CUDA-event ms by stage)."""
        ms, out = {}, {}

        def stage(label, fn):
            out[label], ms[label] = _event_ms(torch, fn)
            return out[label]

        emb, mlvl = stage("encode_video", lambda: model.encode_video(fc))
        queries = stage("encode_regions", lambda: model.encode_regions(
            mlvl, rois, bidx))
        x = stage("splice (video, regions)", lambda: model.splice_regions(
            model._splice(ids, emb, starts), ids, queries[None]))
        stage("LLaMA + lm_head", lambda: model.lm_head(model.model(x, pos)))
        img = stage("encode_grounding", lambda: model.encode_grounding(
            fs, valid))
        for multi in (False, True):
            stage(f"segment points + boxes{', multimask' * multi}",
                  lambda: model.segment(img, multimask_output=multi,
                                        **prompts))
        low_res = out["segment points + boxes"][0].permute(0, 2, 3, 1)
        for multi in (False, True):
            stage(f"segment points + mask input{', multimask' * multi}",
                  lambda: model.segment(
                      img, points=prompts["points"],
                      point_labels=prompts["point_labels"],
                      mask_inputs=low_res, multimask_output=multi))
        return out, ms

    _, cold = run()                     # the process's first region call
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    out, ms = run()
    launches = {k: v.launches for k, v in _kernels.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    mlvl, queries = out["encode_video"][1], out["encode_regions"]
    x, logits = out["splice (video, regions)"], out["LLaMA + lm_head"]
    img = out["encode_grounding"]
    out = {k: v for k, v in out.items() if k.startswith("segment")}

    got = {k: v for k, v in launches.items() if v}
    if got != REGION_LAUNCHES:
        raise PhaseError(f"region path launches {got}, not "
                         f"{REGION_LAUNCHES}")
    _finite(torch, "encode_regions", queries, (n, d))
    _finite(torch, "logits", logits, (1, s, cfg.llama.padded_vocab_size))
    _finite(torch, "encode_grounding", img, (n, g * g, cfg.sam_dec.embed_dim))
    if not torch.equal(x[0, bbox_at], queries.to(x.dtype)):
        raise PhaseError("splice_regions: the <bbox> rows are not the "
                         "region queries")
    for label, (masks, iou) in out.items():
        m = 3 if "multimask" in label else 1
        _finite(torch, f"{label} masks", masks, (n, m, 4 * g, 4 * g))
        _finite(torch, f"{label} iou", iou, (n, m))
    if torch.equal(out["segment points + mask input"][0],
                   out["segment points + boxes"][0]):
        raise PhaseError("segment: the mask input changed nothing")
    say(11, f"GroveConfig() bf16 region + mask path ({n} SyntheticVideo "
            f"frames, {len(REGION_ROIS)} RoIs, a prompt of S = {s} with "
            f"{len(bbox_at)} <bbox>), the second run: CUDA-event ms "
            + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
            + " (the first run: "
            + ", ".join(f"{v:.2f}" for v in cold.values())
            + f"); peak {peak / 2**30:.2f} GiB (weights "
            f"{_model_bytes(model) / 2**30:.2f}); launches {got} (= "
            f"REGION_LAUNCHES); queries max-abs "
            f"{float(queries.float().abs().max()):.3e} on {gpu}")

    # roi_align on the card against the CPU, fp32, on level 1's grid
    with torch.inference_mode():
        b, p, c = mlvl[1].shape
        gl = math.isqrt(p)
        feat = torch.nn.functional.interpolate(
            mlvl[1].float().reshape(b, gl, gl, c).permute(0, 3, 1, 2),
            size=(4 * gl, 4 * gl), mode="bilinear", align_corners=True)
        feat = feat.permute(0, 2, 3, 1).contiguous()
        rois5 = torch.cat([bidx[:, None].float(), rois * 224.0], 1)
        card, t = _event_ms(torch, lambda: roi_align(feat, rois5, 14,
                                                     1 / 3.5))
        host = roi_align(feat.cpu(), rois5.cpu(), 14, 1 / 3.5)
    err = float((card.cpu() - host).abs().max() / host.abs().max())
    say(11, f"roi_align fp32 on level 1 {tuple(feat.shape)}, "
            f"{len(REGION_ROIS)} RoIs: card vs CPU {err:.2e} of max-abs "
            f"(limit {ROI_CARD_TOL}), {t:.3f} ms on the card")
    if not err <= ROI_CARD_TOL:
        raise PhaseError(f"roi_align card vs CPU {err:.2e} > {ROI_CARD_TOL}")
    return launches


def _region_small(torch, gpu):
    """GroveConfig.small() in fp32 (TF32 off), one set of weights on the
    CPU and its copy on the card, fed the same inputs: encode_regions,
    splice_regions (bit-equal), segment with every prompt mix and
    predict_masks with a text prompt, single-mask and multimask, each
    within PARITY_TOL of the CPU's max-abs."""
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.models.grove import init_grove_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GroveConfig.small()
    cpu = init_grove_params(cfg, device="cpu", dtype=torch.float32,
                            seed=8).eval()
    card = copy.deepcopy(cpu).to("cuda")
    clip = _synthetic_clips(cfg, 1, cfg.num_frames, seed=23)[0]
    rng = np.random.default_rng(24)
    n = cfg.num_frames
    with torch.inference_mode():
        _, mlvl = cpu.encode_video(torch.from_numpy(clip["frames_clip"][None]))
        img = cpu.encode_grounding(torch.from_numpy(clip["frames_sam"][None]))
    ids = torch.from_numpy(rng.integers(3, 1000, (2, 40)))
    ids[0, [3, 9, 17]] = cfg.tokens.bbox
    ids[1, [5, 6, 7, 30]] = cfg.tokens.bbox             # more than rows
    embeds = torch.from_numpy(rng.normal(
        size=(2, 40, cfg.llama.hidden_size)).astype(np.float32))
    text = torch.from_numpy(rng.normal(size=(n, 1, cfg.out_dim)).astype(
        np.float32))
    worst = {}

    def both(label, fn, exact=False):
        outs = []
        for model, dev in ((card, "cuda"), (cpu, "cpu")):
            with torch.inference_mode():
                got = fn(model, dev)
            outs.append([t.cpu() for t in (got if isinstance(got, tuple)
                                           else (got,))])
        for g, c in zip(*outs):
            if g.shape != c.shape or not bool(torch.isfinite(g).all()):
                raise PhaseError(f"small() fp32 {label}: {tuple(g.shape)} "
                                 f"vs {tuple(c.shape)}, or not finite")
            if exact:
                if not torch.equal(g, c):
                    raise PhaseError(f"small() fp32 {label}: not equal")
                continue
            rel = float((g - c).abs().max() / c.abs().max())
            worst[label] = max(worst.get(label, 0.0), rel)
            if not rel <= PARITY_TOL:
                raise PhaseError(f"small() fp32 {label} card vs CPU "
                                 f"{rel:.2e} > {PARITY_TOL} of max-abs")

    def regions(model, dev):
        rois, bidx = _region_rois(torch, dev)
        return model.encode_regions([m.to(dev) for m in mlvl], rois, bidx)

    both("encode_regions", regions)
    with torch.inference_mode():
        q = regions(cpu, "cpu")[None].expand(2, -1, -1)[:, :2]
    both("splice_regions", lambda m, dev: m.splice_regions(
        embeds.to(dev), ids.to(dev), q.to(dev)), exact=True)
    for mix in REGION_MIXES:
        for multi in (False, True):
            kw = _mask_prompts(torch, cfg, n, mix, 25, "cpu")
            both(f"segment {'+'.join(mix)}", lambda m, dev: m.segment(
                img.to(dev), multimask_output=multi,
                **{k: v.to(dev) for k, v in kw.items()}))

    def masks(model, dev, multi):
        sam = model.model.grounding_encoder
        sparse, dense = sam.prompt_encoder(text_embeds=text.to(dev))
        return sam.mask_decoder.predict_masks(
            img.to(dev), model.dense_pe(), sparse, dense,
            multimask_output=multi)

    for multi in (False, True):
        both("predict_masks text", lambda m, dev: masks(m, dev, multi))
    say(11, "GroveConfig.small() fp32 card vs CPU on the same inputs, of "
            "max-abs (limit " + f"{PARITY_TOL}): "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
            + "; splice_regions bit-equal; segment and predict_masks "
            f"single-mask and multimask on {gpu}")


# ---------------------------------------------------------------------------
# phase 12: parallel training (grove_tpu_torch.parallel)
# ---------------------------------------------------------------------------

PIPE_STAGES = 2
PIPE_MICRO = 2
PIPE_BATCH = 2
PIPE_KERNELS = ("flash_forward_lse_tc", "flash_backward_dq_tc",
                "flash_backward_dkv_tc")    # the LLaMA's: once a microbatch
# small() fp32 TP = 2 step vs the unsharded one: the loss terms within
# TRAIN_LOSS_REL relative; each first-step gradient within this share of
# its max-abs (or of TRAIN_GRAD_FLOOR of the largest, as phase 6), the
# parity suite's 2e-3: the split GEMMs and the all-reduce add in another
# order, and the SAM adapters' weight gradients, sums that mostly cancel,
# carry that to 1.1e-3 (measured on an H100 80GB HBM3 at 700 W)
PARALLEL_TOL = 2e-3
TP_PROCS = 2


def phase_parallel(torch, gpu, model):
    """Parallel training on the card: (a) on phase 10's full-width bf16
    model, one GPipe step over 2 stages on [cuda:0, cuda:0] in 2
    microbatches and one sequential step from the same weights and batch
    (2 rows, S = 704): loss and every trainable gradient within FULL_TOL,
    and the launches of each step exact; (b) `train.driver.main
    --multihost` under a world-1 NCCL group; (c) two processes on the one
    card over gloo at `small()`: the multi-host demo, and a TP = 2 step
    against the unsharded step in fp32. Between (a) and (b), the pipeline
    one stage a process (`_parallel_ranks`) and what a batch's shape does
    to the step in fp32 and bf16 (`_batch_shape_witness`). Returns the
    pipelined step's launches by kernel and each rank's."""
    t_phase = time.perf_counter()
    launches, seq, host_batch = _parallel_pipeline(torch, gpu, model)
    ranks = _parallel_ranks(torch, gpu, model, seq, host_batch)
    cfg = model.cfg
    del model, seq
    torch.cuda.empty_cache()
    _batch_shape_witness(torch, gpu, cfg, host_batch)
    _parallel_driver(torch, gpu)
    _parallel_processes(torch, gpu)
    _parallel_replicas(torch, gpu)
    say(12, f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return launches, ranks


def _pipe_launches(cfg, s):
    """The exact launches of the pipelined step: the sequential step's
    (`_step_launches`), with the LLaMA layers' attention kernels once a
    microbatch (each microbatch is its own call); the encoders, ground and
    the losses run once on the whole batch."""
    want = _step_launches(cfg, s, False)
    for k in PIPE_KERNELS:
        want[k] *= PIPE_MICRO
    return want


def _parallel_pipeline(torch, gpu, model):
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.parallel.pipeline import (make_pipe_mesh,
                                                   place_stages)
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch.train.step import (OptimizerConfig, batch_to_device,
                                            make_optimizer,
                                            make_pipelined_train_step)
    cfg = dataclasses.replace(model.cfg, max_seq_len=TRAIN_SEQ)
    # the model's special ids come from phase 10's tokenizer
    tok = MockTokenizer(base_vocab_size=model.cfg.tokens.vid_start)
    host_batch = _train_batch(cfg, tok, seed=31, n=PIPE_BATCH)
    batch = batch_to_device(host_batch, "cuda")
    seq = batch["input_ids"].shape[1]
    if seq != 704:
        raise PhaseError(f"the training batch has {seq} tokens, not 704")
    pipe = make_pipe_mesh(PIPE_STAGES, ["cuda:0"] * PIPE_STAGES)
    place_stages(model.model, pipe)
    # one untimed step first (a fresh optimizer: lr(0) = 0, no weight
    # moves), so that neither timed step pays the first call's costs
    _train_setup(torch, model, warmup_steps=1)[1](batch)
    runs = {}
    for name in ("pipelined", "sequential"):
        # a fresh optimizer each: lr(0) = 0, so neither step moves a weight
        params, step = _train_setup(torch, model, warmup_steps=1)
        if name == "pipelined":
            step = make_pipelined_train_step(
                model, make_optimizer(params, OptimizerConfig(
                    warmup_steps=1)), pipe, PIPE_MICRO)
        _kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out, ms = _timed(torch, lambda: step(batch))
        used = {k: v.launches for k, v in _kernels.KERNELS.items()
                if v.launches}
        want = (_pipe_launches(cfg, seq) if name == "pipelined"
                else _step_launches(cfg, seq, False))
        _check_launches(f"{name} step", want)
        _check_off_path(f"{name} step")
        losses = _check_losses(out, f"{name} step")
        peak = torch.cuda.max_memory_allocated()
        grads = {n: p.grad.detach().clone() for n, p in params.items()
                 if p.grad is not None}
        runs[name] = (losses, grads, used)
        how = (f" ({PIPE_STAGES} stages on {[str(d) for d in pipe.devices]},"
               f" {PIPE_MICRO} microbatches)" if name == "pipelined" else "")
        say(12, f"{name} step{how}: {ms:.1f} ms, peak {peak / 2**30:.2f} "
                f"GiB (phase 5's step, batch 1: "
                f"{PHASE5_STEP.get('ms', float('nan')):.1f} ms, "
                f"{PHASE5_STEP.get('peak', float('nan')) / 2**30:.2f} GiB),"
                f" batch {PIPE_BATCH} x S = {seq}, losses "
                + ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
                + f", launches {used} on {gpu}")
        PARALLEL_STEP[name] = {"ms": ms, "peak_gib": peak / 2**30}
        del out, step, params
    (lp, gp, up), (ls, gs, us) = runs["pipelined"], runs["sequential"]
    for k, v in ls.items():
        if abs(lp[k] - v) > FULL_TOL * max(abs(v), 1.0):
            raise PhaseError(f"pipelined {k} {lp[k]} vs sequential {v}")
    if set(gp) != set(gs):
        raise PhaseError(f"gradients of {sorted(set(gp) ^ set(gs))[:4]} "
                         "in one step only")
    n, worst = _grad_distance(gp, gs)[0]
    if worst > FULL_TOL:
        raise PhaseError(f"pipelined gradient {n}: {worst:.3e} of its "
                         f"max-abs from the sequential one")
    diff = {k: (up.get(k, 0), us.get(k, 0)) for k in set(up) | set(us)
            if up.get(k, 0) != us.get(k, 0)}
    say(12, f"pipelined = sequential: losses within {FULL_TOL} relative, "
            f"{len(gs)} trainable gradients within {worst:.3e} of their "
            f"max-abs; launches differ only in {diff} (the LLaMA's "
            f"attention once a microbatch: {PIPE_MICRO} x)")
    if set(diff) != {k for k in PIPE_KERNELS if us.get(k)}:
        raise PhaseError(f"the launches differ in {diff}")
    del runs, gp
    return up, (ls, gs), host_batch


def _rank_launches(cfg, s, ranks, micro, simt=False):
    """The exact launches of one rank of the pipeline one stage a process
    over `ranks` stages, its local batch of one row (or more: each kernel
    takes a rank's rows in one call), and no other kernel: the encoders'
    of phase 5's batch-1 step (K3 once a CLIP layer), and K4's and K4b's
    once a layer of its stage and microbatch. `simt`: an fp32 run's, the
    same counts on the SIMT entries."""
    want = _step_launches(cfg, s, False)
    for k in PIPE_KERNELS:
        want[k] = want[k] * micro // ranks
    want["grouped_plain_attention_tc"] = cfg.clip.num_layers
    return {(k.removesuffix("_tc") if simt else k): v
            for k, v in want.items() if v}


def _stage_shares(ranks, step, n, m):
    """From each rank's CUDA-event marks of timed step `step` (host-clock
    seconds), `ranks` one pipeline's n stages: each stage's busy ms and
    its share of the step, and the pipeline's bubble: 1 - the stages'
    busy time over n x the span from the first microbatch's start to the
    last one's end, forward and backward spans added, beside GPipe's
    (n - 1) / (m + n - 1)."""
    spans, busy = 0.0, []
    for kind in ("forward", "backward"):
        marks = [(a, b) for r in ranks for k, _, a, b in
                 r["steps"][step]["marks"] if k == kind]
        spans += max(b for _, b in marks) - min(a for a, _ in marks)
    for r in ranks:
        busy.append(sum(b - a for k, _, a, b in r["steps"][step]["marks"]
                        if k in ("forward", "backward")))
    shares = [b * 1e3 / r["steps"][step]["ms"] for b, r in zip(busy, ranks)]
    return ([b * 1e3 for b in busy], shares, 1 - sum(busy) / (n * spans),
            (n - 1) / (m + n - 1))


def _stage_sum_ms(rank, step):
    """The CUDA-event ms of rank's stage-group gradient sum in `step`."""
    return sum((b - a) * 1e3 for k, _, a, b in rank["steps"][step]["marks"]
               if k == "stage_sum")


def _check_ranks(got, cfg, s, n, m, label, simt=False):
    """Each rank of a `parallel.workers.pipeline_step` run over n stages
    (rank r stage r % n of replica r // n): its stage and layers (the
    others on the meta device), and every timed step's launches exact
    (`_rank_launches`)."""
    per = cfg.llama.num_layers // n
    want = _rank_launches(cfg, s, n, m, simt)
    for rank, r in enumerate(got["ranks"]):
        stage = rank % n
        layers = list(range(stage * per, (stage + 1) * per))
        rest = [i for i in range(cfg.llama.num_layers) if i not in layers]
        if (r["replica"], r["stage"], r["held"], r["meta"]) != (
                rank // n, stage, layers, rest):
            raise PhaseError(f"{label} rank {rank}: replica {r['replica']},"
                             f" stage {r['stage']}, layers {r['held']} "
                             f"held, {r['meta']} on meta")
        for i, st in enumerate(r["steps"]):
            if st["launches"] != want:
                raise PhaseError(f"{label} rank {rank} step {i + 1}: "
                                 f"launches {st['launches']}, not {want}")
    return want


def _check_replicas(got, n, label):
    """After a `pipeline_step` run of replicas of n stages: each stage's
    copies on every replica, parameters and moments, with equal bit sums
    tensor by tensor (`parallel.workers.bit_sums`), and the replicated
    rest equal on every rank. Returns the tensors compared on rank 0."""
    ranks = got["ranks"]
    for rank, r in enumerate(ranks):
        for kind, sums in r["after"].items():
            first = ranks[rank % n]["after"][kind]
            if sums != first:
                raise PhaseError(f"{label}: rank {rank}'s {kind} differ "
                                 f"from rank {rank % n}'s, its stage on "
                                 "replica 0")
            rest = {k: v for k, v in sums.items()
                    if not k.startswith("model.layers.")}
            if rest != {k: ranks[0]["after"][kind][k] for k in rest}:
                raise PhaseError(f"{label}: rank {rank}'s replicated {kind} "
                                 "differ from rank 0's")
    return sum(len(v) for v in ranks[0]["after"].values())


RANK_PROCS = 2


def _grad_distance(got, want):
    """Each gradient's max-abs distance from `want`'s, relative to its
    max-abs (or to TRAIN_GRAD_FLOOR of the largest), as (name, distance)
    worst first (`_rounded` to print); a name of `got` that `want` lacks
    must hold zeros."""
    extra = [n for n in set(got) - set(want) if bool(got[n].any())]
    if not set(want) <= set(got) or extra:
        raise PhaseError(f"gradients of {sorted(set(want) - set(got))[:4]} "
                         f"missing, {extra[:4]} not zero")
    top = max(float(g.float().abs().max()) for g in want.values())
    dist = {}
    for n, w in want.items():
        scale = max(float(w.float().abs().max()), TRAIN_GRAD_FLOOR * top)
        dist[n] = float((got[n].to(w.device).float() - w.float()).abs()
                        .max()) / scale
    return sorted(dist.items(), key=lambda kv: -kv[1])


def _rounded(pairs):
    return [(n, float(f"{d:.3e}")) for n, d in pairs]


def _parallel_ranks(torch, gpu, model, seq, host_batch):
    """The pipeline one stage a process on the one card: RANK_PROCS
    processes over gloo (`parallel.workers.pipeline_step`), each building
    `model`'s GroveConfig() in bf16 from its seed 0 (phase 10's) with its
    stage's layers only, one row of `host_batch` a rank, PIPE_MICRO
    microbatches, with this process's TF32 settings (the earlier phases
    turn cuDNN's off, and an fp32 op then takes other algorithms): a warm
    step, then a step whose loss terms and trainable gradients must lie
    within FULL_TOL of the same step a row at a time
    (`train.step.row_at_a_time`), each rank's launches exact; the
    distances from `seq` (the sequential step's (losses, gradients) on
    the whole batch) are printed. Returns each rank's launches by kernel."""
    from grove_tpu_torch.parallel.launch import launch
    from grove_tpu_torch.parallel.workers import fingerprint
    from grove_tpu_torch.train.step import row_at_a_time
    ls, gs = seq
    tmp = Path(tempfile.mkdtemp(prefix="grove_ranks_"))
    try:
        with open(tmp / "cfg.pkl", "wb") as f:
            pickle.dump(model.cfg, f)
        torch.save(host_batch, tmp / "batch.pt")
        sums = fingerprint(model)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launch(["-m", "grove_tpu_torch.parallel.workers", "pipeline_step",
                json.dumps(dict(out=str(tmp / "run.pt"),
                                batch=str(tmp / "batch.pt"),
                                microbatches=PIPE_MICRO,
                                config_file=str(tmp / "cfg.pkl"), seed=0,
                                dtype="bf16",
                                optimizer={"warmup_steps": 1},
                                warm_steps=1, steps=1, tf32=[
                                    torch.backends.cuda.matmul.allow_tf32,
                                    torch.backends.cudnn.allow_tf32],
                                device="cuda"))],
               RANK_PROCS, timeout=600)
        secs = time.perf_counter() - t0
        got = torch.load(tmp / "run.pt", weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seq_len = host_batch["input_ids"].shape[1]
    _check_ranks(got, model.cfg, seq_len, RANK_PROCS, PIPE_MICRO,
                 "pipeline ranks")
    for rank, r in enumerate(got["ranks"]):
        off = [n for n, v in r["fingerprint"].items() if v != sums[n]]
        if off:
            raise PhaseError(f"rank {rank}'s weights are not phase 10's: "
                             f"{off[:4]}")
    terms = got["metrics"][0]
    for k, v in ls.items():
        if abs(terms[k] - v) > FULL_TOL * max(abs(v), 1.0):
            raise PhaseError(f"pipeline ranks {k} {terms[k]} vs sequential "
                             f"{v}")
    grads = got["grads"]
    extra = [n for n in set(grads) - set(gs) if bool(grads[n].any())]
    if not set(gs) <= set(grads) or extra:
        raise PhaseError(f"pipeline ranks: gradients of "
                         f"{sorted(set(gs) - set(grads))[:4]} missing, "
                         f"{extra[:4]} not zero")
    rows_terms, rows_grads = row_at_a_time(model, host_batch)
    worst = _grad_distance(grads, rows_grads)
    for k, v in rows_terms.items():
        if abs(terms[k] - v) > FULL_TOL * max(abs(v), 1.0):
            raise PhaseError(f"pipeline ranks {k} {terms[k]} vs a row at a "
                             f"time {v}")
    if worst[0][1] > FULL_TOL:
        raise PhaseError(f"pipeline ranks gradients off the step a row at "
                         f"a time by more than {FULL_TOL} of their max-abs: "
                         f"{_rounded(worst[:4])}")
    worst = _rounded(worst)
    batched = _rounded(_grad_distance(grads, gs))
    rows_batched = _rounded(_grad_distance(rows_grads, gs))
    del rows_grads
    frames = torch.as_tensor(host_batch["frames_clip"]).to(model.device)
    with torch.no_grad():
        both = model.encode_video(frames)[0][:1]
        alone = model.encode_video(frames[:1])[0]
    clip_diff = float((both.float() - alone.float()).abs().max()) / float(
        both.float().abs().max())
    del frames, both, alone
    busy, shares, bubble, gpipe = _stage_shares(got["ranks"], 0, RANK_PROCS,
                                                PIPE_MICRO)
    for rank, r in enumerate(got["ranks"]):
        st = r["steps"][0]
        say(12, f"pipeline one stage a process, rank {rank} (stage "
                f"{r['stage']}, layers {r['held'][0]}-{r['held'][-1]}, the "
                f"other {len(r['meta'])} on meta) over {r['transport']}: "
                f"step {st['ms']:.1f} ms, peak {st['peak'] / 2**30:.2f} "
                f"GiB, stage busy {busy[rank]:.1f} ms ({shares[rank]:.3f} "
                f"of the step), launches {st['launches']} (exact) on {gpu}")
    say(12, f"pipeline one stage a process: {RANK_PROCS} processes on "
            f"cuda:0, batch {PIPE_BATCH} x S = {seq_len}, {PIPE_MICRO} "
            f"microbatches: losses {terms}; against the step a row at a "
            f"time (each rank's arithmetic: the encoders on one row), "
            f"losses within {FULL_TOL} relative and {len(gs)} trainable "
            f"gradients within {FULL_TOL} of their max-abs, the worst "
            f"{worst[:3]}; against the sequential step on both rows (held "
            f"to nothing: bf16 encoders on one row and on two differ, the "
            f"projected CLIP tokens by {clip_diff:.3e} of their max-abs), "
            f"losses {ls}, the worst gradients {batched[:4]}, and the step "
            f"a row at a time's {rows_batched[:4]}; bubble {bubble:.3f} "
            f"(GPipe {gpipe:.3f}; the processes share one card); weights "
            f"equal to phase 10's; {secs:.1f} s with the processes' start")
    return [r["steps"][0]["launches"] for r in got["ranks"]]


WITNESS_LAYERS = 2


@contextlib.contextmanager
def _plain_twins():
    """Every wrapper takes its plain PyTorch version on CUDA tensors too
    (`_kernels.on_cpu` answers True for them), for a comparison run only;
    raises if a kernel launched inside all the same."""
    from grove_tpu_torch import _kernels
    real = _kernels.on_cpu

    def plain(*tensors):
        if any(t.device != tensors[0].device for t in tensors):
            raise ValueError("kernel inputs lie on different devices: "
                             f"{[str(t.device) for t in tensors]}")
        return True
    before = {k: v.launches for k, v in _kernels.KERNELS.items()}
    _kernels.on_cpu = plain
    try:
        yield
    finally:
        _kernels.on_cpu = real
    ran = {k: v.launches - before[k] for k, v in _kernels.KERNELS.items()
           if v.launches != before[k]}
    if ran:
        raise PhaseError(f"kernels launched in a plain-twin run: {ran}")


def _batch_shape_witness(torch, gpu, cfg, host_batch):
    """The step on phase 12's batch of 2 rows against the same step a row
    at a time (`train.step.row_at_a_time`, the pipeline ranks'
    arithmetic), at `cfg`'s full width with the LLaMA cut to
    WITNESS_LAYERS layers, built from seed 0: in fp32 (TF32 off) every
    trainable gradient within PARALLEL_TOL of its max-abs, so that a step
    of one row treats it as the batch does; then the same draws in bf16,
    whose distance is printed beside it (bf16 rounds another way at each
    batch shape), and in bf16 once more with every kernel replaced by its
    plain PyTorch version (`_plain_twins`): a distance of the same order
    there clears the kernels of the bf16 one."""
    from grove_tpu_torch.models.grove import init_grove_params
    from grove_tpu_torch.train.step import batch_to_device, row_at_a_time
    t0 = time.perf_counter()
    cut = dataclasses.replace(
        cfg, max_seq_len=TRAIN_SEQ,
        llama=dataclasses.replace(cfg.llama, num_layers=WITNESS_LAYERS))
    batch = batch_to_device(host_batch, "cuda")
    found = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                        ("bf16 plain", torch.bfloat16)):
        model = init_grove_params(cut, device="cuda", dtype=dtype, seed=0)
        with (_no_tf32(torch) if dtype == torch.float32
              else contextlib.nullcontext()), \
                (_plain_twins() if name == "bf16 plain"
                 else contextlib.nullcontext()):
            # a fresh optimizer: lr(0) = 0, no weight moves
            params, step = _train_setup(torch, model, warmup_steps=1)
            _check_losses(step(batch), f"{name} witness step")
            batched = {n: p.grad.detach().clone() for n, p in params.items()
                       if p.grad is not None}
            _, rows = row_at_a_time(model, host_batch)
        found[name] = _grad_distance(rows, batched)
        del model, params, step, batched, rows
        torch.cuda.empty_cache()
    del batch
    fp32, bf16, plain = found["fp32"], found["bf16"], found["bf16 plain"]
    if fp32[0][1] > PARALLEL_TOL:
        raise PhaseError(f"fp32 step a row at a time off the batched one "
                         f"by more than {PARALLEL_TOL} of the max-abs: "
                         f"{_rounded(fp32[:4])}")
    say(12, f"batch shape, GroveConfig() widths with {WITNESS_LAYERS} LLaMA "
            f"layers, batch {len(host_batch['labels'])} x S = "
            f"{host_batch['input_ids'].shape[1]}: the step a row at a time "
            f"vs the batched step, {len(fp32)} trainable gradients, in fp32 "
            f"(TF32 off) within {PARALLEL_TOL} of their max-abs, the worst "
            f"{_rounded(fp32[:3])}; the same draws in bf16, the worst "
            f"{_rounded(bf16[:3])}, and in bf16 through the plain twins "
            f"(no kernel), the worst {_rounded(plain[:3])} (both held to "
            f"nothing); {time.perf_counter() - t0:.1f} s on {gpu}")


def _free_port():
    import socket
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _parallel_driver(torch, gpu):
    """`train.driver.main --multihost` in this process, a world-1 NCCL group
    from torchrun's environment set here: small() bf16, 2 steps."""
    import torch.distributed as dist
    from grove_tpu_torch.parallel import mesh as pmesh
    from grove_tpu_torch.train import driver
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    seen = {}
    real = pmesh.make_mesh

    def spy(*a, **kw):
        seen.update(backend=dist.get_backend(),
                    world=dist.get_world_size())
        mesh = real(*a, **kw)
        seen["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        return mesh
    tmp = tempfile.mkdtemp(prefix="grove_multihost_")
    t0 = time.perf_counter()
    try:
        pmesh.make_mesh = spy
        best = driver.main(DRIVER_RESUME[:DRIVER_RESUME.index("--device")]
                           + ["--device", "cuda", "--multihost",
                              "--epochs", "1", "--log_base_dir", tmp])
        ckpt = Path(tmp) / "grove_tpu" / "ckpt_model" / "2" / "state.pt"
        state = torch.load(ckpt, map_location="cpu", weights_only=True)
        bad = [k for k, v in state["params"].items()
               if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    finally:
        pmesh.make_mesh = real
        shutil.rmtree(tmp, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if seen.get("backend") != "nccl" or seen.get("world") != 1:
        raise PhaseError(f"--multihost ran on {seen}, not a world-1 NCCL "
                         "group")
    if dist.is_initialized():
        raise PhaseError("the driver left its process group behind")
    if bad:
        raise PhaseError(f"non-finite checkpoint tensors {bad[:4]}")
    say(12, f"driver --multihost: world 1 over {seen['backend']}, mesh "
            f"{seen['mesh']}, 2 steps + validation (best {best:.4f}) and a "
            f"checkpoint of {len(state['params'])} finite tensors in "
            f"{time.perf_counter() - t0:.1f} s on {gpu}")


def _parallel_processes(torch, gpu):
    """Two processes on the one card over gloo: the multi-host demo
    (--device cuda) and a TP = 2 small() fp32 step against the unsharded
    step in this process."""
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch.tools import multihost_demo
    tmp = Path(tempfile.mkdtemp(prefix="grove_procs_"))
    try:
        t0 = time.perf_counter()
        result = multihost_demo.main(["--num_processes", str(TP_PROCS),
                                      "--steps", "2", "--device", "cuda",
                                      "--workdir", str(tmp / "demo"),
                                      "--timeout", "300"])
        say(12, f"multi-host demo, {TP_PROCS} processes on cuda:0 over "
                f"gloo: disjoint shards {result['shards']}, losses by step "
                f"{result['losses']} in {time.perf_counter() - t0:.1f} s")

        cfg = GroveConfig.small()
        tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
        _worker_steps(torch, tmp, [_train_batch(cfg, tok, seed=42)],
                      {f"TP = {TP_PROCS}": (TP_PROCS, TP_PROCS, {})},
                      f"{TP_PROCS} processes on cuda:0 over gloo")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


REPLICA_STAGES = 2       # the pipeline under data parallelism: 2 stages x
REPLICAS = 2             # 2 replicas, rank r stage r % 2 of replica r // 2


def _parallel_replicas(torch, gpu):
    """The pipeline under data parallelism on the one card: small() in
    fp32 (TF32 off) as REPLICA_STAGES stages x REPLICAS replicas, 4
    processes over gloo (messages through pinned host buffers), one row a
    rank, 2 microbatches a replica, 2 steps (`parallel.workers.
    pipeline_step`), against data parallelism over 4 processes on the same
    shards (`parallel.workers.train_step`, the step `--multihost` runs),
    the two launched at once: each step's loss terms and every trainable
    parameter after the 2 steps within CARDS_PIPE_TOL (1 + |x|), but
    those whose gradient is zero up to rounding (below ZERO_GRAD of the
    largest in data parallelism's first step: Adam turns their noise into
    lr-sized steps); the first step's gradients within PARALLEL_TOL of
    their max-abs; each rank's launches exact on the SIMT entries; the
    replicas' copies of each stage bit-equal after the 2 steps."""
    from concurrent.futures import ThreadPoolExecutor
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.models.grove import init_grove_params
    from grove_tpu_torch.parallel.launch import launch
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    procs = REPLICA_STAGES * REPLICAS
    cfg = dataclasses.replace(GroveConfig.small(), max_seq_len=TRAIN_SEQ)
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    batches = [_train_batch(cfg, tok, seed=50 + r) for r in range(procs)]
    whole = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    seq = whole["input_ids"].shape[1]
    tmp = Path(tempfile.mkdtemp(prefix="grove_replicas_"))
    try:
        model = init_grove_params(cfg, device="cpu", dtype=torch.float32,
                                  seed=41)
        torch.save(model.state_dict(), tmp / "small.pt")
        del model
        with open(tmp / "cfg.pkl", "wb") as f:
            pickle.dump(cfg, f)
        torch.save(batches, tmp / "batches.pt")
        torch.save(whole, tmp / "batch.pt")
        common = dict(optimizer={"warmup_steps": 0}, device="cuda")
        argvs = [
            ["-m", "grove_tpu_torch.parallel.workers", "train_step",
             json.dumps(dict(weights=str(tmp / "small.pt"),
                             batches=str(tmp / "batches.pt"),
                             out=str(tmp / "dp.pt"), size="small",
                             config={"max_seq_len": TRAIN_SEQ}, **common))],
            ["-m", "grove_tpu_torch.parallel.workers", "pipeline_step",
             json.dumps(dict(out=str(tmp / "pp.pt"),
                             batch=str(tmp / "batch.pt"), microbatches=2,
                             weights=str(tmp / "small.pt"),
                             config_file=str(tmp / "cfg.pkl"),
                             dtype="fp32", steps=2, replicas=REPLICAS,
                             tf32=[False, False], **common))]]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(lambda argv: launch(
                argv, procs, timeout=600,
                env={"NVIDIA_TF32_OVERRIDE": "0"}), argvs))
        secs = time.perf_counter() - t0
        dp = torch.load(tmp / "dp.pt", weights_only=False)
        pp = torch.load(tmp / "pp.pt", weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    label = f"{REPLICA_STAGES} stages x {REPLICAS} replicas"
    _check_ranks(pp, cfg, seq, REPLICA_STAGES, 2, label, simt=True)
    compared = _check_replicas(pp, REPLICA_STAGES, label)
    for step, (g, w) in enumerate(zip(pp["metrics"], dp["metrics"])):
        for k, v in w.items():
            if abs(g[k] - v) > CARDS_PIPE_TOL * (1 + abs(v)):
                raise PhaseError(f"{label} step {step + 1} {k} {g[k]} vs "
                                 f"data parallelism's {v}")
    top = max(float(g.abs().max()) for g in dp["grads"].values())
    zero = {n for n, g in dp["grads"].items()
            if float(g.abs().max()) <= ZERO_GRAD * top}
    if set(pp["params"]) != set(dp["params"]):
        raise PhaseError(f"{label}: other trainable parameters than data "
                         "parallelism's")
    excess = sorted(((n, float(((pp["params"][n].double() - w.double())
                                .abs() - CARDS_PIPE_TOL * (1 + w.double()
                                                           .abs())).max()))
                     for n, w in dp["params"].items() if n not in zero),
                    key=lambda kv: -kv[1])
    if excess[0][1] > 0:
        raise PhaseError(f"{label}: parameters after 2 steps off data "
                         f"parallelism's by more than {CARDS_PIPE_TOL} (1 + "
                         f"|x|): {excess[:4]}")
    worst = _rounded(_grad_distance(pp["grads"], dp["grads"])[:3])
    if worst[0][1] > PARALLEL_TOL:
        raise PhaseError(f"{label}: first-step gradients off data "
                         f"parallelism's by more than {PARALLEL_TOL} of "
                         f"their max-abs: {worst}")
    say(12, f"pipeline under data parallelism, small() fp32 (TF32 off), "
            f"{label} = {procs} processes on cuda:0 over "
            f"{pp['ranks'][0]['transport']}, one row a rank, 2 microbatches "
            f"a replica, S = {seq}, 2 steps: losses {pp['metrics'][-1]} = "
            f"data parallelism over {procs} processes on the same shards "
            f"within {CARDS_PIPE_TOL} (1 + |x|); {len(excess)} trainable "
            f"parameters within it after 2 steps, the closest to the bound "
            f"{_rounded(excess[:3])} (excess, <= 0; {len(zero)} with a "
            f"gradient zero up to rounding left out); the first step's "
            f"gradients, the worst {worst}; each rank's launches exact "
            f"{pp['ranks'][0]['steps'][0]['launches']}; {compared} tensors "
            f"of each stage's copies bit-equal across the replicas; "
            f"{secs:.1f} s for both launches on {gpu}")


def _reference_step(torch, tmp, batches):
    """Two unsharded fp32 `small()` train steps on the card on the
    concatenation of `batches`, from weights of seed 41 saved to
    tmp / "small.pt"; returns (that path, each step's loss terms, the
    first step's gradients on the CPU)."""
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.models.grove import init_grove_params
    from grove_tpu_torch.train.step import (OptimizerConfig, batch_to_device,
                                            make_optimizer, make_train_step,
                                            partition_params, trainable_mask)
    cfg = GroveConfig.small()
    model = init_grove_params(cfg, device="cuda", dtype=torch.float32,
                              seed=41)
    weights = tmp / "small.pt"
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               weights)
    batch = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    ocfg = OptimizerConfig(warmup_steps=0)
    params = partition_params(model, trainable_mask(model, ocfg))
    step = make_train_step(model, make_optimizer(params, ocfg))
    want, want_g = [], None
    with _no_tf32(torch):
        for _ in range(2):
            out = step(batch_to_device(batch, "cuda"))
            want.append({k: float(v) for k, v in out.items()})
            if want_g is None:           # the first step's, as the workers'
                want_g = {n: p.grad.detach().cpu()
                          for n, p in params.items() if p.grad is not None}
    del model, step, params
    torch.cuda.empty_cache()
    return weights, want, want_g


def _worker_steps(torch, tmp, batches, runs, where):
    """Two fp32 `small()` train steps of `parallel.workers.train_step`
    against the unsharded step in this process on the global batch (the
    concatenation of `batches`, data rank r taking batches[r]): for each
    run label -> (processes, tp, the worker's `fsdp` / `sp` / `zero`
    options), losses within TRAIN_LOSS_REL and the first step's gradients
    within PARALLEL_TOL of their max-abs."""
    from grove_tpu_torch.parallel.launch import launch
    weights, want, want_g = _reference_step(torch, tmp, batches)
    torch.save(batches, tmp / "batches.pt")
    for label, (procs, tp, options) in runs.items():
        t0 = time.perf_counter()
        launch(["-m", "grove_tpu_torch.parallel.workers", "train_step",
                json.dumps(dict(weights=str(weights),
                                batches=str(tmp / "batches.pt"),
                                out=str(tmp / "run.pt"), tp=tp,
                                size="small", device="cuda",
                                optimizer={"warmup_steps": 0}, **options))],
               procs, timeout=600, env={"NVIDIA_TF32_OVERRIDE": "0"})
        got = torch.load(tmp / "run.pt", weights_only=False)
        for g, w in zip(got["metrics"], want):
            for k, v in w.items():
                if abs(g[k] - v) > TRAIN_LOSS_REL * max(abs(v), 1.0):
                    raise PhaseError(f"{label} {k} {g[k]} vs unsharded {v}")
        worst = _rounded(_grad_distance(got["grads"], want_g)[:3])
        if worst[0][1] > PARALLEL_TOL:
            raise PhaseError(f"{label} gradients off the unsharded step by "
                             f"more than {PARALLEL_TOL} of their max-abs: "
                             f"{worst}")
        say(12, f"{label} small() fp32, {where}, 2 steps on "
                f"{len(batches)} local batch(es): losses "
                f"{got['metrics'][-1]} = unsharded within {TRAIN_LOSS_REL}, "
                f"the first step's {len(want_g)} gradients within "
                f"{PARALLEL_TOL} of their max-abs, the worst {worst} "
                f"({time.perf_counter() - t0:.1f} s)")


@contextlib.contextmanager
def _no_tf32(torch):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


PARALLEL_STEP = {}


# ---------------------------------------------------------------------------
# phase 13: the JAX package's model directories
# ---------------------------------------------------------------------------

JAX_DIR_CLIPS = 4        # one group of phase 10's iground clips
# kernels the main path must launch on each model read back (the bf16
# towers' K1, K2 and K3; the flagship's K1q, K6 and K7b), beside launches
# equal to the in-memory model's
JAX_DIR_NEED = {"bf16": ("sam_window_attention_tc", "sam_global_attention_tc",
                         "grouped_plain_attention_tc"),
                "flagship": ("sam_window_attention_q8_tc",
                             "int8_decode_attention", "int4_matmul_a8")}


class _RssPeak:
    """The process's peak resident set while the block runs, sampled from
    /proc/self/statm every 20 ms by a thread (ru_maxrss is the peak of the
    whole process's life, earlier phases included)."""

    def __enter__(self):
        import threading
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.peak = self.start = self._now()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _now(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _run(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._now())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._now())


def _wchar() -> int:
    """The bytes this process has passed to write calls (/proc/self/io
    `wchar`: files, pipes and terminals alike; the card's machine reports
    no block-level `write_bytes`)."""
    with open("/proc/self/io") as f:
        return int(dict(line.split(": ") for line in f.read().splitlines()
                        if ": " in line)["wchar"])


def _tree_bytes(path) -> int:
    """The bytes of the regular files under `path` (0 where it is gone)."""
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                st = os.lstat(os.path.join(root, f))
            except OSError:
                continue
            if stat.S_ISREG(st.st_mode):
                total += st.st_size
    return total


def _filesystem(path: str) -> str:
    """The type of the mount that holds `path` (/proc/mounts)."""
    best, kind = "", "?"
    with open("/proc/mounts") as f:
        for line in f:
            fields = line.split()
            if len(fields) > 2 and (path + "/").startswith(
                    fields[1].rstrip("/") + "/") and len(fields[1]) > len(best):
                best, kind = fields[1], fields[2]
    return f"{kind} at {best}"


class _DiskLedger:
    """What each phase writes, against the 45 GiB a command that the card's
    machine allows: the bytes of every directory tree removed in the phase
    (`shutil.rmtree` is wrapped; `tempfile`'s directories go through it
    too), a bound below on its file writes, since an overwrite or a file
    removed alone is missed; this process's write calls (`_wchar`), a
    bound above on this process's file writes, which counts pipes and
    sockets too and no child process; and the peak of the temporary
    directory's filesystem's used bytes above the run's start (statvfs,
    sampled every 0.1 s by a thread: what the files held at once, other
    users of that filesystem included)."""

    def __init__(self):
        import threading
        self.removed, self.rows = 0, []
        self.start = self.last = _wchar()
        self.fs = tempfile.gettempdir()
        st = os.statvfs(self.fs)
        self.capacity = st.f_blocks * st.f_frsize
        self.used0 = self._used()
        self.peak = self.phase_peak = 0
        self._real = real = shutil.rmtree

        def rmtree(path, *a, **kw):
            self.removed += _tree_bytes(path)
            return real(path, *a, **kw)
        rmtree.avoids_symlink_attacks = real.avoids_symlink_attacks
        shutil.rmtree = rmtree
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    def _used(self) -> int:
        st = os.statvfs(self.fs)
        return (st.f_blocks - st.f_bfree) * st.f_frsize

    def _sample(self):
        while not self._stop.wait(0.1):
            up = self._used() - self.used0
            self.phase_peak = max(self.phase_peak, up)
            self.peak = max(self.peak, up)

    def mark(self, label: str) -> None:
        now = _wchar()
        self.rows.append((label, self.removed, now - self.last))
        say("io", f"{label}: files removed {self.removed / 2**30:.2f} GiB, "
                  f"write calls {(now - self.last) / 2**30:.2f} GiB, used "
                  f"bytes at most {self.phase_peak / 2**30:.2f} GiB above "
                  f"the start; since the start "
                  f"{sum(r[1] for r in self.rows) / 2**30:.2f} and "
                  f"{(now - self.start) / 2**30:.2f} GiB")
        self.removed, self.last, self.phase_peak = 0, now, 0

    def close(self) -> None:
        shutil.rmtree = self._real
        self._stop.set()
        self._thread.join()
        build = _tree_bytes(ROOT / "grove_tpu_torch" / "_build")
        removed = sum(r[1] for r in self.rows)
        counted = (removed + build) / 2**30
        say("io", f"the command: {removed} B of files removed and {build} B "
                  f"of kernel build left, {counted:.2f} GiB of file writes "
                  f"counted (a bound below: overwrites, files removed one by "
                  f"one and child processes' own removals are missed), "
                  f"{45 - counted:.2f} GiB under the 45 GiB a command; this "
                  f"process's write calls {(_wchar() - self.start) / 2**30:.2f}"
                  f" GiB (a bound above on its own file writes, pipes and "
                  f"sockets included); the used bytes of {self.fs}'s "
                  f"filesystem ({_filesystem(self.fs)}, "
                  f"{self.capacity / 2**30:.2f} GiB, {self.used0 / 2**30:.2f} "
                  f"used at the start) at most {self.peak / 2**30:.2f} GiB "
                  f"above the start; the checkout on {_filesystem(str(ROOT))}")


class _GenSpy:
    """Record the generated ids of `infer.sliding.generate_grounded`."""

    def __enter__(self):
        from grove_tpu_torch.infer import sliding
        self._mod, self._real, self.ids = sliding, sliding.generate_grounded, []

        def gen(*a, **kw):
            out = self._real(*a, **kw)
            self.ids.append(np.array(out["generated_ids"]))
            return out
        sliding.generate_grounded = gen
        return self

    def __exit__(self, *exc):
        self._mod.generate_grounded = self._real


def phase_jax_dirs(torch, gpu, model):
    """Phase 10's bf16 model, then the flagship made from it in place,
    each written as the JAX package's model directory and read back on the
    card (see the module docstring). Returns the launches of the main-path
    runs on the models read back, summed, by kernel."""
    from grove_tpu_torch.api import GroveForCausalLM
    from grove_tpu_torch.infer.drivers import (FullClipIGroundDataset,
                                               make_synthetic)
    t_phase = time.perf_counter()
    wchar = _wchar()
    tmp = Path(tempfile.mkdtemp(prefix="grove_jax_dirs_"))
    launches, written = {}, 0
    try:
        ann, videos, _, _ = make_synthetic("iground", str(tmp / "set"),
                                           num_videos=JAX_DIR_CLIPS)
        ds = FullClipIGroundDataset(ann, videos, model.cfg)
        samples = [ds[i] for i in range(JAX_DIR_CLIPS)]
        model.model.stages = None        # phase 12's placement: one card
        for p in model.parameters():
            p.grad = None
        lm = GroveForCausalLM(model.cfg, model.eval())
        for label in ("bf16", "flagship"):
            if label == "flagship":
                t0 = time.perf_counter()
                nf = lm.cfg.num_frames
                lm.quantize(bits=4, vision=True, act_quant=True)
                lm.calibrate(
                    torch.from_numpy(samples[0]["frames_clip"][None, :nf]
                                     ).cuda(),
                    torch.from_numpy(samples[0]["frames_sam"][None, :nf]
                                     ).cuda())
                torch.cuda.synchronize()
                say(13, f"flagship made in place (W4A8, W8A8 towers "
                        f"calibrated on one clip) in "
                        f"{time.perf_counter() - t0:.1f} s: weights "
                        f"{_model_bytes(lm.model) / 2**30:.2f} GiB")
            got, n = _jax_dir_round_trip(torch, gpu, lm, samples, label,
                                         tmp / label)
            written += n
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
        orbax_launches, n = _orbax_round_trip(torch, gpu, tmp / "orbax")
        written += n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    now = _wchar()
    say(13, f"phase 13 wrote {written} B ({written / 2**30:.2f} GiB) of "
            f"model and checkpoint files in all (each deleted after use); "
            f"this process's write calls: {(now - wchar) / 2**30:.2f} GiB "
            f"in phase 13, {now / 2**30:.2f} GiB since it started "
            f"(/proc/self/io wchar, sockets and pipes included: a bound on "
            f"its disk writes, of which the machine takes 45 GiB a "
            f"command); JAX's own Orbax layouts (OCDBT, "
            f"tensorstore): held on the CPU by tests/test_torch_orbax.py; "
            f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return launches, orbax_launches


def _orbax_round_trip(torch, gpu, log):
    """A training run written as the JAX package's Orbax run and read back
    on the card (see the module docstring). Returns (the counted step's
    launches, the bytes written)."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.checkpoint import orbax_read, orbax_write
    from grove_tpu_torch.checkpoint.manager import CheckpointManager
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.models.grove import init_grove_params
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch.train.step import (OptimizerConfig, batch_to_device,
                                            make_optimizer, make_train_step,
                                            partition_params, trainable_mask)
    t0 = time.perf_counter()
    base = GroveConfig()
    cfg = dataclasses.replace(
        base, max_seq_len=TRAIN_SEQ,
        llama=dataclasses.replace(base.llama, num_layers=WITNESS_LAYERS))
    model = init_grove_params(cfg, device="cuda", dtype=torch.bfloat16,
                              seed=7)
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    batch = batch_to_device(_train_batch(cfg, tok, seed=8), "cuda")
    seq = batch["input_ids"].shape[1]
    oc = OptimizerConfig(warmup_steps=1)
    params = partition_params(model, trainable_mask(model, oc))
    opt = make_optimizer(params, oc)
    step = make_train_step(model, opt)
    _check_losses(step(batch), "Orbax run, warm step")
    _kernels.reset_launch_counts()
    out, ms = _timed(torch, lambda: step(batch))
    used = {k: v.launches for k, v in _kernels.KERNELS.items() if v.launches}
    losses = _check_losses(out, "Orbax run, counted step")
    want = _step_launches(cfg, seq, False)
    want["grouped_plain_attention_tc"] = cfg.clip.num_layers
    _check_launches("Orbax run, counted step", want)
    say(13, f"Orbax run: bf16 GroveConfig() with {WITNESS_LAYERS} LLaMA "
            f"layers, S = {seq}, {len(params)} trainable tensors: warm step,"
            f" then {ms:.1f} ms, losses "
            + ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
            + f", launches {used} (exact) on {gpu}; built and stepped in "
            f"{time.perf_counter() - t0:.1f} s")
    del batch, out
    torch.cuda.synchronize()
    state = opt.state_dict()
    with _RssPeak() as rss_w:
        t0 = time.perf_counter()
        n_step = orbax_write.save_step(str(log), 2, model, state,
                                       opt_cfg=oc)
        step_s = time.perf_counter() - t0
        n_best = orbax_write.save_best(str(log), 0, model, "metric",
                                       losses["loss"])
        best_s = time.perf_counter() - t0 - step_s
    from unittest import mock
    # the read must not need tensorstore
    with mock.patch.dict(sys.modules, {"tensorstore": None}):
        with _RssPeak() as rss_r:
            t0 = time.perf_counter()
            back = orbax_read.restore(str(log / "ckpt_model" / "2" /
                                          "default"))
            back = {"params": {k: v.to("cuda")
                               for k, v in back["params"].items()},
                    "opt_state": {"count": back["opt_state"]["count"], **{
                        key: {k: v.to("cuda") for k, v in
                              back["opt_state"][key].items()}
                        for key in ("mu", "nu")}}}
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t0
            mgr = CheckpointManager(str(log))
            best = mgr.restore_best()["params"]
            best_read_s = time.perf_counter() - t0 - read_s
    live = model.state_dict()
    for label, got, want in (("parameter", back["params"], live),
                             ("best parameter", best, live),
                             ("mu", back["opt_state"]["mu"], state["mu"]),
                             ("nu", back["opt_state"]["nu"], state["nu"])):
        if set(got) != set(want):
            raise PhaseError(f"Orbax run: {label} names differ: "
                             f"{sorted(set(got) ^ set(want))[:4]}")
        for k, v in want.items():
            g = got[k]
            if g.dtype != v.dtype or not torch.equal(g.to(v.device), v):
                raise PhaseError(f"Orbax run: {label} {k} read back "
                                 "differs")
    if back["opt_state"]["count"] != state["count"] or mgr.steps() != [2]:
        raise PhaseError(f"Orbax run: count {back['opt_state']['count']} "
                         f"of {state['count']}, steps {mgr.steps()}")
    if mgr.best_metric_from_marker() != float(f"{losses['loss']:.4f}"):
        raise PhaseError("Orbax run: the best marker reads "
                         f"{mgr.best_metric_from_marker()}")
    step_read = sum(t.numel() * t.element_size() for t in (
        *back["params"].values(), *back["opt_state"]["mu"].values(),
        *back["opt_state"]["nu"].values()))
    say(13, f"Orbax run: save_step wrote {n_step} B ({n_step / 2**30:.2f} "
            f"GiB: {len(live)} parameters, {len(state['mu'])} x 2 moments, "
            f"counts) in {step_s:.2f} s ({n_step / step_s / 1e9:.2f} GB/s), "
            f"save_best {n_best} B in {best_s:.2f} s "
            f"({n_best / best_s / 1e9:.2f} GB/s); RSS peak while writing "
            f"{rss_w.peak / 2**30:.2f} GiB (from {rss_w.start / 2**30:.2f}); "
            f"orbax_read.restore without tensorstore read {step_read} B "
            f"onto the card in {read_s:.2f} s "
            f"({step_read / read_s / 1e9:.2f} GB/s; warm page cache), the "
            f"best parameters in {best_read_s:.2f} s; RSS peak while reading"
            f" {rss_r.peak / 2**30:.2f} GiB (from {rss_r.start / 2**30:.2f})"
            f"; every parameter, moment and the count bit-equal, the marker "
            f"{mgr.best_metric_from_marker()} on {gpu}")
    del model, opt, step, params, state, back, best, live
    torch.cuda.empty_cache()
    return used, n_step + n_best


def _jax_dir_round_trip(torch, gpu, lm, samples, label, path):
    """Write `lm` as the JAX package's model directory at `path`, read it
    back on the card, hold the state and the main path's outputs and
    launches bit-equal, delete the directory. Returns (the read-back
    run's launches, the model file's bytes)."""
    import resource
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.api import GroveForCausalLM
    from grove_tpu_torch.checkpoint.flax_msgpack import (MODEL_FILE,
                                                          save_jax_pretrained)
    with _RssPeak() as rss_w:
        t0 = time.perf_counter()
        n = save_jax_pretrained(lm, str(path))
        write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with _RssPeak() as rss_r:
        t0 = time.perf_counter()
        back = GroveForCausalLM.from_pretrained(str(path),
                                                dtype=lm.model.dtype,
                                                device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    peak_dev = torch.cuda.max_memory_allocated()
    read = os.path.getsize(path / MODEL_FILE)
    shutil.rmtree(path)
    if back.cfg != lm.cfg:
        raise PhaseError(f"{label}: the config read back differs")
    want, got = lm.model.state_dict(), back.model.state_dict()
    if set(want) != set(got):
        raise PhaseError(f"{label}: state keys differ: "
                         f"{sorted(set(want) ^ set(got))[:4]}")
    for k, v in want.items():
        if got[k].dtype != v.dtype or not torch.equal(got[k], v):
            raise PhaseError(f"{label}: {k} read back differs")
    say(13, f"{label}: wrote {n} B ({n / 2**30:.2f} GiB) in {write_s:.1f} s "
            f"({n / write_s / 1e9:.2f} GB/s), read {read} B back onto the "
            f"card in {load_s:.1f} s ({read / load_s / 1e9:.2f} GB/s); "
            f"{len(want)} tensors bit-equal; RSS peak while writing "
            f"{rss_w.peak / 2**30:.2f} GiB (from {rss_w.start / 2**30:.2f}),"
            f" while reading {rss_r.peak / 2**30:.2f} GiB (from "
            f"{rss_r.start / 2**30:.2f}); the process's ru_maxrss "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
            f" GiB; device peak while reading {peak_dev / 2**30:.2f} GiB "
            f"({(peak_dev - base) / 2**30:.2f} above the "
            f"{base / 2**30:.2f} before) on {gpu}")
    from grove_tpu_torch.api.processor import _decode_kwargs
    from grove_tpu_torch.infer.sliding import infer_clips_batched
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    tok = MockTokenizer(model_max_length=lm.cfg.max_seq_len)
    runs = {}
    for who, m in (("in memory", lm.model), ("read back", back.model)):
        kw = _decode_kwargs("int8" if label == "flagship" else None, True,
                            device=m.device)
        with _GenSpy() as spy:
            _kernels.reset_launch_counts()
            outs, ms = _timed(torch, lambda: infer_clips_batched(
                m, m.cfg, tok, samples, max_new_tokens=64,
                decode_kwargs=kw))
            used = {k: v.launches for k, v in _kernels.KERNELS.items()
                    if v.launches}
        runs[who] = (outs, spy.ids, used, ms)
    (o1, ids1, l1, ms1), (o2, ids2, l2, ms2) = runs.values()
    if len(ids1) != len(ids2) or not all(
            a.shape == b.shape and np.array_equal(a, b)
            for a, b in zip(ids1, ids2)):
        raise PhaseError(f"{label}: the greedy tokens differ")
    for i, (a, b) in enumerate(zip(o1, o2)):
        if not _bit_equal(a, b):
            raise PhaseError(f"{label} clip {i}: the outputs differ")
    if l1 != l2:
        raise PhaseError(f"{label}: launches {l2} read back, {l1} in "
                         "memory")
    missing = [k for k in JAX_DIR_NEED[label] if not l2.get(k)]
    if missing:
        raise PhaseError(f"{label}: the main path launched no {missing}")
    say(13, f"{label}: infer_clips_batched over {len(samples)} clips, in "
            f"memory {ms1:.1f} ms, read back {ms2:.1f} ms: "
            f"{sum(a.size for a in ids1)} greedy tokens identical, every "
            f"output bit-equal (captions {[o['text'][:30] for o in o2][:2]})"
            f", launches equal {l2} on {gpu}")
    del back
    torch.cuda.empty_cache()
    return l2, n


def _bit_equal(x, y) -> bool:
    """Nested outputs (dicts, lists, tuples, arrays, numbers, str) equal
    bit for bit."""
    if isinstance(x, dict):
        return (isinstance(y, dict) and set(x) == set(y)
                and all(_bit_equal(x[k], y[k]) for k in x))
    if isinstance(x, (list, tuple)):
        return (isinstance(y, (list, tuple)) and len(x) == len(y)
                and all(_bit_equal(a, b) for a, b in zip(x, y)))
    if isinstance(x, (np.ndarray, np.generic)):
        x, y = np.asarray(x), np.asarray(y)
        return (x.dtype == y.dtype and x.shape == y.shape
                and x.tobytes() == y.tobytes())
    return type(x) is type(y) and x == y


def main() -> int:
    compiles = {}
    disk = None
    try:
        if not (ROOT / "grove_tpu_torch" / "__init__.py").is_file():
            raise PhaseError(f"grove_tpu_torch not found beside {__file__}")
        sys.path.insert(0, str(ROOT))
        import torch
        gpu = phase_device(torch)
        decoder = phase_decoder()
        disk = _DiskLedger()
        torch.backends.cuda.matmul.allow_tf32 = False
        phase_build(compiles)
        disk.mark("phase 1")
        rows = phase_kernels(torch, gpu, compiles)
        disk.mark("phase 2")
        launches = phase_slice(torch, gpu, decoder)
        disk.mark("phase 3")
        fp32 = phase_parity(torch, decoder)
        disk.mark("phase 4")
        launches.update({k: fp32[k] for k in (LN_KERNEL, *FP32_SIMT,
                                              "sam_window_attention")})
        train = phase_train(torch, gpu)
        launches.update({k: train[k] for k in TRAIN_KERNELS})
        disk.mark("phase 5")
        fp32_train = phase_train_parity(torch)
        launches.update({k: fp32_train[k] for k in FP32_STEP_SIMT})
        disk.mark("phase 6")
        phase_loader(torch, gpu)
        disk.mark("phase 7")
        phase_driver(torch, gpu)
        disk.mark("phase 8")
        serve_launches = phase_serve(torch, gpu, decoder)
        disk.mark("phase 9")
        infer_launches, full = phase_infer(torch, gpu)
        disk.mark("phase 10")
        region_launches = phase_region(torch, gpu, full)
        disk.mark("phase 11")
        parallel_launches, ranks_launches = phase_parallel(torch, gpu,
                                                           full)
        disk.mark("phase 12")
        jax_dir_launches, orbax_launches = phase_jax_dirs(torch, gpu, full)
        disk.mark("phase 13")
        del full
        disk.close()
    except Exception:                       # report, then fail the run
        traceback.print_exc()
        print("chip_smoke FAILED", file=sys.stderr, flush=True)
        return 1
    finally:
        _stop_tc_compiles(compiles)
        if disk is not None:
            shutil.rmtree = disk._real

    from grove_tpu_torch import _kernels
    kernels = []
    for name, k in _kernels.KERNELS.items():
        row = {"name": name, "route": "cuda", "source": k.source,
               "replaces": k.replaces, "launches": launches[name],
               "serve_launches": serve_launches[name],
               "infer_launches": {task: got.get(name, 0)
                                  for task, got in infer_launches.items()},
               "region_launches": region_launches[name],
               "parallel_launches": parallel_launches.get(name, 0),
               "ranks_launches": [r.get(name, 0) for r in ranks_launches],
               "jax_dir_launches": jax_dir_launches.get(name, 0),
               "orbax_step_launches": orbax_launches.get(name, 0)}
        row.update(rows[name])
        kernels.append(row)
    print(json.dumps({"kernels": kernels, "decoder": decoder}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# --phases cards: the parallel paths across cards (not part of the one-card
# run above)
# ---------------------------------------------------------------------------

CARDS = 4
ZERO_GRAD = 1e-6         # an fp32 gradient zero up to rounding, of the largest
CARDS_DRIVER = ["--synthetic", "--model_size", "small", "--model_max_length",
                "129", "--epochs", "1", "--steps_per_epoch", "3",
                "--num_workers", "1", "--warmup_steps", "0", "--lr", "1e-5",
                "--seed", "7", "--val_mode", "loss", "--batch_size", "2",
                "--device", "cuda"]


# `--phases cards`' pipeline one stage a card: small() in fp32 (TF32 off)
# against data parallelism on the same shards, 3 steps, 2 rows a rank in 2
# microbatches; and the full width in bf16 over CARDS stages
CARDS_PIPE_FP32 = ["--synthetic", "--model_size", "small",
                   "--model_max_length", "129", "--epochs", "1",
                   "--steps_per_epoch", "3", "--num_workers", "1",
                   "--warmup_steps", "0", "--lr", "1e-5", "--seed", "7",
                   "--val_mode", "loss", "--device", "cuda"]
CARDS_PIPE_TOL = 2e-5    # checkpoints vs data parallelism, abs. and rel.
CARDS_MICRO = 4


def _driver_ckpt(torch, argv, nprocs, root):
    """`train.driver` on `nprocs` ranks (one card each, NCCL) with
    CARDS_DRIVER; returns its last checkpoint."""
    from grove_tpu_torch.parallel.launch import launch
    launch(["-m", "grove_tpu_torch.train.driver", *CARDS_DRIVER, *argv,
            "--log_base_dir", str(root)], nprocs, timeout=600)
    return torch.load(root / "grove_tpu" / "ckpt_model" / "3" / "state.pt",
                      map_location="cpu", weights_only=True)


def _zero_grads(torch, tmp):
    """The trainable tensors of `small()` whose gradient is zero up to
    rounding (below ZERO_GRAD of the largest) in an unsharded fp32 step
    on the card: zero in exact arithmetic, as the attention's key biases
    (softmax ignores a shift of the keys)."""
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    cfg = GroveConfig.small()
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    _, _, grads = _reference_step(torch, tmp,
                                  [_train_batch(cfg, tok, seed=42)])
    top = max(float(g.abs().max()) for g in grads.values())
    return {n for n, g in grads.items()
            if float(g.abs().max()) <= ZERO_GRAD * top}


def _ckpt_distance(got, want, zero):
    """Each checkpoint parameter's max-abs distance, relative to its own
    max-abs, split into the tensors of `zero` (gradients zero up to
    rounding: Adam turns their rounding noise into steps of about lr, of
    either sign) and the rest; each as (name, distance) worst first."""
    if set(got["params"]) != set(want["params"]):
        raise PhaseError("the checkpoints hold other parameters")
    dist = {}
    for n, w in want["params"].items():
        w, g = w.float(), got["params"][n].float()
        if not bool(g.isfinite().all()):
            raise PhaseError(f"non-finite checkpoint tensor {n}")
        dist[n] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
    order = sorted(dist.items(), key=lambda kv: -kv[1])
    return ([kv for kv in order if kv[0] in zero],
            [kv for kv in order if kv[0] not in zero])


def _need_cards(torch):
    if torch.cuda.device_count() < CARDS:
        raise PhaseError(f"--phases cards needs {CARDS} cards, this machine "
                         f"has {torch.cuda.device_count()}")


def phase_cards(torch, gpu, decoder):
    """The driver across cards over NCCL, one card a rank (`--phases
    cards`, on a machine of CARDS cards), small() in bf16, 3 steps: world
    1; `--pipeline_stages 2` with its stages on cuda:0 and cuda:1, whose
    checkpoint must be bit-equal to world 1's; `--multihost --mesh_model
    2`, whose checkpoint is compared tensor by tensor with world 1's
    (`_ckpt_distance`, printed), the tensors whose gradient is zero up to
    rounding in an fp32 step (`_zero_grads`) apart. Then the pipeline one
    stage a card: `--multihost --pipeline_stages 2` in fp32 against data
    parallelism (`_cards_pipeline_driver`), and GroveConfig() in bf16 over
    CARDS cards with its bubble (`_cards_pipeline_full`). Then the same
    under data parallelism, 2 stages x 2 replicas: the driver in fp32
    against data parallelism over CARDS cards, and GroveConfig() in bf16
    (`_cards_replicas_full`)."""
    _need_cards(torch)
    tmp = Path(tempfile.mkdtemp(prefix="grove_cards_"))
    try:
        t0 = time.perf_counter()
        zero = _zero_grads(torch, tmp)
        one = _driver_ckpt(torch, [], 1, tmp / "one")
        pp = _driver_ckpt(torch, ["--pipeline_stages", "2",
                                  "--pipeline_microbatches", "2"], 1,
                          tmp / "pp")
        same = sum(torch.equal(v, pp["params"][k])
                   for k, v in one["params"].items())
        if same != len(one["params"]):
            raise PhaseError(f"the 2-card pipelined checkpoint: {same} of "
                             f"{len(one['params'])} tensors bit-equal to "
                             "world 1's")
        say(12, f"driver small() bf16, 3 steps: --pipeline_stages 2 on "
                f"cuda:0, cuda:1 = world 1, {same} of {same} checkpoint "
                "tensors bit-equal")
        tp = _driver_ckpt(torch, ["--multihost", "--mesh_model", "2"], 2,
                          tmp / "tp")
        noise, rest = _ckpt_distance(tp, one, zero)
        say(12, f"driver --multihost --mesh_model 2 on 2 cards vs world 1, "
                f"each parameter's max-abs distance / its max-abs: the "
                f"{len(noise)} whose fp32 gradient is zero up to rounding "
                f"(< {ZERO_GRAD} of the largest), the worst {noise[:4]}; "
                f"the {len(rest)} others, the worst {rest[:4]} "
                f"({time.perf_counter() - t0:.1f} s)")
        _cards_pipeline_driver(torch, tmp, zero)
        _cards_pipeline_full(torch, gpu, tmp)
        _cards_pipeline_driver(torch, tmp, zero, replicas=REPLICAS)
        _cards_replicas_full(torch, gpu, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _fp32_driver_ckpt(torch, argv, nprocs, root):
    """`train.driver.main` through `parallel.workers.driver` in fp32 on
    `nprocs` ranks, one card each (NCCL), TF32 off, with CARDS_PIPE_FP32;
    returns its last checkpoint and rank 0's output."""
    from grove_tpu_torch.parallel.launch import launch
    outs = launch(["-m", "grove_tpu_torch.parallel.workers", "driver",
                   json.dumps(dict(argv=CARDS_PIPE_FP32 + list(argv) + [
                       "--log_base_dir", str(root)], dtype="fp32",
                       device="cuda"))],
                  nprocs, timeout=600, env={"NVIDIA_TF32_OVERRIDE": "0"})
    return torch.load(root / "grove_tpu" / "ckpt_model" / "3" / "state.pt",
                      map_location="cpu", weights_only=True), outs[0]


def _allclose_excess(torch, got, want, zero):
    """Every tensor of two checkpoints (parameters and optimizer state)
    against |got - want| <= CARDS_PIPE_TOL (1 + |want|), elementwise, as
    the CPU tests hold the pipelined driver's checkpoint to data
    parallelism's (`tests/test_torch_pipeline_ranks.py`), but those named
    in `zero`:
    [(key, the largest excess over that bound)], worst first."""
    flat = {}

    def walk(a, b, path):
        if isinstance(b, dict):
            if set(a) != set(b):
                raise PhaseError(f"the checkpoints differ in {path} keys")
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, torch.Tensor):
            if path.split("/")[-1] not in zero and b.is_floating_point():
                d = (a.double() - b.double()).abs()
                flat[path] = float((d - CARDS_PIPE_TOL * (1 + b.double()
                                                          .abs())).max())
        elif a != b:
            raise PhaseError(f"the checkpoints differ at {path}: {a}, {b}")
    walk(got, want, "")
    return sorted(flat.items(), key=lambda kv: -kv[1])


# rows a rank and microbatches of `_cards_pipeline_driver` by replicas of 2
# stages: the synthetic set holds max(4, 2 x --batch_size) clips, so 4
# ranks read one row each and a replica's 2 rows run as one microbatch
CARDS_PIPE_LAYOUTS = {1: (2, 2), 2: (1, 1)}


def _cards_pipeline_driver(torch, tmp, zero, replicas=1):
    """`--multihost --pipeline_stages 2` on 2 x `replicas` cards (one stage
    a rank over NCCL, `replicas` replicas; rows a rank and microbatches
    from CARDS_PIPE_LAYOUTS) against `--multihost` data parallelism on as
    many cards at as many rows a rank (each rank reading the same shard:
    the same global batch), small() in fp32, 3 steps: every tensor of the
    checkpoint, moments included, within CARDS_PIPE_TOL (absolute and
    relative, `_allclose_excess`), but those of `zero` (gradients zero up
    to rounding); each parameter's max-abs distance relative to its
    max-abs printed (`_ckpt_distance`)."""
    t0 = time.perf_counter()
    procs = 2 * replicas
    rows, micro = CARDS_PIPE_LAYOUTS[replicas]
    one, _ = _fp32_driver_ckpt(torch, ["--multihost", "--batch_size",
                                       str(rows)], procs,
                               tmp / f"fp32_dp{procs}")
    pp, out = _fp32_driver_ckpt(torch, [
        "--multihost", "--pipeline_stages", "2", "--pipeline_microbatches",
        str(micro), "--batch_size", str(rows)], procs,
        tmp / f"fp32_pp{procs}")
    line = next((x for x in out.splitlines()
                 if x.startswith("pipeline-parallel LLM")), "")
    if (f"one a rank, 2 stages x {replicas} replicas" not in line
            or "over nccl" not in line):
        raise PhaseError(f"the {procs}-card pipeline ran as {line!r}")
    excess = _allclose_excess(torch, pp, one, zero)
    if excess[0][1] > 0:
        raise PhaseError(f"the {procs}-card pipeline's checkpoint is off "
                         f"data parallelism's by more than {CARDS_PIPE_TOL} "
                         f"(1 + |x|): {excess[:4]}")
    noise, rest = _ckpt_distance(pp, one, zero)
    say(12, f"driver small() fp32, 3 steps: {line!r}; its checkpoint vs "
            f"--multihost data parallelism on {procs} cards, {rows} row(s) "
            f"a rank: {len(excess)} tensors (parameters and "
            f"moments) within {CARDS_PIPE_TOL} (1 + |x|), the closest to "
            f"the bound {excess[:3]} (excess, <= 0); each parameter's "
            f"max-abs distance / its max-abs, the worst {rest[:4]}; the "
            f"{len(noise)} whose fp32 gradient is zero up to rounding, the "
            f"worst {noise[:4]} ({time.perf_counter() - t0:.1f} s)")


def _cards_pipeline_full(torch, gpu, tmp):
    """GroveConfig() in bf16 one stage a card over NCCL: CARDS stages of
    8 layers, one row a rank (a global batch of CARDS at S = 704),
    CARDS_MICRO microbatches; a warm step, then two steps with every
    launch count set to 0 before each: each rank's launches exact, finite
    losses, each rank's step ms, peak memory and busy share, and the
    bubble from CUDA events around each stage's microbatch work beside
    GPipe's (n - 1) / (m + n - 1)."""
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.parallel.launch import launch
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch.text.tokenizer import special_token_ids_from
    cfg = dataclasses.replace(GroveConfig(), max_seq_len=TRAIN_SEQ)
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    cfg = dataclasses.replace(cfg, tokens=special_token_ids_from(tok))
    batch = _train_batch(cfg, tok, seed=37, n=CARDS)
    with open(tmp / "full.pkl", "wb") as f:
        pickle.dump(cfg, f)
    torch.save(batch, tmp / "full_batch.pt")
    t0 = time.perf_counter()
    launch(["-m", "grove_tpu_torch.parallel.workers", "pipeline_step",
            json.dumps(dict(out=str(tmp / "full.pt"),
                            batch=str(tmp / "full_batch.pt"),
                            microbatches=CARDS_MICRO,
                            config_file=str(tmp / "full.pkl"), seed=0,
                            dtype="bf16", optimizer={"warmup_steps": 1},
                            warm_steps=1, steps=2, grads=False,
                            device="cuda"))], CARDS, timeout=900)
    secs = time.perf_counter() - t0
    got = torch.load(tmp / "full.pt", weights_only=False)
    s = batch["input_ids"].shape[1]
    _check_ranks(got, cfg, s, CARDS, CARDS_MICRO, "full-width pipeline")
    for terms in got["metrics"]:
        _check_losses(terms, "full-width pipeline")
    for step in range(len(got["metrics"])):
        busy, shares, bubble, gpipe = _stage_shares(got["ranks"], step,
                                                    CARDS, CARDS_MICRO)
        per = ", ".join(
            f"stage {r['stage']} {r['steps'][step]['ms']:.1f} ms, peak "
            f"{r['steps'][step]['peak'] / 2**30:.2f} GiB, busy "
            f"{busy[k]:.1f} ms = {shares[k]:.3f}"
            for k, r in enumerate(got["ranks"]))
        say(12, f"GroveConfig() bf16 pipeline one stage a card, {CARDS} "
                f"stages x {cfg.llama.num_layers // CARDS} layers over "
                f"{got['ranks'][0]['transport']}, batch {CARDS} x S = {s}, "
                f"{CARDS_MICRO} microbatches, step {step + 1}: {per}; "
                f"bubble {bubble:.3f} (GPipe (n - 1) / (m + n - 1) = "
                f"{gpipe:.3f}); losses {got['metrics'][step]}; launches "
                f"exact on each rank, {gpu}")
    say(12, f"full-width pipeline across {CARDS} cards: {secs:.1f} s with "
            "the processes' start and the warm step")


# the full width under data parallelism: the decoder trainable (under the
# default freeze policy its layers hold no trainable tensor, and the stage
# groups would sum nothing), 2 rows a rank, CARDS_MICRO microbatches a
# replica
REPLICAS_FULL_OPT = {"warmup_steps": 1, "full_llm": True}
REPLICAS_FULL_ROWS = 2


def _cards_replicas_full(torch, gpu, tmp):
    """GroveConfig() in bf16 as REPLICA_STAGES stages x REPLICAS replicas,
    one card a rank over NCCL: REPLICA_STAGES stages of 16 layers, the
    decoder trainable (REPLICAS_FULL_OPT), REPLICAS_FULL_ROWS rows a rank
    (a global batch of 8 at S = 704), CARDS_MICRO microbatches a replica;
    a warm step, then two steps with every launch count set to 0 before
    each: each rank's launches exact, finite losses, the replicas' copies
    of each stage bit-equal after the steps; each rank's step ms, peak
    memory, busy share and the CUDA-event ms of its stage group's
    gradient sum (its bytes beside it), and each replica's bubble beside
    GPipe's (n - 1) / (m + n - 1)."""
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.parallel.launch import launch
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch.text.tokenizer import special_token_ids_from
    cfg = dataclasses.replace(GroveConfig(), max_seq_len=TRAIN_SEQ)
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    cfg = dataclasses.replace(cfg, tokens=special_token_ids_from(tok))
    n = REPLICA_STAGES
    batch = _train_batch(cfg, tok, seed=38, n=REPLICAS_FULL_ROWS * CARDS)
    with open(tmp / "full.pkl", "wb") as f:
        pickle.dump(cfg, f)
    torch.save(batch, tmp / "replicas_batch.pt")
    t0 = time.perf_counter()
    launch(["-m", "grove_tpu_torch.parallel.workers", "pipeline_step",
            json.dumps(dict(out=str(tmp / "replicas.pt"),
                            batch=str(tmp / "replicas_batch.pt"),
                            microbatches=CARDS_MICRO,
                            config_file=str(tmp / "full.pkl"), seed=0,
                            dtype="bf16", optimizer=REPLICAS_FULL_OPT,
                            warm_steps=1, steps=2, grads=False,
                            replicas=REPLICAS, device="cuda"))], CARDS,
           timeout=900)
    secs = time.perf_counter() - t0
    got = torch.load(tmp / "replicas.pt", weights_only=False)
    s = batch["input_ids"].shape[1]
    label = f"full-width {n} stages x {REPLICAS} replicas"
    want = _check_ranks(got, cfg, s, n, CARDS_MICRO, label)
    compared = _check_replicas(got, n, label)
    for terms in got["metrics"]:
        _check_losses(terms, label)
    ranks = got["ranks"]
    for step in range(len(got["metrics"])):
        per, bubbles = [], []
        for d in range(REPLICAS):
            mine = ranks[d * n:(d + 1) * n]
            busy, shares, bubble, gpipe = _stage_shares(mine, step, n,
                                                        CARDS_MICRO)
            bubbles.append(f"replica {d} {bubble:.3f}")
            per += [f"rank {d * n + k} (replica {d}, stage {r['stage']}) "
                    f"{r['steps'][step]['ms']:.1f} ms, peak "
                    f"{r['steps'][step]['peak'] / 2**30:.2f} GiB, busy "
                    f"{busy[k]:.1f} ms = {shares[k]:.3f}, stage sum "
                    f"{_stage_sum_ms(r, step):.2f} ms"
                    for k, r in enumerate(mine)]
        say(12, f"GroveConfig() bf16 pipeline under data parallelism, {n} "
                f"stages x {cfg.llama.num_layers // n} layers x {REPLICAS} "
                f"replicas over {ranks[0]['transport']}, the decoder "
                f"trainable, {REPLICAS_FULL_ROWS} rows a rank (batch "
                f"{REPLICAS_FULL_ROWS * CARDS} x S = {s}), {CARDS_MICRO} "
                f"microbatches a replica, step {step + 1}: "
                + "; ".join(per) + f"; bubble {', '.join(bubbles)} (GPipe "
                f"(n - 1) / (m + n - 1) = {gpipe:.3f}); stage sums of "
                f"{ranks[0]['stage_bytes']:,} B a rank; losses "
                f"{got['metrics'][step]}; launches exact on each rank "
                f"{want}, {gpu}")
    say(12, f"{label} across {CARDS} cards: {compared} tensors of each "
            f"stage's copies bit-equal across the replicas after the "
            f"steps; {secs:.1f} s with the processes' start and the warm "
            "step")


def phase_cards_steps(torch, gpu, decoder):
    """`--phases cards_steps`, on a machine of CARDS cards over NCCL, one
    card a rank: `parallel.workers.train_step` in fp32 against the
    unsharded step on the global batch, DP = 2 on two local batches with
    different box counts and TP = 2 x DP = 2 (`_worker_steps`), then at
    S = 704 TP = 2 x DP = 2 with sequence parallelism, and FSDP2 and
    ZeRO-2 moments at DP = 4; then the multi-host demo on CARDS processes,
    twice."""
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch.tools import multihost_demo
    _need_cards(torch)
    tmp = Path(tempfile.mkdtemp(prefix="grove_cards_"))
    try:
        cfg = GroveConfig.small()
        tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
        batches = [_train_batch(cfg, tok, seed=42),
                   _train_batch(cfg, tok, seed=43)]
        boxes = [int(b["gt_objectness"].sum()) for b in batches]
        if boxes[0] == boxes[1]:
            raise PhaseError(f"the local batches hold {boxes} boxes")
        _worker_steps(torch, tmp, batches,
                      {"DP = 2": (2, 1, {}),
                       "TP = 2 x DP = 2": (CARDS, 2, {})},
                      f"one card a rank over NCCL, {boxes} visible boxes")
        _cards_sharded_steps(torch, tmp)

        for run in range(2):
            t0 = time.perf_counter()
            result = multihost_demo.main([
                "--num_processes", str(CARDS), "--num_videos",
                str(2 * CARDS), "--steps", "2", "--device", "cuda",
                "--workdir", str(tmp / f"demo{run}"),
                "--timeout", "300"])
            say(12, f"multi-host demo run {run + 1}, {CARDS} processes on "
                    f"{CARDS} cards: disjoint shards {result['shards']}, "
                    f"losses by step {result['losses']} in "
                    f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cards_sharded_steps(torch, tmp):
    """`_worker_steps` at S = 704 over CARDS cards: TP = 2 x DP = 2 with
    sequence parallelism, FSDP2 at DP = 4 and ZeRO-2 moments at DP = 4,
    each against the unsharded fp32 step. S = 704 because the LLaMA
    slices the sequence over "model" only where S divides by its size
    (small()'s own 1087 tokens run unsliced)."""
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    cfg = dataclasses.replace(GroveConfig.small(), max_seq_len=TRAIN_SEQ)
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    four = [_train_batch(cfg, tok, seed=44 + i) for i in range(CARDS)]
    s = four[0]["input_ids"].shape[1]
    if s % 2:
        raise PhaseError(f"sequence parallelism needs an even S, not {s}")
    where = f"one card a rank over NCCL, S = {s}"
    _worker_steps(torch, tmp, four[:2],
                  {"TP = 2 x DP = 2 + SP": (CARDS, 2, {"sp": True})}, where)
    _worker_steps(torch, tmp, four,
                  {"FSDP, DP = 4": (CARDS, 1, {"fsdp": True}),
                   "ZeRO-2, DP = 4": (CARDS, 1, {"zero": True})}, where)


AB_PHASES = ("slice", "serve", "cards", "cards_steps")


def main_phases(argv) -> int:
    """`--phases`: see the module docstring."""
    import importlib.util
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--phases", required=True,
                    help=f"comma-separated, of {', '.join(AB_PHASES)}")
    ap.add_argument("--tree", default=str(ROOT),
                    help="the checkout whose chip_smoke.py runs them")
    args = ap.parse_args(argv)
    names = args.phases.split(",")
    if not set(names) <= set(AB_PHASES):
        ap.error(f"--phases: {args.phases} is not a list of {AB_PHASES}")
    tree = Path(args.tree).resolve()
    spec = importlib.util.spec_from_file_location("chip_smoke_tree",
                                                  tree / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not (tree / "grove_tpu_torch" / "__init__.py").is_file():
        print(f"grove_tpu_torch not found in {tree}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree))
    import torch
    compiles = {}
    try:
        gpu = mod.phase_device(torch)
        decoder = mod.phase_decoder()
        torch.backends.cuda.matmul.allow_tf32 = False
        mod.phase_build(compiles)
        mod._stop_tc_compiles(compiles)     # their reports are phase 2's
        for name in names:
            getattr(mod, f"phase_{name}")(torch, gpu, decoder)
    except Exception:                       # report, then fail the run
        traceback.print_exc()
        print("chip_smoke FAILED", file=sys.stderr, flush=True)
        return 1
    finally:
        mod._stop_tc_compiles(compiles)
    return 0


if __name__ == "__main__":
    sys.exit(main_phases(sys.argv[1:]) if len(sys.argv) > 1 else main())
