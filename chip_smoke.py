#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``ppgs_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

The phases run in order; each raises on failure and nothing is caught, so
any failure exits non-zero before the result line:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ppgs_tpu_torch/kernels/csrc with nvcc;
3. K1 (the QKV projection) at odd shapes against its plain version (rows
   1, 63, 64, 65, 127, 128, 129, 1000, the mel model's weights); K3 (the
   output projection and LN1) at C = 256 on K1's rows, seeded weights; K4 (the
   FFN) likewise (rows 1, 63, 64, 65, 127, 129, 1000; hidden widths 128,
   384 and the model's; round_input 0 and 1); K2 (attention) at d_head 128 likewise (T of 1, 63, 64, 65,
   127, 129, 500, 1536; a prefix mask and one with holes; causal off and
   on; scale_log2 1 and log2(e)/sqrt(d); a wholly masked window exactly
   0); then hold each kernel against its plain PyTorch version on
   the card, at the main path's shapes (128 windows x 500 frames of the
   mel model: C = 256, 2 heads of 128, FFN 2048), plus the attention kernel at T = 1536 with
   and without the causal mask and a wholly masked window, the per-layer
   FFN variant, the whole 5-layer stack, and the fused log-mel kernel (B9),
   first at odd shapes (hops 160, 100, 320 and 640; B 1-3; T 1, 7, 127,
   128, 129, 255, 803, 1000; silent and loud audio), then at 64 x 8 s, each
   within atol 8e-3 with 99.9% of the values within 1e-4;
4. the main path, ``from_audio`` on 64 utterances x 8 s of seeded random
   audio with seeded random weights: shape, softmax columns, every kernel
   launched, and the first rows against ``from_audio(..., device='cpu')``;
   then ``legacy_mode`` on a 12 s utterance (T = 1200 > 1024), which takes
   the per-layer path through the attention and FFN kernels; then the main
   path with ``PPGS_TPU_FUSED_MEL=1``: B9 launched once, K1-K4 as before,
   the PPGs against the default path's;
5. times with CUDA events (warm-up, then the median of 20 runs) of each
   kernel, its plain version and a PyTorch library call computing the same
   function (``nn.TransformerEncoder`` for the whole stack), beside the
   kernel's bound; end-to-end audio-seconds per second of ``from_audio``
   (with and without the fused log-mel); and the device time by kernel of
   one ``from_audio`` call (torch.profiler) with the card's idle share; K4's,
   K3's, K2's, K1's and B9's device time per launch beside their event
   times;
6. the gemm kernel against its plain version at small odd shapes (each
   (ta, tb), a bf16 and an fp32 a, both block widths, ragged rows, depths
   and splits), and K4's two train forms at phase 3's odd shapes with
   dropout off and 0.1 (the hidden's keep words against Philox's bits),
   ffn_train_bwd at K4's rows and hidden widths 128, 384 and 2048 (fp32 x
   with the residual and bf16 x; dropout off and 0.1; the training shape's
   limits over the cases pooled), and K1 at phase 3's rows with the train
   layer's unfolded weights, K3's train form there (dropout off and 0.1,
   the normalised rows and 1/std, its mask the plain one's bit for bit),
   and attention_train_fwd and attention_train_bwd at T
   of 1, 63, 64, 65, 127, 128, 129, 500, 512, 1000, 1024 (ragged, holed,
   wholly masked and full windows; causal off and on; dropout off and 0.1;
   the forward with and without its fp32 o, its keep words against
   Philox's bits; the backward's bf16, fp32 and both outputs; two calls bit
   for bit), before anything is timed; K1 at the training shape; the train
   kernels
   against their plain versions at the training shape (256 windows x 512 frames, ragged,
   one wholly masked) with dropout 0.1 and the same Philox masks on both
   sides (K3's mask bit for bit; K4's hidden keep words against Philox's
   bits; ffn_train_bwd
   reading them, its plain version drawing its own), with the six gemm
   forms of a layer's backward (dW1, dW2, dWo, dWqkv split and summed, da,
   dx), dW1 and dWo again on 128,000 rows (a
   ragged last split) and dW1 twice, bit for bit; colsum at each of its
   shapes in a step (two calls bit for bit, its bf16 rounding that of its
   sums); then the whole-layer
   function
   (out, dx and its 14 gradients) and the attention (with and without the
   causal mask) and FFN train functions at the per-layer path's T = 500;
7. the training main path, ``train()`` of the mel model at full width and
   depth on a seeded synthetic batch: 4 steps at 256 x 512 (the whole-layer
   path) with an evaluation at step 0 and checkpoints, then a resume that
   takes a step at 256 x 500 (the per-layer path); the losses finite and
   falling, every train kernel launched, the launches of each step exact,
   and one step on 4 rows against ``device='cpu'`` with the same seed;
8. times of each train kernel (each gemm form apart, beside
   torch.matmul; K1's and K3's train instances and attention_train_fwd
   beside their device time; attention_train_bwd's device time by pass, dq and dk/dv;
   ffn_train_bwd's device time; colsum's at each step shape beside
   t.sum(0)'s;
   both attention kernels with the dropout off against 0.1, what the
   dropout costs them), its plain
   version, a library call and its bound; the
   three train functions whole against their plain versions and a library
   yardstick; the train step's time, audio-seconds per second and peak
   memory, and a torch.profiler breakdown of one step, its gemm time beside
   the six forms' timed alone;
9. K1 at (768, 2304) and (512, 1536), K3 at C = 768 and 512, K4 at C =
   768 (GELU) and 512, and K2 at d_head 64 (12 heads) and 256, at phase
   3's odd shapes; the w2v2fb
   slice's kernel instances against their plain versions at its
   shapes, with seeded full-size random weights (wav2vec2-base trunk: 12
   layers of C = 768, 12 heads of 64, F = 3072, GELU; the C = 512 head, 2
   heads of 256): K1 at both widths, K2 at d_head 64 (64 x T = 400, one
   wholly masked window) and 256 (128 x 500, and T = 1200 with a wholly
   masked window), K3 and K4 at C = 768 (GELU) and 512, K4's per-layer
   variant at C = 512, the 12-layer GELU stack whole (the TPU's
   encoder_stack_streamed); the conv-stack kernels (B10) first at odd
   shapes (conv_stats and conv0_gelu at B = 1 and 3, 1 ... 1000 frames,
   (k0, s0) = (10, 5), (16, 3) and (1, 1), a normal draw and a loud one
   with a DC offset, conv_stats against an fp64 oracle too; conv_gelu at
   k = 3 and 2, B = 1 and 3, output rows of 1, 63, 64, 65, 127, 128, 129,
   400 and 1001; its first form from audio with conv 1 at those rows,
   conv 0's last block reading past the audio; the whole chain at 1 s,
   2.5 s and 8 s + 37 samples), then at 64 x 8 s (statistics, twice and
   against fp64, conv 0's activation with its GELU guard's share, conv 1
   from the audio, conv 2, the whole chain);
10. the w2v2fb main path, ``from_audio(representation='w2v2fb')`` on 64 x
   8 s of seeded audio, the trunk's weights read from a temporary npz that
   ``W2V2FB_CHECKPOINT`` points at: shape, softmax columns, the exact
   launches of each kernel and width, 4 utterances of 2 s against
   ``device='cpu'``; then the same call with ``PPGS_TPU_CONV_STACK=1``:
   the conv-stack kernels launched, the PPGs against the default path's;
11. times of each w2v2fb kernel instance, its plain version, a library call
   and its bound (conv_stats and conv0_gelu by device time too, beside
   the library's routes to them; for B10's first form, beside conv 1 on a
   stored conv-0 activation, the library's route to the same function
   from the audio:
   conv 0, GroupNorm, GELU, conv 1, GELU); each of B10's six convs by
   device time and CUDA events beside its bound and cuDNN's conv + GELU
   at that shape; the 12-layer stack against
   ``nn.TransformerEncoderLayer`` x 12 and the conv chain against the
   cuDNN bf16 convs; the slice's audio-seconds per second and a
   torch.profiler breakdown; K4's device time per call by kernel at each
   width (phases 5, 8 and 11), and K3's, K2's and K1's at each width
   (phases 5, 8 and 11);
12. the bottleneck slice's rel-pos attention kernel (B8, which forms the
   shifted position term from q_v and pos itself) against its plain
   version, with seeded full-size random weights (the 16-block conformer,
   d = 144, 4 heads of 36, FFN 576; the C = 256 head): 64 x T = 800 from
   block 0's projections with ragged rows and a wholly masked one; random
   operands at T = 1, 63, 64, 65, 129 (the band's edges and diagonal
   tiles), 803 and 2048, k and v views of one fused buffer, one draw
   peaked (q x 4); and the 16 blocks whole on the card against
   ``device='cpu'`` on 2 rows;
13. the bottleneck main path, ``from_audio(representation='bottleneck')``
   on 64 x 8 s, the conformer's weights read from a temporary npz that
   ``BOTTLENECK_CHECKPOINT`` points at: shape, softmax columns, exactly 16
   B8 launches, no ``position_term`` call, and 5 of each of K1-K4 at C =
   256, 4 utterances of 2 s against ``device='cpu'``; then a 25 s
   utterance (T = 2500 > 2048): no B8 launch, a finite output;
14. B8's time (CUDA events and device time), its plain version's, the
   library route's (the position term by cuBLAS, the shifted slice times
   the scale, SDPA with it as a bf16 mask, timed whole) and its bound; the
   conformer whole with B8 and with its plain version, beside its bound and
   a profile of its library calls; the slice's audio-seconds per second,
   its peak memory and a torch.profiler breakdown;
15. the api slice's main path (no kernel of its own): 16 seeded wav files
   of 0.3-20 s, the mel model's seeded weights (phase 4's) as a
   JAX-layout .npz and as the reference architecture's .pt state dict:
   ``from_files_to_files`` on the card, each output ``from_file``'s bit
   for bit, K1-K4 launched; the .pt route the .npz route's bit for bit;
   two files (11.3 s, 20 s) against ``device='cpu'``; ``python -m
   ppgs_tpu_torch --input_paths <dir> --checkpoint <npz>`` as a
   subprocess, its <stem>-ppg.npy files the API's bit for bit; the loop's
   audio-seconds per second and the CLI's wall;
16. the convolution model through ``from_audio`` and the spectrogram
   frontend at 64 x 8 s with seeded weights and audio, 4 x 2 s of each
   against ``device='cpu'`` at fp32 1e-4; both walls;
17. ``distance`` (normalize on and off, each reduction), ``interpolate``,
   ``sparsify`` (constant 0.02, percentile 0.85, topk 3), every edit and
   ``grid.sample`` / ``constant`` / ``of_length`` on phase 15's PPGs and a
   seeded 64 x 40 x 800 batch, each against the same function on CPU
   copies (spans, argmax selections, changed frames and kept classes
   exactly; values at 1e-6, the distance at rtol 1e-4); ``sparsify``'s
   percentile on 64 x 40 x 8000 (past 2^24 elements); the distance and
   sparsify timed by CUDA events;
18. the data slice (no kernel of its own), in a temporary root that the
   port's CACHE_DIR, PARTITION_DIR, CLASS_WEIGHT_FILE, EVAL_DIR and
   RUNS_DIR point at: a seeded corpus named commonvoice (400 wav files of
   0.5-10 s, tones and noise, each with a TextGrid of seeded phoneme
   intervals over the 40 phonemes); the native WAV reader built from the
   port's source and its samples the Python reader's; ``partition.datasets``
   against the seeded 80/10/10 split recomputed; ``load.phoneme_weights``
   computed and held to a numpy bincount of the train partition;
   ``preprocess.datasets(mel)`` on the card, every cache (80, frames)
   float16, the first batches' caches against the same batches with
   ``device='cpu'`` within one float16 ulp;
19. ``train('commonvoice')`` of the mel model at full width and depth with
   its default loaders (dropout 0.1): 12 steps with the step-0 evaluation
   and a checkpoint, a resume for 2 whose batches continue an
   uninterrupted run's, and a run in 5 length buckets (batches of T =
   300-900, the per-layer path); each step's path and exact launches;
   ``evaluate.datasets`` on the test partition with batched_test_eval on
   and off: counts equal, float sums within rtol 1e-6, its JSON files and
   tensors.npz written, K1-K4 launched;
20. ``from_files_to_files(num_workers=4)`` over the 400 files with phase
   4's seeded weights: one (40, frames) output each, K1-K4 launched; the
   first batch's longest file and 7 others against ``from_dataloader``
   with ``device='cpu'`` on that batch (bf16 envelope); its audio-s/s
   beside the file loop's (``num_workers=0``), a torch.profiler breakdown
   of one ``from_dataloader`` batch with the idle share, the phase's peak
   device memory;
21. the head-training slice (the w2v2fb and w2v2fc heads: C = 512, 2
   heads of 256, FFN 2048): the train kernels' instances at that width
   against their plain versions at odd shapes before anything is timed:
   K4's two train forms (phase 6's rows, and rows 2597, 16447 and 40000,
   whose units outnumber the persistent hidden launch's blocks and end in
   a wave that is not full and a row block past M; hidden widths 128, 384
   and 2048, dropout off and 0.1, the hidden's keep words against Philox's
   bits), ffn_train_bwd likewise, attention_train_fwd and
   attention_train_bwd at phase 6's T, windows, causal settings and rates
   (keep words against Philox's bits, two calls bit for bit), and
   ln_dropout_bwd at K4's rows (with and without the LayerNorm, dropout off
   and 0.1, fp32 and bf16 g, its mask's bits Philox's);
22. the train kernels at the head's training shape (256 windows x 512
   frames, ragged, one wholly masked, dropout 0.1 with the same Philox
   masks on both sides; K1 and K3's train form at odd rows first), B4,
   B5 and B6 as wholes forward and backward, one step on 4 rows against
   ``device='cpu'``; then each kernel's times (phase 8's), B4-B6 beside
   their library routes (K4's two train forms and attention_train_fwd
   each by CUDA events and device time beside its bound and library
   route), and the train step's ms, audio-s/s, peak memory and profile at
   256 x 512 and 256 x 500;
23. the slice's main path: ``preprocess.datasets(w2v2fb)`` on a seeded
   corpus of 160 wav files (phase 18's recipe) with the seeded
   wav2vec2-base trunk at ``W2V2FB_CHECKPOINT``, every cache (768, frames)
   and finite; ``train('commonvoice', config=w2v2fb)`` from the caches at
   the config's 150,000-frame budget: 4 steps with the step-0 evaluation
   and a checkpoint, a resume for 2, and an epoch in 8 length buckets
   (T = 300, 500, 700, 900 on the per-layer path); each step's path and
   exact launches, every train kernel launched; ``evaluate.datasets`` on
   the test partition (phase 19's checks);
24. the w2v2 slice (wav2vec2's 100 Hz trunk: conv 6 at stride 1, T = 800
   frames a 8 s row), seeded full-size weights of the Charsiu W2V2FC model
   (``W2V2FC_CHECKPOINT`` pointed at them), the W2V2 model and the w2v2fc
   head in temporary npz files: ``conv_gelu`` at (k, s) = (2, 1) at B = 1
   and 3 and T_in one row past phase 9's odd output rows, then on the
   100 Hz chain's conv-5 output (64 x 801) and the chain whole; K1-K4 on
   the trunk's 64 x 800 rows (K2 at d_head 64 and T = 800 with full, W2V2
   half-length, ragged and wholly masked windows); B7 whole at 64 x 800
   under the full and the W2V2 half-length key mask; each against its
   plain version before anything is timed; then each instance's time by
   CUDA events and device time beside its bound, its plain version and
   its library route, B7 and the 100 Hz chain whole;
25. ``from_audio(config='w2v2fc')`` on 64 x 8 s (the w2v2fc frontend, then
   the C = 512 head), by default and with ``PPGS_TPU_CONV_STACK=1`` (B10,
   conv 6 at s = 1), the W2V2 model (``config='w2v2ft'``) and W2V2FC
   (``'w2v2fc-pretrained'``) through ``from_features`` on the audio: each
   call's exact launches by width (and by stride for B10), shapes and
   softmax columns, 4 utterances of 2 s against ``device='cpu'`` and the
   opt-in against the default path at the bf16 gates (atol 2e-2; argmax
   agreement >= 99.5% on the frames bf16 decides, ``agree_decided``), the
   w2v2fc head's output conv scaled x4 so that its PPGs are not near
   uniform; each path's wall,
   audio-s/s, peak memory and profile (idle share, device time by group);
   ``from_audio`` under ``w2v2fc-pretrained`` and ``w2v2ft`` raising
   ValueError as the JAX package does;
26. the W2V2 model's train step (``config='w2v2ft'``, plain PyTorch with
   its dropout, spec-augment and LayerDrop, the feature convs frozen) at
   full width and depth: the batch of 8 s rows that fits 90% of the
   card's free memory, sized by 4- and 8-row steps (printed beside the
   config's 150,000-frame budget), 3 steps: losses finite, the frozen convs bit for
   bit, every other parameter moved, step ms, audio-s/s, peak memory and
   a profile; one step at every rate 0 in fp32 on 2 rows against
   ``device='cpu'`` (loss, gradients, the parameters after Adam); two runs
   from one seed bit for bit (cuDNN deterministic); then
   ``preprocess.datasets(w2v2fc)`` on a seeded 40-file corpus and 2 steps
   of ``train(config='w2v2fc')`` from the caches, each step's launches
   exact;
27. the codec slice (the encodec and dac heads at the mel head's width,
   input channels 128 and 96), on seeded codebooks at the published shapes
   (EnCodec's 32 levels of 1024 x 128, summed; DAC's 12 of 1024 x 8,
   concatenated) saved as npz in a temporary directory that
   ``frontend.CODEBOOK_DIR`` points at and read through ``frontend._load``:
   ``decode_codes`` on the card against the CPU (concat bit for bit, sum
   at rtol 1e-6) and timed; ``from_features(config='encodec')`` and
   ``'dac'`` on 64 x 800 frames of seeded codes with ragged lengths and
   seeded head weights: shape, softmax columns, exactly 5 launches of each
   of K1-K4 (one batch of 128 windows of 500), 4 rows against
   ``device='cpu'`` at the bf16 gates (``agree_decided``), audio-s/s (the
   median of 5) and a profile with its idle share;
28. a seeded corpus of 40 wav files and TextGrids with an int32 code
   cache per codec beside each (``save_masked``); 3 steps of
   ``train(config='encodec')`` and of ``'dac'`` from the caches, each
   step's launches exact; one step at every rate 0 in fp32 on 2 rows
   against ``device='cpu'`` (loss, gradients, the parameters after Adam)
   for each codec; ``evaluate.datasets(config='encodec')`` on the card
   against ``device='cpu'`` in fp32 and bf16 (K1-K4 launched), its JSON
   files and tensors.npz written, and its figures where matplotlib
   imports;
29. ``plot.from_files_to_files`` from 4 seeded wav files with seeded mel
   head weights: K1-K4 launched 5 times a file, each plotted PPG
   ``from_file``'s on the card bit for bit, and where PIL imports each
   PNG's cells that PPG's pixels; ``utils.profiling.trace`` around one
   ``from_audio`` call (8 x 8 s), its Chrome trace naming K1-K4's kernels
   and the annotated region; ``python -m ppgs_tpu_torch.plot.accuracy``
   on phase 28's JSONs where matplotlib imports;
30. a one-rank NCCL group (PPGS_COORDINATOR, PPGS_NUM_PROCESSES=1,
   PPGS_PROCESS_ID=0): ``train(config='mel')`` for 4 steps at 256 x 512
   twice without a group and once in the group (cuDNN asked for
   deterministic algorithms), the parameters bit for bit, B4's
   kernels and one NCCL gradient all_reduce each step, the all_reduce's
   share of a profiled grouped step; one ``from_dataloader`` batch (one 8 s
   file) through the data-parallel branch, ``from_file``'s PPGs bit for
   bit;
31. two ranks sharing the card over gloo (this script with
   ``--parallel-rank``, after the build), each against one process on
   the card: DP, 2 steps of mel on a global 256 x 512 batch (128 rows a
   rank, rank 1's last 16 rows -100) at dropout 0 from seeded weights, the
   losses within rtol 1e-4 and each parameter within relative L2 2^-8; CP, ``infer`` with a
   'seq' axis of 2 on 8 x 60 s (6,000 frames padded to 6,400), K1-K4
   launched on each rank, the bf16 gates (``agree_decided``); TP,
   ``from_audio(config='w2v2fb')`` and the conformer on 16 x 8 s with a
   'model' axis of 2, each rank holding half of the split tensors' bytes,
   the outputs bit for bit;
32. PP: the mel width cut to 4 layers over 2 stages (mel's 5 do not
   divide over 2), 4 microbatches of 32 x 500: one forward (K2 and K4 on
   each stage, once a layer a tick) and one train step at dropout 0 (B5
   and B6) against the sequential per-layer path in one process, the PPGs
   at the bf16 gates and each gradient within relative L2 2^-8; then K1-K4
   at a CP rank's windows against their plain versions, timed;
33. the widths slice (the transformer at the (C, d_head) pairs of
   C = 256, 512 and 768 with d_head 128 or 256 that no registered config
   has:
   (256, 256), (512, 128), (768, 128), (768, 256)): the C = 768 kernel
   instances against their plain versions at odd shapes (K4 with ReLU in
   its LayerNorm forms, round_input 0 and 1, and its two train forms,
   dropout off and 0.1, the hidden's keep words Philox's bits;
   ffn_train_bwd in both forms; ln_dropout_bwd), K2 at those pairs' head
   counts (1, 4, 6, 3) at phase 3's odd shapes, and K2, the train
   attention and row_dot at those head counts and at 2 bit for bit against
   the one-head kernels on the heads folded into the batch (T 1 ... 512,
   holed, wholly masked and full windows, causal, dropout off and 0.1);
34. at each pair, 5 layers, F = 2048, seeded weights from a temporary
   npz: ``from_audio`` on 64 x 8 s (K1-K4 exactly 5 times each at the
   pair's widths; the first 4 rows against ``device='cpu'`` at the bf16
   gates, ``agree_decided``), at C = 768 ``legacy_mode`` on 12 s (the
   per-layer path: K2 and K4 5 times each); a 256 x 512 train step (B4)
   at each pair and a 256 x 500 one (B5 + B6) at C = 768, each step's
   launches exactly phase 8's per-layer counts, its loss and gradients
   against the plain path's fed the same Philox masks (relative L2 5e-2);
   at C = 768 both steps timed with their peak memory;
35. the new instances at the main paths' shapes against their plain
   versions (K4 at 128 x 500 rows; the train kernels at 256 x 512, dropout
   0.1), each timed by CUDA events and device time beside its plain
   version, its library route and its bound: K4 (768, ReLU) in both
   inference forms, its two train forms, ffn_train_bwd, ln_dropout_bwd,
   and K2, attention_train_fwd and attention_train_bwd at each pair;
36. the any_width slice (K1, K3 and K4 at the widths of their inference
   rule, C % 128 == 0 up to 2048, that no registered config has): K1 at
   C = 128, 384, 640, 1024, 1280, 2048 and 1408 (its three forms), K3 at
   the first six, K4 at those with ReLU and GELU, round_input 0 and 1, F =
   128, 384 and 4 C, against their plain versions at rows 1 ... 1000; K2
   at d_head 64 x 16 heads, 128 x 1, 3, 8 and 256 x 4 at phase 3's odd
   shapes;
37. wav2vec2-large's trunk (24 layers, C = 1024, 16 heads of 64, F =
   4096, base's feature encoder; seeded weights through a temporary npz)
   through ``models.w2v2.forward`` on 64 x 8 s (T = 400): K1-K4 exactly
   24 times each at C = 1024 and d_head 64, its wall and profile; its
   24-layer stack against the plain stack (relative L2 within the base
   trunk's 1e-2 scaled by C / 768 and the square root of the depth) and
   K1-K4 of its first layer against theirs; then mel's shape (5 layers,
   F = 2048) at (C, d_head) = (128, 128), (384, 128), (1024, 128) and
   (1024, 256): ``from_audio`` on 64 x 8 s (K1-K4 5 times each at the
   pair's widths; the first 2 rows against ``device='cpu'`` at the bf16
   gates, ``agree_decided``), timed end to end but at (128, 128); at
   (1024, 128) ``legacy_mode`` on 12 s (K2 and K4's round_input 1 form 5
   times each) against the CPU;
38. the new instances at their main paths' shapes against their plain
   versions, timed by CUDA events and device time beside their bounds and
   library calls: K1-K4 of the large trunk's first layer, K1-K4 at (384,
   128) and (1024, 128) and K2 at (1024, 256) on 128 x 500, K4's
   round_input 1 form at 1024; the 24-layer stack whole against its plain
   version and ``nn.TransformerEncoder`` (1024, 16, 4096, GELU) x 24, with
   its device time by kernel;
39. the train_any_width slice (the transformer's training at widths of
   the layer kernels' rule, C % 128 == 0 up to 2048 with d_head 128 or
   256, that no registered config has): at C = 128, 384, 640, 1024, 1280
   and 2048, K3's train form, K4's LayerNorm and y_out train forms (F =
   128, 384 and 2048; the keep words Philox's bits), ffn_train_bwd (fp32
   and bf16 x) and ln_dropout_bwd (fp32 and bf16 g) against their plain
   versions at rows 1 ... 1000, dropout off and 0.1, the relative limits
   scaled by ``flip_rel`` and the shares by ``flip_share``; colsum at the
   step's shapes (dbqkv 3 C columns); the train attention at 8 and 16
   heads of 128 and 4 and 8 heads of 256 bit for bit against the one-head
   kernels on the folded heads;
40. mel's shape (5 layers, F = 2048) at (C, d_head) = (384, 128), (1024,
   128) and (1024, 256), seeded weights through a temporary npz: a 256 x
   512 train step (B4) at each and a 256 x 500 one (B5 + B6) at the first
   two, each step's launches exactly phase 8's per layer, its loss and
   gradients against the plain path fed the same Philox masks (relative
   L2 5e-2); both steps at (1024, 128) timed with their peak memory; then
   ``train()`` at (1024, 128) from the caches of 40 seeded files (phase
   23's recipe: 3 steps with an evaluation and a checkpoint, a resume for
   2 from it, 8 length buckets), K3's and K4's train forms launched;
41. the new instances at the step's shapes (256 x 512 rows, dropout 0.1)
   at C = 384 and 1024 against their plain versions, each timed by CUDA
   events and device time beside its plain version, library route and
   bound: K3's train form, K4's two train forms, ffn_train_bwd and
   ln_dropout_bwd.
42-44. the attention at every head width (``wide_heads``): K2 at d_head
   16, 32 and on its wide route (a thread-block cluster that forms S once
   a head) at 384 ... 2048, the train attention on its wide routes,
   against their plain versions at odd shapes and on folded heads; mel's
   shape at the default two heads widened to (C, d_head) = (1024, 512),
   (768, 384), (2048, 1024) and one head of 2048 (``from_audio``, train
   steps, ``legacy_mode``, ``train()``), the trunk at 24 heads of 32; the
   new instances timed beside SDPA, and B4 at (1024, 512) beside its bound
   and ``nn.TransformerEncoderLayer``.

At the end of every run the sha256 of every file under
``ppgs_tpu/assets/`` is the one read before phase 1.

``--slices`` (default
``mel,train,w2v2fb,bottleneck,api,data,head_train,w2v2,codec,parallel,
widths,any_width,train_any_width,wide_heads``) runs a subset: phases 3-5,
6-8, 9-11, 12-14, 15-17, 18-20, 21-23, 24-26, 27-29, 30-32, 33-35,
36-38, 39-41 and 42-44 respectively. Each phase prints its
seconds. Before the last line it prints one JSON
object with a record per kernel;
the last line is {"ok": true, "device": {...}}. Imports nothing of JAX or
of the JAX package.
"""

import argparse
import collections
import dataclasses
import hashlib
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
BATCH, SECONDS = 64, 8           # main path: 64 utterances x 8 s
LEGACY_SECONDS = 12              # one utterance past the 1024-frame stack
LONG_T = 1536                    # the attention kernel's long-input check
REPS = 20
# The training slice: the JAX bench's train geometry (256 x 512 frames,
# the whole-layer path) and the per-layer path's T = 500
TRAIN_B, TRAIN_T, SPLIT_T = 256, 512, 500
TRAIN_STEPS = 4                  # whole-layer steps before the resume
DROPOUT = 0.1
TRAIN_REPS = 10
STEP_REPS = 6
# Train-kernel launches per layer in one train step, on each path
B4_PER_LAYER = {'qkv_proj': 1, 'attention_train_fwd': 1, 'row_dot': 1,
                'attention_train_bwd': 1, 'out_proj_ln_train': 1,
                'ffn_train_fwd': 1, 'ffn_train_bwd': 1, 'ln_dropout_bwd': 2,
                'gemm': 6, 'colsum': 8}
SPLIT_PER_LAYER = {'qkv_proj': 0, 'attention_train_fwd': 1, 'row_dot': 1,
                   'attention_train_bwd': 1, 'out_proj_ln_train': 0,
                   'ffn_train_fwd': 1, 'ffn_train_bwd': 1,
                   'ln_dropout_bwd': 1, 'gemm': 2, 'colsum': 4}

# The w2v2fb slice: the JAX bench's w2v2fb line (64 x 8 s), 4 utterances
# of 2 s against the CPU (800 frames: one tie flipped is 0.125% of them),
# the head's per-layer path past 1024 frames
W2V2_BATCH, W2V2_SECONDS = 64, 8
W2V2_CPU_ROWS, W2V2_CPU_SECONDS = 4, 2
HEAD_LONG_T = 1200
HEAVY_REPS = 3                   # plain versions of the whole chains

# The bottleneck slice: the JAX bench's fourth line (64 x 8 s,
# bench.py:407-459), 4 utterances of 2 s against the CPU, one 25 s
# utterance past B8's 2048 frames, and B8 at the T about its band's edges
# and diagonal tiles (1-129), a T that is no multiple of 8 and its longest
BN_BATCH, BN_SECONDS = 64, 8
BN_CPU_ROWS, BN_CPU_SECONDS = 4, 2
BN_LONG_SECONDS = 25
BN_ODD_T = (1, 63, 64, 65, 129, 803, 2048)
# and at the other head widths its entry takes, (heads, d_k): its k16
# steps 1, 2, 4 and 4, the odd heads of the first three at column 4 of
# their boxes, on BN_WIDTH_T frames
BN_WIDTHS, BN_WIDTH_T = ((4, 12), (4, 28), (4, 60), (2, 64)), 203
# B8 against its plain version: a bf16 rounding flip of p / denom moves an
# output by about an ulp of p times |v|, and a flip of the output's own
# rounding by one bf16 ulp of the output (2^-8 relative); the card's 16
# blocks against the CPU's, relative L2 (bf16 products rounded by other
# libraries in each block)
B8_ATOL, B8_RTOL = 5e-3, 1e-2
BN_BLOCKS_REL = 1e-2

# Published peaks of an H100 SXM (dense bf16, HBM3), for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# and its fp64 tensor cores (NVIDIA's data sheet), for conv_stats' Gram
PEAK_FP64_FLOPS = 67e12


_phase = {'name': None, 'start': None}


def phase(name=None):
    """Start phase ``name`` (None: end the last one), printing the seconds
    the previous phase took."""
    now = time.perf_counter()
    if _phase['name'] is not None:
        print(f'-- {_phase["name"]}: {now - _phase["start"]:.1f} s',
              flush=True)
    _phase.update(name=name, start=now)
    if name is not None:
        print(f'== {name}', flush=True)


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps=REPS, warmup=3):
    """Median milliseconds of ``fn`` on the card over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops, nbytes):
    """(least milliseconds, what bounds it) on an H100 for the work."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops > t_bytes else 'bytes')


def check(name, got, want, atol, rtol=0.0, rows=None, share=0.0,
          outlier=None, flips_at_zero=False, quiet=False):
    """Raise unless |got - want| <= atol + rtol |want| (on ``rows`` when
    given) everywhere but in at most ``share`` of the elements, each of
    which must be within ``outlier`` of ``want`` or, with
    ``flips_at_zero``, be 0 on one side; return the max |got - want|. The
    mean |want| is printed beside it, so that the limit can be read against
    the size of what it bounds.

    ``share`` > 0 is for bf16 outputs of 10^8 elements: a value whose fp32
    sum lands near a rounding boundary rounds the other way when the sum is
    taken in another order, which no limit of a few ulps of the output
    holds for every element: the flip is an ulp of an intermediate (a
    product before its bias), larger than the output where they cancel.
    Each share is set just above what the seeded inputs read (the kernels
    are deterministic), and each ``outlier`` at about twice the largest
    such flip, so that a wrong row, tile or mask cannot hide in the share.
    ``flips_at_zero`` is for a hidden unit at 0 whose relu' flips: the
    whole gradient moves, and one side is exactly 0. ``quiet``: print
    nothing (the caller prints the error)."""
    if share and outlier is None and not flips_at_zero:
        raise ValueError(f'{name}: a share needs a bound on its outliers')
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name}: non-finite values')
    err = (got - want).abs()
    worst = err.max().item()
    typical = want.abs().mean().item()
    beyond = err > atol + rtol * want.abs()
    over = beyond.float().mean().item()
    if over > share:
        raise AssertionError(
            f'{name}: max |kernel - plain| {worst:.3g}, {over:.2e} of the '
            f'elements beyond atol {atol} rtol {rtol} (at most {share:g} '
            f'may be; mean |plain| {typical:.3g})')
    allowed = ''
    if flips_at_zero:
        stray = int((beyond & (got != 0) & (want != 0)).sum().item())
        if stray:
            raise AssertionError(
                f'{name}: {stray} elements beyond the limit with neither '
                f'side 0 (not a relu\' flip)')
        allowed = f', beyond it {over:.2e} (<= {share:g}), each 0 on one side'
    elif share:
        far = err[beyond].max().item() if over else 0.0
        if far > outlier:
            raise AssertionError(
                f'{name}: an element beyond the limit is {far:.3g} off, '
                f'more than the bound {outlier} on such elements')
        allowed = (f', beyond it {over:.2e} (<= {share:g}), those at most '
                   f'{far:.3g} off (<= {outlier})')
    if not quiet:
        print(f'{name}: max |kernel - plain| = {worst:.3g} (atol {atol}, '
              f'rtol {rtol}{allowed}; mean |plain| {typical:.3g})',
              flush=True)
    return worst


def jitter(tree, gen, path=''):
    """Draw a layer's biases and norm parameters at random (1 + 0.1 N for a
    scale, 0.1 N for a bias), so that every term of the kernels is
    exercised."""
    for key, value in list(tree.items()):
        if isinstance(value, dict):
            jitter(value, gen, key)
        elif key.startswith('b') or path.startswith('norm'):
            noise = torch.randn(value.shape, generator=gen).numpy()
            base = 1.0 if key == 'scale' else 0.0
            tree[key] = (base + 0.1 * noise).astype(np.float32)


def random_params(port, config, seed):
    """Seeded weights in the JAX package's layout: the model's init, with
    biases and LayerNorm parameters drawn at random too."""
    gen = torch.Generator().manual_seed(seed)
    params = port.models.transformer.init(config, gen)
    for layer in params['layers']:
        jitter(layer, gen)
    return params


def random_w2v2_params(port, seed, config=None):
    """Seeded wav2vec2 weights (``config``'s shapes; wav2vec2-base's by
    default) in the JAX package's layout: the trunk's init, with each
    encoder layer's biases and norms drawn at random too."""
    gen = torch.Generator().manual_seed(seed)
    params = port.models.w2v2.init(config or port.models.w2v2.BASE, gen)
    for layer in params['encoder']['layers']:
        jitter(layer, gen)
    return params


def library_encoder(layers, C, H, Fh, dev, activation='relu'):
    """``torch.nn.TransformerEncoder`` in bf16 with the layers' weights:
    post-LN, batch-first, every row computed (no nested tensors); ReLU, or
    GELU (exact erf: PyTorch's 'gelu'). It is one PyTorch call for the
    encoder stack's function, timed as its yardstick; the port never calls
    it."""
    layer = torch.nn.TransformerEncoderLayer(
        C, H, Fh, dropout=0.0, batch_first=True, norm_first=False,
        activation=activation)
    encoder = torch.nn.TransformerEncoder(
        layer, len(layers), enable_nested_tensor=False).to(dev)
    with torch.no_grad():
        for dst, src in zip(encoder.layers, layers):
            pairs = (
                (dst.self_attn.in_proj_weight, src.attn.wqkv.T),
                (dst.self_attn.in_proj_bias, src.attn.bqkv),
                (dst.self_attn.out_proj.weight, src.attn.wo.T),
                (dst.self_attn.out_proj.bias, src.attn.bo),
                (dst.linear1.weight, src.ffn.w1.T),
                (dst.linear1.bias, src.ffn.b1),
                (dst.linear2.weight, src.ffn.w2.T),
                (dst.linear2.bias, src.ffn.b2),
                (dst.norm1.weight, src.norm1.scale),
                (dst.norm1.bias, src.norm1.bias),
                (dst.norm2.weight, src.norm2.scale),
                (dst.norm2.bias, src.norm2.bias))
            for param, value in pairs:
                param.copy_(value)
    return encoder.to(torch.bfloat16).eval().requires_grad_(False)


# The host range that profile_call marks around the profiled call: its span
# on the profiler's own clock is the wall time that the device events,
# converted to that clock, are measured against
PROFILE_WINDOW = 'chip_smoke.profiled_call'


def profile_call(label, fn, card):
    """Device time by kernel in one call of ``fn`` (torch.profiler), and
    the share of the call's wall time in which the card ran no kernel;
    returns the device milliseconds by kernel name."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start = time.perf_counter()
        with record_function(PROFILE_WINDOW):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    return report_profile(label, prof, wall_ms, card)


def kernel_device_ms(label, fn, card, reps=5):
    """Print the device milliseconds per call of ``fn`` by kernel
    (torch.profiler over ``reps`` calls after a warm-up): what one call's
    CUDA-event time spends on the card, without the host's share. Each
    kernel's time is the mean of the launches the trace caught, with their
    count beside it: a trace now and then misses launches, or all of them
    (then it is taken once more). Returns the sum of the means, one launch
    of each kernel a call (None when no trace caught one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    caught = {}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.replace('(anonymous namespace)::',
                                      '').removeprefix('void ').split('(')[0]
                total, count = caught.get(name, (0.0, 0))
                caught[name] = (total + e.time_range.elapsed_us() / 1e3,
                                count + 1)
        if caught:
            break
    parts = ', '.join(f'{name} {total / count:.4f} ms ({count} of {reps} '
                      f'launches caught)'
                      for name, (total, count) in caught.items())
    print(f'{label}, device time per call: {parts or "not measured"} '
          f'[{card}]', flush=True)
    return (sum(total / count for total, count in caught.values())
            if caught else None)


def device_times(label, record, fn, library, card):
    """A kernel's device time per launch beside its event time, bound and
    library call's time (``library`` names it), into its record: a gain
    that the host hides shows as such."""
    record['device_ms'] = kernel_device_ms(label, fn, card)
    ms, dev_ms, lib = record['ms'], record['device_ms'], record['library_ms']
    device = 'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'
    factor = '' if dev_ms is None else f', device {dev_ms / lib:.2f}x'
    launches = ('' if record['launches'] is None else
                f', {record["launches"]} launches per main-path call')
    print(f'{label}: event {ms:.4f} ms, device {device}, bound '
          f'{record["bound_ms"]:.4f} ms ({record["bound_by"]}), {library} '
          f'{lib:.4f} ms: {ms / lib:.2f}x {library}{factor}{launches} '
          f'[{card}]', flush=True)


def agree(name, got, want, want32=None):
    """The card's PPGs against the CPU's: atol 2e-2, argmax agreement >=
    99.5%. With ``want32`` (the same call in fp32) the agreement counts the
    frames bf16 decides, those where ``want`` and ``want32`` pick the same
    phoneme: random weights leave a frame now and then whose top two
    phonemes are nearer than bf16 rounding, a tie that no kernel decides."""
    diff = (got.float().cpu() - want).abs().max().item()
    same = got.cpu().argmax(1) == want.argmax(1)
    rate = same.float().mean().item()
    note = ''
    if want32 is not None:
        decided = want.argmax(1) == want32.argmax(1)
        note = (f', {decided.float().mean().item():.4f} of the frames '
                f'decided (bf16 and fp32 agree), there')
        rate = same[decided].float().mean().item()
    print(f'{name}: max |card - cpu| = {diff:.3g} (atol 2e-2), argmax '
          f'agreement {same.float().mean().item():.4f}{note} {rate:.4f} '
          f'(>= 0.995)', flush=True)
    if diff > 2e-2 or rate < 0.995:
        raise AssertionError(f'{name}: the card disagrees with the cpu')


# K4 (ffn_ln.cu) at odd shapes, every form and width, before anything is
# timed: rows about the 64-row warpgroup and 128-row tile edges and a
# ragged 1000, hidden widths of one 128-wide tile, of three, and the model's
K4_ODD_M = (1, 63, 64, 65, 127, 129, 1000)
K4_ODD_F = (128, 384)
# and, for the train forms at C = 512, whose hidden launch is a persistent
# walk over units of 128 rows x 128 hidden columns (ops/fused_ffn.py
# hidden_walk): more units than the card holds blocks, in ranges that end
# in a last wave that is not full, and a last row block past M
K4_WALK_M = (2597, 16447, 40000)


# K1 (qkv_proj.cu) at odd shapes, each width, before anything is timed:
# rows about its 64-row warpgroups and 128-row units, and a ragged 1000
K1_ODD_M = (1, 63, 64, 65, 127, 128, 129, 1000)


@torch.no_grad()
def k1_odd_shape_checks(tag, wqkv, bqkv, dev):
    """K1 against its plain version at ``K1_ODD_M`` rows with the given
    weights, on its own seeded inputs (the phases' draws stay as they
    were); atol and rtol 1e-2, phase 3's limit at the main shape."""
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk

    K, N = wqkv.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 41 + K)
    worst = 0.0
    for M in K1_ODD_M:
        x = torch.randn(M, K, generator=gen, device=dev)
        worst = max(worst, check(
            f'K1 qkv_proj ({tag}) M={M}', elk.qkv_proj(x, wqkv, bqkv),
            elk.qkv_proj_reference(x, wqkv, bqkv), atol=1e-2, rtol=1e-2,
            quiet=True))
    print(f'K1 qkv_proj ({tag}, {K} -> {N}) at rows {K1_ODD_M}: max '
          f'|kernel - plain| = {worst:.3g} (atol 1e-2, rtol 1e-2)',
          flush=True)


def k3_keep_mask(M, C, drop, dev):
    """K3's train form on inputs that show its dropout mask: a = 0, x = 0,
    bo = 1, gamma = 1 and beta = 0, so that each row's sum is the dropout
    scale where kept and 0 where dropped, and its LayerNorm > 0 exactly
    where kept (a row wholly kept or wholly dropped, 0.9^C likely, would
    read as dropped); returns that mask, (M, C) bool."""
    from ppgs_tpu_torch.ops import encoder_layer_train as elt

    zeros = torch.zeros(M, C, device=dev)
    ones = torch.ones(C, device=dev)
    r, _, _ = elt.out_proj_ln_train(
        zeros.to(torch.bfloat16), torch.zeros(C, C, dtype=torch.bfloat16,
                                              device=dev),
        ones, zeros, ones, torch.zeros(C, device=dev), drop)
    return r > 0


def check_k3_mask(name, M, C, drop, dev):
    """Raise unless K3's dropout mask (``k3_keep_mask``) is the plain
    version's, bit for bit."""
    got, want = k3_keep_mask(M, C, drop, dev), drop.keep((M, C), dev)
    if not torch.equal(got, want):
        raise AssertionError(f'{name}: the kernel dropped '
                             f'{int((got != want).sum())} elements the plain '
                             f'version kept or the reverse')


# K3 (out_proj_ln.cu) at odd shapes, each width and the train form, before
# anything is timed: K1's rows, about the 64-row warpgroups and 128-row
# tiles, and a ragged 1000
@torch.no_grad()
def k3_odd_shape_checks(widths, train, dev):
    """K3 against its plain version at ``K1_ODD_M`` rows on seeded random
    weights: the inference form at each C of ``widths`` and, with
    ``train`` (a width, or 0), the train form at C = train with dropout off
    and 0.1, its
    normalised rows and 1/std too, and with the dropout on its mask
    against the plain version's, bit for bit (``check_k3_mask``). The
    limits are the train form's at the training shape: atol 1e-4 on the
    output and the normalised rows, atol and rtol 1e-5 on 1/std. Prints
    the max |kernel - plain| by M, one line a form."""
    from ppgs_tpu_torch.ops import dropout
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import encoder_layer_train as elt

    # A generator of its own: the phases' own draws stay as they were
    gen = torch.Generator(device=dev).manual_seed(SEED + 47)

    def rnd(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen, device=dev)

    forms = [(C, None) for C in widths] + (
        [(train, 0.0), (train, DROPOUT)] if train else [])
    for C, rate in forms:
        wo = rnd(C, C, scale=C ** -0.5).to(torch.bfloat16)
        vectors = (rnd(C, scale=0.1), rnd(C, scale=0.1, base=1.0),
                   rnd(C, scale=0.1))
        form = 'inference' if rate is None else f'train, rate {rate}'
        cases = []
        for M in K1_ODD_M:
            a, x = rnd(M, C, scale=0.5).to(torch.bfloat16), rnd(M, C)
            name = f'K3 C={C} {form} M={M}'
            if rate is None:
                args = (a, wo, vectors[0], x, *vectors[1:])
                e = check(name, elk.out_proj_residual_ln(*args),
                          elk.out_proj_residual_ln_reference(*args),
                          atol=1e-4, quiet=True)
            else:
                drop = dropout.Drop(SEED + 19, 5, rate)
                args = (a, wo, vectors[0], x, *vectors[1:], drop)
                got = elt.out_proj_ln_train(*args)
                want = elt.out_proj_ln_train_reference(*args)
                e = max(check(f'{name} r', got[0], want[0], atol=1e-4,
                              quiet=True),
                        check(f'{name} n', got[1], want[1], atol=1e-4,
                              quiet=True),
                        check(f'{name} rstd', got[2], want[2], atol=1e-5,
                              rtol=1e-5, quiet=True))
                if rate:
                    check_k3_mask(name, M, C, drop, dev)
            cases.append(f'{M} {e:.3g}')
        mask = ', the dropout mask the plain one\'s bit for bit' if rate else ''
        print(f'K3 out_proj_ln C={C} {form} at rows {K1_ODD_M}: max |kernel '
              f'- plain| by M: {", ".join(cases)} (atol 1e-4; 1/std atol '
              f'and rtol 1e-5){mask}', flush=True)


def relative_l2(got, want):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError('non-finite values')
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


@torch.no_grad()
def k4_odd_shape_checks(form, C, act, model_F, dev, scaled=False):
    """K4 in one form against its plain version at ``K4_ODD_M`` rows (and
    ``K4_WALK_M`` for the train forms at C = 512) and ``K4_ODD_F`` +
    (model_F,) hidden widths, on seeded random weights; prints the max
    |kernel - plain| of every case, one line per (F, variant).

    ``form``: 'ln', the inference LayerNorm form at round_input 0 and 1
    (atol 1e-2, phase 3's limit); 'train_ln' (B4's: stats, dropout off and
    0.1) and 'y_out' (B6's bf16 form, dropout off and 0.1), held as the
    train functions are: relative L2 within 1e-3 (out, the normalised rows
    and 1/std) or 1e-2 (the bf16 y), and y 0 wherever the plain version's
    output mask drops; with the dropout on, the hidden's keep words equal
    to Philox's bits on every row (``check_hidden_words``), none at rate
    0; two calls of a train form equal bit for bit. ``scaled``: those
    relative limits by ``flip_rel`` at C (the train forms past the widths
    where they were read)."""
    from ppgs_tpu_torch.ops import dropout, fused_ffn

    bf16 = torch.bfloat16
    # A generator of its own: the phases' own draws stay as they were
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)

    def rnd(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen, device=dev)

    rows = K4_ODD_M + (K4_WALK_M if form != 'ln' and C == 512 else ())
    for Fh in K4_ODD_F + (model_F,):
        w1, w2 = (rnd(C, Fh, scale=C ** -0.5).to(bf16),
                  rnd(Fh, C, scale=Fh ** -0.5).to(bf16))
        b1, b2 = rnd(Fh, scale=0.1), rnd(C, scale=0.1)
        ln = (rnd(C, scale=0.1, base=1.0), rnd(C, scale=0.1))
        variants = ((0, 1) if form == 'ln' else (0.0, DROPOUT))
        for variant in variants:
            cases = []
            for M in rows:
                name = (f'K4 {form} C={C} {act} F={Fh} M={M} '
                        f'{"round_input" if form == "ln" else "rate"}='
                        f'{variant}')
                if form == 'ln':
                    x = rnd(M, C)
                    args = (x, w1, b1, w2, b2, *ln)
                    e = check(name, fused_ffn.ffn_residual_ln(
                        *args, round_input=variant, activation=act),
                        fused_ffn.ffn_residual_ln_reference(
                            *args, round_input=variant, activation=act),
                        atol=1e-2, quiet=True)
                    cases.append(f'{M} {e:.3g}')
                    continue
                drop_h = dropout.Drop(SEED + 23, 3, variant)
                fwd = ((rnd(M, C), w1, b1, w2, b2, drop_h, drop_h.at(4), ln)
                       if form == 'train_ln' else
                       (rnd(M, C).to(bf16), w1, b1, w2, b2, drop_h,
                        drop_h.at(4)))
                got = fused_ffn.ffn_train_fwd(*fwd)
                if not all(a is b or torch.equal(a, b) for a, b in zip(
                        got, fused_ffn.ffn_train_fwd(*fwd))):
                    raise AssertionError(f'{name}: two calls differ')
                want = fused_ffn.ffn_train_fwd_reference(*fwd)
                if variant:
                    check_hidden_words(name, got[3], drop_h)
                elif got[3] is not None:
                    raise AssertionError(f'{name}: keep words at rate 0')
                pairs = list(zip(got, want))[:3 if form == 'train_ln' else 1]
                limit = 1e-3 if form == 'train_ln' else 1e-2
                if scaled:
                    limit = flip_rel(limit, C)
                rels = [relative_l2(a, b) for a, b in pairs]
                if max(rels) > limit:
                    raise AssertionError(f'{name}: relative L2 errors {rels} '
                                         f'> {limit}')
                # The output's dropped elements are 0 (a kept one may be 0
                # too: bf16(dot) + bf16(b2) cancels exactly now and then)
                if (form == 'y_out' and variant
                        and got[0][~fwd[6].keep((M, C), dev)].any()):
                    raise AssertionError(f'{name}: a dropped element is not 0')
                e = max((a.float() - b.float()).abs().max().item()
                        for a, b in pairs)
                cases.append(f'{M} {e:.3g} (rel {max(rels):.2g})')
            print(f'K4 {form} C={C} {act} F={Fh} '
                  f'{"round_input" if form == "ln" else "rate"}={variant}: '
                  f'max |kernel - plain| by M: {", ".join(cases)}',
                  flush=True)


# K2 (attention.cu) at odd shapes, at every width, before anything is
# timed: T about the 64-key tiles and 128-row query tiles, the main paths'
# window and the long-input check's. Two sets of 4 windows: ragged
# prefixes, and holes (one 64-key tile wholly masked in the first); each
# set has a full window and a wholly masked one
K2_ODD_T = (1, 63, 64, 65, 127, 129, 500, LONG_T)


@torch.no_grad()
def k2_odd_shape_checks(d_head, heads, dev):
    """K2 at one head width against its plain version at ``K2_ODD_T``, on
    q, k, v views of one fused buffer of N(0, 1) values: a prefix mask and
    a mask with holes, causal off and on, ``scale_log2`` 1 (log2(e)/sqrt(d)
    folded into q, as encoder_stack does) and log2(e)/sqrt(d) (raw q); the
    wholly masked window exactly 0. Prints the max |kernel - plain| by T.

    The limit is phase 3's atol 5e-3 plus a bf16 ulp of the output (rtol
    2^-7): a row with a few valid keys (holes, the first rows under the
    causal mask, a short T) gives an output near single values of v, of
    magnitude 1-4, where one rounding flip of the output, or of a p rounded
    to bf16 for the PV product, is 0.008-0.016; the main shapes' outputs
    average hundreds of keys."""
    from ppgs_tpu_torch.ops import flash_attention as fa

    # A generator of its own: the phases' own draws stay as they were
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    C = heads * d_head
    scale = fa.LOG2E / math.sqrt(d_head)
    cases = []
    for T in K2_ODD_T:
        raw = torch.randn(4, T, 3 * C, generator=gen, device=dev)
        folded = raw.clone()
        folded[..., :C] *= scale
        keys = torch.arange(T, device=dev)
        prefix = keys[None] < torch.tensor([max(1, 2 * T // 3), T, T, 0],
                                           device=dev)[:, None]
        holes = torch.rand(4, T, generator=gen, device=dev) < 0.6
        holes[0, 64:128] = False
        holes[2], holes[3] = True, False
        worst = 0.0
        for scale_log2, qkv in ((1.0, folded), (scale, raw)):
            qkv = qkv.to(torch.bfloat16)
            q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
            for mask, causal in itertools.product((prefix, holes),
                                                  (False, True)):
                got = fa.attention(q, k, v, mask, heads, scale_log2, causal)
                name = (f'K2 d_head {d_head} T={T} causal={causal} '
                        f'scale_log2={scale_log2:.4g}')
                worst = max(worst, check(
                    name, got, fa.attention_reference(
                        q, k, v, mask, heads, scale_log2, causal),
                    atol=5e-3, rtol=2 ** -7, quiet=True))
                if not torch.equal(got[3], torch.zeros_like(got[3])):
                    raise AssertionError(f'{name}: the wholly masked window '
                                         f'did not give 0')
        cases.append(f'{T} {worst:.3g}')
    print(f'K2 d_head {d_head} ({heads} heads), prefix and holed masks, '
          f'causal off and on, scale_log2 1 and log2(e)/sqrt(d): max |kernel '
          f'- plain| by T: {", ".join(cases)} (atol 5e-3, rtol 2^-7); the '
          f'wholly masked window exactly 0', flush=True)


def check_hidden_words(name, words, drop):
    """K4's hidden keep words (``ffn_train_fwd``'s fourth output) against
    their plain packing (``fused_ffn.keep_words_reference``) bit for bit on
    every row: Philox's bits of the (M, F) hidden."""
    from ppgs_tpu_torch.ops import fused_ffn

    M, W = words.shape
    if not torch.equal(words, fused_ffn.keep_words_reference(
            drop, M, 32 * W, words.device)):
        raise AssertionError(f'{name}: the hidden\'s keep words differ from '
                             f'Philox\'s bits')


# ffn_train_bwd at odd shapes, before anything is timed: K4's rows, hidden
# widths of one 128-column unit, of three and the model's
FFN_BWD_ODD_F = (128, 384, 2048)
# (atol, rtol, share, outlier bound) of each output, train_kernel_checks'
# at the training shape: a relu' flip moves dh by its whole value and a
# block's db1 sum by the same, and dx's row by dh times W1's row
# (``with_relu_flips`` carries the admitted ones over to the plain side
# before dx and the partial sums are held)
FFN_BWD_LIMITS = {
    'dx (fp32 + residual)': (1e-3, 1e-3, 5e-5, dict(outlier=6.1e-2)),
    'hd': (1e-3, 1e-2, 1e-6, dict(outlier=3.2e-2)),
    'dh': (1e-3, 1e-2, 1e-6, dict(flips_at_zero=True)),
    'db1 partial sums': (1e-2, 1e-3, 2e-6, dict(outlier=1.2)),
    'dx (bf16)': (1e-3, 1e-2, 4e-5, dict(outlier=6.25e-2)),
}
# The shares of rounding flips above were read at C = 256. A flip's rate
# grows with the depth of the sum that is rounded (C for the FFN's h and
# dhd), so at C = 512 (the w2v2fb head) each share is doubled, and a
# relative L2 error made of relu' flips grows by the square root: phase
# 22 read an FFN-backward hd share of 1.11e-6, a bf16 y share of 8.2e-5
# and B4's dW1 and db1 at 1.33e-2 relative, against 4.9e-7, 3.5e-5 and
# 8.7e-3 at C = 256. The outlier bounds stay: a flip moves an element by
# the same few ulps at any width.
FLIP_WIDTH = 256


def flip_share(share, C):
    """A rounding-flip share read at ``FLIP_WIDTH``, at width C."""
    return share * max(1.0, C / FLIP_WIDTH)


def flip_rel(limit, C):
    """A relative L2 limit read at ``FLIP_WIDTH``, at width C."""
    return round(limit * math.sqrt(max(1.0, C / FLIP_WIDTH)), 4)


def with_relu_flips(want, got, w1):
    """The plain version's ffn_train_bwd outputs (dx, hd, dh, partials)
    with the relu' flips that the dh check admits (an element 0 on exactly
    one side) carried over from the kernel's side: each such element's got
    - want added to dx's row through W1 (dx + delta W1^T, rounded again for
    a bf16 dx) and to its 64-row block's partial sum. What remains of a
    difference is the order of the sums and the bf16 roundings, which the
    limits hold; a flip no longer takes a whole dx row or block sum past
    them."""
    from ppgs_tpu_torch.ops import backward

    dx, hd, dh, partial = want
    flip = (got[2] == 0) != (dh == 0)
    if not flip.any():
        return want
    delta = torch.where(flip, got[2].float() - dh.float(), 0.0)
    dx = (dx.float() + (delta @ w1.float().T).view(dx.shape)).to(dx.dtype)
    return dx, hd, dh, partial + backward.block_sums(delta)


@torch.no_grad()
def ffn_bwd_odd_shape_checks(dev, C=256):
    """ffn_train_bwd at width C against its plain version at ``K4_ODD_M``
    rows and
    ``FFN_BWD_ODD_F`` hidden widths, dropout off and 0.1 (the keep words
    ``keep_words_reference``'s), both forms (fp32 x with the residual, bf16
    x), on seeded random weights. Each output is held to
    ``FFN_BWD_LIMITS`` with the share taken of its elements of all the
    cases together (a case of a few rows holds too few for a share of
    1e-6), dx and the partial sums after ``with_relu_flips``; two calls
    equal bit for bit. Prints the max |kernel - plain| by F and form."""
    from ppgs_tpu_torch.ops import dropout, fused_ffn

    bf16 = torch.bfloat16
    # A generator of its own: the phases' own draws stay as they were
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    pooled = {name: ([], []) for name in FFN_BWD_LIMITS}
    for Fh in FFN_BWD_ODD_F:
        w1, w2 = (rnd(C, Fh, scale=C ** -0.5).to(bf16),
                  rnd(Fh, C, scale=Fh ** -0.5).to(bf16))
        b1 = rnd(Fh, scale=0.1)
        for form in ('fp32', 'bf16'):
            worst = {}
            for M, rate in itertools.product(K4_ODD_M, (0.0, DROPOUT)):
                drop = dropout.Drop(SEED + 29, 3, rate)
                keep = (fused_ffn.keep_words_reference(drop, M, Fh, dev)
                        if rate else None)
                x, dy, res = rnd(M, C), rnd(M, C).to(bf16), rnd(M, C)
                args = ((x, dy, w1, b1, w2, drop, keep, res) if form == 'fp32'
                        else (x.to(bf16), dy, w1, b1, w2, drop, keep))
                got = fused_ffn.ffn_train_bwd(*args)
                again = fused_ffn.ffn_train_bwd(*args)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f'ffn_train_bwd M={M} F={Fh} '
                                         f'{form}: two calls differ')
                want = with_relu_flips(
                    fused_ffn.ffn_train_bwd_reference(*args), got, w1)
                names = ('dx (fp32 + residual)' if form == 'fp32'
                         else 'dx (bf16)', 'hd', 'dh', 'db1 partial sums')
                for name, a, b in zip(names, got, want):
                    pooled[name][0].append(a.float().flatten())
                    pooled[name][1].append(b.float().flatten())
                    e = (a.float() - b.float()).abs().max().item()
                    worst[M] = max(worst.get(M, 0.0), e)
            print(f'ffn_train_bwd C={C} F={Fh} x {form}, dropout off and '
                  f'{DROPOUT}: max |kernel - plain| by M: '
                  f'{", ".join(f"{m} {e:.3g}" for m, e in worst.items())}',
                  flush=True)
    for name, (got, want) in pooled.items():
        atol, rtol, share, bound_on = FFN_BWD_LIMITS[name]
        share = flip_share(share, C)
        check(f'ffn_train_bwd C={C} {name}, rows {K4_ODD_M}, F '
              f'{FFN_BWD_ODD_F}, '
              f'pooled', torch.cat(got), torch.cat(want), atol, rtol,
              share=share, **bound_on)


# attention_train_fwd and attention_train_bwd at odd shapes, before
# anything is timed: T about their 64-row tiles and 128-row blocks, the
# per-layer and whole-layer train windows, and two long ones
ATB_ODD_T = (1, 63, 64, 65, 127, 128, 129, 500, 512, 1000, 1024)


def check_keep_words(name, words, drop, mask, causal):
    """The keep words of attention_train_fwd against their plain packing
    (``keep_words_reference``) masked to the valid pairs, bit for bit: the
    kernel writes the bits of those only, and 0 for every other pair and
    past T. Returns the count of valid pairs."""
    from ppgs_tpu_torch.ops import flash_attention as fa

    B, H, T, _ = words.shape
    shift = torch.arange(32, device=words.device)

    def bits(w):
        return (((w.long()[..., None] >> shift) & 1)
                .reshape(B, H, T, -1).bool())

    valid = fa._valid(mask, T, causal).expand(B, H, T, T)
    want = bits(fa.keep_words_reference(drop, B, H, T, words.device))
    got = bits(words)
    if (not torch.equal(got[..., :T], want[..., :T] & valid)
            or got[..., T:].any()):
        raise AssertionError(f'{name}: the keep words differ from Philox\'s '
                             f'bits on the valid pairs, 0 elsewhere')
    return int(valid.sum().item())


@torch.no_grad()
def attention_train_odd_shape_checks(dev, D=128, share=1e-6, outlier=8e-3,
                                     f32_flips=None):
    """attention_train_fwd and attention_train_bwd against their plain
    versions at ``ATB_ODD_T``, 4 windows of 2 heads of D on N(0, 1) q, k,
    v and dO (views of fused buffers): masks ragged, holed (one whole
    64-key tile masked where T reaches it), wholly masked and full, one
    window each; causal off and on; dropout off and 0.1. The forward with
    want_f32 off and on (both callers' forms): its bf16 o, fp32 o and lse,
    its keep words equal to Philox's bits on the valid pairs and 0
    elsewhere (``check_keep_words``). The backward, on lse and d_row from
    the plain forward and the kernel forward's keep words (the plain
    backward draws its own), with want_c / want32 bf16 only, fp32 only and
    both. For both kernels: the wholly masked window exactly 0, the bf16
    output the kernel's own fp32 output rounded, two calls on the same
    inputs equal bit for bit. Limits: ``train_kernel_checks``' for each
    kernel: fp32 atol 2e-3 rtol 1e-2 and lse atol 1e-4 in every case; bf16
    atol 1e-3 rtol 1e-2 but for a ``share`` (1e-6 at d_head 128) of
    rounding flips each within ``outlier`` (8e-3 at d_head 128), the share
    taken of each kernel's bf16 elements of all the cases together (a case
    at small T holds fewer than 10^6 elements). With ``f32_flips``, a
    (share, bound) pair (the wide head widths, where one p or ds rounded to
    bf16 on the other side of a boundary moves a row's d_head fp32 outputs,
    and the more of them the wider the head: an H100 read one past the
    fp32 limit in a case of 2.4 million at d_head 384), the fp32 limits
    too hold but for that share of each kernel's fp32 elements of all the
    cases together, each within that bound. Prints the max |kernel -
    plain| by T."""
    from ppgs_tpu_torch.ops import dropout
    from ppgs_tpu_torch.ops import flash_attention as fa

    # A generator of its own: the phases' own draws stay as they were
    gen = torch.Generator(device=dev).manual_seed(SEED + 47)
    H = 2
    C = H * D
    sl, sm = fa.LOG2E / math.sqrt(D), 1 / math.sqrt(D)
    cases, fwd_cases, pairs = [], [], 0
    pooled = {'attention_train_fwd': ([], []), 'attention_train_bwd': ([], [])}

    def same(name, a, b):
        if not all(x is y or torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f'{name}: two calls differ')

    # fp32 elements past the limits, elements, the worst of them, a kernel
    beyond = {kernel: [0, 0, 0.0] for kernel in pooled}

    def f32_case(kernel, name, got, want):
        """The fp32 limit of one case, or with f32_flips its count of
        elements past it, pooled; returns the max |kernel - plain|."""
        if not f32_flips:
            return check(name, got, want, atol=2e-3, rtol=1e-2, quiet=True)
        diff = (got - want).abs()
        over = diff > 2e-3 + 1e-2 * want.abs()
        tally = beyond[kernel]
        tally[0] += int(over.sum().item())
        tally[1] += diff.numel()
        if over.any():
            tally[2] = max(tally[2], diff[over].max().item())
        return diff.max().item()

    for T in ATB_ODD_T:
        qkv = torch.randn(4, T, 3 * C, generator=gen, device=dev).to(
            torch.bfloat16)
        do = torch.randn(4, T, 2 * C, generator=gen, device=dev).to(
            torch.bfloat16)[..., C:]
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        keys = torch.arange(T, device=dev)
        mask = torch.stack([keys < max(1, 2 * T // 3),
                            torch.rand(T, generator=gen, device=dev) < 0.6,
                            torch.zeros(T, dtype=torch.bool, device=dev),
                            torch.ones(T, dtype=torch.bool, device=dev)])
        mask[1, 64:128] = False
        worst = fwd_worst = 0.0
        for causal, rate in itertools.product((False, True), (0.0, DROPOUT)):
            drop = dropout.Drop(SEED + 19, dropout.site(1, 'probs'), rate)
            o, o32, lse, _ = fa.attention_train_fwd_reference(
                q, k, v, mask, H, sl, causal, drop, want_f32=True)
            name = f'attention_train_fwd T={T} causal={causal} rate={rate}'
            att = (q, k, v, mask, H, sl, causal, drop)
            for want_f32 in (False, True):
                got = fa.attention_train_fwd(*att, want_f32=want_f32)
                same(name, got, fa.attention_train_fwd(*att,
                                                       want_f32=want_f32))
                pooled['attention_train_fwd'][0].append(got[0].flatten())
                pooled['attention_train_fwd'][1].append(o.flatten())
                fwd_worst = max(
                    fwd_worst,
                    (got[0].float() - o.float()).abs().max().item(),
                    check(name, got[2], lse, atol=1e-4, quiet=True))
                if want_f32:
                    fwd_worst = max(fwd_worst, f32_case(
                        'attention_train_fwd', name, got[1], o32))
                    if not torch.equal(got[0], got[1].to(torch.bfloat16)):
                        raise AssertionError(f'{name}: the bf16 o is not the '
                                             f'fp32 o rounded')
                if got[0][2].any() or got[2][2].any() or (
                        want_f32 and got[1][2].any()):
                    raise AssertionError(f'{name}: the wholly masked window '
                                         f'did not give 0')
                keep = got[3]
                if (keep is None) != (rate == 0):
                    raise AssertionError(f'{name}: keep words given with '
                                         f'the dropout off, or none with it '
                                         f'on')
                if keep is not None:
                    pairs += check_keep_words(name, keep, drop, mask, causal)
            d_row = fa.row_dot_reference(do, o32, H).contiguous()
            args = (q, k, v, mask, lse, keep, do, d_row, H, sl, sm, causal,
                    drop)
            w16, w32 = fa.attention_train_bwd_reference(*args, want32=True)
            name = f'attention_train_bwd T={T} causal={causal} rate={rate}'
            for want_c, want32 in ((True, False), (False, True),
                                   (True, True)):
                got = fa.attention_train_bwd(*args, want_c=want_c,
                                             want32=want32)
                if got[1] is not None:
                    worst = max(worst, f32_case('attention_train_bwd', name,
                                                got[1], w32))
                if got[0] is not None:
                    pooled['attention_train_bwd'][0].append(got[0].flatten())
                    pooled['attention_train_bwd'][1].append(w16.flatten())
                    worst = max(worst, (got[0].float() - w16.float()).abs()
                                .max().item())
                if any(out is not None and out[2].any() for out in got):
                    raise AssertionError(f'{name}: the wholly masked window '
                                         f'did not give 0')
            same(name, got, fa.attention_train_bwd(*args, want32=True))
            if not torch.equal(got[0], got[1].to(torch.bfloat16)):
                raise AssertionError(f'{name}: the bf16 output is not the '
                                     f'fp32 one rounded')
        cases.append(f'{T} {worst:.3g}')
        fwd_cases.append(f'{T} {fwd_worst:.3g}')
    for kernel, (got16, want16) in pooled.items():
        check(f'{kernel} d_head {D} at T = {ATB_ODD_T[0]} ... '
              f'{ATB_ODD_T[-1]}, bf16, {sum(t.numel() for t in got16)} '
              f'elements', torch.cat(got16), torch.cat(want16), 1e-3, 1e-2,
              share=share, outlier=outlier)
    f32_share, f32_bound = f32_flips or (0.0, 0.0)
    pool = (f', fp32 but for a pooled share {f32_share:.3g}' if f32_flips
            else '')
    for kernel, (over, elements, worst_over) in beyond.items():
        if f32_flips:
            print(f'{kernel} d_head {D}, fp32: {over} of {elements} elements '
                  f'past atol 2e-3 rtol 1e-2 (at most {f32_share:.3g} of '
                  f'them may be), the worst {worst_over:.3g} (<= '
                  f'{f32_bound:.3g})', flush=True)
        if over > f32_share * elements or worst_over > f32_bound:
            raise AssertionError(f'{kernel} d_head {D}: fp32 outputs past '
                                 f'the limits beyond their share')
    print(f'attention_train_fwd (4 windows, {H} heads of {D}), ragged, '
          f'holed, wholly masked and full windows, causal off and on, '
          f'dropout off and {DROPOUT}, want_f32 off and on: max |kernel - '
          f'plain| of o and lse by T: {", ".join(fwd_cases)} (fp32 o atol '
          f'2e-3 rtol 1e-2, lse atol 1e-4 in each case{pool}); the wholly '
          f'masked window exactly 0; bf16 the fp32 rounded; two calls equal '
          f'bit for bit; the keep words equal to Philox\'s bits on all '
          f'{pairs} valid pairs and 0 elsewhere', flush=True)
    print(f'attention_train_bwd (4 windows, {H} heads of {D}), the same '
          f'windows, causal off and on, dropout off and {DROPOUT}, bf16 / '
          f'fp32 / both: max |kernel - plain| by T: {", ".join(cases)} (fp32 '
          f'atol 2e-3 rtol 1e-2 in each case{pool}); the wholly masked window '
          f'exactly 0; bf16 the fp32 rounded; two calls equal bit for bit',
          flush=True)


def check_rel(name, got, want, limit):
    """Raise unless the relative L2 error |got - want| / |want| <= limit;
    return the max |diff|. For the gradients of a whole layer, where the
    rounding flips of ``check`` propagate through sums."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name}: non-finite values')
    rel = relative_l2(got, want)
    worst = (got - want).abs().max().item()
    print(f'{name}: relative L2 error {rel:.3g} (<= {limit}), max |diff| '
          f'{worst:.3g}, mean |plain| {want.abs().mean().item():.3g}',
          flush=True)
    if not rel <= limit:
        raise AssertionError(f'{name}: relative error {rel:.3g} > {limit}')
    return worst


def median_seconds(fn, reps=5):
    """Median wall seconds of ``fn`` on the host clock, each run ended by
    a synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    return statistics.median(times)


def opt_in_against_default(name, got, ppg, ppg32, card):
    """An opt-in path's PPGs against the default path's: atol 2e-2 and
    argmax agreement >= 99.5% on the frames bf16 decides, those where the
    default path agrees with the same weights in fp32 (``ppg32``)."""
    diff = (got - ppg).abs().max().item()
    same = got.argmax(1) == ppg.argmax(1)
    decided = ppg.argmax(1) == ppg32.argmax(1)
    rates = (same.float().mean().item(), decided.float().mean().item(),
             same[decided].float().mean().item(),
             (ppg - ppg32).abs().max().item())
    print(f'{name} against the default path: max |diff| {diff:.3g} (atol '
          f'2e-2), argmax agreement {rates[0]:.5f}, {rates[2]:.5f} (>= 0.995) '
          f'on the frames bf16 decides ({rates[1]:.5f} of them: the default '
          f'path and fp32 agree); the default path against fp32: max |diff| '
          f'{rates[3]:.3g} [{card}]', flush=True)
    if diff > 2e-2 or rates[2] < 0.995:
        raise AssertionError(f'{name} leaves the bf16 envelope')


def train_batch(config, B, T, seed, dev):
    """A fixed synthetic batch made on the card: random features (the
    config's input channels),
    ragged lengths (the first window whole), random targets with -100
    padding."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = T - torch.randint(0, T // 4, (B,), generator=gen, device=dev)
    lengths[0] = T
    mask = torch.arange(T, device=dev)[None] < lengths[:, None]
    features = (torch.randn(B, config.input_channels, T, generator=gen,
                            device=dev) * mask[:, None, :])
    targets = torch.randint(0, config.output_channels, (B, T), generator=gen,
                            device=dev).masked_fill(~mask, -100)
    return features, targets, lengths


def layer_grads(fn, x, mask, layer, heads, cot, seed):
    """out, dx and the 12 parameter tensors' gradients of one train layer
    (the fused QKV weight and bias hold 6 of the 14 JAX gradients)."""
    xx = x.detach().clone().requires_grad_()
    out = fn(xx, mask, layer, heads, DROPOUT, seed=seed)
    params = list(layer.parameters())
    grads = torch.autograd.grad(out, [xx] + params, cot)
    names = ['dx'] + [name for name, _ in layer.named_parameters()]
    return out.detach(), dict(zip(names, grads))


@torch.no_grad()
def train_kernel_checks(port, config, layer, dev, gen):
    """Each train kernel against its plain version at the training shape,
    dropout 0.1 with identical Philox masks; returns (max errors, inputs
    for the timing phase)."""
    from ppgs_tpu_torch.ops import backward, dropout
    from ppgs_tpu_torch.ops import encoder_layer_train as elt
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    C, H = config.hidden_channels, config.attention_heads
    B, T, M = TRAIN_B, TRAIN_T, TRAIN_B * TRAIN_T
    bf16 = torch.bfloat16
    # Ragged windows, one wholly masked
    lengths = T - torch.randint(0, T // 2, (B,), generator=gen, device=dev)
    lengths[0], lengths[-1] = T, 0
    mask = port.ops.masking.mask_from_lengths(lengths, T)
    drop = dropout.Drop(SEED + 17, dropout.site(0, 'probs'), DROPOUT)
    x = torch.randn(B, T, C, generator=gen, device=dev)
    wqkv, wo = layer.attn.wqkv.to(bf16), layer.attn.wo.to(bf16)
    w1, w2 = layer.ffn.w1.to(bf16), layer.ffn.w2.to(bf16)
    n1, n2, ffn = layer.norm1, layer.norm2, layer.ffn
    sl, sm = fa.LOG2E / math.sqrt(C // H), 1 / math.sqrt(C // H)
    err = {}

    elk = port.ops.encoder_layer_kernel
    k1_odd_shape_checks('train, unfolded weights', wqkv, layer.attn.bqkv,
                        dev)
    k3_odd_shape_checks((), C, dev)
    qkv = elk.qkv_proj(x, wqkv, layer.attn.bqkv)
    # A product near a rounding boundary of [4, 8) flips by its bf16 ulp,
    # 0.0312, before the bias is added; where the bias cancels it to an
    # output near 1, that is beyond rtol (both sides round the product,
    # then add the bf16 bias: JAX's dot_cd form)
    err['qkv_proj'] = check(
        f'K1 qkv_proj (train, {M} rows, unfolded weights)', qkv,
        elk.qkv_proj_reference(x, wqkv, layer.attn.bqkv), 1e-2, 1e-2,
        share=2e-8, outlier=6.25e-2)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    att = (q, k, v, mask, H, sl, False, drop)
    a16, a32, lse, keep = fa.attention_train_fwd(*att, want_f32=True)
    p16, p32, plse, _ = fa.attention_train_fwd_reference(*att,
                                                         want_f32=True)
    err['attention_train_fwd'] = max(
        check('attention_train_fwd o (bf16)', a16, p16, 1e-3, 1e-2,
              share=1e-6, outlier=8e-3),
        check('attention_train_fwd o (fp32)', a32, p32, atol=2e-3, rtol=1e-2),
        check('attention_train_fwd lse', lse, plse, atol=1e-4))
    if a16[-1].abs().max().item() != 0:
        raise AssertionError('the wholly masked window did not give 0')
    del p16, p32, plse
    print(f'attention_train_fwd keep words: equal to Philox\'s bits on all '
          f'{check_keep_words("attention_train_fwd", keep, drop, mask, False)}'
          f' valid pairs', flush=True)

    do = torch.randn(B, T, C, generator=gen, device=dev)
    d_row = fa.row_dot(do, a32, H)
    err['row_dot'] = check('row_dot (fp32)', d_row,
                           fa.row_dot_reference(do, a32, H), atol=1e-3,
                           rtol=1e-4)
    check('row_dot (bf16)', fa.row_dot(do.to(bf16), a16, H),
          fa.row_dot_reference(do.to(bf16), a16, H), atol=1e-3, rtol=1e-4)
    bwd = (q, k, v, mask, lse, keep, do.to(bf16), d_row, H, sl, sm, False,
           drop)
    d16, d32 = fa.attention_train_bwd(*bwd, want32=True)
    w16, w32 = fa.attention_train_bwd_reference(*bwd, want32=True)
    err['attention_train_bwd'] = max(
        check('attention_train_bwd dqkv (bf16)', d16, w16, 1e-3, 1e-2,
              share=1e-6, outlier=8e-3),
        check('attention_train_bwd dqkv (fp32)', d32, w32, atol=2e-3,
              rtol=1e-2))
    del w16, w32

    out_ln = (a16, wo, layer.attn.bo, x, n1.scale, n1.bias,
              drop.at(drop.site + 1))
    r, n, rstd = elt.out_proj_ln_train(*out_ln)
    pr, pn, prstd = elt.out_proj_ln_train_reference(*out_ln)
    err['out_proj_ln_train'] = max(
        check('out_proj_ln_train r', r, pr, atol=1e-4),
        check('out_proj_ln_train n', n, pn, atol=1e-4),
        check('out_proj_ln_train rstd', rstd, prstd, atol=1e-5, rtol=1e-5))
    del pr, pn, prstd
    check_k3_mask('out_proj_ln_train', M, C, out_ln[-1], dev)
    print(f'out_proj_ln_train: its dropout mask is the plain version\'s, bit '
          f'for bit, on all {M} rows', flush=True)

    g = torch.randn(B, T, C, generator=gen, device=dev)
    lnb = (g, n, rstd, n1.scale, drop.at(drop.site + 1), bf16)
    dz, masked, part = backward.ln_dropout_bwd(*lnb)
    pdz, pmasked, ppart = backward.ln_dropout_bwd_reference(*lnb)
    err['ln_dropout_bwd'] = max(
        check('ln_dropout_bwd dz', dz, pdz, atol=1e-5, rtol=1e-5),
        check('ln_dropout_bwd masked (bf16)', masked, pmasked, 1e-5,
              1e-2, share=1e-6, outlier=3.2e-2),
        check('ln_dropout_bwd partial sums', part, ppart, atol=1e-3,
              rtol=1e-4))
    err['colsum'] = check('colsum (M x 3C)', backward.colsum(d32.view(M, -1)),
                          backward.colsum_reference(d32.view(M, -1)),
                          atol=1e-3, rtol=1e-4)
    colsum_inputs = colsum_step_checks(config, M, d32, dev)
    del pdz, pmasked, ppart

    drop_h, drop_y = drop.at(drop.site + 2), drop.at(drop.site + 3)
    fwd = (r, w1, ffn.b1, w2, ffn.b2, drop_h, drop_y, (n2.scale, n2.bias))
    out, n_2, rstd2, hkeep = fused_ffn.ffn_train_fwd(*fwd)
    pout, pn2, prstd2, _ = fused_ffn.ffn_train_fwd_reference(*fwd)
    err['ffn_train_fwd'] = max(
        check('ffn_train_fwd out (LN2 epilogue)', out, pout, 1e-3, 1e-3,
              share=1e-6, outlier=2e-3),
        check('ffn_train_fwd n', n_2, pn2, 1e-3, 1e-3, share=1e-6,
              outlier=2e-3),
        check('ffn_train_fwd rstd', rstd2, prstd2, atol=1e-3, rtol=1e-3))
    del pout, pn2, prstd2
    check_hidden_words('ffn_train_fwd', hkeep, drop_h)
    print(f'ffn_train_fwd keep words: equal to Philox\'s bits on all {M} '
          f'rows', flush=True)
    r16 = r.to(bf16)
    plain_fwd = (r16, w1, ffn.b1, w2, ffn.b2, drop_h, drop_y)
    check('ffn_train_fwd y (bf16 epilogue)',
          fused_ffn.ffn_train_fwd(*plain_fwd)[0],
          fused_ffn.ffn_train_fwd_reference(*plain_fwd)[0], 1e-3, 1e-2,
          share=flip_share(5e-5, C), outlier=4.7e-2)

    dy = masked
    # The backward reads K4's words; its plain version draws the bits
    fb = (r, dy, w1, ffn.b1, w2, drop_h, hkeep, dz)
    got_b = fused_ffn.ffn_train_bwd(*fb)
    want_b = with_relu_flips(
        fused_ffn.ffn_train_bwd_reference(*fb[:6], None, dz), got_b, w1)
    names = ('dx (fp32 + residual)', 'hd', 'dh', 'db1 partial sums')

    def held(name, a, b):
        atol, rtol, share, bound_on = FFN_BWD_LIMITS[name]
        share = flip_share(share, C)
        return check(f'ffn_train_bwd {name}', a, b, atol, rtol, share=share,
                     **bound_on)

    err['ffn_train_bwd'] = max(held(name, a, b) for name, a, b in zip(
        names, got_b, want_b))
    del want_b
    fb16 = (r16, dy, w1, ffn.b1, w2, drop_h, hkeep)
    got16 = fused_ffn.ffn_train_bwd(*fb16)
    held('dx (bf16)', got16[0], with_relu_flips(
        fused_ffn.ffn_train_bwd_reference(*fb16[:6], None), got16, w1)[0])
    del got16

    hd, dh = got_b[1], got_b[2]
    inputs = dict(C=C, H=H, B=B, T=T, M=M, x=x, mask=mask, q=q, k=k, v=v,
                  qkv=qkv, drop=drop, sl=sl, sm=sm, a16=a16, a32=a32, lse=lse,
                  keep=keep, do=do, d_row=d_row, d16=d16, d32=d32, r=r, n=n,
                  rstd=rstd,
                  g=g, masked=masked, dz=dz, hd=hd, dh=dh, hkeep=hkeep,
                  wo=wo, wqkv=wqkv,
                  bqkv=layer.attn.bqkv, w1=w1, w2=w2, lengths=lengths,
                  colsum=colsum_inputs)
    forms = gemm_form_checks(inputs)
    err['gemm'] = max(forms.values())
    err.update({f'gemm {name}': e for name, e in forms.items()})
    return err, inputs


def colsum_shapes(config, M):
    """colsum's (R, N) at each of its launches in a whole-layer train step
    of M rows (ops/encoder_layer_train.py): dbqkv's column sums, the two
    ln_dropout_bwd partials, ffn_train_bwd's db1 partials, and the four
    weight gradients' split partials; with their launches a layer."""
    from ppgs_tpu_torch.ops import backward

    C, Fh = config.hidden_channels, config.ffn_channels
    rows = -(-M // backward.PARTIAL_ROWS)
    shapes = {'dbqkv': ((M, 3 * C), 1), 'ln_dropout_bwd partials':
              ((rows, 3 * C), 2), 'db1 partials': ((rows, Fh), 1)}
    for name, (m, n) in {'dW1': (C, Fh), 'dW2': (Fh, C), 'dWo': (C, C),
                         'dWqkv': (C, 3 * C)}.items():
        shapes[f'{name} partials'] = ((backward.split_count(m, n, M), m * n),
                                      1)
    return shapes


@torch.no_grad()
def colsum_step_checks(config, M, d32, dev):
    """colsum against its plain version at each step shape (atol 1e-3, rtol
    1e-4), two calls bit for bit, and its bf16 rounding the rounding of its
    own sums; returns the inputs (seeded on their own, so that the other
    checks draw what they drew before), for the times."""
    from ppgs_tpu_torch.ops import backward

    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    inputs = {}
    for name, ((R, N), _) in colsum_shapes(config, M).items():
        t = (d32.view(R, N) if name == 'dbqkv'
             else torch.randn(R, N, generator=gen, device=dev))
        got = backward.colsum(t)
        check(f'colsum {name} ({R} x {N})', got, backward.colsum_reference(t),
              atol=1e-3, rtol=1e-4)
        if not torch.equal(backward.colsum(t), got):
            raise AssertionError(f'colsum {name}: two calls differ')
        if not torch.equal(backward.colsum(t, round_to=torch.bfloat16),
                           got.to(torch.bfloat16).float()):
            raise AssertionError(f'colsum {name}: the bf16 rounding is not '
                                 f'that of its sums')
        inputs[name] = t
    print('colsum: two calls bit for bit and the bf16 rounding that of its '
          'sums at every step shape', flush=True)
    return inputs


def colsum_step_times(config, inputs, card):
    """colsum at each step shape: CUDA-event and device time beside
    t.sum(0)'s and the bound (the tensor read once, the sums written)."""
    from ppgs_tpu_torch.ops import backward

    for name, ((R, N), per_layer) in colsum_shapes(
            config, TRAIN_B * TRAIN_T).items():
        t = inputs[name]
        ms, lib_ms = (time_ms(lambda: backward.colsum(t), TRAIN_REPS, 2),
                      time_ms(lambda: t.sum(0), TRAIN_REPS, 2))
        bound_ms, _ = bound(R * N, (R * N + N) * 4)
        dev_ms = kernel_device_ms(f'colsum {name}', lambda: backward.colsum(t),
                                  card)
        lib_dev = kernel_device_ms(f't.sum(0) {name}', lambda: t.sum(0), card)
        fmt = lambda v: 'not measured' if v is None else f'{v:.4f} ms'  # noqa
        print(f'colsum {name} ({R} x {N}), {per_layer * config.num_hidden_layers} '
              f'launches a step: event {ms:.4f} ms, device {fmt(dev_ms)}, '
              f'bound {bound_ms:.4f} ms (bytes), t.sum(0) event '
              f'{lib_ms:.4f} ms, device {fmt(lib_dev)} [{card}]', flush=True)


def gemm_forms(inp, rows):
    """The six gemm forms of a layer's backward (ops/encoder_layer_train.py)
    on the training inputs' first ``rows`` rows: name -> (a, b, keyword
    arguments of a data-gradient form, or None for a weight gradient
    a^T b)."""
    C = inp['C']
    dy = inp['masked'].view(-1, C)[:rows]
    dqkv = inp['d16'].view(-1, 3 * C)[:rows]
    return {
        'dW1': (inp['r'].view(-1, C)[:rows], inp['dh'][:rows], None),
        'dW2': (inp['hd'][:rows], dy, None),
        'dWo': (inp['a16'].view(-1, C)[:rows], dy, None),
        'dWqkv': (inp['x'].view(-1, C)[:rows], dqkv, None),
        'da': (dy, inp['wo'], dict(want16=True)),
        'dx': (dqkv, inp['wqkv'],
               dict(residual=inp['dz'].view(-1, C)[:rows])),
    }


def run_gemm_form(fn, a, b, kw):
    """One launch of a form through ``fn`` (the kernel or its plain
    version): a weight gradient's split partials, or a data gradient's
    (fp32, bf16) pair."""
    from ppgs_tpu_torch.ops import backward

    if kw is None:
        splits = backward.split_count(a.shape[1], b.shape[1], a.shape[0])
        return fn(a, b, True, False, torch.bfloat16, splits=splits)[0]
    return fn(a, b, False, True, torch.bfloat16, **kw)


def gemm_small_checks(dev, gen):
    """The gemm kernel at small odd shapes, each (ta, tb) and type of a,
    both block widths (N % 256 and not), ragged rows, depths and splits,
    against its plain version, before anything is timed. fp32 results:
    sums of at most 4,100 products, atol 1e-3 rtol 1e-4; a bf16 result must
    equal the kernel's own fp32 result rounded (one epilogue)."""
    from ppgs_tpu_torch.ops import backward

    bf16 = torch.bfloat16
    worst = 0.0
    for M, K, N in ((200, 72, 256), (130, 264, 384), (64, 8, 128)):
        a = torch.randn(M, K, generator=gen, device=dev).to(bf16)
        b = torch.randn(N, K, generator=gen, device=dev).to(bf16)
        res = torch.randn(M, N, generator=gen, device=dev)
        for kw in (dict(want16=True), dict(residual=res)):
            got32, got16 = backward.gemm(a, b, False, True, bf16, **kw)
            want32, _ = backward.gemm_reference(a, b, False, True, bf16,
                                                **kw)
            worst = max(worst, check(
                f'gemm (0, 1) M={M} K={K} N={N} {sorted(kw)[0]} (fp32)',
                got32, want32, atol=1e-3, rtol=1e-4))
            if got16 is not None and not torch.equal(got16,
                                                     got32.to(bf16)):
                raise AssertionError(f'gemm (0, 1) M={M} K={K} N={N}: the '
                                     f'bf16 result is not the fp32 one '
                                     f'rounded')
    for a_type in (bf16, torch.float32):
        for K, M, N, splits in ((1000, 136, 384, 3), (77, 64, 256, 1),
                                (4100, 256, 256, 5)):
            a = torch.randn(K, M, generator=gen, device=dev).to(a_type)
            b = torch.randn(K, N, generator=gen, device=dev).to(bf16)
            worst = max(worst, check(
                f'gemm (1, 0) {str(a_type)[6:]} a, K={K} M={M} N={N}, '
                f'{splits} splits', backward.gemm(a, b, True, False, bf16,
                                                  splits=splits)[0],
                backward.gemm_reference(a, b, True, False, bf16,
                                        splits=splits)[0],
                atol=1e-3, rtol=1e-4))
    return worst


def gemm_form_checks(inp):
    """The six forms at the training shape against their plain versions,
    the weight gradients split and summed as the step sums them; dW1 and
    dWo again on 128,000 rows (256 x 500: the last chunk ragged), and dW1
    twice, bit for bit."""
    from ppgs_tpu_torch.ops import backward

    bf16, M = torch.bfloat16, inp['M']
    err = {}
    for rows in (M, TRAIN_B * SPLIT_T):
        for name, (a, b, kw) in gemm_forms(inp, rows).items():
            if rows != M and name not in ('dW1', 'dWo'):
                continue
            label = f'gemm {name}, {rows} rows'
            if kw is None:
                got = backward.weight_grad(a, b, bf16)
                want = backward.weight_grad(a, b, bf16,
                                            backward.gemm_reference,
                                            backward.colsum_reference)
                # sums of 16-131 thousand products: fp32 rounding in
                # another order moves them by ~1e-3 absolute, and the bf16
                # rounding of the result then flips by an ulp now and then
                err[name] = max(err.get(name, 0.0), check(
                    f'{label} (split, rounded to bf16)', got, want, 2e-2,
                    1e-2, share=1e-6, outlier=4.0))
                continue
            got32, got16 = run_gemm_form(backward.gemm, a, b, kw)
            want32, want16 = run_gemm_form(backward.gemm_reference, a, b,
                                           kw)
            err[name] = check(f'{label} (fp32)', got32, want32, atol=1e-3,
                              rtol=1e-4)
            if got16 is not None:
                err[name] = max(err[name], check(
                    f'{label} (bf16)', got16, want16, 1e-5, 1e-2,
                    share=1e-6, outlier=3.2e-2))
    a, b, kw = gemm_forms(inp, M)['dW1']
    first, again = (run_gemm_form(backward.gemm, a, b, kw) for _ in range(2))
    if not torch.equal(first, again):
        raise AssertionError('gemm dW1: two launches differ')
    print('gemm dW1: two launches equal bit for bit', flush=True)
    return err


def whole_function_checks(config, layer, dev, gen, mask):
    """B4 (the whole layer: out, dx and its 14 gradients), and B5 and B6 at
    the per-layer path's T = 500, each against its plain version."""
    from ppgs_tpu_torch.ops import encoder_layer_train as elt
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    C, H = config.hidden_channels, config.attention_heads
    B, T = TRAIN_B, TRAIN_T
    x = torch.randn(B, T, C, generator=gen, device=dev)
    cot = torch.randn(B, T, C, generator=gen, device=dev)
    got = layer_grads(elt.encoder_layer_train, x, mask, layer, H, cot, 5)
    want = layer_grads(elt.encoder_layer_train_reference, x, mask, layer, H,
                       cot, 5)
    check('B4 encoder_layer_train out', got[0], want[0], 2e-2, 2e-2,
          share=1e-6, outlier=4e-2)
    for name in want[1]:
        check_rel(f'B4 grad {name}', got[1][name], want[1][name],
                  flip_rel(1e-2, C))
    del got, want

    T = SPLIT_T
    lengths = T - torch.randint(0, T // 2, (B,), generator=gen, device=dev)
    lengths[0] = T
    mask5 = torch.arange(T, device=dev)[None] < lengths[:, None]
    qkv = (torch.randn(B, T, 3 * C, generator=gen, device=dev)
           .to(torch.bfloat16))
    do = torch.randn(B, T, C, generator=gen, device=dev).to(torch.bfloat16)
    for causal in (False, True):
        results = []
        for fn in (fa.flash_attention_train,
                   fa.flash_attention_train_reference):
            leaf = qkv.clone().requires_grad_()
            o = fn(leaf[..., :C], leaf[..., C:2 * C], leaf[..., 2 * C:],
                   mask5, H, DROPOUT, seed=6, causal=causal, site=1)
            results.append((o.detach(), torch.autograd.grad(o, leaf, do)[0]))
        name = f'B5 flash_attention_train T={T} causal={causal}'
        check(f'{name} out', results[0][0], results[1][0], 1e-3, 1e-2,
              share=1e-6, outlier=1.6e-2)
        check_rel(f'{name} dqkv', results[0][1], results[1][1], 1e-2)
        del results

    ffn = layer.ffn
    xs = torch.randn(B * T, C, generator=gen, device=dev).to(torch.bfloat16)
    gy = torch.randn(B * T, C, generator=gen, device=dev).to(torch.bfloat16)
    results = []
    for fn in (fused_ffn.ffn_train, fused_ffn.ffn_train_reference):
        leaves = [t.detach().to(torch.bfloat16).requires_grad_()
                  for t in (xs, ffn.w1, ffn.b1, ffn.w2, ffn.b2)]
        y = fn(*leaves, DROPOUT, seed=6, site=3)
        results.append((y.detach(), torch.autograd.grad(y, leaves, gy)))
    check(f'B6 ffn_train M={B * T} out', results[0][0], results[1][0],
          1e-3, 1e-2, share=flip_share(5e-5, C), outlier=4.7e-2)
    for name, a, b in zip(('dx', 'dw1', 'db1', 'dw2', 'db2'), results[0][1],
                          results[1][1]):
        check_rel(f'B6 ffn_train M={B * T} {name}', a, b, 1e-2)


def train_counters():
    from ppgs_tpu_torch.ops import backward
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import encoder_layer_train as elt
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    return {'qkv_proj': elk.qkv_proj,
            'attention_train_fwd': fa.attention_train_fwd,
            'row_dot': fa.row_dot,
            'attention_train_bwd': fa.attention_train_bwd,
            'out_proj_ln_train': elt.out_proj_ln_train,
            'ffn_train_fwd': fused_ffn.ffn_train_fwd,
            'ffn_train_bwd': fused_ffn.ffn_train_bwd,
            'ln_dropout_bwd': backward.ln_dropout_bwd,
            'gemm': backward.gemm, 'colsum': backward.colsum}


def recording_losses(core, losses):
    """Make ``core.make_train_step`` hand out steps that append their loss
    to ``losses``, as the train loop takes them (the loop logs only every
    LOG_INTERVAL steps); returns the original, to be put back."""
    original = core.make_train_step

    def make_train_step(*args, **kwargs):
        step = original(*args, **kwargs)

        def recorded(*step_args, **step_kwargs):
            train_loss, stats = step(*step_args, **step_kwargs)
            losses.append(float(train_loss))
            return train_loss, stats
        return recorded

    core.make_train_step = make_train_step
    return original


def train_run(port, config, dev, directory, card):
    """The slice's main path: ``train()`` at full width and depth on a fixed
    synthetic batch, TRAIN_STEPS steps at 256 x 512 (the whole-layer path)
    with an evaluation at step 0 and checkpoints, then a resume that takes
    one step at 256 x 500 (the per-layer path). Returns (the model, the
    launches of the whole run, the 256 x 500 step's launches, each 256 x
    512 step's launches)."""
    counters = train_counters()
    batch = train_batch(config, TRAIN_B, TRAIN_T, SEED + 1, dev)
    split_batch = train_batch(config, TRAIN_B, SPLIT_T, SEED + 2, dev)
    valid = [train_batch(config, 64, TRAIN_T, SEED + 3 + i, dev)
             for i in range(2)]
    snapshots = []

    def loader(train_data):
        def loader_fn(partition):
            if partition != 'train':
                yield from valid
                return
            while True:
                torch.cuda.synchronize()
                snapshots.append({n: f.launches for n, f in counters.items()})
                yield train_data
        return loader_fn

    run_config = config.replace(checkpoint_interval=2)
    core, losses = port.train.core, []
    original = recording_losses(core, losses)
    try:
        for fn in counters.values():
            fn.launches = 0
        counters['gemm'].forms.clear()
        start = time.perf_counter()
        model = port.train.train(directory=directory, config=run_config,
                                 max_steps=TRAIN_STEPS,
                                 loader_fn=loader(batch))
        torch.cuda.synchronize()
        first = time.perf_counter() - start
        snapshots.append({n: f.launches for n, f in counters.items()})
        b4_steps = [{n: b[n] - a[n] for n in a}
                    for a, b in zip(snapshots[:-1], snapshots[1:])]
        print(f'train(): {TRAIN_STEPS} steps at {TRAIN_B} x {TRAIN_T} with '
              f'an evaluation at step 0, {first:.1f} s; losses {losses} '
              f'[{card}]', flush=True)
        if (len(losses) != TRAIN_STEPS
                or not all(math.isfinite(v) for v in losses)
                or not losses[-1] < losses[0]):
            raise AssertionError(f'the train losses are not finite and '
                                 f'falling: {losses}')
        resumed = resume(port, run_config, directory, loader(split_batch),
                         model, counters, snapshots, losses)
    finally:
        core.make_train_step = original
    return (*resumed, b4_steps)


def resume(port, run_config, directory, loader_fn, model, counters,
           snapshots, losses):
    """The second half of ``train_run``: check the last checkpoint, resume
    from it for one step at 256 x 500 and check that the run continued.
    Returns (the model, the launches of both runs, the step's launches)."""
    # The checkpoint of the last step holds the returned model
    last = Path(directory) / f'{TRAIN_STEPS:08d}.npz'
    with np.load(last) as saved:
        for key, value in port.convert.params_to_jax(
                model.state_dict()).items():
            if not np.array_equal(saved[f'params.{key}'], value):
                raise AssertionError(f'{last.name}: {key} differs from the '
                                     f'trained model')

    snapshots.clear()
    resumed = port.train.train(directory=directory, config=run_config,
                               max_steps=TRAIN_STEPS + 1, loader_fn=loader_fn)
    torch.cuda.synchronize()
    snapshots.append({n: f.launches for n, f in counters.items()})
    split_step = {n: snapshots[1][n] - snapshots[0][n] for n in snapshots[0]}
    launches = {n: f.launches for n, f in counters.items()}
    meta = json.loads((Path(directory) /
                       f'{TRAIN_STEPS + 1:08d}.json').read_text())
    with np.load(Path(directory) / f'{TRAIN_STEPS + 1:08d}.npz') as saved:
        count = int(saved['opt_state.count'])
    loss = losses[TRAIN_STEPS] if len(losses) > TRAIN_STEPS else math.nan
    print(f'resumed from {last.name}: step {TRAIN_STEPS} at {TRAIN_B} x '
          f'{SPLIT_T}, loss {loss}, checkpoint step {meta["step"]}, Adam '
          f'count {count}', flush=True)
    if (meta['step'] != TRAIN_STEPS + 1 or count != TRAIN_STEPS + 1
            or len(losses) != TRAIN_STEPS + 1 or not math.isfinite(loss)):
        raise AssertionError('the resumed run did not continue from the '
                             'checkpoint')
    return resumed, launches, split_step


def check_step_launches(config, b4_steps, split_step):
    L = config.num_hidden_layers
    print(f'launches per step, whole-layer path (T={TRAIN_T}): '
          f'{b4_steps[1]}', flush=True)
    print(f'launches per step, per-layer path (T={SPLIT_T}): {split_step}',
          flush=True)
    for i, counts in enumerate(b4_steps):
        for name, per_layer in B4_PER_LAYER.items():
            want = L * per_layer
            # step 0's evaluation also runs the inference stack's qkv_proj
            ok = (counts[name] >= want if i == 0 and name == 'qkv_proj'
                  else counts[name] == want)
            if not ok:
                raise AssertionError(f'step {i} (T={TRAIN_T}): {name} '
                                     f'launched {counts[name]} times, not '
                                     f'{want}')
    for name, per_layer in SPLIT_PER_LAYER.items():
        if split_step[name] != L * per_layer:
            raise AssertionError(f'the T={SPLIT_T} step launched {name} '
                                 f'{split_step[name]} times, not '
                                 f'{L * per_layer}')


def card_against_cpu(port, model, config, dev):
    """One step's loss and gradients on the first 4 rows of the batch, on
    the card (the kernels) and with device='cpu' (the plain versions), from
    the same weights and seed: the Philox masks are the same, so the two
    agree to bf16 rounding. A second seed on the card shows how far apart
    other masks put them."""
    features, targets, lengths = (t[:4] for t in train_batch(
        config, TRAIN_B, TRAIN_T, SEED + 1, dev))
    cpu = port.train.core.init_model(config, 'cpu')
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})

    def loss_and_grads(net, device, seed):
        net.zero_grad(set_to_none=True)
        logits = net(features.to(device), lengths.to(device), train=True,
                     seed=seed)
        value = port.train.loss(logits, targets.to(device))
        value.backward()
        return value.item(), [p.grad.float().cpu() for p in net.parameters()]

    card_loss, card_grads = loss_and_grads(model, dev, 777)
    cpu_loss, cpu_grads = loss_and_grads(cpu, 'cpu', 777)
    _, other = loss_and_grads(model, dev, 778)

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    names = [name for name, _ in model.named_parameters()]
    errors = [rel(a, b) for a, b in zip(card_grads, cpu_grads)]
    same = max(errors)
    apart = statistics.median(rel(a, b) for a, b in zip(other, cpu_grads))
    print(f'one step on 4 rows, card against device=cpu (seed 777): loss '
          f'{card_loss:.6f} vs {cpu_loss:.6f}, per-tensor relative gradient '
          f'error median {statistics.median(errors):.3g}, worst {same:.3g} '
          f'({names[errors.index(same)]}; <= 5e-2); another seed on the '
          f'card: median {apart:.3g}', flush=True)
    if abs(card_loss - cpu_loss) > 1e-2 * abs(cpu_loss) or same > 5e-2:
        raise AssertionError('the card and the CPU disagree on a train step')
    model.zero_grad(set_to_none=True)


def record_name(name, inp, tag):
    """A train kernel's record name: with ``tag`` (the head-training
    slice's instances) its width, d_head for the attention kernels, C for
    the others."""
    base = 'qkv_proj_train' if name == 'qkv_proj' else name
    if not tag:
        return base
    if name.startswith('attention') or name == 'row_dot':
        return f'{base}_d{inp["C"] // inp["H"]}'
    return f'{base}_c{inp["C"]}'


@torch.no_grad()
def train_kernel_times(config, inp, err, launches, per_step, form_launches,
                       card, tag=False):
    """Each train kernel at the training shape: its time, its bound, the
    plain version's and a library call's, and the gemm forms' (one record
    each, named by ``record_name``; launches None leaves the records'
    launches for the caller to fill); returns (the JSON records, the gemm
    forms' ms summed)."""
    from ppgs_tpu_torch.ops import backward
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import encoder_layer_train as elt
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    bf16 = torch.bfloat16
    C, H, B, T, M = (inp[k] for k in 'CHBTM')
    D, Fh = C // H, config.ffn_channels
    drop, mask = inp['drop'], inp['mask']
    q, k, v, do = inp['q'], inp['k'], inp['v'], inp['do']
    do16 = do.to(bf16)
    r, r16 = inp['r'], inp['r'].to(bf16)
    layer_drops = (drop.at(drop.site + 2), drop.at(drop.site + 3))
    # query rows x valid keys, summed over windows and heads
    pairs = H * T * inp['lengths'].double().sum().item()

    def heads(t):
        return t.view(B, T, H, D).transpose(1, 2)

    sdpa_mask = mask[:, None, None, :]
    att = (q, k, v, mask, H, inp['sl'], False, drop)
    bwd = (q, k, v, mask, inp['lse'], inp['keep'], do16, inp['d_row'], H,
           inp['sl'], inp['sm'], False, drop)
    qs, ks, vs = (heads(t).detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():       # the library calls' backward graphs
        sdpa_out = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=sdpa_mask, dropout_p=DROPOUT)
    ffn = (r, inp['w1'], inp['ffn_b1'], inp['w2'], inp['ffn_b2'],
           *layer_drops, (inp['g2'], inp['be2']))
    ffn_bwd = (r, inp['masked'], inp['w1'], inp['ffn_b1'], inp['w2'],
               layer_drops[0], inp['hkeep'], inp['dz'])
    w1t, w2t = inp['w1'].T, inp['w2'].T
    rl = r16.view(M, C).detach().requires_grad_()

    def ffn_chain():
        h = F.dropout(F.relu(F.linear(rl, w1t, inp['ffn_b1'].to(bf16))),
                      DROPOUT)
        y = F.dropout(F.linear(h, w2t, inp['ffn_b2'].to(bf16)), DROPOUT)
        return F.layer_norm(rl.float() + y.float(), (C,), inp['g2'],
                            inp['be2'])

    with torch.enable_grad():
        chain_out = ffn_chain()
    chain_cot = torch.randn_like(chain_out)
    ln_args = (inp['g'], inp['n'], inp['rstd'], inp['g1'],
               drop.at(drop.site + 1), bf16)
    zero_mean = torch.zeros(M, 1, device=r.device)
    d32 = inp['d32'].view(M, 3 * C)
    dh = inp['dh']
    wqkv, bqkv = inp['wqkv'], inp['bqkv']
    runs = {
        'qkv_proj': (
            lambda: elk.qkv_proj(inp['x'], wqkv, bqkv),
            lambda: elk.qkv_proj_reference(inp['x'], wqkv, bqkv),
            lambda: torch.addmm(bqkv.to(bf16), inp['x'].view(M, C).to(bf16),
                                wqkv),
            (2 * M * C * 3 * C,
             M * C * 4 + C * 3 * C * 2 + 3 * C * 4 + M * 3 * C * 2),
            'qkv_proj.cu', 'ppgs_tpu/ops/encoder_layer_train.py:471'),
        'attention_train_fwd': (
            lambda: fa.attention_train_fwd(*att, want_f32=True),
            lambda: fa.attention_train_fwd_reference(*att, want_f32=True),
            lambda: F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v), attn_mask=sdpa_mask,
                dropout_p=DROPOUT),
            # q, k, v and the mask in; o in bf16 and fp32, lse and the keep
            # words out
            (4 * pairs * D,
             3 * M * C * 2 + M + M * C * 6 + M * H * 4
             + 4 * math.prod(fa.keep_words_shape(B, H, T))),
            'attention_train.cu', 'ppgs_tpu/ops/flash_attention.py:576'),
        'row_dot': (
            lambda: fa.row_dot(do, inp['a32'], H),
            lambda: fa.row_dot_reference(do, inp['a32'], H),
            lambda: torch.linalg.vecdot(do.view(B, T, H, D),
                                        inp['a32'].view(B, T, H, D)),
            (2 * M * C, 2 * M * C * 4 + M * H * 4),
            'attention_train.cu', 'ppgs_tpu/ops/flash_attention.py:625'),
        'attention_train_bwd': (
            lambda: fa.attention_train_bwd(*bwd, want32=True),
            lambda: fa.attention_train_bwd_reference(*bwd, want32=True),
            lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), heads(do16),
                                        retain_graph=True),
            (10 * pairs * D,
             4 * M * C * 2 + 2 * M * H * 4 + M + M * 3 * C * 6),
            'attention_train_bwd.cu', 'ppgs_tpu/ops/flash_attention.py:625'),
        'out_proj_ln_train': (
            lambda: elt.out_proj_ln_train(
                inp['a16'], inp['wo'], inp['bo'], inp['x'], inp['g1'],
                inp['be1'], drop.at(drop.site + 1)),
            lambda: elt.out_proj_ln_train_reference(
                inp['a16'], inp['wo'], inp['bo'], inp['x'], inp['g1'],
                inp['be1'], drop.at(drop.site + 1)),
            # addmm + dropout + layer_norm (it keeps no statistics)
            lambda: F.layer_norm(
                inp['x'] + F.dropout(torch.addmm(
                    inp['bo'].to(bf16), inp['a16'].view(M, C), inp['wo']),
                    DROPOUT).view(B, T, C), (C,), inp['g1'], inp['be1']),
            (2 * M * C * C,
             M * C * 2 + M * C * 4 + C * C * 2 + 3 * C * 4 + 2 * M * C * 4
             + M * 4),
            'out_proj_ln.cu', 'ppgs_tpu/ops/encoder_layer_train.py:471'),
        'ln_dropout_bwd': (
            lambda: backward.ln_dropout_bwd(*ln_args),
            lambda: backward.ln_dropout_bwd_reference(*ln_args),
            lambda: torch.ops.aten.native_layer_norm_backward(
                inp['g'].view(M, C), inp['n'].view(M, C)
                / inp['rstd'].view(M, 1), [C], zero_mean,
                inp['rstd'].view(M, 1),
                inp['g1'], inp['be1'], [True, True, True]),
            (8 * M * C,
             3 * M * C * 4 + M * 4 + C * 4 + M * C * 2
             + (M // 64) * 3 * C * 4),
            'layer_train.cu', 'ppgs_tpu/ops/encoder_layer_train.py:531'),
        'colsum': (
            lambda: backward.colsum(d32),
            lambda: backward.colsum_reference(d32),
            lambda: d32.sum(dim=0),
            (M * 3 * C, M * 3 * C * 4 + 3 * C * 4),
            'layer_train.cu', 'ppgs_tpu/ops/encoder_layer_train.py:531'),
        'ffn_train_fwd': (
            lambda: fused_ffn.ffn_train_fwd(*ffn),
            lambda: fused_ffn.ffn_train_fwd_reference(*ffn),
            ffn_chain,
            (4 * M * C * Fh,
             M * C * 4 + 2 * C * Fh * 2 + (Fh + 3 * C) * 4 + 2 * M * C * 4
             + M * 4),
            'ffn_ln.cu', 'ppgs_tpu/ops/fused_ffn.py:256'),
        'ffn_train_bwd': (
            lambda: fused_ffn.ffn_train_bwd(*ffn_bwd),
            lambda: fused_ffn.ffn_train_bwd_reference(*ffn_bwd),
            lambda: torch.autograd.grad(chain_out, rl, chain_cot,
                                        retain_graph=True),
            # x, dy, the residual, the weights, b1 and the keep words in;
            # dx, hd, dh and the db1 partial rows out
            (6 * M * C * Fh,
             M * C * 4 + M * C * 2 + M * C * 4 + 2 * C * Fh * 2 + Fh * 4
             + M * Fh // 8 + M * C * 4 + 2 * M * Fh * 2
             + -(-M // 64) * Fh * 4),
            'ffn_train.cu', 'ppgs_tpu/ops/fused_ffn.py:294'),
    }
    records = []
    for name, (kernel_fn, plain_fn, library_fn, work, src, replaces) in \
            runs.items():
        ms, plain_ms = (time_ms(kernel_fn, TRAIN_REPS, 2),
                        time_ms(plain_fn, TRAIN_REPS, 2))
        library_ms = (time_ms(library_fn, TRAIN_REPS, 2) if library_fn
                      else None)
        bound_ms, bound_by = bound(*work)
        lib = f'{library_ms:.4f} ms' if library_ms is not None else 'none'
        print(f'{name}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms '
              f'({bound_by}), plain {plain_ms:.4f} ms, library {lib}, '
              f'{per_step[name]} launches per step at T={TRAIN_T} '
              f'[{card}]', flush=True)
        records.append({
            'name': record_name(name, inp, tag),
            'route': 'cuda',
            'source': f'ppgs_tpu_torch/kernels/csrc/{src}',
            'replaces': replaces,
            'launches': None if launches is None else launches[name],
            'max_abs_err': err[name], 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': library_ms})
    device_times('K4 ffn_train_fwd (B4\'s form: fp32 x, the LayerNorm)',
                 records[list(runs).index('ffn_train_fwd')],
                 runs['ffn_train_fwd'][0], 'its library route', card)
    k4_y_out_times(inp, layer_drops, card)
    device_times('ffn_train_bwd', records[list(runs).index('ffn_train_bwd')],
                 runs['ffn_train_bwd'][0], 'its library route', card)
    device_times(f'K1 qkv_proj (train, {M} rows)', records[0],
                 runs['qkv_proj'][0], 'cast + addmm', card)
    device_times('K3 out_proj_ln_train',
                 records[list(runs).index('out_proj_ln_train')],
                 runs['out_proj_ln_train'][0], 'its library route', card)
    device_times('attention_train_fwd',
                 records[list(runs).index('attention_train_fwd')],
                 runs['attention_train_fwd'][0], 'SDPA with dropout', card)
    keep_bits_probe('attention_train_fwd',
                    lambda *a: fa.attention_train_fwd(*a, want_f32=True), att,
                    card)
    attention_bwd_times(records[list(runs).index('attention_train_bwd')],
                        bwd, card)
    device_times(f'colsum dbqkv ({M} x {3 * C})',
                 records[list(runs).index('colsum')], runs['colsum'][0],
                 'd32.sum(0)', card)
    colsum_step_times(config, inp['colsum'], card)
    gemm_records = gemm_form_times(inp, err, form_launches, card, tag)
    return records + gemm_records, sum(r['ms'] for r in gemm_records)


def k4_y_out_times(inp, drops, card):
    """K4's other train form at the training shape, ffn_train's (B6: bf16
    x and output, no LayerNorm): CUDA-event and device time by launch,
    beside its bound and its library route (addmm, ReLU, dropout, addmm,
    dropout in bf16)."""
    from ppgs_tpu_torch.ops import fused_ffn

    bf16 = torch.bfloat16
    C, M = inp['C'], inp['M']
    Fh = inp['w1'].shape[1]
    x16 = inp['r'].to(bf16)
    args = (x16, inp['w1'], inp['ffn_b1'], inp['w2'], inp['ffn_b2'], *drops)
    w1t, w2t = inp['w1'].T, inp['w2'].T
    b1, b2 = inp['ffn_b1'].to(bf16), inp['ffn_b2'].to(bf16)

    def library():
        h = F.dropout(F.relu(F.linear(x16, w1t, b1)), DROPOUT)
        return F.dropout(F.linear(h, w2t, b2), DROPOUT)

    ms = time_ms(lambda: fused_ffn.ffn_train_fwd(*args), TRAIN_REPS, 2)
    library_ms = time_ms(library, TRAIN_REPS, 2)
    # x in, the weights and biases, y and the hidden's keep words out
    bound_ms, bound_by = bound(
        4 * M * C * Fh, 2 * M * C * 2 + 2 * C * Fh * 2 + (Fh + C) * 4
        + M * Fh // 8)
    device = kernel_device_ms('K4 ffn_train_fwd (B6\'s form: bf16 x and y)',
                              lambda: fused_ffn.ffn_train_fwd(*args), card)
    dev = 'not measured' if device is None else f'{device:.4f} ms'
    print(f'K4 ffn_train_fwd (B6\'s form) C={C}: event {ms:.4f} ms, device '
          f'{dev}, bound {bound_ms:.4f} ms ({bound_by}), library route '
          f'{library_ms:.4f} ms: {ms / library_ms:.2f}x [{card}]', flush=True)


def attention_bwd_times(record, bwd, card):
    """attention_train_bwd at the training shape: its device time per
    launch by pass (dq, dk/dv) beside its event time and SDPA's backward,
    then ``keep_bits_probe``."""
    from ppgs_tpu_torch.ops import flash_attention as fa

    def run(*args):
        return fa.attention_train_bwd(*args, want32=True)

    device_times('attention_train_bwd (dq and dk/dv passes)', record,
                 lambda: run(*bwd), 'SDPA backward', card)
    keep_bits_probe('attention_train_bwd', run, bwd, card)


def keep_bits_probe(name, fn, args, card):
    """``fn`` (the kernel ``name``) on ``args`` (its arguments, the dropout
    last) as given and with the dropout off (threshold 0), in turns (on,
    off, off, on): CUDA-event medians and the profiler's device time per
    launch by kernel. The gap is what the dropout costs the kernel: drawing
    the keep bits and writing their words (the forward), or reading them
    (the backward). Prints and returns them."""
    from ppgs_tpu_torch.ops import dropout

    drop = args[-1]
    runs = {'on': args,
            'off': args[:-1] + (dropout.Drop(drop.seed, drop.site, 0.0),)}

    def run(key):
        return lambda: fn(*runs[key])

    event = {'on': [], 'off': []}
    for key in ('on', 'off', 'off', 'on'):
        event[key].append(time_ms(run(key), TRAIN_REPS, 2))
    device = {key: kernel_device_ms(
        f'{name}, dropout {drop.rate if key == "on" else 0}', run(key), card)
        for key in runs}
    gap = statistics.mean(event['on']) - statistics.mean(event['off'])
    print(f'{name} keep bits: event {event["on"]} ms at dropout '
          f'{drop.rate}, {event["off"]} ms off: {gap:.4f} ms; device '
          f'{device["on"]} / {device["off"]} ms [{card}]', flush=True)
    return {'event_ms': event, 'device_ms': device, 'keep_bits_ms': gap}


def gemm_form_times(inp, err, form_launches, card, tag=False):
    """Each gemm form at the training shape: the kernel's time, its
    bound, its plain version's and torch.matmul's on the same bf16
    operands (a weight gradient's split partials with the step's split;
    the library call is one product); returns the JSON records (named
    with C where ``tag``; form_launches None leaves their launches for
    the caller to fill)."""
    from ppgs_tpu_torch.ops import backward

    bf16, records = torch.bfloat16, []
    for name, (a, b, kw) in gemm_forms(inp, inp['M']).items():
        a16 = a.to(bf16)
        if kw is None:
            M, K, N = a.shape[1], a.shape[0], b.shape[1]
            library_fn = (lambda a16=a16, b=b: torch.matmul(a16.T, b))
            out_bytes = M * N * 4
        else:
            (M, K), N = a.shape, b.shape[0]
            library_fn = (lambda a16=a16, b=b: torch.matmul(a16, b.T))
            out_bytes = M * N * (4 + 2 * ('want16' in kw)
                                 + 4 * ('residual' in kw))
        kernel_fn, plain_fn = (
            lambda fn=fn, a=a, b=b, kw=kw: run_gemm_form(fn, a, b, kw)
            for fn in (backward.gemm, backward.gemm_reference))
        ms, plain_ms = (time_ms(kernel_fn, TRAIN_REPS, 2),
                        time_ms(plain_fn, TRAIN_REPS, 2))
        library_ms = time_ms(library_fn, TRAIN_REPS, 2)
        bound_ms, bound_by = bound(
            2 * M * N * K,
            a.numel() * a.element_size() + b.numel() * 2 + out_bytes)
        runs = ('' if form_launches is None else
                f'{form_launches[name]} launches in the train() runs ')
        print(f'gemm {name} ({M} x {N}, depth {K}): kernel {ms:.4f} ms, '
              f'bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} '
              f'ms, torch.matmul {library_ms:.4f} ms, {runs}[{card}]',
              flush=True)
        records.append({
            'name': f'gemm {name}' + (f' c{inp["C"]}' if tag else ''),
            'route': 'cuda',
            'source': 'ppgs_tpu_torch/kernels/csrc/gemm.cu',
            'replaces': 'ppgs_tpu/ops/encoder_layer_train.py:531',
            'launches': (None if form_launches is None
                         else form_launches[name]),
            'max_abs_err': err[f'gemm {name}'], 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': library_ms})
    return records


def gemm_form_launches(inp, forms, any_rows=False):
    """Launches of each gemm form in ``forms`` (``gemm.forms`` after the
    train() runs), on either path's rows (with ``any_rows``, on any rows:
    the batches of a data loader) and with either type of a (the
    per-layer path's FFN hands dW1 a bf16 a)."""
    from ppgs_tpu_torch.ops import backward

    launches = {}
    for name, (a, b, kw) in gemm_forms(inp, inp['M']).items():
        launches[name] = 0
        if kw is None:
            want = backward.gemm_form(1, a.dtype, a.shape[1], b.shape[1], 0)
        else:
            want = backward.gemm_form(0, a.dtype, 0, b.shape[0], a.shape[1])
        for key, count in forms.items():
            # the fields of a form but its a's type and its rows (M of a
            # data gradient, the depth K of a weight gradient)
            rows = key[2] if kw is not None else key[4]
            same = (key[0] == want[0] and
                    (key[3:] if kw is not None else key[2:4])
                    == (want[3:] if kw is not None else want[2:4]))
            if same and (any_rows or rows in (inp['M'],
                                              TRAIN_B * SPLIT_T)):
                launches[name] += count
    return launches


def b4_times(config, layer, H, x, mask, lengths, cot, card, plain=True):
    """B4 as a whole, forward and backward, on x (B, T, C) with its
    windows (``mask``, ``lengths``) and the output's cotangent ``cot``:
    the kernels, the plain version (with ``plain``) and
    nn.TransformerEncoderLayer(C, H, F) in train mode in bf16 (the library
    yardstick; the port never calls it), beside the layer's bound: three
    times the forward's products (the forward and the two gradients' of
    each) and 14 operations a valid (query, key) pair and column, six fp32
    tensors of x's size moved."""
    from ppgs_tpu_torch.ops import encoder_layer_train as elt

    bf16 = torch.bfloat16
    B, T, C = x.shape
    D, Fh, M = C // H, config.ffn_channels, B * T
    x = x.detach().clone().requires_grad_()
    params = list(layer.parameters())
    pairs = H * T * lengths.double().sum().item()
    matmul = 2 * M * C * (3 * C + C + 2 * Fh)
    b4_bound = bound(3 * matmul + 14 * pairs * D, 6 * M * C * 4)

    def b4(fn):
        out = fn(x, mask, layer, H, DROPOUT, seed=5)
        return torch.autograd.grad(out, [x] + params, cot)

    torch_layer = torch.nn.TransformerEncoderLayer(
        C, H, Fh, dropout=DROPOUT, batch_first=True).to(x.device).to(
            bf16).train()
    xl = x.detach().to(bf16).requires_grad_()
    pad = ~mask

    def library_b4():
        out = torch_layer(xl, src_key_padding_mask=pad)
        return torch.autograd.grad(out, [xl, *torch_layer.parameters()],
                                   cot.to(bf16))

    fns = {'kernels': lambda: b4(elt.encoder_layer_train),
           'plain': lambda: b4(elt.encoder_layer_train_reference),
           'library': library_b4}
    if not plain:
        del fns['plain']
    times = {name: time_ms(fn, TRAIN_REPS, 2) for name, fn in fns.items()}
    plain_part = f'plain {times["plain"]:.4f} ms, ' if plain else ''
    print(f'B4 encoder_layer_train forward + backward at (C, d_head) = '
          f'({C}, {D}) ({B} x {T}): kernels {times["kernels"]:.4f} ms, bound '
          f'{b4_bound[0]:.4f} ms ({b4_bound[1]}), {plain_part}library '
          f'{times["library"]:.4f} ms (nn.TransformerEncoderLayer({C}, {H}, '
          f'{Fh}), train) [{card}]', flush=True)


def composite_times(port, config, layer, inp, dev, gen, card):
    """B4, B5 and B6 as wholes, forward and backward: the kernels, the plain
    versions and a library yardstick (nn.TransformerEncoderLayer in train
    mode, scaled_dot_product_attention with dropout, an autograd
    addmm/relu/dropout chain); the port never calls the library."""
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    bf16 = torch.bfloat16
    C, H, B, T = (inp[k] for k in 'CHBT')
    D, Fh = C // H, config.ffn_channels
    cot = torch.randn(B, T, C, generator=gen, device=dev)
    b4_times(config, layer, H, inp['x'], inp['mask'], inp['lengths'], cot,
             card)

    T5 = SPLIT_T
    mask5 = torch.ones(B, T5, dtype=torch.bool, device=dev)
    qkv = (torch.randn(B, T5, 3 * C, generator=gen, device=dev).to(bf16)
           .requires_grad_())
    do = torch.randn(B, T5, C, generator=gen, device=dev).to(bf16)

    def b5(fn):
        o = fn(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], mask5, H,
               DROPOUT, seed=6)
        return torch.autograd.grad(o, qkv, do)

    def library_b5():
        q4, k4, v4 = (t.view(B, T5, H, D).transpose(1, 2)
                      for t in qkv.split(C, dim=-1))
        o = F.scaled_dot_product_attention(q4, k4, v4, dropout_p=DROPOUT)
        return torch.autograd.grad(o, qkv, do.view(B, T5, H, D)
                                   .transpose(1, 2))

    pairs5 = H * B * T5 * T5
    b5_bound = bound(14 * pairs5 * D, 3 * B * T5 * C * 2 * 2
                     + 2 * B * T5 * C * 2)
    times = [time_ms(fn, TRAIN_REPS, 2) for fn in (
        lambda: b5(fa.flash_attention_train),
        lambda: b5(fa.flash_attention_train_reference), library_b5)]
    print(f'B5 flash_attention_train forward + backward ({B} x {T5}): '
          f'kernels {times[0]:.4f} ms, bound {b5_bound[0]:.4f} ms '
          f'({b5_bound[1]}), plain {times[1]:.4f} ms, library '
          f'{times[2]:.4f} ms (scaled_dot_product_attention, dropout) '
          f'[{card}]', flush=True)
    del qkv

    M5 = B * T5
    ffn = layer.ffn
    leaves = [torch.randn(M5, C, generator=gen, device=dev).to(bf16)] + [
        t.detach().to(bf16) for t in (ffn.w1, ffn.b1, ffn.w2, ffn.b2)]
    leaves = [t.requires_grad_() for t in leaves]
    gy = torch.randn(M5, C, generator=gen, device=dev).to(bf16)

    def b6(fn):
        return torch.autograd.grad(fn(*leaves, DROPOUT, seed=6), leaves, gy)

    def library_b6():
        xx, w1, b1, w2, b2 = leaves
        h = F.dropout(torch.relu(torch.addmm(b1, xx, w1)), DROPOUT)
        y = F.dropout(torch.addmm(b2, h, w2), DROPOUT)
        return torch.autograd.grad(y, leaves, gy)

    b6_bound = bound(12 * M5 * C * Fh, 4 * M5 * C * 2 + 4 * C * Fh * 2)
    times = [time_ms(fn, TRAIN_REPS, 2) for fn in (
        lambda: b6(fused_ffn.ffn_train),
        lambda: b6(fused_ffn.ffn_train_reference), library_b6)]
    print(f'B6 ffn_train forward + backward (M = {M5}): kernels '
          f'{times[0]:.4f} ms, bound {b6_bound[0]:.4f} ms ({b6_bound[1]}), '
          f'plain {times[1]:.4f} ms, library {times[2]:.4f} ms '
          f'(addmm/relu/dropout chain) [{card}]', flush=True)


def step_metrics(port, model, config, dev, card, gemm_ms):
    """The train step end to end (CUDA-synchronised host clock, median of
    STEP_REPS after warm-up) on both paths, audio-seconds per second, and
    on each its peak device memory and a torch.profiler breakdown of one
    step (its idle share); the 256 x 512 step's gemm kernels' time beside
    ``gemm_ms`` (the forms timed alone, per step)."""
    optimizer = port.train.make_optimizer(model.parameters(), config)
    step = port.train.make_train_step(model, config, optimizer)
    frame_s = config.hopsize / config.sample_rate
    for T in (TRAIN_T, SPLIT_T):
        batch = train_batch(config, TRAIN_B, T, SEED + 1, dev)
        for i in range(2):
            step(*batch, seed=100 + i)
        times = []
        for i in range(STEP_REPS):
            torch.cuda.synchronize()
            start = time.perf_counter()
            step(*batch, seed=200 + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
        step_s = statistics.median(times)
        audio = TRAIN_B * T * frame_s
        print(f'train step {TRAIN_B} x {T}: {step_s * 1e3:.3f} ms (median of '
              f'{STEP_REPS}), {audio / step_s:.1f} audio-s/s '
              f'({audio:.2f} audio-s per step) [{card}]', flush=True)
    for T in (SPLIT_T, TRAIN_T):
        batch = train_batch(config, TRAIN_B, T, SEED + 1, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(*batch, seed=300)
        torch.cuda.synchronize()
        print(f'train step {TRAIN_B} x {T}: peak device memory '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB '
              f'(max_memory_allocated) [{card}]', flush=True)
        by_name = profile_call(f'train step {TRAIN_B} x {T}',
                               lambda: step(*batch, seed=301), card)
    profiled = sum(ms for name, ms in by_name.items()
                   if 'gemm_kernel<' in name)
    print(f'train step {TRAIN_B} x {TRAIN_T}: the gemm kernel {profiled:.3f} '
          f'ms profiled, the six forms timed alone {gemm_ms:.3f} ms per step '
          f'({config.num_hidden_layers} layers) [{card}]', flush=True)


def busy_ms(intervals):
    """The length of the union of (start, end) intervals, in their unit
    over 1e3: the time in which at least one of them ran."""
    total, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total / 1e3


def report_profile(label, prof, wall_ms, card):
    """Device time by kernel name from a torch.profiler run, and the share
    of the wall time in which the card ran no kernel: busy time is the
    union of the device events' intervals (events listed twice count once,
    events that overlap on other streams count once), and raises if it
    exceeds the wall time.

    Busy and wall time are read on one clock, the profiler's: the wall is
    the span of profile_call's host range (``PROFILE_WINDOW``), and the
    device events are clipped to it. The host's ``perf_counter`` wall
    (``wall_ms``) is printed beside it: it is another clock than the one
    the device timestamps are converted to, so a card busy through the
    whole call can show more busy time than that wall. The device time
    outside the range is printed."""
    window = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name == PROFILE_WINDOW
              and e.device_type != torch.autograd.DeviceType.CUDA]
    if len(window) != 1:
        raise AssertionError(f'{label}: {len(window)} host ranges named '
                             f'{PROFILE_WINDOW} in the trace, not 1')
    (lo, hi), = window
    events = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name != PROFILE_WINDOW
                and not getattr(e, 'is_user_annotation', False)):
            events[(e.name, e.thread, e.time_range.start,
                    e.time_range.end)] = e
    if not events:
        print(f'{label}: device time by kernel: not measured (the profiler '
              f'saw no device activity)')
        return {}
    by_name = {}
    for (name, _, start, end) in events:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    summed = sum(by_name.values())
    inside = [(max(start, lo), min(end, hi))
              for (_, _, start, end) in events if end > lo and start < hi]
    busy = busy_ms(inside)
    outside = summed - sum(end - start for start, end in inside) / 1e3
    span = (hi - lo) / 1e3
    streams = len({thread for (_, thread, _, _) in events})
    listed = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f'profiled {label}: wall {span:.3f} ms on the profiler\'s clock '
          f'({wall_ms:.3f} ms by the host\'s perf_counter), device busy '
          f'{busy:.3f} ms (union of {len(events)} device events on '
          f'{streams} streams, clipped to the call\'s host range; {listed} '
          f'listed; their durations sum to {summed:.3f} ms, '
          f'{outside:.3f} ms of it outside the range), idle share '
          f'{1 - busy / span:.4f} [{card}]')
    if busy > span:
        raise AssertionError(f'{label}: device busy time {busy:.3f} ms '
                             f'exceeds the wall time {span:.3f} ms')
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]:
        print(f'  {ms:9.3f} ms  {ms / summed:6.1%}  {name[:90]}')
    # Where the summed durations exceed the union: each event's span that
    # events which started before it already cover, by kernel name
    overlap, reach = {}, None
    for (name, _, start, end) in sorted(events, key=lambda k: k[2]):
        if reach is not None and start < reach:
            n, ms = overlap.get(name, (0, 0.0))
            overlap[name] = (n + 1, ms + (min(end, reach) - start) / 1e3)
        reach = end if reach is None else max(reach, end)
    for name, (n, ms) in sorted(overlap.items(), key=lambda kv: -kv[1][1])[:4]:
        print(f'  overlap {ms:9.3f} ms in {n} events started before the '
              f'previous ended: {name[:80]}')
    return by_name


# Kernel-name fragments of the port's own kernels and of the libraries'
KERNEL_GROUPS = (
    ('B8 rel_attention', ('rel_attention_kernel',)),
    ('K1-K4', ('qkv_proj_kernel', 'attention_kernel<', '::wide_kernel(',
               'out_proj_ln_kernel', 'ffn_fused_kernel', 'ffn_hidden_kernel',
               'ffn_out_kernel')),
    ('B10 conv stack', ('conv_stats_kernel', 'conv0_gelu_kernel',
                        'conv_gelu_kernel')),
    ('cuDNN convs and cuBLAS products', ('gemm', 'conv', 'xmma', 'cutlass')),
    ('PyTorch elementwise, copies and reductions', ('at::native',)),
)


def report_groups(label, by_name, card):
    """Device milliseconds of a profiled call by group of kernels
    (``KERNEL_GROUPS``, first match wins; the rest as 'other')."""
    groups = {}
    for name, ms in by_name.items():
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(key in name for key in keys)), 'other')
        groups[group] = groups.get(group, 0.0) + ms
    parts = ', '.join(f'{g} {ms:.3f} ms'
                      for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
    print(f'{label}, device time by group: {parts} [{card}]', flush=True)


# B9 (fused_mel.cu) at odd shapes before anything is timed: batches of 1-3,
# frames about its 128-frame tiles and ragged ones, hops that take ldmatrix
# (160, 320), 32-bit loads (100) and 64-frame blocks (640), silent audio
# (every mel at the 1e-5 clamp) and loud. The limits are those of the CPU
# test against the JAX kernel: atol 8e-3 (one bf16 flip of a magnitude
# moves its log-mel by at most 7.8e-3) and 99.9% of the values within 1e-4,
# the share pooled over a hop's cases (a case of one frame has 80 values)
B9_ODD_T = (1, 7, 127, 128, 129, 255, 803, 1000)
B9_ODD_HOPS = (160, 100, 320, 640)


def b9_close(name, got, want):
    """Raise unless every value is within 8e-3; return (max error, values
    within 1e-4, values)."""
    err = (got - want).abs()
    worst = err.max().item()
    if not torch.isfinite(got).all() or worst > 8e-3:
        raise AssertionError(f'{name}: max |kernel - plain| {worst:.3g} '
                             f'(atol 8e-3)')
    return worst, int((err <= 1e-4).sum().item()), err.numel()


def b9_share(name, worst, close, count):
    print(f'{name}: max |kernel - plain| {worst:.3g} (atol 8e-3), within '
          f'1e-4 {close / count:.6f} of {count} values (>= 0.999)',
          flush=True)
    if close < 0.999 * count:
        raise AssertionError(f'{name}: fewer than 99.9% of the values within '
                             f'1e-4 of the plain version')


@torch.no_grad()
def b9_odd_shape_checks(config, dev):
    from ppgs_tpu_torch.ops import stft

    gen = torch.Generator(device=dev).manual_seed(SEED + 37)
    geometry = (config.sample_rate, config.num_fft, config.window_size)
    for hop in B9_ODD_HOPS:
        taps = -(-config.num_fft // hop)
        Ts = B9_ODD_T if hop != 640 else (1, 129, 803)
        cases = [(1 + i % 3, T, 0.1) for i, T in enumerate(Ts)]
        cases += [(2, 129, 0.0), (3, 255, 30.0)]     # silent, loud
        worst, close, count = 0.0, 0, 0
        for B, T, scale in cases:
            blocks = scale * torch.randn(B, T + taps - 1, hop, generator=gen,
                                         device=dev)
            args = (T, *geometry, hop, config.num_mels)
            w, c, n = b9_close(f'B9 B={B} T={T} hop={hop} x{scale:g}',
                               stft.fused_log_mel(blocks, *args),
                               stft.fused_log_mel_reference(blocks, *args))
            worst, close, count = max(worst, w), close + c, count + n
        b9_share(f'B9 fused_log_mel, hop {hop}, {len(cases)} odd shapes '
                 f'(B 1-3, T {Ts[0]}..{Ts[-1]}, silent and loud)', worst,
                 close, count)
    # The other hops' bases leave the card (the train phases' peak memory
    # holds only the main path's)
    stft._fused_mel_weights.cache_clear()


def mel_phases(port, config, workdir, dev, gen, card):
    """Phases 3-5: the mel inference kernels against their plain versions,
    the main path, and the times; returns the kernels' JSON records."""
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn
    from ppgs_tpu_torch.ops import stft

    C, H = config.hidden_channels, config.attention_heads
    Fh, L = config.ffn_channels, config.num_hidden_layers
    frames = port.ops.stft.frame_count(
        SECONDS * config.sample_rate, config.num_fft, config.hopsize)
    stride, n_blocks = port.models.transformer.chunk_layout(
        frames, config.chunk_length, config.chunk_overlap)
    W, T = BATCH * n_blocks, config.chunk_length    # 128 windows x 500
    M = W * T

    checkpoint = Path(workdir) / 'random-mel.npz'
    port.load.save_params(checkpoint, random_params(port, config, SEED))
    model, _ = port.load.model(checkpoint=checkpoint, config=config,
                               device=dev)
    # Layer 0's weights as encoder_stack hands them to the kernels: the
    # prepared ones of convert.prepare and the fp32 parameter vectors
    layer0 = model.layers[0]
    p0 = layer0.prepared
    w = {'wqkv': p0.wqkv_folded, 'bqkv': p0.bqkv_folded, 'wo': p0.wo,
         'bo': layer0.attn.bo, 'g1': layer0.norm1.scale,
         'be1': layer0.norm1.bias, 'w1': p0.w1, 'b1': layer0.ffn.b1,
         'w2': p0.w2, 'b2': layer0.ffn.b2, 'g2': layer0.norm2.scale,
         'be2': layer0.norm2.bias}

    phase(f'3 kernels against their plain versions ({W} windows x T={T})')
    k1_odd_shape_checks('mel', w['wqkv'], w['bqkv'], dev)
    k3_odd_shape_checks((C,), 0, dev)
    k4_odd_shape_checks('ln', C, 'relu', Fh, dev)
    k2_odd_shape_checks(C // H, H, dev)
    x = torch.randn(W, T, C, generator=gen, device=dev)
    # The main path's window lengths: 500 and 450 valid frames
    win_len = torch.tensor([min(T, frames + config.chunk_overlap - i * stride)
                            for i in range(n_blocks)], device=dev)
    lengths = win_len.repeat(BATCH)
    mask = port.ops.masking.mask_from_lengths(lengths, T)
    qkv = elk.qkv_proj(x, w['wqkv'], w['bqkv'])
    err = {'qkv_proj': check('K1 qkv_proj', qkv, elk.qkv_proj_reference(
        x, w['wqkv'], w['bqkv']), atol=1e-2, rtol=1e-2)}
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    a = fa.attention(q, k, v, mask, H, 1.0)
    # K2's limit: about 1.3x the worst error seen on these seeded inputs,
    # a tenth of the typical output, so that a dropped key tile or a wrong
    # rescale cannot pass
    err['attention'] = check('K2 attention', a, fa.attention_reference(
        q, k, v, mask, H, 1.0), atol=5e-3)
    r = elk.out_proj_residual_ln(a, w['wo'], w['bo'], x, w['g1'], w['be1'])
    err['out_proj_residual_ln'] = check(
        'K3 out_proj_residual_ln', r, elk.out_proj_residual_ln_reference(
            a, w['wo'], w['bo'], x, w['g1'], w['be1']), atol=1e-3)
    ffn_args = (w['w1'], w['b1'], w['w2'], w['b2'], w['g2'], w['be2'])
    y = fused_ffn.ffn_residual_ln(r, *ffn_args)
    err['ffn_residual_ln'] = check(
        'K4 ffn_residual_ln', y,
        fused_ffn.ffn_residual_ln_reference(r, *ffn_args), atol=1e-2)
    check('K4 ffn_residual_ln (round_input, per-layer path)',
          fused_ffn.ffn_residual_layernorm(r[:3], *ffn_args),
          fused_ffn.ffn_residual_layernorm_reference(r[:3], *ffn_args),
          atol=1e-2)

    # The long-input attention: 4 windows of T = 1536, ragged lengths and
    # one wholly masked window, with and without the causal mask
    long_len = torch.tensor([LONG_T, 1000, 37, 0], device=dev)
    long_mask = port.ops.masking.mask_from_lengths(long_len, LONG_T)
    lq, lk, lv = (torch.randn(4, LONG_T, C, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3))
    for causal in (False, True):
        out = fa.flash_attention(lq, lk, lv, long_mask, H, causal=causal)
        check(f'K2 attention T={LONG_T} causal={causal}', out,
              fa.flash_attention_reference(lq, lk, lv, long_mask, H,
                                           causal=causal),
              atol=5e-3)
        if not torch.equal(out[3], torch.zeros_like(out[3])):
            raise AssertionError('a wholly masked window did not give 0')
    print('K2: the wholly masked window gives exactly 0', flush=True)

    stack_mask = mask.clone()
    stack_mask[-1] = False                        # one wholly masked window
    got = elk.encoder_stack(x, stack_mask, model.layers, H)
    want = elk.encoder_stack_reference(x, stack_mask, model.layers, H)
    check(f'encoder_stack ({L} layers)', got, want, atol=8e-2,
          rows=stack_mask)
    if not torch.isfinite(got).all():
        raise AssertionError('encoder_stack: non-finite values')
    del got, want

    # B9, the fused log-mel of the bf16 opt-in, at 64 x 8 s of its own
    # seeded audio (the main path's draws stay as they were). Its limit: a
    # bf16 rounding flip of a magnitude (sums in another order) moves it by
    # one bf16 ulp, 2^-8 to 2^-7 of it, so a mel value (a sum of positive
    # terms) by at most 2^-7 of itself and its log by at most 7.8e-3
    mel_gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    samples = SECONDS * config.sample_rate
    mel_audio = 0.1 * torch.randn(BATCH, 1, samples, generator=mel_gen,
                                  device=dev)
    blocks, Tm = stft._audio_to_blocks(mel_audio, config.num_fft,
                                       config.hopsize)
    blocks = blocks.contiguous()
    mel_args = (Tm, config.sample_rate, config.num_fft, config.window_size,
                config.hopsize, config.num_mels)
    b9_odd_shape_checks(config, dev)
    worst, close, count = b9_close(
        'B9', stft.fused_log_mel(blocks, *mel_args),
        stft.fused_log_mel_reference(blocks, *mel_args))
    b9_share(f'B9 fused_log_mel ({BATCH} x {Tm} frames)', worst, close, count)
    err['fused_log_mel'] = worst
    del mel_audio

    phase(f'4 from_audio: {BATCH} x {SECONDS} s (main path)')
    samples = SECONDS * config.sample_rate
    audio = 0.1 * torch.randn(BATCH, 1, samples, generator=gen, device=dev)
    counters = {'qkv_proj': elk.qkv_proj, 'attention': fa.attention,
                'out_proj_residual_ln': elk.out_proj_residual_ln,
                'ffn_residual_ln': fused_ffn.ffn_residual_ln}
    for fn in counters.values():
        fn.launches = 0
    ppg = port.from_audio(audio, checkpoint=checkpoint)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f'launches in one from_audio call: {launches}', flush=True)
    if min(launches.values()) == 0:
        raise AssertionError(f'a kernel of the main path never launched: '
                             f'{launches}')
    check_ppg('from_audio', ppg, audio,
              (BATCH, config.output_channels, frames))

    agree('from_audio rows 0-3 against device=cpu', ppg[:4],
          port.from_audio(audio[:4].cpu(), checkpoint=checkpoint,
                          device='cpu'))

    phase(f'4b from_audio legacy_mode: 1 x {LEGACY_SECONDS} s (T > 1024)')
    long_audio = 0.1 * torch.randn(1, 1, LEGACY_SECONDS * config.sample_rate,
                                   generator=gen, device=dev)
    for fn in counters.values():
        fn.launches = 0
    legacy = port.from_audio(long_audio, checkpoint=checkpoint,
                             legacy_mode=True)
    torch.cuda.synchronize()
    legacy_launches = {name: fn.launches for name, fn in counters.items()}
    print(f'launches in one legacy_mode call: {legacy_launches}', flush=True)
    if not (legacy_launches['attention'] and
            legacy_launches['ffn_residual_ln']):
        raise AssertionError('legacy_mode did not run the K2 and K4 kernels')
    agree('from_audio legacy_mode against device=cpu', legacy,
          port.from_audio(long_audio.cpu(), checkpoint=checkpoint,
                          device='cpu', legacy_mode=True))

    phase(f'4c from_audio with PPGS_TPU_FUSED_MEL=1: {BATCH} x {SECONDS} s')
    fused_counters = {**counters, 'fused_log_mel': stft.fused_log_mel}
    os.environ['PPGS_TPU_FUSED_MEL'] = '1'
    try:
        set_counts(fused_counters)
        fused_ppg = port.from_audio(audio, checkpoint=checkpoint)
        fused_launches, _ = read_counts(fused_counters)
    finally:
        del os.environ['PPGS_TPU_FUSED_MEL']
    print(f'launches with PPGS_TPU_FUSED_MEL=1: {fused_launches}', flush=True)
    if fused_launches != {**launches, 'fused_log_mel': 1}:
        raise AssertionError('the fused-mel opt-in did not launch B9 once and '
                             'K1-K4 as the default path')
    opt_in_against_default('PPGS_TPU_FUSED_MEL=1', fused_ppg, ppg, port.from_audio(
        audio, checkpoint=checkpoint,
        config=config.replace(compute_dtype='float32')), card)
    del fused_ppg

    phase(f'5 times on {card} (median of {REPS}, CUDA events)')
    bf16 = torch.bfloat16
    b_qkv = w['bqkv'].to(bf16)
    attn_pairs = mask.sum(dim=1).double().sum().item() * T  # query x key
    work = {
        'qkv_proj': (2 * M * C * 3 * C,
                     M * C * 4 + C * 3 * C * 2 + 3 * C * 4 + M * 3 * C * 2),
        'attention': (4 * attn_pairs * C, M * 3 * C * 2 + M + M * C * 2),
        'out_proj_residual_ln': (2 * M * C * C,
                                 M * C * 2 + 2 * M * C * 4 + C * C * 2
                                 + 3 * C * 4),
        'ffn_residual_ln': (4 * M * C * Fh,
                            2 * M * C * 4 + 2 * C * Fh * 2 + (Fh + 3 * C) * 4),
    }
    q4, k4, v4 = (t.view(W, T, H, C // H).transpose(1, 2) for t in (q, k, v))
    sdpa_mask = mask[:, None, None, :]
    runs = {
        'qkv_proj': (
            lambda: elk.qkv_proj(x, w['wqkv'], w['bqkv']),
            lambda: elk.qkv_proj_reference(x, w['wqkv'], w['bqkv']),
            lambda: torch.addmm(b_qkv, x.view(M, C).to(bf16), w['wqkv'])),
        'attention': (
            lambda: fa.attention(q, k, v, mask, H, 1.0),
            lambda: fa.attention_reference(q, k, v, mask, H, 1.0),
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=sdpa_mask, scale=math.log(2))),
        'out_proj_residual_ln': (
            lambda: elk.out_proj_residual_ln(a, w['wo'], w['bo'], x,
                                             w['g1'], w['be1']),
            lambda: elk.out_proj_residual_ln_reference(
                a, w['wo'], w['bo'], x, w['g1'], w['be1']),
            lambda: F.layer_norm(
                x + torch.addmm(w['bo'].to(bf16), a.view(M, C), w['wo'])
                .view(W, T, C), (C,), w['g1'], w['be1'])),
        'ffn_residual_ln': (
            lambda: fused_ffn.ffn_residual_ln(r, *ffn_args),
            lambda: fused_ffn.ffn_residual_ln_reference(r, *ffn_args),
            lambda: F.layer_norm(
                r + torch.addmm(
                    w['b2'].to(bf16),
                    torch.relu(torch.addmm(w['b1'].to(bf16),
                                           r.view(M, C).to(bf16), w['w1'])),
                    w['w2']).view(W, T, C), (C,), w['g2'], w['be2'])),
    }
    sources = {'qkv_proj': 'qkv_proj.cu', 'attention': 'attention.cu',
               'out_proj_residual_ln': 'out_proj_ln.cu',
               'ffn_residual_ln': 'ffn_ln.cu'}
    replaces = {
        'qkv_proj': 'ppgs_tpu/ops/encoder_layer_kernel.py:152',
        'attention': 'ppgs_tpu/ops/flash_attention.py:43',
        'out_proj_residual_ln': 'ppgs_tpu/ops/encoder_layer_kernel.py:152',
        'ffn_residual_ln': 'ppgs_tpu/ops/fused_ffn.py:33',
    }
    records = []
    for name, (kernel_fn, plain_fn, library_fn) in runs.items():
        ms, plain_ms, library_ms = (time_ms(kernel_fn), time_ms(plain_fn),
                                    time_ms(library_fn))
        bound_ms, bound_by = bound(*work[name])
        print(f'{name}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms '
              f'({bound_by}), plain {plain_ms:.4f} ms, library '
              f'{library_ms:.4f} ms, {launches[name]} launches per main-path '
              f'call [{card}]', flush=True)
        records.append({
            'name': name, 'route': 'cuda',
            'source': f'ppgs_tpu_torch/kernels/csrc/{sources[name]}',
            'replaces': replaces[name], 'launches': launches[name],
            'max_abs_err': err[name], 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': library_ms})

    kernel_device_ms('K4 ffn_residual_ln', runs['ffn_residual_ln'][0], card)
    by_name = {r['name']: r for r in records}
    device_times(f'K3 out_proj_residual_ln C = {C}',
                 by_name['out_proj_residual_ln'],
                 runs['out_proj_residual_ln'][0], 'addmm + layer_norm', card)
    device_times(f'K2 attention d_head {C // H}', by_name['attention'],
                 runs['attention'][0], 'SDPA', card)
    device_times(f'K1 qkv_proj {C} -> {3 * C}', by_name['qkv_proj'],
                 runs['qkv_proj'][0], 'cast + addmm', card)

    # B9: the library's yardstick is the cuDNN bf16 chain of the same
    # function (the DFT as a conv, magnitude, mel product, log)
    n_freqs = config.num_fft // 2 + 1
    wconv = stft._conv_weight(config.num_fft, config.window_size,
                              config.hopsize, dev).to(bf16)
    wmel = stft._mel_weight(config.sample_rate, config.num_fft,
                            config.num_mels, dev).to(bf16)

    def library_mel():
        spec = F.conv1d(blocks.transpose(1, 2).to(bf16), wconv).float()
        re, im = spec[:, :n_freqs], spec[:, n_freqs:]
        mag = torch.sqrt(re * re + im * im + 1e-6).to(bf16)
        return torch.log(torch.clamp((wmel @ mag).float(), min=1e-5))

    Mm = BATCH * Tm
    records.append(timed_record(
        'fused_log_mel', 'fused_mel.cu', 'ppgs_tpu/ops/stft.py:202',
        fused_launches['fused_log_mel'], err['fused_log_mel'], (
            lambda: stft.fused_log_mel(blocks, *mel_args),
            lambda: stft.fused_log_mel_reference(blocks, *mel_args),
            library_mel),
        # the DFT over the n_fft window samples (the blocked basis rows past
        # it are zero) and the mel product; the fp32 audio, the bases and
        # the output
        (2 * 2 * Mm * config.num_fft * n_freqs
         + 2 * Mm * n_freqs * config.num_mels,
         blocks.numel() * 4 + 2 * config.num_fft * n_freqs * 2
         + n_freqs * config.num_mels * 2 + Mm * config.num_mels * 4),
        card, plain_reps=HEAVY_REPS))
    device_times(f'B9 fused_log_mel ({BATCH} x {Tm} frames)', records[-1],
                 lambda: stft.fused_log_mel(blocks, *mel_args), 'cuDNN chain',
                 card)

    stack_ms = time_ms(lambda: elk.encoder_stack(x, mask, model.layers, H))
    stack_plain_ms = time_ms(
        lambda: elk.encoder_stack_reference(x, mask, model.layers, H))
    # The library's yardstick: the same post-LN stack in one call, with
    # the same key-padding mask (the main path's windows have no wholly
    # masked row); its output is held to the kernels' on the valid rows
    # (its residual is bf16, the kernels' fp32)
    encoder = library_encoder(model.layers, C, H, Fh, dev)
    x_bf16, pad = x.to(bf16), ~mask

    def library_stack():
        return encoder(x_bf16, src_key_padding_mask=pad)

    stack_library_ms = time_ms(library_stack)
    gap = (library_stack().float() - elk.encoder_stack(
        x, mask, model.layers, H))[mask].abs()
    print(f'nn.TransformerEncoder against encoder_stack, valid rows: max '
          f'|diff| {gap.max().item():.3g}, mean {gap.mean().item():.3g} '
          f'(mean < 0.1)', flush=True)
    if not gap.mean().item() < 0.1:
        raise AssertionError('the library encoder computes another function')
    del encoder, gap
    # The chain's bound: each of its kernels at its own bound, per layer
    stack_bound = L * sum(bound(*w_)[0] for w_ in work.values())
    print(f'encoder_stack ({L} layers, {W} x {T}): kernels {stack_ms:.4f} ms, '
          f'bound {stack_bound:.4f} ms, plain {stack_plain_ms:.4f} ms, '
          f'library {stack_library_ms:.4f} ms (nn.TransformerEncoder) '
          f'[{card}]', flush=True)

    e2e_s = median_seconds(lambda: port.from_audio(audio,
                                                   checkpoint=checkpoint))
    print(f'from_audio {BATCH} x {SECONDS} s: {e2e_s * 1e3:.3f} ms, '
          f'{BATCH * SECONDS / e2e_s:.1f} audio-s/s (median of 5) [{card}]',
          flush=True)
    profile_call('from_audio', lambda: port.from_audio(
        audio, checkpoint=checkpoint), card)
    os.environ['PPGS_TPU_FUSED_MEL'] = '1'
    try:
        e2e_s = median_seconds(lambda: port.from_audio(
            audio, checkpoint=checkpoint))
        print(f'from_audio {BATCH} x {SECONDS} s (PPGS_TPU_FUSED_MEL=1): '
              f'{e2e_s * 1e3:.3f} ms, {BATCH * SECONDS / e2e_s:.1f} '
              f'audio-s/s (median of 5) [{card}]', flush=True)
        profile_call('from_audio (PPGS_TPU_FUSED_MEL=1)', lambda:
                     port.from_audio(audio, checkpoint=checkpoint), card)
    finally:
        del os.environ['PPGS_TPU_FUSED_MEL']
    del audio, long_audio, model
    return records


def train_phases(port, config, workdir, dev, gen, card):
    """Phases 6-8: the train kernels against their plain versions, the
    training main path, and the times; returns the kernels' JSON records."""
    phase(f'6 train kernels against their plain versions ({TRAIN_B} windows '
          f'x T={TRAIN_T}, dropout {DROPOUT}, the same Philox masks)')
    # The train model holds the same seeded weights as parameters: train
    # mode reads them, cast per call
    train_model = port.train.core.init_model(config, dev)
    train_model.load_state_dict(port.convert.params_from_jax(
        port.load.flatten_params(random_params(port, config, SEED))))
    layer = train_model.layers[0]
    gemm_small_checks(dev, gen)
    for form in ('train_ln', 'y_out'):
        k4_odd_shape_checks(form, config.hidden_channels, 'relu',
                            config.ffn_channels, dev)
    ffn_bwd_odd_shape_checks(dev)
    attention_train_odd_shape_checks(dev)
    train_err, train_inputs = train_kernel_checks(port, config, layer, dev,
                                                  gen)
    train_inputs.update(
        ffn_b1=layer.ffn.b1, ffn_b2=layer.ffn.b2, bo=layer.attn.bo,
        g1=layer.norm1.scale, be1=layer.norm1.bias, g2=layer.norm2.scale,
        be2=layer.norm2.bias)
    whole_function_checks(config, layer, dev, gen, train_inputs['mask'])

    phase(f'7 train(): the mel model at full width and depth, {TRAIN_B} x '
          f'{TRAIN_T} then a resume at {TRAIN_B} x {SPLIT_T} (main path)')
    trained, train_launches, split_step, b4_steps = train_run(
        port, config, dev, Path(workdir) / 'train', card)
    print(f'launches in the train() runs: {train_launches}', flush=True)
    form_launches = gemm_form_launches(
        train_inputs, port.ops.backward.gemm.forms)
    print(f'gemm launches by form in the train() runs: {form_launches}',
          flush=True)
    if min(form_launches.values()) == 0:
        raise AssertionError(f'a gemm form never launched: {form_launches}')
    if min(train_launches.values()) == 0:
        raise AssertionError(f'a train kernel never launched: '
                             f'{train_launches}')
    check_step_launches(config, b4_steps, split_step)
    card_against_cpu(port, trained, config, dev)

    phase(f'8 train times on {card} (median of {TRAIN_REPS}, CUDA events)')
    records, gemm_ms = train_kernel_times(
        config, train_inputs, train_err, train_launches, b4_steps[1],
        form_launches, card)
    composite_times(port, config, layer, train_inputs, dev, gen, card)
    del train_inputs
    step_metrics(port, trained, config, dev, card,
                 gemm_ms * config.num_hidden_layers)
    return records


def w2v2fb_setup(port, workdir, dev):
    """Seeded full-size random trunk and head weights in temporary npz
    files, ``W2V2FB_CHECKPOINT`` pointed at the trunk's; returns (the
    prepared trunk on the card, the head model, the head's config and
    checkpoint)."""
    import dataclasses

    trunk_path = Path(workdir) / 'wav2vec2-base.npz'
    port.load.save_params(trunk_path, random_w2v2_params(port, SEED + 7))
    w2v2fb = port.preprocess.w2v2fb
    w2v2fb.W2V2FB_CHECKPOINT = trunk_path
    head_config = port.config.get('w2v2fb')
    head_path = Path(workdir) / 'random-w2v2fb.npz'
    port.load.save_params(head_path,
                          random_params(port, head_config, SEED + 8))
    wcfg = dataclasses.replace(port.models.w2v2.BASE,
                               compute_dtype=head_config.compute_dtype)
    trunk = w2v2fb._trunk(wcfg, dev)
    head, _ = port.load.model(checkpoint=head_path, config=head_config,
                              device=dev)
    return trunk, head, head_config, head_path


def layer_weights(layer):
    """A layer's weights as the stack hands them to K1-K4: the prepared
    ones of convert.prepare_layers and the fp32 parameter vectors."""
    p = layer.prepared
    return {'wqkv': p.wqkv_folded, 'bqkv': p.bqkv_folded, 'wo': p.wo,
            'bo': layer.attn.bo, 'g1': layer.norm1.scale,
            'be1': layer.norm1.bias, 'w1': p.w1, 'b1': layer.ffn.b1,
            'w2': p.w2, 'b2': layer.ffn.b2, 'g2': layer.norm2.scale,
            'be2': layer.norm2.bias}


@torch.no_grad()
def layer_kernel_checks(tag, x, mask, w, H, activation, err, inputs,
                        k1_share=0.0):
    """K1-K4 of one layer against their plain versions on (B, T, C) x;
    fills ``err`` and ``inputs`` under ``tag``. ``k1_share``: the share of
    K1's outputs that may flip by a bf16 ulp of a product in [4, 8) (the
    train shape's check, phase 6), for the widths whose deeper sums flip
    more often than the registered ones'."""
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    C = x.shape[-1]
    D = C // H
    qkv = elk.qkv_proj(x, w['wqkv'], w['bqkv'])
    err[f'qkv_proj_{tag}'] = check(
        f'K1 qkv_proj ({tag}, {C} -> {3 * C})', qkv,
        elk.qkv_proj_reference(x, w['wqkv'], w['bqkv']), atol=1e-2,
        rtol=1e-2, share=k1_share, outlier=6.25e-2 if k1_share else None)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    a = fa.attention(q, k, v, mask, H, 1.0)
    err[f'attention_d{D}'] = check(
        f'K2 attention (d_head {D}, {H} heads)', a,
        fa.attention_reference(q, k, v, mask, H, 1.0), atol=5e-3)
    dead = ~mask.any(dim=1)
    if dead.any() and a[dead].abs().max().item() != 0:
        raise AssertionError(f'K2 d_head {D}: a wholly masked window did '
                             f'not give 0')
    r = elk.out_proj_residual_ln(a, w['wo'], w['bo'], x, w['g1'], w['be1'])
    err[f'out_proj_residual_ln_c{C}'] = check(
        f'K3 out_proj_residual_ln (C {C})', r,
        elk.out_proj_residual_ln_reference(a, w['wo'], w['bo'], x, w['g1'],
                                           w['be1']), atol=1e-3)
    ffn = (w['w1'], w['b1'], w['w2'], w['b2'], w['g2'], w['be2'])
    y = fused_ffn.ffn_residual_ln(r, *ffn, activation=activation)
    err[f'ffn_residual_ln_c{C}'] = check(
        f'K4 ffn_residual_ln (C {C}, {activation})', y,
        fused_ffn.ffn_residual_ln_reference(r, *ffn, activation=activation),
        atol=1e-2)
    inputs[tag] = dict(x=x, mask=mask, w=w, q=q, k=k, v=v, qkv=qkv, a=a, r=r,
                       H=H, activation=activation)


# B10 (conv_stack.cu) at odd shapes, before anything is timed: conv_gelu's
# output rows about its 128-row tiles and one odd length past several;
# conv 1's (the first form's) likewise, conv 0's last 128-frame block
# reading past the audio; the whole chain at 1 s, 2.5 s and 8 s + 37
# samples of audio
B10_ODD_T = (1, 63, 64, 65, 127, 128, 129, 400, 1001)
B10_CHAIN_SAMPLES = (16_000, 40_000, 128_037)
# conv_stats and conv0_gelu alone: conv-0 frames about conv0_gelu's 64-row
# steps and 128-frame blocks (and conv_stats' groups of 4), conv 0 at
# wav2vec2's (k0, s0), a wider one that takes rows 8.. of the Gram matrix
# from rows 8 - s0.. twice over, two with strides past 8 whose rows 8.. are
# summed as they are (conv_stats' second product), and one tap; a normal
# draw and a loud one with a DC offset (0.9 + 0.05 N: a direct fp32 sum of
# squares loses digits there)
B10_STATS_T0 = (1, 255, 256, 257, 1000)
B10_STATS_CONV0 = ((10, 5), (16, 3), (16, 9), (12, 10), (1, 1))


def stats_fp64(audio, w0, k0, s0):
    """conv 0's per-channel sum and sum of squares summed directly in fp64
    (no Gram matrix), one utterance at a time: the oracle of conv_stats."""
    w = w0.double()
    out = []
    for a in audio:
        x = a.double().unfold(-1, k0, s0) @ w
        out.append(torch.stack([x.sum(0), (x * x).sum(0)]))
    return torch.stack(out)


@torch.no_grad()
def b10_conv0_checks(gn, dev):
    """conv_stats at B = 1 and 3, ``B10_STATS_T0`` frames and
    ``B10_STATS_CONV0``, normal and loud, against its plain version and
    the fp64 oracle at atol 1e-3 rtol 1e-4 (phase 9's limit); conv0_gelu
    on those statistics against its plain version at atol 1e-3 rtol 1e-2,
    pooling the share of outputs that its GELU guard left to tanhf and the
    share whose bits differ from the plain version's."""
    from ppgs_tpu_torch.ops import conv_stack

    gen = torch.Generator(device=dev).manual_seed(SEED + 89)
    C = conv_stack.CHANNELS
    worst = {'plain': 0.0, 'fp64': 0.0, 'conv0': 0.0}
    guarded = apart = outputs = 0
    for (k0, s0), B, T0, loud in itertools.product(
            B10_STATS_CONV0, (1, 3), B10_STATS_T0, (False, True)):
        S = s0 * (T0 - 1) + k0 + 2
        noise = torch.randn(B, S, generator=gen, device=dev)
        audio = (0.9 + 0.05 * noise if loud else 0.1 * noise).to(
            torch.bfloat16)
        w0 = (0.3 * torch.randn(k0, C, generator=gen, device=dev)).to(
            torch.bfloat16)
        name = f'k0={k0} s0={s0} B={B} T0={T0}{" loud" if loud else ""}'
        sums = conv_stack.conv_stats(audio, w0, k0, s0)
        worst['plain'] = max(worst['plain'], check(
            f'B10 conv_stats {name}', sums,
            conv_stack.conv_stats_reference(audio, w0, k0, s0), atol=1e-3,
            rtol=1e-4, quiet=True))
        worst['fp64'] = max(worst['fp64'], check(
            f'B10 conv_stats {name} against fp64', sums,
            stats_fp64(audio, w0, k0, s0), atol=1e-3, rtol=1e-4, quiet=True))
        first = (w0, k0, s0, sums, gn.scale, gn.bias)
        act, count = conv_stack.conv0_gelu_counted(audio, *first)
        plain = conv_stack.conv0_gelu_reference(audio, *first)
        worst['conv0'] = max(worst['conv0'], check(
            f'B10 conv0_gelu {name}', act, plain, atol=1e-3, rtol=1e-2,
            quiet=True))
        guarded += count.item()
        apart += (act != plain).sum().item()
        outputs += act.numel()
    print(f'B10 conv_stats at (k0, s0) {B10_STATS_CONV0}, B = 1, 3, T0 '
          f'{B10_STATS_T0}, normal and loud (DC offset): max |kernel - '
          f'plain| {worst["plain"]:.3g}, max |kernel - fp64| '
          f'{worst["fp64"]:.3g} (atol 1e-3 rtol 1e-4 in each case)',
          flush=True)
    print(f'B10 conv0_gelu on those statistics: max |kernel - plain| '
          f'{worst["conv0"]:.3g} (atol 1e-3 rtol 1e-2 in each case); its '
          f'GELU guard left {guarded / outputs:.3e} of the {outputs} outputs '
          f'to tanhf; {apart / outputs:.3e} differ from the plain version\'s '
          f'bits', flush=True)


@torch.no_grad()
def b10_odd_shape_checks(taps, gn, kernel, stride, dev):
    """conv_gelu's plain form at k = 3 and 2 (s = 2, the trunk's convs 2
    and 5), B = 1 and 3, ``B10_ODD_T`` output rows (T_in one row past the
    least where T_out is odd); its first form (conv0_gelu, then the
    product) from audio whose conv 1 has those rows (2 samples past the
    least for odd T_out), B = 1 and 3; and the whole chain at
    ``B10_CHAIN_SAMPLES``, B = 2; each against its plain version at phase
    9's main-shape limits (atol 1e-3 rtol 1e-2; the chain relative L2
    1e-2), on its own seeded inputs."""
    from ppgs_tpu_torch.ops import conv_stack

    b10_conv0_checks(gn, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 83)
    C = conv_stack.CHANNELS
    k0, s0, k1, s1 = kernel[0], stride[0], kernel[1], stride[1]
    for name, w, k in (('conv 2', taps.w2, kernel[2]),
                       ('conv 5', taps.w5, kernel[5])):
        worst = 0.0
        for B, T_out in itertools.product((1, 3), B10_ODD_T):
            T_in = 2 * (T_out - 1) + k + T_out % 2
            x = (0.5 * torch.randn(B, T_in, C, generator=gen, device=dev)
                 ).to(torch.bfloat16)
            worst = max(worst, check(
                f'B10 conv_gelu {name} B={B} T_out={T_out}',
                conv_stack.conv_gelu(x, w, k, 2),
                conv_stack.conv_gelu_reference(x, w, k, 2), atol=1e-3,
                rtol=1e-2, quiet=True))
        print(f'B10 conv_gelu (k = {k}, s = 2, {name}\'s weights) at B = 1, '
              f'3 and T_out {B10_ODD_T}: max |kernel - plain| {worst:.3g} '
              f'(atol 1e-3 rtol 1e-2 in each case)', flush=True)
    worst = 0.0
    for B, T1 in itertools.product((1, 3), B10_ODD_T):
        T0 = s1 * (T1 - 1) + k1
        S = s0 * (T0 - 1) + k0 + 2 * (T1 % 2)
        audio = (0.1 * torch.randn(B, S, generator=gen, device=dev)
                 ).to(torch.bfloat16)
        sums = conv_stack.conv_stats(audio, taps.w0, k0, s0)
        first = (taps.w0, k0, s0, sums, gn.scale, gn.bias)
        got = conv_stack.conv_gelu(audio, taps.w1, k1, s1, first)
        if got.shape != (B, T1, C):
            raise AssertionError(f'B10 first form: shape {tuple(got.shape)}, '
                                 f'not {(B, T1, C)}')
        worst = max(worst, check(
            f'B10 conv_gelu first form B={B} T_out={T1}', got,
            conv_stack.conv_gelu_reference(audio, taps.w1, k1, s1, first),
            atol=1e-3, rtol=1e-2, quiet=True))
    print(f'B10 conv_gelu first form (conv0_gelu, then conv 1) at B = 1, 3 '
          f'and T_out {B10_ODD_T}, conv 0\'s last block reading past the '
          f'audio: max |kernel - plain| {worst:.3g} (atol 1e-3 rtol 1e-2 in '
          f'each case)', flush=True)
    chain = ([getattr(taps, f'w{i}') for i in range(1, len(kernel))],
             taps.w0, gn.scale, gn.bias, kernel, stride)
    for S in B10_CHAIN_SAMPLES:
        audio = (0.1 * torch.randn(2, S, generator=gen, device=dev)
                 ).to(torch.bfloat16)
        check_rel(f'B10 the whole conv chain, 2 x {S} samples',
                  conv_stack.feature_encoder_stack(audio, *chain),
                  conv_stack.feature_encoder_stack_reference(audio, *chain),
                  1e-2)


@torch.no_grad()
def w2v2fb_kernel_checks(port, trunk, head, head_config, dev, gen):
    """Phase 9: every w2v2fb kernel instance against its plain version at
    the slice's shapes; returns (max errors, inputs for phase 11)."""
    from ppgs_tpu_torch.ops import conv_stack
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    err, inputs = {}, {}
    wcfg = trunk.config
    samples = W2V2_SECONDS * head_config.sample_rate
    S = samples + 2 * port.preprocess.w2v2fb.PAD
    T = int(port.models.w2v2.feat_extract_output_lengths(S, wcfg))
    C, H = wcfg.hidden_size, wcfg.num_heads
    # The trunk: 64 utterances x 400 frames, the last wholly masked
    x = torch.randn(W2V2_BATCH, T, C, generator=gen, device=dev)
    mask = torch.ones(W2V2_BATCH, T, dtype=torch.bool, device=dev)
    mask[-1] = False
    tw = layer_weights(trunk.encoder.layers[0])
    k1_odd_shape_checks('trunk', tw['wqkv'], tw['bqkv'], dev)
    layer_kernel_checks('trunk', x, mask, tw, H, 'gelu', err, inputs)
    x16 = x.to(torch.bfloat16)
    layers = trunk.encoder.layers
    got = elk.encoder_stack(x16, mask, layers, H, activation='gelu')
    want = elk.encoder_stack_reference(x16, mask, layers, H,
                                       activation='gelu')
    check_rel(f'B7 the {len(layers)}-layer GELU stack (valid rows)',
              got[mask], want[mask], 1e-2)
    inputs['stack'] = dict(x16=x16, mask=mask)
    del got, want

    # The head: 128 windows x 500 frames of 500 and 450 valid frames
    frames = samples // head_config.hopsize
    stride, n_blocks = port.models.transformer.chunk_layout(
        frames, head_config.chunk_length, head_config.chunk_overlap)
    Tw = head_config.chunk_length
    win_len = torch.tensor([min(Tw, frames + head_config.chunk_overlap
                                - i * stride) for i in range(n_blocks)],
                           device=dev)
    hmask = port.ops.masking.mask_from_lengths(
        win_len.repeat(W2V2_BATCH), Tw)
    Ch, Hh = head_config.hidden_channels, head_config.attention_heads
    xh = torch.randn(W2V2_BATCH * n_blocks, Tw, Ch, generator=gen, device=dev)
    hw = layer_weights(head.layers[0])
    k1_odd_shape_checks('head', hw['wqkv'], hw['bqkv'], dev)
    layer_kernel_checks('head', xh, hmask, hw, Hh, 'relu', err, inputs)
    r = inputs['head']['r']
    ffn = (hw['w1'], hw['b1'], hw['w2'], hw['b2'], hw['g2'], hw['be2'])
    check(f'K4 ffn_residual_ln (C {Ch}, round_input, per-layer path)',
          fused_ffn.ffn_residual_layernorm(r[:3], *ffn),
          fused_ffn.ffn_residual_layernorm_reference(r[:3], *ffn), atol=1e-2)
    # The head's per-layer path past 1024 frames: 4 windows of T = 1200,
    # ragged, one wholly masked
    long_len = torch.tensor([HEAD_LONG_T, 1000, 37, 0], device=dev)
    long_mask = port.ops.masking.mask_from_lengths(long_len, HEAD_LONG_T)
    lq, lk, lv = (torch.randn(4, HEAD_LONG_T, Ch, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3))
    out = fa.flash_attention(lq, lk, lv, long_mask, Hh)
    check(f'K2 attention (d_head {Ch // Hh}) T={HEAD_LONG_T}', out,
          fa.flash_attention_reference(lq, lk, lv, long_mask, Hh), atol=5e-3)
    if not torch.equal(out[3], torch.zeros_like(out[3])):
        raise AssertionError('a wholly masked window did not give 0')

    # The conv stack (B10) at 64 x 8 s of padded audio
    audio = (0.1 * torch.randn(W2V2_BATCH, S, generator=gen, device=dev)
             ).to(torch.bfloat16)
    taps = trunk.feature_prepared
    gn = trunk.feature_encoder[0].group_norm
    k, s = wcfg.conv_kernel, wcfg.conv_stride
    b10_odd_shape_checks(taps, gn, k, s, dev)
    sums = conv_stack.conv_stats(audio, taps.w0, k[0], s[0])
    err['conv_stats'] = check(
        'B10 conv_stats (sum, sum of squares)', sums,
        conv_stack.conv_stats_reference(audio, taps.w0, k[0], s[0]),
        atol=1e-3, rtol=1e-4)
    check('B10 conv_stats against fp64', sums,
          stats_fp64(audio, taps.w0, k[0], s[0]), atol=1e-3, rtol=1e-4)
    if not torch.equal(sums, conv_stack.conv_stats(audio, taps.w0, k[0],
                                                   s[0])):
        raise AssertionError('B10 conv_stats: a second call on the same '
                             'audio differs from the first')
    first = (taps.w0, k[0], s[0], sums, gn.scale, gn.bias)
    act, count = conv_stack.conv0_gelu_counted(audio, *first)
    plain = conv_stack.conv0_gelu_reference(audio, *first)
    err['conv0_gelu'] = check(
        'B10 conv0_gelu (conv 0 + GroupNorm + GELU: conv 1\'s input)', act,
        plain, atol=1e-3, rtol=1e-2)
    guard_share = count.item() / act.numel()
    apart = (act != plain).float().mean().item()
    print(f'B10 conv0_gelu: its GELU guard left {guard_share:.3e} of the '
          f'outputs to tanhf; {apart:.3e} differ from the plain version\'s '
          f'bits', flush=True)
    del act, plain
    x1 = conv_stack.conv_gelu(audio, taps.w1, k[1], s[1], first)
    err['conv_gelu_first'] = check(
        'B10 conv_gelu first form (conv0_gelu, then conv 1)', x1,
        conv_stack.conv_gelu_reference(audio, taps.w1, k[1], s[1], first),
        atol=1e-3, rtol=1e-2)
    x2 = conv_stack.conv_gelu(x1, taps.w2, k[2], s[2])
    err['conv_gelu'] = check(
        'B10 conv_gelu (conv 2)', x2,
        conv_stack.conv_gelu_reference(x1, taps.w2, k[2], s[2]), atol=1e-3,
        rtol=1e-2)
    chain = ([getattr(taps, f'w{i}') for i in range(1, len(k))], taps.w0,
             gn.scale, gn.bias, k, s)
    got = conv_stack.feature_encoder_stack(audio, *chain)
    check_rel('B10 the whole conv chain', got,
              conv_stack.feature_encoder_stack_reference(audio, *chain),
              1e-2)
    inputs['conv'] = dict(audio=audio, sums=sums, first=first, x1=x1,
                          chain=chain, k=k, s=s)
    return err, inputs


def set_counts(counters):
    for fn in counters.values():
        fn.launches = 0
        for name in ('widths', 'strides'):
            if hasattr(fn, name):
                getattr(fn, name).clear()
        if hasattr(fn, 'first'):
            fn.first = 0


def read_counts(counters):
    """(launches per wrapper, with '<name>_first' for a wrapper that counts
    its first form apart; launches per width of the wrappers that count
    them)."""
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    launches.update({f'{name}_first': fn.first
                     for name, fn in counters.items() if hasattr(fn, 'first')})
    return (launches,
            {name: dict(fn.widths) for name, fn in counters.items()
             if hasattr(fn, 'widths')})


def w2v2fb_main_path(port, trunk, head_config, head_path, dev, gen, card):
    """Phase 10: from_audio(representation='w2v2fb') at 64 x 8 s, its
    exact launches, a 2 s utterance against the CPU, and the conv-stack
    opt-in; returns (the launches per width, the opt-in's launches, the
    audio)."""
    from ppgs_tpu_torch.ops import conv_stack
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    counters = {'qkv_proj': elk.qkv_proj, 'attention': fa.attention,
                'out_proj_residual_ln': elk.out_proj_residual_ln,
                'ffn_residual_ln': fused_ffn.ffn_residual_ln,
                'conv_stats': conv_stack.conv_stats,
                'conv0_gelu': conv_stack.conv0_gelu,
                'conv_gelu': conv_stack.conv_gelu}
    samples = W2V2_SECONDS * head_config.sample_rate
    audio = 0.1 * torch.randn(W2V2_BATCH, 1, samples, generator=gen,
                              device=dev)
    call = dict(representation='w2v2fb', checkpoint=head_path)
    set_counts(counters)
    ppg = port.from_audio(audio, **call)
    launches, widths = read_counts(counters)
    print(f'launches in one w2v2fb from_audio call: {launches}, by width: '
          f'{widths}', flush=True)
    Lt, Lh = trunk.config.num_layers, head_config.num_hidden_layers
    d_t = trunk.config.hidden_size // trunk.config.num_heads
    Ch = head_config.hidden_channels
    d_h = Ch // head_config.attention_heads
    want = {'qkv_proj': Lt + Lh, 'attention': Lt + Lh,
            'out_proj_residual_ln': Lt + Lh, 'ffn_residual_ln': Lt + Lh,
            'conv_stats': 0, 'conv0_gelu': 0, 'conv_gelu': 0,
            'conv_gelu_first': 0}
    Ct = trunk.config.hidden_size
    want_widths = {'qkv_proj': {Ct: Lt, Ch: Lh},
                   'attention': {d_t: Lt, d_h: Lh},
                   'out_proj_residual_ln': {Ct: Lt, Ch: Lh},
                   'ffn_residual_ln': {Ct: Lt, Ch: Lh}}
    if launches != want or any(widths[n] != w for n, w in
                               want_widths.items()):
        raise AssertionError(f'w2v2fb launches {launches} {widths}, not '
                             f'{want} {want_widths}')
    check_ppg('w2v2fb from_audio', ppg, audio,
              (W2V2_BATCH, head_config.output_channels,
               samples // head_config.hopsize))

    short = audio[:W2V2_CPU_ROWS, :,
                  :W2V2_CPU_SECONDS * head_config.sample_rate]
    fp32 = head_config.replace(compute_dtype='float32')
    agree(f'w2v2fb from_audio, {W2V2_CPU_ROWS} x {W2V2_CPU_SECONDS} s, '
          f'against device=cpu', port.from_audio(short, **call),
          port.from_audio(short.cpu(), device='cpu', **call),
          port.from_audio(short.cpu(), device='cpu', config=fp32, **call))

    # The conv-stack opt-in: B10 on, the rest as before
    os.environ['PPGS_TPU_CONV_STACK'] = '1'
    try:
        set_counts(counters)
        stacked = port.from_audio(audio, **call)
        stack_launches, stack_widths = read_counts(counters)
    finally:
        del os.environ['PPGS_TPU_CONV_STACK']
    print(f'launches with PPGS_TPU_CONV_STACK=1: {stack_launches}, by '
          f'width: {stack_widths}', flush=True)
    if (stack_launches != {**want, 'conv_stats': 1, 'conv0_gelu': 1,
                           'conv_gelu': len(trunk.config.conv_kernel) - 1,
                           'conv_gelu_first': 1}
            or stack_widths != widths):
        raise AssertionError('the conv-stack opt-in did not launch B10 once '
                             'per conv, conv0_gelu and the first form once, '
                             'and K1-K4 as the default path')
    # The frames bf16 decides: where the default path agrees with the same
    # weights in fp32 (plain torch on the card)
    opt_in_against_default('PPGS_TPU_CONV_STACK=1', stacked, ppg,
                           port.from_audio(audio, config=fp32, **call), card)
    del stacked
    return widths, stack_launches, audio


def timed_record(name, src, replaces, launches, err, fns, work, card,
                 plain_reps=REPS):
    """Time a kernel, its plain version and a library call (or None) and
    return the kernel's JSON record."""
    kernel_fn, plain_fn, library_fn = fns
    ms = time_ms(kernel_fn)
    plain_ms = time_ms(plain_fn, plain_reps, 1)
    library_ms = time_ms(library_fn) if library_fn else None
    bound_ms, bound_by = bound(*work)
    lib = f'{library_ms:.4f} ms' if library_ms is not None else 'none'
    print(f'{name}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms '
          f'({bound_by}), plain {plain_ms:.4f} ms, library {lib}, '
          f'{launches} launches per main-path call [{card}]', flush=True)
    return {'name': name, 'route': 'cuda',
            'source': f'ppgs_tpu_torch/kernels/csrc/{src}',
            'replaces': replaces, 'launches': launches, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': library_ms}


@torch.no_grad()
def layer_records(tag, inp, err, launches, replaces, card):
    """Phase 11 for one layer shape: K1-K4's records."""
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    bf16 = torch.bfloat16
    x, mask, w, H, act = (inp[k] for k in ('x', 'mask', 'w', 'H',
                                           'activation'))
    q, k, v, a, r = (inp[n] for n in 'qkvar')
    B, T, C = x.shape
    M, D, Fh = B * T, C // H, w['w1'].shape[1]
    pairs = mask.sum(dim=1).double().sum().item() * T     # query x key
    q4, k4, v4 = (t.view(B, T, H, D).transpose(1, 2) for t in (q, k, v))
    sdpa_mask = mask[:, None, None, :]
    ffn = (w['w1'], w['b1'], w['w2'], w['b2'], w['g2'], w['be2'])
    act_fn = (F.relu if act == 'relu'
              else lambda t: F.gelu(t, approximate='tanh'))
    records = []
    records.append(timed_record(
        f'qkv_proj_{tag}', 'qkv_proj.cu', replaces,
        launches['qkv_proj'][tag], err[f'qkv_proj_{tag}'], (
            lambda: elk.qkv_proj(x, w['wqkv'], w['bqkv']),
            lambda: elk.qkv_proj_reference(x, w['wqkv'], w['bqkv']),
            lambda: torch.addmm(w['bqkv'].to(bf16), x.view(M, C).to(bf16),
                                w['wqkv'])),
        (2 * M * C * 3 * C, M * C * 4 + C * 3 * C * 2 + 3 * C * 4
         + M * 3 * C * 2), card))
    device_times(f'K1 qkv_proj {C} -> {3 * C}', records[-1],
                 lambda: elk.qkv_proj(x, w['wqkv'], w['bqkv']),
                 'cast + addmm', card)
    records.append(timed_record(
        f'attention_d{D}', 'attention.cu', replaces,
        launches['attention'][tag], err[f'attention_d{D}'], (
            lambda: fa.attention(q, k, v, mask, H, 1.0),
            lambda: fa.attention_reference(q, k, v, mask, H, 1.0),
            lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=sdpa_mask, scale=math.log(2))),
        (4 * pairs * C, M * 3 * C * 2 + M + M * C * 2), card))
    device_times(f'K2 attention d_head {D}', records[-1],
                 lambda: fa.attention(q, k, v, mask, H, 1.0), 'SDPA', card)
    records.append(timed_record(
        f'out_proj_residual_ln_c{C}', 'out_proj_ln.cu', replaces,
        launches['out_proj_residual_ln'][tag],
        err[f'out_proj_residual_ln_c{C}'], (
            lambda: elk.out_proj_residual_ln(a, w['wo'], w['bo'], x,
                                             w['g1'], w['be1']),
            lambda: elk.out_proj_residual_ln_reference(
                a, w['wo'], w['bo'], x, w['g1'], w['be1']),
            lambda: F.layer_norm(
                x + torch.addmm(w['bo'].to(bf16), a.view(M, C), w['wo'])
                .view(B, T, C), (C,), w['g1'], w['be1'])),
        (2 * M * C * C, M * C * 2 + 2 * M * C * 4 + C * C * 2 + 3 * C * 4),
        card))
    device_times(f'K3 out_proj_residual_ln C = {C}', records[-1],
                 lambda: elk.out_proj_residual_ln(a, w['wo'], w['bo'], x,
                                                  w['g1'], w['be1']),
                 'addmm + layer_norm', card)
    records.append(timed_record(
        f'ffn_residual_ln_c{C}' + ('_gelu' if act == 'gelu' else ''),
        'ffn_ln.cu', replaces, launches['ffn_residual_ln'][tag],
        err[f'ffn_residual_ln_c{C}'], (
            lambda: fused_ffn.ffn_residual_ln(r, *ffn, activation=act),
            lambda: fused_ffn.ffn_residual_ln_reference(r, *ffn,
                                                        activation=act),
            lambda: F.layer_norm(
                r + torch.addmm(
                    w['b2'].to(bf16),
                    act_fn(torch.addmm(w['b1'].to(bf16),
                                       r.view(M, C).to(bf16), w['w1'])),
                    w['w2']).view(B, T, C), (C,), w['g2'], w['be2'])),
        (4 * M * C * Fh, 2 * M * C * 4 + 2 * C * Fh * 2 + (Fh + 3 * C) * 4),
        card))
    kernel_device_ms(f'K4 ffn_residual_ln C = {C}', lambda: fused_ffn.
                     ffn_residual_ln(r, *ffn, activation=act), card)
    return records


@torch.no_grad()
def conv_device_times(a16, taps, first, kernel, stride, records,
                      library_conv0, card):
    """Each of B10's six conv_gelu launches on the main path's chain (64 x
    8 s): its device time per call (the profiler) and event time, its
    bound, and cuDNN's bf16 conv + GELU at that shape (conv 1's on a
    stored conv-0 activation from ``library_conv0``, as in its record) by
    both clocks. The records of conv 1 (the first form) and conv 2 get
    their device times and cuDNN's."""
    from ppgs_tpu_torch.ops import conv_stack

    C = conv_stack.CHANNELS
    B, S = a16.shape
    T0 = (S - kernel[0]) // stride[0] + 1
    k0 = first[1]
    x, T = a16, T0
    for i in range(1, len(kernel)):
        k, s = kernel[i], stride[i]
        w = getattr(taps, f'w{i}')
        T_out = (T - k) // s + 1
        if i == 1:
            def fn(x=x, w=w, k=k, s=s):
                return conv_stack.conv_gelu(x, w, k, s, first)
            x_nct = library_conv0()
            flops = 2 * B * T_out * k * C * C + 2 * B * T0 * k0 * C
            nbytes = B * S * 2 + k * C * C * 2 + k0 * C * 2 + B * T_out * C * 2
        else:
            def fn(x=x, w=w, k=k, s=s):
                return conv_stack.conv_gelu(x, w, k, s)
            x_nct = x.transpose(1, 2).contiguous()
            flops = 2 * B * T_out * k * C * C
            nbytes = B * T * C * 2 + k * C * C * 2 + B * T_out * C * 2
        w_oik = w.view(k, C, C).permute(2, 1, 0).contiguous()

        def cudnn(x_nct=x_nct, w_oik=w_oik, s=s):
            return F.gelu(F.conv1d(x_nct, w_oik, stride=s),
                          approximate='tanh')

        ms, cudnn_ms = time_ms(fn), time_ms(cudnn)
        dev_ms = kernel_device_ms(f'B10 conv {i} (conv_gelu)', fn, card)
        cudnn_dev = kernel_device_ms(f'B10 conv {i}, cuDNN conv + GELU',
                                     cudnn, card)
        bound_ms, bound_by = bound(flops, nbytes)
        dev = 'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'
        lib = 'not measured' if cudnn_dev is None else f'{cudnn_dev:.4f} ms'
        print(f'B10 conv {i} ({B} x {T_out} rows, k = {k}, s = {s}'
              f'{", the first form" if i == 1 else ""}): event {ms:.4f} ms, '
              f'device {dev}, bound {bound_ms:.4f} ms ({bound_by}); cuDNN '
              f'conv + GELU event {cudnn_ms:.4f} ms, device {lib}: '
              f'{ms / cudnn_ms:.2f}x [{card}]', flush=True)
        if i <= len(records):
            records[i - 1]['device_ms'] = dev_ms
            records[i - 1]['library_device_ms'] = cudnn_dev
        del x_nct, w_oik
        x, T = fn(), T_out
    del x


@torch.no_grad()
def w2v2fb_times(port, trunk, head_config, head_path, inputs, err,
                 widths, stack_launches, audio, card):
    """Phase 11: each w2v2fb kernel's time beside its plain version's, a
    library call's and its bound; the wholes; the slice end to end.
    ``widths``: phase 10's launches per width, which give each instance's
    launches."""
    from ppgs_tpu_torch.ops import conv_stack
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk

    d_t = trunk.config.hidden_size // trunk.config.num_heads
    d_h = head_config.hidden_channels // head_config.attention_heads
    Ct, Ch = trunk.config.hidden_size, head_config.hidden_channels
    per_tag = {
        'qkv_proj': {'trunk': widths['qkv_proj'][Ct],
                     'head': widths['qkv_proj'][Ch]},
        'attention': {'trunk': widths['attention'][d_t],
                      'head': widths['attention'][d_h]},
        'out_proj_residual_ln': {
            'trunk': widths['out_proj_residual_ln'][Ct],
            'head': widths['out_proj_residual_ln'][Ch]},
        'ffn_residual_ln': {'trunk': widths['ffn_residual_ln'][Ct],
                            'head': widths['ffn_residual_ln'][Ch]}}
    records = layer_records('trunk', inputs['trunk'], err, per_tag,
                            'ppgs_tpu/ops/encoder_layer_kernel.py:385', card)
    records += layer_records('head', inputs['head'], err, per_tag,
                             'ppgs_tpu/ops/encoder_layer_kernel.py:152', card)

    # B10, launched by the conv-stack opt-in's call (phase 10)
    c = inputs['conv']
    a16, k, s, first = c['audio'], c['k'], c['s'], c['first']
    B, S = a16.shape
    Cc = conv_stack.CHANNELS
    T0 = (S - k[0]) // s[0] + 1
    T1 = (T0 - k[1]) // s[1] + 1
    T2 = (T1 - k[2]) // s[2] + 1
    taps = trunk.feature_prepared
    w0_oik = taps.w0.T[:, None, :]
    gn = trunk.feature_encoder[0].group_norm

    def library_conv0():
        # conv 0 (cuDNN, bf16), the fp32 GroupNorm, GELU to bf16: the first
        # layer of models.w2v2.feature_encoder
        return F.gelu(port.models.w2v2._group_norm(
            F.conv1d(a16[:, None], w0_oik, stride=s[0]), gn),
            approximate='tanh').to(torch.bfloat16)

    conv0 = library_conv0()
    w1_oik = taps.w1.view(k[1], Cc, Cc).permute(2, 1, 0).contiguous()
    w2_oik = taps.w2.view(k[2], Cc, Cc).permute(2, 1, 0).contiguous()
    x1 = c['x1']
    x1_nct = x1.transpose(1, 2).contiguous()
    # conv_stats' bound: the audio read once (its Gram route's fp64
    # products, 2 B T0 (k0 (k0 + 1) / 2 + k0) FLOP, take less at the fp64
    # tensor peak); the direct route's bound counted conv 0's operations
    stats_flops = 2 * B * T0 * (k[0] * (k[0] + 1) // 2 + k[0])
    direct_ms = bound(2 * B * T0 * k[0] * Cc, 0)[0]

    def library_stats():
        # cuDNN's bf16 conv 0, then the sums over the frames
        x = F.conv1d(a16[:, None], w0_oik, stride=s[0]).float()
        return torch.stack([x.sum(-1), (x * x).sum(-1)], 1)

    records.append(timed_record(
        'conv_stats', 'conv_stack.cu', 'ppgs_tpu/ops/conv_stack.py:109',
        stack_launches['conv_stats'], err['conv_stats'], (
            lambda: conv_stack.conv_stats(a16, taps.w0, k[0], s[0]),
            lambda: conv_stack.conv_stats_reference(a16, taps.w0, k[0],
                                                    s[0]),
            library_stats),
        (stats_flops * PEAK_BF16_FLOPS / PEAK_FP64_FLOPS,
         B * S * 2 + k[0] * Cc * 2 + B * 2 * Cc * 4),
        card, plain_reps=HEAVY_REPS))
    stats_record = records[-1]
    device_times('B10 conv_stats', stats_record,
                 lambda: conv_stack.conv_stats(a16, taps.w0, k[0], s[0]),
                 'cuDNN conv 0 + sums', card)
    stats_record['library_device_ms'] = kernel_device_ms(
        'B10 conv_stats library route (cuDNN conv 0 + sums)', library_stats,
        card)
    print(f'conv_stats: bound {stats_record["bound_ms"]:.4f} ms (the audio\'s '
          f'bytes) [{direct_ms:.4f} ms: the direct route\'s operations, conv 0 '
          f'formed, which the Gram route does not need] [{card}]', flush=True)

    def library_gn_gelu():
        # cuDNN's bf16 conv 0, group_norm, GELU and the cast
        x = F.conv1d(a16[:, None], w0_oik, stride=s[0]).float()
        return F.gelu(F.group_norm(x, Cc, gn.scale, gn.bias, 1e-5),
                      approximate='tanh').to(torch.bfloat16)

    # conv 1's input, stored
    records.append(timed_record(
        'conv0_gelu', 'conv_stack.cu', 'ppgs_tpu/ops/conv_stack.py:123',
        stack_launches['conv0_gelu'], err['conv0_gelu'], (
            lambda: conv_stack.conv0_gelu(a16, *first),
            lambda: conv_stack.conv0_gelu_reference(a16, *first),
            library_gn_gelu),
        (2 * B * T0 * k[0] * Cc, B * S * 2 + k[0] * Cc * 2 + B * 2 * Cc * 4
         + 2 * Cc * 4 + B * T0 * Cc * 2), card, plain_reps=HEAVY_REPS))
    conv0_record = records[-1]
    device_times('B10 conv0_gelu', conv0_record,
                 lambda: conv_stack.conv0_gelu(a16, *first),
                 'cuDNN conv 0 + group_norm + GELU + cast', card)
    conv0_record['library_device_ms'] = kernel_device_ms(
        'B10 conv0_gelu library route (cuDNN conv 0 + group_norm + GELU + '
        'cast)', library_gn_gelu, card)
    records.append(timed_record(
        'conv_gelu_first', 'conv_stack.cu', 'ppgs_tpu/ops/conv_stack.py:123',
        stack_launches['conv_gelu_first'], err['conv_gelu_first'], (
            lambda: conv_stack.conv_gelu(a16, taps.w1, k[1], s[1], first),
            lambda: conv_stack.conv_gelu_reference(a16, taps.w1, k[1], s[1],
                                                   first),
            # conv 1 on a stored conv-0 activation (cuDNN, bf16)
            lambda: F.gelu(F.conv1d(conv0, w1_oik, stride=s[1]),
                           approximate='tanh')),
        (2 * B * T1 * k[1] * Cc * Cc + 2 * B * T0 * k[0] * Cc,
         B * S * 2 + k[1] * Cc * Cc * 2 + k[0] * Cc * 2 + B * T1 * Cc * 2),
        card, plain_reps=HEAVY_REPS))
    del conv0

    # The library's route to the function that conv_stats + conv_gelu's
    # first form compute together, from the audio: the first two layers of
    # models.w2v2.feature_encoder (conv 0 + GroupNorm + GELU, conv 1 +
    # GELU); held to the kernels' conv-1 output so that it is that function
    def library_first_two():
        return F.gelu(F.conv1d(library_conv0(), w1_oik, stride=s[1]),
                      approximate='tanh')

    rel = relative_l2(library_first_two().transpose(1, 2), c['x1'])
    chain_first_ms = time_ms(library_first_two)
    records[-1]['library_chain_ms'] = chain_first_ms
    print(f'conv_gelu_first: the library route to the same function (conv 0 '
          f'+ GroupNorm + GELU + conv 1 + GELU, cuDNN bf16) '
          f'{chain_first_ms:.4f} ms (its output within relative L2 '
          f'{rel:.3g} of the kernels\' (<= 5e-2)), against conv 1 on a '
          f'stored conv-0 activation {records[-1]["library_ms"]:.4f} ms and '
          f'conv_stats + conv_gelu_first {stats_record["ms"]:.4f} + '
          f'{records[-1]["ms"]:.4f} ms (conv0_gelu {conv0_record["ms"]:.4f} '
          f'of it) [{card}]', flush=True)
    if not rel <= 5e-2:
        raise AssertionError('the library route to conv_gelu_first computes '
                             'another function')
    records.append(timed_record(
        'conv_gelu', 'conv_stack.cu', 'ppgs_tpu/ops/conv_stack.py:123',
        stack_launches['conv_gelu'] - stack_launches['conv_gelu_first'],
        err['conv_gelu'], (
            lambda: conv_stack.conv_gelu(x1, taps.w2, k[2], s[2]),
            lambda: conv_stack.conv_gelu_reference(x1, taps.w2, k[2], s[2]),
            lambda: F.gelu(F.conv1d(x1_nct, w2_oik, stride=s[2]),
                           approximate='tanh')),
        (2 * B * T2 * k[2] * Cc * Cc,
         B * T1 * Cc * 2 + k[2] * Cc * Cc * 2 + B * T2 * Cc * 2), card,
        plain_reps=HEAVY_REPS))

    conv_device_times(a16, taps, first, k, s, records[-2:], library_conv0,
                      card)

    # The wholes: the 12-layer GELU stack and the conv chain
    st = inputs['stack']
    layers = trunk.encoder.layers
    C, H = trunk.config.hidden_size, trunk.config.num_heads
    Fh = trunk.config.intermediate_size
    stack_ms = time_ms(lambda: elk.encoder_stack(
        st['x16'], st['mask'], layers, H, activation='gelu'))
    stack_plain_ms = time_ms(lambda: elk.encoder_stack_reference(
        st['x16'], st['mask'], layers, H, activation='gelu'), HEAVY_REPS, 1)
    encoder = library_encoder(layers, C, H, Fh, st['x16'].device,
                              activation='gelu')
    pad = ~st['mask']
    stack_library_ms = time_ms(lambda: encoder(st['x16'],
                                               src_key_padding_mask=pad))
    del encoder
    # The chain's bound: each of its kernels at its own bound, per layer
    stack_bound = len(layers) * sum(r['bound_ms'] for r in records[:4])
    print(f'B7 the {len(layers)}-layer GELU stack ({B} x '
          f'{st["x16"].shape[1]}): kernels {stack_ms:.4f} ms, bound '
          f'{stack_bound:.4f} ms, plain {stack_plain_ms:.4f} ms, library '
          f'{stack_library_ms:.4f} ms (nn.TransformerEncoderLayer(768, 12, '
          f'3072, gelu) x {len(layers)}) [{card}]', flush=True)
    chain = c['chain']
    wcfg = trunk.config
    chain_ms = time_ms(lambda: conv_stack.feature_encoder_stack(a16, *chain))
    chain_plain_ms = time_ms(lambda: conv_stack.feature_encoder_stack_reference(
        a16, *chain), HEAVY_REPS, 1)
    chain_library_ms = time_ms(lambda: port.models.w2v2.feature_encoder(
        trunk, a16, wcfg))
    # Its bound: every conv's products (conv 0 once), the audio in and the
    # features out
    frames, flops = T0, 2 * B * T0 * k[0] * Cc
    for ki, si in zip(k[1:], s[1:]):
        frames = (frames - ki) // si + 1
        flops += 2 * B * frames * ki * Cc * Cc
    chain_bound, chain_by = bound(flops, B * S * 2 + B * frames * Cc * 2)
    print(f'B10 the conv chain ({B} x {S} samples): kernels {chain_ms:.4f} '
          f'ms, bound {chain_bound:.4f} ms ({chain_by}), plain '
          f'{chain_plain_ms:.4f} ms, library {chain_library_ms:.4f} ms (the '
          f'cuDNN bf16 convs, GroupNorm and GELU of '
          f'models.w2v2.feature_encoder) [{card}]', flush=True)

    call = dict(representation='w2v2fb', checkpoint=head_path)
    for use_stack in (False, True):
        if use_stack:
            os.environ['PPGS_TPU_CONV_STACK'] = '1'
        try:
            e2e_s = median_seconds(lambda: port.from_audio(audio, **call))
        finally:
            os.environ.pop('PPGS_TPU_CONV_STACK', None)
        print(f'w2v2fb from_audio {W2V2_BATCH} x {W2V2_SECONDS} s'
              f'{" (PPGS_TPU_CONV_STACK=1)" if use_stack else ""}: '
              f'{e2e_s * 1e3:.3f} ms, '
              f'{W2V2_BATCH * W2V2_SECONDS / e2e_s:.1f} audio-s/s (median '
              f'of 5) [{card}]', flush=True)
    profile_call('w2v2fb from_audio', lambda: port.from_audio(audio, **call),
                 card)
    return records


def w2v2fb_phases(port, workdir, dev, gen, card):
    """Phases 9-11: the w2v2fb slice; returns its kernels' JSON records."""
    phase('9 w2v2fb kernels against their plain versions (trunk 64 x 400, '
          'head 128 x 500, conv stack 64 x 8 s)')
    trunk, head, head_config, head_path = w2v2fb_setup(port, workdir, dev)
    k3_odd_shape_checks((trunk.config.hidden_size,
                         head_config.hidden_channels), 0, dev)
    k4_odd_shape_checks('ln', trunk.config.hidden_size, 'gelu',
                        trunk.config.intermediate_size, dev)
    k4_odd_shape_checks('ln', head_config.hidden_channels, 'relu',
                        head_config.ffn_channels, dev)
    k2_odd_shape_checks(
        trunk.config.hidden_size // trunk.config.num_heads,
        trunk.config.num_heads, dev)
    k2_odd_shape_checks(
        head_config.hidden_channels // head_config.attention_heads,
        head_config.attention_heads, dev)
    err, inputs = w2v2fb_kernel_checks(port, trunk, head, head_config, dev,
                                       gen)
    del head
    phase(f'10 from_audio(representation=w2v2fb): {W2V2_BATCH} x '
          f'{W2V2_SECONDS} s (main path)')
    widths, stack_launches, audio = w2v2fb_main_path(
        port, trunk, head_config, head_path, dev, gen, card)
    phase(f'11 w2v2fb times on {card} (median of {REPS}, CUDA events)')
    return w2v2fb_times(port, trunk, head_config, head_path, inputs, err,
                        widths, stack_launches, audio, card)


def random_conformer_params(port, seed):
    """Seeded full-size conformer weights in the JAX package's layout: the
    conformer's init, with the biases, norms and BatchNorm statistics drawn
    at random too and the q and k projections scaled by 4, so that the
    attention is far from uniform."""
    gen = torch.Generator().manual_seed(seed)
    conformer = port.models.conformer
    params = conformer.init(conformer.BOTTLENECK, gen)

    def draw(tree, path=''):
        for key, value in tree.items():
            if isinstance(value, dict):
                draw(value, f'{path}.{key}')
                continue
            noise = torch.randn(value.shape, generator=gen).numpy()
            if key in ('bias', 'mean'):
                tree[key] = (0.1 * noise).astype(np.float32)
            elif key == 'scale':
                tree[key] = (1 + 0.1 * noise).astype(np.float32)
            elif key == 'var':
                tree[key] = (1 + 0.5 * np.abs(noise)).astype(np.float32)
            elif path.endswith(('attn.q', 'attn.k')):
                tree[key] = 4 * value

    draw({'embed': params['embed'], 'after_norm': params['after_norm']})
    for block in params['blocks']:
        draw(block)
    return params


def bottleneck_setup(port, workdir, dev):
    """Seeded full-size conformer and head weights in temporary npz files,
    ``BOTTLENECK_CHECKPOINT`` pointed at the conformer's; returns (the
    prepared conformer on the card, its config, the head's config and
    checkpoint)."""
    import dataclasses

    path = Path(workdir) / 'conformer-24epoch.npz'
    port.load.save_params(path, random_conformer_params(port, SEED + 11))
    bottleneck = port.preprocess.bottleneck
    bottleneck.BOTTLENECK_CHECKPOINT = path
    head_config = port.config.get('bottleneck')
    head_path = Path(workdir) / 'random-bottleneck.npz'
    port.load.save_params(head_path,
                          random_params(port, head_config, SEED + 12))
    ccfg = dataclasses.replace(port.models.conformer.BOTTLENECK,
                               compute_dtype=head_config.compute_dtype)
    return bottleneck._encoder(ccfg, dev), ccfg, head_config, head_path


@torch.no_grad()
def bottleneck_kernel_checks(port, model, ccfg, dev, gen):
    """Phase 12: B8 against its plain version at the slice's shapes and
    about its band's edges, and the 16 blocks whole against the CPU;
    returns (max error, B8's inputs at the main path's shape for phase
    14)."""
    from ppgs_tpu_torch.ops import flash_attention as fa

    conformer = port.models.conformer
    mask_from_lengths = port.ops.masking.mask_from_lengths
    bf16 = torch.bfloat16
    B, H, C = BN_BATCH, ccfg.heads, ccfg.dim
    T = BN_SECONDS * 100                               # 800 frames
    dk = C // H
    # Block 0's projections of a LayerNormed random input, q_v and pos in
    # the layouts B8 reads (the memory behind attention_inputs' views)
    block = model.blocks[0]
    x = conformer._layer_norm(
        torch.randn(B, T, C, generator=gen, device=dev), block.norm_mha)
    pos_emb = torch.from_numpy(conformer.rel_pos_table(T, C))[None].to(dev)
    q_u, k, v, q_v, pos = conformer.attention_inputs(
        x, pos_emb, block.prepared.attn, H, bf16)
    q_v, pos = q_v.transpose(1, 2), pos[0].transpose(0, 1)
    # Ragged lengths, one wholly masked row
    lengths = T - torch.randint(0, T // 2, (B,), generator=gen, device=dev)
    lengths[0], lengths[-1] = T, 0
    mask = mask_from_lengths(lengths, T)
    got = fa.rel_attention(q_u, k, v, q_v, pos, mask, H)
    err = check(f'B8 rel_attention ({B} x T={T} x {H} x {dk}, block 0\'s '
                f'projections, ragged)', got,
                fa.rel_attention_reference(q_u, k, v, q_v, pos, mask, H),
                B8_ATOL, B8_RTOL)
    if got[-1].abs().max().item() != 0:
        raise AssertionError('B8: a wholly masked row did not give 0')
    inputs = dict(q_u=q_u, k=k, v=v, q_v=q_v, pos=pos,
                  mask=torch.ones(B, T, dtype=torch.bool, device=dev))
    del got, x
    # Random operands, k and v views of one fused buffer as in the slice:
    # T about the band's edges and the diagonal tiles, a T no multiple of
    # 8, the longest T the rule sends to B8, one draw peaked as the slice's
    # weights make it (q x 4), one with two whole key tiles masked inside a
    # row (the tile after them forms its band's half A anew), and the other
    # head widths
    cases = ([(Tx, 1, H, dk, False) for Tx in BN_ODD_T]
             + [(BN_ODD_T[-1], 4, H, dk, False),
                (BN_ODD_T[-2], 1, H, dk, True)]
             + [(BN_WIDTH_T, 1, Hx, d, False) for Hx, d in BN_WIDTHS])
    for Tx, peak, Hx, d, hole in cases:
        Cx = Hx * d
        qkv = torch.randn(4, Tx, 3 * Cx, generator=gen, device=dev)
        qkv[..., :Cx] *= peak
        qkv = qkv.to(bf16)
        q1 = qkv[..., :Cx].contiguous().view(4, Tx, Hx, d)
        k1, v1 = (qkv[..., i * Cx:(i + 1) * Cx].unflatten(-1, (Hx, d))
                  for i in (1, 2))
        qv1 = (peak * torch.randn(4, Tx, Hx, d, generator=gen, device=dev)
               ).to(bf16)
        pos1 = torch.randn(Tx, Hx, d, generator=gen, device=dev).to(bf16)
        lens = torch.tensor([Tx, max(Tx - 5, 1), min(37, Tx), 0], device=dev)
        m1 = mask_from_lengths(lens, Tx)
        if hole:
            m1[1, 64:192] = False
        out = fa.rel_attention(q1, k1, v1, qv1, pos1, m1, Hx)
        check(f'B8 rel_attention T={Tx} ({Hx} heads of {d}, 4 rows, '
              f'ragged, random{", peaked" if peak > 1 else ""}'
              f'{", keys 64-191 of row 1 masked" if hole else ""})', out,
              fa.rel_attention_reference(q1, k1, v1, qv1, pos1, m1, Hx),
              B8_ATOL, B8_RTOL)
        if out[3].abs().max().item() != 0:
            raise AssertionError('B8: a wholly masked row did not give 0')
    # The 16 blocks whole: the card (B8) against device='cpu' (its plain
    # version) on 2 rows of random features
    feats = torch.randn(2, T, ccfg.input_dim, generator=gen, device=dev)
    flens = torch.tensor([T, T - 123], device=dev)
    cpu_model = port.preprocess.bottleneck._encoder(ccfg, torch.device('cpu'))
    got = conformer.forward(model, feats, flens)
    want = conformer.forward(cpu_model, feats.cpu(), flens.cpu())
    valid = mask_from_lengths(flens, T)
    check_rel(f'the {ccfg.num_blocks}-block conformer, card against '
              f'device=cpu (2 x {T}, valid frames)', got[valid].cpu(),
              want[valid.cpu()], BN_BLOCKS_REL)
    return err, inputs


def bottleneck_main_path(port, ccfg, head_config, head_path, dev, gen, card):
    """Phase 13: from_audio(representation='bottleneck') at 64 x 8 s, its
    exact launches, 4 x 2 s against the CPU, and a 25 s utterance past
    B8's 2048 frames; returns (the launches, the audio)."""
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn
    from ppgs_tpu_torch.ops import stft

    counters = {'rel_attention': fa.rel_attention,
                'qkv_proj': elk.qkv_proj, 'attention': fa.attention,
                'out_proj_residual_ln': elk.out_proj_residual_ln,
                'ffn_residual_ln': fused_ffn.ffn_residual_ln,
                'fused_log_mel': stft.fused_log_mel}
    sr = head_config.sample_rate
    audio = 0.1 * torch.randn(BN_BATCH, 1, BN_SECONDS * sr, generator=gen,
                              device=dev)
    call = dict(representation='bottleneck', checkpoint=head_path,
                config=head_config)
    set_counts(counters)
    fa.position_term.calls = 0
    ppg = port.from_audio(audio, **call)
    launches, widths = read_counts(counters)
    print(f'launches in one bottleneck from_audio call: {launches}, by '
          f'width: {widths}; position_term calls: '
          f'{fa.position_term.calls}', flush=True)
    if fa.position_term.calls:
        raise AssertionError('the card\'s path formed the (B, H, T + 1, T) '
                             'position term')
    L, Ch = head_config.num_hidden_layers, head_config.hidden_channels
    d_h = Ch // head_config.attention_heads
    want = {'rel_attention': ccfg.num_blocks, 'qkv_proj': L, 'attention': L,
            'out_proj_residual_ln': L, 'ffn_residual_ln': L,
            'fused_log_mel': 0}
    want_widths = {'qkv_proj': {Ch: L}, 'attention': {d_h: L},
                   'out_proj_residual_ln': {Ch: L},
                   'ffn_residual_ln': {Ch: L}}
    if launches != want or widths != want_widths:
        raise AssertionError(f'bottleneck launches {launches} {widths}, not '
                             f'{want} {want_widths}')
    frames = BN_SECONDS * sr // head_config.hopsize
    check_ppg('bottleneck from_audio', ppg, audio,
              (BN_BATCH, head_config.output_channels, frames))

    short = audio[:BN_CPU_ROWS, :, :BN_CPU_SECONDS * sr]
    fp32 = head_config.replace(compute_dtype='float32')
    agree(f'bottleneck from_audio, {BN_CPU_ROWS} x {BN_CPU_SECONDS} s, '
          f'against device=cpu', port.from_audio(short, **call),
          port.from_audio(short.cpu(), device='cpu', **call),
          port.from_audio(short.cpu(), device='cpu',
                          **{**call, 'config': fp32}))

    # Past B8's 2048 frames the conformer runs its plain bf16 branch
    long_audio = 0.1 * torch.randn(1, 1, BN_LONG_SECONDS * sr, generator=gen,
                                   device=dev)
    set_counts(counters)
    long_ppg = port.from_audio(long_audio, **call)
    long_launches, _ = read_counts(counters)
    print(f'launches in one {BN_LONG_SECONDS} s bottleneck call: '
          f'{long_launches}', flush=True)
    if long_launches['rel_attention'] != 0:
        raise AssertionError('B8 launched past its 2048 frames')
    check_ppg(f'bottleneck from_audio, 1 x {BN_LONG_SECONDS} s', long_ppg,
              long_audio, (1, head_config.output_channels,
                           BN_LONG_SECONDS * sr // head_config.hopsize))
    return launches, audio


def check_ppg(name, ppg, audio, shape):
    """Raise unless ``ppg`` has ``shape``, lies on the audio's device, is
    finite and its columns sum to 1."""
    if tuple(ppg.shape) != shape:
        raise AssertionError(f'{name} shape {tuple(ppg.shape)}, not {shape}')
    if ppg.device != audio.device or not torch.isfinite(ppg).all():
        raise AssertionError(f'{name}: not finite or not on the card')
    col_err = (ppg.sum(dim=1) - 1).abs().max().item()
    if col_err > 1e-4:
        raise AssertionError(f'{name}: PPG columns do not sum to 1 '
                             f'({col_err})')


def conformer_work(ccfg, B, T):
    """Operations of the conformer on B x T frames: the products and convs,
    the position term's products among them (which B8 forms inside)."""
    d, f, H = ccfg.dim, ccfg.ffn_dim, ccfg.heads
    M, Fm = B * T, ccfg.input_dim
    embed = (2 * M * Fm * d * 25 + 2 * M * Fm * d * d * 25
             + 2 * M * d * Fm * d)
    per_block = (2 * 2 * (2 * M * d * f)            # the two FFNs
                 + 2 * M * d * 3 * d + 2 * M * d * d  # QKV, out
                 + 2 * B * H * T * (T + 1) * (d // H)  # bd
                 + 4 * B * H * T * T * (d // H)     # QK^T and PV
                 + 2 * M * d * 2 * d + 2 * M * d * ccfg.conv_kernel
                 + 2 * M * d * d)                   # the conv module
    return embed + ccfg.num_blocks * per_block


@torch.no_grad()
def bottleneck_times(port, model, ccfg, head_config, head_path, inputs, err,
                     launches, audio, card):
    """Phase 14: B8's time beside its plain version's, the library route's
    and its bound; the conformer whole; the slice end to end and its peak
    memory."""
    from ppgs_tpu_torch.ops import flash_attention as fa

    conformer = port.models.conformer
    q_u, k, v, q_v, pos, mask = (inputs[n] for n in ('q_u', 'k', 'v', 'q_v',
                                                     'pos', 'mask'))
    B, T, H, dk = q_u.shape
    scale = 1.0 / math.sqrt(dk)
    q4, k4, v4, qv4 = (t.transpose(1, 2) for t in (q_u, k, v, q_v))
    pos_z = F.pad(pos.transpose(0, 1)[None], (0, 0, 1, 0))

    def library_route():
        # The position term by cuBLAS, its shifted slice times the scale as
        # SDPA's bf16 mask (every key of the main path's rows is valid)
        bd = (qv4 @ pos_z.transpose(-1, -2)).view(B, H, T + 1, T)
        shifted = (bd[:, :, 1:].float() * scale).to(torch.bfloat16)
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=shifted,
                                              scale=scale)

    record = timed_record(
        'rel_attention', 'rel_attention.cu',
        'ppgs_tpu/ops/flash_attention.py:341', launches['rel_attention'], err,
        (lambda: fa.rel_attention(q_u, k, v, q_v, pos, mask, H),
         lambda: fa.rel_attention_reference(q_u, k, v, q_v, pos, mask, H),
         library_route),
        # QK^T, the position term and PV over the d_k = 36 columns; q_u,
        # k, v, q_v, the output, pos and the mask
        (6 * B * H * T * T * dk,
         5 * B * T * H * dk * 2 + T * H * dk * 2 + B * T), card,
        plain_reps=HEAVY_REPS)
    device_times('B8 rel_attention', record,
                 lambda: fa.rel_attention(q_u, k, v, q_v, pos, mask, H),
                 'the library route', card)

    # The conformer whole at 64 x 800 frames, with B8 and with its plain
    # version in its place
    feats = torch.randn(B, T, ccfg.input_dim, device=q_u.device)
    flens = torch.full((B,), T, device=q_u.device)
    whole_ms = time_ms(lambda: conformer.forward(model, feats, flens),
                       HEAVY_REPS, 1)
    kernel = fa.rel_attention
    fa.rel_attention = fa.rel_attention_reference
    try:
        plain_ms = time_ms(lambda: conformer.forward(model, feats, flens),
                           HEAVY_REPS, 1)
    finally:
        fa.rel_attention = kernel
    flops = conformer_work(ccfg, B, T)
    print(f'the {ccfg.num_blocks}-block conformer ({B} x {T}): {whole_ms:.4f} '
          f'ms with B8, {plain_ms:.4f} ms with its plain version; bound '
          f'{flops / PEAK_BF16_FLOPS * 1e3:.4f} ms of operations '
          f'({flops / 1e12:.3f} TFLOP) [{card}]', flush=True)
    # Its library yardstick: no one PyTorch call computes a conformer, so
    # the device time of its library calls (cuDNN convs, cuBLAS products)
    # and of the rest, by kernel, in one profiled forward
    report_groups('conformer forward', profile_call(
        f'conformer forward {B} x {T}',
        lambda: conformer.forward(model, feats, flens), card), card)
    del feats

    call = dict(representation='bottleneck', checkpoint=head_path,
                config=head_config)
    e2e_s = median_seconds(lambda: port.from_audio(audio, **call))
    print(f'bottleneck from_audio {BN_BATCH} x {BN_SECONDS} s: '
          f'{e2e_s * 1e3:.3f} ms, {BN_BATCH * BN_SECONDS / e2e_s:.1f} '
          f'audio-s/s (median of 5) [{card}]', flush=True)
    # The call's own peak: what it allocates above what the run holds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    port.from_audio(audio, **call)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    print(f'bottleneck from_audio {BN_BATCH} x {BN_SECONDS} s: peak device '
          f'memory of the call {peak / 2 ** 30:.4f} GiB above the '
          f'{held / 2 ** 30:.4f} GiB held [{card}]', flush=True)
    report_groups('bottleneck from_audio', profile_call(
        'bottleneck from_audio', lambda: port.from_audio(audio, **call),
        card), card)
    return [record]


def bottleneck_phases(port, workdir, dev, gen, card):
    """Phases 12-14: the bottleneck slice; returns B8's JSON record."""
    phase(f'12 B8 against its plain version ({BN_BATCH} x '
          f'{BN_SECONDS * 100}, T = {", ".join(map(str, BN_ODD_T))}; '
          f'd_k = {", ".join(str(d) for _, d in BN_WIDTHS)}) and the '
          f'conformer whole against the CPU')
    model, ccfg, head_config, head_path = bottleneck_setup(port, workdir, dev)
    err, inputs = bottleneck_kernel_checks(port, model, ccfg, dev, gen)
    phase(f'13 from_audio(representation=bottleneck): {BN_BATCH} x '
          f'{BN_SECONDS} s (main path)')
    launches, audio = bottleneck_main_path(port, ccfg, head_config,
                                           head_path, dev, gen, card)
    phase(f'14 bottleneck times on {card} (median of {REPS}, CUDA events)')
    return bottleneck_times(port, model, ccfg, head_config, head_path,
                            inputs, err, launches, audio, card)


# The api slice: 16 files of 0.3-20 s (7 past the 500-frame window, so
# chunked_forward runs), two of them against the CPU; the convolution
# model and the spectrogram at 64 x 8 s, 4 x 2 s against the CPU; the
# algebra and edits on the files' PPGs and a 64 x 40 x 800 batch, and the
# percentile once on 64 x 40 x 8000 (20.5 M elements, past 2^24)
API_SECONDS = (0.3, 0.7, 1.2, 1.9, 2.6, 3.3, 4.1, 4.9, 5.6, 6.4, 7.7, 9.0,
               11.3, 13.8, 16.6, 20.0)
API_CPU_FILES = (12, 15)            # 11.3 s and 20 s: 1130 and 2000 frames
CONV_BATCH, CONV_SECONDS = 64, 8
CONV_CPU_ROWS, CONV_CPU_SECONDS = 4, 2
ALG_B, ALG_T, ALG_LONG_T = 64, 800, 8000
# The algebra on the card against the CPU: elementwise results at atol
# 1e-6. The distance in fp64 at atol 1e-6, rtol 1e-8; in fp32 at rtol
# 1e-4, its per-frame values ('none') at atol 1e-3: the sqrt of a
# divergence term near 0 turns an ulp of the term into its square root
# (2^-12 of the term's scale), so two fp32 orders of the same sums differ
# by ~1e-4 a frame on near-uniform PPGs (5.73e-5 seen in the first run).
# Sparsified PPGs at rtol 2e-5 too: the softmax sums the dropped classes'
# 1e-8 terms into the kept mass S >= 1/40, which a sum in another order
# loses (up to 40 * 1e-8 / S = 1.6e-5 of a value).
ALG_ATOL, SPARSE_RTOL = 1e-6, 2e-5
DISTANCE_RTOL, DISTANCE_FRAME_ATOL, DISTANCE64_RTOL = 1e-4, 1e-3, 1e-8


def card_cpu(name, got, want, atol, rtol=0.0, quiet=False):
    """Raise unless |got - want| <= atol + rtol |want| everywhere (``got``
    from the card, ``want`` from the CPU); return the largest difference
    and, unless ``quiet``, print it."""
    got, want = got.detach().double().cpu(), want.detach().double()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f'{name}: shape {tuple(got.shape)} against '
                             f'{tuple(want.shape)}, or non-finite values')
    err = (got - want).abs()
    worst = err.max().item() if err.numel() else 0.0
    if not quiet:
        print(f'{name}: max |card - cpu| = {worst:.3g} (atol {atol}, rtol '
              f'{rtol})', flush=True)
    if (err > atol + rtol * want.abs()).any():
        raise AssertionError(f'{name}: the card disagrees with the cpu')
    return worst


def reference_state_dict(params, config):
    """The reference architecture's state dict (ppgs/model/transformer.py:
    ``input_layer``, ``model`` an ``nn.TransformerEncoder`` of
    ``nn.TransformerEncoderLayer``, ``output_layer``) holding ``params``,
    JAX-layout transformer weights: a .pt checkpoint as the published ones
    are laid out."""
    C, k = config.hidden_channels, config.kernel_size
    reference = torch.nn.Module()
    reference.input_layer = torch.nn.Conv1d(config.input_channels, C, k)
    reference.model = torch.nn.TransformerEncoder(
        torch.nn.TransformerEncoderLayer(C, config.attention_heads,
                                         config.ffn_channels),
        config.num_hidden_layers, enable_nested_tensor=False)
    reference.output_layer = torch.nn.Conv1d(C, config.output_channels, k)

    def t(array):
        return torch.from_numpy(np.ascontiguousarray(array))

    state = {}
    for name, conv in (('input_layer', 'input_conv'),
                       ('output_layer', 'output_conv')):
        state[f'{name}.weight'] = t(params[conv]['weight'].transpose(2, 1, 0))
        state[f'{name}.bias'] = t(params[conv]['bias'])
    for i, layer in enumerate(params['layers']):
        p, a, f = f'model.layers.{i}.', layer['attn'], layer['ffn']
        state[p + 'self_attn.in_proj_weight'] = t(np.concatenate(
            [a[f'w{n}'].T for n in 'qkv']))
        state[p + 'self_attn.in_proj_bias'] = t(np.concatenate(
            [a[f'b{n}'] for n in 'qkv']))
        state[p + 'self_attn.out_proj.weight'] = t(a['wo'].T)
        state[p + 'self_attn.out_proj.bias'] = t(a['bo'])
        state[p + 'linear1.weight'] = t(f['w1'].T)
        state[p + 'linear1.bias'] = t(f['b1'])
        state[p + 'linear2.weight'] = t(f['w2'].T)
        state[p + 'linear2.bias'] = t(f['b2'])
        for norm in ('norm1', 'norm2'):
            state[f'{p}{norm}.weight'] = t(layer[norm]['scale'])
            state[f'{p}{norm}.bias'] = t(layer[norm]['bias'])
    reference.load_state_dict(state, strict=True)
    return reference.state_dict()


def api_files(port, config, workdir, card):
    """Phase 15: from_files_to_files and the CLI on 16 seeded wav files,
    from the .npz and the .pt of one set of seeded weights; returns the
    files' PPGs (on the card)."""
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    workdir = Path(workdir)
    params = random_params(port, config, SEED)       # phase 4's weights
    npz, pt = workdir / 'api-mel.npz', workdir / 'api-mel.pt'
    port.load.save_params(npz, params)
    torch.save({'model': reference_state_dict(params, config)}, pt)
    wav_dir = workdir / 'api-wavs'
    wav_dir.mkdir()
    rng = np.random.default_rng(SEED + 15)
    wavs = []
    for i, seconds in enumerate(API_SECONDS):
        wavs.append(wav_dir / f'utt{i:02d}.wav')
        port.data.audio.save_wav(wavs[-1], (0.1 * rng.standard_normal(
            (1, int(seconds * config.sample_rate)))).astype(np.float32))
    outs = [workdir / f'{w.stem}.npy' for w in wavs]
    pt_outs = [workdir / f'{w.stem}-pt.npy' for w in wavs]

    counters = {'qkv_proj': elk.qkv_proj, 'attention': fa.attention,
                'out_proj_residual_ln': elk.out_proj_residual_ln,
                'ffn_residual_ln': fused_ffn.ffn_residual_ln}
    set_counts(counters)
    port.from_files_to_files(wavs, outs, checkpoint=npz)
    launches, _ = read_counts(counters)
    print(f'launches in one from_files_to_files call ({len(wavs)} files): '
          f'{launches}', flush=True)
    if min(launches.values()) == 0:
        raise AssertionError(f'a kernel of the main path never launched: '
                             f'{launches}')

    ppgs = []
    for wav, out, seconds in zip(wavs, outs, API_SECONDS):
        got = torch.from_numpy(np.load(out))
        frames = port.ops.stft.frame_count(int(seconds * config.sample_rate),
                                           config.num_fft, config.hopsize)
        want = port.from_file(wav, checkpoint=npz)
        if (tuple(got.shape) != (config.output_channels, frames)
                or not torch.equal(got, want.cpu())):
            raise AssertionError(f'{out.name}: from_files_to_files is not '
                                 f'from_file on the card bit for bit')
        ppgs.append(want)
    print(f'from_files_to_files: each of the {len(wavs)} outputs equals '
          f'from_file bit for bit', flush=True)
    port.from_files_to_files(wavs, pt_outs, checkpoint=pt)
    for out, pt_out in zip(outs, pt_outs):
        if not np.array_equal(np.load(out), np.load(pt_out)):
            raise AssertionError(f'{pt_out.name}: the .pt route is not the '
                                 f'.npz route bit for bit')
    print('from_files_to_files from the .pt checkpoint: bit for bit the '
          '.npz route', flush=True)
    for i in API_CPU_FILES:
        agree(f'{wavs[i].name} ({API_SECONDS[i]} s) against device=cpu',
              ppgs[i][None],
              port.from_file(wavs[i], checkpoint=npz, device='cpu')[None],
              port.from_file(wavs[i], checkpoint=npz, device='cpu',
                             config=config.replace(
                                 compute_dtype='float32'))[None])

    cli = [sys.executable, '-m', 'ppgs_tpu_torch', '--input_paths',
           str(wav_dir), '--checkpoint', str(npz)]
    start = time.perf_counter()
    result = subprocess.run(cli, cwd=Path(__file__).resolve().parent,
                            capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - start
    if result.returncode:
        raise AssertionError(f'python -m ppgs_tpu_torch exited '
                             f'{result.returncode}:\n{result.stderr}')
    for wav, out in zip(wavs, outs):
        written = wav.with_name(wav.stem + '-ppg.npy')
        if not np.array_equal(np.load(written), np.load(out)):
            raise AssertionError(f'{written.name}: the CLI is not the API '
                                 f'bit for bit')
    print(f'python -m ppgs_tpu_torch wrote {len(wavs)} <stem>-ppg.npy '
          f'files, each the API\'s bit for bit', flush=True)

    audio_s = sum(API_SECONDS)
    loop_s = median_seconds(
        lambda: port.from_files_to_files(wavs, outs, checkpoint=npz), reps=3)
    print(f'from_files_to_files on {len(wavs)} files ({audio_s:.1f} audio-s): '
          f'{loop_s * 1e3:.3f} ms (median of 3), {audio_s / loop_s:.1f} '
          f'audio-s/s [{card}]', flush=True)
    print(f'the CLI (a new process: start, model load, {len(wavs)} files): '
          f'{cli_s:.3f} s wall [{card}]', flush=True)
    return ppgs


def api_models(port, workdir, dev, gen, card):
    """Phase 16: the convolution model through from_audio and the
    spectrogram frontend, each at 64 x 8 s on the card and 4 x 2 s against
    the CPU; returns the convolution model's PPGs."""
    conv_config = port.config.get('convolution')
    npz = Path(workdir) / 'api-convolution.npz'
    port.load.save_params(npz, port.models.convolution.init(
        conv_config, torch.Generator().manual_seed(SEED + 16)))
    samples = CONV_SECONDS * conv_config.sample_rate
    audio = 0.1 * torch.randn(CONV_BATCH, 1, samples, generator=gen,
                              device=dev)
    small = audio[:CONV_CPU_ROWS, :, :CONV_CPU_SECONDS
                  * conv_config.sample_rate].contiguous()
    frames = port.ops.stft.frame_count(samples, conv_config.num_fft,
                                       conv_config.hopsize)

    def conv_call():
        return port.from_audio(audio, checkpoint=npz, config=conv_config)

    ppg = conv_call()
    check_ppg('convolution from_audio', ppg, audio,
              (CONV_BATCH, conv_config.output_channels, frames))
    card_cpu(f'convolution from_audio {CONV_CPU_ROWS} x {CONV_CPU_SECONDS} s',
             port.from_audio(small, checkpoint=npz, config=conv_config),
             port.from_audio(small.cpu(), checkpoint=npz, config=conv_config,
                             device='cpu'), atol=1e-4, rtol=1e-4)
    conv_s = median_seconds(conv_call)

    spectrogram = port.preprocess.get('spectrogram')
    mags = spectrogram.from_audios(audio)
    if (tuple(mags.shape) != (CONV_BATCH, conv_config.num_fft // 2 + 1,
                              frames)
            or mags.device != audio.device or not torch.isfinite(mags).all()):
        raise AssertionError(f'spectrogram: shape {tuple(mags.shape)}, not '
                             f'finite or not on the card')
    card_cpu(f'spectrogram {CONV_CPU_ROWS} x {CONV_CPU_SECONDS} s',
             spectrogram.from_audios(small),
             spectrogram.from_audios(small.cpu(), device='cpu'),
             atol=1e-4, rtol=1e-4)
    spec_s = median_seconds(lambda: spectrogram.from_audios(audio))
    audio_s = CONV_BATCH * CONV_SECONDS
    print(f'convolution from_audio {CONV_BATCH} x {CONV_SECONDS} s: '
          f'{conv_s * 1e3:.3f} ms (median of 5), {audio_s / conv_s:.1f} '
          f'audio-s/s; spectrogram: {spec_s * 1e3:.3f} ms (median of 5) '
          f'[{card}]', flush=True)
    return ppg


def kept(out):
    """The classes a sparsified frame kept: a dropped class comes out as
    1e-8 / S <= 5e-7 (S, the kept mass, is above 0.02 at these
    thresholds), a kept one at least as its probability, above 1e-6 in
    these PPGs."""
    return out > 1e-6


def held(tally, who, label, got, want, atol, rtol=0.0):
    """``card_cpu`` on ``who``'s ``label``, quietly; ``tally`` keeps the
    largest difference and the count of each (label, atol, rtol)."""
    worst = card_cpu(f'{who} {label}', got, want, atol, rtol, quiet=True)
    top, count = tally.get((label, atol, rtol), (0.0, 0))
    tally[label, atol, rtol] = (max(top, worst), count + 1)


def sparsify_checks(tally, name, ppg):
    """sparsify by each method on the card against the CPU: the kept
    classes exactly, the values at ALG_ATOL and SPARSE_RTOL."""
    from ppgs_tpu_torch.ops import algebra

    for method, threshold in (('constant', 0.02), ('percentile', 0.85),
                              ('topk', 3)):
        got = algebra.sparsify(ppg, method, threshold)
        want = algebra.sparsify(ppg.cpu(), method, threshold)
        if not torch.equal(kept(got).cpu(), kept(want)):
            raise AssertionError(f'{name} sparsify {method}: the kept '
                                 f'classes differ from the cpu\'s')
        held(tally, name, f'sparsify {method} {threshold} (kept classes '
             f'exact)', got, want, ALG_ATOL, SPARSE_RTOL)


def edit_checks(tally, name, ppg):
    """Every edit and the grid functions on a (40, T) PPG on the card
    against the same on its CPU copy: argmax spans and the frames an edit
    changed exactly, the values at ALG_ATOL; the grids within an ulp of
    T - 1."""
    from ppgs_tpu_torch import edit
    from ppgs_tpu_torch.edit import grid
    from ppgs_tpu_torch.phonemes import PHONEMES

    cpu = ppg.cpu()
    runs = torch.unique_consecutive(cpu.argmax(0))
    pattern = [PHONEMES[int(i)] for i in runs[:2]]
    targets = [PHONEMES[(int(i) + 7) % len(PHONEMES)] for i in runs[:2]]
    spans = edit.regex_find(ppg, pattern)
    if not spans or spans != edit.regex_find(cpu, pattern):
        raise AssertionError(f'{name} regex_find {pattern}: {spans} on the '
                             f'card, other spans on the cpu')
    cases = (('reallocate', ('aa', 'iy')), ('reallocate', ('s', 'z', 0.01)),
             ('swap', ('f', 'v')), ('shift', ('sh', 0.3)),
             ('shift', ('m', -0.1)), ('regex', (pattern, targets)),
             ('regex', (pattern, targets, True)))
    for (fn, args), label in zip(cases, (
            "reallocate('aa', 'iy')", "reallocate('s', 'z', 0.01)",
            "swap('f', 'v')", "shift('sh', 0.3)", "shift('m', -0.1)",
            'regex (swap the first two runs)',
            'regex (reallocate the first two runs)')):
        got = getattr(edit, fn)(ppg, *args)
        want = getattr(edit, fn)(cpu, *args)
        if not torch.equal((got != ppg).any(0).cpu(), (want != cpu).any(0)):
            raise AssertionError(f'{name} {fn}{args}: it changed other '
                                 f'frames on the card')
        held(tally, name, f'{label} (changed frames exact)', got, want,
             ALG_ATOL)
    if not torch.equal(ppg.cpu(), cpu):
        raise AssertionError(f'{name}: an edit wrote its input')
    T = ppg.shape[-1]
    ulp = float(np.spacing(np.float32(T - 1)))
    for label, g, g_cpu in (
            ('of_length 2T - 1', grid.of_length(ppg, 2 * T - 1),
             grid.of_length(cpu, 2 * T - 1)),
            ('constant 0.8', grid.constant(ppg, 0.8),
             grid.constant(cpu, 0.8)),
            ('constant 1.25', grid.constant(ppg, 1.25),
             grid.constant(cpu, 1.25))):
        held(tally, name, f'grid {label} (within an ulp of T - 1)', g, g_cpu,
             ulp)
        held(tally, name, f'grid.sample on the {label} grid',
             grid.sample(ppg, g), grid.sample(cpu, g.cpu()), ALG_ATOL)


def api_algebra(ppgs, dev, gen, card):
    """Phase 17: distance, interpolate, sparsify, the edits and the grids
    on the card against the CPU, on phase 15's PPGs and a seeded 64 x 40 x
    800 batch; sparsify's percentile on 64 x 40 x 8000; the distance and
    sparsify timed."""
    from ppgs_tpu_torch.edit import grid
    from ppgs_tpu_torch.ops import algebra

    def batch(T):
        logits = 3 * torch.randn(ALG_B, 40, T, generator=gen, device=dev)
        return torch.softmax(logits, dim=1)

    x, y = batch(ALG_T), batch(ALG_T)
    tally = {}
    # Each file's PPG beside the next one's resampled to its length
    pairs = [(f'file {i}', p, grid.sample(q, grid.of_length(q, p.shape[-1])))
             for i, (p, q) in enumerate(zip(ppgs, ppgs[1:] + ppgs[:1]))]
    pairs.append((f'batch {ALG_B} x 40 x {ALG_T}', x, y))
    for name, p, q in pairs:
        for normalize, reduction in itertools.product(
                (True, False), ('mean', 'sum', 'none')):
            label = f'distance normalize={normalize} {reduction}'
            p64, q64 = p.double(), q.double()
            held(tally, name, f'{label} (fp64)',
                 algebra.distance(p64, q64, reduction, normalize),
                 algebra.distance(p64.cpu(), q64.cpu(), reduction,
                                  normalize), ALG_ATOL, DISTANCE64_RTOL)
            held(tally, name, label,
                 algebra.distance(p, q, reduction, normalize),
                 algebra.distance(p.cpu(), q.cpu(), reduction, normalize),
                 DISTANCE_FRAME_ATOL if reduction == 'none' else ALG_ATOL,
                 DISTANCE_RTOL)
        t = torch.rand(p.shape[-1], generator=gen, device=dev)
        for label, interp, interp_cpu in (('0.3', 0.3, 0.3),
                                          ('per frame', t, t.cpu())):
            held(tally, name, f'interpolate {label}',
                 algebra.interpolate(p, q, interp),
                 algebra.interpolate(p.cpu(), q.cpu(), interp_cpu), ALG_ATOL)
        sparsify_checks(tally, name, p)
    for i in API_CPU_FILES:
        edit_checks(tally, f'file {i}', ppgs[i])
    # The batch's frames laid end to end as one (40, 51,200) PPG
    edit_checks(tally, f'batch frames (40, {ALG_B * ALG_T})',
                x.permute(1, 0, 2).reshape(40, -1))
    for (label, atol, rtol), (worst, count) in tally.items():
        print(f'{label}: max |card - cpu| = {worst:.3g} over {count} PPGs '
              f'(atol {atol:.3g}, rtol {rtol})', flush=True)
    long = batch(ALG_LONG_T)
    out = algebra.sparsify(long, 'percentile', 0.85)
    col = (out.sum(dim=1) - 1).abs().max().item()
    if not torch.isfinite(out).all() or col > 1e-4:
        raise AssertionError(f'sparsify percentile on {tuple(long.shape)}: '
                             f'not finite or columns off 1 by {col}')
    want = algebra.sparsify(long[:1].cpu(), 'percentile', 0.85)
    if not torch.equal(kept(out[:1]).cpu(), kept(want)):
        raise AssertionError('sparsify percentile on the long batch: the '
                             'kept classes of row 0 differ from the cpu\'s')
    card_cpu(f'sparsify percentile 0.85 on {tuple(long.shape)} '
             f'({long.numel():,} elements), row 0', out[:1], want, ALG_ATOL,
             SPARSE_RTOL)
    del long, out

    for label, fn in (
            ('distance normalize=True mean',
             lambda: algebra.distance(x, y)),
            ('distance normalize=False none',
             lambda: algebra.distance(x, y, 'none', False)),
            ('sparsify percentile 0.85', lambda: algebra.sparsify(x)),
            ('sparsify topk 3', lambda: algebra.sparsify(x, 'topk', 3)),
            ('sparsify constant 0.02',
             lambda: algebra.sparsify(x, 'constant', 0.02))):
        print(f'{label} on {ALG_B} x 40 x {ALG_T}: {time_ms(fn):.4f} ms '
              f'(median of {REPS}, CUDA events) [{card}]', flush=True)


def api_phases(port, config, workdir, dev, gen, card):
    """Phases 15-17: the api slice (no kernel of its own: the file loop
    runs K1-K4)."""
    phase(f'15 from_files_to_files and the CLI: {len(API_SECONDS)} files of '
          f'{API_SECONDS[0]}-{API_SECONDS[-1]} s, from .npz and .pt (main '
          f'path)')
    ppgs = api_files(port, config, workdir, card)
    phase(f'16 the convolution model and the spectrogram: {CONV_BATCH} x '
          f'{CONV_SECONDS} s')
    api_models(port, workdir, dev, gen, card)
    phase(f'17 algebra and editing: the files\' PPGs, {ALG_B} x 40 x '
          f'{ALG_T}, percentile on {ALG_B} x 40 x {ALG_LONG_T}')
    api_algebra(ppgs, dev, gen, card)


###############################################################################
# The data slice (phases 18-20)
###############################################################################

# A seeded corpus named commonvoice: 400 wav files of 0.5-10 s (~35 min),
# each with a TextGrid of seeded phoneme intervals
DATA_FILES, DATA_SECONDS = 400, (0.5, 10.0)
# train() from it: 12 steps (4 epochs of 3 batches at the mel config's
# 150,000 frames), then a resume for 2; every batch's longest utterance is
# past 9 s, so T = 1000 (the whole-layer path). A second run with the
# train partition in 5 length-sorted buckets takes batches of T = 300-900
# (T % 8 != 0: the per-layer path) and one of 1000
DATA_STEPS, DATA_RESUME = 12, 2
DATA_BUCKETS, DATA_BUCKET_STEPS = 5, 5
DATA_CPU = 8                     # caches and files held against the CPU
DATA_WORKERS = 4
DATA_REPS = 3
DATA_DIRS = ('CACHE_DIR', 'PARTITION_DIR', 'CLASS_WEIGHT_FILE', 'EVAL_DIR',
             'RUNS_DIR')


def point_data_dirs(port, root):
    """Point the port's data directories (DATA_DIRS) into ``root`` and send
    no notification; returns their values, which the caller puts back."""
    saved = {name: getattr(port.config, name) for name in DATA_DIRS}
    for name, path in zip(DATA_DIRS, ('cache', 'partitions',
                                      'phoneme_weights.npz', 'eval', 'runs')):
        setattr(port.config, name, root / path)
    os.environ.pop('PPGS_NOTIFICATION_URL', None)   # no message is sent
    return saved


def assets_digest():
    """The sha256 of every file under ppgs_tpu/assets/ (read as bytes)."""
    root = Path(__file__).resolve().parent / 'ppgs_tpu' / 'assets'
    return {str(path.relative_to(root)):
            hashlib.sha256(path.read_bytes()).hexdigest()
            for path in sorted(root.rglob('*')) if path.is_file()}


def data_alignment(port, duration, rng):
    """Seeded phoneme intervals over [0, duration] (the 40 phonemes,
    silence among them), in words of 1-4 phonemes."""
    textgrid = port.data.textgrid
    cuts = np.sort(rng.uniform(0, duration, max(1, int(duration / 0.08))))
    edges = np.concatenate([[0.0], cuts, [duration]])
    labels = rng.integers(0, len(port.PHONEMES), len(edges) - 1)
    phones = [textgrid.Phoneme(port.PHONEMES[label], float(a), float(b))
              for label, a, b in zip(labels, edges[:-1], edges[1:])]
    words, i = [], 0
    while i < len(phones):
        n = int(rng.integers(1, 5))
        words.append(textgrid.Word(f'w{i}', phones[i:i + n]))
        i += n
    return textgrid.Alignment(words)


def data_corpus(port, config, cache, files=DATA_FILES):
    """Write the corpus of ``files`` files; returns {stem: samples}."""
    rng = np.random.default_rng(SEED + 18)
    seconds = rng.uniform(*DATA_SECONDS, files)
    cache.mkdir(parents=True)
    samples = {}
    for i, s in enumerate(seconds):
        stem, n = f'cv{i:04d}', int(s * config.sample_rate)
        t = np.arange(n) / config.sample_rate
        tones = rng.uniform(80, 4000, 3)[:, None]
        gains = rng.uniform(0.02, 0.2, 3)[:, None]
        phases = rng.uniform(0, 2 * np.pi, 3)[:, None]
        audio = ((gains * np.sin(2 * np.pi * tones * t + phases)).sum(0)
                 + 0.02 * rng.standard_normal(n))
        port.data.audio.save_wav(cache / f'{stem}.wav',
                                 audio[None].astype(np.float32),
                                 config.sample_rate)
        data_alignment(port, n / config.sample_rate, rng).save(
            cache / f'{stem}.TextGrid')
        samples[stem] = n
    return samples


def data_native_reader(port, cache):
    """The port's native WAV reader built from its own source, and its
    samples those of the Python reader."""
    start = time.perf_counter()
    if not port.native.available():
        raise AssertionError('the native WAV reader did not build')
    print(f'native WAV reader: {port.native.library_path()} (g++, '
          f'{time.perf_counter() - start:.1f} s)', flush=True)
    files = sorted(cache.glob('*.wav'))[:DATA_CPU]
    arena, lengths = port.data.audio.load_batch(files, num_threads=4)
    for row, n, f in zip(arena, lengths, files):
        samples, _ = port.data.audio.load_wav(f)
        if (n != samples.shape[-1] or not np.array_equal(row[0, :n], samples[0])
                or not np.array_equal(port.native.wav_read(f)[0],
                                      samples[0])):
            raise AssertionError(f'{f.name}: the native reader differs from '
                                 f'the Python reader')
    print(f'native wav_read and load_batch on {len(files)} files: the Python '
          f'reader\'s samples exactly', flush=True)


def data_partitions_and_weights(port, config, cache, samples):
    """partition.datasets against the seeded shuffle recomputed, and the
    computed phoneme weights against a numpy bincount of the train
    partition's framewise targets; returns the partition."""
    import random

    port.partition.datasets(['commonvoice'])
    got = port.load.partition('commonvoice')
    stems = sorted(samples)
    random.seed(config.random_seed)
    random.shuffle(stems)
    left, right = int(0.8 * len(stems)), int(0.9 * len(stems))
    want = {'train': sorted(stems[:left]), 'valid': sorted(stems[left:right]),
            'test': sorted(stems[right:])}
    if got != want:
        raise AssertionError('partition.datasets is not the seeded 80/10/10 '
                             'split')
    print(f'partition.datasets: train / valid / test = '
          f'{[len(got[p]) for p in ("train", "valid", "test")]}, the seeded '
          f'split recomputed', flush=True)

    weights = port.load.phoneme_weights(config).numpy()
    counts = np.zeros(config.output_channels, np.int64)
    hop = config.hopsize / config.sample_rate
    for stem in got['train']:
        alignment = port.data.textgrid.Alignment(cache / f'{stem}.TextGrid')
        phones = list(alignment.phonemes())
        frames = samples[stem] // config.hopsize
        times = np.linspace(hop / 2, (frames - 1) * hop + hop / 2, frames)
        times[-1] = alignment.duration()
        at = np.minimum(np.searchsorted([p.end for p in phones], times,
                                        side='right'), len(phones) - 1)
        labels = np.array([port.PHONEME_TO_INDEX_MAPPING[p.phoneme]
                           for p in phones])
        counts += np.bincount(labels[at], minlength=config.output_channels)
    want = (counts.min() / np.maximum(counts, 1)).astype(np.float32)
    with np.load(port.config.CLASS_WEIGHT_FILE) as saved:
        written = saved['weights']
    if not (np.array_equal(weights, want) and np.array_equal(written, want)):
        raise AssertionError('load.phoneme_weights differs from a bincount '
                             'of the train partition')
    print(f'load.phoneme_weights: computed from {counts.sum():,} train '
          f'frames and written, equal to a numpy bincount (min weight '
          f'{want.min():.4f})', flush=True)
    return got


# Caches of the card against the CPU's: the fp32 frontends agree within
# MEL_ATOL, and a float16 save rounds each side once, so a value may be
# one float16 ulp apart beyond that; near 0 (a mel energy near 1) an ulp
# is far below MEL_ATOL
MEL_ATOL = 1e-4


def fp16_apart(got, want):
    """|got - want| of two float16 arrays as (its largest value, the
    largest in float16 ulps of want, the share of values more than one ulp
    apart, the most any value exceeds one ulp + MEL_ATOL)."""
    want32 = want.astype(np.float32)
    err = np.abs(got.astype(np.float32) - want32)
    ulp = np.spacing(np.abs(want)).astype(np.float32)
    return (float(err.max()), float((err / ulp).max()),
            float((err > ulp).mean()), float((err - ulp - MEL_ATOL).max()))


def data_caches(port, config, root, cache, samples, card):
    """preprocess.datasets on the card; every cache's shape and dtype; the
    first batches (>= DATA_CPU files) against the same batches through
    preprocess.from_dataloader with device='cpu', at one fp16 ulp."""
    start = time.perf_counter()
    port.preprocess.datasets(['commonvoice'], ['mel'], config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    for stem, n in samples.items():
        cached = np.load(cache / f'{stem}-mel.npy')
        if (cached.shape != (config.num_mels, n // config.hopsize)
                or cached.dtype != np.float16
                or not np.isfinite(cached).all()):
            raise AssertionError(f'{stem}-mel.npy: {cached.shape} '
                                 f'{cached.dtype}, or not finite')
    audio_s = sum(samples.values()) / config.sample_rate
    print(f'preprocess.datasets(mel) on the card: {len(samples)} caches '
          f'(80, frames) float16, {wall:.3f} s wall, {audio_s / wall:.1f} '
          f'audio-s/s [{card}]', flush=True)

    features = ['audio', 'length', 'audio_file']
    files = port.data.Dataset('commonvoice', None, features,
                              config=config).audio_files
    loader = port.data.loader(files, features=features, num_workers=0,
                              max_frames=config.max_preprocess_frames,
                              config=config)
    batches = []
    for batch in loader.batch_sampler:
        batches.append(batch)
        if sum(map(len, batches)) >= DATA_CPU:
            break
    cpu = root / 'cpu-caches'
    cpu.mkdir()
    port.preprocess.from_dataloader(
        port.data.Loader(loader.dataset, batches, port.data.Collate(features),
                         num_workers=0),
        {str(f): cpu / f.stem for f in files}, ['mel'], config=config,
        device='cpu')
    got = np.concatenate([np.load(cache / f'{files[i].stem}-mel.npy')
                          for i in itertools.chain(*batches)], -1)
    want = np.concatenate([np.load(cpu / f'{files[i].stem}-mel.npy')
                           for i in itertools.chain(*batches)], -1)
    err, ulps, share, over = fp16_apart(got, want)
    print(f'{sum(map(len, batches))} caches of the first {len(batches)} '
          f'batches against device=cpu on the same batches ({got.size:,} '
          f'values): max |card - cpu| {err:.3g}, {ulps:.3g} float16 ulps; '
          f'{share:.3g} of the values more than one ulp apart; every value '
          f'within one ulp + {MEL_ATOL}', flush=True)
    if over > 0:
        raise AssertionError(f'a cache value of the card is {over:.3g} past '
                             f'one float16 ulp + {MEL_ATOL} from the cpu\'s')


def recording_steps(core, steps, counters):
    """Make ``core.make_train_step`` hand out steps that record (T, the
    batch's lengths, the train kernels' launches in the step, the loss);
    returns the original, to be put back."""
    original = core.make_train_step

    def make_train_step(*args, **kwargs):
        step = original(*args, **kwargs)

        def recorded(features, targets, lengths, *rest, **kw):
            before = {n: f.launches for n, f in counters.items()}
            train_loss, stats = step(features, targets, lengths, *rest, **kw)
            steps.append((features.shape[-1], tuple(lengths.tolist()),
                          {n: f.launches - before[n]
                           for n, f in counters.items()},
                          float(train_loss)))
            return train_loss, stats
        return recorded

    core.make_train_step = make_train_step
    return original


def check_data_steps(port, config, label, steps):
    """Each step's launches exactly those of its path (the whole-layer
    kernel takes T % 8 == 0 up to its longest T); the losses finite.
    Returns the steps on each path."""
    L = config.num_hidden_layers
    longest = port.models.transformer.TRAIN_KERNEL_MAX_T
    paths = {'whole-layer': 0, 'per-layer': 0}
    for i, (T, lengths, launches, loss) in enumerate(steps):
        path = ('whole-layer' if T % 8 == 0 and T <= longest
                else 'per-layer')
        paths[path] += 1
        per_layer = B4_PER_LAYER if path == 'whole-layer' else SPLIT_PER_LAYER
        want = {name: L * n for name, n in per_layer.items()}
        print(f'  {label} step {i}: {len(lengths)} x T={T} ({path}), loss '
              f'{loss:.5f}', flush=True)
        if launches != want or not math.isfinite(loss):
            raise AssertionError(f'{label} step {i} (T={T}, {path}): '
                                 f'launches {launches}, not {want}, or loss '
                                 f'{loss}')
    return paths


def data_batch_order(port, config, count):
    """The train loader's first ``count`` (or more) batches, as their
    lengths, epoch after epoch, and the batches in each epoch."""
    loader = port.data.loader('commonvoice', 'train', config=config)
    lengths = loader.dataset.lengths
    order, sizes = [], []
    for epoch in itertools.count():
        if len(order) >= count:
            break
        loader.batch_sampler.set_epoch(epoch)
        batches = list(loader.batch_sampler)
        sizes.append(len(batches))
        order += [tuple(lengths[i] for i in b) for b in batches]
    return order, sizes


def data_train(port, config, root, card):
    """Phase 19, training: train('commonvoice') with its default loaders on
    the card, a resume, and a run in length buckets (the per-layer path);
    returns the first run's last checkpoint."""
    counters = train_counters()
    core = port.train.core
    steps = []
    run = root / 'runs' / 'mel'
    original = recording_steps(core, steps, counters)
    try:
        start = time.perf_counter()
        port.train.train('commonvoice', run, config=config,
                         max_steps=DATA_STEPS)
        torch.cuda.synchronize()
        first = time.perf_counter() - start
        first_steps = list(steps)
        start = time.perf_counter()
        port.train.train('commonvoice', run, config=config,
                         max_steps=DATA_STEPS + DATA_RESUME)
        torch.cuda.synchronize()
        resumed = time.perf_counter() - start
        resumed_steps = steps[DATA_STEPS:]
        del steps[:]
        bucket_config = config.replace(buckets=DATA_BUCKETS)
        start = time.perf_counter()
        port.train.train('commonvoice', root / 'runs' / 'buckets',
                         config=bucket_config, max_steps=DATA_BUCKET_STEPS)
        torch.cuda.synchronize()
        bucketed = time.perf_counter() - start
        bucket_steps = list(steps)
    finally:
        core.make_train_step = original

    frames = sum(sum(lengths) for _, lengths, _, _ in first_steps)
    print(f'train(\'commonvoice\') with the default loaders: {DATA_STEPS} '
          f'steps ({frames:,} frames, {frames / 100:.1f} audio-s) with an '
          f'evaluation at step 0 and a checkpoint, {first:.3f} s wall; the '
          f'resume ({DATA_RESUME} steps) {resumed:.3f} s; {DATA_BUCKETS} '
          f'buckets ({DATA_BUCKET_STEPS} steps) {bucketed:.3f} s [{card}]',
          flush=True)
    paths = check_data_steps(port, config, 'run',
                             first_steps + resumed_steps)
    bucket_paths = check_data_steps(port, config, 'buckets', bucket_steps)
    total = {p: paths[p] + bucket_paths[p] for p in paths}
    print(f'train steps by path: the run {paths}, the bucketed run '
          f'{bucket_paths}; in all {total}', flush=True)
    if min(total.values()) == 0:
        raise AssertionError(f'a train path took no step: {total}')

    records = [json.loads(line) for line in
               (run / 'metrics.jsonl').read_text().splitlines()]
    valid = [r for r in records if 'valid/loss' in r]
    if ([r['step'] for r in valid] != [0]
            or not math.isfinite(valid[0]['valid/loss'])):
        raise AssertionError(f'the valid evaluation is not at step 0 alone, '
                             f'or not finite: {valid}')
    meta = json.loads((run / f'{DATA_STEPS:08d}.json').read_text())
    order, sizes = data_batch_order(port, config, DATA_STEPS + DATA_RESUME)
    print(f'valid/loss at step 0: {valid[0]["valid/loss"]:.5f}; '
          f'{DATA_STEPS:08d}.npz at epoch {meta["epoch"]}; batches per '
          f'epoch {sizes}', flush=True)
    taken = [lengths for _, lengths, _, _ in first_steps + resumed_steps]
    boundary = DATA_STEPS in itertools.accumulate(sizes)
    if not boundary or taken != order[:DATA_STEPS + DATA_RESUME]:
        raise AssertionError('the run and its resume did not take the '
                             'batches of an uninterrupted run (or the first '
                             'run did not end on an epoch)')
    print(f'the resume\'s first batch is batch {DATA_STEPS} of an '
          f'uninterrupted run (epoch {meta["epoch"]}\'s first), and all '
          f'{len(taken)} batches are the loader\'s epoch by epoch',
          flush=True)
    return core.latest_checkpoint(run)


def inference_counters():
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    return {'qkv_proj': elk.qkv_proj, 'attention': fa.attention,
            'out_proj_residual_ln': elk.out_proj_residual_ln,
            'ffn_residual_ln': fused_ffn.ffn_residual_ln}


# Batched against batch-1 evaluation on the card. In fp32 (plain PyTorch)
# the logits agree to fp32 rounding: the counts exactly, the float sums
# within rtol 1e-6. In bf16 (K1-K4) cuDNN picks its bf16 convs' algorithm
# by batch size, so a logit may round an ulp the other way: the loss and
# JSD sums within EVAL_BF16_RTOL, and the true positives may move by the
# frames whose top two phonemes bf16 does not separate (at most
# EVAL_BF16_FLIPS of the frames, the bf16 argmax envelope)
EVAL_BF16_RTOL, EVAL_BF16_FLIPS = 1e-4, 5e-3


def eval_apart(name, got, want, exact_floats, rtol):
    """(the largest relative difference of the float sums compared, the
    true positives that moved); raises unless the target counts are equal
    and the floats (all of them when ``exact_floats``, else the loss and
    the JSD) agree within ``rtol``."""
    if set(got) != set(want):
        raise AssertionError(f'{name}: other keys batched')
    worst, moved = 0.0, 0.0
    for key, value in want.items():
        if key.startswith('Count/'):
            if got[key] != value:
                raise AssertionError(f'{name} {key}: {got[key]} batched, '
                                     f'{value} batch-1')
        elif key.startswith('Total/'):
            moved += abs(got[key] - value)
        elif exact_floats or key in ('loss', 'JSD'):
            err = abs(got[key] - value)
            worst = max(worst, err / max(abs(value), 1e-30))
            if err > rtol * abs(value) + 1e-9:
                raise AssertionError(f'{name} {key}: {got[key]} batched, '
                                     f'{value} batch-1')
    return worst, moved


def data_evaluate(port, config, checkpoint, card):
    """Phase 19, evaluation: evaluate.datasets on the test partition with
    batched_test_eval on and off, in bf16 (K1-K4 launched) and fp32; the
    JSON files and tensors.npz written."""
    counters = inference_counters()
    for dtype in ('float32', 'bfloat16'):
        results = {}
        for batched in (True, False):
            set_counts(counters)
            start = time.perf_counter()
            results[batched] = port.evaluate.datasets(
                ['commonvoice'], checkpoint=checkpoint,
                config=config.replace(batched_test_eval=batched,
                                      compute_dtype=dtype))
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches, _ = read_counts(counters)
            if dtype == 'bfloat16' and min(launches.values()) == 0:
                raise AssertionError(f'evaluate.datasets: a kernel never '
                                     f'launched: {launches}')
            print(f'evaluate.datasets ({dtype}, batched_test_eval='
                  f'{batched}): {wall:.3f} s wall, launches {launches} '
                  f'[{card}]', flush=True)
        fp32 = dtype == 'float32'
        frames = sum(v for k, v in results[False]['aggregate'].items()
                     if k.startswith('Count/'))
        for name in ('commonvoice', 'aggregate'):
            worst, moved = eval_apart(
                f'{dtype} {name}', results[True][name], results[False][name],
                fp32, 1e-6 if fp32 else EVAL_BF16_RTOL)
            limit = 0 if fp32 else EVAL_BF16_FLIPS * frames
            if moved > limit:
                raise AssertionError(f'{dtype} {name}: {moved} true '
                                     f'positives moved batched (<= {limit})')
        overall = results[True]['aggregate']
        print(f'{dtype}: batched against batch-1 on {frames:.0f} frames: '
              f'target counts equal, {moved:.0f} true positives moved (<= '
              f'{limit:.0f}), float sums within {worst:.3g} relative (<= '
              f'{1e-6 if fp32 else EVAL_BF16_RTOL}{"" if fp32 else ", loss and JSD"}); '
              f'accuracy {overall["Accuracy"]:.4f}, loss {overall["loss"]:.5f}, '
              f'JSD {overall["JSD"]:.5f}', flush=True)
    eval_dir = port.config.EVAL_DIR / config.config
    for path in (eval_dir / 'commonvoice.json', eval_dir / 'overall.json',
                 eval_dir / 'commonvoice' / 'tensors.npz',
                 eval_dir / 'overall' / 'tensors.npz'):
        if not path.exists():
            raise AssertionError(f'{path} was not written')
    print('the JSON files and tensors.npz written', flush=True)


def data_workers(port, config, root, cache, samples, card):
    """Phase 20: from_files_to_files(num_workers=4) over every file on the
    card; the outputs' shapes; the first batch's longest file and 7 others
    against device='cpu' on the same batch geometry; the throughput beside
    the file loop; a profile of one from_dataloader batch."""
    checkpoint = root / 'random-mel.npz'
    port.load.save_params(checkpoint, random_params(port, config, SEED))
    files = sorted(cache.glob('*.wav'))
    outs = root / 'ppgs'
    outs.mkdir()
    counters = inference_counters()
    set_counts(counters)
    start = time.perf_counter()
    port.from_files_to_files(files, [outs / f'{f.stem}.npy' for f in files],
                             checkpoint=checkpoint, num_workers=DATA_WORKERS,
                             config=config)
    torch.cuda.synchronize()
    first = time.perf_counter() - start
    launches, _ = read_counts(counters)
    if min(launches.values()) == 0:
        raise AssertionError(f'a kernel of the worker path never launched: '
                             f'{launches}')
    for f in files:
        ppg = np.load(outs / f'{f.stem}.npy')
        frames = samples[f.stem] // config.hopsize
        if (ppg.shape != (config.output_channels, frames)
                or not np.isfinite(ppg).all()
                or np.abs(ppg.sum(0) - 1).max() > 1e-4):
            raise AssertionError(f'{f.stem}.npy: shape {ppg.shape}, not '
                                 f'({config.output_channels}, {frames}), '
                                 f'or not a softmax')
    print(f'from_files_to_files(num_workers={DATA_WORKERS}) on {len(files)} '
          f'files: one (40, frames) output each, {first:.3f} s wall with the '
          f'model load, launches {launches} [{card}]', flush=True)

    features = ['audio', 'length', 'audio_file']
    loader = port.data.loader(files, features=features, num_workers=0,
                              max_frames=config.max_inference_frames,
                              config=config)
    batches = list(loader.batch_sampler)
    lengths = loader.dataset.lengths
    longest = max(batches[0], key=lambda i: lengths[i])
    chosen = [longest] + [i for i in batches[0] if i != longest][
        :DATA_CPU - 1]
    cpu = {}
    for dtype in ('bfloat16', 'float32'):
        directory = root / f'cpu-{dtype}'
        directory.mkdir()
        port.from_dataloader(
            port.data.Loader(loader.dataset, [chosen],
                             port.data.Collate(features), num_workers=0),
            {str(f): directory / f'{f.stem}.npy' for f in files},
            checkpoint=checkpoint,
            config=config.replace(compute_dtype=dtype), device='cpu')
        cpu[dtype] = torch.cat([torch.from_numpy(np.load(
            directory / f'{files[i].stem}.npy')) for i in chosen], -1)[None]
    card_ppgs = torch.cat([torch.from_numpy(np.load(
        outs / f'{files[i].stem}.npy')) for i in chosen], -1)[None]
    agree(f'{len(chosen)} files of the first batch ({len(batches[0])} files, '
          f'its longest among them) against device=cpu on that batch',
          card_ppgs, cpu['bfloat16'], cpu['float32'])

    audio_s = sum(samples.values()) / config.sample_rate
    loop_outs = root / 'loop'
    loop_outs.mkdir()
    timed = {}
    for workers in (DATA_WORKERS, 0):
        target = outs if workers else loop_outs
        timed[workers] = median_seconds(lambda: port.from_files_to_files(
            files, [target / f'{f.stem}.npy' for f in files],
            checkpoint=checkpoint, num_workers=workers, config=config),
            reps=DATA_REPS)
    print(f'{len(files)} files ({audio_s:.1f} audio-s), median of '
          f'{DATA_REPS}: num_workers={DATA_WORKERS} '
          f'{timed[DATA_WORKERS]:.3f} s, {audio_s / timed[DATA_WORKERS]:.1f} '
          f'audio-s/s; the file loop (num_workers=0) {timed[0]:.3f} s, '
          f'{audio_s / timed[0]:.1f} audio-s/s; '
          f'{timed[0] / timed[DATA_WORKERS]:.2f}x [{card}]', flush=True)

    batch = next(iter(port.data.Loader(loader.dataset, batches[:1],
                                       port.data.Collate(features),
                                       num_workers=0)))
    frames = int(batch[1].sum()) // config.hopsize
    by_name = profile_call(
        f'from_dataloader, one collated batch ({len(batches[0])} files, '
        f'{frames:,} frames, saves included)',
        lambda: port.from_dataloader(
            [batch], {str(f): outs / f'{f.stem}.npy' for f in files},
            checkpoint=checkpoint, config=config), card)
    report_groups('from_dataloader batch', by_name, card)


def data_phases(port, workdir, card):
    """Phases 18-20: the data slice (no kernel of its own: its training
    runs the train kernels, its inference K1-K4)."""
    config = port.config.get('mel')
    root = Path(workdir) / 'data'
    saved = point_data_dirs(port, root)
    cache = root / 'cache' / 'commonvoice'
    try:
        phase(f'18 corpus, partitions, weights and caches: {DATA_FILES} '
              f'seeded wav files of {DATA_SECONDS[0]}-{DATA_SECONDS[1]} s')
        start = time.perf_counter()
        samples = data_corpus(port, config, cache)
        audio_s = sum(samples.values()) / config.sample_rate
        print(f'corpus: {len(samples)} wav files and TextGrids, '
              f'{audio_s:.1f} audio-s, written in '
              f'{time.perf_counter() - start:.1f} s', flush=True)
        data_native_reader(port, cache)
        data_partitions_and_weights(port, config, cache, samples)
        data_caches(port, config, root, cache, samples, card)

        phase(f'19 train(\'commonvoice\') with its default loaders: '
              f'{DATA_STEPS} steps, a resume for {DATA_RESUME}, '
              f'{DATA_BUCKETS} buckets; evaluate.datasets')
        checkpoint = data_train(port, config, root, card)
        data_evaluate(port, config, checkpoint, card)

        phase(f'20 from_files_to_files(num_workers={DATA_WORKERS}) on the '
              f'{DATA_FILES} files (main path)')
        torch.cuda.reset_peak_memory_stats()
        data_workers(port, config, root, cache, samples, card)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f'peak device memory of phase 20: {peak:.4f} GiB [{card}]',
              flush=True)
    finally:
        for name, value in saved.items():
            setattr(port.config, name, value)


# The head-training slice: a corpus of its own (phase 18's recipe), its
# steps before the resume, the resume's and the bucketed run's
HEAD_FILES = 160
HEAD_STEPS, HEAD_RESUME = 4, 2
# The bucketed run: one epoch of 8 buckets, T = 900, 400, 200, 300, 800,
# 500, 1000, 700 on this corpus (4 on the per-layer path)
HEAD_BUCKETS = HEAD_BUCKET_STEPS = 8
HEAD_CONFIG = 'w2v2fb'


@torch.no_grad()
def ln_dropout_bwd_odd_shape_checks(C, dev):
    """ln_dropout_bwd at width C against its plain version at ``K4_ODD_M``
    rows: with the LayerNorm (n, 1/std, gamma) and without, dropout off and
    0.1, fp32 and bf16 g; dz at atol and rtol 1e-5, the bf16 masked output
    to phase 6's limits, the partial sums at atol 1e-3 rtol 1e-4; the
    masked output 0 exactly where Philox drops (its mask's bits); two
    calls equal bit for bit."""
    from ppgs_tpu_torch.ops import backward, dropout

    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    worst = 0.0
    for M, rate, g_type, with_ln in itertools.product(
            K4_ODD_M, (0.0, DROPOUT), (torch.float32, torch.bfloat16),
            (False, True)):
        g = torch.randn(M, C, generator=gen, device=dev).to(g_type)
        n = torch.randn(M, C, generator=gen, device=dev)
        rstd = torch.rand(M, generator=gen, device=dev) + 0.5
        gamma = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
        drop = dropout.Drop(SEED + 31, 7, rate)
        args = ((g, n, rstd, gamma) if with_ln else (g, None, None, None)) + (
            drop, torch.bfloat16)
        name = (f'ln_dropout_bwd C={C} M={M} rate={rate} g {g_type} '
                f'LayerNorm {with_ln}')
        dz, masked, part = backward.ln_dropout_bwd(*args)
        if not all(torch.equal(a, b) for a, b in zip(
                (dz, masked, part), backward.ln_dropout_bwd(*args))):
            raise AssertionError(f'{name}: two calls differ')
        pdz, pmasked, ppart = backward.ln_dropout_bwd_reference(*args)
        worst = max(worst,
                    check(f'{name} dz', dz, pdz, 1e-5, 1e-5, quiet=True),
                    check(f'{name} partial sums', part, ppart, 1e-3, 1e-4,
                          quiet=True))
        check(f'{name} masked (bf16)', masked, pmasked, 1e-5, 1e-2,
              share=1e-6, outlier=3.2e-2, quiet=True)
        if rate and masked[~drop.keep((M, C), dev)].any():
            raise AssertionError(f'{name}: a dropped element is not 0')
    print(f'ln_dropout_bwd C={C} at rows {K4_ODD_M}, with and without the '
          f'LayerNorm, dropout off and {DROPOUT}, fp32 and bf16 g: max '
          f'|kernel - plain| of dz and the partial sums {worst:.3g}; the '
          f'dropped elements 0; two calls bit for bit', flush=True)


def head_corpus_caches(port, config, root, card, files=HEAD_FILES):
    """Phases 23 and 26's data: the seeded corpus of ``files`` files, its
    partitions, and preprocess.datasets of config's representation
    (w2v2fb, w2v2fc) on the card with the seeded trunk; every cache (768,
    frames), finite. Returns the corpus' {stem: samples}."""
    cache = root / 'cache' / 'commonvoice'
    samples = data_corpus(port, config, cache, files)
    port.partition.datasets(['commonvoice'])
    start = time.perf_counter()
    port.preprocess.datasets(['commonvoice'], [config.representation],
                             config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    for stem, n in samples.items():
        cached = np.load(cache / f'{stem}-{config.representation}.npy')
        if (cached.shape != (config.input_channels, n // config.hopsize)
                or not np.isfinite(cached).all()):
            raise AssertionError(f'{stem}: cache {cached.shape}, not '
                                 f'({config.input_channels}, '
                                 f'{n // config.hopsize}), or not finite')
    audio_s = sum(samples.values()) / config.sample_rate
    print(f'preprocess.datasets({config.representation}) on the card: '
          f'{len(samples)} caches ({config.input_channels}, frames) '
          f'{cached.dtype}, {audio_s:.1f} audio-s, {wall:.3f} s wall, '
          f'{audio_s / wall:.1f} audio-s/s [{card}]', flush=True)
    return samples


def head_train_run(port, config, root, card, first=HEAD_STEPS,
                   resume=HEAD_RESUME):
    """Phase 23's training (and phase 40's): train('commonvoice') of
    ``config`` from its caches with the default loaders for ``first``
    steps, a resume for ``resume`` more, and a run in length buckets (the
    per-layer path); each step's path and launches exact. Returns (the first run's last checkpoint, the train kernels'
    launches in the three runs, the gemm forms' counter, those launches by
    path: {'whole-layer': ..., 'per-layer': ...})."""
    counters = train_counters()
    core, steps = port.train.core, []
    run = root / 'runs' / config.config
    set_counts(counters)
    counters['gemm'].forms.clear()
    original = recording_steps(core, steps, counters)
    try:
        walls = []
        for directory, run_config, max_steps in (
                (run, config, first),
                (run, config, first + resume),
                (root / 'runs' / 'buckets',
                 config.replace(buckets=HEAD_BUCKETS), HEAD_BUCKET_STEPS)):
            start = time.perf_counter()
            port.train.train('commonvoice', directory, config=run_config,
                             max_steps=max_steps)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
    finally:
        core.make_train_step = original
    launches, _ = read_counts(counters)
    forms = dict(counters['gemm'].forms)

    runs = {'run': steps[:first], 'resume': steps[first:first + resume],
            'buckets': steps[first + resume:]}
    frames = sum(sum(lengths) for _, lengths, _, _ in steps)
    print(f'train(\'commonvoice\', config={config.config!r}) from the '
          f'{config.representation} caches, budget '
          f'{config.max_training_frames:,} frames: {first} steps with '
          f'an evaluation at step 0 and a checkpoint {walls[0]:.3f} s, the '
          f'resume ({resume} steps) {walls[1]:.3f} s, {HEAD_BUCKETS} '
          f'buckets ({HEAD_BUCKET_STEPS} steps) {walls[2]:.3f} s; '
          f'{len(steps)} steps, {frames:,} frames [{card}]', flush=True)
    if [len(v) for v in runs.values()] != [first, resume, HEAD_BUCKET_STEPS]:
        raise AssertionError(f'the runs took {[len(v) for v in runs.values()]}'
                             f' steps')
    total = {'whole-layer': 0, 'per-layer': 0}
    for label, taken in runs.items():
        paths = check_data_steps(port, config, label, taken)
        total = {p: total[p] + paths[p] for p in total}
    print(f'train steps by path: {total}; launches in the three runs: '
          f'{launches}', flush=True)
    if min(total.values()) == 0:
        raise AssertionError(f'a train path took no step: {total}')
    if min(launches.values()) == 0:
        raise AssertionError(f'a train kernel never launched: {launches}')
    meta = json.loads((run / f'{first + resume:08d}.json').read_text())
    if meta['step'] != first + resume:
        raise AssertionError(f'the resumed run ended at step {meta["step"]}')
    print(f'resumed from {first:08d}.npz and checkpointed at step '
          f'{meta["step"]}', flush=True)
    longest = port.models.transformer.TRAIN_KERNEL_MAX_T
    by_path = {'whole-layer': collections.Counter(),
               'per-layer': collections.Counter()}
    for T, _, step_launches, _ in steps:
        by_path['whole-layer' if T % 8 == 0 and T <= longest
                else 'per-layer'].update(step_launches)
    return core.latest_checkpoint(run), launches, forms, by_path


def head_train_phases(port, workdir, dev, card):
    """Phases 21-23: the train kernels at the w2v2fb head's width and its
    training through train() from cached features; returns the new
    instances' JSON records."""
    config = port.config.get(HEAD_CONFIG)
    C, H = config.hidden_channels, config.attention_heads
    L = config.num_hidden_layers
    phase(f'21 the train kernels at C = {C}, d_head {C // H} against their '
          f'plain versions at odd shapes')
    for form in ('train_ln', 'y_out'):
        k4_odd_shape_checks(form, C, 'relu', config.ffn_channels, dev)
    ffn_bwd_odd_shape_checks(dev, C)
    attention_train_odd_shape_checks(dev, C // H)
    ln_dropout_bwd_odd_shape_checks(C, dev)

    phase(f'22 the train kernels at the head\'s training shape ({TRAIN_B} '
          f'windows x T={TRAIN_T}, dropout {DROPOUT}), B4-B6, a step against '
          f'the CPU, and the times on {card}')
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    model = port.train.core.init_model(config, dev)
    model.load_state_dict(port.convert.params_from_jax(
        port.load.flatten_params(random_params(port, config, SEED + 9))))
    layer = model.layers[0]
    err, inputs = train_kernel_checks(port, config, layer, dev, gen)
    inputs.update(
        ffn_b1=layer.ffn.b1, ffn_b2=layer.ffn.b2, bo=layer.attn.bo,
        g1=layer.norm1.scale, be1=layer.norm1.bias, g2=layer.norm2.scale,
        be2=layer.norm2.bias)
    whole_function_checks(config, layer, dev, gen, inputs['mask'])
    card_against_cpu(port, model, config, dev)
    per_step = {name: L * n for name, n in B4_PER_LAYER.items()}
    records, gemm_ms = train_kernel_times(config, inputs, err, None,
                                          per_step, None, card, tag=True)
    composite_times(port, config, layer, inputs, dev, gen, card)
    step_metrics(port, model, config, dev, card, gemm_ms * L)
    form_inputs = {k: inputs[k] for k in ('C', 'M', 'masked', 'd16', 'r',
                                          'dh', 'hd', 'a16', 'x', 'wo',
                                          'wqkv', 'dz')}
    del inputs, model, layer
    torch.cuda.empty_cache()

    phase(f'23 train(config={HEAD_CONFIG!r}) from cached '
          f'{config.representation} features: {HEAD_FILES} seeded files, '
          f'{HEAD_STEPS} steps, a resume for {HEAD_RESUME}, {HEAD_BUCKETS} '
          f'buckets; evaluate.datasets (main path)')
    root = Path(workdir) / 'head_train'
    w2v2fb = port.preprocess.w2v2fb
    saved = point_data_dirs(port, root)
    saved_trunk = w2v2fb.W2V2FB_CHECKPOINT
    try:
        root.mkdir(parents=True)
        trunk_path = root / 'wav2vec2-base.npz'
        port.load.save_params(trunk_path, random_w2v2_params(port, SEED + 7))
        w2v2fb.W2V2FB_CHECKPOINT = trunk_path
        head_corpus_caches(port, config, root, card)
        checkpoint, launches, forms, _ = head_train_run(port, config, root,
                                                        card)
        data_evaluate(port, config, checkpoint, card)
    finally:
        for name, value in saved.items():
            setattr(port.config, name, value)
        w2v2fb.W2V2FB_CHECKPOINT = saved_trunk

    form_launches = gemm_form_launches(form_inputs, forms, any_rows=True)
    if min(form_launches.values()) == 0:
        raise AssertionError(f'a gemm form never launched: {form_launches}')
    for record in records:
        if record['name'].startswith('gemm '):
            record['launches'] = form_launches[record['name'].split()[1]]
        else:
            record['launches'] = next(
                launches[name] for name in launches
                if record['name'] == record_name(name, form_inputs | {'H': H},
                                                 True))
    print(f'launches in the main path\'s runs: {launches}; gemm forms '
          f'{form_launches}', flush=True)
    return records


# The w2v2 slice: wav2vec2's 100 Hz trunk (the w2v2fc frontend, the W2V2
# and W2V2FC models) at the w2v2fb slice's 64 x 8 s, T = 800 frames; its
# stride-1 conv 6 (B10) at odd shapes, B = 1 and 3, about its 128-row
# tiles; the W2V2 model's train step (config w2v2ft) at the largest batch
# of 8 s rows that fits W2V2_FT_MEMORY_SHARE of the card's free memory,
# sized by steps of W2V2_FT_PROBE_B and twice as many rows (the peak's
# slope and intercept), W2V2_FT_STEPS steps; the same
# step at every rate 0 on W2V2_FT_CPU_ROWS rows of W2V2_FT_CPU_SECONDS
# against the CPU (fp32), and two runs of W2V2_FT_REPLAY_STEPS steps on
# W2V2_FT_REPLAY_B rows from one seed; then the head trained from w2v2fc
# caches of a W2V2FC_FILES-file corpus for W2V2FC_STEPS steps
W2V2_FT_STEPS, W2V2_FT_PROBE_B = 3, 4
W2V2_FT_MEMORY_SHARE = 0.9
W2V2_FT_CPU_ROWS, W2V2_FT_CPU_SECONDS = 2, 2
W2V2_FT_REPLAY_B, W2V2_FT_REPLAY_STEPS = 8, 2
W2V2FC_FILES, W2V2FC_STEPS = 40, 2
# The w2v2fc head's output conv scaled so that its seeded PPGs are not
# near uniform (at the init's scale the largest is ~0.07, and any hidden
# state gives probabilities within the atol of each other); by 4 the
# largest is ~0.26 and bf16's rounding moves a probability by ~0.005
# (against 2e-2). W2V2's and W2V2FC's heads, on the trunk's LayerNorm'd
# states, are that peaked at the init's scale. Scaling the logits scales
# their margins and their rounding alike, so the argmax gate counts only
# the frames bf16 decides (``agree_decided``)
W2V2_HEAD_SCALE = 4.0
# The rate-0 step against the CPU (fp32 on both): the loss at rtol 1e-4,
# each gradient by relative L2 within 1e-3 (sums in other orders over
# 95 M parameters; a gradient that is 0 in exact arithmetic, the key
# bias's, against a millionth of the largest), the parameters after Adam
# within 1e-6, but for at
# most 1e-4 of them within 2 lr (a gradient whose sign the two sums give
# differently: Adam's first update is about lr sign(g))
FT_CPU_GRAD_REL, FT_CPU_PARAM_ATOL, FT_CPU_PARAM_SHARE = 1e-3, 1e-6, 1e-4


# The share of frames that bf16 must decide for the argmax gate to count
DECIDED_SHARE = 0.5


def agree_decided(name, got, want, want32, card):
    """The bf16 gates of the slice's PPGs: max |got - want| <= 2e-2 and
    argmax agreement >= 99.5% on the frames that bf16 decides: those where
    ``want`` (bf16) and ``want32`` (the same call in fp32) pick the same
    phoneme and ``want32``'s top two lie more than twice the largest |want
    - want32| apart (the reach of bf16's rounding in this call), so that
    no bf16 computation within that reach flips them. With random weights
    about half a percent of the frames where bf16 and fp32 merely happen
    to agree (``agree``'s count) lie nearer than that: in two runs of this
    slice the card's and the CPU's bf16 roundings flipped 4 and 5 of some
    795 such frames (max |diff| 4.4e-3), ties that no kernel decides."""
    got, want, want32 = (t.float().cpu() for t in (got, want, want32))
    diff = (got - want).abs().max().item()
    reach = (want - want32).abs().max().item()
    top2 = want32.topk(2, dim=1).values
    decided = ((want.argmax(1) == want32.argmax(1))
               & (top2[:, 0] - top2[:, 1] > 2 * reach))
    same = got.argmax(1) == want.argmax(1)
    share = decided.float().mean().item()
    rate = same[decided].float().mean().item()
    print(f'{name}: max |diff| {diff:.3g} (atol 2e-2); argmax agreement '
          f'{same.float().mean().item():.5f}, on the frames bf16 decides '
          f'({share:.4f} of them: bf16 and fp32 agree, their top two over '
          f'2 x {reach:.3g} apart) {rate:.5f} (>= 0.995) [{card}]',
          flush=True)
    if diff > 2e-2 or rate < 0.995 or share < DECIDED_SHARE:
        raise AssertionError(f'{name} leaves the bf16 envelope')


def random_w2v2_model_params(port, config_name, seed):
    """Seeded weights of the W2V2 ('w2v2ft') or W2V2FC
    ('w2v2fc-pretrained') model in the JAX package's layout: its init,
    with each trunk layer's biases and norms drawn at random too."""
    gen = torch.Generator().manual_seed(seed)
    config = port.config.get(config_name)
    params = port.models.get(config)[0](config, gen)
    for layer in params['w2v2']['encoder']['layers']:
        jitter(layer, gen)
    return params


def w2v2_setup(port, workdir, dev):
    """Seeded full-size weights in temporary npz files: the Charsiu W2V2FC
    model (``W2V2FC_CHECKPOINT`` pointed at it: the w2v2fc frontend and
    w2v2fc-pretrained read it), the W2V2 model and the w2v2fc head (its
    output conv scaled by W2V2_HEAD_SCALE).
    Returns (the prepared bf16 100 Hz trunk on the card, {name: path})."""
    paths = {'charsiu': Path(workdir) / 'charsiu-w2v2-fc.npz',
             'w2v2ft': Path(workdir) / 'w2v2ft.npz',
             'head': Path(workdir) / 'random-w2v2fc.npz'}
    port.load.save_params(paths['charsiu'], random_w2v2_model_params(
        port, 'w2v2fc-pretrained', SEED + 91))
    port.load.save_params(paths['w2v2ft'], random_w2v2_model_params(
        port, 'w2v2ft', SEED + 92))
    head = random_params(port, port.config.get('w2v2fc'), SEED + 93)
    head['output_conv']['weight'] *= W2V2_HEAD_SCALE
    port.load.save_params(paths['head'], head)
    port.preprocess.w2v2fc.W2V2FC_CHECKPOINT = paths['charsiu']
    wcfg = port.models.w2v2_ppg.w2v2_100hz_config('bfloat16')
    return port.preprocess.w2v2fc._trunk(wcfg, dev), paths


@torch.no_grad()
def conv_s1_odd_shape_checks(w, dev):
    """conv_gelu at (k, s) = (2, 1) (conv 6 of the 100 Hz trunk, its
    weights) at B = 1 and 3 and ``B10_ODD_T`` output rows, T_in = T_out +
    1 (odd and even), each tap's map reading rows s t + j up to the last
    input row, against its plain version at phase 9's limits."""
    from ppgs_tpu_torch.ops import conv_stack

    gen = torch.Generator(device=dev).manual_seed(SEED + 94)
    C, worst = conv_stack.CHANNELS, 0.0
    for B, T_out in itertools.product((1, 3), B10_ODD_T):
        x = (0.5 * torch.randn(B, T_out + 1, C, generator=gen, device=dev)
             ).to(torch.bfloat16)
        got = conv_stack.conv_gelu(x, w, 2, 1)
        if got.shape != (B, T_out, C):
            raise AssertionError(f'conv_gelu (2, 1): shape '
                                 f'{tuple(got.shape)}, not {(B, T_out, C)}')
        worst = max(worst, check(
            f'B10 conv_gelu (2, 1) B={B} T_in={T_out + 1}', got,
            conv_stack.conv_gelu_reference(x, w, 2, 1), atol=1e-3,
            rtol=1e-2, quiet=True))
    print(f'B10 conv_gelu (k = 2, s = 1, conv 6\'s weights) at B = 1, 3 and '
          f'T_in = T_out + 1 for T_out {B10_ODD_T}: max |kernel - plain| '
          f'{worst:.3g} (atol 1e-3 rtol 1e-2 in each case)', flush=True)


@torch.no_grad()
def w2v2_kernel_checks(port, trunk, dev, gen):
    """Phase 24's checks: B10's stride-1 conv and chain, K1-K4 on the
    trunk's 64 x 800 rows (K2 at T = 800 with full, W2V2 half-length,
    ragged and wholly masked windows), B7 whole under the full and the
    W2V2 key mask; returns (max errors, inputs for the times)."""
    from ppgs_tpu_torch.ops import conv_stack
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk

    err, inputs = {}, {}
    wcfg = trunk.config
    pad = port.models.w2v2_ppg.PADDING
    S = W2V2_SECONDS * 16000 + 2 * pad
    T = int(port.models.w2v2.feat_extract_output_lengths(S, wcfg))
    half = int(port.models.w2v2.feat_extract_output_lengths(
        S, port.models.w2v2_ppg._mask_config(wcfg)))
    C, H = wcfg.hidden_size, wcfg.num_heads
    print(f'the 100 Hz trunk at {W2V2_BATCH} x {W2V2_SECONDS} s: {S} padded '
          f'samples -> T = {T} frames; the W2V2 key mask covers {half}',
          flush=True)

    # B10 at the 100 Hz strides: conv 6 at (2, 1) alone, then on the
    # chain's conv-5 output, and the chain whole
    taps = trunk.feature_prepared
    gn = trunk.feature_encoder[0].group_norm
    k, s = wcfg.conv_kernel, wcfg.conv_stride
    conv_s1_odd_shape_checks(taps.w6, dev)
    audio = (0.1 * torch.randn(W2V2_BATCH, S, generator=gen, device=dev)
             ).to(torch.bfloat16)
    sums = conv_stack.conv_stats(audio, taps.w0, k[0], s[0])
    first = (taps.w0, k[0], s[0], sums, gn.scale, gn.bias)
    x = conv_stack.conv_gelu(audio, taps.w1, k[1], s[1], first)
    for i in range(2, 6):
        x = conv_stack.conv_gelu(x, getattr(taps, f'w{i}'), k[i], s[i])
    x5 = x
    err['conv_gelu_s1'] = check(
        f'B10 conv_gelu (2, 1) on conv 5\'s output {tuple(x5.shape)}',
        conv_stack.conv_gelu(x5, taps.w6, k[6], s[6]),
        conv_stack.conv_gelu_reference(x5, taps.w6, k[6], s[6]), atol=1e-3,
        rtol=1e-2)
    chain = ([getattr(taps, f'w{i}') for i in range(1, len(k))], taps.w0,
             gn.scale, gn.bias, k, s)
    feats = conv_stack.feature_encoder_stack(audio, *chain)
    if feats.shape != (W2V2_BATCH, T, conv_stack.CHANNELS):
        raise AssertionError(f'B10 chain at 100 Hz: {tuple(feats.shape)}')
    check_rel('B10 the whole conv chain at 100 Hz (conv 6 at s = 1)', feats,
              conv_stack.feature_encoder_stack_reference(audio, *chain),
              1e-2)
    inputs['conv'] = dict(audio=audio, x5=x5, chain=chain, k=k, s=s)
    del feats, x

    # K1-K4 on the trunk's rows: windows full, W2V2 half-length, ragged
    # and wholly masked
    lengths = torch.full((W2V2_BATCH,), T, device=dev)
    lengths[W2V2_BATCH // 2:] = half
    lengths[-2], lengths[-1] = 537, 0
    mask = port.ops.masking.mask_from_lengths(lengths, T)
    xt = torch.randn(W2V2_BATCH, T, C, generator=gen, device=dev)
    layer_kernel_checks('trunk800', xt, mask, layer_weights(
        trunk.encoder.layers[0]), H, 'gelu', err, inputs)

    # B7 whole (the TPU's encoder_stack_streamed) under the full key mask
    # and the W2V2 model's half-length one: every query row counts
    layers = trunk.encoder.layers
    x16 = xt.to(torch.bfloat16)
    for name, m in (('full', torch.ones_like(mask)),
                    (f'W2V2 half-length ({half} keys)',
                     port.ops.masking.mask_from_lengths(
                         torch.full_like(lengths, half), T))):
        got = elk.encoder_stack(x16, m, layers, H, activation='gelu')
        check_rel(f'B7 the {len(layers)}-layer GELU stack {W2V2_BATCH} x {T}, '
                  f'{name} key mask', got, elk.encoder_stack_reference(
                      x16, m, layers, H, activation='gelu'), 1e-2)
        inputs.setdefault('stack', dict(x16=x16, masks={}))['masks'][name] = m
    return err, inputs


@torch.no_grad()
def w2v2_kernel_times(port, trunk, inputs, err, card):
    """Phase 24's times: K1-K4 at the trunk's 64 x 800 rows and conv_gelu
    at (2, 1), each by CUDA events and device time beside its bound, its
    plain version and its library route; B7 and the 100 Hz chain whole.
    Returns the records (their launches filled in by phase 25)."""
    from ppgs_tpu_torch.ops import conv_stack
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk

    none = collections.defaultdict(lambda: {'trunk800': None})
    records = layer_records('trunk800', inputs['trunk800'], err, none,
                            'ppgs_tpu/ops/encoder_layer_kernel.py:496', card)
    for record in records:
        if not record['name'].endswith('trunk800'):
            record['name'] += '_t800'

    c = inputs['conv']
    x5, taps = c['x5'], trunk.feature_prepared
    B, T5, Cc = x5.shape
    T6 = T5 - 1
    x5_nct = x5.transpose(1, 2).contiguous()
    w6_oik = taps.w6.view(2, Cc, Cc).permute(2, 1, 0).contiguous()

    def kernel():
        return conv_stack.conv_gelu(x5, taps.w6, 2, 1)

    records.append(timed_record(
        'conv_gelu_s1', 'conv_stack.cu', 'ppgs_tpu/ops/conv_stack.py:229',
        None, err['conv_gelu_s1'], (
            kernel, lambda: conv_stack.conv_gelu_reference(x5, taps.w6, 2, 1),
            lambda: F.gelu(F.conv1d(x5_nct, w6_oik, stride=1),
                           approximate='tanh')),
        (2 * B * T6 * 2 * Cc * Cc,
         B * T5 * Cc * 2 + 2 * Cc * Cc * 2 + B * T6 * Cc * 2), card,
        plain_reps=HEAVY_REPS))
    device_times(f'B10 conv_gelu (2, 1), {B} x {T5} -> {T6}', records[-1],
                 kernel, 'cuDNN conv + GELU', card)
    records[-1]['library_device_ms'] = kernel_device_ms(
        'B10 conv_gelu (2, 1) library route (cuDNN conv + GELU)',
        lambda: F.gelu(F.conv1d(x5_nct, w6_oik, stride=1),
                       approximate='tanh'), card)
    del x5_nct, w6_oik

    chain, a16 = c['chain'], c['audio']
    chain_ms = time_ms(lambda: conv_stack.feature_encoder_stack(a16, *chain))
    chain_library_ms = time_ms(lambda: port.models.w2v2.feature_encoder(
        trunk, a16, trunk.config))
    print(f'B10 the 100 Hz conv chain ({B} x {a16.shape[1]} samples): kernels '
          f'{chain_ms:.4f} ms, library {chain_library_ms:.4f} ms (the cuDNN '
          f'bf16 convs, GroupNorm and GELU of models.w2v2.feature_encoder) '
          f'[{card}]', flush=True)

    st, layers = inputs['stack'], trunk.encoder.layers
    wcfg = trunk.config
    stack_bound = len(layers) * sum(r['bound_ms'] for r in records[:4])
    encoder = library_encoder(layers, wcfg.hidden_size, wcfg.num_heads,
                              wcfg.intermediate_size, st['x16'].device,
                              activation='gelu')
    for name, m in st['masks'].items():
        ms = time_ms(lambda: elk.encoder_stack(st['x16'], m, layers,
                                               wcfg.num_heads,
                                               activation='gelu'))
        plain_ms = time_ms(lambda: elk.encoder_stack_reference(
            st['x16'], m, layers, wcfg.num_heads, activation='gelu'),
            HEAVY_REPS, 1)
        library_ms = time_ms(lambda: encoder(st['x16'],
                                             src_key_padding_mask=~m))
        print(f'B7 the {len(layers)}-layer GELU stack ({B} x '
              f'{st["x16"].shape[1]}, {name} key mask): kernels {ms:.4f} ms, '
              f'bound {stack_bound:.4f} ms, plain {plain_ms:.4f} ms, library '
              f'{library_ms:.4f} ms (nn.TransformerEncoderLayer(768, 12, '
              f'3072, gelu) x {len(layers)}) [{card}]', flush=True)
    kernel_device_ms(f'B7 the GELU stack {B} x {st["x16"].shape[1]}, by '
                     f'kernel', lambda: elk.encoder_stack(
                         st['x16'], st['masks']['full'], layers,
                         wcfg.num_heads, activation='gelu'), card)
    del encoder
    return records


def w2v2_counters():
    from ppgs_tpu_torch.ops import conv_stack

    return {**inference_counters(), 'conv_stats': conv_stack.conv_stats,
            'conv0_gelu': conv_stack.conv0_gelu,
            'conv_gelu': conv_stack.conv_gelu}


def counted_call(counters, fn):
    """(fn()'s result, the launches of the call, by width, and conv_gelu's
    launches by stride), the counts set to 0 just before."""
    set_counts(counters)
    out = fn()
    launches, widths = read_counts(counters)
    return out, launches, widths, dict(counters['conv_gelu'].strides)


def path_metrics(label, fn, audio_s, card):
    """A path's wall (median of 5), audio-s/s, its peak memory above what
    the run holds, and a profile of one call (idle share, device time by
    kernel and by group)."""
    wall = median_seconds(fn)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    print(f'{label}: {wall * 1e3:.3f} ms (median of 5), '
          f'{audio_s / wall:.1f} audio-s/s, peak {peak:.3f} GiB above the '
          f'{held / 2 ** 30:.3f} GiB held [{card}]', flush=True)
    report_groups(label, profile_call(label, fn, card), card)


def w2v2_inference(port, trunk, paths, dev, gen, card):
    """Phase 25: paths 1 (from_audio(config='w2v2fc'), by default and
    opted in to B10) and 2 (W2V2 and W2V2FC through from_features) at
    64 x 8 s, each with its exact launches and against the CPU; the two
    from_audio configs that the JAX package refuses. Returns the launches
    of the default call by width, and conv_gelu's by stride in the
    opted-in call."""
    Lt = trunk.config.num_layers
    counters = w2v2_counters()
    samples = W2V2_SECONDS * 16000
    audio = 0.1 * torch.randn(W2V2_BATCH, 1, samples, generator=gen,
                              device=dev)
    lengths = np.full(W2V2_BATCH, samples)
    frames = samples // 160
    shape = (W2V2_BATCH, 40, frames)
    head_config = port.config.get('w2v2fc')
    Ch, Lh = head_config.hidden_channels, head_config.num_hidden_layers
    d_h = Ch // head_config.attention_heads
    fp32 = head_config.replace(compute_dtype='float32')
    call = dict(config=head_config, checkpoint=paths['head'])

    def from_audio(a=audio, **kw):
        return port.from_audio(a, 16000, **{**call, **kw})

    ppg, launches, widths, _ = counted_call(counters, from_audio)
    print(f'launches in one w2v2fc from_audio call: {launches}, by width: '
          f'{widths}', flush=True)
    want = {'qkv_proj': Lt + Lh, 'attention': Lt + Lh,
            'out_proj_residual_ln': Lt + Lh, 'ffn_residual_ln': Lt + Lh,
            'conv_stats': 0, 'conv0_gelu': 0, 'conv_gelu': 0,
            'conv_gelu_first': 0}
    want_widths = {'qkv_proj': {768: Lt, Ch: Lh}, 'attention': {64: Lt,
                                                                d_h: Lh},
                   'out_proj_residual_ln': {768: Lt, Ch: Lh},
                   'ffn_residual_ln': {768: Lt, Ch: Lh}}
    if launches != want or widths != want_widths:
        raise AssertionError(f'w2v2fc launches {launches} {widths}, not '
                             f'{want} {want_widths}')
    check_ppg('w2v2fc from_audio', ppg, audio, shape)
    rows = audio[:W2V2_CPU_ROWS, :, :W2V2_CPU_SECONDS * 16000]
    agree_decided(f'w2v2fc from_audio, {W2V2_CPU_ROWS} x {W2V2_CPU_SECONDS} '
                  f's, against device=cpu', from_audio(rows),
                  from_audio(rows.cpu(), device='cpu'),
                  from_audio(rows.cpu(), device='cpu', config=fp32), card)

    os.environ['PPGS_TPU_CONV_STACK'] = '1'
    try:
        stacked, stack_launches, stack_widths, strides = counted_call(
            counters, from_audio)
    finally:
        del os.environ['PPGS_TPU_CONV_STACK']
    print(f'launches with PPGS_TPU_CONV_STACK=1: {stack_launches}, conv_gelu '
          f'by stride {strides}', flush=True)
    if (stack_launches != {**want, 'conv_stats': 1, 'conv0_gelu': 1,
                           'conv_gelu': 6, 'conv_gelu_first': 1}
            or stack_widths != widths or strides != {2: 5, 1: 1}):
        raise AssertionError('the conv-stack opt-in did not launch B10 once '
                             'per conv (conv 6 at s = 1), and K1-K4 as the '
                             'default path')
    agree_decided('w2v2fc PPGS_TPU_CONV_STACK=1 against the default path',
                  stacked, ppg, from_audio(config=fp32), card)
    del stacked

    audio_s = W2V2_BATCH * W2V2_SECONDS
    path_metrics(f'w2v2fc from_audio {W2V2_BATCH} x {W2V2_SECONDS} s',
                 from_audio, audio_s, card)
    os.environ['PPGS_TPU_CONV_STACK'] = '1'
    try:
        path_metrics(f'w2v2fc from_audio {W2V2_BATCH} x {W2V2_SECONDS} s '
                     f'(PPGS_TPU_CONV_STACK=1)', from_audio, audio_s, card)
    finally:
        del os.environ['PPGS_TPU_CONV_STACK']

    # Path 2: the raw-audio models on the audio itself
    trunk_only = {n: (Lt if n in inference_counters() else 0) for n in want}
    trunk_widths = {n: {768: Lt} if n != 'attention' else {64: Lt}
                    for n in want_widths}
    for model, name, kw in (('W2V2', 'w2v2ft',
                             dict(checkpoint=paths['w2v2ft'])),
                            ('W2V2FC', 'w2v2fc-pretrained', {})):
        config = port.config.get(name)

        def from_features(a=audio, n=lengths, **over):
            return port.from_features(a, n, **{'config': config, **kw,
                                               **over})

        ppg, got, got_widths, _ = counted_call(counters, from_features)
        print(f'launches in one {model} from_features call: {got}, by '
              f'width: {got_widths}', flush=True)
        if got != trunk_only or got_widths != trunk_widths:
            raise AssertionError(f'{model} launches {got} {got_widths}, not '
                                 f'{trunk_only} {trunk_widths}')
        check_ppg(f'{model} from_features', ppg, audio, shape)
        n = np.full(W2V2_CPU_ROWS, rows.shape[-1])
        agree_decided(
            f'{model} from_features, {W2V2_CPU_ROWS} x {W2V2_CPU_SECONDS} s, '
            f'against device=cpu', from_features(rows, n),
            from_features(rows.cpu(), n, device='cpu'),
            from_features(rows.cpu(), n, device='cpu',
                          config=config.replace(compute_dtype='float32')),
            card)
        path_metrics(f'{model} from_features {W2V2_BATCH} x {W2V2_SECONDS} s',
                     from_features, audio_s, card)

    # The two configs whose from_audio the JAX package refuses
    for name, match in (('w2v2fc-pretrained', 'squeeze'),
                        ('w2v2ft', 'Unknown representation wav')):
        try:
            port.from_audio(audio[:1], 16000, config=name)
        except ValueError as error:
            if match not in str(error):
                raise
            print(f'from_audio(config={name!r}) raises ValueError as the JAX '
                  f'package does: {error}', flush=True)
        else:
            raise AssertionError(f'from_audio(config={name!r}) ran; the JAX '
                                 f'package raises')
    return widths, strides


def ft_batch(B, seconds, seed, dev):
    """A w2v2ft batch made on the card: (B, 1, S) audio, ragged sample
    counts (the first row whole, the rest zero past theirs), targets at
    100 Hz with -100 past each row's frames."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    S = seconds * 16000
    lengths = S - 160 * torch.randint(0, S // 640, (B,), generator=gen,
                                      device=dev)
    lengths[0] = S
    audio = 0.1 * torch.randn(B, 1, S, generator=gen, device=dev)
    audio *= (torch.arange(S, device=dev) < lengths[:, None])[:, None]
    frames = S // 160
    targets = torch.randint(0, 40, (B, frames), generator=gen, device=dev)
    targets = targets.masked_fill(
        torch.arange(frames, device=dev) >= (lengths // 160)[:, None], -100)
    return audio, targets, lengths


def ft_model(port, config, dev):
    """The W2V2 model at config's rates with seeded random weights (the
    trunk's init, not pretrained, as the JAX package's train starts)."""
    return port.train.core.init_model(
        config, dev, torch.Generator().manual_seed(SEED + 95))


def ft_steps(port, model, config, batch, seeds):
    """Take a step of ``batch`` for each seed; returns (losses, seconds
    each, CUDA-synchronised)."""
    core = port.train.core
    step = core.make_train_step(model, config, core.make_optimizer(
        model.parameters(), config))
    losses, seconds = [], []
    for seed in seeds:
        torch.cuda.synchronize()
        start = time.perf_counter()
        loss, _ = step(*batch, seed=seed)
        losses.append(float(loss))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
    return losses, seconds


def ft_cpu_check(port, config, dev, card):
    """One step at every rate 0 (dropout, LayerDrop, spec-augment), fp32,
    on W2V2_FT_CPU_ROWS rows against the same step with device='cpu': the
    loss, every gradient and the parameters after Adam."""
    config = config.replace(compute_dtype='float32')
    batch = ft_batch(W2V2_FT_CPU_ROWS, W2V2_FT_CPU_SECONDS, SEED + 96, dev)
    results = []
    for device in (dev, torch.device('cpu')):
        model = ft_model(port, config, device)
        model.w2v2.config = dataclasses.replace(
            model.w2v2.config, hidden_dropout=0.0, activation_dropout=0.0,
            attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
            apply_spec_augment=False)
        grads = {}
        core = port.train.core
        optimizer = core.make_optimizer(model.parameters(), config)
        step = core.make_train_step(model, config, optimizer)
        original = optimizer.step

        def keep_grads(*a, **k):
            grads.update({n: p.grad.detach().cpu().clone()
                          for n, p in model.named_parameters()})
            return original(*a, **k)

        optimizer.step = keep_grads
        loss, _ = step(*(t.to(device) for t in batch), seed=5)
        results.append((float(loss), grads, {
            n: p.detach().cpu() for n, p in model.named_parameters()}))
        del model, optimizer
    (loss, grads, params), (loss_cpu, grads_cpu, params_cpu) = results
    if not abs(loss - loss_cpu) <= 1e-4 * abs(loss_cpu):
        raise AssertionError(f'w2v2ft rate-0 step: loss {loss} on the card, '
                             f'{loss_cpu} on the cpu')
    norms = {n: grads_cpu[n].norm().item() for n in grads}
    floor = 1e-6 * max(norms.values())
    worst = max((grads[n] - grads_cpu[n]).norm().item() / max(norms[n], floor)
                for n in grads if norms[n])
    zero = [n for n in grads if not norms[n]]
    if worst > FT_CPU_GRAD_REL or any(grads[n].any() for n in zero):
        raise AssertionError(f'w2v2ft rate-0 step: a gradient {worst:.3g} '
                             f'apart (relative L2), or one of {zero} not 0')
    lr = config.learning_rate
    card_p = torch.cat([params[n].flatten() for n in params])
    cpu_p = torch.cat([params_cpu[n].flatten() for n in params])
    diff = check('w2v2ft rate-0 step: the parameters after Adam', card_p,
                 cpu_p, FT_CPU_PARAM_ATOL, share=FT_CPU_PARAM_SHARE,
                 outlier=2 * lr + 1e-6, quiet=True)
    print(f'w2v2ft step at every rate 0, fp32, {W2V2_FT_CPU_ROWS} x '
          f'{W2V2_FT_CPU_SECONDS} s, card against device=cpu: loss {loss:.6f} '
          f'/ {loss_cpu:.6f}, gradients within relative L2 {worst:.3g} (<= '
          f'{FT_CPU_GRAD_REL}; {len(zero)} tensors 0 on both: {zero[:3]}...), '
          f'parameters after Adam max |diff| {diff:.3g} (atol '
          f'{FT_CPU_PARAM_ATOL}, at most {FT_CPU_PARAM_SHARE} of them within '
          f'2 lr) [{card}]', flush=True)


def w2v2_training(port, dev, card):
    """Phase 26: the W2V2 model's train step under config w2v2ft at full
    width and depth: the batch that fits, its steps (finite losses, the
    frozen convs bit for bit, every other parameter moved), time, audio-s/s
    and peak memory; the rate-0 step against the CPU; a replay."""
    config = port.config.get('w2v2ft')
    L = port.models.w2v2.BASE.num_layers
    model = ft_model(port, config, dev)
    ft_steps(port, model, config, ft_batch(W2V2_FT_PROBE_B, W2V2_SECONDS,
                                           SEED + 97, dev), (1,))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()     # the model and Adam's state
    peaks = []
    for rows in (W2V2_FT_PROBE_B, 2 * W2V2_FT_PROBE_B):
        probe = ft_batch(rows, W2V2_SECONDS, SEED + 97, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ft_steps(port, model, config, probe, (2,))
        peaks.append(torch.cuda.max_memory_allocated() - held)
        del probe
    per_row = (peaks[1] - peaks[0]) / W2V2_FT_PROBE_B
    fixed = peaks[0] - W2V2_FT_PROBE_B * per_row
    del model
    torch.cuda.empty_cache()
    frames = W2V2_SECONDS * 100
    budget_rows = config.max_training_frames // frames
    free, total = torch.cuda.mem_get_info()
    fit = int((W2V2_FT_MEMORY_SHARE * free - held - fixed) / per_row)
    B = max(W2V2_FT_PROBE_B, min(fit, budget_rows) // 4 * 4)
    print(f'w2v2ft step: {per_row / 2 ** 30:.3f} GiB a row of {W2V2_SECONDS} '
          f's at the peak and {fixed / 2 ** 30:.3f} GiB besides (steps of '
          f'{W2V2_FT_PROBE_B} and {2 * W2V2_FT_PROBE_B} rows), the model and '
          f'Adam\'s state {held / 2 ** 30:.3f} GiB; {free / 2 ** 30:.1f} GiB '
          f'free of {total / 2 ** 30:.1f}: {fit} rows fit '
          f'{W2V2_FT_MEMORY_SHARE} of it; the config\'s budget '
          f'({config.max_training_frames:,} frames) is {budget_rows} rows: '
          f'the step runs {B} x {W2V2_SECONDS} s ({B * frames:,} frames, '
          f'a cut of the budget) [{card}]', flush=True)

    model = ft_model(port, config, dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = ft_batch(B, W2V2_SECONDS, SEED + 98, dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seeds = list(range(11, 11 + W2V2_FT_STEPS))
    losses, seconds = ft_steps(port, model, config, batch, seeds)
    peak = torch.cuda.max_memory_allocated()
    print(f'w2v2ft steps {B} x {W2V2_SECONDS} s: losses {losses}; step ms '
          f'{[round(t * 1e3, 3) for t in seconds]} (the first with Adam\'s '
          f'state made), {B * W2V2_SECONDS / statistics.median(seconds):.1f} '
          f'audio-s/s at the median; peak {peak / 2 ** 30:.3f} GiB '
          f'(max_memory_allocated; {held / 2 ** 30:.3f} held before) '
          f'[{card}]', flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f'w2v2ft: a loss is not finite: {losses}')
    frozen = [n for n in before if n.startswith('w2v2.feature_encoder.')]
    changed = [n for n in frozen if not torch.equal(
        before[n], dict(model.named_parameters())[n])]
    if changed or not frozen:
        raise AssertionError(f'w2v2ft: frozen convs changed: {changed}')
    dropped = [i for i in range(L) if not any(
        port.models.w2v2.layer_kept(seed, i, model.w2v2.config.layerdrop)
        for seed in seeds)]
    still = [n for n, p in model.named_parameters()
             if n not in frozen and torch.equal(before[n], p)
             and not any(n.startswith(f'w2v2.encoder.layers.{i}.')
                         for i in dropped)]
    print(f'w2v2ft: the {len(frozen)} frozen conv tensors bit for bit as they '
          f'were; every other parameter moved ({len(before) - len(frozen)} '
          f'tensors; layers LayerDrop skipped in every step: {dropped})',
          flush=True)
    if still:
        raise AssertionError(f'w2v2ft: parameters that did not move: {still}')
    profile_call(f'w2v2ft step {B} x {W2V2_SECONDS} s',
                 lambda: ft_steps(port, model, config, batch, (99,)), card)
    del model, before, batch
    torch.cuda.empty_cache()

    ft_cpu_check(port, config, dev, card)

    # Replay: two runs from one seed, cuDNN's deterministic algorithms (its
    # conv weight gradients may otherwise sum in another order)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        batch = ft_batch(W2V2_FT_REPLAY_B, W2V2_SECONDS, SEED + 99, dev)
        for _ in range(2):
            model = ft_model(port, config, dev)
            losses, _ = ft_steps(port, model, config, batch,
                                 range(21, 21 + W2V2_FT_REPLAY_STEPS))
            runs.append((losses, [p.detach().clone()
                                  for p in model.parameters()]))
            del model
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (l1, p1), (l2, p2) = runs
    if l1 != l2 or not all(torch.equal(a, b) for a, b in zip(p1, p2)):
        raise AssertionError('w2v2ft: two runs from one seed differ')
    print(f'w2v2ft: two runs of {W2V2_FT_REPLAY_STEPS} steps on '
          f'{W2V2_FT_REPLAY_B} rows from one seed (every draw on; cuDNN '
          f'deterministic) equal bit for bit: losses {l1}', flush=True)
    del runs, batch
    torch.cuda.empty_cache()


def w2v2fc_head_training(port, workdir, card):
    """Path 4: preprocess.datasets(w2v2fc) on a seeded corpus through the
    seeded Charsiu trunk, then train(config='w2v2fc') from those caches,
    each step's path and launches exact."""
    config = port.config.get('w2v2fc')
    root = Path(workdir) / 'w2v2fc_train'
    saved = point_data_dirs(port, root)
    counters = train_counters()
    core, steps = port.train.core, []
    try:
        root.mkdir(parents=True)
        head_corpus_caches(port, config, root, card, W2V2FC_FILES)
        set_counts(counters)
        counters['gemm'].forms.clear()
        original = recording_steps(core, steps, counters)
        try:
            start = time.perf_counter()
            port.train.train('commonvoice', root / 'runs' / 'w2v2fc',
                             config=config, max_steps=W2V2FC_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        finally:
            core.make_train_step = original
        launches, _ = read_counts(counters)
    finally:
        for name, value in saved.items():
            setattr(port.config, name, value)
    print(f'train(\'commonvoice\', config=\'w2v2fc\') from the w2v2fc caches: '
          f'{len(steps)} steps with the step-0 evaluation, {wall:.3f} s '
          f'[{card}]', flush=True)
    if len(steps) != W2V2FC_STEPS:
        raise AssertionError(f'the run took {len(steps)} steps')
    check_data_steps(port, config, 'w2v2fc', steps)
    print(f'the train kernels\' launches in the run: {launches}', flush=True)
    if min(launches.values()) == 0:
        raise AssertionError(f'a train kernel never launched: {launches}')


def w2v2_phases(port, workdir, dev, card):
    """Phases 24-26: the w2v2 slice; returns its kernels' JSON records."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    phase(f'24 the 100 Hz trunk\'s kernel instances against their plain '
          f'versions ({W2V2_BATCH} x T = 800; conv 6 at s = 1) and their times '
          f'on {card}')
    trunk, paths = w2v2_setup(port, workdir, dev)
    err, inputs = w2v2_kernel_checks(port, trunk, dev, gen)
    records = w2v2_kernel_times(port, trunk, inputs, err, card)
    del inputs
    torch.cuda.empty_cache()
    phase(f'25 from_audio(config=w2v2fc), W2V2 and W2V2FC through '
          f'from_features: {W2V2_BATCH} x {W2V2_SECONDS} s (main paths)')
    widths, strides = w2v2_inference(port, trunk, paths, dev, gen, card)
    for record, (name, width) in zip(records, (
            ('qkv_proj', 768), ('attention', 64),
            ('out_proj_residual_ln', 768), ('ffn_residual_ln', 768))):
        record['launches'] = widths[name][width]
    records[4]['launches'] = strides[1]
    print(f'the new instances\' launches in phase 25\'s calls: '
          f'{[(r["name"], r["launches"]) for r in records]}', flush=True)
    phase(f'26 the W2V2 train step (config w2v2ft) and train(config=w2v2fc) '
          f'from w2v2fc caches')
    w2v2_training(port, dev, card)
    w2v2fc_head_training(port, workdir, card)
    return records


# The codec slice (phases 27-29): the encodec and dac heads at the mel
# head's width (C = 256, 2 heads of 128, FFN 2048, 5 layers; input channels
# 128 and 96) on seeded codebooks at the published shapes: EnCodec-24 kHz's
# 32 RVQ levels of 1024 x 128 (summed; every level that
# scripts/convert_codebooks.py extracts) and DAC-16 kHz's 12 levels of
# 1024 x 8 (concatenated to 96)
CODEC_BOOKS = {'encodec': (32, 1024, 128, 'sum'),
               'dac': (12, 1024, 8, 'concat')}
CODEC_BATCH, CODEC_FRAMES = 64, 800     # 128 windows of 500 frames
CODEC_CPU_ROWS = 4
CODEC_FILES, CODEC_STEPS = 40, 3
CODEC_FT_ROWS, CODEC_FT_T = 2, 500
# The rate-0 step against the CPU: phase 26's limits, but the share of the
# parameters that may move 2 lr apart after Adam holds the key biases (1280
# of the head's 6.8 M): softmax ignores them, so their gradient is rounding
# noise whose sign Adam's first step takes. Gradients whose norm on the CPU
# is below CODEC_NOISE_NORM of the largest are such noise, held to that
# reach in absolute terms
CODEC_PARAM_SHARE, CODEC_NOISE_NORM = 1e-3, 1e-5
# evaluate.datasets(config='encodec') on the card against device='cpu': the
# target counts equal; in fp32 (plain PyTorch on both) the loss and JSD
# sums within rtol 1e-5 and the true positives within CODEC_EVAL_FLIPS of
# the frames (argmax ties); in bf16 (K1-K4 against their plain versions)
# the loss and JSD within CODEC_EVAL_BF16_RTOL and the true positives
# within EVAL_BF16_FLIPS of the frames
CODEC_EVAL_FLIPS, CODEC_EVAL_BF16_RTOL = 1e-3, 1e-2
PLOT_SECONDS = (2.3, 3.7, 5.2, 6.8)
PROFILE_BATCH = 8


def codec_setup(port, workdir):
    """Seeded codebooks at the published shapes as npz files in a temporary
    directory that ``frontend.CODEBOOK_DIR`` points at (nothing is written
    under ppgs_tpu/assets/), read back through ``frontend._load``; seeded
    head weights for each codec and the mel head in temporary npz files.
    Returns {name: head npz}."""
    frontend = port.frontend
    books_dir = Path(workdir) / 'codebooks'
    books_dir.mkdir()
    frontend.CODEBOOK_DIR = books_dir
    rng = np.random.default_rng(SEED + 27)
    paths = {}
    for i, (name, (Q, V, D, mode)) in enumerate(CODEC_BOOKS.items()):
        # unit-variance latents: a sum of Q levels is scaled by 1/sqrt(Q)
        scale = 1 / math.sqrt(Q) if mode == 'sum' else 1.0
        books = (scale * rng.standard_normal((Q, V, D))).astype(np.float32)
        np.savez(books_dir / f'{name}.npz', codebooks=books, mode=mode)
        frontend.unregister(name)
        loaded, loaded_mode = frontend._load(name)
        if (loaded_mode != mode or loaded.device.type != 'cpu'
                or not np.array_equal(loaded.numpy(), books)):
            raise AssertionError(f'{name}: _load did not read the npz back')
        config = port.config.get(name)
        width = D if mode == 'sum' else Q * D
        if config.input_channels != width:
            raise AssertionError(f'{name}: {width} latent channels, the '
                                 f'config takes {config.input_channels}')
        paths[name] = Path(workdir) / f'{name}-head.npz'
        port.load.save_params(paths[name],
                              random_params(port, config, SEED + 27 + i))
        print(f'{name}: codebooks ({Q}, {V}, {D}) \'{mode}\' -> '
              f'{config.input_channels} channels, read through _load from '
              f'{books_dir}', flush=True)
    paths['mel'] = Path(workdir) / 'mel-head-29.npz'
    port.load.save_params(paths['mel'], random_params(
        port, port.config.get('mel'), SEED + 29))
    return paths


def codec_batch(config, B, T, gen, dev):
    """Seeded int32 codes (B, Q, T) on the card with ragged lengths (the
    first row whole), zero past each row's length as the collate pads
    them; and the lengths."""
    Q, V = CODEC_BOOKS[config.frontend][:2]
    codes = torch.randint(0, V, (B, Q, T), generator=gen, device=dev,
                          dtype=torch.int32)
    lengths = T - torch.randint(0, T // 2, (B,), generator=gen, device=dev)
    lengths[0] = T
    codes *= (torch.arange(T, device=dev) < lengths[:, None])[:, None]
    return codes, lengths.cpu().numpy()


def codec_inference(port, paths, dev, gen, card):
    """Phase 27: decode_codes on the card against the CPU; then
    from_features under each codec config at 64 x 800 frames: exact K1-K4
    launches, the PPGs against device='cpu', audio-s/s and a profile."""
    counters = inference_counters()
    want = {name: 5 for name in counters}
    want_widths = {'qkv_proj': {256: 5}, 'attention': {128: 5},
                   'out_proj_residual_ln': {256: 5},
                   'ffn_residual_ln': {256: 5}}
    for name in CODEC_BOOKS:
        config = port.config.get(name)
        codes, lengths = codec_batch(config, CODEC_BATCH, CODEC_FRAMES, gen,
                                     dev)
        books, mode = port.frontend._load(name)
        got = port.frontend.decode_codes(codes, books.to(dev), mode)
        host = port.frontend.decode_codes(codes.cpu(), books, mode)
        if mode == 'concat':
            if not torch.equal(got.cpu(), host):
                raise AssertionError(f'{name} decode_codes: the card\'s '
                                     f'latents are not the CPU\'s')
            print(f'{name} decode_codes ({mode}) {tuple(got.shape)}: the '
                  f'card\'s bit for bit the CPU\'s', flush=True)
        else:
            check(f'{name} decode_codes ({mode}) {tuple(got.shape)}, card '
                  f'against CPU', got.cpu(), host, atol=0.0, rtol=1e-6)
        decode_ms = time_ms(lambda: port.frontend.decode_codes(
            codes, books.to(dev), mode), reps=10)
        print(f'{name} decode_codes on the card: {decode_ms:.4f} ms (median '
              f'of 10, CUDA events) [{card}]', flush=True)
        del got, host

        call = dict(config=config, checkpoint=paths[name])

        def from_features(c=codes, n=lengths, **kw):
            return port.from_features(c, n, **{**call, **kw})

        set_counts(counters)
        ppg = from_features()
        launches, widths = read_counts(counters)
        print(f'launches in one {name} from_features call ({CODEC_BATCH} x '
              f'{CODEC_FRAMES} frames): {launches}, by width: {widths}',
              flush=True)
        if launches != want or widths != want_widths:
            raise AssertionError(f'{name} launches {launches} {widths}, not '
                                 f'{want} {want_widths}')
        check_ppg(f'{name} from_features', ppg, codes,
                  (CODEC_BATCH, 40, CODEC_FRAMES))
        rows, n = codes[:CODEC_CPU_ROWS].cpu(), lengths[:CODEC_CPU_ROWS]
        fp32 = config.replace(compute_dtype='float32')
        agree_decided(f'{name} from_features, {CODEC_CPU_ROWS} x '
                      f'{CODEC_FRAMES} frames, against device=cpu',
                      ppg[:CODEC_CPU_ROWS],
                      from_features(rows, n, device='cpu'),
                      from_features(rows, n, device='cpu', config=fp32),
                      card)
        del ppg
        path_metrics(f'{name} from_features {CODEC_BATCH} x {CODEC_FRAMES} '
                     f'frames ({CODEC_BATCH * CODEC_FRAMES // 100} audio-s)',
                     from_features, CODEC_BATCH * CODEC_FRAMES / 100, card)


def codec_corpus(port, root, card):
    """Phase 28's data: phase 18's recipe for CODEC_FILES wav files and
    TextGrids, the partitions, and beside each TextGrid a cache of seeded
    int32 codes per codec, (Q, frames), written by save_masked."""
    config = port.config.get('mel')
    cache = root / 'cache' / 'commonvoice'
    samples = data_corpus(port, config, cache, CODEC_FILES)
    port.partition.datasets(['commonvoice'])
    rng = np.random.default_rng(SEED + 28)
    for stem, n in samples.items():
        frames = n // config.hopsize
        for name, (Q, V, _, _) in CODEC_BOOKS.items():
            codes = rng.integers(0, V, (Q, frames + 3)).astype(np.int32)
            port.preprocess.save_masked(codes, cache / f'{stem}-{name}.npy',
                                        frames)
    cached = np.load(cache / f'{stem}-dac.npy')
    if cached.dtype != np.int32 or cached.shape != (12, frames):
        raise AssertionError(f'save_masked wrote {cached.dtype} '
                             f'{cached.shape}, not int32 (12, {frames})')
    print(f'corpus: {len(samples)} wav files, TextGrids and int32 code '
          f'caches per codec ({sum(samples.values()) / 16000:.1f} audio-s)',
          flush=True)


def codec_cpu_step(port, name, dev, card):
    """One step at every rate 0 in fp32 on CODEC_FT_ROWS rows of codes, on
    the card and with device='cpu' from the same weights: the loss, every
    gradient and the parameters after Adam (phase 26's limits)."""
    config = port.config.get(name).replace(compute_dtype='float32',
                                           dropout=0.0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    codes, lengths = codec_batch(config, CODEC_FT_ROWS, CODEC_FT_T, gen, dev)
    targets = torch.randint(0, 40, (CODEC_FT_ROWS, CODEC_FT_T),
                            generator=gen, device=dev)
    targets = targets.masked_fill(torch.arange(CODEC_FT_T, device=dev)
                                  >= torch.as_tensor(lengths, device=dev)
                                  [:, None], -100)
    results = []
    core = port.train.core
    for device in (dev, torch.device('cpu')):
        model = core.init_model(config, device,
                                torch.Generator().manual_seed(SEED + 28))
        optimizer = core.make_optimizer(model.parameters(), config)
        step = core.make_train_step(model, config, optimizer)
        grads, original = {}, optimizer.step

        def keep_grads(*a, **k):
            grads.update({n: p.grad.detach().cpu().clone()
                          for n, p in model.named_parameters()})
            return original(*a, **k)

        optimizer.step = keep_grads
        batch = core._to_device((codes, targets, lengths), device)
        loss, _ = step(*batch, seed=5)
        results.append((float(loss), grads, {
            n: p.detach().cpu() for n, p in model.named_parameters()}))
    (loss, grads, params), (loss_cpu, grads_cpu, params_cpu) = results
    norms = {n: grads_cpu[n].norm().item() for n in grads}
    floor = CODEC_NOISE_NORM * max(norms.values())
    noise = sorted(n for n in grads if norms[n] < floor)
    apart = {n: (grads[n] - grads_cpu[n]).norm().item() for n in grads}
    worst, worst_name = max((apart[n] / norms[n], n) for n in grads
                            if n not in noise)
    noise_worst = max((apart[n] / floor for n in noise), default=0.0)
    lr = config.learning_rate
    diff = check(f'{name} rate-0 step: the parameters after Adam',
                 torch.cat([params[n].flatten() for n in params]),
                 torch.cat([params_cpu[n].flatten() for n in params]),
                 FT_CPU_PARAM_ATOL, share=CODEC_PARAM_SHARE,
                 outlier=2 * lr + 1e-6, quiet=True)
    print(f'{name} step at rate 0, fp32, {CODEC_FT_ROWS} x {CODEC_FT_T} '
          f'frames of codes, card against device=cpu: loss {loss:.6f} / '
          f'{loss_cpu:.6f}, gradients within relative L2 {worst:.3g} '
          f'({worst_name}; <= {FT_CPU_GRAD_REL}; {len(noise)} tensors of '
          f'rounding noise '
          f'{noise[:3]}... apart by {noise_worst:.3g} of {CODEC_NOISE_NORM} '
          f'of the largest norm, <= 1), '
          f'parameters after Adam max |diff| {diff:.3g} (atol '
          f'{FT_CPU_PARAM_ATOL}, at most {CODEC_PARAM_SHARE} of them within '
          f'2 lr) [{card}]', flush=True)
    if not abs(loss - loss_cpu) <= 1e-4 * abs(loss_cpu):
        raise AssertionError(f'{name} rate-0 step: loss {loss} on the card, '
                             f'{loss_cpu} on the cpu')
    if worst > FT_CPU_GRAD_REL or noise_worst > 1:
        raise AssertionError(f'{name} rate-0 step: a gradient {worst:.3g} '
                             f'apart (relative L2), or noise {noise_worst:.3g}')


def codec_evaluate(port, checkpoint, card):
    """evaluate.datasets(config='encodec') on the test partition, on the
    card against device='cpu', in fp32 and bf16 (K1-K4 launched); the
    figures written where matplotlib imports."""
    counters = inference_counters()
    config = port.config.get('encodec')
    for dtype, flips, rtol in (
            ('float32', CODEC_EVAL_FLIPS, 1e-5),
            ('bfloat16', EVAL_BF16_FLIPS, CODEC_EVAL_BF16_RTOL)):
        run = config.replace(compute_dtype=dtype)
        set_counts(counters)
        start = time.perf_counter()
        card_results = port.evaluate.datasets(['commonvoice'],
                                              checkpoint=checkpoint,
                                              config=run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches, _ = read_counts(counters)
        if dtype == 'bfloat16' and min(launches.values()) == 0:
            raise AssertionError(f'evaluate.datasets(encodec): a kernel '
                                 f'never launched: {launches}')
        cpu_results = port.evaluate.datasets(['commonvoice'],
                                             checkpoint=checkpoint,
                                             config=run, device='cpu')
        frames = sum(v for k, v in cpu_results['aggregate'].items()
                     if k.startswith('Count/'))
        for key in ('commonvoice', 'aggregate'):
            worst, moved = eval_apart(f'encodec {dtype} {key}',
                                      card_results[key], cpu_results[key],
                                      False, rtol)
            if moved > flips * frames:
                raise AssertionError(f'encodec {dtype} {key}: {moved} true '
                                     f'positives moved (<= {flips * frames})')
        print(f'evaluate.datasets(config=encodec, {dtype}) on the card: '
              f'{wall:.3f} s wall, launches {launches}; against '
              f'device=cpu on {frames:.0f} frames: target counts equal, '
              f'{moved:.0f} true positives moved (<= {flips * frames:.0f}), '
              f'loss and JSD within {worst:.3g} relative (<= {rtol}); '
              f'accuracy '
              f'{card_results["aggregate"]["Accuracy"]:.4f} [{card}]',
              flush=True)
    eval_dir = port.config.EVAL_DIR / 'encodec'
    wanted = [eval_dir / 'commonvoice.json', eval_dir / 'overall.json',
              eval_dir / 'commonvoice' / 'tensors.npz']
    drawn = port.evaluate.metrics.figures_available()
    if drawn:
        wanted += [eval_dir / 'commonvoice' / f'{figure}.{suffix}'
                   for figure in ('ConfusionMatrix', 'DistanceMatrix')
                   for suffix in ('jpg', 'pdf')]
    missing = [str(p) for p in wanted if not p.exists()]
    if missing:
        raise AssertionError(f'evaluate.datasets did not write {missing}')
    print(f'the JSON files and tensors.npz written'
          f'{", and the four figure files" if drawn else "; matplotlib is absent: no figure drawn (host work, held by the CPU tests)"}',
          flush=True)


def codec_training(port, paths, root, dev, card):
    """Phase 28: the code corpus; train(config=encodec) and (config=dac)
    from its caches, each step's path and launches exact; the rate-0 step
    against the CPU; evaluate.datasets(config='encodec') against the CPU."""
    codec_corpus(port, root, card)
    counters = train_counters()
    core = port.train.core
    checkpoints = {}
    for name in CODEC_BOOKS:
        config = port.config.get(name)
        steps = []
        set_counts(counters)
        original = recording_steps(core, steps, counters)
        try:
            start = time.perf_counter()
            port.train.train('commonvoice', root / 'runs' / name,
                             config=config, max_steps=CODEC_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        finally:
            core.make_train_step = original
        launches, _ = read_counts(counters)
        print(f'train(\'commonvoice\', config={name!r}) from the code '
              f'caches: {len(steps)} steps with the step-0 evaluation, '
              f'{wall:.3f} s [{card}]', flush=True)
        if len(steps) != CODEC_STEPS:
            raise AssertionError(f'the run took {len(steps)} steps')
        check_data_steps(port, config, name, steps)
        print(f'the train kernels\' launches in the run: {launches}',
              flush=True)
        checkpoints[name] = core.latest_checkpoint(root / 'runs' / name)
        codec_cpu_step(port, name, dev, card)
    codec_evaluate(port, checkpoints['encodec'], card)


def codec_plots(port, paths, root, dev, gen, card):
    """Phase 29: plot.from_files_to_files from seeded wavs with the mel
    head (K1-K4 launched; each plotted PPG from_file's on the card bit for
    bit; the PNG's cells its pixels where PIL imports); profiling.trace
    around one from_audio call (K1-K4 named in the Chrome trace); python -m
    ppgs_tpu_torch.plot.accuracy on phase 28's JSONs where matplotlib
    imports."""
    import importlib.util

    plot_core = port.plot.core
    config = port.config.get('mel')
    folder = root / 'plots'
    folder.mkdir()
    rng = np.random.default_rng(SEED + 29)
    wavs = []
    for i, seconds in enumerate(PLOT_SECONDS):
        wavs.append(folder / f'p{i}.wav')
        port.data.audio.save_wav(wavs[-1], (0.1 * rng.standard_normal(
            (1, int(seconds * 16000)))).astype(np.float32))
    outs = [folder / f'p{i}.png' for i in range(len(wavs))]
    pil = importlib.util.find_spec('PIL') is not None
    plotted, draw = [], plot_core.from_ppg_to_image_file

    def recording(ppg, output_file, *args, **kwargs):
        plotted.append(np.array(ppg))
        if pil:
            draw(ppg, output_file, *args, **kwargs)

    counters = inference_counters()
    plot_core.from_ppg_to_image_file = recording
    try:
        set_counts(counters)
        start = time.perf_counter()
        port.plot.from_files_to_files(outs, audio_files=wavs,
                                      checkpoint=paths['mel'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches, _ = read_counts(counters)
    finally:
        plot_core.from_ppg_to_image_file = draw
    print(f'plot.from_files_to_files from {len(wavs)} wav files '
          f'({sum(PLOT_SECONDS):.1f} audio-s) with the mel head: {wall:.3f} s '
          f'wall, launches {launches} [{card}]', flush=True)
    if launches != {name: 5 * len(wavs) for name in counters}:
        raise AssertionError(f'plot launches {launches}, not 5 a file')
    for wav, out, ppg in zip(wavs, outs, plotted):
        want = port.from_file(wav, checkpoint=paths['mel']).cpu().numpy()
        if not np.array_equal(ppg, want):
            raise AssertionError(f'{wav.name}: the plotted PPG is not '
                                 f'from_file\'s on the card')
        if pil:
            from PIL import Image

            with Image.open(out) as image:
                pixels = np.asarray(image.convert('RGB'))
            cells = pixels[::plot_core.CELL_HEIGHT,
                           plot_core.LABEL_WIDTH::plot_core.CELL_WIDTH, 0]
            if not np.array_equal(cells, plot_core._ppg_to_pixels(want)):
                raise AssertionError(f'{out.name}: its cells are not the '
                                     f'PPG\'s pixels')
    print(f'each plotted PPG from_file\'s on the card bit for bit'
          f'{", each PNG" + chr(39) + "s cells its pixels" if pil else "; PIL is absent: no PNG drawn (drawing is host work, held by the CPU tests)"}',
          flush=True)

    audio = 0.1 * torch.randn(PROFILE_BATCH, 1, SECONDS * 16000,
                              generator=gen, device=dev)
    with port.utils.profiling.trace(root / 'trace') as log_dir:
        with port.utils.profiling.annotate('from_audio'):
            port.from_audio(audio, 16000, checkpoint=paths['mel'])
    path = port.utils.profiling.trace.path
    events = json.loads(path.read_text())['traceEvents']
    kernels = [e['name'] for e in events if e.get('cat') == 'kernel']
    named = {key: sum(key in k for k in kernels) for key in (
        'qkv_proj_kernel', 'attention_kernel<', 'out_proj_ln_kernel',
        'ffn_fused_kernel')}
    print(f'profiling.trace around from_audio ({PROFILE_BATCH} x {SECONDS} '
          f's): {path.name} in {log_dir}, {path.stat().st_size:,} bytes, '
          f'{len(events)} events, {len(kernels)} kernel events; K1-K4 '
          f'named: {named}', flush=True)
    if min(named.values()) == 0 or not any(
            e.get('name') == 'from_audio' for e in events):
        raise AssertionError('the trace does not name K1-K4 and the '
                             'annotated region')

    if importlib.util.find_spec('matplotlib') is None:
        print('matplotlib is absent: python -m ppgs_tpu_torch.plot.accuracy '
              'not run (host work, held by the CPU tests)', flush=True)
        return
    chart = root / 'eval' / 'accuracy.png'
    start = time.perf_counter()
    subprocess.run([sys.executable, '-m', 'ppgs_tpu_torch.plot.accuracy',
                    '--output_file', str(chart), '--datasets', 'commonvoice',
                    '--representations', *CODEC_BOOKS],
                   cwd=Path(__file__).resolve().parent, check=True,
                   env={**os.environ, 'PPGS_ROOT_DIR': str(root)})
    if not chart.exists() or not chart.stat().st_size:
        raise AssertionError('the accuracy chart was not written')
    print(f'python -m ppgs_tpu_torch.plot.accuracy on phase 28\'s JSONs: '
          f'{chart.name}, {chart.stat().st_size:,} bytes, '
          f'{time.perf_counter() - start:.1f} s', flush=True)


def codec_phases(port, workdir, dev, card):
    """Phases 27-29: the codec slice (no kernel of its own: the codec heads
    run K1-K4 and the train kernels at the mel head's width)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    root = Path(workdir) / 'codec'
    books_dir = port.frontend.CODEBOOK_DIR
    saved = point_data_dirs(port, root)
    try:
        phase(f'27 the codec heads\' inference: decode_codes and '
              f'from_features(config=encodec, dac) on {CODEC_BATCH} x '
              f'{CODEC_FRAMES} frames of codes (main path)')
        paths = codec_setup(port, workdir)
        codec_inference(port, paths, dev, gen, card)
        torch.cuda.empty_cache()
        phase(f'28 train(config=encodec, dac) from {CODEC_FILES} code caches '
              f'and evaluate.datasets(config=encodec)')
        codec_training(port, paths, root, dev, card)
        phase('29 plot.from_files_to_files, profiling.trace and python -m '
              'ppgs_tpu_torch.plot.accuracy')
        codec_plots(port, paths, root, dev, gen, card)
    finally:
        for name, value in saved.items():
            setattr(port.config, name, value)
        port.frontend.CODEBOOK_DIR = books_dir
        for name in CODEC_BOOKS:
            port.frontend.unregister(name)


###############################################################################
# The parallel slice (phases 30-32)
###############################################################################


# Phase 30: the one-rank NCCL group, the train slice's batch geometry;
# one file of 8 s (a multiple of the loader's 16,000-sample quantum, so
# that its batch is from_file's geometry) through from_dataloader
PAR_FILE_SECONDS = 8
# Phase 31: two ranks sharing the card over gloo. DP: 2 steps on a global
# 256 x 512 batch, 128 rows a rank, rank 1's last PAR_PAD_ROWS rows -100
# padding; CP: 8 x 60 s (6,000 frames, padded to 6,400: 8 windows an
# utterance a rank); TP: 16 x 8 s
PAR_DP_STEPS, PAR_PAD_ROWS = 2, 16
PAR_CP_BATCH, PAR_CP_SECONDS = 8, 60
PAR_TP_BATCH, PAR_TP_SECONDS = 16, 8
# Phase 32: the mel width (C = 256, d_head 128) with its depth cut to 4
# layers, since mel's 5 do not divide over 2 stages; 4 microbatches of
# 32 x 500 (the per-layer path: T % 8 != 0)
PP_LAYERS, PP_MICRO, PP_ROWS, PP_T = 4, 4, 32, 500
# DP on the card: each parameter within relative L2 2^-8 of one process's
# (the sums run in another order); PP's gradients likewise
PAR_REL = 2.0 ** -8
RANK_TIMEOUT = 600


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def group_env(ranks, rank, port):
    return {'PPGS_COORDINATOR': f'127.0.0.1:{port}',
            'PPGS_NUM_PROCESSES': str(ranks), 'PPGS_PROCESS_ID': str(rank)}


def run_ranks(mode, workdir, card, ranks=2):
    """Run ``mode`` of ``parallel_rank`` in ``ranks`` processes of one gloo
    group sharing the card (this script, --parallel-rank); raise if a
    rank fails or outlives RANK_TIMEOUT. Returns each rank's results."""
    port = free_port()
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, **group_env(ranks, rank, port))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             '--parallel-rank', mode, str(workdir)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    deadline = time.time() + RANK_TIMEOUT
    outputs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=max(1, deadline - time.time()))
            outputs.append(out.decode(errors='replace'))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        for line in out.splitlines():
            if line.startswith('rank '):
                print(line, flush=True)
        if proc.returncode != 0:
            print(out[-8000:], flush=True)
            raise AssertionError(f'{mode}: rank {rank} failed '
                                 f'(rc {proc.returncode})')
    found = []
    for rank in range(ranks):
        data = torch.load(Path(workdir) / f'{mode}-rank{rank}.pt',
                          weights_only=True)
        found.append(data)
    return found


def parallel_setup(port, workdir):
    """Seeded weights of the slice's models in npz files: the mel model,
    its 4-layer cut for the pipeline, the w2v2fb trunk and head, the
    conformer; returns their paths."""
    config = port.config.get()
    paths = {name: Path(workdir) / f'parallel-{name}.npz' for name in (
        'mel', 'pipe', 'trunk', 'w2v2fb', 'conformer')}
    port.load.save_params(paths['mel'], random_params(port, config,
                                                      SEED + 30))
    port.load.save_params(paths['pipe'], random_params(
        port, config.replace(num_hidden_layers=PP_LAYERS), SEED + 31))
    port.load.save_params(paths['trunk'], random_w2v2_params(port, SEED + 32))
    port.load.save_params(paths['w2v2fb'], random_params(
        port, port.config.get('w2v2fb'), SEED + 33))
    port.load.save_params(paths['conformer'],
                          random_conformer_params(port, SEED + 34))
    return paths


def parallel_configs(port):
    """The mel config of the DP comparison (dropout 0: a data rank draws
    its own Philox stream, so only at rate 0 is DP training the single
    process's function), its CP and TP meshes, and the pipeline's."""
    mel = port.config.get()
    return {'dp': mel.replace(dropout=0.0, evaluation_interval=10 ** 9,
                              checkpoint_interval=10 ** 9),
            'cp': mel.replace(mesh_shape=(2,), mesh_axis_names=('seq',)),
            'tp': port.config.get('w2v2fb').replace(
                mesh_shape=(2,), mesh_axis_names=('model',)),
            'tp_bn': port.config.get('bottleneck').replace(
                mesh_shape=(2,), mesh_axis_names=('model',)),
            'pipe': mel.replace(num_hidden_layers=PP_LAYERS, dropout=0.0,
                                mesh_shape=(2,), mesh_axis_names=('pipe',))}


def point_frontends(port, paths):
    port.preprocess.w2v2fb.W2V2FB_CHECKPOINT = paths['trunk']
    port.preprocess.bottleneck.BOTTLENECK_CHECKPOINT = paths['conformer']


def seeded_audio(B, seconds, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return 0.1 * torch.randn(B, 1, int(seconds * 16000), generator=gen,
                             device=dev)


def dp_batch(config, dev):
    """The global batch of the DP steps: the train slice's geometry, rank
    1's last PAR_PAD_ROWS rows all -100."""
    features, targets, lengths = train_batch(config, TRAIN_B, TRAIN_T,
                                             SEED + 35, dev)
    targets = targets.clone()
    targets[-PAR_PAD_ROWS:] = -100
    return features, targets, lengths


def seed_run(port, config, directory):
    """A step-0 checkpoint of seeded weights (biases and norms drawn too)
    and a fresh Adam state in ``directory``, for ``train`` to resume from:
    from the init's zero biases two Adam steps leave tensors of about 2
    lr, whose relative error rounding-flipped signs dominate."""
    params = port.load.flatten_params(random_params(port, config,
                                                    SEED + 44))
    flat = {f'params.{k}': v for k, v in params.items()}
    flat['opt_state.count'] = np.asarray(0, np.int32)
    for moment in ('mu', 'nu'):
        flat.update({f'opt_state.{moment}.{k}': np.zeros_like(v)
                     for k, v in params.items()})
    port.train.core.ckpt.npz_save(directory, 0, 0, flat)


def dp_train(port, config, directory, dev, counters=None):
    """PAR_DP_STEPS steps of ``train`` on ``dp_batch`` from ``seed_run``'s
    weights: (the model, the losses, each step's launches of
    ``counters``)."""
    seed_run(port, config, directory)
    batch = dp_batch(config, dev)
    valid = [train_batch(config, 64, TRAIN_T, SEED + 36, dev)]
    snapshots, losses = [], []

    def loader_fn(partition):
        if partition != 'train':
            yield from valid
            return
        while True:
            if counters is not None:
                torch.cuda.synchronize()
                snapshots.append({n: f.launches for n, f in counters.items()})
            yield batch

    core = port.train.core
    original = recording_losses(core, losses)
    try:
        model = port.train.train(directory=directory, config=config,
                                 max_steps=PAR_DP_STEPS, loader_fn=loader_fn,
                                 device=dev)
    finally:
        core.make_train_step = original
    torch.cuda.synchronize()
    if counters is not None:
        snapshots.append({n: f.launches for n, f in counters.items()})
    steps = [{n: b[n] - a[n] for n in a}
             for a, b in zip(snapshots[:-1], snapshots[1:])]
    return model, losses, steps


def without_key_bias(name, *grads):
    """The gradients of ``name`` with the key bias's third of a fused QKV
    bias zeroed: softmax ignores a shift of a row's scores, so that
    gradient is 0 up to rounding noise, which no relative error bounds."""
    if not name.endswith('attn.bqkv'):
        return grads
    out = []
    for g in grads:
        g = g.clone()
        C = g.shape[0] // 3
        g[C:2 * C] = 0
        out.append(g)
    return out


def pipeline_batch(config, dev):
    return train_batch(config, PP_MICRO * PP_ROWS, PP_T, SEED + 37, dev)


def pipeline_counters():
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    return {'attention': fa.attention,
            'ffn_residual_ln': fused_ffn.ffn_residual_ln,
            'attention_train_fwd': fa.attention_train_fwd,
            'attention_train_bwd': fa.attention_train_bwd,
            'row_dot': fa.row_dot,
            'ffn_train_fwd': fused_ffn.ffn_train_fwd,
            'ffn_train_bwd': fused_ffn.ffn_train_bwd}


def parallel_rank(mode, workdir):
    """One rank of phase 31 ('p31') or 32 ('p32'), on the card, in a gloo
    group: its results into ``workdir``/``mode``-rank{r}.pt."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import ppgs_tpu_torch as port
    from ppgs_tpu_torch.parallel import comm, multihost

    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(backend='gloo', device=dev)
    rank = multihost.process_index()
    workdir = Path(workdir)
    paths = {p.stem.split('-', 1)[1]: p
             for p in workdir.glob('parallel-*.npz')}
    configs = parallel_configs(port)
    out = {}
    if mode == 'p31':
        start = time.perf_counter()
        model, losses, steps = dp_train(port, configs['dp'], workdir /
                                        f'dp{rank}', dev, train_counters())
        out['dp_losses'] = torch.tensor(losses)
        out['dp_steps'] = steps
        out['dp_counts'] = dict(comm.counts)
        if rank == 0:
            out['dp_params'] = {n: p.detach().cpu()
                                for n, p in model.named_parameters()}
        del model
        dp_s = time.perf_counter() - start

        start = time.perf_counter()
        audio = seeded_audio(PAR_CP_BATCH, PAR_CP_SECONDS, SEED + 38, dev)
        features = port.preprocess.mel.from_audios(audio, None, device=dev)
        counters = inference_counters()
        set_counts(counters)
        ppg = port.infer(features, [features.shape[-1]] * PAR_CP_BATCH,
                         checkpoint=paths['mel'], config=configs['cp'],
                         device=dev)
        out['cp_launches'] = read_counts(counters)[0]
        out['cp_ppg'] = ppg.cpu()
        out['cp_halo'] = comm.counts[('halo', 'gloo')]
        cp_s = time.perf_counter() - start

        start = time.perf_counter()
        point_frontends(port, paths)
        audio = seeded_audio(PAR_TP_BATCH, PAR_TP_SECONDS, SEED + 39, dev)
        counters = inference_counters()
        set_counts(counters)
        out['tp_ppg'] = port.from_audio(
            audio, checkpoint=paths['w2v2fb'], config=configs['tp'],
            device=dev).cpu()
        out['tp_launches'], out['tp_widths'] = read_counts(counters)
        from ppgs_tpu_torch.ops import flash_attention as fa

        fa.rel_attention.launches = 0
        out['tp_bn'] = port.preprocess.bottleneck.from_audios(
            audio, None, config=configs['tp_bn'], device=dev).cpu()
        torch.cuda.synchronize()
        out['tp_bn_b8'] = fa.rel_attention.launches
        out['tp_bytes'] = {
            key[0]: [port.parallel.local_bytes(p.model.module,
                                               set(p.model._dims)),
                     port.parallel.local_bytes(p.model.module)]
            for key, p in port.parallel._FRONTEND_TP_CACHE.items()}
        tp_s = time.perf_counter() - start
        print(f'rank {rank}: DP {dp_s:.1f} s, CP {cp_s:.1f} s, TP '
              f'{tp_s:.1f} s; collectives {dict(comm.counts)}', flush=True)
    else:
        config = configs['pipe']
        mesh = port.parallel.make_mesh(config.mesh_shape,
                                       config.mesh_axis_names)
        net = port.load.model(checkpoint=paths['pipe'], config=config,
                              device=dev)[0]
        features, targets, lengths = pipeline_batch(config, dev)
        counters = pipeline_counters()
        set_counts(counters)
        out['pp_logits'] = port.parallel.pipeline_forward(
            net, features, lengths, mesh, num_microbatches=PP_MICRO).cpu()
        out['pp_infer_launches'] = read_counts(counters)[0]
        net.requires_grad_(True)
        set_counts(counters)
        logits = port.parallel.pipeline_forward(
            net, features, lengths, mesh, num_microbatches=PP_MICRO,
            train=True, seed=0)
        loss = port.train.loss(logits, targets)
        (loss / mesh.shape['pipe']).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in net.parameters()]
        flat = torch.cat([g.reshape(-1) for g in grads])
        comm.all_reduce_sum(flat, mesh.group('pipe'), 'gradients')
        out['pp_train_launches'] = read_counts(counters)[0]
        out['pp_train_logits'] = logits.detach().cpu()
        if rank == 0:
            offset, named = 0, {}
            for (name, p) in net.named_parameters():
                named[name] = flat[offset:offset + p.numel()].view_as(
                    p).cpu()
                offset += p.numel()
            out['pp_grads'] = named
        print(f'rank {rank}: stage {mesh.index("pipe")}, inference '
              f'{out["pp_infer_launches"]}, training '
              f'{out["pp_train_launches"]}; collectives '
              f'{dict(comm.counts)}', flush=True)
    torch.save(out, workdir / f'{mode}-rank{rank}.pt')
    multihost.shutdown()


def one_rank_group(port, workdir, dev, card):
    """Phase 30: ``train(config='mel')`` without a group and in a one-rank
    NCCL group (PPGS_* set), bit for bit; B4's kernels and one NCCL
    gradient all_reduce each step; then one from_dataloader batch through
    the data-parallel branch against from_file."""
    from ppgs_tpu_torch.parallel import comm, multihost

    config = port.config.get().replace(checkpoint_interval=2)
    counters = train_counters()
    batch = train_batch(config, TRAIN_B, TRAIN_T, SEED + 40, dev)
    valid = [train_batch(config, 64, TRAIN_T, SEED + 41, dev)]

    def run(name):
        snapshots = []

        def loader_fn(partition):
            if partition != 'train':
                yield from valid
                return
            while True:
                torch.cuda.synchronize()
                snapshots.append({n: f.launches for n, f in counters.items()})
                yield batch

        start = time.perf_counter()
        model = port.train.train(directory=Path(workdir) / name,
                                 config=config, max_steps=TRAIN_STEPS,
                                 loader_fn=loader_fn, device=dev)
        torch.cuda.synchronize()
        snapshots.append({n: f.launches for n, f in counters.items()})
        print(f'{name}: {TRAIN_STEPS} steps at {TRAIN_B} x {TRAIN_T}, '
              f'{time.perf_counter() - start:.1f} s [{card}]', flush=True)
        return model, [{n: b[n] - a[n] for n in a}
                       for a, b in zip(snapshots[:-1], snapshots[1:])]

    # cuDNN's fp32 weight gradient of the input conv may pick an
    # algorithm that sums with atomics; the comparison needs a step that
    # repeats itself, so this phase asks cuDNN for deterministic ones and
    # shows first that the ungrouped run repeats bit for bit
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    alone, _ = run('ungrouped')
    again, _ = run('ungrouped-again')
    if not all(torch.equal(a, b) for a, b in zip(alone.parameters(),
                                                 again.parameters())):
        raise AssertionError('two ungrouped runs differ: the steps do not '
                             'repeat bit for bit')
    del again
    os.environ.update(group_env(1, 0, free_port()))
    comm.counts.clear()
    try:
        grouped, steps = run('one-rank-nccl')
        backend = multihost.initialize(device=dev)
        counts = dict(comm.counts)
        print(f'the group: {backend}, {multihost.process_count()} rank; '
              f'collectives {counts}', flush=True)
        if backend != 'nccl' or counts.get(('gradients', 'nccl')) != \
                TRAIN_STEPS:
            raise AssertionError(f'not one NCCL gradient all_reduce a step: '
                                 f'{counts}')
        L = config.num_hidden_layers
        for i, step in enumerate(steps):
            for name, per_layer in B4_PER_LAYER.items():
                if step[name] < L * per_layer:
                    raise AssertionError(f'grouped step {i}: {name} '
                                         f'launched {step[name]} times')
        print(f'grouped step 1 launches: {steps[1]}', flush=True)
        different = [n for (n, a), b in zip(alone.named_parameters(),
                                            grouped.parameters())
                     if not torch.equal(a, b)]
        if different:
            raise AssertionError(f'the one-rank group\'s parameters differ '
                                 f'from the ungrouped run\'s: {different}')
        print(f'parameters after {TRAIN_STEPS} steps: the one-rank NCCL '
              f'group\'s equal the ungrouped run\'s bit for bit '
              f'({len(list(alone.parameters()))} tensors) [{card}]',
              flush=True)

        # The NCCL all_reduce's share of a grouped step's device time
        mesh = port.parallel.make_mesh(config.mesh_shape,
                                       config.mesh_axis_names)
        optimizer = port.train.make_optimizer(grouped.parameters(), config)
        step = port.train.make_train_step(grouped, config, optimizer,
                                          mesh=mesh)
        step(*batch, 1)
        by_name = profile_call('one-rank NCCL train step', lambda: step(
            *batch, 2), card)
        nccl = sum(ms for name, ms in by_name.items()
                   if 'nccl' in name.lower())
        total = sum(by_name.values())
        share = f'{nccl / total:.5f}' if total else 'not measured'
        print(f'NCCL all_reduce in the grouped step: {nccl:.4f} ms of '
              f'{total:.3f} ms device time ({share}) [{card}]', flush=True)
        del alone, grouped, optimizer, step

        # One from_dataloader batch through the data-parallel branch
        from ppgs_tpu_torch.data import loader as data_loader

        wav = Path(workdir) / 'parallel-file.wav'
        port.data.audio.save_wav(wav, seeded_audio(
            1, PAR_FILE_SECONDS, SEED + 42, dev)[0].cpu().numpy())
        npz = Path(workdir) / 'parallel-file-model.npz'
        port.load.save_params(npz, random_params(port, port.config.get(),
                                                 SEED + 43))
        out = Path(workdir) / 'parallel-file.npy'
        counters = inference_counters()
        set_counts(counters)
        port.from_dataloader(
            data_loader([wav], features=['audio', 'length', 'audio_file'],
                        num_workers=1, config=port.config.get()),
            {str(wav): out}, checkpoint=npz, device=dev)
        launches = read_counts(counters)[0]
        want = port.from_file(wav, checkpoint=npz, device=dev).cpu().numpy()
        got = np.load(out)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError('the data-parallel branch\'s PPGs differ '
                                 'from from_file\'s')
        print(f'from_dataloader through the data-parallel branch (one '
              f'rank): {got.shape}, from_file\'s bit for bit; launches '
              f'{launches} [{card}]', flush=True)
        if min(launches.values()) < 1:
            raise AssertionError(f'a kernel was not launched: {launches}')
    finally:
        torch.backends.cudnn.deterministic = deterministic
        multihost.shutdown()
        for name in group_env(1, 0, 0):
            os.environ.pop(name, None)


def two_ranks(port, workdir, paths, dev, card):
    """Phase 31: DP, CP and TP over two ranks that share the card (gloo),
    each against one process on the card."""
    configs = parallel_configs(port)
    torch.cuda.empty_cache()
    found = run_ranks('p31', workdir, card)

    # DP: the loss and every parameter against one process's steps
    model, losses, _ = dp_train(port, configs['dp'], Path(workdir) / 'dp',
                                dev)
    for rank, data in enumerate(found):
        got = data['dp_losses'].tolist()
        print(f'DP rank {rank}: losses {got}, one process {losses}; '
              f'collectives {data["dp_counts"]}', flush=True)
        if not np.allclose(got, losses, rtol=1e-4, atol=0):
            raise AssertionError('the DP loss is not the one process\'s')
        for i, step in enumerate(data['dp_steps']):
            for name, per_layer in B4_PER_LAYER.items():
                if step[name] < configs['dp'].num_hidden_layers * per_layer:
                    raise AssertionError(f'DP rank {rank} step {i}: {name} '
                                         f'launched {step[name]} times')
    worst, name = max((relative_l2(found[0]['dp_params'][n].to(dev),
                                   p.detach()), n)
                      for n, p in model.named_parameters())
    print(f'DP parameters after {PAR_DP_STEPS} steps: the largest relative '
          f'L2 error of a tensor {worst:.3g} (<= 2^-8, {name}) [{card}]',
          flush=True)
    if not worst <= PAR_REL:
        raise AssertionError('a DP parameter left 2^-8')
    del model

    # CP: the bf16 PPGs against one process's, fp32 beside them
    audio = seeded_audio(PAR_CP_BATCH, PAR_CP_SECONDS, SEED + 38, dev)
    features = port.preprocess.mel.from_audios(audio, None, device=dev)
    lengths = [features.shape[-1]] * PAR_CP_BATCH
    want = port.infer(features, lengths, checkpoint=paths['mel'], device=dev)
    want32 = port.infer(features, lengths, checkpoint=paths['mel'],
                        config=port.config.get().replace(
                            config='mel-fp32', compute_dtype='float32'),
                        device=dev)
    for rank, data in enumerate(found):
        print(f'CP rank {rank}: launches {data["cp_launches"]}, '
              f'{data["cp_halo"]} halo exchange', flush=True)
        if data['cp_launches'] != {n: 5 for n in data['cp_launches']}:
            raise AssertionError('CP: K1-K4 not launched 5 times a rank')
        agree_decided(f'CP rank {rank}, {PAR_CP_BATCH} x {PAR_CP_SECONDS} s',
                      data['cp_ppg'], want, want32, card)
    del want, want32

    # TP: the w2v2fb PPGs and the conformer's features bit for bit
    point_frontends(port, paths)
    audio = seeded_audio(PAR_TP_BATCH, PAR_TP_SECONDS, SEED + 39, dev)
    want = port.from_audio(audio, checkpoint=paths['w2v2fb'],
                           config='w2v2fb', device=dev).cpu()
    want_bn = port.preprocess.bottleneck.from_audios(
        audio, None, config='bottleneck', device=dev).cpu()
    whole = {'w2v2_module_dims': port.preprocess.w2v2fb._trunk(
        dataclasses.replace(port.models.w2v2.BASE,
                            compute_dtype='bfloat16'), 'cpu'),
             'conformer_module_dims': port.preprocess.bottleneck._encoder(
        dataclasses.replace(port.models.conformer.BOTTLENECK,
                            compute_dtype='bfloat16'), 'cpu')}
    for rank, data in enumerate(found):
        for rule, full in whole.items():
            dims = getattr(port.parallel, rule)(full)
            split = port.parallel.local_bytes(full, set(dims))
            local_split, local_whole = data['tp_bytes'][rule]
            print(f'TP rank {rank}, {rule}: {local_split} of the {split} '
                  f'bytes of the split parameters, {local_whole} of '
                  f'{port.parallel.local_bytes(full)} in all', flush=True)
            if 2 * local_split != split:
                raise AssertionError('TP: a rank does not hold half')
        print(f'TP rank {rank}: w2v2fb launches {data["tp_launches"]} by '
              f'width {data["tp_widths"]}; the conformer launched B8 '
              f'{data["tp_bn_b8"]} times', flush=True)
        if not (torch.equal(data['tp_ppg'], want)
                and torch.equal(data['tp_bn'], want_bn)):
            raise AssertionError('TP: the outputs are not one process\'s')
        if data['tp_bn_b8'] != 16 or data['tp_launches']['qkv_proj'] != 17:
            raise AssertionError('TP: B7 / B8 not launched as one process')
    print(f'TP: w2v2fb PPGs {tuple(want.shape)} and the conformer\'s '
          f'features {tuple(want_bn.shape)} one process\'s bit for bit on '
          f'both ranks [{card}]', flush=True)


def pipeline_on_card(port, workdir, paths, dev, card):
    """Phase 32: the pipeline over two ranks against the sequential
    per-layer path in one process."""
    from ppgs_tpu_torch.models import transformer

    configs = parallel_configs(port)
    torch.cuda.empty_cache()
    found = run_ranks('p32', workdir, card)
    config = configs['pipe']
    net = port.load.model(checkpoint=paths['pipe'], config=config,
                          device=dev)[0]
    features, targets, lengths = pipeline_batch(config, dev)
    with torch.no_grad():
        # the sequential per-layer path: the stage body's, whole batch
        T = features.shape[-1]
        mask = port.ops.masking.mask_from_lengths(lengths, T)
        x = transformer.conv1d_same(features, net.input_conv.weight,
                                    net.input_conv.bias)
        x = (x.transpose(1, 2) * mask[..., None] + net.pe[:T]).contiguous()
        for layer in net.layers:
            x = transformer._encoder_layer(
                x, layer, mask, False, config.attention_heads,
                torch.bfloat16, True)
        x = transformer.conv1d_same(x.transpose(1, 2),
                                    net.output_conv.weight,
                                    net.output_conv.bias)
        want = (x * mask[:, None, :]).float()
    net.requires_grad_(True)
    logits = transformer.forward(net, features, lengths, train=True, seed=0)
    port.train.loss(logits, targets).backward()
    stage_layers = PP_LAYERS // 2
    ticks = PP_MICRO + 1
    for rank, data in enumerate(found):
        inf, tr = data['pp_infer_launches'], data['pp_train_launches']
        print(f'PP rank {rank}: inference launches {inf}, training '
              f'{tr}', flush=True)
        if (inf['attention'] != stage_layers * ticks
                or inf['ffn_residual_ln'] != stage_layers * ticks
                or tr['attention_train_fwd'] != stage_layers * ticks
                or tr['attention_train_bwd'] != stage_layers * ticks):
            raise AssertionError('PP: a stage did not launch K2 / K4 / B5 '
                                 'once a layer a tick')
        for name, got, ref in (('inference', data['pp_logits'], want),
                               ('training', data['pp_train_logits'],
                                logits.detach())):
            ppg, ref_ppg = (torch.softmax(t.float().to(dev), 1)
                            for t in (got, ref))
            diff = (ppg - ref_ppg).abs().max().item()
            agree_rate = (ppg.argmax(1) == ref_ppg.argmax(1))[
                mask].float().mean().item()
            print(f'PP rank {rank} {name}: PPGs max |diff| {diff:.3g} (atol '
                  f'2e-2), argmax agreement {agree_rate:.5f} (>= 0.995) '
                  f'[{card}]', flush=True)
            if diff > 2e-2 or agree_rate < 0.995:
                raise AssertionError(f'PP {name}: outside the bf16 envelope')
    worst, name = max((relative_l2(*without_key_bias(
        n, found[0]['pp_grads'][n].to(dev), p.grad)), n)
        for n, p in net.named_parameters())
    print(f'PP gradients: the largest relative L2 error of a tensor '
          f'{worst:.3g} (<= 2^-8, {name}; the key biases\' thirds left '
          f'out) [{card}]', flush=True)
    if not worst <= PAR_REL:
        raise AssertionError('a PP gradient left 2^-8')
    return found[0]['pp_infer_launches'], found[0]['pp_train_launches']


@torch.no_grad()
def parallel_records(port, paths, launches, dev, gen, card):
    """The slice's kernel records: K1-K4 at a CP rank's windows (8
    utterances x 8 windows of 500 frames), held against their plain
    versions and timed; the launches are a rank's in phases 31 and 32."""
    model = port.load.model(checkpoint=paths['mel'],
                            config=port.config.get(), device=dev)[0]
    layer = model.layers[0]
    rows = PAR_CP_BATCH * 8
    x = torch.randn(rows, 500, 256, generator=gen, device=dev)
    mask = torch.ones(rows, 500, dtype=torch.bool, device=dev)
    mask[-1, 310:] = False
    err, inputs = {}, {}
    layer_kernel_checks('parallel_cp', x, mask, layer_weights(layer), 2,
                        'relu', err, inputs)
    per_tag = {name: {'parallel_cp': count}
               for name, count in launches.items()}
    records = layer_records('parallel_cp', inputs['parallel_cp'], err,
                            per_tag, 'ppgs_tpu/ops/encoder_layer_kernel.py'
                            ':269', card)
    for record in records:
        record['name'] = f'parallel/{record["name"]}'
    return records


def parallel_phases(port, workdir, dev, card):
    """Phases 30-32: the parallel slice (no kernel of its own: its paths
    run K1-K4, B4, B5, B6, B7 and B8)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    saved = (port.preprocess.w2v2fb.W2V2FB_CHECKPOINT,
             port.preprocess.bottleneck.BOTTLENECK_CHECKPOINT)
    try:
        phase('30 a one-rank NCCL group: train(config=mel) against the '
              'ungrouped run, from_dataloader\'s data-parallel branch')
        one_rank_group(port, workdir, dev, card)
        torch.cuda.empty_cache()
        phase('31 two ranks sharing the card over gloo: DP training, CP '
              'inference, TP w2v2fb and conformer')
        paths = parallel_setup(port, workdir)
        two_ranks(port, workdir, paths, dev, card)
        torch.cuda.empty_cache()
        phase(f'32 PP: the mel width cut to {PP_LAYERS} layers over 2 '
              f'stages, {PP_MICRO} microbatches of {PP_ROWS} x {PP_T}')
        inference, training = pipeline_on_card(port, workdir, paths, dev,
                                               card)
        found = torch.load(Path(workdir) / 'p31-rank0.pt', weights_only=True)
        launches = dict(found['cp_launches'])
        launches['attention'] += inference['attention']
        launches['ffn_residual_ln'] += inference['ffn_residual_ln']
        records = parallel_records(port, paths, launches, dev, gen, card)
    finally:
        (port.preprocess.w2v2fb.W2V2FB_CHECKPOINT,
         port.preprocess.bottleneck.BOTTLENECK_CHECKPOINT) = saved
    return records


# The widths slice: the PPG transformer at the (C, d_head) pairs of C =
# 256, 512 and 768 with d_head 128 or 256 that no registered config has
# (the mel model is (256, 128), the w2v2fb and w2v2fc heads (512, 256)),
# at full width and the mel model's depth (5 layers, F = 2048) with seeded
# weights: from_audio on WIDTH_BATCH x WIDTH_SECONDS, its first
# WIDTH_CPU_ROWS rows against device='cpu'; a whole-layer train step (256
# x 512) at each pair and a per-layer one (256 x 500) at C = 768, the
# width whose FFN kernels are new
WIDTH_PAIRS = ((256, 256), (512, 128), (768, 128), (768, 256))
WIDTH_NEW_C, WIDTH_F = 768, 2048
WIDTH_BATCH, WIDTH_SECONDS, WIDTH_CPU_ROWS = 64, 8, 4
WIDTH_STEP_REPS = 3
# A whole 5-layer step's gradients, the kernels against the plain path fed
# the same Philox masks, per tensor by relative L2: card_against_cpu's
# limit for the same comparison (bf16 products summed in other orders
# through 5 layers); the loss within 1e-2 of the plain path's
WIDTH_GRAD_REL = 5e-2
# The inference shape of the times: from_audio's 64 x 8 s is 128 windows
# of 500 frames
WIDTH_WINDOWS, WIDTH_T = 128, 500


def width_config(port, C, D):
    """The mel model at width C with heads of D (no registered config)."""
    return port.config.get('mel').replace(
        config=f'mel-c{C}-d{D}', hidden_channels=C, attention_heads=C // D,
        ffn_channels=WIDTH_F)


# The head-fold checks' windows: T about the 64-key tiles and 128-row
# blocks, and the per-layer and whole-layer train windows
FOLD_T = (1, 63, 65, 129, 500, 512)


@torch.no_grad()
def head_fold_checks(D, H, dev):
    """K2, attention_train_fwd, row_dot and attention_train_bwd with H
    heads of D against the same kernels with one head, on the heads folded
    into the batch (window b's head h as window b H + h), bit for bit: the
    dropout's Philox index of (window, head, row, key) is the same on both
    sides, so every output must be equal, the keep words and lse too. At
    ``FOLD_T``, 4 windows (ragged, holed, wholly masked, full), causal off
    and on, dropout off and 0.1. With H = 2, the head count phases 6 and 21
    hold against the plain versions, this ties the one-head kernels to
    them; with H = 1, 3, 4, 6 the new head counts to the one-head kernels:
    a grid, a stride or a Philox index that went wrong at a head count
    would differ."""
    from ppgs_tpu_torch.ops import dropout
    from ppgs_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 73)
    bf16, C = torch.bfloat16, H * D
    sl, sm = fa.LOG2E / math.sqrt(D), 1 / math.sqrt(D)

    def fold(t):
        """(B, T, H D) -> (B H, T, D), head h of window b at b H + h."""
        B, T = t.shape[:2]
        return t.reshape(B, T, H, D).transpose(1, 2).reshape(B * H, T, D)

    def folded_views(qkv):
        one = torch.cat([fold(qkv[..., i * C:(i + 1) * C]) for i in range(3)],
                        dim=-1).contiguous()
        return one[..., :D], one[..., D:2 * D], one[..., 2 * D:]

    def same(name, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f'{name}: the {H}-head call is not the '
                                 f'one-head call on its folded heads')

    cases = 0
    for T in FOLD_T:
        qkv = torch.randn(4, T, 3 * C, generator=gen, device=dev).to(bf16)
        do32 = torch.randn(4, T, C, generator=gen, device=dev)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        q1, k1, v1 = folded_views(qkv)
        do16 = do32.to(bf16)
        keys = torch.arange(T, device=dev)
        mask = torch.stack([keys < max(1, 2 * T // 3),
                            torch.rand(T, generator=gen, device=dev) < 0.6,
                            torch.zeros(T, dtype=torch.bool, device=dev),
                            torch.ones(T, dtype=torch.bool, device=dev)])
        mask[1, 64:128] = False
        mask1 = mask.repeat_interleave(H, dim=0)
        for causal, rate in itertools.product((False, True), (0.0, DROPOUT)):
            name = (f'd_head {D}, {H} heads, T={T} causal={causal} '
                    f'rate={rate}')
            drop = dropout.Drop(SEED + 19, dropout.site(1, 'probs'), rate)
            if not rate:
                same(f'K2 {name}', fold(fa.attention(q, k, v, mask, H, sl,
                                                     causal)),
                     fa.attention(q1, k1, v1, mask1, 1, sl, causal))
            o16, o32, lse, keep = fa.attention_train_fwd(
                q, k, v, mask, H, sl, causal, drop, want_f32=True)
            a16, a32, alse, akeep = fa.attention_train_fwd(
                q1, k1, v1, mask1, 1, sl, causal, drop, want_f32=True)
            same(f'attention_train_fwd o {name}', fold(o16), a16)
            same(f'attention_train_fwd o32 {name}', fold(o32), a32)
            same(f'attention_train_fwd lse {name}',
                 lse.reshape(4 * H, 1, T), alse)
            if rate:
                check_keep_words(name, keep, drop, mask, causal)
                same(f'attention_train_fwd keep words {name}',
                     keep.reshape(akeep.shape), akeep)
            d_row = fa.row_dot(do32, o32, H)
            a_row = fa.row_dot(fold(do32).contiguous(), a32, 1)
            same(f'row_dot {name}', d_row.reshape(4 * H, 1, T), a_row)
            d16, d32 = fa.attention_train_bwd(
                q, k, v, mask, lse, keep, do16, d_row, H, sl, sm, causal,
                drop, want32=True)
            b16, b32 = fa.attention_train_bwd(
                q1, k1, v1, mask1, alse, akeep, fold(do16).contiguous(),
                a_row, 1, sl, sm, causal, drop, want32=True)
            for i, part in enumerate(('dq', 'dk', 'dv')):
                cols, one = slice(i * C, (i + 1) * C), slice(i * D,
                                                             (i + 1) * D)
                same(f'attention_train_bwd {part} {name}',
                     fold(d32[..., cols]), b32[..., one])
                same(f'attention_train_bwd {part} (bf16) {name}',
                     fold(d16[..., cols]), b16[..., one])
            cases += 1
    print(f'd_head {D}, {H} heads: K2, attention_train_fwd (o, fp32 o, lse, '
          f'keep words), row_dot and attention_train_bwd (bf16 and fp32) '
          f'equal bit for bit to the one-head kernels on the folded heads in '
          f'{cases} cases (T = {FOLD_T}, 4 windows, causal off and on, '
          f'dropout off and {DROPOUT}; the keep words Philox\'s bits)',
          flush=True)


def widths_odd_shapes(dev):
    """Phase 33: the new kernel instances at C = 768 (K4 with ReLU in its
    inference form and its two train forms, ffn_train_bwd, ln_dropout_bwd)
    against their plain versions at odd shapes; K2 at the new pairs' head
    counts (1, 4, 6, 3) against its plain version at phase 3's odd shapes,
    and the attention kernels at those head counts and at 2 against the
    one-head kernels on the folded heads (``head_fold_checks``)."""
    C = WIDTH_NEW_C
    for form in ('ln', 'train_ln', 'y_out'):
        k4_odd_shape_checks(form, C, 'relu', WIDTH_F, dev)
    ffn_bwd_odd_shape_checks(dev, C)
    ln_dropout_bwd_odd_shape_checks(C, dev)
    for C, D in WIDTH_PAIRS:
        k2_odd_shape_checks(D, C // D, dev)
    for D, H in sorted({(D, 2) for _, D in WIDTH_PAIRS}
                       | {(D, C // D) for C, D in WIDTH_PAIRS}):
        head_fold_checks(D, H, dev)


class plain_train_path:
    """Within it, the train forward's three kernel chains (B4, B5, B6) are
    their plain versions, which draw the same Philox masks."""

    def __init__(self, port):
        tr = port.models.transformer
        self.slots = ((tr.elt, 'encoder_layer_train'),
                      (tr.fa, 'flash_attention_train'),
                      (tr.fused_ffn, 'ffn_train'))

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.slots]
        for m, n in self.slots:
            setattr(m, n, getattr(m, f'{n}_reference'))

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.slots, self.saved):
            setattr(m, n, fn)


def width_step(port, model, batch, seed):
    """One train step's loss and gradients (fp32, by parameter name)."""
    features, targets, lengths = batch
    model.zero_grad(set_to_none=True)
    loss = port.train.loss(model(features, lengths, train=True, seed=seed),
                           targets)
    loss.backward()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def width_train(port, config, params, dev, launches, card, split=None,
                timed=None):
    """Phase 34's steps at one pair (and phase 40's): a 256 x 512 step
    (B4) and with ``split`` a 256 x 500 one (B5 + B6), each with its exact
    launches and its loss and gradients against the plain path's with the
    same seed; with ``timed`` each step timed through make_train_step with
    its peak memory. Both default to C == 768, phase 34's new width."""
    C, H, L = (config.hidden_channels, config.attention_heads,
               config.num_hidden_layers)
    D = C // H
    split = C == WIDTH_NEW_C if split is None else split
    timed = C == WIDTH_NEW_C if timed is None else timed
    model = port.train.core.init_model(config, dev)
    model.load_state_dict(port.convert.params_from_jax(
        port.load.flatten_params(params)))
    counters = train_counters()
    Ts = (TRAIN_T, SPLIT_T) if split else (TRAIN_T,)
    for T in Ts:
        batch = train_batch(config, TRAIN_B, T, SEED + 5, dev)
        set_counts(counters)
        loss, grads = width_step(port, model, batch, 700 + T)
        got, _ = read_counts(counters)
        per_layer = B4_PER_LAYER if T == TRAIN_T else SPLIT_PER_LAYER
        want = {name: L * per_layer[name] for name in counters}
        print(f'(C, d_head) = ({C}, {D}), {H} heads: launches in one '
              f'{TRAIN_B} x {T} step: {got}', flush=True)
        if got != want:
            raise AssertionError(f'({C}, {D}) T={T}: launches {got}, not '
                                 f'{want}')
        form = 'b4' if T == TRAIN_T else 'split'
        launches[f'attention_train_fwd_d{D}_h{H}'] += got[
            'attention_train_fwd']
        launches[f'row_dot_d{D}_h{H}'] += got['row_dot']
        launches[f'attention_train_bwd_d{D}_h{H}'] += got[
            'attention_train_bwd']
        launches[f'out_proj_ln_train_c{C}'] += got['out_proj_ln_train']
        launches[f'ffn_train_fwd_{form}_c{C}'] += got['ffn_train_fwd']
        launches[f'ffn_train_bwd_c{C}'] += got['ffn_train_bwd']
        launches[f'ln_dropout_bwd_c{C}'] += got['ln_dropout_bwd']
        with plain_train_path(port):
            plain_loss, plain = width_step(port, model, batch, 700 + T)
        errors = {n: relative_l2(grads[n], plain[n]) for n in plain}
        worst = max(errors, key=errors.get)
        print(f'({C}, {D}) {TRAIN_B} x {T} step, kernels against the plain '
              f'path (the same Philox masks): loss {loss:.6f} vs '
              f'{plain_loss:.6f}, per-tensor relative gradient error median '
              f'{statistics.median(errors.values()):.3g}, worst '
              f'{errors[worst]:.3g} ({worst}; <= {WIDTH_GRAD_REL}) [{card}]',
              flush=True)
        if (abs(loss - plain_loss) > 1e-2 * abs(plain_loss)
                or errors[worst] > WIDTH_GRAD_REL):
            raise AssertionError(f'({C}, {D}) T={T}: the kernels\' step '
                                 f'disagrees with the plain path\'s')
        del grads, plain
    if not timed:
        return
    optimizer = port.train.make_optimizer(model.parameters(), config)
    step = port.train.make_train_step(model, config, optimizer)
    frame_s = config.hopsize / config.sample_rate
    for T in Ts:
        batch = train_batch(config, TRAIN_B, T, SEED + 5, dev)
        step(*batch, seed=100)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seconds = median_seconds(lambda: step(*batch, seed=200),
                                 WIDTH_STEP_REPS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f'({C}, {D}) train step {TRAIN_B} x {T} '
              f'({"B4" if T == TRAIN_T else "B5 + B6"}): {seconds * 1e3:.3f} '
              f'ms (median of {WIDTH_STEP_REPS}), '
              f'{TRAIN_B * T * frame_s / seconds:.1f} audio-s/s, peak device '
              f'memory {peak:.3f} GiB [{card}]', flush=True)


def widths_main_paths(port, workdir, dev, gen, card):
    """Phase 34: each new pair's from_audio on 64 x 8 s (K1-K4 5 times a
    call at its widths, the first rows against device='cpu' at the bf16
    gates), at C = 768 a legacy_mode call on 12 s (the per-layer path: K2
    and K4 5 times), and its train steps (``width_train``); returns the
    launches of the slice's kernel records in these runs."""
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    counters = {'qkv_proj': elk.qkv_proj, 'attention': fa.attention,
                'out_proj_residual_ln': elk.out_proj_residual_ln,
                'ffn_residual_ln': fused_ffn.ffn_residual_ln}
    launches = collections.Counter()
    for C, D in WIDTH_PAIRS:
        config = width_config(port, C, D)
        H, L = C // D, config.num_hidden_layers
        samples = WIDTH_SECONDS * config.sample_rate
        audio = 0.1 * torch.randn(WIDTH_BATCH, 1, samples, generator=gen,
                                  device=dev)
        params = random_params(port, config, SEED + C + D)
        path = Path(workdir) / f'{config.config}.npz'
        port.load.save_params(path, params)
        set_counts(counters)
        ppg = port.from_audio(audio, config=config, checkpoint=path)
        got, widths = read_counts(counters)
        print(f'(C, d_head) = ({C}, {D}), {H} heads: launches in one '
              f'from_audio call on {WIDTH_BATCH} x {WIDTH_SECONDS} s: {got}, '
              f'by width: {widths}', flush=True)
        want_widths = {'qkv_proj': {C: L}, 'attention': {D: L},
                       'out_proj_residual_ln': {C: L},
                       'ffn_residual_ln': {C: L}}
        if got != {name: L for name in counters} or widths != want_widths:
            raise AssertionError(f'({C}, {D}): launches {got} {widths}, not '
                                 f'{L} of each at {want_widths}')
        launches[f'attention_d{D}_h{H}'] += got['attention']
        if C == WIDTH_NEW_C:
            launches[f'ffn_residual_ln_c{C}_relu'] += got['ffn_residual_ln']
        check_ppg(f'({C}, {D}) from_audio', ppg, audio,
                  (WIDTH_BATCH, config.output_channels,
                   samples // config.hopsize))
        rows = audio[:WIDTH_CPU_ROWS].cpu()
        agree_decided(
            f'({C}, {D}) from_audio, the first {WIDTH_CPU_ROWS} rows, against '
            f'device=cpu', ppg[:WIDTH_CPU_ROWS],
            port.from_audio(rows, config=config, checkpoint=path,
                            device='cpu'),
            port.from_audio(rows, config=config.replace(
                compute_dtype='float32'), checkpoint=path, device='cpu'),
            card)
        del ppg, audio
        if C == WIDTH_NEW_C:
            # legacy_mode past 1024 frames: the per-layer path, K2 and K4's
            # per-layer form (round_input 1) a layer
            legacy = 0.1 * torch.randn(1, 1, LEGACY_SECONDS
                                       * config.sample_rate, generator=gen,
                                       device=dev)
            set_counts(counters)
            ppg = port.from_audio(legacy, config=config, checkpoint=path,
                                  legacy_mode=True)
            got, widths = read_counts(counters)
            print(f'({C}, {D}) launches in one legacy_mode call on 1 x '
                  f'{LEGACY_SECONDS} s: {got}, by width: {widths}', flush=True)
            if got != {'qkv_proj': 0, 'attention': L,
                       'out_proj_residual_ln': 0, 'ffn_residual_ln': L}:
                raise AssertionError(f'({C}, {D}) legacy_mode launches {got}')
            launches[f'attention_d{D}_h{H}'] += got['attention']
            launches[f'ffn_residual_layernorm_c{C}'] += got['ffn_residual_ln']
            agree_decided(
                f'({C}, {D}) from_audio legacy_mode, 1 x {LEGACY_SECONDS} s, '
                f'against device=cpu', ppg,
                port.from_audio(legacy.cpu(), config=config, checkpoint=path,
                                legacy_mode=True, device='cpu'),
                port.from_audio(legacy.cpu(), config=config.replace(
                    compute_dtype='float32'), checkpoint=path,
                    legacy_mode=True, device='cpu'),
                card)
            del ppg, legacy
        width_train(port, config, params, dev, launches, card)
        torch.cuda.empty_cache()
    print(f'the slice\'s launches by record: {dict(launches)}', flush=True)
    return launches


def width_record(name, src, replaces, fns, verify, work, launches, card,
                 library_label, plain_reps=TRAIN_REPS, slice_name='widths'):
    """One record of the slice: the kernel held against its plain version
    on the same inputs by ``verify(got, want)``, which raises beyond its
    limits and returns the max |kernel - plain|; both timed by CUDA events
    with the library call, the bound from ``work``, and the kernel's
    device time per call (``device_times``)."""
    kernel_fn, plain_fn, library_fn = fns
    err = verify(kernel_fn(), plain_fn())
    ms = time_ms(kernel_fn, TRAIN_REPS, 2)
    plain_ms = time_ms(plain_fn, plain_reps, 1)
    library_ms = time_ms(library_fn, TRAIN_REPS, 2)
    bound_ms, bound_by = bound(*work)
    record = {'name': f'{slice_name}/{name}', 'route': 'cuda',
              'source': f'ppgs_tpu_torch/kernels/csrc/{src}',
              'replaces': replaces, 'launches': launches[name],
              'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
              'bound_ms': bound_ms, 'bound_by': bound_by,
              'library_ms': library_ms}
    print(f'{name}: max |kernel - plain| {err:.3g}, plain {plain_ms:.4f} '
          f'ms', flush=True)
    device_times(name, record, kernel_fn, library_label, card)
    if not launches[name]:
        raise AssertionError(f'{name} was not launched on the main path')
    return record


@torch.no_grad()
def widths_ffn_times(port, launches, dev, card):
    """Phase 35's records of the C = 768 FFN kernels: K4 with ReLU (the
    inference LayerNorm forms, the stack's and the per-layer path's, at the
    main path's 128 x 500 rows) and, at the
    training shape (256 x 512 rows, dropout 0.1), K4's two train forms,
    ffn_train_bwd (fp32 x with the residual) and ln_dropout_bwd (LN2 with
    keep_y). The weights are layer 0's of phase 34's (768, 128) model (the
    init's scale, as phase 22 takes its layer's); the activations N(0, 1),
    the LayerNorm'd rows' scale."""
    from ppgs_tpu_torch.ops import fused_ffn

    bf16 = torch.bfloat16
    C, Fh = WIDTH_NEW_C, WIDTH_F
    gen = torch.Generator(device=dev).manual_seed(SEED + 67)

    def rnd(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen, device=dev)

    D = WIDTH_PAIRS[2][1]
    layer = random_params(port, width_config(port, C, D),
                          SEED + C + D)['layers'][0]
    w1, b1, w2, b2 = (torch.from_numpy(layer['ffn'][n]).to(dev)
                      for n in ('w1', 'b1', 'w2', 'b2'))
    w1, w2 = w1.to(bf16), w2.to(bf16)
    g2, be2 = (torch.from_numpy(layer['norm2'][n]).to(dev)
               for n in ('scale', 'bias'))
    w1t, w2t, b1c, b2c = w1.T, w2.T, b1.to(bf16), b2.to(bf16)
    records = []

    M = WIDTH_WINDOWS * WIDTH_T
    x = rnd(M, C)
    ln = (x, w1, b1, w2, b2, g2, be2)
    records.append(width_record(
        f'ffn_residual_ln_c{C}_relu', 'ffn_ln.cu',
        'ppgs_tpu/ops/encoder_layer_kernel.py:330',
        (lambda: fused_ffn.ffn_residual_ln(*ln),
         lambda: fused_ffn.ffn_residual_ln_reference(*ln),
         lambda: F.layer_norm(x + F.linear(F.relu(F.linear(
             x.to(bf16), w1t, b1c)), w2t, b2c).float(), (C,), g2, be2)),
        lambda got, want: check(f'K4 C={C} relu M={M}', got, want, 1e-2),
        (4 * M * C * Fh, 2 * M * C * 4 + 2 * C * Fh * 2 + (Fh + 3 * C) * 4),
        launches, card, 'addmm + ReLU + addmm + layer_norm', REPS))
    # the per-layer path's form (round_input 1: x rounded to bf16 first)
    records.append(width_record(
        f'ffn_residual_layernorm_c{C}', 'ffn_ln.cu',
        'ppgs_tpu/ops/fused_ffn.py:70',
        (lambda: fused_ffn.ffn_residual_layernorm(*ln),
         lambda: fused_ffn.ffn_residual_layernorm_reference(*ln),
         lambda: F.layer_norm(x.to(bf16).float() + F.linear(F.relu(F.linear(
             x.to(bf16), w1t, b1c)), w2t, b2c).float(), (C,), g2, be2)),
        lambda got, want: check(f'K4 C={C} relu round_input 1 M={M}', got,
                                want, 1e-2),
        (4 * M * C * Fh, 2 * M * C * 4 + 2 * C * Fh * 2 + (Fh + 3 * C) * 4),
        launches, card, 'addmm + ReLU + addmm + layer_norm', REPS))
    del x, ln
    return records + train_ffn_records(layer, C, gen, launches, dev, card)


@torch.no_grad()
def train_ffn_records(layer, C, gen, launches, dev, card, slice_name='widths',
                      scaled=False):
    """The records of the FFN's train kernels at width C, on ``layer``'s
    weights (the JAX layout) at the training shape (256 x 512 rows,
    dropout 0.1): K4's two train forms, ffn_train_bwd (fp32 x with the
    residual) and ln_dropout_bwd (LN2 with keep_y), the activations N(0,
    1) from ``gen``. ``scaled``: the relative L2 limits of K4's forms and
    ffn_train_bwd's outlier bounds by ``flip_rel`` at C (phase 41's; phase
    35 holds C = 768 to them as they were read)."""
    from ppgs_tpu_torch.ops import backward, dropout, fused_ffn

    bf16 = torch.bfloat16
    Fh = layer['ffn']['w1'].shape[1]

    def rnd(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen, device=dev)

    w1, b1, w2, b2 = (torch.from_numpy(layer['ffn'][n]).to(dev)
                      for n in ('w1', 'b1', 'w2', 'b2'))
    w1, w2 = w1.to(bf16), w2.to(bf16)
    g2, be2 = (torch.from_numpy(layer['norm2'][n]).to(dev)
               for n in ('scale', 'bias'))
    w1t, w2t, b1c, b2c = w1.T, w2.T, b1.to(bf16), b2.to(bf16)
    records = []

    def record(*args, **kwargs):
        records.append(width_record(*args, **kwargs, slice_name=slice_name))

    def rel_limit(value):
        return flip_rel(value, C) if scaled else value

    M = TRAIN_B * TRAIN_T
    drop_h = dropout.Drop(SEED + 37, dropout.site(0, 'hidden'), DROPOUT)
    drop_y = drop_h.at(drop_h.site + 1)
    r = rnd(M, C)
    r16 = r.to(bf16)
    b4 = (r, w1, b1, w2, b2, drop_h, drop_y, (g2, be2))
    y_out = (r16, w1, b1, w2, b2, drop_h, drop_y)

    def b4_chain(xs):
        h = F.dropout(F.relu(F.linear(xs, w1t, b1c)), DROPOUT)
        y = F.dropout(F.linear(h, w2t, b2c), DROPOUT)
        return F.layer_norm(xs.float() + y.float(), (C,), g2, be2)

    def y_chain():
        h = F.dropout(F.relu(F.linear(r16, w1t, b1c)), DROPOUT)
        return F.dropout(F.linear(h, w2t, b2c), DROPOUT)

    def train_fwd_verify(form, limit):
        """K4's train form as phase 33 holds it: relative L2 of the outputs
        within ``limit``, the hidden's keep words Philox's bits."""
        def verify(got, want):
            check_hidden_words(form, got[3], drop_h)
            pairs = [(a, b) for a, b in zip(got[:3], want[:3])
                     if b is not None]
            rels = [relative_l2(a, b) for a, b in pairs]
            print(f'{form} M={M}: relative L2 errors {rels} (<= {limit}); '
                  f'the keep words Philox\'s bits', flush=True)
            if max(rels) > limit:
                raise AssertionError(f'{form}: relative L2 {rels} > {limit}')
            return max((a.float() - b.float()).abs().max().item()
                       for a, b in pairs)
        return verify

    # x, the weights and biases in; out, the normalised rows, 1/std and the
    # hidden's keep words out
    record(
        f'ffn_train_fwd_b4_c{C}', 'ffn_ln.cu',
        'ppgs_tpu/ops/encoder_layer_train.py:471',
        (lambda: fused_ffn.ffn_train_fwd(*b4),
         lambda: fused_ffn.ffn_train_fwd_reference(*b4),
         lambda: b4_chain(r16)),
        train_fwd_verify(f'ffn_train_fwd B4 C={C}', rel_limit(1e-3)),
        (4 * M * C * Fh, M * C * 4 + 2 * C * Fh * 2 + (Fh + 3 * C) * 4
         + 2 * M * C * 4 + M * 4 + M * Fh // 8),
        launches, card, 'its library route')
    record(
        f'ffn_train_fwd_split_c{C}', 'ffn_ln.cu',
        'ppgs_tpu/ops/fused_ffn.py:256',
        (lambda: fused_ffn.ffn_train_fwd(*y_out),
         lambda: fused_ffn.ffn_train_fwd_reference(*y_out), y_chain),
        train_fwd_verify(f'ffn_train_fwd B6 C={C}', rel_limit(1e-2)),
        (4 * M * C * Fh, 2 * M * C * 2 + 2 * C * Fh * 2 + (Fh + C) * 4
         + M * Fh // 8),
        launches, card, 'its library route')
    _, _, _, keep = fused_ffn.ffn_train_fwd(*b4)
    dy, residual = rnd(M, C).to(bf16), rnd(M, C)
    bwd = (r, dy, w1, b1, w2, drop_h, keep, residual)
    leaf = r16.detach().requires_grad_()
    with torch.enable_grad():
        chain_out = b4_chain(leaf)
    chain_cot = torch.randn_like(chain_out)

    def outlier_bound(bound_on):
        """A flip's outlier bound at C: ``scaled``, by ``flip_rel``. A
        flip moves an element by a few ulps of its value, and at the init's
        scale x W1's spread grows with C (its weights' std is sqrt(2 / (C +
        F)), so about sqrt(2 C / (C + F)): 0.47 at C = 256, 0.82 at 1024),
        and the ulps of its tail with it: an H100 read an hd flip of
        0.0469 at C = 1024 (1.5 ulps of a value in [4, 8)) against
        C = 256's bound of 0.032."""
        if not scaled or 'outlier' not in bound_on:
            return bound_on
        return dict(bound_on, outlier=flip_rel(bound_on['outlier'], C))

    def bwd_verify(got, want):
        """FFN_BWD_LIMITS at C, the relu' flips carried over."""
        want = with_relu_flips(want, got, w1)
        return max(
            check(f'ffn_train_bwd C={C} M={M} {name}', a, b, atol, rtol,
                  share=flip_share(share, C), **outlier_bound(bound_on))
            for name, a, b in zip(('dx (fp32 + residual)', 'hd', 'dh',
                                   'db1 partial sums'), got, want)
            for atol, rtol, share, bound_on in [FFN_BWD_LIMITS[name]])
    # x, dy, the residual, the weights, b1 and the keep words in; dx, hd,
    # dh and the db1 partial rows out
    record(
        f'ffn_train_bwd_c{C}', 'ffn_train.cu', 'ppgs_tpu/ops/fused_ffn.py:294',
        (lambda: fused_ffn.ffn_train_bwd(*bwd),
         lambda: fused_ffn.ffn_train_bwd_reference(*bwd),
         lambda: torch.autograd.grad(chain_out, leaf, chain_cot,
                                     retain_graph=True)),
        bwd_verify,
        (6 * M * C * Fh, M * C * 4 + M * C * 2 + M * C * 4 + 2 * C * Fh * 2
         + Fh * 4 + M * Fh // 8 + M * C * 4 + 2 * M * Fh * 2
         + -(-M // 64) * Fh * 4),
        launches, card, 'its library route')
    del bwd, keep, chain_out, leaf, b4, y_out

    g = rnd(M, C)
    n = rnd(M, C)
    rstd = torch.rand(M, generator=gen, device=dev) + 0.5
    ln_args = (g, n, rstd, g2, drop_y, bf16)
    zero_mean = torch.zeros(M, 1, device=dev)

    def ln_verify(got, want):
        """Phase 33's limits; the dropped elements 0."""
        name = f'ln_dropout_bwd C={C} M={M}'
        if got[1][~drop_y.keep((M, C), dev)].any():
            raise AssertionError(f'{name}: a dropped element is not 0')
        return max(check(f'{name} dz', got[0], want[0], 1e-5, 1e-5),
                   check(f'{name} partial sums', got[2], want[2], 1e-3,
                         1e-4),
                   check(f'{name} masked (bf16)', got[1], want[1], 1e-5,
                         1e-2, share=1e-6, outlier=3.2e-2))
    record(
        f'ln_dropout_bwd_c{C}', 'layer_train.cu',
        'ppgs_tpu/ops/encoder_layer_train.py:531',
        (lambda: backward.ln_dropout_bwd(*ln_args),
         lambda: backward.ln_dropout_bwd_reference(*ln_args),
         lambda: torch.ops.aten.native_layer_norm_backward(
             g, n / rstd[:, None], [C], zero_mean, rstd[:, None], g2, be2,
             [True, True, True])),
        ln_verify,
        (8 * M * C, 3 * M * C * 4 + M * 4 + C * 4 + M * C * 2
         + (M // 64) * 3 * C * 4),
        launches, card, 'native_layer_norm_backward')
    return records


def sdpa_backend(q, k, v, **kw):
    """The backend that ``scaled_dot_product_attention(q, k, v, **kw)``
    runs (PyTorch's own choice, which its backward follows): flash,
    memory-efficient, cuDNN or math."""
    from torch.nn.attention import SDPBackend

    choice = SDPBackend(torch._fused_sdp_choice(q, k, v, **kw))
    return {SDPBackend.FLASH_ATTENTION: 'flash',
            SDPBackend.EFFICIENT_ATTENTION: 'memory-efficient',
            SDPBackend.CUDNN_ATTENTION: 'cuDNN'}.get(choice, 'math')


@torch.no_grad()
def widths_attention_times(launches, dev, card, pairs=WIDTH_PAIRS,
                           slice_name='widths', wide=False):
    """Phase 35's records of the attention kernels at the new head counts
    (and phase 44's at ``pairs``): K2 at the main path's 128 windows of
    500 frames, and attention_train_fwd and attention_train_bwd at the
    training shape (256 x 512, ragged windows, one wholly masked, dropout
    0.1); SDPA beside each, its backend named. ``wide``: phase 44's form,
    row_dot (on the forward's fp32 o) recorded too, and phase 42's limits
    at the wide head widths: the train kernels' flip shares by
    ``flip_share`` at C, their bounds ``wide_flips``' at d_head, the
    backward's fp32 output pooled too."""
    from ppgs_tpu_torch.ops import dropout
    from ppgs_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    records = []
    for C, D in pairs:
        H = C // D
        sl, sm = fa.LOG2E / math.sqrt(D), 1 / math.sqrt(D)
        share = flip_share(1e-6, C) if wide else 1e-6
        bound16, bound32 = wide_flips(D) if wide else (8e-3, 8e-3)

        def heads(t, B, T):
            return t.reshape(B, T, H, D).transpose(1, 2)

        B, T = WIDTH_WINDOWS, WIDTH_T
        qkv = torch.randn(B, T, 3 * C, generator=gen, device=dev).to(bf16)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        mask = torch.ones(B, T, dtype=torch.bool, device=dev)
        att = (q, k, v, mask, H, sl)
        sdpa_qkv = tuple(heads(t, B, T) for t in (q, k, v))
        records.append(width_record(
            f'attention_d{D}_h{H}', 'attention.cu',
            'ppgs_tpu/ops/flash_attention.py:192',
            (lambda: fa.attention(*att), lambda: fa.attention_reference(*att),
             lambda: F.scaled_dot_product_attention(*sdpa_qkv)),
            lambda got, want: check(f'K2 d_head {D} ({H} heads) {B} x {T}',
                                    got, want, 5e-3, 2 ** -7),
            (4 * B * H * T * T * D, 4 * B * T * C * 2 + B * T),
            launches, card, f'SDPA ({sdpa_backend(*sdpa_qkv)})', REPS,
            slice_name=slice_name))
        del qkv, q, k, v, att

        B, T = TRAIN_B, TRAIN_T
        lengths = T - torch.randint(0, T // 2, (B,), generator=gen,
                                    device=dev)
        lengths[0], lengths[-1] = T, 0
        mask = torch.arange(T, device=dev)[None] < lengths[:, None]
        pairs = H * T * lengths.double().sum().item()
        M = B * T
        qkv = torch.randn(B, T, 3 * C, generator=gen, device=dev).to(bf16)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        do = torch.randn(B, T, C, generator=gen, device=dev).to(bf16)
        drop = dropout.Drop(SEED + 19, dropout.site(0, 'probs'), DROPOUT)
        att = (q, k, v, mask, H, sl, False, drop)
        sdpa_mask = mask[:, None, None, :]
        sdpa_qkv = tuple(heads(t, B, T) for t in (q, k, v))
        sdpa_kw = dict(attn_mask=sdpa_mask, dropout_p=DROPOUT)
        records.append(width_record(
            f'attention_train_fwd_d{D}_h{H}', 'attention_train.cu',
            'ppgs_tpu/ops/flash_attention.py:576',
            (lambda: fa.attention_train_fwd(*att, want_f32=True),
             lambda: fa.attention_train_fwd_reference(*att, want_f32=True),
             lambda: F.scaled_dot_product_attention(*sdpa_qkv, **sdpa_kw)),
            lambda got, want: max(
                check(f'attention_train_fwd d_head {D} ({H} heads) o',
                      got[0], want[0], 1e-3, 1e-2, share=share,
                      outlier=bound16),
                check(f'attention_train_fwd d_head {D} o32', got[1], want[1],
                      2e-3, 1e-2, share=share, outlier=bound32),
                check(f'attention_train_fwd d_head {D} lse', got[2], want[2],
                      1e-4)),
            (4 * pairs * D, 3 * M * C * 2 + M + M * C * 6 + M * H * 4
             + 4 * math.prod(fa.keep_words_shape(B, H, T))),
            launches, card,
            f'SDPA with dropout ({sdpa_backend(*sdpa_qkv, **sdpa_kw)})',
            slice_name=slice_name))
        _, o32, lse, keep = fa.attention_train_fwd(*att, want_f32=True)
        do32 = do.float()
        if wide:
            records.append(width_record(
                f'row_dot_d{D}_h{H}', 'attention_train.cu',
                'ppgs_tpu/ops/flash_attention.py:625',
                (lambda: fa.row_dot(do32, o32, H),
                 lambda: fa.row_dot_reference(do32, o32, H),
                 lambda: torch.linalg.vecdot(do32.view(B, T, H, D),
                                             o32.view(B, T, H, D))),
                lambda got, want: check(f'row_dot d_head {D} ({H} heads)',
                                        got, want, 1e-3, 1e-4),
                (2 * M * C, 2 * M * C * 4 + M * H * 4), launches, card,
                'vecdot', slice_name=slice_name))
        d_row = fa.row_dot(do32, o32, H)
        bwd = (q, k, v, mask, lse, keep, do, d_row, H, sl, sm, False, drop)
        qs, ks, vs = (heads(t, B, T).detach().requires_grad_()
                      for t in (q, k, v))
        with torch.enable_grad():
            sdpa_out = F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=sdpa_mask, dropout_p=DROPOUT)
            backend = sdpa_backend(qs, ks, vs, **sdpa_kw)
        records.append(width_record(
            f'attention_train_bwd_d{D}_h{H}', 'attention_train_bwd.cu',
            'ppgs_tpu/ops/flash_attention.py:625',
            (lambda: fa.attention_train_bwd(*bwd, want32=True),
             lambda: fa.attention_train_bwd_reference(*bwd, want32=True),
             lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs),
                                         heads(do, B, T),
                                         retain_graph=True)),
            lambda got, want: max(
                check(f'attention_train_bwd d_head {D} ({H} heads) fp32',
                      got[1], want[1], 2e-3, 1e-2,
                      **(dict(share=share, outlier=bound32) if wide
                         else {})),
                check(f'attention_train_bwd d_head {D} bf16', got[0],
                      want[0], 1e-3, 1e-2, share=share, outlier=bound16)),
            (10 * pairs * D, 4 * M * C * 2 + 2 * M * H * 4 + M
             + M * 3 * C * 6),
            launches, card, f'SDPA backward ({backend})',
            slice_name=slice_name))
        del qkv, q, k, v, do, do32, att, bwd, sdpa_out, o32, lse, keep
        torch.cuda.empty_cache()
    return records


def widths_phases(port, workdir, dev, gen, card):
    """Phases 33-35: the transformer at the new (C, d_head) pairs; returns
    the slice's JSON records."""
    phase(f'33 the new kernel instances (C = {WIDTH_NEW_C}: K4 with ReLU, '
          f'its train forms, ffn_train_bwd, ln_dropout_bwd) against their '
          f'plain versions at odd shapes, and the attention kernels at '
          f'{len(WIDTH_PAIRS)} new head counts')
    widths_odd_shapes(dev)
    phase(f'34 from_audio ({WIDTH_BATCH} x {WIDTH_SECONDS} s) and train steps '
          f'({TRAIN_B} x {TRAIN_T}, and {TRAIN_B} x {SPLIT_T} at C = '
          f'{WIDTH_NEW_C}) at (C, d_head) = {WIDTH_PAIRS} (main path)')
    launches = widths_main_paths(port, workdir, dev, gen, card)
    phase(f'35 the new instances\' times on {card} (CUDA events, device time, '
          f'plain, library, bound)')
    records = widths_ffn_times(port, launches, dev, card)
    records += widths_attention_times(launches, dev, card)
    return records


# The any_width slice: K1, K3 and K4 at widths of their inference rule (C %
# 128 == 0 up to 2048) that no registered config has. Odd shapes at
# ANY_C first (K1 also at 1408, its Stream form's first width), then two
# main paths: wav2vec2-large's trunk (facebook/wav2vec2-large: hidden
# 1024, 24 layers, 16 heads of 64, intermediate 4096; base's feature
# encoder) on 64 x 8 s of audio (T = 400), and the PPG transformer at
# mel's shape (5 layers, F = 2048) at ANY_PAIRS through from_audio on 64 x
# 8 s, timed, and at ANY_CHECKED checked, not timed; legacy_mode on 12 s at
# C = 1024
ANY_C = (128, 384, 640, 1024, 1280, 2048)
ANY_K1_C = ANY_C + (1408,)
ANY_PAIRS = ((384, 128), (1024, 128), (1024, 256))
ANY_CHECKED = ((128, 128),)
ANY_LEGACY = (1024, 128)
ANY_CPU_ROWS = 2
# K2's new head counts: the large trunk's 16 heads of 64, and the pairs'
ANY_HEADS = ((64, 16), (128, 1), (128, 3), (128, 8), (256, 4))
LARGE_TRUNK = dict(hidden_size=1024, num_layers=24, num_heads=16,
                   intermediate_size=4096)
# The 24-layer stack against its plain version, relative L2: the base
# trunk's limit (phase 9: 1e-2 at C = 768, 12 layers) scaled by the width
# (a branch of N(0, 0.02) weights grows with C beside the residual, and
# its bf16 roundings with it) and by the square root of the depth
LARGE_REL = round(1e-2 * (1024 / 768) * math.sqrt(24 / 12), 4)
# K1's share of rounding flips at the main shapes, phase 6's at C = 256
# (flip_share scales it by C / 256): an H100 read one flip in 1.97e8
# outputs at (1024, 128), 128 x 500, where the limit had no share
K1_FLIP_SHARE = 2e-8


@torch.no_grad()
def any_width_odd_shapes(dev):
    """Phase 36: K1 at ``ANY_K1_C``, K3 at ``ANY_C`` and K4 at ``ANY_C``
    (ReLU and GELU, round_input 0 and 1, F = 128, 384 and 4 C) against
    their plain versions at odd rows (1 ... 1000), and K2 at the new head
    counts (``ANY_HEADS``) at phase 3's odd shapes."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    for C in ANY_K1_C:
        wqkv = (C ** -0.5 * torch.randn(C, 3 * C, generator=gen, device=dev)
                ).to(torch.bfloat16)
        bqkv = 0.1 * torch.randn(3 * C, generator=gen, device=dev)
        k1_odd_shape_checks(f'C = {C}', wqkv, bqkv, dev)
    k3_odd_shape_checks(ANY_C, 0, dev)
    for C in ANY_C:
        for act in ('relu', 'gelu'):
            k4_odd_shape_checks('ln', C, act, 4 * C, dev)
    for D, H in ANY_HEADS:
        k2_odd_shape_checks(D, H, dev)


def large_trunk(port, workdir, dev):
    """wav2vec2-large's trunk with seeded weights (``random_w2v2_params``
    at its shapes, through a temporary npz), prepared on the card in bf16."""
    import dataclasses

    wcfg = dataclasses.replace(port.models.w2v2.BASE, **LARGE_TRUNK,
                               compute_dtype='bfloat16')
    path = Path(workdir) / 'wav2vec2-large.npz'
    port.load.save_params(path, random_w2v2_params(port, SEED + 101, wcfg))
    trunk = port.load.prepared_model(port.preprocess.w2v2fb._build, path,
                                     dev, wcfg)
    path.unlink()
    return trunk


def layer_counters():
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import flash_attention as fa
    from ppgs_tpu_torch.ops import fused_ffn

    return {'qkv_proj': elk.qkv_proj, 'attention': fa.attention,
            'out_proj_residual_ln': elk.out_proj_residual_ln,
            'ffn_residual_ln': fused_ffn.ffn_residual_ln}


@torch.no_grad()
def large_trunk_path(port, trunk, dev, gen, launches, card):
    """Phase 37's trunk: ``models.w2v2.forward`` on 64 x 8 s of padded
    audio (T = 400) with its exact launches (24 of each of K1-K4 at C =
    1024 and d_head 64), then the 24-layer stack against its plain version
    on the same seeded (64, 400, 1024) input, the last window wholly
    masked (``LARGE_REL``), and K1-K4 of its first layer against theirs;
    returns (the max errors, the inputs for phase 38)."""
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk

    wcfg = trunk.config
    C, H, L = wcfg.hidden_size, wcfg.num_heads, wcfg.num_layers
    S = W2V2_SECONDS * 16_000 + 2 * port.preprocess.w2v2fb.PAD
    T = int(port.models.w2v2.feat_extract_output_lengths(S, wcfg))
    audio = 0.1 * torch.randn(W2V2_BATCH, S, generator=gen, device=dev)
    counters = layer_counters()
    set_counts(counters)
    hidden = port.models.w2v2.forward(trunk, audio)
    got, widths = read_counts(counters)
    print(f'wav2vec2-large trunk ({L} layers, C = {C}, {H} heads): launches '
          f'in one models.w2v2.forward call on {W2V2_BATCH} x '
          f'{W2V2_SECONDS} s: {got}, by width: {widths}', flush=True)
    want_widths = {'qkv_proj': {C: L}, 'attention': {C // H: L},
                   'out_proj_residual_ln': {C: L}, 'ffn_residual_ln': {C: L}}
    if got != {name: L for name in counters} or widths != want_widths:
        raise AssertionError(f'the large trunk: launches {got} {widths}, not '
                             f'{L} of each at {want_widths}')
    for name in ('qkv_proj', 'out_proj_residual_ln'):
        launches[f'large/{name}_c{C}'] += L
    launches[f'large/ffn_residual_ln_c{C}_gelu'] += L
    launches[f'large/attention_d{C // H}_h{H}'] += L
    if (tuple(hidden.shape) != (W2V2_BATCH, T, C)
            or not torch.isfinite(hidden).all()):
        raise AssertionError(f'the large trunk\'s output: shape '
                             f'{tuple(hidden.shape)}, or not finite')
    seconds = W2V2_BATCH * W2V2_SECONDS
    wall = median_seconds(lambda: port.models.w2v2.forward(trunk, audio))
    print(f'wav2vec2-large trunk forward, {W2V2_BATCH} x {W2V2_SECONDS} s: '
          f'{wall * 1e3:.3f} ms (median of 5), {seconds / wall:.1f} '
          f'audio-s/s [{card}]', flush=True)
    report_groups('wav2vec2-large trunk forward', profile_call(
        'wav2vec2-large trunk forward',
        lambda: port.models.w2v2.forward(trunk, audio), card), card)
    del hidden, audio

    x = torch.randn(W2V2_BATCH, T, C, generator=gen, device=dev)
    mask = torch.ones(W2V2_BATCH, T, dtype=torch.bool, device=dev)
    mask[-1] = False
    x16 = x.to(torch.bfloat16)
    layers = trunk.encoder.layers
    got = elk.encoder_stack(x16, mask, layers, H, activation='gelu')
    want = elk.encoder_stack_reference(x16, mask, layers, H,
                                       activation='gelu')
    err = {'stack': check_rel(
        f'B7 the {L}-layer GELU stack at wav2vec2-large\'s widths (valid '
        f'rows)', got[mask], want[mask], LARGE_REL)}
    del got, want
    inputs = {'stack': dict(x16=x16, mask=mask)}
    layer_kernel_checks('large', x, mask, layer_weights(layers[0]), H,
                        'gelu', err, inputs, flip_share(K1_FLIP_SHARE, C))
    return err, inputs


def any_width_ppg_paths(port, workdir, dev, gen, launches, card,
                        checked=ANY_CHECKED, timed=ANY_PAIRS,
                        legacy_pair=ANY_LEGACY, cpu_rows=ANY_CPU_ROWS):
    """Phase 37's PPG transformer (and phase 43's): at each pair of
    ``checked`` and ``timed``, mel's shape at that width with seeded
    weights: ``from_audio`` on 64 x 8 s (K1-K4 5 times each at the pair's
    widths, the first ``cpu_rows`` rows against device='cpu' at the bf16
    gates, ``agree_decided``), timed end to end at ``timed``; at
    ``legacy_pair`` ``legacy_mode`` on 12 s (K2 and K4's round_input 1 form
    5 times each) against the CPU."""
    counters = layer_counters()
    for C, D in checked + timed:
        config = width_config(port, C, D)
        H, L = C // D, config.num_hidden_layers
        samples = WIDTH_SECONDS * config.sample_rate
        audio = 0.1 * torch.randn(WIDTH_BATCH, 1, samples, generator=gen,
                                  device=dev)
        path = Path(workdir) / f'{config.config}.npz'
        port.load.save_params(path, random_params(port, config,
                                                  SEED + C + D))
        set_counts(counters)
        ppg = port.from_audio(audio, config=config, checkpoint=path)
        got, widths = read_counts(counters)
        print(f'(C, d_head) = ({C}, {D}), {H} heads: launches in one '
              f'from_audio call on {WIDTH_BATCH} x {WIDTH_SECONDS} s: {got}, '
              f'by width: {widths}', flush=True)
        want_widths = {'qkv_proj': {C: L}, 'attention': {D: L},
                       'out_proj_residual_ln': {C: L},
                       'ffn_residual_ln': {C: L}}
        if got != {name: L for name in counters} or widths != want_widths:
            raise AssertionError(f'({C}, {D}): launches {got} {widths}, not '
                                 f'{L} of each at {want_widths}')
        for name in ('qkv_proj', 'out_proj_residual_ln'):
            launches[f'{name}_c{C}'] += L
        launches[f'ffn_residual_ln_c{C}_relu'] += L
        launches[f'attention_d{D}_h{H}'] += L
        check_ppg(f'({C}, {D}) from_audio', ppg, audio,
                  (WIDTH_BATCH, config.output_channels,
                   samples // config.hopsize))
        rows = audio[:cpu_rows].cpu()
        agree_decided(
            f'({C}, {D}) from_audio, the first {cpu_rows} rows, against '
            f'device=cpu', ppg[:cpu_rows],
            port.from_audio(rows, config=config, checkpoint=path,
                            device='cpu'),
            port.from_audio(rows, config=config.replace(
                compute_dtype='float32'), checkpoint=path, device='cpu'),
            card)
        del ppg
        if (C, D) in timed:
            path_metrics(f'({C}, {D}) from_audio, {WIDTH_BATCH} x '
                         f'{WIDTH_SECONDS} s',
                         lambda: port.from_audio(audio, config=config,
                                                 checkpoint=path),
                         WIDTH_BATCH * WIDTH_SECONDS, card)
        del audio
        if (C, D) == legacy_pair:
            legacy = 0.1 * torch.randn(1, 1, LEGACY_SECONDS
                                       * config.sample_rate, generator=gen,
                                       device=dev)
            set_counts(counters)
            ppg = port.from_audio(legacy, config=config, checkpoint=path,
                                  legacy_mode=True)
            got, widths = read_counts(counters)
            print(f'({C}, {D}) launches in one legacy_mode call on 1 x '
                  f'{LEGACY_SECONDS} s: {got}, by width: {widths}', flush=True)
            if got != {'qkv_proj': 0, 'attention': L,
                       'out_proj_residual_ln': 0, 'ffn_residual_ln': L}:
                raise AssertionError(f'({C}, {D}) legacy_mode launches {got}')
            launches[f'attention_d{D}_h{H}'] += L
            launches[f'ffn_residual_layernorm_c{C}'] += L
            agree_decided(
                f'({C}, {D}) from_audio legacy_mode, 1 x {LEGACY_SECONDS} s, '
                f'against device=cpu', ppg,
                port.from_audio(legacy.cpu(), config=config, checkpoint=path,
                                legacy_mode=True, device='cpu'),
                port.from_audio(legacy.cpu(), config=config.replace(
                    compute_dtype='float32'), checkpoint=path,
                    legacy_mode=True, device='cpu'),
                card)
            del ppg, legacy
        torch.cuda.empty_cache()


@torch.no_grad()
def any_width_times(port, trunk, err, inputs, launches, workdir, dev, gen,
                    card):
    """Phase 38: each new instance at its main path's shape against its
    plain version, timed by CUDA events and device time beside its bound
    and library call: K1-K4 of the large trunk's first layer (64 x 400;
    records 'any_width/large/...'), K1-K4 at (384, 128) and (1024, 128)
    and K2 at (1024, 256) on layer 0 of phase 37's weights (128 windows x
    500, the last 50 frames of every second window masked), K4's
    round_input 1 form at 1024; then the 24-layer stack whole against its
    plain version and ``nn.TransformerEncoder``, printed with its device
    time by kernel."""
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
    from ppgs_tpu_torch.ops import fused_ffn

    def tagged(records, tag, C, H, prefix=''):
        """The records of ``layer_records`` renamed by instance, with
        their launches on the slice's main paths."""
        for record in records:
            kind = record['name']
            name = {'qkv_proj': f'qkv_proj_c{C}',
                    'attention': f'attention_d{C // H}_h{H}',
                    'out_proj_residual_ln': f'out_proj_residual_ln_c{C}',
                    'ffn_residual_ln': f'ffn_residual_ln_c{C}_'
                    + inputs[tag]['activation']}[
                        next(k for k in ('qkv_proj', 'attention',
                                         'out_proj_residual_ln',
                                         'ffn_residual_ln')
                             if kind.startswith(k))]
            record['name'] = f'any_width/{prefix}{name}'
            record['launches'] = launches[prefix + name]
        return records

    def per_tag(tag):
        return {k: {tag: None} for k in ('qkv_proj', 'attention',
                                         'out_proj_residual_ln',
                                         'ffn_residual_ln')}

    replaces = 'ppgs_tpu/ops/encoder_layer_kernel.py:330'
    records = tagged(layer_records(
        'large', inputs['large'], err, per_tag('large'),
        'ppgs_tpu/ops/encoder_layer_kernel.py:496', card), 'large',
        trunk.config.hidden_size, trunk.config.num_heads, 'large/')

    T, B = WIDTH_T, WIDTH_WINDOWS
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    mask[1::2, T - 50:] = False
    for C, D in ANY_PAIRS:
        config = width_config(port, C, D)
        model, _ = port.load.model(
            checkpoint=Path(workdir) / f'{config.config}.npz', config=config,
            device=dev)
        tag, H = f'c{C}_d{D}', C // D
        x = torch.randn(B, T, C, generator=gen, device=dev)
        w = layer_weights(model.layers[0])
        layer_kernel_checks(tag, x, mask, w, H, 'relu', err, inputs,
                            flip_share(K1_FLIP_SHARE, C))
        got = tagged(layer_records(tag, inputs[tag], err, per_tag(tag),
                                   replaces, card), tag, C, H)
        # at d_head 256 the layer's K1, K3 and K4 are the d_head 128 pair's
        records += got if D == 128 else got[1:2]
        if (C, D) == ANY_LEGACY:
            r = inputs[tag]['r']
            ffn = (w['w1'], w['b1'], w['w2'], w['b2'], w['g2'], w['be2'])
            M, Fh, bf16 = B * T, w['w1'].shape[1], torch.bfloat16
            w1t, w2t = w['w1'].T, w['w2'].T
            records.append(width_record(
                f'ffn_residual_layernorm_c{C}', 'ffn_ln.cu',
                'ppgs_tpu/ops/fused_ffn.py:70',
                (lambda: fused_ffn.ffn_residual_layernorm(r, *ffn),
                 lambda: fused_ffn.ffn_residual_layernorm_reference(r, *ffn),
                 lambda: F.layer_norm(r.to(bf16).float() + F.linear(F.relu(
                     F.linear(r.to(bf16), w1t, w['b1'].to(bf16))), w2t,
                     w['b2'].to(bf16)).float(), (C,), w['g2'], w['be2'])),
                lambda got, want: check(f'K4 C={C} relu round_input 1 '
                                        f'M={M}', got, want, 1e-2),
                (4 * M * C * Fh, 2 * M * C * 4 + 2 * C * Fh * 2
                 + (Fh + 3 * C) * 4),
                launches, card, 'addmm + ReLU + addmm + layer_norm', REPS,
                slice_name='any_width'))
        del model, x
        inputs.pop(tag)
        torch.cuda.empty_cache()

    # The large trunk's 24-layer stack, whole: printed, with its device
    # time by kernel (PERF.md's breakdown), not a record of its own
    wcfg = trunk.config
    C, H, L = wcfg.hidden_size, wcfg.num_heads, wcfg.num_layers
    Fh = wcfg.intermediate_size
    x16, smask = inputs['stack']['x16'], inputs['stack']['mask']
    layers = trunk.encoder.layers
    Bt, Tt = smask.shape
    M, pairs = Bt * Tt, smask.sum(dim=1).double().sum().item() * Tt
    whole_bound = L * sum(bound(flops, nbytes)[0] for flops, nbytes in (
        (2 * M * C * 3 * C, M * C * 4 + 3 * C * C * 2 + M * 3 * C * 2),
        (4 * pairs * C, M * 3 * C * 2 + M + M * C * 2),
        (2 * M * C * C, M * C * 2 + 2 * M * C * 4 + C * C * 2),
        (4 * M * C * Fh, 2 * M * C * 4 + 2 * C * Fh * 2)))

    def stack():
        return elk.encoder_stack(x16, smask, layers, H, activation='gelu')

    ms = time_ms(stack, REPS, 2)
    plain_ms = time_ms(lambda: elk.encoder_stack_reference(
        x16, smask, layers, H, activation='gelu'), HEAVY_REPS, 1)
    library = library_encoder(layers, C, H, Fh, dev, 'gelu')
    library_ms = time_ms(lambda: library(x16, src_key_padding_mask=~smask),
                         REPS, 2)
    del library
    print(f'B7 at wav2vec2-large\'s widths, {L} layers whole ({Bt} x {Tt}): '
          f'{ms:.4f} ms, bound {whole_bound:.4f} ms ({L} x the four '
          f'kernels\'), plain {plain_ms:.4f} ms, nn.TransformerEncoder '
          f'(1024, 16, 4096, gelu) x {L} {library_ms:.4f} ms: '
          f'{ms / library_ms:.2f}x [{card}]', flush=True)
    kernel_device_ms('B7 at wav2vec2-large\'s widths', stack, card)
    return records


def any_width_phases(port, workdir, dev, gen, card):
    """Phases 36-38: K1, K3 and K4 at the widths of their inference rule
    that no registered config has; returns the slice's JSON records."""
    phase(f'36 K1, K3 and K4 at C = {ANY_C} (K1 also at 1408; K4 ReLU and '
          f'GELU, round_input 0 and 1) and K2 at {ANY_HEADS} (d_head, '
          f'heads) against their plain versions at odd shapes')
    any_width_odd_shapes(dev)
    phase(f'37 wav2vec2-large\'s trunk ({W2V2_BATCH} x {W2V2_SECONDS} s) and '
          f'from_audio ({WIDTH_BATCH} x {WIDTH_SECONDS} s) at (C, d_head) = '
          f'{ANY_CHECKED + ANY_PAIRS} (main paths)')
    launches = collections.Counter()
    trunk = large_trunk(port, workdir, dev)
    err, inputs = large_trunk_path(port, trunk, dev, gen, launches, card)
    any_width_ppg_paths(port, workdir, dev, gen, launches, card)
    print(f'the slice\'s launches by record: {dict(launches)}', flush=True)
    phase(f'38 the new instances\' times on {card} (CUDA events, device time, '
          f'plain, library, bound)')
    records = any_width_times(port, trunk, err, inputs, launches, workdir,
                              dev, gen, card)
    for record in records:
        if not record['launches']:
            raise AssertionError(f'{record["name"]} was not launched on a '
                                 f'main path')
    return records


# The train_any_width slice (phases 39-41): the PPG transformer's training
# at widths of the layer kernels' rule (C % 128 == 0 up to 2048, d_head 128
# or 256) that no registered config has. First the four train kernels whose
# widths the training gate once was (K3's train form, K4's two train forms,
# ffn_train_bwd, ln_dropout_bwd) and colsum at ANY_C, at odd shapes, and
# the train attention at TRAIN_ANY_HEADS against the one-head kernels on
# the folded heads; then mel's shape (5 layers, F = 2048) at
# TRAIN_ANY_PAIRS: a whole-layer step (256 x 512) at each, a per-layer one
# (256 x 500) at TRAIN_ANY_SPLIT, both timed at TRAIN_ANY_TIMED, and
# train() there from TRAIN_ANY_FILES seeded mel caches; last the new
# instances at the step's shapes at TRAIN_ANY_C, timed
TRAIN_ANY_PAIRS = ((384, 128), (1024, 128), (1024, 256))
TRAIN_ANY_SPLIT = ((384, 128), (1024, 128))
TRAIN_ANY_TIMED = (1024, 128)
TRAIN_ANY_C = (384, 1024)
# The train attention's new head counts, (d_head, heads): C = 1024 and
# 2048 at both head widths
TRAIN_ANY_HEADS = ((128, 8), (128, 16), (256, 4), (256, 8))
# train() at TRAIN_ANY_TIMED: phase 18's corpus cut to 40 files, steps
# before the resume and in it (and phase 23's 8 buckets)
TRAIN_ANY_FILES, TRAIN_ANY_STEPS, TRAIN_ANY_RESUME = 40, 3, 2


@torch.no_grad()
def train_any_width_odd_shapes(port, dev):
    """Phase 39: at each C of ``ANY_C``, K3's train form, K4's two train
    forms (F = 128, 384 and 2048; relative limits by ``flip_rel``),
    ffn_train_bwd (fp32 and bf16 x; shares by ``flip_share``) and
    ln_dropout_bwd (fp32 and bf16 g) against their plain versions at odd
    rows (1 ... 1000), dropout off and 0.1, the keep words and masks
    Philox's bits; colsum at the step's shapes (dbqkv's 3 C columns among
    them); then the train attention at ``TRAIN_ANY_HEADS`` against the
    one-head kernels on the folded heads, bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 79)
    for C in ANY_C:
        k3_odd_shape_checks((), C, dev)
        for form in ('train_ln', 'y_out'):
            k4_odd_shape_checks(form, C, 'relu', WIDTH_F, dev, scaled=True)
        ffn_bwd_odd_shape_checks(dev, C)
        ln_dropout_bwd_odd_shape_checks(C, dev)
        M = TRAIN_B * TRAIN_T
        colsum_step_checks(width_config(port, C, 128), M, torch.randn(
            M, 3 * C, generator=gen, device=dev), dev)
        torch.cuda.empty_cache()
    for D, H in TRAIN_ANY_HEADS:
        head_fold_checks(D, H, dev)


def train_any_width_main_paths(port, workdir, dev, card):
    """Phase 40: at each pair of ``TRAIN_ANY_PAIRS``, mel's shape with
    seeded weights through a temporary npz: a 256 x 512 train step (B4)
    and at ``TRAIN_ANY_SPLIT`` a 256 x 500 one (B5 + B6), each with phase
    8's launches a layer exactly and its loss and gradients against the
    plain path's fed the same Philox masks (``width_train``), both timed
    with their peak memory at ``TRAIN_ANY_TIMED``; then train() at
    ``TRAIN_ANY_TIMED`` from the caches of ``TRAIN_ANY_FILES`` seeded files
    (phase 23's recipe: a run, its resume from the checkpoint, and a run in
    length buckets), K3's and K4's train forms among its launches. Returns
    the launches of the slice's records in these runs."""
    launches = collections.Counter()
    for C, D in TRAIN_ANY_PAIRS:
        config = width_config(port, C, D)
        path = Path(workdir) / f'{config.config}-train.npz'
        port.load.save_params(path, random_params(port, config,
                                                  SEED + C + D + 1))
        width_train(port, config, port.load.load_params(path), dev, launches,
                    card, split=(C, D) in TRAIN_ANY_SPLIT,
                    timed=(C, D) == TRAIN_ANY_TIMED)
        path.unlink()
        torch.cuda.empty_cache()

    C, D = TRAIN_ANY_TIMED
    got, by_path = train_from_caches(port, workdir, width_config(port, C, D),
                                     'train_any_width', card,
                                     ('out_proj_ln_train', 'ffn_train_fwd'))
    launches[f'out_proj_ln_train_c{C}'] += got['out_proj_ln_train']
    launches[f'ffn_train_fwd_b4_c{C}'] += by_path['whole-layer'][
        'ffn_train_fwd']
    launches[f'ffn_train_fwd_split_c{C}'] += by_path['per-layer'][
        'ffn_train_fwd']
    launches[f'ffn_train_bwd_c{C}'] += got['ffn_train_bwd']
    launches[f'ln_dropout_bwd_c{C}'] += got['ln_dropout_bwd']
    print(f'the slice\'s launches by record: {dict(launches)}', flush=True)
    return launches


def train_from_caches(port, workdir, config, tag, card, required):
    """train() of ``config`` from the caches of ``TRAIN_ANY_FILES``
    seeded files (phase 23's recipe, ``head_train_run``: a run, its resume
    from the checkpoint, and a run in length buckets, with
    ``TRAIN_ANY_STEPS`` and ``TRAIN_ANY_RESUME`` steps), in a directory
    ``tag`` of ``workdir``; raises unless each of ``required`` ran on the
    whole-layer path. Returns the train kernels' launches and those by
    path."""
    root = Path(workdir) / tag
    saved = point_data_dirs(port, root)
    try:
        root.mkdir(parents=True)
        head_corpus_caches(port, config, root, card, TRAIN_ANY_FILES)
        _, got, _, by_path = head_train_run(port, config, root, card,
                                            TRAIN_ANY_STEPS, TRAIN_ANY_RESUME)
    finally:
        for name, value in saved.items():
            setattr(port.config, name, value)
    for name in required:
        if not by_path['whole-layer'][name]:
            raise AssertionError(f'train() of {config.config} never launched '
                                 f'{name} on the whole-layer path')
    return got, by_path


@torch.no_grad()
def out_proj_train_record(layer, C, gen, launches, dev, card):
    """Phase 41's record of K3's train form at width C, on ``layer``'s
    weights at the training shape (256 x 512 rows, dropout 0.1): r, the
    normalised rows and 1/std against the plain version's (phase 8's
    limits: atol 1e-4, 1/std atol and rtol 1e-5), its mask the plain
    one's bit for bit."""
    from ppgs_tpu_torch.ops import dropout
    from ppgs_tpu_torch.ops import encoder_layer_train as elt

    bf16, M = torch.bfloat16, TRAIN_B * TRAIN_T
    wo = torch.from_numpy(layer['attn']['wo']).to(dev).to(bf16)
    bo = torch.from_numpy(layer['attn']['bo']).to(dev)
    g1, be1 = (torch.from_numpy(layer['norm1'][n]).to(dev)
               for n in ('scale', 'bias'))
    a16 = (0.5 * torch.randn(M, C, generator=gen, device=dev)).to(bf16)
    x = torch.randn(M, C, generator=gen, device=dev)
    drop = dropout.Drop(SEED + 17, dropout.site(0, 'attention'), DROPOUT)
    args = (a16, wo, bo, x, g1, be1, drop)
    name = f'out_proj_ln_train C={C} M={M}'

    def verify(got, want):
        check_k3_mask(name, M, C, drop, dev)
        return max(check(f'{name} r', got[0], want[0], atol=1e-4),
                   check(f'{name} n', got[1], want[1], atol=1e-4),
                   check(f'{name} rstd', got[2], want[2], atol=1e-5,
                         rtol=1e-5))
    return width_record(
        f'out_proj_ln_train_c{C}', 'out_proj_ln.cu',
        'ppgs_tpu/ops/encoder_layer_train.py:471',
        (lambda: elt.out_proj_ln_train(*args),
         lambda: elt.out_proj_ln_train_reference(*args),
         # addmm + dropout + layer_norm (it keeps no statistics)
         lambda: F.layer_norm(x + F.dropout(torch.addmm(
             bo.to(bf16), a16, wo), DROPOUT), (C,), g1, be1)),
        verify,
        (2 * M * C * C, M * C * 2 + M * C * 4 + C * C * 2 + 3 * C * 4
         + 2 * M * C * 4 + M * 4),
        launches, card, 'its library route', slice_name='train_any_width')


def train_any_width_times(port, launches, dev, card):
    """Phase 41: at each C of ``TRAIN_ANY_C``, on layer 0 of the (C, 128)
    model's seeded weights, the new instances at the step's shapes (256 x
    512 rows, dropout 0.1) against their plain versions, each timed by
    CUDA events and device time beside its plain version, its library
    route and its bound: K3's train form, K4's two train forms,
    ffn_train_bwd and ln_dropout_bwd (K4's relative limits by
    ``flip_rel``, ffn_train_bwd's shares by ``flip_share``)."""
    records = []
    for C in TRAIN_ANY_C:
        layer = random_params(port, width_config(port, C, 128),
                              SEED + C + 129)['layers'][0]
        gen = torch.Generator(device=dev).manual_seed(SEED + 83 + C)
        records.append(out_proj_train_record(layer, C, gen, launches, dev,
                                             card))
        records += train_ffn_records(layer, C, gen, launches, dev, card,
                                     slice_name='train_any_width',
                                     scaled=True)
        torch.cuda.empty_cache()
    return records


def train_any_width_phases(port, workdir, dev, card):
    """Phases 39-41: the transformer's training at widths of the rule that
    no registered config has; returns the slice's JSON records."""
    phase(f'39 the train kernels (K3\'s and K4\'s train forms, '
          f'ffn_train_bwd, ln_dropout_bwd, colsum) at C = {ANY_C} against '
          f'their plain versions at odd shapes, and the train attention at '
          f'{TRAIN_ANY_HEADS} (d_head, heads)')
    train_any_width_odd_shapes(port, dev)
    phase(f'40 train steps ({TRAIN_B} x {TRAIN_T}, and {TRAIN_B} x {SPLIT_T} '
          f'at {TRAIN_ANY_SPLIT}) at (C, d_head) = {TRAIN_ANY_PAIRS}, and '
          f'train() at {TRAIN_ANY_TIMED} from {TRAIN_ANY_FILES} seeded mel '
          f'caches (main paths)')
    launches = train_any_width_main_paths(port, workdir, dev, card)
    phase(f'41 the new instances\' times at C = {TRAIN_ANY_C} on {card} '
          f'(CUDA events, device time, plain, library, bound)')
    records = train_any_width_times(port, launches, dev, card)
    for record in records:
        if not record['launches']:
            raise AssertionError(f'{record["name"]} was not launched on a '
                                 f'main path')
    return records


# The wide_heads slice (phases 42-44): the attention kernels at every head
# width of the JAX rule up to the port's C <= 2048. K2 at d_head 16 and 32
# (a wav2vec2 trunk re-headed: the JAX rule takes 128 % d_head == 0) and
# on its wide route at d_head 384 to 2048, the train attention on its
# wide route at 384 to 2048, first at odd shapes against the plain
# versions and on folded heads against the one-head kernels; then mel's
# shape with the default two heads widened to WIDE_PAIRS (from_audio and
# the train steps), the timed pair WIDE_TIMED through train() too, and
# the wav2vec2 trunk's shape at 24 heads of 32. Phase 42 takes every wide
# width: each count of ranks of the forwards' clusters (2 to 8), with
# even and uneven shares of the cluster sum's slots, and a last rank of
# 128 columns at every count (384, 640, ... 1920)
WIDE_D = tuple(range(384, 2049, 128))
WIDE_K2_D = (16, 32) + WIDE_D
WIDE_TRAIN_D = WIDE_D
# The train attention's flip bounds (bf16, fp32) at 384, 512, 1024 and
# 2048: about twice the largest flip an H100 read at each width in phases
# 42 and 44 (bf16 0.0039, 0.0039, 0.0078, 0.0156; fp32 0.0030, 0.0033,
# 0.0053, 0.0071). A flipped p or ds moves each of a row's outputs by its
# ulp times one value of v, q or k, which does not grow with d_head; the
# number of outputs moved does, and so, slowly, the largest of them: a
# width between two of these takes the bounds of the wider (wide_flips)
WIDE_FLIPS = {384: (8e-3, 6e-3), 512: (8e-3, 7e-3), 1024: (1.6e-2, 1.1e-2),
              2048: (3.2e-2, 1.5e-2)}


def wide_flips(D):
    """``WIDE_FLIPS``' bounds at the least of its widths >= D."""
    return WIDE_FLIPS[min(w for w in WIDE_FLIPS if w >= D)]
# K2's heads at d_head 16 and 32 in the odd-shape checks: the wav2vec2
# trunk's C = 768 re-headed
WIDE_NARROW_HEADS = {16: 48, 32: 24}


@torch.no_grad()
def wide_heads_odd_shapes(dev):
    """Phase 42: K2 at ``WIDE_K2_D`` against its plain version at phase 3's
    odd shapes (T 1 ... 1536: the T > 1024 form too; prefix and holed
    masks, the wholly masked window, causal off and on, both scales); the
    train attention (attention_train_fwd, row_dot, attention_train_bwd) at
    ``WIDE_TRAIN_D`` against its plain versions at phase 6's odd shapes (T
    1 ... 1024, dropout off and 0.1, causal off and on; in bf16 and fp32
    the flips' share by ``flip_share`` at C = 2 d_head, since a p or a ds
    rounded the other way moves a row's d_head outputs, and their bounds
    ``wide_flips``' at d_head); and the two-head kernels against the
    one-head kernels on the folded heads, bit for bit
    (``head_fold_checks``)."""
    for D in WIDE_K2_D:
        k2_odd_shape_checks(D, WIDE_NARROW_HEADS.get(D, 2), dev)
    for D in WIDE_TRAIN_D:
        share = flip_share(1e-6, 2 * D)
        bound16, bound32 = wide_flips(D)
        attention_train_odd_shape_checks(dev, D, share, bound16,
                                         (share, bound32))
        head_fold_checks(D, 2, dev)
        torch.cuda.empty_cache()


# Phase 43's PPG transformers, (C, d_head) with mel's shape: the timed pair
# (two heads of 512) first, then two heads of 384 and 1024 and one of 2048,
# checked and not timed; legacy_mode at the timed pair
WIDE_TIMED = (1024, 512)
WIDE_PAIRS = (WIDE_TIMED, (768, 384), (2048, 1024), (2048, 2048))
# Phase 44's attention records: two heads of 512 and of 1024
WIDE_RECORDED = (WIDE_TIMED, (2048, 1024))
# The wav2vec2 trunk's shape (wav2vec2-base: C = 768, 12 layers, F =
# 3072) re-headed to 24 heads of 32
WIDE_TRUNK_HEADS = 24
# The CPU's rows in from_audio's bf16 gates: one 8 s row at C = 2048 is
# 4 windows of 5 layers on 8 cores
WIDE_CPU_ROWS = 1


def wide_trunk(port, workdir, dev):
    """The wav2vec2 trunk at ``WIDE_TRUNK_HEADS`` heads with seeded
    weights (through a temporary npz), prepared on the card in bf16."""
    import dataclasses

    wcfg = dataclasses.replace(port.models.w2v2.BASE,
                               num_heads=WIDE_TRUNK_HEADS,
                               compute_dtype='bfloat16')
    path = Path(workdir) / 'wav2vec2-d32.npz'
    port.load.save_params(path, random_w2v2_params(port, SEED + 103, wcfg))
    trunk = port.load.prepared_model(port.preprocess.w2v2fb._build, path,
                                     dev, wcfg)
    path.unlink()
    return trunk


@torch.no_grad()
def wide_trunk_path(port, trunk, dev, gen, launches, card):
    """Phase 43's trunk: ``models.w2v2.forward`` on 64 x 8 s of padded
    audio (T = 400) with its exact launches (12 of each of K1-K4, K2 at
    d_head 32), timed; then the 12-layer stack against its plain version
    on the same seeded (64, 400, 768) input, the last window wholly
    masked, at phase 9's relative L2 1e-2 for this trunk's widths."""
    from ppgs_tpu_torch.ops import encoder_layer_kernel as elk

    wcfg = trunk.config
    C, H, L = wcfg.hidden_size, wcfg.num_heads, wcfg.num_layers
    S = W2V2_SECONDS * 16_000 + 2 * port.preprocess.w2v2fb.PAD
    T = int(port.models.w2v2.feat_extract_output_lengths(S, wcfg))
    audio = 0.1 * torch.randn(W2V2_BATCH, S, generator=gen, device=dev)
    counters = layer_counters()
    set_counts(counters)
    hidden = port.models.w2v2.forward(trunk, audio)
    got, widths = read_counts(counters)
    print(f'wav2vec2 trunk at {H} heads of {C // H} ({L} layers, C = {C}): '
          f'launches in one models.w2v2.forward call on {W2V2_BATCH} x '
          f'{W2V2_SECONDS} s: {got}, by width: {widths}', flush=True)
    want_widths = {'qkv_proj': {C: L}, 'attention': {C // H: L},
                   'out_proj_residual_ln': {C: L}, 'ffn_residual_ln': {C: L}}
    if got != {name: L for name in counters} or widths != want_widths:
        raise AssertionError(f'the trunk at d_head {C // H}: launches {got} '
                             f'{widths}, not {L} of each at {want_widths}')
    launches[f'attention_d{C // H}_h{H}'] += L
    if (tuple(hidden.shape) != (W2V2_BATCH, T, C)
            or not torch.isfinite(hidden).all()):
        raise AssertionError(f'the trunk\'s output: shape '
                             f'{tuple(hidden.shape)}, or not finite')
    del hidden
    path_metrics(f'wav2vec2 trunk at {H} heads of {C // H}, forward, '
                 f'{W2V2_BATCH} x {W2V2_SECONDS} s',
                 lambda: port.models.w2v2.forward(trunk, audio),
                 W2V2_BATCH * W2V2_SECONDS, card)
    del audio
    x16 = torch.randn(W2V2_BATCH, T, C, generator=gen, device=dev).to(
        torch.bfloat16)
    mask = torch.ones(W2V2_BATCH, T, dtype=torch.bool, device=dev)
    mask[-1] = False
    layers = trunk.encoder.layers
    got = elk.encoder_stack(x16, mask, layers, H, activation='gelu')
    want = elk.encoder_stack_reference(x16, mask, layers, H,
                                       activation='gelu')
    check_rel(f'B7 the {L}-layer GELU stack at {H} heads of {C // H} (valid '
              f'rows)', got[mask], want[mask], 1e-2)


def wide_heads_main_paths(port, workdir, dev, gen, card):
    """Phase 43: mel's shape at each pair of ``WIDE_PAIRS`` with seeded
    weights: ``from_audio`` on 64 x 8 s (K1-K4 5 times each, K2 at the
    pair's d_head; the first ``WIDE_CPU_ROWS`` rows against device='cpu'
    at the bf16 gates), timed at ``WIDE_TIMED``, with ``legacy_mode`` on
    12 s there (K2's T > 1024 form); a 256 x 512 train step (B4) at each
    pair, and a 256 x 500 one (B5 through _FlashTrain, and B6) at
    ``WIDE_TIMED``, each with its exact launches (the train attention 5
    times a step) and its loss and gradients against the plain path's
    with the same Philox masks (``width_train``: relative L2 5e-2), both
    timed there with their peak memory; train() at ``WIDE_TIMED`` from
    seeded mel caches (``train_from_caches``); then the trunk at d_head
    32 (``wide_trunk_path``). Returns the launches of the slice's records
    in these runs."""
    launches = collections.Counter()
    any_width_ppg_paths(port, workdir, dev, gen, launches, card,
                        checked=WIDE_PAIRS[1:], timed=(WIDE_TIMED,),
                        legacy_pair=WIDE_TIMED, cpu_rows=WIDE_CPU_ROWS)
    for C, D in WIDE_PAIRS:
        config = width_config(port, C, D)
        params = port.load.load_params(Path(workdir) / f'{config.config}.npz')
        width_train(port, config, params, dev, launches, card,
                    split=(C, D) == WIDE_TIMED, timed=(C, D) == WIDE_TIMED)
        torch.cuda.empty_cache()
    got, _ = train_from_caches(port, workdir, width_config(port, *WIDE_TIMED),
                               'wide_heads', card,
                               ('attention_train_fwd', 'attention_train_bwd'))
    C, D = WIDE_TIMED
    for name in ('attention_train_fwd', 'row_dot', 'attention_train_bwd'):
        launches[f'{name}_d{D}_h{C // D}'] += got[name]
    trunk = wide_trunk(port, workdir, dev)
    wide_trunk_path(port, trunk, dev, gen, launches, card)
    del trunk
    torch.cuda.empty_cache()
    print(f'the slice\'s launches by record: {dict(launches)}', flush=True)
    return launches


@torch.no_grad()
def wide_trunk_record(port, launches, dev, card):
    """Phase 44's record of K2 at d_head 32: the trunk's 24 heads at its
    main path's shape (64 windows x 400 frames, the last 80 frames of
    every second window masked) against its plain version, beside SDPA."""
    from ppgs_tpu_torch.ops import flash_attention as fa

    H = WIDE_TRUNK_HEADS
    C, D = 768, 768 // H
    B, T = W2V2_BATCH, 400
    gen = torch.Generator(device=dev).manual_seed(SEED + 89)
    qkv = torch.randn(B, T, 3 * C, generator=gen, device=dev).to(
        torch.bfloat16)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    mask[1::2, T - 80:] = False
    att = (q, k, v, mask, H, fa.LOG2E / math.sqrt(D))

    sdpa_qkv = tuple(t.reshape(B, T, H, D).transpose(1, 2)
                     for t in (q, k, v))
    sdpa_mask = mask[:, None, None, :]
    pairs = H * T * mask.sum().item()
    return width_record(
        f'attention_d{D}_h{H}', 'attention.cu',
        'ppgs_tpu/ops/flash_attention.py:192',
        (lambda: fa.attention(*att), lambda: fa.attention_reference(*att),
         lambda: F.scaled_dot_product_attention(*sdpa_qkv,
                                                attn_mask=sdpa_mask)),
        lambda got, want: check(f'K2 d_head {D} ({H} heads) {B} x {T}', got,
                                want, 5e-3, 2 ** -7),
        (4 * pairs * D, 4 * B * T * C * 2 + B * T), launches, card,
        f'SDPA ({sdpa_backend(*sdpa_qkv, attn_mask=sdpa_mask)})', REPS,
        slice_name='wide_heads')


def wide_b4_times(port, dev, card):
    """Phase 44's B4 at ``WIDE_TIMED`` (``b4_times``, without the plain
    version): one layer's forward and backward on the training shape
    (TRAIN_B x TRAIN_T, ragged windows, dropout) with seeded weights."""
    C, D = WIDE_TIMED
    config = width_config(port, C, D)
    gen = torch.Generator(device=dev).manual_seed(SEED + 83)
    model = port.train.core.init_model(config, dev)
    model.load_state_dict(port.convert.params_from_jax(
        port.load.flatten_params(random_params(port, config, SEED + 83))))
    B, T = TRAIN_B, TRAIN_T
    lengths = T - torch.randint(0, T // 2, (B,), generator=gen, device=dev)
    lengths[0] = T
    mask = torch.arange(T, device=dev)[None] < lengths[:, None]
    x = torch.randn(B, T, C, generator=gen, device=dev)
    cot = torch.randn(B, T, C, generator=gen, device=dev)
    b4_times(config, model.layers[0], C // D, x, mask, lengths, cot, card,
             plain=False)


def wide_heads_phases(port, workdir, dev, gen, card):
    """Phases 42-44: the PPG transformer at the default two heads at
    every width, and the trunk's K2 at d_head 32 and 16; returns the
    slice's JSON records."""
    phase(f'42 K2 at d_head 16, 32 and every d_head % 128 == 0 from '
          f'{WIDE_D[0]} to {WIDE_D[-1]}, and the train attention at the '
          f'latter, against their plain versions at odd shapes, and on '
          f'folded heads against the one-head kernels')
    wide_heads_odd_shapes(dev)
    phase(f'43 from_audio ({WIDTH_BATCH} x {WIDTH_SECONDS} s) and train steps '
          f'({TRAIN_B} x {TRAIN_T}, and {TRAIN_B} x {SPLIT_T} at '
          f'{WIDE_TIMED}) at (C, d_head) = {WIDE_PAIRS}, legacy_mode at '
          f'{WIDE_TIMED}, train() there from {TRAIN_ANY_FILES} seeded mel '
          f'caches, and the wav2vec2 trunk at {WIDE_TRUNK_HEADS} heads of '
          f'{768 // WIDE_TRUNK_HEADS} (main paths)')
    launches = wide_heads_main_paths(port, workdir, dev, gen, card)
    phase(f'44 the new instances\' times on {card} (CUDA events, device time, '
          f'plain, SDPA, bound), and B4 at {WIDE_TIMED} beside its bound and '
          f'nn.TransformerEncoderLayer')
    records = widths_attention_times(launches, dev, card, WIDE_RECORDED,
                                     'wide_heads', wide=True)
    records.append(wide_trunk_record(port, launches, dev, card))
    wide_b4_times(port, dev, card)
    for record in records:
        if not record['launches']:
            raise AssertionError(f'{record["name"]} was not launched on a '
                                 f'main path')
    return records


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--slices',
                        default='mel,train,w2v2fb,bottleneck,api,data,'
                        'head_train,w2v2,codec,parallel,widths,any_width,'
                        'train_any_width,wide_heads',
                        help='comma-separated subset of mel,train,w2v2fb,'
                        'bottleneck,api,data,head_train,w2v2,codec,'
                        'parallel,widths,any_width,train_any_width,'
                        'wide_heads')
    parser.add_argument('--parallel-rank', nargs=2, metavar=('MODE', 'DIR'),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    slices = set(args.slices.split(','))
    if not torch.cuda.is_available():
        sys.exit('chip_smoke.py needs a CUDA device; none is available')
    if args.parallel_rank:
        # one rank of the parallel slice (phases 31-32), started by it
        parallel_rank(*args.parallel_rank)
        return
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import ppgs_tpu_torch as port
    from ppgs_tpu_torch import kernels

    digest = assets_digest()       # the JAX package's assets, read only

    dev = torch.device('cuda')
    # Plain fp32 products and convs in full fp32 (cuDNN runs fp32 convs in
    # TF32 by default); the entry points set the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase('1 card')
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)

    phase('2 build')
    seconds = kernels.build_all()
    print(f'built {len(kernels.SOURCES)} kernel sources with nvcc (sm_90a) '
          f'in {seconds:.1f} s into {kernels.build_dir()}', flush=True)
    for src, log in sorted(kernels.build_log.items()):
        for line in log.splitlines():
            if 'Function properties for' in line:
                # the kernel's mangled name to its template arguments
                print(f'  {src}: {line.split(" for ", 1)[1].strip()[:96]}')
            elif 'Used' in line or 'spill' in line:
                print(f'  {src}: {line.strip()}')

    config = port.config.get()            # the mel model, bf16 compute
    workdir = tempfile.TemporaryDirectory()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    records = []
    if 'mel' in slices:
        records += mel_phases(port, config, workdir.name, dev, gen, card)
    if 'train' in slices:
        records += train_phases(port, config, workdir.name, dev, gen, card)
    if 'w2v2fb' in slices:
        records += w2v2fb_phases(port, workdir.name, dev, gen, card)
    if 'bottleneck' in slices:
        records += bottleneck_phases(port, workdir.name, dev, gen, card)
    if 'api' in slices:
        api_phases(port, config, workdir.name, dev, gen, card)
    if 'data' in slices:
        data_phases(port, workdir.name, card)
    if 'head_train' in slices:
        records += head_train_phases(port, workdir.name, dev, card)
    if 'w2v2' in slices:
        records += w2v2_phases(port, workdir.name, dev, card)
    if 'codec' in slices:
        codec_phases(port, workdir.name, dev, card)
    if 'parallel' in slices:
        records += parallel_phases(port, workdir.name, dev, card)
    if 'widths' in slices:
        records += widths_phases(port, workdir.name, dev, gen, card)
    if 'any_width' in slices:
        records += any_width_phases(port, workdir.name, dev, gen, card)
    if 'train_any_width' in slices:
        records += train_any_width_phases(port, workdir.name, dev, card)
    if 'wide_heads' in slices:
        records += wide_heads_phases(port, workdir.name, dev, gen, card)
    phase()
    if assets_digest() != digest:
        raise AssertionError('a file under ppgs_tpu/assets/ changed')
    print(f'ppgs_tpu/assets/: the sha256 of its {len(digest)} files '
          f'unchanged', flush=True)

    workdir.cleanup()
    print(json.dumps({'kernels': records}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
