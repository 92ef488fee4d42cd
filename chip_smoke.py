#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one line:

1. build: compile every kernel of ``texttoaudiogrounding_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and the native evaluation
   decoder (``native/decode.cpp``, g++), and print the card's name and
   power limit as ``nvidia-smi`` reports them; then the registers, shared
   memory and spills of each kernel of the second designs
   (``conv_block_v2.cu``, ``conv_block1_v2.cu``, ``logmel_v2.cu``,
   ``gru_fwd_sm90.cu``, ``gru_bwd_sm90.cu``, ``gru_walk_sm90.cu``,
   ``bn_pool_v2.cu``, ``conv_block_wino_v2.cu``, ``conv_block_tri_v2.cu``,
   ``conv_block_mel3_v2.cu``, ``pair_conv_pool_v2.cu``) from their
   ``-Xptxas -v`` logs (also ``block1_small_v2.cu``, ``logmel_v3_v2.cu``
   and ``logmel_v4_v2.cu``);
2. kernels: run each kernel at the shapes its main path gives it against
   its plain PyTorch version on the same inputs on the card, with the
   stated tolerance, and time both with CUDA events: the four serving
   kernels at the largest request's bucket (32 clips of 10 s at 32 kHz),
   all in their second designs: row 1 (the log-mel, ``logmel_v2.cu``,
   within 2e-3 dB, its gap to the f64 log-mel reported), row 2 (block 1,
   ``conv_block1_v2.cu``, in its four modes: int8 ``True`` and
   ``single`` bit for bit to the plain version and the first design, the
   bf16 modes within 1e-2 relative RMS), rows 3 and 4 (blocks 2-4, the
   wgmma implicit GEMM, ``conv_block_v2.cu``), int8 held bit for bit to
   the plain version and to the first design; both designs timed in turns
   (v1 v2 v2 v1) in every mode and traced by launch, rows 1 and 2 beside a
   PyTorch chain (``torch.stft``; cuDNN bf16 convolutions);
   the BiGRU recurrence (forward with an f32 and a bf16 carry, backward
   with f32 and with bf16 operands, and the hoisted f32 backwards v2 and
   v3, whose walk and dWh product are also timed apart; each gradient
   held on its own) at T = 250, 2B = 64, H = 256, the forward, the
   backward and the hoisted walks on their second designs
   (``gru_fwd_sm90.cu``, ``gru_bwd_sm90.cu`` and ``gru_walk_sm90.cu``, one
   cluster launch a walk) held to their plain versions and to their first
   designs (``gru.cu``, one launch a step) with the same tolerance, each
   timed in turns (first, second, second, first) and at the latency floor
   (B = 1, H = 4), the forward and the walks also at the exchange floor
   (B = 1, H = 256), their CUDA launches a call counted by the profiler
   (1 a walk for the hoisted walks), the walks also at a ragged B = 13, at
   odd numbers of units a CTA (B = 5, H = 30 and 120) and at T = 2 within
   1e-5 of their plain versions, the forward also at a ragged B = 13 and
   at B = 128 against its plain version, its first design and, with the
   f32 carry, ``torch.nn.GRU``, at T = 2 tight enough that a bf16 forward
   without its carry roundings fails, and at odd numbers of units a CTA
   (B = 5, H = 30 and 120), the bf16-operand backward also at T = 2,
   where its bf16 roundings are held tight enough that the backward
   without them fails, beside ``torch.nn.GRU`` (cuDNN, f32 and bf16) on
   the same weights as a yardstick and a third opinion; row 13's forward
   and backward also at the CDur path's shape (T = 125, 2B = 64, H = 128
   over an input of 128: 8-CTA clusters, 3 groups of 11 rows), each output
   and gradient within 1e-4 of its plain version, beside ``torch.nn.GRU``
   and their CUDA launches a call counted (1 and 2), and so at the weak
   class-mapping train step's shape (T = 250, 2B = 32, H = 256: mixup
   halves the batch of 32 before the conv blocks) and at the zoo's text
   shape (T = 20, 2B = 160, H = 256 over 300); and the training
   path's pool kernels (``dual_pool_fwd``/``_bwd``, ``bn_pool_fwd``,
   ``bn_pool_bwd`` on its second design, ``bn_pool_v2.cu``, and the batch
   statistics ``bn_pool_stats``) at the four conv blocks' outputs of a
   batch-32 x 10 s bf16 step, and block 1 in f32, beside the plain
   PyTorch chain they replace (ReLU or train-mode BN, then
   ``F.avg_pool2d + F.max_pool2d``, forward + backward) for information;
   the backward also within 1e-4 of its first design (``three_pass``,
   ``bn_pool.cu``, itself held within 1e-4 of the plain version), the
   same bits on two calls, both timed in turns and
   their CUDA launches a call counted by the profiler (2 for the second
   design), with its
   two-pass streaming floor; the statistics (var within 1e-4 relative,
   mean within 1e-5 std of plain ``batch_stats``, also on block 1's x·0.5
   + 3) beside ``torch.var_mean`` as the library call;
3. serving: ``GroundingPredictor`` over the flagship ``BiEncoder`` at full
   width (Cnn8Rnn 64/128/256/512, BiGRU 2x256, vocabulary 5000, embedding
   512, shared 512) with random weights from a numpy seed answers requests
   of several batch sizes and lengths, the largest 32 clips x 10 s; every
   kernel's launch count must rise as each sub-batch's forward requires,
   ``frame_sim`` must be finite in (0, 1] with the reference length
   arithmetic, and within 0.05 of the port's all-plain f32 path on the
   card; the audio embedding of every sub-batch, taken from the very
   forward that served the request, must lie within 5 % relative RMS of
   the plain path on the same padded input.  A batch-32 request is then
   timed and profiled on the default path (grouped-loop BiGRU) and with
   the bf16 GRU kernel opted in, and with block 1 all in int8
   (``block1_quant="int8"``, the JAX ``TTG_B1_QUANT=1``), each checked the
   same way, the latter's launch counts too, and with block 1 all in int8
   in the single staging (``block1_mode="single"``, the JAX
   ``TTG_B1_MODE=single``), held to the same contract; so are the two
   routing switches (``SERVING_SWITCHES``), their launches exact: block 1
   on the plain bf16 path (``block1_pair=False``, the JAX
   ``TTG_FUSED_B1=0``), the plain frontend under the int8 blocks
   (``logmel_kernel=False``) and row 1's kernel feeding the f32 model
   (``logmel_kernel=True``, the JAX ``TTG_PALLAS_FRONTEND=1``);
4. designs: the JAX package's designs that no shipped model routes, one
   record each in one table: block 1's all-int8 mode in both stagings and
   ``fused_pair_conv_pool`` (with and without conv1, second design
   ``pair_conv_pool_v2.cu``), ``fused_block2`` (row 6, on row 3's second
   design ``conv_block_v2.cu`` at its own chunk, also at odd T: 4 clips x
   499 frames, tc 2) and ``fused_block1`` (row 7, second design
   ``block1_small_v2.cu``) on the batch-32 request's block-1 input (the
   bn0 output) and output with the served model's weights, beside the
   routed rows 2 / 3; the Winograd
   block (``fused_block_wino``, int8 and bf16, second design
   ``conv_block_wino_v2.cu``) at the pool-(2, 2) analog of
   blocks 3 and 4 (a record each) on that request's block-2 output with
   the served blocks 3-4 weights, driven through ``ConvBlock(...,
   wino=True)``, beside the direct9 kernel at pool (2, 2) on the same
   input and bound by the Winograd products' operations (the direct
   conv's beside it); row 4's mel3 and tri tap modes (``mel3=(True,
   True)`` and ``tri=(True, True)`` on their second designs
   ``conv_block_mel3_v2.cu`` and ``conv_block_tri_v2.cu``, int8 at each
   mode's own chunk and the bf16 mode) at the flagship's blocks 3 and 4
   (pool (1, 2), a record each) on that request's block-2 output and then
   the mode's own block-3 output, with the served weights, beside direct9
   on the same input, tri also at its own and direct9's chunk bit for bit
   against the row-4 kernel, mel3 also in its (True, False) mode and in
   bf16 bit for bit against tri, each traced by launch; rows 5-8 and
   both tap modes also against their first designs (int8 bit for bit, the
   first design also against its plain version, bf16 within 1e-2), timed
   in turns with them (v1 v2 v2 v1; mel3 and tri with direct9 between,
   row 5's full block with row 3, row 7 with row 2's all-int8 / bf16
   mode), each design's kernels a call counted
   by the profiler and held to the design's count, beside the cuDNN bf16
   chain (two ``F.conv2d``, or one for row 5 without conv1, affine, ReLU,
   pools) as a yardstick; and the
   log-mel variants v3 (second design ``logmel_v3_v2.cu``, its edge
   frames within 2e-3 dB of the plain frontend's, timed in turns with its
   first design beside row 1, 2 kernels a call by the profiler) and v4
   (second design ``logmel_v4_v2.cu``, timed in turns with its first
   design beside row 1, 2 kernels a call by the profiler) on that
   request's waveform beside row 1's two designs; then rows 3, 4 direct9,
   5 and 6 at M = 4, pool (2, 2), which the second design's GEMM does not
   take: each through its public function bit for bit to its plain version
   in int8, raising its first design's counter once; and row 7 at M = 32
   (its second design) and 48 (its first) on 4 clips of the request's
   block-1 input cut to that many mels, int8 bit for bit and bf16 within
   1e-2 of its plain version, each call raising one counter once.  Each
   design runs once (its launches counted, exactly), then each int8
   kernel is held bit for bit against its plain version and its
   bf16 mode within
   1e-2 relative RMS (v3 within 0.035 dB max and 1e-4 dB mean of its plain
   version, limits that row 1's first design must miss; v4 bit for bit
   against row 1's second design and its first design against row 1's
   first; row 2's int8 records also bit for bit
   against row 2's first design), is timed with CUDA events with its
   weights laid out
   once, as the routes keep them, and each design's relative RMS to the
   f32 plain block (the f64 log-mel) on the same input is reported;
5. train: ``StrongRunner.fit`` on the strong-supervision config's model
   (``configs/strong/biencoder_train.yaml``: BiEncoder(Cnn8Rnn f32,
   EmbeddingAgg(5000, 512), ExpNegL2, shared 512), FrameBceLoss, Adam 1e-3
   with global-norm clipping at 1.0, plateau LR) at full width, batches of
   32 clips x 10 s built in memory in ``AudioPhraseDataset``'s item
   format, 2 epochs of 4 steps with a validation pass each; the GRU
   kernels' counts must rise by one forward and one backward per train
   step and one forward per validation step, the checkpoints must exist,
   the loss must be finite and fall over 8 steps on one fixed batch, and
   every parameter's gradient must lie within a stated relative RMS of
   the all-plain path's on the same batch and weights; then train steps
   are timed with CUDA events and one is profiled.  TF32 is off (full f32
   convolutions and products) for all of it, as the trainer's default;
6. train_bf16: the same fit in the bf16 mixed-precision mode with the
   training kernels opted in (``audio_encoder.args``: ``dtype: bfloat16``,
   ``gru_bwd: bf16``, ``bn_pool: [64, 128]``, ``pool_vjp: [256, 512]``);
   the counts must rise by one log-mel, two of each pool kernel (and of
   ``bn_pool_stats``; ``bn_pool_bwd_three_pass`` none), one bf16
   GRU forward and one bf16 GRU backward per train step, and one log-mel
   and two ``dual_pool_fwd`` per validation step (the bf16 grouped GRU loop
   there, no GRU kernel); checkpoints, a finite loss that falls over 8
   steps on one batch, and gradients within stated relative RMS limits of
   the plain bf16 route's and within twice that route's own change when
   the waveform is scaled by 1 + 1e-6; then three routes are timed (CUDA
   events, 5 steps, in turns a b c c b a) and profiled once each: (a)
   plain bf16 with the f32 GRU kernel, (b) ``bn_pool`` on all four blocks
   + the bf16 GRU, (c) ``pool_vjp`` on all four blocks + the bf16 GRU;
7. train_weak: ``WeakPhraseRunner.fit`` on the phrase-level WSTAG config
   (``configs/weak_phrase/cnn8rnn_w2vmean_similarity.yaml``:
   MultiTextBiEncoder(Cnn8Rnn f32, EmbeddingAgg(5221, 512), DotProduct,
   shared 512, no projections, linear-softmax pooling), ClipBceLoss, Adam
   1e-3 with clipping at 1.0) at full width, batches of 32 clips x 10 s x
   32 phrases from ``AudioSamplePhrasesDataset`` with similarity-sampled
   negatives over data made in memory (noise clips, captions from a
   seeded phrase pool, a random 512-d phrase embedding), 2 epochs of 4
   steps with validation, once with each hoisted GRU backward; the counts
   must rise by one ``gru_fwd`` and one ``gru_bwd_v2`` (or ``_v3``) per
   train step and one ``gru_fwd`` per validation step, checkpoints must
   exist, the loss must fall over 8 steps on one batch and both routes'
   gradients lie within stated relative RMS limits of the all-plain
   path's; then the step is timed with each GRU backward, (a) v1, (b) v2,
   (c) v3, in turns a b c c b a, and profiled once each;
8. evaluate: from the checkpoints of phases 5 and 7, on an evaluation set
   made in memory (32 clips x 10 s, two phrases a clip, each a tone over
   one labelled segment; ``AudioPhraseEvalDataset`` over waveforms by
   audio id, a duration TSV), with ``configs/strong/biencoder_eval.yaml``'s
   keys (50 thresholds, ``max_efprs`` 400 ... 1000 and None):
   ``StrongRunner.evaluate`` of the f32 checkpoint (``gru_fwd`` once a
   batch, and no other kernel), again with ``gru_kernel=False`` (the score
   tracks within 1e-4 of the kernel's) and with the serving
   ``model_overrides`` (``dtype: bfloat16, conv_mode: int8``: rows 1-4
   once a batch each, as a served request's forward, the tracks within
   0.05 of the f32 ones), and ``WeakPhraseRunner.evaluate`` of the WSTAG
   checkpoint with ``configs/weak_phrase/eval.yaml``'s keys (``gru_fwd``
   once a batch); every metric finite in [0, 1], ``result.txt`` and the
   predictions TSVs written; the native decoder against NumPy on every
   evaluated track (the same segments); ``GroundingPredictor.
   from_experiment`` on the strong run serving the first phrase of every
   clip in one request (within 1e-4 of the evaluated tracks); the strong
   run resumed from ``last.pth`` for one more epoch (it starts at the
   saved epoch + 1 and Adam's step count runs on); the forward's ms a
   batch (CUDA events) in f32, in the serving mode and in the serving mode
   with the bf16 GRU kernel (each within 0.05 of the f32 forward), and
   the host seconds of decoding, PSDS and th-AUC;
9. train_cdur: ``StrongRunner.train`` on ``configs/strong/cdur_w2vmean.yaml``
   as a dict (``_cdur_config``: BiEncoder(CrnnEncoder(256),
   EmbeddingAgg(5221, 256), ExpNegL2), FrameBceLoss at 0.08 s frames), cut
   as ``CDUR_CUTS`` lists: data in memory (32 clips x 10 s a batch, 2
   validation batches of 64), 2 epochs of 4 steps, the step profiler on
   steps 2-3; ``gru_fwd`` / ``gru_bwd`` rise by one a train step (and one
   ``gru_fwd`` a validation batch), the trace names both cluster GRU
   kernels, the epoch log its throughput, checkpoints written;
   ``StrongRunner.evaluate`` of the run (metrics finite in [0, 1], frames
   of 0.08 s) and ``from_experiment`` (within 1e-4 of the evaluated
   tracks); the loss falls over 8 steps on one batch; the step's ms (CUDA
   events, 5 steps) and, from one traced step, the device ms of the
   frontend's DFT matmul, the convolutions and row 13, with the largest
   operators;
10. finetune_frozen: the WSTAG (v2) run's best checkpoint finetuned for an
   epoch of 4 steps with ``freeze_cnn`` and ``freeze_bn`` and
   ``save_trainable_only``: every frozen parameter and running statistic
   bit for bit the same, the GRU and text parameters moved, the checkpoint
   the trainable parameters and every buffer; a resume from it starts at
   the saved epoch + 1;
11. desed: ``evaluation/desed.py``'s ``score_clips_zero_shot`` with
   ``from_experiment`` on the WSTAG run over 16 synthetic 10 s clips x the
   10 DESED classes (one forward of 10 rows a clip, ``gru_fwd`` once a
   forward), PSDS1, PSDS2 and macro-F1 finite in [0, 1], the host seconds
   of scoring and of the metrics;
12. train_sentence: ``WeakSentenceRunner.train`` on
   ``configs/weak_sentence/phrase_wise/cnn8rnn_w2vmean_dp_amean_tmean.yaml``
   as a dict (``AudioTextAlignByPhrase``: Cnn8Rnn f32, EmbeddingAgg(5221,
   512), ``AlignDotProduct``, ``AudioMeanTextMean``;
   ``MaxMarginRankingLoss``), cut as ``SENTENCE_CUTS`` lists, over
   ``AudioCaptionPhrasesDataset`` + ``VarNumTextCollate`` (32 clips x 10 s
   of 1-6 phrases a batch, made in memory), 2 epochs of 4 steps and 2
   validation batches: ``gru_fwd`` once a step, ``gru_bwd`` once a train
   step, checkpoints; gradients within the f32 limits of the all-plain
   path's, the loss falling over 8 steps on one batch, the step's ms
   (CUDA events) and one profiled step; then the word-wise config
   (``AudioTextAlignByWord`` on 8-20 token captions) for 1 epoch and
   ``WeakSentenceRunner.evaluate`` of it with ``word_wise/eval.yaml``'s
   keys on phase 8's set (``gru_fwd`` once a batch, metrics finite in
   [0, 1], every frame of each track), again with ``gru_kernel=False``
   (tracks within 1e-4);
13. train_selfsup: ``WeakPhraseSelfSupervisionRunner.train`` on
   ``configs/weak_phrase/cnn8rnn_w2vmean_clustering_selfsup.yaml`` as a
   dict, cut as ``SELFSUP_CUTS`` lists (WAV clips written to the work
   directory, clustering negatives over a seeded 32-cluster map), the
   teacher loaded from phase 7's (v2) ``best.pth`` through
   ``teacher.checkpoint``, 2 epochs of 4 steps: ``gru_fwd`` twice a step
   (student and teacher), ``gru_bwd`` once a train step; the teacher's
   parameters and buffers bit for bit unchanged, no checkpoint key of it,
   its ``frame_sim`` on the first batch within 1e-4 of the checkpoint in a
   fresh plain model, the fused labels at least the batch's; the step's
   ms;
14. cross_models: one forward each at full width on 4 clips x 8 phrases
   of ``MultiTextBiEncoder`` with ``CrossAttentionGating(512)`` + a
   token-level ``DotProduct``, with ``CrossAttention(512, 8)``, with
   ``upsample=True``, and of ``AudioTextCrossAlignByPhrase``, each within
   1e-4 relative RMS of the same weights with ``gru_kernel=False`` and
   ``gru_fwd`` once; one train step of ``MultiTextBiEncoderWithAlign``
   under ``ClipBceLoss`` + ``MaxMarginRankingLoss(sim_key=
   "sentence_sim")``: a finite loss, ``gru_fwd`` and ``gru_bwd`` once;
15. class_mapping: ``ClassMappingWeakRunner.train`` on
   ``configs/class_mapping/kmeans_weak.yaml`` as a dict
   (``AudioTagging(Cnn8Rnn f32, 32 classes, linear_softmax)``,
   ``ClipBceLoss``, mixup and SpecAugment), cut as ``CLASS_MAPPING_CUTS``
   lists, ``KmeansMappingDataset`` items made in memory (weak labels
   from a seeded phrase → cluster map) through ``VarLenPadCollate``, 2
   epochs of 4 steps of 32 clips x 10 s and 2 validation batches:
   ``gru_fwd`` once a step, ``gru_bwd`` once a train step, the train
   step's BiGRU on 16 clips (mixup halves the batch); gradients within the
   f32 limits of ``gru_kernel=False``'s on the same mixup coefficients and
   stripes, the loss falling over 8 steps on one batch with the
   augmentations held fixed, the step's ms; ``evaluate_tagging`` (AP in
   [0, 1], the TSV); then ``ClassMappingStrongRunner.train`` on
   ``kmeans_strong.yaml`` (``MaskedFrameBceLoss``, strong labels at 0.04
   s) for 1 epoch of 4 steps and ``evaluate`` of it with ``eval.yaml``'s
   keys on phase 8's clips, each phrase given a class (``gru_fwd`` once a
   batch, metrics in [0, 1], tracks within 1e-4 of ``gru_kernel=False``);
16. cli: ``cli.main([..., "--device", "cuda"])`` in this process against
   phase 5's run: ``inference`` (the segments equal the steps done by
   hand, ``gru_fwd`` once), ``export`` and ``predictor_from_deployment``
   (a 3-clip request bit for bit ``from_experiment``'s), ``strong
   calc_params`` (the flax tree's count), ``strong calc_params_macs`` (its
   ``SystemExit``), and ``python3 -m texttoaudiogrounding_tpu_torch
   inference`` in a subprocess (exit 0, the same segments);
17. released_model: the released grounding model at full width
   (``models/hf_api.py``: Cnn8Rnn + the RoBERTa-base CLAP text tower,
   512-d projections, ``DotProduct``): a reference-format deployment
   checkpoint from a numpy seed through ``import_hf_grounding`` into the
   serving model (bf16, int8 blocks), the f32 model, the all-plain f32
   model and the serving model with the bf16 GRU kernel; 32 clips x 10 s
   (10 / 7.8 / 5 s) with a 4-16 token phrase each, through the model's
   forward: rows 1-4 launched their serving counts a forward (and
   ``gru_fwd_bf16`` once with the GRU kernel), the lengths, ``frame_sim``
   finite in (0, 1] with padded frames zeroed, within 0.05 of the
   all-plain path and its audio embedding within 5 % relative RMS, the
   text tower's ``seq_emb`` within 1e-4 of the same tower on the CPU; the
   forward's, the text tower's and the audio tower's ms (CUDA events) and
   the peak device memory;
18. zoo: ``CrossCnn8Rnn`` (8 steps) and ``CrossCDur`` (4 steps) in f32 with
   ``FrameBceLoss`` and Adam on one batch of 32 x 10 s (the first step's
   gradients within 1e-4 / 2e-2 of the all-plain path's, row 13 once each
   way a step, the loss falling); ``RnnEncoder`` (bidirectional GRU over
   160 rows of 20 tokens) one step at H = 256 (the cluster designs), at
   H = 300 and 302 (the first design, ``gru.route``; 302 padded to 304
   with zero units) and over 400 rows at H = 300 (the first design's
   launches split by ``gru.per_step_plan``), gradients within 1e-4 of the
   plain GRU's; row 13's first design by its plan at H = 302 and at 400
   rows of H = 300 against its plain version (1e-4); ``IntraAttention``
   / ``SelfAttention`` forward and backward finite; ``Cnn14``,
   ``ResNet38``, ``WavegramLogmelCnn14`` and
   the AST at full width on 32 x 10 s (shapes, finite, 2 clips within 1e-4
   of the CPU); an ``AudioTextClip(Cnn14, RetrievalBert at BERT-base
   width)`` step of ``InfoNceLoss(tau=1)`` whose encoder gradients with
   ``gradient_clip=0.5`` are 0.5x those with 1.0, and its step time; and
   the encode loop of ``extract_phrase_embeddings`` over 1,000 phrases on
   a CLAP tower (host seconds);
19. multi_device: the strong fit of phase 5 (the config's keys at full
   width, ``MULTI_DEVICE_CUTS``) on ranks of ``torch.distributed``, all on
   ``cuda:0``, the cuDNN algorithms deterministic: (a) on an NCCL group of
   one rank with ``parallel.mesh {data: 1}``, its step losses within 1e-6
   of the plain single-process fit and row 13 launched once a step at 2B =
   64; (b) two gloo ranks (``torch.multiprocessing``, ``data: 2``), the
   first epoch's losses within 2e-4 relative of (a) and all within
   ``MD_FIT_LOSS_RTOL``, the first step's gradients within
   ``MD_GRAD_LIMITS`` (the one-rank fit's own change under the waveform
   scalings ``MD_WAVE_SCALES`` reported beside them), the running
   statistics bit for bit alike on the ranks, row 13 once a step at 2B =
   32 on each rank, rank 0's checkpoint served by a one-rank predictor;
   (d) in (b)'s ranks, route (b) (``MD_BF16_ARGS``) for one step, its loss
   within 2e-4 of the one-rank step's and its gradients within the bf16
   limits, and row 12's statistics (``ttg_bn_pool_sums``) and split
   backward (``ttg_bn_pool_bwd_v2_sums`` / ``_apply``, the ranks' sums
   summed between them) within 1e-4 of the plain versions given the same
   global sums; (c) four gloo ranks, data 2 x model 2 with the dp4tp2
   recipe's rules (fc1's weight, the embedding table and their Adam moments
   half their rows on a rank), the losses as in (b), then resumed under
   data 4 x model 1 at epoch 3; (e) ``GroundingPredictor(devices=["cuda:0",
   "cuda:0"])`` over the flagship serving model on the batch-32 and a
   3-clip request: each shard bit for bit the single-device predictor's on
   its padded rows, the request within 0.05 of it, rows 1-4 launched their
   counts a shard; (fault) two gloo ranks with one fault planted, bn0 on
   its rank's rows alone (local statistics): (b)'s limits on the first
   epoch's losses, on all the losses and on the gradients after the trunk,
   and (d)'s, must each reject it; (f) the sentence-level,
   self-supervision and class-mapping runners at full width
   (``MD_RUNNER_CUTS``: 2 steps of 32 clips, the validation batches),
   each fitted by one rank and by two gloo ranks (``data: 2``): the
   phrase- and word-wise sentence configs, the self-supervision config
   (teacher broadcast from rank 0) and both class-mapping configs (mixup
   and SpecAugment in the weak one; the weak one also at a global batch
   of 6, three clips a rank, so that the mixup pair (2, 3) spans the
   ranks: rank 0 holds two mixed rows, rank 1 one), held as (b) holds
   its fit but with
   ``MD_RUNNER_GRAD_LIMITS`` on the gradients, row 13 at half the rows on
   each rank; the word-wise run's ``evaluate`` and the weak run's
   ``evaluate_tagging`` on the two ranks against one rank (tracks and
   probabilities within 1e-4); two planted faults, the
   sentence model's text gathered with an own-rows backward and the mixed
   class-mapping outputs left ungathered, each rejected by the limits;
   the wrappers a rank holding no mixed row calls (rows 11-13, row 12's
   sums) at no rows: empty outputs, zero sums and gradients, no launch.
   Step ms of (a)-(c) and (f) by CUDA events, the requests' ms by the host
   clock;
20. remat: one train step at full width (32 clips x 10 s, cuDNN
   deterministic) of the f32 strong config and of bf16 routes (b) and (c),
   with the activations kept, recomputed in the backward for the whole
   forward (``trainer.remat``, the JAX ``jax.checkpoint``) and for the four
   conv blocks (``Cnn8Rnn(remat_blocks=[1, 2, 3, 4])``, the JAX
   ``TTG_TRAIN_REMAT=1234``), and kept once more: each step's loss and
   dropout generator's state equal to the step without remat, its
   gradients and running statistics bit for bit or within
   ``REMAT_REL_RMS`` (1e-6 relative RMS), its launches exact (the
   recompute reruns rows 1 and 13 / 14 under the whole forward and the
   blocks' pool kernels, rows 11 and 12, under either), its ms (CUDA
   events, 5 steps) and peak device memory; then ``StrongRunner.fit`` of
   the f32 config for 2 epochs of 3 steps under ``CosineWithWarmup`` at
   ``lr_update_interval: iteration``: every step's rate the schedule's
   (its formula written in this script), the epoch lines logging the last
   step's.

Then one JSON line with the kernels' numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero.  Without a CUDA device, or without the package beside this
file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}   # H100 SXM, dense
HBM = 3.35e12                                              # bytes / s
SR, CLIP_S = 32000, 10
KERNEL_CLIPS = 32                     # clips in the per-kernel phase
DEVICE = "cuda"


def _cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, ops: dict) -> tuple:
    """(least ms, what bounds it) for ``nbytes`` moved and ``ops`` = {type:
    operation count} at the card's published peaks."""
    t_bytes = nbytes / HBM
    t_ops = sum(n / PEAK[k] for k, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def _wbytes(w) -> int:
    """Bytes of a block's weights and BN affines as the wrapper takes them
    (f32)."""
    w1, (a1, b1), w2, (a2, b2) = w
    return 4 * sum(t.numel() for t in (w1, a1, b1, w2, a2, b2))


def _err(got, ref) -> tuple:
    import torch
    d = (got.float() - ref.float()).double()
    rel = torch.sqrt(torch.mean(d ** 2) / torch.mean(ref.double() ** 2))
    return float(d.abs().max()), float(rel)


def kernel_phase(clips: int, rng) -> list:
    """Each kernel against its plain version at the flagship's shapes."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.ops import frontend

    dev = torch.device(DEVICE)

    def tensor(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    def weights(cin, cout):
        he = np.sqrt(2.0 / (9 * cin))
        w1 = tensor(rng.normal(0, he, (3, 3, cin, cout)))
        w2 = tensor(rng.normal(0, np.sqrt(2.0 / (9 * cout)),
                               (3, 3, cout, cout)))
        ab = [(tensor(rng.uniform(0.5, 1.5, cout)),
               tensor(rng.normal(0, 0.1, cout))) for _ in range(2)]
        return w1, ab[0], w2, ab[1]

    n = SR * CLIP_S
    t1 = n // 320 + 1                                 # 1001 frames
    cfg = frontend.cnn8rnn_mel_config(SR)
    rows = []

    # ---- rows 1 (log-mel) and 2 (block 1) in their second designs
    # (csrc/logmel_v2.cu, csrc/conv_block1_v2.cu), held to the plain
    # versions and beside the first designs, timed in turns and traced by
    # launch, with a PyTorch chain as a yardstick
    wave = tensor(rng.normal(0, 0.1, (clips, n)))
    rows.append(_logmel_row(wave, cfg, clips, t1))
    x1 = tensor(rng.normal(0, 1, (clips, t1, 64)), torch.bfloat16)
    rows.append(_block1_row(x1, weights(1, 64), clips, t1))

    # ---- blocks 2-4 in the second design (csrc/conv_block_v2.cu), held
    # bit for bit to the plain version and the first design, timed beside
    # the first in turns and traced by launch, int8 and bf16
    rows += redesigned_rows(clips, rng, tensor, weights, t1 // 2)

    out = []
    for row in rows:
        max_abs, rel = _err(row["got"], row["ref"])
        kind, tol = row["tol"]
        ok = (max_abs if kind != "rel_rms" else rel) <= tol
        if not ok:
            raise AssertionError(f"{row['name']}: kernel disagrees with its "
                                 f"plain version: max_abs {max_abs} "
                                 f"rel_rms {rel} > {kind} {tol}")
        bf16_rel = None
        if "bf16" in row:      # the bf16 mode, off the int8 serving path
            bf16_rel = _err(*row["bf16"]())[1]
            if bf16_rel > 1e-2:
                raise AssertionError(f"{row['name']} (bf16): kernel "
                                     f"disagrees with its plain version: "
                                     f"rel_rms {bf16_rel} > 0.01")
        extra = row["designs"]() if "designs" in row else {}
        kernel_ms = extra.get("ms") or _cuda_ms(row["kernel"], 10)
        plain_ms = _cuda_ms(row["plain"], 3)
        out.append({
            "name": row["name"], "route": "cuda", "source": row["source"],
            "replaces": row["replaces"], "max_abs_err": max_abs,
            "rel_rms_err": rel, "tolerance": f"{kind} <= {tol}",
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": None, "clips": clips,
            "bf16_mode_rel_rms_err": bf16_rel, **extra})
    return out


def _logmel_ops(cfg, frames: int) -> tuple:
    """(DFT, power, mel) operations that the log-mel needs on ``frames``
    frames: the DFT's re and im products over K = n_fft for the bins that
    some mel filter weights, their power, and each mel's products over its
    nonzero filter weights only (``logmel.mel_bands``)."""
    import numpy as np

    from texttoaudiogrounding_tpu_torch.ops.kernels import logmel
    fb = logmel._trimmed_basis(cfg)[2]
    bins = int(np.count_nonzero(fb.any(axis=1)))
    nnz = logmel.mel_bands(fb)[1].size
    return (2.0 * frames * cfg.n_fft * 2 * bins, 3.0 * frames * bins,
            2.0 * frames * nnz)


def _logmel_chain(cfg, device):
    """The log-mel as a PyTorch chain in f32: ``torch.stft`` (cuFFT, the
    reflect-padded Hann frames) → power → ``@`` the slaney filterbank →
    dB; a yardstick that the port never calls."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops import frontend
    win = torch.from_numpy(frontend._padded_window(cfg)).to(
        device, torch.float32)
    fb = torch.from_numpy(frontend.mel_filterbank(cfg)).to(device)

    def chain(wave):
        spec = torch.stft(wave, cfg.n_fft, cfg.hop_length, cfg.win_length,
                          window=win, center=True, pad_mode="reflect",
                          return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2          # [B, F, T]
        mel = torch.matmul(power.transpose(1, 2), fb)
        return 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin))
    return chain


def _logmel_row(wave, cfg, clips: int, t1: int) -> dict:
    """Row 1 on its second design, within 2e-3 dB of its plain version;
    both designs timed in turns (v1 v2 v2 v1) and traced by launch, each
    one's gap to the f64 log-mel, and the ``torch.stft`` chain beside."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import logmel

    v2 = lambda: logmel.fused_log_mel_spectrogram(wave, cfg)  # noqa: E731
    v1 = lambda: logmel._fused_log_mel_spectrogram_v1(wave, cfg)  # noqa: E731
    got = v2()
    dft, power, mel = _logmel_ops(cfg, clips * t1)
    ops = {"bf16": dft, "f32": power + mel}
    chain = _logmel_chain(cfg, wave.device)

    def designs():
        f64 = _log_mel_f64(wave, cfg)
        first = v1()
        turns = _turns({"v1": v1, "v2": v2})
        return {"ms": turns["v2"], "v1_ms": turns["v1"],
                "turns_ms": turns["runs"],
                "v1_max_abs_err": _err(got, first)[0],
                "max_abs_vs_f64": _err(got, f64)[0],
                "v1_max_abs_vs_f64": _err(first, f64)[0],
                "chain_ms": _cuda_ms(lambda: chain(wave), 10),
                "chain_max_abs_vs_f64": _err(chain(wave), f64)[0],
                "chain": "torch.stft (cuFFT) -> power -> @ fb -> dB, f32",
                "v1_source": "texttoaudiogrounding_tpu_torch/csrc/logmel.cu",
                "v2_trace": _trace(v2, turns["v2"], by_launch=True),
                "v1_trace": _trace(v1, turns["v1"], by_launch=True)}

    return dict(
        name="logmel",
        source="texttoaudiogrounding_tpu_torch/csrc/logmel_v2.cu",
        replaces="texttoaudiogrounding_tpu/ops/pallas/logmel.py:438",
        got=got, ref=logmel.log_mel_plain(wave, cfg),
        tol=("max_abs_db", 2e-3), kernel=v2,
        plain=lambda: logmel.log_mel_plain(wave, cfg), designs=designs,
        bound=_bound(wave.numel() * 4 + got.numel() * 4, ops))


def _block1_chain(w):
    """Block 1's bf16 mode as a PyTorch chain: cuDNN bf16 ``F.conv2d``,
    the BN affine and ReLU, again, then ``avg_pool2d + max_pool2d``; a
    yardstick that the port never calls."""
    import torch
    import torch.nn.functional as F
    w1, (a1, b1), w2, (a2, b2) = w
    k1 = w1.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
    k2 = w2.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
    aff = [(a.to(torch.bfloat16)[:, None, None], b.to(torch.bfloat16)[
        :, None, None]) for a, b in ((a1, b1), (a2, b2))]

    def chain(x):
        y = F.conv2d(x[:, None], k1, padding=1)
        y = torch.relu(y * aff[0][0] + aff[0][1])
        y = F.conv2d(y, k2, padding=1)
        y = torch.relu(y * aff[1][0] + aff[1][1])
        return F.avg_pool2d(y, 2) + F.max_pool2d(y, 2)
    return chain


def _block1_row(x1, w, clips: int, t1: int) -> dict:
    """Row 2 on its second design in the served ``"conv1"`` mode (within
    1e-2 relative RMS of its plain version, the gap to the first design
    reported), ``False`` likewise, ``True`` and ``single`` bit for bit to
    the plain version and the first design; both designs timed in turns in
    every mode with the weights laid out once, traced by launch in
    ``"conv1"`` and ``True``, and the cuDNN bf16 chain beside."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block1_pair

    modes = {"conv1": ("conv1", "triple"), "bf16": (False, "triple"),
             "int8": (True, "triple"), "single": (True, "single")}
    prep = {q: conv_block1_pair.kernel_weights(*w, q)
            for q in ("conv1", False, True)}

    def fn(design, key):
        q, mode = modes[key]
        run = (conv_block1_pair.fused_block1_pair if design == "v2"
               else conv_block1_pair._fused_block1_pair_v1)
        return lambda: run(x1, *w, quantize=q, mode=mode, prepared=prep[q])

    got = fn("v2", "conv1")()
    ops = {"int8": 2.0 * clips * t1 * 64 * 9 * 64,
           "bf16": 2.0 * clips * (t1 // 2 * 2) * 64 * 576 * 64}
    chain = _block1_chain(w)

    def designs():
        out = {}
        for key, (q, mode) in modes.items():
            g2, g1 = fn("v2", key)(), fn("v1", key)()
            plain = conv_block1_pair.block1_plain(x1, *w, quantize=q,
                                                  mode=mode)
            if q is True and (_err(g2, plain)[0] or _err(g2, g1)[0]):
                raise AssertionError(f"conv_block1_pair {key}: the second "
                                     f"design differs from the plain "
                                     f"version or the first: "
                                     f"{_err(g2, plain)}, {_err(g2, g1)}")
            rel = _err(g2, plain)[1]
            if rel > 1e-2:
                raise AssertionError(f"conv_block1_pair {key}: rel_rms "
                                     f"{rel} to its plain version > 0.01")
            turns = _turns({"v1": fn("v1", key), "v2": fn("v2", key)})
            out[key] = {"ms": turns["v2"], "v1_ms": turns["v1"],
                        "turns_ms": turns["runs"],
                        "max_abs_err": _err(g2, plain)[0],
                        "rel_rms_err": rel,
                        "v1_max_abs_err": _err(g2, g1)[0],
                        "v1_rel_rms_err": _err(g2, g1)[1]}
            if key in ("conv1", "int8"):
                for d in ("v2", "v1"):
                    out[key][f"{d}_trace"] = _trace(fn(d, key), turns[d],
                                                    by_launch=True)
        c16 = chain(x1)
        return {"ms": out["conv1"]["ms"], "v1_ms": out["conv1"]["v1_ms"],
                "modes": out,
                "chain_ms": _cuda_ms(lambda: chain(x1), 10),
                "chain_rel_rms_vs_bf16_plain": _err(
                    c16.permute(0, 2, 3, 1), conv_block1_pair.block1_plain(
                        x1, *w, quantize=False))[1],
                "chain": "cuDNN bf16 F.conv2d -> affine -> ReLU, twice -> "
                         "avg_pool2d + max_pool2d",
                "v1_source": "texttoaudiogrounding_tpu_torch/csrc/"
                             "conv_block1_pair.cu"}

    return dict(
        name="conv_block1_pair",
        source="texttoaudiogrounding_tpu_torch/csrc/conv_block1_v2.cu",
        replaces="texttoaudiogrounding_tpu/ops/pallas/conv_block1_pair.py:346",
        got=got, ref=conv_block1_pair.block1_plain(x1, *w, quantize="conv1"),
        tol=("rel_rms", 1e-2), kernel=fn("v2", "conv1"),
        plain=lambda: conv_block1_pair.block1_plain(x1, *w),
        bf16=lambda: (fn("v2", "bf16")(), conv_block1_pair.block1_plain(
            x1, *w, quantize=False)),
        designs=designs,
        bound=_bound(x1.numel() * 2 + got.numel() * 2 + _wbytes(w), ops))


def _turns(fns: dict, order=("v1", "v2")) -> dict:
    """ms per call of designs {"v1": fn, "v2": fn, ...} timed in turns
    (order, then order reversed: v1 v2 v2 v1; 10 calls each): the mean of
    each design's two runs and all of them."""
    runs = [(k, _cuda_ms(fns[k], 10)) for k in order + order[::-1]]
    return {k: sum(ms for n, ms in runs if n == k) / 2 for k in fns} | {
        "runs": runs}


def redesigned_rows(clips: int, rng, tensor, weights, t2: int) -> list:
    """Rows 3 (block 2) and 4 (blocks 3 and 4) at the served shapes, on the
    second design: int8 held to the plain version and to the first design
    with max |d| = 0, bf16 to the plain version within 1e-2 relative RMS;
    both designs timed in turns (v1 v2 v2 v1) in int8 and bf16 and traced
    by launch, each with its weights laid out once, as the model keeps
    them."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        conv_block, conv_block_pair)

    def block(x, w, pool, pair):
        # (v2, v1, plain, tc) for int8 (q True) and bf16
        out = {}
        for q in (True, False):
            wk = conv_block.kernel_weights(*w, q)
            if pair:
                tc = conv_block_pair.pick_tc_pair(x.shape[1],
                                                  x.shape[2] // 2,
                                                  wk[0].shape[0], q)
                out[q] = (lambda x=x, wk=wk, q=q, tc=tc:
                          conv_block_pair.fused_block2_pair(
                              x, *w, quantize=q, tc=tc, prepared=wk),
                          lambda x=x, wk=wk, q=q, tc=tc:
                          conv_block_pair._launch_v1(x, wk, q, tc),
                          lambda x=x, q=q, tc=tc:
                          conv_block_pair.block2_plain(x, *w, quantize=q,
                                                       tc=tc), tc)
            else:
                tc = conv_block.pick_tc(x.shape[1], x.shape[2], x.shape[3],
                                        wk[0].shape[0], *pool, q)
                out[q] = (lambda x=x, wk=wk, q=q, tc=tc:
                          conv_block.fused_double_conv_pool(
                              x, *w, pool, quantize=q, tc=tc, prepared=wk),
                          lambda x=x, wk=wk, q=q, tc=tc:
                          conv_block._fused_double_conv_pool_v1(
                              x, *w, pool, quantize=q, tc=tc, prepared=wk),
                          lambda x=x, q=q, tc=tc:
                          conv_block.double_conv_plain(
                              x, *w, pool, quantize=q, tc=tc), tc)
        return out

    # block 2: [B, 500, 32, 64] -> [B, 250, 16, 128]
    x2 = tensor(np.abs(rng.normal(0, 1, (clips, t2, 32, 64))),
                torch.bfloat16)
    w2 = weights(64, 128)
    pos = clips * t2 * 32
    specs = [("conv_block_pair", "conv_block_pair.py:211", [
        (x2, w2, (2, 2), True,
         {"int8": 2.0 * pos * 576 * 128 + 2.0 * pos * 1152 * 128})])]
    # blocks 3 and 4: one kernel, two launches per forward
    t3, parts = t2 // 2, []
    for m, cin, cout in ((16, 128, 256), (8, 256, 512)):
        x = tensor(np.abs(rng.normal(0, 1, (clips, t3, m, cin))),
                   torch.bfloat16)
        pos = clips * t3 * m
        parts.append((x, weights(cin, cout), (1, 2), False,
                      {"int8": 2.0 * pos * 9 * (cin * cout + cout * cout)}))
    specs.append(("conv_block", "conv_block.py:370", parts))

    rows = []
    for name, replaces, blocks in specs:
        fns = [block(*b[:4]) for b in blocks]

        def each(q, k, fns=fns):
            return lambda: [f[q][k]() for f in fns]

        got = [f[True][0]() for f in fns]
        ref = [f[True][2]() for f in fns]
        v1 = [f[True][1]() for f in fns]
        vs_v1 = max(_err(g, r)[0] for g, r in zip(got, v1))
        if vs_v1 != 0.0:
            raise AssertionError(f"{name}: the second design differs from "
                                 f"the first: max_abs {vs_v1}")
        bound = [_bound(b[0].numel() * 2 + g.numel() * 2 + _wbytes(b[1]),
                        b[4]) for b, g in zip(blocks, got)]

        def both_designs(fns=fns, name=name, vs_v1=vs_v1):
            t8 = _turns({"v1": each(True, 1, fns), "v2": each(True, 0, fns)})
            t16 = _turns({"v1": each(False, 1, fns),
                          "v2": each(False, 0, fns)})
            g16 = [f[False][0]() for f in fns]
            r16 = [f[False][1]() for f in fns]
            traces = {f"{d}_{k}_trace": _trace(each(q, i, fns), tm[d],
                                                by_launch=True)
                      for q, k, tm in ((True, "int8", t8),
                                       (False, "bf16", t16))
                      for d, i in (("v2", 0), ("v1", 1))}
            return {"ms": t8["v2"], "v1_ms": t8["v1"], "turns_ms": t8["runs"],
                    "bf16_ms": t16["v2"], "v1_bf16_ms": t16["v1"],
                    "bf16_turns_ms": t16["runs"],
                    "v1_max_abs_err": vs_v1,
                    "bf16_v1_rel_rms": max(_err(g, r)[1]
                                           for g, r in zip(g16, r16)),
                    "tc": [f[True][3] for f in fns],
                    "bf16_tc": [f[False][3] for f in fns],
                    "v1_source": "texttoaudiogrounding_tpu_torch/csrc/"
                                 + ("conv_block_pair.cu"
                                    if name == "conv_block_pair"
                                    else "conv_block.cu"),
                    **traces}

        rows.append(dict(
            name=name,
            source="texttoaudiogrounding_tpu_torch/csrc/conv_block_v2.cu",
            replaces=f"texttoaudiogrounding_tpu/ops/pallas/{replaces}",
            got=torch.cat([g.reshape(-1) for g in got]),
            ref=torch.cat([r.reshape(-1) for r in ref]),
            tol=("max_abs", 0.0), kernel=each(True, 0), plain=each(True, 2),
            bf16=lambda fns=fns: (
                torch.cat([f[False][0]().reshape(-1) for f in fns]),
                torch.cat([f[False][2]().reshape(-1) for f in fns])),
            designs=both_designs,
            bound=(sum(b[0] for b in bound), bound[-1][1])))
    return rows


GRU_T, GRU_H, GRU_IN = 250, 256, 512     # the BiGRU at the main path's shapes
# The bf16-operand backward against its plain version, by relative RMS of
# each gradient (dproj, dwh, dbn), on an H100 80GB HBM3 at 700 W: at most
# 8.8e-4 at T = 250, where a dcol summed in another f32 order rounds to
# the other bf16 neighbour and the walk carries it on, and the f32
# backward lies about as far off (1e-3).  So the bf16 roundings are held
# at T = 2: there one such flip reads 2.5e-6 / 1.6e-5 / 2.4e-6, and the
# same backward without its roundings of h_{t-1} and dcol (the f32
# backward given the bf16-rounded Wh) 3.7e-4 / 2.4e-3 / 3.6e-4, which
# must miss the tolerance by GRU_B16_MISS times in the same run.
GRU_B16_TOL, GRU_B16_SHORT_TOL, GRU_B16_MISS = 2e-3, (2e-5, 1e-4, 2e-5), 10


def _max_err(got, ref) -> tuple:
    """(max abs, max relative RMS) over the tensors of ``got``."""
    import torch
    if isinstance(got, torch.Tensor):
        return _err(got, ref)
    errs = [_err(a, b) for a, b in zip(got, ref)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def _gru_bf16_short(proj, gy, wh, bn) -> dict:
    """The bf16-operand backward at T = 2 (the first two steps of the main
    path's inputs), per gradient against its plain version, beside the
    unrounded backward's gap, which must be GRU_B16_MISS times the
    tolerance."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    b16 = torch.bfloat16
    proj2, gy2 = proj[:2].contiguous(), gy[:2].contiguous()
    ys2 = gru.gru_forward_plain(proj2, wh, bn, b16)
    ref = gru.gru_backward_plain(proj2, ys2, gy2, wh, bn, b16)
    got = gru.gru_backward(proj2, ys2, gy2, wh, bn, b16)
    unrounded = gru.gru_backward(proj2, ys2, gy2, wh.to(b16).float(), bn)
    rel = [_err(a, r)[1] for a, r in zip(got, ref)]
    miss = [_err(a, r)[1] for a, r in zip(unrounded, ref)]
    if any(e > tol or m < GRU_B16_MISS * tol
           for e, m, tol in zip(rel, miss, GRU_B16_SHORT_TOL)):
        raise AssertionError(
            f"gru_bwd_bf16 at T = 2: rel_rms (dproj, dwh, dbn) {rel} "
            f"(limits {GRU_B16_SHORT_TOL}); without the bf16 roundings "
            f"{miss} (must reach {GRU_B16_MISS} times the limits)")
    return {"T": 2, "rel_rms_err": rel, "tolerance": GRU_B16_SHORT_TOL,
            "unrounded_rel_rms": miss}


# the cluster design's plan that cluster_plan does not take: groups of 8
# rows (2 x 4 clusters at B = 32, more than the 7 of 16 CTAs an H100 holds
# at once), timed beside the plan it takes
GRU_ROWS_ALT = 8


def _gru_cluster_rows(proj, ys, gy, wh, bn, dtype, rows: int):
    """A call of the cluster backward with groups of ``rows`` rows, in
    place of ``cluster_plan``'s, through its C entry point."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import _build, gru

    t, b2, h = ys.shape
    plan = gru.cluster_plan(b2 // 2, h, dtype)
    groups = -(-(b2 // 2) // rows)
    b16 = dtype == torch.bfloat16
    whk = wh.to(dtype).float() if b16 else wh
    n = 2 * h * 3 * h + 2 * h
    dproj = torch.empty_like(proj)
    out = torch.empty(n, device=proj.device)
    part = torch.empty(groups, n, device=proj.device)
    fn = _build.function("gru_bwd_sm90", "ttg_gru_bwd_cluster",
                         [_build.P] * 8 + [_build.I] * 7 + [_build.P])

    def call():
        _build.check(fn(proj.data_ptr(), ys.data_ptr(), gy.data_ptr(),
                        whk.data_ptr(), bn.data_ptr(), dproj.data_ptr(),
                        out.data_ptr(), part.data_ptr(), t, b2 // 2, h,
                        plan["ctas"], groups, rows, int(b16),
                        _build.stream(proj)), "ttg_gru_bwd_cluster")
        return (dproj, out[:n - 2 * h].view(2, h, 3 * h),
                out[n - 2 * h:].view(2, h))
    return call, groups


def _launches_per_call(fn) -> int:
    """The CUDA launches of one traced call of ``fn``, of any kernel,
    counted by the profiler."""
    return _trace(fn, 1.0, by_launch=True)["launches"]


def _gru_designs(proj, ys, gy, wh, bn, dtype, tiny) -> dict:
    """The backward's two designs at the main path's inputs: the first
    design's gradients and those of the cluster design with groups of
    GRU_ROWS_ALT rows (to hold the chosen plan to), the three timed in
    turns (per_step, cluster, rows_alt, rows_alt, cluster, per_step; 10
    calls each), each design's latency floor (the same walk at B = 1, H =
    4: ``tiny`` = (proj, ys, gy, wh, bn)), the cluster plan and how many
    of its clusters the card holds at once, and each design's CUDA
    launches a call."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    def call(design, args=(proj, ys, gy, wh, bn)):
        return lambda: gru.gru_backward(*args, dtype, design=design)

    alt, alt_groups = _gru_cluster_rows(proj, ys, gy, wh, bn, dtype,
                                        GRU_ROWS_ALT)
    fns = {"per_step": call("per_step"), "cluster": call("cluster"),
           "rows_alt": alt}
    order = ("per_step", "cluster", "rows_alt")
    runs = [(d, _cuda_ms(fns[d], 10)) for d in order + order[::-1]]
    t, b2, h = ys.shape
    plan = gru.cluster_plan(b2 // 2, h, dtype)
    return {"per_step": call("per_step")(), "rows_alt_grads": alt(),
            "ms": {d: sum(ms for n, ms in runs if n == d) / 2
                   for d in order},
            "turns_ms": runs,
            "launches_per_call": {d: _launches_per_call(call(d))
                                  for d in gru.DESIGNS},
            "floor_ms": {d: _cuda_ms(call(d, tiny), 10)
                         for d in gru.DESIGNS},
            "plan": plan,
            "co_resident_clusters": gru.cluster_occupancy(h, plan, dtype),
            "clusters": 2 * plan["groups"],
            "rows_alt": {"rows": GRU_ROWS_ALT, "clusters": 2 * alt_groups}}


# batch rows a direction at which the forward's two designs are also held
# to their plain versions, to each other and to torch.nn.GRU: a ragged B
# whose groups differ in size, and the bench's B = 128, which runs the
# cluster design in waves
GRU_FWD_EXTRA_B = (13, 128)


def _gru_fwd_designs(proj, wh, bn, dtype, tiny) -> dict:
    """The forward's two designs at the main path's inputs: the first
    design's outputs, both timed in turns (per_step, cluster, cluster,
    per_step; 10 calls each), each design's latency floor (the same walk
    at B = 1, H = 4: ``tiny`` = (proj, wh, bn)), the cluster design's
    exchange floor (B = 1 at the main path's H, where 16 CTAs exchange
    their slices of h_t each step around almost no arithmetic), the
    cluster plan and how many of its clusters the card holds at once, and
    each design's CUDA launches a call."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    def call(design, args=(proj, wh, bn)):
        return lambda: gru.gru_forward(*args, dtype, design=design)

    order = ("per_step", "cluster")
    runs = [(d, _cuda_ms(call(d), 10)) for d in order + order[::-1]]
    t, b2, h3 = proj.shape
    plan = gru.forward_plan(b2 // 2, h3 // 3, dtype)
    one_row = (proj[:, ::b2 // 2].contiguous(), wh, bn)      # row 0 of each
    return {"per_step": call("per_step")(),
            "exchange_floor_ms": _cuda_ms(call("cluster", one_row), 10),
            "ms": {d: sum(ms for n, ms in runs if n == d) / 2
                   for d in order},
            "turns_ms": runs,
            "launches_per_call": {d: _launches_per_call(call(d))
                                  for d in gru.DESIGNS},
            "floor_ms": {d: _cuda_ms(call(d, tiny), 10)
                         for d in gru.DESIGNS},
            "plan": plan,
            "co_resident_clusters": gru.cluster_occupancy(
                h3 // 3, plan, dtype, forward=True),
            "clusters": 2 * plan["groups"]}


# The forward's first GRU_FWD_SHORT_T steps, where a sum in another order
# moves ys by about 5e-8: both carries are held to GRU_FWD_SHORT_TOL of
# their plain versions, and the f32 carry (on Wh rounded to bf16, and on
# Wh as it is) must miss the bf16 carry's plain version by
# GRU_FWD_B16_MISS times that limit in the same run, so that a bf16
# forward that rounds no carry fails.  Also at shapes with an odd number
# of units a CTA (GRU_FWD_ODD, B = 5 at H = 30 and 120: 2 and 8 CTAs of
# 15), where the bf16 carry's mma.sync epilogue holds a lone last column.
GRU_FWD_SHORT_T, GRU_FWD_SHORT_TOL, GRU_FWD_B16_MISS = 2, 1e-5, 10
GRU_FWD_ODD = ((5, 30), (5, 120))


def _gru_fwd_short(proj, wh, bn) -> dict:
    """The forward of both carries at the first GRU_FWD_SHORT_T steps of
    ``proj`` against their plain versions, beside the f32 carry's gap to
    the bf16 carry's plain version."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    b16 = torch.bfloat16
    p = proj[:GRU_FWD_SHORT_T].contiguous()
    ref16 = gru.gru_forward_plain(p, wh, bn, b16)
    rel = {"f32": _err(gru.gru_forward(p, wh, bn),
                       gru.gru_forward_plain(p, wh, bn))[1],
           "bf16": _err(gru.gru_forward(p, wh, bn, b16), ref16)[1]}
    miss = {"f32_carry_bf16_wh": _err(gru.gru_forward(
                p, wh.to(b16).float(), bn), ref16)[1],
            "f32_carry": _err(gru.gru_forward(p, wh, bn), ref16)[1]}
    if (max(rel.values()) > GRU_FWD_SHORT_TOL
            or min(miss.values()) < GRU_FWD_B16_MISS * GRU_FWD_SHORT_TOL):
        raise AssertionError(
            f"gru_fwd at T = {GRU_FWD_SHORT_T}, rows {proj.shape[1]}, H = "
            f"{wh.shape[1]}: rel_rms {rel} (limit {GRU_FWD_SHORT_TOL}); the "
            f"f32 carry off the bf16 carry's plain version by {miss} (must "
            f"reach {GRU_FWD_B16_MISS} times the limit)")
    return {"T": GRU_FWD_SHORT_T, "rel_rms_err": rel,
            "tolerance": GRU_FWD_SHORT_TOL,
            "f32_carry_rel_rms_vs_bf16_plain": miss}


def _gru_fwd_odd(b: int, h: int, rng) -> dict:
    """The cluster forward at ``b`` rows a direction of ``h`` units, an
    odd number a CTA: each carry against its plain version over GRU_T
    steps (1e-4 / 1e-2) and over the first GRU_FWD_SHORT_T."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    def tensor(shape, std):
        return torch.from_numpy(rng.normal(0, std, shape).astype(
            np.float32)).to(DEVICE)

    proj = tensor((GRU_T, 2 * b, 3 * h), 1.0)
    wh = tensor((2, h, 3 * h), 1 / np.sqrt(h))
    bn = tensor((2, h), 0.05)
    plan = gru.forward_plan(b, h)
    if plan["units"] % 2 == 0:
        raise AssertionError(f"GRU_FWD_ODD: B = {b}, H = {h} gives "
                             f"{plan['units']} units a CTA, not odd")
    out = {"B": b, "H": h, "plan": plan,
           "short_T": _gru_fwd_short(proj, wh, bn)}
    for dtype, key, tol in ((torch.float32, "gru_fwd", 1e-4),
                            (torch.bfloat16, "gru_fwd_bf16", 1e-2)):
        err = _err(gru.gru_forward(proj, wh, bn, dtype),
                   gru.gru_forward_plain(proj, wh, bn, dtype))
        if err[1] > tol:
            raise AssertionError(f"{key} at B = {b}, H = {h}: rel_rms "
                                 f"{err[1]} > {tol}")
        out[key] = {"rel_rms_err": err[1], "max_abs_err": err[0]}
    return out


def _gru_fwd_extra(project, lib, as_batch_first, wh, bn, b: int,
                   rng) -> dict:
    """Both forward designs at ``b`` rows a direction, each carry against
    its plain version (1e-4 / 1e-2) and the first design, the f32 carry also
    against ``torch.nn.GRU`` (1e-3 max abs), with each design's ms."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    x = torch.from_numpy(rng.normal(0, 1, (b, GRU_T, GRU_IN)).astype(
        "float32")).to(wh.device)
    proj = project(x)
    with torch.no_grad():
        lib_out, _ = lib(x)
    out = {"B": b}
    for dtype, key, tol in ((torch.float32, "gru_fwd", 1e-4),
                            (torch.bfloat16, "gru_fwd_bf16", 1e-2)):
        ys = gru.gru_forward(proj, wh, bn, dtype)
        first = gru.gru_forward(proj, wh, bn, dtype, design="per_step")
        errs = [_err(ys, gru.gru_forward_plain(proj, wh, bn, dtype)),
                _err(ys, first),
                _err(first, gru.gru_forward_plain(proj, wh, bn, dtype))]
        if max(e[1] for e in errs) > tol:
            raise AssertionError(
                f"{key} at B = {b}: rel_rms (cluster vs plain, vs first "
                f"design, first vs plain) {[e[1] for e in errs]} > {tol}")
        rec = {"rel_rms_err": errs[0][1], "max_abs_err": errs[0][0],
               "vs_per_step_rel_rms": errs[1][1],
               "plan": gru.forward_plan(b, GRU_H, dtype),
               "ms": _cuda_ms(lambda: gru.gru_forward(proj, wh, bn, dtype),
                              10),
               "per_step_ms": _cuda_ms(lambda: gru.gru_forward(
                   proj, wh, bn, dtype, design="per_step"), 10)}
        if dtype == torch.float32:
            gap = float((as_batch_first(ys, b) - lib_out).abs().max())
            if gap > 1e-3:
                raise AssertionError(f"{key} at B = {b}: off torch.nn.GRU "
                                     f"by {gap}")
            rec["library_max_abs_diff"] = gap
        out[key] = rec
    return out


# The hoisted walks (row 16) are also held to their plain versions at a
# ragged B, at odd units a CTA and over their first GRU_WALK_SHORT_T steps
# (where another order of summation moves them by about 1e-7)
GRU_WALK_SHAPES = ((13, 256), (5, 30), (5, 120))
GRU_WALK_SHORT_T, GRU_WALK_SHORT_TOL = 2, 1e-5


def _gru_walk_designs(proj, ys, gy, wh, bn, variant, tiny) -> dict:
    """The hoisted walk ``variant``'s two designs at the main path's
    inputs: the outputs of both and of the plain walk, both timed in turns
    (per_step, cluster, cluster, per_step; 10 calls each) and the dWh
    product after the walk apart, the whole backward of each design, each
    design's latency floor (the walk at B = 1, H = 4: ``tiny`` = (proj,
    ys, gy, wh, bn)), the cluster walk's exchange floor (B = 1 at the main
    path's H), the plan and how many of its clusters the card holds at
    once, and each design's CUDA launches a walk."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    def call(design, args=(proj, ys, gy, wh, bn)):
        return lambda: gru.gru_walk(*args, variant, design)

    order = ("per_step", "cluster")
    runs = [(d, _cuda_ms(call(d), 10)) for d in order + order[::-1]]
    got = call("cluster")()
    t, b2, h = ys.shape
    plan = gru.walk_plan(b2 // 2, h)
    one_row = tuple(x[:, ::b2 // 2].contiguous() for x in (proj, ys, gy))
    launches = {d: _launches_per_call(call(d)) for d in gru.DESIGNS}
    if launches["cluster"] != 1:
        raise AssertionError(f"gru_bwd_{variant}: the cluster walk made "
                             f"{launches['cluster']} CUDA launches, not 1")
    return {"got": got, "per_step": call("per_step")(),
            "plain": gru.gru_walk_plain(proj, ys, gy, wh, bn,
                                        variant == "v3"),
            "ms": {d: sum(ms for n, ms in runs if n == d) / 2
                   for d in order},
            "turns_ms": runs,
            "dwh_product_ms": _cuda_ms(
                lambda: gru.hoisted_weight_grads(ys, *got), 10),
            "whole_ms": {d: _cuda_ms(lambda d=d: gru.gru_backward_hoisted(
                proj, ys, gy, wh, bn, variant, d), 10) for d in gru.DESIGNS},
            "floor_ms": {d: _cuda_ms(call(d, tiny), 10) for d in gru.DESIGNS},
            "exchange_floor_ms": _cuda_ms(call("cluster", one_row + (wh, bn)),
                                          10),
            "launches_per_call": launches, "plan": plan,
            "co_resident_clusters": gru.cluster_occupancy(
                h, plan, torch.float32, variant=variant),
            "clusters": 2 * plan["groups"]}


def _gru_walk_short(proj, ys, gy, wh, bn, variant) -> dict:
    """The cluster walk over the first GRU_WALK_SHORT_T steps of its inputs
    against the plain walk, within GRU_WALK_SHORT_TOL."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    args = tuple(x[:GRU_WALK_SHORT_T].contiguous() for x in (proj, ys, gy))
    err = _max_err(gru.gru_walk(*args, wh, bn, variant),
                   gru.gru_walk_plain(*args, wh, bn, variant == "v3"))
    if err[1] > GRU_WALK_SHORT_TOL:
        raise AssertionError(
            f"gru_bwd_{variant} walk at T = {GRU_WALK_SHORT_T}, rows "
            f"{proj.shape[1]}, H = {wh.shape[1]}: rel_rms {err[1]} > "
            f"{GRU_WALK_SHORT_TOL}")
    return {"T": GRU_WALK_SHORT_T, "rel_rms_err": err[1],
            "max_abs_err": err[0], "tolerance": GRU_WALK_SHORT_TOL}


def _gru_walk_shapes(rng) -> list:
    """Both hoisted walks at GRU_WALK_SHAPES (B, H) over GRU_T steps
    against their plain versions (1e-4) and, where H suits it, their first
    design, and over the first GRU_WALK_SHORT_T steps (1e-5)."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    def tensor(shape, std):
        return torch.from_numpy(rng.normal(0, std, shape).astype(
            np.float32)).to(DEVICE)

    out = []
    for b, h in GRU_WALK_SHAPES:
        proj = tensor((GRU_T, 2 * b, 3 * h), 1.0)
        wh = tensor((2, h, 3 * h), 1 / np.sqrt(h))
        bn = tensor((2, h), 0.05)
        gy = tensor((GRU_T, 2 * b, h), 1.0)
        ys = gru.gru_forward_plain(proj, wh, bn)
        rec = {"B": b, "H": h, "plan": gru.walk_plan(b, h)}
        for v in gru.VARIANTS:
            got = gru.gru_walk(proj, ys, gy, wh, bn, v)
            errs = {"plain": _max_err(got, gru.gru_walk_plain(
                proj, ys, gy, wh, bn, v == "v3"))}
            if h % 4 == 0:                   # the first design's JT = 4
                errs["per_step"] = _max_err(got, gru.gru_walk(
                    proj, ys, gy, wh, bn, v, "per_step"))
            if max(e[1] for e in errs.values()) > 1e-4:
                raise AssertionError(f"gru_bwd_{v} walk at B = {b}, H = {h}: "
                                     f"rel_rms {errs} > 1e-4")
            rec[v] = {"rel_rms_err": errs["plain"][1],
                      "max_abs_err": errs["plain"][0],
                      "vs_per_step_rel_rms": errs.get("per_step",
                                                      (None, None))[1],
                      "short_T": _gru_walk_short(proj, ys, gy, wh, bn, v)}
        out.append(rec)
    return out


def _gru_inputs(rng, t: int, b: int, h: int, d: int) -> tuple:
    """A BiGRU's inputs on the card, drawn from ``rng``: ``x [B, T, In]``,
    the output gradient ``gy [T, 2B, H]``, ``project`` (x → the kernels'
    ``proj``), ``proj``, ``wh``, ``bn`` in the port's layout
    (``models/layers.py`` BiGRU: time-major, direction 1 time-flipped, the
    r/z recurrent biases folded into the input ones), and ``torch.nn.GRU``
    on the same weights."""
    import numpy as np
    import torch

    dev = torch.device(DEVICE)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    x = tensor(rng.normal(0, 1, (b, t, d)))
    w_ih = tensor(rng.normal(0, 1 / np.sqrt(d), (2, 3 * h, d)))
    w_hh = tensor(rng.normal(0, 1 / np.sqrt(h), (2, 3 * h, h)))
    b_ih = tensor(rng.normal(0, 0.05, (2, 3 * h)))
    b_hh = tensor(rng.normal(0, 0.05, (2, 3 * h)))
    gy = tensor(rng.normal(0, 1, (t, 2 * b, h)))
    bi = b_ih + torch.cat([b_hh[:, :2 * h], torch.zeros_like(b_hh[:, :h])],
                          dim=1)

    def project(x):
        xg = torch.stack([x, torch.flip(x, dims=(1,))])
        return (torch.matmul(xg, w_ih.transpose(1, 2)[:, None])
                + bi[:, None, None]).permute(2, 0, 1, 3).reshape(
                    t, 2 * x.shape[0], 3 * h).contiguous()

    lib = torch.nn.GRU(d, h, bidirectional=True, batch_first=True).to(dev)
    with torch.no_grad():
        for i, sfx in enumerate(("", "_reverse")):
            getattr(lib, f"weight_ih_l0{sfx}").copy_(w_ih[i])
            getattr(lib, f"weight_hh_l0{sfx}").copy_(w_hh[i])
            getattr(lib, f"bias_ih_l0{sfx}").copy_(b_ih[i])
            getattr(lib, f"bias_hh_l0{sfx}").copy_(b_hh[i])
    return (x, gy, project, project(x), w_hh.transpose(1, 2).contiguous(),
            b_hh[:, 2 * h:].contiguous(), lib)


def gru_kernel_phase(clips: int, rng) -> list:
    """The GRU kernels against their plain versions at T = 250, 2B = 64,
    H = 256, beside ``torch.nn.GRU`` on the same weights; the backward's
    second design also against its first."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    t, b, h, d = GRU_T, clips, GRU_H, GRU_IN
    x_rng = np.random.default_rng(1)          # the extra batch sizes' inputs
    x, gy, project, proj, wh, bn, lib = _gru_inputs(rng, t, b, h, d)
    dev = x.device
    lib16 = torch.nn.GRU(d, h, bidirectional=True, batch_first=True).to(
        dev, torch.bfloat16)
    lib16.load_state_dict(lib.state_dict())
    lib.flatten_parameters()
    lib16.flatten_parameters()
    x16 = x.to(torch.bfloat16)
    gy_lib = torch.randn(b, t, 2 * h, device=dev)

    def lib_fwd_bwd():
        out, _ = lib(x)
        out.backward(gy_lib)

    def as_batch_first(ys, rows=b):
        ys = ys.reshape(t, 2, rows, h).permute(1, 2, 0, 3)
        return torch.cat([ys[0], torch.flip(ys[1], dims=(1,))], dim=-1)

    ys = gru.gru_forward(proj, wh, bn)
    ys_plain = gru.gru_forward_plain(proj, wh, bn)
    with torch.no_grad():
        lib_out, _ = lib(x)
    lib_gap = float((as_batch_first(ys) - lib_out).abs().max())
    if lib_gap > 1e-3:
        raise AssertionError(f"gru_fwd: off torch.nn.GRU by {lib_gap}")
    ys16 = gru.gru_forward(proj, wh, bn, torch.bfloat16)
    ys16_plain = gru.gru_forward_plain(proj, wh, bn, torch.bfloat16)
    grads = gru.gru_backward(proj, ys_plain, gy, wh, bn)
    grads_plain = gru.gru_backward_plain(proj, ys_plain, gy, wh, bn)
    b16 = torch.bfloat16
    grads16 = gru.gru_backward(proj, ys16_plain, gy, wh, bn, b16)
    grads16_plain = gru.gru_backward_plain(proj, ys16_plain, gy, wh, bn, b16)
    short = _gru_bf16_short(proj, gy, wh, bn)
    hoisted = {v: gru.gru_backward_hoisted(proj, ys_plain, gy, wh, bn, v)
               for v in gru.VARIANTS}
    hoisted_plain = {v: gru.gru_backward_hoisted_plain(
        proj, ys_plain, gy, wh, bn, v == "v3") for v in gru.VARIANTS}

    # the per-step launch floor: the same walks at B = 1, H = 4
    tiny = (torch.zeros(t, 2, 12, device=dev), torch.zeros(2, 4, 12,
                                                           device=dev),
            torch.zeros(2, 4, device=dev))
    tiny_ys = gru.gru_forward(*tiny)
    tiny_bwd = (tiny[0], tiny_ys, torch.zeros_like(tiny_ys), *tiny[1:])
    # the forward's two designs, f32 and bf16 carry; then both at the
    # extra batch sizes
    fwd_designs = {"gru_fwd": _gru_fwd_designs(proj, wh, bn, torch.float32,
                                               tiny),
                   "gru_fwd_bf16": _gru_fwd_designs(proj, wh, bn,
                                                    torch.bfloat16, tiny)}
    fwd_extra = [_gru_fwd_extra(project, lib, as_batch_first, wh, bn, eb,
                                x_rng) for eb in GRU_FWD_EXTRA_B]
    fwd_short = _gru_fwd_short(proj, wh, bn)
    fwd_odd = [_gru_fwd_odd(ob, oh, x_rng) for ob, oh in GRU_FWD_ODD]
    # the hoisted walks' two designs, at the main path's inputs, then at
    # the extra shapes
    walk_designs = {v: _gru_walk_designs(proj, ys_plain, gy, wh, bn, v,
                                         tiny_bwd) for v in gru.VARIANTS}
    walk_short = {v: _gru_walk_short(proj, ys_plain, gy, wh, bn, v)
                  for v in gru.VARIANTS}
    walk_shapes = _gru_walk_shapes(x_rng)
    # the backward's two designs, f32 and bf16 operands
    designs = {"gru_bwd": _gru_designs(proj, ys_plain, gy, wh, bn,
                                       torch.float32, tiny_bwd),
               "gru_bwd_bf16": _gru_designs(proj, ys16_plain, gy, wh, bn,
                                            b16, tiny_bwd)}

    fwd_bytes = 4 * (proj.numel() + ys.numel() + wh.numel() + bn.numel())
    fwd_ops = 2.0 * t * 2 * b * h * 3 * h
    bwd_bytes = 4 * (2 * proj.numel() + 2 * ys.numel() + 2 * wh.numel()
                     + 2 * bn.numel())
    # the hoisted backward in its two parts: the walk (gate recompute and
    # dh chain; reads proj, ys, gy, wh, bn, writes dproj and drznn) and
    # the dWh product (reads ys, dproj's r/z thirds and drznn, writes dwh
    # and dbn), timed apart and together
    walk_bound = _bound(4 * (2 * proj.numel() + 3 * ys.numel() + wh.numel()
                             + bn.numel()), {"f32": 2 * fwd_ops})
    product_bound = _bound(4 * (proj.numel() * 2 // 3 + 2 * ys.numel()
                                + wh.numel() + bn.numel()),
                           {"f32": fwd_ops})
    parts = {v: {"walk_bound_ms": walk_bound[0],
                 "dwh_product_bound_ms": product_bound[0]}
             for v in gru.VARIANTS}
    lib_fwd_ms = _cuda_ms(lambda: lib(x), 10)
    lib_fwd_bwd_ms = _cuda_ms(lib_fwd_bwd, 10)
    with torch.no_grad():
        lib16_ms = _cuda_ms(lambda: lib16(x16), 10)
    gy16_lib = gy_lib.to(b16)

    def lib16_fwd_bwd():
        out, _ = lib16(x16)
        out.backward(gy16_lib)

    lib16_grad_fwd_ms = _cuda_ms(lambda: lib16(x16), 10)
    lib16_fwd_bwd_ms = _cuda_ms(lib16_fwd_bwd, 10)
    rows = [
        dict(name="gru_fwd", got=ys, ref=ys_plain, tol=1e-4,
             replaces="texttoaudiogrounding_tpu/ops/pallas/gru.py:62",
             plain=lambda: gru.gru_forward_plain(proj, wh, bn),
             bound=_bound(fwd_bytes, {"f32": fwd_ops}),
             library_ms=lib_fwd_ms, library_max_abs_diff=lib_gap,
             fwd_designs=fwd_designs["gru_fwd"]),
        dict(name="gru_bwd", got=grads, ref=grads_plain, tol=1e-4,
             replaces="texttoaudiogrounding_tpu/ops/pallas/gru.py:199",
             plain=lambda: gru.gru_backward_plain(proj, ys_plain, gy, wh,
                                                  bn),
             bound=_bound(bwd_bytes, {"f32": 3 * fwd_ops}),
             library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
             library_fwd_bwd_ms=lib_fwd_bwd_ms,
             designs=designs["gru_bwd"]),
        dict(name="gru_fwd_bf16", got=ys16, ref=ys16_plain, tol=1e-2,
             replaces="texttoaudiogrounding_tpu/ops/pallas/gru.py:62",
             plain=lambda: gru.gru_forward_plain(proj, wh, bn,
                                                 torch.bfloat16),
             bound=_bound(fwd_bytes, {"bf16": fwd_ops}),
             library_ms=lib16_ms, fwd_designs=fwd_designs["gru_fwd_bf16"],
             short_T=fwd_short),
        dict(name="gru_bwd_bf16", got=grads16, ref=grads16_plain,
             tol=GRU_B16_TOL, short_T=short,
             replaces="texttoaudiogrounding_tpu/ops/pallas/gru.py:283",
             plain=lambda: gru.gru_backward_plain(proj, ys16_plain, gy, wh,
                                                  bn, b16),
             bound=_bound(bwd_bytes, {"bf16": 3 * fwd_ops}),
             library_ms=lib16_fwd_bwd_ms - lib16_grad_fwd_ms,
             library_fwd_bwd_ms=lib16_fwd_bwd_ms,
             designs=designs["gru_bwd_bf16"]),
    ] + [
        dict(name=f"gru_bwd_{v}", got=hoisted[v], ref=hoisted_plain[v],
             tol=1e-4, parts=parts[v],
             replaces="texttoaudiogrounding_tpu/ops/pallas/gru.py:"
             + {"v2": "540", "v3": "566"}[v],
             plain=lambda v=v: gru.gru_backward_hoisted_plain(
                 proj, ys_plain, gy, wh, bn, v == "v3"),
             bound=_bound(bwd_bytes, {"f32": 3 * fwd_ops}),
             library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
             library_fwd_bwd_ms=lib_fwd_bwd_ms,
             walk_designs=walk_designs[v], short_T=walk_short[v],
             other_shapes=[{"B": e["B"], "H": e["H"], "plan": e["plan"],
                            **e[v]} for e in walk_shapes])
        for v in gru.VARIANTS]
    out = []
    for row in rows:
        max_abs, rel = _max_err(row["got"], row["ref"])
        if rel > row["tol"]:
            raise AssertionError(f"{row['name']}: kernel disagrees with its "
                                 f"plain version: rel_rms {rel} > "
                                 f"{row['tol']} (max_abs {max_abs})")
        plain_ms = _cuda_ms(row["plain"], 2)
        extra = {k: row[k] for k in ("library_fwd_bwd_ms",
                                     "library_max_abs_diff", "short_T",
                                     "other_shapes")
                 if k in row}
        extra.update(row.get("parts", {}))
        source = "texttoaudiogrounding_tpu_torch/csrc/gru.cu"
        if "designs" in row:
            d = row["designs"]
            first = [_max_err(d["per_step"], row["ref"]),
                     _max_err(row["got"], d["per_step"]),
                     _max_err(d["rows_alt_grads"], row["ref"])]
            if max(e[1] for e in first) > row["tol"]:
                raise AssertionError(
                    f"{row['name']}: the first design off its plain version, "
                    f"the second design off the first or its {GRU_ROWS_ALT}"
                    f"-row plan off the plain version: rel_rms "
                    f"{[e[1] for e in first]} > {row['tol']}")
            kernel_ms = d["ms"]["cluster"]
            extra.update(
                per_step_ms=d["ms"]["per_step"], turns_ms=d["turns_ms"],
                rows_alt_ms=d["ms"]["rows_alt"], rows_alt=d["rows_alt"],
                rows_alt_rel_rms_err=first[2][1],
                latency_floor_ms=d["floor_ms"]["cluster"],
                per_step_latency_floor_ms=d["floor_ms"]["per_step"],
                per_step_rel_rms_err=first[0][1],
                vs_per_step_rel_rms=first[1][1],
                vs_per_step_max_abs=first[1][0], plan=d["plan"],
                clusters=d["clusters"],
                co_resident_clusters=d["co_resident_clusters"],
                cuda_launches_per_call=d["launches_per_call"]["cluster"],
                per_step_cuda_launches_per_call=d["launches_per_call"][
                    "per_step"],
                per_step_source=source)
            source = "texttoaudiogrounding_tpu_torch/csrc/gru_bwd_sm90.cu"
        elif "fwd_designs" in row:
            d = row["fwd_designs"]
            first = [_max_err(d["per_step"], row["ref"]),
                     _max_err(row["got"], d["per_step"])]
            if max(e[1] for e in first) > row["tol"]:
                raise AssertionError(
                    f"{row['name']}: the first design off its plain version "
                    f"or the second design off the first: rel_rms "
                    f"{[e[1] for e in first]} > {row['tol']}")
            kernel_ms = d["ms"]["cluster"]
            key = row["name"]
            extra.update(
                per_step_ms=d["ms"]["per_step"], turns_ms=d["turns_ms"],
                latency_floor_ms=d["floor_ms"]["cluster"],
                per_step_latency_floor_ms=d["floor_ms"]["per_step"],
                exchange_floor_ms=d["exchange_floor_ms"],
                per_step_rel_rms_err=first[0][1],
                vs_per_step_rel_rms=first[1][1],
                vs_per_step_max_abs=first[1][0], plan=d["plan"],
                clusters=d["clusters"],
                co_resident_clusters=d["co_resident_clusters"],
                cuda_launches_per_call=d["launches_per_call"]["cluster"],
                per_step_cuda_launches_per_call=d["launches_per_call"][
                    "per_step"],
                per_step_source=source,
                other_batches=[{"B": e["B"], **e[key]} for e in fwd_extra],
                odd_units=[{"B": e["B"], "H": e["H"], "plan": e["plan"],
                            "short_T": e["short_T"], **e[key]}
                           for e in fwd_odd])
            source = "texttoaudiogrounding_tpu_torch/csrc/gru_fwd_sm90.cu"
        elif "walk_designs" in row:
            d = row["walk_designs"]
            first = [_max_err(d["got"], d["plain"]),
                     _max_err(d["per_step"], d["plain"]),
                     _max_err(d["got"], d["per_step"])]
            if max(e[1] for e in first) > row["tol"]:
                rel = [e[1] for e in first]
                raise AssertionError(
                    f"{row['name']}: the cluster walk off the plain walk, "
                    f"the first design off it or the cluster walk off the "
                    f"first: rel_rms {rel} > {row['tol']}")
            kernel_ms = d["whole_ms"]["cluster"]
            extra.update(
                per_step_ms=d["whole_ms"]["per_step"],
                walk_ms=d["ms"]["cluster"],
                per_step_walk_ms=d["ms"]["per_step"],
                walk_turns_ms=d["turns_ms"],
                dwh_product_ms=d["dwh_product_ms"],
                latency_floor_ms=d["floor_ms"]["cluster"],
                per_step_latency_floor_ms=d["floor_ms"]["per_step"],
                exchange_floor_ms=d["exchange_floor_ms"],
                walk_rel_rms_err=first[0][1],
                per_step_walk_rel_rms_err=first[1][1],
                vs_per_step_rel_rms=first[2][1],
                vs_per_step_max_abs=first[2][0], plan=d["plan"],
                clusters=d["clusters"],
                co_resident_clusters=d["co_resident_clusters"],
                cuda_launches_per_call=d["launches_per_call"]["cluster"],
                per_step_cuda_launches_per_call=d["launches_per_call"][
                    "per_step"],
                per_step_source=source)
            source = "texttoaudiogrounding_tpu_torch/csrc/gru_walk_sm90.cu"
        else:
            kernel_ms = _cuda_ms(row["kernel"], 10)
        out.append({
            "name": row["name"], "route": "cuda",
            "source": source,
            "replaces": row["replaces"], "max_abs_err": max_abs,
            "rel_rms_err": rel, "tolerance": "rel_rms{} <= {}".format(
                "" if isinstance(row["got"], torch.Tensor)
                else " of each gradient", row["tol"]),
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": row["library_ms"], "library": "torch.nn.GRU "
            f"({'bf16, ' if 'bf16' in row['name'] else ''}cuDNN; includes "
            "the input projection)", "T": t,
            "rows": 2 * b, "H": h, **extra})
    return out


# the conv2 outputs the pool kernels see in a batch-32 x 10 s step
POOL_GEOMETRIES = (("block1", 1001, 64, 64, (2, 2)),
                   ("block2", 500, 32, 128, (2, 2)),
                   ("block3", 250, 16, 256, (1, 2)),
                   ("block4", 250, 8, 512, (1, 2)))
_DUAL = ("texttoaudiogrounding_tpu_torch/csrc/dual_pool.cu",
         "texttoaudiogrounding_tpu/ops/pallas/dual_pool.py:263")
_BN = "texttoaudiogrounding_tpu/ops/pallas/bn_pool.py:376"
POOL_SOURCES = {"dual_pool_fwd": _DUAL, "dual_pool_bwd": _DUAL,
                "bn_pool_fwd": ("texttoaudiogrounding_tpu_torch/csrc/"
                                "bn_pool.cu", _BN),
                "bn_pool_bwd": ("texttoaudiogrounding_tpu_torch/csrc/"
                                "bn_pool_v2.cu", _BN),
                "bn_pool_stats": ("texttoaudiogrounding_tpu_torch/csrc/"
                                  "bn_pool_v2.cu", _BN)}
# bn_pool_stats against plain batch_stats: var within STATS_VAR_TOL
# relative, mean within STATS_MEAN_TOL times the channel's std
STATS_VAR_TOL, STATS_MEAN_TOL = 1e-4, 1e-5


def _stats_err(got, ref) -> tuple:
    """(max abs error, worst share of its limit, var rel, mean / std) of
    ``(mean, var)`` against the plain ``(mean, var)``."""
    (gm, gv), (rm, rv) = got, ref
    var_rel = float(((gv - rv).abs() / rv).max())
    mean_std = float(((gm - rm).abs() / rv.sqrt()).max())
    max_abs = max(float((gm - rm).abs().max()), float((gv - rv).abs().max()))
    return max_abs, max(var_rel / STATS_VAR_TOL, mean_std / STATS_MEAN_TOL), \
        var_rel, mean_std


def _bwd_designs(x, g, mean, inv, gamma, beta, pool, plain,
                 label: str) -> dict:
    """The backward's second design against the first (``three_pass``) on
    the same inputs (1e-4), the first against its plain version ``plain()``
    (1e-4), the same bits on two calls, both timed in turns
    (three_pass, two_pass, two_pass, three_pass; 10 calls each) and each
    design's CUDA launches a call counted by the profiler (two_pass must
    make 2; three_pass makes its 3 and the wrapper's ``γ·inv`` and
    ``torch.stack``)."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import bn_pool

    def call(design):
        return lambda: bn_pool.bn_pool_bwd(x, g, mean, inv, gamma, beta,
                                           pool, design=design)

    first, again, old = call("two_pass")(), call("two_pass")(), \
        call("three_pass")()
    vs_first = _max_err(first, old)
    if vs_first[1] > 1e-4:
        raise AssertionError(f"bn_pool_bwd ({label}): the two designs "
                             f"disagree: rel_rms {vs_first[1]} > 1e-4")
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"bn_pool_bwd ({label}): two calls differ in "
                             "bits")
    del first, again
    vs_plain = _max_err(old, plain())
    if vs_plain[1] > 1e-4:
        raise AssertionError(f"bn_pool_bwd ({label}): three_pass disagrees "
                             f"with its plain version: rel_rms {vs_plain[1]} "
                             "> 1e-4")
    del old
    order = ("three_pass", "two_pass")
    runs = [(d, _cuda_ms(call(d), 10)) for d in order + order[::-1]]
    per_call = {d: _launches_per_call(call(d)) for d in order}
    if per_call["two_pass"] != 2:
        raise AssertionError(f"bn_pool_bwd ({label}): CUDA launches a call "
                             f"{per_call}, expected 2 for two_pass")
    return {"ms_turns": {d: sum(ms for n, ms in runs if n == d) / 2
                         for d in order},
            "turns_ms": runs, "launches_per_call": per_call,
            "vs_three_pass": {"max_abs_err": vs_first[0],
                              "rel_rms_err": vs_first[1]},
            "three_pass_vs_plain": {"max_abs_err": vs_plain[0],
                                    "rel_rms_err": vs_plain[1]},
            "same_bits_twice": True}


def _pool_chains(x, g, gamma, beta, pool):
    """The plain PyTorch chains the pool kernels replace, forward +
    backward (ReLU, or train-mode BN with f32 statistics then ReLU, and
    ``F.avg_pool2d + F.max_pool2d``), and the same work through the
    kernels' autograd functions."""
    import torch
    import torch.nn.functional as F

    from texttoaudiogrounding_tpu_torch.ops.kernels import bn_pool, dual_pool

    def pools(h):
        h = h.permute(0, 3, 1, 2)
        return (F.avg_pool2d(h, pool) + F.max_pool2d(h, pool)).permute(
            0, 2, 3, 1)

    def relu_chain():
        xx = x.detach().requires_grad_()
        pools(torch.relu(xx)).backward(g)

    def bn_chain():
        xx, gg, bb = (v.detach().requires_grad_() for v in (x, gamma, beta))
        xf = xx.float()
        mean = xf.mean(dim=(0, 1, 2))
        var = torch.clamp_min((xf * xf).mean(dim=(0, 1, 2)) - mean * mean,
                              0.0)
        h = ((xx - mean) * (torch.rsqrt(var + 1e-5) * gg) + bb).to(x.dtype)
        pools(torch.relu(h)).backward(g)

    def relu_kernel():
        xx = x.detach().requires_grad_()
        dual_pool.dual_pool_relu(xx, pool).backward(g)

    def bn_kernel():
        xx, gg, bb = (v.detach().requires_grad_() for v in (x, gamma, beta))
        bn_pool.bn_relu_dual_pool(xx, gg, bb, pool)[0].backward(g)

    return {"dual_pool": (relu_chain, relu_kernel),
            "bn_pool": (bn_chain, bn_kernel)}


def pool_kernel_phase(clips: int) -> list:
    """The pool kernels against their plain versions at the four blocks'
    bf16 geometries (and block 1 in f32); one row per kernel, its times
    the sum over the four bf16 blocks, each geometry listed."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import bn_pool, dual_pool

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = [(n, t, m, c, p, torch.bfloat16)
             for n, t, m, c, p in POOL_GEOMETRIES]
    cases.append(("block1_f32", 1001, 64, 64, (2, 2), torch.float32))
    geos = {k: [] for k in POOL_SOURCES}
    tol = {"dual_pool_fwd": 1e-5, "dual_pool_bwd": 1e-5, "bn_pool_fwd": 1e-5,
           "bn_pool_bwd": 1e-4, "bn_pool_stats": 1.0}
    for label, t, m, c, pool, dtype in cases:
        pt = pool[0]
        # a conv output's spread, in bf16 with the ties bf16 makes
        x = torch.randn(clips, t, m, c, device=dev, generator=gen).to(dtype)
        g = torch.randn(clips, t // pt, m // 2, c, device=dev,
                        generator=gen).to(dtype)
        gamma = torch.rand(c, device=dev, generator=gen) + 0.5
        beta = torch.randn(c, device=dev, generator=gen) * 0.1
        mean, var = bn_pool.batch_stats(x)
        inv = torch.rsqrt(var + 1e-5)
        sc, sh = gamma * inv, beta - mean * gamma * inv
        calls = {
            "dual_pool_fwd": (lambda: dual_pool.dual_pool_fwd(x, pool),
                              lambda: dual_pool.dual_pool_fwd_plain(x, pool)),
            "dual_pool_bwd": (
                lambda: dual_pool.dual_pool_bwd(x, g, pool),
                lambda: dual_pool.dual_pool_bwd_plain(x, g, pool)),
            "bn_pool_fwd": (
                lambda: bn_pool.bn_pool_fwd(x, sc, sh, pool),
                lambda: bn_pool.bn_pool_fwd_plain(x, sc, sh, pool)),
            "bn_pool_bwd": (
                lambda: bn_pool.bn_pool_bwd(x, g, mean, inv, gamma, beta,
                                            pool),
                lambda: bn_pool.bn_pool_bwd_plain(x, g, mean, inv, gamma,
                                                  beta, pool)),
            "bn_pool_stats": (lambda: bn_pool.batch_stats(x),
                              lambda: bn_pool.batch_stats_plain(x)),
        }
        # bytes moved; at under 20 f32 operations per input element their
        # time is below a third of the bytes' on every row
        es, nx = x.element_size(), x.numel()
        nbytes = {"dual_pool_fwd": nx * es * (1 + 0.5 / pt),
                  "dual_pool_bwd": nx * es * (2 + 0.5 / pt),
                  "bn_pool_fwd": nx * es * (1 + 0.5 / pt) + 8 * c,
                  "bn_pool_bwd": nx * es * (2 + 0.5 / pt) + 24 * c,
                  "bn_pool_stats": nx * es + 8 * c}
        chains = _pool_chains(x, g, gamma, beta, pool)
        for name, (kern, plain) in calls.items():
            got, ref = kern(), plain()
            if name == "bn_pool_stats":
                max_abs, rel, var_rel, mean_std = _stats_err(got, ref)
                extra = {"var_rel_err": var_rel, "mean_err_over_std": mean_std}
            else:
                if isinstance(got, torch.Tensor):
                    got, ref = (got,), (ref,)
                errs = [_err(a, b) for a, b in zip(got, ref)]
                max_abs = max(e[0] for e in errs)
                rel = max(e[1] for e in errs)
                extra = {}
            if rel > tol[name]:
                raise AssertionError(f"{name} ({label}): kernel disagrees "
                                     f"with its plain version: "
                                     f"{extra or 'rel_rms'} {rel} > "
                                     f"{tol[name]} (max_abs {max_abs})")
            del got, ref
            ms = _cuda_ms(kern, 10)
            device_ms = _trace(lambda kern=kern: [kern() for _ in range(10)],
                               10 * ms)["pool_ms"] / 10
            entry = {"geometry": label, "dtype": str(dtype).split(".")[1],
                     "x_shape": [clips, t, m, c], "pool": list(pool),
                     "max_abs_err": max_abs, "rel_rms_err": rel, **extra,
                     "ms": ms, "device_ms": device_ms,
                     "plain_ms": _cuda_ms(plain, 3),
                     "bound": _bound(nbytes[name], {})}
            if name.endswith("_bwd"):      # forward + backward, information
                chain, through = chains[name.split("_bwd")[0]]
                entry["chain_fwd_bwd_ms"] = _cuda_ms(chain, 5)
                entry["kernel_fwd_bwd_ms"] = _cuda_ms(through, 5)
            if name == "bn_pool_bwd":
                entry.update(_bwd_designs(x, g, mean, inv, gamma, beta, pool,
                                          plain, label))
                # two streaming passes: x and g read twice, dx written
                entry["floor_ms"] = nx * es * (3 + 1 / pt) / HBM * 1e3
            if name == "bn_pool_stats":
                xf = lambda: torch.var_mean(x.float(), dim=(0, 1, 2),
                                            correction=0)
                entry["library_ms"] = _cuda_ms(xf, 10)
                if label == "block1":
                    entry["shifted"] = _stats_shifted(x)
            geos[name].append(entry)
        del x, g
        torch.cuda.empty_cache()
    rows = []
    for name, entries in geos.items():
        main = [e for e in entries if e["dtype"] == "bfloat16"]
        source, replaces = POOL_SOURCES[name]
        for e in entries:
            e["bound_ms"], e["bound_by"] = e.pop("bound")
        extra = {}
        if name == "bn_pool_bwd":
            extra = {
                "three_pass_ms": sum(e["ms_turns"]["three_pass"]
                                     for e in main),
                "two_pass_turns_ms": sum(e["ms_turns"]["two_pass"]
                                         for e in main),
                "floor_ms": sum(e["floor_ms"] for e in main),
                "launches_per_call": main[0]["launches_per_call"],
                "three_pass": "csrc/bn_pool.cu, bn_pool_bwd(..., "
                              "design=\"three_pass\"), timed in turns"}
        library = (None, "none: no single PyTorch call computes it")
        if name == "bn_pool_stats":
            library = (sum(e["library_ms"] for e in main),
                       "torch.var_mean(x.float(), dim=(0, 1, 2), "
                       "correction=0)")
            extra = {"tolerance": f"var within {STATS_VAR_TOL} relative, "
                     f"mean within {STATS_MEAN_TOL} std (rel_rms_err: the "
                     "worst share of those limits)",
                     "replaces_part": "the batch statistics of "
                     "bn_relu_dual_pool, bn_pool.py:395-398 (XLA "
                     "reductions)"}
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "max_abs_err": max(e["max_abs_err"] for e in entries),
            "rel_rms_err": max(e["rel_rms_err"] for e in entries),
            "tolerance": f"rel_rms <= {tol[name]}",
            "ms": sum(e["ms"] for e in main),
            "kernel_ms": sum(e["ms"] for e in main),
            "device_ms": sum(e["device_ms"] for e in main),
            "plain_ms": sum(e["plain_ms"] for e in main),
            "bound_ms": sum(e["bound_ms"] for e in main),
            "bound_by": main[0]["bound_by"], "library_ms": library[0],
            "library": library[1], **extra,
            "times": "sum over the four bf16 blocks of a batch-32 x 10 s "
                     "step", "clips": clips, "geometries": entries})
    return rows


def _stats_shifted(x) -> dict:
    """``bn_pool_stats`` against plain ``batch_stats`` on x·0.5 + 3, where
    ``E[x²] − mean²`` cancels (block 1: 2.05 M elements a channel)."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import bn_pool

    xs = (x.float() * 0.5 + 3.0).to(x.dtype)
    max_abs, share, var_rel, mean_std = _stats_err(bn_pool.batch_stats(xs),
                                                   bn_pool.batch_stats_plain(xs))
    if share > 1.0:
        raise AssertionError(f"bn_pool_stats (x 0.5 + 3): var rel {var_rel} "
                             f"(limit {STATS_VAR_TOL}), mean / std {mean_std} "
                             f"(limit {STATS_MEAN_TOL})")
    return {"input": "x * 0.5 + 3", "max_abs_err": max_abs,
            "var_rel_err": var_rel, "mean_err_over_std": mean_std}


def _embedding_gap(plain, served: list) -> float:
    """Largest relative RMS gap of the served audio embeddings to the plain
    path's on the same inputs; ``served`` holds (input, embedding) pairs
    of the audio encoder's forwards."""
    import torch
    gaps = []
    with torch.no_grad():
        for inp, got in served:
            ref = plain.audio_encoder(inp)["embedding"].double()
            d = got.double() - ref
            gaps.append(float(torch.sqrt((d ** 2).mean()
                                         / (ref ** 2).mean())))
    return max(gaps)


# kernel launches of one int8 serving forward (the rest launch none)
SERVING_PER_FORWARD = {"logmel": 1, "conv_block1_pair": 1,
                       "conv_block_pair": 1, "conv_block": 2}


# the routing switches the serving phase drives: (name, flagship_model
# arguments, launches per forward)
SERVING_SWITCHES = (
    ("block1_plain", {"block1_pair": False},
     {**SERVING_PER_FORWARD, "conv_block1_pair": 0}),
    ("frontend_plain", {"logmel_kernel": False},
     {**SERVING_PER_FORWARD, "logmel": 0}),
    ("f32_logmel_kernel", {"serving": False, "gru_kernel": False,
                           "logmel_kernel": True}, {"logmel": 1}),
)


def _request(rng, lens: list) -> tuple:
    """(audio [B, max len] with noise up to each length, B phrases)."""
    import numpy as np
    audio = np.zeros((len(lens), max(lens)), np.float32)
    for i, ln in enumerate(lens):
        audio[i, :ln] = rng.normal(0, 0.1, ln)
    text = [" ".join(f"w{int(v)}" for v in rng.integers(2, 5000, 3))
            for _ in lens]
    return audio, text


def _checked_request(pred, pred_plain, plain, served: list, label: str,
                     audio, lens, text, per_forward: dict,
                     totals: dict) -> dict:
    """One ``predict`` held to the serving correctness contract (PERF.md
    §2): every kernel's count rises by ``per_forward`` per sub-batch (and
    no other count rises), the reference lengths, ``frame_sim`` finite in
    (0, 1] with padded frames zero and within 0.05 of the all-plain f32
    path, and each sub-batch's audio embedding (the forward hook's
    ``served`` pairs) within 5 % relative RMS of the plain path's.  Adds
    the launches to ``totals``."""
    import numpy as np
    import torch

    before = _counts()
    served.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs, lengths = pred.predict(audio, lens, text, return_length=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    subs = len(pred._chunk_plan(len(lens)))
    for k, n in _counts().items():
        grew = n - before[k]
        if grew != subs * per_forward.get(k, 0):
            raise AssertionError(f"{label}: {k} launched {grew} times, "
                                 f"expected {subs * per_forward.get(k, 0)}")
        totals[k] += grew
    want = (np.asarray(lens) // 320 + 1) // 4
    if not np.array_equal(lengths, want):
        raise AssertionError(f"{label}: lengths {lengths} != {want}")
    valid = np.arange(probs.shape[1])[None] < lengths[:, None]
    if not (np.isfinite(probs).all() and (probs[valid] > 0).all()
            and (probs[valid] <= 1).all() and not probs[~valid].any()):
        raise AssertionError(f"{label}: frame_sim out of (0, 1]")
    ref = pred_plain.predict(audio, lens, text)
    delta = float(np.max(np.abs(probs - ref)))
    if delta >= 0.05:
        raise AssertionError(f"{label}: |frame_sim - plain f32| = "
                             f"{delta} >= 0.05")
    if len(served) != subs:
        raise AssertionError(f"{label}: {len(served)} audio forwards, "
                             f"expected {subs}")
    emb_rel = _embedding_gap(plain, served)     # int8 noise, < 5 %
    if emb_rel >= 0.05:
        raise AssertionError(f"{label}: audio embedding off the plain "
                             f"f32 path by {emb_rel} (relative RMS)")
    return {"request": label, "clips": len(lens), "sub_batches": subs,
            "seconds": seconds, "max_abs_vs_plain_f32": delta,
            "embedding_rel_rms_vs_plain_f32": emb_rel,
            "frame_sim_mean": float(probs[valid].mean())}


def serving_phase(rng, tok) -> dict:
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import (
        GroundingPredictor, flagship_model, random_state_dict)

    model = flagship_model(serving=True, device=DEVICE)
    sd = random_state_dict(model, seed=0)
    model.load_state_dict(sd)
    plain = flagship_model(serving=False, device=DEVICE, gru_kernel=False)
    plain.load_state_dict(sd)
    pred = GroundingPredictor(model, tok)
    pred_plain = GroundingPredictor(plain, tok)

    n = SR * CLIP_S
    requests = [
        ("3 clips, 10/7.8/5 s", [n, 250000, 160000]),
        ("1 clip, 4.3 s", [137600]),
        ("32 clips, 10 s", [n] * 32),
    ]
    # random weights keep frame_sim near 0.5: each sub-batch's audio
    # embedding is also held to the plain f32 path on the same input
    served = []
    hook = model.audio_encoder.register_forward_hook(
        lambda mod, args, out: served.append((args[0], out["embedding"])))
    _reset_counts()
    totals = _counts()                  # launches by predict() alone
    results = []
    for label, lens in requests:
        audio, text = _request(rng, lens)
        results.append(_checked_request(pred, pred_plain, plain, served,
                                        label, audio, lens, text,
                                        SERVING_PER_FORWARD, totals))
    hook.remove()
    served.clear()

    # the bf16 GRU kernel opted in (JAX: TTG_PALLAS_GRU=1), held to the
    # plain path on the largest request as the default path is
    label, lens = requests[-1]
    audio = (rng.normal(0, 0.1, (len(lens), n))).astype(np.float32)
    text = [" ".join(f"w{int(v)}" for v in rng.integers(2, 5000, 3))
            for _ in lens]
    model_gk = flagship_model(serving=True, device=DEVICE, gru_kernel=True)
    model_gk.load_state_dict(sd)
    pred_gk = GroundingPredictor(model_gk, tok)
    hook = model_gk.audio_encoder.register_forward_hook(
        lambda mod, args, out: served.append((args[0], out["embedding"])))
    _reset_counts()
    probs = pred_gk.predict(audio, lens, text)
    torch.cuda.synchronize()
    gru_launches = _counts()["gru_fwd_bf16"]
    hook.remove()
    if gru_launches != len(pred_gk._chunk_plan(len(lens))):
        raise AssertionError(f"bf16 GRU kernel launched {gru_launches} "
                             "times for one request")
    delta = float(np.max(np.abs(probs - pred_plain.predict(audio, lens,
                                                           text))))
    emb_rel = _embedding_gap(plain, served)
    served.clear()
    if delta >= 0.05 or emb_rel >= 0.05:
        raise AssertionError(f"bf16 GRU kernel path: |frame_sim - plain| "
                             f"{delta}, embedding {emb_rel} (limits 0.05)")

    # block 1 all in int8 (JAX: TTG_B1_QUANT=1) on the largest request,
    # held to the contract as the default path is; block 1's input (the
    # bn0 output) and output in this served batch feed the designs phase
    model8 = flagship_model(serving=True, device=DEVICE,
                            block1_quant="int8")
    model8.load_state_dict(sd)
    pred8 = GroundingPredictor(model8, tok)
    enc8 = model8.audio_encoder
    block1_io, block2_out = [], []
    hooks = [enc8.register_forward_hook(
        lambda mod, args, out: served.append((args[0], out["embedding"]))),
        enc8.conv_block1.register_forward_hook(
            lambda mod, args, out: block1_io.append((args[0], out))),
        enc8.conv_block2.register_forward_hook(
            lambda mod, args, out: block2_out.append(out))]
    _reset_counts()
    b1_totals = _counts()
    b1_request = _checked_request(
        pred8, pred_plain, plain, served, f"{label}, block 1 int8", audio,
        lens, text, {**SERVING_PER_FORWARD, "conv_block1_pair": 0,
                     "conv_block1_pair_int8": 1}, b1_totals)
    for hook in hooks:
        hook.remove()
    served.clear()
    handoff = (block1_io[0][0][..., 0].contiguous(),
               block1_io[0][1].contiguous(), enc8,
               block2_out[0].contiguous(),
               torch.from_numpy(audio).to(DEVICE))
    del block1_io, block2_out

    # block 1 all in int8 in the single staging (JAX: TTG_B1_QUANT=1
    # TTG_B1_MODE=single), held to the contract as the default path is
    model_s = flagship_model(serving=True, device=DEVICE,
                             block1_quant="int8", block1_mode="single")
    model_s.load_state_dict(sd)
    pred_s = GroundingPredictor(model_s, tok)
    hook = model_s.audio_encoder.register_forward_hook(
        lambda mod, args, out: served.append((args[0], out["embedding"])))
    _reset_counts()
    single_totals = _counts()
    single_request = _checked_request(
        pred_s, pred_plain, plain, served, f"{label}, block 1 int8 single",
        audio, lens, text, {**SERVING_PER_FORWARD, "conv_block1_pair": 0,
                            "conv_block1_pair_single": 1}, single_totals)
    hook.remove()
    served.clear()

    # the two routing switches (JAX TTG_FUSED_B1=0 and TTG_PALLAS_FRONTEND)
    # on the largest request, each held to the contract as the default
    # path is and its launches exact: block 1 on the plain bf16 path while
    # blocks 2-4 keep their kernels, the plain frontend under the int8
    # blocks, and row 1's kernel feeding the f32 model (all else plain)
    route_launches, route_requests = {}, {}
    for name, kwargs, per_forward in SERVING_SWITCHES:
        model_r = flagship_model(device=DEVICE, **kwargs)
        model_r.load_state_dict(sd)
        hook = model_r.audio_encoder.register_forward_hook(
            lambda mod, args, out: served.append((args[0],
                                                  out["embedding"])))
        _reset_counts()
        route_launches[name] = _counts()
        route_requests[name] = _checked_request(
            GroundingPredictor(model_r, tok), pred_plain, plain, served,
            f"{label}, {name}", audio, lens, text, per_forward,
            route_launches[name])
        hook.remove()
        served.clear()
        del model_r

    # steady-state throughput of the largest request, four ways
    paths = {}
    for name, p in (("default", pred), ("gru_kernel", pred_gk),
                    ("block1_int8", pred8), ("block1_single", pred_s)):
        p.predict(audio, lens, text)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.predict(audio, lens, text)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        secs = float(np.median(times))
        paths[name] = {"clips_per_s": len(lens) / secs, "request_s": secs,
                       "request_s_all": times,
                       "trace": _trace(lambda p=p: p.predict(audio, lens,
                                                             text),
                                       secs * 1e3)}
    paths["gru_kernel"].update(max_abs_vs_plain_f32=delta,
                               embedding_rel_rms_vs_plain_f32=emb_rel)
    paths["block1_int8"].update(b1_request)
    paths["block1_single"].update(single_request)
    return {"requests": results, "launches": totals,
            "gru_fwd_bf16_launches": gru_launches,
            "block1_int8_launches": b1_totals,
            "block1_single_launches": single_totals,
            "switch_launches": route_launches, "switches": route_requests,
            "clips_per_s": paths["default"]["clips_per_s"],
            "largest": label, "paths": paths}, handoff


def _block_weights(blk) -> tuple:
    """(w1, ab1, w2, ab2) of a ``ConvBlock``: HWIO f32, BN folded."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block import fold_bn
    with torch.no_grad():
        return (blk.conv1.weight.detach().permute(2, 3, 1, 0),
                fold_bn(blk.bn1.weight, blk.bn1.bias, blk.bn1.running_mean,
                        blk.bn1.running_var, blk.bn1.eps),
                blk.conv2.weight.detach().permute(2, 3, 1, 0),
                fold_bn(blk.bn2.weight, blk.bn2.bias, blk.bn2.running_mean,
                        blk.bn2.running_var, blk.bn2.eps))


_DESIGN_TOL = "max_abs == 0 (int8); bf16 mode rel_rms <= 0.01"
# row 9 against its plain version on the same waveform: one bf16 ulp of a
# power bin, 10 log10(1 + 2^-7) = 0.034 dB, where the kernel's and the
# plain version's f32 DFT sums round the power to different sides; in the
# mean, far below the 3.9e-3 dB by which row 1's f32 mel projection
# differs from v3's bf16 one (CPU, 2 x 3 s of noise), which the control
# below must show on the card
V3_MAX_DB, V3_MEAN_DB = 0.035, 1e-4


def _bit_exact(out, target) -> dict:
    max_abs, rel = _err(out, target)
    if max_abs != 0.0:
        raise AssertionError(f"differs from its plain version: max_abs "
                             f"{max_abs}, rel_rms {rel}")
    return {"max_abs_err": max_abs, "rel_rms_err": rel}


def _design(kernel, plain, ref, ops, in_bytes, source, replaces, *,
            check=_bit_exact, tolerance=_DESIGN_TOL, target=None, bf16=None,
            beside=None, timed=None, counter=None, trace=False,
            designs=None, **extra) -> dict:
    """One record of the designs table.  ``kernel()`` runs the design as
    its route does (weights laid out once) and ``plain()`` its plain
    version; ``check(out, target())`` holds the counted run's output
    against ``target`` (the plain version if None); ``ref`` is (label,
    tensor) of the f32 block or f64 log-mel it is compared with; ``ops``
    {type: count} and ``in_bytes`` (output bytes added) give its bound;
    ``bf16`` is (kernel, plain) of the bf16 mode, held within 1e-2
    relative RMS; ``beside`` {name: fn} are other kernels timed in the same
    call and compared with ``ref`` (and with ``trace``, traced by launch
    as the design is), ``timed`` {name: fn} are only timed;
    ``counter`` is the launch counter where it is not the record's name;
    ``designs()``, if given, runs last and its dict (a redesigned row's
    first design, timed in turns) goes into the row;
    ``extra`` goes into the JSON row as it is."""
    return {"kernel": kernel, "plain": plain, "ref": ref, "ops": ops,
            "in_bytes": in_bytes, "source": source, "replaces": replaces,
            "check": check, "tolerance": tolerance,
            "target": target or plain, "bf16": bf16, "beside": beside or {},
            "timed": timed or {}, "counter": counter, "trace": trace,
            "designs": designs, "extra": extra}


def _design_row(name: str, d: dict, out) -> dict:
    """Check, time and report one design (its counted run gave ``out``)."""
    try:
        errs = d["check"](out, d["target"]())
    except AssertionError as e:
        raise AssertionError(f"{name}: {e}") from None
    label, ref = d["ref"]

    def vs_ref(key, got):
        # the padded frames off
        return {f"{key}max_abs_vs_{label}": _err(got[:, :ref.shape[1]],
                                                 ref)[0],
                f"{key}rel_rms_vs_{label}": _err(got[:, :ref.shape[1]],
                                                 ref)[1]}

    ms = _cuda_ms(d["kernel"], 10)
    nbytes = d["in_bytes"] + out.numel() * out.element_size()
    bound_ms, bound_by = _bound(nbytes, d["ops"])
    row = {"name": name, "route": "cuda",
           "source": f"texttoaudiogrounding_tpu_torch/csrc/{d['source']}",
           "replaces": f"texttoaudiogrounding_tpu/ops/pallas/"
                       f"{d['replaces']}",
           **errs, "tolerance": d["tolerance"], "ms": ms, "kernel_ms": ms,
           "plain_ms": _cuda_ms(d["plain"], 3), "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None,
           "library": "none: no single PyTorch call computes it",
           "input_bytes": d["in_bytes"], **vs_ref("", out)}
    if d["counter"]:
        row["counter"] = d["counter"]
    if d["bf16"]:
        kern16, plain16 = d["bf16"]
        got16 = kern16()
        b16 = _err(got16, plain16())[1]
        if b16 > 1e-2:
            raise AssertionError(f"{name} (bf16): kernel disagrees with its "
                                 f"plain version: rel_rms {b16} > 0.01")
        row.update({"bf16_mode_rel_rms_err": b16,
                    "bf16_ms": _cuda_ms(kern16, 10),
                    "bf16_bound_ms": _bound(nbytes, {
                        "bf16": sum(d["ops"].values())})[0],
                    **vs_ref("bf16_", got16)})
    for key, fn in d["beside"].items():
        row.update({f"{key}_ms": _cuda_ms(fn, 10), **vs_ref(f"{key}_", fn())})
        if d["trace"]:
            row[f"{key}_trace"] = _trace(fn, row[f"{key}_ms"], by_launch=True)
    for key, fn in d["timed"].items():
        row[f"{key}_ms"] = _cuda_ms(fn, 10)
    if d["trace"]:
        # device time by launch
        row["trace"] = _trace(d["kernel"], ms, by_launch=True)
    row.update(d["extra"])
    if d["designs"]:
        row.update(d["designs"]())
    return row


def designs_phase(x1, y1, enc, y2, wave) -> tuple:
    """The JAX package's designs that no shipped model routes, on the
    served batch: block 1's all-int8 mode in both stagings (row 2) and rows
    5-7 on x1, the bn0 output ``[B, T, 64]`` that entered block 1, and y1,
    block 1's output, with the served blocks-1-2 weights; row 8 on y2, its
    block-2 output, and row 8's own block-3 output; rows 9-10 on its
    waveform.  Each design runs once as the JAX package drives it (its
    launches counted, exactly one per design), then each record of the one
    table is checked, timed and reported by :func:`_design_row`.  Returns
    (records, launches, the reports of :func:`_v1_route` and
    :func:`_row7_mels`)."""
    import collections

    import torch

    designs = _block12_designs(x1, y1, enc)
    loud = _single_loud_frame(x1, _block_weights(enc.conv_block1))
    designs["conv_block1_pair_single"]["extra"]["loud_frame"] = loud
    _reset_counts()
    outs = {name: d["kernel"]() for name, d in designs.items()}
    for more, got in (_wino_designs(enc, y2), _slab_designs(enc, y2),
                      _logmel_designs(wave)):
        designs.update(more)
        outs.update(got)
    torch.cuda.synchronize()
    launches = _counts()
    want = _want(**collections.Counter(d["counter"] or name
                                       for name, d in designs.items()))
    if launches != want:
        raise AssertionError(f"designs: launches {launches}, expected "
                             f"{want}")
    rows = []
    for name, d in designs.items():
        rows.append(_design_row(name, d, outs.pop(name)))
        torch.cuda.empty_cache()
    return rows, launches, {**_v1_route(y1, enc), **_row7_mels(x1, enc)}


# the public function of each row whose second design takes no time pairs
# at M = 4, and the first design's counter its call must raise
V1_ROUTE = {"conv_block_pair": "conv_block_pair_v1",
            "conv_block": "conv_block_v1",
            "pair_conv_pool": "pair_conv_pool_v1",
            "block2_small": "block2_small_v1"}


def _v1_route(y1, enc) -> dict:
    """Rows 3, 4 direct9, 5 and 6 at M = 4, pool (2, 2), on 3 clips x 16
    frames x the first 4 mels of the served block-1 output, with the served
    block-2 weights: each through its public function must equal its plain
    version bit for bit in int8, by way of its first design
    (``conv_block.v2_takes``), raising that design's counter by one and no
    other."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        block2_small, conv_block, conv_block_pair, pair_conv_pool)

    w = _block_weights(enc.conv_block2)
    x = y1[:3, :16, :4].contiguous()
    t, m = x.shape[1:3]
    if conv_block.v2_takes(m, (2, 2)):
        raise AssertionError(f"the second design takes M = {m}")
    tc3 = conv_block_pair.pick_tc_pair(t, m // 2, 128, True)
    tc4 = conv_block.block_tc(x.shape, 128, (2, 2), True, (False,) * 4)
    tc5 = pair_conv_pool.pick_tc(t, m // 2, 2)
    tc6 = block2_small.default_tc(t)
    runs = {
        "conv_block_pair": (
            lambda: conv_block_pair.fused_block2_pair(x, *w, quantize=True),
            lambda: conv_block_pair.block2_plain(x, *w, quantize=True,
                                                 tc=tc3), tc3),
        "conv_block": (
            lambda: conv_block.fused_double_conv_pool(x, *w, (2, 2),
                                                      quantize=True),
            lambda: conv_block.block_plain(x, *w, (2, 2), quantize=True,
                                           tc=tc4), tc4),
        "pair_conv_pool": (
            lambda: pair_conv_pool.fused_pair_conv_pool(x, *w,
                                                        quantize=True),
            lambda: pair_conv_pool.pair_conv_pool_plain(x, *w, quantize=True,
                                                        tc=tc5), tc5),
        "block2_small": (
            lambda: block2_small.fused_block2(x, *w),
            lambda: conv_block_pair.block2_plain(x, *w, quantize=True,
                                                 tc=tc6, divide=True), tc6)}
    out = {}
    for name, (run, plain, tc) in runs.items():
        _reset_counts()
        got = run()
        torch.cuda.synchronize()
        counts = _counts()
        want = _want(**{V1_ROUTE[name]: 1})
        if counts != want:
            raise AssertionError(f"{name} at M = {m}: launches "
                                 f"{ {k: v for k, v in counts.items() if v} }"
                                 f", expected {V1_ROUTE[name]} once")
        max_abs = _err(got, plain())[0]
        if max_abs != 0.0:
            raise AssertionError(f"{name} at M = {m}: max_abs {max_abs} to "
                                 f"its plain version")
        out[name] = {"counter": V1_ROUTE[name], "max_abs_err": max_abs,
                     "tc": tc, "shape": list(x.shape)}
    return out


# row 7 at mel counts other than the flagship's 64: the public function's
# design at each (M 32 takes the second, 48 the first) and its counter
ROW7_MELS = {32: "block1_small", 48: "block1_small_v1"}


def _row7_mels(x1, enc) -> dict:
    """Row 7 (``block1_small.fused_block1``) at M = 32 and 48 on 4 clips of
    the served block-1 input cut to its first M mels, with the served
    block-1 weights: int8 bit for bit and the bf16 mode within 1e-2
    relative RMS of its plain version, each call raising ROW7_MELS[M] by
    one and no other counter; at M = 32 the second design also bit for bit
    to the first (int8)."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import block1_small

    w = _block_weights(enc.conv_block1)
    out = {}
    for m, counter in ROW7_MELS.items():
        x = x1[:4, :, :m].contiguous()
        tc = block1_small.default_tc(x.shape[1])
        rec = {"counter": counter, "tc": tc, "shape": list(x.shape)}
        for q, key in ((True, "int8"), (False, "bf16")):
            def run(q=q):
                return block1_small.fused_block1(x, *w, quantize=q)
            _reset_counts()
            got = run()
            torch.cuda.synchronize()
            counts = _counts()
            if counts != _want(**{counter: 1}):
                raise AssertionError(
                    f"block1_small at M = {m}: launches "
                    f"{ {k: v for k, v in counts.items() if v} }, expected "
                    f"{counter} once")
            plain = block1_small.block1_small_plain(x, *w, quantize=q, tc=tc)
            max_abs, rel = _err(got, plain)
            if (q and max_abs != 0.0) or rel > 1e-2:
                raise AssertionError(f"block1_small at M = {m} ({key}): "
                                     f"max_abs {max_abs}, rel_rms {rel} to "
                                     f"its plain version")
            rec.update({f"{key}_max_abs_err": max_abs,
                        f"{key}_rel_rms_err": rel,
                        f"{key}_ms": _cuda_ms(run, 10)})
            if q and counter == "block1_small":
                vs_v1 = _err(got, block1_small._fused_block1_v1(
                    x, *w, quantize=True))[0]
                if vs_v1 != 0.0:
                    raise AssertionError(f"block1_small at M = {m}: the "
                                         f"first design differs by {vs_v1}")
                rec["v1_max_abs_err"] = vs_v1
        out[f"block1_small_m{m}"] = rec
    return out


def _block12_designs(x1, y1, enc) -> dict:
    """Rows 2 (``True`` and ``single``) and 5-7 on the served block-1 input
    and output, beside the routed rows 2 / 3 on the same input."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        block1_small, block2_small, conv_block, conv_block1_pair,
        conv_block_pair, pair_conv_pool)
    from texttoaudiogrounding_tpu_torch.ops.kernels.conv_block import (
        _quant_i8, over127)

    b1w, b2w = _block_weights(enc.conv_block1), _block_weights(
        enc.conv_block2)
    clips, t1, _ = x1.shape
    t2 = y1.shape[1]
    with torch.no_grad():
        f32_1 = ("f32_block", enc.conv_block1._plain(x1.float()[..., None],
                                                     (2, 2)))
        f32_2 = ("f32_block", enc.conv_block2._plain(y1.float(), (2, 2)))
        # block 1 without conv1: the f32 conv1 activation, int8 with one
        # scale, T padded with zero frames to whole chunks (the caller's
        # part, conv_block.py:741-749)
        w1, (a1, c1), w2, ab2 = b1w
        conv1 = torch.nn.functional.conv2d(
            x1.float()[:, None], w1.permute(3, 2, 0, 1), padding=1)
        act = torch.relu(conv1.permute(0, 2, 3, 1) * a1 + c1)
        xs = over127(act.amax())
        tp = -(-t1 // 48) * 48
        aq = torch.nn.functional.pad(_quant_i8(act, 1.0 / xs),
                                     (0, 0, 0, 0, 0, tp - t1)).contiguous()
        a16 = torch.nn.functional.pad(act.to(torch.bfloat16),
                                      (0, 0, 0, 0, 0, tp - t1)).contiguous()
    # each mode's weights laid out once, as the routes keep them
    prep = {
        ("b1", q): conv_block1_pair.kernel_weights(*b1w, q)
        for q in ("conv1", True, False)}
    prep.update({("b1s", q): block1_small.prepare(*b1w, q)
                 for q in (True, False)})
    prep.update({("c2", q): pair_conv_pool.prepare(
        None, None, w2, ab2, q, xs if q else None) for q in (True, False)})
    prep.update({("b2", q): conv_block.kernel_weights(*b2w, q)
                 for q in (True, False)})
    prep.update({("b2s", q): block2_small.prepare(*b2w, q)
                 for q in (True, False)})
    tc2 = conv_block_pair.pick_tc_pair(t2, 16, 128, True)
    routed1 = {"routed_conv_block1_pair": lambda: (
        conv_block1_pair.fused_block1_pair(x1, *b1w,
                                           prepared=prep["b1", "conv1"]))}
    routed2 = {"routed_conv_block_pair": lambda: (
        conv_block_pair.fused_block2_pair(y1, *b2w, quantize=True, tc=tc2,
                                          prepared=prep["b2", True]))}

    def both(kern, plain, **kw):
        # (kernel, plain) in int8 and in the bf16 mode
        return dict(kernel=lambda: kern(True), plain=lambda: plain(True),
                    bf16=(lambda: kern(False), lambda: plain(False)), **kw)

    mk = 2.0 * clips * 64 * 576 * 64          # block 1's conv2 per frame
    pos2 = clips * t2 * 32
    b1_in = x1.numel() * 2 + _wbytes(b1w)
    b2_in = y1.numel() * 2 + _wbytes(b2w)
    b1_ops = {"int8": 2.0 * clips * t1 * 64 * 9 * 64 + mk * (t1 // 2 * 2)}
    b2_ops = {"int8": 2.0 * pos2 * 576 * 128 + 2.0 * pos2 * 1152 * 128}

    def pair(run, plain, name, w, x16, with_row3=None, **kw):
        # row 5: the second design (the route) held to its plain version
        # and the first, both timed in turns (beside row 3 on the same
        # input for the full block) and traced by launch
        fns = {(d, q): functools.partial(run, fn, q) for q in (True, False)
               for d, fn in (
                   ("v2", pair_conv_pool.fused_pair_conv_pool),
                   ("v1", pair_conv_pool._fused_pair_conv_pool_v1))}
        return _design(
            kernel=fns["v2", True], plain=lambda: plain(True),
            bf16=(fns["v2", False], lambda: plain(False)),
            check=_held_to_v1(fns["v1", True], name),
            source="pair_conv_pool_v2.cu", replaces="conv_block.py:691",
            tolerance=_DESIGN_TOL + "; int8 max_abs == 0 to the first "
                      "design (pair_conv_pool.cu)",
            trace=True, designs=lambda: _redesigned(
                fns, PAIR_KERNELS[name], lambda: plain(False),
                _block_chain(w, (2, 2)), x16, with_direct9=with_row3,
                beside="row3"),
            v1_source="texttoaudiogrounding_tpu_torch/csrc/"
                      "pair_conv_pool.cu", **kw)

    # row 7: the second design (the route) held to its plain version and
    # the first; both timed in turns beside row 2's all-int8 / bf16 modes
    tc7 = block1_small.default_tc(t1)
    b1s = {(d, q): functools.partial(fn, x1, *b1w, quantize=q,
                                     prepared=prep["b1s", q])
           for q in (True, False)
           for d, fn in (("v2", block1_small.fused_block1),
                         ("v1", block1_small._fused_block1_v1))}

    def b1s_plain(q):
        return block1_small.block1_small_plain(x1, *b1w, quantize=q, tc=tc7)

    row2_modes = {q: functools.partial(
        conv_block1_pair.fused_block1_pair, x1, *b1w, quantize=q, tc=48,
        prepared=prep["b1", q]) for q in (True, False)}

    # row 6: row 3's second design at row 6's chunk and divided weights,
    # held to the plain version and to row 3's first design there, also at
    # odd T (a ragged last chunk at tc 2)
    tc6 = block2_small.default_tc(t2)
    b2s = {("v2", q): functools.partial(block2_small.fused_block2, y1, *b2w,
                                        quantize=q, prepared=prep["b2s", q])
           for q in (True, False)}
    b2s.update({("v1", q): functools.partial(
        conv_block_pair._launch_v1, y1, prep["b2s", q], q, tc6)
        for q in (True, False)})

    def b2s_plain(x, q, tc):
        return conv_block_pair.block2_plain(x, *b2w, quantize=q, tc=tc,
                                            divide=True)

    def row6_check(out, target):
        errs = _held_to_v1(b2s["v1", True], "block2_small")(out, target)
        odd = y1[:4, :499].contiguous()
        tco = block2_small.default_tc(odd.shape[1])
        got = block2_small.fused_block2(odd, *b2w, prepared=prep["b2s", True])
        vs_plain = _err(got, b2s_plain(odd, True, tco))[0]
        vs_v1 = _err(got, conv_block_pair._launch_v1(
            odd, prep["b2s", True], True, tco))[0]
        if tco != 2 or vs_plain or vs_v1:
            raise AssertionError(f"block2_small at T = 499 (tc {tco}): "
                                 f"max_abs {vs_plain} to its plain version, "
                                 f"{vs_v1} to the first design")
        return {**errs, "odd_t": {"shape": list(odd.shape), "tc": tco,
                                  "max_abs_err": vs_plain,
                                  "v1_max_abs_err": vs_v1}}

    def row2(mode, line):
        def first():
            return conv_block1_pair._fused_block1_pair_v1(
                x1, *b1w, quantize=True, tc=48, mode=mode,
                prepared=prep["b1", True])

        def check(out, target):
            # bit for bit to the plain version and to the first design
            errs = _bit_exact(out, target)
            vs_v1 = _err(out, first())[0]
            if vs_v1 != 0.0:
                raise AssertionError(f"differs from the first design: "
                                     f"max_abs {vs_v1}")
            return {**errs, "v1_max_abs_err": vs_v1}

        return _design(**both(
            lambda q: conv_block1_pair.fused_block1_pair(
                x1, *b1w, quantize=q, tc=48, mode=mode,
                prepared=prep["b1", q]),
            lambda q: conv_block1_pair.block1_plain(
                x1, *b1w, quantize=q, tc=48, mode=mode),
            ref=f32_1, ops=b1_ops, in_bytes=b1_in,
            source="conv_block1_v2.cu", check=check,
            tolerance=_DESIGN_TOL + "; int8 max_abs == 0 to the first "
                      "design (conv_block1_pair.cu)",
            replaces=f"conv_block1_pair.py:{line}", beside=routed1,
            timed={"v1": first}, input_shape=list(x1.shape)))

    return {
        "conv_block1_pair_int8": row2("triple", 346),
        "conv_block1_pair_single": row2("single", 239),
        "block1_small": _design(
            kernel=b1s["v2", True], plain=lambda: b1s_plain(True),
            bf16=(b1s["v2", False], lambda: b1s_plain(False)),
            check=_held_to_v1(b1s["v1", True], "block1_small"),
            ref=f32_1, ops={"bf16": 2.0 * clips * t1 * 64 * 9 * 64,
                            "int8": mk * (t1 // 2 * 2)},
            in_bytes=b1_in, source="block1_small_v2.cu",
            replaces="conv_block_small.py:471", beside=routed1,
            tolerance=_DESIGN_TOL + "; int8 max_abs == 0 to the first "
                      "design (block1_small.cu)",
            trace=True, designs=lambda: _redesigned(
                b1s, BLOCK1_KERNELS, lambda: b1s_plain(False),
                _block_chain(b1w, (2, 2)), x1[..., None],
                with_direct9=row2_modes, beside="row2"),
            input_shape=list(x1.shape), tc=block1_small.default_tc(t1),
            v1_source="texttoaudiogrounding_tpu_torch/csrc/block1_small.cu"),
        "pair_conv_pool_conv2": pair(
            lambda design, q: design(
                aq if q else a16, None, None, w2, ab2, quantize=q,
                x_scale=xs if q else None, prepared=prep["c2", q]),
            lambda q: pair_conv_pool.pair_conv_pool_plain(
                aq if q else a16, None, None, w2, ab2, quantize=q,
                tc=pair_conv_pool.pick_tc(tp, 32, 2),
                x_scale=xs if q else None),
            "pair_conv_pool_conv2", (None, None, w2, ab2), a16,
            ref=f32_1, ops={"int8": mk * tp},
            in_bytes=aq.numel() + 4 * (w2.numel() + 2 * 64),
            beside=routed1, input_shape=list(aq.shape)),
        "block2_small": _design(
            kernel=b2s["v2", True], plain=lambda: b2s_plain(y1, True, tc6),
            bf16=(b2s["v2", False], lambda: b2s_plain(y1, False, tc6)),
            check=row6_check, ref=f32_2, ops=b2_ops, in_bytes=b2_in,
            source="conv_block_v2.cu", replaces="conv_block_small.py:291",
            tolerance=_DESIGN_TOL + "; int8 max_abs == 0 to the first "
                      "design (conv_block_pair.cu at row 6's chunk and "
                      "weights), also at odd T (4 clips x 499 frames, tc 2)",
            trace=True, designs=lambda: _redesigned(
                b2s, ROW6_KERNELS, lambda: b2s_plain(y1, False, tc6),
                _block_chain(b2w, (2, 2)), y1),
            beside=routed2, input_shape=list(y1.shape), tc=tc6,
            v1_source="texttoaudiogrounding_tpu_torch/csrc/"
                      "conv_block_pair.cu"),
        "pair_conv_pool": pair(
            lambda design, q: design(y1, *b2w, quantize=q,
                                     prepared=prep["b2", q]),
            lambda q: pair_conv_pool.pair_conv_pool_plain(
                y1, *b2w, quantize=q, tc=pair_conv_pool.pick_tc(t2, 16, 2)),
            "pair_conv_pool", b2w, y1, ref=f32_2, ops=b2_ops,
            in_bytes=b2_in, beside=routed2, input_shape=list(y1.shape),
            with_row3={q: lambda q=q: conv_block_pair.fused_block2_pair(
                y1, *b2w, quantize=q, tc=tc2 if q else None,
                prepared=prep["b2", q]) for q in (True, False)}),
    }


# row 7's kernels a call: second design (int8: the max pass, the quantize
# pass, conv2; bf16: conv1 and conv2), first design (int8: the im2col's five
# PyTorch kernels, conv1, the requantize pass, conv2; bf16 without the
# requantize pass)
BLOCK1_KERNELS = {("v2", True): 3, ("v2", False): 2, ("v1", True): 8,
                  ("v1", False): 7}
# row 6's: row 3's designs (second: the x window maxes, the quantize pass,
# conv1, the y1 requantization, conv2; bf16 the pad pass and the two
# convs; first: the gather, conv1, the requantization, conv2; bf16 the
# gather and the two convs)
ROW6_KERNELS = {("v2", True): 5, ("v2", False): 3, ("v1", True): 4,
                ("v1", False): 3}
# row 5's kernels a call: second design (int8: the x window maxes, the
# quantize pass, conv1, the y1 requantization, conv2; bf16: the pad pass
# and the two convs; conv2 alone one GEMM), first design (int8: the
# gather, conv1, the y1 requantization, conv2; bf16: the gather and the
# two convs; conv2 alone one)
PAIR_KERNELS = {
    "pair_conv_pool": {("v2", True): 5, ("v2", False): 3, ("v1", True): 4,
                       ("v1", False): 3},
    "pair_conv_pool_conv2": {("v2", True): 1, ("v2", False): 1,
                             ("v1", True): 1, ("v1", False): 1}}


def _single_loud_frame(x1, b1w) -> dict:
    """Row 2's single staging on 4 clips of x1 made quiet, with one loud
    frame at t = 98: y1 at t = 97 lies in chunk 1's single window [46, 97]
    (tc = 48) and not in the triple window [47, 96], and it sets the
    chunk's y1 scale.  The kernel must equal its plain version bit for bit
    and differ from the triple staging's kernel."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block1_pair

    x = (x1[:4].float() * 0.05)
    x[:, 98] = 5.0
    x = x.to(x1.dtype).contiguous()
    single = conv_block1_pair.fused_block1_pair(x, *b1w, quantize=True,
                                                mode="single")
    plain = conv_block1_pair.block1_plain(x, *b1w, quantize=True,
                                          mode="single")
    triple = conv_block1_pair.fused_block1_pair(x, *b1w, quantize=True)
    max_abs = _err(single, plain)[0]
    vs_triple = _err(single, triple)[1]
    if max_abs != 0.0 or vs_triple < 1e-3:
        raise AssertionError(f"row 2 single, loud frame: max_abs to its "
                             f"plain version {max_abs} (must be 0), "
                             f"relative RMS to the triple staging "
                             f"{vs_triple} (must reach 1e-3)")
    return {"max_abs_err": max_abs, "rel_rms_vs_triple": vs_triple}


def _log_mel_f64(wave, cfg):
    """The log-mel in float64 (reflect-padded frames, the windowed DFT,
    the slaney mel), the reference of the log-mel rows."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops import frontend
    frames = frontend.frame_waveform(wave.double(), cfg)
    basis = torch.from_numpy(frontend._dft_kernel(cfg)).to(wave.device)
    spec = torch.matmul(frames, basis.double())
    nf = cfg.n_freqs
    power = spec[..., :nf] ** 2 + spec[..., nf:] ** 2
    fb = torch.from_numpy(frontend.mel_filterbank(cfg)).to(wave.device)
    mel = torch.matmul(power, fb.double())
    return 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin))


def _block_chain(w, pool):
    """A block's bf16 mode as a PyTorch chain on ``[B, T, M, C]``: cuDNN
    bf16 ``F.conv2d``, the BN affine and ReLU, again, then ``avg_pool2d +
    max_pool2d`` at ``pool``; a yardstick that the port never calls.
    With ``w1`` None (``w = (None, None, w2, ab2)``) conv2 alone."""
    import torch
    import torch.nn.functional as F
    w1, ab1, w2, ab2 = w
    k2 = w2.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
    aff = [(a.to(torch.bfloat16)[:, None, None], b.to(torch.bfloat16)[
        :, None, None]) for a, b in (ab1 or ab2, ab2)]
    if w1 is not None:
        k1 = w1.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()

    def chain(x):
        y = x.permute(0, 3, 1, 2)
        if w1 is not None:
            y = F.conv2d(y, k1, padding=1)
            y = torch.relu(y * aff[0][0] + aff[0][1])
        y = F.conv2d(y, k2, padding=1)
        y = torch.relu(y * aff[1][0] + aff[1][1])
        return (F.avg_pool2d(y, pool) + F.max_pool2d(y, pool)).permute(
            0, 2, 3, 1)
    chain.label = (f"cuDNN bf16 F.conv2d -> affine -> ReLU"
                   f"{'' if w1 is None else ', twice'} -> avg_pool2d + "
                   f"max_pool2d")
    return chain


def _kernel_launches(trace: dict) -> int:
    """The kernels of a by-launch trace (memsets and copies left out)."""
    return sum(1 for e in trace["by_launch"]
               if not e["kernel"].startswith(("Memset", "Memcpy")))


def _redesigned(fns: dict, launches: dict, plain16, chain, x,
                with_direct9=None, beside: str = "direct9") -> dict:
    """A redesigned row's two designs ``fns`` {(design, int8?): fn}: timed
    in turns (v1 v2 v2 v1, with ``with_direct9`` {int8?: fn}, the kernel
    named ``beside``, as v1 v2 d9 d9 v2 v1) in int8 and bf16; each traced
    by launch, its kernels a call counted by the profiler and held to
    ``launches`` {(design, int8?): n}; the first design's bf16 mode held
    within 1e-2 relative RMS of its plain version ``plain16()``; and the
    cuDNN bf16 chain on ``x``."""
    out, counts = {}, {}
    for q, key in ((True, ""), (False, "bf16_")):
        fq = {d: fns[d, q] for d in ("v1", "v2")}
        order = ("v1", "v2")
        if with_direct9:
            fq[beside], order = with_direct9[q], ("v1", "v2", beside)
        t = _turns(fq, order)
        out.update({f"{key}ms": t["v2"], f"v1_{key}ms": t["v1"],
                    f"{key}turns_ms": t["runs"]})
        if with_direct9:
            out[f"{beside}_{key}turns_mean_ms"] = t[beside]
        for d in ("v2", "v1"):
            tr = _trace(fq[d], t[d], by_launch=True)
            out[f"{d}_{key}trace"] = tr
            counts[f"{d}_{key or 'int8_'}kernels"] = _kernel_launches(tr)
            counts[f"{d}_{key or 'int8_'}device_events"] = tr["launches"]
    want = {f"{d}_{'int8_' if q else 'bf16_'}kernels": n
            for (d, q), n in launches.items()}
    got = {k: v for k, v in counts.items() if k.endswith("kernels")}
    if got != want:
        raise AssertionError(f"kernels a call {got}, expected {want}")
    v1_16 = _err(fns["v1", False](), plain16())[1]
    if v1_16 > 1e-2:
        raise AssertionError(f"the first design's bf16 mode: rel_rms "
                             f"{v1_16} to its plain version > 0.01")
    return {**out, "launches_per_call": counts,
            "v1_bf16_rel_rms_err": v1_16,
            "chain_ms": _cuda_ms(lambda: chain(x), 10),
            "chain": chain.label,
            "chain_rel_rms_vs_bf16_plain": _err(chain(x), plain16())[1]}


def _held_to_v1(first, name: str):
    """A check of the counted run against its plain version (bit for bit),
    the first design ``first()`` against both (int8)."""
    def check(out, target):
        v1 = first()
        vs_v1, v1_plain = _err(out, v1)[0], _err(v1, target)[0]
        if vs_v1 or v1_plain:
            raise AssertionError(f"{name}: the first design differs from "
                                 f"the second ({vs_v1}) or from the plain "
                                 f"version ({v1_plain})")
        return {**_bit_exact(out, target), "v1_max_abs_err": vs_v1,
                "v1_vs_plain_max_abs_err": v1_plain}
    return check


# row 8 at the pool-(2, 2) analog of blocks 3-4 (scripts/bench_wino.py):
# (block, Cin, Cout, the bf16 chunk where the JAX rule finds none)
WINO_BLOCKS = ((3, 128, 256, None), (4, 256, 512, 14))
# kernels a call: second design (int8: a scale pass, the V_k pass and the
# product kernel a conv; bf16 the last two), first design (transform,
# products, output transform a conv)
WINO_KERNELS = {("v2", True): 6, ("v2", False): 4, ("v1", True): 6,
                ("v1", False): 6}


def _wino_designs(enc, y2) -> tuple:
    """Row 8 through ``ConvBlock(..., wino=True)`` in int8, with the served
    blocks 3-4 weights, at the pool-(2, 2) analog of blocks 3-4: on the
    served block-2 output (block 3, 128 -> 256) and on that result (block 4,
    256 -> 512); one record per block, on its second design
    (``conv_block_wino_v2.cu``), held bit for bit to its plain version and
    to the first design (``conv_block_wino.cu``, itself held to the plain
    version), both timed in turns in int8 and bf16 and traced by launch,
    beside the direct9 kernel (row 4) at pool (2, 2) on the same input and
    the cuDNN bf16 chain.  Bound by the Winograd products' operations (16
    per 2 x 2 output tile and conv), the least the function needs: its
    int8 result is fixed by the per-(k, chunk) scales of V_k, which a
    direct conv does not have; the direct conv's count, the yardstick of
    rows 2-7, is printed beside it, and the byte floor of the design (x,
    V_k and y1 written and read, the output).  Returns (records, the
    route's outputs)."""
    import torch

    from texttoaudiogrounding_tpu_torch.models.layers import ConvBlock
    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        conv_block, conv_block_wino)

    records, outs, x = {}, {}, y2
    for i, cin, cout, tc16 in WINO_BLOCKS:
        name = f"conv_block_wino_block{i}"
        blk = ConvBlock(cin, cout, "int8", wino=True).to(DEVICE).eval()
        blk.load_state_dict(getattr(enc, f"conv_block{i}").state_dict())
        with torch.no_grad():
            outs[name] = blk(x, (2, 2))
            f32 = getattr(enc, f"conv_block{i}")._plain(x.float(), (2, 2))
        w = _block_weights(blk)
        b, t, m, _ = x.shape
        tpad, tc = conv_block_wino.pick_tpad_tc(t, m, cin, cout, True)
        tpad16, tc16 = conv_block_wino.chunking(t, m, cin, cout, False, tc16)
        wq, w16 = (conv_block_wino.wino_weights(*w, q) for q in (True, False))
        dq, d16 = (conv_block.kernel_weights(*w, q) for q in (True, False))
        pos = b * t * m
        direct_ops = 2.0 * pos * 9 * (cin * cout + cout * cout)
        wino_ops = 2.0 * (pos // 4) * 16 * (cin * cout + cout * cout)
        in_bytes = x.numel() * 2 + _wbytes(w)
        nbytes = in_bytes + outs[name].numel() * 2
        g, mp = b * tpad // tc, m // 2
        tiles = g * (tc // 2 + 2) * mp, g * tc // 2 * mp
        y1_bytes = g * (tc + 4) * m * cout * 2
        v_bytes = 16 * (tiles[0] * cin + tiles[1] * cout)   # int8
        fns = {
            ("v2", True): lambda x=x, w=w, p=wq: (
                conv_block_wino.fused_block_wino(x, *w, quantize=True,
                                                 prepared=p)),
            ("v1", True): lambda x=x, w=w, p=wq: (
                conv_block_wino._fused_block_wino_v1(x, *w, quantize=True,
                                                     prepared=p)),
            ("v2", False): lambda x=x, w=w, tc=tc16, p=w16: (
                conv_block_wino.fused_block_wino(x, *w, tc=tc, prepared=p)),
            ("v1", False): lambda x=x, w=w, tc=tc16, p=w16: (
                conv_block_wino._fused_block_wino_v1(x, *w, tc=tc,
                                                     prepared=p))}
        plain16 = (lambda x=x, w=w, tc=tc16, tp=tpad16, p=w16:
                   conv_block_wino.block_wino_plain(
                       x, *w, quantize=False, tc=tc, tpad=tp, prepared=p))
        records[name] = _design(
            kernel=fns["v2", True],
            plain=lambda x=x, w=w, tc=tc, tp=tpad, p=wq: (
                conv_block_wino.block_wino_plain(
                    x, *w, quantize=True, tc=tc, tpad=tp, prepared=p)),
            check=_held_to_v1(fns["v1", True], name),
            bf16=(fns["v2", False], plain16),
            ref=("f32_block", f32), ops={"int8": wino_ops},
            in_bytes=in_bytes, source="conv_block_wino_v2.cu",
            replaces="conv_block_wino.py:264", counter="conv_block_wino",
            beside={
                "direct9": lambda x=x, w=w, p=dq: (
                    conv_block.fused_double_conv_pool(
                        x, *w, (2, 2), quantize=True, prepared=p)),
                "direct9_bf16": lambda x=x, w=w, p=d16: (
                    conv_block.fused_double_conv_pool(x, *w, (2, 2),
                                                      prepared=p))},
            timed={"weights": lambda w=w: conv_block_wino.wino_weights(
                *w, True)},
            trace=True,
            designs=lambda fns=fns, plain16=plain16, x=x, w=w: _redesigned(
                fns, WINO_KERNELS, plain16, _block_chain(w, (2, 2)), x),
            input_shape=list(x.shape), cin=cin, cout=cout,
            tc=tc, tpad=tpad, bf16_tc=tc16, winograd_ops=wino_ops,
            direct_ops=direct_ops,
            direct_bound_ms=_bound(nbytes, {"int8": direct_ops})[0],
            direct_bf16_bound_ms=_bound(nbytes, {"bf16": direct_ops})[0],
            byte_floor_ms=(nbytes + 2 * y1_bytes + 2 * v_bytes) / HBM * 1e3,
            v_bytes=v_bytes, y1_bytes=y1_bytes,
            v1_source="texttoaudiogrounding_tpu_torch/csrc/"
                      "conv_block_wino.cu")
        x = outs[name]
    return records, outs


# row 4's tap modes at the flagship's blocks 3-4, pool (1, 2): (block,
# Cin, Cout)
SLAB_BLOCKS = ((3, 128, 256), (4, 256, 512))
# kernels a call: second designs (int8: the x maxes, the quantize pass,
# conv1, the y1 requantization, conv2; bf16: the pad pass and the two
# convs), first design (int8: the quantize pass, conv1, the y1
# requantization, conv2; bf16 the two convs, mel3 after a gather pass)
SLAB_KERNELS = {
    "tri": {("v2", True): 5, ("v2", False): 3, ("v1", True): 4,
            ("v1", False): 2},
    "mel3": {("v2", True): 5, ("v2", False): 3, ("v1", True): 4,
             ("v1", False): 3}}


def _slab_designs(enc, y2) -> tuple:
    """Row 4's mel3 and tri modes, each (True, True), with the served
    blocks 3-4 weights at the flagship's pool (1, 2): on the served block-2
    output (block 3) and on the mode's own block-3 output (block 4); one
    record per mode and block, int8 at the mode's own JAX chunk and its
    bf16 mode at its own, beside direct9 (row 4) on the same input, each
    with its weights laid out once.  Both run their second designs, the
    wgmma GEMM's slab form (``conv_block_mel3_v2.cu``,
    ``conv_block_tri_v2.cu``), held bit for bit to the plain version and
    to the first design (the slab kernel of ``conv_block_mel3.cu``, itself
    held to the plain version); tri also to direct9 at tri's chunk and at
    direct9's own (its scales are direct9's); mel3 also in its (True,
    False) mode, and in bf16 bit for bit to tri (the same function at the
    same chunk); the designs timed in turns beside direct9 at the mode's
    chunk and traced by launch, beside the cuDNN bf16 chain.  Bound by the
    direct conv's operations, all of which both do.  Returns (records, the
    outputs of the counted run)."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import conv_block as cb

    records, outs = {}, {}
    for mode in ("mel3", "tri"):
        x = y2
        for i, cin, cout in SLAB_BLOCKS:
            name = f"conv_block_{mode}_block{i}"
            blk = getattr(enc, f"conv_block{i}")
            w = _block_weights(blk)
            kw = {mode: (True, True)}
            pq, p16 = (cb.kernel_weights(*w, q) for q in (True, False))
            modes = {q: cb.tap_modes(cin, q, **kw) for q in (True, False)}
            tcs = {q: cb.block_tc(x.shape, cout, (1, 2), q, modes[q])
                   for q in (True, False)}
            d9_tc = {q: cb.block_tc(x.shape, cout, (1, 2), q, (False,) * 4)
                     for q in (True, False)}
            outs[name] = cb.fused_double_conv_pool(
                x, *w, (1, 2), quantize=True, prepared=pq, **kw)
            with torch.no_grad():
                f32 = blk._plain(x.float(), (1, 2))
            b, t, m, _ = x.shape
            ops = 2.0 * b * t * m * 9 * (cin * cout + cout * cout)

            def run(q, x=x, w=w, kw=kw, pq=pq, p16=p16, **over):
                return cb.fused_double_conv_pool(
                    x, *w, (1, 2), quantize=q, prepared=pq if q else p16,
                    **{**kw, **over})

            def plain(q, x=x, w=w, modes=modes, tcs=tcs):
                return cb.block_plain(x, *w, (1, 2), quantize=q, tc=tcs[q],
                                      modes=modes[q])

            first_fn = {"mel3": cb._fused_mel3_v1,
                        "tri": cb._fused_tri_v1}[mode]

            def first(q, x=x, w=w, pq=pq, p16=p16, first_fn=first_fn,
                      **over):
                return first_fn(x, *w, (1, 2), quantize=q,
                                prepared=pq if q else p16, **over)

            if mode == "tri":
                def check(out, target, run=run, tc=d9_tc[True],
                          tri_tc=tcs[True], name=name, first=first):
                    errs = _held_to_v1(lambda: first(True), name)(out,
                                                                  target)
                    same_tc = _err(out, run(True, tri=None, tc=tri_tc))[0]
                    got = run(True, tc=tc)
                    same = _err(got, run(True, tri=None, tc=tc))[0]
                    if same or same_tc:
                        raise AssertionError(
                            f"{name}: tri differs from the row-4 kernel at "
                            f"tri's tc {tri_tc} ({same_tc}) or at direct9's "
                            f"tc {tc} ({same})")
                    return {**errs, "vs_direct9_at_tri_tc_max_abs": same_tc,
                            "vs_direct9_at_its_tc_max_abs": same}
            else:
                def check(out, target, run=run, name=name, first=first,
                          x=x, w=w, cin=cin, cout=cout):
                    errs = _held_to_v1(lambda: first(True), name)(out,
                                                                  target)
                    # (True, False): f32 y1 and direct9's conv2
                    tf = cb.tap_modes(cin, True, (True, False))
                    got = run(True, mel3=(True, False))
                    tf_plain = _err(got, cb.block_plain(
                        x, *w, (1, 2), quantize=True, modes=tf,
                        tc=cb.block_tc(x.shape, cout, (1, 2), True, tf)))[0]
                    tf_v1 = _err(got, first(True, mel3=(True, False)))[0]
                    # bf16: tri's function at tri's chunk, tri's launches
                    vs_tri = _err(run(False), run(False, mel3=None,
                                                  tri=(True, True)))[0]
                    if tf_plain or tf_v1 or vs_tri:
                        raise AssertionError(
                            f"{name}: mel3 (True, False) differs from its "
                            f"plain version ({tf_plain}) or first design "
                            f"({tf_v1}), or bf16 mel3 from bf16 tri "
                            f"({vs_tri})")
                    return {**errs, "tf_max_abs_err": tf_plain,
                            "tf_v1_max_abs_err": tf_v1,
                            "bf16_vs_tri_max_abs": vs_tri}
            fns = {(d, q): (lambda run=run, q=q: run(q)) if d == "v2"
                   else (lambda first=first, q=q: first(q))
                   for d in ("v2", "v1") for q in (True, False)}
            d9 = {q: (lambda run=run, q=q, tc=tcs[q]: run(
                q, mel3=None, tri=None, tc=tc)) for q in (True, False)}
            records[name] = _design(
                kernel=lambda run=run: run(True),
                plain=lambda plain=plain: plain(True),
                bf16=(lambda run=run: run(False),
                      lambda plain=plain: plain(False)),
                ref=("f32_block", f32), ops={"int8": ops},
                in_bytes=x.numel() * 2 + _wbytes(w),
                source=f"conv_block_{mode}_v2.cu",
                replaces="conv_block.py:370",
                counter=f"conv_block_{mode}", check=check,
                beside={"direct9": lambda run=run: run(True, mel3=None,
                                                       tri=None),
                        "direct9_bf16": lambda run=run: run(
                            False, mel3=None, tri=None)},
                trace=True, input_shape=list(x.shape), cin=cin, cout=cout,
                mode=f"{mode}=(True, True)", tc=tcs[True],
                bf16_tc=tcs[False], direct9_tc=d9_tc[True],
                direct9_bf16_tc=d9_tc[False],
                designs=lambda fns=fns, plain=plain, x=x, w=w, d9=d9,
                kernels=SLAB_KERNELS[mode]: _redesigned(
                    fns, kernels, lambda: plain(False),
                    _block_chain(w, (1, 2)), x, with_direct9=d9),
                v1_source="texttoaudiogrounding_tpu_torch/csrc/"
                          "conv_block_mel3.cu")
            x = outs[name]
    return records, outs


def _v3_check(wave, cfg, t_lo: int, t_hi: int):
    """Row 9's check: within V3_MAX_DB max and V3_MEAN_DB mean of its plain
    version, while row 1's first design (f32 mel; the tile code row 9
    shares) on the interior frames must miss those limits (the control:
    they tell the two projections apart)."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import logmel

    def check(out, plain) -> dict:
        d = (out - plain).abs()
        row1 = logmel._fused_log_mel_spectrogram_v1(wave, cfg)
        ctl = (row1 - plain)[:, t_lo:t_hi].abs()
        got = {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
               "rel_rms_err": _err(out, plain)[1],
               "control_row1_max_abs_err": float(ctl.max()),
               "control_row1_mean_abs_err": float(ctl.mean())}
        if got["max_abs_err"] > V3_MAX_DB or got["mean_abs_err"] > V3_MEAN_DB:
            raise AssertionError(f"off its plain version: {got}")
        if (got["control_row1_max_abs_err"] <= V3_MAX_DB
                and got["control_row1_mean_abs_err"] <= V3_MEAN_DB):
            raise AssertionError(f"row 1's kernel meets v3's limits, which "
                                 f"so do not hold its bf16 mel: {got}")
        return got
    return check


# row 9's kernels a call: the second design's cast pass and its one launch
# of tiles and edge blocks
V3_KERNELS = 2
V3_EDGE_DB = 2e-3     # the edge frames against _edge_frames (f32 sums)


def _v3_designs(wave, cfg, t_lo: int, t_hi: int, row1: dict) -> dict:
    """Row 9's two designs timed in turns beside row 1 (v1 v2 row1 row1 v2
    v1), each traced by launch (the second must make V3_KERNELS kernels a
    call), the first design held by :func:`_v3_check` too, and the
    ``torch.stft`` chain beside."""
    from texttoaudiogrounding_tpu_torch.ops.kernels import logmel_v3

    fns = {"v1": lambda: logmel_v3._fused_log_mel_spectrogram_v3_v1(wave,
                                                                   cfg),
           "v2": lambda: logmel_v3.fused_log_mel_spectrogram_v3(wave, cfg),
           "row1": row1["row1"]}
    t = _turns(fns, ("v1", "v2", "row1"))
    traces = {f"{d}_trace": _trace(fns[d], t[d], by_launch=True)
              for d in ("v2", "v1")}
    kernels = {d: _kernel_launches(traces[f"{d}_trace"]) for d in ("v2", "v1")}
    if kernels["v2"] != V3_KERNELS:
        raise AssertionError(f"logmel_v3: {kernels['v2']} kernels a call, "
                             f"expected {V3_KERNELS}")
    first = fns["v1"]()
    v1_errs = _v3_check(wave, cfg, t_lo, t_hi)(
        first, logmel_v3.log_mel_v3_plain(wave, cfg))
    chain = _logmel_chain(cfg, wave.device)
    return {"ms": t["v2"], "v1_ms": t["v1"], "row1_turns_mean_ms": t["row1"],
            "turns_ms": t["runs"], "kernels_per_call": kernels,
            "v1_max_abs_err": v1_errs["max_abs_err"],
            "v1_mean_abs_err": v1_errs["mean_abs_err"],
            "v2_vs_v1_max_abs": _err(fns["v2"](), first)[0],
            "chain_ms": _cuda_ms(lambda: chain(wave), 10),
            "chain": "torch.stft (cuFFT) -> power -> @ fb -> dB, f32",
            "v1_source": "texttoaudiogrounding_tpu_torch/csrc/logmel_v3.cu",
            **traces}


# row 10's kernels a call: the second design's pad pass and its persistent
# kernel
V4_KERNELS = 2


def _v4_designs(wave, cfg, row1: dict) -> dict:
    """Row 10's two designs timed in turns beside row 1 (v1 v2 row1 row1
    v2 v1), each traced by launch (the second must make V4_KERNELS kernels
    a call), the first design held bit for bit to row 1's first design
    (``csrc/logmel.cu``, whose tile code it shares), and the
    ``torch.stft`` chain beside."""
    from texttoaudiogrounding_tpu_torch.ops import frontend
    from texttoaudiogrounding_tpu_torch.ops.kernels import logmel, logmel_v4

    fns = {"v1": lambda: logmel_v4._fused_log_mel_spectrogram_v4_v1(wave,
                                                                   cfg),
           "v2": lambda: logmel_v4.fused_log_mel_spectrogram_v4(wave, cfg),
           "row1": row1["row1"]}
    t = _turns(fns, ("v1", "v2", "row1"))
    traces = {f"{d}_trace": _trace(fns[d], t[d], by_launch=True)
              for d in ("v2", "v1")}
    kernels = {d: _kernel_launches(traces[f"{d}_trace"]) for d in ("v2", "v1")}
    if kernels["v2"] != V4_KERNELS:
        raise AssertionError(f"logmel_v4: {kernels['v2']} kernels a call, "
                             f"expected {V4_KERNELS}")
    first = fns["v1"]()
    v1_vs_row1 = _err(first, row1["row1_v1"]())[0]
    if v1_vs_row1 != 0.0:
        raise AssertionError(f"logmel_v4's first design differs from row "
                             f"1's first design: max_abs {v1_vs_row1}")
    b, n = wave.shape
    tiles = b * -(-frontend.num_frames(n, cfg.hop_length) // logmel._TILE_V2)
    chain = _logmel_chain(cfg, wave.device)
    return {"ms": t["v2"], "v1_ms": t["v1"], "row1_turns_mean_ms": t["row1"],
            "turns_ms": t["runs"], "kernels_per_call": kernels,
            "v1_max_abs_vs_row1_v1": v1_vs_row1,
            "v2_vs_v1_max_abs": _err(fns["v2"](), first)[0],
            "tiles": tiles,
            "persistent_blocks": logmel_v4._grid(wave.device, tiles),
            "chain_ms": _cuda_ms(lambda: chain(wave), 10),
            "chain": "torch.stft (cuFFT) -> power -> @ fb -> dB, f32",
            "v1_source": "texttoaudiogrounding_tpu_torch/csrc/logmel_v4.cu",
            **traces}


def _logmel_designs(wave) -> tuple:
    """Rows 9 and 10 once on the served waveform, beside row 1's two
    designs: v3 on its second design (``logmel_v3_v2.cu``) held by
    :func:`_v3_check`, its edge frames within V3_EDGE_DB of the plain
    frontend's (``_edge_frames``), timed in turns with its first design
    (``logmel_v3.cu``) beside row 1; v4 on its second design
    (``logmel_v4_v2.cu``) bit for bit to row 1's second design
    (``csrc/logmel_v2.cu``), timed in turns with its first design by
    :func:`_v4_designs`; each compared with the f64 log-mel.  Returns
    (records, outputs)."""
    from texttoaudiogrounding_tpu_torch.ops import frontend
    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        logmel, logmel_v3, logmel_v4)

    cfg = frontend.cnn8rnn_mel_config(SR)
    outs = {"logmel_v3": logmel_v3.fused_log_mel_spectrogram_v3(wave, cfg),
            "logmel_v4": logmel_v4.fused_log_mel_spectrogram_v4(wave, cfg)}
    b, n = wave.shape
    t = outs["logmel_v3"].shape[1]
    t_lo, t_hi = logmel_v3.edges(n, cfg)
    frames = b * (t_hi - t_lo)
    ref = ("f64", _log_mel_f64(wave, cfg))
    row1 = {"row1_v1": lambda: logmel._fused_log_mel_spectrogram_v1(wave,
                                                                     cfg),
            "row1": lambda: logmel.fused_log_mel_spectrogram(wave, cfg)}
    dft, _, mel = _logmel_ops(cfg, frames)        # v3: interior frames
    edge = _logmel_ops(cfg, b * (t - t_hi + t_lo))  # its f32 edge frames
    dft4, power4, mel4 = _logmel_ops(cfg, b * t)

    def v3_check(out, plain):
        errs = _v3_check(wave, cfg, t_lo, t_hi)(out, plain)
        left, right = logmel_v3._edge_frames(wave, cfg, t_lo, t_hi)
        got = max(float((out[:, :t_lo] - left).abs().max()),
                  float((out[:, t_hi:] - right).abs().max()))
        if got > V3_EDGE_DB:
            raise AssertionError(f"edge frames {got} dB off _edge_frames")
        return {**errs, "edge_max_abs_err": got}

    return {
        "logmel_v3": _design(
            kernel=lambda: logmel_v3.fused_log_mel_spectrogram_v3(wave, cfg),
            plain=lambda: logmel_v3.log_mel_v3_plain(wave, cfg), ref=ref,
            ops={"bf16": dft + mel, "f32": sum(edge)},
            in_bytes=wave.numel() * 4, source="logmel_v3_v2.cu",
            replaces="logmel.py:350", check=v3_check,
            tolerance=f"max_abs_db <= {V3_MAX_DB}, mean_abs_db <= "
                      f"{V3_MEAN_DB}; row 1's kernel must miss them; edge "
                      f"frames max_abs_db <= {V3_EDGE_DB} to _edge_frames",
            beside=row1, timed={"v1_edge_frames": lambda: (
                logmel_v3._edge_frames(wave, cfg, t_lo, t_hi))},
            designs=lambda: _v3_designs(wave, cfg, t_lo, t_hi, row1)),
        "logmel_v4": _design(
            kernel=lambda: logmel_v4.fused_log_mel_spectrogram_v4(wave, cfg),
            plain=lambda: logmel.log_mel_plain(wave, cfg), ref=ref,
            ops={"bf16": dft4, "f32": power4 + mel4},
            in_bytes=wave.numel() * 4, source="logmel_v4_v2.cu",
            replaces="logmel.py:175", target=row1["row1"],
            tolerance="bit for bit equal to row 1's second design; its "
                      "first design bit for bit equal to row 1's first",
            beside=row1, designs=lambda: _v4_designs(wave, cfg, row1)),
    }, outs


TRAIN_CLIPS, TRAIN_EPOCHS, TRAIN_STEPS, VAL_STEPS = 32, 2, 4, 2
_TONES = (400.0, 800.0, 1600.0, 3000.0, 240.0, 5000.0, 1200.0, 2200.0)


def _strong_config(exp_dir: str, **audio_args) -> dict:
    """``configs/strong/biencoder_train.yaml``'s model, loss, optimizer and
    trainer, with the epochs cut to ``TRAIN_EPOCHS`` of ``TRAIN_STEPS`` and
    ``audio_args`` added to ``audio_encoder.args``."""
    return {
        "experiment_path": exp_dir, "seed": 1,
        "model": {"type": "BiEncoder",
                  "args": {"shared_dim": 512, "add_proj": True},
                  "audio_encoder": {"type": "Cnn8Rnn",
                                    "args": {"sample_rate": SR,
                                             **audio_args}},
                  "text_encoder": {"type": "EmbeddingAgg",
                                   "args": {"vocab_size": 5000,
                                            "embed_dim": 512,
                                            "aggregation": "mean"}},
                  "match_fn": {"type": "ExpNegL2", "args": {}}},
        "loss": {"type": "FrameBceLoss", "args": {}},
        "optimizer": {"type": "Adam", "args": {"lr": 0.001}},
        "lr_scheduler": {"type": "ReduceLROnPlateau",
                         "args": {"mode": "min", "factor": 0.1,
                                  "patience": 3}},
        "trainer": {"epochs": TRAIN_EPOCHS, "epoch_length": TRAIN_STEPS,
                    "early_stop": 10, "save_interval": 1,
                    "max_grad_norm": 1.0,
                    "metric_monitor": {"mode": "min", "name": "loss"},
                    "include_optim_in_ckpt": True},
    }


def _train_data(work: Path, weak: bool = False) -> dict:
    """The ``data.train`` entry of a training config whose loaders are made
    in memory (``_loaders``, ``_weak_loaders``): the dataset's type and time
    resolution and the collate's tokenizer (``work/vocab.pkl``), which
    evaluation and ``GroundingPredictor.from_experiment`` read."""
    dataset = ({"type": "AudioSamplePhrasesDataset", "args": {}} if weak else
               {"type": "AudioPhraseDataset",
                "args": {"time_resolution": 0.04}})
    return {"train": {"dataset": dataset, "collate_fn": {
        "type": "TextCollate",
        "args": {"text_key": "phrases" if weak else "phrase",
                 "tokenizer": {"type": "DictTokenizer", "args": {
                     "vocabulary": str(work / "vocab.pkl")}}}}}}


def _clip_items(count: int, seed: int):
    """A dataset of ``AudioPhraseDataset`` items made in memory: 10 s of
    noise with a tone over one labelled segment, the phrase naming the
    tone, the waveform stored in float16 as the packed HDF5 files are."""
    import numpy as np
    from torch.utils.data import Dataset

    from texttoaudiogrounding_tpu_torch.data.datasets import frame_labels

    class Items(Dataset):
        def __len__(self):
            return count

        def __getitem__(self, i):
            rng = np.random.default_rng((seed, i))
            n = SR * CLIP_S
            wav = rng.normal(0, 0.01, n).astype(np.float32)
            k = int(rng.integers(len(_TONES)))
            on = float(rng.uniform(0.05, 0.7)) * CLIP_S
            off = on + float(rng.uniform(0.05, 0.25)) * CLIP_S
            idx = np.arange(int(on * SR), int(off * SR))
            wav[idx] += 0.3 * np.sin(2 * np.pi * _TONES[k] * idx / SR)
            return {"audio_id": f"clip{i}", "audiocap_id": i,
                    "start_index": 0, "end_index": 1,
                    "waveform": wav.astype(np.float16),
                    "phrase": f"w{2 + k} w{20 + k}",
                    "caption": f"w{2 + k} w{20 + k}",
                    "label": frame_labels(n, [[on, off]], SR, 0.04)}

    return Items()


def _grads(model, batch, output_transform, loss_fn) -> dict:
    """Every parameter's gradient of one train-mode step on ``batch``."""
    model.train()
    model.zero_grad(set_to_none=True)
    loss_fn(output_transform(model(batch), batch)).backward()
    return {n: p.grad.double() for n, p in model.named_parameters()}


def _gaps(grads: dict, ref: dict) -> dict:
    """Relative RMS of each gradient to ``ref``'s."""
    import torch
    return {name: float(torch.sqrt(((grads[name] - r) ** 2).mean()
                                   / (r ** 2).mean().clamp_min(1e-30)))
            for name, r in ref.items()}


def _worst(gaps: dict) -> tuple:
    """(largest gap in the conv trunk, largest gap after it)."""
    trunk = [g for n, g in gaps.items() if "conv_block" in n or "bn0" in n]
    rest = [g for n, g in gaps.items()
            if not ("conv_block" in n or "bn0" in n)]
    return max(trunk), max(rest)


def _counter_modules() -> tuple:
    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        block1_small, block2_small, bn_pool, conv_block, conv_block1_pair,
        conv_block_pair, conv_block_wino, dual_pool, gru, logmel, logmel_v3,
        logmel_v4, pair_conv_pool)
    return ({"logmel": logmel, "conv_block_pair": conv_block_pair,
             "conv_block_wino": conv_block_wino,
             "logmel_v3": logmel_v3, "logmel_v4": logmel_v4},
            (conv_block, conv_block1_pair, gru, dual_pool, bn_pool,
             pair_conv_pool, block2_small, block1_small))


def _counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name (the first
    designs of rows 1, 9, 10, 3 and 8 count in ``logmel.launches_v1``,
    ``logmel_v3.launches_v1``, ``logmel_v4.launches_v1``,
    ``conv_block_pair.launches_v1`` and ``conv_block_wino.launches_v1``)."""
    ints, dicts = _counter_modules()
    out = {name: mod.launches for name, mod in ints.items()}
    out["logmel_v1"] = ints["logmel"].launches_v1
    out["logmel_v3_v1"] = ints["logmel_v3"].launches_v1
    out["logmel_v4_v1"] = ints["logmel_v4"].launches_v1
    out["conv_block_pair_v1"] = ints["conv_block_pair"].launches_v1
    out["conv_block_wino_v1"] = ints["conv_block_wino"].launches_v1
    for mod in dicts:
        out.update(mod.launches)
    return out


def _reset_counts() -> None:
    ints, dicts = _counter_modules()
    for mod in ints.values():
        mod.launches = 0
    ints["logmel"].launches_v1 = 0
    ints["logmel_v3"].launches_v1 = 0
    ints["logmel_v4"].launches_v1 = 0
    ints["conv_block_pair"].launches_v1 = 0
    ints["conv_block_wino"].launches_v1 = 0
    for mod in dicts:
        for k in mod.launches:
            mod.launches[k] = 0


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _want(**nonzero) -> dict:
    return {k: nonzero.get(k, 0) for k in _counts()}


def _loaders(tok, seed: int) -> tuple:
    """(train, validation) loaders over the in-memory clips."""
    from texttoaudiogrounding_tpu_torch.data.collate import TextCollate
    from texttoaudiogrounding_tpu_torch.data.loader import build_loader

    collate = TextCollate(tok, text_key="phrase",
                          pad_keys=["waveform", "label"],
                          pad_buckets={"waveform": 32000, "label": 100},
                          text_bucket=4)
    train_items = _clip_items(TRAIN_CLIPS * TRAIN_STEPS * TRAIN_EPOCHS, 1)
    val_items = _clip_items(TRAIN_CLIPS * VAL_STEPS, 2)
    return (build_loader(train_items, collate, seed, batch_size=TRAIN_CLIPS,
                         shuffle=True, drop_last=True),
            build_loader(val_items, collate, seed, batch_size=TRAIN_CLIPS))


def training_phase(tok, work: Path) -> tuple:
    """The strong f32 fit and its checks; returns (report, the fit's
    experiment directory under ``work``, kept for the evaluate phase)."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.data.loader import to_device
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner, strong_output_transform)
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    report: dict = {"clips_per_batch": TRAIN_CLIPS, "clip_s": CLIP_S,
                    "tf32": False}
    runner = StrongRunner(device=DEVICE)
    config = runner.setup({**_strong_config(str(work / "strong")),
                           "data": _train_data(work)})
    exp_dir = runner.prepare_experiment()
    train_loader, val_loader = _loaders(tok, config["seed"])
    model = runner.build_model()
    sd = random_state_dict(model, seed=1)
    model.load_state_dict(sd)
    loss_fn = runner.build_loss()

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    record = runner.fit(model, loss_fn, train_loader, val_loader,
                        strong_output_transform, exp_dir)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _counts()
    steps = TRAIN_EPOCHS * TRAIN_STEPS
    want = _want(gru_fwd=steps + TRAIN_EPOCHS * VAL_STEPS, gru_bwd=steps)
    if launches != want:
        raise AssertionError(f"fit: kernel launches {launches}, "
                             f"expected {want}")
    if not all(np.isfinite(record["step_loss"] + record["val_loss"])):
        raise AssertionError(f"fit: loss not finite {record}")
    for name in ("best.pth", "last.pth", "train.log"):
        if not (exp_dir / name).is_file():
            raise AssertionError(f"fit: {name} not written")
    report.update(fit_s=fit_s, fit_launches=launches,
                  fit_step_loss=record["step_loss"],
                  fit_val_loss=record["val_loss"])

    # gradients: kernel path against the all-plain path, dropout off
    batch = to_device(next(iter(val_loader)), torch.device(DEVICE))
    plain_cfg = _strong_config("")["model"]
    plain_cfg["audio_encoder"]["args"].update(gru_kernel=False,
                                              dropout=[0.0, 0.0])
    ref_model = instantiate(plain_cfg, device=DEVICE)
    ref_model.load_state_dict(sd)
    model.load_state_dict(sd)
    model.audio_encoder.dropout = (0.0, 0.0)
    gaps = _gaps(_grads(model, batch, strong_output_transform, loss_fn),
                 _grads(ref_model, batch, strong_output_transform, loss_fn))
    worst_trunk, worst_rest = _worst(gaps)
    if worst_trunk > 2e-2 or worst_rest > 1e-4:
        raise AssertionError(
            f"gradients off the plain path: trunk {worst_trunk}, rest "
            f"{worst_rest} (limits 2e-2, 1e-4): "
            f"{sorted(gaps.items(), key=lambda kv: -kv[1])[:6]}")
    del ref_model
    model.audio_encoder.dropout = (0.2, 0.5)

    # the loss falls over 8 steps on one fixed batch
    model.load_state_dict(sd)
    opt = Optimizer(config["optimizer"], model.parameters(), 1.0)
    losses = [float(runner.train_step(model, loss_fn, opt, batch,
                                      strong_output_transform))
              for _ in range(8)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"loss on a fixed batch does not fall: {losses}")

    # step time on the card, TF32 off (the trainer's default), then on
    def step():
        runner.train_step(model, loss_fn, opt, batch,
                          strong_output_transform)

    step_ms = _cuda_ms(step, 5)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    step_ms_tf32 = _cuda_ms(step, 5)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report.update(
        grad_rel_rms_trunk_max=worst_trunk, grad_rel_rms_rest_max=worst_rest,
        fixed_batch_loss=losses, step_ms=step_ms,
        steps_per_s=1e3 / step_ms, clips_per_s=TRAIN_CLIPS * 1e3 / step_ms,
        step_ms_tf32=step_ms_tf32, trace=_trace(step, step_ms))
    return report, exp_dir


BF16_ARGS = {"dtype": "bfloat16", "gru_bwd": "bf16", "bn_pool": [64, 128],
             "pool_vjp": [256, 512]}
BF16_ROUTES = {
    "a_plain_bf16": {"dtype": "bfloat16"},
    "b_bn_pool_gru_bf16": {"dtype": "bfloat16", "gru_bwd": "bf16",
                           "bn_pool": [64, 128, 256, 512]},
    "c_pool_vjp_gru_bf16": {"dtype": "bfloat16", "gru_bwd": "bf16",
                            "pool_vjp": [64, 128, 256, 512]},
}
# Gradients of the kernel route against the plain bf16 route (pool
# kernels off, the f32 GRU loop), by relative RMS: (conv trunk, after it).
# bf16 roundings flip max-pool and ReLU routings, so a bf16 step's
# gradients move when the waveform is scaled by 1 + 1e-6: the plain route
# itself by 0.214 / 0.0085, while the kernel route lies 0.153 / 0.0056 off
# it (on an H100 80GB HBM3 at 700 W).  The kernel route is held to
# GRAD_LIMITS_BF16, and to GRAD_SELF_MULT times the plain route's own
# change in the same run; a trunk gradient halved, or one after it 2 %
# wrong, fails.
GRAD_LIMITS_BF16, GRAD_SELF_MULT = (0.3, 0.02), 2.0


def training_bf16_phase(tok) -> dict:
    import tempfile

    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.data.loader import to_device
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner, strong_output_transform)
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    report: dict = {"clips_per_batch": TRAIN_CLIPS, "clip_s": CLIP_S,
                    "audio_encoder_args": BF16_ARGS}
    with tempfile.TemporaryDirectory(prefix="ttg_train_bf16_") as tmp:
        runner = StrongRunner(device=DEVICE)
        config = runner.setup(_strong_config(tmp, **BF16_ARGS))
        exp_dir = runner.prepare_experiment()
        train_loader, val_loader = _loaders(tok, config["seed"])
        model = runner.build_model()
        if model.audio_encoder.dtype != torch.bfloat16:
            raise AssertionError("the config did not build the bf16 model")
        sd = random_state_dict(model, seed=1)
        model.load_state_dict(sd)
        loss_fn = runner.build_loss()

        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        record = runner.fit(model, loss_fn, train_loader, val_loader,
                            strong_output_transform, exp_dir)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _counts()
        steps = TRAIN_EPOCHS * TRAIN_STEPS
        vals = TRAIN_EPOCHS * VAL_STEPS
        want = _want(logmel=steps + vals, bn_pool_fwd=2 * steps,
                     bn_pool_bwd=2 * steps, bn_pool_stats=2 * steps,
                     dual_pool_fwd=2 * (steps + vals),
                     dual_pool_bwd=2 * steps, gru_fwd_bf16=steps,
                     gru_bwd_bf16=steps)
        if launches != want:
            raise AssertionError(f"bf16 fit: kernel launches {launches}, "
                                 f"expected {want}")
        if not all(np.isfinite(record["step_loss"] + record["val_loss"])):
            raise AssertionError(f"bf16 fit: loss not finite {record}")
        for name in ("best.pth", "last.pth", "train.log"):
            if not (exp_dir / name).is_file():
                raise AssertionError(f"bf16 fit: {name} not written")
        report.update(fit_s=fit_s, fit_launches=launches,
                      fit_step_loss=record["step_loss"],
                      fit_val_loss=record["val_loss"])

    # gradients: the kernel route against the plain bf16 route, dropout
    # off, beside the plain route's own change under a 1e-6 scaling
    batch = to_device(next(iter(val_loader)), torch.device(DEVICE))
    scaled = dict(batch, waveform=batch["waveform"] * (1 + 1e-6))
    ref_model = instantiate(_strong_config(
        "", dtype="bfloat16", gru_kernel=False,
        dropout=[0.0, 0.0])["model"], device=DEVICE)
    ref_model.load_state_dict(sd)
    model.load_state_dict(sd)
    model.audio_encoder.dropout = (0.0, 0.0)
    ref = _grads(ref_model, batch, strong_output_transform, loss_fn)
    gaps = _gaps(_grads(model, batch, strong_output_transform, loss_fn), ref)
    self_gaps = _gaps(_grads(ref_model, scaled, strong_output_transform,
                             loss_fn), ref)
    worst = _worst(gaps)
    limits = [min(lim, GRAD_SELF_MULT * own)
              for lim, own in zip(GRAD_LIMITS_BF16, _worst(self_gaps))]
    if worst[0] > limits[0] or worst[1] > limits[1]:
        raise AssertionError(
            f"bf16 gradients off the plain bf16 route: trunk {worst[0]}, "
            f"rest {worst[1]} (limits {limits}): "
            f"{sorted(gaps.items(), key=lambda kv: -kv[1])[:6]}")
    del ref_model, ref
    model.audio_encoder.dropout = (0.2, 0.5)

    # the loss falls over 8 steps on one fixed batch
    model.load_state_dict(sd)
    opt = Optimizer(config["optimizer"], model.parameters(), 1.0)
    losses = [float(runner.train_step(model, loss_fn, opt, batch,
                                      strong_output_transform))
              for _ in range(8)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"bf16 loss on a fixed batch does not fall: "
                             f"{losses}")
    del model, opt

    # three routes, timed in turns a b c c b a, each profiled once
    models = {}
    for name, args in BF16_ROUTES.items():
        m = instantiate(_strong_config("", **args)["model"], device=DEVICE)
        m.load_state_dict(sd)
        models[name] = (m, Optimizer(config["optimizer"], m.parameters(),
                                     1.0))
    runs = {name: [] for name in BF16_ROUTES}
    for name in list(BF16_ROUTES) + list(reversed(BF16_ROUTES)):
        m, opt = models[name]
        runs[name].append(_cuda_ms(lambda: runner.train_step(
            m, loss_fn, opt, batch, strong_output_transform), 5))
    routes = {}
    for name, (m, opt) in models.items():
        ms = float(np.mean(runs[name]))
        routes[name] = {
            "audio_encoder_args": BF16_ROUTES[name], "step_ms": ms,
            "step_ms_runs": runs[name], "clips_per_s": TRAIN_CLIPS * 1e3 / ms,
            "trace": _trace(lambda: runner.train_step(
                m, loss_fn, opt, batch, strong_output_transform), ms)}
    report.update(
        grad_rel_rms_trunk_max=worst[0], grad_rel_rms_rest_max=worst[1],
        grad_limits=limits,
        plain_self_rel_rms_trunk_max=_worst(self_gaps)[0],
        plain_self_rel_rms_rest_max=_worst(self_gaps)[1],
        fixed_batch_loss=losses, routes=routes)
    return report


# The WSTAG config (configs/weak_phrase/cnn8rnn_w2vmean_similarity.yaml)
# at full width: 32 clips x 10 s x 32 phrases a batch, the vocabulary's
# 5221 words, a seeded pool of phrases and a random 512-d phrase embedding
WEAK_VOCAB, WEAK_PHRASES, WEAK_POOL = 5221, 32, 3000
WEAK_ROUTES = {"a_v1": None, "b_v2": "v2", "c_v3": "v3"}


def _weak_config(exp_dir: str, **audio_args) -> dict:
    """The similarity config's model, loss, optimizer, scheduler and
    trainer, the epochs cut to ``TRAIN_EPOCHS`` of ``TRAIN_STEPS``."""
    return {
        "experiment_path": exp_dir, "seed": 1,
        "model": {"type": "MultiTextBiEncoder",
                  "args": {"shared_dim": 512, "add_proj": False,
                           "pooling": "linear_softmax",
                           "text_forward_keys": ["text", "text_len"]},
                  "audio_encoder": {"type": "Cnn8Rnn", "args": {
                      "sample_rate": SR, "freeze_cnn": False,
                      "freeze_bn": False, **audio_args}},
                  "text_encoder": {"type": "EmbeddingAgg",
                                   "args": {"vocab_size": WEAK_VOCAB,
                                            "embed_dim": 512}},
                  "match_fn": {"type": "DotProduct", "args": {}}},
        "loss": {"type": "ClipBceLoss", "args": {}},
        "optimizer": {"type": "Adam", "args": {"lr": 0.001}},
        "lr_scheduler": {"type": "ReduceLROnPlateau",
                         "args": {"mode": "min", "patience": 3}},
        "trainer": {"epochs": TRAIN_EPOCHS, "epoch_length": TRAIN_STEPS,
                    "early_stop": 10, "save_interval": 10,
                    "include_optim_in_ckpt": False, "max_grad_norm": 1.0,
                    "metric_monitor": {"mode": "min", "name": "loss"}},
    }


def _weak_loaders(tmp: str, tok, seed: int) -> tuple:
    """(train, validation) loaders of ``AudioSamplePhrasesDataset`` over
    data made in memory: captions of 2-6 phrases from a seeded pool over
    the vocabulary, a random 512-d phrase embedding written as the
    ``.pkl`` the similarity strategy reads, and 10 s noise clips (the
    dataset's ``load_audio`` returns one of 16 made once, in float16 as
    the packed HDF5 files hold)."""
    import pickle
    import zlib

    import numpy as np

    from texttoaudiogrounding_tpu_torch.data.collate import TextCollate
    from texttoaudiogrounding_tpu_torch.data.datasets import (
        AudioSamplePhrasesDataset)
    from texttoaudiogrounding_tpu_torch.data.loader import build_loader

    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(2, WEAK_VOCAB)]
    pool = sorted({" ".join(rng.choice(words, int(rng.integers(1, 5))))
                   for _ in range(WEAK_POOL)})
    emb_path = Path(tmp) / "phrase_embedding.pkl"
    with open(emb_path, "wb") as f:
        pickle.dump({p: rng.normal(size=512).astype(np.float32)
                     for p in pool}, f)
    noise = [rng.normal(0, 0.01, SR * CLIP_S).astype(np.float16)
             for _ in range(16)]

    class InMemory(AudioSamplePhrasesDataset):
        def load_audio(self, audio_id, file_path):
            return noise[zlib.crc32(audio_id.encode()) % len(noise)]

    def dataset(prefix: str, count: int):
        label = [{"audiocap_id": i, "audio_id": f"{prefix}{i}",
                  "tokens": "",
                  "phrases": [str(p) for p in rng.choice(
                      pool, int(rng.integers(2, 7)), replace=False)]}
                 for i in range(count)]
        index = Path(tmp) / f"{prefix}_waveform.csv"
        index.write_text("audio_id\tfile_path\n" + "".join(
            f"{it['audio_id']}\tmemory.h5\n" for it in label))
        return InMemory(str(index), label, phrase_num=WEAK_PHRASES,
                        fix_neg=False, neg_samp_stratg="similarity",
                        max_audio_length=float(CLIP_S),
                        phrase_embed=str(emb_path), sim_threshold=0.5,
                        seed=seed)

    collate = TextCollate(tok, text_key="phrases", pad_keys=["waveform"],
                          pad_buckets={"waveform": 32000}, text_bucket=4)
    train = dataset("train", TRAIN_CLIPS * TRAIN_STEPS * TRAIN_EPOCHS)
    val = dataset("val", TRAIN_CLIPS * VAL_STEPS)
    return (build_loader(train, collate, seed, batch_size=TRAIN_CLIPS,
                         shuffle=True, drop_last=True),
            build_loader(val, collate, seed, batch_size=TRAIN_CLIPS))


def training_weak_phase(tok, work: Path) -> tuple:
    """``WeakPhraseRunner.fit`` on the WSTAG similarity config at full
    width, once with each hoisted backward (``gru_bwd`` v2, then v3),
    the counts set to 0 before each fit; gradients of both against the
    all-plain path, the loss on one batch, checkpoints; then the three
    GRU backwards timed in turns a b c c b a and profiled once each.
    Returns (report, the v2 fit's experiment directory under ``work``)."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.data.loader import to_device
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        WeakPhraseRunner, weak_output_transform)
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    report: dict = {"clips_per_batch": TRAIN_CLIPS, "clip_s": CLIP_S,
                    "phrases_per_clip": WEAK_PHRASES, "fits": {}}
    steps = TRAIN_EPOCHS * TRAIN_STEPS
    vals = TRAIN_EPOCHS * VAL_STEPS
    runner = WeakPhraseRunner(device=DEVICE)
    tmp = str(work / "weak")
    for bwd in ("v2", "v3"):
        config = runner.setup({**_weak_config(f"{tmp}/{bwd}", gru_bwd=bwd),
                               "data": _train_data(work, weak=True)})
        exp_dir = runner.prepare_experiment()
        train_loader, val_loader = _weak_loaders(tmp, tok,
                                                 config["seed"])
        model = runner.build_model()
        sd = random_state_dict(model, seed=2)
        model.load_state_dict(sd)
        loss_fn = runner.build_loss()
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        record = runner.fit(model, loss_fn, train_loader, val_loader,
                            weak_output_transform, exp_dir)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _counts()
        want = _want(gru_fwd=steps + vals, **{f"gru_bwd_{bwd}": steps})
        if launches != want:
            raise AssertionError(f"weak fit ({bwd}): kernel launches "
                                 f"{launches}, expected {want}")
        if not all(np.isfinite(record["step_loss"]
                               + record["val_loss"])):
            raise AssertionError(f"weak fit ({bwd}): loss not finite "
                                 f"{record}")
        for name in ("best.pth", "last.pth", "train.log"):
            if not (exp_dir / name).is_file():
                raise AssertionError(f"weak fit ({bwd}): {name} not "
                                     "written")
        ckpt = torch.load(exp_dir / "last.pth", weights_only=True)
        if not ckpt["save_trainable_only"]:
            raise AssertionError("weak fit: save_trainable_only unset")
        report["fits"][bwd] = {"fit_s": fit_s, "launches": launches,
                               "step_loss": record["step_loss"],
                               "val_loss": record["val_loss"]}
    batch = to_device(next(iter(val_loader)), torch.device(DEVICE))

    # gradients of both hoisted routes against the all-plain path
    plain_cfg = _weak_config("", gru_kernel=False, dropout=[0.0, 0.0])
    ref_model = instantiate(plain_cfg["model"], device=DEVICE)
    ref_model.load_state_dict(sd)
    ref = _grads(ref_model, batch, weak_output_transform, loss_fn)
    del ref_model
    worst = {}
    for bwd in ("v2", "v3"):
        m = instantiate(_weak_config("", gru_bwd=bwd,
                                     dropout=[0.0, 0.0])["model"],
                        device=DEVICE)
        m.load_state_dict(sd)
        gaps = _gaps(_grads(m, batch, weak_output_transform, loss_fn), ref)
        worst[bwd] = _worst(gaps)
        if worst[bwd][0] > 2e-2 or worst[bwd][1] > 1e-4:
            raise AssertionError(
                f"weak gradients ({bwd}) off the plain path: trunk "
                f"{worst[bwd][0]}, rest {worst[bwd][1]} (limits 2e-2, "
                f"1e-4): {sorted(gaps.items(), key=lambda kv: -kv[1])[:6]}")
        del m
    del ref

    # the loss falls over 8 steps on one fixed batch
    model.load_state_dict(sd)
    opt = Optimizer(config["optimizer"], model.parameters(), 1.0)
    losses = [float(runner.train_step(model, loss_fn, opt, batch,
                                      weak_output_transform))
              for _ in range(8)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"weak loss on a fixed batch does not fall: "
                             f"{losses}")
    del model, opt

    # the three GRU backwards, timed in turns a b c c b a
    models = {}
    for name, bwd in WEAK_ROUTES.items():
        m = instantiate(_weak_config("", gru_bwd=bwd)["model"], device=DEVICE)
        m.load_state_dict(sd)
        models[name] = (m, Optimizer(config["optimizer"], m.parameters(),
                                     1.0))
    runs = {name: [] for name in WEAK_ROUTES}
    for name in list(WEAK_ROUTES) + list(reversed(WEAK_ROUTES)):
        m, opt = models[name]
        runs[name].append(_cuda_ms(lambda: runner.train_step(
            m, loss_fn, opt, batch, weak_output_transform), 5))
    routes = {}
    for name, (m, opt) in models.items():
        ms = float(np.mean(runs[name]))
        routes[name] = {
            "gru_bwd": WEAK_ROUTES[name], "step_ms": ms,
            "step_ms_runs": runs[name], "clips_per_s": TRAIN_CLIPS * 1e3 / ms,
            "trace": _trace(lambda: runner.train_step(
                m, loss_fn, opt, batch, weak_output_transform), ms)}
    report.update(
        grad_rel_rms_max={k: {"trunk": v[0], "rest": v[1]}
                          for k, v in worst.items()},
        fixed_batch_loss=losses, routes=routes)
    return report, Path(tmp) / "v2"


# The evaluation set: 32 clips of 10 s, two phrases a clip (a tone each
# over one labelled segment), in label.json's layout; configs/strong/
# biencoder_eval.yaml's and configs/weak_phrase/eval.yaml's keys
EVAL_CLIPS, EVAL_BATCH = 32, 32
EVAL_KEYS = {"resume": "best", "n_thresholds": 50, "window_size": 1,
             "max_efprs": [400, 600, 800, 1000, None],
             "output": "result.txt"}
SERVING_ARGS = {"dtype": "bfloat16", "conv_mode": "int8"}


def _eval_config(work: Path, waves: dict, label: list, **keys) -> dict:
    """An eval config over the in-memory set: ``AudioPhraseEvalDataset``
    with the waveforms by audio id and the label list, the eval collate,
    batches of ``EVAL_BATCH`` and the duration TSV under ``work``."""
    return {**EVAL_KEYS, **keys, "data": {"test": {
        "dataset": {"type": "AudioPhraseEvalDataset",
                    "args": {"waveform": waves, "label": label}},
        "collate_fn": {"type": "TextCollate", "args": {
            "text_key": "phrase", "pad_keys": ["waveform"],
            "pad_buckets": {"waveform": 32000}, "text_bucket": 4,
            "tokenizer": {"type": "DictTokenizer", "args": {
                "vocabulary": str(work / "vocab.pkl")}}}},
        "dataloader_args": {"batch_size": EVAL_BATCH},
        "duration": str(work / "duration.tsv")}}}


def _eval_data(work: Path) -> tuple:
    """(waveforms by audio id in float16, label list): 10 s of noise with
    two tones, each over one segment that its phrase names; the duration
    TSV is written to ``work``."""
    import numpy as np
    rng = np.random.default_rng(7)
    n = SR * CLIP_S
    waves, label = {}, []
    for i in range(EVAL_CLIPS):
        wav = rng.normal(0, 0.01, n).astype(np.float32)
        phrases = []
        for j, k in enumerate(rng.choice(len(_TONES), 2, replace=False)):
            on = round(float(rng.uniform(0.05, 0.7)) * CLIP_S, 3)
            off = round(on + float(rng.uniform(0.05, 0.25)) * CLIP_S, 3)
            idx = np.arange(int(on * SR), int(off * SR))
            wav[idx] += 0.3 * np.sin(2 * np.pi * _TONES[k] * idx / SR)
            phrases.append({"phrase": f"w{2 + k} w{20 + k}",
                            "start_index": 2 * j, "end_index": 2 * j + 1,
                            "segments": [[on, off]]})
        waves[f"eval{i}"] = wav.astype(np.float16)
        label.append({"audiocap_id": 1000 + i, "audio_id": f"eval{i}",
                      "tokens": " ".join(p["phrase"] for p in phrases),
                      "phrases": phrases})
    (work / "duration.tsv").write_text("audio_id\tduration\n" + "".join(
        f"eval{i}\t{float(CLIP_S)}\n" for i in range(EVAL_CLIPS)))
    return waves, label


def _tracks(runner) -> dict:
    return {f: t["fake_event"]
            for f, t in runner.eval_output["score_buffer"].items()}


def _track_gap(tracks: dict, ref: dict) -> float:
    import numpy as np
    if tracks.keys() != ref.keys():
        raise AssertionError("evaluated tracks differ in their files")
    return max(float(np.max(np.abs(tracks[f] - ref[f]))) for f in ref)


def _evaluated(label: str, run, want: dict, out_dir: Path,
               n_thresholds: int) -> dict:
    """Run one evaluation (``run()`` returns its metrics) with the counts
    set to 0 just before, and hold it: the counts read just after equal
    ``want``, every metric finite in [0, 1], ``result.txt`` and one
    predictions TSV a threshold written."""
    import math

    import torch

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, "
                             f"expected {want}")
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0
               for v in results.values()):
        raise AssertionError(f"{label}: metrics out of [0, 1]: {results}")
    if not (out_dir / "result.txt").is_file() or len(list(
            (out_dir / "predictions").glob("*.tsv"))) != n_thresholds:
        raise AssertionError(f"{label}: result.txt or predictions missing")
    return {"metrics": results, "seconds": seconds, "launches": launches}


def evaluate_phase(tok, work: Path, strong_exp: Path, weak_exp: Path
                   ) -> dict:
    """Evaluation on the card from the training phases' checkpoints, on
    the in-memory set (``_eval_data``): ``StrongRunner.evaluate`` of the
    f32 strong checkpoint (row 13's forward kernel), again with
    ``gru_kernel=False`` (tracks within 1e-4), and in the serving
    configuration (``model_overrides``: rows 1-4, tracks within 0.05 of
    the f32 ones); ``WeakPhraseRunner.evaluate`` of the WSTAG checkpoint;
    the native decoder against NumPy on every evaluated track;
    ``GroundingPredictor.from_experiment`` serving the set's first
    phrases (within 1e-4 of the evaluated tracks); a resumed strong run for
    one more epoch from ``last.pth``; the forward's ms a batch (f32,
    serving, serving with the bf16 GRU kernel) and the host seconds of
    decoding, PSDS and th-AUC."""
    import copy

    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import GroundingPredictor
    from texttoaudiogrounding_tpu_torch.data.loader import to_device
    from texttoaudiogrounding_tpu_torch.evaluation.decode import (
        decode_multi_threshold)
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner, strong_output_transform)
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        WeakPhraseRunner)
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    waves, label = _eval_data(work)
    batches = -(-2 * EVAL_CLIPS // EVAL_BATCH)
    n_th = EVAL_KEYS["n_thresholds"]
    report: dict = {"clips": EVAL_CLIPS, "phrases": 2 * EVAL_CLIPS,
                    "clip_s": CLIP_S, "batch": EVAL_BATCH}

    # f32 checkpoint: row 13's forward once a batch
    f32 = StrongRunner(device=DEVICE)
    report["f32"] = _evaluated(
        "evaluate f32", lambda: f32.evaluate(
            strong_exp, _eval_config(work, waves, label)),
        _want(gru_fwd=batches), strong_exp, n_th)
    report["f32"]["host_seconds"] = dict(f32.eval_seconds)
    report["f32"]["curve_files"] = sorted(
        p.name for p in (strong_exp / "psds").iterdir())
    tracks = _tracks(f32)
    if len(tracks) != 2 * EVAL_CLIPS:
        raise AssertionError(f"evaluate f32: {len(tracks)} tracks")

    # the same weights without the GRU kernel, and in the serving mode
    plain = StrongRunner(device=DEVICE)
    report["plain_gru"] = _evaluated(
        "evaluate gru_kernel=False", lambda: plain.evaluate(
            strong_exp, _eval_config(work, waves, label, model_overrides={
                "audio_encoder": {"args": {"gru_kernel": False}}},
                output="result_plain.txt")),
        _want(), strong_exp, n_th)
    gap = _track_gap(_tracks(plain), tracks)
    if gap > 1e-4:
        raise AssertionError(f"evaluate: GRU kernel tracks {gap} off the "
                             "plain GRU's (limit 1e-4)")
    report["plain_gru"]["max_abs_vs_kernel"] = gap
    served = StrongRunner(device=DEVICE)
    report["serving"] = _evaluated(
        "evaluate serving", lambda: served.evaluate(
            strong_exp, _eval_config(
                work, waves, label,
                model_overrides={"audio_encoder": {"args": SERVING_ARGS}},
                output="result_serving.txt")),
        _want(**{k: v * batches for k, v in SERVING_PER_FORWARD.items()}),
        strong_exp, n_th)
    gap = _track_gap(_tracks(served), tracks)
    if gap > 0.05:
        raise AssertionError(f"evaluate: serving tracks {gap} off the f32 "
                             "ones (limit 0.05)")
    report["serving"]["max_abs_vs_f32"] = gap
    report["serving"]["host_seconds"] = dict(served.eval_seconds)

    # WSTAG: the phrase axis of 1, row 13's forward once a batch
    weak = WeakPhraseRunner(device=DEVICE)
    report["weak"] = _evaluated(
        "evaluate WSTAG", lambda: weak.evaluate(
            weak_exp, _eval_config(work, waves, label, time_resolution=0.04)),
        _want(gru_fwd=batches), weak_exp, n_th)

    # the native decoder against NumPy on every evaluated track
    thresholds = np.arange(1 / (n_th * 2), 1, 1 / n_th)
    t0 = time.perf_counter()
    n_tracks = 0
    for runner in (f32, plain, served, weak):
        for scores in _tracks(runner).values():
            nat = decode_multi_threshold(scores, thresholds, 1, 13, 0.04)
            ref = decode_multi_threshold(scores, thresholds, 1, 13, 0.04,
                                         use_native=False)
            if not all(np.array_equal(a, b) for a, b in zip(nat, ref)):
                raise AssertionError("native decode differs from NumPy")
            n_tracks += 1
    report["native_vs_numpy"] = {"tracks": n_tracks, "thresholds": n_th,
                                 "seconds_both": time.perf_counter() - t0}

    # from_experiment serves the first phrase of every clip
    _reset_counts()
    pred = GroundingPredictor.from_experiment(strong_exp, device=DEVICE)
    audio = np.stack([waves[it["audio_id"]].astype(np.float32)
                      for it in label])
    probs, lengths = pred.predict(
        audio, [audio.shape[1]] * EVAL_CLIPS,
        [it["phrases"][0]["phrase"] for it in label], return_length=True)
    report["from_experiment"] = {"launches": _counts()}
    if report["from_experiment"]["launches"] != _want(gru_fwd=1):
        raise AssertionError(f"from_experiment: kernel launches "
                             f"{report['from_experiment']['launches']}")
    gap = max(float(np.max(np.abs(
        p[:n] - tracks[f"{it['audiocap_id']}_0"])))
        for it, p, n in zip(label, probs, lengths))
    if gap > 1e-4:
        raise AssertionError(f"from_experiment: frame_sim {gap} off the "
                             "evaluated tracks (limit 1e-4)")
    report["from_experiment"]["max_abs_vs_evaluate"] = gap
    del pred

    # one more epoch from last.pth: epoch and Adam's step count run on
    saved = torch.load(strong_exp / "last.pth", weights_only=True)
    runner = StrongRunner(device=DEVICE)
    config = runner.setup({
        **_strong_config(str(work / "resumed")), "data": _train_data(work),
        "resume": str(strong_exp / "last.pth")})
    config["trainer"]["epochs"] = saved["epoch"] + 1
    exp_dir = runner.prepare_experiment()
    train_loader, val_loader = _loaders(tok, config["seed"])
    record = runner.fit(runner.build_model(), runner.build_loss(),
                        train_loader, val_loader, strong_output_transform,
                        exp_dir)
    last = torch.load(exp_dir / "last.pth", weights_only=True)
    step = float(last["optimizer"]["state"][0]["step"])
    want_step = float(saved["optimizer"]["state"][0]["step"]) + TRAIN_STEPS
    if not (record["start_epoch"] == saved["epoch"] + 1 == last["epoch"]
            and step == want_step):
        raise AssertionError(
            f"resume: started at epoch {record['start_epoch']}, saved "
            f"{saved['epoch']}, Adam step {step} (expected {want_step})")
    report["resume"] = {"saved_epoch": saved["epoch"],
                        "start_epoch": record["start_epoch"],
                        "adam_step": step,
                        "train_loss": record["train_loss"]}

    # the forward's ms a batch (CUDA events): f32, serving, and serving
    # with the opt-in bf16 GRU kernel (row 14), each held to the f32
    # forward's frame_sim within 0.05 on the batch
    batch = to_device(next(iter(f32.build_dataloader(
        _eval_config(work, waves, label)["data"]["test"], shuffle=False))),
        torch.device(DEVICE))
    with_kernel = copy.deepcopy(served.config["model"])
    with_kernel["audio_encoder"]["args"]["gru_kernel"] = True
    report["forward"] = {}
    ref = None
    for name, cfg in (("f32", f32.config["model"]),
                      ("serving", served.config["model"]),
                      ("serving_gru_kernel", with_kernel)):
        model = instantiate(cfg, device=DEVICE).eval()
        f32.restore_state(model, strong_exp)
        with torch.no_grad():
            out = model(batch)["frame_sim"].float()
            ref = out if ref is None else ref
            gap = float((out - ref).abs().max())
            if gap > 0.05:
                raise AssertionError(f"evaluate forward {name}: frame_sim "
                                     f"{gap} off the f32 forward's")
            report["forward"][name] = {
                "ms_per_batch": _cuda_ms(lambda: model(batch), 5),
                "max_abs_vs_f32": gap}
        del model
    return report


# ------------------------------------- the CDur config, freezing, DESED
# CDur's BiGRU: 125 steps (501 frames halved twice), 32 clips, H = 128 over
# 128 channels x 1 mel
CDUR_T, CDUR_H, CDUR_IN = 125, 128, 128
CDUR_YAML = "configs/strong/cdur_w2vmean.yaml"
CDUR_EPOCHS, CDUR_STEPS, CDUR_VAL_BATCHES = 2, 4, 2
# the keys of _cdur_config that differ from configs/strong/cdur_w2vmean.yaml:
# the run's directory, the data made in memory and the tokenizer's vocabulary
# file, the epochs cut to CDUR_EPOCHS of CDUR_STEPS, the profiler on
CDUR_CUTS = (
    "experiment_path", "data.train.dataset.args.waveform",
    "data.train.dataset.args.label", "data.val.dataset.args.waveform",
    "data.val.dataset.args.label",
    "data.train.collate_fn.args.tokenizer.args.vocabulary",
    "data.val.collate_fn.args.tokenizer.args.vocabulary", "trainer.epochs",
    "trainer.epoch_length", "trainer.profile")


def gru_cdur_rows(clips: int, rng) -> list:
    """Row 13's forward and backward at the CDur path's shape (T = 125, 2B =
    64, H = 128: 8-CTA clusters, 3 groups of 11 rows a direction): see
    ``_gru_path_rows``."""
    return _gru_path_rows("cdur", "train_cdur", CDUR_T, clips, CDUR_H,
                          CDUR_IN, rng)


def gru_mixup_rows(rng) -> list:
    """Row 13's forward and backward at the weak class-mapping train step's
    shape: mixup halves the batch before the conv blocks, so the BiGRU
    runs on 16 clips (T = 250, 2B = 32, H = 256, input 512): see
    ``_gru_path_rows``."""
    return _gru_path_rows("mixup", "train_class_mapping_weak", 250,
                          TRAIN_CLIPS // 2, 256, 512, rng)


def gru_text_rows(rng) -> list:
    """Row 13's forward and backward at ``RnnEncoder``'s text shape in the
    zoo phase (T = 20, 2B = 160 phrases, H = 256 over word2vec's 300): see
    ``_gru_path_rows``."""
    return _gru_path_rows("text", "zoo_rnn_encoder", ZOO_TEXT_T,
                          ZOO_TEXT_ROWS, 256, 300, rng)


def _gru_path_rows(label: str, path: str, t: int, b: int, h: int, d: int,
                   rng) -> list:
    """Row 13's forward and backward at one path's shape (``b`` clips,
    ``2b`` rows) against their plain versions, each output and gradient
    within 1e-4 relative RMS, timed with CUDA events beside
    ``torch.nn.GRU`` on the same weights, their CUDA launches a call
    counted by the profiler (1 and 2); the rows ``gru_fwd_<label>`` /
    ``gru_bwd_<label>`` count ``path``'s launches."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    x, gy, _, proj, wh, bn, lib = _gru_inputs(rng, t, b, h, d)
    dev = x.device
    lib.flatten_parameters()
    gy_lib = torch.randn(b, t, 2 * h, device=dev)

    def lib_fwd_bwd():
        out, _ = lib(x)
        out.backward(gy_lib)

    ys = gru.gru_forward(proj, wh, bn)
    ys_plain = gru.gru_forward_plain(proj, wh, bn)
    with torch.no_grad():
        lib_out, _ = lib(x)
    ys_bf = ys.reshape(t, 2, b, h).permute(1, 2, 0, 3)
    lib_gap = float((torch.cat([ys_bf[0], torch.flip(ys_bf[1], dims=(1,))],
                               dim=-1) - lib_out).abs().max())
    if lib_gap > 1e-3:
        raise AssertionError(f"gru_fwd_{label}: off torch.nn.GRU by "
                             f"{lib_gap}")
    grads = gru.gru_backward(proj, ys_plain, gy, wh, bn)
    grads_plain = gru.gru_backward_plain(proj, ys_plain, gy, wh, bn)
    fwd_ops = 2.0 * t * 2 * b * h * 3 * h
    fwd_bytes = 4 * (proj.numel() + ys.numel() + wh.numel() + bn.numel())
    bwd_bytes = 4 * (2 * proj.numel() + 2 * ys.numel() + 2 * wh.numel()
                     + 2 * bn.numel())
    lib_fwd_ms = _cuda_ms(lambda: lib(x), 10)
    lib_fwd_bwd_ms = _cuda_ms(lib_fwd_bwd, 10)
    rows = [
        dict(name=f"gru_fwd_{label}", counter="gru_fwd", got=ys,
             ref=ys_plain,
             replaces="texttoaudiogrounding_tpu/ops/pallas/gru.py:62",
             source="texttoaudiogrounding_tpu_torch/csrc/gru_fwd_sm90.cu",
             kernel=lambda: gru.gru_forward(proj, wh, bn),
             plain=lambda: gru.gru_forward_plain(proj, wh, bn),
             bound=_bound(fwd_bytes, {"f32": fwd_ops}),
             plan=gru.forward_plan(b, h), library_ms=lib_fwd_ms,
             library_max_abs_diff=lib_gap),
        dict(name=f"gru_bwd_{label}", counter="gru_bwd", got=grads,
             ref=grads_plain,
             replaces="texttoaudiogrounding_tpu/ops/pallas/gru.py:199",
             source="texttoaudiogrounding_tpu_torch/csrc/gru_bwd_sm90.cu",
             kernel=lambda: gru.gru_backward(proj, ys_plain, gy, wh, bn),
             plain=lambda: gru.gru_backward_plain(proj, ys_plain, gy, wh,
                                                  bn),
             bound=_bound(bwd_bytes, {"f32": 3 * fwd_ops}),
             plan=gru.cluster_plan(b, h),
             library_ms=lib_fwd_bwd_ms - lib_fwd_ms,
             library_fwd_bwd_ms=lib_fwd_bwd_ms)]
    out = []
    for row in rows:
        max_abs, rel = _max_err(row["got"], row["ref"])
        if rel > 1e-4:
            raise AssertionError(f"{row['name']}: kernel disagrees with its "
                                 f"plain version: rel_rms {rel} > 1e-4 "
                                 f"(max_abs {max_abs})")
        ms = _cuda_ms(row["kernel"], 10)
        out.append({
            "name": row["name"], "counter": row["counter"],
            "path": path, "route": "cuda",
            "source": row["source"], "replaces": row["replaces"],
            "max_abs_err": max_abs, "rel_rms_err": rel,
            "tolerance": "rel_rms{} <= 1e-4".format(
                "" if isinstance(row["got"], torch.Tensor)
                else " of each gradient"),
            "ms": ms, "kernel_ms": ms,
            "plain_ms": _cuda_ms(row["plain"], 2),
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": row["library_ms"],
            "library": "torch.nn.GRU (cuDNN; includes the input projection)",
            "cuda_launches_per_call": _launches_per_call(row["kernel"]),
            "T": t, "rows": 2 * b, "H": h, "plan": row["plan"],
            **{k: row[k] for k in ("library_fwd_bwd_ms",
                                   "library_max_abs_diff") if k in row}})
    want = {f"gru_fwd_{label}": 1, f"gru_bwd_{label}": 2}
    for row in out:
        if row["cuda_launches_per_call"] != want[row["name"]]:
            raise AssertionError(
                f"{row['name']}: {row['cuda_launches_per_call']} CUDA "
                f"launches a call, expected {want[row['name']]}")
    return out


def _cdur_data(prefix: str, count: int, seed: int) -> tuple:
    """(waveforms by audio id in float16, label list) of ``count`` 10 s
    clips made in memory, each of noise with one tone over a segment that
    its phrase names (``AudioPhraseDataset``'s label format)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = SR * CLIP_S
    waves, label = {}, []
    for i in range(count):
        wav = rng.normal(0, 0.01, n).astype(np.float32)
        k = int(rng.integers(len(_TONES)))
        on = round(float(rng.uniform(0.05, 0.7)) * CLIP_S, 3)
        off = round(on + float(rng.uniform(0.05, 0.25)) * CLIP_S, 3)
        idx = np.arange(int(on * SR), int(off * SR))
        wav[idx] += 0.3 * np.sin(2 * np.pi * _TONES[k] * idx / SR)
        phrase = f"w{2 + k} w{20 + k}"
        waves[f"{prefix}{i}"] = wav.astype(np.float16)
        label.append({"audiocap_id": i, "audio_id": f"{prefix}{i}",
                      "tokens": phrase,
                      "phrases": [{"phrase": phrase, "start_index": 0,
                                   "end_index": 1,
                                   "segments": [[on, off]]}]})
    return waves, label


def _cdur_config(exp_dir: str, train: tuple, val: tuple,
                 vocabulary: str) -> dict:
    """``configs/strong/cdur_w2vmean.yaml`` as a dict, cut as ``CDUR_CUTS``
    lists: ``train`` / ``val`` are (waveforms by audio id, label list)."""
    def split(data: tuple, batch_size: int) -> dict:
        return {
            "dataset": {"type": "AudioPhraseDataset",
                        "args": {"waveform": data[0], "label": data[1],
                                 "time_resolution": 0.08}},
            "collate_fn": {"type": "TextCollate", "args": {
                "text_key": "phrase", "pad_keys": ["waveform", "label"],
                "pad_buckets": {"waveform": 32000, "label": 50},
                "text_bucket": 4,
                "tokenizer": {"type": "DictTokenizer",
                              "args": {"vocabulary": vocabulary}}}},
            "dataloader_args": {"batch_size": batch_size, "num_workers": 2}}

    return {
        "experiment_path": exp_dir, "seed": 1,
        "data": {"train": split(train, 32), "val": split(val, 64)},
        "model": {"type": "BiEncoder",
                  "args": {"shared_dim": 256, "add_proj": False,
                           "upsample": False},
                  "audio_encoder": {"type": "CrnnEncoder",
                                    "args": {"embed_dim": 256,
                                             "sample_rate": SR}},
                  "text_encoder": {"type": "EmbeddingAgg",
                                   "args": {"embed_dim": 256,
                                            "vocab_size": 5221,
                                            "aggregation": "mean"}},
                  "match_fn": {"type": "ExpNegL2",
                               "args": {"text_level": "seq"}}},
        "loss": {"type": "FrameBceLoss", "args": {}},
        "optimizer": {"type": "Adam", "args": {"lr": 0.001}},
        "lr_scheduler": {"type": "ReduceLROnPlateau",
                         "args": {"mode": "min", "patience": 3}},
        "eval_config": {"n_thresholds": 50},
        "inference_args": {"window_size": 1},
        "trainer": {"metric_monitor": {"mode": "min", "name": "loss"},
                    "epochs": CDUR_EPOCHS, "epoch_length": CDUR_STEPS,
                    "early_stop": 10, "lr_update_interval": "epoch",
                    "save_interval": 10, "include_optim_in_ckpt": False,
                    "max_grad_norm": 1.0,
                    "profile": {"start_step": 2, "num_steps": 2}},
    }


def _trace_gru_kernels(path: Path) -> list:
    """The cluster GRU kernels that a Chrome trace names; raises unless
    both row 13's forward and backward are among them."""
    import json as _json
    names = {e.get("name", "") for e in _json.loads(
        path.read_text()).get("traceEvents", [])}
    found = sorted(n for n in names
                   if "gru_fwd_cluster" in n or "gru_bwd_cluster" in n)
    if not any("gru_fwd_cluster" in n for n in found) or not any(
            "gru_bwd_cluster" in n for n in found):
        raise AssertionError(f"train_cdur: the trace {path.name} names no "
                             f"cluster GRU forward and backward: {found}")
    return found


def _op_profile(fn) -> tuple:
    """PyTorch operators of one profiled call of ``fn`` by name and input
    shapes: ``(name, shapes, self device ms, total device ms)``, largest
    self time first, with the count of kernel records the profiler
    dropped (``_unrecorded``; the profile is taken again, 3 tries, while
    one is missing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            _profile_markers()
            fn()
            torch.cuda.synchronize()
        unrecorded = _unrecorded(prof.events(), [
            e for e in prof.events() if e.device_type == cuda])
        if not unrecorded:
            break
    out = []
    for evt in prof.key_averages(group_by_input_shape=True):
        self_us = getattr(evt, "self_device_time_total", None)
        total_us = getattr(evt, "device_time_total", None)
        if self_us is None:
            self_us, total_us = evt.self_cuda_time_total, evt.cuda_time_total
        out.append((evt.key, evt.input_shapes, self_us / 1e3, total_us / 1e3))
    return sorted(out, key=lambda e: -e[2]), unrecorded


def train_cdur_phase(tok, work: Path) -> tuple:
    """``StrongRunner.train`` on ``_cdur_config`` (CrnnEncoder(256),
    EmbeddingAgg(5221, 256), ExpNegL2, FrameBceLoss at 0.08 s frames) at
    full width, 2 epochs of 4 steps of 32 clips x 10 s and 2 validation
    batches of 64, with the step profiler on steps 2-3; its checks;
    ``StrongRunner.evaluate`` of the run and ``from_experiment``; then the
    step timed (CUDA events, 5 steps) and its frontend matmul,
    convolutions and GRU kernels traced.  Returns (report, the run's
    directory)."""
    import copy
    import math

    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import GroundingPredictor
    from texttoaudiogrounding_tpu_torch.data.loader import to_device
    from texttoaudiogrounding_tpu_torch.ops.frontend import (
        _tables as frontend_tables, frame_waveform, log_mel_spectrogram)
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner, strong_output_transform)

    vocab = str(work / "vocab.pkl")
    train = _cdur_data("cdur", TRAIN_CLIPS * CDUR_STEPS, 11)
    val = _cdur_data("cdurval", 64 * CDUR_VAL_BATCHES, 12)
    config = _cdur_config(str(work / "cdur"), train, val, vocab)
    runner = StrongRunner(device=DEVICE)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp_dir = runner.train(config)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _counts()
    steps = CDUR_EPOCHS * CDUR_STEPS
    want = _want(gru_fwd=steps + CDUR_EPOCHS * CDUR_VAL_BATCHES,
                 gru_bwd=steps)
    if launches != want:
        raise AssertionError(f"train_cdur: kernel launches {launches}, "
                             f"expected {want}")
    for name in ("best.pth", "last.pth", "train.log"):
        if not (exp_dir / name).is_file():
            raise AssertionError(f"train_cdur: {name} not written")
    traces = sorted((exp_dir / "profile").glob("*.json"))
    if not traces:
        raise AssertionError("train_cdur: the step profiler wrote no trace")
    gru_kernels = _trace_gru_kernels(traces[0])
    log = (exp_dir / "train.log").read_text()
    if "samples/s" not in log:
        raise AssertionError("train_cdur: no throughput in the epoch log")
    report = {"fit_s": fit_s, "fit_launches": launches,
              "trace_files": [p.name for p in traces],
              "trace_gru_kernels": gru_kernels,
              "epoch_log": [ln.split(" - ", 1)[-1] for ln in log.splitlines()
                            if "train_loss" in ln]}

    # evaluation of the run at 0.08 s frames, and from_experiment on it
    label = copy.deepcopy(val[1][:EVAL_BATCH])
    waves = {it["audio_id"]: val[0][it["audio_id"]] for it in label}
    durations = work / "cdur_duration.tsv"
    durations.write_text("audio_id\tduration\n" + "".join(
        f"{it['audio_id']}\t{float(CLIP_S)}\n" for it in label))
    evaluator = StrongRunner(device=DEVICE)
    eval_cfg = _eval_config(work, waves, label, output="result.txt")
    eval_cfg["data"]["test"]["duration"] = str(durations)
    _reset_counts()
    metrics = evaluator.evaluate(exp_dir, eval_cfg)
    report["evaluate"] = {"metrics": metrics, "launches": _counts(),
                          "host_seconds": dict(evaluator.eval_seconds)}
    if report["evaluate"]["launches"] != _want(gru_fwd=1):
        raise AssertionError(f"train_cdur evaluate: kernel launches "
                             f"{report['evaluate']['launches']}")
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0
               for v in metrics.values()):
        raise AssertionError(f"train_cdur evaluate: metrics {metrics}")
    tracks = _tracks(evaluator)
    steps_s = {round(float(t["offset"][0] - t["onset"][0]), 6)
               for t in evaluator.eval_output["score_buffer"].values()}
    if steps_s != {0.08}:
        raise AssertionError(f"train_cdur evaluate: frames of {steps_s} s")
    pred = GroundingPredictor.from_experiment(exp_dir, device=DEVICE)
    audio = np.stack([waves[it["audio_id"]].astype(np.float32)
                      for it in label])
    probs, lengths = pred.predict(
        audio, [audio.shape[1]] * len(label),
        [it["phrases"][0]["phrase"] for it in label], return_length=True)
    gap = max(float(np.max(np.abs(
        p[:n] - tracks[f"{it['audiocap_id']}_0"])))
        for it, p, n in zip(label, probs, lengths))
    if gap > 1e-4:
        raise AssertionError(f"train_cdur from_experiment: frame_sim {gap} "
                             "off the evaluated tracks (limit 1e-4)")
    report["from_experiment_max_abs"] = gap
    report["time_resolution"] = pred.time_resolution
    del pred

    # the loss falls over 8 steps on one batch; step time; one traced step
    model = runner.build_model()
    runner.restore_state(model, exp_dir, "last")
    batch = to_device(next(iter(runner.build_dataloader(
        config["data"]["train"], shuffle=False))), torch.device(DEVICE))
    loss_fn = runner.build_loss()
    opt = Optimizer(config["optimizer"], model.parameters(), 1.0)
    losses = [float(runner.train_step(model, loss_fn, opt, batch,
                                      strong_output_transform))
              for _ in range(8)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train_cdur: loss on a fixed batch does not "
                             f"fall: {losses}")

    def step():
        runner.train_step(model, loss_fn, opt, batch,
                          strong_output_transform)

    step_ms = _cuda_ms(step, 5)
    cfg = model.audio_encoder.mel_config
    ops, unrecorded = _op_profile(step)
    # the frontend's DFT: frames [B, T, n_fft] @ basis [n_fft, 2 F]; the
    # profiler can drop a step's first kernel records (``unrecorded``),
    # so the matmul is also timed alone with CUDA events
    frontend_ms = sum(total for key, shapes, _, total in ops
                      if key == "aten::matmul" and len(shapes) == 2
                      and shapes[1] == [cfg.n_fft, 2 * cfg.n_freqs])
    frames = frame_waveform(batch["waveform"], cfg)
    basis, _ = frontend_tables(cfg, frames.device)
    report.update(fixed_batch_loss=losses, step_ms=step_ms,
                  clips_per_s=TRAIN_CLIPS * 1e3 / step_ms,
                  frontend_matmul_ms=frontend_ms,
                  frontend_matmul_cuda_ms=_cuda_ms(
                      lambda: torch.matmul(frames, basis), 5),
                  frontend_cuda_ms=_cuda_ms(
                      lambda: log_mel_spectrogram(batch["waveform"], cfg),
                      5),
                  op_profile_unrecorded=unrecorded,
                  top_ops=[{"op": k, "shapes": str(sh)[:120],
                            "self_ms": ms, "total_ms": tot}
                           for k, sh, ms, tot in ops[:15]],
                  trace=_trace(step, step_ms))
    return report, exp_dir


def finetune_frozen_phase(tok, work: Path, weak_exp: Path) -> dict:
    """Finetune the WSTAG run's best checkpoint for 1 epoch of 4 steps with
    ``freeze_cnn`` and ``freeze_bn``, saving trainable parameters only:
    every frozen parameter and BatchNorm statistic bit for bit the same,
    the GRU and text parameters moved, the checkpoint exactly the
    trainable parameters and every buffer; then a resume from it starts at
    the saved epoch + 1."""
    import tempfile

    import torch

    from texttoaudiogrounding_tpu_torch.training.optim import (
        freeze_mask_from_model)
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        WeakPhraseRunner, weak_output_transform)

    source = torch.load(weak_exp / "best.pth", weights_only=True)["model"]

    def run(name: str, resume: Path, finetune: bool, epochs: int) -> tuple:
        runner = WeakPhraseRunner(device=DEVICE)
        cfg = _weak_config(str(work / name), gru_bwd="v2", freeze_cnn=True,
                           freeze_bn=True)
        cfg["trainer"].update(epochs=epochs, save_interval=1,
                              save_trainable_only=True)
        config = runner.setup({**cfg, "data": _train_data(work, weak=True),
                               "resume": str(resume), "finetune": finetune})
        exp_dir = runner.prepare_experiment()
        with tempfile.TemporaryDirectory() as tmp:
            train_loader, val_loader = _weak_loaders(tmp, tok,
                                                     config["seed"])
            model = runner.build_model()
            _reset_counts()
            record = runner.fit(model, runner.build_loss(), train_loader,
                                val_loader, weak_output_transform, exp_dir)
        return runner, model, record, exp_dir, _counts()

    runner, model, record, exp_dir, launches = run(
        "frozen", weak_exp / "best.pth", True, 1)
    want = _want(gru_fwd=TRAIN_STEPS + VAL_STEPS, gru_bwd_v2=TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"finetune_frozen: kernel launches {launches}, "
                             f"expected {want}")
    mask = freeze_mask_from_model(model)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    frozen = sorted(n for n, keep in mask.items() if not keep)
    trainable = sorted(n for n, keep in mask.items() if keep)
    stats = sorted(n for n in state if "running_" in n)
    if not frozen or any(not n.startswith("audio_encoder.rnn.")
                         and not n.startswith("text_encoder.")
                         for n in trainable):
        raise AssertionError(f"finetune_frozen: mask trainable {trainable}")
    changed = [n for n in frozen + stats
               if not torch.equal(state[n], source[n])]
    if changed:
        raise AssertionError(f"finetune_frozen: frozen entries moved: "
                             f"{changed[:8]}")
    still = [n for n in trainable if torch.equal(state[n], source[n])]
    if still:
        raise AssertionError(f"finetune_frozen: trainable entries did not "
                             f"move: {still}")
    saved = torch.load(exp_dir / "last.pth", weights_only=True)
    buffers = {n for n, _ in model.named_buffers()}
    if set(saved["model"]) != set(trainable) | buffers \
            or not saved["trainables_only"]:
        raise AssertionError(
            f"finetune_frozen: the checkpoint holds "
            f"{sorted(set(saved['model']) ^ (set(trainable) | buffers))[:8]} "
            "beyond or short of the trainable parameters and buffers")
    _, _, resumed, _, _ = run("frozen_resumed", exp_dir / "last.pth", False,
                              saved["epoch"] + 1)
    if resumed["start_epoch"] != saved["epoch"] + 1:
        raise AssertionError(f"finetune_frozen: resume started at epoch "
                             f"{resumed['start_epoch']}, saved "
                             f"{saved['epoch']}")
    return {"launches": launches, "frozen_parameters": len(frozen),
            "trainable_parameters": len(trainable),
            "running_statistics": len(stats),
            "checkpoint_entries": len(saved["model"]),
            "step_loss": record["step_loss"],
            "resume": {"saved_epoch": saved["epoch"],
                       "start_epoch": resumed["start_epoch"]}}


DESED_CLIPS = 16


def desed_phase(weak_exp: Path) -> dict:
    """Zero-shot DESED scoring (``evaluation/desed.py``) with
    ``GroundingPredictor.from_experiment`` on the WSTAG run: 16 synthetic
    10 s clips (noise, a tone over each ground-truth event) x the 10
    classes, one forward of 10 rows a clip; PSDS1, PSDS2 and macro-F1
    finite in [0, 1], row 13's forward once a forward; host seconds of
    scoring and of the metrics."""
    import math

    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import GroundingPredictor
    from texttoaudiogrounding_tpu_torch.evaluation.desed import (
        DESED_CLASSES, evaluate_desed_macro_f1, evaluate_desed_psds,
        score_clips_zero_shot)

    rng = np.random.default_rng(19)
    n = SR * CLIP_S
    clips, ground_truth = {}, {}
    for i in range(DESED_CLIPS):
        wav = rng.normal(0, 0.01, n).astype(np.float32)
        events = []
        for j in range(int(rng.integers(1, 4))):
            cls = DESED_CLASSES[(i + j * 3) % len(DESED_CLASSES)]
            on = round(float(rng.uniform(0.0, 0.7)) * CLIP_S, 3)
            off = round(on + float(rng.uniform(0.05, 0.3)) * CLIP_S, 3)
            idx = np.arange(int(on * SR), min(int(off * SR), n))
            tone = _TONES[DESED_CLASSES.index(cls) % len(_TONES)]
            wav[idx] += 0.3 * np.sin(2 * np.pi * tone * idx / SR)
            events.append((on, min(off, float(CLIP_S)), cls))
        clips[f"desed{i}"] = wav
        ground_truth[f"desed{i}"] = events
    durations = {aid: float(CLIP_S) for aid in clips}
    pred = GroundingPredictor.from_experiment(weak_exp, device=DEVICE)
    forwards = len(clips) * len(pred._chunk_plan(len(DESED_CLASSES)))
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = score_clips_zero_shot(pred, clips, pred.time_resolution)
    scoring_s = time.perf_counter() - t0
    launches = _counts()
    if launches != _want(gru_fwd=forwards):
        raise AssertionError(f"desed: kernel launches {launches}, expected "
                             f"gru_fwd {forwards}")
    t0 = time.perf_counter()
    psds = evaluate_desed_psds(scores, ground_truth, durations)
    psds_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f1 = evaluate_desed_macro_f1(scores, ground_truth, durations,
                                 time_resolution=pred.time_resolution)
    f1_s = time.perf_counter() - t0
    metrics = {**psds, "macro_f1": f1["macro_f1"]}
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0
               for v in metrics.values()):
        raise AssertionError(f"desed: metrics out of [0, 1]: {metrics}")
    frames = {len(t["onset"]) for t in scores.values()}
    return {"clips": DESED_CLIPS, "classes": len(DESED_CLASSES),
            "forwards": forwards, "launches": launches, "metrics": metrics,
            "frames": sorted(frames), "scoring_s": scoring_s,
            "psds_s": psds_s, "macro_f1_s": f1_s}


# ------------------- sentence-level WSTAG, self-supervision, cross models
SENTENCE_PHRASE_YAML = ("configs/weak_sentence/phrase_wise/"
                        "cnn8rnn_w2vmean_dp_amean_tmean.yaml")
SENTENCE_WORD_YAML = ("configs/weak_sentence/word_wise/"
                      "cnn8rnn_w2v_dp_amean_tmean.yaml")
SELFSUP_YAML = "configs/weak_phrase/cnn8rnn_w2vmean_clustering_selfsup.yaml"
SENTENCE_EPOCHS, SENTENCE_STEPS, SENTENCE_VAL_BATCHES = 2, 4, 2
WORD_EPOCHS = 1
SELFSUP_CLUSTERS = 32
# the keys of the three configs that the phases change: the run's directory,
# the data made in memory (the sentence datasets' waveforms by audio id and
# label lists; the self-supervision sampler's WAV index, label list and
# cluster map under the run's work directory) and the tokenizer's
# vocabulary file, the train loader's worker processes (none), the epochs
# cut to SENTENCE_EPOCHS (the word-wise run WORD_EPOCHS) of SENTENCE_STEPS
# (SENTENCE_VAL_BATCHES validation batches), and the teacher's checkpoint
# for teacher.pretrained, which neither package reads
_DATA_CUTS = tuple(f"data.{split}.{key}" for split in ("train", "val")
                   for key in ("dataset.args.label",
                               "collate_fn.args.tokenizer.args.vocabulary"))
SENTENCE_CUTS = ("experiment_path", "data.train.dataloader_args.num_workers",
                 "trainer.epochs", "trainer.epoch_length", *_DATA_CUTS,
                 "data.train.dataset.args.waveform",
                 "data.val.dataset.args.waveform")
SELFSUP_CUTS = ("experiment_path", "data.train.dataloader_args.num_workers",
                "trainer.epochs", "trainer.epoch_length", *_DATA_CUTS,
                "data.train.dataset.args.audio",
                "data.val.dataset.args.audio",
                "data.train.dataset.args.cluster_map",
                "data.val.dataset.args.cluster_map", "teacher.pretrained",
                "teacher.checkpoint")
CROSS_CLIPS, CROSS_PHRASES = 4, 8


def _sentence_model(kind: str) -> dict:
    """The model of ``configs/weak_sentence/{phrase,word}_wise``: an align
    model on Cnn8Rnn, ``EmbeddingAgg(5221, 512)``, ``AlignDotProduct``
    without ``l2norm`` or scaling, ``AudioMeanTextMean``."""
    return {"type": kind, "args": {"shared_dim": 512, "add_proj": False},
            "audio_encoder": {"type": "Cnn8Rnn",
                              "args": {"sample_rate": SR}},
            "text_encoder": {"type": "EmbeddingAgg",
                             "args": {"embed_dim": 512, "vocab_size": 5221,
                                      "aggregation": "mean"}},
            "match_fn": {"type": "AlignDotProduct",
                         "args": {"l2norm": False, "scaled": False}},
            "sim_pooling": {"type": "AudioMeanTextMean", "args": {}}}


def _sentence_config(exp_dir: str, kind: str, data: dict, epochs: int
                     ) -> dict:
    """``configs/weak_sentence/*/cnn8rnn_*.yaml`` as a dict, cut as
    ``SENTENCE_CUTS`` lists: ``kind`` is the model, ``data`` the
    ``data.train`` / ``data.val`` entries."""
    return {
        "experiment_path": exp_dir, "seed": 1, "data": data,
        "model": _sentence_model(kind),
        "loss": {"type": "MaxMarginRankingLoss", "args": {}},
        "optimizer": {"type": "Adam", "args": {"lr": 0.001}},
        "lr_scheduler": {"type": "ReduceLROnPlateau",
                         "args": {"mode": "min", "factor": 0.1,
                                  "patience": 3, "threshold": 0.001}},
        "trainer": {"metric_monitor": {"mode": "min", "name": "loss"},
                    "epochs": epochs, "epoch_length": SENTENCE_STEPS,
                    "early_stop": 10, "lr_update_interval": "epoch",
                    "save_interval": 10, "include_optim_in_ckpt": False,
                    "max_grad_norm": 1.0}}


def _sentence_data(work: Path, words: bool) -> dict:
    """``data.train`` / ``data.val`` over clips made in memory: 10 s of
    noise (16 distinct clips, float16 as the packed HDF5 files hold) under
    audio ids, captions of 1-6 phrases of 1-4 words from a seeded pool over
    the vocabulary (phrase-wise: ``AudioCaptionPhrasesDataset`` +
    ``VarNumTextCollate``) or of 8-20 words (word-wise:
    ``AudioCaptionDataset`` + ``TextCollate`` of the caption)."""
    import numpy as np

    rng = np.random.default_rng(23 if words else 22)
    noise = [rng.normal(0, 0.01, SR * CLIP_S).astype(np.float16)
             for _ in range(16)]
    vocab = np.array([f"w{i}" for i in range(2, 5000)])
    pool = np.array([" ".join(rng.choice(vocab, int(rng.integers(1, 5))))
                     for _ in range(WEAK_POOL)])

    def split(prefix: str, clips: int) -> dict:
        label, waves = [], {}
        for i in range(clips):
            aid = f"{prefix}{i}"
            waves[aid] = noise[i % len(noise)]
            phrases = [str(p) for p in rng.choice(
                pool, int(rng.integers(1, 7)), replace=False)]
            label.append({"audiocap_id": i, "audio_id": aid,
                          "tokens": " ".join(rng.choice(
                              vocab, int(rng.integers(8, 21)))),
                          "phrases": [{"phrase": p} for p in phrases]})
        collate = {"type": "VarNumTextCollate", "args": {
            "text_key": "caption" if words else "phrases",
            "pad_keys": ["waveform"], "pad_buckets": {"waveform": 32000},
            "text_bucket": 4, "tokenizer": {
                "type": "DictTokenizer",
                "args": {"vocabulary": str(work / "vocab.pkl")}}}}
        if words:
            collate["type"] = "TextCollate"
        return {"dataset": {"type": ("AudioCaptionDataset" if words
                                     else "AudioCaptionPhrasesDataset"),
                            "args": {"waveform": waves, "label": label}},
                "collate_fn": collate,
                "dataloader_args": {"batch_size": TRAIN_CLIPS}}

    data = {"train": split("cap", TRAIN_CLIPS * SENTENCE_STEPS),
            "val": split("capval", TRAIN_CLIPS * SENTENCE_VAL_BATCHES)}
    data["train"]["dataloader_args"]["num_workers"] = 0
    return data


def _fit_checked(label: str, train, want: dict) -> tuple:
    """Run ``train()`` (a runner's ``train``) with the counts set to 0
    just before and hold it: the counts read just after equal ``want``,
    the checkpoints and log written, every epoch's losses finite.
    Returns (experiment directory, seconds, launches)."""
    import math

    import torch

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp_dir = train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, "
                             f"expected {want}")
    for name in ("best.pth", "last.pth", "train.log"):
        if not (exp_dir / name).is_file():
            raise AssertionError(f"{label}: {name} not written")
    losses = [float(tok) for ln in (exp_dir / "train.log").read_text(
    ).splitlines() if "train_loss" in ln
        for tok in (ln.split("train_loss: ")[1].split()[0],
                    ln.split("val_loss: ")[1].split()[0])]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: epoch losses {losses}")
    return exp_dir, seconds, launches


def train_sentence_phase(tok, work: Path) -> dict:
    """Sentence-level WSTAG on the card: ``WeakSentenceRunner.train`` on the
    phrase-wise config (``AudioTextAlignByPhrase``, ``MaxMarginRankingLoss``)
    at full width, 2 epochs of 4 steps of 32 clips x 10 s and 2 validation
    batches, row 13 forward once a step and backward once a train step;
    its gradients against the all-plain path (f32 limits), the loss on one
    batch over 8 steps, the step timed (CUDA events) and profiled; then the
    word-wise config (``AudioTextAlignByWord`` on 8-20 token captions) for
    1 epoch, and ``WeakSentenceRunner.evaluate`` of it with
    ``word_wise/eval.yaml``'s keys on the evaluate phase's set, again with
    ``gru_kernel=False`` (tracks within 1e-4)."""
    import copy

    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.data.loader import to_device
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        weak_output_transform)
    from texttoaudiogrounding_tpu_torch.training.runner_weak_sentence import (
        WeakSentenceRunner)
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    steps = SENTENCE_EPOCHS * SENTENCE_STEPS
    vals = SENTENCE_EPOCHS * SENTENCE_VAL_BATCHES
    runner = WeakSentenceRunner(device=DEVICE)
    config = _sentence_config(str(work / "sentence_phrase"),
                              "AudioTextAlignByPhrase",
                              _sentence_data(work, words=False),
                              SENTENCE_EPOCHS)
    exp_dir, fit_s, launches = _fit_checked(
        "train_sentence phrase-wise", lambda: runner.train(config),
        _want(gru_fwd=steps + vals, gru_bwd=steps))
    report = {"clips_per_batch": TRAIN_CLIPS, "clip_s": CLIP_S,
              "phrase_wise": {"fit_s": fit_s, "launches": launches}}

    # one validation batch; gradients against the all-plain path
    loader = runner.build_dataloader(config["data"]["val"], shuffle=False)
    batch = to_device(next(iter(loader)), torch.device(DEVICE))
    report["phrase_wise"]["phrases_in_batch"] = int(batch["phrases_num"].sum())
    loss_fn = runner.build_loss()
    model = runner.build_model()
    runner.restore_state(model, exp_dir, "last")
    sd = copy.deepcopy(model.state_dict())
    plain_cfg = copy.deepcopy(config["model"])
    plain_cfg["audio_encoder"]["args"].update(gru_kernel=False,
                                              dropout=[0.0, 0.0])
    ref_model = instantiate(plain_cfg, device=DEVICE)
    ref_model.load_state_dict(sd)
    model.audio_encoder.dropout = (0.0, 0.0)
    gaps = _gaps(_grads(model, batch, weak_output_transform, loss_fn),
                 _grads(ref_model, batch, weak_output_transform, loss_fn))
    worst = _worst(gaps)
    if worst[0] > 2e-2 or worst[1] > 1e-4:
        raise AssertionError(
            f"train_sentence gradients off the plain path: trunk "
            f"{worst[0]}, rest {worst[1]} (limits 2e-2, 1e-4): "
            f"{sorted(gaps.items(), key=lambda kv: -kv[1])[:6]}")
    del ref_model
    model.audio_encoder.dropout = (0.2, 0.5)

    # the loss falls over 8 steps on the batch; step time; one traced step
    opt = Optimizer(config["optimizer"], model.parameters(), 1.0)
    losses = [float(runner.train_step(model, loss_fn, opt, batch,
                                      weak_output_transform))
              for _ in range(8)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train_sentence: loss on a fixed batch does "
                             f"not fall: {losses}")

    def step():
        runner.train_step(model, loss_fn, opt, batch, weak_output_transform)

    step_ms = _cuda_ms(step, 5)
    report["phrase_wise"].update(
        grad_rel_rms_trunk_max=worst[0], grad_rel_rms_rest_max=worst[1],
        fixed_batch_loss=losses, step_ms=step_ms,
        clips_per_s=TRAIN_CLIPS * 1e3 / step_ms,
        trace=_trace(step, step_ms))
    del model, opt

    # word-wise: 1 epoch, then evaluated with word_wise/eval.yaml's keys
    words = WeakSentenceRunner(device=DEVICE)
    wconfig = _sentence_config(str(work / "sentence_word"),
                               "AudioTextAlignByWord",
                               _sentence_data(work, words=True), WORD_EPOCHS)
    wexp, fit_s, launches = _fit_checked(
        "train_sentence word-wise", lambda: words.train(wconfig),
        _want(gru_fwd=WORD_EPOCHS * (SENTENCE_STEPS + SENTENCE_VAL_BATCHES),
              gru_bwd=WORD_EPOCHS * SENTENCE_STEPS))
    report["word_wise"] = {"fit_s": fit_s, "launches": launches}
    waves, label = _eval_data(work)
    batches = -(-2 * EVAL_CLIPS // EVAL_BATCH)
    n_th = EVAL_KEYS["n_thresholds"]
    word_keys = {"time_resolution": 0.04, "word_aggregation": "mean"}
    evaluator = WeakSentenceRunner(device=DEVICE)
    report["word_wise"]["evaluate"] = _evaluated(
        "evaluate sentence word-wise", lambda: evaluator.evaluate(
            wexp, _eval_config(work, waves, label, **word_keys)),
        _want(gru_fwd=batches), wexp, n_th)
    tracks = _tracks(evaluator)
    frames = {len(t) for t in tracks.values()}
    want_frames = (SR * CLIP_S // 320 + 1) // 4       # every frame, uncut
    if len(tracks) != 2 * EVAL_CLIPS or frames != {want_frames}:
        raise AssertionError(f"evaluate sentence: {len(tracks)} tracks of "
                             f"{frames} frames (expected {2 * EVAL_CLIPS} "
                             f"of {want_frames})")
    plain = WeakSentenceRunner(device=DEVICE)
    _evaluated("evaluate sentence gru_kernel=False", lambda: plain.evaluate(
        wexp, _eval_config(work, waves, label, **word_keys,
                           output="result_plain.txt", model_overrides={
                               "audio_encoder": {"args": {
                                   "gru_kernel": False}}})),
        _want(), wexp, n_th)
    gap = _track_gap(_tracks(plain), tracks)
    if gap > 1e-4:
        raise AssertionError(f"evaluate sentence: GRU kernel tracks {gap} "
                             "off the plain GRU's (limit 1e-4)")
    report["word_wise"]["evaluate"]["max_abs_vs_plain_gru"] = gap
    report["word_wise"]["evaluate"]["host_seconds"] = dict(
        evaluator.eval_seconds)
    return report


def _selfsup_config(work: Path, teacher_ckpt: Path,
                    write: bool = True) -> dict:
    """``configs/weak_phrase/cnn8rnn_w2vmean_clustering_selfsup.yaml`` as a
    dict, cut as ``SELFSUP_CUTS`` lists, over data written under ``work``:
    16 WAV clips of 10 s of noise (int16), captions of 2-6 phrases from a
    seeded pool over the vocabulary, and a seeded map of the captions'
    phrases into ``SELFSUP_CLUSTERS`` clusters (``write=False``: the files
    a call with ``write`` made, not written again)."""
    import json as _json

    import numpy as np
    from scipy.io import wavfile

    rng = np.random.default_rng(24)
    root = work / "selfsup_data"
    root.mkdir(parents=True, exist_ok=True)
    wavs = []
    for i in range(16):
        path = root / f"noise{i}.wav"
        noise = rng.normal(0, 0.01, SR * CLIP_S)
        if write:
            wavfile.write(path, SR, (noise * 32767).astype(np.int16))
        wavs.append(path)
    words = np.array([f"w{i}" for i in range(2, WEAK_VOCAB)])
    pool = np.array(sorted({" ".join(rng.choice(words,
                                                int(rng.integers(1, 5))))
                            for _ in range(WEAK_POOL)}))
    labels = {prefix: [{"audiocap_id": i, "audio_id": f"{prefix}{i}",
                        "tokens": "", "phrases": [str(p) for p in rng.choice(
                            pool, int(rng.integers(2, 7)), replace=False)]}
                       for i in range(clips)]
              for prefix, clips in (("ss", TRAIN_CLIPS * SENTENCE_STEPS),
                                    ("ssval", TRAIN_CLIPS
                                     * SENTENCE_VAL_BATCHES))}
    # the captions' phrases in clusters, as k-means over them gives
    used = sorted({p for label in labels.values() for it in label
                   for p in it["phrases"]})
    clusters = rng.integers(0, SELFSUP_CLUSTERS, len(used))
    if write:
        (root / "clusters.json").write_text(_json.dumps(
            {str(c): [p for p, k in zip(used, clusters) if k == c]
             for c in range(SELFSUP_CLUSTERS)}))

    def split(prefix: str) -> dict:
        label = labels[prefix]
        index = root / f"{prefix}.csv"
        if write:
            index.write_text("audio_id\tfile_path\n" + "".join(
                f"{it['audio_id']}\t{wavs[i % len(wavs)]}\n"
                for i, it in enumerate(label)))
        return {"dataset": {"type": "AudioSamplePhrasesDataset", "args": {
                    "label": label, "audio": str(index),
                    "phrase_num": WEAK_PHRASES,
                    "neg_samp_stratg": "clustering", "fix_neg": False,
                    "cluster_map": str(root / "clusters.json"),
                    "max_audio_length": float(CLIP_S)}},
                "collate_fn": {"type": "TextCollate", "args": {
                    "pad_keys": ["waveform"],
                    "pad_buckets": {"waveform": 32000},
                    "text_key": "phrases", "text_bucket": 4,
                    "tokenizer": {"type": "DictTokenizer", "args": {
                        "vocabulary": str(work / "vocab.pkl")}}}},
                "dataloader_args": {"batch_size": TRAIN_CLIPS}}

    model = {"type": "MultiTextBiEncoder",
             "args": {"shared_dim": 512,
                      "text_forward_keys": ["text", "text_len"],
                      "add_proj": False, "pooling": "linear_softmax"},
             "audio_encoder": {"type": "Cnn8Rnn",
                               "args": {"sample_rate": SR,
                                        "freeze_cnn": False,
                                        "freeze_bn": False}},
             "text_encoder": {"type": "EmbeddingAgg",
                              "args": {"vocab_size": WEAK_VOCAB,
                                       "embed_dim": 512}},
             "match_fn": {"type": "DotProduct", "args": {}}}
    data = {"train": split("ss"), "val": split("ssval")}
    data["train"]["dataloader_args"]["num_workers"] = 0
    return {
        "experiment_path": str(work / "selfsup"), "seed": 1, "data": data,
        "model": model,
        "loss": {"type": "ClipFrameBceLoss",
                 "args": {"frame_weight": 0.5, "clip_label_key": "label",
                          "frame_label_key": "frame_label"}},
        "optimizer": {"type": "Adam", "args": {"lr": 0.001}},
        "lr_scheduler": {"type": "ReduceLROnPlateau",
                         "args": {"mode": "min", "patience": 3}},
        "eval_config": {"n_thresholds": 50},
        "inference_args": {"window_size": 1, "time_resolution": 0.04},
        "trainer": {"metric_monitor": {"mode": "min", "name": "loss"},
                    "epochs": SENTENCE_EPOCHS,
                    "epoch_length": SENTENCE_STEPS, "early_stop": 10,
                    "lr_update_interval": "epoch", "save_interval": 10,
                    "include_optim_in_ckpt": False, "max_grad_norm": 1.0},
        "teacher": {**model, "checkpoint": str(teacher_ckpt)}}


def train_selfsup_phase(work: Path, weak_exp: Path) -> dict:
    """``WeakPhraseSelfSupervisionRunner.train`` on the self-supervision
    config at full width (2 epochs of 4 steps of 32 clips x 10 s x 32
    phrases, clustering negatives, 2 validation batches), the teacher
    loaded from the WSTAG (v2) run's ``best.pth``: row 13's forward twice
    a step (student and teacher) and backward once a train step; the
    teacher's parameters and buffers bit for bit unchanged, no checkpoint
    holding a key of it, its ``frame_sim`` on the first batch within 1e-4
    of that checkpoint in a fresh model with ``gru_kernel=False``, the
    fused labels at least the batch's; the step timed (CUDA events)."""
    import copy

    import torch

    from texttoaudiogrounding_tpu_torch.data.loader import to_device
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        WeakPhraseSelfSupervisionRunner)
    from texttoaudiogrounding_tpu_torch.training.train_state import (
        load_checkpoint, load_weights)
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    source = weak_exp / "best.pth"
    config = _selfsup_config(work, source)
    runner = WeakPhraseSelfSupervisionRunner(device=DEVICE)
    built = {}
    build_teacher = runner.build_teacher

    def recorded_teacher():
        teacher = build_teacher()
        built.update({k: v.detach().clone()
                      for k, v in teacher.state_dict().items()})
        return teacher

    runner.build_teacher = recorded_teacher
    steps = SENTENCE_EPOCHS * SENTENCE_STEPS
    vals = SENTENCE_EPOCHS * SENTENCE_VAL_BATCHES
    exp_dir, fit_s, launches = _fit_checked(
        "train_selfsup", lambda: runner.train(config),
        _want(gru_fwd=2 * (steps + vals), gru_bwd=steps))
    teacher = runner.teacher
    moved = [k for k, v in teacher.state_dict().items()
             if not torch.equal(v, built[k])]
    if moved or teacher.training or any(p.requires_grad
                                        for p in teacher.parameters()):
        raise AssertionError(f"train_selfsup: teacher moved {moved[:6]} or "
                             "left eval mode or needs gradients")
    ckpt_source = load_checkpoint(source)["model"]
    loaded = [k for k, v in teacher.state_dict().items()
              if k in ckpt_source and torch.equal(v.cpu(), ckpt_source[k])]
    if len(loaded) != len(ckpt_source):
        raise AssertionError(f"train_selfsup: {len(loaded)} of "
                             f"{len(ckpt_source)} checkpoint entries in "
                             "the teacher")
    student = runner.build_model()
    for name in ("best.pth", "last.pth"):
        keys = set(torch.load(exp_dir / name, weights_only=True)["model"])
        if keys != set(student.state_dict()) or any(
                k.startswith("teacher") for k in keys):
            raise AssertionError(f"train_selfsup: {name} holds "
                                 f"{sorted(keys ^ set(student.state_dict()))[:6]}")

    # the first batch: the teacher against the checkpoint in a fresh plain
    # model; the fused labels
    batch = to_device(next(iter(runner.build_dataloader(
        config["data"]["train"], shuffle=True))), torch.device(DEVICE))
    plain_cfg = copy.deepcopy(config["model"])
    plain_cfg["audio_encoder"]["args"]["gru_kernel"] = False
    ref_teacher = instantiate(plain_cfg, device=DEVICE)
    load_weights(ref_teacher, load_checkpoint(source))
    ref_teacher.eval()
    with torch.no_grad():
        gap = float((teacher(batch)["frame_sim"]
                     - ref_teacher(batch)["frame_sim"]).abs().max())
    if gap > 1e-4:
        raise AssertionError(f"train_selfsup: teacher frame_sim {gap} off "
                             "the checkpoint's plain forward (limit 1e-4)")
    del ref_teacher
    runner.restore_state(student, exp_dir, "last")
    transform = runner.teacher_transform(teacher)
    with torch.no_grad():
        fused = transform(student(batch), batch)
    if not bool((fused["label"] >= batch["label"]).all()) or \
            fused["frame_label"].shape != fused["frame_sim"].shape:
        raise AssertionError("train_selfsup: fused labels below the "
                             "batch's, or frame labels misshapen")

    loss_fn = runner.build_loss()
    opt = Optimizer(config["optimizer"], student.parameters(), 1.0)

    def step():
        runner.train_step(student, loss_fn, opt, batch, transform)

    step_ms = _cuda_ms(step, 5)
    moved = [k for k, v in teacher.state_dict().items()
             if not torch.equal(v, built[k])]
    if moved:
        raise AssertionError(f"train_selfsup: timed steps moved the "
                             f"teacher: {moved[:6]}")
    return {"fit_s": fit_s, "launches": launches,
            "teacher_entries_loaded": len(loaded),
            "teacher_frame_sim_max_abs_vs_plain": gap,
            "label_raised_share": float(
                (fused["label"] > batch["label"]).float().mean()),
            "step_ms": step_ms, "clips_per_s": TRAIN_CLIPS * 1e3 / step_ms,
            "trace": _trace(step, step_ms)}


def _cross_batch(tok, phrases_flat: bool) -> dict:
    """``CROSS_CLIPS`` clips of 10 s (noise, a tone each) with
    ``CROSS_PHRASES`` phrases a clip of 1-4 words, the first half labelled
    positive: ``text [B, N, L]`` for the multi-text models or, with
    ``phrases_flat``, ``VarNumTextCollate``'s ``phrases [B·N, L]`` layout;
    on the card."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.data.collate import (
        TextCollate, VarNumTextCollate)
    from texttoaudiogrounding_tpu_torch.data.loader import to_device

    rng = np.random.default_rng(25)
    items = []
    for i in range(CROSS_CLIPS):
        wav = rng.normal(0, 0.01, SR * CLIP_S).astype(np.float32)
        k = i % 4                             # a tone over an eighth-to-
        idx = np.arange(SR * CLIP_S * (k + 1) // 8,   # quarter of the clip
                        SR * CLIP_S * (k + 3) // 8)
        wav[idx] += 0.3 * np.sin(2 * np.pi * _TONES[i % len(_TONES)] * idx
                                 / SR)
        items.append({"waveform": wav, "phrases": [
            " ".join(f"w{w}" for w in rng.integers(2, 5000,
                                                   int(rng.integers(1, 5))))
            for _ in range(CROSS_PHRASES)],
            "label": np.array([1.0] * (CROSS_PHRASES // 2)
                              + [0.0] * (CROSS_PHRASES // 2), np.float32)})
    make = VarNumTextCollate if phrases_flat else TextCollate
    batch = make(tok, text_key="phrases", pad_keys=["waveform"],
                 pad_buckets={"waveform": 32000}, text_bucket=4)(items)
    return to_device(batch, torch.device(DEVICE))


def cross_models_phase(tok) -> dict:
    """One forward each at full width (Cnn8Rnn, EmbeddingAgg(5221, 512),
    shared 512, no projections) on 4 clips x 8 phrases of the models the
    slice adds: ``MultiTextBiEncoder`` with ``CrossAttentionGating(512)`` +
    a token-level ``DotProduct``, with ``CrossAttention(512, 8)``, with
    ``upsample=True``, and ``AudioTextCrossAlignByPhrase``; each within
    1e-4 relative RMS of the same weights with ``gru_kernel=False``, row
    13's forward once a forward; then one train step of
    ``MultiTextBiEncoderWithAlign`` under ``MultipleLossSum(ClipBceLoss +
    MaxMarginRankingLoss(sim_key="sentence_sim"))``: a finite loss, row
    13's forward and backward once."""
    import collections
    import copy
    import math

    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        WeakPhraseRunner, weak_output_transform)
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    gating = {"type": "CrossAttentionGating", "args": {"embed_dim": 512}}
    token_dot = {"type": "DotProduct", "args": {"text_level": "token"}}

    def multi(match, **extra) -> dict:
        return {"type": "MultiTextBiEncoder",
                "args": {"shared_dim": 512, "add_proj": False},
                "audio_encoder": {"type": "Cnn8Rnn",
                                  "args": {"sample_rate": SR}},
                "text_encoder": {"type": "EmbeddingAgg",
                                 "args": {"vocab_size": WEAK_VOCAB,
                                          "embed_dim": 512}},
                "match_fn": match, **extra}

    cross_align = {**_sentence_model("AudioTextCrossAlignByPhrase"),
                   "match_fn": token_dot, "cross_encoder": gating}
    models = {
        "gating_dot_token": (multi(token_dot, cross_encoder=gating),
                             "frame_sim"),
        "cross_attention": (multi({"type": "CrossAttention", "args": {
            "embed_dim": 512, "num_heads": 8}}), "frame_sim"),
        "upsample": ({**multi({"type": "DotProduct", "args": {}}),
                      "args": {"shared_dim": 512, "add_proj": False,
                               "upsample": True}}, "frame_sim"),
        "cross_align_by_phrase": (cross_align, "sim_matrix"),
    }
    nested, flat = _cross_batch(tok, False), _cross_batch(tok, True)
    report: dict = {"clips": CROSS_CLIPS, "phrases": CROSS_PHRASES}
    total = collections.Counter()
    for seed, (name, (cfg, key)) in enumerate(models.items(), start=30):
        batch = flat if name == "cross_align_by_phrase" else nested
        model = instantiate(cfg, device=DEVICE)
        sd = random_state_dict(model, seed=seed)
        model.load_state_dict(sd)
        plain_cfg = copy.deepcopy(cfg)
        plain_cfg["audio_encoder"]["args"]["gru_kernel"] = False
        plain = instantiate(plain_cfg, device=DEVICE)
        plain.load_state_dict(sd)
        _reset_counts()
        with torch.no_grad():
            out = model(batch)
            launches = _counts()
            ref = plain(batch)
        if launches != _want(gru_fwd=1):
            raise AssertionError(f"cross_models {name}: kernel launches "
                                 f"{launches}, expected gru_fwd 1")
        got, want = out[key].double(), ref[key].double()
        rel = float(torch.sqrt(((got - want) ** 2).mean()
                               / (want ** 2).mean()))
        if not (math.isfinite(rel) and rel <= 1e-4):
            raise AssertionError(f"cross_models {name}: {key} {rel} "
                                 "relative RMS off the plain GRU's")
        with torch.no_grad():
            ms = _cuda_ms(lambda: model(batch), 3)
        total.update(launches)
        report[name] = {"shape": list(out[key].shape), "rel_rms": rel,
                        "launches": _nonzero(launches), "forward_ms": ms}
        del model, plain

    # one train step of the sentence branch's model
    align_cfg = {**multi({"type": "DotProduct", "args": {}}),
                 "type": "MultiTextBiEncoderWithAlign",
                 "align_fn": {"type": "AlignDotProduct", "args": {}},
                 "sentence_pooling": {"type": "AudioMeanTextMean",
                                      "args": {}}}
    loss_cfg = {"type": "MultipleLossSum",
                "args": {"names": ["clip", "sentence"], "weights": [1, 1]},
                "clip": {"type": "ClipBceLoss", "args": {}},
                "sentence": {"type": "MaxMarginRankingLoss",
                             "args": {"sim_key": "sentence_sim"}}}
    model = instantiate(align_cfg, device=DEVICE)
    model.load_state_dict(random_state_dict(model, seed=40))
    runner = WeakPhraseRunner(device=DEVICE)
    opt = Optimizer({"type": "Adam", "args": {"lr": 0.001}},
                    model.parameters(), 1.0)
    _reset_counts()
    loss = float(runner.train_step(model, instantiate(loss_cfg), opt, nested,
                                   weak_output_transform))
    launches = _counts()
    if launches != _want(gru_fwd=1, gru_bwd=1) or not math.isfinite(loss):
        raise AssertionError(f"cross_models with_align step: loss {loss}, "
                             f"kernel launches {launches}")
    total.update(launches)
    report["with_align_step"] = {"loss": loss,
                                 "launches": _nonzero(launches)}
    report["launches"] = dict(total)
    return report


CLASS_MAPPING_YAMLS = {"weak": "configs/class_mapping/kmeans_weak.yaml",
                       "strong": "configs/class_mapping/kmeans_strong.yaml",
                       "eval": "configs/class_mapping/eval.yaml"}
CM_CLASSES, CM_PHRASES = 32, 96
CM_EPOCHS = {"weak": 2, "strong": 1}
CM_STEPS, CM_VAL_BATCHES = 4, 2
# the keys of _class_mapping_config that differ from the YAML files: the
# run's directory, the epochs cut to CM_EPOCHS of CM_STEPS (the training
# configs), the duration TSV of the evaluation set and its batches of
# EVAL_BATCH (eval.yaml names no batch size); the datasets' files are not
# read: their items are made in memory (_memory_loaders)
CLASS_MAPPING_CUTS = {
    "weak": ("experiment_path", "trainer.epochs", "trainer.epoch_length"),
    "strong": ("experiment_path", "trainer.epochs", "trainer.epoch_length"),
    "eval": ("data.test.duration", "data.test.dataloader_args"),
}


def _class_mapping_config(kind: str, exp_dir: str = "",
                          duration: str = "") -> dict:
    """``configs/class_mapping/{kmeans_weak,kmeans_strong,eval}.yaml`` as a
    dict (``kind`` weak, strong or eval), cut as ``CLASS_MAPPING_CUTS``
    lists."""
    collate = {"type": "VarLenPadCollate", "args": {
        "pad_keys": ["waveform"], "pad_buckets": {"waveform": 32000}}}
    if kind == "eval":
        return {
            "data": {"test": {
                "dataset": {"type": "KmeansMappingEvalDataset", "args": {
                    "waveform": "data/audiogrounding/test/waveform.csv",
                    "label": "data/audiogrounding/test/label.json",
                    "phrase_embed":
                        "data/audiocaps/phrase_embedding/clap.pkl",
                    "cluster_model":
                        "experiments/audiocaps/clustering/kmeans/32.pkl"}},
                "collate_fn": collate, "duration": duration,
                "dataloader_args": {"batch_size": EVAL_BATCH}}},
            "time_resolution": 0.04, "window_size": 1, "n_thresholds": 50,
            "resume": "best", "max_efprs": [400, 600, 800, 1000, None],
            "output": "result.txt"}
    weak = kind == "weak"
    if not weak:
        collate = {"type": "VarLenPadCollate", "args": {
            "pad_keys": ["waveform", "strong_label"],
            "pad_buckets": {"waveform": 32000, "strong_label": 100}}}

    def split(name: str, train: bool) -> dict:
        args = {"waveform": "data/audiocaps/waveform.csv",
                "label": f"data/audiocaps/{name}.json",
                "phrase_embed": "data/audiocaps/phrase_embedding/clap.pkl",
                "cluster_model":
                    "experiments/audiocaps/clustering/kmeans/32.pkl",
                "label_type": kind}
        if not weak:
            args["time_resolution"] = 0.04
        return {"dataset": {"type": "KmeansMappingDataset", "args": args},
                "collate_fn": collate,
                "dataloader_args": ({"batch_size": 32, "num_workers": 2}
                                    if train else {"batch_size": 32})}

    return {
        "experiment_path": exp_dir, "seed": 1, "mixup": weak,
        "specaug": weak,
        "data": {"train": split("train", True), "val": split("val", False)},
        "model": {"type": "AudioTagging",
                  "args": {"classes_num": CM_CLASSES,
                           "pooling": "linear_softmax"},
                  "audio_encoder": {"type": "Cnn8Rnn",
                                    "args": {"sample_rate": SR}}},
        "loss": {"type": "ClipBceLoss" if weak else "MaskedFrameBceLoss",
                 "args": {}},
        "optimizer": {"type": "Adam", "args": {"lr": 0.001}},
        "lr_scheduler": {"type": "ReduceLROnPlateau",
                         "args": {"mode": "min", "patience": 3}},
        "trainer": {"metric_monitor": {"mode": "min", "name": "loss"},
                    "epochs": CM_EPOCHS[kind], "epoch_length": CM_STEPS,
                    "early_stop": 10, "save_interval": 10,
                    "max_grad_norm": 1.0}}


def _cm_clusters() -> tuple:
    """The seeded phrase → cluster map of the class-mapping data: a pool of
    ``CM_PHRASES`` two-word phrases, and the clusters of phase 8's eight
    evaluation phrases."""
    import numpy as np
    rng = np.random.default_rng(21)
    pool = {f"w{100 + i} w{300 + i}": int(c) for i, c in enumerate(
        rng.integers(0, CM_CLASSES, CM_PHRASES))}
    evaluated = {f"w{2 + k} w{20 + k}": int(c) for k, c in enumerate(
        rng.integers(0, CM_CLASSES, len(_TONES)))}
    return pool, evaluated


def _cm_items(label_type: str, count: int, seed: int):
    """A dataset of ``KmeansMappingDataset`` items (``label_type`` weak or
    strong) made in memory: 10 s of noise with a tone over one segment for
    each of the clip's 1-3 phrases, at a frequency its cluster sets; the
    labels from the seeded phrase → cluster map (``_cm_clusters``)."""
    import math

    import numpy as np
    from torch.utils.data import Dataset

    pool, _ = _cm_clusters()
    phrases = list(pool)

    class Items(Dataset):
        def __len__(self):
            return count

        def __getitem__(self, i):
            rng = np.random.default_rng((seed, i))
            n = SR * CLIP_S
            wav = rng.normal(0, 0.01, n).astype(np.float32)
            picked = [phrases[j] for j in rng.choice(
                len(phrases), int(rng.integers(1, 4)), replace=False)]
            item = {"audiocap_id": i, "audio_id": f"cm{seed}_{i}",
                    "text": " ".join(picked)}
            weak = np.zeros(CM_CLASSES, np.float32)
            strong = np.zeros((math.floor(n / SR / 0.04) + 1, CM_CLASSES),
                              np.float32)
            for phrase in picked:
                c = pool[phrase]
                on = round(float(rng.uniform(0.05, 0.7)) * CLIP_S, 3)
                off = round(on + float(rng.uniform(0.05, 0.25)) * CLIP_S, 3)
                idx = np.arange(int(on * SR), int(off * SR))
                wav[idx] += 0.3 * np.sin(2 * np.pi * (200.0 + 150.0 * c)
                                         * idx / SR)
                weak[c] = 1
                strong[round(on / 0.04):round(off / 0.04), c] = 1
            item["waveform"] = wav
            if label_type == "weak":
                item["label"] = weak
            else:
                item["weak_label"] = weak
                item["strong_label"] = strong
            return item

    return Items()


def _cm_eval_items(waves: dict, label: list):
    """``KmeansMappingEvalDataset`` items over phase 8's evaluation set
    (one an audio and phrase, ``text_idx`` the phrase's cluster), with the
    label list as ``data``."""
    import numpy as np
    from torch.utils.data import Dataset

    _, clusters = _cm_clusters()
    idxs = [(a, p) for a, it in enumerate(label)
            for p in range(len(it["phrases"]))]

    class Items(Dataset):
        data = label

        def __len__(self):
            return len(idxs)

        def __getitem__(self, index):
            a, p = idxs[index]
            item, phrase = label[a], label[a]["phrases"][p]
            return {"audiocap_id": item["audiocap_id"],
                    "audio_id": item["audio_id"], "text": item["tokens"],
                    "waveform": np.asarray(waves[item["audio_id"]],
                                           np.float32),
                    "text_idx": clusters[phrase["phrase"]],
                    "start_index": phrase["start_index"],
                    "end_index": phrase["end_index"]}

    return Items()


def _memory_loaders(runner, items: dict) -> None:
    """``runner.build_dataloader`` over ``items`` (by the stem of the split's
    label file: train, val, label) in place of the class-mapping datasets'
    files, with the config's collate and loader arguments."""
    from texttoaudiogrounding_tpu_torch.data.loader import build_loader
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    def build(cfg: dict, shuffle: bool):
        kwargs = dict(cfg.get("dataloader_args", {}))
        kwargs.setdefault("shuffle", shuffle)
        kwargs.setdefault("drop_last", shuffle)
        return build_loader(items[Path(cfg["dataset"]["args"]["label"]).stem],
                            instantiate(cfg["collate_fn"]),
                            seed=runner.config.get("seed", 1), **kwargs)

    runner.build_dataloader = build


class _GruBatches:
    """Record each BiGRU call's (train mode, clips) while open."""

    def __enter__(self):
        from texttoaudiogrounding_tpu_torch.models import layers
        self.calls, self._orig = [], layers.BiGRU.forward
        orig, calls = self._orig, self.calls

        def forward(gru, x, dtype=None):
            calls.append((gru.training, int(x.shape[0])))
            return orig(gru, x, dtype)

        layers.BiGRU.forward = forward
        return self

    def __exit__(self, *exc):
        from texttoaudiogrounding_tpu_torch.models import layers
        layers.BiGRU.forward = self._orig


def class_mapping_phase(work: Path) -> dict:
    """Class mapping on the card, the models at full width
    (``AudioTagging(Cnn8Rnn f32, classes_num 32, linear_softmax)``, 10 s
    clips at 32 kHz), data made in memory in the datasets' items through
    ``VarLenPadCollate`` with the configs' collate arguments:

    * ``ClassMappingWeakRunner.train`` on ``kmeans_weak.yaml`` (mixup and
      SpecAugment, ``ClipBceLoss``), 2 epochs of 4 steps of 32 clips and 2
      validation batches: ``gru_fwd`` once a step and a validation batch,
      ``gru_bwd`` once a train step, the train step's BiGRU on 16 clips
      (mixup), checkpoints; the loss falling over 8 steps on one batch
      with the augmentations held fixed (the same λ, and the generator of
      the stripes and dropout masks reseeded before each step); the
      gradients within 2e-2 (trunk) / 1e-4 (after it) of the same step
      with ``gru_kernel=False`` on the same λ and stripes; the step's ms
      (CUDA events, 5 steps); ``evaluate_tagging`` of the run (every AP in
      [0, 1], the TSV written);
    * ``ClassMappingStrongRunner.train`` on ``kmeans_strong.yaml``
      (``MaskedFrameBceLoss``, strong labels at 0.04 s, ``strong_label``
      bucket 100), 1 epoch of 4 steps; ``evaluate`` of it with
      ``eval.yaml``'s keys on phase 8's clips, each phrase given a class
      (``gru_fwd`` once a batch, metrics in [0, 1], ``result.txt``),
      again with ``gru_kernel=False`` (tracks within 1e-4)."""
    import math

    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.data.loader import to_device
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_class_mapping import (
        ClassMappingStrongRunner, ClassMappingWeakRunner, _mixup_lambdas,
        mapping_strong_output_transform, mixup_output_transform)
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    report: dict = {"classes": CM_CLASSES, "clips_per_batch": TRAIN_CLIPS}
    root = work / "class_mapping"
    steps = CM_EPOCHS["weak"] * CM_STEPS
    vals = CM_EPOCHS["weak"] * CM_VAL_BATCHES
    weak_items = {"train": _cm_items("weak", TRAIN_CLIPS * CM_STEPS, 31),
                  "val": _cm_items("weak", TRAIN_CLIPS * CM_VAL_BATCHES, 32)}
    config = _class_mapping_config("weak", str(root / "weak"))
    runner = ClassMappingWeakRunner(device=DEVICE)
    _memory_loaders(runner, weak_items)
    with _GruBatches() as grus:
        exp_dir, fit_s, launches = _fit_checked(
            "class_mapping weak fit", lambda: runner.train(config),
            _want(gru_fwd=steps + vals, gru_bwd=steps))
    clips = sorted({(train, n) for train, n in grus.calls})
    if clips != [(False, TRAIN_CLIPS), (True, TRAIN_CLIPS // 2)]:
        raise AssertionError(f"class_mapping weak fit: the BiGRU ran on "
                             f"(train mode, clips) {clips}")
    weak = {"fit_s": fit_s, "launches": launches,
            "gru_batches": {"train": TRAIN_CLIPS // 2, "val": TRAIN_CLIPS}}

    # one batch with fixed mixup coefficients and the SpecAugment flag
    loss_fn = runner.build_loss()
    batch = to_device(next(iter(runner.build_dataloader(
        config["data"]["train"], shuffle=False))), torch.device(DEVICE))
    batch["mixup_lambda"] = torch.from_numpy(_mixup_lambdas(
        np.random.RandomState(7), TRAIN_CLIPS)).to(DEVICE)
    aug = {**batch, "specaug": True}
    model = runner.build_model()
    runner.restore_state(model, exp_dir, "last")
    sd = {k: v.clone() for k, v in model.state_dict().items()}

    def same_draws(m):
        """The stripes (and dropout masks) drawn anew from one seed."""
        m.audio_encoder._generator = None
        torch.manual_seed(11)

    plain_cfg = json.loads(json.dumps(config["model"]))
    plain_cfg["audio_encoder"]["args"].update(gru_kernel=False,
                                              dropout=[0.0, 0.0])
    ref_model = instantiate(plain_cfg, device=DEVICE)
    ref_model.load_state_dict(sd)
    model.audio_encoder.dropout = (0.0, 0.0)
    same_draws(ref_model)
    ref = _grads(ref_model, aug, mixup_output_transform, loss_fn)
    same_draws(model)
    gaps = _gaps(_grads(model, aug, mixup_output_transform, loss_fn), ref)
    worst_trunk, worst_rest = _worst(gaps)
    if worst_trunk > 2e-2 or worst_rest > 1e-4:
        raise AssertionError(
            f"class_mapping weak gradients off the plain path: trunk "
            f"{worst_trunk}, rest {worst_rest} (limits 2e-2, 1e-4): "
            f"{sorted(gaps.items(), key=lambda kv: -kv[1])[:6]}")
    del ref_model, ref
    model.audio_encoder.dropout = (0.2, 0.5)
    model.load_state_dict(sd)
    opt = Optimizer(config["optimizer"], model.parameters(), 1.0)
    losses = []
    for _ in range(8):
        same_draws(model)
        losses.append(float(runner.train_step(
            model, loss_fn, opt, batch, mixup_output_transform)))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"class_mapping weak: loss on a fixed batch "
                             f"with fixed augmentations does not fall: "
                             f"{losses}")

    def step():
        runner.train_step(model, loss_fn, opt, batch, mixup_output_transform)

    step_ms = _cuda_ms(step, 5)
    del model, opt
    weak.update(grad_rel_rms_trunk_max=worst_trunk,
                grad_rel_rms_rest_max=worst_rest, fixed_batch_loss=losses,
                step_ms=step_ms, clips_per_s=TRAIN_CLIPS * 1e3 / step_ms)

    tagger = ClassMappingWeakRunner(device=DEVICE)
    _memory_loaders(tagger, weak_items)
    _reset_counts()
    result = tagger.evaluate_tagging(exp_dir, {"resume": "best",
                                               "output": "tagging.tsv"})
    tag_launches = _counts()
    if tag_launches != _want(gru_fwd=CM_VAL_BATCHES):
        raise AssertionError(f"evaluate_tagging: kernel launches "
                             f"{tag_launches}")
    ap = result["ap"]
    if ap.shape != (CM_CLASSES,) or not all(
            math.isfinite(v) and 0.0 <= v <= 1.0 for v in ap):
        raise AssertionError(f"evaluate_tagging: AP {ap}")
    rows = (exp_dir / "tagging.tsv").read_text().splitlines()
    if len(rows) != CM_CLASSES + 1 or rows[0] != "label_index\tap":
        raise AssertionError("evaluate_tagging: the TSV is not written")
    weak["evaluate_tagging"] = {"mean_ap": float(ap.mean()),
                                "launches": tag_launches}
    report["weak"] = weak

    # the strong fit and its evaluation on phase 8's clips
    strong_items = {
        "train": _cm_items("strong", TRAIN_CLIPS * CM_STEPS, 33),
        "val": _cm_items("strong", TRAIN_CLIPS * CM_VAL_BATCHES, 34)}
    config = _class_mapping_config("strong", str(root / "strong"))
    runner = ClassMappingStrongRunner(device=DEVICE)
    _memory_loaders(runner, strong_items)
    steps = CM_EPOCHS["strong"] * CM_STEPS
    exp_dir, fit_s, launches = _fit_checked(
        "class_mapping strong fit", lambda: runner.train(config),
        _want(gru_fwd=steps + CM_EPOCHS["strong"] * CM_VAL_BATCHES,
              gru_bwd=steps))
    model = runner.build_model()
    runner.restore_state(model, exp_dir, "last")
    batch = to_device(next(iter(runner.build_dataloader(
        config["data"]["train"], shuffle=False))), torch.device(DEVICE))
    opt = Optimizer(config["optimizer"], model.parameters(), 1.0)
    loss_fn = runner.build_loss()
    strong_ms = _cuda_ms(lambda: runner.train_step(
        model, loss_fn, opt, batch, mapping_strong_output_transform), 5)
    del model, opt
    waves, label = _eval_data(work)
    eval_items = {"label": _cm_eval_items(waves, label)}
    out = {}
    for name, overrides in (("kernel", None), ("plain_gru", {
            "audio_encoder": {"args": {"gru_kernel": False}}})):
        evaluator = ClassMappingStrongRunner(device=DEVICE)
        _memory_loaders(evaluator, eval_items)
        eval_cfg = _class_mapping_config("eval",
                                         duration=str(work / "duration.tsv"))
        if overrides:
            eval_cfg["model_overrides"] = overrides
        want = _want(gru_fwd=math.ceil(len(eval_items["label"])
                                       / EVAL_BATCH)) if overrides is None \
            else _want()
        out[name] = _evaluated(
            f"class_mapping evaluate ({name})",
            lambda: evaluator.evaluate(exp_dir, eval_cfg), want, exp_dir,
            eval_cfg["n_thresholds"])
        out[name]["host_seconds"] = dict(evaluator.eval_seconds)
        out[name]["tracks"] = _tracks(evaluator)
    gap = _track_gap(out["kernel"].pop("tracks"),
                     out["plain_gru"].pop("tracks"))
    if gap > 1e-4:
        raise AssertionError(f"class_mapping evaluate: tracks {gap} off the "
                             "plain GRU's (limit 1e-4)")
    report["strong"] = {"fit_s": fit_s, "launches": launches,
                        "step_ms": strong_ms,
                        "clips_per_s": TRAIN_CLIPS * 1e3 / strong_ms,
                        "evaluate": out["kernel"],
                        "evaluate_plain_gru": out["plain_gru"],
                        "max_abs_vs_plain_gru": gap,
                        "phrases": len(eval_items["label"])}
    return report


def cli_phase(work: Path, strong_exp: Path) -> dict:
    """The command line on the card, in this process
    (``cli.main([..., "--device", "cuda"])``) against phase 5's strong
    run: ``inference`` on a WAV file written here (the segments those of
    ``from_experiment`` + ``median_filter`` + ``find_contiguous_regions``
    done by hand, ``gru_fwd`` once; ``run_inference`` at the track's
    median as the threshold likewise); ``export`` of the run, then
    ``predictor_from_deployment`` on the directory (a request of 3 clips:
    ``frame_sim`` bit for bit ``from_experiment``'s); ``strong
    calc_params`` (the flax tree's count: every parameter but the GRU's
    r/z recurrent biases); ``strong calc_params_macs`` (its
    ``SystemExit``); then ``python3 -m texttoaudiogrounding_tpu_torch
    inference`` in a subprocess (exit 0, the same segments).  The commands
    that take ``key=value`` overrides need PyYAML and run on the CPU
    only."""
    import contextlib
    import io

    import numpy as np
    import torch
    from scipy.io import wavfile

    from texttoaudiogrounding_tpu_torch import GroundingPredictor, cli
    from texttoaudiogrounding_tpu_torch.data.h5io import load_wav
    from texttoaudiogrounding_tpu_torch.deployment import (
        predictor_from_deployment)
    from texttoaudiogrounding_tpu_torch.evaluation.decode import (
        find_contiguous_regions, median_filter)
    from texttoaudiogrounding_tpu_torch.inference import run_inference
    from texttoaudiogrounding_tpu_torch.models.layers import BiGRU
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        CALC_PARAMS_MACS_MESSAGE)
    from texttoaudiogrounding_tpu_torch.utils.config import load_config
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    waves, label = _eval_data(work)
    wav_path = work / "clip.wav"
    wavfile.write(wav_path, SR, waves["eval0"].astype(np.float32))
    phrase = label[0]["phrases"][0]["phrase"]
    exp = str(strong_exp)
    report: dict = {}

    # inference: the command against the same steps by hand
    _reset_counts()
    t0 = time.perf_counter()
    segments = cli.main(["inference", "--experiment_path", exp, "--audio",
                         str(wav_path), "--phrase", phrase, "--device",
                         DEVICE])
    report["inference_s"] = time.perf_counter() - t0
    launches = _counts()
    if launches != _want(gru_fwd=1):
        raise AssertionError(f"cli inference: kernel launches {launches}")
    pred = GroundingPredictor.from_experiment(exp, device=DEVICE)
    wave = load_wav(str(wav_path), SR)
    probs, lengths = pred.predict(wave[None], [wave.shape[0]], [phrase],
                                  return_length=True)
    prob = probs[0][:max(int(lengths[0]), 1)]
    filtered = median_filter(prob[None], window_size=1, threshold=0.5)[0]
    by_hand = [[row[0] * pred.time_resolution, row[1] * pred.time_resolution]
               for row in find_contiguous_regions(filtered)]
    if segments != by_hand:
        raise AssertionError(f"cli inference: {segments} != {by_hand}")
    # and at the track's median, where the frames over the threshold make
    # segments whatever the run learnt
    mid = float(np.median(prob))
    filtered = median_filter(prob[None], window_size=1, threshold=mid)[0]
    by_hand_mid = [[row[0] * pred.time_resolution,
                    row[1] * pred.time_resolution]
                   for row in find_contiguous_regions(filtered)]
    segments_mid = run_inference(exp, str(wav_path), phrase, threshold=mid,
                                 device=DEVICE)
    if not by_hand_mid or segments_mid != by_hand_mid:
        raise AssertionError(f"run_inference at {mid}: {segments_mid} != "
                             f"{by_hand_mid}")
    report.update(inference_launches=launches, segments=len(segments),
                  prob_max=float(prob.max()), median_threshold=mid,
                  segments_at_median=len(segments_mid))

    # export, then serve the directory
    deploy_dir = work / "deploy"
    cli.main(["export", "--experiment_path", exp, "--output",
              str(deploy_dir), "--device", DEVICE])
    files = sorted(p.name for p in deploy_dir.iterdir())
    if files != ["config.json", "deploy.json", "model.pth",
                 "modeling_grounding.py", "pytorch_model.bin",
                 "vocabulary.pkl"]:
        raise AssertionError(f"cli export: files {files}")
    deployed = predictor_from_deployment(deploy_dir, device=DEVICE)
    audio = np.stack([waves[f"eval{i}"].astype(np.float32)
                      for i in (1, 2, 3)])
    lens = [SR * CLIP_S, 250000, 160000]
    text = [label[i]["phrases"][0]["phrase"] for i in (1, 2, 3)]
    _reset_counts()
    got = deployed.predict(audio, lens, text)
    served = _counts()
    ref = pred.predict(audio, lens, text)
    if served != _want(gru_fwd=1) or not np.array_equal(got, ref):
        raise AssertionError(
            f"cli export: the deployed predictor's frame_sim is "
            f"{float(np.abs(got - ref).max())} off from_experiment's "
            f"(launches {served})")
    report.update(export_files=files, deployed_launches=served,
                  deployed_max_abs_vs_experiment=float(np.abs(
                      got - ref).max()))
    del pred, deployed

    # calc_params and calc_params_macs
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        n = cli.main(["strong", "calc_params", "--config",
                      str(strong_exp / "config.json"), "--device", DEVICE])
    model = instantiate(load_config(strong_exp / "config.json")["model"],
                        device=DEVICE)
    want = sum(p.numel() for p in model.parameters()) - sum(
        4 * m.hidden for m in model.modules() if isinstance(m, BiGRU))
    del model
    if n != want or printed.getvalue().strip() != f"params: {want}":
        raise AssertionError(f"cli calc_params: {n} / {printed.getvalue()!r}"
                             f", expected {want}")
    try:
        cli.main(["strong", "calc_params_macs", "--config",
                  str(strong_exp / "config.json"), "--device", DEVICE])
    except SystemExit as exc:
        if str(exc) != CALC_PARAMS_MACS_MESSAGE:
            raise AssertionError(f"cli calc_params_macs: {exc}") from None
    else:
        raise AssertionError("cli calc_params_macs did not exit")
    report["calc_params"] = n

    # python3 -m in a process of its own
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "texttoaudiogrounding_tpu_torch",
         "inference", "--experiment_path", exp, "--audio", str(wav_path),
         "--phrase", phrase, "--device", DEVICE], cwd=str(ROOT),
        capture_output=True, text=True, timeout=600)
    report["subprocess_s"] = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or lines[-1] != str(segments):
        raise AssertionError(f"python3 -m inference: rc {proc.returncode}, "
                             f"stdout {proc.stdout[-500:]!r}, stderr "
                             f"{proc.stderr[-1500:]!r}")
    torch.cuda.synchronize()
    return report


# ------------------------------------------------------------ multi_device
# The strong config's ranks: configs/strong/biencoder_train.yaml's keys at
# full width (``_strong_config``), with these cuts.
RELEASED_LENS_S = (10.0, 7.8, 5.0)    # clip lengths (of 10 s), in turn
RELEASED_TOKENS = (4, 16)             # phrase lengths with <s> and </s>


def _released_batch(rng, vocab: int) -> dict:
    """KERNEL_CLIPS clips of CLIP_S s (noise and a tone, the lengths
    ``RELEASED_LENS_S`` in turn, zero after each) and one phrase a clip of
    4-16 token ids (``<s>`` = 0 first, ``</s>`` = 2 last, the rest drawn in
    the vocabulary, padded with 1), on the card."""
    import numpy as np
    import torch

    b, n = KERNEL_CLIPS, SR * CLIP_S
    wave = np.zeros((b, n), np.float32)
    lens = np.array([int(RELEASED_LENS_S[i % 3] * n / 10) for i in range(b)])
    ids = np.ones((b, RELEASED_TOKENS[1]), np.int64)
    mask = np.zeros_like(ids)
    for i in range(b):
        t = np.arange(lens[i])
        wave[i, :lens[i]] = rng.normal(0, 0.05, lens[i]) + 0.2 * np.sin(
            2 * np.pi * _TONES[i % len(_TONES)] * t / SR)
        k = int(rng.integers(RELEASED_TOKENS[0], RELEASED_TOKENS[1] + 1))
        ids[i, 0], ids[i, k - 1] = 0, 2
        ids[i, 1:k - 1] = rng.integers(3, vocab, k - 2)
        mask[i, :k] = 1
    dev = torch.device(DEVICE)
    return {"waveform": torch.from_numpy(wave).to(dev),
            "waveform_len": torch.from_numpy(lens).to(dev),
            "input_ids": torch.from_numpy(ids).to(dev),
            "attention_mask": torch.from_numpy(mask).to(dev)}


def _masked_frames(out: dict):
    """``frame_sim`` with the frames past each clip's length zeroed, as
    ``GroundingPredictor.predict`` serves it."""
    import torch
    fs = out["frame_sim"]
    valid = torch.arange(fs.shape[1], device=fs.device)[None] \
        < out["length"][:, None]
    return fs * valid, valid


def released_model_phase(rng) -> dict:
    """The released grounding model at full width (Cnn8Rnn + the RoBERTa-
    base CLAP text tower, 512-d projections, DotProduct): a reference-
    format checkpoint from a numpy seed through ``import_hf_grounding``
    into the serving model (bf16, int8 blocks), the f32 model, the
    all-plain f32 model (``gru_kernel=False``) and the serving model with
    the bf16 GRU kernel; KERNEL_CLIPS clips x 10 s (10 / 7.8 / 5 s) with a
    4-16 token phrase each, served through the model's forward."""
    import copy

    import torch

    from texttoaudiogrounding_tpu_torch.models.hf_api import (
        clap_text_config,
        cnn8rnn_laionclap_grounding_model,
        import_hf_grounding,
        random_reference_checkpoint,
    )

    cfg = clap_text_config()
    t0 = time.perf_counter()
    models = {
        "serving": cnn8rnn_laionclap_grounding_model(serving=True,
                                                     device=DEVICE),
        "f32": cnn8rnn_laionclap_grounding_model(device=DEVICE),
        "plain": cnn8rnn_laionclap_grounding_model(gru_kernel=False,
                                                   device=DEVICE),
        "gru_kernel": cnn8rnn_laionclap_grounding_model(
            serving=True, gru_kernel=True, device=DEVICE)}
    sd = import_hf_grounding(random_reference_checkpoint(models["serving"],
                                                         50), cfg)
    for model in models.values():
        model.load_state_dict(sd)                               # strict
    setup_s = time.perf_counter() - t0
    batch = _released_batch(rng, cfg.vocab_size)
    report: dict = {"clips": KERNEL_CLIPS, "setup_s": setup_s,
                    "text_params": sum(p.numel() for p in models[
                        "serving"].text_encoder.parameters()),
                    "audio_params": sum(p.numel() for p in models[
                        "serving"].audio_encoder.parameters())}
    launches = {}
    outs = {}
    with torch.no_grad():
        for name, per_forward in (
                ("serving", SERVING_PER_FORWARD),
                ("gru_kernel", {**SERVING_PER_FORWARD, "gru_fwd_bf16": 1})):
            _reset_counts()
            outs[name] = models[name](batch)
            launches[name] = _counts()
            if launches[name] != _want(**per_forward):
                raise AssertionError(
                    f"released_model {name}: launches "
                    f"{_nonzero(launches[name])}, expected {per_forward}")
        outs["plain"] = models["plain"](batch)
        want_len = (batch["waveform_len"] // 320 + 1) // 4
        for name in ("serving", "gru_kernel"):
            out = outs[name]
            if not torch.equal(out["length"], want_len):
                raise AssertionError(f"released_model {name}: lengths")
            fs, valid = _masked_frames(out)
            if not (torch.isfinite(fs).all() and (fs[valid] > 0).all()
                    and (fs[valid] <= 1).all() and not fs[~valid].any()):
                raise AssertionError(f"released_model {name}: frame_sim "
                                     "out of (0, 1]")
            delta = float((fs - _masked_frames(outs["plain"])[0]).abs()
                          .max())
            emb = models[name].audio_encoder(batch)["embedding"].double()
            ref = models["plain"].audio_encoder(batch)["embedding"].double()
            emb_rel = float(torch.sqrt(((emb - ref) ** 2).mean()
                                       / (ref ** 2).mean()))
            if delta >= 0.05 or emb_rel >= 0.05:
                raise AssertionError(
                    f"released_model {name}: |frame_sim - plain f32| "
                    f"{delta}, audio embedding rel RMS {emb_rel}")
            report[name] = {"max_abs_vs_plain_f32": delta,
                            "embedding_rel_rms_vs_plain_f32": emb_rel,
                            "launches": _nonzero(launches[name])}
        f32 = models["f32"](batch)
        delta = float((_masked_frames(f32)[0]
                       - _masked_frames(outs["plain"])[0]).abs().max())
        if delta > 1e-4:
            raise AssertionError(f"released_model f32: {delta} off the "
                                 "plain GRU's")
        report["f32_max_abs_vs_plain"] = delta
        # the text tower on the card against the same tower on the CPU
        text = models["serving"].text_encoder
        cpu_text = copy.deepcopy(text).cpu()
        seq = text(batch)["seq_emb"]
        seq_cpu = cpu_text({k: v.cpu() for k, v in batch.items()})[
            "seq_emb"]
        text_gap = float((seq.cpu() - seq_cpu).abs().max())
        if text_gap > 1e-4:
            raise AssertionError(f"released_model: text seq_emb {text_gap} "
                                 "off the CPU's")
        report["text_seq_emb_max_abs_vs_cpu"] = text_gap
        serving = models["serving"]
        torch.cuda.reset_peak_memory_stats()
        report["forward_ms"] = _cuda_ms(lambda: serving(batch), 10)
        report["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        report["text_tower_ms"] = _cuda_ms(
            lambda: serving.text_encoder(batch), 10)
        report["audio_tower_ms"] = _cuda_ms(
            lambda: serving.audio_encoder(batch), 10)
        report["forward_ms_gru_kernel"] = _cuda_ms(
            lambda: models["gru_kernel"](batch), 10)
        report["forward_ms_f32"] = _cuda_ms(lambda: models["f32"](batch), 3)
        for name, fn, ms in (
                ("text_tower", lambda: serving.text_encoder(batch),
                 report["text_tower_ms"]),
                ("forward_gru_kernel", lambda: models["gru_kernel"](batch),
                 report["forward_ms_gru_kernel"])):
            trace = _trace(fn, ms)
            report[f"trace_{name}"] = {
                k: trace[k] for k in ("device_busy_ms", "device_idle_share",
                                      "port_kernels_ms", "launches")}
            report[f"trace_{name}"]["top"] = trace["top"][:4]
    report["memory_allocated_gib"] = torch.cuda.memory_allocated() / 2**30
    report["launches"] = {k: _nonzero(v) for k, v in launches.items()}
    del models, cpu_text
    torch.cuda.empty_cache()
    return report


ZOO_CROSS_STEPS = {"CrossCnn8Rnn": 8, "CrossCDur": 4}
ZOO_TEXT_ROWS, ZOO_TEXT_T = 80, 20      # RnnEncoder: 2B = 160 rows of T


def _strong_labels(b: int, t: int, lens):
    """Frame labels ``[b, t]``: each clip's tone over its eighth-to-quarter
    (``_TONES``' segments) in frames of ``t``."""
    import torch
    label = torch.zeros(b, t, device=lens.device)
    for i in range(b):
        k = i % 4
        label[i, t * (k + 1) // 8:t * (k + 3) // 8] = 1.0
    return label


def _zoo_audio(rng, clips: int, vocab: int) -> dict:
    """``clips`` clips of CLIP_S s, each of noise with a tone over an
    eighth-to-quarter of it, and a 1-4 word phrase, on the card."""
    import numpy as np
    import torch

    n = SR * CLIP_S
    wave = rng.normal(0, 0.01, (clips, n)).astype(np.float32)
    for i in range(clips):
        k = i % 4
        idx = np.arange(n * (k + 1) // 8, n * (k + 3) // 8)
        wave[i, idx] += 0.3 * np.sin(2 * np.pi * _TONES[i % len(_TONES)]
                                     * idx / SR)
    text_len = rng.integers(1, 5, clips)
    text = np.zeros((clips, 4), np.int64)
    for i in range(clips):
        text[i, :text_len[i]] = rng.integers(2, vocab, text_len[i])
    dev = torch.device(DEVICE)
    return {"waveform": torch.from_numpy(wave).to(dev),
            "waveform_len": torch.full((clips,), n, device=dev),
            "text": torch.from_numpy(text).to(dev),
            "text_len": torch.from_numpy(text_len).to(dev)}


def _trunk(name: str) -> bool:
    """The cross models' conv trunk, with the text tower, whose gradient
    comes back through every block's ``fc_text``."""
    return name.startswith(("conv_block", "block", "bn0", "text_encoder"))


def _zoo_cross(kind: str, batch: dict) -> dict:
    """``kind`` (Cnn8Rnn or CDur trunk, EmbeddingAgg(5000, 512)) in f32,
    train mode (batch statistics) with dropout off: the first step's
    gradients against the all-plain path's, then ZOO_CROSS_STEPS[kind]
    Adam steps of ``FrameBceLoss`` on the batch: row 13's forward and
    backward once a step, the loss falling."""
    import math

    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.losses import FrameBceLoss
    from texttoaudiogrounding_tpu_torch.models import EmbeddingAgg
    from texttoaudiogrounding_tpu_torch.models import cross_models
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer

    cls = getattr(cross_models, kind)

    def make(**kw):
        return cls(SR, EmbeddingAgg(5000, 512), device=DEVICE, **kw)
    model, plain = make(), make(gru_kernel=False)
    sd = random_state_dict(model, seed=60)
    loss_fn = FrameBceLoss()

    def loss_of(m):
        out = m(batch)
        return loss_fn({**out, "label": _strong_labels(
            out["frame_sim"].shape[0], out["frame_sim"].shape[1],
            batch["waveform_len"])})

    grads = {}
    for name, m in (("kernel", model), ("plain", plain)):
        m.load_state_dict(sd)
        m.dropout = 0.0 if kind == "CrossCDur" else (0.0, 0.0)
        m.train()
        m.zero_grad(set_to_none=True)
        loss_of(m).backward()
        grads[name] = {n: p.grad.double() for n, p in m.named_parameters()
                       if p.grad is not None}
    gaps = _gaps(grads["kernel"], grads["plain"])
    trunk = max(g for n, g in gaps.items() if _trunk(n))
    rest = max(g for n, g in gaps.items() if not _trunk(n))
    if not (trunk <= 2e-2 and rest <= 1e-4):
        raise AssertionError(f"zoo {kind}: first-step gradients {trunk} "
                             f"(trunk) / {rest} off the plain path's")
    model.load_state_dict(sd)
    model.train()
    opt = Optimizer({"type": "Adam", "args": {"lr": 1e-3}},
                    model.parameters(), 1.0)
    losses = []
    _reset_counts()
    t0 = time.perf_counter()
    for _ in range(ZOO_CROSS_STEPS[kind]):
        opt.zero_grad()
        loss = loss_of(model)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    launches = _counts()
    steps = ZOO_CROSS_STEPS[kind]
    if launches != _want(gru_fwd=steps, gru_bwd=steps):
        raise AssertionError(f"zoo {kind}: launches {_nonzero(launches)}, "
                             f"expected gru_fwd / gru_bwd {steps}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"zoo {kind}: losses {losses}")

    def step():
        opt.zero_grad()
        loss_of(model).backward()
        opt.step()

    step_ms = _cuda_ms(step, 3)
    model.eval()
    return {"losses": losses, "grad_rel_rms_trunk_max": trunk,
            "grad_rel_rms_rest_max": rest, "step_ms": step_ms,
            "fit_ms_a_step_host": steps_s / steps * 1e3,
            "frames": int(model(batch)["frame_sim"].shape[1]),
            "launches": _nonzero(launches)}


def _zoo_rnn_encoder(rng, hidden: int, rows: int = ZOO_TEXT_ROWS) -> dict:
    """One step of ``RnnEncoder(5000, 300, hidden, bidirectional)`` on
    ``rows`` phrases of up to ZOO_TEXT_T tokens (2B = 2 rows): its
    gradients within 1e-4 relative RMS of the plain GRU's, row 13 on the
    design ``gru.route`` gives the shape: the cluster designs once each
    way at H <= 256; else the first design (``gru.per_step_plan``: H =
    302 padded to 304, and 200 rows split into the launches whose carries
    fit), once a launch of the plan."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.models import RnnEncoder
    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    dev = torch.device(DEVICE)
    lens = rng.integers(1, ZOO_TEXT_T + 1, rows)
    lens[0] = ZOO_TEXT_T
    text = np.zeros((rows, ZOO_TEXT_T), np.int64)
    for i, n in enumerate(lens):
        text[i, :n] = rng.integers(2, 5000, n)
    batch = {"text": torch.from_numpy(text).to(dev),
             "text_len": torch.from_numpy(lens).to(dev)}
    target = torch.randn(rows, 2 * hidden, device=dev,
                         generator=torch.Generator(dev).manual_seed(3))
    grads, launches = {}, {}
    for name, kernel in (("kernel", None), ("plain", False)):
        enc = RnnEncoder(5000, 300, hidden, bidirectional=True,
                         gru_kernel=kernel).to(dev)
        enc.load_state_dict(random_state_dict(enc, seed=61))
        _reset_counts()
        loss = ((enc(batch)["seq_emb"] - target) ** 2).mean()
        loss.backward()
        launches[name] = _counts()
        grads[name] = {n: p.grad.double() for n, p in enc.named_parameters()
                       if p.grad is not None}
        if name == "kernel":
            def step():
                enc.zero_grad()
                ((enc(batch)["seq_emb"] - target) ** 2).mean().backward()
            step_ms = _cuda_ms(step, 3)
    gaps = _gaps(grads["kernel"], grads["plain"])
    route = gru.route(rows, hidden)
    plans = {part: gru.per_step_plan(rows, hidden, part)
             for part in ("forward", "backward")}
    want = _want(**{
        f"gru_{short}" + ("" if route[part] == "cluster" else "_per_step"):
        1 if route[part] == "cluster" else len(plans[part]["groups"])
        for part, short in (("forward", "fwd"), ("backward", "bwd"))})
    if launches["kernel"] != want or max(gaps.values()) > 1e-4:
        raise AssertionError(f"zoo RnnEncoder H={hidden}, {rows} rows: "
                             f"launches {_nonzero(launches['kernel'])} "
                             f"(want {_nonzero(want)}), gradient gap "
                             f"{max(gaps.values())}")
    return {"H": hidden, "rows": 2 * rows, "T": ZOO_TEXT_T,
            "route": route, "per_step_plans": plans,
            "grad_rel_rms_max": max(gaps.values()), "step_ms": step_ms,
            "launches": _nonzero(launches["kernel"])}


def _zoo_gru_plans(rng) -> dict:
    """Row 13's first design by its call plan (``gru.per_step_plan``) at
    H = 302 (padded to 304 with zero units) and at 200 rows of H = 300
    (two launches each way: the carries of 200 rows overflow shared
    memory), T = ZOO_TEXT_T: forward and backward against their plain
    versions within 1e-4 relative RMS, launches by the plan, both timed
    with CUDA events."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import gru

    out = {}
    for label, b, h in (("h302", ZOO_TEXT_ROWS, 302), ("split", 200, 300)):
        _, gy, _, proj, wh, bn, _ = _gru_inputs(rng, ZOO_TEXT_T, b, h, h)
        plans = {p: gru.per_step_plan(b, h, p) for p in ("forward",
                                                         "backward")}
        _reset_counts()
        ys = gru.gru_forward(proj, wh, bn, design="per_step")
        grads = gru.gru_backward(proj, ys, gy, wh, bn, design="per_step")
        torch.cuda.synchronize()
        launches = _counts()
        want = _want(gru_fwd_per_step=len(plans["forward"]["groups"]),
                     gru_bwd_per_step=len(plans["backward"]["groups"]))
        errs = [_err(ys, gru.gru_forward_plain(proj, wh, bn))]
        errs += [_err(g, r) for g, r in zip(grads, gru.gru_backward_plain(
            proj, ys, gy, wh, bn))]
        if launches != want or max(e[1] for e in errs) > 1e-4:
            raise AssertionError(f"zoo row 13 plan {label}: launches "
                                 f"{_nonzero(launches)} (want "
                                 f"{_nonzero(want)}), errors {errs}")
        out[label] = {
            "B": b, "H": h, "plans": plans, "launches": _nonzero(launches),
            "max_abs_err": max(e[0] for e in errs),
            "rel_rms_err": max(e[1] for e in errs),
            "tolerance": "rel_rms <= 1e-4 (f32)",
            "fwd_ms": _cuda_ms(lambda: gru.gru_forward(
                proj, wh, bn, design="per_step"), 3),
            "bwd_ms": _cuda_ms(lambda: gru.gru_backward(
                proj, ys, gy, wh, bn, design="per_step"), 3),
            "fwd_plain_ms": _cuda_ms(lambda: gru.gru_forward_plain(
                proj, wh, bn), 1)}
    return out


def _zoo_attention() -> dict:
    """``IntraAttention(5000, 512, 2)`` and ``SelfAttention(5000, 512, 8)``
    in train mode on 80 phrases of up to 20 tokens: forward and backward
    finite."""
    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.models import (
        IntraAttention,
        SelfAttention,
    )

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(5)
    lens = torch.randint(1, ZOO_TEXT_T + 1, (ZOO_TEXT_ROWS,), device=dev,
                         generator=gen)
    batch = {"text": torch.randint(2, 5000, (ZOO_TEXT_ROWS, ZOO_TEXT_T),
                                   device=dev, generator=gen),
             "text_len": lens}
    out = {}
    for enc in (IntraAttention(5000, 512, 2), SelfAttention(5000, 512, 8)):
        enc = enc.to(dev)
        enc.load_state_dict(random_state_dict(enc, seed=62))
        enc.train()
        emb = enc(batch)
        (emb["seq_emb"].square().mean()
         + emb["token_emb"].square().mean()).backward()
        finite = all(torch.isfinite(p.grad).all() for p in enc.parameters()
                     if p.grad is not None) and all(
            torch.isfinite(v).all() for v in emb.values())
        if not finite:
            raise AssertionError(f"zoo {type(enc).__name__}: not finite")
        out[type(enc).__name__] = {"seq_emb": list(emb["seq_emb"].shape)}
    return out


def _zoo_towers(batch: dict) -> dict:
    """``Cnn14``, ``ResNet38``, ``WavegramLogmelCnn14`` and the AST at full
    width in eval mode on the batch: shapes, finite values, the forward's
    ms, and the first 2 clips within 1e-4 relative RMS of the same tower
    on the CPU (TF32 off)."""
    import copy

    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.models import (
        AudioSpectrogramTransformer,
        Cnn14,
        ResNet38,
        WavegramLogmelCnn14,
    )

    audio = {k: batch[k] for k in ("waveform", "waveform_len")}
    two = {k: v[:2].cpu() for k, v in audio.items()}
    out = {}
    for seed, cls in enumerate((Cnn14, ResNet38, WavegramLogmelCnn14,
                                AudioSpectrogramTransformer), start=70):
        tower = cls(SR, device=DEVICE)
        tower.load_state_dict(random_state_dict(tower, seed=seed))
        with torch.no_grad():
            got = tower(audio)
            ms = _cuda_ms(lambda: tower(audio), 3)
            ref = copy.deepcopy(tower).cpu()(two)
        b = KERNEL_CLIPS
        shapes = {k: list(v.shape) for k, v in got.items()}
        if got["clip_emb"].shape != (b, tower.embed_dim) or not all(
                torch.isfinite(v.float()).all() for v in got.values()):
            raise AssertionError(f"zoo {cls.__name__}: {shapes}, finite?")
        gaps = {}
        for key in ("clip_emb", "time_emb"):
            d = got[key][:2].cpu().double() - ref[key].double()
            gaps[key] = float(torch.sqrt((d ** 2).mean()
                                         / (ref[key].double() ** 2).mean()))
        if max(gaps.values()) > 1e-4:
            raise AssertionError(f"zoo {cls.__name__}: {gaps} off the CPU")
        out[cls.__name__] = {"shapes": shapes, "forward_ms": ms,
                             "rel_rms_vs_cpu": gaps}
        del tower
        torch.cuda.empty_cache()
    return out


def _zoo_clip(batch: dict) -> dict:
    """``AudioTextClip(Cnn14, RetrievalBert at BERT-base width)``: one train
    step of ``InfoNceLoss(tau=1)`` on ``logit_scale · audio_emb @
    text_emb[:, 0]ᵀ`` with ``gradient_clip`` 1.0 and 0.5 from the same
    weights and dropout generator state: the encoders' gradients of the
    second 0.5× the first's within 1e-6 relative, the rest the same.  The
    step (forward, loss, backward) is then timed with CUDA events over 3
    calls after a warm-up, with the default (not the deterministic)
    algorithms, as a user's step runs."""
    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.losses import InfoNceLoss
    from texttoaudiogrounding_tpu_torch.models import AudioTextClip, Cnn14
    from texttoaudiogrounding_tpu_torch.models.layers import Seeded
    from texttoaudiogrounding_tpu_torch.models.pretrained_text import (
        TextTowerConfig,
    )
    from texttoaudiogrounding_tpu_torch.models.retrieval import RetrievalBert

    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(7)
    b = KERNEL_CLIPS
    feed = {"waveform": batch["waveform"], "waveform_len":
            batch["waveform_len"],
            "input_ids": torch.randint(1000, 30000, (b, 1, 16), device=dev,
                                       generator=gen),
            "attention_mask": torch.ones(b, 1, 16, dtype=torch.long,
                                         device=dev)}
    bert = RetrievalBert(TextTowerConfig(), device=DEVICE)
    model = AudioTextClip(Cnn14(SR, device=DEVICE), bert, 2048,
                          bert.embed_dim, 512, device=DEVICE)
    sd = random_state_dict(model, seed=80)
    loss_fn = InfoNceLoss(tau=1.0)

    def step():
        model.zero_grad(set_to_none=True)
        out = model(feed)
        sim = out["logit_scale"] * out["audio_emb"] @ out["text_emb"][:, 0].T
        loss = loss_fn({"sim": sim})
        loss.backward()
        return loss

    grads = {}
    # deterministic algorithms: atomics in a backward (cuDNN's, the
    # embedding's) would sum in another order each run
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    for clip in (1.0, 0.5):
        model.load_state_dict(sd)
        model.gradient_clip = clip
        for m in model.modules():              # the same dropout masks
            if isinstance(m, Seeded):
                m._generator = torch.Generator(dev).manual_seed(11)
        model.train()
        loss = step()
        grads[clip] = {n: p.grad.double() for n, p in model.named_parameters()
                       if p.grad is not None}
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = cudnn_det
    step_ms = _cuda_ms(step, 3)
    model.eval()
    gaps = {}
    for name, g in grads[1.0].items():
        scale = 0.5 if name.startswith(("audio_encoder", "text_encoder")) \
            else 1.0
        ref = scale * g
        d = grads[0.5][name] - ref
        gaps[name] = float(torch.sqrt((d ** 2).mean()
                                      / (ref ** 2).mean().clamp_min(1e-30)))
    worst = max(gaps.values())
    if not (worst <= 1e-6 and torch.isfinite(loss)):
        raise AssertionError(
            f"zoo AudioTextClip: gradient_clip 0.5 off 0.5x by {worst}: "
            f"{sorted(gaps.items(), key=lambda kv: -kv[1])[:4]}")
    return {"loss": float(loss.detach()), "grad_scale_rel_err_max": worst,
            "step_ms": step_ms}


def _roberta_framed(vocab: int):
    """A stand-in for RoBERTa's tokenizer (no tokenizer files here): each
    word one id in [3, ``vocab``) by its CRC-32, framed by ``<s>`` = 0 and
    ``</s>`` = 2, padded with 1, with the attention mask."""
    import zlib

    import numpy as np

    def tokenize(batch: list) -> dict:
        ids = [[0] + [zlib.crc32(w.encode()) % (vocab - 3) + 3
                      for w in p.split()] + [2] for p in batch]
        width = max(len(x) for x in ids)
        out = np.ones((len(ids), width), np.int64)
        mask = np.zeros_like(out)
        for i, x in enumerate(ids):
            out[i, :len(x)], mask[i, :len(x)] = x, 1
        return {"input_ids": out, "attention_mask": mask}
    return tokenize


def _zoo_phrases(text_encoder, vocab: int) -> dict:
    """The encode loop of ``tools.embeddings.extract_phrase_embeddings``
    (``encode_phrases``, 64 phrases a call) over 1,000 phrases of 1-5
    words on the released model's CLAP tower, tokenized as RoBERTa frames
    them: the host seconds."""
    import numpy as np

    from texttoaudiogrounding_tpu_torch.tools.embeddings import (
        encode_phrases,
    )

    rng = np.random.default_rng(90)
    words = [f"w{i}" for i in range(2000)]
    phrases = sorted({" ".join(rng.choice(words, int(rng.integers(1, 6))))
                      for _ in range(1200)})[:1000]
    t0 = time.perf_counter()
    embs = encode_phrases(text_encoder, _roberta_framed(vocab), phrases)
    seconds = time.perf_counter() - t0
    vals = np.stack(list(embs.values()))
    if len(embs) != len(phrases) or not np.isfinite(vals).all():
        raise AssertionError("zoo phrase embeddings")
    return {"phrases": len(embs), "host_s": seconds}


def zoo_phase() -> dict:
    """The rest of the model zoo on the card: the cross models' f32 steps,
    ``RnnEncoder`` at H = 256 and 300, the attention text encoders, the
    four retrieval towers, an ``AudioTextClip`` step and the phrase
    embeddings of 1,000 phrases."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.models.hf_api import (
        clap_text_config,
    )
    from texttoaudiogrounding_tpu_torch.models.pretrained_text import (
        ClapTextEncoder,
    )
    from texttoaudiogrounding_tpu_torch import random_state_dict

    rng = np.random.default_rng(59)
    t0 = time.perf_counter()
    batch = _zoo_audio(rng, KERNEL_CLIPS, 5000)
    report: dict = {"cross": {k: _zoo_cross(k, batch)
                              for k in ZOO_CROSS_STEPS}}
    report["rnn_encoder"] = {h: _zoo_rnn_encoder(rng, h)
                             for h in (256, 300, 302)}
    report["rnn_encoder_split"] = _zoo_rnn_encoder(rng, 300, 200)
    report["gru_plans"] = _zoo_gru_plans(rng)
    report["attention"] = _zoo_attention()
    report["towers"] = _zoo_towers(batch)
    report["clip"] = _zoo_clip(batch)
    clap = ClapTextEncoder(clap_text_config(), device=DEVICE)
    clap.load_state_dict(random_state_dict(clap, seed=91))
    report["phrase_embeddings"] = _zoo_phrases(
        clap, clap_text_config().vocab_size)
    report["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return report


MULTI_DEVICE_CUTS = (
    "trainer.epochs: TRAIN_EPOCHS (2) of epoch_length TRAIN_STEPS (4)",
    "data: 32 clips of 10 s at 32 kHz a batch made in memory from a seed "
    "(_loaders), not the HDF5 files; the loader in the rank's process",
    "experiment_path: a temporary directory",
    "parallel.mesh: each part's; parallel.rules (c): MD_RULES")
# configs/strong/biencoder_train_dp4tp2.yaml's rules (PyYAML is not on the
# card's machine; the CPU tests read the file itself)
MD_RULES = [{"match": ["fc1", "kernel"], "spec": [None, "model"]},
            {"match": ["text_encoder", "embed", "embedding"],
             "spec": ["model", None]}]
MD_BF16_ARGS = {"dtype": "bfloat16", "gru_bwd": "bf16", "bn_pool": [64, 128]}
# JAX tests/test_multichip.py's dp8 limit (4 steps): the first epoch's
# losses of (b) and (c), and (d)'s loss
MD_LOSS_RTOL = 2e-4
# Splitting the batch sums over ranks moves f32 activations by rounding,
# as scaling every waveform by a rounding-sized 1 +- 1e-6 moves the
# one-rank fit, and Adam carries such changes on from step to step: on an
# H100 the second epoch's losses lie up to 2.7e-4 off and the first step's
# gradients after the trunk 6.9e-4 (the one-rank fit's own change: 9.5e-5
# and 6.9e-4).  Hence fixed limits above that, for all the losses and for
# the gradients (trunk, after it); bn0 on its rank's rows alone, a wrong
# data-parallel step, must fail them (PERF.md §6).
MD_FIT_LOSS_RTOL = 1e-3
MD_GRAD_LIMITS = (2e-2, 2e-3)
MD_WAVE_SCALES = (1 + 1e-6, 1 - 1e-6)
MD_SPLIT_CLIPS = 16                 # a dp2 rank's rows of the batch of 32


def _md_fit(tok, work: Path, exp: str, mesh: dict | None, rules=None,
            resume: str | None = None, epochs: int = TRAIN_EPOCHS,
            device: str = DEVICE, wave_scale: float = 1.0) -> dict:
    """The strong fit of ``training_phase`` (same config, data and
    weights) on ``mesh``: its record, the first step's gradients at full
    shapes and running statistics after it, the fit's launches, the rows
    each BiGRU call saw, the step ms by CUDA events (5 steps on a fixed
    batch of the rank's rows), the runner, the model and the directory.
    ``wave_scale`` scales every waveform the audio encoder reads."""
    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.parallel.mesh import device_feed
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner, strong_output_transform)

    first: dict = {}

    class Capture(StrongRunner):
        def post_grad_hook(self, loss, grads):
            if first:
                return
            shards = getattr(self.model, "tp_shards", {})
            for n, p in self.model.named_parameters():
                if p.grad is not None:
                    g = p.grad.detach()
                    g = shards[n].gather(g) if n in shards else g
                    first[n] = g.double().cpu()
            first["running"] = {n: b.detach().double().cpu() for n, b in
                                self.model.named_buffers() if "running" in n}

    runner = Capture(device=device)
    cfg = {**_strong_config(str(work / exp)), "data": _train_data(work)}
    cfg["trainer"]["epochs"] = epochs
    if mesh is not None:
        cfg["parallel"] = {"mesh": mesh, **({"rules": rules} if rules
                                            else {})}
    if resume:
        cfg["resume"] = resume
    config = runner.setup(cfg)
    exp_dir = runner.prepare_experiment()
    train_loader, val_loader = _loaders(tok, config["seed"])
    model = runner.build_model()
    model.load_state_dict(random_state_dict(model, seed=1))
    loss_fn = runner.build_loss()
    rows: list = []
    hook = model.audio_encoder.rnn.register_forward_hook(
        lambda mod, args, out: rows.append(args[0].shape[0]))
    if wave_scale != 1.0:
        model.audio_encoder.register_forward_pre_hook(
            lambda mod, args: ({**args[0], "waveform":
                                args[0]["waveform"] * wave_scale},))
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    record = runner.fit(model, loss_fn, train_loader, val_loader,
                        strong_output_transform, exp_dir)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _counts()
    hook.remove()
    batch, _, _ = next(device_feed([next(iter(val_loader))], runner.mesh,
                                   runner.device))
    step_ms = _cuda_ms(lambda: runner.train_step(
        model, loss_fn, runner.optimizer, batch, strong_output_transform), 5)
    shapes = {n: list(p.shape) for n, p in model.named_parameters()}
    moments = {n: list(runner.optimizer.inner.state[p]["exp_avg"].shape)
               for n, p in model.named_parameters()
               if p in runner.optimizer.inner.state}
    return {"record": record, "first": first, "launches": launches,
            "gru_rows": sorted(set(rows)), "fit_s": fit_s, "step_ms": step_ms,
            "mesh": runner.mesh.shape, "shapes": shapes, "moments": moments,
            "exp_dir": str(exp_dir), "runner": runner, "model": model}


def _md_public(fit: dict) -> dict:
    return {k: v for k, v in fit.items() if k not in ("runner", "model")}


def _md_bf16_step(tok, work: Path, mesh: dict | None, device: str,
                  wave_scale: float = 1.0) -> dict:
    """Route (b) (``MD_BF16_ARGS``) for one step on the first training
    batch (the rank's rows, its waveform scaled by ``wave_scale``) from
    ``training_phase``'s weights: the loss, the gradients (full shapes) and
    the launches."""
    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.parallel.mesh import device_feed
    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner, strong_output_transform)

    runner = StrongRunner(device=device)
    cfg = {**_strong_config(str(work / "md_bf16"), **MD_BF16_ARGS),
           "data": _train_data(work)}
    if mesh is not None:
        cfg["parallel"] = {"mesh": mesh}
    config = runner.setup(cfg)
    train_loader, _ = _loaders(tok, config["seed"])
    model = runner.build_model()
    model.load_state_dict(random_state_dict(model, seed=1))
    opt = Optimizer(config["optimizer"], model.parameters(), None)
    batch, _, _ = next(device_feed([next(iter(train_loader))], runner.mesh,
                                   runner.device))
    batch["waveform"] = batch["waveform"] * wave_scale
    _reset_counts()
    loss = runner.train_step(model, runner.build_loss(), opt, batch,
                             strong_output_transform)
    torch.cuda.synchronize()
    return {"loss": float(loss), "launches": _counts(),
            "grads": {n: p.grad.double().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None}}


def _md_split_check(axis) -> dict:
    """Row 12 on a dp2 rank's rows at blocks 1 and 2 (f32, their pools):
    the statistics (``bn_pool_sums`` summed over the ranks) and the split
    backward (pass 1, the ranks' s1 / s2 summed, pass 2) against the plain
    versions, given the same global sums."""
    import torch
    import torch.distributed as dist

    from texttoaudiogrounding_tpu_torch.ops.kernels import bn_pool

    out = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31 + axis.index)
    for label, t, m, c, pool in POOL_GEOMETRIES[:2]:
        dev = torch.device("cuda", torch.cuda.current_device())
        x = torch.randn(MD_SPLIT_CLIPS, t, m, c, device=dev, generator=gen)
        g = torch.randn(MD_SPLIT_CLIPS, t // pool[0], m // 2, c, device=dev,
                        generator=gen)
        gamma = torch.rand(c, device=dev, generator=gen) + 0.5
        beta = torch.randn(c, device=dev, generator=gen) * 0.1
        mean, var = bn_pool.global_batch_stats(x, axis)
        plain = torch.stack(bn_pool.batch_sums_plain(x))
        dist.all_reduce(plain, group=axis.group)
        n = plain.new_full((), float(MD_SPLIT_CLIPS * t * m * axis.size))
        pmean = plain[0] / n
        pvar = torch.clamp_min(plain[1] / n - pmean * pmean, 0.0)
        stats = _stats_err((mean, var), (pmean, pvar))
        inv = torch.rsqrt(var + 1e-5)
        s1, s2 = bn_pool.bn_pool_bwd_sums(x, g, mean, inv, gamma, beta, pool)
        ps1, ps2 = bn_pool.bn_pool_bwd_sums_plain(x, g, mean, inv, gamma,
                                                  beta, pool)
        tot = torch.stack([s1, s2])
        dist.all_reduce(tot, group=axis.group)
        count = MD_SPLIT_CLIPS * t * m * axis.size
        dx = bn_pool.bn_pool_bwd_apply(x, g, mean, inv, gamma, beta, pool,
                                       tot[0], tot[1], count)
        pdx = bn_pool.bn_pool_bwd_apply_plain(x, g, mean, inv, gamma, beta,
                                              pool, tot[0], tot[1], count)
        errs = {"dx": _err(dx, pdx), "s1": _err(s1, ps1),
                "s2": _err(s2, ps2)}
        out[label] = {"stats_max_abs": stats[0], "stats_share": stats[1],
                      **{k: {"max_abs": e[0], "rel_rms": e[1]}
                         for k, e in errs.items()}}
        if stats[1] > 1.0 or max(e[1] for e in errs.values()) > 1e-4:
            raise AssertionError(f"row 12 under dp2 ({label}): off its plain "
                                 f"version: {out[label]}")
    return out


def _md_worker(rank: int, world: int, port: int, part: str, work: str,
               out: str) -> None:
    """A rank of the ``multi_device`` phase, started by
    ``torch.multiprocessing``: a gloo group on ``cuda:0``, then ``part``;
    its result to ``out/<part>.<rank>.pt``."""
    import datetime

    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        tok = _md_tokenizer()
        work = Path(work)
        if part == "dp2":
            fit = _md_fit(tok, work, "md_dp2", {"data": 2}, device="cuda:0")
            result = {"fit": _md_public(fit),
                      "running": {n: b.detach().cpu() for n, b in
                                  fit["model"].named_buffers()
                                  if "running" in n}}
            del fit
            torch.cuda.empty_cache()
            result["bf16"] = _md_bf16_step(tok, work, {"data": 2}, "cuda:0")
            from texttoaudiogrounding_tpu_torch.parallel.mesh import (
                mesh_from_config)
            result["split"] = _md_split_check(
                mesh_from_config({"mesh": {"data": 2}}, "cuda:0").axis("data"))
            result["split_launches"] = _counts()
        elif part == "runners":
            result = _md_runner_ranks(work)
        elif part == "fault":
            _md_plant_local_bn0()
            result = {"fit": _md_public(_md_fit(tok, work, "md_fault",
                                                {"data": 2},
                                                device="cuda:0")),
                      "bf16": _md_bf16_step(tok, work, {"data": 2},
                                            "cuda:0")}
        else:
            fit = _md_fit(tok, work, "md_dp2tp2", {"data": 2, "model": 2},
                          MD_RULES, device="cuda:0")
            last = str(Path(fit["exp_dir"]) / "last.pth")
            result = {"fit": _md_public(fit)}
            del fit
            torch.cuda.empty_cache()
            result["resumed"] = _md_public(_md_fit(
                tok, work, "md_dp4tp1", {"data": 4, "model": 1}, MD_RULES,
                resume=last, epochs=TRAIN_EPOCHS + 1, device="cuda:0"))
        torch.cuda.synchronize()
        torch.save(result, Path(out) / f"{part}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def _md_plant_local_bn0() -> None:
    """The planted fault: bn0 normalizes by its rank's rows alone (local
    statistics, as a data-parallel step that forgot one all-reduce)."""
    from texttoaudiogrounding_tpu_torch.models import audio_encoder, layers
    from texttoaudiogrounding_tpu_torch.parallel import kernel_shard

    def local_bn(x, bn):
        with kernel_shard.data_parallel(None):
            return layers.batch_norm_train(x, bn)
    audio_encoder.batch_norm_train = local_bn


def _md_tokenizer():
    from texttoaudiogrounding_tpu_torch.data.tokenizer import DictTokenizer
    from texttoaudiogrounding_tpu_torch.data.vocabulary import Vocabulary

    vocab = Vocabulary()
    for word in ["<pad>", "<unk>"] + [f"w{i}" for i in range(2, 5000)]:
        vocab.add_word(word)
    return DictTokenizer(vocab)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _md_spawn(part: str, world: int, work: Path) -> list:
    """Every rank's result of ``part``, its ranks started here."""
    import torch
    import torch.multiprocessing as mp

    out = work / f"md_{part}_out"
    out.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    mp.spawn(_md_worker, args=(world, _free_port(), part, str(work),
                               str(out)), nprocs=world, join=True)
    results = [torch.load(out / f"{part}.{r}.pt", weights_only=False)
               for r in range(world)]
    results[0]["spawn_s"] = time.perf_counter() - t0
    return results


def _md_loss_first_epoch(label: str, got: list, ref: list) -> None:
    if _md_loss_gap(got[:TRAIN_STEPS], ref[:TRAIN_STEPS]) > MD_LOSS_RTOL:
        raise AssertionError(f"{label}: the first epoch's step losses "
                             f"{got[:TRAIN_STEPS]} off the one-rank fit's "
                             f"{ref[:TRAIN_STEPS]} by more than "
                             f"{MD_LOSS_RTOL}")


def _md_loss_gap(got: list, ref: list) -> float:
    import numpy as np
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref))
                        / np.abs(np.asarray(ref))))


def _md_losses_close(label: str, got: list, ref: list, rtol: float) -> float:
    """The largest relative gap of ``got``'s step losses to ``ref``'s,
    held to ``rtol``, and the first epoch's to ``MD_LOSS_RTOL``."""
    _md_loss_first_epoch(label, got, ref)
    worst = _md_loss_gap(got, ref)
    if len(got) != len(ref) or worst > rtol:
        raise AssertionError(f"{label}: step losses {got} off the one-rank "
                             f"fit {ref} by {worst} > {rtol}")
    return worst


def _md_grads_close(label: str, grads: dict, ref: dict,
                    limits: tuple) -> tuple:
    gaps = _gaps(grads, ref)
    trunk, rest = _worst(gaps)
    if trunk > limits[0] or rest > limits[1]:
        after = {k: v for k, v in gaps.items()
                 if not ("conv_block" in k or "bn0" in k)}
        raise AssertionError(
            f"{label}: first-step gradients off the one-rank step: trunk "
            f"{trunk}, rest {rest} (limits {limits}): "
            f"{sorted(gaps.items(), key=lambda kv: -kv[1])[:4]}, after the "
            f"trunk {sorted(after.items(), key=lambda kv: -kv[1])[:4]}")
    return trunk, rest


def _md_bf16_close(label: str, step: dict, ref16: dict,
                   limits16: tuple) -> dict:
    """Route (b)'s step against the one-rank step: the loss within
    ``MD_LOSS_RTOL``, the gradients within ``limits16``."""
    gap = abs(step["loss"] - ref16["loss"]) / abs(ref16["loss"])
    if gap > MD_LOSS_RTOL:
        raise AssertionError(f"{label}: loss {step['loss']} off the one-rank "
                             f"step's {ref16['loss']} by {gap}")
    trunk, rest = _md_grads_close(label, step["grads"], ref16["grads"],
                                  limits16)
    return {"loss_rel_gap": gap, "grad_rel_rms": [trunk, rest]}


def _md_fault(work: Path, ref_loss: list, ref_first: dict, ref16: dict,
              limits16: tuple) -> dict:
    """Two ranks with bn0 on its rank's rows alone
    (:func:`_md_plant_local_bn0`): its gaps to the one-rank fit and step,
    and which of (b)'s and (d)'s limits reject it.  Raises unless the
    first epoch's loss limit, the whole fit's and the limit on the
    gradients after the trunk each reject it, and (d)'s checks do."""
    fault = _md_spawn("fault", 2, work)[0]
    fit = fault["fit"]
    losses = fit["record"]["step_loss"]
    first = dict(fit["first"])
    first.pop("running")
    trunk, rest = _worst(_gaps(first, ref_first))
    step = fault["bf16"]
    d_loss = abs(step["loss"] - ref16["loss"]) / abs(ref16["loss"])
    d_trunk, d_rest = _worst(_gaps(step["grads"], ref16["grads"]))
    gaps = {"first_epoch_loss_rel": _md_loss_gap(losses[:TRAIN_STEPS],
                                                 ref_loss[:TRAIN_STEPS]),
            "loss_rel": _md_loss_gap(losses, ref_loss),
            "grad_rel_rms": [trunk, rest], "d_loss_rel": d_loss,
            "d_grad_rel_rms": [d_trunk, d_rest]}
    rejected = {"first_epoch_loss": gaps["first_epoch_loss_rel"]
                > MD_LOSS_RTOL,
                "loss": gaps["loss_rel"] > MD_FIT_LOSS_RTOL,
                "grads_trunk": trunk > MD_GRAD_LIMITS[0],
                "grads_after_trunk": rest > MD_GRAD_LIMITS[1],
                "d_loss": d_loss > MD_LOSS_RTOL,
                "d_grads": d_trunk > limits16[0] or d_rest > limits16[1]}
    required = ("first_epoch_loss", "loss", "grads_after_trunk")
    if not all(rejected[k] for k in required) or not (
            rejected["d_loss"] or rejected["d_grads"]):
        raise AssertionError(f"(fault): bn0 with local statistics passes "
                             f"limits: {gaps}, rejected {rejected}")
    return {"planted": "bn0 normalized by its rank's rows alone",
            "step_loss": losses, **gaps, "rejected_by": rejected}


def _md_predictor(tok) -> dict:
    """(e): ``GroundingPredictor(devices=["cuda:0", "cuda:0"])`` over the
    flagship serving model against the single-device predictor: each
    shard's ``frame_sim`` bit for bit the single predictor's on that
    shard's padded rows, the whole request within 0.05 of the unsharded
    one, and rows 1-4 launched their counts a shard forward."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import (
        GroundingPredictor, flagship_model, random_state_dict)
    from texttoaudiogrounding_tpu_torch.inference import pad_batch

    model = flagship_model(serving=True, device=DEVICE)
    model.load_state_dict(random_state_dict(model, seed=0))
    single = GroundingPredictor(model, tok)
    sharded = GroundingPredictor(model, tok, devices=["cuda:0", "cuda:0"])
    rng = np.random.default_rng(23)
    n = SR * CLIP_S
    report = {}
    for label, lens in (("32 clips, 10 s", [n] * 32),
                        ("3 clips, 10/7.8/5 s", [n, 250000, 160000])):
        audio, text = _request(rng, lens)
        plan = sharded._chunk_plan(len(lens))
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs, lengths = sharded.predict(audio, lens, text,
                                         return_length=True)
        torch.cuda.synchronize()
        request_ms = (time.perf_counter() - t0) * 1e3
        launches = _counts()
        shards = 2 * len(plan)
        for k, per in SERVING_PER_FORWARD.items():
            if launches[k] != shards * per:
                raise AssertionError(f"(e) {label}: {k} launched "
                                     f"{launches[k]}, expected "
                                     f"{shards * per}")
        ref, ref_len = single.predict(audio, lens, text, return_length=True)
        gap = float(np.max(np.abs(probs - ref)))
        if not np.array_equal(lengths, ref_len) or gap >= 0.05:
            raise AssertionError(f"(e) {label}: off the single predictor by "
                                 f"{gap} (lengths {lengths}, {ref_len})")
        # each shard against the single predictor on its padded rows
        batch = _md_predict_batch(sharded, audio, lens, text)
        bitwise = True
        for start, size, target in plan:
            chunk = pad_batch({k: v[start:start + size]
                               for k, v in batch.items()}, target)
            got = sharded._run(chunk)["frame_sim"]
            half = target // 2
            for i in range(2):
                part = {k: v[i * half:(i + 1) * half]
                        for k, v in chunk.items()}
                want = single._forward(part)["frame_sim"].cpu()
                bitwise &= torch.equal(got[i * half:(i + 1) * half], want)
        if not bitwise:
            raise AssertionError(f"(e) {label}: a shard's frame_sim differs "
                                 "from the single predictor's on its rows")
        report[label] = {"request_ms": request_ms, "sub_batches": len(plan),
                         "shard_forwards": shards, "max_abs_vs_single": gap,
                         "shards_bit_for_bit": bitwise,
                         "launches": _nonzero(launches)}
    report["launches"] = {k: sum(r["launches"].get(k, 0)
                                 for r in report.values())
                          for k in _counts()}
    return report


def _md_predict_batch(pred, audio, lens, text) -> dict:
    """``predict``'s padded numpy batch of a request (its first lines)."""
    import numpy as np

    from texttoaudiogrounding_tpu_torch.inference import round_up

    audio = np.asarray(audio, np.float32)
    pad_n = round_up(audio.shape[1], pred.audio_bucket)
    audio = np.pad(audio, ((0, 0), (0, pad_n - audio.shape[1])))
    tokens = pred.tokenizer(list(text))
    ids = tokens["text"]
    pad_l = round_up(ids.shape[1], pred.text_bucket)
    return {"waveform": audio,
            "waveform_len": np.asarray(lens, np.int64),
            "text": np.pad(ids, ((0, 0), (0, pad_l - ids.shape[1]))).astype(
                np.int64),
            "text_len": np.asarray(tokens["text_len"], np.int64)}


def _md_split_row(dp2: list) -> dict:
    """The kernels line's row of row 12's split backward: timed at a dp2
    rank's rows of the bf16 blocks 1-2 (route (b)'s ``bn_pool: [64,
    128]``), one rank's sums passed as the global ones; its launches and
    its check against the plain version come from the ranks."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import bn_pool

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    ms = plain_ms = bound = two_pass_ms = 0.0
    for _, t, m, c, pool in POOL_GEOMETRIES[:2]:
        pt = pool[0]
        x = torch.randn(MD_SPLIT_CLIPS, t, m, c, device=dev,
                        generator=gen).bfloat16()
        g = torch.randn(MD_SPLIT_CLIPS, t // pt, m // 2, c, device=dev,
                        generator=gen).bfloat16()
        gamma = torch.rand(c, device=dev, generator=gen) + 0.5
        beta = torch.randn(c, device=dev, generator=gen) * 0.1
        mean, var = bn_pool.batch_stats(x)
        inv = torch.rsqrt(var + 1e-5)
        count = MD_SPLIT_CLIPS * t * m * 2

        def kern():
            s1, s2 = bn_pool.bn_pool_bwd_sums(x, g, mean, inv, gamma, beta,
                                              pool)
            return bn_pool.bn_pool_bwd_apply(x, g, mean, inv, gamma, beta,
                                             pool, s1, s2, count)

        def plain():
            s1, s2 = bn_pool.bn_pool_bwd_sums_plain(x, g, mean, inv, gamma,
                                                    beta, pool)
            return bn_pool.bn_pool_bwd_apply_plain(x, g, mean, inv, gamma,
                                                   beta, pool, s1, s2, count)

        ms += _cuda_ms(kern, 10)
        plain_ms += _cuda_ms(plain, 3)
        two_pass_ms += _cuda_ms(lambda: bn_pool.bn_pool_bwd(
            x, g, mean, inv, gamma, beta, pool), 10)
        nx, es = x.numel(), x.element_size()
        bound += _bound(nx * es * (2 + 0.5 / pt) + 40 * c, {})[0]
        del x, g
    worst = max(max(e[k]["rel_rms"] for k in ("dx", "s1", "s2"))
                for r in dp2 for e in r["split"].values())
    worst_abs = max(max(e[k]["max_abs"] for k in ("dx", "s1", "s2"))
                    for r in dp2 for e in r["split"].values())
    return {"name": "bn_pool_bwd_split", "route": "cuda",
            "source": "texttoaudiogrounding_tpu_torch/csrc/bn_pool_v2.cu",
            "replaces": _BN, "counter": "bn_pool_bwd_sums",
            "path": "multi_device_dp2_bf16",
            "max_abs_err": worst_abs, "rel_rms_err": worst,
            "tolerance": "rel_rms <= 1e-4 (f32, given the same global sums)",
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "two_pass_ms": two_pass_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "times": "sum over the bf16 blocks 1-2 of a dp2 rank's 16 clips "
                     "(ttg_bn_pool_bwd_v2_sums + ttg_bn_pool_bwd_v2_apply, "
                     "the sums' all_reduce between them not included)",
            "clips": MD_SPLIT_CLIPS}


# (f): the sentence-level, self-supervision and class-mapping runners on
# two gloo ranks, each against one rank's fit on the same global batches
MD_RUNNER_KINDS = ("sentence_phrase", "sentence_word", "selfsup",
                   "mapping_weak", "mapping_strong", "mapping_weak_b6")
# mapping_weak_b6: the weak class-mapping fit at a global batch of
# MD_B6_CLIPS, three clips a rank on two ranks, so that the mixup pair
# (2, 3) spans the ranks (rank 0 then holds two mixed rows, rank 1 one)
MD_B6_CLIPS = 6
MD_RUNNER_STEPS = 2                 # train steps of each run (1 epoch)
# (f)'s gradient limits (trunk, after it).  On an H100 the one-rank fits'
# own change under the input scaling MD_WAVE_SCALES[0] reaches 1.60e-2 in
# the trunk (self-supervision) and 4.80e-3 after it (the sentence models:
# their ranking loss over a [B, B] matrix is ill-conditioned), and two
# ranks lie 1.40e-2 / 4.56e-3 from one (PERF.md §6): about twice
# those.  The planted faults miss them by 100x or more (the text gather)
# and the loss limits by 4.5-11x (the ungathered mixup); the loss limits
# are (b)'s.
MD_RUNNER_GRAD_LIMITS = (3e-2, 1e-2)
MD_RUNNER_CUTS = (
    "each config as its phase builds it (SENTENCE_CUTS, SELFSUP_CUTS, "
    "CLASS_MAPPING_CUTS), then trainer.epochs 1 of epoch_length "
    "MD_RUNNER_STEPS (2) with the phase's validation batches, the train "
    "loader without worker processes, parallel.mesh {data: 2} on the "
    "ranks; the teacher is phase 7's v2 best.pth",)
# the device of the ranks' processes (all on the one card)
MD_RANK_DEVICE = "cuda:0"


def _md_runner_case(kind: str, work: Path, exp: str) -> tuple:
    """(runner class, config, items in memory or None) of ``kind`` (one of
    ``MD_RUNNER_KINDS``), cut as ``MD_RUNNER_CUTS`` lists; the
    experiment's directory is ``work / exp``."""
    from texttoaudiogrounding_tpu_torch.training.runner_class_mapping import (
        ClassMappingStrongRunner, ClassMappingWeakRunner)
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        WeakPhraseSelfSupervisionRunner)
    from texttoaudiogrounding_tpu_torch.training.runner_weak_sentence import (
        WeakSentenceRunner)

    items = None
    if kind.startswith("sentence"):
        words = kind == "sentence_word"
        cls = WeakSentenceRunner
        config = _sentence_config(
            str(work / exp), "AudioTextAlignBy" + ("Word" if words
                                                   else "Phrase"),
            _sentence_data(work, words=words), 1)
    elif kind == "selfsup":
        cls = WeakPhraseSelfSupervisionRunner
        config = _selfsup_config(work, work / "md_teacher.pth", write=False)
        config["experiment_path"] = str(work / exp)
    else:
        strong = kind == "mapping_strong"
        cls = ClassMappingStrongRunner if strong else ClassMappingWeakRunner
        label = "strong" if strong else "weak"
        config = _class_mapping_config(label, str(work / exp))
        clips, seed = ((MD_B6_CLIPS, 35) if kind == "mapping_weak_b6"
                       else (TRAIN_CLIPS, 33 if strong else 31))
        items = {"train": _cm_items(label, clips * MD_RUNNER_STEPS, seed),
                 "val": _cm_items(label, clips * CM_VAL_BATCHES, seed + 1)}
        for split in ("train", "val"):
            config["data"][split]["dataloader_args"]["batch_size"] = clips
    config["trainer"].update(epochs=1, epoch_length=MD_RUNNER_STEPS)
    config["data"]["train"]["dataloader_args"]["num_workers"] = 0
    return cls, config, items


def _md_runner_fit(kind: str, work: Path, exp: str, mesh: dict | None,
                   device: str | None = None,
                   wave_scale: float = 1.0) -> dict:
    """``runner.train`` of ``kind`` (``_md_runner_case``) on ``mesh``
    (None: one process), the counts set to 0 just before: the step and
    validation losses, the first step's gradients and running statistics,
    the running statistics after the fit, the launches, the BiGRU's
    (train mode, rows) calls, the teacher's weights as a sum, the step ms
    by CUDA events (3 steps on the rank's rows of a validation batch, after
    the fit) and the experiment directory.  ``wave_scale`` scales every
    waveform the audio encoder reads."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.parallel.mesh import device_feed
    from texttoaudiogrounding_tpu_torch.training.runner_base import (
        whole_batch_inputs)
    from texttoaudiogrounding_tpu_torch.training.runner_class_mapping import (
        _mixup_lambdas, mapping_strong_output_transform,
        mixup_output_transform)
    from texttoaudiogrounding_tpu_torch.training.runner_weak_phrase import (
        weak_output_transform)

    cls, config, items = _md_runner_case(kind, work, exp)
    if mesh is not None:
        config["parallel"] = {"mesh": mesh}
    runner = cls(device=device or DEVICE)
    if items is not None:
        _memory_loaders(runner, items)
    first: dict = {}
    hook = runner.post_grad_hook

    def capture(loss, grads):
        hook(loss, grads)
        if first:
            return
        for n, p in runner.model.named_parameters():
            if p.grad is not None:
                first[n] = p.grad.detach().float().cpu()
        first["running"] = {n: b.detach().float().cpu() for n, b in
                            runner.model.named_buffers() if "running" in n}

    record: dict = {}
    fit = runner.fit

    def recorded_fit(*args, **kwargs):
        record.update(fit(*args, **kwargs))
        return record

    def scaled_fit(model, *args, **kwargs):
        model.audio_encoder.register_forward_pre_hook(
            lambda mod, args: ({**args[0], "waveform":
                                args[0]["waveform"] * wave_scale},))
        return recorded_fit(model, *args, **kwargs)

    runner.post_grad_hook = capture
    runner.fit = recorded_fit if wave_scale == 1.0 else scaled_fit
    with _GruBatches() as grus:
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp_dir = runner.train(config)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _counts()
    model = runner.model
    running = {n: b.detach().cpu().clone() for n, b in model.named_buffers()
               if "running" in n}
    teacher = getattr(runner, "teacher", None)
    teacher_sum = None if teacher is None else float(sum(
        v.double().sum() for v in teacher.state_dict().values()))
    transform = {"selfsup": runner.teacher_transform(teacher)
                 if teacher is not None else None,
                 "mapping_weak": mixup_output_transform,
                 "mapping_weak_b6": mixup_output_transform,
                 "mapping_strong": mapping_strong_output_transform}.get(
                     kind, weak_output_transform)
    host = next(iter(runner.build_dataloader(config["data"]["val"],
                                             shuffle=False)))
    if kind.startswith("mapping_weak"):
        host = {**host, "mixup_lambda": _mixup_lambdas(
            np.random.RandomState(7), len(host["waveform"]))}
    batch, _, _ = next(device_feed([host], runner.mesh, runner.device,
                                   whole=whole_batch_inputs(model)))
    step_ms = _cuda_ms(lambda: runner.train_step(
        model, runner.build_loss(), runner.optimizer, batch, transform), 3)
    out = {"step_loss": record["step_loss"], "val_loss": record["val_loss"],
           "first": first, "running": running, "launches": launches,
           "gru_calls": sorted(set(grus.calls)), "teacher_sum": teacher_sum,
           "fit_s": fit_s, "step_ms": step_ms, "exp_dir": str(exp_dir),
           "mesh": runner.mesh.shape}
    del runner, model, teacher, batch
    torch.cuda.empty_cache()
    return out


def _md_runner_want(kind: str) -> dict:
    """The launches of ``_md_runner_fit`` on any mesh: row 13 once each
    way a train step (the self-supervision teacher's forward beside the
    student's) and once a validation batch."""
    vals = CM_VAL_BATCHES if kind.startswith("mapping") else \
        SENTENCE_VAL_BATCHES
    forwards = 2 if kind == "selfsup" else 1
    return _want(gru_fwd=forwards * (MD_RUNNER_STEPS + vals),
                 gru_bwd=MD_RUNNER_STEPS)


def _md_gru_rows(kind: str, rank: int | None = None) -> list:
    """The (train mode, rows) calls of the BiGRU in ``kind``'s fit: on one
    rank (``rank`` None) or on ``rank`` of two.  The weak class-mapping
    fits mix rows 2k and 2k + 1 of the global batch before the conv
    blocks, each rank the pairs whose even row it holds."""
    clips = MD_B6_CLIPS if kind == "mapping_weak_b6" else TRAIN_CLIPS
    ranks, r = (1, 0) if rank is None else (2, rank)
    rows = clips // ranks
    train = rows
    if kind.startswith("mapping_weak"):
        first, end = r * rows, (r + 1) * rows
        train = len([k for k in range(clips // 2) if first <= 2 * k < end])
    return sorted({(True, train), (False, rows)})


def _md_no_rows() -> dict:
    """The wrappers a rank holding no mixed row calls (rows 11-13 and row
    12's sums, with the mixed rows' shapes at B = 0 on the card): each
    returns its empty output, zero sums and zero weight gradients, and
    launches nothing."""
    import torch

    from texttoaudiogrounding_tpu_torch.ops.kernels import (
        bn_pool, dual_pool, gru)

    dev = torch.device(DEVICE)
    out = {}
    _reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        proj = torch.zeros(250, 0, 768, device=dev, requires_grad=True)
        wh = torch.randn(2, 256, 768, device=dev, requires_grad=True)
        bn = torch.randn(2, 256, device=dev, requires_grad=True)
        ys = gru.bigru_trainable(proj, wh, bn, dtype)
        ys.sum().backward()
        out[f"gru_{dtype}"] = {
            "ys": list(ys.shape), "grads_zero": all(
                not bool(t.grad.any()) for t in (proj, wh, bn))}
        if tuple(ys.shape) != (250, 0, 256) or not out[f"gru_{dtype}"][
                "grads_zero"]:
            raise AssertionError(f"(f) no rows: BiGRU {out}")
    x = torch.zeros(0, 1001, 64, 64, dtype=torch.bfloat16, device=dev)
    g = torch.zeros(0, 500, 32, 64, dtype=torch.bfloat16, device=dev)
    c = torch.ones(64, device=dev)
    sums = bn_pool.batch_sums(x) + bn_pool.bn_pool_bwd_sums(
        x, g, c, c, c, c, (2, 2))
    shapes = [bn_pool.bn_pool_fwd(x, c, c, (2, 2)).shape,
              bn_pool.bn_pool_bwd_apply(x, g, c, c, c, c, (2, 2), c, c,
                                        1).shape,
              dual_pool.dual_pool_fwd(x, (2, 2)).shape,
              dual_pool.dual_pool_bwd(x, g, (2, 2)).shape]
    torch.cuda.synchronize()
    out["pools"] = [list(s_) for s_ in shapes]
    out["launches"] = _nonzero(_counts())
    if (any(bool(t.any()) for t in sums) or out["launches"]
            or out["pools"] != [[0, 500, 32, 64], [0, 1001, 64, 64]] * 2):
        raise AssertionError(f"(f) no rows: {out}, sums {sums}")
    return out


def _md_runner_evals(work: Path, sentence_exp: str, tagging_exp: str,
                     tag: str, device: str | None = None) -> dict:
    """``WeakSentenceRunner.evaluate`` of ``sentence_exp`` (a word-wise run)
    with ``word_wise/eval.yaml``'s keys on the evaluate phase's set, and
    ``ClassMappingWeakRunner.evaluate_tagging`` of ``tagging_exp`` on its
    validation items: on several ranks each rank forwards its rows of each
    batch; rank 0's tracks, metrics, tagging probabilities and APs (other
    ranks': None), and the launches; ``tag`` names the files written."""
    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch.training.runner_class_mapping import (
        ClassMappingWeakRunner)
    from texttoaudiogrounding_tpu_torch.training.runner_weak_sentence import (
        WeakSentenceRunner)

    device = device or DEVICE
    waves, label = _eval_data(work)
    out: dict = {}
    evaluator = WeakSentenceRunner(device=device)
    _reset_counts()
    metrics = evaluator.evaluate(sentence_exp, _eval_config(
        work, waves, label, time_resolution=0.04, word_aggregation="mean",
        output=f"result_{tag}.txt"))
    torch.cuda.synchronize()
    out["sentence"] = {"launches": _counts(), "metrics": metrics,
                       "tracks": _tracks(evaluator) if evaluator.is_main
                       else None}
    tagger = ClassMappingWeakRunner(device=device)
    _memory_loaders(tagger, {"val": _cm_items(
        "weak", TRAIN_CLIPS * CM_VAL_BATCHES, 32)})
    probs = []
    forward = tagger.eval_forward

    def recorded(batch, model):
        output = forward(batch, model)
        probs.append(output["clip_sim"].float().cpu().numpy())
        return output

    tagger.eval_forward = recorded
    _reset_counts()
    result = tagger.evaluate_tagging(tagging_exp,
                                     {"output": f"tagging_{tag}.tsv"})
    torch.cuda.synchronize()
    out["tagging"] = {"launches": _counts(), "ap": result["ap"],
                      "probs": np.concatenate(probs)}
    return out


def _md_plant_own_rows_text(axis) -> None:
    """The planted fault of the sentence model: each rank runs the text
    tower on its own captions and gathers the token embeddings with
    ``gather_rows``, whose backward keeps the rank's own rows (right only
    where every rank computes the same function of what it gathered; here
    each rank computes its own block of the matrix)."""
    from texttoaudiogrounding_tpu_torch.models import align_models
    from texttoaudiogrounding_tpu_torch.parallel import kernel_shard

    def forward(self, input_dict: dict) -> dict:
        audio_out = self.audio_encoder(input_dict)
        audio_emb = audio_out["embedding"]
        word_emb = self.text_encoder(input_dict)["token_emb"]
        if self.needs_proj:
            audio_emb = self.audio_proj(audio_emb)
            word_emb = self.text_proj(word_emb)
        return self._pooled(
            input_dict, self.match_fn(audio_emb,
                                      kernel_shard.gather_rows(word_emb,
                                                               axis)),
            audio_out["length"],
            kernel_shard.gather_rows(input_dict["text_len"], axis))

    align_models.AudioTextAlignByWord.forward = forward
    align_models.AudioTextAlignByWord.whole_batch_inputs = ()


def _md_plant_ungathered_mixup() -> None:
    """The planted fault of the weak class-mapping step: the mixed outputs
    and labels (half the rank's rows) left ungathered, so that each rank
    scores its own half (the base runner's ``output_rows``)."""
    from texttoaudiogrounding_tpu_torch.training.runner_base import (
        BaseRunner)
    from texttoaudiogrounding_tpu_torch.training.runner_class_mapping import (
        ClassMappingWeakRunner)

    ClassMappingWeakRunner.output_rows = BaseRunner.output_rows


def _md_runner_ranks(work: Path) -> dict:
    """A rank of part (f): the five fits on ``data: 2``, the rank-sharded
    evaluations of the one-rank runs' directories, then the two planted
    faults' fits."""
    from texttoaudiogrounding_tpu_torch.parallel.mesh import (
        mesh_from_config)

    mesh = {"data": 2}
    out = {kind: _md_runner_fit(kind, work, f"md_{kind}_dp2", mesh,
                                MD_RANK_DEVICE)
           for kind in MD_RUNNER_KINDS}
    out["evals"] = _md_runner_evals(work, str(work / "md_sentence_word"),
                                    str(work / "md_mapping_weak"), "dp2",
                                    MD_RANK_DEVICE)
    _md_plant_own_rows_text(mesh_from_config({"mesh": mesh},
                                             MD_RANK_DEVICE).axis("data"))
    out["fault_text"] = _md_runner_fit("sentence_word", work,
                                       "md_fault_text", mesh, MD_RANK_DEVICE)
    _md_plant_ungathered_mixup()
    out["fault_mixup"] = _md_runner_fit("mapping_weak", work,
                                        "md_fault_mixup", mesh,
                                        MD_RANK_DEVICE)
    return out


def _md_runners_part(work: Path, teacher: Path) -> tuple:
    """(f): each runner of ``MD_RUNNER_KINDS`` fitted in this process (one
    rank) and on two gloo ranks (``data: 2``): the ranks' step losses
    within ``MD_LOSS_RTOL`` (the first) and ``MD_FIT_LOSS_RTOL`` of one
    rank's, the first step's gradients within ``MD_RUNNER_GRAD_LIMITS``
    (each one-rank fit's own change under the input scaling
    ``MD_WAVE_SCALES[0]`` reported beside them), the running statistics
    bit for bit alike on the ranks, row 13 launched as one rank launches
    it on half the rows (the teacher's weights, the same sum everywhere);
    the word-wise run's evaluation and the weak run's tagging evaluation
    on the ranks against one rank (tracks and probabilities within 1e-4);
    and the two planted faults
    (``_md_plant_own_rows_text``, ``_md_plant_ungathered_mixup``), each
    rejected by the limits.  Returns (report, launches by path)."""
    import shutil

    import numpy as np

    shutil.copyfile(teacher, work / "md_teacher.pth")
    _selfsup_config(work, work / "md_teacher.pth")
    seconds: dict = {}
    t0 = time.perf_counter()
    ref = {kind: _md_runner_fit(kind, work, f"md_{kind}", None)
           for kind in MD_RUNNER_KINDS}
    # each one-rank fit's own change under a rounding-sized input change,
    # reported beside the fixed limits
    moved = {kind: _md_runner_fit(kind, work, f"md_{kind}_moved", None,
                                  wave_scale=MD_WAVE_SCALES[0])
             for kind in MD_RUNNER_KINDS}
    ref_evals = _md_runner_evals(work, ref["sentence_word"]["exp_dir"],
                                 ref["mapping_weak"]["exp_dir"], "one_rank")
    seconds["one_rank"] = time.perf_counter() - t0
    ranks = _md_spawn("runners", 2, work)
    seconds["ranks"] = time.perf_counter() - t0 - seconds["one_rank"]
    report: dict = {"cuts": MD_RUNNER_CUTS, "seconds": seconds,
                    "spawn_s": ranks[0]["spawn_s"], "limits": {
                        "first_loss_rel": MD_LOSS_RTOL,
                        "loss_rel": MD_FIT_LOSS_RTOL,
                        "grad_rel_rms": list(MD_RUNNER_GRAD_LIMITS),
                        "wave_scale": MD_WAVE_SCALES[0]}}
    by_path = {}
    for kind in MD_RUNNER_KINDS:
        one = ref[kind]
        want = _md_runner_want(kind)
        if one["launches"] != want or one["gru_calls"] != _md_gru_rows(
                kind):
            raise AssertionError(f"(f) {kind} one rank: launches "
                                 f"{_nonzero(one['launches'])}, BiGRU calls "
                                 f"{one['gru_calls']}")
        ref_first = {k: v for k, v in one["first"].items()
                     if k != "running"}
        entry = {"one_rank_step_loss": one["step_loss"],
                 "one_rank_step_ms": one["step_ms"],
                 "one_rank_fit_s": one["fit_s"], "ranks": [],
                 "self_loss_rel": _md_loss_gap(moved[kind]["step_loss"],
                                               one["step_loss"]),
                 "self_grad_rel_rms": list(_worst(_gaps(
                     {k: v for k, v in moved[kind]["first"].items()
                      if k != "running"}, ref_first)))}
        for r, res in enumerate(ranks):
            got = res[kind]
            label = f"(f) {kind} rank {r}"
            gap = _md_losses_close(label, got["step_loss"], one["step_loss"],
                                   MD_FIT_LOSS_RTOL)
            first = {k: v for k, v in got["first"].items() if k != "running"}
            trunk, rest = _md_grads_close(label, first, ref_first,
                                          MD_RUNNER_GRAD_LIMITS)
            if got["launches"] != want or got["gru_calls"] != _md_gru_rows(
                    kind, r) or got["mesh"] != {"data": 2}:
                raise AssertionError(f"{label}: launches "
                                     f"{_nonzero(got['launches'])}, BiGRU "
                                     f"calls {got['gru_calls']}, mesh "
                                     f"{got['mesh']}")
            if got["teacher_sum"] != one["teacher_sum"]:
                raise AssertionError(f"{label}: teacher weights sum "
                                     f"{got['teacher_sum']}, one rank's "
                                     f"{one['teacher_sum']}")
            entry["ranks"].append({"step_loss": got["step_loss"],
                                   "loss_rel_gap": gap,
                                   "grad_rel_rms": [trunk, rest],
                                   "step_ms": got["step_ms"],
                                   "fit_s": got["fit_s"]})
        for name, buf in ranks[0][kind]["running"].items():
            if not (buf == ranks[1][kind]["running"][name]).all():
                raise AssertionError(f"(f) {kind}: {name} differs between "
                                     "the ranks")
        entry["launches"] = _nonzero(ranks[0][kind]["launches"])
        entry["gru_rows"] = ranks[0][kind]["gru_calls"]
        report[kind] = entry
        by_path[f"multi_device_{kind}_one_rank"] = one["launches"]
        by_path[f"multi_device_{kind}_dp2"] = ranks[0][kind]["launches"]

    # the evaluations: rank 0's tracks and probabilities against one rank's
    evals = ranks[0]["evals"]
    track_gap = _track_gap(evals["sentence"]["tracks"],
                           ref_evals["sentence"]["tracks"])
    prob_gap = float(np.max(np.abs(evals["tagging"]["probs"]
                                   - ref_evals["tagging"]["probs"])))
    for res in ranks:
        ev = res["evals"]
        batches = -(-2 * EVAL_CLIPS // EVAL_BATCH)
        if ev["sentence"]["launches"] != _want(gru_fwd=batches) or \
                ev["tagging"]["launches"] != _want(gru_fwd=CM_VAL_BATCHES):
            raise AssertionError(
                f"(f) evaluations on a rank: launches "
                f"{_nonzero(ev['sentence']['launches'])}, "
                f"{_nonzero(ev['tagging']['launches'])}")
    if track_gap > 1e-4 or prob_gap > 1e-4:
        raise AssertionError(f"(f) evaluations on two ranks: tracks "
                             f"{track_gap}, tagging probabilities "
                             f"{prob_gap} off one rank's (limit 1e-4)")
    report["evaluate"] = {
        "sentence_track_max_abs": track_gap,
        "sentence_metric_gaps": {k: abs(v - ref_evals["sentence"]["metrics"][
            k]) for k, v in evals["sentence"]["metrics"].items()},
        "tagging_prob_max_abs": prob_gap,
        "tagging_ap_max_abs": float(np.max(np.abs(
            evals["tagging"]["ap"] - ref_evals["tagging"]["ap"]))),
        "launches": {"sentence": _nonzero(evals["sentence"]["launches"]),
                     "tagging": _nonzero(evals["tagging"]["launches"])}}
    by_path["multi_device_eval_sentence_dp2"] = evals["sentence"]["launches"]
    by_path["multi_device_eval_tagging_dp2"] = evals["tagging"]["launches"]

    # the planted faults: each must fail the limits
    faults = {}
    for name, kind, required in (
            ("fault_text", "sentence_word", ("grads_after_trunk",)),
            ("fault_mixup", "mapping_weak", ("loss",
                                             "grads_after_trunk"))):
        got = ranks[0][name]
        one = ref[kind]
        first = {k: v for k, v in got["first"].items() if k != "running"}
        trunk, rest = _worst(_gaps(first, {
            k: v for k, v in one["first"].items() if k != "running"}))
        gaps = {"first_epoch_loss_rel": _md_loss_gap(
                    got["step_loss"][:1], one["step_loss"][:1]),
                "loss_rel": _md_loss_gap(got["step_loss"],
                                         one["step_loss"]),
                "grad_rel_rms": [trunk, rest]}
        rejected = {"first_epoch_loss": gaps["first_epoch_loss_rel"]
                    > MD_LOSS_RTOL,
                    "loss": gaps["loss_rel"] > MD_FIT_LOSS_RTOL,
                    "grads_trunk": trunk > MD_RUNNER_GRAD_LIMITS[0],
                    "grads_after_trunk": rest > MD_RUNNER_GRAD_LIMITS[1]}
        if not all(rejected[k] for k in required):
            raise AssertionError(f"(f) {name}: the planted fault passes "
                                 f"limits: {gaps}, rejected {rejected}")
        faults[name] = {"step_loss": got["step_loss"], **gaps,
                        "rejected_by": rejected, "required": required}
    report["faults"] = faults
    report["no_rows"] = _md_no_rows()
    return report, by_path


def multi_device_phase(tok, work: Path, teacher: Path) -> tuple:
    """(a)-(f) of the port's ranks on the one card (see the module
    docstring; ``teacher`` is the self-supervision teacher's checkpoint);
    returns (report, launches by path, the split row)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.backends.cudnn.deterministic = True
    report: dict = {"cuts": MULTI_DEVICE_CUTS}
    t0 = time.perf_counter()
    seconds = report["seconds"] = {}
    steps = TRAIN_EPOCHS * TRAIN_STEPS
    fit_want = _want(gru_fwd=steps + TRAIN_EPOCHS * VAL_STEPS, gru_bwd=steps)
    # the plain single-process fit, then (a) on an NCCL group of one
    plain = _md_fit(tok, work, "md_plain", None)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        a = _md_fit(tok, work, "md_a", {"data": 1})
    finally:
        dist.destroy_process_group()
    ref_loss = plain["record"]["step_loss"]
    gap_a = _md_losses_close("(a)", a["record"]["step_loss"], ref_loss, 1e-6)
    # the one-rank fit's own change under rounding-sized input changes,
    # reported beside the fixed limits
    self_loss, self_grads = [], []
    for scale in MD_WAVE_SCALES:
        moved = _md_fit(tok, work, "md_moved", None, wave_scale=scale)
        self_loss.append(_md_loss_gap(moved["record"]["step_loss"],
                                      ref_loss))
        moved["first"].pop("running")
        self_grads.append(list(_worst(_gaps(moved["first"], {
            k: v for k, v in a["first"].items() if k != "running"}))))
        del moved
    report["limits"] = {"first_epoch_loss_rel": MD_LOSS_RTOL,
                        "loss_rel": MD_FIT_LOSS_RTOL,
                        "grad_rel_rms": list(MD_GRAD_LIMITS),
                        "wave_scales": list(MD_WAVE_SCALES),
                        "self_loss_rel": self_loss,
                        "self_grad_rel_rms": self_grads}
    if a["launches"] != fit_want or a["gru_rows"] != [TRAIN_CLIPS]:
        raise AssertionError(f"(a): launches {_nonzero(a['launches'])} "
                             f"(want {_nonzero(fit_want)}), GRU rows "
                             f"{a['gru_rows']}")
    report["a"] = {"step_loss": a["record"]["step_loss"],
                   "plain_step_loss": ref_loss, "loss_rel_gap": gap_a,
                   "step_ms": a["step_ms"], "plain_step_ms":
                   plain["step_ms"], "fit_s": a["fit_s"],
                   "launches": _nonzero(a["launches"])}
    ref_first = a["first"]
    ref_first.pop("running")
    del plain, a
    ref16 = _md_bf16_step(tok, work, None, DEVICE)
    # the bf16 step's own change, as training_bf16_phase holds route (b)
    self16 = _worst(_gaps(_md_bf16_step(tok, work, None, DEVICE,
                                        MD_WAVE_SCALES[0])["grads"],
                          ref16["grads"]))
    limits16 = (max(GRAD_LIMITS_BF16[0], GRAD_SELF_MULT * self16[0]),
                max(GRAD_LIMITS_BF16[1], GRAD_SELF_MULT * self16[1]))
    torch.cuda.empty_cache()
    seconds["a"] = time.perf_counter() - t0

    # (b) and (d): two gloo ranks on the one card
    dp2 = _md_spawn("dp2", 2, work)
    for r, res in enumerate(dp2):
        fit = res["fit"]
        _md_losses_close(f"(b) rank {r}", fit["record"]["step_loss"],
                         ref_loss, MD_FIT_LOSS_RTOL)
        first = dict(fit["first"])
        first.pop("running")
        res["grad_rel_rms"] = _md_grads_close(f"(b) rank {r}", first,
                                              ref_first, MD_GRAD_LIMITS)
        want = _want(gru_fwd=steps + TRAIN_EPOCHS * VAL_STEPS, gru_bwd=steps)
        if fit["launches"] != want or fit["gru_rows"] != [TRAIN_CLIPS // 2]:
            raise AssertionError(f"(b) rank {r}: launches "
                                 f"{_nonzero(fit['launches'])}, GRU rows "
                                 f"{fit['gru_rows']} (want 2B = "
                                 f"{TRAIN_CLIPS})")
        res["bf16"].update(_md_bf16_close(f"(d) rank {r}", res["bf16"],
                                          ref16, limits16))
    for name, buf in dp2[0]["running"].items():
        if not torch.equal(buf, dp2[1]["running"][name]):
            raise AssertionError(f"(b): {name} differs between the ranks")
    from texttoaudiogrounding_tpu_torch import GroundingPredictor
    served = GroundingPredictor.from_experiment(
        dp2[0]["fit"]["exp_dir"], device=DEVICE)
    audio, text = _request(np.random.default_rng(5), [SR * CLIP_S] * 2)
    probs = served.predict(audio, [SR * CLIP_S] * 2, text)
    if not np.isfinite(probs).all():
        raise AssertionError("(b): rank 0's checkpoint serves non-finite "
                             "frame_sim")
    fit0 = dp2[0]["fit"]
    report["b"] = {"step_loss": fit0["record"]["step_loss"],
                   "loss_rel_gap": max(_md_loss_gap(
                       r["fit"]["record"]["step_loss"], ref_loss)
                       for r in dp2),
                   "grad_rel_rms": [r["grad_rel_rms"] for r in dp2],
                   "step_ms": fit0["step_ms"], "fit_s": fit0["fit_s"],
                   "spawn_s": dp2[0]["spawn_s"],
                   "launches": _nonzero(fit0["launches"]),
                   "gru_rows": fit0["gru_rows"]}
    report["d"] = {"loss": dp2[0]["bf16"]["loss"], "one_rank_loss":
                   ref16["loss"], "loss_rel_gap": dp2[0]["bf16"][
                       "loss_rel_gap"], "loss_limit": MD_LOSS_RTOL,
                   "grad_rel_rms": dp2[0]["bf16"]["grad_rel_rms"],
                   "grad_limits": limits16,
                   "self_grad_rel_rms": list(self16),
                   "row12": dp2[0]["split"],
                   "launches": _nonzero(dp2[0]["bf16"]["launches"])}
    split_row = _md_split_row(dp2)
    del served
    torch.cuda.empty_cache()
    seconds["b_d"] = time.perf_counter() - t0 - seconds["a"]

    # (c): four gloo ranks, dp2 x tp2 with the recipe's rules, then resumed
    # under dp4 x tp1
    tp = _md_spawn("dp2tp2", 4, work)
    for r, res in enumerate(tp):
        fit, resumed = res["fit"], res["resumed"]
        _md_losses_close(f"(c) rank {r}", fit["record"]["step_loss"],
                         ref_loss, MD_FIT_LOSS_RTOL)
        first = dict(fit["first"])
        first.pop("running")
        res["grad_rel_rms"] = _md_grads_close(f"(c) rank {r}", first,
                                              ref_first, MD_GRAD_LIMITS)
        fc1 = "audio_encoder.fc1.weight"
        emb = "text_encoder.embedding.core.weight"
        for name, full in ((fc1, [512, 512]), (emb, [5000, 512])):
            half = [full[0] // 2, full[1]]
            if fit["shapes"][name] != half or fit["moments"][name] != half:
                raise AssertionError(f"(c) rank {r}: {name} "
                                     f"{fit['shapes'][name]}, moments "
                                     f"{fit['moments'][name]}, want {half}")
            if resumed["shapes"][name] != full or \
                    resumed["moments"][name] != full:
                raise AssertionError(f"(c) resumed rank {r}: {name} not "
                                     "whole under dp4 x tp1")
        rec = resumed["record"]
        if (rec["start_epoch"] != TRAIN_EPOCHS + 1
                or len(rec["step_loss"]) != TRAIN_STEPS
                or not np.isfinite(rec["step_loss"]).all()
                or resumed["mesh"] != {"data": 4, "model": 1}):
            raise AssertionError(f"(c) rank {r}: the resumed run started at "
                                 f"epoch {rec['start_epoch']} with losses "
                                 f"{rec['step_loss']} on {resumed['mesh']}")
    fit0, res0 = tp[0]["fit"], tp[0]["resumed"]
    report["c"] = {"step_loss": fit0["record"]["step_loss"],
                   "loss_rel_gap": max(_md_loss_gap(
                       r["fit"]["record"]["step_loss"], ref_loss)
                       for r in tp),
                   "grad_rel_rms": [r["grad_rel_rms"] for r in tp],
                   "step_ms": fit0["step_ms"], "fit_s": fit0["fit_s"],
                   "spawn_s": tp[0]["spawn_s"],
                   "launches": _nonzero(fit0["launches"]),
                   "gru_rows": fit0["gru_rows"],
                   "resumed": {"start_epoch": res0["record"]["start_epoch"],
                               "step_loss": res0["record"]["step_loss"],
                               "step_ms": res0["step_ms"],
                               "launches": _nonzero(res0["launches"])}}

    seconds["c"] = time.perf_counter() - t0 - seconds["a"] - seconds["b_d"]
    report["fault"] = _md_fault(work, ref_loss, ref_first, ref16, limits16)
    seconds["fault"] = time.perf_counter() - t0 - sum(seconds.values())
    # (e): the data-parallel predictor
    report["e"] = _md_predictor(tok)
    seconds["e"] = time.perf_counter() - t0 - sum(seconds.values())
    # (f): the sentence-level, self-supervision and class-mapping runners
    report["f"], runner_paths = _md_runners_part(work, teacher)
    seconds["f"] = time.perf_counter() - t0 - sum(seconds.values())
    torch.backends.cudnn.deterministic = False
    by_path = {"multi_device_a": {}, "multi_device_dp2":
               dp2[0]["fit"]["launches"],
               "multi_device_dp2_bf16": dp2[0]["bf16"]["launches"],
               "multi_device_dp2tp2": tp[0]["fit"]["launches"],
               "multi_device_dp4tp1": tp[0]["resumed"]["launches"],
               "multi_device_predictor": report["e"].pop("launches")}
    by_path["multi_device_a"] = {k: v for k, v in report["a"][
        "launches"].items()}
    by_path.update(runner_paths)
    return report, by_path, split_row


@functools.lru_cache(maxsize=None)
def _port_kernel_pattern():
    """A pattern for the port's kernels in a profiled kernel name: each
    ``__global__`` function of ``csrc/``, as a whole identifier of the
    demangled name."""
    import re

    from texttoaudiogrounding_tpu_torch.ops.kernels import _build
    names = set()
    for f in _build.CSRC.glob("*.cu*"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(\w+)\s*\(", f.read_text()))
    return re.compile(r"(?:^|[\s:])(?:" + "|".join(sorted(names)) + r")[<(]")


_CONV_OPS = ("aten::convolution", "aten::convolution_backward")


def _profile_markers() -> None:
    """The first kernels launched under the profiler can go unrecorded on
    the card's machine (one in a fresh process; three, a traced CDur
    step's first, late in a whole run): marker kernels take their place,
    are left out by their name where recorded, and a synchronize ends
    them (``_unrecorded`` counts the launches after it)."""
    import torch
    for _ in range(MARKERS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


MARKERS = 8


def _trace(fn, request_ms: float, by_launch: bool = False) -> dict:
    """Device time by kernel name over one profiled call of ``fn``, and the
    device's idle share of the untraced time ``request_ms`` (kernels run
    on one stream, so their times add up).  ``gru_ms`` sums the port's
    GRU kernels, ``conv_ms`` the device time under PyTorch's convolution
    operators, forward and backward (the plain path's convolutions),
    ``pool_ms`` the pool kernels; with ``by_launch`` also each launch's
    device ms in launch order."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    # a by-launch trace is taken again when the profiler recorded none of
    # the call's kernels (only a memset, once in dozens of profiles on an
    # H100) or dropped the record of some (1 of 3 once, in a whole run):
    # see _unrecorded
    for attempt in range(1, 4 if by_launch else 2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _profile_markers()
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == cuda]
        launched = sorted((e for e in events
                           if "spin_kernel" not in e.name),
                          key=lambda e: e.time_range.start)
        unrecorded = _unrecorded(prof.events(), events)
        if not unrecorded and any(
                not e.name.startswith(("Memset", "Memcpy"))
                for e in launched):
            break
    kernels = {}
    for e in launched:
        ms, count = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    conv_ms = 0.0
    for evt in prof.key_averages():
        if evt.key in _CONV_OPS:
            total = getattr(evt, "device_time_total", None)
            if total is None:
                total = evt.cuda_time_total
            conv_ms += total / 1e3
    busy = sum(ms for ms, _ in kernels.values())
    port = sum(ms for k, (ms, _) in kernels.items() 
               if _port_kernel_pattern().search(k))
    gru_ms = sum(ms for k, (ms, _) in kernels.items() if "gru_" in k)
    pool_ms = sum(ms for k, (ms, _) in kernels.items()
                  if "dual_pool_" in k or "bn_pool_" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    order = {}
    if by_launch:
        order["by_launch"] = [{"kernel": e.name[:60],
                               "ms": e.time_range.elapsed_us() / 1e3}
                              for e in launched]
    return {**order, "attempts": attempt, "unrecorded": unrecorded,
            "marker_recorded": len(events) - len(launched),
            "request_ms": request_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / request_ms,
            "port_kernels_ms": port, "gru_ms": gru_ms, "pool_ms": pool_ms,
            "conv_ms": conv_ms,
            "launches": sum(c for _, c in kernels.values()),
            "top": [{"kernel": k[:90], "ms": ms, "count": c}
                    for k, (ms, c) in top]}


def _unrecorded(events, device) -> int:
    """The kernel launches of the traced call whose kernel the profiler
    did not record: a CUDA runtime launch event on the host (which the
    port's libraries, with their own static runtime, report too) with no
    device event of its correlation id.  The launches before the first
    device synchronize (the marker's) are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    cpu = [e for e in events if e.device_type != cuda]
    syncs = [e.time_range.start for e in cpu
             if e.name == "cudaDeviceSynchronize"]
    if not syncs:
        return 0
    ids = {e.id for e in device}
    return sum(1 for e in cpu if "LaunchKernel" in e.name
               and e.time_range.start > min(syncs) and e.id not in ids)


def _ptxas(source: str) -> list:
    """Registers, static shared memory, stack and spills of each kernel of
    ``csrc/<source>.cu`` from its ``nvcc -Xptxas=-v`` build log, with the
    GEMM's dynamic shared memory (``igemm_smem``: 4 ring stages of
    (128 + BN) rows x 64 bytes, and 1024 bytes to align them) and the
    cluster GRU kernels' (``gru.cluster_plan``, ``forward_plan`` and
    ``walk_plan`` at the main path's shape)."""
    import re
    import shutil

    from texttoaudiogrounding_tpu_torch.ops.kernels import _build
    log = _build._lib_path(_build.CSRC / f"{source}.cu").with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    names = [k["function"] for k in out]
    if names and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    for k, name in zip(out, names):
        k["function"] = name
        bn = re.search(r"igemm_kernel<[^,]+, (\d+), (\d+)(, true)?", name)
        if bn and bn.group(3):
            # the slab form: 3 (BN = 256) or 4 stages of a 256-row slab
            # and three B slices
            n = int(bn.group(1))
            k["dynamic_smem"] = ((3 if n == 256 else 4)
                                 * (256 + 3 * n) * 64 + 1024)
        elif bn:
            k["dynamic_smem"] = 4 * (128 + int(bn.group(1))) * 64 + 1024
        if "logmel_v4_v2_kernel" in name:
            # the ring (4 x (128 + 256) rows of 64 bytes), pw (128 bins x
            # 136 frames), band and 1024 weights, 10 barriers, the align
            k["dynamic_smem"] = (4 * 384 * 64 + 128 * 136 * 4 + 64 * 3 * 4
                                 + 1024 * 4 + 10 * 8 + 1024)
        if "wino_fold_kernel<" in name:
            # the ring (7 x (128 + 64) rows of 64 bytes), the four y and
            # the scales
            k["dynamic_smem"] = (7 * 192 * 64 + 4 * 32 * 256 * 4
                                 + 16 * 192 * 4 + 1024)
        plans = {"gru_bwd_cluster<": "cluster_plan",
                 "gru_fwd_cluster<": "forward_plan",
                 "gru_walk_cluster<": "walk_plan"}
        plan = next((v for key, v in plans.items() if key in name), None)
        if plan:
            from texttoaudiogrounding_tpu_torch.ops.kernels import gru
            k["dynamic_smem"] = getattr(gru, plan)(KERNEL_CLIPS,
                                                   GRU_H)["smem"]
    return out


# The remat phase: one train step at full width with the activations kept
# ("off"), recomputed in the backward for the whole forward ("whole":
# trainer.remat, JAX jax.checkpoint) and for the four conv blocks
# ("blocks": Cnn8Rnn remat_blocks, JAX TTG_TRAIN_REMAT=1234), and "off"
# once more ("off_again"), the yardstick of what a rerun of the same step
# moves, on the f32 strong step and bf16 routes (b) and (c).
REMAT_ROUTES = {"f32": {},
                "b_bn_pool_gru_bf16": BF16_ROUTES["b_bn_pool_gru_bf16"],
                "c_pool_vjp_gru_bf16": BF16_ROUTES["c_pool_vjp_gru_bf16"]}
REMAT_VARIANTS = {"off": ({}, False), "whole": ({}, True),
                  "blocks": ({"remat_blocks": [1, 2, 3, 4]}, False),
                  "off_again": ({}, False)}
# a gradient or running statistic of a remat step against the step without:
# bit for bit, or within this relative RMS where a kernel sums in another
# order from one call to the next
REMAT_REL_RMS = 1e-6
REMAT_TIMED_STEPS = 5
# the per-iteration schedule of the remat phase's fit: 2 epochs of 3 steps
REMAT_COSINE = {"type": "CosineWithWarmup",
                "args": {"base_lr": 1e-3, "warmup_iters": 2,
                         "total_iters": 6, "final_lr_ratio": 0.1}}


def _remat_want(route: str, variant: str) -> dict:
    """The launches of one train step: the recompute reruns the forward's
    kernels, row 1 and row 13 (or 14) under the whole forward and the conv
    blocks' pool kernels (rows 11, 12 and row 12's statistics) under
    either; the backwards run once."""
    again = int(variant == "whole")
    if route == "f32":
        return _want(gru_fwd=1 + again, gru_bwd=1)
    pools = 4 * (1 + int(variant in ("whole", "blocks")))
    counts = {"logmel": 1 + again, "gru_fwd_bf16": 1 + again,
              "gru_bwd_bf16": 1}
    if route.startswith("b_"):
        counts.update(bn_pool_fwd=pools, bn_pool_stats=pools, bn_pool_bwd=4)
    else:
        counts.update(dual_pool_fwd=pools, dual_pool_bwd=4)
    return _want(**counts)


def _remat_gaps(got: dict, ref: dict) -> dict:
    """Of ``got``'s tensors against ``ref``'s: how many differ in a bit,
    and the largest relative RMS (0 where all are equal)."""
    import torch
    if set(got) != set(ref):
        raise AssertionError(f"remat: tensors {sorted(set(got) ^ set(ref))} "
                             "on one side only")
    differ, worst = [], 0.0
    for name, r in ref.items():
        g = got[name]
        if torch.equal(g, r):
            continue
        differ.append(name)
        g, r = g.double(), r.double()
        worst = max(worst, float(torch.sqrt(
            ((g - r) ** 2).mean() / (r ** 2).mean().clamp_min(1e-30))))
    return {"differ": len(differ), "of": len(ref), "rel_rms_max": worst,
            "first_differing": differ[:4]}


def _remat_step(runner, config: dict, sd: dict, batch: dict, loss_fn,
                variant: str) -> dict:
    """One train step of ``variant`` from ``sd`` and a fresh optimizer, the
    counts set to 0 just before: its loss, gradients, running statistics,
    the dropout generator's state after and the launches; then the step's
    ms (CUDA events, ``REMAT_TIMED_STEPS`` steps) and the peak memory."""
    import copy

    import torch

    from texttoaudiogrounding_tpu_torch.training.optim import Optimizer
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        strong_output_transform)
    from texttoaudiogrounding_tpu_torch.utils.registry import instantiate

    extra, whole = REMAT_VARIANTS[variant]
    runner.config["trainer"]["remat"] = whole
    model_cfg = copy.deepcopy(config["model"])
    model_cfg["audio_encoder"]["args"].update(extra)
    torch.manual_seed(config["seed"])
    model = instantiate(model_cfg, device=DEVICE)
    model.load_state_dict(sd)
    opt = Optimizer(config["optimizer"], model.parameters(), 1.0)
    grads: dict = {}

    def capture(loss, _grads):
        if not grads:
            grads.update({n: p.grad.detach().clone()
                          for n, p in model.named_parameters()
                          if p.grad is not None})

    runner.post_grad_hook = capture

    def step():
        return runner.train_step(model, loss_fn, opt, batch,
                                 strong_output_transform)

    _reset_counts()
    loss = step()
    torch.cuda.synchronize()
    launches = _counts()
    out = {"loss": float(loss), "grads": grads, "launches": launches,
           "stats": {n: b.detach().clone() for n, b in model.named_buffers()
                     if "running" in n},
           "generator": model.audio_encoder._generator.get_state()}
    runner.post_grad_hook = lambda *a: None
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out["step_ms"] = _cuda_ms(step, REMAT_TIMED_STEPS)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["peak_above_state_bytes"] = out["peak_bytes"] - before
    runner.config["trainer"]["remat"] = False
    del model, opt
    torch.cuda.empty_cache()
    return out


def _remat_schedule_fit(tok, work: Path) -> dict:
    """``StrongRunner.fit`` of the f32 strong config for 2 epochs of 3
    steps with ``REMAT_COSINE`` at ``lr_update_interval: iteration``: every
    step's rate must be the schedule's at that step (from 0), written
    here as its formula, and the epoch lines must log the last step's;
    row 13 once each way a train step and once a validation batch."""
    import math

    import numpy as np
    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner, strong_output_transform)

    runner = StrongRunner(device=DEVICE)
    config = _strong_config(str(work / "remat_cosine"))
    config["lr_scheduler"] = REMAT_COSINE
    config["trainer"].update(epochs=2, epoch_length=3,
                             lr_update_interval="iteration")
    config = runner.setup(config)
    exp_dir = runner.prepare_experiment()
    train_loader, val_loader = _loaders(tok, config["seed"])
    model = runner.build_model()
    model.load_state_dict(random_state_dict(model, seed=1))
    _reset_counts()
    record = runner.fit(model, runner.build_loss(), train_loader, val_loader,
                        strong_output_transform, exp_dir)
    torch.cuda.synchronize()
    launches = _counts()
    a = REMAT_COSINE["args"]

    def rule(i):
        if i < a["warmup_iters"]:
            return a["base_lr"] * (i + 1) / a["warmup_iters"]
        p = min((i - a["warmup_iters"]) / (a["total_iters"]
                                           - a["warmup_iters"]), 1.0)
        return a["base_lr"] * (a["final_lr_ratio"] + (
            1 - a["final_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * p)))

    want_lr = [rule(i) for i in range(6)]
    got_lr = record["step_lr"]
    logged = [line.split("lr: ")[1].split()[0] for line in (
        exp_dir / "train.log").read_text().splitlines() if "lr: " in line]
    want = _want(gru_fwd=6 + 2 * VAL_STEPS, gru_bwd=6)
    if len(got_lr) != 6 or not np.allclose(got_lr, want_lr, rtol=1e-12,
                                           atol=0):
        raise AssertionError(f"remat: the per-iteration rates {got_lr}, "
                             f"the schedule's {want_lr}")
    if logged != [f"{want_lr[i]:.2g}" for i in (2, 5)]:
        raise AssertionError(f"remat: the epoch lines log the rates "
                             f"{logged}, not the epochs' last steps'")
    if launches != want or not np.isfinite(record["step_loss"]).all():
        raise AssertionError(f"remat: the scheduled fit launched "
                             f"{_nonzero(launches)}, losses "
                             f"{record['step_loss']}")
    return {"step_lr": got_lr, "schedule_lr": want_lr, "logged_lr": logged,
            "step_loss": record["step_loss"], "launches": launches,
            "launches_nonzero": _nonzero(launches)}


def remat_phase(tok, work: Path) -> tuple:
    """The f32 strong step and bf16 routes (b) and (c) at full width, one
    batch of 32 x 10 s, cuDNN deterministic: each remat variant's loss,
    gradients, running statistics and generator state against the step
    without (bit for bit or within ``REMAT_REL_RMS``), its launches exact
    (``_remat_want``), its step ms and peak memory; then the scheduled fit
    (``_remat_schedule_fit``).  Raises on any miss."""
    import torch

    from texttoaudiogrounding_tpu_torch import random_state_dict
    from texttoaudiogrounding_tpu_torch.data.loader import to_device
    from texttoaudiogrounding_tpu_torch.training.runner_strong import (
        StrongRunner)

    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    report: dict = {"clips": TRAIN_CLIPS, "clip_s": CLIP_S,
                    "rel_rms_limit": REMAT_REL_RMS,
                    "timed_steps": REMAT_TIMED_STEPS, "routes": {}}
    paths: dict = {}
    try:
        _, val_loader = _loaders(tok, 1)
        batch = to_device(next(iter(val_loader)), torch.device(DEVICE))
        for route, args in REMAT_ROUTES.items():
            runner = StrongRunner(device=DEVICE)
            config = runner.setup(_strong_config(str(work / "remat"),
                                                 **args))
            model = runner.build_model()
            sd = random_state_dict(model, seed=1)
            del model
            loss_fn = runner.build_loss()
            runs = {v: _remat_step(runner, config, sd, batch, loss_fn, v)
                    for v in REMAT_VARIANTS}
            ref = runs["off"]
            entry = {}
            for variant, run in runs.items():
                label = f"remat {route} {variant}"
                want = _remat_want(route, variant)
                if run["launches"] != want:
                    raise AssertionError(
                        f"{label}: launches {_nonzero(run['launches'])}, "
                        f"expected {_nonzero(want)}")
                grads = _remat_gaps(run["grads"], ref["grads"])
                stats = _remat_gaps(run["stats"], ref["stats"])
                same_gen = torch.equal(run["generator"], ref["generator"])
                if (run["loss"] != ref["loss"] or not same_gen
                        or grads["rel_rms_max"] > REMAT_REL_RMS
                        or stats["rel_rms_max"] > REMAT_REL_RMS):
                    raise AssertionError(
                        f"{label}: loss {run['loss']} (off {ref['loss']}), "
                        f"generator state equal {same_gen}, gradients "
                        f"{grads}, running statistics {stats}")
                entry[variant] = {
                    "loss": run["loss"], "grads": grads, "stats": stats,
                    "step_ms": run["step_ms"],
                    "peak_gib": run["peak_bytes"] / 2 ** 30,
                    "peak_above_state_gib":
                        run["peak_above_state_bytes"] / 2 ** 30,
                    "launches": _nonzero(run["launches"])}
                paths[f"remat_{route}_{variant}"] = run["launches"]
            report["routes"][route] = entry
            del runs, ref, sd
            torch.cuda.empty_cache()
        report["schedule"] = _remat_schedule_fit(tok, work)
        paths["remat_schedule"] = report["schedule"]["launches"]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    report["phase_s"] = time.perf_counter() - t0
    return report, paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for a JSON report and the build logs")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "texttoaudiogrounding_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: texttoaudiogrounding_tpu_torch is not beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # the plain versions run in full f32 on the card: cuDNN would run f32
    # convolutions (and matmul might run) in TF32 otherwise
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from texttoaudiogrounding_tpu_torch import native
    from texttoaudiogrounding_tpu_torch.data.tokenizer import DictTokenizer
    from texttoaudiogrounding_tpu_torch.data.vocabulary import Vocabulary
    from texttoaudiogrounding_tpu_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build_s = _build.build_all()
    t0 = time.perf_counter()
    native.build()
    native_s = time.perf_counter() - t0
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "sources": [s.name for s in _build.sources()],
                      "native_decoder_s": native_s, "card": smi}),
          flush=True)
    ptxas = {src: _ptxas(src) for src in ("conv_block_v2", "conv_block1_v2",
                                          "logmel_v2", "gru_fwd_sm90",
                                          "gru_bwd_sm90", "gru_walk_sm90",
                                          "bn_pool_v2", "conv_block_wino_v2",
                                          "conv_block_tri_v2",
                                          "conv_block_mel3_v2",
                                          "pair_conv_pool_v2",
                                          "block1_small_v2", "logmel_v3_v2",
                                          "logmel_v4_v2")}
    print(json.dumps({"phase": "ptxas", "kernels": ptxas}), flush=True)
    report = {"card": smi, "build_s": build_s, "native_decoder_s": native_s,
              "ptxas": ptxas}
    rng = np.random.default_rng(0)
    kernels = (kernel_phase(KERNEL_CLIPS, rng)
               + gru_kernel_phase(KERNEL_CLIPS, rng)
               + gru_cdur_rows(KERNEL_CLIPS, np.random.default_rng(19))
               + gru_mixup_rows(np.random.default_rng(21))
               + gru_text_rows(np.random.default_rng(23))
               + pool_kernel_phase(KERNEL_CLIPS))
    print(json.dumps({"phase": "kernels", "card": smi, "kernels": [
        {k: row[k] for k in ("name", "max_abs_err", "rel_rms_err",
                             "tolerance", "kernel_ms", "plain_ms")}
        for row in kernels]}), flush=True)

    vocab = Vocabulary()
    for word in ["<pad>", "<unk>"] + [f"w{i}" for i in range(2, 5000)]:
        vocab.add_word(word)
    tok = DictTokenizer(vocab)
    # the training runs' experiment directories stay here for the
    # evaluate phase; removed when the script ends
    work_dir = tempfile.TemporaryDirectory(prefix="ttg_smoke_")
    work = Path(work_dir.name)
    vocab.save(work / "vocab.pkl")
    serving, handoff = serving_phase(rng, tok)
    report["serving"] = serving
    print(json.dumps({"phase": "serving", "card": smi,
                      "clips_per_s": serving["clips_per_s"],
                      "largest": serving["largest"],
                      "requests": serving["requests"],
                      "switches": serving["switches"],
                      "paths": {k: {"clips_per_s": v["clips_per_s"],
                                    "launches": v["trace"]["launches"],
                                    "device_idle_share":
                                        v["trace"]["device_idle_share"]}
                                for k, v in serving["paths"].items()}}),
          flush=True)
    designs, design_launches, v1_route = designs_phase(*handoff)
    del handoff
    report["v1_route"] = v1_route
    print(json.dumps({"phase": "v1_route", "card": smi, "rows": v1_route}),
          flush=True)
    kernels += designs
    print(json.dumps({"phase": "designs", "card": smi, "kernels": [
        {k: v for k, v in row.items() if k not in (
            "route", "source", "replaces", "tolerance", "library")
            and not k.endswith("trace")}
        for row in designs]}), flush=True)
    train, strong_exp = training_phase(tok, work)
    report["train"] = train
    print(json.dumps({"phase": "train", "card": smi, **{
        k: train[k] for k in ("steps_per_s", "clips_per_s", "step_ms",
                              "step_ms_tf32", "tf32", "fit_launches",
                              "fixed_batch_loss", "grad_rel_rms_trunk_max",
                              "grad_rel_rms_rest_max")},
        "gru_ms": train["trace"]["gru_ms"],
        "conv_ms": train["trace"]["conv_ms"],
        "device_idle_share": train["trace"]["device_idle_share"]}),
        flush=True)

    train16 = training_bf16_phase(tok)
    report["train_bf16"] = train16
    print(json.dumps({"phase": "train_bf16", "card": smi, **{
        k: train16[k] for k in ("fit_launches", "fixed_batch_loss",
                                "grad_rel_rms_trunk_max",
                                "grad_rel_rms_rest_max", "grad_limits",
                                "plain_self_rel_rms_trunk_max",
                                "plain_self_rel_rms_rest_max")},
        "routes": {k: {"step_ms": v["step_ms"],
                       "step_ms_runs": v["step_ms_runs"],
                       "clips_per_s": v["clips_per_s"],
                       **{m: v["trace"][m] for m in (
                           "device_idle_share", "launches", "pool_ms",
                           "gru_ms", "conv_ms")}}
                   for k, v in train16["routes"].items()}}), flush=True)

    weak, weak_exp = training_weak_phase(tok, work)
    report["train_weak"] = weak
    print(json.dumps({"phase": "train_weak", "card": smi, **{
        k: weak[k] for k in ("grad_rel_rms_max", "fixed_batch_loss")},
        "fits": {k: {"fit_s": v["fit_s"], "launches": v["launches"]}
                 for k, v in weak["fits"].items()},
        "routes": {k: {"step_ms": v["step_ms"],
                       "step_ms_runs": v["step_ms_runs"],
                       "clips_per_s": v["clips_per_s"],
                       **{m: v["trace"][m] for m in (
                           "device_idle_share", "launches", "gru_ms",
                           "conv_ms")}}
                   for k, v in weak["routes"].items()}}), flush=True)

    evaluation = evaluate_phase(tok, work, strong_exp, weak_exp)
    report["evaluate"] = evaluation
    print(json.dumps({"phase": "evaluate", "card": smi, **{
        k: evaluation[k] for k in ("forward", "native_vs_numpy", "resume")},
        "from_experiment_max_abs": evaluation["from_experiment"][
            "max_abs_vs_evaluate"],
        **{k: {m: evaluation[k][m] for m in (
            "metrics", "seconds", "host_seconds", "max_abs_vs_kernel",
            "max_abs_vs_f32", "curve_files") if m in evaluation[k]}
           for k in ("f32", "plain_gru", "serving", "weak")}}), flush=True)

    cdur, _ = train_cdur_phase(tok, work)
    report["train_cdur"] = cdur
    print(json.dumps({"phase": "train_cdur", "card": smi,
                      "fit_launches": _nonzero(cdur["fit_launches"]), **{
        k: cdur[k] for k in ("fit_s", "fixed_batch_loss",
                             "step_ms", "clips_per_s", "frontend_matmul_ms",
                             "frontend_matmul_cuda_ms", "frontend_cuda_ms",
                             "op_profile_unrecorded",
                             "trace_files", "trace_gru_kernels",
                             "from_experiment_max_abs", "time_resolution")},
        "evaluate": {k: cdur["evaluate"][k] for k in ("metrics",
                                                      "host_seconds")},
        **{m: cdur["trace"][m] for m in ("conv_ms", "gru_ms", "launches",
                                         "device_busy_ms",
                                         "device_idle_share")}}),
        flush=True)
    frozen = finetune_frozen_phase(tok, work, weak_exp)
    report["finetune_frozen"] = frozen
    print(json.dumps({"phase": "finetune_frozen", "card": smi, **frozen,
                      "launches": _nonzero(frozen["launches"])}), flush=True)
    desed = desed_phase(weak_exp)
    report["desed"] = desed
    print(json.dumps({"phase": "desed", "card": smi, **desed,
                      "launches": _nonzero(desed["launches"])}), flush=True)
    sentence = train_sentence_phase(tok, work)
    report["train_sentence"] = sentence
    phrase, word = sentence["phrase_wise"], sentence["word_wise"]
    print(json.dumps({"phase": "train_sentence", "card": smi,
                      "phrase_wise": {
                          **{k: phrase[k] for k in (
                              "fit_s", "phrases_in_batch", "step_ms",
                              "clips_per_s", "fixed_batch_loss",
                              "grad_rel_rms_trunk_max",
                              "grad_rel_rms_rest_max")},
                          "launches": _nonzero(phrase["launches"]),
                          **{m: phrase["trace"][m] for m in (
                              "gru_ms", "conv_ms", "launches",
                              "device_idle_share")}},
                      "word_wise": {
                          "fit_s": word["fit_s"],
                          "launches": _nonzero(word["launches"]),
                          "evaluate": {k: word["evaluate"][k] for k in (
                              "metrics", "seconds", "host_seconds",
                              "max_abs_vs_plain_gru")}}}), flush=True)
    selfsup = train_selfsup_phase(work, weak_exp)
    report["train_selfsup"] = selfsup
    print(json.dumps({"phase": "train_selfsup", "card": smi, **{
        k: v for k, v in selfsup.items() if k not in ("launches", "trace")},
        "launches": _nonzero(selfsup["launches"]),
        **{m: selfsup["trace"][m] for m in ("gru_ms", "conv_ms", "launches",
                                            "device_idle_share")}}),
          flush=True)
    cross = cross_models_phase(tok)
    report["cross_models"] = cross
    print(json.dumps({"phase": "cross_models", "card": smi, **cross}),
          flush=True)
    t0 = time.perf_counter()
    mapping = class_mapping_phase(work)
    mapping["phase_s"] = time.perf_counter() - t0
    report["class_mapping"] = mapping
    mweak, mstrong = mapping["weak"], mapping["strong"]
    print(json.dumps({"phase": "class_mapping", "card": smi,
                      "phase_s": mapping["phase_s"], "weak": {
        **{k: mweak[k] for k in (
            "fit_s", "gru_batches", "step_ms", "clips_per_s",
            "fixed_batch_loss", "grad_rel_rms_trunk_max",
            "grad_rel_rms_rest_max", "evaluate_tagging")},
        "launches": _nonzero(mweak["launches"])}, "strong": {
        **{k: mstrong[k] for k in ("fit_s", "step_ms", "clips_per_s",
                                   "phrases", "max_abs_vs_plain_gru")},
        "launches": _nonzero(mstrong["launches"]),
        "evaluate": {k: mstrong["evaluate"][k] for k in (
            "metrics", "seconds", "host_seconds")},
        "evaluate_launches": _nonzero(mstrong["evaluate"]["launches"])}}),
        flush=True)
    t0 = time.perf_counter()
    cli_report = cli_phase(work, strong_exp)
    cli_report["phase_s"] = time.perf_counter() - t0
    report["cli"] = cli_report
    print(json.dumps({"phase": "cli", "card": smi, **{
        k: (_nonzero(v) if k.endswith("launches") else v)
        for k, v in cli_report.items()}}), flush=True)
    released = released_model_phase(np.random.default_rng(49))
    report["released_model"] = released
    print(json.dumps({"phase": "released_model", "card": smi,
                      **released}), flush=True)
    zoo = zoo_phase()
    report["zoo"] = zoo
    print(json.dumps({"phase": "zoo", "card": smi, **zoo}, default=str),
          flush=True)
    t0 = time.perf_counter()
    multi, multi_paths, split_row = multi_device_phase(
        tok, work, weak_exp / "best.pth")
    multi["phase_s"] = time.perf_counter() - t0
    report["multi_device"] = multi
    kernels.append(split_row)
    print(json.dumps({"phase": "multi_device", "card": smi,
                      "phase_s": multi["phase_s"],
                      "step_ms": {k: multi[k]["step_ms"]
                                  for k in ("a", "b", "c")},
                      "request_ms": {k: v["request_ms"] for k, v in
                                     multi["e"].items()},
                      **{k: {m: v for m, v in multi[k].items()
                             if m not in ("step_loss", "plain_step_loss")}
                         for k in ("a", "b", "c", "d", "fault")},
                      "limits": multi["limits"], "e": multi["e"],
                      "f": multi["f"]},
                     default=str), flush=True)
    remat, remat_paths = remat_phase(tok, work)
    report["remat"] = remat
    print(json.dumps({"phase": "remat", "card": smi, **remat, "schedule": {
        k: v for k, v in remat["schedule"].items() if k != "launches"}}),
        flush=True)
    work_dir.cleanup()

    # launches on each path, counted from zero just before it
    by_path = {"serving": {**serving["launches"], "gru_fwd_bf16":
                           serving["gru_fwd_bf16_launches"]},
               "serving_block1_int8": serving["block1_int8_launches"],
               "serving_block1_single": serving["block1_single_launches"],
               **{f"serving_{k}": v
                  for k, v in serving["switch_launches"].items()},
               "designs": design_launches,
               "train": train["fit_launches"],
               "train_bf16": train16["fit_launches"],
               **{f"train_weak_{k}": v["launches"]
                  for k, v in weak["fits"].items()},
               **{f"evaluate_{k}": evaluation[k]["launches"]
                  for k in ("f32", "serving", "weak", "from_experiment")},
               "train_cdur": cdur["fit_launches"],
               "evaluate_cdur": cdur["evaluate"]["launches"],
               "finetune_frozen": frozen["launches"],
               "desed": desed["launches"],
               "train_sentence_phrase": phrase["launches"],
               "train_sentence_word": word["launches"],
               "evaluate_sentence_word": word["evaluate"]["launches"],
               "train_selfsup": selfsup["launches"],
               "cross_models": cross["launches"],
               "train_class_mapping_weak": mweak["launches"],
               "evaluate_tagging": mweak["evaluate_tagging"]["launches"],
               "train_class_mapping_strong": mstrong["launches"],
               "evaluate_class_mapping": mstrong["evaluate"]["launches"],
               "cli_inference": cli_report["inference_launches"],
               "cli_deployed": cli_report["deployed_launches"],
               **{f"released_model_{k}": v
                  for k, v in released["launches"].items()},
               **{f"zoo_{k}": v["launches"]
                  for k, v in zoo["cross"].items()},
               "zoo_rnn_encoder": zoo["rnn_encoder"][256]["launches"],
               "zoo_rnn_encoder_h300": zoo["rnn_encoder"][300]["launches"],
               "zoo_rnn_encoder_h302": zoo["rnn_encoder"][302]["launches"],
               "zoo_rnn_encoder_split": zoo["rnn_encoder_split"]["launches"],
               **{f"zoo_gru_plan_{k}": v["launches"]
                  for k, v in zoo["gru_plans"].items()},
               **multi_paths, **remat_paths}
    for row in kernels:
        counter = row.get("counter", row["name"])
        row["launches_by_path"] = {p: c.get(counter, 0)
                                   for p, c in by_path.items()}
        # a row at one path's shape counts that path's launches
        row["launches"] = (row["launches_by_path"][row["path"]]
                           if "path" in row
                           else sum(row["launches_by_path"].values()))
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on any path")
    report["kernels"] = kernels
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
        for log in _build.build_dir().glob("*.log"):
            (out / log.name).write_text(log.read_text())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
