#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Device and build: prints the card's name and power limit and builds
   the port's CUDA kernels from ``mxnet_tpu_torch/csrc`` and the user
   kernels from their CUDA source text (the example's and this
   script's, below), one ``nvcc`` per source, all started together; the
   paged kernels' three libraries (``PAGED_SOURCES``, the longest
   builds) compile on a thread while the checks of every other kernel
   and the training paths (phases 4, 4b-4e and 5, which launch no paged
   kernel) run, and their own checks come after those (a
   ``phase_walls`` line near the end gives the seconds at each phase's
   end).  Then, with
   ``cuobjdump`` from the
   toolkit beside ``nvcc``, the tensor-core kernels (``TC_KERNELS``:
   B1's forward, B1's two backward kernels, B5's forward and its two
   backward kernels, B8 and both B9 kernels, at each head-width bucket,
   every fp32, bf16 and fp16 instantiation) must hold tensor-core instructions (``HMMA``/
   ``HGMMA``) in their SASS, and those at D = 64 no local (spill)
   memory; each one's registers, shared memory and local memory are
   printed (``tensor_cores`` lines).  The paged kernels' one body
   (``paged::attend_kernel``) is read the same way in its three
   libraries (``paged_report``: registers, shared and local memory, the
   cluster size and the CTAs an SM holds; ``paged_resources`` lines at
   D = 64): every head-width bucket for every page
   reader, no local memory at D = 64, at least two CTAs an SM.
2. Kernels against their plain PyTorch versions on the card, at the
   main paths' shapes, in fp32 and bf16, and the fp16 instantiations of
   rows 1-9 at the table's shapes (``half_kernel_checks``; tolerances in
   ``TOL`` and ``BWD_TOL``, fp16's from bf16's by the two formats' unit
   roundoff): the time of each (CUDA events, median of 20 after
   warm-up), of its plain version, of a PyTorch library call computing
   the same function (timed here only, used nowhere in the port) and
   the least time the card could take for the work (``bound_ms``; the
   tensor-core kernels also carry ``bound_tc_ms``, the same work at
   ``PEAK_TC_FLOPS``, and ``back_to_back_ms``, events around 20 queued
   launches, which hides the host's launch overhead and its noise).  B1's forward and backward also run on a qkv off
   16-byte alignment, and B5 on BTHD buffers off it (``offset=1``).
   The quantized decode runs over int8 and fp8 pools made by the port's
   ``quantize_kv``; the verify kernel over fp32, bf16, int8 and fp8
   pools, and each of its rows must ``torch.equal`` the decode kernel's
   output at ``lengths = start + 1 + w``.  The paged kernels also carry
   ``back_to_back_ms`` and ``device_ms`` (a CUDA graph of 20 calls: the
   device's time without the host's), and run again at the edges of
   their work partition (``paged_edge_checks``: lengths and starts at
   multiples of 8 and 16 pages and beside them, shorter than a page,
   empty; windows of 1, 5 and 9 rows; head widths 32, 37, 48, 64, 96
   and 128; ``paged_edges`` lines).  B1's forward and backward and
   the paged kernels (decode, quantized decode, verify over all four
   pools) run again at the head widths of ``WIDTH_CASES``: 4 heads of 32
   lanes (the default ``transformer_lm``) and 6 of 128.  The LSTM recurrence
   (``lstm_scan``, fp32 only) runs at (T, B, H) = (60, 32, 200),
   (10, 32, 200) and (7, 3, 37), where a thread-block cluster holds ut,
   and at (60, 32, 512) and (20, 8, 1024), where the L2-streaming kernel
   runs (``LSTM_SHAPES``; each record names its design), with random
   non-zero states; its library yardstick is cuDNN's LSTM
   (``torch.nn.LSTM``) fed the projection through an identity input
   weight.  ``flash_mha`` and its two backward
   kernels run on (B, H, T, D) views of BTHD tensors at ``MHA_SHAPES``:
   the DPA path's (8, 12, 1024, 1024, 64) causal, a tail (T = 1000),
   Tq < Tk, and head widths 128 and 80; their library yardstick is
   SDPA's forward and backward.  Then ``float64_check``: B1's and B5's
   forward and backward at the LM's attention shape against their plain
   versions' formulas in float64 (max error over tolerance and mean
   signed error of each output).  Before the next checks, B8 and B9
   must have launched 0 times (the plain versions of B1, B2, B3 and B5
   run the plain partial body).  ``flash_attention_partial`` (B8) and
   its two backward kernels (B9) run on BTHD tensors at
   ``PARTIAL_SHAPES``: the ring's hops at (1, 12, 4096, 4096, 64) on the
   diagonal, in the past, with a positive ``kv_offset`` that leaves the
   first 1024 rows without a key, and non-causal; the Ulysses decode hop
   (1, 3, 2048, 16384, 64) at ``kv_offset`` -8000; a tail (T = 1000),
   the same with every row masked, head widths 128 and 80, and an odd
   width (37) whose rows are off 16-byte alignment.  m must
   ``torch.equal`` the plain m's -inf pattern, such rows hold o = 0 and
   l = 0 exactly, and o / l agrees within ``TOL``; the yardstick is SDPA
   with the hop's boolean mask (the same QK^T and PV work, normalized:
   no PyTorch call returns (o, m, l)) and SDPA's backward, in fp32 and
   bf16; B8's records carry its tensor-core bound (``bound_tc_ms``).
2b. User kernels (``mt.rtc``, the port of ``rtc.pallas_op``): the
   example's ``user_silu`` and ``user_silu_grad`` at its (16, 32) batch
   (and, as extra check lines, at (8192, 3072)) and this script's
   exact-erf ``user_gelu`` and ``user_gelu_grad`` at the GELU LM's
   (8, 1024, 3072), fp32, against their plain versions
   (``TOL``), timed as above and also back to back (events around 20
   queued launches, which hides the host's launch overhead), beside
   ``F.silu``/``F.gelu`` and aten's ``silu_backward``/``gelu_backward``;
   the Triton example's ``user_triton_silu`` and
   ``user_triton_silu_grad`` (``rtc.triton_op``, compiled by Triton at
   their first call) the same way in fp32 and bf16 at (16, 32) and
   (8, 1024, 3072).
   Then the API on ``gpu(0)``: ``register_op`` of ``axpb``
   imperatively and through ``bind``; ``rowsum`` (an output of shape
   (rows, 1) through a callable ``out_like``, ``sym.infer_shape``) and
   ``tiled_scale`` (a 2 x 2 grid of 128 x 128 tiles through
   ``grid``/``block``) equal to their plain versions; a deliberately
   broken user source must raise ``MXNetError`` carrying nvcc's output
   (the run's one expected failure, asserted); a ``cuda_op`` without a
   VJP runs forward and raises when differentiated.
3. Serving: a GPT-2-small-class LM (12 layers, d_model 768, 12 heads,
   d_ff 3072, vocab 32768, 1024 positions; random weights from
   ``np.random.RandomState(0)``) serves through ``DecodeEngine`` (its
   decode, verify and miss-prefill buckets CUDA graphs, whose replays
   add the launches their captures recorded), four runs, each with the
   launch counts reset just before it and read just after:
   A. fp32 pages, 16 requests of 32 tokens: every kernel must have
      launched exactly 12 times per prefill / per decode step, and the
      full forward must reproduce the generated greedy tokens wherever
      the top-2 margin exceeds 1e-3;
   B. fp32 pages with ``spec_tokens=4`` (n-gram proposer), 16 requests
      whose prompts repeat a seeded random segment, 64 tokens each:
      drafts must be accepted, the verify kernel must launch 12 times a
      verify step and the decode kernel 12 times a plain step, and the
      full-forward check holds;
   C. int8 pages with ``spec_tokens=4``, the same requests: the
      quantized kernels launch the same way, drafts are accepted, every
      greedy stream's first token equals run B's (prefill attends raw
      K/V), and the chains' agreement with run B's is printed;
   D. fp8 pages without speculation, 4 requests: the quantized decode
      kernel launches 12 times a step.
3b. The default LM (``default_lm_path``): ``transformer_lm`` at its own
   defaults (4 layers, 4 heads of width 32, d_model 128; ``DEFAULT_LM``)
   serves 8 greedy requests (B1 and the decode kernel 4 times a prefill
   and a step, the full forward reproducing the tokens) and takes one
   ``forward_backward`` through ``Module`` on ``gpu(0)`` at batch 4 x
   512, held against the same step by the port on the CPU (loss to 1e-4
   relative, weight gradients within ``BWD_TOL``).
4. Training: the same LM, fp32, as ``transformer_lm(..., head="ce")``
   through ``mod.Module`` on ``gpu(0)``, bound at batch 8 x 1024 tokens
   from the same weights, takes 10 SGD steps (momentum 0.9,
   ``TRAIN_LR``) over a seeded random-walk token stream.  Every step
   must launch 12 forward and 12 + 12 backward attention kernels, every
   ``qkv_weight`` gradient must be finite and non-zero, and the mean
   loss of the last 3 steps must be below the first step's.
4b. DotProductAttention: the same LM written with user attention
   symbols (``dpa_lm_symbol``: separate q/k/v projections, ``Reshape``
   to (B, T, H, D), ``DotProductAttention(causal=True)``, ``Reshape``
   back), its weights the packed ones cut into thirds
   (``split_qkv_params``).  One ``forward_backward`` on the first batch
   in a fresh module each, counts reset just before: the packed
   ``transformer_lm``, then the BHTD and BTHD variants, whose mean loss
   must agree with the packed LM's to 1e-4 relative and whose q/k/v
   weight gradients must match the thirds of its ``qkv_weight``
   gradient within ``BWD_TOL``.  Then ``TRAIN_STEPS`` SGD steps as in
   4: every step launches ``flash_mha`` and both its backward kernels
   12 times each and the packed kernels never, every q/k/v weight
   gradient is finite and non-zero, and the loss falls.  Last,
   ``mt.nd.DotProductAttention`` on ``gpu(0)`` NDArrays launches
   ``flash_mha`` once and equals the plain version.
4c. The user-kernel example (``mxnet_tpu_torch/examples/
   user_cuda_kernel.py``, the port of ``examples/user_pallas_kernel.py``):
   ``main(gpu(0))`` runs ``mt.nd.user_silu``, then FC(32) →
   ``user_silu`` → FC(2) → ``SoftmaxOutput`` through ``Module.fit`` (10
   epochs, SGD 0.1, ``Xavier()``, batch 16): accuracy above 0.85, and
   every training batch launches ``user_silu`` once and
   ``user_silu_grad`` (its VJP) once; then the Triton example
   (``examples/user_triton_kernel.py``) the same way, its kernels
   ``user_triton_silu`` and ``user_triton_silu_grad`` (in the graphed
   steps too: ``TracedLaunches`` counts them by their Triton names).
4d. The GELU LM: the DPA LM of 4b with its 12 feed-forward GELUs the
   user op ``user_gelu`` (``dpa_lm_symbol(..., gelu_op="user_gelu")``),
   full width.  Its first step must equal the built-in-GELU DPA LM's on
   the same weights and batch (mean loss to 1e-5 relative; ``ff1`` and
   q/k/v weight gradients within ``BWD_TOL``); then ``TRAIN_STEPS`` SGD
   steps as in 4, each launching ``user_gelu``, ``user_gelu_grad`` and
   the three B5 kernels 12 times; its step p50 is printed beside 4b's.
4e. ``CustomOp``: ``tests/test_custom_op.py``'s net, FC(8) →
   ``Custom(op_type=...)`` (a sigmoid whose forward and backward are
   written with ``mt.nd`` ops and check that their NDArrays lie on
   ``gpu(0)``) → FC(2) → ``SoftmaxOutput``: its first step must equal
   the ``Activation(sigmoid)`` net's on the same seeded weights (outputs
   and gradients to ``TOL``), then ``Module.fit`` takes 10 epochs with a
   finite, falling loss.
5. LSTM-PTB: the LSTM language model of ``examples/lstm_bucketing.py``
   at the published widths of upstream MXNet's
   ``example/rnn/lstm_bucketing.py`` (vocab 10,000, embed 200, 2 LSTM
   layers of 200, batch 32, buckets 10-60) trains through
   ``mod.BucketingModule.fit`` on ``gpu(0)`` for ``LSTM_EPOCHS`` epochs
   over a seeded synthetic Markov corpus (Adam lr 0.01, ``Uniform(0.08)``,
   zero states through ``arg_params``, ``Perplexity(ignore_label=0)``,
   ``Speedometer``; a CUDA graph a bucket), then ``score``s a held-out
   corpus (an inference graph a bucket).  Every forward,
   in training and in scoring, must launch ``lstm_scan`` once a layer;
   every bucket must have been seen, with the buckets sharing the
   parameter objects; ``rnn_parameters``' gradient must be finite and
   non-zero every batch; the second epoch's perplexity must be below the
   first's.
6. Greedy NMS (``nms``, fp32) at (B, A) = (8, 192), the toy SSD of
   ``examples/ssd.py``'s detection batch, and (32, 8732), SSD300's
   detection batch, with ``force_suppress`` off (the one-launch fused
   path at 192 rows, the suppression mask in a workspace and the sweep
   at 8732) and on (the survivors' kernel), over score-sorted rows made
   on the card (20 classes, boxes clustered so that most rows are
   suppressed): the kernel must ``torch.equal`` its plain version; each
   record carries its path and workspace bytes, and at (8, 192) force
   off also the mask and sweep's time there (``_nms_launch``).  Then at
   its edges (``check_nms_edges``): A = 1, 63, 64, 65 and 257, 319,
   320, 321 with interleaved dead rows, duplicate boxes and a pair whose
   IoU equals the threshold, thresholds 0.45, 0, -0.5, 1 and 1.5, force
   off and on (at A <= 65 force off on both the fused and the mask
   path); whole blocks of dead rows; one 12,000-row image; three SSD300
   images under a budget that holds two images' masks (two groups, one
   launch).  ``nms_resources`` lines give each B7 kernel's registers,
   shared and local memory (``cuobjdump``; none may use local memory).
   No PyTorch call computes greedy NMS, so it has no library time.
7. SSD300: upstream MXNet's ``example/ssd`` SSD300 over VGG16-reduced
   (``models/ssd.py``'s ``ssd300_symbol``) at its published widths:
   300x300 images, 8,732 anchors, 21 classes (PASCAL VOC's 20 +
   background), batch 32, SGD as upstream's ``train.py`` (lr 0.002,
   momentum 0.9, wd 5e-4), ``Xavier()``, 4 epochs, trained through
   ``mod.Module``
   on ``gpu(0)`` with ``forward``/``backward``/``update`` over seeded
   ``synthetic_boxes`` (VOC images are not in the repo).  Every output
   must be finite, the masked class cross-entropy (from ``cls_prob``
   and the ``cls_label`` output) and the localization loss of the last
   epoch below the first's, and training must launch ``nms`` zero
   times.  Then the detection symbol in a second ``Module``, filled by
   ``set_params(*mod.get_params())`` while the training module and its
   graph pool stay alive, detects the first 3 batches: one ``nms`` launch a
   forward, scores sorted, and rows that ``torch.equal`` ``nms_plain``
   of the rows before NMS of the same forward (rebuilt from the
   ``MultiBoxDetection`` inputs it also outputs).  A second module with
   NMS off runs each batch in its own forward; the batches whose rows
   before NMS differ from the detection forward's, and the kernels only
   one of the two ran, are recorded (``raw_forward_apart``).  B7 is also
   timed alone on the first batch's rows (``nms_on_detection_rows``;
   those launches are not counted).
8. Sequence parallelism (``mt.sequence``) on one card, fp32, at the
   GPT-2-class attention width (H = 12, D = 64), over
   ``sequence_mesh(4, ["cuda:0"] * 4)`` (``sequence_path``): every
   earlier path must have launched B8 and B9 0 times; then the ring at
   T = 16,384, causal (10 B8 launches a forward, 10 + 10 B9 a backward)
   and non-causal (16), its output and q/k/v gradients against
   ``blockwise_attention`` (B5); one attention block of the LM (layer
   0's ``qkv_weight`` and ``proj_weight`` of ``gpt2_small_params(0)``
   around the ring), its ``qkv_weight`` gradient against the same block
   through B5; the decode-time layout, a 2,048-row chunk at
   ``q_offset`` 8,000 through the ring (12 B8) and Ulysses (4 B8), and
   the plain Ulysses (4 B5), against the same rows of B5's causal
   forward; the ring's forward and forward + backward times beside
   B5's, and peak memory.  One card shows the kernels and the hop loop:
   each hop's K/V rotation is ``Tensor.to`` onto the same device, no
   transfer between cards.
9. Prints ``{"kernels": [...]}`` (the fifteen built-in kernels, the
   four timed CUDA user kernels and the two Triton ones, launches summed
   over the runs), the card line, and last ``{"ok": true, "device":
   {...}}``, after phases 10 to 17.
10. Image classification (``image_path``; no kernel of the port's own
   on this path: cuDNN's convolutions and eager PyTorch ops, TF32 off as
   everywhere in this script, the ``tf32`` entry of its line), launch
   counts reset just before and read just after, every built-in and
   user kernel 0 times: ``train_mnist.main`` (the port's
   ``examples/train_mnist.py``) on ``gpu(0)`` for LeNet and the MLP at
   its defaults (batch 64, SGD lr 0.05, momentum 0.9, wd 1e-4,
   ``Xavier(gaussian, in, 2)``, 3 epochs of the synthetic 4,096-image
   set), each above ``MNIST_MIN_ACCURACY`` on the 512 validation
   images; ResNet-50's first step at full width, batch 4, against the
   same step by the port on the CPU (outputs and loss within ``TOL``,
   the 157 weight gradients within ``BWD_TOL``, the 102 new moving
   statistics within ``TOL``); the ``train_imagenet.py --benchmark 1``
   path (``resnet_train``: ResNet-50, 3x224x224, 1,000 classes, batch
   32, SGD lr 0.1, momentum 0.9, wd 1e-4, through ``Module.fit`` with a
   ``Speedometer``, 2 epochs of 20 batches; images/s and step p50 of the
   second epoch, peak memory; gates: finite outputs, every moving
   statistic finite and moved, the last 5 batches' cross-entropy below
   the first 5's); ``benchmark_score.score`` of ResNet-50 at batch 1, 8
   and 32 and LeNet at 1 and 32 (images/s); ``Module.predict`` over
   three batches of 8, the last padded, ``torch.equal`` to the trimmed
   ``forward`` outputs.
11. Per-node randomness, Dropout, the rest of the CNN ops and the CNN
   families (``cnn_dropout_path``; fp32, TF32 off), launch counts reset
   just before and summed over its parts just after: (a) the training
   run's LM with ``LM_DROPOUT`` after each attention projection and
   feed-forward (``dropout_lm_path``): one seed set twice gives bitwise
   equal masks over two forwards, two nodes of a step and two steps of
   a node give other masks, each keeps within 6 sigma of 1 - p; 10 SGD
   steps as in 4 (B1 forward and backward 12 times a step, a falling
   loss); the inference forward ``torch.equal`` to the dropout-free
   LM's on the same weights; (b) LSTM-PTB's symbol with
   ``LSTM_DROPOUT`` between its layers, ``LSTM_DROPOUT_BATCHES``
   bucket-60 batches (the fused step's warm-up, capture and a replay):
   2 ``lstm_scan`` launches a batch, finite losses, layer 0's mask new
   every batch and keeping within 6 sigma; (c) AlexNet (BASELINE's
   row: 3x224x224, 1,000 classes, batch 256, ``CNN_TRAIN``) through
   ``train_imagenet.main`` (its Module timing each step), 2 epochs of 20
   batches: images/s and step p50 of the second epoch, peak memory, the
   device time of a step, and of the eager run's by aten op
   (``CNN_OP_CLASSES``); gates: finite outputs, the last 5 batches'
   cross-entropy below the first 5's; (d) AlexNet's first step at batch
   4 on the card against the CPU replaying the card's masks (float32
   outputs and loss within ``TOL``; the same step in float64 on both,
   outputs within ``TOL`` and gradients within ``BWD_TOL``; float32
   gradients within ``BWD_TOL`` except below a ReLU or max-pool decision
   the card's float32 forward takes otherwise); (e)
   Inception-v3 (3x299x299, batch 32) as (c), every moving statistic
   finite and moved; (f) ``benchmark_score.score`` at batch 1 and 32
   of AlexNet, VGG, Inception-BN, Inception-v3 and ResNet-50 with the
   s2d stem; (g) every op of queue A item 2 through ``mt.nd`` on the
   card against the CPU, forward (``TOL``) and gradient (``BWD_TOL``),
   rrelu and ``Dropout`` with their draws injected, and a Dropout of
   2^24 ones keeping within 6 sigma of 1 - p.  Only (a) and (b) launch
   the port's kernels.
12. Checkpoints and resume (``ckpt_path``; fp32, TF32 off), every
   checkpoint under one ``tempfile.mkdtemp()`` directory removed at the
   end, launch counts reset just before and summed over its traced
   parts just after: (a) phase 11's dropout LM (GPT-2-small class, 12 x
   768, vocabulary 32,768, batch 8 x 1024, dropout 0.1, SGD momentum
   0.9) through ``Module.fit`` and the fused step's CUDA graphs: 10
   steps with no manager; the same weights and seed with a
   ``CheckpointManager(every_n_steps=5, async_save=True)``, stopped by
   an exception after step 7; a fresh module under another seed resumes
   with ``fit(resume='auto')`` at step 5 and runs to 10.  Gates: every
   weight and momentum within ``CKPT_TOL`` (``tests/
   test_torch_fused_graphs.py``'s) of the uninterrupted run's, the
   dropout masks of steps 6-10 equal to its masks, ``verify_checkpoint``
   clean.  Records: each tensor's largest difference, bit for bit or
   the first tensor that parts, each run's captures, the async save's
   blocking ms against a synchronous save's, the writer's ms and the
   bytes, the resume's load, restore, first step and warm-up + capture
   ms, the step p50 with the manager and without.  (b) LSTM-PTB (phase
   4's widths, buckets 10-60, Adam) through ``BucketingModule.fit``: 12
   batches, a checkpoint at batch 6, a stop after batch 8, a resume
   from a fresh module: the same gates (Adam's mean and var beside the
   weights) and records.  (c) ResNet-50 through ``train_imagenet.py
   --benchmark 1 --model-prefix``: 1 epoch, whose checkpoint's arrays
   (every BatchNorm moving statistic too) equal the module's bit for
   bit; then ``--load-epoch 1`` for 1 more, which starts at epoch 1 with
   finite outputs.  Only (a) and (b) launch the port's kernels.
13. bf16 and fp16 training and storage (``bf16_path``; TF32 off but in
   (c)'s TF32 run), launch counts reset just before and summed over (a)
   and (b) just after, for bf16 and then fp16: (a) the training run's
   LM built by ``transformer_lm(..., dtype=...)`` (``tok_embed_weight``
   float32, every other parameter in the dtype), its first step against
   the fp32 first step from the same weights (``HALF_FIRST_STEP``: 4 U
   of the dtype, ``HALF_U``), then ``TRAIN_STEPS`` Adam steps
   (``BF16_OPT``, no loss scaling) through ``Module``'s fused step and
   again eagerly from the same weights: a finite, falling loss, the
   graphed steps within the dtype's ``TOL``/``BWD_TOL`` of the eager
   ones, every traced B1 launch of the graphed run the dtype's
   instantiation (``BF16_SUFFIX`` / ``FP16_SUFFIX``), the share of its
   weight elements step 10 changed; (b) the trained LM served by
   ``DecodeEngine`` (``half_serving``, each run a device trace): with
   ``dtype=`` the dtype (run A's requests), over other pages (bf16:
   ``kv_dtype="bf16"``, greedy tokens equal; fp16: int8 codes under
   fp16 queries) and with ``spec_tokens=4``; fp16 also a prefix hit (B8
   over [cached prefix | suffix]): parameters in their dtypes, every
   traced B1 and paged launch the dtype's instantiation, as many as
   prefills and steps times the layers, tokens/s and TTFT; the
   random-weight LM served the same way first (S0 / F0): its greedy
   tokens the full forward's argmax wherever its top-2 margin exceeds
   ``BF16_MARGIN`` U of the row's largest logit, at a quarter of them at
   least (the trained LM's top logits lie within that margin of each
   other: its tokens within it, over int8 pages ``INT8_MARGIN``, of the
   top logit); (c) ResNet-50's first step (batch 4) in fp32, under TF32
   and in bf16 against the port's float64 step on the CPU (recorded:
   ill-conditioned), every op node of the TF32 and bf16 steps alone
   against the same node in float64 on its inputs (``NODE_UNITS``
   roundings), and phase 10's training run (2 epochs of 20 batches,
   batch 32) in bf16 (bound from a bf16 data descriptor) and under TF32,
   each with its eager step by aten op.  The fp16 instantiations of rows
   1-9 are held against their plain versions at the table's shapes
   (``half_kernel_checks``) with the kernel checks.
14. The operator layer (``ops_path``; no kernel of the port launches):
   (a) the GPT-2-class LM with its attention written from ``batch_dot``
   and ``softmax`` (``primitive_lm_symbol``: ``SliceChannel`` of the
   packed qkv, ``SwapAxis``, scalar arithmetic, a causal bias from
   ``arange`` and ``broadcast_greater``), its first step on the training
   run's weights and batch within 1e-4 of the packed LM's loss and
   ``BWD_TOL`` of its qkv gradients, with no B1 or B5 launch; (b)
   ``TRAIN_STEPS`` SGD steps graphed against eager (``lm_train_pair``),
   its eager step by aten op (``bmm``, softmax, the mask add, the dense
   layers, the rest) beside the packed LM's step; (c) every op name the
   port registers beyond ``EARLIER_OPS`` through ``mt.nd`` on the card
   against the CPU (``ops_sweep``: outputs, gradients, bf16, the
   samplers' moments over 2^20 draws; an ``ops_sweep`` line) and a
   sampler node through the fused step's replays (new draws a replay).
15. Core breadth (``core_path``; the packed LM's B1): (a) ccSGD, NAG,
   SGLD, DCASGD, AdaGrad, RMSProp, AdaDelta and Test on the packed LM at
   batch 8 x 1024, each ``CORE_STEPS`` steps (2 warm-ups, a capture, 3
   replays) through the fused step and again eagerly (graphed = eager
   at ``TOL``/``BWD_TOL``, a finite loss, B1 a layer a step; SGLD with
   zero noise for that pair and once more with its noise, N(0, lr)
   within 6 sigma), RMSProp and AdaDelta on the bf16 LM too; (b)
   ``MXNET_BACKWARD_DO_MIRROR=1`` on the packed and the primitive LM:
   the first step's gradients within ``BWD_TOL`` of the plain step's,
   B1's forward twice a layer a step, graphed = eager, step p50 and peak
   memory with and without; (c) a ``Monitor(1, '.*')`` run of the packed
   LM (eager, no capture, every statistic finite, the names of the
   port's CPU run, the loss of an unmonitored eager step); (d)
   ``model.FeedForward`` trains LeNet to ``MNIST_MIN_ACCURACY``; (e)
   the MLP split into a ``SequentialModule`` (its first step equal to
   one ``Module``'s) trains to ``MNIST_MIN_ACCURACY``.  A
   ``core_summary`` line.
16. The prefix cache and chunked prefill (``prefix_path``), at the
   GPT-2-class width, fp32 pages unless said, KVB 16.  B8 first, at the
   suffix prefill's shapes (``SUFFIX_SHAPES``: one stream, its two
   launches: the gathered table's pages under the key limit ``start``,
   then the raw suffix causal) against its plain version, timed beside
   SDPA and its bound.  The suffix prefills below run as graphed
   ``("prefix_prefill", tp, mb)`` executables.  Then, each run's launch
   counts reset just before its traffic: (a) a 512-token system prompt
   served alone, then 15 requests of it plus distinct 16-400-token
   suffixes (two at temperature 0.8), 32 tokens each, with the cache on
   and off: 15 hits of 512 tokens, 15 x 512 fewer prefill tokens, B1 12
   times a miss, B8 24 times a hit's suffix prefill, the decode kernel
   12 times a step, the full forward over both runs' greedy streams;
   (b) the system prompt alone again: a full hit, one copy-on-write of
   its tail page (whose bytes stay as they were), no prefill launch;
   (c) a 48-page pool against six streams of a shared prompt: evictions
   of parked pages, preemptions of streams holding shared pages, every
   page back at the end; (d) four 900-token prompts and one of 960
   (above the engine's largest prefill bucket, 512) in chunks of 256
   beside 8 short streams already decoding: the chunk count, B8 24
   times a chunk, the full forward; the same with the cache off (the
   greedy chains equal up to a near-tie, where batch shapes round
   either way) and unchunked (the short streams' cost of the stall);
   (e) (a)'s traffic over int8 pages (B8 and the quantized decode
   kernel; the first greedy tokens (a)'s wherever the fp32 forward's
   top-2 margin exceeds ``QMARGIN``) and ``spec_tokens=4`` on
   ``spec_prompts()`` with the cache and chunks of 256 (run B's launch
   rule, chunks on B8).  A ``prefix_summary`` line.  Serving runs A-D,
   the default LM's and phase 13's state that their random prompts
   scored no hit (``serve_run``).
17. Multi-tenant serving and the draft-LM proposer (``tenancy_path``),
   at the GPT-2-class width, fp32 pages unless said, KVB 16, seeded
   LoRA adapters of ranks 8, 8, 16 and 16 (``tenancy_adapters``) in an
   ``AdapterPool`` of rank buckets (8, 16) and 4 slots a bucket: (a) 20
   requests of 64-256-token prompts, 4 per adapter and 4 plain, 32
   tokens each, two sampled: each adapter's greedy streams held by
   ``forward_check`` against the merged-weights model ``W + (A B)^T``,
   the plain ones against the base; the same prompts without adapters
   through an adapter-enabled engine and a pre-adapter engine equal bit
   for bit; B1 12 times a miss, the decode kernel 12 times a step; step
   p50 with adapters and without; (b) a 256-token system prompt with
   new suffixes, plain, under adapter X, plain, under X, then X retired
   and republished with other weights: hits only within a salt, none on
   X's old chain, B8 24 times a hit's suffix prefill, each stream held
   against its own model; (c) six rank-8 adapters published into bucket
   8's 4 slots while 8 streams decode, one retired mid-run: nothing
   shed, evictions of parked slots only (a held slot's rows keep their
   bytes), every refcount 0 and every slot free at the end; (d) one
   decode seat and a quota of two requests: a tenant's third request
   shed with ``QuotaExceededError`` and its counters; an interactive
   request admitted before two batch ones submitted ahead of it; (e)
   ``spec_tokens=4`` on ``spec_prompts()`` (greedy) with the target's
   own weights as the draft LM, with a 2-layer draft cut from them
   (fp32 pages) and with the n-gram proposer: run B's launch
   rule, B1 also ``layers`` times a draft forward, ``forward_check``
   (over int8 pages: every token's logit within ``INT8_MARGIN`` of the
   row's largest of the top one), the self-draft accepting above 0.9.
   A ``tenancy_summary`` line.
18. The engine's executables as CUDA graphs (``graphs_path``), at the
   GPT-2-class width, KVB 16: (a) run A's traffic, (b) run B's
   (``spec_tokens=4``: the verify executables), (c) run A's over int8
   pages and (d) phase 17 (a)'s mixed adapter batch, each through a
   graphed engine and one with ``_graphs=False`` (the same executables
   uncaptured): every token equal, one capture an executable; the
   graphed (b) and (c) are device traces (B1 12 a prefill, the paged
   kernel 12 a step, verify steps included); (e) the pipelined fetch:
   one prompt alone saves device-to-host syncs, its tokens those of an
   engine that cannot pipeline; (f) ``warmup()`` of (a)'s
   graphed engine builds and captures every prefill,
   decode and verify bucket and every suffix-prefill (tp, mb) bucket
   once (the JAX engine's keys), and the traffic after it builds none; (g) a 712-token
   miss's host and kernel ms graphed and eager; (h) ``swap_params`` mid-
   serve: the same weights change no chain and build nothing, other
   weights make the next chains a fresh engine's over them, a swap
   missing a name or of a wrong shape raises and installs nothing;
   ``get_params`` gives the new weights.  A ``graphs_summary`` line.
19. B8's key limit, the serving symbols, the graphed suffix prefill and
   ``InferenceEngine`` (``infer_path``): (a) B8 with its per-row key
   limit (``kv_len`` in the card's memory) against its plain version in
   fp32, bf16 and fp16 at the suffix shapes (both launches, and the
   merged rows against the plain body), at a decode row over a
   contiguous cache (16 streams of up to 1,024 keys, one padded) and at
   the limit's edges (0, 1, 63, 64, 65, a page, all keys, past them),
   causal and not, timed beside SDPA under the same mask and the bound;
   (b) the serving symbols at the GPT-2-class width bound with
   ``simple_bind`` over fp32 and int8 pools: a 200-token prefill, 16
   decode steps, a verify window of 5, a 64-token suffix prefill over
   256 cached tokens and (fp32) a contiguous-cache decode, a device
   trace of their launches, the logits against ``TransformerLM``'s same
   calls within ``TOL``; (c) phase 16's (a) and (d) traffic graphed and
   with ``_graphs=False``, tokens equal, and a 200-token suffix over the
   512-token system prompt's host and kernel ms both ways; (d)
   ``InferenceEngine`` on ResNet-50 from ``Predictor.from_checkpoint``
   of a ``Module.save_checkpoint`` (8 client threads, 256 requests of
   1-4 images, buckets 1/4/16/32): rows against ``Module.predict``, each
   bucket graphed against eager bit for bit, one capture a bucket; (e)
   ``InferenceEngine`` on the packed LM scoring 128-token sequences
   (buckets 1/4/8): B1 12 a batch in a device trace, rows against
   ``Module.predict``.  An ``infer_summary`` line.

The fused step.  Every ``Module`` training path above and below (the
packed, DPA, GELU and dropout LMs, LSTM-PTB, SSD300, phases 10 and 11)
trains through the port's fused step, its default: after
two eager warm-up steps the step of each input shape is a CUDA
graph (forward, backward and one optimizer segment), and so is each
module's ``forward(is_train=False)`` (scoring, detection, predict).
Each such path prints a ``fused_step`` line: whether it runs as graphs
(or the ops that keep it uncaptured: the ``CustomOp`` net's ``Custom``),
the graphs held, captures, capture ms and the pool bytes they added,
beside its step p50 and, from this run, the step p50 of the same path
under ``MXNET_FUSED_STEP=0`` (the eager path), and records the device
time of a step both ways (``step_device_ms``: the kernels' time from
``torch.profiler``, graph replays included, and the CUDA events' span);
ResNet-50, AlexNet and Inception-v3 split the eager step by aten op,
LSTM-PTB's eager batch by part.  The graphed steps of the packed, DPA
and GELU LMs must match the eager steps from the same parameters (each
step's loss within ``TOL``, the weights after the last within
``BWD_TOL``); per-step launch counts are the same both ways.  A
replay runs no wrapper, so wherever a CUDA graph may replay (the
graphed training runs, the example's fit, LSTM-PTB's scoring, SSD300's
detection, phase 11's parts) the launches are read from a
``torch.profiler`` trace of the device (``TracedLaunches``: each kernel
counted by its device function) and must equal what the wrappers
counted (a replay adds the launches its capture recorded); the kernels
line's launches are those traces' counts there.  The dropout LM's and
the dropout LSTM's replayed steps draw new masks every step
(``ReplayMasks``); scoring is timed both ways (``score_pair``).

``python3 chip_smoke.py --decode-timing ROOT`` times only the decode
kernel of the port under ROOT (see ``decode_timing``); ``--paths ROOT``
the tensor-core kernels (B1's forward and backward, B5's forward with
its backward, B9) in fp32 and bf16, the paged kernels
(``paged_timing``), B6 at (60, 32, 200) and the float64 check, then
serving runs A, B and C, the packed LM's and the DPA LM's training,
the sequence phase, LSTM-PTB, SSD300 (its step and detection forward),
ResNet-50's, AlexNet's and Inception-v3's training runs and
``benchmark_score`` of ResNet-50 at batch 1, 8 and 32 there (the
training paths without their eager runs: parent against change is the
comparison), ``--kernels ROOT`` the kernels
alone, ``--nms ROOT`` B7 alone, ``--image ROOT`` phase 10 alone,
``--cnn ROOT`` phase 11 alone, ``--ckpt ROOT`` phase 12 alone,
``--bf16 ROOT`` phase 13 alone after the bf16 and fp16 checks of rows
1-9 at the table's shapes, ``--ops ROOT`` phase 14 alone with the packed
LM's training run beside it, ``--core ROOT`` phase 15 alone,
``--prefix ROOT`` phase 16 alone, ``--tenancy ROOT`` phase 17 alone,
``--graphs ROOT`` phase 18 alone, ``--infer ROOT`` phase 19 alone (see
``paths_timing``);
``--eager-step ROOT`` ResNet-50's step on the eager path, by part
(``eager_step_timing``).

Float32 matmuls run in full float32: TF32 is off for matmuls and cuDNN (but in
phase 13's TF32 run).  Any failed check raises and the script exits non-zero
without the last line.  It needs a CUDA card and the repository around it.
"""

import concurrent.futures
import contextlib
import hashlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM published peaks, dense (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
# the tensor-core kernels' own ceiling: fp32 products as split TF32, three
# TF32 products at 495 TFLOP/s each; bf16 and fp16 at their tensor-core
# rate
PEAK_TC_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12,
                 "float16": 989e12}
# fp16's tolerances are bf16's scaled by the two formats' unit roundoff
# (2^-11 against 2^-8: 11 significand bits against 8)
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2 / 8}
# the backward's tolerance scales with its largest reference value:
# fp32 BWD_TOL * max(1, max|ref|), bf16 and fp16 BWD_TOL * max|ref|
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 1e-2 / 8}
# the attention kernels' 16-bit dtypes, and their dtype codes
HALF_DTYPES = ("bfloat16", "float16")
DTYPE_CODE = {"float32": 0, "bfloat16": 1, "float16": 2}
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, 10, 3e-5
SPEC_K, SPEC_NEW = 4, 64
LSTM_PTB = dict(vocab=10000, num_embed=200, num_hidden=200, num_layers=2,
                batch=32, buckets=(10, 20, 30, 40, 50, 60))
LSTM_EPOCHS, LSTM_TRAIN_SENTENCES, LSTM_HELD_OUT_SENTENCES = 2, 1800, 480
# the eager runs (MXNET_FUSED_STEP=0) beside the fused ones: one epoch
# of LSTM-PTB, SSD300 and the image runs
EAGER_EPOCHS = 1
# lstm_scan checks (T, B, H): LSTM-PTB's longest and shortest bucket and an
# odd shape (the cluster-resident design), then two widths whose ut no
# cluster holds (the L2-streaming kernel)
LSTM_SHAPES = ((60, 32, 200), (10, 32, 200), (7, 3, 37), (60, 32, 512),
               (20, 8, 1024))
KV_TORCH = {"int8": "int8", "fp8": "float8_e4m3fn"}
# the paged kernels' libraries: the longest builds (one cluster kernel,
# many instantiations), compiled while the other kernels' checks run
PAGED_SOURCES = ("paged_attention_decode", "paged_attention_decode_quant",
                 "paged_attention_verify")
# nms: SSD300's detection batch (8,732 default boxes; Liu et al., ECCV
# 2016) beside the toy SSD's; 20 classes and the paper's threshold 0.45
NMS_SHAPES = ((8, 192), (32, 8732))
NMS_CLASSES, NMS_THRESHOLD, NMS_FLOPS_PER_PAIR = 20, 0.45, 20
# SSD300 at upstream example/ssd's train.py settings (batch 32, SGD lr
# 0.002, momentum 0.9, wd 5e-4, rescale_grad 1 on one device); the
# synthetic data set, the epochs and the detection pass (its first
# ``detect_batches`` batches, each held against nms_plain) cut to the
# run's time; both losses fall by the fourth epoch
SSD300 = dict(images=256, batch=32, epochs=4, detect_batches=3, lr=0.002,
              momentum=0.9, wd=0.0005)

# image classification: train_imagenet.py --benchmark 1 (ResNet-50 at
# 3x224x224, 1,000 classes, batch 32, SGD lr 0.1, momentum 0.9, wd 1e-4,
# Xavier(gaussian, in, 2)), 2 epochs of 20 batches cycling two seeded
# batches; the first-step check at batch 4; benchmark_score.py's batches
IMAGE = dict(network="resnet-50", image_shape=(3, 224, 224), classes=1000,
             batch=32, lr=0.1, momentum=0.9, wd=1e-4, epochs=2, batches=20,
             check_batch=4, score_batches=(1, 8, 32),
             lenet_score_batches=(1, 32), score_reps=20, predict_batch=8,
             predict_images=20)
MNIST_MIN_ACCURACY = 0.99

# phase 11: GPT-2 small's residual dropout (Radford et al. 2019) on the
# training run's LM; LSTM-PTB's symbol with p = 0.5 between its layers;
# BASELINE's AlexNet (batch 256) and Inception-v3 (batch 32, 3x299x299)
# training rows through train_imagenet.py --benchmark 1 (AlexNet, which
# has no BatchNorm, at lr 0.01, the rate of Krizhevsky et al. 2012); the
# AlexNet first-step check at batch 4; benchmark_score's batches 1 and 32
# of the scoring row's networks and ResNet-50's s2d stem
LM_DROPOUT, LSTM_DROPOUT = 0.1, 0.5
# (b)'s batches: the fused step's two warm-up steps, its capture, a replay
LSTM_DROPOUT_BATCHES = 4
CNN_TRAIN = {
    "alexnet": dict(image_shape=(3, 224, 224), classes=1000, batch=256,
                    lr=0.01, epochs=2, batches=20),
    "inception-v3": dict(image_shape=(3, 299, 299), classes=1000, batch=32,
                         lr=0.1, epochs=2, batches=20)}
ALEXNET_CHECK_BATCH = 4
CNN_SCORE = (("alexnet", (3, 224, 224), {}), ("vgg", (3, 224, 224), {}),
             ("inception-bn", (3, 224, 224), {}),
             ("inception-v3", (3, 299, 299), {}),
             ("resnet-50", (3, 224, 224), {"stem": "s2d"}))
CNN_SCORE_BATCHES = (1, 32)
DROPOUT_MASK_ELEMENTS = 1 << 24

# phase 12: the LM checkpointed every 5 steps, stopped after step 7 and
# resumed at 5; LSTM-PTB checkpointed at batch 6 of 12, stopped after 8;
# tests/test_torch_fused_graphs.py's tolerance; the two runs' seeds
CKPT_EVERY, CKPT_STOP = 5, 7
CKPT_LSTM_BATCHES, CKPT_LSTM_EVERY, CKPT_LSTM_STOP = 12, 6, 8
CKPT_TOL = dict(rtol=1e-4, atol=1e-5)
CKPT_SEEDS = (5, 23)
CKPT_RESNET_BATCHES = 8

# phase 13: bf16.  The training run's LM built in bf16 under Adam at lr
# 3e-4 (bf16 weights of ~0.02 move by steps of ~1.2e-4, which SGD at
# TRAIN_LR never reaches; at 1e-3 the loss rose again after step 7 on
# the H100); its first step against the fp32 first step from the same
# weights within HALF_FIRST_STEP (bf16's unit roundoff U = 2^-8: the
# mean loss and the gradients' norm within 4 U relative, as the errors
# of a few roundings; measured 1.7e-5 and 6.6e-3); serving's greedy
# tokens (of the random-weight LM served in bf16) equal to the full
# forward's argmax wherever its top-2 margin exceeds BF16_MARGIN U of the
# row's largest logit (a few roundings of the logits on each side), at a
# quarter of the tokens at least; the trained LM's within that margin of
# the top logit (its top logits lie within it of each other)
U_BF16 = 2.0 ** -8
BF16_OPT = ("adam", {"learning_rate": 3e-4})
BF16_MARGIN = 8
# fp16 the same way in its own unit roundoff, 2^-11 (11
# significand bits): the fp16 LM's first step within 4 U of fp32's, the
# same Adam run (no loss scaling, as the JAX package has none), serving
# held to BF16_MARGIN U
U_FP16 = 2.0 ** -11
HALF_U = {"bfloat16": U_BF16, "float16": U_FP16}
HALF_TAG = {"bfloat16": "bf16", "float16": "fp16"}
HALF_FIRST_STEP = {dt: {"loss": 4 * u, "grad": 4 * u}
                   for dt, u in HALF_U.items()}
# ResNet-50's first step in TF32 and bf16, node by node against float64
# on the same inputs: within NODE_UNITS roundings of the format in
# relative norm (the unit roundoff: 2^-11 for TF32's 11 significand
# bits, 2^-8 for bf16's 8; one rounding of a result is about half a
# unit in norm, a product of two TF32-rounded operands about one)
ROUNDING_UNIT = {"tf32": 2.0 ** -11, "bf16": 2.0 ** -8, "fp16": 2.0 ** -11}
NODE_UNITS = 4

GPT2_SMALL = dict(vocab_size=32768, num_layers=12, num_heads=12, d_model=768,
                  d_ff=3072, max_len=1024)
H, D, KVB = 12, 64, 16
# transformer_lm at its own defaults (models/transformer.py: 4 layers, 4
# heads, d_model 128, d_ff 4 x 128: head width 32) over an 8,192-token
# vocabulary and 512 positions, batch 4 in training
DEFAULT_LM = dict(vocab_size=8192, num_layers=4, num_heads=4, d_model=128,
                  d_ff=512, max_len=512)
DEFAULT_LM_BATCH = 4
# B1 and the paged kernels at head widths other than 64, (B, T, heads,
# width) of B1's checks: the default LM's training shape, and 128-lane
# heads at the GPT-2-class d_model; the paged kernels at B = 16, MB = 64
WIDTH_CASES = ((DEFAULT_LM_BATCH, 512, 4, 32), (1, 1024, 6, 128))
# flash_mha checks (B, H, Tq, Tk, D, causal): the DPA path's shape first,
# then a tail (T = 1000), Tq < Tk, and head widths 128 and 80
MHA_SHAPES = ((TRAIN_BATCH, H, 1024, 1024, D, True),
              (1, H, 1000, 1000, D, False),
              (2, H, 256, 1024, D, True), (2, H, 256, 1024, D, False),
              (4, 8, 1024, 1024, 128, True), (2, H, 1024, 1024, 80, True))
# B5's forward on a BTHD buffer off 16-byte alignment (element staging)
MHA_OFFSET_SHAPE = (1, H, 1000, 1000, D, True)
# what --paths / --kernels time of B5: the DPA path's shape and D = 128
PATH_MHA_SHAPES = (MHA_SHAPES[0], MHA_SHAPES[4])
# sequence parallelism on one card: a SEQ_SP-shard ring over
# ["cuda:0"] * SEQ_SP at the GPT-2-class attention width and SEQ_T
# positions; the decode-time layout is a SEQ_CHUNK-row chunk of q at
# SEQ_Q_OFFSET into that K/V
SEQ_SP, SEQ_T, SEQ_CHUNK, SEQ_Q_OFFSET = 4, 16384, 2048, 8000
SEQ_KERNELS = ("flash_attention_partial", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
# B8/B9 checks (B, H, Tq, Tk, D, causal, kv_offset): a ring hop of the
# path (T = 16384 over 4 shards) on the diagonal, in the past (nothing
# masked), with a positive offset that masks the first 1024 rows, and
# non-causal; the Ulysses decode hop (3 heads a device); a tail (T =
# 1000), the same with every row masked, head widths 128 and 80, and an
# odd width (37: rows off 16-byte alignment, staged one element a thread)
PARTIAL_SHAPES = ((1, H, 4096, 4096, D, True, 0),
                  (1, H, 4096, 4096, D, True, -4096),
                  (1, H, 4096, 4096, D, True, 1024),
                  (1, H, 4096, 4096, D, False, 0),
                  (1, 3, 2048, 16384, D, True, -8000),
                  (1, H, 1000, 1000, D, True, 40),
                  (1, H, 1000, 1000, D, True, 1200),
                  (1, 8, 1024, 1024, 128, True, 0),
                  (1, H, 1024, 1024, 80, True, 256),
                  (1, 4, 520, 300, 37, True, -100))
# B8 launches of one ring call at T = SEQ_T (causal: shard i attends
# shards 0..i, 1 + 2 + 3 + 4; full: every shard every hop) and of the
# decode layout (ring: 3 of 4 blocks a shard; Ulysses: one a device)
SEQ_LAUNCHES = {"causal": 10, "full": 16, "decode_ring": 12,
                "decode_ulysses": 4}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def back_to_back_ms(torch, fn, reps=20, warmup=3):
    """Mean device time of ``reps`` launches queued back to back between
    two CUDA events: when the host queues faster than the card runs, the
    host's launch overhead is hidden, which ``time_ms``'s event pair
    around each single call includes."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(torch, fn, reps=20):
    """Device time of one call: ``reps`` calls captured in a CUDA graph
    (the host's work per call is done at capture), the graph replayed
    between two CUDA events, median of 5 replays over ``reps``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    del graph
    return float(np.median(ts))


def time_ms(torch, fn, reps=20, warmup=3):
    """Median of ``reps`` launches, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_tc(nbytes, flops, dtype):
    """The second bound of the tensor-core kernels (``PEAK_TC_FLOPS``)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_TC_FLOPS[dtype]) * 1e3


# the tensor-core kernels: library, kernel names, head-width buckets
# instantiated, and the library's dynamic shared-memory query with the
# arguments it takes for (kernel, bucket, dtype code)
def _which(kernel):
    return int(kernel.endswith("dkv_kernel"))


TC_KERNELS = (
    ("flash_mha_packed", ("mhap_fwd_kernel",), (32, 64, 96, 128),
     "flash_mha_packed_smem_bytes", lambda k, dp, code: (dp, code)),
    ("flash_mha_packed_bwd", ("mhap_bwd_dq_kernel", "mhap_bwd_dkv_kernel"),
     (32, 64, 96, 128), "flash_mha_packed_bwd_smem_bytes",
     lambda k, dp, code: (_which(k), dp, code)),
    ("flash_mha", ("mha_fwd_kernel",), (32, 64, 96, 128),
     "flash_mha_smem_bytes", lambda k, dp, code: (dp, code)),
    ("flash_mha_bwd", ("mha_bwd_dq_kernel", "mha_bwd_dkv_kernel"),
     (32, 64, 96, 128), "flash_mha_bwd_smem_bytes",
     lambda k, dp, code: (_which(k), dp, code)),
    ("flash_attention_partial", ("partial_fwd_kernel",), (32, 64, 96, 128),
     "flash_attention_partial_smem_bytes", lambda k, dp, code: (dp, code)),
    ("flash_attention_partial_bwd",
     ("partial_bwd_dq_kernel", "partial_bwd_dkv_kernel"), (32, 64, 96, 128),
     "flash_attention_bwd_smem_bytes",
     lambda k, dp, code: (_which(k), dp, code)))


def _cuobjdump(_build, args, lib):
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    check(os.path.isfile(tool), f"cuobjdump not found beside nvcc ({tool})")
    return subprocess.run([tool, *args, str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def tensor_core_report(_build):
    """Registers, shared and local memory of every instantiation of the
    tensor-core kernels (``TC_KERNELS``: B1's forward and backward, B5's
    forward and backward, B8, both B9 kernels; ``cuobjdump -res-usage``,
    dynamic shared memory from each library's own query), and the tensor-core
    instructions in each one's SASS (``cuobjdump -sass``).  Raises when a
    tool is missing, an instantiation is missing, one holds no HMMA or
    HGMMA, or one at D = 64 uses local memory."""
    import ctypes
    import re

    names = "|".join(k for spec in TC_KERNELS for k in spec[1])
    name_re = re.compile(rf"\d({names})I(f|13__nv_bfloat16|6__half)"
                         r"(?:Li(\d+)E)?E")
    mangled = {"f": "float32", "13__nv_bfloat16": "bfloat16",
               "6__half": "float16"}
    out = []
    for lib, kernels, dps, query, query_args in TC_KERNELS:
        path = _build._target(lib)
        res = _cuobjdump(_build, ["-res-usage"], path)
        sass = _cuobjdump(_build, ["-sass"], path)
        mma = {}
        for part in re.split(r"\n\s*Function : ", sass)[1:]:
            fn, body = part.split("\n", 1)
            mma[fn.strip()] = (len(re.findall(r"\bHMMA\.", body)),
                               len(re.findall(r"\bHGMMA\.", body)))
        smem = getattr(_build.library(lib), query)
        smem.argtypes = [ctypes.c_int] * len(query_args("", 64, 0))
        smem.restype = ctypes.c_int
        seen = set()
        for fn, regs, stack, shared, local in re.findall(
                r"Function (\S+?):\s+REG:(\d+) STACK:(\d+) SHARED:(\d+) "
                r"LOCAL:(\d+)", res):
            mt_ = name_re.search(fn)
            if mt_ is None:
                continue
            kernel, ty, dp = mt_.group(1), mt_.group(2), mt_.group(3)
            dtype = mangled[ty]
            dp = int(dp or 64)
            dyn = smem(*query_args(kernel, dp, DTYPE_CODE[dtype]))
            hmma, hgmma = mma.get(fn, (0, 0))
            rec = {"kernel": kernel, "dtype": dtype, "head_dim_bucket": dp,
                   "registers": int(regs), "stack_bytes": int(stack),
                   "static_shared_bytes": int(shared),
                   "dynamic_shared_bytes": int(dyn),
                   "local_bytes": int(local), "hmma": hmma, "hgmma": hgmma}
            check(hmma + hgmma > 0, f"{kernel} {dtype} D<={dp}: no "
                  f"tensor-core instruction in its SASS")
            check(dp != 64 or int(local) == 0,
                  f"{kernel} {dtype} D<={dp}: {local} bytes of local memory")
            seen.add((kernel, dtype, dp))
            out.append(rec)
        want = {(k, d, p) for k in kernels for d in DTYPE_CODE
                for p in dps}
        check(want <= seen, f"{lib}: instantiations missing from "
              f"cuobjdump's report: {sorted(want - seen)}")
    return out


def check_prefill(torch, ck, F, T, dtype, B=1, offset=0, H=H, D=D):
    """B1's forward against its plain version at H heads of width D;
    ``offset`` > 0 starts qkv that many elements into its buffer, off
    16-byte alignment, which the kernel stages one element a thread."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(B * 10000 + T)
    n = B * T * 3 * H * D
    qkv = torch.randn(n + offset, generator=g, device="cuda").to(dt)[
        offset:].view(B, T, 3 * H * D)
    o, lse = ck.flash_mha_packed(qkv, H, causal=True)
    po, plse = ck.flash_mha_packed_plain(qkv, H, causal=True)
    torch.cuda.synchronize()
    err = (o.float() - po.float()).abs().max().item()
    lse_err = (lse - plse).abs().max().item()
    check(err <= TOL[dtype] and lse_err <= TOL["float32"] * 10,
          f"flash_mha_packed B={B} T={T} {dtype}: max_abs_err {err} (lse "
          f"{lse_err}) over tolerance {TOL[dtype]}")
    check(bool(torch.isfinite(o.float()).all()), "prefill output not finite")
    # SDPA, the yardstick, faults on the misaligned view: it reads an
    # aligned copy of the same values
    q, k, v = (x.unflatten(-1, (H, D)).transpose(1, 2)
               for x in (qkv.clone() if offset else qkv).split(H * D, dim=-1))
    es = qkv.element_size()
    nbytes = B * (T * 3 * H * D * es + T * H * D * es + T * H * 4)
    flops = 4 * B * H * D * T * (T + 1) // 2
    b_ms, b_by = bound(nbytes, flops, dtype)
    return {
        "kernel": "flash_mha_packed", "shape": f"B={B} T={T} H={H} D={D} "
        f"causal" + (f" offset={offset}" if offset else ""), "dtype": dtype,
        "max_abs_err": err, "tol": TOL[dtype],
        "ms": time_ms(torch, lambda: ck.flash_mha_packed(qkv, H, True)),
        "back_to_back_ms": back_to_back_ms(
            torch, lambda: ck.flash_mha_packed(qkv, H, True)),
        "plain_ms": time_ms(torch, lambda: ck.flash_mha_packed_plain(
            qkv, H, True), reps=5, warmup=1),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_tc_ms": bound_tc(nbytes, flops, dtype)}


def check_backward(torch, ck, F, B, T, dtype, offset=0, H=H, D=D):
    """Both backward kernels against the plain backward, at B x T,
    causal.  One record per kernel: its error over the thirds of dqkv
    it writes, its own time and bounds; the plain version and the
    library call (SDPA's backward) compute dq, dk and dv together, so
    both records carry their one time.  ``offset`` > 0 starts qkv that
    many elements into its buffer, off 16-byte alignment, which the
    kernels stage one element a thread.  H heads of width D."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(B * 10000 + T)
    n = B * T * 3 * H * D
    qkv = torch.randn(n + offset, generator=g, device="cuda").to(dt)[
        offset:].view(B, T, 3 * H * D)
    do = torch.randn((B, T, H * D), generator=g, device="cuda").to(dt)
    o, lse = ck.flash_mha_packed(qkv, H, causal=True)
    got = ck.flash_mha_packed_bwd(qkv, o, lse, do, H, causal=True)
    ref = ck.flash_mha_packed_bwd_plain(qkv, o, lse, do, H, causal=True)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), "backward not finite")
    diff = (got.float() - ref.float()).abs()
    peak = ref.float().abs().max().item()
    tol = BWD_TOL[dtype] * (max(1.0, peak) if dtype == "float32" else peak)
    plain_ms = time_ms(torch, lambda: ck.flash_mha_packed_bwd_plain(
        qkv, o, lse, do, H, causal=True), reps=5, warmup=1)
    # SDPA reads an aligned copy of a misaligned qkv (it faults on one)
    q, k, v = (x.unflatten(-1, (H, D)).transpose(1, 2).detach()
               .requires_grad_() for x in
               (qkv.clone() if offset else qkv).split(H * D, dim=-1))
    sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    do_t = do.unflatten(-1, (H, D)).transpose(1, 2)
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa, (q, k, v), do_t, retain_graph=True))
    es = qkv.element_size()
    pairs = B * H * T * (T + 1) // 2
    # every kernel reads q, k, v, o, do (5 thirds' worth) and lse
    reads = 5 * B * T * H * D * es + B * T * H * 4
    out = []
    for part, lanes, writes, flop_per_pair in (
            ("dq", slice(0, H * D), 1, 6 * D),
            ("dkv", slice(H * D, 3 * H * D), 2, 8 * D)):
        err = diff[..., lanes].max().item()
        check(err <= tol, f"flash_mha_packed_bwd_{part} B={B} T={T} "
              f"{dtype}: max_abs_err {err} over tolerance {tol}")
        buf = torch.empty_like(qkv)
        b_ms, b_by = bound(reads + writes * B * T * H * D * es,
                           flop_per_pair * pairs, dtype)
        out.append({
            "kernel": f"flash_mha_packed_bwd_{part}",
            "shape": f"B={B} T={T} H={H} D={D} causal"
            + (f" offset={offset}" if offset else ""), "dtype": dtype,
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(torch, lambda: ck.launch_flash_mha_packed_bwd(
                part, qkv, o, lse, do, buf, H, True)),
            "back_to_back_ms": back_to_back_ms(
                torch, lambda: ck.launch_flash_mha_packed_bwd(
                    part, qkv, o, lse, do, buf, H, True)),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_tc_ms": bound_tc(reads + writes * B * T * H * D * es,
                                    flop_per_pair * pairs, dtype)})
    return out


def mha_pairs(B, H, Tq, Tk, causal):
    """The (query, key) pairs attention scores: under the causal mask
    aligned at position 0, row q sees min(q + 1, Tk) keys."""
    if not causal:
        return B * H * Tq * Tk
    n = min(Tq, Tk)
    return B * H * (n * (n + 1) // 2 + (Tq - n) * Tk)


def check_mha(torch, ck, F, B, Hh, Tq, Tk, Dh, causal, dtype, offset=0):
    """B5 forward and both backward kernels against their plain versions
    on (B, H, T, D) views of BTHD tensors (the layout DotProductAttention
    hands them).  One record per kernel (the forward's also with its
    tensor-core bound); the backward's plain version and library call
    (SDPA's backward) compute dq, dk and dv together, so both backward
    records carry their one time.  ``offset`` > 0 starts each BTHD
    buffer that many elements in, off 16-byte alignment, which the
    forward kernel stages one element a thread."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(B * 1000 + Tq + Dh)
    q, k, v, do = (torch.randn(B * T * Hh * Dh + offset, generator=g,
                               device="cuda").to(dt)[offset:]
                   .view(B, T, Hh, Dh).transpose(1, 2)
                   for T in (Tq, Tk, Tk, Tq))
    # SDPA reads aligned copies of misaligned views (it faults on them)
    qy, ky, vy, doy = (x.clone() if offset else x for x in (q, k, v, do))
    o, lse = ck.flash_mha(q, k, v, causal)
    po, plse = ck.flash_mha_plain(q, k, v, causal)
    torch.cuda.synchronize()
    err = (o.float() - po.float()).abs().max().item()
    lse_err = (lse - plse).abs().max().item()
    shape = (f"B={B} H={Hh} Tq={Tq} Tk={Tk} D={Dh} "
             + ("causal" if causal else "full")
             + (f" offset={offset}" if offset else ""))
    check(err <= TOL[dtype] and lse_err <= TOL["float32"] * 10,
          f"flash_mha {shape} {dtype}: max_abs_err {err} (lse {lse_err}) "
          f"over tolerance {TOL[dtype]}")
    check(o.stride() == q.stride(), "flash_mha: o not in q's layout")
    got = ck.flash_mha_bwd(q, k, v, o, lse, do, causal)
    ref = ck.flash_mha_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    es = q.element_size()
    pairs = mha_pairs(B, Hh, Tq, Tk, causal)
    rows_q, rows_k = B * Hh * Tq * Dh, B * Hh * Tk * Dh
    fwd_bytes = (2 * rows_q + 2 * rows_k) * es + B * Hh * Tq * 4
    b_ms, b_by = bound(fwd_bytes, 4 * Dh * pairs, dtype)
    out = [{
        "kernel": "flash_mha", "shape": shape, "dtype": dtype,
        "max_abs_err": err, "tol": TOL[dtype],
        "ms": time_ms(torch, lambda: ck.flash_mha(q, k, v, causal)),
        "back_to_back_ms": back_to_back_ms(
            torch, lambda: ck.flash_mha(q, k, v, causal)),
        "plain_ms": time_ms(torch, lambda: ck.flash_mha_plain(
            q, k, v, causal), reps=5, warmup=1),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qy, ky, vy, is_causal=causal)),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_tc_ms": bound_tc(fwd_bytes, 4 * Dh * pairs, dtype)}]
    plain_ms = time_ms(torch, lambda: ck.flash_mha_bwd_plain(
        q, k, v, o, lse, do, causal), reps=5, warmup=1)
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qy, ky, vy))
    sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa, (qg, kg, vg), doy, retain_graph=True))
    delta = (do.float() * o.float()).sum(-1).contiguous()
    # every backward kernel reads q, k, v, do, lse and Delta
    reads = (2 * rows_q + 2 * rows_k) * es + 2 * B * Hh * Tq * 4
    for part, grads, writes, flop_per_pair in (
            ("dq", got[:1], rows_q, 6 * Dh),
            ("dkv", got[1:], 2 * rows_k, 8 * Dh)):
        refs = ref[:1] if part == "dq" else ref[1:]
        peak = max(r.float().abs().max().item() for r in refs)
        tol = BWD_TOL[dtype] * (max(1.0, peak) if dtype == "float32"
                                else peak)
        gerr = max((a.float() - r.float()).abs().max().item()
                   for a, r in zip(grads, refs))
        check(all(bool(torch.isfinite(a.float()).all()) for a in grads),
              f"flash_mha_bwd_{part} {shape} {dtype}: not finite")
        check(gerr <= tol, f"flash_mha_bwd_{part} {shape} {dtype}: "
              f"max_abs_err {gerr} over tolerance {tol}")
        bufs = tuple(torch.empty_like(a) for a in grads)
        b_ms, b_by = bound(reads + writes * es, flop_per_pair * pairs, dtype)
        out.append({
            "kernel": f"flash_mha_bwd_{part}", "shape": shape,
            "dtype": dtype, "max_abs_err": gerr, "tol": tol,
            "ms": time_ms(torch, lambda: ck.launch_flash_mha_bwd(
                part, q, k, v, do, lse, delta, bufs, causal)),
            "back_to_back_ms": back_to_back_ms(
                torch, lambda: ck.launch_flash_mha_bwd(
                    part, q, k, v, do, lse, delta, bufs, causal)),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_tc_ms": bound_tc(reads + writes * es,
                                    flop_per_pair * pairs, dtype)})
    return out


def float64_check(torch, ck):
    """B1's forward and backward and B5's forward and backward at the
    LM's attention shape (8, 12, 1024, 64), causal, fp32, on one set of
    inputs (B5 on the BTHD views of B1's packed qkv), against their plain
    versions' formulas run in float64 on the card (the backward's from
    the kernel forward's own o and lse), beside the fp32 plain versions
    themselves.  For each output: the max error over the check's
    tolerance (``TOL``; lse 10 x; ``BWD_TOL`` x max(1, peak)) and the
    mean signed error (output - float64), and B1's gradients against
    B5's over the same tolerance: the two paths the DPA LM's first step
    holds against each other."""
    import math

    B, T = TRAIN_BATCH, 1024
    g = torch.Generator(device="cuda").manual_seed(64)
    qkv = torch.randn((B, T, 3 * H * D), generator=g, device="cuda")
    do = torch.randn((B, T, H * D), generator=g, device="cuda")

    def heads(x):  # (B, T, H*D) -> a (B, H, T, D) view
        return x.unflatten(-1, (H, D)).transpose(1, 2)

    q, k, v = (heads(x) for x in qkv.split(H * D, dim=-1))
    dob = heads(do)
    scale = 1.0 / math.sqrt(D)
    keep = torch.ones(T, T, dtype=torch.bool, device="cuda").tril()

    def scores64(q, k):
        return (q.double() @ k.double().transpose(-1, -2)) * scale

    s = scores64(q, k).masked_fill(~keep, -math.inf)
    lse64 = torch.logsumexp(s, -1)
    o64 = torch.exp(s - lse64[..., None]) @ v.double()
    del s

    def bwd64(o, lse):
        p = torch.exp(scores64(q, k) - lse.double()[..., None])
        p = p.masked_fill(~keep, 0.0)
        delta = (dob.double() * o.double()).sum(-1, keepdim=True)
        ds = p * (dob.double() @ v.double().transpose(-1, -2) - delta)
        return (ds @ k.double() * scale,
                ds.transpose(-1, -2) @ q.double() * scale,
                p.transpose(-1, -2) @ dob.double())

    def stats(got, ref, tol):
        err = got.double() - ref
        return {"err_over_tol": err.abs().max().item() / tol,
                "mean_signed_err": err.mean().item()}

    def bwd_tol(ref):
        return BWD_TOL["float32"] * max(1.0, ref.abs().max().item())

    out = []
    o1, lse1 = ck.flash_mha_packed(qkv, H, causal=True)
    po1, plse1 = ck.flash_mha_packed_plain(qkv, H, causal=True)
    o5, lse5 = ck.flash_mha(q, k, v, True)
    po5, plse5 = ck.flash_mha_plain(q, k, v, True)
    for name, o, lse, po, plse in (
            ("flash_mha_packed", heads(o1), lse1.transpose(1, 2),
             heads(po1), plse1.transpose(1, 2)),
            ("flash_mha", o5, lse5, po5, plse5)):
        for part, got, plain, ref, tol in (
                ("o", o, po, o64, TOL["float32"]),
                ("lse", lse, plse, lse64, 10 * TOL["float32"])):
            out.append({"kernel": name, "output": part,
                        "kernel_vs_float64": stats(got, ref, tol),
                        "plain_vs_float64": stats(plain, ref, tol)})
    d1 = ck.flash_mha_packed_bwd(qkv, o1, lse1, do, H, causal=True)
    pd1 = ck.flash_mha_packed_bwd_plain(qkv, o1, lse1, do, H, causal=True)
    d5 = ck.flash_mha_bwd(q, k, v, o5, lse5, dob, True)
    pd5 = ck.flash_mha_bwd_plain(q, k, v, o5, lse5, dob, True)
    d1 = [heads(x) for x in d1.split(H * D, dim=-1)]
    pd1 = [heads(x) for x in pd1.split(H * D, dim=-1)]
    ref1 = bwd64(heads(o1), lse1.transpose(1, 2))
    ref5 = bwd64(o5, lse5)
    for name, got, plain, ref in (("flash_mha_packed_bwd", d1, pd1, ref1),
                                  ("flash_mha_bwd", d5, pd5, ref5)):
        for part, a, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
            tol = bwd_tol(r)
            rec = {"kernel": name, "output": part,
                   "kernel_vs_float64": stats(a, r, tol),
                   "plain_vs_float64": stats(p, r, tol)}
            if name == "flash_mha_bwd":
                b1 = d1["dq dk dv".split().index(part)]
                rec["b1_vs_b5_err_over_tol"] = (
                    (b1 - a).abs().max().item() / tol)
            out.append(rec)
    torch.cuda.synchronize()
    return out


def partial_pairs(B, H, Tq, Tk, causal, koff):
    """The (query, key) pairs a partial-state call scores: under the
    causal mask row i sees keys j with j + koff <= i."""
    if not causal:
        return B * H * Tq * Tk
    rows = np.clip(np.arange(Tq) - koff + 1, 0, Tk)
    return B * H * int(rows.sum())


def check_partial(torch, ck, F, B, Hh, Tq, Tk, Dh, causal, koff, dtype):
    """B8 and both B9 kernels against their plain versions on BTHD
    tensors (the layout the ring hands them).  m must match the plain
    m's -inf pattern exactly (``torch.equal``) and its finite values to
    1e-4; a row with m = -inf must hold o = 0 and l = 0 exactly; l agrees
    to 1e-5 relative, and o / l (the normalized rows) to ``TOL``, the
    reported error.  The library yardstick is SDPA on the same q, k, v
    with the hop's boolean mask: the same QK^T and PV work, normalized
    (no PyTorch call returns (o, m, l)); for B9, SDPA's backward, dq,
    dk and dv together (the plain version likewise).  B8's record also
    carries its tensor-core bound (``bound_tc_ms``)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(
        B * 1000 + Tq + Dh + abs(koff))
    q, k, v = (torch.randn((B, T, Hh, Dh), generator=g, device="cuda")
               .to(dt) for T in (Tq, Tk, Tk))
    ob = torch.randn((B, Hh, Tq, Dh), generator=g, device="cuda")
    lb = torch.randn((B, Hh, Tq), generator=g, device="cuda")
    o, m, l = ck.flash_attention_partial(q, k, v, causal, 512, koff)
    po, pm, pl = ck.flash_attention_partial_plain(q, k, v, causal, 512, koff)
    torch.cuda.synchronize()
    shape = (f"B={B} H={Hh} Tq={Tq} Tk={Tk} D={Dh} koff={koff} "
             + ("causal" if causal else "full"))
    empty = torch.isinf(pm)
    check(torch.equal(torch.isinf(m), empty) and not bool(
        torch.isnan(m).any() or torch.isnan(o).any() or torch.isnan(l).any()),
          f"flash_attention_partial {shape} {dtype}: the -inf pattern of m "
          f"differs from the plain version's, or a NaN")
    check(bool((m[empty] < 0).all()) and not bool(o[empty].any())
          and not bool(l[empty].any()),
          f"flash_attention_partial {shape} {dtype}: a row that sees no "
          f"key is not m = -inf, l = 0, o = 0")
    seen = ~empty
    m_err = (m[seen] - pm[seen]).abs().max().item() if seen.any() else 0.0
    l_err = ((l[seen] - pl[seen]).abs() / pl[seen]).max().item() \
        if seen.any() else 0.0
    lsafe, plsafe = (x.clamp(min=1e-30)[..., None] for x in (l, pl))
    err = ((o / lsafe) - (po / plsafe)).abs().max().item()
    check(m_err <= 1e-4 and l_err <= 1e-5 and err <= TOL[dtype],
          f"flash_attention_partial {shape} {dtype}: o/l max_abs_err {err} "
          f"(tolerance {TOL[dtype]}), m {m_err}, l relative {l_err}")
    got = ck.flash_attention_bwd(q, k, v, m, ob, lb, causal, 512, koff)
    ref = ck.flash_attention_bwd_plain(q, k, v, m, ob, lb, causal, 512,
                                       koff)
    torch.cuda.synchronize()
    es = q.element_size()
    pairs = partial_pairs(B, Hh, Tq, Tk, causal, koff)
    rows_q, rows_k = B * Hh * Tq * Dh, B * Hh * Tk * Dh
    fwd_bytes = (rows_q + 2 * rows_k) * es + (rows_q + 2 * B * Hh * Tq) * 4
    b_ms, b_by = bound(fwd_bytes, 4 * Dh * pairs, dtype)
    q4, k4, v4 = (x.transpose(1, 2) for x in (q, k, v))
    mask = None
    if causal:
        kpos = torch.arange(Tk, device="cuda") + koff
        mask = kpos[None, :] <= torch.arange(Tq, device="cuda")[:, None]
    out = [{
        "kernel": "flash_attention_partial", "shape": shape, "dtype": dtype,
        "max_abs_err": err, "tol": TOL[dtype], "m_err": m_err,
        "l_rel_err": l_err, "rows_seeing_no_key": int(empty.sum()),
        "ms": time_ms(torch, lambda: ck.flash_attention_partial(
            q, k, v, causal, 512, koff)),
        "back_to_back_ms": back_to_back_ms(
            torch, lambda: ck.flash_attention_partial(
                q, k, v, causal, 512, koff)),
        "plain_ms": time_ms(torch, lambda: ck.flash_attention_partial_plain(
            q, k, v, causal, 512, koff), reps=5, warmup=1),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask)),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_tc_ms": bound_tc(fwd_bytes, 4 * Dh * pairs, dtype)}]
    plain_ms = time_ms(torch, lambda: ck.flash_attention_bwd_plain(
        q, k, v, m, ob, lb, causal, 512, koff), reps=5, warmup=1)
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    sdpa = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    do_t = ob.to(dt)
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa, (qg, kg, vg), do_t, retain_graph=True))
    # every backward kernel reads q, k, v, m, o's and l's cotangents
    reads = (rows_q + 2 * rows_k) * es + (rows_q + 2 * B * Hh * Tq) * 4
    for part, grads, writes, flop_per_pair in (
            ("dq", got[:1], rows_q, 6 * Dh),
            ("dkv", got[1:], 2 * rows_k, 8 * Dh)):
        refs = ref[:1] if part == "dq" else ref[1:]
        peak = max(r.float().abs().max().item() for r in refs)
        tol = BWD_TOL[dtype] * (max(1.0, peak) if dtype == "float32"
                                else peak)
        gerr = max((a.float() - r.float()).abs().max().item()
                   for a, r in zip(grads, refs))
        check(all(bool(torch.isfinite(a.float()).all()) for a in grads),
              f"flash_attention_bwd_{part} {shape} {dtype}: not finite")
        check(gerr <= tol, f"flash_attention_bwd_{part} {shape} {dtype}: "
              f"max_abs_err {gerr} over tolerance {tol}")
        bufs = tuple(torch.empty_like(a) for a in grads)
        b_ms, b_by = bound(reads + writes * es, flop_per_pair * pairs, dtype)
        out.append({
            "kernel": f"flash_attention_bwd_{part}", "shape": shape,
            "dtype": dtype, "max_abs_err": gerr, "tol": tol,
            "ms": time_ms(torch, lambda: ck.launch_flash_attention_bwd(
                part, q, k, v, m, ob, lb, bufs, causal, koff)),
            "back_to_back_ms": back_to_back_ms(
                torch, lambda: ck.launch_flash_attention_bwd(
                    part, q, k, v, m, ob, lb, bufs, causal, koff)),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_tc_ms": bound_tc(reads + writes * es,
                                    flop_per_pair * pairs, dtype)})
    return out


def lstm_design(ck, Hd):
    """The design ``lstm_scan``'s launch takes at hidden size ``Hd``:
    ``cluster8`` / ``cluster16`` (ut resident in a cluster's shared
    memory) or ``streaming`` (ut streamed from L2), from the library's
    own size rule; a port without that rule (before the cluster design)
    launches one block a batch row."""
    import ctypes

    fn = getattr(ck._build.library("lstm_scan"), "lstm_scan_cluster_size",
                 None)
    if fn is None:
        return "one block a row"
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    nc = fn(Hd)
    return f"cluster{nc}" if nc else "streaming"


def check_lstm(torch, ck, T, B, Hd):
    """B6 against its plain version at (T, B, H), fp32, with random
    non-zero states; the library yardstick is cuDNN's LSTM with input
    size 4H, the identity as its input weight, zero biases and
    ``weight_hh = ut.T``: the same function plus one redundant 4H x 4H
    input product (its values are compared too).  The record names the
    design the launch took (``lstm_design``) and both times per step."""
    g = torch.Generator(device="cuda").manual_seed(T * 1000 + B * 10 + Hd)
    xw = torch.randn((T, B, 4 * Hd), generator=g, device="cuda") * 0.5
    h0 = torch.randn((B, Hd), generator=g, device="cuda") * 0.5
    c0 = torch.randn((B, Hd), generator=g, device="cuda") * 0.5
    ut = torch.randn((Hd, 4 * Hd), generator=g, device="cuda") * 0.1
    got = ck.lstm_scan(xw, h0, c0, ut)
    ref = ck.lstm_scan_plain(xw, h0, c0, ut)
    torch.cuda.synchronize()
    errs = {n: (a - b).abs().max().item()
            for n, a, b in zip(("y", "hT", "cT"), got, ref)}
    err = max(errs.values())
    check(err <= TOL["float32"], f"lstm_scan T={T} B={B} H={Hd}: "
          f"max_abs_err {errs} over tolerance {TOL['float32']}")
    check(all(bool(torch.isfinite(x).all()) for x in got),
          "lstm_scan output not finite")

    lib = torch.nn.LSTM(4 * Hd, Hd).cuda()
    with torch.no_grad():
        lib.weight_ih_l0.copy_(torch.eye(4 * Hd, device="cuda"))
        lib.weight_hh_l0.copy_(ut.t())
        lib.bias_ih_l0.zero_()
        lib.bias_hh_l0.zero_()

    def library():
        with torch.no_grad():
            return lib(xw, (h0[None], c0[None]))

    ly, (lh, lc) = library()
    lib_err = max((ly - ref[0]).abs().max().item(),
                  (lh[0] - ref[1]).abs().max().item(),
                  (lc[0] - ref[2]).abs().max().item())
    # each input read once (xw, h0, c0, ut), each output written once
    nbytes = 4 * (T * B * 4 * Hd + 2 * B * Hd + Hd * 4 * Hd
                  + T * B * Hd + 2 * B * Hd)
    b_ms, b_by = bound(nbytes, 2 * T * B * Hd * 4 * Hd, "float32")
    ms = time_ms(torch, lambda: ck.lstm_scan(xw, h0, c0, ut))
    library_ms = time_ms(torch, library)
    return {
        "kernel": "lstm_scan", "shape": f"T={T} B={B} H={Hd}",
        "dtype": "float32", "design": lstm_design(ck, Hd),
        "max_abs_err": err, "max_abs_err_y_hT_cT": errs,
        "tol": TOL["float32"], "ms": ms, "ms_per_step": ms / T,
        "plain_ms": time_ms(torch, lambda: ck.lstm_scan_plain(
            xw, h0, c0, ut), reps=5, warmup=1),
        "library_ms": library_ms, "library_ms_per_step": library_ms / T,
        "library_max_abs_err": lib_err,
        "bound_ms": b_ms, "bound_by": b_by}


def nms_rows(torch, B, A, seed):
    """Score-sorted detection rows (B, A, 6) made on the card: scores
    uniform, sorted descending; classes 0-19, -1 below score 0.01; boxes
    0.10-0.20 wide around A/64 cluster centres, jittered by 0.02, so
    that most rows of a class in a cluster overlap the first."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    score = torch.rand((B, A), generator=g, device=dev).sort(
        dim=1, descending=True).values
    cls = torch.randint(0, NMS_CLASSES, (B, A), generator=g,
                        device=dev).float()
    cls[score < 0.01] = -1.0
    k = max(1, A // 64)
    centres = torch.rand((B, k, 2), generator=g, device=dev) * 0.7 + 0.15
    pick = torch.randint(0, k, (B, A), generator=g, device=dev)
    c = torch.gather(centres, 1, pick[..., None].expand(B, A, 2)) \
        + (torch.rand((B, A, 2), generator=g, device=dev) - 0.5) * 0.04
    half = (torch.rand((B, A, 2), generator=g, device=dev) * 0.1 + 0.1) / 2
    return torch.cat([cls[..., None], score[..., None], c - half, c + half],
                     dim=-1).contiguous()


def nms_tested_pairs(torch, rows, out, thr, force):
    """The (i, j) pairs greedy NMS must test on these rows: for each row
    j live before NMS, every kept row i < j of its class (any class with
    ``force``) up to the first that suppresses it.  One image at a time
    on the card (an A x A IoU matrix)."""
    from mxnet_tpu_torch.ops.detection import _iou_matrix

    total = 0
    for r, o in zip(rows, out):
        A = r.shape[0]
        iou = _iou_matrix(r[:, 2:6], r[:, 2:6])
        idx = torch.arange(A, device=r.device)
        kept = o[:, 0] >= 0
        tested = kept[:, None] & (idx[:, None] < idx[None, :]) \
            & (r[None, :, 0] >= 0)  # [i, j]
        if not force:
            tested &= r[:, None, 0] == r[None, :, 0]
        kills = tested & (iou >= thr)
        first = torch.where(kills.any(0), kills.float().argmax(0), A)
        total += int((tested & (idx[:, None] <= first[None, :])).sum())
        del iou, tested, kills
    return total


def nms_path(ck, B, A, force):
    """Which of B7's paths the wrapper takes for (B, A), and the bytes of
    the workspace it allocates; None where the port under test has no
    workspace (an earlier design)."""
    if not hasattr(ck, "nms_workspace_bytes"):
        return None, None
    if force:
        return "force", 0
    if A <= ck.NMS_FUSED_MAX_ROWS:
        return "fused", 0
    per_image = ck.nms_workspace_bytes(A)
    return "mask+sweep", min(B, ck.NMS_WORKSPACE_BUDGET // per_image) \
        * per_image


def check_nms(torch, ck, B, A, force, seed):
    """B7 against its plain version, bit for bit (``torch.equal``)."""
    rows = nms_rows(torch, B, A, seed)
    got = ck.nms(rows, NMS_THRESHOLD, force)
    ref = ck.nms_plain(rows, NMS_THRESHOLD, force)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"nms B={B} A={A} force={force}: differs "
          f"from nms_plain in {int((got != ref).sum())} entries")
    check(torch.equal(got[..., 1:], rows[..., 1:]), "nms changed a column "
          "other than the class")
    live = rows[..., 0] >= 0
    suppressed = int((live & (got[..., 0] < 0)).sum())
    pairs = nms_tested_pairs(torch, rows, got, NMS_THRESHOLD, force)
    nbytes = 2 * rows.numel() * 4  # rows read once, written once
    b_ms, b_by = bound(nbytes, NMS_FLOPS_PER_PAIR * pairs, "float32")
    all_ms, _ = bound(nbytes, NMS_FLOPS_PER_PAIR * B * A * A, "float32")
    path, ws_bytes = nms_path(ck, B, A, force)
    rec = {
        "kernel": "nms", "shape": f"B={B} A={A} force_suppress={force}",
        "dtype": "float32", "max_abs_err": 0.0, "bitwise": True,
        "path": path, "workspace_bytes": ws_bytes,
        "suppressed_share": suppressed / max(1, int(live.sum())),
        "rounds": A, "live_rounds_max": int((got[..., 0] >= 0).sum(1).max()),
        "tested_pairs": pairs,
        "ms": time_ms(torch, lambda: ck.nms(rows, NMS_THRESHOLD, force)),
        "device_ms": kernel_device_ms(
            torch, lambda: ck.nms(rows, NMS_THRESHOLD, force)),
        # one call (the check above warmed it): the plain sweep takes
        # seconds at SSD300's (32, 8732)
        "plain_ms": time_ms(torch, lambda: ck.nms_plain(
            rows, NMS_THRESHOLD, force), reps=1, warmup=0),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "bound_ms_all_pairs": all_ms}
    if path == "fused":  # the mask and sweep at the same shape, for the choice
        ws = torch.empty(B * ck.nms_workspace_bytes(A), dtype=torch.uint8,
                         device=rows.device)
        check(torch.equal(ck._nms_launch(rows, NMS_THRESHOLD, force, ws),
                          ref), f"nms B={B} A={A} force={force} over a "
              f"workspace differs from nms_plain")
        rec["mask_sweep_ms"] = time_ms(torch, lambda: ck._nms_launch(
            rows, NMS_THRESHOLD, force, ws))
        rec["mask_sweep_device_ms"] = kernel_device_ms(
            torch, lambda: ck._nms_launch(rows, NMS_THRESHOLD, force, ws))
    return rec


def kernel_device_ms(torch, fn, reps=5):
    """Device ms of each CUDA kernel one call of ``fn`` runs, by name:
    ``torch.profiler`` over ``reps`` calls after one, the mean of the
    launches it recorded (spin kernels first, ``spin_fill``: a trace
    may miss the records of its first moments)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spin_fill(torch)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0 and "spin_kernel" not in e.key:
            name = re.search(r"(\w+_kernel(<[^>]*>)?)", e.key)
            out[name.group(1) if name else e.key[:40]] = \
                e.device_time_total / e.count / 1e3
    return out


def nms_edge_rows(torch, B, A, seed):
    """``nms_rows`` with B7's edge cases: every 7th row dead before NMS
    (interleaved), every 9th row's box a duplicate of the row before it
    (IoU exactly 1), and from A = 4 on rows 2 and 3 of class 0 with boxes
    [0, 0, 1, 1] and [0, 0, 1, h], h = float32(0.45): their float32 IoU
    is exactly 0.45 (inter h, union 1 + h - h = 1)."""
    rows = nms_rows(torch, B, A, seed)
    rows[:, 3::7, 0] = -1.0
    dup = torch.arange(9, max(A, 9), 9, device=rows.device)
    rows[:, dup, 2:] = rows[:, dup - 1, 2:]
    if A >= 4:
        rows[:, 2:4, 0] = 0.0
        rows[:, 2, 2:] = torch.tensor([0.0, 0.0, 1.0, 1.0],
                                      device=rows.device)
        rows[:, 3, 2:] = torch.tensor([0.0, 0.0, 1.0, 0.45],
                                      device=rows.device)
    return rows


def check_nms_edges(torch, ck):
    """B7 bit for bit against ``nms_plain`` at its edges, through the
    wrapper: A in {1, 63, 64, 65} (force off: the fused path, and the
    mask and sweep through ``_nms_launch`` over a workspace) and {257,
    319, 320, 321} (force off: the mask and sweep) at B = 3 over
    ``nms_edge_rows``, force off and on (the survivors' kernel),
    thresholds 0.45, 0, -0.5, 1 and 1.5 (0 and below: every live pair of
    a class suppresses; 1: duplicates only); A = 200 and 300 with whole
    blocks of dead rows (mid-order, a tail, an image with none live);
    then one 12,000-row image and SSD300's A under a workspace budget
    that holds two of three images (two groups in one call, one launch
    counted).  Returns the number of checks."""
    n = 0
    for A in (1, 63, 64, 65, 257, 319, 320, 321):
        rows = nms_edge_rows(torch, 3, A, seed=A)
        ws = torch.empty(3 * ck.nms_workspace_bytes(A), dtype=torch.uint8,
                         device=rows.device)
        for force in (False, True):
            for thr in (NMS_THRESHOLD, 0.0, -0.5, 1.0, 1.5):
                ref = ck.nms_plain(rows, thr, force)
                check(torch.equal(ck.nms(rows, thr, force), ref),
                      f"nms edge A={A} force={force} thr={thr}: differs "
                      f"from nms_plain")
                n += 1
                if A <= ck.NMS_FUSED_MAX_ROWS and not force:
                    check(torch.equal(ck._nms_launch(rows, thr, force, ws),
                                      ref), f"nms edge A={A} thr={thr} "
                          f"(mask and sweep): differs from nms_plain")
                    n += 1
    # whole blocks of dead rows (a dead block mid-order, a dead tail, an
    # image with no live row): the mask skips them, the sweeps stop early
    for A in (200, 300):
        rows = nms_edge_rows(torch, 2, A, seed=A)
        rows[:, 64:128, 0] = -1.0
        rows[:, 150:, 0] = -1.0
        rows[1, :, 0] = -1.0
        for force in (False, True):
            check(torch.equal(ck.nms(rows, NMS_THRESHOLD, force),
                              ck.nms_plain(rows, NMS_THRESHOLD, force)),
                  f"nms with dead blocks A={A} force={force}: differs "
                  f"from nms_plain")
            n += 1
    big = nms_edge_rows(torch, 1, 12000, 12)
    for force in (False, True):
        check(torch.equal(ck.nms(big, NMS_THRESHOLD, force),
                          ck.nms_plain(big, NMS_THRESHOLD, force)),
              f"nms at A=12000 force={force} differs")
        n += 1
    rows = nms_edge_rows(torch, 3, 8732, 3)
    budget = ck.NMS_WORKSPACE_BUDGET
    ck.NMS_WORKSPACE_BUDGET = 2 * ck.nms_workspace_bytes(8732) + 8
    try:
        ck.reset_launch_counts()
        got = ck.nms(rows, NMS_THRESHOLD, False)
        check(ck.LAUNCHES["nms"] == 1, "a grouped nms call counted "
              f"{ck.LAUNCHES['nms']} launches")
    finally:
        ck.NMS_WORKSPACE_BUDGET = budget
    check(torch.equal(got, ck.nms_plain(rows, NMS_THRESHOLD, False)),
          "nms over a workspace of two images (B=3 A=8732) differs")
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    return n + 1


def nms_report(_build):
    """Registers, shared and local memory of each of B7's four kernels
    (``cuobjdump -res-usage``).  Raises when one uses local memory or one
    is missing."""
    import re

    res = _cuobjdump(_build, ["-res-usage"], _build._target("nms"))
    out = []
    for fn, regs, stack, shared, local in re.findall(
            r"Function (\S+?):\s+REG:(\d+) STACK:(\d+) SHARED:(\d+) "
            r"LOCAL:(\d+)", res):
        kind = re.search(r"nms_(mask|sweep|fused|force)_kernel", fn)
        if kind is None:
            continue
        rec = {"kernel": f"nms_{kind.group(1)}_kernel",
               "registers": int(regs), "stack_bytes": int(stack),
               "static_shared_bytes": int(shared),
               "local_bytes": int(local)}
        check(int(local) == 0, f"nms: {rec} uses local memory")
        out.append(rec)
    check(sorted(r["kernel"] for r in out) == [
        "nms_force_kernel", "nms_fused_kernel", "nms_mask_kernel",
        "nms_sweep_kernel"], f"nms: cuobjdump reports {out}, not the "
        f"four kernels (mask, sweep, fused, force)")
    return out


def _ragged_tables(B, MB, rng, lengths=None):
    """Fragmented block tables (padded with the scratch page 0) for
    ``lengths`` (default: ragged up to MB pages, one stream ending on a
    page boundary and, with B > 1, one empty stream)."""
    if lengths is None:
        lengths = rng.randint(1, MB * KVB + 1, size=B).astype(np.int32)
        lengths[0] = MB * KVB
        if B > 1:
            lengths[1] = 0
        if B > 2:
            lengths[2] = KVB * max(1, MB // 2)
    lengths = np.asarray(lengths, np.int32)
    pages = rng.permutation(np.arange(1, 1 + B * MB)).astype(np.int32)
    table = np.zeros((B, MB), np.int32)
    used = 0
    for i, n in enumerate(lengths):
        k = -(-int(n) // KVB)
        table[i, :k] = pages[used:used + k]
        used += k
    return lengths, table


def check_decode(torch, ck, F, B, MB, dtype, rng, kv_dtype=None, H=H, D=D,
                 lengths=None, timed=True):
    """B2 at H heads of width D.  ``kv_dtype`` other than ``dtype``: an
    fp32 model over bf16 pages (``kv_dtype='bf16'``); both sides then
    read the same bf16 values, so the fp32 tolerance holds.  ``lengths``
    (B,): the streams' lengths (default: ``_ragged_tables``'); ``timed``
    False: the check alone, no times."""
    dt = getattr(torch, dtype)
    kv_dt = getattr(torch, kv_dtype or dtype)
    P = 1 + B * MB
    g = torch.Generator(device="cuda").manual_seed(B * 1000 + MB)
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dt)
    kp = torch.randn((P, KVB, H, D), generator=g, device="cuda").to(kv_dt)
    vp = torch.randn((P, KVB, H, D), generator=g, device="cuda").to(kv_dt)
    lengths, table = _ragged_tables(B, MB, rng, lengths)
    t_d = torch.from_numpy(table).cuda()
    l_d = torch.from_numpy(lengths).cuda()
    out = ck.paged_attention_decode(q, kp, vp, t_d, l_d)
    ref = ck.paged_attention_decode_plain(q, kp, vp, t_d, l_d)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= TOL[dtype], f"paged_attention_decode B={B} MB={MB} "
          f"{dtype}: max_abs_err {err} over tolerance {TOL[dtype]}")
    check(bool(torch.isfinite(out.float()).all()), "decode not finite")
    check(all(out[i].abs().max().item() == 0.0 for i in range(B)
              if lengths[i] == 0), "lengths==0 row not zeros")
    if not timed:
        return {"kernel": "paged_attention_decode",
                "shape": f"B={B} MB={MB} KVB={KVB} H={H} D={D} "
                f"lengths={lengths.tolist()}",
                "dtype": dtype if kv_dtype is None else f"{dtype}/{kv_dtype}",
                "max_abs_err": err, "tol": TOL[dtype]}

    idx = t_d.long()
    pos = torch.arange(MB * KVB, device="cuda")
    mask = (pos[None, :] < l_d[:, None])[:, None, None, :]

    def library():  # gather (widened to q's dtype), then masked SDPA
        kg = kp[idx].reshape(B, MB * KVB, H, D).transpose(1, 2).to(dt)
        vg = vp[idx].reshape(B, MB * KVB, H, D).transpose(1, 2).to(dt)
        return F.scaled_dot_product_attention(q[:, :, None], kg, vg,
                                              attn_mask=mask)

    es = kp.element_size()
    toks = int(lengths.sum())
    npages = int(sum(-(-int(n) // KVB) for n in lengths))
    nbytes = 2 * B * H * D * q.element_size() + 2 * toks * H * D * es \
        + npages * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4 * H * D * toks, dtype)
    return {
        "kernel": "paged_attention_decode", "shape": f"B={B} MB={MB} "
        f"KVB={KVB} H={H} D={D} tokens={toks}",
        "dtype": dtype if kv_dtype is None else f"{dtype}/{kv_dtype}",
        "max_abs_err": err, "tol": TOL[dtype],
        "ms": time_ms(torch, lambda: ck.paged_attention_decode(
            q, kp, vp, t_d, l_d)),
        "back_to_back_ms": back_to_back_ms(
            torch, lambda: ck.paged_attention_decode(q, kp, vp, t_d, l_d)),
        "device_ms": graph_ms(
            torch, lambda: ck.paged_attention_decode(q, kp, vp, t_d, l_d)),
        "plain_ms": time_ms(torch, lambda: ck.paged_attention_decode_plain(
            q, kp, vp, t_d, l_d), reps=5, warmup=1),
        "library_ms": time_ms(torch, library),
        "bound_ms": b_ms, "bound_by": b_by}


def _quant_pools(torch, tatt, P, kv, g, H=H, D=D):
    """int8/fp8 K and V pools and their scales, quantized on the card by
    the port's ``quantize_kv`` from N(0, 1) values."""
    qdt = getattr(torch, KV_TORCH[kv])
    out = []
    for _ in range(2):
        raw = torch.randn((P, KVB, H, D), generator=g, device="cuda")
        out.append(tatt.quantize_kv(raw, qdt))
    (kq, ks), (vq, vs) = out
    return kq, vq, ks, vs


def check_decode_quant(torch, ck, tatt, F, B, MB, dtype, kv, rng, H=H, D=D,
                       lengths=None, timed=True):
    """B3 over int8/fp8 pools against its plain version, at H heads of
    width D: both dequantize the same bytes, so the fp32/bf16 tolerance
    holds.  ``lengths`` and ``timed`` as ``check_decode``'s."""
    dt = getattr(torch, dtype)
    P = 1 + B * MB
    g = torch.Generator(device="cuda").manual_seed(B * 1000 + MB + 7)
    q = torch.randn((B, H, D), generator=g, device="cuda").to(dt)
    kq, vq, ks, vs = _quant_pools(torch, tatt, P, kv, g, H, D)
    lengths, table = _ragged_tables(B, MB, rng, lengths)
    t_d = torch.from_numpy(table).cuda()
    l_d = torch.from_numpy(lengths).cuda()
    out = ck.paged_attention_decode_quant(q, kq, vq, ks, vs, t_d, l_d)
    ref = ck.paged_attention_decode_quant_plain(q, kq, vq, ks, vs, t_d, l_d)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= TOL[dtype], f"paged_attention_decode_quant B={B} MB={MB} "
          f"{dtype}/{kv}: max_abs_err {err} over tolerance {TOL[dtype]}")
    check(bool(torch.isfinite(out.float()).all()), "quant decode not finite")
    check(all(out[i].abs().max().item() == 0.0 for i in range(B)
              if lengths[i] == 0), "lengths==0 row not zeros")
    if not timed:
        return {"kernel": "paged_attention_decode_quant",
                "shape": f"B={B} MB={MB} KVB={KVB} H={H} D={D} "
                f"lengths={lengths.tolist()}", "dtype": f"{dtype}/{kv}",
                "max_abs_err": err, "tol": TOL[dtype]}

    idx = t_d.long()
    pos = torch.arange(MB * KVB, device="cuda")
    mask = (pos[None, :] < l_d[:, None])[:, None, None, :]

    def library():  # gather, dequantize, then masked SDPA
        kg = ck.gather_dequant(kq, ks, idx).transpose(1, 2).to(dt)
        vg = ck.gather_dequant(vq, vs, idx).transpose(1, 2).to(dt)
        return F.scaled_dot_product_attention(q[:, :, None], kg, vg,
                                              attn_mask=mask)

    toks = int(lengths.sum())
    npages = int(sum(-(-int(n) // KVB) for n in lengths))
    # codes (1 byte) and one fp32 scale per token-head, for K and V
    nbytes = 2 * B * H * D * q.element_size() + 2 * toks * H * (D + 4) \
        + npages * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4 * H * D * toks, dtype)
    return {
        "kernel": "paged_attention_decode_quant",
        "shape": f"B={B} MB={MB} KVB={KVB} H={H} D={D} tokens={toks}",
        "dtype": f"{dtype}/{kv}", "max_abs_err": err, "tol": TOL[dtype],
        "ms": time_ms(torch, lambda: ck.paged_attention_decode_quant(
            q, kq, vq, ks, vs, t_d, l_d)),
        "back_to_back_ms": back_to_back_ms(
            torch, lambda: ck.paged_attention_decode_quant(
                q, kq, vq, ks, vs, t_d, l_d)),
        "device_ms": graph_ms(
            torch, lambda: ck.paged_attention_decode_quant(
                q, kq, vq, ks, vs, t_d, l_d)),
        "plain_ms": time_ms(torch, lambda: ck.paged_attention_decode_quant_plain(
            q, kq, vq, ks, vs, t_d, l_d), reps=5, warmup=1),
        "library_ms": time_ms(torch, library),
        "bound_ms": b_ms, "bound_by": b_by}


def check_verify(torch, ck, tatt, F, B, W, MB, pool, rng, H=H, D=D,
                 start=None, timed=True, qdtype=None):
    """B4 (``pool`` float32/bfloat16/float16: raw pages, queries of the
    pool's dtype; int8/fp8: the quantized instantiation, under ``qdtype``
    queries, float32 by default) at H heads of width D against its plain
    version, with
    q a strided view of a packed (B, W, 3*H*D) qkv; and row w against
    the decode kernel (B2, or B3 over quantized pools) at lengths =
    start + 1 + w, bit for bit.  ``start`` (B,): the tokens cached before
    each window (default: ragged, one window ending on the last page, one
    padded batch row); ``timed`` False: the checks alone, no times."""
    quant = pool in KV_TORCH
    dtype = (qdtype or "float32") if quant else pool
    dt = getattr(torch, dtype)
    P = 1 + B * MB
    g = torch.Generator(device="cuda").manual_seed(B * 100 + W)
    qkv = torch.randn((B, W, 3 * H * D), generator=g, device="cuda").to(dt)
    q = qkv[..., :H * D].unflatten(-1, (H, D))
    if quant:
        kp, vp, ks, vs = _quant_pools(torch, tatt, P, pool, g, H, D)
        scales = (ks, vs)
    else:
        kp = torch.randn((P, KVB, H, D), generator=g, device="cuda").to(dt)
        vp = torch.randn((P, KVB, H, D), generator=g, device="cuda").to(dt)
        scales = ()
    if start is None:
        # ragged starts (one window ending exactly on the last page, one
        # padded batch row: start 0, a table of scratch pages)
        start = rng.randint(0, MB * KVB - W + 1, size=B).astype(np.int32)
        start[0] = MB * KVB - W
        lengths = start + W
        if B > 1:
            lengths[1] = 0
        lengths, table = _ragged_tables(B, MB, rng, lengths)
        if B > 1:
            start[1] = 0
    else:
        start = np.asarray(start, np.int32)
        _, table = _ragged_tables(B, MB, rng,
                                  np.minimum(start + W, MB * KVB))
    s_d = torch.from_numpy(start).cuda()
    t_d = torch.from_numpy(table).cuda()
    name = "paged_attention_verify_quant" if quant \
        else "paged_attention_verify"
    out = ck.paged_attention_verify(q, kp, vp, t_d, s_d, *scales)
    ref = ck.paged_attention_verify_plain(q, kp, vp, t_d, s_d, *scales)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= TOL[dtype], f"{name} B={B} W={W} MB={MB} {pool}: "
          f"max_abs_err {err} over tolerance {TOL[dtype]}")
    check(bool(torch.isfinite(out.float()).all()), f"{name} not finite")
    for w in range(W):
        lw = s_d + (1 + w)
        if quant:
            dec = ck.paged_attention_decode_quant(q[:, w], kp, vp, *scales,
                                                  t_d, lw)
        else:
            dec = ck.paged_attention_decode(q[:, w], kp, vp, t_d, lw)
        check(torch.equal(out[:, w], dec),
              f"{name} {pool}: row {w} differs from the decode kernel at "
              f"start+1+w (max {(out[:, w].float() - dec.float()).abs().max().item()})")
    if not timed:
        return {"kernel": name, "shape": f"B={B} W={W} MB={MB} KVB={KVB} "
                f"H={H} D={D} start={start.tolist()}",
                "dtype": f"{dtype}/{pool}" if quant else dtype,
                "max_abs_err": err, "tol": TOL[dtype], "rows_bitwise": True}

    idx = t_d.long()
    pos = torch.arange(MB * KVB, device="cuda")
    limit = s_d[:, None] + 1 + torch.arange(W, device="cuda")[None, :]
    mask = (pos[None, None, :] < limit[:, :, None])[:, None]  # (B,1,W,T)

    def library():  # gather (dequantize), SDPA under the diagonal mask
        if quant:
            kg = ck.gather_dequant(kp, ks, idx)
            vg = ck.gather_dequant(vp, vs, idx)
        else:
            kg = kp[idx].reshape(B, MB * KVB, H, D)
            vg = vp[idx].reshape(B, MB * KVB, H, D)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kg.transpose(1, 2).to(dt),
            vg.transpose(1, 2).to(dt), attn_mask=mask)

    # each stream's visible tokens are read once: start + W (its window
    # included); every row w sums over start + 1 + w of them
    vis = int(sum(int(st) + W for st in start))
    pairs = int(sum(W * int(st) + W * (W + 1) // 2 for st in start))
    per_tok = 2 * H * ((D + 4) if quant else D * kp.element_size())
    npages = int(sum(-(-(int(st) + W) // KVB) for st in start))
    nbytes = 2 * B * W * H * D * q.element_size() + vis * per_tok \
        + npages * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4 * H * D * pairs, dtype)
    return {
        "kernel": name,
        "shape": f"B={B} W={W} MB={MB} KVB={KVB} H={H} D={D} "
        f"tokens={vis}", "dtype": f"{dtype}/{pool}" if quant else dtype,
        "max_abs_err": err, "tol": TOL[dtype], "rows_bitwise": True,
        "ms": time_ms(torch, lambda: ck.paged_attention_verify(
            q, kp, vp, t_d, s_d, *scales)),
        "back_to_back_ms": back_to_back_ms(
            torch, lambda: ck.paged_attention_verify(
                q, kp, vp, t_d, s_d, *scales)),
        "device_ms": graph_ms(
            torch, lambda: ck.paged_attention_verify(
                q, kp, vp, t_d, s_d, *scales)),
        "plain_ms": time_ms(torch, lambda: ck.paged_attention_verify_plain(
            q, kp, vp, t_d, s_d, *scales), reps=3, warmup=1),
        "library_ms": time_ms(torch, library),
        "bound_ms": b_ms, "bound_by": b_by}


# the paged kernels' work partition (paged_attention.cuh): NC CTAs a
# cluster take every NC-th page, their NW warps every NW-th of those
PAGED_NC, PAGED_NW, PAGED_WC = 8, 2, 8
# head widths of the edge checks: every bucket, a ragged width whose rows
# stay 16-byte aligned (48) and an odd one (37: 4-, 2- and 1-byte copies)
PAGED_EDGE_WIDTHS = (32, 37, 48, 64, 96, 128)
PAGED_EDGE_W = (1, SPEC_K + 1, 9)  # 9: more rows than a pass holds (8)


def paged_edge_lengths(MB=64):
    """Stream lengths at the partition's edges: empty, shorter than a
    page, one page, and multiples of NC * KVB and NC * NW * KVB (a whole
    round of the cluster's CTAs, and of all its warps) with their
    neighbours, up to the full table."""
    out = {0, 1, KVB - 1, KVB, KVB + 1, MB * KVB}
    for x in (PAGED_NC * KVB, PAGED_NC * PAGED_NW * KVB):
        out |= {x - 1, x, x + 1}
    return sorted(n for n in out if n <= MB * KVB)


def paged_edge_starts(W, MB=64):
    """Verify starts whose windows begin, end or straddle the same
    edges: start 0 (rows of 1..W tokens, shorter than a page), and for
    each edge X, windows ending at X - 1, X and X + 1 and starting at X."""
    out = {0, MB * KVB - W}
    for x in (KVB, PAGED_NC * KVB, PAGED_NC * PAGED_NW * KVB):
        out |= {x - W - 1, x - W, x - W + 1, x}
    return sorted(n for n in out if 0 <= n <= MB * KVB - W)


def paged_edge_checks(torch, ck, tatt, F, rng, MB=64):
    """The paged kernels at the partition's edges (``paged_edge_lengths``,
    ``paged_edge_starts``) at every head width of ``PAGED_EDGE_WIDTHS``
    (4 heads): the decode kernel over fp32, bf16 and fp32/bf16 pages, the
    quantized decode over int8 and fp8, each within ``TOL`` of its plain
    version, an empty stream all zeros; the verify kernel over the four
    pools at W = 1, 5 and 9, within ``TOL``, every row ``torch.equal`` to
    the decode kernel at start + 1 + w.  Untimed."""
    recs = []
    lengths = paged_edge_lengths(MB)
    for Dh in PAGED_EDGE_WIDTHS:
        wide = dict(H=4, D=Dh)
        recs += [
            check_decode(torch, ck, F, len(lengths), MB, "float32", rng,
                         lengths=lengths, timed=False, **wide),
            check_decode(torch, ck, F, len(lengths), MB, "bfloat16", rng,
                         lengths=lengths, timed=False, **wide),
            check_decode(torch, ck, F, len(lengths), MB, "float32", rng,
                         kv_dtype="bfloat16", lengths=lengths, timed=False,
                         **wide)]
        for kv in ("int8", "fp8"):
            recs.append(check_decode_quant(
                torch, ck, tatt, F, len(lengths), MB, "float32", kv, rng,
                lengths=lengths, timed=False, **wide))
        for W in PAGED_EDGE_W:
            starts = paged_edge_starts(W, MB)
            for pool in ("float32", "bfloat16", "int8", "fp8"):
                recs.append(check_verify(torch, ck, tatt, F, len(starts), W,
                                         MB, pool, rng, start=starts,
                                         timed=False, **wide))
    return recs


# the paged kernels: library, its shared-memory query's argument for a
# reader (pool element code), the readers it instantiates
def half_kernel_checks(torch, ck, tatt, F, dtype, rng, parts=("tc",
                                                             "paged")):
    """The ``dtype`` (bfloat16 or float16) instantiations of rows 1-9 of
    PERF.md's table at its shapes, each against its plain version at
    ``TOL`` / ``BWD_TOL`` of ``dtype``: "tc" in ``parts``, B1's forward
    (B = 1 and 8, T = 1024) and backward (B = 8), B5's forward and
    backward at the DPA path's shape, B8 and B9 at the ring's past hop;
    "paged", the paged kernels at B = 16, MB = 64: decode over ``dtype``
    pages under ``dtype`` and fp32 queries, the quantized decode and
    verify under ``dtype`` queries over int8 and fp8 codes, verify over
    ``dtype`` pages (each verify row bit for bit the decode kernel's)."""
    recs = []
    if "tc" in parts:
        recs += [check_prefill(torch, ck, F, 1024, dtype, B=B)
                 for B in (1, TRAIN_BATCH)]
        recs += check_backward(torch, ck, F, TRAIN_BATCH, 1024, dtype)
        recs += check_mha(torch, ck, F, *MHA_SHAPES[0], dtype)
        recs += check_partial(torch, ck, F, *PARTIAL_SHAPES[1], dtype)
        torch.cuda.empty_cache()
    if "paged" not in parts:
        return recs
    recs.append(check_decode(torch, ck, F, 16, 64, dtype, rng))
    recs.append(check_decode(torch, ck, F, 16, 64, "float32", rng,
                             kv_dtype=dtype))
    for kv in ("int8", "fp8"):
        recs.append(check_decode_quant(torch, ck, tatt, F, 16, 64, dtype, kv,
                                       rng))
    for pool in (dtype, "int8", "fp8"):
        recs.append(check_verify(torch, ck, tatt, F, 16, SPEC_K + 1, 64,
                                 pool, rng, qdtype=dtype))
    torch.cuda.empty_cache()
    return recs


# (library, its page readers' mangled element types → the library's
# shared-memory query code, the rows a pass it instantiates: the decode
# libraries one, the verify library one and PAGED_WC)
PAGED_LIBS = (
    ("paged_attention_decode", {"f": 0, "13__nv_bfloat16": 1,
                                "6__half": 2}, (1,)),
    ("paged_attention_decode_quant", {"a": None, "h": None}, (1,)),
    # the verify library's query takes 1 for any 16-bit pool
    ("paged_attention_verify", {"f": 0, "13__nv_bfloat16": 1,
                                "6__half": 1, "a": 2, "h": 3},
     (1, PAGED_WC)))


def paged_report(_build):
    """Registers, shared and local memory of every instantiation of the
    paged kernels' one kernel (``paged::attend_kernel``, at 1 row a pass,
    and in the verify library also ``PAGED_WC``) in each of the three
    libraries (``cuobjdump -res-usage``; dynamic shared memory and the
    cluster size from each library's own queries), and the CTAs an SM
    holds (by registers, shared memory and threads).  Raises when a
    head-width bucket is missing for a reader, an instantiation at D = 64
    uses local memory, or fewer than two CTAs fit an SM."""
    import ctypes
    import re

    name_re = re.compile(r"attend_kernelI(f|13__nv_bfloat16|6__half)"
                         r"Li(\d+)ELi(\d+)E\w*?(RawPages|QuantPages)"
                         r"I(f|13__nv_bfloat16|6__half|a|h)E")
    half = {"f": "float32", "13__nv_bfloat16": "bfloat16",
            "6__half": "float16"}
    out = []
    for lib, readers, rows_built in PAGED_LIBS:
        res = _cuobjdump(_build, ["-res-usage"], _build._target(lib))
        so = _build.library(lib)
        cluster = getattr(so, f"{lib}_cluster_size")
        cluster.restype = ctypes.c_int
        smem = getattr(so, f"{lib}_smem_bytes")
        smem.restype = ctypes.c_int
        seen = set()
        for fn, regs, stack, shared, local in re.findall(
                r"Function (\S+?):\s+REG:(\d+) STACK:(\d+) SHARED:(\d+) "
                r"LOCAL:(\d+)", res):
            mt_ = name_re.search(fn)
            if mt_ is None:
                continue
            tq, dp, rows, _, elem = mt_.groups()
            dp = int(dp)
            code = readers[elem]
            dyn = smem(dp, code) if code is not None else smem(dp)
            regs = int(regs)
            # registers go to a warp in units of 256; 64K an SM, 2048
            # threads, 228 KB of shared memory (1 KB of it per CTA reserved)
            warp_regs = -(-regs * 32 // 256) * 256
            per_sm = min(65536 // warp_regs // PAGED_NW,
                         233472 // (int(shared) + dyn + 1024),
                         2048 // (PAGED_NW * 32), 32)
            rec = {"library": lib, "q": half[tq],
                   "pool": {**half, "a": "int8", "h": "fp8"}[elem],
                   "head_dim_bucket": dp, "rows_a_pass": int(rows),
                   "registers": regs, "stack_bytes": int(stack),
                   "static_shared_bytes": int(shared),
                   "dynamic_shared_bytes": dyn, "local_bytes": int(local),
                   "cluster_size": cluster(), "ctas_per_sm": per_sm}
            check(dp != 64 or int(local) == 0,
                  f"{lib} {rec['q']}/{rec['pool']} D<={dp}: {local} bytes "
                  f"of local memory")
            check(per_sm >= 2, f"{lib} {rec}: fewer than two CTAs an SM")
            check(cluster() == PAGED_NC, f"{lib}: cluster of {cluster()}")
            seen.add((elem, dp, int(rows)))
            out.append(rec)
        want = {(e, p, r) for e in readers for p in (32, 64, 96, 128)
                for r in rows_built}
        check(want <= seen, f"{lib}: instantiations missing from "
              f"cuobjdump's report: {sorted(want - seen)}")
    return out


def gpt2_small_params(seed=0, cfg=GPT2_SMALL):
    """Random weights of the GPT-2-small-class LM (or of the
    ``transformer_lm`` configuration ``cfg``), N(0, 0.02), LayerNorm at
    identity, zero biases."""
    from mxnet_tpu_torch.models.transformer import param_names

    V, L, dm = cfg["vocab_size"], cfg["num_layers"], cfg["d_model"]
    dff, T = cfg["d_ff"], cfg["max_len"]
    shapes = {"tok_embed_weight": (V, dm), "pos_embed_weight": (T, dm),
              "ln_f_gamma": (dm,), "ln_f_beta": (dm,),
              "head_weight": (V, dm), "head_bias": (V,)}
    for i in range(L):
        p = f"layer{i}_"
        shapes.update({p + "ln1_gamma": (dm,), p + "ln1_beta": (dm,),
                       p + "qkv_weight": (3 * dm, dm),
                       p + "qkv_bias": (3 * dm,),
                       p + "proj_weight": (dm, dm), p + "proj_bias": (dm,),
                       p + "ln2_gamma": (dm,), p + "ln2_beta": (dm,),
                       p + "ff1_weight": (dff, dm), p + "ff1_bias": (dff,),
                       p + "ff2_weight": (dm, dff), p + "ff2_bias": (dm,)})
    rng = np.random.RandomState(seed)
    params = {}
    for n in param_names(L):
        if n.endswith("_gamma"):
            params[n] = np.ones(shapes[n], np.float32)
        elif n.endswith(("_beta", "_bias")):
            params[n] = np.zeros(shapes[n], np.float32)
        else:
            params[n] = (rng.standard_normal(shapes[n]) * 0.02).astype(
                np.float32)
    return params


def serve_run(torch, mt, ck, dev_params, prompts, temps, new_tokens,
              cfg=GPT2_SMALL, on_reset=None, trace=None, warm=False,
              **engine_kw):
    """Serve ``prompts`` through a fresh ``DecodeEngine`` of the LM
    ``cfg`` (after a warm-up request; with ``warm`` after ``warmup()``
    too, so no bucket is built inside the traffic), with the launch
    counts reset just before (``on_reset()`` then) and read just after;
    with ``trace`` (a label) the run is a ``TracedLaunches`` region and
    the launches are its trace's (the record's ``half_launches``: the
    bf16 and fp16 instantiations' counts).  Returns (engine model,
    outputs, stats, launches, record)."""
    eng = mt.DecodeEngine(dev_params, **cfg, ctx=mt.gpu(0),
                          kv_block=KVB, max_streams=16, seed=0, **engine_kw)
    traced = None
    warmed = None
    with eng:
        if warm:  # every bucket, and the sampler's first draw
            t0 = time.perf_counter()
            eng.warmup()
            warmed = eng.stats()
            warmed["wall_s"] = time.perf_counter() - t0
            eng.generate(np.arange(1, 20, dtype=np.int32), 2,
                         temperature=0.8)
        eng.generate(np.arange(1, 20, dtype=np.int32), 2)  # CUDA warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng.reset_stats()
        ck.reset_launch_counts()  # counts from here on: this run
        if on_reset is not None:
            on_reset()
        if trace is not None:
            traced = TracedLaunches(torch, ck, trace).__enter__()
        t0 = time.perf_counter()
        futs = [eng.submit(p, new_tokens, temperature=t)
                for p, t in zip(prompts, temps)]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        if traced is not None:
            traced.__exit__(None, None, None)
            launches = traced.launches
        st = eng.stats()
        peak = torch.cuda.max_memory_allocated()
        model = eng.model
    # seeded random prompts under the default prefix cache: no hit, so
    # B1 runs once a prefill and B8 never (the callers' launch rules)
    check(st["prefix_cache"] == 1 and st["prefix_hits"] == 0
          and st["prefill_chunks"] == 0,
          f"a serving run scored {st['prefix_hits']} prefix hits and "
          f"{st['prefill_chunks']} chunks on random prompts")
    for o in outs:
        check(o.shape == (new_tokens,) and o.min() >= 0
              and o.max() < cfg["vocab_size"], f"bad generation {o}")
    gen = int(sum(len(o) for o in outs))
    greedy = hashlib.sha256(b"".join(
        o.astype(np.int32).tobytes() for o, t in zip(outs, temps)
        if t == 0.0)).hexdigest()[:16]
    rec = {"requests": len(prompts),
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "generated_tokens": gen, "wall_s": wall,
           "tokens_per_s": gen / wall,
           "ttft_p50_ms": st["ttft_p50_ms"], "ttft_p99_ms": st["ttft_p99_ms"],
           "decode_step_p50_ms": st["step_p50_ms"],
           "prefills": st["prefills"], "steps": st["steps"],
           "spec_steps": st["spec_steps"],
           "spec_proposed": st["spec_proposed"],
           "spec_accepted": st["spec_accepted"],
           "accepted_token_rate": st["accepted_token_rate"],
           "tokens_per_step": st["tokens_per_step"],
           "preempted": st["preempted"], "kv_dtype": st["kv_dtype"],
           "prefix_hits": st["prefix_hits"],
           "pool_bytes": st["pool_bytes"], "peak_memory_bytes": int(peak),
           "graphs": st.get("graphs"),
           "compiles": len(st.get("compiles", ())),
           "d2h_syncs_saved": st.get("d2h_syncs_saved"),
           "greedy_outputs_sha256": greedy, "launches": launches}
    if traced is not None:
        rec["half_launches"] = {"bf16": traced.bf16_launches,
                                "fp16": traced.fp16_launches}
    if warmed is not None:
        rec["warmup"] = {k: warmed[k] for k in (
            "compiles", "graphs", "wall_s", "prefill_buckets",
            "decode_buckets", "cache_buckets", "spec_tokens",
            "prefix_cache")}
        rec["warmup"]["compiles_after_traffic"] = st["compiles"]
    return model, outs, st, launches, rec


def forward_check(torch, model, prompts, outs, temps, lens, label,
                  margin_tol=1e-3, rel_margin=0.0, band=False):
    """The port's full forward over the shortest and the longest greedy
    stream (its prompt and the engine's tokens) reproduces the engine's
    token wherever the forward's top-2 margin exceeds the tolerance
    (``margin_tol``, fp32; or ``rel_margin`` times the row's largest
    |logit|, bf16, whose logits carry roundings of that size), at a
    quarter of the tokens at least.  With ``band`` (an LM whose top
    logits lie within that tolerance of each other) every engine token's
    logit lies within the tolerance of the top one instead."""
    greedy = [i for i in range(len(prompts)) if temps[i] == 0.0]
    for i in (min(greedy, key=lambda j: lens[j]),
              max(greedy, key=lambda j: lens[j])):
        seq = np.concatenate([prompts[i], outs[i]])
        rows = model(torch.from_numpy(seq).cuda()[None])[0][
            len(prompts[i]) - 1:-1].float()
        top2 = torch.topk(rows, 2, dim=-1)
        margin = top2.values[:, 0] - top2.values[:, 1]
        tol = rel_margin * rows.abs().max(-1).values if rel_margin \
            else torch.full_like(margin, margin_tol)
        sure = (margin > tol).cpu().numpy()
        arg = top2.indices[:, 0].cpu().numpy()
        agree = int((arg == outs[i]).sum())
        if band:
            tok = torch.from_numpy(outs[i].astype(np.int64)).cuda()
            gap = top2.values[:, 0] - rows.gather(1, tok[:, None])[:, 0]
            near = (gap <= tol).cpu().numpy()
            check(near.all(), f"{label} stream {i}: the engine's tokens at "
                  f"{np.nonzero(~near)[0]} lie below the full forward's top "
                  f"logit by more than the tolerance")
        else:
            check(np.array_equal(arg[sure], outs[i][sure])
                  and 4 * sure.sum() >= len(arg),
                  f"{label} stream {i}: full forward disagrees with the "
                  f"engine at {np.nonzero(sure & (arg != outs[i]))[0]}, or "
                  f"fewer than a quarter of {len(arg)} tokens over the "
                  f"margin ({int(sure.sum())})")
        what = f"{rel_margin:g} of the row's largest logit" if rel_margin \
            else f"{margin_tol:g}"
        print(f"forward check ({label}): stream {i} ({lens[i]}-token "
              f"prompt) {int(sure.sum())}/{len(arg)} tokens over the "
              f"{what} margin agree; its argmax is the engine's token at "
              f"{agree}/{len(arg)}" + ("; every token within the margin "
                                       "of the top logit" if band else ""))


def main_path(torch, mt, ck, dev_params):
    """Run A: fp32 pages, 16 requests of 32 tokens."""
    L = GPT2_SMALL["num_layers"]
    rng = np.random.RandomState(1)
    lens = rng.randint(32, 901, size=16)
    prompts = [rng.randint(1, GPT2_SMALL["vocab_size"], size=n)
               .astype(np.int32) for n in lens]
    temps = [0.8 if i in (3, 11) else 0.0 for i in range(16)]
    model, outs, st, launches, rec = serve_run(torch, mt, ck, dev_params,
                                               prompts, temps, 32)
    check(launches["flash_mha_packed"] == L * st["prefills"] > 0,
          f"flash_mha_packed launched {launches['flash_mha_packed']} "
          f"times for {st['prefills']} prefills")
    check(launches["paged_attention_decode"] == L * st["steps"] > 0,
          f"paged_attention_decode launched "
          f"{launches['paged_attention_decode']} times for "
          f"{st['steps']} steps")
    forward_check(torch, model, prompts, outs, temps, lens, "A")
    return rec


def spec_prompts(seed=3):
    """16 prompts, each a seeded random segment of 8-64 tokens repeated
    to 64-900 tokens (quoted or templated text, where prompt lookup
    finds drafts)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(16):
        seg = rng.randint(1, GPT2_SMALL["vocab_size"],
                          size=rng.randint(8, 65)).astype(np.int32)
        n = rng.randint(64, 901)
        out.append(np.tile(seg, -(-n // len(seg)))[:n])
    return out


def _expect_launches(launches, want, run):
    for name, n in want.items():
        check(launches[name] == n, f"run {run}: {name} launched "
              f"{launches[name]} times, expected {n}")


def spec_paths(torch, mt, ck, dev_params, runs=("B", "C", "D")):
    """Runs B (fp32, spec), C (int8, spec) and D (fp8, no spec), those
    of ``runs`` (C needs B)."""
    which = runs
    L = GPT2_SMALL["num_layers"]
    prompts = spec_prompts()
    lens = [len(p) for p in prompts]
    temps = [0.8 if i in (5, 12) else 0.0 for i in range(16)]
    greedy = [i for i in range(16) if temps[i] == 0.0]
    runs = {}

    model, outs_b, st, launches, runs["B"] = serve_run(
        torch, mt, ck, dev_params, prompts, temps, SPEC_NEW,
        spec_tokens=SPEC_K, proposer="ngram")
    plain = st["steps"] - st["spec_steps"]
    check(st["spec_accepted"] > 0, f"run B: no draft accepted ({st})")
    _expect_launches(launches, {
        "flash_mha_packed": L * st["prefills"],
        "paged_attention_verify": L * st["spec_steps"],
        "paged_attention_decode": L * plain,
        "paged_attention_decode_quant": 0,
        "paged_attention_verify_quant": 0}, "B")
    forward_check(torch, model, prompts, outs_b, temps, lens, "B")
    del model
    torch.cuda.empty_cache()

    _, outs_c, st, launches, runs["C"] = serve_run(
        torch, mt, ck, dev_params, prompts, temps, SPEC_NEW,
        kv_dtype="int8", spec_tokens=SPEC_K, proposer="ngram")
    plain = st["steps"] - st["spec_steps"]
    check(st["spec_accepted"] > 0, f"run C: no draft accepted ({st})")
    _expect_launches(launches, {
        "flash_mha_packed": L * st["prefills"],
        "paged_attention_verify_quant": L * st["spec_steps"],
        "paged_attention_decode_quant": L * plain,
        "paged_attention_decode": 0, "paged_attention_verify": 0}, "C")
    for i in greedy:  # prefill attends raw K/V: the same first token
        check(outs_c[i][0] == outs_b[i][0], f"run C stream {i}: first "
              f"token {outs_c[i][0]} differs from run B's {outs_b[i][0]}")
    agree = []
    for i in greedy:
        same = np.nonzero(outs_c[i] != outs_b[i])[0]
        agree.append(int(same[0]) if same.size else SPEC_NEW)
    runs["C"]["greedy_tokens_equal_to_B_before_first_difference"] = agree
    print(f"int8 vs fp32 pages (runs C, B): greedy streams agree for "
          f"{agree} of {SPEC_NEW} tokens")
    torch.cuda.empty_cache()
    if "D" not in which:
        return runs

    _, _, st, launches, runs["D"] = serve_run(
        torch, mt, ck, dev_params, prompts[:4], [0.0] * 4, 32,
        kv_dtype="fp8")
    _expect_launches(launches, {
        "flash_mha_packed": L * st["prefills"],
        "paged_attention_decode_quant": L * st["steps"],
        "paged_attention_decode": 0, "paged_attention_verify": 0,
        "paged_attention_verify_quant": 0}, "D")
    check(st["steps"] > 0 and st["spec_steps"] == 0, f"run D: {st}")
    torch.cuda.empty_cache()
    return runs


def random_walk_tokens(vocab, seq_len, rows, seed=7):
    """Next-token data over a random-walk token stream (token t+1 lies
    near token t: a learnable synthetic language), ids 1..vocab-1."""
    rng = np.random.RandomState(seed)
    walk = np.cumsum(rng.randint(-2, 3, size=rows * seq_len + 1))
    toks = (np.abs(walk) % (vocab - 1) + 1).astype(np.float32)
    return (toks[:-1].reshape(rows, seq_len),
            toks[1:].reshape(rows, seq_len))


DPA_KERNELS = ("flash_mha", "flash_mha_bwd_dq", "flash_mha_bwd_dkv")
PACKED_KERNELS = ("flash_mha_packed", "flash_mha_packed_bwd_dq",
                  "flash_mha_packed_bwd_dkv")


def lm_module(mt, sym, params):
    """``sym`` (a GPT-2-class LM symbol) bound through ``Module`` on
    ``gpu(0)`` at batch ``TRAIN_BATCH`` x 1024 with ``params``."""
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    T = GPT2_SMALL["max_len"]
    mod.bind(data_shapes=[("data", (TRAIN_BATCH, T))],
             label_shapes=[("softmax_label", (TRAIN_BATCH, T))])
    mod.init_params(arg_params=params)
    return mod


def lm_batches(mt):
    V, T = GPT2_SMALL["vocab_size"], GPT2_SMALL["max_len"]
    X, Y = random_walk_tokens(V, T, TRAIN_BATCH * TRAIN_STEPS)
    return mt.io.NDArrayIter(X, Y, batch_size=TRAIN_BATCH)


def launch_counts(ck):
    """The built-in kernels' launch counts and the user kernels' (a user
    kernel cannot take a built-in kernel's name)."""
    from mxnet_tpu_torch import rtc

    return {**ck.LAUNCHES, **rtc.LAUNCHES}


def reset_launch_counts(ck):
    from mxnet_tpu_torch import rtc

    ck.reset_launch_counts()
    rtc.reset_launch_counts()


# the device functions of each kernel a graphed path launches, as a
# trace names them: one launch a wrapper counts is one of these (nms:
# its sweep, its fused or its survivors' kernel, one a call whose images
# fit one workspace group, as the detection forward's do)
TRACE_FUNCTIONS = {
    "flash_mha_packed": ("mhap_fwd_kernel",),
    "flash_mha_packed_bwd_dq": ("mhap_bwd_dq_kernel",),
    "flash_mha_packed_bwd_dkv": ("mhap_bwd_dkv_kernel",),
    "flash_mha": ("mha_fwd_kernel",),
    "flash_mha_bwd_dq": ("mha_bwd_dq_kernel",),
    "flash_mha_bwd_dkv": ("mha_bwd_dkv_kernel",),
    "lstm_scan": ("lstm_cluster_kernel", "lstm_stream_kernel"),
    "nms": ("nms_sweep_kernel", "nms_fused_kernel", "nms_force_kernel"),
    "user_silu": ("user_silu",), "user_silu_grad": ("user_silu_grad",),
    "user_gelu": ("user_gelu",), "user_gelu_grad": ("user_gelu_grad",),
    "user_triton_silu": ("user_triton_silu",),
    "user_triton_silu_grad": ("user_triton_silu_grad",),
    # the four paged wrappers launch one device function: a trace counts
    # them together (PAGED_GROUP)
    "paged_attention": ("attend_kernel",),
    "flash_attention_partial": ("partial_fwd_kernel",),
    "flash_attention_bwd_dq": ("partial_bwd_dq_kernel",),
    "flash_attention_bwd_dkv": ("partial_bwd_dkv_kernel",)}
_TRACE_KEY = {f: k for k, fs in TRACE_FUNCTIONS.items() for f in fs}
# the wrappers whose launches a trace counts under "paged_attention"
PAGED_GROUP = ("paged_attention_decode", "paged_attention_decode_quant",
               "paged_attention_verify", "paged_attention_verify_quant")
# a function's name in a kernel's trace name, demangled ("void
# mhap_fwd_kernel<float>(...)", "user_gelu(float const*, ...)"), not
# ("_Z9user_geluPKfPfi"), or a Triton kernel's ("user_triton_silu", in
# older Triton versions with a specialization suffix "_0d1d2de")
_TRACE_NAME = re.compile(r"(?<![A-Za-z_])("
                         + "|".join(sorted(_TRACE_KEY, key=len,
                                           reverse=True))
                         + r")(?=[<(IP]|_\d|$)")


# spin kernels (``torch.cuda._sleep``) at each end of a traced region,
# about a millisecond each first and half that last: a trace may miss
# the records of its first moments (up to 28 of 32 first spins in a
# full run), and no kernel of the region is then among them
TRACE_FILLERS, TRACE_FILLER_CYCLES = 100, 2_000_000


def spin_fill(torch, cycles=TRACE_FILLER_CYCLES):
    """``TRACE_FILLERS`` spin kernels of ``cycles``, then a
    synchronize."""
    for _ in range(TRACE_FILLERS):
        torch.cuda._sleep(cycles)
    torch.cuda.synchronize()


# a traced kernel whose name holds "bfloat16" or "__half" (a template
# argument: its input, or a paged kernel's pages or q) is also counted
# under its wrapper's name with this suffix
BF16_SUFFIX, FP16_SUFFIX = "@bf16", "@fp16"


def traced_launches(prof):
    """The kernels of ``TRACE_FUNCTIONS`` in the device activity of the
    finished ``torch.profiler`` run ``prof``, by wrapper name (the bf16
    and fp16 instantiations also under name + ``BF16_SUFFIX`` /
    ``FP16_SUFFIX``), and the spin
    kernels: "spin_long" (at least 3/4 of a ``TRACE_FILLER_CYCLES``
    spin's median) and "spin_short"."""
    counts = {k: 0 for k in TRACE_FUNCTIONS}
    kineto = getattr(prof.profiler, "kineto_results", None)
    if kineto is not None:
        events = [(e.name(), e.duration_ns()) for e in kineto.events()
                  if str(e.device_type()).endswith("CUDA")]
    else:
        events = [(e.name, e.device_time_total * 1e3) for e in prof.events()
                  if str(e.device_type).endswith("CUDA")]
    spins = []
    for name, ns in events:
        m = _TRACE_NAME.search(name)
        if m:
            counts[_TRACE_KEY[m.group(1)]] += 1
            for tag, suffix in (("bfloat16", BF16_SUFFIX),
                                ("__half", FP16_SUFFIX)):
                if tag in name:  # the bf16 / fp16 instantiation
                    key = _TRACE_KEY[m.group(1)] + suffix
                    counts[key] = counts.get(key, 0) + 1
        elif "spin_kernel" in name:
            spins.append(ns)
    top = max(spins, default=0)
    counts["spin_long"] = sum(ns >= 0.75 * top for ns in spins)
    counts["spin_short"] = len(spins) - counts["spin_long"]
    return counts


class TracedLaunches:
    """The port's kernels as the card ran them while entered: with
    ``on``, a ``torch.profiler`` trace of the device's activity (each
    kernel a CUDA graph replays is a record of its own) counted by
    device function (``traced_launches``) is ``launches``, and what the
    wrappers counted meanwhile (a graph's replays by the launches its
    capture recorded) must equal it, kernel by kernel; a kernel counted
    that ``TRACE_FUNCTIONS`` lacks fails (the paged wrappers are counted
    together, as "paged_attention").  ``TRACE_FILLERS`` spin
    kernels open and close the trace (``spin_fill``; a line is printed
    if the trace lost any).  Without ``on`` (an eager path, where each
    count is a launch), ``launches`` is the wrappers' counts.  ``label``
    names the region in a failure."""

    def __init__(self, torch, ck, label, on=True):
        self.torch, self.ck, self.label, self.on = torch, ck, label, on
        self.launches = self.counted = None
        self.bf16_launches, self.fp16_launches = {}, {}

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.before = launch_counts(self.ck)
        self.prof = None
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            spin_fill(self.torch)
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        if self.prof is not None:
            spin_fill(self.torch, TRACE_FILLER_CYCLES // 2)
            self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        now = launch_counts(self.ck)
        self.counted = {k: now[k] - self.before.get(k, 0) for k in now}
        if not self.on:
            self.launches = dict(self.counted)
            return False
        traced = traced_launches(self.prof)
        self.prof = None
        self.bf16_launches, self.fp16_launches = (
            {k[:-len(sfx)]: traced.pop(k) for k in list(traced)
             if k.endswith(sfx)} for sfx in (BF16_SUFFIX, FP16_SUFFIX))
        spins = (traced.pop("spin_long"), traced.pop("spin_short"))
        if spins != (TRACE_FILLERS, TRACE_FILLERS):
            print(json.dumps({"trace_fillers": {
                "region": self.label, "launched": TRACE_FILLERS,
                "traced_first": spins[0], "traced_last": spins[1]}}))
        self.counted["paged_attention"] = sum(self.counted.get(k, 0)
                                              for k in PAGED_GROUP)
        untraced = [k for k, n in self.counted.items()
                    if n and k not in traced and k not in PAGED_GROUP]
        check(not untraced, f"{self.label}: {untraced} launched, and the "
              f"trace names no device function of theirs")
        off = {k: (self.counted.get(k, 0), n) for k, n in traced.items()
               if self.counted.get(k, 0) != n}
        check(not off, f"{self.label}: (counted, traced) launches differ: "
              f"{off}")
        self.launches = {**self.counted, **traced}
        return False


@contextlib.contextmanager
def env_value(name, value):
    """The environment variable ``name`` = ``value`` while entered."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def fused_env(value):
    """``MXNET_FUSED_STEP`` = ``value`` while entered: a module made
    meanwhile (it reads the switch at construction, a BucketingModule's
    bucket modules when they are made) takes the eager path for "0"."""
    return env_value("MXNET_FUSED_STEP", value)


def graph_stats(mod):
    """``mod.graph_stats()``: where the fused step and the inference
    forward run (None for a port without the fused step, a parent
    checkout under ``--paths``)."""
    stats = getattr(mod, "graph_stats", None)
    return stats() if stats is not None else None


def fused_report(label, stats, p50, eager_p50, captured=True):
    """Print the fused step's line of a path: whether it runs as CUDA
    graphs (or the ops that keep it uncaptured), the graphs held, the
    captures, their time and the pool bytes they added, beside the
    path's step p50 and the eager path's from this run.  With
    ``captured`` the path must have captured a graph."""
    rec = {"path": label, "step_p50_ms": p50, "eager_step_p50_ms": eager_p50}
    if stats is not None:
        rec.update(stats)
        check(not captured or (stats["graphs_on"] and stats["captures"] > 0),
              f"{label}: the fused step ran no CUDA graph: {stats}")
    print(json.dumps({"fused_step": rec}))
    return rec


# steps that time a step's device time (after one more); inference
# forwards of a module that capture its graph and replay it (the fused
# step's two warm-up calls, the capture, a replay)
STEP_PROFILE_REPS, INFERENCE_FORWARDS = 3, 4


def step_device_ms(torch, fn, reps=STEP_PROFILE_REPS):
    """Device ms a call of ``fn`` (called once first, then ``reps``
    times under ``torch.profiler`` and ``reps`` times between CUDA
    events): the kernels' own time (those a CUDA graph replays
    included) and the events' span, the device's idle gaps included."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = sum(e.self_device_time_total for e in prof.key_averages()
                  if str(e.device_type) != "DeviceType.CPU") / reps / 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return {"kernels_ms": kernels, "span_ms": start.elapsed_time(end) / reps}


def graphs_on(mod):
    """True where ``mod`` (a ``Module``, or a bound ``BucketingModule``)
    runs its steps as CUDA graphs."""
    stats = graph_stats(mod)
    return bool(stats and stats["graphs_on"])


def train_steps(torch, ck, mod, batches, kernels, grad_names, label,
                user_kernels=(), after_step=None, opt=None):
    """``TRAIN_STEPS`` steps of a bound LM module under ``opt``
    ((optimizer, its parameters); SGD at ``TRAIN_LR`` with momentum 0.9
    by default), the launch counts reset just before and read just after:
    every step must count a launch of each of ``kernels`` and
    ``user_kernels`` (of ``rtc``) a layer and none of the other
    attention family's kernels (a dropped attention gradient shows as 0
    backward launches), every gradient of ``grad_names`` must be finite
    and non-zero, and the mean loss of the last 3 steps must be below
    the first step's.  Under CUDA graphs the steps run inside
    ``TracedLaunches``: the launches are the trace's, which must hold
    ``TRAIN_STEPS`` a layer of each kernel.  ``after_step(step)`` runs
    after each step's checks."""
    L, T = GPT2_SMALL["num_layers"], GPT2_SMALL["max_len"]
    opt = opt or ("sgd", {"learning_rate": TRAIN_LR, "momentum": 0.9})
    mod.init_optimizer(optimizer=opt[0], optimizer_params=opt[1])
    grads = [mod._exec.grad_dict[n]._data for n in grad_names]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    reset_launch_counts(ck)  # counts from here on: this training path
    traced = TracedLaunches(torch, ck, label, on=graphs_on(mod))
    traced.__enter__()
    t0 = time.perf_counter()
    for step, batch in enumerate(batches):
        before = launch_counts(ck)
        ts = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        now = launch_counts(ck)
        for k in DPA_KERNELS + PACKED_KERNELS + tuple(user_kernels):
            n = now[k] - before[k]
            want = L if k in tuple(kernels) + tuple(user_kernels) else 0
            check(n == want, f"{label} step {step}: {k} launched {n} "
                  f"times, not {want}")
        # summed in float32: an fp16 gradient's sum may pass 65504
        sums = torch.stack([g.float().abs().sum() for g in grads]).cpu()
        check(bool(torch.isfinite(sums).all() and (sums > 0).all()),
              f"{label} step {step}: a gradient of {grad_names} is zero or "
              f"not finite: {sums.tolist()}")
        out = mod.get_outputs()[0].asnumpy()
        check(out.shape == (TRAIN_BATCH, T), f"loss shape {out.shape}")
        losses.append(float(out.mean()))
        check(np.isfinite(losses[-1]), f"{label} loss not finite: {losses}")
        if after_step is not None:
            after_step(step)
    wall = time.perf_counter() - t0
    traced.__exit__(None, None, None)
    launches = traced.launches
    for k in DPA_KERNELS + PACKED_KERNELS + tuple(user_kernels):
        want = L * TRAIN_STEPS \
            if k in tuple(kernels) + tuple(user_kernels) else 0
        check(launches[k] == want, f"{label}: {k} launched {launches[k]} "
              f"times in {TRAIN_STEPS} steps, not {want}")
    peak = torch.cuda.max_memory_allocated()
    check(len(losses) == TRAIN_STEPS, f"{len(losses)} {label} steps")
    check(np.mean(losses[-3:]) < losses[0],
          f"{label} loss did not fall over {TRAIN_STEPS} steps: {losses}")
    print(f"{label} loss curve: {losses}")
    return {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq_len": T,
            "optimizer": opt[0], **opt[1], "losses": losses,
            "bf16_launches": traced.bf16_launches,
            "fp16_launches": traced.fp16_launches, "wall_s": wall,
            "tokens_per_s": TRAIN_STEPS * TRAIN_BATCH * T / wall,
            "step_ms": step_ms, "step_p50_ms": float(np.median(step_ms)),
            "peak_memory_bytes": int(peak), "launches": launches,
            "graphs": graph_stats(mod)}


def lm_train_pair(torch, mt, ck, make_mod, batches, kernels, grad_names,
                  label, user_kernels=(), compare=True, probe=None,
                  eager=True, keep=None, tally=None, opt=None,
                  dtype="float32", after_step=None):
    """``train_steps`` of a fresh ``make_mod()`` through the fused step
    (the default: warm-up steps, a capture, replays), then the device
    time of a step (``step_device_ms``, ``STEP_PROFILE_REPS`` + 1 more
    steps); with ``eager``, the same again from the same parameters
    under ``MXNET_FUSED_STEP=0``, and with ``compare`` (a dropout-free
    LM) each graphed step's mean loss within ``TOL`` of the eager one's
    (relative) and the ``grad_names`` weights after the last step within
    ``BWD_TOL`` (of max(1, max|w|)).  The record is the fused run's,
    with the eager run's p50, losses and device time beside it.  A
    ``probe`` (``ReplayMasks``) is entered around the fused run's steps
    and checks each; ``keep(mod)`` sees the fused module last;
    ``tally(launches)`` takes each run's ``train_steps`` launches (a
    phase's ``Launches.add``).  ``opt`` as ``train_steps``'; ``dtype``
    the network's, which picks ``TOL`` and ``BWD_TOL``; ``after_step``
    runs after each fused step (``train_steps``), unless a ``probe``
    does."""
    first = next(iter(batches))
    batches.reset()

    def run(mod, tag, probe, hook=None):
        with probe or contextlib.nullcontext():
            rec = train_steps(torch, ck, mod, batches, kernels, grad_names,
                              tag, user_kernels,
                              probe.after_step if probe else hook, opt)
        if tally is not None:
            tally(rec["launches"])
        weights = {n: mod._exec.arg_dict[n]._data.clone()
                   for n in grad_names} if compare else None

        def step():
            mod.forward_backward(first)
            mod.update()

        rec["step_device_ms"] = step_device_ms(torch, step)
        batches.reset()
        return rec, weights

    mod = make_mod()
    rec, fused_w = run(mod, label, probe, after_step)
    if keep is not None:
        keep(mod)
    del mod
    torch.cuda.empty_cache()
    eager_p50 = None
    if eager:
        with fused_env("0"):
            emod = make_mod()
        erec, eager_w = run(emod, f"{label} (eager)", None)
        del emod
        torch.cuda.empty_cache()
        eager_p50 = erec["step_p50_ms"]
        rec.update(eager_step_p50_ms=eager_p50, eager_losses=erec["losses"],
                   eager_step_device_ms=erec["step_device_ms"],
                   eager_peak_memory_bytes=erec["peak_memory_bytes"])
        if compare:
            loss_err = max(abs(a - b) / (TOL[dtype] * abs(b))
                           for a, b in zip(rec["losses"], erec["losses"]))
            w_err = max((fused_w[n] - eager_w[n]).abs().max().item()
                        / (BWD_TOL[dtype]
                           * max(1.0, eager_w[n].abs().max().item()))
                        for n in grad_names)
            rec["graphed_vs_eager_err_over_tol"] = {"loss": loss_err,
                                                    "weights": w_err}
            check(loss_err <= 1 and w_err <= 1, f"{label}: the graphed "
                  f"steps miss the eager ones (error over tolerance: loss "
                  f"{loss_err}, weights {w_err})")
    fused_report(label, rec["graphs"], rec["step_p50_ms"], eager_p50)
    return rec


def packed_lm_symbol(mt, dropout=0.0, dtype="float32"):
    V, L, T = GPT2_SMALL["vocab_size"], GPT2_SMALL["num_layers"], \
        GPT2_SMALL["max_len"]
    return mt.models.transformer_lm(V, T, num_layers=L, num_heads=H,
                                    d_model=GPT2_SMALL["d_model"],
                                    d_ff=GPT2_SMALL["d_ff"], head="ce",
                                    dropout=dropout, dtype=dtype)


def train_path(torch, mt, ck, eager=True):
    """10 SGD steps of the GPT-2-small-class LM through ``Module``'s
    fused step, against the eager path (``lm_train_pair``)."""
    L = GPT2_SMALL["num_layers"]
    params = gpt2_small_params(0)
    return lm_train_pair(
        torch, mt, ck, lambda: lm_module(mt, packed_lm_symbol(mt), params),
        lm_batches(mt), PACKED_KERNELS,
        [f"layer{i}_qkv_weight" for i in range(L)], "training", eager=eager)


def dpa_lm_symbol(sym, vocab, seq_len, num_layers, num_heads, d_model,
                  d_ff, layout="BTHD", gelu_op=None):
    """The GPT-2-class LM of ``transformer_lm(..., head="ce")`` with its
    attention written as a user writes it, in the symbol namespace
    ``sym`` (``mt.sym`` or the JAX package's ``mx.sym``): per layer,
    ``layer{i}_q``/``_k``/``_v`` ``FullyConnected(flatten=False)`` →
    ``Reshape`` to (B, T, H, D) (``BHTD``: then ``transpose`` to
    (B, H, T, D)) → ``DotProductAttention(causal=True)`` → back to
    (B, T, H*D) → ``layer{i}_proj``.  With ``split_qkv_params`` weights
    it computes what ``transformer_lm`` computes.  ``gelu_op`` names a
    registered op (a user kernel, ``register_user_gelu``) that takes the
    place of each feed-forward ``Activation(act_type="gelu")``."""
    Dh = d_model // num_heads
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    x = sym.Embedding(data, input_dim=vocab, output_dim=d_model,
                      name="tok_embed")
    pos = sym.Variable("pos_embed_weight", shape=(seq_len, d_model),
                       init="[\"zero\", {}]")
    x = sym.broadcast_add(x, sym.expand_dims(pos, axis=0))
    for i in range(num_layers):
        name = f"layer{i}"
        h = sym.LayerNorm(x, name=f"{name}_ln1")
        qkv = []
        for part in "qkv":
            t = sym.FullyConnected(h, num_hidden=d_model, flatten=False,
                                   name=f"{name}_{part}")
            t = sym.Reshape(t, shape=(0, 0, num_heads, Dh))
            if layout == "BHTD":
                t = sym.transpose(t, axes=(0, 2, 1, 3))
            qkv.append(t)
        a = sym.DotProductAttention(*qkv, causal=True, layout=layout,
                                    name=f"{name}_attn")
        if layout == "BHTD":
            a = sym.transpose(a, axes=(0, 2, 1, 3))
        a = sym.Reshape(a, shape=(0, 0, d_model))
        x = x + sym.FullyConnected(a, num_hidden=d_model, flatten=False,
                                   name=f"{name}_proj")
        h = sym.LayerNorm(x, name=f"{name}_ln2")
        h = sym.FullyConnected(h, num_hidden=d_ff, flatten=False,
                               name=f"{name}_ff1")
        h = getattr(sym, gelu_op)(h, name=f"{name}_gelu") if gelu_op \
            else sym.Activation(h, act_type="gelu", name=f"{name}_gelu")
        x = x + sym.FullyConnected(h, num_hidden=d_model, flatten=False,
                                   name=f"{name}_ff2")
    x = sym.LayerNorm(x, name="ln_f")
    logits = sym.FullyConnected(x, num_hidden=vocab, flatten=False,
                                name="head")
    return sym.SoftmaxCELoss(logits, label, use_ignore=True, ignore_label=0,
                             name="softmax")


def split_qkv_params(params, num_layers):
    """``transformer_lm`` weights for ``dpa_lm_symbol``: each packed
    ``layer{i}_qkv_weight`` (3*d, d) and ``_bias`` (3*d,) cut into row
    thirds [q | k | v]."""
    out = {k: v for k, v in params.items() if "_qkv_" not in k}
    for i in range(num_layers):
        for kind in ("weight", "bias"):
            packed = params[f"layer{i}_qkv_{kind}"]
            n = packed.shape[0] // 3
            for j, part in enumerate("qkv"):
                out[f"layer{i}_{part}_{kind}"] = packed[j * n:(j + 1) * n]
    return out


# ---------------------------------------------------------------------------
# user kernels: this script is a user of mt.rtc (the port of rtc.pallas_op)
# ---------------------------------------------------------------------------

# exact-erf GELU, 0.5 x (1 + erf(x / sqrt 2)), and its VJP
# g (Phi(x) + x phi(x)), fp32, grid-stride over float4 (one float4 a
# thread a pass when every pointer is 16-byte aligned, then the tail)
GELU_SOURCE = r"""
__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__global__ void user_gelu(const float* __restrict__ x, float* __restrict__ y,
                          long long n) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const bool vec = (((unsigned long long)x | (unsigned long long)y) & 15) == 0;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = tid; i < n4; i += stride) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    v.x = gelu(v.x); v.y = gelu(v.y); v.z = gelu(v.z); v.w = gelu(v.w);
    reinterpret_cast<float4*>(y)[i] = v;
  }
  for (long long i = n4 * 4 + tid; i < n; i += stride) y[i] = gelu(x[i]);
}
"""
GELU_GRAD_SOURCE = r"""
__device__ __forceinline__ float gelu_grad(float x, float g) {
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  const float pdf = expf(-0.5f * x * x) * 0.39894228040143268f;
  return g * (cdf + x * pdf);
}

__global__ void user_gelu_grad(const float* __restrict__ x,
                               const float* __restrict__ g,
                               float* __restrict__ dx, long long n) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const bool vec = (((unsigned long long)x | (unsigned long long)g |
                     (unsigned long long)dx) & 15) == 0;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = tid; i < n4; i += stride) {
    const float4 a = reinterpret_cast<const float4*>(x)[i];
    const float4 b = reinterpret_cast<const float4*>(g)[i];
    float4 r;
    r.x = gelu_grad(a.x, b.x); r.y = gelu_grad(a.y, b.y);
    r.z = gelu_grad(a.z, b.z); r.w = gelu_grad(a.w, b.w);
    reinterpret_cast<float4*>(dx)[i] = r;
  }
  for (long long i = n4 * 4 + tid; i < n; i += stride)
    dx[i] = gelu_grad(x[i], g[i]);
}
"""
# the two API checks of tests/test_rtc.py: an output shaped (rows, 1),
# one thread a row; and a tiled kernel, one 128 x 128 tile a block
ROWSUM_SOURCE = r"""
__global__ void rowsum(const float* __restrict__ x, float* __restrict__ y,
                       long long rows, long long cols) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float acc = 0.0f;
  for (long long c = 0; c < cols; ++c) acc += x[r * cols + c];
  y[r] = acc;
}
"""
TILED_SCALE_SOURCE = r"""
__global__ void tiled_scale(const float* __restrict__ x,
                            float* __restrict__ y, long long rows,
                            long long cols) {
  const long long r0 = (long long)blockIdx.y * 128;
  const long long c0 = (long long)blockIdx.x * 128;
  for (int r = threadIdx.y; r < 128; r += blockDim.y)
    for (int c = threadIdx.x; c < 128; c += blockDim.x) {
      const long long i = r0 + r, j = c0 + c;
      if (i < rows && j < cols) y[i * cols + j] = 3.0f * x[i * cols + j];
    }
}
"""
USER_BLOCK = 256
# operations an element (a transcendental counted as one), for bound_ms
USER_FLOPS = {"user_silu": 4, "user_silu_grad": 9, "user_gelu": 5,
              "user_gelu_grad": 11}


def float4_grid(x, *rest):
    """One float4 a thread: ceil(n / (4 * USER_BLOCK)) blocks."""
    return (-(-x.numel() // (4 * USER_BLOCK)),)


def gelu_plain(torch, x):
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def gelu_grad_plain(torch, x, g):
    cdf = 0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
    pdf = torch.exp(-0.5 * x * x) * 0.3989422804014327
    return g * (cdf + x * pdf)


def register_user_gelu(torch, mt, name="user_gelu"):
    """Exact-erf GELU as a user CUDA op ``name`` whose VJP launches a
    second user kernel, ``<name>_grad``; their plain versions are the CPU
    route.  Returns the two kernels."""
    grad = mt.rtc.cuda_kernel(GELU_GRAD_SOURCE, "user_gelu_grad",
                              grid=float4_grid, block=USER_BLOCK,
                              plain=lambda x, g: gelu_grad_plain(torch, x, g),
                              name=f"{name}_grad")

    def vjp(inputs, out_grads):
        return (grad(inputs[0], out_grads[0]),)

    op = mt.rtc.cuda_op(name, GELU_SOURCE, "user_gelu", grid=float4_grid,
                        block=USER_BLOCK,
                        plain=lambda x: gelu_plain(torch, x), vjp=vjp)
    return op.kernel, grad


def register_api_ops(torch, mt, suffix=""):
    """The three ops of ``tests/test_rtc.py``'s API checks, named with
    ``suffix``: ``axpb`` (``register_op`` of a torch function), ``rowsum``
    (an output of another shape, through a callable ``out_like`` and
    ``infer_shape``) and ``tiled_scale`` (a 2 x 2 grid of 128 x 128
    tiles through ``grid``/``block``) → their names and the two
    kernels."""
    names = {k: f"{k}{suffix}" for k in ("axpb", "rowsum", "tiled_scale")}
    mt.rtc.register_op(names["axpb"], lambda x: 2.0 * x + 1.0)
    mt.rtc.cuda_op(
        names["rowsum"], ROWSUM_SOURCE, "rowsum",
        out_like=lambda x: ((x.shape[0], 1), x.dtype),
        scalars=lambda x: (x.shape[0], x.shape[1]),
        plain=lambda x: x.sum(1, keepdim=True),
        infer_shape=lambda s: (s[0], 1))
    mt.rtc.cuda_op(
        names["tiled_scale"], TILED_SCALE_SOURCE, "tiled_scale",
        grid=(2, 2), block=(32, 8), scalars=lambda x: tuple(x.shape),
        plain=lambda x: x * 3.0)
    return names, [mt.ops.registry.get_op(names[k]).kernel
                   for k in ("rowsum", "tiled_scale")]


def first_step(torch, mt, ck, sym, params, batch, grads, want,
               user_kernels=()):
    """One ``forward_backward`` of a fresh module on ``batch``, the
    launch counts reset just before and read just after (each kernel of
    ``want`` and ``user_kernels`` 12 times, the others of both attention
    families 0); returns (mean loss, launches, host copies of the
    ``grads`` gradients).  The module is released before returning."""
    L = GPT2_SMALL["num_layers"]
    mod = lm_module(mt, sym, params)
    torch.cuda.synchronize()
    reset_launch_counts(ck)
    mod.forward_backward(batch)
    torch.cuda.synchronize()
    launches = launch_counts(ck)
    for name in DPA_KERNELS + PACKED_KERNELS + tuple(user_kernels):
        n = L if name in tuple(want) + tuple(user_kernels) else 0
        check(launches[name] == n, f"first step: {name} launched "
              f"{launches[name]} times, expected {n}")
    loss = float(mod.get_outputs()[0].asnumpy().mean())
    out = {n: mod._exec.grad_dict[n]._data.cpu() for n in grads}
    del mod
    torch.cuda.empty_cache()
    return loss, launches, out


def dpa_path(torch, mt, ck, eager=True):
    """The GPT-2-small-class LM over user-written attention symbols
    (``dpa_lm_symbol``) through ``Module``: first the check step against
    the packed ``transformer_lm`` on the same weights and batch (and the
    BHTD variant), then ``TRAIN_STEPS`` SGD steps of the fused step
    against the eager path (``lm_train_pair``)."""
    V, L, T = GPT2_SMALL["vocab_size"], GPT2_SMALL["num_layers"], \
        GPT2_SMALL["max_len"]
    dm, dff = GPT2_SMALL["d_model"], GPT2_SMALL["d_ff"]
    packed_params = gpt2_small_params(0)
    params = split_qkv_params(packed_params, L)
    batches = lm_batches(mt)
    first = next(batches)
    qkv_names = [f"layer{i}_{p}_weight" for i in range(L) for p in "qkv"]

    ref_loss, _, ref = first_step(
        torch, mt, ck, packed_lm_symbol(mt), packed_params, first,
        [f"layer{i}_qkv_weight" for i in range(L)], PACKED_KERNELS)
    check_launches = {}
    agreement = {}
    for layout in ("BHTD", "BTHD"):
        sym = dpa_lm_symbol(mt.sym, V, T, L, H, dm, dff, layout=layout)
        loss, launches, grads = first_step(torch, mt, ck, sym, params, first,
                                           qkv_names, DPA_KERNELS)
        for k, n in launches.items():
            check_launches[k] = check_launches.get(k, 0) + n
        check(abs(loss - ref_loss) <= 1e-4 * abs(ref_loss),
              f"DPA LM ({layout}) first-step loss {loss} vs the packed "
              f"LM's {ref_loss}")
        worst = 0.0
        for i in range(L):
            thirds = ref[f"layer{i}_qkv_weight"].chunk(3, dim=0)
            for part, want in zip("qkv", thirds):
                got = grads[f"layer{i}_{part}_weight"]
                err = (got - want).abs().max().item()
                tol = BWD_TOL["float32"] * max(1.0, want.abs().max().item())
                check(err <= tol, f"DPA LM ({layout}) layer{i}_{part}_weight "
                      f"gradient: max_abs_err {err} over {tol} against the "
                      f"packed LM's qkv_weight third")
                worst = max(worst, err / tol)
        agreement[layout] = {"loss": loss,
                             "qkv_grad_err_over_tol_max": worst}
    print(f"DPA LM first step: {agreement}, packed LM loss {ref_loss}")

    sym = dpa_lm_symbol(mt.sym, V, T, L, H, dm, dff)
    batches.reset()
    rec = lm_train_pair(torch, mt, ck, lambda: lm_module(mt, sym, params),
                        batches, DPA_KERNELS, qkv_names, "DPA training",
                        eager=eager)
    for k, n in check_launches.items():
        rec["launches"][k] += n
    rec["first_step_vs_packed"] = dict(agreement, packed_loss=ref_loss)
    return rec


def default_lm_path(torch, mt, ck):
    """``transformer_lm`` at its own defaults (``DEFAULT_LM``: 4 heads of
    width 32) on the card, through B1's 32-lane instantiations and the
    paged kernels': serving 8 greedy requests (fp32 pages, 24-400 token
    prompts, 16 new tokens), B1's forward 4 times a prefill and the
    decode kernel 4 times a step, the full forward reproducing the
    greedy tokens; then one ``forward_backward`` through ``Module`` at
    batch ``DEFAULT_LM_BATCH`` x 512 on ``gpu(0)``, B1's three kernels 4
    times each, held against the same step run by the port on the CPU
    (mean loss to 1e-4 relative, every weight gradient within
    ``BWD_TOL``).  Launch counts reset just before each run and read
    just after."""
    cfg = DEFAULT_LM
    V, L, T = cfg["vocab_size"], cfg["num_layers"], cfg["max_len"]
    NH, dm = cfg["num_heads"], cfg["d_model"]
    params = gpt2_small_params(5, cfg)
    rng = np.random.RandomState(6)
    lens = rng.randint(24, 401, size=8)
    prompts = [rng.randint(1, V, size=n).astype(np.int32) for n in lens]
    temps = [0.0] * len(prompts)
    dev_params = mt.params_from_numpy(params, "cuda")
    model, outs, st, launches, serving = serve_run(
        torch, mt, ck, dev_params, prompts, temps, 16, cfg=cfg)
    check(launches["flash_mha_packed"] == L * st["prefills"] > 0
          and launches["paged_attention_decode"] == L * st["steps"] > 0,
          f"default LM serving: {launches} for {st['prefills']} prefills "
          f"and {st['steps']} steps")
    forward_check(torch, model, prompts, outs, temps, lens, "default LM")
    del model, dev_params
    torch.cuda.empty_cache()

    sym = mt.models.transformer_lm(V, T, num_layers=L, num_heads=NH,
                                   d_model=dm, d_ff=cfg["d_ff"], head="ce")
    X, Y = random_walk_tokens(V, T, DEFAULT_LM_BATCH, seed=9)
    batch = next(mt.io.NDArrayIter(X, Y, batch_size=DEFAULT_LM_BATCH))
    weights = sorted(n for n in params if n.endswith("_weight"))
    steps = {}
    for ctx in (mt.gpu(0), mt.cpu()):
        mod = mt.mod.Module(sym, context=ctx)
        mod.bind(data_shapes=[("data", (DEFAULT_LM_BATCH, T))],
                 label_shapes=[("softmax_label", (DEFAULT_LM_BATCH, T))])
        mod.init_params(arg_params=params)
        torch.cuda.synchronize()
        reset_launch_counts(ck)
        mod.forward_backward(batch)
        torch.cuda.synchronize()
        steps[ctx.device_type] = (
            float(mod.get_outputs()[0].asnumpy().mean()), launch_counts(ck),
            {n: mod._exec.grad_dict[n]._data.cpu() for n in weights})
        del mod
    torch.cuda.empty_cache()
    (loss, train_launches, grads), (ref_loss, cpu_launches, ref) = \
        steps["gpu"], steps["cpu"]
    for name in PACKED_KERNELS + DPA_KERNELS:
        want = L if name in PACKED_KERNELS else 0
        check(train_launches[name] == want and cpu_launches[name] == 0,
              f"default LM step: {name} launched {train_launches[name]} "
              f"times on the card ({cpu_launches[name]} on the CPU), "
              f"expected {want}")
    check(abs(loss - ref_loss) <= 1e-4 * abs(ref_loss),
          f"default LM step: loss {loss} on the card vs {ref_loss} on the "
          f"CPU")
    worst = 0.0
    for n in weights:
        tol = BWD_TOL["float32"] * max(1.0, ref[n].abs().max().item())
        err = (grads[n] - ref[n]).abs().max().item()
        check(bool(torch.isfinite(grads[n]).all()) and err <= tol,
              f"default LM step: {n} gradient max_abs_err {err} over {tol} "
              f"against the CPU step")
        worst = max(worst, err / tol)
    print(f"default LM step: loss {loss} (CPU {ref_loss}), weight "
          f"gradients at {worst} of BWD_TOL")
    return {"config": dict(cfg), "head_dim": dm // NH, "serving": serving,
            "train_step": {"batch": DEFAULT_LM_BATCH, "seq_len": T,
                           "loss": loss, "cpu_loss": ref_loss,
                           "grad_err_over_tol_max": worst,
                           "launches": train_launches},
            "launches": {k: n + train_launches.get(k, 0)
                         for k, n in launches.items()}}


def imperative_check(torch, mt, ck):
    """``mt.nd.DotProductAttention`` on ``gpu(0)`` NDArrays: one
    ``flash_mha`` launch, equal to the plain version."""
    rng = np.random.RandomState(4)
    q, k, v = (mt.nd.array(rng.randn(2, 100, H, D).astype(np.float32),
                           ctx=mt.gpu(0)) for _ in range(3))
    ck.reset_launch_counts()
    out = mt.nd.DotProductAttention(q, k, v, causal="True")
    torch.cuda.synchronize()
    launches = ck.LAUNCHES["flash_mha"]
    check(launches == 1 and sum(ck.LAUNCHES.values()) == 1,
          f"mt.nd.DotProductAttention launched {dict(ck.LAUNCHES)}")
    ref, _ = ck.flash_mha_plain(*(x._data.transpose(1, 2) for x in (q, k, v)),
                                causal=True)
    err = (out._data - ref.transpose(1, 2)).abs().max().item()
    check(out.shape == q.shape and out.context == mt.gpu(0)
          and err <= TOL["float32"], f"mt.nd.DotProductAttention: shape "
          f"{out.shape}, context {out.context}, max_abs_err {err}")
    return {"shape": list(q.shape), "launches": launches,
            "max_abs_err": err}


def check_user_kernel(torch, kernel, shape, plain, library, flops, n_in,
                      dtype="float32"):
    """A user kernel against its plain version on seeded inputs of
    ``shape`` and ``dtype``, timed beside the plain version, ``library``
    (one PyTorch call computing the same function) and its bound: each
    input read once, the output written once, ``flops`` float32
    operations an element (the kernels compute in float32 whatever they
    store)."""
    g = torch.Generator(device="cuda").manual_seed(len(kernel.name))
    xs = [torch.randn(shape, generator=g, device="cuda").to(
        getattr(torch, dtype)) for _ in range(n_in)]
    got, ref = kernel(*xs), plain(*xs)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    check(bool(torch.isfinite(got).all()) and got.dtype == ref.dtype
          and err <= TOL[dtype],
          f"{kernel.name} {shape} {dtype}: max_abs_err {err} over "
          f"{TOL[dtype]}")
    n = got.numel()
    b_ms, b_by = bound((n_in + 1) * n * got.element_size(), flops * n,
                       "float32")
    return {"kernel": kernel.name, "shape": "x".join(map(str, shape)),
            "dtype": dtype, "max_abs_err": err, "tol": TOL[dtype],
            "ms": time_ms(torch, lambda: kernel(*xs)),
            "plain_ms": time_ms(torch, lambda: plain(*xs)),
            "library_ms": time_ms(torch, lambda: library(*xs)),
            "bound_ms": b_ms, "bound_by": b_by,
            "back_to_back_ms": back_to_back_ms(torch, lambda: kernel(*xs)),
            "library_back_to_back_ms": back_to_back_ms(
                torch, lambda: library(*xs))}


def user_kernel_checks(torch, F, ex, gelu_kernels):
    """The four timed user kernels, SiLU and GELU and their VJPs, at the
    shapes of their paths: the example's (16, 32) batch of FC(32)
    outputs, and the GELU LM's FFN activation (8, 1024, 3072).  The SiLU
    pair is also held and timed at (8192, 3072), a GPT-2-small FFN batch
    of 8 x 1024 flattened, which no path runs.  The library yardsticks
    are ``F.silu``/``F.gelu`` and aten's ``silu_backward``/
    ``gelu_backward``, the calls their autograd backward makes.  Returns
    (the rows at the paths' shapes, the extra rows)."""
    aten = torch.ops.aten
    gelu, gelu_grad = gelu_kernels
    silu = (ex.register().kernel, ex.silu_plain, F.silu,
            USER_FLOPS["user_silu"], 1)
    silu_grad = (ex.silu_grad, ex.silu_grad_plain,
                 lambda x, g: aten.silu_backward(g, x),
                 USER_FLOPS["user_silu_grad"], 2)
    ffn = (TRAIN_BATCH, 1024, GPT2_SMALL["d_ff"])
    path = [
        check_user_kernel(torch, silu[0], (16, 32), *silu[1:]),
        check_user_kernel(torch, silu_grad[0], (16, 32), *silu_grad[1:]),
        check_user_kernel(torch, gelu, ffn, lambda x: gelu_plain(torch, x),
                          lambda x: F.gelu(x, approximate="none"),
                          USER_FLOPS["user_gelu"], 1),
        check_user_kernel(torch, gelu_grad, ffn,
                          lambda x, g: gelu_grad_plain(torch, x, g),
                          lambda x, g: aten.gelu_backward(
                              g, x, approximate="none"),
                          USER_FLOPS["user_gelu_grad"], 2)]
    big = (8192, 3072)
    extra = [check_user_kernel(torch, silu[0], big, *silu[1:]),
             check_user_kernel(torch, silu_grad[0], big, *silu_grad[1:])]
    return path, extra


def triton_kernel_checks(torch, F, tex):
    """The Triton example's kernels (``rtc.triton_op``), SiLU and its
    VJP, against their plain versions in fp32 and bf16 at the example's
    (16, 32) batch and at (8, 1024, 3072), the GELU LM's FFN activation,
    timed beside ``F.silu`` and aten's ``silu_backward`` and the byte
    bound.  Triton compiles each (kernel, dtype) at its first call here.
    Returns (the fp32 rows at the example's shape, the other rows)."""
    aten = torch.ops.aten
    silu = (tex.register().kernel, tex.silu_plain, F.silu,
            USER_FLOPS["user_silu"], 1)
    silu_grad = (tex.silu_grad, tex.silu_grad_plain,
                 lambda x, g: aten.silu_backward(g, x),
                 USER_FLOPS["user_silu_grad"], 2)
    rows = [check_user_kernel(torch, k[0], shape, *k[1:], dtype=dtype)
            for shape in ((16, 32), (TRAIN_BATCH, 1024, GPT2_SMALL["d_ff"]))
            for dtype in ("float32", "bfloat16") for k in (silu, silu_grad)]
    return rows[:2], rows[2:]


def rtc_api_checks(torch, mt, names, ex):
    """The API on the card: ``register_op`` of ``axpb`` imperatively and
    through ``bind``; ``rowsum`` (output (rows, 1), ``sym.infer_shape``)
    and ``tiled_scale`` (a 2 x 2 grid of 128 x 128 tiles) equal to their
    plain versions, one launch each; a broken user source raises
    ``MXNetError`` with nvcc's output, and the run goes on; a ``cuda_op``
    without a VJP runs forward and raises when differentiated."""
    rtc, gpu = mt.rtc, mt.gpu(0)
    rng = np.random.RandomState(11)
    x = rng.randn(3, 4).astype(np.float32)
    axpb = getattr(mt.nd, names["axpb"])(mt.nd.array(x, ctx=gpu))
    check(axpb.context == gpu and np.allclose(axpb.asnumpy(), 2 * x + 1,
                                              rtol=1e-6),
          f"axpb on gpu(0): {axpb.context}")
    sym = getattr(mt.sym, names["axpb"])(mt.sym.Variable("data"))
    out = sym.bind(gpu, {"data": mt.nd.array(x, ctx=gpu)}).forward()[0]
    check(np.allclose(out.asnumpy(), 2 * x + 1, rtol=1e-6), "axpb via bind")

    reset = rtc.reset_launch_counts
    reset()
    xt = torch.from_numpy(x).cuda()
    rs = getattr(mt.nd, names["rowsum"])(mt.nd.array(x, ctx=gpu))
    want = xt.sum(1, keepdim=True)
    _, shapes, _ = getattr(mt.sym, names["rowsum"])(
        mt.sym.Variable("data")).infer_shape(data=(3, 4))
    check(rs.shape == (3, 1) and shapes == [(3, 1)]
          and (rs._data - want).abs().max().item() <= TOL["float32"]
          and rtc.LAUNCHES[names["rowsum"]] == 1,
          f"rowsum: shape {rs.shape}, infer_shape {shapes}, launches "
          f"{rtc.LAUNCHES[names['rowsum']]}")
    big = torch.arange(256 * 256, dtype=torch.float32, device="cuda")
    big = (big % 97).reshape(256, 256)
    ts = getattr(mt.nd, names["tiled_scale"])(mt.nd.NDArray(big, gpu))
    check(torch.equal(ts._data, big * 3.0)
          and rtc.LAUNCHES[names["tiled_scale"]] == 1,
          "tiled_scale: not 3x its input over the 2 x 2 grid of tiles")

    broken = rtc.cuda_kernel("__global__ void broken(float* x) "
                             "{ this is not C++; }\n", "broken",
                             name="smoke_broken_source")
    try:  # the one expected failure of the run
        broken(torch.ones(4, device="cuda"))
        build_failure = None
    except mt.MXNetError as e:
        build_failure = str(e)
    check(build_failure is not None and "nvcc failed" in build_failure
          and "error" in build_failure.split("\n", 1)[-1]
          and rtc.LAUNCHES["smoke_broken_source"] == 0,
          f"a broken user source did not raise with nvcc's output: "
          f"{build_failure!r}")

    novjp = "smoke_novjp_silu"
    rtc.cuda_op(novjp, ex.SILU_SOURCE, "user_silu", grid=ex.float4_grid,
                block=ex.BLOCK, plain=ex.silu_plain)
    net = getattr(mt.sym, novjp)(mt.sym.FullyConnected(
        mt.sym.Variable("data"), num_hidden=8, name="fc"))
    exe = net.simple_bind(gpu, data=(4, 5))
    exe.forward(is_train=True)
    try:  # differentiating a raw kernel without a VJP must raise
        exe.backward(out_grads=[mt.nd.ones((4, 8), ctx=gpu)])
        failure = None
    except mt.MXNetError as e:
        failure = str(e)
    check(failure is not None and novjp in failure and "no vjp" in failure
          and rtc.LAUNCHES[novjp] == 1,
          f"a cuda_op without vjp did not raise when differentiated: "
          f"{failure!r}")
    print(f"rtc API on gpu(0): axpb, rowsum, tiled_scale OK; the broken "
          f"source raised: {build_failure.splitlines()[:3]!r} ...; the "
          f"op without vjp raised: {failure!r}")
    return {"axpb": True, "rowsum_shape": list(rs.shape),
            "tiled_scale_grid": [2, 2], "broken_source_raised": True,
            "no_vjp_raised": True}


def example_path(torch, mt, ck, ex, op="user_silu"):
    """``examples/user_cuda_kernel.main(gpu(0))`` (or the Triton
    example's, ``op`` ``user_triton_silu``): the op imperatively, then
    ``Module.fit`` to accuracy > 0.85, each training batch counting a
    launch of ``op`` and one of ``<op>_grad``, under ``TracedLaunches``
    (the fit's steps are CUDA graphs)."""
    torch.cuda.synchronize()
    reset_launch_counts(ck)
    with TracedLaunches(torch, ck, "user kernel example") as traced:
        t0 = time.perf_counter()
        rec = ex.main(mt.gpu(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = traced.launches
    check(rec["accuracy"] > 0.85, f"example accuracy {rec['accuracy']}")
    check(rec["batches"] == 80 and set(rec["batch_launches"]) == {(1, 1)},
          f"example: {rec['batches']} batches, launches a batch "
          f"{sorted(set(rec['batch_launches']))}, not (1, 1)")
    check(launches[op] == 81 and launches[f"{op}_grad"] == 80,
          f"example launches {launches[op]} / {launches[f'{op}_grad']}, "
          f"not 81 / 80")
    return {"accuracy": rec["accuracy"], "batches": rec["batches"],
            "wall_s": wall, "launches": launches}


def gelu_lm_path(torch, mt, ck, gelu_name, dpa_step_p50_ms):
    """The DPA LM with its 12 GELUs a user kernel (``dpa_lm_symbol(...,
    gelu_op=)``), full width: its first step against the built-in-GELU
    DPA LM on the same weights and batch (mean loss to 1e-5 relative;
    ``ff1_weight`` and q/k/v weight gradients within ``BWD_TOL``), then
    ``TRAIN_STEPS`` SGD steps of the fused step against the eager path
    (``lm_train_pair``), each launching ``user_gelu``,
    ``user_gelu_grad`` and the three DPA kernels 12 times."""
    V, L, T = GPT2_SMALL["vocab_size"], GPT2_SMALL["num_layers"], \
        GPT2_SMALL["max_len"]
    dm, dff = GPT2_SMALL["d_model"], GPT2_SMALL["d_ff"]
    user = (gelu_name, f"{gelu_name}_grad")
    params = split_qkv_params(gpt2_small_params(0), L)
    batches = lm_batches(mt)
    first = next(batches)
    names = [f"layer{i}_{p}_weight" for i in range(L)
             for p in ("q", "k", "v", "ff1")]
    ref_loss, _, ref = first_step(
        torch, mt, ck, dpa_lm_symbol(mt.sym, V, T, L, H, dm, dff), params,
        first, names, DPA_KERNELS)
    sym = dpa_lm_symbol(mt.sym, V, T, L, H, dm, dff, gelu_op=gelu_name)
    loss, launches, grads = first_step(torch, mt, ck, sym, params, first,
                                       names, DPA_KERNELS, user)
    check(abs(loss - ref_loss) <= 1e-5 * abs(ref_loss),
          f"GELU LM first-step loss {loss} vs the built-in-GELU LM's "
          f"{ref_loss}")
    worst = 0.0
    for n in names:
        err = (grads[n] - ref[n]).abs().max().item()
        tol = BWD_TOL["float32"] * max(1.0, ref[n].abs().max().item())
        check(err <= tol, f"GELU LM {n} gradient: max_abs_err {err} over "
              f"{tol} against the built-in-GELU LM's")
        worst = max(worst, err / tol)
    print(f"GELU LM first step: loss {loss} (built-in GELU {ref_loss}), "
          f"gradient error over tolerance at most {worst}")
    batches.reset()
    rec = lm_train_pair(torch, mt, ck, lambda: lm_module(mt, sym, params),
                        batches, DPA_KERNELS,
                        [n for n in names if "ff1" in n or "_q_" in n],
                        "GELU LM training", user_kernels=user)
    for k, n in launches.items():
        rec["launches"][k] += n
    rec["first_step_vs_builtin_gelu"] = {
        "loss": loss, "builtin_loss": ref_loss,
        "grad_err_over_tol_max": worst}
    rec["dpa_step_p50_ms"] = dpa_step_p50_ms
    return rec


def _custom_sigmoid(mt, op_type):
    """A ``CustomOp`` sigmoid written with ``mt.nd`` ops, asserting its
    NDArrays lie on ``gpu(0)``."""
    op = mt.operator

    @op.register(op_type)
    class SigmoidProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes=None):
            return Sigmoid()

    class Sigmoid(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            check(in_data[0].context == mt.gpu(0)
                  and out_data[0].context == mt.gpu(0),
                  f"CustomOp forward got {in_data[0].context}")
            y = mt.nd.Activation(in_data[0], act_type="sigmoid")
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            check(all(a.context == mt.gpu(0) for a in
                      (out_grad[0], out_data[0], in_grad[0])),
                  "CustomOp backward NDArrays not on gpu(0)")
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1.0 - y))


def custom_op_path(torch, mt):
    """``test_custom_op.py``'s net, FC(8) → ``Custom(op_type=sigmoid)``
    → FC(2) → ``SoftmaxOutput``, on ``gpu(0)``: its first step against
    the same net with ``Activation(sigmoid)`` on the same seeded weights
    (outputs and every gradient to ``TOL``), then ``Module.fit`` for 10
    epochs (SGD 0.5, batch 20) with a finite, falling loss."""
    _custom_sigmoid(mt, "smoke_sigmoid")
    gpu = mt.gpu(0)
    rng = np.random.RandomState(2)
    X = rng.randn(80, 6).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.float32)
    init = {"fc1_weight": rng.randn(8, 6) * 0.3, "fc1_bias": np.zeros(8),
            "fc2_weight": rng.randn(2, 8) * 0.3, "fc2_bias": np.zeros(2)}
    init = {k: v.astype(np.float32) for k, v in init.items()}

    def net(custom):
        h = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=8,
                                  name="fc1")
        h = mt.sym.Custom(h, op_type="smoke_sigmoid", name="act") if custom \
            else mt.sym.Activation(h, act_type="sigmoid", name="act")
        h = mt.sym.FullyConnected(h, num_hidden=2, name="fc2")
        return mt.sym.SoftmaxOutput(h, name="softmax")

    batch = mt.io.DataBatch([mt.nd.array(X[:20], ctx=gpu)],
                            [mt.nd.array(y[:20], ctx=gpu)])
    steps = {}
    for custom in (False, True):
        mod = mt.mod.Module(net(custom), context=gpu)
        mod.bind(data_shapes=[("data", (20, 6))],
                 label_shapes=[("softmax_label", (20,))])
        mod.init_params(arg_params=init)
        mod.forward_backward(batch)
        steps[custom] = (mod.get_outputs()[0]._data.clone(),
                         {k: v._data.clone() for k, v in
                          mod._exec.grad_dict.items() if v is not None})
    (ref_out, ref_g), (out, grads) = steps[False], steps[True]
    err = max([(out - ref_out).abs().max().item()]
              + [(grads[k] - ref_g[k]).abs().max().item() for k in ref_g])
    check(sorted(grads) == sorted(ref_g) and err <= TOL["float32"],
          f"Custom sigmoid net's first step vs Activation(sigmoid): "
          f"max_abs_err {err}")

    losses = []

    def on_batch(p):
        prob = p.locals["self"].get_outputs()[0]._data
        lab = p.locals["data_batch"].label[0]._data.to(prob.device).long()
        losses.append(float(-prob.gather(1, lab[:, None]).log().mean()))

    mod = mt.mod.Module(net(True), context=gpu)
    t0 = time.perf_counter()
    mod.fit(mt.io.NDArrayIter(X, y, batch_size=20), num_epoch=10,
            optimizer="sgd", optimizer_params={"learning_rate": 0.5},
            arg_params=init, batch_end_callback=on_batch)
    wall = time.perf_counter() - t0
    # Custom runs Python per call: the fused step runs uncaptured
    stats = fused_report("CustomOp net", graph_stats(mod), None, None,
                         captured=False)
    check(not stats["graphs_on"] and stats["uncapturable_ops"] == ["Custom"]
          and stats["captures"] == 0, f"CustomOp net: {stats}")
    check(len(losses) == 40 and np.all(np.isfinite(losses))
          and np.mean(losses[-4:]) < np.mean(losses[:4]),
          f"Custom-op net did not train: {losses}")
    print(f"CustomOp on gpu(0): first step max_abs_err {err}; loss "
          f"{np.mean(losses[:4]):.4f} → {np.mean(losses[-4:]):.4f}")
    return {"first_step_max_abs_err": err, "epochs": 10, "batches": 40,
            "loss_first_epoch": float(np.mean(losses[:4])),
            "loss_last_epoch": float(np.mean(losses[-4:])), "wall_s": wall,
            "graphs": stats}


def lstm_sym_gen(mt, vocab, num_embed, num_hidden, num_layers, dropout=0.0):
    """``make_sym_gen`` of ``examples/lstm_bucketing.py:134-153``;
    ``dropout`` between the LSTM layers (the RNN's ``p``)."""
    def sym_gen(seq_len):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        embed = mt.sym.Embedding(data, input_dim=vocab,
                                 output_dim=num_embed, name="embed")
        rnn = mt.sym.RNN(data=mt.sym.transpose(embed, axes=(1, 0, 2)),
                         parameters=mt.sym.Variable("rnn_parameters"),
                         state=mt.sym.Variable("rnn_state"),
                         state_cell=mt.sym.Variable("rnn_state_cell"),
                         state_size=num_hidden, num_layers=num_layers,
                         mode="lstm", p=dropout, name="rnn")
        out = mt.sym.Reshape(mt.sym.transpose(rnn, axes=(1, 0, 2)),
                             shape=(-1, num_hidden))
        pred = mt.sym.FullyConnected(out, num_hidden=vocab, name="pred")
        flat_label = mt.sym.Reshape(label, shape=(-1,))
        sm = mt.sym.SoftmaxOutput(pred, flat_label, ignore_label=0,
                                  use_ignore=True, name="softmax")
        return sm, ("data",), ("softmax_label",)
    return sym_gen


def synthetic_corpus(num_sentences, vocab_size, max_len, seed):
    """``examples/lstm_bucketing.py:45``: a Markov corpus (each token one
    of two successors of the last, from one table drawn from seed 0),
    lengths 5..max_len, ids 2..vocab-1."""
    trans = np.random.RandomState(0).randint(2, vocab_size,
                                             size=(vocab_size, 2))
    rng = np.random.RandomState(seed)
    sentences = []
    for _ in range(num_sentences):
        n = rng.randint(5, max_len + 1)
        tok = rng.randint(2, vocab_size)
        s = [tok]
        for _ in range(n - 1):
            tok = trans[tok, rng.randint(0, 2)]
            s.append(int(tok))
        sentences.append(s)
    return sentences


class BucketSentenceIter:
    """Sentences padded with 0 up to their bucket, batched per bucket in
    a seeded shuffled order (``examples/lstm_bucketing.py:61``); label =
    data shifted left, 0 (ignored) at the end."""

    def __init__(self, mt, sentences, batch_size, buckets, seed):
        self.mt, self.batch_size = mt, batch_size
        self.buckets = sorted(buckets)
        self.default_bucket_key = max(buckets)
        self._rng = np.random.RandomState(seed)
        per = {b: [] for b in self.buckets}
        for s in sentences:
            b = next(b for b in self.buckets if len(s) <= b)
            per[b].append(np.pad(s, (0, b - len(s))))
        self._data = {b: np.asarray(v, np.float32) for b, v in per.items()
                      if len(v) >= batch_size}
        self.provide_data = [mt.io.DataDesc(
            "data", (batch_size, self.default_bucket_key))]
        self.provide_label = [mt.io.DataDesc(
            "softmax_label", (batch_size, self.default_bucket_key))]
        self.reset()

    def reset(self):
        self._plan = []
        for b, arr in self._data.items():
            idx = self._rng.permutation(len(arr))
            for i in range(0, len(arr) - self.batch_size + 1,
                           self.batch_size):
                self._plan.append((b, idx[i:i + self.batch_size]))
        self._rng.shuffle(self._plan)
        self._cur = 0

    def __iter__(self):
        return self

    def state_dict(self):
        """The position for a checkpoint: the epoch's plan (bucket, rows)
        and the batches taken, and the shuffling generator's state."""
        return {"kind": "BucketSentenceIter", "cur": self._cur,
                "plan": [(int(b), np.asarray(idx)) for b, idx in self._plan],
                "rng": self._rng.get_state()}

    def set_state(self, state, rewind=False):
        self._plan = [(int(b), np.asarray(idx)) for b, idx in state["plan"]]
        self._cur = 0 if rewind else int(state["cur"])
        self._rng.set_state(state["rng"])

    def __next__(self):
        if self._cur >= len(self._plan):
            raise StopIteration
        b, idx = self._plan[self._cur]
        self._cur += 1
        data = self._data[b][idx]
        label = np.concatenate([data[:, 1:],
                                np.zeros((len(data), 1), np.float32)], 1)
        mt, cpu = self.mt, self.mt.cpu()
        return mt.io.DataBatch(
            [mt.nd.array(data, ctx=cpu)], [mt.nd.array(label, ctx=cpu)],
            pad=0, bucket_key=b,
            provide_data=[mt.io.DataDesc("data", (self.batch_size, b))],
            provide_label=[mt.io.DataDesc("softmax_label",
                                          (self.batch_size, b))])


class BatchChecks:
    """A batch-end callback: ``lstm_scan`` launched once a layer in the
    batch's forward, and (training) ``rnn_parameters``' gradient finite
    and non-zero; records each batch's host time and bucket."""

    def __init__(self, torch, ck, mod, layers, phase, training):
        self.torch, self.ck, self.mod = torch, ck, mod
        self.layers, self.phase, self.training = layers, phase, training
        self.seen = 0
        self.batch_ms, self.keys = [], []
        self.t = time.perf_counter()

    def __call__(self, param):
        n = self.ck.LAUNCHES["lstm_scan"] - self.seen
        self.seen += n
        key = self.mod._curr_bucket_key
        check(n == self.layers, f"lstm {self.phase} epoch {param.epoch} "
              f"batch {param.nbatch} (bucket {key}): lstm_scan launched "
              f"{n} times, not {self.layers}")
        if self.training:
            grad = self.mod._curr_module._exec.grad_dict["rnn_parameters"]
            total = grad._data.abs().sum().item()
            check(np.isfinite(total) and total > 0, f"lstm {self.phase} "
                  f"batch {param.nbatch}: rnn_parameters gradient {total}")
        now = time.perf_counter()
        self.batch_ms.append((now - self.t) * 1e3)
        self.keys.append(key)
        self.t = now


def lstm_breakdown(torch, mt, ck, mod, data, key, Hd, B, reps=3):
    """Host-clock split (each part ends in a synchronize; medians of
    ``reps``) of one training batch of bucket ``key`` after training:
    forward, backward, update, metric; and the remat backward of one
    layer alone (the plain recurrence's forward and backward under
    autograd at (key, B, Hd))."""
    data.reset()
    batch = next(b for b in data if b.bucket_key == key)
    parts = {"forward": [], "backward": [], "update": [], "metric": []}

    def timed(name, fn):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        parts[name].append((time.perf_counter() - t) * 1e3)

    m = mt.metric.Perplexity(ignore_label=0)
    for _ in range(reps):
        timed("forward", lambda: mod.forward(batch, is_train=True))
        timed("backward", mod.backward)
        timed("update", mod.update)
        timed("metric", lambda: mod.update_metric(m, batch.label))
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(s, generator=g, device="cuda") * 0.1 for s in
          ((key, B, 4 * Hd), (B, Hd), (B, Hd), (Hd, 4 * Hd))]
    cots = [torch.randn(s, generator=g, device="cuda") for s in
            ((key, B, Hd), (B, Hd), (B, Hd))]
    remat = []
    for _ in range(reps):
        t = time.perf_counter()
        ins = [x.clone().requires_grad_() for x in xs]
        torch.autograd.grad(ck.lstm_scan_plain(*ins), ins, cots)
        torch.cuda.synchronize()
        remat.append((time.perf_counter() - t) * 1e3)
    out = {k: float(np.median(v)) for k, v in parts.items()}
    out.update(bucket=key, remat_backward_one_layer=float(np.median(remat)))
    return out


def lstm_fit(torch, mt, ck, train, epochs):
    """``BucketingModule.fit`` of the LSTM-PTB model over ``train`` for
    ``epochs`` (Adam 0.01, ``Uniform(0.08)``, zero states,
    ``Perplexity``, a ``Speedometer``), the launch counts reset just
    before, ``BatchChecks`` on every batch → (module, checks, the
    perplexity and seconds of each epoch, the launches of the first
    epoch and its batches).  Under the fused step the first epoch
    (every bucket's warm-up steps, capture and first replays) runs
    inside ``TracedLaunches`` and the launches are its trace's; the
    later epochs run untraced, the ones to time (a trace costs a graph
    of LSTM-PTB's many small kernels about as much again)."""
    import logging

    cfg = LSTM_PTB
    L, Hd, B = cfg["num_layers"], cfg["num_hidden"], cfg["batch"]
    mod = mt.mod.BucketingModule(
        lstm_sym_gen(mt, cfg["vocab"], cfg["num_embed"], Hd, L),
        default_bucket_key=train.default_bucket_key, context=mt.gpu(0),
        logger=logging.getLogger("lstm_ptb"))
    metric = mt.metric.Perplexity(ignore_label=0)
    zeros = mt.nd.zeros((L, B, Hd), ctx=mt.gpu(0))
    checks = BatchChecks(torch, ck, mod, L, "training", True)
    curve, epoch_s = [], []
    t_epoch = [time.perf_counter()]

    def epoch_end(epoch, *_):
        torch.cuda.synchronize()
        now = time.perf_counter()
        epoch_s.append(now - t_epoch[0])
        curve.append(metric.get()[1])
        if epoch == 0:
            traced.__exit__(None, None, None)
            first.append(len(checks.batch_ms))
            now = checks.t = time.perf_counter()
        t_epoch[0] = now

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    mt.random.seed(0)
    train.reset()
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    # graphs where the port has them and the bucket modules, made in
    # fit, read no MXNET_FUSED_STEP=0
    traced = TracedLaunches(torch, ck, "LSTM-PTB training",
                            on=hasattr(mod, "graph_stats") and os.environ.get(
                                "MXNET_FUSED_STEP", "1") != "0")
    traced.__enter__()
    first = []
    t_epoch[0] = checks.t = time.perf_counter()
    mod.fit(train, num_epoch=epochs, optimizer="adam",
            optimizer_params={"learning_rate": 0.01}, eval_metric=metric,
            initializer=mt.initializer.Uniform(0.08),
            arg_params={"rnn_state": zeros, "rnn_state_cell": zeros.copy()},
            allow_missing=True,
            batch_end_callback=[mt.callback.Speedometer(B, 20,
                                                        auto_reset=False),
                                checks],
            epoch_end_callback=epoch_end)
    return mod, checks, curve, epoch_s, traced.launches, first[0]


def lstm_path(torch, mt, ck, eager=True):
    """Train the LSTM-PTB model through ``BucketingModule.fit`` (the
    fused step: a CUDA graph a bucket after its warm-up steps), then
    score a held-out corpus (an inference graph a bucket); launch counts
    reset just before each phase and read just after, from
    ``TracedLaunches`` where the graphs run.  Then the device
    time of a bucket-60 batch (``step_device_ms``), and with ``eager``
    ``EAGER_EPOCHS`` under ``MXNET_FUSED_STEP=0``: its batch p50,
    ``lstm_breakdown`` of its module and its batch's device time."""
    cfg = LSTM_PTB
    L, Hd, B = cfg["num_layers"], cfg["num_hidden"], cfg["batch"]
    buckets = list(cfg["buckets"])
    train = BucketSentenceIter(
        mt, synthetic_corpus(LSTM_TRAIN_SENTENCES, cfg["vocab"], buckets[-1],
                             seed=1), B, buckets, seed=1)
    held_out = BucketSentenceIter(
        mt, synthetic_corpus(LSTM_HELD_OUT_SENTENCES, cfg["vocab"],
                             buckets[-1], seed=2), B, buckets, seed=2)
    check(sorted(train._data) == buckets and sorted(held_out._data) ==
          buckets, "a bucket holds fewer sentences than one batch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # counts from here on: LSTM training
    mod, checks, curve, epoch_s, train_launches, traced_batches = \
        lstm_fit(torch, mt, ck, train, LSTM_EPOCHS)
    check(train_launches["lstm_scan"] == L * traced_batches,
          f"lstm_scan launched {train_launches['lstm_scan']} times in "
          f"{traced_batches} training batches")
    peak = torch.cuda.max_memory_allocated()
    n_batches = len(checks.batch_ms) // LSTM_EPOCHS
    check(set(checks.keys) == set(buckets) == set(mod._buckets),
          f"buckets seen {sorted(set(checks.keys))}, bound "
          f"{sorted(mod._buckets)}")
    default = mod._buckets[train.default_bucket_key]
    for key, m in mod._buckets.items():
        for p in default._param_names:
            check(m._exec.arg_dict[p] is default._exec.arg_dict[p],
                  f"bucket {key} does not share parameter {p}")
    check(all(np.isfinite(curve)) and curve[1] < curve[0],
          f"training perplexity did not fall: {curve}")
    train_graphs = graph_stats(mod)

    scoring = BatchChecks(torch, ck, mod, L, "scoring", False)
    ck.reset_launch_counts()  # counts from here on: LSTM scoring
    with TracedLaunches(torch, ck, "LSTM-PTB scoring",
                        on=graphs_on(mod)) as traced:
        scoring.t = time.perf_counter()
        (_, held_ppl), = mod.score(
            held_out, mt.metric.Perplexity(ignore_label=0),
            batch_end_callback=scoring)
    score_launches = traced.launches
    check(np.isfinite(held_ppl) and held_ppl < curve[0],
          f"held-out perplexity {held_ppl} (training {curve})")
    check(score_launches["lstm_scan"] == L * len(scoring.batch_ms) > 0,
          f"lstm_scan launched {score_launches['lstm_scan']} times in "
          f"scoring")
    launches = {k: train_launches[k] + score_launches[k] for k in
                train_launches}
    print(f"LSTM-PTB perplexity curve {curve}, held-out {held_ppl}")

    train.reset()
    longest = next(b for b in train if b.bucket_key == buckets[-1])

    def batch_step(m):
        m.forward_backward(longest)
        m.update()

    device = step_device_ms(torch, lambda: batch_step(mod))
    graphs = graph_stats(mod)
    del mod
    torch.cuda.empty_cache()
    rec = {"config": cfg, "epochs": LSTM_EPOCHS,
           "train_sentences": LSTM_TRAIN_SENTENCES,
           "batches_per_epoch": n_batches,
           "samples_per_s_per_epoch": [n_batches * B / t for t in epoch_s],
           "epoch_s": epoch_s,
           # the batches after the traced first epoch: replays
           "batch_p50_ms": float(np.median(
               checks.batch_ms[traced_batches:])),
           "traced_epoch_batch_p50_ms": float(np.median(
               checks.batch_ms[:traced_batches])),
           "batch_p50_ms_by_bucket": {
               b: float(np.median([t for t, k in zip(
                   checks.batch_ms[traced_batches:],
                   checks.keys[traced_batches:]) if k == b]))
               for b in buckets},
           "batch_device_ms": device,
           "train_perplexity": curve, "held_out_perplexity": held_ppl,
           "held_out_batches": len(scoring.batch_ms),
           "score_batch_p50_ms": float(np.median(scoring.batch_ms)),
           "lstm_scan_launches": {"training": train_launches["lstm_scan"],
                                  "scoring": score_launches["lstm_scan"]},
           "peak_memory_bytes": int(peak), "launches": launches,
           "train_graphs": train_graphs, "graphs": graphs}
    eager_p50 = None
    if eager:
        with fused_env("0"):
            emod, echecks, ecurve, _, _, _ = lstm_fit(
                torch, mt, ck, train, EAGER_EPOCHS)
            breakdown = lstm_breakdown(torch, mt, ck, emod, train,
                                       buckets[-1], Hd, B)
            edevice = step_device_ms(torch, lambda: batch_step(emod))
        del emod
        torch.cuda.empty_cache()
        eager_p50 = float(np.median(echecks.batch_ms))
        rec["eager"] = {"epochs": EAGER_EPOCHS,
                        "batch_p50_ms": eager_p50, "perplexity": ecurve,
                        "batch_breakdown_ms": breakdown,
                        "batch_device_ms": edevice}
    fused_report("LSTM-PTB", graphs, rec["batch_p50_ms"], eager_p50)
    return rec


def ssd_train(torch, mt, ck, epochs):
    """SSD300 through ``Module`` at upstream's batch and optimizer
    settings for ``epochs`` over the shuffled ``synthetic_boxes`` (the
    launch counts reset just before), each step timed (host clock,
    synchronized) and its outputs checked finite, under
    ``TracedLaunches`` → (module, iterator, class cross-entropy and
    localization loss by epoch, step ms, the later epochs' samples/s,
    the launches)."""
    from mxnet_tpu_torch.models.ssd import ssd300_symbol, synthetic_boxes

    train_sym, _ = ssd300_symbol()
    X, Y = synthetic_boxes(SSD300["images"], seed=0)
    np.random.seed(0)  # NDArrayIter's shuffle
    mt.random.seed(0)  # Xavier's draws
    it = mt.io.NDArrayIter(X, Y, batch_size=SSD300["batch"], shuffle=True,
                           label_name="label", last_batch_handle="discard")
    mod = mt.mod.Module(train_sym, label_names=("label",),
                        context=mt.gpu(0))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=True)
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": SSD300["lr"], "momentum": SSD300["momentum"],
        "wd": SSD300["wd"], "rescale_grad": 1.0})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    ce, loc, step_ms = [], [], []
    traced = TracedLaunches(torch, ck, "SSD300 training", on=graphs_on(mod))
    traced.__enter__()
    t_window = time.perf_counter()
    for epoch in range(epochs):
        if epoch == 1:
            t_window = time.perf_counter()
        it.reset()
        ce_e, loc_e = [], []
        for batch in it:
            t0 = time.perf_counter()
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            prob, loc_loss, target = (o._data for o in mod.get_outputs())
            check(bool(torch.isfinite(prob).all())
                  and bool(torch.isfinite(loc_loss).all()),
                  f"SSD300 epoch {epoch}: an output is not finite")
            keep = target >= 0
            p = torch.gather(prob, 1, target.clamp(min=0).long()[:, None])
            ce_e.append(float(-torch.log(p[:, 0][keep]).mean()))
            loc_e.append(float(loc_loss.sum(1).mean()))
        ce.append(float(np.mean(ce_e)))
        loc.append(float(np.mean(loc_e)))
    window_s = time.perf_counter() - t_window
    traced.__exit__(None, None, None)
    window_steps = len(step_ms) * max(epochs - 1, 1) // epochs
    return (mod, it, ce, loc, step_ms,
            window_steps * SSD300["batch"] / window_s, traced.launches)


def ssd_detect_module(mt, mod, it):
    """The detection symbol bound for inference, filled by
    ``set_params(*mod.get_params())``: its outputs are the rows and the
    inputs of its ``MultiBoxDetection`` (cls_prob, loc_preds, anchors),
    so the rows before NMS can be rebuilt from the same forward."""
    from mxnet_tpu_torch.models.ssd import ssd300_symbol

    _, det_sym = ssd300_symbol()
    det = mt.mod.Module(mt.sym.Group([det_sym, *det_sym.get_children()]),
                        label_names=("label",), context=mt.gpu(0))
    det.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=False)
    det.set_params(*mod.get_params())
    return det, det_sym


def kernel_configs(torch, fn):
    """The kernels one call of ``fn`` runs on the card, each as "name
    grid block" (a ``torch.profiler`` trace of the device's activity,
    exported as a Chrome trace; spin kernels around the call), counted.
    """
    import collections
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spin_fill(torch)
        fn()
        spin_fill(torch)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return collections.Counter(
        f"{e['name']} grid {e['args'].get('grid')} block "
        f"{e['args'].get('block')}" for e in events
        if e.get("cat") == "kernel" and "spin_kernel" not in e["name"])


def ssd_path(torch, mt, ck, eager=True):
    """Train SSD300 through ``Module``'s fused step (``ssd_train``, a
    CUDA graph after the warm-up), then detect through a second module
    filled by ``set_params`` (its inference graph: B7 replayed inside
    it), the training module and its graph's pool still alive; launch
    counts under ``TracedLaunches`` in both phases.  The first epoch is
    the warm-up: samples/s counts the later ones' steps over their wall
    time (gates included).  The device time of a training step
    (``step_device_ms``) is taken before the detection.  Each detection
    batch's rows must equal ``nms_plain`` of its rows before NMS, rebuilt
    from the cls_prob, loc_preds and anchors of the same forward.  A
    module ``raw`` (the same net, NMS off, sharing the detection
    module's parameters and graph pool) runs each batch in a forward of
    its own: the batches whose rows before NMS differ from the detection
    forward's are counted; where some do, whether each module's forward
    repeats bit for bit on the first batch, and the kernels (with their
    grids) only one of the two ran (``kernel_configs``).  With
    ``eager``, ``EAGER_EPOCHS`` of training and one pass of detection
    under ``MXNET_FUSED_STEP=0``: their p50s and the step's device
    time."""
    from mxnet_tpu_torch.ops.detection import _iou_matrix, \
        multibox_detection

    t_part = time.perf_counter()
    part_s = {}
    mod, it, ce, loc, step_ms, samples_per_s, train_launches = ssd_train(
        torch, mt, ck, SSD300["epochs"])
    part_s["train"] = time.perf_counter() - t_part
    train_peak = torch.cuda.max_memory_allocated()
    check(train_launches["nms"] == 0, f"training forwards launched nms "
          f"{train_launches['nms']} times")
    check(ce[-1] < ce[0], f"SSD300 class cross-entropy did not fall: {ce}")
    check(loc[-1] < loc[0], f"SSD300 localization loss did not fall: {loc}")

    it.reset()
    first = next(it)

    def step(m):
        m.forward(first, is_train=True)
        m.backward()
        m.update()

    device = step_device_ms(torch, lambda: step(mod))
    graphs = graph_stats(mod)
    det, det_sym = ssd_detect_module(mt, mod, it)
    cls_prob, loc_preds, anchors = det_sym.get_children()
    raw = mt.mod.Module(mt.sym.MultiBoxDetection(
        cls_prob, loc_preds, anchors, nms_threshold="0",
        variances="(0.1, 0.1, 0.2, 0.2)"),
        label_names=("label",), context=mt.gpu(0))
    raw.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=False, shared_module=det)
    it.reset()
    det_ms, kept, dropped, hits, images = [], 0, 0, 0, 0
    apart = {"batches": 0, "max_abs_diff": 0.0, "kernels_only_in_detection":
             None, "kernels_only_in_raw": None}
    torch.cuda.synchronize()
    ck.reset_launch_counts()  # counts from here on: the detection
    t_part = time.perf_counter()
    with TracedLaunches(torch, ck, "SSD300 detection",
                        on=graphs_on(det)) as traced:
        for batch in it:
            if len(det_ms) == SSD300["detect_batches"]:
                break
            torch.cuda.synchronize()
            counted = ck.LAUNCHES["nms"]
            t0 = time.perf_counter()
            det.forward(batch, is_train=False)
            torch.cuda.synchronize()
            det_ms.append((time.perf_counter() - t0) * 1e3)
            n = ck.LAUNCHES["nms"] - counted
            check(n == 1, f"a detection forward counted {n} nms launches")
            rows, cls_out, loc_out, anchor_out = (
                o._data for o in det.get_outputs())
            # the rows before NMS of this forward: its own NMS inputs,
            # decoded and sorted again with NMS off
            before = multibox_detection(cls_out, loc_out, anchor_out,
                                        nms_threshold=0.0)
            want = ck.nms_plain(before, NMS_THRESHOLD, False)
            if not torch.equal(rows, want):
                cls_off = int((rows[:, :, 0] != want[:, :, 0]).sum())
                rest = (rows[:, :, 1:] - before[:, :, 1:]).abs().max().item()
                check(False, f"detection batch {images // rows.shape[0]}: "
                      f"rows differ from nms_plain of the rows before NMS "
                      f"({cls_off} class ids; columns 1-5 against the rows "
                      f"before NMS: max abs diff {rest}); graphs "
                      f"{graph_stats(det)}")
            raw.forward(batch, is_train=False)
            other = raw.get_outputs()[0]._data
            if not torch.equal(other, before):
                apart["batches"] += 1
                apart["max_abs_diff"] = max(apart["max_abs_diff"], (
                    other[:, :, 1:] - before[:, :, 1:]).abs().max().item())
            if not images:
                first_rows = before
            s = rows[:, :, 1]
            check(bool(((s[:, :-1] >= s[:, 1:]) | (s[:, 1:] < 0)).all()),
                  "detection scores not sorted")
            kept += int((rows[:, :, 0] >= 0).sum())
            dropped += int(((before[:, :, 0] >= 0)
                            & (rows[:, :, 0] < 0)).sum())
            gt = batch.label[0]._data.to(rows.device)
            iou = _iou_matrix(rows[:, :1, 2:6], gt[:, :, 1:5])[:, 0]
            right = (gt[:, :, 0] == rows[:, :1, 0]) & (rows[:, :1, 0] >= 0) \
                & (iou >= 0.5)
            hits += int(right.any(1).sum())
            images += rows.shape[0]
    det_launches = traced.launches
    part_s["detect"] = time.perf_counter() - t_part
    # B7 alone on the first batch's rows (launches not counted)
    nms_rec = {"ms": time_ms(torch, lambda: ck.nms(
        first_rows, NMS_THRESHOLD, False)), "device_ms": kernel_device_ms(
        torch, lambda: ck.nms(first_rows, NMS_THRESHOLD, False)),
        "live_rows_per_image": float((first_rows[:, :, 0] >= 0).float()
                                     .sum(1).mean())}
    check(det_launches["nms"] == len(det_ms), f"nms launched "
          f"{det_launches['nms']} times in {len(det_ms)} detection forwards")
    if apart["batches"]:  # why, outside the count: is each forward
        # repeatable, and did the two run the same kernels at the same
        # grids?
        it.reset()
        batch = next(it)
        seen = []
        for m, i in ((det, 1), (det, 1), (raw, 0), (raw, 0)):
            m.forward(batch, is_train=False)
            seen.append(m.get_outputs()[i]._data.clone())
        apart["detection_repeats_equal"] = torch.equal(seen[0], seen[1])
        apart["raw_repeats_equal"] = torch.equal(seen[2], seen[3])
        det_k = kernel_configs(torch, lambda: det.forward(batch, False))
        raw_k = kernel_configs(torch, lambda: raw.forward(batch, False))
        apart["kernels_only_in_detection"] = sorted((det_k - raw_k)
                                                    .elements())
        apart["kernels_only_in_raw"] = sorted((raw_k - det_k).elements())
    print(f"SSD300 class cross-entropy {ce}, loc loss per image {loc}; "
          f"{kept / images:.2f} detections an image, {dropped} rows "
          f"suppressed, top detection right in {hits}/{images} images")
    det_graphs = graph_stats(det)
    check(det_graphs is None or det_graphs["captures"] == 1, f"SSD300 "
          f"detection: {det_graphs}")
    peak = int(torch.cuda.max_memory_allocated())
    del det, raw, mod
    torch.cuda.empty_cache()
    rec = {"config": dict(SSD300, anchors=8732, classes=21,
                          image="3x300x300"),
           "class_ce_by_epoch": ce,
           "loc_loss_per_image_by_epoch": loc,
           "steps": len(step_ms),
           "samples_per_s": samples_per_s,
           "step_p50_ms": float(np.median(step_ms)),
           "step_device_ms": device,
           "train_peak_memory_bytes": int(train_peak),
           "detection_batches": len(det_ms),
           "detection_forward_p50_ms": float(np.median(det_ms)),
           "nms_on_detection_rows": nms_rec,
           "detections_per_image": kept / images,
           "rows_suppressed": dropped,
           "top_detection_right_share": hits / images,
           "raw_forward_apart": apart,
           "peak_memory_bytes": peak,
           "nms_launches": {"training": train_launches["nms"],
                            "detection": det_launches["nms"]},
           "launches": {k: train_launches[k] + det_launches[k]
                        for k in train_launches},
           "graphs": graphs, "detection_graphs": det_graphs}
    eager_p50 = eager_det_p50 = None
    rec["part_wall_s"] = part_s
    if eager:
        t_part = time.perf_counter()
        with fused_env("0"):
            emod, eit, _, _, estep_ms, _, _ = ssd_train(torch, mt, ck,
                                                         EAGER_EPOCHS)
            edevice = step_device_ms(torch, lambda: step(emod))
            edet, _ = ssd_detect_module(mt, emod, eit)
        eit.reset()
        edet_ms = []
        for batch in eit:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            edet.forward(batch, is_train=False)
            torch.cuda.synchronize()
            edet_ms.append((time.perf_counter() - t0) * 1e3)
        del emod, edet
        torch.cuda.empty_cache()
        eager_p50 = float(np.median(estep_ms))
        eager_det_p50 = float(np.median(edet_ms))
        rec["eager"] = {"epochs": EAGER_EPOCHS, "step_p50_ms": eager_p50,
                        "step_device_ms": edevice,
                        "detection_forward_p50_ms": eager_det_p50}
        part_s["eager"] = time.perf_counter() - t_part
    fused_report("SSD300", graphs, rec["step_p50_ms"], eager_p50)
    fused_report("SSD300 detection", det_graphs,
                 rec["detection_forward_p50_ms"], eager_det_p50)
    return rec


def sequence_path(torch, mt, ck):
    """Sequence parallelism on one card: ``mt.sequence`` over
    ``sequence_mesh(SEQ_SP, ["cuda:0"] * SEQ_SP)`` at the GPT-2-class
    attention width, fp32, SEQ_T positions.  Each run below has the
    launch counts reset just before it and read just after: exactly
    ``SEQ_LAUNCHES`` B8 launches a forward, as many B9 dq and dk/dv
    launches a backward, and no other kernel.

    1. The ring, causal and non-causal: output and q/k/v gradients (under
       a seeded cotangent) against ``blockwise_attention`` (B5) on the
       same tensors (``TOL``, ``BWD_TOL``).
    2. One attention block of the GPT-2-class LM: layer 0's packed
       ``qkv_weight``/``qkv_bias`` of ``gpt2_small_params(0)`` (cut in
       row thirds as ``split_qkv_params``) project a seeded (1, SEQ_T,
       768) activation to q, k, v; the ring; ``proj_weight``/
       ``proj_bias``; a seeded cotangent's dot product as the loss.  The
       ``qkv_weight`` gradient is held against the same block through B5.
    3. The decode-time layout: a SEQ_CHUNK-row chunk of q at
       SEQ_Q_OFFSET through ``ring_attention`` and ``ulysses_attention``
       (``q_offset``), and the plain ``ulysses_attention`` (B5 on each
       device) over all of q, against the same rows of B5's full causal
       forward.
    Then the ring's forward and forward + backward times (CUDA events,
    median of 3) beside B5's and both peak memories.  On one card the
    K/V rotation is ``Tensor.to`` onto the same device: it moves no
    bytes, so the times are the kernels' and the merges', not a
    transfer's."""
    import torch.nn.functional as F

    from mxnet_tpu_torch import sequence as seq
    from mxnet_tpu_torch.ops import attention as tatt

    T, sp = SEQ_T, SEQ_SP
    mesh = seq.sequence_mesh(sp, ["cuda:0"] * sp)
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, cot = (torch.randn((1, T, H, D), generator=g, device="cuda")
                    for _ in range(4))
    launches = {name: 0 for name in SEQ_KERNELS}

    def counted(label, fn, want):
        """fn() between a reset and a read of the counts: ``want``
        launches of the kernels it names, none of any other."""
        torch.cuda.synchronize()
        reset_launch_counts(ck)
        out = fn()
        torch.cuda.synchronize()
        got = launch_counts(ck)
        for name in ck.LAUNCHES:
            check(got[name] == want.get(name, 0), f"sequence {label}: {name} "
                  f"launched {got[name]} times, expected {want.get(name, 0)}")
        for name in SEQ_KERNELS:
            launches[name] += got[name]
        return out

    def fwd_bwd(attn, xs, cotangent):
        leaves = [x.detach().clone().requires_grad_() for x in xs]
        out = attn(*leaves)
        out.backward(cotangent)
        return out.detach(), [x.grad for x in leaves]

    def grad_err(got, want):
        worst = 0.0
        for a, b in zip(got, want):
            tol = BWD_TOL["float32"] * max(1.0, b.abs().max().item())
            err = (a - b).abs().max().item()
            worst = max(worst, err / tol)
        return worst

    rec = {"sp": sp, "devices": [str(d) for d in mesh.devices], "T": T,
           "heads": H, "head_dim": D, "dtype": "float32"}
    for causal in (True, False):
        label = "causal" if causal else "full"
        n = SEQ_LAUNCHES[label]

        def ring(*xs, causal=causal):
            return seq.ring_attention(*xs, mesh, causal=causal)

        def b5(*xs, causal=causal):
            return tatt.blockwise_attention(*xs, causal=causal)

        out, grads = counted(
            f"ring {label}", lambda: fwd_bwd(ring, (q, k, v), cot),
            {"flash_attention_partial": n, "flash_attention_bwd_dq": n,
             "flash_attention_bwd_dkv": n})
        ref, rgrads = fwd_bwd(b5, (q, k, v), cot)
        err = (out - ref).abs().max().item()
        gworst = grad_err(grads, rgrads)
        check(bool(torch.isfinite(out).all()) and err <= TOL["float32"]
              and gworst <= 1.0, f"sequence ring {label}: output "
              f"max_abs_err {err} against B5, gradients at {gworst} of "
              f"BWD_TOL")
        rec[f"ring_{label}"] = {"launches_fwd": n, "launches_bwd": n,
                                "max_abs_err": err,
                                "grad_err_over_tol_max": gworst}

    # one attention block of the GPT-2-class LM
    params = gpt2_small_params(0)
    dm = GPT2_SMALL["d_model"]
    w_qkv, b_qkv, w_p, b_p = (torch.from_numpy(params[f"layer0_{n}"]).cuda()
                              for n in ("qkv_weight", "qkv_bias",
                                        "proj_weight", "proj_bias"))
    del params
    x = torch.randn((1, T, dm), generator=g, device="cuda")
    cy = torch.randn((1, T, dm), generator=g, device="cuda")

    def block(attn):
        w = w_qkv.clone().requires_grad_()
        q_, k_, v_ = (F.linear(x, wt, bt).unflatten(-1, (H, D)) for wt, bt
                      in zip(w.chunk(3, dim=0), b_qkv.chunk(3)))
        y = F.linear(attn(q_, k_, v_, mesh, causal=True).flatten(2), w_p,
                     b_p)
        loss = (y * cy).sum()
        loss.backward()
        return loss.item(), w.grad

    n = SEQ_LAUNCHES["causal"]
    loss, gw = counted("GPT-2 block", lambda: block(seq.ring_attention),
                       {"flash_attention_partial": n,
                        "flash_attention_bwd_dq": n,
                        "flash_attention_bwd_dkv": n})
    ref_loss, ref_gw = block(
        lambda q_, k_, v_, mesh, causal: tatt.blockwise_attention(
            q_, k_, v_, causal=causal))
    gworst = grad_err([gw], [ref_gw])
    check(abs(loss - ref_loss) <= 1e-5 * abs(ref_loss) and gworst <= 1.0,
          f"sequence GPT-2 block: loss {loss} vs B5's {ref_loss}, "
          f"layer0_qkv_weight gradient at {gworst} of BWD_TOL")
    rec["gpt2_block"] = {"loss": loss, "b5_loss": ref_loss,
                         "qkv_weight_grad_err_over_tol_max": gworst}

    # the decode-time layout
    off, chunk = SEQ_Q_OFFSET, SEQ_CHUNK
    with torch.no_grad():
        full = tatt.blockwise_attention(q, k, v, causal=True)
        qc = q[:, off:off + chunk]
        for label, fn, kernel, n in (
                ("decode_ring", seq.ring_attention, "flash_attention_partial",
                 SEQ_LAUNCHES["decode_ring"]),
                ("decode_ulysses", seq.ulysses_attention,
                 "flash_attention_partial", SEQ_LAUNCHES["decode_ulysses"]),
                ("ulysses_plain", seq.ulysses_attention, "flash_mha", sp)):
            if label == "ulysses_plain":
                out = counted(label, lambda: fn(q, k, v, mesh, causal=True),
                              {kernel: n})
                want = full
            else:
                out = counted(label, lambda: fn(
                    qc, k, v, mesh, causal=True, q_offset=off), {kernel: n})
                want = full[:, off:off + chunk]
            err = (out - want).abs().max().item()
            check(out.shape == want.shape and err <= TOL["float32"],
                  f"sequence {label}: shape {tuple(out.shape)}, "
                  f"max_abs_err {err} against B5's causal rows")
            rec[label] = {"launches": {kernel: n}, "max_abs_err": err}
    rec["decode_layout"] = {"q_rows": chunk, "q_offset": off, "kv_rows": T}

    # times: p50 of 3 after one warm-up; peak memory of one fwd + bwd
    def timed(attn):
        with torch.no_grad():
            fwd = time_ms(torch, lambda: attn(q, k, v), reps=3, warmup=1)
        both = time_ms(torch, lambda: fwd_bwd(attn, (q, k, v), cot), reps=3,
                       warmup=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd(attn, (q, k, v), cot)
        torch.cuda.synchronize()
        return fwd, both, int(torch.cuda.max_memory_allocated())

    r = timed(lambda *xs: seq.ring_attention(*xs, mesh, causal=True))
    b = timed(lambda *xs: tatt.blockwise_attention(*xs, causal=True))
    rec["times"] = {"ring_fwd_ms": r[0], "ring_fwd_bwd_ms": r[1],
                    "ring_peak_memory_bytes": r[2], "b5_fwd_ms": b[0],
                    "b5_fwd_bwd_ms": b[1], "b5_peak_memory_bytes": b[2]}
    rec["launches"] = launches
    return rec


def resnet50(mt):
    return mt.models.get_symbol(IMAGE["network"],
                                num_classes=IMAGE["classes"],
                                image_shape=IMAGE["image_shape"])


def image_bind(mt, sym, ctx, batch, for_training=True,
               shape=IMAGE["image_shape"], dtype="float32"):
    """``sym`` bound from a ``dtype`` data descriptor (bf16: every
    parameter bf16, the moving statistics float32)."""
    mod = mt.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[mt.io.DataDesc("data", (batch,) + tuple(shape),
                                         dtype)],
             label_shapes=[("softmax_label", (batch,))],
             for_training=for_training)
    return mod


def image_step(torch, mt, sym, ctx, params, batch, float64=False,
               dtype="float32"):
    """One ``forward_backward`` of ``sym`` bound on ``ctx`` (from a
    ``dtype`` descriptor) from ``params`` → (outputs, mean
    cross-entropy, {weight: gradient}, {aux: new value}), all float64 on
    the host.  With ``float64`` every bound array is cast to float64
    first (the port's BatchNorm then keeps its statistics in
    float64)."""
    B = batch.data[0].shape[0]
    mod = image_bind(mt, sym, ctx, B, shape=batch.data[0].shape[1:],
                     dtype=dtype)
    mod.init_params(arg_params=params[0], aux_params=params[1])
    ex = mod._exec
    if float64:
        for arrays in (ex.arg_dict, ex.grad_dict, ex.aux_dict):
            for a in arrays.values():
                a._data = a._data.double()
    mod.forward_backward(batch)
    out = ex.outputs[0]._data.double().cpu()
    lab = batch.label[0]._data.long()[:, None]
    return (out, float(-torch.log(out.gather(1, lab)).mean()),
            {n: ex.grad_dict[n]._data.double().cpu() for n in params[0]},
            {n: a._data.double().cpu() for n, a in ex.aux_dict.items()})


def resnet_first_step(torch, mt):
    """One ResNet-50 ``forward_backward`` at full width, batch
    ``IMAGE["check_batch"]``, on ``gpu(0)`` against the same step by the
    port on the CPU from the same seeded ``Xavier(gaussian, in, 2)``
    parameters: outputs, the mean cross-entropy and every new moving
    statistic within ``TOL`` (scaled by max(1, max|CPU value|)).

    The weight gradients of this step are ill-conditioned in float32:
    the CPU's own float32 step misses the same step in float64 by ~1.5%
    in norm and by up to ~17% of a gradient's largest value, the card's
    by as much (measured on the H100), so no two float32 runs meet
    ``BWD_TOL`` here.  They are held against the CPU's float64 step
    instead: the card's error norm over all weights at most 1.5 times
    the CPU float32's, and each weight's largest error (over its
    largest value) at most twice the CPU float32's worst; gradients
    that are exactly zero (``bn_data``'s fixed gamma) stay zero."""
    B = IMAGE["check_batch"]
    sym = resnet50(mt)
    rng = np.random.RandomState(11)
    X = rng.rand(B, *IMAGE["image_shape"]).astype(np.float32)
    Y = rng.randint(0, IMAGE["classes"], size=B).astype(np.float32)
    batch = mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                            [mt.nd.array(Y, ctx=mt.cpu())])
    init = image_bind(mt, sym, mt.cpu(), B)
    mt.random.seed(0)
    init.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    params = init.get_params()
    del init
    rout, rloss, rgrads, raux = image_step(torch, mt, sym, mt.cpu(), params,
                                           batch)
    _, _, grads64, _ = image_step(torch, mt, sym, mt.cpu(), params, batch,
                                  float64=True)
    out, loss, grads, aux = image_step(torch, mt, sym, mt.gpu(0), params,
                                       batch)
    torch.cuda.empty_cache()

    def err_over_tol(a, ref, tol):
        return (a - ref).abs().max().item() \
            / (tol * max(1.0, ref.abs().max().item()))

    worst = {"outputs": err_over_tol(out, rout, TOL["float32"]),
             "loss": abs(loss - rloss) / (TOL["float32"] * max(1.0, rloss))}
    errs = {n: err_over_tol(aux[n], raux[n], TOL["float32"]) for n in raux}
    worst["moving_statistic_name"] = name = max(errs, key=errs.get)
    worst["moving_statistic"] = errs[name]
    check(bool(torch.isfinite(out).all()) and worst["outputs"] <= 1
          and worst["loss"] <= 1 and worst["moving_statistic"] <= 1
          and len(aux) == len(sym.list_auxiliary_states()),
          f"ResNet-50 first step on the card against the CPU: {worst}")
    check(len(grads) == len(sym.list_arguments()) - 2
          and all(bool(torch.isfinite(g).all()) for g in grads.values()),
          f"ResNet-50 first step: {len(grads)} gradients, or one not finite")
    zero = [n for n, g in grads64.items() if not g.any()]
    check(all(not grads[n].any() and not rgrads[n].any() for n in zero),
          f"ResNet-50 first step: a gradient of {zero} is not zero")

    def vs64(g):
        rel = {n: ((g[n] - grads64[n]).abs().max()
                   / grads64[n].abs().max()).item()
               for n in grads64 if n not in zero}
        diff = torch.cat([(g[n] - grads64[n]).reshape(-1) for n in grads64])
        return rel, diff.norm().item()

    ref_norm = torch.cat([g.reshape(-1) for g in grads64.values()]).norm()
    card_rel, card_norm = vs64(grads)
    cpu_rel, cpu_norm = vs64(rgrads)
    worst.update({
        "grad_err_norm_vs_float64": card_norm / ref_norm.item(),
        "cpu_grad_err_norm_vs_float64": cpu_norm / ref_norm.item(),
        "grad_max_rel_err_vs_float64": max(card_rel.values()),
        "cpu_grad_max_rel_err_vs_float64": max(cpu_rel.values()),
        "grad_vs_cpu_over_bwd_tol": max(
            err_over_tol(grads[n], rgrads[n], BWD_TOL["float32"])
            for n in grads)})
    check(card_norm <= 1.5 * cpu_norm and max(card_rel.values())
          <= 2 * max(cpu_rel.values()), f"ResNet-50 first step: the card's "
          f"gradients miss the float64 step by more than the CPU's float32 "
          f"ones: {worst}")
    print(f"ResNet-50 first step on the card against the CPU: {worst}")
    return {"batch": B, "loss": loss, "cpu_loss": rloss,
            "err_over_tol": worst}


def resnet_run(torch, mt, epochs=IMAGE["epochs"], dtype="float32"):
    """``train_imagenet.py --benchmark 1`` at full width: ResNet-50
    through ``Module.fit`` on ``gpu(0)`` over ``synthetic_image_iter``
    (two seeded batches cycled by ``ResizeIter``), ``epochs`` epochs
    (``IMAGE``'s by default), ``IMAGE``'s batches and optimizer,
    ``Xavier(gaussian, in, 2)``, accuracy and a ``Speedometer`` every 10
    batches.  A step is timed by host clock
    around ``forward_backward`` + ``update`` + synchronize; images/s and
    step p50 are the last epoch's.  Gates: every output finite; every
    moving statistic finite and moved from its initial value; the mean
    cross-entropy of the last 5 batches below that of the first 5.
    ``dtype`` "bfloat16": the same images as bf16 tensors, whose
    descriptor binds the network in bf16.
    → (the record, the trained module, the iterator's first batch)."""
    from mxnet_tpu_torch.examples.common import synthetic_image_iter

    step_ms = []

    class TimedModule(mt.mod.Module):
        def forward_backward(self, data_batch):
            torch.cuda.synchronize()
            self._t0 = time.perf_counter()
            super().forward_backward(data_batch)

        def update(self):
            super().update()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - self._t0) * 1e3)

    B, batches = IMAGE["batch"], IMAGE["batches"]
    train = synthetic_image_iter(B, IMAGE["image_shape"], IMAGE["classes"],
                                 batches)
    if dtype != "float32":
        inner = train.data_iter  # its two batches, in dtype
        train = mt.io.ResizeIter(mt.io.NDArrayIter(
            torch.from_numpy(inner.data[0][1]).to(getattr(torch, dtype)),
            inner.label[0][1], batch_size=B), batches, reset_internal=False)
    mod = TimedModule(resnet50(mt), context=mt.gpu(0))
    ce, finite, epoch_end = [], [], []

    def on_batch(param):
        prob = mod.get_outputs()[0]._data
        lab = param.locals["data_batch"].label[0]._data.to(prob.device)
        ce.append(-torch.log(prob.gather(1, lab.long()[:, None])).mean())
        finite.append(torch.isfinite(prob).all())
        if param.nbatch == batches - 1:
            torch.cuda.synchronize()
            epoch_end.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mt.random.seed(0)
    t0 = time.perf_counter()
    mod.fit(train, num_epoch=epochs, eval_metric="acc",
            optimizer="sgd", optimizer_params={
                "learning_rate": IMAGE["lr"], "wd": IMAGE["wd"],
                "momentum": IMAGE["momentum"]},
            initializer=mt.initializer.Xavier(rnd_type="gaussian",
                                              factor_type="in", magnitude=2),
            batch_end_callback=[mt.callback.Speedometer(B, 10), on_batch])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = epochs * batches
    check(len(step_ms) == steps == len(ce), f"{len(step_ms)} timed steps, "
          f"{len(ce)} batches for {steps}")
    check(bool(torch.stack(finite).all()), "ResNet-50: an output is not "
          "finite")
    ce = torch.stack(ce).tolist()
    aux = mod._exec.aux_dict
    moved = [n for n, a in aux.items() if bool(torch.isfinite(a._data).all())
             and bool((a._data != (0.0 if n.endswith("_mean")
                                   else 1.0)).any())]
    check(len(moved) == len(aux) == len(mod.symbol.list_auxiliary_states()),
          f"ResNet-50: {len(aux) - len(moved)}"
          f" moving statistics not finite or not moved: "
          f"{sorted(set(aux) - set(moved))[:5]}")
    check(np.mean(ce[-5:]) < np.mean(ce[:5]), f"ResNet-50 cross-entropy did "
          f"not fall: {ce}")
    run_ms = list(step_ms)  # the device-time steps are not the run's
    last = run_ms[-batches:]
    print(f"ResNet-50 cross-entropy by batch: {ce}")
    train.reset()
    return {"config": dict(IMAGE), "dtype": dtype, "steps": steps,
            "cross_entropy": ce, "step_ms": run_ms,
            "step_p50_ms": float(np.median(last)),
            "images_per_s": B * batches / (sum(last) / 1e3),
            "last_epoch_wall_images_per_s": B * batches
            / (epoch_end[-1] - epoch_end[-2]) if epochs > 1 else None,
            "wall_s": wall, "peak_memory_bytes": int(peak),
            "reference_p100_images_per_s": 181.53}, mod, next(train)


def resnet_train(torch, mt, eager=True):
    """``resnet_run`` through the fused step (a CUDA graph a step after
    the warm-up), then the device time of its step (``step_device_ms``);
    with ``eager`` the same run for ``EAGER_EPOCHS`` under
    ``MXNET_FUSED_STEP=0``, its step p50 and ``resnet_breakdown`` of its
    module (host and device time by
    part: a replayed step's kernels run under no aten op)."""
    rec, mod, batch = resnet_run(torch, mt)

    def step(m):
        m.forward_backward(batch)
        m.update()

    rec["step_device_ms"] = step_device_ms(torch, lambda: step(mod))
    rec["graphs"] = graph_stats(mod)
    del mod
    torch.cuda.empty_cache()
    eager_p50 = None
    if eager:
        with fused_env("0"):
            erec, emod, _ = resnet_run(torch, mt, EAGER_EPOCHS)
        breakdown = resnet_breakdown(torch, mt, emod, batch)
        print(f"ResNet-50 eager step breakdown: {breakdown}")
        del emod
        torch.cuda.empty_cache()
        eager_p50 = erec["step_p50_ms"]
        rec["eager"] = {k: erec[k] for k in ("step_p50_ms", "images_per_s",
                                             "peak_memory_bytes")}
        rec["eager"]["breakdown"] = breakdown
    fused_report("resnet-50", rec["graphs"], rec["step_p50_ms"], eager_p50)
    return rec


# ResNet-50's step by the aten op that launched each kernel: a key
# containing a substring of a class lands there; the rest (BatchNorm's
# eager ops, the residual adds, the loss head) is "batchnorm_adds_rest"
STEP_OP_CLASSES = (("convolution", ("convolution",)),
                   ("relu", ("relu", "clamp_min", "threshold_backward")),
                   ("pool", ("pool",)), ("fc", ("addmm", "aten::mm")),
                   ("copy", ("copy_", "_to_copy")))


def device_ms_by_class(torch, fn, reps, classes=None, rest=None):
    """Device ms a call of ``fn`` by ``classes`` (``STEP_OP_CLASSES``,
    the rest under ``rest``, "batchnorm_adds_rest"): the self device
    time of each aten op (the kernels it launched), from
    ``torch.profiler`` over ``reps`` calls after one."""
    classes = classes or STEP_OP_CLASSES
    rest = rest or "batchnorm_adds_rest"
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name, _ in classes}
    out[rest] = 0.0
    for e in prof.key_averages():
        if str(e.device_type) != "DeviceType.CPU":
            continue  # a kernel's own entry: counted under its aten op
        ms = e.self_device_time_total / reps / 1e3
        name = next((n for n, keys in classes
                     if any(k in e.key for k in keys)), rest)
        out[name] += ms
    return out


def resnet_breakdown(torch, mt, mod, batch, reps=3):
    """Where a ResNet-50 training step of the bound ``mod`` goes, on
    ``batch`` after training: host-clock forward, backward and update
    (each ending in a synchronize; medians of ``reps``); the device time
    of ``forward_backward`` and of ``update`` by the aten ops that
    launched it (``device_ms_by_class``); the convolutions' FLOPs
    (forward, data and weight gradients, from the symbol's shapes) and
    rate; the BatchNorm layers and the elements they normalize."""
    parts = {"forward": [], "backward": [], "update": []}

    def timed(name, fn):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        parts[name].append((time.perf_counter() - t) * 1e3)

    for _ in range(reps):
        timed("forward", lambda: mod.forward(batch, is_train=True))
        timed("backward", mod.backward)
        timed("update", mod.update)
    out = {k + "_ms": float(np.median(v)) for k, v in parts.items()}
    fb = device_ms_by_class(torch, lambda: mod.forward_backward(batch), reps)
    upd = device_ms_by_class(torch, mod.update, reps)
    out["forward_backward_device_ms"] = fb
    out["update_device_ms"] = sum(upd.values())
    out["step_device_ms"] = sum(fb.values()) + out["update_device_ms"]

    sym = mod.symbol
    B = batch.data[0].shape[0]
    internals = sym.get_internals()
    arg_shapes, out_shapes, _ = internals.infer_shape(
        data=(B,) + IMAGE["image_shape"], softmax_label=(B,))
    shape_of = dict(zip(internals.list_outputs(), out_shapes))
    shape_of.update(zip(internals.list_arguments(), arg_shapes))
    flops, bn_elements, bn_layers = 0, 0, 0
    for node in sym._topo():
        if node.op == "Convolution":
            w = shape_of[f"{node.name}_weight"]
            flops += 3 * 2 * int(np.prod(shape_of[f"{node.name}_output"])) \
                * int(np.prod(w[1:]))
        elif node.op == "BatchNorm":
            bn_layers += 1
            bn_elements += int(np.prod(shape_of[f"{node.name}_output"]))
    conv = fb["convolution"]
    rate = flops / (conv / 1e3) if conv else float("nan")
    out.update(conv_gflop=flops / 1e9, conv_tflop_per_s=rate / 1e12,
               conv_share_of_fp32_peak=rate / PEAK_FLOPS["float32"],
               batchnorm_layers=bn_layers, batchnorm_elements=bn_elements,
               parameters=len(mod._exec.grad_dict),
               aux_states=len(mod._exec.aux_dict))
    return out


def image_path(torch, mt, ck, eager=True):
    """Phase 10, image classification, on ``gpu(0)``: ``train_mnist``
    for LeNet and the MLP at its defaults (gate: validation accuracy
    >= ``MNIST_MIN_ACCURACY``), ResNet-50's first step against the CPU
    (``resnet_first_step``), its training run (``resnet_train``), then
    ``benchmark_score``'s scoring of ResNet-50 and LeNet, and
    ``Module.predict`` over three batches, the last one padded, which
    must ``torch.equal`` the trimmed ``forward`` outputs.  The launch
    counts are reset just before and read just after: no built-in or
    user kernel may launch on this path."""
    from mxnet_tpu_torch.examples import train_mnist

    dev = mt.gpu(0)
    torch.cuda.synchronize()
    reset_launch_counts(ck)  # counts from here on: image classification
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    mnist = {}
    for net in ("lenet", "mlp"):
        np.random.seed(0)  # the training iterator's shuffle
        mt.random.seed(0)  # Xavier's draws
        t0 = time.perf_counter()
        acc = float(train_mnist.main(["--network", net], ctx=dev))
        mnist[net] = {"val_accuracy": acc,
                      "wall_s": time.perf_counter() - t0}
        check(acc >= MNIST_MIN_ACCURACY, f"train_mnist {net}: validation "
              f"accuracy {acc} below {MNIST_MIN_ACCURACY}")
    first = resnet_first_step(torch, mt)
    train = resnet_train(torch, mt, eager)
    torch.cuda.empty_cache()
    score = {}
    for net, shape, classes, sizes in (
            ("resnet-50", IMAGE["image_shape"], IMAGE["classes"],
             IMAGE["score_batches"]),
            ("lenet", (1, 28, 28), 10, IMAGE["lenet_score_batches"])):
        for b in sizes:
            score[f"{net} batch {b}"] = score_pair(torch, mt, net, b, shape,
                                                   classes, eager)
    print(f"scoring images/s: {score}")

    Bp, n = IMAGE["predict_batch"], IMAGE["predict_images"]
    pmod = image_bind(mt, resnet50(mt), dev, Bp, for_training=False)
    mt.random.seed(0)
    pmod.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    rng = np.random.RandomState(12)
    it = mt.io.NDArrayIter(
        rng.rand(n, *IMAGE["image_shape"]).astype(np.float32),
        rng.randint(0, IMAGE["classes"], size=n).astype(np.float32),
        batch_size=Bp)
    merged = pmod.predict(it)._data
    it.reset()
    trimmed, pads = [], []
    for batch in it:
        pmod.forward(batch, is_train=False)
        out = pmod.get_outputs()[0]._data
        trimmed.append(out[:out.shape[0] - batch.pad].clone())
        pads.append(batch.pad)
    check(pads == [0, 0, 3 * Bp - n] and merged.shape == (n, IMAGE["classes"])
          and torch.equal(merged, torch.cat(trimmed)),
          f"Module.predict (pads {pads}, shape {tuple(merged.shape)}) does "
          f"not equal the trimmed forward outputs")
    del pmod
    torch.cuda.synchronize()
    launches = launch_counts(ck)
    check(not any(launches.values()), f"the image path launched a kernel: "
          f"{ {k: v for k, v in launches.items() if v} }")
    return {"tf32": tf32, "mnist": mnist, "resnet50_first_step": first,
            "resnet50_train": train, "score_images_per_s": score,
            "predict": {"images": n, "batch": Bp, "pads": pads,
                        "equal_to_forward": True},
            "launches": launches}


# ---------------------------------------------------------------------------
# phase 11: per-node randomness, Dropout, the rest of the CNN ops and the
# CNN families
# ---------------------------------------------------------------------------


class MaskRecorder:
    """While entered, ``ops.nn.draw_mask`` keeps every mask it draws."""

    def __init__(self):
        from mxnet_tpu_torch.ops import nn as tnn

        self.nn, self.masks = tnn, []

    def __enter__(self):
        self.draw = self.nn.draw_mask

        def draw(*args):
            mask = self.draw(*args)
            self.masks.append(mask)
            return mask

        self.nn.draw_mask = draw
        return self

    def __exit__(self, *exc):
        self.nn.draw_mask = self.draw


class Replay:
    """While entered, ``ops.nn.<name>`` (``draw_mask`` or
    ``draw_slopes``) hands out ``draws`` in order, each moved to the
    device asked for; every draw must be taken."""

    def __init__(self, draws, name="draw_mask"):
        from mxnet_tpu_torch.ops import nn as tnn

        self.nn, self.name, self.draws = tnn, name, list(draws)

    def __enter__(self):
        self.draw = getattr(self.nn, self.name)
        setattr(self.nn, self.name,
                lambda g, *args: self.draws.pop(0).to(args[-1]))
        return self

    def __exit__(self, *exc):
        setattr(self.nn, self.name, self.draw)
        if exc[0] is None:
            check(not self.draws, f"{len(self.draws)} {self.name} draws "
                  f"not taken")


class ReplayMasks:
    """While entered, ``ops.nn.draw_mask`` also copies each mask it
    draws into its node's buffer (``nodes`` masks a step, in order),
    made at the node's first, eager draw: a captured step records the
    copy, so every replay writes its masks where the host reads them.
    ``after_step`` holds each step's masks against the last step's (none
    equal) and ``keep`` (each within 6 sigma)."""

    def __init__(self, nodes, keep):
        from mxnet_tpu_torch.ops import nn as tnn

        self.nn, self.nodes, self.keep = tnn, nodes, keep
        self.buffers, self.calls, self.last = [], 0, None
        self.fractions = []

    def __enter__(self):
        self.draw = self.nn.draw_mask

        def draw(*args):
            mask = self.draw(*args)
            i = self.calls % self.nodes
            if len(self.buffers) <= i:
                self.buffers.append(mask.new_empty(mask.shape))
            self.buffers[i].copy_(mask)
            self.calls += 1
            return mask

        self.nn.draw_mask = draw
        return self

    def __exit__(self, *exc):
        self.nn.draw_mask = self.draw

    def after_step(self, step):
        check(len(self.buffers) == self.nodes, f"{len(self.buffers)} masks "
              f"of {self.nodes} nodes")
        masks = [b.clone() for b in self.buffers]
        if self.last is not None:
            same = [i for i, (a, b) in enumerate(zip(self.last, masks))
                    if a.equal(b)]
            check(not same, f"step {step}: nodes {same} drew the masks of "
                  f"the step before")
        fracs = [keep_fraction_ok(m, self.keep) for m in masks]
        check(all(ok for _, ok in fracs), f"step {step}: a keep fraction "
              f"off {self.keep}: {[f for f, _ in fracs]}")
        self.fractions.append([f for f, _ in fracs])
        self.last = masks


def keep_fraction_ok(mask, keep):
    """The fraction of True in ``mask`` within 6 sigma of ``keep``."""
    n = mask.numel()
    frac = float(mask.float().mean())
    return frac, abs(frac - keep) <= 6 * np.sqrt(keep * (1 - keep) / n)


class Launches:
    """Launch counts summed over the parts of a phase that launch the
    port's kernels: ``add`` adds a part's (``TracedLaunches``'), and
    ``region(label, on)`` is a ``TracedLaunches`` whose launches are
    added at its exit."""

    def __init__(self, torch, ck):
        self.torch, self.ck, self.total = torch, ck, {}

    def add(self, launches):
        for k, v in launches.items():
            self.total[k] = self.total.get(k, 0) + v

    @contextlib.contextmanager
    def region(self, label, on=True):
        with TracedLaunches(self.torch, self.ck, label, on) as traced:
            yield
        self.add(traced.launches)


def dropout_lm_path(torch, mt, ck, counts, eager=True):
    """(a) The GPT-2-class LM of the training run with ``LM_DROPOUT``
    after each attention projection and feed-forward: under one seed set
    twice the masks of two forwards are bitwise equal, two nodes of one
    step and two steps of one node differ, every mask keeps within 6
    sigma of 1 - p; then ``lm_train_pair`` (B1 forward and backward 12
    times a step, a finite, falling loss; the fused step's graphed
    steps, under ``ReplayMasks``, draw new masks every step, warm-up and
    replays alike); then ``forward(is_train=False)`` of the trained
    module, ``INFERENCE_FORWARDS`` times (its inference graph captured
    and replayed), equals, bitwise, the same weights under dropout 0 on
    the eager path."""
    L = GPT2_SMALL["num_layers"]
    params = gpt2_small_params(0)
    sym = packed_lm_symbol(mt, LM_DROPOUT)
    mod = lm_module(mt, sym, params)
    batches = lm_batches(mt)
    first = next(iter(batches))
    batches.reset()
    runs = []
    with counts.region("dropout LM mask runs", on=False):
        for _ in range(2):
            mt.random.seed(5)
            with MaskRecorder() as rec:
                mod.forward(first, is_train=True)
                mod.forward(first, is_train=True)
            runs.append(rec.masks)
    n = 2 * L  # Dropout nodes a forward
    check(len(runs[0]) == len(runs[1]) == 2 * n, f"{len(runs[0])} masks "
          f"for two forwards of {n} Dropout nodes")
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "one seed set twice drew other masks")
    check(not torch.equal(runs[0][0], runs[0][1]), "two Dropout nodes of "
          "one step drew the same mask")
    check(not torch.equal(runs[0][0], runs[0][n]), "two steps of one "
          "Dropout node drew the same mask")
    fracs = [keep_fraction_ok(m, 1 - LM_DROPOUT) for m in runs[0]]
    check(all(ok for _, ok in fracs), f"a keep fraction off 1 - p: "
          f"{[f for f, _ in fracs]}")
    del runs, mod
    torch.cuda.empty_cache()
    probe = ReplayMasks(n, 1 - LM_DROPOUT)
    outs, kept = [], {}

    def inference(trained):
        with counts.region("dropout LM inference"):
            for _ in range(INFERENCE_FORWARDS):
                trained.forward(first, is_train=False)
                outs.append(trained.get_outputs()[0]._data.clone())
        kept.update(stats=graph_stats(trained),
                    params=trained.get_params()[0])

    rec = lm_train_pair(torch, mt, ck, lambda: lm_module(mt, sym, params),
                        batches, PACKED_KERNELS,
                        [f"layer{i}_qkv_weight" for i in range(L)],
                        "dropout LM training", compare=False, probe=probe,
                        eager=eager, keep=inference, tally=counts.add)
    stats = kept["stats"]
    check(stats is None or stats["graphs"] == 2, f"the dropout LM holds "
          f"{stats and stats['graphs']} graphs, not its training step's "
          f"and its inference forward's")
    with fused_env("0"):
        ref = mt.mod.Module(packed_lm_symbol(mt), context=mt.gpu(0))
    T = GPT2_SMALL["max_len"]
    ref.bind(data_shapes=[("data", (TRAIN_BATCH, T))],
             label_shapes=[("softmax_label", (TRAIN_BATCH, T))],
             for_training=False)
    ref.init_params(arg_params=kept.pop("params"))
    with counts.region("dropout-free LM forward", on=False):
        ref.forward(first, is_train=False)
    check(all(torch.equal(o, ref.get_outputs()[0]._data) for o in outs),
          "the dropout LM's inference forward (its graph's replays) differs "
          "from the dropout-free LM's on the eager path")
    del ref
    rec.update(dropout=LM_DROPOUT, mask_keep_fractions=[f for f, _ in fracs],
               replayed_mask_keep_fractions=probe.fractions,
               inference_equal_to_dropout_free=True,
               inference_graph_forwards=len(outs))
    return rec


def lstm_dropout_batch(torch, mt, ck, counts):
    """(b) LSTM-PTB's symbol with ``LSTM_DROPOUT`` between its 2 layers:
    ``LSTM_DROPOUT_BATCHES`` training batches of bucket 60 through the
    fused step (Adam 0.01, ``Uniform(0.08)``, zero states; the warm-up
    steps, the capture, a replay): ``lstm_scan`` launched once a layer a
    batch, finite losses, layer 0's mask new every batch (``ReplayMasks``)
    and keeping within 6 sigma of 1 - p."""
    cfg = LSTM_PTB
    L, Hd, B, T = cfg["num_layers"], cfg["num_hidden"], cfg["batch"], 60
    it = BucketSentenceIter(mt, synthetic_corpus(4 * B, cfg["vocab"], T,
                                                 seed=3), B, [T], seed=3)
    batch = next(it)
    sym, _, _ = lstm_sym_gen(mt, cfg["vocab"], cfg["num_embed"], Hd, L,
                             dropout=LSTM_DROPOUT)(T)
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (B, T))],
             label_shapes=[("softmax_label", (B, T))])
    zeros = mt.nd.zeros((L, B, Hd), ctx=mt.gpu(0))
    mt.random.seed(0)
    mod.init_params(mt.initializer.Uniform(0.08),
                    arg_params={"rnn_state": zeros,
                                "rnn_state_cell": zeros.copy()},
                    allow_missing=True)
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.01})
    ces = []
    with counts.region("LSTM with dropout"), \
            ReplayMasks(L - 1, 1 - LSTM_DROPOUT) as probe:
        for step in range(LSTM_DROPOUT_BATCHES):
            before = launch_counts(ck)["lstm_scan"]
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
            n = launch_counts(ck)["lstm_scan"] - before
            check(n == L, f"LSTM with dropout, batch {step}: lstm_scan "
                  f"launched {n} times, not {L}")
            probe.after_step(step)
            prob = mod.get_outputs()[0]._data
            lab = batch.label[0]._data.to(prob.device).reshape(-1).long()
            live = lab != 0
            ces.append(float(-torch.log(prob[live].gather(
                1, lab[live][:, None])).mean()))
            check(np.isfinite(ces[-1]), f"LSTM with dropout: loss {ces}")
    check(tuple(probe.buffers[0].shape) == (T, B, Hd),
          f"LSTM dropout mask {tuple(probe.buffers[0].shape)}")
    stats = fused_report("LSTM with dropout", graph_stats(mod), None, None)
    return {"bucket": T, "batch": B, "p": LSTM_DROPOUT,
            "batches": LSTM_DROPOUT_BATCHES, "lstm_scan_a_batch": L,
            "keep_fractions": probe.fractions, "cross_entropy": ces,
            "graphs": stats}


# a CNN step by the aten op that launched each kernel: LRN is
# F.local_response_norm's window mean (avg_pool3d) and power, Dropout's
# draw is uniform_ and lt (its where and division, and BatchNorm's
# eager ops, the adds and the loss head fall in "rest"); copy is mostly
# the batch's staging from pageable host memory
CNN_OP_CLASSES = (("convolution", ("convolution",)),
                  ("relu", ("relu", "clamp_min", "threshold_backward")),
                  ("max_pool", ("max_pool",)),
                  ("lrn", ("avg_pool3d", "aten::pow")),
                  ("dropout_draw", ("uniform_", "aten::lt")),
                  ("pool_pad", ("constant_pad_nd",)),
                  ("avg_pool", ("avg_pool2d",)),
                  ("fc", ("addmm", "aten::mm")),
                  ("concat", ("aten::cat",)),
                  ("copy", ("copy_", "_to_copy")))


def cnn_run(torch, mt, network, epochs=None):
    """``train_imagenet.main(["--network", network, "--benchmark", "1",
    ...])`` on ``gpu(0)`` at ``CNN_TRAIN[network]`` (``Module.fit``,
    SGD momentum 0.9, wd 1e-4, ``Xavier(gaussian, in, 2)``), its Module
    a subclass that times each step (host clock around ``forward_backward``
    + ``update`` + synchronize) and reads its cross-entropy.  Gates:
    every output finite; the last 5 batches' mean cross-entropy below the
    first 5's; every moving statistic finite and moved.  ``epochs``
    overrides the config's.  → (the record: the last epoch's images/s
    and step p50, peak memory; the trained module; a step function on
    one fixed batch)."""
    from mxnet_tpu_torch.examples import train_imagenet

    cfg = dict(CNN_TRAIN[network])
    cfg["epochs"] = epochs or cfg["epochs"]
    B, batches = cfg["batch"], cfg["batches"]
    step_ms, ce, finite = [], [], []

    class TimedModule(mt.mod.Module):
        def forward_backward(self, data_batch):
            torch.cuda.synchronize()
            self._t0 = time.perf_counter()
            self._label = data_batch.label[0]
            super().forward_backward(data_batch)

        def update(self):
            super().update()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - self._t0) * 1e3)
            prob = self.get_outputs()[0]._data
            lab = self._label._data.to(prob.device).long()[:, None]
            ce.append(-torch.log(prob.gather(1, lab)).mean())
            finite.append(torch.isfinite(prob).all())

    argv = ["--network", network, "--benchmark", "1", "--batch-size", str(B),
            "--image-shape", ",".join(map(str, cfg["image_shape"])),
            "--num-classes", str(cfg["classes"]), "--num-epochs",
            str(cfg["epochs"]), "--num-batches", str(batches), "--lr",
            str(cfg["lr"]), "--disp-batches", "10"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain = mt.mod.Module
    mt.mod.Module = TimedModule
    try:
        mt.random.seed(0)
        t0 = time.perf_counter()
        mod = train_imagenet.main(argv, ctx=mt.gpu(0))
        wall = time.perf_counter() - t0
    finally:
        mt.mod.Module = plain
    peak = torch.cuda.max_memory_allocated()
    steps = cfg["epochs"] * batches
    # the device-time steps after the run are not the run's
    run_ms, losses = list(step_ms), torch.stack(ce).tolist()
    check(len(run_ms) == steps == len(losses), f"{network}: {len(run_ms)} "
          f"timed steps for {steps}")
    check(bool(torch.stack(finite).all()), f"{network}: an output is not "
          f"finite")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]), f"{network} "
          f"cross-entropy did not fall: {losses}")
    aux = mod._exec.aux_dict
    moved = [n for n, a in aux.items() if bool(torch.isfinite(a._data).all())
             and bool((a._data != (0.0 if n.endswith("_mean")
                                   else 1.0)).any())]
    check(len(moved) == len(aux) == len(mod.symbol.list_auxiliary_states()),
          f"{network}: {len(aux) - len(moved)} moving statistics not finite"
          f" or not moved")
    print(f"{network} cross-entropy by batch: {losses}")
    last = run_ms[-batches:]
    batch = mt.io.DataBatch([mt.nd.array(np.random.RandomState(0).rand(
        B, *cfg["image_shape"]).astype(np.float32), ctx=mt.cpu())],
        [mt.nd.array(np.zeros(B, np.float32), ctx=mt.cpu())])

    def step():
        mod.forward_backward(batch)
        mod.update()

    return {"config": dict(cfg, network=network), "steps": steps,
            "cross_entropy": losses, "step_ms": run_ms,
            "step_p50_ms": float(np.median(last)),
            "images_per_s": B * batches / (sum(last) / 1e3),
            "wall_s": wall, "peak_memory_bytes": int(peak),
            "moving_statistics": len(aux)}, mod, step


def cnn_train(torch, mt, network, eager=True):
    """(c), (e) ``cnn_run`` through the fused step (a CUDA graph a step
    after the warm-up), then the device time of its step
    (``step_device_ms``); with ``eager`` the same run under
    ``MXNET_FUSED_STEP=0``, its step p50 and the device time of its step
    by aten op (``CNN_OP_CLASSES``, two steps profiled after one: a
    replayed step's kernels run under no aten op)."""
    rec, mod, step = cnn_run(torch, mt, network)
    rec["step_device_ms"] = step_device_ms(torch, step)
    rec["graphs"] = graph_stats(mod)
    del mod, step
    torch.cuda.empty_cache()
    eager_p50 = None
    if eager:
        with fused_env("0"):
            erec, emod, estep = cnn_run(torch, mt, network, EAGER_EPOCHS)
        by_op = device_ms_by_class(torch, estep, 2, CNN_OP_CLASSES, "rest")
        del emod, estep
        torch.cuda.empty_cache()
        eager_p50 = erec["step_p50_ms"]
        rec["eager"] = {"step_p50_ms": eager_p50,
                        "images_per_s": erec["images_per_s"],
                        "peak_memory_bytes": erec["peak_memory_bytes"],
                        "step_device_ms_by_op": by_op,
                        "step_device_ms": sum(by_op.values())}
    fused_report(network, rec["graphs"], rec["step_p50_ms"], eager_p50)
    return rec


def forward_decisions(torch, sym, ctx, params, X, Y, masks):
    """The float32 training forward of ``sym`` on ``ctx`` (``masks``
    replayed) → ``{node: decisions}``: each ReLU's pattern of positive
    outputs and each max pool's argmax (where the window's max is
    positive: a window of zeros routes no gradient)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.executor import build_graph_fn

    internals = sym.get_internals()
    names = internals.list_outputs()
    dev = ctx.torch_device()
    args = {n: v._data.to(dev) for n, v in params[0].items()}
    args.update(data=torch.from_numpy(X).to(dev),
                softmax_label=torch.from_numpy(Y).to(dev))
    with torch.no_grad(), Replay(masks):
        outs, _ = build_graph_fn(internals)(args, {}, 0, True)
    value = dict(zip(names, outs))
    out = {}
    for node in sym._topo():
        if node.op == "Activation" and node.attrs.get("act_type") == "relu":
            out[node.name] = (value[f"{node.name}_output"] > 0).cpu()
        elif node.op == "Pooling" and node.attrs.get("pool_type") == "max":
            src, i = node.inputs[0]
            x = value[f"{src.name}_output" if i == 0 else f"{src.name}_"
                      f"output{i}"]
            k = tuple(int(v) for v in node.attrs["kernel"].strip("()")
                      .split(","))
            st = tuple(int(v) for v in node.attrs["stride"].strip("()")
                       .split(","))
            top, idx = F.max_pool2d(x, k, st, return_indices=True)
            out[node.name] = torch.where(top > 0, idx, -1).cpu()
    return out


def alexnet_first_step(torch, mt):
    """(d) AlexNet's first ``forward_backward`` at full width, batch
    ``ALEXNET_CHECK_BATCH``, on ``gpu(0)`` against the same step on the
    CPU, which replays the card's two dropout masks.  Float32: outputs
    and the loss within ``TOL``; each weight gradient within
    ``BWD_TOL`` of the CPU's, except below the last ReLU or max pool
    whose decisions (``forward_decisions``) the card's float32 forward
    takes otherwise than the CPU's: a pre-activation within float32
    noise of the kink, or a near tie, routes the gradient elsewhere (a
    chaotic, not a systematic difference; those weights are listed with
    the flipped decisions and their distance from float64).  Float64:
    the same step on the card (cuDNN and cuBLAS in double) against the
    CPU's, every output and gradient within ``BWD_TOL``: there the
    decisions cannot flip, so the card's path is held whole."""
    B, cfg = ALEXNET_CHECK_BATCH, CNN_TRAIN["alexnet"]
    shape = cfg["image_shape"]
    sym = mt.models.get_symbol("alexnet", num_classes=cfg["classes"],
                               image_shape=shape)
    rng = np.random.RandomState(13)
    X = rng.rand(B, *shape).astype(np.float32)
    Y = rng.randint(0, cfg["classes"], size=B).astype(np.float32)
    batch = mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                            [mt.nd.array(Y, ctx=mt.cpu())])
    init = image_bind(mt, sym, mt.cpu(), B, shape=shape)
    mt.random.seed(0)
    init.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    params = init.get_params()
    del init
    with MaskRecorder() as rec:
        out, loss, grads, _ = image_step(torch, mt, sym, mt.gpu(0), params,
                                         batch)
    masks = [m.cpu() for m in rec.masks]
    check(len(masks) == 2, f"AlexNet drew {len(masks)} dropout masks")
    steps = {}
    for key, ctx, f64 in (("cpu", mt.cpu(), False),
                          ("cpu64", mt.cpu(), True),
                          ("card64", mt.gpu(0), True)):
        with Replay(masks):
            steps[key] = image_step(torch, mt, sym, ctx, params, batch,
                                    float64=f64)
    rout, rloss, rgrads, _ = steps["cpu"]
    torch.cuda.empty_cache()

    def over(a, ref, tol):
        return (a - ref).abs().max().item() \
            / (tol * max(1.0, ref.abs().max().item()))

    worst = {"outputs": over(out, rout, TOL["float32"]),
             "loss": abs(loss - rloss) / (TOL["float32"] * max(1.0, rloss))}
    check(bool(torch.isfinite(out).all()) and worst["outputs"] <= 1
          and worst["loss"] <= 1, f"AlexNet first step: {worst}")
    o64, l64, g64, _ = steps["card64"]
    r64, rl64, rg64, _ = steps["cpu64"]
    worst["float64_outputs"] = over(o64, r64, TOL["float32"])
    worst["float64_grads"] = max(over(g64[n], rg64[n], BWD_TOL["float32"])
                                 for n in rg64)
    check(worst["float64_outputs"] <= 1 and worst["float64_grads"] <= 1
          and abs(l64 - rl64) <= TOL["float32"] * max(1.0, rl64),
          f"AlexNet first step in float64, card against CPU: {worst}")

    card_dec = forward_decisions(torch, sym, mt.gpu(0), params, X, Y, masks)
    cpu_dec = forward_decisions(torch, sym, mt.cpu(), params, X, Y, masks)
    flipped = {n: int((card_dec[n] != cpu_dec[n]).sum()) for n in cpu_dec}
    order = [n.name for n in sym._topo()]
    last = max((order.index(n) for n, c in flipped.items() if c),
               default=-1)
    by_tol = {n: over(grads[n], rgrads[n], BWD_TOL["float32"])
              for n in grads}
    below = {n for n in grads if order.index(n) < last}
    check(all(by_tol[n] <= 1 for n in grads if n not in below),
          f"AlexNet first step: gradients off the CPU's with no flipped "
          f"decision above them: {by_tol}, flipped {flipped}")
    worst["grad_vs_cpu_over_bwd_tol"] = max(by_tol.values())
    worst["flipped_decisions"] = {n: c for n, c in flipped.items() if c}
    worst["past_bwd_tol_below_a_flip"] = {
        n: {"vs_cpu_over_bwd_tol": by_tol[n],
            "card_vs_float64_rel": ((grads[n] - rg64[n]).abs().max()
                                    / rg64[n].abs().max()).item(),
            "cpu_vs_float64_rel": ((rgrads[n] - rg64[n]).abs().max()
                                   / rg64[n].abs().max()).item()}
        for n in sorted(below) if by_tol[n] > 1}
    print(f"AlexNet first step on the card against the CPU: {worst}")
    return {"batch": B, "loss": loss, "cpu_loss": rloss,
            "err_over_tol": worst}


def score_pair(torch, mt, net, batch, shape, classes, eager, **kw):
    """``benchmark_score.score`` images/s of ``net`` at ``batch`` (its
    forwards replay the inference graph after the warm-up and capture),
    and with ``eager`` the same under ``MXNET_FUSED_STEP=0``."""
    from mxnet_tpu_torch.examples import benchmark_score

    mt.random.seed(0)
    out = {"graphed": benchmark_score.score(
        net, batch, shape, classes, mt.gpu(0),
        num_batches=IMAGE["score_reps"], **kw)}
    if eager:
        mt.random.seed(0)
        with fused_env("0"):
            out["eager"] = benchmark_score.score(
                net, batch, shape, classes, mt.gpu(0),
                num_batches=IMAGE["score_reps"], **kw)
    return out


def cnn_score(torch, mt, eager=True):
    """(f) ``score_pair`` of ``CNN_SCORE`` at ``CNN_SCORE_BATCHES``
    (images/s; ``IMAGE["score_reps"]`` forwards)."""
    out = {}
    for net, shape, kw in CNN_SCORE:
        label = net + ("-s2d" if kw.get("stem") == "s2d" else "")
        for b in CNN_SCORE_BATCHES:
            out[f"{label} batch {b}"] = score_pair(torch, mt, net, b, shape,
                                                   1000, eager, **kw)
        torch.cuda.empty_cache()
    print(f"scoring images/s: {out}")
    return out


def cnn_op_cases(rng):
    """(name, inputs, attrs, gradient slots, draws) of ``check_cnn_ops``:
    every op of queue A item 2 at small shapes over its attributes;
    ``draws`` replaces ``draw_mask`` / ``draw_slopes``."""
    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    x = r(4, 8, 13, 13)
    cases = [("LRN", [x], dict(nsize=5, knorm=1, alpha=1e-4, beta=0.75),
              (0,), None),
             ("LRN", [x], dict(nsize=4, knorm=2), (0,), None)]
    for attrs in (dict(act_type="leaky", slope=0.1), dict(act_type="elu"),
                  dict(act_type="gelu"), dict(act_type="rrelu")):
        cases.append(("LeakyReLU", [x], attrs, (0,), None))
    cases.append(("LeakyReLU", [x, rng.rand(8).astype(np.float32)],
                  dict(act_type="prelu"), (0, 1), None))
    cases.append(("LeakyReLU", [x], dict(act_type="rrelu"), (0,),
                  ("draw_slopes", rng.uniform(0.125, 0.334, (4, 8))
                   .astype(np.float32))))
    for mode in ("channel", "instance"):
        cases.append(("SoftmaxActivation", [x], dict(mode=mode), (0,),
                      None))
    cases.append(("InstanceNorm", [x, rng.rand(8).astype(np.float32),
                                   r(8)], dict(eps=1e-3), (0, 1, 2), None))
    for attrs in (dict(kernel=(3, 3), num_filter=6, stride=(2, 2),
                       pad=(1, 1), adj=(1, 1), no_bias=False),
                  dict(kernel=(4, 4), num_filter=12, num_group=4,
                       dilate=(2, 2), pad=(2, 1), no_bias=True),
                  dict(kernel=(2, 2), num_filter=4, stride=(2, 2),
                       pad=(1, 1), adj=(2, 2), no_bias=True)):
        g = attrs.get("num_group", 1)
        ins = [x, r(8, attrs["num_filter"] // g, *attrs["kernel"]) * 0.3]
        if not attrs["no_bias"]:
            ins.append(r(attrs["num_filter"]))
        cases.append(("Deconvolution", ins, attrs,
                      tuple(range(len(ins))), None))
    cases.append(("UpSampling", [x], dict(scale=2, sample_type="nearest"),
                  (0,), None))
    cases.append(("UpSampling", [x, r(4, 3, 1, 1)], dict(
        scale=2, sample_type="nearest", num_args=2), (0, 1), None))
    cases.append(("UpSampling", [x, r(8, 1, 4, 4) * 0.5], dict(
        scale=2, sample_type="bilinear", num_filter=8), (0, 1), None))
    for attrs, like in ((dict(h_w=(7, 9), offset=(2, 1)), None),
                        (dict(num_args=2), r(1, 1, 6, 5)),
                        (dict(h_w=(5, 5), center_crop=True), None)):
        cases.append(("Crop", [x] + ([] if like is None else [like]), attrs,
                      (0,), None))
    for mode in ("constant", "edge", "reflect"):
        cases.append(("Pad", [x], dict(mode=mode, constant_value=0.5,
                                       pad_width=(0, 0, 0, 0, 2, 3, 1, 4)),
                      (0,), None))
    for order in ("depth_major", "group_major"):
        cases.append(("space_to_depth", [x], dict(
            block_size=2, pad=(3, 3), channel_order=order), (0,), None))
        cases.append(("depth_to_space", [r(4, 32, 5, 6)], dict(
            block_size=2, channel_order=order), (0,), None))
    cases.append(("Dropout", [x], dict(p=0.3), (0,),
                  ("draw_mask", rng.rand(*x.shape) < 0.7)))
    return cases


def check_cnn_ops(torch, mt):
    """(g) Each op of queue A item 2 through ``mt.nd.<op>`` on ``gpu(0)``
    against the same call on the CPU (``TOL``), and its gradients
    (``registry.invoke`` under autograd, one seeded cotangent) against
    the CPU's (``BWD_TOL``); rrelu in training and ``Dropout`` with the
    slopes and mask injected.  Then one ``Dropout`` of
    ``DROPOUT_MASK_ELEMENTS`` ones on the card: a keep fraction within 6
    sigma of 1 - p, every kept value ``1 / keep`` exactly."""
    from mxnet_tpu_torch.ops.registry import invoke

    rng = np.random.RandomState(14)
    worst = {}
    for i, (name, ins, attrs, slots, draws) in enumerate(cnn_op_cases(rng)):
        train = draws is not None
        outs = []
        for ctx in (mt.gpu(0), mt.cpu()):
            dev = ctx.torch_device()
            nds = [mt.nd.array(a, ctx=ctx) for a in ins]
            inject = Replay([torch.from_numpy(np.array(draws[1]))],
                            draws[0]) if train else None
            if inject:
                with inject:
                    fwd = getattr(mt.nd, name)(*nds, is_train=True, **attrs)
            else:
                fwd = getattr(mt.nd, name)(*nds, **attrs)
            tin = [torch.from_numpy(a).to(dev).requires_grad_(i in slots)
                   for i, a in enumerate(ins)]
            if inject:
                inject = Replay([torch.from_numpy(np.array(draws[1]))],
                                draws[0])
                with inject:
                    (y,), _ = invoke(name, tin, attrs, is_train=True)
            else:
                (y,), _ = invoke(name, tin, attrs)
            cot = torch.from_numpy(np.random.RandomState(1).randn(
                *y.shape).astype(np.float32)).to(dev)
            grads = torch.autograd.grad(y, [tin[i] for i in slots], cot)
            outs.append((fwd._data.cpu(), [g.cpu() for g in grads]))
        (o, gs), (ro, rgs) = outs
        err = (o - ro).abs().max().item() / (
            TOL["float32"] * max(1.0, ro.abs().max().item()))
        gerr = max((g - r).abs().max().item() / (
            BWD_TOL["float32"] * max(1.0, r.abs().max().item()))
            for g, r in zip(gs, rgs))
        key = f"{i} {name} {attrs}"
        worst[key] = {"fwd": err, "bwd": gerr}
        check(o.shape == ro.shape and err <= 1 and gerr <= 1,
              f"{key} on the card against the CPU: {worst[key]}")
    p = 0.3
    x = mt.nd.ones((DROPOUT_MASK_ELEMENTS,), ctx=mt.gpu(0))
    y = mt.nd.Dropout(x, p=p, is_train=True)._data
    kept = y != 0
    frac, ok = keep_fraction_ok(kept, 1 - p)
    scale = (torch.tensor(1.0) / torch.tensor(1 - p)).item()
    check(ok and bool((y[kept] == scale).all()), f"Dropout of 2^24 ones: "
          f"keep fraction {frac}, kept values {y[kept].unique()[:4]}")
    return {"ops": len(worst), "max_fwd_err_over_tol":
            max(w["fwd"] for w in worst.values()),
            "max_bwd_err_over_tol": max(w["bwd"] for w in worst.values()),
            "dropout_2_24_keep_fraction": frac, "p": p}


def cnn_dropout_path(torch, mt, ck, eager=True):
    """Phase 11 on ``gpu(0)``, fp32 with TF32 off: (a) the dropout LM
    (``dropout_lm_path``), (b) LSTM-PTB with dropout between layers
    (``lstm_dropout_batch``), (c) AlexNet's training run
    (``cnn_train``), (d) its first step against the CPU
    (``alexnet_first_step``), (e) Inception-v3's training run, (f) the
    scoring (``cnn_score``), (g) the ops on the card
    (``check_cnn_ops``).  Launch counts summed over the traced regions
    of (a) and (b) (``Launches``): B1's forward and backward come from
    (a), ``lstm_scan`` from (b); the wrappers count no launch in the
    other parts."""
    counts = Launches(torch, ck)
    rec, wall = {}, {}
    for part, fn in (("dropout_lm", lambda: dropout_lm_path(
                         torch, mt, ck, counts, eager)),
                     ("lstm_dropout", lambda: lstm_dropout_batch(
                         torch, mt, ck, counts)),
                     ("alexnet_train", lambda: cnn_train(torch, mt,
                                                         "alexnet", eager)),
                     ("alexnet_first_step", lambda: alexnet_first_step(
                         torch, mt)),
                     ("inception_v3_train", lambda: cnn_train(
                         torch, mt, "inception-v3", eager)),
                     ("score_images_per_s", lambda: cnn_score(torch, mt,
                                                              eager)),
                     ("ops", lambda: check_cnn_ops(torch, mt))):
        counted = launch_counts(ck)
        t0 = time.perf_counter()
        rec[part] = fn()
        torch.cuda.synchronize()
        wall[part] = time.perf_counter() - t0
        if part not in ("dropout_lm", "lstm_dropout"):
            now = launch_counts(ck)
            check(now == counted, f"phase 11 {part} counted launches: "
                  f"{ {k: n - counted[k] for k, n in now.items()} }")
        torch.cuda.empty_cache()
    launched = {k: v for k, v in counts.total.items() if v}
    # (a): two mask runs of two forwards; the fused and the eager run's
    # steps; the trained module's inference forwards and the
    # dropout-free one's; (b): its batches
    steps = (1 + eager) * TRAIN_STEPS
    want = {"flash_mha_packed": 12 * (4 + steps + INFERENCE_FORWARDS + 1),
            "flash_mha_packed_bwd_dq": 12 * steps,
            "flash_mha_packed_bwd_dkv": 12 * steps,
            "lstm_scan": LSTM_PTB["num_layers"] * LSTM_DROPOUT_BATCHES}
    check(launched == want, f"phase 11 launched {launched}, not {want}")
    rec.update(part_wall_s=wall, launches=counts.total)
    return rec


# ---------------------------------------------------------------------------
# phase 12: checkpoints and resume
# ---------------------------------------------------------------------------


class Stop(Exception):
    """Ends an interrupted run (raised by a ``StepClock``)."""


class MaskTape(ReplayMasks):
    """``ReplayMasks`` that also keeps each step's masks (``steps``)."""

    def __init__(self, nodes, keep):
        super().__init__(nodes, keep)
        self.steps = []

    def after_step(self, step):
        super().after_step(step)
        self.steps.append(self.last)


class StepClock:
    """A batch-end callback: each step's ms since the last call, the
    main stream synchronized (not the device: a checkpoint writer's
    copies on its own stream are not waited for); a ``tape`` takes the
    step's masks; after ``stop`` steps it raises ``Stop``."""

    def __init__(self, torch, stop=None, tape=None):
        self.torch, self.stop, self.tape = torch, stop, tape
        self.ms, self.done_at = [], []
        self.t = None

    def start(self):
        self.torch.cuda.current_stream().synchronize()
        self.t = time.perf_counter()

    def __call__(self, param):
        self.torch.cuda.current_stream().synchronize()
        now = time.perf_counter()
        self.ms.append((now - self.t) * 1e3)
        self.done_at.append(now)
        self.t = now
        if self.tape is not None:
            self.tape.after_step(len(self.ms))
        if self.stop is not None and len(self.ms) == self.stop:
            raise Stop()


def ckpt_fit(torch, mt, counts, label, mod, it, fit_kw, seed, stop=None,
             manager=None, tape=None):
    """``mod.fit(it)`` for one epoch under ``seed`` inside a traced
    region of ``counts``, with ``manager`` and ``resume='auto'`` when one
    is given, stopped after ``stop`` steps → (clock, stamps): the
    perf_counter times at the start, after the manager's ``load_latest``
    and after its ``restore_training_state``."""
    mt.random.seed(seed)
    np.random.seed(seed)
    clock = StepClock(torch, stop, tape)
    stamps = {}
    if manager is not None:
        for name in ("load_latest", "restore_training_state"):
            def stamped(*a, _f=getattr(manager, name), _n=name, **kw):
                out = _f(*a, **kw)
                torch.cuda.current_stream().synchronize()
                stamps[_n] = time.perf_counter()
                return out
            setattr(manager, name, stamped)
    with counts.region(label), tape or contextlib.nullcontext():
        clock.start()
        stamps["start"] = clock.t
        try:
            mod.fit(it, num_epoch=1, checkpoint=manager,
                    resume="auto" if manager is not None else None,
                    batch_end_callback=clock, **fit_kw)
        except Stop:
            pass
    return clock, stamps


def state_diffs(torch, ref, got):
    """{name: max |ref - got|} of two {name: tensor or tuple} dicts, the
    names of the entries outside ``CKPT_TOL``, and the first that is not
    bit for bit equal (None when all are)."""
    diffs, off, first = {}, [], None
    for name, a in ref.items():
        b = got[name]
        pairs = zip(a, b) if isinstance(a, (tuple, list)) else [(a, b)]
        for i, (x, y) in enumerate(pairs):
            key = name if not isinstance(a, (tuple, list)) \
                else f"{name}[{i}]"
            diffs[key] = float((x.double() - y.double()).abs().max())
            if first is None and not torch.equal(x, y):
                first = key
            if not torch.allclose(y, x, **CKPT_TOL):
                off.append(key)
    return diffs, off, first


def ckpt_resume_record(torch, mt, label, ref, got, ref_clock, int_clock,
                       res_clock, stamps, mgr, sync_mgr, ckpt_dir, runs):
    """The gates and the record of a resume: every state within
    ``CKPT_TOL`` of the uninterrupted run's, the checkpoint clean."""
    diffs, off, first = state_diffs(torch, ref, got)
    check(not off, f"{label}: the resumed run parts from the "
          f"uninterrupted one beyond {CKPT_TOL}: {off[:8]}")
    infos = [i for i in mt.checkpoint.list_checkpoints(ckpt_dir)
             if i.committed]
    problems = [p for i in infos
                for p in mt.checkpoint.verify_checkpoint(i.path)]
    check(infos and not problems, f"{label}: checkpoints {infos}: "
          f"{problems}")
    done = res_clock.done_at
    return {
        "tensors": len(diffs), "max_abs_err": max(diffs.values()),
        "bit_for_bit": first is None, "first_parting_tensor": first,
        "max_abs_err_by_tensor": {k: v for k, v in diffs.items() if v},
        "checkpoint_steps": [i.step for i in infos],
        "captures": runs,
        "async_save_blocking_ms": mgr["blocking_ms"],
        "snapshot_ms_new_and_cached_memory": mgr["snapshot_ms"],
        "async_writer_ms": mgr["save_ms"], "checkpoint_bytes": mgr["bytes"],
        "sync_save_ms": sync_mgr["blocking_ms"],
        "sync_checkpoint_bytes": sync_mgr["bytes"],
        "resume_load_ms": (stamps["load_latest"] - stamps["start"]) * 1e3,
        "resume_restore_ms": (stamps["restore_training_state"]
                              - stamps["load_latest"]) * 1e3,
        "resume_first_step_ms": (done[0] - stamps["restore_training_state"])
        * 1e3,
        "resume_warmup_and_capture_ms":
            (done[2] - stamps["restore_training_state"]) * 1e3,
        "step_ms": {"uninterrupted": ref_clock.ms,
                    "with_manager": int_clock.ms, "resumed": res_clock.ms},
        # the steps after the capture (the 4th on)
        "step_p50_ms_without_manager": float(np.median(ref_clock.ms[3:])),
        "step_p50_ms_with_manager": float(np.median(int_clock.ms[3:]))}


def ckpt_sync_save(mt, mod, directory, step):
    """A synchronous save of ``mod`` → its blocking ms and bytes."""
    mgr = mt.CheckpointManager(directory, async_save=False, keep=1)
    mgr.save(module=mod, epoch=0, nbatch=step - 1, step=step)
    return {"blocking_ms": mgr.last_blocking_ms, "bytes": mgr.last_bytes}


def ckpt_three_runs(torch, mt, counts, label, make, fit_kw, stop, every,
                    root, state_of, tape_of=None):
    """The uninterrupted run, the run with a manager stopped after
    ``stop`` steps, and the resume of a fresh module from its checkpoint,
    for ``make()`` → (module, iterator) → (the gated record, the
    uninterrupted run's and the resumed run's tapes)."""
    ckpt_dir = os.path.join(root, label)
    seed, other = CKPT_SEEDS
    mod, it = make()
    ref_tape = tape_of() if tape_of else None
    ref_clock, _ = ckpt_fit(torch, mt, counts, f"{label} uninterrupted",
                            mod, it, fit_kw(True), seed, tape=ref_tape)
    ref = state_of(mod)
    runs = {"uninterrupted": graph_stats(mod)["captures"]}
    del mod
    torch.cuda.empty_cache()
    mod, it = make()
    mgr = mt.CheckpointManager(ckpt_dir, every_n_steps=every,
                               async_save=True, keep=2)
    blocking = []
    save = mgr.save

    def timed_save(*a, **kw):
        save(*a, **kw)
        blocking.append(mgr.last_blocking_ms)
    mgr.save = timed_save
    int_clock, _ = ckpt_fit(torch, mt, counts, f"{label} interrupted", mod,
                            it, fit_kw(True), seed, stop=stop, manager=mgr,
                            tape=tape_of() if tape_of else None)
    mgr.close()
    check(len(int_clock.ms) == stop, f"{label}: the interrupted run took "
          f"{len(int_clock.ms)} steps, not {stop}")
    check(mgr.last_error is None, f"{label}: {mgr.last_error!r}")
    saved = {"blocking_ms": blocking[0], "save_ms": mgr.last_save_ms,
             "bytes": mgr.last_bytes}
    sync = ckpt_sync_save(mt, mod, os.path.join(root, f"{label}-sync"),
                          stop)
    # the snapshot's host ms alone (device copies, no write), twice: the
    # first with the copies' memory new to the allocator, the second
    # with it cached
    saved["snapshot_ms"] = []
    for _ in range(2):
        t0 = time.perf_counter()
        snap = (mod.get_params(), mod._optimizer_states_to_host(lazy=True))
        saved["snapshot_ms"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        del snap
    runs["interrupted"] = graph_stats(mod)["captures"]
    del mod
    torch.cuda.empty_cache()
    mod, it = make()
    res_tape = tape_of() if tape_of else None
    res_mgr = mt.CheckpointManager(ckpt_dir, every_n_steps=0)
    res_clock, stamps = ckpt_fit(torch, mt, counts, f"{label} resumed", mod,
                                 it, fit_kw(False), other, manager=res_mgr,
                                 tape=res_tape)
    res_mgr.close()
    check(len(res_clock.ms) + every == len(ref_clock.ms), f"{label}: the "
          f"resumed run took {len(res_clock.ms)} steps after step {every}")
    runs["resumed"] = graph_stats(mod)["captures"]
    rec = ckpt_resume_record(torch, mt, label, ref, state_of(mod),
                             ref_clock, int_clock, res_clock, stamps, saved,
                             sync, ckpt_dir, runs)
    del mod
    torch.cuda.empty_cache()
    return rec, ref_tape, res_tape


def ckpt_lm(torch, mt, ck, counts, root):
    """(a) The dropout LM: 10 steps, stopped after ``CKPT_STOP`` with a
    checkpoint every ``CKPT_EVERY``, resumed (``ckpt_three_runs``); the
    resumed run's masks must be the uninterrupted run's."""
    L = GPT2_SMALL["num_layers"]
    params = gpt2_small_params(0)
    sym = packed_lm_symbol(mt, LM_DROPOUT)

    def make():
        return mt.mod.Module(sym, context=mt.gpu(0)), lm_batches(mt)

    def fit_kw(with_params):
        return dict(optimizer="sgd", eval_metric="loss",
                    optimizer_params={"learning_rate": TRAIN_LR,
                                      "momentum": 0.9},
                    arg_params=params if with_params else None)

    def state_of(mod):
        w = {n: mod._exec.arg_dict[n]._data.clone()
             for n in mod._param_names}
        w.update({f"{n} momentum": s.clone()
                  for n, s in mod._fused.states.items()})
        return w

    rec, ref_tape, res_tape = ckpt_three_runs(
        torch, mt, counts, "ckpt-lm", make, fit_kw, CKPT_STOP, CKPT_EVERY,
        root, state_of, tape_of=lambda: MaskTape(2 * L, 1 - LM_DROPOUT))
    want = ref_tape.steps[CKPT_EVERY:]
    check(len(res_tape.steps) == len(want), f"{len(res_tape.steps)} "
          f"resumed steps' masks, not {len(want)}")
    same = [all(torch.equal(a, b) for a, b in zip(x, y))
            for x, y in zip(want, res_tape.steps)]
    check(all(same), f"the resumed LM's masks of steps "
          f"{CKPT_EVERY + 1}-{TRAIN_STEPS} part from the uninterrupted "
          f"run's: {same}")
    rec.update(masks_equal_steps=list(range(CKPT_EVERY + 1,
                                            TRAIN_STEPS + 1)),
               dropout=LM_DROPOUT, steps=TRAIN_STEPS,
               stopped_after=CKPT_STOP, every_n_steps=CKPT_EVERY)
    return rec


def ckpt_lstm(torch, mt, ck, counts, root):
    """(b) LSTM-PTB through ``BucketingModule.fit`` (Adam 0.01,
    ``Uniform(0.08)``, zero states): ``CKPT_LSTM_BATCHES`` batches, a
    checkpoint every ``CKPT_LSTM_EVERY``, stopped after
    ``CKPT_LSTM_STOP``, resumed (``ckpt_three_runs``)."""
    cfg = LSTM_PTB
    L, Hd, B = cfg["num_layers"], cfg["num_hidden"], cfg["batch"]
    sentences = synthetic_corpus(LSTM_TRAIN_SENTENCES, cfg["vocab"],
                                 max(cfg["buckets"]), seed=1)

    def make():
        it = BucketSentenceIter(mt, sentences, B, list(cfg["buckets"]),
                                seed=3)
        it._plan = it._plan[:CKPT_LSTM_BATCHES]
        mod = mt.mod.BucketingModule(
            lstm_sym_gen(mt, cfg["vocab"], cfg["num_embed"], Hd, L),
            default_bucket_key=it.default_bucket_key, context=mt.gpu(0))
        return mod, it

    def fit_kw(_):
        zeros = mt.nd.zeros((L, B, Hd), ctx=mt.gpu(0))
        return dict(optimizer="adam", optimizer_params={
                        "learning_rate": 0.01},
                    eval_metric=mt.metric.Perplexity(ignore_label=0),
                    initializer=mt.initializer.Uniform(0.08),
                    arg_params={"rnn_state": zeros,
                                "rnn_state_cell": zeros.copy()},
                    allow_missing=True)

    def state_of(mod):
        cur = mod._curr_module
        w = {n: cur._exec.arg_dict[n]._data.clone()
             for n in cur._param_names}
        w.update({f"{n} adam": tuple(x.clone() for x in s)
                  for n, s in cur._fused.states.items()})
        return w

    rec = ckpt_three_runs(torch, mt, counts, "ckpt-lstm", make, fit_kw,
                          CKPT_LSTM_STOP, CKPT_LSTM_EVERY, root,
                          state_of)[0]
    rec.update(batches=CKPT_LSTM_BATCHES, stopped_after=CKPT_LSTM_STOP,
               every_n_steps=CKPT_LSTM_EVERY)
    return rec


def ckpt_resnet(torch, mt, root):
    """(c) ResNet-50 through ``train_imagenet.py --benchmark 1``: one
    epoch with ``--model-prefix``, whose checkpoint's arrays equal the
    module's bit for bit, then ``--load-epoch 1`` for one more, which
    begins at epoch 1 with finite outputs."""
    from mxnet_tpu_torch.examples import train_imagenet

    prefix = os.path.join(root, "r50")
    argv = ["--benchmark", "1", "--network", IMAGE["network"],
            "--batch-size", str(IMAGE["batch"]), "--num-batches",
            str(CKPT_RESNET_BATCHES), "--model-prefix", prefix]
    t0 = time.perf_counter()
    mod = train_imagenet.main(argv + ["--num-epochs", "1"])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, arg, aux = mt.model.load_checkpoint(prefix, 1)
    load_ms = (time.perf_counter() - t0) * 1e3
    have_arg, have_aux = mod.get_params()
    check(sorted(arg) == sorted(have_arg) and sorted(aux) == sorted(have_aux)
          and len(aux) == 102, f"the checkpoint holds {len(arg)} args and "
          f"{len(aux)} aux states")
    parted = [k for src, have in ((arg, have_arg), (aux, have_aux))
              for k, v in src.items()
              if not torch.equal(v._data, have[k]._data.cpu())]
    check(not parted, f"ResNet-50's checkpoint parts from the module: "
          f"{parted[:8]}")
    nbytes = os.path.getsize(prefix + "-0001.params")
    del mod
    torch.cuda.empty_cache()
    begun = []
    fit = mt.mod.Module.fit

    def spy(self, *a, **kw):
        begun.append(kw.get("begin_epoch"))
        return fit(self, *a, **kw)

    mt.mod.Module.fit = spy
    try:
        t0 = time.perf_counter()
        mod = train_imagenet.main(argv + ["--num-epochs", "2",
                                          "--load-epoch", "1"])
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
    finally:
        mt.mod.Module.fit = fit
    check(begun == [1], f"--load-epoch 1 began at epochs {begun}")
    out = mod.get_outputs()[0]._data
    check(bool(torch.isfinite(out).all()), "the resumed ResNet-50's "
          "outputs are not finite")
    check(os.path.exists(prefix + "-0002.params"), "no epoch-2 checkpoint")
    del mod
    torch.cuda.empty_cache()
    return {"args": len(arg), "aux_states": len(aux),
            "params_bytes": nbytes, "load_checkpoint_ms": load_ms,
            "arrays_bit_for_bit": True, "begin_epoch": 1,
            "epoch1_wall_s": first_s, "resumed_epoch_wall_s": second_s,
            "batches_an_epoch": CKPT_RESNET_BATCHES}


def ckpt_path(torch, mt, ck):
    """Phase 12 on ``gpu(0)``, fp32 with TF32 off: (a) the dropout LM
    (``ckpt_lm``), (b) LSTM-PTB (``ckpt_lstm``), (c) ResNet-50 through
    ``train_imagenet.py`` (``ckpt_resnet``), every checkpoint under one
    temporary directory removed at the end, the SIGTERM handler the
    managers install put back.  Launch counts summed over the traced
    regions of (a) and (b)."""
    counts = Launches(torch, ck)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    handler = signal.getsignal(signal.SIGTERM)
    rec, wall = {}, {}
    try:
        for part, fn in (("lm", lambda: ckpt_lm(torch, mt, ck, counts,
                                                root)),
                         ("lstm", lambda: ckpt_lstm(torch, mt, ck, counts,
                                                    root)),
                         ("resnet", lambda: ckpt_resnet(torch, mt, root))):
            counted = launch_counts(ck)
            t0 = time.perf_counter()
            rec[part] = fn()
            torch.cuda.synchronize()
            wall[part] = time.perf_counter() - t0
            print(json.dumps({f"ckpt_{part}": rec[part]}))
            if part == "resnet":
                now = launch_counts(ck)
                check(now == counted, f"phase 12 {part} counted launches: "
                      f"{ {k: n - counted[k] for k, n in now.items()} }")
            torch.cuda.empty_cache()
    finally:
        signal.signal(signal.SIGTERM, handler)
        shutil.rmtree(root, ignore_errors=True)
    launched = {k: v for k, v in counts.total.items() if v}
    lm_steps = TRAIN_STEPS + CKPT_STOP + TRAIN_STEPS - CKPT_EVERY
    lstm_batches = (CKPT_LSTM_BATCHES + CKPT_LSTM_STOP + CKPT_LSTM_BATCHES
                    - CKPT_LSTM_EVERY)
    L = GPT2_SMALL["num_layers"]
    want = {"flash_mha_packed": L * lm_steps,
            "flash_mha_packed_bwd_dq": L * lm_steps,
            "flash_mha_packed_bwd_dkv": L * lm_steps,
            "lstm_scan": LSTM_PTB["num_layers"] * lstm_batches}
    check(launched == want, f"phase 12 launched {launched}, not {want}")
    rec.update(part_wall_s=wall, launches=counts.total)
    return rec


# ---------------------------------------------------------------------------
# phase 13: bf16 training and storage
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def tf32(torch, on):
    """TF32 for matmuls and cuDNN ``on`` while entered (this script's
    setting, off, restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def half_lm_first_step(torch, mt, ck, params, batch, dtype):
    """One eager ``forward_backward`` of the training LM in fp32 and in
    ``dtype`` (bfloat16 or float16) from the same weights (``params``,
    rounded to ``dtype`` in its module) on ``batch``: the mean loss within
    ``HALF_FIRST_STEP[dtype]["loss"]`` of the fp32 one (relative), its
    gradients within ``HALF_FIRST_STEP[dtype]["grad"]`` in relative norm
    over every parameter; the per-token loss difference, the worst
    parameter and each parameter's dtype recorded."""
    res = {}
    for dt in ("float32", dtype):
        with fused_env("0"):
            mod = lm_module(mt, packed_lm_symbol(mt, dtype=dt), params)
        mod.forward_backward(batch)
        ex = mod._exec
        res[dt] = (ex.outputs[0]._data.float().clone(),
                   {n: ex.grad_dict[n]._data.float().clone()
                    for n in mod._param_names},
                   {n: str(ex.arg_dict[n]._data.dtype)
                    for n in mod._param_names})
        del mod, ex
        torch.cuda.empty_cache()
    (l32, g32, _), (lh, gh, types) = res["float32"], res[dtype]
    tol = HALF_FIRST_STEP[dtype]
    check(types["tok_embed_weight"] == "torch.float32"
          and {t for n, t in types.items() if n != "tok_embed_weight"}
          == {f"torch.{dtype}"}, f"{dtype} LM parameter dtypes: {types}")
    check(bool(torch.isfinite(lh).all()) and all(
        bool(torch.isfinite(g).all()) for g in gh.values()),
        f"{dtype} LM first step: a loss or gradient is not finite")
    loss_rel = abs(float(lh.mean()) - float(l32.mean())) \
        / float(l32.mean())
    diff = torch.cat([(gh[n] - g32[n]).reshape(-1) for n in g32]).norm()
    ref = torch.cat([g.reshape(-1) for g in g32.values()]).norm()
    grad_rel = float(diff / ref)
    worst = max(g32, key=lambda n: float((gh[n] - g32[n]).norm()
                                         / g32[n].norm().clamp_min(1e-30)))
    rec = {"dtype": dtype, "mean_loss_fp32": float(l32.mean()),
           "mean_loss": float(lh.mean()), "mean_loss_rel_err": loss_rel,
           "token_loss_max_abs_err": float((lh - l32).abs().max()),
           "grad_rel_norm_err": grad_rel, "worst_param": worst,
           "worst_param_rel_norm_err": float(
               (gh[worst] - g32[worst]).norm() / g32[worst].norm()),
           "zero_grad_elements": {
               "fp32": sum(int((g == 0).sum()) for g in g32.values()),
               dtype: sum(int((g == 0).sum()) for g in gh.values())},
           "tolerance": tol}
    check(loss_rel <= tol["loss"] and grad_rel <= tol["grad"],
          f"{dtype} LM first step against fp32: {rec}")
    print(f"{dtype} LM first step against fp32: {rec}")
    return rec


def half_lm_train(torch, mt, ck, counts, params, dtype):
    """The training run's LM built in ``dtype`` (``transformer_lm(...,
    dtype=...)``, bfloat16 or float16), ``TRAIN_STEPS`` Adam steps
    (``BF16_OPT``, no loss scaling: the JAX package has none) through the
    fused step's CUDA graphs, and again under ``MXNET_FUSED_STEP=0`` from
    the same weights, the graphed steps held to the eager ones at the
    dtype's ``TOL``/``BWD_TOL`` (``lm_train_pair``).  Gates: a falling,
    finite loss; B1's three kernels a layer a step, each launch of the
    graphed run the dtype's instantiation in the device trace.  Records
    the share of the half-precision parameters' elements that step 10
    changed.  → (the record, the trained parameters on the device)."""
    L = GPT2_SMALL["num_layers"]
    tag = HALF_TAG[dtype]
    dt = getattr(torch, dtype)
    kept, before, changed = {}, {}, {}

    def keep(mod):
        kept.update({k: v._data for k, v in mod.get_params()[0].items()})

    state = {}

    def make():
        mod = lm_module(mt, packed_lm_symbol(mt, dtype=dtype), params)
        state["mod"] = mod
        return mod

    def snapshot(step):
        mod = state["mod"]
        arg = mod._exec.arg_dict
        names = [n for n in mod._param_names if arg[n]._data.dtype == dt]
        if step == TRAIN_STEPS - 2:
            before.update({n: arg[n]._data.clone() for n in names})
        elif step == TRAIN_STEPS - 1:
            moved = sum(int((arg[n]._data != before[n]).sum())
                        for n in names)
            total = sum(before[n].numel() for n in names)
            changed.update(elements=total, changed=moved,
                           share=moved / total)
            before.clear()

    rec = lm_train_pair(
        torch, mt, ck, make, lm_batches(mt), PACKED_KERNELS,
        [f"layer{i}_qkv_weight" for i in range(L)], f"{tag} training",
        keep=keep, tally=counts.add, opt=BF16_OPT,
        dtype=dtype, after_step=snapshot)
    state.clear()
    for k in PACKED_KERNELS:
        got = rec[f"{tag}_launches"].get(k, 0)
        check(got == L * TRAIN_STEPS, f"{tag} training: {got} {tag} "
              f"launches of {k} in the trace, not {L * TRAIN_STEPS}")
    check(changed.get("changed", 0) > 0, f"{tag} training: step "
          f"{TRAIN_STEPS} changed no {tag} weight ({changed})")
    rec["step_changed_elements"] = changed
    return rec, kept


def half_serving(torch, mt, ck, counts, params, dtype):
    """The GPT-2-class LM served in ``dtype`` by ``DecodeEngine``, each
    run a device trace (``serve_run(trace=)``).  Run 0: its random
    weights (phase 3's, ``tok_embed_weight`` float32, the rest rounded to
    ``dtype``) with ``dtype=dtype`` pages, run A's 16 requests of 32
    tokens; then the trained LM (``params``): run 1 the same, run 2 over
    other pages (bf16: ``kv_dtype="bf16"``, whose greedy tokens must equal
    run 1's; fp16: ``kv_dtype="int8"``, fp16 queries over int8 codes),
    run 3 ``spec_tokens=4`` over the spec prompts; fp16 also a prefix hit
    (``half_prefix_hit``).  Gates: the engine's parameters keep their
    dtypes; every traced B1 and paged launch is the dtype's
    instantiation, as many as prefills and steps (plain and verify)
    times the layers; run 0's greedy tokens are the full forward's argmax
    wherever its top-2 margin exceeds ``BF16_MARGIN`` U of the row's
    largest logit, at a quarter of them at least; the trained LM's top
    logits lie within that margin of each other (ten steps taught it the
    few hundred ids its random walk visits, alike), so the later runs'
    tokens are held to the band: each within that margin (over int8
    pages ``INT8_MARGIN``) of the full forward's top logit."""
    L = GPT2_SMALL["num_layers"]
    tag, u = HALF_TAG[dtype], HALF_U[dtype]
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(1)
    lens = rng.randint(32, 901, size=16)
    prompts = [rng.randint(1, GPT2_SMALL["vocab_size"], size=n)
               .astype(np.int32) for n in lens]
    temps = [0.8 if i in (3, 11) else 0.0 for i in range(16)]
    spec = spec_prompts()
    spec_temps = [0.0] * len(spec)
    runs, outs = {}, {}
    random_params = {k: torch.from_numpy(v) if k == "tok_embed_weight"
                     else torch.from_numpy(v).to(dt)
                     for k, v in gpt2_small_params(0).items()}
    other = dict(kv_dtype="bf16") if dtype == "bfloat16" \
        else dict(kv_dtype="int8")
    letter = "S" if dtype == "bfloat16" else "F"
    for i, kw, weights, pr, tp, new in (
            (0, dict(dtype=dtype), random_params, prompts, temps, 32),
            (1, dict(dtype=dtype), params, prompts, temps, 32),
            (2, other, params, prompts, temps, 32),
            (3, dict(dtype=dtype, spec_tokens=SPEC_K, proposer="ngram"),
             params, spec, spec_temps, SPEC_NEW)):
        run = f"{letter}{i}"
        model, outs[run], st, launches, rec = serve_run(
            torch, mt, ck, weights, pr, tp, new, trace=f"{run} serving",
            **kw)
        counts.add(launches)
        dtypes = {n: str(p.dtype) for n, p in model.named_parameters()}
        check(dtypes.pop("tok_embed_weight") == "torch.float32"
              and set(dtypes.values()) == {f"torch.{dtype}"},
              f"{run}: engine parameter dtypes {dtypes}")
        half = rec["half_launches"][tag]
        want = {"flash_mha_packed": L * st["prefills"],
                "paged_attention": L * st["steps"]}
        got = {k: (launches.get(k, 0), half.get(k, 0)) for k in want}
        check(all(g == (n, n) for g, n in zip(got.values(), want.values()))
              and launches["paged_attention_verify"]
              + launches["paged_attention_verify_quant"]
              == L * st["spec_steps"],
              f"{run}: (traced, {tag}) launches {got}, want {want}")
        check(st["steps"] > 0 and (st["spec_steps"] > 0) == (i == 3),
              f"{run}: {st}")
        margin = INT8_MARGIN if kw.get("kv_dtype") == "int8" \
            else BF16_MARGIN * u
        forward_check(torch, model, pr, outs[run], tp,
                      [len(p) for p in pr], run, rel_margin=margin,
                      band=i != 0)
        rec["greedy_tokens"] = [o.tolist() for o, t in zip(outs[run], tp)
                                if t == 0.0][:2]
        runs[run] = rec
        del model
        torch.cuda.empty_cache()
    del random_params
    if dtype == "bfloat16":
        for i, t in enumerate(temps):
            if t == 0.0:
                check(np.array_equal(outs["S1"][i], outs["S2"][i]),
                      f"S2 stream {i}: greedy tokens differ from S1's")
    else:
        runs["F4"] = half_prefix_hit(torch, mt, ck, counts, params, dtype)
    return runs


def half_prefix_hit(torch, mt, ck, counts, params, dtype):
    """A prefix hit served in ``dtype`` pages: a 256-token prompt, then the
    same plus 64 new tokens, 32 greedy tokens each; the second must hit
    the 256 cached tokens and run B8 twice a layer (the dtype's
    instantiation, traced: the cached pages under the key limit, then
    the suffix), and both chains
    lie within ``BF16_MARGIN`` U of the full forward's top logit (the
    trained LM's band)."""
    L = GPT2_SMALL["num_layers"]
    tag = HALF_TAG[dtype]
    rng = np.random.RandomState(29)
    first = rng.randint(1, GPT2_SMALL["vocab_size"], 256).astype(np.int32)
    second = np.concatenate([first, rng.randint(
        1, GPT2_SMALL["vocab_size"], 64).astype(np.int32)])
    with mt.DecodeEngine(params, **GPT2_SMALL, ctx=mt.gpu(0),
                         kv_block=KVB, max_streams=16, seed=0,
                         dtype=dtype) as eng:
        eng.generate(np.arange(1, 20, dtype=np.int32), 2)  # CUDA warm-up
        a = eng.generate(first, 32)
        torch.cuda.synchronize()
        eng.reset_stats()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        with TracedLaunches(torch, ck, f"{tag} prefix hit") as tr:
            b = eng.generate(second, 32)
        wall = time.perf_counter() - t0
        st = eng.stats()
        model = eng.model
        check(st["prefix_hits"] == 1 and st["prefix_hit_tokens"] == 256
              and st["prefills"] == 1,
              f"{tag} prefix hit: {st['prefix_hits']} hits of "
              f"{st['prefix_hit_tokens']} tokens")
        counts.add(tr.launches)
        half = tr.fp16_launches if dtype == "float16" else tr.bf16_launches
        want = {"flash_attention_partial": 2 * L, "flash_mha_packed": 0,
                "paged_attention": L * st["steps"]}
        got = {k: (tr.launches.get(k, 0), half.get(k, 0)) for k in want}
        check(all(g == (n, n) for g, n in zip(got.values(), want.values())),
              f"{tag} prefix hit: (traced, {tag}) launches {got}, want "
              f"{want}")
        forward_check(torch, model, [first, second], [a, b], [0.0, 0.0],
                      [256, 320], f"{tag} prefix hit",
                      rel_margin=BF16_MARGIN * HALF_U[dtype], band=True)
        del model
    return {"prefix_hit_tokens": st["prefix_hit_tokens"],
            "ttft_p50_ms": st["ttft_p50_ms"], "wall_s": wall,
            "launches": tr.launches, "half_launches": half}


def grad_distance(torch, grads, ref):
    """→ (the error norm over all weights relative to ``ref``'s norm,
    the largest error of a weight over its largest value), weights whose
    reference gradient is exactly zero left out of the second."""
    diff = torch.cat([(grads[n] - ref[n]).reshape(-1) for n in ref]).norm()
    norm = torch.cat([g.reshape(-1) for g in ref.values()]).norm()
    worst = max(((grads[n] - ref[n]).abs().max()
                 / ref[n].abs().max()).item()
                for n in ref if ref[n].any())
    return float(diff / norm), worst


@contextlib.contextmanager
def node_inputs(mt, sym):
    """While entered, every op node of ``sym`` that runs keeps a copy of
    its inputs and aux states, the first of each (op, attributes, input
    shapes and dtypes): yields {key: (op name, attrs, inputs, aux)}."""
    from mxnet_tpu_torch.ops.registry import get_op

    kept = {}
    ops = {n.op for n in sym._topo() if not n.is_variable}
    saved = {name: get_op(name).compute for name in ops}

    def spy(name, compute):
        def run(op_ctx, attrs, inputs, aux):
            key = (name, tuple(sorted(attrs.items())),
                   tuple((tuple(x.shape), str(x.dtype)) for x in inputs))
            if key not in kept:
                kept[key] = (name, dict(attrs),
                             [x.detach().clone() for x in inputs],
                             [x.detach().clone() for x in aux])
            return compute(op_ctx, attrs, inputs, aux)
        return run

    for name, compute in saved.items():
        get_op(name).compute = spy(name, compute)
    try:
        yield kept
    finally:
        for name, compute in saved.items():
            get_op(name).compute = compute


def node_errors(torch, mt, name, attrs, inputs, aux, seed):
    """One op node run alone in training mode on its recorded inputs, in
    their dtypes on the card and in float64 (the same values), forward
    and backward from one seeded head gradient rounded to the output's
    dtype → the largest relative error norm over its outputs and its
    inputs' gradients, and the float64 norms of those."""
    from mxnet_tpu_torch.ops.registry import OpContext, get_op

    op = get_op(name)

    def run(xs, aux_states):
        xs = [x.clone().requires_grad_(x.is_floating_point()) for x in xs]
        outs = op.compute(OpContext(is_train=True), attrs, xs,
                          [a.clone() for a in aux_states])
        if aux_states:
            outs = outs[0]
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        return xs, outs

    xs, outs = run(inputs, aux)
    rs, routs = run([x.double() for x in inputs], [a.double() for a in aux])
    g = torch.Generator(device="cpu").manual_seed(seed)
    heads = [torch.randn(o.shape, generator=g, dtype=torch.float64)
             .to(o.dtype).to(o.device) for o in outs]
    want = [i for i, x in enumerate(xs) if x.requires_grad]
    grads = torch.autograd.grad(outs, [xs[i] for i in want], heads,
                                allow_unused=True)
    rgrads = torch.autograd.grad(routs, [rs[i] for i in want],
                                 [h.double() for h in heads],
                                 allow_unused=True)
    worst, what = 0.0, None
    pairs = [(f"output {i}", o, r) for i, (o, r) in enumerate(zip(outs, routs))]
    pairs += [(f"input {i} gradient", a, b) for i, a, b in
              zip(want, grads, rgrads) if a is not None and b is not None]
    for label, a, b in pairs:
        norm = float(b.detach().norm())
        if norm == 0.0:
            continue
        err = float((a.detach().double() - b.detach()).norm()) / norm
        if err >= worst:
            worst, what = err, label
    return worst, what


def bf16_resnet_first_steps(torch, mt):
    """ResNet-50's first step (batch ``IMAGE["check_batch"]``, the seeded
    ``Xavier(gaussian, in, 2)`` parameters of phase 10) on the card in
    fp32 with TF32 off, with TF32 on, and bound in bf16 from a bf16 data
    descriptor, each against the port's float64 step on the CPU: the
    gradients' error norm over all weights (relative to the float64
    norm) and the largest error of a weight over its largest value, the
    measure of phase 10, recorded.  That step is ill-conditioned (C13):
    no bound holds it.  So for TF32 and bf16 every op node of the step,
    the first of each (op, attributes, shapes), is run alone on the card
    on the inputs it met in the step and held to the same node in
    float64 on the same values: its outputs and its inputs' gradients
    (from a seeded head gradient) within ``NODE_UNITS`` roundings of the
    format (``ROUNDING_UNIT``) in relative norm.  Outputs finite."""
    B = IMAGE["check_batch"]
    sym = resnet50(mt)
    rng = np.random.RandomState(11)
    X = rng.rand(B, *IMAGE["image_shape"]).astype(np.float32)
    Y = rng.randint(0, IMAGE["classes"], size=B).astype(np.float32)
    batch = mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                            [mt.nd.array(Y, ctx=mt.cpu())])
    init = image_bind(mt, sym, mt.cpu(), B, shape=IMAGE["image_shape"])
    mt.random.seed(0)
    init.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    params = init.get_params()
    del init
    t0 = time.perf_counter()
    _, loss64, grads64, _ = image_step(torch, mt, sym, mt.cpu(), params,
                                       batch, float64=True)
    cpu_s = time.perf_counter() - t0
    out = {"float64_cpu_s": cpu_s, "float64_loss": loss64}
    for variant, dtype, on in (("fp32", "float32", False),
                               ("tf32", "float32", True),
                               ("bf16", "bfloat16", False)):
        with tf32(torch, on), node_inputs(mt, sym) as nodes:
            o, loss, grads, _ = image_step(torch, mt, sym, mt.gpu(0),
                                           params, batch, dtype=dtype)
        check(bool(torch.isfinite(o).all()) and np.isfinite(loss)
              and all(bool(torch.isfinite(g).all())
                      for g in grads.values()),
              f"ResNet-50 {variant} first step: not finite")
        norm, worst = grad_distance(torch, grads, grads64)
        out[variant] = {"loss": loss, "grad_err_norm_vs_float64": norm,
                        "grad_max_rel_err_vs_float64": worst}
        if variant != "fp32":
            tol = NODE_UNITS * ROUNDING_UNIT[variant]
            errs = {}
            with tf32(torch, on):
                for i, (name, attrs, xs, aux) in enumerate(nodes.values()):
                    errs[f"{name} {i}"] = node_errors(torch, mt, name, attrs,
                                                      xs, aux, seed=i)
            top = max(errs, key=lambda k: errs[k][0])
            by_op = {}
            for k, (e, _) in errs.items():
                op = k.split()[0]
                by_op[op] = max(by_op.get(op, 0.0), e)
            out[variant]["nodes"] = {
                "checked": len(errs), "tolerance": tol,
                "worst": {"node": top, "part": errs[top][1],
                          "rel_err": errs[top][0]},
                "worst_by_op": by_op}
            check(errs[top][0] <= tol, f"ResNet-50 {variant}: node {top}'s "
                  f"{errs[top][1]} is {errs[top][0]:.3e} from float64 in "
                  f"relative norm, over {tol:.3e}")
        del nodes
        torch.cuda.empty_cache()
    print(f"ResNet-50 first steps against float64: {out}")
    return out


def bf16_resnet_run(torch, mt, variant):
    """``resnet_run`` (phase 10's 2 epochs of 20 batches at batch 32)
    in bf16 (the data's descriptor binds the network in bf16) or fp32
    with TF32 on, through the fused step; then an eager module from its
    parameters split by aten op (``resnet_breakdown``)."""
    dtype = "bfloat16" if variant == "bf16" else "float32"
    with tf32(torch, variant == "tf32"):
        rec, mod, batch = resnet_run(torch, mt, dtype=dtype)
        rec["graphs"] = graph_stats(mod)
        arg, aux = mod.get_params()
        types = {str(a._data.dtype) for a in arg.values()}
        check(types == {f"torch.{dtype}"}, f"ResNet-50 {variant}: "
              f"parameter dtypes {types}")
        check({str(a._data.dtype) for a in aux.values()}
              == {"torch.float32"}, f"ResNet-50 {variant}: aux dtypes")
        del mod
        torch.cuda.empty_cache()
        with fused_env("0"):
            emod = image_bind(mt, resnet50(mt), mt.gpu(0), IMAGE["batch"],
                              shape=IMAGE["image_shape"], dtype=dtype)
        emod.init_params(arg_params=arg, aux_params=aux)
        emod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": IMAGE["lr"], "wd": IMAGE["wd"],
            "momentum": IMAGE["momentum"]})
        rec["eager_breakdown"] = resnet_breakdown(torch, mt, emod, batch)
        del emod
    torch.cuda.empty_cache()
    rec.pop("step_ms")
    print(f"ResNet-50 {variant}: step p50 {rec['step_p50_ms']:.2f} ms, "
          f"{rec['images_per_s']:.1f} images/s; eager device ms by op "
          f"{rec['eager_breakdown']['forward_backward_device_ms']}")
    return rec


def bf16_path(torch, mt, ck):
    """Phase 13 on ``gpu(0)``, for bf16 and then fp16: (a) the training
    run's LM in that dtype, its first step against fp32
    (``half_lm_first_step``) and 10 Adam steps graphed and eager
    (``half_lm_train``); (b) the trained LM served (``half_serving``);
    then (c) ResNet-50's first steps against float64 in fp32, TF32 and
    bf16 (``bf16_resnet_first_steps``) and its training run in bf16 and
    under TF32 (``bf16_resnet_run``).  Launch counts reset just before
    and summed over (a) and (b) just after."""
    counts = Launches(torch, ck)
    reset_launch_counts(ck)
    wall = {}
    params = gpt2_small_params(0)
    batch = next(iter(lm_batches(mt)))
    lm = {}
    for dtype in HALF_DTYPES:
        tag = HALF_TAG[dtype]
        t0 = time.perf_counter()
        with TracedLaunches(torch, ck, f"{tag} first step", on=False) as tr:
            first = half_lm_first_step(torch, mt, ck, params, batch, dtype)
        counts.add(tr.launches)
        train, trained = half_lm_train(torch, mt, ck, counts, params, dtype)
        torch.cuda.empty_cache()
        wall[f"{tag}_lm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serving = half_serving(torch, mt, ck, counts, trained, dtype)
        del trained
        torch.cuda.empty_cache()
        wall[f"{tag}_serving"] = time.perf_counter() - t0
        lm[dtype] = {"first_step": first, "train": train,
                     "serving": serving}
    del params
    now = launch_counts(ck)
    t0 = time.perf_counter()
    resnet = {"first_steps": bf16_resnet_first_steps(torch, mt)}
    for variant in ("bf16", "tf32"):
        resnet[variant] = bf16_resnet_run(torch, mt, variant)
    check(launch_counts(ck) == now, "phase 13: ResNet-50 launched a kernel "
          "of the port's")
    wall["resnet"] = time.perf_counter() - t0
    launched = {k: v for k, v in counts.total.items() if v}
    check(all(launched.get(k, 0) > 0 for k in PACKED_KERNELS + (
        "paged_attention_decode", "paged_attention_verify",
        "paged_attention_decode_quant", "flash_attention_partial")),
        f"phase 13 launched {launched}")
    rec = {"lm": lm, "resnet50": resnet, "part_wall_s": wall,
           "launches": counts.total,
           "bf16_traced_launches": lm["bfloat16"]["train"]["bf16_launches"],
           "fp16_traced_launches": lm["float16"]["train"]["fp16_launches"]}
    summary = {}
    for dtype, r in lm.items():
        train = r["train"]
        summary[HALF_TAG[dtype]] = {
            "lm_step_p50_ms": train["step_p50_ms"],
            "lm_eager_step_p50_ms": train.get("eager_step_p50_ms"),
            "lm_step_device_ms": train["step_device_ms"],
            "lm_eager_step_device_ms": train.get("eager_step_device_ms"),
            "lm_graphs": train["graphs"],
            "lm_peak_memory_bytes": train["peak_memory_bytes"],
            "lm_tokens_per_s": train["tokens_per_s"],
            "lm_losses": train["losses"],
            "lm_graphed_vs_eager": train.get(
                "graphed_vs_eager_err_over_tol"),
            "lm_step_changed_share":
                train["step_changed_elements"]["share"],
            "first_step": r["first_step"],
            "serving": {run: {k: x.get(k) for k in (
                "tokens_per_s", "ttft_p50_ms", "decode_step_p50_ms",
                "half_launches", "accepted_token_rate", "kv_dtype",
                "prefix_hit_tokens")} for run, x in r["serving"].items()}}
    print(json.dumps({"bf16_summary": {
        **summary,
        "resnet50": {v: {"step_p50_ms": resnet[v]["step_p50_ms"],
                         "images_per_s": resnet[v]["images_per_s"],
                         "peak_memory_bytes": resnet[v]["peak_memory_bytes"],
                         "graphs": resnet[v]["graphs"],
                         "eager_device_ms_by_op": resnet[v][
                             "eager_breakdown"]["forward_backward_device_ms"],
                         "eager_update_device_ms": resnet[v][
                             "eager_breakdown"]["update_device_ms"],
                         "grad_err_norm_vs_float64":
                         resnet["first_steps"][v]["grad_err_norm_vs_float64"],
                         "grad_max_rel_err_vs_float64": resnet["first_steps"][
                             v]["grad_max_rel_err_vs_float64"],
                         "nodes": resnet["first_steps"][v]["nodes"]}
                     for v in ("bf16", "tf32")},
        "resnet50_fp32_grad_err_norm_vs_float64":
            resnet["first_steps"]["fp32"]["grad_err_norm_vs_float64"],
        "wall_s": wall}}))
    return rec


# ---------------------------------------------------------------------------
# phase 14: the operator layer (queue A item 5, part 1)
# ---------------------------------------------------------------------------

# the op names the port registered before its operator layer; phase 14's
# op sweep covers every other name the port registers
EARLIER_OPS = frozenset((
    "Activation", "BatchNorm", "Cast", "Concat", "Convolution", "Crop",
    "Custom", "Deconvolution", "DotProductAttention", "Dropout", "Embedding",
    "Flatten", "FullyConnected", "InstanceNorm", "L2Normalization", "LRN",
    "LayerNorm", "LeakyReLU", "MakeLoss", "MultiBoxDetection",
    "MultiBoxPrior", "MultiBoxTarget", "MultiHeadAttention", "Pad",
    "Pooling", "QKVSelfAttention", "RNN", "Reshape", "Softmax",
    "SoftmaxActivation", "SoftmaxCELoss", "SoftmaxOutput", "UpSampling",
    "_add", "_minus", "_mul", "_plus", "_sub", "broadcast_add",
    "broadcast_mul", "broadcast_plus", "cast", "concat", "depth_to_space",
    "elemwise_add", "elemwise_mul", "elemwise_sub", "expand_dims",
    "flatten", "make_loss", "pad", "reshape", "smooth_l1", "space_to_depth",
    "transpose"))


def serving_ops(registry):
    """The serving ops, read from their registrations: the port's ops
    outside ``EARLIER_OPS`` that launch a kernel of the port
    (``kernel=``) or write a pool in place (a ``new_*`` output).  The
    sweep leaves them to phase 19 (b), whose symbols must hold every one
    (``symbol_ops``) and are held against ``TransformerLM``'s same
    calls."""
    out = set()
    for n in registry.list_ops():
        op = registry.get_op(n)
        if n in EARLIER_OPS or not op.compute.__module__.startswith(
                "mxnet_tpu_torch.ops."):
            continue
        if op.launches_kernel({}) or any(
                str(o).startswith("new_") for o in op.output_names({})):
            out.add(n)
    return out


def symbol_ops(sym):
    """The op names of ``sym``'s nodes."""
    return {n.opdef().name for n in sym._topo() if not n.is_variable}


# draws a sampler case makes on the card, and the sigmas its sample mean
# and variance may lie from the distribution's
SAMPLE_DRAWS, SAMPLE_SIGMAS = 1 << 20, 6.0
# (heads, T, D) of the primitive LM's attention at batch 1: the sweep's
# shapes for the ops it uses
PRIMITIVE_ATTN = (12, 1024, 64)
# the primitive LM's eager step by aten op: (class, name keys)
PRIMITIVE_OP_CLASSES = (("bmm", ("aten::bmm",)),
                        ("softmax", ("softmax",)),
                        ("fc", ("addmm", "aten::mm", "aten::matmul")))


def primitive_lm_symbol(sym, vocab, seq_len, num_layers, num_heads,
                        d_model, d_ff):
    """The GPT-2-class LM of ``transformer_lm(..., head="ce")`` with its
    attention written from ``batch_dot`` and ``softmax``, as a user of
    MXNet 0.9 wrote it before there was an attention op, in the symbol
    namespace ``sym`` (``mt.sym`` or the JAX package's ``mx.sym``).  Per
    layer: the packed ``layer{i}_qkv`` ``FullyConnected(flatten=False)``
    → ``SliceChannel(num_outputs=3, axis=2)`` → each part ``Reshape`` to
    (B, T, H, D), ``SwapAxis(1, 2)``, ``Reshape`` to (B*H, T, D) →
    ``batch_dot(q, k, transpose_b=True) * (1 / sqrt(D))`` + a causal bias
    (``arange(T)`` as a row and a column, ``broadcast_greater``, ``*
    -1e9``, ``broadcast_add``) → ``softmax(axis=-1)`` → ``batch_dot(p, v)``
    → back to (B, T, H*D) → ``layer{i}_proj``.  The parameters are the
    packed LM's, under its names."""
    Dh = d_model // num_heads
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    x = sym.Embedding(data, input_dim=vocab, output_dim=d_model,
                      name="tok_embed")
    pos = sym.Variable("pos_embed_weight", shape=(seq_len, d_model),
                       init="[\"zero\", {}]")
    x = sym.broadcast_add(x, sym.expand_dims(pos, axis=0))
    steps = sym.arange(seq_len, name="causal_steps")
    future = sym.broadcast_greater(sym.Reshape(steps, shape=(1, seq_len)),
                                   sym.Reshape(steps, shape=(seq_len, 1)))
    bias = future * -1e9
    for i in range(num_layers):
        name = f"layer{i}"
        h = sym.LayerNorm(x, name=f"{name}_ln1")
        qkv = sym.FullyConnected(h, num_hidden=3 * d_model, flatten=False,
                                 name=f"{name}_qkv")
        parts = sym.SliceChannel(qkv, num_outputs=3, axis=2,
                                 name=f"{name}_split")
        q, k, v = (sym.Reshape(sym.SwapAxis(
            sym.Reshape(parts[j], shape=(0, 0, num_heads, Dh)),
            dim1=1, dim2=2), shape=(-3, 0, 0)) for j in range(3))
        scores = sym.batch_dot(q, k, transpose_b=True) * (1.0 / Dh ** 0.5)
        p = sym.softmax(sym.broadcast_add(scores, bias), axis=-1)
        a = sym.batch_dot(p, v)
        a = sym.Reshape(sym.SwapAxis(
            sym.Reshape(a, shape=(-4, -1, num_heads, 0, 0)), dim1=1,
            dim2=2), shape=(0, 0, -3))
        x = x + sym.FullyConnected(a, num_hidden=d_model, flatten=False,
                                   name=f"{name}_proj")
        h = sym.LayerNorm(x, name=f"{name}_ln2")
        h = sym.FullyConnected(h, num_hidden=d_ff, flatten=False,
                               name=f"{name}_ff1")
        h = sym.Activation(h, act_type="gelu", name=f"{name}_gelu")
        x = x + sym.FullyConnected(h, num_hidden=d_model, flatten=False,
                                   name=f"{name}_ff2")
    x = sym.LayerNorm(x, name="ln_f")
    logits = sym.FullyConnected(x, num_hidden=vocab, flatten=False,
                                name="head")
    return sym.SoftmaxCELoss(logits, label, use_ignore=True, ignore_label=0,
                             name="softmax")


def op_sweep_cases(rng, n=64, m=1024, attn=PRIMITIVE_ATTN):
    """The operator layer's cases: dicts of ``name``, ``ins`` (numpy
    inputs), ``attrs``, ``grads`` (the input slots whose gradient is
    compared), ``exact`` (integer, index and comparison results: equal),
    ``bf16`` (also run on bf16 inputs), ``family``, and for a sampler
    ``moments`` ((mean, variance, excess kurtosis) of its distribution).
    Every op name the port registers outside ``EARLIER_OPS`` has at
    least one case, at (n, m) elementwise shapes and the primitive LM's
    attention shapes ``attn`` for the ops it uses; inputs hold ties,
    negative operands, halves and out-of-range indices where an op
    treats them specially."""
    f32 = np.float32

    def r(*s):
        return rng.randn(*s).astype(f32)

    def u(lo, hi, *s):
        return rng.uniform(lo, hi, s).astype(f32)

    cases = []

    def case(family, name, ins, attrs=None, grads=None, exact=False,
             bf16=False, **extra):
        if grads is None:
            grads = () if exact else tuple(range(len(ins)))
        cases.append(dict(family=family, name=name, ins=ins,
                          attrs=attrs or {}, grads=grads, exact=exact,
                          bf16=bf16, **extra))

    x = r(n, m)
    halves = (rng.randint(-8, 9, (n, m)) / 2).astype(f32)
    pos = u(0.2, 3.0, n, m)
    unit = u(-0.9, 0.9, n, m)
    domains = {"pos": pos, "unit": unit, "halves": halves,
               "gamma": np.where(rng.rand(n, m) < 0.3, -(rng.randint(
                   0, 3, (n, m)) + 0.5), pos).astype(f32),
               "cosh": 1.0 + pos,
               "cbrt": np.where(np.abs(x) < 0.1, f32(0.5), x)}
    unary = {
        "halves": ("abs", "relu"),
        "pos": ("sqrt", "rsqrt", "log", "log10", "log2", "rcbrt",
                "gammaln"),
        "unit": ("arcsin", "arccos", "arctanh", "log1p", "tan"),
        "gamma": ("gamma",), "cosh": ("arccosh",), "cbrt": ("cbrt",),
        "x": ("negative", "_np_negative", "_copy", "identity", "square",
              "exp", "expm1", "sin", "cos", "arctan", "degrees",
              "radians", "sinh", "cosh", "tanh", "arcsinh", "sigmoid",
              "softsign", "erf")}
    for dom, names in unary.items():
        for name in names:
            case("elemwise", name, [domains.get(dom, x)], bf16=True)
    for name in ("round", "rint", "ceil", "floor", "fix", "trunc", "sign",
                 "logical_not"):
        case("elemwise", name, [halves], exact=True, bf16=True)
    case("elemwise", "round", [halves.astype(np.int32)], exact=True)
    for name in ("BlockGrad", "stop_gradient"):
        case("elemwise", name, [x], grads=())
    case("elemwise", "clip", [halves], dict(a_min=-1.5, a_max=2.0),
         bf16=True)

    a, b = r(n, m), r(n, m)
    tie = b.copy()
    tie[::3] = a[::3]
    nonzero = np.where(np.abs(b) < 0.3, f32(0.7), b)
    for name, ins in (("elemwise_div", [a, nonzero]), ("_div", [a, nonzero]),
                      ("_power", [pos, u(-2, 2, n, m)]),
                      ("pow", [pos, u(-2, 2, n, m)]),
                      ("_maximum", [a, tie]), ("_minimum", [a, tie]),
                      ("_hypot", [a, b])):
        case("elemwise", name, ins, bf16=True)
    h2 = halves.copy()
    h2[::2] = (rng.randint(-8, 9, h2[::2].shape) / 2).astype(f32)
    for name in ("_equal", "_not_equal", "_greater", "_greater_equal",
                 "_lesser", "_lesser_equal"):
        case("elemwise", name, [halves, h2], exact=True, bf16=True)

    row, col = r(1, m), r(n, 1)
    row_nz = np.where(np.abs(row) < 0.3, f32(-0.8), row)
    row_tie = row.copy()
    a_tie = a.copy()
    a_tie[:, ::5] = row_tie[:, ::5]
    for name, ins in (("broadcast_sub", [a, row]),
                      ("broadcast_minus", [a, col]),
                      ("broadcast_div", [a, row_nz]),
                      ("broadcast_mod", [3 * a, row_nz]),
                      ("broadcast_power", [pos, u(-2, 2, 1, m)]),
                      ("broadcast_maximum", [a_tie, row_tie]),
                      ("broadcast_minimum", [a_tie, row_tie]),
                      ("broadcast_hypot", [a, col])):
        case("elemwise", name, ins, bf16=True)
    hrow = (rng.randint(-2, 3, (1, m)) / 2).astype(f32)
    for name in ("broadcast_equal", "broadcast_not_equal",
                 "broadcast_greater", "broadcast_greater_equal",
                 "broadcast_lesser", "broadcast_lesser_equal",
                 "broadcast_logical_and", "broadcast_logical_or",
                 "broadcast_logical_xor"):
        case("elemwise", name, [halves, hrow], exact=True, bf16=True)

    xs = x.copy()
    for name, s, ins in (
            ("_plus_scalar", 0.5, x), ("_minus_scalar", 1.25, x),
            ("_rminus_scalar", -2.0, x), ("_mul_scalar", 0.125, x),
            ("_div_scalar", 3.0, x), ("_rdiv_scalar", 2.0, nonzero),
            ("_mod_scalar", 1.5, 3 * x), ("_mod_scalar", -1.5, 3 * x),
            ("_rmod_scalar", 2.5, nonzero), ("_power_scalar", 2.0, x),
            ("_power_scalar", 0.5, pos), ("_rpower_scalar", 1.7, x),
            ("_maximum_scalar", 0.25, np.where(rng.rand(n, m) < 0.2,
                                               f32(0.25), xs)),
            ("_minimum_scalar", -0.25, np.where(rng.rand(n, m) < 0.2,
                                                f32(-0.25), xs)),
            ("_hypot_scalar", 0.75, x)):
        case("elemwise", name, [ins], dict(scalar=s), bf16=True)
    for name in ("_mul_scalar", "_plus_scalar", "_div_scalar"):
        case("elemwise", name, [halves.astype(np.int32)], dict(scalar=0.5),
             exact=True)
    for name in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
                 "_greater_equal_scalar", "_lesser_scalar",
                 "_lesser_equal_scalar"):
        case("elemwise", name, [halves], dict(scalar=0.5), exact=True,
             bf16=True)
    for name in ("add_n", "ElementWiseSum", "_sum"):
        case("elemwise", name, [a, b, x], dict(num_args=3), bf16=True)
    case("elemwise", "_grad_add", [a, b])

    # reductions: ties at the row maxima and minima, NaNs for nan*
    t = r(n, m)
    t[:, 3] = t[:, 10] = 6.0
    t[:, 4] = t[:, 11] = -6.0
    near1 = (1.0 + 0.05 * r(n, m)).astype(f32)
    nans = np.where(rng.rand(n, m) < 0.1, f32(np.nan), near1)
    for name, ins, attrs in (
            ("sum", x, dict(axis=1)), ("sum", x, {}),
            ("sum_axis", x, dict(axis=0, keepdims=True)),
            ("mean", x, dict(axis=-1, keepdims=True)),
            ("mean", x, dict(axis=(0, 1))), ("prod", near1, dict(axis=1)),
            ("max", t, dict(axis=1)), ("max_axis", t, dict(axis=0)),
            ("min", t, dict(axis=1)), ("min_axis", t, {}),
            ("nansum", nans, dict(axis=1)), ("nanprod", nans, dict(axis=1)),
            ("norm", x, {}), ("broadcast_to", col, dict(shape=(0, m))),
            ("broadcast_axis", row, dict(axis=0, size=n)),
            ("broadcast_axes", r(n, 1, 4), dict(axis=(1,), size=(3,)))):
        case("reduce", name, [ins], attrs, bf16=name in ("sum", "mean"))
    for name, attrs in (("argmax", dict(axis=1)), ("argmin", dict(axis=0)),
                        ("argmax", {}),
                        ("argmin", dict(axis=1, keepdims=True))):
        case("reduce", name, [t], attrs, exact=True)
    case("reduce", "argmax_channel", [t], exact=True)

    # shapes, products, splits, gathers
    heads, T, Dh = attn
    qkv = r(1, T, 3 * heads * Dh)
    case("matrix", "slice", [x], dict(begin=(1, 2), end=(n - 1, m // 2)))
    case("matrix", "crop", [r(4, n, 8)], dict(begin=(1, 0), end=(3, n - 2)))
    case("matrix", "slice_axis", [x], dict(axis=1, begin=-(m // 4), end=None))
    case("matrix", "slice_axis", [x], dict(axis=0, begin=2, end=-1))
    case("matrix", "flip", [x], dict(axis=(1,)))
    case("matrix", "reverse", [x], dict(axis=(0, 1)))
    k_ = 96
    case("matrix", "dot", [r(n, k_), r(k_, m // 4)], bf16=True)
    case("matrix", "dot", [r(k_, n), r(m // 4, k_)],
         dict(transpose_a=True, transpose_b=True))
    case("matrix", "dot", [r(k_), r(k_)])
    case("matrix", "dot", [r(2, n, k_), r(k_)])
    qh, kh, vh = (r(heads, T, Dh) for _ in range(3))
    case("matrix", "batch_dot", [qh, kh], dict(transpose_b=True), bf16=True)
    case("matrix", "batch_dot", [r(heads, T, T) * 0.05, vh])
    case("matrix", "batch_dot", [r(4, k_, n), r(4, k_, 8)],
         dict(transpose_a=True))
    for name in ("SliceChannel", "split", "slice_channel"):
        case("matrix", name, [qkv], dict(num_outputs=3, axis=2))
    case("matrix", "SliceChannel", [r(4, 3, 5)],
         dict(num_outputs=3, axis=1, squeeze_axis=True))
    for name in ("SwapAxis", "swapaxes"):
        case("matrix", name, [r(1, T, heads, Dh)], dict(dim1=1, dim2=2))
    case("matrix", "repeat", [r(n, 8)], dict(repeats=2, axis=1))
    case("matrix", "repeat", [r(4, 8)], dict(repeats=3))
    case("matrix", "tile", [r(n, 8)], dict(reps=(2, 3)))
    case("matrix", "tile", [r(4, 8)], dict(reps=(2, 1, 2)))
    ids = rng.randint(-3, m + 5, (n, 3)).astype(f32)
    table = r(m, 16)
    case("indexing", "take", [table, ids], grads=(0,))
    case("indexing", "take", [table, ids], dict(mode="wrap"), grads=(0,))
    case("indexing", "take", [r(8, m), ids[:, 0]], dict(axis=1),
         grads=(0,))
    case("indexing", "batch_take", [x, rng.randint(0, m, n).astype(f32)],
         grads=(0,))
    case("indexing", "one_hot", [rng.randint(-1, 13, (n, 5)).astype(f32)],
         dict(depth=12, on_value=2.0, off_value=-0.5), exact=True)
    cond = np.where(rng.rand(n, m) < 0.5, f32(0), halves)
    case("indexing", "where", [cond, a, b], grads=(1, 2))
    case("indexing", "where", [cond[:, 0], a, b], grads=(1, 2))

    # softmax, the regression and SVM heads, the sequence ops
    case("nn", "softmax", [x], dict(axis=-1, temperature=2.0), bf16=True)
    case("nn", "softmax", [r(heads, T, T)], dict(axis=-1))
    case("nn", "log_softmax", [x], dict(axis=0))
    reg = r(n, 8)
    for name, lab in (("LinearRegressionOutput", r(n, 8)),
                      ("LogisticRegressionOutput", rng.rand(n, 8)
                       .astype(f32)),
                      ("MAERegressionOutput", r(n * 8))):
        case("nn", name, [reg, lab], dict(grad_scale=0.5), grads=(0,))
    labels = rng.randint(0, 10, n).astype(f32)
    for lin in (False, True):
        case("nn", "SVMOutput", [r(n, 10), labels],
             dict(margin=0.5, regularization_coefficient=2.0,
                  use_linear=lin), grads=(0,))
    case("nn", "softmax_cross_entropy", [r(n, 10), labels], grads=(0,))
    seq = r(8, n, 16)
    lens = rng.randint(1, 9, n).astype(f32)
    for name in ("SequenceLast", "SequenceMask", "SequenceReverse"):
        case("nn", name, [seq, lens], dict(use_sequence_length=True,
                                           value=-1.0), grads=(0,))
        case("nn", name, [seq])
    case("nn", "IdentityAttachKLSparseReg", [x],
         dict(sparseness_target=0.2, penalty=0.01))
    # LayerNorm (an earlier op) over the axes and statistics the parent
    # did not take
    ln = (r(4, 5, 6) * 2 + 1).astype(f32)
    for axis, stats in ((1, False), (1, True), (-1, True), (0, True)):
        k = ln.shape[axis]
        case("nn", "LayerNorm", [ln, u(0.5, 1.5, k), r(k)],
             dict(axis=axis, eps=1e-5, output_mean_var=stats))

    # ordering: ties in halves
    for name, attrs in (("sort", {}), ("sort", dict(axis=0,
                                                    is_ascend=False))):
        case("ordering", name, [halves], attrs, bf16=True)
    case("ordering", "sort", [halves], dict(axis=None))
    for attrs in ({}, dict(axis=0, is_ascend=False)):
        case("ordering", "argsort", [halves], attrs, exact=True)
    for attrs in (dict(k=5), dict(k=3, axis=0, is_ascend=True),
                  dict(k=4, ret_typ="mask")):
        case("ordering", "topk", [halves], attrs, exact=True)
    case("ordering", "topk", [halves], dict(k=5, ret_typ="value"))
    case("ordering", "topk", [halves], dict(k=2, ret_typ="both", axis=0),
         grads=(0,))

    # nodes without inputs
    case("init", "_zeros", [], dict(shape=(n, m)), exact=True)
    case("init", "_ones", [], dict(shape=(n, 4), dtype="int32"), exact=True)
    case("init", "_full", [], dict(shape=(3, n), value=2.5), exact=True)
    case("init", "_arange", [], dict(start=2, stop=50, step=0.5, repeat=2),
         exact=True)
    case("init", "_arange", [], dict(start=T), exact=True)
    draws = (SAMPLE_DRAWS,)
    for name, attrs, moments in (
            ("_sample_uniform", dict(low=-1.0, high=3.0), (1.0, 4 / 3, -1.2)),
            ("uniform", {}, (0.5, 1 / 12, -1.2)),
            ("_random_uniform", dict(low=2.0, high=2.5),
             (2.25, 0.25 / 12, -1.2)),
            ("_sample_normal", dict(loc=1.0, scale=2.0), (1.0, 4.0, 0.0)),
            ("normal", {}, (0.0, 1.0, 0.0)),
            ("_random_normal", dict(loc=-3.0, scale=0.5), (-3.0, 0.25, 0.0)),
            ("_sample_gamma", dict(alpha=2.0, beta=1.5), (3.0, 4.5, 3.0)),
            ("_random_gamma", dict(alpha=0.5, beta=2.0), (1.0, 2.0, 12.0)),
            ("_sample_exponential", dict(lam=2.0), (0.5, 0.25, 6.0)),
            ("_random_exponential", {}, (1.0, 1.0, 6.0))):
        case("sample", name, [], dict(shape=draws, **attrs), grads=(),
             moments=moments)
    case("sample", "normal", [], dict(shape=(n, m), dtype="bfloat16"),
         grads=(), moments=(0.0, 1.0, 0.0))

    # optimizer updates (forward only)
    w, g = r(n, m), r(n, m)
    opt = dict(lr=0.1, wd=0.01, rescale_grad=0.5, clip_gradient=0.3)
    case("optimizer", "sgd_update", [w, g], opt, grads=())
    case("optimizer", "sgd_mom_update", [w, g, r(n, m)],
         dict(opt, momentum=0.9), grads=())
    case("optimizer", "adam_update", [w, g, r(n, m), u(0, 1, n, m)],
         dict(opt, beta1=0.8, beta2=0.99, epsilon=1e-6), grads=())

    # spatial
    img = r(2, 8, 24, 24)
    boxes = np.stack([rng.randint(0, 2, 6),
                      *[rng.uniform(0, 30, 6) for _ in range(2)],
                      *[rng.uniform(20, 46, 6) for _ in range(2)]], 1)
    boxes[:, [1, 3]] = np.sort(boxes[:, [1, 3]], axis=1)
    boxes[:, [2, 4]] = np.sort(boxes[:, [2, 4]], axis=1)
    case("spatial", "ROIPooling", [img, boxes.astype(f32)],
         dict(pooled_size=(3, 3), spatial_scale=0.5), grads=(0,))
    # a box reaching past the image: its outer bins are empty (0)
    case("spatial", "ROIPooling", [img[:, :2, :6, :6],
                                   np.array([[0, 4, 4, 11, 11]], f32)],
         dict(pooled_size=(4, 4), spatial_scale=1.0), grads=(0,))
    theta = (np.array([1, 0, 0, 0, 1, 0], f32) + 0.2 * r(2, 6)).astype(f32)
    case("spatial", "GridGenerator", [theta],
         dict(transform_type="affine", target_shape=(12, 16)))
    case("spatial", "GridGenerator", [r(2, 2, 12, 16)],
         dict(transform_type="warp"))
    case("spatial", "SpatialTransformer", [r(2, 4, 12, 16), theta],
         dict(target_shape=(10, 14)))
    case("spatial", "BilinearSampler", [r(2, 4, 12, 16),
                                        u(-1.2, 1.2, 2, 2, 10, 14)])
    case("spatial", "Correlation", [r(2, 8, 16, 16), r(2, 8, 16, 16)],
         dict(kernel_size=1, max_displacement=3, stride1=1, stride2=1,
              pad_size=3))
    case("spatial", "Correlation", [r(2, 4, 15, 15), r(2, 4, 15, 15)],
         dict(kernel_size=3, max_displacement=2, stride1=2, stride2=2,
              pad_size=2, is_multiply=False))
    # the LoRA epilogue (the first serving op name): 4 streams of 8 rows,
    # slots 0 (the base's bits), 2, 1, 2 of a slab of 3 slots, rank 8
    slabs_a, slabs_b = 0.3 * r(3, 2, 32, 8), 0.3 * r(3, 2, 8, 96)
    slabs_a[0], slabs_b[0] = 0.0, 0.0
    case("adapter", "LoraGatherDelta",
         [r(4, 8, 96), r(4, 8, 32), slabs_a, slabs_b,
          np.array([0, 2, 1, 2], np.int32)], dict(layer=1),
         grads=(0, 1, 2, 3))
    return cases


def sweep_tensors(torch, case, dev, dtype=None):
    """A case's inputs as tensors on ``dev`` (the float ones in ``dtype``
    when given), the ``grads`` slots requiring gradient."""
    out = []
    for i, a in enumerate(case["ins"]):
        t = torch.from_numpy(np.array(a)).to(dev)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out.append(t.requires_grad_(i in case["grads"]))
    return out


def sweep_run(torch, mt, case, ctx, dtype=None):
    """(outputs through ``mt.nd.imperative_invoke`` on ``ctx``, gradients of
    sum(out * w) over every output, ``w`` seeded, through
    ``registry.invoke`` under autograd), all on the host."""
    from mxnet_tpu_torch.ops.registry import invoke

    dev = ctx.torch_device()
    nds = [mt.nd.NDArray(t.detach().clone(), ctx)
           for t in sweep_tensors(torch, case, dev, dtype)]
    kw = dict(case["attrs"])
    if not nds:
        kw["ctx"] = ctx
    # by the op's name (``nd.gamma`` is the sampler, as in the JAX package)
    fwd = mt.nd.imperative_invoke(case["name"], *nds, **kw)
    fwd = fwd if isinstance(fwd, list) else [fwd]
    grads = []
    if case["grads"]:
        tin = sweep_tensors(torch, case, dev, dtype)
        outs, _ = invoke(case["name"], tin, case["attrs"], is_train=True)
        cots = [torch.from_numpy(np.random.RandomState(1 + j).randn(
            *o.shape).astype(np.float32)).to(dev, o.dtype)
            for j, o in enumerate(outs)]
        live = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in live],
                                    [tin[i] for i in case["grads"]],
                                    [c for _, c in live])
    return [o._data.cpu() for o in fwd], [g.cpu() for g in grads]


def sweep_err(torch, got, want, dtype_name, bwd=False):
    """Largest |got - want| over (tol * max(1, max|want|)), NaNs where the
    other has NaNs too (``TOL``/``BWD_TOL`` of ``dtype_name``)."""
    tol = (BWD_TOL if bwd else TOL)[dtype_name]
    g, w = got.double(), want.double()
    check(bool(torch.equal(torch.isnan(g), torch.isnan(w))),
          "NaNs in other places")
    g, w = torch.nan_to_num(g), torch.nan_to_num(w)
    scale = max(1.0, w.abs().max().item()) if w.numel() else 1.0
    return ((g - w).abs().max().item() / (tol * scale)) if w.numel() else 0.0


def check_sample_moments(torch, case, out):
    """A sampler's draws: its dtype and shape, the sample mean within
    ``SAMPLE_SIGMAS`` standard errors of the distribution's, the sample
    variance within as many of its own (from the excess kurtosis)."""
    want_dt = case["attrs"].get("dtype", "float32")
    check(str(out.dtype) == f"torch.{want_dt}" and tuple(out.shape)
          == tuple(case["attrs"]["shape"]), f"{case['name']}: {out.dtype} "
          f"{tuple(out.shape)}")
    mean, var, kurt = case["moments"]
    x = out.double().reshape(-1)
    nn_ = x.numel()
    got_mean, got_var = x.mean().item(), x.var().item()
    se_mean = (var / nn_) ** 0.5
    se_var = var * ((kurt + 2.0) / nn_) ** 0.5
    dm, dv = abs(got_mean - mean) / se_mean, abs(got_var - var) / se_var
    check(dm <= SAMPLE_SIGMAS and dv <= SAMPLE_SIGMAS,
          f"{case['name']} {case['attrs']}: mean {got_mean} (want {mean}, "
          f"{dm:.2f} sigma), variance {got_var} ({var}, {dv:.2f} sigma)")
    return max(dm, dv)


def ops_sweep(torch, mt):
    """(c) Every op name the port's ops register outside ``EARLIER_OPS``
    and ``serving_ops`` through ``mt.nd.<name>`` on ``gpu(0)`` and on the CPU on the same
    seeded inputs (``op_sweep_cases``): outputs within ``TOL`` (exact
    where ``exact``), gradients of sum(out * w) within ``BWD_TOL``, fp32
    and, where a case says so, bf16; a sampler's draws (2^20 on the
    card) by their moments.  One ``ops_sweep`` line; any miss raises."""
    from mxnet_tpu_torch.ops import registry

    cases = op_sweep_cases(np.random.RandomState(20))
    names = {c["name"] for c in cases}
    # the port's own ops (not a user's: mt.rtc, CustomOp)
    ported = {n for n in registry.list_ops() if registry.get_op(
        n).compute.__module__.startswith("mxnet_tpu_torch.ops.")}
    missing = ported - EARLIER_OPS - serving_ops(registry) - names
    check(not missing, f"op names the sweep does not run: {sorted(missing)}")
    worst = {"fwd": 0.0, "bwd": 0.0, "bf16": 0.0, "sample_sigmas": 0.0}
    where = {}
    counts = {"cases": 0, "exact": 0, "with_grads": 0, "bf16_cases": 0}
    t0 = time.perf_counter()
    for case in cases:
        if case["family"] == "sample":
            outs, _ = sweep_run(torch, mt, case, mt.gpu(0))
            worst["sample_sigmas"] = max(worst["sample_sigmas"],
                                         check_sample_moments(torch, case,
                                                              outs[0]))
            counts["cases"] += 1
            continue
        dtypes = [None] + ([torch.bfloat16] if case["bf16"] else [])
        for dt in dtypes:
            label = f"{case['name']} {case['attrs']} {dt or 'float32'}"
            (o, g), (ro, rg) = (sweep_run(torch, mt, case, ctx, dt)
                                for ctx in (mt.gpu(0), mt.cpu()))
            check(len(o) == len(ro) and all(
                a.shape == b.shape and a.dtype == b.dtype
                for a, b in zip(o, ro)), f"{label}: outputs "
                f"{[(a.shape, a.dtype) for a in o]} vs "
                f"{[(a.shape, a.dtype) for a in ro]}")
            if case["exact"]:
                check(all(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
                          for a, b in zip(o, ro)), f"{label}: not equal")
                counts["exact"] += 1
            else:
                key = "fwd" if dt is None else "bf16"
                tname = "float32" if dt is None else "bfloat16"
                err = max(sweep_err(torch, a, b, tname) for a, b in
                          zip(o, ro))
                gerr = max([sweep_err(torch, a, b, tname, bwd=True)
                            for a, b in zip(g, rg)], default=0.0)
                for k, e in ((key, err), ("bwd" if dt is None else "bf16",
                                          gerr)):
                    if e > worst[k]:
                        worst[k], where[k] = e, label
                check(err <= 1 and gerr <= 1, f"{label} on the card "
                      f"against the CPU: forward {err}, backward {gerr} "
                      f"(error over tolerance)")
                counts["with_grads"] += bool(g)
            counts["bf16_cases"] += dt is not None
            counts["cases"] += 1
    rec = {"names": len(names), "new_names_registered":
           len(ported - EARLIER_OPS), **counts,
           "fwd": worst["fwd"], "bwd": worst["bwd"], "bf16": worst["bf16"],
           "sample_sigmas": worst["sample_sigmas"],
           "worst_over_tol": max(worst["fwd"], worst["bwd"], worst["bf16"]),
           "worst_cases": where, "wall_s": time.perf_counter() - t0}
    print("ops_sweep " + json.dumps(rec))
    return rec


def sampler_replays(torch, mt):
    """A module whose symbol draws (``FullyConnected`` + ``normal``
    noise under ``MakeLoss``) through the fused step's graph, lr 0: each
    replay's outputs must differ from the step before (new draws), and
    out - FullyConnected's must look N(0, 1)."""
    sym = mt.sym
    data = sym.Variable("data")
    h = sym.FullyConnected(data, num_hidden=256, name="fc")
    out = sym.MakeLoss(h + sym.normal(shape=(64, 256), name="noise"))
    mod = mt.mod.Module(out, label_names=(), context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (64, 32))])
    mod.init_params(initializer=mt.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.0})
    batch = mt.io.DataBatch([mt.nd.array(np.random.RandomState(3).randn(
        64, 32), ctx=mt.gpu(0))], [])
    outs = []
    for _ in range(6):
        mod.forward_backward(batch)
        mod.update()
        outs.append(mod.get_outputs()[0]._data.clone())
    torch.cuda.synchronize()
    stats = graph_stats(mod)
    check(stats is not None and stats["graphs_on"] and stats["captures"]
          > 0, f"the sampler module ran no CUDA graph: {stats}")
    for i in range(1, len(outs)):
        check(not torch.equal(outs[i], outs[i - 1]), f"step {i} drew the "
              f"step before's noise")
    w = mod._exec.arg_dict["fc_weight"]._data
    b = mod._exec.arg_dict["fc_bias"]._data
    noise = outs[-1] - (batch.data[0]._data @ w.t() + b)
    m, v = noise.mean().item(), noise.var().item()
    check(abs(m) < 0.05 and abs(v - 1) < 0.05, f"replayed noise mean {m}, "
          f"variance {v}")
    return {"steps": len(outs), "captures": stats["captures"],
            "noise_mean": m, "noise_var": v}


def primitive_breakdown(torch, mt, params, batch, reps=2):
    """The primitive LM's eager step (``MXNET_FUSED_STEP=0``) by aten
    op: ``bmm``, softmax, the mask add and the scaling (an add or a
    multiply over (B*H, T, T) scores, told apart by its input shapes),
    the dense layers (``fc``) and the rest, device ms from
    ``torch.profiler`` over ``reps`` steps after one; and ``memory``:
    the bytes autograd saves in a step (each storage once; how many are
    (B*H, T, T) float32 scores), the step's peak above the module's
    resident arrays."""
    from torch.profiler import ProfilerActivity, profile

    V, L, T = GPT2_SMALL["vocab_size"], GPT2_SMALL["num_layers"], \
        GPT2_SMALL["max_len"]
    sym = primitive_lm_symbol(mt.sym, V, T, L, H, GPT2_SMALL["d_model"],
                              GPT2_SMALL["d_ff"])
    with fused_env("0"):
        mod = lm_module(mt, sym, params)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": TRAIN_LR, "momentum": 0.9})

    def step():
        mod.forward_backward(batch)
        mod.update()

    step()
    torch.cuda.synchronize()
    # what autograd keeps for the backward (storages counted once) and
    # the eager step's peak above what the module holds between steps
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        saved[st.data_ptr()] = st.nbytes()
        return t

    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        step()
    torch.cuda.synchronize()
    scores_bytes = TRAIN_BATCH * H * T * T * 4
    memory = {"resident_bytes": resident,
              "step_peak_above_resident_bytes":
                  torch.cuda.max_memory_allocated() - resident,
              "saved_bytes": sum(saved.values()),
              "saved_score_sized": sum(b == scores_bytes
                                       for b in saved.values())}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    out = {name: 0.0 for name, _ in PRIMITIVE_OP_CLASSES}
    out.update(mask_add=0.0, scale=0.0, rest=0.0)
    scores = [TRAIN_BATCH * H, T, T]
    for e in prof.key_averages(group_by_input_shape=True):
        if str(e.device_type) != "DeviceType.CPU":
            continue
        ms = e.self_device_time_total / reps / 1e3
        on_scores = scores in list(e.input_shapes or [])
        if on_scores and e.key in ("aten::add", "aten::mul"):
            out["mask_add" if e.key == "aten::add" else "scale"] += ms
            continue
        name = next((n for n, keys in PRIMITIVE_OP_CLASSES
                     if any(k in e.key for k in keys)), "rest")
        out[name] += ms
    out["total"] = sum(out.values())
    out["memory"] = memory
    del mod
    torch.cuda.empty_cache()
    return out


def ops_path(torch, mt, ck, packed=None, eager=True):
    """Phase 14 on ``gpu(0)``, fp32 with TF32 off: the operator layer.
    (a) The primitive LM (``primitive_lm_symbol``) at GPT-2-small width
    from ``gpt2_small_params(0)``: one ``forward_backward`` on the first
    batch of ``lm_batches``, its loss within 1e-4 (relative) of the packed
    ``transformer_lm``'s on the same weights and batch and every
    ``layer{i}_qkv_weight`` gradient within ``BWD_TOL`` of max(1, |ref|)
    of the packed LM's, with no launch of B1's or B5's kernels (the
    launch counters: the path is the primitive one).  (b) ``TRAIN_STEPS``
    SGD steps through ``Module``'s fused step against the eager path
    (``lm_train_pair``: graphed = eager, a finite falling loss, no B1/B5
    launch, the captures), its eager step by aten op
    (``primitive_breakdown``) and the packed LM's step p50 beside it
    (``packed``, the training run's record; run here when None).  (c)
    The op sweep (``ops_sweep``) and a sampler through the fused step's
    replays (``sampler_replays``)."""
    V, L, T = GPT2_SMALL["vocab_size"], GPT2_SMALL["num_layers"], \
        GPT2_SMALL["max_len"]
    params = gpt2_small_params(0)
    batches = lm_batches(mt)
    first = next(batches)
    qkv = [f"layer{i}_qkv_weight" for i in range(L)]
    part_s = {}
    t0 = time.perf_counter()
    ref_loss, _, ref = first_step(torch, mt, ck, packed_lm_symbol(mt),
                                  params, first, qkv, PACKED_KERNELS)
    sym = primitive_lm_symbol(mt.sym, V, T, L, H, GPT2_SMALL["d_model"],
                              GPT2_SMALL["d_ff"])
    loss, launches, grads = first_step(torch, mt, ck, sym, params, first,
                                       qkv, ())
    check(abs(loss - ref_loss) <= 1e-4 * abs(ref_loss), f"primitive LM "
          f"first-step loss {loss} vs the packed LM's {ref_loss}")
    worst = 0.0
    for n in qkv:
        err = (grads[n] - ref[n]).abs().max().item()
        tol = BWD_TOL["float32"] * max(1.0, ref[n].abs().max().item())
        check(err <= tol, f"primitive LM {n} gradient: max_abs_err {err} "
              f"over {tol} against the packed LM's")
        worst = max(worst, err / tol)
    first_rec = {"loss": loss, "packed_loss": ref_loss,
                 "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
                 "qkv_grad_err_over_tol_max": worst,
                 "b1_b5_launches": sum(launches[k] for k in
                                       DPA_KERNELS + PACKED_KERNELS)}
    print(f"primitive LM first step: {json.dumps(first_rec)}")
    part_s["first_steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches.reset()
    rec = lm_train_pair(torch, mt, ck, lambda: lm_module(mt, sym, params),
                        batches, (), qkv, "primitive LM training",
                        eager=eager)
    part_s["training"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["eager_step_by_op_ms"] = primitive_breakdown(torch, mt, params,
                                                     first)
    part_s["breakdown"] = time.perf_counter() - t0
    if packed is None:
        t0 = time.perf_counter()
        packed = train_path(torch, mt, ck, eager=False)
        part_s["packed_training"] = time.perf_counter() - t0
    rec["packed_lm"] = {k: packed.get(k) for k in (
        "step_p50_ms", "eager_step_p50_ms", "step_device_ms",
        "peak_memory_bytes")}
    rec["first_step_vs_packed"] = first_rec
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["ops_sweep"] = ops_sweep(torch, mt)
    rec["sampler_replays"] = sampler_replays(torch, mt)
    part_s["sweep"] = time.perf_counter() - t0
    rec["part_wall_s"] = part_s
    print(json.dumps({"primitive_lm": {k: rec[k] for k in (
        "step_p50_ms", "eager_step_p50_ms", "step_device_ms",
        "eager_step_device_ms", "peak_memory_bytes",
        "eager_peak_memory_bytes", "graphs",
        "eager_step_by_op_ms", "packed_lm", "first_step_vs_packed",
        "sampler_replays", "part_wall_s") if k in rec}}))
    return rec


# ---------------------------------------------------------------------------
# phase 15: core breadth (queue A item 5, part 2): the remaining
# optimizers, MXNET_BACKWARD_DO_MIRROR, a monitored run, FeedForward and
# SequentialModule
# ---------------------------------------------------------------------------

# each new optimizer on the packed LM: (name, parameters), rates small
# enough that 6 steps of the random-walk stream stay finite
CORE_OPTIMIZERS = (
    ("ccsgd", {"learning_rate": TRAIN_LR, "momentum": 0.9}),
    ("nag", {"learning_rate": TRAIN_LR, "momentum": 0.9}),
    ("sgld", {"learning_rate": 1e-6}),
    ("dcasgd", {"learning_rate": TRAIN_LR, "momentum": 0.9}),
    ("adagrad", {"learning_rate": 1e-4}),
    ("rmsprop", {"learning_rate": 2e-5}),
    ("adadelta", {}),
    ("test", {"learning_rate": TRAIN_LR}))
CORE_BF16 = ("rmsprop", "adadelta")
# the fused step's 2 warm-ups, its capture (replayed once) and 3 replays
CORE_STEPS = 6
MIRROR_STEPS = 5
MONITOR_BATCHES = 2


def core_run(torch, mt, ck, make_mod, opt, batches, label, fwd, bwd,
             steps=CORE_STEPS):
    """``steps`` steps of ``make_mod()`` under ``opt`` over ``batches``
    (the launch counts reset just before): per step the mean loss (which
    must be finite), its wall ms, and the launches of B1's forward
    (``fwd`` a step) and of its two backward kernels (``bwd`` each a
    step).  → the record, with the ``layer{i}_qkv_weight`` weights after
    the last step (``weights``, on the card) and the peak memory."""
    L = GPT2_SMALL["num_layers"]
    mod = make_mod()
    mod.init_optimizer(optimizer=opt[0], optimizer_params=opt[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts(ck)
    losses, step_ms = [], []
    batches.reset()
    # a replay runs no wrapper: under graphs the launches are the trace's
    traced = TracedLaunches(torch, ck, label, on=graphs_on(mod))
    traced.__enter__()
    for step in range(steps):
        batch = next(batches)
        before = launch_counts(ck)
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        now = launch_counts(ck)
        for k, want in zip(PACKED_KERNELS, (fwd, bwd, bwd)):
            n = now[k] - before[k]
            check(n == want, f"{label} step {step}: {k} launched {n} "
                  f"times, not {want}")
        losses.append(float(mod.get_outputs()[0]._data.float().mean()))
        check(np.isfinite(losses[-1]), f"{label}: loss not finite at step "
              f"{step}: {losses}")
    traced.__exit__(None, None, None)
    rec = {"optimizer": opt[0], **opt[1], "steps": steps, "losses": losses,
           "step_ms": step_ms, "step_p50_ms": float(np.median(step_ms)),
           "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
           "launches": traced.launches,
           "bf16_launches": traced.bf16_launches, "graphs": graph_stats(mod),
           "weights": {f"layer{i}_qkv_weight":
                       mod._exec.arg_dict[f"layer{i}_qkv_weight"]._data
                       .clone() for i in range(L)}}
    del mod
    torch.cuda.empty_cache()
    return rec


def core_pair(torch, mt, ck, make_mod, opt, batches, label, fwd, bwd,
              dtype="float32", steps=CORE_STEPS):
    """``core_run`` through the fused step (warm-ups, a capture, replays)
    and under ``MXNET_FUSED_STEP=0`` from the same weights: each step's
    loss within ``TOL`` (relative) and the qkv weights after the last
    within ``BWD_TOL`` of max(1, max|w|), the fused-step phase's gate.
    → the graphed record, the eager p50 and errors beside it."""
    rec = core_run(torch, mt, ck, make_mod, opt, batches, label, fwd, bwd,
                   steps)
    with fused_env("0"):
        erec = core_run(torch, mt, ck, make_mod, opt, batches,
                        f"{label} (eager)", fwd, bwd, steps)
    stats = rec["graphs"]
    check(stats["graphs_on"] and stats["captures"] == 1,
          f"{label}: the fused step captured no graph: {stats}")
    loss_err = max(abs(a - b) / (TOL[dtype] * abs(b))
                   for a, b in zip(rec["losses"], erec["losses"]))
    w_err = max((rec["weights"][n].float() - erec["weights"][n].float())
                .abs().max().item()
                / (BWD_TOL[dtype]
                   * max(1.0, erec["weights"][n].float().abs().max().item()))
                for n in rec["weights"])
    check(loss_err <= 1 and w_err <= 1, f"{label}: graphed steps miss the "
          f"eager ones (error over tolerance: loss {loss_err}, weights "
          f"{w_err})")
    for r in (rec, erec):
        del r["weights"]
    rec.update(eager_step_p50_ms=erec["step_p50_ms"],
               eager_losses=erec["losses"],
               eager_peak_memory_bytes=erec["peak_memory_bytes"],
               graphed_vs_eager_err_over_tol={"loss": loss_err,
                                              "weights": w_err})
    rec["launches"] = {k: rec["launches"].get(k, 0)
                       + erec["launches"].get(k, 0)
                       for k in set(rec["launches"]) | set(erec["launches"])}
    return rec


def core_optimizers(torch, mt, ck, params):
    """(a) Each new optimizer on the packed LM through ``core_pair``, in
    fp32 and, for ``CORE_BF16``, the bf16 LM too.  SGLD's graphed and
    eager steps draw their noise from other generators (the fused
    state's streams, the step-key chain), so its pair runs with
    ``draw_noise`` giving zeros, and one more graphed run draws real
    noise: finite loss, and the first step's change of the qkv weights
    against the zero-noise run's, N(0, lr) within 6 sigma."""
    from mxnet_tpu_torch import optimizer as topt

    L = GPT2_SMALL["num_layers"]
    batches = lm_batches(mt)
    out = {}

    def make(dtype="float32"):
        return lambda: lm_module(mt, packed_lm_symbol(mt, dtype=dtype),
                                 params)

    for name, kw in CORE_OPTIMIZERS:
        zero = name == "sgld"
        real = topt.draw_noise
        if zero:
            topt.draw_noise = lambda gen, shape, device: torch.zeros(
                shape, device=device)
        try:
            out[name] = core_pair(torch, mt, ck, make(), (name, kw),
                                  batches, f"{name} (packed LM)", L, L)
        finally:
            topt.draw_noise = real
        print(json.dumps({"core_optimizer": {k: v for k, v in
                                             out[name].items()
                                             if k != "launches"}}))
    # SGLD with its noise, graphed: the first step's change against the
    # zero-noise step's is N(0, lr)
    name, kw = "sgld", dict(CORE_OPTIMIZERS)["sgld"]
    first = {}
    for noise in (False, True):
        real = topt.draw_noise
        if not noise:
            topt.draw_noise = lambda gen, shape, device: torch.zeros(
                shape, device=device)
        try:
            rec = core_run(torch, mt, ck, make(), (name, kw), batches,
                           f"sgld noise={noise}", L, L, steps=1)
        finally:
            topt.draw_noise = real
        first[noise] = rec["weights"]
    diff = torch.cat([(first[True][n] - first[False][n]).reshape(-1)
                      for n in first[True]]).double()
    lr, n = kw["learning_rate"], diff.numel()
    mean, var = diff.mean().item(), diff.var().item()
    check(abs(mean) <= 6 * np.sqrt(lr / n)
          and abs(var - lr) <= 6 * lr * np.sqrt(2.0 / (n - 1)),
          f"SGLD noise: mean {mean}, variance {var} for N(0, {lr}) over "
          f"{n} weights")
    out["sgld_noise"] = {"weights": n, "mean": mean, "variance": var,
                         "lr": lr, "launches": rec["launches"]}
    for name in CORE_BF16:
        kw = dict(CORE_OPTIMIZERS)[name]
        out[f"{name}_bf16"] = core_pair(
            torch, mt, ck, make("bfloat16"), (name, kw), batches,
            f"{name} (bf16 LM)", L, L, dtype="bfloat16")
        for k in PACKED_KERNELS:
            n = out[f"{name}_bf16"]["bf16_launches"].get(k, 0)
            check(n == L * CORE_STEPS, f"{name} (bf16 LM): {n} bf16 "
                  f"launches of {k} in the trace, not {L * CORE_STEPS}")
        print(json.dumps({"core_optimizer_bf16": {
            k: v for k, v in out[f"{name}_bf16"].items()
            if k != "launches"}}))
    return out


def mirror_first_step(torch, mt, ck, sym, params, batch, grads, fwd, bwd):
    """One ``forward_backward`` (the executor's; no optimizer) of a fresh
    module on ``batch``, the launch counts of B1's kernels checked
    (``fwd`` and ``bwd``) → (mean loss, host copies of ``grads``)."""
    mod = lm_module(mt, sym, params)
    torch.cuda.synchronize()
    reset_launch_counts(ck)
    mod.forward_backward(batch)
    torch.cuda.synchronize()
    launches = launch_counts(ck)
    for k, want in zip(PACKED_KERNELS, (fwd, bwd, bwd)):
        check(launches[k] == want, f"first step: {k} launched "
              f"{launches[k]} times, expected {want}")
    for k in DPA_KERNELS:
        check(launches[k] == 0, f"first step: {k} launched")
    loss = float(mod.get_outputs()[0].asnumpy().mean())
    out = {n: mod._exec.grad_dict[n]._data.cpu() for n in grads}
    del mod
    torch.cuda.empty_cache()
    return loss, out


def mirror_env(value):
    """``MXNET_BACKWARD_DO_MIRROR`` = ``value`` while entered (an
    executor reads it at bind)."""
    return env_value("MXNET_BACKWARD_DO_MIRROR", value)


def core_mirror(torch, mt, ck, params):
    """(b) ``MXNET_BACKWARD_DO_MIRROR=1`` on the packed LM and the
    primitive LM: the first step's qkv gradients within ``BWD_TOL`` of
    max(1, |g|) of the step without the mirror, its loss within ``TOL``;
    B1's forward launched twice a layer a step on the packed LM (once in
    the forward, once in the recomputation) and its backward kernels
    once; ``MIRROR_STEPS`` SGD steps graphed against eager under the
    mirror (``core_pair``), and the same steps graphed without it: step
    p50 and peak memory of each."""
    V, L, T = GPT2_SMALL["vocab_size"], GPT2_SMALL["num_layers"], \
        GPT2_SMALL["max_len"]
    qkv = [f"layer{i}_qkv_weight" for i in range(L)]
    opt = ("sgd", {"learning_rate": TRAIN_LR, "momentum": 0.9})
    batches = lm_batches(mt)
    first = next(batches)
    syms = {"packed": (lambda: packed_lm_symbol(mt), L),
            "primitive": (lambda: primitive_lm_symbol(
                mt.sym, V, T, L, H, GPT2_SMALL["d_model"],
                GPT2_SMALL["d_ff"]), 0)}
    out = {}
    for label, (make_sym, per_layer) in syms.items():
        rec = {}
        loss0, g0 = mirror_first_step(torch, mt, ck, make_sym(), params,
                                      first, qkv, per_layer, per_layer)
        with mirror_env("1"):
            loss1, g1 = mirror_first_step(torch, mt, ck, make_sym(), params,
                                          first, qkv, 2 * per_layer,
                                          per_layer)
        g_err = max((g1[n] - g0[n]).abs().max().item()
                    / (BWD_TOL["float32"] * max(1.0, g0[n].abs().max()
                                                .item())) for n in qkv)
        l_err = abs(loss1 - loss0) / (TOL["float32"] * abs(loss0))
        check(g_err <= 1 and l_err <= 1, f"{label} LM under the mirror: "
              f"first step misses the plain one (error over tolerance: "
              f"loss {l_err}, gradients {g_err})")
        rec["first_step_err_over_tol"] = {"loss": l_err, "grads": g_err}

        def make():
            return lm_module(mt, make_sym(), params)

        with mirror_env("1"):
            mirrored = core_pair(torch, mt, ck, make, opt, batches,
                                 f"{label} LM mirrored", 2 * per_layer,
                                 per_layer, steps=MIRROR_STEPS)
        plain = core_run(torch, mt, ck, make, opt, batches,
                         f"{label} LM", per_layer, per_layer,
                         steps=MIRROR_STEPS)
        del plain["weights"]
        rec.update({
            "mirror": {k: mirrored[k] for k in (
                "step_p50_ms", "eager_step_p50_ms", "peak_memory_bytes",
                "eager_peak_memory_bytes", "graphed_vs_eager_err_over_tol",
                "losses")},
            "plain": {k: plain[k] for k in ("step_p50_ms",
                                             "peak_memory_bytes",
                                             "losses")},
            "launches": {k: mirrored["launches"].get(k, 0)
                         + plain["launches"].get(k, 0)
                         for k in PACKED_KERNELS}})
        print(json.dumps({"core_mirror": {label: rec}}))
        out[label] = rec
    return out


def tiny_lm_monitor_names(mt):
    """The names a monitored step of the packed LM's symbol gives, from
    the port's CPU run of the same symbol at cut widths (the names do
    not depend on the widths): 2 steps, ``Monitor(1, '.*')``."""
    from mxnet_tpu_torch.name import NameManager

    V, L, T = 64, GPT2_SMALL["num_layers"], 16
    with NameManager():  # the auto names of a first build, as the card's
        sym = mt.models.transformer_lm(V, T, num_layers=L, num_heads=H,
                                       d_model=2 * H, d_ff=4 * H, head="ce")
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(data_shapes=[("data", (1, T))],
             label_shapes=[("softmax_label", (1, T))])
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": TRAIN_LR})
    mon = mt.Monitor(interval=1, pattern=".*")
    mod.install_monitor(mon)
    X, Y = random_walk_tokens(V, T, 1)
    batch = mt.io.DataBatch([mt.nd.array(X, ctx=mt.cpu())],
                            [mt.nd.array(Y, ctx=mt.cpu())])
    names = []
    for _ in range(MONITOR_BATCHES):
        mon.tic()
        mod.forward_backward(batch)
        mod.update()
        names.append([k for _, k, _ in mon.toc()])
    return names


def core_monitor(torch, mt, ck, params):
    """(c) ``Monitor(interval=1, pattern='.*')`` on the packed LM over
    ``MONITOR_BATCHES`` SGD steps: eager (no capture), every statistic
    finite, the names those of the port's CPU run of the symbol
    (``tiny_lm_monitor_names``), B1 a layer a step, and the first step's
    loss equal (within ``TOL``) to an unmonitored eager step's."""
    L = GPT2_SMALL["num_layers"]
    opt = {"learning_rate": TRAIN_LR, "momentum": 0.9}
    batches = lm_batches(mt)
    first = next(batches)
    with fused_env("0"):
        ref = lm_module(mt, packed_lm_symbol(mt), params)
    ref.init_optimizer(optimizer="sgd", optimizer_params=opt)
    ref.forward_backward(first)
    ref.update()
    ref_loss = float(ref.get_outputs()[0].asnumpy().mean())
    del ref
    torch.cuda.empty_cache()
    from mxnet_tpu_torch.name import NameManager

    with NameManager():  # the auto names of a first build
        sym = packed_lm_symbol(mt)
    mod = lm_module(mt, sym, params)
    mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    mon = mt.Monitor(interval=1, pattern=".*")
    mod.install_monitor(mon)
    batches.reset()
    reset_launch_counts(ck)
    names, losses, stats, toc_ms = [], [], 0, []
    t0 = time.perf_counter()
    for step in range(MONITOR_BATCHES):
        mon.tic()
        mod.forward_backward(next(batches))
        mod.update()
        losses.append(float(mod.get_outputs()[0].asnumpy().mean()))
        ts = time.perf_counter()
        res = mon.toc()
        toc_ms.append((time.perf_counter() - ts) * 1e3)
        bad = [k for _, k, v in res
               if not all(np.isfinite(float(x)) for x in v.split())]
        check(not bad, f"monitored LM step {step}: statistics not finite: "
              f"{bad[:5]}")
        names.append([k for _, k, _ in res])
        stats += len(res)
    wall = time.perf_counter() - t0
    launches = launch_counts(ck)
    for k in PACKED_KERNELS:
        check(launches[k] == L * MONITOR_BATCHES, f"monitored LM: {k} "
              f"launched {launches[k]} times, not {L * MONITOR_BATCHES}")
    gs = graph_stats(mod)
    check(gs["captures"] == 0 and mod._fused is None,
          f"monitored LM: a monitored run captured a graph: {gs}")
    del mod
    torch.cuda.empty_cache()
    cpu_names = tiny_lm_monitor_names(mt)
    check(names == cpu_names, "monitored LM: statistic names differ from "
          "the CPU run's")
    l_err = abs(losses[0] - ref_loss) / (TOL["float32"] * abs(ref_loss))
    check(l_err <= 1, f"monitored LM: loss {losses[0]} against the "
          f"unmonitored eager step's {ref_loss}")
    return {"batches": MONITOR_BATCHES, "statistics": stats,
            "names_per_step": len(names[0]), "losses": losses,
            "unmonitored_loss": ref_loss, "loss_err_over_tol": l_err,
            "toc_ms": toc_ms, "wall_s": wall, "graphs": gs,
            "launches": launches}


def core_feedforward(torch, mt):
    """(d) ``model.FeedForward`` trains LeNet on ``gpu(0)`` over the
    synthetic MNIST set, ``train_mnist``'s settings (3 epochs, batch 64,
    SGD 0.05 with momentum 0.9, wd 1e-4, Xavier gaussian in 2):
    validation accuracy >= ``MNIST_MIN_ACCURACY``."""
    from mxnet_tpu_torch.examples.common import synthetic_mnist

    np.random.seed(0)
    mt.random.seed(0)
    X, y = synthetic_mnist(4096)
    Xv, yv = synthetic_mnist(512, seed=7)
    model = mt.model.FeedForward(
        mt.models.get_symbol("lenet", num_classes=10), ctx=mt.gpu(0),
        num_epoch=3, optimizer="sgd", learning_rate=0.05, momentum=0.9,
        wd=0.0001, numpy_batch_size=64,
        initializer=mt.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    t0 = time.perf_counter()
    model.fit(mt.io.NDArrayIter(X, y, batch_size=64, shuffle=True,
                                last_batch_handle="discard"))
    fit_s = time.perf_counter() - t0
    acc = float(model.score(Xv, yv))
    check(acc >= MNIST_MIN_ACCURACY, f"FeedForward LeNet: validation "
          f"accuracy {acc} below {MNIST_MIN_ACCURACY}")
    pred = model.predict(Xv[:64])
    check(pred.shape == (64, 10) and np.isfinite(pred).all(),
          f"FeedForward.predict: shape {pred.shape}")
    return {"val_accuracy": acc, "fit_s": fit_s}


def core_sequential(torch, mt):
    """(e) The MLP of ``models.mlp`` split into two modules, a
    ``SequentialModule`` on ``gpu(0)`` (``take_labels``,
    ``auto_wiring``): its first SGD step equal to the single
    ``Module``'s (weights within ``BWD_TOL`` of max(1, |w|), outputs
    within ``TOL``), then 3 epochs over the synthetic MNIST set to
    validation accuracy >= ``MNIST_MIN_ACCURACY``."""
    from mxnet_tpu_torch.examples.common import synthetic_mnist

    dev = mt.gpu(0)
    X, y = synthetic_mnist(4096)
    Xv, yv = synthetic_mnist(512, seed=7)
    X, Xv = X.reshape(len(X), -1), Xv.reshape(len(Xv), -1)

    def head(x):
        x = mt.sym.FullyConnected(x, num_hidden=10, name="fc3")
        return mt.sym.SoftmaxOutput(x, name="softmax")

    def body(x):
        x = mt.sym.Activation(mt.sym.FullyConnected(x, num_hidden=128,
                                                    name="fc1"),
                              act_type="relu", name="relu1")
        return mt.sym.Activation(mt.sym.FullyConnected(x, num_hidden=64,
                                                       name="fc2"),
                                 act_type="relu", name="relu2")

    def chain():
        seq = mt.mod.SequentialModule()
        seq.add(mt.mod.Module(body(mt.sym.Variable("data")),
                              label_names=None, context=dev))
        seq.add(mt.mod.Module(head(mt.sym.Variable("data")), context=dev),
                take_labels=True, auto_wiring=True)
        return seq

    def whole():
        return mt.mod.Module(head(body(mt.sym.Variable("data"))),
                             context=dev)

    opt = {"learning_rate": 0.1, "momentum": 0.9}
    it = mt.io.NDArrayIter(X, y, batch_size=64, shuffle=False,
                           last_batch_handle="discard")
    batch = next(iter(it))
    mt.random.seed(3)
    start = None
    got = []
    for make in (chain, whole):
        mod = make()
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        if start is None:
            mod.init_params(mt.initializer.Xavier())
            start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        else:
            mod.init_params(arg_params={k: mt.nd.array(v, ctx=dev)
                                        for k, v in start.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        got.append(({k: v._data for k, v in mod.get_params()[0].items()},
                    mod.get_outputs()[0]._data.clone()))
    w_err = max((got[0][0][k] - got[1][0][k]).abs().max().item()
                / (BWD_TOL["float32"]
                   * max(1.0, got[1][0][k].abs().max().item()))
                for k in start)
    o_err = ((got[0][1] - got[1][1]).abs().max().item()
             / (TOL["float32"] * max(1.0, got[1][1].abs().max().item())))
    check(w_err <= 1 and o_err <= 1, f"SequentialModule's first step "
          f"misses the single Module's (error over tolerance: weights "
          f"{w_err}, outputs {o_err})")
    np.random.seed(0)
    seq = chain()
    t0 = time.perf_counter()
    seq.fit(mt.io.NDArrayIter(X, y, batch_size=64, shuffle=True,
                              last_batch_handle="discard"),
            num_epoch=3, optimizer="sgd", optimizer_params=opt,
            initializer=mt.initializer.Xavier())
    fit_s = time.perf_counter() - t0
    (_, acc), = seq.score(mt.io.NDArrayIter(Xv, yv, batch_size=64), "acc")
    check(acc >= MNIST_MIN_ACCURACY, f"SequentialModule MLP: validation "
          f"accuracy {acc} below {MNIST_MIN_ACCURACY}")
    return {"first_step_err_over_tol": {"weights": w_err, "outputs": o_err},
            "val_accuracy": float(acc), "fit_s": fit_s}


def core_path(torch, mt, ck):
    """Phase 15 on ``gpu(0)``, fp32 with TF32 off: (a) the eight
    optimizers this slice ports on the packed GPT-2-class LM
    (``core_optimizers``), (b) ``MXNET_BACKWARD_DO_MIRROR`` on the
    packed and the primitive LM (``core_mirror``), (c) a monitored run
    (``core_monitor``), (d) ``FeedForward`` (``core_feedforward``) and
    (e) ``SequentialModule`` (``core_sequential``); one ``core_summary``
    line.  The launches are summed over (a)-(c)."""
    params = gpt2_small_params(0)
    part_s, rec = {}, {}
    for key, fn in (("optimizers", core_optimizers),
                    ("mirror", core_mirror), ("monitor", core_monitor)):
        t0 = time.perf_counter()
        rec[key] = fn(torch, mt, ck, params)
        part_s[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    for key, fn in (("feedforward", core_feedforward),
                    ("sequential", core_sequential)):
        t0 = time.perf_counter()
        rec[key] = fn(torch, mt)
        part_s[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    parts = [r for r in rec["optimizers"].values()]
    parts += [r for r in rec["mirror"].values()] + [rec["monitor"]]
    rec["launches"] = {k: sum(p["launches"].get(k, 0) for p in parts)
                       for k in PACKED_KERNELS}
    rec["part_wall_s"] = part_s
    opt = rec["optimizers"]
    print(json.dumps({"core_summary": {
        "optimizer_step_p50_ms": {k: v["step_p50_ms"] for k, v in opt.items()
                                  if "step_p50_ms" in v},
        "optimizer_eager_step_p50_ms": {
            k: v["eager_step_p50_ms"] for k, v in opt.items()
            if "eager_step_p50_ms" in v},
        "sgld_noise": {k: opt["sgld_noise"][k] for k in (
            "weights", "mean", "variance", "lr")},
        "mirror": {k: {"first_step_err_over_tol":
                       v["first_step_err_over_tol"], **{
                           f"{m}_{f}": v[m][f] for m in ("mirror", "plain")
                           for f in ("step_p50_ms", "peak_memory_bytes")}}
                   for k, v in rec["mirror"].items()},
        "monitor": {k: rec["monitor"][k] for k in (
            "statistics", "names_per_step", "loss_err_over_tol", "toc_ms",
            "wall_s")},
        "feedforward": rec["feedforward"], "sequential": rec["sequential"],
        "launches": rec["launches"], "part_wall_s": part_s,
        "card": card_line()}}))
    return rec


# ---------------------------------------------------------------------------
# phase 16: the prefix cache and chunked prefill (queue A item 7, part 1)
# ---------------------------------------------------------------------------

# (a)'s traffic: a PREFIX_TOKENS-token system prompt (32 pages), a first
# request of it alone, then PREFIX_REQUESTS requests of it plus distinct
# 16-400-token suffixes, PREFIX_NEW tokens each, two sampled
PREFIX_TOKENS, PREFIX_REQUESTS, PREFIX_NEW = 512, 15, 32
PREFIX_SAMPLED = (4, 10)
# (c): a pool of PRESSURE_PAGES usable pages against six streams of a
# shared 256-token prompt growing by 160 tokens each (lifetimes ~88 pages)
PRESSURE_PAGES, PRESSURE_PREFIX, PRESSURE_NEW = 48, 256, 160
# (d): four 900-token prompts and one of 960 (above the engine's largest
# prefill bucket, 512) in chunks of 256, beside 8 short streams decoding
CHUNK, CHUNK_LONG, CHUNK_LONGEST, CHUNK_NEW = 256, 900, 960, 32
CHUNK_SHORT, CHUNK_SHORT_NEW = 8, 96
CHUNK_BUCKETS = [16, 32, 64, 128, 256, 512]
# the top-2 logit margin above which int8 pages must not change a greedy
# token (tests/torch_serving_parity.py's QMARGIN)
QMARGIN = 1e-2
# B8 at the suffix prefill's shapes (start, suffix bucket): (a)'s hit
# (512 cached, the longest suffix's bucket) and (d)'s last chunk
SUFFIX_SHAPES = ((PREFIX_TOKENS, 512), (768, CHUNK))
# one prefill call at the model level, (cached tokens, tokens run): a
# miss of (a)'s mean prompt, a hit's mean suffix, a chunk
PREFILL_TIMED = ((0, 712), (PREFIX_TOKENS, 200), (PREFIX_TOKENS, CHUNK))


def limit_pairs(Tq, Tk, causal, koff, kv_len):
    """The (query, key) pairs a head of B8 scores under its causal mask
    (``koff``) and the per-row key limits ``kv_len`` (a list, one a batch
    row), and the keys each row reads: what this run's data needs."""
    rows = np.clip(np.arange(Tq) - koff + 1, 0, Tk) if causal \
        else np.full(Tq, Tk)
    lims = np.clip(np.asarray(kv_len), 0, Tk)
    pairs = int(sum(np.minimum(rows, n).sum() for n in lims))
    return pairs, int(lims.sum())


def check_limit(torch, ck, F, Hh, Tq, Tk, Dh, causal, kv_len, dtype, label,
                koff=0, q=None, k=None, v=None):
    """B8 with its per-row key limit (``kv_len``, (B,) int32 on the card)
    against its plain version on the same inputs: m's -inf pattern
    exactly, a row that sees no key the exact empty state (m = -inf, l =
    0, o = 0), o / l within ``TOL``.  Timed beside its plain version,
    SDPA with the same boolean mask (the library yardstick: rows that
    see no key come out NaN there, which the timing ignores) and its
    bound over the keys this run's limits let it read."""
    dt = getattr(torch, dtype)
    B = len(kv_len)
    if q is None:
        g = torch.Generator(device="cuda").manual_seed(Tq + Tk + B + Dh)
        q, k, v = (torch.randn((B, T, Hh, Dh), generator=g, device="cuda")
                   .to(dt) for T in (Tq, Tk, Tk))
    lim = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    o, m, l = ck.flash_attention_partial(q, k, v, causal, KVB, koff,
                                         kv_len=lim)
    po, pm, pl = ck.flash_attention_partial_plain(q, k, v, causal, KVB, koff,
                                                  kv_len=lim)
    torch.cuda.synchronize()
    shape = (f"{label} B={B} H={Hh} Tq={Tq} Tk={Tk} D={Dh} koff={koff} "
             f"{'causal' if causal else 'full'} kv_len={list(kv_len)[:8]}")
    empty = torch.isinf(pm)
    check(torch.equal(torch.isinf(m), empty)
          and not bool(torch.isnan(o).any() or torch.isnan(l).any()),
          f"flash_attention_partial {shape} {dtype}: the -inf pattern of m "
          f"differs from the plain version's, or a NaN")
    check(bool((m[empty] < 0).all()) and not bool(o[empty].any())
          and not bool(l[empty].any()),
          f"flash_attention_partial {shape} {dtype}: a row that sees no "
          f"key is not the exact empty state")
    lsafe, plsafe = (x.clamp(min=1e-30)[..., None] for x in (l, pl))
    err = ((o / lsafe) - (po / plsafe)).abs().max().item()
    check(err <= TOL[dtype], f"flash_attention_partial {shape} {dtype}: "
          f"o/l max_abs_err {err} (tolerance {TOL[dtype]})")
    pairs, keys = limit_pairs(Tq, Tk, causal, koff, kv_len)
    pairs *= Hh
    es = q.element_size()
    nbytes = (B * Tq + 2 * keys) * Hh * Dh * es \
        + B * Hh * Tq * (Dh + 2) * 4
    b_ms, b_by = bound(nbytes, 4 * Dh * pairs, dtype)
    kpos = torch.arange(Tk, device="cuda")
    mask = (kpos[None, :] < lim[:, None])[:, None, None, :]
    if causal:
        mask = mask & ((kpos + koff)[None, :] <= torch.arange(
            Tq, device="cuda")[:, None])[None, None]
    q4, k4, v4 = (x.transpose(1, 2) for x in (q, k, v))
    run = lambda: ck.flash_attention_partial(q, k, v, causal, KVB, koff,
                                             kv_len=lim)
    return {"kernel": "flash_attention_partial", "shape": shape,
            "dtype": dtype, "max_abs_err": err, "tol": TOL[dtype],
            "rows_seeing_no_key": int(empty.sum()),
            "ms": time_ms(torch, run),
            "back_to_back_ms": back_to_back_ms(torch, run),
            "plain_ms": time_ms(torch, lambda: ck.flash_attention_partial_plain(
                q, k, v, causal, KVB, koff, kv_len=lim), reps=5, warmup=1),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask)),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_tc_ms": bound_tc(nbytes, 4 * Dh * pairs, dtype)}


# B8's per-row key limit at the edges (phase 19): B = 8 rows of 512 keys
# whose limits are empty, one key, a tile boundary (64) and beside it, a
# page, all keys, and past them
LIMIT_EDGES = (0, 1, 63, 64, 65, KVB, 512, 517)
# a decode row over a contiguous cache: 16 streams of up to 1024 tokens
LIMIT_DECODE = (16, 1024)


def check_suffix_attention(torch, ck, tatt, F, start, Ts, dtype="float32"):
    """B8 as the suffix prefill calls it (one stream, H heads of D, the
    table's pages gathered at a fixed width C = the next power of two of
    start + Ts tokens, stale bytes past ``start``): the prefix launch
    (non-causal, ``kv_len = start`` from the card's memory) and the
    suffix launch (causal, ``kv_offset = 0``), each against its plain
    version (``check_limit`` records, timed, with SDPA under the same
    mask and the bound), then ``prefix_suffix_attention``'s merged rows
    against the plain body over [prefix | suffix] at ``kv_offset =
    -start`` within ``TOL``."""
    g = torch.Generator(device="cuda").manual_seed(start + Ts)
    dt = getattr(torch, dtype)
    C = 1 << (start + Ts - 1).bit_length()
    q, ks, vs = (torch.randn((1, Ts, H, D), generator=g, device="cuda")
                 .to(dt) for _ in range(3))
    kg, vg = (torch.randn((1, C, H, D), generator=g, device="cuda")
              .to(dt) for _ in range(2))
    lim = torch.tensor([start], dtype=torch.int32, device="cuda")
    out = tatt.prefix_suffix_attention(q, ks, vs, kg, vg, lim, KVB)
    k = torch.cat([kg[:, :start], ks], 1)
    v = torch.cat([vg[:, :start], vs], 1)
    o, m, l = tatt._blockwise_attention_partial_plain(q, k, v, True, KVB,
                                                      -start)
    ref = tatt.normalize_attention_state(o, m, l, dt)
    err = (out.float() - ref.float()).abs().max().item()
    shape = f"suffix start={start} Ts={Ts} C={C} H={H} D={D}"
    check(bool(torch.isfinite(out).all()) and err <= TOL[dtype],
          f"prefix_suffix_attention {shape} {dtype}: max_abs_err {err}")
    recs = [check_limit(torch, ck, F, H, Ts, C, D, False, [start], dtype,
                        f"suffix-prefix start={start} Ts={Ts}", q=q, k=kg,
                        v=vg),
            check_limit(torch, ck, F, H, Ts, Ts, D, True, [Ts], dtype,
                        f"suffix-self start={start} Ts={Ts}", q=q, k=ks,
                        v=vs)]
    for r in recs:
        r["merged_max_abs_err"] = err
    return recs


def limit_checks(torch, ck, tatt, F):
    """Phase 19's B8 key-limit checks in fp32, bf16 and fp16: the suffix
    prefill at ``SUFFIX_SHAPES`` (PERF.md row 8's), a decode row over a
    contiguous cache (``LIMIT_DECODE``, seeded lengths with a padded
    row), and ``LIMIT_EDGES`` causal and not."""
    rng = np.random.RandomState(19)
    B, C = LIMIT_DECODE
    lengths = [0] + [int(n) for n in rng.randint(1, C + 1, size=B - 1)]
    out = []
    for dtype in ("float32", *HALF_DTYPES):
        for s, ts in SUFFIX_SHAPES:
            out += check_suffix_attention(torch, ck, tatt, F, s, ts, dtype)
        out.append(check_limit(torch, ck, F, H, 1, C, D, False, lengths,
                               dtype, "decode"))
        for causal in (False, True):
            out.append(check_limit(torch, ck, F, H, 256, 512, D, causal,
                                   list(LIMIT_EDGES), dtype, "edges"))
        torch.cuda.empty_cache()
    return out


# the engine's host work in (a), by method: (label, attribute path under
# the engine).  _run_prefill only queues the forward; _sample_first waits
# for the device and copies the first token back
HOST_SPANS = (("admit", "_admit"), ("prefill", "_prefill"),
              ("run_prefill", "_run_prefill"),
              ("model.prefill", "_model.prefill"),
              ("model.suffix_prefill", "_model.suffix_prefill"),
              ("sample_first", "_sample_first"),
              ("finish_prefill", "_finish_prefill"), ("step", "_step"),
              ("cow_active", "_cow_active"), ("retire", "_retire"),
              ("prefix.peek", "_prefix.peek"),
              ("prefix.attach", "_prefix.attach"),
              ("prefix.register", "_prefix.register"),
              ("prefix.release", "_prefix.release"))


@contextlib.contextmanager
def host_spans(eng, spans=HOST_SPANS):
    """Time the engine's methods named in ``spans`` on the host clock
    while the block runs: each is shadowed on its object by a wrapper
    that adds its inclusive wall time and a call to the label's total
    (a few microseconds a call).  Yields the totals; read them with
    ``span_report``.  Spans whose object is absent (no prefix cache) are
    skipped."""
    totals, undo = {}, []
    for label, path in spans:
        *owners, attr = path.split(".")
        obj = eng
        for o in owners:
            obj = getattr(obj, o, None)
        if obj is None:
            continue
        fn = getattr(obj, attr)

        def timed(*a, _fn=fn, _label=label, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                tot = totals.setdefault(_label, [0.0, 0])
                tot[0] += time.perf_counter() - t
                tot[1] += 1

        object.__setattr__(obj, attr, timed)
        undo.append((obj, attr))
    try:
        yield totals
    finally:
        for obj, attr in undo:
            object.__delattr__(obj, attr)


def engine_prefill_profile(torch, eng, prompt, top=12):
    """One admission of ``prompt`` through ``eng`` (``max_new`` 1: its
    prefill and first token, no step) under ``torch.profiler`` with the
    device's activity: the wall, every device kernel's time by name
    (``top`` of them) and their sum, so a device wait at the end of the
    prefill can be read against the kernels that make it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.generate(prompt, 1)
        wall = (time.perf_counter() - t) * 1e3
    ev = sorted((e for e in prof.key_averages()
                 if e.self_device_time_total > 0),
                key=lambda e: -e.self_device_time_total)
    return {"tokens": len(prompt), "wall_ms": wall,
            "device_ms": sum(e.self_device_time_total for e in ev) / 1e3,
            "top": [[e.key, e.count, e.self_device_time_total / 1e3]
                    for e in ev[:top]]}


def span_report(totals):
    """``host_spans`` totals as {label: {calls, ms_per_call, ms}}."""
    return {k: {"calls": n, "ms_per_call": t * 1e3 / n, "ms": t * 1e3}
            for k, (t, n) in totals.items() if n}


@contextlib.contextmanager
def counted_engine(torch, mt, ck, dev_params, warm=(), **engine_kw):
    """A fresh ``DecodeEngine`` of the GPT-2-class LM after a warm-up
    request and the ``warm`` requests ((prompt, max_new[, temperature]):
    prompts of the traffic's shapes under other tokens and its
    temperatures, served together, so the measured traffic meets no
    first use of a shape or of the sampler), with its stats and the
    launch counts reset just before the caller's traffic."""
    kw = dict(kv_block=KVB, max_streams=16, seed=0)
    kw.update(engine_kw)
    with mt.DecodeEngine(dev_params, **GPT2_SMALL, ctx=mt.gpu(0),
                         **kw) as eng:
        eng.generate(np.arange(1, 20, dtype=np.int32), 2)  # CUDA warm-up
        for f in [eng.submit(*w) for w in warm]:
            f.result(timeout=600)
        torch.cuda.synchronize()
        eng.reset_stats()
        ck.reset_launch_counts()
        yield eng


def shared_prompt_traffic(seed=4, lens=None):
    """(a)'s requests: (system prompt, the first request, the others,
    their temperatures); ``lens`` (the suffixes' lengths) are drawn from
    ``seed`` unless given."""
    V = GPT2_SMALL["vocab_size"]
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, V, size=PREFIX_TOKENS).astype(np.int32)
    first = np.concatenate([prefix, rng.randint(1, V, size=64)]) \
        .astype(np.int32)
    drawn = rng.randint(16, 401, size=PREFIX_REQUESTS)
    lens = drawn if lens is None else lens
    prompts = [np.concatenate([prefix, rng.randint(1, V, size=n)])
               .astype(np.int32) for n in lens]
    temps = [0.8 if i in PREFIX_SAMPLED else 0.0
             for i in range(PREFIX_REQUESTS)]
    return prefix, first, prompts, temps


def expect_prefix_launches(launches, st, run, quant=False, misses=None):
    """The launch rule of a run with the prefix cache: B1 12 times a
    whole-prompt prefill (``misses``; by default every prefill that is
    not a hit's suffix), B8 24 times a chunk or a hit's suffix prefill
    (the prefix under its key limit, then the suffix, a layer),
    the paged decode kernel 12 times a plain step and the verify kernel
    12 times a verify step (their quantized instantiations over int8 /
    fp8 pages)."""
    L = GPT2_SMALL["num_layers"]
    suffix = st["prefix_hits"] - st["prefix_full_hits"]
    if misses is None:
        misses = st["prefills"] - suffix
    plain = st["steps"] - st["spec_steps"]
    q = "_quant" if quant else ""
    want = {"flash_mha_packed": L * misses,
            "flash_attention_partial": 2 * L * (suffix
                                                + st["prefill_chunks"]),
            f"paged_attention_decode{q}": L * plain,
            f"paged_attention_verify{q}": L * st["spec_steps"],
            "paged_attention_decode" + ("" if quant else "_quant"): 0,
            "paged_attention_verify" + ("" if quant else "_quant"): 0}
    _expect_launches(launches, want, run)


def shared_prompt_run(torch, mt, ck, dev_params, traffic, label, **kw):
    """(a): the first request alone, then the rest together, after a
    warm pass of the same shapes under another system prompt.  With the
    cache on also (b): the system prompt alone again (a full hit), its
    shared tail page's bytes compared before and after the COW."""
    prefix, first, prompts, temps = traffic
    # the warm pass's suffixes are the traffic's lengths: its hits capture
    # the (tp, mb) suffix-prefill executables the traffic replays
    _, wfirst, wprompts, _ = shared_prompt_traffic(
        seed=5, lens=[len(p) - PREFIX_TOKENS for p in prompts])
    # the temperatures too: the process's first sampled token costs ~90
    # ms once (tools/torch_prefill_trace.py), which must not land in (a)
    warm = [(p, PREFIX_NEW, t) for p, t in zip([wfirst] + wprompts,
                                               [0.0] + temps)]
    out = {}
    with counted_engine(torch, mt, ck, dev_params, warm=warm, **kw) as eng:
        with host_spans(eng) as totals:
            t0 = time.perf_counter()
            outs = [eng.generate(first, PREFIX_NEW)]
            futs = [eng.submit(p, PREFIX_NEW, temperature=t)
                    for p, t in zip(prompts, temps)]
            outs += [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
        launches, st = dict(ck.LAUNCHES), eng.stats()
        model = eng.model
        # a probe of the system prompt and 200 new tokens: a hit of 512
        # with the cache on, a 712-token miss with it off
        probe = np.concatenate([prefix, np.random.RandomState(7).randint(
            1, GPT2_SMALL["vocab_size"], size=200)]).astype(np.int32)
        out["profile"] = engine_prefill_profile(torch, eng, probe)
        if st["prefix_cache"]:
            chain = [n.page for n in eng._prefix.index.match(
                prefix, touch=False)]
            check(len(chain) == PREFIX_TOKENS // KVB,
                  f"16{label}: the system prompt's chain holds {len(chain)} "
                  f"pages")
            before = [p[chain[-1]].view(torch.uint8).clone()
                      for p in eng._pools]
            eng.reset_stats()
            ck.reset_launch_counts()
            again = eng.generate(prefix, PREFIX_NEW)
            st_b, launches_b = eng.stats(), dict(ck.LAUNCHES)
            same = all(torch.equal(p[chain[-1]].view(torch.uint8), b)
                       for p, b in zip(eng._pools, before))
            out["full_hit"] = (again, st_b, launches_b, same)
    out.update(outs=outs, st=st, launches=launches, model=model, rec={
        "wall_s": wall, "prefix_hits": st["prefix_hits"] if st[
            "prefix_cache"] else None,
        "prefill_tokens": st["prefill_tokens"], "prefills": st["prefills"],
        "steps": st["steps"], "ttft_p50_ms": st["ttft_p50_ms"],
        "ttft_hit_p50_ms": st["ttft_hit_p50_ms"],
        "ttft_miss_p50_ms": st["ttft_miss_p50_ms"],
        "prefill_p50_ms": st["prefill_p50_ms"],
        "queue_wait_p50_ms": st["queue_wait_p50_ms"],
        "step_p50_ms": st["step_p50_ms"],
        "tokens_per_s": st["tokens"] / wall, "launches": launches,
        "host_spans": span_report(totals), "profile": out["profile"]})
    return out


def pressure_run(torch, mt, ck, dev_params):
    """(c): a 48-page pool.  A request of a 256-token prompt P and one
    of another prompt retire and park their pages; then six requests of
    P plus distinct suffixes, 160 tokens each (~88 pages of lifetimes):
    admission revives P's chain and evicts the other parked pages,
    growth preempts streams that hold P's shared pages, and they return
    as prefix hits."""
    V = GPT2_SMALL["vocab_size"]
    rng = np.random.RandomState(12)
    P = rng.randint(1, V, size=PRESSURE_PREFIX).astype(np.int32)
    seed_req = np.concatenate([P, rng.randint(1, V, size=16)]).astype(
        np.int32)
    other = rng.randint(1, V, size=128).astype(np.int32)
    prompts = [np.concatenate([P, rng.randint(1, V, size=n)])
               .astype(np.int32) for n in (16, 24, 32, 40, 48, 56)]
    with counted_engine(torch, mt, ck, dev_params,
                        cache_blocks=1 + PRESSURE_PAGES) as eng:
        eng.generate(seed_req, 2)
        eng.generate(other, 2)
        futs = [eng.submit(p, PRESSURE_NEW) for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        launches, st = dict(ck.LAUNCHES), eng.stats()
        a = eng._alloc
        pages = (a.free_list_blocks, a.parked_blocks, a.capacity)
        model = eng.model
    check(st["evictions"] >= 1 and st["preempted"] >= 1
          and st["prefix_hits"] >= len(prompts),
          f"16c: evictions {st['evictions']}, preempted {st['preempted']}, "
          f"hits {st['prefix_hits']}")
    check(st["cache_util"] == 0.0 and pages[0] + pages[1] == pages[2],
          f"16c: pages leaked: free {pages[0]} + parked {pages[1]} of "
          f"{pages[2]}, cache_util {st['cache_util']}")
    expect_prefix_launches(launches, st, "16c")
    forward_check(torch, model, prompts, outs, [0.0] * len(prompts),
                  [len(p) for p in prompts], "16c")
    return {"evictions": st["evictions"], "preempted": st["preempted"],
            "prefix_hits": st["prefix_hits"], "prefills": st["prefills"],
            "free_pages": pages[0], "parked_pages": pages[1],
            "launches": launches}


def chunk_traffic(seed=13):
    V = GPT2_SMALL["vocab_size"]
    rng = np.random.RandomState(seed)
    short = [rng.randint(1, V, size=n).astype(np.int32)
             for n in rng.randint(32, 65, size=CHUNK_SHORT)]
    long = [rng.randint(1, V, size=n).astype(np.int32)
            for n in [CHUNK_LONG] * 4 + [CHUNK_LONGEST]]
    return short, long


def chunk_run(torch, mt, ck, dev_params, traffic, **kw):
    """(d): the short streams first; once all decode, the long prompts
    (after a warm pass of the same shapes under other tokens).  Returns
    outputs, stats, launches and the short streams' host ms a token
    (submit to result over their tokens: what a stall costs them)."""
    short, long = traffic
    warm = [(p, 2) for p in sum(chunk_traffic(seed=14), [])]
    with counted_engine(torch, mt, ck, dev_params, warm=warm, **kw) as eng:
        done = {}
        futs = []
        for i, p in enumerate(short):
            t = time.perf_counter()
            f = eng.submit(p, CHUNK_SHORT_NEW)
            f.add_done_callback(
                lambda _f, i=i, t=t: done.__setitem__(
                    i, time.perf_counter() - t))
            futs.append(f)
        deadline = time.perf_counter() + 120
        while eng.stats()["active_streams"] < len(short):
            check(time.perf_counter() < deadline, "16d: short streams idle")
            time.sleep(0.002)
        futs += [eng.submit(p, CHUNK_NEW) for p in long]
        outs = [f.result(timeout=600) for f in futs]
        launches, st = dict(ck.LAUNCHES), eng.stats()
        model = eng.model
    per_tok = [done[i] * 1e3 / CHUNK_SHORT_NEW for i in range(len(short))]
    return outs, st, launches, model, {
        "short_ms_per_token_p50": float(np.median(per_tok)),
        "short_ms_per_token_max": float(np.max(per_tok)),
        "step_p50_ms": st["step_p50_ms"], "steps": st["steps"],
        "prefill_chunks": st["prefill_chunks"],
        "prefill_chunk_p50_ms": st["prefill_chunk_p50_ms"],
        "launches": launches}


def prefill_timing(torch, model):
    """One prefill call of the served model at ``PREFILL_TIMED``'s
    shapes over fresh fp32 pools: ``prefill`` for a miss,
    ``suffix_prefill`` over cached pages for a hit or a chunk, each
    padded to its bucket: host ms of a call ending in a synchronize
    (median of 5 after 2) beside the device's (``step_device_ms``: its
    kernels' time and the CUDA-event span)."""
    L = GPT2_SMALL["num_layers"]
    pools = [torch.zeros((128, KVB, H, D), device="cuda")
             for _ in range(2 * L)]
    out = []
    for start, n in PREFILL_TIMED:
        tp = 1 << (n - 1).bit_length()
        data = torch.randint(1, GPT2_SMALL["vocab_size"], (1, tp),
                             device="cuda")
        pos = (start + torch.arange(tp, device="cuda"))[None]
        lengths = torch.tensor([start + n], dtype=torch.int32,
                               device="cuda")
        table = torch.arange(1, 1 + (start + tp) // KVB, dtype=torch.int32,
                             device="cuda")[None]
        if start:
            def fn():
                model.suffix_prefill(data, pos, start, lengths, table, pools)
        else:
            def fn():
                model.prefill(data, pos, lengths, table, pools)
        host = []
        for i in range(7):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t) * 1e3)
        out.append({"start": start, "tokens": n, "bucket": tp,
                    "host_ms": float(np.median(host[2:])),
                    **step_device_ms(torch, fn, reps=3),
                    "host_ops": host_ops(torch, fn, top=40)})
    del pools
    return out


def host_ops(torch, fn, reps=3, top=12):
    """Where one call's host time goes: ``torch.profiler`` on the CPU
    only over ``reps`` calls (each ending in a synchronize), the ops'
    self time a call (``aten_ms``: every recorded op's; ``top``: the
    largest, by name, with their calls a call) beside the call's wall
    time under the profiler.  What the wall holds beyond ``aten_ms`` is
    Python and the kernel wrappers' launches (ctypes), which the
    profiler does not see as ops."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    ev = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"profiled_wall_ms": wall,
            "aten_ms": sum(e.self_cpu_time_total for e in ev) / 1e3 / reps,
            "ops": sum(e.count for e in ev) / reps,
            "top": [[e.key, e.count / reps,
                     e.self_cpu_time_total / 1e3 / reps] for e in ev[:top]]}


def margin_agree(torch, model, prompts, a, b, tol=1e-3):
    """Greedy chains ``a`` and ``b`` of ``prompts``: the positions before
    the first where they differ, and whether the full forward over
    ``a``'s chain has its top-2 margin at or below ``tol`` there (a
    near-tie, where batch shapes may round either way)."""
    firsts, ties = [], 0
    for p, x, y in zip(prompts, a, b):
        diff = np.nonzero(x != y)[0]
        if not diff.size:
            firsts.append(len(x))
            continue
        j = int(diff[0])
        seq = np.concatenate([p, x])
        row = model(torch.from_numpy(seq).cuda()[None])[0][len(p) - 1 + j]
        top2 = torch.topk(row.float(), 2).values
        check(float(top2[0] - top2[1]) <= tol,
              f"chains differ at token {j} where the full forward's top-2 "
              f"margin {float(top2[0] - top2[1])} exceeds {tol}")
        firsts.append(j)
        ties += 1
    return firsts, ties


def prefix_path(torch, mt, ck, tatt, F):
    """Phase 16, the prefix cache and chunked prefill at the GPT-2-class
    width (fp32 pages unless said, KVB 16), each run's launch counts
    reset just before its traffic and read just after:

    (a) a 512-token system prompt: one request alone, then 15 of it
        plus distinct 16-400-token suffixes (two sampled), with the
        cache on and off: 15 hits of 512 tokens, 15 x 512 fewer prefill
        tokens, B1 12 a miss, B8 24 a hit's suffix, the decode kernel 12
        a step, the full forward on both runs' greedy streams;
    (b) the system prompt alone again: a full hit, one COW, the shared
        page's bytes unchanged, no prefill launch;
    (c) a pool too small for the lifetimes: evictions, preemptions of
        streams holding shared pages, no page leaked;
    (d) four 900-token prompts and a 960 (above the largest prefill
        bucket, 512) in chunks of 256 beside 8 short decoding streams,
        with the cache on and off, and unchunked (buckets to 1024): the
        chunk count, B8 24 a chunk, the full forward, the cache-off
        chains equal up to a near-tie, the short streams' cost;
    (e) (a)'s traffic over int8 pages (B8 and the quantized decode
        kernel, first tokens as (a)'s up to a near-tie), and
        ``spec_tokens=4`` on ``spec_prompts()`` with the cache and
        chunks of 256 (run B's launch rule with chunks)."""
    t_start = time.perf_counter()
    L = GPT2_SMALL["num_layers"]
    kernels = [c for s, ts in SUFFIX_SHAPES
               for c in check_suffix_attention(torch, ck, tatt, F, s, ts)]
    for c in kernels:
        print(json.dumps({"check": c}))
    ck.reset_launch_counts()
    dev_params = mt.params_from_numpy(gpt2_small_params(0), "cuda")
    traffic = shared_prompt_traffic()
    prefix, first, prompts, temps = traffic
    all_prompts, all_temps = [first] + prompts, [0.0] + temps
    lens = [len(p) for p in all_prompts]
    parts, part_s, launches = {}, {}, {}

    def tally(got):
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    t0 = time.perf_counter()
    on = shared_prompt_run(torch, mt, ck, dev_params, traffic, "a")
    off = shared_prompt_run(torch, mt, ck, dev_params, traffic, "a",
                            prefix_cache=0)
    st = on["st"]
    check(st["prefix_hits"] == PREFIX_REQUESTS
          and st["prefix_hit_tokens"] == PREFIX_REQUESTS * PREFIX_TOKENS
          and st["prefix_full_hits"] == 0,
          f"16a: hits {st['prefix_hits']}, hit tokens "
          f"{st['prefix_hit_tokens']}, full hits {st['prefix_full_hits']}")
    saved = off["st"]["prefill_tokens"] - st["prefill_tokens"]
    check(saved == PREFIX_REQUESTS * PREFIX_TOKENS,
          f"16a: prefill tokens {st['prefill_tokens']} against "
          f"{off['st']['prefill_tokens']} with the cache off")
    expect_prefix_launches(on["launches"], st, "16a", misses=1)
    expect_prefix_launches(off["launches"], {**off["st"], "prefix_hits": 0,
                                             "prefix_full_hits": 0},
                           "16a off", misses=1 + PREFIX_REQUESTS)
    for run in (on, off):
        forward_check(torch, run["model"], all_prompts, run["outs"],
                      all_temps, lens, "16a")
        tally(run["launches"])
    parts["a"] = {"cache_on": on["rec"], "cache_off": off["rec"],
                  "prefill_tokens_saved": saved,
                  "prefill_calls": prefill_timing(torch, on["model"])}
    again, st_b, launches_b, same = on["full_hit"]
    check(st_b["prefix_full_hits"] >= 1 and st_b["cow_copies"] >= 1
          and same, f"16b: full hits {st_b['prefix_full_hits']}, COWs "
          f"{st_b['cow_copies']}, shared page unchanged {same}")
    expect_prefix_launches(launches_b, st_b, "16b", misses=0)
    check(st_b["prefills"] == 0, f"16b: {st_b['prefills']} prefills")
    forward_check(torch, on["model"], [prefix], [again], [0.0],
                  [PREFIX_TOKENS], "16b")
    tally(launches_b)
    parts["b"] = {"prefix_full_hits": st_b["prefix_full_hits"],
                  "cow_copies": st_b["cow_copies"],
                  "shared_page_unchanged": same,
                  "ttft_hit_p50_ms": st_b["ttft_hit_p50_ms"],
                  "launches": launches_b}
    part_s["ab"] = time.perf_counter() - t0
    del on["model"], off["model"]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    parts["c"] = pressure_run(torch, mt, ck, dev_params)
    tally(parts["c"]["launches"])
    part_s["c"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ctraffic = chunk_traffic()
    short, long = ctraffic
    want_chunks = sum(-(-len(p) // CHUNK) for p in long)
    runs_d = {}
    for name, kw in (("chunked", dict(prefill_chunk=CHUNK,
                                      prefill_buckets=CHUNK_BUCKETS)),
                     ("chunked_cache_off", dict(
                         prefill_chunk=CHUNK, prefill_buckets=CHUNK_BUCKETS,
                         prefix_cache=0)),
                     ("unchunked", {})):
        outs, st, got, model, rec = chunk_run(torch, mt, ck, dev_params,
                                              ctraffic, **kw)
        cached = kw.get("prefix_cache", 1)
        stx = st if cached else {**st, "prefix_hits": 0,
                                 "prefix_full_hits": 0}
        check(stx["prefix_hits"] == 0, f"16d {name}: {stx['prefix_hits']} "
              f"hits on random prompts")
        chunked = len(long) if "prefill_chunk" in kw else 0
        expect_prefix_launches(got, stx, f"16d {name}",
                               misses=len(short) + len(long) - chunked)
        check(st["prefill_chunks"] == (want_chunks if chunked else 0),
              f"16d {name}: {st['prefill_chunks']} chunks, want "
              f"{want_chunks if chunked else 0}")
        runs_d[name] = (outs, model)
        rec["launches"] = got
        tally(got)
        parts.setdefault("d", {})[name] = rec
    outs, model = runs_d["chunked"]
    every = short + long
    forward_check(torch, model, every, outs, [0.0] * len(every),
                  [len(p) for p in every], "16d")
    firsts, ties = margin_agree(torch, model, every, outs,
                                runs_d["chunked_cache_off"][0])
    parts["d"]["cache_off_equal_streams"] = sum(
        f == len(o) for f, o in zip(firsts, outs))
    parts["d"]["cache_off_near_ties"] = ties
    del runs_d
    part_s["d"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    q8 = shared_prompt_run(torch, mt, ck, dev_params, traffic, "e",
                           kv_dtype="int8")
    st = q8["st"]
    check(st["prefix_hits"] == PREFIX_REQUESTS,
          f"16e int8: {st['prefix_hits']} hits")
    expect_prefix_launches(q8["launches"], st, "16e int8", quant=True,
                           misses=1)
    greedy = [i for i, t in enumerate(all_temps) if t == 0.0]
    # a hit reads the prefix from int8 pages where (a) read fp32 ones:
    # the first tokens agree wherever the fp32 forward's top-2 margin
    # exceeds QMARGIN
    firsts, ties = margin_agree(
        torch, q8["model"], [all_prompts[i] for i in greedy],
        [on["outs"][i][:1] for i in greedy],
        [q8["outs"][i][:1] for i in greedy], tol=QMARGIN)
    tally(q8["launches"])
    again, st_b, launches_b, same = q8["full_hit"]
    check(st_b["cow_copies"] >= 1 and same,
          f"16e int8 full hit: COWs {st_b['cow_copies']}, page kept {same}")
    tally(launches_b)
    parts["e"] = {"int8": {**q8["rec"], "first_tokens_equal_to_a": sum(
        f == 1 for f in firsts), "first_token_near_ties": ties}}
    del q8
    torch.cuda.empty_cache()
    spec = spec_prompts()
    stemps = [0.8 if i in (5, 12) else 0.0 for i in range(len(spec))]
    with counted_engine(torch, mt, ck, dev_params, spec_tokens=SPEC_K,
                        proposer="ngram", prefill_chunk=CHUNK) as eng:
        futs = [eng.submit(p, SPEC_NEW, temperature=t)
                for p, t in zip(spec, stemps)]
        souts = [f.result(timeout=600) for f in futs]
        got, st, model = dict(ck.LAUNCHES), eng.stats(), eng.model
    long_n = sum(len(p) > CHUNK for p in spec)
    check(st["spec_accepted"] > 0 and st["prefix_hits"] == 0
          and st["prefill_chunks"] == sum(-(-len(p) // CHUNK) for p in spec
                                          if len(p) > CHUNK),
          f"16e spec: accepted {st['spec_accepted']}, hits "
          f"{st['prefix_hits']}, chunks {st['prefill_chunks']}")
    expect_prefix_launches(got, st, "16e spec",
                           misses=len(spec) - long_n)
    forward_check(torch, model, spec, souts, stemps, [len(p) for p in spec],
                  "16e spec")
    tally(got)
    parts["e"]["spec"] = {"spec_steps": st["spec_steps"],
                          "spec_accepted": st["spec_accepted"],
                          "prefill_chunks": st["prefill_chunks"],
                          "step_p50_ms": st["step_p50_ms"], "launches": got}
    part_s["e"] = time.perf_counter() - t0
    del model, dev_params
    torch.cuda.empty_cache()
    a_on, a_off = parts["a"]["cache_on"], parts["a"]["cache_off"]
    d = parts["d"]
    summary = {
        "ttft_hit_p50_ms": a_on["ttft_hit_p50_ms"],
        "prefill_calls": parts["a"]["prefill_calls"],
        "ttft_miss_p50_ms": a_off["ttft_miss_p50_ms"],
        "ttft_p50_ms": [a_on["ttft_p50_ms"], a_off["ttft_p50_ms"]],
        "prefill_p50_ms": [a_on["prefill_p50_ms"], a_off["prefill_p50_ms"]],
        "step_p50_ms": [a_on["step_p50_ms"], a_off["step_p50_ms"]],
        "host_spans": [a_on["host_spans"], a_off["host_spans"]],
        "prefill_profile": [a_on["profile"], a_off["profile"]],
        "prefill_tokens": [a_on["prefill_tokens"], a_off["prefill_tokens"]],
        "prefill_tokens_saved": parts["a"]["prefill_tokens_saved"],
        "full_hit_ttft_ms": parts["b"]["ttft_hit_p50_ms"],
        "evictions": parts["c"]["evictions"],
        "preempted": parts["c"]["preempted"],
        "short_step_p50_ms": [d["chunked"]["step_p50_ms"],
                              d["unchunked"]["step_p50_ms"]],
        "short_ms_per_token_p50": [d["chunked"]["short_ms_per_token_p50"],
                                   d["unchunked"]["short_ms_per_token_p50"]],
        "short_ms_per_token_max": [d["chunked"]["short_ms_per_token_max"],
                                   d["unchunked"]["short_ms_per_token_max"]],
        "b8_serving_launches": launches.get("flash_attention_partial", 0),
        "part_wall_s": part_s, "wall_s": time.perf_counter() - t_start,
        "card": card_line()}
    print(json.dumps({"prefix_summary": summary}))
    return {"parts": parts, "kernels": kernels, "launches": launches,
            "summary": summary}


# ---------------------------------------------------------------------------
# phase 17: multi-tenant serving (LoRA adapters, quotas, SLO classes) and
# the draft-LM proposer
# ---------------------------------------------------------------------------

# seeded adapters of ranks 8, 8, 16 and 16 in the pool's rank buckets
TENANCY_RANKS, TENANCY_BUCKETS, TENANCY_SLOTS = (8, 8, 16, 16), (8, 16), 4
# (a): 4 requests per adapter and 4 plain (20), 64-256-token prompts,
# 32 new tokens each, two sampled
TENANCY_NEW, TENANCY_PER, TENANCY_SAMPLED = 32, 4, (2, 17)
# (b): a 256-token system prompt and 32-token suffixes
TENANCY_SYSTEM, TENANCY_SUFFIX = 256, 32
# (c): 6 rank-8 adapters into the 4 slots of bucket 8 while 8 streams
# of HOT_NEW tokens decode
HOT_ADAPTERS, HOT_STREAMS, HOT_NEW = 6, 8, 96
# (d): a quota of two requests of 64 + 32 tokens, and the tiers
QUOTA_PROMPT = 64
# (e): forward_check's margin over int8 pages, of the row's largest logit
INT8_MARGIN = 2.0 ** -5


def tenancy_adapters(seed=21, ranks=TENANCY_RANKS, prefix="t"):
    """Seeded LoRA pairs {name: (A, B, alpha)} of the GPT-2-class LM:
    A ~ N(0, 1/d_model), B ~ N(0, 1/r), alpha = r (scale 1), a delta of
    about unit size on each QKV lane beside the base projection's ~0.55,
    so an adapter's greedy chain leaves the base's within a few
    tokens."""
    rng = np.random.RandomState(seed)
    L, dm = GPT2_SMALL["num_layers"], GPT2_SMALL["d_model"]
    out = {}
    for i, r in enumerate(ranks):
        a = (rng.standard_normal((L, dm, r)) / np.sqrt(dm)).astype(np.float32)
        b = (rng.standard_normal((L, r, 3 * dm)) / np.sqrt(r)).astype(
            np.float32)
        out[f"{prefix}{i}"] = (a, b, float(r))
    return out


def merged_model(torch, dev_params, a, b, alpha):
    """The merged-weights LM, ``W + (alpha / r) (A B)^T`` on each layer's
    fused QKV weight (the product in float64 on the host): what an
    adapter stream's tokens are held against (``forward_check``)."""
    from mxnet_tpu_torch.models.transformer import TransformerLM

    L = GPT2_SMALL["num_layers"]
    params = dict(dev_params)
    for i in range(L):
        w = dev_params[f"layer{i}_qkv_weight"]
        delta = a[i].astype(np.float64) @ b[i] * (alpha / a.shape[2])
        params[f"layer{i}_qkv_weight"] = w + torch.from_numpy(
            delta.T.astype(np.float32)).to(w.device)
    return TransformerLM(params, num_layers=L,
                         num_heads=GPT2_SMALL["num_heads"], kv_block=KVB)


def adapter_pool(mt, slots=TENANCY_SLOTS, buckets=TENANCY_BUCKETS):
    return mt.AdapterPool(num_layers=GPT2_SMALL["num_layers"],
                          d_model=GPT2_SMALL["d_model"], slots=slots,
                          rank_buckets=buckets, ctx=mt.gpu(0))


def tenant_traffic(seed=17):
    """(a)'s prompts, their adapters (``TENANCY_PER`` each of t0-t3, as
    many plain) and temperatures."""
    V = GPT2_SMALL["vocab_size"]
    n = TENANCY_PER * (len(TENANCY_RANKS) + 1)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, V, size=k).astype(np.int32)
               for k in rng.randint(64, 257, size=n)]
    names = [f"t{i // TENANCY_PER}" if i < n - TENANCY_PER else None
             for i in range(n)]
    temps = [0.8 if i in TENANCY_SAMPLED else 0.0 for i in range(n)]
    return prompts, names, temps


def tenant_run(torch, mt, ck, dev_params, traffic, adapters, ads=None,
               **engine_kw):
    """One engine (an adapter pool with ``ads`` published when
    ``adapters``; ``engine_kw`` beside), a warm pass of the traffic's
    shapes under other tokens, then the traffic with the launch counts
    reset just before → (outputs, stats, launches, wall, model)."""
    prompts, names, temps = traffic
    wprompts, _, _ = tenant_traffic(seed=18)
    kw = dict(engine_kw)
    if adapters:
        kw["adapters"] = adapter_pool(mt)
        for name, (a, b, alpha) in (ads or {}).items():
            kw["adapters"].publish(name, a, b, alpha=alpha)
    with counted_engine(torch, mt, ck, dev_params, **kw) as eng:
        for f in [eng.submit(p, TENANCY_NEW, temperature=t, adapter=n)
                  for p, n, t in zip(wprompts, names, temps)]:
            f.result(timeout=600)
        torch.cuda.synchronize()
        eng.reset_stats()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [eng.submit(p, TENANCY_NEW, temperature=t, adapter=n,
                           tenant=n or "plain")
                for p, n, t in zip(prompts, names, temps)]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches, st, model = dict(ck.LAUNCHES), eng.stats(), eng.model
    return outs, st, launches, wall, model


def tenancy_mixed(torch, mt, ck, dev_params, ads):
    """(a) Mixed tenants: the traffic through a pre-adapter engine and an
    adapter-enabled one with no adapter named (bit for bit equal), then
    mixed (each adapter's greedy streams held by ``forward_check``
    against its merged-weights model, the plain ones against the base)."""
    L = GPT2_SMALL["num_layers"]
    prompts, names, temps = tenant_traffic()
    n = len(prompts)
    mine = [i for i in range(n) if names[i] is None]
    plain = (prompts, [None] * n, temps)
    base_outs, base_st, base_launches, _, _ = tenant_run(
        torch, mt, ck, dev_params, plain, adapters=False)
    off_outs, off_st, off_launches, _, _ = tenant_run(
        torch, mt, ck, dev_params, plain, adapters=True, ads=ads)
    same = sum(a.tobytes() == b.tobytes() for a, b in zip(base_outs,
                                                          off_outs))
    check(same == n, f"17a: {n - same} plain streams of the adapter-"
          f"enabled engine differ from the pre-adapter engine's")
    outs, st, launches, wall, model = tenant_run(
        torch, mt, ck, dev_params, (prompts, names, temps), adapters=True,
        ads=ads)
    for run, s, got in (("pre-adapter", base_st, base_launches),
                        ("no adapter named", off_st, off_launches),
                        ("mixed", st, launches)):
        check(s["prefix_hits"] == 0 and s["prefills"] == n,
              f"17a {run}: {s['prefix_hits']} hits, {s['prefills']} "
              f"prefills")
        _expect_launches(got, {
            "flash_mha_packed": L * s["prefills"],
            "paged_attention_decode": L * s["steps"],
            "flash_attention_partial": 0}, f"17a {run}")
    lens = [len(p) for p in prompts]
    forward_check(torch, model, [prompts[i] for i in mine],
                  [outs[i] for i in mine], [temps[i] for i in mine],
                  [lens[i] for i in mine], "17a plain")
    left = {}
    for name, (a, b, alpha) in ads.items():
        idx = [i for i in range(n) if names[i] == name]
        merged = merged_model(torch, dev_params, a, b, alpha)
        forward_check(torch, merged, [prompts[i] for i in idx],
                      [outs[i] for i in idx], [temps[i] for i in idx],
                      [lens[i] for i in idx], f"17a {name}")
        del merged
        # where the adapter's greedy chain leaves the base's
        greedy = [i for i in idx if temps[i] == 0.0]
        left[name] = [int(np.nonzero(outs[i] != base_outs[i])[0][0])
                      if not np.array_equal(outs[i], base_outs[i])
                      else None for i in greedy]
        check(all(j is not None for j in left[name]),
              f"17a {name}: a greedy chain equals the base's: {left[name]}")
    plain_same = sum(outs[i].tobytes() == base_outs[i].tobytes()
                     for i in mine)
    torch.cuda.empty_cache()
    return {"requests": n, "generated_tokens": int(sum(map(len, outs))),
            "wall_s": wall, "tokens_per_s": sum(map(len, outs)) / wall,
            "step_p50_ms": {"mixed": st["step_p50_ms"],
                            "no_adapter_named": off_st["step_p50_ms"],
                            "pre_adapter": base_st["step_p50_ms"]},
            "ttft_p50_ms": {"mixed": st["ttft_p50_ms"],
                            "no_adapter_named": off_st["ttft_p50_ms"],
                            "pre_adapter": base_st["ttft_p50_ms"]},
            "steps": st["steps"], "prefills": st["prefills"],
            "plain_streams_bitwise": same,
            "mixed_plain_streams_equal_to_plain_run": plain_same,
            "greedy_chain_leaves_base_at": left,
            "tenants": st["tenants"], "adapters": st["adapters"],
            "launches": {k: launches[k] + off_launches[k]
                         + base_launches[k] for k in launches}}


def tenancy_salted(torch, mt, ck, dev_params, ads):
    """(b) Salted prefixes: the system prompt with a new suffix each time,
    plain, under adapter X, plain, under X, then X retired and
    republished with other weights, under X again: hits only within a
    salt, none on X's old chain after the republish, every stream held
    by ``forward_check`` against its own model, B8 24 times a hit's
    suffix prefill."""
    L, V = GPT2_SMALL["num_layers"], GPT2_SMALL["vocab_size"]
    rng = np.random.RandomState(23)
    system = rng.randint(1, V, size=TENANCY_SYSTEM).astype(np.int32)
    prompts = [np.concatenate([system, rng.randint(1, V, size=TENANCY_SUFFIX)])
               .astype(np.int32) for _ in range(5)]
    x, x2 = ads["t0"], tenancy_adapters(seed=22, ranks=(8,), prefix="x")["x0"]
    order = [None, "X", None, "X", "X"]
    outs, hits = [], []
    with counted_engine(torch, mt, ck, dev_params,
                        adapters=adapter_pool(mt)) as eng:
        eng.publish_adapter("X", x[0], x[1], alpha=x[2])
        for i, (p, name) in enumerate(zip(prompts, order)):
            if i == 4:  # retire, then bind new weights to the name
                retired = eng.retire_adapter("X")
                eng.publish_adapter("X", x2[0], x2[1], alpha=x2[2])
            outs.append(eng.generate(p, TENANCY_NEW, adapter=name))
            hits.append(eng.stats()["prefix_hits"])
        launches, st, model = dict(ck.LAUNCHES), eng.stats(), eng.model
    # plain: a miss; X: a miss (its own salt); plain: a hit on the plain
    # chain; X: a hit on X's chain; X republished: a miss
    check(hits == [0, 0, 1, 2, 2] and retired,
          f"17b: prefix hits after each stream {hits}, want [0, 0, 1, 2, 2]"
          f" (retired at once: {retired})")
    suffix = st["prefix_hits"] - st["prefix_full_hits"]
    _expect_launches(launches, {
        "flash_mha_packed": L * (st["prefills"] - suffix),
        "flash_attention_partial": 2 * L * suffix}, "17b")
    models = {None: model,
              "X": merged_model(torch, dev_params, *x),
              "X2": merged_model(torch, dev_params, *x2)}
    for i, name in enumerate(order):
        forward_check(torch, models["X2" if i == 4 else name], [prompts[i]],
                      [outs[i]], [0.0], [len(prompts[i])], f"17b {i}")
    del models
    torch.cuda.empty_cache()
    return {"hits_after_each": hits, "prefix_hit_tokens":
            st["prefix_hit_tokens"], "suffix_prefills": suffix,
            "ttft_hit_p50_ms": st["ttft_hit_p50_ms"],
            "ttft_miss_p50_ms": st["ttft_miss_p50_ms"],
            "launches": launches}


def tenancy_hot(torch, mt, ck, dev_params):
    """(c) Hot publish and retire: 4 rank-8 adapters fill bucket 8's 4
    slots; 8 streams decode (2 on h0, 2 on h1, 4 plain); meanwhile h4
    and h5 are published (evicting parked ones, never a held slot: the
    held rows keep their bytes) and h1 is retired (deferred to its last
    stream); then an evicted adapter serves again (a miss, re-installed).
    At the end every adapter is retired: refcounts 0, every slot free."""
    V = GPT2_SMALL["vocab_size"]
    ads = tenancy_adapters(seed=24, ranks=(8,) * HOT_ADAPTERS, prefix="h")
    rng = np.random.RandomState(25)
    prompts = [rng.randint(1, V, size=n).astype(np.int32)
               for n in rng.randint(64, 129, size=HOT_STREAMS)]
    names = ["h0", "h0", "h1", "h1"] + [None] * (HOT_STREAMS - 4)
    pool = adapter_pool(mt)
    with counted_engine(torch, mt, ck, dev_params, adapters=pool) as eng:
        for n in ("h0", "h1", "h2", "h3"):
            a, b, alpha = ads[n]
            eng.publish_adapter(n, a, b, alpha=alpha)
        futs = [eng.submit(p, HOT_NEW, adapter=n) for p, n in zip(prompts,
                                                                  names)]
        deadline = time.perf_counter() + 120
        while eng.stats()["active_streams"] < HOT_STREAMS:
            check(time.perf_counter() < deadline, "17c: streams idle")
            time.sleep(0.002)
        held = {n: pool._entries[n].slot for n in ("h0", "h1")}
        slabs = pool.slabs()
        rows = {n: [s[held[n]].clone() for s in slabs[:2]] for n in held}
        for n in ("h4", "h5"):
            a, b, alpha = ads[n]
            eng.publish_adapter(n, a, b, alpha=alpha)
        retired_now = eng.retire_adapter("h1")
        torch.cuda.synchronize()
        kept = all(torch.equal(s[held[n]], r) for n in held
                   for s, r in zip(pool.slabs()[:2], rows[n]))
        active_during = eng.stats()["active_streams"]
        outs = [f.result(timeout=600) for f in futs]
        evictions = pool.stats()["evictions"]
        again = eng.generate(prompts[0], 8, adapter="h2")  # evicted: miss
        st = eng.stats()
        for n in ("h0", "h2", "h3", "h4", "h5"):
            eng.retire_adapter(n)
        end = pool.stats()
        refs = [pool.refcount(n) for n in ads]
        launches = dict(ck.LAUNCHES)
    check(st["shed"] == 0 and all(o.shape == (HOT_NEW,) for o in outs)
          and again.shape == (8,), f"17c: shed {st['shed']}")
    check(evictions >= 1 and kept and not retired_now
          and active_during == HOT_STREAMS,
          f"17c: evictions {evictions}, held rows kept {kept}, h1 retired "
          f"at once {retired_now}, streams active {active_during}")
    check(all(r == 0 for r in refs) and end["published"] == 0
          and all(b["free"] == TENANCY_SLOTS and b["live"] == 0
                  and b["parked"] == 0 for b in end["buckets"].values()),
          f"17c: at the end refcounts {refs}, pool {end}")
    return {"evictions": evictions, "held_rows_kept": kept,
            "misses": end["misses"], "hits": end["hits"],
            "publishes": end["publishes"], "retires": end["retires"],
            "step_p50_ms": st["step_p50_ms"], "launches": launches}


def tenancy_quota_tiers(torch, mt, ck, dev_params):
    """(d) One decode seat and a quota of two 64 + 32-token requests: a
    tenant's third request is shed with ``QuotaExceededError`` (the
    per-tenant counters equal the submissions), another tenant's goes
    through; an interactive request is admitted before two batch ones
    submitted ahead of it."""
    V = GPT2_SMALL["vocab_size"]
    rng = np.random.RandomState(26)
    prompt = rng.randint(1, V, size=QUOTA_PROMPT).astype(np.int32)
    need = QUOTA_PROMPT + TENANCY_NEW
    order, lock = [], threading.Lock()

    def done(name):
        def cb(_f):
            with lock:
                order.append(name)
        return cb

    with counted_engine(torch, mt, ck, dev_params, max_streams=1,
                        decode_buckets=[1],
                        tenant_quota=mt.TenantQuota(2 * need + 10)) as eng:
        for _ in range(2):
            eng.generate(prompt, TENANCY_NEW, tenant="q")
        try:
            eng.submit(prompt, TENANCY_NEW, tenant="q")
            shed = None
        except mt.QuotaExceededError as e:
            shed = (e.reason, e.tenant, e.needed)
        eng.generate(prompt, TENANCY_NEW, tenant="r")
        st = eng.stats()
        f0 = eng.submit(prompt, 64)  # holds the one seat
        time.sleep(0.05)
        futs = [(eng.submit(prompt, 2, slo_class=c), n) for c, n in (
            ("batch", "batch1"), ("batch", "batch2"),
            ("interactive", "interactive"))]
        for f, n in futs:
            f.add_done_callback(done(n))
        for f in [f0] + [f for f, _ in futs]:
            f.result(timeout=600)
        launches = dict(ck.LAUNCHES)
    q = st["tenants"]["q"]
    check(shed == ("tenant_quota", "q", need) and st["shed"] == 1
          and st["shed_tenant_quota"] == 1 and q["requests"] == 2
          and q["shed"] == 1 and q["charged"] == 2 * need
          and st["tenants"]["r"]["requests"] == 1,
          f"17d: shed {shed}, tenants {st['tenants']}")
    check(order.index("interactive") < min(order.index("batch1"),
                                           order.index("batch2")),
          f"17d: completion order {order}")
    return {"shed": shed, "tenants": st["tenants"], "tier_order": order,
            "launches": launches}


def draft_params(dev_params, layers):
    """A draft LM made of the target: its embeddings, its first
    ``layers`` blocks, its final LayerNorm and its head."""
    keep = {f"layer{i}_" for i in range(layers)}
    return {k: v for k, v in dev_params.items()
            if not k.startswith("layer") or k[:k.index("_") + 1] in keep}


def tenancy_draft(torch, mt, ck, dev_params):
    """(e) The draft-LM proposer, ``spec_tokens=4`` on ``spec_prompts()``
    (run B's prompts, greedy): drafting with the target's own weights
    and with a 2-layer draft cut from them, fp32 pages (the 2-layer
    draft over int8 pages is left out for the full run's time limit;
    phase 18 (c) serves over int8 pages); the n-gram proposer on the
    same prompts beside them.  Run B's launch rule, B1 also ``layers``
    times a draft forward; the outputs held by ``forward_check``."""
    from mxnet_tpu_torch.speculative import DraftLMProposer

    L, Hh = GPT2_SMALL["num_layers"], GPT2_SMALL["num_heads"]
    prompts = spec_prompts()
    lens = [len(p) for p in prompts]
    # greedy: a sampled stream rejects a greedy draft with the probability
    # the target gives other tokens (run B holds the sampled verify rows)
    temps = [0.0] * 16
    runs = {}
    for label, layers in (("self", L), ("two_layer", 2), ("ngram", None)):
        draft = DraftLMProposer(draft_params(dev_params, layers),
                                num_heads=Hh, kv_block=KVB,
                                ctx=mt.gpu(0)) if layers else "ngram"

        def reset(draft=draft):
            if layers:
                draft.forwards = 0

        model, outs, st, launches, rec = serve_run(
            torch, mt, ck, dev_params, prompts, temps, SPEC_NEW,
            on_reset=reset, spec_tokens=SPEC_K, proposer=draft)
        plain = st["steps"] - st["spec_steps"]
        forwards = draft.forwards if layers else 0
        _expect_launches(launches, {
            "flash_mha_packed": L * st["prefills"] + (layers or 0) * forwards,
            "paged_attention_verify": L * st["spec_steps"],
            "paged_attention_decode": L * plain,
            "paged_attention_verify_quant": 0,
            "paged_attention_decode_quant": 0}, f"17e {label}")
        forward_check(torch, model, prompts, outs, temps, lens,
                      f"17e {label}")
        rec.update(draft_layers=layers, draft_forwards=forwards,
                   accepted_token_rate=st["accepted_token_rate"])
        runs[label] = rec
        del model, draft
        torch.cuda.empty_cache()
    check(runs["self"]["accepted_token_rate"] > 0.9,
          f"17e: the target drafting for itself accepted "
          f"{runs['self']['accepted_token_rate']}")
    return runs


def tenancy_path(torch, mt, ck):
    """Phase 17, multi-tenant serving and the draft-LM proposer at the
    GPT-2-class width (fp32 pages unless said, KVB 16), each run's
    launch counts reset just before its traffic and read just after:
    (a) ``tenancy_mixed``, (b) ``tenancy_salted``, (c) ``tenancy_hot``,
    (d) ``tenancy_quota_tiers``, (e) ``tenancy_draft``.  A
    ``tenancy_summary`` line."""
    t_start = time.perf_counter()
    dev_params = mt.params_from_numpy(gpt2_small_params(0), "cuda")
    ads = tenancy_adapters()
    parts, part_s, launches = {}, {}, {}
    for name, fn in (("a", lambda: tenancy_mixed(torch, mt, ck, dev_params,
                                                 ads)),
                     ("b", lambda: tenancy_salted(torch, mt, ck, dev_params,
                                                  ads)),
                     ("c", lambda: tenancy_hot(torch, mt, ck, dev_params)),
                     ("d", lambda: tenancy_quota_tiers(torch, mt, ck,
                                                       dev_params)),
                     ("e", lambda: tenancy_draft(torch, mt, ck, dev_params))):
        t0 = time.perf_counter()
        parts[name] = fn()
        part_s[name] = time.perf_counter() - t0
        recs = parts[name].values() if name == "e" else [parts[name]]
        for r in recs:
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
    del dev_params
    torch.cuda.empty_cache()
    e = parts["e"]
    summary = {
        "step_p50_ms": parts["a"]["step_p50_ms"],
        "ttft_p50_ms": parts["a"]["ttft_p50_ms"],
        "mixed_tokens_per_s": parts["a"]["tokens_per_s"],
        "plain_streams_bitwise": parts["a"]["plain_streams_bitwise"],
        "greedy_chain_leaves_base_at":
            parts["a"]["greedy_chain_leaves_base_at"],
        "salted_hits_after_each": parts["b"]["hits_after_each"],
        "salted_ttft_hit_p50_ms": parts["b"]["ttft_hit_p50_ms"],
        "hot_evictions": parts["c"]["evictions"],
        "quota_shed": parts["d"]["shed"], "tier_order":
            parts["d"]["tier_order"],
        "draft": {k: {"accepted_token_rate": r["accepted_token_rate"],
                      "tokens_per_s": r["tokens_per_s"],
                      "decode_step_p50_ms": r["decode_step_p50_ms"],
                      "draft_forwards": r["draft_forwards"]}
                  for k, r in e.items()},
        "launches": launches, "part_wall_s": part_s,
        "wall_s": time.perf_counter() - t_start, "card": card_line()}
    print(json.dumps({"tenancy_summary": summary}))
    return {"parts": parts, "launches": launches, "summary": summary}


# ---------------------------------------------------------------------------
# phase 18: the engine's executables as CUDA graphs, warmup(), the pipelined
# fetch and swap_params (queue A item 7, part 3)
# ---------------------------------------------------------------------------

# (e): one greedy prompt alone, through the pipelining engine and one
# held unpipelined (one seat, and an eos id no token equals)
PIPE_PROMPT, PIPE_NEW = 100, 48
# (g): the miss whose host and kernel time is split (phase 16's)
MISS_TOKENS = 712


def graph_pair(label, runs, outs):
    """Graphed against eager: every token of ``outs[0]`` (the graphed
    engine's) equals ``outs[1]``'s, greedy and sampled alike; each
    graphed run captured one graph a bucket it used (every ``compiles``
    count 1, a capture an executable).  → the two runs' serving
    figures."""
    for i, (a, b) in enumerate(zip(*outs)):
        check(np.array_equal(a, b), f"18 {label} stream {i}: graphed tokens "
              f"differ from eager at {np.nonzero(a != b)[0][:5]}")
    g, e = runs
    check(g["graphs"]["graphs_on"] and not e["graphs"]["graphs_on"]
          and g["graphs"]["captures"] == g["graphs"]["executables"]
          == g["compiles"] > 0,
          f"18 {label}: graphs {g['graphs']}, {g['compiles']} compiles")
    keys = ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
            "decode_step_p50_ms", "prefills", "steps", "d2h_syncs_saved")
    return {"graphed": {k: g.get(k) for k in keys + ("graphs",)},
            "eager": {k: e.get(k) for k in keys},
            "streams_equal": len(outs[0])}


def graphs_serving(torch, mt, ck, dev_params, tally):
    """(a)-(d): run A's traffic (fp32 pages), run B's (``spec_tokens=4``,
    the verify executables), run A's over int8 pages, and phase 17 (a)'s
    mixed adapter batch, each through a graphed engine and one with
    ``_graphs=False`` (the same executables uncaptured): tokens equal.
    (a) and (b) build every bucket first (``warmup()``, checked by
    ``warmup_matrix``; (b)'s with the verify buckets) and (d) warms the
    traffic's shapes, so no capture falls inside their timed traffic;
    (c) captures each bucket at its first use inside it (its graphed
    TTFT holds those captures).  The graphed runs of (b) and (c) are
    device traces: B1 12 a prefill, the paged kernel 12 a step (verify
    and decode) in the trace."""
    L = GPT2_SMALL["num_layers"]
    rng = np.random.RandomState(1)
    lens = rng.randint(32, 901, size=16)
    prompts = [rng.randint(1, GPT2_SMALL["vocab_size"], size=n)
               .astype(np.int32) for n in lens]
    temps = [0.8 if i in (3, 11) else 0.0 for i in range(16)]
    spec = spec_prompts()
    stemps = [0.8 if i in (5, 12) else 0.0 for i in range(16)]
    out = {}
    for part, pr, tp, new, kw, trace in (
            ("a", prompts, temps, 32, {}, None),
            ("b", spec, stemps, SPEC_NEW,
             dict(spec_tokens=SPEC_K, proposer="ngram"), "18b graphed"),
            ("c", prompts, temps, 32, dict(kv_dtype="int8"),
             "18c graphed")):
        recs, outs = [], []
        for graphs in (True, False):
            model, o, st, launches, rec = serve_run(
                torch, mt, ck, dev_params, pr, tp, new, warm=part != "c",
                trace=trace if graphs else None, _graphs=graphs, **kw)
            tally(launches)
            if graphs and trace is not None:
                check(launches["flash_mha_packed"] == L * st["prefills"]
                      and launches["paged_attention"] == L * st["steps"]
                      and launches["paged_attention_verify"]
                      + launches["paged_attention_verify_quant"]
                      == L * st["spec_steps"] > (0 if part == "b" else -1),
                      f"18{part}: traced launches {launches} for "
                      f"{st['prefills']} prefills, {st['steps']} steps "
                      f"({st['spec_steps']} verify)")
            if graphs and "warmup" in rec:
                rec["warmup_matrix"] = warmup_matrix(part, rec)
            recs.append(rec)
            outs.append(o)
            del model
            torch.cuda.empty_cache()
        out[part] = graph_pair(part, recs, outs)
        out[part]["warmup"] = recs[0].get("warmup_matrix")
    ads = tenancy_adapters()
    traffic = tenant_traffic()
    runs = []
    for graphs in (True, False):
        o, st, launches, wall, model = tenant_run(
            torch, mt, ck, dev_params, traffic, adapters=True, ads=ads,
            _graphs=graphs)
        tally(launches)
        del model
        runs.append((o, {"graphs": st["graphs"],
                         "compiles": len(st["compiles"]),
                         "tokens_per_s": sum(len(x) for x in o) / wall,
                         "ttft_p50_ms": st["ttft_p50_ms"],
                         "ttft_p99_ms": st["ttft_p99_ms"],
                         "decode_step_p50_ms": st["step_p50_ms"],
                         "prefills": st["prefills"], "steps": st["steps"],
                         "d2h_syncs_saved": st["d2h_syncs_saved"]}))
        if graphs:
            check(any("lora" in k for k in st["compiles"]),
                  f"18d: no executable ran an adapter bucket: "
                  f"{sorted(st['compiles'])}")
    out["d"] = graph_pair("d", [r for _, r in runs], [o for o, _ in runs])
    torch.cuda.empty_cache()
    return out


def warmup_matrix(label, rec):
    """(f): the ``warmup()`` of a run made with ``serve_run(warm=True)``
    built every prefill bucket, every (bb, mb) decode bucket (and verify
    bucket when speculating) and every (tp, mb) suffix-prefill bucket
    whose table holds the suffix (the prefix cache is on), each captured
    once: the JAX engine's keys; the traffic after it built none."""
    w = rec["warmup"]
    want = {("prefill", tp) for tp in w["prefill_buckets"]}
    for bb in w["decode_buckets"]:
        for mb in w["cache_buckets"]:
            want.add(("decode", bb, mb))
            if w["spec_tokens"]:
                want.add(("verify", bb, mb, w["spec_tokens"] + 1))
    if w["prefix_cache"]:  # the suffix prefill's (tp, mb) pairs
        want |= {("prefix_prefill", tp, mb) for tp in w["prefill_buckets"]
                 for mb in w["cache_buckets"] if mb * KVB >= tp}
    want = {str(k): 1 for k in want}
    check(w["compiles"] == want == w["compiles_after_traffic"]
          and w["graphs"]["captures"] == len(want),
          f"18 {label}: warmup() built {w['compiles']} "
          f"({w['graphs']['captures']} captures), the traffic after it "
          f"{set(w['compiles_after_traffic']) - set(want)}; want {want}")
    return {"executables": len(want), "wall_s": w["wall_s"],
            "captures": w["graphs"]["captures"],
            "capture_ms": w["graphs"]["capture_ms"],
            "pool_bytes": w["graphs"]["pool_bytes"]}


def graphs_pipeline(torch, mt, dev_params):
    """(e): one greedy prompt alone saves device-to-host syncs (the
    pipelined fetch), with tokens equal to an engine that cannot pipeline
    (one seat and an eos id no token equals)."""
    prompt = np.random.RandomState(31).randint(
        1, GPT2_SMALL["vocab_size"], PIPE_PROMPT).astype(np.int32)
    res = []
    for kw in ({}, dict(max_streams=1, decode_buckets=[1], eos_id=-1)):
        with mt.DecodeEngine(dev_params, **{"kv_block": KVB,
                                            "max_streams": 16, "seed": 0,
                                            **GPT2_SMALL, **kw},
                             ctx=mt.gpu(0)) as eng:
            out = eng.generate(prompt, PIPE_NEW)
            res.append((out, eng.stats()))
    (a, st), (b, st0) = res
    check(np.array_equal(a, b) and st["d2h_syncs_saved"] > 0
          and st0["d2h_syncs_saved"] == 0
          and st["d2h_syncs"] == st["prefills"] + st["steps"],
          f"18e: pipelined {a[:8]} / saved {st['d2h_syncs_saved']} "
          f"({st['d2h_syncs']} syncs) against {b[:8]} / saved "
          f"{st0['d2h_syncs_saved']}")
    return {"d2h_syncs": st["d2h_syncs"],
            "d2h_syncs_saved": st["d2h_syncs_saved"],
            "steps": st["steps"], "step_p50_ms": st["step_p50_ms"],
            "unpipelined_step_p50_ms": st0["step_p50_ms"]}


def graphs_swap(torch, mt, dev_params):
    """(h): ``swap_params`` while requests decode: the same weights leave
    every chain and ``compiles`` as they were; other weights
    (``gpt2_small_params(1)``) make the next requests' greedy chains those
    of a fresh engine over them; a swap missing a name or of a wrong shape
    raises and installs nothing.  The prefix cache is on: a swap drops
    its chains (their pages hold the old weights' K/V), so the prompts
    served again after it miss and follow the new weights."""
    prompts = spec_prompts(seed=8)[:4]
    kw = dict(**GPT2_SMALL, ctx=mt.gpu(0), kv_block=KVB, max_streams=16,
              seed=0)
    host0, host1 = gpt2_small_params(0), gpt2_small_params(1)
    with mt.DecodeEngine(host1, **kw) as eng:
        want1 = [f.result(timeout=600)
                 for f in [eng.submit(p, 24) for p in prompts]]
    with mt.DecodeEngine(dev_params, **kw) as eng:
        want0 = [f.result(timeout=600)
                 for f in [eng.submit(p, 24) for p in prompts]]
        # the same prompts again hit the prefix cache: their
        # suffix-prefill executables are built here, before the snapshot
        hits = eng.stats()["prefix_hits"]
        warm = [f.result(timeout=600)
                for f in [eng.submit(p, 24) for p in prompts]]
        check(all(np.array_equal(a, b) for a, b in zip(warm, want0))
              and eng.stats()["prefix_hits"] > hits
              and any(k[0] == "prefix_prefill" for k in eng.compiles),
              "18h: the prompts served again did not hit the prefix "
              "cache, or a hit's chain differs from the miss's")
        before = dict(eng.compiles)
        futs = [eng.submit(p, 24) for p in prompts]
        eng.swap_params(host0)  # mid-serve, between two steps
        same = [f.result(timeout=600) for f in futs]
        check(all(np.array_equal(a, b) for a, b in zip(same, want0))
              and dict(eng.compiles) == before,
              "18h: an identity swap changed a chain or built an "
              "executable")
        name = "layer0_qkv_weight"
        for bad, what in (({name: host1[name]}, "missing"),
                          ({**host1, name: np.zeros((3, 3), np.float32)},
                           "shape")):
            try:
                eng.swap_params(bad)
            except mt.MXNetError as exc:
                check(what in str(exc), f"18h: {exc}")
            else:
                check(False, f"18h: a swap with a {what} param installed")
        again = [f.result(timeout=600)
                 for f in [eng.submit(p, 24) for p in prompts]]
        check(all(np.array_equal(a, b) for a, b in zip(again, want0)),
              "18h: a failed swap changed the served weights")
        t0 = time.perf_counter()
        eng.swap_params(host1)
        swap_ms = (time.perf_counter() - t0) * 1e3
        got = [f.result(timeout=600)
               for f in [eng.submit(p, 24) for p in prompts]]
        check(all(np.array_equal(a, b) for a, b in zip(got, want1))
              and dict(eng.compiles) == before,
              "18h: after swap_params the chains are not the new "
              "weights' (a prefix hit over the old weights' pages, or an "
              "executable was built)")
        snap = eng.get_params()
        check(all(np.array_equal(snap[n], host1[n]) for n in host1),
              "18h: get_params is not the swapped-in weights")
    return {"swap_ms": swap_ms, "executables": len(before),
            "new_chains_differ": sum(not np.array_equal(a, b)
                                     for a, b in zip(want0, want1))}


def graphs_miss(torch, mt, dev_params):
    """(g): a 712-token miss (prefix cache off, so each call misses),
    served to its first token graphed and eager: host ms of
    ``generate(prompt, 1)`` (median of 5 after 2) beside the device's
    (``step_device_ms``: kernels and the CUDA-event span)."""
    prompt = np.random.RandomState(32).randint(
        1, GPT2_SMALL["vocab_size"], MISS_TOKENS).astype(np.int32)
    out = {}
    for graphs in (True, False):
        with mt.DecodeEngine(dev_params, **GPT2_SMALL, ctx=mt.gpu(0),
                             kv_block=KVB, max_streams=16, seed=0,
                             prefix_cache=0, _graphs=graphs) as eng:
            host = []
            for _ in range(7):
                t = time.perf_counter()
                eng.generate(prompt, 1)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t) * 1e3)
            out["graphed" if graphs else "eager"] = {
                "host_ms": float(np.median(host[2:])),
                **step_device_ms(torch, lambda: eng.generate(prompt, 1))}
    return out


def graphs_path(torch, mt, ck):
    """Phase 18 at the GPT-2-class width, KVB 16: ``DecodeEngine``'s
    executables as CUDA graphs (``graphs_serving``: (a) run A, (b) run
    B, (c) int8 pages, (d) the mixed adapter batch, each graphed against
    ``_graphs=False``; (f) the ``warmup()`` of (a)'s graphed engine:
    ``warmup_matrix``), (e) the pipelined fetch (``graphs_pipeline``),
    (g) a miss's host and kernel ms (``graphs_miss``), (h)
    ``swap_params`` (``graphs_swap``).  A ``graphs_summary`` line."""
    t_start = time.perf_counter()
    dev_params = mt.params_from_numpy(gpt2_small_params(0), "cuda")
    counts = Launches(torch, ck)
    wall, parts = {}, {}
    for name, fn in (
            ("serving", lambda: graphs_serving(torch, mt, ck, dev_params,
                                               counts.add)),
            ("pipeline", lambda: graphs_pipeline(torch, mt, dev_params)),
            ("miss", lambda: graphs_miss(torch, mt, dev_params)),
            ("swap", lambda: graphs_swap(torch, mt, dev_params))):
        t0 = time.perf_counter()
        parts[name] = fn()
        wall[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    del dev_params
    torch.cuda.empty_cache()
    summary = {**parts, "part_wall_s": wall,
               "wall_s": time.perf_counter() - t_start, "card": card_line()}
    print(json.dumps({"graphs_summary": summary}))
    return {"parts": parts, "launches": counts.total, "summary": summary}


# ---------------------------------------------------------------------------
# phase 19: B8's key limit, the serving symbols, the graphed suffix prefill
# and InferenceEngine
# ---------------------------------------------------------------------------

# the serving symbols' chain (one stream each): a prompt of INFER_PROMPT
# tokens (bucket 256), INFER_STEPS decode steps, a verify window of
# SPEC_K + 1; a second stream of 256 cached tokens and a 64-token suffix
INFER_PROMPT, INFER_STEPS, INFER_SUFFIX = 200, 16, (256, 64)
INFER_P, INFER_MB = 64, 32
# the graphed suffix prefill: 200 new tokens over the 512-token system
# prompt, INFER_PROBES distinct probes (2 warm, 5 timed)
INFER_PROBES = 7
# InferenceEngine on ResNet-50 (BASELINE config 2's scoring): buckets,
# client threads, requests of 1-4 images; on the packed LM: buckets, T
INFER_BUCKETS, INFER_CLIENTS, INFER_REQUESTS = (1, 4, 16, 32), 8, 256
INFER_LM_BUCKETS, INFER_LM_T, INFER_LM_REQUESTS = (1, 4, 8), 128, 24
# a request's row against Module.predict's: cuDNN picks its deterministic
# algorithms per batch size, so the rows of one image at two batch sizes
# differ in float32's rounding
INFER_TOL = dict(rtol=1e-4, atol=1e-6)
# the LM's rows are probabilities over 32,768 tokens (about 3e-5 each):
# the same relative tolerance, an absolute floor far below that
INFER_LM_TOL = dict(rtol=1e-4, atol=1e-7)


def infer_symbols(torch, mt, ck, dev_params, kv):
    """(b): the serving symbols at the GPT-2-class width, bound with
    ``simple_bind`` (sharing weights and pools through ``shared_exec``)
    over ``kv`` pools ("fp32" or "int8"): stream A's prefill of 200
    tokens, 16 decode steps and a verify window of 5; stream B's prefill
    of 256 and its 64-token suffix prefill (start 256); over fp32 pools
    also the contiguous-cache decode (``paged=False``: the prefill's K/V
    in (1, 256, H, D) caches, 16 steps on B8 with ``kv_len = lengths``).
    The symbols run as one ``TracedLaunches`` region (B1 12 a prefill,
    the paged kernel 12 a step, B8 24 a suffix prefill and 12 a
    contiguous step), then ``TransformerLM``'s same calls over the same
    pools' bytes: every logits row within ``TOL`` (the contiguous decode
    against the paged decode's rows within 1e-3: another kernel)."""
    import importlib

    tf = importlib.import_module("mxnet_tpu_torch.models.transformer")
    L, V = GPT2_SMALL["num_layers"], GPT2_SMALL["vocab_size"]
    dm = GPT2_SMALL["d_model"]
    quant = kv == "int8"
    rng = np.random.RandomState(19)
    kw = dict(num_layers=L, num_heads=H, d_model=dm,
              d_ff=GPT2_SMALL["d_ff"], kv_block=KVB, kv_dtype=kv)
    pool_names = [f"layer{i}_{n}" for i in range(L)
                  for n in ("kpool", "vpool", "kscale", "vscale")[
                      :4 if quant else 2]]
    ints = ("data", "positions", "lengths", "block_table", "start")
    common = {"pos_embed_weight": (GPT2_SMALL["max_len"], dm),
              "block_table": (1, INFER_MB), "lengths": (1,)}
    for n in pool_names:
        common[n] = (INFER_P, KVB, H) if "scale" in n \
            else (INFER_P, KVB, H, D)

    used = set()  # the op names of every symbol bound here

    def bind(fn, shared=None, **shapes):
        sym = getattr(tf, fn)(V, **kw)
        used.update(symbol_ops(sym))
        types = {n: ("int32" if n in ints else "int8" if quant
                     and "pool" in n else "float32")
                 for n in sym.list_arguments()}
        ex = sym.simple_bind(mt.gpu(0), grad_req="null", type_dict=types,
                             shared_exec=shared, **common, **shapes)
        if shared is None:
            ex.copy_params_from({k: v for k, v in dev_params.items()
                                 if k in ex.arg_dict})
        return ex

    pre = bind("transformer_lm_prefill", data=(1, 256), positions=(1, 256))
    dec = bind("transformer_lm_decode", pre, data=(1, 1), positions=(1, 1))
    ver = bind("transformer_lm_verify", pre, data=(1, SPEC_K + 1),
               positions=(1, SPEC_K + 1), start=(1,))
    suf = bind("transformer_lm_prefix_prefill", pre,
               data=(1, INFER_SUFFIX[1]), positions=(1, INFER_SUFFIX[1]),
               start=(1,))
    pools = [pre.arg_dict[n]._data for n in pool_names]
    check(all(dec.arg_dict[n]._data is p and suf.arg_dict[n]._data is p
              for n, p in zip(pool_names, pools)),
          f"19b {kv}: the symbols' executors do not share the pools")
    for n, p in zip(pool_names, pools):  # stale bytes the masks keep out
        if "scale" in n:
            p.copy_(torch.rand(p.shape, device="cuda") + 0.5)
        elif quant:
            p.copy_(torch.randint(-100, 100, p.shape, device="cuda"))
        else:
            p.normal_()
    ref_pools = [p.clone() for p in pools]
    tables = np.zeros((2, INFER_MB), np.int32)
    tables[0, :14] = np.arange(1, 15)
    tables[1, :20] = np.arange(15, 35)
    a_prompt = rng.randint(1, V, INFER_PROMPT).astype(np.int32)
    b_prompt = rng.randint(1, V, sum(INFER_SUFFIX)).astype(np.int32)
    steps = rng.randint(1, V, INFER_STEPS + SPEC_K + 1).astype(np.int32)
    calls = []  # (executor, method, feeds, real rows)
    tp = np.zeros((1, 256), np.int32)
    tp[0, :INFER_PROMPT] = a_prompt
    calls.append((pre, "prefill", dict(
        data=tp, positions=np.arange(256, dtype=np.int32)[None],
        lengths=[INFER_PROMPT], block_table=tables[:1]), INFER_PROMPT))
    for i in range(INFER_STEPS):
        pos = INFER_PROMPT + i
        calls.append((dec, "decode", dict(
            data=[[steps[i]]], positions=[[pos]], lengths=[pos + 1],
            block_table=tables[:1]), 1))
    start = INFER_PROMPT + INFER_STEPS
    W = SPEC_K + 1
    calls.append((ver, "verify", dict(
        data=steps[None, INFER_STEPS:], positions=start + np.arange(
            W, dtype=np.int32)[None], start=[start], lengths=[start + W],
        block_table=tables[:1]), W))
    cached, ns = INFER_SUFFIX
    calls.append((pre, "prefill", dict(
        data=b_prompt[None, :cached], positions=np.arange(
            cached, dtype=np.int32)[None], lengths=[cached],
        block_table=tables[1:]), cached))
    calls.append((suf, "suffix_prefill", dict(
        data=b_prompt[None, cached:], positions=cached + np.arange(
            ns, dtype=np.int32)[None], start=[cached],
        lengths=[cached + ns], block_table=tables[1:]), ns))

    def feeds_of(f):
        return {k: torch.tensor(np.asarray(v, np.int32), device="cuda")
                for k, v in f.items()}

    got = []
    with TracedLaunches(torch, ck, f"19b {kv} symbols") as tr:
        for ex, _, f, real in calls:
            outs = ex.forward(**feeds_of(f))
            got.append(outs[0]._data[0, :real].clone())
        cont = []
        if not quant:
            csym = tf.transformer_lm_prefill(V, paged=False, **kw)
            used.update(symbol_ops(csym))
            cex = csym.simple_bind(
                mt.gpu(0), grad_req="null", shared_exec=pre,
                type_dict={n: "int32" if n in ints else "float32"
                           for n in csym.list_arguments()},
                data=(1, 256), positions=(1, 256),
                pos_embed_weight=(GPT2_SMALL["max_len"], dm))
            outs = cex.forward(**feeds_of({k: v for k, v in calls[0][2]
                                           .items()
                                           if k in ("data", "positions")}))
            caches = [o._data.clone() for o in outs[1:]]
            dsym = tf.transformer_lm_decode(V, paged=False, **kw)
            used.update(symbol_ops(dsym))
            cnames = [f"layer{i}_{n}" for i in range(L)
                      for n in ("kcache", "vcache")]
            dex = dsym.simple_bind(
                mt.gpu(0), grad_req="null", shared_exec=pre,
                type_dict={n: "int32" if n in ints else "float32"
                           for n in dsym.list_arguments()},
                data=(1, 1), positions=(1, 1), lengths=(1,),
                pos_embed_weight=(GPT2_SMALL["max_len"], dm),
                **{n: (1, 256, H, D) for n in cnames})
            for n, c in zip(cnames, caches):
                dex.arg_dict[n]._data.copy_(c)
            for _, _, f, _ in calls[1:1 + INFER_STEPS]:
                outs = dex.forward(**feeds_of({k: v for k, v in f.items()
                                               if k != "block_table"}))
                cont.append(outs[0]._data[0].clone())
            del cex, dex, caches
    launches = tr.launches
    n_pre, n_dec = 2 + (0 if quant else 1), INFER_STEPS
    q = "_quant" if quant else ""
    want = {"flash_mha_packed": L * n_pre, "paged_attention": L * (n_dec + 1),
            f"paged_attention_decode{q}": L * n_dec,
            f"paged_attention_verify{q}": L,
            "flash_attention_partial": 2 * L + (0 if quant else L * n_dec)}
    off = {k: (launches.get(k, 0), n) for k, n in want.items()
           if launches.get(k, 0) != n}
    check(not off, f"19b {kv}: (traced, wanted) launches {off}")
    model = tf.TransformerLM(dev_params, num_layers=L, num_heads=H,
                             kv_block=KVB)
    errs = []
    for (_, method, f, real), row in zip(calls, got):
        t = feeds_of(f)
        args = [t["data"], t["positions"]] + (
            [t["start"]] if "start" in t else []) + [t["lengths"],
                                                      t["block_table"]]
        want_row = getattr(model, method)(*args, ref_pools)[0, :real]
        errs.append((want_row - row).abs().max().item())
    err = max(errs)
    check(err <= TOL["float32"], f"19b {kv}: the symbols' logits are "
          f"{err} from TransformerLM's (tolerance {TOL['float32']})")
    rec = {"kv": kv, "calls": len(calls), "max_abs_err": err,
           "tol": TOL["float32"], "launches": launches,
           "ops": sorted(used)}
    if cont:
        paged_rows = got[1:1 + INFER_STEPS]
        cerr = max((a - b[0]).abs().max().item()
                   for a, b in zip(cont, paged_rows))
        check(cerr <= 1e-3, f"19b: the contiguous decode's logits are "
              f"{cerr} from the paged decode's")
        rec["contiguous_decode_max_abs_err"] = cerr
    del pre, dec, ver, suf, pools, ref_pools, model
    torch.cuda.empty_cache()
    return rec


def infer_suffix_graphs(torch, mt, ck, dev_params):
    """(c): phase 16's (a) traffic (a 512-token system prompt, 15 hits)
    and (d) traffic (chunked prefill beside decoding streams) through a
    graphed engine and one with ``_graphs=False``: tokens equal, every
    executable (the ``("prefix_prefill", tp, mb)`` ones among them)
    captured once; then a 200-token suffix over the cached system prompt
    served to its first token, graphed and eager (``INFER_PROBES``
    distinct probes, host ms median of the last 5, device ms by
    ``step_device_ms`` on a fresh probe each call)."""
    traffic = shared_prompt_traffic()
    prefix, first, prompts, temps = traffic
    out, outs = {}, {}
    for graphs in (True, False):
        run = shared_prompt_run(torch, mt, ck, dev_params, traffic,
                                "19c", _graphs=graphs)
        st = run["st"]
        outs[graphs] = run["outs"]
        out["graphed" if graphs else "eager"] = {
            k: st[k] for k in ("ttft_hit_p50_ms", "ttft_miss_p50_ms",
                               "ttft_p50_ms", "prefill_p50_ms",
                               "step_p50_ms", "prefix_hits")}
        out["graphed" if graphs else "eager"]["graphs"] = st["graphs"]
        pfx = [k for k in st["compiles"] if "prefix_prefill" in k]
        if graphs:
            check(pfx and st["graphs"]["captures"]
                  == st["graphs"]["executables"] == len(st["compiles"]),
                  f"19c: graphs {st['graphs']}, compiles {st['compiles']}")
            out["prefix_prefill_executables"] = len(pfx)
        del run
        torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(outs[True], outs[False])):
        check(np.array_equal(a, b), f"19c stream {i}: graphed tokens differ "
              f"from eager at {np.nonzero(a != b)[0][:5]}")
    ctraffic = chunk_traffic()
    couts = {}
    for graphs in (True, False):
        o, st, _, model, _ = chunk_run(
            torch, mt, ck, dev_params, ctraffic, prefill_chunk=CHUNK,
            prefill_buckets=CHUNK_BUCKETS, _graphs=graphs)
        couts[graphs] = o
        del model
    for i, (a, b) in enumerate(zip(couts[True], couts[False])):
        check(np.array_equal(a, b), f"19c chunked stream {i}: graphed "
              f"tokens differ from eager")
    out["streams_equal"] = len(outs[True]) + len(couts[True])
    rng = np.random.RandomState(33)
    V = GPT2_SMALL["vocab_size"]
    for graphs in (True, False):
        with mt.DecodeEngine(dev_params, **GPT2_SMALL, ctx=mt.gpu(0),
                             kv_block=KVB, max_streams=16, seed=0,
                             _graphs=graphs) as eng:
            eng.generate(prefix, 1)  # the system prompt, cached
            probes = iter([np.concatenate([prefix, rng.randint(
                1, V, size=200)]).astype(np.int32) for _ in range(
                    INFER_PROBES + 12)])
            host = []
            for _ in range(INFER_PROBES):
                t = time.perf_counter()
                eng.generate(next(probes), 1)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t) * 1e3)
            st = eng.stats()
            out["graphed" if graphs else "eager"]["suffix_200_over_512"] = {
                "host_ms": float(np.median(host[2:])),
                **step_device_ms(torch, lambda: eng.generate(next(probes),
                                                             1), reps=3)}
            check(st["prefix_hits"] >= INFER_PROBES,
                  f"19c: the probes scored {st['prefix_hits']} hits")
    return out


def resnet_checkpoint(torch, mt, root):
    """ResNet-50 bound as phase 10 binds it (batch 32, training), seeded
    Xavier weights, saved by ``Module.save_checkpoint`` under ``root``:
    the prefix."""
    mod = image_bind(mt, resnet50(mt), mt.gpu(0), IMAGE["batch"])
    mt.random.seed(0)
    mod.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    prefix = os.path.join(root, "resnet50")
    mod.save_checkpoint(prefix, 0)
    del mod
    torch.cuda.empty_cache()
    return prefix


def engine_traffic(eng, requests, clients):
    """``requests`` (input dicts) submitted by ``clients`` closed-loop
    threads, request i by thread i % clients: (outputs by request, wall
    s)."""
    got = [None] * len(requests)

    def client(c):
        for i in range(c, len(requests), clients):
            got[i] = eng.submit(requests[i]).result(timeout=600)[0]

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    check(not any(t.is_alive() for t in threads), "19: a client hung")
    return got, time.perf_counter() - t0


def engine_record(st, wall, images):
    return {"images_per_s": images / wall, "wall_s": wall,
            "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
            "batch_fill_ratio": st["batch_fill_ratio"],
            "batches": st["batches"],
            "flushes": {r: st[f"flush_{r}"] for r in ("full", "timeout",
                                                      "boundary")},
            "compiles": st["compiles"], "graphs": st["graphs"]}


def infer_resnet(torch, mt, ck, root):
    """(d): ``InferenceEngine`` on ResNet-50 (fp32, TF32 off) from
    ``Predictor.from_checkpoint`` of the files ``resnet_checkpoint``
    wrote, buckets ``INFER_BUCKETS``, prewarmed: ``INFER_CLIENTS``
    threads submit ``INFER_REQUESTS`` requests of 1-4 seeded images;
    every row against ``Module.predict`` on the same images within
    ``INFER_TOL``; each bucket's executable graphed against
    ``_graphs=False`` on the same padded batch, bit for bit; one capture
    a bucket."""
    prefix = resnet_checkpoint(torch, mt, root)
    shape = IMAGE["image_shape"]
    rng = np.random.RandomState(19)
    sizes = rng.randint(1, 5, size=INFER_REQUESTS)
    images = rng.rand(int(sizes.sum()), *shape).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    reqs = [{"data": images[a:b], "softmax_label": np.zeros(b - a,
                                                            np.float32)}
            for a, b in zip(offs[:-1], offs[1:])]
    pred = mt.Predictor.from_checkpoint(
        prefix, 0, {"data": (1,) + shape, "softmax_label": (1,)},
        ctx=mt.gpu(0))
    recs, same = {}, None
    for graphs in (True, False):
        with mt.InferenceEngine(pred, buckets=INFER_BUCKETS, prewarm=True,
                                _graphs=graphs) as eng:
            eng.submit(reqs[0]).result(timeout=600)  # the threads' warm-up
            eng._metrics.reset()
            got, wall = engine_traffic(eng, reqs, INFER_CLIENTS)
            st = eng.stats()
            recs["graphed" if graphs else "eager"] = engine_record(
                st, wall, len(images))
            bucket_rows = []
            for b in INFER_BUCKETS:
                exe = eng._bucket_exe(b)
                exe.feed(data=images[:b], softmax_label=np.zeros(
                    b, np.float32))
                bucket_rows.append(exe.run()[0].clone())
            if graphs:
                check(st["graphs"]["captures"] == st["graphs"]["executables"]
                      == len(INFER_BUCKETS) and set(st["compiles"]
                                                    .values()) == {1},
                      f"19d: {st['graphs']}, compiles {st['compiles']}")
                same, served = bucket_rows, got
            else:
                check(all(torch.equal(a, b) for a, b in zip(same,
                                                            bucket_rows)),
                      "19d: a graphed bucket differs from the eager one")
    mod = image_bind(mt, resnet50(mt), mt.gpu(0), IMAGE["batch"],
                     for_training=False)
    _, arg, aux = mt.model.load_checkpoint(prefix, 0)
    mod.set_params(arg, aux)
    it = mt.io.NDArrayIter(images, np.zeros(len(images), np.float32),
                           batch_size=IMAGE["batch"])
    want = mod.predict(it).asnumpy()
    err = max(float(np.abs(g - want[a:b]).max())
              for g, a, b in zip(served, offs[:-1], offs[1:]))
    ok = all(np.allclose(g, want[a:b], **INFER_TOL)
             for g, a, b in zip(served, offs[:-1], offs[1:]))
    check(ok, f"19d: the engine's rows are {err} from Module.predict's")
    del mod, pred
    torch.cuda.empty_cache()
    return {"requests": INFER_REQUESTS, "images": len(images),
            "max_abs_err_vs_predict": err, **recs}


def infer_lm(torch, mt, ck, dev_params):
    """(e): ``InferenceEngine`` on the packed ``transformer_lm`` at the
    GPT-2-class width scoring T = 128 sequences (buckets
    ``INFER_LM_BUCKETS``, prewarmed, 4 client threads of 1-2 seeded
    sequences): a ``TracedLaunches`` region whose replays must launch B1
    12 times a batch; the rows against ``Module.predict`` within
    ``INFER_LM_TOL``."""
    cfg = GPT2_SMALL
    L, T, V = cfg["num_layers"], INFER_LM_T, cfg["vocab_size"]
    sym = mt.models.transformer_lm(V, T, num_layers=L, num_heads=H,
                                   d_model=cfg["d_model"], d_ff=cfg["d_ff"])
    params = {k: (v[:T] if k == "pos_embed_weight" else v)
              for k, v in dev_params.items()}
    pred = mt.Predictor(sym, params, {"data": (1, T),
                                      "softmax_label": (1, T)},
                        ctx=mt.gpu(0))
    rng = np.random.RandomState(20)
    sizes = rng.randint(1, 3, size=INFER_LM_REQUESTS)
    seqs = rng.randint(1, V, size=(int(sizes.sum()), T)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    reqs = [{"data": seqs[a:b], "softmax_label": np.zeros((b - a, T),
                                                          np.float32)}
            for a, b in zip(offs[:-1], offs[1:])]
    with mt.InferenceEngine(pred, buckets=INFER_LM_BUCKETS,
                            prewarm=True) as eng:
        eng.submit(reqs[0]).result(timeout=600)
        eng._metrics.reset()
        with TracedLaunches(torch, ck, "19e LM engine") as tr:
            got, wall = engine_traffic(eng, reqs, 4)
        st = eng.stats()
    check(tr.launches["flash_mha_packed"] == L * st["batches"] > 0,
          f"19e: B1 launched {tr.launches['flash_mha_packed']} times for "
          f"{st['batches']} batches")
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (max(INFER_LM_BUCKETS), T))],
             label_shapes=[("softmax_label", (max(INFER_LM_BUCKETS), T))],
             for_training=False)
    mod.set_params({k: mt.nd.NDArray(v, mt.gpu(0)) for k, v in
                    params.items()}, {})
    it = mt.io.NDArrayIter(seqs, np.zeros((len(seqs), T), np.float32),
                           batch_size=max(INFER_LM_BUCKETS))
    want = mod.predict(it).asnumpy()
    pairs = [(g, want[a:b]) for g, a, b in zip(got, offs[:-1], offs[1:])]
    err = max(float(np.abs(g - w).max()) for g, w in pairs)
    rel = max(float((np.abs(g - w) / np.maximum(np.abs(w), 1e-30)).max())
              for g, w in pairs)
    check(all(np.allclose(g, w, **INFER_LM_TOL) for g, w in pairs),
          f"19e: the engine's rows are {err} ({rel} relative) from "
          f"Module.predict's (tolerance {INFER_LM_TOL})")
    del mod, pred
    torch.cuda.empty_cache()
    return {"requests": len(reqs), "sequences": len(seqs),
            "max_abs_err_vs_predict": err,
            "max_rel_err_vs_predict": rel, "tol": INFER_LM_TOL,
            "launches": tr.launches,
            **engine_record(st, wall, len(seqs))}


def infer_path(torch, mt, ck, tatt, F):
    """Phase 19 (``--infer``): (a) B8's per-row key limit against its
    plain version (``limit_checks``: fp32, bf16, fp16; the suffix shapes,
    a decode row, the edges); (b) the serving symbols over fp32 and int8
    pools (``infer_symbols``); (c) the suffix prefill as graphed
    executables (``infer_suffix_graphs``); (d) ``InferenceEngine`` on
    ResNet-50 (``infer_resnet``) and (e) on the packed LM
    (``infer_lm``).  The launch counts are reset just before each part
    and read just after.  An ``infer_summary`` line."""
    import tempfile

    t_start = time.perf_counter()
    wall = {}
    t0 = time.perf_counter()
    kernels = limit_checks(torch, ck, tatt, F)
    for c in kernels:
        print(json.dumps({"check": c}))
    wall["limit_checks"] = time.perf_counter() - t0
    dev_params = mt.params_from_numpy(gpt2_small_params(0), "cuda")
    counts = Launches(torch, ck)
    parts = {}
    t0 = time.perf_counter()
    for kv in ("fp32", "int8"):
        ck.reset_launch_counts()
        parts[f"symbols_{kv}"] = infer_symbols(torch, mt, ck, dev_params, kv)
        counts.add(parts[f"symbols_{kv}"]["launches"])
    from mxnet_tpu_torch.ops import registry

    unrun = serving_ops(registry) - {
        n for kv in ("fp32", "int8") for n in parts[f"symbols_{kv}"]["ops"]}
    check(not unrun, f"19b: serving ops no symbol ran: {sorted(unrun)}")
    wall["symbols"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck.reset_launch_counts()
    parts["suffix_graphs"] = infer_suffix_graphs(torch, mt, ck, dev_params)
    counts.add(dict(ck.LAUNCHES))
    wall["suffix_graphs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck.reset_launch_counts()
    root = tempfile.mkdtemp()
    try:
        parts["resnet50_engine"] = infer_resnet(torch, mt, ck, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts.add(dict(ck.LAUNCHES))
    wall["resnet50_engine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck.reset_launch_counts()
    parts["lm_engine"] = infer_lm(torch, mt, ck, dev_params)
    counts.add(parts["lm_engine"]["launches"])
    wall["lm_engine"] = time.perf_counter() - t0
    del dev_params
    torch.cuda.empty_cache()
    summary = {**parts, "part_wall_s": wall,
               "wall_s": time.perf_counter() - t_start, "card": card_line()}
    print(json.dumps({"infer_summary": summary}))
    return {"parts": parts, "kernels": kernels, "launches": counts.total,
            "summary": summary}


def decode_timing(root):
    """``python3 chip_smoke.py --decode-timing ROOT``: time the decode
    kernel (B2) of the port under ROOT (a checkout, e.g. a parent commit
    unpacked beside this one) at the kernel checks' shapes, one JSON
    line each.  Run parent, change, change, parent in one call to
    compare two versions on one card."""
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    check(ck.__file__.startswith(root), f"imported {ck.__file__}, not "
          f"the port under {root}")
    _build.build(["paged_attention_decode"])
    rng = np.random.RandomState(2)  # main()'s shapes: the same lengths
    for dtype in ("float32", "bfloat16"):
        for B in (1, 16, 64):
            c = check_decode(torch, ck, F, B, 64, dtype, rng)
            print(json.dumps({"decode_timing": {"root": root, **c}}))
    print(card_line())
    return 0


def paged_timing(torch, ck, tatt, F, MB=64):
    """The paged kernels at their main shapes (B = 1, 16, 64; MB = 64;
    12 heads of 64; verify at W = SPEC_K + 1): the decode kernel over
    fp32 and bf16 pages, the quantized decode and the verify kernel over
    int8 and fp8 (fp32 queries), the verify kernel over fp32 and bf16;
    then at the two other head widths of ``WIDTH_CASES`` (B = 16): decode,
    int8 decode, verify over fp32 and int8.  Each record carries its
    per-call and back-to-back times."""
    rng = np.random.RandomState(2)  # the same lengths in every run
    recs = []
    for dtype in ("float32", "bfloat16"):
        recs += [check_decode(torch, ck, F, B, MB, dtype, rng)
                 for B in (1, 16, 64)]
    for kv in ("int8", "fp8"):
        recs += [check_decode_quant(torch, ck, tatt, F, B, MB, "float32", kv,
                                    rng) for B in (1, 16, 64)]
    for pool in ("float32", "bfloat16", "int8", "fp8"):
        recs += [check_verify(torch, ck, tatt, F, B, SPEC_K + 1, MB, pool,
                              rng) for B in (1, 16, 64)]
    for _, _, Hh, Dh in WIDTH_CASES:
        wide = dict(H=Hh, D=Dh)
        recs += [check_decode(torch, ck, F, 16, MB, "float32", rng, **wide),
                 check_decode_quant(torch, ck, tatt, F, 16, MB, "float32",
                                    "int8", rng, **wide)]
        recs += [check_verify(torch, ck, tatt, F, 16, SPEC_K + 1, MB, pool,
                              rng, **wide) for pool in ("float32", "int8")]
    return recs


# steps of ``eager_step_timing``: untimed, then timed
EAGER_STEP_WARMUP, EAGER_STEP_REPS = 3, 20


def eager_step_timing(root):
    """``python3 chip_smoke.py --eager-step ROOT``: ResNet-50's training
    step (batch 32, ``IMAGE``'s SGD settings, one batch of uniform
    noise) on the eager path of the port under ROOT
    (``MXNET_FUSED_STEP=0``: the executor's autograd pass, then the
    ``Updater`` on each parameter), fp32 with TF32 off: host ms of
    ``forward``, ``backward`` and ``update`` (each ending in a
    synchronize) and of the whole step, medians of ``EAGER_STEP_REPS``
    steps after ``EAGER_STEP_WARMUP``.  Run parent, change, change,
    parent in one call to compare two versions on one card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.environ["MXNET_FUSED_STEP"] = "0"
    import mxnet_tpu_torch as mt

    check(mt.__file__.startswith(root), f"imported {mt.__file__}, not "
          f"the port under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B = IMAGE["batch"]
    mod = image_bind(mt, resnet50(mt), mt.gpu(0), B)
    mt.random.seed(0)
    mod.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": IMAGE["lr"], "momentum": IMAGE["momentum"],
        "wd": IMAGE["wd"]})
    rng = np.random.RandomState(0)
    batch = mt.io.DataBatch(
        [mt.nd.array(rng.rand(B, *IMAGE["image_shape"]).astype(np.float32),
                     ctx=mt.cpu())],
        [mt.nd.array(rng.randint(0, IMAGE["classes"], B).astype(np.float32),
                     ctx=mt.cpu())])
    parts = {"forward": [], "backward": [], "update": [], "step": []}
    for i in range(EAGER_STEP_WARMUP + EAGER_STEP_REPS):
        times = []
        for fn in (lambda: mod.forward(batch, is_train=True), mod.backward,
                   mod.update):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        if i >= EAGER_STEP_WARMUP:
            for k, ms in zip(parts, times + [sum(times)]):
                parts[k].append(ms)
    out = {k + "_ms": float(np.median(v)) for k, v in parts.items()}
    print(json.dumps({"eager_step": {
        "root": root, "network": IMAGE["network"], "batch": B,
        "parameters": len(mod._exec.grad_dict), "steps": EAGER_STEP_REPS,
        **out}}))
    print(card_line())
    return 0


def paths_timing(root, mode="paths"):
    """``python3 chip_smoke.py --paths ROOT``: the tensor-core kernels at
    their main-path shapes, in fp32 and bf16 — B1's forward at (1, 1024)
    and (8, 1024), B1's backward at (8, 1024), B5's forward (with B5's
    backward) at ``PATH_MHA_SHAPES``, B8 and B9 at the ring's past hop,
    the paged kernels (``paged_timing``), B6 at LSTM-PTB's (60, 32,
    200), the four timed user kernels (B10's port, per call and back to
    back), ``float64_check`` and B7 (``nms``) at ``NMS_SHAPES`` with
    force off and on — then serving runs A, B and C (the verify steps),
    the packed LM's training run, the DPA LM's, the sequence phase,
    LSTM-PTB, SSD300 (its detection forward p50, and B7 alone on its
    rows) and ResNet-50's training run (step p50, images/s), on the
    port under ROOT (a checkout, e.g. a parent commit
    unpacked beside this one), one JSON line each; ``--kernels ROOT``
    the kernels alone, ``--nms ROOT`` B7 alone, ``--image ROOT`` phase
    10 (image classification) alone, ``--cnn ROOT`` phase 11 alone,
    ``--ckpt ROOT`` phase 12 alone (each building B1 and B6 first) and
    ``--bf16 ROOT`` phase 13 alone (the attention kernels built and
    rows 1-9 checked in bf16 and fp16 at the table's shapes first), ``--ops ROOT`` phase 14
    alone (B1 built first, for the packed LM's reference step) and
    ``--core ROOT`` phase 15 alone (B1 built first), ``--prefix ROOT``
    phase 16 alone and ``--tenancy ROOT`` phase 17 alone (B1, B8 and
    the paged kernels built first), ``--graphs ROOT`` phase 18 alone
    and ``--infer ROOT`` phase 19 alone (the same built first).
    Run parent, change, change, parent in one call to compare two
    versions on one card."""
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import attention as tatt
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    check(ck.__file__.startswith(root), f"imported {ck.__file__}, not "
          f"the port under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == "image":
        print(json.dumps({"paths_timing": {
            "root": root, "image_path": image_path(torch, mt, ck)}}))
        print(card_line())
        return 0
    if mode == "cnn":
        _build.build(["flash_mha_packed", "flash_mha_packed_bwd",
                      "lstm_scan"])
        print(json.dumps({"paths_timing": {
            "root": root, "cnn_dropout_path": cnn_dropout_path(torch, mt,
                                                               ck)}}))
        print(card_line())
        return 0
    if mode == "ckpt":
        _build.build(["flash_mha_packed", "flash_mha_packed_bwd",
                      "lstm_scan"])
        print(json.dumps({"paths_timing": {
            "root": root, "ckpt_path": ckpt_path(torch, mt, ck)}}))
        print(card_line())
        return 0
    if mode == "ops":
        _build.build(["flash_mha_packed", "flash_mha_packed_bwd"])
        rec = ops_path(torch, mt, ck)
        print(json.dumps({"paths_timing": {"root": root, "ops_path": {
            k: rec[k] for k in ("part_wall_s", "launches")}}}))
        print(card_line())
        return 0
    if mode == "prefix":
        _build.build(["flash_mha_packed", "flash_attention_partial",
                      "paged_attention_decode",
                      "paged_attention_decode_quant",
                      "paged_attention_verify"])
        rec = prefix_path(torch, mt, ck, tatt, F)
        print(json.dumps({"paths_timing": {"root": root, "prefix_path": {
            k: rec[k] for k in ("parts", "launches")}}}))
        print(card_line())
        return 0
    if mode == "core":
        _build.build(["flash_mha_packed", "flash_mha_packed_bwd"])
        t0 = time.perf_counter()
        rec = core_path(torch, mt, ck)
        print(json.dumps({"paths_timing": {"root": root, "core_path": {
            "part_wall_s": rec["part_wall_s"], "launches": rec["launches"],
            "wall_s": time.perf_counter() - t0}}}))
        print(card_line())
        return 0
    if mode == "bf16":
        _build.build([n for n in _build.SOURCES
                      if n not in ("lstm_scan", "nms")])
        rng = np.random.RandomState(2)
        # the bf16 and fp16 instantiations of rows 1-9 at the table's
        # shapes
        for dtype in HALF_DTYPES:
            for rec in half_kernel_checks(torch, ck, tatt, F, dtype, rng):
                print(json.dumps({"paths_timing": {"root": root, **rec}}))
        torch.cuda.empty_cache()
        rec = bf16_path(torch, mt, ck)
        print(json.dumps({"paths_timing": {"root": root, "bf16_path": {
            k: rec[k] for k in ("part_wall_s", "launches",
                                "bf16_traced_launches",
                                "fp16_traced_launches")}}}))
        print(card_line())
        return 0
    if mode == "graphs":
        _build.build(["flash_mha_packed", "flash_attention_partial",
                      "paged_attention_decode",
                      "paged_attention_decode_quant",
                      "paged_attention_verify"])
        rec = graphs_path(torch, mt, ck)
        print(json.dumps({"paths_timing": {"root": root, "graphs_path": {
            "launches": rec["launches"]}}}))
        print(card_line())
        return 0
    if mode == "infer":
        _build.build(["flash_mha_packed", "flash_attention_partial",
                      "paged_attention_decode",
                      "paged_attention_decode_quant",
                      "paged_attention_verify"])
        rec = infer_path(torch, mt, ck, tatt, F)
        print(json.dumps({"paths_timing": {"root": root, "infer_path": {
            "launches": rec["launches"]}}}))
        print(card_line())
        return 0
    if mode == "tenancy":
        _build.build(["flash_mha_packed", "flash_attention_partial",
                      "paged_attention_decode",
                      "paged_attention_decode_quant",
                      "paged_attention_verify"])
        rec = tenancy_path(torch, mt, ck)
        print(json.dumps({"paths_timing": {"root": root, "tenancy_path": {
            k: rec[k] for k in ("parts", "launches")}}}))
        print(card_line())
        return 0
    if mode != "nms":
        from mxnet_tpu_torch.examples import user_cuda_kernel as ex
        from mxnet_tpu_torch.examples import user_triton_kernel as tex

        gelu_kernels = register_user_gelu(torch, mt)
        _build.build(sources=[(k.name, k.text, ()) for k in (
            ex.register().kernel, ex.silu_grad, *gelu_kernels)])
        for dtype in ("float32", "bfloat16"):
            recs = [check_prefill(torch, ck, F, 1024, dtype, B=B)
                    for B in (1, TRAIN_BATCH)]
            recs += check_backward(torch, ck, F, TRAIN_BATCH, 1024, dtype)
            for shape in PATH_MHA_SHAPES:
                recs += check_mha(torch, ck, F, *shape, dtype)
            recs += check_partial(torch, ck, F, *PARTIAL_SHAPES[1], dtype)
            for rec in recs:
                print(json.dumps({"paths_timing": {"root": root, **rec}}))
            torch.cuda.empty_cache()
        for rec in paged_timing(torch, ck, tatt, F):
            print(json.dumps({"paths_timing": {"root": root, **rec}}))
        torch.cuda.empty_cache()
        # the fp16 instantiations of rows 1-9 at the table's shapes
        for rec in half_kernel_checks(torch, ck, tatt, F, "float16",
                                      np.random.RandomState(2)):
            print(json.dumps({"paths_timing": {"root": root, **rec}}))
        rec = check_lstm(torch, ck, *LSTM_SHAPES[0])
        print(json.dumps({"paths_timing": {"root": root, **rec}}))
        for rec in user_kernel_checks(torch, F, ex, gelu_kernels)[0] \
                + sum(triton_kernel_checks(torch, F, tex), []):
            print(json.dumps({"paths_timing": {"root": root, **rec}}))
        for rec in float64_check(torch, ck):
            print(json.dumps({"paths_timing": {"root": root,
                                               "float64": rec}}))
        torch.cuda.empty_cache()
    for B, A in NMS_SHAPES:
        for force in (False, True):
            rec = check_nms(torch, ck, B, A, force, seed=B + A)
            print(json.dumps({"paths_timing": {"root": root, **rec}}))
    torch.cuda.empty_cache()
    if mode != "paths":
        print(card_line())
        return 0
    dev_params = mt.params_from_numpy(gpt2_small_params(0), "cuda")
    runs = {"serving_A": main_path(torch, mt, ck, dev_params)}
    torch.cuda.empty_cache()
    for run, rec in spec_paths(torch, mt, ck, dev_params,
                               runs=("B", "C")).items():
        runs[f"serving_{run}"] = rec
    del dev_params
    torch.cuda.empty_cache()
    runs["train_path"] = train_path(torch, mt, ck, eager=False)
    torch.cuda.empty_cache()
    runs["dpa_path"] = dpa_path(torch, mt, ck, eager=False)
    torch.cuda.empty_cache()
    runs["sequence_path"] = sequence_path(torch, mt, ck)
    torch.cuda.empty_cache()
    runs["lstm_path"] = lstm_path(torch, mt, ck, eager=False)
    torch.cuda.empty_cache()
    runs["ssd300_path"] = ssd_path(torch, mt, ck, eager=False)
    torch.cuda.empty_cache()
    runs["resnet50_train"] = resnet_train(torch, mt, eager=False)
    torch.cuda.empty_cache()
    for net in ("alexnet", "inception-v3"):
        runs[f"{net}_train"] = cnn_train(torch, mt, net, eager=False)
    runs["resnet50_score_images_per_s"] = {
        b: score_pair(torch, mt, "resnet-50", b, IMAGE["image_shape"],
                      IMAGE["classes"], False)["graphed"]
        for b in IMAGE["score_batches"]}
    for name, rec in runs.items():
        print(json.dumps({"paths_timing": {"root": root, name: rec}}))
    print(card_line())
    return 0


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this script drives "
              "the port on an NVIDIA card", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import attention as tatt
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; device {kind}")

    # the user kernels (this script and the example are users of
    # mt.rtc) build from their source text beside the port's csrc/
    from mxnet_tpu_torch.examples import user_cuda_kernel as ex
    from mxnet_tpu_torch.examples import user_triton_kernel as tex

    gelu_kernels = register_user_gelu(torch, mt)
    api_names, api_kernels = register_api_ops(torch, mt)
    user_kernels = [ex.register().kernel, ex.silu_grad, *gelu_kernels,
                    *api_kernels]
    # the paged kernels' three libraries take the longest to compile (most
    # of the build's wall): they compile on a thread while the checks of
    # every other kernel run, and their own checks wait for them
    t0 = time.perf_counter()
    paged_build = concurrent.futures.ThreadPoolExecutor(1).submit(
        _build.build, PAGED_SOURCES)
    built = _build.build(
        [n for n in _build.SOURCES if n not in PAGED_SOURCES],
        sources=[(k.name, k.text, ()) for k in user_kernels])
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    # seconds since the start at each phase's end, for the time budget
    marks = {}

    def mark(name):
        marks[name] = round(time.perf_counter() - t_start, 2)

    mark("build")
    for rec in tensor_core_report(_build):
        print(json.dumps({"tensor_cores": rec}))
    for rec in nms_report(_build):
        print(json.dumps({"nms_resources": rec}))

    checks = []
    for dtype in ("float32", "bfloat16"):
        for B, T in ((1, 128), (1, 1000), (1, 1024), (TRAIN_BATCH, 1024)):
            checks.append(check_prefill(torch, ck, F, T, dtype, B=B))
            print(json.dumps({"check": checks[-1]}))
        checks.append(check_prefill(torch, ck, F, 1000, dtype, offset=1))
        print(json.dumps({"check": checks[-1]}))
    # head widths other than 64: B1's forward and backward at each width
    # of WIDTH_CASES, fp32 and bf16 (the paged kernels' below)
    for B, T, Hh, Dh in WIDTH_CASES:
        for dtype in ("float32", "bfloat16"):
            for c in [check_prefill(torch, ck, F, T, dtype, B=B, H=Hh, D=Dh),
                      *check_backward(torch, ck, F, B, T, dtype, H=Hh,
                                      D=Dh)]:
                checks.append(c)
                print(json.dumps({"check": c}))
        torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        for c in [c for B, T in ((1, 128), (1, 1000), (1, 1024),
                                 (TRAIN_BATCH, 1024))
                  for c in check_backward(torch, ck, F, B, T, dtype)] \
                + check_backward(torch, ck, F, 1, 1000, dtype, offset=1):
            checks.append(c)
            print(json.dumps({"check": c}))
    for dtype in ("float32", "bfloat16"):
        for c in [c for shape in MHA_SHAPES
                  for c in check_mha(torch, ck, F, *shape, dtype)] \
                + check_mha(torch, ck, F, *MHA_OFFSET_SHAPE, dtype,
                            offset=1):
            checks.append(c)
            print(json.dumps({"check": c}))
    torch.cuda.empty_cache()
    for rec in float64_check(torch, ck):
        print(json.dumps({"float64": rec}))
    torch.cuda.empty_cache()
    # no earlier check launched B8 or B9: the plain versions of B1, B2,
    # B3 and B5 run the plain partial body, not the B8 wrapper
    check(all(ck.LAUNCHES[n] == 0 for n in SEQ_KERNELS),
          f"B8/B9 launched before their checks: {dict(ck.LAUNCHES)}")
    for dtype in ("float32", "bfloat16"):
        for B, Hh, Tq, Tk, Dh, causal, koff in PARTIAL_SHAPES:
            for c in check_partial(torch, ck, F, B, Hh, Tq, Tk, Dh, causal,
                                   koff, dtype):
                checks.append(c)
                print(json.dumps({"check": c}))
    torch.cuda.empty_cache()
    for T, B, Hd in LSTM_SHAPES:
        checks.append(check_lstm(torch, ck, T, B, Hd))
        print(json.dumps({"check": checks[-1]}))
    for B, A in NMS_SHAPES:
        for force in (False, True):
            checks.append(check_nms(torch, ck, B, A, force, seed=B + A))
            print(json.dumps({"check": checks[-1]}))
    print(json.dumps({"nms_edges": {"checks": check_nms_edges(torch, ck)}}))
    torch.cuda.empty_cache()
    user_checks, user_extra = user_kernel_checks(torch, F, ex, gelu_kernels)
    triton_checks, triton_extra = triton_kernel_checks(torch, F, tex)
    for c in user_checks + user_extra + triton_checks + triton_extra:
        print(json.dumps({"check": c}))
    torch.cuda.empty_cache()
    print(json.dumps({"rtc_api": rtc_api_checks(torch, mt, api_names, ex)}))
    # the fp16 instantiations of rows 1, 3 and 6-9 at the table's shapes,
    # while the paged kernels still compile
    for c in half_kernel_checks(torch, ck, tatt, F, "float16", None,
                                parts=("tc",)):
        checks.append(c)
        print(json.dumps({"check": c}))

    mark("checks")
    # the training paths need no paged kernel: they run while those still
    # compile
    torch.cuda.empty_cache()
    train = train_path(torch, mt, ck)
    print(json.dumps({"train_path": train}))
    torch.cuda.empty_cache()
    dpa = dpa_path(torch, mt, ck)
    print(json.dumps({"dpa_path": dpa}))
    mark("train")
    print(json.dumps({"imperative": imperative_check(torch, mt, ck)}))
    example = example_path(torch, mt, ck, ex)
    print(json.dumps({"user_kernel_example": example}))
    triton_example = example_path(torch, mt, ck, tex, op="user_triton_silu")
    print(json.dumps({"user_triton_kernel_example": triton_example}))
    gelu = gelu_lm_path(torch, mt, ck, "user_gelu", dpa["step_p50_ms"])
    print(json.dumps({"gelu_lm_path": gelu}))
    print(json.dumps({"custom_op": custom_op_path(torch, mt)}))
    mark("user_ops")
    torch.cuda.empty_cache()
    lstm = lstm_path(torch, mt, ck)
    print(json.dumps({"lstm_path": lstm}))
    mark("lstm")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    built = paged_build.result()
    print(f"build (paged kernels, waited {time.perf_counter() - t0:.1f} s): "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    for rec in paged_report(_build):
        if rec["head_dim_bucket"] == D:
            print(json.dumps({"paged_resources": rec}))
    rng = np.random.RandomState(2)
    for dtype in ("float32", "bfloat16"):
        for B, MB in ((1, 64), (16, 64), (64, 64)):
            checks.append(check_decode(torch, ck, F, B, MB, dtype, rng))
            print(json.dumps({"check": checks[-1]}))
    checks.append(check_decode(torch, ck, F, 16, 64, "float32", rng,
                               kv_dtype="bfloat16"))
    print(json.dumps({"check": checks[-1]}))
    for kv in ("int8", "fp8"):
        for dtype in ("float32", "bfloat16"):
            for B in (1, 16, 64):
                checks.append(check_decode_quant(torch, ck, tatt, F, B, 64,
                                                 dtype, kv, rng))
                print(json.dumps({"check": checks[-1]}))
    for pool in ("float32", "bfloat16", "int8", "fp8"):
        checks.append(check_verify(torch, ck, tatt, F, 16, SPEC_K + 1, 64,
                                   pool, rng))
        print(json.dumps({"check": checks[-1]}))
    # the paged kernels at each width of WIDTH_CASES, fp32 and bf16
    for B, T, Hh, Dh in WIDTH_CASES:
        wide = dict(H=Hh, D=Dh)
        for dtype in ("float32", "bfloat16"):
            width_checks = [
                check_decode(torch, ck, F, 16, 64, dtype, rng, **wide),
                check_decode_quant(torch, ck, tatt, F, 16, 64, dtype,
                                   "int8" if dtype == "float32" else "fp8",
                                   rng, **wide)]
            for c in width_checks:
                checks.append(c)
                print(json.dumps({"check": c}))
        for pool in ("float32", "bfloat16", "int8", "fp8"):
            checks.append(check_verify(torch, ck, tatt, F, 16, SPEC_K + 1,
                                       64, pool, rng, **wide))
            print(json.dumps({"check": checks[-1]}))
        torch.cuda.empty_cache()
    # the paged kernels at the edges of their work partition, every width
    edges = paged_edge_checks(torch, ck, tatt, F, rng)
    for Dh in PAGED_EDGE_WIDTHS:
        mine = [c for c in edges if f" D={Dh} " in c["shape"]]
        print(json.dumps({"paged_edges": {
            "D": Dh, "checks": len(mine),
            "max_err_over_tol": max(c["max_abs_err"] / c["tol"]
                                    for c in mine),
            "verify_rows_bitwise": sum(c.get("rows_bitwise", False)
                                       for c in mine)}}))
    torch.cuda.empty_cache()
    # the fp16 instantiations of the paged kernels at the table's shapes
    for c in half_kernel_checks(torch, ck, tatt, F, "float16", rng,
                                parts=("paged",)):
        checks.append(c)
        print(json.dumps({"check": c}))
    mark("paged_checks")

    dev_params = mt.params_from_numpy(gpt2_small_params(0), "cuda")
    res = main_path(torch, mt, ck, dev_params)
    print(json.dumps({"main_path": res}))
    torch.cuda.empty_cache()
    runs = spec_paths(torch, mt, ck, dev_params)
    for run, rec in runs.items():
        print(json.dumps({f"serving_{run}": rec}))
    del dev_params
    torch.cuda.empty_cache()
    default_lm = default_lm_path(torch, mt, ck)
    print(json.dumps({"default_lm_path": default_lm}))
    mark("serving")
    torch.cuda.empty_cache()
    ssd = ssd_path(torch, mt, ck)
    print(json.dumps({"ssd300_path": ssd}))
    mark("ssd300")
    torch.cuda.empty_cache()
    earlier = [res, *runs.values(), default_lm, train, dpa, lstm, ssd,
               example, triton_example, gelu]
    check(all(r["launches"].get(n, 0) == 0 for r in earlier
              for n in SEQ_KERNELS), "B8/B9 launched on an earlier path")
    sequence = sequence_path(torch, mt, ck)
    print(json.dumps({"sequence_path": sequence}))
    mark("sequence")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    image = image_path(torch, mt, ck)
    image["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"image_path": image}))
    mark("image")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cnn = cnn_dropout_path(torch, mt, ck)
    cnn["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"cnn_dropout_path": cnn}))
    mark("cnn")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ckpt = ckpt_path(torch, mt, ck)
    ckpt["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"ckpt_path": {k: ckpt[k] for k in (
        "part_wall_s", "launches", "wall_s")}}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bf16 = bf16_path(torch, mt, ck)
    bf16["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"bf16_path": {k: bf16[k] for k in (
        "part_wall_s", "launches", "bf16_traced_launches",
        "fp16_traced_launches", "wall_s")}}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ops = ops_path(torch, mt, ck, packed=train)
    ops["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"ops_path": {k: ops[k] for k in (
        "part_wall_s", "launches", "wall_s")}}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    core = core_path(torch, mt, ck)
    core["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"core_path": {k: core[k] for k in (
        "part_wall_s", "launches", "wall_s")}}))
    torch.cuda.empty_cache()
    prefix = prefix_path(torch, mt, ck, tatt, F)
    print(json.dumps({"prefix_path": {k: prefix[k] for k in (
        "parts", "launches")}}))
    mark("prefix")
    torch.cuda.empty_cache()
    tenancy = tenancy_path(torch, mt, ck)
    print(json.dumps({"tenancy_path": tenancy["parts"]}))
    mark("tenancy")
    torch.cuda.empty_cache()
    graphs = graphs_path(torch, mt, ck)
    mark("graphs")
    torch.cuda.empty_cache()
    infer = infer_path(torch, mt, ck, tatt, F)
    mark("infer")
    print(json.dumps({"phase_walls": marks}))

    # the fp32 check at each kernel's largest main-path shape stands for
    # it; launches are summed over the serving runs, the default LM's
    # serving and step, the training run, the DPA training run, the
    # LSTM-PTB run, the SSD300 run, the sequence phase, phase 11 (the
    # dropout LM's B1, the LSTM with dropout's lstm_scan), phase 12
    # (the checkpointed dropout LM's B1, LSTM-PTB's lstm_scan), phase 13
    # (the bf16 LM's B1, its serving's B1 and paged kernels), phase 14
    # (none: the primitive LM's training launches no kernel) and phase 15
    # (the packed LM's B1 under each optimizer, the mirror, the monitor),
    # phase 16 (serving with the prefix cache: B1 a miss, B8 a hit's
    # suffix prefill or a chunk, the paged kernels a step) and phase 17
    # (multi-tenant serving: B1 a miss and a draft LM's forward, B8 a
    # salted hit's suffix prefill, the paged kernels a step)
    paged = "mxnet_tpu_torch/csrc/paged_attention_"
    bwd = ("mxnet_tpu_torch/csrc/flash_mha_packed_bwd.cu",
           "mxnet_tpu/ops/pallas_kernels.py:1230")
    mha_bwd = ("mxnet_tpu_torch/csrc/flash_mha_bwd.cu",
               "mxnet_tpu/ops/pallas_kernels.py:838")
    path_mha = f"B={TRAIN_BATCH} H={H} Tq=1024 Tk=1024 D={D} causal"
    partial = "mxnet_tpu_torch/csrc/flash_attention_partial"
    hop = f"B=1 H={H} Tq=4096 Tk=4096 D={D} koff=-4096 "
    meta = {"flash_mha_packed": (
                "mxnet_tpu_torch/csrc/flash_mha_packed.cu",
                "mxnet_tpu/ops/pallas_kernels.py:1193", "B=1 T=1024 ",
                "float32"),
            "flash_mha_packed_bwd_dq": bwd + (f"B={TRAIN_BATCH} T=1024 ",
                                              "float32"),
            "flash_mha_packed_bwd_dkv": bwd + (f"B={TRAIN_BATCH} T=1024 ",
                                               "float32"),
            "flash_mha": ("mxnet_tpu_torch/csrc/flash_mha.cu",
                          "mxnet_tpu/ops/pallas_kernels.py:792", path_mha,
                          "float32"),
            "flash_mha_bwd_dq": mha_bwd + (path_mha, "float32"),
            "flash_mha_bwd_dkv": mha_bwd + (path_mha, "float32"),
            "paged_attention_decode": (
                paged + "decode.cu", "mxnet_tpu/ops/pallas_kernels.py:1389",
                "B=16 MB=64 ", "float32"),
            "paged_attention_decode_quant": (
                paged + "decode_quant.cu",
                "mxnet_tpu/ops/pallas_kernels.py:1437", "B=16 MB=64 ",
                "float32/int8"),
            "paged_attention_verify": (
                paged + "verify.cu", "mxnet_tpu/ops/pallas_kernels.py:1545",
                f"B=16 W={SPEC_K + 1} ", "float32"),
            "paged_attention_verify_quant": (
                paged + "verify.cu",
                "mxnet_tpu/ops/attention.py:894 (paged_verify_attention_q, "
                "a lax function: no Pallas kernel exists)",
                f"B=16 W={SPEC_K + 1} ", "float32/int8"),
            "lstm_scan": (
                "mxnet_tpu_torch/csrc/lstm_scan.cu",
                "mxnet_tpu/ops/pallas_kernels.py:94", "T=60 B=32 H=200",
                "float32"),
            "nms": (
                "mxnet_tpu_torch/csrc/nms.cu",
                "mxnet_tpu/ops/pallas_kernels.py:203",
                "B=32 A=8732 force_suppress=False", "float32"),
            # the ring's past hop (nothing masked, the most work a hop
            # does) stands for B8 and B9
            "flash_attention_partial": (
                partial + ".cu", "mxnet_tpu/ops/pallas_kernels.py:303",
                hop, "float32"),
            "flash_attention_bwd_dq": (
                partial + "_bwd.cu", "mxnet_tpu/ops/pallas_kernels.py:470",
                hop, "float32"),
            "flash_attention_bwd_dkv": (
                partial + "_bwd.cu", "mxnet_tpu/ops/pallas_kernels.py:470",
                hop, "float32")}
    all_runs = earlier + [sequence, image, cnn, ckpt, bf16, ops, core,
                          prefix, tenancy, graphs, infer]
    kernels = []
    for name, (src, replaces, shape, dtype) in meta.items():
        c = next(c for c in checks if c["kernel"] == name
                 and c["dtype"] == dtype and c["shape"].startswith(shape))
        launches = sum(r["launches"].get(name, 0) for r in all_runs)
        check(launches > 0, f"{name} never launched on the main paths")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches,
                        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                        "plain_ms": c["plain_ms"],
                        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                        "library_ms": c["library_ms"]})
    # the user kernels (B10's port, rtc.cuda_op and rtc.triton_op):
    # launches over the examples' runs (SiLU) and the GELU LM's (GELU)
    user_src = {"user_silu": "mxnet_tpu_torch/examples/user_cuda_kernel.py",
                "user_gelu": "chip_smoke.py",
                "user_triton_silu":
                    "mxnet_tpu_torch/examples/user_triton_kernel.py"}
    for c in user_checks + triton_checks:
        name = c["kernel"]
        launches = sum(r["launches"].get(name, 0) for r in all_runs)
        check(launches > 0, f"{name} never launched on the main paths")
        kernels.append({"name": name,
                        "route": "triton" if "triton" in name else "cuda",
                        "source": user_src[name.replace("_grad", "")],
                        "replaces": "mxnet_tpu/rtc.py:143 (pallas_op, user "
                                    "kernel)",
                        "launches": launches,
                        "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                        "plain_ms": c["plain_ms"],
                        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                        "library_ms": c["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"wall_s": time.perf_counter() - t_start}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--eager-step"]:
        sys.exit(eager_step_timing(sys.argv[2] if len(sys.argv) > 2
                                   else "."))
    if sys.argv[1:2] == ["--decode-timing"]:
        sys.exit(decode_timing(sys.argv[2] if len(sys.argv) > 2 else "."))
    if sys.argv[1:2] in (["--paths"], ["--kernels"], ["--nms"],
                         ["--image"], ["--cnn"], ["--ckpt"], ["--bf16"],
                         ["--ops"], ["--core"], ["--prefix"],
                         ["--tenancy"], ["--graphs"], ["--infer"]):
        sys.exit(paths_timing(sys.argv[2] if len(sys.argv) > 2 else ".",
                              mode=sys.argv[1][2:]))
    sys.exit(main())
