"""Drive the PyTorch/CUDA port (nnstreamer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only slice,serve

Phases, each printing one JSON line:

  device     the card (nvidia-smi name and power limit), torch and CUDA
             versions, and the time it took to build the kernel library
             from csrc/ with nvcc;
  kernel     every hand-written kernel against its plain PyTorch version on
             the card, at the flagship path's shapes: max abs error against
             the stated tolerance, kernel and plain times (CUDA events
             around back-to-back calls, after warm-up), the kernel's own
             device time per launch from torch.profiler (device_ms: a
             kernel faster than its wrapper's host time is not timed by
             the wrapper) and the least time the card could take for the
             same work (bytes at 3.35 TB/s or operations at the peak rate
             for their type, whichever is larger). The fused block has one
             row per stride-1 block of MobileNet-v2 at batch 128, with its
             plan, registers, shared memory and CTAs per SM and the time of
             the same block as three cuDNN convolutions
             (inverted_residual_conv, timed only: cudnn_chain_ms, the
             library column), then a float32 row, a prime 113x113 row, a
             row summing the 13 and, after the stride2 phase, one summing
             all 17 blocks the forward launches (its bound is the sum of
             the per-block bounds); then the same rows at every block
             shape of SSD-MobileNet-v2 at 300 px (17, batch 32) and
             DeepLab-v3 at 257 px (13, batch 16; its 4 dilated blocks run
             the convolutions) with a sum per model, SSD's 17 again at
             batch 1 (the streams phase's detect-then-crop line), their
             stride-2 rows under stride2, and normalize_u8 at the four
             vision lines' frames, bit-equal to its plain version;
  stride2    the kernel's stride-2 body at MobileNet-v2's 4 stride-2
             blocks (112, 56, 28 and 14 to half) at batch 128 against its
             plain version at the fused block's tolerance, with the kernel
             phase's columns, the cuDNN chain held to the plain version at
             its own looser tolerance, and a sum of 4 against its bound;
             SSD's (150, 75, 38, 19) and DeepLab's (129, 65, 33) stride-2
             rows (even and odd maps: TF SAME pads (0, 1) and (1, 1)); the
             float32 body at all 11 shapes at batch 2 (1e-4, TF32 off);
  slice      the flagship image-labeling line through the port's
             parse_launch at full width (MobileNet-v2 1.0, 224x224 RGB,
             1001 classes, 128 frames per tensor): one label per frame,
             the fused-block kernel launched 17 times and normalize_u8 once
             per forward, the filter's logits against the same forward with
             the kernel's plain version in its place (mode 'plain'), the
             fused:xla forward's distance from it (reported), frames per
             second and p50 batch latency;
  profile    one more run of the line under torch.profiler: device time
             by kernel, the PyTorch elementwise kernels' sum and the
             device's idle share; then (line=flagship_forward) the
             filter's forward alone, 4 times on one batch on the card: a
             forward's device ms and the fused block's by body (stride 1,
             stride 2);
  transform  tensor_transform acceleration=device bit-equal to numpy;
             (the kernel phase also holds arith_chain bit-equal to its
             plain version for every input and output dtype, on all 256
             values of 8-bit inputs and all 65,536 of 16-bit ones, for the
             launch lines' chains, at a ragged size and an unaligned base);
  attention  the flash-attention kernel against its plain version (the
             blockwise recurrence at the instance's key block: 128 keys,
             64 for bf16 from head_dim 256 up) at causal 8x8192x128 (the
             stream line), 768x197x64 (ViT-S/16 at batch 128), causal
             4x8192x256 (the stream line at head_dim 256), a ragged causal
             3x1000x32 and 4x777x64 and a ragged non-causal 2x333x128
             (each head dim on both mask paths), in float32 at the
             reference's test shapes, in bf16 and float32 at head dims 8,
             16, 24, 48, 96 and 256 with ragged and unequal sequences, and
             in float32 at causal 8x4096x128: max error
             against the stated tolerance (float32 at 2e-5 abs + 2e-5
             rel, TF32 off); for the timed shapes kernel, device, plain and
             bound ms, and the time of torch's scaled_dot_product_attention
             at the same shape (library_ms, timed only); every line also
             gives the body and instantiation the kernel ran, its registers
             per thread, dynamic shared memory and resident CTAs per SM;
  stream     the long-context line (appsrc ! tensor_aggregator !
             tensor_filter model=stream_transformer ! tensor_sink) at seq
             8192, dim 1024, 8 heads, depth 4: 8 windows after 2 warm-up
             windows, windows and frames per second, p50 window latency,
             4 flash_attention launches per forward, the output against a
             twin of the model whose attention is the plain version; then
             a profile line of 2 more windows;
  chunk      the ring's chunk kernel against its plain version (the chunk
             recurrence at the instance's key block) at the stream line's
             sp=4 shard, 8x2048x128, on carries from an earlier hop: the
             diagonal, past, future and non-causal hops, the diagonal,
             past and future hops at the head_dim 256 line's shard
             4x2048x256, and two ragged
             causal cases (3x1000x32 with offsets); then the diagonal, past,
             partly masked and future hops at 3x300x300 for head dims 8, 16,
             24, 48, 96 and 256 in bf16 and float32; a future hop leaves
             the carries bit-identical, the others hold acc/l, m and l
             within stated tolerances; kernel, device, plain and bound ms
             per timed hop;
  ring       ring_attention over make_mesh(sp=4, devices=[cuda:0] * 4) at
             causal 8x8192x128 against the same ring over the plain chunk
             update, cross-checked (with their own tolerance) against
             flash_attention_cuda, as is ulysses_attention at 1x8x8192x128;
             16 flash_chunk launches per ring call and 4 flash_attention
             per Ulysses call; ring, Ulysses, flash and SDPA ms; then the
             stream line's StreamTransformer on the filter's own weights
             with the ring as its attention (64 flash_chunk launches)
             against the filter's flash forward, and both forwards' ms;
             and a profile line of 5 ring calls;
  stream256  the stream line at head_dim 256 (dim 1024 over 4 heads: the
             tensor-core body in 64-key tiles): 4 windows after a warm-up
             window, windows per second, p50 window latency, 4
             flash_attention launches per forward, the output against the
             plain-attention twin; then one ring call at its attention
             shape, causal 4x8192x256 over the sp=4 mesh (16 flash_chunk
             launches), against the plain ring at ATTN_TOL and the flash
             kernel at the ring's own tolerance, with ring, plain ring,
             flash and SDPA ms;
  longctx    examples/long_context.py's three steps at its own sizes, run
             by the port's runner (nnstreamer_tpu_torch/examples/
             long_context.py): its stream line (128 one-frame buffers to
             one window, dim 32, 2 heads: bf16 at head_dim 16) against the
             plain-attention twin, with its flash_attention launch; ring
             attention on float32 (2, 1024, 32) and Ulysses on float32
             (2, 8, 1024, 32), causal, over make_mesh(sp=8,
             devices=[cuda:0] * 8), each against plain_attention at the
             reference's atol 3e-5 with its kernel's launches; then the
             reference tests' float32 ring (d 16 and 8) and Ulysses (d 16)
             shapes the same way;
  vit        the ViT-S/16 labeling line (224x224, depth 6, 1000 classes,
             128 frames per tensor): 6 flash_attention launches and 1
             normalize_u8 launch per forward, logits against the plain
             twin, frames per second and p50 batch latency;
  detect     the SSD line at full width (300x300 RGB, width 1.0, 91
             classes, 1917 anchors, fused:pallas, 32 frames per tensor)
             into bounding_boxes mobilenet-ssd with split-batch=32: one
             RGBA overlay per frame, the fused block launched 17 times and
             normalize_u8 once per forward, boxes and scores against the
             plain forward (the kernel's plain version in its place) held
             to the bf16 noise floor (the fused:xla forward's distance
             from the same plain forward: the kernel's mean distance at
             most half of it, its max distance and per-anchor class
             agreement no worse), the float32 forward's distance
             reported, frames/s and p50 batch latency; then the
             postproc:pp line into mobilenet-ssd-postprocess: its quads
             bit-equal to the post-process of the kernel forward's raw
             outputs, and their near agreement with the plain forward's
             quads no worse than the fused:xla forward's;
  segment    the DeepLab line (257x257, width 1.0, 21 classes, 16 frames
             per tensor) into image_segment tflite-deeplab: 13 fused-block
             launches and 1 normalize_u8 per forward, logits and per-pixel
             classes held to the noise floor as in detect, frames/s; the
             SSD and DeepLab lines each get a profile line of 4 more
             batches (device time by kernel, idle share);
  vision     PoseNet (257 px, 17 keypoints) into pose_estimation
             heatmap-offset and YOLOv8 (320 px, width 0.25, depth 0.34, 80
             classes) into bounding_boxes yolov8, 16 frames per tensor:
             output shapes, finiteness, one overlay per frame, one
             normalize_u8 per forward, frames/s;

  upload     the flagship line (fetch-window=4) at feed-depth 1, 2 and 4,
             each run twice (1, 2, 4, 4, 2, 1): frames per second per run
             with the median and spread per depth, p50 batch latency,
             labels equal to feed-depth=1's, and from the tracer one h2d
             crossing per batch and one d2h per fetch window at the filter
             (with their bytes), the upload-window and fetch-window
             residencies; then one run each at feed-depth 1 and 2 under
             trace.torch_profile: device busy ms and idle share, the
             kernels' streams, and every host-to-device copy by name
             (Pinned or Pageable), stream, count and ms — at feed-depth 2
             the input's upload must be pinned and off the kernels' stream;
             and one span-traced run each at feed-depth 1 and 2: the
             filter's own host ms per batch, its mean dispatch ms and at
             depth 2 the prefetch's staging copy (the h2d span);
  batch      the live-camera form of the line: tensor_converter
             frames-per-tensor=1 ! tensor_filter batch-size=32
             fetch-timeout-ms=50 fetch-window=auto, frames pushed one by
             one: labels equal to the frames-per-tensor=32 line's, the
             window auto settled on, frames per second; then 40 frames and
             no EOS, brought out only by the timer thread's quiescence
             flush, labels again equal;
  hostspans  the flagship and stream lines with a span tracer attached
             after warm-up: each element's host ms per batch (window), its
             chain's inclusive time from Tracer.report() and its own time
             from the span ring (Tracer.element_self_ms), the host-stack
             roll-up and the filter's crossings; both span traces and a
             trace.torch_profile trace of the flagship line checked by
             validate_chrome_trace;
  serve      the serving tier at full width: tensor_query_serversrc
             serve=1 serve-batch=32 serve-queue-depth=256 ! tensor_filter
             model=mobilenet_v2 (1.0, 224x224, 1001 classes) !
             tensor_query_serversink, 8 client pipelines (appsrc !
             tensor_query_client ! tensor_decoder image_labeling !
             tensor_sink) pushing 32 seeded frames each at once: every
             client gets exactly its own 32 replies in order, each label
             equal to the direct forward's at batch 32 on the same
             frames, and (a second run with no decoder) each reply's
             logits within 0.15 abs + 0.05 rel of it, while the same
             replies shifted by one row fall outside that band and each
             client's frames carry at least two labels (so a mis-sliced
             row would show; logits_bit_equal reported); 17 fused-block and
             1 normalize_u8 launches per served batch; the serving report
             (rows, sheds, replies, batch fill); requests/s and p50/p99
             request latency from client push to client sink; then a
             profile line of one more run (line=serve), a serve_overload
             line (open-loop Poisson arrivals over the 8 clients at twice
             the measured rate for 3 s, serve-queue-depth=32: queue-full
             sheds, every admitted request answered once by its own
             client, the first reply before the last push, admitted
             p50/p99 and goodput), and a serve_lines
             line (the three lines of examples/launch_lines_serving.txt
             as written, model=add, 4 clients x 8 requests: exact);
  streams    three multi-stream lines at full width, each with its
             frames/s, p50 latency, launches and crossings: two cameras
             (appsrc ! tensor_converter frames-per-tensor=64, twice, into
             tensor_merge option=3 ! the flagship's tensor_filter at batch
             128 ! tensor_split tensorseg=64,64 ! image_labeling per
             camera; 8 batches after 2 warm-up: each camera's labels equal
             to the direct forward's of the merged frames, 17 fused-block
             and 1 normalize_u8 launches, one h2d and one d2h per batch,
             both at the filter); detect, then crop (300 px frames one
             per buffer ! tee, SSD ! tensor_region ! tensor_converter into
             tensor_crop.info, the frame into tensor_crop.raw; 32 frames:
             every frame's 4 crops byte-equal to the frame sliced at the
             regions tensor_region gives on the direct forward of that
             frame, 17 + 1 launches per frame; a profile line of 16 more
             frames); and the gated live camera (tensor_if
             TENSOR_AVERAGE_VALUE gt 16 between the converter and the
             batch-size=32 filter of the batch phase, 256 frames of which
             a seeded 64 are dark: exactly the bright frames labelled, in
             order, with the frames-per-tensor=32 line's labels);
  residency  the planner's lines at full width, 8 batches each after 2
             warm-up: the flagship with the reference preamble
             (tensor_transform typecast:float32,add:-127.5,div:127.5
             before the filter) fused — the transform a passthrough shell,
             its arithmetic in the filter through arith_chain (one launch
             per batch, no normalize_u8), the uint8 frames uploaded
             (19,267,584 B per batch) — and with fusion=off on the
             transform (numpy on the host, 77,070,336 B of float32 per
             batch): frames/s, p50, crossings at the filter, labels equal
             between the two, the fused stage's output on the card
             bit-equal to numpy's preamble, and a profile line of each;
             the fused line into a tee of two sinks (one d2h per batch,
             at the filter); and MobileNet-v2's logits through a queue
             into a model=add filter with chain-fusion=off (one h2d at
             the first filter and one d2h at the second per batch,
             device_ok and memory:HBM on the first filter's src pad,
             outputs the direct forward's + 1);
             and the fused preamble into a model=add filter on 8-frame
             float64, float16, int64 and uint32 buffers, types the kernel
             does not read (converted to float32 first: output bit-equal
             to numpy, one arith_chain launch per buffer);
  train      on-device training: a datarepo of 256 seeded 224x224x3 uint8
             frames with one-hot labels over 1001 outputs (16 classes,
             each a seeded mean colour plus noise) through datareposrc
             epochs=3 ! tensor_trainer framework=jax model-config=
             mobilenet_v2 (width 1.0, batch 32, lr 0.01, seed:0,
             fused:pallas; 192 train and 64 validation samples an epoch)
             ! tensor_sink: three 1:1:4 float64 reports, the training loss
             falling from epoch 1 to 3, finite validation metrics, one
             normalize_u8 launch per train and validation batch and 17
             fused-block launches per validation batch (train); before
             it, the first step on the card against the same step through
             the port on the CPU, each of loss, running statistics and
             weights within twice the CPU bf16 step's distance from the
             CPU float32 step, and normalize_u8's bf16 frames against the
             CPU preamble (train_step); after it, the validation forward
             against the unfused eval forward of the current weights
             (equal labels, within twice the bf16 forward's distance from
             float32; the float32 kernel forward at 0.15 + 0.05·|p|; the
             forward folded from the initial weights must fail:
             train_refold); the saved weights served by tensor_filter
             custom=params:<save>,fused:pallas on the validation frames,
             labels equal to the trainer's last validation forward's,
             logits within 0.15 + 0.05·|p| of them (their distance
             reported), 17 + 1 launches per batch (train_serve); then
             train step ms,
             samples/s, validation frames/s, h2d bytes per batch and the
             peak device memory from a trainer driven directly
             (train_timing), and a profile line of 4 steps (every
             profile line also sums device ms by kind: convolution,
             GEMM, reduction, elementwise, copies, this package's
             kernels); then the sharded trainer (train_mesh): the same
             line's first 32 frames, 3 steps, under custom=mesh:1 (dp 4)
             and mesh:1,tp:2 (dp 2 x tp 2) over cuda:0*4 against the
             unsharded trainer within twice its bf16 noise (the same
             steps at float32), replicas equal, the trained weights
             through the flagship's filter, step ms in turns, and a
             profile line of 2 dp 4 steps;
  loop       the steady loop, each window one replay of a CUDA graph over
             the filter's whole per-frame composition: line A (the
             reference's loop leg, bench.py:669-677: one 224 px frame a
             buffer into MobileNet-v2 fused:pallas, postproc:argmax,
             loop-window=8 launch-depth=2; 512 frames) and line B (the
             flagship at 128 frames a tensor, loop-window=4
             launch-depth=2; 32 batches, then again with the reference
             preamble fused, arith_chain inside the graph), each in turns
             with the same line per-buffer on the same frames: labels
             equal on every frame, no refusal, replays = windows, one h2d
             crossing and one dispatch span a window, 17 fused-block and
             1 normalize_u8 (B's preamble: 1 arith_chain) launches a frame
             through the replays; frames/s per run with median and
             spread, p50 frame latency, host ms per frame by span, capture
             ms, the memory plan's predicted bytes against
             max_memory_allocated (fails where the plan bills less), the
             plan's graph-pool bill against the pool one recapture needs
             (fails outside [pool, 2 pool]), with the bill's rows beside
             the blocks live at the capture's peak (from the allocator's
             history: each request, the bytes the allocator counts for
             it, the frame that made it) and the pool's segments, and
             what a private pool still holds once the first captures'
             lines stopped (cuBLAS's workspace); a profile line of each
             form (after capture); A and B without
             the argmax: windowed logits bit-equal to per-buffer ones on
             every frame; A with its classifier negated and the weights'
             version moved halfway: one recapture, the second half's
             logits the per-buffer ones negated bit for bit, launches
             counted through the replays plus the recapture's warm-up;
             line C: loop-window=auto on A, resolved by the memory plan
             against the card's memory;
  edge       the among-device transports, every label against the same
             frames' (1,024 seeded frames, the seed:0 weights): (a) the
             serve line with connect-type=HYBRID (the server announces its
             bound TCP port on the port's MqttBroker and 8 clients
             discover it) and over plain TCP, in turns H T T H H T:
             labels equal to the direct forward, 17 fused-block and 1
             normalize_u8 launches a served batch, requests/s, p50/p99
             request latency and discovery ms (a HYBRID client's start
             less a TCP client's), median and spread of 3 runs each; (b)
             the MQTT camera line (appsrc ! tensor_converter
             frames-per-tensor=128 ! mqttsink broker=embedded qos=1 into
             mqttsrc qos=1 ! the flagship's filter with postproc:argmax):
             1,024 frames as 8 messages a run, 3 runs, every frame once
             and in order with the flagship line's labels, frames/s, p50
             frame latency, bytes a message, duplicates received by the
             broker and by the subscriber and dropped, host ms a message
             (publish, broker fan-out, decode, filter), 17 + 1 launches a
             message, and a profile line; (c) edgesink
             connect-type=HYBRID into edgesrc connect-type=HYBRID ! the
             same filter: labels equal, frames/s;
  wide       kernels 4 and 5 from head_dim 256 up (the tensor-core body
             at 256 and the split bodies above) at d 256, 320, 384 and
             512, bf16 and float32, causal and not, at 8 heads x 1024,
             each against its plain version at the instance's key block
             and the attention and chunk phases' tolerances (the chunk
             kernel at the diagonal, non-causal and half-masked hops and
             the future hop, carries bit-identical, in bf16 and at d 384
             in float32), with kernel, device, plain, bound and (flash)
             SDPA ms and each instance's registers, shared memory, CTAs
             per SM, body and key block;
  chain      whole-chain fusion on line K, the flagship's head
             (MobileNet-v2 1.0, 224 px, 128 frames a tensor) ! queue ! a
             typecast:float32,div:2.0 transform ! a bf16 1001x1001 matmul
             with the argmax ! image_labeling: its NNST450 verdict; (a)
             fused and chain-fusion=off in turns (F O O F F O), 8 batches
             a run after 2 warm-up: labels equal to the off run's on
             every frame, 17 fused-block, 1 normalize_u8 and 1
             arith_chain launches a batch, one h2d at m and one d2h a
             batch, h never invoked and m built once when fused, the
             logits (no argmax) fused against off, frames/s and p50 batch
             latency with median and spread, and a profile line; (b)
             loop-window=4 launch-depth=2 on m: NNST460, one graph replay
             a window over the whole composition, one capture, labels
             equal; (c) arith_chain at the gap's 128x1001 float32 against
             its plain version with kernel, device, plain, bound and
             library (x / 2.0) ms; (d) the analyzer alone on an add chain
             sized past the card's budget (NNST452) and the fixture's
             12 GiB line, which the card's budget admits (NNST450);
  robust     the flagship with the preamble fused, on the torch_cuda
             backend, under this package's sanitizer: (a) invoke-hang on
             the first 2 invokes (1.5 s against invoke-timeout-ms=1000,
             fallback-framework=jax fallback-after=2 on-error=drop): 2
             trips, the first batch dropped, a fresh jax instance with
             the fused preamble serving the rest, logits bit-equal to an
             unfaulted run, 17 fused-block and 1 arith_chain launches a
             batch on the fallback, no NNST601 and no hard violation;
             the watchdog worker on the streaming thread's stream at
             feed-depth 1, 2 and 4; (b) frames/s and p50 batch latency
             with the watchdog armed and without, and with the sanitizer
             on and off, in turns (on off off on on off); (c) donate:1
             against off at feed-depth 1 and 2: each invoke's peak above
             its entry (max_memory_allocated, max_memory_reserved),
             logits bit-equal, and the refusal behind a tee; (d) NNST600
             on CUDA tensors (a tee into two acceleration=device
             transforms, one writing in place) and the flagship, tee
             line and line K with no violation; (e) the validate CLI on
             examples/launch_lines_ctl.txt (each EXPECT) and the serve
             line's static plant seed beside the serve phase's device ms
             a row;
  mesh       shard=dp|tp|dpxtp and replicas=4 over cuda:0*4 (see
             check_mesh);
  tune       the autotuner (see check_tune): the flagship's static
             search (counts, prune codes, the chosen config, the
             signature), the card's host constants, a measured search
             with them, the chosen config's labels against the
             baseline's, validate --tune in a subprocess (the second
             run: the in-process search's report and signature) and the
             cost method compiled at batch 128 against the meta method;
  aot        the compile cache (see check_aot): the flagship with aot:1
             over a fresh cache, a miss (the worker child builds on the
             card) then a hit, against an aot:0 play — logits bit-equal,
             17 + 1 launches a batch, the open and first-output ms, the
             worker's and the load's ms, then the open and first-output
             ms of aot:0 against a hit in turns; the preamble-fused
             flagship and
             line K (a miss then a hit each, line K also against aot:0),
             a loop-window=4 flagship keyed apart, a damaged entry
             quarantined and rebuilt, a budget under the entry's
             hbm_bytes refused (the play on the kernels, built in
             process); validate --aot over examples/launch_lines_aot.txt
             (every EXPECT, then the WARM line played and linted twice:
             strict-clean, byte-identical); the tracer's aot_report;
  rollout    safe rollout (see check_rollout): the flagship on checkpoint
             A (seed 0, models.save_state) with aot:1, a rollout-model
             event to B (seed 1): promoted after a 64-frame canary and
             labelling as a line opened on B (flip ms); a B whose first
             invoke faults rolls back to A, a cache hit, labelling as A
             (rollback ms); rollout_report;
  deploy     validate --deploy on every examples/fleet/*.deploy (each its
             header's verdict), doctor --json and doctor --aot (the card,
             nvcc, the built library);
  import     imported model files (see check_import): the zoo's
             MobileNet-v2 1.0 (seed 0, 224 px, 1001 classes) written as a
             .tflite and an .onnx (size, write ms), each streamed through
             the image-labeling line with framework=jax at batch 128 —
             the preamble fused, and for the .tflite also
             custom=preproc:norm:-127.5:127.5 and batch:native — labels
             equal to the zoo's float32 forward on
             the CPU, logits max abs err against it, one arith_chain and
             no fused-block launch a batch, frames/s and p50 batch
             latency beside the zoo flagship's on the same frames;
             precision:default (TF32) against highest, then both
             invoked at once from two threads, each held to its serial
             logits and the TF32 flags restored after; the .tflite line
             with aot:1 (a miss, then a hit, logits bit-equal to aot:0);
             SingleShot(model=<tflite>) on one frame; the phase's seconds;
  train_vision  tensor_trainer framework=jax on SSD-MobileNet-v2 (300 px,
             width 1.0, 91 classes), DeepLab-v3 (257 px, 21 classes),
             PoseNet (257 px, 17 keypoints) and YOLOv8 (320 px, width
             0.25, 80 classes) at full width from seed:0 (see
             check_train_vision): loss:mse against labels of the head's
             shape from the CPU's float32 forward, batch 16, 4 steps and
             one validation batch through appsrc ! tensor_trainer
             (fused:pallas: SSD's and DeepLab's validation on the
             fused-block kernel, every batch's frames on normalize_u8);
             each model's first step on the card in float32 against the
             CPU's (forward, weight and running-statistics updates, loss;
             the CPU's bfloat16 step must fail the same limits), the
             card's bf16 forward within the bf16 noise, normalize_u8 at
             the line's frames bit-equal to its plain version, the
             validation batch against the unfused float32 forward; step
             ms, samples/s, validation frames/s, idle share over 4 steps;
  custom     user C and Lua filters on the card's lines (see
             check_custom): the flagship followed by the codegen 'c'
             passthrough .so, built with g++ against native/include,
             labels equal to the flagship alone, frames/s, p50 and d2h
             bytes a batch; model=add on the card into a framework=lua
             script on small tensors;
  native     the native pipeline core and framework=pjrt (see
             check_native): the port's core (g++, no cmake), the
             TorchScript op library (csrc/torch_ops.cc) and the native
             executable filter (csrc/native_exec.cc) built beside the
             kernels' nvcc at the start, each build's seconds (the
             device line's native_build_s the wall time of both); while
             the flagship's program builds in the worker child, each
             kernel through its op (a trace of its wrapper)
             bit-equal to its ctypes route at the flagship's shapes (its 17
             blocks, 4 of them stride 2, at batch 128, normalize_u8 on 128
             frames); the
             frozen add program (k:1.5) through tools/pjrt_native.py's
             default mode in a child that imports no torch, exact; the
             flagship with no Python in the frame path (videotestsrc !
             tensor_converter frames-per-tensor=128 ! tensor_filter
             framework=pjrt on native_aot_compile's frozen MobileNet-v2 !
             tensor_decoder image_labeling ! appsink; 8 batches after 1):
             17 fused-block and 1 normalize_u8 launches a batch counted in
             C by the op library, labels equal to the port's Python flagship
             line on the same testsrc frames, one batch's logits (a program
             without the argmax) within 0.15 + 0.05·|p| of the plain forward
             and against the Python forward; the same graph with the Python
             filter as a register_callback_filter backend, labels equal;
             frames/s and p50 batch interval of both native lines, frames/s
             and p50 batch latency of the Python line, and run_ab's native
             and Python medians;

  probes     first the MFU table's fused:pallas forward (kernels 1 and 2)
             against its plain version at batch 128, 256 and 512 (the
             flagship's tolerance and the bf16 noise floor); then the
             port's measurement tools: tools/mfu_table.py's table
             (MobileNet-v2 at batch 128/256/512 with float32 and bf16
             weights, fused:xla and fused:pallas, NCHW frames; ViT-S/16 at
             batch 32 and 128; the causal 8x8192x128 bf16 flash kernel
             against the blockwise plain version; the quant rows only
             where their file is in the checkout), each row's device ms by
             chained differencing on CUDA graphs, TFLOP/s and MFU against
             989 TFLOP/s, none unreliable; tools/mbv2_breakdown.py's 12
             rows, per-stage deltas and depthwise share;
             tools/multistream_probe.py's three legs at 1, 2, 4 and 8
             streams; the tables in build/probes/; the launches the
             timed graphs' replays made are printed apart and stay out of
             the kernels line;
  examples   the seven runners of nnstreamer_tpu_torch/examples on the
             card at their examples' sizes (the .tflite runner on the
             full-width MobileNet-v2 file testing/model_files.py writes),
             each with its outputs checked, its seconds and its launches;
             classification's labels and detection's objects equal to the
             same runner's on the CPU;

then one ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero without
that last line. It needs a CUDA card: without one it exits 1 at once.

``--only`` runs the named phases alone (``serve`` needs ``slice`` for
its frames; ``streams``, ``residency``, ``train``, ``loop``, ``edge``,
``chain``, ``robust``, ``mesh``, ``tune``, ``aot``, ``rollout``,
``deploy``, ``import``, ``train_vision``, ``custom``, ``native``,
``probes`` and ``examples`` build
their own; ``stride2`` runs inside ``kernel``, the
flagship's profile
inside ``slice``, the overload and reference lines inside ``serve``) and
ends after them, without the ``kernels`` and result lines.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from functools import lru_cache

ROOT = os.path.dirname(os.path.abspath(__file__))

#: published peaks of one H100 SXM (dense): bytes/s, bf16 and f32 ops/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

BATCH = 128
SIZE = 224
N_BATCHES = 8
FETCH_WINDOW = 4


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of fn(), after warm-up: the median over up to
    5 groups of back-to-back calls (``reps`` in all), each group timed by
    two CUDA events. Back to back, a kernel that takes longer than its
    host-side launch keeps the card busy, so this is its device time; a
    call whose host side is the slower (a launch that does no work) is
    timed by its host side."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    groups = max(1, min(5, reps))
    per = max(1, reps // groups)
    times = []
    for _ in range(groups):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times)


def device_ms(torch, fn, kernel: str, calls: int = 10):
    """Device time per launch of the kernels whose name contains
    ``kernel``, over ``calls`` calls of fn() under torch.profiler (after a
    warm-up call): the kernel's own time, which back-to-back ``cuda_ms``
    cannot separate from its wrapper's host time when the wrapper is the
    slower. The profiler now and then records no device activity for a
    window, so an empty window is traced again, up to 3 times; None when
    it never sees the kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and kernel in e.key):
                us += getattr(e, "self_device_time_total", 0) or 0
                count += e.count
        if count:
            return us / 1e3 / count
    return None


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def within(got, want, atol: float, rtol: float) -> bool:
    import torch

    return bool(torch.all((got.float() - want.float()).abs()
                          <= atol + rtol * want.float().abs()))


# -- phase: kernels against their plain versions ---------------------------

def check_elementwise(torch, results):
    from nnstreamer_tpu_torch.ops import (
        arith_chain,
        arith_chain_plain,
        normalize_u8,
        normalize_u8_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    ragged = torch.randint(0, 256, (1000003,), generator=gen, device="cuda",
                           dtype=torch.uint8)
    n = frames.numel()
    # normalize_u8: bit-equal to the plain version (same two roundings)
    for x, out in ((frames, torch.bfloat16), (frames, torch.float32),
                   (ragged, torch.float32)):
        k = normalize_u8(x, out_dtype=out)
        p = normalize_u8_plain(x, out_dtype=out)
        err = max_err(k, p)
        row = {"kernel": "normalize_u8", "shape": list(x.shape),
               "out": str(out).replace("torch.", ""), "max_abs_err": err,
               "tol": 0.0}
        if x is frames and out is torch.bfloat16:
            row["ms"] = cuda_ms(lambda: normalize_u8(x, out_dtype=out))
            row["device_ms"] = device_ms(
                torch, lambda: normalize_u8(x, out_dtype=out),
                "normalize_u8_kernel")
            row["plain_ms"] = cuda_ms(lambda: normalize_u8_plain(x, out_dtype=out))
            row["bound_ms"], row["bound_by"] = bound_ms(3 * n, 2 * n, "float32")
            results["normalize_u8"] = row
        emit("kernel", **row)
        if err != 0.0:
            raise AssertionError(f"normalize_u8 {row}")
    # arith_chain: the tensor_transform preamble and a clamp, bit-equal
    pre = [("add", -127.5), ("div", 127.5)]
    xf = torch.randn(BATCH * SIZE * SIZE * 3, generator=gen, device="cuda")
    cases = [(frames, pre, None, "preamble"),
             (xf, [], (-1.0, 1.0), "clamp"),
             (ragged, pre + [("mul", 3.0), ("add", 0.5)], (-2.0, 2.0),
              "ragged")]
    for x, ops, clamp, what in cases:
        k = arith_chain(x, ops, out_dtype=torch.float32, clamp=clamp)
        p = arith_chain_plain(x, ops, out_dtype=torch.float32, clamp=clamp)
        err = max_err(k, p)
        row = {"kernel": "arith_chain", "case": what, "shape": list(x.shape),
               "in": str(x.dtype).replace("torch.", ""), "max_abs_err": err,
               "tol": 0.0}
        if what == "preamble":
            row["ms"] = cuda_ms(lambda: arith_chain(x, ops, torch.float32))
            row["device_ms"] = device_ms(
                torch, lambda: arith_chain(x, ops, torch.float32),
                "arith_chain")
            row["plain_ms"] = cuda_ms(
                lambda: arith_chain_plain(x, ops, torch.float32))
            row["bound_ms"], row["bound_by"] = bound_ms(5 * n, 3 * n, "float32")
            results["arith_chain"] = row
        emit("kernel", **row)
        if err != 0.0:
            raise AssertionError(f"arith_chain {row}")
    check_arith_exhaustive(torch, gen)


#: the chains of the repo's launch lines (the tensor_transform preamble,
#: mul:2, mul:0.5, mul:0.1, add:1) and a clamp
ARITH_CHAINS = {
    "preamble": ([("add", -127.5), ("div", 127.5)], None),
    "mul2": ([("mul", 2.0)], None),
    "mul0.5": ([("mul", 0.5)], None),
    "mul0.1": ([("mul", 0.1)], None),
    "add1": ([("add", 1.0)], None),
    "preamble_clamp": ([("add", -127.5), ("div", 127.5)], (-0.5, 0.5)),
}


def _bits_equal(torch, a, b) -> bool:
    """Bit for bit where neither is NaN, and NaN at the same places (the
    NaN payload a conversion leaves is not the function's)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    ints = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a.view(ints)[~na], b.view(ints)[~nb]))


def check_arith_exhaustive(torch, gen):
    """arith_chain bit-equal to its plain version for every input and
    output dtype and every chain of ARITH_CHAINS: all 256 values of an
    8-bit input and all 65,536 of a 16-bit one (repeated to a ragged
    length), int32 and float32 samples with their extremes, each at an
    aligned base and at an unaligned one (x[1:], the element-by-element
    path)."""
    from nnstreamer_tpu_torch.ops import arith_chain, arith_chain_plain

    def tiled(values, reps):
        return torch.cat([values.repeat(reps), values[:37]])

    u8 = torch.arange(256, device="cuda", dtype=torch.int32)
    u16 = torch.arange(65536, device="cuda", dtype=torch.int32)
    i32 = torch.randint(-2 ** 31, 2 ** 31 - 1, (300001,), generator=gen,
                        device="cuda", dtype=torch.int32)
    i32[:4] = torch.tensor([-2 ** 31, 2 ** 31 - 1, 0, -1], device="cuda")
    f32 = torch.randn(300001, generator=gen, device="cuda") * 300.0
    f32[:8] = torch.tensor([float("inf"), float("-inf"), float("nan"), 0.0,
                            -0.0, 1e-40, 3.4e38, -3.4e38], device="cuda")
    inputs = {"uint8": tiled(u8.to(torch.uint8), 1000),
              "int8": tiled(u8.to(torch.uint8).view(torch.int8), 1000),
              "uint16": tiled(u16.to(torch.int16), 3).view(torch.uint16),
              "int16": tiled(u16.to(torch.int16), 3),
              "int32": i32, "float32": f32}
    checked, bad = 0, []
    for name, x in inputs.items():
        for out in (torch.float32, torch.bfloat16, torch.float16):
            for chain, (ops, clamp) in ARITH_CHAINS.items():
                for base in (x, x[1:]):
                    k = arith_chain(base, ops, out_dtype=out, clamp=clamp)
                    p = arith_chain_plain(base, ops, out_dtype=out,
                                          clamp=clamp)
                    checked += 1
                    if not _bits_equal(torch, k, p):
                        bad.append([name, str(out), chain,
                                    base.data_ptr() % 16,
                                    max_err(k[~torch.isnan(p.float())],
                                            p[~torch.isnan(p.float())])])
    emit("kernel", kernel="arith_chain", case="exhaustive",
         inputs={n: list(x.shape) for n, x in inputs.items()},
         outputs=["float32", "bfloat16", "float16"],
         chains=sorted(ARITH_CHAINS), calls=checked, bit_equal=not bad,
         mismatches=bad[:10])
    if bad:
        raise AssertionError(f"arith_chain not bit-equal: {bad[:10]}")


def _blocks(model, stride: int):
    """(index, H, W, folded) of the blocks with ``stride`` at SIZE (H, W:
    the block's input map)."""
    from nnstreamer_tpu_torch.ops.fused_block import fold_inverted_residual

    out, hw = [], SIZE // 2
    for i, blk in enumerate(model.blocks):
        if blk.stride == stride:
            out.append((i, hw, hw, fold_inverted_residual(blk)))
        hw = -(-hw // blk.stride)
    return out


def _block_work(B, H, W, fwc, stride: int = 1):
    """(bytes, operations) of one block: the input read once and the
    output written once in bf16, the weights once; 2 operations per
    multiply-add of the expand, depthwise and project."""
    Cin = fwc["w1"].shape[0] if "w1" in fwc else fwc["wd"].shape[1]
    Ch, Cout = fwc["wd"].shape[1], fwc["w2"].shape[1]
    Ho, Wo = -(-H // stride), -(-W // stride)
    nbytes = 2 * B * (H * W * Cin + Ho * Wo * Cout) + sum(
        v.numel() * v.element_size() for v in fwc.values())
    ops = 2.0 * B * ((H * W * Cin * Ch if "w1" in fwc else 0)
                     + Ho * Wo * (9 * Ch + Ch * Cout))
    return nbytes, ops


#: fused block, kernel against plain: both round at the same points, only
#: the order of the float32 sums differs, which flips an occasional bf16
#: rounding (1 ulp = 2^-8 relative) — allow 4
FUSED_TOL = 2.0 ** -6
#: stride-2 blocks, inverted_residual_conv (the library column, fused:xla's
#: route) against the plain version: the convolutions round each conv's
#: output to bf16 before its bias add and cuDNN sums the depthwise products
#: unrounded, two more roundings per stage than the plain version's: a few
#: bf16 ulps of values up to 8
STRIDE2_TOL = 2.0 ** -4


def _fused_row(torch, B, H, W, fw, gen, stride: int = 1, **label):
    """One block shape: the kernel against its plain version at batch B
    on random bf16 input, with its plan, registers, shared memory, CTAs
    per SM, times (kernel, profiler device, plain, the three-cuDNN-call
    chain inverted_residual_conv: the library column) and bound. Emits the
    row (phase ``kernel``, ``stride2`` for a stride-2 block, which also
    holds the cuDNN chain against the plain version at STRIDE2_TOL);
    raises if the kernel disagrees."""
    from nnstreamer_tpu_torch.ops.fused_block import (
        _plan_tiles,
        cast_folded,
        fused_inverted_residual,
        fused_kernel_attributes,
        inverted_residual_conv,
        inverted_residual_plain,
    )

    fwc = cast_folded(fw, torch.bfloat16, "cuda")
    fwx = cast_folded(fw, torch.bfloat16, "cuda", torch.bfloat16)
    Cin = fwc["w1"].shape[0] if "w1" in fwc else fwc["wd"].shape[1]
    Ch, Cout = fwc["wd"].shape[1], fwc["w2"].shape[1]
    x = torch.randn((B, H, W, Cin), generator=gen, device="cuda")
    x = x.clamp(-3, 3).to(torch.bfloat16)
    k = fused_inverted_residual(x, fwc, stride=stride)
    p = inverted_residual_plain(x, fwc, stride=stride)
    err = max_err(k, p)
    ok = k.shape == p.shape and within(k, p, FUSED_TOL, FUSED_TOL)
    plan = _plan_tiles(H, W, Cin, Ch, Cout, 2, "w1" in fwc, stride)
    row = {"kernel": "fused_inverted_residual", **label,
           "shape": [B, H, W, Cin, Ch, Cout], "stride": stride,
           "out_shape": list(k.shape), "dtype": "bfloat16",
           "max_abs_err": err, "atol": FUSED_TOL, "rtol": FUSED_TOL,
           "ok": ok, "plan": plan._asdict(),
           **fused_kernel_attributes(plan)}
    if stride == 2:
        conv = inverted_residual_conv(x, fwx, stride=2)
        row["conv_max_abs_err"] = max_err(conv, p)
        row["conv_ok"] = conv.shape == p.shape and within(
            conv, p, STRIDE2_TOL, STRIDE2_TOL)
        ok = ok and row["conv_ok"]
    row["ms"] = cuda_ms(lambda: fused_inverted_residual(x, fwc, stride=stride))
    row["device_ms"] = device_ms(
        torch, lambda: fused_inverted_residual(x, fwc, stride=stride),
        "fused_ir_")
    row["plain_ms"] = cuda_ms(
        lambda: inverted_residual_plain(x, fwc, stride=stride), reps=10,
        warmup=2)
    row["cudnn_chain_ms"] = cuda_ms(
        lambda: inverted_residual_conv(x, fwx, stride=stride))
    nbytes, ops = _block_work(B, H, W, fwc, stride)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, "bfloat16")
    row["tflops"] = ops / row["ms"] / 1e9
    emit("stride2" if stride == 2 else "kernel", **row)
    if not ok:
        raise AssertionError(f"fused block {label} at {row['shape']} "
                             f"stride {stride} disagrees: {row}")
    return row


def _add_rows(tot, by, row, keys):
    """Add one block row's times into ``tot`` (a sum with a missing term
    is None) and its bound into ``by`` (bound ms by kind)."""
    for key in keys:
        tot[key] = None if tot[key] is None or row[key] is None \
            else tot[key] + row[key]
    by[row["bound_by"]] += row["bound_ms"]


def check_fused_block(torch, results):
    from nnstreamer_tpu_torch.models.mobilenet_v2 import (
        MobileNetV2,
        init_weights,
    )
    from nnstreamer_tpu_torch.ops.fused_block import (
        _plan_tiles,
        cast_folded,
        fused_inverted_residual,
        fused_kernel_attributes,
        inverted_residual_plain,
    )

    model = MobileNetV2()
    init_weights(model, 0)
    blocks = _blocks(model, 1)
    if len(blocks) != 13:
        raise AssertionError(f"expected 13 stride-1 blocks, got {len(blocks)}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    keys = ("ms", "device_ms", "plain_ms", "cudnn_chain_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    by = {"bytes": 0.0, "operations": 0.0}  # bound ms of each kind
    errs = []
    for i, H, W, fw in blocks:
        row = _fused_row(torch, BATCH, H, W, fw, gen, block=i)
        _add_rows(tot, by, row, keys)
        errs.append(row["max_abs_err"])
    # one shape in float32 against a float32 plain version (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    i, H, W, fw = blocks[5]
    fwc = cast_folded(fw, torch.float32, "cuda")
    Cin = fwc["w1"].shape[0]
    x = torch.randn((BATCH, H, W, Cin), generator=gen, device="cuda")
    k = fused_inverted_residual(x, fwc, compute_dtype=torch.float32)
    p = inverted_residual_plain(x, fwc, compute_dtype=torch.float32)
    err = max_err(k, p)
    ok = within(k, p, 1e-4, 1e-4)
    plan = _plan_tiles(H, W, Cin, fwc["wd"].shape[1], fwc["w2"].shape[1], 4)
    emit("kernel", kernel="fused_inverted_residual", block=i,
         shape=list(x.shape), dtype="float32", max_abs_err=err, atol=1e-4,
         rtol=1e-4, ok=ok, plan=plan._asdict(),
         **fused_kernel_attributes(plan))
    if not ok:
        raise AssertionError(f"fused block f32 disagrees: {err}")
    errs.append(err)
    # a prime size: ragged row tiles, and Cout (80) across 5 fragment
    # columns; the JAX package's tiling gate would send it to XLA
    Cin, Ch, Cout = 8, 48, 80
    fw = {"w1": torch.randn((Cin, Ch), generator=gen, device="cuda") * 0.3,
          "b1": torch.randn((Ch,), generator=gen, device="cuda") * 0.2,
          "wd": torch.randn((9, Ch), generator=gen, device="cuda") * 0.3,
          "bd": torch.randn((Ch,), generator=gen, device="cuda") * 0.2,
          "w2": torch.randn((Ch, Cout), generator=gen, device="cuda") * 0.3,
          "b2": torch.randn((Cout,), generator=gen, device="cuda") * 0.2}
    fwc = cast_folded(fw, torch.bfloat16, "cuda")
    x = torch.randn((4, 113, 113, Cin), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k = fused_inverted_residual(x, fwc)
    p = inverted_residual_plain(x, fwc)
    err = max_err(k, p)
    ok = within(k, p, FUSED_TOL, FUSED_TOL)
    plan = _plan_tiles(113, 113, Cin, Ch, Cout, 2)
    emit("kernel", kernel="fused_inverted_residual", block="prime",
         shape=[4, 113, 113, Cin, Ch, Cout], dtype="bfloat16",
         max_abs_err=err, atol=FUSED_TOL, rtol=FUSED_TOL, ok=ok,
         plan=plan._asdict(), **fused_kernel_attributes(plan))
    if not ok:
        raise AssertionError(f"fused block at 113x113 disagrees: {err}")
    errs.append(err)
    emit("kernel", kernel="fused_inverted_residual", block="sum of 13",
         stride=1, **tot, max_abs_err=max(errs[:13]), bound_ms_by_kind=by)
    # the stride-2 blocks, then the sum of all 17 (the forward's launches)
    tot2, by2 = check_stride2(torch, model, gen)
    for key in keys:
        tot[key] = None if tot[key] is None or tot2[key] is None \
            else tot[key] + tot2[key]
    errs.append(tot2["max_abs_err"])
    by = {k: by[k] + by2[k] for k in by}
    # the bound is the sum of per-block bounds (each block is bound by
    # bytes or by operations on its own); bound_by names the kind that
    # holds the larger part of it
    results["fused_inverted_residual"] = {
        "ms": tot["ms"], "device_ms": tot["device_ms"],
        "plain_ms": tot["plain_ms"], "cudnn_chain_ms": tot["cudnn_chain_ms"],
        "max_abs_err": max(errs), "bound_ms": tot["bound_ms"],
        "bound_by": max(by, key=by.get), "bound_ms_by_kind": by,
        "library_ms": None}
    emit("kernel", kernel="fused_inverted_residual",
         block=f"sum of {kernel_blocks()}", **results["fused_inverted_residual"])
    check_vision_blocks(torch, results, gen)


def check_stride2(torch, model, gen):
    """The 4 stride-2 blocks of MobileNet-v2 at batch 128 through the
    kernel's stride-2 body against its plain version (rows as the kernel
    phase's, the cuDNN chain as the library column and held to the plain
    version too), their sum against the ~0.036 ms bound; then the float32
    body at every stride-2 shape of the flagship, SSD (150, 75, 38, 19:
    even and odd maps) and DeepLab (129, 65, 33: odd) at batch 2, TF32
    off, at 1e-4. SSD's and DeepLab's bf16 rows come from
    check_vision_blocks (phase stride2 too). Returns the bf16 sums and
    bound ms by kind."""
    from nnstreamer_tpu_torch.models.mobilenet_v2 import kernel_block_shapes
    from nnstreamer_tpu_torch.ops.fused_block import (
        _plan_tiles,
        _same_pads,
        cast_folded,
        fold_inverted_residual,
        fused_inverted_residual,
        fused_kernel_attributes,
        inverted_residual_plain,
    )

    blocks = _blocks(model, 2)
    if len(blocks) != 4:
        raise AssertionError(f"expected 4 stride-2 blocks, got {len(blocks)}")
    keys = ("ms", "device_ms", "plain_ms", "cudnn_chain_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    by = {"bytes": 0.0, "operations": 0.0}
    errs = []
    for i, H, W, fw in blocks:
        row = _fused_row(torch, BATCH, H, W, fw, gen, stride=2, block=i)
        _add_rows(tot, by, row, keys)
        errs.append(row["max_abs_err"])
    tot["max_abs_err"] = max(errs)
    emit("stride2", kernel="fused_inverted_residual", block="sum of 4",
         **tot, bound_ms_by_kind=by)
    # the float32 body, the checks' dtype, at every stride-2 shape
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [("mobilenet_v2", i, H, W, fw) for i, H, W, fw in blocks]
    for name in ("ssd_mobilenet", "deeplab_v3"):
        m = _vision_model(name)
        cases += [(name, i, H, W, fold_inverted_residual(m.blocks[i]))
                  for i, H, W, *_, stride in kernel_block_shapes(
                      m, VISION[name]["size"]) if stride == 2]
    bad = []
    for name, i, H, W, fw in cases:
        fwc = cast_folded(fw, torch.float32, "cuda")
        Cin = fwc["w1"].shape[0] if "w1" in fwc else fwc["wd"].shape[1]
        x = torch.randn((2, H, W, Cin), generator=gen, device="cuda")
        k = fused_inverted_residual(x, fwc, stride=2,
                                    compute_dtype=torch.float32)
        p = inverted_residual_plain(x, fwc, stride=2,
                                    compute_dtype=torch.float32)
        ok = k.shape == p.shape and within(k, p, 1e-4, 1e-4)
        plan = _plan_tiles(H, W, Cin, fwc["wd"].shape[1], fwc["w2"].shape[1],
                           4, "w1" in fwc, 2)
        row = {"kernel": "fused_inverted_residual", "model": name,
               "block": i, "shape": [2, H, W, Cin, fwc["wd"].shape[1],
                                     fwc["w2"].shape[1]], "stride": 2,
               "pads": [_same_pads(H, 2, 3), _same_pads(W, 2, 3)],
               "dtype": "float32", "max_abs_err": max_err(k, p),
               "atol": 1e-4, "rtol": 1e-4, "ok": ok, "plan": plan._asdict(),
               **fused_kernel_attributes(plan)}
        emit("stride2", **row)
        if not ok:
            bad.append(row)
    if bad:
        raise AssertionError(f"fused block float32 stride 2 disagrees: {bad}")
    return tot, by


# -- phase: the flagship slice ---------------------------------------------

def _labeling_line(labels: str, model: str, custom: str) -> str:
    return (
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=1000/1 "
        f"! tensor_converter frames-per-tensor={BATCH} "
        f"! tensor_filter name=f framework=jax model={model} "
        f"custom={custom} fetch-window={FETCH_WINDOW} "
        f"! queue ! tensor_decoder mode=image_labeling option1={labels} "
        f"! tensor_sink name=out")


def _flagship(labels: str, fused: str = "pallas") -> str:
    return _labeling_line(labels, "mobilenet_v2",
                          f"seed:0,postproc:argmax,fused:{fused}")


def _drive(line, frames, n_batches, traced=False, spans=False):
    """Push n_batches of frames through a labeling line; returns
    (labels per batch, seconds, p50 batch latency ms, pipeline).
    ``traced`` attaches a tracer (aggregate counters; with ``spans``, the
    span ring too)."""
    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.pipeline import parse_launch

    p = parse_launch(line)
    if traced:
        trace.attach(p, spans=spans)
    pushed, arrived = {}, {}
    p["out"].connect_new_data(
        lambda b: arrived.__setitem__(b.pts, time.perf_counter()))
    p.play()
    t0 = time.perf_counter()
    for i in range(n_batches * BATCH):
        p["src"].push_buffer(Buffer(tensors=[frames[i % len(frames)]], pts=i))
        pushed[i] = time.perf_counter()
    p["src"].end_of_stream()
    if not p.bus.wait_eos(600):
        raise TimeoutError("labeling line did not reach EOS")
    secs = time.perf_counter() - t0
    if p.bus.error is not None:
        raise RuntimeError(f"labeling line failed: {p.bus.error.data}")
    lat = [(arrived[k] - pushed[k]) * 1e3 for k in arrived]
    out = [b.meta["label"] for b in p["out"].collected]
    return out, secs, statistics.median(lat), p


def check_slice(torch, results, workdir):
    import numpy as np

    from nnstreamer_tpu_torch.models import get_model, preprocess_frames
    from nnstreamer_tpu_torch.models.mobilenet_v2 import _make_fused_apply
    from nnstreamer_tpu_torch.ops import _cuda

    labels = os.path.join(workdir, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    # frames of 4x4 blocks of flat colour, so they differ in content
    rng = np.random.default_rng(0)
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(BATCH)]
    results["flag_labels"], results["flag_frames"] = labels, frames
    # warm-up run (cuDNN/cuBLAS plans, allocator) — not the measured one
    _, _, _, p = _drive(_flagship(labels), frames, 2)
    p.stop()
    _cuda.reset_launches()
    out, secs, p50, p = _drive(_flagship(labels), frames, N_BATCHES)
    launches = dict(_cuda.LAUNCHES)
    forward = p["f"].fw._bundle.apply_fn  # the filter's own forward
    module = p["f"].fw._bundle.module
    p.stop()
    n_frames = sum(len(b) for b in out)
    if len(out) != N_BATCHES or n_frames != N_BATCHES * BATCH:
        raise AssertionError(f"expected {N_BATCHES * BATCH} labels, got "
                             f"{n_frames} in {len(out)} buffers")
    names = {f"class{i}" for i in range(1001)}
    if not all(lab in names for b in out for lab in b):
        raise AssertionError("a label is not from the labels file")
    if launches["fused_inverted_residual"] != kernel_blocks() * N_BATCHES or \
            launches["normalize_u8"] != N_BATCHES:
        raise AssertionError(f"launch counts per {N_BATCHES} forwards: "
                             f"{launches}")
    results["launches"] = launches
    # the filter's logits for one batch against the same folded forward
    # with the kernel's plain version in its place (mode 'plain'), on the
    # filter's own weights; the fused:xla forward (every block through the
    # convolutions, the JAX package's fused:xla) is compared with it too,
    # reported and not held to the kernel's tolerance: it rounds
    # differently in all 17 blocks, which random weights amplify
    x = torch.from_numpy(np.stack(frames)).cuda()
    with torch.inference_mode():
        got = forward(x).float()
        pre = preprocess_frames(x, "pm1", module.dtype)
        plain = _make_fused_apply(module, mode="plain")(pre).float()
        xla = get_model("mobilenet_v2", {"seed": "0", "fused": "xla"},
                        "cuda").apply_fn(x).float()
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got).all())
    ok = finite and within(got, plain, 0.15, 0.05)
    results["flag_classes"] = got.argmax(-1).tolist()
    xla_agree = float((xla.argmax(-1) == plain.argmax(-1)).float().mean())
    agree = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    emit("slice", frames=n_frames, batches=len(out), seconds=secs,
         fps=n_frames / secs, p50_batch_latency_ms=p50,
         fetch_window=FETCH_WINDOW, launches=launches,
         logits_max_abs_err=max_err(got, plain), logits_atol=0.15,
         logits_rtol=0.05, logits_ok=ok, argmax_agreement=agree,
         xla_logits_max_abs_err=max_err(xla, plain),
         xla_argmax_agreement=xla_agree,
         distinct_labels=len({lab for b in out for lab in b}),
         card=results["card"])
    if not ok:
        raise AssertionError("filter logits disagree with the plain forward")
    profile_slice(torch, labels, frames)
    profile_forward(torch, forward, x)


def profile_slice(torch, labels, frames, n_batches: int = 4) -> None:
    """One more run of the line under torch.profiler."""
    def run():
        _, secs, _, p = _drive(_flagship(labels), frames, n_batches)
        p.stop()
        return secs

    emit("profile", line="flagship", batches=n_batches,
         **device_profile(torch, run))


def profile_forward(torch, forward, x, n: int = 4) -> None:
    """The flagship's forward alone (the filter's own apply on one batch of
    frames already on the card, no pipeline around it) n times under
    torch.profiler: device time by kind, the fused block's device ms by
    body (stride 1, stride 2; each forward launches it kernel_blocks()
    times) and a forward's device ms (busy / n)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        forward(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                forward(x)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    stats = profile_stats(torch, prof, secs)
    fused, count = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"fused_ir_(?:tc_kernel<\d+, \d+, (\d)>|fma_kernel)",
                      e.key)
        if m:
            body = f"stride{m.group(1)}" if m.group(1) else "float32"
            us = getattr(e, "self_device_time_total", 0) or 0
            fused[body] = fused.get(body, 0.0) + us / 1e3
            count[body] = count.get(body, 0) + e.count
    busy = stats["device_busy_ms"]
    emit("profile", line="flagship_forward", forwards=n,
         batch=int(x.shape[0]), fused_block_ms=fused,
         fused_block_launches=count, kernel_blocks=kernel_blocks(),
         forward_device_ms=busy / n if busy else None, **stats)


def device_profile(torch, run) -> dict:
    """Device time by kernel name and the device's idle share over the wall
    time ``run()`` returns (first push to the last output). Device times
    are null when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        secs = run()
    return profile_stats(torch, prof, secs)


def profile_stats(torch, prof, secs: float) -> dict:
    """:func:`device_profile`'s numbers from a finished profiler over a
    run of ``secs`` seconds."""
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or 0
        by_name[e.key] = by_name.get(e.key, 0) + us
    busy_ms = sum(by_name.values()) / 1e3
    wall_ms = secs * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    elementwise = sum(v for k, v in by_name.items() if "elementwise" in k)
    kinds = {}
    for k, v in by_name.items():
        kinds[_device_kind(k)] = kinds.get(_device_kind(k), 0.0) + v / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
            "elementwise_ms": elementwise / 1e3 if busy_ms else None,
            "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
            "by_kind_ms": kinds,
            "top_device": [{"name": k[:90], "ms": v / 1e3} for k, v in top]}


def _device_kind(name: str) -> str:
    """A device item's kind, by its name: this package's kernels, copies,
    convolutions (cuDNN's forward, data- and weight-gradient kernels),
    GEMMs, reductions, elementwise work, the rest."""
    low = name.lower()
    if any(k in low for k in ("fused_ir", "normalize_u8", "arith_chain",
                              "flash_")):
        return "package_kernels"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("conv", "fprop", "dgrad", "wgrad")):
        return "convolution"
    if "gemm" in low or "cutlass" in low:
        return "gemm"
    if "reduce" in low:
        return "reduction"
    if "elementwise" in low or "copy_kernel" in low:
        return "elementwise"
    return "other"


def check_transform(torch, results):
    import numpy as np

    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    line = (f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
            f"height={SIZE},framerate=1000/1 "
            f"! tensor_converter frames-per-tensor={BATCH} "
            "! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 "
            "acceleration=device ! tensor_sink name=out")
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (2 * BATCH, SIZE, SIZE, 3), np.uint8)
    p = parse_launch(line)
    _cuda.reset_launches()
    p.play()
    for f in frames:
        p["src"].push_buffer(Buffer(tensors=[f]))
    p["src"].end_of_stream()
    if not p.bus.wait_eos(300) or p.bus.error is not None:
        raise RuntimeError(f"transform line failed: {p.bus.error}")
    launches = _cuda.LAUNCHES["arith_chain"]
    got = [np.asarray(b.tensors[0]) for b in p["out"].collected]
    p.stop()
    want = [(frames[i:i + BATCH].astype(np.float32) + -127.5) / 127.5
            for i in range(0, len(frames), BATCH)]
    equal = len(got) == len(want) and all(
        np.array_equal(g, w) for g, w in zip(got, want))
    emit("transform", buffers=len(got), bit_equal_numpy=equal,
         arith_chain_launches=launches)
    if not equal or launches < 1:
        raise AssertionError("transform line: not bit-equal or no launch")
    results["arith_launches"] = launches


# -- phase: the attention kernel against its plain version -----------------

#: |kernel - plain| <= ATTN_TOL + ATTN_TOL * |plain|: both round p to bf16
#: at the same running max (the same key blocks, key_block) and the
#: output once; only the order of the float32 sums and exp's last bits
#: differ, which can flip a bf16 rounding of p or of the output (1 ulp =
#: 2^-8 relative) — allow 4
ATTN_TOL = 2.0 ** -6

#: the long-context line (examples/long_context.py) at the repo's causal
#: 8x8192x128 attention shape: head_dim 1024 / 8 = 128
STREAM = {"seq": 8192, "feat": 64, "dim": 1024, "depth": 4, "heads": 8}
STREAM_CHUNK = 512
#: the same line at head_dim 256 (1024 / 4), the tensor-core body's widest
#: D, a common head width of public models; its windows after one warm-up
STREAM_HD256 = {**STREAM, "heads": 4}
STREAM_HD256_WINDOWS = 4
#: ViT-S/16 (bench_suite.py, tools/mfu_table.py), depth 6
VIT = {"size": SIZE, "patch": 16, "depth": 6, "dim": 384, "heads": 6,
       "classes": 1000}
N_WARMUP = 2
#: model outputs against the plain-attention instance on the same weights:
#: the JAX package's bf16 tolerance for logits
#: (tests/test_fused_block.py::test_model_zoo_fused_custom)
MODEL_ATOL, MODEL_RTOL = 0.15, 0.05
#: least share of ViT frames whose argmax must agree with the plain twin:
#: random weights leave near-ties that a reordered float32 sum can flip
VIT_ARGMAX_FLOOR = 0.95


def _custom(cfg: dict) -> str:
    return ",".join(f"{k}:{v}" for k, v in cfg.items())


#: float32 attention, kernel against plain at the same 128-key blocks:
#: both products in float32 (the plain version's matmul with TF32 off),
#: only the order of the sums and exp's last bits differ
F32_ATOL = F32_RTOL = 2e-5
#: head dims of every kind: 8 and 16 the reference's ring and Ulysses
#: tests (16 also the tensor-core body's D 16), multiples of 8 and odd
#: widths that only the simple body takes in bf16 (its odd q row stride,
#: a partial 32-column K stage, V rows at stride d), and the largest the
#: kernels take
WIDE_DIMS = (1, 8, 16, 20, 24, 33, 48, 96, 100, 200, 256)
#: one timed shape for each instantiation the bf16 main-path shapes do
#: not reach (causal 8 heads x 4096, half the stream line's length): the
#: tensor-core body at D 16 (bf16, d 16), the simple body at D 32, 64, 128
#: and 256 (float32)
TIMED_WIDE = ((16, "bfloat16"), (32, "float32"), (64, "float32"),
              (128, "float32"), (256, "float32"))


def attention_work(bh: int, sq: int, sk: int, d: int, causal: bool,
                   q_offset: int = 0, k_offset: int = 0,
                   carries: bool = False, itemsize: int = 2):
    """(bytes, operations) one attention call needs: 4*d operations (two
    products) per (q, k) pair the mask keeps, at the global positions
    q_offset + i >= k_offset + j; q, k, v read once in their dtype
    (``itemsize`` bytes) and either o written once in it (a flash call)
    or, for a chunk update (``carries``), the float32 carries m, l, acc
    read and written once. A chunk no row sees needs nothing: its carries
    pass through."""
    import numpy as np

    if causal:
        pairs = int(np.clip(q_offset - k_offset + 1 + np.arange(sq), 0,
                            sk).sum())
    else:
        pairs = sq * sk
    if not carries:
        return itemsize * bh * d * (2 * sq + 2 * sk), 4.0 * bh * d * pairs
    if pairs == 0:
        return 0.0, 0.0
    return (bh * (itemsize * d * (sq + 2 * sk) + 8.0 * sq * (2 + d)),
            4.0 * bh * d * pairs)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tols(torch, dtype):
    return (ATTN_TOL, ATTN_TOL) if dtype == torch.bfloat16 else (F32_ATOL,
                                                                 F32_RTOL)


def check_attention(torch, results):
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops.attention import (
        flash_attention_cuda,
        flash_attention_plain,
        flash_kernel_attributes,
        key_block,
    )

    # float32 products in float32 on both sides: the plain version's
    # matmul (and SDPA's, timed only) with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    hd = STREAM["dim"] // STREAM["heads"]
    vit_hd = VIT["dim"] // VIT["heads"]
    vit_tokens = (SIZE // VIT["patch"]) ** 2 + 1
    bf16, f32 = torch.bfloat16, torch.float32
    # (case, q shape, key length, causal, dtype, timed, on a main path)
    cases = [("stream", (STREAM["heads"], STREAM["seq"], hd), None, True,
              bf16, True, True),
             ("vit", (BATCH * VIT["heads"], vit_tokens, vit_hd), None, False,
              bf16, True, True),
             # the head_dim 256 stream line's shape: timed apart from the
             # main-path sum, which keeps the shapes of earlier rows
             ("stream_hd256", (STREAM_HD256["heads"], STREAM_HD256["seq"],
                               STREAM_HD256["dim"] // STREAM_HD256["heads"]),
              None, True, bf16, True, False),
             ("ragged", (3, 1000, 32), None, True, bf16, False, False),
             ("ragged64", (4, 777, 64), None, True, bf16, False, False),
             ("noncausal128", (2, 333, 128), None, False, bf16, False,
              False),
             # float32 at the reference's kernel tests (tests/test_ops.py)
             ("ref_f32", (2, 64, 128), None, False, f32, False, False),
             ("ref_f32_causal", (2, 64, 128), None, True, f32, False, False),
             ("ref_f32_lead", (2, 3, 32, 128), None, False, f32, False,
              False)]
    cases += [(f"timed_{dt}_d{d}", (8, 4096, d), None, True,
               getattr(torch, dt), True, False) for d, dt in TIMED_WIDE]
    for d in WIDE_DIMS:
        for dtype in (bf16, f32):
            cases += [(f"d{d}_causal", (3, 300, d), None, True, dtype, False,
                       False),
                      (f"d{d}_unequal", (2, 257, d), 130, False, dtype,
                       False, False)]
    tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bytes": 0.0, "ops": 0.0, "err": 0.0}
    for case, shape, sk, causal, dtype, timed, main in cases:
        *lead, s, d = shape
        kshape = (*lead, sk or s, d)
        q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(kshape, generator=gen, device="cuda").to(dtype)
                for _ in range(2))

        def kern():
            return flash_attention_cuda(q, k, v, causal=causal)

        def plain():
            return flash_attention_plain(q, k, v, causal=causal)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max_err(got, want)
        atol, rtol = _tols(torch, dtype)
        ok = (got.dtype == dtype and bool(torch.isfinite(got.float()).all())
              and within(got, want, atol, rtol))
        row = {"kernel": "flash_attention", "case": case,
               "shape": list(shape), "sk": kshape[-2], "causal": causal,
               "dtype": _dtype_name(dtype), "block_k": key_block(d, dtype),
               "max_abs_err": err, "atol": atol, "rtol": rtol, "ok": ok,
               **flash_kernel_attributes(d, dtype=dtype)}
        if timed:
            def library():
                return F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=causal)

            bh = shape[0]
            nbytes, ops = attention_work(bh, s, kshape[-2], d, causal,
                                         itemsize=q.element_size())
            row["ms"] = cuda_ms(kern)
            row["device_ms"] = device_ms(torch, kern, "flash_fwd")
            row["plain_ms"] = cuda_ms(plain, reps=5, warmup=1)
            row["library_ms"] = cuda_ms(library)
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, ops, _dtype_name(dtype))
            row["tflops"] = ops / row["ms"] / 1e9
            if main:
                for key in ("ms", "device_ms", "plain_ms", "library_ms"):
                    tot[key] = None if tot[key] is None or row[key] is None \
                        else tot[key] + row[key]
                tot["bytes"] += nbytes
                tot["ops"] += ops
        emit("attention", **row)
        if not ok:
            raise AssertionError(f"flash_attention disagrees: {row}")
        tot["err"] = max(tot["err"], err)
        if case == "stream_hd256":
            results["flash_attention_hd256"] = {key: row[key] for key in (
                "shape", "block_k", "max_abs_err", "ms", "device_ms",
                "plain_ms", "library_ms", "bound_ms", "bound_by")}
    b_ms, b_by = bound_ms(tot["bytes"], tot["ops"], "bfloat16")
    results["flash_attention"] = {
        "ms": tot["ms"], "device_ms": tot["device_ms"],
        "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
        "max_abs_err": tot["err"], "bound_ms": b_ms, "bound_by": b_by}


def _plain_twin(module, cls, cfg):
    """A second instance of the filter's model with the kernel's plain
    version as its attention, on the same weights: the oracle."""
    from nnstreamer_tpu_torch.ops.attention import flash_attention_plain

    # the plain version at each call's own key block (key_block)
    twin = cls(**cfg, attention=flash_attention_plain)
    twin.load_state_dict(module.state_dict())
    return twin.to("cuda").eval()


# -- phase: the long-context stream line -----------------------------------

def _stream_line(cfg=STREAM) -> str:
    feat, seq = cfg["feat"], cfg["seq"]
    return (f"appsrc name=src caps=other/tensors,format=static,"
            f"dimensions={feat}:{STREAM_CHUNK},types=float32 "
            f"! tensor_aggregator name=agg frames_in={STREAM_CHUNK} "
            f"frames_out={seq} "
            f"frames_dim=1 ! tensor_filter name=f framework=jax "
            f"model=stream_transformer custom=seed:0,{_custom(cfg)} "
            f"! tensor_sink name=out")


class _LineDriver:
    """A launch line, open across its runs: each unit is a list of
    buffers (a window's chunks, a batch's frames) whose push yields
    ``outputs_per_unit`` buffers at the sink; :meth:`run` pushes whole
    units and waits for their outputs. ``spans`` attaches a span tracer
    now; :meth:`attach` does it between runs (after a warm-up)."""

    def __init__(self, line, chunks, outputs_per_unit=1, spans=False):
        from nnstreamer_tpu_torch import trace
        from nnstreamer_tpu_torch.pipeline import parse_launch

        self.chunks = chunks
        self.per_unit = outputs_per_unit
        self.p = parse_launch(line)
        self.arrived = []
        self.p["out"].connect_new_data(
            lambda b: self.arrived.append(time.perf_counter()))
        if spans:
            trace.attach(self.p, spans=True)
        self.p.play()
        self.pts = 0

    def attach(self):
        from nnstreamer_tpu_torch import trace

        return trace.attach(self.p, spans=True)

    def run(self, n_units: int):
        """Push n_units units; returns (seconds from the first push to
        the last output, p50 ms from a unit's last push to its output)."""
        from nnstreamer_tpu_torch.buffer import Buffer

        start = len(self.arrived)
        last_push = []
        t0 = time.perf_counter()
        for _ in range(n_units):
            for c in self.chunks:
                self.p["src"].push_buffer(Buffer(tensors=[c], pts=self.pts))
                self.pts += 1
            last_push.append(time.perf_counter())
        want = start + n_units * self.per_unit
        deadline = time.monotonic() + 600
        while len(self.arrived) < want:
            if self.p.bus.error is not None:
                raise RuntimeError(f"line failed: {self.p.bus.error.data}")
            if time.monotonic() > deadline:
                raise TimeoutError("line: outputs did not arrive")
            time.sleep(0.001)
        secs = self.arrived[-1] - t0
        ends = self.arrived[start + self.per_unit - 1::self.per_unit]
        lat = [(a - b) * 1e3 for a, b in zip(ends, last_push)]
        return secs, statistics.median(lat)

    def close(self):
        self.p["src"].end_of_stream()
        if not self.p.bus.wait_eos(120) or self.p.bus.error is not None:
            raise RuntimeError(f"line failed at EOS: {self.p.bus.error}")
        outs = [b.tensors[0] for b in self.p["out"].collected]
        self.p.stop()
        return outs


class _StreamDriver(_LineDriver):
    """The stream line: one unit is one window's 512-frame chunks."""

    def __init__(self, window, spans=False, cfg=STREAM):
        super().__init__(_stream_line(cfg),
                         [window[i:i + STREAM_CHUNK]
                          for i in range(0, len(window), STREAM_CHUNK)],
                         spans=spans)


def check_stream(torch, results):
    import numpy as np

    from nnstreamer_tpu_torch.models.vit import StreamTransformer
    from nnstreamer_tpu_torch.ops import _cuda

    seq, feat = STREAM["seq"], STREAM["feat"]
    window = np.random.default_rng(3).normal(
        size=(seq, feat)).astype(np.float32)
    drv = _StreamDriver(window)
    drv.run(N_WARMUP)
    _cuda.reset_launches()
    secs, p50 = drv.run(N_BATCHES)
    launches = dict(_cuda.LAUNCHES)
    if launches["flash_attention"] != STREAM["depth"] * N_BATCHES:
        raise AssertionError(f"stream: launch counts per {N_BATCHES} "
                             f"forwards: {launches}")
    results["stream_launches"] = launches
    prof = device_profile(torch, lambda: drv.run(N_WARMUP)[0])
    bundle = drv.p["f"].fw._bundle  # the filter's own model
    results["stream_module"], results["stream_window"] = bundle.module, window
    outs = drv.close()
    # the filter's forward on one window against the plain-attention twin
    twin = _plain_twin(bundle.module, StreamTransformer, STREAM)
    x = torch.from_numpy(window).cuda()
    with torch.inference_mode():
        got = bundle.apply_fn(x).float()
        want = twin(x[None]).float()
    torch.cuda.synchronize()
    last = np.asarray(outs[-1])
    finite = bool(torch.isfinite(got).all()) and bool(np.isfinite(last).all())
    ok = (finite and tuple(got.shape) == (1, seq, feat)
          and last.shape == (1, seq, feat)
          and within(got, want, MODEL_ATOL, MODEL_RTOL))
    emit("stream", windows=N_BATCHES, frames=N_BATCHES * seq, seconds=secs,
         windows_per_s=N_BATCHES / secs, frames_per_s=N_BATCHES * seq / secs,
         p50_window_latency_ms=p50, launches=launches,
         out_max_abs_err=max_err(got, want), out_atol=MODEL_ATOL,
         out_rtol=MODEL_RTOL, out_ok=ok, finite=finite,
         outputs=len(outs), card=results["card"])
    emit("profile", line="stream", windows=N_WARMUP, **prof)
    if not ok:
        raise AssertionError("stream output disagrees with the plain "
                             "forward or is not finite")


# -- phase: the ring's chunk kernel against its plain version --------------

#: the stream line's attention (causal 8x8192x128) over an sp=4 mesh on the
#: one card: 4 shards of 2048, 16 chunk launches per ring call, 4 on the
#: diagonal, 6 in the past and 6 in the masked future
SP = 4
#: chunk carries, kernel against plain from the same carries: m is a max of
#: float32 dot products of 128 bf16 pairs summed in another order, so it
#: moves by a few float32 ulps of those sums; l sums the same float32 exps
#: in another order, at an m that moved by that much: both far inside
#: 1e-4. acc / l, the hop's output, is held at ATTN_TOL, as the flash kernel
CHUNK_M_ATOL = 1e-4
CHUNK_L_RTOL = 1e-4
#: ring (or Ulysses) against flash_attention_cuda on the same q/k/v: the ring
#: folds a row's keys in another order (its diagonal chunk first, then the
#: earlier ones), so every p is rounded to bf16 at another running max, not
#: only a few: |Δ| <= 2^-9 max|v| (p's rounding) + 2 bf16 ulps of the output;
#: 2^-5 absolute and relative holds that with room for max|v| up to 8
XCHECK_TOL = 2.0 ** -5


def _carries(torch, bh, sq, d):
    return (torch.full((bh, sq), -1e30, device="cuda"),
            torch.zeros((bh, sq), device="cuda"),
            torch.zeros((bh, sq, d), device="cuda"))


def check_chunk(torch, results):
    from nnstreamer_tpu_torch.ops.attention import (
        flash_chunk_cuda,
        flash_chunk_plain,
        flash_kernel_attributes,
        key_block,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    bh, n = STREAM["heads"], STREAM["seq"] // SP
    d = STREAM["dim"] // STREAM["heads"]
    bh2 = STREAM_HD256["heads"]
    d2 = STREAM_HD256["dim"] // bh2
    bf16, f32 = torch.bfloat16, torch.float32

    # (case, q/k/v/earlier-chunk shapes, q_offset, k_offset, causal, dtype,
    # timed): the ring's shard 2 at its hops, on carries from an earlier hop
    # over a past chunk, so they are non-zero, at head_dim 128 and at the
    # head_dim 256 line's shard; then two ragged causal cases,
    # the second with its first q tiles wholly before the chunk; then every
    # hop at every head dim of WIDE_DIMS in both dtypes, ragged: the
    # diagonal, a past chunk, one whose first rows see none of it, and one
    # wholly in the future
    cases = [("diagonal", (bh, n, n, d), 2 * n, 2 * n, True, bf16, True),
             ("past", (bh, n, n, d), 2 * n, n, True, bf16, True),
             ("future", (bh, n, n, d), 2 * n, 3 * n, True, bf16, True),
             ("noncausal", (bh, n, n, d), 2 * n, n, False, bf16, True),
             ("hd256_diagonal", (bh2, n, n, d2), 2 * n, 2 * n, True, bf16,
              True),
             ("hd256_past", (bh2, n, n, d2), 2 * n, n, True, bf16, True),
             ("hd256_future", (bh2, n, n, d2), 2 * n, 3 * n, True, bf16,
              True),
             ("ragged", (3, 1000, 1000, 32), 1000, 700, True, bf16, False),
             ("ragged_head", (3, 1000, 1000, 32), 0, 300, True, bf16, False)]
    for hd in WIDE_DIMS:
        for dtype in (bf16, f32):
            name = f"{_dtype_name(dtype)}_d{hd}"
            cases += [(f"{name}_diagonal", (3, 300, 300, hd), 300, 300, True,
                       dtype, False),
                      (f"{name}_past", (3, 300, 300, hd), 600, 0, True, dtype,
                       False),
                      (f"{name}_masked", (3, 300, 300, hd), 0, 150, True,
                       dtype, False),
                      (f"{name}_future", (3, 300, 300, hd), 0, 300, True,
                       dtype, False)]
    rows = {}
    for case, (b, sq, sk, hd), q_off, k_off, causal, dtype, timed in cases:
        q, k, v, k0, v0 = (torch.randn((b, s, hd), generator=gen,
                                       device="cuda").to(dtype)
                           for s in (sq, sk, sk, sk, sk))
        scale = 1.0 / hd ** 0.5
        kw = dict(q_offset=q_off, k_offset=k_off, causal=causal, scale=scale)
        carries = flash_chunk_plain(
            q, k0, v0, *_carries(torch, b, sq, hd), q_offset=q_off,
            k_offset=q_off - sk if causal else 0, causal=causal, scale=scale)
        before = [c.clone() for c in carries]
        got = flash_chunk_cuda(q, k, v, *[c.clone() for c in carries], **kw)
        want = flash_chunk_plain(q, k, v, *carries, **kw)
        torch.cuda.synchronize()
        out_got, out_want = (c[2] / c[1].clamp(min=1e-37)[..., None]
                             for c in (got, want))
        err = max_err(out_got, out_want)
        m_err = max_err(got[0], want[0])
        l_rel = float(((got[1] - want[1]).abs()
                       / want[1].abs().clamp(min=1e-30)).max())
        finite = all(bool(torch.isfinite(c).all()) for c in got)
        atol, rtol = _tols(torch, dtype)
        m_atol, l_rtol = ((CHUNK_M_ATOL, CHUNK_L_RTOL) if dtype == bf16
                          else (F32_ATOL, F32_RTOL))
        future = case.endswith("future")
        if future:
            same = all(torch.equal(g.view(torch.int32), c.view(torch.int32))
                       for g, c in zip(got, before))
            ok = same and all(torch.equal(w, c) for w, c in zip(want, before))
        else:
            ok = (finite and within(out_got, out_want, atol, rtol)
                  and m_err <= m_atol and l_rel <= l_rtol)
        row = {"kernel": "flash_chunk", "case": case, "shape": [b, sq, sk, hd],
               "q_offset": q_off, "k_offset": k_off, "causal": causal,
               "dtype": _dtype_name(dtype), "block_k": key_block(hd, dtype),
               "max_abs_err": err, "atol": atol, "rtol": rtol,
               "m_max_abs_err": m_err, "m_atol": m_atol,
               "l_max_rel_err": l_rel, "l_rtol": l_rtol, "ok": ok,
               **flash_kernel_attributes(hd, carry=True, dtype=dtype)}
        if future:
            row["bit_identical"] = ok
        if timed:
            work = [c.clone() for c in carries]

            def kern():
                return flash_chunk_cuda(q, k, v, *work, **kw)

            row["ms"] = cuda_ms(kern)
            row["device_ms"] = device_ms(torch, kern, "flash_chunk")
            row["plain_ms"] = cuda_ms(lambda: flash_chunk_plain(
                q, k, v, *carries, **kw), reps=5, warmup=1)
            nbytes, ops = attention_work(b, sq, sk, hd, causal, q_off, k_off,
                                         carries=True,
                                         itemsize=q.element_size())
            row["bytes"], row["ops"] = nbytes, ops
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, ops, _dtype_name(dtype))
            row["tflops"] = ops / row["ms"] / 1e9
            row["library_ms"] = None
        emit("chunk", **row)
        if not ok:
            raise AssertionError(f"flash_chunk disagrees: {row}")
        rows[case] = row
    # the kernels line: one ring call's 16 hops at the stream shape (a
    # future hop's device time is its CTAs' early return; the profiler may
    # see none of it, and the sum is then null)
    hops = {"diagonal": SP, "past": SP * (SP - 1) // 2,
            "future": SP * (SP - 1) // 2}
    for key, prefix in (("flash_chunk", ""), ("flash_chunk_hd256", "hd256_")):
        tot = {k: sum(rows[prefix + c][k] * n_hops
                      for c, n_hops in hops.items())
               for k in ("ms", "plain_ms", "bytes", "ops")}
        dev = [rows[prefix + c]["device_ms"] for c in hops]
        b_ms, b_by = bound_ms(tot["bytes"], tot["ops"], "bfloat16")
        results[key] = {
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "library_ms": None,
            "device_ms": None if None in dev else sum(
                x * n_hops for x, n_hops in zip(dev, hops.values())),
            "max_abs_err": max(r["max_abs_err"] for c, r in rows.items()
                               if c.startswith(prefix)),
            "bound_ms": b_ms, "bound_by": b_by, "hops": hops,
            "shape": rows[prefix + "diagonal"]["shape"],
            "block_k": rows[prefix + "diagonal"]["block_k"]}


# -- phase: sequence-parallel attention over an sp mesh on the card --------

def check_ring(torch, results):
    import functools

    import torch.nn.functional as F

    from nnstreamer_tpu_torch.models.vit import StreamTransformer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.ops.attention import (
        flash_attention_cuda,
        ring_attention,
        ring_attention_plain,
        ulysses_attention,
    )
    from nnstreamer_tpu_torch.parallel import make_mesh

    mesh = make_mesh(sp=SP, devices=[torch.device("cuda", 0)] * SP)
    gen = torch.Generator(device="cuda").manual_seed(6)
    bh, s = STREAM["heads"], STREAM["seq"]
    d = STREAM["dim"] // STREAM["heads"]
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))

    def ring():
        return ring_attention(q, k, v, mesh, "sp", causal=True)

    def plain():
        return ring_attention_plain(q, k, v, mesh, "sp", causal=True)

    def flash():
        return flash_attention_cuda(q, k, v, causal=True)

    def ulysses():
        return ulysses_attention(q[None], k[None], v[None], mesh, "sp",
                                 causal=True)

    def library():
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              is_causal=True)

    _cuda.reset_launches()
    got = ring()
    torch.cuda.synchronize()
    ring_launches = dict(_cuda.LAUNCHES)
    _cuda.reset_launches()
    uly = ulysses()[0]
    torch.cuda.synchronize()
    uly_launches = dict(_cuda.LAUNCHES)
    want, ref = plain(), flash()
    torch.cuda.synchronize()
    err = max_err(got, want)
    ok = bool(torch.isfinite(got.float()).all()) and within(
        got, want, ATTN_TOL, ATTN_TOL)
    x_ok = within(got, ref, XCHECK_TOL, XCHECK_TOL)
    u_ok = within(uly, ref, XCHECK_TOL, XCHECK_TOL)
    counts_ok = (ring_launches["flash_chunk"] == SP * SP
                 and ring_launches["flash_attention"] == 0
                 and uly_launches["flash_attention"] == SP
                 and uly_launches["flash_chunk"] == 0)
    row = {"shape": [bh, s, d], "causal": True, "dtype": "bfloat16",
           "sp": SP, "devices": [str(dv) for dv in mesh.axis_devices("sp")],
           "max_abs_err_vs_plain_ring": err, "atol": ATTN_TOL,
           "rtol": ATTN_TOL, "ok": ok,
           "max_abs_err_vs_flash": max_err(got, ref),
           "ulysses_max_abs_err_vs_flash": max_err(uly, ref),
           "ulysses_bit_equal_flash": bool(torch.equal(uly, ref)),
           "xcheck_tol": XCHECK_TOL, "xcheck_ok": x_ok and u_ok,
           "ring_launches": ring_launches, "ulysses_launches": uly_launches,
           "ring_ms": cuda_ms(ring, reps=10),
           "plain_ring_ms": cuda_ms(plain, reps=1, warmup=1),
           "ulysses_ms": cuda_ms(ulysses, reps=10),
           "flash_ms": cuda_ms(flash, reps=10),
           "sdpa_ms": cuda_ms(library, reps=10), "card": results["card"]}
    emit("ring", **row)
    if not (ok and x_ok and u_ok and counts_ok):
        raise AssertionError(f"ring/ulysses: {row}")

    def five_rings():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            ring()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    emit("profile", line="ring", calls=5, **device_profile(torch, five_rings))

    # the stream transformer at full width with the ring as its attention,
    # on the filter's own weights, against the filter's (flash) forward
    flash_model = results["stream_module"]
    ring_model = StreamTransformer(**STREAM, attention=functools.partial(
        ring_attention, mesh=mesh, axis_name="sp"))
    ring_model.load_state_dict(flash_model.state_dict())
    ring_model = ring_model.to("cuda").eval()
    x = torch.from_numpy(results["stream_window"]).cuda()[None]
    with torch.inference_mode():
        want = flash_model(x).float()
        _cuda.reset_launches()
        got = ring_model(x).float()
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        ring_fwd_ms = cuda_ms(lambda: ring_model(x), reps=5, warmup=1)
        flash_fwd_ms = cuda_ms(lambda: flash_model(x), reps=5, warmup=1)
    ok = (bool(torch.isfinite(got).all())
          and tuple(got.shape) == (1, STREAM["seq"], STREAM["feat"])
          and within(got, want, MODEL_ATOL, MODEL_RTOL))
    emit("ring", model="stream_transformer", sp=SP, launches=launches,
         out_max_abs_err=max_err(got, want), out_atol=MODEL_ATOL,
         out_rtol=MODEL_RTOL, out_ok=ok, ring_forward_ms=ring_fwd_ms,
         flash_forward_ms=flash_fwd_ms, card=results["card"])
    if not ok or launches["flash_chunk"] != SP * SP * STREAM["depth"] \
            or launches["flash_attention"] != 0:
        raise AssertionError(f"ring stream transformer: {launches}, ok={ok}")
    results["ring_launches"] = launches


# -- phase: the stream line at head_dim 256 ---------------------------------

def check_stream256(torch, results):
    """The stream line over 4 heads (head_dim 256, the tensor-core body in
    64-key tiles) against its plain-attention twin, then one ring call at
    its attention shape against the plain ring."""
    import numpy as np
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.models.vit import StreamTransformer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.ops.attention import (
        flash_attention_cuda,
        flash_kernel_attributes,
        key_block,
        ring_attention,
        ring_attention_plain,
    )
    from nnstreamer_tpu_torch.parallel import make_mesh

    cfg = STREAM_HD256
    seq, feat, heads = cfg["seq"], cfg["feat"], cfg["heads"]
    hd = cfg["dim"] // heads
    bf16 = torch.bfloat16
    window = np.random.default_rng(4).normal(
        size=(seq, feat)).astype(np.float32)
    drv = _StreamDriver(window, cfg=cfg)
    drv.run(1)
    _cuda.reset_launches()
    secs, p50 = drv.run(STREAM_HD256_WINDOWS)
    launches = dict(_cuda.LAUNCHES)
    if launches["flash_attention"] != cfg["depth"] * STREAM_HD256_WINDOWS:
        raise AssertionError(f"stream256: launch counts per "
                             f"{STREAM_HD256_WINDOWS} forwards: {launches}")
    bundle = drv.p["f"].fw._bundle
    outs = drv.close()
    twin = _plain_twin(bundle.module, StreamTransformer, cfg)
    x = torch.from_numpy(window).cuda()
    with torch.inference_mode():
        got = bundle.apply_fn(x).float()
        want = twin(x[None]).float()
    torch.cuda.synchronize()
    last = np.asarray(outs[-1])
    finite = bool(torch.isfinite(got).all()) and bool(np.isfinite(last).all())
    ok = (finite and tuple(got.shape) == (1, seq, feat)
          and last.shape == (1, seq, feat)
          and within(got, want, MODEL_ATOL, MODEL_RTOL))
    emit("stream256", head_dim=hd, heads=heads, windows=STREAM_HD256_WINDOWS,
         seconds=secs, windows_per_s=STREAM_HD256_WINDOWS / secs,
         frames_per_s=STREAM_HD256_WINDOWS * seq / secs,
         p50_window_latency_ms=p50, launches=launches,
         plain_block_k=key_block(hd, bf16),
         out_max_abs_err=max_err(got, want), out_atol=MODEL_ATOL,
         out_rtol=MODEL_RTOL, out_ok=ok, finite=finite, outputs=len(outs),
         kernel=flash_kernel_attributes(hd, dtype=bf16), card=results["card"])
    if not ok:
        raise AssertionError("stream256 output disagrees with the plain "
                             "forward or is not finite")

    # one ring call at the line's attention shape: 16 hops over sp=4
    mesh = make_mesh(sp=SP, devices=[torch.device("cuda", 0)] * SP)
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn((heads, seq, hd), generator=gen, device="cuda")
               .to(bf16) for _ in range(3))

    def ring():
        return ring_attention(q, k, v, mesh, "sp", causal=True)

    def plain():
        return ring_attention_plain(q, k, v, mesh, "sp", causal=True)

    def flash():
        return flash_attention_cuda(q, k, v, causal=True)

    def library():
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              is_causal=True)

    _cuda.reset_launches()
    got = ring()
    torch.cuda.synchronize()
    ring_launches = dict(_cuda.LAUNCHES)
    want, ref = plain(), flash()
    torch.cuda.synchronize()
    ok = (bool(torch.isfinite(got.float()).all())
          and within(got, want, ATTN_TOL, ATTN_TOL)
          and within(got, ref, XCHECK_TOL, XCHECK_TOL)
          and ring_launches["flash_chunk"] == SP * SP
          and ring_launches["flash_attention"] == 0)
    emit("stream256", part="ring", shape=[heads, seq, hd], causal=True,
         dtype="bfloat16", sp=SP, launches=ring_launches,
         max_abs_err_vs_plain_ring=max_err(got, want), atol=ATTN_TOL,
         rtol=ATTN_TOL, max_abs_err_vs_flash=max_err(got, ref),
         xcheck_tol=XCHECK_TOL, ok=ok, ring_ms=cuda_ms(ring, reps=10),
         plain_ring_ms=cuda_ms(plain, reps=1, warmup=1),
         flash_ms=cuda_ms(flash, reps=10), sdpa_ms=cuda_ms(library, reps=10),
         kernel=flash_kernel_attributes(hd, carry=True, dtype=bf16),
         card=results["card"])
    if not ok:
        raise AssertionError(f"stream256 ring: {ring_launches}")
    results["stream256_launches"] = {
        name: launches[name] + ring_launches[name] for name in launches}


# -- phase: examples/long_context.py on the card ----------------------------

#: the example's sequence-parallel steps: sp=8 on one card, float32
LONGCTX_SP = 8
#: float32 ring and Ulysses against plain attention: the reference's
#: tolerance (tests/test_ops.py TestRingAttention, TestUlyssesAttention)
SP_F32_ATOL = 3e-5


def check_longctx(torch, results):
    """The three steps of examples/long_context.py at its own sizes through
    the port's runner (nnstreamer_tpu_torch/examples/long_context.py, on
    the card): the stream line (128 one-frame buffers aggregated to one
    window, the stream transformer at dim 32, 2 heads, bf16) against its
    plain-attention twin; ring_attention on float32 (2, 1024, 32) and
    ulysses_attention on float32 (2, 8, 1024, 32), causal, over
    make_mesh(sp=8, devices=[cuda:0] * 8), against plain_attention. The
    data are the example's own (numpy default_rng(0), q = k = v). Then
    the reference's float32 ring and Ulysses test shapes the same way, and
    ring and Ulysses at every head dim of WIDE_DIMS in both dtypes: float32
    against plain_attention, bf16 against the plain ring and the plain
    flash forward at the instance's key block (p rounded at the same
    blocks) at ATTN_TOL."""
    import numpy as np

    from nnstreamer_tpu_torch.examples import long_context
    from nnstreamer_tpu_torch.models import get_model
    from nnstreamer_tpu_torch.models.vit import StreamTransformer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.ops.attention import (
        flash_attention_plain,
        flash_kernel_attributes,
        plain_attention,
        ring_attention,
        ring_attention_plain,
        ulysses_attention,
    )
    from nnstreamer_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    run = long_context.main([])
    got = torch.as_tensor(run["stream"]).float()
    # the runner's model (bf16, dim 32 over 2 heads: head_dim 16) and its
    # plain-attention twin on the same seed weights
    custom = dict(kv.split(":") for kv in
                  long_context.STREAM_CUSTOM.split(","))
    cfg = {k: int(v) for k, v in custom.items() if k != "seed"}
    seq, feat = cfg["seq"], cfg["feat"]
    twin = _plain_twin(get_model("stream_transformer", custom).module,
                       StreamTransformer, cfg)
    with torch.inference_mode():
        want = twin(torch.from_numpy(np.stack(run["frames"])).cuda()[None])
    want = want.float().cpu()
    launches = run["launches"]["stream"]
    ok = (tuple(got.shape) == (1, seq, feat)
          and bool(torch.isfinite(got).all())
          and within(got, want, MODEL_ATOL, MODEL_RTOL)
          and launches["flash_attention"] == cfg["depth"])
    hd = cfg["dim"] // cfg["heads"]
    emit("longctx", step="stream_line", shape=list(got.shape), head_dim=hd,
         dtype="bfloat16", launches=launches,
         out_max_abs_err=max_err(got, want), out_atol=MODEL_ATOL,
         out_rtol=MODEL_RTOL, ok=ok,
         kernel=flash_kernel_attributes(hd, dtype=torch.bfloat16))
    if not ok:
        raise AssertionError(f"longctx stream line: {launches}")
    total = dict(launches)

    mesh = make_mesh(sp=LONGCTX_SP,
                     devices=[torch.device("cuda", 0)] * LONGCTX_SP)
    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def plain_ring(a, b, c, causal):
        return ring_attention_plain(a, b, c, mesh, "sp", causal=causal)

    def plain_flash(a, b, c, causal):
        return flash_attention_plain(a, b, c, causal=causal)

    # the runner's two sequence-parallel steps: its outputs and launches
    for step, fn, x, kernel in (
            ("ring", ring_attention, run["q"], "flash_chunk"),
            ("ulysses", ulysses_attention, run["qh"], "flash_attention")):
        a = torch.from_numpy(x).float().cuda()
        out, launches = run[step], run["launches"][step]
        ref = plain_attention(a, a, a, causal=True)
        ok = (out.shape == a.shape and out.dtype == a.dtype
              and bool(torch.isfinite(out).all())
              and within(out, ref, SP_F32_ATOL, 0.0) and launches[kernel] > 0)

        def call(fn=fn, a=a):
            return fn(a, a, a, mesh, "sp", causal=True)

        emit("longctx", step=step, shape=list(a.shape), causal=True,
             dtype="float32", sp=LONGCTX_SP, launches=launches,
             plain="plain_attention",
             max_abs_err_vs_plain=max_err(out, ref), atol=SP_F32_ATOL,
             rtol=0.0, ok=ok, ms=cuda_ms(call, reps=5, warmup=1),
             # the kernel's own time per launch, and its instantiation
             kernel_device_ms=device_ms(
                 torch, call, "flash_chunk" if step == "ring" else
                 "flash_fwd", calls=2),
             kernel=flash_kernel_attributes(a.shape[-1], carry=step == "ring",
                                            dtype=a.dtype))
        if not ok:
            raise AssertionError(f"longctx {step}: {launches}")
        total = {kk: total[kk] + launches[kk] for kk in total}

    # (step, function, three tensors, causal, launch counted, plain
    # version); float32 against plain_attention at SP_F32_ATOL
    steps = []
    for causal in (False, True):
        steps += [(f"ref_ring_d16_{'causal' if causal else 'full'}",
                   ring_attention, [randn((2, 256, 16)) for _ in range(3)],
                   causal, "flash_chunk", plain_attention),
                  (f"ref_ulysses_d16_{'causal' if causal else 'full'}",
                   ulysses_attention,
                   [randn((2, 8, 256, 16)) for _ in range(3)], causal,
                   "flash_attention", plain_attention)]
    steps.append(("ref_ring_d8_long", ring_attention,
                  [randn((1, 1024, 8)) for _ in range(3)], False,
                  "flash_chunk", plain_attention))
    for hd in WIDE_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            name = f"{_dtype_name(dtype)}_d{hd}"
            f32 = dtype == torch.float32
            steps += [(f"ring_{name}", ring_attention,
                       [randn((2, 256, hd), dtype) for _ in range(3)], True,
                       "flash_chunk", plain_attention if f32 else plain_ring),
                      (f"ulysses_{name}", ulysses_attention,
                       [randn((2, 8, 256, hd), dtype) for _ in range(3)],
                       True, "flash_attention",
                       plain_attention if f32 else plain_flash)]
    for step, fn, (a, b, c), causal, kernel, plain in steps:
        _cuda.reset_launches()
        out = fn(a, b, c, mesh, "sp", causal=causal)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        ref = plain(a, b, c, causal=causal)
        if a.dtype == torch.float32:
            atol, rtol = SP_F32_ATOL, 0.0
        else:
            atol = rtol = ATTN_TOL
        ok = (out.shape == a.shape and out.dtype == a.dtype
              and bool(torch.isfinite(out.float()).all())
              and within(out, ref, atol, rtol) and launches[kernel] > 0)
        emit("longctx", step=step, shape=list(a.shape), causal=causal,
             dtype=_dtype_name(a.dtype), sp=LONGCTX_SP, launches=launches,
             plain=plain.__name__, max_abs_err_vs_plain=max_err(out, ref),
             atol=atol, rtol=rtol, ok=ok)
        if not ok:
            raise AssertionError(f"longctx {step}: {launches}")
    results["longctx_launches"] = total


# -- phase: the ViT-S/16 labeling line -------------------------------------

def check_vit(torch, results, workdir):
    import numpy as np

    from nnstreamer_tpu_torch.models import preprocess_frames
    from nnstreamer_tpu_torch.models.vit import ViT
    from nnstreamer_tpu_torch.ops import _cuda

    classes = VIT["classes"]
    labels = os.path.join(workdir, "vit_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(classes)) + "\n")
    rng = np.random.default_rng(4)
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(BATCH)]
    line = _labeling_line(labels, "vit",
                          f"seed:0,postproc:argmax,{_custom(VIT)}")
    _, _, _, p = _drive(line, frames, N_WARMUP)
    p.stop()
    _cuda.reset_launches()
    out, secs, p50, p = _drive(line, frames, N_BATCHES)
    launches = dict(_cuda.LAUNCHES)
    bundle = p["f"].fw._bundle
    p.stop()
    n_frames = sum(len(b) for b in out)
    if len(out) != N_BATCHES or n_frames != N_BATCHES * BATCH:
        raise AssertionError(f"vit: expected {N_BATCHES * BATCH} labels, got "
                             f"{n_frames} in {len(out)} buffers")
    names = {f"class{i}" for i in range(classes)}
    if not all(lab in names for b in out for lab in b):
        raise AssertionError("vit: a label is not from the labels file")
    if launches["flash_attention"] != VIT["depth"] * N_BATCHES or \
            launches["normalize_u8"] != N_BATCHES:
        raise AssertionError(f"vit: launch counts per {N_BATCHES} forwards: "
                             f"{launches}")
    results["vit_launches"] = launches
    twin = _plain_twin(bundle.module, ViT, VIT)
    x = torch.from_numpy(np.stack(frames)).cuda()
    with torch.inference_mode():
        got = bundle.apply_fn(x).float()
        want = twin(preprocess_frames(x, "pm1", torch.bfloat16)).float()
    torch.cuda.synchronize()
    ok = bool(torch.isfinite(got).all()) and within(got, want, MODEL_ATOL,
                                                    MODEL_RTOL)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    ok = ok and agree >= VIT_ARGMAX_FLOOR
    emit("vit", frames=n_frames, batches=len(out), seconds=secs,
         fps=n_frames / secs, p50_batch_latency_ms=p50,
         fetch_window=FETCH_WINDOW, launches=launches,
         logits_max_abs_err=max_err(got, want), logits_atol=MODEL_ATOL,
         logits_rtol=MODEL_RTOL, logits_ok=ok, argmax_agreement=agree,
         argmax_floor=VIT_ARGMAX_FLOOR,
         distinct_labels=len({lab for b in out for lab in b}),
         card=results["card"])
    if not ok:
        raise AssertionError("vit logits or labels disagree with the plain "
                             "forward")


# -- the detection, segmentation and pose lines ----------------------------

#: the four lines at full width (seed:0 weights from the port's numpy init):
#: frame size, frames per tensor, and the model's own customs
VISION = {
    "ssd_mobilenet": {"size": 300, "fpt": 32, "custom": "classes:91"},
    "deeplab_v3": {"size": 257, "fpt": 16, "custom": "classes:21"},
    "posenet": {"size": 257, "fpt": 16, "custom": "keypoints:17"},
    "yolov8": {"size": 320, "fpt": 16, "custom": "classes:80"},
}
#: batches per measured run of a line (after 2 warm-up batches)
VISION_BATCHES = 8


def _vision_model(name):
    """The line's model at full width with the seed:0 weights its line
    builds (the kernel rows' blocks)."""
    import importlib

    mod = importlib.import_module(f"nnstreamer_tpu_torch.models.{name}")
    model = getattr(mod, {"ssd_mobilenet": "SSDMobileNetV2",
                          "deeplab_v3": "DeepLabV3"}[name])()
    mod.init_weights(model, 0)
    return model


@lru_cache(maxsize=None)
def kernel_blocks(name: str = "mobilenet_v2") -> int:
    """The fused-block launches of one forward of a line's model at its
    line's size: the blocks kernel_block_shapes sends to the kernel (17
    for MobileNet-v2 and SSD, stride-2 blocks included; 13 for DeepLab,
    whose 4 dilated blocks run the convolutions)."""
    import importlib

    from nnstreamer_tpu_torch.models.mobilenet_v2 import kernel_block_shapes

    mod = importlib.import_module(f"nnstreamer_tpu_torch.models.{name}")
    model = getattr(mod, {"mobilenet_v2": "MobileNetV2",
                          "ssd_mobilenet": "SSDMobileNetV2",
                          "deeplab_v3": "DeepLabV3"}[name])()
    size = SIZE if name == "mobilenet_v2" else VISION[name]["size"]
    return len(kernel_block_shapes(model, size))


def check_vision_blocks(torch, results, gen):
    """The fused block at every block shape SSD (300 px, batch 32; 17) and
    DeepLab (257 px, batch 16; 13, the dilated 4 are not the kernel's)
    give it, against its plain version, each row with its plan, registers,
    shared memory, CTAs per SM, times, bound and cuDNN chain (the
    stride-2 rows under phase stride2); then normalize_u8 at the four
    lines' frames, bit-equal to its plain version."""
    from nnstreamer_tpu_torch.models.mobilenet_v2 import kernel_block_shapes
    from nnstreamer_tpu_torch.ops import normalize_u8, normalize_u8_plain
    from nnstreamer_tpu_torch.ops.fused_block import fold_inverted_residual

    keys = ("ms", "device_ms", "plain_ms", "cudnn_chain_ms", "bound_ms")
    # SSD again at batch 1: the detect-then-crop line of the streams phase
    # runs it one frame per buffer
    for name, want, batch, key in (
            ("ssd_mobilenet", (13, 4), VISION["ssd_mobilenet"]["fpt"],
             "ssd_mobilenet"),
            ("deeplab_v3", (10, 3), VISION["deeplab_v3"]["fpt"],
             "deeplab_v3"),
            ("ssd_mobilenet", (13, 4), 1, "ssd_mobilenet_batch1")):
        cfg = VISION[name]
        model = _vision_model(name)
        shapes = kernel_block_shapes(model, cfg["size"])
        got = tuple(sum(s[-1] == st for s in shapes) for st in (1, 2))
        if got != want:
            raise AssertionError(f"{name}: {got} stride-1/2 kernel blocks, "
                                 f"expected {want}")
        want = sum(want)
        tot, errs = dict.fromkeys(keys, 0.0), []
        by = {"bytes": 0.0, "operations": 0.0}
        for i, H, W, *_, stride in shapes:
            row = _fused_row(torch, batch, H, W,
                             fold_inverted_residual(model.blocks[i]), gen,
                             stride=stride, model=name, block=i)
            _add_rows(tot, by, row, keys)
            errs.append(row["max_abs_err"])
        results[f"fused_{key}"] = dict(tot, max_abs_err=max(errs))
        emit("kernel", kernel="fused_inverted_residual", model=name,
             block=f"sum of {want}", batch=batch, **tot,
             max_abs_err=max(errs))
    for name, cfg in VISION.items():
        s, fpt = cfg["size"], cfg["fpt"]
        x = torch.randint(0, 256, (fpt, s, s, 3), generator=gen,
                          device="cuda", dtype=torch.uint8)
        scale = (1.0 / 255.0, 0.0) if name == "yolov8" else (1.0 / 127.5,
                                                             -1.0)
        k = normalize_u8(x, *scale, out_dtype=torch.bfloat16)
        p = normalize_u8_plain(x, *scale, out_dtype=torch.bfloat16)
        n = x.numel()
        row = {"kernel": "normalize_u8", "model": name,
               "shape": list(x.shape), "max_abs_err": max_err(k, p),
               "tol": 0.0,
               "ms": cuda_ms(lambda: normalize_u8(
                   x, *scale, out_dtype=torch.bfloat16)),
               "plain_ms": cuda_ms(lambda: normalize_u8_plain(
                   x, *scale, out_dtype=torch.bfloat16)),
               "bound_ms": bound_ms(3 * n, 2 * n, "float32")[0]}
        emit("kernel", **row)
        if row["max_abs_err"] != 0.0:
            raise AssertionError(f"normalize_u8 at {name}'s frames: {row}")


def _vision_frames(seed, n, size):
    """n frames of 4x4 blocks of flat colour (different content each)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cell = -(-size // 4)
    return [np.kron(rng.integers(0, 256, (4, 4, 3)),
                    np.ones((cell, cell, 1)))[:size, :size].astype(np.uint8)
            for _ in range(n)]


def _vision_line(name, decoder, extra=""):
    cfg = VISION[name]
    s = cfg["size"]
    return (f"appsrc name=src caps=video/x-raw,format=RGB,width={s},"
            f"height={s},framerate=1000/1 "
            f"! tensor_converter frames-per-tensor={cfg['fpt']} "
            f"! tensor_filter name=f framework=jax model={name} "
            f"custom=seed:0,{cfg['custom']}{extra} "
            f"! queue ! tensor_decoder {decoder} split-batch={cfg['fpt']} "
            f"! tensor_sink name=out")


def _run_vision(torch, name, decoder, frames, extra="",
                n_batches=VISION_BATCHES, warmup=N_WARMUP):
    """Drive one line: ``warmup`` batches, then n_batches measured with
    the launch counts zeroed just before. Returns (seconds, p50 batch ms,
    launches, bundle, the measured run's overlays, objects per overlay)."""
    from nnstreamer_tpu_torch.ops import _cuda

    fpt, size = VISION[name]["fpt"], VISION[name]["size"]
    d = _LineDriver(_vision_line(name, decoder, extra), frames,
                    outputs_per_unit=fpt)
    if warmup:
        d.run(warmup)
    _cuda.reset_launches()
    secs, p50 = d.run(n_batches)
    launches = dict(_cuda.LAUNCHES)
    bundle = d.p["f"].fw._bundle
    measured = d.p["out"].collected[warmup * fpt:]
    objects = [len(b.meta.get("objects") or b.meta.get("keypoints") or ())
               for b in measured]
    outs = d.close()[warmup * fpt:]
    if len(outs) != n_batches * fpt or any(
            tuple(o.shape) != (size, size, 4) for o in outs):
        raise AssertionError(f"{name}: expected {n_batches * fpt} "
                             f"{size}x{size} RGBA overlays, got "
                             f"{[tuple(o.shape) for o in outs[:3]]}... "
                             f"({len(outs)})")
    return secs, p50, launches, bundle, outs, objects


def _profile_vision(torch, name, decoder, frames, extra=""):
    """One more run of a line (4 batches, no warm-up: the model's weights
    upload inside the window, the wall clock starts at the first push)
    under torch.profiler."""
    emit("profile", line=name + extra, batches=4, **device_profile(
        torch, lambda: _run_vision(torch, name, decoder, frames, extra,
                                   n_batches=4, warmup=0)[0]))


def _check_launches(name, launches, fused, n_batches=VISION_BATCHES):
    """The fused block ``fused`` times and normalize_u8 once per forward,
    no other kernel."""
    want = {"fused_inverted_residual": fused * n_batches,
            "normalize_u8": n_batches}
    got = {k: v for k, v in launches.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{name}: launches per {n_batches} forwards "
                             f"{launches}, expected {want}")


def _near_agreement(got, want, tol=5e-3):
    """The pp quads' near agreement (tests/test_fused_block.py::
    test_ssd_zoo_fused_pp_custom) per frame: survivor counts within
    max(3, n/10), the leading (up to 10) scores within ``tol`` and each
    leading detection matched by one of the oracle's first lead + 3 with
    its class, score and box (near-tied scores may swap order). Returns
    (whether every frame holds it, frames whose leading classes are in
    the same order, the largest count difference)."""
    locs, cls, scr, num = (t.float().cpu() for t in got)
    wl, wc, ws, wn = (t.float().cpu() for t in want)
    ok, same_order, worst = True, 0, 0
    for b in range(num.shape[0]):
        n_got, n_want = int(num[b, 0]), int(wn[b, 0])
        worst = max(worst, abs(n_got - n_want))
        ok &= abs(n_got - n_want) <= max(3, n_want // 10)
        lead = min(n_got, n_want, 10)
        ok &= bool(((scr[b, :lead] - ws[b, :lead]).abs()
                    <= tol + tol * ws[b, :lead].abs()).all())
        same_order += bool((cls[b, :lead] == wc[b, :lead]).all())
        for i in range(lead):
            ok &= any(wc[b, j] == cls[b, i]
                      and abs(float(ws[b, j] - scr[b, i])) <= tol
                      and float((wl[b, j] - locs[b, i]).abs().max()) <= tol
                      for j in range(min(lead + 3, wc.shape[1])))
    return bool(ok), same_order, worst


def _forwards(torch, name, bundle, x):
    """The filter's own forward on ``x`` and, on the same weights, the
    same folded forward with the kernel's plain version in its place
    ('plain'), with every block as three convolutions ('xla', the JAX
    package's fused:xla form) and in float32 ('f32', TF32 off)."""
    import importlib

    from nnstreamer_tpu_torch.models import preprocess_frames

    mod = importlib.import_module(f"nnstreamer_tpu_torch.models.{name}")
    m = bundle.module
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        pre = preprocess_frames(x, "pm1", m.dtype)
        out = {"kernel": bundle.apply_fn(x)}
        for mode in ("plain", "xla"):
            out[mode] = mod._make_fused_apply(m, mode=mode)(pre)
        out["f32"] = mod._make_fused_apply(
            m, mode="plain", compute_dtype=torch.float32)(pre.float())
    torch.cuda.synchronize()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    return {k: v if isinstance(v, tuple) else (v,) for k, v in out.items()}


#: the kernel forward against the plain forward, relative to the bf16
#: noise floor: the xla forward's distance from the same plain forward
#: (it rounds at other points in every block, as any second correct bf16
#: implementation does). The kernel rounds where the plain version rounds,
#: so its mean distance must stay below this share of the floor's
NOISE_SHARE = 0.5


def _agreement(torch, outs):
    """Per output tensor: max and mean |a - plain| for a in kernel, xla
    and f32, and the argmax agreement over the last axis. ``ok``: every
    kernel output finite, its mean distance at most NOISE_SHARE of the
    xla forward's, its max distance and argmax agreement no worse than
    the xla forward's."""
    rows, ok = [], True
    for i, plain in enumerate(outs["plain"]):
        row = {}
        for a in ("kernel", "xla", "f32"):
            d = (outs[a][i].float() - plain.float()).abs()
            row[a] = {"max": float(d.max()), "mean": float(d.mean()),
                      "argmax_agreement": float(
                          (outs[a][i].argmax(-1) == plain.argmax(-1))
                          .float().mean())}
        k, x = row["kernel"], row["xla"]
        row["finite"] = bool(torch.isfinite(outs["kernel"][i]).all())
        row["ok"] = (row["finite"] and k["mean"] <= NOISE_SHARE * x["mean"]
                     and k["max"] <= x["max"]
                     and k["argmax_agreement"] >= x["argmax_agreement"])
        ok = ok and row["ok"]
        rows.append(row)
    return ok, rows


def check_detect(torch, results, workdir):
    """SSD-MobileNet-v2 at 300 px into bounding_boxes mobilenet-ssd, then
    its postproc:pp line into mobilenet-ssd-postprocess."""
    import numpy as np

    from nnstreamer_tpu_torch.models.ssd_mobilenet import (
        generate_anchors,
        pp_options,
        ssd_postprocess,
        write_box_priors,
    )

    name, cfg = "ssd_mobilenet", VISION["ssd_mobilenet"]
    labels = os.path.join(workdir, "ssd_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(91)) + "\n")
    priors = os.path.join(workdir, "box_priors.txt")
    n_anchors = write_box_priors(priors, cfg["size"])
    frames = _vision_frames(5, cfg["fpt"], cfg["size"])
    wh = f"{cfg['size']}:{cfg['size']}"
    secs, p50, launches, bundle, outs, objects = _run_vision(
        torch, name,
        f"mode=bounding_boxes option1=mobilenet-ssd option2={labels} "
        f"option3={priors}:0.5 option4={wh} option5={wh}", frames,
        extra=",fused:pallas")
    _check_launches(name, launches, kernel_blocks("ssd_mobilenet"))
    results["detect_launches"] = launches
    x = torch.from_numpy(np.stack(frames)).cuda()
    fw = _forwards(torch, name, bundle, x)
    got = fw["kernel"]
    ok, rows = _agreement(torch, fw)
    ok = ok and (tuple(got[0].shape) == (cfg["fpt"], n_anchors, 1, 4)
                 and tuple(got[1].shape) == (cfg["fpt"], n_anchors, 91))
    emit("detect", line="ssd_mobilenet", frames=len(outs),
         batches=VISION_BATCHES, frames_per_tensor=cfg["fpt"], seconds=secs,
         fps=len(outs) / secs, p50_batch_latency_ms=p50, launches=launches,
         anchors=n_anchors, boxes=rows[0], scores=rows[1],
         noise_share=NOISE_SHARE, ok=ok,
         within_flagship_tol=[within(g, w, MODEL_ATOL, MODEL_RTOL)
                              for g, w in zip(got, fw["plain"])],
         objects_per_frame=statistics.mean(objects), card=results["card"])
    if not ok:
        raise AssertionError("detect: SSD outputs stray from the plain "
                             "forward beyond the bf16 noise floor")
    _profile_vision(
        torch, name,
        f"mode=bounding_boxes option1=mobilenet-ssd option2={labels} "
        f"option3={priors}:0.5 option4={wh} option5={wh}", frames,
        extra=",fused:pallas")
    # the pp line: the post-process on the device, four small tensors out
    k, iou, thr = pp_options({})
    secs, p50, launches, bundle, outs, objects = _run_vision(
        torch, name,
        f"mode=bounding_boxes option1=mobilenet-ssd-postprocess "
        f"option2={labels} option3=0:1:2:3,50 option4={wh} option5={wh}",
        frames, extra=",fused:pallas,postproc:pp", n_batches=4)
    _check_launches(name, launches, kernel_blocks("ssd_mobilenet"), n_batches=4)
    results["detect_pp_launches"] = launches
    pri = torch.from_numpy(generate_anchors(cfg["size"])).cuda()
    with torch.inference_mode():
        got = bundle.apply_fn(x)
        post = {a: ssd_postprocess(*fw[a], pri, k, iou, thr)
                for a in ("kernel", "plain", "xla")}
    torch.cuda.synchronize()
    # the device post-process is exact: the pp line's quads are the
    # post-process of the same kernel forward's raw outputs, bit for bit
    exact = all(bool(torch.equal(g, w)) for g, w in zip(got, post["kernel"]))
    # against the plain forward's quads: the near-agreement rule,
    # reported, and held to the noise floor of the xla forward's quads
    near, same_order, worst = _near_agreement(got, post["plain"])
    x_near, x_same, x_worst = _near_agreement(post["xla"], post["plain"])
    ok = exact and worst <= x_worst and same_order >= x_same
    emit("detect", line="ssd_mobilenet postproc:pp", frames=len(outs),
         batches=4, seconds=secs, fps=len(outs) / secs,
         p50_batch_latency_ms=p50, launches=launches,
         survivors=[int(v) for v in got[3][:, 0].tolist()],
         survivors_plain=[int(v) for v in post["plain"][3][:, 0].tolist()],
         exact=exact, near_agreement=near, largest_count_difference=worst,
         leading_order_equal=same_order,
         xla={"near_agreement": x_near, "largest_count_difference": x_worst,
              "leading_order_equal": x_same},
         ok=ok, objects_per_frame=statistics.mean(objects),
         card=results["card"])
    if not ok:
        raise AssertionError("detect: the pp quads are not the post-process "
                             "of the kernel forward, or stray from the "
                             "plain forward's beyond the noise floor")


def check_segment(torch, results):
    """DeepLab-v3 at 257 px into image_segment tflite-deeplab."""
    import numpy as np

    name, cfg = "deeplab_v3", VISION["deeplab_v3"]
    frames = _vision_frames(6, cfg["fpt"], cfg["size"])
    secs, p50, launches, bundle, outs, _ = _run_vision(
        torch, name, "mode=image_segment option1=tflite-deeplab", frames,
        extra=",fused:pallas")
    _check_launches(name, launches, kernel_blocks("deeplab_v3"))
    results["segment_launches"] = launches
    fw = _forwards(torch, name, bundle,
                   torch.from_numpy(np.stack(frames)).cuda())
    got = fw["kernel"][0]
    s = cfg["size"]
    ok, rows = _agreement(torch, fw)
    ok = ok and tuple(got.shape) == (cfg["fpt"], s, s, 21)
    emit("segment", line="deeplab_v3", frames=len(outs),
         batches=VISION_BATCHES, frames_per_tensor=cfg["fpt"], seconds=secs,
         fps=len(outs) / secs, p50_batch_latency_ms=p50, launches=launches,
         logits=rows[0], noise_share=NOISE_SHARE, ok=ok,
         within_flagship_tol=within(got, fw["plain"][0], MODEL_ATOL,
                                    MODEL_RTOL),
         distinct_classes=int(got.argmax(-1).unique().numel()),
         card=results["card"])
    if not ok:
        raise AssertionError("segment: DeepLab logits stray from the plain "
                             "forward beyond the bf16 noise floor")
    _profile_vision(torch, name, "mode=image_segment option1=tflite-deeplab",
                    frames, extra=",fused:pallas")


#: COCO's 17 keypoints and their skeleton, as the pose decoder's
#: metadata file (PoseNet emits 17 heatmaps; the decoder's default has 14)
COCO_KEYPOINTS = (
    ("nose", (1, 2)), ("l_eye", (0, 3)), ("r_eye", (0, 4)), ("l_ear", (1,)),
    ("r_ear", (2,)), ("l_shoulder", (6, 7, 11)), ("r_shoulder", (5, 8, 12)),
    ("l_elbow", (5, 9)), ("r_elbow", (6, 10)), ("l_wrist", (7,)),
    ("r_wrist", (8,)), ("l_hip", (5, 12, 13)), ("r_hip", (6, 11, 14)),
    ("l_knee", (11, 15)), ("r_knee", (12, 16)), ("l_ankle", (13,)),
    ("r_ankle", (14,)))


def check_vision(torch, results, workdir):
    """PoseNet at 257 px into pose_estimation heatmap-offset, YOLOv8 at
    320 px into bounding_boxes yolov8: outputs' shapes and finiteness, one
    overlay per frame, frames per second."""
    import numpy as np

    labels = os.path.join(workdir, "coco_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(80)) + "\n")
    pose = os.path.join(workdir, "coco_pose.txt")
    with open(pose, "w") as f:  # label, then the keypoints it joins
        f.write("\n".join(f"{n} {' '.join(map(str, c))}" for n, c in (
            COCO_KEYPOINTS)) + "\n")
    results["vision_launches"] = {}
    for name, decoder, shapes in (
            ("posenet", "mode=pose_estimation option1=257:257 "
             f"option2=257:257 option3={pose} option4=heatmap-offset",
             [(16, 17, 17, 17), (16, 17, 17, 34)]),
            ("yolov8", f"mode=bounding_boxes option1=yolov8 "
             f"option2={labels} option3=1:0.25:0.45 option4=320:320 "
             "option5=320:320", [(16, 2100, 84)])):
        cfg = VISION[name]
        frames = _vision_frames(7, cfg["fpt"], cfg["size"])
        secs, p50, launches, bundle, outs, objects = _run_vision(
            torch, name, decoder, frames)
        _check_launches(name, launches, 0)
        for k, v in launches.items():
            results["vision_launches"][k] = \
                results["vision_launches"].get(k, 0) + v
        with torch.inference_mode():
            out = bundle.apply_fn(torch.from_numpy(np.stack(frames)).cuda())
        out = out if isinstance(out, tuple) else (out,)
        got = [tuple(t.shape) for t in out]
        finite = all(bool(torch.isfinite(t).all()) for t in out)
        ok = finite and got == shapes
        emit("vision", line=name, frames=len(outs), batches=VISION_BATCHES,
             frames_per_tensor=cfg["fpt"], seconds=secs,
             fps=len(outs) / secs, p50_batch_latency_ms=p50,
             launches=launches, shapes=got, finite=finite, ok=ok,
             objects_per_frame=statistics.mean(objects),
             card=results["card"])
        if not ok:
            raise AssertionError(f"vision: {name} outputs {got}, finite "
                                 f"{finite}; expected {shapes}")


# -- phase: the upload window on the flagship line --------------------------

#: feed-depth values the upload phase drives, each run twice, in the order
#: 1, 2, 4, 4, 2, 1
FEED_DEPTHS = (1, 2, 4)


def _flag_line(labels: str, extra: str = "", fpt: int = BATCH) -> str:
    """The flagship labeling line with tensor_filter properties added
    (fetch-window=4 unless ``extra`` sets one)."""
    if "fetch-window" not in extra:
        extra += f" fetch-window={FETCH_WINDOW}"
    return (
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=1000/1 "
        f"! tensor_converter name=conv frames-per-tensor={fpt} "
        f"! tensor_filter name=f framework=jax model=mobilenet_v2 "
        f"custom=seed:0,postproc:argmax,fused:pallas {extra} "
        f"! queue name=q ! tensor_decoder name=dec mode=image_labeling "
        f"option1={labels} ! tensor_sink name=out")


def _labels_of(p) -> list:
    """Every label the sink collected, one per frame, in order."""
    out = []
    for b in p["out"].collected:
        lab = b.meta["label"]
        out.extend(lab if isinstance(lab, list) else [lab])
    return out


def trace_device_stats(path: str, wall_s: float) -> dict:
    """From a torch.profiler Chrome trace (``trace.torch_profile``): the
    device's busy time (union of its kernel, memcpy and memset intervals)
    and idle share over ``wall_s``, the streams the kernels ran on, and
    every host-to-device copy by name (Kineto says Pinned or Pageable) and
    stream, with its count and milliseconds."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    spans, kernel_streams, h2d = [], set(), {}
    for e in events:
        cat = e.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset") or "dur" not in e:
            continue
        t0 = float(e["ts"])
        spans.append((t0, t0 + float(e["dur"])))
        stream = (e.get("args") or {}).get("stream")
        if cat == "kernel":
            kernel_streams.add(stream)
        elif "HtoD" in e.get("name", ""):
            n, ms = h2d.get((e["name"], stream), (0, 0.0))
            h2d[(e["name"], stream)] = (n + 1, ms + float(e["dur"]) / 1e3)
    busy_us, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy_us += t1 - t0
            end = t1
        elif t1 > end:
            busy_us += t1 - end
            end = t1
    return {"device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
            "kernel_streams": sorted(kernel_streams, key=str),
            "h2d": [{"name": name, "stream": stream, "count": n, "ms": ms}
                    for (name, stream), (n, ms) in sorted(h2d.items(),
                                                          key=str)],
            "h2d_pinned_off_kernel_stream": any(
                "Pinned" in name and stream not in kernel_streams
                for name, stream in h2d)}


def check_upload(torch, results, workdir):
    """The flagship line at feed-depth 1, 2 and 4 (fetch-window=4), each
    run twice: frames/s, labels against feed-depth=1, the tracer's
    crossings and upload-window residency, then one torch.profiler run at
    depth 1 and one at depth 2 (idle share; which stream the uploads ran
    on, pinned or pageable)."""
    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.ops import _cuda

    labels, frames = results["flag_labels"], results["flag_frames"]
    _, _, _, p = _drive(_flag_line(labels, "feed-depth=2"), frames, 2)
    p.stop()  # warm-up: the staging ring's first pinned allocations
    runs = {d: [] for d in FEED_DEPTHS}
    launches = {}
    ref_labels, report = None, {}
    for d in FEED_DEPTHS + FEED_DEPTHS[::-1]:
        _cuda.reset_launches()
        out, secs, p50, p = _drive(
            _flag_line(labels, f"feed-depth={d}"), frames, N_BATCHES,
            traced=True)
        for k, v in _cuda.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        got = _labels_of(p)
        cr = p.tracer.crossings()["per_element"]
        res = p.tracer.report().get("residency", {})
        p.stop()
        if ref_labels is None:
            ref_labels = got
        runs[d].append({"fps": N_BATCHES * BATCH / secs, "p50_ms": p50,
                        "labels_equal_depth1": got == ref_labels})
        report[d] = {"crossings_f": cr.get("f"),
                     "crossings_other": {k: v for k, v in cr.items()
                                         if k != "f"},
                     "upload_window": res.get("upload-window:f"),
                     "fetch_window": res.get("fetch-window:f")}
        want_h2d = (N_BATCHES, N_BATCHES * BATCH * SIZE * SIZE * 3)
        want_d2h = (N_BATCHES // FETCH_WINDOW, N_BATCHES * BATCH * 4)
        f = cr.get("f") or {}
        if (len(got) != N_BATCHES * BATCH or got != ref_labels
                or (f.get("h2d"), f.get("h2d_bytes")) != want_h2d
                or (f.get("d2h"), f.get("d2h_bytes")) != want_d2h
                or (d > 1 and (res.get("upload-window:f") or {})
                    .get("count") != N_BATCHES)):
            emit("upload", feed_depth=d, failed=report[d],
                 labels=len(got), labels_equal=got == ref_labels)
            raise AssertionError(f"upload: feed-depth={d} run is wrong")
    runs_n = 2 * len(FEED_DEPTHS)
    if launches.get("fused_inverted_residual") != kernel_blocks() * N_BATCHES * runs_n \
            or launches.get("normalize_u8") != N_BATCHES * runs_n:
        raise AssertionError(f"upload: launch counts {launches}")
    results["upload_launches"] = launches
    profiles = {}
    for d in (1, 2):
        logdir = os.path.join(workdir, f"upload_prof_d{d}")
        with trace.torch_profile(logdir) as path:
            _, secs, _, p = _drive(_flag_line(labels, f"feed-depth={d}"),
                                   frames, FETCH_WINDOW)
            p.stop()
        profiles[d] = trace_device_stats(path, secs)
        profiles[d]["wall_ms"] = secs * 1e3
        profiles[d]["trace_valid"] = trace.validate_chrome_trace(path) == []
    # the host side: one span-traced run per depth — the filter's own ms
    # per batch, its invoke dispatch (at depth 1 it includes the pageable
    # upload) and, at depth 2, the prefetch's staging copy (the h2d span)
    host = {}
    for d in (1, 2):
        _, secs, _, p = _drive(_flag_line(labels, f"feed-depth={d}"),
                               frames, N_BATCHES, traced=True, spans=True)
        recs = p.tracer.spans.records()
        p.stop()
        ms = {cat: [(r[4] - r[3]) * 1e3 for r in recs if r[2] == cat]
              for cat in ("h2d", "dispatch")}
        host[d] = {"wall_ms_per_batch": secs * 1e3 / N_BATCHES,
                   "filter_own_ms_per_batch":
                       p.tracer.element_self_ms(N_BATCHES).get("f"),
                   "dispatch_ms_mean": statistics.fmean(ms["dispatch"]),
                   "h2d_staging_ms_mean": (statistics.fmean(ms["h2d"])
                                           if ms["h2d"] else None)}
    emit("upload", batches=N_BATCHES, batch=BATCH,
         fetch_window=FETCH_WINDOW,
         fps={d: [r["fps"] for r in runs[d]] for d in FEED_DEPTHS},
         fps_median={d: statistics.median(r["fps"] for r in runs[d])
                     for d in FEED_DEPTHS},
         fps_spread={d: max(r["fps"] for r in runs[d])
                     - min(r["fps"] for r in runs[d]) for d in FEED_DEPTHS},
         p50_batch_latency_ms={d: [r["p50_ms"] for r in runs[d]]
                               for d in FEED_DEPTHS},
         labels_equal_depth1=all(r["labels_equal_depth1"]
                                 for d in FEED_DEPTHS for r in runs[d]),
         tracer=report, launches=launches, profile=profiles,
         host_spans=host, card=results["card"])
    if not profiles[2]["h2d_pinned_off_kernel_stream"]:
        raise AssertionError("upload: feed-depth=2 shows no pinned upload "
                             "off the kernels' stream")


# -- phase: the live-camera form of the flagship line ------------------------

#: frames per micro-batch on the live line, and the quiescence flush
LIVE_BATCH = 32
LIVE_TIMEOUT_MS = 50


def check_batch(torch, results):
    """tensor_converter frames-per-tensor=1 ! tensor_filter batch-size=32
    fetch-timeout-ms=50 fetch-window=auto, frames pushed one by one: its
    labels against the frames-per-tensor=32 line on the same frames, the
    window auto settles on, frames/s; then 40 frames with no EOS, which
    only the timer thread's flush can bring out."""
    from nnstreamer_tpu_torch.ops import _cuda

    labels, frames = results["flag_labels"], results["flag_frames"]
    n_units = 16
    live = (f"batch-size={LIVE_BATCH} fetch-timeout-ms={LIVE_TIMEOUT_MS} "
            "fetch-window=auto")
    ref = _LineDriver(_flag_line(labels, "fetch-window=1", fpt=LIVE_BATCH),
                      frames[:LIVE_BATCH])
    ref.run(2)
    ref.run(n_units)
    ref.close()
    want = _labels_of(ref.p)[2 * LIVE_BATCH:]
    drv = _LineDriver(_flag_line(labels, live, fpt=1), frames[:LIVE_BATCH],
                      outputs_per_unit=LIVE_BATCH)
    drv.run(2)  # warm-up
    _cuda.reset_launches()
    secs, p50 = drv.run(n_units)
    launches = dict(_cuda.LAUNCHES)
    window = drv.p["f"]._auto_window
    # the quiescence flush: 40 frames, no EOS — the last 8 sit in a
    # partial batch until fetch-timeout-ms expires on the timer thread
    n0 = len(drv.arrived)
    t0 = time.perf_counter()
    for i in range(40):
        drv.p["src"].push_buffer(_frame_buf(frames[i % LIVE_BATCH]))
    deadline = time.monotonic() + 30
    while len(drv.arrived) < n0 + 40 and time.monotonic() < deadline:
        time.sleep(0.001)
    flush_s = time.perf_counter() - t0
    drv.close()
    got = _labels_of(drv.p)
    live_labels = got[2 * LIVE_BATCH:2 * LIVE_BATCH + n_units * LIVE_BATCH]
    timer_labels = got[(2 + n_units) * LIVE_BATCH:]
    ok = (live_labels == want and len(timer_labels) == 40
          and timer_labels == want[:40]
          and launches.get("fused_inverted_residual") == kernel_blocks() * n_units
          and launches.get("normalize_u8") == n_units)
    results["batch_launches"] = launches
    emit("batch", frames=n_units * LIVE_BATCH, batch=LIVE_BATCH,
         seconds=secs, fps=n_units * LIVE_BATCH / secs,
         p50_batch_latency_ms=p50, auto_window=window,
         labels_equal_fpt32=live_labels == want,
         timeout_flush_frames=len(timer_labels),
         timeout_flush_labels_equal=timer_labels == want[:40],
         timeout_flush_s=flush_s, launches=launches, card=results["card"])
    if not ok:
        raise AssertionError("batch: labels, the timer flush or the launch "
                             "counts are wrong")


def _frame_buf(frame):
    from nnstreamer_tpu_torch.buffer import Buffer

    return Buffer(tensors=[frame])


# -- phase: host time per element ---------------------------------------------

def _element_host_ms(tracer, units: int) -> dict:
    """Per element: its chain's inclusive host ms per unit (report()'s
    proctime; an element's chain includes the downstream chains it calls
    on its thread) and its own ms per unit (the span ring's self time)."""
    rep = tracer.report()
    own = tracer.element_self_ms(units)
    out = {}
    for el, e in rep.items():
        pt = e.get("proctime") if isinstance(e, dict) else None
        if not pt or not pt.get("count"):
            continue
        out[el] = {"chains": pt["count"],
                   "inclusive_ms": pt["mean_us"] * pt["count"] / 1e3 / units,
                   "own_ms": own.get(el, 0.0)}
    return out


def check_hostspans(torch, results, workdir):
    """The flagship and stream lines with a span tracer attached after
    their warm-up: each element's host ms per batch (window), the
    host-stack roll-up, and a torch_profile trace of the flagship line
    checked by validate_chrome_trace."""
    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.ops import _cuda

    labels, frames = results["flag_labels"], results["flag_frames"]
    launches = {}
    drv = _LineDriver(_flag_line(labels), frames)
    drv.run(FETCH_WINDOW)
    tracer = drv.attach()
    _cuda.reset_launches()
    secs, _ = drv.run(N_BATCHES)
    for k, v in _cuda.LAUNCHES.items():
        launches[k] = launches.get(k, 0) + v
    flag = {"batches": N_BATCHES, "wall_ms_per_batch": secs * 1e3 / N_BATCHES,
            "elements": _element_host_ms(tracer, N_BATCHES),
            "host_stack": tracer.host_stack_report(N_BATCHES),
            "crossings": tracer.crossings()["per_element"]}
    spans_valid = trace.validate_chrome_trace(
        tracer.export_chrome_trace()) == []
    drv.close()
    window = results["stream_window"]
    sdrv = _StreamDriver(window)
    sdrv.run(N_WARMUP)
    stracer = sdrv.attach()
    _cuda.reset_launches()
    ssecs, _ = sdrv.run(N_BATCHES)
    for k, v in _cuda.LAUNCHES.items():
        launches[k] = launches.get(k, 0) + v
    stream = {"windows": N_BATCHES,
              "wall_ms_per_window": ssecs * 1e3 / N_BATCHES,
              "elements": _element_host_ms(stracer, N_BATCHES),
              "host_stack": stracer.host_stack_report(N_BATCHES)}
    spans_valid = spans_valid and trace.validate_chrome_trace(
        stracer.export_chrome_trace()) == []
    sdrv.close()
    logdir = os.path.join(workdir, "hostspans_prof")
    with trace.torch_profile(logdir) as path:
        _, psecs, _, p = _drive(_flag_line(labels), frames, FETCH_WINDOW)
        p.stop()
    problems = trace.validate_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        n_events = len(json.load(f)["traceEvents"])
    prof = trace_device_stats(path, psecs)
    results["hostspans_launches"] = launches
    emit("hostspans", flagship=flag, stream=stream,
         span_traces_valid=spans_valid,
         torch_profile={"path": os.path.relpath(path, ROOT),
                        "events": n_events, "problems": problems[:5],
                        "valid": not problems, "wall_ms": psecs * 1e3,
                        "idle_share": prof["idle_share"],
                        "device_busy_ms": prof["device_busy_ms"]},
         launches=launches, card=results["card"])
    if problems or not spans_valid or not flag["elements"] \
            or not stream["elements"] \
            or launches.get("fused_inverted_residual") != kernel_blocks() * N_BATCHES \
            or launches.get("flash_attention") != \
            STREAM["depth"] * N_BATCHES:
        raise AssertionError("hostspans: a trace is invalid, an element "
                             "is missing or a kernel did not launch")


# -- phase: the serving tier --------------------------------------------------

#: rows per served batch, client pipelines, requests per client, and the
#: admission bound of the measured run and of the 2x-overload run
SERVE_BATCH = 32
SERVE_CLIENTS = 8
SERVE_PER_CLIENT = 32
SERVE_DEPTH = 256
OVERLOAD_DEPTH = 32
OVERLOAD_S = 3.0
SERVE_FRAME_CAPS = (f"other/tensors,num-tensors=1,dimensions=3:{SIZE}:{SIZE},"
                    "types=uint8,framerate=0/1")


def _serve_line(depth: int = SERVE_DEPTH, server_extra: str = "",
                filter_extra: str = "") -> str:
    """The serving line at full width: MobileNet-v2 1.0, 224x224, 1001
    classes, 32 rows per batch assembled from every waiting client;
    ``server_extra`` and ``filter_extra`` go on the serversrc and the
    filter."""
    return (f"tensor_query_serversrc id=srv port=0 serve=1 {server_extra}"
            f"serve-batch={SERVE_BATCH} serve-queue-depth={depth} "
            f"caps={SERVE_FRAME_CAPS} ! tensor_filter framework=jax "
            f"model=mobilenet_v2 custom=seed:0,fused:pallas {filter_extra}"
            "! tensor_query_serversink id=srv timeout=5")


def _element(p, type_name: str):
    return next(e for e in p.elements.values()
                if e.ELEMENT_NAME == type_name)


def _serve_frames(frames, client: int, n: int = SERVE_PER_CLIENT,
                  order=None):
    """Client ``client``'s frames: the flagship's seeded frames (in
    ``order``, a list of their indices, if given), from an offset of its
    own."""
    order = order or range(len(frames))
    return [frames[order[(client * 17 + k) % len(order)]] for k in range(n)]


def _class_spread(classes) -> list:
    """Frame indices ordered so that each class recurs at even intervals
    (the i-th of a class's n frames at key (i + 0.5) / n): any window of
    the order holds each class in proportion to its share of the frames,
    so every client's window holds two classes whenever the frames carry
    a second class of a window's share. With random weights the flagship
    gives its frames two or three classes, unevenly; a window of the
    frames in their own order can hold one."""
    counts, seen, keys = {}, {}, []
    for c in classes:
        counts[c] = counts.get(c, 0) + 1
    for i, c in enumerate(classes):
        seen[c] = seen.get(c, 0) + 1
        keys.append(((seen[c] - 0.5) / counts[c], i))
    return [i for _, i in sorted(keys)]


def _run_serving(server_line, clients, client_caps, client_tail="",
                 decoder="", traced=True, client_connect="", inspect=None):
    """Play ``server_line`` and one client pipeline per entry of
    ``clients`` (each ``(frames, offsets)``: the frames it pushes and, for
    an open-loop run, the second after the start at which it pushes each;
    None pushes them back to back), all started together in threads.
    Returns (per-client results, the server's serving report, seconds from
    the first push to the last reply, the served filter's forward and
    device). Each frame's pts names its client and index, so a reply
    names the request it answers. ``client_connect`` replaces the
    clients' ``port=<the server's>`` (HYBRID: the broker and topic); each
    client's result also gives the ms its pipeline took to start
    (``play_ms``: connecting, and for HYBRID discovering, the server).
    ``inspect(server, tracer)`` runs after the last reply, before the
    server stops."""
    import threading

    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.pipeline import parse_launch

    server = parse_launch(server_line)
    tracer = trace.attach(server) if traced else None
    server.play()
    res = {}
    t0 = [0.0]
    # every client connected and playing before the first push; the
    # barrier's action stamps the start all offsets count from
    ready = threading.Barrier(
        len(clients) + 1, timeout=60,
        action=lambda: t0.__setitem__(0, time.perf_counter()))
    try:
        port = _element(server, "tensor_query_serversrc").port

        def client(i, frames, offsets):
            cl = parse_launch(
                f"appsrc name=src caps={client_caps} ! tensor_query_client "
                f"name=qc {client_connect or f'port={port}'} timeout=60 "
                f"{client_tail} ! {decoder}tensor_sink name=out")
            arrived = {}
            cl["out"].connect_new_data(
                lambda b: arrived.__setitem__(b.pts, time.perf_counter()))
            t_play = time.perf_counter()
            cl.play()
            play_ms = (time.perf_counter() - t_play) * 1e3
            pushed = {}
            try:
                ready.wait()
                for k, f in enumerate(frames):
                    if offsets is not None:
                        delay = t0[0] + offsets[k] - time.perf_counter()
                        if delay > 0:
                            time.sleep(delay)
                    pts = i * 1_000_000 + k
                    pushed[pts] = time.perf_counter()
                    cl["src"].push_buffer(Buffer(tensors=[f], pts=pts))
                cl["src"].end_of_stream()
                ok = cl.bus.wait_eos(180)
                res[i] = {"ok": ok, "error": cl.bus.error, "pushed": pushed,
                          "arrived": arrived, "play_ms": play_ms,
                          "out": list(cl["out"].collected),
                          "dropped": cl["qc"].error_stats["dropped"]}
            finally:
                cl.stop()

        threads = [threading.Thread(target=client, args=(i, fr, off),
                                    daemon=True)
                   for i, (fr, off) in enumerate(clients)]
        for t in threads:
            t.start()
        ready.wait()
        for t in threads:
            t.join(timeout=300)
            if t.is_alive():
                raise AssertionError("serve: a client pipeline hung")
        last = max((max(r["arrived"].values()) for r in res.values()
                    if r["arrived"]), default=t0[0])
        if inspect is not None:
            inspect(server, tracer)
        fw = _element(server, "tensor_filter").fw
        forward = (fw._bundle.apply_fn, fw._device)  # the backend closes
    finally:
        server.stop()
    if len(res) != len(clients):
        raise AssertionError(f"serve: {len(clients) - len(res)} client "
                             "pipeline(s) failed to run")
    for i, r in res.items():
        if not r["ok"] or r["error"] is not None:
            raise AssertionError(f"serve: client {i} failed: {r['error']}")
    serving = next(iter(tracer.serving().values())) if traced else None
    return res, serving, last - t0[0], forward


def _latencies_ms(res) -> list:
    return sorted((r["arrived"][k] - r["pushed"][k]) * 1e3
                  for r in res.values() for k in r["arrived"])


def _pct(sorted_vals, q: float):
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


def _serve_launches(name, launches, batches):
    if launches.get("fused_inverted_residual") != kernel_blocks() * batches or \
            launches.get("normalize_u8") != batches:
        raise AssertionError(f"serve {name}: launches {launches} over "
                             f"{batches} served batches")


def _check_replies(name, res, n_per_client):
    """Every client got exactly its own requests' replies, once each, in
    the order it sent them."""
    for i, r in res.items():
        got = [b.pts for b in r["out"]]
        want = sorted(r["pushed"])
        if got != want or len(got) != n_per_client:
            raise AssertionError(f"serve {name}: client {i} got pts "
                                 f"{got[:5]}... for {want[:5]}...")


def check_serve(torch, results, workdir):
    """The serving tier at full width: 8 clients x 32 frames through the
    continuous-batching server (labels and logits against the direct
    forward at batch 32, launch counts per served batch, the serving
    report, requests/s and request latency), one torch.profiler run, a
    run at twice the measured capacity (open-loop Poisson arrivals,
    serve-queue-depth=32: queue-full sheds, every admitted request
    answered once by the right client), then the three reference serving
    lines of examples/launch_lines_serving.txt as written."""
    import numpy as np

    from nnstreamer_tpu_torch.ops import _cuda

    labels, frames = results["flag_labels"], results["flag_frames"]
    names = [f"class{i}" for i in range(1001)]
    decoder = f"tensor_decoder mode=image_labeling option1={labels} ! "
    # each client's frames from an order that spreads the classes the
    # filter gave the frames in the slice phase, so that a reply shifted
    # by one row changes a label in every client (the check below)
    order = _class_spread(results["flag_classes"])
    clients = [(_serve_frames(frames, i, order=order), None)
               for i in range(SERVE_CLIENTS)]
    total = SERVE_CLIENTS * SERVE_PER_CLIENT
    # warm-up: one client (cuDNN plans, the allocator), not measured
    _run_serving(_serve_line(), clients[:1], SERVE_FRAME_CAPS,
                 traced=False)
    launches_all = {}

    def add_launches(launches):
        for k, v in launches.items():
            launches_all[k] = launches_all.get(k, 0) + v

    _cuda.reset_launches()
    res, srv, secs, (forward, device) = _run_serving(
        _serve_line(), clients, SERVE_FRAME_CAPS, decoder=decoder)
    launches = dict(_cuda.LAUNCHES)
    add_launches(launches)
    _serve_launches("labels", launches, srv["batches"])
    if srv["rows"] != total or srv["shed"] != 0 or srv["replies"] != total \
            or not srv["batch_fill"] > 1:
        raise AssertionError(f"serve: serving report {srv}")
    _check_replies("labels", res, SERVE_PER_CLIENT)
    # the direct forward of the same filter on each client's frames at
    # batch 32: its labels, and its logits for the second run
    want_logits = {}
    with torch.inference_mode():
        for i, (fr, _) in enumerate(clients):
            x = torch.from_numpy(np.stack(fr)).to(device)
            want_logits[i] = forward(x).float()
    torch.cuda.synchronize()
    label_ok, distinct = True, []
    for i, r in res.items():
        got = []
        for b in r["out"]:
            lab = b.meta["label"]
            got.extend(lab if isinstance(lab, list) else [lab])
        want = [names[j] for j in want_logits[i].argmax(-1).tolist()]
        label_ok = label_ok and got == want
        distinct.append(len(set(want)))
    lat = _latencies_ms(res)
    rps = total / secs
    # the logits: the same run with no decoder at the clients
    _cuda.reset_launches()
    res2, srv2, secs2, _ = _run_serving(_serve_line(), clients,
                                        SERVE_FRAME_CAPS)
    launches2 = dict(_cuda.LAUNCHES)
    add_launches(launches2)
    _serve_launches("logits", launches2, srv2["batches"])
    _check_replies("logits", res2, SERVE_PER_CLIENT)
    logits_err, logits_ok, bit_equal = 0.0, True, True
    shift_caught, rows_caught = True, 0
    for i, r in res2.items():
        want = want_logits[i]
        got = torch.from_numpy(np.stack(
            [np.asarray(b.tensors[0]).reshape(-1) for b in r["out"]])
        ).to(want.device)
        logits_err = max(logits_err, max_err(got, want))
        logits_ok = logits_ok and got.shape == want.shape and \
            within(got, want, 0.15, 0.05)
        bit_equal = bit_equal and torch.equal(got, want)
        # a demux off by one row must fail the same check: the replies
        # shifted by one row, against the direct forward
        shifted = got.roll(1, 0)
        shift_caught = shift_caught and not within(shifted, want, 0.15, 0.05)
        rows_caught += int((~((shifted - want).abs()
                              <= 0.15 + 0.05 * want.abs()).all(-1)).sum())
    lat2 = _latencies_ms(res2)
    emit("serve", clients=SERVE_CLIENTS, requests=total,
         serve_batch=SERVE_BATCH, seconds=secs, requests_per_s=rps,
         p50_request_ms=_pct(lat, 0.5), p99_request_ms=_pct(lat, 0.99),
         batches=srv["batches"], batch_fill=srv["batch_fill"],
         padded_rows=srv["padded_rows"],
         time_in_queue=srv["time_in_queue"], launches=launches,
         labels_equal_direct_forward=label_ok,
         distinct_labels_per_client=distinct,
         logits_run={"seconds": secs2, "requests_per_s": total / secs2,
                     "p50_request_ms": _pct(lat2, 0.5),
                     "p99_request_ms": _pct(lat2, 0.99),
                     "batches": srv2["batches"],
                     "batch_fill": srv2["batch_fill"],
                     "launches": launches2},
         logits_max_abs_err=logits_err, logits_atol=0.15, logits_rtol=0.05,
         logits_ok=logits_ok, logits_bit_equal=bit_equal,
         shifted_by_one_fails=shift_caught,
         shifted_rows_caught=rows_caught, card=results["card"])
    if not label_ok or not logits_ok:
        raise AssertionError("serve: a reply's label or logits disagree "
                             "with the direct forward")
    # the checks above could not see a mis-sliced row if every frame got
    # the same class, or if neighbouring rows' logits lay within the band
    if min(distinct) < 2 or not shift_caught:
        raise AssertionError(
            f"serve: the label and logits checks cannot tell rows apart "
            f"(distinct labels per client {distinct}, replies shifted by "
            f"one row pass: {not shift_caught})")

    # one run under torch.profiler: device busy, idle share, device time
    # by kernel
    def run():
        _cuda.reset_launches()
        _, sp, s, _ = _run_serving(_serve_line(), clients, SERVE_FRAME_CAPS)
        prof_launches = dict(_cuda.LAUNCHES)
        add_launches(prof_launches)
        _serve_launches("profile", prof_launches, sp["batches"])
        return s

    prof = device_profile(torch, run)
    emit("profile", line="serve", requests=total, **prof)
    # the measured device ms a served row (robust phase prints the
    # static plant seed beside it)
    results["serve_row_device_ms"] = (
        prof["device_busy_ms"] / total if prof["device_busy_ms"] else None)

    # 2x the measured capacity, open loop: Poisson arrivals per client at
    # 2 * rps / 8, for OVERLOAD_S seconds, queue bound 32
    rate = 2.0 * rps / SERVE_CLIENTS
    rng = np.random.default_rng(7)
    over = []
    for i in range(SERVE_CLIENTS):
        offs = np.cumsum(rng.exponential(1.0 / rate, int(rate * OVERLOAD_S
                                                        * 1.5) + 8))
        offs = offs[offs < OVERLOAD_S]
        over.append((_serve_frames(frames, i, len(offs)), list(offs)))
    _cuda.reset_launches()
    res3, srv3, secs3, _ = _run_serving(
        _serve_line(depth=OVERLOAD_DEPTH), over, SERVE_FRAME_CAPS,
        client_tail="on-error=drop max-in-flight=100000")
    launches3 = dict(_cuda.LAUNCHES)
    add_launches(launches3)
    _serve_launches("overload", launches3, srv3["batches"])
    offered = sum(len(r["pushed"]) for r in res3.values())
    delivered = sum(len(r["out"]) for r in res3.values())
    dropped = sum(r["dropped"] for r in res3.values())
    own_once = all(
        len({b.pts for b in r["out"]}) == len(r["out"])
        and all(b.pts // 1_000_000 == i and b.pts in r["pushed"]
                for b in r["out"])
        for i, r in res3.items())
    lat3 = _latencies_ms(res3)
    first = min(min(r["pushed"].values()) for r in res3.values())
    last_push = max(max(r["pushed"].values()) for r in res3.values())
    # a batch must leave while the clients still send: a scheduler that
    # ingests until its queue is empty answers nothing until they stop
    first_reply = min((min(r["arrived"].values()) for r in res3.values()
                       if r["arrived"]), default=float("inf"))
    served_while_sending = first_reply < last_push
    emit("serve_overload", target_rps=2.0 * rps,
         offered_rps=offered / max(1e-9, last_push - first),
         offered=offered, admitted=srv3["enqueued"], shed=srv3["shed"],
         shed_reasons=srv3["shed_reasons"], replies=srv3["replies"],
         delivered=delivered, client_drops=dropped,
         admitted_p50_ms=_pct(lat3, 0.5), admitted_p99_ms=_pct(lat3, 0.99),
         goodput_rps=delivered / secs3, seconds=secs3,
         batches=srv3["batches"], batch_fill=srv3["batch_fill"],
         replies_own_client_once=own_once,
         served_while_sending=served_while_sending, launches=launches3,
         card=results["card"])
    if not (srv3["shed"] > 0 and srv3["shed_reasons"].get("queue-full", 0) > 0
            and own_once and delivered == srv3["replies"] == srv3["enqueued"]
            and delivered + dropped == offered and served_while_sending):
        raise AssertionError("serve: the 2x run did not shed on queue-full, "
                             "lost or misrouted an admitted request, or "
                             "answered nothing while the clients sent")
    results["serve_launches"] = launches_all
    check_serve_lines(results)


def check_serve_lines(results):
    """The three lines of examples/launch_lines_serving.txt as written
    (model=add on the card): 4 clients x 8 requests each, every answer
    exactly x + 1, in order. The clients keep one request in flight and
    retry a shed (the multi-tenant line's rate limit)."""
    import numpy as np

    with open(os.path.join(ROOT, "examples", "launch_lines_serving.txt"),
              encoding="utf-8") as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    rows = []
    for line in lines:
        n = 8 if "dimensions=8" in line else 4
        caps = (f"other/tensors,num-tensors=1,dimensions={n},"
                "types=float32,framerate=0/1")
        sid = line.split(" id=", 1)[1].split()[0]
        clients = [([np.full(n, 10.0 * i + k, np.float32) for k in range(8)],
                    None) for i in range(4)]
        res, srv, secs, _ = _run_serving(
            line, clients, caps,
            client_tail="max-in-flight=1 on-error=retry:12 "
                        "retry-backoff-ms=10")
        ok = True
        for i, r in res.items():
            got = [np.asarray(b.tensors[0]).reshape(-1) for b in r["out"]]
            want = [fr + 1 for fr in clients[i][0]]
            ok = ok and len(got) == 8 and all(
                np.array_equal(g, w) for g, w in zip(got, want))
        rows.append({"id": sid, "exact": ok, "replies": srv["replies"],
                     "shed": srv["shed"], "batches": srv["batches"],
                     "batch_fill": srv["batch_fill"], "seconds": secs})
    emit("serve_lines", lines=rows, card=results["card"])
    if not all(r["exact"] and r["replies"] == 32 for r in rows):
        raise AssertionError("serve_lines: a reference serving line did not "
                             "answer exactly")


# -- phase: the multi-stream lines ---------------------------------------------

#: frames per camera per merged batch (line A): two cameras make BATCH
CAM_FPT = BATCH // 2
#: line B's boxes per frame (tensor_region option1)
CROP_TOP = 4
#: line B's measured frames, one per buffer (after 2 warm-up frames)
CROP_FRAMES = 32
#: line C's frames and its dark share
GATED_FRAMES = 256
GATED_DARK = GATED_FRAMES // 4


def _crossings_of(tracer) -> dict:
    c = tracer.crossings()
    return {"h2d": c["h2d"], "d2h": c["d2h"],
            "per_element": {el: {"h2d": v["h2d"], "d2h": v["d2h"]}
                            for el, v in c["per_element"].items()}}


def _two_camera_line(labels: str) -> str:
    cam = (f"appsrc name=c{{i}} caps=video/x-raw,format=RGB,width={SIZE},"
           f"height={SIZE},framerate=1000/1 ! tensor_converter "
           f"frames-per-tensor={CAM_FPT} ! m.sink_{{i}} ")
    out = (f"s.src_{{i}} ! tensor_decoder mode=image_labeling "
           f"option1={labels} ! tensor_sink name=o{{i}} ")
    return (cam.format(i=0) + cam.format(i=1)
            + "tensor_merge name=m mode=linear option=3 ! tensor_filter "
            "name=f framework=jax model=mobilenet_v2 "
            "custom=seed:0,postproc:argmax,fused:pallas ! tensor_split "
            f"name=s tensorseg={CAM_FPT},{CAM_FPT} "
            + out.format(i=0) + out.format(i=1))


def _push_cameras(p, cams, batches, pts0, pushed):
    """Push ``batches`` merged batches, the cameras interleaved batch by
    batch (each appsrc queues and feeds its own streaming thread, so
    neither camera waits on the other). ``pushed[k]`` becomes the time the
    last frame of batch k went in."""
    from nnstreamer_tpu_torch.buffer import Buffer

    for k in range(pts0, pts0 + batches):
        for i in range(2):
            for j in range(CAM_FPT):
                p[f"c{i}"].push_buffer(Buffer(tensors=[cams[i][j]],
                                              pts=k * CAM_FPT + j))
        pushed[k] = time.perf_counter()


def _wait_for(counts, want, p, what):
    deadline = time.monotonic() + 600
    while min(counts()) < want:
        if p.bus.error is not None:
            raise RuntimeError(f"{what} failed: {p.bus.error.data}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what}: outputs did not arrive")
        time.sleep(0.001)


def check_two_cameras(torch, labels, results):
    """Line A: two cameras, CAM_FPT frames per tensor each, merged along
    the frames dim into one MobileNet-v2 batch of BATCH and split back per
    camera. Per merged batch: 17 fused-block and 1 normalize_u8 launches,
    one h2d and one d2h, both at the filter (the residency boundary before
    the split); each camera's labels
    equal to the direct forward's of the merged frames."""
    import numpy as np

    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    cams = [_vision_frames(10 + i, CAM_FPT, SIZE) for i in range(2)]
    p = parse_launch(_two_camera_line(labels))
    arrived = {}
    for i in range(2):
        p[f"o{i}"].connect_new_data(
            lambda b, i=i: arrived.__setitem__((i, b.pts // CAM_FPT),
                                               time.perf_counter()))
    p.play()
    pushed = {}
    _push_cameras(p, cams, N_WARMUP, 0, pushed)
    _wait_for(lambda: [len(p[f"o{i}"].collected) for i in range(2)],
              N_WARMUP, p, "two cameras")
    tracer = trace.attach(p)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    _push_cameras(p, cams, N_BATCHES, N_WARMUP, pushed)
    _wait_for(lambda: [len(p[f"o{i}"].collected) for i in range(2)],
              N_WARMUP + N_BATCHES, p, "two cameras")
    secs = max(arrived.values()) - t0
    launches = dict(_cuda.LAUNCHES)
    crossings = _crossings_of(tracer)
    forward = p["f"].fw._bundle.apply_fn
    got = [[b.meta["label"] for b in p[f"o{i}"].collected[N_WARMUP:]]
           for i in range(2)]
    p["c0"].end_of_stream()
    p["c1"].end_of_stream()
    if not p.bus.wait_eos(120) or p.bus.error is not None:
        raise RuntimeError(f"two cameras at EOS: {p.bus.error}")
    p.stop()
    merged = torch.from_numpy(np.stack(cams[0] + cams[1])).cuda()
    with torch.inference_mode():
        want = forward(merged).float().argmax(-1).tolist()
    want = [[f"class{c}" for c in want[:CAM_FPT]],
            [f"class{c}" for c in want[CAM_FPT:]]]
    # the cameras' frames differ, and so do their labels: a split that
    # swapped the cameras would show
    labels_ok = want[0] != want[1] and all(
        len(got[i]) == N_BATCHES and all(b == want[i] for b in got[i])
        for i in range(2))
    lat = [(max(arrived[(0, k)], arrived[(1, k)]) - pushed[k]) * 1e3
           for k in range(N_WARMUP, N_WARMUP + N_BATCHES)]
    per = crossings["per_element"]
    counts_ok = (launches["fused_inverted_residual"] == kernel_blocks() * N_BATCHES
                 and launches["normalize_u8"] == N_BATCHES
                 and crossings["h2d"] == N_BATCHES
                 and crossings["d2h"] == N_BATCHES
                 and per.get("f") == {"h2d": N_BATCHES, "d2h": N_BATCHES})
    frames = N_BATCHES * BATCH
    emit("streams", line="two_cameras", cameras=2,
         frames_per_camera_per_tensor=CAM_FPT, batch=BATCH,
         batches=N_BATCHES, frames=frames, seconds=secs, fps=frames / secs,
         p50_batch_latency_ms=statistics.median(lat), launches=launches,
         crossings=crossings, labels_equal_direct_forward=labels_ok,
         distinct_labels=len({lb for cam in want for lb in cam}),
         counts_ok=counts_ok, card=results["card"])
    if not (labels_ok and counts_ok):
        raise AssertionError("streams: two cameras' labels, launches or "
                             "crossings are wrong")
    return launches


def _detect_crop_line(priors: str, size: int) -> str:
    return (f"appsrc name=src caps=video/x-raw,format=RGB,width={size},"
            f"height={size},framerate=1000/1 ! tensor_converter ! tee name=t "
            "t. ! queue ! tensor_filter name=f framework=jax "
            "model=ssd_mobilenet custom=seed:0,classes:91,fused:pallas "
            f"! tensor_decoder name=dec mode=tensor_region "
            f"option1={CROP_TOP} option3={priors}:0.5 "
            f"option4={size}:{size} ! tensor_converter ! c.info "
            "t. ! queue ! c.raw tensor_crop name=c ! tensor_sink name=out")


def _expected_crops(torch, forward, frame, priors, size):
    """The frame sliced at the regions the port's tensor_region decoder
    gives on the direct forward of ``frame`` (the filter's input shape)."""
    import numpy as np

    from nnstreamer_tpu_torch.buffer import Buffer, materialize_tensors
    from nnstreamer_tpu_torch.decoders.tensor_region import TensorRegion
    from nnstreamer_tpu_torch.meta import unwrap_flexible
    from nnstreamer_tpu_torch.types import (
        TensorInfo,
        TensorsConfig,
        TensorsInfo,
    )

    with torch.inference_mode():
        raw = materialize_tensors(list(forward(
            torch.from_numpy(frame).cuda())))
    dec = TensorRegion()
    dec.init([str(CROP_TOP), None, f"{priors}:0.5", f"{size}:{size}"]
             + [None] * 5)
    cfg = TensorsConfig(TensorsInfo(tensors=[
        TensorInfo.from_np_shape(r.shape, str(r.dtype)) for r in raw]), 0, 1)
    dec.get_out_caps(cfg)
    blob = dec.decode(Buffer(tensors=raw), cfg).tensors[0]
    regions = unwrap_flexible(blob)[0].reshape(-1, 4).astype(np.int64)
    return [frame[max(0, y):max(max(0, y), min(size, y + h)),
                  max(0, x):max(max(0, x), min(size, x + w))]
            for x, y, w, h in regions]


def check_detect_crop(torch, workdir, results):
    """Line B: SSD-MobileNet-v2 at 300 px, one frame per buffer, into
    tensor_region (the top CROP_TOP boxes), the converter's flexible path
    and tensor_crop.info; the frame itself into tensor_crop.raw. Every
    frame's crops byte-equal the frame sliced at the regions the decoder
    gives on the direct forward of that frame; 17 fused-block and 1
    normalize_u8 launches per frame; then a profile of the line."""
    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.models.ssd_mobilenet import write_box_priors
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    size = VISION["ssd_mobilenet"]["size"]
    priors = os.path.join(workdir, "streams_priors.txt")
    write_box_priors(priors, size)
    frames = _vision_frames(21, CROP_FRAMES, size)

    def run(n, warm=N_WARMUP, traced=False):
        from nnstreamer_tpu_torch.buffer import Buffer

        p = parse_launch(_detect_crop_line(priors, size))
        arrived = []
        p["out"].connect_new_data(
            lambda b: arrived.append(time.perf_counter()))
        p.play()
        for i in range(warm):
            p["src"].push_buffer(Buffer(tensors=[frames[i]], pts=i))
        _wait_for(lambda: [len(arrived)], warm, p, "detect-crop")
        tracer = trace.attach(p) if traced else None
        _cuda.reset_launches()
        pushed = []
        t0 = time.perf_counter()
        for i in range(n):
            p["src"].push_buffer(Buffer(tensors=[frames[i]], pts=warm + i))
            pushed.append(time.perf_counter())
        _wait_for(lambda: [len(arrived)], warm + n, p, "detect-crop")
        secs = arrived[-1] - t0
        launches = dict(_cuda.LAUNCHES)
        lat = [(a - b) * 1e3 for a, b in zip(arrived[warm:], pushed)]
        p["src"].end_of_stream()
        if not p.bus.wait_eos(120) or p.bus.error is not None:
            raise RuntimeError(f"detect-crop at EOS: {p.bus.error}")
        crops = [b.tensors for b in p["out"].collected[warm:]]
        forward = p["f"].fw._bundle.apply_fn
        p.stop()
        return secs, lat, launches, tracer, crops, forward

    secs, lat, launches, tracer, crops, forward = run(CROP_FRAMES,
                                                      traced=True)
    crossings = _crossings_of(tracer)
    exact, nonempty = True, 0
    for frame, got in zip(frames, crops):
        want = _expected_crops(torch, forward, frame, priors, size)
        exact = exact and len(got) == len(want) == CROP_TOP and all(
            g.shape == w.shape and g.tobytes() == w.tobytes()
            for g, w in zip(got, want))
        nonempty += sum(1 for g in got if g.size)
    counts_ok = (launches["fused_inverted_residual"] == kernel_blocks("ssd_mobilenet") * CROP_FRAMES
                 and launches["normalize_u8"] == CROP_FRAMES
                 and crossings["h2d"] == CROP_FRAMES
                 and crossings["d2h"] == CROP_FRAMES)
    emit("streams", line="detect_crop", frames=CROP_FRAMES,
         frames_per_buffer=1, size=size, top=CROP_TOP, seconds=secs,
         fps=CROP_FRAMES / secs, p50_frame_latency_ms=statistics.median(lat),
         launches=launches, crossings=crossings, crops_byte_equal=exact,
         nonempty_crops=nonempty, counts_ok=counts_ok, card=results["card"])
    if not (exact and counts_ok and len(crops) == CROP_FRAMES
            and nonempty > 0):
        raise AssertionError("streams: detect-crop crops, launches or "
                             "crossings are wrong (or every crop is empty)")
    emit("profile", line="detect_crop", frames=CROP_FRAMES // 2,
         **device_profile(torch, lambda: run(CROP_FRAMES // 2, warm=1)[0]))
    return launches


def _gated_line(labels: str, gate: bool, extra: str, fpt: int) -> str:
    line = _flag_line(labels, extra, fpt=fpt)
    if gate:
        line = line.replace(
            "! tensor_filter ",
            "! tensor_if name=gate compared-value=TENSOR_AVERAGE_VALUE "
            "compared-value-option=0 operator=gt supplied-value=16 "
            "then=PASSTHROUGH else=SKIP ! tensor_filter ", 1)
    return line


def check_gated(torch, labels, results):
    """Line C: the live camera (one frame per buffer, batch-size=32
    fetch-timeout-ms=50 fetch-window=auto, as in check_batch) with
    tensor_if skipping frames whose mean is not above 16. GATED_FRAMES
    seeded frames, a seeded GATED_DARK of them dark: exactly the bright
    frames are labelled, in order, with the labels of the
    frames-per-tensor=32 line on the bright frames alone."""
    import numpy as np

    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    rng = np.random.default_rng(31)
    frames = _vision_frames(30, GATED_FRAMES, SIZE)
    dark = set(rng.choice(GATED_FRAMES, GATED_DARK, replace=False).tolist())
    for i in dark:
        frames[i] = np.kron(rng.integers(0, 24, (4, 4, 3)), np.ones(
            (SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
    bright = [i for i in range(GATED_FRAMES) if i not in dark]
    if any(frames[i].mean() >= 16 for i in dark) or any(
            frames[i].mean() <= 16 for i in bright):
        raise AssertionError("streams: the seeded frames do not split at 16")
    ref = _LineDriver(_gated_line(labels, False, "fetch-window=1",
                                  LIVE_BATCH),
                      [frames[i] for i in bright],
                      outputs_per_unit=len(bright) // LIVE_BATCH)
    ref.run(1)
    ref.close()
    want = _labels_of(ref.p)
    live = (f"batch-size={LIVE_BATCH} fetch-timeout-ms={LIVE_TIMEOUT_MS} "
            "fetch-window=auto")
    p = parse_launch(_gated_line(labels, True, live, 1))
    arrived = {}
    p["out"].connect_new_data(
        lambda b: arrived.__setitem__(b.pts, time.perf_counter()))
    p.play()
    # warm-up: one batch of bright frames, out of the counts
    for i in range(LIVE_BATCH):
        p["src"].push_buffer(Buffer(tensors=[frames[bright[i]]],
                                    pts=-1 - i))
    _wait_for(lambda: [len(arrived)], LIVE_BATCH, p, "gated")
    tracer = trace.attach(p)
    _cuda.reset_launches()
    pushed = {}
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        p["src"].push_buffer(Buffer(tensors=[f], pts=i))
        pushed[i] = time.perf_counter()
    _wait_for(lambda: [len(arrived)], LIVE_BATCH + len(bright), p, "gated")
    secs = max(arrived.values()) - t0
    launches = dict(_cuda.LAUNCHES)
    crossings = _crossings_of(tracer)
    p["src"].end_of_stream()
    if not p.bus.wait_eos(120) or p.bus.error is not None:
        raise RuntimeError(f"gated line at EOS: {p.bus.error}")
    outs = p["out"].collected[LIVE_BATCH:]
    p.stop()
    got = [b.meta["label"] for b in outs]
    got = [lb for g in got for lb in (g if isinstance(g, list) else [g])]
    order = [b.pts for b in outs]
    n_batches = len(bright) // LIVE_BATCH
    lat = [(arrived[i] - pushed[i]) * 1e3 for i in bright]
    ok = (order == bright and got == want
          and launches["fused_inverted_residual"] == kernel_blocks() * n_batches
          and launches["normalize_u8"] == n_batches)
    emit("streams", line="gated", frames=GATED_FRAMES, dark=len(dark),
         labelled=len(got), labelled_in_order=order == bright,
         labels_equal_fpt32=got == want, batch=LIVE_BATCH, seconds=secs,
         fps_in=GATED_FRAMES / secs, fps_labelled=len(got) / secs,
         p50_frame_latency_ms=statistics.median(lat), launches=launches,
         crossings=crossings, card=results["card"])
    if not ok:
        raise AssertionError("streams: the gated line labelled other frames, "
                             "other labels or launched other counts")
    return launches


def check_streams(torch, results, workdir):
    """Lines A (two cameras), B (detect, then crop) and C (gated live
    camera) at full width; their launches add up into streams_launches."""
    labels = os.path.join(workdir, "streams_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    total = {}
    for launches in (check_two_cameras(torch, labels, results),
                     check_detect_crop(torch, workdir, results),
                     check_gated(torch, labels, results)):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    results["streams_launches"] = total


# -- phase: the planner's transform fusion and residency lane ----------------

#: the reference NNStreamer preamble (tests/test_elements.py:97)
PREAMBLE = "typecast:float32,add:-127.5,div:127.5"


def _preamble_line(labels: str, fusion: str = "auto") -> str:
    """The flagship line with the preamble before the filter; fusion=off
    on the transform keeps it a live host element."""
    return (
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=1000/1 "
        f"! tensor_converter frames-per-tensor={BATCH} "
        f"! tensor_transform name=tr mode=arithmetic option={PREAMBLE} "
        f"fusion={fusion} "
        "! tensor_filter name=f framework=jax model=mobilenet_v2 "
        "custom=seed:0,postproc:argmax,fused:pallas "
        f"! queue ! tensor_decoder mode=image_labeling option1={labels} "
        "! tensor_sink name=out")


def _fanout_line() -> str:
    """The fused preamble filter into a tee of two sinks."""
    return (
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=1000/1 "
        f"! tensor_converter frames-per-tensor={BATCH} "
        f"! tensor_transform name=tr mode=arithmetic option={PREAMBLE} "
        "! tensor_filter name=f framework=jax model=mobilenet_v2 "
        "custom=seed:0,postproc:argmax,fused:pallas ! tee name=t "
        "t. ! queue ! tensor_sink name=out t. ! queue ! tensor_sink name=o2")


def _two_filter_line() -> str:
    """MobileNet-v2's logits through a queue into a second filter, each
    filter its own program (chain-fusion=off on the second: the lane
    between two programs is what this line checks; the chain phase fuses
    such a cascade)."""
    return (
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=1000/1 "
        f"! tensor_converter frames-per-tensor={BATCH} "
        "! tensor_filter name=f1 framework=jax model=mobilenet_v2 "
        "custom=seed:0,fused:pallas ! queue "
        "! tensor_filter name=f2 framework=jax model=add custom=k:1 "
        "chain-fusion=off ! tensor_sink name=out")


#: input types the arith kernel does not read: the fused preamble's
#: leading typecast:float32 converts them before the launch
WIDE_TYPES = ("float64", "float16", "int64", "uint32")
WIDE_FRAMES = 8


def _wide_line(dtype: str) -> str:
    """Full-size frames of ``dtype`` through the preamble into a filter."""
    return (
        "appsrc name=src caps=other/tensors,num-tensors=1,"
        f"dimensions=3:{SIZE}:{SIZE}:{WIDE_FRAMES},types={dtype},"
        f"framerate=0/1 ! tensor_transform name=tr mode=arithmetic "
        f"option={PREAMBLE} ! tensor_filter name=f framework=jax model=add "
        "custom=k:1 ! tensor_sink name=out")


def check_wide_inputs(torch, results, total):
    """The fused preamble on frames of each type the arith kernel does not
    read: the stage converts them to float32 and launches the kernel once
    per buffer; the output is bit-equal to numpy's astype(float32), the
    chain and the model's +1, and the upload carries the input's bytes."""
    import numpy as np

    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    rng = np.random.default_rng(5)
    shape = (WIDE_FRAMES, SIZE, SIZE, 3)
    rows = {}
    for dtype in WIDE_TYPES:
        if dtype.startswith("float"):
            x = (rng.normal(0, 300, shape) + 1 / 3).astype(dtype)
        else:
            x = rng.integers(2 ** 24, 2 ** 31, shape).astype(dtype)
        p = parse_launch(_wide_line(dtype))
        tracer = trace.attach(p)
        _cuda.reset_launches()
        p.play()
        for k in range(2):
            p["src"].push_buffer(Buffer(tensors=[x], pts=k))
        p["src"].end_of_stream()
        if not p.bus.wait_eos(120) or p.bus.error is not None:
            raise RuntimeError(f"residency: the {dtype} line failed: "
                               f"{p.bus.error}")
        launches = dict(_cuda.LAUNCHES)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        outs = [np.asarray(b.tensors[0]) for b in p["out"].collected]
        f = tracer.crossings()["per_element"].get("f", {})
        fusions = tracer.fusions()
        p.stop()
        want = ((x.astype(np.float32) + np.float32(-127.5))
                / np.float32(127.5)) + np.float32(1)
        rows[dtype] = {
            "fusions": fusions, "arith_chain": launches["arith_chain"],
            "h2d_bytes": f.get("h2d_bytes", 0),
            "bit_equal_numpy": len(outs) == 2 and all(
                o.dtype == np.float32 and np.array_equal(o, want)
                for o in outs)}
        rows[dtype]["ok"] = (rows[dtype]["bit_equal_numpy"]
                             and fusions == {"tr": "fused-into:f"}
                             and launches["arith_chain"] == 2
                             and f.get("h2d_bytes") == 2 * x.nbytes)
    ok = all(r["ok"] for r in rows.values())
    emit("residency", line="wide_inputs", frames=WIDE_FRAMES, buffers=2,
         types=rows, ok=ok, card=results["card"])
    if not ok:
        raise AssertionError("residency: the fused preamble is wrong on an "
                             "input type the kernel does not read")


def _run_line(line, frames, n_batches, warm=N_WARMUP):
    """Warm ``warm`` batches, then trace and time ``n_batches``; returns
    (pipeline, tracer, seconds, p50 batch latency ms, the launches of the
    timed run). The sink 'out' collects every buffer; the tracer holds
    the planner's fusions and the timed run's crossings."""
    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    p = parse_launch(line)
    pushed, arrived = {}, {}
    p["out"].connect_new_data(
        lambda b: arrived.__setitem__(b.pts, time.perf_counter()))
    fusions = trace.attach(p).fusions  # the planner records at play()
    p.play()

    def push(k0, n):
        for i in range(k0 * BATCH, (k0 + n) * BATCH):
            p["src"].push_buffer(Buffer(tensors=[frames[i % len(frames)]],
                                        pts=i))
            pushed[i] = time.perf_counter()
        _wait_for(lambda: [len(p["out"].collected)], k0 + n, p, line[-40:])

    push(0, warm)
    tracer = trace.attach(p, replace=True)
    tracer.fusions = fusions
    _cuda.reset_launches()
    t0 = time.perf_counter()
    push(warm, n_batches)
    secs = max(arrived.values()) - t0
    launches = dict(_cuda.LAUNCHES)
    p["src"].end_of_stream()
    if not p.bus.wait_eos(120) or p.bus.error is not None:
        raise RuntimeError(f"residency line failed: {p.bus.error}")
    lat = [(arrived[k] - pushed[k]) * 1e3 for k in arrived
           if k >= warm * BATCH]
    return p, tracer, secs, statistics.median(lat), launches


def check_residency(torch, results, workdir):
    """The flagship line with the preamble, fused (the transform runs
    inside the filter through arith_chain, the upload carries uint8) and
    unfused (fusion=off: numpy on the host, float32 uploaded); a tee
    fan-out after the filter; two filters through a queue."""
    import numpy as np

    from nnstreamer_tpu_torch.ops import _cuda

    labels = os.path.join(workdir, "residency_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    rng = np.random.default_rng(3)
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(BATCH)]
    frame_bytes = BATCH * SIZE * SIZE * 3
    total = {}
    runs = {}
    for fusion in ("auto", "off"):
        p, tracer, secs, p50, launches = _run_line(
            _preamble_line(labels, fusion), frames, N_BATCHES)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        cr = tracer.crossings()
        f = cr["per_element"].get("f", {})
        stage = p["f"].fw._stage_pre
        runs[fusion] = {
            "fps": N_BATCHES * BATCH / secs, "p50_batch_latency_ms": p50,
            "fusions": tracer.fusions(),
            "h2d_bytes_per_batch": f.get("h2d_bytes", 0) / N_BATCHES,
            "crossings": _crossings_of(tracer), "launches": launches,
            "labels": [lab for b in p["out"].collected[-N_BATCHES:]
                       for lab in b.meta["label"]]}
        p.stop()
        if fusion == "auto":
            # the fused stage on the card against numpy's preamble on the
            # same frames (its launches are not the line's)
            x = np.stack(frames)
            with torch.inference_mode():
                got = stage(torch.from_numpy(x).cuda()).cpu().numpy()
            want = ((x.astype(np.float32) + np.float32(-127.5))
                    / np.float32(127.5))
            runs[fusion]["stage_bit_equal_numpy"] = bool(
                got.dtype == want.dtype and np.array_equal(got, want))
    fused, unfused = runs["auto"], runs["off"]
    labels_equal = fused["labels"] == unfused["labels"] and \
        len(fused["labels"]) == N_BATCHES * BATCH
    ok = (labels_equal and fused["stage_bit_equal_numpy"]
          and fused["fusions"] == {"tr": "fused-into:f"}
          and unfused["fusions"] == {}
          and fused["h2d_bytes_per_batch"] == frame_bytes
          and unfused["h2d_bytes_per_batch"] == frame_bytes * 4
          and fused["launches"]["arith_chain"] == N_BATCHES
          and unfused["launches"]["arith_chain"] == 0
          and fused["launches"]["normalize_u8"] == 0
          and fused["launches"]["fused_inverted_residual"] == kernel_blocks() * N_BATCHES
          and all(r["crossings"]["per_element"].get("f")
                  == {"h2d": N_BATCHES, "d2h": N_BATCHES}
                  and r["crossings"]["h2d"] == r["crossings"]["d2h"]
                  == N_BATCHES for r in runs.values()))
    distinct = len(set(fused["labels"]))
    for r in runs.values():
        r.pop("labels")
    emit("residency", line="preamble", batches=N_BATCHES, batch=BATCH,
         fused=fused, unfused=unfused, labels_equal=labels_equal,
         distinct_labels=distinct, card=results["card"])
    if not ok:
        raise AssertionError("residency: the preamble lines are wrong")
    for fusion in ("auto", "off"):
        def run(fusion=fusion):
            p, _, secs, _, _ = _run_line(_preamble_line(labels, fusion),
                                         frames, 4, warm=0)
            p.stop()
            return secs

        tag = "fused" if fusion == "auto" else "unfused"
        emit("profile", line=f"preamble_{tag}", batches=4,
             **device_profile(torch, run))

    # the tee fan-out: one boundary at the filter serves both branches
    p, tracer, secs, p50, launches = _run_line(_fanout_line(), frames,
                                               N_BATCHES)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    cr = _crossings_of(tracer)
    branches_equal = [np.asarray(b.tensors[0]).tolist()
                      for b in p["out"].collected] == \
        [np.asarray(b.tensors[0]).tolist() for b in p["o2"].collected]
    p.stop()
    fan_ok = (branches_equal and cr["d2h"] == N_BATCHES
              and list(cr["per_element"]) == ["f"]
              and cr["per_element"]["f"] == {"h2d": N_BATCHES,
                                             "d2h": N_BATCHES}
              and launches["arith_chain"] == N_BATCHES)
    emit("residency", line="fanout", batches=N_BATCHES,
         fps=N_BATCHES * BATCH / secs, p50_batch_latency_ms=p50,
         crossings=cr, launches=launches, branches_equal=branches_equal,
         ok=fan_ok, card=results["card"])
    if not fan_ok:
        raise AssertionError("residency: the fan-out fetched more than once "
                             "per batch, or not at the filter")

    # two filters through a queue: the logits stay on the card between them
    p, tracer, secs, p50, launches = _run_line(_two_filter_line(), frames,
                                               N_BATCHES)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    cr = _crossings_of(tracer)
    src = p["f1"].src_pad
    lane = {"f1_device_ok": src.device_ok,
            "f1_caps_hbm": bool(src.caps is not None
                                and src.caps.is_device_resident()),
            "f2_device_ok": p["f2"].src_pad.device_ok}
    out = torch.from_numpy(np.asarray(p["out"].collected[-1].tensors[0]))
    forward = p["f1"].fw._bundle.apply_fn
    p.stop()
    with torch.inference_mode():
        want = forward(torch.from_numpy(np.stack(frames)).cuda()).float().cpu()
    err = max_err(out.float(), want + 1)
    two_ok = (lane == {"f1_device_ok": True, "f1_caps_hbm": True,
                       "f2_device_ok": False}
              and cr["h2d"] == cr["d2h"] == N_BATCHES
              and cr["per_element"].get("f1", {}).get("h2d") == N_BATCHES
              and cr["per_element"].get("f2", {}).get("d2h") == N_BATCHES
              and tuple(out.shape) == (BATCH, 1001)
              and bool(torch.isfinite(out).all())
              and within(out.float(), want + 1, MODEL_ATOL, MODEL_RTOL))
    emit("residency", line="two_filters", batches=N_BATCHES,
         fps=N_BATCHES * BATCH / secs, p50_batch_latency_ms=p50,
         crossings=cr, lane=lane, launches=launches,
         logits_plus_one_max_abs_err=err, ok=two_ok, card=results["card"])
    if not two_ok:
        raise AssertionError("residency: the two-filter line's lane, "
                             "crossings or outputs are wrong")
    check_wide_inputs(torch, results, total)
    results["residency_launches"] = total


#: the training line (the reference's tests/test_training.py line at the
#: flagship's width): 256 frames, per epoch 192 train (6 steps at batch
#: 32) and 64 validation (2 batches), 3 epochs
TRAIN = {"frames": 256, "train": 192, "val": 64, "epochs": 3, "batch": 32,
         "classes": 16, "outputs": 1001, "lr": "0.01"}
#: train steps timed after 2 warm-up steps, validation batches after 2
TRAIN_TIMED, VAL_TIMED = 8, 4


def _train_custom(**extra) -> dict:
    return {"batch": str(TRAIN["batch"]), "lr": TRAIN["lr"],
            "size": str(SIZE), "width": "1.0",
            "classes": str(TRAIN["outputs"]), "seed": "0", **extra}


def _custom_str(custom: dict) -> str:
    return ",".join(f"{k}:{v}" for k, v in custom.items())


def _train_repo(workdir):
    """A datarepo of seeded uint8 224x224x3 frames with one-hot labels
    over 1001 outputs: 16 classes, each a seeded mean colour, plus noise,
    so the loss has something to learn. Returns (data, json, frames,
    class ids)."""
    import numpy as np

    rng = np.random.default_rng(12)
    n = TRAIN["frames"]
    means = rng.integers(32, 224, (TRAIN["classes"], 3))
    cls = rng.integers(0, TRAIN["classes"], n)
    noise = rng.normal(0.0, 24.0, (n, SIZE, SIZE, 3))
    frames = np.clip(means[cls][:, None, None, :] + noise, 0, 255).astype(
        np.uint8)
    onehot = np.zeros((n, TRAIN["outputs"]), np.float32)
    onehot[np.arange(n), cls] = 1.0
    data = os.path.join(workdir, "train.data")
    meta = os.path.join(workdir, "train.json")
    with open(data, "wb") as f:
        for i in range(n):
            f.write(frames[i].tobytes())
            f.write(onehot[i].tobytes())
    with open(meta, "w") as f:
        json.dump({"gst_caps": (
            "other/tensors,format=static,num_tensors=2,dimensions="
            f"3:{SIZE}:{SIZE}.{TRAIN['outputs']},types=uint8.float32,"
            "framerate=0/1"), "total_samples": n,
            "sample_size": frames[0].nbytes + onehot[0].nbytes}, f)
    return data, meta, frames, onehot


def _trainer(torch, custom, n_train, n_val=0, epochs=1):
    from nnstreamer_tpu_torch.trainers import TrainerProperties
    from nnstreamer_tpu_torch.trainers.cuda_trainer import CudaTrainer

    tr = CudaTrainer()
    props = TrainerProperties(
        model_config="mobilenet_v2", num_training_samples=n_train,
        num_validation_samples=n_val, num_epochs=epochs, custom=custom)
    tr.create(props)
    tr.start(lambda e: None)
    return tr, props


def _set_dtype(torch, module, dtype) -> None:
    """Run a zoo module's unfused and train forwards in ``dtype``."""
    for m in module.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype


def _first_step(torch, frames, onehot, device, dtype=None):
    """One train step of the line's first batch on a fresh trainer (seed:0
    weights): (loss, state dict on the host)."""
    custom = _train_custom(**({"device": "cpu"} if device == "cpu" else {}))
    tr, props = _trainer(torch, custom, TRAIN["batch"])
    if dtype is not None:
        _set_dtype(torch, tr._bundle.module, dtype)
    for i in range(TRAIN["batch"]):
        tr.push_data([frames[i], onehot[i]])
    return props.training_loss, _host_state(tr._bundle.module)


def _step_dist(a, b) -> dict:
    """Distances of two first steps (loss, state): the loss's, and the
    largest over the running statistics and over the weights."""
    def d(sel):
        return max(float((a[1][k] - b[1][k]).abs().max()) for k in a[1]
                   if sel(k))
    return {"loss": abs(a[0] - b[0]),
            "running_stats": d(lambda k: "running" in k),
            "weights": d(lambda k: "running" not in k)}


def check_train_step(torch, frames, onehot, results) -> None:
    """The card's first train step against the same step through the port
    on the CPU (the same seed:0 weights and 32 frames, the CPU's plain
    float32 preamble): the loss, the running statistics and the updated
    weights, each no farther from the CPU bfloat16 step than twice the CPU
    bfloat16 step's distance from the CPU float32 step (the step's own
    bf16 noise). Also how close normalize_u8's bfloat16 frames are to the
    CPU's float32 preamble rounded to bfloat16."""
    from nnstreamer_tpu_torch.ops.preprocess import normalize_u8

    t0 = time.perf_counter()
    card = _first_step(torch, frames, onehot, "cuda")
    cpu = _first_step(torch, frames, onehot, "cpu")
    cpu32 = _first_step(torch, frames, onehot, "cpu", torch.float32)
    cpu_s = time.perf_counter() - t0
    dist, noise = _step_dist(card, cpu), _step_dist(cpu, cpu32)
    ok = all(dist[k] <= 2 * noise[k] for k in dist)
    x = torch.from_numpy(frames[:TRAIN["batch"]])
    kern = normalize_u8(x.cuda()).float().cpu()
    plain = (x.float() / 127.5 - 1.0).to(torch.bfloat16).float()
    diff = (kern - plain).abs()
    ulp = torch.where(plain == 0, torch.ones_like(plain),
                      2.0 ** (torch.floor(torch.log2(plain.abs())) - 7))
    emit("train_step", losses={"card": card[0], "cpu_bf16": cpu[0],
                               "cpu_f32": cpu32[0]},
         card_vs_cpu_bf16=dist, cpu_bf16_vs_f32=noise, tolerance="2x noise",
         ok=ok, preamble_elements=diff.numel(),
         preamble_differ=int((diff > 0).sum()),
         preamble_max_abs=float(diff.max()),
         preamble_max_ulps=float((diff / ulp).max()), cpu_s=cpu_s,
         card=results["card"])
    if not ok:
        raise AssertionError(f"train step: card vs CPU {dist}, noise {noise}")


def _trained_serve_line(params: str) -> str:
    return (f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
            f"height={SIZE},framerate=1000/1 ! tensor_converter "
            f"frames-per-tensor={TRAIN['batch']} ! tensor_filter name=f "
            f"framework=jax model=mobilenet_v2 "
            f"custom=params:{params},fused:pallas ! tensor_sink name=out")


def check_refold(torch, module, forward, x, results) -> None:
    """The trainer's validation forward after training (fused:pallas,
    bfloat16, refolded at the first validation batch after each epoch's
    steps) against the unfused eval forward of the current weights: equal
    labels, and its distance no more than twice the unfused bfloat16
    forward's distance from the unfused float32 one (0.15 + 0.05·|p| lies
    below this network's bf16 noise: reported). The same kernel forward
    in float32 is held to 0.15 + 0.05·|p| and equal labels (TF32 off, as
    the kernel phase leaves it in a whole run). The forward folded from
    the initial weights must fail."""
    from nnstreamer_tpu_torch.models import get_model, preprocess_frames
    from nnstreamer_tpu_torch.models.mobilenet_v2 import _make_fused_apply

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        val = forward(x).float()
        unfused = module(preprocess_frames(x, "pm1", module.dtype)).float()
        _set_dtype(torch, module, torch.float32)
        pre32 = preprocess_frames(x, "pm1", torch.float32)
        unfused32 = module(pre32).float()
        _set_dtype(torch, module, torch.bfloat16)
        kernel32 = _make_fused_apply(module, mode="kernel",
                                     compute_dtype=torch.float32)(pre32)
        stale = get_model("mobilenet_v2", _train_custom(fused="pallas"),
                          "cuda").apply_fn(x).float()
    torch.cuda.synchronize()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    noise = max_err(unfused, unfused32)
    err, stale_err = max_err(val, unfused), max_err(stale, unfused)

    def labels_equal(a, b):
        return bool(torch.equal(a.argmax(-1), b.argmax(-1)))

    ok = labels_equal(val, unfused) and err <= 2 * noise
    ok32 = (labels_equal(kernel32, unfused32)
            and within(kernel32, unfused32, 0.15, 0.05))
    stale_fails = not (labels_equal(stale, unfused) and stale_err <= 2 * noise)
    emit("train_refold", frames=int(x.shape[0]),
         logits_max_abs=float(unfused.abs().max()),
         val_vs_unfused_max_abs=err, bf16_noise=noise,
         val_within_rule=within(val, unfused, 0.15, 0.05),
         labels_equal=labels_equal(val, unfused), ok=ok,
         f32_kernel_vs_unfused_max_abs=max_err(kernel32, unfused32),
         f32_ok=ok32, stale_vs_unfused_max_abs=stale_err,
         stale_labels_equal=int((stale.argmax(-1) == unfused.argmax(-1))
                                .sum()),
         stale_fails=stale_fails, card=results["card"])
    if not (ok and ok32 and stale_fails):
        raise AssertionError("train: the validation forward after training "
                             "does not run the current weights")


def time_training(torch, frames, onehot, results) -> None:
    """Train step and validation times on a trainer driven directly (no
    pipeline): the batch-completing push of each step (stack, one upload,
    forward, backward, update, the loss read), after 2 warm-up steps, and
    each validation batch after 2; the peak device memory; then a profile
    of 4 more steps."""
    custom = _train_custom(fused="pallas")
    n_steps, n_val = 2 + TRAIN_TIMED, 2 + VAL_TIMED
    torch.cuda.reset_peak_memory_stats()
    tr, _ = _trainer(torch, custom, n_steps * TRAIN["batch"],
                     n_val * TRAIN["batch"])
    step_ms, val_ms = [], []
    for i in range((n_steps + n_val) * TRAIN["batch"]):
        j = i % TRAIN["frames"]
        t0 = time.perf_counter()
        tr.push_data([frames[j], onehot[j]])
        if (i + 1) % TRAIN["batch"] == 0:
            (step_ms if i < n_steps * TRAIN["batch"] else val_ms).append(
                (time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    steps, vals = step_ms[2:], val_ms[2:]
    per_batch_h2d = tr.stats["h2d_bytes"] / (tr.stats["steps"]
                                              + tr.stats["val_batches"])
    emit("train_timing", batch=TRAIN["batch"], steps_timed=len(steps),
         step_ms_median=statistics.median(steps),
         step_ms_min=min(steps), step_ms_max=max(steps),
         samples_per_s=TRAIN["batch"] / statistics.median(steps) * 1e3,
         first_val_ms_refold=val_ms[0], val_ms_median=statistics.median(vals),
         val_frames_per_s=TRAIN["batch"] / statistics.median(vals) * 1e3,
         h2d_bytes_per_batch=per_batch_h2d,
         frame_bytes_per_batch=TRAIN["batch"] * SIZE * SIZE * 3,
         syncs=tr.stats["syncs"], batches=tr.stats["steps"]
         + tr.stats["val_batches"], max_memory_allocated=peak,
         card=results["card"])
    want = TRAIN["batch"] * (SIZE * SIZE * 3 + 8)
    if per_batch_h2d != want or tr.stats["syncs"] != n_steps + n_val:
        raise AssertionError(f"train: {per_batch_h2d} h2d bytes a batch "
                             f"(want {want}), {tr.stats}")
    tr2, _ = _trainer(torch, custom, 10 ** 6)

    def run():
        t0 = time.perf_counter()
        for i in range(4 * TRAIN["batch"]):
            tr2.push_data([frames[i], onehot[i]])
        return time.perf_counter() - t0

    run()  # warm-up steps
    emit("profile", line="train", steps=4, card=results["card"],
         **device_profile(torch, run))


def check_train(torch, results, workdir):
    """datareposrc ! tensor_trainer framework=jax (MobileNet-v2 1.0 at
    224 px, 1001 outputs, batch 32, 3 epochs of 192 train and 64
    validation samples, fused:pallas) ! tensor_sink, then the saved
    weights served by the flagship's tensor_filter on the validation
    frames; around it the first step against the CPU, the refold, and the
    training's timing and profile."""
    import numpy as np

    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    data, meta, frames, onehot = _train_repo(workdir)
    check_train_step(torch, frames, onehot, results)
    save = os.path.join(workdir, "mbv2.npz")
    line = (f"datareposrc location={data} json={meta} "
            f"epochs={TRAIN['epochs']} ! tensor_trainer name=tr "
            f"framework=jax model-config=mobilenet_v2 model-save-path={save} "
            f"num-inputs=1 num-labels=1 num-training-samples={TRAIN['train']} "
            f"num-validation-samples={TRAIN['val']} epochs={TRAIN['epochs']} "
            f"custom={_custom_str(_train_custom(fused='pallas'))} "
            "! tensor_sink name=out")
    p = parse_launch(line)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    p.play()
    if not p.bus.wait_eos(600) or p.bus.error is not None:
        raise RuntimeError(f"training line failed: {p.bus.error}")
    secs = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    tr = p["tr"]._fw
    module, forward, stats = tr._bundle.module, tr._bundle.apply_fn, \
        dict(tr.stats)
    reports = [np.asarray(b.tensors[0]) for b in p["out"].collected]
    per_epoch = TRAIN["train"] // TRAIN["batch"], TRAIN["val"] // TRAIN["batch"]
    steps, vals = per_epoch[0] * TRAIN["epochs"], per_epoch[1] * TRAIN["epochs"]
    rep = [r.reshape(-1).tolist() for r in reports]
    ok = (len(reports) == TRAIN["epochs"]
          and all(r.shape == (4, 1, 1) and r.dtype == np.float64
                  for r in reports)
          and rep[-1][0] < rep[0][0]
          and all(np.isfinite(r[2:]).all() for r in rep)
          and launches["normalize_u8"] == steps + vals
          and launches["fused_inverted_residual"] == kernel_blocks() * vals
          and stats["steps"] == steps and os.path.isfile(save))
    emit("train", epochs=TRAIN["epochs"], seconds=secs,
         samples=TRAIN["frames"] * TRAIN["epochs"],
         reports=[dict(zip(("train_loss", "train_acc", "val_loss", "val_acc"),
                           r)) for r in rep],
         steps=stats["steps"], val_batches=stats["val_batches"],
         h2d_bytes=stats["h2d_bytes"], syncs=stats["syncs"],
         launches=launches, saved=os.path.getsize(save)
         if os.path.isfile(save) else None, ok=ok, card=results["card"])
    if not ok:
        raise AssertionError(f"training line: {rep}, {launches}, {stats}")
    x = torch.from_numpy(frames[TRAIN["train"]:]).cuda()
    with torch.inference_mode():
        last = torch.cat([forward(c) for c in x.split(TRAIN["batch"])])
    trained = last.argmax(-1).cpu().tolist()
    check_refold(torch, module, forward, x, results)
    p.stop()

    # serve what was trained
    s = parse_launch(_trained_serve_line(save))
    s.play()
    _cuda.reset_launches()
    for i in range(TRAIN["train"], TRAIN["frames"]):
        s["src"].push_buffer(Buffer(tensors=[frames[i]], pts=i))
    s["src"].end_of_stream()
    if not s.bus.wait_eos(120) or s.bus.error is not None:
        raise RuntimeError(f"serving line failed: {s.bus.error}")
    serve_launches = dict(_cuda.LAUNCHES)
    logits = torch.cat([torch.as_tensor(np.asarray(b.tensors[0])).reshape(
        -1, TRAIN["outputs"]) for b in s["out"].collected])
    served = logits.argmax(-1).tolist()
    s.stop()
    n_served = TRAIN["val"] // TRAIN["batch"]
    same_shape = logits.shape == last.shape
    serve_ok = (served == trained and same_shape
                and within(logits, last.cpu(), 0.15, 0.05)
                and serve_launches["fused_inverted_residual"] == kernel_blocks() * n_served
                and serve_launches["normalize_u8"] == n_served)
    emit("train_serve", frames=len(served), labels_equal=served == trained,
         distinct_labels=len(set(served)),
         logits_max_abs_err=max_err(logits, last.cpu()) if same_shape
         else None,
         launches=serve_launches, ok=serve_ok, card=results["card"])
    if not serve_ok:
        raise AssertionError("the served weights' labels differ from the "
                             "trainer's")
    results["train_launches"] = {k: launches[k] + serve_launches[k]
                                 for k in launches}
    time_training(torch, frames, onehot, results)
    check_train_mesh(torch, frames, onehot, results, workdir)


#: the sharded trainer (phase train, train_mesh): the training line's
#: first 32 frames, one step an epoch for 3 epochs, over four mesh
#: positions on the one card
TRAIN_MESH = {"frames": 32, "epochs": 3, "devices": "cuda:0*4",
              "meshes": {"dp4x1": ("mesh:1", 4, 1),
                         "dp2x2": ("mesh:1,tp:2", 2, 2)},
              "timed_steps": 4}


def _mesh_repo(workdir, frames, onehot):
    """The first TRAIN_MESH["frames"] samples as a datarepo of their own."""
    n = TRAIN_MESH["frames"]
    data = os.path.join(workdir, "mesh_train.data")
    meta = os.path.join(workdir, "mesh_train.json")
    with open(data, "wb") as f:
        for i in range(n):
            f.write(frames[i].tobytes())
            f.write(onehot[i].tobytes())
    with open(meta, "w") as f:
        json.dump({"gst_caps": (
            "other/tensors,format=static,num_tensors=2,dimensions="
            f"3:{SIZE}:{SIZE}.{TRAIN['outputs']},types=uint8.float32,"
            "framerate=0/1"), "total_samples": n,
            "sample_size": frames[0].nbytes + onehot[0].nbytes}, f)
    return data, meta


def _host_state(module) -> dict:
    return {k: v.detach().float().cpu() for k, v in
            module.state_dict().items() if "num_batches" not in k}


def _mesh_train_line(torch, data, meta, custom, save):
    """datareposrc ! tensor_trainer over the mesh repo, one step an
    epoch: (the loss of each step, the trained state on the host, the
    trainer's step, the launches)."""
    import numpy as np

    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    n, e = TRAIN_MESH["frames"], TRAIN_MESH["epochs"]
    p = parse_launch(
        f"datareposrc location={data} json={meta} epochs={e} "
        f"! tensor_trainer name=tr framework=jax model-config=mobilenet_v2 "
        f"model-save-path={save} num-inputs=1 num-labels=1 "
        f"num-training-samples={n} num-validation-samples=0 epochs={e} "
        f"custom={_custom_str(custom)} ! tensor_sink name=out")
    _cuda.reset_launches()
    p.play()
    if not p.bus.wait_eos(600) or p.bus.error is not None:
        raise RuntimeError(f"mesh training line failed: {p.bus.error}")
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    losses = [float(np.asarray(b.tensors[0]).reshape(-1)[0])
              for b in p["out"].collected]
    tr = p["tr"]._fw
    state, step = _host_state(tr._bundle.module), tr._step
    p.stop()
    return losses, state, step, launches


def _run_dist(a, b) -> dict:
    """Distances of two runs (losses a step, state): the largest of the
    losses', and the largest over the weights and over the running
    statistics."""
    def d(sel):
        return max(float((a[1][k] - b[1][k]).abs().max()) for k in a[1]
                   if sel(k))
    return {"loss": max(abs(x - y) for x, y in zip(a[0], b[0])),
            "weights": d(lambda k: "running" not in k),
            "running_stats": d(lambda k: "running" in k)}


def _replicas_equal(torch, step) -> bool:
    """Every copy of a leaf equals dp row 0's at its tp column, bit for
    bit (a replicated leaf's copies all equal position (0, 0)'s)."""
    return all(torch.equal(leaf.shards[i][j],
                           leaf.shards[0][j if leaf.dim is not None else 0])
               for leaf in step.placed.values()
               for i in range(step.dp) for j in range(step.tp))


def _served_logits(torch, frames, save):
    """The flagship's filter (fused:pallas) on the frames after the mesh
    repo's, with ``save``'s weights: (logits, launches)."""
    import numpy as np

    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    s = parse_launch(_trained_serve_line(save))
    s.play()
    _cuda.reset_launches()
    lo = TRAIN_MESH["frames"]
    for i in range(lo, lo + 2 * TRAIN["batch"]):
        s["src"].push_buffer(Buffer(tensors=[frames[i]], pts=i))
    s["src"].end_of_stream()
    if not s.bus.wait_eos(120) or s.bus.error is not None:
        raise RuntimeError(f"serving line failed: {s.bus.error}")
    launches = dict(_cuda.LAUNCHES)
    logits = torch.cat([torch.as_tensor(np.asarray(b.tensors[0])).reshape(
        -1, TRAIN["outputs"]) for b in s["out"].collected])
    s.stop()
    return logits.float(), launches


def check_train_mesh(torch, frames, onehot, results, workdir) -> None:
    """The sharded trainer at full width (MobileNet-v2 1.0, 224 px, 1001
    outputs, batch 32, seed:0): datareposrc ! tensor_trainer
    custom=mesh:1 (dp 4, 8 rows a position) and custom=mesh:1,tp:2 (dp 2 x
    tp 2) over NNSTPU_TORCH_DEVICES=cuda:0*4, 3 steps on the same batch,
    each held against the unsharded trainer's line on it: each step's
    loss, the weights and the running statistics after the last step no
    farther from it than twice the unsharded bfloat16 run's distance from
    the same steps at float32 (the step's own bf16 noise; the CPU tests
    hold the step at float64, where that noise is 1e-16), and the dp
    replicas equal bit for bit. Then the trained weights through the
    flagship's filter: fused-block and normalize_u8 launches, logits no
    farther from the unsharded-trained weights' than twice the float32-
    trained weights' distance from them. Last, step ms sharded against
    unsharded in turns (a finding, not a gate)."""
    data, meta = _mesh_repo(workdir, frames, onehot)
    n, e = TRAIN_MESH["frames"], TRAIN_MESH["epochs"]
    card = results["card"]
    runs, total = {}, {}
    save = {}
    save["off"] = os.path.join(workdir, "mesh_off.npz")
    loss, state, _, _ = _mesh_train_line(torch, data, meta, _train_custom(),
                                         save["off"])
    runs["off"] = (loss, state)
    # the unsharded steps at float32: the noise floor of the bf16 step
    tr, props = _trainer(torch, _train_custom(), n, epochs=e)
    _set_dtype(torch, tr._bundle.module, torch.float32)
    losses32 = []
    for _ in range(e):
        for i in range(n):
            tr.push_data([frames[i], onehot[i]])
        losses32.append(props.training_loss)
    save["f32"] = os.path.join(workdir, "mesh_f32.npz")
    tr.save(save["f32"])
    runs["f32"] = (losses32, _host_state(tr._bundle.module))
    noise = _run_dist(runs["off"], runs["f32"])
    prev = os.environ.get("NNSTPU_TORCH_DEVICES")
    os.environ["NNSTPU_TORCH_DEVICES"] = TRAIN_MESH["devices"]
    try:
        checks = {}
        for name, (custom, dp, tp) in TRAIN_MESH["meshes"].items():
            save[name] = os.path.join(workdir, f"mesh_{name}.npz")
            loss, state, step, launches = _mesh_train_line(
                torch, data, meta, _train_custom(**dict(
                    kv.split(":") for kv in custom.split(","))), save[name])
            _add_launches(total, launches)
            runs[name] = (loss, state)
            dist = _run_dist(runs[name], runs["off"])
            checks[name] = {
                "mesh": [step.dp, step.tp], "losses": loss,
                "vs_unsharded": dist,
                "replicas_equal": _replicas_equal(torch, step),
                "ok": all(dist[k] <= 2 * noise[k] for k in dist),
                "launches": launches}
            if ((step.dp, step.tp) != (dp, tp)
                    or not checks[name]["replicas_equal"]
                    or not checks[name]["ok"] or len(loss) != e
                    or launches["normalize_u8"] != e * dp):
                raise AssertionError(f"train_mesh {name}: {checks[name]}, "
                                     f"noise {noise}")
        # the trained weights through the flagship's filter
        served = {k: _served_logits(torch, frames, save[k]) for k in save}
        serve_noise = max_err(served["off"][0], served["f32"][0])
        for name in TRAIN_MESH["meshes"]:
            logits, launches = served[name]
            _add_launches(total, launches)
            err = max_err(logits, served["off"][0])
            checks[name]["serve"] = {
                "logits_max_abs_err": err, "launches": launches,
                "labels_equal": int((logits.argmax(-1) == served["off"][0]
                                     .argmax(-1)).sum()),
                "frames": int(logits.shape[0])}
            if (err > 2 * serve_noise
                    or launches["fused_inverted_residual"] == 0
                    or launches["normalize_u8"] == 0):
                raise AssertionError(f"train_mesh {name} serve: "
                                     f"{checks[name]['serve']}, noise "
                                     f"{serve_noise}")
        step_ms = _mesh_step_turns(torch, frames, onehot)
        # where a dp 4 step's time goes
        tr, _ = _trainer(torch, _train_custom(mesh="1"), 10 ** 6)

        def run():
            t0 = time.perf_counter()
            for i in range(2 * TRAIN["batch"]):
                tr.push_data([frames[i], onehot[i]])
            return time.perf_counter() - t0

        run()  # warm-up steps
        emit("profile", line="train_mesh_dp4x1", steps=2, card=card,
             **device_profile(torch, run))
    finally:
        if prev is None:
            os.environ.pop("NNSTPU_TORCH_DEVICES", None)
        else:
            os.environ["NNSTPU_TORCH_DEVICES"] = prev
    results["train_mesh_launches"] = total
    emit("train_mesh", devices=TRAIN_MESH["devices"], steps=e,
         batch=TRAIN["batch"], unsharded_losses=runs["off"][0],
         f32_losses=runs["f32"][0], bf16_noise=noise,
         serve_bf16_noise=serve_noise, tolerance="2x noise",
         meshes=checks, step_ms_turns=step_ms, card=card)


def _mesh_step_turns(torch, frames, onehot) -> dict:
    """Train step ms on trainers driven directly (the batch's 32 pushes,
    the loss read the sync), unsharded and over each mesh in turns (off,
    dp4x1, dp2x2, dp2x2, dp4x1, off), after 2 warm-up steps a trainer:
    each turn's median."""
    order = ["off"] + list(TRAIN_MESH["meshes"])
    order = order + order[::-1]
    out = {k: [] for k in order}
    b = TRAIN["batch"]
    for name in order:
        extra = {} if name == "off" else dict(
            kv.split(":") for kv in TRAIN_MESH["meshes"][name][0].split(","))
        tr, _ = _trainer(torch, _train_custom(**extra), 10 ** 6)
        ms = []
        for s in range(2 + TRAIN_MESH["timed_steps"]):
            t0 = time.perf_counter()
            for i in range(b):
                j = (s * b + i) % TRAIN["frames"]
                tr.push_data([frames[j], onehot[j]])
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name].append(statistics.median(ms[2:]))
    return out


# -- phase: the steady loop ------------------------------------------------

#: line A (the reference's own loop leg, bench.py:669-677): one frame per
#: buffer, 8 frames a window, 2 windows banked; line B: the flagship at
#: 128 frames per tensor, 4 buffers a window, 8 windows a run (a window
#: waits for 4 converted buffers before the card starts, so a short run
#: measures that fill more than the steady state)
LOOP_A = {"window": 8, "depth": 2, "frames": 512, "reps": 3}
LOOP_B = {"window": 4, "depth": 2, "batches": 32, "reps": 2}


def _loop_line_a(extra: str = "", raw: bool = False) -> str:
    """Line A; ``raw`` leaves out the on-device argmax, so the sink
    receives the logits."""
    post = "" if raw else "postproc:argmax,"
    return (
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=1000/1 "
        "! tensor_converter frames-per-tensor=1 "
        "! tensor_filter name=f framework=jax model=mobilenet_v2 "
        f"custom=seed:0,{post}fused:pallas {extra} "
        "! tensor_sink name=out")


def _loop_line_b(labels: str, extra: str = "", preamble: bool = False,
                 raw: bool = False) -> str:
    """The flagship (labels through image_labeling), per-buffer with its
    fetch window or with ``extra``'s loop properties; ``preamble`` puts
    the reference preamble before the filter, which fuses it; ``raw``
    leaves out the argmax and the decoder, so the sink receives the
    logits."""
    pre = (f"! tensor_transform name=tr mode=arithmetic option={PREAMBLE} "
           if preamble else "")
    fw = "" if "loop-window" in extra else f"fetch-window={FETCH_WINDOW} "
    post = "" if raw else "postproc:argmax,"
    tail = ("" if raw else "! queue ! tensor_decoder mode=image_labeling "
            f"option1={labels} ")
    return (
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=1000/1 "
        f"! tensor_converter frames-per-tensor={BATCH} {pre}"
        "! tensor_filter name=f framework=jax model=mobilenet_v2 "
        f"custom=seed:0,{post}fused:pallas {fw}{extra} "
        f"{tail}! tensor_sink name=out")


def _loop_drive(torch, line, frames, n, spans=False, plan=False,
                profile=False, midway=None):
    """Play ``line``, set the launch counts to 0, push ``n`` frames (one a
    buffer, cycling ``frames``; ``midway(p)`` is called after the first
    half), EOS; returns a dict with the labels one per frame (the logits,
    one row per frame, where the sink receives float outputs), seconds
    from the first push to the last output, p50
    latency of a frame (push to its output at the sink), the launches,
    crossings at the filter, the span tracer's dispatch spans and
    host-stack report (with ``spans``), the filter's loop state and its
    backend's loop stats, (with ``plan``) the memory plan's predicted
    bytes against the peak the card allocated, and (with ``profile``)
    the device profile of the pushed frames' run — after play(), so a
    window's capture is not in it."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    import numpy as np

    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.analysis.memplan import plan_memory
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    p = parse_launch(line)
    tracer = trace.attach(p, spans=spans)
    pushed, arrived = {}, {}
    p["out"].connect_new_data(
        lambda b: arrived.__setitem__(b.pts, time.perf_counter()))
    p.play()
    f = p["f"]
    predicted = plan_memory(p) if plan else None
    torch.cuda.synchronize()
    _cuda.reset_launches()
    prof = (torch_profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
            if profile else None)
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    for i in range(n):
        if midway is not None and i == n // 2:
            midway(p)
        p["src"].push_buffer(Buffer(tensors=[frames[i % len(frames)]],
                                    pts=i))
        pushed[i] = time.perf_counter()
    p["src"].end_of_stream()
    if not p.bus.wait_eos(600) or p.bus.error is not None:
        raise RuntimeError(f"loop line failed: {p.bus.error}")
    secs = max(arrived.values()) - t0
    if prof is not None:
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    out = []
    for b in p["out"].collected:
        lab = b.meta.get("label")
        t = np.asarray(b.tensors[0])
        if lab is not None:
            out.extend(lab if isinstance(lab, list) else [lab])
        elif t.dtype.kind == "f":
            out.append(t.reshape(-1, t.shape[-1]))
        else:
            out.extend(int(v) for v in t.reshape(-1))
    if out and isinstance(out[0], np.ndarray):
        out = np.concatenate(out)
    cr = tracer.crossings()["per_element"].get("f", {})
    r = {"labels": out, "seconds": secs,
         "p50_latency_ms": statistics.median(
             (arrived[k] - pushed[k]) * 1e3 for k in arrived),
         "launches": launches, "crossings": cr,
         "loop_state": f._loop_state, "loop_refused": f._loop_refused,
         "loop_stats": (f.fw.loop_stats()
                        if f._loop_state is not None else None)}
    if prof is not None:
        r["profile"] = profile_stats(torch, prof, secs)
    if spans:
        r["dispatch_spans"] = sum(1 for rec in tracer.spans.records()
                                  if rec[2] == "dispatch")
        r["host_stack"] = tracer.host_stack_report(n)
    if plan:
        row = next(x for x in predicted["rows"] if x["element"] == "f")
        r["memory"] = {"predicted_bytes": predicted["total_bytes"],
                       "params": predicted["param_bytes_total"],
                       "derived": predicted["derived_bytes_total"],
                       "weight_rounding": predicted[
                           "weight_rounding_bytes_total"],
                       "activation": row["activation_bytes"],
                       "loop_ring": row["loop_bytes"],
                       "graph_pool": row["graph_bytes"],
                       "feed": row["feed_bytes"],
                       "fetch_window": row["window_bytes"],
                       "budget": predicted["budget_bytes"],
                       "budget_source": predicted["budget_source"],
                       "max_memory_allocated": peak}
        if peak > predicted["total_bytes"]:
            raise AssertionError(f"the memory plan under-bills {line!r}: "
                                 f"{r['memory']}")
        if f._loop_state is not None:
            pool, blocks = _graph_pool_peak(torch, f.fw)
            r["memory"]["graph_pool_measured"] = pool
            r["pool_blocks"] = blocks
            r["graph_terms"] = row.get("graph_terms")
            # the graph pool's bill: never below what a capture keeps
            # alive, and within twice of it
            if not pool <= row["graph_bytes"] <= 2 * pool:
                raise AssertionError(
                    f"graph pool bill {row['graph_bytes']} B against "
                    f"{pool} B measured on {line!r}")
    p.stop()
    return r


def _graph_pool_peak(torch, fw):
    """What one capture of the filter's window keeps alive: the window's
    graph is dropped and captured again (warm-up runs, then the capture,
    as at play) with the peak counter reset, and the peak live bytes above
    what was allocated before it are the pool the capture needs. Taken
    after the measured run, so its numbers are not in the run's. Returns
    the peak and :func:`_pool_blocks`' listing of the same capture (the
    allocator's history is recorded around it)."""
    from nnstreamer_tpu_torch.ops import _cuda

    (g,) = fw._loop_graphs.values()
    g.graph, g.outs = None, []  # the old capture's pool and outputs go
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python", max_entries=200000)
    try:
        g.capture()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    warm = _cuda.side_stream(g.device, "loop-warmup").cuda_stream
    return peak, _pool_blocks(torch, snap, g.graph.pool(), warm, peak)


def _frame_at(frames) -> str:
    """The innermost frame of an allocation in the port's code (else the
    innermost frame), as file:line function."""
    frames = frames or []
    mine = [f for f in frames if "nnstreamer_tpu_torch" in f["filename"]]
    f = (mine or frames or [{"filename": "?", "line": 0, "name": "?"}])[0]
    path = f["filename"]
    if "nnstreamer_tpu_torch" in path:
        path = path[path.index("nnstreamer_tpu_torch"):]
    else:
        path = os.path.basename(path)
    inner = f" < {frames[0]['name']}" if frames and frames[0] is not f else ""
    return f"{path}:{f['line']} {f['name']}{inner}"


def _pool_blocks(torch, snap, pool_id, warm_stream, peak) -> dict:
    """The blocks of one window capture, from the allocator's history:
    every allocation live at the capture's peak (the warm-up runs on the
    ordinary pool, then the capture on the graph's private pool), by the
    frame that made it and its size, each request beside the bytes the
    allocator counts for it (``card_block_bytes``, the rule the memory
    plan bills); the private pool's segments (what the card reserves for
    it); and the rule's peak beside the measured one."""
    from nnstreamer_tpu_torch.analysis.costmodel import card_block_bytes

    def tag(ev):
        return "warmup" if ev["stream"] == warm_stream else "capture"

    trace = snap["device_traces"][torch.cuda.current_device()]
    live, cur, top, at_top = {}, 0, 0, {}
    each = {"warmup": [0, 0], "capture": [0, 0]}  # [now, peak] a stream
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            n = card_block_bytes(ev["size"])
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            ev = live.pop(ev["addr"])
            n = -card_block_bytes(ev["size"])
        else:
            continue
        cur += n
        t = each[tag(ev)]
        t[0] += n
        t[1] = max(t)
        if cur > top:
            top, at_top = cur, dict(live)
    rows = {}
    for ev in at_top.values():
        key = (tag(ev), _frame_at(ev.get("frames")), int(ev["size"]))
        n = rows.setdefault(key, [0, card_block_bytes(ev["size"])])
        n[0] += 1
    blocks = [{"stream": k[0], "at": k[1], "requested": k[2], "count": n,
               "counted": c} for k, (n, c) in rows.items()]
    blocks.sort(key=lambda b: -b["count"] * b["counted"])
    segs = [s for s in snap["segments"]
            if tuple(s.get("segment_pool_id") or ()) == tuple(pool_id)]
    return {"rule_peak": top, "measured": peak,
            "rule_peak_by_stream": {k: v[1] for k, v in each.items()},
            "live_at_peak": blocks,
            "pool_segments": [{"type": s["segment_type"],
                               "bytes": s["total_size"],
                               "active": s["active_size"]} for s in segs],
            "pool_reserved": sum(s["total_size"] for s in segs)}


def _pools_held(snap) -> list:
    """The blocks still active in a private (graph) pool, by frame and
    size, and each such pool's reserved bytes."""
    held = []
    for seg in snap["segments"]:
        pid = tuple(seg.get("segment_pool_id") or ())
        if not any(pid) or not seg["active_size"]:
            continue
        for b in seg["blocks"]:
            if b["state"] != "inactive":
                held.append({"pool": list(pid), "segment": seg["total_size"],
                             "type": seg["segment_type"], "bytes": b["size"],
                             "requested": b.get("requested_size"),
                             "at": _frame_at(b.get("frames"))})
    return held


def _loop_check(name, r, frames, window, want_labels, per_frame,
                extra_rows=0):
    """The window engaged as a CUDA graph (no refusal, replays = windows),
    one h2d crossing per window, labels equal to per-buffer's on every
    frame (``want_labels`` None: compared by the caller), and the
    kernels' launches through the replays: ``per_frame`` launches of each
    kernel per window row, and per row of ``extra_rows`` run outside the
    replays (a recapture's warm-up)."""
    import math

    windows = math.ceil(frames / window)
    st = r["loop_stats"]
    bad = []
    if r["loop_state"] is None or r["loop_refused"] is not None:
        bad.append(f"loop not engaged: {r['loop_refused']}")
    elif st["replays"] != windows:
        bad.append(f"{st['replays']} replays for {windows} windows")
    if r["crossings"].get("h2d") != windows:
        bad.append(f"h2d {r['crossings']} for {windows} windows")
    if "dispatch_spans" in r and r["dispatch_spans"] != windows:
        bad.append(f"{r['dispatch_spans']} dispatch spans")
    if want_labels is not None and r["labels"] != want_labels:
        bad.append("labels differ from per-buffer")
    for k, n in per_frame.items():
        want = n * (windows * window + extra_rows)
        if r["launches"].get(k) != want:
            bad.append(f"{k}: {r['launches'].get(k)} launches, want {want}")
    if bad:
        raise AssertionError(f"loop line {name}: {bad}")
    return windows


def _fps_runs(runs):
    """frames/s per run and their median and spread (max - min)."""
    fps = [r["frames"] / r["seconds"] for r in runs]
    return {"fps": fps, "median": statistics.median(fps),
            "spread": max(fps) - min(fps),
            "p50_latency_ms": [r["p50_latency_ms"] for r in runs]}


def _bit_equal(name, got, want):
    import numpy as np

    if got.shape != want.shape or not np.array_equal(got, want):
        err = (float(np.abs(got - want).max()) if got.shape == want.shape
               else None)
        raise AssertionError(f"{name}: logits {got.shape} differ from "
                             f"{want.shape}, max abs {err}")


def _loop_logits(torch, frames, labels, a_loop, b_loop, add, card):
    """Lines A and B without the argmax: the windowed logits are
    bit-equal to the per-buffer ones on every frame (the window runs the
    same kernels at the same shapes). Then line A with its classifier
    negated halfway, after the first half's windows were dispatched, and
    the weights' version moved: the window recaptures once, the second
    half's logits are the per-buffer ones negated, bit for bit, and the
    recapture's warm-up launches are the only launches outside the
    replays."""
    from nnstreamer_tpu_torch.models import weights_changed
    from nnstreamer_tpu_torch.ops.steady_loop import CudaGraphWindow

    n_a, n_b = 256, 16 * BATCH
    per_frame = {"fused_inverted_residual": kernel_blocks(), "normalize_u8": 1}
    ref_a = _loop_drive(torch, _loop_line_a(raw=True), frames, n_a)
    win_a = _loop_drive(torch, _loop_line_a(a_loop, raw=True), frames, n_a)
    _loop_check("A logits", win_a, n_a, LOOP_A["window"], None, per_frame)
    _bit_equal("line A windowed", win_a["labels"], ref_a["labels"])
    ref_b = _loop_drive(torch, _loop_line_b(labels, raw=True), frames, n_b)
    win_b = _loop_drive(torch, _loop_line_b(labels, b_loop, raw=True),
                        frames, n_b)
    _loop_check("B logits", win_b, n_b // BATCH, LOOP_B["window"], None,
                per_frame)
    _bit_equal("line B windowed", win_b["labels"], ref_b["labels"])

    half, window = n_a // 2, LOOP_A["window"]

    def negate_classifier(p):
        fw = p["f"].fw
        deadline = time.perf_counter() + 60
        while fw.loop_stats()["replays"] < half // window:
            if time.perf_counter() > deadline:
                raise AssertionError("line A: the first half's windows "
                                     "were not dispatched")
            time.sleep(0.001)
        m = fw._bundle.module
        with torch.no_grad():
            m.classifier.weight.neg_()
            m.classifier.bias.neg_()
        weights_changed(m)

    flip = _loop_drive(torch, _loop_line_a(a_loop, raw=True), frames, n_a,
                       midway=negate_classifier)
    _loop_check("A weights moved", flip, n_a, window, None, per_frame,
                extra_rows=CudaGraphWindow.WARMUP * window)
    if flip["loop_stats"]["captures"] != 2:
        raise AssertionError(f"line A weights moved: "
                             f"{flip['loop_stats']['captures']} captures")
    _bit_equal("line A before the weights moved", flip["labels"][:half],
               ref_a["labels"][:half])
    _bit_equal("line A after the weights moved", flip["labels"][half:],
               -ref_a["labels"][half:])
    for r in (win_a, win_b, flip):
        add(r)
    emit("loop", line="logits", frames_a=n_a, frames_b=n_b,
         bit_equal=True,
         logits_scale={"A": float(abs(ref_a["labels"]).max()),
                       "B": float(abs(ref_b["labels"]).max())},
         weights_moved={"at_frame": half,
                        "captures": flip["loop_stats"]["captures"],
                        "replays": flip["loop_stats"]["replays"],
                        "capture_ms": flip["loop_stats"]["capture_ms"],
                        "launches": flip["launches"], "bit_equal": True},
         card=card)


def check_loop(torch, results, workdir):
    """Lines A, B and C with the window as a CUDA graph, each against
    its per-buffer line on the same frames."""
    import numpy as np

    from nnstreamer_tpu_torch.analysis.loop import analyze_loop
    from nnstreamer_tpu_torch.pipeline import parse_launch

    rng = np.random.default_rng(0)
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(BATCH)]
    labels = os.path.join(workdir, "loop_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    a_loop = (f"loop-window={LOOP_A['window']} "
              f"launch-depth={LOOP_A['depth']}")
    b_loop = (f"loop-window={LOOP_B['window']} "
              f"launch-depth={LOOP_B['depth']}")
    n_a, n_b = LOOP_A["frames"], LOOP_B["batches"] * BATCH
    launches = {}

    def add(r):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v

    # warm-up: cuDNN plans and the allocator for both forms of each line;
    # the allocator's history of these first captures says what a graph
    # pool still holds once every line has stopped (a cuBLAS workspace
    # made inside a capture would stay in its pool)
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python", max_entries=500000)
    try:
        for line, n in ((_loop_line_a(), 64), (_loop_line_a(a_loop), 64),
                        (_loop_line_b(labels), 2 * BATCH),
                        (_loop_line_b(labels, b_loop), 8 * BATCH)):
            _loop_drive(torch, line, frames, n)
        gc.collect()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    emit("loop", line="first_captures", held=_pools_held(snap),
         card=results["card"])

    # line A: per-buffer and windowed in turns (P, W, W, P, P, W)
    runs = {"per_buffer": [], "windowed": []}
    for kind in ("per_buffer", "windowed", "windowed", "per_buffer",
                 "per_buffer", "windowed")[:2 * LOOP_A["reps"]]:
        r = _loop_drive(torch, _loop_line_a(
            a_loop if kind == "windowed" else ""), frames, n_a)
        r["frames"] = n_a
        runs[kind].append(r)
    want = runs["per_buffer"][0]["labels"]
    if any(r["labels"] != want for r in runs["per_buffer"]):
        raise AssertionError("line A: per-buffer labels differ between runs")
    for r in runs["windowed"]:
        windows = _loop_check("A", r, n_a, LOOP_A["window"], want,
                              {"fused_inverted_residual": kernel_blocks(),
                               "normalize_u8": 1})
        add(r)
    spans_w = _loop_drive(torch, _loop_line_a(a_loop), frames, n_a,
                          spans=True, plan=True)
    _loop_check("A spans", spans_w, n_a, LOOP_A["window"], want,
                {"fused_inverted_residual": kernel_blocks(), "normalize_u8": 1})
    add(spans_w)
    spans_p = _loop_drive(torch, _loop_line_a(), frames, n_a, spans=True,
                          plan=True)
    w0 = runs["windowed"][0]
    emit("loop", line="A", frames=n_a, window=LOOP_A["window"],
         depth=LOOP_A["depth"], windows=windows,
         labels_equal=True, distinct_labels=len(set(want)),
         replays=w0["loop_stats"]["replays"],
         captures=w0["loop_stats"]["captures"],
         capture_ms=w0["loop_stats"]["capture_ms"],
         launches_per_replay=w0["loop_stats"]["launches_per_replay"],
         launches=w0["launches"], per_buffer_launches=runs[
             "per_buffer"][0]["launches"],
         h2d_per_window=w0["crossings"]["h2d"] / windows,
         d2h_per_window=w0["crossings"]["d2h"] / windows,
         dispatch_spans_per_window=spans_w["dispatch_spans"] / windows,
         windowed=_fps_runs(runs["windowed"]),
         per_buffer=_fps_runs(runs["per_buffer"]),
         host_ms_per_frame={"windowed": spans_w["host_stack"],
                            "per_buffer": spans_p["host_stack"]},
         memory={"windowed": spans_w["memory"],
                 "per_buffer": spans_p["memory"]},
         card=results["card"])

    for kind, extra in (("windowed", a_loop), ("per_buffer", "")):
        r = _loop_drive(torch, _loop_line_a(extra), frames, n_a // 2,
                        profile=True)
        emit("profile", line=f"loop_A_{kind}", frames=n_a // 2,
             **r["profile"])

    # line B: the flagship, per-buffer and windowed in turns (P, W, W, P)
    runs = {"per_buffer": [], "windowed": []}
    for kind in ("per_buffer", "windowed", "windowed",
                 "per_buffer")[:2 * LOOP_B["reps"]]:
        r = _loop_drive(torch, _loop_line_b(
            labels, b_loop if kind == "windowed" else ""), frames, n_b)
        r["frames"] = n_b
        runs[kind].append(r)
    want_b = runs["per_buffer"][0]["labels"]
    for r in runs["windowed"]:
        windows_b = _loop_check("B", r, LOOP_B["batches"], LOOP_B["window"],
                                want_b, {"fused_inverted_residual": kernel_blocks(),
                                         "normalize_u8": 1})
        add(r)
    # B with the reference preamble fused: arith_chain inside the graph
    pre = _loop_drive(torch, _loop_line_b(labels, b_loop, preamble=True),
                      frames, n_b, spans=True, plan=True)
    _loop_check("B preamble", pre, LOOP_B["batches"], LOOP_B["window"],
                want_b, {"arith_chain": 1, "fused_inverted_residual": kernel_blocks()})
    if pre["launches"].get("normalize_u8"):
        raise AssertionError("B preamble: normalize_u8 ran beside the "
                             "fused preamble")
    add(pre)
    spans_bw = _loop_drive(torch, _loop_line_b(labels, b_loop), frames,
                           n_b, spans=True, plan=True)
    add(spans_bw)
    spans_bp = _loop_drive(torch, _loop_line_b(labels), frames, n_b,
                           spans=True, plan=True)
    w0 = runs["windowed"][0]
    emit("loop", line="B", frames=n_b, batches=LOOP_B["batches"],
         window=LOOP_B["window"], depth=LOOP_B["depth"], windows=windows_b,
         labels_equal=True, distinct_labels=len(set(want_b)),
         replays=w0["loop_stats"]["replays"],
         captures=w0["loop_stats"]["captures"],
         capture_ms=w0["loop_stats"]["capture_ms"],
         launches_per_replay=w0["loop_stats"]["launches_per_replay"],
         launches=w0["launches"],
         h2d_per_window=w0["crossings"]["h2d"] / windows_b,
         dispatch_spans_per_window=spans_bw["dispatch_spans"] / windows_b,
         windowed=_fps_runs(runs["windowed"]),
         per_buffer=_fps_runs(runs["per_buffer"]),
         host_ms_per_frame={"windowed": spans_bw["host_stack"],
                            "per_buffer": spans_bp["host_stack"]},
         memory={"windowed": spans_bw["memory"],
                 "per_buffer": spans_bp["memory"]},
         preamble={"launches": pre["launches"],
                   "launches_per_replay": pre["loop_stats"][
                       "launches_per_replay"],
                   "replays": pre["loop_stats"]["replays"],
                   "capture_ms": pre["loop_stats"]["capture_ms"],
                   "fps": n_b / pre["seconds"], "labels_equal": True,
                   "memory": pre["memory"]},
         card=results["card"])

    for kind, extra in (("windowed", b_loop), ("per_buffer", "")):
        r = _loop_drive(torch, _loop_line_b(labels, extra), frames,
                        8 * BATCH, profile=True)
        emit("profile", line=f"loop_B_{kind}", batches=8, **r["profile"])

    _loop_logits(torch, frames, labels, a_loop, b_loop, add,
                 results["card"])

    # line C: loop-window=auto on line A, resolved by the memory plan
    # against the card's memory
    auto = "loop-window=auto launch-depth=2"
    p = parse_launch(_loop_line_a(auto))
    v = analyze_loop(p, p["f"])
    n_c = 256
    c = _loop_drive(torch, _loop_line_a(auto), frames, n_c, plan=True)
    _loop_check("C", c, n_c, v.window,
                [want[i % len(frames)] for i in range(n_c)],
                {"fused_inverted_residual": kernel_blocks(), "normalize_u8": 1})
    add(c)
    emit("loop", line="C", frames=n_c, verdict=v.code, window=v.window,
         depth=v.depth, budget_source=c["memory"]["budget_source"],
         budget=c["memory"]["budget"],
         replays=c["loop_stats"]["replays"], labels_equal=True,
         fps=n_c / c["seconds"], memory=c["memory"], card=results["card"])
    if v.code != "NNST460" or c["loop_state"]["window"] != v.window:
        raise AssertionError(f"line C: {v}, {c['loop_state']}")
    # the memory plan's graph-pool bill against the pool one capture
    # keeps alive (each run above asserted measured <= bill <= 2x)
    pools = {name: {"bill": r["memory"]["graph_pool"],
                    "measured": r["memory"]["graph_pool_measured"],
                    "ratio": r["memory"]["graph_pool"]
                    / r["memory"]["graph_pool_measured"]}
             for name, r in (("A", spans_w), ("B", spans_bw),
                             ("B_preamble", pre), ("C", c))}
    # each line's bill by its rows beside the blocks its capture held
    for name, r in (("A", spans_w), ("B", spans_bw), ("B_preamble", pre),
                    ("C", c)):
        emit("loop", line="graph_pool_blocks", of=name,
             ratio=pools[name]["ratio"], bill=r["memory"]["graph_pool"],
             bill_rows=dict(r["graph_terms"],
                            feed=r["memory"]["feed"],
                            fetch_window=r["memory"]["fetch_window"]),
             pool=r["pool_blocks"], card=results["card"])
    emit("loop", line="graph_pool", pools=pools, card=results["card"])
    results["graph_pool"] = pools
    results["loop_launches"] = launches


# -- phase: the among-device transports ---------------------------------------

#: the camera lines' frames: 8 messages of BATCH frames
EDGE_FRAMES = 1024
EDGE_RUNS = 3
SERVE_TOPIC = "nns/edge/serve"
CAM_TOPIC = "nns/edge/cam"
PUB_TOPIC = "nns/edge/pub"
#: head dims from 256 up: the tensor-core body's widest D (bf16), then,
#: where kernels 4 and 5 split the output's columns over the grid, a
#: ragged last slice and two multiples of 128, where the JAX package runs
#: its Pallas kernel
SPLIT_DIMS = (256, 320, 384, 512)
#: their shapes: 8 heads x 1024 rows (16 q tiles, 128 CTAs per slice, so
#: the slices of a tile run side by side on the card)
SPLIT_BH, SPLIT_SEQ = 8, 1024


def _edge_frames():
    """EDGE_FRAMES seeded 224x224 RGB frames of 4x4 blocks of flat colour,
    one pattern a frame, so that a frame out of place shows in its label."""
    import numpy as np

    rng = np.random.default_rng(14)
    blocks = rng.integers(0, 256, (EDGE_FRAMES, 4, 4, 3), dtype=np.uint8)
    cell = SIZE // 4
    return list(blocks.repeat(cell, axis=1).repeat(cell, axis=2))


def _timed(obj, attr, sink, *, record=None):
    """Replace ``obj.attr`` (a bound method) with one that appends its
    host seconds to ``sink`` (and, with ``record``, ``record(args,
    result)``'s value to ``sink`` instead of the time)."""
    orig = getattr(obj, attr)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        sink.append(record(a, out) if record else time.perf_counter() - t0)
        return out

    setattr(obj, attr, wrapper)


def _fps_stats(runs):
    med = statistics.median(runs)
    return {"runs": runs, "median": med, "spread": max(runs) - min(runs)}


def _flagship_indices(torch, labels, frames):
    """The flagship line's labels on ``frames`` (8 batches of BATCH), as
    class indices: what every transport line must reproduce."""
    out, _, _, p = _drive(_flagship(labels), frames, EDGE_FRAMES // BATCH)
    p.stop()
    return [int(lab[len("class"):]) for b in out for lab in b]


class _CameraLine:
    """A publisher line (appsrc ! tensor_converter frames-per-tensor=BATCH
    ! ``sink``) and a subscriber line (``src`` ! the flagship's filter
    with postproc:argmax ! tensor_sink), both playing until close():
    run() pushes frames and waits for their BATCH-frame buffers."""

    def __init__(self, pub_sink, sub_src_of):
        from nnstreamer_tpu_torch.pipeline import parse_launch

        self.pub = parse_launch(
            f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
            f"height={SIZE},framerate=1000/1 ! tensor_converter "
            f"frames-per-tensor={BATCH} ! {pub_sink}")
        self.pub.play()
        self.sub = None
        try:
            self.sub = parse_launch(
                f"{sub_src_of(self.pub)} ! tensor_filter name=f "
                "framework=jax model=mobilenet_v2 "
                "custom=seed:0,postproc:argmax,fused:pallas "
                "! tensor_sink name=out")
            self.arrived = {}
            self.sub["out"].connect_new_data(
                lambda b: self.arrived.__setitem__(b.pts,
                                                   time.perf_counter()))
            self.sub.play()
        except BaseException:
            self.close()
            raise
        self.pts = 0

    def run(self, frames):
        """Push ``frames`` (a whole number of buffers); returns (seconds
        from the first push to the last buffer out, per-frame latency ms,
        labels in order, the buffers' pts)."""
        import numpy as np

        from nnstreamer_tpu_torch.buffer import Buffer

        n_out = len(frames) // BATCH
        have = len(self.sub["out"].collected)
        pushed = []
        t0 = time.perf_counter()
        for f in frames:
            pushed.append(time.perf_counter())
            self.pub["src"].push_buffer(Buffer(tensors=[f], pts=self.pts))
            self.pts += 1
        deadline = time.monotonic() + 300
        while len(self.sub["out"].collected) < have + n_out:
            for p in (self.pub, self.sub):
                if p.bus.error is not None:
                    raise RuntimeError(f"edge line failed: {p.bus.error.data}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"edge line: {len(self.sub['out'].collected) - have} of "
                    f"{n_out} buffers arrived")
            time.sleep(0.001)
        time.sleep(0.05)  # a duplicate would land after the last one
        outs = list(self.sub["out"].collected)[have:]
        pts = [b.pts for b in outs]
        first = self.pts - len(frames)
        lat = [(self.arrived[first + (i // BATCH + 1) * BATCH - 1]
                - pushed[i]) * 1e3 for i in range(len(frames))
               if first + (i // BATCH + 1) * BATCH - 1 in self.arrived]
        secs = max(self.arrived[q] for q in pts) - t0
        labels = [int(x) for b in outs
                  for x in np.asarray(b.tensors[0]).reshape(-1)]
        return secs, lat, labels, pts

    def close(self):
        for p in (self.sub, self.pub):
            if p is not None:
                p.stop()


def _check_camera_run(name, frames_n, first_pts, pts, labels, want):
    """Every frame arrived once and in order: one buffer a BATCH frames,
    each named by its last frame's pts, labels equal to the flagship's."""
    want_pts = [first_pts + (k + 1) * BATCH - 1
                for k in range(frames_n // BATCH)]
    if pts != want_pts:
        raise AssertionError(f"edge {name}: buffers {pts} for {want_pts}")
    if labels != want:
        bad = sum(a != b for a, b in zip(labels, want))
        raise AssertionError(f"edge {name}: {bad} of {len(want)} labels "
                             "differ from the flagship line's")


def _edge_launches(name, launches, buffers):
    if launches.get("fused_inverted_residual") != kernel_blocks() * buffers or \
            launches.get("normalize_u8") != buffers:
        raise AssertionError(f"edge {name}: launches {launches} over "
                             f"{buffers} forwards")


def check_edge_serving(torch, results, frames, launches_all):
    """(a) The serving line with connect-type=HYBRID (the server announces
    its bound TCP port on the port's MqttBroker, the 8 clients discover
    it) and over plain TCP, in turns (H T T H H T): labels equal to the
    direct forward on the same frames, 17 + 1 launches a served batch,
    requests/s, p50/p99 request latency and client start ms (which holds
    discovery) per run."""
    import numpy as np

    from nnstreamer_tpu_torch.edge.mqtt import MqttBroker
    from nnstreamer_tpu_torch.ops import _cuda

    labels = results["edge_labels"]
    names = [f"class{i}" for i in range(1001)]
    decoder = f"tensor_decoder mode=image_labeling option1={labels} ! "
    clients = [(_serve_frames(frames, i), None)
               for i in range(SERVE_CLIENTS)]
    total = SERVE_CLIENTS * SERVE_PER_CLIENT
    broker = MqttBroker()
    broker.start()
    try:
        hybrid_line = _serve_line().replace(
            "tensor_query_serversrc id=srv port=0 ",
            f"tensor_query_serversrc id=srv port=0 connect-type=HYBRID "
            f"topic={SERVE_TOPIC} dest-host=localhost "
            f"dest-port={broker.port} ", 1)
        if hybrid_line == _serve_line():
            raise AssertionError("edge: the serving line changed shape")
        forms = {"hybrid": (hybrid_line,
                            f"connect-type=HYBRID host=localhost "
                            f"port={broker.port} topic={SERVE_TOPIC}"),
                 "tcp": (_serve_line(), "")}
        _run_serving(_serve_line(), clients[:1], SERVE_FRAME_CAPS,
                     traced=False)  # warm-up, not measured
        want = None
        runs = {"hybrid": [], "tcp": []}
        for form in ("hybrid", "tcp", "tcp", "hybrid", "hybrid", "tcp"):
            line, connect = forms[form]
            _cuda.reset_launches()
            res, srv, secs, (forward, device) = _run_serving(
                line, clients, SERVE_FRAME_CAPS, decoder=decoder,
                client_connect=connect)
            launches = dict(_cuda.LAUNCHES)
            for k, v in launches.items():
                launches_all[k] = launches_all.get(k, 0) + v
            _serve_launches(f"edge {form}", launches, srv["batches"])
            _check_replies(f"edge {form}", res, SERVE_PER_CLIENT)
            if srv["rows"] != total or srv["shed"] != 0:
                raise AssertionError(f"edge {form}: serving report {srv}")
            if want is None:
                with torch.inference_mode():
                    want = {i: [names[j] for j in forward(
                        torch.from_numpy(np.stack(fr)).to(device)
                    ).float().argmax(-1).tolist()]
                        for i, (fr, _) in enumerate(clients)}
            ok = True
            for i, r in res.items():
                got = []
                for b in r["out"]:
                    lab = b.meta["label"]
                    got.extend(lab if isinstance(lab, list) else [lab])
                ok = ok and got == want[i]
            if not ok:
                raise AssertionError(f"edge {form}: a reply's label differs "
                                     "from the direct forward's")
            lat = _latencies_ms(res)
            runs[form].append({
                "requests_per_s": total / secs,
                "p50_request_ms": _pct(lat, 0.5),
                "p99_request_ms": _pct(lat, 0.99),
                "client_start_ms": statistics.median(
                    r["play_ms"] for r in res.values()),
                "batches": srv["batches"], "launches": launches})
    finally:
        broker.close()
    row = {}
    for form, rs in runs.items():
        row[form] = {key: _fps_stats([r[key] for r in rs])
                     for key in ("requests_per_s", "p50_request_ms",
                                 "p99_request_ms", "client_start_ms")}
        row[form]["batches"] = [r["batches"] for r in rs]
    row["discovery_ms"] = _fps_stats(
        [h["client_start_ms"] - t["client_start_ms"]
         for h, t in zip(runs["hybrid"], runs["tcp"])])
    emit("edge", part="hybrid_serving", clients=SERVE_CLIENTS,
         requests=total, serve_batch=SERVE_BATCH, order="H T T H H T",
         labels_equal_direct_forward=True, **row, card=results["card"])


def check_edge_mqtt(torch, results, frames, want, launches_all):
    """(b) The MQTT camera line: appsrc ! tensor_converter
    frames-per-tensor=128 ! mqttsink broker=embedded qos=1 into mqttsrc
    qos=1 ! the flagship's filter (postproc:argmax): 1,024 frames as 8
    messages a run, a warm-up run and EDGE_RUNS measured runs, then a
    profiled one."""
    from nnstreamer_tpu_torch.ops import _cuda

    line = _CameraLine(
        f"mqttsink name=sink broker=embedded port=0 topic={CAM_TOPIC} qos=1",
        lambda pub: (f"mqttsrc name=msrc port={pub['sink'].port} "
                     f"topic={CAM_TOPIC} qos=1"))
    try:
        deadline = time.monotonic() + 30
        broker = line.pub["sink"]._broker
        while not any(broker._subs.values()):
            if time.monotonic() > deadline:
                raise TimeoutError("edge mqtt: mqttsrc never subscribed")
            time.sleep(0.01)
        line.run(frames[:2 * BATCH])  # warm-up, not measured
        spans = {"publish": [], "broker": [], "create": [], "recv": [],
                 "filter": [], "bytes": []}
        _timed(line.pub["sink"], "chain", spans["publish"])
        _timed(broker, "_fanout", spans["broker"])
        _timed(line.sub["f"], "chain", spans["filter"])
        _timed(line.pub["sink"]._client, "publish", spans["bytes"],
               record=lambda a, out: len(a[1]))
        client = line.sub["msrc"]._client
        recv_s = [0.0]
        orig_recv, orig_create = client.recv, line.sub["msrc"].create

        def recv(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig_recv(*a, **kw)
            finally:
                recv_s[0] += time.perf_counter() - t0

        def create():
            r0, t0 = recv_s[0], time.perf_counter()
            buf = orig_create()
            if buf is not None:
                spans["create"].append(time.perf_counter() - t0
                                       - (recv_s[0] - r0))
            return buf

        client.recv = recv
        line.sub["msrc"].create = create
        fps, lats = [], []
        _cuda.reset_launches()
        for _ in range(EDGE_RUNS):
            first = line.pts
            secs, lat, labels, pts = line.run(frames)
            _check_camera_run("mqtt", len(frames), first, pts, labels, want)
            fps.append(len(frames) / secs)
            lats.extend(lat)
        launches = dict(_cuda.LAUNCHES)
        for k, v in launches.items():
            launches_all[k] = launches_all.get(k, 0) + v
        _edge_launches("mqtt", launches, EDGE_RUNS * len(frames) // BATCH)
        msgs = EDGE_RUNS * len(frames) // BATCH
        host = {k: 1e3 * sum(spans[k]) / msgs
                for k in ("publish", "broker", "filter")}
        host["decode"] = 1e3 * sum(spans["create"]) / msgs
        dups = {"broker_received": broker.dups_received,
                "subscriber_received": client.dups_received,
                "subscriber_dropped": client.dups_dropped}

        def profiled():
            first = line.pts
            secs, _, labels, pts = line.run(frames)
            _check_camera_run("mqtt profile", len(frames), first, pts,
                              labels, want)
            return secs

        prof = device_profile(torch, profiled)
    finally:
        line.close()
    emit("edge", part="mqtt_camera", frames=len(frames),
         messages_per_run=len(frames) // BATCH, qos=1,
         fps=_fps_stats(fps), p50_frame_latency_ms=statistics.median(lats),
         bytes_per_message=sorted(set(spans["bytes"])),
         duplicates=dups, host_ms_per_message=host, launches=launches,
         every_frame_once_in_order=True, labels_equal_flagship=True,
         card=results["card"])
    emit("profile", line="edge_mqtt", frames=len(frames), **prof,
         card=results["card"])
    # one publish a message, each the batch's tensor and a header of a few
    # hundred bytes (its JSON meta's digits vary with pts and the epoch)
    sizes = spans["bytes"]
    if len(sizes) != msgs + len(frames) // BATCH or \
            min(sizes) < BATCH * SIZE * SIZE * 3 or \
            max(sizes) - BATCH * SIZE * SIZE * 3 > 1024:
        raise AssertionError(f"edge mqtt: {len(sizes)} publishes of "
                             f"{sorted(set(sizes))} bytes")


def check_edge_pubsub(torch, results, frames, want, launches_all):
    """(c) edgesink connect-type=HYBRID ! (TCP) ! edgesrc
    connect-type=HYBRID ! the flagship's filter, the same frames."""
    from nnstreamer_tpu_torch.edge.mqtt import MqttBroker
    from nnstreamer_tpu_torch.ops import _cuda

    broker = MqttBroker()
    broker.start()
    line = None
    try:
        line = _CameraLine(
            f"edgesink name=es connect-type=HYBRID topic={PUB_TOPIC} "
            f"dest-host=localhost dest-port={broker.port}",
            lambda pub: (f"edgesrc name=esrc connect-type=HYBRID "
                         f"host=localhost port={broker.port} "
                         f"topic={PUB_TOPIC} timeout=30"))
        deadline = time.monotonic() + 30
        while not line.pub["es"]._server._conns:
            if time.monotonic() > deadline:
                raise TimeoutError("edge pubsub: edgesrc never connected")
            time.sleep(0.01)
        line.run(frames[:2 * BATCH])  # warm-up, not measured
        fps = []
        _cuda.reset_launches()
        for _ in range(EDGE_RUNS):
            first = line.pts
            secs, _, labels, pts = line.run(frames)
            _check_camera_run("pubsub", len(frames), first, pts, labels,
                              want)
            fps.append(len(frames) / secs)
        launches = dict(_cuda.LAUNCHES)
    finally:
        if line is not None:
            line.close()
        broker.close()
    for k, v in launches.items():
        launches_all[k] = launches_all.get(k, 0) + v
    _edge_launches("pubsub", launches, EDGE_RUNS * len(frames) // BATCH)
    emit("edge", part="edgesink_edgesrc_hybrid", frames=len(frames),
         fps=_fps_stats(fps), launches=launches, labels_equal_flagship=True,
         card=results["card"])


def check_wide_attention(torch, results):
    """Phase ``wide``: kernels 4 and 5 from head_dim 256 up (the
    tensor-core body at 256 and the split bodies above), bf16 and float32,
    causal and not, against their plain versions at the instance's key
    block and the ``attention`` and ``chunk`` phases' tolerances; the
    chunk kernel on carries from an earlier hop at the diagonal, a
    non-causal hop, a hop whose first q tiles see none of the chunk (their
    CTAs pass m and l through) and one wholly in the future (carries
    bit-identical; every bf16 head dim and float32 at 384). Every flash
    case and every causal diagonal hop is timed."""
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops.attention import (
        flash_attention_cuda,
        flash_attention_plain,
        flash_chunk_cuda,
        flash_chunk_plain,
        flash_kernel_attributes,
        head_dim_slices,
        key_block,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(21)
    bh, n = SPLIT_BH, SPLIT_SEQ
    rows = {"flash_attention": [], "flash_chunk": []}
    for d in SPLIT_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            atol, rtol = _tols(torch, dtype)
            dt = _dtype_name(dtype)
            q, k, v, k0, v0 = (torch.randn((bh, n, d), generator=gen,
                                           device="cuda").to(dtype)
                               for _ in range(5))
            for causal in (False, True):
                def kern():
                    return flash_attention_cuda(q, k, v, causal=causal)

                def plain():
                    return flash_attention_plain(q, k, v, causal=causal)

                def library():
                    return F.scaled_dot_product_attention(
                        q[None], k[None], v[None], is_causal=causal)

                got, want = kern(), plain()
                torch.cuda.synchronize()
                ok = (got.dtype == dtype
                      and bool(torch.isfinite(got.float()).all())
                      and within(got, want, atol, rtol))
                nbytes, ops = attention_work(bh, n, n, d, causal,
                                             itemsize=q.element_size())
                row = {"kernel": "flash_attention", "d": d, "dtype": dt,
                       "causal": causal, "shape": [bh, n, d],
                       "slices": head_dim_slices(d),
                       "block_k": key_block(d, dtype),
                       "max_abs_err": max_err(got, want), "atol": atol,
                       "rtol": rtol, "ok": ok,
                       "ms": cuda_ms(kern, reps=10),
                       "device_ms": device_ms(torch, kern, "flash_fwd", 5),
                       "plain_ms": cuda_ms(plain, reps=3, warmup=1),
                       "library_ms": cuda_ms(library, reps=10),
                       **flash_kernel_attributes(d, dtype=dtype)}
                row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, dt)
                row["bytes"], row["ops"] = nbytes, ops
                emit("wide", part="attention", **row, card=results["card"])
                if not ok:
                    raise AssertionError(f"flash_attention d {d}: {row}")
                rows["flash_attention"].append(row)
            scale = 1.0 / d ** 0.5
            hops = [("diagonal", n, n, True), ("noncausal", n, 0, False),
                    ("masked", 0, n // 2, True)]
            if d == 384 or dtype == torch.bfloat16:
                hops.append(("future", 0, n, True))
            for case, q_off, k_off, causal in hops:
                kw = dict(q_offset=q_off, k_offset=k_off, causal=causal,
                          scale=scale)
                carries = flash_chunk_plain(
                    q, k0, v0, *_carries(torch, bh, n, d), q_offset=q_off,
                    k_offset=q_off - n, causal=True, scale=scale)
                before = [c.clone() for c in carries]
                got = flash_chunk_cuda(q, k, v, *[c.clone() for c in carries],
                                       **kw)
                want = flash_chunk_plain(q, k, v, *carries, **kw)
                torch.cuda.synchronize()
                out_got, out_want = (c[2] / c[1].clamp(min=1e-37)[..., None]
                                     for c in (got, want))
                m_err = max_err(got[0], want[0])
                l_rel = float(((got[1] - want[1]).abs()
                               / want[1].abs().clamp(min=1e-30)).max())
                m_atol, l_rtol = ((CHUNK_M_ATOL, CHUNK_L_RTOL)
                                  if dtype == torch.bfloat16
                                  else (F32_ATOL, F32_RTOL))
                if case == "future":
                    ok = all(torch.equal(g.view(torch.int32),
                                         c.view(torch.int32))
                             for g, c in zip(got, before))
                else:
                    ok = (all(bool(torch.isfinite(c).all()) for c in got)
                          and within(out_got, out_want, atol, rtol)
                          and m_err <= m_atol and l_rel <= l_rtol)
                row = {"kernel": "flash_chunk", "d": d, "dtype": dt,
                       "case": case, "q_offset": q_off, "k_offset": k_off,
                       "causal": causal, "shape": [bh, n, n, d],
                       "slices": head_dim_slices(d),
                       "block_k": key_block(d, dtype),
                       "max_abs_err": max_err(out_got, out_want),
                       "atol": atol, "rtol": rtol, "m_max_abs_err": m_err,
                       "m_atol": m_atol, "l_max_rel_err": l_rel,
                       "l_rtol": l_rtol, "ok": ok,
                       **flash_kernel_attributes(d, carry=True, dtype=dtype)}
                if case == "diagonal":
                    work = [c.clone() for c in carries]

                    def kern():
                        return flash_chunk_cuda(q, k, v, *work, **kw)

                    nbytes, ops = attention_work(
                        bh, n, n, d, causal, q_off, k_off, carries=True,
                        itemsize=q.element_size())
                    row.update(ms=cuda_ms(kern, reps=10),
                               device_ms=device_ms(torch, kern,
                                                   "flash_chunk", 5),
                               plain_ms=cuda_ms(lambda: flash_chunk_plain(
                                   q, k, v, *carries, **kw),
                                   reps=3, warmup=1),
                               library_ms=None, bytes=nbytes, ops=ops)
                    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops,
                                                                dt)
                emit("wide", part="chunk", **row, card=results["card"])
                if not ok:
                    raise AssertionError(f"flash_chunk d {d}: {row}")
                rows["flash_chunk"].append(row)
    results["wide_attention"] = rows


def check_edge(torch, results, workdir):
    """Phase ``edge``: the among-device transports serving and feeding
    MobileNet-v2 (a HYBRID serving, b MQTT camera, c edgesink/edgesrc
    HYBRID)."""
    labels = os.path.join(workdir, "edge_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    results["edge_labels"] = labels
    frames = _edge_frames()
    want = _flagship_indices(torch, labels, frames)
    if len(set(want)) < 2:
        raise AssertionError("edge: the frames' labels cannot tell frames "
                             "apart")
    launches = {}
    check_edge_serving(torch, results, frames[:BATCH], launches)
    check_edge_mqtt(torch, results, frames, want, launches)
    check_edge_pubsub(torch, results, frames, want, launches)
    results["edge_launches"] = launches


# -- phase: whole-chain fusion (the cascade, line K) --------------------------

#: line K: 8 timed batches of BATCH frames a run after N_WARMUP, 3 runs of
#: each form in turns (F O O F F O); the looped head's window and depth
CHAIN_BATCHES = 8
CHAIN_TURNS = ("auto", "off", "off", "auto", "auto", "off")
CHAIN_LOOP = {"window": 4, "depth": 2, "batches": 8}
#: the gap transform between the two models
CHAIN_GAP = "typecast:float32,div:2.0"


def _cascade_line(labels: str, extra: str = "", raw: bool = False) -> str:
    """Line K: the flagship's head (MobileNet-v2 1.0 at 224 px, 128 frames
    a tensor, no postproc) with a second model behind it — a gap
    transform, then a bf16 1001x1001 product with the argmax — into the
    labels; ``extra`` goes on the head, ``raw`` leaves out the argmax and
    the decoder, so the sink receives the logits."""
    post = "" if raw else ",postproc:argmax"
    tail = ("" if raw else "! queue ! tensor_decoder mode=image_labeling "
            f"option1={labels} ")
    return (
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=1000/1 "
        f"! tensor_converter frames-per-tensor={BATCH} "
        "! tensor_filter name=m framework=jax model=mobilenet_v2 "
        f"custom=seed:0,fused:pallas {extra} "
        f"! queue ! tensor_transform name=tr mode=arithmetic "
        f"option={CHAIN_GAP} "
        "! tensor_filter name=h framework=jax model=matmul "
        f"custom=dim:1001,seed:1{post} {tail}! tensor_sink name=out")


def _chain_run(torch, line, frames, n_batches, chain_fusion="auto",
               warm=N_WARMUP, profile=False):
    """Play line K with ``chain_fusion``, warm ``warm`` batches, set the
    launch counts to 0, push ``n_batches`` timed batches and EOS; returns
    the labels (or logits) of the timed batches, frames/s, p50 batch
    latency, the launches, the crossings per element, the fusions, h's
    invokes and m's builds during the timed run, the loop state and
    stats, and (``profile``) the device profile of the timed run."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    import numpy as np

    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    p = parse_launch(line)
    p.chain_fusion = chain_fusion
    pushed, arrived = {}, {}
    p["out"].connect_new_data(
        lambda b: arrived.__setitem__(b.pts, time.perf_counter()))
    fusions = trace.attach(p).fusions  # the planner records at play()
    p.play()

    def push(k0, n):
        for i in range(k0 * BATCH, (k0 + n) * BATCH):
            p["src"].push_buffer(Buffer(tensors=[frames[i % len(frames)]],
                                        pts=i))
            pushed[i] = time.perf_counter()

    if warm:
        push(0, warm)
        _wait_for(lambda: [len(p["out"].collected)], warm, p, "line K")
    tracer = trace.attach(p, replace=True)
    h_before = p["h"].fw.stats.total_invoke_num
    builds_before = p["m"].fw.compile_stats()["jit_traces"]
    torch.cuda.synchronize()
    _cuda.reset_launches()
    prof = (torch_profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
            if profile else None)
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    push(warm, n_batches)
    p["src"].end_of_stream()
    if not p.bus.wait_eos(600) or p.bus.error is not None:
        raise RuntimeError(f"line K failed: {p.bus.error}")
    secs = max(arrived.values()) - t0
    if prof is not None:
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    launches = dict(_cuda.LAUNCHES)
    out = []
    for b in p["out"].collected[warm:]:
        lab = b.meta.get("label")
        out.extend(lab if lab is not None else [np.asarray(b.tensors[0])])
    m = p["m"]
    r = {"out": out, "fps": n_batches * BATCH / secs,
         "p50_batch_latency_ms": statistics.median(
             (arrived[k] - pushed[k]) * 1e3 for k in arrived
             if k >= warm * BATCH),
         "launches": launches, "crossings": _crossings_of(tracer),
         "fusions": fusions(),
         "h_invokes": p["h"].fw.stats.total_invoke_num - h_before,
         "m_builds": m.fw.compile_stats()["jit_traces"] - builds_before,
         "m_builds_total": m.fw.compile_stats()["jit_traces"],
         "loop_state": m._loop_state, "loop_refused": m._loop_refused,
         "loop_stats": (m.fw.loop_stats() if m._loop_state is not None
                        else None)}
    if prof is not None:
        r["profile"] = profile_stats(torch, prof, secs)
    p.stop()
    return r


def _chain_launches_ok(launches, rows) -> bool:
    """17 fused-block, 1 normalize_u8 and 1 arith_chain launches per
    batch row (the head's blocks and preamble, the gap)."""
    return (launches.get("fused_inverted_residual") == kernel_blocks() * rows
            and launches.get("normalize_u8") == rows
            and launches.get("arith_chain") == rows)


def check_chain_gap(torch, results):
    """(c) arith_chain at the gap's shape, 128 x 1001 float32, against its
    plain version: bit-equal, kernel, device, plain, bound and (x / 2.0,
    one PyTorch call computing the same) library ms."""
    from nnstreamer_tpu_torch.ops import arith_chain, arith_chain_plain

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(BATCH, 1001, generator=gen, device="cuda") * 8
    ops = [("div", 2.0)]
    k = arith_chain(x, ops, out_dtype=torch.float32)
    want = arith_chain_plain(x, ops, out_dtype=torch.float32)
    n = x.numel()
    row = {"kernel": "arith_chain", "case": "chain_gap",
           "shape": list(x.shape), "in": "float32", "ops": CHAIN_GAP,
           "max_abs_err": max_err(k, want), "tol": 0.0,
           "bit_equal": _bits_equal(torch, k, want),
           "library_bit_equal": _bits_equal(torch, k, x / 2.0),
           "ms": cuda_ms(lambda: arith_chain(x, ops, torch.float32)),
           "device_ms": device_ms(
               torch, lambda: arith_chain(x, ops, torch.float32),
               "arith_chain"),
           "plain_ms": cuda_ms(
               lambda: arith_chain_plain(x, ops, torch.float32)),
           "library_ms": cuda_ms(lambda: x / 2.0)}
    row["bound_ms"], row["bound_by"] = bound_ms(8 * n, n, "float32")
    emit("chain", part="gap_kernel", **row, card=results["card"])
    if not row["bit_equal"]:
        raise AssertionError(f"arith_chain at the chain gap: {row}")
    results["arith_chain_gap"] = row


def check_chain_budget(results):
    """(d) NNST452 on the card: the analyzer alone (the line is never
    played) on an add → add chain whose composed program holds about 1.5
    times ``device_memory_budget()``; and the fixture's 12 GiB line, which
    the card's budget admits (NNST450)."""
    from nnstreamer_tpu_torch.analysis import analyze_launch
    from nnstreamer_tpu_torch.analysis.memplan import device_memory_budget

    budget, source = device_memory_budget()
    # the composed run holds its input and both members' outputs: three
    # frames of half the budget
    rows = -(-budget // (2 * 4 * 1024 * 1024))
    caps = ("other/tensors,num-tensors=1,"
            f"dimensions=1024:1024:{rows},types=float32,framerate=0/1")
    line = (f"appsrc caps={caps} ! tensor_filter name=f1 framework=jax "
            "model=add custom=k:1 ! tensor_filter name=f2 framework=jax "
            "model=add custom=k:10 ! tensor_sink")
    over = [d for d in analyze_launch(line) if d.code.startswith("NNST45")]
    with open(os.path.join(ROOT, "examples",
                           "launch_lines_chains.txt")) as f:
        fixture = [ln.strip() for ln in f
                   if "dimensions=1536:1024:2048" in ln]
    fix = [d for d in analyze_launch(fixture[0])
           if d.code.startswith("NNST45")]
    row = {"budget_bytes": budget, "budget_source": source,
           "frame_bytes": rows * 4 * 1024 * 1024,
           "over_budget": [(d.code, d.element, d.message) for d in over],
           "fixture_12gib": [(d.code, d.message) for d in fix]}
    emit("chain", part="budget", **row, card=results["card"])
    if (source != "cuda" or [d.code for d in over] != ["NNST452"]
            or [d.code for d in fix] != ["NNST450"]):
        raise AssertionError(f"chain budget verdicts: {row}")


def check_chain(torch, results, workdir):
    """Phase ``chain``: (a) line K fused and with chain-fusion=off in
    turns, (b) the looped head, (c) the gap kernel, (d) NNST452."""
    import numpy as np

    from nnstreamer_tpu_torch.analysis import analyze_launch
    from nnstreamer_tpu_torch.analysis.loop import analyze_loop
    from nnstreamer_tpu_torch.pipeline import parse_launch

    labels = os.path.join(workdir, "chain_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    rng = np.random.default_rng(11)
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(BATCH)]
    verdict = [(d.code, d.element, d.message)
               for d in analyze_launch(_cascade_line(labels))
               if d.code.startswith("NNST45")]
    if [v[0] for v in verdict] != ["NNST450"]:
        raise AssertionError(f"line K: chain verdict {verdict}")
    total = {}

    def add(r):
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v

    # (a) fused and chain-fusion=off in turns
    runs = {"auto": [], "off": []}
    for cf in CHAIN_TURNS:
        runs[cf].append(_chain_run(torch, _cascade_line(labels), frames,
                                   CHAIN_BATCHES, chain_fusion=cf))
    want = runs["off"][0]["out"]
    n = CHAIN_BATCHES
    bad = []
    for cf, rs in runs.items():
        for r in rs:
            add(r)
            if r["out"] != want or len(r["out"]) != n * BATCH:
                bad.append(f"{cf}: labels differ from chain-fusion=off's")
            if not _chain_launches_ok(r["launches"], n):
                bad.append(f"{cf}: launches {r['launches']}")
            cr = r["crossings"]
            if cr["h2d"] != n or cr["d2h"] != n \
                    or cr["per_element"].get("m", {}).get("h2d") != n:
                bad.append(f"{cf}: crossings {cr}")
    for r in runs["auto"]:
        if (r["fusions"] != {"tr": "fused-into:m", "h": "fused-into:m"}
                or r["h_invokes"] != 0 or r["m_builds_total"] != 1
                or "h" in r["crossings"]["per_element"]):
            bad.append(f"fused: {r['fusions']}, h invokes "
                       f"{r['h_invokes']}, m builds {r['m_builds_total']}")
    for r in runs["off"]:
        if r["fusions"] != {"tr": "fused-into:h"} or r["h_invokes"] != n:
            bad.append(f"off: {r['fusions']}, h invokes {r['h_invokes']}")
    # the logits, fused against off, on the same frames
    raw = {cf: _chain_run(torch, _cascade_line(labels, raw=True), frames,
                          2, chain_fusion=cf, warm=0)
           for cf in ("auto", "off")}
    for r in raw.values():
        add(r)
    got = torch.from_numpy(np.concatenate(raw["auto"]["out"]))
    ref = torch.from_numpy(np.concatenate(raw["off"]["out"]))
    logits = {"shape": list(got.shape), "max_abs_err": max_err(got, ref),
              "bit_equal": bool(torch.equal(got, ref)),
              "finite": bool(torch.isfinite(got).all()),
              "atol": MODEL_ATOL, "rtol": MODEL_RTOL}
    if (tuple(got.shape) != (2 * BATCH, 1001) or not logits["finite"]
            or not within(got, ref, MODEL_ATOL, MODEL_RTOL)):
        bad.append(f"logits: {logits}")

    def summary(rs):
        fps = [r["fps"] for r in rs]
        return {"fps": fps, "median_fps": statistics.median(fps),
                "spread_fps": max(fps) - min(fps),
                "p50_batch_latency_ms": [r["p50_batch_latency_ms"]
                                         for r in rs],
                "median_p50_ms": statistics.median(
                    r["p50_batch_latency_ms"] for r in rs)}

    f0, o0 = runs["auto"][0], runs["off"][0]
    emit("chain", part="line_k", batches=n, batch=BATCH, verdict=verdict,
         turns=list(CHAIN_TURNS), fused=summary(runs["auto"]),
         off=summary(runs["off"]), labels_equal=not any(
             "labels" in b for b in bad),
         distinct_labels=len(set(want)),
         launches_per_batch={k: v / n for k, v in f0["launches"].items()},
         off_launches_per_batch={k: v / n
                                 for k, v in o0["launches"].items()},
         crossings_per_batch={el: {d: c[d] / n for d in c} for el, c in
                              f0["crossings"]["per_element"].items()},
         off_crossings_per_batch={el: {d: c[d] / n for d in c} for el, c in
                                  o0["crossings"]["per_element"].items()},
         fusions=f0["fusions"], off_fusions=o0["fusions"],
         h_invokes={"fused": f0["h_invokes"], "off": o0["h_invokes"]},
         m_builds=f0["m_builds_total"], logits=logits,
         card=results["card"])
    if bad:
        raise AssertionError(f"line K: {bad}")

    def run():
        r = _chain_run(torch, _cascade_line(labels), frames, 4, warm=0)
        add(r)
        return 4 * BATCH / r["fps"]

    emit("profile", line="chain", batches=4, **device_profile(torch, run))

    # (b) the looped head: one graph replay a window over the whole
    # composition
    loop = (f"loop-window={CHAIN_LOOP['window']} "
            f"launch-depth={CHAIN_LOOP['depth']}")
    pk = parse_launch(_cascade_line(labels, loop))
    lv = analyze_loop(pk, pk["m"])
    nb = CHAIN_LOOP["batches"]
    windows = nb // CHAIN_LOOP["window"]
    _chain_run(torch, _cascade_line(labels, loop), frames, nb, warm=0)
    lr = _chain_run(torch, _cascade_line(labels, loop), frames, nb, warm=0)
    add(lr)
    st = lr["loop_stats"] or {}
    want_loop = [want[i % len(want)] for i in range(nb * BATCH)]
    loop_ok = (lv.code == "NNST460" and lr["loop_refused"] is None
               and lr["loop_state"] == {"window": CHAIN_LOOP["window"],
                                        "depth": CHAIN_LOOP["depth"]}
               and st.get("replays") == windows and st.get("captures") == 1
               and lr["h_invokes"] == 0
               and lr["fusions"] == {"tr": "fused-into:m",
                                     "h": "fused-into:m"}
               and lr["out"] == want_loop
               and _chain_launches_ok(lr["launches"], nb)
               and lr["crossings"]["per_element"].get("m", {}).get("h2d")
               == windows)
    emit("chain", part="loop", verdict=lv.code, window=CHAIN_LOOP["window"],
         depth=CHAIN_LOOP["depth"], batches=nb, windows=windows,
         replays=st.get("replays"), captures=st.get("captures"),
         capture_ms=st.get("capture_ms"),
         launches_per_replay=st.get("launches_per_replay"),
         launches=lr["launches"], crossings=lr["crossings"],
         h_invokes=lr["h_invokes"], labels_equal=lr["out"] == want_loop,
         fps=lr["fps"], ok=loop_ok, card=results["card"])
    if not loop_ok:
        raise AssertionError(f"line K looped: {lv}, {lr['loop_refused']}, "
                             f"{st}")
    results["chain_launches"] = total
    check_chain_gap(torch, results)
    check_chain_budget(results)


#: the robust phase: the watchdog's deadline, each injected hang (longer
#: than the deadline), the trips before the switch (fallback-after), the
#: batches run on the fallback after it, and the order of the timed turns
ROBUST_T_MS = 1000
ROBUST_HANG_S = 1.5
ROBUST_K = 2
ROBUST_AFTER = 6
ROBUST_TURNS = ("on", "off", "off", "on", "on", "off")
#: codes the sanitizer reports as a warning, not a violation of the run
SANITIZER_WARNINGS = ("NNST613",)


def _robust_line(labels: str, extra: str = "", custom: str = "",
                 raw: bool = False) -> str:
    """The flagship with the preamble fused into the filter, on the
    torch_cuda backend: ``extra`` goes on the filter, ``custom`` after its
    custom string, ``raw`` sends the logits to the sink (no argmax, no
    decoder)."""
    post = "" if raw else ",postproc:argmax"
    tail = ("" if raw else "! queue ! tensor_decoder mode=image_labeling "
            f"option1={labels} ")
    return (
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=1000/1 "
        f"! tensor_converter frames-per-tensor={BATCH} "
        f"! tensor_transform name=tr mode=arithmetic option={PREAMBLE} "
        "! tensor_filter name=f framework=torch_cuda model=mobilenet_v2 "
        f"custom=seed:0,fused:pallas{post}{custom} {extra} "
        f"{tail}! tensor_sink name=out")


def _until(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"robust: {what}")
        time.sleep(0.002)


def _add_launches(total, launches) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _hard_violations(sanitizer) -> list:
    return [(v.code, v.element, v.message[:200])
            for v in sanitizer.violations()
            if v.code not in SANITIZER_WARNINGS]


def _logits_by_pts(p) -> dict:
    import numpy as np

    return {b.pts: np.asarray(b.tensors[0]) for b in p["out"].collected}


def check_robust_trip(torch, labels, frames, total):
    """(a) The watchdog trips, the filter switches, the labels stay right:
    invoke-hang on the first ROBUST_K invokes (longer than the deadline),
    each batch paced until its abandoned invoke has run; the first batch
    is dropped, the K-th trip switches to a fresh ``jax`` instance that
    serves that batch, and every delivered batch's logits are bit-equal
    to an unfaulted run's. Then ROBUST_AFTER batches on the fallback with
    the launch counts from 0."""
    import numpy as np

    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch
    from nnstreamer_tpu_torch.testing import faults

    n = ROBUST_K + ROBUST_AFTER
    p, _, _, _, launches = _run_line(_robust_line(labels, raw=True), frames,
                                     n, warm=0)
    _add_launches(total, launches)
    want = _logits_by_pts(p)
    p.stop()

    wd = (f"invoke-timeout-ms={ROBUST_T_MS} fallback-framework=jax "
          f"fallback-after={ROBUST_K} on-error=drop")
    p = parse_launch(_robust_line(labels, wd, raw=True))
    p.play()
    f = p["f"]
    primary = f.fw

    def push(k):
        for i in range(k * BATCH, (k + 1) * BATCH):
            p["src"].push_buffer(Buffer(tensors=[frames[i % len(frames)]],
                                        pts=i))

    faults.install("invoke-hang", times=ROBUST_K, delay_s=ROBUST_HANG_S)
    try:
        t0 = time.perf_counter()
        for k in range(ROBUST_K):
            push(k)
            _until(lambda: f.get_property("watchdog-trips") >= k + 1,
                   f"trip {k + 1}")
            # the abandoned invoke wakes and launches on the primary
            _until(lambda: primary.stats.total_invoke_num >= k + 1,
                   f"abandoned invoke {k + 1}")
        _wait_for(lambda: [len(p["out"].collected)], ROBUST_K - 1, p,
                  "robust switch")
        switch_s = time.perf_counter() - t0
    finally:
        faults.clear()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    for k in range(ROBUST_K, n):
        push(k)
    _wait_for(lambda: [len(p["out"].collected)], n - 1, p, "robust")
    torch.cuda.synchronize()
    after = dict(_cuda.LAUNCHES)
    _add_launches(total, after)
    p["src"].end_of_stream()
    if not p.bus.wait_eos(120) or p.bus.error is not None:
        raise RuntimeError(f"robust trip line failed: {p.bus.error}")
    got = _logits_by_pts(p)
    kept = sorted(want)[1:]  # the first batch is the one the trips cost
    bit_equal = sorted(got) == kept and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        for k in kept)
    labels_equal = sorted(got) == kept and all(
        np.array_equal(got[k].argmax(-1), want[k].argmax(-1)) for k in kept)
    row = {"timeout_ms": ROBUST_T_MS, "hang_s": ROBUST_HANG_S,
           "fallback_after": ROBUST_K, "batches": n,
           "watchdog_trips": f.get_property("watchdog-trips"),
           "degraded_to": f.get_property("degraded-to"),
           "error_stats": f.get_property("error-stats"),
           "fault_actions": [r["action"] for r in p.bus.fault_record],
           "delivered_batches": len(got), "dropped_pts": sorted(
               set(want) - set(got)),
           "fresh_instance": f.fw is not primary,
           "fallback_preamble": bool(f.fw._pre_specs),
           "primary_invokes": primary.stats.total_invoke_num,
           "fallback_invokes": f.fw.stats.total_invoke_num,
           "switch_s": switch_s, "logits_bit_equal": bit_equal,
           "labels_equal": labels_equal,
           "launches_after_switch": after,
           "launches_per_batch_after_switch": {
               k: v / ROBUST_AFTER for k, v in after.items()}}
    p.stop()
    ok = (row["watchdog_trips"] == ROBUST_K and row["degraded_to"] == "jax"
          and row["error_stats"].get("dropped") == 1
          and row["error_stats"].get("fallbacks") == 1
          and row["fault_actions"] == ["watchdog-trip", "drop"] * (
              ROBUST_K - 1) + ["watchdog-trip", "fallback"]
          and row["dropped_pts"] == [sorted(want)[0]]
          and row["fresh_instance"] and row["fallback_preamble"]
          and row["primary_invokes"] == ROBUST_K
          and bit_equal and labels_equal
          and after.get("fused_inverted_residual") == kernel_blocks() * ROBUST_AFTER
          and after.get("arith_chain") == ROBUST_AFTER
          and after.get("normalize_u8", 0) == 0)
    return row, ok


def check_robust_streams(torch, labels, frames, total):
    """The watchdog's worker invokes on the streaming thread's CUDA stream
    at feed-depth 1, 2 and 4 (no fault), with the labels of the unwatched
    feed-depth=1 line."""
    import threading

    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    seen = []
    orig_backend = TensorFilter._invoke_backend

    def spy_backend(self, inputs, replica=None):
        seen.append(("caller", threading.current_thread().name,
                     torch.cuda.current_stream().cuda_stream))
        return orig_backend(self, inputs, replica=replica)

    rows = {}
    p, _, _, _, launches = _run_line(_robust_line(labels), frames, 2, warm=1)
    _add_launches(total, launches)
    want = [lab for b in p["out"].collected for lab in b.meta["label"]]
    p.stop()
    TensorFilter._invoke_backend = spy_backend
    try:
        for fd in (1, 2, 4):
            seen.clear()
            p = _robust_parse(labels, f"invoke-timeout-ms={ROBUST_T_MS} "
                              f"feed-depth={fd}")
            fw_invoke = p["f"].fw.invoke

            def spy_invoke(inputs, _orig=fw_invoke):
                seen.append(("invoke", threading.current_thread().name,
                             torch.cuda.current_stream().cuda_stream))
                return _orig(inputs)

            p["f"].fw.invoke = spy_invoke
            got = _robust_play(torch, p, frames, 3)
            _add_launches(total, got["launches"])
            callers = {s for w, _, s in seen if w == "caller"}
            invokes = {s for w, _, s in seen if w == "invoke"}
            threads = {t for w, t, _ in seen if w == "invoke"}
            rows[fd] = {"caller_streams": sorted(callers),
                        "invoke_streams": sorted(invokes),
                        "invoke_threads": sorted(threads),
                        "invokes": sum(1 for w, _, _ in seen
                                       if w == "invoke"),
                        "labels_equal": got["labels"] == want}
    finally:
        TensorFilter._invoke_backend = orig_backend
    ok = all(r["caller_streams"] == r["invoke_streams"]
             and len(r["invoke_streams"]) == 1
             and r["invoke_threads"] == ["invoke-wd:f"]
             and r["invokes"] == 3 and r["labels_equal"]
             for r in rows.values())
    return rows, ok


def _robust_parse(labels, extra="", custom="", raw=False):
    from nnstreamer_tpu_torch.pipeline import parse_launch

    p = parse_launch(_robust_line(labels, extra, custom, raw))
    p.play()
    return p


def _robust_play(torch, p, frames, n_batches):
    """Push ``n_batches`` into a playing robust line, EOS, stop; returns
    the labels (or logits), the launches and the sink's buffers."""
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launches()
    for i in range(n_batches * BATCH):
        p["src"].push_buffer(Buffer(tensors=[frames[i % len(frames)]],
                                    pts=i))
    p["src"].end_of_stream()
    if not p.bus.wait_eos(300) or p.bus.error is not None:
        raise RuntimeError(f"robust line failed: {p.bus.error}")
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    outs = list(p["out"].collected)
    p.stop()
    labels = [lab for b in outs for lab in (b.meta.get("label") or [])]
    return {"labels": labels, "launches": launches, "outs": outs}


def _turns(run, turns=ROBUST_TURNS):
    """``run(on)`` for each turn; per side: frames/s and p50 batch latency
    of each run, their medians and spreads."""
    out = {"on": [], "off": []}
    for t in turns:
        out[t].append(run(t == "on"))

    def summary(rs):
        fps = [r["fps"] for r in rs]
        p50 = [r["p50_batch_latency_ms"] for r in rs]
        return {"fps": fps, "median_fps": statistics.median(fps),
                "spread_fps": max(fps) - min(fps),
                "p50_batch_latency_ms": p50,
                "median_p50_ms": statistics.median(p50),
                "spread_p50_ms": max(p50) - min(p50)}

    return {side: summary(rs) for side, rs in out.items()}


def check_robust_donate(torch, labels, frames, total):
    """(c) custom=donate:1 against off at feed-depth 1 and 2 on the raw
    line: every invoke's peak above what was allocated at its entry
    (``reset_peak_memory_stats`` before it, ``max_memory_allocated`` and
    ``max_memory_reserved`` after), logits bit-equal."""
    import numpy as np

    rows = {}
    outs = {}
    for fd in (1, 2):
        for donate in (False, True):
            p = _robust_parse(labels, f"feed-depth={fd}",
                              ",donate:1" if donate else "", raw=True)
            fw = p["f"].fw
            peaks = []
            orig = fw.invoke

            def spy(inputs, _orig=orig, _peaks=peaks):
                base = torch.cuda.memory_allocated()
                base_r = torch.cuda.memory_reserved()
                torch.cuda.reset_peak_memory_stats()
                out = _orig(inputs)
                _peaks.append((torch.cuda.max_memory_allocated() - base,
                               torch.cuda.max_memory_reserved() - base_r))
                return out

            fw.invoke = spy
            got = _robust_play(torch, p, frames, 4)
            _add_launches(total, got["launches"])
            steady = peaks[1:]  # the first invoke builds
            key = f"fd{fd}_{'on' if donate else 'off'}"
            rows[key] = {
                "donating": fw._donate,
                "peak_alloc_bytes": [a for a, _ in steady],
                "peak_reserved_growth_bytes": [r for _, r in steady],
                "median_peak_alloc_bytes": statistics.median(
                    a for a, _ in steady)}
            outs[key] = np.concatenate([np.asarray(b.tensors[0])
                                        for b in got["outs"]])
    frame_bytes = BATCH * SIZE * SIZE * 3
    for fd in (1, 2):
        on, off = rows[f"fd{fd}_on"], rows[f"fd{fd}_off"]
        rows[f"fd{fd}_fall_bytes"] = (off["median_peak_alloc_bytes"]
                                      - on["median_peak_alloc_bytes"])
        rows[f"fd{fd}_fall_minus_input_bytes"] = (
            rows[f"fd{fd}_fall_bytes"] - frame_bytes)
        rows[f"fd{fd}_bit_equal"] = bool(
            outs[f"fd{fd}_on"].shape == outs[f"fd{fd}_off"].shape
            and np.array_equal(outs[f"fd{fd}_on"], outs[f"fd{fd}_off"]))
    rows["input_bytes"] = frame_bytes
    ok = (rows["fd1_bit_equal"] and rows["fd2_bit_equal"]
          and rows["fd1_on"]["donating"] and not rows["fd1_off"]["donating"]
          and outs["fd1_on"].shape == (4 * BATCH, 1001))
    return rows, ok


def check_robust_tee_refusal(labels):
    """A donate:1 filter behind a tee is refused at construction."""
    from nnstreamer_tpu_torch.log import ElementError
    from nnstreamer_tpu_torch.pipeline import parse_launch

    line = (f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
            f"height={SIZE},framerate=1000/1 "
            f"! tensor_converter frames-per-tensor={BATCH} ! tee name=t "
            "t. ! queue ! tensor_filter name=f framework=torch_cuda "
            "model=mobilenet_v2 custom=seed:0,fused:pallas,donate:1 "
            "! tensor_sink name=out t. ! queue ! tensor_sink name=o2")
    p = parse_launch(line)
    try:
        p.play()
    except ElementError as e:
        p.stop()
        return str(e), "donate:1 is unsafe here" in str(e)
    p.stop()
    return "played", False


def check_robust_nnst600(torch):
    """(d) NNST600 on tensors on the card: a tee of CUDA tensors into two
    ``tensor_transform acceleration=device`` branches, the first of which
    writes its input in place (the reference's tee-aliasing case); the
    violation names it. Without the write, no violation."""
    from nnstreamer_tpu_torch.analysis import sanitizer
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.elements.transform import TensorTransform
    from nnstreamer_tpu_torch.pipeline import parse_launch

    caps = (f"other/tensors,num-tensors=1,dimensions=3:{SIZE}:{SIZE}:"
            f"{BATCH},types=uint8,framerate=0/1")
    line = (f"appsrc name=src caps={caps} ! tee name=t "
            f"t. ! tensor_transform name=tr mode=arithmetic "
            f"option={PREAMBLE} acceleration=device ! tensor_sink name=a "
            f"t. ! queue ! tensor_transform name=tr2 mode=arithmetic "
            f"option={PREAMBLE} acceleration=device ! tensor_sink name=b")
    orig = TensorTransform._device_chain_inputs

    def inplace(self, buf):
        xs = orig(self, buf)
        if self.name == "tr":
            for x in xs:
                x.add_(1)  # through the tee-shared tensor itself
        return xs

    rows = {}
    for mutate in (True, False):
        sanitizer.clear()
        TensorTransform._device_chain_inputs = inplace if mutate else orig
        try:
            p = parse_launch(line)
            p.play()
            x = torch.randint(0, 255, (BATCH, SIZE, SIZE, 3),
                              dtype=torch.uint8, device="cuda")
            p["src"].push_buffer(Buffer(tensors=[x]))
            p["src"].end_of_stream()
            p.bus.wait_eos(60)
            err = p.bus.error
            p.stop()
        finally:
            TensorTransform._device_chain_inputs = orig
        v = [(x.code, x.element) for x in sanitizer.violations()]
        rows["inplace" if mutate else "clean"] = {
            "violations": v, "bus_error": err is not None,
            "message": next((x.message[:160] for x in
                             sanitizer.violations()), None)}
    sanitizer.clear()
    ok = (rows["inplace"]["violations"] == [("NNST600", "tr")]
          and rows["inplace"]["bus_error"]
          and rows["clean"]["violations"] == []
          and not rows["clean"]["bus_error"])
    return rows, ok


def check_robust_clean_lines(torch, labels, frames, total):
    """(d) The flagship, the tee line and line K (the cascade) under the
    sanitizer: zero violations (NNST613 is a warning and listed)."""
    from nnstreamer_tpu_torch.analysis import sanitizer

    rows = {}
    for name, line in (("flagship", _robust_line(labels)),
                       ("tee", _fanout_line()),
                       ("line_k", _cascade_line(labels))):
        sanitizer.clear()
        p, _, _, _, launches = _run_line(line, frames, 2, warm=1)
        _add_launches(total, launches)
        p.stop()
        rows[name] = {"hard": _hard_violations(sanitizer),
                      "warnings": sorted({(v.code, v.element) for v in
                                          sanitizer.violations()
                                          if v.code in SANITIZER_WARNINGS})}
    sanitizer.clear()
    return rows, all(not r["hard"] for r in rows.values())


def check_robust_ctl(results):
    """(e) The ctl pass on the card: the validate CLI on the ctl fixture
    file gives each line's EXPECT code; the serve phase's line's static
    plant seed beside its measured device ms a row."""
    import re

    from nnstreamer_tpu_torch.analysis.plant import serving_launch_model
    from nnstreamer_tpu_torch.pipeline import parse_launch

    path = os.path.join(ROOT, "examples", "launch_lines_ctl.txt")
    out = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.tools.validate",
         "--json", "--file", path], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    doc = json.loads(out.stdout)
    expects, expect = [], None
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            m = re.match(r"#\s*EXPECT:\s*(NNST\d+)", line)
            if m:
                expect = m.group(1)
            elif line and not line.startswith("#"):
                expects.append(expect)
                expect = None
    got = [sorted({d["code"] for d in r["diagnostics"]})
           for r in doc["results"]]
    p = parse_launch(_serve_line())
    src = next(e for e in p.elements.values()
               if e.ELEMENT_NAME == "tensor_query_serversrc")
    seed = serving_launch_model(p, src)
    row = {"exit": out.returncode, "expects": expects, "codes": got,
           "serve_seed": seed,
           "serve_measured_row_device_ms": results.get(
               "serve_row_device_ms")}
    ok = (out.returncode == 2 and len(got) == len(expects)
          and all(e is None or e in g for e, g in zip(expects, got))
          and seed is not None and seed["row_device_ms"] > 0)
    return row, ok


def check_robust(torch, results, workdir):
    """Phase ``robust``: the flagship with the preamble fused, under this
    package's sanitizer: (a) the watchdog trips, switches and keeps the
    logits, the worker on the caller's stream; (b) the armed watchdog's
    cost without a fault and the sanitizer's, each in turns; (c)
    donation's peak and outputs; (d) NNST600 on the card and clean
    lines; (e) the ctl pass."""
    import numpy as np

    from nnstreamer_tpu_torch.analysis import lockwitness, sanitizer

    labels = os.path.join(workdir, "robust_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    rng = np.random.default_rng(16)
    # three batches of distinct frames: the batches a run compares differ
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(3 * BATCH)]
    total = {}
    bad = []
    sanitizer.enable(True)
    sanitizer.clear()
    lockwitness.reset()
    try:
        trip, ok = check_robust_trip(torch, labels, frames, total)
        trip_violations = [(v.code, v.element) for v in
                           sanitizer.violations()]
        trip["nnst601"] = sum(1 for c, _ in trip_violations
                              if c == "NNST601")
        trip["hard_violations"] = _hard_violations(sanitizer)
        emit("robust", part="trip", **trip, card=results["card"])
        if not ok or trip["nnst601"] or trip["hard_violations"]:
            bad.append(f"trip: {trip}")
        sanitizer.clear()
        streams, ok = check_robust_streams(torch, labels, frames, total)
        emit("robust", part="worker_stream", feed_depths=streams,
             hard_violations=_hard_violations(sanitizer),
             card=results["card"])
        if not ok or _hard_violations(sanitizer):
            bad.append(f"worker stream: {streams}")
        sanitizer.clear()
        donate, ok = check_robust_donate(torch, labels, frames, total)
        refusal, refused = check_robust_tee_refusal(labels)
        emit("robust", part="donate", **donate, tee_refusal=refusal,
             hard_violations=_hard_violations(sanitizer),
             card=results["card"])
        if not ok or not refused or _hard_violations(sanitizer):
            bad.append(f"donate: {donate}, tee: {refusal}")
        nnst600, ok = check_robust_nnst600(torch)
        emit("robust", part="nnst600_device", **nnst600,
             card=results["card"])
        if not ok:
            bad.append(f"NNST600 on the card: {nnst600}")
        clean, ok = check_robust_clean_lines(torch, labels, frames, total)
        emit("robust", part="sanitized_lines", lines=clean,
             card=results["card"])
        if not ok:
            bad.append(f"sanitized lines: {clean}")
    finally:
        sanitizer.enable(False)
        sanitizer.clear()
        lockwitness.reset()

    # (b) the armed watchdog without a fault, and the sanitizer, in turns
    def timed(extra, sanitize=False):
        def run(on):
            sanitizer.enable(sanitize and on)
            try:
                p, _, secs, p50, launches = _run_line(
                    _robust_line(labels, extra if on else ""), frames,
                    N_BATCHES)
            finally:
                sanitizer.enable(False)
                sanitizer.clear()
                lockwitness.reset()
            _add_launches(total, launches)
            p.stop()
            return {"fps": N_BATCHES * BATCH / secs,
                    "p50_batch_latency_ms": p50}
        return run

    wd = _turns(timed(f"invoke-timeout-ms={ROBUST_T_MS}"))
    emit("robust", part="watchdog_cost", turns=list(ROBUST_TURNS),
         batches=N_BATCHES, timeout_ms=ROBUST_T_MS, watchdog_on=wd["on"],
         watchdog_off=wd["off"], card=results["card"])
    san = _turns(timed("", sanitize=True))
    emit("robust", part="sanitizer_cost", turns=list(ROBUST_TURNS),
         batches=N_BATCHES, sanitizer_on=san["on"], sanitizer_off=san["off"],
         card=results["card"])
    ctl, ok = check_robust_ctl(results)
    emit("robust", part="ctl", **ctl, card=results["card"])
    if not ok:
        bad.append(f"ctl: {ctl}")
    results["robust_launches"] = total
    if bad:
        raise AssertionError(f"robust: {bad}")


# -- phase: mesh sharding and the replica pool ---------------------------------

#: the virtual devices of the phase: four mesh positions on the one card
MESH_DEVICES = "cuda:0*4"
#: the devices the validate CLI resolves the fixture files against
MESH_LINT_DEVICES = "cuda:0*8"
MESH_BATCHES = 4
MESH_TURNS = ("on", "off", "off", "on", "on", "off")


def _mesh_line(labels: str, extra: str = "", raw: bool = False) -> str:
    """The flagship at full width with ``extra`` on the filter; ``raw``
    leaves out the argmax and the decoder, so the sink receives the
    logits."""
    post = "" if raw else "postproc:argmax,"
    tail = ("" if raw else "! queue ! tensor_decoder mode=image_labeling "
            f"option1={labels} ")
    return (
        f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
        f"height={SIZE},framerate=1000/1 "
        f"! tensor_converter frames-per-tensor={BATCH} "
        "! tensor_filter name=f framework=jax model=mobilenet_v2 "
        f"custom=seed:0,{post}fused:pallas {extra} "
        f"{tail}! tensor_sink name=out")


def _mesh_logits(line, frames, n=MESH_BATCHES):
    """The raw line's logits of ``n`` batches pushed through to EOS (an
    upload window holds its last entry until EOS), its launches, and the
    pipeline (stopped by the caller)."""
    import numpy as np

    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    p = parse_launch(line)
    p.play()
    _cuda.reset_launches()
    for i in range(n * BATCH):
        p["src"].push_buffer(Buffer(tensors=[frames[i % len(frames)]],
                                    pts=i))
    p["src"].end_of_stream()
    if not p.bus.wait_eos(600) or p.bus.error is not None:
        raise RuntimeError(f"mesh line failed: {p.bus.error}")
    launches = dict(_cuda.LAUNCHES)
    outs = [np.asarray(b.tensors[0]) for b in p["out"].collected]
    return np.concatenate(outs), launches, p


def _mesh_compare(torch, name, got, want):
    """Labels equal on every frame, logits within the slice phase's
    tolerance (atol 0.15, rtol 0.05)."""
    g, w = torch.from_numpy(got), torch.from_numpy(want)
    labels_equal = bool((g.argmax(-1) == w.argmax(-1)).all())
    ok = g.shape == w.shape and within(g, w, 0.15, 0.05)
    out = {"labels_equal": labels_equal, "logits_ok": ok,
           "logits_max_abs_err": max_err(g, w),
           "distinct_labels": len(set(w.argmax(-1).tolist()))}
    if not (labels_equal and ok):
        raise AssertionError(f"mesh {name}: against the unsharded run {out}")
    return out


def _mesh_launches(name, launches, per_batch, n=MESH_BATCHES):
    want = {"fused_inverted_residual": kernel_blocks() * per_batch * n,
            "normalize_u8": per_batch * n}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"mesh {name}: launches {launches}, want {want}")


def _kernel_streams(prof, workdir) -> list:
    """The CUDA streams the fused-block kernels ran on, from the
    profiler's trace."""
    path = os.path.join(workdir, "mesh_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    return sorted({e.get("args", {}).get("stream") for e in events
                   if e.get("cat") == "kernel"
                   and "fused_ir" in e.get("name", "")} - {None})


def check_mesh(torch, results, workdir):
    """shard=dp|tp|dpxtp and replicas=4 over a mesh of virtual devices on
    the one card (NNSTPU_TORCH_DEVICES=cuda:0*4), at full width: (a) dp
    4x1 against unsharded (verdict, launches, labels and logits, frames/s
    and p50 in turns, a profile with the shards' streams); (b) tp 1x2 and
    dpxtp 2x2 (labels and logits, each position's weights against the
    analyzer's bill, memory_allocated back at its entry value after an
    invoke, the memory plan's cuda:0 row against max_memory_allocated);
    (c) the serving line behind replicas=4 against replicas off in turns,
    and serve-batches placed into a shard=dp filter; (d) the validate CLI
    on the shard, pool and threads fixture files over cuda:0*8; (e) the
    loop phase's graph-pool bills, when it ran in this call."""
    prev = os.environ.get("NNSTPU_TORCH_DEVICES")
    os.environ["NNSTPU_TORCH_DEVICES"] = MESH_DEVICES
    try:
        _check_mesh(torch, results, workdir)
    finally:
        if prev is None:
            os.environ.pop("NNSTPU_TORCH_DEVICES", None)
        else:
            os.environ["NNSTPU_TORCH_DEVICES"] = prev


def _check_mesh(torch, results, workdir):
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.analysis.memplan import plan_memory
    from nnstreamer_tpu_torch.analysis.shard import (
        analyze_shard,
        shard_billing,
    )
    from nnstreamer_tpu_torch.pipeline import parse_launch

    labels = os.path.join(workdir, "mesh_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    rng = np.random.default_rng(5)
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(BATCH)]
    card, total = results["card"], {}

    def verdict(line):
        p = parse_launch(line)
        return analyze_shard(p, p["f"]).code

    # (a) shard=dp mesh=4x1 against unsharded
    dp = "shard=dp mesh=4x1"
    base, launches, p = _mesh_logits(_mesh_line(labels, raw=True), frames)
    p.stop()
    _add_launches(total, launches)
    code = verdict(_mesh_line(labels, dp, raw=True))
    got, launches, p = _mesh_logits(_mesh_line(labels, dp, raw=True), frames)
    state = p["f"]._shard_state
    streams = [s.stream_id for s in p["f"].fw._mesh_streams]
    p.stop()
    _add_launches(total, launches)
    if code != "NNST470" or state != {"mode": "dp", "dp": 4, "tp": 1}:
        raise AssertionError(f"mesh dp: verdict {code}, installed {state}")
    _mesh_launches("dp", launches, 4)
    cmp_dp = _mesh_compare(torch, "dp", got, base)
    # feed-depth 2: each shard's rows upload onto its row as they arrive
    got, launches, p = _mesh_logits(
        _mesh_line(labels, dp + " feed-depth=2", raw=True), frames)
    prefetched = p["f"].fw._mesh_staging
    p.stop()
    _add_launches(total, launches)
    _mesh_launches("dp feed-depth=2", launches, 4)
    cmp_feed = _mesh_compare(torch, "dp feed-depth=2", got, base)
    if not all(ring is not None for ring in prefetched):
        raise AssertionError("mesh dp feed-depth=2: a row never prefetched")

    def timed(extra):
        def run(on):
            p, _, secs, p50, launches = _run_line(
                _mesh_line(labels, extra if on else ""), frames, N_BATCHES)
            if on and p["f"]._shard_state is None:
                raise AssertionError("mesh dp: the timed run is unsharded")
            p.stop()
            _add_launches(total, launches)
            return {"fps": N_BATCHES * BATCH / secs,
                    "p50_batch_latency_ms": p50}
        return run

    turns = _turns(timed(dp), MESH_TURNS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p, _, secs, _, launches = _run_line(_mesh_line(labels, dp), frames,
                                            MESH_BATCHES)
    p.stop()
    _add_launches(total, launches)
    stats = profile_stats(torch, prof, secs)
    kernel_streams = _kernel_streams(prof, workdir)
    emit("mesh", part="dp", mesh="4x1", devices=MESH_DEVICES, verdict=code,
         shard_state=state, rows_per_shard=BATCH // 4,
         launches_per_batch={k: v // MESH_BATCHES for k, v in
                             launches.items()},
         **cmp_dp, feed_depth_2=cmp_feed, sharded=turns["on"],
         unsharded=turns["off"],
         turns=list(MESH_TURNS), batches=N_BATCHES, card=card)
    emit("profile", line="mesh_dp_4x1", batches=MESH_BATCHES,
         shard_streams=streams, fused_block_streams=kernel_streams, **stats)
    if len(kernel_streams) < 4:
        raise AssertionError(f"mesh dp: the fused block ran on streams "
                             f"{kernel_streams}; the four shards each have "
                             f"their own")

    # (b) shard=tp mesh=1x2 and shard=dpxtp mesh=2x2
    x = np.stack(frames)
    for mode, mesh, rows in (("tp", "1x2", 1), ("dpxtp", "2x2", 2)):
        extra = f"shard={mode} mesh={mesh}"
        line = _mesh_line(labels, extra, raw=True)
        code = verdict(line)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        got, launches, p = _mesh_logits(line, frames)
        peak = torch.cuda.max_memory_allocated() - base_mem
        _add_launches(total, launches)
        f = p["f"]
        try:
            state = f._shard_state
            if code != "NNST470" or state is None or state["mode"] != mode:
                raise AssertionError(f"mesh {mode}: verdict {code}, "
                                     f"installed {state}")
            _mesh_launches(mode, launches, rows)
            cmp = _mesh_compare(torch, mode, got, base)
            bill = shard_billing(p, f)
            held = {f"{i},{j}": b
                    for (i, j), b in f.fw.mesh_param_bytes().items()}
            plan = plan_memory(p)
            planned = plan["per_device_bytes"]["cuda:0"]
            # memory_allocated after an invoke (its outputs dropped) is
            # what it was at the invoke's entry: nothing gathered stays
            f.fw.invoke([x])
            torch.cuda.synchronize()
            entry = torch.cuda.memory_allocated()
            outs = f.fw.invoke([x])
            torch.cuda.synchronize()
            del outs
            after = torch.cuda.memory_allocated()
        finally:
            p.stop()
        emit("mesh", part=mode, mesh=mesh, devices=MESH_DEVICES,
             verdict=code, shard_state=state, **cmp,
             param_bytes_per_position=held,
             billed_param_bytes_per_device=bill["param_bytes_per_device"],
             memory_allocated_entry=entry, memory_allocated_after=after,
             plan_cuda0_bytes=planned, max_memory_allocated=peak,
             plan_over_measured=planned / peak if peak else None, card=card)
        if set(held.values()) != {bill["param_bytes_per_device"]}:
            raise AssertionError(f"mesh {mode}: positions hold {held}, the "
                                 f"bill is {bill['param_bytes_per_device']}")
        if after != entry:
            raise AssertionError(f"mesh {mode}: memory_allocated {after} "
                                 f"after an invoke, {entry} at its entry")
        if planned < peak:
            raise AssertionError(f"mesh {mode}: the plan's cuda:0 row "
                                 f"{planned} is below the measured {peak}")

    # (c) serving: replicas=4 against off in turns, and sharded placement
    check_mesh_serving(torch, results, frames, labels, total)

    # (d) the validate CLI on the fixture files over cuda:0*8
    lint = _mesh_lint()
    emit("mesh", part="validate", devices=MESH_LINT_DEVICES, files=lint,
         card=card)

    # (e) the graph pool's bill (the loop phase asserts it on each line)
    emit("mesh", part="graph_pool",
         pools=results.get("graph_pool", "the loop phase did not run"),
         card=card)
    results["mesh_launches"] = total


def check_mesh_serving(torch, results, frames, labels, total):
    """The serving line at full width behind replicas=4 (NNST960, every
    replica takes a batch, every reply's label equal to replicas off,
    requests/s and p50/p99 in turns), then serve-batches placed into a
    shard=dp mesh=4x1 filter (one put per shard, the serversrc billing
    the upload with its per-device split, labels equal)."""
    from nnstreamer_tpu_torch.analysis.pool import analyze_pool
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch
    from nnstreamer_tpu_torch.serving import scheduler as sched_mod

    card = results["card"]
    decoder = f"tensor_decoder mode=image_labeling option1={labels} ! "
    clients = [(_serve_frames(frames, i), None) for i in range(SERVE_CLIENTS)]
    n_req = SERVE_CLIENTS * SERVE_PER_CLIENT
    pooled = _serve_line(server_extra="replicas=4 ")
    verdicts = [v.code for v in analyze_pool(parse_launch(pooled))]
    if verdicts != ["NNST960"]:
        raise AssertionError(f"mesh serve: pool verdicts {verdicts}")
    _run_serving(_serve_line(), clients[:1], SERVE_FRAME_CAPS, traced=False)
    _run_serving(pooled, clients[:1], SERVE_FRAME_CAPS, traced=False)

    def labels_of(res):
        """Each client's replies' labels by request pts: every client got
        exactly its own requests' replies, once each (a pool may answer
        a client's batches out of order)."""
        out = {}
        for i, r in res.items():
            got = {}
            for b in r["out"]:
                lab = b.meta["label"]
                got[b.pts] = lab[0] if isinstance(lab, list) else lab
            if sorted(got) != sorted(r["pushed"]) or \
                    len(r["out"]) != SERVE_PER_CLIENT:
                raise AssertionError(f"mesh serve: client {i} got pts "
                                     f"{sorted(got)[:5]}... for "
                                     f"{sorted(r['pushed'])[:5]}...")
            out[i] = got
        return out

    runs = {"on": [], "off": []}
    want = None
    for t in MESH_TURNS:
        seen = {}

        def inspect(server, tracer, seen=seen):
            src = _element(server, "tensor_query_serversrc")
            filt = _element(server, "tensor_filter")
            seen.update(pool=src._pool_state, replicas=filt._replica_state)

        _cuda.reset_launches()
        res, srv, secs, _ = _run_serving(
            pooled if t == "on" else _serve_line(), clients,
            SERVE_FRAME_CAPS, decoder=decoder, inspect=inspect)
        launches = dict(_cuda.LAUNCHES)
        _add_launches(total, launches)
        _serve_launches(f"mesh {t}", launches, srv["batches"])
        got = labels_of(res)
        if want is None and t == "off":
            want = got
        lat = _latencies_ms(res)
        run = {"requests_per_s": n_req / secs, "seconds": secs,
               "p50_request_ms": _pct(lat, 0.5),
               "p99_request_ms": _pct(lat, 0.99),
               "batches": srv["batches"], "labels": got}
        if t == "on":
            split = srv.get("per_replica") or {}
            run["per_replica"] = split
            if seen.get("pool") != {"replicas": 4} or sorted(split) != [
                    "0", "1", "2", "3"] or any(
                    v["batches"] < 1 for v in split.values()):
                raise AssertionError(f"mesh serve: pool {seen}, per-replica "
                                     f"batches {split}")
        runs[t].append(run)
    for run in runs["on"] + runs["off"]:
        if run.pop("labels") != want:
            raise AssertionError("mesh serve: a reply's label differs from "
                                 "the replicas=off run's")

    def summary(rs, key):
        vals = [r[key] for r in rs]
        return {"runs": vals, "median": statistics.median(vals),
                "spread": max(vals) - min(vals)}

    emit("mesh", part="serve_replicas", replicas=4, devices=MESH_DEVICES,
         verdict="NNST960", clients=SERVE_CLIENTS, requests=n_req,
         serve_batch=SERVE_BATCH, turns=list(MESH_TURNS),
         labels_equal_replicas_off=True,
         per_replica_batches=[r["per_replica"] for r in runs["on"]],
         replicas_rps=summary(runs["on"], "requests_per_s"),
         off_rps=summary(runs["off"], "requests_per_s"),
         replicas_p50_ms=summary(runs["on"], "p50_request_ms"),
         off_p50_ms=summary(runs["off"], "p50_request_ms"),
         replicas_p99_ms=summary(runs["on"], "p99_request_ms"),
         off_p99_ms=summary(runs["off"], "p99_request_ms"), card=card)

    # sharded serve-batch placement into a shard=dp mesh=4x1 filter
    puts = []
    orig = sched_mod.ServingScheduler._place_sharded

    def counted(self, parts, placement):
        arr, nb = orig(self, parts, placement)
        puts.append(len(arr) if isinstance(arr, sched_mod.ShardedBatch)
                    else 0)
        return arr, nb

    seen = {}

    def inspect(server, tracer):
        src = _element(server, "tensor_query_serversrc")
        filt = _element(server, "tensor_filter")
        cr = tracer.crossings()["per_element"]
        seen.update(placement=src._pool_placement is filt,
                    shard=filt._shard_state,
                    src=cr.get(src.name, {}), filt=cr.get(filt.name, {}))

    sched_mod.ServingScheduler._place_sharded = counted
    try:
        _cuda.reset_launches()
        res, srv, secs, _ = _run_serving(
            _serve_line(filter_extra="shard=dp mesh=4x1 "), clients,
            SERVE_FRAME_CAPS, decoder=decoder, inspect=inspect)
    finally:
        sched_mod.ServingScheduler._place_sharded = orig
    launches = dict(_cuda.LAUNCHES)
    _add_launches(total, launches)
    got = labels_of(res)
    src_cr, f_cr = seen["src"], seen["filt"]
    emit("mesh", part="serve_placement", mesh="4x1", devices=MESH_DEVICES,
         placement=seen["placement"], shard_state=seen["shard"],
         batches=srv["batches"], puts_per_batch=sorted(set(puts)),
         serversrc_crossings=src_cr, filter_crossings=f_cr,
         launches=launches, labels_equal_replicas_off=got == want,
         requests_per_s=n_req / secs, card=card)
    if not (seen["placement"] and seen["shard"] == {"mode": "dp", "dp": 4,
                                                    "tp": 1}
            and puts == [4] * srv["batches"] and got == want
            and src_cr.get("h2d") == srv["batches"]
            and src_cr.get("h2d_bytes_per_device", 0) * 4
            == src_cr.get("h2d_bytes")
            and not f_cr.get("h2d")
            and launches.get("fused_inverted_residual")
            == kernel_blocks() * 4 * srv["batches"]):
        raise AssertionError(f"mesh serve placement: {seen}, puts {puts}, "
                             f"launches {launches}")


def _mesh_lint() -> dict:
    """``validate --strict`` (with ``--cost`` where the file asks) on the
    shard, pool and threads fixture files over MESH_LINT_DEVICES: each
    file fails, every EXPECT code appears, and the eligible line alone is
    strict-clean."""
    import contextlib
    import io
    import re

    from nnstreamer_tpu_torch.tools import validate

    prev = os.environ.get("NNSTPU_TORCH_DEVICES")
    os.environ["NNSTPU_TORCH_DEVICES"] = MESH_LINT_DEVICES
    out = {}
    try:
        for name, eligible in (("launch_lines_shard.txt", "NNST470"),
                               ("launch_lines_pool.txt", "NNST960"),
                               ("launch_lines_threads.txt", "NNST620")):
            path = os.path.join(ROOT, "examples", name)
            with open(path) as f:
                text = f.read()
            cost = ["--cost"] if "# ANALYZE: cost" in text else []
            expects = [c for m in re.findall(r"# EXPECT: (\S+)", text)
                       for c in m.split(",")]
            lines = re.findall(rf"# EXPECT: {eligible}\n([^#\n][^\n]*)", text)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = validate.main(["--strict", "--verbose", *cost,
                                    "--file", path])
            with contextlib.redirect_stdout(io.StringIO()):
                rc_eligible = validate.main(["--strict", *cost, lines[0]])
            found = set(re.findall(r"NNST\d{3}", buf.getvalue()))
            missing = sorted(set(expects) - found)
            out[name] = {"rc": rc, "eligible_rc": rc_eligible,
                         "expected": sorted(set(expects)),
                         "missing": missing}
            if rc != 2 or rc_eligible != 0 or missing or len(lines) != 1:
                raise AssertionError(f"mesh validate {name}: {out[name]}")
    finally:
        if prev is None:
            os.environ.pop("NNSTPU_TORCH_DEVICES", None)
        else:
            os.environ["NNSTPU_TORCH_DEVICES"] = prev
    return out


# -- phase: the autotuner --------------------------------------------------

#: the measured search (phase tune, part c): the flagship at 32 frames a
#: tensor over feed-depth x fetch-window (batch-size > 1 would stack a
#: fifth axis the port's MobileNet-v2 refuses: NNST853), the top 3
#: measured 3 times each over 1024 frames
TUNE_MEASURED = {"fpt": 32, "space": {"feed_depth": [1, 2, 4],
                                     "fetch_window": [1, 4]},
                 "top_k": 3, "repeats": 3, "n_frames": 1024}
#: host constants: invokes timed, flushes timed
TUNE_CALIBRATE = {"invokes": 30, "flushes": 30}


def _tune_line(labels: str, fpt: int = 0) -> str:
    return _flag_line(labels, fpt=fpt or BATCH)


def _calibrate_host(torch, labels, frames) -> dict:
    """The card's two host constants of the tuner's objective: one
    launch's host dispatch through the port's filter (the backend's
    invoke on a frame batch already on the card, timed on the host clock
    without waiting for the device, the device idle before each), and one
    fetch-window flush's sync (``materialize_tensors`` of FETCH_WINDOW
    finished invokes' outputs, the device idle: the flush's own cost)."""
    import numpy as np

    from nnstreamer_tpu_torch.buffer import materialize_tensors

    _, _, _, p = _drive(_tune_line(labels), frames, 2)
    fw = p["f"].fw
    x = torch.from_numpy(np.stack(frames[:BATCH])).cuda()
    dispatch, flush = [], []
    for _ in range(3):
        fw.invoke([x])  # warm
    for _ in range(TUNE_CALIBRATE["invokes"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fw.invoke([x])
        dispatch.append((time.perf_counter() - t0) * 1e3)
    for _ in range(TUNE_CALIBRATE["flushes"]):
        outs = [o for _ in range(FETCH_WINDOW) for o in fw.invoke([x])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        materialize_tensors(outs)
        flush.append((time.perf_counter() - t0) * 1e3)
    p.stop()
    return {"dispatch_ms_per_launch": statistics.median(dispatch),
            "sync_ms_per_flush": statistics.median(flush),
            "dispatch_ms_spread": [min(dispatch), max(dispatch)],
            "sync_ms_spread": [min(flush), max(flush)],
            "batch": BATCH, "fetch_window": FETCH_WINDOW}


def _labels_with_point(line, point, frames, n_batches: int):
    """The labels a line gives with a tuner point applied, one entry a
    buffer."""
    from nnstreamer_tpu_torch.analysis.tuner import apply_point
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.pipeline import parse_launch

    p = parse_launch(line)
    apply_point(p, point)
    p.play()
    for i in range(n_batches * BATCH):
        p["src"].push_buffer(Buffer(tensors=[frames[i % len(frames)]], pts=i))
    p["src"].end_of_stream()
    if not p.bus.wait_eos(600) or p.bus.error is not None:
        raise RuntimeError(f"tuned line failed: {p.bus.error}")
    labels = [b.meta["label"] for b in p["out"].collected]
    p.stop()
    return labels


def check_tune(torch, results, workdir):
    """The autotuner on the card: (a) the static search of the flagship
    line over its whole space (counts by fate and prune code, the chosen
    config, seconds; the accounting invariant); (b) the card's host
    constants (one launch's dispatch, one flush's sync); (c) tune_report with measurement on over
    TUNE_MEASURED's space with the card's constants, every measured point
    launching the fused block and normalize_u8 (predicted and measured
    orderings, static_choice_confirmed: a finding, not a gate); (d) the
    chosen config, and the static choice where it differs, against the
    baseline on the same frames, labels equal; (e)
    ``python -m nnstreamer_tpu_torch.tools.validate --tune --json`` on the
    flagship in a subprocess (the measured phase off by
    NNSTPU_TUNE_MEASURE=0): exit 0 and one JSON document, (a)'s report to
    the byte and its signature, so two runs of the static search agree;
    (f) the cost
    method ``compiled`` of MobileNet-v2 at batch 128 against the meta
    method's flops (within 25%), its peak beside max_memory_allocated."""
    import numpy as np

    from nnstreamer_tpu_torch.analysis import tuner
    from nnstreamer_tpu_torch.analysis.costmodel import (
        ShapeDtype,
        composition,
        meta_composition,
        program_cost,
    )
    from nnstreamer_tpu_torch.ops import _cuda

    card = results["card"]
    labels = os.path.join(workdir, "tune_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    rng = np.random.default_rng(9)
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(BATCH)]
    line = _tune_line(labels)

    # (a) the static search (its second run, the CLI's in (e), must give
    # the same signature and report)
    t0 = time.perf_counter()
    rep = tuner.tune_report(line, measure=False)
    secs = [time.perf_counter() - t0]
    c = rep["counts"]
    static_ok = (c["pruned"] + c["evaluated"] + c["validated"]
                 == c["enumerated"] == len(rep["points"]) > 0)
    emit("tune", part="static", enumerated=c["enumerated"],
         pruned=c["pruned"], pruned_by_code=rep["pruned_by_code"],
         survivors=c["evaluated"] + c["validated"],
         space={k: len(v) for k, v in rep["space"].items()},
         chosen=rep.get("chosen", {}).get("launch_fragment"),
         predicted=rep.get("chosen", {}).get("predicted"),
         headroom_pct=rep.get("headroom_pct"), seconds=secs,
         signature=rep["signature"]["digest"], ok=static_ok, card=card)
    if not static_ok:
        raise AssertionError(f"tune static: {c}")

    # (b) the card's host constants
    consts = _calibrate_host(torch, labels, frames)
    emit("tune", part="constants", **consts,
         reference_defaults={k: tuner.TUNE_CONSTANTS[k] for k in (
             "dispatch_ms_per_launch", "sync_ms_per_flush")}, card=card)
    constants = {k: consts[k] for k in ("dispatch_ms_per_launch",
                                        "sync_ms_per_flush")}

    # (c) the measured search over the reduced space
    total, per_point = {}, []

    def measure(launch, point, n_frames):
        _cuda.reset_launches()
        got = tuner.measure_launch(launch, point, n_frames,
                                   repeats=TUNE_MEASURED["repeats"])
        launches = dict(_cuda.LAUNCHES)
        _add_launches(total, launches)
        per_point.append({"config": dict(point), "launches": launches})
        return got

    mline = _tune_line(labels, TUNE_MEASURED["fpt"])
    t0 = time.perf_counter()
    mrep = tuner.tune_report(mline, top_k=TUNE_MEASURED["top_k"],
                             space=TUNE_MEASURED["space"],
                             constants=constants, measure=measure,
                             n_frames=TUNE_MEASURED["n_frames"])
    msecs = time.perf_counter() - t0
    ranked = sorted((e for e in mrep["points"] if "rank" in e),
                    key=lambda e: e["rank"])
    measured = [e for e in ranked if "measured" in e]
    launched = all(pp["launches"]["fused_inverted_residual"] > 0
                   and pp["launches"]["normalize_u8"] > 0
                   for pp in per_point)
    mc = mrep["counts"]
    emit("tune", part="measured", line_fpt=TUNE_MEASURED["fpt"],
         space=TUNE_MEASURED["space"], counts=mc, constants=constants,
         predicted_order=[tuner.config_fragment(e["config"])
                          for e in ranked],
         predicted_fps=[e["predicted"]["modeled_fps"] for e in ranked],
         measured_order=[tuner.config_fragment(e["config"]) for e in sorted(
             measured, key=lambda e: -e["measured"]["fps"])],
         measured_fps={tuner.config_fragment(e["config"]):
                       e["measured"]["fps"] for e in measured},
         chosen=mrep.get("chosen", {}).get("launch_fragment"),
         static_choice_confirmed=mrep.get("chosen", {}).get(
             "static_choice_confirmed"),
         launches=per_point, seconds=msecs, card=card)
    if (len(measured) != min(TUNE_MEASURED["top_k"], len(ranked))
            or not mrep["measure"]["ran"] or not launched
            or mc["pruned"] + mc["evaluated"] + mc["validated"]
            != mc["enumerated"]):
        raise AssertionError(f"tune measured: {mc}, {per_point}")

    # (d) the chosen config, and the static choice where the measured
    # one differs from it, against the baseline on the same frames
    chosen = mrep["chosen"]["config"]
    base = mrep["baseline"]["config"]
    tried = [chosen] + [e["config"] for e in ranked[:1]
                        if e["config"] != chosen]
    _cuda.reset_launches()
    want = _labels_with_point(mline, base, frames, 2)
    got = [_labels_with_point(mline, pt, frames, 2) for pt in tried]
    _add_launches(total, dict(_cuda.LAUNCHES))
    n_buffers = 2 * BATCH // TUNE_MEASURED["fpt"]
    same = len(want) == n_buffers and all(g == want for g in got)
    emit("tune", part="chosen_vs_baseline", configs=tried, baseline=base,
         frames=2 * BATCH, buffers=len(want), labels_equal=same,
         labels_differ=[sum(a != b for a, b in zip(g, want)) for g in got],
         card=card)
    if not same:
        raise AssertionError(f"tune: {tried} and the baseline {base} "
                             "label the frames differently")

    # (e) the CLI in a subprocess
    env = dict(os.environ, NNSTPU_TUNE_MEASURE="0")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.tools.validate",
         "--tune", "--json", line], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    cli_secs = time.perf_counter() - t0
    try:
        doc = json.loads(proc.stdout)
    except ValueError:
        doc = None
    # the second run of the static search: the same signature and the
    # same whole report as (a)'s
    same_sig = doc is not None and doc["signature"] == rep["signature"]
    same_report = doc is not None and doc == json.loads(
        json.dumps(rep, sort_keys=True))
    cli_ok = proc.returncode == 0 and same_sig and same_report
    emit("tune", part="cli", rc=proc.returncode, seconds=cli_secs,
         parsed=doc is not None, same_signature_as_a=same_sig,
         same_report_as_a=same_report, stderr_tail=proc.stderr[-400:],
         card=card)
    if not cli_ok:
        raise AssertionError(f"validate --tune: rc {proc.returncode}, "
                             f"{proc.stderr[-2000:]}")

    # (f) the compiled cost of MobileNet-v2 at batch 128
    custom = {"seed": "0", "fused": "pallas"}
    shapes = [ShapeDtype((BATCH, SIZE, SIZE, 3), np.dtype(np.uint8))]
    fn, module, _ = meta_composition("mobilenet_v2", custom)
    meta = program_cost(fn, module, shapes)
    fn, module, _ = composition("mobilenet_v2", custom, device="cuda")
    torch.cuda.synchronize()
    base_alloc = torch.cuda.memory_allocated()
    compiled = program_cost(fn, module, shapes, method="compiled")
    peak_alloc = torch.cuda.max_memory_allocated()
    rel = abs(compiled["flops"] - meta["flops"]) / meta["flops"]
    del fn, module
    emit("tune", part="compiled_cost", batch=BATCH,
         flops_compiled=compiled["flops"], flops_meta=meta["flops"],
         flops_rel_diff=rel, kernel_launches=compiled["kernel_launches"],
         peak_live_bytes=compiled["peak_live_bytes"],
         max_memory_allocated=peak_alloc,
         memory_allocated_at_entry=base_alloc,
         hbm_bytes_accessed=compiled["hbm_bytes"],
         meta_peak_live_bytes=meta["peak_live_bytes"], card=card)
    if rel >= 0.25 or compiled["kernel_launches"] == 0:
        raise AssertionError(f"compiled cost: {compiled['flops']} against "
                             f"meta {meta['flops']}")
    results["tune_launches"] = total


# -- phase: the compile cache (filters/aot.py) --------------------------------

#: batches each play of the aot and rollout phases pushes
AOT_BATCHES = 2
#: the order of the timed open turns of the aot phase
AOT_TURNS = ("aot0", "hit", "hit", "aot0", "aot0", "hit", "hit", "aot0")
#: the rollout canary's window (frames = the filter's input buffers)
ROLLOUT_CANARY = 64


def _aot_custom(extra: str = "") -> str:
    return f"seed:0,postproc:argmax,fused:pallas,aot:1{extra}"


def _aot_cascade_line(labels: str, aot: str = "1") -> str:
    """Line K (the cascade of the chain phase) with the head's cache
    gate ``aot``."""
    return _cascade_line(labels).replace(
        "custom=seed:0,fused:pallas", f"custom=seed:0,fused:pallas,aot:{aot}")


def _aot_play(torch, line, frames, n_batches=AOT_BATCHES, name="f",
              logits=True):
    """Parse and play ``line``, push ``n_batches`` batches and EOS: the
    labels, the launches of the run, the ms from the parse to the end of
    ``play()`` (the filter's open) and to the first output, the tracer's
    aot section of ``name`` and, with ``logits``, the model logits of the
    program the filter ran (the loaded entry's or the in-process build's)
    on the first batch, computed after the launches were read."""
    import numpy as np

    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    torch.cuda.synchronize()
    _cuda.reset_launches()
    first = []
    t0 = time.perf_counter()
    p = parse_launch(line)
    tracer = trace.attach(p)
    p["out"].connect_new_data(
        lambda b: first.append(time.perf_counter()) if not first else None)
    p.play()
    t_play = time.perf_counter()
    for i in range(n_batches * BATCH):
        p["src"].push_buffer(Buffer(tensors=[frames[i % len(frames)]], pts=i))
    p["src"].end_of_stream()
    if not p.bus.wait_eos(600) or p.bus.error is not None:
        raise RuntimeError(f"aot play failed: {p.bus.error}")
    t_end = time.perf_counter()
    launches = dict(_cuda.LAUNCHES)
    out = [lab for b in p["out"].collected for lab in b.meta["label"]]
    fw = p[name].fw
    r = {"labels": out, "launches": launches,
         "open_ms": (t_play - t0) * 1e3, "first_ms": (first[0] - t0) * 1e3,
         "seconds": t_end - t0,
         "aot": (tracer.report().get("aot") or {}).get(name, {}),
         "builds": fw.compile_stats()["jit_traces"],
         "from_cache": any(fw._aot_tried.values()),
         "loop_state": p[name]._loop_state,
         "loop_refused": p[name]._loop_refused}
    if logits:
        x = torch.from_numpy(np.stack(frames[:BATCH])).cuda()
        with torch.inference_mode():
            r["logits"] = fw._bundle.apply_fn(x).float().cpu()
    p.stop()
    return r


def _aot_outcomes(r) -> list:
    return [e["outcome"] for e in r["aot"].get("events", [])]


def _aot_check(name, r, outcomes, per_batch, n=AOT_BATCHES):
    got = _aot_outcomes(r)
    if got != outcomes:
        raise AssertionError(f"aot {name}: outcomes {got}, want {outcomes}")
    for k, v in per_batch.items():
        if r["launches"].get(k, 0) != v * n:
            raise AssertionError(f"aot {name}: {r['launches']}, want "
                                 f"{per_batch} per batch")


def _aot_summary(r) -> dict:
    ev = r["aot"].get("events", [])
    return {"open_ms": r["open_ms"], "first_ms": r["first_ms"],
            "outcomes": [e["outcome"] for e in ev],
            "compile_ms": sum(e["compile_ms"] for e in ev),
            "load_ms": sum(e["load_ms"] for e in ev),
            "launches": r["launches"], "builds": r["builds"]}


def _add_into(total, launches) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _spawn(args, env):
    """Start ``python -m <args>`` from the checkout's root (a child that
    runs beside the caller's work: each costs seconds to start)."""
    return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _collect(proc, timeout=300):
    """(rc, stdout, stderr) of a :func:`_spawn` child; kills it at the
    timeout."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


def _aot_lint_fixture():
    """The fixture's lines and their EXPECT codes."""
    path = os.path.join(ROOT, "examples", "launch_lines_aot.txt")
    lines, expects, expect = [], [], None
    with open(path) as f:
        for raw in f:
            s = raw.strip()
            if s.startswith("# EXPECT:"):
                expect = s.split(":", 1)[1].strip().split(",")
            elif s and not s.startswith("#"):
                lines.append(s)
                expects.append(expect)
                expect = None
    return path, lines, expects


def _aot_lint(env, cold) -> dict:
    """validate --aot over examples/launch_lines_aot.txt (``cold``: the
    child started on a cold cache at the phase's start): each line's
    codes hold its EXPECT; then the WARM line played once in this
    process, linted twice warm in two children side by side:
    strict-clean, byte-identical."""
    path, lines, expects = _aot_lint_fixture()
    rc, out, err = _collect(cold)
    doc = json.loads(out)
    codes = [sorted({d["code"] for d in r["diagnostics"]})
             for r in doc["results"]]
    missing = [(i, e) for i, (e, c) in enumerate(zip(expects, codes))
               if e is not None and not set(e) <= set(c)]
    if missing or len(codes) != len(lines):
        raise AssertionError(f"validate --aot: EXPECT missing {missing} in "
                             f"{codes}")
    # the WARM line: one play on the card warms its entry
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.pipeline import parse_launch

    import numpy as np

    warm = lines[0]
    p = parse_launch(warm.replace("! tensor_sink", "! tensor_sink name=out")
                     .replace("appsrc ", "appsrc name=src ", 1))
    p.play()
    p["src"].push_buffer(Buffer(tensors=[np.zeros((2, 4), np.float32)]))
    p["src"].end_of_stream()
    if not p.bus.wait_eos(120):
        raise RuntimeError("the WARM line did not reach EOS")
    p.stop()
    t0 = time.perf_counter()
    runs = [_collect(p) for p in [
        _spawn(["nnstreamer_tpu_torch.tools.validate", "--aot", "--strict",
                "--verbose", warm], env) for _ in range(2)]]
    warm_s = time.perf_counter() - t0
    if runs[0][0] != 0 or runs[0][1] != runs[1][1] \
            or "1/1 predicted warm" not in runs[0][1]:
        raise AssertionError(f"warm lint: rc {runs[0][0]}, "
                             f"{runs[0][1][-800:]}{runs[0][2][-800:]}")
    return {"lines": len(lines), "codes": codes, "cold_rc": rc,
            "warm_rc": runs[0][0], "warm_byte_identical": True,
            "warm_lints_s": warm_s}


def check_aot(torch, results, workdir):
    """The compile cache on the card: the flagship with ``aot:1`` over a
    fresh cache (a miss whose worker child builds on the card, then a
    hit), its logits bit-equal to an ``aot:0`` play, 17 fused-block and 1
    normalize_u8 launches a batch in each play; the preamble-fused
    flagship and line K with entries of their own, each a hit on its
    second play; a loop-window=4 flagship keyed apart from the solo
    entry; a corrupted entry quarantined and recompiled; a budget below
    the entry's hbm_bytes refused, the play still on the kernels;
    ``validate --aot`` over examples/launch_lines_aot.txt."""
    import numpy as np

    from nnstreamer_tpu_torch.filters import aot
    from nnstreamer_tpu_torch.filters.cuda_filter import TorchCudaFilter

    labels, frames = _phase_frames(torch, results, workdir)
    card = results["card"]
    old = os.environ.get("NNSTPU_AOT_CACHE")
    # validate --aot over the fixture on a cold cache of its own, in a
    # child that runs beside the plays
    lint_env = dict(os.environ, NNSTPU_AOT_CACHE=os.path.join(workdir,
                                                              "aot-lint"))
    cold_lint = _spawn(["nnstreamer_tpu_torch.tools.validate", "--aot",
                        "--json", "--file", _aot_lint_fixture()[0]],
                       lint_env)
    os.environ["NNSTPU_AOT_CACHE"] = os.path.join(workdir, "aot")
    total: dict = {}
    try:
        solo = _labeling_line(labels, "mobilenet_v2", _aot_custom())
        r0 = _aot_play(torch, solo.replace("aot:1", "aot:0"), frames)
        miss = _aot_play(torch, solo, frames)
        worker = dict(aot.LAST_WORKER)
        hit = _aot_play(torch, solo, frames)
        per = {"fused_inverted_residual": kernel_blocks(), "normalize_u8": 1}
        _aot_check("aot:0", r0, [], per)
        _aot_check("miss", miss, ["miss-compiled"], per)
        _aot_check("hit", hit, ["hit"], per)
        for r in (miss, hit):
            if r["labels"] != r0["labels"] or r["builds"] != 0 \
                    or not r["from_cache"]:
                raise AssertionError("aot: the cached program's labels or "
                                     "builds differ from aot:0's")
            if not torch.equal(r["logits"], r0["logits"]):
                raise AssertionError(
                    "aot: logits not bit-equal to aot:0's (max abs "
                    f"{max_err(r['logits'], r0['logits'])})")
        for r in (r0, miss, hit):
            _add_into(total, r["launches"])
        emit("aot", part="flagship", aot0=_aot_summary(r0),
             miss=_aot_summary(miss), hit=_aot_summary(hit), worker=worker,
             logits_bit_equal=True, batches=AOT_BATCHES, card=card)
        # the open and first-output ms in turns (aot:0 hit hit aot:0 x2):
        # the first plays above also paid the process's first cuDNN and
        # allocator warm-up, which the turns do not
        turns = {"aot0": [], "hit": []}
        for mode in AOT_TURNS:
            r = _aot_play(torch, solo if mode == "hit" else
                          solo.replace("aot:1", "aot:0"), frames,
                          logits=False)
            _aot_check(f"turn {mode}", r, ["hit"] if mode == "hit" else [],
                       per)
            if r["labels"] != r0["labels"]:
                raise AssertionError(f"aot turn {mode}: labels differ")
            _add_into(total, r["launches"])
            turns[mode].append((r["open_ms"], r["first_ms"]))
        emit("aot", part="turns", order=list(AOT_TURNS),
             open_ms={k: [o for o, _ in v] for k, v in turns.items()},
             first_ms={k: [f for _, f in v] for k, v in turns.items()},
             card=card)

        # the preamble-fused flagship and line K: entries of their own
        pre = _preamble_line(labels).replace(
            "custom=seed:0,postproc:argmax,fused:pallas",
            f"custom={_aot_custom()}")
        pre_runs = [_aot_play(torch, pre, frames, logits=False)
                    for _ in range(2)]
        per_pre = {"fused_inverted_residual": kernel_blocks(), "normalize_u8": 0,
                   "arith_chain": 1}
        _aot_check("preamble miss", pre_runs[0], ["miss-compiled"], per_pre)
        _aot_check("preamble hit", pre_runs[1], ["hit"], per_pre)
        k_runs = [_aot_play(torch, _aot_cascade_line(labels, a), frames,
                            name="m", logits=False) for a in ("0", "1", "1")]
        per_k = {"fused_inverted_residual": kernel_blocks(), "normalize_u8": 1,
                 "arith_chain": 1}
        _aot_check("line K aot:0", k_runs[0], [], per_k)
        _aot_check("line K miss", k_runs[1], ["miss-compiled"], per_k)
        _aot_check("line K hit", k_runs[2], ["hit"], per_k)
        if any(r["labels"] != r0["labels"] for r in pre_runs) or any(
                r["labels"] != k_runs[0]["labels"] for r in k_runs[1:]):
            raise AssertionError("aot: preamble or line K labels differ")
        for r in pre_runs + k_runs:
            _add_into(total, r["launches"])
        # the loop-window=4 flagship keys apart from the solo entry
        loop = _aot_play(torch, _loop_line_b(
            labels, "loop-window=4 launch-depth=2").replace(
                "custom=seed:0,postproc:argmax,fused:pallas",
                f"custom={_aot_custom()}"), frames, logits=False)
        ev = loop["aot"].get("events", [])
        if _aot_outcomes(loop) != ["miss-compiled"] or \
                ev[0]["spec"].get("loop_window") != 4 or \
                loop["labels"] != r0["labels"]:
            raise AssertionError(f"aot loop: {_aot_outcomes(loop)} "
                                 f"{ev[:1]} {loop['loop_state']} "
                                 f"{loop['loop_refused']}")
        _add_into(total, loop["launches"])
        keys = {e["key"] for r in (miss, pre_runs[0], k_runs[1], loop)
                for e in r["aot"]["events"]}
        emit("aot", part="entries", preamble=[_aot_summary(r)
                                             for r in pre_runs],
             line_k=[_aot_summary(r) for r in k_runs],
             loop=_aot_summary(loop), distinct_keys=len(keys),
             entries=len(aot.cache_entries()),
             entry_bytes=[r["size"] for r in aot.cache_entries()],
             card=card)
        if len(keys) != 4:
            raise AssertionError(f"aot: {len(keys)} distinct keys, want 4")

        # a corrupted entry is quarantined, then recompiled
        row = next(r for r in aot.cache_entries()
                   if r["custom"] == _aot_custom() and not r["spec"]
                   and r["shapes"] == [[[BATCH, SIZE, SIZE, 3], "uint8"]])
        with open(row["path"], "wb") as f:
            f.write(b"damaged")
        bad = _aot_play(torch, solo, frames, logits=False)
        _aot_check("quarantine", bad, ["miss-compiled"], per)
        if aot.quarantined_entries() != [row["file"]]:
            raise AssertionError(f"aot: quarantine "
                                 f"{aot.quarantined_entries()}")
        # a budget below the entry's footprint: refused, built in process
        hbm = aot.entry_meta(row["path"])["hbm_bytes"]
        real = TorchCudaFilter._aot_budget
        TorchCudaFilter._aot_budget = lambda self, n=1: hbm - 1
        try:
            refused = _aot_play(torch, solo, frames, logits=False)
        finally:
            TorchCudaFilter._aot_budget = real
        _aot_check("refused", refused, ["refused-budget"], per)
        if refused["labels"] != r0["labels"] or refused["builds"] != 1:
            raise AssertionError("aot: the refused play's labels differ")
        for r in (bad, refused):
            _add_into(total, r["launches"])
        emit("aot", part="housekeeping", quarantine=_aot_summary(bad),
             quarantined=aot.quarantined_entries(), hbm_bytes=hbm,
             refused=_aot_summary(refused), card=card)

        # validate --aot over the fixture
        os.environ["NNSTPU_AOT_CACHE"] = lint_env["NNSTPU_AOT_CACHE"]
        lint = _aot_lint(lint_env, cold_lint)
        emit("aot", part="validate", **lint, card=card)
        os.environ["NNSTPU_AOT_CACHE"] = os.path.join(workdir, "aot")
        emit("aot", part="report", aot_report=miss["aot"],
             hit_report=hit["aot"], card=card)
    finally:
        if cold_lint.poll() is None:
            cold_lint.kill()
            cold_lint.communicate()
        if old is None:
            os.environ.pop("NNSTPU_AOT_CACHE", None)
        else:
            os.environ["NNSTPU_AOT_CACHE"] = old
    results["aot_launches"] = total


def _phase_frames(torch, results, workdir):
    """The flagship's labels file and frames: the slice phase's when it
    ran, else made here as it makes them."""
    import numpy as np

    if "flag_frames" in results:
        return results["flag_labels"], results["flag_frames"]
    labels = os.path.join(workdir, "labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    rng = np.random.default_rng(0)
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(BATCH)]
    return labels, frames


# -- phase: safe rollout --------------------------------------------------------

def _rollout_line(labels: str, model: str, extra: str = "") -> str:
    """The flagship on checkpoint ``model`` with the cache on, each
    output emitted as its invoke returns (no fetch window)."""
    return _labeling_line(
        labels, model, "arch:mobilenet_v2,postproc:argmax,fused:pallas,aot:1"
    ).replace(f"fetch-window={FETCH_WINDOW} ", f"{extra} ")


def _rollout_run(torch, labels, frames, a, b, n_after, fault=False):
    """Open the flagship on checkpoint ``a``, push 2 batches, send a
    ``rollout-model`` event naming ``b`` (``fault``: B's first invoke
    raises through testing/faults.py), push ``n_after`` batches, EOS.
    Returns the labels per batch, the launches, the tracer report."""
    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.buffer import Buffer, Event
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch
    from nnstreamer_tpu_torch.testing import faults

    p = parse_launch(_rollout_line(
        labels, a, f"rollout-canary-frames={ROLLOUT_CANARY}"))
    tracer = trace.attach(p)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    p.play()

    def push(k0, n):
        for i in range(k0 * BATCH, (k0 + n) * BATCH):
            p["src"].push_buffer(Buffer(tensors=[frames[i % len(frames)]],
                                        pts=i))

    push(0, 2)
    _wait_for(lambda: [len(p["out"].collected)], 2, p, "rollout")
    if fault:
        faults.install("invoke-raise", times=1, match="f")
    t0 = time.perf_counter()
    p["f"].sink_pad.receive_event(Event("rollout-model", {"model": b}))
    event_s = time.perf_counter() - t0
    try:
        push(2, n_after)
        p["src"].end_of_stream()
        if not p.bus.wait_eos(600) or p.bus.error is not None:
            raise RuntimeError(f"rollout line failed: {p.bus.error}")
    finally:
        faults.clear()
    launches = dict(_cuda.LAUNCHES)
    out = [b.meta["label"] for b in p["out"].collected]
    rep = tracer.report()
    p.stop()
    return out, launches, rep, event_s


def check_rollout(torch, results, workdir):
    """Safe rollout on the card: the flagship on checkpoint A (seed 0,
    ``models.save_state``) with ``aot:1``; a ``rollout-model`` event moves
    it to B (seed 1). A clean B is promoted after a 64-frame canary and
    then labels as a line opened on B; a B whose first invoke faults
    rolls back to A, whose reload is a compile-cache hit, and then labels
    as A."""
    from nnstreamer_tpu_torch.models import build_bundle, save_state

    labels, frames = _phase_frames(torch, results, workdir)
    card = results["card"]
    ckpt = {}
    for tag, seed in (("a", 0), ("b", 1)):
        bundle = build_bundle("mobilenet_v2",
                              {"seed": str(seed), "fused": "pallas"}, "cuda")
        ckpt[tag] = os.path.join(workdir, f"mbv2_{tag}.npz")
        save_state(bundle.module.state_dict(), ckpt[tag])
        del bundle
    old = os.environ.get("NNSTPU_AOT_CACHE")
    os.environ["NNSTPU_AOT_CACHE"] = os.path.join(workdir, "aot-rollout")
    total: dict = {}
    try:
        want = {}
        for tag in ("a", "b"):
            r = _aot_play(torch, _rollout_line(labels, ckpt[tag]), frames,
                          logits=False)
            _add_into(total, r["launches"])
            want[tag] = r["labels"][:BATCH]
        if want["a"] == want["b"]:
            raise AssertionError("rollout: checkpoints A and B label alike")
        n_after = ROLLOUT_CANARY + 2
        out, launches, rep, flip_s = _rollout_run(
            torch, labels, frames, ckpt["a"], ckpt["b"], n_after)
        _add_into(total, launches)
        ro = rep["rollout"]["f"]
        started = [e for e in ro["events"] if e["decision"] == "started"][0]
        if (ro["promoted"], ro["rolled_back"]) != (1, 0) or \
                out[-1] != want["b"] or out[0] != want["a"]:
            raise AssertionError(f"rollout: clean B {ro}")
        per = launches.get("fused_inverted_residual", 0) / kernel_blocks()
        if per != len(out) or launches.get("normalize_u8") != len(out):
            raise AssertionError(f"rollout: launches {launches} for "
                                 f"{len(out)} batches")
        emit("rollout", part="promote", batches=len(out),
             canary_frames=ROLLOUT_CANARY, flip_ms=started["flip_ms"],
             event_ms=flip_s * 1e3, decisions=[e["decision"]
                                               for e in ro["events"]],
             aot=[(e["outcome"], e["compile_ms"], e["load_ms"])
                  for e in rep["aot"]["f"]["events"]],
             launches=launches, labels_equal_b=True, card=card)
        out, launches, rep, _ = _rollout_run(
            torch, labels, frames, ckpt["a"], ckpt["b"], 4, fault=True)
        _add_into(total, launches)
        ro = rep["rollout"]["f"]
        rb = [e for e in ro["events"] if e["decision"] == "rolled-back"]
        outcomes = [e["outcome"] for e in rep["aot"]["f"]["events"]]
        if not rb or ro["promoted"] or outcomes[-1] != "hit" or \
                out[-1] != want["a"]:
            raise AssertionError(f"rollout: faulted B {ro} {outcomes}")
        emit("rollout", part="rollback", batches=len(out),
             rollback_ms=rb[0]["rollback_ms"], reason=rb[0]["reason"],
             frames_used=rb[0]["frames_used"], aot=outcomes,
             launches=launches, labels_equal_a=True, card=card)
        emit("rollout", part="report", rollout_report=rep["rollout"],
             card=card)
    finally:
        if old is None:
            os.environ.pop("NNSTPU_AOT_CACHE", None)
        else:
            os.environ["NNSTPU_AOT_CACHE"] = old
    results["rollout_launches"] = total


# -- phase: the deployment analyzer and doctor -----------------------------------

def check_deploy(torch, results, workdir):
    """``validate --deploy`` on each of examples/fleet/*.deploy in one
    child (each gives the verdict its header names, the clean spec
    none), and beside it ``doctor --json`` and ``doctor --aot``: the
    card, nvcc and the built kernel library."""
    import glob

    card = results["card"]
    env = dict(os.environ, NNSTPU_AOT_CACHE=os.path.join(workdir,
                                                         "aot-deploy"))
    specs = sorted(glob.glob(os.path.join(ROOT, "examples", "fleet",
                                          "*.deploy")))
    args = ["nnstreamer_tpu_torch.tools.validate", "--json"]
    for spec in specs:
        args += ["--deploy", spec]
    t0 = time.perf_counter()
    children = [_spawn(args, env),
                _spawn(["nnstreamer_tpu_torch.tools.doctor", "--json"], env),
                _spawn(["nnstreamer_tpu_torch.tools.doctor", "--aot"], env)]
    (rc, out, err), doc_json, doc_aot = [_collect(c) for c in children]
    secs = time.perf_counter() - t0
    doc = json.loads(out)
    verdicts = {}
    for spec, res in zip(specs, doc["results"]):
        with open(spec) as f:
            head = f.readline()
        want = [c for c in ("NNST991", "NNST992", "NNST993", "NNST994",
                            "NNST995", "NNST996") if c in head]
        got = sorted({d["code"] for d in res["diagnostics"]
                      if d["code"].startswith("NNST99")})
        verdicts[os.path.basename(spec)] = got
        if not set(want) <= set(got) or "NNST990" not in got or (
                not want and set(got) != {"NNST990"}):
            raise AssertionError(f"validate --deploy {spec}: {got}, want "
                                 f"{want}")
    emit("deploy", part="validate", specs=len(specs), verdicts=verdicts,
         exit=doc["exit"], card=card)
    rep = json.loads(doc_json[1])
    aot_rc, aot_out, aot_err = doc_aot
    k = rep["kernels"]
    name = torch.cuda.get_device_name(0)
    if not (any(name in d for d in rep["devices"]) and k["nvcc"]
            and k["built"] and rep["hw"]["has_gpu"] and aot_rc == 0
            and "AOT cache" in aot_out):
        raise AssertionError(f"doctor: {rep['devices']} {k} "
                             f"{aot_out[-400:]}{aot_err[-400:]}")
    emit("deploy", part="doctor", devices=rep["devices"], kernels=k,
         torch=rep["torch"], aot=aot_out.splitlines()[:3],
         children_s=secs, card=card)


# -- phase: imported model files (.tflite, .onnx) ---------------------------

#: the zoo model the imported files are written from: MobileNet-v2 1.0,
#: 224 px, 1001 classes, seed 0 (testing/model_files.py)
IMPORT_MODEL = {"seed": "0"}
#: the imported lines' float32 logits (TF32 off) against the zoo's float32
#: forward on the CPU over the same weights (BatchNorm folded into the
#: .tflite, unfolded in the .onnx): the sums differ in order only
IMPORT_ATOL = 1e-3


def _import_line(model: str, labels: str, custom: str = "",
                 preamble: bool = True) -> str:
    """The reference's image-labeling line on an imported file, the
    logits teed to a sink of their own."""
    head = (f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
            f"height={SIZE},framerate=1000/1 "
            f"! tensor_converter frames-per-tensor={BATCH} ")
    if preamble:
        head += f"! tensor_transform name=tr mode=arithmetic option={PREAMBLE} "
    cust = f" custom={custom}" if custom else ""
    return (head + f"! tensor_filter name=f framework=jax model={model}{cust} "
            "! tee name=t t. ! queue ! tensor_sink name=raw "
            f"t. ! queue ! tensor_decoder mode=image_labeling option1={labels} "
            "! tensor_sink name=out")


def _import_run(torch, line, frames, n_batches=N_BATCHES, warm=N_WARMUP):
    """Play ``line`` with one tracer from ``play()`` on, warm ``warm``
    batches, then time ``n_batches``: frames/s, p50 batch latency, the
    timed run's launches, the planner's fusions, the filter's compile-cache
    outcomes, every label and the last batch's logits."""
    import numpy as np

    from nnstreamer_tpu_torch import trace
    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    t_open = time.perf_counter()
    p = parse_launch(line)
    pushed, arrived = {}, {}
    p["out"].connect_new_data(
        lambda b: arrived.__setitem__(b.pts, time.perf_counter()))
    tracer = trace.attach(p)
    p.play()

    def push(k0, n):
        for i in range(k0 * BATCH, (k0 + n) * BATCH):
            p["src"].push_buffer(Buffer(tensors=[frames[i % len(frames)]],
                                        pts=i))
            pushed[i] = time.perf_counter()
        _wait_for(lambda: [len(p["out"].collected)], k0 + n, p, line[-40:])

    push(0, warm)
    first_s = time.perf_counter() - t_open
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    push(warm, n_batches)
    secs = max(arrived.values()) - t0
    launches = dict(_cuda.LAUNCHES)
    p["src"].end_of_stream()
    if not p.bus.wait_eos(120) or p.bus.error is not None:
        raise RuntimeError(f"import line failed: {p.bus.error}")
    lat = [(arrived[k] - pushed[k]) * 1e3 for k in arrived
           if k >= warm * BATCH]
    aot_events = ((tracer.report().get("aot") or {}).get("f", {})
                  .get("events", []))
    r = {"fps": n_batches * BATCH / secs,
         "p50_batch_latency_ms": statistics.median(lat),
         "open_to_warm_s": first_s, "launches": launches,
         "fusions": tracer.fusions(),
         "aot": [e["outcome"] for e in aot_events],
         "labels": [lab for b in p["out"].collected for lab in
                    b.meta["label"]],
         "logits": np.asarray(p["raw"].collected[-1].tensors[0])}
    p.stop()
    return r


def check_import(torch, results, workdir):
    """Imported model files on the card: the zoo's MobileNet-v2 written
    as a .tflite and an .onnx (testing/model_files.py), each streamed
    through the image-labeling line with ``framework=jax`` — the graph
    lowered to torch ops (cuDNN convolutions, TF32 off), its image
    preamble on the arith_chain kernel — with the preamble fused (both
    files), and the .tflite file also with ``preproc:norm:-127.5:127.5``
    and with ``batch:native`` (the .onnx importer ignores both, as the
    JAX one does); beside the zoo flagship (fused:pallas, bf16) on the
    same frames; TF32 against float32; the compile cache; the single-shot
    API."""
    import numpy as np

    from nnstreamer_tpu_torch.single import SingleShot
    from nnstreamer_tpu_torch.testing import model_files

    t_phase = time.perf_counter()
    labels = os.path.join(workdir, "import_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    files = {}
    for kind, write in (("tflite", model_files.write_mobilenet_v2_tflite),
                        ("onnx", model_files.write_mobilenet_v2_onnx)):
        path = os.path.join(workdir, f"mobilenet_v2.{kind}")
        t0 = time.perf_counter()
        write(path, IMPORT_MODEL)
        files[kind] = {"path": path, "bytes": os.path.getsize(path),
                       "write_ms": (time.perf_counter() - t0) * 1e3}
    rng = np.random.default_rng(5)
    frames = [np.kron(rng.integers(0, 256, (4, 4, 3)),
                      np.ones((SIZE // 4, SIZE // 4, 1))).astype(np.uint8)
              for _ in range(BATCH)]
    # the reference: the zoo module's float32 forward on the CPU, on the
    # frames the preamble makes
    x = ((np.stack(frames).astype(np.float32) + np.float32(-127.5))
         / np.float32(127.5))
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = model_files.zoo_module(IMPORT_MODEL)(
            torch.from_numpy(x)).numpy()
    ref_s = time.perf_counter() - t0
    want_labels = [f"class{i}" for i in want.argmax(-1)]
    emit("import", part="files", tflite={k: v for k, v in
                                          files["tflite"].items()
                                          if k != "path"},
         onnx={k: v for k, v in files["onnx"].items() if k != "path"},
         cpu_reference_s=ref_s, distinct_labels=len(set(want_labels)),
         card=results["card"])

    total = {}
    failures = []

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def judge(name, r, preamble, n_batches=N_BATCHES):
        err = max_err(torch.from_numpy(r["logits"]).float(),
                      torch.from_numpy(want).float())
        row = {"fps": r["fps"], "p50_batch_latency_ms":
               r["p50_batch_latency_ms"], "open_to_warm_s":
               r["open_to_warm_s"], "max_abs_err": err,
               "atol": IMPORT_ATOL, "fusions": r["fusions"],
               "launches": r["launches"], "aot": r["aot"],
               "labels_equal": bool(r["labels"]) and r["labels"] ==
               want_labels * (len(r["labels"]) // BATCH)}
        ok = (row["labels_equal"] and err <= IMPORT_ATOL
              and r["logits"].shape == (BATCH, 1001)
              and bool(np.isfinite(r["logits"]).all())
              and r["launches"].get("arith_chain", 0) == n_batches
              and r["launches"].get("fused_inverted_residual", 0) == 0
              and r["launches"].get("normalize_u8", 0) == 0
              and r["fusions"] == ({"tr": "fused-into:f"} if preamble
                                   else {}))
        row["ok"] = ok
        if not ok:
            failures.append(name)
        return row

    runs = {}
    variants = (("fused", "", True),
                ("preproc", "preproc:norm:-127.5:127.5", False),
                ("native", "batch:native", True))
    for kind in ("tflite", "onnx"):
        for name, custom, preamble in variants[:3 if kind == "tflite"
                                               else 1]:
            r = _import_run(torch, _import_line(files[kind]["path"], labels,
                                                custom, preamble), frames)
            add(r["launches"])
            runs[f"{kind}_{name}"] = (r, judge(f"{kind}_{name}", r,
                                               preamble))
            emit("import", line=f"{kind}_{name}", custom=custom,
                 batches=N_BATCHES, batch=BATCH,
                 **runs[f"{kind}_{name}"][1], card=results["card"])

    # the zoo flagship (fused:pallas, bf16) on the same frames and line
    p, _, secs, p50, launches = _run_line(_preamble_line(labels), frames,
                                          N_BATCHES)
    add(launches)
    flag_labels = [lab for b in p["out"].collected[-N_BATCHES:]
                   for lab in b.meta["label"]]
    p.stop()
    emit("import", line="zoo_flagship", fps=N_BATCHES * BATCH / secs,
         p50_batch_latency_ms=p50, launches=launches,
         label_agreement_f32_reference=sum(
             a == b for a, b in zip(flag_labels, want_labels * N_BATCHES))
         / len(flag_labels), card=results["card"])

    def run_imported():
        r = _import_run(torch, _import_line(files["tflite"]["path"], labels),
                        frames, n_batches=4, warm=0)
        return 4 * BATCH / r["fps"]

    emit("profile", line="import_tflite_fused", batches=4,
         **device_profile(torch, run_imported))

    # TF32 (precision:default) against float32 (the default, highest)
    r = _import_run(torch, _import_line(files["tflite"]["path"], labels,
                                        "precision:default"), frames)
    add(r["launches"])
    base = runs["tflite_fused"][0]
    tf32_gap = float(np.abs(r["logits"] - base["logits"]).max())
    emit("import", line="tflite_precision_default",
         fps=r["fps"], fps_highest=base["fps"],
         p50_batch_latency_ms=r["p50_batch_latency_ms"],
         logits_gap_to_highest=tf32_gap,
         labels_equal_highest=r["labels"] == base["labels"],
         card=results["card"])
    if not (np.isfinite(r["logits"]).all()
            and r["launches"].get("arith_chain", 0) == N_BATCHES):
        failures.append("tflite_precision_default")

    # invokes of both precisions at once, from two threads (as replicas
    # or two imported filters run them): each keeps its own precision,
    # and the process's TF32 flags are as they were after both have left
    import threading

    from nnstreamer_tpu_torch.tools.import_tflite import load_tflite

    xs = torch.from_numpy(x).cuda()
    bundles = {p: load_tflite(files["tflite"]["path"], {"precision": p},
                              device="cuda") for p in ("highest", "default")}
    serial = {p: b.apply_fn(xs).float().cpu() for p, b in bundles.items()}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    got = {p: [] for p in bundles}

    def loop(p):
        for _ in range(8):
            got[p].append(bundles[p].apply_fn(xs))

    threads = [threading.Thread(target=loop, args=(p,)) for p in bundles]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    torch.cuda.synchronize()
    errs = {p: max(float((o.float().cpu() - serial[p]).abs().max())
                   for o in outs) if outs else float("inf")
            for p, outs in got.items()}
    gap = float((serial["default"] - serial["highest"]).abs().max())
    conc = {"iterations": {p: len(v) for p, v in got.items()},
            "max_abs_err_to_serial": errs, "atol_highest": 1e-5,
            "tf32_gap": gap, "flags_restored": flags == (
                torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)}
    conc["ok"] = (all(n == 8 for n in conc["iterations"].values())
                  and errs["highest"] <= 1e-5 and errs["default"] < gap / 10
                  and conc["flags_restored"])
    emit("import", line="precisions_concurrent", **conc,
         card=results["card"])
    if not conc["ok"]:
        failures.append("precisions_concurrent")

    # the compile cache: aot:1 over a fresh cache, a miss then a hit
    old = os.environ.get("NNSTPU_AOT_CACHE")
    os.environ["NNSTPU_AOT_CACHE"] = os.path.join(workdir, "import-aot")
    try:
        aot_rows = {}
        for tag in ("miss", "hit"):
            r = _import_run(torch, _import_line(files["tflite"]["path"],
                                                labels, "aot:1"), frames,
                            n_batches=2, warm=1)
            add(r["launches"])
            aot_rows[tag] = {
                "outcomes": r["aot"], "open_to_warm_s": r["open_to_warm_s"],
                "bit_equal_aot0": bool(np.array_equal(
                    r["logits"], base["logits"])),
                "labels_equal": r["labels"] == want_labels * 3}
    finally:
        if old is None:
            os.environ.pop("NNSTPU_AOT_CACHE", None)
        else:
            os.environ["NNSTPU_AOT_CACHE"] = old
    aot_ok = (aot_rows["miss"]["outcomes"] == ["miss-compiled"]
              and aot_rows["hit"]["outcomes"] == ["hit"]
              and all(v["bit_equal_aot0"] and v["labels_equal"]
                      for v in aot_rows.values()))
    emit("import", line="tflite_aot", **aot_rows, ok=aot_ok,
         card=results["card"])
    if not aot_ok:
        failures.append("tflite_aot")

    # the single-shot API on one frame
    with SingleShot(model=files["tflite"]["path"], framework="jax") as s:
        outs = [s.invoke(x[0])[0] for _ in range(5)]
        single = {"label_equal": int(np.argmax(outs[-1])) == int(
                      want[0].argmax()),
                  "max_abs_err": float(np.abs(
                      outs[-1].reshape(-1) - want[0]).max()),
                  "latency_us": s.latency_us, "device": str(s.fw._device)}
    emit("import", line="single_shot", **single, card=results["card"])
    if not (single["label_equal"] and single["max_abs_err"] <= IMPORT_ATOL
            and single["device"].startswith("cuda")):
        failures.append("single_shot")

    results["import_launches"] = total
    emit("import", part="summary", failures=failures,
         seconds=time.perf_counter() - t_phase, card=results["card"])
    if failures:
        raise AssertionError(f"import: {failures} failed their checks")

# -- phase: training the vision models ---------------------------------------

#: each vision model at full width, its customs, and whether the
#: fused-block kernel runs its blocks (kernel_blocks counts them) in a
#: validation batch
TRAIN_VISION = {
    "ssd_mobilenet": {"size": 300, "custom": "width:1.0,classes:91",
                      "fused": True},
    "deeplab_v3": {"size": 257, "custom": "width:1.0,classes:21",
                   "fused": True},
    "posenet": {"size": 257, "custom": "width:1.0,keypoints:17",
                "fused": False},
    "yolov8": {"size": 320, "custom": "width:0.25,classes:80",
               "fused": False},
}
#: batch, train steps and validation batches of the line; timed steps and
#: validation batches after 2 warm-up steps and 1 validation batch; the
#: first step's batch on the card and the CPU
TV = {"batch": 16, "steps": 4, "val": 1, "timed": 4, "val_timed": 2,
      "first": 4, "lr": "0.0001"}


#: the card's float32 first step against the CPU's (no TF32): the largest
#: relative distance of the train forward's outputs, of the step's change
#: of the weights and of the running statistics, and of the loss. The
#: CPU's bfloat16 step is the control: it must lie farther than each
#: limit, so the limits tell a path one rounding off from a right one
TV_F32_LIMITS = {"forward": 1e-3, "weights_update": 1e-1,
                 "running_stats_update": 1e-3, "loss": 1e-4}
#: the card's bfloat16 forward (the line's) and its validation batch are
#: held within this many times the CPU bfloat16 run's distance from the
#: CPU float32 run (the bf16 noise of the same arithmetic)
TV_NOISE_FACTOR = 2.0


def _tv_custom(name, **extra) -> dict:
    cfg = TRAIN_VISION[name]
    custom = dict(kv.split(":") for kv in cfg["custom"].split(","))
    return {"size": str(cfg["size"]), "batch": str(TV["batch"]),
            "lr": TV["lr"], "loss": "mse", "seed": "0", **custom, **extra}


def _tv_frames(name, n):
    import numpy as np

    size = TRAIN_VISION[name]["size"]
    return np.random.default_rng(21).integers(0, 256, (n, size, size, 3),
                                               dtype=np.uint8)


def _tv_trainer(torch, name, custom, n_train, n_val=0):
    from nnstreamer_tpu_torch.trainers import TrainerProperties
    from nnstreamer_tpu_torch.trainers.cuda_trainer import CudaTrainer

    tr = CudaTrainer()
    props = TrainerProperties(model_config=name, num_training_samples=n_train,
                              num_validation_samples=n_val, custom=custom)
    tr.create(props)
    tr.start(lambda e: None)
    return tr, props


def _host(torch, out) -> list:
    """A model's output (a tensor or a tuple) as float64 host tensors."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [o.detach().double().cpu() for o in outs]


def _rel(a: list, b: list) -> float:
    """||a − b|| / ||b|| over lists of host tensors."""
    num = sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
    den = sum(float((y ** 2).sum()) for y in b)
    return (num / den) ** 0.5 if den else float(num > 0)


def _rel_cols(a: list, b: list) -> float:
    """The largest :func:`_rel` of one output's column (its last axis:
    a box coordinate, a class, a keypoint) over the outputs, so a column
    of small values (YOLOv8's scores beside its pixel boxes) counts."""
    return max(_rel([x[..., j]], [y[..., j]]) for x, y in zip(a, b)
               for j in range(y.shape[-1]))


class _TvRun:
    """One model's first step on a fresh trainer (seed:0 weights) over
    the first ``TV['first']`` frames, on the card (the zoo's bfloat16) or
    on the CPU, its layers in ``dtype`` when given: the train forward's
    outputs on those frames (no step taken), then the step's loss and the
    state before and after it, all on the host."""

    def __init__(self, torch, name, frames, device, dtype=None):
        n = TV["first"]
        extra = {"batch": str(n)}
        if device == "cpu":
            extra["device"] = "cpu"
        self.tr, self.props = _tv_trainer(torch, name,
                                          _tv_custom(name, **extra), n)
        module = self.tr._bundle.module
        if dtype is not None:
            _set_dtype(torch, module, dtype)
        with torch.no_grad():
            out, _ = self.tr._bundle.train_apply_fn(
                torch.from_numpy(frames[:n]).to(device))
        self.outputs = _host(torch, out)
        self.before = self._state()
        self.frames = frames[:n]

    def _state(self) -> dict:
        return {k: v.detach().double().cpu() for k, v
                in self.tr._bundle.module.state_dict().items()
                if v.is_floating_point()}

    def step(self, labels) -> None:
        for i, f in enumerate(self.frames):
            self.tr.push_data([f, labels[i % len(labels)]])
        self.loss = self.props.training_loss
        self.after = self._state()
        self.tr.destroy()

    def delta(self, running: bool) -> list:
        """The step's change of the weights (or the running statistics)."""
        return [self.after[k] - self.before[k] for k in sorted(self.after)
                if ("running" in k) == running]


def _tv_first_steps(torch, name, frames) -> tuple:
    """The first step on the card against the same module's float32 step
    on the CPU, from the same seed:0 weights on the same 4 frames: the
    train forward's outputs, the step's change of the weights and of the
    running statistics (relative norms), and the loss (relative). The
    card's step in float32 (TF32 off) is held within TV_F32_LIMITS, and
    the CPU's bfloat16 step must lie outside them (the control); the
    card's bfloat16 forward, the line's, is held within TV_NOISE_FACTOR
    times the CPU bfloat16 forward's distance. The labels are the CPU
    float32 forward's outputs (the tensor the loss reads) plus N(0, 0.5)
    noise, independent of the card; sample i takes label i % 4. Returns
    (labels, readings, ok)."""
    import numpy as np

    t0 = time.perf_counter()
    cpu32 = _TvRun(torch, name, frames, "cpu", torch.float32)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card32 = _TvRun(torch, name, frames, "cuda", torch.float32)
        card16 = _TvRun(torch, name, frames, "cuda")
        cpu16 = _TvRun(torch, name, frames, "cpu")
        rng = np.random.default_rng(21)
        labels = [(o + rng.normal(0.0, 0.5, o.shape)).astype(np.float32)
                  for o in cpu32.outputs[0].numpy()]
        for r in (cpu32, card32, card16, cpu16):
            r.step(labels)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    def dist(r, key):
        if key == "forward":
            return _rel_cols(r.outputs, cpu32.outputs)
        if key == "loss":
            return abs(r.loss - cpu32.loss) / abs(cpu32.loss)
        running = key == "running_stats_update"
        return _rel(r.delta(running), cpu32.delta(running))

    losses = [cpu32.loss, card32.loss, card16.loss, cpu16.loss]
    ok = bool(np.isfinite(losses).all())
    readings = {"losses": dict(zip(("cpu_f32", "card_f32", "card_bf16",
                                    "cpu_bf16"), losses)),
                "batch": TV["first"]}
    for key, limit in TV_F32_LIMITS.items():
        got, control = dist(card32, key), dist(cpu16, key)
        readings[key] = {"card_f32_vs_cpu_f32": got,
                         "cpu_bf16_vs_f32": control, "limit": limit,
                         "card_bf16_vs_cpu_f32": dist(card16, key)}
        ok = ok and got <= limit < control
    fwd = readings["forward"]
    fwd["bf16_limit"] = TV_NOISE_FACTOR * fwd["cpu_bf16_vs_f32"]
    ok = ok and fwd["card_bf16_vs_cpu_f32"] <= fwd["bf16_limit"]
    readings["seconds"] = time.perf_counter() - t0
    return labels, readings, ok


def _tv_preamble(torch, name, frames) -> dict:
    """normalize_u8 at the line's batch of frames, bit-equal to its plain
    version (the same two roundings)."""
    from nnstreamer_tpu_torch.ops import normalize_u8, normalize_u8_plain

    x = torch.from_numpy(frames[:TV["batch"]]).cuda()
    scale = (1.0 / 255.0, 0.0) if name == "yolov8" else (1.0 / 127.5, -1.0)
    return {"shape": list(x.shape), "scale": list(scale), "tol": 0.0,
            "max_abs_err": max_err(
                normalize_u8(x, *scale, out_dtype=torch.bfloat16),
                normalize_u8_plain(x, *scale, out_dtype=torch.bfloat16))}


def _tv_validation(torch, name, fw, frames, labels, n_train, n_val,
                   reported) -> dict:
    """The trained line's validation forward (``fused:pallas``: the
    fused-block kernel for SSD and DeepLab) run again on its validation
    batch with its trained weights: its mse against the line's reported
    validation loss (1e-3 relative), and its outputs (by column,
    _rel_cols) against the unfused forward of the same weights in float32
    on the CPU, within
    TV_NOISE_FACTOR times the CPU's unfused bfloat16 forward's distance
    from it."""
    import numpy as np

    from nnstreamer_tpu_torch.models import build_with_state

    x = frames[n_train:n_train + n_val]
    y = np.stack([labels[i % len(labels)]
                  for i in range(n_train, n_train + n_val)])
    with torch.no_grad():
        card = _host(torch, fw._bundle.apply_fn(torch.from_numpy(x).cuda()))
    state = {k: v.detach().cpu()
             for k, v in fw._bundle.module.state_dict().items()}
    twin = build_with_state(name, _tv_custom(name, device="cpu"), "cpu",
                            state)
    outs = {}
    for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        _set_dtype(torch, twin.module, dtype)
        outs[key] = _host(torch, twin.apply_fn(torch.from_numpy(x)))
    mse = float(((card[0] - torch.from_numpy(y).double()) ** 2).mean())
    got = _rel_cols(card, outs["f32"])
    noise = _rel_cols(outs["bf16"], outs["f32"])
    row = {"frames": n_val, "card_vs_cpu_f32": got,
           "cpu_bf16_vs_f32": noise, "limit": TV_NOISE_FACTOR * noise,
           "loss_rerun": mse, "loss_reported": reported}
    row["ok"] = bool(got <= row["limit"] and reported is not None
                     and abs(mse - reported) <= 1e-3 * abs(reported))
    return row


def _tv_line(name, label_shape, n_train, n_val) -> str:
    cfg = TRAIN_VISION[name]
    label_dims = ":".join(str(d) for d in reversed(label_shape))
    caps = ("other/tensors,format=static,num_tensors=2,dimensions="
            f"3:{cfg['size']}:{cfg['size']}.{label_dims},"
            "types=uint8.float32,framerate=0/1")
    return (f"appsrc name=src caps={caps} ! tensor_trainer name=tr "
            f"framework=jax model-config={name} num-inputs=1 num-labels=1 "
            f"num-training-samples={n_train} "
            f"num-validation-samples={n_val} epochs=1 "
            f"custom={_custom_str(_tv_custom(name, fused='pallas'))} "
            "! tensor_sink name=out")


def _tv_timing(torch, name, frames, labels) -> dict:
    """Train step and validation times on a trainer driven directly: the
    batch-completing push of each step (stack, one upload, forward,
    backward, update, the loss read) after 2 warm-up steps, each
    validation batch after 1; then the idle share over 4 more steps."""
    b = TV["batch"]
    n_steps, n_val = 2 + TV["timed"], 1 + TV["val_timed"]
    tr, _ = _tv_trainer(torch, name, _tv_custom(name, fused="pallas"),
                        n_steps * b, n_val * b)
    step_ms, val_ms = [], []
    for i in range((n_steps + n_val) * b):
        t0 = time.perf_counter()
        tr.push_data([frames[i % len(frames)], labels[i % 4]])
        if (i + 1) % b == 0:
            torch.cuda.synchronize()
            (step_ms if i < n_steps * b else val_ms).append(
                (time.perf_counter() - t0) * 1e3)
    steps, vals = step_ms[2:], val_ms[1:]
    tr2, _ = _tv_trainer(torch, name, _tv_custom(name, fused="pallas"),
                         10 ** 6)

    def run():
        t0 = time.perf_counter()
        for i in range(4 * b):
            tr2.push_data([frames[i % len(frames)], labels[i % 4]])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()  # warm-up steps
    prof = device_profile(torch, run)
    return {"step_ms_median": statistics.median(steps),
            "step_ms_min": min(steps), "step_ms_max": max(steps),
            "samples_per_s": b / statistics.median(steps) * 1e3,
            "val_ms_median": statistics.median(vals),
            "val_frames_per_s": b / statistics.median(vals) * 1e3,
            "idle_share_4_steps": prof["idle_share"],
            "device_busy_ms_4_steps": prof["device_busy_ms"],
            "wall_ms_4_steps": prof["wall_ms"],
            "by_kind_ms": prof["by_kind_ms"]}


def check_train_vision(torch, results):
    """The four BatchNorm vision models trained at full width from their
    seed:0 weights through ``appsrc ! tensor_trainer framework=jax
    model-config=<name> custom=...,loss:mse,fused:pallas ! tensor_sink``:
    4 steps of batch 16 and one validation batch, against labels of the
    head's shape from the CPU's float32 forward (see _tv_first_steps).
    Each model is held on (1) its first step on the card against the same
    module's float32 step on the CPU in this process: the train forward's
    outputs, the step's change of the weights and of the running
    statistics, and the loss, the card's float32 step within
    TV_F32_LIMITS, which the CPU's bfloat16 step must exceed, and the
    card's bfloat16 forward within TV_NOISE_FACTOR times the CPU's
    bfloat16 forward's distance (_tv_first_steps); (2) normalize_u8 at
    the line's frames, bit-equal to its plain version (a train-mode
    BatchNorm after the bias-free stem hides a scale or offset error of
    the preamble from the outputs); (3) the line: its launches —
    normalize_u8 once a batch (steps and validation), the fused-block
    kernel 17 (SSD) or 13 (DeepLab) times a validation batch — and finite
    reports; (4) the line's validation batch through its fused forward
    against the unfused float32 forward on the CPU (_tv_validation); then
    the timing on a trainer driven directly."""
    import numpy as np

    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    t_phase = time.perf_counter()
    total, failures = {}, []
    b = TV["batch"]
    n_train, n_val = TV["steps"] * b, TV["val"] * b
    for name, cfg in TRAIN_VISION.items():
        frames = _tv_frames(name, n_train + n_val)
        labels, first, first_ok = _tv_first_steps(torch, name, frames)
        preamble = _tv_preamble(torch, name, frames)

        p = parse_launch(_tv_line(name, labels[0].shape, n_train, n_val))
        _cuda.reset_launches()
        t0 = time.perf_counter()
        p.play()
        for i in range(n_train + n_val):
            p["src"].push_buffer(Buffer(tensors=[frames[i], labels[i % 4]],
                                        pts=i))
        p["src"].end_of_stream()
        if not p.bus.wait_eos(600) or p.bus.error is not None:
            raise RuntimeError(f"train_vision {name}: {p.bus.error}")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        stats = dict(p["tr"]._fw.stats)
        reports = [np.asarray(r.tensors[0]).reshape(-1).tolist()
                   for r in p["out"].collected]
        report = dict(zip(("train_loss", "train_acc", "val_loss",
                           "val_acc"), reports[0])) if reports else None
        val = _tv_validation(torch, name, p["tr"]._fw, frames, labels,
                             n_train, n_val,
                             report["val_loss"] if report else None)
        p.stop()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        batches = TV["steps"] + TV["val"]
        ok = (first_ok and val["ok"]
              and preamble["max_abs_err"] <= preamble["tol"]
              and len(reports) == 1 and np.isfinite(reports[0]).all()
              and stats["steps"] == TV["steps"]
              and stats["val_batches"] == TV["val"]
              and launches.get("normalize_u8", 0) == batches
              and launches.get("fused_inverted_residual", 0)
              == (kernel_blocks(name) if cfg["fused"] else 0) * TV["val"])
        row = {"model": name, "size": cfg["size"], "custom": cfg["custom"],
               "batch": b, "first_step": first, "preamble": preamble,
               "validation": val, "line_seconds": secs, "report": report,
               "steps": stats["steps"], "val_batches": stats["val_batches"],
               "h2d_bytes_per_batch": stats["h2d_bytes"] / batches,
               "launches": launches, "ok": ok}
        if ok:
            row.update(_tv_timing(torch, name, frames, labels))
        else:
            failures.append(name)
        emit("train_vision", **row, card=results["card"])
    results["train_vision_launches"] = total
    emit("train_vision", part="summary", failures=failures,
         launches=total, seconds=time.perf_counter() - t_phase,
         card=results["card"])
    if failures:
        raise AssertionError(f"train_vision: {failures} failed their checks")


# -- phase: user C and Lua filters -------------------------------------------

CUSTOM_BATCHES = 8
LUA_SCRIPT = """
inputTensorsInfo = { num = 1, dim = {{16, 1, 1, 1},}, type = {'float32',} }
outputTensorsInfo = { num = 1, dim = {{16, 1, 1, 1},}, type = {'float32',} }
function nnstreamer_invoke()
  local inp = input_tensor(1)
  local out = output_tensor(1)
  for i = 1, 16 do
    out[i] = inp[i] * 2.0 + 0.5
  end
end
"""


def _build_passthrough_so(workdir) -> str:
    """The codegen 'c' passthrough, built with g++ against native/include
    (raises when g++ is missing or the build fails)."""
    import shutil

    from nnstreamer_tpu_torch.tools import codegen

    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("custom: no g++ on this machine")
    src = os.path.join(workdir, "genfilter.c")
    so = os.path.join(workdir, "libgenfilter.so")
    with open(src, "w") as f:
        f.write(codegen.generate("c", "genfilter"))
    out = subprocess.run([gxx, "-O2", "-fPIC", "-shared",
                          f"-I{os.path.join(ROOT, 'native', 'include')}",
                          src, "-o", so], capture_output=True, text=True,
                         timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"custom: g++ failed: {out.stderr[-2000:]}")
    return so


def _custom_flag_line(labels: str, so: str = "") -> str:
    """The flagship labeling line (argmax on the card), the C passthrough
    between the filter and the decoder when ``so`` names one."""
    lib = f"! tensor_filter name=c framework=custom model={so} " if so else ""
    return (f"appsrc name=src caps=video/x-raw,format=RGB,width={SIZE},"
            f"height={SIZE},framerate=1000/1 "
            f"! tensor_converter frames-per-tensor={BATCH} "
            "! tensor_filter name=f framework=jax model=mobilenet_v2 "
            "custom=seed:0,postproc:argmax,fused:pallas "
            f"{lib}! queue ! tensor_decoder mode=image_labeling "
            f"option1={labels} ! tensor_sink name=out")


def check_custom(torch, results, workdir):
    """The flagship line followed by a user C library (the codegen 'c'
    passthrough, built here), labels equal to the flagship alone, with
    frames/s, p50 batch latency and the d2h bytes a batch; then model=add
    on the card into a framework=lua script on 16-float tensors, outputs
    against numpy."""
    import numpy as np

    from nnstreamer_tpu_torch.buffer import Buffer
    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.pipeline import parse_launch

    t_phase = time.perf_counter()
    labels, frames = _phase_frames(torch, results, workdir)
    t0 = time.perf_counter()
    so = _build_passthrough_so(workdir)
    build_s = time.perf_counter() - t0
    total, failures = {}, []
    rows = {}
    for tag, lib in (("flagship", ""), ("flagship_custom_so", so)):
        p, tracer, secs, p50, launches = _run_line(
            _custom_flag_line(labels, lib), frames, CUSTOM_BATCHES)
        cross = tracer.crossings()
        labs = _labels_of(p)[-CUSTOM_BATCHES * BATCH:]
        p.stop()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        rows[tag] = {"fps": CUSTOM_BATCHES * BATCH / secs,
                     "p50_batch_latency_ms": p50, "launches": launches,
                     "d2h_per_batch": cross["d2h"] / CUSTOM_BATCHES,
                     "d2h_bytes_per_batch": cross["d2h_bytes"]
                     / CUSTOM_BATCHES, "labels": labs}
    a, c = rows["flagship"], rows["flagship_custom_so"]
    so_ok = (c["labels"] == a["labels"] and len(c["labels"])
             == CUSTOM_BATCHES * BATCH and c["d2h_per_batch"] == 1
             and c["launches"].get("fused_inverted_residual", 0)
             == kernel_blocks() * CUSTOM_BATCHES
             and c["launches"].get("normalize_u8", 0) == CUSTOM_BATCHES)
    emit("custom", line="flagship_custom_so", so_build_s=build_s,
         batches=CUSTOM_BATCHES, batch=BATCH,
         labels_equal_flagship=c["labels"] == a["labels"],
         **{k: v for k, v in c.items() if k != "labels"},
         flagship={k: v for k, v in a.items() if k != "labels"},
         ok=so_ok, card=results["card"])
    if not so_ok:
        failures.append("flagship_custom_so")

    # model=add on the card into a Lua script: one host read a buffer
    line = ("appsrc name=src caps=other/tensors,format=static,num-tensors=1,"
            "dimensions=16,types=float32,framerate=0/1 "
            "! tensor_filter name=m framework=jax model=add custom=k:1 "
            "! tensor_filter name=f framework=lua ! tensor_sink name=out")
    from nnstreamer_tpu_torch import trace

    rng = np.random.default_rng(7)
    xs = [rng.normal(size=16).astype(np.float32) for _ in range(32)]
    p = parse_launch(line)
    p["f"].set_property("model", LUA_SCRIPT)
    tracer = trace.attach(p)
    p.play()
    t0 = time.perf_counter()
    for i, x in enumerate(xs):
        p["src"].push_buffer(Buffer(tensors=[x], pts=i))
    p["src"].end_of_stream()
    if not p.bus.wait_eos(120) or p.bus.error is not None:
        raise RuntimeError(f"custom: lua line failed: {p.bus.error}")
    secs = time.perf_counter() - t0
    outs = [np.asarray(b.tensors[0]).reshape(-1) for b in p["out"].collected]
    cross = tracer.crossings()
    m_dev = str(p["m"].fw._device)
    p.stop()
    err = max((float(np.abs(o - ((x + 1) * 2.0 + 0.5)).max())
               for o, x in zip(outs, xs)), default=float("inf"))
    lua_ok = (len(outs) == len(xs) and err == 0.0
              and cross["d2h"] == len(xs) and m_dev.startswith("cuda"))
    emit("custom", line="add_lua", buffers=len(outs), max_abs_err=err,
         d2h=cross["d2h"], h2d=cross["h2d"], model_device=m_dev,
         buffers_per_s=len(outs) / secs, ok=lua_ok, card=results["card"])
    if not lua_ok:
        failures.append("add_lua")
    results["custom_launches"] = total
    emit("custom", part="summary", failures=failures,
         seconds=time.perf_counter() - t_phase, card=results["card"])
    if failures:
        raise AssertionError(f"custom: {failures} failed their checks")


# -- phase: the native pipeline core and framework=pjrt ----------------------

NATIVE_BATCHES = 8
NATIVE_CUSTOM = "seed:0,postproc:argmax,fused:pallas"
NATIVE_AB_REPS = 10


def _build_native() -> dict:
    """The port's core, then the native executable filter and the op
    library it links (compiled side by side); each build's seconds (0
    where it was built)."""
    from nnstreamer_tpu_torch import native_rt

    t0 = time.perf_counter()
    runner = native_rt.build_exec()
    return {"runner": runner, "wall_s": time.perf_counter() - t0,
            **{f"{k}_s": native_rt.build_seconds.get(k, 0.0)
               for k in ("core", "ops", "exec")}}


def _op_route_rows(torch) -> list:
    """Each kernel through its TorchScript op (a trace of the wrapper)
    against its ctypes route on the same input, at the flagship's shapes:
    its 17 blocks (13 stride-1, 4 stride-2) at batch 128 and normalize_u8
    on 128 frames."""
    from nnstreamer_tpu_torch.filters import aot
    from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, init_weights
    from nnstreamer_tpu_torch.ops.fused_block import (
        cast_folded,
        fused_inverted_residual,
    )
    from nnstreamer_tpu_torch.ops.preprocess import normalize_u8

    gen = torch.Generator(device="cuda").manual_seed(22)
    model = MobileNetV2(num_classes=1001)
    init_weights(model, 0)
    rows = []

    def compare(name, fn, x, **label):
        with torch.no_grad(), aot.quiet_jit():
            traced = torch.jit.trace(fn, (x,), check_trace=False)
        want, got = fn(x), traced(x)
        torch.cuda.synchronize()
        ops_in_graph = sum(n.kind() == f"nnstpu_torch::{name}"
                           for n in traced.graph.nodes())
        rows.append({"kernel": name, **label, "shape": list(x.shape),
                     "bits_equal": _bits_equal(torch, got, want),
                     "max_abs_err": max_err(got, want),
                     "ops_in_graph": ops_in_graph})

    for stride in (1, 2):
        for i, H, W, fw in _blocks(model, stride):
            fwc = cast_folded(fw, torch.bfloat16, "cuda")
            cin = fwc["w1"].shape[0] if "w1" in fwc else fwc["wd"].shape[1]
            x = torch.randn((BATCH, H, W, cin), generator=gen, device="cuda")
            compare("fused_inverted_residual",
                    lambda t, fwc=fwc, s=stride: fused_inverted_residual(
                        t, fwc, stride=s),
                    x.clamp(-3, 3).to(torch.bfloat16), block=i,
                    stride=stride)
    u8 = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=gen,
                       device="cuda", dtype=torch.uint8)
    compare("normalize_u8", lambda t: normalize_u8(t), u8)
    return rows


def _native_logits(torch, runner, frames, workdir) -> dict:
    """One batch through a native program without the argmax (appsrc
    ! framework=pjrt ! appsink; the worker's build run in this process)
    against the port's Python forward (fused:pallas) and its plain twin,
    as check_slice holds the filter."""
    import numpy as np

    from nnstreamer_tpu_torch.filters import aot_worker
    from nnstreamer_tpu_torch.models import get_model, preprocess_frames
    from nnstreamer_tpu_torch.models.mobilenet_v2 import _make_fused_apply
    from nnstreamer_tpu_torch.tools import pjrt_native

    x_np = np.stack(frames)
    path = os.path.join(workdir, "mbv2_logits.pjrt")
    aot_worker.build_frozen({"model": "mobilenet_v2",
                             "custom": "seed:0,fused:pallas",
                             "shapes": [[list(x_np.shape), "uint8"]],
                             "device": "cuda", "out": path})
    (out,), = pjrt_native.run_native(path, [[x_np]], runner=runner)
    got = torch.from_numpy(out.view(np.float32).reshape(len(frames), -1))
    bundle = get_model("mobilenet_v2", {"seed": "0", "fused": "pallas"},
                       "cuda")
    x = torch.from_numpy(x_np).cuda()
    with torch.inference_mode():
        py = bundle.apply_fn(x).float().cpu()
        pre = preprocess_frames(x, "pm1", bundle.module.dtype)
        plain = _make_fused_apply(bundle.module, mode="plain")(pre).float()
    plain = plain.cpu()
    return {"logits_max_abs_err": max_err(got, plain), "logits_atol": 0.15,
            "logits_rtol": 0.05, "logits_ok": bool(
                torch.isfinite(got).all()) and within(got, plain, 0.15, 0.05),
            "python_forward_max_abs_err": max_err(got, py),
            "python_forward_bits_equal": _bits_equal(torch, got, py)}


def _native_add(runner, workdir) -> dict:
    """``native_aot_compile("add", "k:1.5", ...)`` through pjrt_native's
    default mode in a child process: check_max_err must be 0.0."""
    import numpy as np

    from nnstreamer_tpu_torch.filters import aot

    path = aot.native_aot_compile("add", "k:1.5", [((4, 4), "float32")])
    if path is None:
        raise RuntimeError("native: the add program did not build")
    x = np.random.default_rng(0).normal(0, 1, (4, 4)).astype(np.float32)
    want = os.path.join(workdir, "native_add_want.npy")
    np.save(want, x + 1.5)
    spec = os.path.join(workdir, "native_add.json")
    with open(spec, "w") as f:
        json.dump({"exec": path, "frames": 4, "seed": 0,
                   "check_path": want, "runner": runner}, f)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "nnstreamer_tpu_torch.tools.pjrt_native", spec],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    if r.returncode != 0:
        raise RuntimeError(f"native: add program failed: {r.stderr[-2000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    out["child_s"] = time.perf_counter() - t0
    return out


def check_native(torch, results, workdir):
    """The native pipeline core and framework=pjrt on the card (see the
    module docstring's ``native``)."""
    import numpy as np

    from nnstreamer_tpu_torch import native_rt
    from nnstreamer_tpu_torch.filters import aot
    from nnstreamer_tpu_torch.ops import _cuda, _script_ops
    from nnstreamer_tpu_torch.single import SingleShot
    from nnstreamer_tpu_torch.tools import pjrt_native
    from nnstreamer_tpu_torch.types import TensorInfo, TensorsInfo

    t_phase = time.perf_counter()
    card = results["card"]
    failures = []
    # built beside the kernels at the start (main), else here
    fut = results.get("native_build")
    builds = dict(fut.result() if fut is not None else _build_native())
    runner = builds.pop("runner")
    emit("native", part="build", **builds, card=card)

    labels = os.path.join(workdir, "native_labels.txt")
    with open(labels, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(1001)) + "\n")
    n_all = (NATIVE_BATCHES + 1) * BATCH
    frames = [pjrt_native.testsrc_frame(i) for i in range(n_all)]
    # the flagship's program builds in the worker child while this process
    # checks the op route and one batch's logits (nothing here is timed)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        program = pool.submit(aot.native_aot_compile, "mobilenet_v2",
                              NATIVE_CUSTOM,
                              [((BATCH, SIZE, SIZE, 3), "uint8")])
        rows = _op_route_rows(torch)
        logits = _native_logits(torch, runner, frames[BATCH:2 * BATCH],
                                workdir)
        path = program.result()
    if path is None:
        raise RuntimeError("native: the flagship program did not build")
    compile_s, worker = time.perf_counter() - t0, dict(aot.LAST_WORKER)
    for row in rows:
        emit("native", part="op_route", **row, card=card)
    if not all(r["bits_equal"] and r["ops_in_graph"] == 1 for r in rows):
        failures.append("op_route")

    add = _native_add(runner, workdir)
    add_ok = add.get("check_max_err") == 0.0 and not add["python_torch"]
    emit("native", part="add", **add, ok=add_ok, card=card)
    if not add_ok:
        failures.append("add")

    # the flagship with no Python in the frame path, counted in C
    _script_ops.reset_launches()
    native_iv = []
    fps, native_labels = pjrt_native.run_flagship(
        path, labels, NATIVE_BATCHES, BATCH, runner=runner, timeout=120,
        intervals=native_iv)
    counted = _script_ops.launches()
    n_batches = NATIVE_BATCHES + 1  # the warm-up batch runs the program too
    launches_ok = (counted["fused_inverted_residual"]
                   == kernel_blocks() * n_batches
                   and counted["normalize_u8"] == n_batches)
    native_flat = [lab for b in native_labels for lab in b]

    # the port's Python flagship (check_slice's line) on the same frames
    p, _tracer, py_secs, py_p50, py_launches = _run_line(
        _flag_line(labels, "fetch-window=1"), frames, NATIVE_BATCHES, warm=1)
    py_flat = _labels_of(p)[-NATIVE_BATCHES * BATCH:]
    p.stop()
    labels_ok = native_flat == py_flat and len(native_flat) == \
        NATIVE_BATCHES * BATCH

    # the callback route: the port's Python filter inside the native graph
    single = SingleShot(model="mobilenet_v2", framework="jax",
                        custom=NATIVE_CUSTOM)
    name = "torch_flagship_cb"
    native_rt.register_callback_filter(
        name, lambda xs: single.invoke(xs[0]),
        TensorsInfo(tensors=[TensorInfo(dims=(3, SIZE, SIZE, BATCH),
                                        dtype="uint8")]),
        TensorsInfo(tensors=[TensorInfo(dims=(BATCH,), dtype="int32")]))
    try:
        _cuda.reset_launches()
        cb_iv = []
        cb_fps, cb_labels = pjrt_native.run_flagship(
            path, labels, NATIVE_BATCHES, BATCH, framework=name,
            timeout=120, intervals=cb_iv)
        cb_launches = dict(_cuda.LAUNCHES)
    finally:
        native_rt.unregister_filter(name)
        single.close()
    cb_flat = [lab for b in cb_labels for lab in b]
    cb_ok = (cb_flat == native_flat
             and cb_launches["fused_inverted_residual"] == kernel_blocks() * n_batches
             and cb_launches["normalize_u8"] == n_batches)

    ab = pjrt_native.run_ab({"exec": path, "model": "mobilenet_v2",
                             "custom_model": NATIVE_CUSTOM,
                             "reps": NATIVE_AB_REPS, "runner": runner})
    ms = lambda iv: statistics.median(iv) * 1e3  # noqa: E731
    emit("native", part="flagship", batches=NATIVE_BATCHES, batch=BATCH,
         warmup_batches=1, program=os.path.basename(path),
         program_bytes=os.path.getsize(path), compile_s=compile_s,
         worker=worker, launches_counted_in_c=counted,
         launches_per_batch={k: v / n_batches for k, v in counted.items()},
         launches_ok=launches_ok, labels_equal_python=labels_ok,
         distinct_labels=len(set(native_flat)), **logits,
         native={"fps": fps, "p50_batch_interval_ms": ms(native_iv)},
         callback={"fps": cb_fps, "p50_batch_interval_ms": ms(cb_iv),
                   "labels_equal_native": cb_flat == native_flat,
                   "launches": cb_launches},
         python={"fps": NATIVE_BATCHES * BATCH / py_secs,
                 "p50_batch_latency_ms": py_p50, "launches": py_launches},
         run_ab=ab, card=card)
    if not launches_ok:
        failures.append("launches")
    if not labels_ok:
        failures.append("labels")
    if not logits["logits_ok"]:
        failures.append("logits")
    if not cb_ok:
        failures.append("callback")
    results["native_launches"] = {
        k: counted[k] + cb_launches.get(k, 0) for k in counted}
    results["native_op_launches"] = counted
    emit("native", part="summary", failures=failures,
         seconds=time.perf_counter() - t_phase, card=card)
    if failures:
        raise AssertionError(f"native: {failures} failed their checks")



# -- phases: the measurement tools and the example runners ------------------

#: the MFU table's rows the probes phase must print, measured
MFU_ROWS = tuple(
    f"{name}@{b}" for b in (128, 256, 512) for name in (
        "mobilenet_v2 f32-params uint8-in",
        "mobilenet_v2 bf16-params uint8-in",
        "mobilenet_v2 fused:xla (BN-folded)",
        "mobilenet_v2 fused:pallas (BN-folded, kernels)")) + (
    "mobilenet_v2 f32-params NCHW-in(+device permute)@128",
    "vit_s16 bf16@32", "vit_s16 bf16@128",
    "flash-attn cuda causal 8x8192x128 bf16 (interleaved)@8",
    "flash-attn blockwise b256 causal 8x8192x128 bf16 (interleaved)@8")
MS_STREAMS = (1, 2, 4, 8)


def check_probes(torch, results):
    """The port's three measurement tools on the card, each printing one
    line per row: tools/mfu_table.py's whole table (the quant section runs
    only where its file is in the checkout; the line names the path it
    skipped), every row with device ms, TFLOP/s and MFU against 989 TFLOP/s
    and none unreliable; tools/mbv2_breakdown.py's rows, per-stage deltas
    and depthwise share; tools/multistream_probe.py at 1, 2, 4 and 8
    streams. The tables go to build/probes/. Before the table, the
    fused:pallas forward is held against its plain version at each of the
    table's batches (:func:`_probe_forwards_agree`). Launches: the
    wrappers' own (warm-ups, counting), which join the kernels line; the
    launches the timed graphs' replays made (launches per apply times
    applies replayed) are printed apart, as ``graph_launches``."""
    import math

    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.tools import (
        mbv2_breakdown,
        mfu_table,
        multistream_probe,
    )

    out_dir = os.path.join(ROOT, "build", "probes")
    card = results["card"]
    t0 = time.perf_counter()
    _probe_forwards_agree(torch, card)
    _cuda.reset_launches()
    before = mfu_table.card_stamp()
    rows = mfu_table.build_rows()
    table = mfu_table.table(rows, before, mfu_table.card_stamp())
    clean = mfu_table.save(table, os.path.join(out_dir,
                                               "MFU_TABLE.cuda.json"))
    graph = {}
    for r in rows:
        emit("probes", probe="mfu_table", **r)
        _add_into(graph, r.get("graph_launches", {}))
    seen = {f"{r['config']}@{r.get('batch')}": r for r in rows}
    bad = [k for k in MFU_ROWS if k not in seen or any(
        f not in seen[k] for f in ("device_ms_per_batch", "tflops_per_sec",
                                   "mfu_pct"))]
    bad += [k for k, r in seen.items() if r.get("unreliable")
            or "error" in r or not r.get("card", {}).get("power.limit")]
    mfu_s = time.perf_counter() - t0
    emit("probes", probe="mfu_table", rows=len(rows), clean=clean,
         quant=table["quant_tflite"], card_before=table["card_before"],
         card_after=table["card_after"], seconds=mfu_s, failed=bad,
         card=card)
    if bad or not clean:
        raise AssertionError(f"probes: mfu_table rows failed: {bad}")

    t1 = time.perf_counter()
    br = mbv2_breakdown.run()
    with open(os.path.join(out_dir, "MBV2_BREAKDOWN.cuda.json"), "w") as f:
        json.dump(br, f, indent=1)
    for r in br["rows"]:
        emit("probes", probe="mbv2_breakdown", **r)
    ok = (len(br["rows"]) == 12 and len(br["per_stage_delta_ms"]) == 7
          and math.isfinite(br["depthwise_share_pct"])
          and all(r["device_ms_per_batch"] > 0 for r in br["rows"]))
    emit("probes", probe="mbv2_breakdown", batch=br["batch"],
         per_stage_delta_ms=br["per_stage_delta_ms"],
         depthwise_share_pct=br["depthwise_share_pct"],
         full_ms=br["full_ms"], card_after=br["card"], ok=ok,
         seconds=time.perf_counter() - t1, card=card)
    if not ok:
        raise AssertionError("probes: the breakdown is incomplete")

    t2 = time.perf_counter()
    ms = multistream_probe.run(MS_STREAMS)
    ok = all(math.isfinite(ms[leg][str(s)]) and ms[leg][str(s)] > 0
             for leg in ("ms_host", "ms_dev", "native_spin")
             for s in MS_STREAMS)
    emit("probes", probe="multistream", **ms, ok=ok,
         seconds=time.perf_counter() - t2)
    if not ok:
        raise AssertionError(f"probes: multistream legs: {ms}")
    total = dict(_cuda.LAUNCHES)
    results["probes_launches"] = total
    emit("probes", launches=total, graph_launches=graph,
         seconds=time.perf_counter() - t0)
    for k in ("fused_inverted_residual", "normalize_u8", "flash_attention"):
        if total.get(k, 0) == 0:
            raise AssertionError(f"probes: {k} was never launched")


#: the MFU table's MobileNet-v2 batches, each held before it is timed
PROBE_BATCHES = (128, 256, 512)


def _probe_forwards_agree(torch, card):
    """The MFU table's fused:pallas forward (kernels 1 and 2; the same
    zoo model, seed 0) at each of its batches, against the same folded
    forward with the kernels' plain versions in their place: within the
    flagship's limit (MODEL_ATOL, MODEL_RTOL) and the bf16 noise floor of
    :func:`_agreement` (the fused:xla forward's distance from plain). One
    line per batch; raises if a batch fails."""
    import numpy as np

    from nnstreamer_tpu_torch.models import get_model

    bundle = get_model("mobilenet_v2", {"seed": "0", "fused": "pallas"},
                       "cuda")
    rng = np.random.default_rng(1)
    bad = []
    for b in PROBE_BATCHES:
        x = torch.from_numpy(rng.integers(0, 256, (b, 224, 224, 3),
                                          np.uint8)).cuda()
        fw = _forwards(torch, "mobilenet_v2", bundle, x)
        ok, rows = _agreement(torch, fw)
        tol = within(fw["kernel"][0], fw["plain"][0], MODEL_ATOL, MODEL_RTOL)
        emit("probes", probe="forward_check", batch=b,
             logits=rows[0], within_flagship_tol=tol, atol=MODEL_ATOL,
             rtol=MODEL_RTOL, noise_share=NOISE_SHARE, ok=ok and tol,
             card=card)
        if not (ok and tol):
            bad.append(b)
        del x, fw
    del bundle
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"probes: the fused:pallas forward strays from "
                             f"its plain version at batch {bad}")


#: per runner: the kernels it must launch on the card
EXAMPLE_KERNELS = {
    "long_context": ("flash_attention", "flash_chunk"),
    "classification": ("normalize_u8",),
    "detection": ("normalize_u8",),
    "query_offload": (),
    "training": (),
    "native_pipeline": (),
    "tflite_models": (),
}


def _example_ok(torch, name, out) -> bool:
    """What each runner's output must be on the card."""
    import numpy as np

    if name == "long_context":
        return (out["stream"].shape == (1, 128, 16)
                and bool(np.isfinite(out["stream"]).all())
                and tuple(out["ring"].shape) == (2, 1024, 32)
                and tuple(out["ulysses"].shape) == (2, 8, 1024, 32)
                and bool(torch.isfinite(out["ring"]).all())
                and bool(torch.isfinite(out["ulysses"]).all()))
    if name == "classification":
        return len(out) == 2 and all(
            len(b) == 4 and all(lab.startswith("class") for lab in b)
            for b in out)
    if name == "detection":
        return out["overlay"].shape == (96, 96, 4) and \
            out["overlay"].dtype == np.uint8
    if name == "query_offload":
        return len(out) == 3 and all(
            np.array_equal(r, np.full(4, (i + 1) * 10.0, np.float32))
            for i, r in enumerate(out))
    if name == "training":
        return (out["saved"] and len(out["epochs"]) == 3
                and all(np.isfinite(e).all() for e in out["epochs"]))
    if name == "native_pipeline":
        return out == [(i, 3 * i) for i in range(4)]
    return len(out) == 4 and all(o.shape == (1, 1001)
                                 and np.isfinite(o).all() for o in out)


#: box corners of a detection on the card against the CPU's, in pixels
#: of the 96x96 overlay (bf16 on the card, float32 on the CPU)
BOX_PX_TOL = 2


def _example_matches_cpu(name, out, cpu) -> dict:
    """The classification and detection runners on the card against the
    same runner with ``--device cpu``: labels equal; objects equal in
    number and class, boxes within BOX_PX_TOL pixels."""
    if name == "classification":
        return {"labels_equal_cpu": out == cpu, "ok": out == cpu}
    got, want = out["objects"], cpu["objects"]
    same = len(got) == len(want) and all(
        g["class_id"] == w["class_id"] for g, w in zip(got, want))
    px = max((abs(g[k] - w[k]) for g, w in zip(got, want)
              for k in ("x", "y", "width", "height")), default=0)
    return {"objects": len(got), "objects_cpu": len(want),
            "classes_equal_cpu": same, "box_max_px_diff": px,
            "ok": same and px <= BOX_PX_TOL}


def check_examples(torch, results, workdir):
    """The seven runners of nnstreamer_tpu_torch/examples on the card, at
    their examples' sizes, each with the kernel launches it made (counts
    set to 0 just before it and read just after) and its output checked;
    classification and detection also against the same runner on the CPU
    (:func:`_example_matches_cpu`, outside the counted run); the .tflite
    runner on the full-width MobileNet-v2 file that testing/model_files.py
    writes."""
    import contextlib
    import importlib
    import io

    from nnstreamer_tpu_torch.ops import _cuda
    from nnstreamer_tpu_torch.testing import model_files

    tflite = os.path.join(workdir, "mobilenet_v2.tflite")
    model_files.write_mobilenet_v2_tflite(tflite, {"seed": "0"})
    args = {"tflite_models": [tflite, "4"]}
    total = {}
    for name, kernels in EXAMPLE_KERNELS.items():
        mod = importlib.import_module(f"nnstreamer_tpu_torch.examples.{name}")
        _cuda.reset_launches()
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            out = mod.main(args.get(name, []))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        _add_into(total, launches)
        ok = _example_ok(torch, name, out) and all(
            launches[k] > 0 for k in kernels)
        vs_cpu = {}
        if name in ("classification", "detection"):
            with contextlib.redirect_stdout(io.StringIO()):
                cpu = mod.main(["--device", "cpu"])
            vs_cpu = _example_matches_cpu(name, out, cpu)
            ok = ok and vs_cpu["ok"]
        emit("examples", runner=name, seconds=secs, launches=launches,
             printed=printed.getvalue().strip().splitlines(),
             vs_cpu=vs_cpu, ok=ok, card=results["card"])
        if not ok:
            raise AssertionError(f"examples: {name} failed: {launches}")
    results["examples_launches"] = total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nnstreamer_tpu_torch.ops import _cuda

    card = nvidia_smi()
    results = {"card": card}
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    workdir = tempfile.mkdtemp(dir=workdir)
    phases = {
        "elementwise": lambda: check_elementwise(torch, results),
        "kernel": lambda: check_fused_block(torch, results),
        "slice": lambda: check_slice(torch, results, workdir),
        "transform": lambda: check_transform(torch, results),
        "attention": lambda: check_attention(torch, results),
        "stream": lambda: check_stream(torch, results),
        "chunk": lambda: check_chunk(torch, results),
        "ring": lambda: check_ring(torch, results),
        "stream256": lambda: check_stream256(torch, results),
        "longctx": lambda: check_longctx(torch, results),
        "wide": lambda: check_wide_attention(torch, results),
        "vit": lambda: check_vit(torch, results, workdir),
        "detect": lambda: check_detect(torch, results, workdir),
        "segment": lambda: check_segment(torch, results),
        "vision": lambda: check_vision(torch, results, workdir),
        "upload": lambda: check_upload(torch, results, workdir),
        "batch": lambda: check_batch(torch, results),
        "hostspans": lambda: check_hostspans(torch, results, workdir),
        "serve": lambda: check_serve(torch, results, workdir),
        "streams": lambda: check_streams(torch, results, workdir),
        "residency": lambda: check_residency(torch, results, workdir),
        "train": lambda: check_train(torch, results, workdir),
        "loop": lambda: check_loop(torch, results, workdir),
        "edge": lambda: check_edge(torch, results, workdir),
        "chain": lambda: check_chain(torch, results, workdir),
        "robust": lambda: check_robust(torch, results, workdir),
        "mesh": lambda: check_mesh(torch, results, workdir),
        "tune": lambda: check_tune(torch, results, workdir),
        "aot": lambda: check_aot(torch, results, workdir),
        "rollout": lambda: check_rollout(torch, results, workdir),
        "deploy": lambda: check_deploy(torch, results, workdir),
        "import": lambda: check_import(torch, results, workdir),
        "train_vision": lambda: check_train_vision(torch, results),
        "custom": lambda: check_custom(torch, results, workdir),
        "native": lambda: check_native(torch, results, workdir),
        "probes": lambda: check_probes(torch, results),
        "examples": lambda: check_examples(torch, results, workdir),
    }
    only = None
    if "--only" in sys.argv[1:]:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
        unknown = sorted(set(only) - set(phases))
        if unknown:
            print(f"chip_smoke: unknown phases {unknown}; phases are "
                  f"{sorted(phases)}", file=sys.stderr)
            return 2
    t0 = time.perf_counter()
    # the native phase's three libraries (g++, at low priority) build on
    # the CPU beside the kernels' nvcc, and are done before any phase
    # measures
    native_build = None
    if only is None or "native" in only:
        pool = ThreadPoolExecutor(1)
        native_build = pool.submit(_build_native)
        pool.shutdown(wait=False)
    _cuda.lib()
    kernel_build_s = time.perf_counter() - t0
    if native_build is not None:
        futures_wait([native_build])
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), kernel_build_s=kernel_build_s,
         nvcc_s=_cuda.build_seconds,
         native_build_s=(None if native_build is None
                         else time.perf_counter() - t0))
    results["native_build"] = native_build
    phase_seconds = {}
    for name, run in phases.items():
        if only is None or name in only:
            t_run = time.perf_counter()
            run()
            phase_seconds[name] = time.perf_counter() - t_run
    emit("summary", phases=only or list(phases),
         seconds=time.perf_counter() - t0, phase_seconds=phase_seconds,
         card=card)
    if only is not None:
        return 0

    src = {"fused_inverted_residual": "nnstreamer_tpu_torch/csrc/fused_block.cu",
           "normalize_u8": "nnstreamer_tpu_torch/csrc/preprocess.cu",
           "arith_chain": "nnstreamer_tpu_torch/csrc/transform_ops.cu",
           "flash_attention": "nnstreamer_tpu_torch/csrc/attention.cu",
           "flash_chunk": "nnstreamer_tpu_torch/csrc/attention.cu"}
    rep = {"fused_inverted_residual": "nnstreamer_tpu/ops/fused_block.py:430",
           "normalize_u8": "nnstreamer_tpu/ops/preprocess.py:63",
           "arith_chain": "nnstreamer_tpu/ops/transform_ops.py:75",
           "flash_attention": "nnstreamer_tpu/ops/attention.py:180",
           "flash_chunk": "nnstreamer_tpu/ops/attention.py:347"}
    # launches summed over the main-path runs of every line
    launches = {name: sum(results[run].get(name, 0) for run in (
        "launches", "stream_launches", "stream256_launches",
        "vit_launches", "ring_launches",
        "longctx_launches", "upload_launches", "batch_launches",
        "hostspans_launches", "detect_launches", "detect_pp_launches",
        "segment_launches", "vision_launches", "serve_launches",
        "streams_launches", "residency_launches", "train_launches",
        "loop_launches", "edge_launches", "chain_launches",
        "robust_launches", "mesh_launches", "train_mesh_launches",
        "tune_launches", "aot_launches", "rollout_launches",
        "import_launches", "train_vision_launches", "custom_launches",
        "native_launches", "probes_launches", "examples_launches"))
        for name in src}
    launches["arith_chain"] += results["arith_launches"]
    kernels = []
    for name in src:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name],
            "replaces": rep[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            "device_ms": r.get("device_ms")})
    # rows 1 and 2 also run as TorchScript ops (csrc/torch_ops.cc) in the
    # native line: those launches, counted in C, are in "launches" too
    for row in kernels:
        if row["name"] in results.get("native_op_launches", {}):
            row["torchscript_op_launches"] = \
                results["native_op_launches"][row["name"]]
    # kernels 4 and 5 from head_dim 256 up: the head_dim 256 stream line's
    # shapes (the flash call, one ring call's 16 hops), then every timed
    # row of the wide phase
    kernels[3]["stream_hd256"] = results["flash_attention_hd256"]
    kernels[4]["stream_hd256"] = {
        key: results["flash_chunk_hd256"][key] for key in (
            "shape", "block_k", "max_abs_err", "ms", "device_ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by", "hops")}
    for row in kernels:
        wide = results.get("wide_attention", {}).get(row["name"], [])
        row["wide_head_dims"] = [
            {key: r[key] for key in (
                "d", "dtype", "causal", "shape", "slices", "block_k",
                "body", "max_abs_err", "ms", "device_ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by")}
            for r in wide if "ms" in r]
    # the fused block's rows at the SSD and DeepLab lines' shapes
    # arith_chain at the cascade's gap (128 x 1001 float32)
    kernels[2]["chain_gap"] = {key: results["arith_chain_gap"][key] for key in (
        "shape", "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
        "bound_ms", "bound_by")}
    kernels[0]["models"] = {name: results[f"fused_{name}"]
                            for name in ("ssd_mobilenet", "deeplab_v3",
                                         "ssd_mobilenet_batch1")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
