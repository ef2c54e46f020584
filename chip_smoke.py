"""GPU smoke run of the waifu2x_torch port: builds the CUDA kernels, holds
the conv stack's scale (B1) and noise (B2) input modes, its last layer's
dense (B6) and u8 (B3) output forms, its truncated form (B7), layer 6 as
int8 (B4) and as Winograd (B5) and the tensor-core kernel of layers 2-6
against their plain PyTorch versions, drives the scale, noise and
noise->scale paths and the frame-stream runtime at full model width, with
layer 6 in each of its forms, runs the data-movement probes (csrc/probe.cu)
and prints their numbers. Layer 1 of every stack call runs on csrc/l1.cu
(ops.stack.L1_LAUNCHES). Every stack call of every phase runs layers 2-6 on
the tensor cores, in bf16 on csrc/mma.cu and in f32 as 3xTF32 on
csrc/mma_tf32.cu. Layer 7 of every stack call runs folded (csrc/l7.cu:
bf16 on the tensor cores, f32 with FFMA; on the int8 layer 6's tile-major
planes too), counted by kernel in ops.stack.L7_LAUNCHES, which phases 4,
6-8, 10, 11 and 15 read, as they and every stream read L1_LAUNCHES. Under
the int8 switch layer 6 runs on the int8 tensor cores (csrc/i8.cu,
ops.stack.I8_LAUNCHES); under the Winograd switch on the tensor cores in
both types (csrc/wino.cu, ops.stack.WINO_LAUNCHES: f32 as 3xTF32). Under
the int8 switch layer 5 takes the tiles' maxima in its epilogue
(I8_LAUNCHES["l5max"]). stack_scale_upto's gather at upto 0..5 is
csrc/gather.cu's (ops.stack.GATHER_LAUNCHES).

    python3 chip_smoke.py          # needs one CUDA card; no arguments

Phases (any failure raises and exits non-zero):
  1. build csrc/gather.cu, csrc/mma.cu, csrc/wino.cu, csrc/l7.cu,
     csrc/probe.cu, csrc/tmm.cu, csrc/l1.cu, csrc/mma_tf32.cu, csrc/i8.cu
     and csrc/epi.cu with nvcc for sm_90a, all at once (ops/_build.py);
  2. f32 scale kernel vs plain version at small and odd shapes:
     max |diff| <= 3e-5;
  3. the scale kernel vs its plain version at the scale512 shape
     (16 x 512^2 low-res): f32 max |diff| <= 3e-5; bf16 max |diff| against
     the bf16 plain version <= 2^-4 (rounding ties flip a bf16 unit at
     some layer and propagate), and >= 50 dB PSNR (peak 1) against the
     f32 plain version;
  4. the scale512 main path with the shipped scale2.0x weights on 16
     seeded 512 x 512 BGR u8 frames: _to_yuv -> scale2x_batch_u8_fused ->
     d2s_host_cmajor, with the launch counter read around it; frames 0-1
     >= 50 dB against the port's f32 non-kernel path; then
     Converter.process_bgr_u8 on a 720 x 1280 image against the f32
     non-kernel Converter: x2 (bf16 kernel) >= 50 dB, x4 (two chained bf16
     stacks) >= 45 dB, x4 with f32 kernels >= 50 dB;
  5. the f32 noise kernel (stack_noise, and stack_noise_s2d at even
     shapes) vs its plain version at small and odd shapes: <= 3e-5; at the
     noise256 shape with the shipped noise1 weights: f32 <= 3e-5, bf16
     <= 2^-4 against the bf16 plain version and >= 50 dB against f32;
  6. the noise256 main path: 256 seeded 256 x 256 u8 frames with the
     noise1 weights, _to_yuv -> noise_batch_u8_fused -> d2s_host_cmajor at
     7 launches; frames 0-1 >= 50 dB against the f32 non-kernel noise_batch;
  7. the ns1080 chain: 4 seeded 1080 x 1920 frames with the noise2 and
     scale2.0x weights, noise_y_batch_fast(out_dtype=None) handed to
     scale2x_batch_u8_fused(y=...) at 14 launches; each of the 4 frames
     against the f32 non-kernel chain: >= 45 dB with both stacks bf16,
     >= 50 dB with an f32 noise stack and a bf16 scale stack (the
     Converter's auto policy);
  8. Converter mode="noise" (levels 1 and 2) and mode="noise_scale" under
     compute_dtype="auto" on a 720 x 1280 and an odd 721 x 1279 image:
     >= 50 dB against the f32 non-kernel Converter, launches a multiple of 7.
  9. the last layer's other output forms, f32 and bf16, at small and odd
     shapes and at scale512: stack_scale_dense un-chunked bit-equal to
     stack_scale, its pad columns zero, f32 within 3e-5 of its plain
     version; stack_scale_fused_u8 against its plain version: f32 |diff|
     <= 1 u8 level at < 0.5% of bytes, bf16 |diff| <= 15 levels (the 2^-4
     of the Y forms) and at scale512 >= 50 dB against the f32 plain
     version, lanes 12:16 zero; against the default tail on the scale512
     frames: f32 |diff| <= 1 at < 0.5%, bf16 |diff| <= 1 (the two round
     the same Y at another place) and PSNR against the f32 non-kernel
     path no lower than the default tail's less 0.1 dB;
 10. the scale stream, StreamConverter.process_frames on 64 seeded 512 x
     512 frames at batch 16, depth 2: with the default tail, with YDENSE
     (equal to the default bit for bit) and with FUSED_TAIL="kernel" (the
     stream's main path): every frame equal to the batch step's on the same
     batch, 7 launches per dispatch, frames 0-1 >= 50 dB against the f32
     non-kernel path;
 11. the noise stream (512 frames of 256 x 256 at batch 256, then an odd
     255 x 257 frame among even ones), the noise_scale stream built by
     from_params (8 frames of 1080 x 1920 at batch 8, which the volume cap
     cuts to 4; f32 noise stack; each frame >= 50 dB against the f32
     non-kernel chain) and a stream of three frame sizes interleaved
     (tail batches padded, output order equal to input order).
 12. the truncated stack (B7), stack_scale_upto for upto = 0..6 at (2,37,53),
     (1,5,300) and scale512, f32 and bf16, against its plain version: f32
     <= 3e-5, bf16 <= 2^-4; upto + 1 launches per call;
 13. Winograd layer 6 (B5), l6_wino=True: the tensor-core kernel alone
     (csrc/wino.cu, stack.wino_layer) against the plain version of its
     arithmetic (wino_layer_plain) at the layer-6 planes of (1,27,38),
     (2,37,53), (1,5,300), scale512 and noise256, to one bf16 ulp at the
     output's magnitude (the share of differing outputs printed); then the
     stacks, scale and noise input modes, at the small and odd shapes,
     scale512 and noise256: f32 (3xTF32, csrc/wino.cu) <= 3e-5 against its
     plain version and <= 1e-4 against the direct kernel; bf16 (tensor
     cores) <= 2^-4 against the bf16 plain version and, at the two main
     shapes, >= 50 dB against the f32 plain version; the kernel each call
     reached asserted from stack.WINO_LAUNCHES; both forms' PSNR on a
     pure-random plane printed;
 14. int8 layer 6 (B4), l6_i8=True, at equal tile, scale and noise input
     modes, a grid that pads both ways, a single tile, scale512 and
     noise256: (a) layer 6 alone, the int8 tensor-core kernel (csrc/i8.cu,
     one I8_LAUNCHES["mma"] a call, given the plane's tile maxima) and the
     plain version fed the same stored layer-5 plane (layer5_plane and
     l6_i8_layer, standalone wrappers, leave the stack counts LAUNCHES and
     KERNEL_LAUNCHES as they were): the quantised values and the int32 sums
     are then the same on both sides, so the two are held equal bit for
     bit, f32 and bf16, the tiles' scales too; (b) the
     whole stack: a quantiser tie that the f32 summation order of layers
     1-5 flips moves one int8 step, so in f32 kernel - plain is held
     against int8 - direct on the same input, its rms to a tenth and its
     max to a quarter, with at most 10% of outputs over 1e-5; in bf16 it
     is held to 2^-4;
 15. the product paths at full width under each layer-6 switch (stack.L6_WINO,
     stack.L6_I8): the scale512 batch step, the 64-frame scale512 stream
     under W2X_TAIL=kernel (equal to the batch step bit for bit, launches
     counted by kind, by layer-6 form and, for Winograd, by kernel: the
     tensor-core one on every bf16 call) and the noise256 batch step;
     frames 0-1 against the f32 non-kernel path: Winograd no lower than the
     direct form on the same frames less 1.5 dB (its U is rounded to bf16,
     the one rounding the direct form lacks) and reported against the 50 dB
     bar; int8 printed beside the QAT proxy (train.qat.l6_quant_gap_db)
     and held to >= 35 dB only: the shipped weights were not trained for
     int8, and the JAX package ships the mode opt-in for that reason. Then
     the two entry points that drive these configurations directly,
     tools.layer_time_probe (the upto ladder at the scale512 shape) and
     tools.i8_fidelity_probe.
 16. tools.mma_probe: the mma_chain kernel (64 back-to-back [M, 128] x
     [128, 128] bf16 products, f32 sums in registers) against its plain
     version, max |diff| <= 1e-4 of the largest output, and its TFLOP/s, the
     ceiling of the layers' inner loop;
 17. the tensor-core kernel of layers 2-6 (ops.stack.mma_layer) against its
     plain version from the packed weights (mma_layer_plain), in both of each
     layer's compiled chunk plans: all five widths at (1,27,38), (2,37,53)
     and (1,5,300) with random weights, and a chain of the five layers at
     the scale512 and noise256 layer shapes with the shipped weights, each
     layer fed the kernel's output of the one before: |diff| <= one bf16 ulp
     at the output's magnitude (or 1e-5, the f32 sums' own spread, where the
     terms cancel), the share of differing outputs printed. Then the whole
     scale512 stack and main path >= 50 dB against the f32 path, launches
     counted by kernel (5 "mma" per bf16 stack call); per-layer ms in two
     runs, with TFLOP/s and GB/s against both peaks, each layer's bound and
     the cuDNN time of the same five layers.
 18. the data-movement probes (ops/probe.py, csrc/probe.cu: probe_store,
     probe_fetch_map, probe_fetch_reduce, probe_l1_mm; the counterparts of
     15 pallas_call sites of the JAX package's tools/): every one of the 32
     variants against its plain version at its JAX tool's grid (B = 16 or 4,
     (8, 4) cells of (64, 128)), equal bit for bit (cin9mm and
     grid_floor's 4-fetch, whose f32 sums the kernel takes in another order,
     on inputs k / 256 that make every sum exact); then the slice's main
     path, tools.stage_time, tools.grid_floor_probe and tools.dma_probe
     (rounds 1-3), with the launch counts read around them (203 per
     variant: a check, then a warm-up and 100 timed launches captured into
     a CUDA graph, and the same issued one by one), each variant's bytes by
     its BlockSpecs and distinct bytes (neighbouring cells' blocks overlap
     in four variants), time (one replay of the graph, and one by one) and
     GB/s; a variant that moves its distinct bytes faster than 3.35 TB/s
     fails the phase (a fetch was dropped); each probe_store variant's time
     printed beside fill_'s, each probe_fetch_map variant's beside
     contiguous() of its view, which for the five maps that copy one block
     (probe.library_is_the_map) is first held equal to the kernel's output
     byte for byte. probe_fetch_reduce's traffic sum (every word its
     whole-block pass lands, mod 2^32) is held equal to
     probe.traffic_sum_plain for cin1, cin4, cin9 and 4-fetch; that kernel's
     and probe_l1_mm's variants are printed against their bounds, beside
     the library call and their first kernels' times (PERF.md section 6),
     and so are the seven variants that the router gives
     probe_fetch_map's persistent ring form (lane16_x4, lane128,
     lane128_x4, in16+o128, in128+o128, raw+o128, xonly; each launch's
     route as the C entry reports it, probe.MAP_ROUTES, held to be exactly
     these seven), each against its aim of twice its bound; the ring form
     in its wide geometry (rows wider than a slot, stripes wider than the
     head buffer; MAP_WIDE) held bit-equal to its plain version too.
 19. the truncation probes and the four-tap layer (phase19 below): tap_mm
     (csrc/tmm.cu, wgmma, persistent) in both layouts against its plain
     version bit for bit on inputs k / 16 (every f32 sum exact), at two
     small grids, the JAX tool's and one (odd tr, two segments a cell row)
     whose rows leave every block partial work units, and the two layouts
     equal on the same values permuted;
     stack_scale_upto's forms out="whole" (upto 0..5), "lane0" (0) and
     "phase_taps" (6, also after the Winograd layer 6) against their plain
     versions, f32 <= 3e-5 and bf16 <= 2^-4, with their launches counted;
     the truncation's two tap forms alone on layer 7's fold (csrc/l7.cu,
     launched as stack_scale_upto's upto 6 launches them: launch_taps)
     against the fold's plain version at three odd shapes and the scale512
     layer-6 plane and
     on B4's tile-major planes, bf16 to one bf16 ulp and f32 <= 3e-5, then
     timed alone at scale512 in both types, twice, beside the byte bound
     and cuDNN's stride-2 convolution; then the four tools
     (fused_strip_probe, k1_forensics, l14_probe, tmm_probe) at their JAX
     grids with the stack's, layer 7's (every launch on the fold) and the
     probes' launch counts read around each (the probe variants
     oneblk and xonly, which phase 18 held, are timed there). Phase 15
     reads layer 7's launches around tools.layer_time_probe the same way.
 20. the last three probe sites (phase20 below): csrc/mma.cu's zero-shift
     variants (ZS 1-3 of layers 2-6, all 15 built) against
     mma_layer_plain(zs) at (1,27,38), (2,37,53) and (1,5,300) to one bf16
     ulp, layer 7 under each mask folded (csrc/l7.cu) against
     l7_fold_plain(zs) (one bf16 ulp, f32 <= 3e-5), the two-accumulator
     variants (PP) bit for bit against the one-accumulator kernel at the
     scale512 layer shapes; the variants alone timed in turns at 4 x 512^2,
     layer 7 under each mask twice beside cuDNN's layer 7;
     stack_scale_pp, shift_stack and l4_shift against their plain versions
     at 4 x 512^2 (bf16 <= 2^-4), stack_scale_pp and shift_stack's base
     against stack_scale bit for bit; then tools.accpp_probe,
     shift_cost_probe (every mode's layer 7 on the fold: 84 fold launches)
     and l4_shift_probe with every launch count read around
     each, and stack_scale's counts checked unchanged.
 21. layer 7 folded on the tensor cores (phase21 below; csrc/l7.cu through
     stack.last_layer) against its plain version in its three forms at
     (1,27,38), (2,37,53), (1,5,300) and the scale512 and noise256 layer-7
     planes: s2d and dense to one bf16 ulp, dense un-chunked equal to s2d
     bit for bit, u8 by check_u8_kernel, one "fold" launch a call; then
     timed alone at scale512 in each form, twice, and at noise256, beside
     cuDNN's layer 7 alone, the plain version and the bound.
 22. the f32 layers 2-6 as 3xTF32 (phase22 below; csrc/mma_tf32.cu through
     stack.mma_layer) against the f32 plain version, each alone at
     (1,27,38), (2,37,53), (1,5,300) and chained at the ns1080 noise
     stack's layer shapes, max |diff| <= 3e-5, one "mma_tf32" launch a
     call; the f32 noise stack at ns1080 with 5 "mma_tf32" launches, timed
     layer by layer and whole, twice, against the 3xTF32 bound and the
     FFMA floor, beside cuDNN's f32 layers 2-6 and f32 stack (TF32 off);
 23. layer 1 (phase23 below; csrc/l1.cu through stack.l1_layer) against
     l1_plain, scale and noise, f32 and bf16, at three small shapes and at
     scale512 and noise256: bf16 to one bf16 ulp, f32 <= 3e-5; then timed
     twice, with GB/s against the byte bound and cuDNN's layer 1 on the
     padded plane.
 24. layer 7 of the f32 stacks folded with FFMA (phase24 below; csrc/l7.cu's
     l7_fold_f32 through stack.last_layer) against l7_fold_plain in its
     three forms at three small shapes and the ns1080 and scale512 f32
     layer-7 planes: s2d and dense <= 3e-5, dense un-chunked equal to s2d
     bit for bit, u8 one level at < 0.5% of bytes, one "fold_f32" launch a
     call; then each form held against last_layer_plain (the nine taps
     summed per pixel) and timed alone, twice, beside the byte bound,
     cuDNN's f32 layer 7 (TF32 off) and the plain version.
 25. B4's int8 layer 6 on the int8 tensor cores (phase25 below; csrc/i8.cu
     through stack.l6_i8_layer, given the tiles' maxima) timed alone at
     scale512 with the default tile, twice, beside its bound, the plain
     version and cuDNN's bf16 layer 6 (a different function); the timed
     plane's output equals the plain version's bit for bit.
 26. B4's layer 7 folded on the int8 layer 6's tile-major planes (phase26
     below; csrc/l7.cu through stack.last_layer_tiles) against
     l7_tiles_plain in its three forms and both types at three odd shapes
     and scale512 (bf16 one ulp, f32 3e-5, u8 by check_u8_kernel, dense ==
     s2d bit for bit), then held in s2d against the nine taps summed per
     pixel of each tile and timed alone at scale512, twice, beside the byte
     bound, cuDNN's layer 7 on the tile batch and the plain version.
 27. B5's f32 Winograd layer 6 as 3xTF32 (phase27 below; csrc/wino.cu's
     l6_wino_tf32 through stack.wino_layer) against _l6_wino_plain at 3e-5
     at three odd shapes and the ns1080 and scale512 layer-5 planes, the
     f32 dense and u8 stacks under l6_wino against theirs, then timed alone,
     twice, beside the direct 3xTF32 layer 6, cuDNN's f32 layer 6 and the
     bound; and the ns1080 f32 noise stack and f32-noise step under l6_wino
     against the direct form.
 28. the command line (phase28 below; waifu2x_torch.cli.main in this
     process, the shipped weights from the default model dir, the launch
     counts set to 0 before each call and read after it): a 720 x 1280 PNG
     in the default mode (noise_scale: the f32 noise stack, the bf16 scale
     stack) and a 512 x 512 PNG in scale mode, each bit-equal to
     Converter.process_bgr_u8 of the decoded file and >= 50 dB against the
     f32 non-kernel path, layer 1, layers 2-6 on the tensor cores and
     layer 7 folded launched, no probe variant; four
     512 x 512 PNGs in one call (the stream route), each at the u8 bar
     (|diff| <= 1 at < 0.2% of bytes) against the one-file call; --profile;
     StreamConverter.process_paths over the four with a frame cursor, then
     again (nothing launched, nothing written); a 1024 x 1024 PNG with
     --pallas off (the block tiler: its plane within 3e-5 of the monolithic
     F.conv2d plane, its output >= 50 dB against the kernel route's). It
     prints which codec each call used, the decode / convert / encode
     split, the four-file MP/s and the tiles, with the card's name and
     power limit, and adds each kernel's CLI launches to its row of the
     kernel table ("cli_launches").
 29. the multi-device layer (phase29 below; waifu2x_torch/parallel/):
     MeshPipeline over virtual meshes of the one card, (1, 1, 1),
     (2, 2, 2) and (1, 2, 4), with the shipped weights, against the single
     device: ns1080 noise_scale (the denoised plane bit-equal), scale512,
     ratio 4 and ratio 3 at 512^2 and noise256, each at the u8 bar
     (|diff| <= 1 at < 0.2% of bytes), the launch counts read around each
     call (the hand kernels only, one stack call a position and stack), the
     (2, 2, 2) shards' wrapper calls held against the plain versions; then
     Converter.from_config(Config(mesh="1x1")), a StreamConverter on a
     (1, 1, 1) mesh and the CLI with --mesh 1x1 against their one-device
     runs; the mesh steps timed in turns against the single-device steps,
     tools.scaling_probe's overhead, the halo redundancy and the peak
     memory, with the card's name and power limit; each mesh-path kernel's
     row gains "mesh_launches".
 30. training at full width (phase30 below; waifu2x_torch/train/, F.conv2d
     under autograd and torch.optim.Adam: no TPU kernel is on the training
     path): the 7-layer model at the reference's TrainConfig defaults
     (batch 32, crop 128, "highest"); one step on the card against the
     same step on the CPU (loss within 1e-6, params within 1e-5 but those
     whose gradient is under 1e-6, held to 2 x lr: hold_step); the MSE
     and QAT steps timed at "highest" and "default" with samples/s and
     peak memory; 50 steps on one batch lower the loss; the sharded step
     on the virtual meshes (2, 4) and (1, 8) against one device, MSE and
     QAT (hold_step, loss within 1e-5); a checkpoint's 2 + 2 steps within
     1e-5 of 4 straight; tools.train_demo warm-started from the shipped
     scale2.0x_demo weights with their QAT recipe, its held-out dB before
     and after, the layer-6 quantisation gap, the exported JSON through
     Converter.from_config at >= 50 dB against the f32 non-kernel path on
     the hand kernels only, and the scale512 int8 step's PSNR for the
     trained and the shipped weights (measured, not gated);
 31. the three fidelity tools (phase31 below): chain_fidelity_probe at
     512^2 (f32/f32 >= 50 dB), edge_error_probe at 512 and ns1080_probe at
     --iters 2, each with the launch counts read around it (the hand
     kernels only); their launches and phase 30's Converter run's go to
     each kernel row as "train_tools_launches".
 32. B7's gather and B4's tile maxima (phase32 below): the gather
     (csrc/gather.cu:upto_gather_tiled) through stack_scale_upto at upto
     0..5 in every output form, f32 and bf16, at (1, 27, 38), (2, 37, 53),
     (1, 5, 300), (1, 3, 2) and scale512, bit for bit against its plain
     version on the input it read; each mode's launch alone at scale512,
     twice, beside its byte bound, the plain version and the one-call
     library form (checked equal) where there is one. The tile maxima in
     layer 5's epilogue (stack.layer5_maxima: csrc/mma.cu, mma_tf32.cu) at
     the default tile and tiles (1, 1), (2, 3), (3, 5), a NaN among the
     inputs: x5 bit for bit the default layer 5's, m bit for bit
     tile_max_plain's; at scale512 layer 5 with and without them in turns;
     the B4 stack timed twice and the int8 step; a (2, 1, 1) mesh under
     l6_i8 byte-equal to one position, a maxima launch each;
 33. layers 2-6 on csrc/mma.cu's persistent kernel (phase33 below: layers
     2-5 with their weights resident, layer 6 split in two output halves)
     bit for bit against the tile kernel (persistent=False) at the
     benchmark cells' layer shapes (scale512, the chain's 2160 x 3840
     scale step, the sweep's 1440p and 4K bands) and four ragged shapes,
     each launch's route read in MID_LAUNCHES; each layer timed in turns
     against the tile kernel at scale512 and the chain's shapes; the
     plans' bytes staged from L2 a tile; one stack call's routes.
 34. UpCUNet's 3x3 layers on csrc/mma.cu (phase34 below; ops/stack.py:
     conv3x3_mma, keyed by (ci, co)): each of the ten layers of a 436-px
     tile that run there (32 -> 64, 64 -> 64, 64 -> 128 on vgg_7's
     instances, 128 -> 64 on its own) at its plane in that tile, two
     tiles, against mma_layer_plain within one bf16 ulp (check_mma_layer),
     each call one launch on its plan's route by MMA_SHAPES; then one
     upcunet2x_batch_u8 dispatch of a 1080p frame, its launches by (ci, co,
     route) the ten layers' once a chunk of tiles.
 35. UpCUNet's library-layer epilogue on csrc/epi.cu (phase35 below;
     ops/unet.py:cunet_epilogue): each of the twelve library layers of a
     436-px tile, two tiles, its cuDNN output without the bias, bit for bit
     against cunet_epilogue_plain (on the CPU) and against the three
     PyTorch passes it replaces, on that output and as the layer computed
     them (the bias in the cuDNN call); each launch counted by mode in
     EPI_LAUNCHES; each layer timed at 16 tiles against its byte bound and
     the three passes; then one upcunet2x_batch_u8 dispatch of a 1080p
     frame, its launches 7 bias + leaky, 3 with the skip, 2 bias alone, its
     u8 output bit for bit that of the same dispatch with the three passes.
Phase 15 also runs the ns1080 chain with its f32 noise stack under the
Winograd switch (the f32 stack on l6_wino_tf32, the bf16 one on
l6_wino_mma) and gates the scale512 int8 step and stream at 50 dB.
In phase 7 the f32-noise chain's layers 2-6 count 5 "mma_tf32" (the noise
stack) and 5 "mma" (the bf16 scale stack), its layer 7 one "fold_f32" and
one "fold", and the ns1080 timings give the f32-noise step and stack,
twice each, with the noise stack's per-layer events. Phase 8 holds every
Converter call's layer 7 to the folds (f32 for the noise stack of the
default noise_scale policy).
In phases 4, 6-8, 10-11 and 15 every call that the run made to a kernel wrapper
(one per wrapper, input shape, dtype and weights) is repeated on a copy of
its input and held against the plain version: f32 max |diff| <= 3e-5; bf16
max |diff| <= 2^-4 against the bf16 plain version and >= 50 dB against the
f32 plain version with the model's f32 weights; the u8 wrapper at phase 9's
bars; the dense wrapper also bit-equal to stack_scale; under the int8 switch the
bf16 bar against the f32 plain version is phase 15's 35 dB.
Calls on frames of more than 1 M pixels are held on their first frame. Then
timings with CUDA events (bf16 stacks on the tensor-core layers) for
scale512 (each tail, each last-layer form,
each layer-6 form, layer 6 alone: the tensor-core Winograd kernel twice,
beside the direct tensor-core layer and cuDNN's layer 6, the truncation's
own launches), noise256 and ns1080,
cuDNN bf16 yardsticks the port never calls, and for each stream its wall
time beside the sum of its device step times.

The last line of stdout is {"ok": true, "device": {...}}; the line before it
is the kernel table as JSON (u8 kernels give max_abs_err in u8 levels; a
probe kernel's ms, plain_ms, bound_ms and library_ms are the sums over its
variants, and "variants" lists each one's).
Without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import logging
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

F32_TOL = 3e-5
BF16_TOL = 2.0 ** -4
PSNR_BAR = 50.0
# x4 runs two bf16 stacks in a chain; each rounds its activations to bf16,
# and the second amplifies the first's error, so the single-stack 50 dB
# bar does not apply to the chain. The same chain with f32 kernels is
# held to 50 dB.
CHAIN_BAR = 45.0
# The u8 kernel and its plain version take the same f32 steps from Y to the
# byte (the kernel's colour map is written without fmaf), so they differ
# only where the convolutions' summation order moves a value across a
# rounding tie: one level, at few bytes.
U8_MAX = 1
U8_FRAC = 0.005
# In bf16 storage a tie flips a bf16 unit of some activation and the flip
# propagates, as in the Y-output forms: their bar on Y, BF16_TOL, in u8
# levels, with no bar on how many bytes differ (the count is printed).
U8_BF16_MAX = int(BF16_TOL * 255)
# Winograd against the direct kernel in f32: two factorisations of one
# layer, each within F32_TOL of its own plain version; the JAX suite holds
# the same pair to 1e-5 at 32 x 32 with unit-scale random weights.
WINO_VS_DIRECT_TOL = 1e-4
WINO_DB_SLACK = 1.5   # dB under the direct form on the same frames
I8_BAR = 35.0         # dB, int8 with weights that were not trained for it
# probe_fetch_reduce's and probe_l1_mm's first kernels, ms at the tools'
# grids on an H100 80GB HBM3 at 700 W (PERF.md section 6), printed beside
# the present kernels' times
PROBE_FIRST_FORM_MS = {"cin1": 0.0986, "cin4": 0.1862, "cin9": 0.0769,
                       "4-fetch": 0.2333, "cin9mm": 0.4055,
                       # probe_fetch_map's earlier row-split form, whose
                       # variants now run on its persistent ring form
                       "lane16_x4": 0.0351, "lane128": 0.0233,
                       "lane128_x4": 0.0308, "in16+o128": 0.0197,
                       "in128+o128": 0.0262, "raw+o128": 0.0085,
                       "xonly": 0.0364}
# the fetch_map variants on the ring form (csrc/probe.cu:
# w2x_probe_fetch_map, which reports each launch's route)
MAP_RING = ("lane16_x4", "lane128", "lane128_x4", "in16+o128", "in128+o128",
            "raw+o128", "xonly")
# the ring form's wide geometry (csrc/probe.cu: fm_geometry), at grids no
# tool runs: a tile row and its right stripe's wider than a slot (tc 1024),
# the stripes wider than the head buffer (tc 256), one block of 32 KB rows
MAP_WIDE = (("lane16_x4", (1, 2, 3, 16, 1024)), ("xonly", (1, 3, 2, 64, 256)),
            ("lane128", (1, 2, 3, 16, 1024)),
            ("in16+o128", (1, 2, 3, 16, 1024)))
# The int8 kernel against its plain version over a whole stack, in f32: the
# two quantise the same layer-5 values except where the summation order of
# layers 1-5 moves one across a rounding tie of the quantiser, and such a
# flip moves one int8 step. Held against what int8 itself costs on the same
# input (int8 - direct): the rms to a tenth, the largest single difference
# to a quarter (one flip against the sum of a window's rounding errors; the
# largest of 16.7 M outputs measured 0.12 of it at scale512, 0.05 at the
# small shapes), and the share of outputs that move by over 1e-5 to 10%
# (measured 1.7-2.9%; an error in the arithmetic would move them all).
I8_TIE_RMS = 0.1
I8_TIE_MAX = 0.25
I8_TIE_OUTPUTS = 0.1


def log(*args):
    print(*args, flush=True)


def timed_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up run."""
    from waifu2x_torch.utils.timing import time_ms
    return time_ms(lambda _: fn(), torch.device("cuda"), reps)


def psnr1(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.double() - b.double()) ** 2).item()
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def structured_bgr(rng: np.random.Generator, n: int, h: int, w: int):
    """Seeded u8 BGR frames with image-like structure: a smooth random
    field (bilinear upscale of a coarse grid) plus sensor-like noise."""
    coarse = torch.from_numpy(rng.random((n, 3, h // 32 + 1, w // 32 + 1),
                                         dtype=np.float32))
    smooth = F.interpolate(coarse, size=(h, w), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1).numpy()
    img = smooth * 255.0 + rng.normal(0.0, 6.0, (n, h, w, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def check_max_err(what: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{what}: max |diff| {err} > {tol}")


def check_u8(what: str, got: torch.Tensor, ref: torch.Tensor,
             max_level: int = U8_MAX, max_frac: float = U8_FRAC):
    """Hold two u8 tensors to |diff| <= max_level at under max_frac of
    bytes; returns (max |diff|, fraction of bytes that differ)."""
    if (got.shape != ref.shape or got.dtype != torch.uint8
            or ref.dtype != torch.uint8):
        raise AssertionError(f"{what}: {got.shape} {got.dtype} against "
                             f"{ref.shape} {ref.dtype}")
    diff = (got.to(torch.int16) - ref.to(torch.int16)).abs()
    worst, frac = diff.max().item(), (diff != 0).float().mean().item()
    if not (worst <= max_level and frac < max_frac):
        raise AssertionError(f"{what}: max |diff| {worst}, {frac:.3%} of "
                             f"bytes differ")
    return worst, frac


def check_u8_kernel(what: str, got, ref, dtype):
    """check_u8 at the u8 kernel's bar against its plain version: f32 one
    level at under U8_FRAC of bytes, bf16 U8_BF16_MAX levels."""
    if dtype == torch.float32:
        return check_u8(what, got, ref)
    return check_u8(what, got, ref, U8_BF16_MAX, 1.01)


def check_lanes_zero(what: str, u8: torch.Tensor) -> None:
    if u8[..., 12:].any().item():
        raise AssertionError(f"{what}: lanes 12:16 are not all zero")


def check_dense_pad(what: str, ydense: torch.Tensor, tc: int, wl: int):
    n, hl, wd = ydense.shape
    nx = wd // (4 * tc)
    pad = ydense.reshape(n, hl, nx, 4, tc)[:, :, -1, :, wl - (nx - 1) * tc:]
    if nx != -(-wl // tc) or pad.any().item():
        raise AssertionError(f"{what}: pad columns are not all zero")


# wrapper -> position of the weights among its arguments
WRAPPERS = {"stack_scale": 1, "stack_noise_s2d": 1, "stack_noise": 1,
            "stack_scale_dense": 1, "stack_scale_fused_u8": 2}
HOLD_PX = 1e6   # calls on larger frames are held on their first frame


def record_wrapper_calls(pipeline_mod, seen: dict):
    """Route the pipeline's calls of the stack wrappers through a recorder
    that keeps a copy of the first tensor arguments at each (wrapper,
    shape, dtype, weights) in `seen`. Returns a function that restores the
    wrappers."""
    orig = {name: getattr(pipeline_mod, name) for name in WRAPPERS}

    def recorder(name):
        def call(*args, **kw):
            x, sp = args[0], args[WRAPPERS[name]]
            key = (name, tuple(x.shape), x.dtype, id(sp))
            if key not in seen:
                seen[key] = tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args)
            return orig[name](*args, **kw)
        return call

    for name in WRAPPERS:
        setattr(pipeline_mod, name, recorder(name))
    return lambda: [setattr(pipeline_mod, n, f) for n, f in orig.items()]


def in_chunks(fn, x: torch.Tensor, scale: bool) -> torch.Tensor:
    """torch.cat of fn(i0, i1) over frame ranges sized so that a plain
    version's 128-channel f32 activations stay near 4 GB (the plain
    versions are frame-independent)."""
    out_px = x.shape[1] * x.shape[2] * (4 if scale else 1)
    c = max(1, int(4e9 // (128 * 4 * out_px)))
    return torch.cat([fn(i, i + c) for i in range(0, x.shape[0], c)])


def plain_in_chunks(plain, x: torch.Tensor, sp, scale: bool) -> torch.Tensor:
    """plain(x, sp) as f32, a few frames at a time."""
    return in_chunks(lambda i, j: plain(x[i:j], sp).float(), x, scale)


def hold_seen(seen: dict, stack, f32_twin, max_err: dict,
              psnr_bar: float = PSNR_BAR) -> None:
    """Repeat every recorded wrapper call on its input and hold the kernel
    against its plain version: f32 max |diff| <= F32_TOL; bf16 max |diff|
    <= BF16_TOL against the bf16 plain version and >= psnr_bar against the
    f32 plain version with the model's f32 weights (both sides with layer 6
    in the form the stack module's switches select). stack_scale_dense is
    un-chunked first and must also equal stack_scale bit for bit;
    stack_scale_fused_u8 is held by check_u8_kernel, its bf16 form also
    to PSNR_BAR (peak 255) against the f32 plain version. Calls on frames of
    more than HOLD_PX pixels are held on their first frame. `max_err` collects
    the largest |diff| per wrapper."""
    for (name, shape, dtype, _), args in seen.items():
        x, sp = args[0], args[WRAPPERS[name]]
        if x.shape[1] * x.shape[2] > HOLD_PX:
            x = x[:1].contiguous()
        n, hl, wl = x.shape
        msg = f"  held {name} {tuple(x.shape)} of {shape} {dtype}: "
        if name == "stack_scale_fused_u8":
            uvp = args[1][:n].contiguous()
            got = stack.stack_scale_fused_u8(x, uvp, sp)
            check_lanes_zero(f"{name} at {shape}", got)
            err, frac = check_u8_kernel(f"{name} at {shape}", got, in_chunks(
                lambda i, j: stack.stack_scale_fused_u8_plain(
                    x[i:j], uvp[i:j], sp), x, True), dtype)
            msg += f"max|kernel - plain| = {err} level, {frac:.4%} of bytes"
            if dtype != torch.float32:
                sp32 = f32_twin(sp)
                db = 20 * np.log10(255.0) + psnr1(got, in_chunks(
                    lambda i, j: stack.stack_scale_fused_u8_plain(
                        x[i:j].float(), uvp[i:j], sp32), x, True))
                msg += f"; vs f32 plain {db:.2f} dB"
                if not db >= psnr_bar:
                    raise AssertionError(f"bf16 {name} at {shape}: {db} dB")
        else:
            plain_name, scale = name + "_plain", name == "stack_scale"
            if name == "stack_scale_dense":
                ydense, tc = stack.stack_scale_dense(x, sp, *args[2:])
                check_dense_pad(f"{name} at {shape}", ydense, tc, wl)
                got = stack.dense_to_s2d(ydense, tc, hl, wl)
                if not torch.equal(got, stack.stack_scale(x, sp)):
                    raise AssertionError(f"{name} at {shape}: un-chunked "
                                         f"output differs from stack_scale")
                msg += "bit-equal to stack_scale; "
                plain_name, scale = "stack_scale_plain", True
                got = got.float()
            else:
                got = getattr(stack, name)(x, sp).float()
            plain = getattr(stack, plain_name)
            err = (got - plain_in_chunks(plain, x, sp, scale)
                   ).abs().max().item()
            msg += f"max|kernel - plain| = {err:.3e}"
            if dtype == torch.float32:
                check_max_err(f"{name} at {shape}", err, F32_TOL)
            else:
                db = psnr1(got, plain_in_chunks(plain, x.float(),
                                                f32_twin(sp), scale))
                msg += f"; vs f32 plain {db:.2f} dB"
                if not (err <= BF16_TOL and db >= psnr_bar):
                    raise AssertionError(f"bf16 {name} at {shape}: {err} "
                                         f"abs, {db} dB")
        max_err[name] = max(max_err.get(name, 0.0), err)
        log(msg)
        del got
        torch.cuda.empty_cache()
    seen.clear()


def run_stream(sc, frames, stack, label: str, smi: str):
    """Drive sc.process_frames(frames) once with the launch counts set to
    0 just before, timing each dispatch's device step with CUDA events and,
    on the host's clock, the time spent inside _dispatch (the pinned fill
    and every enqueue) and inside _interleave. Returns (outputs, launches
    by kernel configuration, dispatches)."""
    steps, host_s = [], {"dispatch": 0.0, "interleave": 0.0}
    step, dispatch, interleave = sc._step, sc._dispatch, sc._interleave

    def timed_step(yuv):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = step(yuv)
        ev[1].record()
        steps.append(ev)
        return out

    def on_host(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            host_s[name] += time.perf_counter() - t0
            return out
        return call

    sc._step = timed_step
    sc._dispatch = on_host("dispatch", dispatch)
    sc._interleave = on_host("interleave", interleave)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stack.reset_launches()
    t0 = time.perf_counter()
    outs = list(sc.process_frames(frames))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(stack.KERNEL_LAUNCHES)
    mid = dict(stack.MID_LAUNCHES)
    l7 = dict(stack.L7_LAUNCHES)
    sc._step, sc._dispatch, sc._interleave = step, dispatch, interleave
    if sum(counts.values()) != stack.LAUNCHES:
        raise AssertionError(f"{label}: launch counts {counts} do not add "
                             f"up to {stack.LAUNCHES}")
    dev_s = sum(a.elapsed_time(b) for a, b in steps) / 1e3
    out_px = sum(o.shape[0] * o.shape[1] for o in outs)
    log(f"stream {label} on {smi}: {len(frames)} frames in {len(steps)} "
        f"dispatches, launches {counts}, layers 2-6 by kernel {mid}, layer "
        f"7 by kernel {l7}; wall "
        f"{wall:.3f} s = "
        f"{len(frames) / wall:.2f} frames/s = {out_px / wall / 1e6:.2f} "
        f"output MP/s; device steps {dev_s:.3f} s "
        f"({100 * dev_s / wall:.1f}% of wall, host share "
        f"{wall - dev_s:.3f} s); host time in dispatch "
        f"{host_s['dispatch']:.3f} s, in interleave "
        f"{host_s['interleave']:.3f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if len(outs) != len(frames):
        raise AssertionError(f"{label}: {len(outs)} outputs for "
                             f"{len(frames)} frames")
    # layers 2-6 of every stack call (2-5 where layer 6 is int8 or
    # Winograd), on the tensor cores (as 3xTF32 where the stack is f32)
    # (an int8 stack call's layer 6 is the int8 layer's launch)
    other_l6 = stack.I8_LAUNCHES["mma"] + stack.L6_LAUNCHES["wino"]
    stacks = stack.LAUNCHES // 7
    if (mid["mma"] + mid["mma_tf32"] != 5 * stacks - other_l6
            or mid["chain"]):
        raise AssertionError(f"{label}: layers 2-6 launches {mid} of "
                             f"{stack.LAUNCHES}")
    # one layer 7 a stack call, folded (the int8 layer 6's tile-major
    # planes included)
    if sum(l7.values()) != stacks:
        raise AssertionError(f"{label}: layer-7 launches {l7} for "
                             f"{stacks} stack calls")
    expect_l1(stack, label, stacks)   # and one layer 1, on csrc/l1.cu
    return outs, counts, len(steps)


def per_layer_ms(run, stack) -> np.ndarray:
    """Per-layer device ms of run(events) (a wrapper call that records 8
    CUDA events), averaged over 3 runs after the caller's warm-up."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    ms = np.zeros(len(stack.WIDTHS))
    for _ in range(3):
        run(events)
        torch.cuda.synchronize()
        ms += [events[k].elapsed_time(events[k + 1]) / 3
               for k in range(len(stack.WIDTHS))]
    return ms


def layer_rates(ms_per_layer, stack, n, hl, wl, l1_in_px, itemsize=2):
    """Per layer: FLOPs over the planes it really computes (the padded
    borders included) and its activation bytes, read once + written once.
    Returns (one-line report, activation bytes per call)."""
    rates, act_bytes = [], 0
    for k, (ms, (ci, co)) in enumerate(zip(ms_per_layer, stack.WIDTHS)):
        hin, win = 2 * hl + 14 - 2 * k, 2 * wl + 14 - 2 * k
        flop_k = 2 * n * (hin - 2) * (win - 2) * ci * co * 9
        in_px = l1_in_px if k == 0 else hin * win
        bytes_k = itemsize * n * (in_px * ci + (hin - 2) * (win - 2) * co)
        act_bytes += bytes_k
        rates.append(f"L{k + 1} {ms:.2f} ms {flop_k / ms / 1e9:.2f} TFLOP/s "
                     f"{bytes_k / ms / 1e6:.1f} GB/s")
    return "; ".join(rates), act_bytes


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of bf16 (8 significant bits) at |v|."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
                      - 7)


MMA_SUM_SPREAD = 1e-5   # what two f32 summation orders differ by at order 1


def check_mma_layer(what: str, got: torch.Tensor, ref: torch.Tensor):
    """Hold a tensor-core layer's bf16 output to its plain version's: the
    two sum the same exact products in another order, so they differ by at
    most one bf16 ulp at the output's magnitude, or by MMA_SUM_SPREAD where
    the terms cancel to less than that. Returns (max |diff|, share of
    outputs that differ)."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {got.shape} {got.dtype} against "
                             f"{ref.shape} {ref.dtype}")
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    tol = bf16_ulp(torch.maximum(g.abs(), r.abs())).clamp_min(MMA_SUM_SPREAD)
    if not bool((diff <= tol).all()) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: max |diff| {diff.max().item()}, "
                             f"{(diff > tol).float().mean().item():.3%} of "
                             f"outputs over one bf16 ulp")
    return diff.max().item(), (diff > 0).float().mean().item()


def mma_plain_in_chunks(stack, x: torch.Tensor, wp, b) -> torch.Tensor:
    """stack.mma_layer_plain a few frames at a time, so that its f32 copies
    stay near 2 GB each."""
    c = max(1, int(2e9 // (x[0].numel() // x.shape[3]
                           * max(x.shape[3], wp.shape[2]) * 4)))
    return torch.cat([stack.mma_layer_plain(x[i:i + c], wp, b)
                      for i in range(0, x.shape[0], c)])


def mid_bounds(stack, n: int, hl: int, wl: int):
    """Per layer 2-6 at an [n, hl, wl] low-res batch: (FLOPs, bytes, bound
    ms, bound_by), the bytes being the bf16 input, weights and output once
    each, the bound the larger of FLOPs at the bf16 tensor-core peak and
    bytes at the memory rate."""
    out = []
    for k in range(1, 6):
        ci, co = stack.WIDTHS[k]
        hin, win = 2 * hl + 14 - 2 * k, 2 * wl + 14 - 2 * k
        flops = 2 * n * (hin - 2) * (win - 2) * ci * co * 9
        moved = (2 * n * (hin * win * ci + (hin - 2) * (win - 2) * co)
                 + 2 * 9 * ci * co + 4 * co)
        t_ops, t_b = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
        out.append((flops, moved, max(t_ops, t_b),
                    "operations" if t_ops >= t_b else "bytes"))
    return out


def cudnn_layers(pairs) -> list:
    """(w OIHW channels_last, b) in bf16 of the stack's (w, b) pairs, as
    the library yardsticks' F.conv2d takes them."""
    return [(w.float().reshape(w.shape[0], 3, 3, w.shape[2])
             .permute(3, 0, 1, 2).to(torch.bfloat16)
             .contiguous(memory_format=torch.channels_last),
             b.to(torch.bfloat16)) for w, b in pairs]


def library_mid_ms(sp16, n: int, hl: int, wl: int) -> float:
    """Library yardstick (never called by the port): layers 2-6 alone as
    cuDNN bf16 channels_last convolutions + leaky_relu on a random layer-1
    activation of the batch's shape."""
    layers = cudnn_layers(sp16[1:6])
    x1 = torch.rand((n, 32, 2 * hl + 12, 2 * wl + 12), device=sp16[0][0].device
                    ).to(torch.bfloat16).contiguous(
                        memory_format=torch.channels_last)

    def library_mid():
        h = x1
        for w, b in layers:
            h = F.leaky_relu(F.conv2d(h, w, b), 0.1)
        return h

    ms = timed_ms(library_mid)
    del x1, layers
    torch.cuda.empty_cache()
    return ms


def library_l6_ms(x5: torch.Tensor, sp16) -> float:
    """Library yardstick (never called by the port): layer 6 alone as one
    cuDNN bf16 channels_last convolution + leaky_relu, TF32 off, on the
    NHWC layer-5 plane x5 (a channels_last view, no copy)."""
    from waifu2x_torch.ops.convstack import no_tf32
    (w, b), = cudnn_layers(sp16[5:6])
    xc = x5.permute(0, 3, 1, 2)
    with no_tf32():
        ms = timed_ms(lambda: F.leaky_relu(F.conv2d(xc, w, b), 0.1))
    torch.cuda.empty_cache()
    return ms


def library_stack_ms(plane16: torch.Tensor, sp16, post=None,
                     upto: "int | None" = None) -> float:
    """Library yardstick (never called by the port): the same 7-conv stack
    as cuDNN bf16 channels_last on a plane already replicate-padded by 7
    ([N, H, W] bf16), followed by post(Y [N, H-14, W-14]) where given. With
    `upto` the chain stops after that layer and post gets its whole output
    [N, C, H', W']."""
    layers = cudnn_layers(sp16 if upto is None else sp16[:upto])
    xpad = plane16[:, None].contiguous(memory_format=torch.channels_last)

    def library_stack():
        h = xpad
        for w, b in layers:
            h = F.leaky_relu(F.conv2d(h, w, b), 0.1)
        if post is None:
            return h
        return post(h[:, 0] if upto is None else h)

    ms = timed_ms(library_stack)
    del xpad, layers
    torch.cuda.empty_cache()
    return ms


def tap_kernel(w7: torch.Tensor) -> torch.Tensor:
    """Layer 7's same-cell taps (stack_scale_upto at upto = 6) as one
    stride-2 convolution: [4, 128, 2, 2] bf16, phase a*2+b holding tap
    (dy, dx) of w7 [128, 9, 1] for dy < 2 - a, dx < 2 - b."""
    k = torch.zeros((4, 128, 2, 2), device=w7.device)
    for a in (0, 1):
        for b in (0, 1):
            for dy in range(2 - a):
                for dx in range(2 - b):
                    k[a * 2 + b, :, dy, dx] = w7[:, dy * 3 + dx, 0].float()
    return k.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def stack_bound(plane: torch.Tensor, out_px: int, sp, maccs: int,
                io_bytes: "int | None" = None):
    """(bound ms, bound_by, FLOPs) of one stack call: its FLOPs at the bf16
    peak against the bytes it must move (the input plane, the weights and Y,
    each once) at the memory rate. `io_bytes` replaces the bytes of the
    plane and Y where a call reads or writes other arrays."""
    item = plane.element_size()
    flops = 2 * maccs * out_px
    if io_bytes is None:
        io_bytes = plane.numel() * item + out_px * item
    moved = io_bytes + sum(
        w.numel() * w.element_size() + b.numel() * 4 for w, b in sp)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops


TAP_FORMS = ("cell", "phase_taps")   # stack_scale_upto's names at upto 6


def launch_taps(stack, x: torch.Tensor, sp, out: str,
                image=None) -> torch.Tensor:
    """stack_scale_upto's tap form `out` alone, launched as its upto 6
    launches it (the stack's launcher, _Launcher.taps: the fold): x the
    layer-6 plane [N, 2hl+2, 2wl+2, 128],
    or with image = (hl, wl) B4's tile-major planes [N, ny, nx, 2tr+2,
    2tc+2, 128] -> [N, hl, wl, 4] in x's dtype."""
    if image is None:
        n, h6, w6 = x.shape[:3]
        hl, wl, tiling = (h6 - 2) // 2, (w6 - 2) // 2, None
    else:
        (n, ny, nx, h6, w6), (hl, wl) = x.shape[:5], image
        tiling = ((h6 - 2) // 2, (w6 - 2) // 2, ny, nx)
    y = torch.empty((n, hl, wl, 4), dtype=x.dtype, device=x.device)
    stack._Launcher(None, x, None).taps(x, sp, y, n, hl, wl, out, tiling)
    return y


def taps_alone(dev: torch.device) -> dict:
    """Phase 19's tap forms (stack_scale_upto at upto 6 ends in them) alone
    on the fold (csrc/l7.cu, launch_taps): held against the fold's plain
    version (_last_taps_plain)
    at (1,27,38), (2,37,53), (1,5,300) and the scale512 layer-6 plane, and
    on B4's tile-major planes at (2,37,53) and scale512, bf16 to one bf16
    ulp (check_mma_layer), f32 <= 3e-5, one "fold" / "fold_f32" launch a
    call, counted under its form in TAP_LAUNCHES; then each form timed
    alone at scale512 in both types, twice, beside the byte bound, one cuDNN
    call for the same function (TF32 off) and the plain version. Returns
    the numbers by form and type."""
    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.ops import stack
    from waifu2x_torch.ops.convstack import no_tf32
    from waifu2x_torch.utils.timing import time_ms

    gen = torch.Generator(device=dev).manual_seed(16)   # planes made there
    res = {(out, dt): {"max_abs_err": 0.0} for out in TAP_FORMS
           for dt in ("bf16", "f32")}
    for dt in (torch.bfloat16, torch.float32):
        key = "bf16" if dt == torch.bfloat16 else "f32"
        sp = stack.prep_params(init_params(3), dt, dev)
        kern = "fold" if dt == torch.bfloat16 else "fold_f32"
        for shape in ((1, 27, 38), (2, 37, 53), (1, 5, 300), (16, 512, 512)):
            n, hl, wl = shape
            x6 = (torch.rand((n, 2 * hl + 2, 2 * wl + 2, 128), generator=gen,
                             device=dev) * 2 - 1).to(dt)
            for out in TAP_FORMS:
                stack.reset_launches()
                got = launch_taps(stack, x6, sp, out)
                torch.cuda.synchronize()
                tap = "ptaps" if out == "phase_taps" else "taps"
                if stack.L7_LAUNCHES != {k: int(k == kern) for k in
                                         stack.L7_LAUNCHES} or (
                        stack.TAP_LAUNCHES != {k: int(k == tap) for k in
                                               stack.TAP_LAUNCHES}):
                    raise AssertionError(f"{out} {shape}: "
                                         f"{stack.L7_LAUNCHES} "
                                         f"{stack.TAP_LAUNCHES}")
                ref = stack._last_taps_plain(x6, sp, out)
                what = f"phase 19 {out} alone {shape} {key}"
                if dt == torch.bfloat16:
                    err, share = check_mma_layer(what, got, ref.to(dt))
                else:
                    err, share = check_f32(what, got, ref), None
                res[out, key]["max_abs_err"] = max(
                    res[out, key]["max_abs_err"], err)
                log(f"{what}: max|fold - plain| = {err:.3g}"
                    + ("" if share is None else f", {share:.4%} differ"))
                del got, ref
            if shape[0] < 16:
                continue
            # timed alone at scale512
            w7 = sp[6][0]
            k4 = (w7[:, 0:4, 0].t().float().reshape(4, 128, 1, 1).to(dt)
                  .contiguous(memory_format=torch.channels_last))
            kt = tap_kernel(w7).to(dt).contiguous(
                memory_format=torch.channels_last)
            xc = x6.permute(0, 3, 1, 2)
            item = x6.element_size()
            for out in TAP_FORMS:
                turns = [time_ms(lambda k, o=out: launch_taps(
                    stack, x6, sp, o), dev, 10) for _ in range(2)]
                lib_k = k4 if out == "phase_taps" else kt
                with no_tf32():
                    lib = time_ms(lambda k, w=lib_k: F.conv2d(xc, w, stride=2),
                                  dev, 10)
                t0 = time.perf_counter()
                stack._last_taps_plain(x6, sp, out).to(dt)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                # the pixels the function reads (pixel (0, 0) of each cell,
                # or all four), once, and its output, once
                px = n * hl * wl * (1 if out == "phase_taps" else 4)
                bound = (px * 128 + n * hl * wl * 4) * item / PEAK_BYTES * 1e3
                res[out, key].update({
                    "ms": sum(turns) / 2, "turns": turns,
                    "bound_ms": bound, "library_ms": lib,
                    "plain_ms": plain_ms})
                log(f"phase 19 {out} alone at scale512 {key}, twice: "
                    + " / ".join(f"{t:.4f}" for t in turns)
                    + f" ms; bound {bound:.4f} ms by bytes "
                    f"({100 * bound / res[out, key]['ms']:.1f}% of it), "
                    f"cuDNN stride-2 conv {lib:.4f} ms, plain "
                    f"{plain_ms:.1f} ms (host clock)")
            del x6, xc
            torch.cuda.empty_cache()
        # on B4's tile-major planes (the default tile at scale512)
        for (n, hl, wl), tile in (((2, 37, 53), (8, 16)),
                                  ((16, 512, 512), stack.default_tile(512,
                                                                      512))):
            tr, tc = tile
            ny, nx = -(-hl // tr), -(-wl // tc)
            x6t = (torch.rand((n, ny, nx, 2 * tr + 2, 2 * tc + 2, 128),
                              generator=gen, device=dev) * 2 - 1).to(dt)
            planes = x6t.reshape(-1, 2 * tr + 2, 2 * tc + 2, 128)
            for out in TAP_FORMS:
                stack.reset_launches()
                got = launch_taps(stack, x6t, sp, out, image=(hl, wl))
                torch.cuda.synchronize()
                if (stack.L7_LAUNCHES != {k: int(k == kern) for k in
                                          stack.L7_LAUNCHES}
                        or sum(stack.TAP_LAUNCHES.values()) != 1):
                    raise AssertionError(f"{out} tiles: {stack.L7_LAUNCHES} "
                                         f"{stack.TAP_LAUNCHES}")
                ref = stack._tiles_image(stack._last_taps_plain(
                    planes, sp, out), n, ny, nx)[:, :hl, :wl]
                what = f"phase 19 {out} on B4's tiles {(n, hl, wl)} {key}"
                err = (check_mma_layer(what, got, ref.to(dt))[0]
                       if dt == torch.bfloat16 else check_f32(what, got, ref))
                res[out, key]["max_abs_err"] = max(
                    res[out, key]["max_abs_err"], err)
                log(f"{what}, tile {tile}: max|fold - plain| = {err:.3g}")
                del got, ref
            del x6t, planes
            torch.cuda.empty_cache()
    return res



def phase19(dev: torch.device, sp16, taps_launches: dict) -> list:
    """19. The truncation probes (tools/fused_strip_probe.py:134,162,
    k1_forensics.py:136, l14_probe.py:145) and the four-tap layer
    (tmm_probe.py:79,122): every new kernel and form against its plain
    version (phase 18 holds the probe variants oneblk and xonly), the two
    tap forms alone on the fold (taps_alone), then the four tools at their
    JAX grids, counted, layer 7 on the fold only. sp16 is the shipped scale
    model in bf16 (for the library yardsticks); taps_launches holds the
    same-cell taps' launches ("cell") read around layer_time_probe's run
    (phase 15, stack.TAP_LAUNCHES).
    Returns the kernel table's rows."""
    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.ops import probe, stack
    from waifu2x_torch.tools import (
        fused_strip_probe, k1_forensics, l14_probe, tmm_probe)
    from waifu2x_torch.tools.layer_time_probe import bound_ms

    # tap_mm, both layouts, bit for bit, and chlane == poslane permuted; the
    # fourth shape's 296 rows of work (odd tr, two segments a cell row) leave
    # every block of the persistent grid partial work units
    tmm_err = 0.0
    for b, ny, nx, tr, tc in ((2, 2, 2, 8, 128), (1, 3, 1, 64, 256),
                              (16, 8, 4, 64, 128), (2, 2, 1, 37, 256)):
        x, w = probe.tmm_inputs(
            probe.tmm_input_shape("chlane", b, ny, nx, tr, tc), 0, dev)
        outs = {}
        for layout in probe.TMM_LAYOUTS:
            xl = (x if layout == "chlane"
                  else x.permute(0, 1, 3, 2).contiguous())
            before = probe.LAUNCHES["tap_mm"]
            got = probe.tap_mm(xl, w, layout, (tr, tc))
            torch.cuda.synchronize()
            if probe.LAUNCHES["tap_mm"] != before + 1:
                raise AssertionError(f"tap_mm {layout}: launches "
                                     f"{probe.LAUNCHES}")
            err, share, ok = probe.compare(
                got, probe.tap_mm_plain(xl, w, layout, (tr, tc)))
            log(f"phase 19 tap_mm {layout} {tuple(xl.shape)}, tile "
                f"{(tr, tc)} -> {tuple(got.shape)}: max|kernel - plain| = "
                f"{err:.3g}, {share:.5%} differ (bar: bit-equal, exact sums)")
            if not ok:
                raise AssertionError(f"tap_mm {layout}: kernel != plain")
            tmm_err = max(tmm_err, err)
            outs[layout] = got
        if not torch.equal(outs["poslane"].permute(0, 1, 3, 2),
                           outs["chlane"]):
            raise AssertionError("tap_mm: poslane != chlane permuted")
        log("  poslane equals chlane on the same values permuted, bit for "
            "bit")
        del x, w, outs, got
    torch.cuda.empty_cache()

    # stack_scale_upto's three probe forms against their plain versions
    forms = ([(k, "whole") for k in range(6)] + [(0, "lane0"),
                                                 (6, "phase_taps")])
    want_launches = {"whole": lambda k: max(k, 1), "lane0": lambda k: 1,
                     "phase_taps": lambda k: 7}
    sp_r = {dt: stack.prep_params(init_params(3), dt, dev)
            for dt in (torch.float32, torch.bfloat16)}
    gen = torch.Generator().manual_seed(19)
    form_err = {out: 0.0 for _, out in forms}
    for shape in ((2, 37, 53), (1, 5, 300), (4, 512, 512)):
        y32 = torch.rand(shape, generator=gen).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            y, tol = y32.to(dt), F32_TOL if dt == torch.float32 else BF16_TOL
            errs = []
            for k, out in forms:
                stack.reset_launches()
                got = stack.stack_scale_upto(y, sp_r[dt], k, out=out)
                n_launch = want_launches[out](k)
                if stack.LAUNCHES != n_launch:
                    raise AssertionError(f"upto {k} out={out}: "
                                         f"{stack.LAUNCHES} launches")
                ref = stack.stack_scale_upto_plain(y, sp_r[dt], k, out=out)
                if got.shape != ref.shape or got.dtype != dt:
                    raise AssertionError(f"upto {k} out={out}: "
                                         f"{tuple(got.shape)} {got.dtype}")
                errs.append((got.float() - ref.float()).abs().max().item())
                check_max_err(f"upto {k} out={out} {shape} {dt}", errs[-1],
                              tol)
                form_err[out] = max(form_err[out], errs[-1])
                del got, ref
            log(f"phase 19 {shape} {dt}: max|kernel - plain| whole 0..5 "
                + " ".join(f"{e:.2e}" for e in errs[:6])
                + f", lane0 {errs[6]:.2e}, phase_taps {errs[7]:.2e}")
        torch.cuda.empty_cache()
    y = torch.rand((2, 37, 53), generator=gen).to(dev)
    err = (stack.stack_scale_upto(y, sp_r[torch.float32], 6, l6_wino=True,
                                  out="phase_taps")
           - stack.stack_scale_upto_plain(y, sp_r[torch.float32], 6,
                                          l6_wino=True, out="phase_taps")
           ).abs().max().item()
    check_max_err("phase_taps after the Winograd layer 6", err, F32_TOL)
    form_err["phase_taps"] = max(form_err["phase_taps"], err)
    log(f"phase 19 phase_taps after the Winograd layer 6, f32: "
        f"max|kernel - plain| = {err:.2e}")

    taps = taps_alone(dev)

    # the four tools at their JAX grids, the stack's and the probes'
    # launches read around each tool's run
    iters = 20   # the tools' default: a warm-up and 20 captured calls a mode
    # stack launches a call, mode by mode: the cell form at upto k is k
    # layers and the gather, "whole" max(k, 1), "lane0" the gather,
    # "phase_taps" and the whole stack 7; the probe variants none
    stack_calls = {"fused_strip_probe": (1, 2, 3, 4, 5, 6, 7, 7, 7, 7, 0),
                   "k1_forensics": (1, 1, 2, 3, 4, 4, 4),
                   "l14_probe": (0, 2, 3, 4, 5)}
    rows, stack_launches, l7_launches, tap_launches = {}, {}, {}, {}
    for tool, argv in (
            (fused_strip_probe, fused_strip_probe.MODES),
            (k1_forensics, k1_forensics.MODES), (l14_probe, []),
            (tmm_probe, ["chlane"]), (tmm_probe, ["poslane"])):
        before, stack_before = dict(probe.LAUNCHES), stack.LAUNCHES
        l7_before = dict(stack.L7_LAUNCHES)
        tap_before = dict(stack.TAP_LAUNCHES)
        key = tool.__name__.rsplit(".", 1)[1] + (
            f" {argv[0]}" if tool is tmm_probe else "")
        log(f"phase 19 tools.{key}:")
        rows[key] = []
        if tool.main(list(argv), rows[key]) != 0:
            raise AssertionError(f"{key} failed")
        rows[key + " launches"] = {k: probe.LAUNCHES[k] - before[k]
                                   for k in before}
        stack_launches[key] = stack.LAUNCHES - stack_before
        l7_launches[key] = {k: stack.L7_LAUNCHES[k] - l7_before[k]
                            for k in l7_before}
        tap_launches[key] = {k: stack.TAP_LAUNCHES[k] - tap_before[k]
                             for k in tap_before}
    want = {key: (iters + 1) * sum(stack_calls.get(key, ())) for key in
            stack_launches}
    # layer 7 on the fold only: fused_strip_probe's mode 6 (the phase taps)
    # and its three whole-stack modes (7, 107, dimsem), each a warm-up and
    # 20 captured calls; no other tool reaches layer 7
    want_l7 = {key: {"fold": 4 * (iters + 1) if key == "fused_strip_probe"
                     else 0, "fold_f32": 0}
               for key in l7_launches}
    # of which the tap forms: mode 6's phase taps, a warm-up and 20 captured
    want_taps = {key: {"taps": 0, "ptaps": iters + 1 if key == (
        "fused_strip_probe") else 0} for key in tap_launches}
    if l7_launches != want_l7 or tap_launches != want_taps:
        raise AssertionError(f"phase 19 layer-7 launches {l7_launches}, "
                             f"tap forms {tap_launches} (want {want_l7}, "
                             f"{want_taps})")
    log(f"phase 19 layer-7 launches by tool {l7_launches}: "
        f"{tap_launches['fused_strip_probe']['ptaps']} of "
        f"fused_strip_probe's are the phase taps on the fold "
        f"(TAP_LAUNCHES)")
    taps_launches = dict(taps_launches, phase_taps=tap_launches[
        "fused_strip_probe"]["ptaps"])
    per_variant = 1 + 2 * (iters + 1)   # measure(): check, graph, one by one
    tmm_launches = {layout: rows[f"tmm_probe {layout} launches"]["tap_mm"]
                    for layout in probe.TMM_LAYOUTS}
    fetch = {"oneblk": rows["fused_strip_probe launches"]["fetch_map"],
             "xonly": rows["l14_probe launches"]["fetch_map"]}
    if (stack_launches != want or set(fetch.values()) != {per_variant}
            or set(tmm_launches.values()) != {1 + iters + 1}):
        raise AssertionError(f"phase 19 launches: stack {stack_launches} "
                             f"(want {want}), probes {fetch}, tap_mm "
                             f"{tmm_launches}")
    log(f"phase 19 launches: stack by tool {stack_launches}, oneblk/xonly "
        f"{fetch}, tap_mm {tmm_launches}")
    # with each tool's total as counted, the forms' own launches: lane0 is
    # fused_strip's mode 0, phase_taps its mode 6, whole all of k1's modes
    form_launches = {"lane0": iters + 1, "phase_taps": 7 * (iters + 1),
                     "whole": stack_launches["k1_forensics"]}

    def mode(tool, label):
        return next(r for r in rows[tool] if r["mode"] == label)

    # plain and library times of the three stack forms at the tools' grid
    gen = torch.Generator().manual_seed(0)
    ylow = torch.rand((4, 512, 512), generator=gen).to(dev, torch.bfloat16)
    sp = stack.prep_params(init_params(0), torch.bfloat16, dev)
    plain = {out: timed_ms(lambda k=k, out=out: stack.stack_scale_upto_plain(
        ylow, sp, k, out=out), reps=1)
        for k, out in ((0, "lane0"), (4, "whole"), (6, "phase_taps"))}
    xpad = F.pad(ylow.repeat_interleave(2, 1).repeat_interleave(2, 2)[:, None],
                 (7,) * 4, mode="replicate")[:, 0]
    k4 = (sp[6][0][:, 0:4, 0].t().float().reshape(4, 128, 1, 1)
          .to(torch.bfloat16).contiguous(memory_format=torch.channels_last))
    library = {"whole": library_stack_ms(xpad, sp, upto=4),
               "phase_taps": library_stack_ms(
                   xpad, sp, upto=6,
                   post=lambda h: F.conv2d(h, k4, stride=2))}
    del xpad, ylow
    torch.cuda.empty_cache()

    def bound(k, out):
        ms, by = bound_ms(torch.empty((4, 512, 512), dtype=torch.bfloat16),
                          k, out)
        return {"bound_ms": ms, "bound_by": by}

    gather = "waifu2x_torch/csrc/gather.cu"
    out_rows = []
    for layout in probe.TMM_LAYOUTS:
        r = rows[f"tmm_probe {layout}"][0]
        out_rows.append({
            "name": f"tap_mm, four-tap 128 -> 128 layer, {layout} (wgmma, "
                    f"the weights resident in registers as A, B the "
                    f"activation K-major, a TMA-staged row a slot"
                    + (", transposed there in shared memory"
                       if layout == "poslane" else "") + "; persistent)",
            "route": "cuda", "source": "waifu2x_torch/csrc/tmm.cu",
            "replaces": probe.TMM_SITES[layout],
            "launches": tmm_launches[layout], "max_abs_err": tmm_err,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "conv_ms": r["conv_ms"],
            "tflops": r["tflops"]})
    fs, k1 = "fused_strip_probe", "k1_forensics"
    out_rows += [{
        "name": "upto_gather_tiled GATHER_LANE0 (stack_scale_upto, upto 0, "
                "out=\"lane0\")",
        "route": "cuda", "source": gather,
        "replaces": "tools/fused_strip_probe.py:162",
        "launches": form_launches["lane0"], "max_abs_err": form_err["lane0"],
        "ms": mode(fs, "upto0")["ms"], "plain_ms": plain["lane0"],
        **bound(0, "lane0"), "library_ms": None,
        "ladder_ms": {r["mode"]: r["ms"] for r in rows[fs]
                      if "probe" not in r}}, {
        "name": "stack_scale_upto, upto 6, out=\"phase_taps\" (layers 1-6, "
                "then l7_fold OUT_PTAPS)",
        "route": "cuda", "source": "waifu2x_torch/csrc/l7.cu",
        "replaces": "tools/fused_strip_probe.py:162",
        "launches": form_launches["phase_taps"],
        "max_abs_err": form_err["phase_taps"],
        "ms": mode(fs, "upto6")["ms"], "plain_ms": plain["phase_taps"],
        **bound(6, "phase_taps"), "library_ms": library["phase_taps"]}, {
        "name": "stack_scale_upto out=\"whole\" (upto_gather_tiled "
                "GATHER_PAD at upto 0; layer k's own buffer at 1-5)",
        "route": "cuda", "source": gather,
        "replaces": "tools/k1_forensics.py:136",
        "launches": form_launches["whole"], "max_abs_err": form_err["whole"],
        "ms": mode(k1, "+L4 (full K1)")["ms"], "plain_ms": plain["whole"],
        **bound(4, "whole"), "library_ms": library["whole"],
        "ladder_ms": {r["mode"]: r["ms"] for r in rows[k1]}}]
    for tool, name in (("fused_strip_probe", "oneblk"),
                       ("l14_probe", "xonly")):
        r = mode(tool, name)["probe"]
        out_rows.append({
            "name": f"probe_fetch_map, {name}", "route": "cuda",
            "source": "waifu2x_torch/csrc/probe.cu",
            "replaces": r["site"], "launches": fetch[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    out_rows[-1]["ladder_ms"] = {r["mode"]: r["ms"] for r in rows["l14_probe"]}
    # the two tap forms alone (bf16 the rows' numbers, f32 beside them),
    # their launches on the tools' runs
    for out, what, tool, run in (
            ("cell", "OUT_TAPS, the same-cell taps (stack_scale_upto "
             "upto 6)", "tools/layer_time_probe.py:78",
             "layer_time_probe (phase 15)"),
            ("phase_taps", "OUT_PTAPS, the phase taps, pixel (0, 0) alone "
             "(stack_scale_upto upto 6, out=\"phase_taps\")",
             "tools/fused_strip_probe.py:162",
             "fused_strip_probe (phase 19)")):
        b, f = taps[out, "bf16"], taps[out, "f32"]
        out_rows.append({
            "name": f"l7_fold {what}: the fold's Zt lanes 0-3 (wgmma; f32 "
                    f"l7_fold_f32, FFMA)",
            "route": "cuda", "source": "waifu2x_torch/csrc/l7.cu",
            "replaces": tool, "launches": taps_launches[out],
            "launches_of": f"stack.TAP_LAUNCHES read around {run}",
            "max_abs_err": b["max_abs_err"], "ms": b["ms"],
            "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": "bytes", "library_ms": b["library_ms"],
            "turns": b["turns"],
            "f32": {k: f[k] for k in ("ms", "bound_ms", "library_ms",
                                      "plain_ms", "max_abs_err")}})
    return out_rows


def phase20(dev: torch.device) -> list:
    """20. The last three probe sites (tools/accpp_probe.py:127,
    shift_cost_probe.py:156, l4_shift_probe.py:130): csrc/mma.cu's
    zero-shift (ZS) and two-accumulator (PP) variants of the tensor-core
    layer, layer 7 under each zero-shift mask folded (csrc/l7.cu, against
    l7_fold_plain(zs)), the three probe stacks against theirs at the JAX
    grid (shift_stack's base equal to stack_scale bit for bit), then the
    three tools with their launches counted, and the main path's counts
    checked unchanged. Returns the kernel table's rows."""
    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.ops import probe, stack
    from waifu2x_torch.tools import (
        accpp_probe, l4_shift_probe, shift_cost_probe)
    from waifu2x_torch.utils.timing import card_name

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(20)
    sp_r = {dt: stack.prep_params(init_params(3), dt, dev)
            for dt in (torch.float32, torch.bfloat16)}

    def mid_delta(before):
        return {k: stack.MID_LAUNCHES[k] - before[k] for k in before}

    # every instantiated ZS layer against mma_layer_plain(zs), one bf16 ulp
    zs_err = 0.0
    zs_keys = [key for key in sorted(stack._MMA_VARIANTS) if not key[3]]
    for shape in ((1, 27, 38), (2, 37, 53), (1, 5, 300)):
        for ci, co, zs, _ in zs_keys:
            k = stack.WIDTHS.index((ci, co)) + 1
            x = torch.randn((*shape, ci), generator=gen).to(dev,
                                                            torch.bfloat16)
            before = dict(stack.MID_LAUNCHES)
            got = stack.mma_layer(x, sp_r[torch.bfloat16], k, zs=zs)
            torch.cuda.synchronize()
            if mid_delta(before)["mma_zs"] != 1 or sum(
                    mid_delta(before).values()) != 1:
                raise AssertionError(f"mma_layer zs {zs}: launches "
                                     f"{mid_delta(before)}")
            ref = stack.mma_layer_plain(x, sp_r[torch.bfloat16].wm[k - 2],
                                        sp_r[torch.bfloat16][k - 1][1], zs)
            err, _ = check_mma_layer(f"mma layer {k} zs {zs} {shape}", got,
                                     ref)
            zs_err = max(zs_err, err)
    log(f"phase 20 ZS layers 2-6, zs 1-3, at (1,27,38), (2,37,53), "
        f"(1,5,300): max|kernel - plain| {zs_err:.3e} (bar: one bf16 ulp)")

    # layer 7 under each mask against its plain version, f32 and bf16: the
    # fold (csrc/l7.cu) against l7_fold_plain(zs), one bf16 ulp or 3e-5 in
    # f32
    fold_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    zs_fold_checks = 0
    for n, hl, wl in ((2, 19, 26), (1, 3, 150), (2, 64, 63)):
        x6 = torch.rand((n, 2 * hl + 2, 2 * wl + 2, 128), generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            x = x6.to(dev, dt)
            for zs in range(4):
                stack.reset_launches()
                got = stack.last_layer(x, sp_r[dt], zs)
                torch.cuda.synchronize()
                expect_l7(stack, f"layer 7 fold zs {zs} {dt}",
                          *((1, 0) if dt == torch.bfloat16 else (0, 1)))
                if any(stack.L6_LAUNCHES.values()):
                    raise AssertionError(f"layer 7 fold zs {zs}: launches "
                                         f"{stack.L6_LAUNCHES}")
                y32 = stack.l7_fold_plain(x, stack._w7f(sp_r[dt], x),
                                          sp_r[dt][6][1], zs)
                if dt == torch.bfloat16:
                    err, _ = check_mma_layer(
                        f"layer 7 fold zs {zs} {(n, hl, wl)}", got,
                        y32.to(dt))
                else:
                    err = (got - y32).abs().max().item()
                    check_max_err(f"layer 7 fold zs {zs} {(n, hl, wl)} f32",
                                  err, F32_TOL)
                fold_err[dt] = max(fold_err[dt], err)
                zs_fold_checks += 1
    stack.reset_launches()
    log(f"phase 20 layer 7 zs 0-3 at (2,19,26), (1,3,150), (2,64,63): fold "
        f"max|kernel - l7_fold_plain(zs)| f32 {fold_err[torch.float32]:.2e} "
        f"(bar 3e-5), bf16 {fold_err[torch.bfloat16]:.2e} (bar one bf16 "
        f"ulp)")

    # each PP layer bit-equal to the one-accumulator kernel, scale512 shapes
    sp0 = stack.prep_params(init_params(0), torch.bfloat16, dev)
    dev_gen = torch.Generator(device=dev).manual_seed(20)
    for k in range(2, 7):
        ci = stack.WIDTHS[k - 1][0]
        side = 2 * 512 + 16 - 2 * k
        x = torch.rand((16, side, side, ci), device=dev,
                       generator=dev_gen).to(torch.bfloat16)
        before = dict(stack.MID_LAUNCHES)
        one, two = stack.mma_layer(x, sp0, k), stack.mma_layer(x, sp0, k,
                                                               pp=True)
        torch.cuda.synchronize()
        if mid_delta(before) != {"mma": 1, "chain": 0,
                                 "mma_zs": 0, "mma_pp": 1, "mma_tf32": 0,
                                 "mma_resident": int(k < 6),
                                 "mma_split": int(k == 6),
                                 "mma_tile": 0}:
            raise AssertionError(f"pp layer {k}: launches {mid_delta(before)}")
        if not torch.equal(one.view(torch.int16), two.view(torch.int16)):
            diff = (one.float() - two.float()).abs()
            raise AssertionError(f"pp layer {k}: {int((diff > 0).sum())} "
                                 f"outputs differ, max {diff.max().item()}")
        del x, one, two
    torch.cuda.empty_cache()
    log("phase 20 PP layers 2-6 at the scale512 layer shapes: equal to the "
        "one-accumulator kernel bit for bit")

    # the variants alone at the JAX grid's layer shapes (B = 4, 512^2), in
    # turns (one accumulator and each variant, twice), beside their plain
    # versions; layer 7 under each mask
    n4 = 4
    xs = {k: torch.rand((n4, 2 * 512 + 16 - 2 * k, 2 * 512 + 16 - 2 * k,
                         stack.WIDTHS[k - 1][0]), device=dev,
                        generator=dev_gen).to(torch.bfloat16)
          for k in range(2, 7)}
    variants = {"one": {}, "pp": {"pp": True}, **{
        f"zs{z}": {"zs": z} for z in (1, 2, 3)}}
    layer_ms = {name: [0.0] * 5 for name in variants}
    for turn in (0, 1):
        for name, kw in (variants.items() if turn == 0
                         else reversed(variants.items())):
            for k in range(2, 7):
                layer_ms[name][k - 2] += timed_ms(
                    lambda: stack.mma_layer(xs[k], sp0, k, **kw)) / 2
    # the plain versions on the host's clock; PP held against them too
    pp_err, plain_ms = 0.0, {"one": 0.0, "zs3": 0.0}
    for name, zs in (("one", 0), ("zs3", 3)):
        for k in range(2, 7):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref = stack.mma_layer_plain(xs[k], sp0.wm[k - 2], sp0[k - 1][1],
                                        zs)
            torch.cuda.synchronize()
            plain_ms[name] += (time.perf_counter() - t1) * 1e3
            if name == "one":
                got = stack.mma_layer(xs[k], sp0, k, pp=True)
                pp_err = max(pp_err, check_mma_layer(
                    f"pp layer {k} B = 4", got, ref)[0])
                del got
            del ref
        torch.cuda.empty_cache()
    del xs
    x6 = torch.rand((n4, 1026, 1026, 128), device=dev,
                    generator=dev_gen).to(torch.bfloat16)
    # layer 7 under each mask, twice
    l7_turns = {zs: [timed_ms(lambda: stack.last_layer(x6, sp0, zs))
                     for _ in range(2)] for zs in range(4)}
    stack.reset_launches()
    fold_ms = {zs: sum(t) / 2 for zs, t in l7_turns.items()}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stack.l7_fold_plain(x6, sp0.w7f, sp0[6][1], 3)
    torch.cuda.synchronize()
    l7_plain_ms = (time.perf_counter() - t1) * 1e3
    l7_library_ms = library_l7_ms(x6, sp0)
    l7_bytes = x6.numel() * 2 + n4 * 512 * 512 * 4 * 2 + 128 * 9 * 2 + 4
    # the fold's operations: the [n, 513, 513, 512] x [512, 16] product
    fold_ops = 2 * 512 * 16 * n4 * 513 * 513
    del x6
    torch.cuda.empty_cache()
    mid4 = mid_bounds(stack, n4, 512, 512)
    mid4_ms = sum(b[2] for b in mid4)
    mid4_by = ("operations" if sum(b[2] for b in mid4 if b[3] == "operations")
               >= sum(b[2] for b in mid4 if b[3] == "bytes") else "bytes")
    mid4_library = library_mid_ms(sp0, n4, 512, 512)
    log(f"timing B = 4, 512^2, layers 2-6 alone, bf16, on {card_name()} "
        "(two turns): " + "; ".join(
            f"{name} {sum(v):.3f} ms (" + " / ".join(f"{t:.3f}" for t in v)
            + ")" for name, v in layer_ms.items())
        + f"; bound {mid4_ms:.3f} ms; cuDNN bf16 {mid4_library:.3f} ms; "
        f"plain (host clock) one {plain_ms['one']:.1f} ms, zs3 "
        f"{plain_ms['zs3']:.1f} ms")
    l7_bound = max(l7_bytes / PEAK_BYTES, fold_ops / PEAK_BF16_FLOPS) * 1e3
    log(f"timing B = 4, 512^2, layer 7 alone under zs 0/1/2/3, bf16, on "
        f"{card_name()}, twice each: fold "
        + " / ".join(f"{fold_ms[z]:.3f}" for z in range(4))
        + " ms (runs " + "; ".join(
            " ".join(f"{t:.3f}" for t in l7_turns[z]) for z in range(4))
        + f"); bound {l7_bound:.3f} ms; cuDNN layer 7 (zs 0) "
        f"{l7_library_ms:.3f} ms; plain zs3 (host clock) "
        f"{l7_plain_ms:.1f} ms")

    # the three probe stacks against their plain versions at the JAX grid
    ylow = torch.rand((4, 512, 512), generator=torch.Generator().manual_seed(
        0)).to(dev, torch.bfloat16)
    twin_err, twin_plain_ms = {}, {}
    cases = [("pp", lambda: probe.stack_scale_pp(ylow, sp0),
              lambda: probe.stack_scale_pp_plain(ylow, sp0))]
    cases += [(m, lambda f=f: probe.shift_stack(ylow, sp0, *f),
               lambda f=f: probe.shift_stack_plain(ylow, sp0, *f))
              for m, f in probe.SHIFT_MODES.items()]
    cases += [(m, lambda m=m: probe.l4_shift(ylow, sp0, m),
               lambda m=m: probe.l4_shift_plain(ylow, sp0, m))
              for m in ("l4", "zshift", "zdx")]
    for name, fn, plain in cases:
        got = fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = plain()
        torch.cuda.synchronize()
        twin_plain_ms[name] = (time.perf_counter() - t1) * 1e3
        if got.shape != ref.shape or got.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype}")
        twin_err[name] = (got.float() - ref.float()).abs().max().item()
        check_max_err(f"probe stack {name}", twin_err[name], BF16_TOL)
        del got, ref
    if not torch.equal(probe.stack_scale_pp(ylow, sp0),
                       stack.stack_scale(ylow, sp0)):
        raise AssertionError("stack_scale_pp != stack_scale")
    if not torch.equal(probe.shift_stack(ylow, sp0, 1, 1),
                       stack.stack_scale(ylow, sp0)):
        raise AssertionError("shift_stack base != stack_scale")
    xpad = F.pad(ylow.repeat_interleave(2, 1).repeat_interleave(2, 2)[:, None],
                 (7,) * 4, mode="replicate")[:, 0]
    stack_library_ms = library_stack_ms(xpad, sp0)
    del xpad
    torch.cuda.empty_cache()
    log("phase 20 probe stacks at 4 x 512^2, bf16: max|kernel - plain| "
        + ", ".join(f"{k} {v:.2e}" for k, v in twin_err.items())
        + " (bar 2^-4); stack_scale_pp and shift_stack base == stack_scale "
        "bit for bit")

    # the three tools, the launches read around each (a warm-up and 20
    # captured calls a mode; accpp_probe makes one more call a mode for its
    # comparison)
    rows, counts = {}, {}
    for tool, argv in ((accpp_probe, []),
                       (shift_cost_probe, shift_cost_probe.MODES),
                       (l4_shift_probe, l4_shift_probe.MODES)):
        key = tool.__name__.rsplit(".", 1)[1]
        log(f"phase 20 tools.{key}:")
        stack.reset_launches()
        probe.reset_launches()
        rows[key] = []
        if tool.main(list(argv), rows[key]) != 0:
            raise AssertionError(f"{key} failed")
        counts[key] = {"stack": stack.LAUNCHES, **stack.KERNEL_LAUNCHES,
                       **stack.MID_LAUNCHES,
                       **{f"l7_{k}": v for k, v in stack.L7_LAUNCHES.items()},
                       "probe_kernels": sum(probe.LAUNCHES.values())}
    calls = 21
    want_l4 = {"stack": 0, "mma": 0, "mma_zs": 0}
    for mode in l4_shift_probe.MODES:
        upto, zs4, _ = probe.L4_MODES[mode]
        want_l4["stack"] += calls * upto
        want_l4["mma"] += calls * (upto - 1 - (zs4 > 0))
        want_l4["mma_zs"] += calls * (zs4 > 0)
    n_zs = len(shift_cost_probe.MODES) - 1
    # every shift_cost mode ends in the fold (base too): 84 fold launches
    want = {
        "accpp_probe": {"stack": 3 * (calls + 1) * 7, "scale": 2 * 22 * 7,
                        "probe": 22 * 7, "mma": 2 * 22 * 5,
                        "mma_pp": 22 * 5, "mma_zs": 0},
        "shift_cost_probe": {"stack": 4 * calls * 7, "probe": 4 * calls * 7,
                             "mma": calls * 5, "mma_zs": n_zs * calls * 5,
                             "mma_pp": 0,
                             "l7_fold": len(shift_cost_probe.MODES) * calls},
        "l4_shift_probe": {**want_l4, "probe": want_l4["stack"],
                           "mma_pp": 0}}
    for key, w in want.items():
        got = {k: counts[key][k] for k in w}
        if got != w or counts[key]["probe_kernels"]:
            raise AssertionError(f"phase 20 {key} launches {counts[key]}, "
                                 f"want {w}")
    log(f"phase 20 launches by tool: {counts}")

    # the main path's counts are as they were
    stack.reset_launches()
    stack.stack_scale(ylow, sp0)
    torch.cuda.synchronize()
    if (stack.LAUNCHES != 7 or stack.KERNEL_LAUNCHES["scale"] != 7
            or stack.MID_LAUNCHES != {"mma": 5, "chain": 0,
                                      "mma_zs": 0, "mma_pp": 0, "mma_tf32": 0,
                                      "mma_resident": 4, "mma_split": 1,
                                      "mma_tile": 0}
            or stack.L6_LAUNCHES != {"direct": 1, "i8": 0, "wino": 0,
                                     "upto": 0}
            or stack.KERNEL_LAUNCHES["probe"]):
        raise AssertionError(f"stack_scale after phase 20: {stack.LAUNCHES}, "
                             f"{stack.MID_LAUNCHES}, {stack.L6_LAUNCHES}")
    del ylow
    torch.cuda.empty_cache()
    serial = probe.ptxas_serialized()
    log(f"phase 20: {accpp_probe.serialization_note(dev)}; "
        f"{time.perf_counter() - t0:.1f} s")

    def ms_of(tool):
        return {r["mode"]: r["ms"] for r in rows[tool]}

    mma_src = "waifu2x_torch/csrc/mma.cu"
    stack_bound4 = rows["accpp_probe"][0]
    return [{
        "name": "conv3x3_bias_leaky_mma ZS, layers 2-6 under a zero-shift "
                "mask (wgmma; window copies with pixel pairs swapped)",
        "route": "cuda", "source": mma_src,
        "replaces": "tools/shift_cost_probe.py:156, "
                    "tools/l4_shift_probe.py:130",
        "launches": (counts["shift_cost_probe"]["mma_zs"]
                     + counts["l4_shift_probe"]["mma_zs"]),
        "max_abs_err": max(zs_err, *(twin_err[m] for m in (
            "noshiftx", "noshifty", "noshift", "zshift", "zdx"))),
        "ms": sum(layer_ms["zs3"]),
        "layer_ms": {name: v for name, v in layer_ms.items()
                     if name.startswith("zs") or name == "one"},
        "plain_ms": plain_ms["zs3"], "bound_ms": mid4_ms,
        "bound_by": mid4_by, "library_ms": None,
        "tool_ms": {**{f"shift_cost {k}": v for k, v in
                       ms_of("shift_cost_probe").items()},
                    **{f"l4_shift {k}": v for k, v in
                       ms_of("l4_shift_probe").items()}},
        "stack_plain_ms": {k: twin_plain_ms[k] for k in (
            "noshiftx", "noshifty", "noshift", "zshift", "zdx", "l4")},
        "stack_bound_ms": {"shift_cost": stack_bound4["bound_ms"],
                           "l4_shift": rows["l4_shift_probe"][1]["bound_ms"]},
    }, {
        "name": "conv3x3_bias_leaky_mma PP, layers 2-6 with two register "
                "accumulators (wgmma, two commit groups)",
        "route": "cuda", "source": mma_src,
        "replaces": "tools/accpp_probe.py:127",
        "launches": counts["accpp_probe"]["mma_pp"],
        "max_abs_err": max(pp_err, twin_err["pp"]),
        "ms": sum(layer_ms["pp"]), "one_acc_ms": sum(layer_ms["one"]),
        "layer_ms": {"pp": layer_ms["pp"], "one": layer_ms["one"]},
        "plain_ms": plain_ms["one"], "bound_ms": mid4_ms,
        "bound_by": mid4_by, "library_ms": mid4_library,
        "ptxas_serialized": serial,
        "tool_ms": ms_of("accpp_probe") | {
            "prod (both runs)": [r["ms"] for r in rows["accpp_probe"]
                                 if r["mode"] == "prod"]},
        "stack_plain_ms": twin_plain_ms["pp"],
        "stack_library_ms": stack_library_ms,
        "stack_bound_ms": stack_bound4["bound_ms"],
    }, {
        "name": "l7_fold ZS, layer 7 under a zero-shift mask, folded "
                "(wgmma m64n16k16 on TMA-staged tiles; the shift-sum reads "
                "a zeroed axis' own cell)",
        "route": "cuda", "source": "waifu2x_torch/csrc/l7.cu",
        "replaces": "tools/shift_cost_probe.py:156",
        "launches": counts["shift_cost_probe"]["l7_fold"],
        "max_abs_err": max(fold_err.values()),
        "max_abs_err_f32": fold_err[torch.float32],
        "checks": zs_fold_checks,
        "ms": fold_ms[3], "zs_ms": [fold_ms[z] for z in range(4)],
        "turns_ms": l7_turns,
        "plain_ms": l7_plain_ms,
        "bound_ms": l7_bound,
        "bound_by": ("bytes" if l7_bytes / PEAK_BYTES
                     >= fold_ops / PEAK_BF16_FLOPS else "operations"),
        "library_ms": l7_library_ms,
        "library_is": "cuDNN bf16 conv 128 -> 1 + leaky, zs 0's function",
    }]


L7_SHAPES = ((1, 27, 38), (2, 37, 53), (1, 5, 300))


def expect_l7(stack, label: str, bf16: int = 0, f32: int = 0) -> None:
    """Layer 7's launches by kernel since the counts were last reset: `bf16`
    on the tensor-core fold, `f32` on the FFMA one."""
    want = {"fold": bf16, "fold_f32": f32}
    if stack.L7_LAUNCHES != want:
        raise AssertionError(f"{label}: layer-7 launches "
                             f"{stack.L7_LAUNCHES}, want {want}")


def library_l7_ms(x6: torch.Tensor, sp16) -> float:
    """Library yardstick (never called by the port): layer 7 alone as one
    cuDNN bf16 channels_last convolution 128 -> 1 + leaky_relu, TF32 off,
    on the NHWC layer-6 plane x6 (a channels_last view, no copy)."""
    from waifu2x_torch.ops.convstack import no_tf32
    (w, b), = cudnn_layers(sp16[6:7])
    xc = x6.permute(0, 3, 1, 2)
    with no_tf32():
        ms = timed_ms(lambda: F.leaky_relu(F.conv2d(xc, w, b), 0.1))
    torch.cuda.empty_cache()
    return ms


def phase21(dev: torch.device, main_launches: int) -> list:
    """21. Layer 7 folded on the tensor cores (csrc/l7.cu, reached through
    stack.last_layer as every bf16 stack reaches it) against its plain
    version (l7_fold_plain, then last_out) in its three output forms, at
    the layer-7 planes of L7_SHAPES (random weights) and of scale512 and
    noise256 (the shipped weights): s2d and dense to one bf16 ulp at the
    output's magnitude, dense un-chunked equal to s2d bit for bit and its
    pad columns zero, u8 by check_u8_kernel, each call one launch under
    L7_LAUNCHES["fold"]. Then layer 7 alone at scale512 in each form,
    twice, and at noise256 in s2d, beside cuDNN's layer 7 alone, the plain
    version and the bound. `main_launches` is the fold's
    count in phase 4's main path. Returns the kernel table's row."""
    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.ops import stack
    from waifu2x_torch.utils.timing import card_name

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    sp_r = stack.prep_params(init_params(3), torch.bfloat16, dev)
    sp_s = stack.prep_params(load_model_json(
        root / "models" / "scale2.0x_demo.json"), torch.bfloat16, dev)
    sp_n = stack.prep_params(load_model_json(
        root / "models" / "noise1_demo.json"), torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    err = {"s2d": 0.0, "dense": 0.0, "u8": 0}
    share = {"s2d": 0.0, "dense": 0.0, "u8": 0.0}
    cases = [(shape, sp_r) for shape in L7_SHAPES]
    cases += [((16, 512, 512), sp_s), ((256, 128, 128), sp_n)]
    planes = {}
    for (n, hl, wl), sp in cases:
        x6 = torch.rand((n, 2 * hl + 2, 2 * wl + 2, 128), device=dev,
                        generator=gen, dtype=torch.bfloat16)
        uvp = torch.rand((n, hl, wl, 8), device=dev, generator=gen)
        chunk = max(1, int(2e9 // (x6[0].numel() * 4)))
        y32 = torch.cat([stack.l7_fold_plain(x6[i:i + chunk], sp.w7f,
                                             sp[6][1])
                         for i in range(0, n, chunk)])
        stack.reset_launches()
        got = stack.last_layer(x6, sp)
        expect_l7(stack, f"layer 7 fold s2d {(n, hl, wl)}", bf16=1)
        e, sh = check_mma_layer(f"layer 7 fold s2d {(n, hl, wl)}", got,
                                stack.last_out(y32, "s2d", torch.bfloat16))
        err["s2d"], share["s2d"] = max(err["s2d"], e), max(share["s2d"], sh)
        ydense, tc = stack.last_layer(x6, sp, out="dense")
        check_dense_pad(f"layer 7 fold dense {(n, hl, wl)}", ydense, tc, wl)
        if not torch.equal(stack.dense_to_s2d(ydense, tc, hl, wl), got):
            raise AssertionError(f"layer 7 fold dense {(n, hl, wl)}: "
                                 f"un-chunked output differs from s2d")
        e, sh = check_mma_layer(
            f"layer 7 fold dense {(n, hl, wl)}", ydense,
            stack.last_out(y32, "dense", torch.bfloat16, tc=tc)[0])
        err["dense"] = max(err["dense"], e)
        share["dense"] = max(share["dense"], sh)
        del ydense, got
        got = stack.last_layer(x6, sp, out="u8", uvp=uvp)
        check_lanes_zero(f"layer 7 fold u8 {(n, hl, wl)}", got)
        e, sh = check_u8_kernel(f"layer 7 fold u8 {(n, hl, wl)}", got,
                                stack.last_out(y32, "u8", torch.bfloat16,
                                               uvp), torch.bfloat16)
        err["u8"], share["u8"] = max(err["u8"], e), max(share["u8"], sh)
        expect_l7(stack, f"layer 7 fold {(n, hl, wl)}", bf16=3)
        del got, y32
        if n > 2:
            planes[(n, hl, wl)] = (x6, uvp, sp)
        else:
            del x6, uvp
        torch.cuda.empty_cache()
    log(f"phase 21 layer 7 fold at {', '.join(map(str, L7_SHAPES))}, "
        f"scale512 and noise256 x6 planes: max|kernel - plain| s2d "
        f"{err['s2d']:.3e} ({share['s2d']:.4%} of outputs differ), dense "
        f"{err['dense']:.3e} ({share['dense']:.4%}) (bar: one bf16 ulp), "
        f"dense un-chunked == s2d bit for bit, u8 {err['u8']} level at "
        f"{share['u8']:.4%} of bytes")

    # layer 7 alone at scale512 in each form, twice
    x6, uvp, sp = planes[(16, 512, 512)]
    n, hl, wl = 16, 512, 512
    kw = {"s2d": {}, "dense": {"out": "dense"},
          "u8": {"out": "u8", "uvp": uvp}}
    turns = {form: [timed_ms(lambda: stack.last_layer(x6, sp, **args))
                    for _ in range(2)] for form, args in kw.items()}
    ms = {form: sum(t) / 2 for form, t in turns.items()}
    t1 = time.perf_counter()
    for i in range(0, n, 2):
        stack.l7_fold_plain(x6[i:i + 2], sp.w7f, sp[6][1]).to(torch.bfloat16)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    lib_ms = library_l7_ms(x6, sp)
    cells = n * (hl + 1) * (wl + 1)
    ops = 2 * 512 * 16 * cells   # the fold's products (W holds zeros)
    tc = stack._dense_tc(wl, None)
    out_bytes = {"s2d": n * hl * wl * 4 * 2,
                 "dense": n * hl * -(-wl // tc) * 4 * tc * 2,
                 "u8": n * hl * wl * (16 + 8 * 4)}
    in_bytes = x6.numel() * 2 + 512 * 16 * 2 + 4
    bound = {f: max((in_bytes + b) / PEAK_BYTES, ops / PEAK_BF16_FLOPS) * 1e3
             for f, b in out_bytes.items()}
    bound_by = "bytes" if (in_bytes / PEAK_BYTES
                           >= ops / PEAK_BF16_FLOPS) else "operations"
    del planes[(16, 512, 512)], x6, uvp
    torch.cuda.empty_cache()
    x6n, _, spn = planes.pop((256, 128, 128))
    noise_ms = timed_ms(lambda: stack.last_layer(x6n, spn))
    noise_bound = max((x6n.numel() * 2 + 256 * 128 * 128 * 8) / PEAK_BYTES,
                      2 * 512 * 16 * 256 * 129 * 129 / PEAK_BF16_FLOPS) * 1e3
    noise_lib_ms = library_l7_ms(x6n, spn)
    del x6n
    torch.cuda.empty_cache()
    x6_shape = (n, 2 * hl + 2, 2 * wl + 2, 128)
    log(f"phase 21 layer 7 alone, scale512 x6 {x6_shape} bf16, on "
        f"{card_name()}: " + "; ".join(
            f"{form} fold {ms[form]:.3f} ms (runs "
            + " / ".join(f"{v:.3f}" for v in turns[form])
            + f"; {(in_bytes + out_bytes[form]) / ms[form] / 1e6:.0f} "
            f"GB/s = {100 * bound[form] / ms[form]:.1f}% of the bound "
            f"{bound[form]:.3f} ms by {bound_by})"
            for form in kw)
        + f"; plain (l7_fold_plain, in chunks, host clock) {plain_ms:.1f} ms;"
        f" cuDNN bf16 layer 7 alone {lib_ms:.3f} ms; noise256 x6 s2d: fold "
        f"{noise_ms:.3f} ms, bound "
        f"{noise_bound:.3f} ms, cuDNN {noise_lib_ms:.3f} ms; "
        f"{time.perf_counter() - t0:.1f} s")
    return [{
        "name": "l7_fold, layer 7 (128 -> 1) as the folded tap product on "
                "the tensor cores (wgmma; every bf16 stack call on a plane)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/l7.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "replaces_part": "_stack_body's layer 7 with l7_fold, :489-508 and "
                         ":603-655",
        "launches": main_launches,
        "max_abs_err": max(err["s2d"], err["dense"]),
        "max_abs_err_u8_levels": err["u8"],
        "ms": ms["s2d"],
        "form_ms": ms,
        "noise256_ms": noise_ms,
        "noise256_bound_ms": noise_bound,
        "noise256_library_ms": noise_lib_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["s2d"],
        "form_bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }]


PEAK_TF32_FLOPS = 494.7e12   # dense TF32 (NVIDIA data sheet, 700 W)
NS1080 = (4, 1080, 1920)     # the chain's full-res frames: the noise stack


def expect_l1(stack, label: str, l1: int) -> None:
    """Layer 1's launches by kernel since the counts were last reset: every
    stack call's on csrc/l1.cu."""
    want = {"l1": l1}
    if stack.L1_LAUNCHES != want:
        raise AssertionError(f"{label}: layer-1 launches "
                             f"{stack.L1_LAUNCHES}, want {want}")


def check_f32(what: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """An f32 kernel's output against its plain version's: finite, same
    shape, max |diff| <= F32_TOL. Returns max |diff|."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {got.shape} {got.dtype} against "
                             f"{ref.shape} {ref.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = (got - ref).abs().max().item()
    check_max_err(what, err, F32_TOL)
    return err


def tf32_layer_bounds(stack, n: int, hg: int, wg: int):
    """Per layer 2-6 of a stack on an [n, hg, wg] grid of s2d cells: (FLOPs
    of the function, f32 bytes (input, weights, output once each), bound ms
    of the 3xTF32 kernel (three TF32 products a term at the TF32 peak, or
    the bytes), FFMA floor ms (one f32 product a term at 67 TFLOP/s))."""
    out = []
    for k in range(1, 6):
        ci, co = stack.WIDTHS[k]
        hin, win = 2 * hg + 14 - 2 * k, 2 * wg + 14 - 2 * k
        flops = 2 * n * (hin - 2) * (win - 2) * ci * co * 9
        moved = (4 * n * (hin * win * ci + (hin - 2) * (win - 2) * co)
                 + 4 * 9 * ci * co + 4 * co)
        out.append((flops, moved, max(3 * flops / PEAK_TF32_FLOPS,
                                      moved / PEAK_BYTES) * 1e3,
                    flops / PEAK_F32_FLOPS * 1e3))
    return out


def cudnn_f32(pairs) -> list:
    """(w OIHW channels_last, b) in f32 of the stack's (w, b) pairs."""
    return [(w.float().reshape(w.shape[0], 3, 3, w.shape[2])
             .permute(3, 0, 1, 2)
             .contiguous(memory_format=torch.channels_last), b.float())
            for w, b in pairs]


def library_f32_ms(x: torch.Tensor, pairs) -> float:
    """Library yardstick (never called by the port): the layers `pairs` as
    cuDNN f32 channels_last convolutions + leaky_relu with TF32 off, on
    x [N, C, H, W] f32."""
    from waifu2x_torch.ops.convstack import no_tf32
    layers = cudnn_f32(pairs)
    xc = x.contiguous(memory_format=torch.channels_last)

    def run():
        h = xc
        for w, b in layers:
            h = F.leaky_relu(F.conv2d(h, w, b), 0.1)
        return h

    with no_tf32():
        ms = timed_ms(run)
    del xc, layers
    torch.cuda.empty_cache()
    return ms


def phase22(dev: torch.device, main_launches: int) -> list:
    """22. Layers 2-6 of the f32 stacks as 3xTF32 on the tensor cores
    (csrc/mma_tf32.cu, through stack.mma_layer as every f32 stack reaches
    it) against the f32 plain version (mma_layer_plain from the f32
    weights): each layer alone at L7_SHAPES (random weights, randn input)
    and the five chained at the ns1080 noise stack's layer shapes (the
    shipped noise2 weights, each layer fed the kernel's output of the one
    before), max |diff| <= 3e-5, one "mma_tf32" launch a call. Then the f32
    noise stack at ns1080 layer by layer, twice, with TFLOP/s against the
    3xTF32 bound and the FFMA floor, beside cuDNN's f32 layers 2-6 and f32
    stack (TF32 off).
    `main_launches` is the "mma_tf32" count of phase 7's f32-noise chain.
    Returns the kernel table's rows (the layers, the f32 stack)."""
    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.ops import stack
    from waifu2x_torch.ops.convstack import pad_replicate
    from waifu2x_torch.utils.timing import card_name

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    sp_r = stack.prep_params(init_params(3), torch.float32, dev)
    sp_n = stack.prep_params(load_model_json(
        root / "models" / "noise2_demo.json"), torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    only_tf32 = {k: 0 for k in stack.MID_LAUNCHES}
    only_tf32["mma_tf32"] = 1

    def hold(x, sp, k, label, time_plain=False):
        ci, co = stack.WIDTHS[k - 1]
        t1 = time.perf_counter()
        ref = mma_plain_in_chunks(stack, x, sp.wm[k - 2], sp[k - 1][1])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        stack.reset_launches()
        got = stack.mma_layer(x, sp, k)
        torch.cuda.synchronize()
        if stack.MID_LAUNCHES != only_tf32 or stack.LAUNCHES:
            raise AssertionError(f"3xTF32 layer {k} alone: launches "
                                 f"{stack.MID_LAUNCHES}, {stack.LAUNCHES}")
        err = check_f32(f"3xTF32 layer {k} {label}", got, ref)
        log(f"phase 22 3xTF32 layer {k} ({ci} -> {co}) {label}, largest "
            f"output {ref.abs().max().item():.3f}: max|kernel - plain| "
            f"{err:.3e}")
        return got, err, plain_ms if time_plain else 0.0

    err = 0.0
    for shape in L7_SHAPES:
        for k in range(2, 7):
            x = torch.randn((*shape, stack.WIDTHS[k - 1][0]), device=dev,
                            generator=gen)
            err = max(err, hold(x, sp_r, k, f"{shape}")[1])
    n, h, w = NS1080
    hg, wg = h // 2, w // 2
    x = torch.rand((n, 2 * hg + 12, 2 * wg + 12, 32), device=dev,
                   generator=gen)
    plain_ms = 0.0
    for k in range(2, 7):
        x, e, ms = hold(x, sp_n, k, f"ns1080 {tuple(x.shape)}", True)
        err, plain_ms = max(err, e), plain_ms + ms
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()

    # the f32 noise stack at ns1080 layer by layer, twice
    y = torch.rand(NS1080, device=dev, generator=gen)
    turns, whole = [], []
    for _ in range(2):
        whole.append(timed_ms(lambda: stack.stack_noise(y, sp_n)))
        turns.append(per_layer_ms(
            lambda ev: stack.stack_noise(y, sp_n, events=ev), stack))
    stack.reset_launches()
    stack.stack_noise(y, sp_n)
    torch.cuda.synchronize()
    want = {k: 0 for k in stack.MID_LAUNCHES}
    want["mma_tf32"] = 5
    if stack.MID_LAUNCHES != want:
        raise AssertionError(f"f32 noise stack: layers 2-6 launches "
                             f"{stack.MID_LAUNCHES}, want {want}")
    per_layer = (turns[0] + turns[1]) / 2   # layers 1 and 7: [0], [6]
    mid = per_layer[1:6]
    stack_ms = sum(whole) / 2
    bounds = tf32_layer_bounds(stack, n, hg, wg)
    bound = sum(b[2] for b in bounds)
    floor = sum(b[3] for b in bounds)
    flops = sum(b[0] for b in bounds)
    x1 = torch.rand((n, 32, 2 * hg + 12, 2 * wg + 12), device=dev,
                    generator=gen)
    lib_mid = library_f32_ms(x1, sp_n[1:6])
    del x1
    torch.cuda.empty_cache()
    xpad = pad_replicate(y, 7)
    lib_stack = library_f32_ms(xpad, sp_n)
    del xpad
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    for i in range(n):
        stack.stack_noise_plain(y[i:i + 1], sp_n)
    torch.cuda.synchronize()
    stack_plain_ms = (time.perf_counter() - t1) * 1e3
    # the f32 stack's bound: layers 2-6 at 3xTF32, layers 1 and 7 at the
    # FFMA peak, or its plane in and out
    maccs_17 = 9 * 32 + 9 * 128
    px = n * h * w
    stack_bound = max(
        bound + 2 * maccs_17 * px / PEAK_F32_FLOPS * 1e3,
        4 * 2 * px / PEAK_BYTES * 1e3)
    stack_floor = floor + 2 * maccs_17 * px / PEAK_F32_FLOPS * 1e3
    smi = card_name()
    log(f"phase 22 f32 noise stack at ns1080 {NS1080}, layers 2-6, on {smi}: "
        f"3xTF32 {mid.sum():.2f} ms = "
        f"{3 * flops / mid.sum() / 1e9:.1f} TFLOP/s of TF32 products "
        f"({100 * bound / mid.sum():.1f}% of the bound {bound:.2f} ms; FFMA "
        f"floor {floor:.2f} ms); per layer " + "; ".join(
            f"L{k + 2} {mid[k]:.2f} ms, bound {bounds[k][2]:.2f}"
            for k in range(5))
        + f"; layer 1 (csrc/l1.cu) {per_layer[0]:.2f} ms, layer 7 "
        f"(csrc/l7.cu, the f32 fold) {per_layer[6]:.2f} ms; the two runs: "
        + " / ".join(f"{t[1:6].sum():.2f}" for t in turns)
        + f" ms; cuDNN f32 layers 2-6 (TF32 off) {lib_mid:.2f} ms; "
        f"mma_layer_plain layers 2-6 (host clock) {plain_ms:.1f} ms")
    log(f"phase 22 f32 noise stack at ns1080, whole: 3xTF32 "
        f"{stack_ms:.2f} ms (runs " + " / ".join(f"{v:.2f}" for v in whole)
        + f"), bound {stack_bound:.2f} ms (FFMA floor {stack_floor:.2f}), "
        f"cuDNN f32 stack (TF32 off) {lib_stack:.2f} ms, plain (a frame at "
        f"a time, host clock) {stack_plain_ms:.1f} ms; max|kernel - plain| "
        f"of the layers {err:.3e}; {time.perf_counter() - t0:.1f} s")
    del y
    torch.cuda.empty_cache()
    return [{
        "name": "conv3x3_bias_leaky_tf32, layers 2-6 of every f32 stack call "
                "as 3xTF32 on the tensor cores (wgmma)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/mma_tf32.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": main_launches,
        "launches_of": "phase 7's ns1080 chain with an f32 noise stack",
        "max_abs_err": err,
        "ms": float(mid.sum()),
        "layer_ms": [float(v) for v in mid],
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "operations",
        "ffma_floor_ms": floor,
        "library_ms": lib_mid,
    }, {
        "name": "the f32 noise stack at ns1080 (stack_noise, f32: layers 2-6 "
                "3xTF32, layers 1 and 7 csrc/l1.cu and csrc/l7.cu)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/mma_tf32.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": main_launches,
        "launches_of": "phase 7's ns1080 chain with an f32 noise stack "
                       "(3xTF32 launches)",
        "max_abs_err": err,
        "ms": stack_ms,
        "plain_ms": stack_plain_ms,
        "bound_ms": stack_bound,
        "bound_by": "operations",
        "ffma_floor_ms": stack_floor,
        "library_ms": lib_stack,
    }]


def library_l1_ms(x: torch.Tensor, sp, full_res: bool) -> float:
    """Library yardstick (never called by the port): layer 1 as one cuDNN
    channels_last convolution 1 -> 32 + leaky_relu, TF32 off, in x's dtype,
    on the plane the stack reads: the nearest-2x upscale replicate-padded by
    7 (scale), or the plane padded by 7 (noise; even sizes)."""
    from waifu2x_torch.ops.convstack import no_tf32
    w, b = sp[0]
    wc = (w.float().reshape(1, 3, 3, 32).permute(3, 0, 1, 2).to(x.dtype)
          .contiguous(memory_format=torch.channels_last))
    bc = b.to(x.dtype)
    up = x if full_res else x.repeat_interleave(2, 1).repeat_interleave(2, 2)
    xpad = F.pad(up[:, None], (7,) * 4, mode="replicate").contiguous(
        memory_format=torch.channels_last)
    with no_tf32():
        ms = timed_ms(lambda: F.leaky_relu(F.conv2d(xpad, wc, bc), 0.1), 20)
    del xpad, up
    torch.cuda.empty_cache()
    return ms


def phase23(dev: torch.device, main_launches: int) -> list:
    """23. Layer 1 (csrc/l1.cu, through stack.l1_layer as every stack call
    reaches it) against its plain version (l1_plain), scale and noise, f32
    and bf16, at L7_SHAPES (random weights) and at scale512 and noise256
    (the shipped scale2.0x and noise1 weights): bf16 to one bf16 ulp, f32
    <= 3e-5, one "l1" launch a call. Then timed at scale512 and noise256,
    twice, with GB/s against the byte bound, beside cuDNN's layer 1 on the
    padded plane. `main_launches` is the "l1" count of phase
    4's main path. Returns the kernel table's row."""
    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.ops import stack
    from waifu2x_torch.utils.timing import card_name

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    gen = torch.Generator(device=dev).manual_seed(23)
    sps = {}
    for dt in (torch.float32, torch.bfloat16):
        sps[dt] = {"rand": stack.prep_params(init_params(3), dt, dev)}
        for name, model in (("scale", "scale2.0x"), ("noise", "noise1")):
            sps[dt][name] = stack.prep_params(load_model_json(
                root / "models" / f"{model}_demo.json"), dt, dev)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    share = 0.0
    main = {False: (16, 512, 512), True: (256, 256, 256)}
    for dt in err:
        for full_res in (False, True):
            for shape in (*L7_SHAPES, main[full_res]):
                is_main = shape == main[full_res]
                sp = sps[dt]["noise" if full_res else "scale"] if is_main \
                    else sps[dt]["rand"]
                x = torch.rand(shape, device=dev, generator=gen).to(dt)
                stack.reset_launches()
                got = stack.l1_layer(x, sp, full_res)
                torch.cuda.synchronize()
                expect_l1(stack, f"layer 1 alone {shape}", 1)
                if stack.LAUNCHES:
                    raise AssertionError("layer 1 alone counted as a stack")
                c = 2 if is_main and shape[0] > 16 else 1
                ref = torch.cat([stack.l1_plain(x[i:i + c], sp, full_res)
                                 for i in range(0, shape[0], c)])
                what = (f"layer 1 {'noise' if full_res else 'scale'} "
                        f"{shape} {dt}")
                if dt == torch.float32:
                    e = check_f32(what, got, ref)
                else:
                    e, sh = check_mma_layer(what, got, ref)
                    share = max(share, sh)
                err[dt] = max(err[dt], e)
                del got, ref, x
        torch.cuda.empty_cache()
    log(f"phase 23 layer 1 (csrc/l1.cu) against l1_plain at "
        f"{', '.join(map(str, L7_SHAPES))}, scale512 and noise256, scale and "
        f"noise: f32 max|diff| {err[torch.float32]:.3e} (bar 3e-5), bf16 "
        f"{err[torch.bfloat16]:.3e} ({share:.4%} of outputs differ; bar one "
        f"bf16 ulp)")

    # timed twice, beside cuDNN
    rows = {}
    for full_res in (False, True):
        for dt in (torch.bfloat16, torch.float32):
            shape = main[full_res]
            sp = sps[dt]["noise" if full_res else "scale"]
            x = torch.rand(shape, device=dev, generator=gen).to(dt)
            # 20 calls back to back: at a few tenths of a ms each, the
            # host's launch of the first would weigh in a mean of 3
            t = [timed_ms(lambda: stack.l1_layer(x, sp, full_res), 20)
                 for _ in range(2)]
            n, ph, pw = shape
            hg, wg = (ph // 2, pw // 2) if full_res else (ph, pw)
            size = x.element_size()
            out_b = n * (2 * hg + 12) * (2 * wg + 12) * 32 * size
            in_b = x.numel() * size + 32 * 4 + (9 * 32 if full_res
                                                 else 9 * 128) * size
            macs = (9 if full_res else 4) * 32 * n * (2 * hg + 12) * (
                2 * wg + 12)
            bound = max((in_b + out_b) / PEAK_BYTES,
                        2 * macs / PEAK_F32_FLOPS) * 1e3
            rows[(full_res, dt)] = {
                "new": sum(t) / 2, "turns": t, "bound": bound,
                "bytes": in_b + out_b,
                "library": library_l1_ms(x, sp, full_res)}
            if dt == torch.bfloat16 and not full_res:
                t1 = time.perf_counter()
                for i in range(n):
                    stack.l1_plain(x[i:i + 1], sp)
                torch.cuda.synchronize()
                rows[(full_res, dt)]["plain"] = (
                    time.perf_counter() - t1) * 1e3
            del x
            torch.cuda.empty_cache()
    def tag(fr, dt):
        return (f"{'noise256' if fr else 'scale512'} "
                f"{'f32' if dt == torch.float32 else 'bf16'}")

    log(f"phase 23 layer 1 alone on {card_name()}: " + "; ".join(
        f"{tag(fr, dt)} l1.cu {r['new']:.3f} ms (runs "
        + " / ".join(f"{v:.3f}" for v in r["turns"])
        + f"; {r['bytes'] / r['new'] / 1e6:.0f} GB/s = "
        f"{100 * r['bound'] / r['new']:.1f}% of the bound {r['bound']:.3f} ms"
        f" by bytes); cuDNN {r['library']:.3f} ms"
        for (fr, dt), r in rows.items())
        + f"; plain (scale512 bf16, a frame at a time, host clock) "
        f"{rows[(False, torch.bfloat16)]['plain']:.1f} ms; "
        f"{time.perf_counter() - t0:.1f} s")
    r = rows[(False, torch.bfloat16)]
    return [{
        "name": "l1_conv, layer 1 (1 -> 32) of every stack call: the scale "
                "stack's phase sums on the low-res plane, the noise stack's "
                "9 taps on the full-res plane",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/l1.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "replaces_part": "_stack_body's layer 1 (l1q, :395-421)",
        "launches": main_launches,
        "max_abs_err": max(err.values()),
        "ms": r["new"],
        "form_ms": {tag(*key): v["new"] for key, v in rows.items()},
        "form_bound_ms": {tag(*key): v["bound"] for key, v in rows.items()},
        "form_library_ms": {tag(*key): v["library"]
                            for key, v in rows.items()},
        "plain_ms": r["plain"],
        "bound_ms": r["bound"],
        "bound_by": "bytes",
        "library_ms": r["library"],
    }]


def library_l7_f32_ms(x6: torch.Tensor, sp32) -> float:
    """Library yardstick (never called by the port): layer 7 alone as one
    cuDNN f32 channels_last convolution 128 -> 1 + leaky_relu, TF32 off, on
    the NHWC f32 layer-6 plane x6 (a channels_last view, no copy)."""
    from waifu2x_torch.ops.convstack import no_tf32
    (w, b), = cudnn_f32(sp32[6:7])
    xc = x6.permute(0, 3, 1, 2)
    with no_tf32():
        ms = timed_ms(lambda: F.leaky_relu(F.conv2d(xc, w, b), 0.1))
    torch.cuda.empty_cache()
    return ms


def phase24(dev: torch.device, main_launches: int) -> list:
    """24. Layer 7 of the f32 stacks folded with FFMA (csrc/l7.cu's
    l7_fold_f32, reached through stack.last_layer as every f32 stack
    reaches it) against its plain version (l7_fold_plain, then last_out) in
    its three output forms, at the layer-7 planes of L7_SHAPES (random
    weights) and of ns1080's noise stack and scale512 (the shipped noise2
    and scale2.0x weights, f32): s2d and dense within 3e-5, dense
    un-chunked equal to s2d bit for bit and its pad columns zero, u8 by
    check_u8_kernel, each call one launch under L7_LAUNCHES["fold_f32"].
    Then at ns1080 (s2d) and scale512 (each form) each form held against
    last_layer_plain's Y (the nine taps summed per pixel) at the same bars
    and timed alone, twice, beside cuDNN's f32 layer 7 alone (TF32 off),
    the plain version and the byte bound. `main_launches` is the fold's f32 count in phase 7's f32-noise
    chain. Returns the kernel table's row."""
    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.ops import stack
    from waifu2x_torch.utils.timing import card_name

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    sp_r = stack.prep_params(init_params(3), torch.float32, dev)
    sp_n = stack.prep_params(load_model_json(
        root / "models" / "noise2_demo.json"), torch.float32, dev)
    sp_s = stack.prep_params(load_model_json(
        root / "models" / "scale2.0x_demo.json"), torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(24)
    ns = (NS1080[0], NS1080[1] // 2, NS1080[2] // 2)
    cases = [(shape, sp_r) for shape in L7_SHAPES]
    cases += [(ns, sp_n), ((16, 512, 512), sp_s)]
    err = {"s2d": 0.0, "dense": 0.0, "u8": 0}
    share = 0.0
    planes = {}
    for (n, hl, wl), sp in cases:
        x6 = torch.rand((n, 2 * hl + 2, 2 * wl + 2, 128), device=dev,
                        generator=gen)
        uvp = torch.rand((n, hl, wl, 8), device=dev, generator=gen)
        chunk = max(1, int(2e9 // (x6[0].numel() * 4)))
        y32 = torch.cat([stack.l7_fold_plain(x6[i:i + chunk], sp.w7f,
                                             sp[6][1])
                         for i in range(0, n, chunk)])
        label = f"f32 layer 7 fold {(n, hl, wl)}"
        stack.reset_launches()
        got = stack.last_layer(x6, sp)
        torch.cuda.synchronize()
        expect_l7(stack, label + " s2d", f32=1)
        err["s2d"] = max(err["s2d"], check_f32(label + " s2d", got, y32))
        ydense, tc = stack.last_layer(x6, sp, out="dense")
        check_dense_pad(label + " dense", ydense, tc, wl)
        if not torch.equal(stack.dense_to_s2d(ydense, tc, hl, wl), got):
            raise AssertionError(f"{label} dense: un-chunked output "
                                 f"differs from s2d")
        err["dense"] = max(err["dense"], check_f32(
            label + " dense", ydense,
            stack.last_out(y32, "dense", torch.float32, tc=tc)[0]))
        del ydense, got
        got = stack.last_layer(x6, sp, out="u8", uvp=uvp)
        check_lanes_zero(label + " u8", got)
        e, sh = check_u8_kernel(label + " u8", got,
                                stack.last_out(y32, "u8", torch.float32,
                                               uvp), torch.float32)
        err["u8"], share = max(err["u8"], e), max(share, sh)
        expect_l7(stack, label, f32=3)
        del got, y32
        if n > 2:
            planes[(n, hl, wl)] = (x6, uvp, sp)
        else:
            del x6, uvp
        torch.cuda.empty_cache()
    log(f"phase 24 f32 layer 7 fold at {', '.join(map(str, L7_SHAPES))}, "
        f"ns1080 {ns} and scale512 x6 planes: max|kernel - plain| s2d "
        f"{err['s2d']:.3e}, dense {err['dense']:.3e} (bar 3e-5), dense "
        f"un-chunked == s2d bit for bit, u8 {err['u8']} level at "
        f"{share:.4%} of bytes")

    def bound_ms(x6, out_bytes):
        """Bytes: x6 read once, w7 and b, the output written once; the
        operations: the 4 x 9 x 128 FMA a cell that w7f does not hold as
        zeros, at the f32 peak."""
        n, h6, w6, _ = x6.shape
        cells = n * (h6 // 2) * (w6 // 2)
        moved = x6.numel() * 4 + 128 * 9 * 4 + 4 + out_bytes
        ops = 2 * 4 * 9 * 128 * cells
        return (max(moved / PEAK_BYTES, ops / PEAK_F32_FLOPS) * 1e3,
                "bytes" if moved / PEAK_BYTES >= ops / PEAK_F32_FLOPS
                else "operations", moved)

    rows = {}
    taps_err = {"s2d": 0.0, "dense": 0.0, "u8": 0}
    for key, forms in ((ns, ("s2d",)), ((16, 512, 512),
                                        ("s2d", "dense", "u8"))):
        x6, uvp, sp = planes.pop(key)
        n, hl, wl = key
        kw = {"s2d": {}, "dense": {"out": "dense"},
              "u8": {"out": "u8", "uvp": uvp}}
        tc = stack._dense_tc(wl, None)
        # the same function summed tap by tap: each form timed below
        # against last_layer_plain's f32 Y
        yf = torch.cat([stack.last_layer_plain(x6[i:i + 2], sp[6][0],
                                               sp[6][1])
                        for i in range(0, n, 2)])
        label = f"f32 layer 7 fold against the per-pixel sum {key}"
        for form in forms:
            got = stack.last_layer(x6, sp, **kw[form])
            if form == "s2d":
                e = check_f32(label + " s2d", got, yf)
            elif form == "dense":
                e = check_f32(label + " dense", got[0], stack.last_out(
                    yf, "dense", torch.float32, tc=got[1])[0])
            else:
                e = check_u8_kernel(label + " u8", got, stack.last_out(
                    yf, "u8", torch.float32, uvp), torch.float32)[0]
            taps_err[form] = max(taps_err[form], e)
            del got
        del yf
        torch.cuda.empty_cache()
        out_bytes = {"s2d": n * hl * wl * 4 * 4,
                     "dense": n * hl * -(-wl // tc) * 4 * tc * 4,
                     "u8": n * hl * wl * (16 + 8 * 4)}
        for form in forms:
            turns = [timed_ms(lambda: stack.last_layer(x6, sp, **kw[form]))
                     for _ in range(2)]
            b, by, moved = bound_ms(x6, out_bytes[form])
            rows[(key, form)] = {
                "fold": sum(turns) / 2, "turns": turns, "bound": b,
                "bound_by": by, "moved": moved}
        rows[(key, "s2d")]["library"] = library_l7_f32_ms(x6, sp)
        t1 = time.perf_counter()
        for i in range(0, n, 2):
            stack.l7_fold_plain(x6[i:i + 2], sp.w7f, sp[6][1])
        torch.cuda.synchronize()
        rows[(key, "s2d")]["plain"] = (time.perf_counter() - t1) * 1e3
        del x6, uvp
        torch.cuda.empty_cache()

    def tag(key):
        return "ns1080" if key == ns else "scale512"

    log(f"phase 24 f32 layer 7 alone on {card_name()}: " + "; ".join(
        f"{tag(key)} {form} fold {r['fold']:.3f} ms (runs "
        + " / ".join(f"{v:.3f}" for v in r["turns"])
        + f"; {r['moved'] / r['fold'] / 1e6:.0f} GB/s = "
        f"{100 * r['bound'] / r['fold']:.1f}% of the bound {r['bound']:.3f} "
        f"ms by {r['bound_by']})"
        + (f"; cuDNN f32 layer 7 alone (TF32 off) {r['library']:.3f} ms; "
           f"plain (l7_fold_plain, two frames at a time, host clock) "
           f"{r['plain']:.1f} ms" if "library" in r else "")
        for (key, form), r in rows.items())
        + f"; the fold against last_layer_plain: max|diff| "
        f"s2d {taps_err['s2d']:.3e}, dense {taps_err['dense']:.3e} (bar "
        f"3e-5), u8 {taps_err['u8']} level; {time.perf_counter() - t0:.1f} s")
    r = rows[(ns, "s2d")]
    s512 = rows[((16, 512, 512), "s2d")]
    return [{
        "name": "l7_fold_f32, layer 7 (128 -> 1) of every f32 stack call on "
                "a plane as the folded tap product, FFMA on the w7 taps that "
                "w7f holds (L7-32)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/l7.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "replaces_part": "_stack_body's layer 7 with l7_fold in f32, "
                         ":489-508 and :603-655",
        "launches": main_launches,
        "launches_of": "phase 7's ns1080 chain with an f32 noise stack",
        "max_abs_err": max(err["s2d"], err["dense"]),
        "max_abs_err_u8_levels": err["u8"],
        "ms": r["fold"],
        "per_pixel_max_abs_err": max(taps_err["s2d"], taps_err["dense"]),
        "per_pixel_max_abs_err_u8_levels": taps_err["u8"],
        "plain_ms": r["plain"],
        "bound_ms": r["bound"],
        "bound_by": r["bound_by"],
        "library_ms": r["library"],
        "scale512_ms": {form: rows[((16, 512, 512), form)]["fold"]
                        for form in ("s2d", "dense", "u8")},
        "scale512_bound_ms": s512["bound"],
        "scale512_library_ms": s512["library"],
        "scale512_plain_ms": s512["plain"],
    }]


def phase25(dev: torch.device, main_launches: int) -> list:
    """25. The int8 layer 6 (B4) on the int8 tensor cores (csrc/i8.cu,
    reached through stack.l6_i8_layer as every stack under l6_i8 reaches
    it; phase 14a held it bit for bit) timed alone at scale512 with the
    default tile, twice, each call the layer alone from the tile maxima
    (taken once by tile_max_plain: on the stacks layer 5's epilogue takes
    them, phase 32), beside its bound (the int8 multiply-adds of the tile
    windows at the int8 peak, or x5 read and the tile-major x6 written
    once), the plain version and cuDNN's bf16 layer 6 on the same plane (a
    different function: no quantisation, no tiles); its output on the timed
    plane must equal the plain version's bit for bit (the row's
    max_abs_err). `main_launches` is the
    layer's I8_LAUNCHES["mma"] count in phase 15's scale512 stream. Returns
    the kernel table's row."""
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.ops import stack
    from waifu2x_torch.utils.timing import card_name

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    sp = stack.prep_params(load_model_json(
        root / "models" / "scale2.0x_demo.json"), torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(25)
    n, hl, wl = 16, 512, 512
    tile = stack.default_tile(hl, wl)
    ylow = torch.rand((n, hl, wl), device=dev, generator=gen).to(
        torch.bfloat16)
    x5 = stack.layer5_plane(ylow, sp, tile)
    del ylow
    tr, tc = tile
    ny, nx = (x5.shape[1] - 4) // (2 * tr), (x5.shape[2] - 4) // (2 * tc)
    m = stack.tile_max_plain(x5, tile)
    turns = [timed_ms(lambda: stack.l6_i8_layer(x5, sp, tile, m=m))
             for _ in range(2)]
    ms = sum(turns) / 2
    stack.reset_launches()
    x6t, sx = stack.l6_i8_layer(x5, sp, tile, m=m)
    torch.cuda.synchronize()
    if stack.I8_LAUNCHES != {"mma": 1, "l5max": 0}:
        raise AssertionError(f"int8 layer 6 alone: {stack.I8_LAUNCHES}")
    lib_ms = library_l6_ms(x5, sp)
    t1 = time.perf_counter()
    plain = [stack.l6_i8_layer_plain(x5[i:i + 1], sp, tile)
             for i in range(n)]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    # the timed plane's output against the plain version's: bit for bit
    err = max(max((x6t[i:i + 1].float() - p6.float()).abs().max().item(),
                  (sx[i:i + 1] - psx).abs().max().item())
              for i, (p6, psx) in enumerate(plain))
    del plain, x6t, sx
    if err != 0.0:
        raise AssertionError(f"int8 layer 6 alone at scale512: max|wgmma - "
                             f"plain| {err}, want bit for bit")
    tiles = n * ny * nx
    outputs = tiles * (2 * tr + 2) * (2 * tc + 2)
    macs = outputs * 128 * 9 * 128
    moved = x5.numel() * 2 + outputs * 128 * 2 + 128 * 9 * 128 + 4 * 128 * 2
    ops_ms = 2 * macs / PEAK_INT8_OPS * 1e3
    bytes_ms = moved / PEAK_BYTES * 1e3
    bound = max(ops_ms, bytes_ms)
    log(f"phase 25 int8 layer 6 alone (from the tile maxima) at scale512, x5 "
        f"{tuple(x5.shape)} bf16, tile {tile} ({tiles} tiles), on "
        f"{card_name()}: wgmma {ms:.3f} ms (runs "
        + " / ".join(f"{v:.3f}" for v in turns)
        + f"; {2 * macs / ms / 1e9:.1f} TOPS = "
        f"{100 * bound / ms:.1f}% of the bound {bound:.3f} ms: int8 "
        f"products {ops_ms:.3f} ms, bytes {bytes_ms:.3f} ms); cuDNN bf16 "
        f"layer 6 on the same "
        f"plane (a different function) {lib_ms:.3f} ms; plain "
        f"(l6_i8_layer_plain, a frame at a time, host clock) "
        f"{plain_ms:.1f} ms; max|wgmma - plain| on this plane {err} (bit for "
        f"bit); {time.perf_counter() - t0:.1f} s")
    del x5
    torch.cuda.empty_cache()
    return [{
        "name": "l6_i8_mma, B4's int8 layer 6 on the int8 tensor cores "
                "(wgmma s8 x s8 -> s32; the layer alone, from the tile "
                "maxima)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/i8.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "replaces_part": "_stack_body's layer 6 with l6_i8=True",
        "launches": main_launches,
        "launches_of": "phase 15's scale512 stream under W2X_L6_I8",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": lib_ms,
        "library_is": "cuDNN bf16 layer 6, no quantisation",
    }]


def phase26(dev: torch.device, main_launches: int) -> list:
    """26. B4's layer 7 folded on the int8 layer 6's tile-major planes
    (csrc/l7.cu with a tiling, reached through stack.last_layer_tiles as
    every int8 stack reaches it) against its plain version (l7_tiles_plain
    cropped, then last_out) in its three output forms and both types, at the
    image shapes of L7_SHAPES with tiles (8, 16), (8, 16), (3, 5) (random
    weights) and at scale512 with the default tile (the shipped scale2.0x
    weights): bf16 s2d and dense to one bf16 ulp, f32 within 3e-5, dense
    un-chunked equal to s2d bit for bit and its pad columns zero, u8 by
    check_u8_kernel, each call one launch under L7_LAUNCHES["fold"] or
    ["fold_f32"]. Then at scale512 held in s2d against the nine taps summed
    per pixel of each tile (last_layer_plain's function) and timed alone in
    each form and type, twice, beside the byte bound, cuDNN's layer 7 on
    the tile batch as one convolution and the plain version. `main_launches`
    is the
    fold's count in phase 15's scale512 stream under int8. Returns the
    kernel table's row."""
    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.ops import stack
    from waifu2x_torch.utils.timing import card_name

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    params_s = load_model_json(root / "models" / "scale2.0x_demo.json")
    sps = {dt: (stack.prep_params(init_params(3), dt, dev),
                stack.prep_params(params_s, dt, dev))
           for dt in (torch.bfloat16, torch.float32)}
    gen = torch.Generator(device=dev).manual_seed(26)
    # layer 7's launches (bf16, f32) a call, by storage type
    kernel = {torch.bfloat16: (1, 0), torch.float32: (0, 1)}
    scale512 = (16, 512, 512)
    cases = [(shape, tile, 0) for shape, tile in
             zip(L7_SHAPES, ((8, 16), (8, 16), (3, 5)))]
    cases.append((scale512, stack.default_tile(*scale512[1:]), 1))
    err = {(dt, f): 0 for dt in sps for f in ("s2d", "dense", "u8")}
    share = 0.0
    planes = {}

    def x6t_of(n, hl, wl, tile, dt):
        tr, tc = tile
        ny, nx = -(-hl // tr), -(-wl // tc)
        return torch.rand((n, ny, nx, 2 * tr + 2, 2 * tc + 2, 128),
                          device=dev, generator=gen, dtype=dt)

    def plain_y(x6t, sp, hl, wl):
        """l7_tiles_plain, cropped, a few images at a time."""
        c = max(1, int(2e9 // (x6t[0].numel() * 4)))
        return torch.cat([stack.l7_tiles_plain(
            x6t[i:i + c], sp.w7f, sp[6][1])[:, :hl, :wl]
            for i in range(0, x6t.shape[0], c)])

    for dt, (sp_r, sp_s) in sps.items():
        for (n, hl, wl), tile, shipped in cases:
            sp = sp_s if shipped else sp_r
            x6t = x6t_of(n, hl, wl, tile, dt)
            uvp = torch.rand((n, hl, wl, 8), device=dev, generator=gen)
            y32 = plain_y(x6t, sp, hl, wl)
            label = f"int8 layer 7 fold {dt} {(n, hl, wl)} tile {tile}"
            stack.reset_launches()
            got = stack.last_layer_tiles(x6t, sp, hl, wl)
            torch.cuda.synchronize()
            expect_l7(stack, label + " s2d", *kernel[dt])
            ref = stack.last_out(y32, "s2d", dt)
            e = (check_f32(label + " s2d", got, ref) if dt == torch.float32
                 else check_mma_layer(label + " s2d", got, ref)[0])
            err[dt, "s2d"] = max(err[dt, "s2d"], e)
            ydense, tc = stack.last_layer_tiles(x6t, sp, hl, wl, out="dense")
            check_dense_pad(label + " dense", ydense, tc, wl)
            if not torch.equal(stack.dense_to_s2d(ydense, tc, hl, wl), got):
                raise AssertionError(f"{label} dense: un-chunked output "
                                     f"differs from s2d")
            ref = stack.last_out(y32, "dense", dt, tc=tc)[0]
            e = (check_f32(label + " dense", ydense, ref)
                 if dt == torch.float32
                 else check_mma_layer(label + " dense", ydense, ref)[0])
            err[dt, "dense"] = max(err[dt, "dense"], e)
            del ydense, got
            got = stack.last_layer_tiles(x6t, sp, hl, wl, out="u8", uvp=uvp)
            check_lanes_zero(label + " u8", got)
            e, sh = check_u8_kernel(label + " u8", got, stack.last_out(
                y32, "u8", dt, uvp), dt)
            err[dt, "u8"], share = max(err[dt, "u8"], e), max(share, sh)
            expect_l7(stack, label, *(3 * c for c in kernel[dt]))
            del got, y32
            if shipped:
                planes[dt] = (x6t, uvp, sp, tile)
            else:
                del x6t, uvp
            torch.cuda.empty_cache()
    log(f"phase 26 int8 layer 7 fold on the tile-major planes at "
        f"{', '.join(map(str, L7_SHAPES))} (tiles (8, 16), (8, 16), (3, 5)) "
        f"and scale512 (tile {stack.default_tile(512, 512)}): max|kernel - "
        f"plain| " + "; ".join(
            f"{'bf16' if dt == torch.bfloat16 else 'f32'} s2d "
            f"{err[dt, 's2d']:.3e}, dense {err[dt, 'dense']:.3e}, u8 "
            f"{err[dt, 'u8']} level" for dt in sps)
        + f" (bars: bf16 one ulp, f32 3e-5; u8 bytes differing at most "
        f"{share:.4%}); dense un-chunked == s2d bit for bit")

    rows = {}
    taps_err = {}
    for dt, (x6t, uvp, sp, tile) in planes.items():
        n, hl, wl = scale512
        kw = {"s2d": {}, "dense": {"out": "dense"},
              "u8": {"out": "u8", "uvp": uvp}}
        # the same function summed tap by tap: the fold's output against
        # the plain 9-tap sum of each tile, s2d
        label = f"int8 layer 7 fold against the per-pixel sum {dt} scale512"
        got = stack.last_layer_tiles(x6t, sp, hl, wl)
        yf = torch.cat([stack._tiles_image(stack._last_layer_f32(
            x6t[i:i + 1].reshape(-1, *x6t.shape[3:]), sp[6][0], sp[6][1]),
            1, *x6t.shape[1:3])[:, :hl, :wl] for i in range(n)])
        ref = stack.last_out(yf, "s2d", dt)
        taps_err[dt] = (check_f32(label, got, ref) if dt == torch.float32
                        else check_mma_layer(label, got, ref)[0])
        del got, yf, ref
        torch.cuda.empty_cache()
        size = 2 if dt == torch.bfloat16 else 4
        tc = stack._dense_tc(wl, None)
        out_bytes = {"s2d": n * hl * wl * 4 * size,
                     "dense": n * hl * -(-wl // tc) * 4 * tc * size,
                     "u8": n * hl * wl * (16 + 8 * 4)}
        tiles = x6t.shape[0] * x6t.shape[1] * x6t.shape[2]
        cells = tiles * (tile[0] + 1) * (tile[1] + 1)
        ops = (2 * 512 * 16 * cells if dt == torch.bfloat16
               else 2 * 4 * 9 * 128 * cells)
        peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
        in_bytes = x6t.numel() * size + 4
        for form in kw:
            turns = [timed_ms(lambda: stack.last_layer_tiles(
                x6t, sp, hl, wl, **kw[form])) for _ in range(2)]
            moved = in_bytes + out_bytes[form]
            rows[dt, form] = {
                "fold": sum(turns) / 2, "turns": turns, "moved": moved,
                "bound": max(moved / PEAK_BYTES, ops / peak) * 1e3,
                "bound_by": ("bytes" if moved / PEAK_BYTES >= ops / peak
                             else "operations")}
        lib = library_l7_ms if dt == torch.bfloat16 else library_l7_f32_ms
        rows[dt, "s2d"]["library"] = lib(
            x6t.view(-1, *x6t.shape[3:]), sp)
        t1 = time.perf_counter()
        for i in range(n):
            stack.last_out(stack.l7_tiles_plain(
                x6t[i:i + 1], sp.w7f, sp[6][1])[:, :hl, :wl], "s2d", dt)
        torch.cuda.synchronize()
        rows[dt, "s2d"]["plain"] = (time.perf_counter() - t1) * 1e3
        del x6t, uvp
        torch.cuda.empty_cache()
    planes.clear()
    log(f"phase 26 int8 layer 7 alone at scale512 (16 x {8} x {4} tiles of "
        f"130 x 258 x 128), on {card_name()}: " + "; ".join(
            f"{'bf16' if dt == torch.bfloat16 else 'f32'} {form} fold "
            f"{r['fold']:.3f} ms (runs "
            + " / ".join(f"{v:.3f}" for v in r["turns"])
            + f"; {r['moved'] / r['fold'] / 1e6:.0f} GB/s = "
            f"{100 * r['bound'] / r['fold']:.1f}% of the bound "
            f"{r['bound']:.3f} ms by {r['bound_by']})"
            + (f"; cuDNN layer 7 on the tile batch {r['library']:.3f} ms; "
               f"plain (l7_tiles_plain, a frame at a time, host clock) "
               f"{r['plain']:.1f} ms" if "library" in r else "")
            for (dt, form), r in rows.items())
        + f"; the fold held against the 9-tap plain version: bf16 "
        f"{taps_err[torch.bfloat16]:.3e}, f32 {taps_err[torch.float32]:.3e}; "
        f"{time.perf_counter() - t0:.1f} s")
    r16, r32 = rows[torch.bfloat16, "s2d"], rows[torch.float32, "s2d"]
    return [{
        "name": "l7_fold on the int8 layer 6's tile-major planes, layer 7 "
                "of every int8 stack call (B4-L7; bf16 l7_fold, f32 "
                "l7_fold_f32, with a tiling)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/l7.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "replaces_part": "_stack_body's int8 branch, then l7_tap and the "
                         "shift-sum, :551-585, :491-508, :603-655",
        "launches": main_launches,
        "launches_of": "phase 15's scale512 stream under W2X_L6_I8",
        "max_abs_err": max(err[torch.bfloat16, "s2d"],
                           err[torch.bfloat16, "dense"]),
        "max_abs_err_f32": max(err[torch.float32, "s2d"],
                               err[torch.float32, "dense"]),
        "max_abs_err_u8_levels": max(err[torch.bfloat16, "u8"],
                                     err[torch.float32, "u8"]),
        "ms": r16["fold"],
        "plain_ms": r16["plain"],
        "bound_ms": r16["bound"],
        "bound_by": r16["bound_by"],
        "library_ms": r16["library"],
        "form_ms": {f"{'bf16' if dt == torch.bfloat16 else 'f32'} {form}":
                    r["fold"] for (dt, form), r in rows.items()},
        "f32_ms": r32["fold"],
        "f32_bound_ms": r32["bound"],
        "f32_plain_ms": r32["plain"],
        "f32_library_ms": r32["library"],
    }]


def library_l6_f32_ms(x5: torch.Tensor, sp32) -> float:
    """Library yardstick (never called by the port): layer 6 alone as one
    cuDNN f32 channels_last convolution + leaky_relu, TF32 off, on the NHWC
    f32 layer-5 plane x5 (a channels_last view, no copy)."""
    from waifu2x_torch.ops.convstack import no_tf32
    (w, b), = cudnn_f32(sp32[5:6])
    xc = x5.permute(0, 3, 1, 2)
    with no_tf32():
        ms = timed_ms(lambda: F.leaky_relu(F.conv2d(xc, w, b), 0.1))
    torch.cuda.empty_cache()
    return ms


def phase27(dev: torch.device, main_launches: int, step=None) -> list:
    """27. B5's Winograd layer 6 in f32 on the tensor cores as 3xTF32
    (csrc/wino.cu's l6_wino_tf32, reached through stack.wino_layer as every
    f32 stack under l6_wino reaches it) against its plain version
    (_l6_wino_plain, V in f32) within 3e-5: alone at the layer-5 planes of
    L7_SHAPES (random weights) and at the ns1080 noise stack's and scale512's
    real f32 layer-5 planes (the shipped noise2 and scale2.0x weights, from
    layer5_plane), one WINO_LAUNCHES["mma_tf32"] launch a call; the f32
    dense and u8 stacks under l6_wino against theirs. Then timed alone at
    ns1080 and scale512, twice, beside the direct 3xTF32 layer 6, cuDNN's
    f32 layer 6 (TF32 off), the bound (three TF32 products
    of the function's 16 a block), the FFMA floor and the plain version; and
    the f32 noise stack at ns1080 under l6_wino against the direct one, with
    the f32-noise step where `step(l6_wino)` runs it. `main_launches` is
    the kernel's count in phase 15's ns1080 f32-noise chain under
    W2X_L6_WINO. Returns the kernel table's row."""
    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.ops import stack
    from waifu2x_torch.utils.timing import card_name

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    sp_r = stack.prep_params(init_params(3), torch.float32, dev)
    sp_n = stack.prep_params(load_model_json(
        root / "models" / "noise2_demo.json"), torch.float32, dev)
    sp_s = stack.prep_params(load_model_json(
        root / "models" / "scale2.0x_demo.json"), torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(27)

    def plain(x5, sp):
        """_l6_wino_plain (V in f32, TF32 off), a frame at a time, NHWC."""
        from waifu2x_torch.ops.convstack import no_tf32
        with no_tf32():
            return torch.cat([stack._l6_wino_plain(
                x5[i:i + 1].permute(0, 3, 1, 2), sp, torch.float32
            ).permute(0, 2, 3, 1) for i in range(x5.shape[0])])

    def alone(x5, sp, label) -> float:
        stack.reset_launches()
        got = stack.wino_layer(x5, sp)
        torch.cuda.synchronize()
        want = {"mma": 0, "mma_tf32": 1}
        if stack.WINO_LAUNCHES != want or stack.LAUNCHES:
            raise AssertionError(f"{label}: launches {stack.WINO_LAUNCHES}, "
                                 f"{stack.LAUNCHES}, want {want}")
        return check_f32(label, got, plain(x5, sp))

    err = 0.0
    for n, hl, wl in L7_SHAPES:
        x5 = torch.rand((n, 2 * hl + 4, 2 * wl + 4, 128), device=dev,
                        generator=gen)
        err = max(err, alone(x5, sp_r, f"f32 wino layer 6 {(n, hl, wl)}"))
    y = torch.rand(L7_SHAPES[0], device=dev, generator=gen)
    uvp = torch.rand((*L7_SHAPES[0], 8), device=dev, generator=gen)
    ydense, tc = stack.stack_scale_dense(y, sp_r, l6_wino=True)
    check_f32("f32 wino dense stack", ydense, stack.stack_scale_dense_plain(
        y, sp_r, tc, l6_wino=True)[0])
    check_u8_kernel("f32 wino u8 stack", stack.stack_scale_fused_u8(
        y, uvp, sp_r, l6_wino=True), stack.stack_scale_fused_u8_plain(
        y, uvp, sp_r, l6_wino=True), torch.float32)
    ns = (NS1080[0], NS1080[1] // 2, NS1080[2] // 2)
    yc = torch.rand(NS1080, device=dev, generator=gen)
    ylow = torch.rand((16, 512, 512), device=dev, generator=gen)
    real = {"ns1080": (stack.layer5_plane(yc, sp_n, full_res=True), sp_n),
            "scale512": (stack.layer5_plane(ylow, sp_s), sp_s)}
    del ylow
    for key, (x5, sp) in real.items():
        err = max(err, alone(x5, sp, f"f32 wino layer 6 {key}"))
        torch.cuda.empty_cache()
    log(f"phase 27 f32 Winograd layer 6 (3xTF32) at "
        f"{', '.join(map(str, L7_SHAPES))} and the ns1080 "
        f"{tuple(real['ns1080'][0].shape)} and scale512 "
        f"{tuple(real['scale512'][0].shape)} layer-5 planes: "
        f"max|kernel - plain| {err:.3e} (bar 3e-5); the f32 dense and u8 "
        f"stacks under l6_wino hold")

    rows = {}
    plan = stack.wino_plan(torch.float32)
    for key, (x5, sp) in real.items():
        n, h5, w5, _ = x5.shape
        turns = [timed_ms(lambda: stack.wino_layer(x5, sp))
                 for _ in range(2)]
        blocks = n * ((h5 - 2) // 2) * ((w5 - 2) // 2)
        flops = 2 * blocks * 16 * 128 * 128   # the function's products
        moved = (x5.numel() + n * (h5 - 2) * (w5 - 2) * 128 + 2 * 16 * 128
                 * 128 + 128) * 4
        ops_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
        bytes_ms = moved / PEAK_BYTES * 1e3
        # the kernel's units, each of which stages U's share for its
        # channels (hi and lo) from L2 once
        tile = plan.tile[0]
        units = (n * -(-((h5 - 2) // 2) // tile) * -(-((w5 - 2) // 2) // tile)
                 * (128 // plan.co))
        r = {"tf32": sum(turns) / 2, "turns": turns, "flops": flops,
             "u_gb": units * 16 * 128 * plan.co * 8 / 1e9,
             "bound": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
             "bytes_ms": bytes_ms,
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
             "floor": flops / PEAK_F32_FLOPS * 1e3,
             "direct": timed_ms(lambda: stack.mma_layer(x5, sp, 6)),
             "library": library_l6_f32_ms(x5, sp)}
        t1 = time.perf_counter()
        plain(x5, sp)
        torch.cuda.synchronize()
        r["plain"] = (time.perf_counter() - t1) * 1e3
        rows[key] = r
        torch.cuda.empty_cache()
    del real
    torch.cuda.empty_cache()
    # the f32 noise stack at ns1080 with each layer-6 form, and the step
    stack_ms = {w: timed_ms(lambda: stack.stack_noise(yc, sp_n, l6_wino=w))
                for w in (False, True)}
    step_ms = ({w: timed_ms(lambda: step(w)) for w in (False, True)}
               if step is not None else None)
    del yc
    torch.cuda.empty_cache()
    log(f"phase 27 f32 Winograd layer 6 alone on {card_name()}: " + "; ".join(
        f"{key} 3xTF32 {r['tf32']:.3f} ms (runs "
        + " / ".join(f"{v:.3f}" for v in r["turns"])
        + f"; {3 * r['flops'] / r['tf32'] / 1e9:.1f} TFLOP/s of TF32 "
        f"products = {100 * r['bound'] / r['tf32']:.1f}% of the bound "
        f"{r['bound']:.3f} ms by {r['bound_by']}: three TF32 products "
        f"{r['ops_ms']:.3f} ms, bytes {r['bytes_ms']:.3f} ms; FFMA floor "
        f"{r['floor']:.3f} ms; units of {plan.tile[0]} x {plan.tile[1]} "
        f"blocks x {plan.co} channels in chunks of {plan.kc}, U's halves "
        f"staged from L2 {r['u_gb']:.1f} GB = "
        f"{r['u_gb'] / r['tf32']:.2f} TB/s); direct 3xTF32 layer 6 "
        f"{r['direct']:.3f} ms; cuDNN f32 layer 6 (TF32 off) "
        f"{r['library']:.3f} ms; plain (_l6_wino_plain, a frame at a time, "
        f"host clock) {r['plain']:.1f} ms" for key, r in rows.items())
        + f"; ns1080 f32 noise stack {stack_ms[True]:.2f} ms under l6_wino, "
        f"{stack_ms[False]:.2f} ms direct"
        + (f"; f32-noise step {step_ms[True]:.2f} ms under l6_wino, "
           f"{step_ms[False]:.2f} ms direct" if step_ms else "")
        + f"; {time.perf_counter() - t0:.1f} s")
    r, s = rows["ns1080"], rows["scale512"]
    return [{
        "name": "l6_wino_tf32, B5's Winograd layer 6 in f32 on the tensor "
                "cores as 3xTF32 (wgmma m64n32k8, A from registers; B5-32)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/wino.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "replaces_part": "_stack_body's layer 6 with l6_wino=True in f32, "
                         ":509-550",
        "launches": main_launches,
        "launches_of": "phase 15's ns1080 f32-noise chain under W2X_L6_WINO",
        "max_abs_err": err,
        "ms": r["tf32"],
        "plain_ms": r["plain"],
        "bound_ms": r["bound"],
        "bound_by": r["bound_by"],
        "ffma_floor_ms": r["floor"],
        "library_ms": r["library"],
        "direct_tf32_ms": r["direct"],
        "scale512_ms": s["tf32"],
        "scale512_bound_ms": s["bound"],
        "scale512_library_ms": s["library"],
        "scale512_direct_tf32_ms": s["direct"],
        "ns1080_noise_stack_ms": stack_ms,
        "ns1080_step_ms": step_ms,
    }]


# the u8 bar between two routes of one conversion (__graft_entry__.py's):
# equal except |diff| <= 1 at under 0.2% of bytes
CLI_U8_FRAC = 0.002


class _RunRecords(logging.Handler):
    """Keeps the run record (record.w2x_run) that cli.main logs at its end."""

    def __init__(self):
        super().__init__()
        self.runs = []

    def emit(self, record):
        if hasattr(record, "w2x_run"):
            self.runs.append(record.w2x_run)


def cli_run(argv: list, what: str, totals: dict):
    """cli.main(argv) in this process, every launch count set to 0 just
    before it and read just after. Returns (the run record it logged, its
    launches, the codec calls it made); adds the launches to `totals`."""
    from waifu2x_torch import cli
    from waifu2x_torch import io as w2x_io
    from waifu2x_torch.ops import stack
    handler = _RunRecords()
    logger = logging.getLogger("waifu2x_torch.cli")
    logger.addHandler(handler)
    w2x_io.CODEC_CALLS.clear()
    stack.reset_launches()
    try:
        rc = cli.main([str(a) for a in argv])
    finally:
        logger.removeHandler(handler)
    launches = {"stack": stack.LAUNCHES, "l1": stack.L1_LAUNCHES["l1"],
                "mma": stack.MID_LAUNCHES["mma"],
                "mma_tf32": stack.MID_LAUNCHES["mma_tf32"],
                **{f"l7_{k}": v for k, v in stack.L7_LAUNCHES.items()}}
    codecs = {f"{op} {codec}": n
              for (op, codec), n in sorted(w2x_io.CODEC_CALLS.items())}
    if rc != 0 or len(handler.runs) != 1:
        raise AssertionError(f"phase 28 {what}: cli.main returned {rc}")
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v
    run = handler.runs[0]
    log(f"phase 28 {what}: rc 0, route {run['route']}, codecs {codecs}, "
        f"launches {launches}")
    return run, launches, codecs


def expect_hand_kernels(what: str, launches: dict, f32: bool) -> None:
    """The kernel route's launches (cli_run's or mesh_launches()' counts):
    layer 1, layers 2-6 on the tensor cores and layer 7 folded launched in
    bf16, and in f32 (3xTF32, the f32 fold) exactly where `f32`; no probe
    variant and no other layer-6 form."""
    need = ["l1", "mma", "l7_fold"] + (["mma_tf32", "l7_fold_f32"]
                                       if f32 else [])
    banned = ("chain", "mma_zs", "mma_pp", "l6_other") + (
        () if f32 else ("mma_tf32", "l7_fold_f32"))
    if (any(launches[k] == 0 for k in need)
            or any(launches.get(k, 0) for k in banned)):
        raise AssertionError(f"{what}: launches {launches}")


def phase28(dev: torch.device, smi: str) -> dict:
    """The command line end to end on the card (waifu2x_torch.cli.main, in
    this process, with the shipped weights from the default model dir):
    one 720 x 1280 PNG in the default mode and one 512 x 512 PNG in scale
    mode, each bit-equal to Converter.process_bgr_u8 of the decoded input
    and >= 50 dB against the f32 non-kernel path; four 512 x 512 PNGs in one
    call (the stream route), each at the u8 bar against the one-file call;
    StreamConverter.process_paths over the same four with a frame cursor,
    twice (the second run launches and writes nothing); a 1024 x 1024 PNG
    with --pallas off (the block tiler: its plane within 3e-5 of the
    monolithic F.conv2d plane, its output >= 50 dB against the kernel
    route's). Returns the launches of every CLI run, summed by kernel."""
    import dataclasses
    from waifu2x_torch import cli, native
    from waifu2x_torch import io as w2x_io
    from waifu2x_torch import pipeline as pipeline_mod
    from waifu2x_torch.ops import stack
    from waifu2x_torch.ops.resize import NEAREST, resize
    from waifu2x_torch.parallel import tiles
    from waifu2x_torch.pipeline import Converter, _to_yuv
    from waifu2x_torch.stream import StreamConverter
    from waifu2x_torch.utils.metrics import psnr

    t0 = time.perf_counter()
    log(f"phase 28 cli: the native runtime (native/libw2x_host.so) loads: "
        f"{native.available()}")
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    rng = np.random.default_rng(28)
    totals = {}

    def cfg_of(argv):
        return cli.config_from_args(cli.build_parser().parse_args(
            [str(a) for a in argv]))

    def one_file(img, extra, what, f32_noise):
        src, out = d / f"{what}.png", d / f"{what}_out.png"
        w2x_io.imwrite_bgr(str(src), img)
        argv = ["-i", src, "-o", out, *extra]
        run, launches, codecs = cli_run(argv, what, totals)
        expect_hand_kernels(f"phase 28 {what}", launches, f32_noise)
        decoded = w2x_io.imread_bgr(str(src))
        if not np.array_equal(decoded, img):
            raise AssertionError(f"phase 28 {what}: the PNG round trip "
                                 f"changed the input")
        got = w2x_io.imread_bgr(str(out))
        cfg = cfg_of(argv)
        want = Converter.from_config(cfg, dev).process_bgr_u8(decoded)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(
                f"phase 28 {what}: the CLI's output is not "
                f"Converter.process_bgr_u8's: {got.shape} {want.shape}, "
                f"{int((got != want).sum()) if got.shape == want.shape else '-'}"
                f" bytes differ")
        ref = Converter.from_config(dataclasses.replace(
            cfg, use_pallas=False, compute_dtype="float32"),
            dev).process_bgr_u8(decoded)
        db = psnr(got, ref)
        log(f"phase 28 {what}: {img.shape} -> {got.shape}, bit-equal to "
            f"Converter.process_bgr_u8, {db:.2f} dB against the f32 "
            f"non-kernel path")
        if not db >= PSNR_BAR:
            raise AssertionError(f"phase 28 {what}: {db} dB")
        log(f"phase 28 {what} wall time on {smi}, host clock: "
            f"{run['seconds']:.3f} s (decode {run['decode']:.3f} s, convert "
            f"{run['convert']:.3f} s, encode {run['encode']:.3f} s; "
            f"Converter.from_config and model load the rest); codecs "
            f"{codecs}")
        return run, got

    # 2. one file in the default mode (noise_scale: an f32 noise stack and
    # a bf16 scale stack), then the scale512 frame in scale mode
    one_run, _ = one_file(structured_bgr(rng, 1, 720, 1280)[0], [],
                          "one file 720x1280 noise_scale", True)
    one_file(structured_bgr(rng, 1, 512, 512)[0], ["-m", "scale"],
             "one file 512x512 scale", False)

    # 3. four files in one call: the stream route
    frames4 = structured_bgr(rng, 4, 512, 512)
    paths = [d / f"four{i}.png" for i in range(4)]
    for p, f in zip(paths, frames4):
        w2x_io.imwrite_bgr(str(p), f)
    run4, launches4, _ = cli_run(["-i", *paths], "four files 512x512 "
                                 "noise_scale", totals)
    expect_hand_kernels("phase 28 four files", launches4, True)
    if run4["route"] != "stream":
        raise AssertionError(f"phase 28 four files: route {run4['route']}")
    stream_outs, n_diff = [], []
    for i, p in enumerate(paths):
        out = w2x_io.imread_bgr(w2x_io.auto_output_name(
            str(p), "noise_scale", 1, 2.0))
        single = d / f"single{i}.png"
        cli_run(["-i", p, "-o", single], f"four files, file {i} alone",
                totals)
        worst, frac = check_u8(f"phase 28 four files, file {i}",
                               torch.from_numpy(out),
                               torch.from_numpy(w2x_io.imread_bgr(
                                   str(single))), 1, CLI_U8_FRAC)
        n_diff.append(int(round(frac * out.size)))
        stream_outs.append(out)
    log(f"phase 28 four files: stream against one file at a time, bytes "
        f"that differ by 1 (of {stream_outs[0].size} each): {n_diff}")
    log(f"phase 28 four files on {smi}: {run4['mp']:.2f} MP out in "
        f"{run4['seconds']:.3f} s, {run4['mp'] / run4['seconds']:.2f} MP/s "
        f"(host clock; decode {run4['decode']:.3f} s, convert "
        f"{run4['convert']:.3f} s, encode {run4['encode']:.3f} s)")

    # --profile: a torch.profiler Chrome trace (reported, not gated: CUPTI
    # tracing on the card's machine is the profiler's to give)
    trace_dir = d / "trace"
    cli_run(["-i", paths[0], "-o", d / "prof.png", "-m", "scale",
             "--profile", trace_dir], "--profile", totals)
    (trace,) = trace_dir.iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    device = [e for e in events if e.get("cat") == "kernel"]
    log(f"phase 28 --profile: {trace.name}, {len(events)} events, "
        f"{len(device)} device kernel events, "
        f"{sum(e.get('dur', 0) for e in device) / 1e3:.3f} ms of kernel "
        f"time; kernels "
        + ", ".join(sorted({e['name'].split('(')[0][:40] for e in device})))

    # process_paths with a frame cursor, twice
    conv = Converter.from_config(cfg_of(["-i", paths[0]]), dev)
    sc = StreamConverter(fast=conv.fast_scale, fast_noise=conv.fast_noise,
                         mode="noise_scale", device=dev)
    outs, ckpt = [d / f"pp{i}.png" for i in range(4)], d / "cursor.json"
    stack.reset_launches()
    sc.process_paths([str(p) for p in paths], [str(o) for o in outs],
                     checkpoint=str(ckpt))
    pp_launches = stack.LAUNCHES
    cursor = json.loads(ckpt.read_text())["cursor"]
    for i, (o, want) in enumerate(zip(outs, stream_outs)):
        check_u8(f"phase 28 process_paths, file {i}",
                 torch.from_numpy(w2x_io.imread_bgr(str(o))),
                 torch.from_numpy(want), 1, CLI_U8_FRAC)
    mtimes = [o.stat().st_mtime_ns for o in outs]
    w2x_io.CODEC_CALLS.clear()
    stack.reset_launches()
    sc.process_paths([str(p) for p in paths], [str(o) for o in outs],
                     checkpoint=str(ckpt))
    if (cursor != 4 or not pp_launches or stack.LAUNCHES
            or w2x_io.CODEC_CALLS
            or [o.stat().st_mtime_ns for o in outs] != mtimes):
        raise AssertionError(
            f"phase 28 process_paths: cursor {cursor}, launches "
            f"{pp_launches} then {stack.LAUNCHES}, codec calls on the "
            f"second run {dict(w2x_io.CODEC_CALLS)}")
    log(f"phase 28 process_paths: 4 files, {pp_launches} launches, cursor "
        f"{cursor}; the second run launched nothing and wrote nothing")

    # 4. the tiled route: --pallas off on a plane over 1.5 blocks
    big = structured_bgr(rng, 1, 1024, 1024)[0]
    src_big, out_t, out_k = d / "big.png", d / "big_tiled.png", d / "big_k.png"
    w2x_io.imwrite_bgr(str(src_big), big)
    plans = []
    orig = pipeline_mod.tiled_convert

    def spy(y, model, plan, batch_tiles):
        plans.append(plan)
        return orig(y, model, plan, batch_tiles)

    pipeline_mod.tiled_convert = spy
    argv_t = ["-i", src_big, "-o", out_t, "-m", "scale", "--pallas", "off"]
    try:
        _, launches_t, _ = cli_run(argv_t, "1024x1024 scale --pallas off",
                                   totals)
    finally:
        pipeline_mod.tiled_convert = orig
    if len(plans) != 1 or launches_t["stack"]:
        raise AssertionError(f"phase 28 tiled route: {len(plans)} tiled "
                             f"calls, launches {launches_t}")
    plan = plans[0]
    cfg_t = cfg_of(argv_t)
    model = Converter.from_config(cfg_t, dev).scale_model
    yuv = _to_yuv(torch.from_numpy(w2x_io.imread_bgr(str(src_big))).to(dev))
    h, w = yuv.shape[:2]
    y_in = resize(yuv[None, ..., 0], (2 * h, 2 * w), NEAREST, h_axis=1)
    tiled = tiles.tiled_convert(y_in[0], model, plan, cfg_t.batch_tiles)
    mono = model.convert_plane(y_in)[0]
    err = (tiled - mono).abs().max().item()
    log(f"phase 28 tiled route: plane {tuple(mono.shape)}, max|tiled - "
        f"monolithic| = {err:.3e} (f32, TF32 off)")
    check_max_err("phase 28 tiled against monolithic", err, F32_TOL)
    del tiled, mono, y_in, yuv
    torch.cuda.empty_cache()
    _, launches_k, _ = cli_run(["-i", src_big, "-o", out_k, "-m", "scale"],
                               "1024x1024 scale, kernel route", totals)
    expect_hand_kernels("phase 28 1024x1024 kernel route", launches_k,
                        False)
    db = psnr(w2x_io.imread_bgr(str(out_t)), w2x_io.imread_bgr(str(out_k)))
    log(f"phase 28 tiled route against the kernel route: {db:.2f} dB")
    if not db >= PSNR_BAR:
        raise AssertionError(f"phase 28 tiled against kernel: {db} dB")
    log(f"phase 28 tiled_convert on {smi}: plane {plan.h} x {plan.w}, "
        f"{plan.n_tiles} tiles of {plan.tile}^2 ({plan.ny} x {plan.nx}, "
        f"stride {plan.stride}), batch_tiles {cfg_t.batch_tiles}, "
        f"redundancy {plan.redundancy:.4f}")
    tmp.cleanup()
    log(f"phase 28 passed in {time.perf_counter() - t0:.1f} s; CLI launches "
        f"by kernel {totals}; one file's decode/convert/encode "
        f"{one_run['decode']:.3f}/{one_run['convert']:.3f}/"
        f"{one_run['encode']:.3f} s")
    return totals


MESH_SHAPES = ((1, 1, 1), (2, 2, 2), (1, 2, 4))   # virtual meshes of a card


def mesh_launches() -> dict:
    """Every layer kernel's launch count since the last reset."""
    from waifu2x_torch.ops import stack
    return {"l1": stack.L1_LAUNCHES["l1"],
            **{k: v for k, v in stack.MID_LAUNCHES.items()},
            **{f"l7_{k}": v for k, v in stack.L7_LAUNCHES.items()},
            "l6_other": sum(v for k, v in stack.L6_LAUNCHES.items()
                            if k != "direct")}


def expect_mesh(what: str, launches: dict, f32: int, bf16: int) -> None:
    """`f32` and `bf16` stack calls, each on the hand kernels alone: one
    layer 1 (csrc/l1.cu), five layers 2-6 on the tensor cores (3xTF32 for
    f32; bf16 on the persistent kernel's routes, four resident and one
    split) and one folded layer 7; no other launch and no other layer-6
    form."""
    want = {"l1": f32 + bf16, "mma": 5 * bf16, "mma_tf32": 5 * f32,
            "mma_resident": 4 * bf16, "mma_split": bf16,
            "l7_fold": bf16, "l7_fold_f32": f32}
    rest = {k: v for k, v in launches.items() if k not in want and v}
    if {k: launches[k] for k in want} != want or rest:
        raise AssertionError(f"phase 29 {what}: launches {launches}, want "
                             f"{want} and nothing else")


def phase29(dev: torch.device, smi: str) -> dict:
    """The multi-device layer on the card (waifu2x_torch/parallel/), with the
    shipped weights at full width and depth. MeshPipeline over virtual
    meshes of the one card, (1, 1, 1), (2, 2, 2) and (1, 2, 4) (every
    position on the card; the shards run one after another), against the
    single-device path: ns1080 noise_scale (4 x 1080 x 1920, the f32 noise
    stack and the bf16 scale stack; the denoised plane bit-equal, the u8
    output at the u8 bar), scale512 (16 x 512^2), ratio 4 and ratio 3 at
    512^2 and noise256 (256 x 256^2); the launch counts set to 0 before
    each mesh call and read after it (the hand kernels only, one stack call
    a position and stack); the (2, 2, 2) shards' wrapper calls held against
    the plain versions. Then Converter.from_config(Config(mesh="1x1")), a
    StreamConverter on a (1, 1, 1) mesh and the CLI with --mesh 1x1, each
    against its one-device run; the mesh steps timed in turns against the
    single-device steps (CUDA events, and the host's clock with the
    transfers), scaling_probe's overhead, the halo redundancy and the peak
    memory. Returns the mesh calls' launches, summed by kernel."""
    import dataclasses
    from waifu2x_torch import cli
    from waifu2x_torch import io as w2x_io
    from waifu2x_torch import pipeline as pipeline_mod
    from waifu2x_torch.config import Config
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.models.zoo import ensure_default_models
    from waifu2x_torch.ops import stack
    from waifu2x_torch.ops.resize import LINEAR, resize
    from waifu2x_torch.ops.s2d import d2s_host_cmajor
    from waifu2x_torch.parallel import mesh as w2x_mesh
    from waifu2x_torch.parallel.mesh_pipeline import (
        HALO_NOISE, HALO_SCALE, MeshPipeline, make_mesh3)
    from waifu2x_torch.pipeline import (
        Converter, FastStack, _to_bgr_u8, _to_yuv, noise_batch_u8_fused,
        noise_y_batch_fast, scale2x_batch_fast, scale2x_batch_u8_fused)
    from waifu2x_torch.stream import StreamConverter, resolve_stream_mesh
    from waifu2x_torch.tools import scaling_probe

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    p_s, p_n1, p_n2 = (load_model_json(root / "models" / f"{m}_demo.json")
                       for m in ("scale2.0x", "noise1", "noise2"))
    fs16 = FastStack.build(p_s, True, torch.bfloat16, dev)
    fn2_32 = FastStack.build(p_n2, False, torch.float32, dev)
    fn1_16 = FastStack.build(p_n1, False, torch.bfloat16, dev)
    twins = [(fs16.sp, stack.prep_params(p_s, torch.float32, dev)),
             (fn1_16.sp, stack.prep_params(p_n1, torch.float32, dev))]

    def f32_twin(sp):
        if sp[0][0].dtype == torch.float32:
            return sp
        for s16, s32 in twins:
            if all(torch.equal(a[0], b[0]) for a, b in zip(sp, s16)):
                return s32
        raise AssertionError("phase 29: bf16 weights of no shipped model")

    rng = np.random.default_rng(29)
    ns_frames = structured_bgr(rng, 4, 1080, 1920)
    s_frames = structured_bgr(rng, 16, 512, 512)
    r_frames = structured_bgr(rng, 2, 512, 512)
    n_frames = structured_bgr(rng, 256, 256, 256)

    def up(frames):
        return _to_yuv(torch.from_numpy(frames).to(dev))

    def host(u8):
        return d2s_host_cmajor(u8.cpu().numpy())

    # the single-device references (the ns1080 one's peak memory beside the
    # meshes')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    yuv = up(ns_frames)
    y_ref = noise_y_batch_fast(yuv[..., 0], fn2_32, out_dtype=None)
    ns_ref = host(scale2x_batch_u8_fused(yuv, fs16, y=y_ref))
    del yuv
    log(f"phase 29 ns1080 on one device: peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    s_ref = host(scale2x_batch_u8_fused(up(s_frames), fs16))
    mid = scale2x_batch_fast(up(r_frames), fs16)
    r4_ref = host(scale2x_batch_u8_fused(mid, fs16))
    full = scale2x_batch_fast(mid, fs16)
    dsize = (int(full.shape[1] * 0.75), int(full.shape[2] * 0.75))
    r3_ref = _to_bgr_u8(resize(full, dsize, LINEAR, h_axis=1)).cpu().numpy()
    del mid, full
    n_ref = host(noise_batch_u8_fused(up(n_frames), fn1_16))
    torch.cuda.empty_cache()

    cases = (  # name, pipeline arguments, frames, reference, f32 / bf16 stacks
        ("ns1080", dict(fast_scale=fs16, fast_noise=fn2_32,
                        mode="noise_scale"), ns_frames, ns_ref, 1, 1),
        ("scale512", dict(fast_scale=fs16), s_frames, s_ref, 0, 1),
        ("ratio 4 at 512^2", dict(fast_scale=fs16, scale_ratio=4.0),
         r_frames, r4_ref, 0, 2),
        ("ratio 3 at 512^2", dict(fast_scale=fs16, scale_ratio=3.0),
         r_frames, r3_ref, 0, 2),
        ("noise256", dict(fast_noise=fn1_16, mode="noise"), n_frames, n_ref,
         0, 1))
    totals, seen, max_err, timings = {}, {}, {}, []
    for shape in MESH_SHAPES:
        npos = int(np.prod(shape))
        mesh = make_mesh3(shape, [dev] * npos)
        for name, kw, frames, ref, n32, n16 in cases:
            pipe = MeshPipeline(mesh, **kw)
            restore = (record_wrapper_calls(pipeline_mod, seen)
                       if shape == (2, 2, 2) else (lambda: None))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stack.reset_launches()
            try:
                got = pipe.convert_bgr_u8(frames)
            finally:
                restore()
            torch.cuda.synchronize()
            launches = mesh_launches()
            peak = torch.cuda.max_memory_allocated() / 1e9
            expect_mesh(f"{name} on {shape}", launches, n32 * npos,
                        n16 * npos)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            worst, frac = check_u8(f"phase 29 {name} on {shape}",
                                   torch.from_numpy(got),
                                   torch.from_numpy(ref), 1, CLI_U8_FRAC)
            log(f"phase 29 {name} on mesh {shape} ({npos} positions on one "
                f"card): {got.shape}, {int(round(frac * got.size))} of "
                f"{got.size} bytes differ from the single device (max "
                f"{worst}), launches l1 {launches['l1']} mma "
                f"{launches['mma']} mma_tf32 {launches['mma_tf32']} fold "
                f"{launches['l7_fold']} fold_f32 {launches['l7_fold_f32']}; "
                f"peak memory {peak:.2f} GB")
            if name == "ns1080":   # the handoff plane, bit for bit
                yuv = up(ns_frames)
                n, h, w = ns_frames.shape[:3]
                y_mesh = w2x_mesh.gather(
                    pipe._noise_y(pipe.shard(yuv)))[:n, :h, :w]
                if not torch.equal(y_mesh, y_ref):
                    raise AssertionError(
                        f"phase 29 ns1080 on {shape}: the denoised plane "
                        f"differs from the single device's by up to "
                        f"{(y_mesh - y_ref).abs().max()}")
                del yuv, y_mesh
            del got
            torch.cuda.empty_cache()
    hold_seen(seen, stack, f32_twin, max_err)
    log(f"phase 29 (2, 2, 2) shards' wrapper calls held against the plain "
        f"versions: max |kernel - plain| {max_err}")
    del ns_ref, s_ref, r4_ref, r3_ref, n_ref

    # the mesh steps in turns with the single-device steps (device-resident
    # input, CUDA events: single, mesh, mesh, single), and the host's clock
    # around convert_bgr_u8 (upload, shards, gather, host interleave)
    steps = (
        ("ns1080", ns_frames, lambda y: scale2x_batch_u8_fused(
            y, fs16, y=noise_y_batch_fast(y[..., 0], fn2_32,
                                          out_dtype=None)),
         dict(fast_scale=fs16, fast_noise=fn2_32, mode="noise_scale")),
        ("scale512", s_frames, lambda y: scale2x_batch_u8_fused(y, fs16),
         dict(fast_scale=fs16)),
        ("noise256", n_frames, lambda y: noise_batch_u8_fused(y, fn1_16),
         dict(fast_noise=fn1_16, mode="noise")))
    for name, frames, single, kw in steps:
        yuv = up(frames)
        n, h, w = frames.shape[:3]
        parts = []
        for shape in MESH_SHAPES:
            npos = int(np.prod(shape))
            pipe = MeshPipeline(make_mesh3(shape, [dev] * npos), **kw)
            cur = pipe.shard(yuv)

            def one_device():
                return single(yuv)

            def on_mesh():
                return pipe._chain_u8(cur, (h, w))

            ms = [timed_ms(one_device), timed_ms(on_mesh), timed_ms(on_mesh),
                  timed_ms(one_device)]
            one, sharded = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
            torch.cuda.synchronize()
            t = time.perf_counter()
            pipe.convert_bgr_u8(frames)
            wall_mesh = time.perf_counter() - t
            t = time.perf_counter()
            d2s_host_cmajor(single(up(frames)).cpu().numpy())
            wall_one = time.perf_counter() - t
            _, dy, sp = shape
            hs, ws = -(-h // (2 * dy)) * 2, -(-w // (2 * sp)) * 2
            # the share of pixels each stage's halo adds to a shard
            redundancy = {stage: ((hs + 2 * k) * (ws + 2 * k)) / (hs * ws) - 1
                          for stage, k in (("noise", HALO_NOISE),
                                           ("scale", HALO_SCALE))
                          if stage in kw.get("mode", "scale")}
            timings.append({"cell": name, "mesh": shape, "single_ms": one,
                            "mesh_ms": sharded, "ratio": sharded / one,
                            "turns_ms": ms, "wall_single_s": wall_one,
                            "wall_mesh_s": wall_mesh,
                            "halo_redundancy": redundancy})
            parts.append(
                f"{shape}: {sharded:.2f} ms = {sharded / one:.3f}x (turns "
                f"{', '.join(f'{v:.2f}' for v in ms)}; the halo adds "
                + ", ".join(f"{100 * v:.2f}% ({k})"
                            for k, v in redundancy.items())
                + f" of a shard's pixels; host clock with the transfers "
                f"{wall_mesh:.3f} s against {wall_one:.3f} s)")
            del cur, pipe
            torch.cuda.empty_cache()
        log(f"phase 29 timing {name} on {smi}: single device {one:.2f} ms; "
            + "; ".join(parts))
        del yuv
        torch.cuda.empty_cache()
    if "ns1080" in [t["cell"] for t in timings]:
        ns = [t for t in timings if t["cell"] == "ns1080"
              and t["mesh"] == (2, 2, 2)][0]
        log(f"phase 29 prediction check, ns1080 on (2, 2, 2): "
            f"{ns['ratio']:.3f}x the single-device step (PERF.md predicted "
            f"1.04-1.12x)")

    # scaling_probe: the F.conv2d plane and the kernel chain, 8 positions
    probe = scaling_probe.run((1, 8), (512, 3840), 3, dev)
    log(f"phase 29 scaling_probe (1 x 8 on one card, 512 x 3840) on {smi}: "
        f"plane overhead {probe['plane']['overhead']:.4f} (analytic halo "
        f"{probe['plane']['analytic_halo_recompute']:.4f}; "
        f"{probe['plane']['t_single_ms']:.2f} -> "
        f"{probe['plane']['t_sharded_ms']:.2f} ms), chain overhead "
        f"{probe['chain']['overhead']:.4f} (analytic "
        f"{probe['chain']['analytic_halo_recompute']:.4f}; "
        f"{probe['chain']['t_single_ms']:.2f} -> "
        f"{probe['chain']['t_sharded_ms']:.2f} ms)")

    # the callers on the (1, 1, 1) mesh: Converter, StreamConverter, CLI
    ensure_default_models(w2x_io.default_model_dir())
    img = structured_bgr(rng, 1, 720, 1280)[0]
    cfg = Config(mesh="1x1", model_dir=w2x_io.default_model_dir())
    conv = Converter.from_config(cfg, dev)
    stack.reset_launches()
    got = conv.process_bgr_u8(img)
    torch.cuda.synchronize()
    launches = mesh_launches()
    if list(conv._pipes) != [(1, 1, 1)]:
        raise AssertionError(f"phase 29 Converter mesh='1x1': pipelines "
                             f"{list(conv._pipes)}")
    expect_mesh("Converter mesh='1x1'", launches, 1, 1)
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v
    want = Converter.from_config(dataclasses.replace(cfg, mesh="off"),
                                 dev).process_bgr_u8(img)
    worst, frac = check_u8("phase 29 Converter mesh='1x1'",
                           torch.from_numpy(got), torch.from_numpy(want), 1,
                           CLI_U8_FRAC)
    log(f"phase 29 Converter.from_config(Config(mesh='1x1')) 720x1280 "
        f"noise_scale: MeshPipeline (1, 1, 1), {int(round(frac * got.size))}"
        f" bytes differ from mesh='off' (max {worst})")
    if resolve_stream_mesh((1, 1, 1), dev) is not None:
        raise AssertionError("phase 29: resolve_stream_mesh((1, 1, 1))")
    frames4 = structured_bgr(rng, 4, 512, 512)
    kw = dict(fast=conv.fast_scale, fast_noise=conv.fast_noise,
              mode="noise_scale", device=dev, batch=2)
    stack.reset_launches()
    outs = list(StreamConverter(mesh=make_mesh3((1, 1, 1), [dev]), **kw)
                .process_frames(frames4))
    torch.cuda.synchronize()
    launches = mesh_launches()
    expect_mesh("StreamConverter on (1, 1, 1)", launches, 2, 2)
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v
    refs = list(StreamConverter(**kw).process_frames(frames4))
    n_diff = [int(round(check_u8(f"phase 29 stream frame {i}",
                                 torch.from_numpy(g), torch.from_numpy(r), 1,
                                 CLI_U8_FRAC)[1] * g.size))
              for i, (g, r) in enumerate(zip(outs, refs))]
    log(f"phase 29 StreamConverter on a (1, 1, 1) mesh, 4 x 512^2 "
        f"noise_scale in 2 dispatches: bytes that differ from the one-device "
        f"stream {n_diff}")
    d = Path(tempfile.mkdtemp())
    src = d / "in.png"
    w2x_io.imwrite_bgr(str(src), structured_bgr(rng, 1, 512, 512)[0])
    files = {}
    for spec in ("1x1", "off"):
        stack.reset_launches()
        if cli.main(["-i", str(src), "-o", str(d / f"{spec}.png"), "-m",
                     "scale", "--mesh", spec, "--device", dev.type]) != 0:
            raise AssertionError(f"phase 29 cli --mesh {spec}")
        launches = mesh_launches()
        expect_mesh(f"cli --mesh {spec}", launches, 0, 1)
        if spec == "1x1":
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
        files[spec] = w2x_io.imread_bgr(str(d / f"{spec}.png"))
    worst, frac = check_u8("phase 29 cli --mesh 1x1",
                           torch.from_numpy(files["1x1"]),
                           torch.from_numpy(files["off"]), 1, CLI_U8_FRAC)
    shutil.rmtree(d)
    log(f"phase 29 cli --mesh 1x1 512x512 scale: "
        f"{int(round(frac * files['1x1'].size))} bytes differ from --mesh "
        f"off (max {worst})")
    log(f"phase 29 passed in {time.perf_counter() - t0:.1f} s; mesh "
        f"launches by kernel {totals}")
    log(json.dumps({"mesh_timings": timings, "scaling_probe": probe}))
    return totals


# One train step against another run of it (phase 30): a param within
# STEP_TOL after the step, the loss within STEP_LOSS_TOL of the CPU's (the
# sharded steps' loss within STEP_TOL). Adam's first update is
# lr * g / (|g| + 1e-8): where a gradient is near 1e-8 a last-bit
# difference between two summation orders moves the update by up to lr
# (measured on the CPU at full width, batch 8, crop 96: 2 of 155 k weights,
# |g| 5e-9, 2.2e-5 and 4.7e-5 apart between the sharded and the one-device
# step, every other weight within 1.5e-8), so the params whose gradient is
# under SMALL_GRAD on either side are held within 2 x lr instead and
# counted.
STEP_TOL = 1e-5
STEP_LOSS_TOL = 1e-6
SMALL_GRAD = 1e-6
# tools.train_demo in phase 30: the shipped scale2.0x_demo file's own
# recipe (its provenance: --qat_mu 4 --lr 5e-5 --ema 0.999 --clip 1, batch
# 32, crop 96), cut to these steps and synthetic images, evaluated every
# DEMO_EVAL steps (300 steps: 13.3 s on an H100 80GB HBM3 at 700 W, and
# neither variant beat the shipped weights at step 300)
DEMO_STEPS = 1000
DEMO_IMAGES = 64
DEMO_EVAL = 250


def train_flops(crop: int, batch: int, spec) -> float:
    """About the operations of one train step on the valid stack: the
    forward's multiply-adds x 2, times 3 (the backward's input-gradient and
    weight-gradient products a layer; layer 1 has no input gradient, under
    0.1% of the whole)."""
    h, macs = crop, 0
    for layer in spec.layers:
        h -= layer.ksize - 1
        macs += h * h * layer.ksize * layer.ksize * layer.cin * layer.cout
    return 3 * 2 * macs * batch


def hold_step(what: str, got, ref, loss_got: float, loss_ref: float,
              loss_tol: float, lr: float) -> dict:
    """One train step's params (autograd leaves, their .grad the step's
    gradient) and loss against another run of the same step: the loss
    within loss_tol, every param within STEP_TOL but those whose gradient
    is under SMALL_GRAD on either side, which are held within 2 x lr.
    Returns the errors."""
    from waifu2x_torch.train.train import leaves
    worst = worst_small = 0.0
    n = n_small = 0
    for a, b in zip(leaves(got), leaves(ref), strict=True):
        d = (a.detach().cpu() - b.detach().cpu()).abs()
        small = torch.minimum(a.grad.detach().cpu().abs(),
                              b.grad.detach().cpu().abs()) < SMALL_GRAD
        n += d.numel()
        if (~small).any():
            worst = max(worst, d[~small].max().item())
        if small.any():
            n_small += int(small.sum())
            worst_small = max(worst_small, d[small].max().item())
    dl = abs(loss_got - loss_ref)
    log(f"{what}: loss {loss_got:.8f} against {loss_ref:.8f} (|diff| "
        f"{dl:.3e}, bar {loss_tol:g}); params max |diff| {worst:.3e} over "
        f"the {n - n_small} of {n} whose gradient is >= {SMALL_GRAD:g} (bar "
        f"{STEP_TOL:g}), {worst_small:.3e} over the other {n_small} (bar "
        f"2 x lr = {2 * lr:g})")
    if not (dl <= loss_tol and worst <= STEP_TOL
            and worst_small <= 2 * lr):
        raise AssertionError(f"{what}: loss |diff| {dl}, params {worst}, "
                             f"{worst_small} at small gradients")
    return {"loss": dl, "params": worst, "params_small_grad": worst_small,
            "small_grad_params": n_small}


def phase30(dev: torch.device, smi: str, frames: np.ndarray) -> dict:
    """30. Training at full width on the card (waifu2x_torch/train/: F.conv2d
    under autograd and torch.optim.Adam, as the JAX package's training is
    XLA's convolution under jax.grad, with no Pallas kernel): the
    7-layer model 1-32-32-64-64-128-128-1 at the reference's TrainConfig
    defaults (batch 32, crop 128, lr 2.5e-4, "highest"), on
    train.data.make_batch pairs of synthetic images. One step on the card
    against the same step on the CPU (hold_step); the MSE and QAT (mu 4)
    steps timed at "highest" and "default" with CUDA events after a
    warm-up, on batches resident on the card, with samples/s and peak
    memory; 50 steps on one batch lower the loss; the sharded step on the
    virtual meshes (2, 4) and (1, 8) of the card against the one-device
    step, MSE and QAT (hold_step); a checkpoint's 2 + 2 steps against 4
    straight (schedule and clipping on, cuDNN deterministic): within 1e-5.
    Then tools.train_demo warm-started from models/scale2.0x_demo.json with
    that file's recipe (DEMO_STEPS steps, DEMO_IMAGES images, evaluated
    every DEMO_EVAL), its held-out dB before and after, its curve and the
    layer-6 quantisation gap of the exported and the shipped weights; the exported JSON through
    Converter.from_config on a 512 x 512 image (>= 50 dB against the f32
    non-kernel path with the same weights, the hand kernels only); the
    scale512 int8 step's PSNR (frames 0-1 of `frames`, phase 15's
    measurement) for the trained and the shipped weights, measured, not
    gated. Returns the numbers."""
    from waifu2x_torch import pipeline as pipeline_mod
    from waifu2x_torch.config import Config
    from waifu2x_torch.models.srcnn import SRCNN, WAIFU2X_7LAYER, init_params
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.ops import stack
    from waifu2x_torch.ops.s2d import d2s_host_cmajor
    from waifu2x_torch.parallel import mesh as w2x_mesh
    from waifu2x_torch.pipeline import (
        Converter, FastStack, _to_bgr_u8, _to_yuv, scale2x_batch,
        scale2x_batch_u8_fused)
    from waifu2x_torch.tools import train_demo
    from waifu2x_torch.train import checkpoint, data, qat, train
    from waifu2x_torch.utils.metrics import psnr
    from waifu2x_torch.utils.timing import time_ms

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    cfg = train.TrainConfig()
    lr = cfg.learning_rate
    rng = np.random.default_rng(30)
    images = [train_demo.synth_image(rng, 192) for _ in range(8)]
    opts = data.PairOptions(crop_size=cfg.crop_size)
    batches = [data.make_batch(images, cfg.batch_size, "scale", rng, opts)
               for _ in range(4)]
    x, y = batches[0]
    p0 = init_params(30)
    opt = cfg.make_optimizer()
    qat4 = qat.make_qat_l6_loss(4.0)
    res = {"errors": {}}

    def fresh(device):
        p = train.trainable(p0, device)
        return p, opt.init(p)

    # 1. one "highest" step on the card and on the CPU, from equal params
    # on equal data
    p_cpu, st = fresh("cpu")
    tc = time.perf_counter()
    p_cpu, _, l_cpu = train.make_train_step(opt)(p_cpu, st, x, y)
    cpu_s = time.perf_counter() - tc
    p_card, st = fresh(dev)
    p_card, _, l_card = train.make_train_step(opt)(p_card, st, x, y)
    log(f"phase 30 model {[l.cout for l in WAIFU2X_7LAYER.layers]}, batch "
        f"{cfg.batch_size} x {cfg.crop_size}^2 scale pairs, lr {lr}; the "
        f"CPU step took {cpu_s:.2f} s on the host")
    res["errors"]["card_vs_cpu"] = hold_step(
        "phase 30 one step, card against the CPU", p_card, p_cpu,
        float(l_card), float(l_cpu), STEP_LOSS_TOL, lr)
    del p_cpu, p_card

    # 2. step times, batches resident on the card
    xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    flops = train_flops(cfg.crop_size, cfg.batch_size, WAIFU2X_7LAYER)
    peaks = {"highest": PEAK_F32_FLOPS, "default": PEAK_TF32_FLOPS}
    res["steps"] = {}
    for lname, loss in (("mse", None), ("qat", qat4)):
        for prec in ("highest", "default"):
            p, st = fresh(dev)
            step = train.make_train_step(opt, prec, loss)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda _: step(p, st, xd, yd), dev, 5)
            peak = torch.cuda.max_memory_allocated() / 1e9
            row = {"ms": ms, "samples_per_s": cfg.batch_size / ms * 1e3,
                   "peak_gb": peak}
            note = ""
            if lname == "mse":
                row["tflops"] = flops / ms / 1e9
                row["bound_ms"] = flops / peaks[prec] * 1e3
                note = (f", {row['tflops']:.1f} TFLOP/s (about "
                        f"{flops / 1e12:.2f} TFLOP a step; bound "
                        f"{row['bound_ms']:.2f} ms at the "
                        f"{'f32 FFMA' if prec == 'highest' else 'TF32'} peak)")
            res["steps"][f"{lname} {prec}"] = row
            log(f"phase 30 {lname} step, precision {prec!r}, on {smi}: "
                f"{ms:.2f} ms = {row['samples_per_s']:.1f} samples/s, peak "
                f"memory {peak:.2f} GB{note}")
            del p, st, step

    # 3. 50 steps on one fixed batch lower the loss
    p, st = fresh(dev)
    step = train.make_train_step(opt)
    losses = []
    for _ in range(50):
        p, st, value = step(p, st, xd, yd)
        losses.append(value)
    losses = torch.stack(losses).tolist()
    log(f"phase 30 50 steps on one batch: loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"phase 30: the loss did not fall: {losses}")
    res["loss_first_last"] = (losses[0], losses[-1])
    del p, st

    # 4. the sharded step on virtual meshes of the card
    for shape in ((2, 4), (1, 8)):
        mesh = w2x_mesh.make_mesh(shape, ("dp", "sp"), [dev] * 8)
        for lname, loss in (("mse", None), ("qat", qat4)):
            p1, st = fresh(dev)
            p1, _, l1 = train.make_train_step(opt, "highest", loss)(
                p1, st, xd, yd)
            ps, st = fresh(dev)
            ps, _, ls = train.make_sharded_train_step(
                mesh, opt, "highest", loss)(ps, st, xd, yd)
            res["errors"][f"sharded {shape} {lname}"] = hold_step(
                f"phase 30 sharded step {shape} {lname}, against one "
                f"device", ps, p1, float(ls), float(l1), STEP_TOL, lr)
            del p1, ps, st

    # 5. checkpoints: 2 + 2 steps against 4 straight, with a schedule and
    # clipping (44 leaves), cuDNN deterministic for both
    ccfg = train.TrainConfig(decay_steps=8, warmup_steps=1, clip_norm=1.0)
    copt = ccfg.make_optimizer()
    dev_batches = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
                   for a, b in batches]
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)

    def run(p, st, bs):
        step = train.make_train_step(copt)
        for xb, yb in bs:
            p, st, _ = step(p, st, xb, yb)
        return p, st

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        p = train.trainable(p0, dev)
        straight, _ = run(p, copt.init(p), dev_batches)
        p = train.trainable(p0, dev)
        p, st = run(p, copt.init(p), dev_batches[:2])
        path = str(d / "train.npz")
        checkpoint.save_checkpoint(path, p, st, 2)
        q = train.trainable(init_params(31), dev)
        q, qst, at = checkpoint.load_checkpoint(path, q, copt.init(q))
        q, _ = run(q, qst, dev_batches[2:])
    with np.load(path) as f:
        n_leaves = sum(k.startswith("leaf_") for k in f.files)
    err = max((a - b).abs().max().item() for a, b in zip(
        train.leaves(q), train.leaves(straight)))
    log(f"phase 30 checkpoint: {n_leaves} leaves, "
        f"{Path(path).stat().st_size / 1e6:.2f} MB, resumed at step {at}; "
        f"2 + 2 steps against 4 straight: max |diff| {err:.3e} (bar "
        f"{STEP_TOL:g})")
    if not (at == 2 and n_leaves == 44 and err <= STEP_TOL):
        raise AssertionError(f"phase 30 checkpoint: step {at}, {n_leaves} "
                             f"leaves, {err}")
    res["errors"]["resume"] = err
    del p, q, straight, dev_batches, xd, yd
    torch.cuda.empty_cache()

    # 6. the demo tool, warm-started from the shipped weights with their
    # own recipe; its JSON into a model dir of its own
    mdir = d / "models"
    mdir.mkdir()
    out_json = mdir / "scale2.0x_model.json"
    shipped_json = root / "models" / "scale2.0x_demo.json"
    td = time.perf_counter()
    if train_demo.main([
            "--init", str(shipped_json), "--qat_mu", "4", "--lr", "5e-5",
            "--ema", "0.999", "--clip", "1", "--batch", "32", "--crop", "96",
            "--steps", str(DEMO_STEPS), "--images", str(DEMO_IMAGES),
            "--eval_every", str(DEMO_EVAL), "--out", str(out_json),
            "--device", str(dev)]) != 0:
        raise AssertionError("phase 30: tools.train_demo failed")
    demo_s = time.perf_counter() - td
    prov = json.loads(Path(str(out_json) + ".provenance.json").read_text())
    trained = load_model_json(out_json)
    shipped = load_model_json(shipped_json)
    xs, _ = train_demo.build_eval_set("scale", 1)
    xg = torch.from_numpy(xs[:64]).to(dev)

    def on_dev(prm):
        return tuple({k: v.to(dev) for k, v in q.items()} for q in prm)

    gap = {name: qat.l6_quant_gap_db(on_dev(prm), xg)
           for name, prm in (("trained", trained), ("shipped", shipped))}
    curve = ", ".join(f"{pt['variant']}@{pt['step']} {pt['db']} dB "
                      f"(gap {pt['l6_quant_gap_db']})" for pt in prov["curve"])
    log(f"phase 30 tools.train_demo ({DEMO_STEPS} steps, {DEMO_IMAGES} "
        f"images, {demo_s:.1f} s): held-out "
        f"{prov['heldout_y_psnr_untrained_db']} dB before (the shipped "
        f"weights) -> {prov['heldout_y_psnr_db']} dB exported "
        f"({prov['shipped_variant']}: the best evaluated point, the init "
        f"where none beat it; input baseline "
        f"{prov['heldout_input_baseline_db']} dB); the curve: {curve}; "
        f"l6_quant_gap_db exported {gap['trained']:.2f} dB, shipped "
        f"{gap['shipped']:.2f} dB")

    img = structured_bgr(rng, 1, 512, 512)[0]
    stack.reset_launches()
    got = Converter.from_config(Config(mode="scale", model_dir=str(mdir)),
                                dev).process_bgr_u8(img)
    launches = mesh_launches()
    expect_hand_kernels("phase 30 Converter on the trained weights",
                        launches, f32=False)
    ref = Converter.from_config(Config(
        mode="scale", model_dir=str(mdir), use_pallas=False,
        compute_dtype="float32"), dev).process_bgr_u8(img)
    conv_db = psnr(got, ref)
    log(f"phase 30 Converter.from_config(mode='scale') on the exported "
        f"weights, 512 x 512: {conv_db:.2f} dB against the f32 non-kernel "
        f"path with the same weights; launches {launches}")
    if not conv_db >= PSNR_BAR:
        raise AssertionError(f"phase 30 Converter: {conv_db} dB")

    yuv = _to_yuv(torch.from_numpy(frames).to(dev))
    tail = (pipeline_mod.FUSED_TAIL, pipeline_mod.YDENSE)
    pipeline_mod.FUSED_TAIL, pipeline_mod.YDENSE = "xla", False

    def i8_db(prm) -> float:
        fast = FastStack.build(prm, True, torch.bfloat16, dev)
        stack.L6_I8 = True
        try:
            u8 = scale2x_batch_u8_fused(yuv, fast)
        finally:
            stack.L6_I8 = False
        outp = d2s_host_cmajor(u8.cpu().numpy())
        want = _to_bgr_u8(scale2x_batch(
            yuv[:2], SRCNN.from_params(prm).to(dev),
            Config(mode="scale", compute_dtype="float32"))).cpu().numpy()
        return psnr(outp[:2], want)

    i8 = {name: i8_db(prm) for name, prm in (("trained", trained),
                                              ("shipped", shipped))}
    pipeline_mod.FUSED_TAIL, pipeline_mod.YDENSE = tail
    log(f"phase 30 scale512 int8 step (l6_i8, frames 0-1 against the f32 "
        f"non-kernel path) on {smi}: exported weights {i8['trained']:.2f} "
        f"dB, shipped {i8['shipped']:.2f} dB (measured, not gated)")
    tmp.cleanup()
    res.update({"demo": {"steps": DEMO_STEPS, "images": DEMO_IMAGES,
                         "seconds": demo_s, "curve": prov["curve"],
                         "heldout_before_db": prov[
                             "heldout_y_psnr_untrained_db"],
                         "heldout_after_db": prov["heldout_y_psnr_db"],
                         "shipped_variant": prov["shipped_variant"]},
                "l6_quant_gap_db": gap, "converter_db": conv_db,
                "i8_step_db": i8, "launches": launches,
                "seconds": time.perf_counter() - t0})
    log(f"phase 30 passed in {res['seconds']:.1f} s")
    return res


def phase31(dev: torch.device, smi: str) -> dict:
    """31. The three fidelity tools on the card, the stack's launch counts
    set to 0 before each and read after it (the hand kernels only):
    tools.chain_fidelity_probe at 512^2 (the four noise -> scale chains'
    PSNR; f32/f32 held to >= 50 dB), tools.edge_error_probe at 512 and
    tools.ns1080_probe at --iters 2. Returns the launches summed by kernel
    and the tools' numbers."""
    from waifu2x_torch.ops import stack
    from waifu2x_torch.tools import (
        chain_fidelity_probe, edge_error_probe, ns1080_probe)

    t0 = time.perf_counter()
    totals, out = {}, {}
    for tool, argv, f32 in ((chain_fidelity_probe, ["--size", "512"], True),
                            (edge_error_probe, ["--size", "512"], False),
                            (ns1080_probe, ["--iters", "2"], False)):
        name = tool.__name__.rsplit(".", 1)[1]
        log(f"phase 31 tools.{name} {' '.join(argv)} on {smi}:")
        tt = time.perf_counter()
        stack.reset_launches()
        results = []
        if tool.main(argv, results) != 0:
            raise AssertionError(f"phase 31 {name} failed")
        launches = mesh_launches()
        expect_hand_kernels(f"phase 31 {name}", launches, f32)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        out[name] = results
        log(f"phase 31 {name}: {time.perf_counter() - tt:.1f} s, launches "
            f"{launches}")
    dbs = out["chain_fidelity_probe"][0]
    if not dbs["f32/f32"] >= PSNR_BAR:
        raise AssertionError(f"phase 31 chain f32/f32: {dbs['f32/f32']} dB")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 31 passed in {out['seconds']:.1f} s")
    return {"launches": totals, "results": out}


def gather_plain(stack, src: torch.Tensor, sp, upto: int, out: str,
                 hl: int, wl: int) -> torch.Tensor:
    """The gather's plain version on the input the kernel read: the low-res
    plane's taps / lane 0 / padded window (stack_scale_upto_plain at upto
    0), or the 4 lanes of the activation's even pixels (upto 1..5)."""
    if upto == 0:
        return stack.stack_scale_upto_plain(src, sp, 0, out=out)
    return src[:, 0:2 * hl:2, 0:2 * wl:2, 0:4].contiguous()


def gather_alone(stack, src: torch.Tensor, out: torch.Tensor, upto: int,
                 mode: int, hl: int, wl: int) -> torch.Tensor:
    """The gather's launch alone, as stack_scale_upto makes it."""
    hk, wk = 2 * hl + 14 - 2 * upto, 2 * wl + 14 - 2 * upto
    ck = stack.WIDTHS[upto - 1][1] if upto else 1
    stack._Launcher(None, src, None).gather(src, out, src.shape[0], hl, wl,
                                            hk, wk, ck, mode)
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, dtype and storage bits."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def phase32(dev: torch.device, smi: str, sps, ylow16: torch.Tensor,
            i8_step, launches: dict) -> list:
    """32. B7's gather and B4's tile maxima in layer 5's epilogue. The
    gather (csrc/gather.cu:upto_gather_tiled) in all four modes and both
    types, through stack_scale_upto, at (1, 27, 38), (2, 37, 53),
    (1, 5, 300), (1, 3, 2) and scale512, bit for bit against its plain
    version on the input it read; then at scale512 each mode's launch
    alone, twice, beside its bound (bytes: the low-res modes read the plane
    and write y; GATHER_ACT writes y and reads a 32-byte sector a cell) and
    the one-call library form (GATHER_ACT a strided slice's contiguous(),
    GATHER_PAD F.pad replicate; both checked equal). The maxima
    (layer5_maxima: csrc/mma.cu in bf16, mma_tf32.cu in f32) at the default
    tile and at tiles (1, 1), (2, 3), (3, 5), a NaN among the inputs: x5
    bit for bit the default layer 5's, m bit for bit tile_max_plain's; at
    scale512 layer 5 with and without the maxima in turns; the B4 stack
    timed twice and the int8 step; a (2, 1, 1) mesh under l6_i8 against one
    position bit for bit, each position its own maxima.
    sps = (f32, bf16) shipped scale weights, ylow16 the scale512 plane,
    i8_step() the scale512 int8 batch step -> (u8 frames, dB against the
    f32 path), `launches` the two kernels' counts on the main path (phase
    15). Returns the kernel table's two rows."""
    from waifu2x_torch.models.srcnn import init_params
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.ops import stack
    from waifu2x_torch.parallel.mesh_pipeline import MeshPipeline, make_mesh3
    from waifu2x_torch.pipeline import FastStack

    t0 = time.perf_counter()
    sp_r = {dt: stack.prep_params(init_params(3), dt, dev)
            for dt in (torch.float32, torch.bfloat16)}
    sp_main = dict(zip((torch.float32, torch.bfloat16), sps))
    gen = torch.Generator(device=dev).manual_seed(32)

    # the gather: every form, both types, bit for bit
    forms = [(k, "cell") for k in range(6)] + [(0, "lane0"), (0, "whole")]
    for shape in ((1, 27, 38), (2, 37, 53), (1, 5, 300), (1, 3, 2),
                  (16, 512, 512)):
        main_shape = shape == (16, 512, 512)
        for dt in (torch.float32, torch.bfloat16):
            y = torch.rand(shape, device=dev, generator=gen).to(dt)
            sp = (sp_main if main_shape else sp_r)[dt]
            for k, out in forms:
                src = y if k == 0 else stack.stack_scale_upto(y, sp, k,
                                                              out="whole")
                stack.reset_launches()
                got = stack.stack_scale_upto(y, sp, k, out=out)
                torch.cuda.synchronize()
                if (stack.GATHER_LAUNCHES != {"tiled": 1}
                        or stack.L6_LAUNCHES["upto"] != 1):
                    raise AssertionError(f"gather upto {k} out={out}: "
                                         f"{stack.GATHER_LAUNCHES}")
                ref = gather_plain(stack, src, sp, k, out, *shape[1:])
                if not same_bits(got, ref):
                    raise AssertionError(
                        f"gather upto {k} out={out} {shape} {dt}: differs "
                        f"from its plain version")
                del src, got, ref
            del y
            torch.cuda.empty_cache()
        log(f"phase 32 gather {shape}: upto 0..5 in every form, f32 and "
            f"bf16, == plain bit for bit")

    # each mode's launch alone at scale512, twice, beside its bound and its
    # one-call library form
    n, hl, wl = ylow16.shape
    gather_rows = {}
    for dt in (torch.float32, torch.bfloat16):
        isz = 4 if dt == torch.float32 else 2
        y = ylow16.to(dt)
        sp = sp_main[dt]
        # (csrc/gather.cu's mode, upto, stack_scale_upto's output form)
        timed = [("GATHER_ACT", 5, "cell"), ("GATHER_ACT", 1, "cell"),
                 ("GATHER_TAPS", 0, "cell"), ("GATHER_LANE0", 0, "lane0"),
                 ("GATHER_PAD", 0, "whole")]
        for name, k, out_form in timed:
            mode = stack._GATHER_LOWRES[out_form] if k == 0 else 0
            src = y if k == 0 else stack.stack_scale_upto(y, sp, k,
                                                          out="whole")
            pad = 8 if name == "GATHER_PAD" else 0
            lanes = 1 if name == "GATHER_PAD" else 4
            out = torch.empty((n, hl + pad, wl + pad, lanes), dtype=dt,
                              device=dev)
            turns = [timed_ms(lambda: gather_alone(stack, src, out, k, mode,
                                                   hl, wl))
                     for _ in range(2)]
            got = gather_alone(stack, src, out, k, mode, hl, wl).clone()
            plain_ms = timed_ms(lambda: gather_plain(stack, src, sp, k,
                                                     out_form, hl, wl),
                                reps=1)
            out_bytes = out.numel() * isz
            if k:   # a 32-byte sector a cell, and y written
                read_bytes = n * hl * wl * 32
                library = (lambda: src[:, 0:2 * hl:2, 0:2 * wl:2,
                                       0:4].contiguous())
            else:
                read_bytes = y.numel() * isz
                library = ((lambda: F.pad(y[:, None], (4, 4, 4, 4),
                                          mode="replicate"))
                           if name == "GATHER_PAD" else None)
            lib_ms = None
            if library is not None:
                lib_out = library()
                if not same_bits(lib_out.reshape(got.shape), got):
                    raise AssertionError(f"{name} upto {k} {dt}: the library "
                                         f"form differs from the gather")
                del lib_out
                lib_ms = timed_ms(library)
            ms = sum(turns) / 2
            bound = (read_bytes + out_bytes) / PEAK_BYTES * 1e3
            useful = (2 * out_bytes if k else read_bytes + out_bytes)
            key = f"{name} upto {k}" if name == "GATHER_ACT" else name
            gather_rows[key, dt] = {
                "ms": ms, "turns_ms": turns,
                "bound_ms": bound, "share_of_bound": bound / ms,
                "kept_bytes_bound_ms": useful / PEAK_BYTES * 1e3,
                "plain_ms": plain_ms, "library_ms": lib_ms}
            log(f"phase 32 {key} {dt} at scale512 on {smi}: "
                f"{ms:.4f} ms (runs "
                + " / ".join(f"{v:.4f}" for v in turns)
                + f"), bound {bound:.4f} ms by bytes ("
                f"{(read_bytes + out_bytes) / 1e6:.1f} MB: "
                + ("a 32-byte sector a cell read, y written; the bytes kept "
                   if k else "the plane read once, y written; ")
                + (f"{useful / PEAK_BYTES * 1e3:.4f} ms" if k else "")
                + f") = {100 * bound / ms:.1f}% of it; library "
                + (f"{lib_ms:.4f} ms" if lib_ms is not None else
                   "none (no one PyTorch call builds the taps / lane 0)")
                + f"; plain {plain_ms:.3f} ms")
            del src, out, got
            torch.cuda.empty_cache()

    # B4's tile maxima in layer 5's epilogue
    def maxima_check(x4, sp, tile, label) -> float:
        stack.reset_launches()
        x5, m = stack.layer5_maxima(x4, sp, tile)
        torch.cuda.synchronize()
        mid = "mma" if x4.dtype == torch.bfloat16 else "mma_tf32"
        if (stack.I8_LAUNCHES != {"mma": 0, "l5max": 1}
                or stack.MID_LAUNCHES[mid] != 1 or stack.LAUNCHES):
            raise AssertionError(f"layer5_maxima {label}: "
                                 f"{stack.I8_LAUNCHES}, {stack.MID_LAUNCHES}")
        x5_ref = stack.mma_layer(x4, sp, 5)
        m_plain = stack.tile_max_plain(x5, tile)
        ok = (same_bits(x5, x5_ref), same_bits(m, m_plain))
        if not all(ok):
            raise AssertionError(f"layer5_maxima {label}: x5 == default "
                                 f"instance {ok[0]}, m == plain {ok[1]}")
        c = 1   # the layer against its plain version, frame 0 (no NaN)
        ref = stack.mma_layer_plain(x4[:c], sp.wm[3], sp[4][1])
        err = (check_mma_layer(f"layer 5 {label}", x5[:c], ref)[0]
               if x4.dtype == torch.bfloat16
               else check_f32(f"layer 5 {label}", x5[:c], ref))
        log(f"phase 32 layer5_maxima {label}: x5 == the default layer 5 "
            f"bit for bit, max|x5 - plain| {err:.3e}; m {tuple(m.shape)} == "
            f"tile_max_plain bit for bit (largest "
            f"{m.max().item():.4f})")
        return err

    l5_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for cells, tile in (((27, 38), None), ((37, 53), (1, 1)),
                            ((37, 53), (2, 3)), ((37, 53), (3, 5))):
            tile = tile or stack.default_tile(*cells)
            ny, nx = -(-cells[0] // tile[0]), -(-cells[1] // tile[1])
            x4 = torch.rand((2, 2 * ny * tile[0] + 6, 2 * nx * tile[1] + 6,
                             64), device=dev, generator=gen).to(dt)
            if tile == (1, 1):
                x4[1, 9, 11, 5] = float("nan")   # fmaxf drops it, both ways
            l5_err = max(l5_err, maxima_check(
                x4, sp_r[dt], tile, f"{cells} tile {tile} {dt}"))
    tile = stack.default_tile(hl, wl)
    tr, tc = tile
    ny, nx = -(-hl // tr), -(-wl // tc)
    maxima_rows = {}
    for dt in (torch.float32, torch.bfloat16):
        sp, isz = sp_main[dt], 4 if dt == torch.float32 else 2
        x4 = torch.rand((n, 2 * ny * tr + 6, 2 * nx * tc + 6, 64),
                        device=dev, generator=gen).to(dt)
        l5_err = max(l5_err, maxima_check(x4, sp, tile,
                                          f"scale512 tile {tile} {dt}"))
        x5 = stack.mma_layer(x4, sp, 5)
        runs = {"l5": lambda: stack.mma_layer(x4, sp, 5),
                "l5max": lambda: stack.layer5_maxima(x4, sp, tile)}
        turns = {k: [] for k in runs}
        for key in ("l5", "l5max", "l5max", "l5"):
            turns[key].append(timed_ms(runs[key]))
        ms = {k: sum(v) / 2 for k, v in turns.items()}
        t1 = time.perf_counter()
        for i in range(0, n, 2):
            stack.layer5_maxima_plain(x4[i:i + 2], sp, tile)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        out_px = n * (x4.shape[1] - 2) * (x4.shape[2] - 2)
        l5_ops = 2 * out_px * 9 * 64 * 128 / (
            PEAK_BF16_FLOPS if dt == torch.bfloat16
            else PEAK_TF32_FLOPS / 3) * 1e3
        l5_bytes = (x4.numel() + x5.numel()) * isz / PEAK_BYTES * 1e3
        m_bytes = n * ny * nx * 4
        maxima_rows[dt] = {
            "ms": ms["l5max"], "layer5_ms": ms["l5"],
            "epilogue_extra_ms": ms["l5max"] - ms["l5"],
            "maxima_extra_bytes": m_bytes,
            "turns_ms": {k: v for k, v in turns.items()},
            "plain_ms": plain_ms, "bound_ms": max(l5_ops, l5_bytes),
            "bound_by": "operations" if l5_ops >= l5_bytes else "bytes"}
        log(f"phase 32 scale512 layer 5 {tuple(x4.shape)} -> "
            f"{tuple(x5.shape)} {dt}, tile {tile}, on {smi}: with the maxima "
            f"in its epilogue {ms['l5max']:.3f} ms, without "
            f"{ms['l5']:.3f} ms (epilogue +{ms['l5max'] - ms['l5']:.3f} ms, "
            f"{m_bytes} bytes more written); turns "
            + ", ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in t)
                        for k, t in turns.items())
            + f"; layer 5's bound {max(l5_ops, l5_bytes):.3f} ms "
            f"(operations {l5_ops:.3f}, bytes {l5_bytes:.3f}); plain "
            f"(layer5_maxima_plain, 2 frames at a time, host clock) "
            f"{plain_ms:.1f} ms")
        del x4, x5
        torch.cuda.empty_cache()

    # the B4 stack, twice, and the int8 step
    def b4():
        return stack.stack_scale(ylow16, sps[1], l6_i8=True)

    stack_turns = [timed_ms(b4) for _ in range(2)]
    stack.reset_launches()
    b4()
    torch.cuda.synchronize()
    if stack.I8_LAUNCHES != {"mma": 1, "l5max": 1} or stack.LAUNCHES != 7:
        raise AssertionError(f"B4 stack: {stack.I8_LAUNCHES}, "
                             f"{stack.LAUNCHES}")
    _, step_db = i8_step()
    stack_ms = sum(stack_turns) / 2
    log(f"phase 32 scale512 B4 stack (bf16, l6_i8) on {smi}: maxima in layer "
        f"5's epilogue {stack_ms:.3f} ms (runs "
        + " / ".join(f"{v:.3f}" for v in stack_turns)
        + f"), 7 launches; the int8 step {step_db:.2f} dB against the f32 "
        f"path")

    # the mesh: each position its own maxima
    root = Path(__file__).resolve().parent
    fs16 = FastStack.build(load_model_json(
        root / "models" / "scale2.0x_demo.json"), True, torch.bfloat16, dev)
    frames = structured_bgr(np.random.default_rng(32), 4, 512, 512)
    mesh_out = {}
    stack.L6_I8 = True
    try:
        for shape in ((1, 1, 1), (2, 1, 1)):
            stack.reset_launches()
            mesh_out[shape] = MeshPipeline(
                make_mesh3(shape, [dev] * int(np.prod(shape))),
                fast_scale=fs16).convert_bgr_u8(frames)
            torch.cuda.synchronize()
            npos = int(np.prod(shape))
            if stack.I8_LAUNCHES != {"mma": npos, "l5max": npos}:
                raise AssertionError(f"mesh {shape} under l6_i8: "
                                     f"{stack.I8_LAUNCHES}")
    finally:
        stack.L6_I8 = False
    if not np.array_equal(np.asarray(mesh_out[(1, 1, 1)]),
                          np.asarray(mesh_out[(2, 1, 1)])):
        raise AssertionError("mesh (2, 1, 1) under l6_i8 differs from one "
                             "position")
    log("phase 32 MeshPipeline under l6_i8, 4 x 512^2: (2, 1, 1) equal to "
        "(1, 1, 1) byte for byte, one layer-5 maxima launch a position")

    rows = [{
        "name": "upto_gather_tiled, B7's gather at upto 0..5 (a band of "
                "rows a block, a warp a row, 16-byte vectors; the low-res "
                "band staged in shared memory; persistent), GATHER_ACT at "
                "upto 5 in the row's numbers",
        "route": "cuda", "source": "waifu2x_torch/csrc/gather.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:380",
        "launches": launches["gather"],
        "launches_of": "stack.GATHER_LAUNCHES['tiled'] read around "
                       "layer_time_probe (phase 15)",
        "max_abs_err": 0.0,
        **{k: gather_rows["GATHER_ACT upto 5", torch.bfloat16][k]
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes",
        "bound_is": "GATHER_ACT: a 32-byte sector read an output cell and "
                    "y written; the low-res modes: the plane read once and "
                    "y written",
        "modes": {f"{key} {'bf16' if dt == torch.bfloat16 else 'f32'}": r
                  for (key, dt), r in gather_rows.items()},
        "library_is": "GATHER_ACT act[:, ::2, ::2, :4].contiguous(), "
                      "GATHER_PAD F.pad replicate; none for GATHER_TAPS and "
                      "GATHER_LANE0 (no one call builds the taps)"}, {
        "name": "layer 5 with B4's tile maxima in its epilogue "
                "(conv3x3_bias_leaky_mma / _tf32, the AM instance; "
                "common.cuh:tile_max_block), bf16 in the row's numbers",
        "route": "cuda", "source": "waifu2x_torch/csrc/mma.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:563",
        "launches": launches["l5max"],
        "launches_of": "stack.I8_LAUNCHES['l5max'] in phase 15's scale512 "
                       "stream under W2X_L6_I8",
        "max_abs_err": l5_err,
        **{k: maxima_rows[torch.bfloat16][k] for k in (
            "ms", "layer5_ms", "epilogue_extra_ms", "maxima_extra_bytes",
            "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "library_is": "none: no one PyTorch call gives layer 5 and the "
                      "per-window max |x5|",
        "f32": maxima_rows[torch.float32],
        "b4_stack_ms": stack_ms,
        "i8_step_db": step_db}]
    log(f"phase 32 passed in {time.perf_counter() - t0:.1f} s")
    return rows


def mma_route_shapes(stack) -> list:
    """(label, layer k, input shape) of layers 2-6 as the benchmark's cells
    run them: scale512 (16 x 512^2 low-res), the chain's scale step (4 x
    1080 x 1920), the sweep's bands at 1440p and 4K (2 frames a band, band
    rows as pipeline._bands cuts them), and the CPU tests' ragged shapes;
    (3, 18, 18) and (1, 5, 300) give an odd tile count, and fewer tiles
    than the card holds blocks."""
    from waifu2x_torch import pipeline as pipeline_mod
    shapes = []
    for label, n, hl, wl in (("scale512", 16, 512, 512),
                             ("chain 2160x3840", 4, 1080, 1920),
                             ("sweep 1440p band", 2, 1440, 2560),
                             ("sweep 4K band", 2, 2160, 3840)):
        rows = pipeline_mod._band_rows(pipeline_mod.BAND_ROWS, n, wl)
        if hl > rows:
            hl = next(pipeline_mod._bands(hl, rows))[1]
        for k in range(2, 7):
            side = (2 * hl + 16 - 2 * k, 2 * wl + 16 - 2 * k)
            shapes.append((f"{label} ({n} x {hl} x {wl} low-res)", k,
                           (n, *side, stack.WIDTHS[k - 1][0])))
    for shape in ((1, 27, 38), (1, 5, 300), (1, 19, 35), (3, 18, 18)):
        for k in range(2, 7):
            shapes.append(("ragged", k, (*shape, stack.WIDTHS[k - 1][0])))
    return shapes


def phase33(dev: torch.device, smi: str) -> list:
    """33. Layers 2-6 on the persistent kernel (csrc/mma.cu:
    conv3x3_bias_leaky_mma: layers 2-5 with their weights resident, layer 6
    with its outputs split in two halves, a block keeping one half's
    weights resident) against the tile kernel (persistent=False, the first
    design and the timing yardstick),
    bit for bit, at every shape of mma_route_shapes, each launch's route
    checked in MID_LAUNCHES; the plans' bytes staged from L2 a tile; each
    layer timed in turns against the tile kernel at scale512 and the
    chain's 2160x3840 shapes; the routes one stack call takes. Returns the
    timing rows."""
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch.ops import stack

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    sp = stack.prep_params(load_model_json(root / "models"
                                           / "scale2.0x_demo.json"),
                           torch.bfloat16, dev)
    gen = torch.Generator(device=dev).manual_seed(33)
    for k in range(2, 7):
        ci, co = stack.WIDTHS[k - 1]
        new, old = stack.mma_plan(ci, co), stack.mma_plan(ci, co,
                                                          persistent=False)
        log(f"phase 33 layer {k} ({ci} -> {co}): persistent route "
            f"{new.route}, {new.groups} consumer group(s), {new.stages} slots, "
            f"{new.smem_bytes} B shared, {new.resident_bytes} B of weights "
            f"resident; staged from L2 a tile {new.l2_tile_bytes} B against "
            f"the tile kernel's {old.l2_tile_bytes} B")

    def both(x, k):
        before = dict(stack.MID_LAUNCHES)
        new = stack.mma_layer(x, sp, k)
        old = stack.mma_layer(x, sp, k, persistent=False)
        torch.cuda.synchronize()
        delta = {r: stack.MID_LAUNCHES[r] - before[r]
                 for r in stack.MID_LAUNCHES}
        route = "mma_split" if k == 6 else "mma_resident"
        want = {r: 0 for r in delta}
        want.update({"mma": 2, route: 1, "mma_tile": 1})
        if delta != want:
            raise AssertionError(f"layer {k}: launches {delta}, want {want}")
        return new, old

    checks = 0
    for label, k, shape in mma_route_shapes(stack):
        x = (torch.rand(shape, device=dev, generator=gen,
                        dtype=torch.bfloat16) - 0.25)
        new, old = both(x, k)
        if not same_bits(new, old):
            diff = (new.float() - old.float()).abs()
            raise AssertionError(
                f"layer {k} {label} {shape}: {int((diff > 0).sum())} of "
                f"{diff.numel()} outputs differ, max {diff.max().item()}")
        checks += 1
        del x, new, old
        torch.cuda.empty_cache()
    log(f"phase 33 persistent == tile kernel bit for bit: {checks} layer "
        f"calls (5 layers x {checks // 5} shapes)")

    rows = []
    for label, n, hl, wl in (("scale512", 16, 512, 512),
                             ("chain 2160x3840", 4, 1080, 1920)):
        ms = {True: [], False: []}
        for k in range(2, 7):
            ci, co = stack.WIDTHS[k - 1]
            x = torch.rand((n, 2 * hl + 16 - 2 * k, 2 * wl + 16 - 2 * k, ci),
                           device=dev, generator=gen, dtype=torch.bfloat16)
            got = {True: [], False: []}
            for persistent in (False, True, True, False):
                got[persistent].append(timed_ms(
                    lambda: stack.mma_layer(x, sp, k,
                                            persistent=persistent), 5))
            for p in (True, False):
                ms[p].append(sum(got[p]) / 2)
            log(f"phase 33 {label} layer {k} ({ci} -> {co}) {tuple(x.shape)} "
                f"on {smi}: persistent {got[True][0]:.4f} / "
                f"{got[True][1]:.4f} ms, tile kernel {got[False][0]:.4f} / "
                f"{got[False][1]:.4f} ms (in turns)")
            del x
            torch.cuda.empty_cache()
        rows.append({"shape": label, "n": n, "hl": hl, "wl": wl,
                     "persistent_ms": ms[True], "tile_ms": ms[False],
                     "persistent_sum_ms": sum(ms[True]),
                     "tile_sum_ms": sum(ms[False])})
        log(f"phase 33 {label} layers 2-6: persistent "
            f"{sum(ms[True]):.3f} ms, tile kernel {sum(ms[False]):.3f} ms")

    ylow = torch.rand((16, 512, 512), device=dev, generator=gen,
                      dtype=torch.bfloat16)
    stack.reset_launches()
    stack.stack_scale(ylow, sp)
    torch.cuda.synchronize()
    routes = {r: stack.MID_LAUNCHES[r] for r in ("mma", *stack.MID_ROUTES)}
    if (stack.LAUNCHES != 7 or routes != {
            "mma": 5, "mma_resident": 4, "mma_split": 1, "mma_tile": 0}):
        raise AssertionError(f"stack_scale: {stack.LAUNCHES} launches, "
                             f"routes {routes}")
    log(f"phase 33 one scale512 stack call: {stack.LAUNCHES} launches, "
        f"layers 2-6 by route {routes}; {time.perf_counter() - t0:.1f} s")
    stack.reset_launches()
    return rows


def phase34(dev: torch.device, smi: str) -> dict:
    """34. UpCUNet's 3x3 layers on csrc/mma.cu through ops/stack.py:
    conv3x3_mma, at the planes of a 436-px tile (models/cunet.py:
    layer_sides), two tiles a call: each against mma_layer_plain within one
    bf16 ulp at the output's magnitude (check_mma_layer), and one launch on
    mma_plan's route, counted by (ci, co, route) in stack.MMA_SHAPES; then
    one pipeline.upcunet2x_batch_u8 dispatch of a 1080p frame on seeded
    weights, its MMA_SHAPES each such layer once a chunk of tiles. Returns
    the dispatch's launches by shape and route."""
    from waifu2x_torch import pipeline
    from waifu2x_torch.models import cunet
    from waifu2x_torch.ops import stack, unet
    from waifu2x_torch.ops.s2d import pack_mma

    t0 = time.perf_counter()
    tile = 436
    sides = cunet.layer_sides(tile)
    layers = [k for k in cunet.LAYERS
              if k.kind == "conv3" and stack.has_mma(k.cin, k.cout)]
    gen = torch.Generator(device=dev).manual_seed(34)
    for k in layers:
        ci, co = k.cin, k.cout
        side = sides[k.key][0]
        x = torch.randn((2, side, side, ci), device=dev,
                        generator=gen).to(torch.bfloat16)
        w = torch.randn((co, ci, 3, 3), device=dev, generator=gen) * (
            2.0 / (9 * ci)) ** 0.5
        b = torch.randn((co,), device=dev, generator=gen) * 0.1
        wp = pack_mma(w.permute(2, 3, 1, 0)).to(torch.bfloat16).contiguous()
        stack.reset_launches()
        got = stack.conv3x3_mma(x, wp, b)
        torch.cuda.synchronize()
        route = stack.mma_plan(ci, co).route
        if stack.MMA_SHAPES != {(ci, co, route): 1}:
            raise AssertionError(f"{k.key}: launches {stack.MMA_SHAPES}, "
                                 f"want one on {route}")
        worst, differ = check_mma_layer(
            f"{k.key} {ci} -> {co} at {side} px", got,
            mma_plain_in_chunks(stack, x, wp, b))
        log(f"phase 34 {k.key} ({ci} -> {co}) {tuple(x.shape)}: route "
            f"{route}, max |kernel - plain| {worst:.3e}, {differ:.3%} of "
            f"outputs differ")
        del x, got
        torch.cuda.empty_cache()
    model = unet.CunetModel.build(cunet.init_params(20181022),
                                  torch.bfloat16, dev, tile)
    rng = np.random.default_rng(34)
    frame = torch.from_numpy(structured_bgr(rng, 1, 1080, 1920)).to(dev)
    stack.reset_launches()
    out = pipeline.upcunet2x_batch_u8(pipeline.unit_rgb(frame), model)
    torch.cuda.synchronize()
    step = tile - 2 * pipeline.CUNET_HALO
    tiles = -(-1080 // step) * -(-1920 // step)
    chunks = -(-tiles // pipeline.cunet_chunk(model))
    want = {}
    for k in layers:
        key = (k.cin, k.cout, stack.mma_plan(k.cin, k.cout).route)
        want[key] = want.get(key, 0) + chunks
    if out.shape != (1, 2160, 3840, 3) or stack.MMA_SHAPES != want:
        raise AssertionError(f"upcunet2x_batch_u8 {tuple(out.shape)}: "
                             f"launches {stack.MMA_SHAPES}, want {want}")
    got = {f"{a}>{c}:{r}": v for (a, c, r), v in stack.MMA_SHAPES.items()}
    log(f"phase 34 one 1080p UpCUNet dispatch on {smi} ({tiles} tiles, "
        f"{chunks} chunk(s)): csrc/mma.cu launches by shape and route "
        f"{got}; {time.perf_counter() - t0:.1f} s")
    stack.reset_launches()
    return got


def _three_passes(x, model, key, leaky, skip=None, crop=0):
    """ops/unet.py:_library as it was before csrc/epi.cu, on the card: the
    bias in the cuDNN call, F.leaky_relu, crop_add."""
    from waifu2x_torch.models import cunet
    from waifu2x_torch.ops import unet
    from waifu2x_torch.ops.convstack import no_tf32
    w, b = model.conv[key]
    kind = cunet.BY_KEY[key].kind
    kw = {"down": {"stride": 2}, "up": {"stride": 2},
          "up4": {"stride": 2, "padding": 3}}.get(kind, {})
    op = F.conv_transpose2d if kind in ("up", "up4") else F.conv2d
    with no_tf32():
        y = op(x.permute(0, 3, 1, 2), w, b, **kw)
    if leaky:
        y = F.leaky_relu(y, unet.LEAKY)
    y = y.permute(0, 2, 3, 1).contiguous()
    return y if skip is None else unet.crop_add(skip, crop, y)


# UpCUNet's library layers in the forward pass's order: (key, LeakyReLU,
# the key of the layer whose output is the skip, crop)
CUNET_LIBRARY = (
    ("unet1.conv1.conv.0", True, None, 0),
    ("unet1.conv1_down", True, None, 0),
    ("unet1.conv2_up", True, "unet1.conv1.conv.2", 4),
    ("unet1.conv_bottom", False, None, 0),
    ("unet2.conv1.conv.0", True, None, 0),
    ("unet2.conv1_down", True, None, 0),
    ("unet2.conv2_down", True, None, 0),
    ("unet2.conv3.conv.0", True, None, 0),
    ("unet2.conv3.conv.2", True, None, 0),
    ("unet2.conv3_up", True, "unet2.conv2.conv.2", 4),
    ("unet2.conv4_up", True, "unet2.conv1.conv.2", 16),
    ("unet2.conv_bottom", False, None, 0))


def phase35(dev: torch.device, smi: str, tile: int = 436,
            timed_tiles: int = 16, frame_hw=(1080, 1920)) -> dict:
    """35. UpCUNet's library-layer epilogue on csrc/epi.cu through
    ops/unet.py:cunet_epilogue, at the twelve library layers of a 436-px
    tile (models/cunet.py:layer_sides; `tile`), on seeded weights: two tiles of
    random bf16 input a layer, the cuDNN output without the bias; the
    kernel on it bit for bit against cunet_epilogue_plain (on the CPU, host
    clock) and against the three PyTorch passes, both on the same output
    and as the layer computed them (_three_passes: the bias in the cuDNN
    call), one launch a call in EPI_LAUNCHES by mode. Each layer timed at
    16 tiles (every plane above the 50 MB L2) with CUDA events against its
    bytes (y read and written, the skip's crop read once) at 3.35 TB/s and
    against the three passes, each timed alone (the library yardstick).
    Then one pipeline.upcunet2x_batch_u8 dispatch of a 1080p frame: its
    EPI_LAUNCHES 7 / 3 / 2 a chunk of tiles, its u8 output bit for bit the
    same dispatch's with _three_passes in the place of the epilogue.
    Returns the kernel-table row. (`tile`, `timed_tiles` and `frame_hw`
    shrink it for a rehearsal.)"""
    from waifu2x_torch import pipeline
    from waifu2x_torch.models import cunet
    from waifu2x_torch.ops import _build, unet
    from waifu2x_torch.ops.convstack import no_tf32
    from waifu2x_torch.utils.timing import time_ms

    t0 = time.perf_counter()
    hbm = 3.35e12
    card = int(dev.type == "cuda")   # launches a call (none in a rehearsal)
    sides = cunet.layer_sides(tile)
    model = unet.CunetModel.build(cunet.init_params(20181022),
                                  torch.bfloat16, dev, tile)
    gen = torch.Generator(device=dev).manual_seed(35)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(
            torch.bfloat16)

    rows, plain_ms = [], 0.0
    for key, leaky, skip_key, crop in CUNET_LIBRARY:
        layer = cunet.BY_KEY[key]
        s_in, s_out = sides[key]
        w, b = model.conv[key]
        x = rand(2, s_in, s_in, layer.cin)
        kind = layer.kind
        kw = {"down": {"stride": 2}, "up": {"stride": 2},
              "up4": {"stride": 2, "padding": 3}}.get(kind, {})
        op = F.conv_transpose2d if kind in ("up", "up4") else F.conv2d
        with no_tf32():
            y = op(x.permute(0, 3, 1, 2), w, None, **kw).permute(
                0, 2, 3, 1).contiguous()
        skip = None
        if skip_key:
            s_skip = sides[skip_key][1]
            assert s_skip == s_out + 2 * crop, (key, s_skip, s_out)
            skip = rand(2, s_skip, s_skip, layer.cout)
        unet.reset_epi_launches()
        got = unet.cunet_epilogue(y.clone(), b, leaky, skip, crop)
        torch.cuda.synchronize()
        mode = unet.epi_mode(leaky, skip is not None)
        if unet.EPI_LAUNCHES[mode] != card or sum(
                unet.EPI_LAUNCHES.values()) != card:
            raise AssertionError(f"{key}: launches {unet.EPI_LAUNCHES}")
        t1 = time.perf_counter()
        plain = unet.cunet_epilogue_plain(
            y.cpu(), b.cpu(), leaky, None if skip is None else skip.cpu(),
            crop)
        plain_ms += 1e3 * (time.perf_counter() - t1)
        t = y + b
        if leaky:
            t = F.leaky_relu(t, unet.LEAKY)
        passes = t if skip is None else unet.crop_add(skip, crop, t)
        # (the CPU's bf16 convolution adds its bias in f32: the layer as it
        # was is the card's alone)
        layer_passes = (_three_passes(x, model, key, leaky, skip, crop)
                        if card else passes)
        bits = got.view(torch.int16)
        for name, want in (("cunet_epilogue_plain", plain.to(dev)),
                           ("the three passes", passes),
                           ("the layer as it was", layer_passes)):
            if not torch.equal(bits, want.view(torch.int16)):
                differ = (bits != want.view(torch.int16)).float().mean()
                raise AssertionError(f"phase 35 {key}: {differ.item():.3%} "
                                     f"of values differ from {name}")
        del x, y, got, plain, t, passes, layer_passes, skip
        # timing: 16 tiles of the layer's output (and skip)
        yt = rand(timed_tiles, s_out, s_out, layer.cout)
        st = (rand(timed_tiles, s_out + 2 * crop, s_out + 2 * crop,
                   layer.cout) if skip_key else None)
        ms = time_ms(lambda _: unet.cunet_epilogue(yt, b, leaky, st, crop),
                     dev, 10)
        # the three passes apart, as the layer ran them: the bias added in
        # place to the NCHW view (PyTorch's cuDNN route), F.leaky_relu,
        # crop_add
        nchw = yt.permute(0, 3, 1, 2)
        passes_ms = [
            time_ms(lambda _: nchw.add_(b.view(1, -1, 1, 1)), dev, 10),
            time_ms(lambda _: F.leaky_relu(nchw, unet.LEAKY), dev, 10)
            if leaky else 0.0,
            time_ms(lambda _: unet.crop_add(st, crop, yt), dev, 10)
            if skip_key else 0.0]
        nbytes = 2 * timed_tiles * layer.cout * s_out ** 2 * (
            3 if skip_key else 2)
        bound = 1e3 * nbytes / hbm
        rows.append((key, mode, layer.cout, ms, bound, sum(passes_ms),
                     *passes_ms))
        log(f"phase 35 {key} ({mode}, C {layer.cout}, {timed_tiles} x "
            f"{s_out}^2): {ms:.4f} ms, bound {bound:.4f} ms "
            f"({100 * bound / ms:.1f}%), the three passes "
            f"{sum(passes_ms):.4f} ms (bias add / LeakyReLU / skip add "
            f"{' / '.join(f'{v:.4f}' for v in passes_ms)}); two tiles "
            f"bit-equal to the plain version and the three passes")
        del yt, st, nchw
        torch.cuda.empty_cache()
    total = [sum(r[k] for r in rows) for k in range(3, 9)]
    log(f"phase 35 the twelve epilogues at {timed_tiles} tiles on {smi}: "
        f"{total[0]:.3f} ms against a {total[1]:.3f} ms byte bound "
        f"({100 * total[1] / total[0]:.1f}%), the three passes "
        f"{total[2]:.3f} ms ({total[2] / total[0]:.2f}x: bias adds "
        f"{total[3]:.3f}, LeakyReLU {total[4]:.3f}, skip adds "
        f"{total[5]:.3f}); plain version, two tiles, host clock "
        f"{plain_ms:.0f} ms")
    report = _build.BUILD_LOG.get("epi", (0.0, ""))[1]
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"phase 35 ptxas: {line.strip()}")

    rng = np.random.default_rng(35)
    fh, fw = frame_hw
    frame = torch.from_numpy(structured_bgr(rng, 1, fh, fw)).to(dev)
    x = pipeline.unit_rgb(frame)
    unet.reset_epi_launches()
    out = pipeline.upcunet2x_batch_u8(x, model)
    torch.cuda.synchronize()
    step = tile - 2 * pipeline.CUNET_HALO
    tiles = -(-fh // step) * -(-fw // step)
    chunks = -(-tiles // pipeline.cunet_chunk(model))
    want = {"bias": 2 * chunks * card, "bias_leaky": 7 * chunks * card,
            "bias_skip": 0, "bias_leaky_skip": 3 * chunks * card}
    if unet.EPI_LAUNCHES != want:
        raise AssertionError(f"phase 35 dispatch: launches "
                             f"{unet.EPI_LAUNCHES}, want {want}")
    launches = dict(unet.EPI_LAUNCHES)
    library = unet._library
    unet._library = _three_passes if card else library
    try:
        ref = pipeline.upcunet2x_batch_u8(x, model)
    finally:
        unet._library = library
    if not torch.equal(out, ref):
        raise AssertionError(f"phase 35 dispatch: "
                             f"{(out != ref).float().mean().item():.3%} of "
                             f"u8 values differ from the three passes'")
    log(f"phase 35 one {fh}x{fw} UpCUNet dispatch on {smi} ({tiles} tiles, "
        f"{chunks} chunk(s)): csrc/epi.cu launches {launches}, u8 output "
        f"bit-equal to the three passes'; {time.perf_counter() - t0:.1f} s")
    unet.reset_epi_launches()
    return {"name": "cunet_epilogue, UpCUNet's library-layer epilogue "
                    f"(csrc/epi.cu), {timed_tiles} tiles of {tile} px",
            "ms": total[0], "bound_ms": total[1],
            "library_ms": total[2], "plain_ms": plain_ms,
            "plain_ms_of": "the twelve layers at two tiles, host clock",
            "library_parts_ms": dict(zip(("bias", "leaky", "skip"),
                                         total[3:])),
            "layers": [{"key": r[0], "mode": r[1], "channels": r[2],
                        "ms": r[3], "bound_ms": r[4], "library_ms": r[5]}
                       for r in rows]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from waifu2x_torch.config import Config
    from waifu2x_torch.models.srcnn import (
        SRCNN, count_maccs_per_pixel, init_params)
    from waifu2x_torch.models.weights import load_model_json
    from waifu2x_torch import pipeline as pipeline_mod
    from waifu2x_torch.ops import _build, stack
    from waifu2x_torch.ops.s2d import d2s_host_cmajor, s2d
    from waifu2x_torch.pipeline import (
        Converter, FastStack, _tail_u8_cmajor, _to_bgr_u8, _to_yuv,
        _uv_phases_cmajor, noise_batch, noise_batch_u8_fused,
        noise_y_batch_fast, scale2x_batch, scale2x_batch_u8_fused)
    from waifu2x_torch.stream import StreamConverter
    from waifu2x_torch.utils.metrics import psnr
    from waifu2x_torch.utils.timing import card_name

    t_start = time.perf_counter()
    smi = card_name()
    log(smi)
    dev = torch.device("cuda")
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    # 1. build
    t0 = time.perf_counter()
    _build.load("gather", "mma", "wino", "l7", "probe", "tmm", "l1",
                "mma_tf32", "i8", "epi")
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    log("  " + nvcc.strip().splitlines()[-1])
    for name, (secs, out) in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        log(f"  nvcc {name}.cu {secs:.2f} s; ptxas: " + " | ".join(regs))

    # 2. f32 kernel vs plain at small and odd shapes
    sp_rand = stack.prep_params(init_params(3), torch.float32, dev)
    gen = torch.Generator().manual_seed(0)
    for shape in [(2, 37, 53), (1, 8, 8), (2, 64, 96), (1, 5, 300)]:
        y = torch.rand(shape, generator=gen).to(dev)
        err = (stack.stack_scale(y, sp_rand)
               - stack.stack_scale_plain(y, sp_rand)).abs().max().item()
        log(f"phase 2 f32 {shape}: max|kernel - plain| = {err:.3e}")
        check_max_err(f"f32 scale kernel at {shape}", err, F32_TOL)

    # 3. the kernel vs its plain version at the main path's shape
    params = load_model_json(root / "models" / "scale2.0x_demo.json")
    params_n1 = load_model_json(root / "models" / "noise1_demo.json")
    params_n2 = load_model_json(root / "models" / "noise2_demo.json")
    # (bf16, f32) weights of each shipped model, for the held calls' f32
    # comparison
    twins = [(stack.prep_params(p, torch.bfloat16, dev),
              stack.prep_params(p, torch.float32, dev))
             for p in (params, params_n1, params_n2)]
    (sp16, sp32), (spn16, spn32) = twins[0], twins[1]

    def f32_twin(sp):
        if sp[0][0].dtype == torch.float32:
            return sp
        for s16, s32 in twins:
            if all(torch.equal(a[0], b[0]) for a, b in zip(sp, s16)):
                return s32
        raise AssertionError("bf16 weights of no shipped model")

    rng = np.random.default_rng(0)
    frames = structured_bgr(rng, 16, 512, 512)
    yuv = _to_yuv(torch.from_numpy(frames).to(dev))
    ylow = yuv[..., 0].contiguous()
    ylow16 = ylow.to(torch.bfloat16)
    ref32 = stack.stack_scale_plain(ylow, sp32)
    err32 = (stack.stack_scale(ylow, sp32) - ref32).abs().max().item()
    got16 = stack.stack_scale(ylow16, sp16)
    ref16 = stack.stack_scale_plain(ylow16, sp16).float()
    err16 = (got16.float() - ref16).abs().max().item()
    db16 = psnr1(got16.float(), ref32)
    log(f"phase 3 {tuple(ylow.shape)}: f32 max|kernel - plain| = "
        f"{err32:.3e}; bf16 max|kernel - bf16 plain| = {err16:.3e}; "
        f"bf16 kernel vs f32 plain {db16:.2f} dB")
    check_max_err("f32 scale kernel at the main shape", err32, F32_TOL)
    if not (err16 <= BF16_TOL and db16 >= PSNR_BAR):
        raise AssertionError(f"bf16 kernel: {err16} abs, {db16} dB")
    max_err = {"stack_scale": max(err32, err16)}
    # the adversarial worst case for bf16 storage: a pure-random luma
    # plane, every pixel an edge (reported, not gated)
    noise = torch.rand((2, 512, 512), generator=gen).to(dev)
    db_noise = psnr1(
        stack.stack_scale(noise.to(torch.bfloat16), sp16).float(),
        stack.stack_scale_plain(noise, sp32))
    log(f"  bf16 kernel on a pure-random plane vs f32 plain: "
        f"{db_noise:.2f} dB")
    del ref32, ref16, got16, noise
    torch.cuda.empty_cache()

    # 4. the main path at full width. From here to the end of phase 8 the
    # pipeline's wrapper calls are recorded, and after each run every one
    # is held against its plain version on the same input (hold_seen).
    seen = {}
    restore_wrappers = record_wrapper_calls(pipeline_mod, seen)
    fast = FastStack.build(params, True, dtype=torch.bfloat16, device=dev)
    stack.reset_launches()
    u8 = scale2x_batch_u8_fused(_to_yuv(torch.from_numpy(frames).to(dev)),
                                fast)
    launches, mid_launches = stack.LAUNCHES, dict(stack.MID_LAUNCHES)
    l7_main = stack.L7_LAUNCHES["fold"]
    l1_main = stack.L1_LAUNCHES["l1"]
    out = d2s_host_cmajor(u8.cpu().numpy())
    log(f"phase 4 main path: {frames.shape} -> {out.shape} {out.dtype}, "
        f"{launches} kernel launches, layers 2-6 by kernel {mid_launches}, "
        f"layer 7 by kernel {stack.L7_LAUNCHES}")
    expect_l7(stack, "phase 4 main path", bf16=1)
    expect_l1(stack, "phase 4 main path", 1)
    if (launches != 7 or out.shape != (16, 1024, 1024, 3)
            or mid_launches != {"mma": 5, "chain": 0,
                                "mma_zs": 0, "mma_pp": 0, "mma_tf32": 0,
                                "mma_resident": 4, "mma_split": 1,
                                "mma_tile": 0}):
        raise AssertionError(f"main path: {launches} launches, "
                             f"{mid_launches}, {out.shape}")
    hold_seen(seen, stack, f32_twin, max_err)
    model32 = SRCNN.from_params(params).to(dev)
    cfg32 = Config(mode="scale", compute_dtype="float32")
    ref_main = _to_bgr_u8(scale2x_batch(yuv[:2], model32,
                                        cfg32)).cpu().numpy()
    db_main = psnr(out[:2], ref_main)
    log(f"  frames 0-1 vs f32 non-kernel path: {db_main:.2f} dB")
    if not db_main >= PSNR_BAR:
        raise AssertionError(f"main path at {db_main} dB")
    del u8, out
    torch.cuda.empty_cache()

    mdir_obj = tempfile.TemporaryDirectory()
    mdir = mdir_obj.name
    for demo, name in (("scale2.0x", "scale2.0x"), ("noise1", "noise1"),
                       ("noise2", "noise2")):
        shutil.copy(root / "models" / f"{demo}_demo.json",
                    Path(mdir) / f"{name}_model.json")
    img = structured_bgr(rng, 1, 720, 1280)[0]

    def converter_check(cfg_kw: dict, img: np.ndarray, bar: float,
                        min_launches: int, ref: np.ndarray) -> float:
        conv = Converter.from_config(Config(model_dir=mdir, **cfg_kw), dev)
        stack.reset_launches()
        got = conv.process_bgr_u8(img)
        n_conv = stack.LAUNCHES   # 7 per dispatch; tall planes band
        # every layer 7 folded: bf16 on the tensor cores, f32 with FFMA (the
        # f32 stacks: compute_dtype float32, and the noise stack of the
        # default noise_scale policy)
        l7 = dict(stack.L7_LAUNCHES)
        f32_stacks = cfg_kw.get("compute_dtype") == "float32" or (
            cfg_kw.get("mode") == "noise_scale"
            and cfg_kw.get("compute_dtype") == "auto")
        if (l7["fold"] + l7["fold_f32"] != n_conv // 7
                or bool(l7["fold_f32"]) != f32_stacks):
            raise AssertionError(f"Converter {cfg_kw}: layer-7 launches "
                                 f"{l7} for {n_conv} launches")
        db = psnr(got, ref)
        log(f"  Converter {cfg_kw} {img.shape} -> {got.shape}: {n_conv} "
            f"launches (layer 7 {l7}), {db:.2f} dB vs f32 non-kernel path "
            f"(bar {bar:g})")
        if (n_conv < min_launches or n_conv % 7 or got.shape != ref.shape
                or not db >= bar):
            raise AssertionError(f"Converter {cfg_kw}: {n_conv} launches, "
                                 f"{db} dB")
        hold_seen(seen, stack, f32_twin, max_err)
        del conv, got
        torch.cuda.empty_cache()
        return db

    def converter_ref(cfg_kw: dict, img: np.ndarray) -> np.ndarray:
        return Converter.from_config(Config(
            model_dir=mdir, use_pallas=False, compute_dtype="float32",
            **cfg_kw), dev).process_bgr_u8(img)

    refs = {}
    for ratio, dtype, bar in ((2.0, "auto", PSNR_BAR),
                              (4.0, "auto", CHAIN_BAR),
                              (4.0, "float32", PSNR_BAR)):
        kw = dict(mode="scale", scale_ratio=ratio)
        if ratio not in refs:
            refs[ratio] = converter_ref(kw, img)
        converter_check(dict(kw, compute_dtype=dtype), img, bar,
                        7 * int(np.log2(ratio)), refs[ratio])
    del refs

    # 5. the noise kernel (B2) vs its plain version
    for shape in [(1, 27, 38), (2, 37, 53), (1, 5, 300), (1, 8, 8)]:
        y = torch.rand(shape, generator=gen).to(dev)
        err = (stack.stack_noise(y, sp_rand)
               - stack.stack_noise_plain(y, sp_rand)).abs().max().item()
        msg = f"phase 5 f32 noise {shape}: max|kernel - plain| = {err:.3e}"
        check_max_err(f"f32 noise kernel at {shape}", err, F32_TOL)
        max_err["stack_noise"] = max(max_err.get("stack_noise", 0.0), err)
        if shape[1] % 2 == 0 and shape[2] % 2 == 0:
            err = (stack.stack_noise_s2d(y, sp_rand)
                   - stack.stack_noise_s2d_plain(y, sp_rand)
                   ).abs().max().item()
            msg += f"; s2d {err:.3e}"
            check_max_err(f"f32 noise_s2d kernel at {shape}", err, F32_TOL)
            max_err["stack_noise_s2d"] = max(
                max_err.get("stack_noise_s2d", 0.0), err)
        log(msg)

    frames_n = structured_bgr(rng, 256, 256, 256)
    yuv_n = _to_yuv(torch.from_numpy(frames_n).to(dev))
    yn = yuv_n[..., 0].contiguous()
    yn16 = yn.to(torch.bfloat16)
    ref32 = stack.stack_noise_s2d_plain(yn, spn32)
    errn32 = (stack.stack_noise_s2d(yn, spn32) - ref32).abs().max().item()
    got16 = stack.stack_noise_s2d(yn16, spn16)
    errn16 = (got16.float() - stack.stack_noise_s2d_plain(yn16, spn16)
              .float()).abs().max().item()
    dbn16 = psnr1(got16.float(), ref32)
    log(f"phase 5 noise {tuple(yn.shape)}: f32 max|kernel - plain| = "
        f"{errn32:.3e}; bf16 max|kernel - bf16 plain| = {errn16:.3e}; "
        f"bf16 kernel vs f32 plain {dbn16:.2f} dB")
    check_max_err("f32 noise kernel at noise256", errn32, F32_TOL)
    if not (errn16 <= BF16_TOL and dbn16 >= PSNR_BAR):
        raise AssertionError(f"bf16 noise kernel: {errn16} abs, {dbn16} dB")
    max_err["stack_noise_s2d"] = max(max_err.get("stack_noise_s2d", 0.0),
                                     errn32, errn16)
    del ref32, got16
    torch.cuda.empty_cache()

    # 6. the noise256 main path at full width
    fast_n1 = FastStack.build(params_n1, False, dtype=torch.bfloat16,
                              device=dev)
    stack.reset_launches()
    u8 = noise_batch_u8_fused(_to_yuv(torch.from_numpy(frames_n).to(dev)),
                              fast_n1)
    launches_n = stack.LAUNCHES
    out = d2s_host_cmajor(u8.cpu().numpy())
    log(f"phase 6 noise256 main path: {frames_n.shape} -> {out.shape} "
        f"{out.dtype}, {launches_n} kernel launches, layer 7 by kernel "
        f"{stack.L7_LAUNCHES}")
    expect_l7(stack, "phase 6 noise256 main path", bf16=1)
    expect_l1(stack, "phase 6 noise256 main path", 1)
    if launches_n != 7 or out.shape != frames_n.shape:
        raise AssertionError(f"noise256: {launches_n} launches, {out.shape}")
    hold_seen(seen, stack, f32_twin, max_err)
    modeln32 = SRCNN.from_params(params_n1).to(dev)
    cfgn32 = Config(mode="noise", compute_dtype="float32")
    ref_n256 = _to_bgr_u8(noise_batch(yuv_n[:2], modeln32,
                                      cfgn32)).cpu().numpy()
    db_n256 = psnr(out[:2], ref_n256)
    log(f"  frames 0-1 vs f32 non-kernel noise_batch: {db_n256:.2f} dB")
    if not db_n256 >= PSNR_BAR:
        raise AssertionError(f"noise256 main path at {db_n256} dB")
    del u8, out
    torch.cuda.empty_cache()

    # 7. the ns1080 chain: noise2 -> scale2.0x on 4 1080p frames
    frames_c = structured_bgr(rng, 4, 1080, 1920)
    yuv_c = _to_yuv(torch.from_numpy(frames_c).to(dev))
    modeln2_32 = SRCNN.from_params(params_n2).to(dev)
    cfgn2_32 = Config(mode="noise", compute_dtype="float32")
    ref_chain = np.concatenate([_to_bgr_u8(scale2x_batch(
        noise_batch(yuv_c[i:i + 1], modeln2_32, cfgn2_32), model32, cfg32))
        .cpu().numpy() for i in range(len(frames_c))])   # a frame at a time
    ref = ref_chain
    torch.cuda.empty_cache()
    fast_n2 = {dt: FastStack.build(params_n2, False, dtype=dt, device=dev)
               for dt in (torch.bfloat16, torch.float32)}

    def chain(fast_noise):
        y = noise_y_batch_fast(yuv_c[..., 0], fast_noise, out_dtype=None)
        return scale2x_batch_u8_fused(yuv_c, fast, y=y)

    db_chain = {}
    for dt, bar in ((torch.bfloat16, CHAIN_BAR), (torch.float32, PSNR_BAR)):
        stack.reset_launches()
        u8 = chain(fast_n2[dt])
        launches_c = stack.LAUNCHES
        # the noise stack's layer 7: folded on the tensor cores in bf16,
        # folded with FFMA in f32
        expect_l7(stack, f"phase 7 ns1080 chain, {dt} noise",
                  *((2, 0) if dt == torch.bfloat16 else (1, 1)))
        if dt == torch.float32:
            l7_f32_main = stack.L7_LAUNCHES["fold_f32"]
        expect_l1(stack, f"phase 7 ns1080 chain, {dt} noise", 2)
        # layers 2-6: the bf16 scale stack's on csrc/mma.cu, the noise
        # stack's there too in bf16, as 3xTF32 (csrc/mma_tf32.cu) in f32
        f32_noise = dt == torch.float32
        want = {k: 0 for k in stack.MID_LAUNCHES}
        want.update(mma=5 if f32_noise else 10, mma_tf32=5 * f32_noise,
                    mma_resident=4 if f32_noise else 8,
                    mma_split=1 if f32_noise else 2)
        if stack.MID_LAUNCHES != want:
            raise AssertionError(f"ns1080 chain {dt}: layers 2-6 launches "
                                 f"{stack.MID_LAUNCHES}, want {want}")
        if f32_noise:
            tf32_main = stack.MID_LAUNCHES["mma_tf32"]
        out = d2s_host_cmajor(u8.cpu().numpy())
        db_frames = [psnr(out[i], ref[i]) for i in range(len(ref))]
        db_chain[dt] = min(db_frames)
        log(f"phase 7 ns1080 chain, {dt} noise / bf16 scale: "
            f"{tuple(u8.shape)} u8, {launches_c} kernel launches (layers "
            f"2-6 {stack.MID_LAUNCHES}, layer 7 {stack.L7_LAUNCHES}), frames "
            f"0-3 "
            + " / ".join(f"{db:.2f}" for db in db_frames)
            + f" dB vs the f32 non-kernel chain (bar {bar:g} each)")
        if (launches_c != 14 or tuple(u8.shape) != (4, 1080, 1920, 16)
                or not db_chain[dt] >= bar):
            raise AssertionError(f"ns1080 chain {dt}: {launches_c} launches, "
                                 f"{db_frames} dB")
        hold_seen(seen, stack, f32_twin, max_err)
        out_chain = out    # the f32-noise chain's frames, for phase 11
        del u8, out
        torch.cuda.empty_cache()
    del ref

    # 8. Converter noise / noise_scale, auto policy, even and odd images
    img_odd = structured_bgr(rng, 1, 721, 1279)[0]
    for kw, min_l in ((dict(mode="noise", noise_level=1), 7),
                      (dict(mode="noise", noise_level=2), 7),
                      (dict(mode="noise_scale", noise_level=1), 14)):
        for im in (img, img_odd):
            converter_check(dict(kw, compute_dtype="auto"), im, PSNR_BAR,
                            min_l, converter_ref(kw, im))

    # 9. the last layer's other output forms: dense Y (B6), u8 BGR (B3)
    sp_rand16 = stack.prep_params(init_params(3), torch.bfloat16, dev)
    cases = [(torch.rand(shape, generator=gen).to(dev), None)
             for shape in [(2, 37, 53), (1, 8, 8), (1, 5, 300)]]
    cases.append((ylow, _uv_phases_cmajor(yuv)))       # scale512
    for y32, uvp in cases:
        shape = tuple(y32.shape)
        _, hl, wl = shape
        main_shape = uvp is not None
        if not main_shape:
            uvp = _uv_phases_cmajor(
                torch.rand((*shape, 3), generator=gen).to(dev))
        for dt in (torch.float32, torch.bfloat16):
            f32 = dt == torch.float32
            sp = ((sp32 if f32 else sp16) if main_shape
                  else (sp_rand if f32 else sp_rand16))
            y = y32.to(dt)
            ydense, tc = stack.stack_scale_dense(y, sp)
            check_dense_pad(f"dense at {shape}", ydense, tc, wl)
            y_s2d = stack.stack_scale(y, sp)
            if not torch.equal(stack.dense_to_s2d(ydense, tc, hl, wl), y_s2d):
                raise AssertionError(f"dense at {shape} {dt}: un-chunked "
                                     f"output differs from stack_scale")
            msg = (f"phase 9 {shape} {dt}: dense (tc {tc}) un-chunked == "
                   f"stack_scale, pad zero")
            if f32 and not main_shape:
                err = (ydense - stack.stack_scale_dense_plain(y, sp, tc)[0]
                       ).abs().max().item()
                check_max_err(f"f32 dense kernel at {shape}", err, F32_TOL)
                max_err["stack_scale_dense"] = max(
                    max_err.get("stack_scale_dense", 0.0), err)
                msg += f", max|kernel - plain| = {err:.3e}"
            got = stack.stack_scale_fused_u8(y, uvp, sp)
            check_lanes_zero(f"u8 kernel at {shape}", got)
            worst, frac = check_u8_kernel(
                f"u8 kernel at {shape} {dt}", got, in_chunks(
                    lambda i, j: stack.stack_scale_fused_u8_plain(
                        y[i:j], uvp[i:j], sp), y, True), dt)
            max_err["stack_scale_fused_u8"] = max(
                max_err.get("stack_scale_fused_u8", 0.0), worst)
            msg += (f"; u8 max|kernel - plain| = {worst} level at "
                    f"{frac:.4%} of bytes")
            if main_shape:
                tail = _tail_u8_cmajor(y_s2d, yuv)
                if f32:
                    worst, frac = check_u8("f32 kernel tail vs default tail",
                                           got, tail)
                    msg += (f"; vs the default tail {worst} level at "
                            f"{frac:.4%} of bytes")
                else:
                    db = 20 * np.log10(255.0) + psnr1(got, in_chunks(
                        lambda i, j: stack.stack_scale_fused_u8_plain(
                            y32[i:j], uvp[i:j], sp32), y, True))
                    msg += f"; vs f32 plain {db:.2f} dB"
                    if not db >= PSNR_BAR:
                        raise AssertionError(f"bf16 u8 kernel: {db} dB")
                    # the default tail maps the bf16 rounding of the same
                    # f32 Y: half a bf16 unit of Y, under one level
                    worst, frac = check_u8("bf16 kernel tail vs default tail",
                                           got, tail, 1, 1.01)
                    msg += (f"; vs the default tail {worst} level at "
                            f"{frac:.4%} of bytes")
                    db_k, db_x = (psnr(d2s_host_cmajor(
                        t[:2].cpu().numpy()), ref_main) for t in (got, tail))
                    msg += (f"; frames 0-1 vs f32 non-kernel path: kernel "
                            f"tail {db_k:.2f} dB, default tail {db_x:.2f} dB")
                    if not db_k >= db_x - 0.1:
                        raise AssertionError(f"bf16 kernel tail {db_k} dB, "
                                             f"default tail {db_x} dB")
                del tail
            log(msg)
            del ydense, y_s2d, got
            torch.cuda.empty_cache()
    del cases, uvp

    def set_tail(tail: str, ydense: bool) -> None:
        pipeline_mod.FUSED_TAIL, pipeline_mod.YDENSE = tail, ydense

    def expect_counts(label, counts, dispatches, want_dispatches, **want):
        want = {k: want.get(k, 0) for k in counts}
        if dispatches != want_dispatches or counts != want:
            raise AssertionError(f"{label}: {dispatches} dispatches, "
                                 f"launches {counts}; want "
                                 f"{want_dispatches}, {want}")

    def expect_equal(label, outs, refs) -> None:
        for k, (got, ref) in enumerate(zip(outs, refs, strict=True)):
            if got.shape != ref.shape or not np.array_equal(got, ref):
                raise AssertionError(f"{label}: frame {k} differs")

    def to_yuv_dev(frames_u8) -> torch.Tensor:
        return _to_yuv(torch.from_numpy(np.stack(frames_u8)).to(dev))

    # 10. the scale stream in its three tails; the last is the main path
    frames64 = list(frames) + list(structured_bgr(rng, 48, 512, 512))
    # untimed: the first pinned host buffers and the allocator's blocks
    list(StreamConverter(fast, batch=16, depth=2, device=dev)
         .process_frames(frames64[:32]))
    seen.clear()
    stream_outs, stream_launches, stream_db = {}, {}, {}
    for kind, tail, ydense in (("scale", "xla", False),
                               ("dense", "xla", True),
                               ("fused_u8", "kernel", False)):
        label = f"phase 10 scale512, W2X_TAIL={tail} W2X_YDENSE={int(ydense)}"
        set_tail(tail, ydense)
        sc = StreamConverter(fast, batch=16, depth=2, device=dev)
        outs, counts, nd = run_stream(sc, frames64, stack, label, smi)
        expect_counts(label, counts, nd, 4, **{kind: 28})
        expect_l7(stack, label, bf16=4)
        if stack.MID_LAUNCHES != {"mma": 20, "chain": 0,
                                  "mma_zs": 0, "mma_pp": 0, "mma_tf32": 0,
                                  "mma_resident": 16, "mma_split": 4,
                                  "mma_tile": 0}:
            raise AssertionError(f"{label}: layers 2-6 launches "
                                 f"{stack.MID_LAUNCHES}")
        for k in range(0, 64, 16):   # the batch step on the same batch
            ref = d2s_host_cmajor(scale2x_batch_u8_fused(
                to_yuv_dev(frames64[k:k + 16]), fast).cpu().numpy())
            expect_equal(label + " vs the batch step", outs[k:k + 16], ref)
        db = psnr(np.stack(outs[:2]), ref_main)
        log(f"  in order, equal to the batch step; frames 0-1 vs f32 "
            f"non-kernel path: {db:.2f} dB")
        if outs[0].shape != (1024, 1024, 3) or not db >= PSNR_BAR:
            raise AssertionError(f"{label}: {outs[0].shape}, {db} dB")
        hold_seen(seen, stack, f32_twin, max_err)
        stream_outs[kind], stream_launches[kind] = outs, counts[kind]
        stream_db[kind] = db
    set_tail("xla", False)
    expect_equal("YDENSE stream vs default tail", stream_outs["dense"],
                 stream_outs["scale"])
    # the two round Y at another place: a level at most, at any byte
    worst, frac = check_u8(
        "kernel-tail stream vs default tail",
        torch.from_numpy(np.stack(stream_outs["fused_u8"][:16])),
        torch.from_numpy(np.stack(stream_outs["scale"][:16])), 1, 1.01)
    log(f"phase 10: YDENSE stream == default tail stream bit for bit; "
        f"kernel tail vs default tail (bf16, frames 0-15): {worst} level "
        f"at {frac:.4%} of bytes")
    del stream_outs, outs, ref
    torch.cuda.empty_cache()

    # 11. the noise stream, an odd frame among even ones, the noise_scale
    # stream of from_params, and mixed sizes
    label = "phase 11 noise256"
    sc = StreamConverter(None, batch=256, depth=2, fast_noise=fast_n1,
                         mode="noise", device=dev)
    outs_n, counts, nd = run_stream(
        sc, list(frames_n) + list(frames_n[::-1]), stack, label, smi)
    expect_counts(label, counts, nd, 2, noise=14)
    expect_l7(stack, label, bf16=2)
    ref = d2s_host_cmajor(noise_batch_u8_fused(yuv_n, fast_n1).cpu().numpy())
    expect_equal(label + " vs the batch step", outs_n[:256], ref)
    expect_equal(label + " second batch", outs_n[256:], ref[::-1])
    db = psnr(np.stack(outs_n[:2]), ref_n256)
    log(f"  in order, equal to the batch step; frames 0-1 vs f32 "
        f"non-kernel noise_batch: {db:.2f} dB")
    if not db >= PSNR_BAR:
        raise AssertionError(f"{label}: {db} dB")
    hold_seen(seen, stack, f32_twin, max_err)

    label = "phase 11 noise, one odd 255x257 frame among 256x256"
    odd = structured_bgr(rng, 1, 255, 257)[0]
    mix = list(frames_n[:3]) + [odd] + list(frames_n[3:5])
    sc = StreamConverter(None, batch=4, depth=2, fast_noise=fast_n1,
                         mode="noise", device=dev)
    outs, counts, nd = run_stream(sc, mix, stack, label, smi)
    # 4 even frames, the fifth padded to 4, the odd one padded to 4
    expect_counts(label, counts, nd, 3, noise=21)
    expect_l7(stack, label, bf16=3)
    expect_equal(label, outs[:3] + outs[4:], outs_n[:5])
    ref_odd = _to_bgr_u8(noise_batch(to_yuv_dev([odd]), modeln32,
                                     cfgn32)).cpu().numpy()[0]
    db = psnr(outs[3], ref_odd)
    log(f"  even frames equal the batch-256 stream's; odd frame "
        f"{outs[3].shape} vs f32 non-kernel noise_batch: {db:.2f} dB")
    if outs[3].shape != odd.shape or not db >= PSNR_BAR:
        raise AssertionError(f"{label}: {outs[3].shape}, {db} dB")
    hold_seen(seen, stack, f32_twin, max_err)
    del outs_n, outs, ref

    label = "phase 11 ns1080, from_params"
    sc = StreamConverter.from_params(
        scale_params=params, noise_params=params_n2, mode="noise_scale",
        batch=8, depth=2, device=dev)
    if (sc._shape_batch(1080, 1920) != 4
            or sc.fast_noise.dtype != torch.float32
            or sc.fast.dtype != torch.bfloat16):
        raise AssertionError(f"{label}: batch "
                             f"{sc._shape_batch(1080, 1920)}, dtypes "
                             f"{sc.fast_noise.dtype} / {sc.fast.dtype}")
    outs, counts, nd = run_stream(sc, list(frames_c) * 2, stack, label, smi)
    expect_counts(label, counts, nd, 2, noise=14, scale=14)
    # the f32 noise stack's layer 7 folded with FFMA, the bf16 scale stack's
    # on the tensor cores
    expect_l7(stack, label, bf16=2, f32=2)
    expect_equal(label + " vs the phase 7 chain", outs, list(out_chain) * 2)
    db_frames = [psnr(o, ref_chain[i % 4]) for i, o in enumerate(outs)]
    log(f"  batch 8 cut to 4 by the volume cap, f32 noise stack; equal to "
        f"the phase 7 chain; frames 0-7 "
        + " / ".join(f"{db:.2f}" for db in db_frames)
        + " dB vs the f32 non-kernel chain")
    if not min(db_frames) >= PSNR_BAR:
        raise AssertionError(f"{label}: {db_frames} dB")
    hold_seen(seen, stack, f32_twin, max_err)
    del outs, out_chain, sc   # ref_chain: phase 15 reads it again
    torch.cuda.empty_cache()

    label = "phase 11 mixed sizes, W2X_TAIL=kernel"
    sizes = [(360, 640), (270, 480), (512, 512)]
    mixed = [structured_bgr(rng, 1, *sizes[k])[0]
             for k in (0, 1, 0, 2, 1, 0, 0, 2, 1, 0, 2)]
    set_tail("kernel", False)
    sc = StreamConverter(fast, batch=2, depth=2, device=dev)
    outs, counts, nd = run_stream(sc, mixed, stack, label, smi)
    # 5 + 3 + 3 frames at batch 2: 4 full batches and 3 padded tails
    expect_counts(label, counts, nd, 7, fused_u8=49)
    expect_l7(stack, label, bf16=7)
    expect_equal(label, outs, [d2s_host_cmajor(scale2x_batch_u8_fused(
        to_yuv_dev([f]), fast).cpu().numpy())[0] for f in mixed])
    log("  output order equals input order; every frame equal to its "
        "single-frame batch step")
    set_tail("xla", False)
    hold_seen(seen, stack, f32_twin, max_err)
    del outs
    restore_wrappers()
    mdir_obj.cleanup()
    log(f"phases 1-11 passed in {time.perf_counter() - t_start:.1f} s")

    # 12. the truncated stack (B7): every upto against its plain version
    def upto_check(y, sp, label) -> float:
        tol = F32_TOL if y.dtype == torch.float32 else BF16_TOL
        errs = []
        for k in range(7):
            stack.reset_launches()
            got = stack.stack_scale_upto(y, sp, k)
            gathers = {"tiled": int(k < 6)}
            if (stack.LAUNCHES != k + 1 or stack.L6_LAUNCHES["upto"] != 1
                    or stack.GATHER_LAUNCHES != gathers
                    or stack.KERNEL_LAUNCHES["scale"] != k + 1
                    or tuple(got.shape) != (*y.shape, 4)
                    or got.dtype != y.dtype):
                raise AssertionError(
                    f"upto {k} {label}: {stack.LAUNCHES} launches, "
                    f"{stack.L6_LAUNCHES}, {tuple(got.shape)} {got.dtype}")
            errs.append((got.float() - in_chunks(
                lambda i, j: stack.stack_scale_upto_plain(y[i:j], sp,
                                                          k).float(),
                y, True)).abs().max().item())
            check_max_err(f"upto {k} {label}", errs[-1], tol)
        log(f"phase 12 upto 0..6 {label}: max|kernel - plain| = "
            + " ".join(f"{e:.2e}" for e in errs) + "; upto + 1 launches")
        return max(errs)

    l6_cases = [torch.rand(shape, generator=gen).to(dev)
                for shape in [(2, 37, 53), (1, 5, 300)]]
    max_err["upto"] = 0.0
    for y32 in l6_cases + [ylow]:
        main_shape = y32 is ylow
        for dt in (torch.float32, torch.bfloat16):
            f32 = dt == torch.float32
            sp = ((sp32 if f32 else sp16) if main_shape
                  else (sp_rand if f32 else sp_rand16))
            max_err["upto"] = max(max_err["upto"], upto_check(
                y32.to(dt), sp, f"{tuple(y32.shape)} {dt}"))
    torch.cuda.empty_cache()

    # 13. Winograd layer 6 (B5)
    t13 = time.perf_counter()
    def plain_kw(name, **kw):
        fn = getattr(stack, name)
        return lambda x, sp: fn(x, sp, **kw)

    def wino_check(y32, sps, label, noise, psnr_gate) -> float:
        """Both dtypes of one input; sps = (f32 weights, bf16 weights)."""
        name = ("stack_noise" if noise and not psnr_gate
                else "stack_noise_s2d" if noise else "stack_scale")
        kernel, plain = getattr(stack, name), plain_kw(name + "_plain",
                                                       l6_wino=True)
        stack.reset_launches()
        got32 = kernel(y32, sps[0], l6_wino=True)
        expect_wino(f"f32 {name} {label}", 0, tf32=1)
        ref32 = plain_in_chunks(plain, y32, sps[0], not noise)
        err32 = (got32 - ref32).abs().max().item()
        vs_direct = (got32 - kernel(y32, sps[0], l6_wino=False)
                     ).abs().max().item()
        y16 = y32.to(torch.bfloat16)
        stack.reset_launches()
        got16 = kernel(y16, sps[1], l6_wino=True).float()
        expect_wino(f"bf16 {name} {label}", 1)
        err16 = (got16 - plain_in_chunks(plain, y16, sps[1], not noise)
                 ).abs().max().item()
        db16 = psnr1(got16, ref32)
        log(f"phase 13 wino {name} {label}: f32 max|kernel - plain| = "
            f"{err32:.3e}, max|wino - direct kernel| = {vs_direct:.3e}; "
            f"bf16 (tensor cores) max|kernel - bf16 plain| = {err16:.3e}, "
            f"vs f32 plain {db16:.2f} dB")
        check_max_err(f"f32 wino {name} {label}", err32, F32_TOL)
        check_max_err(f"f32 wino vs direct {name} {label}", vs_direct,
                      WINO_VS_DIRECT_TOL)
        check_max_err(f"bf16 wino {name} {label}", err16, BF16_TOL)
        if psnr_gate and not db16 >= PSNR_BAR:
            raise AssertionError(f"bf16 wino {name} {label}: {db16} dB")
        return max(err32, err16)

    def expect_wino(label, mma, tf32=0):
        """The Winograd layer 6 ran on the kernel its dtype selects."""
        want = {"mma": mma, "mma_tf32": tf32}
        if (stack.WINO_LAUNCHES != want
                or stack.L6_LAUNCHES["wino"] != mma + tf32):
            raise AssertionError(f"{label}: Winograd launches "
                                 f"{stack.WINO_LAUNCHES}, want {want}")

    def wino_layer_check(x5, label) -> float:
        """The tensor-core Winograd layer alone against the plain version
        of its arithmetic: one bf16 ulp at the output's magnitude."""
        stack.reset_launches()
        got = stack.wino_layer(x5, sp_l6)
        torch.cuda.synchronize()
        if (stack.WINO_LAUNCHES != {"mma": 1, "mma_tf32": 0}
                or stack.LAUNCHES
                or any(stack.L6_LAUNCHES.values())):
            raise AssertionError(f"wino_layer alone {label}: launches "
                                 f"{stack.WINO_LAUNCHES}, {stack.LAUNCHES}")
        c = max(1, int(2e9 // (x5[0].numel() * 4 * 2)))
        ref = torch.cat([stack.wino_layer_plain(x5[i:i + c], sp_l6.w6m,
                                                sp_l6[5][1])
                         for i in range(0, x5.shape[0], c)])
        err, share = check_mma_layer(f"wino layer 6 {label}", got, ref)
        log(f"phase 13 wino layer 6 alone (tensor cores) {label} "
            f"{tuple(x5.shape)}, largest output "
            f"{ref.float().abs().max().item():.3f}: max|kernel - plain| "
            f"{err:.3e}, {share:.4%} of outputs differ")
        return err

    max_err["wino_layer"] = 0.0
    dev_gen13 = torch.Generator(device=dev).manual_seed(13)
    for sp_l6, shape in ((sp_rand16, (1, 27, 38)), (sp_rand16, (2, 37, 53)),
                         (sp_rand16, (1, 5, 300)), (sp16, (16, 512, 512)),
                         (spn16, (256, 128, 128))):
        n_, h_, w_ = shape   # s2d cells; layer 5's plane is 2h + 4 square
        x5 = torch.rand((n_, 2 * h_ + 4, 2 * w_ + 4, 128), device=dev,
                        generator=dev_gen13).to(torch.bfloat16)
        label = {(16, 512, 512): "scale512",
                 (256, 128, 128): "noise256"}.get(shape, str(shape))
        max_err["wino_layer"] = max(max_err["wino_layer"],
                                    wino_layer_check(x5, label))
        del x5
        torch.cuda.empty_cache()

    max_err["wino"] = 0.0
    for y32 in l6_cases:
        for noise in (False, True):
            max_err["wino"] = max(max_err["wino"], wino_check(
                y32, (sp_rand, sp_rand16), tuple(y32.shape), noise, False))
    max_err["wino"] = max(
        max_err["wino"],
        wino_check(ylow, (sp32, sp16), "scale512", False, True),
        wino_check(yn, (spn32, spn16), "noise256", True, True))
    # the pure-random plane of phase 3, now with V rounded once
    noise = torch.rand((2, 512, 512), generator=gen).to(dev)
    ref_noise = stack.stack_scale_plain(noise, sp32)
    db_noise_l6 = {form: psnr1(stack.stack_scale(
        noise.to(torch.bfloat16), sp16, l6_wino=form == "wino").float(),
        ref_noise) for form in ("direct", "wino")}
    log(f"phase 13 bf16 stack on a pure-random plane vs f32 plain: "
        f"Winograd (tensor cores) {db_noise_l6['wino']:.2f} dB, direct "
        f"{db_noise_l6['direct']:.2f} dB (reported, not gated)")
    del noise, ref_noise
    torch.cuda.empty_cache()
    log(f"phase 13 passed in {time.perf_counter() - t13:.1f} s")

    # 14. int8 layer 6 (B4), at equal tile on both sides
    def rms(t: torch.Tensor) -> float:
        return t.double().pow(2).mean().sqrt().item()

    def stacks_unchanged(what: str, call):
        before = (stack.LAUNCHES, dict(stack.KERNEL_LAUNCHES))
        out = call()
        if (stack.LAUNCHES, stack.KERNEL_LAUNCHES) != before:
            raise AssertionError(f"{what} alone moved the stack counts: "
                                 f"{before} -> {stack.LAUNCHES}, "
                                 f"{stack.KERNEL_LAUNCHES}")
        return out

    def i8_layer_check(y32, sps, label, tile, noise, frames_a) -> float:
        """(a): layer 6 alone on the kernel's stored layer-5 plane."""
        worst = 0.0
        for sp, dt in zip(sps, (torch.float32, torch.bfloat16)):
            y = y32[:frames_a].to(dt).contiguous()
            tile_ = tile or stack.default_tile(*(
                (-(-d // 2) for d in y.shape[1:]) if noise else y.shape[1:]))
            # two standalone wrappers: no stack ran, so neither adds to the
            # stack counts (LAUNCHES, KERNEL_LAUNCHES)
            x5 = stacks_unchanged("layer5_plane", lambda: stack.layer5_plane(
                y, sp, tile, full_res=noise))
            # no layer 5 ran here: the maxima of the stored plane, as
            # layer 5's epilogue takes them on the stacks (phase 32)
            m = stack.tile_max_plain(x5, tile_)
            stack.reset_launches()
            x6k, sxk = stacks_unchanged("l6_i8_layer", lambda: (
                stack.l6_i8_layer(x5, sp, tile_, m=m)))
            if stack.I8_LAUNCHES != {"mma": 1, "l5max": 0}:
                raise AssertionError(f"i8 layer 6 {label} {dt}: launches "
                                     f"{stack.I8_LAUNCHES}")
            x6p, sxp = stack.l6_i8_layer_plain(x5, sp, tile_)
            err = (x6k.float() - x6p.float()).abs().max().item()
            log(f"phase 14a i8 layer 6 alone {label} {dt}, tile {tile_}, "
                f"{tuple(sxk.shape)} tiles: max|kernel - plain| = {err:.3e}, "
                f"wgmma == plain bit for bit: {torch.equal(x6k, x6p)}, "
                f"scales equal: {torch.equal(sxk, sxp)}")
            # the int32 sums are exact and the epilogue's f32 steps the
            # same: bit for bit, no allowance
            if not torch.equal(x6k, x6p):
                raise AssertionError(f"i8 layer 6 {label} {dt}: the kernel "
                                     f"and the plain version differ")
            if not torch.equal(sxk, sxp):
                raise AssertionError(f"i8 layer 6 {label} {dt}: the tiles' "
                                     f"scales differ")
            del m
            worst = max(worst, err)
            del x5, x6k, x6p
            torch.cuda.empty_cache()
        return worst

    def i8_stack_check(y32, sps, label, tile, noise) -> float:
        """(b): the whole stack, kernel against plain version."""
        name = "stack_noise" if noise else "stack_scale"
        kernel = getattr(stack, name)
        plain = plain_kw(name + "_plain", l6_i8=True, tile=tile)
        got32 = kernel(y32, sps[0], l6_i8=True, tile=tile)
        ref32 = plain_in_chunks(plain, y32, sps[0], not noise)
        cost = ref32 - plain_in_chunks(plain_kw(name + "_plain", l6_i8=False),
                                       y32, sps[0], not noise)
        diff = got32 - ref32
        err32, share = diff.abs().max().item(), (
            diff.abs() > 1e-5).float().mean().item()
        y16 = y32.to(torch.bfloat16)
        got16 = kernel(y16, sps[1], l6_i8=True, tile=tile).float()
        err16 = (got16 - plain_in_chunks(plain, y16, sps[1], not noise)
                 ).abs().max().item()
        log(f"phase 14b i8 {name} {label}, tile {tile}: f32 kernel - plain "
            f"max {err32:.3e} rms {rms(diff):.3e}, {share:.3%} of outputs "
            f"over 1e-5; int8 - direct (plain) max {cost.abs().max().item():.3e} "
            f"rms {rms(cost):.3e}; bf16 max|kernel - bf16 plain| = "
            f"{err16:.3e}, bf16 kernel vs f32 int8 plain "
            f"{psnr1(got16, ref32):.2f} dB")
        if not (err32 <= I8_TIE_MAX * cost.abs().max().item()
                and rms(diff) <= I8_TIE_RMS * rms(cost)
                and share <= I8_TIE_OUTPUTS):
            raise AssertionError(f"f32 i8 {name} {label}: kernel - plain "
                                 f"too far for quantiser ties")
        check_max_err(f"bf16 i8 {name} {label}", err16, BF16_TOL)
        return max(err32, err16)

    max_err["i8_layer"] = max_err["i8"] = 0.0
    one_tile = torch.rand((1, 16, 16), generator=gen).to(dev)
    for y32, tile in ((l6_cases[0], (8, 16)), (l6_cases[1], (8, 16)),
                      (one_tile, None)):
        for noise in (False, True):
            label = (f"{tuple(y32.shape)} "
                     f"{'noise' if noise else 'scale'} input")
            max_err["i8_layer"] = max(max_err["i8_layer"], i8_layer_check(
                y32, (sp_rand, sp_rand16), label, tile, noise, None))
            max_err["i8"] = max(max_err["i8"], i8_stack_check(
                y32, (sp_rand, sp_rand16), label, tile, noise))
    max_err["i8_layer"] = max(
        max_err["i8_layer"],
        i8_layer_check(ylow, (sp32, sp16), "scale512, frames 0-3", None,
                       False, 4),
        i8_layer_check(yn, (spn32, spn16), "noise256, frames 0-63", None,
                       True, 64))
    max_err["i8"] = max(
        max_err["i8"],
        i8_stack_check(ylow, (sp32, sp16), "scale512", None, False),
        i8_stack_check(yn, (spn32, spn16), "noise256", None, True))
    del l6_cases, one_tile
    torch.cuda.empty_cache()

    # 15. the product paths under each layer-6 switch
    from waifu2x_torch.tools import i8_fidelity_probe, layer_time_probe
    from waifu2x_torch.train.qat import l6_quant_gap_db

    def set_l6(form: str) -> None:
        stack.L6_WINO, stack.L6_I8 = form == "wino", form == "i8"

    def expect_l6(label, form, calls, per_call) -> None:
        want = {k: 0 for k in stack.L6_LAUNCHES}
        want[form] = calls * per_call
        if stack.L6_LAUNCHES != want:
            raise AssertionError(f"{label}: layer-6 launches "
                                 f"{stack.L6_LAUNCHES}, want {want}")
        # bf16 stacks: the Winograd layer 6 on the tensor cores
        wino = {"mma": calls if form == "wino" else 0, "mma_tf32": 0}
        if stack.WINO_LAUNCHES != wino:
            raise AssertionError(f"{label}: Winograd launches by kernel "
                                 f"{stack.WINO_LAUNCHES}, want {wino}")
        # the int8 layer on the int8 tensor cores (csrc/i8.cu) every call,
        # the tile maxima in layer 5's epilogue
        i8 = {"mma": calls if form == "i8" else 0,
              "l5max": calls if form == "i8" else 0}
        if stack.I8_LAUNCHES != i8:
            raise AssertionError(f"{label}: int8 layer launches by kernel "
                                 f"{stack.I8_LAUNCHES}, want {i8}")
        # layer 7 folded, on the Winograd layer 6's plane and on the int8
        # layer 6's tile-major planes alike
        expect_l7(stack, label, bf16=calls)

    ypad = F.pad(yuv[:2, ..., 0][:, None].cpu(), (7,) * 4,
                 mode="replicate")[:, 0, :256, :256, None].contiguous()
    qat_db = l6_quant_gap_db(params, ypad)
    restore_wrappers = record_wrapper_calls(pipeline_mod, seen)
    l6_launches, l6_db, l6_err = {}, {}, {}
    for form in ("wino", "i8"):
        set_l6(form)
        per_stack = 7      # launches per stack call (int8: the maxima in
        per_l6 = 1         # layer 5), of them layer 6's
        hold_bar = I8_BAR if form == "i8" else PSNR_BAR
        l6_err[form] = {}

        def gate(label, db, db_direct, product=False):
            # int8 on the scale512 step and stream: the product bar
            bar = ((PSNR_BAR if product else I8_BAR) if form == "i8"
                   else db_direct - WINO_DB_SLACK)
            log(f"  {label}: frames 0-1 vs f32 non-kernel path {db:.2f} dB "
                f"(direct form {db_direct:.2f} dB; held to {bar:.2f}; the "
                f"product bar is {PSNR_BAR:g})"
                + (f"; QAT proxy of the int8 gap {qat_db:.2f} dB"
                   if form == "i8" else ""))
            if not db >= bar:
                raise AssertionError(f"{label}: {db} dB under {bar}")

        label = f"phase 15 scale512 batch step, layer 6 {form}"
        set_tail("xla", False)
        stack.reset_launches()
        u8 = scale2x_batch_u8_fused(to_yuv_dev(frames), fast)
        out = d2s_host_cmajor(u8.cpu().numpy())
        log(f"{label}: {frames.shape} -> {out.shape}, launches "
            f"{stack.KERNEL_LAUNCHES}, layer 6 {stack.L6_LAUNCHES}")
        if (stack.LAUNCHES != per_stack
                or stack.KERNEL_LAUNCHES["scale"] != per_stack
                or out.shape != (16, 1024, 1024, 3)):
            raise AssertionError(f"{label}: {stack.LAUNCHES} launches, "
                                 f"{out.shape}")
        expect_l6(label, form, 1, per_l6)
        db_step = psnr(out[:2], ref_main)
        gate(label, db_step, db_main, product=True)
        hold_seen(seen, stack, f32_twin, l6_err[form], hold_bar)
        del u8, out

        label = f"phase 15 scale512 stream, W2X_TAIL=kernel, layer 6 {form}"
        set_tail("kernel", False)
        sc = StreamConverter(fast, batch=16, depth=2, device=dev)
        outs, counts, nd = run_stream(sc, frames64, stack, label, smi)
        expect_counts(label, counts, nd, 4, fused_u8=4 * per_stack)
        expect_l6(label, form, 4, per_l6)
        l6_launches[form] = stack.L6_LAUNCHES[form]
        if form == "wino":
            wino_mma_launches = stack.WINO_LAUNCHES["mma"]
        else:
            i8_mma_launches = stack.I8_LAUNCHES["mma"]
            i8_l7_launches = stack.L7_LAUNCHES["fold"]
            i8_l5max_launches = stack.I8_LAUNCHES["l5max"]
        for k in range(0, 64, 16):   # the batch step on the same batch
            ref = d2s_host_cmajor(scale2x_batch_u8_fused(
                to_yuv_dev(frames64[k:k + 16]), fast).cpu().numpy())
            expect_equal(label + " vs the batch step", outs[k:k + 16], ref)
        l6_db[form] = psnr(np.stack(outs[:2]), ref_main)
        log("  in order, equal to the batch step bit for bit")
        gate(label, l6_db[form], stream_db["fused_u8"], product=True)
        hold_seen(seen, stack, f32_twin, l6_err[form], hold_bar)
        set_tail("xla", False)
        del outs, ref

        label = f"phase 15 noise256 batch step, layer 6 {form}"
        stack.reset_launches()
        u8 = noise_batch_u8_fused(yuv_n, fast_n1)
        out = d2s_host_cmajor(u8.cpu().numpy())
        log(f"{label}: {frames_n.shape} -> {out.shape}, launches "
            f"{stack.KERNEL_LAUNCHES}, layer 6 {stack.L6_LAUNCHES}")
        if (stack.KERNEL_LAUNCHES["noise"] != per_stack
                or stack.LAUNCHES != per_stack
                or out.shape != frames_n.shape):
            raise AssertionError(f"{label}: {stack.LAUNCHES} launches, "
                                 f"{out.shape}")
        expect_l6(label, form, 1, per_l6)
        gate(label, psnr(out[:2], ref_n256), db_n256)
        hold_seen(seen, stack, f32_twin, l6_err[form], hold_bar)
        del u8, out
        torch.cuda.empty_cache()
    # the ns1080 chain with its f32 noise stack (the default noise_scale
    # surface) under W2X_L6_WINO: layer 6 of the f32 noise stack on the
    # 3xTF32 Winograd kernel, of the bf16 scale stack on the bf16 one
    label = "phase 15 ns1080 chain, f32 noise / bf16 scale, layer 6 wino"
    set_l6("wino")
    stack.reset_launches()
    u8 = chain(fast_n2[torch.float32])
    if stack.WINO_LAUNCHES != {"mma": 1, "mma_tf32": 1}:
        raise AssertionError(f"{label}: Winograd launches "
                             f"{stack.WINO_LAUNCHES}")
    expect_l7(stack, label, bf16=1, f32=1)
    wino_tf32_launches = stack.WINO_LAUNCHES["mma_tf32"]
    out = d2s_host_cmajor(u8.cpu().numpy())
    db_wino_chain = min(psnr(out[i], ref_chain[i]) for i in range(len(out)))
    log(f"{label}: launches {stack.KERNEL_LAUNCHES}, Winograd by kernel "
        f"{stack.WINO_LAUNCHES}; frames 0-3 vs the f32 non-kernel chain "
        f"{db_wino_chain:.2f} dB (direct {db_chain[torch.float32]:.2f} dB)")
    if not db_wino_chain >= db_chain[torch.float32] - WINO_DB_SLACK:
        raise AssertionError(f"{label}: {db_wino_chain} dB")
    hold_seen(seen, stack, f32_twin, l6_err["wino"])
    del u8, out
    set_l6("direct")
    restore_wrappers()

    # the two entry points that drive B7 and B4 directly
    log("phase 15 tools.layer_time_probe (the upto ladder at the scale512 "
        "shape):")
    stack.reset_launches()
    if layer_time_probe.main([]) != 0:
        raise AssertionError("layer_time_probe failed")
    upto_launches = stack.L6_LAUNCHES["upto"]
    # upto 0..6, each once to warm up and --iters (3) times; of them upto
    # 0..5 on the tiled gather
    gather_launches = stack.GATHER_LAUNCHES["tiled"]
    if (upto_launches != 7 * 4 or stack.L6_LAUNCHES["direct"] != 2 * 4 + 4
            or stack.GATHER_LAUNCHES != {"tiled": 6 * 4}):
        raise AssertionError(f"layer_time_probe: layer-6 launches "
                             f"{stack.L6_LAUNCHES}, gathers "
                             f"{stack.GATHER_LAUNCHES}")
    # layer 7 on the fold only: upto 6's taps 4 times (OUT_TAPS), the whole
    # stack 8 (a warm-up, 3 with events, a warm-up and 3 timed)
    taps_launches = {"cell": stack.TAP_LAUNCHES["taps"]}
    if stack.L7_LAUNCHES != {"fold": 4 + 8, "fold_f32": 0} or (
            stack.TAP_LAUNCHES != {"taps": 4, "ptaps": 0}):
        raise AssertionError(f"layer_time_probe: layer-7 launches "
                             f"{stack.L7_LAUNCHES}, taps "
                             f"{stack.TAP_LAUNCHES}")
    log(f"phase 15 layer_time_probe layer-7 launches {stack.L7_LAUNCHES} "
        f"({taps_launches['cell']} of them upto 6's taps on the fold, as "
        f"TAP_LAUNCHES counted them)")
    log("phase 15 tools.i8_fidelity_probe:")
    stack.reset_launches()
    if (i8_fidelity_probe.main(["--iters", "2"]) != 0
            or not stack.L6_LAUNCHES["i8"] or stack.L6_I8):
        raise AssertionError(f"i8_fidelity_probe: {stack.L6_LAUNCHES}")
    torch.cuda.empty_cache()
    log(f"phases 12-15 passed; {time.perf_counter() - t_start:.1f} s so far")

    # 16. the probe of the tensor-core inner loop
    from waifu2x_torch.tools import mma_probe
    log("phase 16 tools.mma_probe:")
    stack.reset_launches()
    if mma_probe.main(["--iters", "2"]) != 0:
        raise AssertionError("mma_probe failed")
    chain_launches = stack.MID_LAUNCHES["chain"]
    # one to compare, a warm-up and --iters timed
    if chain_launches != 4 or stack.LAUNCHES:
        raise AssertionError(f"mma_probe: launches {stack.MID_LAUNCHES}, "
                             f"{stack.LAUNCHES}")
    chain_r = mma_probe.run(256 * 132 * 8, 64, 5, 0, dev)
    if not chain_r["ok"]:
        raise AssertionError(f"mma_chain: max |diff| "
                             f"{chain_r['max_abs_err']}")
    torch.cuda.empty_cache()

    # 17. the tensor-core kernel of layers 2-6 against its plain version
    def mma_hold(x, sp, k, label, time_plain=False):
        """Layer k on x against the plain version -> (the kernel's output,
        max |diff|, plain ms or None)."""
        ci, co = stack.WIDTHS[k - 1]
        t0 = time.perf_counter()
        ref = mma_plain_in_chunks(stack, x, sp.wm[k - 2], sp[k - 1][1])
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 if time_plain else None
        stack.reset_launches()
        got = stack.mma_layer(x, sp, k)
        torch.cuda.synchronize()
        if (stack.MID_LAUNCHES != {"mma": 1, "chain": 0,
                                   "mma_zs": 0, "mma_pp": 0, "mma_tf32": 0,
                                   "mma_resident": int(k < 6),
                                   "mma_split": int(k == 6),
                                   "mma_tile": 0}
                or stack.LAUNCHES or any(stack.KERNEL_LAUNCHES.values())):
            raise AssertionError(f"mma_layer alone: launches "
                                 f"{stack.MID_LAUNCHES}, {stack.LAUNCHES}")
        err, share = check_mma_layer(f"mma layer {k} {label}", got, ref)
        log(f"phase 17 mma layer {k} ({ci} -> {co}) {label}, largest output "
            f"{ref.float().abs().max().item():.3f}: max|kernel - plain| "
            f"{err:.3e}, {share:.4%} differ")
        return got, err, plain_ms

    max_err["mma"] = 0.0
    dev_gen = torch.Generator(device=dev).manual_seed(0)
    for shape in [(1, 27, 38), (2, 37, 53), (1, 5, 300)]:
        for k in range(2, 7):
            x = torch.randn((*shape, stack.WIDTHS[k - 1][0]),
                            generator=gen).to(dev, torch.bfloat16)
            _, err, _ = mma_hold(x, sp_rand16, k, f"{shape}")
            max_err["mma"] = max(max_err["mma"], err)
    mma_plain_ms = 0.0
    for label, sp, (nb, hb) in (("scale512", sp16, (16, 512)),
                                ("noise256", spn16, (256, 128))):
        side = 2 * hb + 12       # layer 1's output plane, layer 2's input
        x = torch.rand((nb, side, side, 32), device=dev,
                       generator=dev_gen).to(torch.bfloat16)
        for k in range(2, 7):    # each layer fed the kernel's output
            x, err, ms = mma_hold(x, sp, k, f"{label} {tuple(x.shape)}",
                                  label == "scale512")
            max_err["mma"] = max(max_err["mma"], err)
            mma_plain_ms += ms or 0.0
            torch.cuda.empty_cache()
        del x
    torch.cuda.empty_cache()

    # the whole scale512 stack and main path against the f32 ones
    ref32 = stack.stack_scale_plain(ylow, sp32)
    stack.reset_launches()
    mid_y = stack.stack_scale(ylow16, sp16)
    want = {"mma": 5, "chain": 0, "mma_zs": 0, "mma_pp": 0, "mma_tf32": 0,
            "mma_resident": 4, "mma_split": 1, "mma_tile": 0}
    if stack.MID_LAUNCHES != want or stack.LAUNCHES != 7:
        raise AssertionError(f"scale512 stack: launches "
                             f"{stack.MID_LAUNCHES} of {stack.LAUNCHES}")
    mid_db = psnr1(mid_y.float(), ref32)
    u8 = scale2x_batch_u8_fused(to_yuv_dev(frames[:2]), fast)
    mid_main_db = psnr(d2s_host_cmajor(u8.cpu().numpy()), ref_main)
    log(f"phase 17 scale512 stack, bf16, layers 2-6 on the tensor cores: "
        f"{mid_db:.2f} dB vs f32 plain; main path frames 0-1 vs f32 "
        f"non-kernel path {mid_main_db:.2f} dB")
    if not min(mid_db, mid_main_db) >= PSNR_BAR:
        raise AssertionError(f"scale512 stack: {mid_db}, {mid_main_db} dB")
    del ref32, mid_y, u8
    torch.cuda.empty_cache()

    # per-layer ms, two runs
    mid_ms = {}
    for shape_name, y16, spx, wrapper in (
            ("scale512", ylow16, sp16, stack.stack_scale),
            ("noise256", yn16, spn16, stack.stack_noise_s2d)):
        wrapper(y16, spx)      # warm-up
        turns = [per_layer_ms(lambda ev: wrapper(y16, spx, events=ev), stack)
                 for _ in range(2)]
        mid_ms[shape_name] = sum(turns) / 2
        nb, hb, wb = y16.shape
        if wrapper is stack.stack_noise_s2d:
            hb, wb = hb // 2, wb // 2
        bounds = mid_bounds(stack, nb, hb, wb)
        new = mid_ms[shape_name][1:6]
        log(f"timing {shape_name} layers 2-6, bf16, on {smi}: tensor cores "
            f"{new.sum():.2f} ms, bound "
            f"{sum(b[2] for b in bounds):.2f} ms; per layer: " + "; ".join(
                f"L{k + 2} {new[k]:.2f} "
                f"ms = {bounds[k][0] / new[k] / 1e9:.1f} TFLOP/s "
                f"({100 * bounds[k][0] / new[k] / 1e-3 / PEAK_BF16_FLOPS:.1f}"
                f"% of the bf16 peak), {bounds[k][1] / new[k] / 1e6:.0f} GB/s "
                f"({100 * bounds[k][1] / new[k] / 1e-3 / PEAK_BYTES:.1f}% of "
                f"the memory rate), bound {bounds[k][2]:.2f} ms by "
                f"{bounds[k][3]}" for k in range(5))
            + f"; the two runs: {turns[0][1:6].sum():.2f} / "
            f"{turns[1][1:6].sum():.2f} ms")
    mid_bound = mid_bounds(stack, *ylow16.shape)
    mid_library_ms = library_mid_ms(sp16, *ylow16.shape)
    # each layer alone at the scale512 shapes, with its plan
    alone_ms = []
    for k in range(2, 7):
        ci, co = stack.WIDTHS[k - 1]
        side = 2 * 512 + 16 - 2 * k
        x = torch.rand((16, side, side, ci), device=dev,
                       generator=dev_gen).to(torch.bfloat16)
        plan = stack.mma_plan(ci, co)
        ms = timed_ms(lambda: stack.mma_layer(x, sp16, k))
        alone_ms.append(f"L{k} kc {plan.kc} x {plan.stages} "
                        f"({plan.smem_bytes} B) {ms:.2f} ms")
        del x
        torch.cuda.empty_cache()
    log(f"timing scale512 mma_layer alone, on {smi}: " + "; ".join(alone_ms)
        + f"; cuDNN bf16 layers 2-6 {mid_library_ms:.2f} ms; "
        f"mma_layer_plain layers 2-6 (in chunks, host clock) "
        f"{mma_plain_ms:.2f} ms")
    log(f"phases 16-17 passed; {time.perf_counter() - t_start:.1f} s so far")

    # 18. the data-movement probes (csrc/probe.cu): every variant against
    # its plain version at its JAX tool's grid, then the three tools
    from waifu2x_torch.ops import probe
    from waifu2x_torch.tools import dma_probe, grid_floor_probe, stage_time
    probe_err = {k: 0.0 for k in probe.LAUNCHES}
    traffic_checked, ring_routes = [], {}
    for tool, names in probe.TOOL_VARIANTS.items():
        g = probe.Grid(16 if tool in ("stage_time", "grid_floor_probe")
                       else 4, 8, 4)
        for name in names:
            v = probe.VARIANTS[name]
            args = probe.make_inputs(v, g, 0, dev)
            routes_before = dict(probe.MAP_ROUTES)
            got = probe.run(v, g, args, device=dev)
            ref = probe.plain(v, g, args, dev)
            err, share, ok = probe.compare(got, ref)
            log(f"phase 18 {name} ({v.site}, {v.kernel}) {tuple(got.shape)} "
                f"{got.dtype}: max|kernel - plain| = {err:.3g}, "
                f"{share:.5%} of outputs differ (bar: bit-equal"
                f"{', exact sums' if name in probe.SUM_VARIANTS else ''})")
            if not ok:
                raise AssertionError(f"probe {name}: kernel != plain")
            if v.kernel == "fetch_map":   # the route the C entry took
                taken = [k for k, n in probe.MAP_ROUTES.items()
                         if n != routes_before[k]]
                if len(taken) != 1 or (probe.MAP_ROUTES[taken[0]]
                                       != routes_before[taken[0]] + 1):
                    raise AssertionError(f"probe {name}: routes "
                                         f"{probe.MAP_ROUTES}")
                ring_routes[name] = taken[0]
            if probe.library_is_the_map(v):
                # the yardstick computes this map's own function
                lib = probe.library(v, g, args, dev)()
                if lib.numel() != got.numel() or not torch.equal(
                        lib.reshape(got.shape), got):
                    raise AssertionError(f"probe {name}: library output "
                                         f"!= kernel output")
                log(f"  {name}: library's contiguous() == kernel byte for "
                    f"byte")
                del lib
            if v.kernel == "fetch_reduce":
                # the whole-block pass: every word that lands in shared
                # memory, once a cell (a block dropped or read twice shows)
                got_sum = probe.traffic_sum(v, g, args)
                want_sum = probe.traffic_sum_plain(v, g, args["x"])
                log(f"  {name}: traffic sum {got_sum:#010x}, plain "
                    f"{want_sum:#010x}")
                if got_sum != want_sum:
                    raise AssertionError(f"probe {name}: traffic sum "
                                         f"{got_sum:#x} != {want_sum:#x}")
                traffic_checked.append(name)
            probe_err[v.kernel] = max(probe_err[v.kernel], err)
            del args, got, ref
    if traffic_checked != ["cin1", "cin4", "cin9", "4-fetch"]:
        raise AssertionError(f"traffic sums checked for {traffic_checked}")
    # the router sent exactly these seven to the ring form
    if sorted(n for n, r in ring_routes.items() if r == "ring") != sorted(
            MAP_RING):
        raise AssertionError(f"probe_fetch_map routes {ring_routes}")
    log(f"phase 18 probe_fetch_map routes, as the C entry reported them: "
        f"{ring_routes}")
    # the ring form's wide geometry, bit-equal to the plain version
    for name, shape in MAP_WIDE:
        v, g = probe.VARIANTS[name], probe.Grid(*shape)
        args = probe.make_inputs(v, g, 1, dev)
        ring_before = probe.MAP_ROUTES["ring"]
        got = probe.run(v, g, args, device=dev)
        err, share, ok = probe.compare(got, probe.plain(v, g, args, dev))
        log(f"phase 18 {name} at grid {shape} (the ring form's wide "
            f"geometry) {tuple(got.shape)}: max|kernel - plain| = {err:.3g}, "
            f"{share:.5%} differ (bar: bit-equal)")
        if not ok or probe.MAP_ROUTES["ring"] != ring_before + 1:
            raise AssertionError(f"probe {name} wide: kernel != plain or "
                                 f"routes {probe.MAP_ROUTES}")
        probe_err["fetch_map"] = max(probe_err["fetch_map"], err)
        del args, got
    torch.cuda.empty_cache()
    # the slice's main path: the three tools, counted
    probe.reset_launches()
    probe_rows = []
    for tool, argv in ((stage_time, []), (grid_floor_probe, []),
                       (dma_probe, [])):
        if tool.main(argv, probe_rows) != 0:
            raise AssertionError(f"{tool.__name__} failed")
    probe_launches = dict(probe.LAUNCHES)
    # per variant: the check, then a warm-up and the 100 timed launches
    # twice, once captured into the graph and once issued one by one (the
    # graph's replays run the captured launches and add no count)
    per_kernel = {k: sum(r["kernel"] == k for r in probe_rows)
                  for k in probe_launches}
    if probe_launches != {k: 203 * n for k, n in per_kernel.items()}:
        raise AssertionError(f"probe launches {probe_launches}, variants "
                             f"{per_kernel}")
    fast_rows = [r["name"] for r in probe_rows if not r["rate_ok"]]
    if fast_rows:   # over the memory rate: a fetch was dropped
        raise AssertionError(f"probes over {PEAK_BYTES / 1e12} TB/s: "
                             f"{fast_rows}")
    # the store kernel beside fill_ of the same output (reported, not gated)
    log(f"phase 18 probe_store against fill_, on {smi}: " + "; ".join(
        f"{r['name']} {r['ms']:.4f} / {r['library_ms']:.4f} ms = "
        f"{r['ms'] / r['library_ms']:.2f}x (bound {r['bound_ms']:.4f})"
        for r in probe_rows if r["kernel"] == "store"))
    log(f"phase 18 probe_fetch_map against contiguous() of the view, on "
        f"{smi}: " + "; ".join(
            f"{r['name']} {r['ms']:.4f} / {r['library_ms']:.4f} ms = "
            f"{r['ms'] / r['library_ms']:.2f}x (bound {r['bound_ms']:.4f}"
            + ("" if probe.library_is_the_map(probe.VARIANTS[r['name']])
               else "; the library copies, the map does more")
            + ")" for r in probe_rows if r["kernel"] == "fetch_map"))
    # the three redesigned kernels: each variant's share of its bound,
    # beside the library call and the first form's time (the ring form's
    # aim: within twice the bound)
    for kernel, what in (("fetch_reduce", "amax / sum over a view"),
                         ("l1_mm", "bf16 matmul, weight lanes 0-3"),
                         ("fetch_map", "contiguous() of the view")):
        parts = [f"{r['name']} {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                 f"({100 * r['bound_ms'] / r['ms']:.1f}% of it"
                 + (f"; aim {2 * r['bound_ms']:.4f} "
                    f"{'met' if r['ms'] <= 2 * r['bound_ms'] else 'missed'}"
                    if kernel == "fetch_map" else "")
                 + f"), library {r['library_ms']:.4f} ({what}), first form "
                 f"{PROBE_FIRST_FORM_MS[r['name']]:.4f}"
                 for r in probe_rows if r["kernel"] == kernel
                 and (kernel != "fetch_map" or r["name"] in MAP_RING)]
        log(f"phase 18 probe_{kernel}"
            + (" (ring form)" if kernel == "fetch_map" else "")
            + f" against its bound, on {smi}: " + "; ".join(parts))
    torch.cuda.empty_cache()
    log(f"phase 18 passed; {time.perf_counter() - t_start:.1f} s so far")

    t19 = time.perf_counter()
    kernels19 = phase19(dev, sp16, taps_launches)
    torch.cuda.empty_cache()
    log(f"phase 19 passed in {time.perf_counter() - t19:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    t20 = time.perf_counter()
    kernels19 += phase20(dev)
    torch.cuda.empty_cache()
    log(f"phase 20 passed in {time.perf_counter() - t20:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    t21 = time.perf_counter()
    kernels19 += phase21(dev, l7_main)
    torch.cuda.empty_cache()
    log(f"phase 21 passed in {time.perf_counter() - t21:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    t22 = time.perf_counter()
    kernels19 += phase22(dev, tf32_main)
    log(f"phase 22 passed in {time.perf_counter() - t22:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    t23 = time.perf_counter()
    kernels19 += phase23(dev, l1_main)
    log(f"phase 23 passed in {time.perf_counter() - t23:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    t24 = time.perf_counter()
    kernels19 += phase24(dev, l7_f32_main)
    log(f"phase 24 passed in {time.perf_counter() - t24:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    t25 = time.perf_counter()
    kernels19 += phase25(dev, i8_mma_launches)
    log(f"phase 25 passed in {time.perf_counter() - t25:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s so far")
    t26 = time.perf_counter()
    kernels19 += phase26(dev, i8_l7_launches)
    log(f"phase 26 passed in {time.perf_counter() - t26:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s so far")

    def f32_noise_step(l6_wino: bool):
        """The ns1080 f32-noise step with the noise stack's layer 6 as
        Winograd or direct (the bf16 scale stack direct)."""
        stack.L6_WINO = l6_wino
        y = noise_y_batch_fast(yuv_c[..., 0], fast_n2[torch.float32],
                               out_dtype=None)
        stack.L6_WINO = False
        return scale2x_batch_u8_fused(yuv_c, fast, y=y)

    t27 = time.perf_counter()
    kernels19 += phase27(dev, wino_tf32_launches, f32_noise_step)
    log(f"phase 27 passed in {time.perf_counter() - t27:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s so far")

    def i8_step():
        """The scale512 batch step under l6_i8 -> (u8 frames, frames 0-1
        against the f32 path in dB)."""
        set_l6("i8")
        try:
            out = d2s_host_cmajor(scale2x_batch_u8_fused(
                to_yuv_dev(frames), fast).cpu().numpy())
        finally:
            set_l6("direct")
        return out, psnr(out[:2], ref_main)

    kernels19 += phase32(dev, smi, (sp32, sp16), ylow16, i8_step,
                         {"gather": gather_launches,
                          "l5max": i8_l5max_launches})
    torch.cuda.empty_cache()
    mma_turns = phase33(dev, smi)
    torch.cuda.empty_cache()
    phase34(dev, smi)
    torch.cuda.empty_cache()
    kernels19.append(phase35(dev, smi))
    torch.cuda.empty_cache()
    log(f"{time.perf_counter() - t_start:.1f} s so far")
    cli_launches = phase28(dev, smi)
    log(f"{time.perf_counter() - t_start:.1f} s so far")
    mesh_totals = phase29(dev, smi)
    torch.cuda.empty_cache()
    log(f"{time.perf_counter() - t_start:.1f} s so far")
    trained = phase30(dev, smi, frames)
    torch.cuda.empty_cache()
    tools31 = phase31(dev, smi)
    torch.cuda.empty_cache()
    log(f"{time.perf_counter() - t_start:.1f} s so far")

    maccs = count_maccs_per_pixel()

    # timings, scale512 (CUDA events, after a warm-up)
    yuv16 = _to_yuv(torch.from_numpy(frames).to(dev))
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(lambda: scale2x_batch_u8_fused(yuv16, fast))
    set_tail("xla", True)
    d_step_ms = timed_ms(lambda: scale2x_batch_u8_fused(yuv16, fast))
    set_tail("kernel", False)
    u_step_ms = timed_ms(lambda: scale2x_batch_u8_fused(yuv16, fast))
    set_tail("xla", False)
    uvp16 = _uv_phases_cmajor(yuv16)
    kernel_ms = timed_ms(lambda: stack.stack_scale(ylow16, sp16))
    d_kernel_ms = timed_ms(lambda: stack.stack_scale_dense(ylow16, sp16))
    u_kernel_ms = timed_ms(
        lambda: stack.stack_scale_fused_u8(ylow16, uvp16, sp16))
    per_layer = per_layer_ms(
        lambda ev: stack.stack_scale(ylow16, sp16, events=ev), stack)
    d_per_layer = per_layer_ms(
        lambda ev: stack.stack_scale_dense(ylow16, sp16, events=ev), stack)
    u_per_layer = per_layer_ms(
        lambda ev: stack.stack_scale_fused_u8(ylow16, uvp16, sp16, events=ev),
        stack)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the PyTorch pieces around the kernel in each tail
    y_s2d16 = stack.stack_scale(ylow16, sp16)
    ydense16, tc16 = stack.stack_scale_dense(ylow16, sp16)
    tail_ms = timed_ms(lambda: _tail_u8_cmajor(y_s2d16, yuv16))
    unchunk_ms = timed_ms(lambda: stack.dense_to_s2d(
        ydense16, tc16, *ylow16.shape[1:]).contiguous())
    uvp_ms = timed_ms(lambda: _uv_phases_cmajor(yuv16))
    d_io_bytes = ylow16.numel() * 2 + ydense16.numel() * 2
    del y_s2d16, ydense16
    plain_ms = timed_ms(lambda: stack.stack_scale_plain(ylow16, sp16))
    d_plain_ms = timed_ms(
        lambda: stack.stack_scale_dense_plain(ylow16, sp16), reps=2)
    u_plain_ms = timed_ms(
        lambda: stack.stack_scale_fused_u8_plain(ylow16, uvp16, sp16), reps=2)
    torch.cuda.empty_cache()
    xpad16 = F.pad(
        ylow16.repeat_interleave(2, 1).repeat_interleave(2, 2)[:, None],
        (7,) * 4, mode="replicate")[:, 0]
    library_ms = library_stack_ms(xpad16, sp16)
    # one library call sequence for the same function as each new form:
    # the cuDNN bf16 stack, then the chunking / the PyTorch u8 tail
    d_library_ms = library_stack_ms(xpad16, sp16, post=lambda y: (
        stack.s2d_to_dense(s2d(y[..., None]), tc16)))
    u_library_ms = library_stack_ms(xpad16, sp16, post=lambda y: (
        _tail_u8_cmajor(s2d(y[..., None]), yuv16)))
    del xpad16

    n, hl, wl = ylow16.shape
    out_px = n * 4 * hl * wl
    bound_ms, bound_by, flops = stack_bound(ylow16, out_px, sp16, maccs)
    log(f"timing scale512 {n} x {hl}x{wl} -> {2 * hl}x{2 * wl} bf16 on "
        f"{smi}: step {step_ms:.2f} ms = {out_px / step_ms / 1e3:.2f} MP/s; "
        f"kernel {kernel_ms:.2f} ms "
        f"({flops / kernel_ms / 1e9:.2f} TFLOP/s, bound {bound_ms:.2f} ms = "
        f"{100 * bound_ms / kernel_ms:.2f}% of roofline; FFMA floor "
        f"{flops / PEAK_F32_FLOPS * 1e3:.2f} ms); plain {plain_ms:.2f} ms; "
        f"cuDNN bf16 library {library_ms:.2f} ms; "
        f"peak memory {peak_gb:.2f} GB")
    report, act_bytes = layer_rates(per_layer, stack, n, hl, wl, hl * wl)
    log("  per layer: " + report)
    d_bound_ms, d_bound_by, _ = stack_bound(ylow16, out_px, sp16, maccs,
                                            d_io_bytes)
    u_bound_ms, u_bound_by, _ = stack_bound(
        ylow16, out_px, sp16, maccs,
        ylow16.numel() * 2 + uvp16.numel() * 4 + n * hl * wl * 16)
    log(f"timing scale512 tails, bf16, on {smi}: last layer s2d (B1) "
        f"{per_layer[6]:.2f} ms, dense (B6) {d_per_layer[6]:.2f} ms, u8 (B3) "
        f"{u_per_layer[6]:.2f} ms; whole stack s2d {kernel_ms:.2f} ms, dense "
        f"{d_kernel_ms:.2f} ms (bound {d_bound_ms:.2f} ms by {d_bound_by}), "
        f"u8 {u_kernel_ms:.2f} ms (bound {u_bound_ms:.2f} ms by "
        f"{u_bound_by}); step W2X_TAIL=xla {step_ms:.2f} ms, "
        f"W2X_YDENSE=1 {d_step_ms:.2f} ms, W2X_TAIL=kernel "
        f"{u_step_ms:.2f} ms = {out_px / u_step_ms / 1e3:.2f} MP/s; PyTorch "
        f"pieces: u8 tail {tail_ms:.2f} ms, un-chunk {unchunk_ms:.2f} ms, "
        f"uvp build {uvp_ms:.2f} ms; plain dense {d_plain_ms:.2f} ms, u8 "
        f"{u_plain_ms:.2f} ms; cuDNN bf16 library + chunking "
        f"{d_library_ms:.2f} ms, + PyTorch u8 tail {u_library_ms:.2f} ms")
    del uvp16
    log(f"  activation traffic {act_bytes / 1e9:.2f} GB per batch = "
        f"{act_bytes / PEAK_BYTES * 1e3:.2f} ms at {PEAK_BYTES / 1e12} TB/s")
    del yuv16
    torch.cuda.empty_cache()

    # timings, noise256
    torch.cuda.reset_peak_memory_stats()
    n_step_ms = timed_ms(lambda: noise_batch_u8_fused(yuv_n, fast_n1))
    n_kernel_ms = timed_ms(lambda: stack.stack_noise_s2d(yn16, spn16))
    n_per_layer = per_layer_ms(
        lambda ev: stack.stack_noise_s2d(yn16, spn16, events=ev), stack)
    n_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_plain_ms = timed_ms(lambda: stack.stack_noise_s2d_plain(yn16, spn16))
    torch.cuda.empty_cache()
    n_library_ms = library_stack_ms(
        F.pad(yn16[:, None], (7,) * 4, mode="replicate")[:, 0], spn16)
    nn_, hn, wn = yn16.shape
    n_px = nn_ * hn * wn
    n_bound_ms, n_bound_by, n_flops = stack_bound(yn16, n_px, spn16, maccs)
    log(f"timing noise256 {nn_} x {hn}x{wn} bf16 on {smi}: step "
        f"{n_step_ms:.2f} ms = {n_px / n_step_ms / 1e3:.2f} MP/s; kernel "
        f"{n_kernel_ms:.2f} ms ({n_flops / n_kernel_ms / 1e9:.2f} TFLOP/s, "
        f"bound {n_bound_ms:.2f} ms = "
        f"{100 * n_bound_ms / n_kernel_ms:.2f}% of roofline; FFMA floor "
        f"{n_flops / PEAK_F32_FLOPS * 1e3:.2f} ms); plain {n_plain_ms:.2f} "
        f"ms; cuDNN bf16 library {n_library_ms:.2f} ms; peak memory "
        f"{n_peak_gb:.2f} GB")
    report, _ = layer_rates(n_per_layer, stack, nn_, hn // 2, wn // 2,
                            hn * wn)
    log("  per layer: " + report)
    del yuv_n, yn, yn16
    torch.cuda.empty_cache()

    # timings, ns1080 (the bf16 throughput chain and the Converter's f32
    # noise policy), with each stack's kernel alone at its shape
    yc = yuv_c[..., 0].contiguous()
    yc16 = yc.to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    c_step = {dt: timed_ms(lambda dt=dt: chain(fast_n2[dt]))
              for dt in (torch.bfloat16, torch.float32)}
    c_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the f32-noise step and stack as the product runs them, twice each,
    # with the noise stack's per-layer events
    def chain_f32():
        y = noise_y_batch_fast(yuv_c[..., 0], fast_n2[torch.float32],
                               out_dtype=None)
        return scale2x_batch_u8_fused(yuv_c, fast, y=y)

    c_turns = [(timed_ms(chain_f32), timed_ms(lambda: stack.stack_noise(
        yc, fast_n2[torch.float32].sp))) for _ in range(2)]
    l7_chain = {"step": sum(t[0] for t in c_turns) / 2,
                "stack": sum(t[1] for t in c_turns) / 2,
                "layers": per_layer_ms(lambda ev: stack.stack_noise(
                    yc, fast_n2[torch.float32].sp, events=ev), stack)}
    yc_by_dtype = {torch.bfloat16: yc16, torch.float32: yc}
    c_noise_ms = {dt: timed_ms(lambda dt=dt: stack.stack_noise(
        yc_by_dtype[dt], fast_n2[dt].sp)) for dt in yc_by_dtype}
    c_scale_ms = timed_ms(lambda: stack.stack_scale(yc16, sp16))
    c_per_layer = per_layer_ms(
        lambda ev: stack.stack_noise(yc16, fast_n2[torch.bfloat16].sp,
                                     events=ev), stack)
    c_plain_ms = timed_ms(lambda: stack.stack_noise_plain(
        yc16, fast_n2[torch.bfloat16].sp))
    torch.cuda.empty_cache()
    nc, hc, wc = yc.shape
    c_out_px = nc * 4 * hc * wc
    c_bound = (2 * maccs * nc * hc * wc / PEAK_BF16_FLOPS * 1e3,
               2 * maccs * c_out_px / PEAK_BF16_FLOPS * 1e3)
    log(f"timing ns1080 {nc} x {hc}x{wc} -> {2 * hc}x{2 * wc} on {smi}: "
        f"step bf16/bf16 {c_step[torch.bfloat16]:.2f} ms = "
        f"{c_out_px / c_step[torch.bfloat16] / 1e3:.2f} MP/s; step "
        f"f32/bf16 {c_step[torch.float32]:.2f} ms = "
        f"{c_out_px / c_step[torch.float32] / 1e3:.2f} MP/s; noise kernel "
        f"bf16 {c_noise_ms[torch.bfloat16]:.2f} ms, f32 "
        f"{c_noise_ms[torch.float32]:.2f} ms (bound {c_bound[0]:.2f} ms); "
        f"scale kernel bf16 {c_scale_ms:.2f} ms (bound {c_bound[1]:.2f} ms); "
        f"noise plain bf16 {c_plain_ms:.2f} ms; peak memory "
        f"{c_peak_gb:.2f} GB")
    report, _ = layer_rates(c_per_layer, stack, nc, hc // 2, wc // 2,
                            hc * wc)
    log("  noise per layer (bf16): " + report)
    log(f"timing ns1080 f32-noise step and f32 noise stack (layers 2-6 "
        f"3xTF32, layer 7 folded), on {smi}: step {l7_chain['step']:.2f} ms "
        f"(runs " + " / ".join(f"{t[0]:.2f}" for t in c_turns)
        + f"), noise stack {l7_chain['stack']:.2f} ms (runs "
        + " / ".join(f"{t[1]:.2f}" for t in c_turns) + "); per layer "
        + ", ".join(f"L{k + 1} {v:.2f}"
                    for k, v in enumerate(l7_chain["layers"])) + " ms")

    # timings, layer 6's three forms at scale512 in bf16, beside B1's
    yuv16 = _to_yuv(torch.from_numpy(frames).to(dev))
    l6_t = {}
    for form, kw in (("direct", {}), ("wino", {"l6_wino": True}),
                     ("i8", {"l6_i8": True})):
        set_l6(form)
        l6_t[form] = {
            "stack": timed_ms(lambda: stack.stack_scale(ylow16, sp16, **kw)),
            "layers": per_layer_ms(lambda ev: stack.stack_scale(
                ylow16, sp16, events=ev, **kw), stack),
            "step": timed_ms(lambda: scale2x_batch_u8_fused(yuv16, fast)),
        }
        if form != "direct":
            # a few frames at a time: the Winograd plain version keeps
            # more f32 planes alive than the card holds for 16 frames
            l6_t[form]["plain"] = timed_ms(lambda: plain_in_chunks(
                plain_kw("stack_scale_plain", **kw), ylow16, sp16, True),
                reps=1)
            torch.cuda.empty_cache()
    set_l6("direct")
    del yuv16
    maccs_l6 = 128 * 128 * 9
    ops_ms = {   # every layer but 6 at the bf16 peak, layer 6 in its form
        "wino": 2 * out_px * (maccs - maccs_l6 + maccs_l6 * 16 // 36)
        / PEAK_BF16_FLOPS * 1e3,
        "i8": 2 * out_px * ((maccs - maccs_l6) / PEAK_BF16_FLOPS
                            + maccs_l6 / PEAK_INT8_OPS) * 1e3,
    }
    io_ms = (ylow16.numel() * 2 + out_px * 2) / PEAK_BYTES * 1e3
    log(f"timing scale512 layer-6 forms, bf16, on {smi}: "
        + "; ".join(
            f"{form}: stack {t['stack']:.2f} ms, layer 6 "
            f"{t['layers'][5]:.2f} ms, layer 7 {t['layers'][6]:.2f} ms, step "
            f"{t['step']:.2f} ms = {out_px / t['step'] / 1e3:.2f} MP/s"
            + (f", plain (in chunks) {t['plain']:.2f} ms, bound "
               f"{ops_ms[form]:.2f} ms by "
               f"operations (bytes {io_ms:.2f} ms)" if form in ops_ms else "")
            for form, t in l6_t.items())
        + f"; int8 default tile {stack.default_tile(hl, wl)}")

    # layer 6 alone at the scale512 shape, bf16: the tensor-core Winograd
    # kernel, twice, beside the direct tensor-core layer and cuDNN's layer
    # 6 on the same x5
    t_l6 = time.perf_counter()
    x5 = torch.rand((n, 2 * hl + 4, 2 * wl + 4, 128), device=dev,
                    generator=dev_gen).to(torch.bfloat16)
    wino_turns = [timed_ms(lambda: stack.wino_layer(x5, sp16))
                  for _ in range(2)]
    l6_alone = {"mma": sum(wino_turns) / 2}
    l6_alone["direct"] = timed_ms(lambda: stack.mma_layer(x5, sp16, 6))
    l6_alone["cudnn"] = library_l6_ms(x5, sp16)
    t0 = time.perf_counter()
    for i in range(0, n, 2):
        stack.wino_layer_plain(x5[i:i + 2], sp16.w6m, sp16[5][1])
    torch.cuda.synchronize()
    l6_alone["plain"] = (time.perf_counter() - t0) * 1e3
    del x5
    torch.cuda.empty_cache()
    wblocks = n * (hl + 1) * (wl + 1)   # 2 x 2 output blocks of layer 6
    l6_flops = {  # per 2 x 2 block: the function's products as Winograd
        # F(2x2, 3x3) (16) and as the direct form (36); the tensor-core
        # kernel computes 24, its own register-budget choice
        "wino16": 2 * wblocks * 16 * 128 * 128,
        "mma": 2 * wblocks * 24 * 128 * 128,
        "direct": 2 * wblocks * 4 * 9 * 128 * 128}
    l6_bytes = 2 * 128 * (n * (2 * hl + 4) * (2 * wl + 4)
                          + 4 * wblocks) + 2 * 16 * 128 * 128 + 4 * 128
    l6_bound = {k: max(f / PEAK_BF16_FLOPS, l6_bytes / PEAK_BYTES) * 1e3
                for k, f in l6_flops.items() if k != "mma"}
    l6_bound_by = {k: "operations" if l6_flops[k] / PEAK_BF16_FLOPS
                   >= l6_bytes / PEAK_BYTES else "bytes" for k in l6_bound}
    log(f"timing scale512 layer 6 alone, bf16, x5 "
        f"{(n, 2 * hl + 4, 2 * wl + 4, 128)}, on {smi}: Winograd tensor "
        f"cores {l6_alone['mma']:.3f} ms (runs "
        + " / ".join(f"{v:.3f}" for v in wino_turns)
        + f"; {l6_flops['mma'] / l6_alone['mma'] / 1e9:.1f} TFLOP/s of its "
        f"24 products a block = "
        f"{100 * l6_flops['mma'] / l6_alone['mma'] / 1e-3 / PEAK_BF16_FLOPS:.1f}"
        f"% of the bf16 peak, {l6_bytes / l6_alone['mma'] / 1e6:.0f} GB/s; "
        f"bound {l6_bound['wino16']:.2f} ms by {l6_bound_by['wino16']}: "
        f"the function's 16 products "
        f"{l6_flops['wino16'] / PEAK_BF16_FLOPS * 1e3:.2f} ms, bytes "
        f"{l6_bytes / PEAK_BYTES * 1e3:.2f} ms; the kernel's own 24 "
        f"products would take {l6_flops['mma'] / PEAK_BF16_FLOPS * 1e3:.2f}"
        f" ms); direct "
        f"tensor-core layer 6 {l6_alone['direct']:.3f} ms (bound "
        f"{l6_bound['direct']:.2f} ms); cuDNN bf16 layer 6 "
        f"{l6_alone['cudnn']:.3f} ms; plain versions (in chunks, host "
        f"clock) wino_layer_plain {l6_alone['plain']:.1f} ms; the "
        f"tensor-core Winograd "
        f"{'beats' if l6_alone['mma'] < l6_alone['cudnn'] else 'loses to'} "
        f"cuDNN's layer 6 and "
        f"{'beats' if l6_alone['mma'] < l6_alone['direct'] else 'loses to'} "
        f"the direct wgmma layer 6")
    log(f"timing layer 6 alone took {time.perf_counter() - t_l6:.1f} s")

    # timings, the truncated stack (B7) at upto = 6 and its own launches
    u6_ms = timed_ms(lambda: stack.stack_scale_upto(ylow16, sp16, 6))
    u6_plain_ms = timed_ms(lambda: plain_in_chunks(
        lambda x, sp: stack.stack_scale_upto_plain(x, sp, 6), ylow16, sp16,
        True), reps=1)
    torch.cuda.empty_cache()
    own = {}
    for k in (0, 5, 6):   # the last event pair brackets B7's own launch
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(k + 2)]
        stack.stack_scale_upto(ylow16, sp16, k)   # the allocator's warm-up
        stack.stack_scale_upto(ylow16, sp16, k, events=ev)
        torch.cuda.synchronize()
        own[k] = ev[k].elapsed_time(ev[k + 1])
    # the library's form: the cuDNN chain of layers 1-6, then the taps as
    # one stride-2 convolution
    taps16 = tap_kernel(sp16[6][0])
    xpad16 = F.pad(
        ylow16.repeat_interleave(2, 1).repeat_interleave(2, 2)[:, None],
        (7,) * 4, mode="replicate")[:, 0]
    u6_library_ms = library_stack_ms(xpad16, sp16, upto=6, post=lambda h: (
        F.conv2d(h, taps16, stride=2)))
    del xpad16, taps16
    torch.cuda.empty_cache()
    # layers 1-6 and the 9 same-cell taps of 128 channels per s2d cell
    u6_maccs = maccs - 128 * 9 + 128 * 9 // 4
    u6_bound_ms, u6_bound_by, _ = stack_bound(ylow16, out_px, sp16, u6_maccs)
    log(f"timing scale512 stack_scale_upto(6), bf16, on {smi}: "
        f"{u6_ms:.2f} ms (bound {u6_bound_ms:.2f} ms by {u6_bound_by}), "
        f"plain (in chunks) {u6_plain_ms:.2f} ms, cuDNN bf16 layers 1-6 + "
        f"taps as one stride-2 conv {u6_library_ms:.2f} ms; B7's own "
        f"launch: upto 0 "
        f"{own[0]:.3f} ms, upto 5 {own[5]:.3f} ms, upto 6 {own[6]:.3f} ms "
        f"(output {n * hl * wl * 8 / 1e6:.1f} MB)")

    kernels = [{
        "name": "the scale stack, low-res layer 1 (stack_scale, B1)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/l1.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": launches,
        "max_abs_err": max_err["stack_scale"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, {
        "name": "the noise stack, full-res layer 1 (stack_noise_s2d / "
                "stack_noise, B2)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/l1.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": launches_n,
        "max_abs_err": max(max_err["stack_noise"],
                           max_err["stack_noise_s2d"]),
        "ms": n_kernel_ms,
        "plain_ms": n_plain_ms,
        "bound_ms": n_bound_ms,
        "bound_by": n_bound_by,
        "library_ms": n_library_ms,
    }, {
        "name": "layer 7's u8 BGR out, the fold's OUT_U8 epilogue "
                "(stack_scale_fused_u8, B3)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/l7.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": stream_launches["fused_u8"],
        "max_abs_err": max_err["stack_scale_fused_u8"],
        "max_abs_err_unit": "u8 levels",
        "ms": u_kernel_ms,
        "plain_ms": u_plain_ms,
        "bound_ms": u_bound_ms,
        "bound_by": u_bound_by,
        "library_ms": u_library_ms,
    }, {
        "name": "layer 7's dense Y out, the fold's OUT_DENSE epilogue "
                "(stack_scale_dense, B6)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/l7.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": stream_launches["dense"],
        "max_abs_err": max_err["stack_scale_dense"],
        "ms": d_kernel_ms,
        "plain_ms": d_plain_ms,
        "bound_ms": d_bound_ms,
        "bound_by": d_bound_by,
        "library_ms": d_library_ms,
    }, {
        "name": "upto_gather_tiled / l7_fold's tap forms "
                "(stack_scale_upto, B7)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/gather.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": upto_launches,
        "max_abs_err": max_err["upto"],
        "ms": u6_ms,
        "own_launch_ms": {f"upto {k}": own[k] for k in own},
        "plain_ms": u6_plain_ms,
        "bound_ms": u6_bound_ms,
        "bound_by": u6_bound_by,
        "library_ms": u6_library_ms,
    }, {
        "name": "layer 5's tile-maxima epilogue + l6_i8_mma, the int8 "
                "layer 6 stack (l6_i8=True, B4)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/i8.cu",
        "sources": ["waifu2x_torch/csrc/mma.cu", "waifu2x_torch/csrc/i8.cu",
                    "waifu2x_torch/csrc/l7.cu"],
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": l6_launches["i8"],
        "max_abs_err": max(max_err["i8"], *(
            v for k, v in l6_err["i8"].items()
            if k != "stack_scale_fused_u8")),
        "max_abs_err_layer6_alone": max_err["i8_layer"],
        "ms": l6_t["i8"]["stack"],
        "layer6_ms": l6_t["i8"]["layers"][5],
        "plain_ms": l6_t["i8"]["plain"],
        "bound_ms": max(ops_ms["i8"], io_ms),
        "bound_by": "operations" if ops_ms["i8"] >= io_ms else "bytes",
        "library_ms": library_ms,
        "library_layer6_ms": l6_alone["cudnn"],
        "psnr_db": l6_db["i8"],
    }, {
        "name": "Winograd layer 6 (l6_wino=True, B5): the bf16 stack, its "
                "layer 6 on the tensor cores",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/wino.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": l6_launches["wino"],
        "max_abs_err": max(max_err["wino"], *(
            v for k, v in l6_err["wino"].items()
            if k != "stack_scale_fused_u8")),
        "ms": l6_t["wino"]["stack"],
        "layer6_ms": l6_t["wino"]["layers"][5],
        "plain_ms": l6_t["wino"]["plain"],
        "bound_ms": max(ops_ms["wino"], io_ms),
        "bound_by": "operations" if ops_ms["wino"] >= io_ms else "bytes",
        "library_ms": library_ms,
        "library_layer6_ms": l6_alone["cudnn"],
        "psnr_db": l6_db["wino"],
        "psnr_db_pure_random_plane": db_noise_l6["wino"],
    }, {
        "name": "l6_wino_mma, the Winograd layer 6 alone on the tensor "
                "cores (wgmma; bf16 l6_wino=True)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/wino.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": wino_mma_launches,
        "max_abs_err": max_err["wino_layer"],
        "ms": l6_alone["mma"],
        "direct_mma_ms": l6_alone["direct"],
        "plain_ms": l6_alone["plain"],
        "bound_ms": l6_bound["wino16"],
        "bound_by": l6_bound_by["wino16"],
        "own_24_products_ms": l6_flops["mma"] / PEAK_BF16_FLOPS * 1e3,
        "library_ms": l6_alone["cudnn"],
    }, {
        "name": "conv3x3_bias_leaky_mma, layers 2-6 of every bf16 stack "
                "call on the tensor cores (wgmma)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/mma.cu",
        "replaces": "waifu2x_tpu/ops/pallas_stack.py:798",
        "launches": mid_launches["mma"],
        "max_abs_err": max_err["mma"],
        "ms": float(mid_ms["scale512"][1:6].sum()),
        "layer_ms": [float(v) for v in mid_ms["scale512"][1:6]],
        "plain_ms": mma_plain_ms,
        "bound_ms": sum(b[2] for b in mid_bound),
        "bound_by": ("operations" if sum(
            b[2] for b in mid_bound if b[3] == "operations") >= sum(
            b[2] for b in mid_bound if b[3] == "bytes") else "bytes"),
        "library_ms": mid_library_ms,
        "psnr_db": mid_main_db,
        "routes": "persistent: layers 2-5 resident, layer 6 split",
        "tile_kernel_turns": mma_turns,
    }, {
        "name": "mma_chain, the inner loop's probe (tools/mma_probe.py)",
        "route": "cuda",
        "source": "waifu2x_torch/csrc/mma.cu",
        "replaces": "tools/vmem_bound_probe.py:80",
        "launches": chain_launches,
        "max_abs_err": chain_r["max_abs_err"],
        "ms": chain_r["ms"],
        "plain_ms": chain_r["plain_ms"],
        "bound_ms": chain_r["bound_ms"],
        "bound_by": chain_r["bound_by"],
        "library_ms": chain_r["library_ms"],
    }]
    kernel_names = {
        "store": "probe_store, a constant to every output block",
        "fetch_map": "probe_fetch_map, 1 or 4 blocks fetched, a map out "
                     "(one block, no repeat: probe_map_direct, "
                     "probe_map_planar; the rest persistent, block rows by "
                     "TMA into a ring)",
        "fetch_reduce": "probe_fetch_reduce, 1 or 4 blocks fetched whole "
                        "by TMA into a ring, reduced to one f32 per cell "
                        "(persistent)",
        "l1_mm": "probe_l1_mm, 9-lane block x (9, 128) weight on the "
                 "tensor cores (mma.sync), lanes 0-3 planar (persistent)"}
    for k, name in kernel_names.items():
        rows_k = [r for r in probe_rows if r["kernel"] == k]
        kernels.append({
            "name": name + " (tools/stage_time.py, grid_floor_probe.py, "
                           "dma_probe.py)",
            "route": "cuda",
            "source": "waifu2x_torch/csrc/probe.cu",
            "replaces": ", ".join(dict.fromkeys(r["site"] for r in rows_k)),
            "launches": probe_launches[k],
            "max_abs_err": probe_err[k],
            # ms, plain_ms, bound_ms and library_ms: the sums over the
            # kernel's variants, each at its tool's grid; "variants" has
            # each one's
            "ms": sum(r["ms"] for r in rows_k),
            "plain_ms": sum(r["plain_ms"] for r in rows_k),
            "bound_ms": sum(r["bound_ms"] for r in rows_k),
            "bound_by": ("operations" if all(
                r["bound_by"] == "operations" for r in rows_k) else "bytes"),
            "library_ms": sum(r["library_ms"] for r in rows_k),
            "variants": {r["name"]: {
                **{key: r[key] for key in (
                    "site", "bytes", "distinct_bytes", "ms", "eager_ms",
                    "rate_gbs", "bound_ms", "ffma_floor_ms", "plain_ms",
                    "library_ms", "max_abs_err")},
                **({"form": ring_routes[r["name"]]} if k == "fetch_map"
                   else {})}
                for r in rows_k},
        })
    l7_row = next(r for r in kernels19 if r["name"].startswith("l7_fold_f32"))
    l7_row.update({   # the f32 fold's row: the stack and step it ends
        "ns1080_noise_stack_ms": l7_chain["stack"],
        "ns1080_step_ms": l7_chain["step"],
        "ns1080_stack_layer_ms": list(map(float, l7_chain["layers"]))})
    kernels += kernels19
    # the kernels the command line reached (phase 28), by row
    for prefix, key in (("l1_conv,", "l1"), ("conv3x3_bias_leaky_mma,", "mma"),
                        ("conv3x3_bias_leaky_tf32,", "mma_tf32"),
                        ("l7_fold, layer 7 (128 -> 1)", "l7_fold"),
                        ("l7_fold_f32,", "l7_fold_f32")):
        (row,) = [r for r in kernels if r["name"].startswith(prefix)]
        row["cli_launches"] = cli_launches[key]
        row["cli_launches_of"] = ("phase 28's command-line runs, the counts "
                                  "set to 0 before each")
        row["mesh_launches"] = mesh_totals[key]
        row["mesh_launches_of"] = ("phase 29's mesh calls (MeshPipeline on "
                                   "three virtual meshes of the card, "
                                   "Converter, StreamConverter and the CLI on "
                                   "(1, 1, 1)), the counts set to 0 before "
                                   "each")
        row["train_tools_launches"] = (trained["launches"][key]
                                       + tools31["launches"][key])
        row["train_tools_launches_of"] = (
            "phase 30's Converter run of the trained weights and phase 31's "
            "three fidelity tools, the counts set to 0 before each")
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
