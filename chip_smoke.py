"""GPU smoke run of the port's main path (lilliput_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card; builds the host library (g++: Huffman decode and
encode, PNG row filters, the GIF container and LZW, JPEG 2000 Tier-1,
AVIF's YUV -> BGR rows; the WebP, libjpeg and ffmpeg libraries only where
their headers exist)
and the kernels (nvcc, sm_90a; one nvcc per
source, all at once) from the sources in this checkout, then drives
fourteen serving paths, each JpegTranscodePipeline(fixture -> 256x256 Fit
JPEG at q85, or PNG, batch 128), fixtures under tests/assets/:

  420, 422, 440, 444  the chroma layouts, upright (bench_1080p{,_422,_440,
                      _444}.jpg), AREA, chroma_mode="rgb", each through its
                      decode kernel;
  gray                grayscale, upright (bench_1080p_gray.jpg): no kernel,
                      the IDCT is a torch matmul as the JAX package's XLA
                      einsum;
  gray_o6             grayscale, EXIF orientation 6 (bench_1080p_gray_o6.jpg),
                      the whole frame through dequant_idct_blocks' u8
                      epilogue;
  420_o6              4:2:0, EXIF orientation 6 (bench_1080p_o6.jpg), the
                      whole frame through decode420;
  420_direct          4:2:0, chroma_mode="direct": no kernel, the IDCTs are
                      torch matmuls (dequant_idct_u8);
  420_direct_s2       4:2:0, chroma_mode="direct", dct_scale=2: no kernel
                      (dequant_idct_scaled), 16 of 64 coefficient lanes
                      shipped;
  420_linear          4:2:0, method="linear": decode420, then the streaming
                      Q11 bilinear;
  444_cubic           4:4:4 (bench_1080p_444.jpg), method="cubic": decode444,
                      then the streaming fixed-point bicubic;
  420_exact           4:2:0 with LILLIPUT_FUSED_EXACT=1 (set for this path
                      only, restored after): decode420, then the exact
                      sequential-tap AREA tail;
  420_png             4:2:0, output_format=".png": decode420 and the block
                      tail, the planes packed to BGRA pixels, PNG on the
                      host;
  gray_o6_png         grayscale o6, output_format=".png": dequant_idct_blocks
                      (u8), gray pixels, 1-channel PNG;

then the single-image surface (the still phase), the overlap check of
transcode_pipelined, the still formats, GIF, the mixed serving front,
JPEG 2000, WebP, the JPEG encode options with the libjpeg route, AVIF,
video with the profiling tools, multi-device serving over meshes, and
tools/tpu_smoke.py's 13 surfaces at small, odd shapes.

1. device and builds: card name and power limit, versions, build seconds;
2. the path's kernel against its plain PyTorch version on the card at the
   serving shape (the fixture's coefficients x128; both epilogues of a
   decode kernel) and, on the kernel's first path, at odd geometries with
   per-image tables (q30/85/95); every kernel also at its band and strip
   edges (EDGE_420, EDGE_422, EDGE_440, EDGE_444, EDGE_IDCT, batches 1 and
   3). dequant_idct_blocks' f32 epilogue is gated on the u8 values
   decode_gray makes of it, its f32 difference printed, and its u8
   epilogue must equal that rounded f32 output (0 differing values);
3. the main path: transcode_pipelined, with every launch count set to 0
   just before and read just after: the path's kernel must launch once per
   device step and no other kernel at all (none on the gray and direct
   paths), every
   output must be a 256x256 JPEG with the source's component count, and
   the device step must agree with the same step through the plain
   version and with the CPU step (2 images, a CPU pipeline built with the
   path's keywords and environment). 4:2:0 runs 3 batches, one
   holding a truncated scan (jpeg_huff.cpp declines it: the libjpeg route,
   whose slot holds HostLibraryMissingError where binding.JPEG_HEADER is
   absent, and otherwise bytes within the step gate of the CPU front's),
   and checks that the entropy round trip is lossless; the other paths
   run 2 batches.
   The .png paths' outputs must decode (the port's PngDecoder on the
   CPU) to 256x256 pixels with the source's channel count, and
   their packed pixels are held to the kernel gate instead;
4. times (CUDA events; host clock around work that ends in a sync): each
   kernel and its plain version (dequant_idct_blocks: the u8 epilogue the
   path runs, and the f32 epilogue beside torch.baddbmm, the one PyTorch
   call computing that function; the bound of each), each
   path's H2D, device step and end-to-end rate, its step split by
   utils.measure_device_stages into decode (the kernel, or the direct
   and upright gray modes' IDCTs), resize, encode (colour + fDCT, or the
   pixel pack), dispatch and fetch, 4:2:0's and 420_exact's D2H and host
   decode and encode rates, and the device's busy share under
   torch.profiler (utils.profile_complete: never from a session that
   dropped device records); the H2D of 420_direct_s2's truncated lanes
   beside 420's;
5. the still phase: for each fixture, new_decoder(device="cuda") ->
   ImageOps(8192).transform to .jpeg and to .png, Fit 256x256, and one
   decode_to, with every launch count 0 just before and read after: each
   decode launches its layout's kernel (dequant_idct_blocks for gray)
   exactly once. The decoded frame equals the plain decode (from a 2-image
   stack) and the CPU port's under the kernel gate, the .png pixels the
   CPU port's under the same gate, the .jpeg coefficients the CPU port's
   under the step gate. Prints ms per image for decode, transform and
   encode, and each kernel's batch-1 whole-frame time beside its plain
   version and bound;
6. the overlap check: one transcode_pipelined of 4 batches on 4:2:0, in
   which every _to_host of batch i-1 must return while step i's event is
   still pending (event.query() False); images/s and the busy share;
7. the still formats (still_inputs: the JCS_RGB and CMYK fixtures, YCCK,
   six kinds of PNG, BMP, PNM, PAM, Sun Raster, HDR and PFM at 1080p,
   packed from bench_1080p's pixels by tests/_torch_still_builders.py
   and the port's encoders): each decoded with
   device="cuda" with the launch counts 0 just before and read just after
   (dequant_idct_blocks exactly 3 times per JCS_RGB and 4 per CMYK/YCCK
   decode, no kernel for the others), equal to the CPU decode (0
   differing values) and, for the JPEGs, to the plain decode from a
   2-image stack under the kernel gate; ImageOps.transform to .jpeg, .png
   and .thumbhash, Fit 256x256, equal to the CPU port's bytes (.jpeg:
   coefficients under the step gate); thumbhash_batch of the RGBA PNG
   input's 100x100 tiles on the card: grids within THUMB_GRID_ATOL of the
   CPU's, hashes equal but where an AC sits on a rounding tie within the
   grids' difference; one
   in-process CLI run of the PNG input to .jpeg on the card, equal to
   -device cpu's bytes; ms per image
   of decode, transform and each encode, and dequant_idct_blocks' batch-1
   time on a CMYK plane beside torch.baddbmm's;
8. GIF (no kernel: the palette ops are torch ops): the avatar resize,
   AnimatedTranscodePipeline(128, 128, ".gif").transcode of 32 480x480
   animations (gif_inputs: pans across bench_1080p's pixels written with
   dictionary LZW by tests/_torch_gif_builders.py, 28 of 32 frames and 4
   of 20, so two groups), with every launch count 0 just before the
   phase and read just after (no kernel may launch); every timed
   transcode must run as those two batch groups: outputs equal
   per-animation transcode_gif on the card and transcode_gif_batch
   called directly, the CPU port's bytes for four of them, the
   streaming ImageOps transform for one, and decode to 128x128 with the
   sources' frame counts; a corrupt GIF fails only its own slot; a
   1920x1080 GIF of 4 frames through ImageOps.transform to .jpeg, .png and
   .thumbhash (Fit 256x256) equal to the CPU port's (.jpeg: coefficients
   under the step gate); times of each group's stages from
   transcode_gif_batch's stage_times (host LZW decode, stacking, H2D,
   composite, crop + resize, plan, quantize, D2H, host LZW encode),
   output frames/s, peak device memory and busy share;
9. the mixed serving front: MultiGeometryPipeline(256, 256, q85) over MIX,
   193 shuffled requests of 12 signatures (the 1080p fixtures of every
   layout, gray and o6; a 720p 4:2:0 JPEG the port stretches from
   bench_1080p.jpg; PNG RGB8, RGBA8 and gray8 of the fixtures' pixels;
   the 1080p GIF) and three broken inputs (a truncated scan, a truncated
   PNG, a frameless RIFF/WEBP header), with every launch count 0 just
   before its
   first transcode and read just after (MIX_LAUNCHES: decode420 3, the
   other four 1 each, none from the still and gray groups). Every healthy
   output equals its per-signature JpegTranscodePipeline or
   StillTranscodePipeline on the card in input order, the broken slots
   and only they hold exceptions (the WebP one HostLibraryMissingError
   where libwebp's header is absent, else InvalidImageError; the
   truncated scan HostLibraryMissingError where libjpeg's header is
   absent, else it decodes through libjpeg and is healthy), stats()
   reads one build per signature and one hit per other routed request
   (again on a second call, no eviction), max_geometries=4 counts
   evictions without changing the bytes, the .jpeg coefficients are
   within the step gate of the CPU front's, and a front warmed from the
   twelve signatures builds nothing on the mix. Times: images/s, each
   group's host decode, device_step and encode, busy share, peak device
   memory, a new geometry's first request cold and warmed, and
   StillTranscodePipeline over 128 1080p PNG RGB8 (host decode per image
   on the decode threads, with torch's intra-op threads and with one; H2D,
   device_step, transcode_pipelined images/s);
10. JPEG 2000 (no kernel: Tier-2 and Tier-1 on the host, the wavelet,
   colour transforms and decode tail as torch ops): jp2_inputs(), seven
   1080p streams the port's encoder writes on the card (lossless RGB,
   9/7 at JPEG2000_RATE 10000, gray, RGBA, 9/7 in 256x256 tiles, sYCC,
   truncated), with every launch count 0 just before the phase and read
   just after (none may launch): decode_to on the card equal to the CPU
   port with 0 differing values, ImageOps.transform to .jpeg, .png and
   .jp2 equal to the CPU port's (.jpeg: coefficients under the step
   gate), the .jp2 encode of the card's frames equal to the CPU's, one
   CLI run, StillTranscodePipeline over 16 requests of 4 lossless images
   equal to the CPU front, MultiGeometryPipeline failing the truncated
   slot alone; decode ms on the card and the CPU split into host Tier-2
   + Tier-1 and the device tail, device events per decode, encode ms,
   the still front's images/s;
11. WebP (phase11; no kernel of its own: the yuv420 emit and the
   composite are torch ops), with every launch count 0 just before the
   phase and read just after: (a) JpegTranscodePipeline(bench_1080p.jpg
   -> 256x256 .webp, q85) emits yuv420, one batch-128 device step
   launches decode420 once and nothing else (that launch joins the
   kernels line), its planes (128x256x256 and 2x 128x128x128 u8) equal
   the CPU port's step on 2 images and the yuv420 conversion of the .png
   step's pixels on the card; the emit's ms, the .webp and .png steps'
   ms, the D2H bytes and ms at 1.5 against 4 B/px; (b) the still front's
   .webp step over 1080p PNG RGB8 (yuv420) and RGBA8 (pixels) equal to
   the CPU port's; (c) webp_yuv420_from_packed over every u8 value, at
   1x1, 5x7, 33x47 and a batch, equal to the CPU port's; (d) the
   composite + AREA 480->128 of 16 animations x 32 frames
   (webp_anim_inputs: sub-rects at clipped and negative offsets, partial
   alpha, both blends and disposals, bucket padding) equal to the CPU
   port's, with its ms, H2D and device events; (e) where libwebp's header
   is absent (the card's machine), new_decoder of
   tests/assets/anim_96x80.webp, new_encoder(".webp"), transcode_webp,
   the .webp pipeline's transcode and GIF -> .webp each raise
   HostLibraryMissingError; where it is present their card bytes equal
   the CPU port's;
12. JPEG encode options and the libjpeg decode route (phase12): (a)
   JpegTranscodePipeline(bench_1080p.jpg -> 256x256, q85,
   optimize_coding=True), OPT_BATCHES batch-128 steps with every launch
   count 0 just before and read just after: decode420 once per step and
   nothing else (those launches join the kernels line), each output the
   coefficients of the baseline pipeline's output and no larger; the
   encode ms of a batch with and without optimize_coding, the bytes of
   both, transcode_pipelined images/s of both in turns; (b)
   ImageOps.transform of the fixture to .jpeg and JpegEncoder of its
   1080p frame on the card under each ENC_OPTIONS (progressive,
   optimize, restart, all three): the baseline's coefficients, SOF2 or
   DRI where due, and the 1080p encode ms of each; (c) the CLI's .jpg on
   the card is progressive and equals -device cpu's; (d) where libjpeg's
   header is absent (the card's machine), the truncated scan through
   new_decoder(device="cuda") and LILLIPUT_JPEG_HUFF=libjpeg each raise
   HostLibraryMissingError; where it is present their frames equal the
   CPU port's under the kernel gate;
13. AVIF (phase13; no kernel: the HDR chain and colour conversions are
   torch ops, the AV1 codec host code), with every launch count 0 just
   before the phase and read just after: (a) the HDR decode's device
   half (codecs/avif.hdr_planes_to_bgr) on two 3840x2160 inputs made from
   a seed (avif_hdr_inputs: 10-bit limited 4:2:0, BT.2020, PQ, a 10-bit
   alpha plane; 12-bit full-range 4:2:2, P3, HLG) within the step gate
   of the CPU port's, the alpha equal, with its H2D and device ms and
   device events; (b) planes_to_bgr_u8 of 4K 10- and 8-bit 4:2:0 planes
   on the host, yuv_bgr.cpp equal to the Python reference; (c)
   bgr_to_yuv then yuv420_to_bgr of bench_1080p.jpg's pixels equal to the
   CPU port's; (d) the committed AVIF fixtures (AVIF_FIXTURES): header,
   duration, loop count and ICC as stated on the card and the CPU; where
   ffmpeg's header is absent (the card's machine) decode_to, an .avif
   encode, transcode_avif, transcode_avif_batch and the animated front's
   .avif slot each raise HostLibraryMissingError, and where it is
   present the card's frames and bytes equal the CPU port's;
14. video and the profiling tools (phase14; no kernel of their own: the
   YUV -> BGR conversion, the LINEAR and AREA resizes and the thumbhash
   grids are torch ops, ffmpeg host code), with every launch count 0 just
   before (a) and read after (c) (none may launch there): (a)
   codecs/video.frame_to_bgra on 1080p planes (VIDEO_CASES: yuv420p
   bt709, yuvj422p full range bt601, yuv444p, 1440x1080 displayed at
   1920x1080 through the LINEAR upscale) and bgra_to_display, each equal
   to the CPU port's byte for byte, with H2D and device ms and device
   events; (b) pipeline.spritesheet_tiles of 64 1920x1080 keyframes
   (sprite_frames) to 160x90 tiles with thumbhashes, the tiles equal to
   the CPU port's, the hashes equal but at rounding ties, each stage's
   ms; (c) where ffmpeg's header is absent (the card's machine)
   new_decoder, VideoDecoder and spritesheet of tests/assets/
   tiny_vp8.webm raise HostLibraryMissingError, and where it is present
   the first frame equals the CPU port's; random bytes raise
   InvalidImageError; (d) utils.measure_device_stages on the 4:2:0
   pipeline at batch 128 beside phase 4's decode420 time; Chrome traces
   (complete_trace) of one device_step and of two, each read only from a
   session that kept a record of every kernel launch and copy (one that
   dropped records is thrown away and a fresh one opened; a second drop
   fails), holding one decode420_kernel event per step, and a
   utils.device_trace of one step, its file written and its records
   counted (the traces go to traces/phase14/ in the checkout);
15. multi-device serving (phase15; parallel/: each mesh slot runs the
   one-device step's kernels on its own device and CUDA stream), at full
   width on three meshes (phase15_meshes): make_mesh(), every card (one
   slot on a one-card machine), and the first card four times, shaped
   (4, 1) and (2, 2). (a) ShardedJpegPipeline over 4:2:0 1080p x128 ->
   256x256 q85: each slot's input slice pinned; two batches of
   transcode_pipelined with every launch count 0 just before and read
   just after, decode420 once per slot per step and nothing else (those
   launches join the kernels line); dp meshes give JpegTranscodePipeline's
   bytes, (2, 2) (sp: rows split with explicit halos) coefficients within
   1 of its step; each slot's device_step(plain=True) within the step
   gate of its kernel run; in a complete_trace of two (4, 1) steps the
   slots' work (kernels and copies) runs on four streams and overlaps
   across them (the kernels' and copies' own overlap printed);
   device_step ms of each
   mesh beside the one-device step's; (b) a 3840x2160 4:2:0 and a gray
   JPEG (the port's stretch of the fixtures) x SP_BATCH on (2, 2): within
   1 of the one-device step, the serving.sp_* counters, each shard's
   decoded rows equal to the whole decode's; (c) ShardedStillPipeline
   over STILL_MESH_BATCH 1080p PNG RGB8 on each mesh (dp bytes equal, sp
   within 1); (d) phase 8's GIF lanes over (4, 1), the one-device bytes;
   (e) MultiGeometryPipeline(mesh=) over phase 9's mix on each mesh,
   every kernel launched once per dp slot of each group (more where
   (2, 2) splits a group's rows; these launches join the kernels line),
   the dp meshes' healthy bytes equal to the one-device front's, (2, 2)'s
   .jpeg coefficients within 1, the broken slots failing alone;
16. tools/tpu_smoke.py's 13 surfaces at its small, odd shapes,
   the inputs built here (small_bgr, layout_jpeg, tests/_torch_*_builders,
   tests/assets/): the 100x76 JPEG in 4:2:0, gray, 4:2:2 and 4:4:4 to
   .jpeg, .png and .webp (steps within the kernel gate of their plain
   versions and the step gate of the CPU port's); the 47x33 and 33x47
   still fronts; the yuv420 emit at 33x47, 1x1 and 64x64; the 14x9 GIF
   alone and as a 3-lane group; the 20x13 WebP composite; thumbhash;
   an 853x479 yuv420p frame; ops/resize 37x53 -> 24x17 by AREA, LINEAR
   and CUBIC; ops/blend of a 13x11 frame into 31x29 and ops/orient 1-8;
   a 121x81 PQ tone map (the HDR tier); a 40x30 16-bit PNG; 4 spritesheet
   tiles (the thumbhash tie rule); each equal to the CPU port (atol 0
   where the port is exact), and each host call of libwebp or ffmpeg
   raising HostLibraryMissingError where the library is absent (equal to
   the CPU port's result where present). One JSON line per surface, then
   {"surfaces": 13, "failures": [...]}; a failure fails the phase;
17. the batch-serving entry point, python -m lilliput_tpu_torch.serve_batch
   (phase17: serve_batch.main, its default device the card), over 128
   copies of the 1080p fixtures (every decode kernel's layout, gray o6
   for dequant_idct_blocks), a 1080p RGBA PNG and a 1080p GIF, Fit
   256x256 .jpeg, with no flag, -warm (over a quarter of each source's
   copies: -warm refuses more than 64 requests, as the JAX example does,
   which is checked) and -sharded (make_mesh(): every card), every
   launch count 0 just before each run and read just after
   (every kernel launched; these launches join the kernels line): its
   lines, its files byte-equal across the runs and across copies of one
   source, and their coefficients within the step gate of its files with
   -device cpu.
18. the device entropy route (phase18; ops/entropy_kernels, the
   huffman_decode kernels): decode_entropy(device="cuda") against the host
   route (jpeg_huff.cpp) on the seven 1080p fixtures x16 and on
   ENTROPY_SOURCES 4032x3024 4:2:0 sources made as the benchmark's maker
   makes them (portbench/inputs/jpeg_photos.py; orientation 6, whole
   frames, and upright, the window) in batches of ENTROPY_BATCH: every
   coefficient and table equal, no stream flagged; the kernels' ms a
   batch of 32 at 12 MP (CUDA events) beside their byte bound (scans read
   once, coefficients written once, at 3.35 TB/s) and the plain version's
   host seconds on ENTROPY_PLAIN_BATCH of them; transcode_pipelined over
   3 batches of each 12 MP batch by both routes: bytes equal, 3 launch
   sequences on the device route and none on the host route, no stream
   redone (serving.device_entropy_redo), the decode spans'
   device_entropy equal to their images.

device_spans (the busy shares and device-event counts of phases 4-14)
and complete_trace (phases 14 and 15's Chrome traces) run through
utils.profile_complete: torch.profiler opened as utils.device_trace
opens it, with a burn-in of one-element kernels first, and read only
from a session that kept a device record of every kernel launch and
every memcpy/memset of the work (a fresh session after one that dropped
records; a second drop fails the phase, naming the counts); every busy
share prints with its count of device records.

Prints one line per phase, then the kernels JSON line, the card line, and
as its last line {"ok": true, "device": {...}}. Any failure raises, so the
exit code is non-zero and the last line is not printed. Imports no JAX.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(ROOT, "tests", "assets")
_TPU = "lilliput_tpu/ops/pallas_kernels.py"
_CSRC = "lilliput_tpu_torch/csrc"
#: kernel -> (CUDA source, TPU kernel it replaces, (h2, v2) of a decode
#: kernel's chroma layout)
KERNELS = {
    "decode420": (f"{_CSRC}/decode420.cu", f"{_TPU}:390", (True, True)),
    "decode422": (f"{_CSRC}/decode422.cu", f"{_TPU}:544", (True, False)),
    "decode440": (f"{_CSRC}/decode440.cu", f"{_TPU}:670", (False, True)),
    "decode444": (f"{_CSRC}/decode444.cu", f"{_TPU}:771", (False, False)),
    "dequant_idct_blocks": (f"{_CSRC}/idct_blocks.cu", f"{_TPU}:45", None),
}
IDCT = "dequant_idct_blocks"


class Path(NamedTuple):
    fixture: str
    kernel: "str | None"   # launched once per device step; None: no kernel
    ncomp: int             # output components
    kw: dict = {}          # JpegTranscodePipeline keywords
    env: dict = {}         # environment set for this path only


PATHS = {
    "420": Path("bench_1080p.jpg", "decode420", 3),
    "422": Path("bench_1080p_422.jpg", "decode422", 3),
    "440": Path("bench_1080p_440.jpg", "decode440", 3),
    "444": Path("bench_1080p_444.jpg", "decode444", 3),
    "gray": Path("bench_1080p_gray.jpg", None, 1),
    "gray_o6": Path("bench_1080p_gray_o6.jpg", IDCT, 1),
    "420_o6": Path("bench_1080p_o6.jpg", "decode420", 3),
    "420_direct": Path("bench_1080p.jpg", None, 3,
                       {"chroma_mode": "direct"}),
    "420_direct_s2": Path("bench_1080p.jpg", None, 3,
                          {"chroma_mode": "direct", "dct_scale": 2}),
    "420_linear": Path("bench_1080p.jpg", "decode420", 3,
                       {"method": "linear"}),
    "444_cubic": Path("bench_1080p_444.jpg", "decode444", 3,
                      {"method": "cubic"}),
    "420_exact": Path("bench_1080p.jpg", "decode420", 3, {},
                      {"LILLIPUT_FUSED_EXACT": "1"}),
    "420_png": Path("bench_1080p.jpg", "decode420", 3,
                    {"output_format": ".png"}),
    "gray_o6_png": Path("bench_1080p_gray_o6.jpg", IDCT, 1,
                        {"output_format": ".png"}),
}
#: the still phase's fixtures: every layout, grayscale, and orientation 6
STILLS = ["bench_1080p.jpg", "bench_1080p_422.jpg", "bench_1080p_440.jpg",
          "bench_1080p_444.jpg", "bench_1080p_gray.jpg",
          "bench_1080p_gray_o6.jpg", "bench_1080p_o6.jpg"]
#: H100 SXM data-sheet peaks: HBM bytes/s and f32 non-tensor FLOP/s
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
BATCH = 128
DST = 256
#: utils.measure_device_stages' stages, printed per path by phase 4
STAGES = ("decode", "resize", "encode", "full_step", "dispatch", "fetch")
CASES = [(64, 48), (67, 61), (16, 16), (130, 17), (8, 8), (24, 129)]
#: decode420's, decode422's and decode440's band and strip edges (bands of
#: 17 MCU rows; strips of 10, 14 and 16 MCUs), and decode444's (steps of 4
#: and bands of 16 MCU rows, strips of 16 MCUs), as chroma block rows x
#: cols; on each kernel's first path only
EDGE_420 = [(ch, cw) for ch in (1, 16, 17, 18, 35)
            for cw in (1, 7, 8, 9, 10, 11, 17, 21)]
EDGE_422 = [(ch, cw) for ch in (1, 16, 17, 18, 35)
            for cw in (1, 13, 14, 15, 28, 29)]
EDGE_440 = [(ch, cw) for ch in (1, 16, 17, 18, 35)
            for cw in (1, 10, 15, 16, 17, 33)]
EDGE_444 = [(ch, cw) for ch in (1, 3, 4, 5, 15, 16, 17, 35)
            for cw in (1, 15, 16, 17, 33)]
#: dequant_idct_blocks' step (4 block rows), band (16 block rows) and strip
#: (16 block columns) edges, as block rows x cols
EDGE_IDCT = [(bh, bw) for bh in (1, 3, 4, 5, 15, 16, 17, 33)
             for bw in (1, 15, 16, 17, 33)]
KERNEL_MAX_DIFF, KERNEL_MAX_SHARE = 1, 1e-4
STEP_MAX_DIFF, STEP_MAX_SHARE = 1, 1e-3
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches (after one warm-up),
    measured with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def diff_stats(got, ref):
    """(max |got - ref|, count of differing values, count of values) over
    u8 planes, unpacked BGRA bytes or int16 coefficients."""
    import torch
    if isinstance(got, torch.Tensor) and got.dtype == torch.int32:
        got = [(got >> s) & 255 for s in (0, 8, 16, 24)]
        ref = [(ref >> s) & 255 for s in (0, 8, 16, 24)]
    mx, nd, n = 0, 0, 0
    for g, r in zip(got, ref):
        d = (g.to(torch.int32) - r.to(torch.int32)).abs()
        mx = max(mx, int(d.max()))
        nd += int((d > 0).sum())
        n += d.numel()
    return mx, nd, n


def phase1():
    import torch
    print(f"phase 1: cuda available={torch.cuda.is_available()}", flush=True)
    check(torch.cuda.is_available(), "no CUDA device")
    print(f"phase 1: card {card_line()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    from concurrent.futures import ThreadPoolExecutor
    from lilliput_tpu_torch import binding
    from lilliput_tpu_torch.ops import _build
    from lilliput_tpu_torch.ops import decode_kernels as DK
    t0 = time.perf_counter()
    have_webp = os.path.exists(binding.WEBP_HEADER)
    have_jpeg = os.path.exists(binding.JPEG_HEADER)
    with ThreadPoolExecutor(4) as ex:      # g++ beside the nvcc builds
        host = ex.submit(binding.load)
        webp = ex.submit(binding.load_webp) if have_webp else None
        jpeg = ex.submit(binding.load_jpeg) if have_jpeg else None
        libs = DK.build()
        host.result()
        for lib in (webp, jpeg):
            if lib is not None:
                lib.result()
    t1 = time.perf_counter()
    for name, lib in libs.items():
        ptxas = [ln.strip() for ln in _build.build_log(lib).splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Function properties" in ln]
        print(f"phase 1: {name} ptxas: {ptxas}", flush=True)
    deflate = ("linked" if binding.load().lp_zlib_fast_available()
               else "absent: PNG deflates with Python zlib")
    print(f"phase 1: host library and {len(libs)} kernel libraries built "
          f"in {t1 - t0:.1f}s; libdeflate {deflate}; libwebp "
          f"{'built' if have_webp else 'absent: WebP host calls raise HostLibraryMissingError'}; "
          f"libjpeg "
          f"{'built' if have_jpeg else 'absent: the libjpeg decode route raises HostLibraryMissingError'}",
          flush=True)


def random_case(rng, h, w, h2, v2, batch=3):
    import torch
    from lilliput_tpu_torch.codecs.jpeg import scaled_qtables
    from lilliput_tpu_torch.ops import jpeg_kernels as K

    def bl(n, f):
        return (-(-n // f) + 7) // 8
    cshape = (batch, bl(h, 1 + v2), bl(w, 1 + h2), 64)
    yc = rng.integers(-300, 300, (batch, bl(h, 1), bl(w, 1), 64))
    cb = rng.integers(-200, 200, cshape)
    cr = rng.integers(-200, 200, cshape)
    qs = [scaled_qtables(q) for q in (30, 85, 95)][:batch]
    qy = np.stack([q[0] for q in qs]).astype(np.float32)
    qc = np.stack([q[1] for q in qs]).astype(np.float32)
    dev = [torch.from_numpy(a.astype(np.int16)).to(DEVICE)
           for a in (yc, cb, cr)]
    return (*dev, K.fold_qtables(torch.from_numpy(qy).to(DEVICE)),
            K.fold_qtables(torch.from_numpy(qc).to(DEVICE)))


def plain_decode(args, h2, v2, out):
    """The plain version of the decode kernels; one image's is taken from a
    stack of two copies of it, since at batch 1 cuBLAS runs a single GEMM
    whose sum order differs from its batched one."""
    from lilliput_tpu_torch.ops import decode_kernels as DK
    if args[0].shape[0] > 1:
        return DK.decode_ycc_reference(*args, h2, v2, out=out)
    import torch
    ref = DK.decode_ycc_reference(*(torch.cat([a, a]) for a in args), h2, v2,
                                  out=out)
    return ref[:1] if out == "packed" else tuple(p[:1] for p in ref)


def phase2(path, pipe, bufs, first: bool):
    """The path's kernel vs its plain version on the card. Returns (max
    diff, args at the serving shape), (None, None) without a kernel."""
    name = PATHS[path].kernel
    if name is None:
        print(f"phase 2: {path}: no kernel on this path (the IDCTs are "
              "torch matmuls, as the JAX package's XLA dots)", flush=True)
        return None, None
    if name == IDCT:
        return phase2_idct(path, pipe, bufs, first)
    import torch
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    h2, v2 = KERNELS[name][2]
    kernel = getattr(DK, name)
    ys, cbs, crs, qty, qtc = pipe.decode_entropy(bufs)
    serving = tuple(torch.from_numpy(a).to(DEVICE) for a in (ys, cbs, crs))
    serving += tuple(K.fold_qtables(torch.from_numpy(
        q.astype(np.float32)).to(DEVICE)) for q in (qty, qtc))
    rng = np.random.default_rng(1234)
    inputs = [(f"{path} fixture x{BATCH} {tuple(ys.shape[1:3])}", serving)]
    if first:
        inputs += [(f"random {h}x{w}", random_case(rng, h, w, h2, v2))
                   for h, w in CASES]
    edges = {"decode420": EDGE_420, "decode422": EDGE_422,
             "decode440": EDGE_440, "decode444": EDGE_444}.get(name, [])
    if first:
        inputs += [(f"edge chroma {ch}x{cw} x{1 + 2 * (i % 2)}", random_case(
            rng, 8 * (1 + v2) * ch - 1, 8 * (1 + h2) * cw - 3, h2, v2,
            batch=1 + 2 * (i % 2))) for i, (ch, cw) in enumerate(edges)]
    worst = 0
    for what, args in inputs:
        for out in ("planes", "packed"):
            got = kernel(*args, out=out)
            ref = plain_decode(args, h2, v2, out)
            mx, nd, n = diff_stats(got, ref)
            worst = max(worst, mx)
            print(f"phase 2: {name} {what} {out}: max_abs_diff={mx} "
                  f"differing={nd}/{n} ({nd / n:.3g})", flush=True)
            check(mx <= KERNEL_MAX_DIFF and nd <= KERNEL_MAX_SHARE * n,
                  f"{name} disagrees with its plain version on {what}")
    return worst, serving


def _u8(p):
    import torch
    return torch.clamp(torch.round(p), 0, 255).to(torch.uint8)


def plain_idct(coefs, wq):
    """dequant_idct_blocks' plain version (f32); one image's is taken from a
    stack of two copies of it, as in plain_decode."""
    import torch
    from lilliput_tpu_torch.ops import decode_kernels as DK
    if coefs.shape[0] > 1:
        return DK.dequant_idct_blocks_reference(coefs, wq)
    return DK.dequant_idct_blocks_reference(torch.cat([coefs, coefs]),
                                            torch.cat([wq, wq]))[:1]


def idct_inputs(rng):
    """dequant_idct_blocks' phase-2 inputs besides the serving shape: the
    CASES at batch 3 and the EDGE_IDCT grids at batches 1 and 3 in turn,
    coefficients in -400..399 with per-image q30/85/95 tables, as
    [(what, (coefs, wq))]."""
    import torch
    from lilliput_tpu_torch.codecs.jpeg import scaled_qtables
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    qs = np.stack([scaled_qtables(q)[0] for q in (30, 85, 95)])
    wq = K.fold_qtables(torch.from_numpy(qs.astype(np.float32)).to(DEVICE))

    def case(bh, bw, batch=3):
        return torch.from_numpy(rng.integers(
            -400, 400, (batch, bh, bw, 64)).astype(np.int16)).to(DEVICE), \
            wq[:batch]
    return [(f"random {h}x{w}", case(-(-h // 8), -(-w // 8)))
            for h, w in CASES] + [
        (f"edge blocks {bh}x{bw} x{1 + 2 * (i % 2)}",
         case(bh, bw, 1 + 2 * (i % 2)))
        for i, (bh, bw) in enumerate(EDGE_IDCT)]


def phase2_idct(path, pipe, bufs, first: bool):
    """dequant_idct_blocks vs its plain version: the f32 epilogue's u8
    values (decode_gray's round half to even and clip) within KERNEL_MAX_*,
    its f32 difference printed; the u8 epilogue equal to the rounded f32
    output. Returns (max f32 difference, serving args)."""
    import torch
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    ys, qty = pipe.decode_entropy(bufs)
    serving = (torch.from_numpy(ys).to(DEVICE), K.fold_qtables(
        torch.from_numpy(qty.astype(np.float32)).to(DEVICE)))
    inputs = [(f"{path} fixture x{BATCH} {tuple(ys.shape[1:3])}", serving)]
    if first:
        inputs += idct_inputs(np.random.default_rng(4321))
    worst = 0.0
    for what, args in inputs:
        got = DK.dequant_idct_blocks(*args)
        got8 = DK.dequant_idct_blocks(*args, out="u8")
        ref = plain_idct(*args)
        f32 = float((got - ref).abs().max())
        worst = max(worst, f32)
        mx, nd, n = diff_stats([_u8(got)], [_u8(ref)])
        _, nd8, _ = diff_stats([got8], [_u8(got)])
        print(f"phase 2: {IDCT} {what}: f32 max_abs_diff={f32!r}; u8 "
              f"max_abs_diff={mx} differing={nd}/{n} ({nd / n:.3g}); u8 "
              f"epilogue vs rounded f32 differing={nd8}", flush=True)
        check(mx <= KERNEL_MAX_DIFF and nd <= KERNEL_MAX_SHARE * n,
              f"{IDCT} disagrees with its plain version on {what}")
        check(nd8 == 0, f"{IDCT}'s u8 epilogue differs from its rounded f32 "
              f"output on {what}")
        del got, got8, ref
    return worst, serving


def png_pixels(buf: bytes) -> np.ndarray:
    """A PNG's pixels, (H, W, C) u8, decoded by the port on the CPU."""
    from lilliput_tpu_torch import Framebuffer
    from lilliput_tpu_torch.codecs.png import PngDecoder
    fb = Framebuffer()
    PngDecoder(buf, device="cpu").decode_to(fb)
    return fb.to_numpy()


def jpeg_coefs(buf: bytes):
    """A JPEG's quantized coefficients per component (jpeg_huff.cpp)."""
    from lilliput_tpu_torch import binding
    from lilliput_tpu_torch.codecs import jpeg as J
    info = J.read_info(buf)
    comps = [np.zeros((info.comp_blocks_h[c], info.comp_blocks_w[c], 64),
                      np.int16) for c in range(info.num_components)]
    qt = np.zeros((4, 64), np.uint16)
    arr = np.frombuffer(buf, np.uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    rc = binding.load().lp_jpeg_decode_coefs_fast(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size,
        (i16p * len(comps))(*[c.ctypes.data_as(i16p) for c in comps]),
        qt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), 1)
    check(rc == 0, f"re-decode of a JPEG output failed ({rc})")
    return comps


def is_png_path(path) -> bool:
    return PATHS[path].kw.get("output_format") == ".png"


def check_outputs(path, res, skip=()):
    from lilliput_tpu_torch.codecs import jpeg as J
    ncomp = PATHS[path].ncomp
    for bi, outs in enumerate(res):
        for i, o in enumerate(outs):
            if (bi, i) in skip:
                continue
            check(isinstance(o, bytes), f"{path} batch {bi} item {i} "
                  f"failed: {o!r}")
            if is_png_path(path):
                shape = png_pixels(o).shape
            else:
                info = J.read_info(o)
                shape = (info.height, info.width, info.num_components)
            check(shape == (DST, DST, ncomp),
                  f"{path} output {bi}/{i} is not {DST}x{DST}x{ncomp}")


def run_main_path(path, pipe, batches):
    """transcode_pipelined with every launch count 0 just before and read
    just after; the path's kernel must launch once per device step and no
    other kernel at all. Returns (results, counts)."""
    from lilliput_tpu_torch.ops import decode_kernels as DK
    name = PATHS[path].kernel
    DK.reset_launches()
    res = pipe.transcode_pipelined(batches, return_exceptions=True)
    counts = dict(DK.launches)
    print(f"phase 3: {path} transcode_pipelined {len(batches)}x{BATCH}: "
          f"launches={counts}", flush=True)
    check(counts == {k: len(batches) * (k == name) for k in counts},
          f"{name or 'no kernel'} did not launch once per device step of "
          f"the {path} path (or another kernel launched)")
    return res, counts


def _check_step_diff(path, step, ref, what):
    """A step's coefficients within the step gate, or its packed pixels
    (.png paths) within the kernel gate."""
    import torch
    if is_png_path(path):
        got, exp = torch.from_numpy(step[0]), torch.from_numpy(ref[0])
        gate, unit = (KERNEL_MAX_DIFF, KERNEL_MAX_SHARE), "pixel bytes"
    else:
        got = [torch.from_numpy(a) for a in step]
        exp = [torch.from_numpy(a) for a in ref]
        gate, unit = (STEP_MAX_DIFF, STEP_MAX_SHARE), "coefficients"
    mx, nd, n = diff_stats(got, exp)
    print(f"phase 3: {path} device_step vs {what}: max_abs_diff={mx} "
          f"differing={nd}/{n} ({nd / n:.3g}) {unit}", flush=True)
    check(mx <= gate[0] and nd <= gate[1] * n,
          f"{path} device_step disagrees with the {what}")


def check_plain_step(path, pipe, batch):
    """device_step vs the same step through the plain version; returns the
    step's coefficients as numpy."""
    args = pipe.decode_entropy(batch)
    step = [t.cpu().numpy() for t in pipe.device_step(*args)]
    plain = [t.cpu().numpy() for t in pipe.device_step(*args, plain=True)]
    _check_step_diff(path, step, plain, "plain device_step")
    return step


def check_cpu_step(path, pipe, fixture):
    """device_step on the card vs the CPU pipeline's step, 2 images; the
    CPU pipeline has the path's keywords, and runs inside the path's
    environment."""
    from lilliput_tpu_torch import JpegTranscodePipeline
    cpu = JpegTranscodePipeline(fixture, DST, DST, quality=85, device="cpu",
                                **PATHS[path].kw)
    args = pipe.decode_entropy([fixture] * 2)
    step = [t.cpu().numpy() for t in pipe.device_step(*args)]
    host = [t.numpy() for t in cpu.device_step(*args)]
    _check_step_diff(path, step, host, "CPU device_step")


def phase3_420(pipe, fixture):
    import torch
    from lilliput_tpu_torch import JpegTranscodePipeline, binding
    from lilliput_tpu_torch.errors import HostLibraryMissingError
    from lilliput_tpu_torch.utils import metrics

    # a scan cut off mid-stream: jpeg_huff.cpp declines it, so it takes
    # the libjpeg route, which fails its slot where libjpeg is absent
    corrupt = fixture[:len(fixture) // 2]
    have_jpeg = os.path.exists(binding.JPEG_HEADER)
    batches = [[fixture] * BATCH for _ in range(3)]
    batches[1][5] = corrupt
    pipe.transcode([fixture] * 2)              # warm: pools, tables, cuBLAS
    metrics.reset()
    res, counts = run_main_path("420", pipe, batches)
    poisoned = metrics.snapshot()["counters"].get("serving.poison_isolated")
    if have_jpeg:
        check_outputs("420", res)
        check(not poisoned, f"serving.poison_isolated={poisoned}")
        cpu = JpegTranscodePipeline(fixture, DST, DST, quality=85,
                                    device="cpu").transcode([corrupt])[0]
        mx, nd, n = diff_stats(
            [torch.from_numpy(a) for a in jpeg_coefs(res[1][5])],
            [torch.from_numpy(a) for a in jpeg_coefs(cpu)])
        check(mx <= STEP_MAX_DIFF and nd <= STEP_MAX_SHARE * n,
              f"the truncated scan's output differs from the CPU front's: "
              f"max {mx}, {nd}/{n} coefficients")
        slot = (f"truncated scan decoded through libjpeg, coefficients "
                f"within the step gate of the CPU front's (max {mx}, "
                f"{nd}/{n})")
    else:
        check(isinstance(res[1][5], HostLibraryMissingError),
              f"the truncated scan gave {res[1][5]!r}")
        check_outputs("420", res, skip={(1, 5)})
        check(poisoned == 1, f"serving.poison_isolated={poisoned}")
        slot = (f"truncated scan's slot holds HostLibraryMissingError "
                f"(serving.poison_isolated={poisoned})")
    check(res[1][4] == res[0][4], "a healthy slot next to the truncated "
          "one changed")
    print(f"phase 3: 420 {sum(len(b) for b in res)} outputs are 256x256 "
          f"3-component JPEGs; {slot}", flush=True)

    # entropy round trip and device step vs its plain version
    step = check_plain_step("420", pipe, batches[0])
    enc = pipe.encode_entropy(*step)
    lib = binding.load()
    i16p = ctypes.POINTER(ctypes.c_int16)
    for i in (0, BATCH - 1):
        comps = [np.zeros((32, 32, 64), np.int16)] + [
            np.zeros((16, 16, 64), np.int16) for _ in range(2)]
        qt = np.zeros((4, 64), np.uint16)
        arr = np.frombuffer(enc[i], np.uint8)
        rc = lib.lp_jpeg_decode_coefs_fast(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size,
            (i16p * 3)(*[c.ctypes.data_as(i16p) for c in comps]),
            qt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), 1)
        check(rc == 0, f"re-decode of output {i} failed ({rc})")
        for c, s in zip(comps, step):
            check(np.array_equal(c, s[i][:c.shape[0], :c.shape[1]]),
                  f"entropy round trip of output {i} is lossy")
    print(f"phase 3: 420 entropy round trip of outputs 0 and {BATCH - 1}: "
          "coefficients equal", flush=True)
    check_cpu_step("420", pipe, fixture)
    return counts


def phase3(path, pipe, fixture):
    """Returns the launch counts of the main path's run."""
    if path == "420":
        return phase3_420(pipe, fixture)
    batches = [[fixture] * BATCH for _ in range(2)]
    pipe.transcode([fixture] * 2)              # warm: pools, tables, cuBLAS
    res, counts = run_main_path(path, pipe, batches)
    check_outputs(path, res)
    print(f"phase 3: {path} {sum(len(b) for b in res)} outputs are "
          f"{DST}x{DST} {PATHS[path].ncomp}-component "
          f"{'PNG' if is_png_path(path) else 'JPEG'}s", flush=True)
    check_plain_step(path, pipe, batches[0])
    check_cpu_step(path, pipe, fixture)
    return counts


def bound(inputs, outputs, blocks):
    """(ms, 'bytes' or 'operations'): the least time an H100 SXM takes for
    a kernel's work on these tensors at data-sheet peaks: every input read
    once and every output written once, against the IDCT's multiply-adds
    (2 * 64 * 64 FLOP per 8x8 block)."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in tuple(inputs) + tuple(outputs))
    t_bytes, t_ops = nbytes / HBM_BPS, 2 * 64 * 64 * blocks / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def device_spans(fn):
    """(sorted (start, end) of every device-side event of fn(), host wall
    us) under torch.profiler, through utils.profile_complete: the session
    opens as utils.device_trace opens it (a burn-in of one-element
    kernels, whose records, before fn's, are left out), and one that kept
    fewer device kernel records than fn's kernel launches (a session
    opened late in a long process may drop its first records,
    tools/torch_profiler_drops.py) is thrown away and fn runs again in a
    fresh session; a second drop fails the phase, naming the counts."""
    import torch
    from torch.profiler import record_function
    from lilliput_tpu_torch.utils import RecordsDropped, profile_complete
    wall = []

    def run():
        with record_function("chip_smoke.device_spans"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append(1e6 * (time.perf_counter() - t0))
    try:
        events = profile_complete(run).profile.events()
    except RecordsDropped as e:
        raise SmokeFailure(str(e)) from e
    start = min(e.time_range.start for e in events
                if e.name == "chip_smoke.device_spans")
    return sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.time_range.start >= start), wall[-1]


def complete_trace(fn, log_dir, what):
    """(path, events, TraceRecords) of a Chrome trace of fn() that
    utils.profile_complete wrote to log_dir, from the first torch.profiler
    session that kept a device record of every kernel launch and copy of
    fn (a second session that dropped records fails the phase, naming the
    counts)."""
    from lilliput_tpu_torch.utils import RecordsDropped, profile_complete
    try:
        tr = profile_complete(fn, log_dir=log_dir)
    except RecordsDropped as e:
        raise SmokeFailure(f"{what}: {e}") from e
    with open(tr.path) as f:
        return tr.path, json.load(f)["traceEvents"], tr.records


class Busy(NamedTuple):
    """A busy share and the count of device records it was read from, of
    a session that kept a record of every kernel launch."""
    share: float
    records: int


def busy_share(fn) -> Busy:
    """Device busy share of fn() under torch.profiler: the union of the
    device-side events' intervals over the host clock's window, with the
    number of device records."""
    spans, wall_us = device_spans(fn)
    check(bool(spans), "torch.profiler recorded no device events")
    busy, lo, hi = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    return Busy((busy + hi - lo) / wall_us, len(spans))


def kernel_times(name, serving):
    """The kernel and its plain version at the serving shape; for
    dequant_idct_blocks the u8 epilogue the path runs, and the f32 epilogue
    beside the PyTorch call computing that function."""
    import torch
    from lilliput_tpu_torch.ops import decode_kernels as DK
    kernel = getattr(DK, name)
    t = {}
    if name == IDCT:
        coefs, wq = serving
        ref = DK.dequant_idct_blocks_reference
        t["kernel_ms"] = cuda_ms(lambda: kernel(coefs, wq, out="u8"), 10)
        t["plain_ms"] = cuda_ms(lambda: ref(coefs, wq, out="u8"), 10)
        t["f32_ms"] = cuda_ms(lambda: kernel(coefs, wq), 10)
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
        b = coefs.shape[0]
        flat = coefs.reshape(b, -1, 64).to(torch.float32)
        base = torch.full_like(flat, 128.0)
        t["library_ms"] = cuda_ms(lambda: torch.baddbmm(base, flat, wq), 10)
        del flat, base
        t["bound_ms"], t["bound_by"] = bound(
            serving, [kernel(coefs, wq, out="u8")], coefs.numel() // 64)
        t["f32_bound_ms"], t["f32_bound_by"] = bound(
            serving, [kernel(coefs, wq)], coefs.numel() // 64)
    else:
        h2, v2 = KERNELS[name][2]
        t["kernel_ms"] = cuda_ms(lambda: kernel(*serving), 10)
        t["plain_ms"] = cuda_ms(
            lambda: DK.decode_ycc_reference(*serving, h2, v2), 10)
        t["library_ms"] = t["f32_ms"] = None
        t["bound_ms"], t["bound_by"] = bound(
            serving, kernel(*serving),
            sum(c.numel() // 64 for c in serving[:3]))
    return t


def phase4(path, pipe, bufs, serving, card):
    name = PATHS[path].kernel
    t = kernel_times(name, serving) if name else {}
    args = pipe.decode_entropy(bufs)
    coefs = args[:pipe.ncomp]
    t["h2d_ms"] = cuda_ms(lambda: [pipe._to_device(a) for a in coefs], 5)
    t["device_step_ms"] = cuda_ms(lambda: pipe.device_step(*args), 10)
    if path in ("420", "420_exact"):
        t.update(stage_breakdown_420(pipe, bufs, args))
    # the step's own decode, resize and encode stages, dispatch and fetch
    # (CUDA events; the direct modes' decode is their IDCTs)
    from lilliput_tpu_torch.utils import Metrics, measure_device_stages
    t["device_stages"] = measure_device_stages(pipe, bufs, iters=3,
                                               registry=Metrics())
    t0 = time.perf_counter()
    pipe.transcode_pipelined([bufs] * 4)
    t["pipelined_ips"] = 4 * BATCH / (time.perf_counter() - t0)
    t["device_busy_share"] = busy_share(
        lambda: pipe.transcode_pipelined([bufs] * 2))
    for k, v in t.items():
        print(f"phase 4: {path} {k}={v!r} [{card}]", flush=True)
    return t


def stage_breakdown_420(pipe, bufs, args):
    """4:2:0's D2H of a step's outputs, and its host entropy decode and
    encode rates (images/s, 8 threads)."""
    t = {}
    out = pipe.device_step(*args)
    t["d2h_ms"] = cuda_ms(lambda: [o.cpu() for o in out], 5)
    t0 = time.perf_counter()
    for _ in range(3):
        pipe.decode_entropy(bufs, pool=True)
    t["host_decode_ips"] = 3 * BATCH / (time.perf_counter() - t0)
    coefs = [o.cpu().numpy() for o in out]
    t0 = time.perf_counter()
    for _ in range(3):
        pipe.encode_entropy(*coefs)
    t["host_encode_ips"] = 3 * BATCH / (time.perf_counter() - t0)
    return t


def still_kernel(info) -> str:
    """The kernel a JpegDecoder of this header launches: the layout's
    decode kernel, dequant_idct_blocks for grayscale."""
    from lilliput_tpu_torch.ops import decode_kernels as DK
    if info.num_components == 1:
        return IDCT
    return DK.kernel_for(info.comp_h_samp[0] // info.comp_h_samp[1] == 2,
                         info.comp_v_samp[0] // info.comp_v_samp[1] == 2)


def plain_still(dec):
    """The plain version of a JpegDecoder's frame, (H, W, C) u8, taken
    from a stack of two copies of its coefficients (see plain_decode)."""
    import torch
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    info = dec._info
    h, w = info.height, info.width

    def two(c, get):
        t = get(c)
        return torch.stack([t, t])
    if info.num_components == 1:
        return K.decode_gray(two(0, dec._coef), two(0, dec._qtable), h, w,
                             plain=True)[0][..., None]
    planes = K.decode_ycc_420(
        *(two(c, dec._coef) for c in range(3)),
        *(two(c, dec._qtable) for c in range(2)), h, w,
        info.comp_h_samp[0] // info.comp_h_samp[1] == 2,
        info.comp_v_samp[0] // info.comp_v_samp[1] == 2, plain=True)
    return torch.stack([p[0] for p in planes], dim=-1)


def still_args(dec):
    """A JpegDecoder's coefficients and folded tables as its kernel's
    batch-1 arguments."""
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    n = 1 if dec._info.num_components == 1 else 3
    return (tuple(dec._coef(c)[None] for c in range(n))
            + tuple(K.fold_qtables(dec._qtable(c)) for c in range(min(n, 2))))


def _gate(what, got, ref, limits, unit, phase=5):
    mx, nd, n = diff_stats(got, ref)
    print(f"phase {phase}: {what}: max_abs_diff={mx} differing={nd}/{n} "
          f"({nd / n:.3g}) {unit}", flush=True)
    check(mx <= limits[0] and nd <= limits[1] * n, f"{what} disagrees")


def still_times(fixture, reps: int = 5, fmts=(".jpeg", ".png")):
    """Host-clock ms per image of the single-image surface's stages on the
    card, each ended by a sync: decode (header, host Huffman or inflate
    and parse, H2D, the kernel), transform (orientation and Fit), encode
    to each of `fmts` (device stages, D2H, host entropy)."""
    import torch
    from lilliput_tpu_torch import Framebuffer, new_decoder, new_encoder
    t = {}
    t0 = time.perf_counter()
    for _ in range(reps):
        dec = new_decoder(fixture, device=DEVICE)
        fb = Framebuffer()
        dec.decode_to(fb)
        torch.cuda.synchronize()
    t["decode_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        x = Framebuffer(fb.array)
        x.orientation_transform(dec.header().orientation)
        out = x.fit(DST, DST)
        torch.cuda.synchronize()
    t["transform_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    for fmt in fmts:
        enc = new_encoder(fmt, dec)
        t0 = time.perf_counter()
        for _ in range(reps):
            enc.encode(out, {})
        t[f"encode{fmt.replace('.', '_')}_ms"] = (
            1e3 * (time.perf_counter() - t0) / reps)
    return t


def phase5(card, kernels):
    """The single-image surface: new_decoder -> ImageOps.transform to
    .jpeg and .png (Fit 256x256) for each still, with the launch counts 0
    just before and read just after; then the comparisons and times.
    Adds the launches to `kernels` and each kernel's batch-1 whole-frame
    times (still_ms, still_plain_ms, still_bound_ms)."""
    import torch
    from lilliput_tpu_torch import (Framebuffer, ImageOps, ImageOptions,
                                    ResizeMethod, new_decoder)
    from lilliput_tpu_torch.ops import decode_kernels as DK

    def opts(fmt):
        return ImageOptions(file_type=fmt, width=DST, height=DST,
                            resize_method=ResizeMethod.FIT)
    timed = set()
    for still in STILLS:
        with open(os.path.join(ASSETS, still), "rb") as f:
            fixture = f.read()
        dec = new_decoder(fixture, device=DEVICE)
        kernel = still_kernel(dec._info)
        want = {k: int(k == kernel) for k in DK.launches}
        outs = {}
        DK.reset_launches()
        for fmt in (".jpeg", ".png", "decode_to"):
            before = dict(DK.launches)
            if fmt == "decode_to":
                fb = Framebuffer()
                dec.decode_to(fb)
            else:
                outs[fmt] = ImageOps(8192).transform(
                    new_decoder(fixture, device=DEVICE), opts(fmt))
            check({k: DK.launches[k] - before[k] for k in before} == want,
                  f"{still} {fmt}: {kernel} did not launch exactly once "
                  f"(or another kernel launched)")
        counts = dict(DK.launches)
        print(f"phase 5: {still} transform .jpeg, .png and decode_to: "
              f"launches={counts}", flush=True)
        kernels[kernel]["launches"] += counts[kernel]
        kernels[kernel]["still_launches"] = (
            kernels[kernel].get("still_launches", 0) + counts[kernel])

        gate = (KERNEL_MAX_DIFF, KERNEL_MAX_SHARE)
        cpu = Framebuffer()
        new_decoder(fixture, device="cpu").decode_to(cpu)
        _gate(f"{still} decode vs plain decode (2-image stack)", [fb.array],
              [plain_still(dec)], gate, "u8")
        _gate(f"{still} decode vs CPU decode", [fb.array],
              [cpu.array.to(DEVICE)], gate, "u8")
        cpu_outs = {fmt: ImageOps(8192).transform(
            new_decoder(fixture, device="cpu"), opts(fmt))
            for fmt in (".jpeg", ".png")}
        got, ref = png_pixels(outs[".png"]), png_pixels(cpu_outs[".png"])
        check(got.shape == ref.shape == (DST, DST, dec.header().channels),
              f"{still} .png is {got.shape}")
        _gate(f"{still} .png pixels vs CPU", [torch.from_numpy(got)],
              [torch.from_numpy(ref)], gate, "u8")
        _gate(f"{still} .jpeg coefficients vs CPU",
              [torch.from_numpy(c) for c in jpeg_coefs(outs[".jpeg"])],
              [torch.from_numpy(c) for c in jpeg_coefs(cpu_outs[".jpeg"])],
              (STEP_MAX_DIFF, STEP_MAX_SHARE), "coefficients")
        t = still_times(fixture)
        if kernel not in timed:
            timed.add(kernel)
            k = kernel_times(kernel, still_args(dec))
            kernels[kernel].update(still_ms=k["kernel_ms"],
                                   still_plain_ms=k["plain_ms"],
                                   still_bound_ms=k["bound_ms"])
            t.update({f"{kernel}_batch1_{n}": v for n, v in k.items()})
        for n, v in t.items():
            print(f"phase 5: {still} {n}={v!r} [{card}]", flush=True)
        del dec, fb, cpu
        torch.cuda.empty_cache()


def phase6(card):
    """The overlap check: in one transcode_pipelined of 4 batches on 4:2:0,
    every _to_host of batch i-1 must return while step i's event is still
    pending. Prints images/s and the busy share."""
    from lilliput_tpu_torch import JpegTranscodePipeline
    with open(os.path.join(ASSETS, PATHS["420"].fixture), "rb") as f:
        fixture = f.read()
    pipe = JpegTranscodePipeline(fixture, DST, DST, quality=85,
                                 device=DEVICE)
    bufs = [fixture] * BATCH
    pipe.transcode_pipelined([bufs] * 2)      # warm: both slots of each pool
    fetches, pending = [], []
    fetch0, to_host0 = pipe._fetch, pipe._to_host

    def fetch(dev):
        fetches.append(fetch0(dev))
        return fetches[-1]

    def to_host(f):
        arrs = to_host0(f)
        i = next(k for k, g in enumerate(fetches) if g is f)
        if i + 1 < len(fetches):
            pending.append(not all(e.query() for e in fetches[i + 1].events))
        return arrs
    pipe._fetch, pipe._to_host = fetch, to_host
    t0 = time.perf_counter()
    res = pipe.transcode_pipelined([bufs] * 4)
    ips = 4 * BATCH / (time.perf_counter() - t0)
    del pipe._fetch, pipe._to_host
    check_outputs("420", res)
    print(f"phase 6: 420 transcode_pipelined 4x{BATCH}: step i still "
          f"pending when _to_host(i-1) returned: {pending}", flush=True)
    check(len(pending) == 3 and all(pending), "transcode_pipelined waited "
          "for step i before returning batch i-1's outputs")
    busy = busy_share(lambda: pipe.transcode_pipelined([bufs] * 4))
    print(f"phase 6: 420 pipelined_ips={ips!r} device_busy_share={busy!r} "
          f"[{card}]", flush=True)


#: the thumbhash grids' bound between the card and the CPU: twice the
#: worst-case error of either side's f32 sums (two products of 100-term
#: sums over a 100x100 plane of values within [-1, 1], scaled by 1/10^4:
#: 2 * 100 * 100 * 100 * 2^-24 / 10^4 each)
THUMB_GRID_ATOL = 2.4e-5
#: phase 7's JPEG inputs: committed fixture, the Adobe transform byte to
#: set (None: as committed), launches of dequant_idct_blocks per decode
STILL_JPEGS = {"jpeg_rgb": ("bench_1080p_rgb.jpg", None, 3),
               "jpeg_cmyk": ("bench_1080p_cmyk.jpg", None, 4),
               "jpeg_ycck": ("bench_1080p_cmyk.jpg", 2, 4)}


def fixture_pixels(fixture: str) -> np.ndarray:
    """A committed fixture's pixels, (H, W, C) u8 BGR or gray, decoded by
    the port on the CPU."""
    from lilliput_tpu_torch import Framebuffer, new_decoder
    fb = Framebuffer()
    with open(os.path.join(ASSETS, fixture), "rb") as f:
        new_decoder(f.read(), device="cpu").decode_to(fb)
    return fb.to_numpy()


def alpha_ramp(h: int, w: int) -> np.ndarray:
    """(h, w, 1) alpha rising from 0 at the left edge to 255 at the
    right."""
    return np.broadcast_to(
        (np.arange(w) * 255 // (w - 1)).astype(np.uint8)[None, :, None],
        (h, w, 1))


def png_inputs(bgr, gray) -> dict:
    """PNG RGB8, RGBA8 (alpha_ramp) and gray8 of BGR and gray pixels
    (tests/_torch_still_builders.png_bytes: filter type 0)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_still_builders import png_bytes
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    return {"png_rgb8": png_bytes(rgb, 2),
            "png_rgba8": png_bytes(np.concatenate(
                [rgb, alpha_ramp(*rgb.shape[:2])], axis=-1), 6),
            "png_gray8": png_bytes(gray, 0)}


def still_inputs():
    """Phase 7's inputs at 1080p, name -> (bytes, launches of
    dequant_idct_blocks per decode): the JCS_RGB and CMYK fixtures, YCCK
    (the CMYK stream with the Adobe transform byte set to 2), PNG (RGB8,
    RGBA8, gray8, palette8 of a fixed 3-3-2 quantization, RGB16, Adam7;
    filter type 0), and BMP, PNM, PAM, Sun Raster, HDR and PFM from the
    port's encoders, with buffers packed by tests/_torch_still_builders.py
    for what they do not write (BMP 565 bitfields and RLE8, 16-bit PPM, a
    Sun Raster colormap). The
    pixels are bench_1080p.jpg's and bench_1080p_gray.jpg's, decoded by
    the port on the CPU."""
    from lilliput_tpu_torch import Framebuffer, new_encoder
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_still_builders import (bmp_bytes, bmp_rle8, bmp_rows,
                                       png_bytes, pnm16, sunras_bytes)
    out = {}
    for name, (fixture, transform, n) in STILL_JPEGS.items():
        with open(os.path.join(ASSETS, fixture), "rb") as f:
            buf = f.read()
        if transform is not None:
            b = bytearray(buf)
            b[buf.index(b"\xff\xee\x00\x0eAdobe") + 15] = transform
            buf = bytes(b)
        out[name] = (buf, n)

    bgr, gray = fixture_pixels("bench_1080p.jpg"), fixture_pixels(
        "bench_1080p_gray.jpg")
    h, w = bgr.shape[:2]
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    alpha = alpha_ramp(h, w)
    i = np.arange(256)
    pal = np.stack([(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7,
                    (i & 3) * 255 // 3], axis=1)          # RGB
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    idx = ((r >> 5) << 5 | (g >> 5) << 2 | (b >> 6)).astype(np.uint8)
    word = (r >> 3) << 11 | (g >> 2) << 5 | (b >> 3)
    out.update(png_inputs(bgr, gray))
    out.update({
        "png_palette8": png_bytes(idx[..., None], 3, palette=pal),
        "png_rgb16": png_bytes(rgb.astype(np.uint16) * 257, 2, 16),
        "png_adam7": png_bytes(rgb, 2, interlace=1),
        "bmp_565": bmp_bytes(w, h, 16, bmp_rows(np.stack(
            [word & 255, word >> 8], axis=-1).reshape(h, -1).astype(
                np.uint8)), compression=3, masks=(0xF800, 0x07E0, 0x001F)),
        "bmp_rle8": bmp_bytes(w, h, 8, bmp_rle8(idx), pal[:, ::-1],
                              compression=1),
        "ppm16": pnm16(rgb.astype(np.uint16) * 257),
        "ras_palette": sunras_bytes(w, h, 8, idx.tobytes(), 1, pal),
    })
    for name, ext, px in (("bmp_24", ".bmp", bgr),
                          ("bmp_32", ".bmp", np.concatenate([bgr, alpha],
                                                            axis=-1)),
                          ("ppm", ".ppm", bgr), ("pgm", ".pgm", gray),
                          ("pam", ".pam", bgr), ("ras_24", ".ras", bgr),
                          ("hdr", ".hdr", bgr), ("pfm", ".pfm", bgr)):
        out[name] = new_encoder(ext).encode(
            Framebuffer.from_array(px, device="cpu"), {})
    return {k: v if isinstance(v, tuple) else (v, 0) for k, v in out.items()}


PHASE7_FMTS = (".jpeg", ".png", ".thumbhash")


def _still_output(buf, device, fmt):
    """ImageOps.transform of `buf` on `device` to `fmt`, Fit 256x256."""
    from lilliput_tpu_torch import (ImageOps, ImageOptions, ResizeMethod,
                                    new_decoder)
    return ImageOps(8192).transform(
        new_decoder(buf, device=device), ImageOptions(
            file_type=fmt, width=DST, height=DST,
            resize_method=ResizeMethod.FIT))


def _plain_frame(dec):
    """A JpegDecoder's frame from the plain versions, taken from a stack
    of two copies of its coefficients and tables (queue 3 entry 7)."""
    import torch

    def two(get):
        return lambda c: torch.stack([get(c), get(c)])
    return dec.frame(two(dec._coef), two(dec._qtable), plain=True)[0]


def phase7(card, kernels):
    """The still formats: for each of still_inputs(), decode on the card
    and on the CPU (0 differing values), ImageOps.transform to .jpeg,
    .png and .thumbhash on both (.png and .thumbhash bytes equal, .jpeg
    coefficients under the step gate), with the launch counts 0 just
    before each decode and read just after: dequant_idct_blocks exactly
    3 (JCS_RGB) or 4 (CMYK, YCCK) times per decode, no kernel for the
    other formats; a JPEG's frame equals its plain version (2-image stack)
    under the kernel gate. Then thumbhash_batch of tiles on the card
    (phase7_thumbhash_batch), one CLI run of the PNG input to .jpeg on
    the card, whose bytes must equal -device cpu's, and the times."""
    import torch
    from lilliput_tpu_torch import Framebuffer, new_decoder
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    t0 = time.perf_counter()
    inputs = still_inputs()
    print(f"phase 7: {len(inputs)} inputs built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gate = (KERNEL_MAX_DIFF, KERNEL_MAX_SHARE)
    launched = 0
    for name, (buf, n) in inputs.items():
        want = {k: n if k == IDCT else 0 for k in DK.launches}
        dec = new_decoder(buf, device=DEVICE)
        fb = Framebuffer()
        DK.reset_launches()
        dec.decode_to(fb)
        got = dict(DK.launches)
        check(got == want, f"{name}: launches {got}, want {want}")
        cpu = Framebuffer()
        new_decoder(buf, device="cpu").decode_to(cpu)
        mx, nd, nv = diff_stats([fb.array], [cpu.array.to(DEVICE)])
        print(f"phase 7: {name} {fb.width}x{fb.height}x{fb.channels} "
              f"launches={got} decode vs CPU: max_abs_diff={mx} "
              f"differing={nd}/{nv}", flush=True)
        check(fb.array.shape == cpu.array.shape and nd == 0,
              f"{name}: the card's decode differs from the CPU's")
        if n:
            ref = _plain_frame(dec)
            _gate(f"{name} planes vs plain decode (2-image stack)",
                  [fb.array[..., c] for c in range(3)],
                  [ref[..., c] for c in range(3)], gate, "u8", 7)
        outs = {}
        for fmt in PHASE7_FMTS:
            before = dict(DK.launches)
            outs[fmt] = _still_output(buf, DEVICE, fmt)
            delta = {k: DK.launches[k] - before[k] for k in before}
            check(delta == want, f"{name} {fmt}: launches {delta}")
        launched += DK.launches[IDCT]
        ref = {fmt: _still_output(buf, "cpu", fmt) for fmt in PHASE7_FMTS}
        for fmt in (".png", ".thumbhash"):
            check(outs[fmt] == ref[fmt], f"{name} {fmt} bytes differ from "
                  f"the CPU port's")
        _gate(f"{name} .jpeg coefficients vs CPU",
              [torch.from_numpy(c) for c in jpeg_coefs(outs[".jpeg"])],
              [torch.from_numpy(c) for c in jpeg_coefs(ref[".jpeg"])],
              (STEP_MAX_DIFF, STEP_MAX_SHARE), "coefficients", 7)
        print(f"phase 7: {name} .png and .thumbhash bytes equal the CPU "
              f"port's; .jpeg bytes equal: {outs['.jpeg'] == ref['.jpeg']}",
              flush=True)
        t = still_times(buf, fmts=PHASE7_FMTS)
        if name == "jpeg_cmyk":
            k = kernel_times(IDCT, (dec._coef(0)[None],
                                    K.fold_qtables(dec._qtable(0))))
            kernels[IDCT].update(cmyk_batch1_f32_ms=k["f32_ms"],
                                 cmyk_batch1_library_ms=k["library_ms"],
                                 cmyk_batch1_f32_bound_ms=k["f32_bound_ms"])
            t.update({f"{IDCT}_cmyk_plane_batch1_{m}": v
                      for m, v in k.items()})
        for m, v in t.items():
            print(f"phase 7: {name} {m}={v!r} [{card}]", flush=True)
        del dec, fb, cpu
        torch.cuda.empty_cache()
    kernels[IDCT]["launches"] += launched
    kernels[IDCT]["still_formats_launches"] = launched
    phase7_thumbhash_batch(card, inputs["png_rgba8"][0])
    phase7_cli(inputs["png_rgb8"][0])


def phase7_thumbhash_batch(card, png: bytes, tile: int = 100):
    """thumbhash_batch of the RGBA PNG input cut into 100x100 BGRA tiles
    (its alpha ramp, then the same tiles opaque), as a spritesheet's, on
    the card against the CPU: the coefficient grids within
    THUMB_GRID_ATOL, and equal hashes for every tile whose hash the
    grids' measured difference cannot change (thumbhash.order_dependent:
    an AC zero in exact arithmetic sits on a rounding tie); ms per batch
    (mean of 5)."""
    from lilliput_tpu_torch import Framebuffer, new_decoder
    from lilliput_tpu_torch.codecs import thumbhash as TH
    fb = Framebuffer()
    new_decoder(png, device="cpu").decode_to(fb)
    px = fb.to_numpy()
    ty, tx = px.shape[0] // tile, px.shape[1] // tile
    tiles = px[:ty * tile, :tx * tile].reshape(
        ty, tile, tx, tile, 4).swapaxes(1, 2).reshape(-1, tile, tile, 4)
    opaque = tiles.copy()
    opaque[..., 3] = 255
    tiles = np.concatenate([tiles, opaque])
    grids, _ = TH.batch_grids(tiles, device=DEVICE)
    ref_grids, sums = TH.batch_grids(tiles, device="cpu")
    err = max(float(np.abs(g - r).max()) for g, r in zip(grids, ref_grids))
    got = TH.thumbhash_batch(tiles, device=DEVICE)
    ref = TH.thumbhash_batch(tiles, device="cpu")
    ties = [TH.order_dependent(TH.hash_fields(ref_grids, sums, i, tile,
                                              tile), err)
            for i in range(len(tiles))]
    nd = sum(a != b for a, b in zip(got, ref))
    bad = sum(a != b and not t for a, b, t in zip(got, ref, ties))
    t0 = time.perf_counter()
    for _ in range(5):
        TH.thumbhash_batch(tiles, device=DEVICE)
    ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"phase 7: thumbhash_batch of {len(tiles)} {tile}x{tile} tiles on "
          f"{DEVICE}: grids max_abs_diff={err!r} vs the CPU's; {nd} of "
          f"{len(got)} hashes differ, {bad} of them on a tile without a "
          f"tie ({sum(ties)} tiles with one); ms per batch={ms!r} [{card}]",
          flush=True)
    check(err <= THUMB_GRID_ATOL, "thumbhash_batch grids on the card are "
          "not within THUMB_GRID_ATOL of the CPU's")
    check(bad == 0, "thumbhash_batch on the card differs from the CPU's on "
          "a tile without a rounding tie")


def phase7_cli(png: bytes):
    """python -m lilliput_tpu_torch of the PNG input to a 256x256 .jpeg,
    in this process, on the card and with -device cpu: equal bytes."""
    import tempfile
    from lilliput_tpu_torch import cli
    outs = {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".phase7_") as d:
        src = os.path.join(d, "in.png")
        with open(src, "wb") as f:
            f.write(png)
        for dev in (DEVICE, "cpu"):
            dst = os.path.join(d, f"out_{dev}.jpg")
            rc = cli.main(["-input", src, "-output", dst, "-width",
                           str(DST), "-height", str(DST), "-device", dev])
            check(rc == 0, f"the CLI on {dev} exited {rc}")
            with open(dst, "rb") as f:
                outs[dev] = f.read()
    print(f"phase 7: CLI png -> jpeg on {DEVICE} and cpu: "
          f"{len(outs[DEVICE])} and {len(outs['cpu'])} bytes, equal: "
          f"{outs[DEVICE] == outs['cpu']}", flush=True)
    check(outs[DEVICE] == outs["cpu"], "the CLI's .jpeg on the card differs "
          "from -device cpu's")


#: phase 8's serving shape: GIF_ANIMS animations on GIF_SIZE^2 canvases,
#: of GIF_FRAMES frames (bucket 32) but every eighth of GIF_SHORT (bucket
#: 24), to GIF_DST^2 .gif (the avatar resize); GIF_CPU of them also on the
#: CPU port (among them two short ones)
GIF_ANIMS, GIF_SIZE, GIF_FRAMES, GIF_SHORT, GIF_DST = 32, 480, 32, 20, 128
GIF_CPU = (0, 7, 13, 31)


def gif_inputs():
    """Phase 8's inputs: GIF_ANIMS GIF89a animations panning across
    bench_1080p.jpg's pixels (decoded by the port on the CPU) and one
    1920x1080 GIF of 4 frames, written by
    tests/_torch_gif_builders.pan_gif: a 3-3-2 global palette and every
    fourth frame on a local 6x6x6 one, partial rects (one running off the
    canvas), a transparent index on every third frame, disposals 1, 2, 3,
    0 in turn, an interlaced frame, loop and comment extensions; the LZW
    streams are dictionary LZW, written by the port's C++ GIF encoder
    (codec=True), as a real GIF's are."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_gif_builders import pan_gif
    rgb = np.ascontiguousarray(fixture_pixels("bench_1080p.jpg")[..., ::-1])
    anims = [pan_gif(rgb, GIF_SIZE, GIF_SIZE,
                     GIF_SHORT if k % 8 == 7 else GIF_FRAMES, start=11 * k,
                     codec=True)
             for k in range(GIF_ANIMS)]
    return anims, pan_gif(rgb, rgb.shape[1], rgb.shape[0], 4, codec=True)


def gif_stage_times(anims, card, reps: int = 3):
    """transcode_gif_batch of `anims` called directly `reps` times with
    its stage clock on (stage_times): each stage's ms per group, the mean
    over the reps (CUDA events around device stages, the host clock
    around host ones; see utils.StageClock). Returns the bytes of the
    last call for the caller to check."""
    from lilliput_tpu_torch import pipeline as TP
    times = {}
    for _ in range(reps):
        out = TP.transcode_gif_batch(anims, GIF_DST, GIF_DST, fit=True,
                                     device=DEVICE, stage_times=times)
    for name, ms in times.items():
        per = len(ms) // reps
        means = [sum(ms[g::per]) / reps for g in range(per)]
        print(f"phase 8: transcode_gif_batch stage {name}: ms per group "
              f"{means!r} (mean of {reps}) [{card}]", flush=True)
    return out


def phase8(card):
    """GIF: AnimatedTranscodePipeline(128, 128, ".gif").transcode of
    GIF_ANIMS 480x480 animations on the card, with every launch count 0
    just before the phase and read just after (the GIF path launches none
    of the five kernels). Its outputs must equal per-animation
    transcode_gif on the card byte for byte, the CPU port's bytes for
    GIF_CPU, decode (the port's GifDecoder on the CPU) to 128x128 frames
    of the source's frame count, and for animation 0 equal the streaming
    ImageOps(8192).transform(new_decoder(buf), RESIZE 128x128 ".gif"); a
    corrupt GIF in a batch fails only its own slot. The 1920x1080 GIF
    through ImageOps.transform to .jpeg, .png and .thumbhash at Fit
    256x256 on the card: the CPU port's bytes (.jpeg: coefficients under
    the step gate). Every timed transcode must run as the batch's groups
    (serving.anim_groups), and transcode_gif_batch called directly must
    give the pipeline's bytes. Times: the stages of each group
    (gif_stage_times), output frames/s of the whole transcode, peak
    device memory, the device's busy share, the single-image stages of
    the 1080p GIF."""
    import torch
    from lilliput_tpu_torch import (AnimatedTranscodePipeline, Framebuffer,
                                    ImageOps, ImageOptions, ResizeMethod,
                                    new_decoder)
    from lilliput_tpu_torch import pipeline as TP
    from lilliput_tpu_torch.codecs.gif import GifDecoder
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.ops import palette as P
    from lilliput_tpu_torch.utils import metrics
    t0 = time.perf_counter()
    anims, still = gif_inputs()
    counts = [GifDecoder(b, device="cpu").frame_count() for b in anims]
    print(f"phase 8: {len(anims)} {GIF_SIZE}x{GIF_SIZE} GIFs of "
          f"{sum(counts)} frames ({sum(map(len, anims))} bytes) and a "
          f"1920x1080 GIF of 4 frames built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    pipe = AnimatedTranscodePipeline(GIF_DST, GIF_DST, ".gif",
                                     device=DEVICE)
    buckets = collections.Counter(P.frame_bucket(c) for c in counts)
    n_groups = sum(-(-n // TP._MAX_ANIM_LANES) for n in buckets.values())

    def batched():
        """pipe.transcode(anims) with a check that it ran as n_groups
        batch groups (the per-item path, where the batch failed, would
        run one group per animation)."""
        before = metrics.snapshot()["counters"].get("serving.anim_groups", 0)
        res = pipe.transcode(anims)
        ran = metrics.snapshot()["counters"].get("serving.anim_groups",
                                                  0) - before
        check(ran == n_groups, f"the transcode ran {ran} groups, not the "
              f"batch's {n_groups}")
        return res
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    DK.reset_launches()
    t0 = time.perf_counter()
    outs = batched()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    again = batched()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(again == outs, "two runs of the batch differ")
    for k, (buf, o) in enumerate(zip(anims, outs)):
        check(isinstance(o, bytes), f"animation {k} failed: {o!r}")
        check(o == TP.transcode_gif(buf, GIF_DST, GIF_DST, fit=True,
                                    device=DEVICE),
              f"animation {k}: the batch differs from transcode_gif")
    print(f"phase 8: {len(outs)} outputs equal per-animation transcode_gif "
          f"on {DEVICE}", flush=True)
    for k in GIF_CPU:
        check(outs[k] == TP.transcode_gif(anims[k], GIF_DST, GIF_DST,
                                          fit=True, device="cpu"),
              f"animation {k}: the card's bytes differ from the CPU port's")
    print(f"phase 8: animations {GIF_CPU} equal the CPU port's bytes",
          flush=True)
    for k, o in enumerate(outs):
        d, n = GifDecoder(o, device="cpu"), 0
        while True:
            fb = Framebuffer()
            try:
                d.decode_to(fb)
            except EOFError:
                break
            check(fb.array.shape == (GIF_DST, GIF_DST, 4),
                  f"output {k} frame {n} is {tuple(fb.array.shape)}")
            n += 1
        check(n == counts[k], f"output {k} has {n} frames, not {counts[k]}")
    stream = ImageOps(8192).transform(
        new_decoder(anims[0], device=DEVICE), ImageOptions(
            file_type=".gif", width=GIF_DST, height=GIF_DST,
            resize_method=ResizeMethod.RESIZE, encode_timeout=600.0))
    check(stream == outs[0], "the streaming transform differs from the "
          "batch on animation 0")
    res = pipe.transcode([anims[0], anims[1][:len(anims[1]) // 3],
                          anims[2]], return_exceptions=True)
    check(res[0] == outs[0] and res[2] == outs[2]
          and isinstance(res[1], Exception), "a corrupt GIF in the batch "
          "did not fail only its own slot")
    print(f"phase 8: outputs decode to {GIF_DST}x{GIF_DST} with the "
          f"sources' frame counts; streaming == batch on animation 0; the "
          f"corrupt GIF failed alone ({type(res[1]).__name__})", flush=True)
    outs_still = {fmt: _still_output(still, DEVICE, fmt)
                  for fmt in PHASE7_FMTS}
    ref = {fmt: _still_output(still, "cpu", fmt) for fmt in PHASE7_FMTS}
    for fmt in (".png", ".thumbhash"):
        check(outs_still[fmt] == ref[fmt], f"1080p GIF {fmt} bytes differ "
              f"from the CPU port's")
    _gate("1080p GIF .jpeg coefficients vs CPU",
          [torch.from_numpy(c) for c in jpeg_coefs(outs_still[".jpeg"])],
          [torch.from_numpy(c) for c in jpeg_coefs(ref[".jpeg"])],
          (STEP_MAX_DIFF, STEP_MAX_SHARE), "coefficients", 8)
    print(f"phase 8: peak device memory of the batch "
          f"{peak / 2**20!r} MiB; first transcode {first_s!r} s; "
          f"transcode of {sum(counts)} frames {wall!r} s, "
          f"{sum(counts) / wall!r} output frames/s [{card}]", flush=True)
    share = busy_share(batched)
    print(f"phase 8: device busy share of the transcode {share!r} "
          f"[{card}]", flush=True)
    check(gif_stage_times(anims, card) == outs, "transcode_gif_batch "
          "called directly differs from the pipeline's bytes")
    for m, v in still_times(still, fmts=PHASE7_FMTS).items():
        print(f"phase 8: 1080p GIF {m}={v!r} [{card}]", flush=True)
    launched = dict(DK.launches)
    print(f"phase 8: launches over the phase {launched}", flush=True)
    check(not any(launched.values()), "the GIF path launched a kernel")


#: phase 9's mix, all to DST x DST Fit .jpeg q85: source -> requests.
#: JPEG sources are the committed fixtures (the 720p one the port's own
#: 1280x720 stretch of bench_1080p.jpg), the PNGs png_inputs() of the
#: 1080p fixtures' pixels, the GIF gif_inputs()'s 1080p one; mix_inputs()
#: adds a truncated 4:2:0 scan, a truncated PNG RGB8 and a RIFF/WEBP
#: header. Shuffled with MIX_SEED.
MIX = {"420": 64, "422": 16, "440": 16, "444": 16, "gray_o6": 16, "gray": 8,
       "o6": 8, "420_720p": 16, "png_rgb8": 16, "png_rgba8": 8,
       "png_gray8": 4, "gif": 2}
MIX_SEED = 14
#: the kernel launches of one transcode of the mix: one per JPEG group of
#: each layout (4:2:0 at 1080p, 1080p o6 and 720p), dequant_idct_blocks'
#: u8 epilogue for the gray o6 group; none for gray upright and the stills
MIX_LAUNCHES = {"decode420": 3, "decode422": 1, "decode440": 1,
                "decode444": 1, "dequant_idct_blocks": 1}
#: StillTranscodePipeline's own run: batches of STILL_BATCH 1080p PNG RGB8
STILL_BATCH = 128
#: the first-request latency's two new 4:2:0 geometries (cold, warmed)
NEW_GEOMS = ((1600, 900), (1440, 810))


def _stretched_jpeg(fixture: bytes, w: int, h: int) -> bytes:
    """The port's own ImageOps stretch of a JPEG to w x h .jpeg at q85
    (4:2:0), on DEVICE."""
    from lilliput_tpu_torch import (JPEG_QUALITY, ImageOps, ImageOptions,
                                    ResizeMethod, new_decoder)
    return ImageOps(8192).transform(
        new_decoder(fixture, device=DEVICE), ImageOptions(
            file_type=".jpeg", width=w, height=h,
            resize_method=ResizeMethod.RESIZE,
            encode_options={JPEG_QUALITY: 85}))


def mix_inputs():
    """Phase 9's mix: (sources, labels, bufs, groups), where sources maps
    each source to its bytes, labels[i] names request i's source
    ("broken" for the three broken inputs) and groups[i] the signature
    group it joins (None for the WebP header, which fails routing)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_gif_builders import pan_gif
    sources = {}
    for name in ("420", "422", "440", "444", "gray_o6", "gray", "o6"):
        fixture = ("bench_1080p.jpg" if name == "420"
                   else f"bench_1080p_{name}.jpg")
        with open(os.path.join(ASSETS, fixture), "rb") as f:
            sources[name] = f.read()
    sources["420_720p"] = _stretched_jpeg(sources["420"], 1280, 720)
    bgr = fixture_pixels("bench_1080p.jpg")
    sources.update(png_inputs(bgr, fixture_pixels("bench_1080p_gray.jpg")))
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    sources["gif"] = pan_gif(rgb, rgb.shape[1], rgb.shape[0], 4, codec=True)
    jpeg, png = sources["420"], sources["png_rgb8"]
    sources["broken_jpeg"] = jpeg[:len(jpeg) // 2]   # scan cut
    sources["broken_png"] = png[:len(png) // 2]
    sources["broken_webp"] = b"RIFF\x00\x00\x00\x00WEBPVP8 " + bytes(8)
    items = [(name, name) for name, n in MIX.items() for _ in range(n)]
    items += [("broken_jpeg", "420"), ("broken_png", "png_rgb8"),
              ("broken_webp", None)]
    order = np.random.default_rng(MIX_SEED).permutation(len(items))
    items = [items[i] for i in order]
    labels = [k for k, _ in items]
    return (sources, labels, [sources[k] for k in labels],
            [g for _, g in items])


def _mix_groups(groups):
    """signature group -> the request indices in it, in input order."""
    out = {}
    for i, g in enumerate(groups):
        if g is not None:
            out.setdefault(g, []).append(i)
    return out


def _mix_signature_pipe(sources, group):
    """The per-signature pipeline of a group, on DEVICE."""
    from lilliput_tpu_torch import (JpegTranscodePipeline,
                                    StillTranscodePipeline)
    cls = (StillTranscodePipeline if group.startswith(("png", "gif"))
           else JpegTranscodePipeline)
    return cls(sources[group], DST, DST, quality=85, device=DEVICE)


def _mix_specs(sources):
    """warm() specs of the mix's twelve signatures: JPEG geometry tuples
    (synthetic_jpeg), samples for the oriented sources and the GIF, PNG
    tuples (a zero-pixel PNG of the channel count)."""
    return [(1920, 1080, "420"), (1920, 1080, "422"), (1920, 1080, "440"),
            (1920, 1080, "444"), sources["gray_o6"],
            (1920, 1080, "420", True), sources["o6"], (1280, 720, "420"),
            ("png", 1920, 1080, 3), ("png", 1920, 1080, 4),
            ("png", 1920, 1080, 1), sources["gif"]]


def phase9(card, kernels):
    """The mixed serving front: MultiGeometryPipeline(DST, DST, q85) on
    the card over the shuffled MIX, with every launch count 0 just before
    its first transcode and read just after (MIX_LAUNCHES exactly). Gates:
    every healthy output byte-identical to its per-signature
    JpegTranscodePipeline or StillTranscodePipeline on the card, in input
    order; the broken slots hold exceptions (the WebP one
    HostLibraryMissingError where libwebp's header is absent, else
    InvalidImageError) and only they; stats() reads twelve signatures built and cached, one
    hit per other routed request and again that many on a second call,
    which gives the same bytes, no eviction; with max_geometries=4 the
    evictions are counted and the bytes unchanged; each .jpeg output's
    coefficients within the step gate of MultiGeometryPipeline(...,
    device="cpu") on the batch; a fresh front warmed from the twelve
    signatures serves the mix without building a pipeline. Prints images/s
    (mean of 3 after warming), each group's host decode, device_step (CUDA
    events) and encode ms, the busy share and the peak device memory,
    the first-request latency of a new 4:2:0 geometry cold against
    warmed, and StillTranscodePipeline over STILL_BATCH 1080p PNG RGB8:
    host decode, H2D, device_step and transcode_pipelined images/s."""
    import torch
    from lilliput_tpu_torch import MultiGeometryPipeline
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.utils import metrics
    t0 = time.perf_counter()
    from lilliput_tpu_torch import binding
    sources, labels, bufs, groups = mix_inputs()
    by_group = _mix_groups(groups)
    # the truncated scan decodes through libjpeg where libjpeg exists
    have_jpeg = os.path.exists(binding.JPEG_HEADER)
    broken = [i for i, k in enumerate(labels) if k.startswith("broken")
              and not (have_jpeg and k == "broken_jpeg")]
    n_ok = len(bufs) - len(broken)
    print(f"phase 9: {len(bufs)} requests of {len(by_group)} signatures and "
          f"{len(broken)} broken inputs built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    metrics.reset()
    mg = MultiGeometryPipeline(DST, DST, quality=85, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    DK.reset_launches()
    t0 = time.perf_counter()
    outs = mg.transcode(bufs, return_exceptions=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = dict(DK.launches)
    print(f"phase 9: first transcode of the mix {first_s!r} s; "
          f"launches={launched}", flush=True)
    check(launched == MIX_LAUNCHES, f"the mix launched {launched}, not "
          f"{MIX_LAUNCHES}")
    for k, n in launched.items():
        kernels[k]["launches"] += n
        kernels[k]["mix_launches"] = n

    # the broken slots, and only they, hold exceptions
    failed = [i for i, o in enumerate(outs) if not isinstance(o, bytes)]
    check(failed == broken, f"failed slots {failed}, broken {broken}")
    from lilliput_tpu_torch.errors import (HostLibraryMissingError,
                                           InvalidImageError)
    webp = outs[labels.index("broken_webp")]
    check(isinstance(webp, InvalidImageError
                     if os.path.exists(binding.WEBP_HEADER)
                     else HostLibraryMissingError),
          f"the WebP slot holds {webp!r}")
    cut = outs[labels.index("broken_jpeg")]
    check(isinstance(cut, bytes) if have_jpeg
          else isinstance(cut, HostLibraryMissingError),
          f"the truncated scan's slot holds {cut!r}")
    print(f"phase 9: broken slots: "
          f"{[(labels[i], type(outs[i]).__name__) for i in broken]}; the "
          f"truncated scan's: {type(cut).__name__}", flush=True)

    # stats: one build per signature, a hit per other routed request. The
    # WebP header fails routing; so does the truncated PNG if it comes
    # before every healthy PNG RGB8 (its signature's pipeline would be
    # built from it, and refuses it), at the cost of one more build
    png_first = int(labels.index("broken_png") < labels.index("png_rgb8"))
    routed = len(bufs) - 1 - png_first
    st = mg.stats()
    want = {"geometries_cached": len(by_group),
            "compiles": len(by_group) + png_first,
            "hits": routed - len(by_group), "evictions": 0}
    check({k: st[k] for k in want} == want, f"stats {st}, want {want}")
    again = mg.transcode(bufs, return_exceptions=True)
    st2 = mg.stats()
    want.update(hits=want["hits"] + len(bufs) - 1)
    check({k: st2[k] for k in want} == want,
          f"stats after a second call {st2}, want {want}")
    check([a for a in again if isinstance(a, bytes)]
          == [o for o in outs if isinstance(o, bytes)],
          "a second transcode of the mix gave other bytes")
    print(f"phase 9: stats after one call {st}; after two {st2}", flush=True)

    # gate 1: each group equals its per-signature pipeline on the card
    for g, idx in by_group.items():
        res = _mix_signature_pipe(sources, g).transcode(
            [bufs[i] for i in idx], return_exceptions=True)
        for i, r in zip(idx, res):
            if i not in broken:
                check(r == outs[i], f"request {i} ({labels[i]}) differs "
                      f"from its per-signature pipeline")
    print(f"phase 9: {n_ok} outputs equal their per-signature pipelines "
          f"on {DEVICE}, in input order", flush=True)

    # the LRU at max_geometries=4: evictions counted, bytes unchanged
    metrics.reset()
    small = MultiGeometryPipeline(DST, DST, quality=85, max_geometries=4,
                                  device=DEVICE)
    t0 = time.perf_counter()
    lru = small.transcode(bufs, return_exceptions=True)
    lru_s = time.perf_counter() - t0
    st4 = small.stats()
    check(st4["evictions"] > 0 and st4["geometries_cached"] == 4,
          f"max_geometries=4: {st4}")
    check(all(a == b for a, b in zip(lru, outs) if isinstance(b, bytes)),
          "max_geometries=4 changed the bytes")
    print(f"phase 9: max_geometries=4: {st4}, bytes unchanged, "
          f"{lru_s!r} s", flush=True)
    del small, lru

    # gate 5: the CPU front on the same batch
    t0 = time.perf_counter()
    cpu = MultiGeometryPipeline(DST, DST, quality=85,
                                device="cpu").transcode(
        bufs, return_exceptions=True)
    cpu_s = time.perf_counter() - t0
    worst = (0, 0, 0)
    for i, (o, c) in enumerate(zip(outs, cpu)):
        if i in broken:
            check(not isinstance(c, bytes), f"request {i} ({labels[i]}) "
                  "did not fail on the CPU")
            continue
        mx, nd, n = diff_stats(
            [torch.from_numpy(a) for a in jpeg_coefs(o)],
            [torch.from_numpy(a) for a in jpeg_coefs(c)])
        check(mx <= STEP_MAX_DIFF and nd <= STEP_MAX_SHARE * n,
              f"request {i} ({labels[i]}) differs from the CPU front: "
              f"max {mx}, {nd}/{n} coefficients")
        worst = max(worst, (mx, nd, n))
    print(f"phase 9: .jpeg coefficients vs MultiGeometryPipeline on the CPU "
          f"({cpu_s!r} s there): worst max_abs_diff={worst[0]} "
          f"differing={worst[1]}/{worst[2]}; bytes equal in "
          f"{sum(o == c for o, c in zip(outs, cpu) if isinstance(o, bytes))}"
          f" of {n_ok}", flush=True)
    del cpu

    # gate 6: a fresh front warmed from the twelve signatures
    fresh = MultiGeometryPipeline(DST, DST, quality=85, device=DEVICE)
    metrics.reset()
    rep = fresh.warm(_mix_specs(sources))
    built = fresh.stats()["compiles"]
    check(rep["compiled_new"] == len(by_group) == built,
          f"warm() built {rep}, stats {fresh.stats()}")
    served = fresh.transcode(bufs, return_exceptions=True)
    check(all(a == b for a, b in zip(served, outs) if isinstance(b, bytes)),
          "the warmed front's bytes differ")
    check(fresh.stats()["compiles"] == built, f"the warmed front built "
          f"{fresh.stats()['compiles'] - built} pipelines on the mix")
    print(f"phase 9: warm() of {len(by_group)} signatures {rep}; the mix "
          f"built no pipeline after it", flush=True)
    del fresh

    # times, after warming
    torch.cuda.synchronize()
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        mg.transcode(bufs, return_exceptions=True)
        reps.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    share = busy_share(lambda: mg.transcode(bufs, return_exceptions=True))
    print(f"phase 9: mix of {len(bufs)} requests: {n_ok} outputs in "
          f"{reps!r} s, {n_ok * 3 / sum(reps)!r} images/s (mean of 3); "
          f"busy share {share!r}; peak device memory "
          f"{peak / 2**20!r} MiB [{card}]", flush=True)
    mix_group_times(mg, bufs, groups, card)
    first_request_latency(sources, card)
    still_batch_times(sources, card)


def mix_group_times(mg, bufs, groups, card, reps: int = 5):
    """Each signature group's stages in mg.transcode of the mix, with its
    stage clock on (stage_times): host decode and encode (host clock) and
    device_step (CUDA events), ms per group, the mean of reps calls and
    each call's."""
    times = {}
    for _ in range(reps):
        mg.transcode(bufs, return_exceptions=True, stage_times=times)
    check(len(times) == len(_mix_groups(groups)) and all(
        sorted(t) == ["device_step", "encode", "host_decode"]
        and all(len(v) == reps for v in t.values())
        for t in times.values()), f"stage_times recorded {times}")
    for idx, t in times.items():
        stages = ", ".join(f"{k} {sum(t[k]) / reps!r} ms (calls {t[k]!r})"
                           for k in ("host_decode", "device_step", "encode"))
        print(f"phase 9: group {groups[idx[0]]} x{len(idx)}: {stages} "
              f"[{card}]", flush=True)


def first_request_latency(sources, card):
    """The first request of a new 4:2:0 geometry: cold (the front builds
    its pipeline and tables on it) against warmed (warm() of its geometry
    tuple first), host clock to the bytes; two geometries neither has
    seen, so one's warm-up cannot serve the other."""
    import torch
    from lilliput_tpu_torch import MultiGeometryPipeline
    (cw, ch), (ww, wh) = NEW_GEOMS
    cold_buf = _stretched_jpeg(sources["420"], cw, ch)
    warm_buf = _stretched_jpeg(sources["420"], ww, wh)
    torch.cuda.synchronize()
    mg = MultiGeometryPipeline(DST, DST, quality=85, device=DEVICE)
    t0 = time.perf_counter()
    cold = mg.transcode([cold_buf])
    cold_ms = 1e3 * (time.perf_counter() - t0)
    mg.warm([(ww, wh, "420")])
    t0 = time.perf_counter()
    warm = mg.transcode([warm_buf])
    warm_ms = 1e3 * (time.perf_counter() - t0)
    check(all(isinstance(o, bytes) for o in cold + warm),
          "a new geometry's first request failed")
    print(f"phase 9: first request of a new 4:2:0 geometry: cold "
          f"{cw}x{ch} {cold_ms!r} ms, warmed {ww}x{wh} {warm_ms!r} ms "
          f"[{card}]", flush=True)


def still_batch_times(sources, card):
    """StillTranscodePipeline over STILL_BATCH 1080p PNG RGB8: host decode
    ms per image on the decode threads against one image alone, H2D and
    device_step (CUDA events), transcode_pipelined images/s over 2
    batches (host clock)."""
    import torch
    from lilliput_tpu_torch import StillTranscodePipeline
    png = sources["png_rgb8"]
    pipe = StillTranscodePipeline(png, DST, DST, quality=85, device=DEVICE)
    bufs = [png] * STILL_BATCH
    t0 = time.perf_counter()
    for _ in range(3):
        pipe._decode_one(png)
    alone_ms = 1e3 * (time.perf_counter() - t0) / 3
    pipe.decode_pixels(bufs, pool=True)          # the pool's first slot
    t0 = time.perf_counter()
    (px,), _ = pipe._host_decode(bufs)
    batch_ms = 1e3 * (time.perf_counter() - t0)
    # the same with one intra-op thread per decode thread: does torch's
    # CPU pool oversubscribe the host under the decode threads?
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        pipe.decode_pixels(bufs, pool=True)
        single_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        torch.set_num_threads(threads)
    h2d_ms = cuda_ms(lambda: pipe._to_device(px), 3)
    step_ms = cuda_ms(lambda: pipe.device_step(px), 3)
    pipe.transcode_pipelined([bufs] * 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipe.transcode_pipelined([bufs] * 2)
    ips = 2 * STILL_BATCH / (time.perf_counter() - t0)
    check(all(isinstance(o, bytes) for b in res for o in b),
          "StillTranscodePipeline failed an item")
    print(f"phase 9: StillTranscodePipeline {STILL_BATCH}x PNG RGB8 "
          f"{pipe.src_w}x{pipe.src_h}: host decode {batch_ms / STILL_BATCH!r}"
          f" ms per image on {min(8, os.cpu_count() or 1)} threads "
          f"({batch_ms!r} ms per batch) against {alone_ms!r} ms alone "
          f"(torch intra-op threads {threads}; with 1: "
          f"{single_ms / STILL_BATCH!r} ms per image); H2D "
          f"{h2d_ms!r} ms; device_step {step_ms!r} ms; transcode_pipelined "
          f"{ips!r} images/s [{card}]", flush=True)


#: phase 10's JPEG 2000 inputs: the 9/7 tile, the Jp2Encoder ratio, and
#: the still front's requests (JP2_STILL of JP2_DISTINCT lossless images)
JP2_TILE = (256, 256)
JP2_RATE = 10000
JP2_STILL, JP2_DISTINCT = 16, 4
#: the inputs whose decode phase 10 times (mean of 3) on the card and CPU
JP2_TIMED = ("lossless", "rate10", "tiled_97")


def jp2_inputs():
    """Phase 10's inputs, name -> bytes, 1080p from bench_1080p.jpg's
    pixels (bench_1080p_gray.jpg's for gray), written by the port's own
    encoder on DEVICE (the card's machine has no PIL or OpenJPEG):
    lossless 5/3 RGB; 9/7 RGB through Jp2Encoder with JPEG2000_RATE
    JP2_RATE; 5/3 gray; 5/3 RGBA (alpha_ramp); 9/7 in JP2_TILE tiles; the
    lossless stream with its colr box patched to sYCC (enumcs 18, as
    tests/test_jp2.py patches it); the lossless stream cut in half. Also
    returns the three more lossless RGB images of the still front (the
    pixels mirrored, flipped, and the 4:4:4 fixture's)."""
    import struct
    import torch
    from lilliput_tpu_torch import Framebuffer, JPEG2000_RATE, new_encoder
    from lilliput_tpu_torch.codecs.jp2_enc import encode_jp2
    bgr = fixture_pixels("bench_1080p.jpg")
    gray = fixture_pixels("bench_1080p_gray.jpg")
    rgb = torch.from_numpy(np.ascontiguousarray(bgr[..., ::-1])).to(DEVICE)
    alpha = torch.from_numpy(np.ascontiguousarray(
        alpha_ramp(*bgr.shape[:2]))).to(DEVICE)
    out = {"lossless": encode_jp2(rgb),
           "rate10": new_encoder(".jp2").encode(
               Framebuffer.from_array(bgr, device=DEVICE),
               {JPEG2000_RATE: JP2_RATE}),
           "gray": encode_jp2(torch.from_numpy(
               np.ascontiguousarray(gray[..., 0])).to(DEVICE)),
           "rgba": encode_jp2(torch.cat([rgb, alpha], -1)),
           "tiled_97": encode_jp2(rgb, reversible=False, tile=JP2_TILE)}
    sycc = bytearray(out["lossless"])
    i = bytes(sycc).find(b"colr")
    sycc[i + 7:i + 11] = struct.pack(">I", 18)
    out["sycc"] = bytes(sycc)
    out["truncated"] = out["lossless"][:len(out["lossless"]) // 2]
    b444 = fixture_pixels("bench_1080p_444.jpg")
    more = [encode_jp2(rgb.flip(1)), encode_jp2(rgb.flip(0)),
            encode_jp2(torch.from_numpy(np.ascontiguousarray(
                b444[..., ::-1])).to(DEVICE))]
    return out, more


def _jp2_decode(buf, device, times=None):
    from lilliput_tpu_torch import Framebuffer
    from lilliput_tpu_torch.codecs.jp2 import Jp2Decoder
    fb = Framebuffer()
    Jp2Decoder(buf, device=device, stage_times=times).decode_to(fb)
    return fb


def phase10(card):
    """JPEG 2000 (no kernel: Tier-2 in Python and Tier-1 in C++ on the
    host, the dequantization, wavelet, colour transforms and decode tail
    as torch ops on the device), with every launch count 0 just before the
    phase and read just after (none may launch). Gates, on jp2_inputs():
    decode_to on the card equals device="cpu" with 0 differing values on
    every input (9/7 and sYCC included) and the truncated one fails alike;
    ImageOps.transform to .jpeg, .png and .jp2 (Fit 256x256) equals the
    CPU port's bytes (.jpeg: coefficients under the step gate); the .jp2
    encode of the card's 1080p frame equals the CPU's bytes and decodes
    back to it; one CLI run of the lossless input to .jpg on the card
    equals -device cpu's bytes; StillTranscodePipeline(256, 256) over
    JP2_STILL requests of JP2_DISTINCT lossless images equals the CPU
    front; MultiGeometryPipeline(256, 256) over the healthy inputs and
    the truncated one fails that slot alone, every other output equal to
    its per-signature pipeline's. Prints ms per image of decode on the
    card and on the CPU (mean of 3) split into the host's Tier-2 + Tier-1
    and the device tail (CUDA events), the tiled input's device events
    (device_spans), ms of the .jp2 encodes and the still front's
    images/s."""
    import torch
    from lilliput_tpu_torch import (Framebuffer, MultiGeometryPipeline,
                                    StillTranscodePipeline, new_decoder,
                                    new_encoder)
    from lilliput_tpu_torch.ops import decode_kernels as DK
    t_phase = time.perf_counter()
    DK.reset_launches()
    t0 = time.perf_counter()
    inputs, more = jp2_inputs()
    print(f"phase 10: {len(inputs)} inputs and {len(more)} more lossless "
          f"images written on {DEVICE} in {time.perf_counter() - t0:.1f}s: "
          f"{ {k: len(v) for k, v in inputs.items()} } bytes", flush=True)
    healthy = [k for k in inputs if k != "truncated"]

    # decode_to: the card against the CPU, 0 differing values
    frames = {}
    for name in healthy:
        fb, cpu = (_jp2_decode(inputs[name], d) for d in (DEVICE, "cpu"))
        mx, nd, nv = diff_stats([fb.array], [cpu.array.to(DEVICE)])
        print(f"phase 10: {name} {fb.width}x{fb.height}x{fb.channels} "
              f"decode vs CPU: max_abs_diff={mx} differing={nd}/{nv}",
              flush=True)
        check(fb.array.device.type == torch.device(DEVICE).type
              and fb.array.shape == cpu.array.shape and nd == 0,
              f"jp2 {name}: the card's decode differs from the CPU's")
        frames[name] = fb
    errs = []
    for dev in (DEVICE, "cpu"):
        try:
            _jp2_decode(inputs["truncated"], dev)
            errs.append(None)
        except Exception as e:  # noqa: BLE001 -- compared below
            errs.append(type(e).__name__)
    check(errs[0] == errs[1] == "DecodingFailedError",
          f"the truncated JP2 raised {errs}")

    # ImageOps.transform: .png and .jp2 bytes equal, .jpeg coefficients
    for name in healthy:
        for fmt in (".jpeg", ".png", ".jp2"):
            got, ref = (_still_output(inputs[name], d, fmt)
                        for d in (DEVICE, "cpu"))
            if fmt == ".jpeg":
                _gate(f"jp2 {name} .jpeg coefficients vs CPU",
                      [torch.from_numpy(c) for c in jpeg_coefs(got)],
                      [torch.from_numpy(c) for c in jpeg_coefs(ref)],
                      (STEP_MAX_DIFF, STEP_MAX_SHARE), "coefficients", 10)
            else:
                check(got == ref, f"jp2 {name} {fmt} bytes differ from the "
                      "CPU port's")
    print(f"phase 10: ImageOps.transform of {len(healthy)} inputs to .jpeg, "
          f".png and .jp2 on {DEVICE}: .png and .jp2 bytes equal the CPU "
          f"port's", flush=True)

    # the .jp2 encode of the card's 1080p frame
    enc_ms = {}
    for name, opts in (("lossless", {}), ("rate10", {1000: JP2_RATE})):
        fb = frames[name]
        cpu_fb = Framebuffer.from_array(fb.to_numpy(), device="cpu")
        t0 = time.perf_counter()
        got = new_encoder(".jp2").encode(fb, opts)
        enc_ms[name] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        ref = new_encoder(".jp2").encode(cpu_fb, opts)
        enc_ms[name + "_cpu"] = 1e3 * (time.perf_counter() - t0)
        check(got == ref, f"jp2 .jp2 encode of the card's {name} frame "
              "differs from the CPU's")
        if name == "lossless":
            back = _jp2_decode(got, DEVICE)
            check(torch.equal(back.array, fb.array), "the card's lossless "
                  ".jp2 does not decode back to its frame")
    print(f"phase 10: .jp2 encode of the 1080p frames: bytes equal the "
          f"CPU's, lossless decodes back; ms {enc_ms!r} [{card}]",
          flush=True)

    # the CLI, lossless -> .jpg
    import tempfile
    from lilliput_tpu_torch import cli
    outs = {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".phase10_") as d:
        src = os.path.join(d, "in.jp2")
        with open(src, "wb") as f:
            f.write(inputs["lossless"])
        for dev in (DEVICE, "cpu"):
            dst = os.path.join(d, f"out_{dev}.jpg")
            rc = cli.main(["-input", src, "-output", dst, "-width",
                           str(DST), "-height", str(DST), "-device", dev])
            check(rc == 0, f"the CLI on {dev} exited {rc}")
            with open(dst, "rb") as f:
                outs[dev] = f.read()
    check(outs[DEVICE] == outs["cpu"], "the CLI's .jpg of a JP2 on the card "
          "differs from -device cpu's")
    print(f"phase 10: CLI jp2 -> jpg on {DEVICE} and cpu: "
          f"{len(outs[DEVICE])} bytes, equal", flush=True)

    # the still front: JP2_STILL requests of JP2_DISTINCT lossless images
    distinct = [inputs["lossless"]] + more
    bufs = [distinct[i % JP2_DISTINCT] for i in range(JP2_STILL)]
    pipe = StillTranscodePipeline(bufs[0], DST, DST, quality=85,
                                  device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipe.transcode(bufs)
    torch.cuda.synchronize()
    ips = JP2_STILL / (time.perf_counter() - t0)
    cpu_res = StillTranscodePipeline(bufs[0], DST, DST, quality=85,
                                     device="cpu").transcode(bufs)
    worst = (0, 0, 0)
    for o, c in zip(res, cpu_res):
        mx, nd, n = diff_stats([torch.from_numpy(a) for a in jpeg_coefs(o)],
                               [torch.from_numpy(a) for a in jpeg_coefs(c)])
        check(mx <= STEP_MAX_DIFF and nd <= STEP_MAX_SHARE * n,
              "the JP2 still front on the card differs from the CPU's")
        worst = max(worst, (mx, nd, n))
    print(f"phase 10: StillTranscodePipeline {JP2_STILL}x of {JP2_DISTINCT} "
          f"1080p lossless JP2: {ips!r} images/s; .jpeg coefficients vs the "
          f"CPU front worst max_abs_diff={worst[0]} differing="
          f"{worst[1]}/{worst[2]}, bytes equal in "
          f"{sum(a == b for a, b in zip(res, cpu_res))} of {JP2_STILL} "
          f"[{card}]", flush=True)

    # the mixed front: the healthy inputs and the truncated one; each
    # signature group against its pipeline on the same members
    names = healthy + ["truncated"]
    mix = [inputs[k] for k in names]
    outs = MultiGeometryPipeline(DST, DST, quality=85, device=DEVICE
                                 ).transcode(mix, return_exceptions=True)
    failed = [names[i] for i, o in enumerate(outs)
              if not isinstance(o, bytes)]
    check(failed == ["truncated"], f"the JP2 mix failed {failed}")
    groups = {}
    for i, buf in enumerate(mix):
        h = new_decoder(buf, device="cpu").header()
        groups.setdefault((h.width, h.height, h.channels), []).append(i)
    for idx in groups.values():
        solo = StillTranscodePipeline(mix[idx[0]], DST, DST, quality=85,
                                      device=DEVICE).transcode(
            [mix[i] for i in idx], return_exceptions=True)
        for i, o in zip(idx, solo):
            if names[i] != "truncated":
                check(o == outs[i], f"jp2 {names[i]}: the mixed front "
                      "differs from its per-signature pipeline")
    print(f"phase 10: MultiGeometryPipeline over {len(mix)} JP2 requests "
          f"({len(groups)} signatures): only the truncated slot failed "
          f"({type(outs[-1]).__name__}); the others equal their "
          f"per-signature pipelines", flush=True)

    # times: decode on the card and the CPU, split host / device tail
    for name in JP2_TIMED:
        for dev in (DEVICE, "cpu"):
            times = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                _jp2_decode(inputs[name], dev, times)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / 3
            split = {k: sum(v) / len(v) for k, v in times.items()}
            tail = split["device_synthesis"] + split["device_convert"]
            print(f"phase 10: {name} decode_to on {dev}: {ms!r} ms per "
                  f"image (mean of 3); host Tier-2 + Tier-1 "
                  f"{split['host_tier2_tier1']!r} ms, device tail "
                  f"{tail!r} ms (synthesis {split['device_synthesis']!r}, "
                  f"conversions {split['device_convert']!r}) [{card}]",
                  flush=True)
    n_ev = len(device_spans(
        lambda: _jp2_decode(inputs["tiled_97"], DEVICE))[0])
    n_one = len(device_spans(
        lambda: _jp2_decode(inputs["rate10"], DEVICE))[0])
    print(f"phase 10: device events of one decode_to: tiled_97 ({JP2_TILE} "
          f"tiles) {n_ev}, rate10 (one tile) {n_one}", flush=True)
    launched = {k: v for k, v in DK.launches.items() if v}
    check(not launched, f"phase 10 launched {launched}")
    print(f"phase 10: no kernel launched; phase took "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)


#: phase 11: the .webp step's batch and fixture, the still front's batch of
#: each PNG kind, the composite's animations (WEBP_ANIMS x WEBP_FRAMES on a
#: WEBP_CANVAS canvas to WEBP_DST), the CPU reference's lanes per chunk
WEBP_STILL_BATCH = 4
WEBP_ANIMS, WEBP_FRAMES, WEBP_CANVAS, WEBP_DST = 16, 32, 480, 128
WEBP_CPU_CHUNK = 4
WEBP_FIXTURE = "anim_96x80.webp"


def webp_anim_inputs(seed: int = 11, anims: "int | None" = None,
                     frames: "int | None" = None,
                     canvas: "int | None" = None):
    """Phase 11's composite inputs, made in numpy from `seed`: WEBP_ANIMS
    animations of WEBP_FRAMES // 2 + 1 to WEBP_FRAMES frames (padded to the frame bucket
    with inert frames: no-blend, nothing drawn) on a WEBP_CANVAS canvas,
    as pipeline._webp_anim_inputs scatters them. Frame 0 covers the
    canvas; the others are sub-rects of bench_1080p's pixels at offsets
    that may be negative or run past the canvas (clipped as the host
    assembly clips them), with partial alpha, blend 0 or 1 and dispose 0
    or 1. anims, frames and canvas replace WEBP_ANIMS, WEBP_FRAMES and
    WEBP_CANVAS. Returns the dict of stacked arrays (_WEBP_INPUTS)."""
    from lilliput_tpu_torch import pipeline as TP
    from lilliput_tpu_torch.ops import palette as P
    anims = WEBP_ANIMS if anims is None else anims
    frames = WEBP_FRAMES if frames is None else frames
    rng = np.random.default_rng(seed)
    bgr = fixture_pixels("bench_1080p.jpg")
    c = WEBP_CANVAS if canvas is None else canvas
    nb = P.frame_bucket(frames)
    stack = {"frames": np.zeros((anims, nb, c, c, 4), np.uint8),
             "drawn": np.zeros((anims, nb, c, c), bool),
             "blends": np.ones((anims, nb), np.int32),
             "pdisp": np.zeros((anims, nb), np.int32),
             "prects": np.zeros((anims, nb, c, c), bool)}
    for a in range(anims):
        n = int(rng.integers(frames // 2 + 1, frames + 1))
        prev, prev_disp = None, 0
        for k in range(n):
            if k == 0:
                x, y, w, h = 0, 0, c, c
            else:
                w, h = (int(v) for v in rng.integers(16, c, 2))
                x, y = (int(v) for v in rng.integers(-w // 2, c - w // 2, 2))
            sy, sx = (int(rng.integers(0, bgr.shape[i] - d))
                      for i, d in ((0, h), (1, w)))
            px = np.empty((h, w, 4), np.uint8)
            px[..., :3] = bgr[sy:sy + h, sx:sx + w]
            px[..., 3] = (255 if k == 0 else rng.choice(
                [0, 64, 128, 200, 255], (h, w)).astype(np.uint8))
            mask, (x2, y2, w2, h2) = TP._rect_mask(x, y, w, h, c, c)
            if w2 > 0 and h2 > 0:
                stack["frames"][a, k, y2:y2 + h2, x2:x2 + w2] = px[
                    y2 - y:y2 - y + h2, x2 - x:x2 - x + w2]
            stack["drawn"][a, k] = mask
            if prev is not None:
                stack["prects"][a, k] = TP._rect_mask(*prev, c, c)[0]
            stack["blends"][a, k] = int(rng.integers(0, 2))
            stack["pdisp"][a, k] = prev_disp
            prev, prev_disp = (x, y, w, h), int(rng.integers(0, 2))
    return stack


def phase11(card, kernels):
    """WebP: the yuv420 emit, the still front, the value sweep, the
    animated composite and the host route, every launch count 0 just
    before the phase and read just after (decode420 once per .webp step of
    the 4:2:0 fixture, nothing else).

    (a) JpegTranscodePipeline(bench_1080p.jpg, DST, DST, q85, ".webp"):
    its emit is yuv420, one batch-128 device_step launches decode420
    exactly once and no other kernel, its planes are (128, 256, 256) and
    (128, 128, 128) u8; on 2 images they equal the CPU port's .webp step
    (0 differing values) and, on the card, webp_yuv420_from_packed of the
    .png pipeline's packed pixels of the same batch. Prints the emit's ms
    (CUDA events), the .webp and .png steps' ms, and the D2H bytes and ms
    of the planes against the packed pixels.
    (b) StillTranscodePipeline(DST, DST, ".webp") steps over 1080p PNG
    RGB8 (yuv420 emit) and RGBA8 (pixels emit) sources equal the CPU
    port's steps (0 differing values).
    (c) webp_yuv420_from_packed of every u8 value (the sweep of
    tests/test_webp.py:187-198), at 1x1, 5x7 and 33x47 and over a batch,
    equals the CPU port's.
    (d) _webp_batch_to_pixels over webp_anim_inputs() (composite, no crop,
    AREA to WEBP_DST) on the card equals the CPU port's (0 differing
    values); prints its ms, the H2D's and the device events.
    (e) Where libwebp's header is absent, new_decoder of tests/assets/
    WEBP_FIXTURE, new_encoder(".webp"), transcode_webp, the .webp
    pipeline's transcode and GIF -> .webp each raise
    HostLibraryMissingError; where it is present their card bytes equal
    the CPU port's."""
    import torch
    from lilliput_tpu_torch import (JpegTranscodePipeline,
                                    StillTranscodePipeline, new_decoder,
                                    new_encoder)
    from lilliput_tpu_torch import binding
    from lilliput_tpu_torch import pipeline as TP
    from lilliput_tpu_torch.errors import HostLibraryMissingError
    from lilliput_tpu_torch.ops import color as C
    from lilliput_tpu_torch.ops import decode_kernels as DK
    t_phase = time.perf_counter()
    have_webp = os.path.exists(binding.WEBP_HEADER)
    print(f"phase 11: {binding.WEBP_HEADER} "
          f"{'present' if have_webp else 'absent'}", flush=True)
    DK.reset_launches()

    # (a) the yuv420 emit on the main path
    with open(os.path.join(ASSETS, "bench_1080p.jpg"), "rb") as f:
        fixture = f.read()
    bufs = [fixture] * BATCH
    webp = JpegTranscodePipeline(fixture, DST, DST, quality=85,
                                 output_format=".webp", device=DEVICE)
    png = JpegTranscodePipeline(fixture, DST, DST, quality=85,
                                output_format=".png", device=DEVICE)
    check(webp._emit == "yuv420", f"the .webp emit is {webp._emit}")
    args = webp.decode_entropy(bufs)
    before = dict(DK.launches)
    planes = webp.device_step(*args)
    torch.cuda.synchronize()
    step = {k: v - before[k] for k, v in DK.launches.items()}
    check(step == {**dict.fromkeys(step, 0), "decode420": 1},
          f"one .webp device step launched {step}")
    shapes = [(tuple(p.shape), p.dtype) for p in planes]
    half = DST // 2
    check(shapes == [((BATCH, DST, DST), torch.uint8)]
          + [((BATCH, half, half), torch.uint8)] * 2,
          f"the .webp step's planes are {shapes}")
    packed = png.device_step(*args)[0]
    for p, q in zip(planes, C.webp_yuv420_from_packed(packed)):
        check(torch.equal(p, q), "the .webp planes differ from the yuv420 "
              "conversion of the .png step's pixels")
    cpu = JpegTranscodePipeline(fixture, DST, DST, quality=85,
                                output_format=".webp", device="cpu")
    two = cpu.decode_entropy(bufs[:2])
    for p, q in zip(webp.device_step(*two), cpu.device_step(*two)):
        mx, nd, n = diff_stats([p.cpu()], [q])
        check(nd == 0, f"the .webp planes differ from the CPU port's in "
              f"{nd} of {n} values (max {mx})")
    emit_ms = cuda_ms(lambda: C.webp_yuv420_from_packed(packed), 10)
    webp_ms = cuda_ms(lambda: webp.device_step(*args), 10)
    png_ms = cuda_ms(lambda: png.device_step(*args), 10)
    yuv_bytes = sum(p.numel() for p in planes)
    bgra_bytes = packed.numel() * packed.element_size()

    def d2h(ts):
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in ts]
        return cuda_ms(lambda: [h.copy_(t, non_blocking=True)
                                for h, t in zip(host, ts)], 10)
    print(f"phase 11: .webp step of {BATCH}: planes {shapes}, equal to the "
          f"CPU port's (2 images) and to the yuv420 conversion of the .png "
          f"step; one decode420 launch per step", flush=True)
    print(f"phase 11: yuv420 emit {emit_ms!r} ms; device_step .webp "
          f"{webp_ms!r} ms vs .png {png_ms!r} ms; D2H {yuv_bytes} B "
          f"({yuv_bytes / (BATCH * DST * DST)!r} B/px) in {d2h(planes)!r} ms "
          f"vs {bgra_bytes} B ({bgra_bytes / (BATCH * DST * DST)!r} B/px) in "
          f"{d2h([packed])!r} ms [{card}]", flush=True)
    del planes, packed, args

    # (b) the still front: yuv420 for RGB, pixels for RGBA
    pngs = png_inputs(fixture_pixels("bench_1080p.jpg"),
                      fixture_pixels("bench_1080p_gray.jpg"))
    for kind, emit in (("png_rgb8", "yuv420"), ("png_rgba8", "pixels")):
        sources = [pngs[kind]] * WEBP_STILL_BATCH
        pipes = [StillTranscodePipeline(pngs[kind], DST, DST, quality=85,
                                        output_format=".webp", device=dev)
                 for dev in (DEVICE, "cpu")]
        check([p._emit for p in pipes] == [emit] * 2,
              f"{kind}: the emit is {pipes[0]._emit}, not {emit}")
        (batch,), _ = pipes[1]._host_decode(sources)
        got = pipes[0].device_step(batch)
        want = pipes[1].device_step(batch)
        for g, w in zip(got, want):
            mx, nd, n = diff_stats([g.cpu()], [w])
            check(nd == 0, f"{kind} .webp step differs from the CPU port's "
                  f"in {nd} of {n} values (max {mx})")
        print(f"phase 11: still front {kind} x{WEBP_STILL_BATCH} ({emit}): "
              f"the card's step equals the CPU port's", flush=True)

    # (c) the value sweep
    sweep = np.zeros((2, 512), np.int32)
    for v in range(256):
        sweep[:, 2 * v:2 * v + 2] = v * 0x010101
    rng = np.random.default_rng(16)
    stacks = [sweep[None]] + [
        rng.integers(0, 1 << 24, shape).astype(np.int32)
        for shape in ((1, 1, 1), (1, 5, 7), (1, 33, 47), (6, 33, 47))]
    for packed in stacks:
        packed = torch.from_numpy(packed | np.int32(-16777216))
        for g, w in zip(C.webp_yuv420_from_packed(packed.to(DEVICE)),
                        C.webp_yuv420_from_packed(packed)):
            check(torch.equal(g.cpu(), w), f"the yuv420 emit at "
                  f"{tuple(packed.shape)} differs from the CPU port's")
    print(f"phase 11: the yuv420 emit over every u8 value and at "
          f"{[tuple(s.shape) for s in stacks[1:]]} equals the CPU port's",
          flush=True)

    # (d) the animated composite
    t0 = time.perf_counter()
    stack = webp_anim_inputs()
    host = [torch.from_numpy(stack[k]) for k in TP._WEBP_INPUTS]
    print(f"phase 11: composite inputs {tuple(host[0].shape)} "
          f"({sum(t.numel() * t.element_size() for t in host)} B) built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    h2d_ms = cuda_ms(lambda: [t.to(DEVICE) for t in host], 3)
    dev = [t.to(DEVICE) for t in host]

    def batch():
        return TP._webp_batch_to_pixels(*dev, None, WEBP_DST, WEBP_DST)
    got = batch().cpu()
    comp_ms = cuda_ms(batch, 3)
    events = len(device_spans(batch)[0])
    for lo in range(0, WEBP_ANIMS, WEBP_CPU_CHUNK):
        lanes = slice(lo, lo + WEBP_CPU_CHUNK)
        want = TP._webp_batch_to_pixels(*[t[lanes] for t in host], None,
                                        WEBP_DST, WEBP_DST)
        mx, nd, n = diff_stats([got[lanes]], [want])
        check(nd == 0, f"the composite of animations {lo}.. differs from "
              f"the CPU port's in {nd} of {n} values (max {mx})")
    print(f"phase 11: composite + AREA {WEBP_CANVAS}->{WEBP_DST} of "
          f"{WEBP_ANIMS} x {host[0].shape[1]} frames equals the CPU port's; "
          f"{comp_ms!r} ms, H2D {h2d_ms!r} ms, {events} device events "
          f"[{card}]", flush=True)
    del dev, host, stack, got

    # (e) the host route
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_gif_builders import pan_gif
    with open(os.path.join(ASSETS, WEBP_FIXTURE), "rb") as f:
        anim = f.read()
    rgb = np.ascontiguousarray(fixture_pixels("bench_1080p.jpg")[
        :240, :320, ::-1])
    gif = pan_gif(rgb, 160, 120, 4)
    calls = {
        "new_decoder": lambda d: new_decoder(anim, device=d).header(),
        "new_encoder": lambda d: new_encoder(".webp") and None,
        "transcode_webp": lambda d: TP.transcode_webp(
            anim, 48, 40, fit=True, device=d),
        ".webp transcode": lambda d: JpegTranscodePipeline(
            fixture, DST, DST, quality=85, output_format=".webp",
            device=d).transcode([fixture] * 2),
        "GIF -> .webp": lambda d: TP.transcode_gif(
            gif, 64, 48, fit=True, file_type=".webp", device=d),
    }
    for name, call in calls.items():
        if have_webp:
            check(call(DEVICE) == call("cpu"), f"{name}: the card's bytes "
                  "differ from the CPU port's")
            continue
        try:
            call(DEVICE)
        except HostLibraryMissingError as e:
            check("libwebp" in str(e), f"{name}: {e}")
        else:
            raise SmokeFailure(f"{name} did not raise HostLibraryMissingError")
    print(f"phase 11: host route {list(calls)}: "
          f"{'card bytes equal the CPU port' if have_webp else 'each raised HostLibraryMissingError'}",
          flush=True)
    launched = {k: v for k, v in DK.launches.items() if v}
    print(f"phase 11: launches over the phase {launched}", flush=True)
    check(set(launched) == {"decode420"}, f"phase 11 launched {launched}")
    # the main path's run: the one batch-128 .webp step of (a)
    kernels["decode420"]["launches"] += step["decode420"]
    kernels["decode420"]["webp_launches"] = step["decode420"]
    print(f"phase 11: phase took {time.perf_counter() - t_phase:.1f}s",
          flush=True)


#: phase 12's JpegEncoder options: each alone and the three together
#: (keys JPEG_PROGRESSIVE 2, JPEG_OPTIMIZE 3, JPEG_RST_INTERVAL 4 of
#: lilliput_tpu_torch/framebuffer.py)
ENC_OPTIONS = {"baseline": {}, "progressive": {2: 1}, "optimize": {3: 1},
               "restart": {4: 1}, "all three": {2: 1, 3: 1, 4: 1}}
#: phase 12 (a)'s main-path run: batches of BATCH
OPT_BATCHES = 2


def _markers(buf: bytes):
    """(SOF2 present, DRI present) among a JPEG's header segments (up to
    its first SOS, which every DRI of ours precedes)."""
    seen = set()
    i = 2
    while i + 4 <= len(buf) and buf[i] == 0xFF and buf[i + 1] != 0xDA:
        seen.add(buf[i + 1])
        i += 2 + int.from_bytes(buf[i + 2:i + 4], "big")
    return 0xC2 in seen, 0xDD in seen


def distinct_sources(fixture: bytes, n: int):
    """n distinct JPEGs of the fixture's geometry and layout: the fixture
    itself, then its frame rolled and brightened per slot and encoded by
    the port's JpegEncoder on DEVICE at qualities 71..95 (4:2:0), so that
    every slot of a batch has an answer of its own."""
    import torch
    from lilliput_tpu_torch import Framebuffer, new_decoder
    from lilliput_tpu_torch.codecs.jpeg import JpegEncoder
    fb = Framebuffer()
    new_decoder(fixture, device=DEVICE).decode_to(fb)
    encoder = JpegEncoder()
    out = [fixture]
    for i in range(1, n):
        px = torch.roll(fb.array, 17 * i, dims=1).to(torch.int16) + i % 24
        out.append(encoder.encode(Framebuffer.from_array(
            px.clamp(0, 255).to(torch.uint8)), {1: 71 + i % 25}))
    return out


def phase12(card, kernels):
    """JPEG encode options and the libjpeg decode route (ROADMAP queue 1
    item 2).

    (a) JpegTranscodePipeline(bench_1080p.jpg, DST, DST, q85,
    optimize_coding=True).transcode_pipelined of OPT_BATCHES batches of
    BATCH distinct sources (distinct_sources; the second batch the first
    rotated by one slot), every launch count 0 just before and read just
    after: decode420 once per step and no other kernel (the launches join
    the kernels line); each output decodes (jpeg_huff.cpp) to exactly the
    coefficients of the baseline pipeline's output of the same slot of the
    same batch, and is no larger. Prints the encode ms of one batch of BATCH with and
    without optimize_coding on the encode threads, the bytes of both, and
    transcode_pipelined images/s of both in turns.
    (b) ImageOps.transform of the fixture to .jpeg (Fit DST) and
    JpegEncoder of its 1080p frame on the card, under each ENC_OPTIONS:
    the coefficients of the baseline bytes of the same frame, SOF2 where
    progressive, a DRI where restart; the 1080p encode ms of each.
    (c) the CLI's .jpg on the card: SOF2, the bytes of -device cpu's.
    (d) where binding.JPEG_HEADER is absent (the H100 machine), the
    truncated scan through new_decoder(..., device="cuda") and the
    fixture under LILLIPUT_JPEG_HUFF=libjpeg each raise
    HostLibraryMissingError; where it is present, their frames equal the
    CPU port's under the kernel gate."""
    import torch
    from lilliput_tpu_torch import (Framebuffer, ImageOps, ImageOptions,
                                    JpegTranscodePipeline, ResizeMethod,
                                    binding, new_decoder)
    from lilliput_tpu_torch.codecs.jpeg import JpegEncoder
    from lilliput_tpu_torch.errors import HostLibraryMissingError
    from lilliput_tpu_torch.ops import decode_kernels as DK
    t_phase = time.perf_counter()
    have_jpeg = os.path.exists(binding.JPEG_HEADER)
    print(f"phase 12: {binding.JPEG_HEADER} "
          f"{'present' if have_jpeg else 'absent'}", flush=True)
    with open(os.path.join(ASSETS, "bench_1080p.jpg"), "rb") as f:
        fixture = f.read()
    bufs = distinct_sources(fixture, BATCH)
    check(len(set(bufs)) == BATCH, "the phase 12 sources are not distinct")
    batches = [bufs, bufs[1:] + bufs[:1]][:OPT_BATCHES]

    # (a) optimize_coding on the main path
    opt = JpegTranscodePipeline(fixture, DST, DST, quality=85,
                                optimize_coding=True, device=DEVICE)
    base = JpegTranscodePipeline(fixture, DST, DST, quality=85,
                                 device=DEVICE)
    opt.transcode(bufs[:2])                    # warm: pools, tables, cuBLAS
    DK.reset_launches()
    res = opt.transcode_pipelined(batches)
    counts = dict(DK.launches)
    print(f"phase 12: optimize_coding transcode_pipelined "
          f"{OPT_BATCHES}x{BATCH}: launches={counts}", flush=True)
    check(counts == {k: OPT_BATCHES * (k == "decode420") for k in counts},
          "decode420 did not launch once per device step of the "
          "optimize_coding path (or another kernel launched)")
    kernels["decode420"]["launches"] += counts["decode420"]
    kernels["decode420"]["optimize_coding_launches"] = counts["decode420"]
    for bi, (outs, batch) in enumerate(zip(res, batches)):
        base_out = base.transcode(batch)
        check(len(set(base_out)) == BATCH, f"batch {bi}: the baseline "
              "outputs of distinct sources are not distinct")
        for i, (o, b) in enumerate(zip(outs, base_out)):
            check(all(np.array_equal(x, y) for x, y in
                      zip(jpeg_coefs(o), jpeg_coefs(b))),
                  f"optimize_coding output {bi}/{i}: other coefficients "
                  "than the baseline output's")
            check(len(o) <= len(b), f"optimize_coding output {bi}/{i} is "
                  f"larger than the baseline's ({len(o)} > {len(b)})")
    step = [t.cpu().numpy() for t in base.device_step(
        *base.decode_entropy(bufs))]
    enc = {}
    for name, pipe in (("baseline", base), ("optimize_coding", opt),
                       ("optimize_coding ", opt), ("baseline ", base)):
        t0 = time.perf_counter()
        out = pipe.encode_entropy(*step)
        enc.setdefault(name.strip(), []).append(
            1e3 * (time.perf_counter() - t0))
        enc[name.strip() + " bytes"] = sum(len(o) for o in out)
    workers = min(8, os.cpu_count() or 1)
    print(f"phase 12: encode of {BATCH} {DST}x{DST} outputs on {workers} "
          f"threads: baseline {enc['baseline']!r} ms, {enc['baseline bytes']}"
          f" bytes; optimize_coding {enc['optimize_coding']!r} ms, "
          f"{enc['optimize_coding bytes']} bytes [{card}]", flush=True)
    ips = {"baseline": [], "optimize_coding": []}
    runs = [batches[i % OPT_BATCHES] for i in range(4)]
    for name in ("baseline", "optimize_coding", "optimize_coding",
                 "baseline"):
        pipe = base if name == "baseline" else opt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.transcode_pipelined(runs)
        ips[name].append(len(runs) * BATCH / (time.perf_counter() - t0))
    print(f"phase 12: transcode_pipelined {len(runs)}x{BATCH} images/s "
          f"(turns baseline, optimize, optimize, baseline): {ips!r} "
          f"[{card}]", flush=True)
    del opt, base, step, res

    # (b) every JpegEncoder option, through ImageOps and on a 1080p frame
    def transform(opts):
        return ImageOps(8192).transform(
            new_decoder(fixture, device=DEVICE), ImageOptions(
                file_type=".jpeg", width=DST, height=DST,
                resize_method=ResizeMethod.FIT,
                encode_options={1: 85, **opts}))
    fb = Framebuffer()
    new_decoder(fixture, device=DEVICE).decode_to(fb)
    frame_ref = None
    lines = []
    for name, opts in ENC_OPTIONS.items():
        small = transform(opts)
        encoder = JpegEncoder()
        big = encoder.encode(fb, {1: 85, **opts})
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = encoder.encode(fb, {1: 85, **opts})
            ms.append(1e3 * (time.perf_counter() - t0))
            check(again == big, f"{name}: two encodes of the frame differ")
        if frame_ref is None:
            frame_ref = jpeg_coefs(small), jpeg_coefs(big)
        for out, ref in ((small, frame_ref[0]), (big, frame_ref[1])):
            check(all(np.array_equal(x, y)
                      for x, y in zip(jpeg_coefs(out), ref)),
                  f"{name}: other coefficients than the baseline bytes'")
            sof2, dri = _markers(out)
            check(sof2 == (2 in opts) and dri == (4 in opts),
                  f"{name}: SOF2 {sof2}, DRI {dri}")
        lines.append(f"{name} {sum(ms) / len(ms)!r} ms {len(big)} B")
    print(f"phase 12: JpegEncoder of the 1920x1080 frame on {DEVICE} "
          f"(mean of 3; same coefficients, SOF2/DRI where due; the 256x256 "
          f"transform too): {'; '.join(lines)} [{card}]", flush=True)

    # (c) the CLI's .jpg
    import tempfile
    from lilliput_tpu_torch import cli
    outs = {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".phase12_") as d:
        src = os.path.join(d, "in.jpg")
        with open(src, "wb") as f:
            f.write(fixture)
        for dev in (DEVICE, "cpu"):
            dst = os.path.join(d, f"out_{dev}.jpg")
            rc = cli.main(["-input", src, "-output", dst, "-width",
                           str(DST), "-height", str(DST), "-device", dev])
            check(rc == 0, f"the CLI on {dev} exited {rc}")
            with open(dst, "rb") as f:
                outs[dev] = f.read()
    check(_markers(outs[DEVICE])[0], "the CLI's .jpg is not progressive")
    check(outs[DEVICE] == outs["cpu"], "the CLI's .jpg on the card differs "
          "from -device cpu's")
    print(f"phase 12: the CLI's .jpg on {DEVICE} is progressive (SOF2), "
          f"{len(outs[DEVICE])} bytes, equal to -device cpu's", flush=True)

    # (d) the libjpeg decode route
    cut = fixture[:len(fixture) // 2]
    calls = {"truncated scan": (cut, {}),
             "LILLIPUT_JPEG_HUFF=libjpeg": (
                 fixture, {"LILLIPUT_JPEG_HUFF": "libjpeg"})}
    for name, (buf, env) in calls.items():
        with path_env(env):
            if not have_jpeg:
                try:
                    new_decoder(buf, device=DEVICE).decode_to(Framebuffer())
                except HostLibraryMissingError as e:
                    check("libjpeg" in str(e), f"{name}: {e}")
                else:
                    raise SmokeFailure(f"{name} did not raise "
                                       "HostLibraryMissingError")
                continue
            frames = []
            for dev in (DEVICE, "cpu"):
                fbd = Framebuffer()
                new_decoder(buf, device=dev).decode_to(fbd)
                frames.append(fbd.array.to("cpu"))
        if have_jpeg:
            mx, nd, n = diff_stats([frames[0]], [frames[1]])
            check(mx <= KERNEL_MAX_DIFF and nd <= KERNEL_MAX_SHARE * n,
                  f"{name}: the card's frame differs from the CPU port's: "
                  f"max {mx}, {nd}/{n}")
    print(f"phase 12: libjpeg route {list(calls)}: "
          f"{'frames equal the CPU port' if have_jpeg else 'each raised HostLibraryMissingError'}",
          flush=True)
    print(f"phase 12: phase took {time.perf_counter() - t_phase:.1f}s",
          flush=True)


#: phase 13: the HDR device half's full-size inputs (AVIF_W x AVIF_H), the
#: committed AVIF fixtures and what their headers must read (width,
#: height, channels, orientation, frames; duration s; loop count; ICC)
AVIF_W, AVIF_H = 3840, 2160
AVIF_FIXTURES = {
    "still_alpha_64x48.avif": ((64, 48, 4, 1, 1), 0.0, 0, "srgb"),
    "anim_4f_48x40.avif": ((48, 40, 4, 1, 4), 0.4, 3, None),
}


def _gradient_plane(rng, h, w, depth, k):
    """A smooth gradient plus noise at `depth` bits, (h, w) u16."""
    mx = (1 << depth) - 1
    g = 0.5 + 0.35 * (np.sin(np.arange(h) / h * 3.1 + k)[:, None]
                      * np.cos(np.arange(w) / w * 2.3 - k)[None, :])
    g = g * mx + rng.normal(0, mx * 0.02, (h, w))
    return np.clip(g, 0, mx).astype(np.uint16)


def avif_hdr_inputs():
    """Phase 13 (a)'s two 4K inputs, made from seeds: name -> (colour
    RawPlanes, alpha RawPlanes or None, colr CICP). "pq_420": 10-bit
    limited-range 4:2:0, BT.2020 matrix and primaries, PQ, a 10-bit alpha
    plane; "hlg_422": 12-bit full-range 4:2:2, P3 primaries, HLG."""
    from lilliput_tpu_torch.codecs.av1_raw import RawPlanes
    h, w = AVIF_H, AVIF_W
    rng = np.random.default_rng(13)
    out = {}
    for name, depth, cw, full, prim, trc, alpha in (
            ("pq_420", 10, w // 2, False, 9, 16, True),
            ("hlg_422", 12, w // 2, True, 12, 18, False)):
        ch = h // 2 if name.endswith("420") else h
        rp = RawPlanes(y=_gradient_plane(rng, h, w, depth, 0.3),
                       u=_gradient_plane(rng, ch, cw, depth, 1.1),
                       v=_gradient_plane(rng, ch, cw, depth, 2.0),
                       width=w, height=h, depth=depth, full_range=full,
                       matrix=9, primaries=prim, trc=trc)
        ap = (RawPlanes(y=_gradient_plane(rng, h, w, depth, 0.7), u=None,
                        v=None, width=w, height=h, depth=depth,
                        full_range=True, matrix=2, primaries=2, trc=2)
              if alpha else None)
        out[name] = (rp, ap, (prim, trc, 9, int(full)))
    return out


def phase13(card):
    """AVIF (no kernel: the HDR chain and the colour conversions are torch
    ops, the AV1 decode and encode host code), with every launch count 0
    just before the phase and read just after (none may launch).
    (a) codecs/avif.hdr_planes_to_bgr, the HDR decode's device half, on
    avif_hdr_inputs() (AVIF_W x AVIF_H): the card's BGR(A) within
    STEP_MAX_DIFF of the CPU port's on at most STEP_MAX_SHARE of the
    values, the alpha channel equal; the H2D and device ms (CUDA events,
    mean of 3), the device events of one call (device_spans), the CPU
    port's ms on the host and the differing count.
    (b) codecs/yuv_rgb.planes_to_bgr_u8 of 4K 10-bit and 8-bit 4:2:0
    planes on this machine's host: the C++ row kernel (yuv_bgr.cpp)
    equals the Python reference (LILLIPUT_YUV_RGB=py) at atol 0; the ms
    of both (mean of 3, after a warm-up call that builds the library).
    (c) ops/color.bgr_to_yuv, then yuv420_to_bgr, of bench_1080p.jpg's
    pixels on the card equal the CPU port's at atol 0; their ms.
    (d) the committed fixtures (AVIF_FIXTURES): new_decoder(...,
    device="cuda") reads the header, duration, loop count and ICC stated
    there, as the CPU port does. Where binding.AVFORMAT_HEADER is absent
    (the H100 machine) decode_to, an .avif encode, transcode_avif,
    transcode_avif_batch and AnimatedTranscodePipeline's .avif slot each
    raise HostLibraryMissingError; where it is present the card's frames
    and bytes equal the CPU port's."""
    import torch
    from lilliput_tpu_torch import (AnimatedTranscodePipeline, Framebuffer,
                                    binding, new_decoder, new_encoder,
                                    transcode_avif, transcode_avif_batch)
    from lilliput_tpu_torch.codecs import yuv_rgb
    from lilliput_tpu_torch.codecs.avif import hdr_planes_to_bgr
    from lilliput_tpu_torch.errors import HostLibraryMissingError
    from lilliput_tpu_torch.ops import color as COLOR
    from lilliput_tpu_torch.ops import decode_kernels as DK
    t_phase = time.perf_counter()
    have_ffmpeg = os.path.exists(binding.AVFORMAT_HEADER)
    print(f"phase 13: {binding.AVFORMAT_HEADER} "
          f"{'present' if have_ffmpeg else 'absent'}", flush=True)
    DK.reset_launches()

    # (a) the HDR device half at full size
    for name, (rp, ap, cicp) in avif_hdr_inputs().items():
        def run(dev, times=None, rp=rp, ap=ap, cicp=cicp):
            return hdr_planes_to_bgr(rp, ap, AVIF_H, AVIF_W, cicp, dev,
                                     stage_times=times)
        run(DEVICE)                                  # warm
        times = {}
        for _ in range(3):
            got = run(DEVICE, times)
        t0 = time.perf_counter()
        ref = run("cpu")
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        got = got.cpu()
        check(got.shape == ref.shape == (AVIF_H, AVIF_W, 4 if ap else 3),
              f"{name}: shape {tuple(got.shape)}")
        mx, nd, n = diff_stats([got[..., :3]], [ref[..., :3]])
        check(mx <= STEP_MAX_DIFF and nd <= STEP_MAX_SHARE * n,
              f"{name}: the card's tone map differs from the CPU port's: "
              f"max {mx}, {nd}/{n}")
        check(torch.equal(got[..., 3:], ref[..., 3:]),
              f"{name}: the alpha rescale differs from the CPU port's")
        n_ev = len(device_spans(lambda: run(DEVICE))[0])
        h2d = sum(times["h2d"]) / 3
        dev_ms = sum(times["device_convert"]) / 3
        print(f"phase 13: (a) {name} {AVIF_W}x{AVIF_H} hdr_planes_to_bgr "
              f"on {DEVICE}: H2D {h2d!r} ms, device {dev_ms!r} ms (CUDA "
              f"events, mean of 3), {n_ev} device events; the CPU port "
              f"{cpu_ms!r} ms on this host; vs the CPU port "
              f"max_abs_diff={mx} differing={nd}/{n} [{card}]", flush=True)
        del got, ref
    torch.cuda.empty_cache()

    # (b) yuv_bgr.cpp on this machine's host
    rng = np.random.default_rng(131)
    h, w = AVIF_H, AVIF_W
    for depth in (10, 8):
        dt = np.uint16 if depth > 8 else np.uint8
        y, u, v = (rng.integers(0, 1 << depth, s).astype(dt)
                   for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
        ms, outs = {}, {}
        for mode in ("native", "py"):
            with path_env({"LILLIPUT_YUV_RGB": mode}):
                def conv(y=y, u=u, v=v, depth=depth):
                    return yuv_rgb.planes_to_bgr_u8(y, u, v, depth, 1,
                                                    False, h, w)
                outs[mode] = conv()          # warm: builds the library
                t0 = time.perf_counter()
                for _ in range(3):
                    conv()
                ms[mode] = 1e3 * (time.perf_counter() - t0) / 3
        check(np.array_equal(outs["native"], outs["py"]),
              f"yuv_bgr.cpp differs from the Python reference at {depth} "
              "bits")
        print(f"phase 13: (b) planes_to_bgr_u8 {w}x{h} {depth}-bit 4:2:0 on "
              f"the host: C++ {ms['native']!r} ms, Python reference "
              f"{ms['py']!r} ms (mean of 3), equal [{card}]", flush=True)

    # (c) the colour ops on the 1080p fixture's pixels
    bgr = torch.from_numpy(fixture_pixels("bench_1080p.jpg"))

    def roundtrip(dev):
        yuv = COLOR.bgr_to_yuv(bgr.to(dev))
        return yuv, COLOR.yuv420_to_bgr(*yuv)
    (yc, back_c), (yp, back_p) = roundtrip(DEVICE), roundtrip("cpu")
    for a, b in zip(list(yc) + [back_c], list(yp) + [back_p]):
        check(torch.equal(a.cpu(), b), "bgr_to_yuv/yuv420_to_bgr on the card "
              "differ from the CPU port's")
    fwd = cuda_ms(lambda: COLOR.bgr_to_yuv(bgr.to(DEVICE)), 5)
    inv = cuda_ms(lambda: COLOR.yuv420_to_bgr(*yc), 5)
    print(f"phase 13: (c) {bgr.shape[1]}x{bgr.shape[0]} bgr_to_yuv "
          f"{fwd!r} ms (with the H2D), yuv420_to_bgr {inv!r} ms on "
          f"{DEVICE}; equal to the CPU port [{card}]", flush=True)

    # (d) the committed fixtures
    for name, (hdr, dur, loops, icc) in AVIF_FIXTURES.items():
        with open(os.path.join(ASSETS, name), "rb") as f:
            buf = f.read()
        want_icc = b""
        if icc:
            with open(os.path.join(ROOT, "lilliput_tpu_torch", "icc_profiles",
                                   f"{icc}_profile.icc"), "rb") as f:
                want_icc = f.read()
        decs = {dev: new_decoder(buf, device=dev) for dev in (DEVICE, "cpu")}
        for dev, d in decs.items():
            hd = d.header()
            got = ((hd.width, hd.height, hd.channels, int(hd.orientation),
                    hd.num_frames), d.duration(), d.loop_count(), d.icc())
            check(got == (hdr, dur, loops, want_icc),
                  f"{name} on {dev}: header, duration, loops, ICC {got[:3]}")
        frame = Framebuffer.from_array(
            np.zeros((hdr[1], hdr[0], 3), np.uint8), device=DEVICE)

        def avif_encode():
            enc = new_encoder(".avif")
            enc.encode(frame, {})
            return enc.encode(None, {})

        def pipeline_slot():
            res = AnimatedTranscodePipeline(
                32, 32, output_format=".avif", device=DEVICE).transcode(
                [buf], return_exceptions=True)[0]
            if isinstance(res, Exception):
                raise res
            return res
        calls = {
            "decode_to": lambda d=decs[DEVICE]: d.decode_to(Framebuffer()),
            ".avif encode": avif_encode,
            "transcode_avif": lambda: transcode_avif(buf, 32, 32,
                                                     device=DEVICE),
            "transcode_avif_batch": lambda: transcode_avif_batch(
                [buf, buf], 32, 32, device=DEVICE),
            "AnimatedTranscodePipeline .avif": pipeline_slot,
        }
        if not have_ffmpeg:
            for what, call in calls.items():
                try:
                    call()
                except HostLibraryMissingError as e:
                    check("ffmpeg" in str(e), f"{name} {what}: {e}")
                else:
                    raise SmokeFailure(f"{name} {what} did not raise "
                                       "HostLibraryMissingError")
            print(f"phase 13: (d) {name}: header {hdr}, duration {dur}, "
                  f"loops {loops}, ICC {len(want_icc)} B on {DEVICE} as on "
                  f"the CPU; {list(calls)} each raised "
                  "HostLibraryMissingError", flush=True)
            continue
        for _ in range(hdr[4]):
            fbs = {dev: Framebuffer() for dev in decs}
            for dev, d in decs.items():
                d.decode_to(fbs[dev])
            check(torch.equal(fbs[DEVICE].array.cpu(), fbs["cpu"].array),
                  f"{name}: the card's frame differs from the CPU port's")
        outs = {dev: (transcode_avif(buf, 32, 32, device=dev),
                      transcode_avif_batch([buf, buf], 32, 32, device=dev),
                      AnimatedTranscodePipeline(
                          32, 32, output_format=".avif",
                          device=dev).transcode([buf, buf]))
                for dev in (DEVICE, "cpu")}
        check(outs[DEVICE] == outs["cpu"], f"{name}: the card's AVIF bytes "
              "differ from the CPU port's")
        print(f"phase 13: (d) {name}: header {hdr}, duration {dur}, loops "
              f"{loops}, ICC {len(want_icc)} B; frames and transcode bytes "
              f"on {DEVICE} equal the CPU port's", flush=True)
    launched = {k: v for k, v in DK.launches.items() if v}
    check(not launched, f"phase 13 launched {launched}")
    print(f"phase 13: no kernel launched; phase took "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)


VIDEO_W, VIDEO_H = 1920, 1080
#: phase 14 (a)'s planar inputs: name -> (AVPixelFormat, AVCOL_SPC,
#: AVCOL_RANGE, coded (w, h)); each is displayed at VIDEO_W x VIDEO_H
VIDEO_CASES = {
    "yuv420p_bt709": (0, 1, 1, (1920, 1080)),
    "yuvj422p_bt601": (13, 5, 2, (1920, 1080)),
    "yuv444p": (5, 2, 1, (1920, 1080)),
    "yuv420p_sar_1440": (0, 1, 1, (1440, 1080)),
}
SPRITE_FRAMES, SPRITE_TILE = 64, (160, 90)
#: the batch of phase 14 (d)'s measure_device_stages
PROFILE_BATCH = 128


def video_planes(rng, fmt: int, w: int, h: int):
    """Y, U, V u8 planes of a gradient plus noise for AVPixelFormat fmt at
    coded size w x h (the chroma size of its subsampling)."""
    from lilliput_tpu_torch.codecs.video import _PLANAR_YUV
    sx, sy = _PLANAR_YUV[fmt]
    return tuple(_gradient_plane(rng, ph, pw, 8, k).astype(np.uint8)
                 for ph, pw, k in ((h, w, 0.4), (-(-h // sy), -(-w // sx),
                                                 1.3),
                                   (-(-h // sy), -(-w // sx), 2.2)))


def sprite_frames():
    """Phase 14 (b)'s SPRITE_FRAMES 1920x1080 BGRA keyframes in one pinned
    array: bench_1080p.jpg's pixels rolled and brightened by seeded
    amounts, alpha 255, as a clip's keyframes differ."""
    import torch
    bgr = fixture_pixels("bench_1080p.jpg")[:VIDEO_H, :VIDEO_W]
    rng = np.random.default_rng(14)
    out = torch.empty((SPRITE_FRAMES, VIDEO_H, VIDEO_W, 4),
                      dtype=torch.uint8, pin_memory=True).numpy()
    for i in range(SPRITE_FRAMES):
        dx, dy, lift = (int(v) for v in (rng.integers(0, VIDEO_W),
                                         rng.integers(0, VIDEO_H),
                                         rng.integers(0, 48)))
        out[i, ..., :3] = np.roll(bgr, (dy, dx), axis=(0, 1))
        np.add(out[i, ..., :3], lift, out=out[i, ..., :3],
               casting="unsafe", where=out[i, ..., :3] < 255 - lift)
        out[i, ..., 3] = 255
    return out


def phase14(card, kernels):
    """Video and the profiling tools (no kernel of their own: the YUV ->
    BGR conversion, the LINEAR and AREA resizes and the thumbhash grids
    are torch ops; ffmpeg is host code). The launch counts are set to 0
    just before (a) and read after (c): nothing may launch there.
    (a) codecs/video.frame_to_bgra, the device half of a frame's decode,
    on VIDEO_CASES (1920x1080 planes: yuv420p limited bt709, yuvj422p
    full bt601, yuv444p with an unlisted matrix, and 1440x1080 planes
    displayed at 1920x1080 through the LINEAR upscale) and bgra_to_display
    on a 1920x1080 BGRA frame (the shim's sws route): each equal to the
    CPU port's byte for byte; H2D and device ms (CUDA events, mean of 3)
    and the device events of one call.
    (b) pipeline.spritesheet_tiles of SPRITE_FRAMES 1920x1080 BGRA
    keyframes (sprite_frames, pinned) to 160x90 tiles with thumbhashes:
    the tiles equal the CPU port's byte for byte, the grids within
    THUMB_GRID_ATOL, the hashes equal but where an AC sits on a rounding
    tie (thumbhash.order_dependent, ROADMAP queue 3 entry 12); each
    stage's ms (CUDA events, mean of 3) and the device events of one call.
    (c) Where binding.AVFORMAT_HEADER is absent (the H100 machine),
    new_decoder, VideoDecoder and spritesheet of tests/assets/tiny_vp8.webm
    each raise HostLibraryMissingError naming ffmpeg; where it is present
    the card's first frame equals the CPU port's. new_decoder of random
    bytes raises InvalidImageError either way.
    (d) utils.measure_device_stages on the 4:2:0 pipeline at
    PROFILE_BATCH, printed beside phase 4's decode420 time for the same
    window; complete_trace of one and of two device_steps, each read
    only from a session that kept a device record of every kernel launch
    and copy of its steps (late in a long process a session may drop its
    first device records, tools/torch_profiler_drops.py: one that did is
    thrown away and a fresh one opened, and a second drop fails the
    phase), each holding one event of decode420_kernel per step, the
    __global__ function behind lpt_decode420 (csrc/decode420.cu:233); a
    utils.device_trace of one step writes its trace and counts its
    records (no event count is read from it)."""
    import torch
    from lilliput_tpu_torch import (Framebuffer, JpegTranscodePipeline,
                                    binding, new_decoder, spritesheet)
    from lilliput_tpu_torch.codecs import thumbhash as TH
    from lilliput_tpu_torch.codecs import video as V
    from lilliput_tpu_torch.errors import (HostLibraryMissingError,
                                           InvalidImageError)
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.pipeline import spritesheet_tiles
    from lilliput_tpu_torch.utils import (Metrics, device_trace,
                                          measure_device_stages)
    t_phase = time.perf_counter()
    have_ffmpeg = os.path.exists(binding.AVFORMAT_HEADER)
    print(f"phase 14: {binding.AVFORMAT_HEADER} "
          f"{'present' if have_ffmpeg else 'absent'}", flush=True)
    DK.reset_launches()

    # (a) the video device half at 1080p
    rng = np.random.default_rng(141)
    calls = {}
    for name, (fmt, spc, rng_, (w, h)) in VIDEO_CASES.items():
        planes = video_planes(rng, fmt, w, h)
        calls[name] = (sum(p.nbytes for p in planes),
                       lambda dev, times=None, planes=planes, fmt=fmt,
                       spc=spc, r=rng_: V.frame_to_bgra(
                           *planes, spc=spc, rng=r, fmt=fmt,
                           display_w=VIDEO_W, display_h=VIDEO_H, device=dev,
                           stage_times=times))
    px = np.concatenate([video_planes(rng, 5, VIDEO_W, VIDEO_H)[0][..., None]
                         .repeat(3, -1), np.full((VIDEO_H, VIDEO_W, 1), 255,
                                                 np.uint8)], -1)
    calls["bgra"] = (px.nbytes, lambda dev, times=None: V.bgra_to_display(
        px, display_w=VIDEO_W, display_h=VIDEO_H, device=dev,
        stage_times=times))
    for name, (nbytes, run) in calls.items():
        run(DEVICE)                                  # warm
        times = {}
        for _ in range(3):
            got = run(DEVICE, times)
        ref = run("cpu")
        check(tuple(got.shape) == (VIDEO_H, VIDEO_W, 4)
              and torch.equal(got.cpu(), ref),
              f"{name}: the card's frame differs from the CPU port's")
        n_ev = len(device_spans(lambda: run(DEVICE))[0])
        print(f"phase 14: (a) {name} -> {VIDEO_W}x{VIDEO_H} BGRA on "
              f"{DEVICE}: H2D of {nbytes} B {sum(times['h2d']) / 3!r} ms, "
              f"device {sum(times['device_convert']) / 3!r} ms (CUDA events, "
              f"mean of 3), {n_ev} device events; equal to the CPU port "
              f"[{card}]", flush=True)
    del got, ref
    torch.cuda.empty_cache()

    # (b) the spritesheet's device half
    frames = sprite_frames()
    tw, th = SPRITE_TILE
    spritesheet_tiles(frames, tw, th, True, DEVICE)     # warm
    times = {}
    for _ in range(3):
        tiles, hashes = spritesheet_tiles(frames, tw, th, True, DEVICE,
                                          stage_times=times)
    n_ev = len(device_spans(
        lambda: spritesheet_tiles(frames, tw, th, True, DEVICE))[0])
    t0 = time.perf_counter()
    ref, ref_hashes = spritesheet_tiles(frames, tw, th, True, "cpu")
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    check(tiles.shape == (SPRITE_FRAMES, th, tw, 4)
          and np.array_equal(tiles, ref),
          "spritesheet_tiles on the card differ from the CPU port's")
    grids, _ = TH.batch_grids(ref, device=DEVICE)
    ref_grids, sums = TH.batch_grids(ref, device="cpu")
    err = max(float(np.abs(g - r).max()) for g, r in zip(grids, ref_grids))
    check(err <= THUMB_GRID_ATOL, "spritesheet thumbhash grids on the card "
          "are not within THUMB_GRID_ATOL of the CPU's")
    ties = [TH.order_dependent(TH.hash_fields(ref_grids, sums, i, tw, th),
                               err) for i in range(SPRITE_FRAMES)]
    nd = sum(a != b for a, b in zip(hashes, ref_hashes))
    bad = sum(a != b and not t for a, b, t in zip(hashes, ref_hashes, ties))
    check(bad == 0, "spritesheet thumbhashes on the card differ from the "
          "CPU's on a tile without a rounding tie")
    stages = ", ".join(f"{k} {sum(v) / 3!r}" for k, v in times.items())
    print(f"phase 14: (b) spritesheet_tiles of {SPRITE_FRAMES} {VIDEO_W}x"
          f"{VIDEO_H} BGRA keyframes ({frames.nbytes} B pinned) -> "
          f"{tw}x{th} tiles + thumbhashes on {DEVICE}: ms {stages} (CUDA "
          f"events, mean of 3), {n_ev} device events; tiles equal to the "
          f"CPU port's ({cpu_ms!r} ms there), grids max_abs_diff={err!r}, "
          f"{nd} hashes differ, {bad} off a tie ({sum(ties)} ties) "
          f"[{card}]", flush=True)
    del frames
    torch.cuda.empty_cache()

    # (c) the host half
    with open(os.path.join(ASSETS, "tiny_vp8.webm"), "rb") as f:
        webm = f.read()
    host_calls = {
        "new_decoder": lambda: new_decoder(webm, device=DEVICE),
        "VideoDecoder": lambda: V.VideoDecoder(webm, device=DEVICE),
        "spritesheet": lambda: spritesheet(webm, tw, th, device=DEVICE),
    }
    if not have_ffmpeg:
        for what, call in host_calls.items():
            try:
                call()
            except HostLibraryMissingError as e:
                check("ffmpeg" in str(e), f"{what}: {e}")
            else:
                raise SmokeFailure(f"{what} of tiny_vp8.webm did not raise "
                                   "HostLibraryMissingError")
        done = f"{list(host_calls)} each raised HostLibraryMissingError"
    else:
        fbs = {dev: Framebuffer() for dev in (DEVICE, "cpu")}
        for dev, fb in fbs.items():
            new_decoder(webm, device=dev).decode_to(fb)
        check(torch.equal(fbs[DEVICE].array.cpu(), fbs["cpu"].array),
              "tiny_vp8.webm's first frame on the card differs from the "
              "CPU port's")
        done = "the first frame on the card equals the CPU port's"
    noise = np.random.default_rng(142).integers(0, 256, 4096,
                                                np.uint8).tobytes()
    try:
        new_decoder(noise, device=DEVICE)
    except InvalidImageError:
        pass
    else:
        raise SmokeFailure("new_decoder of random bytes did not raise "
                           "InvalidImageError")
    launched = {k: v for k, v in DK.launches.items() if v}
    check(not launched, f"phase 14 (a)-(c) launched {launched}")
    print(f"phase 14: (c) tiny_vp8.webm: {done}; random bytes raised "
          "InvalidImageError; no kernel launched in (a)-(c)", flush=True)

    # (d) the profiling tools on the 4:2:0 pipeline
    with open(os.path.join(ASSETS, "bench_1080p.jpg"), "rb") as f:
        fixture = f.read()
    pipe = JpegTranscodePipeline(fixture, DST, DST, quality=85,
                                 device=DEVICE)
    bufs = [fixture] * PROFILE_BATCH
    reg = Metrics()
    stages = measure_device_stages(pipe, bufs, iters=3, registry=reg)
    counts = {k: v["count"] for k, v in reg.snapshot()["stages"].items()}
    check(counts == {f"device.{k}": 1 for k in STAGES},
          f"measure_device_stages registry {counts}")
    print(f"phase 14: (d) measure_device_stages 4:2:0 x{PROFILE_BATCH}: "
          f"{stages}; phase 4's decode420 kernel "
          f"{kernels['decode420']['ms']!r} ms on the same window [{card}]",
          flush=True)
    coefs = pipe.decode_entropy(bufs)
    log_dir = os.path.join(ROOT, "traces", "phase14")

    def step():
        pipe._to_host(pipe._fetch(pipe.device_step(*coefs)))

    def traced(what, n_steps):
        """The decode420_kernel events of a complete_trace of n_steps
        steps."""
        path, events, rec = complete_trace(
            lambda: [step() for _ in range(n_steps)], log_dir,
            f"phase 14 (d) {what}")
        hits = [e for e in events if e.get("cat") == "kernel"
                and "decode420_kernel" in e["name"]]
        print(f"phase 14: (d) {what}: {path} ({os.path.getsize(path)} B), "
              f"{rec}, {len(hits)} decode420_kernel event(s) "
              f"{[e.get('dur') for e in hits]!r} us", flush=True)
        check(len(hits) == n_steps, f"the trace {path} holds "
              f"{len(hits)} decode420_kernel events for {n_steps} steps")
        return hits

    traced("trace of one device_step", 1)
    traced("trace of two device_steps", 2)
    with device_trace(log_dir) as tr:
        step()
    check(os.path.exists(tr.path) and tr.records.launches > 0,
          f"device_trace wrote {tr.path} with {tr.records}")
    note = "" if tr.records.complete else "; dropped records, none read"
    print(f"phase 14: (d) utils.device_trace of one device_step: {tr.path} "
          f"({tr.records}{note})", flush=True)
    print(f"phase 14: phase took {time.perf_counter() - t_phase:.1f}s",
          flush=True)


#: phase 15's meshes: every card (one slot on a one-card machine), and the
#: first card repeated four times, shaped (4, 1) and (2, 2), each slot on
#: a CUDA stream of its own
MESH_SHAPES = {"all": None, "4x1": 1, "2x2": 2}
#: phase 15 (b)'s big-image batch and (c)'s still batch
SP_BATCH, SP_W, SP_H, STILL_MESH_BATCH = 8, 3840, 2160, 16


def phase15_meshes():
    from lilliput_tpu_torch.parallel import make_mesh
    return {name: make_mesh() if sp is None else
            make_mesh(sp=sp, devices=["cuda:0"] * 4)
            for name, sp in MESH_SHAPES.items()}


def stream_overlap(path, cats=("kernel",)):
    """(streams with records of the categories `cats`, us during which
    records of two or more streams run at once, us during which any
    runs) of a Chrome trace."""
    with open(path) as f:
        recs = [e for e in json.load(f)["traceEvents"]
                if e.get("cat") in cats]
    edges = sorted([(e["ts"], 1, e["args"].get("stream")) for e in recs]
                   + [(e["ts"] + e["dur"], -1, e["args"].get("stream"))
                      for e in recs], key=lambda x: (x[0], x[1]))
    active = collections.Counter()
    both = busy = 0.0
    last = None
    for ts, step, stream in edges:
        live = sum(1 for v in active.values() if v > 0)
        if last is not None:
            both += (ts - last) * (live >= 2)
            busy += (ts - last) * (live >= 1)
        active[stream] += step
        last = ts
    return len({e["args"].get("stream") for e in recs}), both, busy


def _slot_diffs(got, ref):
    """diff_stats of each dp slot's real rows of two _SlotOutputs."""
    return [diff_stats([a[:r] for a in g], [b[:r] for b in p])
            for g, p, r in zip(got.parts, ref.parts, got.rows) if r]


def phase15(card, kernels):
    """Multi-device serving (parallel/), at full width on three meshes:
    make_mesh() (every card: one slot on a one-card machine) and the
    first card four times as (4, 1) and (2, 2), each slot on its own
    stream. (a) ShardedJpegPipeline over 4:2:0 1080p x128 -> 256x256 q85:
    each slot's input slice pinned; transcode_pipelined of 2 batches with
    every launch count 0 just before and read just after: decode420 once
    per slot per step and nothing else (those launches join the kernels
    line); on dp meshes the bytes of JpegTranscodePipeline, on (2, 2) the
    step's coefficients within 1 of its; each slot's device_step(plain=True)
    within the step gate of its kernel run; the (4, 1) slots' streams
    overlapping (kernels and copies) in a complete_trace; device_step ms per
    mesh beside the one-device step's. (b) 3840x2160 4:2:0 and gray JPEGs
    (the port's stretch of the fixtures) x SP_BATCH on (2, 2): within 1 of
    the one-device step, the sp counters, each shard's decoded rows equal
    to the whole decode's. (c) ShardedStillPipeline over STILL_MESH_BATCH
    1080p PNG RGB8 on each mesh: dp bytes equal, sp coefficients within 1.
    (d) phase 8's GIF lanes through AnimatedTranscodePipeline on (4, 1):
    the one-device bytes. (e) MultiGeometryPipeline(mesh=) over phase 9's
    mix with every launch count 0 just before and read after each run:
    dp meshes' healthy bytes equal the one-device front's, every kernel
    launched per slot (those launches join the kernels line), the broken
    slots failing alone; on (2, 2) the .jpeg coefficients within 1."""
    import torch
    from lilliput_tpu_torch import (AnimatedTranscodePipeline,
                                    JpegTranscodePipeline,
                                    MultiGeometryPipeline,
                                    StillTranscodePipeline)
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.parallel import (ShardedJpegPipeline,
                                             ShardedStillPipeline)
    from lilliput_tpu_torch.parallel import serving as S
    from lilliput_tpu_torch.utils import device_trace, metrics
    t_phase = time.perf_counter()
    meshes = phase15_meshes()
    print(f"phase 15: meshes {meshes} on {torch.cuda.device_count()} "
          f"card(s)", flush=True)

    # (a) the 4:2:0 serving path over each mesh
    with open(os.path.join(ASSETS, "bench_1080p.jpg"), "rb") as f:
        fixture = f.read()
    bufs = [fixture] * BATCH
    one = JpegTranscodePipeline(fixture, DST, DST, quality=85, device=DEVICE)
    args = one.decode_entropy(bufs)
    ref_bytes = one.transcode(bufs)
    ref_step = [t.cpu() for t in one.device_step(*args)]
    ms = {"one device": cuda_ms(lambda: one.device_step(*args), 5)}
    for name, mesh in meshes.items():
        pipe = ShardedJpegPipeline(fixture, DST, DST, quality=85, mesh=mesh)
        dp, size = mesh.shape["dp"], mesh.size
        c = -(-BATCH // dp)
        pinned = [torch.from_numpy(a)[i * c:(i + 1) * c].is_pinned()
                  for a in args for i in range(dp)]
        check(all(pinned), f"{name}: a slot's input slice is not pinned")
        pipe.transcode(bufs[:2])              # warm: pools, tables, cuBLAS
        DK.reset_launches()
        res = pipe.transcode_pipelined([bufs] * 2)
        launched = dict(DK.launches)
        check(launched == {k: 2 * size * (k == "decode420")
                           for k in launched},
              f"{name}: launches {launched}, not decode420 once per slot "
              f"per step")
        kernels["decode420"]["launches"] += launched["decode420"]
        step = pipe.device_step(*args)
        mx, nd, n = diff_stats([t.cpu() for t in step.gather()], ref_step)
        if mesh.shape["sp"] == 1:
            bad = [(b, i) for b, outs in enumerate(res)
                   for i, (o, r) in enumerate(zip(outs, ref_bytes)) if o != r]
            again = diff_stats([t.cpu() for t in one.device_step(*args)],
                               ref_step)
            check(not bad and (mx, nd) == (0, 0),
                  f"{name}: the bytes differ from JpegTranscodePipeline's: "
                  f"outputs {bad[:8]} of {len(bad)}; step max {mx}, {nd}/"
                  f"{n} differ; the one-device step again: {again}")
            same = "bytes equal to JpegTranscodePipeline's"
        else:
            check(mx <= 1, f"{name}: coefficients {mx} from the one-device "
                  "step")
            same = (f"coefficients within 1 of the one-device step (max "
                    f"{mx}, {nd}/{n} differ)")
        plain = _slot_diffs(step, pipe.device_step(*args, plain=True))
        check(all(d[0] <= STEP_MAX_DIFF and d[1] <= STEP_MAX_SHARE * d[2]
                  for d in plain), f"{name}: a slot's kernel run is off "
              f"its plain version: {plain}")
        ms[name] = cuda_ms(lambda: pipe.device_step(*args), 5)
        print(f"phase 15: (a) {name} dp={dp} sp={mesh.shape['sp']}: "
              f"{len(res)}x{BATCH} transcode_pipelined, launches "
              f"{launched}; {same}; each slot's plain step (max, differing, "
              f"count) {plain}; slot inputs pinned", flush=True)
        if name == "4x1":
            # two steps: a session late in the run may drop its first
            # device records (phase 14), the first step's copies among them
            path, _, rec = complete_trace(
                lambda: [pipe._to_host(pipe._fetch(pipe.device_step(*args)))
                         for _ in range(2)],
                os.path.join(ROOT, "traces", "phase15"),
                "phase 15 (a) 4x1 trace")
            for what, cats in (("kernels", ("kernel",)),
                               ("copies", ("gpu_memcpy",)),
                               ("kernels and copies",
                                ("kernel", "gpu_memcpy", "gpu_memset"))):
                streams, both, busy = stream_overlap(path, cats)
                print(f"phase 15: (a) 4x1 trace of two steps {path} ({rec}): "
                      f"{what} on {streams} streams, {both!r} us of "
                      f"{busy!r} us with two or more streams running them",
                      flush=True)
            check(streams >= 4 and both > 0, "the (4, 1) slots' streams "
                  "did not overlap")
        del pipe, step
    print(f"phase 15: (a) device_step ms of 4:2:0 x{BATCH}: {ms} [{card}]",
          flush=True)

    # (b) big images over (2, 2): sp by explicit halos
    m22 = meshes["2x2"]
    with open(os.path.join(ASSETS, "bench_1080p_gray.jpg"), "rb") as f:
        gray_fixture = f.read()
    for name, src in (("4:2:0", fixture), ("gray", gray_fixture)):
        big = _stretched_jpeg(src, SP_W, SP_H)
        pipe = ShardedJpegPipeline(big, DST, DST, quality=85, mesh=m22)
        ref = JpegTranscodePipeline(big, DST, DST, quality=85, device=DEVICE)
        bargs = ref.decode_entropy([big] * SP_BATCH)
        metrics.reset()
        got = [t.cpu() for t in pipe.device_step(*bargs).gather()]
        counters = {k: v for k, v in metrics.snapshot()["counters"].items()
                    if k.startswith("serving.sp")}
        mx, nd, n = diff_stats(got, [t.cpu()
                                     for t in ref.device_step(*bargs)])
        check(mx <= 1 and counters.get("serving.sp_sharded_planes"),
              f"(b) {name}: {counters}, max {mx}")
        t_sp = cuda_ms(lambda: pipe.device_step(*bargs), 3)
        t_one = cuda_ms(lambda: ref.device_step(*bargs), 3)
        geom = pipe._sp_geometry([torch.from_numpy(a) for a in bargs])
        coefs = [torch.from_numpy(a[:2]).to(DEVICE) for a in bargs]
        whole = S._decode_rows(geom, coefs, False)
        rows = []
        for p0, p1, m0, m1 in S.jpeg_shards(geom, bargs[0].shape[1], 2):
            part = [a[:, geom.fy * m0:geom.fy * m1] if k == 0 else
                    a[:, m0:m1] if k < pipe.ncomp else a
                    for k, a in enumerate(coefs)]
            rows.append([p[:, p0 - m0 * geom.mh:p1 - m0 * geom.mh]
                         for p in S._decode_rows(geom, part, False)])
        equal = all(torch.equal(torch.cat(ps, 1), w)
                    for ps, w in zip(zip(*rows), whole))
        check(equal, f"(b) {name}: the shards' decoded rows differ from "
              "the whole decode")
        nbytes = sum(a[0].nbytes for a in bargs[:pipe.ncomp])
        print(f"phase 15: (b) {name} {SP_W}x{SP_H} x{SP_BATCH} on 2x2: "
              f"{nbytes} B of coefficients per image; within 1 of the "
              f"one-device step "
              f"(max {mx}, {nd}/{n} differ); {counters}; shards' decoded "
              f"rows equal the whole decode's; device_step {t_sp!r} ms on "
              f"2x2 vs {t_one!r} ms on one device [{card}]", flush=True)
        del pipe, ref, bargs, got, whole, rows, coefs
        torch.cuda.empty_cache()

    # (c) the still front
    png = png_inputs(fixture_pixels("bench_1080p.jpg"),
                     fixture_pixels("bench_1080p_gray.jpg"))["png_rgb8"]
    pngs = [png] * STILL_MESH_BATCH
    sone = StillTranscodePipeline(png, DST, DST, quality=85, device=DEVICE)
    sref = sone.transcode(pngs)
    px, _ = sone.decode_pixels(pngs)
    sstep = [t.cpu() for t in sone.device_step(px)]
    for name, mesh in meshes.items():
        spipe = ShardedStillPipeline(png, DST, DST, quality=85, mesh=mesh)
        metrics.reset()
        out = spipe.transcode(pngs)
        counters = {k: v for k, v in metrics.snapshot()["counters"].items()
                    if k.startswith("serving.sp")}
        if mesh.shape["sp"] == 1:
            check(out == sref, f"(c) {name}: the still bytes differ")
            same = "bytes equal to StillTranscodePipeline's"
        else:
            mx, nd, n = diff_stats([t.cpu() for t in spipe.device_step(
                px).gather()], sstep)
            check(mx <= 1 and counters.get("serving.sp_sharded_planes"),
                  f"(c) {name}: max {mx}, {counters}")
            same = f"coefficients within 1 (max {mx}, {nd}/{n} differ)"
        print(f"phase 15: (c) {name} PNG RGB8 1080p x{STILL_MESH_BATCH}: "
              f"{same}; {counters}; device_step "
              f"{cuda_ms(lambda: spipe.device_step(px), 3)!r} ms [{card}]",
              flush=True)

    # (d) phase 8's GIF lanes over dp 4
    anims, _ = gif_inputs()
    gone = AnimatedTranscodePipeline(GIF_DST, GIF_DST, ".gif",
                                     device=DEVICE).transcode(anims)
    t0 = time.perf_counter()
    gmesh = AnimatedTranscodePipeline(GIF_DST, GIF_DST, ".gif",
                                      mesh=meshes["4x1"]).transcode(anims)
    wall = time.perf_counter() - t0
    check(gmesh == gone, "(d) the GIF lanes over dp 4 differ from the "
          "one-device bytes")
    print(f"phase 15: (d) {len(anims)} GIFs over 4x1: bytes equal to the "
          f"one-device front's; {wall!r} s [{card}]", flush=True)

    # (e) the mixed front over each mesh
    _, labels, mbufs, _ = mix_inputs()
    ref = MultiGeometryPipeline(DST, DST, quality=85, device=DEVICE)
    want = ref.transcode(mbufs, return_exceptions=True)
    for name, mesh in meshes.items():
        mg = MultiGeometryPipeline(DST, DST, quality=85, mesh=mesh)
        DK.reset_launches()
        outs = mg.transcode(mbufs, return_exceptions=True)
        launched = dict(DK.launches)
        check(all(launched[k] >= n * mesh.shape["dp"]
                  for k, n in MIX_LAUNCHES.items()),
              f"(e) {name}: launches {launched}")
        if name != "2x2":
            check(launched == {k: n * mesh.shape["dp"]
                               for k, n in MIX_LAUNCHES.items()},
                  f"(e) {name}: launches {launched}")
        for k, n in launched.items():
            kernels[k]["launches"] += n
        failed = [i for i, o in enumerate(outs) if isinstance(o, Exception)]
        check(failed == [i for i, o in enumerate(want)
                         if isinstance(o, Exception)],
              f"(e) {name}: failed slots {failed}")
        worst = 0
        for o, w in zip(outs, want):
            if isinstance(o, Exception):
                continue
            if mesh.shape["sp"] == 1:
                check(o == w, f"(e) {name}: a healthy output differs")
            else:
                worst = max(worst, diff_stats(
                    [torch.from_numpy(a) for a in jpeg_coefs(o)],
                    [torch.from_numpy(a) for a in jpeg_coefs(w)])[0])
        check(worst <= 1, f"(e) {name}: coefficients {worst} apart")
        print(f"phase 15: (e) {name} mix of {len(mbufs)}: launches "
              f"{launched}; {len(failed)} broken slots failed alone; "
              f"healthy outputs "
              f"{'equal' if mesh.shape['sp'] == 1 else f'within {worst}'}",
              flush=True)
    print(f"phase 15: phase took {time.perf_counter() - t_phase:.1f}s",
          flush=True)


def small_bgr(seed: int, w: int, h: int, c: int = 3) -> np.ndarray:
    """tools/tpu_smoke.py's small smooth picture without cv2: a random
    10x10 u8 image upscaled to w x h by the port's CUBIC resize on the
    CPU, (h, w, c) u8."""
    import torch
    from lilliput_tpu_torch.ops import resize as R
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.integers(0, 256, (10, 10, c), np.uint8))
    out = R.resize(img, w, h, R.CUBIC).to(torch.float32)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8).numpy()


def layout_jpeg(bgr: np.ndarray, sub: str, quality: int = 88) -> bytes:
    """A JPEG of (h, w, 3) u8 BGR pixels in chroma layout `sub` ("420",
    "422", "440", "444") or "gray" (channel 0), coded by the port on the
    CPU (the card's machine has no PIL or cv2): the colour conversion and
    fDCT of ops/jpeg_kernels, chroma averaged over its sampling factors,
    then codecs.jpeg.encode_coefs at libjpeg's block geometry."""
    import torch
    from lilliput_tpu_torch.codecs import jpeg as J
    from lilliput_tpu_torch.ops import jpeg_kernels as K
    qt_l, qt_c = J.scaled_qtables(quality)
    h, w = bgr.shape[:2]
    f = torch.from_numpy(np.ascontiguousarray(bgr)).to(torch.float32)
    if sub == "gray":
        planes, hs, vs = [f[..., 0]], [1], [1]
    else:
        planes = list(K._bgr_to_ycc(f[..., 0], f[..., 1], f[..., 2]))
        hs, vs = J._SAMP[sub]
    mh, mv = max(hs), max(vs)
    ph = -(-h // (8 * mv)) * 8 * mv
    pw = -(-w // (8 * mh)) * 8 * mh
    comps = []
    for k, (p, sh, sv) in enumerate(zip(planes, hs, vs)):
        p = K._pad_to(p, ph, pw)
        fy, fx = mv // sv, mh // sh
        p = p.reshape(ph // fy, fy, pw // fx, fx).mean((1, 3))
        q = torch.from_numpy((qt_l if k == 0 else qt_c).astype(np.float32))
        c = K.fdct_quant(p, q).numpy()
        comps.append(np.ascontiguousarray(
            c[:-(-h * sv // (8 * mv)), :-(-w * sh // (8 * mh))]))
    return J.encode_coefs(w, h, comps, hs, vs, qt_l, qt_c)


def _step_diff(got, ref):
    """diff_stats of two device steps' outputs on any devices: packed
    BGRA pixels by byte, planes and coefficients by value."""
    import torch
    if len(got) == 1 and got[0].dtype == torch.int32:
        return diff_stats(got[0].cpu(), ref[0].cpu())
    return diff_stats([g.cpu() for g in got], [r.cpu() for r in ref])


def _host_or_missing(call, present: bool, lib: str) -> str:
    """call(device) on the card: where the host library is present its
    result must equal call("cpu")'s; where it is absent the call must raise
    HostLibraryMissingError naming it."""
    from lilliput_tpu_torch.errors import HostLibraryMissingError
    if present:
        def outcome(dev):
            try:
                return call(dev)
            except Exception as e:  # noqa: BLE001 - compared below
                return f"{type(e).__name__}: {e}"
        got = outcome(DEVICE)
        check(got == outcome("cpu"), f"the card's {lib} result differs "
              "from the CPU port's")
        return ("equal to the CPU port" if not isinstance(got, str)
                else f"as the CPU port: {got}")
    try:
        call(DEVICE)
    except HostLibraryMissingError as e:
        check(lib in str(e), f"HostLibraryMissingError without {lib}: {e}")
        return "HostLibraryMissingError"
    raise SmokeFailure(f"no HostLibraryMissingError without {lib}")


def phase16(card):
    """tools/tpu_smoke.py's 13 surfaces on the card at that tool's small,
    odd shapes, the inputs built here (that tool reads the reference
    checkout's), each gated against the CPU port; one JSON line per
    surface, then {"surfaces": 13, "failures": [...]}; any failure fails
    the phase."""
    import traceback
    import torch
    from lilliput_tpu_torch import (Framebuffer, ImageOps, ImageOptions,
                                    JpegTranscodePipeline, ResizeMethod,
                                    StillTranscodePipeline, binding,
                                    new_decoder, new_encoder, spritesheet)
    from lilliput_tpu_torch import pipeline as TP
    from lilliput_tpu_torch.codecs import thumbhash as TH
    from lilliput_tpu_torch.codecs import video as V
    from lilliput_tpu_torch.codecs.av1_raw import RawPlanes
    from lilliput_tpu_torch.codecs.avif import hdr_planes_to_bgr
    from lilliput_tpu_torch.framebuffer import JPEG_QUALITY
    from lilliput_tpu_torch.ops import blend as B
    from lilliput_tpu_torch.ops import color as C
    from lilliput_tpu_torch.ops import decode_kernels as DK
    from lilliput_tpu_torch.ops import orient as O
    from lilliput_tpu_torch.ops import resize as R
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_gif_builders import pan_gif
    from _torch_still_builders import png_bytes
    t_phase = time.perf_counter()
    have_webp = os.path.exists(binding.WEBP_HEADER)
    have_ffmpeg = os.path.exists(binding.AVFORMAT_HEADER)
    DK.reset_launches()

    def asset(name):
        with open(os.path.join(ASSETS, name), "rb") as f:
            return f.read()

    def gate_steps(what, make, bufs, kernel=True):
        """A pipeline's device step on the card against its plain version
        (the kernel gate) and the CPU port's (the step gate)."""
        pd, pc = make(DEVICE), make("cpu")

        def host(p):
            if isinstance(p, StillTranscodePipeline):
                return (p.decode_pixels(bufs)[0],)
            return p.decode_entropy(bufs)
        coefs = host(pd)
        got = pd.device_step(*coefs)
        if kernel:
            mx, nd, n = _step_diff(got, pd.device_step(*coefs, plain=True))
            check(mx <= KERNEL_MAX_DIFF and nd <= KERNEL_MAX_SHARE * n,
                  f"{what}: the step differs from its plain version "
                  f"(max {mx}, {nd} of {n})")
        mx, nd, n = _step_diff(got, pc.device_step(*host(pc)))
        check(mx <= STEP_MAX_DIFF and nd <= STEP_MAX_SHARE * n,
              f"{what}: the step differs from the CPU port's (max {mx}, "
              f"{nd} of {n})")
        return pd, mx

    def jpeg_serving():
        img = small_bgr(0, 100, 76)
        worst = 0
        for sub, dst in (("420", 64), ("gray", 48), ("422", 48),
                         ("444", 48)):
            buf = layout_jpeg(img, sub)
            for fmt in (".jpeg", ".png", ".webp"):
                pipe, mx = gate_steps(
                    f"{sub} {fmt}", lambda d: JpegTranscodePipeline(
                        buf, dst, dst, output_format=fmt, device=d),
                    [buf, buf], kernel=sub != "gray")
                worst = max(worst, mx)
                if fmt == ".webp":
                    _host_or_missing(lambda d: JpegTranscodePipeline(
                        buf, dst, dst, output_format=fmt,
                        device=d).transcode([buf]), have_webp, "libwebp")
                    continue
                out = pipe.transcode([buf])[0]
                check(out[:2] == b"\xff\xd8" if fmt == ".jpeg"
                      else out[:8] == b"\x89PNG\r\n\x1a\n", f"{sub} {fmt}")
        return {"layouts": ["420", "gray", "422", "444"], "step_max": worst}

    def still_serving():
        rgba = png_bytes(small_bgr(1, 100, 100, 4), 6)
        pipe, mx = gate_steps("RGBA PNG -> 47x33 .jpeg",
                              lambda d: StillTranscodePipeline(
                                  rgba, 47, 33, device=d), [rgba, rgba],
                              kernel=False)
        check(all(o[:2] == b"\xff\xd8" for o in pipe.transcode([rgba] * 2)),
              "still .jpeg")
        ga = png_bytes(small_bgr(2, 100, 100, 2), 4)
        outs = [StillTranscodePipeline(ga, 33, 47, output_format=".png",
                                       device=d).transcode([ga])[0]
                for d in (DEVICE, "cpu")]
        check(outs[0] == outs[1] and outs[0][:8] == b"\x89PNG\r\n\x1a\n",
              "gray+alpha PNG -> 33x47 .png differs from the CPU port's")
        if have_webp:
            fb = Framebuffer.from_array(small_bgr(3, 100, 100), device="cpu")
            wb = new_encoder(".webp").encode(fb, {})
        else:
            wb = asset(WEBP_FIXTURE)
        webp = _host_or_missing(lambda d: StillTranscodePipeline(
            wb, 40, 40, device=d).transcode([wb]), have_webp, "libwebp")
        return {"step_max": mx, "webp": webp}

    def webp_yuv():
        rng = np.random.default_rng(7)
        for (h, w) in ((33, 47), (1, 1), (64, 64)):
            px = rng.integers(0, 256, (h, w, 3), np.uint8).astype(np.int32)
            packed = torch.from_numpy(
                (px[..., 0] | (px[..., 1] << 8) | (px[..., 2] << 16)
                 | np.int32(-16777216))[None])
            for g, r in zip(C.webp_yuv420_from_packed(packed.to(DEVICE)),
                            C.webp_yuv420_from_packed(packed)):
                check(torch.equal(g.cpu(), r), f"yuv420 emit at {(h, w)}")
        buf = layout_jpeg(small_bgr(4, 100, 76), "420")
        _, mx = gate_steps("420 -> 48x48 .webp planes",
                           lambda d: JpegTranscodePipeline(
                               buf, 48, 48, output_format=".webp", device=d),
                           [buf])
        lib = _host_or_missing(lambda d: binding.load_webp() and None,
                               have_webp, "libwebp")
        return {"step_max": mx, "libwebp": lib}

    gif = pan_gif(np.ascontiguousarray(small_bgr(5, 140, 110)[..., ::-1]),
                  100, 80, 4)

    def gif_batch():
        out = TP.transcode_gif(gif, 14, 9, device=DEVICE)
        check(out[:6] in (b"GIF87a", b"GIF89a"), "GIF magic")
        check(out == TP.transcode_gif(gif, 14, 9, device="cpu"),
              "14x9 GIF differs from the CPU port's")
        return {"bytes": len(out)}

    def gif_group():
        outs = TP.transcode_gif_batch([gif] * 3, 14, 9, device=DEVICE)
        want = TP.transcode_gif(gif, 14, 9, device=DEVICE)
        check(outs == [want] * 3, "the 3-lane group differs from one GIF")
        check(outs == TP.transcode_gif_batch([gif] * 3, 14, 9,
                                             device="cpu"),
              "the 3-lane group differs from the CPU port's")
        return {"bytes": len(want)}

    def webp_batch():
        stack = webp_anim_inputs(seed=16, anims=2, frames=6, canvas=41)
        host = [torch.from_numpy(stack[k]) for k in TP._WEBP_INPUTS]
        got = TP._webp_batch_to_pixels(*[t.to(DEVICE) for t in host], None,
                                       20, 13).cpu()
        want = TP._webp_batch_to_pixels(*host, None, 20, 13)
        check(torch.equal(got, want), "the 20x13 composite differs from "
              "the CPU port's")
        anim = asset(WEBP_FIXTURE)
        lib = _host_or_missing(lambda d: TP.transcode_webp(
            anim, 20, 13, device=d), have_webp, "libwebp")
        return {"composite": list(got.shape), "host": lib}

    def thumbhash():
        buf = layout_jpeg(small_bgr(6, 160, 120), "420")
        outs = [ImageOps(1024).transform(new_decoder(buf, device=d),
                                         ImageOptions(file_type=".thumbhash",
                                                      width=100, height=100))
                for d in (DEVICE, "cpu")]
        check(outs[0] == outs[1], "the thumbhash differs from the CPU port's")
        return {"bytes": len(outs[0])}

    def video_frame():
        planes = video_planes(np.random.default_rng(8), 0, 853, 479)
        got, want = (V.frame_to_bgra(*planes, spc=1, rng=1, fmt=0,
                                     display_w=853, display_h=479,
                                     device=d).cpu()
                     for d in (DEVICE, "cpu"))
        check(tuple(got.shape) == (479, 853, 4) and torch.equal(got, want),
              "853x479 yuv420p frame differs from the CPU port's")
        host = _host_or_missing(lambda d: ImageOps(8192).transform(
            new_decoder(asset("tiny_vp8.webm"), device=d), ImageOptions(
                file_type=".jpeg", width=160, height=90,
                resize_method=ResizeMethod.RESIZE,
                encode_options={JPEG_QUALITY: 85},
                disable_animated_output=True)), have_ffmpeg, "ffmpeg")
        return {"host": host}

    def resize_paths():
        img = torch.from_numpy(np.random.default_rng(1).integers(
            0, 256, (37, 53, 3), np.uint8))
        for method in (R.AREA, R.LINEAR, R.CUBIC):
            got = R.resize(img.to(DEVICE), 24, 17, method).cpu()
            want = R.resize(img, 24, 17, method)
            check(tuple(got.shape) == (17, 24, 3) and torch.equal(got, want),
                  f"{method} 37x53 -> 24x17 differs from the CPU port's")
        return {}

    def blend_orient():
        rng = np.random.default_rng(2)
        canvas = torch.from_numpy(rng.integers(0, 256, (31, 29, 4), np.uint8))
        frame = torch.from_numpy(rng.integers(0, 256, (13, 11, 4), np.uint8))
        got = B.copy_to_region_with_alpha(canvas.to(DEVICE), frame.to(DEVICE),
                                          3, 5, 11, 13).cpu()
        check(torch.equal(got, B.copy_to_region_with_alpha(
            canvas, frame, 3, 5, 11, 13)), "blend differs from the CPU's")
        for o in range(1, 9):
            check(torch.equal(O.orient(canvas.to(DEVICE), o).cpu(),
                              O.orient(canvas, o)), f"orient {o}")
        return {}

    def avif_frame():
        rng = np.random.default_rng(9)
        h, w = 81, 121
        rp = RawPlanes(y=_gradient_plane(rng, h, w, 10, 0.3),
                       u=_gradient_plane(rng, -(-h // 2), -(-w // 2), 10, 1.1),
                       v=_gradient_plane(rng, -(-h // 2), -(-w // 2), 10, 2.0),
                       width=w, height=h, depth=10, full_range=False,
                       matrix=9, primaries=9, trc=16)
        ap = RawPlanes(y=_gradient_plane(rng, h, w, 10, 0.7), u=None, v=None,
                       width=w, height=h, depth=10, full_range=True,
                       matrix=2, primaries=2, trc=2)
        got, want = (hdr_planes_to_bgr(rp, ap, h, w, (9, 16, 9, 0), d).cpu()
                     for d in (DEVICE, "cpu"))
        mx, nd, n = diff_stats([got[..., :3]], [want[..., :3]])
        check(got.shape == want.shape == (h, w, 4)
              and mx <= STEP_MAX_DIFF and nd <= STEP_MAX_SHARE * n
              and torch.equal(got[..., 3:], want[..., 3:]),
              f"the {w}x{h} PQ tone map differs from the CPU port's "
              f"(max {mx}, {nd} of {n})")
        host = _host_or_missing(lambda d: ImageOps(8192).transform(
            new_decoder(asset("still_alpha_64x48.avif"), device=d),
            ImageOptions(file_type=".jpeg", width=120, height=80,
                         resize_method=ResizeMethod.FIT,
                         encode_options={JPEG_QUALITY: 85},
                         disable_animated_output=True)), have_ffmpeg,
            "ffmpeg")
        return {"max_abs_diff": mx, "differing": nd, "host": host}

    def png16():
        rng = np.random.default_rng(10)
        px = (small_bgr(11, 64, 48).astype(np.uint16) * 257
              + rng.integers(0, 257, (48, 64, 3)).astype(np.uint16))
        buf = png_bytes(px, 2, depth=16)
        outs = [ImageOps(8192).transform(new_decoder(buf, device=d),
                                         ImageOptions(
                                             file_type=".png", width=40,
                                             height=30,
                                             resize_method=ResizeMethod.FIT))
                for d in (DEVICE, "cpu")]
        check(outs[0] == outs[1] and outs[0][:8] == b"\x89PNG\r\n\x1a\n",
              "16-bit PNG -> 40x30 .png differs from the CPU port's")
        return {"bytes": len(outs[0])}

    def sprite():
        frames = np.stack([np.concatenate(
            [small_bgr(20 + k, 241, 135), np.full((135, 241, 1), 255,
                                                 np.uint8)], -1)
            for k in range(4)])
        tiles, hashes = TP.spritesheet_tiles(frames, 64, 36, True, DEVICE)
        ref, ref_hashes = TP.spritesheet_tiles(frames, 64, 36, True, "cpu")
        check(np.array_equal(tiles, ref), "tiles differ from the CPU's")
        grids, _ = TH.batch_grids(ref, device=DEVICE)
        ref_grids, sums = TH.batch_grids(ref, device="cpu")
        err = max(float(np.abs(g - r).max())
                  for g, r in zip(grids, ref_grids))
        ties = [TH.order_dependent(TH.hash_fields(ref_grids, sums, i, 64, 36),
                                   err) for i in range(len(ref))]
        bad = sum(a != b and not t
                  for a, b, t in zip(hashes, ref_hashes, ties))
        check(err <= THUMB_GRID_ATOL and bad == 0, "spritesheet thumbhashes "
              "differ from the CPU's off a rounding tie")
        host = _host_or_missing(lambda d: spritesheet(
            asset("tiny_vp8.webm"), 64, 36, max_tiles=4,
            with_thumbhashes=True, device=d)[1:], have_ffmpeg, "ffmpeg")
        return {"tiles": len(tiles), "host": host}

    # tools/tpu_smoke.py's surfaces, in its order and by its names
    fns = {"jpeg_serving_small+gray": jpeg_serving,
           "still_input_serving": still_serving,
           "webp_yuv420_emit": webp_yuv, "gif_batch_anim": gif_batch,
           "gif_anim_group": gif_group, "webp_batch_anim": webp_batch,
           "thumbhash_golden": thumbhash, "video_first_frame": video_frame,
           "resize_exact_paths": resize_paths, "blend_orient": blend_orient,
           "avif_tone_map": avif_frame, "png_16bit_roundtrip": png16,
           "spritesheet": sprite}
    failures = []
    for name, fn in fns.items():
        t0 = time.perf_counter()
        try:
            detail = fn() or {}
            row = {"surface": name, "ok": True,
                   "s": round(time.perf_counter() - t0, 2), **detail}
        except Exception as e:  # noqa: BLE001 - every surface runs
            traceback.print_exc()
            failures.append(name)
            row = {"surface": name, "ok": False,
                   "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(row), flush=True)
    print(json.dumps({"surfaces": len(fns), "failures": failures}),
          flush=True)
    launched = {k: v for k, v in DK.launches.items() if v}
    print(f"phase 16: launches over the phase {launched}; phase took "
          f"{time.perf_counter() - t_phase:.1f}s [{card}]", flush=True)
    check(not failures, f"phase 16: surfaces failed: {failures}")


#: phase 17's requests to python -m lilliput_tpu_torch.serve_batch: 128
#: JPEGs, copies of the 1080p fixtures (every decode kernel's layout, and
#: gray o6 for dequant_idct_blocks), then a 1080p RGBA PNG and a 1080p
#: GIF, each written to a file of its own
SERVE_JPEGS = {"bench_1080p.jpg": 64, "bench_1080p_422.jpg": 16,
               "bench_1080p_440.jpg": 16, "bench_1080p_444.jpg": 16,
               "bench_1080p_gray_o6.jpg": 8, "bench_1080p_gray.jpg": 8}
#: the runs on the card, by their flags beside the requests
SERVE_RUNS = {"default": [], "warm": ["-warm"], "sharded": ["-sharded"]}
#: -warm warms every request as a spec of its own and refuses more than
#: MultiGeometryPipeline's max_geometries (64) of them, as the JAX example
#: does: its run takes the first SERVE_WARM_SHARE of each source's copies
SERVE_WARM_MAX, SERVE_WARM_SHARE = 64, 0.25


def serve_inputs(d: str):
    """Writes phase 17's requests into d; returns their paths, in order,
    and the source each is a copy of."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_gif_builders import pan_gif
    sources = {}
    for fixture in SERVE_JPEGS:
        with open(os.path.join(ASSETS, fixture), "rb") as f:
            sources[fixture] = f.read()
    from _torch_still_builders import png_bytes
    rgb = np.ascontiguousarray(fixture_pixels("bench_1080p.jpg")[..., ::-1])
    sources["rgba.png"] = png_bytes(np.concatenate(
        [rgb, alpha_ramp(*rgb.shape[:2])], axis=-1), 6)
    sources["pan.gif"] = pan_gif(rgb, rgb.shape[1], rgb.shape[0], 4,
                                 codec=True)
    names = [f for f, n in SERVE_JPEGS.items() for _ in range(n)]
    names += ["rgba.png", "pan.gif"]
    paths, of = [], {}
    for i, name in enumerate(names):
        path = os.path.join(d, f"r{i:03d}_{name}")
        with open(path, "wb") as f:
            f.write(sources[name])
        paths.append(path)
        of[path] = name
    return paths, of


def _serve(argv):
    """(exit code, stdout lines) of serve_batch.main(argv)."""
    import io
    from lilliput_tpu_torch import serve_batch
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_batch.main(argv)
    return rc, buf.getvalue().splitlines()


def _served(outdir, path):
    """The .jpeg file serve_batch wrote in outdir for the request at
    path, and its path."""
    dst = os.path.join(outdir, os.path.splitext(os.path.basename(path))[0]
                       + ".out.jpeg")
    with open(dst, "rb") as f:
        return f.read(), dst


def phase17(card, kernels):
    """The batch-serving entry point on the card:
    serve_batch.main(requests + [-width 256 -height 256 -outdir ...]) with
    its default device (cuda) over SERVE_JPEGS' 128 1080p JPEGs, a 1080p
    RGBA PNG and a 1080p GIF, once per SERVE_RUNS flag set (none, -warm,
    -sharded: parallel.make_mesh(), every card), with every launch count
    0 just before each run and read just after: every kernel launched
    (those launches join the kernels line). Gates: exit 0, a "-> file (n
    bytes)" line per request and the count line (the -warm report, the
    cache line, the mesh's size); every file of the three runs byte-equal
    across the runs and across the copies of one source (-warm over the
    first quarter of each source's copies, and refusing all 130 requests
    with ValueError, as the JAX example refuses them); each source's
    .jpeg coefficients within the step gate of the same entry point's
    files with -device cpu (one request per source there)."""
    import tempfile
    import torch
    from lilliput_tpu_torch.ops import decode_kernels as DK
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".phase17_") as d:
        paths, of = serve_inputs(d)
        firsts = {}
        for path in paths:
            firsts.setdefault(of[path], path)
        geom = ["-width", str(DST), "-height", str(DST)]
        cpu_dir = os.path.join(d, "cpu")
        t0 = time.perf_counter()
        rc, _ = _serve(list(firsts.values()) + geom
                       + ["-outdir", cpu_dir, "-device", "cpu"])
        check(rc == 0, f"serve_batch -device cpu exited {rc}")
        ref = {name: _served(cpu_dir, p)[0] for name, p in firsts.items()}
        print(f"phase 17: serve_batch -device cpu over {len(firsts)} "
              f"sources in {time.perf_counter() - t0:.1f}s", flush=True)
        copies = {}
        for p in paths:
            copies[of[p]] = copies.get(of[p], 0) + 1
        taken, warm = {}, []
        for p in paths:
            taken[of[p]] = taken.get(of[p], 0) + 1
            if taken[of[p]] <= max(1, int(SERVE_WARM_SHARE * copies[of[p]])):
                warm.append(p)
        if len(paths) > SERVE_WARM_MAX:
            try:
                _serve(paths + geom + ["-outdir", os.path.join(d, "x"),
                                       "-warm"])
            except ValueError as e:
                check("max_geometries=64" in str(e), str(e))
            else:
                raise SmokeFailure(f"-warm took {len(paths)} requests")
        runs = {}
        for run, flags in SERVE_RUNS.items():
            outdir = os.path.join(d, run)
            reqs = warm if run == "warm" else paths
            torch.cuda.synchronize()
            DK.reset_launches()
            t0 = time.perf_counter()
            rc, lines = _serve(reqs + geom + ["-outdir", outdir] + flags)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launched = dict(DK.launches)
            check(rc == 0, f"serve_batch {flags} exited {rc}")
            check(all(launched.get(k) for k in KERNELS), f"serve_batch "
                  f"{flags} launched {launched}: not every kernel")
            for k, n in launched.items():
                kernels[k]["launches"] += n
            served = [_served(outdir, p) for p in reqs]
            outs = [o for o, _ in served]
            want = [f"{p} -> {dst} ({len(o)} bytes)"
                    for p, (o, dst) in zip(reqs, served)]
            got = [ln for ln in lines if " -> " in ln]
            check(got == want, f"serve_batch {flags}: the file lines "
                  f"differ: {got[:2]} vs {want[:2]}")
            last = lines[-1]
            check(last.startswith(f"{len(reqs)} image(s) in "), last)
            if run == "warm":
                check(lines[0].startswith("warmed "), lines[0])
            check(("sharded over " if run == "sharded" else ", cache ")
                  in last, last)
            for p, o in zip(reqs, outs):
                check(o[:2] == b"\xff\xd8", f"{p} -> not a JPEG")
            by_src = {}
            for p, o in zip(reqs, outs):
                by_src.setdefault(of[p], set()).add(o)
            check(all(len(v) == 1 for v in by_src.values()),
                  f"serve_batch {flags}: copies of one source differ")
            runs[run] = dict(zip(reqs, outs))
            print(f"phase 17: serve_batch {' '.join(flags) or '(no flag)'} "
                  f"on {DEVICE}: {len(reqs)} requests in {secs:.2f}s; "
                  + (f"{lines[0]!r}; " if run == "warm" else "") +
                  f"last line {last!r}; "
                  f"launches {launched} [{card}]", flush=True)
        check(runs["sharded"] == runs["default"] and all(
            runs["default"][p] == o for p, o in runs["warm"].items()),
              "serve_batch's files differ between -warm, -sharded and no "
              "flag")
        worst, same = (0, 0, 0), 0
        for p, o in runs["default"].items():
            c = ref[of[p]]
            mx, nd, n = diff_stats(
                [torch.from_numpy(a) for a in jpeg_coefs(o)],
                [torch.from_numpy(a) for a in jpeg_coefs(c)])
            check(mx <= STEP_MAX_DIFF and nd <= STEP_MAX_SHARE * n,
                  f"{p} differs from serve_batch -device cpu: max {mx}, "
                  f"{nd}/{n} coefficients")
            worst, same = max(worst, (mx, nd, n)), same + (o == c)
    print(f"phase 17: the card's files equal across the three runs; .jpeg "
          f"coefficients vs -device cpu: worst max_abs_diff={worst[0]} "
          f"differing={worst[1]}/{worst[2]}; bytes equal in {same} of "
          f"{len(paths)}; phase took {time.perf_counter() - t_phase:.1f}s "
          f"[{card}]", flush=True)


@contextlib.contextmanager
def path_env(env):
    """The path's environment variables, restored afterwards."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


#: phase 18: distinct 12 MP sources, their batch, and the batch the plain
#: version decodes
ENTROPY_SOURCES = 16
ENTROPY_BATCH = 32
ENTROPY_PLAIN_BATCH = 4
ENTROPY_W, ENTROPY_H = 4032, 3024
ENTROPY_SEED = 3240001234


def entropy_sources(orientation: int):
    """ENTROPY_SOURCES JPEGs as the benchmark's phone12mp_o6 maker makes
    them (4:2:0, q80/85/90), at an EXIF orientation."""
    from portbench.inputs import jpeg_photos
    return jpeg_photos.make({
        "width": ENTROPY_W, "height": ENTROPY_H, "sources": ENTROPY_SOURCES,
        "qualities": [80, 85, 90], "orientation": orientation,
        "texture": 1.75, "rects": 6}, ENTROPY_SEED + orientation,
        DEVICE)["bufs"]


def _entropy_equal(pipe, bufs, what):
    """decode_entropy's device route against its host route: every array
    equal, no stream flagged."""
    import torch
    host = pipe.decode_entropy(bufs)
    dev = pipe.decode_entropy(bufs, device=DEVICE)
    status = pipe._entropy_check()[0]
    for h, d in zip(host, dev):
        check(torch.equal(torch.from_numpy(np.asarray(h)), d.cpu()),
              f"phase 18: {what}: the device decode differs")
    check(not status.any(), f"phase 18: {what}: "
          f"{int(status.count_nonzero())} streams flagged")


def phase18(card):
    import torch
    from lilliput_tpu_torch import JpegTranscodePipeline
    from lilliput_tpu_torch.ops import entropy_kernels as E
    from lilliput_tpu_torch.utils import metrics
    t_phase = time.perf_counter()
    fixtures = ["bench_1080p.jpg", "bench_1080p_o6.jpg",
                "bench_1080p_422.jpg", "bench_1080p_440.jpg",
                "bench_1080p_444.jpg", "bench_1080p_gray.jpg",
                "bench_1080p_gray_o6.jpg"]
    for name in fixtures:
        with open(os.path.join(ASSETS, name), "rb") as f:
            buf = f.read()
        pipe = JpegTranscodePipeline(buf, DST, DST, device=DEVICE)
        _entropy_equal(pipe, [buf] * 16, name)
    print(f"phase 18: {len(fixtures)} 1080p fixtures x16 equal to the host "
          f"decoder", flush=True)
    res = {}
    for orientation in (6, 1):
        srcs = entropy_sources(orientation)
        bufs = [srcs[i % len(srcs)] for i in range(ENTROPY_BATCH)]
        pipe = JpegTranscodePipeline(srcs[0], DST, DST, device=DEVICE)
        _entropy_equal(pipe, bufs, f"12 MP o{orientation}")
        tag = f"o{orientation}"
        calls = []
        launch = E.huffman_decode

        def keep(*a, **k):
            calls.append((a, k))
            return launch(*a, **k)
        E.huffman_decode = keep
        try:
            pipe.decode_entropy(bufs, device=DEVICE)
        finally:
            E.huffman_decode = launch
        a, k = calls[-1]
        ms = cuda_ms(lambda: launch(*a, **k), 10)
        scan_bytes = int(a[1].seg[:, 1].astype(np.int64).sum()) // 8
        coef_bytes = sum(o.numel() * o.element_size() for o in a[7])
        bound_ms = 1e3 * (scan_bytes + coef_bytes) / 3.35e12
        t0 = time.perf_counter()
        pcpu = JpegTranscodePipeline(srcs[0], DST, DST, device="cpu")
        pcpu.decode_entropy(bufs[:ENTROPY_PLAIN_BATCH], device="cpu")
        plain_s = time.perf_counter() - t0
        # both routes through the serving loop
        outs = {}
        for route in (True, False):
            pipe._device_entropy = route
            torch.cuda.synchronize()
            metrics.reset()
            E.launches["huffman_decode"] = 0
            outs[route] = pipe.transcode_pipelined([bufs] * 3,
                                                   return_exceptions=True)
            torch.cuda.synchronize()
            spans = [r for r in metrics.spans().records
                     if r.name == "decode"]
            launched = E.launches["huffman_decode"]
            redo = metrics.snapshot()["counters"].get(
                "serving.device_entropy_redo", 0)
            dev_lanes = sum(r.counts.get("device_entropy", 0) for r in spans)
            images = sum(r.counts["images"] for r in spans)
            check(launched == (3 if route else 0), f"phase 18: {tag}: "
                  f"{launched} launch sequences, route {route}")
            check(redo == 0, f"phase 18: {tag}: {redo} streams redone")
            check(dev_lanes == (images if route else 0), f"phase 18: "
                  f"{tag}: device_entropy {dev_lanes} of {images} images")
        pipe._device_entropy = True
        check(outs[True] == outs[False], f"phase 18: {tag}: the routes' "
              f"bytes differ")
        res[tag] = {"kernel_ms": ms, "bound_ms": bound_ms,
                    "scan_bytes": scan_bytes, "coef_bytes": coef_bytes,
                    "subsequences": a[1].nsub,
                    "plain_s": plain_s, "plain_batch": ENTROPY_PLAIN_BATCH}
        print(f"phase 18: 12 MP {tag} x{ENTROPY_BATCH}: huffman_decode "
              f"{ms!r} ms a batch, bound {bound_ms!r} ms (bytes), plain "
              f"{plain_s!r} s for {ENTROPY_PLAIN_BATCH}; both routes' bytes "
              f"equal, 3 launch sequences, no redo [{card}]", flush=True)
    print(f"phase 18: {json.dumps(res)} in "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)


def main() -> int:
    import torch
    phase1()
    from lilliput_tpu_torch import JpegTranscodePipeline
    card = card_line()
    kernels = {}
    h2d = {}
    for path, spec in PATHS.items():
        name = spec.kernel
        with open(os.path.join(ASSETS, spec.fixture), "rb") as f:
            fixture = f.read()
        with path_env(spec.env):
            if spec.env:
                print(f"phase 2: {path}: environment {spec.env}", flush=True)
            pipe = JpegTranscodePipeline(fixture, DST, DST, quality=85,
                                         device=DEVICE, **spec.kw)
            check(pipe.ncomp == spec.ncomp, f"{spec.fixture} has "
                  f"{pipe.ncomp} components, not {spec.ncomp}")
            if name and name != IDCT:
                check((pipe.geom.h2, pipe.geom.v2) == KERNELS[name][2],
                      f"{spec.fixture} is not the layout of {name}")
            bufs = [fixture] * BATCH
            worst, serving = phase2(path, pipe, bufs, name not in kernels)
            counts = phase3(path, pipe, fixture)
            t = phase4(path, pipe, bufs, serving, card)
        h2d[path] = t["h2d_ms"]
        if name in kernels:      # a later path of the same kernel
            kernels[name]["launches"] += counts[name]
            kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"],
                                               worst)
        elif name:
            source, replaces, _ = KERNELS[name]
            kernels[name] = {
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": worst, "ms": t["kernel_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "f32_ms": t["f32_ms"]}
        del serving, pipe
        torch.cuda.empty_cache()
    check(set(kernels) == set(KERNELS), f"kernels not driven: "
          f"{set(KERNELS) - set(kernels)}")
    phase5(card, kernels)
    phase6(card)
    phase7(card, kernels)
    phase8(card)
    phase9(card, kernels)
    phase10(card)
    phase11(card, kernels)
    phase12(card, kernels)
    phase13(card)
    phase14(card, kernels)
    phase15(card, kernels)
    phase16(card)
    phase17(card, kernels)
    phase18(card)
    print(f"phase 4: H2D 420_direct_s2 {h2d['420_direct_s2']!r} ms (16 of "
          f"64 lanes) vs 420 {h2d['420']!r} ms: ratio "
          f"{h2d['420_direct_s2'] / h2d['420']!r} [{card}]", flush=True)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
