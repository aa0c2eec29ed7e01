#!/usr/bin/env python3
"""Drive the torch port's paths once on one CUDA card and check them.

    python3 chip_smoke.py        # from the root of a checkout, one card
    python3 chip_smoke.py --parent DIR   # and an earlier checkout's
                                         # kernels and CLI

The main path is the 1080i -> 720p chain of ``bench.py``: YUV420P
1920x1080, batch 16, ``-I 5`` linear-blend deinterlace, ``-Z 1280x720``
Lanczos3 zoom, ``-J hqdn3d=luma=4.0`` (which runs after the zoom, at
1280x720).  Five more paths follow it, each driven on its own:

- cfg2 (``benches/run_configs.py:162-170``): 1280x720, batch 16,
  ``-J hqdn3d=luma=4.0,unsharp=luma=0.8:luma_matrix=7x5``;
- cfg4 (``run_configs.py:183-191``): 1920x1080 at 29.97 fps, batch 16,
  ``-J tomsmocomp=searcheffort=5``; its first two frames are skipped;
- denoise3d: 1280x720, batch 16, ``-J denoise3d`` at its defaults;
- cfg3 (``run_configs.py:173-181``): 720x480 at 29.97 fps, batch 16,
  ``-J 32detect,ivtc,decimate`` on 3:2 telecined content.  Its modules
  hold no kernel: the same torch code on the CPU is its plain version;
- cfg1 (``run_configs.py:108-159``): YUV420P 640x480, batch 16,
  ``colorspace.convert`` to RGB24 and back, then ``zoom_plane`` to
  512x384 / 256x192 (the zoom kernel, six launches a batch);
- the field-rate paths (``FIELD_PATHS``) on an interlaced clip with a
  moving block and a cut (``write_motion_y4m``): smartdeint, 1080i
  ``-J smartdeinter,hqdn3d=luma=4.0 -Z 1280x720``; bob, NTSC
  ``-J doublefps,smartbob`` (no kernel); modfps, NTSC with every fifth
  frame repeated, ``-J modfps=buffer=7 --export_fps 25 -Z 720x576``;
- the clean-up paths (``CLEAN_PATHS``) on the same clip with grain or
  impulse noise: dvdclean, NTSC ``-J yuvdenoise,pp=de`` (the
  ``yuvdenoise_chroma`` kernel, one launch a frame); capture, PAL
  ``-J yuvmedian,dnr,xsharpen`` (no kernel);
- the stabilization and broadcast paths (``OVERLAY_PATHS``): stabilize,
  two CLI runs on 1080p hand-held footage (``write_shaky_y4m``), pass 1
  ``-J stabilize`` (the ``stabilize_field_search`` kernel, one launch a
  batch) writing the ``.trf`` file and pass 2 ``-J transform`` reading
  it (``transform_warp`` and ``unsharp``, three launches each a batch);
  broadcast, 1080i telecined film with a station logo, ``-J
  fieldanalysis,logoaway,logo`` (the logo's chroma through
  ``zoom_pass`` at setup);
- the audio track: av, the main path at 29.97 fps with a 48 kHz stereo
  WAV of the same length through ``-p``/``-m``, ``-J
  hqdn3d=luma=4.0,normalize -E 44100`` (its kernels are the main path's;
  the audio chain is plain torch and the host stage's numpy), and
  audio_only, a 60 s WAV to WAV, once through ``-E 44100 -J
  normalize,lowpass,astat`` and once through the jitted step's form,
  ``-J normalize=algo=2,aclip,detectsilence,cpaudio``; and normalize's
  CUDA graph capture (``ops/graphs.py``) held against a captured graph
  that becomes garbage in the middle of it;
- the DVD path: ``tests/data/mpeg2/dvd.vob`` (NTSC DVD video, 720x480
  at 29.97 fps, 48 frames of MPEG-2 MP@ML frame pictures, GOP N=15 M=3,
  6000 kbit/s, a video-only program stream) through ``-x mpeg -J
  hqdn3d=luma=4.0``: the host parse (a g++ build of the port's pinned
  copy of the JAX package's C++ parser), the reconstruction on the card
  (``mpeg2_recon`` for each P and B picture, ``mpeg2_idct_intra`` for
  intra runs), hqdn3d's scans; and the same on ``dvd_fields.vob``
  (field pictures);
- the DVD rip: ``tests/data/dvd/VIDEO_TS`` (a decrypted title of NTSC
  DVD video, 720x480, 28 frames over two VOB files and two chapters,
  with a 48 kHz stereo AC-3 track) through ``-x dvd -T 1 -J
  extsub=subtitle_file=title.idx,hqdn3d=luma=4.0 -m out.wav``: the
  demux with the AC-3 decode in a worker process, the title's files
  one after the other, the subtitles' blend and the dvd path's kernels;
- the DVD authoring path, dvdauthor: 1080i at 29.97 fps with a 48 kHz
  stereo WAV through ``-I 5 -Z 720x480 -J hqdn3d=luma=4.0 -y
  mpeg2,raw,mpg -F gop_n=15:gop_m=3:rc=1:bitrate=6000`` to an MPEG-2
  MP@ML program stream with DVD LPCM (cfg6's and cfg8's encoder
  settings): the main path's zoom and hqdn3d kernels, then the
  encoder's (``mpeg2_me``, ``mpeg2_enc_pred`` with its B-mode entry
  ``mpeg2_enc_bmode``, ``mpeg2_enc_blocks``), each picture's levels coded
  on the host by the pinned syntax writer (g++) under TM5 rate control;
- the DivX path, divx: ``tests/data/mpeg4/divx.avi`` (cfg10's geometry
  and encoder settings: 640x480 at 25 fps, XVID, libavcodec mpeg4 with
  GOP 12, two B frames and 4MV, 24 frames, a 48 kHz stereo PCM track)
  through ``-x avi -J hqdn3d=luma=4.0 -y raw,raw,avi``: the AVI demux,
  the host parse of each chunk (the pinned numpy parse), each VOP
  reconstructed on the card in one launch (``mpeg4_idct_intra`` for an
  I-VOP, ``mpeg4_recon`` for a P or B VOP), hqdn3d's scans, and the avi
  multiplexor writing I420 frames and the PCM track;
- the DVD-to-DivX path, divxenc: ``tests/data/mpeg2/dvd.vob`` through
  ``-x mpeg -Z 640x480 -J hqdn3d=luma=4.0 -y xvid,raw,avi -F
  keyint=12:bframes=2:four_mv=1 -w 1500`` (cfg10's encoder settings) to
  a 640x480 XVID AVI: the DVD path's decode kernels, the zoom and
  hqdn3d's scans, then the MPEG-4 encoder's (``mpeg4_enc_me`` a P-VOP,
  ``mpeg4_enc_bme`` a B-VOP, ``mpeg4_enc_blocks`` every VOP), each VOP's
  bits written on the host from its records under TM5 rate control;
- the quarter-sample and interlaced DivX paths (``ASP_PATHS``):
  divx_qpel, ``tests/data/mpeg4/divx_qpel.avi`` (640x480 at 25 fps,
  cfg10's settings with quarter-sample: Xvid's Advanced Simple Profile)
  through divx's arguments, each P or B VOP one ``mpeg4_recon_qpel``
  launch; divx_il, ``tests/data/mpeg4/divx_il.avi`` (an NTSC capture kept
  interlaced, 720x480 at 29.97 fps, field DCT and field motion) through
  ``-x avi -I 5 -J hqdn3d=luma=4.0 -y raw,raw,avi``, each P or B VOP one
  ``mpeg4_recon_field`` launch and each I-VOP an ``mpeg4_idct_intra``
  with field DCT; the host parse is the port's ``io/mpeg4plan.py``;
- the GMC and short-header paths (``GMC_PATHS``): divx_gmc, a 640x480
  GMC stream at 25 fps (four groups of 12: an I-VOP from the port's own
  encoder, then S-VOPs with 1, 2, 3 and 2 warping points at accuracy 3,
  their macroblocks GMC skips, GMC macroblocks with a residual, 1MV and
  intra ones) written at run time from a seed (``write_gmc_avi``),
  through divx's arguments, each S-VOP an ``mpeg4_gmc_warp`` launch
  (made by the reconstruction wrapper from the VOP's warp record) and an
  ``mpeg4_recon`` launch (its GMC form); its macroblock mix and
  trajectories are synthetic, with no source, so the stream is an
  exactness fixture and its times are not a user's cost; h263,
  ``tests/data/h263/h263.avi`` (a CIF short-header stream, 48 frames at
  25 fps, GOP 12, about 400 kbit/s, fourcc FMP4) through divx's
  arguments, each P picture one ``mpeg4_recon`` launch (1MV records), each
  I picture an ``mpeg4_idct_intra``;
- the Motion-JPEG path, mjpeg: ``tests/data/mjpeg/legacy.avi`` (the
  README's legacy AVI, written by the JAX CLI with ``-y movjpeg,lame,avi
  -F MJPG``: 8 frames of dvd.vob at 640x480, a camcorder's VGA movie
  mode, 29.97 fps, baseline 4:2:0 JPEG at quality 90, 48 kHz stereo MP3)
  through ``-x avi -J hqdn3d=luma=4.0`` to a Y4M and its decoded track
  through ``-m`` to a WAV: the host's Huffman decode (a g++ build of
  ``csrc/jpeg_entropy.cpp``), ``jpeg_idct`` and ``jpeg_color`` once each
  a batch, the RGB24 entry conversion and hqdn3d's scans, the MP3 decode
  in its worker process;
- the legacy-AVI export path, mjpegenc: the dvdauthor path's 1080i with
  its WAV through ``-I 5 -Z 640x480 -J hqdn3d=luma=4.0 -y
  movjpeg,lame,avi -F MJPG`` (the README's legacy AVI, at legacy.avi's
  640x480): the zoom and hqdn3d kernels, the RGB24 conversion,
  ``jpeg_ycc_down`` and ``jpeg_fdct_quant`` once each a batch, one
  download of the coefficients, the Huffman coder on the host (a g++
  build of ``csrc/jpeg_huffenc.cpp``), the in-tree MP3 encoder at 128
  kbit/s on the writer thread and the avi multiplexor;
- the 4:2:2 path, mpeg422 (422P@ML, a studio's contribution encode):
  1080i 4:2:2 at 25 fps through ``-V yuv422p -I 5 -Z 720x576 -J
  denoise3d -y mpeg2,raw,raw -F gop_n=12:gop_m=3:rc=1:bitrate=15000``
  (the zoom and d3 scans, the search, the 4:2:2 forms of the prediction
  and the block coder, the B modes), its first frames again as field
  pictures and as the ``-R 1`` / ``-R 2`` pair, then the stream read
  back kept at 4:2:2 (``-x mpeg -V yuv422p -J denoise3d``) and decimated
  to 4:2:0 (``-x mpeg -J hqdn3d=luma=4.0``): the 4:2:2 forms of
  ``mpeg2_recon`` and ``mpeg2_idct_intra``;
- the ATSC capture path, ts1080: a transport stream (``mux_ts``: PAT, a
  PMT of stream types 0x02 and 0x81, the video's PCR in adaptation
  fields, PCR-only and null packets) of 1920x1080 top-field-first
  MPEG-2 at 15 Mbit/s (GOP 15/3, the port's own encode of
  ``write_motion_y4m``) and AC-3 at 192 kbit/s, through ``-x auto -I 5
  -Z 1280x720 -J hqdn3d=luma=4.0 -m``: the TS demux and the host parse
  on the reader thread, the AC-3 decode in the worker process,
  ``mpeg2_recon`` and ``mpeg2_idct_intra`` at 1920x1088, then the main
  path's chain; beside it a VideoCD track (``cdxa.wrap_ps`` of dvd.vob),
  PSU mode on three units, and the ``TS_GOLDEN`` cases (transport
  streams with MP2, AC-3, AAC and no audio, ``--ts_pid``, a mid-PES
  start, CDXA, PSU, ``-S``, ``-W``, ``-p`` of MP3, MP2, AC-3, FLAC and
  AAC files);
- the DivX-era rip to OGM, ogm: the DVD rip's title through ``-x dvd -T
  1 -Z 640x480 -J hqdn3d=luma=4.0 -y xvid,vorbis,ogg=fourcc=XVID -F
  keyint=12:bframes=2:four_mv=1 -w 1500`` with its own AC-3 track and
  no ``-m``: the dvd path's decode, the zoom and hqdn3d kernels, the
  three MPEG-4 encoder kernels, the numpy Vorbis encoder and the ``ogg``
  multiplexor; its Vorbis track read back by the ``ogg`` importer as
  ``-p``; beside it transcode's flagship job, the title through ``-y
  xvid,lame,avi`` without ``-m`` (its AVI holds the title's track), and
  the ``ROUTE_GOLDEN`` cases (a source's own track without ``-m``,
  audio-only sessions through the encoders and multiplexors, Ogg both
  ways, ``-m`` through the multiplexors, ``-p`` from the containers);
- the capture codecs: dv, a PAL DV camcorder clip (720x576 4:2:0, 48
  kHz stereo AAUX, written on the card by the port's own ``-y dv,raw,dv``
  and pinned by the JAX CLI's digest) through ``-x dv -J
  hqdn3d=luma=4.0 -y mpeg2,mp2enc,mpg -F
  gop_n=12:gop_m=3:rc=1:bitrate=6000`` (``dv_idct``, the hqdn3d scans,
  the MPEG-2 encoder kernels); dvenc, the main path's 1080i with its
  WAV through ``-I 5 -Z 720x576 -J hqdn3d=luma=4.0 -y dv,raw,dv``
  (``dv_fdct_cost`` twice a batch, the zoom and hqdn3d); nuv, a 640x480
  NuppelVideo capture (RTjpeg 255, 44.1 kHz PCM, written by the port's
  ``-y nuvrtj,raw,nuv``: ``rtjpeg_fdct_quant``) through ``-x nuv -I 5
  -J hqdn3d=luma=4.0 -y xvid,lame,avi`` (``rtjpeg_idct``, hqdn3d, the
  MPEG-4 encoder kernels), and its ``-y nuvrtj,raw,nuv`` re-encode;
  each output against the port's own --device cpu digest, and the
  ``CAPTURE_GOLDEN`` cases (NTSC 4:1:1 both ways, the refusals) against
  the JAX CLI's.

Phases, each of which raises on failure:

1. a CUDA card is present; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from ``tcforge_tpu_torch/csrc`` (one nvcc per
   source, all started together; sm_90a) and the host libraries (g++:
   the MPEG-2 parse and syntax writer, the JPEG entropy decode and
   Huffman encode, the DV and RTjpeg coders) beside them;
3. each kernel against its plain torch version on the card, tolerance 0
   (all of it is integer arithmetic): at its paths' shapes, and off the
   paths at ragged shapes and a band wider than the zoom's unrolled
   bound, TomsMoComp's window form over ragged planes, every effort and
   batches of 1, 2 and 17 frames, and the temporal scans at ragged,
   unaligned and aligned planes of 1 and 17 frames, two batches in a
   row, and unsharp's fifteen register instances, its tiled kernel at
   the same and at larger matrices, over ragged and aligned planes of 1
   to 17 frames; at the paths' shapes each is timed over a rotation of
   inputs larger than L2, beside its plain version, its bound (bytes or
   int32 operations) and the one PyTorch call that computes the same
   function where there is one; ``yuvdenoise_chroma`` at dvdclean's
   shape and at ragged planes; the field search and the warp at the
   stabilize path's shapes and off it (stepsize 1, 2 and 6, ragged
   frames, fields over the edges, ties, shakiness 10; every
   interpolation with and without crop); the two MPEG-2 kernels on every
   call while every stream of ``tests/data/mpeg2`` decodes (every
   picture of dvd.vob and of the field-picture stream, field MC, dual
   prime, field DCT, MPEG-1 D-pictures, sizes that are not a multiple of
   16, intra runs of 1 and 3 pictures) and timed at dvd.vob's shapes
   beside ``torch.matmul`` of their IDCT part, and the four kernels of
   the DVD rip on every call of a rip (phase 4); the MPEG-2 encoder's
   three kernels on every call of a 720x480 encode at the authoring
   path's settings and off the path (search ranges 1 to 64 with one and
   two references on ragged planes and a field of a frame, P and B
   prediction, the block coder at qs 1, 2, 8 and 31, alternate scan,
   MPEG-1, an intra mask, 4:2:2 intra planes), timed at 720x480 beside
   float64 ``torch.matmul`` of the forward DCT, and the intra-only
   encoder (the block coder under the pinned writer) against the pinned
   numpy encoder at 720x480, byte for byte; the two MPEG-4 kernels on
   every call while every stream of ``tests/data/mpeg4`` decodes
   (divx.avi's every VOP, 200x136, drop-frame and packed chunks, the
   in-tree encoder's stream) and on 24 VOPs of random records off the
   path (coefficients in [-2048, 2047], vectors far outside the frame,
   rounding 0 and 1, 1MV and 4MV, every mask, I-VOPs, grids of one
   macroblock to 720x576's), timed on divx.avi's VOPs; the three MPEG-4
   encoder kernels on every call of the divxenc path and off it
   (``MPEG4ENC_CASES``: I, P with and without 4MV, B with co-located
   skips, 200x136, one macroblock, q 1 and 31, rate control), timed
   on every one of the path's calls and clones of them past L2, their
   operation bounds from the SADs that the plain decisions' searches
   visit; the quarter-sample and interlaced
   reconstruction on every call while six streams decode
   (``ASP_STREAMS``) and on random records (every quarter phase at
   filter blocks of 16 and 8, rounding 0 and 1, field macroblocks on the
   top and bottom rows, field DCT), timed on divx_qpel's and divx_il's
   VOPs (``mpeg4_recon_qpel`` beside float32 ``F.conv2d`` of its
   filter); the GMC warp and the reconstruction on every call while
   divx_gmc's stream, two small GMC streams and the three H.263 fixtures
   decode, the GMC form of the quarter-sample and interlaced instances on
   divx_gmc's S-VOPs, and 30 random warps off the path (0 to 3 points,
   accuracy 0 to 3, display sizes that are not multiples of 16,
   trajectories far outside 1080p planes), the warp timed on divx_gmc's
   S-VOPs and on 1080p planes beside float32 ``F.grid_sample``, the GMC
   form on divx_gmc's S-VOPs; the two JPEG kernels on every call while
   every fixture of ``tests/data/mjpeg`` decodes (``MJPEG_FILES``: every
   sampling, gray, Adobe RGB, restart intervals, odd sizes, AVI1
   fields, no DHT, the MOV samples) and on random coefficient records
   (int16 over their range, 16-bit tables: the range limit wraps) and
   samples over ``JPEG_RANDOM_GEOMS``, timed on a 16-frame batch of
   legacy.avi's frames (``jpeg_idct`` beside float64 ``torch.matmul`` of
   its IDCT); the two JPEG encode kernels on the mjpegenc path's
   640x480 batch of 16 and off it (``JPEGENC_SHAPES``: 720x480, odd
   sizes, widths of 16 and less, 1x1) at qualities 10, 50, 90 and 100,
   timed on the path's batch (``jpeg_fdct_quant`` beside float64
   ``torch.matmul`` of its DCT); the four 4:2:2 forms on random records
   and grids from one macroblock to 45x36 and on every call of a
   16-frame 720x576 4:2:2 encode and its read-back, timed on those
   calls; with ``--parent DIR``, the unsharp,
   TomsMoComp and temporal kernels of the checkout in DIR are built
   too, called through DIR's own wrappers and timed in turns with this
   tree's on the same inputs;
4. each path through the port's CLI on a seeded 48-frame Y4M, with the
   launch counts set to 0 just before and read just after: every kernel
   of the path was launched, and the output equals the same chain built
   from the plain versions on the card, byte for byte; cfg3, bob and
   cfg1 against the same torch code run on the CPU in this process, and
   so capture, the small ``FLAG_CASES`` (every internal transform, on
   YUV and RGB jobs, ``-I 2``, the engine's flags, and the filters of
   plain torch ops) and ``CLEAN_FLAG_CASES`` (the clean-up filters'
   other options, their logs too), stabilize's two passes against the
   same two runs on the plain versions on the card (the ``.trf`` and
   both outputs), broadcast against its CPU run (its RESULTS lines too)
   and ``OVERLAY_FLAG_CASES``, av (its Y4M equal to the same CLI's
   without the audio track, its WAV equal to the CPU's audio-only
   session of the same samples, both files equal to the CPU's on three
   batches) and audio_only (each run's WAV equal to the CPU's), the DVD
   rip (its .y4m and .wav against the JAX-pinned digests, every kernel
   call against its plain version, and the run on the plain versions),
   dvdauthor (its program stream against the same CLI's on the plain
   versions on the card, byte for byte, and read back by the port's
   MPEG importer: every frame at 720x480, the WAV's samples in the LPCM
   track), divx (one reconstruction launch a VOP; its AVI against the
   CPU run's, byte for byte, and its chunks at ``--batch 3``), divxenc
   (one block coder launch a VOP, one decision launch a P or B VOP; its
   AVI against phase 3's run on the card, whose encoder calls were held
   to their plain versions, byte for byte: the same bytes twice; the
   whole chain is held to the JAX CLI's digest in phase 5), divx_qpel and divx_il (one
   reconstruction launch a VOP; each AVI against the CPU run's and in
   chunks at ``--batch 3``) and quarter-sample field prediction refused
   (``qpel_il.avi``, exit 1), divx_gmc and h263 (an ``mpeg4_gmc_warp``
   and an ``mpeg4_recon`` an S-VOP, an ``mpeg4_recon`` a P picture; each
   AVI against the CPU run's and in chunks at ``--batch 3``), mjpeg (one
   ``jpeg_idct`` and one ``jpeg_color`` a batch; its Y4M and WAV against
   the CPU run's and at ``--batch 3``), mjpegenc (one
   ``jpeg_ycc_down`` and one ``jpeg_fdct_quant`` a batch; its AVI equal
   to the same CLI's with every JPEG kernel call held to its plain
   version, and read back by the port's Motion-JPEG importer: 48 frames
   at 640x480 and the WAV's length of MP3 audio, the same on the card
   and the CPU), mpeg422 (each of its seven CLIs against the same CLI
   on the plain versions on the card, byte for byte, pass 1's log too;
   every decoded frame 720x576 in C422 or C420 and in its count; pass 2
   read the log), ts1080 (its Y4M and WAV against the same CLI with
   every kernel call held to its plain version and on the plain
   versions, its Y4M against the CLI on the ``.m2v`` the TS wraps, its
   WAV's samples against an audio-only session of the AC-3 it wraps; a
   VideoCD track of dvd.vob against dvd.vob; ``--psu_mode`` on three
   units against the CPU, file by file; the 1920x1088 reconstruction
   calls timed beside their plain versions), and the
   engine at every
   ``--prefetch`` 1, 2, 4 and ``--batch`` 1, 3, 16;
5. the small cases whose SHA-256 ``tests/test_torch_cli.py`` pins
   against the JAX CLI, run on the card: same digests; and the MPEG
   goldens (``MPEG_GOLDEN``: dvd.vob and the field-picture stream at full
   width and the small streams, ``-c``, ``-L``, a cut stream), and the
   DVD goldens (``DVD_GOLDEN``: the rip, ``-T 1,2``, LPCM, MP2 and AC-3
   VOBs, ``-a 1``, ``-p`` WAV beside MPEG video, ``-L`` with a track, a
   directory, extsub from a ``.spu`` and from a ``.idx``/``.sub``), and
   the export goldens (``AUTHOR_GOLDEN``: dvdauthor at 96x64, an
   ``.m2v`` at constant q, intra only (4:2:0 and 4:2:2) and an identity
   chain with their launch counts, dvd.vob re-encoded, field pictures with ``-w``, the
   yuv4mpeg encoder, raw planes), and the AVI goldens (``AVI_GOLDEN``:
   divx at full width, the small MPEG-4 streams with PCM, a batch
   boundary inside a B run, drop-frame and packed chunks, the in-tree
   encoder's stream at ``--batch 1``, divxkey, ``-c``, YUY2 and LZO2,
   the lzo encoder after ``-L``, DivX to PAL DVD, and ``ASP_GOLDEN``:
   divx_qpel and divx_il at full width, the small quarter-sample and
   interlaced streams with and without ``-I 5``), the GMC goldens
   (``GMC_GOLDEN``: divx_gmc and h263 at full width, small GMC streams
   at accuracy 2 and 1, one 200x136 with ``-I 5``, QCIF with drop-frame
   chunks and a short last batch, sub-QCIF with GOB headers at
   ``--batch 1``), the JPEG goldens (``MJPEG_GOLDEN``: mjpeg at full
   width, the small AVIs of every sampling, odd sizes, AVI1 fields, no
   DHT, MP2 and AC-3 tracks, ``-L``, the MOV files with ``jpeg`` and
   ``mjpa`` samples), the legacy-AVI and DVD-audio export goldens
   (``MJPEGENC_GOLDEN``: movjpeg and lame into an MJPG AVI, a DVD-style
   VOB with ac3enc, MP2 in a program stream and in an AVI, AC-3 in an
   AVI, MP3 at 44.1 kHz, and the mov multiplexor with photo-JPEG, YV12
   and RGB), the TS goldens (``TS_GOLDEN``), the audio-route goldens
   (``ROUTE_GOLDEN``), and the MPEG-4 export
   goldens (``XVID_GOLDEN``: divxenc at full width, the divx.avi
   re-encode with its PCM track, small DVD, DivX and Y4M cases at
   constant q, under ``-w`` and rate control, a raw ``.m4v``), with the
   read-back: the divxenc AVI decoded by the port's own MPEG-4 importer
   on the card equals its CPU decode, and 12-frame 640x480 encodes
   decode to the
   encoder's reconstruction without 4MV (with it the count of frames
   that drift from the JAX encoder's 4MV skip);
6. numbers: steady-state chain frames/s on device-resident batches
   (CUDA events) for every path, beside the host's time to queue the
   batches, the step's peak device memory and the device's busy share
   and kernel time by name (torch.profiler), and dvdclean's device
   time split between its block search, its chroma kernel, the rest of
   yuvdenoise and pp, and stabilize pass 1's between the field search
   and the rest; then each path's CLI (stabilize's two passes apart) on
   160 frames (ten batches), wall clock, with the serial engine's
   stages timed one by one beside it (``engine_stages``), and with
   ``--parent DIR`` the parent's CLI in turns on the same file; av's CLI
   with and without its audio track and through each part of the track
   alone (``AV_SPLIT``) in turns, the engine's video and audio stages
   timed inside the CLI (``_StageClock``), audio_only's seconds of
   audio per second, and the audio chain's host and device ms per batch
   (``_audio_chain_ms``); the DVD path on dvd.vob's stream three times
   over (nine batches): the host's parse a batch, decode and hqdn3d on
   the card (events, host queueing, device busy and time by kernel),
   the CLI on that stream and on dvd.vob, six runs of each in turns,
   and its serial stages (``mpeg_stages``); the DVD rip's CLI on a
   112-frame title with its track, with its track and a film's count of
   subtitle units (``film_vobsub``), and without ``-m``, two runs of
   each in turns, and its serial stages with the audio decode
   (``dvdrip_stages``), with each of the two subtitle files; the
   authoring CLI on 160 frames of 1080i with its WAV, six timed runs
   (median and spread), and the encoder's stages a batch
   (``encode_stages``: queueing, device, the levels' download, the
   syntax writer, the multiplexor); the DivX path on divx.avi twice
   over (48 frames, written by the port's AviWriter): its decode against
   the fixture's repeated, the CLI two runs after an untimed one
   (median and spread), and its serial stages (``avi_stages``: parse,
   upload, reconstruction, chain, copy back, write); the divxenc CLI on
   dvd.vob's stream three times over (144 frames), two runs after an
   untimed one, and its serial stages (``divxenc_stages``: parse, decode,
   chain, the decisions, the block coder, the records' copy, the syntax
   writer, the multiplexor); divx_qpel and divx_il on their fixtures
   twice over (24 frames), two CLI runs after an untimed one and
   ``avi_stages``; divx_gmc and h263 on their 48 frames the same way;
   mjpeg on legacy.avi's chunks repeated to 48 frames, three CLI runs
   after an untimed one (with the MP3 decoder's seconds in its process)
   and ``avi_stages`` with the track (entropy decode, upload, the two
   kernels, chain, copy back, write, the audio's read and its decode);
   mjpegenc on its 48 frames, two CLI runs after an untimed one and
   ``mjpegenc_stages`` (the wait for the chain and the kernels, the
   coefficients' download, the Huffman coder, the MP3 encoder, the
   multiplexor; the device's kernels by name); mpeg422's encode and
   two read-backs on 48 frames, three CLI runs each after an untimed
   one, ``encode_stages`` and each read-back's ``mpeg_stages`` and
   device busy time; ts1080 on its 48 frames, four CLI runs after an
   untimed one, its ``mpeg_stages`` (the video and audio PIDs' demux,
   the parse, the audio wait and the AC-3 decoder's own time,
   reconstruction, chain, copy back, write, and the importer's open)
   and the device's busy share of one CLI run; ogm on the title (28
   frames), two CLI runs with host clocks around its stages
   (``_ogm_clock``: the parse, the decode, the chain, the MPEG-4
   encoder, the Vorbis encoder apart, the multiplexor) and one under
   torch.profiler (the device's busy time and kernels by name); dv,
   dvenc and nuv on 48 frames, two CLI runs after an untimed one with
   host clocks around their stages (``_capture_rates``) and one under
   torch.profiler.

It prints one JSON object per result (``t``: seconds since it started),
then the kernels' summary and, as
its last line, ``{"ok": true, "device": {...}}``.  It imports nothing of
JAX.  Without a CUDA device it exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent

# the main path (bench.py:29-44, __graft_entry__.py:15-56)
MAIN_W, MAIN_H, MAIN_BATCH, MAIN_FRAMES = 1920, 1080, 16, 48
MAIN_ARGS = ["-I", "5", "-Z", "1280x720", "-J", "hqdn3d=luma=4.0"]

# the small golden case: port CLI == JAX CLI byte for byte on the CPU
# (tests/test_torch_cli.py), and this digest on the card
GOLDEN_W, GOLDEN_H, GOLDEN_FRAMES, GOLDEN_SEED = 128, 72, 7, 1
GOLDEN_ARGS = ["-I", "5", "-Z", "64x48", "-J", "hqdn3d=luma=4.0",
               "--batch", "3"]
GOLDEN_SHA256 = ("d722baeee4117656ce281b2d83799d44"
                 "cbe1f88ce33ef1f63f29ef87afa73784")

# the slice's paths: input geometry and fps, CLI arguments, the kernels
# each must launch, and frames out of PATH_FRAMES in
PATH_FRAMES = 48
PATHS = {
    "cfg2": dict(w=1280, h=720, fps=(25, 1),
                 args=["-J", "hqdn3d=luma=4.0,"
                             "unsharp=luma=0.8:luma_matrix=7x5"],
                 kernels=("hqdn3d_spatial_scan", "hqdn3d_temporal_scan",
                          "unsharp"), frames_out=PATH_FRAMES),
    "cfg4": dict(w=1920, h=1080, fps=(30000, 1001),
                 args=["-J", "tomsmocomp=searcheffort=5"],
                 kernels=("tomsmocomp",), frames_out=PATH_FRAMES - 2),
    "denoise3d": dict(w=1280, h=720, fps=(25, 1), args=["-J", "denoise3d"],
                      kernels=("d3_spatial_scan", "d3_temporal_scan"),
                      frames_out=PATH_FRAMES),
}
MAIN_KERNELS = ("hqdn3d_spatial_scan", "hqdn3d_temporal_scan", "zoom_pass")
MAIN_PATH = dict(w=MAIN_W, h=MAIN_H, fps=(25, 1), args=MAIN_ARGS)

# the paths' small golden cases (GOLDEN_W x GOLDEN_H, GOLDEN_FRAMES
# frames, --batch 3): SHA-256 pinned against the JAX CLI on the CPU by
# tests/test_torch_cli.py, and checked again on the card
PATH_GOLDEN_SHA256 = {
    "cfg2": ("a3be60c2f75a1bc913790dae5aaf2d60"
             "e23a8b80b09a55ac08873c4dbc1b1613"),
    "cfg4": ("9d3a4d7fd3abd5f0e9160ce937787de4"
             "00514ea141f7c248def3fa1a366f29d8"),
    "denoise3d": ("deb1783b57ff0b24a9f9bc6ca65027ae"
                  "0a3acedc9b1cd7b7425bbdeafceb4648"),
}

# cfg3: the cadence chain at NTSC size on 3:2 telecined content, and
# its small golden case (--batch 7: batches of 7, 7 and 6)
CFG3 = dict(w=720, h=480, fps=(30000, 1001), content="telecine",
            args=["-J", "32detect,ivtc,decimate"], kernels=(),
            frames_out=PATH_FRAMES - 13)
CFG3_GOLDEN = dict(w=64, h=48, frames=20, seed=9, args=[
    "-J", "32detect,ivtc,decimate", "--batch", "7"])
CFG3_GOLDEN_SHA256 = ("29d34e89df8e54f98dda96d207a315e8"
                      "c4b51a5e96599f7e22278642ace16f95")
# the small RGB case: -V rgb24 with a clip, both flips and gamma, on the
# golden input
RGB_GOLDEN_ARGS = ["-V", "rgb24", "-j", "8,16", "-z", "-l", "-G", "0.8",
                   "--batch", "3"]
RGB_GOLDEN_SHA256 = ("3ad8f423c6ac8b9c4fd0c37399ced669"
                     "38ac2833b54bf8b18dbe28992bfaf09a")
# the internal transforms and 32drop through the CLI on the golden
# input, on the card against the CPU here and against the JAX CLI in
# tests/test_torch_cli.py.  The frame count is a multiple of --batch
# where -C is on: the JAX package caches its antialias tables inside the
# first jit trace, and a second trace (a shorter last batch) fails there.
FLAG_CASES = {
    "rgb_deint3_aa_gray_swap_reduce": ["-V", "rgb24", "-I", "3", "-C", "2",
                                       "-K", "-k", "-r", "2", "--batch", "7"],
    "rgb_expand_zoom_clip": ["-V", "rgb24", "-X", "1,1,8", "-Z", "48x32",
                             "-Y", "2,-2", "--batch", "3"],
    "yuv422_shrink_aa_gamma_postclip": [
        "-V", "yuv422p", "-B", "1,2,8", "-C", "1", "-G", "1.3",
        "--post_clip", "2,4", "--batch", "7"],
    "yuv444_preclip_dropfield": ["-V", "yuv444p", "--pre_clip", "0,4", "-I",
                                 "4", "--batch", "3"],
    "yuv411_blend_zoom": ["-V", "yuv411p", "-I", "5", "-Z", "64x24",
                          "--zoom_filter", "mitchell", "--batch", "3"],
    "grow_reduce_gray_flips": ["-j-4,2", "-r", "1,2", "-K", "-l", "-z", "-I",
                               "1"],
    "rgb_aa_para": ["-V", "rgb24", "-I", "4", "-C", "1",
                    "--antialias_para", "0.5,0.2", "--batch", "7"],
    "drop32": ["-J", "32drop", "--batch", "5"],
    "ivtc_bottom_magic_decimate": ["-J", "ivtc=field=1:magic=1,decimate",
                                   "--batch", "16"],
    "deinterlace_2": ["-I", "2", "--batch", "3"],
    "engine_seek_ranges_interval": ["-L", "1", "-c", "0.0-0.2,0.3-0.6",
                                    "--frame_interval", "2", "--batch", "2",
                                    "--prefetch", "1", "-J", "null"],
    "engine_identity": ["--batch", "3"],
    "engine_max_frames_prefetch": ["--max_frames", "5", "--prefetch", "4",
                                   "-I", "5", "--batch", "1"],
    "smartyuv": ["-J", "smartyuv", "--batch", "3"],
    "smartyuv_luma_field": ["-J", "smartyuv=doChroma=0:diffmode=1:Blend=0"],
    "barrel": ["-J", "barrel=order2=0.2:order4=0.05:range=1-5/2"],
    "fps_up": ["-J", "fps=25:40", "--batch", "3"],
    "fps_down_skip": ["-J", "fps=infps=25:outfps=15,skip=0.2-0.4"],
    "slowmo": ["-J", "slowmo=factor=3", "--max_frames", "5"],
    "simple": ["-J", "invert,levels=input=16-235:gamma=1.2,"
                     "deinterlace=mode=linear_blend,"
                     "mask=lefttop=8x8:rightbot=100x60,null", "--batch", "3"],
    "testframe": ["-J", "testframe=mode=2"],
}
# the field-rate paths: interlaced content from write_motion_y4m (modfps:
# every fifth frame repeated), input geometry and fps, CLI arguments,
# the kernels each must launch (bob runs none: it is held against the
# same CLI on the CPU), frames out of PATH_FRAMES in, and the small
# golden case (GOLDEN_FRAMES, or ``frames``, of w x h, --batch 3) whose
# SHA-256 tests/test_torch_cli.py pins against the JAX CLI
FIELD_PATHS = {
    "smartdeint": dict(
        w=1920, h=1080, fps=(30000, 1001), content="motion", repeat=0,
        args=["-J", "smartdeinter,hqdn3d=luma=4.0", "-Z", "1280x720"],
        kernels=("hqdn3d_spatial_scan", "hqdn3d_temporal_scan",
                 "zoom_pass"), frames_out=PATH_FRAMES,
        golden=dict(w=64, h=48, args=["-J", "smartdeinter,hqdn3d=luma=4.0",
                                      "-Z", "48x32"])),
    "bob": dict(
        w=720, h=480, fps=(30000, 1001), content="motion", repeat=0,
        args=["-J", "doublefps,smartbob"], kernels=(),
        frames_out=2 * PATH_FRAMES,
        golden=dict(w=64, h=48, args=["-J", "doublefps,smartbob"])),
    "modfps": dict(
        w=720, h=480, fps=(30000, 1001), content="motion", repeat=5,
        args=["-J", "modfps=buffer=7", "--export_fps", "25", "-Z",
              "720x576"], kernels=("zoom_pass",), frames_out=34,
        golden=dict(w=64, h=48, frames=20,
                    args=["-J", "modfps=buffer=7", "--export_fps", "25",
                          "-Z", "64x56"])),
}
FIELD_GOLDEN_SHA256 = {
    "smartdeint": ("085dc1c239fa8d3f7cd8e6ac38cc7d6c"
                   "a4f435e6af31b1a2059b9ce4adaca41e"),
    "bob": ("29d99393f54d914868613b5dd6cc3c30"
            "f1ab8641637d7377362d440f8c264fbc"),
    "modfps": ("9134f6d84ffb9f2ce1957664edee4aa7"
               "d0fd520c9c71aedf9304771165233631"),
}
# the clean-up paths: write_motion_y4m's clip with grain a few levels deep
# (dvdclean: yuvdenoise's low-contrast gate and scene reset, pp's
# deblock) or impulse noise (capture: the median, dnr's locks and scene
# change); input geometry and fps, CLI arguments, the kernels each must
# launch (capture runs none: it is held against the same CLI on the
# CPU), frames out, and the small golden case (GOLDEN_FRAMES of w x h,
# --batch 3) whose SHA-256 tests/test_torch_cli.py pins against the JAX
# CLI
CLEAN_PATHS = {
    "dvdclean": dict(
        w=720, h=480, fps=(30000, 1001), content="motion", grain=2,
        args=["-J", "yuvdenoise,pp=de"], kernels=("yuvdenoise_chroma",),
        frames_out=PATH_FRAMES, chain_on_content=True,
        golden=dict(w=64, h=48, args=["-J", "yuvdenoise,pp=de"])),
    "capture": dict(
        w=720, h=576, fps=(25, 1), content="motion", impulses=0.02,
        args=["-J", "yuvmedian,dnr,xsharpen"], kernels=(),
        frames_out=PATH_FRAMES, chain_on_content=True,
        golden=dict(w=64, h=48, args=["-J", "yuvmedian,dnr,xsharpen"])),
}
CLEAN_GOLDEN_SHA256 = {
    "dvdclean": ("8b9cf0a9b81df4c8042c8d85e290631d"
                 "890b6b418ab97c8de75b71a313c85ff6"),
    "capture": ("6d6aec77e0340fc80a4be26d67361173"
                "d06f582aa3ab67e6900972f2d6e8a5c6"),
}
# the other clean-up filters and option families through the CLI, on
# the card against the CPU here and against the JAX CLI in
# tests/test_torch_cli.py, on CLEAN_FLAG_INPUT (64x64: yuvdenoise takes
# multiples of 16, its mode 1 splits fields at a multiple of 32);
# "{dir}" is a directory of the run's own, where write_clean_aux puts
# compare's pattern and yait's ops file, and the filters their logs
CLEAN_FLAG_INPUT = dict(w=64, h=64, fps=(30000, 1001), content="motion",
                        grain=2)
CLEAN_FLAG_CASES = {
    "pp_deint_tn": ["-J", "pp=lb/li/ci/md/fd/tn:4:12:20", "--batch", "3"],
    "pp_fast_chroma": ["-J", "pp=fa/-al/hb:32:20:y/fq:6"],
    "yuvdenoise_fields": ["-J", "yuvdenoise=mode=1:deinterlace=1",
                          "--batch", "3"],
    "yuvdenoise_pass2": ["-J", "yuvdenoise=mode=2:border=8x8-48x48"],
    "smooth": ["-J", "smooth=strength=0.6:cdiff=12", "--batch", "3"],
    "msharpen": ["-J", "msharpen=strength=150:threshold=8"],
    "compare": ["-J", "compare=pattern={dir}/pattern.png:"
                "results={dir}/compare.log:delta=40", "--batch", "3"],
    "whitebalance": ["-J", "whitebalance=level=-50:limit=+0-3+5"],
    "detectclipping": ["-J", "detectclipping=limit=30:log={dir}/clip.log",
                       "--batch", "3"],
    "facemask": ["-J", "facemask=xpos=8:ypos=8:xdim=32:ydim=24:"
                 "xresolution=8:yresolution=6"],
    "fields": ["-J", "fields=shift=1:flip=1", "--batch", "3"],
    "yait_log": ["-J", "yait=log={dir}/yait.log", "--batch", "3"],
    "yait_ops": ["-J", "yait=ops={dir}/yait.ops", "--batch", "3"],
    "denoise3d_rgb24": ["-V", "rgb24", "-J", "denoise3d", "--batch", "3"],
}
# the files the CLEAN_FLAG_CASES write besides their Y4M
CLEAN_FLAG_FILES = {"compare": "compare.log", "detectclipping": "clip.log",
                    "yait_log": "yait.log"}


def write_clean_aux(directory) -> None:
    """compare's pattern (a 40x30 RGBA PNG of gray ramps, opaque but for
    a transparent band) and yait's ops file (save, copy, drop and the
    deinterlacers over the first frames) in ``directory``."""
    from tcforge_tpu_torch.io.image import write_png
    directory = Path(directory)
    yy, xx = np.mgrid[0:30, 0:40]
    rgba = np.stack([xx * 6, yy * 8, (xx + yy) * 3,
                     np.where(xx < 6, 0, 255)], axis=-1).astype(np.uint8)
    write_png(str(directory / "pattern.png"), rgba)
    (directory / "yait.ops").write_text(
        "0: es\n1: oc\n2: d\n3: 5\n4: ec1\n5: os3\n")


def clean_flag_argv(name: str, directory) -> list:
    """CLEAN_FLAG_CASES[name] with "{dir}" made ``directory``."""
    return [a.replace("{dir}", str(directory))
            for a in CLEAN_FLAG_CASES[name]]


# the stabilization and broadcast paths.  stabilize is two CLI runs on
# hand-held footage (write_shaky_y4m): pass 1 writes the .trf file in
# the run's directory, pass 2 reads it and warps every frame (bilinear,
# then the 5x5 unsharp on all three planes); its kernels are those of
# both passes, and both runs are held against the same two runs on the
# plain versions on the card (the .trf and the Y4M bytes).  broadcast is
# telecined film with a 192x96 station logo in the top right: field
# analysis, the logo painted out by XY interpolation and a watermark
# (write_logo_png, {dir}/logo.png) stamped bottom left, whose chroma the
# Lanczos3 zoom converts at setup; it is held against the same CLI on
# the CPU, its logged RESULTS lines too.  Their small golden cases run
# in a directory of their own with the .trf named relatively (its header
# names it): SHA-256 pinned against the JAX CLI by
# tests/test_torch_cli.py and checked again on the card.
OVERLAY_PATHS = {
    "stabilize": dict(
        w=1920, h=1080, fps=(30000, 1001), content="shaky",
        passes=(["-J", "stabilize=result={dir}/shake.trf"],
                ["-J", "transform=input={dir}/shake.trf"]),
        kernels=("stabilize_field_search", "transform_warp", "unsharp"),
        frames_out=PATH_FRAMES,
        golden=dict(w=160, h=120, frames=12, batch=5, passes=(
            ["-J", "stabilize=result=shake.trf"],
            ["-J", "transform=input=shake.trf"]))),
    "broadcast": dict(
        w=1920, h=1080, fps=(30000, 1001), content="telecine",
        station=(1664, 48, 192, 96), logo=(192, 96),
        args=["-J", "fieldanalysis,logoaway=pos=1664x48:size=192x96:mode=2,"
                    "logo=file={dir}/logo.png:posdef=3:hqconv=1"],
        kernels=("zoom_pass",), frames_out=PATH_FRAMES,
        golden=dict(w=64, h=48, station=(48, 4, 12, 8), logo=(16, 8),
                    batch=3, args=[
                        "-J", "fieldanalysis,logoaway=pos=48x4:size=12x8:"
                        "mode=2,logo=file={dir}/logo.png:posdef=3:hqconv=1"])),
}
OVERLAY_GOLDEN_SHA256 = {
    "stabilize.trf": ("5c3555518d765bd5f6d1a5fa766dc969"
                      "c01e0435eecc9efd81ff64c9341754e6"),
    "stabilize": ("03733c470393143b2db3152b630d6cd9"
                  "b18b44f5b5c39ef93fb482d499c15897"),
    "broadcast": ("b050afab6b71df3d2d785543bf2c1068"
                  "789af01374924df73d6185a47a9a86a5"),
}
# the slice's other option families through the CLI on
# OVERLAY_FLAG_INPUT (the broadcast content at 64x48): on the card
# against the CPU here, against the JAX CLI in tests/test_torch_cli.py.
# "{dir}" is the run's own directory, where write_overlay_aux puts the
# logo, logoaway's shape image and a .trf of made-up transforms
OVERLAY_FLAG_INPUT = dict(w=64, h=48, fps=(30000, 1001), content="telecine",
                          station=(48, 4, 12, 8))
OVERLAY_FLAG_CASES = {
    "stabilize_algo0": ["-J", "stabilize=algo=0:result={dir}/a0.trf",
                        "--batch", "3"],
    "transform_zero": ["-J", "transform=input={dir}/rows.trf:interpol=0:"
                             "sharpen=0", "--batch", "3"],
    "transform_linear": ["-J", "transform=input={dir}/rows.trf:interpol=1:"
                               "sharpen=0"],
    "transform_quadratic_crop": ["-J", "transform=input={dir}/rows.trf:"
                                       "interpol=3:crop=1:sharpen=0"],
    "transform_bicubic": ["-J", "transform=input={dir}/rows.trf:"
                                "interpol=4:sharpen=0", "--batch", "3"],
    "transform_invert_absolute": [
        "-J", "transform=input={dir}/rows.trf:invert=1:relative=0:"
              "sharpen=0"],
    "transform_clamps": ["-J", "transform=input={dir}/rows.trf:maxshift=1:"
                               "maxangle=0.002:optzoom=0:sharpen=0"],
    "logoaway_solid_shape": ["-J", "logoaway=mode=1:pos=48x4:size=12x8:"
                                   "file={dir}/shape.ppm", "--batch", "3"],
    "logoaway_shape_border": ["-J", "logoaway=mode=3:pos=48x4:size=12x8:"
                                    "file={dir}/shape.ppm:border=1"],
    "logo_fade_range_flip": ["-J", "logo=file={dir}/logo.png:posdef=4:"
                                   "fade=2-2:range=1-5:flip=1"],
    "logo_rgbswap_grayout": ["-J", "logo=file={dir}/logo.png:pos=10x6:"
                                   "rgbswap=1:grayout=1", "--batch", "3"],
    "fieldanalysis_outdiff2": ["-J", "fieldanalysis=outdiff=2", "--batch",
                               "3"],
    "fieldanalysis_outdiff9": ["-J", "fieldanalysis=outdiff=9"],
    "29to23": ["-J", "29to23", "--batch", "3"],
    "cpaudio_logoaway": ["-J", "cpaudio,logoaway=mode=2:pos=48x4:size=12x8"],
    "hqdn3d_cpaudio": ["-J", "hqdn3d,cpaudio", "--batch", "3"],
    "rgb24_logoaway_logo": ["-V", "rgb24", "-J",
                            "logoaway=mode=2:pos=48x4:size=12x8,"
                            "logo=file={dir}/logo.png:posdef=1",
                            "--batch", "3"],
}
# the files the OVERLAY_FLAG_CASES write besides their Y4M
OVERLAY_FLAG_FILES = {"stabilize_algo0": "a0.trf"}


def write_overlay_aux(directory, logo=(16, 8)) -> None:
    """In ``directory``: the watermark ``logo.png`` (``logo`` = (w, h)),
    logoaway's shape image ``shape.ppm`` (12x8: opaque in a diamond,
    levels of alpha around it) and ``rows.trf``, nine made-up
    transforms (shifts of a few pixels, turns of a few hundredths of a
    radian)."""
    from tcforge_tpu_torch.io.image import write_image
    from tcforge_tpu_torch.modules.filters.stabilize import write_trf
    directory = Path(directory)
    write_logo_png(directory / "logo.png", *logo, seed=1)
    yy, xx = np.mgrid[0:8, 0:12]
    shape = np.where(abs(xx - 6) + abs(yy - 4) < 4, 255,
                     (xx * 20 + yy * 7) % 256).astype(np.uint8)
    write_image(str(directory / "shape.ppm"), np.stack([shape] * 3, -1))
    rng = np.random.default_rng(12)
    rows = np.stack([rng.normal(0, 2, 9), rng.normal(0, 2, 9),
                     rng.normal(0, 0.02, 9), np.zeros(9)], axis=1)
    write_trf(str(directory / "rows.trf"), list(rows), {"made": "up"})


def overlay_argv(args, directory) -> list:
    """A path's or a flag case's arguments with "{dir}" made
    ``directory``."""
    return [a.replace("{dir}", str(directory)) for a in args]


# the audio track.  av: the main path with a 48 kHz stereo s16 WAV of
# the same length through -p/-m (benches/run_configs.py:194-275, cfg5's
# audio half), on a 29.97 fps 1080i Y4M; audio_only: a WAV-to-WAV
# session of AUDIO_ONLY_SECONDS, first through -E's streaming resampler
# and op-by-op filters, then through the jitted step's form
AV_FPS = (30000, 1001)
AV_ARGS = ["-I", "5", "-Z", "1280x720", "-J", "hqdn3d=luma=4.0,normalize",
           "-E", "44100"]
AUDIO_RATE = 48000
AUDIO_ONLY_SECONDS = 60
AUDIO_ONLY_RUNS = {
    "resampled": ["-E", "44100", "-J", "normalize,lowpass,astat"],
    "jitted": ["-J", "normalize=algo=2,aclip,detectsilence,cpaudio"]}
# the small cases whose digests tests/test_torch_cli.py pins against the
# JAX CLI: the golden 128x72 Y4M (7 frames at 25 fps) with a WAV of the
# same length, and a 1 s WAV alone
AUDIO_GOLDEN_SECONDS = 1
AUDIO_GOLDEN_ARGS = {
    "av": ["-J", "hqdn3d=luma=4.0,normalize", "-E", "44100", "--batch", "3"],
    "av_jitted": ["-J", "hqdn3d=luma=4.0,normalize", "--batch", "3"],
    "volume_mono": ["-s", "1.5", "-d", "1", "--batch", "3"],
    "volume_mono_resampled": ["-s", "1.5", "-d", "1", "-E", "44100",
                              "--batch", "3"],
    "audio_only_resampled": AUDIO_ONLY_RUNS["resampled"],
    "audio_only_jitted": AUDIO_ONLY_RUNS["jitted"]}
AUDIO_GOLDEN_SHA256 = {
    "av.y4m": ("0c2b3b73ad48850154542efadbcb25c2"
               "1c8d0524ac0b7e023f45ff0f6f50f81c"),
    "av.wav": ("83747203c054b14edadbde028a29b99e"
               "46a523cf057f3a6d45b4fbc4cba85f38"),
    "av_jitted.y4m": ("0c2b3b73ad48850154542efadbcb25c2"
                      "1c8d0524ac0b7e023f45ff0f6f50f81c"),
    "av_jitted.wav": ("e8c5c1ded933efbc61a885d23fd7e670"
                      "40d8228842e9600568e1ade963e67d8e"),
    "volume_mono.y4m": ("d83353fa52bc611c2bc9e0440f0652fb"
                        "f820a8043da64d7e2eb4c6ca25733c7b"),
    "volume_mono.wav": ("6f9cf688c9305614b3d4d7b6a5bdda1a"
                        "517295c53e897c0bcd236c3beb659086"),
    "volume_mono_resampled.y4m": ("d83353fa52bc611c2bc9e0440f0652fb"
                                  "f820a8043da64d7e2eb4c6ca25733c7b"),
    "volume_mono_resampled.wav": ("cb90a727f3c70217348eb3f036c11d91"
                                  "ae57cf88fa431c76a24385c57a75d203"),
    "audio_only_resampled.wav": ("fd5949d35bfb0d01234064eaeb11c2de"
                                 "dcd1c595d4d2c60a657e5c266e45279a"),
    "audio_only_jitted.wav": ("0ecb988d10992123221868bda185808f"
                              "3f0596527428938579fe45cdee1075f8")}


def audio_golden_inputs(directory) -> dict:
    """The small audio cases' inputs in ``directory``: the golden Y4M,
    its WAV (1920 samples a frame at 25 fps) and the 1 s WAV."""
    d = Path(directory)
    paths = {"y4m": d / "golden_av.y4m", "wav": d / "golden_av.wav",
             "long": d / "golden_long.wav"}
    write_test_y4m(paths["y4m"], GOLDEN_W, GOLDEN_H, GOLDEN_FRAMES,
                   GOLDEN_SEED)
    spf = AUDIO_RATE // 25
    write_test_wav(paths["wav"], GOLDEN_FRAMES * spf, GOLDEN_SEED,
                   frame=spf)
    write_test_wav(paths["long"], AUDIO_GOLDEN_SECONDS * AUDIO_RATE,
                   GOLDEN_SEED + 1, frame=spf)
    return paths


def audio_golden_argv(case: str, paths: dict, out) -> list:
    """The CLI arguments of an audio golden case, writing ``out``.y4m and
    ``out``.wav (the audio-only cases ``out``.wav alone)."""
    if case.startswith("audio_only"):
        return ["-i", str(paths["long"]), "-o", f"{out}.wav",
                *AUDIO_GOLDEN_ARGS[case]]
    return ["-i", str(paths["y4m"]), "-p", str(paths["wav"]), "-o",
            f"{out}.y4m", "-m", f"{out}.wav", *AUDIO_GOLDEN_ARGS[case]]


# the DVD path: MPEG-2 import of tests/data/mpeg2/dvd.vob (NTSC DVD
# video, 720x480 at 29.97 fps, 48 frames, MP@ML frame pictures, GOP N=15
# M=3, 6000 kbit/s, a video-only program stream; make_streams.py writes
# it with the JAX package's encoder) into hqdn3d, and the same on the
# field-picture stream; the kernels of both
MPEG_DATA = ROOT / "tests" / "data" / "mpeg2"
DVD_ARGS = ["-x", "mpeg", "-J", "hqdn3d=luma=4.0"]
DVD_W, DVD_H, DVD_FRAMES = 720, 480, 48
MPEG_KERNELS = ("mpeg2_recon", "mpeg2_idct_intra", "hqdn3d_spatial_scan",
                "hqdn3d_temporal_scan")
# the stream cut mid-picture: the first bytes of small.m2v
MPEG_CUT = ("small.m2v", 7000)
# the whole-path goldens: the port's CLI on the stream with the
# arguments, SHA-256 pinned against the JAX CLI (with --mesh off) by
# tests/test_torch_cli.py and tests/test_torch_mpeg_import.py on the CPU,
# and checked again on the card
MPEG_GOLDEN = {
    "dvd": ("dvd.vob", DVD_ARGS + ["--batch", "16"]),
    "dvd_fields": ("dvd_fields.vob", DVD_ARGS + ["--batch", "16"]),
    "small_ps": ("small.mpg", ["-J", "hqdn3d=luma=4.0", "--batch", "3"]),
    "small_es": ("small.m2v", ["-x", "mpeg2", "--batch", "4"]),
    "fields": ("fields.m2v", ["-x", "vob", "-J", "hqdn3d=luma=4.0",
                              "--batch", "3"]),
    "mpeg1": ("mpeg1.m1v", ["--batch", "5"]),
    "dpict": ("dpict.m1v", ["-x", "mpg", "--batch", "3"]),
    "intra": ("intra.m2v", ["--batch", "3"]),
    "odd": ("synth_odd.m2v", ["--batch", "3"]),
    "synth": ("synth_tff0.m2v", ["--batch", "2"]),
    "synth_fields": ("synth_fields.m2v", ["--batch", "4"]),
    "ranges": ("small.mpg", ["-c", "0.2-0.9,0.12-0.17", "--batch", "3"]),
    "seek": ("small.mpg", ["-L", "5", "--batch", "3"]),
    "seek_es": ("small.m2v", ["-L", "4", "--max_frames", "7", "--batch",
                              "2"]),
    "b_run": ("small.m2v", ["--batch", "2", "--frame_interval", "2"]),
    "cut": (None, ["--batch", "3"]),
}
MPEG_GOLDEN_SHA256 = {
    "dvd": "9a2358e8def4fef5d45e0ac141498b349cb07a1bde50e6ae3120e8dfc339c4ef",
    "dvd_fields":
        "c6f90f999bd14c3675e0bbbd3c1079e1b2399bf88f9980ae832b9262caab8194",
    "small_ps":
        "306b35473395dda48e1169b1464f7254fc48467212aecf410ebe8ac99f4114ea",
    "small_es":
        "79671d4a1a819c6b7b79db1a53162975e9f7b77fbcb25d5b1a5708b802780a13",
    "fields":
        "25dd90665f93e09bd06af58884bb5f8dbfe591e11596760d50fa959b8eb4d747",
    "mpeg1":
        "d3c3e17e5ed4111bf69feb64294107f7d7eabd3ea346d37c2511997b8563f12c",
    "dpict":
        "cafa6098b4176694d66380e7a230ff1d20f7fdc24c30d94f676892f4ac34fc62",
    "intra":
        "34757c1b3e9db385abc5f46c2874b2ebbd67c07069d58e66e1d104028d305f5d",
    "odd": "0047a816ed547ed20fef6c4302415ea62430cf91ec586c14e97e66203b7d279f",
    "synth":
        "668fb2cdb277c3834ecf4cbac8aac352998c1b4dd43b20730898b4cc36361ff6",
    "synth_fields":
        "b54d0655a69cf043463be6a8f4e6f1633e9f13a9519230f6bed2c74c6c08ecfb",
    "ranges":
        "f6eac6209ef4c53595dc39cfbeed120f519588a28591928840b93953ec95fae5",
    "seek": "053a6467236db2a67d18193158e55314e2d68461ec4547c86c71dd010f0970c3",
    "seek_es":
        "d1ed0f4421836872518c98ee3dacf58f65065f0dd120fa558014f9433706081b",
    "b_run":
        "f92a7d04304b583ed3cdbe0190bda2ba4976bc36726015293e2e12e977f7eda9",
    "cut": "f90d2d57f6fd146cef24e16bb83e0f76398479aeec423fbb57051c1f99a025f3",
}


# the DVD rip: tests/data/dvd (make_streams.py there), a decrypted
# VIDEO_TS title of NTSC DVD video (720x480, 28 frames, MPEG-2 MP@ML,
# GOP N=15 M=3, about 1.7 Mbit/s) with a 48 kHz stereo AC-3 track at
# 192 kbit/s, over two VOB files and two chapters, read with -x dvd -T
# and its VobSub subtitles burnt in by extsub before hqdn3d, with -m for
# the track; small program streams with each kind of DVD audio and
# subtitles beside it.  The goldens' SHA-256 (the .y4m and the .wav) are
# pinned against the JAX CLI with the FFmpeg bridge off (its in-tree
# decoders) by tests/test_torch_dvd_audio.py and test_torch_dvd_title.py
DVD_DATA = ROOT / "tests" / "data" / "dvd"
RIP_ARGS = ["-x", "dvd", "-T", "1", "-J",
            "extsub=subtitle_file={dvd}/title.idx,hqdn3d=luma=4.0"]
DVD_GOLDEN = {
    "rip": ("VIDEO_TS", RIP_ARGS),
    "chapter2": ("VIDEO_TS", ["-x", "dvd", "-T", "1,2", "--batch", "5"]),
    "lpcm": ("lpcm.vob", ["--batch", "3"]),
    "mp2": ("mp2.vob", ["--batch", "5"]),
    "ac3": ("ac3.vob", []),
    "ac3_b3": ("ac3.vob", ["--batch", "3", "-J", "hqdn3d=luma=4.0"]),
    "track1": ("ac3x2.vob", ["-a", "1", "--batch", "4"]),
    "wav": ("mp2.vob", ["-p", "{wav}", "--batch", "5"]),
    "seek": ("ac3.vob", ["-L", "3", "--batch", "4"]),
    "dir": ("{dir}", ["--batch", "5"]),
    "extsub_spu": ("ac3.vob", ["-J", "extsub=subtitle_file={dvd}/small.spu",
                               "--batch", "5"]),
    "extsub_idx": ("mp2.vob", ["-J", "extsub=subtitle_file={dvd}/small.idx:"
                               "track=1:vertshift=5", "--batch", "5"]),
}
DVD_GOLDEN_SHA256 = {
    "rip": (
        "613b85beef38dc4d9fdb7cb555b25ac0a2ff42a2fa73280024c9aba4197357cf",
        "e1df5a4cf82a5ad765f071a892f745b5356451ae50f589ced46d7b2698a1f302"),
    "chapter2": (
        "6cb93bb655464e55a0b797fbf00008497420fb8785277d415acc8fe357850db0",
        "99216dadd5530114134127b528e8664f7af607aee23c13a28f6451203fe9b752"),
    "lpcm": (
        "f9df8ba1aa7a769be9ec1ee6b4990e39a2f89fbbf94a08eb56fb6c13dcc1ed4d",
        "c487f8fe6f90e15d8899686af25953efbf986ef1bd547bca3b99ca2a98c1697d"),
    "mp2": (
        "00aea5eee3a3cec4c6e9438904a77d2c5c973a96fcadf37cd864d01bdfcc8481",
        "68ae7165ac3f17ba0661fb3b0fe61da0d26ee2b8ac0dfc1e28592fdd01231417"),
    "ac3": (
        "00aea5eee3a3cec4c6e9438904a77d2c5c973a96fcadf37cd864d01bdfcc8481",
        "1443adb6303e7fa95ac2f0510eff72ffdfc94e77b10a39fab345fc440bf47c72"),
    "ac3_b3": (
        "0dc50787b43495986705ec7293fd4169696dccf31430badc9ba4a817f337086c",
        "1443adb6303e7fa95ac2f0510eff72ffdfc94e77b10a39fab345fc440bf47c72"),
    "track1": (
        "00aea5eee3a3cec4c6e9438904a77d2c5c973a96fcadf37cd864d01bdfcc8481",
        "33534321124f8e72688d5ab711581d9e4cb63dcb39434887bf2fdb709ae11081"),
    "wav": (
        "00aea5eee3a3cec4c6e9438904a77d2c5c973a96fcadf37cd864d01bdfcc8481",
        "ab331689c92ff5aa559af211eabb7049e595ca6751529ce73d6301892aa1c3d0"),
    "seek": (
        "88c84dabec539f330d8772b7722d260e4987bc4a20dbeb5a2f40327e4bb2e66c",
        "aa3b98cfec2519e5d20e8c92b3555178ff205ecc40d232eb295eda018718bef5"),
    "dir": (
        "ce5651e90950cb499ac5d0060d5e1a3f45327dfaca981a59e22743a3139404d4",
        "d0adc6576bb555e5881d3ac337549a6f68fc384a71acc01c1f139d400a0dce5c"),
    "extsub_spu": (
        "3caafdbffeee4cbc468cf454f3ec3af8f7dec224d7d7b9e3f3fcd9c5f29b9bfd",
        "1443adb6303e7fa95ac2f0510eff72ffdfc94e77b10a39fab345fc440bf47c72"),
    "extsub_idx": (
        "598dea7dcee008e95ed20672af67acf2a4454278e2c0709d43da2c43f97520d0",
        "68ae7165ac3f17ba0661fb3b0fe61da0d26ee2b8ac0dfc1e28592fdd01231417"),
}


def dvd_golden_argv(case: str, directory, out) -> list:
    """The CLI arguments of a ``DVD_GOLDEN`` case, writing ``out``.y4m and
    ``out``.wav; the inputs it needs beyond tests/data/dvd are written
    into ``directory``: ``{wav}`` a seeded 48 kHz stereo WAV of one
    second, ``{dir}`` a directory holding ac3.vob and mp2.vob (played one
    after the other)."""
    directory = Path(directory)
    src, args = DVD_GOLDEN[case]
    names = {"dvd": str(DVD_DATA), "wav": str(directory / "dvd_in.wav"),
             "dir": str(directory / "vobs")}
    if "{wav}" in " ".join(args) and not Path(names["wav"]).exists():
        write_test_wav(names["wav"], 48000, seed=17)
    if src == "{dir}" and not Path(names["dir"]).exists():
        Path(names["dir"]).mkdir()
        for k, name in enumerate(("ac3.vob", "mp2.vob")):
            (Path(names["dir"]) / f"{k + 1}.vob").write_bytes(
                (DVD_DATA / name).read_bytes())
    src = (src.format(**names) if src.startswith("{")
           else str(DVD_DATA / src))
    return ["-i", src, "-o", f"{out}.y4m", "-m", f"{out}.wav",
            *(a.format(**names) for a in args)]


def mpeg_golden_input(case: str, directory) -> Path:
    """The stream of an ``MPEG_GOLDEN`` case: a file of
    tests/data/mpeg2, or for ``cut`` the first ``MPEG_CUT`` bytes of one,
    written into ``directory``."""
    name = MPEG_GOLDEN[case][0]
    if name is not None:
        return MPEG_DATA / name
    src, nbytes = MPEG_CUT
    out = Path(directory) / "cut.m2v"
    out.write_bytes((MPEG_DATA / src).read_bytes()[:nbytes])
    return out


# the DivX path: tests/data/mpeg4/divx.avi (make_streams.py there), cfg10's
# geometry and encoder settings (benches/run_configs.py:564-660): 640x480
# at 25 fps, XVID, libavcodec mpeg4 with GOP 12, two B frames and 4MV,
# about 1.5 Mbit/s, 24 frames, a 48 kHz stereo PCM track; through -x avi
# -J hqdn3d=luma=4.0 -y raw,raw,avi (raw I420 frames and the PCM track in
# one AVI).  The host parses each chunk (the pinned numpy parse), the
# card reconstructs each VOP (mpeg4_idct_intra or mpeg4_recon), then
# hqdn3d's scans
MPEG4_DATA = ROOT / "tests" / "data" / "mpeg4"
DIVX_ARGS = ["-x", "avi", "-J", "hqdn3d=luma=4.0", "-y", "raw,raw,avi"]
DIVX_W, DIVX_H, DIVX_FRAMES = 640, 480, 24
AVI_KERNELS = ("mpeg4_recon", "mpeg4_idct_intra", "hqdn3d_spatial_scan",
               "hqdn3d_temporal_scan")
# the Xvid-ASP path, divx_qpel: tests/data/mpeg4/divx_qpel.avi, cfg10's
# geometry and settings (640x480 at 25 fps, GOP 12, two B-VOPs, 4MV)
# with quarter-sample, about 1 Mbit/s, 12 frames; each P or B VOP one
# mpeg4_recon_qpel launch, through the divx path's arguments
QPEL_KERNELS = ("mpeg4_recon_qpel", "mpeg4_idct_intra",
                "hqdn3d_spatial_scan", "hqdn3d_temporal_scan")
# the interlaced-capture path, divx_il: tests/data/mpeg4/divx_il.avi, an
# NTSC capture kept interlaced (720x480 at 29.97 fps, 12 field-sampled
# frames, field DCT and field motion, GOP 12, two B-VOPs, about 1
# Mbit/s), deinterlaced by -I 5; each P or B VOP one mpeg4_recon_field
# launch, each I-VOP an mpeg4_idct_intra with field DCT
DIVX_IL_ARGS = ["-x", "avi", "-I", "5", "-J", "hqdn3d=luma=4.0", "-y",
                "raw,raw,avi"]
FIELD_KERNELS = ("mpeg4_recon_field", "mpeg4_idct_intra",
                 "hqdn3d_spatial_scan", "hqdn3d_temporal_scan")
# the two paths: (fixture, arguments, frames, kernels, width, height)
ASP_PATHS = {"divx_qpel": ("divx_qpel.avi", DIVX_ARGS, 12, QPEL_KERNELS, 640,
                           480),
             "divx_il": ("divx_il.avi", DIVX_IL_ARGS, 12, FIELD_KERNELS,
                         720, 480)}
# the AVI goldens: the port's CLI on a fixture with the arguments ("{dir}"
# the output directory), its outputs' SHA-256 pinned against the JAX CLI
# (TCFORGE_NATIVE_MPEG4=1, the numpy decode; --mesh off) by
# tests/test_torch_mpeg4.py on the CPU, and checked again on the card
AVI_GOLDEN = {
    "divx": ("divx.avi", DIVX_ARGS + ["--batch", "16"], ("out.avi",)),
    "small": ("small.avi", ["-J", "hqdn3d=luma=4.0", "--batch", "3", "-m",
                            "{dir}/out.wav"], ("out.y4m", "out.wav")),
    "odd_b4": ("odd.avi", ["-x", "avi", "-y", "raw,raw,avi", "--batch", "4"],
               ("out.avi",)),
    "packed": ("packed.avi", ["--batch", "2"], ("out.y4m",)),
    "drop": ("drop.avi", ["-y", "raw,raw,avi", "--batch", "3"],
             ("out.avi",)),
    "native_b1": ("native.avi", ["--batch", "1"], ("out.y4m",)),
    "divxkey": ("small.avi", ["-J", "divxkey", "-y", "raw,raw,avi",
                              "--batch", "5"], ("out.avi",)),
    "ranges": ("odd.avi", ["-c", "0.2-0.5,0.7-0.9", "--batch", "3"],
               ("out.y4m",)),
    "yuy2": ("yuy2.avi", ["-y", "raw,raw,avi"], ("out.avi",)),
    "lzo": ("lzo.avi", ["-J", "hqdn3d", "-y", "raw,raw,avi"], ("out.avi",)),
    "lzo_seek": ("lzo.avi", ["-L", "2", "-y", "lzo,raw,avi", "-F", "LZO2"],
                 ("out.avi",)),
    "pal_dvd": ("divx.avi", ["-Z", "720x576", "-y", "mpeg2,raw,mpg",
                             "--max_frames", "6", "--batch", "3"],
                ("out.mpg",)),
    "divx_qpel": ("divx_qpel.avi", DIVX_ARGS + ["--batch", "16"],
                  ("out.avi",)),
    "divx_il": ("divx_il.avi", DIVX_IL_ARGS + ["--batch", "16"],
                ("out.avi",)),
    # the small ones; a batch of 2 or 5 ends inside a B run
    "qpel_small": ("qpel_small.avi", ["-y", "raw,raw,avi", "--batch", "2"],
                   ("out.avi",)),
    "qpel_small_i5": ("qpel_small.avi", ["-I", "5", "--batch", "4"],
                      ("out.y4m",)),
    "il_small": ("il_small.avi", ["-y", "raw,raw,avi", "--batch", "5"],
                 ("out.avi",)),
    "il_small_i5": ("il_small.avi", ["-I", "5", "-y", "raw,raw,avi",
                                     "--batch", "2"], ("out.avi",)),
}
AVI_GOLDEN_SHA256 = {
    "divx": (
        "1cc28b2e5b3ad0ba71e28e1431ad662ed3c40b7d8f28ea19658bf424b0d332a7",),
    "small": (
        "f7bc7485f9f86f9194a4731faff30262268b7f2b5bde6d5b759ba50eec0db2d0",
        "0d5b30e1755a1715c641d2674c7eb5d4d5ee78a3beeea81766809e7c040c99b2",),
    "odd_b4": (
        "24d34431b3a540854ba8d4e980ae7024ca3b787d33c3b03c2ece46d83d2a8b8e",),
    "packed": (
        "3ae1b1f5176df16846eeec7417a2376c3a79a3b8821fb79c19078f9f01f20ff9",),
    "drop": (
        "b341030463574757fd48fcfcfee121822544b5539e1d80e5e5a00def7c381f88",),
    "native_b1": (
        "3b9a5b0b920291e14bd1545b112c290b6282c139e6d7e044f342ff83f9e969b2",),
    "divxkey": (
        "47c5e9762780cfbce8d8cde794122b0510f5238b73a84af37964adbb8e19a486",),
    "ranges": (
        "5c5abcc47b81784a10209fc67a7d865618ab1c80d4763677a84dce4a24c161df",),
    "yuy2": (
        "741f046049c1db683de3168d109a81e475a05cc21f2fac40bde56f22cce75933",),
    "lzo": (
        "cddb15922ffe8234d6b5e4dff31adc0fd24a79995158a95bbbd6c0034dfbfc57",),
    "lzo_seek": (
        "96fb2b9e86e8416696def2352c95c8d574a2d15dc9b621343f634ae5a9027d40",),
    "pal_dvd": (
        "71e46118ec59739df0bfe5f74043366382b63c85d10e349a8277028b2304674a",),
    "divx_qpel": (
        "306ed96e95ef64bdacb82780adb49d63ef88cb2b0ee4dcb26cf7599f506f5d39",),
    "divx_il": (
        "38f2ced0c53272c2b4c8c433932e858b9027b845b8354085ad4b334a770fafc3",),
    "qpel_small": (
        "dfa485658d7d1f39222ea7b490a11344bb5867a4ba069cb4f1aecb1f2f942ac3",),
    "qpel_small_i5": (
        "18bec79022873d82fa921eb4c1913b33d73a15e21392bc32b2c536bc5905458d",),
    "il_small": (
        "a8893a2a6bb4514f0a4c0f7c69e592de0b8c6739fd8253a28a58760c01350336",),
    "il_small_i5": (
        "3f4e9f15e09e4ecceb9920aa1d8a29ab5b08437005db57fa12ca33ebd949d010",),
}
# the AVI goldens of the quarter-sample and interlaced fixtures, which
# tests/test_torch_mpeg4_asp.py runs through both CLIs
ASP_GOLDEN = ("divx_qpel", "divx_il", "qpel_small", "qpel_small_i5",
              "il_small", "il_small_i5")


def encoder_clip(width: int, height: int, frames: int, seed: int,
                 kind: str = "wave"):
    """Seeded YUV420P frames for the MPEG-4 encoder's checks, as numpy
    (y, u, v) tuples.  ``wave``: moving sine gratings with grain and
    moving chroma ramps (every macroblock moves: searches, half-pel,
    4MV, intra in the grain); ``still``: a smooth random texture in which
    each macroblock's top-left 8x8 quadrant shifts by -1, 0 or 1 sample
    from frame to frame and the rest stays (4MV macroblocks whose 1MV
    vector is (0, 0), the JAX encoder's not_coded case, and B-VOPs with
    co-located skips)."""
    rng = np.random.default_rng(seed)
    ch, cw = (height + 1) // 2, (width + 1) // 2
    out = []
    if kind == "wave":
        yy, xx = np.mgrid[0:height, 0:width]
        cy, cx = np.mgrid[0:ch, 0:cw]
        for t in range(frames):
            y = (128 + 60 * np.sin((xx + 3 * t) / 7.0)
                 + 40 * np.cos((yy - 2 * t) / 5.0)
                 + rng.normal(0, 6, (height, width)))
            u = (cy * 4 + t * 3) % 256
            v = (cx * 6 - t * 5) % 256
            out.append((y.clip(0, 255).astype(np.uint8), u.astype(np.uint8),
                        v.astype(np.uint8)))
        return out
    base = rng.integers(40, 216, (height + 8, width + 8)).astype(np.int64)
    base = ((base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3)
    base = base.astype(np.uint8)
    for t in range(frames):
        y = base[4:4 + height, 4:4 + width].copy()
        for by in range(0, height, 16):
            for bx in range(0, width, 16):
                s = (t + bx // 16 + by // 16) % 3 - 1
                blk = base[4 + by + s:12 + by + s, 4 + bx + s:12 + bx + s]
                y[by:by + 8, bx:bx + 8] = blk[:max(0, min(8, height - by)),
                                              :max(0, min(8, width - bx))]
        u = np.full((ch, cw), 128, np.uint8)
        out.append((y, u, u.copy()))
    return out


# the GMC DivX path, divx_gmc: cfg10's geometry (640x480 at 25 fps, DIVX
# fourcc), four groups of 12 VOPs (an I-VOP, then eleven S-VOPs), written
# at run time from a seed by write_gmc_avi: each group's VOL with its
# count of warping points (GMC_POINTS) at sprite_warping_accuracy 3 (what
# DivX and Xvid emit), each S-VOP's macroblocks a seeded mix of GMC skips,
# GMC macroblocks with a residual, 1MV inter macroblocks and intra ones;
# each S-VOP one mpeg4_gmc_warp and one mpeg4_recon launch, through the
# divx path's arguments
GMC_W, GMC_H, GMC_GROUPS, GMC_GOP, GMC_SEED = 640, 480, 4, 12, 41
GMC_POINTS = (1, 2, 3, 2)
GMC_FRAMES = GMC_GROUPS * GMC_GOP
# a macroblock of an S-VOP: GMC skip, GMC with a residual, 1MV, intra; a
# synthetic mix with no source (no DivX 5 or Xvid GMC stream's statistics
# are in the repo), chosen to hold every form; so are the trajectories'
# ranges and the residuals
GMC_MIX = (0.6, 0.2, 0.12, 0.08)
GMC_KERNELS = ("mpeg4_gmc_warp", "mpeg4_recon", "mpeg4_idct_intra",
               "hqdn3d_spatial_scan", "hqdn3d_temporal_scan")


def _put_traj(w, v: int) -> None:
    """One trajectory difference (``Mpeg4Decoder._read_traj_dmv``)."""
    from tcforge_tpu_torch.io.mpeg4dec import Mpeg4Decoder
    size = abs(int(v)).bit_length()
    n = Mpeg4Decoder._TRAJ_LENS[size]
    w.put(0 if size == 0 else (1 + size if size <= 5 else (1 << n) - 2), n)
    if size:
        w.put(v if v > 0 else v + (1 << size) - 1, size)
    w.put(1, 1)                          # marker


class GmcWriter:
    """An MPEG-4 Advanced Simple stream with GMC, chunk by chunk: each
    group's headers (the VOL with ``sprite_enable`` 2, its warping points
    and ``accuracy``) and I-VOP, coded by the port's own encoder
    (``io/mpeg4enc.Mpeg4Encoder`` at constant q on the CPU), then S-VOPs
    written with the pinned syntax writer (``io/mpeg4syntax.py``): random
    trajectories, and each macroblock drawn from ``GMC_MIX`` (a GMC skip,
    a GMC macroblock with random residual levels, a 1MV macroblock whose
    vector lies near its average GMC vector, with a residual, or an intra
    macroblock of the group's frame's block means), the vector predictor
    and DC prediction kept as the decoder keeps them.  A ``quarter``
    (quarter-sample) VOL's 1MV vectors are quarter-sample ones; an
    ``interlaced`` VOL's VOPs carry the field flags, its I-VOPs are the
    writer's own (intra macroblocks of block means, the encoder has no
    interlaced syntax), and each coded macroblock a random dct_type (1MV
    ones frame-predicted)."""

    def __init__(self, width: int, height: int, seed: int,
                 accuracy: int = 3, qscale: int = 4, fps: int = 25,
                 quarter: bool = False, interlaced: bool = False):
        from tcforge_tpu_torch.io import mpeg4dec
        from tcforge_tpu_torch.io.mpeg4enc import Mpeg4Encoder
        self.enc = Mpeg4Encoder(width, height, fps=fps, qscale=qscale,
                                gop=1)
        self.enc._wrote_headers = True
        self.dec = mpeg4dec.Mpeg4Decoder()
        vol = mpeg4dec._VOL()
        vol.width, vol.height = width, height
        vol.sprite_enable, vol.sprite_accuracy = 2, accuracy
        self.dec.vol = vol
        self.dec._mbw, self.dec._mbh = self.enc.mbw, self.enc.mbh
        self.rng = np.random.default_rng(seed)
        self.disp = self.tb = 0
        self.quarter, self.interlaced = int(quarter), int(interlaced)

    def headers(self, points: int, sprite: int = 2,
                brightness: int = 0) -> bytes:
        """The visual object sequence and the VOL: GMC (``sprite`` 2) with
        ``points`` warping points, or another ``sprite_enable`` and a
        brightness change flag, which the decoder refuses."""
        from tcforge_tpu_torch.io.mpeg4syntax import BitWriter
        e, w = self.enc, BitWriter()
        self.dec.vol.sprite_points = points
        for v, n in ((0x000001B0, 32), (0xF3, 8), (0x000001B5, 32), (0, 1),
                     (1, 4), (0, 1)):
            w.put(v, n)                  # ASP@L3; a video object
        w.stuff()
        gmc = ((points, 6), (self.dec.vol.sprite_accuracy, 2),
               (brightness, 1)) if sprite == 2 else ()
        for v, n in ((0x00000100, 32), (0x00000120, 32), (0, 1), (17, 8),
                     (1, 1), (5, 4), (1, 3), (1, 4), (0, 1), (0, 2), (1, 1),
                     (e.time_inc_res, 16), (1, 1), (0, 1), (1, 1),
                     (e.width, 13), (1, 1), (e.height, 13), (1, 1),
                     (self.interlaced, 1), (1, 1), (sprite, 2), *gmc,
                     (0, 1), (0, 1), (self.quarter, 1), (1, 1), (1, 1),
                     (0, 1), (0, 1), (0, 1), (0, 1)):
            # advanced simple, verid 5, rectangular, interlaced or not,
            # the sprite (GMC: points, accuracy, brightness change), 8
            # bit, H.263 quantizer, quarter-sample or not, no complexity
            # estimation, no resync markers, partitions, newpred, reduced
            # resolution or scalability
            w.put(v, n)
        w.stuff()
        return w.getvalue()

    def _vop_header(self, w, vop_type: int, rounding: int = 0) -> None:
        """A VOP's header up to its trajectories: the time, vop_coded,
        an S-VOP's rounding, dc threshold 0, an interlaced VOL's top
        field first and no alternate scan."""
        e = self.enc
        secs, t = divmod(self.disp, e.time_inc_res)
        w.put(0x000001B6, 32)
        w.put(vop_type, 2)
        for _ in range(secs - self.tb):
            w.put(1, 1)                  # modulo time base
        w.put(0, 1)
        self.tb = secs
        for v, n in ((1, 1), (t, e.time_inc_bits), (1, 1), (1, 1)):
            w.put(v, n)                  # markers, vop_coded
        if vop_type:
            w.put(rounding, 1)
        w.put(0, 3)                      # dc threshold 0
        if self.interlaced:
            w.put(1, 1)
            w.put(0, 1)

    def _intra_mb(self, w, frame, mbx: int, mby: int, dcs,
                  in_pvop: bool) -> None:
        """An intra macroblock of ``_intra_levels``; an interlaced VOL's
        with a random dct_type after cbpy (interlaced_information)."""
        from tcforge_tpu_torch.io.mpeg4syntax import (_CBPY_CODES,
                                                      _MCBPC_I, _MCBPC_P,
                                                      _write_block,
                                                      _write_dc)
        e = self.enc
        lv = self._intra_levels(frame, mbx, mby)
        cbp = sum(1 << (5 - n) for n in range(6)
                  if lv[n].reshape(64)[1:].any())
        entries = e._intra_entries(lv, mbx, mby, dcs)
        if not self.interlaced:
            e._write_intra_mb(w, cbp, entries, in_pvop)
            return
        if in_pvop:
            w.put(0, 1)                  # not_coded = 0
        w.put(*(_MCBPC_P if in_pvop else _MCBPC_I)[(3, cbp & 3)])
        w.put(0, 1)                      # ac_pred_flag
        w.put(*_CBPY_CODES[(cbp >> 2) & 0xF])
        w.put(int(self.rng.integers(0, 2)), 1)
        for n, (dcd, lvn) in enumerate(entries):
            _write_dc(w, dcd, 0 if n < 4 else 1)
            if (cbp >> (5 - n)) & 1:
                _write_block(w, lvn, True, 1)

    def ivop(self, frame) -> bytes:
        import torch
        e = self.enc
        if self.interlaced:
            from tcforge_tpu_torch.io.mpeg4syntax import BitWriter
            w = BitWriter()
            self._vop_header(w, 0)
            w.put(e.qscale, 5)
            dcs = e._dc_grids()
            for i in range(e.mbw * e.mbh):
                self._intra_mb(w, frame, i % e.mbw, i // e.mbw, dcs, False)
            w.stuff()
            self.disp += 1
            return w.getvalue()
        e._frame, e._tb = self.disp, self.tb
        chunk, _ = e.encode(*(torch.from_numpy(np.ascontiguousarray(p))
                              for p in frame))
        self.tb = e._tb
        self.disp += 1
        return chunk

    def _intra_levels(self, frame, mbx: int, mby: int):
        """An intra macroblock of ``frame``'s block means, an AC level on
        some blocks."""
        from tcforge_tpu_torch.io import _mp4tables as T
        q = self.enc.qscale
        lv = np.zeros((6, 8, 8), np.int64)
        for n in range(6):
            if n < 4:
                y0, x0 = 16 * mby + 8 * (n >> 1), 16 * mbx + 8 * (n & 1)
                blk, scale = frame[0][y0:y0 + 8, x0:x0 + 8], T.Y_DC_SCALE[q]
            else:
                blk = frame[n - 3][8 * mby:8 * mby + 8, 8 * mbx:8 * mbx + 8]
                scale = T.C_DC_SCALE[q]
            mean = float(blk.mean()) if blk.size else 128.0
            lv[n, 0, 0] = int(round(8 * mean / scale))
            if self.rng.random() < 0.5:
                lv[n, int(self.rng.integers(0, 3)),
                   int(self.rng.integers(1, 3))] = \
                    int(self.rng.choice([-2, -1, 1, 2]))
        return lv

    def _residual(self):
        """Random coded blocks: cbp and sparse small levels."""
        cbp = int(self.rng.integers(1, 64))
        lv = np.zeros((6, 8, 8), np.int64)
        for n in range(6):
            if (cbp >> (5 - n)) & 1:
                for _ in range(int(self.rng.integers(1, 4))):
                    lv[n, int(self.rng.integers(0, 3)),
                       int(self.rng.integers(0, 3))] = \
                        int(self.rng.choice([-3, -2, -1, 1, 2, 3]))
                if not lv[n].any():
                    lv[n, 0, 0] = 1
        return cbp, lv

    def svop(self, frame, rounding: int) -> bytes:
        from tcforge_tpu_torch.io.mpeg4syntax import (_CBPY_CODES,
                                                      _MCBPC_P, BitWriter,
                                                      _write_block,
                                                      _write_mv)
        e, dec, rng = self.enc, self.dec, self.rng
        w = BitWriter()
        self._vop_header(w, 3, rounding)         # S-VOP
        points = dec.vol.sprite_points
        traj = [tuple(int(v) for v in rng.integers(-r, r + 1, 2))
                for r in (8, 5, 5)[:points]]
        for du, dv in traj:
            _put_traj(w, du)
            _put_traj(w, dv)
        w.put(e.qscale, 5)
        w.put(1, 3)                      # fcode 1
        P = dec._gmc_setup(traj)
        grid = [[(0, 0)] * (2 * e.mbw) for _ in range(2 * e.mbh)]
        dcs = e._dc_grids()
        kinds = rng.choice(4, size=e.mbw * e.mbh, p=GMC_MIX)
        for i, kind in enumerate(kinds.tolist()):
            mbx, mby = i % e.mbw, i // e.mbw
            bx, by = 2 * mbx, 2 * mby
            if kind == 3:
                self._intra_mb(w, frame, mbx, mby, dcs, True)
                continue
            amv = dec._gmc_amv(P, mbx, mby, 1)
            mv = amv
            if kind == 0:
                w.put(1, 1)              # not_coded: a GMC skip
            else:
                cbp, lv = self._residual()
                w.put(0, 1)
                w.put(*_MCBPC_P[(0, cbp & 3)])
                w.put(1 if kind == 1 else 0, 1)      # mcsel
                w.put(*_CBPY_CODES[((cbp >> 2) & 0xF) ^ 0xF])
                if self.interlaced:
                    w.put(int(rng.integers(0, 2)), 1)    # dct_type
                    if kind == 2:
                        w.put(0, 1)      # frame prediction
                if kind == 2:
                    mv = tuple(int(np.clip(a + rng.integers(-6, 7), -32, 31))
                               for a in amv)
                    pred = dec._pred_mv(grid, bx, by, 0)
                    _write_mv(w, e._wrap_mv(mv[0] - pred[0]))
                    _write_mv(w, e._wrap_mv(mv[1] - pred[1]))
                for n in range(6):
                    if (cbp >> (5 - n)) & 1:
                        _write_block(w, lv[n], False, 0)
            for k in range(4):
                grid[by + (k >> 1)][bx + (k & 1)] = mv
        w.stuff()
        self.disp += 1
        return w.getvalue()


def gmc_chunks(width: int, height: int, groups: int, gop: int, seed: int,
               points=GMC_POINTS, accuracy: int = 3, quarter: bool = False,
               interlaced: bool = False) -> list:
    """The chunks of a GMC stream (``GmcWriter``): ``groups`` groups of
    ``gop`` VOPs, group g's VOL with ``points[g % len(points)]`` warping
    points, its I-VOP of ``encoder_clip``'s frame g, its S-VOPs' rounding
    alternating."""
    gw = GmcWriter(width, height, seed, accuracy, quarter=quarter,
                   interlaced=interlaced)
    frames = encoder_clip(width, height, groups, seed, "wave")
    out = []
    for g, frame in enumerate(frames):
        out.append(gw.headers(points[g % len(points)]) + gw.ivop(frame))
        out += [gw.svop(frame, (g + k) & 1) for k in range(gop - 1)]
    return out


def write_gmc_avi(path, width: int = GMC_W, height: int = GMC_H,
                  groups: int = GMC_GROUPS, gop: int = GMC_GOP,
                  seed: int = GMC_SEED, points=GMC_POINTS,
                  accuracy: int = 3, quarter: bool = False,
                  interlaced: bool = False) -> Path:
    """``gmc_chunks`` in an AVI (fourcc DIVX, 25 fps) written by the
    port's ``AviWriter``; the same bytes on every run."""
    from tcforge_tpu_torch.io.avi import AviVideoStream, AviWriter
    w = AviWriter(str(path), AviVideoStream(fourcc="DIVX", width=width,
                                            height=height, fps=25.0))
    for i, c in enumerate(gmc_chunks(width, height, groups, gop, seed,
                                     points, accuracy, quarter,
                                     interlaced)):
        w.write_video_frame(c, i % gop == 0)
    w.close()
    return Path(path)


# the H.263 path, h263: tests/data/h263/h263.avi, a CIF (352x288) short-
# header stream at 25 fps, 48 frames (GOP 12), about 400 kbit/s, under
# fourcc FMP4 (libavcodec's h263, tests/data/h263/make_streams.py); each P
# picture one mpeg4_recon launch (1MV records), each I picture an
# mpeg4_idct_intra, through the divx path's arguments
H263_DATA = ROOT / "tests" / "data" / "h263"
H263_KERNELS = ("mpeg4_recon", "mpeg4_idct_intra", "hqdn3d_spatial_scan",
                "hqdn3d_temporal_scan")
# the two paths: (input, arguments, frames, kernels, width, height); the
# input None is the GMC stream, written at run time (write_gmc_avi)
GMC_PATHS = {"divx_gmc": (None, DIVX_ARGS, GMC_FRAMES, GMC_KERNELS, GMC_W,
                          GMC_H),
             "h263": (H263_DATA / "h263.avi", DIVX_ARGS, 48, H263_KERNELS,
                      352, 288)}
# their goldens: (input, arguments, outputs), the input a file of
# tests/data/h263 or ("gmc", width, height, groups, gop, seed, points,
# accuracy[, quarter, interlaced]), a write_gmc_avi stream written into
# the output directory;
# the SHA-256 of the JAX CLI's outputs (TCFORGE_NATIVE_MPEG4=1, the numpy
# decode; --mesh off), pinned by tests/test_torch_mpeg4_gmc.py and
# tests/test_torch_h263.py, which run the cases through both CLIs
GMC_GOLDEN = {
    "divx_gmc": (("gmc", GMC_W, GMC_H, GMC_GROUPS, GMC_GOP, GMC_SEED,
                  GMC_POINTS, 3), DIVX_ARGS + ["--batch", "16"],
                 ("out.avi",)),
    "gmc_small": (("gmc", 176, 144, 2, 6, 5, (0, 3), 2),
                  ["-y", "raw,raw,avi", "--batch", "5"], ("out.avi",)),
    "gmc_odd_i5": (("gmc", 200, 136, 2, 5, 6, (2, 1), 1),
                   ["-I", "5", "-J", "hqdn3d", "--batch", "4"],
                   ("out.y4m",)),
    "gmc_qpel": (("gmc", 176, 144, 2, 5, 21, (2, 3), 3, True, False),
                 ["-y", "raw,raw,avi", "--batch", "4"], ("out.avi",)),
    "gmc_il": (("gmc", 176, 144, 2, 5, 22, (1, 3), 2, False, True),
               ["-J", "hqdn3d", "--batch", "3"], ("out.y4m",)),
    "h263": ("h263.avi", DIVX_ARGS + ["--batch", "16"], ("out.avi",)),
    "qcif_drop": ("qcif.avi", ["-J", "hqdn3d", "--batch", "5"],
                  ("out.y4m",)),
    "gob_b1": ("gob.avi", ["-y", "raw,raw,avi", "--batch", "1"],
               ("out.avi",)),
}
GMC_GOLDEN_SHA256 = {
    "divx_gmc": (
        "3b251d5834b7c60176ef589e55a1d8e6e50a0c932ecf37ea0777a85b06fe1add",),
    "gmc_small": (
        "5a974ca95f6942743eabfe7430a20fe8f388afd41996a4931c7a6404f0829fcd",),
    "gmc_odd_i5": (
        "8ca2ea4b7d2de747808ac16d84daacc027eb9e820c56cd6d885016bd9aff7b95",),
    "gmc_qpel": (
        "68888bd1299d54bd963a2523579567e3d401a5b52010a13c2317a54824ac1e0a",),
    "gmc_il": (
        "76957ba8b9290a5eb1394c94d6becac14c7b90a9873b54f946196b175526d305",),
    "h263": (
        "376e44bddede6f855d9ab95da2d728a32a9d09d211532d48b1418e38fa2be562",),
    "qcif_drop": (
        "001d563230477bb461c2f2793b40898183e9cbe8db069acf0a6959461acab84c",),
    "gob_b1": (
        "1c21bf521e6f458bcfcf3482df96ec2e30845da1cfe353334648ac376658924c",),
}


def gmc_golden_argv(case: str, directory) -> list:
    """The CLI arguments of a ``GMC_GOLDEN`` case writing into
    ``directory`` (where a GMC stream is written first)."""
    src, args, outs = GMC_GOLDEN[case]
    if isinstance(src, tuple):
        _, w, h, groups, gop, seed, points, acc, *flags = src
        path = Path(directory) / "in.avi"
        if not path.exists():
            write_gmc_avi(path, w, h, groups, gop, seed, points, acc,
                          *flags)
    else:
        path = H263_DATA / src
    return ["-i", str(path), "-o", f"{directory}/{outs[0]}", *args]


def gmc_golden_outputs(case: str, directory) -> list:
    return [Path(directory) / f for f in GMC_GOLDEN[case][2]]


# the Motion-JPEG path, mjpeg: tests/data/mjpeg/legacy.avi, the README's
# legacy AVI (written by the JAX CLI with the README's -y
# movjpeg,lame,avi -F MJPG: 8 frames of dvd.vob zoomed to 640x480, a
# camcorder's VGA movie mode, at 29.97 fps, baseline 4:2:0 JPEG at
# quality 90, with 48 kHz stereo MP3) through -x avi -J hqdn3d=luma=4.0
# to a Y4M and the decoded track as a WAV: the host's Huffman decode,
# jpeg_idct and jpeg_color once each a batch, the RGB24 entry conversion
# and hqdn3d's scans; the MP3 decode in its worker process.  (-y
# raw,raw,avi keeps an RGB source RGB into the AVI, where hqdn3d refuses
# it in both CLIs.)
MJPEG_DATA = ROOT / "tests" / "data" / "mjpeg"
MJPEG_ARGS = ["-x", "avi", "-J", "hqdn3d=luma=4.0"]
MJPEG_W, MJPEG_H, MJPEG_FRAMES = 640, 480, 8
MJPEG_KERNELS = ("jpeg_idct", "jpeg_color", "hqdn3d_spatial_scan",
                 "hqdn3d_temporal_scan")
# every JPEG fixture, decoded on the card in phase 3
MJPEG_FILES = ("legacy.avi", "small.avi", "mixed.avi", "odd.avi",
               "narrow.avi", "dot.avi", "fields.avi", "nodht.avi",
               "mp2.avi", "ac3.avi", "jpeg.mov", "mjpa.mov")
# the JPEG goldens: (fixture, arguments, outputs) as AVI_GOLDEN's, pinned
# against the JAX CLI by tests/test_torch_mjpeg.py, test_torch_avi_audio.py
# and test_torch_mov.py (the JAX CLI's compressed audio through the in-tree
# decoders, its route without the FFmpeg bridge)
MJPEG_GOLDEN = {
    "mjpeg": ("legacy.avi", MJPEG_ARGS + ["--batch", "16", "-m",
                                          "{dir}/out.wav"],
              ("out.y4m", "out.wav")),
    "small_avi": ("small.avi", ["-y", "raw,raw,avi"], ("out.avi",)),
    "small_b4": ("small.avi", ["-J", "hqdn3d", "--batch", "4", "-m",
                               "{dir}/out.wav"], ("out.y4m", "out.wav")),
    "mixed": ("mixed.avi", ["-y", "raw,raw,avi", "--batch", "5"],
              ("out.avi",)),
    "odd": ("odd.avi", ["-y", "raw,raw,avi", "--batch", "1"], ("out.avi",)),
    "narrow": ("narrow.avi", ["-y", "raw,raw,avi"], ("out.avi",)),
    "dot": ("dot.avi", ["-y", "raw,raw,avi"], ("out.avi",)),
    "fields": ("fields.avi", ["-J", "hqdn3d", "--batch", "2"],
               ("out.y4m",)),
    "nodht": ("nodht.avi", ["-y", "raw,raw,avi"], ("out.avi",)),
    "mp2": ("mp2.avi", ["-J", "hqdn3d", "--batch", "4", "-m",
                        "{dir}/out.wav"], ("out.y4m", "out.wav")),
    "ac3_seek": ("ac3.avi", ["-y", "raw,raw,avi", "-L", "2"], ("out.avi",)),
    "mov_jpeg": ("jpeg.mov", ["-m", "{dir}/out.wav"], ("out.y4m",
                                                       "out.wav")),
    "mov_mjpa": ("mjpa.mov", ["-J", "hqdn3d"], ("out.y4m",)),
    "mov_seek": ("jpeg.mov", ["-x", "mov", "-y", "raw,raw,avi", "-L", "2",
                              "--batch", "2"], ("out.avi",)),
}
MJPEG_GOLDEN_SHA256 = {
    "mjpeg": (
        "3c22426184c448584f72020b1e4f219131a706e52902d588731ec3ccb1de7f97",
        "e08277a92aaddbd76470e3fe742ba634ce71b62e9bcc2d05a8dccbb83e3cc363",),
    "small_avi": (
        "d0c3444b1c9ad11749d29af44f1af74dd3fa91c76550eb1430ebaccb2246ea47",),
    "small_b4": (
        "47cc819fdc3beaefc37aaf43e37ba62fa3d01181d2f263db737d8d2fba20623e",
        "11dee29a105ec4bfe9878ae01f0ebfdd6657984e10a34243432ef04b5812fda0",),
    "mixed": (
        "29d71a91288c11f74a0d18cb10871b73fd74b4aed412fcbd4d3c6e4eeb708749",),
    "odd": (
        "444df73f22bdcf87be016549efbca230ae5abf30a14773bfc61c16a8fda5da16",),
    "narrow": (
        "4748417add2a46bb226da264b8df108006ed61493f0ccec0fb95469a6512c7ac",),
    "dot": (
        "2eff4cf77d862e7c0532f08725f677266e2740c9c618f9ddbfa4bad02ba55fcd",),
    "fields": (
        "13c71bd2d1696871e7642b4fca1bab2a31f464990158a399ad89955cfe1c705f",),
    "nodht": (
        "8c9452c3ccfab6c128c67c29d1a08a01ef38f7698baa908fdcb1612d42f26fa1",),
    "mp2": (
        "47cc819fdc3beaefc37aaf43e37ba62fa3d01181d2f263db737d8d2fba20623e",
        "9d09710911e9fc37dffbfb4d7b883e403e48edd301e9808da3bb0d5d930d6578",),
    "ac3_seek": (
        "d11526933c0c6f455872dc2646370e34412e6d1bdb19f154b742316c5ef8ba42",),
    "mov_jpeg": (
        "713ae61c9693a24126244ed642918351caaf1e0f96511724df7e2c139653439f",
        "3b524367db1165e430fb8b1bce08eb78dae82f515d994d4b7aaf7d8c43abd098",),
    "mov_mjpa": (
        "13c71bd2d1696871e7642b4fca1bab2a31f464990158a399ad89955cfe1c705f",),
    "mov_seek": (
        "f02be894f05897725e28f62d8e1076eeb176781dad85a92869e8ed4c05333e20",),
}
# phase 6: legacy.avi's chunks repeated to this many frames
MJPEG_RATE_FRAMES = 48
MJPEG_RUNS = 3
# the fewest int32 operations the two kernels' work needs: jpeg_idct a
# block, 16 one-dimensional passes of 56 (14 products, 32 sums, the
# rounding added once each to tmp0 and tmp1, whose sums all 8 outputs
# take, and 8 shifts), 64 dequantizing products and 4 a sample for the
# range limit; jpeg_color a pixel, 20 for ycc_rgb_convert (four
# products, four sums with the rounding, the -128 offsets folded into
# it, three shifts, three sums and six clamps), and by a component's
# upsampling: h2v1 and h1v2 4 (3a + b, the bias, the shift), h2v2 8,
# the others none
JPEG_IDCT_OPS = 16 * 56 + 64 + 4 * 64
JPEG_YCC_OPS = 20
JPEG_UP_OPS = (0, 4, 4, 8, 0)
# phase 3 off the path: (width, height, colour, sampling) of random
# coefficient records and random samples
JPEG_RANDOM_GEOMS = (
    (640, 480, 0, ((2, 2), (1, 1), (1, 1))),
    (13, 7, 0, ((2, 2), (1, 1), (1, 1))),
    (4, 9, 0, ((2, 1), (1, 1), (1, 1))),
    (33, 17, 0, ((1, 2), (1, 1), (1, 1))),
    (47, 5, 0, ((4, 1), (1, 1), (1, 1))),
    (1, 1, 0, ((2, 2), (1, 1), (1, 1))),
    (40, 24, 2, ((1, 1),)),
    (24, 40, 1, ((1, 1), (1, 1), (1, 1))),
    (48, 32, 0, ((2, 1), (2, 1), (2, 1))),
    (720, 480, 0, ((2, 1), (1, 1), (1, 1))))


def mjpeg_golden_argv(case: str, directory) -> list:
    """The CLI arguments of an ``MJPEG_GOLDEN`` case writing into
    ``directory``."""
    name, args, outs = MJPEG_GOLDEN[case]
    return ["-i", str(MJPEG_DATA / name), "-o", f"{directory}/{outs[0]}",
            *(a.replace("{dir}", str(directory)) for a in args)]


def mjpeg_golden_outputs(case: str, directory) -> list:
    return [Path(directory) / f for f in MJPEG_GOLDEN[case][2]]


# the legacy-AVI export path, mjpegenc: the main path's 1080i at 29.97 fps
# with its 48 kHz stereo WAV (write_author_inputs), -I 5, zoomed to
# 640x480 (legacy.avi's VGA movie-mode size), hqdn3d, then README's
# legacy AVI: the movjpeg encoder at quality 90 (jpeg_ycc_down and
# jpeg_fdct_quant on the card, the Huffman coder on the host) and lame at
# 128 kbit/s (the in-tree MP3 encoder) into an MJPG AVI
MJPEGENC_ARGS = ["-I", "5", "-Z", "640x480", "-J", "hqdn3d=luma=4.0", "-y",
                 "movjpeg,lame,avi", "-F", "MJPG"]
MJPEGENC_W, MJPEGENC_H, MJPEGENC_FRAMES = 640, 480, 48
MJPEGENC_KERNELS = ("jpeg_ycc_down", "jpeg_fdct_quant", "zoom_pass",
                    "hqdn3d_spatial_scan", "hqdn3d_temporal_scan")
MJPEGENC_RUNS = 2
# phase 3 off the path: (width, height, frames) of random RGB24 batches,
# each at JPEGENC_QUALITIES
JPEGENC_SHAPES = ((720, 480, 4), (1, 1, 3), (7, 5, 3), (15, 17, 2),
                  (16, 16, 2), (17, 33, 2), (33, 31, 2), (13, 1, 3),
                  (1, 29, 2), (176, 144, 3))
JPEGENC_QUALITIES = (10, 50, 90, 100)
# the fewest int32 operations a block of jpeg_fdct_quant needs: 16
# one-dimensional passes of 12 products, 32 sums and 8 shifts, with the
# descale's rounding added once to z1 (which o2 and o6 take) and once to
# z5 (o7, o5, o3 and o1 each take one of z3 and z4, which both hold it):
# 54 a row pass; a column pass also descales o0 and o4, with one more
# rounding added to tmp10: 55; the samples' -128 offsets cancel in every
# output but the DC and fold into column 0's rounding constant, so they
# cost none; then 64 quantizations of 5 (the magnitude, the correction,
# the product, the shift and the sign);
# jpeg_ycc_down a chroma sample: 4 pixels of Y (three products, three
# sums, the shift) and Cb and Cr (three products, three sums, the
# shift), the two 2x2 sums, the biases and the shifts
JPEG_FDCT_OPS = 8 * 54 + 8 * 55 + 64 * 5
JPEG_YCC_DOWN_OPS = 4 * 7 + 4 * 14 + 2 * 5
# the export goldens that tests/test_torch_jpeg_encode.py,
# test_torch_audio_encode.py and test_torch_mov_export.py hold against the
# JAX CLI (its audio encoders switched to the in-tree ones, as the port's
# are): the arguments ({wav} the WAV of write_author_inputs at
# MJPEGENC_GOLDEN_W x MJPEGENC_GOLDEN_H) and the output's name
MJPEGENC_GOLDEN_W, MJPEGENC_GOLDEN_H = 176, 144
MJPEGENC_GOLDEN_FRAMES = 20
MJPEGENC_GOLDEN = {
    "mjpegenc": (["-p", "{wav}", "-I", "5", "-Z", "128x96", "-J",
                  "hqdn3d=luma=4.0", "-y", "movjpeg,lame,avi", "-F", "MJPG"],
                 "out.avi"),
    "dvdauthor_ac3": (["-p", "{wav}", "-I", "5", "-Z", "96x64", "-J",
                       "hqdn3d=luma=4.0", "-y", "mpeg2,ac3enc,mpg", "-F",
                       "gop_n=15:gop_m=3:rc=1:bitrate=6000"], "out.mpg"),
    "mp2_mpg": (["-p", "{wav}", "-Z", "96x64", "-y", "mpeg2,mp2enc,mpg",
                 "-F", "gop_n=6:gop_m=3"], "out.mpg"),
    "ac3_avi": (["-p", "{wav}", "-Z", "96x64", "-y", "raw,ac3enc,avi"],
                "out.avi"),
    "toolame_avi": (["-p", "{wav}", "-Z", "96x64", "-y",
                     "raw,toolame=bitrate=128,avi", "-d", "1"], "out.avi"),
    "lame_44k": (["-p", "{wav}", "-Z", "96x64", "-E", "44100", "-b", "96",
                  "-y", "raw,lame,avi"], "out.avi"),
    "mov_q50": (["-p", "{wav}", "-Z", "96x64", "-y",
                 "movjpeg=quality=50,raw,mov"], "out.mov"),
    "mov_raw": (["-p", "{wav}", "-Z", "96x64", "-y", "raw,raw,mov"],
                "out.mov"),
    "mov_rgb": (["-Z", "96x64", "-V", "rgb24", "-y", "raw,raw,mov"],
                "out.mov"),
}
MJPEGENC_GOLDEN_SHA256 = {
    "mjpegenc": ("f760cca858e2f953fe14db1c205e8131"
                  "e806babb1d73cf2286657f81ba9d16ee"),
    "dvdauthor_ac3": ("93ec7db653955a3a706516342c413f2b"
                       "ec9cb0458b99466d97f453628c31af63"),
    "mp2_mpg": ("208695e0f70ae7e03918e4720bb004ca"
                 "d85e7ecf7a584e810d873b231273e83a"),
    "ac3_avi": ("1ed9da0309190557a48758a4c8df12c2"
                 "346b7fe5a26d7d0300d72f56a407a7a0"),
    "toolame_avi": ("73d2ac3fcd0a21223c6cc547b30cf0bf"
                     "86e631b2d6ddec9e314506497bf3cacd"),
    "lame_44k": ("aecc355eee1ff76a3181bf9d3d97b032"
                  "0f1dcf9f6fd94e8471f55f4bafdd92a7"),
    "mov_q50": ("44710e2c389028e2c6a0209370dbd0e9"
                 "dbf5c07e6d73202fb720ef118eb1ef0e"),
    "mov_raw": ("355c4cab72f6b4f83d68c884703f58eb"
                 "2ff670c93060752bc8a26de14c8c40fd"),
    "mov_rgb": ("6a5d3f4efce6ecb65b1114bb9ca157f7"
                 "269d8d8275e3f63b2d5b75398aa997f2"),
}


def mjpegenc_golden_argv(case: str, directory) -> list:
    """The CLI arguments of an ``MJPEGENC_GOLDEN`` case writing into
    ``directory``, its inputs written there first."""
    args, out = MJPEGENC_GOLDEN[case]
    src = Path(directory) / "mjpegenc_golden_in.y4m"
    wav = Path(directory) / "mjpegenc_golden_in.wav"
    if not src.exists():
        write_author_inputs(directory, MJPEGENC_GOLDEN_W, MJPEGENC_GOLDEN_H,
                            MJPEGENC_GOLDEN_FRAMES,
                            name="mjpegenc_golden_in")
    return ["-i", str(src), "-o", f"{directory}/{out}",
            *(a.replace("{wav}", str(wav)) for a in args)]


def mjpegenc_golden_output(case: str, directory) -> Path:
    return Path(directory) / MJPEGENC_GOLDEN[case][1]


# the DVD-to-DivX path, divxenc: tests/data/mpeg2/dvd.vob (NTSC DVD
# video, 720x480 at 29.97 fps, 48 frames) zoomed to 640x480 (the 4:3
# square-pixel size of a DivX rip), hqdn3d, and the MPEG-4 encoder at
# cfg10's settings (benches/run_configs.py:564-660: GOP 12, two B-VOPs,
# 4MV, about 1.5 Mbit/s under TM5 rate control) into an XVID AVI; its
# decisions and block coding on the card, its bits on the host
DIVXENC_ARGS = ["-x", "mpeg", "-Z", "640x480", "-J", "hqdn3d=luma=4.0",
                "-y", "xvid,raw,avi", "-F", "keyint=12:bframes=2:four_mv=1",
                "-w", "1500"]
DIVXENC_W, DIVXENC_H, DIVXENC_FRAMES = 640, 480, 48
# the read-back clips: one GOP of cfg10's, with its I, P and B VOPs
READBACK_FRAMES = 12
DIVXENC_KERNELS = ("mpeg4_enc_me", "mpeg4_enc_bme", "mpeg4_enc_blocks",
                   "mpeg2_recon", "mpeg2_idct_intra", "zoom_pass",
                   "hqdn3d_spatial_scan", "hqdn3d_temporal_scan")
MPEG4ENC_KERNELS = ("mpeg4_enc_me", "mpeg4_enc_bme", "mpeg4_enc_blocks")
# phase 6's timed CLI runs of the divxenc path (cut from four to keep the
# script inside its time limit)
DIVXENC_RUNS = 2
# the MPEG-4 export goldens: (input, arguments, outputs); the input is a
# file of the repo or ("y4m", width, height, frames, seed), a
# write_motion_y4m clip written into the output directory.  The SHA-256
# of the JAX CLI's outputs (TCFORGE_NATIVE_MPEG4ENC=1, and
# TCFORGE_NATIVE_MPEG4=1 for an AVI input; --mesh off), made by
# tests/data/mpeg4/make_xvid_goldens.py; tests/test_torch_xvid.py runs
# the small cases through both CLIs on the CPU
XVID_GOLDEN = {
    "divxenc": ("tests/data/mpeg2/dvd.vob", DIVXENC_ARGS, ("out.avi",)),
    "divx": ("tests/data/mpeg4/divx.avi",
             ["-x", "avi", "-y", "xvid,raw,avi", "-F", "keyint=12:bframes=2"],
             ("out.avi",)),
    "dvd_small": ("tests/data/mpeg2/dvd.vob",
                  ["-x", "mpeg", "-Z", "160x112", "-c", "0-0.10", "-J",
                   "hqdn3d=luma=4.0", "-y", "xvid,raw,avi", "-F",
                   "keyint=12:bframes=2:four_mv=1", "-w", "1500"],
                  ("out.avi",)),
    "divx_small": ("tests/data/mpeg4/divx.avi",
                   ["-x", "avi", "-Z", "160x112", "--max_frames", "9",
                    "-y", "xvid,raw,avi", "-F", "keyint=12:bframes=2"],
                   ("out.avi",)),
    "y4m_b1": (("y4m", 96, 64, 12, 3), ["-y", "xvid,raw,avi", "-F",
                                        "quant=4:bframes=1"], ("out.avi",)),
    "y4m_rc": (("y4m", 96, 64, 12, 4),
               ["-y", "xvid,raw,avi", "-F", "bitrate=300:four_mv=1:keyint=5",
                "--batch", "4"], ("out.avi",)),
    "y4m_default": (("y4m", 96, 64, 9, 5), ["-y", "xvid,raw,avi"],
                    ("out.avi",)),
    "y4m_w": (("y4m", 88, 56, 10, 6), ["-y", "xvid", "-w", "400"],
              ("out.avi",)),
    "m4v": (("y4m", 88, 56, 11, 7), ["-y", "xvid,raw,raw", "-F",
                                     "quant=6:bframes=3:four_mv=1",
                                     "--batch", "5"], ("out.m4v",)),
}
XVID_GOLDEN_SHA256 = {
    "divxenc": (
        "ab1f726f473a5448ab2374d55d53527d535227babf195bd4cd79ecb48d69e0b7",),
    "divx": (
        "52a9ed0fbf34887ccc28270fec72f77a1e38250543514192b2d2f0a2fbc1bdfa",),
    "dvd_small": (
        "1848d8511c515c171589f458fcfb99d04e87c1d7d83a8f20c9fe4788d3c2c1d2",),
    "divx_small": (
        "63e6129ec1af9d4a6062b6c064bb127052cb4b745a111e3bd8b31c77b42402bb",),
    "y4m_b1": (
        "7126efc190635d13c7621b9fab608d336e2b57300db2cb63aef0966fce03d329",),
    "y4m_rc": (
        "85c8a838e953f31c0039026f57d9d5d1ccc18edbec69cb9a5713cf4cdcbea2e8",),
    "y4m_default": (
        "1fef32ca4963213b22370beaaaebd34c86f0e437480c922c995c8c6a388f39bf",),
    "y4m_w": (
        "ae5be1ccdd5cc70eacf33eb468b11438e018eaa84c2da0964811da60f4f3b23d",),
    "m4v": (
        "388b10d7811a797ce7015bf0f5431f2f9a51a2b29b405c3842b1a0094b416018",),
}


def xvid_golden_argv(case: str, directory) -> list:
    """The CLI arguments of an ``XVID_GOLDEN`` case writing into
    ``directory`` (where a Y4M input is written first)."""
    src, args, outs = XVID_GOLDEN[case]
    if isinstance(src, tuple):
        _, w, h, frames, seed = src
        path = Path(directory) / "in.y4m"
        if not path.exists():
            write_motion_y4m(path, w, h, frames, seed=seed)
    else:
        path = ROOT / src
    return ["-i", str(path), "-o", f"{directory}/{outs[0]}", *args]


def xvid_golden_outputs(case: str, directory) -> list:
    return [Path(directory) / f for f in XVID_GOLDEN[case][2]]


def avi_golden_argv(case: str, directory) -> list:
    """The CLI arguments of an ``AVI_GOLDEN`` case writing into
    ``directory``."""
    name, args, outs = AVI_GOLDEN[case]
    return ["-i", str(MPEG4_DATA / name), "-o", f"{directory}/{outs[0]}",
            *(a.replace("{dir}", str(directory)) for a in args)]


def avi_golden_outputs(case: str, directory) -> list:
    return [Path(directory) / f for f in AVI_GOLDEN[case][2]]

# the CLI timings: ten batches of MAIN_BATCH frames, enough for the
# engine's stages to overlap
ENGINE_FRAMES = 10 * 16
# the DVD authoring path (cfg6's and cfg8's encoder settings,
# benches/run_configs.py:277-310 and 311-421: GOP N=15, M=3, TM5 rate
# control toward 6000 kbit/s, search range 8) from 1080i broadcast with
# its 48 kHz stereo WAV to an NTSC DVD's 720x480 program stream with
# LPCM audio
AUTHOR_FPS = (30000, 1001)
AUTHOR_SPF = 1602
AUTHOR_W, AUTHOR_H = 720, 480
AUTHOR_ENC = ["-y", "mpeg2,raw,mpg", "-F",
              "gop_n=15:gop_m=3:rc=1:bitrate=6000"]
AUTHOR_ARGS = ["-I", "5", "-Z", f"{AUTHOR_W}x{AUTHOR_H}", "-J",
               "hqdn3d=luma=4.0", *AUTHOR_ENC]
AUTHOR_FRAMES = 48
AUTHOR_RATE_FRAMES = 160
ENCODE_KERNELS = ("mpeg2_me", "mpeg2_enc_pred", "mpeg2_enc_bmode",
                  "mpeg2_enc_blocks")
AUTHOR_KERNELS = (*ENCODE_KERNELS, "zoom_pass", "hqdn3d_spatial_scan",
                  "hqdn3d_temporal_scan")
# phase 3: frames of the authoring path's content encoded with every
# kernel call checked; the search ranges off the path
ENC_CHECK_FRAMES = 16
ENC_RANGES = (1, 4, 5, 8, 16, 64)
# the small export cases that tests/test_torch_export.py holds against
# the JAX CLI: (input, arguments, output suffix); "motion" is
# write_author_inputs at AUTHOR_GOLDEN_W x AUTHOR_GOLDEN_H, {wav} its WAV
AUTHOR_GOLDEN_W, AUTHOR_GOLDEN_H, AUTHOR_GOLDEN_FRAMES = 128, 96, 20
AUTHOR_GOLDEN = {
    "dvdauthor": ("motion", ["-p", "{wav}", "-I", "5", "-Z", "96x64", "-J",
                             "hqdn3d=luma=4.0", *AUTHOR_ENC], ".mpg"),
    "m2v": ("motion", ["-Z", "96x64", "-y", "mpeg2,raw,raw", "-F",
                       "gop_n=12:gop_m=1:qscale=5"], ".m2v"),
    "intra": ("motion", ["-Z", "96x64", "-y", "mpeg2"], ".m2v"),
    "intra422": ("motion", ["-Z", "96x64", "-V", "yuv422p", "-y", "mpeg2",
                            "-F", "qscale=4"], ".m2v"),
    "identity": ("motion", ["-y", "mpeg2,raw,raw", "-F",
                            "gop_n=6:gop_m=3:range=4", "--batch", "4"],
                 ".m2v"),
    "vob": ("dvd.vob", ["-x", "mpeg", "--max_frames", "7", "-y",
                        "mpeg2,raw,raw", "-F",
                        "gop_n=15:gop_m=3:rc=1:bitrate=6000"], ".m2v"),
    "fields": ("motion", ["-Z", "96x64", "--encode_fields", "b", "-w",
                          "2000", "--quantizers", "3,24", "-y",
                          "mpeg2,raw,raw", "-F", "gop_n=6:gop_m=3"],
               ".m2v"),
    "yuv4mpeg": ("motion", ["-J", "hqdn3d", "-y", "yuv4mpeg,raw,raw"],
                 ".y4m"),
    "raw_yuv": ("motion", ["-p", "{wav}", "-J", "hqdn3d", "-y", "raw,raw",
                           "--frame_interval", "3"], ".yuv"),
}
AUTHOR_GOLDEN_SHA256 = {
    "dvdauthor": ("75e8d7a33884b7648a15d43d2c35d953"
                  "4f5c7f7f5d8dec109adcbf9b8bd5aec6"),
    "m2v": ("425401e8fc66d2d780df97df3eb82950"
            "0f7d453ce5520ae762f06956f36128d5"),
    "intra": ("a46ae566270bc60c317489e3165e3ec9"
              "9d38bc1d5ee6bac0c741f22349b26486"),
    "intra422": ("80b8c33a71dac091ffecd55846645928"
                 "08b0076bb8c7ec65b447ba43fb955122"),
    "identity": ("c1c19c547da767d24dad024cb04c88a8"
                 "b2b6c376f25d99509629f38807a9b1b4"),
    "vob": ("cfc3e73ad310c7654873c6782b061588"
            "e2e660d7bc7a7f8cad9089619ab831ec"),
    "fields": ("31602e9676ddeb8eed8ba2216b849c5d"
               "e81aaa16900da99e805e2694c1085345"),
    "yuv4mpeg": ("1ef64b5758ab1385ea0e090538f80f65"
                 "8a1b35eeee0703954dc3424afa31529b"),
    "raw_yuv": ("2c06301549718a072b34a738b3d78821"
                "6e22aba20837e374dac33e6bffcddc1c"),
}
# the 4:2:2 path (422P@ML, the studio's and broadcast contribution's
# long GOP at 15-50 Mbit/s): 1080i 4:2:2 at 25 fps, -I 5, the zoom to
# 720x576 and denoise3d into a 422P I/B/B/P elementary stream (GOP 12/3,
# TM5 toward 15 Mbit/s); the same on its first frames as field pictures,
# and as the -R 1 / -R 2 pair; then the stream read back by the port's
# MPEG importer kept at 4:2:2 (-V yuv422p, denoise3d) and decimated to
# 4:2:0 (hqdn3d)
MPEG422_W, MPEG422_H = 720, 576
MPEG422_FPS = (25, 1)
MPEG422_FRAMES = 48
MPEG422_SHORT_FRAMES = 16          # the field and two-pass variants
MPEG422_GOP = "gop_n=12:gop_m=3:rc=1:bitrate=15000"
MPEG422_ENC = ["-V", "yuv422p", "-I", "5", "-Z",
               f"{MPEG422_W}x{MPEG422_H}", "-J", "denoise3d", "-y",
               "mpeg2,raw,raw", "-F", MPEG422_GOP]
MPEG422_KEEP = ["-x", "mpeg", "-V", "yuv422p", "-J", "denoise3d"]
MPEG422_DECIMATE = ["-x", "mpeg", "-J", "hqdn3d=luma=4.0"]
MPEG422_KERNELS = {
    "encode": (*ENCODE_KERNELS, "zoom_pass", "d3_spatial_scan",
               "d3_temporal_scan"),
    "keep": ("mpeg2_recon", "mpeg2_idct_intra", "d3_spatial_scan",
             "d3_temporal_scan"),
    "decimate": ("mpeg2_recon", "mpeg2_idct_intra", "hqdn3d_spatial_scan",
                 "hqdn3d_temporal_scan")}
# the kernels line's rows of the 4:2:2 forms, each of the kernel it is a
# form of (the launches: the mpeg422 path's, which runs only 4:2:2 forms)
FORMS_422 = {"mpeg2_recon_422": "mpeg2_recon",
             "mpeg2_idct_intra_422": "mpeg2_idct_intra",
             "mpeg2_enc_pred_422": "mpeg2_enc_pred",
             "mpeg2_enc_blocks_422": "mpeg2_enc_blocks"}
# the small cases that tests/test_torch_mpeg422_cli.py holds against the
# JAX CLI, in order (a decode reads an earlier case's stream, pass 2 the
# log of pass 1): case -> (the case whose .m2v is the input, or None for
# write_motion_y4m's 4:2:2 clip at MPEG422_GOLDEN_W x MPEG422_GOLDEN_H,
# arguments, output suffix); {log} is the pass log
MPEG422_GOLDEN_W, MPEG422_GOLDEN_H, MPEG422_GOLDEN_FRAMES = 128, 96, 12
MPEG422_GOLDEN_GOP = "gop_n=6:gop_m=3:rc=1:bitrate=3000"
_M422_SMALL = ["-V", "yuv422p", "-I", "5", "-Z", "96x64", "-J", "denoise3d"]
MPEG422_GOLDEN = {
    "enc": (None, [*_M422_SMALL, "-y", "mpeg2,raw,raw", "-F",
                   MPEG422_GOLDEN_GOP], ".m2v"),
    "enc_fields": (None, [*_M422_SMALL, "-y", "mpeg2,raw,raw", "-F",
                          MPEG422_GOLDEN_GOP + ":fields=1"], ".m2v"),
    "pass1": (None, [*_M422_SMALL, "-y", "mpeg2,raw,raw", "-F",
                     MPEG422_GOLDEN_GOP, "-R", "1,{log}"], ".m2v"),
    "pass2": (None, [*_M422_SMALL, "-N", "mpeg2video", "-F",
                     MPEG422_GOLDEN_GOP, "-R", "2,{log}"], ".m2v"),
    "keep": ("enc", MPEG422_KEEP, ".y4m"),
    "keep_fields": ("enc_fields", MPEG422_KEEP, ".y4m"),
    "decimate": ("enc", MPEG422_DECIMATE, ".y4m"),
}
MPEG422_GOLDEN_SHA256 = {
    "enc": ("967d182a56dead435bb6e8463f849a22"
            "9f1f7cb17d9fc1a8213d0f8a5ec3a698"),
    "enc_fields": ("0932f3349f22ad40c22902ab47b8d8a4"
                   "015f1cd35bac7f1b2f4364f1a732b98a"),
    "pass1": ("967d182a56dead435bb6e8463f849a22"
              "9f1f7cb17d9fc1a8213d0f8a5ec3a698"),
    "pass2": ("eef6a0ff3526489164db6a5b5e13d20d"
              "e276788b4c5140170dd6b893caa8142a"),
    "keep": ("1c58a525ffbab1682adb8bab5f2d7b80"
             "0cf584176c0c8fe5cdb3fdd8666d75ba"),
    "keep_fields": ("ed898d36db928788460f51bcbb5faae5"
                    "f3e51d04590cef7016cf9163372f7d6a"),
    "decimate": ("cba7305b3065ecc01bbf6357e46493f3"
                 "5b718ede1f379c7ca15c5d87a960a0c3"),
}


def mpeg422_golden_argv(case: str, directory, side: str) -> list:
    """The CLI arguments of an ``MPEG422_GOLDEN`` case run by ``side``
    (one name per CLI): its input (written into ``directory``, or the
    earlier case's output of the same side), its output
    ``mpeg422_<case>_<side><suffix>`` and the side's pass log there."""
    directory = Path(directory)
    src_case, args, suffix = MPEG422_GOLDEN[case]
    if src_case is None:
        src = directory / "mpeg422_golden_in.y4m"
        if not src.exists():
            write_motion_y4m(src, MPEG422_GOLDEN_W, MPEG422_GOLDEN_H,
                             MPEG422_GOLDEN_FRAMES, seed=19,
                             fps=MPEG422_FPS, chroma=422)
    else:
        src = directory / f"mpeg422_{src_case}_{side}.m2v"
    log = directory / f"mpeg422_{side}.log"
    return ["-i", str(src), "-o",
            str(directory / f"mpeg422_{case}_{side}{suffix}"),
            *(a.replace("{log}", str(log)) for a in args)]


# ------------------------------------------------------------------ #
# Transport streams, VideoCD tracks, PSU navigation, compressed audio

# the elementary streams of tests/data/ts (make_streams.py there): MPEG-2
# video at 176x144, 15 frames in five program stream units, and 0.6 s of
# MP2, MP3, AC-3, ADTS AAC and FLAC; the transport streams and the
# VideoCD track are muxed from them at run time (``ts_input``)
TS_DATA = ROOT / "tests" / "data" / "ts"
TS_PACKET = 188
TS_NULL_PID = 0x1FFF
# mux_ts's layout: PES payload bytes of a video and an audio PES, and the
# packets between two repeats of the PAT and PMTs, two PCR-only packets
# and two null packets
TS_VIDEO_PES = 9000
TS_AUDIO_PES = 1500
TS_PSI_EVERY = 64
TS_PCR_ONLY_EVERY = 53
TS_NULL_EVERY = 17
# a stream of a transport stream: its PID, PMT stream type, PES stream id
# and elementary stream file of tests/data/ts ("video.m2v:N" its first N
# bytes)
TS_VIDEO = (0x100, 0x02, 0xE0, "video.m2v")
TS_AUDIO = {"mp2": (0x101, 0x03, 0xC0, "a.mp2"),
            "mp3": (0x101, 0x04, 0xC0, "a.mp3"),
            "ac3": (0x101, 0x81, 0xBD, "a.ac3"),
            "aac": (0x101, 0x0F, 0xC0, "a.aac")}
# the inputs: programs (program number, PMT PID, streams) and the muxer's
# options; two.ts's first program holds the video's first three units and
# AC-3, its second the whole video (PID 0x200) and MP2, whose PID sorts
# first among the audio streams; midpes.ts is mp2.ts without its first
# 37 packets (the file starts inside a PES of each stream)
TS_INPUTS = {
    **{f"{k}.ts": dict(programs=[(1, 0x30, [TS_VIDEO, a])])
       for k, a in TS_AUDIO.items()},
    "none.ts": dict(programs=[(1, 0x30, [TS_VIDEO])]),
    "two.ts": dict(programs=[
        (1, 0x30, [(0x100, 0x02, 0xE0, "video.m2v:8532"),
                   (0x102, 0x81, 0xBD, "a.ac3")]),
        (2, 0x40, [(0x200, 0x02, 0xE0, "video.m2v"), TS_AUDIO["mp2"]])]),
    "midpes.ts": dict(programs=[(1, 0x30, [TS_VIDEO, TS_AUDIO["mp2"]])],
                      skip=37),
}
TS_NAV_PICTURES = 15
# the goldens: (input, arguments) through the port's CLI, writing
# ts_<case>.y4m and ts_<case>.wav (``ts_golden_outputs``); {nav} is a
# tcdemux nav file of TS_NAV_PICTURES pictures, {y4m} a seeded 64x48 Y4M
# of 8 frames, a name of tests/data/ts that file; SHA-256 pinned against
# the JAX CLI (--mesh off; its FFmpeg bridge's decoders replaced by its
# in-tree ones) by tests/test_torch_ts.py, test_torch_mpeg_nav.py and
# test_torch_audio_import.py on the CPU, and checked again on the card
TS_GOLDEN = {
    "ts_mp2": ("mp2.ts", ["-J", "hqdn3d=luma=4.0", "--batch", "5"]),
    "ts_ac3": ("ac3.ts", ["--batch", "16"]),
    "ts_aac": ("aac.ts", ["--batch", "7"]),
    "ts_none": ("none.ts", ["--batch", "4"]),
    "ts_pid": ("two.ts", ["--ts_pid", "200", "--batch", "6"]),
    "ts_auto": ("two.ts", ["--batch", "6"]),
    "ts_whole": ("ac3.ts", ["-x", "mpeg=stream=0", "--batch", "16"]),
    "ts_seek": ("ac3.ts", ["-L", "5", "--batch", "4"]),
    "ts_midpes": ("midpes.ts", ["--batch", "5"]),
    "cdxa": ("vcd.dat", ["-J", "hqdn3d=luma=4.0", "--batch", "5"]),
    "psu": ("mp2.ts", ["--psu_mode", "--batch", "4"]),
    "psu_range": ("video.m2v", ["--psu_mode", "--psu_first", "1",
                                "--psu_last", "3"]),
    "psu_chunks": ("video.m2v", ["--psu_chunks", "2-4", "--batch", "3"]),
    "no_split": ("mp2.ts", ["--psu_mode", "--no_split", "--psu_first", "1",
                            "--batch", "5"]),
    "chunks_no_split": ("video.m2v", ["--psu_chunks", "1-2", "--no_split"]),
    "seek_unit": ("mp2.ts", ["-S", "2,5", "--batch", "5"]),
    "w_nav": ("mp2.ts", ["-W", "1,3,{nav}", "--batch", "5"]),
    "w_pct": ("video.m2v", ["-W", "25,50,{nav}", "--cluster_percentage"]),
    "w_chunks": ("video.m2v", ["-W", "0,4", "--nav_seek", "{nav}",
                               "--cluster_chunks", "1-3"]),
    "p_mp3": ("{y4m}", ["-p", "a.mp3"]),
    "p_mp2": ("{y4m}", ["-p", "a.mp2"]),
    "p_ac3": ("{y4m}", ["-p", "a.ac3"]),
    "p_flac": ("{y4m}", ["-p", "a.flac"]),
    "p_aac": ("{y4m}", ["-p", "a.aac"]),
    "audio_only": ("a.ac3", []),
}
TS_GOLDEN_SHA256 = {
    "ts_mp2": (
        "431194510a82320093c19dcac6f6db98fbd2fec366b9d5b1b0e5514f5a364bd5",
        "6cdaa42a0c087ceb35cb6239ad98dc3ca6dd12b976c7ffaa1737f1d379753096"),
    "ts_ac3": (
        "baa6f11a98df7419c97f6b322bc5e33858119470160a552e72108d308c1138a9",
        "7fa56ef6a3a143f1605e25eb1ca7dae2fcfb040bd120c19b9a6e77cc96c79e3b"),
    "ts_aac": (
        "baa6f11a98df7419c97f6b322bc5e33858119470160a552e72108d308c1138a9",
        "46a468ecf28481ea3078fc2a23e8c476bdf6c00b9d6f1e6f9252b27fca02552c"),
    "ts_none": (
        "baa6f11a98df7419c97f6b322bc5e33858119470160a552e72108d308c1138a9",
        "4872b61c768dff943f9e021453d816f06e35adc8edd88ef183301f03e31b94a5"),
    "ts_pid": (
        "baa6f11a98df7419c97f6b322bc5e33858119470160a552e72108d308c1138a9",
        "6cdaa42a0c087ceb35cb6239ad98dc3ca6dd12b976c7ffaa1737f1d379753096"),
    "ts_auto": (
        "e1393bf64790046f1759004b01cb0572989a3f932fd333c4cbd9d3cb14e75301",
        "0ecb68e4dbab8a60d4c95a7c25a9bbf77734dff4e08369eba03be99808dc73d2"),
    "ts_whole": (
        "baa6f11a98df7419c97f6b322bc5e33858119470160a552e72108d308c1138a9",
        "7fa56ef6a3a143f1605e25eb1ca7dae2fcfb040bd120c19b9a6e77cc96c79e3b"),
    "ts_seek": (
        "f27ebae0675bfbd0149b25bb7651e1fd827e6a1ce04d1a466388fd7bb6fd6838",
        "453db107ce4bd3df496ed01c0d88fc3d01baa1315fb66b655f961ddbd7bbf7c2"),
    "ts_midpes": (
        "7d72b972539d74a6677d60f1cf7c9fcbae312483b92876e08f45a60dc9da5893",
        "693f2f7eef2bc3a6411d4aab1cf87ecd13ec66036a20f32672d45ca1a6892244"),
    "cdxa": (
        "431194510a82320093c19dcac6f6db98fbd2fec366b9d5b1b0e5514f5a364bd5",
        "6cdaa42a0c087ceb35cb6239ad98dc3ca6dd12b976c7ffaa1737f1d379753096"),
    "psu": (
        "7cc738061e13b7e34ccbec897ee3fb600719132bec9464d93908422f07b26244",
        "1419042b40a2c7c54edd18aabb60fcf0e1d8e846f23f4e3c5773fa7e6f79b916",
        "c4d55712d6e43116a63fdde5d2cf096319243e014cf1bbecf9053c4678b9366a",
        "1f8c9e1faee698cc14004415946ffff9cf3ce5ff2815c671b12677baee3da82d",
        "39100286863a3a05840bb076126f22958fe0c0ff027e090e2fbec0e49f5250c5",
        "778e182b0defa34210560a834c99a2c0758976bcf1825f6e608bbcd90f96a935"),
    "psu_range": (
        "1419042b40a2c7c54edd18aabb60fcf0e1d8e846f23f4e3c5773fa7e6f79b916",
        "c4d55712d6e43116a63fdde5d2cf096319243e014cf1bbecf9053c4678b9366a",
        "4872b61c768dff943f9e021453d816f06e35adc8edd88ef183301f03e31b94a5"),
    "psu_chunks": (
        "c4d55712d6e43116a63fdde5d2cf096319243e014cf1bbecf9053c4678b9366a",
        "1f8c9e1faee698cc14004415946ffff9cf3ce5ff2815c671b12677baee3da82d",
        "4872b61c768dff943f9e021453d816f06e35adc8edd88ef183301f03e31b94a5"),
    "no_split": (
        "85ac2e285a761a190183be61b96cc1449c23015227786a89820937f9d1aaf3a0",
        "2dc7e2e32f0bafbe425ea57199f7b7aa1d726059533ad29bbf6c8783937a03c2"),
    "chunks_no_split": (
        "baa6f11a98df7419c97f6b322bc5e33858119470160a552e72108d308c1138a9",
        "4872b61c768dff943f9e021453d816f06e35adc8edd88ef183301f03e31b94a5"),
    "seek_unit": (
        "c3217dc67a96b806946518da5e568ed023d72d1019ee78989b6225a84d3f2147",
        "ea59bbfe930b6687b0ccd03e0c16bbf1fad7bab48dceb0b72432c08329b09e1b"),
    "w_nav": (
        "810c597af8e9624d0b56c7cb863afae2bc1ef7c8e57e4f961878cc22601924dd",
        "1c707cdaaacd8f18447c0636f0acea0b16093acb67968387ce1ecc766d2cbec0"),
    "w_pct": (
        "bc8a6acd44762811bfaff72d475aba8a6ec59b132585d2f5ef704ec1b25ece03",
        "4872b61c768dff943f9e021453d816f06e35adc8edd88ef183301f03e31b94a5"),
    "w_chunks": (
        "bc8a6acd44762811bfaff72d475aba8a6ec59b132585d2f5ef704ec1b25ece03",
        "4872b61c768dff943f9e021453d816f06e35adc8edd88ef183301f03e31b94a5"),
    "p_mp3": (
        "5a823df14198bb66880611293700a43a08c78ec58b76dfbb721c4ebc9c49e051",
        "83afd9f78886614c1207838d960b7304a65ed4cdcf3946cf42a36862e5e6af24"),
    "p_mp2": (
        "5a823df14198bb66880611293700a43a08c78ec58b76dfbb721c4ebc9c49e051",
        "37953c2edc7414976eb0703acecbbf58d4b28841bd310f3d8c6574baf9a28dff"),
    "p_ac3": (
        "5a823df14198bb66880611293700a43a08c78ec58b76dfbb721c4ebc9c49e051",
        "664d8b3a6453e4355837388b3f2782e8a83387f8c9be25d537fbfa988e49adc2"),
    "p_flac": (
        "5a823df14198bb66880611293700a43a08c78ec58b76dfbb721c4ebc9c49e051",
        "79c833e7bb542be7b39a1703a37c727e8f624e3732593b36c0cb91bd0b5897d2"),
    "p_aac": (
        "5a823df14198bb66880611293700a43a08c78ec58b76dfbb721c4ebc9c49e051",
        "f0e23c161efffe3df9c622b7567c26b8e2b32ab78b565d39b737fee4ecdfb36f"),
    "audio_only": (
        "22158316a806880b89b386fc23d151a740df1fba6d28d3728a970b10407aac44",),
}


def _crc32_mpeg(data: bytes) -> int:
    """CRC-32/MPEG-2 of a PSI section."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000
                   else crc << 1) & 0xFFFFFFFF
    return crc


def _psi_section(table_id: int, ext: int, body: bytes) -> bytes:
    s = (bytes([table_id]) + (0xB000 | (len(body) + 9)).to_bytes(2, "big")
         + ext.to_bytes(2, "big") + bytes([0xC1, 0, 0]) + body)
    return s + _crc32_mpeg(s).to_bytes(4, "big")


def _pcr_bytes(ticks: int) -> bytes:
    """A PCR of ``ticks`` 27 MHz ticks: its 33-bit base and 9-bit
    extension."""
    base, ext = (ticks // 300) & ((1 << 33) - 1), ticks % 300
    return bytes([base >> 25 & 0xFF, base >> 17 & 0xFF, base >> 9 & 0xFF,
                  base >> 1 & 0xFF, (base & 1) << 7 | 0x7E | ext >> 8,
                  ext & 0xFF])


def ts_packet(pid: int, cc: int, payload: bytes = b"", pusi: bool = False,
              pcr: Optional[int] = None) -> bytes:
    """One 188-byte transport packet: an adaptation field where it has a
    PCR or its payload is short (stuffed with 0xFF), none without a
    payload (a PCR-only packet)."""
    room = TS_PACKET - 4 - len(payload)
    af = b""
    if pcr is not None or room:
        body = bytes([0x10]) + _pcr_bytes(pcr) if pcr is not None else b""
        if room == 1 and not body:
            af = b"\x00"
        else:
            if not body:
                body = b"\x00"
            af = bytes([room - 1]) + body + b"\xff" * (room - 1 - len(body))
    afc = (2 if af else 0) | (1 if payload else 0)
    head = bytes([0x47, (0x40 if pusi else 0) | pid >> 8, pid & 0xFF,
                  afc << 4 | (cc & 15)])
    out = head + af + payload
    assert len(out) == TS_PACKET, (pid, len(af), len(payload))
    return out


def _pes(sid: int, payload: bytes, pts: int) -> bytes:
    """A PES packet with a PTS; length 0 (unbounded) for video."""
    head = bytes([0x80, 0x80, 5, 0x21 | (pts >> 29 & 0x0E),
                  pts >> 22 & 0xFF, 0x01 | (pts >> 14 & 0xFE),
                  pts >> 7 & 0xFF, 0x01 | (pts << 1 & 0xFE)])
    size = 0 if 0xE0 <= sid <= 0xEF else len(head) + len(payload)
    return b"\x00\x00\x01" + bytes([sid]) + size.to_bytes(2, "big") + \
        head + payload


def mux_ts(programs, skip: int = 0) -> bytes:
    """A broadcast-like transport stream: ``programs`` is a list of
    (program number, PMT PID, [(PID, stream type, PES stream id,
    elementary stream bytes)]); the first stream of each program is its
    PCR PID.  Each elementary stream goes into PES packets of
    ``TS_VIDEO_PES`` or ``TS_AUDIO_PES`` bytes, split into transport
    packets whose streams interleave in proportion to their length; the
    PAT and every PMT open the stream and repeat every ``TS_PSI_EVERY``
    packets, the first packet of each PES of a PCR PID carries a PCR in
    its adaptation field, a PCR-only packet (adaptation field, no
    payload) follows every ``TS_PCR_ONLY_EVERY`` packets and a null
    packet (PID 0x1FFF) every ``TS_NULL_EVERY``; every PID counts its
    packets with payload in its continuity counter.  The first ``skip``
    packets are dropped (a capture that starts inside a PES)."""
    cc: dict = {}

    def packet(pid, payload=b"", pusi=False, pcr=None):
        c = cc.get(pid, 0)
        if payload:
            cc[pid] = (c + 1) & 15
        return ts_packet(pid, c, payload, pusi, pcr)

    pat = _psi_section(0x00, 1, b"".join(
        n.to_bytes(2, "big") + (0xE000 | pmt).to_bytes(2, "big")
        for n, pmt, _ in programs))
    pmts = [(pmt, _psi_section(0x02, n, (0xE000 | streams[0][0]).to_bytes(
        2, "big") + b"\xf0\x00" + b"".join(
            bytes([st]) + (0xE000 | pid).to_bytes(2, "big") + b"\xf0\x00"
            for pid, st, _, _ in streams)))
        for n, pmt, streams in programs]

    def psi():
        out = [packet(0, (b"\x00" + pat).ljust(184, b"\xff"), True)]
        for pmt, sec in pmts:
            out.append(packet(pmt, (b"\x00" + sec).ljust(184, b"\xff"),
                              True))
        return out

    pcr_pids = {streams[0][0] for _, _, streams in programs}
    lanes = []
    for _, _, streams in programs:
        for pid, _st, sid, es in streams:
            step = TS_VIDEO_PES if 0xE0 <= sid <= 0xEF else TS_AUDIO_PES
            units = []
            for k, off in enumerate(range(0, len(es), step)):
                pes = _pes(sid, es[off:off + step], 90000 + 3600 * k)
                pos, first = 0, True
                while pos < len(pes):
                    pcr = (None if not (first and pid in pcr_pids)
                           else 27000000 + 300 * 3600 * k)
                    take = 184 - (8 if pcr is not None else 0)
                    units.append((pes[pos:pos + take], first, pcr))
                    pos += take
                    first = False
            lanes.append([pid, units, 0, len(es)])
    out = psi()
    while any(lane[2] < len(lane[1]) for lane in lanes):
        lane = min((ln for ln in lanes if ln[2] < len(ln[1])),
                   key=lambda ln: ln[2] / len(ln[1]))
        payload, first, pcr = lane[1][lane[2]]
        lane[2] += 1
        out.append(packet(lane[0], payload, first, pcr))
        n = len(out)
        if n % TS_PSI_EVERY == 0:
            out.extend(psi())
        if n % TS_PCR_ONLY_EVERY == 0:
            out.append(packet(min(pcr_pids), pcr=27000000 + 1000 * n))
        if n % TS_NULL_EVERY == 0:
            out.append(ts_packet(TS_NULL_PID, 0, b"\xff" * 184))
    return b"".join(out[skip:])


def _ts_es(spec: str) -> bytes:
    name, _, cut = spec.partition(":")
    data = (TS_DATA / name).read_bytes()
    return data[:int(cut)] if cut else data


def write_vcd(path, video: bytes, audio: bytes) -> None:
    """A VideoCD track (RIFF/CDXA, form-2 sectors) of a program stream
    whose packs carry the video (PES 0xE0) and MPEG audio (PES 0xC0) in
    proportion to their length."""
    from tcforge_tpu_torch.io.cdxa import wrap_ps
    from tcforge_tpu_torch.io.psmux import pack_header, pes_packet
    ps = bytearray()
    parts = [(0xE0, video, 2000), (0xC0, audio, 1000)]
    pos = [0, 0]
    scr = 0
    while pos[0] < len(video) or pos[1] < len(audio):
        k = min((i for i in (0, 1) if pos[i] < len(parts[i][1])),
                key=lambda i: pos[i] / len(parts[i][1]))
        sid, data, step = parts[k]
        ps += pack_header(scr) + pes_packet(sid, data[pos[k]:pos[k] + step])
        pos[k] += step
        scr += 1800
    ps += b"\x00\x00\x01\xb9"
    Path(path).write_bytes(wrap_ps(bytes(ps)))


def ts_input(name: str, directory) -> Path:
    """An input of the TS goldens, written into ``directory`` once: a
    transport stream of ``TS_INPUTS``, ``vcd.dat`` (``write_vcd`` of
    video.m2v and a.mp2), or a file of tests/data/ts."""
    if name not in TS_INPUTS and name != "vcd.dat":
        return TS_DATA / name
    out = Path(directory) / name
    if out.exists():
        return out
    if name == "vcd.dat":
        write_vcd(out, _ts_es("video.m2v"), _ts_es("a.mp2"))
        return out
    spec = TS_INPUTS[name]
    programs = [(n, pmt, [(pid, st, sid, _ts_es(f))
                          for pid, st, sid, f in streams])
                for n, pmt, streams in spec["programs"]]
    out.write_bytes(mux_ts(programs, skip=spec.get("skip", 0)))
    return out


def ts_golden_argv(case: str, directory) -> list:
    """The CLI arguments of a ``TS_GOLDEN`` case, its inputs written into
    ``directory`` and its outputs ``ts_<case>`` there (``%d`` in PSU
    mode)."""
    directory = Path(directory)
    src, args = TS_GOLDEN[case]
    names = {"nav": str(directory / "ts_nav.json"),
             "y4m": str(directory / "ts_in.y4m")}
    if not Path(names["nav"]).exists():
        Path(names["nav"]).write_text(json.dumps(
            {"total_pictures": TS_NAV_PICTURES}))
    if not Path(names["y4m"]).exists():
        write_test_y4m(names["y4m"], 64, 48, 8, seed=23)
    src = names["y4m"] if src == "{y4m}" else str(ts_input(src, directory))
    out = directory / f"ts_{case}"
    psu = ("--psu_mode" in args or "--psu_chunks" in args) \
        and "--no_split" not in args
    argv = ["-i", src, "-o", f"{out}%d.y4m" if psu else f"{out}.y4m",
            "-m", f"{out}.wav"]
    if case == "audio_only":
        argv = ["-i", src, "-o", f"{out}.wav"]
    for a in args:
        a = a.format(**names)
        argv.append(str(TS_DATA / a) if (TS_DATA / a).is_file() else a)
    return argv


def ts_golden_outputs(case: str, directory) -> list:
    """The files a ``TS_GOLDEN`` case writes, in order: each PSU's .y4m,
    or the .y4m, then the .wav."""
    directory = Path(directory)
    out = directory / f"ts_{case}"
    units = sorted(directory.glob(f"ts_{case}[0-9]*.y4m"),
                   key=lambda p: int(p.stem[len(out.name):]))
    videos = units or ([Path(f"{out}.y4m")] if case != "audio_only" else [])
    return [*videos, Path(f"{out}.wav")]


# The audio half of the export: a source's own track without -m, -m and
# audio-only sessions through the encoders and multiplexors, Ogg/OGM
# with Vorbis both ways, faac, flac, au, vag and null.  The goldens:
# (input, arguments, outputs, exit code) through the port's CLI in a
# directory of their own, in order ("{ogm}" reads the OGM that
# vob_vorbis_ogg wrote); the first output is -o, "{d}" the case's
# directory; an input is a file of tests/data/dvd or tests/data/ts, a
# stream of ``ts_input``, or one written by ``route_input``: {y4m} a
# seeded 64x48 Y4M of 8 frames, {au} and {ulaw} seeded AU files,
# {vag} a seeded VAGp file, {late} a program stream whose MP2 track
# starts after its video (``write_late_track_ps``: the windowed reader
# of 4 KB windows meets it after its discovery budget, and both
# engines drop it).  SHA-256 pinned against the JAX CLI (--mesh off; its
# FFmpeg bridge's decoders replaced by its in-tree ones and its encoders
# forced to theirs) by tests/test_torch_audio_routes.py and
# tests/test_torch_ogg.py on the CPU, and checked again on the card
ROUTE_GOLDEN = {
    # the source's own track into a multiplexor that takes audio
    "lpcm_avi": ("lpcm.vob", ["-y", "raw,raw,avi"], ["o.avi"], 0),
    "mp2_mpg": ("mp2.vob", ["-y", "mpeg2,mp2enc,mpg"], ["o.mpg"], 0),
    "ac3_lame_avi": ("ac3.vob", ["-y", "raw,lame,avi"], ["o.avi"], 0),
    "mp2_seek_mpg": ("mp2.vob", ["-L", "2", "-y", "mpeg2,mp2enc,mpg"],
                     ["o.mpg"], 0),
    "title_ac3enc": ("VIDEO_TS", ["-x", "dvd", "-T", "1", "-r", "4", "-y",
                                  "mpeg2,ac3enc,mpg"], ["o.mpg"], 0),
    "ts_mpg": ("mp2.ts", ["-y", "mpeg2,mp2enc,mpg"], ["o.mpg"], 0),
    "ts_whole_mpg": ("mp2.ts", ["-x", "mpeg=stream=0", "-y",
                                "mpeg2,mp2enc,mpg"], ["o.mpg"], 0),
    "ts_psu_mpg": ("mp2.ts", ["--psu_mode", "-y", "mpeg2,mp2enc,mpg"],
                   ["o%d.mpg", "o0.mpg", "o1.mpg", "o2.mpg"], 0),
    "ts_ac3_avi": ("ac3.ts", ["-y", "raw,raw,avi"], ["o.avi"], 0),
    "ts_midpes_avi": ("midpes.ts", ["-y", "movjpeg,lame,avi"], ["o.avi"],
                      0),
    "ts_multi_raw": ("mp2.ts", ["-x", "multi", "-y", "mpeg2,raw,raw"],
                     ["o.m2v", "o.m2v.aud"], 0),
    "ts_422_raw": ("mp2.ts", ["-V", "yuv422p", "-y", "mpeg2,raw,raw"],
                   ["o.m2v", "o.m2v.aud"], 0),
    "vcd_xvid_avi": ("vcd.dat", ["-y", "xvid,lame,avi"], ["o.avi"], 0),
    "vcd_mpg": ("vcd.dat", ["-y", "mpeg2,mp2enc,mpg"], ["o.mpg"], 0),
    "late_track": ("{late}", ["-x", "mpeg=window=4", "-y",
                              "mpeg2,mp2enc,mpg"], ["o.mpg"], 0),
    # audio-only sessions through -y's encoder and multiplexor
    "aac_lame_avi": ("a.aac", ["-y", "null,lame,avi"], ["o.avi"], 0),
    "flac_vorbis_ogg": ("a.flac", ["-y", "null,vorbis,ogg"], ["o.ogg"], 0),
    "mp3_faac_raw": ("a.mp3", ["-y", "null,faac,raw"], ["o.raw"], 0),
    "ac3_flac_raw": ("a.ac3", ["-y", "null,flac,raw"], ["o.raw"], 0),
    "au_wav": ("{au}", [], ["o.wav"], 0),
    "ulaw_vorbis_ogg": ("{ulaw}", ["-y", "raw,vorbis,ogg=fourcc=XVID"],
                        ["o.ogg"], 0),
    "vag_mp2": ("{vag}", ["-y", "null,mp2enc,raw"], ["o.mp2"], 0),
    "au_m_ogg": ("{au}", ["-m", "{d}/m.ogg"], ["o.wav", "m.ogg"], 0),
    "au_y4m_m": ("{au}", ["-m", "{d}/a.wav"], ["o.y4m", "a.wav"], 0),
    "null_e": ("a.ac3", ["-x", "null", "-e", "22050,16,1"], ["o.wav"], 1),
    # Ogg/OGM both ways, -m through the multiplexors, -p from containers
    "vob_vorbis_ogg": ("ac3.vob", ["-y", "raw,vorbis,ogg"], ["o.ogg"], 0),
    "ogm_in": ("{ogm}", ["-m", "{d}/o.wav"], ["o.y4m", "o.wav"], 0),
    "ogm_p": ("{y4m}", ["-p", "{ogm}", "-m", "{d}/o.wav"],
              ["o.y4m", "o.wav"], 0),
    "pcm_ogm": ("{y4m}", ["-p", "{au}"], ["o.ogm"], 0),
    "m_ogg": ("vcd.dat", ["-y", "xvid,lame,avi", "-m", "{d}/x.ogg"],
              ["o.avi", "x.ogg"], 0),
    "m_mp3": ("{y4m}", ["-p", "{au}", "-y", "xvid,lame,avi", "-m",
                        "{d}/a.mp3"], ["o.avi", "a.mp3"], 1),
    "p_vob": ("{y4m}", ["-p", "ac3.vob", "-m", "{d}/o.wav"],
              ["o.y4m", "o.wav"], 0),
    "p_ts": ("{y4m}", ["-p", "ac3.ts", "-m", "{d}/o.wav"],
             ["o.y4m", "o.wav"], 0),
    "p_avi": ("{y4m}", ["-p", "legacy.avi", "-m", "{d}/o.wav"],
              ["o.y4m", "o.wav"], 0),
    "p_au": ("{y4m}", ["-p", "{au}", "-y", "raw,flac,raw"],
             ["o.raw", "o.raw.aud"], 0),
}
ROUTE_GOLDEN_SHA256 = {
    "lpcm_avi": (
        "2f9c429d6a519b16a155a1152cd9eddb6d00b53e2aa0c3bbf6f756198798308a",),
    "mp2_mpg": (
        "8c5f554ef8c0e6e5b7fb343a7ba4202793ebab25dabdf901dbe9945e8f453a66",),
    "ac3_lame_avi": (
        "8793d06f82728cecd17cc148c2fa4002a1372426dfd842680fc7fa639198fdce",),
    "mp2_seek_mpg": (
        "a97ead0f7df958ddf0044f0810c60b7c23ab1c0a4b26a68385910284b015d78a",),
    "title_ac3enc": (
        "e6b663220adbb3211f176a63187cb62dead248f710209f2f3b563f12979ee323",),
    "ts_mpg": (
        "a66cc5c87af8cd46c19cde227ae94a3d75d44c68b1786f73e7c892b138c4aa45",),
    "ts_whole_mpg": (
        "a66cc5c87af8cd46c19cde227ae94a3d75d44c68b1786f73e7c892b138c4aa45",),
    "ts_psu_mpg": (
        "9ceb44aba181d467c24a06a463eb7b146a624fa2e18ef9728611d666244000ab",
        "9426d343639f3633362c321a9298ea29fabc35ac3e72a617511296c3015df333",
        "69354a73bca7b186ba9be60b49754c509038377ab1233c76fe47aac40629e47f"),
    "ts_ac3_avi": (
        "a6dd52b59a0a66e6f368f4e0e7c89e687a82fd051f7f54f8e9c6aafe2f7916ab",),
    "ts_midpes_avi": (
        "39ceb664132f678536f75329cd3c0a1c4405f47aa6105940c5fa4a4312c04913",),
    "ts_multi_raw": (
        "51ba9c22ce3b6090a70ca809dd79e65c7bde9fc4f82c828e43f9355a9d006510",
        "69578f0e155d540b4a30f76e5db4ba070a6dd11d2d462d120a9576b0939b651d"),
    "ts_422_raw": (
        "6d80f371c03ea471417f5f5f1c95a7cc5689ca3e3cd44728e8c5f3c7b9b0b559",
        "69578f0e155d540b4a30f76e5db4ba070a6dd11d2d462d120a9576b0939b651d"),
    "vcd_xvid_avi": (
        "10286c165e3aea823eb6b4ffa573c818cc613ab9646e0d363eee03df2065e340",),
    "vcd_mpg": (
        "a66cc5c87af8cd46c19cde227ae94a3d75d44c68b1786f73e7c892b138c4aa45",),
    "late_track": (
        "013527b373f34b51dd48c5acb872649a30f09ddf40b75e3001397ecb30e95884",),
    "aac_lame_avi": (
        "7eca1c7c2d1c6ac76f7204cc6a3072fc9585c79b9fd5e9b6867b0ef210baa469",),
    "flac_vorbis_ogg": (
        "bf8ca8190a6c361e0e6619aa1ee2cf31f2579f398c690dbf73d88d0d14b1e192",),
    "mp3_faac_raw": (
        "470ef42c5a9112fe6c86f5d459a8e540e1c8e53836f04d52e9ff1eb74a1e0ee2",),
    "ac3_flac_raw": (
        "258318e114f57fe4bab9ad6fdbfdcea66857232cbb1a0fbf5b73a4eaebdbbd8a",),
    "au_wav": (
        "a0dc5b44b4ebb9864af65ce7c84f2d443776815672898c13518d0169feade9de",),
    "ulaw_vorbis_ogg": (
        "0a9658c51a6c1df2d3850b098a5e82676b8c250e89fa48a6a7e4d0c79f861b64",),
    "vag_mp2": (
        "3b63359018568225df9ef63155ffbf85c80c300f579816dcec348928064e5f5a",),
    "au_m_ogg": (
        "991cd2a53281fab26a26b23f2b3d7a020e277b83978ea36796679e0952ae7575",
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    "au_y4m_m": (
        "54902bfbda0cce8b0aae27ad9c4ce499a59de970213aac463709a30f396baf28",
        "a0dc5b44b4ebb9864af65ce7c84f2d443776815672898c13518d0169feade9de"),
    "null_e": (
        "24d5db4ca2d256752cd049a330cb406196c05f4cfe8036beb309e0e4533d21de",),
    "vob_vorbis_ogg": (
        "537655d6317ef16bacd42ad99ce4b00047bdbb79c83e415f2992d0646a9346aa",),
    "ogm_in": (
        "00aea5eee3a3cec4c6e9438904a77d2c5c973a96fcadf37cd864d01bdfcc8481",
        "7c7b0bacdefc350abc932a9819a14dd6bdd4953da873b08e1d0af6e3bbb95aaa"),
    "ogm_p": (
        "5a823df14198bb66880611293700a43a08c78ec58b76dfbb721c4ebc9c49e051",
        "56e9e8aaaa436caf648738181ade45ef6e5cc6fb8bd693dc9434c2f3e45b4b90"),
    "pcm_ogm": (
        "afa8501e1448ca2df9439e1a70e1767096c2aab5ad67ed829ff87c05ba7faaa5",),
    "m_ogg": (
        "6eaa97b3dab6439c05fdddf7a0736c2ce33c5e5ffc21c9f16f24de794e5a9644",
        "9674731da4c8850c2af38b392e61491bce3da7236cd00c910b2cd5c5123e7aad"),
    "m_mp3": (
        "67502515b8080fa75b25b97091388d12f8fa7e2ae857b4361b882c8c8cf588f7",
        "991cd2a53281fab26a26b23f2b3d7a020e277b83978ea36796679e0952ae7575"),
    "p_vob": (
        "5a823df14198bb66880611293700a43a08c78ec58b76dfbb721c4ebc9c49e051",
        "9eeaecab2352b940884bd4bec37fc4dcdf2017f9d3547123553046f0c142bc0c"),
    "p_ts": (
        "5a823df14198bb66880611293700a43a08c78ec58b76dfbb721c4ebc9c49e051",
        "664d8b3a6453e4355837388b3f2782e8a83387f8c9be25d537fbfa988e49adc2"),
    "p_avi": (
        "5a823df14198bb66880611293700a43a08c78ec58b76dfbb721c4ebc9c49e051",
        "cd73ab7653fae8032c818bf6fce247eab01f60571d7066da61113c7889f541c3"),
    "p_au": (
        "402281047240064a785f837ed8277b0fa9b4cfda02c3023786f0e2e173e1d9a6",
        "f10eb2d705b2273f991ae1553c224f3019e5f9caf745c0bd4651d2af0fd72ad9"),
}


def write_au(path, pcm, rate: int, ulaw: bool = False) -> None:
    """A Sun .au file of int16 ``pcm`` (samples, channels): 16-bit
    big-endian linear (encoding 3), or G.711 μ-law (encoding 1)."""
    pcm = np.asarray(pcm, np.int16).reshape(len(pcm), -1)
    if ulaw:
        x = pcm.astype(np.int32)
        sign = np.where(x < 0, 0x80, 0)
        mag = np.minimum(np.abs(x), 32635) + 0x84
        exp = np.floor(np.log2(mag)).astype(np.int32) - 7
        mant = (mag >> (exp + 3)) & 0x0F
        body = (~(sign | exp << 4 | mant) & 0xFF).astype(np.uint8).tobytes()
        enc = 1
    else:
        body = pcm.astype(">i2").tobytes()
        enc = 3
    Path(path).write_bytes(b".snd" + struct.pack(
        ">IIIII", 24, len(body), enc, rate, pcm.shape[1]) + body)


def write_vag(path, seed: int, blocks: int, rate: int = 22050) -> None:
    """A mono VAGp file of ``blocks`` seeded SPU ADPCM blocks (28 samples
    each; predictors 0-4, shifts 0-12)."""
    rng = np.random.default_rng(seed)
    body = bytearray()
    for _ in range(blocks):
        body += bytes([int(rng.integers(0, 5)) << 4
                       | int(rng.integers(0, 13)), 0])
        body += rng.integers(0, 256, 14, dtype=np.uint8).tobytes()
    head = bytearray(0x30)
    head[0:4] = b"VAGp"
    head[4:8] = struct.pack(">I", 0x20)
    head[0x0C:0x10] = struct.pack(">I", len(body))
    head[0x10:0x14] = struct.pack(">I", rate)
    Path(path).write_bytes(bytes(head) + bytes(body))


def write_late_track_ps(path) -> None:
    """A program stream of video.m2v in 2000-byte video PES packets and
    then a.mp2 in 1000-byte audio packets: its track starts after the
    whole video."""
    from tcforge_tpu_torch.io.psmux import pack_header, pes_packet
    ps = bytearray()
    scr = 0
    for sid, data, step in ((0xE0, _ts_es("video.m2v"), 2000),
                            (0xC0, _ts_es("a.mp2"), 1000)):
        for at in range(0, len(data), step):
            ps += pack_header(scr) + pes_packet(sid, data[at:at + step])
            scr += 1800
    ps += b"\x00\x00\x01\xb9"
    Path(path).write_bytes(bytes(ps))


def route_input(name: str, directory) -> Path:
    """An input of the route goldens, written into ``directory`` once
    (see ``ROUTE_GOLDEN``)."""
    directory = Path(directory)
    if name == "VIDEO_TS" or (DVD_DATA / name).is_file():
        return DVD_DATA / name
    if (MJPEG_DATA / name).is_file():
        return MJPEG_DATA / name
    if not name.startswith("{"):
        return ts_input(name, directory)
    out = directory / {"{y4m}": "route_in.y4m", "{au}": "a.au",
                       "{ulaw}": "ulaw.au", "{vag}": "a.vag",
                       "{late}": "late.mpg"}[name]
    if out.exists():
        return out
    rng = np.random.default_rng(29)
    if name == "{y4m}":
        write_test_y4m(out, 64, 48, 8, seed=23)
    elif name == "{au}":
        write_au(out, np.clip(rng.standard_normal((12000, 2)) * 3000,
                              -32768, 32767).astype(np.int16), 44100)
    elif name == "{ulaw}":
        t = np.arange(8000) / 16000.0
        tone = 9000 * np.sin(2 * np.pi * 440 * t)
        write_au(out, np.rint(tone).astype(np.int16)[:, None], 16000,
                 ulaw=True)
    elif name == "{vag}":
        write_vag(out, 31, 300)
    else:
        write_late_track_ps(out)
    return out


def route_golden_argv(case: str, directory, inputs) -> list:
    """The CLI arguments of a ``ROUTE_GOLDEN`` case: its inputs written
    into (or read from) ``inputs``, its outputs in ``directory``; "{ogm}"
    is vob_vorbis_ogg's OGM in ``directory``'s parent's
    ``vob_vorbis_ogg`` directory."""
    directory = Path(directory)
    src, args, outs, _rc = ROUTE_GOLDEN[case]
    ogm = str(directory.parent / "vob_vorbis_ogg" / "o.ogg")

    def fill(a):
        if "{d}" in a:
            return a.replace("{d}", str(directory))
        if a == "{ogm}":
            return ogm
        if a.startswith("{") or a.endswith((".vob", ".ts", ".avi")):
            return str(route_input(a, inputs))
        return a
    src = ogm if src == "{ogm}" else str(route_input(src, inputs))
    return ["-i", src, "-o", str(directory / outs[0]),
            *(fill(a) for a in args)]


def route_golden_outputs(case: str, directory) -> list:
    """The files a ``ROUTE_GOLDEN`` case writes, in order (a PSU case's
    units, not its ``%d`` name)."""
    outs = ROUTE_GOLDEN[case][2]
    return [Path(directory) / f for f in outs if "%d" not in f]


# cfg1: YUV420P -> RGB24 -> YUV420P, then the zoom
CFG1_W, CFG1_H, CFG1_ZOOM = 640, 480, (512, 384)

# the bound (H100 SXM datasheet): device memory at 3.35 TB/s, and
# int32 instructions at 64 lanes per SM (half the 128 fp32 lanes behind
# the 67 TFLOP/s fp32 peak) x 132 SMs x 1.98 GHz; the card's L2
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# fused multiply-adds a second: float32 at the 67 TFLOP/s peak outside
# the tensor cores, float64 at 34 TFLOP/s (two operations each)
F32_FMA_PER_S = 67e12 / 2
F64_FMA_PER_S = 34e12 / 2
L2_BYTES = 50 << 20
# int32 operations per element, the fewest each function needs: a
# spatial step is the index (add, shift, two clamps for hqdn3d; add and
# clamps for denoise3d) and the sum; a temporal step adds the carry's
# shift, round and mask and the emitted byte's
SCAN_OPS = {"hqdn3d_spatial_scan": 5, "d3_spatial_scan": 4,
            "hqdn3d_temporal_scan": 12, "d3_temporal_scan": 4}
# unsharp: 2*sx + 2*sy adds for the blur (the [1,1] cascade) and this
# many for rounding, shift, sharpening and clamp per pixel
UNSHARP_OPS = 8
# unsharp off the path: matrices (the fifteen register instances, steps
# 0..3 on each axis, are checked besides), planes, amounts
UNSHARP_MATRICES = ((3, 3), (5, 5), (7, 5), (7, 7), (3, 7), (9, 9),
                    (17, 15), (33, 1), (1, 33))
UNSHARP_SHAPES = ((2, 1, 1), (3, 31, 33), (2, 129, 127), (1, 719, 1277),
                  (2, 37, 400), (1, 2, 129), (17, 9, 64), (17, 33, 36))
UNSHARP_AMOUNTS = (0.8, -1.5)
# TomsMoComp per 32-bit word of four synthesized pixels (byte-SIMD
# operations do four at once): per candidate a pair average, an abs
# difference, a compare and two selects; then the +1 bias and the clamp
# to the bob pair's window (min, max, two saturated adds, max, min)
TMC_OPS_PER_CANDIDATE = 5
TMC_OPS = 7
# yuvdenoise's chroma correction per pixel: |ref - tmp| and its test,
# f1's subtraction, product, division and two clamps, f2, the flat-index
# test, and the 3-tap blend (four sums, two products, two divisions by
# 3, a sum and a division by 255) and the select
YD_CHROMA_OPS = 24
# the field search: one byte SAD per pixel per candidate; __vsadu4 takes
# four in one int32 lane operation, so its bound counts four to an
# operation.  The warp: float32 operations per output pixel of the
# bilinear form (two source coordinates, two floors, four weights, three
# fused multiply-adds and two products) at the card's float32 rate
SADS_PER_OP = 4
WARP_FLOPS = 24
FP32_OPS_PER_S = 67e12
# kernel timing: the host time to queue one call, which the stream
# sleeps ahead of the timed calls, at the card's clock
QUEUE_S_PER_CALL = 2e-4
SLEEP_HZ = 1.98e9
# phase 3 off the paths: H or W of 1, 2, 31, 33, 127, 129, 719 and 1277;
# (2, 37, 400) also takes the 16-byte paths at a ragged tile and strip
RAGGED_SHAPES = ((2, 1, 1), (3, 31, 33), (2, 129, 127), (1, 719, 1277),
                 (2, 37, 400), (1, 2, 129))
# the spatial scans' step latency: a 720p luma plane
STEP_SHAPE = (720, 1280)
# phase 3 off the paths, TomsMoComp's window form: widths and heights
# (|dx| = 4 reaches both edges at effort 15), batches of n frames, two
# in a row so that the carried frames cross them
TMC_WIDTHS = (1, 5, 9, 13, 127, 1277)
TMC_HEIGHTS = (1, 3, 4, 5)
TMC_BATCHES = (1, 2, 17)
# the temporal scans off the paths: planes (h, w) and the offset in
# elements at which the input tensors start.  plane % 4 != 0 or an
# offset of 1 takes the scalar path; 64x128 and 360x640 at offset 0 take
# the four-pixel vectors, at 1 frame (fewer than the kernel loads ahead)
# and 17 (one batch ahead and a frame left over)
TEMPORAL_PLANES = ((1, 1, 0), (3, 5, 0), (37, 402, 0), (719, 1277, 0),
                   (64, 128, 1), (64, 128, 0), (360, 640, 0))
TEMPORAL_FRAMES = (1, 17)

KERNELS = {
    "hqdn3d_spatial_scan": ("tcforge_tpu_torch/csrc/hqdn3d_scan.cu",
                            "tcforge_tpu/ops/kernels.py:221"),
    "hqdn3d_temporal_scan": ("tcforge_tpu_torch/csrc/hqdn3d_scan.cu",
                             "tcforge_tpu/ops/kernels.py:277"),
    "zoom_pass": ("tcforge_tpu_torch/csrc/zoom_pass.cu",
                  "tcforge_tpu/ops/kernels.py:859"),
    "unsharp": ("tcforge_tpu_torch/csrc/unsharp.cu",
                "tcforge_tpu/ops/kernels.py:692"),
    "tomsmocomp": ("tcforge_tpu_torch/csrc/tomsmocomp.cu",
                   "tcforge_tpu/ops/kernels.py:750"),
    "d3_spatial_scan": ("tcforge_tpu_torch/csrc/hqdn3d_scan.cu",
                        "tcforge_tpu/ops/kernels.py:221"),
    "d3_temporal_scan": ("tcforge_tpu_torch/csrc/hqdn3d_scan.cu",
                         "tcforge_tpu/ops/kernels.py:337"),
    # not a TPU kernel: the lax.scan of correct_chroma
    "yuvdenoise_chroma": ("tcforge_tpu_torch/csrc/yuvdenoise.cu",
                          "tcforge_tpu/modules/filters/yuvdenoise.py:183"),
    # not TPU kernels: the lax.scan of field_search and the XLA ops of
    # warp_plane
    "stabilize_field_search": ("tcforge_tpu_torch/csrc/stabilize.cu",
                               "tcforge_tpu/modules/filters/stabilize.py:209"),
    "transform_warp": ("tcforge_tpu_torch/csrc/stabilize.cu",
                       "tcforge_tpu/modules/filters/stabilize.py:632"),
    # not TPU kernels: the XLA ops of _recon_picture_math and
    # _recon_field_core, and the CPU branch of reconstruct_intra_batch_jax
    # (the native float64 IDCT)
    "mpeg2_recon": ("tcforge_tpu_torch/csrc/mpeg2_recon.cu",
                    "tcforge_tpu/io/mpeg2codec.py:1527"),
    "mpeg2_idct_intra": ("tcforge_tpu_torch/csrc/mpeg2_recon.cu",
                         "tcforge_tpu/io/mpeg2codec.py:1851"),
    # not TPU kernels: the encoder's XLA ops (motion_search with
    # halfpel_refine, _mc_pred_half, the block math of _intra_math_jax
    # and _code_plane_inter), whose CPU route is native/tcforge_host.cpp
    "mpeg2_me": ("tcforge_tpu_torch/csrc/mpeg2_encode.cu",
                 "tcforge_tpu/io/mpeg2enc.py:388"),
    "mpeg2_enc_pred": ("tcforge_tpu_torch/csrc/mpeg2_encode.cu",
                       "tcforge_tpu/io/mpeg2enc.py:482"),
    "mpeg2_enc_bmode": ("tcforge_tpu_torch/csrc/mpeg2_encode.cu",
                        "tcforge_tpu/io/mpeg2enc.py:1110"),
    "mpeg2_enc_blocks": ("tcforge_tpu_torch/csrc/mpeg2_encode.cu",
                         "tcforge_tpu/io/mpeg2enc.py:606"),
    # the 4:2:2 forms of four of them (FORMS_422): _recon_picture_math and
    # _recon_field_core with chroma=2, reconstruct_intra_422's native
    # IDCT, and the encoder's 4:2:2 layout (_chroma_mv_half_422,
    # _chroma_params, _enc_layout)
    "mpeg2_recon_422": ("tcforge_tpu_torch/csrc/mpeg2_recon.cu",
                        "tcforge_tpu/io/mpeg2codec.py:1527"),
    "mpeg2_idct_intra_422": ("tcforge_tpu_torch/csrc/mpeg2_recon.cu",
                             "tcforge_tpu/io/mpeg2codec.py:947"),
    "mpeg2_enc_pred_422": ("tcforge_tpu_torch/csrc/mpeg2_encode.cu",
                           "tcforge_tpu/io/mpeg2enc.py:530"),
    "mpeg2_enc_blocks_422": ("tcforge_tpu_torch/csrc/mpeg2_encode.cu",
                             "tcforge_tpu/io/mpeg2enc.py:653"),
    # not TPU kernels: the XLA ops of _recon_vop_math and, for an I-VOP,
    # xvid_idct_jax (the JAX CLI's route is the numpy decoder's)
    "mpeg4_recon": ("tcforge_tpu_torch/csrc/mpeg4_recon.cu",
                    "tcforge_tpu/io/mpeg4jax.py:140"),
    "mpeg4_idct_intra": ("tcforge_tpu_torch/csrc/mpeg4_recon.cu",
                         "tcforge_tpu/io/mpeg4jax.py:52"),
    # not TPU kernels: the numpy decoder's quarter-sample MC
    # (_mc_block_qpel) and field MC (_field_pred_mb), which the JAX device
    # form refuses
    "mpeg4_recon_qpel": ("tcforge_tpu_torch/csrc/mpeg4_recon.cu",
                         "tcforge_tpu/io/mpeg4dec.py:2074"),
    "mpeg4_recon_field": ("tcforge_tpu_torch/csrc/mpeg4_recon.cu",
                          "tcforge_tpu/io/mpeg4dec.py:2007"),
    # not a TPU kernel: the numpy decoder's GMC warp (_gmc_warp_planes and
    # _gmc_bilin), which the JAX device form refuses
    "mpeg4_gmc_warp": ("tcforge_tpu_torch/csrc/mpeg4_recon.cu",
                       "tcforge_tpu/io/mpeg4dec.py:1411"),
    # not TPU kernels: the numpy loops of the JAX package's MPEG-4
    # encoder (_encode_pvop's and _encode_bvop's decisions, the block
    # coding of _code_intra_mb and the inter macroblocks)
    "mpeg4_enc_me": ("tcforge_tpu_torch/csrc/mpeg4_encode.cu",
                     "tcforge_tpu/io/mpeg4enc.py:647"),
    "mpeg4_enc_bme": ("tcforge_tpu_torch/csrc/mpeg4_encode.cu",
                      "tcforge_tpu/io/mpeg4enc.py:858"),
    "mpeg4_enc_blocks": ("tcforge_tpu_torch/csrc/mpeg4_encode.cu",
                         "tcforge_tpu/io/mpeg4enc.py:352"),
    # not TPU kernels: the JAX package decodes JPEG through PIL
    # (Image.open in its avi importer; io/mov.py:342 the same for MOV)
    "jpeg_idct": ("tcforge_tpu_torch/csrc/jpeg_decode.cu",
                  "tcforge_tpu/modules/importers/avi_import.py:175"),
    "jpeg_color": ("tcforge_tpu_torch/csrc/jpeg_decode.cu",
                   "tcforge_tpu/modules/importers/avi_import.py:175"),
    # not TPU kernels: the JAX package encodes JPEG through PIL
    # (Image.save in its movjpeg encoder)
    "jpeg_ycc_down": ("tcforge_tpu_torch/csrc/jpeg_encode.cu",
                      "tcforge_tpu/modules/importers/mov_import.py:141"),
    "jpeg_fdct_quant": ("tcforge_tpu_torch/csrc/jpeg_encode.cu",
                        "tcforge_tpu/modules/importers/mov_import.py:141"),
    # not TPU kernels: the JAX package's DV codec and RTjpeg are numpy
    # (the IDCTs and placement of DVDecoder.decode, the transform, modes,
    # quantizer and bit count of DVEncoder._segment_strings; RTjpeg's
    # idct_blocks and fdct_blocks with quant_blocks)
    "dv_idct": ("tcforge_tpu_torch/csrc/dv.cu", "tcforge_tpu/io/dvdec.py:267"),
    "dv_fdct_cost": ("tcforge_tpu_torch/csrc/dv.cu",
                     "tcforge_tpu/io/dvenc.py:481"),
    "rtjpeg_idct": ("tcforge_tpu_torch/csrc/rtjpeg.cu",
                    "tcforge_tpu/io/rtjpeg.py:206"),
    "rtjpeg_fdct_quant": ("tcforge_tpu_torch/csrc/rtjpeg.cu",
                          "tcforge_tpu/io/rtjpeg.py:125"),
    # not TPU kernels: the JAX package's Theora is numpy (the decoder's
    # _reconstruct and _loop_filter, the encoder's _quantize_blocks with
    # _fdct_blocks and _choose_modes with _search_mv)
    "theora_recon": ("tcforge_tpu_torch/csrc/theora.cu",
                     "tcforge_tpu/io/theora.py:1102"),
    "theora_loop_filter": ("tcforge_tpu_torch/csrc/theora.cu",
                           "tcforge_tpu/io/theora.py:1256"),
    "theora_fdct_quant": ("tcforge_tpu_torch/csrc/theora.cu",
                          "tcforge_tpu/io/theoraenc.py:936"),
    "theora_me": ("tcforge_tpu_torch/csrc/theora.cu",
                  "tcforge_tpu/io/theoraenc.py:769"),
}
LIBS = ("hqdn3d_scan", "zoom_pass", "unsharp", "tomsmocomp", "yuvdenoise",
        "stabilize", "mpeg2_recon", "mpeg2_encode", "mpeg4_recon",
        "mpeg4_encode", "jpeg_decode", "jpeg_encode", "dv", "rtjpeg",
        "theora")
# the host libraries (g++): the MPEG-2 parse and syntax writer, the JPEG
# entropy decode and Huffman encode, the DV, RTjpeg and Theora coders
HOST_LIBS = ("mpeg2intra", "mpeg2encode", "jpeg_entropy", "jpeg_huffenc",
             "dv_host", "rtjpeg_host", "theora_host")
# each wrapper of ops/kernels.py, whose plain version is <name>_ref
WRAPPERS = ("spatial_scan", "temporal_scan", "zoom_pass", "unsharp_plane",
            "tomsmocomp_plane", "tomsmocomp_window", "d3_spatial_scan",
            "d3_temporal_scan", "yuvdenoise_chroma", "stabilize_field_search",
            "transform_warp", "mpeg2_recon", "mpeg2_idct_intra", "mpeg2_me",
            "mpeg2_enc_pred", "mpeg2_enc_bmode", "mpeg2_enc_blocks",
            "mpeg4_recon", "mpeg4_idct_intra", "mpeg4_recon_qpel",
            "mpeg4_recon_field", "mpeg4_gmc_warp", "mpeg4_enc_me",
            "mpeg4_enc_bme", "mpeg4_enc_blocks", "jpeg_idct", "jpeg_color",
            "jpeg_ycc_down", "jpeg_fdct_quant", "dv_idct", "dv_fdct_cost",
            "rtjpeg_idct", "rtjpeg_fdct_quant", "theora_recon",
            "theora_loop_filter", "theora_fdct_quant", "theora_me")


def write_test_y4m(path, width: int, height: int, frames: int,
                   seed: int, fps=(25, 1)) -> None:
    """A seeded YUV420P Y4M of uniform noise at ``fps`` (num, den)."""
    from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MWriter
    rng = np.random.default_rng(seed)
    hdr = Y4MHeader(width=width, height=height, fps_num=fps[0],
                    fps_den=fps[1])
    with Y4MWriter(str(path), hdr) as wr:
        for _ in range(frames):
            wr.write_frame(
                rng.integers(0, 256, (height, width), dtype=np.uint8),
                rng.integers(0, 256, (height // 2, width // 2),
                             dtype=np.uint8),
                rng.integers(0, 256, (height // 2, width // 2),
                             dtype=np.uint8))


# the audio track's levels: silence, hiss, quiet, speech-like and loud
AUDIO_LEVELS = (0.0, 2.0, 200.0, 3000.0, 12000.0)


def write_test_wav(path, samples: int, seed: int, rate: int = 48000,
                   channels: int = 2, frame: int = 1602) -> None:
    """A seeded s16 WAV of Gaussian noise whose level holds for runs of
    1 to 7 frames of ``frame`` samples, each run at one of
    ``AUDIO_LEVELS``: normalize's gate and gain, aclip's skips and
    detectsilence's intervals all see their branches."""
    from tcforge_tpu_torch.io.wav import WavInfo, WavWriter
    rng = np.random.default_rng(seed)
    frames = -(-samples // frame)
    runs = rng.integers(1, 8, size=frames)
    levels = rng.choice(np.array(AUDIO_LEVELS, np.float32), size=frames)
    per_frame = np.repeat(levels, runs)[:frames]
    gain = np.repeat(per_frame, frame)[:samples, None]
    noise = rng.standard_normal((samples, channels), dtype=np.float32)
    pcm = np.clip(np.rint(noise * gain), -32768, 32767).astype(np.int16)
    with WavWriter(str(path), WavInfo(rate=rate, channels=channels,
                                      bits=16)) as w:
        w.write_samples(pcm)


def write_telecine_y4m(path, width: int, height: int, frames: int,
                       seed: int, fps=(30000, 1001), station=None) -> None:
    """A seeded YUV420P Y4M of 3:2 telecined film: a progressive
    sequence (8x8 blocks of noise panning 8 pixels a film frame, each
    frame with its own grain of +-3) whose fields are repeated A A, B B,
    B C, C D, D D, and +-1 of noise on every video frame, so that the
    repeated frame that decimate looks for is close to its neighbour
    and not equal to it.  With ``station`` = (x, y, w, h) a static
    "station logo" (``station_logo``) covers that luma box and its
    chroma on every frame, over the grain."""
    from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MWriter
    rng = np.random.default_rng(seed)
    films = -(-frames // 5) * 4

    def film_planes(h, w, block):
        wide = np.kron(rng.integers(16, 240, (-(-h // block),
                                              -(-w // block) + films)),
                       np.ones((block, block), dtype=np.int64))
        return [np.clip(wide[:h, block * i:block * i + w]
                        + rng.integers(-3, 4, (h, w)), 0, 255)
                for i in range(films)]

    film = list(zip(film_planes(height, width, 8),
                    film_planes(height // 2, width // 2, 4),
                    film_planes(height // 2, width // 2, 4)))
    hdr = Y4MHeader(width=width, height=height, fps_num=fps[0],
                    fps_den=fps[1])
    with Y4MWriter(str(path), hdr) as wr:
        for k in range(frames):
            group, phase = divmod(k, 5)
            top, bottom = ((0, 0), (1, 1), (1, 2), (2, 3), (3, 3))[phase]
            planes = []
            for t, b in zip(film[4 * group + top], film[4 * group + bottom]):
                p = t.copy()
                p[1::2] = b[1::2]
                p += rng.integers(-1, 2, p.shape)
                planes.append(np.clip(p, 0, 255).astype(np.uint8))
            if station is not None:
                x, y, bw, bh = station
                for i, logo in enumerate(station_logo(bw, bh)):
                    s = 1 if i == 0 else 2
                    planes[i][y // s:y // s + bh // s,
                              x // s:x // s + bw // s] = logo
            wr.write_frame(*planes)


def write_motion_y4m(path, width: int, height: int, frames: int, seed: int,
                     fps=(30000, 1001), repeat_every: int = 0,
                     grain: int = 1, impulses: float = 0.0,
                     chroma: int = 420) -> None:
    """A seeded interlaced Y4M, YUV420P (or YUV422P with ``chroma`` 422,
    whose chroma moves as far down as the luma): a fixed noise
    background with a noise block a quarter of the frame wide that moves
    4 pixels right and 2 down a frame, its bottom field half a step
    ahead of its top field, and one hard cut (a new background and
    block) at the middle frame; +-``grain`` of grain on every frame, and
    with ``impulses`` = p that share of each plane's samples set to 0 or
    255 (a capture's impulse noise).  With ``repeat_every`` = k, every
    k-th frame repeats the one before it (with its own grain): a
    near-duplicate for modfps to skip."""
    from tcforge_tpu_torch.core.formats import ImageFormat
    from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MWriter
    rng = np.random.default_rng(seed)
    ch = height if chroma == 422 else height // 2

    def scene(h, w):
        bg = rng.integers(16, 236, (h, w), dtype=np.int16)
        block = rng.integers(16, 236, (max(1, h // 4), max(1, w // 4)),
                             dtype=np.int16)
        return bg, block

    def draw(bg, block, x, y, half):
        out = bg.copy()
        bh, bw = block.shape
        y0 = y % max(1, bg.shape[0] - bh)
        for rows, dx in ((slice(0, None, 2), 0), (slice(1, None, 2), half)):
            x0 = (x + dx) % max(1, bg.shape[1] - bw)
            out[y0:y0 + bh, x0:x0 + bw][rows] = block[rows]
        return out

    scenes = [[scene(height, width), scene(ch, width // 2),
               scene(ch, width // 2)] for _ in range(2)]
    hdr = Y4MHeader(width=width, height=height, fps_num=fps[0],
                    fps_den=fps[1], interlacing="t",
                    format=(ImageFormat.YUV422P if chroma == 422
                            else ImageFormat.YUV420P))
    t = 0
    with Y4MWriter(str(path), hdr) as wr:
        for k in range(frames):
            if not (repeat_every and k % repeat_every == repeat_every - 1):
                t += 1                      # else the last frame again
            planes = []
            for i, (bg, block) in enumerate(scenes[2 * k >= frames]):
                s = 2 if i == 0 else 1       # chroma moves half as far
                sy = 2 if i == 0 or chroma == 422 else 1
                p = draw(bg, block, 2 * s * t, sy * t, s) + rng.integers(
                    -grain, grain + 1, bg.shape, dtype=np.int16)
                if impulses:
                    hit = rng.random(bg.shape) < impulses
                    p[hit] = 255 * rng.integers(0, 2, int(hit.sum()))
                planes.append(np.clip(p, 0, 255).astype(np.uint8))
            wr.write_frame(*planes)


def station_logo(width: int, height: int):
    """A broadcaster's static logo of ``width`` x ``height`` as YUV420P
    planes: a white frame two pixels wide around a dark field with a
    light diagonal band, and a tinted chroma."""
    yy, xx = np.mgrid[0:height, 0:width]
    y = np.where((abs(xx - yy * width // max(height, 1)) < width // 8 + 1),
                 200, 40)
    border = ((xx < 2) | (yy < 2) | (xx >= width - 2) | (yy >= height - 2))
    y = np.where(border, 235, y).astype(np.uint8)
    ch, cw = height // 2, width // 2
    return (y, np.full((ch, cw), 90, np.uint8),
            np.full((ch, cw), 170, np.uint8))


def write_logo_png(path, width: int, height: int, seed: int) -> None:
    """The watermark for ``logo``: a seeded RGBA PNG whose alpha is 0
    (the video shows), 255 (the logo is copied) and every level between
    (blended) in bands, over coloured gradients."""
    from tcforge_tpu_torch.io.image import write_png
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    alpha = np.select([xx < width // 4, xx >= 3 * width // 4],
                      [0, 255], (xx * 255 // max(width - 1, 1)))
    alpha = np.where((yy + xx) % 7 == 0, rng.integers(0, 256, alpha.shape),
                     alpha)
    rgba = np.stack([xx * 255 // max(width - 1, 1),
                     yy * 255 // max(height - 1, 1),
                     rng.integers(0, 256, (height, width)), alpha],
                    axis=-1).astype(np.uint8)
    write_png(str(path), rgba)


def write_shaky_y4m(path, width: int, height: int, frames: int, seed: int,
                    fps=(30000, 1001), shakiness: int = 4) -> None:
    """A seeded YUV420P Y4M of hand-held footage: a base of noise
    upsampled in 8x8 blocks (features about 8 pixels wide, so the
    strided coarse search finds a basin), moved by a seeded random walk
    of integer translations kept inside half of stabilize's maxshift
    (``min(w, h) * shakiness // 40``), and every fourth frame turned by
    0.5 to 2 degrees about the centre (nearest neighbour), so that the
    rotation estimate sees a signal.  Chroma follows at half the
    translation."""
    from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MWriter
    rng = np.random.default_rng(seed)
    limit = max(1, min(width, height) * shakiness // 40 // 2)
    margin = 2 * limit + max(width, height) // 8 + 8
    bases = []
    for s, block in ((1, 8), (2, 4)):
        h, w = height // s + 2 * margin, width // s + 2 * margin
        small = rng.integers(16, 236, (-(-h // block), -(-w // block)))
        bases.append(np.kron(small, np.ones((block, block), np.int64))
                     [:h, :w].astype(np.uint8))
    hdr = Y4MHeader(width=width, height=height, fps_num=fps[0],
                    fps_den=fps[1])
    tx = ty = 0
    with Y4MWriter(str(path), hdr) as wr:
        for k in range(frames):
            tx = int(np.clip(tx + rng.integers(-2, 3), -limit, limit))
            ty = int(np.clip(ty + rng.integers(-2, 3), -limit, limit))
            angle = (np.deg2rad(rng.uniform(0.5, 2.0))
                     * rng.choice((-1, 1)) if k % 4 == 3 else 0.0)
            planes = []
            for s, base in zip((1, 2, 2), (bases[0], bases[1], bases[1])):
                h, w = height // s, width // s
                if not angle:
                    y0, x0 = margin - ty // s, margin - tx // s
                    planes.append(base[y0:y0 + h, x0:x0 + w])
                    continue
                c, sn = np.cos(angle), np.sin(angle)
                yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
                cx, cy = (w - 1) / 2, (h - 1) / 2
                sx = c * (xx - cx) - sn * (yy - cy) + cx - tx // s + margin
                sy = sn * (xx - cx) + c * (yy - cy) + cy - ty // s + margin
                sx = np.clip(np.rint(sx).astype(np.int64), 0,
                             base.shape[1] - 1)
                sy = np.clip(np.rint(sy).astype(np.int64), 0,
                             base.shape[0] - 1)
                planes.append(base[sy, sx])
            wr.write_frame(*planes)


def write_input(spec, path, frames: int, seed: int) -> None:
    """A path's input: ``frames`` frames of its geometry, fps and
    content (``noise``, the default, ``telecine`` (with the path's
    ``station`` box), ``motion`` or ``shaky``)."""
    content = spec.get("content", "noise")
    if content == "telecine":
        write_telecine_y4m(path, spec["w"], spec["h"], frames, seed,
                           fps=spec["fps"], station=spec.get("station"))
    elif content == "shaky":
        write_shaky_y4m(path, spec["w"], spec["h"], frames, seed,
                        fps=spec["fps"])
    elif content == "motion":
        write_motion_y4m(path, spec["w"], spec["h"], frames, seed,
                         fps=spec["fps"], repeat_every=spec.get("repeat", 0),
                         grain=spec.get("grain", 1),
                         impulses=spec.get("impulses", 0.0))
    else:
        write_test_y4m(path, spec["w"], spec["h"], frames, seed,
                       fps=spec["fps"])


def sha256_file(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


_T0 = time.perf_counter()


def emit(**record) -> None:
    """One JSON line, with ``t``: seconds since the script started."""
    record.setdefault("t", round(time.perf_counter() - _T0, 3))
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


@contextlib.contextmanager
def plain_versions(kernels):
    """Route every wrapper of ``kernels`` to its plain version, so a
    chain built from the wrappers runs on the plain versions alone."""
    saved = {name: getattr(kernels, name) for name in WRAPPERS}
    try:
        for name in WRAPPERS:
            setattr(kernels, name, getattr(kernels, name + "_ref"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def main(argv=()) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--parent", metavar="DIR",
        help="a checkout of an earlier commit (any since 0713932, which "
             "has this tree's unsharp_plane, temporal_scan, "
             "d3_temporal_scan and tomsmocomp_plane wrappers): its "
             "unsharp, TomsMoComp and temporal "
             "kernels are built from DIR and called through DIR's own "
             "wrappers, and its CLI runs the paths it has, each timed "
             "beside this tree's, in turns, on the same inputs")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tcforge_tpu_torch import cli
    from tcforge_tpu_torch.core.job import FilterSpec, Job
    from tcforge_tpu_torch.io.y4m import Y4MReader
    from tcforge_tpu_torch.modules.filters.hqdn3d import Hqdn3dFilter
    from tcforge_tpu_torch.ops import _build, colorspace, kernels, video, zoom

    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit(phase="card", name=torch.cuda.get_device_name(0), nvidia_smi=card,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build: one nvcc per source, all started together
    def build(lib):
        t0 = time.perf_counter()
        path, report = _build.build(lib)
        return path, report, time.perf_counter() - t0

    def build_host(lib):
        t0 = time.perf_counter()
        path, report = _build.build_host(lib)
        return path, report, time.perf_counter() - t0

    with ThreadPoolExecutor(len(LIBS) + len(HOST_LIBS)) as pool:
        host = [pool.submit(build_host, lib) for lib in HOST_LIBS]
        builds = list(pool.map(build, LIBS))
    for lib, job in zip(HOST_LIBS, host):
        path, _report, seconds = job.result()
        emit(phase="build", lib=lib, seconds=seconds, compiler="g++",
             path=str(path.relative_to(ROOT)))
    for lib, (path, report, seconds) in zip(LIBS, builds):
        kernels._lib(lib)
        emit(phase="build", lib=lib, seconds=seconds,
             path=str(path.relative_to(ROOT)))
        for line in report.splitlines():
            if "ptxas info" in line:
                print("  " + line.strip(), flush=True)

    # 3. kernels vs plain versions at the main path's shapes; the library
    # calls' float32 is plain fp32 arithmetic, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = Job(deinterlace=5, zoom_width=1280, zoom_height=720,
              filters=[FilterSpec("hqdn3d", "luma=4.0")])
    hq = Hqdn3dFilter(job, "luma=4.0")
    bench = KernelBench(torch, dev, kernels)
    if args.parent:
        bench.parent = ParentPackage(Path(args.parent))
    _check_main_kernels(torch, kernels, zoom, hq, bench)
    torch.cuda.empty_cache()
    _check_slice_kernels(torch, kernels, bench)
    torch.cuda.empty_cache()
    _check_yuvdenoise_chroma(torch, kernels, bench)
    torch.cuda.empty_cache()
    _check_stabilize_kernels(torch, kernels, bench)
    torch.cuda.empty_cache()
    _check_mpeg2_kernels(torch, kernels, bench)
    torch.cuda.empty_cache()
    _check_encode_kernels(torch, kernels, bench)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_m422_") as tmp:
        _check_mpeg422_kernels(torch, kernels, bench, tmp)
    torch.cuda.empty_cache()
    _check_mpeg4_kernels(torch, kernels, bench)
    torch.cuda.empty_cache()
    _check_asp_kernels(torch, kernels, bench)
    torch.cuda.empty_cache()
    # the GMC stream of divx_gmc, written once for phases 3 to 6
    gmc_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_gmc_")
    gmc_avi = gmc_path_input("divx_gmc", gmc_dir.name)
    _check_gmc_kernels(torch, kernels, bench, gmc_avi, gmc_dir.name)
    # the mjpegenc path's inputs, written in phase 4 for phases 4 and 6
    mjpegenc_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_mjpegenc_")
    # the ts1080 path's capture, written in phase 4 for phases 4 and 6
    ts_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_ts1080_")
    torch.cuda.empty_cache()
    _check_jpeg_kernels(torch, kernels, bench)
    torch.cuda.empty_cache()
    _check_jpegenc_kernels(torch, kernels, bench)
    torch.cuda.empty_cache()
    divxenc_checked = _check_mpeg4enc_kernels(torch, kernels, cli, bench)
    torch.cuda.empty_cache()
    _check_capture_kernels(torch, kernels, bench)
    # the capture paths' inputs, written in phase 4 for phases 4 and 6
    capture_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_capture_")
    torch.cuda.empty_cache()
    _check_theora_kernels(torch, kernels, bench)
    # the Theora paths' files, written in phase 4 for phases 4 and 6
    theora_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_theora_")
    torch.cuda.empty_cache()
    _check_ragged(torch, kernels, zoom, hq, bench)
    _check_unsharp_sizes(torch, kernels, bench)
    _check_tmc_windows(torch, kernels, bench)
    _check_temporal_planes(torch, kernels, hq, bench)
    torch.cuda.empty_cache()
    _scan_steps(torch, kernels, hq, bench)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        # 4. the main path through the port's CLI
        src = tmp / "in1080.y4m"
        out = tmp / "out720.y4m"
        write_test_y4m(src, MAIN_W, MAIN_H, MAIN_FRAMES, seed=3)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["-i", str(src), "-o", str(out), *MAIN_ARGS,
                       "--batch", str(MAIN_BATCH), "--device", "cuda",
                       "--progress_off", "-q"])
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        check(rc == 0, f"CLI exit code {rc}")
        emit(phase="main_path", frames=MAIN_FRAMES, seconds=e2e_s,
             e2e_fps=MAIN_FRAMES / e2e_s, launches=launches)
        for name in MAIN_KERNELS:
            check(launches[name] > 0, f"kernel {name} was not launched by "
                                      "the main path")
        got = _read_y4m(Y4MReader, out)
        check(got[0].shape == (MAIN_FRAMES, 720, 1280)
              and got[1].shape == (MAIN_FRAMES, 360, 640),
              f"main path output shapes {[p.shape for p in got]}")
        want = _plain_chain(torch, dev, _read_y4m(Y4MReader, src), hq,
                            video, zoom, kernels)
        diff = [int((torch.from_numpy(g).to(dev).int() - w.int()).abs()
                    .max()) for g, w in zip(got, want)]
        emit(phase="main_path_vs_plain", max_abs_err=max(diff),
             planes=["y", "u", "v"])
        check(max(diff) == 0, f"main path differs from the plain chain on "
                              f"the card: {diff}")

        # 5. golden digest pinned against the JAX CLI
        gsrc, gout = tmp / "golden_in.y4m", tmp / "golden_out.y4m"
        write_test_y4m(gsrc, GOLDEN_W, GOLDEN_H, GOLDEN_FRAMES, GOLDEN_SEED)
        rc = cli.main(["-i", str(gsrc), "-o", str(gout), *GOLDEN_ARGS,
                       "--device", "cuda", "--progress_off", "-q"])
        digest = sha256_file(gout)
        emit(phase="golden", sha256=digest, pinned=GOLDEN_SHA256)
        check(rc == 0 and digest == GOLDEN_SHA256,
              "golden output differs from the JAX-pinned digest")

        # 4. and 5. for the slice's paths
        path_launches = {}
        for name, spec in PATHS.items():
            path_launches[name] = _run_path(torch, cli, kernels, tmp, name,
                                            spec)
        for name in PATHS:
            gsrc, gout = tmp / "golden_in.y4m", tmp / f"golden_{name}.y4m"
            rc = cli.main(["-i", str(gsrc), "-o", str(gout),
                           *PATHS[name]["args"], "--batch", "3",
                           "--device", "cuda", "--progress_off", "-q"])
            digest = sha256_file(gout)
            emit(phase="golden", path=name, sha256=digest,
                 pinned=PATH_GOLDEN_SHA256[name])
            check(rc == 0 and digest == PATH_GOLDEN_SHA256[name],
                  f"{name} golden output differs from the JAX-pinned "
                  "digest")

        # 4. cfg3 at full width, against its CPU run; 5. its small case
        # and the RGB case
        _run_path(torch, cli, kernels, tmp, "cfg3", CFG3)
        for name, src_y4m, argv, pinned in (
                ("cfg3", tmp / "golden_cfg3_in.y4m", CFG3_GOLDEN["args"],
                 CFG3_GOLDEN_SHA256),
                ("rgb24", tmp / "golden_in.y4m", RGB_GOLDEN_ARGS,
                 RGB_GOLDEN_SHA256)):
            if name == "cfg3":
                write_telecine_y4m(src_y4m, CFG3_GOLDEN["w"],
                                   CFG3_GOLDEN["h"], CFG3_GOLDEN["frames"],
                                   CFG3_GOLDEN["seed"])
            gout = tmp / f"golden_{name}.y4m"
            rc = cli.main(["-i", str(src_y4m), "-o", str(gout), *argv,
                           "--device", "cuda", "--progress_off", "-q"])
            digest = sha256_file(gout)
            emit(phase="golden", path=name, sha256=digest, pinned=pinned)
            check(rc == 0 and digest == pinned,
                  f"{name} golden output differs from the JAX-pinned digest")

        # 4. and 5. for the field-rate paths, on interlaced content
        for name, spec in FIELD_PATHS.items():
            path_launches[name] = _run_path(torch, cli, kernels, tmp, name,
                                            spec)
            g = spec["golden"]
            gsrc = tmp / f"golden_{name}_in.y4m"
            gout = tmp / f"golden_{name}.y4m"
            write_input({**spec, **g}, gsrc, g.get("frames", GOLDEN_FRAMES),
                        GOLDEN_SEED)
            rc = cli.main(["-i", str(gsrc), "-o", str(gout), *g["args"],
                           "--batch", "3", "--device", "cuda",
                           "--progress_off", "-q"])
            digest = sha256_file(gout)
            emit(phase="golden", path=name, sha256=digest,
                 pinned=FIELD_GOLDEN_SHA256[name])
            check(rc == 0 and digest == FIELD_GOLDEN_SHA256[name],
                  f"{name} golden output differs from the JAX-pinned "
                  "digest")

        # 4. and 5. for the clean-up paths, on grain and impulse noise
        for name, spec in CLEAN_PATHS.items():
            path_launches[name] = _run_path(torch, cli, kernels, tmp, name,
                                            spec)
            g = spec["golden"]
            gsrc = tmp / f"golden_{name}_in.y4m"
            gout = tmp / f"golden_{name}.y4m"
            write_input({**spec, **g}, gsrc, GOLDEN_FRAMES, GOLDEN_SEED)
            rc = cli.main(["-i", str(gsrc), "-o", str(gout), *g["args"],
                           "--batch", "3", "--device", "cuda",
                           "--progress_off", "-q"])
            digest = sha256_file(gout)
            emit(phase="golden", path=name, sha256=digest,
                 pinned=CLEAN_GOLDEN_SHA256[name])
            check(rc == 0 and digest == CLEAN_GOLDEN_SHA256[name],
                  f"{name} golden output differs from the JAX-pinned "
                  "digest")

        # the clean-up filters' other options: the card's output (and
        # log) against the CPU's
        csrc = tmp / "clean_flags_in.y4m"
        write_input(CLEAN_FLAG_INPUT, csrc, GOLDEN_FRAMES, GOLDEN_SEED)
        for name in CLEAN_FLAG_CASES:
            got = {}
            for device in ("cuda", "cpu"):
                d = tmp / f"clean_{name}_{device}"
                d.mkdir()
                write_clean_aux(d)
                rc = cli.main(["-i", str(csrc), "-o", str(d / "out.y4m"),
                               *clean_flag_argv(name, d), "--device",
                               device, "--progress_off", "-q"])
                check(rc == 0, f"{name} on {device}: CLI exit code {rc}")
                got[device] = [(d / f).read_bytes() for f in
                               ("out.y4m", CLEAN_FLAG_FILES.get(name))
                               if f]
            same = got["cuda"] == got["cpu"]
            emit(phase="flags_vs_cpu", case=name, identical=same,
                 sha256=hashlib.sha256(got["cuda"][0]).hexdigest())
            check(same, f"{name}: the card's output differs from the CPU's")

        # 4. and 5. for the stabilization and broadcast paths, and their
        # other options against the CPU
        path_launches["stabilize"] = _run_stabilize(torch, cli, kernels,
                                                    tmp)
        path_launches["broadcast"] = _run_broadcast(torch, cli, kernels,
                                                    tmp)
        _overlay_goldens(cli, tmp)
        _overlay_flag_cases(cli, tmp)

        # 4., 5. and 6. for the audio track: the av path (its CLI timed
        # with and without the track), the audio-only path, the small
        # cases pinned against the JAX CLI
        path_launches["av"] = _run_av(torch, cli, kernels, tmp)
        # 4. and 5. for the DVD path: the MPEG-2 import into hqdn3d,
        # and the MPEG goldens pinned against the JAX CLI
        path_launches["dvd"] = _run_dvd(torch, cli, kernels, tmp)
        _mpeg_goldens(cli, tmp)
        # 4. and 5. for the DVD rip: the VIDEO_TS title with its AC-3
        # track, subtitles and hqdn3d, and the DVD goldens
        path_launches["dvdrip"] = _run_dvdrip(torch, cli, kernels, bench,
                                              tmp)
        _dvd_goldens(cli, tmp)
        # 4. and 5. for the ts1080 path: the ATSC capture to 720p with its
        # AC-3 track, a VideoCD track, PSU mode; the TS, VideoCD, PSU and
        # compressed-audio goldens
        path_launches["ts1080"] = _run_ts1080(torch, cli, kernels, bench,
                                              tmp, ts_dir.name)
        _ts_goldens(cli, tmp)
        # 4. and 5. for MPEG-2 export: the DVD authoring path at full
        # width, and the export goldens pinned against the JAX CLI
        path_launches["dvdauthor"] = _run_dvdauthor(torch, cli, kernels,
                                                    tmp)
        _author_goldens(cli, tmp)
        # 4. and 5. for the 4:2:2 path: the 422P encode (and its field and
        # two-pass variants) and its read-back kept at 4:2:2 and decimated,
        # and the 4:2:2 goldens pinned against the JAX CLI
        m422 = _run_mpeg422(torch, cli, kernels, tmp)
        path_launches["mpeg422"] = {
            **{k: m422["encode"][k] for k in MPEG422_KERNELS["encode"]},
            **{k: m422["keep"][k] for k in MPEG422_KERNELS["keep"]}}
        _mpeg422_goldens(cli, tmp)
        # 4. and 5. for the DivX path: divx.avi through -x avi, one
        # reconstruction launch a VOP, and the AVI goldens
        path_launches["divx"] = _run_divx(torch, cli, kernels, tmp)
        # 4. for the quarter-sample and interlaced paths, and the refusal
        # of quarter-sample field prediction
        for name in ASP_PATHS:
            path_launches[name] = _run_asp(torch, cli, kernels, tmp, name)
        _asp_refusal(cli, tmp)
        _avi_goldens(cli, tmp)
        # 4. and 5. for the GMC and short-header paths and their goldens
        for name in GMC_PATHS:
            path_launches[name] = _run_gmc(
                torch, cli, kernels, tmp, name,
                gmc_path_input(name, gmc_dir.name))
        _gmc_goldens(cli, tmp, gmc_avi)
        # 4. and 5. for the Motion-JPEG path and the JPEG goldens
        path_launches["mjpeg"] = _run_mjpeg(torch, cli, kernels, tmp)
        _mjpeg_goldens(cli, tmp)
        # 4. and 5. for the legacy-AVI export (kept for phase 6) and the
        # export goldens with MP3, MP2 and AC-3 and the mov multiplexor
        path_launches["mjpegenc"] = _run_mjpegenc(torch, cli, kernels, bench,
                                                  mjpegenc_dir.name)
        _mjpegenc_goldens(cli, tmp)
        # 4. and 5. for MPEG-4 export: the divxenc path at full width
        # against phase 3's checked run, the export goldens pinned against the JAX
        # CLI, and the read-back through the port's own decoder
        path_launches["divxenc"], divxenc_avi = _run_divxenc(
            torch, cli, kernels, tmp, divxenc_checked)
        _xvid_goldens(torch, cli, tmp, divxenc_avi)
        _run_audio_only(torch, cli, tmp)
        _audio_goldens(cli, tmp)
        # 4. and 5. for the audio half of the export: the ogm path (a DVD
        # title to XVID + Vorbis), the flagship xvid,lame,avi job without
        # -m, and the route goldens pinned against the JAX CLI
        path_launches["ogm"] = _run_ogm(torch, cli, kernels, tmp)
        path_launches["flagship"] = _run_flagship(torch, cli, kernels, tmp)
        _route_goldens(cli, tmp)
        # 4. and 5. for the capture codecs: the dv, dvenc and nuv paths
        # (and nuvrtj) at full width against their CPU digests, and the
        # capture goldens (NTSC both ways among them) against the JAX CLI's
        path_launches.update(_run_capture(torch, cli, kernels, bench,
                                          capture_dir.name))
        _capture_goldens(cli, tmp)
        # 4. and 5. for Theora: the ogv path and its read-back at full
        # width and the fixtures' decodes against their pinned digests,
        # and the Theora goldens against the JAX CLI's
        path_launches.update(_run_theora(torch, cli, kernels, bench,
                                         theora_dir.name))
        _theora_goldens(cli, tmp)
        emit(phase="audio_chain", batch=MAIN_BATCH,
             **_audio_chain_ms(torch, dev))
        _graph_capture_vs_collection(torch, dev)

        # the internal transforms, the engine's flags and the filters of
        # plain torch ops: the card's output against the CPU's
        gsrc = tmp / "golden_in.y4m"
        for name, argv in FLAG_CASES.items():
            outs = {}
            for device in ("cuda", "cpu"):
                outs[device] = tmp / f"flags_{name}_{device}.y4m"
                rc = cli.main(["-i", str(gsrc), "-o", str(outs[device]),
                               *argv, "--device", device, "--progress_off",
                               "-q"])
                check(rc == 0, f"{name} on {device}: CLI exit code {rc}")
            same = outs["cuda"].read_bytes() == outs["cpu"].read_bytes()
            emit(phase="flags_vs_cpu", case=name, identical=same,
                 sha256=sha256_file(outs["cuda"]))
            check(same, f"{name}: the card's output differs from the CPU's")

        # the staged engine (pinned rings, two copy streams) at every
        # read-ahead depth and batch size: the card's bytes against the
        # CPU's, on modfps's small case (its read-back, the zoom kernel)
        g = FIELD_PATHS["modfps"]["golden"]
        gsrc = tmp / "golden_modfps_in.y4m"
        argv = ["-i", str(gsrc), *g["args"], "--progress_off", "-q"]
        want = tmp / "sweep_cpu.y4m"
        check(cli.main([*argv, "-o", str(want), "--device", "cpu"]) == 0,
              "engine sweep: the CPU run failed")
        for prefetch in (1, 2, 4):
            for batch in (1, 3, 16):
                got = tmp / f"sweep_{prefetch}_{batch}.y4m"
                rc = cli.main([*argv, "-o", str(got), "--device", "cuda",
                               "--prefetch", str(prefetch), "--batch",
                               str(batch)])
                same = rc == 0 and got.read_bytes() == want.read_bytes()
                emit(phase="engine_vs_cpu", prefetch=prefetch, batch=batch,
                     identical=same)
                check(same, f"engine at --prefetch {prefetch} --batch "
                            f"{batch}: the card's output differs")

    # 4. cfg1 at full width, against its CPU run
    _run_cfg1(torch, dev, kernels, colorspace, zoom)

    # 6. steady-state chain frames/s on device-resident batches
    for name, spec in (("main", MAIN_PATH), *PATHS.items(), ("cfg3", CFG3),
                       *FIELD_PATHS.items(), *CLEAN_PATHS.items()):
        fps = _chain_fps(torch, dev, spec)
        emit(phase="chain", path=name, batch=MAIN_BATCH, **fps)
        torch.cuda.empty_cache()
    emit(phase="dvdclean_split", **_dvdclean_split(
        torch, dev, kernels, CLEAN_PATHS["dvdclean"]))
    torch.cuda.empty_cache()
    fps = _cfg1_fps(torch, dev, colorspace, zoom)
    emit(phase="chain", path="cfg1", batch=MAIN_BATCH, **fps)

    # 6. the CLI end to end, with the serial stages beside it
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        for name, spec in (("main", MAIN_PATH), *PATHS.items(),
                           ("cfg3", CFG3), *FIELD_PATHS.items(),
                           *CLEAN_PATHS.items()):
            _cli_rates(torch, dev, cli, Path(tmp), name, spec,
                       bench.parent if name not in FIELD_PATHS
                       and name not in CLEAN_PATHS else None)
    # 6. the stabilization and broadcast paths: chains, CLIs, pass 1's split
    with tempfile.TemporaryDirectory(prefix="chip_smoke_overlay_") as tmp:
        _overlay_rates(torch, dev, cli, Path(tmp))
    torch.cuda.empty_cache()
    # 6. the DVD path: decode and chain on the card, the host's parse,
    # the CLI on nine batches with the serial stages beside it
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dvd_") as tmp:
        _dvd_rates(torch, dev, cli, Path(tmp))
    torch.cuda.empty_cache()
    # 6. the DVD rip: its CLI with the track (and a film's subtitles)
    # and without, in turns; its serial stages
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rip_") as tmp:
        _dvdrip_rates(torch, dev, cli, Path(tmp))
    torch.cuda.empty_cache()
    # 6. the ts1080 path: its CLI, its serial stages, the device's share
    _ts1080_rates(torch, dev, cli, Path(ts_dir.name))
    ts_dir.cleanup()
    torch.cuda.empty_cache()
    # 6. the DVD authoring path: its CLI and the encoder's stages
    with tempfile.TemporaryDirectory(prefix="chip_smoke_author_") as tmp:
        _author_rates(torch, cli, Path(tmp))
    torch.cuda.empty_cache()
    # 6. the 4:2:2 path: the encode's and the read-backs' CLIs and stages
    with tempfile.TemporaryDirectory(prefix="chip_smoke_m422_") as tmp:
        _mpeg422_rates(torch, dev, cli, Path(tmp))
    torch.cuda.empty_cache()
    # 6. the DivX path: its CLI on 48 frames and its serial stages
    with tempfile.TemporaryDirectory(prefix="chip_smoke_divx_") as tmp:
        _divx_rates(torch, dev, cli, Path(tmp))
    torch.cuda.empty_cache()
    # 6. the quarter-sample and interlaced paths: each CLI on 24 frames
    # and its serial stages
    with tempfile.TemporaryDirectory(prefix="chip_smoke_asp_") as tmp:
        for name in ASP_PATHS:
            _asp_rates(torch, dev, cli, Path(tmp), name)
    torch.cuda.empty_cache()
    # 6. the GMC and short-header paths: each CLI on its 48 frames and its
    # serial stages
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gmc_rates_") as tmp:
        for name in GMC_PATHS:
            _gmc_rates(torch, dev, cli, Path(tmp), name,
                       gmc_path_input(name, gmc_dir.name))
    gmc_dir.cleanup()
    torch.cuda.empty_cache()
    # 6. the mjpeg path: its CLI on 48 frames and its serial stages
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mjpeg_") as tmp:
        _mjpeg_rates(torch, dev, cli, Path(tmp))
    torch.cuda.empty_cache()
    # 6. the mjpegenc path: its CLI on 48 frames and its stages
    _mjpegenc_rates(torch, cli, mjpegenc_dir.name)
    mjpegenc_dir.cleanup()
    torch.cuda.empty_cache()
    # 6. the divxenc path: its CLI on 144 frames and its serial stages
    with tempfile.TemporaryDirectory(prefix="chip_smoke_divxenc_") as tmp:
        _divxenc_rates(torch, dev, cli, Path(tmp))
    torch.cuda.empty_cache()
    # 6. the ogm path: its CLI on the title and its stages
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ogm_") as tmp:
        _ogm_rates(torch, cli, Path(tmp))
    torch.cuda.empty_cache()
    # 6. the capture paths: each CLI on 48 frames and its stages
    _capture_rates(torch, cli, capture_dir.name)
    capture_dir.cleanup()
    torch.cuda.empty_cache()
    # 6. the Theora paths: each CLI on 32 frames and its stages
    _theora_rates(torch, cli, theora_dir.name)
    theora_dir.cleanup()
    torch.cuda.empty_cache()

    # each kernel's launches in the run of the path that carries it
    for name, (src, _) in KERNELS.items():
        if name in FORMS_422:
            launches[name] = path_launches["mpeg422"][FORMS_422[name]]
        elif name in ("mpeg2_recon", "mpeg2_idct_intra"):
            launches[name] = path_launches["dvd"][name]
        elif name in ENCODE_KERNELS:
            launches[name] = path_launches["dvdauthor"][name]
        elif name in ("mpeg4_recon", "mpeg4_idct_intra"):
            launches[name] = path_launches["divx"][name]
        elif name == "mpeg4_recon_qpel":
            launches[name] = path_launches["divx_qpel"][name]
        elif name == "mpeg4_recon_field":
            launches[name] = path_launches["divx_il"][name]
        elif name == "mpeg4_gmc_warp":
            launches[name] = path_launches["divx_gmc"][name]
        elif name in MPEG4ENC_KERNELS:
            launches[name] = path_launches["divxenc"][name]
        elif name in _JPEG_WRAPPERS:
            launches[name] = path_launches["mjpeg"][name]
        elif name in _JPEGENC_WRAPPERS:
            launches[name] = path_launches["mjpegenc"][name]
        elif name in THEORA_WRAPPERS:
            owner = "ogv_dec" if name in ("theora_recon",
                                          "theora_loop_filter") else "ogv"
            launches[name] = path_launches[owner][name]
        elif name in CAPTURE_WRAPPERS:
            owner = {"dv_idct": "dv", "dv_fdct_cost": "dvenc",
                     "rtjpeg_idct": "nuv", "rtjpeg_fdct_quant": "nuvrtj"}
            launches[name] = path_launches[owner[name]][name]
        elif name not in MAIN_KERNELS:
            owner = next(p for p, spec in (*PATHS.items(),
                                           *CLEAN_PATHS.items(),
                                           *OVERLAY_PATHS.items())
                         if name in spec["kernels"])
            launches[name] = path_launches[owner][name]
    emit(phase="launches", path="dvdrip", launches={
        k: path_launches["dvdrip"][k] for k in RIP_KERNELS})
    emit(phase="launches", path="ts1080", launches={
        k: path_launches["ts1080"][k] for k in TS1080_KERNELS})
    emit(phase="launches", path="dvdauthor", launches={
        k: path_launches["dvdauthor"][k] for k in AUTHOR_KERNELS})
    emit(phase="launches", path="mpeg422", launches={
        run: {k: m422[run][k] for k in names}
        for run, names in MPEG422_KERNELS.items()})
    emit(phase="launches", path="divx", launches={
        k: path_launches["divx"][k] for k in AVI_KERNELS})
    for name, spec in (*ASP_PATHS.items(), *GMC_PATHS.items()):
        emit(phase="launches", path=name, launches={
            k: path_launches[name][k] for k in spec[3]})
    emit(phase="launches", path="divxenc", launches={
        k: path_launches["divxenc"][k] for k in DIVXENC_KERNELS})
    emit(phase="launches", path="mjpeg", launches={
        k: path_launches["mjpeg"][k] for k in MJPEG_KERNELS})
    emit(phase="launches", path="mjpegenc", launches={
        k: path_launches["mjpegenc"][k] for k in MJPEGENC_KERNELS})
    emit(phase="launches", path="ogm", launches={
        k: path_launches["ogm"][k] for k in OGM_KERNELS})
    emit(phase="launches", path="flagship", launches={
        k: path_launches["flagship"][k] for k in FLAGSHIP_KERNELS})
    for name, names in (("dv", DV_KERNELS), ("dvenc", DVENC_KERNELS),
                        ("nuv", NUV_KERNELS), ("nuvrtj", NUVRTJ_KERNELS),
                        ("ogv", OGV_KERNELS), ("ogv_dec", OGV_DEC_KERNELS)):
        emit(phase="launches", path=name, launches={
            k: path_launches[name][k] for k in names})
    if bench.parent:
        emit(phase="parent_summary", per_batch=bench.versus_sums)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         **bench.summary(name)}
        for name, (source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _read_y4m(reader_cls, path):
    with reader_cls(str(path)) as r:
        return r.read_batch(1 << 30)


def _plain_chain(torch, dev, planes, hq, video, zoom, kernels):
    """The main path composed from the plain torch versions only, on the
    card: deinterlace, zoom, then hqdn3d with FrameAnt carried."""
    ls, lt, cs, ct = hq.luts(dev)

    def zoom_ref(p, nw, nh):
        h, w = p.shape[-2:]
        p = kernels.zoom_pass_ref(p, zoom._device_band(
            w, nw, "lanczos3", str(dev)), -1)
        return kernels.zoom_pass_ref(p, zoom._device_band(
            h, nh, "lanczos3", str(dev)), -2)

    outs = [[], [], []]
    ants = [None, None, None]
    n = planes[0].shape[0]
    for b0 in range(0, n, MAIN_BATCH):
        y, u, v = (torch.from_numpy(p[b0:b0 + MAIN_BATCH]).to(dev)
                   for p in planes)
        y = video.deint_linear_blend(y)
        batch = (zoom_ref(y, 1280, 720), zoom_ref(u, 640, 360),
                 zoom_ref(v, 640, 360))
        for k, (p, sp, tp) in enumerate(zip(batch, (ls, cs, cs),
                                            (lt, ct, ct))):
            ant = ants[k] if ants[k] is not None else \
                p[0].to(torch.int32) << 8
            hp = kernels.spatial_scan_ref(p, sp, -1)
            vp = kernels.spatial_scan_ref(hp, sp, -2)
            o, ants[k] = kernels.temporal_scan_ref(vp, ant, tp)
            outs[k].append(o)
    return [torch.cat(o) for o in outs]


def _chain_fps(torch, dev, spec, warmup: int = 2, timed_batches: int = 8):
    """Frames/s of VideoChain on batches already on the card: CUDA
    events around ``timed_batches`` distinct batches after ``warmup``
    ones, with every filter's carry kept throughout.  The chain is the
    job the CLI builds from the path's arguments (``spec["args"]``) at
    its geometry and rate; the batches are uniform noise, on which these
    chains do the same work as on any content, or with
    ``chain_on_content`` the path's own content (the clean-up filters'
    gates and scene tests take one branch on noise).

    Beside it, the host's time to queue those batches (taken before the
    synchronize: near the device time when the host holds the chain
    back, below it when the device does), the step's peak device memory
    above its inputs, and from one more pass over the same batches under
    torch.profiler, the device's busy share and its kernel time by
    name."""
    from tcforge_tpu_torch import cli
    from tcforge_tpu_torch.core.formats import ImageFormat
    from tcforge_tpu_torch.pipeline.chain import VideoChain

    job = cli.args_to_job(cli.build_parser().parse_args(
        ["-i", "-", "-o", "-", *spec["args"], "--batch", str(MAIN_BATCH)]))
    job.im_v_width, job.im_v_height = spec["w"], spec["h"]
    job.fps = spec["fps"][0] / spec["fps"][1]
    chain = VideoChain(job, ImageFormat.YUV420P, spec["w"], spec["h"])
    batches = (_content_batches(torch, dev, spec, warmup + timed_batches)
               if spec.get("chain_on_content") else
               _noise_batches(torch, dev, spec["w"], spec["h"],
                              warmup + timed_batches))
    return _timed_batches(torch, chain, chain.initial_states(dev), batches,
                          warmup)


def _cli_rates(torch, dev, cli, tmp, name, spec, parent=None):
    """The path's CLI on the card over ENGINE_FRAMES frames of its
    content (ten batches), wall clock to the last byte written, after
    one untimed run of each CLI: twice, or with ``parent`` in turns with
    the parent's CLI on the same file (parent, this, this, parent); then
    the serial stages of the same job (``engine_stages``)."""
    src, out = tmp / f"cli_{name}.y4m", tmp / f"cli_{name}_out.y4m"
    write_input(spec, src, ENGINE_FRAMES, seed=6)
    argv = ["-i", str(src), "-o", str(out), *spec["args"], "--batch",
            str(MAIN_BATCH), "--device", "cuda", "--progress_off", "-q"]

    def rate(main):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"{name}: CLI exit code {rc}")
        return ENGINE_FRAMES / seconds

    def parent_rate():
        with parent.active():
            return rate(parent.cli.main)

    rate(cli.main)
    if parent is None:
        fps, parent_fps = [rate(cli.main), rate(cli.main)], None
    else:
        parent_rate()           # the parent's first run builds its kernels
        p1 = parent_rate()
        fps = [rate(cli.main), rate(cli.main)]
        parent_fps = [p1, parent_rate()]
    stages = engine_stages(torch, dev, cli, src, out, spec["args"])
    emit(phase="cli", path=name, frames=ENGINE_FRAMES, fps=fps,
         parent_fps=parent_fps, serial_stages=stages)
    src.unlink()


def _noise_batches(torch, dev, width: int, height: int, count: int):
    """``count`` seeded YUV420P batches of uniform noise on the card."""
    from tcforge_tpu_torch.core.formats import ImageFormat
    from tcforge_tpu_torch.core.frame import FrameBatch
    gen = torch.Generator(device=dev).manual_seed(11)

    def plane(h, w):
        return torch.randint(0, 256, (MAIN_BATCH, h, w), generator=gen,
                             dtype=torch.uint8, device=dev)

    return [FrameBatch(
        format=ImageFormat.YUV420P, y=plane(height, width),
        u=plane(height // 2, width // 2), v=plane(height // 2, width // 2),
        attrs=torch.zeros(MAIN_BATCH, dtype=torch.int32, device=dev),
        frame_ids=torch.arange(k * MAIN_BATCH, (k + 1) * MAIN_BATCH,
                               dtype=torch.int32, device=dev),
        fps=25.0) for k in range(count)]


def _content_batches(torch, dev, spec, count: int):
    """``count`` batches of the path's own content (``write_input``,
    seed 8) on the card, frame ids running on."""
    from tcforge_tpu_torch.core.frame import FrameBatch
    from tcforge_tpu_torch.io.y4m import Y4MReader
    with tempfile.TemporaryDirectory(prefix="chip_smoke_content_") as tmp:
        path = Path(tmp) / "content.y4m"
        write_input(spec, path, count * MAIN_BATCH, seed=8)
        with Y4MReader(str(path)) as r:
            return [FrameBatch.from_numpy(
                *r.read_batch(MAIN_BATCH), device=dev, fps=25.0,
                first_id=k * MAIN_BATCH) for k in range(count)]


def _timed_batches(torch, step, states, batches, warmup: int):
    """``step(batch, states) -> (out, states)`` over ``batches``: the
    first ``warmup`` untimed, the rest between CUDA events, then once
    more under torch.profiler (see ``_chain_fps``)."""
    timed_batches = len(batches) - warmup
    for fb in batches[:warmup]:
        _, states = step(fb, states)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for fb in batches[warmup:]:
        out, states = step(fb, states)
    end.record()
    queue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    dev_ms = start.elapsed_time(end)
    step_peak_mb = (torch.cuda.max_memory_allocated() - resident) / 1e6
    frames = MAIN_BATCH * timed_batches

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fb in batches[warmup:]:
            _, states = step(fb, states)
        torch.cuda.synchronize()
    busy = _device_busy(prof, timed_batches)
    if busy["busy_ms_per_batch"] is not None:
        # the traced kernels' time over the untraced run's: the profiler
        # slows the host, not the kernels
        busy["busy_share"] = busy["busy_ms_per_batch"] / (
            dev_ms / timed_batches)
    return {"chain_fps": frames / (dev_ms / 1e3),
            "ms_per_batch": dev_ms / timed_batches,
            "queue_ms_per_batch": queue_s * 1e3 / timed_batches,
            "step_peak_mb": step_peak_mb, "frames": frames,
            "out_shape": list(out.y.shape), **busy}


def engine_stages(torch, dev, cli, src, out, argv, batch: int = MAIN_BATCH):
    """The serial engine's five stages for one CLI job on the card, each
    timed alone with the card synchronized after it: Y4M read, copy to
    the card from pageable memory, chain, copy back, Y4M write (every
    frame, no selection).  Returns ms per batch of each stage over the
    whole file, their sum, and the frames/s of the sum and of the slowest
    stage: what a serial engine and a fully overlapped one could reach."""
    from tcforge_tpu_torch.core.frame import FrameBatch
    from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MReader, Y4MWriter
    from tcforge_tpu_torch.pipeline.chain import VideoChain
    job = cli.args_to_job(cli.build_parser().parse_args(
        ["-i", str(src), "-o", str(out), *argv]))
    ms = dict.fromkeys(("read", "to_card", "chain", "to_host", "write"), 0.0)
    frames = batches = 0
    with contextlib.ExitStack() as stack:
        reader = stack.enter_context(Y4MReader(str(src)))
        hdr = reader.header
        job.im_v_width, job.im_v_height, job.fps = (hdr.width, hdr.height,
                                                    hdr.fps)
        chain = VideoChain(job, hdr.format, hdr.width, hdr.height)
        states = chain.initial_states(dev)
        writer = None
        torch.cuda.synchronize()
        while True:
            t0 = time.perf_counter()
            planes = reader.read_batch(batch)
            t1 = time.perf_counter()
            if planes is None:
                break
            fb = FrameBatch.from_numpy(*planes, device=dev, fmt=hdr.format,
                                       fps=job.fps, first_id=frames)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            result, states = chain(fb, states)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            host = result.to_numpy()
            t4 = time.perf_counter()
            if writer is None:
                writer = stack.enter_context(Y4MWriter(str(out), Y4MHeader(
                    width=result.width, height=result.height,
                    format=result.format)))
            writer.write_batch(*host)
            t5 = time.perf_counter()
            for key, a, b in (("read", t0, t1), ("to_card", t1, t2),
                              ("chain", t2, t3), ("to_host", t3, t4),
                              ("write", t4, t5)):
                ms[key] += (b - a) * 1e3
            frames += fb.batch
            batches += 1
    per_batch = {k: v / batches for k, v in ms.items()}
    total = sum(per_batch.values())
    slowest = max(per_batch.values())
    return {"frames": frames, "ms_per_batch": per_batch,
            "sum_ms_per_batch": total,
            "serial_fps": frames / (total * batches / 1e3),
            "overlapped_fps": frames / (slowest * batches / 1e3)}


def cfg1_step(colorspace, zoom, fb):
    """cfg1's step on one YUV420P batch: to RGB24 and back, then each
    plane through the zoom (benches/run_configs.py:118-128)."""
    from tcforge_tpu_torch.core.formats import ImageFormat
    back = colorspace.convert(colorspace.convert(fb, ImageFormat.RGB24),
                              ImageFormat.YUV420P)
    zw, zh = CFG1_ZOOM
    return back.with_planes(y=zoom.zoom_plane(back.y, zw, zh),
                            u=zoom.zoom_plane(back.u, zw // 2, zh // 2),
                            v=zoom.zoom_plane(back.v, zw // 2, zh // 2))


def _run_cfg1(torch, dev, kernels, colorspace, zoom):
    """Phase 4 for cfg1: one seeded batch through ``cfg1_step`` on the
    card, with the counts set to 0 just before and read just after, and
    the same batch through the same code on the CPU (which runs the zoom's
    plain version): equal planes, six zoom launches."""
    from tcforge_tpu_torch.core.formats import ImageFormat
    from tcforge_tpu_torch.core.frame import FrameBatch
    rng = np.random.default_rng(13)
    planes = [rng.integers(0, 256, (MAIN_BATCH, h, w), dtype=np.uint8)
              for h, w in ((CFG1_H, CFG1_W), (CFG1_H // 2, CFG1_W // 2),
                           (CFG1_H // 2, CFG1_W // 2))]
    torch.cuda.synchronize()
    kernels.reset_launches()
    got = cfg1_step(colorspace, zoom, FrameBatch.from_numpy(
        *planes, device=dev, fmt=ImageFormat.YUV420P))
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    want = cfg1_step(colorspace, zoom, FrameBatch.from_numpy(
        *planes, device=torch.device("cpu"), fmt=ImageFormat.YUV420P))
    check(launches["zoom_pass"] == 6 and not any(
        n for k, n in launches.items() if k != "zoom_pass"),
        f"cfg1 launches {launches}")
    check(dict(kernels.launches) == launches,
          "cfg1's CPU run launched a kernel")
    zw, zh = CFG1_ZOOM
    check(tuple(got.y.shape) == (MAIN_BATCH, zh, zw)
          and tuple(got.u.shape) == (MAIN_BATCH, zh // 2, zw // 2),
          f"cfg1 output shapes {got.y.shape} {got.u.shape}")
    err = max(int((g.cpu().int() - w.int()).abs().max())
              for g, w in zip(got.planes, want.planes))
    emit(phase="path", path="cfg1", frames=MAIN_BATCH, launches=launches)
    emit(phase="path_vs_cpu", path="cfg1", max_abs_err=err)
    check(err == 0, f"cfg1 differs from its CPU run (max abs err {err})")


def _cfg1_fps(torch, dev, colorspace, zoom, warmup: int = 2,
              timed_batches: int = 8):
    """``_chain_fps`` for cfg1's step on 640x480 batches."""
    batches = _noise_batches(torch, dev, CFG1_W, CFG1_H,
                             warmup + timed_batches)
    return _timed_batches(
        torch, lambda fb, states: (cfg1_step(colorspace, zoom, fb), states),
        None, batches, warmup)


def _device_busy(prof, batches: int, names=()) -> dict:
    """From a torch.profiler trace, per batch: the window from the
    first device operation's start to the last one's end, the time in
    which a kernel, copy or fill ran, and the device time of the eight
    costliest names and of the rest (None where the trace holds no
    device work); with ``names``, the device time of the operations
    whose name holds each."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    if not ops:
        return {**({"named_ms_per_batch": None} if names else {}),
                "profiled_ms_per_batch": None, "busy_ms_per_batch": None,
                "busy_share": None, "kernels_ms_per_batch": None}
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in ops)
    busy_us, reach = 0.0, spans[0][0]
    for lo, hi in spans:
        if hi > reach:
            busy_us += hi - max(lo, reach)
            reach = hi
    window_us = reach - spans[0][0]
    by_name = {}
    for e in ops:
        name = e["name"][:80]
        by_name[name] = by_name.get(name, 0.0) + float(e["dur"])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    top = dict(ranked[:8])
    top["(the rest)"] = sum(v for _, v in ranked[8:])
    named = {n: sum(float(e["dur"]) for e in ops if n in e["name"]) / 1e3
             / batches for n in names}
    return {**({"named_ms_per_batch": named} if names else {}),
            "profiled_ms_per_batch": window_us / 1e3 / batches,
            "busy_ms_per_batch": busy_us / 1e3 / batches,
            "kernels_ms_per_batch": {k: v / 1e3 / batches
                                     for k, v in top.items()}}


class KernelBench:
    """Phase 3's bookkeeping: seeded inputs on the card, each kernel held
    against its plain version (tolerance 0), timed over a rotation of
    inputs larger than L2, and per kernel the sums over one 16-frame
    batch of the path that carries it."""

    def __init__(self, torch, dev, kernels):
        self.torch, self.dev, self.kernels = torch, dev, kernels
        self.rng = np.random.default_rng(7)
        self.stats = {k: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0,
                          "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0,
                          "library_ms": None} for k in KERNELS}
        self.parent = None
        self.versus_sums = {}

    def u8(self, *shape):
        return self.torch.from_numpy(
            self.rng.integers(0, 256, shape, dtype=np.uint8)).to(self.dev)

    def rotation(self, make):
        """At least 4 distinct argument tuples from ``make``, more than
        the card's 50 MB L2 together, so a timed call finds its inputs
        in device memory as the path's next batch would."""
        first = make()
        size = sum(a.numel() * a.element_size() for a in first
                   if isinstance(a, self.torch.Tensor))
        return [first] + [make() for _ in range(max(3, L2_BYTES // size))]

    def time(self, fn, inputs, reps):
        """Device ms per call of ``fn`` over ``reps`` calls that cycle
        through ``inputs``.  The stream first sleeps long enough for the
        host to queue every call, so the host's time between launches is
        not counted (a short kernel would otherwise time its wrapper)."""
        torch = self.torch
        for args in inputs[:reps]:
            fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(reps * QUEUE_S_PER_CALL * SLEEP_HZ))
        start.record()
        for i in range(reps):
            fn(*inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def check(self, kernel, case, got, want, quiet=False):
        """Max abs err of ``got`` against ``want`` (tensors or tuples of
        them); emits it (unless ``quiet``) and raises unless it is 0."""
        torch = self.torch
        got, want = _flat_tensors(got), _flat_tensors(want)
        check(len(got) == len(want),
              f"{kernel} {case}: {len(got)} outputs against {len(want)}")
        err = 0
        for a, b in zip(got, want):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{kernel} {case}: shape/dtype {tuple(a.shape)} {a.dtype} "
                  f"vs {tuple(b.shape)} {b.dtype}")
            if a.numel():
                err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                                   .abs().max()))
        if not quiet:
            emit(phase="kernel_check", kernel=kernel, case=case,
                 max_abs_err=err)
        check(err == 0, f"{kernel} {case} differs from its plain version "
                        f"(max abs err {err})")
        s = self.stats[kernel]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        return err

    def record(self, kernel, case, per_batch, fn, ref, inputs, nbytes, ops,
               library=None, reps=20, plain_reps=1, library_reps=5,
               ops_per_s=INT32_OPS_PER_S):
        """Check ``fn`` against ``ref`` on the first input and time both,
        and ``library`` (a call and its own inputs) where one PyTorch call
        computes the same function.  ``nbytes`` and ``ops``: what one call
        must move and compute, for its bound, the operations at
        ``ops_per_s``.  ``per_batch``: launches of this case in one
        16-frame batch of the kernel's path (0: a check off the path, not
        in the sums)."""
        err = self.check(kernel, case, fn(*inputs[0]), ref(*inputs[0]))
        ms = self.time(fn, inputs, reps)
        plain_ms = self.time(ref, inputs, plain_reps)
        lib_ms = self.time(*library, library_reps) if library else None
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ops_per_s * 1e3
        emit(phase="kernel", kernel=kernel, case=case, max_abs_err=err,
             ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
             per_batch=per_batch)
        s = self.stats[kernel]
        s["ms"] += ms * per_batch
        s["plain_ms"] += plain_ms * per_batch
        s["bytes_ms"] += bytes_ms * per_batch
        s["ops_ms"] += ops_ms * per_batch
        s["bound_ms"] += max(bytes_ms, ops_ms) * per_batch
        if lib_ms is not None and per_batch:
            s["library_ms"] = (s["library_ms"] or 0.0) + lib_ms * per_batch

    def versus(self, kernel, case, per_batch, fn, parent_fn, inputs,
               parent_inputs, reps=20):
        """This tree's ``fn`` and the parent's ``parent_fn`` on the same
        inputs (``parent_inputs[i]`` holds ``inputs[i]`` in the form the
        parent's kernel takes): equal outputs, then timed in turns
        (parent, this, this, parent); per-batch sums kept by kernel."""
        self.check(kernel, f"{case} vs parent", fn(*inputs[0]),
                   parent_fn(*parent_inputs[0]))
        p1 = self.time(parent_fn, parent_inputs, reps)
        c1 = self.time(fn, inputs, reps)
        c2 = self.time(fn, inputs, reps)
        p2 = self.time(parent_fn, parent_inputs, reps)
        emit(phase="versus_parent", kernel=kernel, case=case,
             per_batch=per_batch, ms=[c1, c2], parent_ms=[p1, p2])
        sums = self.versus_sums.setdefault(
            kernel, {"ms": [0.0, 0.0], "parent_ms": [0.0, 0.0]})
        for key, pair in (("ms", (c1, c2)), ("parent_ms", (p1, p2))):
            for i, t in enumerate(pair):
                sums[key][i] += t * per_batch

    def summary(self, kernel):
        s = self.stats[kernel]
        return {"max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": ("bytes" if s["bytes_ms"] >= s["ops_ms"]
                             else "operations"),
                "library_ms": s["library_ms"]}


class ParentPackage:
    """An earlier checkout's ``tcforge_tpu_torch``: its kernel wrappers
    (``ops/kernels.py``) and its CLI, imported under their own module
    objects.  DIR's package is in ``sys.modules`` only while it imports
    and while ``active()`` holds, so its code keeps its own modules: at
    first use its wrappers build DIR's ``csrc`` into DIR's ``_build``
    and call DIR's C interfaces, and its CLI runs its own engine.  Any
    checkout whose ``kernels.py`` has ``unsharp_plane(img, sx, sy,
    amount)``, ``temporal_scan``, ``d3_temporal_scan`` and
    ``tomsmocomp_plane`` with this tree's signatures will do: every
    commit since the TomsMoComp and denoise3d ports (0713932)."""

    PKG = "tcforge_tpu_torch"
    MODULES = ("ops.kernels", "cli", "pipeline.engine")
    TEMPORAL = {"hqdn3d_temporal_scan": "temporal_scan",
                "d3_temporal_scan": "d3_temporal_scan"}

    def __init__(self, root: Path):
        import importlib
        root = root.resolve()
        sys.path.insert(0, str(root))
        try:
            with self._swapped({}):
                for name in self.MODULES:
                    importlib.import_module(f"{self.PKG}.{name}")
                self.modules = {k: m for k, m in sys.modules.items()
                                if self._ours(k)}
        finally:
            sys.path.remove(str(root))
        self.kernels = self.modules[self.PKG + ".ops.kernels"]
        self.cli = self.modules[self.PKG + ".cli"]
        check(Path(self.kernels.__file__).resolve().is_relative_to(root),
              f"{root} holds no {self.PKG}")

    @classmethod
    def _ours(cls, name: str) -> bool:
        return name == cls.PKG or name.startswith(cls.PKG + ".")

    @classmethod
    @contextlib.contextmanager
    def _swapped(cls, modules):
        """The package's entries of ``sys.modules`` replaced by
        ``modules`` while the block runs."""
        saved = {k: m for k, m in sys.modules.items() if cls._ours(k)}
        for k in saved:
            del sys.modules[k]
        sys.modules.update(modules)
        try:
            yield
        finally:
            for k in [k for k in sys.modules if cls._ours(k)]:
                del sys.modules[k]
            sys.modules.update(saved)

    def active(self):
        """The parent's modules in ``sys.modules``: its code's imports
        inside functions find its own package."""
        return self._swapped(self.modules)

    def temporal(self, name):
        return getattr(self.kernels, self.TEMPORAL[name])

    def unsharp(self, img, sx, sy, amount):
        return self.kernels.unsharp_plane(img, sx, sy, amount)

    def tomsmocomp(self, window, parity, effort):
        return self.kernels.tomsmocomp_plane(window[1:-1], window[:-2],
                                             window[2:], parity, effort)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _flat_tensors(x) -> list:
    """The tensors of a kernel's arguments or outputs, nested tuples and
    lists flattened, None and other values left out."""
    if hasattr(x, "data_ptr"):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for e in x for t in _flat_tensors(e)]
    return []


def _check_main_kernels(torch, kernels, zoom, hq, bench):
    """Phase 3 for the main path's kernels: the hqdn3d scans at 720p and
    the zoom passes 1080 -> 720, per plane."""
    dev = bench.dev
    ls, lt, cs, ct = hq.luts(dev)
    # "ms" sums the launches of one 16-frame batch: u and v count twice
    for plane, (n, h, w), sp, tp, per_batch in (
            ("y", (16, 720, 1280), ls, lt, 1),
            ("u/v", (16, 360, 640), cs, ct, 2)):
        numel = n * h * w
        lut_bytes = _nbytes(sp)
        hin = bench.rotation(lambda: (bench.u8(n, h, w), sp, -1))
        bench.record("hqdn3d_spatial_scan", f"{plane} H {(n, h, w)}",
                     per_batch, kernels.spatial_scan, kernels.spatial_scan_ref,
                     hin, numel * 5 + lut_bytes,
                     numel * SCAN_OPS["hqdn3d_spatial_scan"])
        vin = [(kernels.spatial_scan(x, sp, -1), sp, -2) for x, _, _ in hin]
        del hin
        bench.record("hqdn3d_spatial_scan", f"{plane} V {(n, h, w)}",
                     per_batch, kernels.spatial_scan, kernels.spatial_scan_ref,
                     vin, numel * 8 + lut_bytes,
                     numel * SCAN_OPS["hqdn3d_spatial_scan"])
        vs = [kernels.spatial_scan(x, sp, -2) for x, _, _ in vin]
        del vin
        # two consecutive batches: the FrameAnt carry crosses them
        ant0 = (vs[0][0] >> 16) << 8
        o1, a1 = kernels.temporal_scan(vs[0], ant0, tp)
        o2, a2 = kernels.temporal_scan(vs[1], a1, tp)
        r1, b1 = kernels.temporal_scan_ref(vs[0], ant0, tp)
        r2, b2 = kernels.temporal_scan_ref(vs[1], b1, tp)
        bench.check("hqdn3d_temporal_scan", f"{plane} 2 batches {(n, h, w)}",
                    (o1, a1, o2, a2), (r1, b1, r2, b2))
        del o1, a1, o2, a2, r1, b1, r2, b2
        # timed as the path feeds it: V-pass outputs, each with the
        # FrameAnt the scan of the one before left (the lookups' spread
        # over the table, and so over the banks, depends on both)
        tin = _carried(kernels.temporal_scan, vs, ant0, tp)
        del vs
        _record_temporal(bench, kernels, "hqdn3d_temporal_scan", plane,
                         per_batch, kernels.temporal_scan,
                         kernels.temporal_scan_ref, tin)
        del tin

    # the main path's passes, then cfg1's (not in the main path's sums)
    for plane, (h, w), (nh, nw), per_batch in (
            ("y", (1080, 1920), (720, 1280), 1),
            ("u/v", (540, 960), (360, 640), 2),
            ("cfg1 y", (CFG1_H, CFG1_W), CFG1_ZOOM[::-1], 0),
            ("cfg1 u/v", (CFG1_H // 2, CFG1_W // 2),
             (CFG1_ZOOM[1] // 2, CFG1_ZOOM[0] // 2), 0)):
        src_shape = (16, h, w)
        for axis, old, new, name in ((-1, w, nw, "H"), (-2, h, nh, "V")):
            band = zoom._device_band(old, new, "lanczos3", str(dev))
            if axis == -1:
                ins = bench.rotation(lambda: (bench.u8(*src_shape), band, -1))
            else:
                hband = zoom._device_band(w, nw, "lanczos3", str(dev))
                ins = bench.rotation(lambda: (kernels.zoom_pass(
                    bench.u8(16, h, w), hband, -1), band, -2))
            src = ins[0][0]
            out_shape = list(src.shape)
            out_shape[axis] = new
            lines = src.numel() // old
            outputs = lines * new
            dense = torch.from_numpy(zoom.contrib_matrix(old, new, "lanczos3")
                                     ).to(dev, torch.float32)
            if axis == -1:
                dense_t = dense.T.contiguous()
                lib = (lambda x: torch.matmul(x, dense_t),
                       bench.rotation(lambda: (bench.u8(*src.shape).reshape(
                           -1, old).to(torch.float32),)))
            else:
                lib = (lambda x: torch.matmul(dense, x),
                       bench.rotation(lambda: (bench.u8(*src.shape).to(
                           torch.float32),)))
            bench.record("zoom_pass", f"{plane} {name} {tuple(src.shape)}->"
                                      f"{tuple(out_shape)}", per_batch,
                         kernels.zoom_pass, kernels.zoom_pass_ref, ins,
                         src.numel() + outputs,
                         int(band.taps.sum()) * lines + 4 * outputs,
                         library=lib, plain_reps=3)
            del ins, lib


def _carried(scan, vs, carry, lut):
    """(v, carry, lut) per V-pass output of ``vs``, the carry of each
    the one that ``scan`` left after the one before, as in the path."""
    tin = []
    for v in vs:
        tin.append((v, carry, lut))
        carry = scan(v, carry, lut)[1]
    return tin


def _record_temporal(bench, kernels, name, plane, per_batch, fn, ref, tin):
    """Phase 3's timing of a temporal scan on ``tin`` (v, carry, lut),
    and beside the parent's kernel where one was built."""
    v, carry, lut = tin[0]
    n, h, w = v.shape
    numel = n * h * w
    case = f"{plane} {(n, h, w)}"
    bench.record(name, case, per_batch, fn, ref, tin,
                 numel * 5 + h * w * 8 + _nbytes(lut),
                 numel * SCAN_OPS[name], plain_reps=3)
    if bench.parent:
        bench.versus(name, case, per_batch, fn,
                     bench.parent.temporal(name), tin, tin)


def _check_slice_kernels(torch, kernels, bench):
    """Phase 3 for unsharp, TomsMoComp and the denoise3d scans."""
    from tcforge_tpu_torch.modules.filters.denoise3d import precalc_coefs
    import torch.nn.functional as F

    dev = bench.dev
    # unsharp: cfg2's luma (7x5, 0.8; chroma amount 0 launches nothing)
    # through the register kernel, the tiled kernel on the same inputs,
    # and 17x15 where the uint32 sums wrap.  The library call is the
    # blur's sum alone: conv2d of the replicate-padded float32 plane with
    # the binomial, exact below 2^24 (7x5: 255 * 2^10).
    for (n, h, w), (mx, my, am), per_batch in (
            ((16, 720, 1280), (7, 5, 0.8), 1),
            ((4, 360, 640), (17, 15, -1.5), 0)):
        sx, sy = mx // 2, my // 2
        ins = bench.rotation(lambda: (bench.u8(n, h, w), sx, sy, am))
        binom = torch.tensor([[math.comb(2 * sy, i) * math.comb(2 * sx, j)
                               for j in range(2 * sx + 1)]
                              for i in range(2 * sy + 1)],
                             dtype=torch.float32, device=dev)[None, None]
        lib = (lambda x: F.conv2d(x, binom), bench.rotation(lambda: (F.pad(
            bench.u8(n, 1, h, w).to(torch.float32), (sx, sx, sy, sy),
            mode="replicate"),))) if per_batch else None
        numel = n * h * w
        bench.record("unsharp", f"{mx}x{my} {am} {(n, h, w)}", per_batch,
                     kernels.unsharp_plane, kernels.unsharp_plane_ref, ins,
                     2 * numel, numel * (2 * sx + 2 * sy + UNSHARP_OPS),
                     library=lib, plain_reps=3)
        if per_batch:
            case = f"{mx}x{my} {am} {(n, h, w)}"
            def tiled(*a):
                return kernels.unsharp_plane(*a, tiled=True)
            bench.check("unsharp", case + " tiled kernel", tiled(*ins[0]),
                        kernels.unsharp_plane(*ins[0]))
            emit(phase="kernel", kernel="unsharp",
                 case=case + " tiled kernel", per_batch=0,
                 ms=bench.time(tiled, ins, 20))
            if bench.parent:
                bench.versus("unsharp", case, per_batch,
                             kernels.unsharp_plane, bench.parent.unsharp,
                             ins, ins)
        del ins, lib

    # TomsMoComp through the window form, as cfg4's filter calls it:
    # cfg4 (effort 5, topfirst -> parity 0) per plane; the other parity,
    # effort 15 and the plane form (three tensors) off the path
    for (n, h, w), effort, parity, per_batch, fn in (
            ((16, 1080, 1920), 5, 0, 1, kernels.tomsmocomp_window),
            ((16, 540, 960), 5, 0, 2, kernels.tomsmocomp_window),
            ((16, 1080, 1920), 5, 1, 0, kernels.tomsmocomp_window),
            ((16, 540, 960), 5, 1, 0, kernels.tomsmocomp_window),
            ((4, 1080, 1920), 15, 0, 0, kernels.tomsmocomp_window),
            ((16, 1080, 1920), 5, 0, 0, kernels.tomsmocomp_plane)):
        if fn is kernels.tomsmocomp_plane:
            def make():
                window = bench.u8(n + 2, h, w)
                return (window[1:-1], window[:-2], window[2:], parity,
                        effort)
            ref, form = kernels.tomsmocomp_plane_ref, "plane form"
        else:
            def make():
                return (bench.u8(2, h, w), bench.u8(n, h, w), parity, effort)
            ref, form = kernels.tomsmocomp_window_ref, "window"
        ins = bench.rotation(make)
        synth_rows = sum(1 for r in range(1, h - 1) if r % 2 != parity)
        candidates = len(kernels.tmc_offsets(effort)) + 1
        case = f"{form} effort {effort} parity {parity} {(n, h, w)}"
        bench.record("tomsmocomp", case, per_batch, fn, ref,
                     ins, (2 * n + 2) * h * w,
                     n * synth_rows * -(-w // 4) * (
                         TMC_OPS_PER_CANDIDATE * candidates + TMC_OPS),
                     plain_reps=3)
        if bench.parent and per_batch:
            # the parent's filter built the window with cat before its
            # kernel; the cat is not timed here
            bench.versus("tomsmocomp", case, per_batch, fn,
                         bench.parent.tomsmocomp, ins,
                         [(torch.cat([st, b]), par, eff)
                          for st, b, par, eff in ins])
        del ins

    # denoise3d at its defaults: luma 4/6, chroma 3/4
    for plane, (n, h, w), (s, t), per_batch in (
            ("y", (16, 720, 1280), (4.0, 6.0), 1),
            ("u/v", (16, 360, 640), (3.0, 4.0), 2)):
        sp = torch.from_numpy(precalc_coefs(s)).to(dev)
        tp = torch.from_numpy(precalc_coefs(t)).to(dev)
        numel = n * h * w
        hin = bench.rotation(lambda: (bench.u8(n, h, w), sp, -1))
        bench.record("d3_spatial_scan", f"{plane} H {(n, h, w)}", per_batch,
                     kernels.d3_spatial_scan, kernels.d3_spatial_scan_ref,
                     hin, numel * 5 + _nbytes(sp),
                     numel * SCAN_OPS["d3_spatial_scan"])
        vin = [(kernels.d3_spatial_scan(x, sp, -1), sp, -2) for x, _, _ in hin]
        del hin
        bench.record("d3_spatial_scan", f"{plane} V {(n, h, w)}", per_batch,
                     kernels.d3_spatial_scan, kernels.d3_spatial_scan_ref,
                     vin, numel * 8 + _nbytes(sp),
                     numel * SCAN_OPS["d3_spatial_scan"])
        vs = [kernels.d3_spatial_scan(x, sp, -2) for x, _, _ in vin]
        del vin
        # two consecutive batches: the previous-output carry crosses them
        prev0 = torch.zeros((h, w), dtype=torch.int32, device=dev)
        o1, p1 = kernels.d3_temporal_scan(vs[0], prev0, tp)
        o2, p2 = kernels.d3_temporal_scan(vs[1], p1, tp)
        r1, q1 = kernels.d3_temporal_scan_ref(vs[0], prev0, tp)
        r2, q2 = kernels.d3_temporal_scan_ref(vs[1], q1, tp)
        bench.check("d3_temporal_scan", f"{plane} 2 batches {(n, h, w)}",
                    (o1, p1, o2, p2), (r1, q1, r2, q2))
        del o1, p1, o2, p2, r1, q1, r2, q2
        # timed as the path feeds it: V-pass outputs, each with the
        # previous output the scan of the one before left
        tin = _carried(kernels.d3_temporal_scan, vs, prev0, tp)
        del vs
        _record_temporal(bench, kernels, "d3_temporal_scan", plane,
                         per_batch, kernels.d3_temporal_scan,
                         kernels.d3_temporal_scan_ref, tin)
        del tin


def _check_yuvdenoise_chroma(torch, kernels, bench):
    """Phase 3 for yuvdenoise's chroma correction: U and V of a 720x480
    frame (dvdclean's shape, one launch a frame), timed, then odd and
    even widths, heights 2, 3, 120 (a field) and 240, at thresholds 0
    and 5 (the default).  No PyTorch call computes the row recurrence."""
    dev = bench.dev

    def planes(p, h2, w2, threshold=5):
        ref = torch.from_numpy(bench.rng.integers(
            16, 241, (p, h2, w2), dtype=np.int32)).to(dev)
        noise = torch.from_numpy(bench.rng.integers(
            -20, 21, (p, h2, w2), dtype=np.int32)).to(dev)
        return ref, (ref + noise).clamp_(0, 255), threshold

    n = 2 * 240 * 360
    bench.record("yuvdenoise_chroma", "720x480 U+V", MAIN_BATCH,
                 kernels.yuvdenoise_chroma, kernels.yuvdenoise_chroma_ref,
                 bench.rotation(lambda: planes(2, 240, 360)),
                 nbytes=3 * 4 * n, ops=YD_CHROMA_OPS * n)
    cases = 0
    for p, h2, w2 in ((2, 2, 7), (2, 3, 8), (1, 3, 1), (2, 120, 360),
                      (1, 240, 361), (2, 240, 33)):
        for threshold in (0, 5):
            args = planes(p, h2, w2, threshold)
            bench.check("yuvdenoise_chroma", f"{p}x{h2}x{w2} T={threshold}",
                        kernels.yuvdenoise_chroma(*args),
                        kernels.yuvdenoise_chroma_ref(*args), quiet=True)
            cases += 1
    emit(phase="kernel_sweep", kernel="yuvdenoise_chroma", cases=cases,
         max_abs_err=0)


def _busy_ms(torch, fn, calls: int) -> float:
    """The device's busy ms per call of ``fn`` over ``calls`` calls, from
    a torch.profiler trace (the union of its kernels' spans: host time
    between them is not counted)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return _device_busy(prof, calls)["busy_ms_per_batch"]


def _dvdclean_split(torch, dev, kernels, spec, batches: int = 4):
    """Where dvdclean's device time goes, per 16-frame batch of its
    content: the whole chain, yuvdenoise alone, its block search (16
    calls of ``mc_search`` on 720x480 luma) and its chroma kernel (16
    launches on U and V), and pp alone; device busy ms from
    torch.profiler, each piece on its own."""
    from tcforge_tpu_torch import cli
    from tcforge_tpu_torch.core.formats import ImageFormat
    from tcforge_tpu_torch.modules.filters import pp as ppf
    from tcforge_tpu_torch.modules.filters import yuvdenoise as ydf
    from tcforge_tpu_torch.pipeline.chain import VideoChain
    data = _content_batches(torch, dev, spec, batches)
    job = cli.args_to_job(cli.build_parser().parse_args(
        ["-i", "-", "-o", "-", *spec["args"]]))
    chain = VideoChain(job, ImageFormat.YUV420P, spec["w"], spec["h"])
    yd = ydf.YuvDenoiseFilter(job, "")
    pp = ppf.PPFilter(job, "de")
    out = {}
    for name, step, init in (
            ("chain", chain, chain.initial_states(dev)),
            ("yuvdenoise", yd.apply, yd.init_state(
                spec["w"], spec["h"], ImageFormat.YUV420P, dev)),
            ("pp", pp.apply, None)):
        carry = {"state": init, "calls": 0}

        def run(step=step, carry=carry):
            fb = data[carry["calls"] % batches]
            _, carry["state"] = step(fb, carry["state"])
            carry["calls"] += 1
        out[f"{name}_busy_ms"] = _busy_ms(torch, run, batches)
    ry = ydf.contrast_plane(data[0].y, 100, ydf.Y_LO, ydf.Y_HI)
    searched = torch.ones((spec["h"] // 8, spec["w"] // 8), dtype=torch.bool,
                          device=dev)

    def search():
        for i in range(MAIN_BATCH):
            ydf.mc_search(ry[i], ry[i - 1], 8, searched)
    out["search_busy_ms"] = _busy_ms(torch, search, 2)
    rc = torch.stack([ydf.contrast_plane(p, 100, ydf.C_LO, ydf.C_HI)
                      for p in (data[0].u, data[0].v)], dim=1)

    def chroma():
        for i in range(MAIN_BATCH):
            kernels.yuvdenoise_chroma(rc[i], rc[i - 1], 5)
    out["chroma_kernel_busy_ms"] = _busy_ms(torch, chroma, 2)
    parts = (out["yuvdenoise_busy_ms"], out["search_busy_ms"],
             out["chroma_kernel_busy_ms"])
    out["yuvdenoise_rest_busy_ms"] = (None if None in parts
                                      else parts[0] - parts[1] - parts[2])
    return out


def _check_ragged(torch, kernels, zoom, hq, bench):
    """Phase 3 off the paths: the spatial scans (hqdn3d and denoise3d,
    both axes, uint8 and int32 input) and the zoom pass (up and down;
    box where a plane is too small for a wider filter) at ragged shapes,
    and a band wider than the kernel's unrolled bound (sinc8 1920 ->
    320), each against its plain version, tolerance 0."""
    from tcforge_tpu_torch.modules.filters.denoise3d import precalc_coefs
    dev = bench.dev
    scans = (("hqdn3d_spatial_scan", kernels.spatial_scan,
              kernels.spatial_scan_ref, hq.luts(dev)[0], 16),
             ("d3_spatial_scan", kernels.d3_spatial_scan,
              kernels.d3_spatial_scan_ref,
              torch.from_numpy(precalc_coefs(4.0)).to(dev), 0))
    for shape in RAGGED_SHAPES:
        u8 = bench.u8(*shape)
        for name, fn, ref, lut, shift in scans:
            # int32 input in the step's domain, as the V pass gets it
            i32 = (u8.to(torch.int32) << shift) + (torch.from_numpy(
                bench.rng.integers(0, 1 << shift, shape, dtype=np.int32))
                .to(dev) if shift else 0)
            for x in (u8, i32):
                for axis in (-1, -2):
                    bench.check(name, f"{shape} {x.dtype} axis {axis}",
                                fn(x, lut, axis), ref(x, lut, axis))
        for axis in (-1, -2):
            old = shape[axis]
            for new in (old * 3 // 2 + 1, max(1, old * 2 // 3)):
                filters = (("box",) if min(old, new) < 4
                           else ("lanczos3", "sinc8"))
                for filt in filters:
                    band = zoom._device_band(old, new, filt, str(dev))
                    bench.check("zoom_pass", f"{filt} {shape} axis {axis} "
                                             f"{old}->{new}",
                                kernels.zoom_pass(u8, band, axis),
                                kernels.zoom_pass_ref(u8, band, axis))
    for shape, axis in (((2, 64, 1920), -1), ((2, 1920, 64), -2)):
        band = zoom._device_band(1920, 320, "sinc8", str(dev))
        u8 = bench.u8(*shape)
        bench.check("zoom_pass", f"sinc8 {shape} axis {axis} 1920->320 "
                                 f"({band.weights.shape[1]} taps)",
                    kernels.zoom_pass(u8, band, axis),
                    kernels.zoom_pass_ref(u8, band, axis))
    # a rows pass with more 32-row blocks than a grid's y could hold
    tall = bench.u8(1950, 1080, 16)
    band = zoom._device_band(16, 25, "lanczos3", str(dev))
    bench.check("zoom_pass", "lanczos3 (1950, 1080, 16) axis -1 16->25",
                kernels.zoom_pass(tall, band, -1),
                kernels.zoom_pass_ref(tall, band, -1))


def _check_unsharp_sizes(torch, kernels, bench):
    """Phase 3 off the path for unsharp: every register instance (steps
    0..3 on each axis) through the register kernel and through the tiled
    one, and the matrices of UNSHARP_MATRICES, each over the planes of
    UNSHARP_SHAPES (the second half of them starting one byte off a
    word) with a sharpening and a blurring amount in turn.  One line per
    matrix."""
    small = [(2 * sx + 1, 2 * sy + 1) for sx in range(4) for sy in range(4)
             if sx + sy]
    for mx, my in small + [m for m in UNSHARP_MATRICES if m not in small]:
        sx, sy = mx // 2, my // 2
        cases = 0
        for i, (n, h, w) in enumerate(UNSHARP_SHAPES * 2):
            offset = i // len(UNSHARP_SHAPES)
            img = bench.u8(n * h * w + offset)[offset:].view(n, h, w)
            amount = UNSHARP_AMOUNTS[(i + sx) % 2]
            want = kernels.unsharp_plane_ref(img, sx, sy, amount)
            forms = (False, True) if (mx, my) in small else (False,)
            for tiled in forms:
                bench.check("unsharp", f"{mx}x{my} {amount} {(n, h, w)} "
                                       f"offset {offset} tiled {tiled}",
                            kernels.unsharp_plane(img, sx, sy, amount,
                                                  tiled=tiled),
                            want, quiet=True)
                cases += 1
        emit(phase="kernel_sweep", kernel="unsharp", matrix=f"{mx}x{my}",
             cases=cases, max_abs_err=0)


def _check_tmc_windows(torch, kernels, bench):
    """Phase 3 off the paths for TomsMoComp's window form, each case
    over two batches in a row with the filter's carry of the last two
    window frames between them: every width of TMC_WIDTHS by every
    height of TMC_HEIGHTS at effort 0 and 15, both parities and n of
    TMC_BATCHES; every effort level on a ragged and an aligned plane; a
    batch at an address off 16 bytes.  One line per sweep."""
    from tcforge_tpu_torch.modules.filters.tomsmocomp import window_carry

    def two_batches(h, w, n, parity, effort, offset=0):
        state = bench.u8(2, h, w)
        got, want = [], []
        for _ in range(2):
            batch = bench.u8(n * h * w + offset)[offset:].view(n, h, w)
            got += [kernels.tomsmocomp_window(state, batch, parity, effort)]
            want += [kernels.tomsmocomp_window_ref(state, batch, parity,
                                                   effort)]
            carry = window_carry(state, batch)
            want_carry = torch.cat([state, batch])[-2:]
            got += [carry]
            want += [want_carry]
            state = carry
        bench.check("tomsmocomp", f"window n {n} {(h, w)} parity {parity} "
                                  f"effort {effort} offset {offset}",
                    tuple(got), tuple(want), quiet=True)

    cases = 0
    for w in TMC_WIDTHS:
        for h in TMC_HEIGHTS:
            for effort in (0, 15):
                for parity in (0, 1):
                    for n in TMC_BATCHES:
                        two_batches(h, w, n, parity, effort)
                        cases += 1
    for h, w in ((37, 1277), (66, 1920)):
        for effort in (0, 1, 3, 5, 9, 11, 13, 15):
            for parity in (0, 1):
                two_batches(h, w, 3, parity, effort)
                cases += 1
    two_batches(40, 1920, 3, 0, 15, offset=1)
    emit(phase="kernel_sweep", kernel="tomsmocomp", form="window",
         cases=cases + 1, max_abs_err=0)


def _check_temporal_planes(torch, kernels, hq, bench):
    """Phase 3 off the paths for both temporal scans: the planes of
    TEMPORAL_PLANES (each with its input tensors at its offset),
    TEMPORAL_FRAMES frames, two batches in a row with the carry handed
    over.  One line per kernel."""
    from tcforge_tpu_torch.modules.filters.denoise3d import precalc_coefs
    dev = bench.dev

    def int32(x, offset):
        buf = torch.empty(x.numel() + offset, dtype=torch.int32, device=dev)
        return buf[offset:].view(x.shape).copy_(x)

    def low_bits(shape, bits):
        return torch.from_numpy(bench.rng.integers(
            0, 1 << bits, shape, dtype=np.int32)).to(dev)

    scans = (
        ("hqdn3d_temporal_scan", kernels.temporal_scan,
         kernels.temporal_scan_ref, hq.luts(dev)[1],
         lambda s: (bench.u8(*s).int() << 16) + low_bits(s, 16),
         lambda s: (bench.u8(*s).int() << 8) + low_bits(s, 8)),
        ("d3_temporal_scan", kernels.d3_temporal_scan,
         kernels.d3_temporal_scan_ref,
         torch.from_numpy(precalc_coefs(6.0)).to(dev),
         lambda s: bench.u8(*s).int(), lambda s: bench.u8(*s).int()))
    for name, fn, ref, lut, make_v, make_carry in scans:
        cases = 0
        for h, w, offset in TEMPORAL_PLANES:
            for frames in TEMPORAL_FRAMES:
                carry = want_carry = int32(make_carry((h, w)), offset)
                got, want = [], []
                for _ in range(2):
                    v = int32(make_v((frames, h, w)), offset)
                    out, carry = fn(v, carry, lut)
                    ref_out, want_carry = ref(v, want_carry, lut)
                    got += [out, carry]
                    want += [ref_out, want_carry]
                    carry = int32(carry, offset)
                bench.check(name, f"{(frames, h, w)} offset {offset}",
                            tuple(got), tuple(want), quiet=True)
                cases += 1
        emit(phase="kernel_sweep", kernel=name, cases=cases, max_abs_err=0)


def _scan_steps(torch, kernels, hq, bench):
    """Phase 3's step latency of the spatial scans: the luma H and V
    passes at 720p on 1 and 16 frames of noise and 16 flat frames, in ms
    and ns per step (one sample along a line).  A time per step that
    does not fall with fewer lines in flight is each line's own latency,
    its serial chain's; noise spreads the table lookups over the banks,
    a flat plane sends every lane to one entry."""
    from tcforge_tpu_torch.modules.filters.denoise3d import precalc_coefs
    dev = bench.dev
    scans = (("hqdn3d_spatial_scan", kernels.spatial_scan, hq.luts(dev)[0]),
             ("d3_spatial_scan", kernels.d3_spatial_scan,
              torch.from_numpy(precalc_coefs(4.0)).to(dev)))
    h, w = STEP_SHAPE
    for n, content in ((1, "noise"), (16, "noise"), (16, "flat")):
        def make():
            x = bench.u8(n, h, w)
            if content == "flat":
                x.fill_(int(bench.rng.integers(0, 256)))
            return (x,)
        frames = bench.rotation(make)
        for name, fn, lut in scans:
            hin = [(x, lut, -1) for x, in frames]
            h_ms = bench.time(fn, hin, 20)
            vin = [(fn(*a), lut, -2) for a in hin]
            v_ms = bench.time(fn, vin, 20)
            emit(phase="scan_step", kernel=name, frames=n, content=content,
                 h_ms=h_ms, h_ns_per_step=h_ms * 1e6 / w,
                 v_ms=v_ms, v_ns_per_step=v_ms * 1e6 / h)
            del hin, vin
        del frames


def _run_path(torch, cli, kernels, tmp, name, spec):
    """Phase 4 for one path: its CLI on the card over PATH_FRAMES frames
    of its content, with the counts set to 0 just before and read just
    after (each of its kernels launched), then the same CLI on its plain
    versions: on the card where the path holds kernels, else on the CPU
    in this process, launching none; the same frames out and the same
    bytes.  Returns the path's launch counts."""
    from tcforge_tpu_torch.io.y4m import Y4MReader
    src = tmp / f"in_{name}.y4m"
    out, plain = tmp / f"out_{name}.y4m", tmp / f"plain_{name}.y4m"
    write_input(spec, src, PATH_FRAMES, seed=5)
    argv = ["-i", str(src), *spec["args"], "--batch", str(MAIN_BATCH),
            "--progress_off", "-q"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main([*argv, "-o", str(out), "--device", "cuda"])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(rc == 0, f"{name}: CLI exit code {rc}")
    with Y4MReader(str(out)) as r:
        frames_out = sum(1 for _ in r)
    emit(phase="path", path=name, frames=PATH_FRAMES, seconds=e2e_s,
         e2e_fps=PATH_FRAMES / e2e_s, frames_out=frames_out,
         launches=launches)
    for kernel in spec["kernels"]:
        check(launches[kernel] > 0, f"kernel {kernel} was not launched by "
                                    f"the {name} path")
    check(frames_out == spec["frames_out"],
          f"{name}: {frames_out} frames out, expected {spec['frames_out']}")
    kernels.reset_launches()
    if spec["kernels"]:
        with plain_versions(kernels):
            rc = cli.main([*argv, "-o", str(plain), "--device", "cuda"])
    else:
        rc = cli.main([*argv, "-o", str(plain), "--device", "cpu"])
    check(rc == 0 and not any(kernels.launches.values()),
          f"{name}: the plain run failed or launched a kernel")
    same = out.read_bytes() == plain.read_bytes()
    emit(phase="path_vs_plain" if spec["kernels"] else "path_vs_cpu",
         path=name, identical=same, frames_out=frames_out,
         sha256=sha256_file(out))
    check(same, f"{name} differs from its plain run")
    return launches


def _check_stabilize_kernels(torch, kernels, bench):
    """Phase 3 for the field search and the warp: at the stabilize
    path's shapes (1080p, batch 16, 98 fields of 108 at shakiness 4,
    stepsize 6; the warp's luma and chroma planes at a turn and a zoom),
    timed; then off the path at stepsize 1, 2 and 6, odd sizes, frames
    of 1 to 3 rows, fields at and over the edges, ties placed on
    purpose, and shakiness 10 at 1080p (270-pixel fields, the patch in
    73 KB of shared memory); and every interpolation, with and without
    crop, on ragged planes with pure-translation frames among them.  The
    warp's library call is F.grid_sample (bilinear, the same source
    coordinates), timed only: its borders and rounding differ."""
    import torch.nn.functional as F
    from tcforge_tpu_torch.modules.filters import stabilize as st
    dev = bench.dev
    spec = OVERLAY_PATHS["stabilize"]
    w, h = spec["w"], spec["h"]

    def fields(fw, fh, shakiness=4, stepsize=6):
        m = min(fw, fh) * shakiness // 40
        return (torch.from_numpy(st.init_fields(fw, fh, m, m, stepsize))
                .to(dev), m)

    centers, m = fields(w, h)
    nf = centers.shape[0]
    cands = (2 * m // 6 + 1) ** 2 + 11 ** 2 - 1
    sads = MAIN_BATCH * nf * cands * m * m
    bench.record("stabilize_field_search",
                 f"{nf} fields of {m} px, {cands} candidates, "
                 f"{(MAIN_BATCH, h, w)} ({sads} byte SADs)", 1,
                 kernels.stabilize_field_search,
                 kernels.stabilize_field_search_ref,
                 bench.rotation(lambda: (bench.u8(h, w),
                                         bench.u8(MAIN_BATCH, h, w), centers,
                                         m, m, 6)),
                 (MAIN_BATCH + 1) * h * w + _nbytes(centers)
                 + MAIN_BATCH * nf * 8, sads / SADS_PER_OP, plain_reps=1)
    cases = 0

    def search(prev, frames, c, size, maxshift, stepsize, case):
        nonlocal cases
        bench.check("stabilize_field_search", case,
                    kernels.stabilize_field_search(prev, frames, c, size,
                                                   maxshift, stepsize),
                    kernels.stabilize_field_search_ref(
                        prev, frames, c, size, maxshift, stepsize),
                    quiet=True)
        cases += 1

    for fw, fh in ((96, 64), (53, 37), (41, 25)):
        for stepsize in (1, 2, 6):
            c, mm = fields(fw, fh, 4, stepsize)
            frames = bench.u8(3, fh, fw)
            search(frames[0], frames, c, mm, mm, stepsize,
                   f"{(3, fh, fw)} stepsize {stepsize}")
    edge = torch.tensor([[0, 0], [39, 2], [-2, 1], [45, -4], [20, 1]],
                        dtype=torch.int32, device=dev)
    for rows in (1, 2, 3):
        for stepsize in (1, 2):
            frames = bench.u8(2, rows, 40)
            search(frames[0], frames, edge, 3, 2, stepsize,
                   f"{rows} rows, fields over the edges, stepsize "
                   f"{stepsize}")
    yy, xx = torch.meshgrid(torch.arange(48, device=dev),
                            torch.arange(64, device=dev), indexing="ij")
    tex = ((xx % 4) * 40 + (yy % 4) * 9).to(torch.uint8)
    ties = torch.stack([torch.roll(tex, (1, 2), (0, 1)),
                        torch.full_like(tex, 77)])
    for stepsize in (1, 2, 6):
        c, _ = fields(64, 48, 4, stepsize)
        search(tex, ties, c, 8, 8, stepsize,
               f"ties, stepsize {stepsize}")
    c, mm = fields(w, h, 10)
    frames = bench.u8(2, h, w)
    search(frames[0], frames, c, mm, mm, 6, f"shakiness 10: {mm} px fields")
    emit(phase="kernel_sweep", kernel="stabilize_field_search", cases=cases,
         max_abs_err=0)

    # the warp, as pass 2 calls it: a turn of 0.02 rad and a 3 % zoom
    trans = np.tile(np.array([[3.25, -1.5, 0.02, 3.0]], np.float32),
                    (MAIN_BATCH, 1))
    for plane, (pw, ph), scale, dv, per_batch in (
            ("y", (w, h), 1.0, 16, 1), ("u/v", (w // 2, h // 2), 0.5, 128,
                                        2)):
        fp, ip = (torch.from_numpy(a).to(dev) for a in st.warp_params(
            trans, pw, ph, scale, 0.25 / (180 / np.pi)))
        x_s, y_s = st.source_coords(fp, ph, pw)
        grid = torch.stack([x_s * (2.0 / (pw - 1)) - 1,
                            y_s * (2.0 / (ph - 1)) - 1], dim=-1)
        numel = MAIN_BATCH * ph * pw
        bench.record(
            "transform_warp", f"{plane} bilinear {(MAIN_BATCH, ph, pw)}",
            per_batch, kernels.transform_warp, kernels.transform_warp_ref,
            bench.rotation(lambda: (bench.u8(MAIN_BATCH, ph, pw), fp, ip,
                                    2, 0, dv)),
            2 * numel + _nbytes(fp, ip), WARP_FLOPS * numel,
            library=(lambda x: F.grid_sample(x, grid, mode="bilinear",
                                             align_corners=True),
                     bench.rotation(lambda: (bench.u8(
                         MAIN_BATCH, 1, ph, pw).to(torch.float32),))),
            plain_reps=3, ops_per_s=FP32_OPS_PER_S)
    cases = 0
    for n, ph, pw in ((3, 37, 53), (2, 1, 40), (2, 3, 17), (5, 26, 38)):
        t = np.random.default_rng(n * ph).normal(
            0, [3, 3, 0.05, 4], (n, 4)).astype(np.float32)
        t[::2, 2:] = 0                  # pure translations among them
        for scale in (1.0, 0.5):
            fp, ip = (torch.from_numpy(a).to(dev) for a in st.warp_params(
                t, pw, ph, scale, 0.25 / (180 / np.pi)))
            plane = bench.u8(n, ph, pw)
            for interp in (0, 1, 2, 3, 4):
                for crop in (0, 1):
                    bench.check("transform_warp",
                                f"{(n, ph, pw)} scale {scale} interp "
                                f"{interp} crop {crop}",
                                kernels.transform_warp(plane, fp, ip, interp,
                                                       crop, 16),
                                kernels.transform_warp_ref(
                                    plane, fp, ip, interp, crop, 16),
                                quiet=True)
                    cases += 1
    emit(phase="kernel_sweep", kernel="transform_warp", cases=cases,
         max_abs_err=0)


@contextlib.contextmanager
def captured_log():
    """The lines the port logs at INFO while the block runs."""
    import logging

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    logger = logging.getLogger("tcforge_tpu_torch")
    handler, level = Lines(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield handler.lines
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def _run_stabilize(torch, cli, kernels, tmp):
    """Phase 4 for the two-pass stabilize path: both CLI runs on the
    card over PATH_FRAMES frames of shaky footage, the counts set to 0
    before each and read after (pass 1 launches the field search, pass 2
    the warp and unsharp on all three planes of every batch), then the
    same two runs on the plain versions on the card in the same
    directory: the .trf and both Y4M files byte for byte.  Returns the
    launches of both passes."""
    spec = OVERLAY_PATHS["stabilize"]
    src = tmp / "in_stabilize.y4m"
    write_input(spec, src, PATH_FRAMES, seed=5)
    d = tmp / "stabilize"
    d.mkdir()
    common = ["-i", str(src), "--batch", str(MAIN_BATCH), "--progress_off",
              "-q", "--device", "cuda"]
    runs, total = {}, {}
    for mode in ("kernels", "plain"):
        ctx = plain_versions(kernels) if mode == "plain" else \
            contextlib.nullcontext()
        files, counts = [], []
        with ctx:
            for i, args in enumerate(spec["passes"]):
                out = d / f"pass{i + 1}.y4m"
                torch.cuda.synchronize()
                kernels.reset_launches()
                t0 = time.perf_counter()
                rc = cli.main([*common, "-o", str(out),
                               *overlay_argv(args, d)])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                check(rc == 0, f"stabilize pass {i + 1} ({mode}): CLI exit "
                               f"code {rc}")
                counts.append(dict(kernels.launches))
                files.append(out.read_bytes())
                if mode == "kernels":
                    emit(phase="path", path=f"stabilize pass {i + 1}",
                         frames=PATH_FRAMES, seconds=seconds,
                         e2e_fps=PATH_FRAMES / seconds,
                         launches=counts[-1])
            files.append((d / "shake.trf").read_bytes())
        runs[mode] = files
        if mode == "kernels":
            batches = -(-PATH_FRAMES // MAIN_BATCH)
            check(counts[0]["stabilize_field_search"] == batches,
                  f"stabilize pass 1 launches {counts[0]}")
            check(counts[1]["transform_warp"] == 3 * batches
                  and counts[1]["unsharp"] == 3 * batches,
                  f"stabilize pass 2 launches {counts[1]}")
            total = {k: counts[0][k] + counts[1][k] for k in counts[0]}
        else:
            check(not any(v for c in counts for v in c.values()),
                  f"stabilize's plain runs launched a kernel: {counts}")
    from tcforge_tpu_torch.io.y4m import Y4MReader
    with Y4MReader(str(d / "pass2.y4m")) as r:
        frames_out = sum(1 for _ in r)
    check(frames_out == spec["frames_out"],
          f"stabilize: {frames_out} frames out")
    same = runs["kernels"] == runs["plain"]
    emit(phase="path_vs_plain", path="stabilize", identical=same,
         frames_out=frames_out,
         trf_sha256=hashlib.sha256(runs["kernels"][2]).hexdigest(),
         sha256=hashlib.sha256(runs["kernels"][1]).hexdigest())
    check(same, "stabilize differs from its plain runs (the .trf or a "
                "pass's output)")
    return total


def _run_broadcast(torch, cli, kernels, tmp):
    """Phase 4 for the broadcast path: its CLI on the card over
    PATH_FRAMES frames of telecined film with the station logo, the
    counts set to 0 just before and read just after (the logo's chroma
    zoom), then the same CLI on the CPU: the same bytes and the same
    RESULTS and CONCLUSION lines.  Returns the launches."""
    spec = OVERLAY_PATHS["broadcast"]
    src = tmp / "in_broadcast.y4m"
    write_input(spec, src, PATH_FRAMES, seed=5)
    d = tmp / "broadcast"
    d.mkdir()
    write_overlay_aux(d, logo=spec["logo"])
    argv = ["-i", str(src), *overlay_argv(spec["args"], d), "--batch",
            str(MAIN_BATCH), "--progress_off", "-q"]
    got = {}
    for device in ("cuda", "cpu"):
        out = d / f"out_{device}.y4m"
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with captured_log() as lines:
            rc = cli.main([*argv, "-o", str(out), "--device", device])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"broadcast on {device}: CLI exit code {rc}")
        if device == "cuda":
            launches = dict(kernels.launches)
            emit(phase="path", path="broadcast", frames=PATH_FRAMES,
                 seconds=seconds, e2e_fps=PATH_FRAMES / seconds,
                 launches=launches)
            check(launches["zoom_pass"] == 4,
                  f"broadcast: the logo's chroma zoom launched "
                  f"{launches['zoom_pass']} times, not 4")
        else:
            check(not any(kernels.launches.values()),
                  "broadcast's CPU run launched a kernel")
        results = [x for x in lines if x.startswith("[fieldanalysis]")]
        got[device] = (out.read_bytes(), results)
    same = got["cuda"] == got["cpu"]
    emit(phase="path_vs_cpu", path="broadcast", identical=same,
         sha256=hashlib.sha256(got["cuda"][0]).hexdigest(),
         results=got["cuda"][1])
    check(same and len(got["cuda"][1]) == 5,
          "broadcast differs from its CPU run (output or RESULTS lines)")
    return launches


def _overlay_goldens(cli, tmp):
    """Phase 5 for the two paths: their small cases in a directory of
    their own (the .trf named relatively), against the pinned digests."""
    spec = OVERLAY_PATHS["stabilize"]
    g = spec["golden"]
    d = tmp / "golden_stabilize"
    d.mkdir()
    write_input({**spec, **g}, d / "in.y4m", g["frames"], GOLDEN_SEED)
    common = ["-i", "in.y4m", "--batch", str(g["batch"]), "--progress_off",
              "-q", "--device", "cuda"]
    with contextlib.chdir(d):
        rcs = [cli.main([*common, "-o", out, *args]) for out, args in
               (("pass1.y4m", g["passes"][0]), ("out.y4m", g["passes"][1]))]
    for key, name in (("stabilize.trf", "shake.trf"),
                      ("stabilize", "out.y4m")):
        digest = sha256_file(d / name)
        emit(phase="golden", path=key, sha256=digest,
             pinned=OVERLAY_GOLDEN_SHA256[key])
        check(rcs == [0, 0] and digest == OVERLAY_GOLDEN_SHA256[key],
              f"{key} golden output differs from the JAX-pinned digest")
    spec = OVERLAY_PATHS["broadcast"]
    g = spec["golden"]
    d = tmp / "golden_broadcast"
    d.mkdir()
    write_input({**spec, **g}, d / "in.y4m", GOLDEN_FRAMES, GOLDEN_SEED)
    write_overlay_aux(d, logo=g["logo"])
    rc = cli.main(["-i", str(d / "in.y4m"), "-o", str(d / "out.y4m"),
                   *overlay_argv(g["args"], d), "--batch", str(g["batch"]),
                   "--device", "cuda", "--progress_off", "-q"])
    digest = sha256_file(d / "out.y4m")
    emit(phase="golden", path="broadcast", sha256=digest,
         pinned=OVERLAY_GOLDEN_SHA256["broadcast"])
    check(rc == 0 and digest == OVERLAY_GOLDEN_SHA256["broadcast"],
          "broadcast golden output differs from the JAX-pinned digest")


def _overlay_flag_cases(cli, tmp):
    """OVERLAY_FLAG_CASES: the card's output (and .trf) against the
    CPU's, each in a directory of its own."""
    src = tmp / "overlay_flags_in.y4m"
    write_input(OVERLAY_FLAG_INPUT, src, GOLDEN_FRAMES, GOLDEN_SEED)
    for name in OVERLAY_FLAG_CASES:
        got = {}
        for device in ("cuda", "cpu"):
            d = tmp / f"overlay_{name}_{device}"
            d.mkdir()
            write_overlay_aux(d)
            rc = cli.main(["-i", str(src), "-o", str(d / "out.y4m"),
                           *overlay_argv(OVERLAY_FLAG_CASES[name], d), "--device", device,
                           "--progress_off", "-q"])
            check(rc == 0, f"{name} on {device}: CLI exit code {rc}")
            got[device] = [(d / f).read_bytes().replace(
                str(d).encode(), b"{dir}") for f in
                ("out.y4m", OVERLAY_FLAG_FILES.get(name)) if f]
        same = got["cuda"] == got["cpu"]
        emit(phase="flags_vs_cpu", case=name, identical=same,
             sha256=hashlib.sha256(got["cuda"][0]).hexdigest())
        check(same, f"{name}: the card's output differs from the CPU's")


def _overlay_rates(torch, dev, cli, tmp):
    """Phase 6 for the two paths: each CLI on ENGINE_FRAMES frames of its
    content, broadcast's chain and stabilize's two chains (pass 2 on the
    .trf its pass-1 CLI run wrote) on noise batches, and pass 1's traced
    device time split between the field search and the rest."""
    bspec = OVERLAY_PATHS["broadcast"]
    write_overlay_aux(tmp, logo=bspec["logo"])
    bspec = {**bspec, "args": overlay_argv(bspec["args"], tmp)}
    sspec = OVERLAY_PATHS["stabilize"]
    passes = [{**sspec, "args": overlay_argv(args, tmp)}
              for args in sspec["passes"]]
    rows = (("stabilize_pass1", passes[0]), ("stabilize_pass2", passes[1]),
            ("broadcast", bspec))
    for name, spec in rows:
        _cli_rates(torch, dev, cli, tmp, name, spec)
    for name, spec in rows:
        chain = _chain_fps(torch, dev, spec)
        emit(phase="chain", path=name, batch=MAIN_BATCH, **chain)
        torch.cuda.empty_cache()
        if name == "stabilize_pass1" and chain["kernels_ms_per_batch"]:
            # the traced chain's device time: the search and the rest
            search = sum(v for k, v in chain["kernels_ms_per_batch"].items()
                         if "field_search" in k)
            emit(phase="stabilize_pass1_split", batch=MAIN_BATCH,
                 busy_ms=chain["busy_ms_per_batch"], search_ms=search,
                 rest_ms=chain["busy_ms_per_batch"] - search)


def _av_files(tmp, frames: int):
    """The av path's inputs: a 1080i Y4M at 29.97 fps and a 48 kHz stereo
    WAV of the same length (round(48000/29.97) = 1602 samples a frame)."""
    spf = round(AUDIO_RATE * AV_FPS[1] / AV_FPS[0])
    src, wav = tmp / "av_in.y4m", tmp / "av_in.wav"
    write_test_y4m(src, MAIN_W, MAIN_H, frames, seed=7, fps=AV_FPS)
    write_test_wav(wav, frames * spf, seed=7, frame=spf)
    return src, wav


# the av CLI's split, timed in turns on the same file: the video alone,
# the track through each part of the audio chain alone, the whole path
AV_SPLIT = {
    "video": (MAIN_ARGS, False),
    "identity_audio": (MAIN_ARGS, True),
    "resample_only": ([*MAIN_ARGS, "-E", "44100"], True),
    "normalize_only": (["-I", "5", "-Z", "1280x720", "-J",
                        "hqdn3d=luma=4.0,normalize"], True),
    "av": (AV_ARGS, True)}
# av's audio half alone, as an audio-only session: -E's chunks do not
# depend on how the samples arrive, so its WAV is av's
AV_AUDIO_ARGS = ["-E", "44100", "-J", "normalize"]
# frames of av's run against the CPU: three batches of MAIN_BATCH
AV_CPU_FRAMES = 3 * 16


class _StageClock:
    """Wall and thread CPU seconds, and calls, of functions wrapped in
    place (``wrap``) while it is active; ``restore`` unwraps them."""

    def __init__(self):
        self.wall, self.cpu, self.calls, self._saved = {}, {}, {}, []

    def wrap(self, owner, name: str, label: str) -> None:
        fn = getattr(owner, name)
        self._saved.append((owner, name, fn))
        for d in (self.wall, self.cpu, self.calls):
            d.setdefault(label, 0)

        def timed(*args, **kwargs):
            w, c = time.perf_counter(), time.thread_time()
            try:
                return fn(*args, **kwargs)
            finally:
                self.wall[label] += time.perf_counter() - w
                self.cpu[label] += time.thread_time() - c
                self.calls[label] += 1

        setattr(owner, name, timed)

    def restore(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()

    def per_call_ms(self) -> dict:
        return {label: {"calls": n,
                        "wall_ms": 1e3 * self.wall[label] / max(1, n),
                        "cpu_ms": 1e3 * self.cpu[label] / max(1, n)}
                for label, n in self.calls.items()}


def _run_av(torch, cli, kernels, tmp):
    """The av path (phases 4 and 6): the main path with its audio track
    through the CLI on ENGINE_FRAMES frames, the launch counts set to 0
    just before and read just after; its Y4M equal to the same CLI's
    without -p/-m (exact-length audio: the adjust synchronizer clones
    and drops nothing, and logs nothing); its whole WAV equal to the
    CPU's audio-only session of the same samples (``AV_AUDIO_ARGS``);
    both files equal to the CPU's on AV_CPU_FRAMES frames at the path's
    batch; then the CLI's frames/s through each of ``AV_SPLIT`` in
    turns, and the engine's stages timed inside the CLI with and
    without the track."""
    from tcforge_tpu_torch.pipeline import chain as chain_mod
    src, wav = _av_files(tmp, ENGINE_FRAMES)

    def run(out, args, audio: bool, device="cuda", extra=()):
        argv = ["-i", str(src), *args, "--progress_off", "-q", "-o",
                f"{out}.y4m", "--batch", str(MAIN_BATCH), "--device",
                device, *extra]
        if audio:
            argv += ["-p", str(wav), "-m", f"{out}.wav"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with captured_log() as lines:
            rc = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"av on {device}: CLI exit code {rc}")
        return seconds, lines

    torch.cuda.synchronize()
    kernels.reset_launches()
    seconds, lines = run(tmp / "av", AV_ARGS, True)
    launches = dict(kernels.launches)
    for name in MAIN_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  "av path")
    synced = [x for x in lines if "(adjust)" in x]
    check(not synced, f"av: the synchronizer cloned or dropped: {synced}")
    run(tmp / "video", AV_ARGS, False)
    same_video = ((tmp / "av.y4m").read_bytes()
                  == (tmp / "video.y4m").read_bytes())
    wav_bytes = (tmp / "av.wav").stat().st_size
    want_bytes = 44 + 4 * (ENGINE_FRAMES * round(
        AUDIO_RATE * AV_FPS[1] / AV_FPS[0]) * 44100 // AUDIO_RATE)
    emit(phase="path", path="av", frames=ENGINE_FRAMES, seconds=seconds,
         launches=launches, y4m_sha256=sha256_file(tmp / "av.y4m"),
         wav_sha256=sha256_file(tmp / "av.wav"), wav_bytes=wav_bytes,
         y4m_equals_video_alone=same_video)
    check(same_video, "av: the Y4M differs from the same CLI's without "
                      "the audio track")
    check(wav_bytes == want_bytes, f"av: {wav_bytes} WAV bytes, "
                                   f"{want_bytes} expected")
    t0 = time.perf_counter()
    rc = cli.main(["-i", str(wav), "-o", str(tmp / "av_audio_cpu.wav"),
                   *AV_AUDIO_ARGS, "--device", "cpu", "--progress_off",
                   "-q"])
    check(rc == 0, f"av's audio on the CPU: exit code {rc}")
    same_wav = ((tmp / "av.wav").read_bytes()
                == (tmp / "av_audio_cpu.wav").read_bytes())
    emit(phase="path_vs_cpu", path="av (whole WAV)", frames=ENGINE_FRAMES,
         identical=same_wav, cpu_seconds=time.perf_counter() - t0)
    check(same_wav, "av: the card's WAV differs from the CPU's audio-only "
                    "session of the same samples")
    outs, cpu_seconds = {}, 0.0
    for device in ("cuda", "cpu"):
        out = tmp / f"avcpu_{device}"
        s, _ = run(out, AV_ARGS, True, device,
                   ["--max_frames", str(AV_CPU_FRAMES)])
        cpu_seconds = s
        outs[device] = [Path(f"{out}.{e}").read_bytes()
                        for e in ("y4m", "wav")]
    same = outs["cuda"] == outs["cpu"]
    emit(phase="path_vs_cpu", path="av", frames=AV_CPU_FRAMES,
         batch=MAIN_BATCH, identical=same, cpu_seconds=cpu_seconds,
         sha256=[hashlib.sha256(b).hexdigest() for b in outs["cuda"]])
    check(same, "av: the card's Y4M or WAV differs from the CPU's")
    # 6. the CLI's frames/s through each part of the track, in turns
    # (the host's own spread between runs is wide: six of each, the
    # order turned each round)
    names = list(AV_SPLIT)
    fps = {name: [] for name in names}
    for r in range(6):
        for name in names[r % len(names):] + names[:r % len(names)]:
            args, audio = AV_SPLIT[name]
            s, _ = run(tmp / "timed", args, audio)
            fps[name].append(ENGINE_FRAMES / s)
    emit(phase="cli", path="av", frames=ENGINE_FRAMES, fps=fps["av"],
         video_alone_fps=fps["video"],
         median_fps=float(np.median(fps["av"])),
         median_video_alone_fps=float(np.median(fps["video"])),
         split_fps=fps,
         split_median_fps={k: float(np.median(v)) for k, v in fps.items()})
    # where the track's time goes inside the CLI: the video chain's call
    # (main thread), the audio's host stage (its own thread) and device
    # stage (main thread), wall and CPU ms a call, three runs each
    for name in ("video", "av", "video", "av", "video", "av"):
        clock = _StageClock()
        clock.wrap(chain_mod.VideoChain, "__call__", "video_chain")
        clock.wrap(chain_mod.AudioChain, "prepare", "audio_prepare")
        clock.wrap(chain_mod.AudioChain, "run", "audio_run")
        try:
            args, audio = AV_SPLIT[name]
            s, _ = run(tmp / "timed", args, audio)
        finally:
            clock.restore()
        emit(phase="av_stages", run=name, fps=ENGINE_FRAMES / s,
             per_call=clock.per_call_ms())
    for pattern in ("av*", "video*", "timed*"):
        for f in tmp.glob(pattern):
            f.unlink()
    return launches


def _run_audio_only(torch, cli, tmp):
    """The audio_only path (phases 4 and 6): a WAV of AUDIO_ONLY_SECONDS
    through each run of AUDIO_ONLY_RUNS on the card, timed (seconds of
    audio per second, after an untimed run), and on the CPU: the same
    bytes."""
    src = tmp / "audio_only_in.wav"
    write_test_wav(src, AUDIO_ONLY_SECONDS * AUDIO_RATE, seed=8)
    for name, args in AUDIO_ONLY_RUNS.items():
        outs, rates = {}, []
        for device in ("cuda", "cuda", "cuda", "cpu"):
            out = tmp / f"audio_only_{name}_{device}.wav"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(["-i", str(src), "-o", str(out), *args,
                           "--device", device, "--progress_off", "-q"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            check(rc == 0, f"audio_only {name} on {device}: exit code {rc}")
            if device == "cuda":
                rates.append(AUDIO_ONLY_SECONDS / seconds)
            outs[device] = out.read_bytes()
        same = outs["cuda"] == outs["cpu"]
        emit(phase="path", path=f"audio_only {name}",
             seconds_of_audio=AUDIO_ONLY_SECONDS,
             audio_seconds_per_s=rates[1:], first_run=rates[0],
             sha256=hashlib.sha256(outs["cuda"]).hexdigest(),
             cpu_seconds=seconds, identical_to_cpu=same)
        check(same, f"audio_only {name}: the card's WAV differs from the "
                    "CPU's")
    src.unlink()


def _audio_goldens(cli, tmp):
    """Phase 5 for the audio track: the small cases whose digests
    tests/test_torch_cli.py pins against the JAX CLI, on the card."""
    paths = audio_golden_inputs(tmp)
    for case in AUDIO_GOLDEN_ARGS:
        out = tmp / f"golden_audio_{case}"
        rc = cli.main([*audio_golden_argv(case, paths, out), "--device",
                       "cuda", "--progress_off", "-q"])
        check(rc == 0, f"audio golden {case}: exit code {rc}")
        for key, pinned in AUDIO_GOLDEN_SHA256.items():
            if key.startswith(case + "."):
                digest = sha256_file(f"{out}.{key.split('.')[-1]}")
                emit(phase="golden", path=key, sha256=digest, pinned=pinned)
                check(digest == pinned, f"{key} differs from the JAX-pinned "
                                        "digest")


def _graph_capture_vs_collection(torch, dev):
    """A CUDA graph freed while another is being captured ends that
    capture, and the cyclic garbage collector frees a finished session's
    normalize filter, its graph with it, at whatever allocation it runs
    on.  ``GraphScan`` keeps the collector off while it captures: here a
    step lets go of the last hold on a captured scan in the middle of its
    own capture, with the collector due at almost every allocation, and
    the new scan's replay must equal the same steps run eagerly."""
    import gc
    from tcforge_tpu_torch.ops.graphs import GraphScan

    def step(x, a):
        return (a * 0.5 + x.sum(),)
    x = torch.zeros((2,), dtype=torch.float32, device=dev)
    a = torch.ones((), dtype=torch.float32, device=dev)
    old = GraphScan(step)
    old.prepare(x, (a,))
    hold = [old]
    del old

    def capturing(x, a):
        if hold and torch.cuda.is_current_stream_capturing():
            garbage = [hold.pop()]          # the last hold, in a cycle
            garbage.append(garbage)
            del garbage
            [[] for _ in range(64)]         # a collection's turn
        return step(x, a)
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        scan = GraphScan(capturing)
        scan.prepare(x, (a,))
    finally:
        gc.set_threshold(*thresholds)
    xs = torch.arange(12, dtype=torch.float32, device=dev).reshape(6, 2)
    ys, _ = scan(xs, (a,))
    want, carry = [], a
    for row in xs:
        carry = step(row, carry)[0]
        want.append(carry)
    same = torch.equal(ys, torch.stack(want))
    emit(phase="graph_capture", garbage_dropped_mid_capture=not hold,
         identical=same)
    check(not hold and same, "GraphScan: the replay after a capture with "
                             "garbage pending differs from the eager steps")


def _audio_chain_ms(torch, dev, batches: int = 10, warmup: int = 4):
    """The audio chain of the av path alone, per batch of MAIN_BATCH
    frames of 1602 stereo samples handed over in host memory, as the
    engine hands them: the host's time in its host stage
    (``AudioChain.prepare``, which the engine runs in a thread of its
    own) and in its device stage (``run``, the main thread's queueing;
    nothing in either waits for the card), timed without the profiler,
    and, from a torch.profiler trace of the same batches through a
    fresh chain, the device's busy time; with -E (the streaming branch,
    normalize on 2048-sample chunks) and without (the jitted step's
    form).  The warmup batches see each batch shape twice, so normalize
    replays its CUDA graphs in the timed ones."""
    from torch.profiler import ProfilerActivity, profile
    from tcforge_tpu_torch.core.frame import AudioBatch
    from tcforge_tpu_torch.core.job import FilterSpec, Job
    from tcforge_tpu_torch.pipeline.chain import AudioChain
    spf = round(AUDIO_RATE * AV_FPS[1] / AV_FPS[0])
    rng = np.random.default_rng(9)
    levels = np.array(AUDIO_LEVELS, np.float32)
    inputs = [np.clip(np.rint(rng.standard_normal(
        (MAIN_BATCH, spf, 2), dtype=np.float32) * rng.choice(
            levels, (MAIN_BATCH, 1, 1))), -32768, 32767).astype(np.int16)
        for _ in range(warmup + batches)]
    out = {}
    for branch, rate in (("resampled", 44100), ("jitted", 0)):
        job = Job(filters=[FilterSpec("normalize", "")], a_rate=AUDIO_RATE,
                  a_chan=2, dm_chan=2, mp3frequency=rate)

        def run_all(host=None):
            chain = AudioChain(job, dev)
            states = chain.initial_states()
            for i, x in enumerate(inputs):
                t0 = time.perf_counter()
                prepared = chain.prepare(AudioBatch(
                    pcm=torch.from_numpy(x), rate=AUDIO_RATE))
                t1 = time.perf_counter()
                _, states, _ = chain.run(prepared, states)
                if host is not None and i >= warmup:
                    host += (t1 - t0, time.perf_counter() - t1)
            torch.cuda.synchronize()

        host = np.zeros(2)
        run_all(host)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_all()
        host_ms = [float(v) * 1e3 / batches for v in host]
        busy = _device_busy(prof, warmup + batches)
        out[branch] = {"host_stage_ms_per_batch": host_ms[0],
                       "queue_ms_per_batch": host_ms[1],
                       "busy_ms_per_batch": busy["busy_ms_per_batch"],
                       "kernels_ms_per_batch": busy["kernels_ms_per_batch"]}
    return out


# ---------------------------------------------------------------------- #
# The DVD path: MPEG-1/2 import (host parse, reconstruction kernels) into
# hqdn3d

def _mpeg_importer(path, dev, buffers: int = 2, options: str = "",
                   job=None):
    from tcforge_tpu_torch.core.job import Job
    from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "mpeg", job or Job(),
                     options)
    imp.open(str(path))
    imp.start(dev, buffers)
    return imp


def _recon_bytes(args) -> int:
    """What one frame picture's ``mpeg2_recon`` call must move: its
    coefficient grids and records, each reference plane it reads once,
    its three planes out."""
    yc, uc, vc, mbinfo, fwd, bwd = args[:6]
    refs = [p for planes in (fwd, bwd) if planes is not None for p in planes]
    # one output sample for each coefficient (4:2:0 and 4:2:2 alike)
    return _nbytes(yc, uc, vc, mbinfo, *refs) + yc.numel() + 2 * uc.numel()


def _check_mpeg2_kernels(torch, kernels, bench):
    """Phase 3 for the MPEG-2 reconstruction: every call of
    ``mpeg2_recon`` and ``mpeg2_idct_intra`` while every stream of
    tests/data/mpeg2 decodes on the card (dvd.vob's every picture, the
    field-picture stream, field MC, dual prime, field DCT, MPEG-1 with
    D-pictures, sizes that are not a multiple of 16) held against the
    plain versions on the same inputs, at batches of 16, of 1 and of 3
    (intra runs of one and of an odd count); the float64 IDCT on ragged
    random grids of 1 and 5 pictures; then each timed at dvd.vob's
    shapes beside its plain version, its bound and ``torch.matmul`` of
    the IDCT's (blocks, 64) @ (64, 64) part."""
    dev = bench.dev
    recon, idct = kernels.mpeg2_recon, kernels.mpeg2_idct_intra
    counts = {"mpeg2_recon": 0, "mpeg2_idct_intra": 0}
    captured = {"recon": [], "idct": []}
    where = {"case": ""}

    def checked_recon(*args, **kw):
        got = recon(*args, **kw)
        bench.check("mpeg2_recon", where["case"], got,
                    kernels.mpeg2_recon_ref(*args, **kw), quiet=True)
        counts["mpeg2_recon"] += 1
        if where["case"] == "dvd.vob b16":
            captured["recon"].append(args)
        return got

    def checked_idct(coef):
        got = idct(coef)
        bench.check("mpeg2_idct_intra", where["case"], got,
                    kernels.mpeg2_idct_intra_ref(coef), quiet=True)
        counts["mpeg2_idct_intra"] += 1
        if where["case"] == "dvd.vob b16":
            captured["idct"].append(coef)
        return got

    streams = sorted(p.name for p in MPEG_DATA.iterdir()
                     if p.suffix != ".py")
    runs = [(name, 16) for name in streams] + [
        ("intra.m2v", 1), ("intra.m2v", 3), ("dpict.m1v", 1),
        ("synth_fields.m2v", 1), ("small.mpg", 3)]
    kernels.mpeg2_recon, kernels.mpeg2_idct_intra = (checked_recon,
                                                     checked_idct)
    try:
        for name, batch in runs:
            where["case"] = f"{name} b{batch}"
            imp = _mpeg_importer(MPEG_DATA / name, dev)
            while imp.read_video_batch(batch) is not None:
                pass
            imp.close()
    finally:
        kernels.mpeg2_recon, kernels.mpeg2_idct_intra = recon, idct
    rng = np.random.default_rng(11)
    for n, bh, bw in ((1, 3, 5), (5, 7, 9), (1, 60, 90)):
        coef = torch.from_numpy(rng.integers(-300, 300, (n, bh, bw, 64),
                                             dtype=np.int32)).to(dev)
        bench.check("mpeg2_idct_intra", f"random {n}x{bh}x{bw}",
                    kernels.mpeg2_idct_intra(coef),
                    kernels.mpeg2_idct_intra_ref(coef), quiet=True)
        counts["mpeg2_idct_intra"] += 1
    for kernel, cases in counts.items():
        emit(phase="kernel_sweep", kernel=kernel, cases=cases,
             streams=len(streams), max_abs_err=0)

    # timed at dvd.vob's shapes: its P and B pictures in turn (each a
    # different picture, more than L2 together), and its intra planes
    from tcforge_tpu_torch.io.mpeg2codec import idct_kron
    calls = captured["recon"]
    check(len(calls) >= 8, f"dvd.vob gave {len(calls)} mpeg2_recon calls")
    kmat = torch.from_numpy(idct_kron()).to(dev)

    def fmas(args):
        """Fused multiply-adds these coefficients need: 64 per nonzero
        coefficient (one for each pixel of its block)."""
        return 64 * int(sum(int((c != 0).sum()) for c in args[:3]))

    def coef_rows(args):
        return (torch.cat([c.reshape(-1, 64) for c in args[:3]])
                .to(torch.float32),)

    per_batch = len(calls) / (DVD_FRAMES / MAIN_BATCH)
    # the bound of the mean call: the timed calls are these pictures in
    # turn, B pictures reading two references and P pictures one
    bench.record("mpeg2_recon", "720x480 P and B pictures", per_batch,
                 lambda *a: kernels.mpeg2_recon(*a),
                 lambda *a: kernels.mpeg2_recon_ref(*a), calls,
                 nbytes=sum(map(_recon_bytes, calls)) / len(calls),
                 ops=sum(map(fmas, calls)) / len(calls),
                 library=(lambda c: torch.matmul(c, kmat),
                          [coef_rows(a) for a in calls]),
                 plain_reps=2, ops_per_s=F32_FMA_PER_S)
    planes = captured["idct"]
    check(len(planes) >= 3, f"dvd.vob gave {len(planes)} intra planes")
    per_batch = len(planes) / (DVD_FRAMES / MAIN_BATCH)
    kmat64 = kmat.to(torch.float64)
    for label, group in (("720x480 intra Y", planes[0::3]),
                         ("360x240 intra U, V", planes[1::3] + planes[2::3])):
        inputs = [(c,) for c in group]
        while sum(_nbytes(c) for (c,) in inputs) < L2_BYTES:
            inputs = inputs + [(c.clone(),) for (c,) in inputs]
        c0 = inputs[0][0]
        blocks = c0.numel() // 64
        bench.record("mpeg2_idct_intra", label,
                     per_batch * len(group) / len(planes),
                     kernels.mpeg2_idct_intra, kernels.mpeg2_idct_intra_ref,
                     inputs, nbytes=_nbytes(c0) + blocks * 64,
                     ops=1024 * blocks,
                     library=(lambda c: torch.matmul(c, kmat64),
                              [(c.reshape(-1, 64).to(torch.float64),)
                               for (c,) in inputs]),
                     plain_reps=2, ops_per_s=F64_FMA_PER_S)


def _run_dvd(torch, cli, kernels, tmp):
    """Phase 4 for the DVD path: dvd.vob through the port's CLI with the
    launch counts set to 0 just before and read just after (the two
    reconstruction kernels and hqdn3d's), its output equal to the same
    CLI on the plain versions on the card, byte for byte, and equal at
    --batch 1, 3, 16 and --prefetch 1, 4; the field-picture stream
    against its plain versions too.  Returns the launches."""
    argv = ["-i", str(MPEG_DATA / "dvd.vob"), *DVD_ARGS, "--device", "cuda",
            "--progress_off", "-q"]
    out = tmp / "dvd.y4m"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main([*argv, "-o", str(out), "--batch", str(MAIN_BATCH)])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(rc == 0, f"dvd: CLI exit code {rc}")
    emit(phase="path", path="dvd", frames=DVD_FRAMES, seconds=e2e_s,
         e2e_fps=DVD_FRAMES / e2e_s,
         launches={k: launches[k] for k in MPEG_KERNELS})
    for name in MPEG_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  "dvd path")
    want = out.read_bytes()
    for name, src in (("dvd", "dvd.vob"), ("dvd_fields", "dvd_fields.vob")):
        got = {}
        for label, ctx in (("kernels", contextlib.nullcontext()),
                           ("plain", plain_versions(kernels))):
            path = tmp / f"{name}_{label}.y4m"
            with ctx:
                rc = cli.main(["-i", str(MPEG_DATA / src), *DVD_ARGS,
                               "--device", "cuda", "--progress_off", "-q",
                               "-o", str(path)])
            check(rc == 0, f"{name} on the {label}: CLI exit code {rc}")
            got[label] = path.read_bytes()
        same = got["kernels"] == got["plain"]
        emit(phase="path_vs_plain", path=name, identical=same,
             sha256=hashlib.sha256(got["kernels"]).hexdigest())
        check(same, f"{name}: the kernels' output differs from the plain "
                    "versions' on the card")
    check(want == (tmp / "dvd_kernels.y4m").read_bytes(),
          "dvd: two runs of the CLI differ")
    for prefetch in (1, 4):
        for batch in (1, 3, 16):
            path = tmp / f"dvd_{prefetch}_{batch}.y4m"
            rc = cli.main([*argv, "-o", str(path), "--prefetch",
                           str(prefetch), "--batch", str(batch)])
            same = rc == 0 and path.read_bytes() == want
            emit(phase="engine_vs_batch16", path="dvd", prefetch=prefetch,
                 batch=batch, identical=same)
            check(same, f"dvd at --prefetch {prefetch} --batch {batch}: "
                        "the output differs")
            path.unlink()
    return launches


def _mpeg_goldens(cli, tmp):
    """Phase 5 for the MPEG import: every ``MPEG_GOLDEN`` case on the
    card, its SHA-256 against the JAX CLI's pinned digest."""
    for case, (_name, args) in MPEG_GOLDEN.items():
        src = mpeg_golden_input(case, tmp)
        out = tmp / f"mpeg_golden_{case}.y4m"
        rc = cli.main(["-i", str(src), "-o", str(out), *args, "--device",
                       "cuda", "--progress_off", "-q"])
        digest = sha256_file(out)
        emit(phase="golden", path=f"mpeg_{case}", sha256=digest,
             pinned=MPEG_GOLDEN_SHA256[case])
        check(rc == 0 and digest == MPEG_GOLDEN_SHA256[case],
              f"mpeg {case} golden output differs from the JAX-pinned "
              "digest")


def _dvd_long_es(tmp, copies: int = 3) -> Path:
    """dvd.vob's video elementary stream three times over (144 frames,
    nine batches): a longer programme of the same pictures."""
    from tcforge_tpu_torch.io import mpeg
    es = b"".join(p for sid, p in mpeg.iter_pes_packets(
        str(MPEG_DATA / "dvd.vob")) if 0xE0 <= sid <= 0xEF)
    path = Path(tmp) / "dvd_long.m2v"
    path.write_bytes(es * copies)
    return path


def _dvd_rates(torch, dev, cli, tmp):
    """Phase 6 for the DVD path, on dvd.vob's stream three times over
    (nine batches of 16): the host's parse and plan per batch; the
    decode and hqdn3d on the card per batch (CUDA events; the host's
    time to queue them; the device's busy share and time by kernel from
    torch.profiler: the upload, mpeg2_recon, mpeg2_idct_intra, hqdn3d's
    scans); then the CLI, wall clock, six runs on that stream and six on
    dvd.vob in turns, and its serial stages one by one
    (``mpeg_stages``)."""
    from torch.profiler import ProfilerActivity, profile
    from tcforge_tpu_torch.core.formats import ImageFormat
    from tcforge_tpu_torch.core.frame import FrameBatch
    from tcforge_tpu_torch.core.job import FilterSpec, Job
    from tcforge_tpu_torch.pipeline.chain import VideoChain
    src = _dvd_long_es(tmp)
    job = Job(filters=[FilterSpec("hqdn3d", "luma=4.0")],
              im_v_width=DVD_W, im_v_height=DVD_H)

    def plans():
        # a buffer for each of the nine plans: all parsed before the run
        imp = _mpeg_importer(src, dev, buffers=10)
        out, ms = [], []
        while True:
            t0 = time.perf_counter()
            plan = imp.plan_batch(MAIN_BATCH)
            ms.append((time.perf_counter() - t0) * 1e3)
            if plan is None:
                return imp, out, ms[:-1]
            out.append(plan)

    def run(imp, todo, copy):
        chain = VideoChain(job, ImageFormat.YUV420P, DVD_W, DVD_H)
        states = chain.initial_states(dev)
        first = 0
        for plan in todo:
            planes = imp.execute(plan, copy)
            n = planes["y"].shape[0]
            fb = FrameBatch(format=ImageFormat.YUV420P, y=planes["y"],
                            u=planes["u"], v=planes["v"],
                            attrs=torch.zeros((n,), dtype=torch.int32,
                                              device=dev),
                            frame_ids=torch.arange(first, first + n,
                                                   dtype=torch.int32,
                                                   device=dev), fps=29.97)
            _out, states = chain(fb, states)
            first += n
        return first

    copy = torch.cuda.Stream(dev)
    imp, todo, parse_ms = plans()
    run(imp, todo[:1], copy)                   # warm: kernels loaded
    imp, todo, parse_ms = plans()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    frames = run(imp, todo, copy)
    end.record()
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end)
    imp, todo2, _ = plans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(imp, todo2, copy)
        torch.cuda.synchronize()
    batches = len(todo)
    busy = _device_busy(prof, batches)
    emit(phase="chain", path="dvd", batch=MAIN_BATCH, frames=frames,
         chain_fps=frames / (event_ms / 1e3), ms_per_batch=event_ms / batches,
         queue_ms_per_batch=queue_ms / batches,
         parse_ms_per_batch=sum(parse_ms) / len(parse_ms),
         parse_fps=frames / (sum(parse_ms) / 1e3), **busy,
         busy_share=(busy["busy_ms_per_batch"] / (event_ms / batches)
                     if busy["busy_ms_per_batch"] else None))
    # the CLI on the long ES and on dvd.vob's program stream, in turns
    # (the host's spread between runs is wide: six of each, the order
    # turned each round)
    out = Path(tmp) / "dvd_long.y4m"
    argv = [*DVD_ARGS, "--batch", str(MAIN_BATCH)]
    inputs = {"es": (src, frames), "ps": (MPEG_DATA / "dvd.vob", DVD_FRAMES)}
    fps = {name: [] for name in inputs}
    names = list(inputs)
    for r in range(6):
        for name in names[r % 2:] + names[:r % 2]:
            path, n = inputs[name]
            t0 = time.perf_counter()
            rc = cli.main(["-i", str(path), "-o", str(out), *argv,
                           "--device", "cuda", "--progress_off", "-q"])
            torch.cuda.synchronize()
            fps[name].append(n / (time.perf_counter() - t0))
            check(rc == 0, f"dvd CLI on {path.name}: exit code {rc}")
    emit(phase="cli", path="dvd", frames=frames, fps=fps["es"],
         median_fps=float(np.median(fps["es"])),
         min_fps=min(fps["es"]), max_fps=max(fps["es"]),
         ps_frames=DVD_FRAMES, ps_fps=fps["ps"],
         ps_median_fps=float(np.median(fps["ps"])),
         stages=mpeg_stages(torch, dev, src, Path(tmp) / "stages.y4m", job))


def mpeg_stages(torch, dev, src, out, job, batch: int = MAIN_BATCH,
                audio: bool = False):
    """The serial engine's stages for an MPEG input on the card, each
    timed alone with the card synchronized after it: the host parse and
    plan, with ``audio`` the wait for the batch's samples of the
    importer's audio track, the decode (upload and reconstruction), the
    chain, the copy back and the Y4M write.  A transport stream's demux
    (``tsio.iter_video_es``: one PID's packets to elementary stream
    pieces) is timed wherever it runs and taken out of the stage it ran
    in: ``demux`` the video PID's, ``audio_demux`` the audio PID's.
    Apart from the sum: ``audio_decode``, the audio decoder's own time in
    its process; ``open_ms``, the importer's open, of which
    ``demux_at_open_ms`` demuxed; ``audio_demux_ms_per_piece``, the audio
    PID's demux time over the pieces it gave, at open or later.  Returns
    ms per batch of each stage, their sum and the frames/s of the sum
    and of the slowest stage.  The importer takes ``job`` too (a 4:2:2
    stream stays 4:2:2 under its -V yuv422p)."""
    from tcforge_tpu_torch.core.frame import FrameBatch
    from tcforge_tpu_torch.io import ts as tsio
    from tcforge_tpu_torch.io.adec_worker import decode_seconds
    from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MWriter
    from tcforge_tpu_torch.modules.importers.mpeg_import import _TS_AUDIO
    from tcforge_tpu_torch.pipeline.chain import VideoChain
    with open(src, "rb") as f:
        is_ts = f.read(1) == b"\x47"
    apids = ({p for p, st in tsio.scan_programs(str(src)).items()
              if st in _TS_AUDIO} if is_ts else set())
    spent = {"demux": 0.0, "audio_demux": 0.0}
    audio_pieces = [0]
    iter_es = tsio.iter_video_es

    def timed_es(path, pid=None, **kw):
        key = "audio_demux" if pid in apids else "demux"
        pieces = iter_es(path, pid=pid, **kw)
        while True:
            t = time.perf_counter()
            piece = next(pieces, None)
            spent[key] += time.perf_counter() - t
            if piece is None:
                return
            audio_pieces[0] += key == "audio_demux"
            yield piece

    def host_stage(key, a, b, before):
        ran = {k: v - before[k] for k, v in spent.items()}
        ms[key] += ((b - a) - sum(ran.values())) * 1e3
        for k, v in ran.items():
            ms[k] += v * 1e3

    ms = dict.fromkeys(("demux", "parse", "audio_demux", "audio", "decode",
                        "chain", "to_host", "write"), 0.0)
    tsio.iter_video_es = timed_es
    try:
        t0 = time.perf_counter()
        imp = _mpeg_importer(src, dev, job=job)
        open_ms = (time.perf_counter() - t0) * 1e3
        demux_at_open_ms = sum(spent.values()) * 1e3
        fmt = imp.format
        spf = imp.audio_rate * 1001 / 30000
        chain = VideoChain(job, fmt, imp.width, imp.height)
        states = chain.initial_states(dev)
        audio_decode = 0.0
        frames = batches = 0
        wr = None
        torch.cuda.synchronize()
        while True:
            before, dec0 = dict(spent), decode_seconds()
            t0 = time.perf_counter()
            plan = imp.plan_batch(batch)
            t1 = time.perf_counter()
            if plan is None:
                break
            host_stage("parse", t0, t1, before)
            n = len(plan.frames)
            before = dict(spent)
            if audio and n:
                imp.read_audio_batch(int(round(spf * (frames + n)))
                                     - int(round(spf * frames)))
            t2 = time.perf_counter()
            host_stage("audio", t1, t2, before)
            audio_decode += (decode_seconds() - dec0) * 1e3
            planes = imp.execute(plan)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if planes is None:
                continue
            fb = FrameBatch(format=fmt, y=planes["y"],
                            u=planes["u"], v=planes["v"],
                            attrs=torch.zeros((n,), dtype=torch.int32,
                                              device=dev),
                            frame_ids=torch.arange(frames, frames + n,
                                                   dtype=torch.int32,
                                                   device=dev), fps=29.97,
                            id_range=(frames, frames + n))
            result, states = chain(fb, states)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            host = result.to_numpy()
            t5 = time.perf_counter()
            if wr is None:
                wr = Y4MWriter(str(out), Y4MHeader(
                    width=result.width, height=result.height,
                    fps_num=30000, fps_den=1001, format=result.format))
            wr.write_batch(*host)
            t6 = time.perf_counter()
            for key, a, b in (("decode", t2, t3), ("chain", t3, t4),
                              ("to_host", t4, t5), ("write", t5, t6)):
                ms[key] += (b - a) * 1e3
            frames += n
            batches += 1
        imp.close()
    finally:
        tsio.iter_video_es = iter_es
        if wr is not None:
            wr.close()
    per_batch = {k: v / batches for k, v in ms.items()}
    total = sum(per_batch.values())
    return {"frames": frames, "ms_per_batch": per_batch,
            "sum_ms_per_batch": total,
            "serial_fps": frames / (total * batches / 1e3),
            "overlapped_fps": frames / (max(per_batch.values())
                                        * batches / 1e3),
            "audio_decode_ms_per_batch": audio_decode / batches,
            "open_ms": open_ms, "demux_at_open_ms": demux_at_open_ms,
            "audio_pieces": audio_pieces[0],
            "audio_demux_ms_per_piece": (
                spent["audio_demux"] * 1e3 / audio_pieces[0]
                if audio_pieces[0] else None)}


# ---------------------------------------------------------------------- #
# The DVD rip: -i VIDEO_TS -x dvd -T 1 with its AC-3 track (-m), extsub
# and hqdn3d

RIP_KERNELS = MPEG_KERNELS
# the long title of the CLI timings: two VOB files, each the title's
# sectors twice over (112 frames; a disc's VOB file holds a GB; cut from
# eight, then four, to keep the script inside its time limit)
RIP_LONG_REPEAT = 2
# phase 6's CLI runs of each rip variant (cut from six, then four and
# three, to keep the script inside its time limit)
RIP_RUNS = 2
# a feature film's VobSub: about 1,500 units over two hours
FILM_UNITS, FILM_STEP_MS = 1500, 4800


def dvdrip_title(directory, repeat: int = 1) -> Path:
    """A ``VIDEO_TS`` directory in ``directory``: the fixture title's IFOs
    and its two VOB files, or with ``repeat`` more than 1 two VOB files
    that each hold the title's sectors ``repeat`` times over (each of
    its files starts at a GOP, so the copies play one after the
    other)."""
    src = DVD_DATA / "VIDEO_TS"
    ts = Path(directory) / f"VIDEO_TS_{repeat}" / "VIDEO_TS"
    ts.mkdir(parents=True)
    for name in ("VIDEO_TS.IFO", "VTS_01_0.IFO"):
        (ts / name).write_bytes((src / name).read_bytes())
    vobs = [(src / f"VTS_01_{k}.VOB").read_bytes() for k in (1, 2)]
    if repeat > 1:
        vobs = [b"".join(vobs) * repeat] * 2
    for k, vob in enumerate(vobs):
        (ts / f"VTS_01_{k + 1}.VOB").write_bytes(vob)
    return ts


def film_vobsub(directory, units: int = FILM_UNITS,
                step_ms: int = FILM_STEP_MS, src: str = "title") -> Path:
    """A VobSub pair in ``directory`` with a film's count of units:
    ``src``'s first-language units repeated in turn, the first at their
    own times and then one every ``step_ms``; returns the .idx path."""
    lines = (DVD_DATA / f"{src}.idx").read_text().splitlines()
    sub = (DVD_DATA / f"{src}.sub").read_bytes()
    first = next(i for i, line in enumerate(lines) if line.startswith("id:"))
    stamps = []
    for line in lines[first + 1:]:
        if not line.startswith("timestamp:"):
            break
        hh, mm, ss, ms = (int(v) for v in line.split()[1][:-1].split(":"))
        pos = int(line.rsplit(" ", 1)[1], 16)
        size = 6 + int.from_bytes(sub[pos + 4:pos + 6], "big")
        stamps.append((((hh * 60 + mm) * 60 + ss) * 1000 + ms,
                       sub[pos:pos + size]))
    out, body = lines[:first + 1], bytearray()
    for k in range(units):
        ms, packet = stamps[k % len(stamps)]
        if k >= len(stamps):
            ms = stamps[-1][0] + (k - len(stamps) + 1) * step_ms
        hh, rest = divmod(ms, 3600000)
        mm, rest = divmod(rest, 60000)
        ss, rest = divmod(rest, 1000)
        out.append(f"timestamp: {hh:02d}:{mm:02d}:{ss:02d}:{rest:03d}, "
                   f"filepos: {len(body):09x}")
        body += packet
    idx = Path(directory) / f"film{units}.idx"
    idx.write_text("\n".join(out) + "\n")
    idx.with_suffix(".sub").write_bytes(bytes(body))
    return idx


def rip_args(subs=None) -> list:
    """The rip's options, its subtitles from ``subs`` (an .idx path)
    where given."""
    args = [a.format(dvd=DVD_DATA) for a in RIP_ARGS]
    if subs is not None:
        args[-1] = args[-1].replace(f"{DVD_DATA}/title.idx", str(subs))
    return args


def rip_argv(title, out, audio: bool = True, subs=None) -> list:
    """The rip's CLI arguments on ``title``, writing ``out``.y4m (and
    ``out``.wav with the track)."""
    return (["-i", str(title), "-o", f"{out}.y4m", *rip_args(subs)]
            + (["-m", f"{out}.wav"] if audio else []))


@contextlib.contextmanager
def checked_kernels(kernels, bench, case: str, names):
    """Every call of the wrappers ``names`` (kernel name: wrapper name)
    held against its plain version on the same inputs; yields the count
    of calls by kernel."""
    saved = {w: getattr(kernels, w) for w in names.values()}
    counts = dict.fromkeys(names, 0)

    def checked(kernel, wrapper):
        fn, ref = saved[wrapper], getattr(kernels, wrapper + "_ref")

        def call(*a, **k):
            got = fn(*a, **k)
            bench.check(kernel, case, got, ref(*a, **k), quiet=True)
            counts[kernel] += 1
            return got
        return call
    try:
        for kernel, wrapper in names.items():
            setattr(kernels, wrapper, checked(kernel, wrapper))
        yield counts
    finally:
        for wrapper, fn in saved.items():
            setattr(kernels, wrapper, fn)


_RIP_WRAPPERS = {"mpeg2_recon": "mpeg2_recon",
                 "mpeg2_idct_intra": "mpeg2_idct_intra",
                 "hqdn3d_spatial_scan": "spatial_scan",
                 "hqdn3d_temporal_scan": "temporal_scan"}


def _run_dvdrip(torch, cli, kernels, bench, tmp):
    """Phase 4 for the DVD rip: the rip through the port's CLI with the
    launch counts set to 0 just before and read just after (every kernel
    of the path launched); its .y4m and .wav against the JAX-pinned
    digests; the same CLI with every kernel call held against its plain
    version (max abs err 0) and on the plain versions alone, byte for
    byte.  Returns the launches."""
    title = dvdrip_title(tmp)
    out = tmp / "rip"
    argv = [*rip_argv(title, out), "--device", "cuda", "--progress_off",
            "-q"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(rc == 0, f"dvdrip: CLI exit code {rc}")
    frames = Path(f"{out}.y4m").read_bytes().count(b"FRAME\n")
    emit(phase="path", path="dvdrip", frames=frames, seconds=seconds,
         e2e_fps=frames / seconds,
         launches={k: launches[k] for k in RIP_KERNELS})
    for name in RIP_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  "dvdrip path")
    want = [sha256_file(f"{out}.{ext}") for ext in ("y4m", "wav")]
    emit(phase="golden", path="dvdrip", sha256=want,
         pinned=list(DVD_GOLDEN_SHA256["rip"]))
    check(tuple(want) == DVD_GOLDEN_SHA256["rip"],
          "dvdrip output differs from the JAX-pinned digests")
    for label in ("checked", "plain"):
        path = tmp / f"rip_{label}"
        ctx = (checked_kernels(kernels, bench, "dvdrip", _RIP_WRAPPERS)
               if label == "checked" else plain_versions(kernels))
        with ctx as counts:
            rc = cli.main([*rip_argv(title, path), "--device", "cuda",
                           "--progress_off", "-q"])
        check(rc == 0, f"dvdrip on the {label}: CLI exit code {rc}")
        got = [sha256_file(f"{path}.{ext}") for ext in ("y4m", "wav")]
        same = got == want
        emit(phase="path_vs_plain", path="dvdrip", run=label,
             identical=same, checked_calls=counts)
        check(same, f"dvdrip on the {label}: the output differs")
    return launches


def _dvd_goldens(cli, tmp):
    """Phase 5 for the DVD rip: every ``DVD_GOLDEN`` case on the card, its
    .y4m and .wav SHA-256 against the JAX CLI's pinned digests."""
    for case in DVD_GOLDEN:
        argv = dvd_golden_argv(case, tmp, tmp / f"dvd_golden_{case}")
        rc = cli.main([*argv, "--device", "cuda", "--progress_off", "-q"])
        digest = tuple(sha256_file(tmp / f"dvd_golden_{case}.{ext}")
                       for ext in ("y4m", "wav"))
        emit(phase="golden", path=f"dvd_{case}", sha256=list(digest),
             pinned=list(DVD_GOLDEN_SHA256[case]))
        check(rc == 0 and digest == DVD_GOLDEN_SHA256[case],
              f"dvd {case} golden output differs from the JAX-pinned "
              "digests")


def _dvdrip_rates(torch, dev, cli, tmp):
    """Phase 6 for the DVD rip, on a title of two VOB files that each
    hold the fixture title ``RIP_LONG_REPEAT`` times: the CLI, wall
    clock, RIP_RUNS runs of each variant in turns: the rip with its track,
    the same with a film's VobSub (``film_vobsub``), and without -m (no
    track demuxed); then the serial stages a batch (``dvdrip_stages``)
    with each subtitle file."""
    title = dvdrip_title(tmp, RIP_LONG_REPEAT)
    film = film_vobsub(tmp)
    out = Path(tmp) / "rip_long"
    variants = [("m", True, None), ("m_film_subs", True, film),
                ("video_only", False, None)]
    fps = {name: [] for name, _, _ in variants}
    frames = {}
    for r in range(RIP_RUNS):
        k = r % len(variants)
        for name, audio, subs in variants[k:] + variants[:k]:
            t0 = time.perf_counter()
            rc = cli.main([*rip_argv(title, out, audio, subs), "--batch",
                           str(MAIN_BATCH), "--device", "cuda",
                           "--progress_off", "-q"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            check(rc == 0, f"dvdrip CLI ({name}): exit code {rc}")
            frames[name] = Path(f"{out}.y4m").read_bytes().count(
                b"FRAME\n")
            fps[name].append(frames[name] / seconds)
    emit(phase="cli", path="dvdrip", repeat=RIP_LONG_REPEAT, frames=frames,
         film_units=FILM_UNITS, fps=fps,
         median_fps={k: float(np.median(v)) for k, v in fps.items()},
         min_fps={k: min(v) for k, v in fps.items()},
         max_fps={k: max(v) for k, v in fps.items()})
    for label, subs in (("title_subs", None), ("film_subs", film)):
        emit(phase="stages", path="dvdrip", subs=label,
             **dvdrip_stages(torch, dev, title, Path(tmp) / "stages.y4m",
                             subs))


def dvdrip_stages(torch, dev, title, out, subs=None,
                  batch: int = MAIN_BATCH):
    """The serial stages of the rip on the card, each timed alone with
    the card synchronized after it: the host parse and plan (with the
    demux), the wait for the audio track's samples of the batch (what
    the decode process has not given back yet), the decode (upload and
    reconstruction), the chain (extsub from ``subs`` or the title's
    .idx, hqdn3d), the copy back and the Y4M write; ``audio_decode`` is
    the decoder's own time a batch, in its process.  Returns ms per
    batch of each, the sum of the serial ones and the frames/s of the
    sum and of the slowest one."""
    from tcforge_tpu_torch.core.formats import ImageFormat
    from tcforge_tpu_torch.core.frame import FrameBatch
    from tcforge_tpu_torch.core.job import FilterSpec, Job
    from tcforge_tpu_torch.io.adec_worker import decode_seconds
    from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MWriter
    from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
    from tcforge_tpu_torch.pipeline.chain import VideoChain
    job = Job(dvd_title=1, fps=30000 / 1001, filters=[
        FilterSpec.parse(f) for f in rip_args(subs)[-1].split(",")])
    imp = new_module(ModuleKind.DEMULTIPLEXOR, "dvd", job)
    imp.open(str(title))
    imp.start(dev, 2)
    spf = int(round(imp.audio_rate / imp.fps))
    chain = VideoChain(job, ImageFormat.YUV420P, imp.width, imp.height)
    states = chain.initial_states(dev)
    ms = dict.fromkeys(("parse", "audio", "decode", "chain", "to_host",
                        "write"), 0.0)
    ms["audio_decode"] = 0.0
    frames = batches = 0
    with Y4MWriter(str(out), Y4MHeader(
            width=imp.width, height=imp.height, fps_num=30000,
            fps_den=1001, format=ImageFormat.YUV420P)) as wr:
        torch.cuda.synchronize()
        while True:
            dec0 = decode_seconds()
            t0 = time.perf_counter()
            plan = imp.plan_batch(batch)
            t1 = time.perf_counter()
            if plan is None:
                break
            n = len(plan.frames)
            if n:
                imp.read_audio_batch(spf * n)
            t2 = time.perf_counter()
            ms["audio_decode"] += (decode_seconds() - dec0) * 1e3
            planes = imp.execute(plan)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if planes is None:
                continue
            fb = FrameBatch(format=ImageFormat.YUV420P, y=planes["y"],
                            u=planes["u"], v=planes["v"],
                            attrs=torch.zeros((n,), dtype=torch.int32,
                                              device=dev),
                            frame_ids=torch.arange(
                                frames, frames + n, dtype=torch.int32,
                                device=dev), fps=job.fps,
                            id_range=(frames, frames + n))
            result, states = chain(fb, states)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            host = result.to_numpy()
            t5 = time.perf_counter()
            wr.write_batch(*host)
            t6 = time.perf_counter()
            for key, a, b in (("parse", t0, t1), ("audio", t1, t2),
                              ("decode", t2, t3), ("chain", t3, t4),
                              ("to_host", t4, t5), ("write", t5, t6)):
                ms[key] += (b - a) * 1e3
            frames += n
            batches += 1
    imp.close()
    per_batch = {k: v / batches for k, v in ms.items()}
    serial = {k: v for k, v in per_batch.items() if k != "audio_decode"}
    total = sum(serial.values())
    return {"frames": frames, "ms_per_batch": per_batch,
            "sum_ms_per_batch": total,
            "serial_fps": frames / (total * batches / 1e3),
            "overlapped_fps": frames / (max(serial.values())
                                        * batches / 1e3)}


# ------------------------------------------------------------------ #
# The DVD authoring path: MPEG-2 export

def write_author_inputs(directory, width: int, height: int, frames: int,
                        seed: int = 5, name: str = "author_in"):
    """The authoring path's inputs in ``directory``: an interlaced
    YUV420P Y4M at 29.97 fps (``write_motion_y4m``) and a 48 kHz stereo
    s16 WAV of the same length (1602 samples a frame), ``name`` .y4m and
    .wav."""
    directory = Path(directory)
    src, wav = directory / f"{name}.y4m", directory / f"{name}.wav"
    write_motion_y4m(src, width, height, frames, seed, fps=AUTHOR_FPS)
    write_test_wav(wav, frames * AUTHOR_SPF, seed=seed, frame=AUTHOR_SPF)
    return src, wav


def author_golden_argv(case: str, directory, out) -> list:
    """The CLI arguments of an ``AUTHOR_GOLDEN`` case, writing ``out``
    and its suffix; its inputs are written into ``directory``."""
    kind, args, suffix = AUTHOR_GOLDEN[case]
    wav = Path(directory) / "author_golden_in.wav"
    if kind == "dvd.vob":
        src = MPEG_DATA / "dvd.vob"
    else:
        src = Path(directory) / "author_golden_in.y4m"
        if not src.exists():
            write_author_inputs(directory, AUTHOR_GOLDEN_W, AUTHOR_GOLDEN_H,
                                AUTHOR_GOLDEN_FRAMES,
                                name="author_golden_in")
    return ["-i", str(src), "-o", f"{out}{suffix}",
            *(a.replace("{wav}", str(wav)) for a in args)]


def _tensors_clone(args):
    """``args`` with every tensor cloned (nested tuples and lists kept)."""
    if hasattr(args, "data_ptr"):
        return args.clone()
    if isinstance(args, (tuple, list)):
        return type(args)(_tensors_clone(a) for a in args)
    return args


def _me_terms(h: int, w: int, r: int, nref: int) -> int:
    """Byte differences a motion search of an (h, w) plane needs: the
    candidates inside the plane of its exhaustive or coarse stage (8x8
    blocks of the decimated planes), then the 25 refine and 9 half-pel
    candidates of each macroblock, 256 each."""
    mbh, mbw = h // 16, w // 16
    if r <= 4:
        mb, plane_h, plane_w, rr, tail = 16, h, w, r, 9
    else:
        mb, plane_h, plane_w, rr, tail = 8, h // 2, w // 2, (r + 1) // 2, 34
    y0 = np.arange(mbh)[:, None] * mb
    x0 = np.arange(mbw)[None, :] * mb
    d = np.arange(-rr, rr + 1)
    oky = ((y0[..., None] + d >= 0)
           & (y0[..., None] + mb + d <= plane_h)).sum(-1)
    okx = ((x0[..., None] + d >= 0)
           & (x0[..., None] + mb + d <= plane_w)).sum(-1)
    return nref * int((oky * okx).sum() * mb * mb + mbh * mbw * tail * 256)


def _check_encode_kernels(torch, kernels, bench):
    """Phase 3 for the MPEG-2 encoder: every call of ``mpeg2_me``,
    ``mpeg2_enc_pred`` (and its ``mpeg2_enc_bmode`` entry) and
    ``mpeg2_enc_blocks`` while 720x480 frames of the authoring path's
    content encode at its settings, held against the plain versions on
    the same inputs; off the path the search at ``ENC_RANGES`` with one
    and two references on ragged planes and on a field of a frame (every
    other row, read in place), the prediction in P and B form, the block
    coder at qs 1, 2, 8 and 31 with and without alternate scan and MPEG-1
    and with an intra mask; then each timed at the path's shapes beside
    its plain version, its bound and, for the block coder, float64
    ``torch.matmul`` of its forward DCT."""
    from tcforge_tpu_torch.io import mpeg2enc
    from tcforge_tpu_torch.io.mpeg2codec import dct_basis
    from tcforge_tpu_torch.io.y4m import Y4MReader
    dev = bench.dev
    rng = np.random.default_rng(23)
    wrappers = ENCODE_KERNELS
    saved = {w: getattr(kernels, w) for w in wrappers}
    captured = {w: [] for w in wrappers}
    counts = dict.fromkeys(wrappers, 0)

    def checked(wrapper):
        fn, ref = saved[wrapper], getattr(kernels, wrapper + "_ref")

        def call(*a):
            got = fn(*a)
            bench.check(wrapper, "720x480 authoring", got, ref(*a),
                        quiet=True)
            counts[wrapper] += 1
            captured[wrapper].append((a, got))
            return got
        return call

    with tempfile.TemporaryDirectory(prefix="chip_smoke_enc_") as tmp:
        src = Path(tmp) / "enc.y4m"
        write_motion_y4m(src, AUTHOR_W, AUTHOR_H, ENC_CHECK_FRAMES, seed=9,
                         fps=AUTHOR_FPS)
        planes = [torch.from_numpy(p).to(dev)
                  for p in _read_y4m(Y4MReader, src)]
    enc = mpeg2enc.Mpeg2FullEncoder(AUTHOR_W, AUTHOR_H, 29.97, gop_n=15,
                                    gop_m=3, rate_control=True,
                                    bitrate_kbps=6000, qmin=2)
    try:
        for w in wrappers:
            setattr(kernels, w, checked(w))
        for i in range(ENC_CHECK_FRAMES):
            enc.push_frame(planes[0][i], planes[1][i], planes[2][i])
        enc.flush()
    finally:
        for w, fn in saved.items():
            setattr(kernels, w, fn)
    emit(phase="kernel_sweep", kernel="mpeg2_encode",
         frames=ENC_CHECK_FRAMES, cases=counts, max_abs_err=0)

    # off the path
    def smooth(h, w, seed, shift=(0, 0)):
        r = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:h, 0:w]
        base = (128 + 60 * np.sin((xx + shift[1]) / 7.0 + seed)
                + 50 * np.cos((yy + shift[0]) / 5.0))
        return torch.from_numpy(np.clip(base + r.normal(0, 6, (h, w)), 0,
                                        255).astype(np.uint8)).to(dev)

    def vectors(*shape):
        return torch.from_numpy(rng.integers(-40, 41, shape)
                                .astype(np.int32)).to(dev)

    cases = 0
    for h, w in ((16, 16), (48, 64), (64, 96), (480, 720)):
        mbh, mbw = h // 16, w // 16
        for content in ("smooth", "noise"):
            if content == "smooth":
                refs = (smooth(h, w, 1), smooth(h, w, 2))
                cur = smooth(h, w, 1, (3, -5))
            else:
                refs, cur = (bench.u8(h, w), bench.u8(h, w)), bench.u8(h, w)
            for r in ENC_RANGES:
                for n in (1, 2):
                    bench.check("mpeg2_me", f"{h}x{w} r{r} {content} {n}",
                                kernels.mpeg2_me(refs[:n], cur, r),
                                kernels.mpeg2_me_ref(refs[:n], cur, r),
                                quiet=True)
                    cases += 1
        y, u, v = (smooth(h, w, 3), smooth(h // 2, w // 2, 4),
                   bench.u8(h // 2, w // 2))
        fwd = (smooth(h, w, 5), bench.u8(h // 2, w // 2),
               smooth(h // 2, w // 2, 6))
        bwd = (bench.u8(h, w), smooth(h // 2, w // 2, 7),
               bench.u8(h // 2, w // 2))
        fmv, bmv = vectors(mbh, mbw, 2), vectors(mbh, mbw, 2)
        mode = torch.from_numpy(rng.integers(0, 3, (mbh, mbw))
                                .astype(np.int32)).to(dev)
        sads = [torch.from_numpy(rng.integers(0, 20000, (mbh, mbw))
                                 .astype(np.int32)).to(dev) for _ in (0, 1)]
        for args in ((fwd, fmv), (fwd, fmv, bwd, bmv, mode), (fwd[:1], fmv)):
            bench.check("mpeg2_enc_pred", f"{h}x{w} {len(args)} args",
                        kernels.mpeg2_enc_pred(*args),
                        kernels.mpeg2_enc_pred_ref(*args), quiet=True)
            cases += 1
        bargs = (fwd[0], bwd[0], fmv, sads[0], bmv, sads[1], y)
        bench.check("mpeg2_enc_bmode", f"{h}x{w}",
                    kernels.mpeg2_enc_bmode(*bargs),
                    kernels.mpeg2_enc_bmode_ref(*bargs), quiet=True)
        cases += 1
        pred = kernels.mpeg2_enc_pred_ref(fwd, fmv)
        intra_mb = torch.from_numpy(rng.random((mbh, mbw)) < 0.3).to(dev)
        # every setting at the small shapes; at 480x720 (the path's shape,
        # checked call by call on the path) the corners alone, to keep
        # the script inside its time limit
        full = h < 480
        for qs in ((1, 2, 8, 31) if full else (1, 31)):
            for alt in (False, True):
                for m1 in ((False, True) if full else (alt,)):
                    for args in ((0, (y, u, v), None, qs, alt, m1),
                                 (1, (y, u, v), pred, qs, alt, m1,
                                  intra_mb),
                                 (1, (y, u, v), pred, qs, alt, m1),
                                 (2, (y, u, v), pred, qs, alt, m1)):
                        bench.check("mpeg2_enc_blocks",
                                    f"{h}x{w} mode {args[0]} q{qs}",
                                    kernels.mpeg2_enc_blocks(*args),
                                    kernels.mpeg2_enc_blocks_ref(*args),
                                    quiet=True)
                        cases += 1
    # fields of a frame: every other row, read in place
    frame = smooth(128, 96, 8)
    top, bottom = frame[0::2], frame[1::2]
    cu, cv = smooth(64, 48, 9)[0::2], smooth(64, 48, 10)[1::2]
    for r in (4, 8):
        bench.check("mpeg2_me", f"field r{r}",
                    kernels.mpeg2_me((top,), bottom, r),
                    kernels.mpeg2_me_ref((top,), bottom, r), quiet=True)
    fargs = ((top, cu, cv), vectors(4, 6, 2))
    bench.check("mpeg2_enc_pred", "field", kernels.mpeg2_enc_pred(*fargs),
                kernels.mpeg2_enc_pred_ref(*fargs), quiet=True)
    bargs = (0, (bottom, cu, cv), None, 6, True, False)
    bench.check("mpeg2_enc_blocks", "field",
                kernels.mpeg2_enc_blocks(*bargs),
                kernels.mpeg2_enc_blocks_ref(*bargs), quiet=True)
    # 4:2:2 intra planes: eight blocks a macroblock
    for h, w in ((16, 16), (48, 64), (480, 720)):
        planes = (smooth(h, w, 11), smooth(h, w // 2, 12), bench.u8(h, w // 2))
        for qs in (1, 8, 31):
            args = (0, planes, None, qs, False, False)
            bench.check("mpeg2_enc_blocks", f"{h}x{w} 4:2:2 q{qs}",
                        kernels.mpeg2_enc_blocks(*args),
                        kernels.mpeg2_enc_blocks_ref(*args), quiet=True)
            cases += 1
    emit(phase="kernel_sweep", kernel="mpeg2_encode off the path",
         cases=cases + 4, max_abs_err=0)

    # the intra-only encoder (gop_n=1): the block coder under the pinned
    # writer, byte for byte the pinned numpy encoder's on the host
    from tcforge_tpu_torch.io.mpeg2host import Mpeg2Encoder
    pictures = 0
    for chroma, fields, qs in ((420, False, 5), (420, True, 1),
                               (422, False, 31)):
        kw = dict(qscale=qs, chroma=chroma, interlaced=fields)
        on_card = mpeg2enc.Mpeg2IntraEncoder(AUTHOR_W, AUTHOR_H, 29.97, **kw)
        on_host = Mpeg2Encoder(AUTHOR_W, AUTHOR_H, 29.97, **kw)
        ch = AUTHOR_H if chroma == 422 else AUTHOR_H // 2
        code = "encode_frame_fields" if fields else "encode_frame"
        for i in range(2):
            frame = (smooth(AUTHOR_H, AUTHOR_W, 13 + i),
                     smooth(ch, AUTHOR_W // 2, 15 + i),
                     bench.u8(ch, AUTHOR_W // 2))
            got = getattr(on_card, code)(*frame, with_seq=i == 0)
            want = getattr(on_host, code)(*(p.cpu().numpy() for p in frame),
                                          with_seq=i == 0)
            check(got == want, f"the intra-only encoder's picture ({chroma}"
                               f", fields {fields}, q{qs}) differs from "
                               "the pinned numpy encoder's")
            pictures += 1
    emit(phase="intra_encoder_vs_numpy", pictures=pictures, identical=True)

    # timed at the path's shapes, the captured calls in turn (more than
    # L2 together)
    def rotation(calls):
        inputs = [a for a, _ in calls]
        while sum(_nbytes(*_flat_tensors(a)) for a in inputs) < L2_BYTES:
            inputs = inputs + [_tensors_clone(a) for a in inputs]
        return inputs

    batches = ENC_CHECK_FRAMES / MAIN_BATCH
    for nref, label in ((1, "P"), (2, "B")):
        calls = [c for c in captured["mpeg2_me"] if len(c[0][0]) == nref]
        check(bool(calls), f"no {label} motion search was captured")
        bench.record("mpeg2_me", f"720x480 {label}", len(calls) / batches,
                     lambda *a: kernels.mpeg2_me(*a),
                     lambda *a: kernels.mpeg2_me_ref(*a), rotation(calls),
                     nbytes=_nbytes(*_flat_tensors(calls[0])),
                     ops=_me_terms(AUTHOR_H, AUTHOR_W, 8, nref)
                     / SADS_PER_OP)
    for bi, label in ((False, "P"), (True, "B")):
        calls = [c for c in captured["mpeg2_enc_pred"]
                 if (len(c[0]) > 2) == bi]
        check(bool(calls), f"no {label} prediction was captured")
        bench.record("mpeg2_enc_pred", f"720x480 {label}",
                     len(calls) / batches,
                     lambda *a: kernels.mpeg2_enc_pred(*a),
                     lambda *a: kernels.mpeg2_enc_pred_ref(*a),
                     rotation(calls),
                     nbytes=_nbytes(*_flat_tensors(calls[0])), ops=0)
    calls = captured["mpeg2_enc_bmode"]
    check(bool(calls), "no B mode decision was captured")
    bench.record("mpeg2_enc_bmode", "720x480", len(calls) / batches,
                 lambda *a: kernels.mpeg2_enc_bmode(*a),
                 lambda *a: kernels.mpeg2_enc_bmode_ref(*a),
                 rotation(calls), nbytes=_nbytes(*_flat_tensors(calls[0])),
                 ops=0)
    kmat = torch.from_numpy(np.kron(dct_basis(), dct_basis())).to(dev)
    for mode, label in ((0, "I"), (1, "P"), (2, "B")):
        calls = [c for c in captured["mpeg2_enc_blocks"] if c[0][0] == mode]
        check(bool(calls), f"no {label} block coding was captured")
        ins = rotation(calls)
        levels = calls[0][1][0]
        blocks = levels.shape[0] * 6
        coded = int((levels != 0).any(dim=2).sum())
        recon = 0 if mode == 2 else blocks if mode == 0 else coded
        bench.record("mpeg2_enc_blocks", f"720x480 {label}",
                     len(calls) / batches,
                     lambda *a: kernels.mpeg2_enc_blocks(*a),
                     lambda *a: kernels.mpeg2_enc_blocks_ref(*a), ins,
                     nbytes=_nbytes(*_flat_tensors(calls[0])),
                     ops=1024 * (blocks + recon),
                     library=(lambda c: torch.matmul(c, kmat),
                              [(torch.cat([p.reshape(-1, 64) for p in
                                           _flat_tensors(a[1])])
                                .to(torch.float64),) for a in ins]),
                     ops_per_s=F64_FMA_PER_S)


def _author_argv(src, wav, out) -> list:
    return ["-i", str(src), "-p", str(wav), "-o", str(out), *AUTHOR_ARGS,
            "--batch", str(MAIN_BATCH), "--device", "cuda", "--progress_off",
            "-q"]


def _run_dvdauthor(torch, cli, kernels, tmp):
    """Phase 4 for the DVD authoring path: 1080i with its WAV through the
    port's CLI to a 720x480 program stream, the launch counts set to 0
    just before and read just after (the encoder's three kernels, the
    zoom's and hqdn3d's), its bytes equal to the same CLI's on the plain
    versions on the card; the program stream read back by the port's
    MPEG importer on the card: every frame at 720x480, the LPCM track the
    WAV's samples.  Returns the launches."""
    from tcforge_tpu_torch.io.wav import WavReader
    src, wav = write_author_inputs(tmp, MAIN_W, MAIN_H, AUTHOR_FRAMES)
    out = tmp / "author.mpg"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(_author_argv(src, wav, out))
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(rc == 0, f"dvdauthor: CLI exit code {rc}")
    emit(phase="path", path="dvdauthor", frames=AUTHOR_FRAMES,
         seconds=e2e_s, e2e_fps=AUTHOR_FRAMES / e2e_s,
         bytes=out.stat().st_size,
         launches={k: launches[k] for k in AUTHOR_KERNELS})
    for name in AUTHOR_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  "dvdauthor path")
    plain = tmp / "author_plain.mpg"
    with plain_versions(kernels):
        rc = cli.main(_author_argv(src, wav, plain))
    check(rc == 0, f"dvdauthor on the plain versions: exit code {rc}")
    same = out.read_bytes() == plain.read_bytes()
    emit(phase="path_vs_plain", path="dvdauthor", identical=same,
         sha256=sha256_file(out))
    check(same, "dvdauthor: the kernels' program stream differs from the "
                "plain versions' on the card")
    back, back_wav = tmp / "author_back.y4m", tmp / "author_back.wav"
    # the whole-file demux: each batch's video (about 600 KB here) comes
    # before its audio, past the windowed demux's discovery budget
    rc = cli.main(["-i", str(out), "-x", "mpeg=stream=0", "-o", str(back),
                   "-m", str(back_wav), "--device", "cuda", "--progress_off",
                   "-q"])
    check(rc == 0, f"dvdauthor read back: exit code {rc}")
    with open(back, "rb") as f:
        header = f.readline()
        frames = f.read().count(b"FRAME\n")
    with WavReader(str(wav)) as r:
        want = r.read_samples(r.total_samples)
    with WavReader(str(back_wav)) as r:
        got = r.read_samples(r.total_samples)
        got = got if got is not None else np.zeros((0, 2), np.int16)
    ok = (f" W{AUTHOR_W} H{AUTHOR_H} ".encode() in header
          and frames == AUTHOR_FRAMES
          and got.shape[1] == 2 and got.shape[0] > 0
          and np.array_equal(got, want[:got.shape[0]]))
    emit(phase="dvdauthor_read_back", frames=frames,
         header=header.decode().strip(), lpcm_samples=int(got.shape[0]),
         wav_samples=int(want.shape[0]), lpcm_equal=ok)
    check(ok, "dvdauthor: the program stream does not read back as its "
              "frames at 720x480 with the WAV's samples")
    for f in (src, wav, plain, back, back_wav):
        f.unlink()
    return launches


def _author_goldens(cli, tmp):
    """Phase 5 for MPEG-2 export: every ``AUTHOR_GOLDEN`` case on the
    card, its SHA-256 against the JAX CLI's pinned digest."""
    from tcforge_tpu_torch.ops import kernels
    for case in AUTHOR_GOLDEN:
        argv = author_golden_argv(case, tmp, tmp / f"author_golden_{case}")
        kernels.reset_launches()
        rc = cli.main([*argv, "--device", "cuda", "--progress_off", "-q"])
        if case in ("identity", "intra", "intra422"):
            # the identity chain has no filter and no transform: the
            # frames go to the card all the same, for the encoder; intra
            # only codes its blocks there
            names = (ENCODE_KERNELS if case == "identity"
                     else ("mpeg2_enc_blocks",))
            launched = {k: kernels.launches[k] for k in names}
            emit(phase="launches", path=f"author_{case}",
                 launches=launched)
            check(all(launched.values()), f"the {case} encode did not "
                                          f"launch {launched}")
        digest = sha256_file(argv[argv.index("-o") + 1])
        emit(phase="golden", path=f"author_{case}", sha256=digest,
             pinned=AUTHOR_GOLDEN_SHA256[case])
        check(rc == 0 and digest == AUTHOR_GOLDEN_SHA256[case],
              f"author {case} golden output differs from the JAX-pinned "
              "digest")


def encode_stages(torch, cli, argv, frames: int) -> dict:
    """An encoding CLI (``argv``) twice more, per 16-frame batch.  First
    with the encoder's and the multiplexor's calls timed inside it (host
    clocks, wrappers around the module's functions): queueing each picture's
    kernels and torch ops (``encode_*_math``), the syntax writer
    (``m2e_picture``), the wait for and the copy of the picture's levels
    and records with the rate controller's arithmetic (the rest of
    ``_emit``), and the program stream multiplexor (on the writer
    thread).  Then under torch.profiler: the device's busy time in the
    run, and the encoder's kernels' share of it (the search, the
    prediction with the B modes, the block coder)."""
    from torch.profiler import ProfilerActivity, profile

    from tcforge_tpu_torch.io import mpeg2enc
    from tcforge_tpu_torch.modules.muxers import ps_mux
    ms = dict.fromkeys(("queue", "emit", "writer", "mux"), 0.0)

    def timed(fn, key):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                ms[key] += (time.perf_counter() - t0) * 1e3
        return call

    cls, mux = mpeg2enc.Mpeg2FullEncoder, ps_mux.MpegPsMuxer
    patched = [(mpeg2enc, name, "queue") for name in
               ("encode_intra_math", "encode_p_math", "encode_b_math")]
    patched += [(mpeg2enc, "m2e_picture", "writer"), (cls, "_emit", "emit"),
                (mux, "write_video", "mux"), (mux, "write_audio", "mux")]
    saved = [getattr(owner, name) for owner, name, _ in patched]
    for owner, name, key in patched:
        setattr(owner, name, timed(getattr(owner, name), key))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        for (owner, name, _), fn in zip(patched, saved):
            setattr(owner, name, fn)
    check(rc == 0, f"encode_stages: exit code {rc}")
    batches = frames / MAIN_BATCH
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rc = cli.main(argv)
        torch.cuda.synchronize()
    check(rc == 0, f"encode_stages under the profiler: exit code {rc}")
    busy = _device_busy(prof, batches, ("me_kernel", "pred_kernel",
                                        "bmode_kernel", "blocks_kernel"))
    return {"frames": frames, "fps": frames / seconds,
            "ms_per_batch": {"queue": ms["queue"] / batches,
                             "download": (ms["emit"] - ms["writer"])
                             / batches,
                             "writer": ms["writer"] / batches,
                             "mux": ms["mux"] / batches},
            "device_busy_ms_per_batch": busy["busy_ms_per_batch"],
            "encoder_kernels_ms_per_batch": busy["named_ms_per_batch"],
            "device_kernels_ms_per_batch": busy["kernels_ms_per_batch"]}


def _author_rates(torch, cli, tmp):
    """Phase 6 for the DVD authoring path: its CLI on AUTHOR_RATE_FRAMES
    frames of 1080i with the WAV, wall clock to the last byte, after one
    untimed run, six runs (median and spread); then ``encode_stages``."""
    src, wav = write_author_inputs(tmp, MAIN_W, MAIN_H, AUTHOR_RATE_FRAMES,
                                   seed=6)
    out = tmp / "author_rate.mpg"
    fps = []
    for r in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(_author_argv(src, wav, out))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"dvdauthor CLI: exit code {rc}")
        if r:
            fps.append(AUTHOR_RATE_FRAMES / seconds)
    emit(phase="cli", path="dvdauthor", frames=AUTHOR_RATE_FRAMES, fps=fps,
         median_fps=float(np.median(fps)), min_fps=min(fps),
         max_fps=max(fps))
    emit(phase="stages", path="dvdauthor",
         **encode_stages(torch, cli, _author_argv(src, wav, out),
                         AUTHOR_RATE_FRAMES))
    for f in (src, wav, out):
        f.unlink()


# ---------------------------------------------------------------------- #
# The 4:2:2 path: the 422P encode, whose encoder kernels run their 4:2:2
# forms, and its read-back, whose reconstruction kernels run theirs

# phase 3 off the path: macroblock grids (mb_w, mb_h), among them
# 720x576's coded grid and grids of one macroblock row or column
# (the path's 45x36 grid, 720x576, is checked call by call on the path;
# off the path it was cut to keep the script inside its time limit)
M422_GRIDS = ((1, 1), (3, 5), (7, 1), (1, 3))
# phase 3 on the path: frames of the path's content encoded and read back
# with every kernel call checked
M422_CHECK_FRAMES = 16


def _records_422(rng, nmb: int, field: bool) -> np.ndarray:
    """Random macroblock records (int32 (nmb, 12)) of a picture: every mix
    of the intra, forward, backward, field-DCT, field-MV (frame pictures)
    or 16x8 (field pictures) and dual-prime flags, vectors near and far
    past every edge of a 720x576 picture, random field selects; dual
    prime's differential vectors in -1..1."""
    info = np.zeros((nmb, 12), np.int32)
    flags = np.zeros(nmb, np.int32)
    for bit in ((1, 2, 4, 64, 128) if field else (1, 2, 4, 16, 32, 64)):
        flags |= np.where(rng.random(nmb) < 0.4, bit, 0).astype(np.int32)
    info[:, 0] = flags
    far = rng.integers(-1600, 1601, (nmb, 8))
    near = rng.integers(-40, 41, (nmb, 8))
    info[:, 1:9] = np.where(rng.random((nmb, 8)) < 0.3, far, near)
    dual = (flags & 64) != 0
    info[dual, 3:5] = rng.integers(-1, 2, (int(dual.sum()), 2))
    info[:, 9] = rng.integers(0, 16, nmb)
    return info


def _sparse_coefs(torch, rng, dev, *shape):
    """Random int32 coefficient grids, about 30 % of them nonzero."""
    c = rng.integers(-60, 61, shape).astype(np.int32)
    c[rng.random(shape) < 0.7] = 0
    return torch.from_numpy(c).to(dev)


def _check_422_off_path(torch, kernels, bench, rng) -> dict:
    """The four 4:2:2 forms against their plain versions on random inputs
    at ``M422_GRIDS``: ``mpeg2_recon`` in frame pictures (forward, both
    and no reference, either field first) and field pictures (either
    parity, reference fields of other heights read in place as a
    frame's lines of one parity), ``mpeg2_idct_intra`` with random
    field-DCT macroblocks (one picture and three), ``mpeg2_enc_pred``
    in P and B form with vectors past every edge, ``mpeg2_enc_blocks``
    in its three modes (P with an intra mask) at qs 1, 8 and 31 with and
    without alternate scan.  Returns the cases by form."""
    dev = bench.dev
    cases = dict.fromkeys(FORMS_422, 0)

    def u8planes(rows, cols):
        return (bench.u8(rows, cols), bench.u8(rows, cols // 2),
                bench.u8(rows, cols // 2))

    def fields(rows, cols):
        fr = u8planes(rows, cols)
        return (tuple(p[0::2] for p in fr), tuple(p[1::2] for p in fr))

    for mb_w, mb_h in M422_GRIDS:
        grid = f"{mb_w}x{mb_h}"
        h, w = 16 * mb_h, 16 * mb_w
        yc = _sparse_coefs(torch, rng, dev, 2 * mb_h, 2 * mb_w, 64)
        uc = _sparse_coefs(torch, rng, dev, 2 * mb_h, mb_w, 64)
        vc = _sparse_coefs(torch, rng, dev, 2 * mb_h, mb_w, 64)
        for field in (False, True):
            mbinfo = torch.from_numpy(
                _records_422(rng, mb_h * mb_w, field)).to(dev)
            if field:
                forms = [(fields(2 * h, w), None, p, True) for p in (0, 1)]
                forms.append((fields(2 * h + 6, w), fields(2 * h - 2, w),
                              1, True))
            else:
                forms = [(u8planes(h, w), None, None, tff)
                         for tff in (True, False)]
                forms += [(u8planes(h, w), u8planes(h, w), None, False),
                          (None, None, None, True)]
            for fwd, bwd, parity, tff in forms:
                args = (yc, uc, vc, mbinfo, fwd, bwd, tff)
                kw = dict(field_parity=parity, chroma=2)
                bench.check("mpeg2_recon_422",
                            f"{grid} {'field' if field else 'frame'}",
                            kernels.mpeg2_recon(*args, **kw),
                            kernels.mpeg2_recon_ref(*args, **kw),
                            quiet=True)
                cases["mpeg2_recon_422"] += 1
        for n in (1, 3):
            fd = torch.from_numpy(rng.random((n, mb_h, mb_w)) < 0.5).to(dev)
            for bw in (2 * mb_w, mb_w):
                coef = _sparse_coefs(torch, rng, dev, n, 2 * mb_h, bw, 64)
                bench.check("mpeg2_idct_intra_422", f"{grid} n{n} bw{bw}",
                            kernels.mpeg2_idct_intra(coef, field_dct=fd),
                            kernels.mpeg2_idct_intra_ref(coef, field_dct=fd),
                            quiet=True)
                cases["mpeg2_idct_intra_422"] += 1
        fwd, bwd = u8planes(h, w), u8planes(h, w)

        def vectors():
            far = rng.integers(-4 * h - 64, 4 * h + 65, (mb_h, mb_w, 2))
            near = rng.integers(-33, 34, (mb_h, mb_w, 2))
            return torch.from_numpy(np.where(rng.random((mb_h, mb_w, 1))
                                             < 0.3, far, near)
                                    .astype(np.int32)).to(dev)

        mode = torch.from_numpy(rng.integers(0, 3, (mb_h, mb_w))
                                .astype(np.int32)).to(dev)
        for args in ((fwd, vectors()),
                     (fwd, vectors(), bwd, vectors(), mode)):
            bench.check("mpeg2_enc_pred_422", f"{grid} {len(args)} args",
                        kernels.mpeg2_enc_pred(*args),
                        kernels.mpeg2_enc_pred_ref(*args), quiet=True)
            cases["mpeg2_enc_pred_422"] += 1
        cur, pred = u8planes(h, w), u8planes(h, w)
        intra_mb = torch.from_numpy(rng.random((mb_h, mb_w)) < 0.3).to(dev)
        for qs in (1, 8, 31):
            for alt in (False, True):
                for args in ((0, cur, None, qs, alt, False),
                             (1, cur, pred, qs, alt, False, intra_mb),
                             (1, cur, pred, qs, alt, False),
                             (2, cur, pred, qs, alt, False)):
                    bench.check("mpeg2_enc_blocks_422",
                                f"{grid} mode {args[0]} q{qs}",
                                kernels.mpeg2_enc_blocks(*args),
                                kernels.mpeg2_enc_blocks_ref(*args),
                                quiet=True)
                    cases["mpeg2_enc_blocks_422"] += 1
    return cases


def _check_mpeg422_kernels(torch, kernels, bench, tmp):
    """Phase 3 for the 4:2:2 forms: ``_check_422_off_path``; then
    ``M422_CHECK_FRAMES`` frames of the path's content at 720x576 4:2:2
    through ``Mpeg2FullEncoder`` at the path's settings and the stream
    read back by the importer on the card, every call of the four
    kernels held against its plain version on the same inputs (the
    search and the B modes too, which see luma only); then each 4:2:2
    form timed at the path's shapes beside its plain version, its bound
    and ``torch.matmul`` of its IDCT or DCT part."""
    from tcforge_tpu_torch.io import mpeg2enc
    from tcforge_tpu_torch.io.mpeg2codec import dct_basis, idct_kron
    from tcforge_tpu_torch.io.y4m import Y4MReader
    dev = bench.dev
    rng = np.random.default_rng(29)
    cases = _check_422_off_path(torch, kernels, bench, rng)

    # on the path: the encode, then its read-back, every call checked
    form_of = {"mpeg2_enc_pred": "mpeg2_enc_pred_422",
               "mpeg2_enc_blocks": "mpeg2_enc_blocks_422",
               "mpeg2_recon": "mpeg2_recon_422",
               "mpeg2_idct_intra": "mpeg2_idct_intra_422"}
    wrappers = (*ENCODE_KERNELS, "mpeg2_recon", "mpeg2_idct_intra")
    saved = {w: getattr(kernels, w) for w in wrappers}
    captured = {w: [] for w in wrappers}

    def checked(wrapper):
        fn, ref = saved[wrapper], getattr(kernels, wrapper + "_ref")

        def call(*a, **kw):
            got = fn(*a, **kw)
            bench.check(form_of.get(wrapper, wrapper), "720x576 4:2:2 path",
                        got, ref(*a, **kw), quiet=True)
            captured[wrapper].append((a, kw, got))
            return got
        return call

    src = Path(tmp) / "m422_check.y4m"
    write_motion_y4m(src, MPEG422_W, MPEG422_H, M422_CHECK_FRAMES, seed=9,
                     fps=MPEG422_FPS, chroma=422)
    planes = [torch.from_numpy(p).to(dev) for p in _read_y4m(Y4MReader, src)]
    stream = Path(tmp) / "m422_check.m2v"
    enc = mpeg2enc.Mpeg2FullEncoder(MPEG422_W, MPEG422_H, 25.0, gop_n=12,
                                    gop_m=3, rate_control=True,
                                    bitrate_kbps=15000, chroma=422)
    try:
        for w in wrappers:
            setattr(kernels, w, checked(w))
        with open(stream, "wb") as f:
            for i in range(M422_CHECK_FRAMES):
                f.write(enc.push_frame(planes[0][i], planes[1][i],
                                       planes[2][i]))
            f.write(enc.flush())
        from tcforge_tpu_torch.core.formats import ImageFormat
        from tcforge_tpu_torch.core.job import Job
        imp = _mpeg_importer(stream, dev,
                             job=Job(im_colorspace=ImageFormat.YUV422P))
        frames = 0
        while True:
            got = imp.read_video_batch(MAIN_BATCH)
            if got is None:
                break
            frames += got["y"].shape[0]
        imp.close()
    finally:
        for w, fn in saved.items():
            setattr(kernels, w, fn)
    check(frames == M422_CHECK_FRAMES,
          f"the 4:2:2 check stream read back {frames} frames")
    emit(phase="kernel_sweep", kernel="4:2:2 forms", off_path=cases,
         on_path={w: len(c) for w, c in captured.items()}, max_abs_err=0)
    for w in wrappers:
        check(bool(captured[w]), f"the 4:2:2 check made no {w} call")

    # timed at the path's shapes: its calls in turn (more than L2 together)
    def rotation(calls):
        inputs = [(a, kw) for a, kw, _ in calls]
        while sum(_nbytes(*_flat_tensors(a)) for a, _ in inputs) < L2_BYTES:
            inputs = inputs + [(_tensors_clone(a), kw) for a, kw in inputs]
        return [(*a, kw) for a, kw in inputs]

    def with_kw(fn):
        return lambda *a: fn(*a[:-1], **a[-1])

    batches = M422_CHECK_FRAMES / MAIN_BATCH
    kmat = torch.from_numpy(idct_kron()).to(dev)
    calls = captured["mpeg2_recon"]
    inter = [c for c in calls if c[0][4] is not None]
    check(len(inter) >= 4, f"the 4:2:2 stream gave {len(inter)} P and B "
                           "reconstructions")
    bench.record("mpeg2_recon_422", "720x576 P and B pictures",
                 len(calls) / batches,
                 with_kw(kernels.mpeg2_recon), with_kw(kernels.mpeg2_recon_ref),
                 rotation(inter),
                 nbytes=sum(_recon_bytes(a) for a, _, _ in inter) / len(inter),
                 ops=sum(64 * int(sum(int((c != 0).sum()) for c in a[:3]))
                         for a, _, _ in inter) / len(inter),
                 library=(lambda c: torch.matmul(c, kmat),
                          [(torch.cat([c.reshape(-1, 64) for c in a[:3]])
                            .to(torch.float32),) for a, _, _ in inter]),
                 plain_reps=2, ops_per_s=F32_FMA_PER_S)
    calls = captured["mpeg2_idct_intra"]
    kmat64 = kmat.to(torch.float64)
    for label, group in (("720x576 intra Y", calls[0::3]),
                         ("360x576 intra U, V", calls[1::3] + calls[2::3])):
        ins = rotation(group)
        c0 = ins[0][0]
        blocks = c0.numel() // 64
        bench.record("mpeg2_idct_intra_422", label,
                     len(group) / batches, with_kw(kernels.mpeg2_idct_intra),
                     with_kw(kernels.mpeg2_idct_intra_ref), ins,
                     nbytes=_nbytes(*_flat_tensors(ins[0][:-1]),
                                    *_flat_tensors(list(ins[0][-1].values())))
                     + blocks * 64,
                     ops=1024 * blocks,
                     library=(lambda c: torch.matmul(c, kmat64),
                              [(a[0].reshape(-1, 64).to(torch.float64),)
                               for a in ins]),
                     plain_reps=2, ops_per_s=F64_FMA_PER_S)
    for bi, label in ((False, "P"), (True, "B")):
        group = [c for c in captured["mpeg2_enc_pred"]
                 if (len(c[0]) > 2) == bi]
        check(bool(group), f"no 4:2:2 {label} prediction was captured")
        bench.record("mpeg2_enc_pred_422", f"720x576 {label}",
                     len(group) / batches, with_kw(kernels.mpeg2_enc_pred),
                     with_kw(kernels.mpeg2_enc_pred_ref), rotation(group),
                     nbytes=_nbytes(*_flat_tensors((group[0][0],
                                                    group[0][2]))), ops=0)
    kmat_enc = torch.from_numpy(np.kron(dct_basis(), dct_basis())).to(dev)
    for mode, label in ((0, "I"), (1, "P"), (2, "B")):
        group = [c for c in captured["mpeg2_enc_blocks"] if c[0][0] == mode]
        check(bool(group), f"no 4:2:2 {label} block coding was captured")
        ins = rotation(group)
        levels = group[0][2][0]
        blocks = levels.shape[0] * levels.shape[1]
        coded = int((levels != 0).any(dim=2).sum())
        recon = 0 if mode == 2 else blocks if mode == 0 else coded
        bench.record("mpeg2_enc_blocks_422", f"720x576 {label}",
                     len(group) / batches, with_kw(kernels.mpeg2_enc_blocks),
                     with_kw(kernels.mpeg2_enc_blocks_ref), ins,
                     nbytes=_nbytes(*_flat_tensors((group[0][0],
                                                    group[0][2]))),
                     ops=1024 * (blocks + recon),
                     library=(lambda c: torch.matmul(c, kmat_enc),
                              [(torch.cat([p.reshape(-1, 64) for p in
                                           _flat_tensors(a[1])])
                                .to(torch.float64),) for a in ins]),
                     ops_per_s=F64_FMA_PER_S)
    stream.unlink()
    src.unlink()


def mpeg422_input(directory, seed: int = 21):
    """The 4:2:2 path's source in ``directory``: MPEG422_FRAMES frames of
    1080i 4:2:2 at 25 fps (``write_motion_y4m`` with ``chroma`` 422)."""
    frames = MPEG422_FRAMES
    src = Path(directory) / f"m422_in_{frames}.y4m"
    if not src.exists():
        write_motion_y4m(src, MAIN_W, MAIN_H, frames, seed, fps=MPEG422_FPS,
                         chroma=422)
    return src


def _m422_argv(src, out, args) -> list:
    return ["-i", str(src), "-o", str(out), *args, "--batch",
            str(MAIN_BATCH), "--device", "cuda", "--progress_off", "-q"]


def _pass_logs_read(mpeg2enc):
    """A context that records the complexities each rate controller the
    encoder builds was given (pass 2 reads them from the log)."""
    got = []
    real = mpeg2enc.RateController

    def spy(*a, **kw):
        got.append(kw.get("complexities"))
        return real(*a, **kw)

    @contextlib.contextmanager
    def ctx():
        mpeg2enc.RateController = spy
        try:
            yield got
        finally:
            mpeg2enc.RateController = real
    return ctx()


def _run_mpeg422(torch, cli, kernels, tmp):
    """Phase 4 for the 4:2:2 path: the encode of MPEG422_FRAMES frames of
    1080i 4:2:2 through the port's CLI, then its read-back kept at 4:2:2
    and decimated to 4:2:0, each with the launch counts set to 0 just
    before and read just after; the field-picture encode and the -R 1 /
    -R 2 pair on the first MPEG422_SHORT_FRAMES frames, and the field
    stream's read-back; every CLI's bytes (and the pass log) equal to the
    same CLI's on the plain versions on the card; every decoded frame
    720x576 in the right format and count, and pass 2's log read.
    Returns the launches of the encode, and of the decodes."""
    from tcforge_tpu_torch.io import mpeg2enc
    tmp = Path(tmp)
    src = mpeg422_input(tmp)
    short = ["--max_frames", str(MPEG422_SHORT_FRAMES)]
    log = tmp / "m422_pass.log"
    runs = [  # name, input, arguments, frames out, kernels counted
        ("encode", src, MPEG422_ENC, MPEG422_FRAMES, "encode"),
        ("keep", "encode", MPEG422_KEEP, MPEG422_FRAMES, "keep"),
        ("decimate", "encode", MPEG422_DECIMATE, MPEG422_FRAMES, "decimate"),
        ("fields", src, [*MPEG422_ENC[:-1], MPEG422_GOP + ":fields=1",
                         *short], MPEG422_SHORT_FRAMES, None),
        ("keep_fields", "fields", MPEG422_KEEP, MPEG422_SHORT_FRAMES, None),
        ("pass1", src, [*MPEG422_ENC, *short, "-R", f"1,{log}"],
         MPEG422_SHORT_FRAMES, None),
        ("pass2", src, [*MPEG422_ENC, *short, "-R", f"2,{log}"],
         MPEG422_SHORT_FRAMES, None)]
    launches, outs = {}, {}
    for name, inp, args, frames, counted in runs:
        if not isinstance(inp, Path):
            inp = outs[inp]["kernels"]
        suffix = ".m2v" if inp == src else ".y4m"
        got = {}
        for label, ctx in (("kernels", contextlib.nullcontext()),
                           ("plain", plain_versions(kernels))):
            out = tmp / f"m422_{name}_{label}{suffix}"
            with ctx, _pass_logs_read(mpeg2enc) as rcs:
                torch.cuda.synchronize()
                kernels.reset_launches()
                t0 = time.perf_counter()
                rc = cli.main(_m422_argv(inp, out, args))
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            check(rc == 0, f"mpeg422 {name} on the {label}: exit code {rc}")
            got[label] = out
            if name == "pass1":
                got[label + "_log"] = log.read_bytes()
            if name == "pass2":
                read = [c for c in rcs if c is not None]
                want = len(log.read_text().splitlines())
                emit(phase="mpeg422_pass2_log", versions=label,
                     complexities=[len(c) for c in read], log_lines=want)
                check(len(read) == 1 and len(read[0]) == want > 0,
                      "mpeg422 pass 2 did not read pass 1's log")
            if label == "kernels":
                counts = dict(kernels.launches)
                emit(phase="path", path=f"mpeg422_{name}", frames=frames,
                     seconds=seconds, e2e_fps=frames / seconds,
                     bytes=out.stat().st_size,
                     launches={k: counts[k] for k in
                               MPEG422_KERNELS[counted or
                                               ("encode" if suffix == ".m2v"
                                                else "keep")]})
                if counted:
                    launches[counted] = counts
                    for k in MPEG422_KERNELS[counted]:
                        check(counts[k] > 0, f"kernel {k} was not launched "
                                             f"by the mpeg422 {name} run")
        outs[name] = got
        same = (got["kernels"].read_bytes() == got["plain"].read_bytes()
                and got.get("kernels_log") == got.get("plain_log"))
        emit(phase="path_vs_plain", path=f"mpeg422_{name}", identical=same,
             sha256=sha256_file(got["kernels"]))
        check(same, f"mpeg422 {name}: the kernels' output differs from the "
                    "plain versions' on the card")
        if suffix == ".y4m":
            with open(got["kernels"], "rb") as f:
                header = f.readline()
                count = f.read().count(b"FRAME\n")
            csp = b" C422" if name.startswith("keep") else b" C420"
            ok = (f" W{MPEG422_W} H{MPEG422_H} ".encode() in header
                  and csp in header and count == frames)
            emit(phase="mpeg422_read_back", path=name, frames=count,
                 header=header.decode().strip(), ok=ok)
            check(ok, f"mpeg422 {name}: {count} frames, header {header!r}")
    for got in outs.values():
        for f in got.values():
            if isinstance(f, Path):
                f.unlink()
    return launches


def _mpeg422_goldens(cli, tmp):
    """Phase 5 for the 4:2:2 path: every ``MPEG422_GOLDEN`` case on the
    card, in order, its SHA-256 against the JAX CLI's pinned digest."""
    for case in MPEG422_GOLDEN:
        argv = mpeg422_golden_argv(case, tmp, "card")
        rc = cli.main([*argv, "--device", "cuda", "--progress_off", "-q"])
        digest = sha256_file(argv[argv.index("-o") + 1])
        emit(phase="golden", path=f"mpeg422_{case}", sha256=digest,
             pinned=MPEG422_GOLDEN_SHA256[case])
        check(rc == 0 and digest == MPEG422_GOLDEN_SHA256[case],
              f"mpeg422 {case} golden output differs from the JAX-pinned "
              "digest")


def _mpeg422_rates(torch, dev, cli, tmp, runs: int = 3):
    """Phase 6 for the 4:2:2 path: the encode CLI and the two read-back
    CLIs on MPEG422_FRAMES frames, wall clock to the last byte, after one
    untimed run, ``runs`` runs each in turns (median, min and max); then
    the encode's stages (``encode_stages``: queueing, the wait and copy
    of each picture's levels, the writer; the device's busy time and
    the encoder kernels' share), each read-back's serial stages
    (``mpeg_stages``) and, under torch.profiler, the device's busy time
    in a read-back CLI run and the reconstruction kernels' share."""
    from torch.profiler import ProfilerActivity, profile
    from tcforge_tpu_torch.core.formats import ImageFormat
    from tcforge_tpu_torch.core.job import FilterSpec, Job
    tmp = Path(tmp)
    src = mpeg422_input(tmp)
    stream = tmp / "m422_rate.m2v"
    argvs = {"encode": _m422_argv(src, stream, MPEG422_ENC),
             "keep": _m422_argv(stream, tmp / "m422_keep.y4m",
                                MPEG422_KEEP),
             "decimate": _m422_argv(stream, tmp / "m422_dec.y4m",
                                    MPEG422_DECIMATE)}
    fps = {name: [] for name in argvs}
    for r in range(runs + 1):
        for name, argv in argvs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            check(rc == 0, f"mpeg422 {name} CLI: exit code {rc}")
            if r:
                fps[name].append(MPEG422_FRAMES / seconds)
    for name, got in fps.items():
        emit(phase="cli", path=f"mpeg422_{name}", frames=MPEG422_FRAMES,
             fps=got, median_fps=float(np.median(got)), min_fps=min(got),
             max_fps=max(got))
    emit(phase="stages", path="mpeg422_encode",
         **encode_stages(torch, cli, argvs["encode"], MPEG422_FRAMES))
    batches = MPEG422_FRAMES / MAIN_BATCH
    for name, job in (
            ("keep", Job(filters=[FilterSpec("denoise3d", "")],
                         im_colorspace=ImageFormat.YUV422P)),
            ("decimate", Job(filters=[FilterSpec("hqdn3d", "luma=4.0")]))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rc = cli.main(argvs[name])
            torch.cuda.synchronize()
        check(rc == 0, f"mpeg422 {name} under the profiler: exit code {rc}")
        busy = _device_busy(prof, batches, ("recon_kernel",
                                            "idct_intra_kernel"))
        emit(phase="stages", path=f"mpeg422_{name}",
             device_busy_ms_per_batch=busy["busy_ms_per_batch"],
             decode_kernels_ms_per_batch=busy["named_ms_per_batch"],
             device_kernels_ms_per_batch=busy["kernels_ms_per_batch"],
             serial=mpeg_stages(torch, dev, stream, tmp / "m422_stages.y4m",
                                job))
    for f in tmp.glob("m422_*"):
        f.unlink()


# ---------------------------------------------------------------------- #
# The DivX path: -x avi on divx.avi (MPEG-4 part 2 with a PCM track), the
# host parse, mpeg4_recon / mpeg4_idct_intra on the card, hqdn3d, the avi
# multiplexor

_AVI_WRAPPERS = {"mpeg4_recon": "mpeg4_recon",
                 "mpeg4_idct_intra": "mpeg4_idct_intra"}
# phase 3 off the path: macroblock grids (mbw, mbh) of VOPs of random
# records, among them 720x576's coded grid and grids of one macroblock
# row or column
MPEG4_GRIDS = ((1, 1), (3, 2), (1, 9), (11, 1), (40, 30), (45, 36))
# the XVID IDCT's int32 operations an output sample, the fewest its two
# passes need (row: four even and four odd sums of products, the
# butterfly, shift and wrap; column: the TAN and SQRT2 products, the
# butterfly, shift and wrap), and the prediction's a predicted sample
# (four taps, their sum, rounding, shift, the average and the clip)
MPEG4_IDCT_OPS = 20
MPEG4_MC_OPS = 10


def avi_plans(path):
    """Every VOP plan of an MPEG-4 AVI, parsed on the host (as the
    importer parses them: drop-frame chunks are all-skip P plans once a
    VOP was seen, a packed chunk's placeholder is skipped)."""
    from tcforge_tpu_torch.io.avi import AviReader
    from tcforge_tpu_torch.io.mpeg4plan import Mpeg4PlanDecoder
    dec, plans, debt = Mpeg4PlanDecoder(), [], 0
    with AviReader(str(path)) as r:
        for i in range(r.video_frames):
            raw = r.read_video_frame(i)[0]
            if raw:
                got = dec.parse_plans(bytes(raw))
                debt += max(0, len(got) - 1)
                plans += got
            elif debt:
                debt -= 1
            elif plans:
                p = dec._plan_new("P")
                p["use_f"][:] = 1
                dec._plan = None
                plans.append(p)
    return dec, plans


def _avi_importer(path, dev, buffers: int = 2):
    """The AVI (or, for a ``.mov``, the MOV) import module of ``path``,
    started on ``dev``."""
    from tcforge_tpu_torch.core.job import Job
    from tcforge_tpu_torch.modules.registry import ModuleKind, new_module
    kind = "mov" if Path(path).suffix == ".mov" else "avi"
    imp = new_module(ModuleKind.DEMULTIPLEXOR, kind, Job())
    imp.open(str(path))
    imp.start(dev, buffers)
    return imp


def _vop_bytes(args) -> int:
    """What one ``mpeg4_recon`` call must move: its records, each anchor
    plane it reads once, its three planes out."""
    vop, mbw = args[0], args[1]
    refs = [q for planes in args[3:5] if planes is not None for q in planes]
    return _nbytes(vop, *refs) + vop.shape[0] * 384


def _vop_ops(args) -> int:
    """Operations these records need: the IDCT of each block with a
    coefficient, the prediction of each sample of a predicted macroblock
    (once a direction)."""
    vop = args[0]
    blocks = int((vop[:, :384].reshape(-1, 6, 64) != 0).any(-1).sum())
    dirs = 0 if len(args) < 5 else int(
        (vop[:, 404] != 0).sum() + (vop[:, 405] != 0).sum())
    return MPEG4_IDCT_OPS * 64 * blocks + MPEG4_MC_OPS * 384 * dirs


def _vop_rotation(calls) -> list:
    """``calls`` and copies of them (every tensor cloned), more than the
    card's L2 together: timed with a call for each (``reps`` at least
    their number), each finds its records and anchors in device memory
    as the path's next VOP would."""
    inputs = list(calls)
    while sum(_vop_bytes(a) for a in inputs) < L2_BYTES:
        inputs += [_tensors_clone(a) for a in calls]
    return inputs


def _random_vop(torch, rng, mbw, mbh, dev, kind):
    """Records of a VOP off the path: dense coefficients in [-2048, 2047]
    (where int32 and int64 IDCTs differ), every mask combination, 1MV and
    4MV macroblocks, vectors from small to far past the frame."""
    from tcforge_tpu_torch.io.mpeg4recon import REC
    nmb = mbw * mbh
    rec = np.zeros((nmb, REC), np.int16)
    dense = rng.random(nmb) < 0.5
    coef = rng.integers(-2048, 2048, (nmb, 384))
    coef[~dense] *= rng.random((int((~dense).sum()), 384)) < 0.05
    rec[:, :384] = coef
    reach = rng.choice([2, 33, 700, 4000], size=(nmb, 1))
    mv = rng.integers(-reach, reach + 1, (nmb, 8))
    one = rng.random(nmb) < 0.5                    # 1MV: four equal
    mv[one] = np.tile(mv[one, :2], 4)
    rec[:, 384:392] = mv
    rec[:, 392:400] = rng.integers(-reach, reach + 1, (nmb, 8))
    rec[:, 400:404] = rng.integers(-reach, reach + 1, (nmb, 4))
    if kind != "I":
        rec[:, 404] = rng.integers(0, 2, nmb)
        rec[:, 405] = rng.integers(0, 2, nmb) if kind == "B" else 0
    return torch.from_numpy(rec).to(dev)


def _check_mpeg4_kernels(torch, kernels, bench):
    """Phase 3 for the MPEG-4 reconstruction: every call of
    ``mpeg4_recon`` and ``mpeg4_idct_intra`` while every stream of
    tests/data/mpeg4 decodes on the card (divx.avi's every VOP, 200x136,
    drop-frame chunks, packed P+B chunks, the in-tree encoder's stream)
    held against the plain versions on the same inputs; then VOPs of
    random records off the path (dense coefficients in [-2048, 2047],
    vectors far outside the frame, rounding 0 and 1, 1MV and 4MV
    macroblocks, every mask, I-VOPs) on grids from one macroblock to
    720x576's; then each timed on divx.avi's VOPs beside its plain
    version and its bound (no PyTorch call computes the XVID integer
    IDCT with the MC: library none), ``mpeg4_recon_field`` beside
    ``mpeg4_recon`` (the superset line) and, with ``--parent``, both
    beside the parent's."""
    dev = bench.dev
    captured = {"mpeg4_recon": [], "mpeg4_idct_intra": []}
    streams = ["divx.avi", "small.avi", "odd.avi", "native.avi",
               "drop.avi", "packed.avi"]
    cases = 0
    with checked_kernels(kernels, bench, "mpeg4 streams",
                         _AVI_WRAPPERS) as counts:
        checked = {w: getattr(kernels, w) for w in captured}

        def keeping(w):
            def call(*a):
                captured[w].append(a)
                return checked[w](*a)
            return call
        for name in streams:
            if name == "divx.avi":      # its calls, kept for the timing
                for w in checked:
                    setattr(kernels, w, keeping(w))
            imp = _avi_importer(MPEG4_DATA / name, dev)
            while imp.read_video_batch(5) is not None:
                pass
            imp.close()
            for w, fn in checked.items():
                setattr(kernels, w, fn)
        stream_counts = dict(counts)
    rng = np.random.default_rng(13)
    for mbw, mbh in MPEG4_GRIDS:
        fwd, bwd = (tuple(torch.from_numpy(rng.integers(
            0, 256, (mbh * mb, mbw * mb), dtype=np.uint8)).to(dev)
            for mb in (16, 8, 8)) for _ in range(2))
        for kind, rounding in (("I", 0), ("P", 0), ("P", 1), ("B", 0)):
            vop = _random_vop(torch, rng, mbw, mbh, dev, kind)
            label = f"{mbw}x{mbh} MBs {kind} rounding {rounding}"
            if kind == "I":
                bench.check("mpeg4_idct_intra", label,
                            kernels.mpeg4_idct_intra(vop, mbw),
                            kernels.mpeg4_idct_intra_ref(vop, mbw),
                            quiet=True)
            else:
                args = (vop, mbw, rounding, fwd, bwd if kind == "B" else None)
                bench.check("mpeg4_recon", label, kernels.mpeg4_recon(*args),
                            kernels.mpeg4_recon_ref(*args), quiet=True)
            cases += 1
    for kernel, n in stream_counts.items():
        emit(phase="kernel_sweep", kernel=kernel, cases=n,
             streams=len(streams), off_path=cases, max_abs_err=0)
    recon, intra = captured["mpeg4_recon"], captured["mpeg4_idct_intra"]
    check(len(recon) >= 8 and len(intra) >= 2,
          f"divx.avi gave {len(recon)} mpeg4_recon and {len(intra)} "
          "mpeg4_idct_intra calls")
    per = DIVX_FRAMES / MAIN_BATCH
    inputs = _vop_rotation(recon)
    reps = max(20, len(inputs))
    bench.record("mpeg4_recon", "640x480 P and B VOPs", len(recon) / per,
                 kernels.mpeg4_recon, kernels.mpeg4_recon_ref, inputs,
                 nbytes=sum(map(_vop_bytes, recon)) / len(recon),
                 ops=sum(map(_vop_ops, recon)) / len(recon), reps=reps,
                 plain_reps=2)
    # the interlaced VOL's kernel takes every form: on divx.avi's records
    # (all half-pel frame macroblocks) it equals mpeg4_recon, and the two
    # are timed in turns on the same inputs
    for a in recon:
        bench.check("mpeg4_recon_field", "divx.avi VOP against mpeg4_recon",
                    kernels.mpeg4_recon_field(*a), kernels.mpeg4_recon(*a),
                    quiet=True)
    ms = [bench.time(fn, inputs, reps) for fn in (
        kernels.mpeg4_recon, kernels.mpeg4_recon_field,
        kernels.mpeg4_recon_field, kernels.mpeg4_recon)]
    emit(phase="superset", kernel="mpeg4_recon_field",
         case="divx.avi 640x480 P and B VOPs", ms=ms[1:3],
         mpeg4_recon_ms=[ms[0], ms[3]], vops=len(recon))
    # with --parent, the parent's two kernels on the same VOPs, in turns
    for name in ("mpeg4_recon", "mpeg4_recon_field"):
        theirs = getattr(bench.parent.kernels, name, None) \
            if bench.parent else None
        if theirs is not None:
            bench.versus(name, "divx.avi 640x480 P and B VOPs", 0,
                         getattr(kernels, name), theirs, inputs, inputs,
                         reps=reps)
    inputs = _vop_rotation(intra)
    bench.record("mpeg4_idct_intra", "640x480 I-VOPs", len(intra) / per,
                 kernels.mpeg4_idct_intra, kernels.mpeg4_idct_intra_ref,
                 inputs, nbytes=sum(map(_vop_bytes, intra)) / len(intra),
                 ops=sum(map(_vop_ops, intra)) / len(intra),
                 reps=max(20, len(inputs)), plain_reps=2)



def _run_divx(torch, cli, kernels, tmp):
    """Phase 4 for the DivX path: divx.avi through the port's CLI with
    the launch counts set to 0 just before and read just after (one
    reconstruction launch per VOP: ``mpeg4_idct_intra`` for each I-VOP,
    ``mpeg4_recon`` for each other, and hqdn3d's), its AVI equal byte for
    byte to the same CLI's with --device cpu (the plain versions) and at
    --batch 3 with --prefetch 1.  Returns the launches."""
    argv = ["-i", str(MPEG4_DATA / "divx.avi"), *DIVX_ARGS, "--progress_off",
            "-q"]
    out = tmp / "divx.avi"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main([*argv, "-o", str(out), "--batch", str(MAIN_BATCH),
                   "--device", "cuda"])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(rc == 0, f"divx: CLI exit code {rc}")
    _dec, plans = avi_plans(MPEG4_DATA / "divx.avi")
    intra = sum(p["kind"] == "I" for p in plans)
    emit(phase="path", path="divx", frames=DIVX_FRAMES, seconds=e2e_s,
         e2e_fps=DIVX_FRAMES / e2e_s, vops=len(plans), i_vops=intra,
         launches={k: launches[k] for k in AVI_KERNELS})
    for name in AVI_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  "divx path")
    check(launches["mpeg4_idct_intra"] == intra
          and launches["mpeg4_recon"] == len(plans) - intra,
          f"divx: {launches['mpeg4_idct_intra']} + "
          f"{launches['mpeg4_recon']} launches for {len(plans)} VOPs")
    want = out.read_bytes()
    path = tmp / "divx_cpu.avi"
    rc = cli.main([*argv, "-o", str(path), "--device", "cpu"])
    same = rc == 0 and path.read_bytes() == want
    emit(phase="path_vs_cpu", path="divx", identical=same,
         sha256=hashlib.sha256(want).hexdigest())
    check(same, "divx: the card's output differs from the CPU's")
    # the AVI interleaves a batch's video and audio chunks, so another
    # batch size writes other bytes: the chunks are compared
    rc = cli.main([*argv, "-o", str(path), "--device", "cuda", "--batch",
                   "3", "--prefetch", "1"])
    same = rc == 0 and _avi_chunks(path) == _avi_chunks(out)
    emit(phase="engine_vs_batch16", path="divx", batch=3, prefetch=1,
         identical=same)
    check(same, "divx at --batch 3: the chunks differ from --batch 16's")
    path.unlink()
    return launches


def _avi_chunks(path):
    """An AVI's video chunks and its first track's bytes."""
    from tcforge_tpu_torch.io.avi import AviReader
    with AviReader(str(path)) as r:
        return ([r.read_video_frame(i)[0] for i in range(r.video_frames)],
                b"".join(r.read_audio_chunks(0)) if r.audio else b"")


def _avi_goldens(cli, tmp):
    """Phase 5 for the AVI import: every ``AVI_GOLDEN`` case on the card,
    its outputs' SHA-256 against the JAX CLI's pinned digests."""
    for case in AVI_GOLDEN:
        d = tmp / f"avi_golden_{case}"
        d.mkdir()
        rc = cli.main([*avi_golden_argv(case, d), "--device", "cuda",
                       "--progress_off", "-q"])
        digests = [sha256_file(f) if f.exists() else None
                   for f in avi_golden_outputs(case, d)]
        emit(phase="golden", path=f"avi_{case}", sha256=digests,
             pinned=list(AVI_GOLDEN_SHA256[case]))
        check(rc == 0 and digests == list(AVI_GOLDEN_SHA256[case]),
              f"avi {case} golden output differs from the JAX-pinned "
              "digest")


# phase 6's divx input: divx.avi this many times over (24 frames; cut
# from 96 and then 48 to keep the script inside its time limit)
DIVX_COPIES = 1
# phase 6's timed CLI runs of the divx path (cut from four to keep the
# script inside its time limit)
DIVX_RUNS = 2


def avi_long(directory, fixture: str, copies: int) -> Path:
    """An MPEG-4 fixture's chunks (and PCM, where it has a track)
    ``copies`` times over, in one AVI written by the port's own
    ``AviWriter``: a longer programme of the same VOPs (each copy starts
    at its I-VOP and VOL header)."""
    from tcforge_tpu_torch.io.avi import (AviAudioStream, AviReader,
                                          AviVideoStream, AviWriter)
    with AviReader(str(MPEG4_DATA / fixture)) as r:
        v, tracks = r.video, r.audio[:1]
        video = [r.read_video_frame(i) for i in range(r.video_frames)]
        pcm = b"".join(r.read_audio_chunks(0)) if tracks else b""
    spf = len(pcm) // len(video)
    path = Path(directory) / f"{Path(fixture).stem}_long.avi"
    w = AviWriter(str(path), AviVideoStream(fourcc=v.fourcc, width=v.width,
                                            height=v.height, fps=v.fps),
                  [AviAudioStream(rate=a.rate, channels=a.channels,
                                  bits=a.bits) for a in tracks])
    for _ in range(copies):
        for i, (chunk, key) in enumerate(video):
            w.write_video_frame(chunk, key)
            if tracks:
                w.write_audio(pcm[i * spf:(i + 1) * spf])
    w.close()
    return path


def _check_repeat(torch, dev, fixture: str, src, frames: int, name: str):
    """``src`` (``avi_long`` of ``fixture``) decodes on the card to the
    fixture's frames repeated, frame for frame."""
    one = []
    imp = _avi_importer(MPEG4_DATA / fixture, dev)
    while (b := imp.read_video_batch(MAIN_BATCH)) is not None:
        one += [tuple(b[k][i] for k in "yuv") for i in range(len(b["y"]))]
    imp.close()
    imp = _avi_importer(src, dev)
    seen = 0
    while (b := imp.read_video_batch(MAIN_BATCH)) is not None:
        for i in range(len(b["y"])):
            ref = one[seen % len(one)]
            check(all(torch.equal(b[k][i], ref[j])
                      for j, k in enumerate("yuv")),
                  f"{name}_long: frame {seen} differs from {fixture}'s "
                  f"frame {seen % len(one)}")
            seen += 1
    imp.close()
    check(seen == frames, f"{name}_long gave {seen} frames")
    emit(phase="path_vs_repeat", path=f"{name}_long", frames=seen,
         identical=True)


def avi_stages(torch, dev, src, out, job, batch: int = MAIN_BATCH,
               audio: bool = False, warmup: int = 0):
    """The serial engine's stages for an MPEG-4 or Motion-JPEG AVI on the
    card, each timed alone with the card synchronized after it: the host
    parse and plan (Motion-JPEG: the entropy decode), the upload of the
    plan's records (the same bytes copied alone), the decode (upload and
    reconstruction, or the two JPEG kernels: the difference), the chain,
    the copy back and the AVI write; with ``audio``, the batch's samples
    of the compressed track (``audio_read``, the host's wall time) and
    the decoder's own time in its worker process (``audio_decode``).
    The first ``warmup`` batches run untimed (the worker process's start,
    the filters' tables).  Returns ms per batch of each, their sum and
    the frames/s of the sum and of the slowest stage."""
    from tcforge_tpu_torch.core.frame import FrameBatch
    from tcforge_tpu_torch.io import adec_worker
    from tcforge_tpu_torch.io.avi import AviVideoStream, AviWriter
    from tcforge_tpu_torch.pipeline.chain import VideoChain
    imp = _avi_importer(src, dev)
    jpeg = imp.format.is_rgb
    chain = VideoChain(job, imp.format, imp.width, imp.height)
    states = chain.initial_states(dev)
    keys = ["parse", "upload", "reconstruction", "chain", "to_host",
            "write"] + (["audio_read", "audio_decode"] if audio else [])
    ms = dict.fromkeys(keys, 0.0)
    spf = int(round(imp.audio_rate / imp.fps)) if audio else 0
    frames = timed = batches = 0
    w = AviWriter(str(out), AviVideoStream(width=imp.width,
                                           height=imp.height, fps=imp.fps))
    torch.cuda.synchronize()
    while True:
        t0 = time.perf_counter()
        plan = imp.plan_batch(batch)
        t1 = time.perf_counter()
        if plan is None:
            break
        n = plan.upload_elements
        if n:
            plan.buffer.flat[:n].to(dev, non_blocking=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        planes = imp.execute(plan)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        got = next(iter(planes.values())).shape[0]
        fb = FrameBatch(format=imp.format, y=planes.get("y"),
                        u=planes.get("u"), v=planes.get("v"),
                        rgb=planes.get("rgb"),
                        attrs=torch.zeros((got,), dtype=torch.int32,
                                          device=dev),
                        frame_ids=torch.arange(frames, frames + got,
                                               dtype=torch.int32,
                                               device=dev), fps=imp.fps)
        result, states = chain(fb, states)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        host = result.to_numpy()
        t5 = time.perf_counter()
        for i in range(got):
            w.write_video_frame(b"".join(p[i].tobytes() for p in host))
        t6 = time.perf_counter()
        d0 = adec_worker.decode_seconds()
        if audio:
            imp.read_audio_batch(spf * got)
        t7 = time.perf_counter()
        frames += got
        if frames <= warmup * batch:
            continue
        for key, a, b in (("parse", t0, t1), ("upload", t1, t2),
                          ("chain", t3, t4), ("to_host", t4, t5),
                          ("write", t5, t6)):
            ms[key] += (b - a) * 1e3
        ms["reconstruction"] += ((t3 - t2) - (t2 - t1)) * 1e3
        if audio:
            ms["audio_read"] += (t7 - t6) * 1e3
            ms["audio_decode"] += (adec_worker.decode_seconds() - d0) * 1e3
        timed += got
        batches += 1
    w.close()
    imp.close()
    per_batch = {k: v / batches for k, v in ms.items()}
    if jpeg:
        per_batch["entropy_decode"] = per_batch.pop("parse")
        per_batch["kernels"] = per_batch.pop("reconstruction")
    # the decoder's time runs in its own process, beside the others
    total = sum(v for k, v in per_batch.items() if k != "audio_decode")
    return {"frames": timed, "ms_per_batch": per_batch,
            "sum_ms_per_batch": total,
            "serial_fps": timed / (total * batches / 1e3),
            "overlapped_fps": timed / (max(per_batch.values())
                                       * batches / 1e3)}


def _divx_rates(torch, dev, cli, tmp):
    """Phase 6 for the DivX path, on divx.avi twice over (48 frames,
    three batches): the long file's decode on the card against the
    fixture's decode repeated, frame for frame; the CLI, wall clock to the
    last byte, ``DIVX_RUNS`` runs after an untimed one (median and
    spread); then ``avi_stages``."""
    from tcforge_tpu_torch.core.job import FilterSpec, Job
    src = avi_long(tmp, "divx.avi", DIVX_COPIES)
    frames = DIVX_COPIES * DIVX_FRAMES
    _check_repeat(torch, dev, "divx.avi", src, frames, "divx")
    out = tmp / "divx_long_out.avi"
    fps = []
    for r in range(DIVX_RUNS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["-i", str(src), "-o", str(out), *DIVX_ARGS,
                       "--batch", str(MAIN_BATCH), "--device", "cuda",
                       "--progress_off", "-q"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"divx CLI: exit code {rc}")
        if r:
            fps.append(frames / seconds)
    job = Job(filters=[FilterSpec("hqdn3d", "luma=4.0")],
              im_v_width=DIVX_W, im_v_height=DIVX_H)
    emit(phase="cli", path="divx", frames=frames, fps=fps,
         median_fps=float(np.median(fps)), min_fps=min(fps),
         max_fps=max(fps),
         stages=avi_stages(torch, dev, src, tmp / "stages.avi", job))
    for f in (src, out, tmp / "stages.avi"):
        f.unlink()


# ---------------------------------------------------------------------- #
# The quarter-sample and interlaced MPEG-4 paths (ASP_PATHS): divx_qpel
# (mpeg4_recon_qpel) and divx_il (mpeg4_recon_field, mpeg4_idct_intra
# with field DCT), each -x avi into hqdn3d and the avi multiplexor

_ASP_WRAPPERS = {k: k for k in ("mpeg4_recon", "mpeg4_recon_qpel",
                                "mpeg4_recon_field", "mpeg4_idct_intra")}
# the streams phase 3 decodes with every call checked
ASP_STREAMS = ("qpel_small.avi", "il_small.avi", "qpel.avi", "ildct.avi",
               "divx_qpel.avi", "divx_il.avi")
# off the path: grids (mbw, mbh) of random records, one macroblock row
# or column among them, and 720x480's
ASP_GRIDS = ((1, 1), (4, 2), (1, 5), (7, 1), (45, 30))
# the 8-tap filter's int32 operations an output sample, the fewest the
# symmetric taps [-1 3 -6 20 20 -6 3 -1] need: four pair sums first,
# then 20 a (a multiply), -6 b and 3 c (two multiply-adds), minus d,
# the rounding, the shift and the clip's min and max; a quarter
# average's (a sum, rounding, shift)
QPEL_TAP_OPS = 12
QPEL_AVG_OPS = 3
# the quarter-sample form's luma: (form, filter block side, blocks)
QPEL_FORMS = ((1, 16, 1), (2, 8, 4))
# phase 6's ASP input: each fixture this many times over (12 frames; cut
# from two to keep the script inside its time limit)
ASP_COPIES = 1
# phase 6's timed CLI runs of the ASP and GMC paths (cut from three to
# keep the script inside its time limit)
ASP_RUNS = 2


def _qpel_vop(torch, rng, mbw, mbh, dev, kind):
    """Records off the path for ``mpeg4_recon_qpel``: random coefficients
    and masks (``_random_vop``), each macroblock of form FORM_QPEL16,
    FORM_QPEL8 or FORM_HALF; the first 32 macroblocks of a grid cycle
    through the 16 quarter phases (x & 3, y & 3) at s = 16 and then at
    s = 8 (four blocks, four phases), the rest random."""
    from tcforge_tpu_torch.io import mpeg4recon as R
    vop = _random_vop(torch, rng, mbw, mbh, torch.device("cpu"), kind)
    rec = vop.numpy()
    nmb = mbw * mbh
    form = rng.choice([0, 1, 2], size=nmb, p=[0.2, 0.4, 0.4])
    form[:32] = np.repeat([1, 2], 16)[:nmb]
    rec[:, R.FORM] = form
    for i in range(min(32, nmb)):
        base = rng.integers(-40, 40, size=(8,)) * 4
        ph = (i + np.arange(4)) % 16 if form[i] == 2 else np.full(4, i % 16)
        mv = base.reshape(4, 2) + np.stack([ph & 3, ph >> 2], 1)
        if form[i] == 1:
            mv[:] = mv[0]
        rec[i, R.FMV:R.BMV] = mv.reshape(8)
        rec[i, R.BMV:R.FCMV] = mv.reshape(8)[::-1]
    return vop.to(dev)


def _field_vop(torch, rng, mbw, mbh, dev, kind):
    """Records off the path for ``mpeg4_recon_field``: the quarter-sample
    VOP's, with every macroblock of the top and bottom rows and a third
    of the rest of form FORM_FIELD (every select pair, odd and even
    vertical field vectors, small and far past the frame), and dct_type
    at random."""
    from tcforge_tpu_torch.io import mpeg4recon as R
    vop = _qpel_vop(torch, rng, mbw, mbh, torch.device("cpu"), kind)
    rec = vop.numpy()
    nmb = mbw * mbh
    field = rng.random(nmb) < 0.34
    field[:mbw] = field[-mbw:] = True
    rec[field, R.FORM] = R.FORM_FIELD
    n = int(field.sum())
    reach = rng.choice([3, 40, 600], size=(n, 1))
    rec[field, R.FSEL:R.FLDMV] = rng.integers(0, 2, (n, 4))
    rec[field, R.FLDMV:R.FLDCMV + 8] = rng.integers(-reach, reach + 1,
                                                    (n, 16))
    rec[:, R.DCT] = rng.integers(0, 2, nmb)
    return vop.to(dev)


def _qpel_ops(args) -> int:
    """Operations a quarter-sample VOP's records need: ``_vop_ops`` with
    the filter's instead of the half-pel taps on its quarter-sample
    macroblocks' luma (each filter block's stages as its phase takes
    them: the horizontal over s+1 rows where x & 3, the vertical where
    y & 3, an average where the phase is odd), once a direction."""
    from tcforge_tpu_torch.io import mpeg4recon as R
    vop = args[0].cpu().numpy().astype(np.int64)
    ops = _vop_ops(args)
    for lo, use in ((R.FMV, R.USE_F), (R.BMV, R.USE_B)):
        if lo == R.BMV and (len(args) < 5 or args[4] is None):
            continue
        for form, s, nb in QPEL_FORMS:
            sel = (vop[:, R.FORM] == form) & (vop[:, use] != 0)
            mv = vop[sel, lo:lo + 2 * nb].reshape(-1, 2)
            hx, hy = mv[:, 0] & 3, mv[:, 1] & 3
            taps = (np.where(hx != 0, np.where(hy != 0, s + 1, s) * s, 0)
                    + np.where(hy != 0, s * s, 0))
            avgs = (np.where(hx & 1, np.where(hy != 0, s + 1, s) * s, 0)
                    + np.where(hy & 1, s * s, 0))
            ops += int((QPEL_TAP_OPS * taps + QPEL_AVG_OPS * avgs).sum()
                       - MPEG4_MC_OPS * 256 * sel.sum())
    return ops


def _qpel_library(torch, rotation):
    """The library call beside ``mpeg4_recon_qpel`` and its inputs, one
    for each VOP of ``rotation``: float32 ``F.conv2d`` of the 8-tap
    filter's two stages, a 1x8 kernel and then an 8x1 one, over the
    VOP's quarter-sample filter blocks where its records place them (both
    directions, s = 16 and s = 8).  The horizontal stage runs where
    x & 3 (over s+1 rows where y & 3 too, else s), the vertical where
    y & 3.  Each block's window is gathered before the clock starts,
    each coordinate clamped to its anchor and the columns mirrored by
    ``_qpel_idx``; the rows are mirrored between the two stages.  The
    filter's stages alone: no rounding, clip, quarter average, chroma or
    IDCT (timed only)."""
    import torch.nn.functional as F
    from tcforge_tpu_torch.io import mpeg4dec as M
    from tcforge_tpu_torch.io import mpeg4recon as R
    dev = rotation[0][0].device
    taps = torch.tensor(R._QPEL_TAPS, dtype=torch.float32, device=dev) / 32
    kh, kv = taps.view(1, 1, 1, 8), taps.view(1, 1, 8, 1)
    # the 8 taps of output j are at j..j+7 of a window s+7 long
    ext = {s: np.concatenate([M._qpel_idx(s)[:, 0], M._qpel_idx(s)[-1, 1:]])
           for _f, s, _n in QPEL_FORMS}

    def windows(args):
        vop, mbw, fwd, bwd = args[0], args[1], args[3], args[4]
        rec = vop.cpu().numpy().astype(np.int64)
        groups = {}
        for lo, use, planes in ((R.FMV, R.USE_F, fwd), (R.BMV, R.USE_B, bwd)):
            if planes is None:
                continue
            y = planes[0].float()
            h, w = y.shape
            for form, s, nb in QPEL_FORMS:
                mb = np.nonzero((rec[:, R.FORM] == form)
                                & (rec[:, use] != 0))[0]
                k, side = np.arange(nb), 16 // s
                mv = rec[mb, lo:lo + 2 * nb].reshape(-1, nb, 2)
                oy = ((mb // mbw * 16)[:, None] + s * (k // side)
                      + (mv[..., 1] >> 2)).ravel()
                ox = ((mb % mbw * 16)[:, None] + s * (k % side)
                      + (mv[..., 0] >> 2)).ravel()
                hx = (mv[..., 0] & 3).ravel() != 0
                hy = (mv[..., 1] & 3).ravel() != 0
                for hs, vs in ((True, False), (False, True), (True, True)):
                    sel = (hx == hs) & (hy == vs)
                    if not sel.any():
                        continue
                    rows = np.arange(s + 1 if vs else s)
                    cols = ext[s] if hs else np.arange(s)
                    ys = torch.from_numpy(np.clip(
                        oy[sel, None] + rows, 0, h - 1)).to(dev)
                    xs = torch.from_numpy(np.clip(
                        ox[sel, None] + cols, 0, w - 1)).to(dev)
                    groups.setdefault((s, hs, vs), []).append(
                        y[ys[:, :, None], xs[:, None, :]])
        return [(torch.cat(g).unsqueeze(1), hs, vs,
                 torch.from_numpy(ext[s]).to(dev))
                for (s, hs, vs), g in sorted(groups.items())]

    def library(groups):
        out = []
        for x, hs, vs, rows in groups:
            if hs:
                x = F.conv2d(x, kh)
            if vs:
                x = F.conv2d(x.index_select(2, rows), kv)
            out.append(x)
        return out
    return library, [(windows(a),) for a in rotation]


def _check_asp_kernels(torch, kernels, bench):
    """Phase 3 for the quarter-sample and interlaced paths: every call of
    the MPEG-4 reconstruction wrappers while each of ``ASP_STREAMS``
    decodes on the card (divx_qpel.avi's and divx_il.avi's every VOP, the
    small streams, the two-frame ones), held against its plain version;
    then VOPs of random records off the path on ``ASP_GRIDS``: every
    quarter phase at s = 16 and s = 8 with rounding 0 and 1 (P) and
    bidirectional (B), field macroblocks on the top and bottom rows with
    every select pair, dct_type at random, I-VOPs with field DCT; then
    each timed on its path's VOPs beside its plain version, its bound
    and, for ``mpeg4_recon_qpel``, ``_qpel_library``.  Returns each
    kernel's count of checked calls."""
    dev = bench.dev
    captured = {"divx_qpel.avi": [], "divx_il.avi": []}
    cases = dict.fromkeys(_ASP_WRAPPERS, 0)
    with checked_kernels(kernels, bench, "asp streams",
                         _ASP_WRAPPERS) as counts:
        checked = {w: getattr(kernels, w) for w in _ASP_WRAPPERS}
        for name in ASP_STREAMS:
            if name in captured:
                def keeping(w, calls=captured[name]):
                    def call(*a):
                        calls.append((w, a))
                        return checked[w](*a)
                    return call
                for w in checked:
                    setattr(kernels, w, keeping(w))
            imp = _avi_importer(MPEG4_DATA / name, dev)
            while imp.read_video_batch(5) is not None:
                pass
            imp.close()
            for w, fn in checked.items():
                setattr(kernels, w, fn)
        stream_counts = dict(counts)
    rng = np.random.default_rng(15)
    for mbw, mbh in ASP_GRIDS:
        fwd, bwd = (tuple(torch.from_numpy(rng.integers(
            0, 256, (mbh * mb, mbw * mb), dtype=np.uint8)).to(dev)
            for mb in (16, 8, 8)) for _ in range(2))
        for name, make in (("mpeg4_recon_qpel", _qpel_vop),
                           ("mpeg4_recon_field", _field_vop)):
            for kind, rounding in (("P", 0), ("P", 1), ("B", 0)):
                vop = make(torch, rng, mbw, mbh, dev, kind)
                args = (vop, mbw, rounding, fwd, bwd if kind == "B" else None)
                bench.check(name, f"{mbw}x{mbh} MBs {kind} rounding "
                            f"{rounding}", getattr(kernels, name)(*args),
                            getattr(kernels, name + "_ref")(*args),
                            quiet=True)
                cases[name] += 1
        vop = _field_vop(torch, rng, mbw, mbh, dev, "I")
        bench.check("mpeg4_idct_intra", f"{mbw}x{mbh} MBs field DCT",
                    kernels.mpeg4_idct_intra(vop, mbw),
                    kernels.mpeg4_idct_intra_ref(vop, mbw), quiet=True)
        cases["mpeg4_idct_intra"] += 1
    for kernel, n in stream_counts.items():
        emit(phase="kernel_sweep", kernel=kernel, cases=n,
             streams=len(ASP_STREAMS), off_path=cases[kernel],
             max_abs_err=0)
    qpel = [a for w, a in captured["divx_qpel.avi"]
            if w == "mpeg4_recon_qpel"]
    field = [a for w, a in captured["divx_il.avi"]
             if w == "mpeg4_recon_field"]
    intra = [a for w, a in captured["divx_il.avi"]
             if w == "mpeg4_idct_intra"]
    check(len(qpel) >= 8 and len(field) >= 8 and intra,
          f"divx_qpel.avi and divx_il.avi gave {len(qpel)} "
          f"mpeg4_recon_qpel, {len(field)} mpeg4_recon_field and "
          f"{len(intra)} mpeg4_idct_intra calls")
    for kernel, calls, frames, case, ops in (
            ("mpeg4_recon_qpel", qpel, ASP_PATHS["divx_qpel"][2],
             "640x480 quarter-sample P and B VOPs", _qpel_ops),
            ("mpeg4_recon_field", field, ASP_PATHS["divx_il"][2],
             "720x480 interlaced P and B VOPs", _vop_ops),
            ("mpeg4_idct_intra", intra, 0, "720x480 I-VOPs, field DCT",
             _vop_ops)):
        inputs = _vop_rotation(calls)
        library = (_qpel_library(torch, inputs)
                   if kernel == "mpeg4_recon_qpel" else None)
        fn, ref = getattr(kernels, kernel), getattr(kernels, kernel + "_ref")
        bench.record(kernel, case, len(calls) / (frames / MAIN_BATCH)
                     if frames else 0, fn, ref, inputs,
                     nbytes=sum(map(_vop_bytes, calls)) / len(calls),
                     ops=sum(map(ops, calls)) / len(calls),
                     library=library, reps=max(20, len(inputs)),
                     plain_reps=2, library_reps=len(inputs))
    return stream_counts


def _run_asp(torch, cli, kernels, tmp, name):
    """Phase 4 for a path of ``ASP_PATHS``: its fixture through the
    port's CLI with the launch counts set to 0 just before and read just
    after (an ``mpeg4_idct_intra`` a I-VOP, the path's reconstruction
    kernel a P or B VOP, hqdn3d's), its AVI equal byte for byte to the
    same CLI's with --device cpu and, in chunks, at --batch 3 with
    --prefetch 1.  Returns the launches."""
    fixture, args, frames, names, _w, _h = ASP_PATHS[name]
    argv = ["-i", str(MPEG4_DATA / fixture), *args, "--progress_off", "-q"]
    out = tmp / f"{name}.avi"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main([*argv, "-o", str(out), "--batch", str(MAIN_BATCH),
                   "--device", "cuda"])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(rc == 0, f"{name}: CLI exit code {rc}")
    _dec, plans = avi_plans(MPEG4_DATA / fixture)
    intra = sum(p["kind"] == "I" for p in plans)
    emit(phase="path", path=name, frames=frames, seconds=e2e_s,
         e2e_fps=frames / e2e_s, vops=len(plans), i_vops=intra,
         field_dct_mbs=int(sum(p["dct_type"].sum() for p in plans)),
         forms=np.bincount(np.concatenate([p["form"] for p in plans]),
                           minlength=4).tolist(),
         launches={k: launches[k] for k in names})
    for k in names:
        check(launches[k] > 0, f"kernel {k} was not launched by the {name} "
                               "path")
    check(launches["mpeg4_idct_intra"] == intra
          and launches[names[0]] == len(plans) - intra
          and launches["mpeg4_recon"] == 0,
          f"{name}: {launches['mpeg4_idct_intra']} + {launches[names[0]]} "
          f"launches for {len(plans)} VOPs")
    want = out.read_bytes()
    path = tmp / f"{name}_cpu.avi"
    rc = cli.main([*argv, "-o", str(path), "--device", "cpu"])
    same = rc == 0 and path.read_bytes() == want
    emit(phase="path_vs_cpu", path=name, identical=same,
         sha256=hashlib.sha256(want).hexdigest())
    check(same, f"{name}: the card's output differs from the CPU's")
    rc = cli.main([*argv, "-o", str(path), "--device", "cuda", "--batch",
                   "3", "--prefetch", "1"])
    same = rc == 0 and _avi_chunks(path) == _avi_chunks(out)
    emit(phase="engine_vs_batch16", path=name, batch=3, prefetch=1,
         identical=same)
    check(same, f"{name} at --batch 3: the chunks differ from --batch 16's")
    path.unlink()
    return launches


def _asp_refusal(cli, tmp):
    """What the numpy decoder refuses the port refuses: qpel_il.avi (a
    field-predicted P macroblock in a quarter-sample VOL) makes the CLI
    exit 1 on the card."""
    rc = cli.main(["-i", str(MPEG4_DATA / "qpel_il.avi"), "-o",
                   str(tmp / "qpel_il.y4m"), "--device", "cuda",
                   "--progress_off", "-q"])
    emit(phase="refusal", path="qpel_il", exit_code=rc)
    check(rc == 1, f"qpel_il.avi: CLI exit code {rc}, not 1")


def _asp_rates(torch, dev, cli, tmp, name):
    """Phase 6 for a path of ``ASP_PATHS``, on its fixture ``ASP_COPIES``
    times over (``avi_long``): the long file's decode on the card against
    the fixture's repeated, frame for frame; the CLI, wall clock to the
    last byte, ``ASP_RUNS`` runs after an untimed one (median and
    spread); then ``avi_stages``."""
    from tcforge_tpu_torch.core.job import FilterSpec, Job
    fixture, args, frames, _names, w, h = ASP_PATHS[name]
    src = avi_long(tmp, fixture, ASP_COPIES)
    frames *= ASP_COPIES
    _check_repeat(torch, dev, fixture, src, frames, name)
    out = tmp / f"{name}_long_out.avi"
    fps = []
    for r in range(ASP_RUNS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["-i", str(src), "-o", str(out), *args, "--batch",
                       str(MAIN_BATCH), "--device", "cuda", "--progress_off",
                       "-q"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"{name} CLI: exit code {rc}")
        if r:
            fps.append(frames / seconds)
    job = Job(deinterlace=5 if "-I" in args else 0,
              filters=[FilterSpec("hqdn3d", "luma=4.0")], im_v_width=w,
              im_v_height=h)
    emit(phase="cli", path=name, frames=frames, fps=fps,
         median_fps=float(np.median(fps)), min_fps=min(fps),
         max_fps=max(fps),
         stages=avi_stages(torch, dev, src, tmp / "stages.avi", job))
    for f in (src, out, tmp / "stages.avi"):
        f.unlink()


# ---------------------------------------------------------------------- #
# The GMC and short-header paths (GMC_PATHS): divx_gmc (mpeg4_gmc_warp and
# the GMC form of mpeg4_recon) and h263 (1MV records through mpeg4_recon)

_GMC_WRAPPERS = {k: k for k in ("mpeg4_gmc_warp", "mpeg4_recon",
                                "mpeg4_recon_qpel", "mpeg4_recon_field",
                                "mpeg4_idct_intra")}
# the streams phase 3 decodes with every call checked besides divx_gmc's:
# the small GMC goldens' (a quarter-sample one and an interlaced one among
# them, whose S-VOPs take mpeg4_recon_qpel and mpeg4_recon_field) and the
# H.263 fixtures
GMC_SMALL = ("gmc_small", "gmc_odd_i5", "gmc_qpel", "gmc_il")
H263_STREAMS = ("h263.avi", "qcif.avi", "gob.avi")
# the warp's int32 operations an output sample, the fewest it needs: the
# coordinate pair (two multiply-adds and an add each, counted once, and a
# shift each), the floors and fractions (two shifts, two masks), the four
# clamps (two each), the four weights (two subtractions, four products),
# the four products with the samples and their sum with the rounding (four
# multiply-adds), the shift and the clip's min and max
GMC_WARP_OPS = 20
# the random warps off the path: 30 over these coded planes (h, w), the
# first 1080p's
GMC_WARP_PLANES = ((1088, 1920), (480, 640), (144, 176), (16, 16),
                   (96, 112), (32, 208))
GMC_RANDOM_WARPS = 30


def gmc_path_input(name: str, directory) -> Path:
    """The input of a ``GMC_PATHS`` path: h263's fixture, or the GMC
    stream written into ``directory`` once."""
    src = GMC_PATHS[name][0]
    if src is not None:
        return src
    path = Path(directory) / "divx_gmc.avi"
    if not path.exists():
        write_gmc_avi(path)
    return path


def _random_warp(rng, h: int, w: int):
    """The warp record of a random GMC VOL whose coded planes are (h, w):
    a display size up to 15 samples smaller (not a multiple of 16, not a
    power of two), 0 to 3 points, accuracy 0 to 3, trajectories from a few
    samples to far outside the frame, rounding 0 or 1 (``_gmc_setup``)."""
    from tcforge_tpu_torch.io import mpeg4dec
    from tcforge_tpu_torch.io.mpeg4plan import warp_record
    dec = mpeg4dec.Mpeg4Decoder()
    vol = mpeg4dec._VOL()
    vol.width = max(1, w - int(rng.integers(0, 16)))
    vol.height = max(1, h - int(rng.integers(0, 16)))
    vol.sprite_points = int(rng.integers(0, 4))
    vol.sprite_accuracy = int(rng.integers(0, 4))
    dec.vol = vol
    reach = int(rng.choice([4, 64, 3000]))
    traj = [tuple(int(v) for v in rng.integers(-reach, reach + 1, 2))
            for _ in range(vol.sprite_points)]
    return warp_record(dec._gmc_setup(traj), int(rng.integers(0, 2)))


def _gmc_library(torch, rotation):
    """The library call beside ``mpeg4_gmc_warp`` and its inputs, one for
    each warp of ``rotation``: float32 ``F.grid_sample`` (bilinear, edge
    samples repeated) of the three planes at the warp's own source
    coordinates (``_gmc_coords``, made before the clock starts); no
    rounding to the 1/S grid, no clip (timed only)."""
    import torch.nn.functional as F
    from tcforge_tpu_torch.io.mpeg4recon import _gmc_coords
    from tcforge_tpu_torch.io.mpeg4plan import W_S

    def inputs(args):
        planes, warp = args[0], args[1]
        out = []
        for p, plane in enumerate(planes):
            h, w = plane.shape
            vx, vy = _gmc_coords(warp, h, w, p > 0, plane.device)
            s = float(warp[W_S])
            grid = torch.stack([(vx / s) * (2.0 / max(1, w - 1)) - 1,
                                (vy / s) * (2.0 / max(1, h - 1)) - 1],
                               dim=-1).to(torch.float32)[None]
            out.append((plane.to(torch.float32)[None, None], grid))
        return (out,)

    def library(planes):
        return [F.grid_sample(x, g, mode="bilinear", padding_mode="border",
                              align_corners=True) for x, g in planes]
    return library, [inputs(a) for a in rotation]


def _check_gmc_kernels(torch, kernels, bench, gmc_avi, tmp):
    """Phase 3 for the GMC and short-header paths: every call of the
    MPEG-4 wrappers while divx_gmc's stream (``gmc_avi``), the small GMC
    goldens' streams and the H.263 fixtures decode on the card, held
    against the plain versions; each S-VOP of divx_gmc through the other
    two template instances (``mpeg4_recon_qpel``, ``mpeg4_recon_field``:
    their GMC form against their plain versions); ``GMC_RANDOM_WARPS``
    random warps off the path (``_random_warp`` over ``GMC_WARP_PLANES``,
    1080p among them); then ``mpeg4_gmc_warp`` timed on divx_gmc's warps
    and on the 1080p ones beside its plain version, its bound and
    ``_gmc_library``, and the GMC form of ``mpeg4_recon`` on divx_gmc's
    S-VOPs beside its plain version."""
    dev = bench.dev
    warps, svops = [], []
    sources = [gmc_avi]
    for case in GMC_SMALL:
        d = Path(tmp) / f"gmc_check_{case}"
        d.mkdir(exist_ok=True)
        sources.append(Path(gmc_golden_argv(case, d)[1]))
    sources += [H263_DATA / name for name in H263_STREAMS]
    with checked_kernels(kernels, bench, "gmc and h263 streams",
                         _GMC_WRAPPERS) as counts:
        checked = {w: getattr(kernels, w) for w in ("mpeg4_gmc_warp",
                                                    "mpeg4_recon")}

        def keep_warp(*a, **k):
            got = checked["mpeg4_gmc_warp"](*a, **k)
            warps.append(_tensors_clone(a))
            return got

        def keep_recon(*a, **k):
            got = checked["mpeg4_recon"](*a, **k)
            if k.get("warp") is not None:
                svops.append(_tensors_clone(a) + (k["warp"],))
            return got
        for src in sources:
            if src == gmc_avi:
                kernels.mpeg4_gmc_warp, kernels.mpeg4_recon = (keep_warp,
                                                               keep_recon)
            imp = _avi_importer(src, dev)
            while imp.read_video_batch(5) is not None:
                pass
            imp.close()
            kernels.mpeg4_gmc_warp = checked["mpeg4_gmc_warp"]
            kernels.mpeg4_recon = checked["mpeg4_recon"]
        stream_counts = dict(counts)
    check(len(warps) == len(svops) == GMC_GROUPS * (GMC_GOP - 1),
          f"divx_gmc gave {len(warps)} warps and {len(svops)} S-VOP "
          "reconstructions")
    for name in ("mpeg4_recon_qpel", "mpeg4_recon_field"):
        for a in svops:
            bench.check(name, "divx_gmc S-VOP, GMC form",
                        getattr(kernels, name)(*a[:5], warp=a[5]),
                        getattr(kernels, name + "_ref")(*a[:5], warp=a[5]),
                        quiet=True)
    rng = np.random.default_rng(17)
    big = []
    for k in range(GMC_RANDOM_WARPS):
        h, w = GMC_WARP_PLANES[k % len(GMC_WARP_PLANES)]
        ref = (bench.u8(h, w), bench.u8(h // 2, w // 2),
               bench.u8(h // 2, w // 2))
        warp = _random_warp(rng, h, w)
        bench.check("mpeg4_gmc_warp", f"random {w}x{h} warp {k}",
                    kernels.mpeg4_gmc_warp(ref, warp),
                    kernels.mpeg4_gmc_warp_ref(ref, warp), quiet=True)
        if (h, w) == GMC_WARP_PLANES[0]:
            big.append((ref, warp))
    emit(phase="kernel_sweep", kernel="mpeg4_gmc_warp",
         cases=stream_counts["mpeg4_gmc_warp"], streams=len(sources),
         off_path=GMC_RANDOM_WARPS, max_abs_err=0)
    for kernel in ("mpeg4_recon", "mpeg4_recon_qpel", "mpeg4_recon_field",
                   "mpeg4_idct_intra"):
        emit(phase="kernel_sweep", kernel=kernel, case="gmc and h263",
             cases=stream_counts[kernel], streams=len(sources),
             gmc_form_instances=2 * len(svops), max_abs_err=0)
    per = GMC_FRAMES / MAIN_BATCH
    bh, bw = GMC_WARP_PLANES[0]
    for case, calls, per_batch in (
            (f"{GMC_W}x{GMC_H} S-VOPs of divx_gmc", warps, len(warps) / per),
            (f"{bw}x{bh} random warps", big, 0)):
        samples = sum(p.numel() for p in calls[0][0])
        inputs = _clone_rotation(calls)
        bench.record("mpeg4_gmc_warp", case, per_batch,
                     kernels.mpeg4_gmc_warp, kernels.mpeg4_gmc_warp_ref,
                     inputs, nbytes=2 * samples, ops=GMC_WARP_OPS * samples,
                     library=_gmc_library(torch, inputs),
                     reps=max(20, len(inputs)), plain_reps=2,
                     library_reps=len(inputs))

    # the GMC form alone: the reconstruction launch on each S-VOP's warped
    # planes, made before the clock starts
    from tcforge_tpu_torch.io import mpeg4recon
    forms = [a[:5] + (kernels.mpeg4_gmc_warp(a[3], a[5]),) for a in svops]

    def gmc_form(*a):
        return kernels._recon_kernel("mpeg4_recon", *a)

    def gmc_form_ref(*a):
        return mpeg4recon.mpeg4_recon_ref(*a)
    inputs = _vop_rotation(forms)
    bench.record("mpeg4_recon", f"{GMC_W}x{GMC_H} S-VOPs of divx_gmc, GMC "
                 "form", 0,
                 gmc_form, gmc_form_ref, inputs,
                 nbytes=sum(_vop_bytes(a) + _nbytes(*a[5])
                            for a in forms) / len(forms),
                 ops=sum(map(_vop_ops, forms)) / len(forms),
                 reps=max(20, len(inputs)), plain_reps=2)
    return stream_counts


def _run_gmc(torch, cli, kernels, tmp, name, src):
    """Phase 4 for a path of ``GMC_PATHS``: its input ``src`` through the
    port's CLI with the launch counts set to 0 just before and read just
    after (an ``mpeg4_idct_intra`` an I-VOP, an ``mpeg4_recon`` every
    other VOP, an ``mpeg4_gmc_warp`` an S-VOP, hqdn3d's), its AVI equal
    byte for byte to the same CLI's with --device cpu and, in chunks, at
    --batch 3 with --prefetch 1.  Returns the launches."""
    _src, args, frames, names, _w, _h = GMC_PATHS[name]
    argv = ["-i", str(src), *args, "--progress_off", "-q"]
    out = tmp / f"{name}_out.avi"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main([*argv, "-o", str(out), "--batch", str(MAIN_BATCH),
                   "--device", "cuda"])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(rc == 0, f"{name}: CLI exit code {rc}")
    _dec, plans = avi_plans(src)
    intra = sum(p["kind"] == "I" for p in plans)
    svops = sum(p["warp"] is not None for p in plans)
    emit(phase="path", path=name, frames=frames, seconds=e2e_s,
         e2e_fps=frames / e2e_s, vops=len(plans), i_vops=intra,
         s_vops=svops, short=sum(p["short"] for p in plans),
         forms=np.bincount(np.concatenate([p["form"] for p in plans]),
                           minlength=5).tolist(),
         launches={k: launches[k] for k in names})
    for k in names:
        check(launches[k] > 0, f"kernel {k} was not launched by the {name} "
                               "path")
    check(launches["mpeg4_idct_intra"] == intra
          and launches["mpeg4_recon"] == len(plans) - intra
          and launches["mpeg4_gmc_warp"] == svops
          and launches["mpeg4_recon_qpel"] == launches["mpeg4_recon_field"]
          == 0, f"{name}: launches {launches} for {len(plans)} VOPs")
    want = out.read_bytes()
    path = tmp / f"{name}_cpu.avi"
    rc = cli.main([*argv, "-o", str(path), "--device", "cpu"])
    same = rc == 0 and path.read_bytes() == want
    emit(phase="path_vs_cpu", path=name, identical=same,
         sha256=hashlib.sha256(want).hexdigest())
    check(same, f"{name}: the card's output differs from the CPU's")
    rc = cli.main([*argv, "-o", str(path), "--device", "cuda", "--batch",
                   "3", "--prefetch", "1"])
    same = rc == 0 and _avi_chunks(path) == _avi_chunks(out)
    emit(phase="engine_vs_batch16", path=name, batch=3, prefetch=1,
         identical=same)
    check(same, f"{name} at --batch 3: the chunks differ from --batch 16's")
    path.unlink()
    return launches


def _gmc_goldens(cli, tmp, gmc_avi):
    """Phase 5 for the GMC and short-header paths: every ``GMC_GOLDEN``
    case on the card (divx_gmc on ``gmc_avi``, the same stream), its
    outputs' SHA-256 against the JAX CLI's pinned digests."""
    import shutil
    for case in GMC_GOLDEN:
        d = tmp / f"gmc_golden_{case}"
        d.mkdir()
        if case == "divx_gmc":
            shutil.copyfile(gmc_avi, d / "in.avi")
        rc = cli.main([*gmc_golden_argv(case, d), "--device", "cuda",
                       "--progress_off", "-q"])
        digests = [sha256_file(f) if f.exists() else None
                   for f in gmc_golden_outputs(case, d)]
        emit(phase="golden", path=f"gmc_{case}", sha256=digests,
             pinned=list(GMC_GOLDEN_SHA256[case]))
        check(rc == 0 and digests == list(GMC_GOLDEN_SHA256[case]),
              f"gmc {case} golden output differs from the JAX-pinned "
              "digest")


def _gmc_rates(torch, dev, cli, tmp, name, src):
    """Phase 6 for a path of ``GMC_PATHS`` on its 48 frames: the CLI,
    wall clock to the last byte, ``ASP_RUNS`` runs after an untimed one
    (median and spread); then ``avi_stages``."""
    from tcforge_tpu_torch.core.job import FilterSpec, Job
    _src, args, frames, _names, w, h = GMC_PATHS[name]
    out = tmp / f"{name}_rates.avi"
    fps = []
    for r in range(ASP_RUNS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["-i", str(src), "-o", str(out), *args, "--batch",
                       str(MAIN_BATCH), "--device", "cuda", "--progress_off",
                       "-q"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"{name} CLI: exit code {rc}")
        if r:
            fps.append(frames / seconds)
    job = Job(filters=[FilterSpec("hqdn3d", "luma=4.0")], im_v_width=w,
              im_v_height=h)
    emit(phase="cli", path=name, frames=frames, fps=fps,
         median_fps=float(np.median(fps)), min_fps=min(fps),
         max_fps=max(fps),
         stages=avi_stages(torch, dev, src, tmp / "stages.avi", job))
    for f in (out, tmp / "stages.avi"):
        f.unlink()


# ---------------------------------------------------------------------- #
# MPEG-4 export, the divxenc path: dvd.vob -x mpeg -Z 640x480 -J hqdn3d
# -y xvid,raw,avi at cfg10's encoder settings

_ENC4_WRAPPERS = {k: k for k in MPEG4ENC_KERNELS}
# off the path: (width, height, frames, content, encoder settings)
MPEG4ENC_CASES = (
    (320, 240, 4, "wave", dict(qscale=5)),                       # I, 1MV P
    (320, 240, 5, "wave", dict(qscale=5, four_mv=True, bframes=1)),
    (640, 480, 5, "still", dict(qscale=8, four_mv=True, bframes=2)),
    (200, 136, 6, "wave", dict(qscale=1, four_mv=True, bframes=2)),
    (200, 136, 6, "still", dict(qscale=31, four_mv=True, bframes=3)),
    (176, 144, 9, "wave", dict(bitrate_kbps=300, gop=4, bframes=2,
                               search_range=4)),
    (16, 16, 4, "wave", dict(qscale=2, bframes=1, four_mv=True)),
)
# the decisions' work a macroblock beside their searches, in byte
# operations: a P macroblock's mean and its deviation from it; a B
# macroblock's direct and interpolated predictions, an average and a SAD
# each
ME_FIXED_MB = 2 * 256
BME_FIXED_MB = 4 * 256
# the block coder's float64 FMAs a macroblock: two 8-term chains for each
# of its 384 coefficients
BLOCK_FMAS_MB = 384 * 16
# a record's decision fields (MODE to BCMV), read by the block coder
REC_HEAD = 32


@contextlib.contextmanager
def counted_searches(D):
    """While it holds, the plain decisions (module ``D``,
    ``io/mpeg4encdev.py``) count the byte SADs their searches need:
    every 8x8 luma block at every integer offset it visits once, however
    many times the three-step search, the two seeds and the 4MV search
    come back to it (a 16x16 SAD is four of them), and every sample of
    each half-pel candidate.  Yields a function that gives the count."""
    seen, half = set(), [0]
    search_mv, search_mv4, sads = D.search_mv, D.search_mv4, D.HalfPel.sads

    def blocks(hp, y, x, size, ix, iy):
        for by in range(y // 8, (y + size) // 8):
            for bx in range(x // 8, (x + size) // 8):
                seen.add((id(hp), by, bx, ix, iy))

    def mv(sad16, hp, cur, x0, y0, pred, lim):
        def sad(ix, iy):
            blocks(hp, y0, x0, 16, ix, iy)
            return sad16(ix, iy)
        return search_mv(sad, hp, cur, x0, y0, pred, lim)

    def mv4(t8, hp, cur_y, x0, y0, mx, my):
        def sad(k, nx, ny):
            blocks(hp, y0 + 8 * (k >> 1), x0 + 8 * (k & 1), 8, nx, ny)
            return t8(k, nx, ny)
        return search_mv4(sad, hp, cur_y, x0, y0, mx, my)

    def halfpel(hp, cur, y, x, cands):
        size = cur.shape[0]
        for mx, my in cands:
            if (mx | my) & 1:
                half[0] += size * size
            else:
                blocks(hp, y, x, size, mx >> 1, my >> 1)
        return sads(hp, cur, y, x, cands)
    D.search_mv, D.search_mv4, D.HalfPel.sads = mv, mv4, halfpel
    try:
        yield lambda: 64 * len(seen) + half[0]
    finally:
        D.search_mv, D.search_mv4, D.HalfPel.sads = search_mv, search_mv4, \
            sads


def _enc_bytes(args, got, kernel) -> int:
    """What one encoder kernel call must move, each byte once.  The
    decisions: the luma planes they search (and the chroma that the 4MV
    not_coded test codes, of each 4MV macroblock whose 1MV vector is
    (0, 0)), a B-VOP's co-located vectors and skips, the records out.
    The block coder: its planes, the decision fields of the records in
    (none for an I-VOP), the records out and the reconstruction."""
    from tcforge_tpu_torch.io import mpeg4encdev as D
    if kernel == "mpeg4_enc_blocks":
        rec_in, cur, fwd, bwd = args[:4]
        nmb = cur[0].numel() // 256
        px = sum(p.numel() for ps in (cur, fwd, bwd) if ps is not None
                 for p in ps)
        recon = cur[0].numel() * 3 // 2 if args[-1] else 0
        return (px + (0 if rec_in is None else 2 * REC_HEAD * nmb)
                + 2 * D.REC * nmb + recon)
    nmb = args[0][0].numel() // 256
    out = 2 * D.REC * nmb
    if kernel == "mpeg4_enc_bme":
        return sum(a[0].numel() for a in args[:3]) + 2 * 9 * nmb + out
    quirk = int(((got[:, D.MODE] == D.MODE_INTER4) & (got[:, D.MX] == 0)
                 & (got[:, D.MY] == 0)).sum())
    return args[0][0].numel() + args[1][0].numel() + quirk * 4 * 64 + out


def _enc_ops(args, got, kernel, sads) -> float:
    """What one call's data needs: the decisions' byte operations (four
    to an operation), their searches' SADs (``counted_searches`` on the
    call's plain version) and the work of each macroblock that searched
    (not a co-located skip); the block coder's FDCT FMAs."""
    from tcforge_tpu_torch.io import mpeg4encdev as D
    if kernel == "mpeg4_enc_blocks":
        return BLOCK_FMAS_MB * got[0].shape[0]
    if kernel == "mpeg4_enc_bme":
        fixed = BME_FIXED_MB * int((got[:, D.MODE] != D.MODE_COSKIP).sum())
    else:
        fixed = ME_FIXED_MB * got.shape[0]
    return (sads + fixed) / SADS_PER_OP


def _check_mpeg4enc_kernels(torch, kernels, cli, bench):
    """Phase 3 for the MPEG-4 encoder: every call of ``mpeg4_enc_me``,
    ``mpeg4_enc_bme`` and ``mpeg4_enc_blocks`` while the divxenc path
    runs through the CLI (its 48 VOPs) held against the plain versions on
    the same inputs, the decisions' plain versions counting the SADs
    their searches need; then off the path (``MPEG4ENC_CASES``: I-VOPs,
    P-VOPs with and without 4MV, B-VOPs with co-located skips, 200x136,
    one macroblock, q 1 and 31, rate control, search range 4) against
    the plain versions call by call; then each timed on every one of the
    path's calls and clones of them, more than the card's L2 together
    (``_clone_rotation``), beside its plain version and its bound, the
    block coder also beside float64 ``torch.matmul`` of its forward DCT
    (no PyTorch call makes the decisions: library none).  Returns the
    checked run's AVI (every encoder kernel call in it held to its plain
    version on the same inputs; the decode, zoom and hqdn3d before them
    on the card unchecked), which phase 4 holds the path's run to (the
    plain decisions run once)."""
    from tcforge_tpu_torch.io import mpeg4encdev as D
    from tcforge_tpu_torch.io.mpeg4enc import Mpeg4Encoder
    dev = bench.dev
    captured = {k: [] for k in MPEG4ENC_KERNELS}
    searched = {k: [] for k in MPEG4ENC_KERNELS}
    saved = {k: getattr(kernels, k) for k in MPEG4ENC_KERNELS}
    refs = {k: getattr(kernels, k + "_ref") for k in MPEG4ENC_KERNELS}

    def keeping(k):
        def call(*a):
            got = saved[k](*a)
            captured[k].append((a, got))
            return got
        return call

    def counting(k):
        def call(*a):
            with counted_searches(D) as count:
                got = refs[k](*a)
            searched[k].append(count())
            return got
        return call
    with tempfile.TemporaryDirectory(prefix="chip_smoke_enc4_") as tmp:
        try:
            for k in MPEG4ENC_KERNELS:
                setattr(kernels, k, keeping(k))
                setattr(kernels, k + "_ref", counting(k))
            with checked_kernels(kernels, bench, "divxenc path",
                                 _ENC4_WRAPPERS) as counts:
                rc = cli.main([*divxenc_argv(f"{tmp}/enc.avi"),
                               "--device", "cuda"])
                path_counts = dict(counts)
            checked_avi = Path(f"{tmp}/enc.avi").read_bytes() if rc == 0 \
                else None
        finally:
            for k in MPEG4ENC_KERNELS:
                setattr(kernels, k, saved[k])
                setattr(kernels, k + "_ref", refs[k])
    check(rc == 0, f"divxenc with checked kernels: exit code {rc}")
    check(path_counts["mpeg4_enc_blocks"] == DIVXENC_FRAMES,
          f"divxenc: {path_counts} kernel calls for {DIVXENC_FRAMES} VOPs")
    check(all(len(searched[k]) == len(captured[k]) for k in searched),
          "divxenc: a kernel call without its plain version's count")
    emit(phase="kernel_sweep_path", path="divxenc", calls=path_counts)
    cases = dict.fromkeys(MPEG4ENC_KERNELS, 0)
    for w, h, n, kind, cfg in MPEG4ENC_CASES:
        frames = encoder_clip(w, h, n, seed=w + n, kind=kind)
        with checked_kernels(kernels, bench, f"{w}x{h} {kind} {cfg}",
                             _ENC4_WRAPPERS) as counts:
            enc = Mpeg4Encoder(w, h, **cfg)
            for f in frames:
                enc.push(*(torch.from_numpy(p).to(dev) for p in f))
            enc.flush()
            for k in counts:
                cases[k] += counts[k]
    for k in MPEG4ENC_KERNELS:
        emit(phase="kernel_sweep", kernel=k, path_calls=path_counts[k],
             off_path=cases[k], max_abs_err=0)
    vops = DIVXENC_FRAMES / MAIN_BATCH
    dct = torch.from_numpy(np.kron(D._DCTM, D._DCTM).T.copy()).to(dev)
    for k in MPEG4ENC_KERNELS:
        calls = captured[k]
        inputs = _clone_rotation([a for a, _ in calls])
        library = None
        if k == "mpeg4_enc_blocks":
            library = (lambda b: torch.matmul(b, dct),
                       [(D._mb_blocks(a[1], a[1][0].shape[1] // 16)
                         .reshape(-1, 64).to(torch.float64),)
                        for a in inputs[:16]])
        bench.record(k, "divxenc 640x480 VOPs", len(calls) / vops,
                     getattr(kernels, k), getattr(kernels, k + "_ref"),
                     inputs,
                     nbytes=sum(_enc_bytes(a, g, k) for a, g in calls)
                     / len(calls),
                     ops=sum(_enc_ops(a, g, k, n) for (a, g), n
                             in zip(calls, searched[k])) / len(calls),
                     ops_per_s=(F64_FMA_PER_S if k == "mpeg4_enc_blocks"
                                else INT32_OPS_PER_S),
                     library=library, reps=len(inputs), plain_reps=1)
        if k != "mpeg4_enc_blocks":
            emit(phase="mpeg4_enc_searched", kernel=k,
                 byte_sads_per_mb=sum(searched[k]) / sum(
                     a[0][0].numel() // 256 for a, _ in calls))
    # the wavefront's dependent steps: one macroblock each
    emit(phase="mpeg4_enc_me_wavefront", steps=40 + 2 * (30 - 1),
         ms=bench.stats["mpeg4_enc_me"]["ms"] / max(1, len(
             captured["mpeg4_enc_me"]) / vops))
    return checked_avi


def _unique_bytes(args) -> int:
    """Bytes of the distinct tensors among ``args`` (an anchor that
    several calls read counts once)."""
    return sum({t.data_ptr(): t.numel() * t.element_size()
                for t in _flat_tensors(args)}.values())


def _clone_rotation(calls) -> list:
    """Every call of ``calls`` (argument tuples) and clones of them, more
    than the card's L2 together: timed with a call for each, each finds
    its inputs in device memory as the path's next call would."""
    inputs = list(calls)
    while _unique_bytes(inputs) < L2_BYTES:
        inputs += [_tensors_clone(a) for a in calls]
    return inputs


def _run_divxenc(torch, cli, kernels, tmp, checked_avi):
    """Phase 4 for the divxenc path: dvd.vob through the port's CLI to a
    640x480 XVID AVI with the launch counts set to 0 just before and read
    just after (every kernel of the path launched; one block coder launch
    a VOP, one decision launch a P or B VOP), against ``checked_avi``,
    the AVI of phase 3's run on the card with every encoder kernel call
    held to its plain version, byte for byte: a check that the path
    gives the same bytes twice.  The whole chain (the dvd.vob decode, the
    zoom and hqdn3d too) is held to the JAX CLI's digest in phase 5.
    Returns the launches and the AVI."""
    from tcforge_tpu_torch.io.avi import AviReader
    out = tmp / "divxenc.avi"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main([*divxenc_argv(out), "--device", "cuda"])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(rc == 0, f"divxenc: CLI exit code {rc}")
    with AviReader(str(out)) as r:
        check((r.video.fourcc, r.video.width, r.video.height,
               r.video_frames) == ("XVID", DIVXENC_W, DIVXENC_H,
                                   DIVXENC_FRAMES),
              f"divxenc: {r.video.fourcc} {r.video.width}x{r.video.height}"
              f" {r.video_frames} frames")
    emit(phase="path", path="divxenc", frames=DIVXENC_FRAMES,
         seconds=e2e_s, e2e_fps=DIVXENC_FRAMES / e2e_s,
         launches={k: launches[k] for k in DIVXENC_KERNELS})
    for name in DIVXENC_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  "divxenc path")
    check(launches["mpeg4_enc_blocks"] == DIVXENC_FRAMES
          and launches["mpeg4_enc_me"] + launches["mpeg4_enc_bme"]
          < DIVXENC_FRAMES,
          f"divxenc: launches {launches} for {DIVXENC_FRAMES} VOPs")
    want = out.read_bytes()
    same = want == checked_avi
    emit(phase="path_vs_checked_run", path="divxenc", identical=same,
         sha256=hashlib.sha256(want).hexdigest())
    check(same, "divxenc: the card's output differs from the checked "
                "run's")
    return launches, out


def divxenc_argv(out) -> list:
    return ["-i", str(MPEG_DATA / "dvd.vob"), *DIVXENC_ARGS, "-o", str(out),
            "--batch", str(MAIN_BATCH), "--progress_off", "-q"]


def _decode_avi(path, dev):
    imp = _avi_importer(path, dev)
    out = []
    while (b := imp.read_video_batch(MAIN_BATCH)) is not None:
        out += [tuple(b[k][i].cpu().numpy() for k in "yuv")
                for i in range(len(b["y"]))]
    imp.close()
    return out


def _xvid_goldens(torch, cli, tmp, divxenc_avi):
    """Phase 5 for MPEG-4 export: every ``XVID_GOLDEN`` case on the card
    (divxenc from phase 4's run), its outputs' SHA-256 against the JAX
    CLI's pinned digests; then the read-back: the divxenc AVI decoded by
    the port's own MPEG-4 importer on the card equals its decode on the
    CPU, and 640x480 encodes at cfg10's settings written to AVIs and
    decoded on the card equal the encoder's reconstruction without 4MV,
    and with 4MV drift where the JAX encoder's 4MV skip keeps a
    reconstruction that no decoder makes (a count, reported)."""
    from tcforge_tpu_torch.io.avi import AviVideoStream, AviWriter
    from tcforge_tpu_torch.io.mpeg4enc import Mpeg4Encoder
    dev = torch.device("cuda")
    for case in XVID_GOLDEN:
        if case == "divxenc":
            digests = [sha256_file(divxenc_avi)]
            rc = 0
        else:
            d = tmp / f"xvid_golden_{case}"
            d.mkdir()
            rc = cli.main([*xvid_golden_argv(case, d), "--device", "cuda",
                           "--progress_off", "-q"])
            digests = [sha256_file(f) if f.exists() else None
                       for f in xvid_golden_outputs(case, d)]
        emit(phase="golden", path=f"xvid_{case}", sha256=digests,
             pinned=list(XVID_GOLDEN_SHA256[case]))
        check(rc == 0 and digests == list(XVID_GOLDEN_SHA256[case]),
              f"xvid {case} golden output differs from the JAX-pinned "
              "digest")
    card = _decode_avi(divxenc_avi, dev)
    host = _decode_avi(divxenc_avi, torch.device("cpu"))
    same = len(card) == DIVXENC_FRAMES and all(
        all(np.array_equal(a, b) for a, b in zip(x, y))
        for x, y in zip(card, host))
    emit(phase="readback", path="divxenc", frames=len(card),
         card_equals_cpu=same)
    check(same, "divxenc read-back: the card's decode differs from the "
                "CPU's")
    for kind, four_mv in (("wave", False), ("still", False),
                          ("wave", True), ("still", True)):
        frames = encoder_clip(DIVXENC_W, DIVXENC_H, READBACK_FRAMES,
                              seed=21, kind=kind)
        enc = Mpeg4Encoder(DIVXENC_W, DIVXENC_H, fps=29.97, gop=12,
                           bframes=2, four_mv=four_mv, bitrate_kbps=1500,
                           keep_recon_log=True)
        chunks = []
        for f in frames:
            chunks += enc.push(*(torch.from_numpy(p).to(dev) for p in f))
        chunks += enc.flush()
        path = tmp / f"readback_{kind}_{int(four_mv)}.avi"
        w = AviWriter(str(path), AviVideoStream(fourcc="XVID",
                                                width=DIVXENC_W,
                                                height=DIVXENC_H, fps=29.97))
        for c, key in chunks:
            w.write_video_frame(c, key)
        w.close()
        got = _decode_avi(path, dev)
        drift = [i for i, g in enumerate(got) if not all(
            np.array_equal(a, b.cpu().numpy())
            for a, b in zip(g, enc.recon_log[i]))]
        emit(phase="readback", clip=kind, four_mv=four_mv, frames=len(got),
             drift_frames=len(drift))
        check(len(got) == READBACK_FRAMES,
              f"read-back {kind}: {len(got)} frames")
        if not four_mv:
            check(not drift, f"read-back {kind} without 4MV: frames "
                             f"{drift} differ from the encoder's "
                             "reconstruction")
        path.unlink()


def divxenc_stages(torch, dev, src, out, batch: int = MAIN_BATCH) -> dict:
    """The divxenc path's stages serially on the card, each timed alone
    with the card synchronized after it: the host parse and plan, the
    decode, the chain (zoom and hqdn3d), the encoder's decisions
    (``mpeg4_enc_me``, ``mpeg4_enc_bme``) and block coder, the records'
    copy to the host, the syntax writer and the AVI multiplexor.  Returns
    ms per batch of each, their sum and the frames/s of the sum and of
    the slowest stage."""
    from tcforge_tpu_torch.core.formats import ImageFormat
    from tcforge_tpu_torch.core.frame import FrameBatch
    from tcforge_tpu_torch.core.job import FilterSpec, Job
    from tcforge_tpu_torch.io.avi import AviVideoStream, AviWriter
    from tcforge_tpu_torch.io.mpeg4enc import Mpeg4Encoder
    from tcforge_tpu_torch.ops import kernels
    from tcforge_tpu_torch.pipeline.chain import VideoChain
    ms = dict.fromkeys(("parse", "decode", "chain", "me", "blocks",
                        "records", "writer", "mux"), 0.0)
    saved = {k: getattr(kernels, k) for k in MPEG4ENC_KERNELS}

    def timed(key, fn):
        def call(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(*a)
            torch.cuda.synchronize()
            ms[key] += (time.perf_counter() - t0) * 1e3
            return got
        return call
    job = Job(zoom_width=DIVXENC_W, zoom_height=DIVXENC_H,
              filters=[FilterSpec("hqdn3d", "luma=4.0")])
    imp = _mpeg_importer(src, dev)
    chain = VideoChain(job, ImageFormat.YUV420P, imp.width, imp.height)
    states = chain.initial_states(dev)
    enc = Mpeg4Encoder(DIVXENC_W, DIVXENC_H, fps=29.97, gop=12, bframes=2,
                       four_mv=True, bitrate_kbps=1500)
    w = AviWriter(str(out), AviVideoStream(fourcc="XVID", width=DIVXENC_W,
                                           height=DIVXENC_H, fps=29.97))
    enc._records = timed("records", enc._records)
    for name in ("_write_ivop", "_write_pvop", "_write_bvop"):
        setattr(enc, name, timed("writer", getattr(enc, name)))
    frames = batches = 0
    for k in MPEG4ENC_KERNELS:
        setattr(kernels, k, timed("blocks" if k == "mpeg4_enc_blocks"
                                  else "me", saved[k]))
    try:
        torch.cuda.synchronize()
        while True:
            t0 = time.perf_counter()
            plan = imp.plan_batch(batch)
            t1 = time.perf_counter()
            if plan is None:
                break
            planes = imp.execute(plan)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            n = planes["y"].shape[0]
            fb = FrameBatch(format=ImageFormat.YUV420P, y=planes["y"],
                            u=planes["u"], v=planes["v"],
                            attrs=torch.zeros((n,), dtype=torch.int32,
                                              device=dev),
                            frame_ids=torch.arange(frames, frames + n,
                                                   dtype=torch.int32,
                                                   device=dev), fps=29.97)
            result, states = chain(fb, states)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            chunks = []
            for i in range(n):
                chunks += enc.push(result.y[i], result.u[i], result.v[i])
            if frames + n >= 3 * DIVXENC_FRAMES:
                chunks += enc.flush()
            t4 = time.perf_counter()
            for c, key in chunks:
                w.write_video_frame(c, key)
            t5 = time.perf_counter()
            for key, a, b in (("parse", t0, t1), ("decode", t1, t2),
                              ("chain", t2, t3), ("mux", t4, t5)):
                ms[key] += (b - a) * 1e3
            frames += n
            batches += 1
    finally:
        for k, fn in saved.items():
            setattr(kernels, k, fn)
        w.close()
        imp.close()
    per_batch = {k: v / batches for k, v in ms.items()}
    total = sum(per_batch.values())
    return {"frames": frames, "ms_per_batch": per_batch,
            "sum_ms_per_batch": total,
            "serial_fps": frames / (total * batches / 1e3),
            "overlapped_fps": frames / (max(per_batch.values())
                                        * batches / 1e3)}


def _divxenc_rates(torch, dev, cli, tmp):
    """Phase 6 for the divxenc path, on dvd.vob's stream three times over
    (144 frames, nine batches): the CLI, wall clock to the last byte,
    ``DIVXENC_RUNS`` runs after an untimed one (median and spread), then
    ``divxenc_stages``."""
    src = _dvd_long_es(tmp)
    frames = 3 * DIVXENC_FRAMES
    out = tmp / "divxenc_long.avi"
    fps = []
    for r in range(DIVXENC_RUNS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["-i", str(src), "-o", str(out), *DIVXENC_ARGS,
                       "--batch", str(MAIN_BATCH), "--device", "cuda",
                       "--progress_off", "-q"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"divxenc CLI: exit code {rc}")
        if r:
            fps.append(frames / seconds)
    emit(phase="cli", path="divxenc", frames=frames, fps=fps,
         median_fps=float(np.median(fps)), min_fps=min(fps),
         max_fps=max(fps),
         stages=divxenc_stages(torch, dev, src, tmp / "stages.avi"))
    for f in (src, out, tmp / "stages.avi"):
        f.unlink()


# ---------------------------------------------------------------------- #
# The Motion-JPEG path (mjpeg): legacy.avi through -x avi, jpeg_idct and
# jpeg_color once each a batch; the JPEG fixtures and goldens

_JPEG_WRAPPERS = {"jpeg_idct": "jpeg_idct", "jpeg_color": "jpeg_color"}


def _idct_bytes(args) -> int:
    """What one ``jpeg_idct`` call must move: its coefficients and
    quantizers in, a byte a coefficient out."""
    coef, qt, _geom = args
    return _nbytes(coef, qt) + coef.shape[0] * 64


def _color_bytes(args) -> int:
    """What one ``jpeg_color`` call must move: the samples in, three
    bytes a pixel out."""
    samples, geom = args
    frames = samples.shape[0] // geom.blocks
    return _nbytes(samples) + frames * geom.width * geom.height * 3


def _color_ops(args) -> int:
    samples, geom = args
    frames = samples.shape[0] // geom.blocks
    per_pixel = ((JPEG_YCC_OPS if geom.color == 0 else 0)
                 + sum(JPEG_UP_OPS[c.up] for c in geom.comps))
    return per_pixel * frames * geom.width * geom.height


def _idct_library(torch, coef, qt, geom):
    """The yardstick of ``jpeg_idct``: every block's 8x8 IDCT as one
    float64 ``torch.matmul`` of the dequantized coefficients (computed
    beforehand, not timed) with the 64x64 basis; a product, not libjpeg's
    integer arithmetic, so timed only."""
    from tcforge_tpu_torch.io import jpeg
    k, n = np.mgrid[0:8, 0:8]
    c = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    basis = torch.from_numpy(np.kron(c, c)).to(coef.device)
    q = (qt.reshape(-1, 64).to(torch.int32) & 0xFFFF)[
        jpeg._block_comps(geom, coef.shape[0], coef.device)]
    deq = (coef.to(torch.float64) * q.to(torch.float64))
    return torch.matmul, [(deq, basis)]


def _check_jpeg_kernels(torch, kernels, bench):
    """Phase 3 for the JPEG kernels: every call of ``jpeg_idct`` and
    ``jpeg_color`` while every fixture of tests/data/mjpeg decodes on
    the card (``MJPEG_FILES``: legacy.avi's 640x480 4:2:0 batch, 4:4:4,
    4:2:2, 4:4:0, 4:1:1, gray, non-interleaved scans, 16-bit tables,
    Adobe RGB, RGB by component ids, restart intervals, odd sizes,
    chroma 1 and 2 samples wide, AVI1 fields, no DHT, the MOV samples),
    held against the plain versions at tolerance 0; then random records
    off the path (``JPEG_RANDOM_GEOMS``: int16 coefficients over their
    whole range and 16-bit quantizers, whose products send pass 2 far
    past the range-limit table's [-512, 512) so that it wraps, and
    random samples through every upsampling form); then each timed on a
    16-frame batch of legacy.avi's frames over inputs past L2, beside
    its plain version, its bound and, for ``jpeg_idct``,
    ``_idct_library`` (no PyTorch call upsamples and converts JPEG
    colour: ``jpeg_color``'s library is none)."""
    from tcforge_tpu_torch.io import jpeg
    dev = bench.dev
    captured = []
    with checked_kernels(kernels, bench, "jpeg fixtures",
                         _JPEG_WRAPPERS) as counts:
        checked = kernels.jpeg_idct

        def keep(coef, qt, geom):
            captured.append((coef.clone(), qt.clone(), geom))
            return checked(coef, qt, geom)
        seen = {}
        for name in MJPEG_FILES:
            if name == "legacy.avi":
                kernels.jpeg_idct = keep
            imp = _avi_importer(MJPEG_DATA / name, dev)
            seen[name] = 0
            while (b := imp.read_video_batch(MAIN_BATCH)) is not None:
                seen[name] += b["rgb"].shape[0]
            imp.close()
            kernels.jpeg_idct = checked
        stream_counts = dict(counts)
    rng = np.random.default_rng(17)
    for w, h, color, sampling in JPEG_RANDOM_GEOMS:
        geom = jpeg.geometry(w, h, color, list(sampling))
        frames = 1 if w * h > 100000 else 3
        coef = torch.from_numpy(rng.integers(
            -32768, 32768, (frames * geom.blocks, 64)).astype(np.int16)
        ).to(dev)
        qt = torch.from_numpy(rng.integers(
            0, 65536, (frames, 4, 64)).astype(np.uint16).view(np.int16)
        ).to(dev)
        label = f"random {w}x{h} {sampling}"
        bench.check("jpeg_idct", label, kernels.jpeg_idct(coef, qt, geom),
                    kernels.jpeg_idct_ref(coef, qt, geom), quiet=True)
        samples = torch.from_numpy(rng.integers(
            0, 256, (frames * geom.blocks, 64), dtype=np.uint8)).to(dev)
        bench.check("jpeg_color", label, kernels.jpeg_color(samples, geom),
                    kernels.jpeg_color_ref(samples, geom), quiet=True)
    for kernel, n in stream_counts.items():
        emit(phase="kernel_sweep", kernel=kernel, cases=n,
             files=len(MJPEG_FILES), frames=sum(seen.values()),
             off_path=len(JPEG_RANDOM_GEOMS), max_abs_err=0)
    check(len(captured) == 1 and seen["legacy.avi"] == MJPEG_FRAMES,
          f"legacy.avi gave {len(captured)} jpeg_idct calls for "
          f"{seen['legacy.avi']} frames")
    coef8, qt8, geom = captured[0]

    def batch16():
        return (torch.cat([coef8, coef8]), torch.cat([qt8, qt8]), geom)
    inputs = bench.rotation(batch16)
    nblocks = 2 * coef8.shape[0]
    case = f"{MJPEG_W}x{MJPEG_H} 4:2:0, a batch of {2 * MJPEG_FRAMES}"
    bench.record("jpeg_idct", case, 1, kernels.jpeg_idct,
                 kernels.jpeg_idct_ref, inputs, nbytes=_idct_bytes(inputs[0]),
                 ops=JPEG_IDCT_OPS * nblocks,
                 library=_idct_library(torch, *inputs[0]),
                 reps=max(20, len(inputs)), plain_reps=2)
    samples = bench.rotation(lambda: (kernels.jpeg_idct(*batch16()), geom))
    bench.record("jpeg_color", case, 1, kernels.jpeg_color,
                 kernels.jpeg_color_ref, samples,
                 nbytes=_color_bytes(samples[0]), ops=_color_ops(samples[0]),
                 reps=max(20, len(samples)), plain_reps=2)


def mjpeg_argv(out_dir) -> list:
    """The mjpeg path's CLI arguments, its Y4M and WAV in ``out_dir``."""
    return ["-i", str(MJPEG_DATA / "legacy.avi"), *MJPEG_ARGS, "-o",
            f"{out_dir}/out.y4m", "-m", f"{out_dir}/out.wav",
            "--progress_off", "-q"]


def _mjpeg_outputs(out_dir) -> list:
    return [(Path(out_dir) / f).read_bytes() for f in ("out.y4m", "out.wav")]


def _run_mjpeg(torch, cli, kernels, tmp):
    """Phase 4 for the mjpeg path: legacy.avi through the port's CLI with
    the launch counts set to 0 just before and read just after (one
    ``jpeg_idct`` and one ``jpeg_color`` a batch, hqdn3d's), its Y4M and
    WAV equal byte for byte to the same CLI's with --device cpu and at
    --batch 3 with --prefetch 1 (three batches: three launches of each).
    Returns the launches."""
    runs = {}
    for key, extra in (("cuda", ["--batch", str(MAIN_BATCH)]),
                       ("cpu", []), ("b3", ["--batch", "3", "--prefetch",
                                            "1"])):
        d = tmp / f"mjpeg_{key}"
        d.mkdir()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main([*mjpeg_argv(d), *extra, "--device",
                       "cpu" if key == "cpu" else "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"mjpeg ({key}): CLI exit code {rc}")
        runs[key] = (dict(kernels.launches), _mjpeg_outputs(d), seconds)
    launches, want, seconds = runs["cuda"]
    emit(phase="path", path="mjpeg", frames=MJPEG_FRAMES, seconds=seconds,
         e2e_fps=MJPEG_FRAMES / seconds,
         launches={k: launches[k] for k in MJPEG_KERNELS},
         launches_b3={k: runs["b3"][0][k] for k in _JPEG_WRAPPERS})
    for name in MJPEG_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  "mjpeg path")
    batches = -(-MJPEG_FRAMES // MAIN_BATCH)
    for key, n in (("cuda", batches), ("b3", -(-MJPEG_FRAMES // 3))):
        got = runs[key][0]
        check(got["jpeg_idct"] == got["jpeg_color"] == n,
              f"mjpeg ({key}): {got['jpeg_idct']} jpeg_idct and "
              f"{got['jpeg_color']} jpeg_color launches for {n} batches")
    for key in ("cpu", "b3"):
        same = runs[key][1] == want
        emit(phase="path_vs_cpu" if key == "cpu" else "engine_vs_batch16",
             path="mjpeg", identical=same,
             sha256=[hashlib.sha256(b).hexdigest() for b in want])
        check(same, f"mjpeg: the card's output differs from the {key} run's")
    return launches


def _mjpeg_goldens(cli, tmp):
    """Phase 5 for the JPEG import: every ``MJPEG_GOLDEN`` case on the
    card, its outputs' SHA-256 against the JAX CLI's pinned digests."""
    for case in MJPEG_GOLDEN:
        d = tmp / f"mjpeg_golden_{case}"
        d.mkdir()
        rc = cli.main([*mjpeg_golden_argv(case, d), "--device", "cuda",
                       "--progress_off", "-q"])
        digests = [sha256_file(f) if f.exists() else None
                   for f in mjpeg_golden_outputs(case, d)]
        emit(phase="golden", path=f"mjpeg_{case}", sha256=digests,
             pinned=list(MJPEG_GOLDEN_SHA256[case]))
        check(rc == 0 and digests == list(MJPEG_GOLDEN_SHA256[case]),
              f"mjpeg {case} golden output differs from the JAX-pinned "
              "digest")


def mjpeg_long(directory, copies: int) -> Path:
    """legacy.avi's video chunks and MP3 frames ``copies`` times over, in
    one AVI written by the port's own ``AviWriter``."""
    from tcforge_tpu_torch.io.avi import (AviAudioStream, AviReader,
                                          AviVideoStream, AviWriter)
    with AviReader(str(MJPEG_DATA / "legacy.avi")) as r:
        v, a = r.video, r.audio[0]
        video = [r.read_video_frame(i)[0] for i in range(r.video_frames)]
        audio = list(r.read_audio_chunks(0))
    path = Path(directory) / "legacy_long.avi"
    w = AviWriter(str(path), AviVideoStream(fourcc=v.fourcc, width=v.width,
                                            height=v.height, fps=v.fps),
                  [AviAudioStream(format_tag=a.format_tag,
                                  channels=a.channels, rate=a.rate,
                                  bits=a.bits, byte_rate=a.byte_rate)])
    per = -(-len(audio) // len(video))
    for _ in range(copies):
        for i, chunk in enumerate(video):
            w.write_video_frame(chunk)
            for payload in audio[i * per:(i + 1) * per]:
                w.write_audio(payload)
    w.close()
    return path


def _mjpeg_rates(torch, dev, cli, tmp):
    """Phase 6 for the mjpeg path, on legacy.avi's chunks repeated to
    ``MJPEG_RATE_FRAMES`` frames (``mjpeg_long``): its decode on the card
    against the fixture's frames repeated, frame for frame; the CLI,
    wall clock to the last byte, ``MJPEG_RUNS`` runs after an untimed
    one (median and spread), the MP3 decoder's own seconds in its
    process beside each; then ``avi_stages`` with the audio track, its
    first batch untimed (the worker's start, hqdn3d's tables)."""
    from tcforge_tpu_torch.core.job import FilterSpec, Job
    from tcforge_tpu_torch.io import adec_worker
    copies = MJPEG_RATE_FRAMES // MJPEG_FRAMES
    src = mjpeg_long(tmp, copies)
    one = []
    imp = _avi_importer(MJPEG_DATA / "legacy.avi", dev)
    while (b := imp.read_video_batch(MAIN_BATCH)) is not None:
        one += list(b["rgb"])
    imp.close()
    imp = _avi_importer(src, dev)
    seen = 0
    while (b := imp.read_video_batch(MAIN_BATCH)) is not None:
        for frame in b["rgb"]:
            check(torch.equal(frame, one[seen % len(one)]),
                  f"legacy_long: frame {seen} differs from legacy.avi's")
            seen += 1
    imp.close()
    check(seen == MJPEG_RATE_FRAMES, f"legacy_long gave {seen} frames")
    emit(phase="path_vs_repeat", path="mjpeg_long", frames=seen,
         identical=True)
    fps, decode_s = [], []
    for r in range(MJPEG_RUNS + 1):
        d0 = adec_worker.decode_seconds()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["-i", str(src), *MJPEG_ARGS, "-o",
                       str(tmp / "long.y4m"), "-m", str(tmp / "long.wav"),
                       "--batch", str(MAIN_BATCH), "--device", "cuda",
                       "--progress_off", "-q"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"mjpeg CLI: exit code {rc}")
        if r:
            fps.append(MJPEG_RATE_FRAMES / seconds)
            decode_s.append(adec_worker.decode_seconds() - d0)
    job = Job(filters=[FilterSpec("hqdn3d", "luma=4.0")],
              im_v_width=MJPEG_W, im_v_height=MJPEG_H)
    emit(phase="cli", path="mjpeg", frames=MJPEG_RATE_FRAMES, fps=fps,
         median_fps=float(np.median(fps)), min_fps=min(fps),
         max_fps=max(fps), mp3_decode_s=decode_s,
         stages=avi_stages(torch, dev, src, tmp / "stages.avi", job,
                           audio=True, warmup=1))
    for f in (src, tmp / "long.y4m", tmp / "long.wav", tmp / "stages.avi"):
        f.unlink()


# ---------------------------------------------------------------------- #
# The legacy-AVI export path, mjpegenc: 1080i with its WAV through -I 5,
# the zoom to 640x480 and hqdn3d into movjpeg (jpeg_ycc_down and
# jpeg_fdct_quant on the card, the Huffman coder on the host), lame (the
# in-tree MP3 encoder) and the avi multiplexor

_JPEGENC_WRAPPERS = {"jpeg_ycc_down": "jpeg_ycc_down",
                     "jpeg_fdct_quant": "jpeg_fdct_quant"}


def _ycc_down_bytes(args) -> int:
    """What one ``jpeg_ycc_down`` call must move: the RGB24 pixels in,
    the padded planes out."""
    rgb, geom = args
    return _nbytes(rgb) + rgb.shape[0] * geom.plane_bytes


def _fdct_bytes(args) -> int:
    """What one ``jpeg_fdct_quant`` call must move: the planes and the
    divisors in, two bytes a coefficient out."""
    planes, div, geom = args
    return _nbytes(planes, div) + planes.shape[0] * geom.blocks * 128


def _fdct_library(torch, planes, div, geom):
    """The yardstick of ``jpeg_fdct_quant``: every block's 8x8 DCT as one
    float64 ``torch.matmul`` of the blocks' samples less 128 (gathered
    beforehand, not timed) with the 64x64 basis; a product, not libjpeg's
    integer arithmetic and no quantization, so timed only."""
    from tcforge_tpu_torch.io import jpegenc
    k, n = np.mgrid[0:8, 0:8]
    c = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    basis = torch.from_numpy(np.kron(c, c).T.copy()).to(planes.device)
    offs, strides, _tabs, _dummies = jpegenc.block_sources(geom)
    r8 = torch.arange(8, device=planes.device)
    idx = (torch.from_numpy(offs).to(planes.device)[:, None, None]
           + r8[None, :, None] * torch.from_numpy(strides).to(
               planes.device)[:, None, None] + r8[None, None, :])
    blocks = (planes[:, idx].to(torch.float64) - 128).reshape(-1, 64)
    return torch.matmul, [(blocks, basis)]


def _check_jpegenc_kernels(torch, kernels, bench):
    """Phase 3 for the JPEG encode kernels: ``jpeg_ycc_down`` and
    ``jpeg_fdct_quant`` against their plain versions at tolerance 0 on
    the mjpegenc path's 640x480 batch of 16, and off the path on random
    RGB24 batches of ``JPEGENC_SHAPES`` (720x480, odd sizes, widths of 16
    and less, 1x1), each at ``JPEGENC_QUALITIES``; then each timed on the
    path's batch over inputs past L2, beside its plain version, its bound
    and, for ``jpeg_fdct_quant``, ``_fdct_library`` (no PyTorch call
    converts and downsamples as libjpeg does: ``jpeg_ycc_down``'s library
    is none)."""
    from tcforge_tpu_torch.io import jpegenc
    dev = bench.dev
    cases = 0
    for w, h, n in ((MJPEGENC_W, MJPEGENC_H, MAIN_BATCH), *JPEGENC_SHAPES):
        geom = jpegenc.enc_geometry(w, h)
        for q in JPEGENC_QUALITIES:
            rgb = bench.u8(n, h, w, 3)
            div = torch.from_numpy(jpegenc.divisors(
                jpegenc.quant_tables(q))).to(dev)
            label = f"{w}x{h}x{n} q{q}"
            planes = kernels.jpeg_ycc_down(rgb, geom)
            bench.check("jpeg_ycc_down", label, planes,
                        kernels.jpeg_ycc_down_ref(rgb, geom), quiet=True)
            bench.check("jpeg_fdct_quant", label,
                        kernels.jpeg_fdct_quant(planes, div, geom),
                        kernels.jpeg_fdct_quant_ref(planes, div, geom),
                        quiet=True)
            cases += 1
    for kernel in _JPEGENC_WRAPPERS:
        emit(phase="kernel_sweep", kernel=kernel, cases=cases,
             shapes=1 + len(JPEGENC_SHAPES),
             qualities=list(JPEGENC_QUALITIES), max_abs_err=0)
    geom = jpegenc.enc_geometry(MJPEGENC_W, MJPEGENC_H)
    div = torch.from_numpy(jpegenc.divisors(jpegenc.quant_tables(90))).to(
        dev)
    case = f"{MJPEGENC_W}x{MJPEGENC_H}, a batch of {MAIN_BATCH}, q90"
    rgbs = bench.rotation(lambda: (bench.u8(MAIN_BATCH, MJPEGENC_H,
                                            MJPEGENC_W, 3), geom))
    bench.record("jpeg_ycc_down", case, 1, kernels.jpeg_ycc_down,
                 kernels.jpeg_ycc_down_ref, rgbs,
                 nbytes=_ycc_down_bytes(rgbs[0]),
                 ops=JPEG_YCC_DOWN_OPS * MAIN_BATCH * 64 * geom.mcux
                 * geom.mcuy, reps=max(20, len(rgbs)), plain_reps=2)
    planes = [(kernels.jpeg_ycc_down(*a), div, geom) for a in rgbs]
    bench.record("jpeg_fdct_quant", case, 1, kernels.jpeg_fdct_quant,
                 kernels.jpeg_fdct_quant_ref, planes,
                 nbytes=_fdct_bytes(planes[0]),
                 ops=JPEG_FDCT_OPS * MAIN_BATCH * geom.blocks,
                 library=_fdct_library(torch, *planes[0]),
                 reps=max(20, len(planes)), plain_reps=2)


def mjpegenc_argv(src, wav, out, device: str = "cuda") -> list:
    return ["-i", str(src), "-p", str(wav), *MJPEGENC_ARGS, "-o", str(out),
            "--batch", str(MAIN_BATCH), "--device", device, "--progress_off",
            "-q"]


def _run_mjpegenc(torch, cli, kernels, bench, directory):
    """Phase 4 for the mjpegenc path: 1080i with its WAV through the
    port's CLI to a 640x480 MJPG AVI with its MP3 track, the launch
    counts set to 0 just before and read just after (one launch of each
    JPEG kernel a batch, the zoom's and hqdn3d's); the same CLI with
    every JPEG kernel call held against its plain version (max abs err
    0), byte for byte; the AVI read back through the port's Motion-JPEG
    importer on the card and on the CPU, the same frames and samples,
    every frame at 640x480 and as many samples as the WAV's in whole MP3
    frames.  Returns the launches."""
    from tcforge_tpu_torch.io.wav import WavReader
    src, wav = write_author_inputs(directory, MAIN_W, MAIN_H,
                                   MJPEGENC_FRAMES)
    out = Path(directory) / "mjpegenc.avi"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(mjpegenc_argv(src, wav, out))
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(rc == 0, f"mjpegenc: CLI exit code {rc}")
    emit(phase="path", path="mjpegenc", frames=MJPEGENC_FRAMES,
         seconds=e2e_s, e2e_fps=MJPEGENC_FRAMES / e2e_s,
         bytes=out.stat().st_size,
         launches={k: launches[k] for k in MJPEGENC_KERNELS})
    for name in MJPEGENC_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  "mjpegenc path")
    batches = -(-MJPEGENC_FRAMES // MAIN_BATCH)
    check(launches["jpeg_ycc_down"] == launches["jpeg_fdct_quant"]
          == batches, f"mjpegenc: {launches['jpeg_ycc_down']} and "
          f"{launches['jpeg_fdct_quant']} JPEG launches for {batches} "
          "batches")
    checked = Path(directory) / "mjpegenc_checked.avi"
    with checked_kernels(kernels, bench, "mjpegenc path",
                         _JPEGENC_WRAPPERS) as counts:
        rc = cli.main(mjpegenc_argv(src, wav, checked))
    check(rc == 0, f"mjpegenc with checked kernels: exit code {rc}")
    same = checked.read_bytes() == out.read_bytes()
    emit(phase="path_vs_plain", path="mjpegenc", identical=same,
         checked_calls=dict(counts), sha256=sha256_file(out))
    check(same and all(v == batches for v in counts.values()),
          "mjpegenc: the AVI with every JPEG kernel call checked differs")
    back = {}
    for device in ("cuda", "cpu"):
        y4m = Path(directory) / f"mjpegenc_back_{device}.y4m"
        back_wav = Path(directory) / f"mjpegenc_back_{device}.wav"
        rc = cli.main(["-i", str(out), "-x", "avi", "-o", str(y4m), "-m",
                       str(back_wav), "--device", device, "--progress_off",
                       "-q"])
        check(rc == 0, f"mjpegenc read back on {device}: exit code {rc}")
        back[device] = (y4m.read_bytes(), back_wav.read_bytes())
        y4m.unlink()
    with WavReader(str(wav)) as r:
        want_samples = r.total_samples
    with WavReader(str(Path(directory) / "mjpegenc_back_cuda.wav")) as r:
        got = r.read_samples(r.total_samples)
    header = back["cuda"][0].split(b"\n", 1)[0]
    ok = (back["cuda"] == back["cpu"]
          and f" W{MJPEGENC_W} H{MJPEGENC_H} ".encode() in header
          and back["cuda"][0].count(b"FRAME\n") == MJPEGENC_FRAMES
          and got.shape[1] == 2
          and 0 <= got.shape[0] - want_samples < 1152
          and int(np.abs(got.astype(np.int32)).max()) > 1000)
    emit(phase="mjpegenc_read_back", card_vs_cpu=back["cuda"] == back["cpu"],
         header=header.decode(), frames=back["cuda"][0].count(b"FRAME\n"),
         mp3_samples=int(got.shape[0]), wav_samples=want_samples)
    check(ok, "mjpegenc: the AVI does not read back as 48 frames at "
              "640x480 with the WAV's length of audio, the same on the "
              "card and the CPU")
    for f in (checked, *Path(directory).glob("mjpegenc_back_*")):
        f.unlink()
    return launches


def _mjpegenc_goldens(cli, tmp):
    """Phase 5 for the legacy-AVI and DVD-audio export: every
    ``MJPEGENC_GOLDEN`` case on the card, its SHA-256 against the JAX
    CLI's pinned digest (the JAX CLI on its in-tree audio encoders)."""
    for case in MJPEGENC_GOLDEN:
        d = tmp / f"mjpegenc_golden_{case}"
        d.mkdir()
        rc = cli.main([*mjpegenc_golden_argv(case, d), "--device", "cuda",
                       "--progress_off", "-q"])
        out = mjpegenc_golden_output(case, d)
        digest = sha256_file(out) if out.exists() else None
        emit(phase="golden", path=f"mjpegenc_{case}", sha256=digest,
             pinned=MJPEGENC_GOLDEN_SHA256[case])
        check(rc == 0 and digest == MJPEGENC_GOLDEN_SHA256[case],
              f"mjpegenc {case} golden output differs from the JAX-pinned "
              "digest")


def mjpegenc_stages(torch, cli, src, wav, out, frames: int) -> dict:
    """The mjpegenc CLI twice more, per 16-frame batch.  First with host
    clocks around the export's calls: the wait for the batch's device
    work before the coefficients' download (the chain and the two
    kernels), the download itself, the Huffman coder, the MP3 encoder
    (on the writer thread) and the AVI multiplexor (also there).  Then
    under torch.profiler: the device's busy time, and the device time of
    the chain's kernels (zoom, hqdn3d) and of each JPEG kernel."""
    from torch.profiler import ProfilerActivity, profile

    from tcforge_tpu_torch.io import jpegenc
    from tcforge_tpu_torch.modules.encoders import audio_enc
    from tcforge_tpu_torch.modules.muxers import basic
    ms = dict.fromkeys(("wait", "download", "huffman", "mp3", "mux"), 0.0)

    def timed(fn, key):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                ms[key] += (time.perf_counter() - t0) * 1e3
        return call

    download = jpegenc.download

    def waited(coef):
        t0 = time.perf_counter()
        torch.cuda.current_stream(coef.device).synchronize()
        ms["wait"] += (time.perf_counter() - t0) * 1e3
        return download(coef)

    patched = [(jpegenc, "entropy_code", "huffman"),
               (audio_enc.LameEncoder, "encode_audio", "mp3"),
               (audio_enc.LameEncoder, "flush", "mp3"),
               (basic.AviMuxer, "write_video", "mux"),
               (basic.AviMuxer, "write_audio", "mux")]
    saved = [getattr(owner, name) for owner, name, _ in patched]
    for owner, name, key in patched:
        setattr(owner, name, timed(getattr(owner, name), key))
    jpegenc.download = timed(waited, "download")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(mjpegenc_argv(src, wav, out))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        for (owner, name, _), fn in zip(patched, saved):
            setattr(owner, name, fn)
        jpegenc.download = download
    check(rc == 0, f"mjpegenc_stages: exit code {rc}")
    ms["download"] -= ms["wait"]
    batches = frames / MAIN_BATCH
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rc = cli.main(mjpegenc_argv(src, wav, out))
        torch.cuda.synchronize()
    check(rc == 0, f"mjpegenc_stages under the profiler: exit code {rc}")
    busy = _device_busy(prof, batches, ("zoom_", "scan_", "ycc_kernel",
                                        "fdct_kernel"))
    return {"frames": frames, "fps": frames / seconds,
            "ms_per_batch": {k: v / batches for k, v in ms.items()},
            "device_busy_ms_per_batch": busy["busy_ms_per_batch"],
            "named_kernels_ms_per_batch": busy["named_ms_per_batch"],
            "device_kernels_ms_per_batch": busy["kernels_ms_per_batch"]}


def _mjpegenc_rates(torch, cli, directory):
    """Phase 6 for the mjpegenc path: its CLI on phase 4's 48 frames of
    1080i with the WAV, wall clock to the last byte, ``MJPEGENC_RUNS``
    runs after an untimed one (median and spread); then
    ``mjpegenc_stages``."""
    src = Path(directory) / "author_in.y4m"
    wav = Path(directory) / "author_in.wav"
    out = Path(directory) / "mjpegenc_rate.avi"
    fps = []
    for r in range(MJPEGENC_RUNS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(mjpegenc_argv(src, wav, out))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"mjpegenc CLI: exit code {rc}")
        if r:
            fps.append(MJPEGENC_FRAMES / seconds)
    emit(phase="cli", path="mjpegenc", frames=MJPEGENC_FRAMES, fps=fps,
         median_fps=float(np.median(fps)), min_fps=min(fps),
         max_fps=max(fps))
    emit(phase="stages", path="mjpegenc",
         **mjpegenc_stages(torch, cli, src, wav, out, MJPEGENC_FRAMES))


# ---------------------------------------------------------------------- #
# The capture codecs: DV25 both ways (PAL 4:2:0, NTSC 4:1:1, AAUX audio)
# and NuppelVideo/RTjpeg: the dv path (a camcorder clip to a PAL DVD
# programme stream), the dvenc path (1080i broadcast material to DV for
# editing) and the nuv path (an analog capture to a DivX AVI)

DV_DATA = ROOT / "tests" / "data" / "dv"
CAPTURE_FRAMES = 48
CAPTURE_RUNS = 2             # phase 6's timed runs, after an untimed one
DV_CLIP_FRAMES = 16          # the camcorder clip, three times over
DV_CLIP_SEED = 43
DV_ARGS = ["-x", "dv", "-J", "hqdn3d=luma=4.0", "-y", "mpeg2,mp2enc,mpg",
           "-F", "gop_n=12:gop_m=3:rc=1:bitrate=6000"]
DVENC_ARGS = ["-I", "5", "-Z", "720x576", "-J", "hqdn3d=luma=4.0", "-y",
              "dv,raw,dv"]
NUV_W, NUV_H, NUV_FPS, NUV_RATE = 640, 480, (30000, 1001), 44100
NUV_ARGS = ["-x", "nuv", "-I", "5", "-J", "hqdn3d=luma=4.0", "-y",
            "xvid,lame,avi"]
DV_KERNELS = ("dv_idct", "hqdn3d_spatial_scan", "hqdn3d_temporal_scan",
              *ENCODE_KERNELS)
DVENC_KERNELS = ("dv_fdct_cost", "zoom_pass", "hqdn3d_spatial_scan",
                 "hqdn3d_temporal_scan")
NUV_KERNELS = ("rtjpeg_idct", "hqdn3d_spatial_scan", "hqdn3d_temporal_scan",
               "mpeg4_enc_me", "mpeg4_enc_blocks")
NUVRTJ_KERNELS = ("rtjpeg_fdct_quant",)
CAPTURE_WRAPPERS = {"dv_idct": "dv_idct", "dv_fdct_cost": "dv_fdct_cost",
                    "rtjpeg_idct": "rtjpeg_idct",
                    "rtjpeg_fdct_quant": "rtjpeg_fdct_quant"}
# the capture inputs the port's encoders write on the card, pinned by the
# JAX CLI's output on the same source (tests/data/dv/make_capture_goldens.py)
CAPTURE_INPUT_SHA256 = {
    "camcorder.dv": "e210e751392c403856f3cfc6cadad01f25533b739b12bfd8277f6672b6d16420",
    "capture.nuv": "980b7a10ec1346411e52e33b82803109f40ef93ba86324479dbeac5ba12e9788"}
# each path's output from the port's CLI with --device cpu, equal to the
# JAX CLI's (tests/data/dv/make_capture_goldens.py)
CAPTURE_CPU_SHA256 = {
    "dv": "aef90bc652a8595eb888288450798ca895f796b4175469bd3f3aea550b78b2d2",
    "dvenc": "822ec0c9e6b5356f89911bb00efe5646d1f4f740b672e5fe8dcb3a080ab7362b",
    "nuv": "74c899a69fa7409846e5a75b1da6a51f98322aecae088a6b7ec9828f4e0df9e7",
    "nuvrtj": "fd1e6c1d1c2f4feb4a08b82a651d28c4ea7ca53bd3385f57f7f09d99c9818825"}
# small cases through both CLIs (tests/test_torch_capture_cli.py): input,
# arguments, outputs, exit code; run in order (nuv_in reads nuvrtj's file)
CAPTURE_GOLDEN = {
    "dv_pal": ("pal.dv", ["-x", "dv", "-m", "o.wav"], ["o.y4m", "o.wav"], 0),
    "dv_ntsc": ("ntsc.dv", ["-x", "dv"], ["o.y4m"], 0),
    "dv_auto_hqdn3d": ("pal.dv", ["-J", "hqdn3d=luma=4.0", "--batch", "1"],
                       ["o.y4m"], 0),
    "dv_mpg": ("pal.dv", ["-x", "dv", "-y", "mpeg2,mp2enc,mpg"], ["o.mpg"],
               0),
    "dvenc_pal": ("pal.y4m", ["-p", "pal.wav", "-y", "dv,raw,dv"], ["o.dv"],
                  0),
    "dvenc_ntsc": ("ntsc.y4m", ["-y", "dv,raw,raw"], ["o.dv"], 0),
    "dv_ntsc_into_dv": ("ntsc.y4m", ["-y", "dv,raw,dv", "--max_frames", "1"],
                        [], 1),
    "dv_44k_into_dv": ("pal.y4m", ["-p", "a44.wav", "-y", "dv,raw,dv",
                                   "--max_frames", "1"], [], 1),
    "dv_size": ("small.y4m", ["-y", "dv,raw,raw"], [], 1),
    "nuvrtj": ("cif.y4m", ["-p", "a44.wav", "-y", "nuvrtj=quality=200,raw,"
                           "nuv"], ["o.nuv"], 0),
    "nuv_in": ("o.nuv", ["-x", "nuv", "-m", "o.wav"], ["o.y4m", "o.wav"], 0),
}
# the JAX CLI's outputs of each case, by file (None: a refusal)
CAPTURE_GOLDEN_SHA256 = {
    "dv_pal": ["5b49308a61ef163a814c942161661b956c69ac7b425bb614a4660fb722e87842", "5b03a5fe8bf01bb6d77b37a2180b6eed8c3c3804ed0c539c6f7405a1c7179186"],
    "dv_ntsc": ["e922f1d050a93c110553df7abb471549e87cfbc753ddf8ddeabcb8f0df2a0fcc"],
    "dv_auto_hqdn3d": ["91bbddeecf5f2da31213010d5d965397ad1982dc85445aa26f3d323aed4c0d74"],
    "dv_mpg": ["7fe1e418e15464ba8baa205ae8a8a63d202649fff9a875b1db0127fb5cdbdb9f"],
    "dvenc_pal": ["a5fae739d58466fdf2685436230e69e126036bc1141b5dbc1d35b1168e585ef5"],
    "dvenc_ntsc": ["0622f59cd4fb35f7c9a2771d02d09cabe68e701500ac99c1ad86fbcb92d358db"],
    "dv_ntsc_into_dv": [],
    "dv_44k_into_dv": [],
    "dv_size": [],
    "nuvrtj": ["8bf68bebfdb4eba27082d111a5b7576436ef5c62768cd0d5657b041ad1fd1a1b"],
    "nuv_in": ["c035605ff0b723f02f1408829ca6e04292faab3f5a747910ba401c50f8e15fe3", "ea0cec836b40b826f4b0df8bde32260df2e9d661f691e4fb6f6b50b0379d05df"],
}
# the operations a block's transform takes, for the bounds: dv_idct's
# 64-bit row and column passes (two int32 operations each), RTjpeg's
DV_IDCT_OPS = 2 * (8 * 60 + 8 * 60 + 64)
RTJPEG_OPS = 2 * (8 * 44 + 8 * 44 + 64 * 4)


def capture_input(name: str, directory) -> Path:
    """A ``CAPTURE_GOLDEN`` input in ``directory``: the DV fixtures, or
    written here (seeded, numpy only): 720x576 and 720x480 motion clips of
    two frames, a 48 kHz and a 44.1 kHz WAV, a 64x48 clip, a 176x144 clip
    of ten frames; ``o.nuv`` is the nuvrtj case's output."""
    d = Path(directory)
    if name.endswith(".dv"):
        return DV_DATA / name
    path = d / name
    if path.exists() or name == "o.nuv":
        return path
    if name == "pal.y4m":
        write_motion_y4m(path, 720, 576, 2, seed=5, fps=(25, 1))
    elif name == "ntsc.y4m":
        write_motion_y4m(path, 720, 480, 2, seed=6)
    elif name == "small.y4m":
        write_motion_y4m(path, 64, 48, 2, seed=7, fps=(25, 1))
    elif name == "cif.y4m":
        write_motion_y4m(path, 176, 144, 10, seed=8)
    elif name == "pal.wav":
        write_test_wav(path, 2 * 1920, seed=9, frame=1920)
    elif name == "a44.wav":
        write_test_wav(path, 10 * 1472, seed=10, rate=44100, frame=1472)
    else:
        raise KeyError(name)
    return path


def capture_golden_argv(case: str, directory) -> list:
    """The CLI arguments of a ``CAPTURE_GOLDEN`` case in ``directory``
    (inputs written there, outputs named there); ``nuv_in`` reads the
    ``nuvrtj`` case's file from the same directory."""
    d = Path(directory)
    src, args, outs, _ = CAPTURE_GOLDEN[case]
    argv = ["-i", str(capture_input(src, d))]
    for a in args:
        if a == "o.wav":                 # -m's output
            a = str(d / a)
        elif a.endswith(".wav"):         # -p's input
            a = str(capture_input(a, d))
        argv.append(a)
    main_out = next((o for o in outs if o != "o.wav"), "o.out")
    return [*argv, "-o", str(d / main_out), "--progress_off", "-q"]


def capture_golden_outputs(case: str, directory) -> list:
    return [Path(directory) / o for o in CAPTURE_GOLDEN[case][2]]


def capture_inputs(cli, kernels, directory, device: str = "cuda") -> dict:
    """The three paths' inputs in ``directory``, written by the port's
    encoders from seeded sources: ``camcorder.dv`` (DV_CLIP_FRAMES
    frames of ``write_motion_y4m`` at 720x576 and 25 fps with a 48 kHz
    stereo WAV, ``-y dv,raw,dv``) and ``camcorder48.dv`` (it three times
    over); ``broadcast.y4m`` (1920x1080 interlaced, 25 fps) and its WAV;
    ``capture.nuv`` (640x480 at 29.97 fps, RTjpeg quality 255 with 44.1
    kHz stereo PCM, ``-y nuvrtj,raw,nuv``).  Returns the paths and the
    launches of the two encodes."""
    d = Path(directory)
    src, wav = d / "camcorder.y4m", d / "camcorder.wav"
    write_motion_y4m(src, 720, 576, DV_CLIP_FRAMES, seed=DV_CLIP_SEED,
                     fps=(25, 1))
    write_test_wav(wav, DV_CLIP_FRAMES * 1920, seed=DV_CLIP_SEED,
                   frame=1920)
    clip = d / "camcorder.dv"
    kernels.reset_launches()
    rc = cli.main(["-i", str(src), "-p", str(wav), "-y", "dv,raw,dv", "-o",
                   str(clip), "--device", device, "--progress_off", "-q"])
    check(rc == 0, f"the camcorder clip's encode: exit code {rc}")
    dv_launches = dict(kernels.launches)
    clip48 = d / "camcorder48.dv"
    clip48.write_bytes(clip.read_bytes() * (CAPTURE_FRAMES // DV_CLIP_FRAMES))
    bsrc, bwav = d / "broadcast.y4m", d / "broadcast.wav"
    write_motion_y4m(bsrc, MAIN_W, MAIN_H, CAPTURE_FRAMES, seed=47,
                     fps=(25, 1))
    write_test_wav(bwav, CAPTURE_FRAMES * 1920, seed=47, frame=1920)
    nsrc, nwav = d / "capture.y4m", d / "capture.wav"
    write_motion_y4m(nsrc, NUV_W, NUV_H, CAPTURE_FRAMES, seed=53,
                     fps=NUV_FPS)
    write_test_wav(nwav, CAPTURE_FRAMES * 1472, seed=53, rate=NUV_RATE,
                   frame=1472)
    nuv = d / "capture.nuv"
    kernels.reset_launches()
    rc = cli.main(["-i", str(nsrc), "-p", str(nwav), "-y", "nuvrtj,raw,nuv",
                   "-o", str(nuv), "--device", device, "--progress_off",
                   "-q"])
    check(rc == 0, f"the capture's encode: exit code {rc}")
    nuv_launches = dict(kernels.launches)
    return {"clip": clip, "clip48": clip48, "broadcast": (bsrc, bwav),
            "nuv": nuv, "nuv_source": (nsrc, nwav),
            "launches": {"dv_clip": dv_launches, "nuvrtj": nuv_launches}}


def capture_argv(name: str, inputs: dict, out, frames=None) -> list:
    """The CLI arguments of the dv, dvenc, nuv and nuvrtj paths."""
    if name == "dv":
        argv = ["-i", str(inputs["clip48"]), *DV_ARGS]
    elif name == "dvenc":
        bsrc, bwav = inputs["broadcast"]
        argv = ["-i", str(bsrc), "-p", str(bwav), *DVENC_ARGS]
    elif name == "nuv":
        argv = ["-i", str(inputs["nuv"]), *NUV_ARGS]
    else:
        argv = ["-i", str(inputs["nuv"]), "-x", "nuv", "-y",
                "nuvrtj,raw,nuv"]
    if frames is not None:
        argv += ["--max_frames", str(frames)]
    return [*argv, "-o", str(out), "--batch", str(MAIN_BATCH),
            "--progress_off", "-q"]


def cpu_capture_digests(directory) -> dict:
    """The capture inputs and each path's output from the port's CLI
    with --device cpu: their SHA-256 (``CAPTURE_INPUT_SHA256``,
    ``CAPTURE_CPU_SHA256``)."""
    sys.path.insert(0, str(ROOT))
    from tcforge_tpu_torch import cli
    from tcforge_tpu_torch.ops import kernels
    d = Path(directory)
    inputs = capture_inputs(cli, kernels, d, device="cpu")
    out = {"camcorder.dv": sha256_file(inputs["clip"]),
           "capture.nuv": sha256_file(inputs["nuv"])}
    for name, suffix in (("dv", "mpg"), ("dvenc", "dv"), ("nuv", "avi"),
                         ("nuvrtj", "nuv")):
        path = d / f"{name}.{suffix}"
        check(cli.main([*capture_argv(name, inputs, path), "--device",
                        "cpu"]) == 0, f"{name} on the CPU")
        out[name] = sha256_file(path)
    return out


# ---------------------------------------------------------------------- #
# The ts1080 path: an ATSC HDTV capture (1080i MPEG-2 and AC-3 in a
# transport stream) brought down to 720p, the main path's chain behind the
# MPEG-2 decode

TS1080_FPS = (30000, 1001)
TS1080_FRAMES = 48
# the encoder's settings: ATSC's 19.39 Mbit/s holds 15 Mbit/s of video
TS1080_GOP = "gop_n=15:gop_m=3:rc=1:bitrate=15000"
TS1080_AC3_KBPS = 192
# an ATSC station's PIDs: video 0x31, AC-3 0x34, the PMT 0x30
TS1080_PIDS = (0x30, 0x31, 0x34)
TS1080_ARGS = ["-x", "auto", "-I", "5", "-Z", "1280x720", "-J",
               "hqdn3d=luma=4.0"]
TS1080_KERNELS = ("mpeg2_recon", "mpeg2_idct_intra", "zoom_pass",
                  "hqdn3d_spatial_scan", "hqdn3d_temporal_scan")
_TS1080_WRAPPERS = {**_RIP_WRAPPERS, "zoom_pass": "zoom_pass"}
TS1080_RUNS = 4
# phase 4's PSU check: the first three units of tests/data/ts/video.m2v
PSU3_BYTES = 8532


def ts1080_inputs(cli, directory, device: str = "cuda"):
    """The ts1080 path's capture in ``directory``: ``write_programme_y4m``
    at 1920x1088, 29.97 fps, top field first, encoded by the port's CLI
    (``-y mpeg2,raw,raw``, ``TS1080_GOP``) to ``ts1080.m2v`` and its
    display height set to 1080 (``atsc_display_height``); a seeded
    48 kHz stereo WAV of the same length through the port's AC-3 encoder
    to ``ts1080.ac3``; the two muxed by ``mux_ts`` into ``ts1080.ts``
    (PAT, a PMT with stream types 0x02 and 0x81, the video's PCR, null
    and PCR-only packets).  Returns the three paths."""
    from tcforge_tpu_torch.io.a52enc import NativeAc3Encoder
    from tcforge_tpu_torch.io.wav import WavReader
    d = Path(directory)
    y4m, wav = d / "ts1080_in.y4m", d / "ts1080_in.wav"
    m2v, ac3, ts = d / "ts1080.m2v", d / "ts1080.ac3", d / "ts1080.ts"
    coded = -(-MAIN_H // 16) * 16
    write_programme_y4m(y4m, MAIN_W, coded, TS1080_FRAMES, seed=29)
    rc = cli.main(["-i", str(y4m), "-o", str(m2v), "-y", "mpeg2,raw,raw",
                   "-F", TS1080_GOP, "--device", device, "--progress_off",
                   "-q"])
    check(rc == 0, f"ts1080: the encode's exit code {rc}")
    y4m.unlink()
    m2v.write_bytes(atsc_display_height(m2v.read_bytes(), MAIN_H))
    samples = TS1080_FRAMES * 48000 * TS1080_FPS[1] // TS1080_FPS[0] + 1
    write_test_wav(wav, samples, seed=31)
    with WavReader(str(wav)) as r:
        pcm = r.read_samples(samples)
    enc = NativeAc3Encoder(48000, 2, TS1080_AC3_KBPS * 1000)
    enc.feed(pcm)
    enc.flush()
    ac3.write_bytes(b"".join(enc.read_packets()))
    pmt, vpid, apid = TS1080_PIDS
    ts.write_bytes(mux_ts([(1, pmt, [(vpid, 0x02, 0xE0, m2v.read_bytes()),
                                     (apid, 0x81, 0xBD, ac3.read_bytes())])]))
    return ts, m2v, ac3


def write_programme_y4m(path, width: int, height: int, frames: int,
                        seed: int, fps=TS1080_FPS) -> None:
    """A seeded interlaced YUV420P Y4M that compresses like a programme,
    not like noise (``tests/data/mpeg2/make_streams.clip_y4m``'s
    content): a smooth gradient that drifts down, two textured blocks
    moving across it, and half a level of grain."""
    from tcforge_tpu_torch.io.y4m import Y4MHeader, Y4MWriter
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    cy, cx = yy[::2, ::2] / 2, xx[::2, ::2] / 2
    tex = rng.integers(40, 220, (max(2, height // 3), max(2, width // 4)))
    hdr = Y4MHeader(width=width, height=height, fps_num=fps[0],
                    fps_den=fps[1], interlacing="t")
    with Y4MWriter(str(path), hdr) as wr:
        for k in range(frames):
            y = 60 + 80 * (xx / width) + 50 * np.sin((yy + 3 * k) / 23.0)
            for bx, by, vx, vy in ((0.1, 0.2, 5, 2), (0.6, 0.5, -3, 3)):
                th, tw = tex.shape
                x0 = int(bx * width + vx * k) % max(1, width - tw)
                y0 = int(by * height + vy * k) % max(1, height - th)
                y[y0:y0 + th, x0:x0 + tw] = tex
            y += rng.normal(0, 0.5, y.shape).astype(np.float32)
            u = 128 + 30 * np.cos((cx + 2 * k) / 17.0)
            v = 128 + 30 * np.sin((cy - k) / 13.0)
            wr.write_frame(*(np.clip(np.round(p), 0, 255).astype(np.uint8)
                             for p in (y, u, v)))


def atsc_display_height(es: bytes, height: int) -> bytes:
    """``es`` with every sequence header's vertical size set to
    ``height``: the encoder takes sizes that are multiples of 16, and an
    ATSC 1080i stream codes 1088 lines and displays 1080 (the decoder
    crops the macroblock rows' last lines)."""
    out = bytearray(es)
    pos = out.find(b"\x00\x00\x01\xb3")
    while pos >= 0:
        out[pos + 5] = (out[pos + 5] & 0xF0) | (height >> 8)
        out[pos + 6] = height & 0xFF
        pos = out.find(b"\x00\x00\x01\xb3", pos + 4)
    return bytes(out)


def ts1080_argv(src, out, device: str = "cuda") -> list:
    """The ts1080 CLI on ``src``, writing ``out``.y4m and ``out``.wav."""
    return ["-i", str(src), *TS1080_ARGS, "-o", f"{out}.y4m", "-m",
            f"{out}.wav", "--device", device, "--progress_off", "-q"]


def ts1080_job():
    """The job of ``TS1080_ARGS`` (for the importer and chain driven
    without the CLI)."""
    from tcforge_tpu_torch.core.job import FilterSpec, Job
    return Job(deinterlace=5, zoom_width=1280, zoom_height=720,
               fps=TS1080_FPS[0] / TS1080_FPS[1],
               filters=[FilterSpec("hqdn3d", "luma=4.0")])


def _wav_pcm(path):
    from tcforge_tpu_torch.io.wav import WavReader
    with WavReader(str(path)) as r:
        return r.info, r.read_samples(1 << 30)


def _run_ts1080(torch, cli, kernels, bench, tmp, inputs):
    """Phase 4 for the ts1080 path: the capture through the port's CLI
    with the launch counts set to 0 just before and read just after
    (every kernel of the path launched); the same CLI with every kernel
    call held against its plain version (max abs err 0), the 1920x1088
    calls kept for their timing, and on the plain versions alone, byte
    for byte; its .y4m against the same CLI on the elementary stream the
    TS wraps and its .wav's samples against an audio-only session of the
    AC-3 stream it wraps; a VideoCD track (``cdxa.wrap_ps`` of dvd.vob)
    against dvd.vob; --psu_mode over three units on the card against the
    CPU, file by file.  The capture is written into ``inputs`` (kept for
    phase 6).  Returns the launches."""
    from tcforge_tpu_torch.io.cdxa import wrap_ps
    ts, m2v, ac3 = ts1080_inputs(cli, inputs)
    out = tmp / "ts1080"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(ts1080_argv(ts, out))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(rc == 0, f"ts1080: CLI exit code {rc}")
    frames = Path(f"{out}.y4m").read_bytes().count(b"FRAME\n")
    emit(phase="path", path="ts1080", frames=frames, seconds=seconds,
         e2e_fps=frames / seconds, ts_bytes=ts.stat().st_size,
         launches={k: launches[k] for k in TS1080_KERNELS})
    check(frames == TS1080_FRAMES, f"ts1080 wrote {frames} frames")
    for name in TS1080_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  "ts1080 path")
    want = [Path(f"{out}.{ext}").read_bytes() for ext in ("y4m", "wav")]
    captured = {"recon": [], "idct": []}
    for label in ("checked", "plain"):
        path = tmp / f"ts1080_{label}"
        ctx = (checked_kernels(kernels, bench, "ts1080", _TS1080_WRAPPERS)
               if label == "checked" else plain_versions(kernels))
        with ctx as counts:
            if label == "checked":
                recon, idct = kernels.mpeg2_recon, kernels.mpeg2_idct_intra

                def kept_recon(*a, **k):
                    if k.get("chroma", 1) == 1 and len(k) <= 1:
                        captured["recon"].append(a)   # a frame picture
                    return recon(*a, **k)

                def kept_idct(coef, *a, **k):
                    if not a and not k:   # a batched intra run's plane
                        captured["idct"].append(coef)
                    return idct(coef, *a, **k)
                kernels.mpeg2_recon = kept_recon
                kernels.mpeg2_idct_intra = kept_idct
            rc = cli.main(ts1080_argv(ts, path))
        check(rc == 0, f"ts1080 on the {label}: CLI exit code {rc}")
        got = [Path(f"{path}.{ext}").read_bytes() for ext in ("y4m", "wav")]
        same = got == want
        emit(phase="path_vs_plain", path="ts1080", run=label,
             identical=same, checked_calls=counts)
        check(same, f"ts1080 on the {label}: the output differs")
        for ext in ("y4m", "wav"):
            Path(f"{path}.{ext}").unlink()
    # the elementary stream the TS wraps, and its AC-3 stream alone
    rc = cli.main(ts1080_argv(m2v, tmp / "ts1080_es"))
    check(rc == 0, f"ts1080 on the .m2v: CLI exit code {rc}")
    same = (tmp / "ts1080_es.y4m").read_bytes() == want[0]
    emit(phase="ts_vs_es", path="ts1080", identical=same)
    check(same, "ts1080: the TS's .y4m differs from its .m2v's")
    (tmp / "ts1080_es.y4m").unlink()
    rc = cli.main(["-i", str(ac3), "-o", str(tmp / "ts1080_ac3.wav"),
                   "--device", "cuda", "--progress_off", "-q"])
    check(rc == 0, f"ts1080's AC-3 alone: CLI exit code {rc}")
    info, pcm = _wav_pcm(f"{out}.wav")
    ainfo, apcm = _wav_pcm(tmp / "ts1080_ac3.wav")
    n = pcm.shape[0]
    same = (info == ainfo and n >= TS1080_FRAMES * 1601
            and np.array_equal(pcm, apcm[:n]))
    emit(phase="ts_audio_vs_ac3", path="ts1080", samples=n,
         ac3_samples=int(apcm.shape[0]), rate=info.rate,
         channels=info.channels, identical=same)
    check(same, "ts1080: the TS's audio differs from its AC-3 stream's")
    # a VideoCD track against the program stream it wraps
    dat = tmp / "dvd.dat"
    dat.write_bytes(wrap_ps((MPEG_DATA / "dvd.vob").read_bytes()))
    got = {}
    for name, src in (("vob", MPEG_DATA / "dvd.vob"), ("dat", dat)):
        o = tmp / f"cdxa_{name}"
        rc = cli.main(["-i", str(src), "-J", "hqdn3d=luma=4.0", "-o",
                       f"{o}.y4m", "-m", f"{o}.wav", "--device", "cuda",
                       "--progress_off", "-q"])
        check(rc == 0, f"cdxa {name}: CLI exit code {rc}")
        got[name] = [Path(f"{o}.{ext}").read_bytes() for ext in ("y4m", "wav")]
    same = got["vob"] == got["dat"]
    emit(phase="cdxa_vs_ps", path="dvd.vob", identical=same,
         frames=got["dat"][0].count(b"FRAME\n"))
    check(same, "the VideoCD track's output differs from its PS's")
    dat.unlink()
    # PSU mode: three units, the card against the CPU
    psu = tmp / "psu3.m2v"
    psu.write_bytes((TS_DATA / "video.m2v").read_bytes()[:PSU3_BYTES])
    files = {}
    for device in ("cuda", "cpu"):
        d = tmp / f"psu_{device}"
        d.mkdir()
        rc = cli.main(["-i", str(psu), "--psu_mode", "-J", "hqdn3d=luma=4.0",
                       "-o", str(d / "unit%d.y4m"), "--device", device,
                       "--progress_off", "-q"])
        check(rc == 0, f"psu on {device}: CLI exit code {rc}")
        files[device] = {f.name: f.read_bytes() for f in d.iterdir()}
    same = files["cuda"] == files["cpu"] and len(files["cuda"]) == 3
    emit(phase="psu_vs_cpu", units=sorted(files["cuda"]), identical=same)
    check(same, "psu mode: the card's units differ from the CPU's")
    _time_recon_1080(torch, kernels, bench, captured)
    return launches


def _time_recon_1080(torch, kernels, bench, captured):
    """The ts1080 path's 1920x1088 reconstruction calls timed as phase 3
    times dvd.vob's (beside the plain versions, the bound and the IDCT's
    ``torch.matmul``), each line's ``per_batch`` 0 so the summary keeps
    the dvd path's rows, the path's calls a batch in the case's name."""
    from tcforge_tpu_torch.io.mpeg2codec import idct_kron
    dev = bench.dev
    calls, planes = captured["recon"], captured["idct"]
    check(len(calls) >= 8 and len(planes) >= 3,
          f"ts1080 gave {len(calls)} recon calls, {len(planes)} intra planes")
    kmat = torch.from_numpy(idct_kron()).to(dev)
    batches = TS1080_FRAMES / MAIN_BATCH

    def fmas(args):
        return 64 * int(sum(int((c != 0).sum()) for c in args[:3]))

    bench.record("mpeg2_recon",
                 f"1920x1088 P and B pictures (ts1080, "
                 f"{len(calls) / batches:g} a batch)", 0,
                 lambda *a: kernels.mpeg2_recon(*a),
                 lambda *a: kernels.mpeg2_recon_ref(*a), calls,
                 nbytes=sum(map(_recon_bytes, calls)) / len(calls),
                 ops=sum(map(fmas, calls)) / len(calls),
                 library=(lambda c: torch.matmul(c, kmat),
                          [(torch.cat([c.reshape(-1, 64) for c in a[:3]])
                            .to(torch.float32),) for a in calls]),
                 plain_reps=2, ops_per_s=F32_FMA_PER_S)
    kmat64 = kmat.to(torch.float64)
    for label, group in (("1920x1088 intra Y", planes[0::3]),
                         ("960x544 intra U, V", planes[1::3] + planes[2::3])):
        inputs = [(c,) for c in group]
        while sum(_nbytes(c) for (c,) in inputs) < L2_BYTES:
            inputs = inputs + [(c.clone(),) for (c,) in inputs]
        c0 = inputs[0][0]
        blocks = c0.numel() // 64
        bench.record("mpeg2_idct_intra",
                     f"{label} (ts1080, {len(group) / batches:g} a batch)",
                     0, kernels.mpeg2_idct_intra,
                     kernels.mpeg2_idct_intra_ref, inputs,
                     nbytes=_nbytes(c0) + blocks * 64, ops=1024 * blocks,
                     library=(lambda c: torch.matmul(c, kmat64),
                              [(c.reshape(-1, 64).to(torch.float64),)
                               for (c,) in inputs]),
                     plain_reps=2, ops_per_s=F64_FMA_PER_S)
    calls.clear()
    planes.clear()


def _ts_goldens(cli, tmp):
    """Phase 5 for TS, VideoCD, PSU navigation and the audio importers:
    every ``TS_GOLDEN`` case on the card, each output's SHA-256 against
    the JAX CLI's pinned digests."""
    for case in TS_GOLDEN:
        d = tmp / f"ts_golden_{case}"
        d.mkdir()
        rc = cli.main([*ts_golden_argv(case, d), "--device", "cuda",
                       "--progress_off", "-q"])
        digest = tuple(sha256_file(f) for f in ts_golden_outputs(case, d))
        emit(phase="golden", path=case, sha256=list(digest),
             pinned=list(TS_GOLDEN_SHA256[case]))
        check(rc == 0 and digest == TS_GOLDEN_SHA256[case],
              f"{case} golden output differs from the JAX-pinned digests")


def _ts1080_rates(torch, dev, cli, tmp):
    """Phase 6 for the ts1080 path: its CLI on phase 4's 48-frame capture
    (in ``tmp``), wall clock to the last byte, ``TS1080_RUNS`` runs after
    an untimed one (median and spread); its serial stages
    (``mpeg_stages``); under torch.profiler, one CLI run's device busy time
    a batch and the decode kernels' share."""
    from torch.profiler import ProfilerActivity, profile
    ts = tmp / "ts1080.ts"
    out = tmp / "ts1080_rate"
    fps = []
    for r in range(TS1080_RUNS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(ts1080_argv(ts, out))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"ts1080 CLI: exit code {rc}")
        if r:
            fps.append(TS1080_FRAMES / seconds)
    emit(phase="cli", path="ts1080", frames=TS1080_FRAMES, fps=fps,
         median_fps=float(np.median(fps)), min_fps=min(fps),
         max_fps=max(fps))
    emit(phase="stages", path="ts1080",
         **mpeg_stages(torch, dev, ts, tmp / "ts1080_stages.y4m",
                       ts1080_job(), audio=True))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = cli.main(ts1080_argv(ts, out))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(rc == 0, f"ts1080 under the profiler: exit code {rc}")
    t0 = time.perf_counter()
    busy = _device_busy(prof, TS1080_FRAMES / MAIN_BATCH,
                        ("recon_kernel", "idct_intra_kernel"))
    busy_ms = busy["busy_ms_per_batch"]
    emit(phase="stages", path="ts1080_device",
         cli_seconds=wall,
         busy_share_of_cli=(None if busy_ms is None else
                            busy_ms * TS1080_FRAMES / MAIN_BATCH / 1e3
                            / wall),
         busy_share_of_window=(None if busy_ms is None else
                               busy_ms / busy["profiled_ms_per_batch"]),
         device_busy_ms_per_batch=busy_ms,
         profiled_ms_per_batch=busy["profiled_ms_per_batch"],
         decode_kernels_ms_per_batch=busy["named_ms_per_batch"],
         device_kernels_ms_per_batch=busy["kernels_ms_per_batch"],
         trace_seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------- #
# The ogm path: the DivX-era rip of a DVD title into an OGM file, MPEG-4
# video and Vorbis sound (the title's own AC-3 track, no -m); the
# flagship -y xvid,lame,avi job without -m; the route goldens

OGM_ARGS = ["-x", "dvd", "-T", "1", "-Z", "640x480", "-J",
            "hqdn3d=luma=4.0", "-y", "xvid,vorbis,ogg=fourcc=XVID", "-F",
            "keyint=12:bframes=2:four_mv=1", "-w", "1500"]
OGM_KERNELS = DIVXENC_KERNELS
OGM_FRAMES = 28                 # the fixture title's
OGM_RUNS = 2                    # phase 6's timed runs, after an untimed one
FLAGSHIP_ARGS = ["-x", "dvd", "-T", "1", "-y", "xvid,lame,avi"]
FLAGSHIP_KERNELS = ("mpeg4_enc_me", "mpeg4_enc_blocks", "mpeg2_recon",
                    "mpeg2_idct_intra")
# the SHA-256 of the ogm path's OGM and the flagship job's AVI from the
# port's own CLI with --device cpu (the plain versions), as
# ``cpu_digests`` computes them: python3 -c "import chip_smoke as c;
# print(c.cpu_digests())" (about a minute on a CPU)
OGM_CPU_SHA256 = (
    "ee835e5f684ee185865570fa45cb359088c68245e4900dc4ca0c4c55357b0934")
FLAGSHIP_CPU_SHA256 = (
    "12d215832d6caf6f887a3e81427ae65e8bd295a46ff982fcf25ada89c88b8433")


def ogm_argv(title, out) -> list:
    return ["-i", str(title), *OGM_ARGS, "-o", str(out), "--batch",
            str(MAIN_BATCH), "--progress_off", "-q"]


def flagship_argv(title, out) -> list:
    return ["-i", str(title), *FLAGSHIP_ARGS, "-o", str(out), "--batch",
            str(MAIN_BATCH), "--progress_off", "-q"]


def cpu_digests() -> dict:
    """The ogm path's and the flagship job's outputs on the title from the
    port's CLI with --device cpu: their SHA-256 (``OGM_CPU_SHA256``,
    ``FLAGSHIP_CPU_SHA256``)."""
    sys.path.insert(0, str(ROOT))
    from tcforge_tpu_torch import cli
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cpu_") as tmp:
        tmp = Path(tmp)
        title = dvdrip_title(tmp)
        out = {}
        for name, argv in (("ogm", ogm_argv(title, tmp / "film.ogm")),
                           ("flagship",
                            flagship_argv(title, tmp / "film.avi"))):
            check(cli.main([*argv, "--device", "cpu"]) == 0,
                  f"{name} on the CPU")
            out[name] = sha256_file(argv[argv.index("-o") + 1])
    return out


def _launched_run(torch, cli, kernels, argv, names, label):
    """The CLI on ``argv`` on the card with the launch counts set to 0
    just before and read just after: (seconds, launches), every kernel
    of ``names`` launched."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main([*argv, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(rc == 0, f"{label}: CLI exit code {rc}")
    for name in names:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  f"{label} path")
    return seconds, launches


def _run_ogm(torch, cli, kernels, tmp):
    """Phases 4 and 5 for the ogm path: the title through the port's CLI
    to a 640x480 XVID + Vorbis OGM, launches counted, byte for byte the
    port's own --device cpu run (``OGM_CPU_SHA256``); the OGM's streams;
    its Vorbis track read back by the port's ogg importer as -p beside a
    Y4M of as many frames, the WAV's digest printed.  Returns the
    launches."""
    from tcforge_tpu_torch.io.ogg import identify_streams
    d = tmp / "ogm"
    d.mkdir()
    title = dvdrip_title(d)
    out = d / "film.ogm"
    seconds, launches = _launched_run(torch, cli, kernels,
                                      ogm_argv(title, out), OGM_KERNELS,
                                      "ogm")
    emit(phase="path", path="ogm", frames=OGM_FRAMES, seconds=seconds,
         e2e_fps=OGM_FRAMES / seconds,
         launches={k: launches[k] for k in OGM_KERNELS})
    digest = sha256_file(out)
    emit(phase="path_vs_cpu", path="ogm", identical=digest == OGM_CPU_SHA256,
         sha256=digest, pinned=OGM_CPU_SHA256)
    check(digest == OGM_CPU_SHA256, "ogm: the card's OGM differs from the "
                                    "CPU run's")
    with open(out, "rb") as f:
        streams = [(s.kind, s.codec, s.width, s.height, s.samplerate,
                    s.channels) for s in identify_streams(f)]
    check(streams == [("video", "XVID", 640, 480, 0, 0),
                      ("audio", "vorbis", 0, 0, 48000, 2)],
          f"ogm: the OGM's streams {streams}")
    y4m, back = d / "frames.y4m", d / "back.wav"
    write_test_y4m(y4m, 64, 48, OGM_FRAMES, seed=5, fps=(30000, 1001))
    rc = cli.main(["-i", str(y4m), "-p", str(out), "-o",
                   str(d / "back.y4m"), "-m", str(back), "--device", "cuda",
                   "--progress_off", "-q"])
    samples = (back.stat().st_size - 44) // 4 if back.exists() else 0
    emit(phase="readback", path="ogm", sha256=sha256_file(back),
         samples=samples)
    check(rc == 0 and samples == 1602 * OGM_FRAMES,
          f"ogm: the Vorbis read-back gave {samples} samples")
    return launches


def _run_flagship(torch, cli, kernels, tmp):
    """transcode's flagship job, -i VIDEO_TS -y xvid,lame,avi without -m:
    the AVI holds the title's own track as MP3 (tag 0x55), launches
    counted, and equals the port's own --device cpu run byte for byte
    (``FLAGSHIP_CPU_SHA256``).  Returns the launches."""
    from tcforge_tpu_torch.io.avi import AviReader
    d = tmp / "flagship"
    d.mkdir()
    title = dvdrip_title(d)
    out = d / "film.avi"
    seconds, launches = _launched_run(torch, cli, kernels,
                                      flagship_argv(title, out),
                                      FLAGSHIP_KERNELS, "flagship")
    with AviReader(str(out)) as r:
        audio = [(a.format_tag, a.rate, a.channels) for a in r.audio]
        audio_bytes = sum(len(c) for c in r.read_audio_chunks(0)) \
            if r.audio else 0
        video = (r.video.fourcc, r.video.width, r.video.height,
                 r.video_frames)
    emit(phase="path", path="flagship", frames=OGM_FRAMES, seconds=seconds,
         launches={k: launches[k] for k in FLAGSHIP_KERNELS}, video=video,
         audio=audio, audio_bytes=audio_bytes)
    check(video == ("XVID", 720, 480, OGM_FRAMES)
          and audio == [(0x55, 48000, 2)] and audio_bytes > 0,
          f"flagship: video {video}, audio {audio} ({audio_bytes} bytes)")
    digest = sha256_file(out)
    emit(phase="path_vs_cpu", path="flagship",
         identical=digest == FLAGSHIP_CPU_SHA256, sha256=digest,
         pinned=FLAGSHIP_CPU_SHA256)
    check(digest == FLAGSHIP_CPU_SHA256, "flagship: the card's AVI differs "
                                         "from the CPU run's")
    return launches


def _route_goldens(cli, tmp):
    """Phase 5 for the audio routes: every ``ROUTE_GOLDEN`` case on the
    card, in order, its exit code and its files' SHA-256 against the JAX
    CLI's pinned digests."""
    inputs = tmp / "route_inputs"
    inputs.mkdir()
    for case, (_src, _args, _outs, want_rc) in ROUTE_GOLDEN.items():
        d = tmp / "routes" / case
        d.mkdir(parents=True)
        rc = cli.main([*route_golden_argv(case, d, inputs), "--device",
                       "cuda", "--progress_off", "-q"])
        digest = tuple(sha256_file(f) if f.exists() else None
                       for f in route_golden_outputs(case, d))
        emit(phase="golden", path=f"route_{case}", rc=rc,
             sha256=list(digest), pinned=list(ROUTE_GOLDEN_SHA256[case]))
        check(rc == want_rc and digest == ROUTE_GOLDEN_SHA256[case],
              f"route {case} golden output differs from the JAX-pinned "
              "digests")


def _ogm_clock() -> "_StageClock":
    """Host clocks around the ogm CLI's stages: the importer's plan (the
    host parse) and execute (the upload and the reconstruction kernels),
    the chain, the MPEG-4 encoder (its decisions and block coding on the
    card, its records' copy and syntax writer on the host), the Vorbis
    encoder and the Ogg multiplexor (the writer thread)."""
    from tcforge_tpu_torch.modules.encoders.vorbis_enc import \
        VorbisAudioEncoder
    from tcforge_tpu_torch.modules.encoders.xvid import XvidEncoder
    from tcforge_tpu_torch.modules.importers.mpeg_import import MpegImporter
    from tcforge_tpu_torch.modules.muxers.ogg_mux import OggMuxer
    from tcforge_tpu_torch.pipeline.chain import VideoChain
    clock = _StageClock()
    for owner, name, label in (
            (MpegImporter, "plan_batch", "parse"),
            (MpegImporter, "execute", "decode"),
            (VideoChain, "__call__", "chain"),
            (XvidEncoder, "encode_video", "mpeg4_encoder"),
            (XvidEncoder, "flush", "mpeg4_encoder"),
            (VorbisAudioEncoder, "encode_audio", "vorbis_encoder"),
            (VorbisAudioEncoder, "flush", "vorbis_encoder"),
            (OggMuxer, "write_video", "ogg_mux"),
            (OggMuxer, "write_audio", "ogg_mux")):
        clock.wrap(owner, name, label)
    return clock


def _ogm_rates(torch, cli, tmp):
    """Phase 6 for the ogm path, on the title (28 frames; its kernels and
    tables warm from phase 4; twice over before it was cut to keep the
    script inside its time limit): the CLI, wall clock to the
    last byte, ``OGM_RUNS`` runs (median and spread) with host clocks
    around its stages (``_ogm_clock``, ms a 16-frame batch, the Vorbis
    encoder's apart); then the title once under torch.profiler: the
    device's busy time a batch and the named kernels'."""
    from torch.profiler import ProfilerActivity, profile
    title = dvdrip_title(tmp)
    frames = OGM_FRAMES
    argv = [*ogm_argv(title, tmp / "ogm_rate.ogm"), "--device", "cuda"]
    batches = frames / MAIN_BATCH
    fps = []
    clock = _ogm_clock()
    try:
        for _ in range(OGM_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            check(rc == 0, f"ogm CLI: exit code {rc}")
            fps.append(frames / seconds)
    finally:
        clock.restore()
    # the device's share on the title once (28 frames, two batches)
    short = [*ogm_argv(title, tmp / "ogm_prof.ogm"),
             "--device", "cuda"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rc = cli.main(short)
        torch.cuda.synchronize()
    check(rc == 0, f"ogm under the profiler: exit code {rc}")
    busy = _device_busy(prof, OGM_FRAMES / MAIN_BATCH,
                        ("recon_kernel", "zoom_", "scan_", "mpeg4_me_",
                         "mpeg4_bme_", "mpeg4_blocks_"))
    per_run = batches * OGM_RUNS
    wall = {k: 1e3 * v / per_run for k, v in clock.wall.items()}
    emit(phase="cli", path="ogm", frames=frames, fps=fps,
         median_fps=float(np.median(fps)), min_fps=min(fps),
         max_fps=max(fps), vorbis_ms_per_batch=wall["vorbis_encoder"],
         host_wall_ms_per_batch=wall,
         host_cpu_ms_per_batch={k: 1e3 * v / per_run
                                for k, v in clock.cpu.items()},
         device_busy_ms_per_batch=busy["busy_ms_per_batch"],
         named_kernels_ms_per_batch=busy["named_ms_per_batch"],
         device_kernels_ms_per_batch=busy["kernels_ms_per_batch"])


# ---------------------------------------------------------------------- #
# The capture codecs' phases


def _dv_records(frames, pal: bool):
    """The host parse of DV ``frames`` (bytes): int16 coefficients and
    uint8 modes as numpy arrays."""
    from tcforge_tpu_torch.io import dvcodec
    nb = dvcodec.frame_blocks(pal)
    coef = np.zeros((len(frames) * nb, 64), np.int16)
    mode = np.zeros(len(frames) * nb, np.uint8)
    dvcodec.parse_frames(frames, pal, coef, mode)
    return coef, mode


def _dv_fixture_frames(name: str, count: int) -> list:
    size = 144000 if name == "pal.dv" else 120000
    data = (DV_DATA / name).read_bytes()
    frames = [data[i:i + size] for i in range(0, len(data), size)]
    return (frames * count)[:count]


def _dv_cost_ops(cls) -> int:
    """The float64 operations of a ``dv_fdct_cost`` launch on its inputs:
    each block's 64 x 64 FMAs, and one division a coefficient for each
    class it tried (``cls`` the classes chosen, + 1): at every qno for
    the table, at the chosen one for the levels."""
    return int(cls.shape[0]) * 4096 + 63 * int((cls.long() + 1).sum())


def _check_capture_kernels(torch, kernels, bench):
    """Phase 3 for the capture kernels at tolerance 0 against their plain
    versions: ``dv_idct`` on 16 PAL and 16 NTSC frames of the fixtures
    (parsed on the host), ``dv_fdct_cost``'s table and levels on those
    frames' planes (PAL 4:2:0, NTSC 4:1:1; the host's rate fit between),
    ``rtjpeg_fdct_quant`` and ``rtjpeg_idct`` at 640x480 on random
    batches of 16 at qualities 16, 128 and 255 (each encode's stream
    decoded on the host for the IDCT).  Then each timed at the paths'
    shapes over inputs past L2 beside its plain version, its bound and
    the library yardstick (a float64 ``torch.matmul`` of the blocks with a
    64 x 64 basis: the same count of products, not the same function)."""
    from tcforge_tpu_torch.io import dvcodec, rtjcodec
    dev = bench.dev
    basis = torch.from_numpy(dvcodec.basis()[0].copy()).to(dev)

    def yardstick(coef):
        blocks = coef.reshape(-1, 64).to(torch.float64)
        return (torch.matmul, [(blocks, basis)])
    for name, pal in (("pal.dv", True), ("ntsc.dv", False)):
        label = "PAL" if pal else "NTSC"
        coef, mode = _dv_records(_dv_fixture_frames(name, MAIN_BATCH), pal)
        c = torch.from_numpy(coef).to(dev)
        m = torch.from_numpy(mode).to(dev)
        inputs = bench.rotation(lambda: (c.clone(), m.clone(), pal))
        planes = kernels.dv_idct(c, m, pal)
        out_bytes = _nbytes(*planes)
        bench.record("dv_idct", f"{label}, a batch of {MAIN_BATCH}",
                     1 if pal else 0, kernels.dv_idct, kernels.dv_idct_ref,
                     inputs, nbytes=_nbytes(c, m) + out_bytes,
                     ops=DV_IDCT_OPS * coef.shape[0],
                     library=yardstick(c), plain_reps=2)
        y, u, v = planes
        table, dc, md = kernels.dv_fdct_cost(y, u, v)
        want = kernels.dv_fdct_cost_ref(y, u, v)
        bench.check("dv_fdct_cost", f"{label} table", (table, dc, md), want)
        qno = torch.from_numpy(dvcodec.rate_fit(table.cpu().numpy())).to(dev)
        lv = kernels.dv_fdct_cost(y, u, v, qno)
        bench.check("dv_fdct_cost", f"{label} levels", lv,
                    kernels.dv_fdct_cost_ref(y, u, v, qno))
        if not pal:
            continue
        rot = bench.rotation(lambda: tuple(p.clone() for p in planes))
        bench.record("dv_fdct_cost", f"PAL table, a batch of {MAIN_BATCH}",
                     1, kernels.dv_fdct_cost, kernels.dv_fdct_cost_ref, rot,
                     nbytes=out_bytes + _nbytes(table, dc, md),
                     ops=_dv_cost_ops(table[:, :, 0]), library=yardstick(c),
                     ops_per_s=F64_FMA_PER_S, reps=max(8, len(rot)),
                     plain_reps=1)
        rotq = [(*a, qno) for a in rot]
        bench.record("dv_fdct_cost", f"PAL levels, a batch of {MAIN_BATCH}",
                     1, kernels.dv_fdct_cost, kernels.dv_fdct_cost_ref, rotq,
                     nbytes=out_bytes + _nbytes(qno, *lv),
                     ops=_dv_cost_ops(lv[1]),
                     ops_per_s=F64_FMA_PER_S, reps=max(8, len(rotq)),
                     plain_reps=1)
    w, h = NUV_W, NUV_H
    nb = rtjcodec.frame_blocks(w, h)
    for q in (16, 128, 255):
        qt, lb8, cb8, tables = rtjcodec.compress_tables(q)
        qt = torch.from_numpy(qt).to(dev)
        fdct_in = bench.rotation(lambda: (
            bench.u8(MAIN_BATCH, h, w), bench.u8(MAIN_BATCH, h // 2, w // 2),
            bench.u8(MAIN_BATCH, h // 2, w // 2), qt))
        blocks = kernels.rtjpeg_fdct_quant(*fdct_in[0])
        dq, l2, c2 = rtjcodec.decompress_tables(tables)
        coef = np.empty((MAIN_BATCH * nb, 64), np.int32)
        rtjcodec.decompress_frames(rtjcodec.compress_frames(
            blocks.cpu().numpy(), nb, lb8, cb8), nb, dq, l2, c2, coef)
        ct = torch.from_numpy(coef).to(dev)
        idct_in = bench.rotation(lambda: (ct.clone(), w, h))
        per_batch = 1 if q == 255 else 0
        label = f"{w}x{h}, a batch of {MAIN_BATCH}, quality {q}"
        bench.record("rtjpeg_fdct_quant", label, per_batch,
                     kernels.rtjpeg_fdct_quant,
                     kernels.rtjpeg_fdct_quant_ref, fdct_in,
                     nbytes=_nbytes(*fdct_in[0][:3], blocks),
                     ops=RTJPEG_OPS * MAIN_BATCH * nb,
                     library=yardstick(blocks), plain_reps=2)
        planes = kernels.rtjpeg_idct(ct, w, h)
        bench.record("rtjpeg_idct", label, per_batch, kernels.rtjpeg_idct,
                     kernels.rtjpeg_idct_ref, idct_in,
                     nbytes=_nbytes(ct, *planes),
                     ops=RTJPEG_OPS * MAIN_BATCH * nb,
                     library=yardstick(ct), plain_reps=2)


def _run_capture(torch, cli, kernels, bench, directory) -> dict:
    """Phases 4 for the capture paths: the inputs written by the port's
    encoders on the card (``capture_inputs``: the camcorder clip and the
    capture, each against the JAX CLI's pinned digest), then the dv,
    dvenc, nuv and nuvrtj paths through the port's CLI with the launch
    counts set to 0 just before and read just after (every kernel of each
    path launched; one ``dv_idct``, two ``dv_fdct_cost``, one
    ``rtjpeg_idct`` or ``rtjpeg_fdct_quant`` launch a batch), each output
    against the port's own --device cpu run's pinned digest
    (``CAPTURE_CPU_SHA256``, which equals the JAX CLI's); then each path
    on its first 16 frames with every capture kernel call held against
    its plain version.  Returns the launches by path."""
    d = Path(directory)
    inputs = capture_inputs(cli, kernels, d)
    for key, path in (("camcorder.dv", inputs["clip"]),
                      ("capture.nuv", inputs["nuv"])):
        digest = sha256_file(path)
        emit(phase="capture_input", input=key, sha256=digest,
             pinned=CAPTURE_INPUT_SHA256[key], bytes=path.stat().st_size)
        check(digest == CAPTURE_INPUT_SHA256[key],
              f"{key}: the port's encode on the card differs from the JAX "
              "CLI's")
    launches = {"nuvrtj": inputs["launches"]["nuvrtj"]}
    batches = CAPTURE_FRAMES // MAIN_BATCH
    for name, suffix, names in (("dv", "mpg", DV_KERNELS),
                                ("dvenc", "dv", DVENC_KERNELS),
                                ("nuv", "avi", NUV_KERNELS),
                                ("nuvrtj", "nuv", NUVRTJ_KERNELS)):
        out = d / f"{name}.{suffix}"
        seconds, got = _launched_run(torch, cli, kernels,
                                     capture_argv(name, inputs, out), names,
                                     name)
        launches[name] = got
        digest = sha256_file(out)
        emit(phase="path", path=name, frames=CAPTURE_FRAMES, seconds=seconds,
             e2e_fps=CAPTURE_FRAMES / seconds, bytes=out.stat().st_size,
             launches={k: got[k] for k in names})
        emit(phase="path_vs_cpu", path=name,
             identical=digest == CAPTURE_CPU_SHA256[name], sha256=digest,
             pinned=CAPTURE_CPU_SHA256[name])
        check(digest == CAPTURE_CPU_SHA256[name],
              f"{name}: the card's output differs from the CPU's")
    per_batch = {"dv": ("dv_idct", 1), "dvenc": ("dv_fdct_cost", 2),
                 "nuv": ("rtjpeg_idct", 1), "nuvrtj": ("rtjpeg_fdct_quant", 1)}
    for name, (kernel, n) in per_batch.items():
        check(launches[name][kernel] == n * batches,
              f"{name}: {launches[name][kernel]} {kernel} launches for "
              f"{batches} batches")
    # every capture kernel call held against its plain version
    for name, suffix in (("dv", "mpg"), ("dvenc", "dv"), ("nuv", "avi"),
                         ("nuvrtj", "nuv")):
        out = d / f"{name}_checked.{suffix}"
        with checked_kernels(kernels, bench, f"{name} path",
                             CAPTURE_WRAPPERS) as counts:
            rc = cli.main([*capture_argv(name, inputs, out, MAIN_BATCH),
                           "--device", "cuda"])
        check(rc == 0 and sum(counts.values()) > 0,
              f"{name} with checked kernels: exit code {rc}")
        emit(phase="path_checked", path=name, frames=MAIN_BATCH,
             checked_calls={k: v for k, v in counts.items() if v})
        out.unlink()
    return launches


def _capture_goldens(cli, tmp) -> None:
    """Phase 5 for the capture codecs: every ``CAPTURE_GOLDEN`` case on
    the card in one directory, in order, its exit code and outputs
    against the JAX CLI's pinned digests."""
    d = tmp / "capture_golden"
    d.mkdir()
    for case, (_, _, _, want_rc) in CAPTURE_GOLDEN.items():
        rc = cli.main([*capture_golden_argv(case, d), "--device", "cuda"])
        got = [sha256_file(f) if f.exists() else None
               for f in capture_golden_outputs(case, d)]
        pinned = CAPTURE_GOLDEN_SHA256[case]
        emit(phase="golden", path=f"capture_{case}", rc=rc, sha256=got,
             pinned=pinned)
        check((rc != 0) == (want_rc != 0) and got == pinned,
              f"capture {case}: exit code {rc} or outputs differ from the "
              "JAX-pinned digests")


def _capture_rates(torch, cli, directory) -> None:
    """Phase 6 for the capture paths on phase 4's inputs: each CLI, wall
    clock to the last byte, ``CAPTURE_RUNS`` runs after an untimed one
    (median and spread), with host clocks around its stages (ms a
    16-frame batch: the host parse or pack, the importer's device half
    or the encoder, the video chain, the multiplexor), then once under
    torch.profiler: the device's busy time a batch and the named
    kernels'."""
    from torch.profiler import ProfilerActivity, profile

    from tcforge_tpu_torch.io import dvcodec, rtjcodec
    from tcforge_tpu_torch.modules.encoders import capture_enc, mpeg2, xvid
    from tcforge_tpu_torch.modules.importers import dv_import, nuv_import
    from tcforge_tpu_torch.modules.muxers import capture_mux, ps_mux
    from tcforge_tpu_torch.pipeline import chain as chain_mod
    d = Path(directory)
    inputs = {"clip48": d / "camcorder48.dv",
              "broadcast": (d / "broadcast.y4m", d / "broadcast.wav"),
              "nuv": d / "capture.nuv"}
    stages = {
        "dv": [(dvcodec, "parse_frames", "host_parse"),
               (dv_import.DvImporter, "execute", "upload_and_idct"),
               (mpeg2.Mpeg2VideoEncoder, "encode_video", "mpeg2_encoder"),
               (ps_mux.MpegPsMuxer, "write_video", "mux")],
        "dvenc": [(dvcodec, "rate_fit", "host_rate_fit"),
                  (dvcodec, "pack_frames", "host_pack"),
                  (capture_enc.DvVideoEncoder, "encode_video", "encoder"),
                  (capture_mux.DvMuxer, "write_video", "mux"),
                  (capture_mux.DvMuxer, "write_audio", "mux")],
        "nuv": [(rtjcodec, "decompress_frames", "host_parse"),
                (nuv_import.NuvImporter, "execute", "upload_and_idct"),
                (xvid.XvidEncoder, "encode_video", "xvid_encoder")]}
    names = {"dv": ("dv_idct_kernel", "scan_", "mpeg2_"),
             "dvenc": ("dv_cost_kernel", "zoom_", "scan_"),
             "nuv": ("rtjpeg_idct_kernel", "scan_", "mpeg4_")}
    batches = CAPTURE_FRAMES / MAIN_BATCH
    for name, suffix in (("dv", "mpg"), ("dvenc", "dv"), ("nuv", "avi")):
        argv = [*capture_argv(name, inputs, d / f"{name}_rate.{suffix}"),
                "--device", "cuda"]
        check(cli.main(argv) == 0, f"{name} CLI: untimed run")
        clock = _StageClock()
        for owner, attr, label in stages[name]:
            clock.wrap(owner, attr, label)
        clock.wrap(chain_mod.VideoChain, "__call__", "chain_call")
        fps = []
        try:
            for _ in range(CAPTURE_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = cli.main(argv)
                torch.cuda.synchronize()
                check(rc == 0, f"{name} CLI: exit code {rc}")
                fps.append(CAPTURE_FRAMES / (time.perf_counter() - t0))
        finally:
            clock.restore()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rc = cli.main(argv)
            torch.cuda.synchronize()
        check(rc == 0, f"{name} under the profiler: exit code {rc}")
        busy = _device_busy(prof, batches, names[name])
        per_run = batches * CAPTURE_RUNS
        emit(phase="cli", path=name, frames=CAPTURE_FRAMES, fps=fps,
             median_fps=float(np.median(fps)), min_fps=min(fps),
             max_fps=max(fps),
             host_wall_ms_per_batch={k: 1e3 * v / per_run
                                     for k, v in clock.wall.items()},
             host_cpu_ms_per_batch={k: 1e3 * v / per_run
                                    for k, v in clock.cpu.items()},
             device_busy_ms_per_batch=busy["busy_ms_per_batch"],
             profiled_ms_per_batch=busy["profiled_ms_per_batch"],
             named_kernels_ms_per_batch=busy["named_ms_per_batch"],
             device_kernels_ms_per_batch=busy["kernels_ms_per_batch"])


# ---------------------------------------------------------------------- #
# Theora both ways: the ogv path (1080i broadcast material to a 720p web
# OGV, Theora and Vorbis), its read-back (ogv_dec: the OGV with its own
# Vorbis track to an MPEG-2 programme stream) and the fixtures' decode

THEORA_DATA = ROOT / "tests" / "data" / "theora"
THEORA_FRAMES = 32
THEORA_FPS = (30000, 1001)
THEORA_SEED = 59
OGV_ARGS = ["-I", "5", "-Z", "1280x720", "-J", "hqdn3d=luma=4.0", "-y",
            "theora=qi=45:keyint=16,vorbis,ogg"]
OGV_DEC_ARGS = ["-J", "hqdn3d=luma=4.0", "-y", "mpeg2,mp2enc,mpg"]
THEORA_KERNELS = ("theora_recon", "theora_loop_filter", "theora_fdct_quant",
                  "theora_me")
THEORA_WRAPPERS = {k: k for k in THEORA_KERNELS}
OGV_KERNELS = (*THEORA_KERNELS, "zoom_pass", "hqdn3d_spatial_scan",
               "hqdn3d_temporal_scan")
# the mpeg2 encoder's defaults code intra pictures alone (gop_n 1)
OGV_DEC_KERNELS = ("theora_recon", "theora_loop_filter",
                   "hqdn3d_spatial_scan", "hqdn3d_temporal_scan",
                   "mpeg2_enc_blocks")
# the fixtures (tests/data/theora/make_streams.py), decoded to Y4M with
# three frames a batch
THEORA_FIXTURES = ("yuv420.ogv", "yuv422.ogv", "yuv444.ogv", "cif.ogv",
                   "lowq.ogv", "cropped.ogv", "dup.ogv")
# the ogv path's OGV from the JAX CLI (TCFORGE_NATIVE_THEORAENC=1, --mesh
# off), which the port's must equal (tests/data/theora/make_goldens.py)
THEORA_INPUT_SHA256 = {
    "ogv": "783bfbeb8d544fdc43b9c938570f9686949bdfaf5918c3a79b036130935a805c"}
# each output from the port's CLI with --device cpu, equal to the JAX
# CLI's (tests/data/theora/make_goldens.py)
THEORA_CPU_SHA256 = {
    "ogv_dec": "21cef946183a64c63751bbe9f5ba4fbe708b5d6401c6c6ea65204943e9685165",
    "yuv420.ogv": "2c897058f9c28ffdd3c0315d50955115912b0def6450b703f8f7dc84941ff3d7",
    "yuv422.ogv": "7242087042dcb80a62245c1646070e0ffc47cc359d67f3f2e2cfb55a902de11c",
    "yuv444.ogv": "2d53052450a280423d1540ad9392ffca4305c62a04a94d4a39f5915aaeb60262",
    "cif.ogv": "bf26661c9b19d765d4ccb54dd67d36ef47d0650244fd4e607eadc144e42dbd36",
    "lowq.ogv": "e9fd70022797e370fea203ab892e8225956912040b50e713061cfdc988fc65c8",
    "cropped.ogv": "dd1a8cba691dd14514253437faea9e68bad10b3b0ae0d0ac20d05e02aae22451",
    "dup.ogv": "dc5425df1d1b5f2791814453642b8da5adbb0b39e07912f3ac97baffd909213f"}
# small cases through both CLIs (tests/test_torch_theora_cli.py): input,
# arguments, outputs, exit code; run in order (ogv_in reads ogv_small's)
THEORA_GOLDEN = {
    "ogv_small": ("field.y4m", ["-p", "a.wav", "-I", "5", "-J",
                                "hqdn3d=luma=4.0", "-y",
                                "theora=qi=45:keyint=8,vorbis,ogg",
                                "--batch", "5"], ["o.ogv"], 0),
    "ogv_in": ("o.ogv", ["-x", "ogg", "-m", "o.wav", "--batch", "4"],
               ["o.y4m", "o.wav"], 0),
    "theora_avi": ("cif.y4m", ["-y", "theora=qi=30:keyint=4,raw,avi"],
                   ["o.avi"], 0),
    "minus_n": ("cif.y4m", ["-N", "theora", "-F", "qi=60"], ["o.ogg"], 0),
    "yuv422_in": ("yuv422.ogv", ["--batch", "3"], ["o.y4m"], 0),
    "yuv444_in": ("yuv444.ogv", ["--batch", "3"], ["o.y4m"], 0),
}
# the JAX CLI's outputs of each case, by file
THEORA_GOLDEN_SHA256 = {
    "ogv_small": ["b6127161f1ae9a59e66b9942c82bd9af19e72152432fc40fd8ca7aeddd1bdfda"],
    "ogv_in": ["1cb83637c4f819d12edb76ecd1362404ac0a4a7687a3246a67c03356e8ade931", "015ba7e443415ea16a537ab4a5da8413ea38a35a487ab5078100c92ab6e989ba"],
    "theora_avi": ["b73fc1e68d54b12246ab0a8a4292ab311b93d3c5f079e9a84b1ac5b8f68e910f"],
    "minus_n": ["ebd50fbb018116ad68631df4c14c4aa2c99ed837e8f60c2d5e8593a5ab7abe73"],
    "yuv422_in": ["7242087042dcb80a62245c1646070e0ffc47cc359d67f3f2e2cfb55a902de11c"],
    "yuv444_in": ["2d53052450a280423d1540ad9392ffca4305c62a04a94d4a39f5915aaeb60262"],
}
# the operations of the Theora kernels, for the bounds: a coded block's
# dequantization (64 products), its IDCT (16 1-D passes of 8 points, each
# 16 products with their shift and 26 adds) and final rounding (2 a
# sample) and its clip (2 a sample), the prediction counted by
# ``_theora_recon_ops``; the loop filter's 16 operations a sample on an
# edge; fdct's 64 x 64 x 3 float64 operations; me's counted by
# ``_theora_me_ops``
THEORA_RECON_OPS = 64 + 16 * (16 * 2 + 26) + 64 * 2 + 64 * 2
THEORA_FILTER_OPS = 16
THEORA_FDCT_FLOPS = 64 * 64 * 3


def theora_input(name: str, directory) -> Path:
    """A ``THEORA_GOLDEN`` input in ``directory``: the fixtures, or written
    here (seeded, numpy only): a 176x144 interlaced clip of 12 frames and
    its 48 kHz WAV, a 176x144 clip of 6 frames; ``o.ogv`` is ogv_small's
    output."""
    d = Path(directory)
    if name.endswith(".ogv") and name != "o.ogv":
        return THEORA_DATA / name
    path = d / name
    if path.exists() or name == "o.ogv":
        return path
    if name == "field.y4m":
        write_programme_y4m(path, 176, 144, 12, seed=61, fps=(25, 1))
    elif name == "a.wav":
        write_test_wav(path, 12 * 1920, seed=61, frame=1920)
    elif name == "cif.y4m":
        write_motion_y4m(path, 176, 144, 6, seed=62, fps=(25, 1))
    else:
        raise KeyError(name)
    return path


def theora_golden_argv(case: str, directory) -> list:
    """The CLI arguments of a ``THEORA_GOLDEN`` case in ``directory``."""
    d = Path(directory)
    src, args, outs, _ = THEORA_GOLDEN[case]
    argv = ["-i", str(theora_input(src, d))]
    for a in args:
        if a == "o.wav":
            a = str(d / a)
        elif a.endswith(".wav"):
            a = str(theora_input(a, d))
        argv.append(a)
    main_out = next(o for o in outs if o != "o.wav")
    return [*argv, "-o", str(d / main_out), "--progress_off", "-q"]


def theora_golden_outputs(case: str, directory) -> list:
    return [Path(directory) / o for o in THEORA_GOLDEN[case][2]]


def theora_inputs(directory) -> tuple:
    """The ogv path's source in ``directory``: ``write_programme_y4m`` at
    1920x1080, 29.97 fps, top field first, ``THEORA_FRAMES`` frames, and a
    seeded 48 kHz stereo WAV as long."""
    d = Path(directory)
    src, wav = d / "broadcast_ogv.y4m", d / "broadcast_ogv.wav"
    if not src.exists():
        write_programme_y4m(src, MAIN_W, MAIN_H, THEORA_FRAMES,
                            seed=THEORA_SEED, fps=THEORA_FPS)
        write_test_wav(wav, THEORA_FRAMES * 1602 + 1602, seed=THEORA_SEED)
    return src, wav


def theora_argv(name: str, directory, out) -> list:
    """The CLI arguments of the ogv and ogv_dec paths (ogv_dec reads the
    ogv path's ``ogv.ogv`` in ``directory``) and of a fixture's decode."""
    d = Path(directory)
    if name == "ogv":
        src, wav = theora_inputs(d)
        argv = ["-i", str(src), "-p", str(wav), *OGV_ARGS]
    elif name == "ogv_dec":
        argv = ["-i", str(d / "ogv.ogv"), *OGV_DEC_ARGS]
    else:
        argv = ["-i", str(THEORA_DATA / name), "-x", "ogg", "--batch", "3"]
    batch = [] if name in THEORA_FIXTURES else ["--batch", str(MAIN_BATCH)]
    return [*argv, *batch, "-o", str(out), "--progress_off", "-q"]


def theora_outputs() -> list:
    """(name, output file name) of the ogv path, its read-back and the
    fixtures' decodes, in the order they run."""
    return [("ogv", "ogv.ogv"), ("ogv_dec", "ogv_dec.mpg"),
            *((f, f.replace(".ogv", ".y4m")) for f in THEORA_FIXTURES)]


# ---------------------------------------------------------------------- #
# The Theora phases

THEORA_RUNS = 2             # phase 6's timed runs
THEORA_CHECK_FRAMES = 4     # phase 4's frames with every call checked


@contextlib.contextmanager
def _kept_calls(kernels, names, store):
    """Every call of the wrappers ``names`` appends its arguments to
    ``store[name]`` (None: nothing kept)."""
    saved = {n: getattr(kernels, n) for n in names}

    def keep(name, fn):
        def call(*a):
            store[name].append(a)
            return fn(*a)
        return call
    try:
        if store is not None:
            for n in names:
                setattr(kernels, n, keep(n, saved[n]))
        yield
    finally:
        for n, fn in saved.items():
            setattr(kernels, n, fn)


def _theora_packets(name: str) -> list:
    from tcforge_tpu_torch.io.ogg import iter_pages, pages_to_packets
    with open(THEORA_DATA / name, "rb") as f:
        return [p for _, p in pages_to_packets(iter_pages(f))]


def _filtered_edges(coded, fmt: int, fw: int, fh: int) -> int:
    """The edges ``theora_loop_filter`` filters for the coded flags."""
    from tcforge_tpu_torch.io import theoracodec
    c = coded.bool().cpu().numpy()
    n, off = 0, 0
    for h, w in theoracodec.plane_dims(fmt, fw, fh):
        bh, bw = h // 8, w // 8
        g = c[off:off + bh * bw].reshape(bh, bw)
        off += bh * bw
        n += int(g[:, 1:].sum() + g[1:, :].sum()
                 + (g[:, :-1] & ~g[:, 1:]).sum() + (g[:-1, :] & ~g[1:, :]).sum())
    return n


def _theora_recon_ops(args) -> int:
    """The int32 operations ``theora_recon`` needs on ``args``: each
    coded block's ``THEORA_RECON_OPS`` and its prediction, 1 a sample
    for an intra block (+128) or a whole-pel vector (+ the residual), 3
    at a half-pel vector (the average and the residual); an uncoded
    block only copies."""
    import torch
    from tcforge_tpu_torch.io import theora as th
    from tcforge_tpu_torch.io import theoracodec
    coded, mbrec, last = args[1].bool(), args[3], args[5]
    fmt, fw, fh = args[7:10]
    n = int(coded.sum())
    if last is None:
        return n * (THEORA_RECON_OPS + 64)
    fc = torch.tensor(th.FRAME_CLASS, device=mbrec.device)
    half = 0
    off = 0
    for p, (h, w) in enumerate(theoracodec.plane_dims(fmt, fw, fh)):
        bh, bw = h // 8, w // 8
        mode, mx, my = theoracodec.block_motion(mbrec, fmt, p, bh, bw)
        c = coded[off:off + bh * bw].reshape(bh, bw)
        half += int((c & (fc[mode] != 0) & (((mx | my) & 1) != 0)).sum())
        off += bh * bw
    return n * (THEORA_RECON_OPS + 64) + half * 64 * 2


def _theora_me_ops(args) -> int:
    """The int32 operations ``theora_me`` needs on ``args``, counted on
    the walk of its plain version: every macroblock's four 8x8 SSEs (3 a
    sample), a coded macroblock's mean and its SAD from it (4 a sample),
    and each distinct SAD that the walk asks for once (3 a sample, 5 at a
    half-pel vector: the average)."""
    from tcforge_tpu_torch.io import theoracodec
    src, ref, order, lam, sse_floor = args
    sse, sad_i = theoracodec.mb_stats_ref(src, ref)
    table = theoracodec.TableSad(src, ref)
    seen = set()

    def sad(mb, mx, my):
        seen.add((int(mb), mx, my))
        return table(mb, mx, my)
    rec = theoracodec.choose_modes(sad, sse.cpu().numpy(),
                                   sad_i.cpu().numpy(), order.cpu().numpy(),
                                   lam, sse_floor)
    half = sum(1 for _, mx, my in seen if (mx | my) & 1)
    return (src.numel() * 3 + int((rec[:, 0] >= 0).sum()) * 256 * 4
            + (len(seen) - half) * 256 * 3 + half * 256 * 5)


def _check_theora_kernels(torch, kernels, bench):
    """Phase 3 for the Theora kernels at tolerance 0 against their plain
    versions: the encoder on 1280x720 programme content (a key frame and
    two inter frames at qi 45, one at qi 0 and 63), then the 4:2:0, 4:2:2, 4:4:4
    and cropped fixtures' decode, every kernel call checked; then each
    kernel timed on the qi 45 encode's calls (the key frame's and an inter
    frame's, ``per_batch`` as the ogv path's batch of 16 holds them) over
    clones past L2, beside its plain version, its bound and, for the two
    transforms, the library yardstick (a float64 ``torch.matmul`` of the
    blocks with a 64 x 64 basis: the same count of products, not the same
    function)."""
    from tcforge_tpu_torch.io import theoracodec
    from tcforge_tpu_torch.io.y4m import Y4MReader
    dev = bench.dev
    with tempfile.TemporaryDirectory(prefix="chip_smoke_theora3_") as tmp:
        src = Path(tmp) / "p.y4m"
        write_programme_y4m(src, 1280, 720, 3, seed=THEORA_SEED + 1,
                            fps=(25, 1))
        ys, us, vs = _read_y4m(Y4MReader, src)
    kept = {k: [] for k in THEORA_KERNELS}
    for qi in (0, 45, 63):
        enc = theoracodec.TheoraDeviceEncoder(1280, 720, qi=qi, gop=16,
                                              device=dev)
        case = f"1280x720 encode at qi {qi}"
        with checked_kernels(kernels, bench, case, THEORA_WRAPPERS) as n, \
                _kept_calls(kernels, THEORA_KERNELS,
                            kept if qi == 45 else None):
            for k in range(3 if qi == 45 else 2):
                enc.encode(*(torch.from_numpy(p[k]).to(dev)
                             for p in (ys, us, vs)))
        emit(phase="kernel_check", kernel="theora", case=case,
             checked_calls=n, max_abs_err=0)
    for name in ("yuv420.ogv", "yuv422.ogv", "yuv444.ogv", "cropped.ogv"):
        pk = _theora_packets(name)
        dec = theoracodec.TheoraDeviceDecoder(pk[:3], dev)
        with checked_kernels(kernels, bench, name, THEORA_WRAPPERS) as n:
            for pkt in pk[3:]:
                dec.decode(pkt)
        emit(phase="kernel_check", kernel="theora", case=f"{name} decode",
             fmt=dec.geo.fmt, checked_calls=n, max_abs_err=0)
    kmat = torch.from_numpy(np.kron(theoracodec.basis(),
                                    theoracodec.basis())).to(dev)

    def yardstick(blocks):
        return (torch.matmul, [(blocks.reshape(-1, 64).to(torch.float64),
                                kmat)])
    for label, at, per_batch in (("key frame", 0, 1), ("inter frame", -1, 15)):
        args = kept["theora_recon"][at]
        rot = bench.rotation(lambda: _tensors_clone(args))
        coefs, coded = args[0], args[1]
        out = kernels.theora_recon(*args)
        refs = args[5] if args[5] is not None else ()
        bench.record("theora_recon", f"1280x720 {label}, qi 45", per_batch,
                     kernels.theora_recon, kernels.theora_recon_ref, rot,
                     nbytes=_nbytes(coefs, coded, args[2], args[3], *out,
                                    *refs),
                     ops=_theora_recon_ops(args),
                     library=yardstick(coefs), plain_reps=1)
        args = kept["theora_loop_filter"][at]
        rot = bench.rotation(lambda: _tensors_clone(args))
        bench.record("theora_loop_filter", f"1280x720 {label}, qi 45",
                     per_batch, kernels.theora_loop_filter,
                     kernels.theora_loop_filter_ref, rot,
                     nbytes=2 * _nbytes(*args[0]) + _nbytes(args[1]),
                     ops=THEORA_FILTER_OPS * 8 * _filtered_edges(
                         args[1], *args[3:]), plain_reps=1, reps=10)
        args = kept["theora_fdct_quant"][at]
        rot = bench.rotation(lambda: _tensors_clone(args))
        n = args[0].shape[0]
        bench.record("theora_fdct_quant", f"1280x720 {label}, qi 45",
                     per_batch, kernels.theora_fdct_quant,
                     kernels.theora_fdct_quant_ref, rot,
                     nbytes=_nbytes(args[0], args[1]) + n * 64 * 4,
                     ops=THEORA_FDCT_FLOPS * n, library=yardstick(args[0]),
                     ops_per_s=F64_FMA_PER_S, plain_reps=1)
    args = kept["theora_me"][-1]
    rot = bench.rotation(lambda: _tensors_clone(args))
    nmb = args[0].numel() // 256
    bench.record("theora_me", "1280x720 inter frame, qi 45", 15,
                 kernels.theora_me, kernels.theora_me_ref, rot,
                 nbytes=_nbytes(args[0], args[1]) + nmb * 7 * 4,
                 ops=_theora_me_ops(args), plain_reps=1, reps=10)


def _run_theora(torch, cli, kernels, bench, directory) -> dict:
    """Phase 4 for the Theora paths: the ogv path (1080i with its WAV to a
    720p Theora + Vorbis OGV) through the port's CLI with the launch
    counts set to 0 just before and read just after (every kernel of the
    path launched; one ``theora_fdct_quant``, ``theora_recon`` and
    ``theora_loop_filter`` a frame, one ``theora_me`` an inter frame), its
    OGV against the JAX CLI's pinned digest (``THEORA_INPUT_SHA256``); the
    ogv_dec path (that OGV with its own Vorbis track to an MPEG-2
    programme stream) and every fixture's decode to Y4M (every kernel call
    held against its plain version), each against the port's --device cpu
    run's pinned digest (``THEORA_CPU_SHA256``, which equals the JAX
    CLI's); then both paths on their first
    ``THEORA_CHECK_FRAMES`` frames with every Theora kernel call held
    against its plain version.  Returns the launches by path."""
    d = Path(directory)
    launches = {}
    for name, out, names in (("ogv", "ogv.ogv", OGV_KERNELS),
                             ("ogv_dec", "ogv_dec.mpg", OGV_DEC_KERNELS)):
        path = d / out
        seconds, got = _launched_run(torch, cli, kernels,
                                     theora_argv(name, d, path), names, name)
        launches[name] = got
        digest = sha256_file(path)
        pinned = (THEORA_INPUT_SHA256 if name == "ogv"
                  else THEORA_CPU_SHA256)[name]
        emit(phase="path", path=name, frames=THEORA_FRAMES, seconds=seconds,
             e2e_fps=THEORA_FRAMES / seconds, bytes=path.stat().st_size,
             launches={k: got[k] for k in names})
        emit(phase="path_vs_cpu" if name == "ogv_dec" else "path_vs_jax",
             path=name, identical=digest == pinned, sha256=digest,
             pinned=pinned)
        check(digest == pinned, f"{name}: the card's output differs from "
                                "the pinned digest")
    keys = -(-THEORA_FRAMES // 16)
    per = {"theora_fdct_quant": ("ogv", THEORA_FRAMES),
           "theora_me": ("ogv", THEORA_FRAMES - keys),
           "theora_recon": ("ogv_dec", THEORA_FRAMES),
           "theora_loop_filter": ("ogv_dec", THEORA_FRAMES)}
    for kernel, (name, n) in per.items():
        check(launches[name][kernel] == n and launches["ogv"]["theora_recon"]
              == THEORA_FRAMES, f"{name}: {launches[name][kernel]} {kernel} "
                                f"launches for {THEORA_FRAMES} frames")
    for name in THEORA_FIXTURES:
        out = d / name.replace(".ogv", ".y4m")
        with checked_kernels(kernels, bench, name, THEORA_WRAPPERS) as n:
            _, got = _launched_run(torch, cli, kernels,
                                   theora_argv(name, d, out),
                                   ("theora_recon",), name)
        digest = sha256_file(out)
        emit(phase="path_vs_cpu", path=name, identical=digest ==
             THEORA_CPU_SHA256[name], sha256=digest,
             pinned=THEORA_CPU_SHA256[name],
             launches={k: got[k] for k in ("theora_recon",
                                           "theora_loop_filter")},
             checked_calls={k: v for k, v in n.items() if v})
        check(digest == THEORA_CPU_SHA256[name],
              f"{name}: the card's decode differs from the CPU's")
    for name, out in (("ogv", "ogv_checked.ogv"),
                      ("ogv_dec", "ogv_dec_checked.mpg")):
        with checked_kernels(kernels, bench, f"{name} path",
                             THEORA_WRAPPERS) as counts:
            rc = cli.main([*theora_argv(name, d, d / out), "--max_frames",
                           str(THEORA_CHECK_FRAMES), "--device", "cuda"])
        check(rc == 0 and sum(counts.values()) > 0,
              f"{name} with checked kernels: exit code {rc}")
        emit(phase="path_checked", path=name, frames=THEORA_CHECK_FRAMES,
             checked_calls={k: v for k, v in counts.items() if v})
        (d / out).unlink()
    return launches


def _theora_goldens(cli, tmp) -> None:
    """Phase 5 for Theora: every ``THEORA_GOLDEN`` case on the card in one
    directory, in order, its exit code and outputs against the JAX CLI's
    pinned digests."""
    d = tmp / "theora_golden"
    d.mkdir()
    for case, (_, _, _, want_rc) in THEORA_GOLDEN.items():
        rc = cli.main([*theora_golden_argv(case, d), "--device", "cuda"])
        got = [sha256_file(f) if f.exists() else None
               for f in theora_golden_outputs(case, d)]
        pinned = THEORA_GOLDEN_SHA256[case]
        emit(phase="golden", path=f"theora_{case}", rc=rc, sha256=got,
             pinned=pinned)
        check(rc == want_rc and got == pinned,
              f"theora {case}: exit code {rc} or outputs differ from the "
              "JAX-pinned digests")


def _theora_rates(torch, cli, directory) -> None:
    """Phase 6 for the Theora paths on phase 4's files: each CLI, wall
    clock to the last byte, ``THEORA_RUNS`` runs (phase 4 ran each CLI
    on the same files, so the kernels and tables are warm), with
    host clocks around its stages (ms a 16-frame batch: ogv's encoder on
    the main thread and, inside it, the host's DC residuals, token coder
    and the reconstruction's queueing, the Vorbis encoder and the
    multiplexor on the writer thread; ogv_dec's host parse and token
    decode on the reader thread, the reconstruction and crop on the main
    one, the MPEG-2 and MP2 encoders), then once under torch.profiler:
    the device's busy time a batch and the named kernels'."""
    from torch.profiler import ProfilerActivity, profile

    from tcforge_tpu_torch.io import theoracodec
    from tcforge_tpu_torch.modules.encoders import audio_enc, mpeg2, \
        theora_enc, vorbis_enc
    from tcforge_tpu_torch.modules.importers import ogg_import
    from tcforge_tpu_torch.modules.muxers import ogg_mux, ps_mux
    from tcforge_tpu_torch.pipeline import chain as chain_mod
    d = Path(directory)
    enc = theoracodec.TheoraDeviceEncoder
    stages = {
        "ogv": [(theora_enc.TheoraEncoder, "encode_video", "theora_encoder"),
                (enc, "_finish", "host_tokens_and_recon_queue"),
                (theoracodec, "write_tokens", "host_token_coder"),
                (vorbis_enc.VorbisAudioEncoder, "encode_audio",
                 "vorbis_encoder"),
                (vorbis_enc.VorbisAudioEncoder, "flush", "vorbis_encoder"),
                (ogg_mux.OggMuxer, "write_video", "mux"),
                (ogg_mux.OggMuxer, "write_audio", "mux")],
        "ogv_dec": [(ogg_import.OggImporter, "plan_batch", "host_parse"),
                    (ogg_import.OggImporter, "execute", "recon_and_crop"),
                    (mpeg2.Mpeg2VideoEncoder, "encode_video",
                     "mpeg2_encoder"),
                    (audio_enc.Mp2Encoder, "encode_audio", "mp2_encoder"),
                    (ps_mux.MpegPsMuxer, "write_video", "mux")]}
    names = {"ogv": ("theora_", "zoom_", "scan_"),
             "ogv_dec": ("theora_", "scan_", "mpeg2_")}
    batches = THEORA_FRAMES / MAIN_BATCH
    for name, out in (("ogv", "ogv_rate.ogv"), ("ogv_dec", "ogv_dec_rate.mpg")):
        argv = [*theora_argv(name, d, d / out), "--device", "cuda"]
        clock = _StageClock()
        for owner, attr, label in stages[name]:
            clock.wrap(owner, attr, label)
        clock.wrap(chain_mod.VideoChain, "__call__", "chain_call")
        fps = []
        try:
            for _ in range(THEORA_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = cli.main(argv)
                torch.cuda.synchronize()
                check(rc == 0, f"{name} CLI: exit code {rc}")
                fps.append(THEORA_FRAMES / (time.perf_counter() - t0))
        finally:
            clock.restore()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rc = cli.main(argv)
            torch.cuda.synchronize()
        check(rc == 0, f"{name} under the profiler: exit code {rc}")
        busy = _device_busy(prof, batches, names[name])
        per_run = batches * THEORA_RUNS
        emit(phase="cli", path=name, frames=THEORA_FRAMES, fps=fps,
             median_fps=float(np.median(fps)), min_fps=min(fps),
             max_fps=max(fps),
             host_wall_ms_per_batch={k: 1e3 * v / per_run
                                     for k, v in clock.wall.items()},
             host_cpu_ms_per_batch={k: 1e3 * v / per_run
                                    for k, v in clock.cpu.items()},
             device_busy_ms_per_batch=busy["busy_ms_per_batch"],
             profiled_ms_per_batch=busy["profiled_ms_per_batch"],
             named_kernels_ms_per_batch=busy["named_ms_per_batch"],
             device_kernels_ms_per_batch=busy["kernels_ms_per_batch"])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
