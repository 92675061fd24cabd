"""ffmpeg_ffv2_tpu — an accelerator FFV1/FFV2 codec framework in JAX.

A from-scratch rebuild of the capabilities of the cyanreg/ffmpeg_ffv2
reference (an FFmpeg 4.2 fork carrying the FFV1 lossless codec and the
experimental FFV2 transform codec), redesigned for an accelerator (a GPU;
the CPU for tests):

- compute path: JAX / XLA / Pallas (parallel context modeling, transforms,
  slice-sharded entropy coding),
- host runtime: C++ (bit-exact entropy coders, packet assembly, containers),
- scale-out: jax.sharding over device meshes (slices and frames ->
  devices).

Layout (see SURVEY.md section 7 for the plan):
  core/       frames, pixel formats, CRC32, bit IO
  coder/      range coder, Golomb-Rice, Daala entropy coder (bit-exact)
  ffv1/       FFV1 codec: predictor/context kernels, slice codec, headers
  ffv2/       FFV2 codec: DCT/DST, lapped filters, PVQ, block coding
  convert/    pixel format conversions (swscale equivalent)
  parallel/   slice<->core sharding, frame batching, packet assembly
  container/  raw packet framing, AVI mux/demux
  cli/        encode/decode/transcode/psnr tool
  native/     C++ host-side codec core (ctypes-bound)
  accel.py    how each device stage runs on the platform JAX finds
"""

__version__ = "0.1.0"
