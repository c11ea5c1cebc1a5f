"""dmnerf_tpu_torch — the PyTorch / CUDA port of dmnerf_tpu for one NVIDIA H100.

It mirrors the JAX package's layout and function names, and keeps its parameter
layout (flat dicts of ``[in, out]`` matrices), so a JAX checkpoint carries over
without transposes. It imports torch, numpy and scipy, never JAX and nothing of
``dmnerf_tpu``.

  core/      positional encoding, the DM-NeRF MLP, rays, samplers, compositor and
             the coarse-to-fine pipeline, as plain functions on tensors.
  kernels/   hand-written Hopper kernels (CUDA C++ for sm_90a, built with nvcc at
             first use) with their plain PyTorch versions and wrappers.
  objfield/  instance-map evaluation (Hungarian-matched IoU, COCO-style AP).
  render/    the chunked image renderer and test-view evaluation.
  data/      the DM-SR loader and the analytic DM-SR scene generator.
  utils/     devices, checkpoints, image metrics, result files.
  tools/     label-map visualisation.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise.
"""

__version__ = "0.1.0"
