"""Seeded violation: a wrapper that states the segment-search kernel's
shapes and disagrees with ``kernels/seg_search.cu`` (rule
``cuda-constant-mirror``): the source's ``MAX_WARPS`` is 8, and a
wrapper that launches 16 warps per CTA indexes past the kernel's
per-warp buffers."""

LANES = 128
F = LANES
WARPS_PER_CTA = 16          # <- cuda-constant-mirror
MAX_K = 8
MAX_TABLE = 8192
