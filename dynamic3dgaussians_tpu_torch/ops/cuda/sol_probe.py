"""Speed-of-light probe of the tile walk (K3): the CUDA kernel's wrapper and
its plain PyTorch version.

Port of the probe of `tools/bench_vpu_sol.py` (its `build`: the bodies
`kern_compute` with `fused_process`, and `kern_dma`). The kernel is
`csrc/sol_probe.cu` (one thread block per walk; the compute variants give
each thread two pixels of a tile column and read records in 128-bit loads; its
source note says what bounds it). A walk is the work of one 16x16 tile, the
pixels (lin % 16, lin // 16) of tile 0, over a feature-major table

  rec  (16, n_chunks * 256) float32: rows x, y, conic a, b, c (log2 units),
       -, the log2-opacity rows 6 and 7 of the fused path, then 8 value rows

in blocks of 256 records. Three variants (`KINDS`):

  compute_only    the fused cell pipeline over block 0, n_chunks times
  stream_compute  the same pipeline over the n_chunks successive blocks
  dma_only        every block's rec[0:8, 0:128] + rec[8:16, 128:256], summed

Per record and pixel: p0 = -(a dx^2 + c dy^2)/2 - b dx dy, m = min(p0 + row6,
row7), m = -130 where m < log2(1/255); alpha = 2^m, l = log2(1 - alpha), cum
the inclusive sum of l over the block, w = 2^(m + (cum - l) + log2T), acc +=
w * values; after each block log2T += its total.

Each walk gives two parts (`PARTS`), whose sum (`total`) is the reference's
scalar: [sum(acc), sum(log2T)] over the tile's pixels for the compute
variants, and [sum of the rows 0:8 corner, sum of the rows 8:16 corner] for
dma_only. They are kept apart because they differ by orders of magnitude:
after the first block log2T is about -54 per pixel and w about 0, so
sum(log2T) is ~10^7 at the bench shape and sum(acc) ~10^2; a tolerance on
the sum could not see the acc half of the pipeline.

A batch axis holds B independent walks: rec (B, 16, n_chunks * 256) gives
(B, 2) results, a (16, n) table a (2,) result. One walk occupies one SM of
the card, so a card-wide measurement launches many walks, each on its own
slice.
"""

from __future__ import annotations

import torch

from dynamic3dgaussians_tpu_torch.device import no_tf32

KINDS = ("compute_only", "dma_only", "stream_compute")
PARTS = {"compute_only": ("acc", "log2T"), "stream_compute": ("acc", "log2T"),
         "dma_only": ("geometry_corner", "value_corner")}
P = 256              # pixels of one 16x16 tile
TILE = 16
CHUNK = 256          # records per block
ROWS = 16            # 8 geometry + 8 value rows
VAL_ROW = 8
LOG2_ALPHA_EPS = -7.994353436858858    # log2(1/255)
DEAD_EXP = -130.0


def _check_args(rec: torch.Tensor, kind: str) -> torch.Tensor:
    """rec as a (B, 16, n) view."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if rec.dtype != torch.float32 or rec.dim() not in (2, 3):
        raise ValueError(f"rec must be a (16, n) or (B, 16, n) float32 table,"
                         f" got {tuple(rec.shape)} {rec.dtype}")
    rec3 = rec if rec.dim() == 3 else rec[None]
    if rec3.shape[1] != ROWS or rec3.shape[2] == 0 or rec3.shape[2] % CHUNK:
        raise ValueError(f"rec must have {ROWS} rows and a positive multiple "
                         f"of {CHUNK} columns, got {tuple(rec.shape)}")
    if rec3.shape[0] == 0:
        raise ValueError("rec holds no walk")
    return rec3


def sol_probe_torch(rec: torch.Tensor, kind: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel: all walks at once, one loop step
    per block, `torch.cumsum` for the scan and a (256, 256) @ (256, 8)
    product per block and walk. Returns each walk's two parts."""
    rec3 = _check_args(rec, kind)
    b, _, ne = rec3.shape
    n_chunks = ne // CHUNK
    dev = rec3.device
    f32 = torch.float32
    blocks = rec3.reshape(b, ROWS, n_chunks, CHUNK)
    if kind == "dma_only":
        acc_g = torch.zeros((b, 8, 128), dtype=f32, device=dev)
        acc_v = torch.zeros((b, 8, 128), dtype=f32, device=dev)
        for k in range(n_chunks):
            acc_g = acc_g + blocks[:, 0:8, k, 0:128]
            acc_v = acc_v + blocks[:, VAL_ROW:ROWS, k, 128:CHUNK]
        out = torch.stack([acc_g.sum(dim=(1, 2)), acc_v.sum(dim=(1, 2))], -1)
        return out if rec.dim() == 3 else out[0]

    lin = torch.arange(P, device=dev)
    px = (lin % TILE).to(f32)[None, :, None]          # (1, P, 1)
    py = (lin // TILE).to(f32)[None, :, None]
    log_t = torch.zeros((b, P), dtype=f32, device=dev)
    acc = torch.zeros((b, P, 8), dtype=f32, device=dev)
    for k in range(n_chunks):
        g = blocks[:, :, 0 if kind == "compute_only" else k, :]   # (B, 16, C)
        x, y = g[:, 0, None, :], g[:, 1, None, :]                  # (B, 1, C)
        ca, cb, cc = g[:, 2, None, :], g[:, 3, None, :], g[:, 4, None, :]
        dx = x - px                                                # (B, P, C)
        dy = y - py
        p0 = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        m = torch.minimum(p0 + g[:, 6, None, :], g[:, 7, None, :])
        m = torch.where(m >= LOG2_ALPHA_EPS, m, torch.full_like(m, DEAD_EXP))
        logs = torch.log2(1.0 - torch.exp2(m))
        cum = torch.cumsum(logs, dim=-1)
        w = torch.exp2(m + (cum - logs) + log_t[:, :, None])
        with no_tf32():
            acc = acc + torch.bmm(w, g[:, VAL_ROW:ROWS, :].transpose(1, 2))
        log_t = log_t + cum[:, :, -1]
    out = torch.stack([acc.sum(dim=(1, 2)), log_t.sum(dim=1)], -1)
    return out if rec.dim() == 3 else out[0]


def total(parts: torch.Tensor) -> torch.Tensor:
    """The reference's scalar per walk: the sum of its two parts."""
    return parts[..., 0] + parts[..., 1]


def sol_probe(rec: torch.Tensor, kind: str) -> torch.Tensor:
    """Run the probe kernel on a CUDA tensor.

    Returns each walk's two parts (`PARTS`). A CPU tensor takes the plain
    version (`sol_probe_torch`); a CUDA tensor launches `csrc/sol_probe.cu`
    or raises. Each launch adds one to `sol_probe.launches`.
    """
    rec3 = _check_args(rec, kind)
    if rec.device.type == "cpu":
        return sol_probe_torch(rec, kind)
    if rec.device.type != "cuda":
        raise ValueError(f"sol_probe runs on cuda or cpu tensors, got "
                         f"{rec.device}")
    if not rec3.is_contiguous():
        raise ValueError("rec must be contiguous")
    from dynamic3dgaussians_tpu_torch import _build
    lib = _build.load_library()
    dev = rec.device
    out = torch.empty((rec3.shape[0], 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.d3g_sol_probe(rec3.data_ptr(), rec3.shape[2], rec3.shape[0],
                                KINDS.index(kind), out.data_ptr(), stream)
    _build.check(lib, err, "sol_probe kernel launch")
    sol_probe.launches += 1
    return out if rec.dim() == 3 else out[0]


sol_probe.launches = 0
