"""Speed-of-light probe of the tile walk (K3) on one NVIDIA GPU.

    python -m dynamic3dgaussians_tpu_torch.tools.bench_sol [--small]
        [--device cpu]

The port's counterpart of `tools/bench_vpu_sol.py`: the same numpy
`RandomState(0)` table (16, n_chunks * 256) uniform in [-1, 1] with rows 6
and 7 set to -2, n_chunks 2143 (35.1 MB, the 200k-gaussian scene's
schedule) or 4 with `--small`, run through the three variants of
`ops/cuda/sol_probe.py::sol_probe` (`csrc/sol_probe.cu` on the card, the
plain version with `--device cpu`). One JSON line per variant, with the
reference's keys `ms`, `ns_per_cell` and `GB_s` for one walk, the walk's
scalar (`value`, the reference's) and its two `parts`, and `card_wide`:
the same variant over B walks (4 per SM), each with its own slice of a
table of B x 35.1 MB, the size that keeps timed repeats out of the 50 MB
L2. One walk is one SM's work, so only the card-wide figures are card
figures. Beside each bound stands `sfu_floor_ms`, the 3 transcendentals per
cell at the SFU's rate and the card's maximum SM clock (`nvidia-smi
--query-gpu=clocks.max.sm`, given as `sm_clock_max_mhz`). Then `exp2`:
torch.exp2(x).sum() over the reference's (n_chunks, 256, 128) draw, the
counterpart of its XLA `exp2_xla` line. Times are CUDA events over 3
launches after a warm-up; every line carries the card's `nvidia-smi` name
and power limit.
On the CPU the lines carry the values and no times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Dict

import numpy as np
import torch

from dynamic3dgaussians_tpu_torch.device import resolve_device
from dynamic3dgaussians_tpu_torch.ops.cuda.sol_probe import (CHUNK, KINDS, P,
                                                             PARTS, ROWS,
                                                             sol_probe, total)

N_CHUNKS = 2143          # the bench shape
N_CHUNKS_SMALL = 4
WALKS_PER_SM = 4
ITERS = 3                # timed launches per figure, after one warm-up
# float32 operations per cell of the compute variants: p0 11 (2 sub, 3
# products of offsets, 3 coefficient muls, add, * -1/2, sub), the gate 3 (add
# row 6, min row 7, compare-select), the scan step 8 (exp2, 1 - alpha, log2,
# running add, cum - l, + m, + log2T, exp2), the 8 value rows 16 (multiply-
# adds). Each of the 3 transcendentals counts as one operation at the FMA
# rate, which the card's SFU, where they run, does not reach: `sfu_floor_ms`
# beside the bound counts them at the SFU's rate. The count is held fixed so
# that bound shares compare across versions of the kernel; the CUDA kernel
# itself does ~34 per cell (dx, a dx^2 and b dx once per record for a
# thread's 2 pixels of a column, an exclusive scan with no cum - l, log2T
# added once per block), so its bound on its own count is ~0.89x this one.
FLOPS_PER_CELL = 38
TRANSCENDENTALS_PER_CELL = 3
# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# ex2 / lg2 results per clock per SM on sm_90 (CUDA C Programming Guide,
# arithmetic instruction throughput)
SFU_PER_CLOCK_SM = 16


def probe_inputs(small: bool):
    """The reference probe's inputs, from the same numpy draws: the record
    table (16, n_chunks * 256) and the exp2 line's (n_chunks, 256, 128)."""
    n_chunks = N_CHUNKS_SMALL if small else N_CHUNKS
    rng = np.random.RandomState(0)
    rec = rng.uniform(-1, 1, (ROWS, n_chunks * CHUNK)).astype(np.float32)
    rec[6] = -2.0   # log2-op rows: plausible alphas
    rec[7] = -2.0
    bigx = rng.uniform(-8, 0, (n_chunks, P, 128)).astype(np.float32)
    return rec, bigx


def card_table(n_walks: int, n_chunks: int, device, seed: int = 0):
    """(n_walks, 16, n_chunks * 256) table of independent walks, uniform in
    [-1, 1] with rows 6 and 7 at -2, drawn on `device` from a seeded
    generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rec = torch.rand((n_walks, ROWS, n_chunks * CHUNK), generator=gen,
                     device=device)
    rec.mul_(2.0).sub_(1.0)
    rec[:, 6:8] = -2.0
    return rec


def wide_alpha_table(n_walks: int, n_chunks: int, device, seed: int = 0):
    """`card_table`'s draw with rows 6 and 7 drawn so that a live cell's
    alpha spans [1/255, 0.99] (the bench table's rows at -2 cap it at
    0.25): row 7 is log2 of a uniform draw in [1/255, 0.99], row 6 uniform
    in [-1, 1]. It holds the kernel's transcendentals where log2(1 - alpha)
    is far from 0 and transmittance falls within a few records."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rec = torch.rand((n_walks, ROWS, n_chunks * CHUNK), generator=gen,
                     device=device)
    rec.mul_(2.0).sub_(1.0)
    u = torch.rand((n_walks, n_chunks * CHUNK), generator=gen, device=device)
    rec[:, 7] = torch.log2(1.0 / 255.0 + u * (0.99 - 1.0 / 255.0))
    return rec


def work(kind: str, n_walks: int, n_chunks: int, sms: int,
         clock_hz: float) -> Dict:
    """Cells, operations and bytes of one call, and its bound: the larger of
    the operations over the float32 peak and the bytes (the table read once,
    one float written per walk) over the memory rate. Beside it
    `sfu_floor_ms`: the compute variants' 3 transcendentals per cell at
    `SFU_PER_CLOCK_SM` per SM on `sms` SMs at `clock_hz` (None for dma_only,
    which has none)."""
    cells = n_walks * n_chunks * CHUNK * P
    table = n_walks * ROWS * n_chunks * CHUNK * 4
    if kind == "dma_only":
        flops = n_walks * (n_chunks * 2 * 8 * 128 + 8 * 128)
        bytes_ = table + 4 * n_walks
    else:
        flops = cells * FLOPS_PER_CELL + n_walks * (8 * P + 2 * P)
        # compute_only reads one block per walk
        bytes_ = (n_walks * ROWS * CHUNK * 4 if kind == "compute_only"
                  else table) + 4 * n_walks
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    sfu = (None if kind == "dma_only" else
           cells * TRANSCENDENTALS_PER_CELL
           / (SFU_PER_CLOCK_SM * sms * clock_hz) * 1e3)
    return dict(cells=cells, flops=flops, bytes=bytes_, table_bytes=table,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                sfu_floor_ms=sfu)


def smi_line() -> str:
    """The card's `nvidia-smi` name and power limit, as one csv line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, from `nvidia-smi --query-gpu=
    clocks.max.sm` (MHz), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def cuda_ms(fn, iters: int, warmup: int = 1):
    """(mean ms per call of `fn` over `iters` calls after `warmup` untimed
    ones, from CUDA events; what the last call returned)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, out


def rates(ms: float, w: Dict) -> Dict:
    """The reference's per-line figures for a time of `ms`."""
    return dict(ms=ms, ns_per_cell=ms * 1e6 / w["cells"],
                GB_s=w["table_bytes"] / ms / 1e6,
                bound_share=w["bound_ms"] / ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_sol")
    ap.add_argument("--small", action="store_true",
                    help="n_chunks 4 instead of 2143 (a shakeout)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "version and measures no time)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    rec_np, bigx_np = probe_inputs(args.small)
    n_chunks = rec_np.shape[1] // CHUNK
    rec = torch.as_tensor(rec_np, device=dev)
    card = smi_line() if on_card else None
    if on_card:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        clock = max_sm_clock_hz()
        walks = WALKS_PER_SM * sms
        wide = card_table(walks, n_chunks, dev)

    out = {}
    for kind in KINDS:
        parts = sol_probe(rec, kind)
        line = dict(value=float(total(parts)),
                    parts=dict(zip(PARTS[kind], parts.tolist())),
                    n_chunks=n_chunks, cells=n_chunks * CHUNK * P)
        if on_card:
            w1 = work(kind, 1, n_chunks, sms, clock)
            line.update(bound_ms=w1["bound_ms"], bound_by=w1["bound_by"],
                        sfu_floor_ms=w1["sfu_floor_ms"],
                        sm_clock_max_mhz=clock / 1e6,
                        **rates(cuda_ms(lambda: sol_probe(rec, kind),
                                        ITERS)[0], w1))
            ww = work(kind, walks, n_chunks, sms, clock)
            vals = sol_probe(wide, kind)
            line["card_wide"] = dict(
                walks=walks, table_bytes=ww["table_bytes"],
                bound_ms=ww["bound_ms"], bound_by=ww["bound_by"],
                sfu_floor_ms=ww["sfu_floor_ms"],
                finite=bool(torch.isfinite(vals).all()),
                **rates(cuda_ms(lambda: sol_probe(wide, kind), ITERS)[0],
                        ww))
            line["card"] = card
        else:
            line.update(ms="not measured", card_wide="not measured")
        out[kind] = line
        print(json.dumps({kind: line}), flush=True)

    bigx = torch.as_tensor(bigx_np, device=dev)
    line = dict(value=float(torch.exp2(bigx).sum()))
    if on_card:
        ms, _ = cuda_ms(lambda: torch.exp2(bigx).sum(), ITERS)
        line.update(ms=ms, ns_per_elem=ms * 1e6 / bigx.numel(), card=card)
    else:
        line.update(ms="not measured")
    out["exp2"] = line
    print(json.dumps({"exp2": line}), flush=True)
    print("SOL_RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
