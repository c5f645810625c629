#!/usr/bin/env python3
"""Where the tile kernels' time goes, on one NVIDIA GPU.

    git show <commit>:dynamic3dgaussians_tpu_torch/csrc/raster_bwd.cu \\
        > build/split/parent_raster_bwd.cu        # and raster_fwd.cu
    python3 kernel_split.py [--parent DIR] [VARIANT ...]

Builds variants of the backward (K2) and forward (K1) tile kernels, each
from a kernel source with a few named text edits (`VARIANTS`), into its own
library with nvcc (the flags of `_build.py`, `csrc/` on the include path),
and times each with CUDA events on the tables of `chip_smoke.py` (the bench
view and the stopping table, CV 8 and 40), on the forward's outputs (from
K1's plain version) and chip_smoke's seeded cotangent. A variant computes
wrong values on purpose: only its time is read. Sources are the current
`csrc/` files and, when `--parent DIR` holds them, an earlier commit's
(`parent_raster_bwd.cu`, `parent_raster_fwd.cu`). `tail_ms` times a kernel
on its table with every tile but the heaviest emptied: the least time the
slowest block needs.
Prints one JSON line per (variant, table, CV), then the card's nvidia-smi
line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

ALPHA_SINK = 'asm volatile("" ::"f"(cell.alpha));'

# name: (kernel, source, [(old text, new text), ...]); every edit must apply
VARIANTS = {
    "parent_bwd": ("bwd", "parent", []),
    # the per-term shuffle trees gone (lane 0 keeps its own term)
    "parent_bwd_no_reduce": ("bwd", "parent", [(
        "#pragma unroll\n  for (int off = 16; off > 0; off >>= 1)\n"
        "    v += __shfl_down_sync(FULL_MASK, v, off);\n", "")]),
    # the alpha chain and gate of every walked cell, nothing after it
    "parent_bwd_alpha_only": ("bwd", "parent", [(
        "const bool live = d3g::alpha_live(cell);",
        "const bool live = d3g::alpha_live(cell);" + ALPHA_SINK
        + " if (j >= 0) continue;")]),
    # staging, barriers and the sums over warps; no record is walked
    "parent_bwd_stage_only": ("bwd", "parent", [(
        "for (int j = jb_end - 1; j >= jb0; --j) {",
        "for (int j = jb_end - 1; j >= jb0 && nact < 0; --j) {")]),
    "bwd": ("bwd", "current", []),
    "bwd_no_cull": ("bwd", "current", [(
        "d3g::box_hits(d3g::load_box(bx, chunk, jj), rect)", "true")]),
    "bwd_sync_stage": ("bwd", "current", [(
        "col - chunk, chunk);", "col - chunk, chunk);\n"
        "      d3g::cp_async_wait_all();")]),
    # the reduce-scatter's shuffles gone (its selects and adds stay)
    "bwd_no_shuffle": ("bwd", "current", [
        ("__shfl_xor_sync(FULL_MASK, send, 16)", "send"),
        ("__shfl_xor_sync(FULL_MASK, send, 8)", "send"),
        ("__shfl_xor_sync(FULL_MASK, send, 4)", "send"),
        ("s += __shfl_xor_sync(FULL_MASK, s, 2);", ""),
        ("s += __shfl_xor_sync(FULL_MASK, s, 1);", "")]),
    "bwd_alpha_only": ("bwd", "current", [(
        "const bool live = d3g::alpha_live(cell);",
        "const bool live = d3g::alpha_live(cell);" + ALPHA_SINK
        + " if (j >= 0) return false;")]),
    # timing only: the word barriers gone (a race: wrong sums)
    "bwd_no_word_sync": ("bwd", "current", [
        ("__syncthreads();  // every warp's partials of this word are in", ""),
        ("__syncthreads();  // the partials are read before the next word",
         "")]),
    "bwd_fast_exp": ("bwd", "current", [(
        "const float T = exp2f(logt);",
        'float T; asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(T) : "f"(logt));')]),
    # the IEEE division this change replaced
    "bwd_ieee_div": ("bwd", "current", [(
        "__fdividef(suffix, one_m)", "suffix / one_m")]),
    "parent_fwd": ("fwd", "parent", []),
    "fwd": ("fwd", "current", []),
    "fwd_no_cull": ("fwd", "current", [(
        "d3g::box_hits(d3g::load_box(bx, chunk, jj), rect)", "true")]),
    "fwd_fast_exp": ("fwd", "current", [(
        "const float w = cell.alpha * exp2f(cum + log2t);",
        'float t; asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(t)'
        ' : "f"(cum + log2t)); const float w = cell.alpha * t;')]),
    "fwd_sync_stage": ("fwd", "current", [(
        "col + chunk, chunk);", "col + chunk, chunk);\n"
        "      d3g::cp_async_wait_all();")]),
}
TAIL = ("parent_bwd", "bwd", "parent_fwd", "fwd")


def variant_source(name, parent_dir):
    kern, src, edits = VARIANTS[name]
    fname = f"raster_{kern}.cu"
    path = (REPO / "dynamic3dgaussians_tpu_torch" / "csrc" / fname
            if src == "current" else Path(parent_dir) / f"parent_{fname}")
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: edit {old!r} matches "
                             f"{text.count(old)} times in {path}")
        text = text.replace(old, new)
    if kern == "bwd":   # the error string lives beside the forward kernel
        text += ('\nextern "C" const char* d3g_error_string(int err) '
                 '{ return cudaGetErrorString((cudaError_t)err); }\n')
    return text


def build(names, parent_dir, out_dir):
    """{name: (library path, ptxas report)}, nvcc started for all at once."""
    from dynamic3dgaussians_tpu_torch import _build
    nvcc = _build.find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(name, parent_dir))
        lib = out_dir / f"lib{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-I",
               str(_build.CSRC_DIR), str(cu), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    out, failed = {}, []
    for name, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name} failed:\n{report}")
        out[name] = (lib, report)
    if failed:
        raise SystemExit("\n".join(failed))
    return out


def takes_order(name, parent_dir):
    """Whether the variant's C entry point takes the tile-order scratch
    (sources from this change on do)."""
    return "int* order" in variant_source(name, parent_dir)


def load(path, kern, order):
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    o = [vp] if order else []
    if kern == "fwd":
        lib.d3g_raster_fwd.argtypes = [vp, i64, i32, vp, vp, i32, i32, i32,
                                       i32, i32, *o, vp, vp, vp, vp]
        lib.d3g_raster_fwd.restype = i32
    else:
        lib.d3g_raster_bwd.argtypes = [vp, i64, i32, vp, vp, vp, vp, vp, i32,
                                       i32, i32, i32, i32, *o, vp, vp]
        lib.d3g_raster_bwd.restype = i32
    lib.d3g_error_string.argtypes = [i32]
    lib.d3g_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_split")
    ap.add_argument("--parent", default=str(REPO / "build" / "split"),
                    help="directory holding parent_raster_{bwd,fwd}.cu")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("variants", nargs="*", help="names of VARIANTS to time "
                    "(default: every one whose source is present)")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from dynamic3dgaussians_tpu_torch import _build
    from dynamic3dgaussians_tpu_torch.ops.cuda.raster_fwd import \
        composite_tiles_torch
    from dynamic3dgaussians_tpu_torch.tools.bench_sol import cuda_ms, smi_line

    if not torch.cuda.is_available():
        print("kernel_split: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    have_parent = all((Path(args.parent) / f"parent_raster_{k}.cu").exists()
                      for k in ("bwd", "fwd"))
    names = [n for n, v in VARIANTS.items()
             if (v[1] == "current" or have_parent)
             and (not args.variants or n in args.variants)]
    libs = build(names, args.parent, REPO / "build" / "split" / "libs")
    smi = smi_line()
    dev = torch.device("cuda")
    for name, (_, report) in libs.items():
        print(json.dumps(dict(variant=name,
                              ptxas=cs.ptxas_summary(report))), flush=True)
    for table in cs.TABLES:
        make, k_slots = cs.TABLES[table]
        for extra in ("seg_colors", "feats"):
            rec_t, starts, counts, _, kw = cs.bench_records(
                make(), extra, dev, k=k_slots)
            raw, log_t, nact = composite_tiles_torch(rec_t, starts, counts,
                                                   **kw)
            d_raw = torch.as_tensor(np.random.RandomState(3).normal(
                size=tuple(raw.shape)).astype(np.float32), device=dev)
            nact = nact.reshape(-1).contiguous()
            walked = torch.minimum(counts.long(),
                                   nact.long() * kw["chunk"]
                                   - starts.long() % kw["chunk"])
            heavy = int(torch.argmax(walked))
            tail_counts = torch.zeros_like(counts)
            tail_counts[heavy] = counts[heavy]
            out_f = [torch.empty_like(raw), torch.empty_like(log_t),
                     torch.empty_like(nact)]
            d_out = torch.zeros_like(rec_t)
            order = torch.empty_like(counts)
            for name in names:
                kern = VARIANTS[name][0]
                has_order = takes_order(name, args.parent)
                o = [order.data_ptr()] if has_order else []
                lib = load(libs[name][0], kern, has_order)
                stream = torch.cuda.current_stream().cuda_stream

                def run(cnt=counts):
                    if kern == "fwd":
                        err = lib.d3g_raster_fwd(
                            rec_t.data_ptr(), rec_t.shape[1], rec_t.shape[0],
                            starts.data_ptr(), cnt.data_ptr(),
                            kw["num_tiles"], kw["grid_w"], kw["tile_h"],
                            kw["tile_w"], kw["chunk"], *o,
                            out_f[0].data_ptr(),
                            out_f[1].data_ptr(), out_f[2].data_ptr(), stream)
                    else:
                        err = lib.d3g_raster_bwd(
                            rec_t.data_ptr(), rec_t.shape[1], rec_t.shape[0],
                            starts.data_ptr(), cnt.data_ptr(),
                            nact.data_ptr(), log_t.data_ptr(),
                            d_raw.data_ptr(), kw["num_tiles"], kw["grid_w"],
                            kw["tile_h"], kw["tile_w"], kw["chunk"], *o,
                            d_out.data_ptr(), stream)
                    _build.check(lib, err, name)

                ms, _ = cuda_ms(run, iters=args.iters, warmup=2)
                line = dict(variant=name, table=table, cv=rec_t.shape[0] - 8,
                            ms=ms, card=smi)
                if name in TAIL:
                    line["tail_ms"], _ = cuda_ms(lambda: run(tail_counts),
                                                 iters=args.iters, warmup=2)
                    line["tail_tile_records"] = int(walked[heavy])
                print(json.dumps(line), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
