#!/usr/bin/env python3
"""Where the tile kernels' and the probe's time goes, on one NVIDIA GPU.

    git show <commit>:dynamic3dgaussians_tpu_torch/csrc/raster_bwd.cu \\
        > build/split/parent_raster_bwd.cu  # and raster_fwd.cu, sol_probe.cu
    python3 kernel_split.py [--parent DIR] [VARIANT ...]

Builds variants of the backward (K2) and forward (K1) tile kernels and of
the probe (K3), each from a kernel source with a few named text edits
(`VARIANTS`), into its own library with nvcc (the flags of `_build.py`,
`csrc/` on the include path), and times each with CUDA events. K1 and K2
run on the tables of `chip_smoke.py` (the bench view and the stopping
table, CV 8 and 40), on the forward's outputs (from K1's plain version) and
chip_smoke's seeded cotangent; `tail_ms` times a kernel on its table with
every tile but the heaviest emptied: the least time the slowest block
needs. K3's compute variants run card-wide (4 walks per SM over the bench
shape, an 18.5 GB table on an H100), each variant's parts held against the
plain version's by chip_smoke's tolerances (`within_tol`). A variant may
compute wrong values on purpose: then only its time is read. Sources are
the current `csrc/` files and, when `--parent DIR` holds them, an earlier
commit's (`parent_raster_bwd.cu`, `parent_raster_fwd.cu`,
`parent_sol_probe.cu`): the `parent_*` edits of K1 and K2 fit their
sources before their redesign (commit 75b3285), those of K3 its source
before its redesign (commit 060e578). Prints one JSON line per (variant,
table, CV) or (variant, kind, round), then the card's nvidia-smi line.
Imports nothing of JAX.
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

# K3: the transcendentals' bodies, and stand-ins put before the staging code
EX2_ASM = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
LG2_ASM = 'asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));'
SOL_DEFS_AT = "// Stage the (ROWS, CHUNK) block at"
UNROLL = "#pragma unroll 4\n    for (int j = 0;"
# 2^x on the FMA pipes, x <= 0: x + 1.5 2^23 rounds x to the integer n in
# the low bits, 2^(x - n) (|x - n| <= 1/2) is a degree-6 Taylor polynomial
# (relative error ~1e-7), n is added to the exponent field
EX2_FMA = """__device__ __forceinline__ float ex2_fma(float x) {
  x = fmaxf(x, -126.0f);
  const float t = x + 12582912.0f;
  const float f = x - (t - 12582912.0f);
  float p = 1.5403530e-4f;
  p = fmaf(p, f, 1.3333558e-3f);
  p = fmaf(p, f, 9.6181291e-3f);
  p = fmaf(p, f, 5.5504109e-2f);
  p = fmaf(p, f, 2.4022651e-1f);
  p = fmaf(p, f, 6.9314718e-1f);
  p = fmaf(p, f, 1.0f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}
"""
# log2 x on the FMA and integer pipes: x = 2^e (1 + t), 1 + t in [0.75,
# 1.5), a degree-8 polynomial in t (Taylor's coefficients: for its time
# only, its values are off by up to ~1e-3 at the ends of the range)
LG2_FMA = """__device__ __forceinline__ float lg2_fma(float x) {
  const int bits = __float_as_int(x);
  const int e = (bits - 0x3f400000) >> 23;
  const float t = __int_as_float(bits - (e << 23)) - 1.0f;
  float p = -0.18033688f;
  p = fmaf(p, t, 0.20609929f);
  p = fmaf(p, t, -0.24044917f);
  p = fmaf(p, t, 0.28853901f);
  p = fmaf(p, t, -0.36067376f);
  p = fmaf(p, t, 0.48089835f);
  p = fmaf(p, t, -0.72134752f);
  p = fmaf(p, t, 1.44269504f);
  return fmaf(t, p, __int_as_float(e + 0x4b400000) - 12582912.0f);
}
"""
# the parent's transcendentals as single MUFU instructions, or as FMAs
PARENT_FAST = """__device__ __forceinline__ float ex2a(float x) {
  float y; asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x)); return y;
}
__device__ __forceinline__ float lg2a(float x) {
  float y; asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x)); return y;
}
"""
PARENT_FMA = """__device__ __forceinline__ float ex2a(float x) {
  return fmaf(x, 0.0625f, 1.0f);
}
__device__ __forceinline__ float lg2a(float x) {
  return fmaf(x, 0.5f, -0.5f);
}
"""
PARENT_CALLS = [("log2f(1.0f - exp2f(m))", "lg2a(1.0f - ex2a(m))"),
                ("exp2f((m + (cum - lg)) + log2t)",
                 "ex2a((m + (cum - lg)) + log2t)")]

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
        "accumulate(cell.alpha * exp2f(cum + log2t), j);",
        'float t; asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(t)'
        ' : "f"(cum + log2t)); accumulate(cell.alpha * t, j);')]),
    "fwd_sync_stage": ("fwd", "current", [(
        "col + chunk, chunk);", "col + chunk, chunk);\n"
        "      d3g::cp_async_wait_all();")]),
    # K3: the parent, and its transcendentals as MUFU ops or as FMAs
    "parent_sol": ("sol", "parent", []),
    "parent_sol_fast_transcendentals": ("sol", "parent", [
        (SOL_DEFS_AT, PARENT_FAST + SOL_DEFS_AT)] + PARENT_CALLS),
    "parent_sol_fma_transcendentals": ("sol", "parent", [
        (SOL_DEFS_AT, PARENT_FMA + SOL_DEFS_AT)] + PARENT_CALLS),
    "sol": ("sol", "current", []),
    # each design step removed on its own
    # (1 and 4 pixels per thread at the unroll that keeps them free of
    # spills: 64 registers at 256 threads, 255 at 64)
    "sol_scalar_loads": ("sol", "current", [
        ("constexpr int R = 4;", "constexpr int R = 1;"),
        (UNROLL, "#pragma unroll 16\n    for (int j = 0;")]),
    "sol_1px": ("sol", "current", [
        ("constexpr int PPT = 2;", "constexpr int PPT = 1;"),
        (UNROLL, "#pragma unroll 1\n    for (int j = 0;")]),
    "sol_4px": ("sol", "current", [
        ("constexpr int PPT = 2;", "constexpr int PPT = 4;"),
        (UNROLL, "#pragma unroll 2\n    for (int j = 0;")]),
    "sol_accurate": ("sol", "current", [(EX2_ASM, "y = exp2f(x);"),
                                        (LG2_ASM, "y = log2f(x);")]),
    "sol_accurate_lg2": ("sol", "current", [(LG2_ASM, "y = log2f(x);")]),
    # one step of 4 records per loop trip, not four
    "sol_no_unroll": ("sol", "current", [(
        UNROLL, "#pragma unroll 1\n    for (int j = 0;")]),
    # the next block's copy waited for before the walk of this one
    "sol_sync_stage": ("sol", "current", [(
        "(int64_t)(k + 1) * CHUNK, CHUNK);",
        "(int64_t)(k + 1) * CHUNK, CHUNK);\n"
        "      d3g::cp_async_wait_all();")]),
    # timing only: the transcendentals as one FMA each (wrong values)
    "sol_fma_transcendentals": ("sol", "current", [
        (EX2_ASM, "y = fmaf(x, 0.0625f, 1.0f);"),
        (LG2_ASM, "y = fmaf(x, 0.5f, -0.5f);")]),
    # one transcendental of three moved from the SFU to the FMA pipes
    "sol_fma_ex2_w": ("sol", "current", [
        (SOL_DEFS_AT, EX2_FMA + SOL_DEFS_AT),
        ("const float w = ex2(m + cum[i]);",
         "const float w = ex2_fma(m + cum[i]);")]),
    # p0 + row6 factored and contracted (4 instructions per cell for 8; its
    # gate may fall on the other side of 1/255 than the plain version's)
    "sol_factored_p0": ("sol", "current", [
        ("""        const float adx2 = __fmul_rn(__fmul_rn(a[q], dx), dx);
        const float bdx = __fmul_rn(b[q], dx);""",
         """        const float hx = fmaf(-0.5f * a[q] * dx, dx, r6[q]);
        const float nbdx = -b[q] * dx;
        const float hc = -0.5f * cc[q];"""),
        ("""          const float s = __fadd_rn(adx2, __fmul_rn(__fmul_rn(cc[q], dy), dy));
          // -s/2 is exact, so the fma rounds as (-s/2) - b dx dy does
          const float p0 = fmaf(-0.5f, s, -__fmul_rn(bdx, dy));
          float m = fminf(__fadd_rn(p0, r6[q]), r7[q]);""",
         """          float m = fminf(fmaf(dy, fmaf(hc, dy, nbdx), hx), r7[q]);""")]),
    "sol_fma_lg2": ("sol", "current", [
        (SOL_DEFS_AT, LG2_FMA + SOL_DEFS_AT),
        ("lg2(1.0f - ex2(m))", "lg2_fma(1.0f - ex2(m))")]),
}
TAIL = ("parent_bwd", "bwd", "parent_fwd", "fwd")
SOL_KINDS = ("stream_compute", "compute_only")
SOL_ITERS = 3    # timed launches per K3 variant and kind (~90-150 ms each)


def source_name(kern):
    return "sol_probe.cu" if kern == "sol" else f"raster_{kern}.cu"


def variant_source(name, parent_dir):
    kern, src, edits = VARIANTS[name]
    fname = source_name(kern)
    path = (REPO / "dynamic3dgaussians_tpu_torch" / "csrc" / fname
            if src == "current" else Path(parent_dir) / f"parent_{fname}")
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: edit {old!r} matches "
                             f"{text.count(old)} times in {path}")
        text = text.replace(old, new)
    if kern != "fwd":   # the error string lives beside the forward kernel
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


def entry_args(name, parent_dir):
    """What the variant's C entry point takes beyond the oldest sources':
    the tile-order scratch (K2), the variant int (K1: FUSED / BF16 bits;
    K2: BF16) and the device run counter."""
    text = variant_source(name, parent_dir)
    return dict(order="int* order" in text,
                variant="int variant" in text or "int bf16" in text,
                runs="unsigned long long* runs" in text)


def load(path, kern, ea):
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    o = [vp] if ea["order"] else []
    v = [i32] if ea["variant"] else []
    r = [vp] if ea["runs"] else []
    if kern == "sol":
        lib.d3g_sol_probe.argtypes = [vp, i64, i32, i32, vp, vp]
        lib.d3g_sol_probe.restype = i32
    elif kern == "fwd":
        lib.d3g_raster_fwd.argtypes = [vp, i64, i32, vp, vp, i32, i32, i32,
                                       i32, i32, *v, *o, vp, vp, vp, *r, vp]
        lib.d3g_raster_fwd.restype = i32
    else:
        lib.d3g_raster_bwd.argtypes = [vp, i64, i32, vp, vp, vp, vp, vp, i32,
                                       i32, i32, i32, i32, *v, *o, vp, *r,
                                       vp]
        lib.d3g_raster_bwd.restype = i32
    lib.d3g_error_string.argtypes = [i32]
    lib.d3g_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_split")
    ap.add_argument("--parent", default=str(REPO / "build" / "split"),
                    help="directory holding parent_raster_{bwd,fwd}.cu and "
                         "parent_sol_probe.cu")
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
    names = [n for n, v in VARIANTS.items()
             if (v[1] == "current" or (Path(args.parent) / (
                 "parent_" + source_name(v[0]))).exists())
             and (not args.variants or n in args.variants)]
    libs = build(names, args.parent, REPO / "build" / "split" / "libs")
    smi = smi_line()
    dev = torch.device("cuda")
    for name, (_, report) in libs.items():
        print(json.dumps(dict(variant=name,
                              ptxas=cs.ptxas_summary(report))), flush=True)
    sol = [n for n in names if VARIANTS[n][0] == "sol"]
    names = [n for n in names if VARIANTS[n][0] != "sol"]
    for table in cs.TABLES if names else ():
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
                ea = entry_args(name, args.parent)
                o = [order.data_ptr()] if ea["order"] else []
                v = [0] if ea["variant"] else []     # the default variant
                r = [None] if ea["runs"] else []     # no run counter
                lib = load(libs[name][0], kern, ea)
                stream = torch.cuda.current_stream().cuda_stream

                def run(cnt=counts):
                    if kern == "fwd":
                        err = lib.d3g_raster_fwd(
                            rec_t.data_ptr(), rec_t.shape[1], rec_t.shape[0],
                            starts.data_ptr(), cnt.data_ptr(),
                            kw["num_tiles"], kw["grid_w"], kw["tile_h"],
                            kw["tile_w"], kw["chunk"], *v, *o,
                            out_f[0].data_ptr(),
                            out_f[1].data_ptr(), out_f[2].data_ptr(), *r,
                            stream)
                    else:
                        err = lib.d3g_raster_bwd(
                            rec_t.data_ptr(), rec_t.shape[1], rec_t.shape[0],
                            starts.data_ptr(), cnt.data_ptr(),
                            nact.data_ptr(), log_t.data_ptr(),
                            d_raw.data_ptr(), kw["num_tiles"], kw["grid_w"],
                            kw["tile_h"], kw["tile_w"], kw["chunk"], *v, *o,
                            d_out.data_ptr(), *r, stream)
                    _build.check(lib, err, name)

                ms, _ = cuda_ms(run, iters=args.iters, warmup=2)
                line = dict(variant=name, table=table, cv=rec_t.shape[0] - 8,
                            ms=ms, card=smi)
                if name in TAIL:
                    line["tail_ms"], _ = cuda_ms(lambda: run(tail_counts),
                                                 iters=args.iters, warmup=2)
                    line["tail_tile_records"] = int(walked[heavy])
                print(json.dumps(line), flush=True)
    if sol:
        time_sol(sol, libs, SOL_ITERS, smi, dev)
    print(smi, flush=True)
    return 0


def time_sol(names, libs, iters, smi, dev, rounds=2):
    """Each K3 variant's compute kinds card-wide: 4 walks per SM over the
    bench shape, `card_table`'s draw; ms, ns per cell, the share of the
    bound and of the SFU floor, and whether its parts are within
    chip_smoke's tolerances of the plain version's. The variants are timed
    in turn, `rounds` times over, so that a drift of the card's clock
    shows as a spread between rounds and not as a difference between
    variants. With each time stand the SM clock and the power draw that
    `nvidia-smi` reads while 8 more launches run."""
    import torch

    import chip_smoke as cs
    from dynamic3dgaussians_tpu_torch import _build
    from dynamic3dgaussians_tpu_torch.ops.cuda.sol_probe import (
        KINDS, sol_probe_torch)
    from dynamic3dgaussians_tpu_torch.tools import bench_sol as B

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = B.max_sm_clock_hz()
    walks = B.WALKS_PER_SM * sms
    rec = B.card_table(walks, B.N_CHUNKS, dev)
    out = torch.empty((walks, 2), dtype=torch.float32, device=dev)
    for kind, rnd in ((k, r) for k in SOL_KINDS for r in range(rounds)):
        if rnd == 0:
            plain = sol_probe_torch(rec, kind)
            w = B.work(kind, walks, B.N_CHUNKS, sms, clock)
        for name in names:
            lib = load(libs[name][0], "sol", False)
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                _build.check(lib, lib.d3g_sol_probe(
                    rec.data_ptr(), rec.shape[2], walks, KINDS.index(kind),
                    out.data_ptr(), stream), name)
                return out

            ms, got = B.cuda_ms(run, iters=iters, warmup=1)
            errs, bad = cs.k3_errors(got, plain, kind)
            for _ in range(8):      # ~1 s of launches queued, then a sample
                run()
            clock_mhz, power = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], check=True,
                capture_output=True, text=True).stdout.split(",")[:2]
            torch.cuda.synchronize()
            print(json.dumps(dict(
                variant=name, kind=kind, round=rnd, walks=walks, ms=ms,
                ns_per_cell=ms * 1e6 / w["cells"],
                bound_share=w["bound_ms"] / ms,
                sfu_floor_ms=w["sfu_floor_ms"],
                sfu_floor_share=w["sfu_floor_ms"] / ms,
                sm_clock_max_mhz=clock / 1e6,
                sm_clock_mhz_under_load=float(clock_mhz),
                power_w_under_load=float(power), within_tol=not bad,
                err_rel={n: e["err_rel"] for n, e in errs.items()},
                card=smi)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
