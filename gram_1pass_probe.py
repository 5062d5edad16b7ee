#!/usr/bin/env python3
"""Diagnostics of the one-product Gram kernel on one CUDA card.

    python3 gram_1pass_probe.py [--parts sweep,worklist,variants,host]

Builds ``csrc/gram_moments.cu`` as ``chip_smoke.py`` does and prints one
JSON line per measurement (the card's name and power limit first):

- ``sweep``: at 131,072 × 512 and 131,072 × 2,048, the Gram's largest error
  against the f64 sum of the exact bf16 products, over max|G|, and the
  kernel time, for promotion intervals (``gram_moments.PROMOTE_STEPS``) of
  1 to 64 steps of 64 rows;
- ``worklist``: each kernel's device time (``torch.profiler``) with the
  row-part work list (``gram_moments.schedule_1pass``) and with contiguous
  shares of the tile-major line at the same 64-row steps, the cut the
  three-product kernels use;
- ``variants``: the same for copies of the source whose Gram pass leaves out
  its wgmmas (the TMA loads alone) or its TMA loads (the wgmmas on whatever
  the ring holds), built into ``build/gram_1pass_probe/``;
- ``host``: the shapes where a call is host-bound, each one-product wrapper
  against the three-product ones, in turns, 500 launches each.

It needs a card and exits with 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as C
from spark_rapids_ml_tpu_torch.ops import _build
from spark_rapids_ml_tpu_torch.ops import gram_moments as G

PARTS = ("sweep", "worklist", "variants", "host")
SHAPES = ((65_536, 512), (131_072, 2_048))
KERNELS = ("bf16_moments_kernel", "gram_1pass_kernel", "gram_1pass_reduce_kernel",
           "gram_partial_kernel", "gram_reduce_kernel")


def emit(kind: str, **fields) -> None:
    print(json.dumps({"probe": kind, **fields}), flush=True)


def contiguous_shares(rows: int, n: int, sm_count: int) -> G.Schedule1Pass:
    """The upper tiles' line of (tile, 64-row step) pairs cut into one equal
    share a block, as ``gram_moments.schedule`` cuts it for the three-product
    kernels: each block starts at another row."""
    pairs = G.tile_pairs(n, True)
    steps = -(-rows // G.STEP_1PASS)
    total = len(pairs) * steps
    blocks = min(sm_count, total)
    items, block_items = [], [0]
    for b in range(blocks):
        pos, end = b * total // blocks, (b + 1) * total // blocks
        while pos < end:
            t, s0 = divmod(pos, steps)
            s1 = min(steps, s0 + end - pos)
            items.append((*pairs[t], s0, s1))
            pos += s1 - s0
        block_items.append(len(items))
    tiles, it = [], 0
    for pair in pairs:
        begin = it
        while it < len(items) and items[it][:2] == pair:
            it += 1
        tiles.append((*pair, begin, it))
    return G.Schedule1Pass(np.asarray(items, np.int32).reshape(-1, 4),
                           np.asarray(tiles, np.int32).reshape(-1, 4),
                           np.asarray(block_items, np.int32),
                           np.arange(len(items), dtype=np.int32))


def device_us(call, reps: int = 10) -> dict:
    """Each kernel's mean device time (us) over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        for name in KERNELS:
            if name in event.key:
                out[name] = getattr(event, "device_time", None) or event.cuda_time
    return out


def part_sweep(device: torch.device) -> None:
    gen = torch.Generator(device=device).manual_seed(3)
    default = G.PROMOTE_STEPS
    try:
        for n in (512, 2_048):
            x = torch.randn((131_072, n), generator=gen, device=device)
            hd = x.to(torch.bfloat16).double()
            exact = hd.T @ hd
            scale = exact.abs().max().item()
            for steps in (1, 2, 4, 8, 16, 32, 64):
                G.PROMOTE_STEPS = steps
                g = G.symmetric_gram_moments(x, products=1)[0]
                torch.cuda.synchronize()
                emit("sweep", shape=[131_072, n], promote_steps=steps,
                     rel_err_vs_f64=(g.double() - exact).abs().max().item() / scale,
                     kernel_ms=C._time_ms(lambda: G.symmetric_gram_moments(x, products=1),
                                          C.TIMED_LAUNCHES))
            del x, hd, exact
            torch.cuda.empty_cache()
    finally:
        G.PROMOTE_STEPS = default


def _with_schedule(make, fn):
    saved = G.schedule_1pass
    G.schedule_1pass = make
    G._device_tables.cache_clear()
    try:
        return fn()
    finally:
        G.schedule_1pass = saved
        G._device_tables.cache_clear()


def part_worklist(device: torch.device) -> None:
    gen = torch.Generator(device=device).manual_seed(5)
    for rows, n in SHAPES:
        x = torch.randn((rows, n), generator=gen, device=device)
        for name, make in (("row_parts", G.schedule_1pass), ("contiguous", contiguous_shares)):
            us = _with_schedule(make, lambda: device_us(
                lambda: G.symmetric_gram_moments(x, products=1)))
            emit("worklist", shape=[rows, n], work_list=name, device_us=us)
        del x


def _variant_sources() -> dict[str, str]:
    src = (_build.CSRC_DIR / "gram_moments.cu").read_text()
    mma = src[src.index("        wgmma_fence();\n#pragma unroll\n        for (int kk = 0; kk < k1Step"):]
    mma = mma[:mma.index("        wgmma_commit();")]
    tma = src[src.index("        mbar_arrive_expect_tx(full, diag ? k1Panel : k1Stage);"):]
    tma = tma[:tma.index("      }\n    }\n  } else {\n    // ---- consumer warpgroups")]
    return {
        "kernel": src,
        "no_wgmma": src.replace(mma, "        wgmma_fence();\n"),
        "no_tma": src.replace(tma, "        mbar_arrive(full);\n"),
    }


def part_variants(device: torch.device) -> None:
    out_dir = _build.BUILD_DIR.parent / "gram_1pass_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in _variant_sources().items():
        (out_dir / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(out_dir / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    launches = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).gram_moments_1pass_launch
        fn.argtypes, fn.restype = G._ARGTYPES["one"], ctypes.c_int
        launches[name] = fn
    gen = torch.Generator(device=device).manual_seed(5)
    for rows, n in SHAPES:
        x = torch.randn((rows, n), generator=gen, device=device)
        for name, fn in launches.items():
            emit("variant", shape=[rows, n], variant=name,
                 device_us=device_us(lambda: G._launch_1pass(fn, name, x)))
        del x


def part_host(device: torch.device) -> None:
    gen = torch.Generator(device=device).manual_seed(9)
    names = ("gram_moments", "gram_moments_1pass", "symmetric_gram_moments_1pass",
             "symmetric_gram_moments")
    for rows, n in ((1_000, 300), (65_536, 129)):
        x = torch.randn((rows, n), generator=gen, device=device)
        times = {name: [] for name in names}
        for _ in range(3):
            for name in names:
                wrapper = C.FUNCTIONS[name][0]
                times[name].append(C._time_ms(lambda: wrapper(x), 500))
        emit("host", shape=[rows, n], kernel_ms=times)
        for name in ("gram_moments", "gram_moments_1pass"):
            wrapper = C.FUNCTIONS[name][0]
            emit("host_device", shape=[rows, n], kernel=name,
                 device_us=device_us(lambda: wrapper(x), 50))
        del x


def main(argv=()) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parts", default=",".join(PARTS))
    parts = [p for p in parser.parse_args(list(argv)).parts.split(",") if p]
    unknown = set(parts) - set(PARTS)
    if unknown:
        parser.error(f"unknown parts {sorted(unknown)}; choose from {PARTS}")
    if not torch.cuda.is_available():
        print("gram_1pass_probe: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    C.phase_card()
    _build.build(["gram_moments"])
    for part in parts:
        globals()[f"part_{part}"](device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
