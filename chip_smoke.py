#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each a plain function that the CPU tests also call at a tiny size:

1. card: the device's name and count, and nvidia-smi's name and power limit;
2. build: compile every CUDA source of the path and print ptxas's registers,
   shared memory and spills;
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the main path's shape, the north-star width and a ragged shape, then
   time kernel, plain version and a library yardstick with CUDA events;
4. main path: fit PCA (500,000 x 512, k=50, precision "high", 8 partitions)
   through the kernel, check it against the f64 host oracle and a
   "highest" fit, transform every row and check the projection.

The last lines are one JSON object with every kernel's numbers, the card's
nvidia-smi line, and {"ok": true, "device": {...}}. Without a card the script
exits nonzero and prints no result. Every failed check raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import PCA
from spark_rapids_ml_tpu_torch.ops import _build
from spark_rapids_ml_tpu_torch.ops import gram_moments as G
from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.utils import columnar

# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

MAIN_SHAPE = (65_536, 512)  # one partition of the main path's fit
KERNEL_SHAPES = (MAIN_SHAPE, (131_072, 2_048), (1_000, 300))
MAIN_ROWS, MAIN_N, MAIN_K, MAIN_PARTITIONS = 500_000, 512, 50, 8
TIMED_LAUNCHES = 20
COSINE_BAR = 0.9999

KERNELS = {
    "gram_moments": {
        "route": "cuda",
        "source": "spark_rapids_ml_tpu_torch/csrc/gram_moments.cu",
        "replaces": "spark_rapids_ml_tpu/ops/pallas_gram.py:199",
    },
}


def bench_workload(rows: int, n: int, seed: int = 7) -> np.ndarray:
    """The bench's correlated-spectrum data: a rank-64 mix plus 0.1 noise,
    f32. Its eigenvalues are well separated, so components compare."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(rows, 64)).astype(np.float32)
    mix = rng.normal(size=(64, n)).astype(np.float32)
    return base @ mix + 0.1 * rng.normal(size=(rows, n)).astype(np.float32)


def gram_bound(rows: int, n: int) -> tuple[float, str]:
    """Least time (ms) an H100 needs for the kernel's work, and what bounds
    it. The Gram hiᵀhi + hiᵀlo + loᵀhi is symmetric: its least work is the
    upper triangle of hiᵀhi and all of hiᵀlo (loᵀhi is its transpose),
    rows·n·(3n+1) bf16 operations, against X read once and the three outputs
    written once."""
    ops_ms = float(rows) * n * (3 * n + 1) / PEAK_BF16_FLOPS * 1e3
    bytes_ms = 4.0 * (rows * n + n * n + 2 * n) / PEAK_HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
    }
    print(f"card: {card['kind']} x{card['count']} | nvidia-smi: {smi}", flush=True)
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build(list(KERNELS))
    print(f"build: {sorted(KERNELS)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}", flush=True)


def _exact_split_gram(x: torch.Tensor) -> torch.Tensor:
    """hiᵀhi + hiᵀlo + loᵀhi summed in f64: the split's gram without the
    f32 summation error either side carries."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    hd, ld = hi.double(), lo.double()
    return hd.T @ hd + hd.T @ ld + ld.T @ hd


def phase_kernel_check(shapes, device: torch.device, seed: int = 0) -> dict:
    """Kernel (through its wrapper) against its plain version on the same
    inputs. Both sides form exact bf16×bf16 products, so they differ only in
    the f32 summation order: gram within 1e-5·max|G|, moments within
    rtol 1e-5 and 1e-5·√rows·max|x|. The kernel's gram is also held to the
    same 1e-5·max|G| against the split summed in f64."""
    gen = torch.Generator(device=device).manual_seed(seed)
    results = {}
    for rows, n in shapes:
        x = torch.randn((rows, n), generator=gen, device=device, dtype=torch.float32)
        g, cs, sq = G.fused_gram_moments(x)
        rg, rcs, rsq = G.fused_gram_moments_reference(x)
        exact = _exact_split_gram(x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        gram_err = (g - rg).abs().max().item()
        gram_tol = 1e-5 * rg.abs().max().item()
        exact_err = (g.double() - exact).abs().max().item()
        plain_exact_err = (rg.double() - exact).abs().max().item()
        mom_atol = 1e-5 * rows ** 0.5 * x.abs().max().item()
        mom_excess = max(
            ((a - b).abs() - (mom_atol + 1e-5 * b.abs())).max().item()
            for a, b in ((cs, rcs), (sq, rsq))
        )
        entry = {
            "shape": [rows, n],
            "max_abs_err": gram_err,
            "tol": gram_tol,
            "max_abs_err_vs_f64": exact_err,
            "plain_max_abs_err_vs_f64": plain_exact_err,
            "moments_max_abs_err": max(
                (cs - rcs).abs().max().item(), (sq - rsq).abs().max().item()
            ),
            "moments_atol": mom_atol,
        }
        print(f"kernel check: gram_moments {rows}x{n}: {json.dumps(entry)}", flush=True)
        if not (gram_err <= gram_tol and exact_err <= gram_tol and mom_excess <= 0.0):
            raise AssertionError(f"gram_moments disagrees with its plain version: {entry}")
        results[(rows, n)] = entry
        del x, g, cs, sq, rg, rcs, rsq, exact
    return results


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_timing(shapes, device: torch.device, seed: int = 1) -> dict:
    """kernel_ms, plain_ms and library_ms (f32 ``x.T @ x``, a yardstick the
    port never calls) over TIMED_LAUNCHES launches after a warm-up."""
    gen = torch.Generator(device=device).manual_seed(seed)
    results = {}
    for rows, n in shapes:
        x = torch.randn((rows, n), generator=gen, device=device, dtype=torch.float32)
        bound_ms, bound_by = gram_bound(rows, n)
        entry = {
            "kernel_ms": _time_ms(lambda: G.fused_gram_moments(x), TIMED_LAUNCHES),
            "plain_ms": _time_ms(lambda: G.fused_gram_moments_reference(x), TIMED_LAUNCHES),
            "library_ms": _time_ms(lambda: x.T @ x, TIMED_LAUNCHES),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        print(f"kernel timing: gram_moments {rows}x{n}: {json.dumps(entry)}", flush=True)
        results[(rows, n)] = entry
        del x
    return results


def _min_abs_cosine(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    cos = np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))
    return float(cos.min())


def explained_variance_f64(x: np.ndarray, k: int) -> np.ndarray:
    """The reference's explainedVariance (sᵢ/Σs over the full spectrum,
    s = √λ of the uncentered scatter) computed in f64 on the host."""
    xa = np.asarray(x, dtype=np.float64)
    evals = np.linalg.eigvalsh(xa.T @ xa)[::-1]
    s = np.sqrt(np.clip(evals, 0.0, None))
    return s[:k] / s.sum()


def explained_variance_high_with_lolo(
    x: np.ndarray, k: int, partitions: int, device: torch.device
) -> np.ndarray:
    """explainedVariance of the "high" fit's path with the dropped loᵀlo term
    added back to each partition's Gram: the fit at "high" differs from it
    in that term alone."""
    total = None
    for part in np.array_split(x, partitions):
        padded, _ = columnar.pad_rows(part)
        xt = torch.from_numpy(padded).to(device)
        stats = L.gram_stats(xt, precision="high")
        hi = xt.to(torch.bfloat16)
        lo = (xt - hi.float()).to(torch.bfloat16).float()
        stats = L.GramStats(stats.xtx + lo.T @ lo, stats.col_sum, stats.count)
        total = stats if total is None else L.combine_gram_stats(total, stats)
    cov = L.covariance_from_stats(total, mean_centering=False)
    return L.pca_fit_from_cov(cov, k)[1].cpu().numpy()


def phase_main_path(rows: int, n: int, k: int, partitions: int, device: torch.device) -> dict:
    """Fit at "high" and transform through the port's public API; the
    kernel's launch count is read from 0 around exactly this run."""
    x = bench_workload(rows, n)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    pca = PCA(device=device).setInputCol("features").setK(k).setPrecision("high")
    # warm-up on a slice, so that neither timed fit pays the cuBLAS and
    # cuSOLVER handles' first-use set-up
    pca.fit(x[: 4 * n])
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    G.launches = 0
    t0 = time.perf_counter()
    model = pca.fit(x, num_partitions=partitions)
    sync()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(x)
    sync()
    transform_s = time.perf_counter() - t0
    launches = G.launches

    expected = partitions if cuda else 0
    if launches != expected:
        raise AssertionError(
            f"gram_moments launched {launches} times in the fit, expected {expected}"
        )
    min_cos = L.min_cosine_vs_f64_oracle(x, model.pc, k)
    if not min_cos >= COSINE_BAR:
        raise AssertionError(f"min cosine vs the f64 oracle {min_cos} < {COSINE_BAR}")

    t0 = time.perf_counter()
    highest = PCA(device=device).setK(k).setPrecision("highest").fit(
        x, num_partitions=partitions
    )
    sync()
    fit_highest_s = time.perf_counter() - t0
    cos_vs_highest = _min_abs_cosine(model.pc, highest.pc)
    if not cos_vs_highest >= COSINE_BAR:
        raise AssertionError(f"'high' vs 'highest' min cosine {cos_vs_highest} < {COSINE_BAR}")
    # "highest" (f32 products) must give the f64 oracle's explainedVariance.
    # "high" drops loᵀlo, ~2⁻¹⁹·⁶ of each diagonal element of XᵀX, which
    # lowers every noise-floor eigenvalue; explainedVariance divides by Σ√λ
    # over the full spectrum (448 of 512 values are that floor here), so all
    # its ratios shift together: rtol 1e-3 between tiers. That the shift is
    # this term's is checked: with loᵀlo added back the gap is within 1e-4.
    ev_oracle = explained_variance_f64(x, k)
    np.testing.assert_allclose(highest.explainedVariance, ev_oracle, rtol=1e-4)
    np.testing.assert_allclose(model.explainedVariance, highest.explainedVariance, rtol=1e-3)
    ev_rel = np.abs(model.explainedVariance / highest.explainedVariance - 1).max()
    ev_lolo = explained_variance_high_with_lolo(x, k, partitions, device)
    np.testing.assert_allclose(ev_lolo, highest.explainedVariance, rtol=1e-4)
    ev_lolo_rel = np.abs(ev_lolo / highest.explainedVariance - 1).max()

    if out.shape != (rows, k) or not np.isfinite(out).all():
        raise AssertionError(f"transform gave shape {out.shape} or non-finite values")
    ref = x.astype(np.float64) @ model.pc.astype(np.float64)
    proj_err = float(np.abs(out - ref).max())
    proj_tol = 1e-4 * float(np.abs(ref).max())
    if not proj_err <= proj_tol:
        raise AssertionError(f"transform error {proj_err} > {proj_tol}")

    result = {
        "rows": rows, "n": n, "k": k, "partitions": partitions,
        "launches": {"gram_moments": launches},
        "min_cosine_vs_f64_oracle": min_cos,
        "min_cosine_high_vs_highest": cos_vs_highest,
        "explained_variance_rel_diff_high_vs_highest": float(ev_rel),
        "explained_variance_rel_diff_high_with_lolo_vs_highest": float(ev_lolo_rel),
        "explained_variance_rel_diff_highest_vs_f64": float(
            np.abs(highest.explainedVariance / ev_oracle - 1).max()
        ),
        "transform_max_abs_err": proj_err,
        "transform_tol": proj_tol,
        "fit_s": fit_s,
        "fit_highest_s": fit_highest_s,
        "transform_s": transform_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device) if cuda else None,
    }
    print(f"main path: {json.dumps(result)}", flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)

    card = phase_card()
    phase_build()
    checks = phase_kernel_check(KERNEL_SHAPES, device)
    timings = phase_kernel_timing(KERNEL_SHAPES, device)
    main_path = phase_main_path(MAIN_ROWS, MAIN_N, MAIN_K, MAIN_PARTITIONS, device)

    kernels = []
    for name, meta in KERNELS.items():
        at_main = {**checks[MAIN_SHAPE], **timings[MAIN_SHAPE]}
        kernels.append({
            "name": name,
            **meta,
            "launches": main_path["launches"][name],
            "max_abs_err": at_main["max_abs_err"],
            "tol": at_main["tol"],
            "ms": at_main["kernel_ms"],
            "kernel_ms": at_main["kernel_ms"],
            "plain_ms": at_main["plain_ms"],
            "bound_ms": at_main["bound_ms"],
            "bound_by": at_main["bound_by"],
            "library_ms": at_main["library_ms"],
            "shapes": [{**checks[s], **timings[s]} for s in KERNEL_SHAPES],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
