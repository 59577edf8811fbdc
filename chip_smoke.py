#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cellseg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `cellseg_tpu_torch/csrc/`, checks each
against its plain PyTorch version, and drives the port's main path once:
the trained 3-class UNet predictor (normalize -> sliding-window forward ->
softmax -> CC decode) on a 2048x2048 synthetic slide. Every phase raises
on failure. Output, in order: the card and toolchain, per-kernel checks
and times, the labyrinth labeling, the forward parity, the main path's
stage times, kernel launch counts and a profile of each stage, then
one JSON line of per-kernel numbers, the card's name and power limit,
and the `ok` line last.

Needs one CUDA device and the repository beside this file; exits nonzero
without either. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "assets", "bench_unet_3class.ckpt")
INF = 2**31 - 1

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, and the
# non-tensor-core 32-bit rate, used here for the int32 min/select work
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

TPU_KERNELS = {
    "row_segmented_min_scan": "cellseg_tpu/ops/pallas/scans.py:136",
    "col_segmented_min_scan": "cellseg_tpu/ops/pallas/scans.py:157",
    "fused_sweeps": "cellseg_tpu/ops/pallas/sweeps.py:93",
}
SOURCES = {
    "row_segmented_min_scan": "cellseg_tpu_torch/csrc/scans.cu",
    "col_segmented_min_scan": "cellseg_tpu_torch/csrc/scans.cu",
    "fused_sweeps": "cellseg_tpu_torch/csrc/sweeps.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def make_slide(H: int = 2048, W: int = 2048, n_cells: int = 2000,
               seed: int = 0) -> np.ndarray:
    """Synthetic whole-slide surrogate: ~n_cells bright disks on a noisy
    background (the workload of the JAX package's bench.py)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img_f = rng.normal(30, 8, (H, W))
    cy = rng.integers(10, H - 10, n_cells)
    cx = rng.integers(10, W - 10, n_cells)
    r = rng.integers(6, 22, n_cells)
    for i in range(n_cells):
        y0, y1 = max(cy[i] - r[i], 0), min(cy[i] + r[i] + 1, H)
        x0, x1 = max(cx[i] - r[i], 0), min(cx[i] + r[i] + 1, W)
        d2 = (yy[y0:y1, x0:x1] - cy[i]) ** 2 + (xx[y0:y1, x0:x1] - cx[i]) ** 2
        inside = d2 <= r[i] ** 2
        img_f[y0:y1, x0:x1] = np.maximum(
            img_f[y0:y1, x0:x1], np.where(inside, 180.0, 0.0))
    return np.clip(img_f, 0, 255).astype(np.uint8)


def make_labyrinth(n: int = 1024, seed: int = 0) -> np.ndarray:
    """Top half: one serpentine corridor (2-px corridors, 2-px walls,
    joined at alternating ends), which needs about one propagation
    iteration per corridor. Bottom half: random speckle, where 4- and
    8-connectivity differ."""
    mask = np.zeros((n, n), bool)
    half = n // 2
    rows = list(range(0, half - 1, 4))
    for k, r in enumerate(rows):
        mask[r:r + 2, 1:n - 1] = True
        if k + 1 < len(rows):
            c = n - 2 if k % 2 == 0 else 1
            mask[r + 2:r + 4, c] = True
    rng = np.random.default_rng(seed)
    mask[half:] = rng.random((n - half, n)) < 0.45
    return mask


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_setup():
    import torch

    from cellseg_tpu_torch.kernels import build

    card = card_line()
    log(f"[1] card: {card}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    log(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, nvcc "
        f"{nvcc.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    took = build.build_all()
    log(f"[1] built {sorted(took)} in parallel: "
        f"{time.perf_counter() - t0:.2f} s wall "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in sorted(took.items()))})")
    return card


def phase_kernels(dev):
    """Every kernel bit-equal to its plain version; times at 2176^2."""
    import torch

    from cellseg_tpu_torch.ops.kernels import scans, sweeps

    shapes = [(2176, 2176), (1000, 1537), (4096, 200), (3, 5)]
    rng = np.random.default_rng(0)
    checked = 0
    max_err = {k: 0 for k in TPU_KERNELS}
    for h, w in shapes:
        for density in (0.1, 0.5, 0.9):
            m = rng.random((h, w)) < density
            vals = rng.integers(0, h * w, (h, w), dtype=np.int64)
            mask = torch.from_numpy(m).to(dev)
            any_lab = torch.from_numpy(vals.astype(np.int32)).to(dev)
            lab = torch.where(mask, any_lab, INF)
            cases = [
                ("row_segmented_min_scan", scans.row_segmented_min_scan,
                 lambda a, b: scans.segmented_min_scan_plain(a, b, 1),
                 lab, {}),
                ("col_segmented_min_scan", scans.col_segmented_min_scan,
                 lambda a, b: scans.segmented_min_scan_plain(a, b, 0),
                 lab, {}),
                ("row_segmented_min_scan", scans.row_segmented_min_scan,
                 lambda a, b: scans.segmented_min_scan_plain(a, b, 1, True),
                 any_lab, {"region": True}),
                ("col_segmented_min_scan", scans.col_segmented_min_scan,
                 lambda a, b: scans.segmented_min_scan_plain(a, b, 0, True),
                 any_lab, {"region": True}),
            ]
            for conn in (1, 2):
                for k in (1, 16):
                    cases.append((
                        "fused_sweeps", sweeps.fused_sweeps,
                        lambda a, b, k=k, c=conn:
                            sweeps.fused_sweeps_plain(a, b, k, c),
                        lab, {"k": k, "connectivity": conn}))
            for name, kern, plain, inp, kw in cases:
                got = kern(inp, mask, **kw)
                torch.cuda.synchronize()
                want = plain(inp, mask)
                if got.numel():
                    err = int((got.long() - want.long()).abs().max())
                    max_err[name] = max(max_err[name], err)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{name} {kw} differs from its plain version at "
                        f"{(h, w)} density {density}: "
                        f"{int((got != want).sum())} pixels")
                checked += 1
    log(f"[2] {checked} kernel cases bit-equal to the plain versions at "
        f"{shapes}, densities 0.1/0.5/0.9 (tolerance 0: integer labels; "
        f"max abs err {max_err})")

    # times at the main path's plane size, density 0.5
    h = w = 2176
    m = torch.from_numpy(rng.random((h, w)) < 0.5).to(dev)
    any_lab = torch.from_numpy(
        rng.integers(0, h * w, (h, w)).astype(np.int32)).to(dev)
    lab = torch.where(m, any_lab, INF)
    px = h * w
    nbytes = px * (4 + 1 + 4)  # labels in, mask in, labels out: each once
    rows = {}
    # (name, configuration, kwargs, int32 ops per pixel); the first of
    # each name is what the main path launches on the slide and goes into
    # the JSON line, the others are logged (region scans run in the same
    # decode; k=16 is the phase-2 configuration of the labyrinth)
    for name, kw, ops_px in [
        ("row_segmented_min_scan", {}, 6),
        ("col_segmented_min_scan", {}, 6),
        ("fused_sweeps", {"k": 1, "connectivity": 2}, 9),
        ("row_segmented_min_scan", {"region": True}, 6),
        ("col_segmented_min_scan", {"region": True}, 6),
        ("fused_sweeps", {"k": 16, "connectivity": 2}, 16 * 9),
    ]:
        if name == "fused_sweeps":
            kern = sweeps.fused_sweeps
            inp = lab

            def plain(a, b, kw=kw):
                return sweeps.fused_sweeps_plain(a, b, kw["k"],
                                                 kw["connectivity"])
        else:
            kern = getattr(scans, name)
            dim = 1 if name.startswith("row") else 0
            region = kw.get("region", False)
            inp = any_lab if region else lab

            def plain(a, b, dim=dim, region=region):
                return scans.segmented_min_scan_plain(a, b, dim, region)
        ms = cuda_ms(lambda: kern(inp, m, **kw))
        plain_ms = cuda_ms(lambda: plain(inp, m), iters=5, warmup=1)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_px * px / SCALAR_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        log(f"[2] {name} {kw} at {h}x{w}: {ms:.4f} ms, bound {bound:.4f} ms "
            f"({'bytes' if bytes_ms >= ops_ms else 'operations'}), plain "
            f"version {plain_ms:.4f} ms")
        if name not in rows:
            rows[name] = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": TPU_KERNELS[name], "launches": 0,
                "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None,
            }
    return rows


def phase_labyrinth(dev):
    import torch
    from scipy import ndimage

    from cellseg_tpu_torch.ops.cc import label_components
    from cellseg_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    mask_np = make_labyrinth()
    mask = torch.from_numpy(mask_np).to(dev)
    for conn in (1, 2):
        reset_launch_counts()
        t0 = time.perf_counter()
        got = label_components(mask, connectivity=conn)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        want, n = ndimage.label(
            mask_np, structure=ndimage.generate_binary_structure(2, conn))
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError(f"labyrinth labels differ from scipy at "
                                 f"connectivity {conn}")
        if counts["fused_sweeps"] == 0:
            raise AssertionError("labyrinth did not reach the fused sweeps")
        log(f"[3] labyrinth 1024x1024 conn {conn}: {n} components equal to "
            f"scipy, {dt * 1e3:.1f} ms, launches {counts}")


def phase_forward(dev):
    import torch

    from cellseg_tpu_torch.checkpoint import load_model_for_inference

    model_gpu, _ = load_model_for_inference(CKPT, device=dev)
    model_cpu, _ = load_model_for_inference(CKPT, device="cpu")
    x = np.random.default_rng(0).random((8, 256, 256, 3)).astype(np.float32)
    with torch.inference_mode():
        y_gpu = model_gpu(torch.from_numpy(x).to(dev)).cpu()
        y_cpu = model_cpu(torch.from_numpy(x))
    err = float((y_gpu - y_cpu).abs().max())
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    log(f"[4] UNet forward, 8 tiles 256x256 float32 (cudnn/matmul TF32 "
        f"{tf32}): card vs CPU "
        f"max abs diff {err:.3e} (limit 1e-3), max |logit| "
        f"{float(y_cpu.abs().max()):.3f}")
    if not err <= 1e-3:
        raise AssertionError(f"forward differs from the CPU by {err}")
    return model_gpu


def stage_calls(pred, padded, h, w, dev):
    """The predictor's three stages as callables chained through `state`;
    the decode stage ends with the labels on the host."""
    import torch

    state = {}

    def normalize():
        state["np01"] = pred.stage_norm(torch.from_numpy(padded).to(dev))

    def forward():
        state["interior"] = pred.stage_forward(state["np01"])

    def decode():
        labels = pred.stage_decode(state["interior"], h, w)
        state["labels"] = labels.cpu().numpy()[:h, :w].astype(np.int32)

    return state, [("normalize", normalize), ("forward + softmax", forward),
                   ("decode", decode)]


def phase_main_path(dev, model, card):
    import torch

    from cellseg_tpu_torch.decode.threeclass import (
        decode_interior_prob,
        decode_interior_prob_host,
    )
    from cellseg_tpu_torch.infer.predictor import Predictor
    from cellseg_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    img = make_slide()
    pred = Predictor(model, device=dev)
    pred.predict(img)  # warm-up: cuDNN algorithm choice, allocator

    padded, h, w = pred.pad(img)
    state, stages = stage_calls(pred, padded, h, w, dev)
    stage_ms = {}
    reset_launch_counts()
    with torch.inference_mode():
        torch.cuda.synchronize()
        for name, fn in stages:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            stage_ms[name] = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    total = sum(stage_ms.values())
    log(f"[5] main path, {h}x{w} slide padded to {padded.shape[0]}x"
        f"{padded.shape[1]}, on {card}: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in stage_ms.items())
        + f", total {total:.2f} ms, {h * w / 1e3 / total:.3f} MP/s")
    log(f"[5] kernel launches in the main path: {counts}")
    if not all(counts[k] > 0 for k in TPU_KERNELS):
        raise AssertionError(f"a kernel of the path did not launch: {counts}")

    labels_np = state["labels"]
    prob = state["interior"].clone()
    prob[h:] = 0.0
    prob[:, w:] = 0.0
    prob_cpu = prob.cpu()
    plain = decode_interior_prob(prob_cpu).numpy()[:h, :w]
    golden = decode_interior_prob_host(prob_cpu.numpy())[:h, :w]
    if not np.array_equal(labels_np, plain):
        raise AssertionError("card labels differ from the CPU plain decode")
    if not np.array_equal(labels_np, golden):
        raise AssertionError("card labels differ from the scipy golden")
    n_cells = int(labels_np.max())
    if n_cells == 0:
        raise AssertionError("the slide decoded to no instances")
    log(f"[5] {n_cells} instances, identical to the CPU plain decode and "
        f"the scipy golden")
    phase_profile(pred, padded, h, w, dev, card, stage_ms)
    return counts


def phase_profile(pred, padded, h, w, dev, card, stage_ms):
    """Device busy time per stage (torch.profiler) and the stage's
    heaviest kernels. The idle share is taken against the stage's wall
    time in the counted run (`stage_ms`): walls under the profiler are
    inflated by its tracing. Not part of the counted run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, stages = stage_calls(pred, padded, h, w, dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the tracer's start-up, unmeasured
        torch.cuda.synchronize()
    with torch.inference_mode():
        for name, fn in stages:
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            wall = stage_ms[name]
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            if busy == 0:
                log(f"[6] {name}: device time not measured by the profiler")
                continue
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            log(f"[6] {name} on {card}: device busy {busy:.2f} ms of the "
                f"counted run's {wall:.2f} ms wall, idle share "
                f"{max(0.0, 1 - busy / wall):.3f}; heaviest: "
                + "; ".join(f"{e.key[:48]} x{e.count} "
                            f"{e.self_device_time_total / 1e3:.2f} ms"
                            for e in top[:5]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "cellseg_tpu_torch")):
        print("chip_smoke: the cellseg_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.set_num_threads(max(1, os.cpu_count() or 1))

    card = phase_setup()
    rows = phase_kernels(dev)
    phase_labyrinth(dev)
    model = phase_forward(dev)
    counts = phase_main_path(dev, model, card)
    for name, row in rows.items():
        row["launches"] = counts[name]
    print(json.dumps({"kernels": list(rows.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
