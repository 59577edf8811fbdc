#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cellseg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `cellseg_tpu_torch/csrc/`, checks each
against its plain PyTorch version, and drives the port's paths once: the
trained 3-class UNet predictor (normalize -> sliding-window forward ->
softmax -> decode) on a 2048x2048 synthetic slide, first with the CC
decode (the main path), then with the boundary-watershed decode on the
watershed's plain route, a dihedral-TTA prediction of a 512x512 crop, and
the boundary-watershed decode once more on the stripe route (the JAX
package's route on the TPU), and the CC decode once more on the CC stripe
route (block-local convergence, B4). Every phase raises on failure.
Output, in order: the card and toolchain, per-kernel checks and times,
the labyrinth labeling on both CC routes, the forward parity, each path's
stage times, kernel launch counts and a profile of each stage, the
instance F1 of the decoders against the slide's ground truth, the TTA
check, then one JSON line of per-kernel numbers, the card's name and
power limit, and the `ok` line last.

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
    "stripe_converge": "cellseg_tpu/ops/pallas/local_cc.py:146",
    "stripe_ws_converge": "cellseg_tpu/ops/pallas/ws_local.py:99",
    "fused_ws_sweeps": "cellseg_tpu/ops/pallas/ws_sweeps.py:137",
}
SOURCES = {
    "row_segmented_min_scan": "cellseg_tpu_torch/csrc/scans.cu",
    "col_segmented_min_scan": "cellseg_tpu_torch/csrc/scans.cu",
    "fused_sweeps": "cellseg_tpu_torch/csrc/sweeps.cu",
    "stripe_converge": "cellseg_tpu_torch/csrc/local_cc.cu",
    "stripe_ws_converge": "cellseg_tpu_torch/csrc/ws_local.cu",
    "fused_ws_sweeps": "cellseg_tpu_torch/csrc/ws_sweeps.cu",
}
# the kernels each path launches: the CC decode's, and the boundary
# watershed's (its mask, seeds and area filters are CC work too) on the
# plain and on the stripe route (one global sweep after each stripe pass)
CC_KERNELS = ("row_segmented_min_scan", "col_segmented_min_scan",
              "fused_sweeps")
BW_KERNELS = CC_KERNELS + ("fused_ws_sweeps",)
BW_STRIPE_KERNELS = BW_KERNELS + ("stripe_ws_converge",)
# the CC decode on the CC stripe route: B4, the full-height column scan
# and the global 3x3 sweep of the 8-conn labeling (no row scan)
CC_STRIPE_KERNELS = ("stripe_converge", "col_segmented_min_scan",
                     "fused_sweeps")
# the port's kernels by the names of their CUDA functions, for the
# profiles (one function serves B1 and B2)
PROFILE_KERNELS = {"B1+B2": "seg_scan_kernel", "B3": "fused_sweeps_kernel",
                   "B4": "stripe_converge_kernel", "B5": "stripe_ws_",
                   "B6": "fused_ws_sweeps_kernel"}
# int32 operations of one B4 round per pixel: each segmented scan folds
# forward and backward (a min and a select each) and masks (1), the 8-conn
# sweep takes 8 mins and a select, a region scan compares for its openness
# in both directions (2) instead of masking; 1 compare for the change vote
LOCAL_CC_OPS_PER_PX_ROUND = {(1, False): 2 * 5 + 1, (2, False): 2 * 5 + 9 + 1,
                             (1, True): 2 * 6 + 1}
# int32/float32 operations of folding one neighbour into a masked pixel's
# watershed state: max, 2 compares + add + 2 selects for the hops, 6
# compares and 4 logic ops for the order, 3 selects
WS_OPS_PER_NEIGHBOUR = 18
# shapes of the kernel checks, and the side of the timed planes (the
# main path's padded slide)
CHECK_SHAPES = [(2176, 2176), (1000, 1537), (4096, 200), (3, 5)]
# B5 also at the wide planes of its cuda test, and at the stripes just
# inside (16 blocks) and just outside (global memory) the cluster
WS_LOCAL_EXTRA = [(4, 20011, 2), (20011, 3, 1), (16, 12360, 8),
                  (16, 12376, 8)]
TIMED_SIDE = 2176
LABYRINTH_SIDE = 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def make_slide(H: int = 2048, W: int = 2048, n_cells: int = 2000,
               seed: int = 0, return_labels: bool = False):
    """Synthetic whole-slide surrogate: ~n_cells bright disks on a noisy
    background (the workload of the JAX package's bench.py). With
    return_labels, also the ground-truth instances: each disk's pixels
    not already taken by an earlier disk."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img_f = rng.normal(30, 8, (H, W))
    labels = np.zeros((H, W), np.int32) if return_labels else None
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
        if labels is not None:
            blob = labels[y0:y1, x0:x1]
            blob[inside & (blob == 0)] = i + 1
    img = np.clip(img_f, 0, 255).astype(np.uint8)
    if return_labels:
        return img, labels
    return img


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


def ws_world(rng, h: int, w: int, terrain: str, density: float, dev):
    """The watershed's state over random elevations (continuous, quantized
    to 0.5, or integer-valued) with a seed on every 200th pixel:
    [e, mask, cost, hops, label] on `dev`, as ops/watershed.py sets it up."""
    import torch

    from cellseg_tpu_torch.ops.kernels.ws_sweeps import BIG, INF_HOPS

    img = rng.normal(size=(h, w)).astype(np.float32)
    if terrain == "quantized":
        img = np.round(img * 2) / 2
    elif terrain == "integer":
        img = rng.integers(0, 4, (h, w)).astype(np.float32)
    mask = rng.random((h, w)) < density
    n = h * w // 200 + 1
    markers = np.zeros((h, w), np.int32)
    markers[rng.integers(0, h, n), rng.integers(0, w, n)] = np.arange(1, n + 1)
    markers *= mask
    e = np.where(mask, img, BIG).astype(np.float32)
    seeded = markers > 0
    planes = [e, mask, np.where(seeded, e, BIG).astype(np.float32),
              np.where(seeded, 0, INF_HOPS).astype(np.int32), markers]
    return [torch.from_numpy(p).to(dev) for p in planes]


def ws_needed_ops(planes, stripe: int, sweeps) -> int:
    """int32/float32 operations that `sweeps[i]` Jacobi relaxation sweeps
    of row stripe i of the watershed state `planes` ([e, mask, cost, hops,
    label]) need: every neighbour of every masked pixel in the first
    sweep, then only the neighbours (within the stripe) that changed in
    the sweep before. The fold is a minimum in a total order, so a
    neighbour that did not change offers nothing that the pixel's state
    does not already hold. Replays the sweeps with the plain version."""
    import torch
    import torch.nn.functional as F

    from cellseg_tpu_torch.ops.kernels.ws_sweeps import (
        SHIFTS_8,
        relax_once_plain,
    )

    h, w = planes[0].shape
    n = h // stripe
    e, m, c, hp, lb = (t.reshape(n, stripe, w) for t in planes)
    m = m != 0
    sweeps = sweeps.view(n, 1, 1)
    folds = 8 * int((m & (sweeps > 0)).sum())
    for s in range(1, int(sweeps.max())):
        nc, nh, nl = relax_once_plain(c, hp, lb, e, m)
        moved = F.pad(((nc != c) | (nh != hp) | (nl != lb)).to(torch.int32),
                      (1, 1, 1, 1))
        fresh = sum(moved[:, 1 + dy:1 + dy + stripe, 1 + dx:1 + dx + w]
                    for dy, dx in SHIFTS_8)
        folds += int(fresh[m & (sweeps > s)].sum())
        c, hp, lb = nc, nh, nl
    return WS_OPS_PER_NEIGHBOUR * folds


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

    from cellseg_tpu_torch.ops.cc import stripe_route_supported
    from cellseg_tpu_torch.ops.kernels import (
        local_cc,
        scans,
        sweeps,
        ws_local,
        ws_sweeps,
    )

    shapes = CHECK_SHAPES
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
    log(f"[2] {checked} scan and sweep cases bit-equal to the plain "
        f"versions at {shapes}, densities 0.1/0.5/0.9 (tolerance 0: "
        f"integer labels)")

    # B6: all three state planes bit-equal (tolerance 0: the kernel does
    # the plain version's float32 comparisons in the same order)
    ws_checked = 0
    terrains = ("continuous", "quantized", "integer")
    for h, w in shapes:
        for terrain in terrains:
            for density in (0.5, 0.85):
                args = ws_world(rng, h, w, terrain, density, dev)
                for k in (1, 8):
                    got = ws_sweeps.fused_ws_sweeps(*args, k=k)
                    torch.cuda.synchronize()
                    want = ws_sweeps.fused_ws_sweeps_plain(*args, k=k)
                    for g, wt, plane in zip(got, want,
                                            ("cost", "hops", "label")):
                        err = float((g.double() - wt.double()).abs().max())
                        max_err["fused_ws_sweeps"] = max(
                            max_err["fused_ws_sweeps"], err)
                        if not torch.equal(g, wt):
                            raise AssertionError(
                                f"fused_ws_sweeps k={k} {plane} differs from "
                                f"its plain version at {(h, w)} {terrain} "
                                f"density {density}: "
                                f"{int((g != wt).sum())} pixels")
                    ws_checked += 1
    log(f"[2] {ws_checked} fused_ws_sweeps cases (k 1/8, {'/'.join(terrains)}"
        f" elevations, mask densities 0.5/0.85) bit-equal to the plain "
        f"version in cost, hops and label at {shapes} (tolerance 0; max abs "
        f"err {max_err})")

    # B5: the three state planes and the sweeps of every stripe equal
    # (tolerance 0, as B6), at the JAX package's stripe for the shape or,
    # where it has none, one stripe of the whole height, and at the shapes
    # that take the other variants
    local_checked = 0
    variants = {}
    for h, w, stripe in ([(h, w, ws_local.ws_stripe(h, w) or h)
                          for h, w in shapes] + WS_LOCAL_EXTRA):
        variants[h, w, stripe] = ws_local.ws_cluster_size(h, w, stripe)
        for terrain in terrains:
            for density in (0.5, 0.85):
                args = ws_world(rng, h, w, terrain, density, dev)
                for cap in (256, 5):
                    ran = [torch.zeros(h // stripe, dtype=torch.int32,
                                       device=dev) for _ in range(2)]
                    got = ws_local.stripe_ws_converge(
                        *args, cap=cap, stripe=stripe, sweeps=ran[0])
                    torch.cuda.synchronize()
                    want = ws_local.stripe_ws_converge_plain(
                        *args, cap=cap, stripe=stripe, sweeps=ran[1])
                    for g, wt, plane in zip((*got, ran[0]), (*want, ran[1]),
                                            ("cost", "hops", "label",
                                             "sweeps")):
                        err = float((g.double() - wt.double()).abs().max())
                        max_err["stripe_ws_converge"] = max(
                            max_err["stripe_ws_converge"], err)
                        if not torch.equal(g, wt):
                            raise AssertionError(
                                f"stripe_ws_converge cap={cap} {plane} "
                                f"differs from its plain version at "
                                f"{(h, w)} stripe {stripe} {terrain} density "
                                f"{density}: {int((g != wt).sum())} pixels")
                    local_checked += 1
    if set(variants.values()) != {0, ws_local.MAX_CLUSTER}:
        raise AssertionError(f"the B5 checks miss a variant: {variants}")
    log(f"[2] {local_checked} stripe_ws_converge cases (cap 256/5, "
        f"{'/'.join(terrains)} elevations, mask densities 0.5/0.85) "
        f"bit-equal to the plain version in cost, hops, label and the "
        f"sweeps per stripe at (h, w, stripe): blocks per cluster (0: the "
        f"global-memory variant) {variants} (tolerance 0; max abs err "
        f"{max_err['stripe_ws_converge']})")

    # B4: the labels and the rounds of every stripe equal (tolerance 0),
    # at the shapes where the CC stripe route runs (the labyrinth's too),
    # plain mode with INF off the mask and region mode on any labels, with
    # the route's cap and a binding one
    lcc_checked = 0
    lcc_shapes = [s for s in dict.fromkeys(
        shapes + [(LABYRINTH_SIDE, LABYRINTH_SIDE)])
        if stripe_route_supported(*s)]
    for h, w in lcc_shapes:
        stripe = local_cc.cc_stripe(h, w)
        for density in (0.1, 0.5, 0.9):
            m = torch.from_numpy(rng.random((h, w)) < density).to(dev)
            vals = torch.from_numpy(
                rng.integers(0, h * w, (h, w)).astype(np.int32)).to(dev)
            lab = torch.where(m, vals, INF)
            for conn, region, inp in ((1, False, lab), (2, False, lab),
                                      (1, True, vals)):
                for cap in (16, 2):
                    ran = [torch.zeros(h // stripe, dtype=torch.int32,
                                       device=dev) for _ in range(2)]
                    got = local_cc.stripe_converge(inp, m, conn, region, cap,
                                                   rounds=ran[0])
                    torch.cuda.synchronize()
                    want = local_cc.stripe_converge_plain(
                        inp, m, conn, region, cap, stripe, ran[1])
                    for g, wt, plane in ((got, want, "labels"),
                                         (ran[0], ran[1], "rounds")):
                        err = int((g.long() - wt.long()).abs().max())
                        max_err["stripe_converge"] = max(
                            max_err["stripe_converge"], err)
                        if not torch.equal(g, wt):
                            raise AssertionError(
                                f"stripe_converge connectivity {conn} region "
                                f"{region} cap {cap} {plane} differ from the "
                                f"plain version at {(h, w)} stripe {stripe} "
                                f"density {density}: "
                                f"{int((g != wt).sum())} entries")
                    lcc_checked += 1
    log(f"[2] {lcc_checked} stripe_converge cases (connectivity 1/2, region "
        f"on/off, cap 16/2, densities 0.1/0.5/0.9) bit-equal to the plain "
        f"version in labels and rounds per stripe at {lcc_shapes} "
        f"(tolerance 0; max abs err {max_err['stripe_converge']})")

    # times at the main path's plane size, density 0.5 for the CC kernels
    h = w = TIMED_SIDE
    px = h * w
    m = torch.from_numpy(rng.random((h, w)) < 0.5).to(dev)
    any_lab = torch.from_numpy(
        rng.integers(0, h * w, (h, w)).astype(np.int32)).to(dev)
    lab = torch.where(m, any_lab, INF)
    cc_bytes = px * (4 + 1 + 4)  # labels in, mask in, labels out: each once
    # the watershed in mid-flood (16 sweeps in), mask density 0.85
    ws = ws_world(rng, h, w, "continuous", 0.85, dev)
    ws[2:] = ws_sweeps.fused_ws_sweeps(*ws, k=16)
    ws_bytes = px * (4 + 1 + 4 + 4 + 4 + 3 * 4)  # 5 planes in, 3 out
    # B5 from the watershed's initial state, as the stripe route's first
    # launch gets it; its operations are those that the sweeps each stripe
    # of this input runs (the kernel reports them) need
    local = ws_world(rng, h, w, "continuous", 0.85, dev)
    stripe = ws_local.ws_stripe(h, w)
    ran = torch.zeros(h // stripe, dtype=torch.int32, device=dev)
    ws_local.stripe_ws_converge(*local, sweeps=ran)
    local_ops = ws_needed_ops(local, stripe, ran)
    every_sweep = int((local[1].view(h // stripe, -1).sum(1) * ran).sum())
    cluster = ws_local.ws_cluster_size(h, w, stripe)
    resident = ws_local.cluster_occupancy(h, w, stripe)
    log(f"[2] stripe_ws_converge input at {h}x{w}: {h // stripe} stripes of "
        f"{stripe} rows, sweeps per stripe {int(ran.min())}-"
        f"{int(ran.max())} (mean {float(ran.float().mean()):.1f}); "
        f"{cluster} blocks per cluster, {resident} clusters resident at "
        f"once (cudaOccupancyMaxActiveClusters); operations needed "
        f"{local_ops} (every neighbour of every masked pixel in every "
        f"sweep: {8 * WS_OPS_PER_NEIGHBOUR * every_sweep})")

    def ws_steps(ms, most=int(ran.max()), total=int(ran.sum()),
                 busy=min(resident, h // stripe)):
        # the slowest stripe's chain, and one cluster's sweep if every
        # resident cluster were busy all the time
        return (f"{ms * 1e3 / most:.2f} us per sweep of the slowest stripe "
                f"({most} sweeps), {ms * 1e3 * busy / total:.2f} us per "
                f"sweep of a cluster with {busy} clusters busy")

    # B4 at the port's stripe for the plane, and at 16 rows (logged); its
    # operations are those of the rounds each stripe of this input runs
    # (the kernel reports them)
    lcc_stripe = local_cc.cc_stripe(h, w)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lcc_ops, lcc_steps = {}, {}
    for conn, region, st in [(*k, lcc_stripe)
                             for k in LOCAL_CC_OPS_PER_PX_ROUND] + [
                                 (2, False, 16)]:
        ran = torch.zeros(h // st, dtype=torch.int32, device=dev)
        local_cc.stripe_converge(any_lab if region else lab, m, conn, region,
                                 stripe=st, rounds=ran)
        lcc_ops[conn, region, st] = (LOCAL_CC_OPS_PER_PX_ROUND[conn, region]
                                     * int(ran.sum()) * st * w)
        per_wave = local_cc.blocks_per_sm(w, st, conn, region) * sms
        waves = -(-(h // st) // per_wave)
        log(f"[2] stripe_converge input at {h}x{w}, connectivity {conn} "
            f"region {region}: {h // st} stripes of {st} rows, rounds per "
            f"stripe {int(ran.min())}-{int(ran.max())} (mean "
            f"{float(ran.float().mean()):.2f}, cap 16); {per_wave} stripes "
            f"per wave on {sms} SMs, {waves} wave(s)")
        lcc_steps[conn, region, st] = (
            lambda ms, most=int(ran.max()), waves=waves:
                f"{ms * 1e3 / (most * waves):.2f} us per round and wave")
    rows = {}
    # (name, configuration, kernel call, plain call, bytes, int32/float32
    # operations, time per step or None); the first of each name is what
    # its path launches on the slide and goes into the JSON line, the
    # others are logged (region scans run in the same decode; k=16 is the
    # phase-2 configuration of the labyrinth; the watershed launches k=8
    # but for a shorter last launch, k=1 is logged for the cost of one
    # sweep; B4 at 16 rows, the stripe of its first design)
    cases = []
    for kw in ({}, {"region": True}):
        region = kw.get("region", False)
        inp = any_lab if region else lab
        for name, dim in (("row_segmented_min_scan", 1),
                          ("col_segmented_min_scan", 0)):
            cases.append((
                name, kw,
                lambda kern=getattr(scans, name), inp=inp, kw=kw:
                    kern(inp, m, **kw),
                lambda inp=inp, dim=dim, region=region:
                    scans.segmented_min_scan_plain(inp, m, dim, region),
                cc_bytes, 6 * px, None))
        if not region:
            cases.append((
                "fused_sweeps", {"k": 1, "connectivity": 2},
                lambda: sweeps.fused_sweeps(lab, m, 1, 2),
                lambda: sweeps.fused_sweeps_plain(lab, m, 1, 2),
                cc_bytes, 9 * px, None))
    cases.append((
        "fused_sweeps", {"k": 16, "connectivity": 2},
        lambda: sweeps.fused_sweeps(lab, m, 16, 2),
        lambda: sweeps.fused_sweeps_plain(lab, m, 16, 2),
        cc_bytes, 16 * 9 * px, None))
    for k in (8, 1):
        cases.append((
            "fused_ws_sweeps", {"k": k},
            lambda k=k: ws_sweeps.fused_ws_sweeps(*ws, k=k),
            lambda k=k: ws_sweeps.fused_ws_sweeps_plain(*ws, k=k),
            ws_bytes,
            ws_needed_ops(ws, h, torch.full((1,), k, device=dev)), None))
    # the 8-conn labeling first: the decode's last and largest labeling
    for conn, region, st in ((2, False, lcc_stripe), (1, False, lcc_stripe),
                             (1, True, lcc_stripe), (2, False, 16)):
        inp = any_lab if region else lab
        cases.append((
            "stripe_converge",
            {"connectivity": conn, "region": region, "cap": 16,
             "stripe": st},
            lambda inp=inp, c=conn, r=region, st=st:
                local_cc.stripe_converge(inp, m, c, r, stripe=st),
            lambda inp=inp, c=conn, r=region, st=st:
                local_cc.stripe_converge_plain(inp, m, c, r, stripe=st),
            cc_bytes, lcc_ops[conn, region, st],
            lcc_steps[conn, region, st]))
    cases.append((
        "stripe_ws_converge", {"cap": 256, "stripe": stripe,
                               "cluster": cluster},
        lambda: ws_local.stripe_ws_converge(*local),
        lambda: ws_local.stripe_ws_converge_plain(*local),
        ws_bytes, local_ops, ws_steps))
    for name, kw, kern, plain, nbytes, ops, steps in cases:
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain, iters=3 if name == "stripe_ws_converge"
                           else 5, warmup=1)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / SCALAR_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"[2] {name} {kw} at {h}x{w}: {ms:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by}), plain version {plain_ms:.4f} ms"
            + (f"; {steps(ms)}" if steps else ""))
        if name not in rows:
            rows[name] = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": TPU_KERNELS[name], "launches": 0,
                "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            }
    return rows


def phase_labyrinth(dev):
    """The labyrinth on both CC routes: the global route reaches phase 2
    (B3 with k = 16), the stripe route runs B4. Labels equal to scipy;
    the time is of the second of two calls."""
    import torch
    from scipy import ndimage

    from cellseg_tpu_torch.ops.cc import label_components
    from cellseg_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    mask_np = make_labyrinth(LABYRINTH_SIDE)
    mask = torch.from_numpy(mask_np).to(dev)
    needs = {"global": "fused_sweeps", "stripe": "stripe_converge"}
    for route, kernel in needs.items():
        for conn in (1, 2):
            label_components(mask, connectivity=conn, route=route)
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = label_components(mask, connectivity=conn, route=route)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = launch_counts()
            want, n = ndimage.label(
                mask_np, structure=ndimage.generate_binary_structure(2, conn))
            if not np.array_equal(got.cpu().numpy(), want):
                raise AssertionError(f"labyrinth labels differ from scipy at "
                                     f"connectivity {conn}, route {route}")
            if counts[kernel] == 0:
                raise AssertionError(f"labyrinth on the {route} route did "
                                     f"not launch {kernel}")
            log(f"[3] labyrinth {LABYRINTH_SIDE}x{LABYRINTH_SIDE} conn {conn}"
                f", {route} route: {n} components equal to scipy, "
                f"{dt * 1e3:.1f} ms, launches "
                f"{ {k: v for k, v in counts.items() if v} }")


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
    return model_gpu, model_cpu


def stage_calls(pred, padded, h, w, dev):
    """The predictor's three stages as callables chained through `state`;
    the decode stage ends with the labels on the host."""
    import torch

    state = {}

    def normalize():
        state["np01"] = pred.stage_norm(torch.from_numpy(padded).to(dev))

    def forward():
        state["probs"] = pred.stage_forward(state["np01"])

    def decode():
        labels = pred.stage_decode(state["probs"], h, w)
        state["labels"] = labels.cpu().numpy()[:h, :w].astype(np.int32)

    return state, [("normalize", normalize), ("forward + softmax", forward),
                   ("decode", decode)]


def run_path(tag, pred, img, dev, card, kernels):
    """One counted, timed run of a predictor path after a warm-up: launch
    counts set to 0 just before it and read just after. Fails unless
    every kernel in `kernels` launched. Returns (state, stage ms, counts,
    padded slide)."""
    import torch

    from cellseg_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

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
    log(f"{tag}, {h}x{w} slide padded to {padded.shape[0]}x"
        f"{padded.shape[1]}, on {card}: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in stage_ms.items())
        + f", total {total:.2f} ms, {h * w / 1e3 / total:.3f} MP/s")
    log(f"{tag}, kernel launches: {counts}")
    if not all(counts[k] > 0 for k in kernels):
        raise AssertionError(f"a kernel of the path did not launch: {counts}")
    return state, stage_ms, counts, padded


def masked_probs(probs, h, w):
    """The forward's probabilities on the host, zero outside the image
    (as stage_decode masks them)."""
    prob = probs.clone()
    prob[h:] = 0.0
    prob[:, w:] = 0.0
    return prob.cpu()


def phase_main_path(dev, model, card, img):
    from cellseg_tpu_torch.decode.threeclass import (
        decode_interior_prob,
        decode_interior_prob_host,
    )
    from cellseg_tpu_torch.infer.predictor import Predictor

    h, w = img.shape[:2]
    pred = Predictor(model, device=dev)
    state, stage_ms, counts, padded = run_path(
        "[5] main path (cc decode)", pred, img, dev, card, CC_KERNELS)

    labels_np = state["labels"]
    prob_cpu = masked_probs(state["probs"], h, w)
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
    phase_profile("[6]", pred, padded, h, w, dev, card, stage_ms)
    return counts, labels_np


def phase_boundary_watershed(dev, model, card, img, gt, cc_labels):
    """The boundary-watershed path on the slide: card labels bit-identical
    to the port's CPU plain decode of the same two probability maps, the
    fused watershed sweeps launched, F1 of both decoders against the
    ground truth, and agreement with the sequential golden on a crop."""
    import torch

    from cellseg_tpu_torch.decode.threeclass import boundary_watershed_markers
    from cellseg_tpu_torch.infer.predictor import Predictor
    from cellseg_tpu_torch.metrics.f1 import score_pair
    from cellseg_tpu_torch.ops.watershed import watershed, watershed_host

    h, w = img.shape[:2]
    pred = Predictor(model, device=dev, decode="boundary_watershed")
    state, stage_ms, counts, padded = run_path(
        "[7] boundary-watershed path", pred, img, dev, card, BW_KERNELS)

    labels_np = state["labels"]
    prob_cpu = masked_probs(state["probs"], h, w)
    t0 = time.perf_counter()
    p_int_cpu = prob_cpu[..., 0].contiguous()
    # decode_boundary_watershed, its markers kept for the stripe route
    seeds_cpu, mask_cpu = boundary_watershed_markers(
        p_int_cpu, prob_cpu[..., 1].contiguous())
    plain = watershed(-p_int_cpu, seeds_cpu, mask_cpu)
    plain_s = time.perf_counter() - t0
    if not np.array_equal(labels_np, plain.numpy()[:h, :w]):
        raise AssertionError("boundary-watershed card labels differ from "
                             "the CPU plain decode")
    n_cells = int(labels_np.max())
    if n_cells == 0:
        raise AssertionError("the slide decoded to no instances")
    log(f"[7] {n_cells} instances ({int(cc_labels.max())} with the cc "
        f"decode), identical to the CPU plain decode of the same "
        f"probabilities ({padded.shape[0]}x{padded.shape[1]}, "
        f"{plain_s:.1f} s on {torch.get_num_threads()} CPU threads)")
    f1 = {name: score_pair(gt, lab)
          for name, lab in (("cc", cc_labels),
                            ("boundary_watershed", labels_np))}
    log(f"[7] instance F1 at IoU 0.5 against the slide's ground truth "
        f"({f1['cc']['true_num']} cells off the border): "
        + ", ".join(f"{k} {v['f1']:.4f} (tp {v['tp']}, fp {v['fp']}, "
                    f"fn {v['fn']})" for k, v in f1.items()))

    # the relaxation against the sequential priority flood on a crop
    n = 512
    crop = state["probs"][:n, :n]
    p_int, p_bnd = crop[..., 0].contiguous(), crop[..., 1].contiguous()
    with torch.inference_mode():
        seeds, mask = boundary_watershed_markers(p_int, p_bnd)
        card_ws = watershed(-p_int, seeds, mask).cpu().numpy()
    mask_np = mask.cpu().numpy()
    host_ws = watershed_host(-p_int.cpu().numpy(), seeds.cpu().numpy(),
                             mask_np)
    agree = float((card_ws[mask_np] == host_ws[mask_np]).mean())
    log(f"[7] watershed on a {n}x{n} crop: pixel agreement with the "
        f"sequential priority-flood golden {agree:.4f} over "
        f"{int(mask_np.sum())} mask pixels (no threshold)")
    phase_profile("[8]", pred, padded, h, w, dev, card, stage_ms)
    return counts, {"labels": labels_np, "seeds": seeds_cpu,
                    "mask": mask_cpu, "prob": prob_cpu, "f1": f1,
                    "crop": (seeds, mask, p_int, host_ws)}


def phase_stripe_route(dev, model, card, img, gt, bw):
    """The boundary-watershed path on the stripe route: card labels
    bit-identical to the same route through the kernels' plain versions
    (run on the card: the route takes hundreds of sweeps, too many for the
    CPU at 2176^2) from the CPU plain decode's seeds and mask; B5 and B6
    launched; how far the labels are from the plain route's, their F1
    against the ground truth, and agreement with the sequential golden on
    the crop of [7]."""
    import torch

    from cellseg_tpu_torch.infer.predictor import Predictor
    from cellseg_tpu_torch.metrics.f1 import score_pair
    from cellseg_tpu_torch.ops.watershed import watershed, watershed_plain

    h, w = img.shape[:2]
    pred = Predictor(model, device=dev, decode="boundary_watershed",
                     ws_route="stripe")
    state, stage_ms, counts, padded = run_path(
        "[10] boundary-watershed path, stripe route", pred, img, dev, card,
        BW_STRIPE_KERNELS)
    labels_np = state["labels"]
    p_int = bw["prob"][..., 0].contiguous().to(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = watershed_plain(-p_int, bw["seeds"].to(dev), bw["mask"].to(dev),
                              route="stripe").cpu().numpy()[:h, :w]
    ref_s = time.perf_counter() - t0
    if not np.array_equal(labels_np, ref):
        raise AssertionError("stripe-route card labels differ from the "
                             "plain versions' stripe route")
    mask_np = bw["mask"].numpy()[:h, :w]
    differ = int((labels_np != bw["labels"])[mask_np].sum())
    f1 = score_pair(gt, labels_np)
    log(f"[10] {int(labels_np.max())} instances, identical to the stripe "
        f"route through the plain versions on the card from the CPU "
        f"decode's seeds and mask ({ref_s:.1f} s); {differ} of "
        f"{int(mask_np.sum())} mask pixels labeled otherwise than on the "
        f"plain route; instance F1 at IoU 0.5 against the ground truth "
        f"{f1['f1']:.4f} (tp {f1['tp']}, fp {f1['fp']}, fn {f1['fn']}; plain "
        f"route {bw['f1']['boundary_watershed']['f1']:.4f})")
    seeds, mask, crop_int, host_ws = bw["crop"]
    with torch.inference_mode():
        card_ws = watershed(-crop_int, seeds, mask,
                            route="stripe").cpu().numpy()
    crop_mask = mask.cpu().numpy()
    agree = float((card_ws[crop_mask] == host_ws[crop_mask]).mean())
    log(f"[10] stripe-route watershed on the {crop_mask.shape[0]}x"
        f"{crop_mask.shape[1]} crop: pixel agreement with the sequential "
        f"priority-flood golden {agree:.4f} (no threshold)")
    phase_profile("[11]", pred, padded, h, w, dev, card, stage_ms)
    return counts


def phase_tta(dev, model, model_cpu, card, img):
    """One dihedral-TTA prediction of a 512x512 crop, checked as the main
    path is: its probabilities against the CPU forward, its labels
    against the CPU plain decode and the scipy golden."""
    import torch

    from cellseg_tpu_torch.decode.threeclass import (
        decode_interior_prob,
        decode_interior_prob_host,
    )
    from cellseg_tpu_torch.infer.predictor import Predictor
    from cellseg_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    crop = img[:512, :512]
    pred = Predictor(model, device=dev, tta=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    labels, probs, h, w = pred.predict_device(crop)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    if not all(counts[k] > 0 for k in CC_KERNELS):
        raise AssertionError(f"a kernel of the path did not launch: {counts}")
    labels_np = labels.cpu().numpy()[:h, :w].astype(np.int32)

    cpu = Predictor(model_cpu, device="cpu", tta=True)
    with torch.inference_mode():
        p_cpu = cpu.stage_forward(cpu.stage_norm(
            torch.from_numpy(cpu.pad(crop)[0])))
    err = float((probs.cpu() - p_cpu).abs().max())
    if not err <= 1e-3:
        raise AssertionError(f"TTA probabilities differ from the CPU by {err}")
    prob_cpu = masked_probs(probs, h, w)
    plain = decode_interior_prob(prob_cpu).numpy()[:h, :w]
    golden = decode_interior_prob_host(prob_cpu.numpy())[:h, :w]
    if not (np.array_equal(labels_np, plain)
            and np.array_equal(labels_np, golden)):
        raise AssertionError("TTA card labels differ from the CPU plain "
                             "decode or the scipy golden")
    log(f"[9] TTA (8 dihedral views, cc decode) on a {h}x{w} crop, on "
        f"{card}: {ms:.2f} ms first call; probabilities within {err:.3e} of "
        f"the CPU (limit 1e-3); {int(labels_np.max())} instances identical "
        f"to the CPU plain decode and the scipy golden; launches {counts}")


def phase_cc_stripe_route(dev, model, card, img, cc_labels):
    """The main path with the CC decode on the CC stripe route: labels
    bit-identical to the global route's [5] and to the scipy golden of
    this run's probabilities; B4 and the column scan launched."""
    from cellseg_tpu_torch.decode.threeclass import decode_interior_prob_host
    from cellseg_tpu_torch.infer.predictor import Predictor

    h, w = img.shape[:2]
    pred = Predictor(model, device=dev, cc_route="stripe")
    state, stage_ms, counts, padded = run_path(
        "[12] main path (cc decode), CC stripe route", pred, img, dev, card,
        CC_STRIPE_KERNELS)
    labels_np = state["labels"]
    golden = decode_interior_prob_host(
        masked_probs(state["probs"], h, w).numpy())[:h, :w]
    if not np.array_equal(labels_np, cc_labels):
        raise AssertionError("CC stripe-route labels differ from the global "
                             "route's")
    if not np.array_equal(labels_np, golden):
        raise AssertionError("CC stripe-route labels differ from the scipy "
                             "golden")
    log(f"[12] {int(labels_np.max())} instances, identical to the global "
        f"route's [5] and to the scipy golden")
    phase_profile("[13]", pred, padded, h, w, dev, card, stage_ms)
    return counts


def phase_profile(tag, pred, padded, h, w, dev, card, stage_ms):
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
                log(f"{tag} {name}: device time not measured by the "
                    f"profiler")
                continue
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            log(f"{tag} {name} on {card}: device busy {busy:.2f} ms of the "
                f"counted run's {wall:.2f} ms wall, idle share "
                f"{max(0.0, 1 - busy / wall):.3f}; heaviest: "
                + "; ".join(f"{e.key[:48]} x{e.count} "
                            f"{e.self_device_time_total / 1e3:.2f} ms"
                            for e in top[:5]))
            ours = {}
            for label, fn_name in PROFILE_KERNELS.items():
                hits = [e for e in kernels if fn_name in e.key]
                if hits:
                    ours[label] = (
                        sum(e.count for e in hits),
                        sum(e.self_device_time_total for e in hits) / 1e3)
            if ours:
                log(f"{tag} {name}: the port's kernels, device time: "
                    + ", ".join(f"{k} x{n} {t:.2f} ms"
                                for k, (n, t) in ours.items()))


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
    model, model_cpu = phase_forward(dev)
    img, gt = make_slide(return_labels=True)
    counts, cc_labels = phase_main_path(dev, model, card, img)
    bw_counts, bw = phase_boundary_watershed(dev, model, card, img, gt,
                                             cc_labels)
    phase_tta(dev, model, model_cpu, card, img)
    stripe_counts = phase_stripe_route(dev, model, card, img, gt, bw)
    cc_stripe_counts = phase_cc_stripe_route(dev, model, card, img,
                                             cc_labels)
    for name, row in rows.items():
        # each kernel's launches in the run of the path it was ported for
        row["launches"] = {"fused_ws_sweeps": bw_counts,
                           "stripe_ws_converge": stripe_counts,
                           "stripe_converge": cc_stripe_counts}.get(
                               name, counts)[name]
    print(json.dumps({"kernels": list(rows.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
