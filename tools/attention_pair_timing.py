"""Time the window-attention and MLP kernels of two checkouts of heal_swin_torch on one
GPU, in turns: other, this, this, other.

    python3 tools/attention_pair_timing.py --other _checkout/parent \
        [--family mlp|tail|f32|tail_f32|tails|paths|mlp_f32|attn_f32_bwd]

``--other`` is an unpacked copy of another commit (``git archive`` into the
git-ignored ``_checkout/``).  Each of the four turns is its own process: it imports
heal_swin_torch from its checkout and builds that checkout's kernels.  What it times
comes from this checkout's chip_smoke.py, so that every turn runs the same operands
as its ``check_kernels``: the seeded inputs (``seeded_draws``, ``stage_inputs``,
``bottleneck_inputs``), the library call (``sdpa_library``) and the single-call time
(``median_ms``).  The attention family (``--family attention``), masked and unmasked:
K1 and its backward K4 (cosine, with LayerNorm) and K16 / K17 (scaled-dot) at the three
stage shapes (T 262,144 / 65,536 / 16,384, C 96 / 192 / 384); K2 and its backward K5,
each in both flavours, at the bottleneck (T 4,096, C 768, 24 heads); and one
``scaled_dot_product_attention`` on K2's operands, the same code in every turn: a
control for the spread between turns.  The MLP family (``--family mlp``), tanh GELU, on
``check_mlp_kernels``'s operands (``mlp_inputs``) at the four stage shapes (T 262,144 /
65,536 / 16,384 / 4,096, C 96 / 192 / 384 / 768, H 4C): K12, K13, K14 and K15 (with the
DropPath scale), and the port's cuBLAS / ATen routes for K12 / K13's function and for
K14 / K15's (``mlp_route``, forward and backward; the branch's with the DropPath scale)
as the controls.  The tail family (``--family tail``), at the paper tail (T 262,144, C 96,
p 4, F 10) on chip_smoke.py's ``tail_inputs``: K6 and its backward K7, K3 (predict), and
K8 / K9 (the depth loss, l2, one channel), and the composed PyTorch routes of K3's
function (``pred_route``), of K6 / K7's (``tail_route``) and of K8 / K9's
(``depth_route``), forward and backward, as the controls that run the same code in every
turn; each launches once a step (K3 once a predict).  The f32 family (``--family f32``),
on the f32 operands of chip_smoke.py's ``check_f32_eval_kernels`` (its seed, the bf16
draws of ``stage_inputs`` and ``bottleneck_inputs`` taken to f32): the f32 K1 at the three
stage shapes, masked and unmasked, the f32 K2 at the bottleneck in both flavours, masked
and unmasked, and one f32 ``scaled_dot_product_attention`` on K2's operands as the
control, summed over the paper predict's launches (the f32 K1 20: 4 at C 96, 4 at C 192,
12 at C 384, half of them masked; the f32 K2 2, one masked, cosine as the paper configs);
where the checkout exposes them, the f32 K1's steps alone (the qkv product, the masked
cosine attention, the output product: the LayerNorm is the rest), summed the same way.
The f32 tail family (``--family tail_f32``), at the paper configs' f32 tails (T 262,144, C
96, p 4) on chip_smoke.py's ``paper_tail_inputs`` (F 8) and ``paper_depth_tail_inputs``
(l2, one channel), with their seeds: the f32 K3, K6 and K7, K8 and K9, and the f32 composed
PyTorch routes of K3's, K6 / K7's and K8 / K9's functions as the controls (their
backwards are autograd on a saved graph: the forward is not run again, as K7 and K9 run
it); each launches once a step (K3 once a predict).  Beside the times, each turn prints
each f32 kernel's device ms by kernel name (chip_smoke.py's ``trace``, 5 calls; the
profiler can drop a record) and the ptxas report (registers, spills) of the f32 tail
kernels its build compiled.  ``--family tails`` times the tail family and the f32 tail
family in the same turns.  ``--family paths`` times K3, K6 and K7 at the tails that the
row cores' chunked heads and streamed slices serve (T 262,144, p 4, ``width_inputs``
operands): bf16 at C 128, F 10 (K7's slices streamed), f32 at C 96, F 25 (the heads in
chunks of 16), and bf16 at C 96, F 25 and 32 (one chunk of 32), on whichever route and
head each checkout takes them.  ``--family mlp_f32`` times the f32 K13 (exact GELU, the
paper configs') and the f32 K15 (with the DropPath draw) on chip_smoke.py's
``f32_mlp_inputs`` at the stage shapes of batch 2 (K13 at the four, K15 at the three the
MLP phase runs it at), each beside the f32 ``mlp_route`` of its function (autograd
backward, TF32 off) as the control, with each kernel's device ms by kernel name and the
ptxas lines of the f32 MLP kernels the turn built; it sums them over step (c)'s 22 K13
launches (4 at C 96, 4 at C 192, 12 at C 384, 2 at C 768) and the MLP phase's 20 K15
launches (4, 4 and 12).  ``--family attn_f32_bwd`` times the f32 K4 (cosine, with
LayerNorm) and the f32 K17 (cosine) at the three stage shapes of batch 2, masked and
unmasked, on chip_smoke.py's ``check_f32_train_kernels`` operands, each summed over its
step's 20 launches (the f32 K4 over step (b)'s, the f32 K17 over step (a)'s: 2 and 2 at C
96 and C 192, 6 and 6 at C 384), with the f32 K5 (cosine, the bottleneck, one launch of
each mask a step) and the f32 K1 (with LayerNorm) and K16 (cosine) at the stage shapes as
the controls that run the same code in both checkouts; each turn
prints K4's and K17's device ms by kernel over those launches (one traced call a shape,
chip_smoke.py's ``trace``) and the ptxas lines of the f32 backward's kernels its build
compiled.  ``--family all`` (the default) times the first four.

Each shape gets two times: the device time (``device_ms``: each call enqueued behind a
spin kernel, so that the events bracket the device work alone) and a single call's
time (chip_smoke.py's ``median_ms``, the ``ms`` of its kernels line, which takes in
the host's launch path wherever the device finishes first).  Prints each turn's JSON
line, then per kind of time one line per shape with the four times, and each kernel
summed over a train step's launches (at C <= 384 2 unmasked and 2 masked at C 96 and
C 192, 6 and 6 at C 384; K2 / K5 one of each) and the MLP kernels over chip_smoke.py's
MLP phase (K12 and K13 4 launches at C 96; K14 and K15 4, 4 and 12 at C 96, 192, 384;
the routes as K12 / K13 and K14 / K15).  Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# launches per (C, masked) in one train step: the blocks at C <= 384 (encoder 2/2/6,
# decoder 6/2/2; K1 and K4 cosine, K16 and K17 scaled-dot), the two at C 768 (K2, K5)
STEP_LAUNCHES = {(96, False): 2, (96, True): 2, (192, False): 2, (192, True): 2,
                 (384, False): 6, (384, True): 6, (768, False): 1, (768, True): 1}
# launches per C in chip_smoke.py's MLP phase: K12 / K13 on the 4 blocks at C 96, K14 /
# K15 on the 20 at C <= 384
BLOCK_LAUNCHES = {96: 4, 192: 4, 384: 12}
MLP_LAUNCHES = {"K12": {96: 4}, "K13": {96: 4}, "K14": BLOCK_LAUNCHES, "K15": BLOCK_LAUNCHES,
                "route-fwd": {96: 4}, "route-bwd": {96: 4}, "route-block-fwd": BLOCK_LAUNCHES,
                "route-block-bwd": BLOCK_LAUNCHES}
# the f32 K13 over step (c)'s 22 blocks (C 96, 192, 384, 768: 4, 4, 12, 2), the f32 K15 over
# the f32 MLP phase's 20 (C <= 384); the routes as their kernels
STEP_C_LAUNCHES = {96: 4, 192: 4, 384: 12, 768: 2}
F32_MLP_LAUNCHES = {"f32-K13": STEP_C_LAUNCHES, "f32-K15": BLOCK_LAUNCHES,
                    "f32-route-bwd": STEP_C_LAUNCHES, "f32-route-block-bwd": BLOCK_LAUNCHES}


def load_smoke():
    """This checkout's chip_smoke.py as a module, whichever heal_swin_torch is first on
    the path (its functions import the package only when called)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def device_ms(fn, runs, warmup=3) -> float:
    """Median of ``runs`` CUDA-event timings of one call of ``fn`` after ``warmup``
    calls, each call enqueued while a spin kernel (``torch.cuda._sleep``, four times
    the call's host-clock time at ~2 GHz) holds the stream, so that the events time
    the device work and not the host's launch path."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cycles = int(4 * max(time.perf_counter() - t0, 1e-4) * 2e9)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def turn(root: Path, family: str) -> dict:
    """This process's turn: the times of the checkout at ``root``, keyed by shape."""
    sys.path.insert(0, str(root))
    import torch

    smoke = load_smoke()
    from heal_swin_torch import _build
    from heal_swin_torch.ops import window_attention as wa

    if Path(wa.__file__).resolve().parents[2] != root.resolve():
        raise RuntimeError(f"imported {wa.__file__}, not the checkout at {root}")
    _build.lib()
    dev = torch.device("cuda", 0)

    def both(fn):
        return [device_ms(fn, smoke.TIMING_RUNS), smoke.median_ms(fn)]

    times = {}
    if family in ("attention", "all"):
        times.update(attention_times(smoke, dev, both))
    if family in ("mlp", "all"):
        times.update(mlp_times(smoke, dev, both))
    if family in ("tail", "all"):
        times.update(tail_times(smoke, dev, both))
    if family in ("f32", "all"):
        times.update(f32_times(smoke, dev, both))
    if family == "tails":
        times.update(tail_times(smoke, dev, both))
    if family in ("tail_f32", "tails"):
        times.update(tail_f32_times(smoke, dev, both))
    if family == "paths":
        times.update(path_times(smoke, dev, both))
    if family == "mlp_f32":
        times.update(mlp_f32_times(smoke, dev, both))
    if family == "attn_f32_bwd":
        times.update(attn_f32_bwd_times(smoke, dev, both))
    torch.cuda.synchronize()
    return times


# the f32 tail's kernels by name: the tile kernels, and an older checkout's row kernels
# and dWe product
F32_TAIL_KERNELS = ("tail_fwd_3xtf32", "tail_bwd_3xtf32", "tail_loss_f32", "tail_bwd_f32",
                    "gemm_tn_f32")


def tail_f32_times(smoke, dev, both) -> dict:
    """The f32 K3, K6-K9 and the f32 routes at the paper configs' tails; for each kernel
    also its device ms by kernel name (labels "split ..."), and the build's ptxas lines of
    the f32 tail kernels (label "ptxas", one string each)."""
    import torch

    from heal_swin_torch import _build
    from heal_swin_torch.ops import final_head as fh

    largs = smoke.paper_tail_inputs(torch.Generator().manual_seed(smoke.SEED + 17), dev)
    dargs = smoke.paper_depth_tail_inputs(torch.Generator().manual_seed(smoke.SEED + 18), dev)
    dargs = dargs[:4] + (dargs[4][:, :1].contiguous(), dargs[5])
    p = smoke.TAIL_P
    T, C = largs[0].shape
    scale = torch.ones((), device=dev) / largs[6].sum()
    dscale = torch.ones((), device=dev) / torch.isfinite(dargs[5]).sum()
    kw = dict(patch_size=p, impl="pallas")
    dkw = dict(kw, loss_kind="l2")
    label = f"C={C} T={T}"
    calls = {"f32-K3": lambda: fh.final_head_predict(*largs[:5], **kw),
             "f32-K6": lambda: fh.final_head_loss_sums(*largs, **kw),
             "f32-K7": lambda: fh.final_head_loss_bwd(*largs, scale, **kw),
             "f32-K8": lambda: fh.final_head_depth_loss_sums(*dargs, **dkw),
             "f32-K9": lambda: fh.final_head_depth_loss_bwd(*dargs, dscale, **dkw)}
    times = {}
    with torch.no_grad():
        for name, fn in calls.items():
            times[f"{name} {label}"] = both(fn)
            per, _ = smoke.trace(fn, smoke.SEQUENCE_TRACED)
            for kname, (ms, _) in per.items():
                times[f"split {name} {kname[:70]}"] = [ms / smoke.SEQUENCE_TRACED] * 2
    times[f"f32-pred-route {label}"] = both(smoke.pred_route(largs[:5], p, torch.float32))
    route_f, route_b = smoke.tail_route(largs, p, torch.float32)
    times[f"f32-tail-route-fwd {label}"] = both(route_f)
    times[f"f32-tail-route-bwd {label}"] = both(route_b)
    del route_f, route_b
    route_f, route_b = smoke.depth_route(dargs, p, torch.float32)
    times[f"f32-depth-route-fwd {label}"] = both(route_f)
    times[f"f32-depth-route-bwd {label}"] = both(route_b)
    times["ptxas"] = ptxas_lines(_build.build_log, lambda n: any(k in n for k in F32_TAIL_KERNELS),
                                 ("tail_", "gemm_"))
    return times


def ptxas_lines(build_log: str, wanted, starts) -> list:
    """The ptxas report's spill and register lines of the kernels whose mangled name
    ``wanted`` takes, each under its name from the first of ``starts`` it holds."""
    name, lines = None, []
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if wanted(line) else None
        elif name and ("spill" in line or "registers" in line):
            i = next((name.find(k) for k in starts if k in name), 0)
            lines.append(f"{name[i:i + 64]}: {line.split(':', 1)[-1].strip()}")
    return lines


def mlp_f32_times(smoke, dev, both) -> dict:
    """The f32 K13 (exact GELU) at the four stage shapes of batch 2, the f32 K15 (exact
    GELU, the batch's DropPath draw) at the three of the MLP phase, and the f32 routes of
    their functions; each kernel's device ms by kernel name (labels "split ..."), and the
    ptxas lines of the f32 MLP kernels (label "ptxas")."""
    import torch

    from heal_swin_torch import _build
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(smoke.SEED + 51)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    times = {}
    for T, C in smoke.mlp_stages():
        args, dz, ds = smoke.f32_mlp_inputs(rnd, dev, T, C, smoke.BATCH)
        a5, label = args[:5], f"C={C} T={T}"
        kw = dict(approximate=False, impl="pallas")
        calls = {"f32-K13": lambda: tm.mlp_bwd(*a5, dz, **kw)}
        if C in BLOCK_LAUNCHES:
            calls["f32-K15"] = lambda: tm.mlp_block_bwd(*args, ds, dz, **kw)
        with torch.no_grad():
            for name, fn in calls.items():
                times[f"{name} {label}"] = both(fn)
                per, _ = smoke.trace(fn, smoke.SEQUENCE_TRACED)
                for kname, (ms, n) in per.items():
                    short = kname.replace("hs::(anonymous namespace)::", "")[:60]
                    times[f"split {name} {label} {short} x{n / smoke.SEQUENCE_TRACED:.0f}"] = \
                        [ms / smoke.SEQUENCE_TRACED] * 2
        _, route_b = smoke.mlp_route(args, None, False, block=False)
        times[f"f32-route-bwd {label}"] = both(route_b)
        del route_b
        if C in BLOCK_LAUNCHES:
            _, route_b = smoke.mlp_route(args, ds, False, block=True)
            times[f"f32-route-block-bwd {label}"] = both(route_b)
            del route_b
        del args, dz, ds
        torch.cuda.empty_cache()
    times["ptxas"] = ptxas_lines(_build.build_log, lambda n: "_mlp_f32_cu_" in n,
                                 ("gemm_", "mlp_ln_"))
    return times


def attn_f32_bwd_times(smoke, dev, both) -> dict:
    """The f32 K4 (cosine, with LayerNorm) and the f32 K17 (cosine) at the three stage
    shapes of batch 2, masked and unmasked, on ``check_f32_train_kernels``' operands (its
    seed and draws: the bf16 draws of ``stage_inputs`` taken to f32), and the f32 K5
    (cosine) at the bottleneck, masked and unmasked, and the f32 K1 (with LayerNorm) and
    K16 (cosine) at the stage shapes, as the controls: the same code in both checkouts.  Each call of K4 and K17 traced by kernel (label "by kernel": for each
    call's label, kernel -> [device ms, launches] a call, ``per_call_by_kernel``); the ptxas
    lines of the f32 backward's kernels (label "ptxas")."""
    import torch

    from heal_swin_torch import _build
    from heal_swin_torch.ops import window_attention as wa

    rnd, logit_scales = smoke.seeded_draws(torch.Generator().manual_seed(smoke.SEED + 40), dev)
    times, by_kernel = {}, {}
    with torch.no_grad():
        for stage in range(3):
            T, C, h, args = smoke.stage_inputs(rnd, logit_scales, stage, dev)
            x, wq, bq, wp, bp, g, b, bias, ls, groups = (
                a.float() if a.dtype == torch.bfloat16 else a for a in args)
            dz = rnd(T, C)
            for masked in (False, True):
                gr = groups if masked else None
                kw = dict(ws=smoke.WS, num_heads=h, has_mask=masked, impl="pallas")
                label = f"C={C} T={T} mask={masked}"
                calls = {
                    "f32-K4": lambda: wa.window_attention_qkv_epi_bwd(
                        x, wq, bq, wp, bp, g, b, gr, bias, ls, dz, sm_scale=1.0, **kw),
                    "f32-K17": lambda: wa.window_attention_qkv_bwd(
                        x, wq, bq, gr, bias, ls, dz, use_cos=True, sm_scale=smoke.DOT_SCALE,
                        **kw)}
                for name, fn in calls.items():
                    times[f"{name} {label}"] = both(fn)
                    by_kernel[f"{name} {label}"] = smoke.per_call_by_kernel(
                        smoke.trace(fn, smoke.SEQUENCE_TRACED)[0])[0]
                times[f"f32-K1 {label}"] = both(lambda: wa.window_attention_qkv_epi_fwd(
                    x, wq, bq, wp, bp, g, b, gr, bias, ls, sm_scale=1.0, **kw))
                times[f"f32-K16 {label}"] = both(lambda: wa.window_attention_qkv_fwd(
                    x, wq, bq, gr, bias, ls, use_cos=True, sm_scale=smoke.DOT_SCALE, **kw))
            del x, dz, args
            torch.cuda.empty_cache()
        T, C, h, (qkv, bias, ls, groups, dout) = smoke.bottleneck_inputs(rnd, logit_scales, dev)
        qkv, dout = qkv.float(), dout.float()
        for masked in (False, True):
            kw = dict(ws=smoke.WS, num_heads=h, use_cos=True, sm_scale=smoke.DOT_SCALE,
                      has_mask=masked, impl="pallas")
            a = (qkv, groups if masked else None, bias, ls)
            times[f"f32-K5 C={C} T={T} mask={masked} cosine"] = both(
                lambda: wa.window_attention_bwd(*a, dout, **kw))
    times["by kernel"] = by_kernel
    times["ptxas"] = ptxas_lines(_build.build_log, lambda n: "_window_attention_bwd_f32_cu_" in n,
                                 ("gemm_", "attn_", "ln_"))
    return times


def attn_f32_bwd_breakdown(t: dict, kernel: str) -> dict:
    """A turn's f32 K4 or K17 device ms and launches by kernel, summed over a train
    step's launches (STEP_LAUNCHES: step (b)'s f32 K4, step (a)'s f32 K17)."""
    total = {}
    for label, per in t["by kernel"].items():
        name, shape, _, mask = label.split()
        if name != kernel:
            continue
        n = STEP_LAUNCHES[(int(shape[2:]), mask == "mask=True")]
        for short, (ms, cnt) in per.items():
            ms0, cnt0 = total.get(short, (0.0, 0.0))
            total[short] = (ms0 + n * ms, cnt0 + n * cnt)
    return total


def tail_times(smoke, dev, both) -> dict:
    """K3, K6, K7, K8, K9 at the paper tail, and the three routes."""
    import torch

    from heal_swin_torch.ops import final_head as fh

    rnd, _ = smoke.seeded_draws(torch.Generator().manual_seed(smoke.SEED + 9), dev)
    gen = torch.Generator().manual_seed(smoke.SEED + 10)
    largs = smoke.tail_inputs(rnd, gen, dev)
    p = smoke.TAIL_P
    T, C = largs[0].shape
    scale = torch.ones((), device=dev) / largs[6].sum()
    dargs = largs[:4] + (rnd(C, 1, std=0.1), smoke.depth_targets(gen, T, p, dev))
    kw = dict(patch_size=p, impl="pallas")
    dkw = dict(kw, loss_kind="l2")
    label = f"C={C} T={T}"
    times = {}
    with torch.no_grad():
        times[f"K3 {label}"] = both(lambda: fh.final_head_predict(*largs[:5], **kw))
        times[f"K6 {label}"] = both(lambda: fh.final_head_loss_sums(*largs, **kw))
        times[f"K7 {label}"] = both(lambda: fh.final_head_loss_bwd(*largs, scale, **kw))
        times[f"K8 {label}"] = both(lambda: fh.final_head_depth_loss_sums(*dargs, **dkw))
        times[f"K9 {label}"] = both(lambda: fh.final_head_depth_loss_bwd(*dargs, scale, **dkw))
    times[f"pred-route {label}"] = both(smoke.pred_route(largs[:5], p))
    route_f, route_b = smoke.tail_route(largs, p)
    times[f"tail-route-fwd {label}"] = both(route_f)
    times[f"tail-route-bwd {label}"] = both(route_b)
    del route_f, route_b
    route_f, route_b = smoke.depth_route(dargs, p)
    times[f"depth-route-fwd {label}"] = both(route_f)
    times[f"depth-route-bwd {label}"] = both(route_b)
    return times


# the paths' tails and the bf16 heads of one chunk: (dtype, C, F), T 262,144, p 4
PATH_TAILS = (("bf16", 128, 10), ("f32", 96, 25), ("bf16", 96, 25), ("bf16", 96, 32))


def path_times(smoke, dev, both) -> dict:
    """K3, K6 and K7 at the paths' tails (PATH_TAILS), on seeded ``width_inputs``."""
    import torch

    from heal_swin_torch.ops import final_head as fh

    T, p = 262144, 4
    times = {}
    for dt, C, F in PATH_TAILS:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        gen = torch.Generator().manual_seed(smoke.SEED + C + F)
        largs = smoke.width_inputs(gen, dev, T, C, F, p, dtype)
        scale = torch.ones((), device=dev) / largs[6].sum()
        kw = dict(patch_size=p, impl="pallas")
        label = f"{dt} C={C} F={F} T={T}"
        with torch.no_grad():
            times[f"K3 {label}"] = both(lambda: fh.final_head_predict(*largs[:5], **kw))
            times[f"K6 {label}"] = both(lambda: fh.final_head_loss_sums(*largs, **kw))
            times[f"K7 {label}"] = both(lambda: fh.final_head_loss_bwd(*largs, scale, **kw))
        del largs
    return times


def f32_times(smoke, dev, both) -> dict:
    """The f32 K1 at the three stage shapes, the f32 K2 and the f32 SDPA at the
    bottleneck, on ``check_f32_eval_kernels``' operands (drawn in its order)."""
    import torch

    from heal_swin_torch.ops import window_attention as wa

    def f32(args):
        return tuple(a.float() if a.dtype == torch.bfloat16 else a for a in args)

    rnd, logit_scales = smoke.seeded_draws(torch.Generator().manual_seed(smoke.SEED + 20), dev)
    times = {}
    with torch.no_grad():
        for stage in range(3):
            T, C, h, args = smoke.stage_inputs(rnd, logit_scales, stage, dev)
            x, wq, bq, wp, bp, g, b, bias, ls, grp = f32(args)
            for masked in (False, True):
                a = (x, wq, bq, wp, bp, g, b, grp if masked else None, bias, ls)
                kw = dict(ws=smoke.WS, num_heads=h, sm_scale=(C // h) ** -0.5,
                          has_mask=masked, impl="pallas")
                times[f"f32-K1 C={C} T={T} mask={masked}"] = both(
                    lambda: wa.window_attention_qkv_epi(*a, **kw))
            if hasattr(wa, "gemm_nn_f32"):  # the sequence's steps alone, where exposed
                qkv = wa.gemm_nn_f32(x, wq, bq)
                akw = dict(ws=smoke.WS, num_heads=h, use_cos=True, sm_scale=1.0,
                           has_mask=True, impl="pallas")
                o = wa.window_attention(qkv, grp, bias, ls, **akw)
                times[f"f32-K1-qkv C={C} T={T} step"] = both(lambda: wa.gemm_nn_f32(x, wq, bq))
                times[f"f32-K1-attention C={C} T={T} step"] = both(
                    lambda: wa.window_attention(qkv, grp, bias, ls, **akw))
                times[f"f32-K1-proj C={C} T={T} step"] = both(lambda: wa.gemm_nn_f32(o, wp, bp))
                del qkv, o
            del x, args
        T, C, h, (qkv, bias, ls, grp, _) = smoke.bottleneck_inputs(rnd, logit_scales, dev)
        qkv = qkv.float()
        for masked in (False, True):
            for use_cos in (True, False):
                a = (qkv, grp if masked else None, bias, ls if use_cos else None)
                kw = dict(ws=smoke.WS, num_heads=h, use_cos=use_cos, sm_scale=smoke.DOT_SCALE,
                          has_mask=masked, impl="pallas")
                flavour = "cosine" if use_cos else "scaled-dot"
                times[f"f32-K2 C={C} T={T} mask={masked} {flavour}"] = both(
                    lambda: wa.window_attention(*a, **kw))
            lib_f, _ = smoke.sdpa_library(qkv, grp if masked else None, bias, h,
                                          torch.zeros(T, C, device=dev))
            times[f"f32-SDPA C={C} T={T} mask={masked} scaled-dot"] = both(lib_f)
    return times


def mlp_times(smoke, dev, both) -> dict:
    """K12-K15 and the routes at the four stage shapes, tanh GELU."""
    import torch

    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(smoke.SEED + 7)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    times = {}
    for T, C in smoke.mlp_stages():
        args, dz, ds = smoke.mlp_inputs(rnd, dev, T, C)
        a5 = args[:5]
        kw = dict(approximate=True, impl="pallas")
        label = f"C={C} T={T}"
        with torch.no_grad():
            times[f"K12 {label}"] = both(lambda: tm.mlp_fwd(*a5, **kw))
            times[f"K13 {label}"] = both(lambda: tm.mlp_bwd(*a5, dz, **kw))
            times[f"K14 {label}"] = both(lambda: tm.mlp_block_fwd(*args, ds, **kw))
            times[f"K15 {label}"] = both(lambda: tm.mlp_block_bwd(*args, ds, dz, **kw))
        for name, d, block in (("route", None, False), ("route-block", ds, True)):
            route_f, route_b = smoke.mlp_route(args, d, True, block=block)
            times[f"{name}-fwd {label}"] = both(route_f)
            times[f"{name}-bwd {label}"] = both(route_b)
        del args, dz, ds, route_f, route_b
        torch.cuda.empty_cache()
    return times


def attention_times(smoke, dev, both) -> dict:
    """K1, K4, K16, K17 at the three stage shapes, K2, K5 and SDPA at the bottleneck."""
    import torch

    from heal_swin_torch.ops import window_attention as wa

    rnd, logit_scales = smoke.seeded_draws(torch.Generator().manual_seed(smoke.SEED), dev)
    times = {}
    for stage in range(3):
        T, C, h, (x, wq, bq, wp, bp, g, b, bias, ls, grp) = smoke.stage_inputs(
            rnd, logit_scales, stage, dev)
        for masked in (False, True):
            groups = grp if masked else None
            args = (x, wq, bq, wp, bp, g, b, groups, bias, ls)
            kw = dict(ws=smoke.WS, num_heads=h, sm_scale=(C // h) ** -0.5, has_mask=masked,
                      impl="pallas")
            label = f"C={C} T={T} mask={masked}"
            times[f"K1 {label}"] = both(lambda: wa.window_attention_qkv_epi(*args, **kw))
            dz = rnd(T, C).to(torch.bfloat16)
            times[f"K4 {label}"] = both(lambda: wa.window_attention_qkv_epi_bwd(*args, dz, **kw))
            qargs = (x, wq, bq, groups, bias, None)
            qkw = dict(ws=smoke.WS, num_heads=h, use_cos=False, sm_scale=smoke.DOT_SCALE,
                       has_mask=masked, impl="pallas")
            times[f"K16 {label}"] = both(lambda: wa.window_attention_qkv_fwd(*qargs, **qkw))
            times[f"K17 {label}"] = both(
                lambda: wa.window_attention_qkv_bwd(*qargs, dz, **qkw))
        del x, dz
    T, C, h, (qkv, bias, ls, grp, dout) = smoke.bottleneck_inputs(rnd, logit_scales, dev)
    for masked in (False, True):
        for use_cos in (True, False):
            args = (qkv, grp if masked else None, bias, ls if use_cos else None)
            kw = dict(ws=smoke.WS, num_heads=h, use_cos=use_cos, sm_scale=smoke.DOT_SCALE,
                      has_mask=masked, impl="pallas")
            flavour = "cosine" if use_cos else "scaled-dot"
            times[f"K2 C={C} T={T} mask={masked} {flavour}"] = both(
                lambda: wa.window_attention(*args, **kw))
            times[f"K5 C={C} T={T} mask={masked} {flavour}"] = both(
                lambda: wa.window_attention_bwd(*args, dout, **kw))
        lib_f, _ = smoke.sdpa_library(qkv, grp if masked else None, bias, h, dout)
        times[f"SDPA C={C} T={T} mask={masked} scaled-dot"] = both(lib_f)
    return times


def step_ms(times: dict, kernel: str, which: int, flavour: str = "scaled-dot") -> float:
    """A kernel's ms over a train step's launches (which: 0 device, 1 single call); K2
    and K5 in ``flavour`` (the scaled-dot step's, or the cosine step's)."""
    total = 0.0
    for label, ms in times.items():
        if len(label.split()) < 4:  # an MLP label
            continue
        name, shape, _, mask, *rest = label.split()
        if name == kernel and rest in ([], [flavour]):
            total += STEP_LAUNCHES[(int(shape[2:]), mask == "mask=True")] * ms[which]
    return total


def predict_step_ms(times: dict, step: str, which: int) -> float:
    """A step of the f32 K1 (qkv, attention, proj) over the paper predict's 20 launches
    (4 at C 96, 4 at C 192, 12 at C 384); 0 where the checkout exposes no steps."""
    total = 0.0
    for label, ms in times.items():
        name, shape, *_ = label.split()
        if name == f"f32-K1-{step}":
            total += {96: 4, 192: 4, 384: 12}[int(shape[2:])] * ms[which]
    return total


def mlp_phase_ms(times: dict, kernel: str, which: int, launches=MLP_LAUNCHES) -> float:
    """An MLP kernel's (or the route's) ms over chip_smoke.py's MLP phase launches (or
    over ``launches``: kernel -> launches per C)."""
    total = 0.0
    for label, ms in times.items():
        name, *shape_rest = label.split()
        if name == kernel and len(shape_rest) == 2:
            total += launches[kernel].get(int(shape_rest[0][2:]), 0) * ms[which]
    return total


def compare(label, runs, get):
    o = [get(t) for w, t in runs if w == "other"]
    c = [get(t) for w, t in runs if w == "this"]
    if not all(o):  # a step the other checkout does not expose
        return f"{label}: this {c[0]:.4f} / {c[1]:.4f} ms (other: none)"
    return (f"{label}: other {o[0]:.4f} / {o[1]:.4f} ms, this {c[0]:.4f} / {c[1]:.4f} ms, "
            f"this / other {statistics.mean(c) / statistics.mean(o):.3f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="the other checkout (e.g. the parent)")
    ap.add_argument("--family", choices=("attention", "mlp", "tail", "f32", "tail_f32", "tails",
                                         "paths", "mlp_f32", "attn_f32_bwd", "all"),
                    default="all",
                    help="which kernels to time (default: all)")
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.turn is not None:
        print(json.dumps({"root": str(a.turn), "times": turn(a.turn, a.family)}), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("attention_pair_timing: no CUDA device", file=sys.stderr)
        return 1
    other = a.other.resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    order = [("other", other), ("this", HERE), ("this", HERE), ("other", other)]
    runs = []
    for who, root in order:
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn", str(root),
                              "--family", a.family],
                             capture_output=True, text=True, env=dict(os.environ))
        if out.returncode != 0:
            print(out.stdout, out.stderr, sep="\n", file=sys.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(f"{who}: {line}", flush=True)
        runs.append((who, json.loads(line)["times"]))
    for who, t in runs:  # the f32 tail's split by kernel and ptxas report, turn by turn
        for label, v in t.items():
            if label == "ptxas":
                for line in v:
                    print(f"{who} ptxas {line}")
            elif label.startswith("split "):
                print(f"{who} {label}: {v[0]:.4f} ms a call on the device")
    if a.family == "attn_f32_bwd":  # the f32 K4's and K17's sequences by kernel, turn by turn
        for who, t in runs:
            for kernel, step in (("f32-K4", "(b)"), ("f32-K17", "(a)")):
                total = attn_f32_bwd_breakdown(t, kernel)
                print(f"{who} {kernel} over step {step}'s 20 launches by kernel: "
                      f"{sum(ms for ms, _ in total.values()):.4f} ms on the device")
                for short, (ms, cnt) in sorted(total.items(), key=lambda kv: -kv[1][0]):
                    print(f"{who} {kernel} {ms:9.4f} ms {cnt:6.1f} launches  {short}")
    for which, kind in enumerate(("on the device", "a single call")):
        print(f"-- {kind}")
        for label in runs[1][1]:
            if label not in ("ptxas", "by kernel") and not label.startswith("split "):
                print(compare(label, runs, lambda t: t[label][which] if label in t else None))
        if a.family in ("attention", "all"):
            for kernel, n, flavour in (("K1", 20, ""), ("K4", 20, ""), ("K16", 20, ""),
                                       ("K17", 20, ""), ("K2", 2, "scaled-dot"),
                                       ("K5", 2, "scaled-dot"), ("K2", 2, "cosine"),
                                       ("K5", 2, "cosine")):
                print(compare(f"{kernel} {flavour} over a train step's {n} launches".replace(
                    "  ", " "), runs,
                    lambda t: step_ms(t, kernel, which, flavour or "scaled-dot")))
        if a.family in ("f32", "all"):
            for kernel, n, flavour in (("f32-K1", 20, ""), ("f32-K2", 2, "cosine"),
                                       ("f32-K2", 2, "scaled-dot"),
                                       ("f32-SDPA", 2, "scaled-dot")):
                print(compare(f"{kernel} {flavour} over the paper predict's {n} launches"
                              .replace("  ", " "), runs,
                              lambda t: step_ms(t, kernel, which, flavour or "scaled-dot")))
            for step in ("qkv", "attention", "proj"):
                print(compare(f"f32-K1's {step} step over the paper predict's 20 launches",
                              runs, lambda t: predict_step_ms(t, step, which)))
        if a.family in ("mlp", "all"):
            for kernel, per_c in MLP_LAUNCHES.items():
                print(compare(f"{kernel} over the MLP phase's {sum(per_c.values())} launches",
                              runs, lambda t: mlp_phase_ms(t, kernel, which)))
        if a.family == "attn_f32_bwd":
            for kernel, n, step, flavour in (("f32-K4", 20, "step (b)'s", ""),
                                             ("f32-K17", 20, "step (a)'s", ""),
                                             ("f32-K5", 2, "a step's", "cosine"),
                                             ("f32-K1", 20, "step (b)'s", ""),
                                             ("f32-K16", 20, "step (a)'s", "")):
                print(compare(f"{kernel} over {step} {n} launches", runs,
                              lambda t: step_ms(t, kernel, which, flavour or "scaled-dot")))
        if a.family == "mlp_f32":
            for kernel, per_c in F32_MLP_LAUNCHES.items():
                where = "step (c)'s" if per_c is STEP_C_LAUNCHES else "the MLP phase's"
                print(compare(f"{kernel} over {where} {sum(per_c.values())} launches", runs,
                              lambda t: mlp_phase_ms(t, kernel, which, F32_MLP_LAUNCHES)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
