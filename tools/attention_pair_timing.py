"""Time the window-attention and MLP kernels of two checkouts of heal_swin_torch on one
GPU, in turns: other, this, this, other.

    python3 tools/attention_pair_timing.py --other _checkout/parent \
        [--family mlp|tail|f32|tail_f32]

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
kernels its build compiled.  ``--family all`` (the default) times the first four.

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
    if family == "tail_f32":
        times.update(tail_f32_times(smoke, dev, both))
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
    name, ptxas = None, []
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in F32_TAIL_KERNELS if k in line), None) and line.split("'")[1]
        elif name and ("spill" in line or "registers" in line):
            i = name.find("tail_") if "tail_" in name else name.find("gemm_")
            ptxas.append(f"{name[i:i + 48]}: {line.split(':', 1)[-1].strip()}")
    times["ptxas"] = ptxas
    return times


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


def mlp_phase_ms(times: dict, kernel: str, which: int) -> float:
    """An MLP kernel's (or the route's) ms over chip_smoke.py's MLP phase launches."""
    total = 0.0
    for label, ms in times.items():
        name, shape, *rest = label.split()
        if name == kernel and not rest[1:]:
            total += MLP_LAUNCHES[kernel].get(int(shape[2:]), 0) * ms[which]
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
    ap.add_argument("--family", choices=("attention", "mlp", "tail", "f32", "tail_f32", "all"),
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
    for which, kind in enumerate(("on the device", "a single call")):
        print(f"-- {kind}")
        for label in runs[1][1]:
            if label != "ptxas" and not label.startswith("split "):
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
