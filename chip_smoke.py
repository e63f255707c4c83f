"""On-GPU smoke check of heal_swin_torch: builds the CUDA kernels from the checkout,
holds each against its plain PyTorch version at the shapes of the main path (K4, a
launch sequence, also step by step: its projection/LayerNorm backward alone, and
one-hot probes that K4 and K5 recompute K1's and K2's probabilities, K13 K12's
hidden and K15 K14's LayerNorm xhat bit for bit; K7 and K9, launch sequences too, step
by step, and probes through the kernels' logits taps that K7 recomputes K6's logits and
K9 K8's f32 logits bit for bit, and that K3's classes are the argmax of its f32 logits,
which rounded to bf16 are K6's), then
drives HEAL-SWIN-UNet at the paper configuration (nside 256, batch 2, bf16, random
seeded weights) through the kernels and through the plain path: segmentation
``predict`` (serving) and its train step (forward, weighted CE, backward, Adam), and
the depth task's ``predict`` and train step (masked l2 loss on standardized depths
with background marked inf); then the paper's depth Chamfer evaluation: the depth
model predicts 4 images, and the Chamfer writer scores them on its four variants
through the brute (K10) and neighbour-pruned (K11) Chamfer folds; then the MLP family
(K12-K15: fc1 -> GELU -> fc2 and the v2 MLP branch x + dscale * LN(mlp(x)), forward
and backward) at every stage shape and on the paper model's own blocks; then the same
segmentation model with scaled-dot attention (``use_cos_attn=False``, the config's
default flavour), whose blocks at C <= 384 run the fused-qkv window attention (K16
forward, K17 backward): its predict and train step through both paths; then the paper
segmentation config's own train step (``heal_swin_torch.run_configs``: float32, dropout
and attention dropout 0.1, DropPath 0.1, 8 classes, Adam at the paper rate; nside 256,
batch 2): the f32 K6/K7 against their plain versions at its tail, then its train step
through both paths on the same dropout masks (attention dropout sends every block to
the plain XLA route, so the f32 K6/K7 are its only kernels); then the depth paper
config's own train step (``paper_depth_config``: the same network in float32 with one
output channel, the masked l2 loss on standardized depths, Adam at 0.005): the f32 K8/K9
against their plain versions at its tail for every loss kind and head, then its train
step through both paths on the same dropout masks (the f32 K8/K9 its only kernels); then
both paper configs' f32 forward in eval mode, where no dropout is active and every block
runs the f32 window-attention kernels: the f32 K1 (a launch sequence), K2 and K3 against
their plain versions at every paper shape, each config's predict and its validation
(``training.trainer.run_validation``, 3 batches) through both paths, and the Chamfer
writer through the predict loop (``training.trainer.predict``); then f32 training with
attention dropout off (``drive_f32_attention_train``): the f32 K16, K17, K4 and K5 against
their plain versions at every stage shape (cosine and scaled-dot, masked and unmasked, on
HEALPix and flat operands), then the paper segmentation config's train step with
attention dropout 0 through both paths, (a) with proj dropout 0.1 (the blocks at C <= 384
on f32 K16 / K17) and (b) with dropout 0 too (f32 K1 / K4), the bottleneck on f32 K2 /
K5 in both; then ``Trainer.fit`` of
both paper configs on the port's synthetic HEALPix datamodule (``drive_fit``: two
uninterrupted 2-epoch runs, and a 1-epoch run resumed from its checkpoint and held to
them, with their launches, tracked metrics and checkpoint files); then the real input
path and the run entry (``drive_run_entry``: generated 966 x 1280 WoodScape and
SynWoodScape fixtures, the on-device fisheye -> HEALPix projection held to the host npz
pipeline, ``Trainer.lr_find``, and ``python3 -m heal_swin_torch.cli train`` / ``resume``
of the port's bf16 convergence config, with its ``eval_after_train``, and ``train`` of its
f32 depth config, each in a child process whose launches are counted); then the
evaluation entry (``drive_evaluate``: ``python3 -m heal_swin_torch.cli evaluate`` of both
runs in child processes, the paper's back-projected HP-masked IoU with and without the
masked IoU, and the depth Chamfer evaluation; the depth Chamfer writer again in this
process, each of its pairs held to the other route and K10 / K11 to their plain versions;
the headline writer's metrics again in this process through the kernels and through the
plain route); and last the kernels'
refusal: small f32 models at window 64 (scaled-dot, and cosine in training) run through the
f32 kernels, held to "xla"; what the kernels do not take (a bf16 window-16 model with 40
classes, an f32 tail at C 48, the fused MLP on f32 tokens) raises under "auto" with no
launch, and runs the plain versions under "xla".

The flat SWIN-UNet baseline (the JAX package's ``swin_flat.py``: bench.py's ``swin`` and
``depth_swin`` cells in bf16, and the paper flat configs in f32; 640 x 768 images, patch
2, 8 x 8 windows, batch 2, full width and depth) runs in three phases of its own:
``drive_flat`` after the scaled-dot phase (K1, K4, K2, K5, K3, K6, K7 against their plain
versions on its 9-region masks and 2-D rel-pos bias, its predict, its segmentation and
depth train steps through both paths; the depth tail is unfused, so no K8 / K9),
``drive_flat_paper`` after the fit phase (the f32 kernels at its shapes, the paper
segmentation config's train step, both paper configs' predict against "xla", and
``Trainer.fit`` of both with a resume), and ``drive_flat_entry`` after the evaluation
phase (``cli train`` of a wrapper of the port's copy of the paper flat segmentation config
on the WoodScape fixture, ``cli evaluate`` with the flat headline ``hp_masked_iou`` and with
``val_on_hp_projected``, the headline writer through the kernels against the plain route,
and the flat depth Chamfer writer on one sample, every pair held to the other route and
K10 / K11 to their plain versions).  Their kernels' entries in the results line are named
"flat <kernel>".

    python3 chip_smoke.py            # needs one CUDA GPU; exits non-zero otherwise

(``python3 chip_smoke.py --entry-child COUNTS -- <cli arguments>`` is the run-entry and
evaluation phases' child: ``python3 -m heal_swin_torch.cli <cli arguments>``, then its launch
counters written to COUNTS.)

Prints its findings line by line, a JSON line of per-kernel results, and ends with
{"ok": true, "device": {...}}.  Any failed check raises, so the exit code is non-zero.

The kernels' launch counters (``launches``, and ``launches_by_shape`` per operand
shape) are set to 0 just before each driven call (a segmentation predict, a
segmentation train step, a depth predict, a depth train step, the Chamfer writer's
batch, the MLP phase's blocks, the scaled-dot predict and train step) and read just
after; each kernel's ``launches`` in the results line comes from the run that uses it
(the segmentation train step for K1, K4, K6, K7; segmentation predict for K3; the
depth train step for K8, K9; the writer for K10, K11; the MLP phase for K12-K15, which
no configuration's train step or predict launches; the scaled-dot train step for K2,
K5, K16, K17; the paper config's f32 train step for the f32 K6 and K7, and the depth
paper config's for the f32 K8 and K9, the paper segmentation config's predict for the f32
K1, K2 and K3, and the f32 attention training step of variant (a) for the f32 K16, K17 and
K5, of (b) for the f32 K4, whose ``bound_ms`` takes the 3xTF32 rate, a third of the TF32 peak, and
which add ``device_ms``, one call's device time (``spin_ms``), and, for the tails,
``route_ms``, the composed PyTorch route in f32; the f32 K2's ``library_ms`` is one f32
``scaled_dot_product_attention`` on its operands, in the scaled-dot flavour).  For K1-K9
and K12-K15 ``ms`` / ``plain_ms`` / ``bound_ms`` are sums, over
the shapes that run launched the kernel at, of one call's median time (its plain
version's; the least time the card could take, from the shapes) times the number of
such launches; K12-K15 add ``route_ms``, the port's composed cuBLAS / ATen route, and
K16/K17 ``route_ms``, the composed PyTorch route of their scaled-dot function (bf16
``F.linear`` + ``scaled_dot_product_attention``, autograd backward); K2/K5 (timed in
the scaled-dot flavour of that step, the cosine flavour beside it) add ``library_ms``,
one ``scaled_dot_product_attention`` call (forward; backward); K3 adds ``route_ms``, the
composed PyTorch route (bf16 ``F.linear``, ``F.layer_norm``, ``F.linear``, ``argmax``:
``pred_route``); K6 / K7 add ``route_ms``,
the composed PyTorch route (bf16 ``F.linear``, ``F.layer_norm``, ``F.linear``, weighted
``F.cross_entropy`` and ``torch.bincount``; its autograd backward), and K8 / K9 the same
route with the masked l2 loss in place of the cross entropy (``depth_route``).  For K10 / K11
``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` cover the same work: sample 0's
HP pair (chamfer_distance) for K10 (the library call there is ``torch.cdist`` in its inexact
matrix-multiply form, then the minima), and the folds of its pruned
full_res_hp_masked pair for K11 (no PyTorch call folds a tile-pair list: null);
``writer_ms`` is their device time over the writer's whole run (torch.profiler), and
``mid`` holds their times at a mid-size pair, with ``torch.cdist`` there in its exact
difference form too.  torch.profiler traces of predict and of both train steps
give the device time by kernel and the device's idle share.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BATCH = 2
NSIDE = 256
N_CLASSES = 10
WS = 64
REL_L2_TOL = 1e-2  # kernel vs plain, one kernel call or one block, bf16 (check_close)
LOSS_REL_TOL = 1e-3  # K6's loss vs its plain version's
SLICE_REL_L2_TOL = 5e-2  # tail=False features after 22 blocks (see check_slice)
# K4's projection/LayerNorm backward alone (``qkv_epi_proj_ln_bwd``) against its plain
# version: one product and the LayerNorm's f32 sums in another order, du rounded to bf16
# (as gemm_nt's limit in the GPU tests)
PROJ_LN_REL_L2_TOL = 1e-3
# K12-K15 against their plain versions at the paper stage shapes, every output and
# gradient: about three times the largest relative L2 an H100 showed (3.1e-4, 3.2e-4,
# 3.5e-4, 1.3e-3; PERF.md).  K14 / K15 are held on the branch (z - x, dx - dz), which
# the residual would otherwise hide.
MLP_REL_L2_TOL = {"mlp_fwd": 1e-3, "mlp_bwd": 1e-3, "mlp_block_fwd": 1e-3,
                  "mlp_block_bwd": 4e-3}
# K13 / K15's f32 db1 (the sum of the unrounded dh), which the bf16 outputs cannot
# give: within this of the plain version of its own GELU and further than this from
# the other GELU's.  An H100 showed 3.4e-7 / 4.2e-4 for K13 and, where the bf16
# rounding of du flips, 5.7e-5 / 9.6e-4 for K15 at stage 0.
GELU_DB1_TOL = {"mlp_bwd": 2e-6, "mlp_block_bwd": 2e-4}
TIMING_RUNS = 20
PROFILE_PREDICTS = 5
TRAIN_STEPS = 5
PROFILE_STEPS = 2
LEARNING_RATE = 9.55e-4  # the JAX package's bench.py train rate
BACKGROUND = 0.35  # share of depth targets marked inf (bench.py's depth cell)
# K8/K9's loss kinds and output channels checked at the paper tail; the depth train
# step launches the first (the paper config: l2, one channel)
DEPTH_CASES = (("l2", 1), ("l1", 1), ("huber", 1), ("nll", 2), ("l2", 2))
HUBER_DELTA = 1.0
# the depth Chamfer evaluation: the depth run config's pred_batch_size, WoodScape's
# frame, one calibration per camera, a 190-degree lens, a sky band
CHAMFER_BATCH = 4
FLAT_H, FLAT_W = 966, 1280
CAMS = ("FV", "RV", "MVL", "MVR")
K_SCALE = 460.0  # quartic model scale: the 95-degree ray lands ~660 px off centre
LENS_THETA = math.radians(95.0)
SKY = -0.6  # rays whose image-up component exceeds 0.6 see sky (depth 1000)
MID_POINTS = 65536  # the mid-size pair of the Chamfer kernel checks
NOISE_M = 0.1  # the noise pair: target points and the same points moved by N(0, 0.1 m)
# the card's published peaks (H100 SXM, dense): bf16 tensor cores, f32 outside them,
# device memory
BF16_PEAK = 989e12
F32_PEAK = 67e12
HBM_RATE = 3.35e12
# K10/K11's rate for their 8 FADD/FMUL a point pair: none of them may fuse under the
# bit-equality contract (csrc/chamfer.cu), and F32_PEAK counts an FMA slot as two FLOP
CHAMFER_PEAK = F32_PEAK / 2
DOT_SCALE = 32 ** -0.5  # the scaled-dot flavour's sm_scale: head dim 32
# the flat SWIN-UNet (bench.py's flat cells, the paper flat configs): 640 x 768 images,
# patch 2, 8 x 8 windows shifted by 2
FLAT_IN = (640, 768)
FLAT_PATCH, FLAT_WIN, FLAT_SHIFT = 2, 8, 2


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def check_close(name, got, want, tol=REL_L2_TOL):
    """bf16 kernel vs plain version on the same inputs: both round at the same points,
    so they differ by summation order and the bf16 roundings it flips (~2^-8 on a
    flipped element); relative L2 well under 1e-2."""
    mae = float((got.float() - want.float()).abs().max())
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite values")
    if float(torch.linalg.vector_norm(want.float())) == 0.0:  # e.g. a dropped branch
        if mae != 0.0:
            raise AssertionError(f"{name}: reference is zero, got max abs {mae:.3e}")
        return 0.0, 0.0
    err = rel_l2(got, want)
    if err > tol:
        raise AssertionError(f"{name}: relative L2 {err:.3e} > {tol} (max abs {mae:.3e})")
    return err, mae


def median_ms(fn, runs=TIMING_RUNS, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def spin_ms(fn, runs=TIMING_RUNS, warmup=3) -> float:
    """One call's device time: the median of ``runs`` CUDA-event timings, each call
    enqueued while a spin kernel (``torch.cuda._sleep``, four times the call's host time
    at ~2 GHz) holds the stream, so that the events time the device's work and not the
    host's launch path (``tools/attention_pair_timing.py``'s ``device_ms``; the
    profiler's records of a launch sequence can be dropped)."""
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


def ring_groups(n_tokens_per_image: int) -> torch.Tensor:
    """The paper model's shifted-block mask groups at one stage, tiled over the batch."""
    from heal_swin_torch.models.swin_hp import get_shift_spec

    spec = get_shift_spec("ring_shift", n_tokens_per_image, 8, WS, 4)
    return torch.tensor(np.tile(spec.win_groups, (BATCH, 1)), dtype=torch.int32)


def logit_slack(fh, x, tail):
    """Per-row bound on how far K3's f32 logits can sit from the plain version's when
    the two sum in another order: each z element may round to a neighbouring bf16 value
    (2^-7 relative), so logit j may move by 2^-7 * sum_c |z_c| |Wh_cj|, and the gap of
    two logits by twice the largest of those.  z comes from the plain tail with an
    identity head."""
    we, g, b, wh = tail
    C = x.shape[1]
    eye = torch.eye(C, device=x.device)
    z = fh.final_head_logits_plain(x, we, g, b, eye, patch_size=we.shape[1] // C)
    return 2 * 2.0 ** -7 * (z.abs() @ wh.to(x.dtype).float().abs()).amax(-1)


def preds_agree(name, preds, want, ref_logits, slack):
    """Indices ``preds`` equal the plain version's ``want`` except at near-ties: rows
    whose reference top-2 logit gap is below ``slack`` (per row), where rounding alone
    may reorder the top two.  Returns (differing indices, near-tie rows, the largest
    |preds - want| outside near-ties)."""
    top2 = ref_logits.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < slack
    diff = (preds.long() - want.long()).abs()
    bad = (diff != 0) & ~near
    if int(bad.sum()):
        raise AssertionError(f"{name}: {int(bad.sum())} predictions differ outside near-ties")
    return int((diff != 0).sum()), int(near.sum()), int(diff.masked_fill(near, 0).max())


def repeat_equal(label, got, again):
    """Two launches of a kernel on the same inputs give the same bits."""
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches differ")


def seeded_draws(gen, dev):
    """Draws from ``gen``, put on ``dev``: ``rnd(*shape, std)``, normal, and
    ``logit_scales(h)``, cosine attention's per-head scales perturbed around their
    init (10) and clamped at 100."""
    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    def logit_scales(h):
        return torch.exp(torch.clamp_max(math.log(10.0) + 0.5 * torch.randn(h, generator=gen),
                                         math.log(100.0))).to(dev)

    return rnd, logit_scales


def flat_res(stage):
    """The flat model's token grid at ``stage``: (H, W) of one image."""
    return (FLAT_IN[0] // FLAT_PATCH) >> stage, (FLAT_IN[1] // FLAT_PATCH) >> stage


def flat_groups(stage) -> torch.Tensor:
    """The flat model's shifted-block mask groups at one stage (the 9-region SWIN mask
    of 8 x 8 windows shifted by (2, 2)), tiled over the batch."""
    from heal_swin_torch.models.swin_flat import shift_win_groups

    H, W = flat_res(stage)
    g = shift_win_groups(H, W, FLAT_WIN, FLAT_WIN, FLAT_SHIFT, FLAT_SHIFT)
    return torch.tensor(np.tile(g, (BATCH, 1)), dtype=torch.int32)


def flat_rel_bias(rnd, h):
    """The flat model's (h, 64, 64) rel-pos bias: a (15 * 15, h) table gathered by the
    2-D relative position index, as the flat blocks gather it."""
    from heal_swin_torch.models.swin_flat import rel_pos_index_2d

    table = rnd((2 * FLAT_WIN - 1) ** 2, h, std=0.5)
    idx = torch.as_tensor(rel_pos_index_2d(FLAT_WIN, FLAT_WIN)).to(table.device)
    return table[idx].permute(2, 0, 1).contiguous()


def stage_inputs(rnd, logit_scales, stage, dev, flat=False):
    """K1's and K4's operands at one stage of the blocks at C <= 384 (encoder stages
    0-2, decoder stages 1-3): T, C, heads and (x, Wqkv, bqkv, Wp, bp, LN scale, LN bias,
    rel-pos bias, logit scales, mask groups); with ``flat`` the flat model's stage (its
    token count, 9-region mask groups and 2-D rel-pos bias)."""
    bf16 = torch.bfloat16
    C = 96 * 2 ** stage
    h = C // 32
    if flat:
        T = BATCH * math.prod(flat_res(stage))
    else:
        T = BATCH * 8 * NSIDE * NSIDE // 4 // 4 ** stage
    x = rnd(T, C).to(bf16)
    wq, bq = rnd(C, 3 * C, std=C ** -0.5).to(bf16), rnd(3 * C, std=0.02).to(bf16)
    wp, bp = rnd(C, C, std=C ** -0.5).to(bf16), rnd(C, std=0.02).to(bf16)
    g, b = 1.0 + rnd(C, std=0.1), rnd(C, std=0.1)
    bias = flat_rel_bias(rnd, h) if flat else rnd(h, WS, WS, std=0.5)
    ls = logit_scales(h)
    groups = flat_groups(stage) if flat else ring_groups(T // BATCH)
    return T, C, h, (x, wq, bq, wp, bp, g, b, bias, ls, groups.to(dev))


def bottleneck_inputs(rnd, logit_scales, dev, flat=False):
    """K2's and K5's operands at the C = 768 bottleneck blocks: T, C, heads and (qkv,
    rel-pos bias, logit scales, mask groups, output gradient); ``flat`` as in
    ``stage_inputs``."""
    bf16 = torch.bfloat16
    C, h = 768, 24
    T = BATCH * (math.prod(flat_res(3)) if flat else 8 * NSIDE * NSIDE // 4 // 4 ** 3)
    qkv = rnd(T, 3 * C).to(bf16)
    bias = flat_rel_bias(rnd, h) if flat else rnd(h, WS, WS, std=0.5)
    ls = logit_scales(h)
    groups = (flat_groups(3) if flat else ring_groups(T // BATCH)).to(dev)
    return T, C, h, (qkv, bias, ls, groups, rnd(T, C).to(bf16))


def check_kernels(gen, dev, flat=False):
    """Each kernel against its plain version at the main paths' shapes.  Returns the
    measures of each shape, keyed as the wrappers' ``launches_by_shape`` counters are:
    (kernel, T, C, has_mask) for the attention kernels, (kernel, T, C) for K3, K6, K7,
    (kernel, T, C, F, loss kind) for K8, K9.  With ``flat`` the kernels of the flat
    SWIN-UNet's path (K1, K4, K2, K5, K3, K6, K7) at its shapes, on its 9-region masks
    and 2-D rel-pos bias: 640 x 768 images, patch 2, window 8 x 8."""
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.ops import window_attention as wa

    bf16 = torch.bfloat16
    timed = {}
    rnd, logit_scales = seeded_draws(gen, dev)

    # K1: every block at C <= 384 (encoder stages 0-2, decoder stages 1-3)
    for stage in range(3):
        T, C, h, (x, wq, bq, wp, bp, g, b, bias, ls, groups) = stage_inputs(
            rnd, logit_scales, stage, dev, flat)
        for masked in (False, True):
            args = (x, wq, bq, wp, bp, g, b, groups if masked else None, bias, ls)
            kw = dict(ws=WS, num_heads=h, sm_scale=(C // h) ** -0.5, has_mask=masked)
            got = wa.window_attention_qkv_epi(*args, **kw, impl="pallas")
            want = wa.window_attention_qkv_epi_plain(*args, **kw)
            err, mae = check_close(f"K1 C={C} mask={masked}", got, want)
            repeat_equal(f"K1 C={C} mask={masked}", got,
                         wa.window_attention_qkv_epi(*args, **kw, impl="pallas"))
            ms = median_ms(lambda: wa.window_attention_qkv_epi(*args, **kw, impl="pallas"))
            pms = median_ms(lambda: wa.window_attention_qkv_epi_plain(*args, **kw))
            log(f"K1 window_attention_qkv_epi C={C} T={T} mask={masked}: rel_l2 {err:.3e} "
                f"max_abs {mae:.3e}, two launches bit-equal; kernel {ms:.4f} ms plain "
                f"{pms:.4f} ms")
            timed[("window_attention_qkv_epi", T, C, masked)] = dict(
                rel_l2=err, max_abs_err=mae, ms=ms, plain_ms=pms)

            # K4, its backward (a launch sequence), for an output gradient dz: with
            # LayerNorm, timed and traced by kernel, and without
            dz = rnd(T, C).to(bf16)
            got = wa.window_attention_qkv_epi_bwd(*args, dz, **kw, impl="pallas")
            want = wa.window_attention_qkv_epi_bwd_plain(*args, dz, **kw)
            err, mae = check_grads(f"K4 C={C} mask={masked}", K4_GRADS, got, want)
            again = wa.window_attention_qkv_epi_bwd(*args, dz, **kw, impl="pallas")
            if not all(g is None or torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"K4 C={C} mask={masked}: two launches differ")
            del got, want, again
            nargs = args[:5] + (None, None) + args[7:]
            e0 = check_grads(f"K4 C={C} mask={masked} no LN", K4_GRADS,
                             wa.window_attention_qkv_epi_bwd(*nargs, dz, **kw, impl="pallas"),
                             wa.window_attention_qkv_epi_bwd_plain(*nargs, dz, **kw))
            ms = median_ms(lambda: wa.window_attention_qkv_epi_bwd(*args, dz, **kw,
                                                                   impl="pallas"))
            pms = median_ms(lambda: wa.window_attention_qkv_epi_bwd_plain(*args, dz, **kw))
            per, _ = trace(lambda: wa.window_attention_qkv_epi_bwd(*args, dz, **kw,
                                                                   impl="pallas"), 3)
            log(f"K4 window_attention_qkv_epi_bwd C={C} T={T} mask={masked}: rel_l2 <= "
                f"{err:.3e} max_abs {mae:.3e}, two launches bit-equal; without LayerNorm "
                f"rel_l2 <= {e0[0]:.3e}; kernel {ms:.4f} ms plain {pms:.4f} ms")
            timed[("window_attention_qkv_epi_bwd", T, C, masked)] = dict(
                rel_l2=err, max_abs_err=mae, ms=ms, plain_ms=pms)
            timed[("k4_sequence", T, C, masked)] = {
                name: (dev_ms / 3, n / 3) for name, (dev_ms, n) in per.items()}

    # K2: the C = 768 bottleneck blocks (one unshifted, one shifted), in both flavours;
    # timed in the scaled-dot one (the flavour one PyTorch call also computes) with the
    # cosine one beside it
    T, C, h, (qkv, bias, ls, groups, dout) = bottleneck_inputs(rnd, logit_scales, dev, flat)
    for masked in (False, True):
        res = {}
        for use_cos in (True, False):
            flavour = "cosine" if use_cos else "scaled-dot"
            args = (qkv, groups if masked else None, bias, ls if use_cos else None)
            kw = dict(ws=WS, num_heads=h, use_cos=use_cos, sm_scale=DOT_SCALE, has_mask=masked)
            got = wa.window_attention(*args, **kw, impl="pallas")
            e2 = check_close(f"K2 C={C} mask={masked} {flavour}", got,
                             wa.window_attention_plain(*args, **kw))
            repeat_equal(f"K2 C={C} mask={masked} {flavour}", got,
                         wa.window_attention(*args, **kw, impl="pallas"))
            # K5, its backward, for an output gradient dout
            e5 = check_grads(f"K5 C={C} mask={masked} {flavour}", K5_GRADS,
                             wa.window_attention_bwd(*args, dout, **kw, impl="pallas"),
                             wa.window_attention_bwd_plain(*args, dout, **kw))
            res[use_cos] = dict(
                e2=e2, e5=e5,
                ms2=median_ms(lambda: wa.window_attention(*args, **kw, impl="pallas")),
                pms2=median_ms(lambda: wa.window_attention_plain(*args, **kw)),
                ms5=median_ms(lambda: wa.window_attention_bwd(*args, dout, **kw,
                                                              impl="pallas")),
                pms5=median_ms(lambda: wa.window_attention_bwd_plain(*args, dout, **kw)))
        lib_f, lib_b = sdpa_library(qkv, groups if masked else None, bias, h, dout)
        lms2, lms5 = median_ms(lib_f), median_ms(lib_b)
        if masked:
            log(f"K2/K5 library call: scaled_dot_product_attention ran {sdpa_kernels(lib_f)} "
                f"forward, {sdpa_kernels(lib_b)} backward")
        dot, cos = res[False], res[True]
        for k, name in (("2", "window_attention"), ("5", "window_attention_bwd")):
            log(f"K{k} {name} C={C} T={T} mask={masked}: " + ("two launches bit-equal in "
                "both flavours; " if k == "2" else "") + "scaled-dot rel_l2 "
                f"{dot['e' + k][0]:.3e} max_abs {dot['e' + k][1]:.3e} kernel "
                f"{dot['ms' + k]:.4f} ms plain {dot['pms' + k]:.4f} ms library "
                f"{(lms2, lms5)[k == '5']:.4f} ms; cosine rel_l2 {cos['e' + k][0]:.3e} kernel "
                f"{cos['ms' + k]:.4f} ms plain {cos['pms' + k]:.4f} ms")
            timed[(name, T, C, masked)] = dict(
                rel_l2=dot["e" + k][0], max_abs_err=dot["e" + k][1], ms=dot["ms" + k],
                plain_ms=dot["pms" + k], library_ms=(lms2, lms5)[k == "5"],
                cos_rel_l2=cos["e" + k][0], cos_ms=cos["ms" + k], cos_plain_ms=cos["pms" + k])
    del qkv, dout, lib_f, lib_b
    if not flat:  # K16 / K17 are off the flat path (its blocks are cosine, no proj dropout)
        timed.update(check_qkv_kernels(gen, dev, rnd, logit_scales))

    # K3: the decoder tail, T = 262144 tokens (flat: 245,760), p = 4, F = 10
    largs = tail_inputs(rnd, gen, dev, flat=flat)
    args, (y, welem) = largs[:5], largs[5:]
    x, we, g, b, wh = args
    T, C = x.shape
    p, F = TAIL_P, N_CLASSES
    got = fh.final_head_predict(*args, patch_size=p, impl="pallas")
    want = fh.final_head_predict_plain(*args, patch_size=p)
    logits = fh.final_head_logits_plain(*args, patch_size=p)
    mism, near, worst = preds_agree("K3", got, want, logits, logit_slack(fh, x, (we, g, b, wh)))
    ms = median_ms(lambda: fh.final_head_predict(*args, patch_size=p, impl="pallas"))
    pms = median_ms(lambda: fh.final_head_predict_plain(*args, patch_size=p))
    rms = median_ms(pred_route(args, p))
    log(f"K3 final_head_predict T={T} C={C} p={p} F={F}: {mism} of {T * p} indices differ, "
        f"all at near-ties ({near} near-tie rows); kernel {ms:.4f} ms plain {pms:.4f} ms "
        f"route {rms:.4f} ms")
    # K3 emits class indices: max_abs_err is the largest |kernel - plain| index
    # difference outside near-ties; the near-tie flips are counted on their own
    timed[("final_head_predict", T, C)] = dict(
        max_abs_err=worst, index_mismatches=mism, index_mismatch_share=mism / (T * p),
        near_tie_rows=near, ms=ms, plain_ms=pms, route_ms=rms)

    # K6 / K7: the fused CE tail and its backward, on the same tail operands
    timed.update(check_loss_kernels("flat K6/K7" if flat else "K6/K7", largs, p, fh))
    if flat:  # the flat depth task's tail is unfused (the JAX gate): no K8 / K9
        return timed

    # K8 / K9: the fused masked depth loss and its backward, on the same x, expand and
    # LN operands, a head of F channels and targets with 35% background; every kind
    # checked, the depth train step's (l2, F = 1) timed
    t = depth_targets(gen, T, p, dev)
    for kind, F in DEPTH_CASES:
        dargs = args[:4] + (rnd(C, F, std=0.1), t)
        timed.update(check_depth_kernels("K8/K9", dargs, p, kind, fh,
                                         timing=(kind, F) == DEPTH_CASES[0]))
    check_depth_edges(args[:4] + (rnd(C, 1, std=0.1), t), p, fh)
    return timed


TAIL_P = 4  # the expand's sub-pixels (patch size 4)


def tail_inputs(rnd, gen, dev, F=N_CLASSES, flat=False):
    """The paper tail's operands (T = 262,144 tokens of batch 2 at nside 256, or with
    ``flat`` 245,760 of the flat model at 640 x 768, C 96, p 4, F classes, 10 by
    default): (x, we, gamma, beta, wh, y, welem), x bf16, per-element weights of random
    class weights."""
    C, p = 96, TAIL_P
    T = BATCH * (math.prod(flat_res(0)) if flat else 8 * NSIDE * NSIDE // p)
    x = rnd(T, C).to(torch.bfloat16)
    we, wh = rnd(C, p * C, std=0.02), rnd(C, F, std=0.02)
    g, b = 1.0 + rnd(C, std=0.1), rnd(C, std=0.1)
    y = torch.randint(0, F, (T, p), generator=gen, dtype=torch.int32).to(dev)
    welem = (0.5 + torch.rand(F, generator=gen)).to(dev)[y.long()]
    return x, we, g, b, wh, y, welem


def pred_route(args, p, dtype=torch.bfloat16):
    """The composed PyTorch route for K3's function on its operands (x, we, gamma, beta,
    wh), in ``dtype`` (bf16, or f32 for the f32 kernel): ``F.linear`` for the expand,
    ``F.layer_norm`` on the sub-rows, ``F.linear`` for the head and ``argmax``.  Returns
    forward(), which gives the (T, p) classes."""
    import torch.nn.functional as tF

    x, we, g, b, wh = args
    T, C = x.shape
    wet, gr, br, wht = (t.to(dtype).contiguous() for t in (we.t(), g, b, wh.t()))

    def forward():
        with torch.no_grad():
            z = tF.layer_norm(tF.linear(x, wet).reshape(T * p, C), (C,), gr, br, 1e-5)
            return tF.linear(z, wht).argmax(-1).reshape(T, p)

    return forward


def tail_route(largs, p, dtype=torch.bfloat16):
    """The composed PyTorch route for K6's and K7's function on their operands, in
    ``dtype`` (bf16, or f32 for the f32 kernels): ``F.linear`` for the expand,
    ``F.layer_norm`` on the sub-rows, ``F.linear`` for the head, the weighted
    ``F.cross_entropy`` in f32 and the confusion matrix by ``torch.bincount`` of the
    argmax.  Returns (forward, backward): forward() gives (loss, confusion matrix),
    backward() the autograd gradients of x, We, gamma, beta and Wh for a loss gradient
    of 1."""
    import torch.nn.functional as tF

    x, we, g, b, wh, y, welem = largs
    T, C = x.shape
    F = wh.shape[1]
    leaves = [t.detach().to(dtype).contiguous().requires_grad_()
              for t in (x, we.t(), g, b, wh.t())]
    yl, wl = y.reshape(-1).long(), welem.reshape(-1).float()

    def fwd():
        xr, wet, gr, br, wht = leaves
        z = tF.layer_norm(tF.linear(xr, wet).reshape(T * p, C), (C,), gr, br, 1e-5)
        lf = tF.linear(z, wht)
        loss = (wl * tF.cross_entropy(lf.float(), yl, reduction="none")).sum() / wl.sum()
        return loss, torch.bincount(yl * F + lf.argmax(-1), minlength=F * F)

    loss, _ = fwd()

    def forward():
        with torch.no_grad():
            return fwd()

    return forward, lambda: torch.autograd.grad(loss, leaves, retain_graph=True)


def tail_sequence(T, C, F, p, depth=False):
    """K7's (with ``depth``: K9's) launch sequence at a shape: kernel -> launches in one
    call (the row kernel; ``reduce_rows`` over its partial rows, two passes above 64
    rows; ``gemm_tn`` and its ``reduce_rows`` over its token splits, one split per 2048
    tokens up to 128)."""
    from heal_swin_torch import _build

    def passes(rows):
        return 1 if rows <= 64 else 2

    lib = _build.lib()
    if depth:
        grid, row_kernel = lib.hs_final_head_depth_loss_bwd_grid(T, C, F, p), "tail_depth_bwd"
    else:
        grid, row_kernel = lib.hs_final_head_loss_bwd_grid(T, C, F, p), "tail_bwd"
    return {f"{row_kernel}_kernel": 1, "gemm_tn_kernel": 1,
            "reduce_rows_kernel": passes(grid) + passes(min(-(-T // 2048), 128))}


def check_tail_steps(name, largs, p, fh, scale):
    """Each step of K7's launch sequence against its plain twin on the step's own input:
    the row kernel (dx, dh, the partial rows on its grid) within REL_L2_TOL, ``gemm_tn``
    (dWe = x^T dh) and ``reduce_rows`` within 1e-5 (f32 sums of the same bf16 and f32
    operands in another order); and K7 is the three steps composed, bit for bit.
    Returns the row kernel's grid."""
    x, C, F = largs[0], largs[0].shape[1], largs[4].shape[1]
    dx, dh, part = fh.final_head_loss_bwd_rows(*largs, scale, patch_size=p, impl="pallas")
    grid = part.shape[0]
    err, _ = check_grads(f"{name} row step", ("dx", "dh", "partial rows"), (dx, dh, part),
                         fh.final_head_loss_bwd_rows_plain(*largs, scale, patch_size=p,
                                                           grid=grid))
    dwe = fh.final_head_loss_dwe(x, dh, impl="pallas")
    e_dwe, _ = check_close(f"{name} dWe step", dwe, fh.final_head_loss_dwe_plain(x, dh), 1e-5)
    red = fh.reduce_rows(part, impl="pallas")
    e_red, _ = check_close(f"{name} reduce step", red, fh.reduce_rows_plain(part), 1e-5)
    dwh, dg, db = red.split([C * F, C, C])
    whole = fh.final_head_loss_bwd(*largs, scale, patch_size=p, impl="pallas")
    if not all(torch.equal(a, b) for a, b in zip(whole, (dx, dwe, dg, db, dwh.reshape(C, F)))):
        raise AssertionError(f"{name}: K7 is not its three steps composed")
    log(f"{name} sequence step by step on {grid} blocks: row kernel rel_l2 <= {err:.3e}, "
        f"gemm_tn {e_dwe:.3e}, reduce_rows {e_red:.3e}; K7 is the steps composed, bit-equal")
    return grid


def depth_targets(gen, T, p, dev, mean=0.0):
    """(T, p) f32 network-space targets N(mean, 1), BACKGROUND of them inf."""
    t = torch.randn(T, p, generator=gen) + mean
    bg = torch.rand(T, p, generator=gen) < BACKGROUND
    return torch.where(bg, float("inf"), t).to(dev)


def depth_route(dargs, p, dtype=torch.bfloat16):
    """The composed PyTorch route for K8's and K9's function with the depth train step's
    loss (masked l2, one channel) on their operands, in ``dtype`` (bf16, or f32 for the
    f32 kernels): ``F.linear`` for the expand, ``F.layer_norm`` on the sub-rows,
    ``F.linear`` for the head, the masked l2 loss by ``torch.where`` in f32 over the
    count of valid targets.  Returns (forward, backward): forward() gives (loss,
    predictions (T, p F)), backward() the autograd gradients of x, We, gamma, beta and
    Wh for a loss gradient of 1."""
    import torch.nn.functional as tF

    x, we, g, b, wh, t = dargs
    T, C = x.shape
    leaves = [a.detach().to(dtype).contiguous().requires_grad_()
              for a in (x, we.t(), g, b, wh.t())]
    tl = t.reshape(-1).float()
    valid = torch.isfinite(tl)
    ts = torch.where(valid, tl, 0.0)
    den = torch.clamp_min(valid.sum().float(), 1.0)

    def fwd():
        xr, wet, gr, br, wht = leaves
        z = tF.layer_norm(tF.linear(xr, wet).reshape(T * p, C), (C,), gr, br, 1e-5)
        lf = tF.linear(z, wht)
        d = torch.where(valid, lf[:, 0].float() - ts, 0.0)
        return (0.5 * d * d).sum() / den, lf.reshape(T, -1)

    loss, _ = fwd()

    def forward():
        with torch.no_grad():
            return fwd()

    return forward, lambda: torch.autograd.grad(loss, leaves, retain_graph=True)


def check_f32_bwd_steps(label, which, x, F, p, fh, rows, twin, whole):
    """Each step of the f32 K7's or K9's launch sequence (``which``) against its plain
    twin on the step's own input, within F32_TAIL_TOL: the tile kernel (``rows()``: dx
    and the partial rows [dWe | dWh | dgamma | dbeta] on its grid; ``twin(grid)``) and
    ``reduce_rows``; and the kernel (``whole()``) is the two steps composed, bit for bit.
    Returns (the grid, the tile step's worst relative L2, the reduction's)."""
    C = x.shape[1]
    dx, part = rows()
    grid = part.shape[0]
    e_rows, _ = check_grads(f"{label} {which} tile step", ("dx", "partial rows"), (dx, part),
                            twin(grid), F32_TAIL_TOL)
    red = fh.reduce_rows(part, impl="pallas")
    e_red, _ = check_close(f"{label} {which} reduce step", red, fh.reduce_rows_plain(part),
                           F32_TAIL_TOL)
    steps = (dx,) + fh.split_f32_bwd_row(red, C, F, p)
    if not all(torch.equal(a, b) for a, b in zip(whole(), steps)):
        raise AssertionError(f"{label}: {which} is not its two steps composed")
    log(f"{label} {which} sequence step by step on {grid} blocks: tile kernel rel_l2 <= "
        f"{e_rows:.3e}, reduce_rows {e_red:.3e}; {which} is the steps composed, bit-equal")
    return grid, e_rows, e_red


def check_depth_steps(name, dargs, p, kind, fh, scale, tol=REL_L2_TOL):
    """Each step of K9's launch sequence against its plain twin on the step's own input:
    the row kernel (dx, dh, the partial rows on its grid) within ``tol`` (REL_L2_TOL),
    ``gemm_tn`` (dWe = x^T dh) and ``reduce_rows`` within 1e-5 (f32 sums of the same
    operands in another order); and K9 is the three steps composed, bit for bit; for the
    f32 K9 its two steps (``check_f32_bwd_steps``).  Returns the row kernel's grid."""
    x, C, F = dargs[0], dargs[0].shape[1], dargs[4].shape[1]
    kw = dict(patch_size=p, loss_kind=kind, huber_delta=HUBER_DELTA)
    if x.dtype == torch.float32:
        return check_f32_bwd_steps(
            name, "K9", x, F, p, fh,
            lambda: fh.final_head_depth_loss_bwd_rows(*dargs, scale, **kw, impl="pallas"),
            lambda grid: fh.final_head_depth_loss_bwd_rows_f32_plain(*dargs, scale, **kw,
                                                                     grid=grid),
            lambda: fh.final_head_depth_loss_bwd(*dargs, scale, **kw, impl="pallas"))[0]
    dx, dh, part = fh.final_head_depth_loss_bwd_rows(*dargs, scale, **kw, impl="pallas")
    grid = part.shape[0]
    err, _ = check_grads(f"{name} row step", ("dx", "dh", "partial rows"), (dx, dh, part),
                         fh.final_head_depth_loss_bwd_rows_plain(*dargs, scale, **kw,
                                                                 grid=grid), tol)
    dwe = fh.final_head_loss_dwe(x, dh, impl="pallas")
    e_dwe, _ = check_close(f"{name} dWe step", dwe, fh.final_head_loss_dwe_plain(x, dh), 1e-5)
    red = fh.reduce_rows(part, impl="pallas")
    e_red, _ = check_close(f"{name} reduce step", red, fh.reduce_rows_plain(part), 1e-5)
    dwh, dg, db = red.split([C * F, C, C])
    whole = fh.final_head_depth_loss_bwd(*dargs, scale, **kw, impl="pallas")
    if not all(torch.equal(a, b) for a, b in zip(whole, (dx, dwe, dg, db, dwh.reshape(C, F)))):
        raise AssertionError(f"{name}: K9 is not its three steps composed")
    log(f"{name} K9 sequence step by step on {grid} blocks: row kernel rel_l2 <= {err:.3e}, "
        f"gemm_tn {e_dwe:.3e}, reduce_rows {e_red:.3e}; K9 is the steps composed, bit-equal")
    return grid


def check_depth_kernels(name, dargs, p, kind, fh, timing=True):
    """K8 (loss sums, predictions) and K9 (every gradient, for a loss gradient of 1)
    against their plain versions on ``dargs`` = (x, we, gamma, beta, wh, t).  The count
    of valid targets exact, the loss sum within LOSS_REL_TOL relative, the bf16
    predictions and the gradients within REL_L2_TOL; for f32 x (the f32 K8/K9) the loss
    sum, the f32 predictions and the gradients within F32_TAIL_TOL.  Returns the
    timings, keyed like the launch counters, when ``timing``; in f32 with each kernel's
    device time by kernel and the f32 route; else the errors."""
    x, wh = dargs[0], dargs[4]
    T, C = x.shape
    F = wh.shape[-1]
    f32 = x.dtype == torch.float32
    sfx = "_f32" if f32 else ""
    loss_tol, tol = (F32_TAIL_TOL, F32_TAIL_TOL) if f32 else (LOSS_REL_TOL, REL_L2_TOL)
    kw = dict(patch_size=p, loss_kind=kind, huber_delta=HUBER_DELTA)
    label = f"{name} {kind} F={F}"
    with torch.no_grad():
        num, den, preds = fh.final_head_depth_loss_sums(*dargs, **kw, impl="pallas")
        wnum, wden, wpreds = fh.final_head_depth_loss_plain(*dargs, **kw)
        if float(den) != float(wden) or float(den) != float(torch.isfinite(dargs[5]).sum()):
            raise AssertionError(f"{label}: count {float(den)} vs plain {float(wden)}")
        loss_rel = abs(float(num) - float(wnum)) / abs(float(wnum))
        if not loss_rel <= loss_tol:
            raise AssertionError(f"{label}: loss sum {float(num)} vs plain {float(wnum)}")
        if preds.dtype != x.dtype or tuple(preds.shape) != (T, p * F):
            raise AssertionError(f"{label}: predictions {tuple(preds.shape)} {preds.dtype}")
        perr, pmae = check_close(f"{label} predictions", preds, wpreds, tol)
        scale = torch.ones((), device=x.device) / torch.clamp_min(wden, 1.0)
        got = fh.final_head_depth_loss_bwd(*dargs, scale, **kw, impl="pallas")
        want = fh.final_head_depth_loss_bwd_plain(*dargs, scale, **kw)
        gerr, gmae = check_grads(label, K7_GRADS, got, want, tol)
        if F == 2 and kind != "nll" and float(got[4][:, 1].abs().max()) != 0.0:
            raise AssertionError(f"{label}: the logvar channel got a gradient")
    log(f"{label} final_head_depth_loss{sfx} T={T} C={C}: loss sum {float(num):.6f} plain "
        f"{float(wnum):.6f} (rel {loss_rel:.2e}), count {int(den)}; predictions rel_l2 "
        f"{perr:.3e} max_abs {pmae:.3e}; backward rel_l2 <= {gerr:.3e} max_abs {gmae:.3e}")
    if not timing:  # the errors alone
        return dict(loss_sum_rel_err=loss_rel, pred_rel_l2=perr, pred_max_abs=pmae,
                    grad_rel_l2=gerr, grad_max_abs=gmae)
    with torch.no_grad():
        check_depth_steps(label, dargs, p, kind, fh, scale, tol)
        ms8 = median_ms(lambda: fh.final_head_depth_loss_sums(*dargs, **kw, impl="pallas"))
        pms8 = median_ms(lambda: fh.final_head_depth_loss_plain(*dargs, **kw))
        ms9 = median_ms(lambda: fh.final_head_depth_loss_bwd(*dargs, scale, **kw,
                                                             impl="pallas"))
        pms9 = median_ms(lambda: fh.final_head_depth_loss_bwd_plain(*dargs, scale, **kw))
        per, _ = trace(lambda: fh.final_head_depth_loss_bwd(*dargs, scale, **kw,
                                                            impl="pallas"), SEQUENCE_TRACED)
        if f32:
            by8, dev8 = device_ms(lambda: fh.final_head_depth_loss_sums(*dargs, **kw,
                                                                        impl="pallas"))
            dev9 = spin_ms(lambda: fh.final_head_depth_loss_bwd(*dargs, scale, **kw,
                                                                impl="pallas"))
    if (kind, F) != ("l2", 1):
        raise ValueError(f"the depth route is the l2 loss of one channel, not {kind} F={F}")
    route_f, route_b = depth_route(dargs, p, x.dtype)
    rms8, rms9 = median_ms(route_f), median_ms(route_b)
    if f32:
        rdev8, rdev9 = spin_ms(route_f), spin_ms(route_b)
    del route_f, route_b
    who = "f32 " if f32 else ""
    fwd = dict(rel_l2=perr, max_abs_err=pmae, loss_sum_rel_err=loss_rel, ms=ms8,
               plain_ms=pms8, route_ms=rms8)
    bwd = dict(rel_l2=gerr, max_abs_err=gmae, ms=ms9, plain_ms=pms9, route_ms=rms9)
    if f32:
        by9 = {kname: ms / SEQUENCE_TRACED for kname, (ms, _) in per.items()}
        fwd["device_ms"], bwd["device_ms"] = dev8, dev9
        fwd["route_device_ms"], bwd["route_device_ms"] = rdev8, rdev9
        for k, by in (("f32 K8", by8), ("f32 K9", by9)):
            for kname, ms in sorted(by.items(), key=lambda kv: -kv[1]):
                part_of = next((v for n, v in F32_DEPTH_STEPS.items() if n in kname), None)
                log(f"{k} one call on the device: {ms:9.4f} ms  "
                    f"{part_of or 'operand copy or other'}: {kname[:90]}")
    dms = (f" (device {fwd['device_ms']:.4f} ms)", f" (device {bwd['device_ms']:.4f} ms)"
           ) if f32 else ("", "")
    rdms = (f" (device {rdev8:.4f} ms)", f" (device {rdev9:.4f} ms; autograd on a saved "
            "graph, the forward not recomputed)") if f32 else ("", "")
    log(f"{who}K8 final_head_depth_loss{sfx} T={T} C={C} p={p} F={F} {kind}: kernel "
        f"{ms8:.4f} ms{dms[0]} plain {pms8:.4f} ms {who}route {rms8:.4f} ms{rdms[0]}")
    log(f"{who}K9 final_head_depth_loss_bwd{sfx} T={T} C={C} p={p} F={F} {kind}: kernel "
        f"{ms9:.4f} ms{dms[1]} plain {pms9:.4f} ms {who}route {rms9:.4f} ms{rdms[1]}")
    # K8's max_abs_err: over its predictions (its loss sum's relative error apart)
    return {(f"final_head_depth_loss{sfx}", T, C, F, kind): fwd,
            (f"final_head_depth_loss_bwd{sfx}", T, C, F, kind): bwd,
            (f"depth_sequence{sfx}", T, C, F, kind): {name: (dev_ms / n, n / SEQUENCE_TRACED)
                                                      for name, (dev_ms, n) in per.items()}}


def check_depth_edges(dargs, p, fh):
    """K8/K9 where the targets hold no depth: a tile of 64 rows all background gives
    exactly 0 gradients to its rows; NaN targets count as background (the results
    equal, bit for bit, those with inf in their place); a batch all background has a
    count of 0, a loss sum of 0 and every gradient exactly 0."""
    x = dargs[0]
    plain_kw = dict(patch_size=p, loss_kind="l2", huber_delta=HUBER_DELTA)
    kw = dict(plain_kw, impl="pallas")
    t = dargs[5].clone()
    t[:64] = float("inf")
    t[64::7, 1] = float("nan")
    t_inf = torch.where(torch.isnan(t), float("inf"), t)
    one = torch.ones((), device=x.device)
    with torch.no_grad():
        res = [fh.final_head_depth_loss_sums(*dargs[:5], tt, **kw) for tt in (t, t_inf)]
        grads = [fh.final_head_depth_loss_bwd(*dargs[:5], tt, one / res[0][1], **kw)
                 for tt in (t, t_inf)]
        if float(res[0][1]) != float(torch.isfinite(t).sum()):
            raise AssertionError("K8: a NaN target was counted")
        if not (all(torch.equal(a, b) for a, b in zip(*res))
                and all(torch.equal(a, b) for a, b in zip(*grads))):
            raise AssertionError("K8/K9: NaN targets differ from inf ones")
        if not (torch.isfinite(grads[0][0].float()).all()
                and float(grads[0][0][:64].float().abs().max()) == 0.0):
            raise AssertionError("K9: an all-background tile got a gradient")
        want = fh.final_head_depth_loss_plain(*dargs[:5], t, **plain_kw)
        if abs(float(res[0][0]) - float(want[0])) > LOSS_REL_TOL * abs(float(want[0])):
            raise AssertionError("K8 with NaN targets: loss sum differs from the plain one")
        bg = torch.full_like(t, float("inf"))
        num, den, preds = fh.final_head_depth_loss_sums(*dargs[:5], bg, **kw)
        zero = fh.final_head_depth_loss_bwd(*dargs[:5], bg, one, **kw)
        if float(num) != 0.0 or float(den) != 0.0 or not torch.isfinite(preds.float()).all():
            raise AssertionError(f"K8 all background: loss sum {float(num)} count {float(den)}")
        if any(float(g.float().abs().max()) != 0.0 or not torch.isfinite(g.float()).all()
               for g in zero):
            raise AssertionError("K9 all background: a gradient is not exactly 0")
    log(f"K8/K9 edges T={x.shape[0]}: an all-background tile gets exactly 0 gradients, "
        f"{int(torch.isnan(t).sum())} NaN targets count as background (bit-equal to inf), "
        f"an all-background batch gives count 0, loss sum 0 and exactly 0 gradients")


K4_GRADS = ("dx", "dwqkv", "dbqkv", "dwp", "dbp", "dgamma", "dbeta", "dbias", "dlogit_scale")
K5_GRADS = ("dqkv", "dbias", "dlogit_scale")
K7_GRADS = ("dx", "dwe", "dgamma", "dbeta", "dwh")
K17_GRADS = ("dx", "dwqkv", "dbqkv", "dbias", "dlogit_scale")


def _sdpa_mask(groups, bias, dt):
    """The additive float mask of the scaled-dot function, (nW, h, ws, ws) in the
    query's dtype as scaled_dot_product_attention takes it: the rel-pos bias, -100
    between tokens of different mask groups."""
    from heal_swin_torch.ops import window_attention as wa

    mask = bias[None] if groups is None else bias[None] + wa._mask(groups)
    return mask.to(dt)


def sdpa_library(qkv, groups, bias, h, dout):
    """K2/K5's library call, a yardstick the port never calls: one
    ``scaled_dot_product_attention`` on the qkv rows' q, k, v (nW, h, ws, 32) with the
    additive float mask as a leaf in bf16 (the rel-pos bias rounded there).  Returns
    (forward, backward): forward() runs the call, backward() the autograd gradients
    of q, k, v and the mask of a kept forward for ``dout``."""
    import torch.nn.functional as F

    T = qkv.shape[0]
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.reshape(T // WS, WS, 3, h, 32).permute(2, 0, 3, 1, 4))
    mask = _sdpa_mask(groups, bias, qkv.dtype).expand(T // WS, h, WS, WS).contiguous()
    mask.requires_grad_()

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=DOT_SCALE)

    out = fwd()
    do = dout.reshape(T // WS, WS, h, 32).transpose(1, 2)

    def forward():
        with torch.no_grad():
            return fwd()

    return forward, lambda: torch.autograd.grad(out, (q, k, v, mask), do, retain_graph=True)


def sdpa_kernels(fn) -> str:
    """The device kernels one call of ``fn`` ran, by device time (which backend
    scaled_dot_product_attention chose)."""
    per, _ = trace(fn)
    return ", ".join(f"{name[:70]} {ms:.3f} ms" for name, (ms, _) in
                     sorted(per.items(), key=lambda kv: -kv[1][0])[:3])


def sdpa_route(x, wq, bq, groups, bias, h):
    """The composed PyTorch route of K16/K17's scaled-dot function, a yardstick the port
    never calls: bf16 ``F.linear`` for qkv, ``scaled_dot_product_attention`` with the
    additive float mask built from the bias and the groups, back to (T, C); its backward
    from autograd (x, Wqkv, bqkv and the bias).  Returns (forward, backward) as
    ``mlp_route``."""
    import torch.nn.functional as F

    T, C = x.shape
    nw = T // WS
    xr, w, b, br = (t.detach().requires_grad_() for t in (x, wq.t().contiguous(), bq, bias))

    def fwd():
        qkv = F.linear(xr, w, b).reshape(nw, WS, 3, h, 32).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                           attn_mask=_sdpa_mask(groups, br, x.dtype),
                                           scale=DOT_SCALE)
        return o.transpose(1, 2).reshape(T, C)

    out = fwd()
    dz = torch.ones_like(out)

    def forward():
        with torch.no_grad():
            return fwd()

    return forward, lambda: torch.autograd.grad(out, (xr, w, b, br), dz, retain_graph=True)


def check_qkv_kernels(gen, dev, rnd, logit_scales):
    """K16 and K17 against their plain versions at the three stage shapes of the blocks
    at C <= 384 (T 262,144 / 65,536 / 16,384, C 96 / 192 / 384), masked and unmasked, in
    both flavours (scaled-dot at sm_scale 32^-0.5, cosine), with a qkv bias and a
    perturbed rel-pos bias: the output and every gradient within REL_L2_TOL, and two
    K17 launches bit-equal.  The scaled-dot flavour, the one the path runs, is timed
    (median of TIMING_RUNS CUDA-event timings) beside the plain versions and the
    composed PyTorch route (``sdpa_route``).  Returns its timings keyed like the
    wrappers' ``launches_by_shape``: (kernel, T, C, has_mask)."""
    from heal_swin_torch.ops import window_attention as wa

    bf16 = torch.bfloat16
    timed = {}
    for stage in range(3):
        C = 96 * 2 ** stage
        h = C // 32
        T = BATCH * 8 * NSIDE * NSIDE // 4 // 4 ** stage
        x = rnd(T, C).to(bf16)
        wq, bq = rnd(C, 3 * C, std=C ** -0.5).to(bf16), rnd(3 * C, std=0.02).to(bf16)
        bias = rnd(h, WS, WS, std=0.5)
        ls = logit_scales(h)
        groups = ring_groups(T // BATCH).to(dev)
        dout = rnd(T, C).to(bf16)
        dqkv_b, part_b = qkv_bwd_workspace(T, C)
        log(f"K17 T={T} C={C}: workspace {workspace_bytes(('window_attention_qkv_bwd', T, C))} "
            f"bytes a launch written and read back: dqkv {dqkv_b}, partial rows {part_b} "
            f"(one row per window: {qkv_bwd_workspace(T, C, run=1)[1]})")
        for masked in (False, True):
            for use_cos in (True, False):
                flavour = "cosine" if use_cos else "scaled-dot"
                args = (x, wq, bq, groups if masked else None, bias, ls if use_cos else None)
                kw = dict(ws=WS, num_heads=h, use_cos=use_cos, sm_scale=DOT_SCALE,
                          has_mask=masked)
                label = f"C={C} T={T} mask={masked} {flavour}"
                e16 = check_close(f"K16 {label}",
                                  wa.window_attention_qkv_fwd(*args, **kw, impl="pallas"),
                                  wa.window_attention_qkv_plain(*args, **kw))
                got = wa.window_attention_qkv_bwd(*args, dout, **kw, impl="pallas")
                e17 = check_grads(f"K17 {label}", K17_GRADS, got,
                                  wa.window_attention_qkv_bwd_plain(*args, dout, **kw))
                again = wa.window_attention_qkv_bwd(*args, dout, **kw, impl="pallas")
                if not all(g is None or torch.equal(g, a) for g, a in zip(got, again)):
                    raise AssertionError(f"K17 {label}: two launches differ")
                del got, again
                line = (f"K16 window_attention_qkv {label}: rel_l2 {e16[0]:.3e} max_abs "
                        f"{e16[1]:.3e}; K17 rel_l2 <= {e17[0]:.3e} max_abs {e17[1]:.3e}, two "
                        f"launches bit-equal")
                if use_cos:
                    log(line)
                    continue
                ms16 = median_ms(lambda: wa.window_attention_qkv_fwd(*args, **kw, impl="pallas"))
                pms16 = median_ms(lambda: wa.window_attention_qkv_plain(*args, **kw))
                ms17 = median_ms(lambda: wa.window_attention_qkv_bwd(*args, dout, **kw,
                                                                     impl="pallas"))
                pms17 = median_ms(lambda: wa.window_attention_qkv_bwd_plain(*args, dout, **kw))
                route_f, route_b = sdpa_route(x, wq, bq, groups if masked else None, bias, h)
                rms16, rms17 = median_ms(route_f), median_ms(route_b)
                if stage == 0 and masked:
                    log(f"K16/K17 route: scaled_dot_product_attention ran "
                        f"{sdpa_kernels(route_f)} forward, {sdpa_kernels(route_b)} backward")
                del route_f, route_b
                log(f"{line}; K16 kernel {ms16:.4f} ms plain {pms16:.4f} ms route "
                    f"{rms16:.4f} ms; K17 kernel {ms17:.4f} ms plain {pms17:.4f} ms route "
                    f"{rms17:.4f} ms")
                key = (T, C, masked)
                timed[("window_attention_qkv",) + key] = dict(
                    rel_l2=e16[0], max_abs_err=e16[1], ms=ms16, plain_ms=pms16, route_ms=rms16)
                timed[("window_attention_qkv_bwd",) + key] = dict(
                    rel_l2=e17[0], max_abs_err=e17[1], ms=ms17, plain_ms=pms17, route_ms=rms17)
        del x, dout
        torch.cuda.empty_cache()
    return timed


def check_proj_ln(gen, dev):
    """K4's projection/LayerNorm backward alone (the second step of K4's launch
    sequence, ``qkv_epi_proj_ln_bwd``) against its plain version at the three stage
    shapes, with LayerNorm (timed) and without: du, dbp, dgamma, dbeta within
    PROJ_LN_REL_L2_TOL, and a second launch bit-equal."""
    from heal_swin_torch.ops import window_attention as wa

    bf16 = torch.bfloat16
    rnd, _ = seeded_draws(gen, dev)
    names = ("du", "dbp", "dgamma", "dbeta")
    for stage in range(3):
        C = 96 * 2 ** stage
        T = BATCH * 8 * NSIDE * NSIDE // 4 // 4 ** stage
        o, dz = rnd(T, C).to(bf16), rnd(T, C).to(bf16)
        wp, bp = rnd(C, C, std=C ** -0.5).to(bf16), rnd(C, std=0.02).to(bf16)
        g = 1.0 + rnd(C, std=0.1)
        res = []
        for gamma in (g, None):
            args = (o, wp, bp, gamma, dz)
            got = wa.qkv_epi_proj_ln_bwd(*args, impl="pallas")
            label = f"proj/LN backward C={C} T={T} LN={gamma is not None}"
            res.append(check_grads(label, names, got, wa.qkv_epi_proj_ln_bwd_plain(*args),
                                   PROJ_LN_REL_L2_TOL))
            again = wa.qkv_epi_proj_ln_bwd(*args, impl="pallas")
            if not all(a is None or torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{label}: two launches differ")
        ms = median_ms(lambda: wa.qkv_epi_proj_ln_bwd(o, wp, bp, g, dz, impl="pallas"))
        pms = median_ms(lambda: wa.qkv_epi_proj_ln_bwd_plain(o, wp, bp, g, dz))
        log(f"K4 step 2 proj/LN backward C={C} T={T}: rel_l2 <= {res[0][0]:.3e} max_abs "
            f"{res[0][1]:.3e} (without LayerNorm {res[1][0]:.3e}; limit "
            f"{PROJ_LN_REL_L2_TOL}), two launches bit-equal; kernel {ms:.4f} ms plain "
            f"{pms:.4f} ms")


def probe_x(rnd, dev, T, C):
    """x (T, C) and Wqkv (C, 3C), bf16, random but for a one-hot probe: channel r < 32
    of x is 1 on row r of each window's first 32 rows and 0 elsewhere, and head 0's v
    columns of Wqkv are [I_32; 0], so that head 0's v rows are e_key for keys < 32 and
    0 beyond, and an attention output o[i, c < 32] is bf16(P[i, key c])."""
    x = rnd(T, C)
    x.view(T // WS, WS, C)[:, :, :32] = 0
    x.view(T // WS, WS, C)[:, :32, :32] = torch.eye(32, device=dev)
    wq = rnd(C, 3 * C, std=C ** -0.5)
    wq[:, 2 * C:2 * C + 32] = 0
    wq[:32, 2 * C:2 * C + 32] = torch.eye(32, device=dev)
    return x.to(torch.bfloat16), wq.to(torch.bfloat16)


def probe_dout(dev, T, C):
    """An output gradient one-hot on head 0: dout[i, c] = (i == c) on each window's rows
    i, c < 32, so that dV[key, c] = bf16(P[c, key])."""
    dout = torch.zeros(T, C, device=dev)
    dout.view(T // WS, WS, C)[:, :32, :32] = torch.eye(32, device=dev)
    return dout.to(torch.bfloat16)


def equal_bits(label, got, want, min_nonzero=0):
    """``got`` and ``want`` equal bit for bit, and ``want`` holds at least
    ``min_nonzero`` nonzero entries (a probe that reads real probabilities)."""
    nz = int((want != 0).sum())
    if nz < min_nonzero:
        raise AssertionError(f"{label}: the probe read {nz} nonzero values")
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: {int((got != want).sum())} of {want.numel()} differ")
    log(f"{label}: bit-equal ({want.numel()} values, {nz} nonzero)")


def check_probes(gen, dev):
    """The backward kernels recompute their forward's probabilities (K13: K12's hidden,
    K15: K14's xhat) bit for bit, read through one-hot probes; any difference fails the
    run.  (a) K1 with Wp = I, bp = 0 and no LayerNorm is K16's cosine output at the three stage shapes, masked: K4's
    sequence recomputes o with K16.  (b) One window at C 96 / 192 / 384, masked, x and
    Wqkv of ``probe_x``, Wp = I, no LayerNorm, dz of ``probe_dout``: K1's o[i, c] =
    bf16(P[i, key c]), and K4's dWqkv[key, 2C + c] = dv[key, c] = bf16(P[c, key]), since
    du = dz and do = du Wp^T = dz.  (c) K5 against K2 at the C = 768 bottleneck shape,
    masked, head 0's v rows e_key, dout of ``probe_dout``: K2's o[i, c] and K5's
    dv[key, c], window by window, in both flavours.  (d) K13 against K12 at the four MLP
    stage shapes (tanh; erf too at C 96): with W2 = [I; 0] and b2 = 0 K12's out is g[:,
    :C], and for dout one-hot at (t, c) K13's dW2[:C, c] is g[t, :C], which its
    weight-gradient kernel recomputes.  (e) K15 against K14 at the MLP stage shapes at C
    <= 384 (tanh; erf too at C 96): with gamma = 1, beta = 0, no dscale and dz one on
    every column of row t, K15's dgamma is xhat[t, :], so bf16(x[t] + dgamma) is K14's
    out[t].  (f) K7 against K6 at the paper tail: the rounded logits its row kernel
    recomputes are the ones K6's cross entropy took, read through both kernels' logits
    taps.  (g) K9 against K8 at the paper tail, l2 with one channel and nll with two: the
    f32 logits K9's row kernel recomputes are the ones K8's loss took, through both
    kernels' logits taps, and K8's predictions are its logits rounded to bf16.  (h) K3
    against K6 at the paper tail: K3's classes are ``argmax_lowest`` of its own f32 logits
    tap, and that tap rounded to bf16 is K6's logits tap."""
    from heal_swin_torch.ops import window_attention as wa

    bf16 = torch.bfloat16
    rnd, logit_scales = seeded_draws(gen, dev)
    for stage in range(3):
        T, C, h, (x, wq, bq, _, _, _, _, bias, ls, groups) = stage_inputs(
            rnd, logit_scales, stage, dev)
        kw = dict(ws=WS, num_heads=h, sm_scale=DOT_SCALE, has_mask=True, impl="pallas")
        eye = torch.eye(C, device=dev, dtype=bf16)
        equal_bits(f"probe (a) C={C} T={T}: K1 with Wp = I against K16 cosine",
                   wa.window_attention_qkv_epi_fwd(x, wq, bq, eye, None, None, None, groups,
                                                   bias, ls, **kw),
                   wa.window_attention_qkv_fwd(x, wq, bq, groups, bias, ls, use_cos=True,
                                               **kw))
        del x
    for C in (96, 192, 384):
        h = C // 32
        x, wq = probe_x(rnd, dev, WS, C)
        bq = rnd(3 * C, std=0.1).to(bf16)
        bq[2 * C:] = 0
        groups = torch.randint(0, 3, (1, WS), generator=gen, dtype=torch.int32).to(dev)
        args = (x, wq, bq, torch.eye(C, device=dev, dtype=bf16), None, None, None, groups,
                rnd(h, WS, WS, std=0.5), logit_scales(h))
        kw = dict(ws=WS, num_heads=h, sm_scale=DOT_SCALE, has_mask=True, impl="pallas")
        o = wa.window_attention_qkv_epi_fwd(*args, **kw)
        dwq = wa.window_attention_qkv_epi_bwd(*args, probe_dout(dev, WS, C), **kw)[1]
        equal_bits(f"probe (b) C={C}: K4's recomputed P against K1's",
                   dwq[:32, 2 * C:2 * C + 32].t(), o[:32, :32].float(), 256)
    T, C, h, (qkv, bias, ls, groups, _) = bottleneck_inputs(rnd, logit_scales, dev)
    nw = T // WS
    v = qkv.view(nw, WS, 3 * C)[:, :, 2 * C:2 * C + 32]
    v.zero_()
    v[:, :32] = torch.eye(32, device=dev, dtype=bf16)
    dout = probe_dout(dev, T, C)
    for use_cos in (True, False):
        kw = dict(ws=WS, num_heads=h, use_cos=use_cos, sm_scale=DOT_SCALE, has_mask=True,
                  impl="pallas")
        args = (qkv, groups, bias, ls if use_cos else None)
        o = wa.window_attention_fwd(*args, **kw)
        dqkv = wa.window_attention_bwd(*args, dout, **kw)[0]
        equal_bits(f"probe (c) C={C} T={T} {'cosine' if use_cos else 'scaled-dot'}: K5's "
                   f"recomputed P against K2's",
                   dqkv.view(nw, WS, 3 * C)[:, :32, 2 * C:2 * C + 32].transpose(1, 2),
                   o.view(nw, WS, C)[:, :32, :32], 256 * nw)
    del qkv, dout, dqkv, o
    from heal_swin_torch.ops import mlp as tm

    for T, C in mlp_stages():
        H = 4 * C
        (x, w1, b1, *_), _, _ = mlp_inputs(rnd, dev, T, C)
        w2 = torch.zeros(H, C, device=dev, dtype=bf16)
        w2[:C] = torch.eye(C, device=dev, dtype=bf16)
        b2 = torch.zeros(C, device=dev)
        for approximate in ((True, False) if C == 96 else (True,)):
            kw = dict(approximate=approximate, impl="pallas")
            out = tm.mlp_fwd(x, w1, b1, w2, b2, **kw)
            for t, c in ((0, 0), (T // 2 + 17, C // 2), (T - 1, C - 1)):
                dout = torch.zeros(T, C, device=dev, dtype=bf16)
                dout[t, c] = 1
                dw2 = tm.mlp_bwd(x, w1, b1, w2, b2, dout, **kw)[3]
                equal_bits(f"probe (d) T={T} C={C} tanh={approximate} row {t} column {c}: "
                           f"K13's recomputed g against K12's", dw2[:C, c], out[t].float(),
                           C // 4)
        del x, out
    for T, C in mlp_stages():
        if C > 384:
            continue
        (x, w1, b1, w2, b2, *_), _, _ = mlp_inputs(rnd, dev, T, C)
        gamma, beta = torch.ones(C, device=dev), torch.zeros(C, device=dev)
        for approximate in ((True, False) if C == 96 else (True,)):
            kw = dict(approximate=approximate, impl="pallas")
            out = tm.mlp_block_fwd(x, w1, b1, w2, b2, gamma, beta, None, **kw)
            for t in (0, T // 2 + 17, T - 1):
                dz = torch.zeros(T, C, device=dev, dtype=bf16)
                dz[t] = 1
                dgamma = tm.mlp_block_bwd(x, w1, b1, w2, b2, gamma, beta, None, dz, **kw)[5]
                equal_bits(f"probe (e) T={T} C={C} tanh={approximate} row {t}: K15's "
                           f"recomputed xhat against K14's", (x[t].float() + dgamma).to(bf16),
                           out[t], C // 2)
        del x, out
    from heal_swin_torch.ops import final_head as fh

    largs = tail_inputs(rnd, gen, dev)
    T, C = largs[0].shape
    lf6 = fh.final_head_loss_sums(*largs, patch_size=TAIL_P, impl="pallas", tap_logits=True)[3]
    lf7 = fh.final_head_loss_bwd_rows(*largs, torch.ones((), device=dev), patch_size=TAIL_P,
                                      impl="pallas", tap_logits=True)[3]
    equal_bits(f"probe (f) T={T} C={C} p={TAIL_P} F={N_CLASSES}: K7's recomputed logits "
               f"against K6's", lf7, lf6, lf6.numel() // 2)
    preds, lf3 = fh.final_head_predict(*largs[:5], patch_size=TAIL_P, impl="pallas",
                                       tap_logits=True)
    label = f"probe (h) T={T} C={C} p={TAIL_P} F={N_CLASSES}"
    equal_bits(f"{label}: K3's classes against argmax_lowest of its f32 logits", preds,
               fh.argmax_lowest(lf3), preds.numel() // 2)
    equal_bits(f"{label}: K3's f32 logits rounded to bf16 against K6's", lf3.to(bf16), lf6,
               lf6.numel() // 2)
    del lf6, lf7, lf3, preds
    t = depth_targets(gen, T, TAIL_P, dev)
    for kind, F in (("l2", 1), ("nll", 2)):
        dargs = largs[:4] + (rnd(C, F, std=0.1), t)
        kw = dict(patch_size=TAIL_P, loss_kind=kind, impl="pallas")
        _, _, preds, lf8 = fh.final_head_depth_loss_sums(*dargs, **kw, tap_logits=True)
        lf9 = fh.final_head_depth_loss_bwd_rows(*dargs, torch.ones((), device=dev), **kw,
                                                tap_logits=True)[3]
        label = f"probe (g) T={T} C={C} p={TAIL_P} {kind} F={F}"
        equal_bits(f"{label}: K9's recomputed f32 logits against K8's", lf9, lf8,
                   lf8.numel() // 2)
        equal_bits(f"{label}: K8's predictions against its f32 logits rounded to bf16", preds,
                   lf8.reshape(T, TAIL_P * F).to(bf16), preds.numel() // 2)


def log_k4_sequence(timed, run):
    """K4's launch sequence by kernel over a train step: the device ms of each kernel
    in one traced K4 call at each shape (``check_kernels``), weighted by the step's K4
    launches at that shape (``run``: launches per kernel, per shape)."""
    _, by_shape = run
    total = collections.defaultdict(lambda: [0.0, 0.0])
    for key, n in by_shape.items():
        if key[0] == "window_attention_qkv_epi_bwd":
            for name, (ms, cnt) in timed[("k4_sequence",) + key[1:]].items():
                total[name][0] += n * ms
                total[name][1] += n * cnt
    step = sum(ms for ms, _ in total.values())
    log(f"K4 sequence over the train step's K4 launches: {step:.4f} ms on the device")
    for name, (ms, cnt) in sorted(total.items(), key=lambda kv: -kv[1][0]):
        log(f"K4 sequence: {ms:9.4f} ms {cnt:6.1f} launches  {name[:110]}")


def sequence_call_ms(kernel, per, label):
    """One K13 or K15 call's device ms by kernel, from a trace's (ms per recorded
    launch, recorded launches per call) by kernel name: each kernel's mean times its
    launches in the sequence (``MLP_SEQUENCES``; the profiler's records of a traced call
    can miss a launch).  Returns kernel -> (ms a call, launches recorded a call).  Fails
    on a kernel that is not the sequence's, or one never recorded."""
    name_of, seq = MLP_SEQUENCES[kernel]
    out = {}
    for name, (ms, recorded) in per.items():
        part = next((k for k in seq if k in name), None)
        if part is None:
            raise AssertionError(f"{label}: {name_of} launched {name[:80]}, not a kernel of "
                                 f"its sequence {list(seq)}")
        out[part] = (ms * seq[part], recorded)
    if set(out) != set(seq):
        raise AssertionError(f"{label}: the trace recorded only {sorted(out)}")
    return out


def log_mlp_sequences(timed, run):
    """K13's and K15's launch sequences by kernel over the MLP phase: the device ms of
    each kernel in a traced call at each shape (``check_mlp_kernels``,
    ``sequence_call_ms``), weighted by the phase's launches of the kernel at that shape
    (``run``: launches per kernel, per shape)."""
    _, by_shape = run
    for kernel, (name_of, seq) in MLP_SEQUENCES.items():
        for key, per in sorted((k, v) for k, v in timed.items()
                               if k[:2] == ("sequence", kernel)):
            label = f"{name_of} sequence " + " ".join(
                f"{f}={v}" for f, v in zip(("T", "C", "H", "tanh", "dscale"), key[2:]))
            call = sequence_call_ms(kernel, per, label)
            log(f"{label}: one call {sum(ms for ms, _ in call.values()):.4f} ms on the device "
                f"= " + ", ".join(f"{name} {ms:.4f} ({rec:.2f} recorded a call)"
                                  for name, (ms, rec) in call.items()))
        total = collections.defaultdict(float)
        for key, n in by_shape.items():
            if key[0] == kernel:
                traced = timed[("sequence",) + key]
                for name, (ms, _) in sequence_call_ms(kernel, traced, name_of).items():
                    total[name] += n * ms
        log(f"{name_of} sequence over the MLP phase's {name_of} launches: "
            f"{sum(total.values()):.4f} ms on the device")
        for name, ms in sorted(total.items(), key=lambda kv: -kv[1]):
            log(f"{name_of} sequence: {ms:9.4f} ms  {name} ({seq[name]} a call)")


def log_tail_sequence(timed, run, depth=False):
    """K7's (with ``depth``: K9's) launch sequence by kernel over a train step: each
    kernel's device ms a launch in a traced call at each shape (``check_loss_kernels``,
    ``check_depth_kernels``) times its launches in one call (``tail_sequence``; the
    profiler's records of a traced call can miss a launch), weighted by the step's
    launches at that shape (``run``).  The wrapper's own operand copies (the expand
    weight split into its p slices, the head and LayerNorm parameters cast) count as
    recorded, under their ATen names."""
    _, by_shape = run
    kernel, label, traced = (("final_head_depth_loss_bwd", "K9", "depth_sequence") if depth
                             else ("final_head_loss_bwd", "K7", "tail_sequence"))
    total = collections.defaultdict(float)
    for key, n in by_shape.items():
        if key[0] != kernel:
            continue
        T, C = key[1:3]
        seq = tail_sequence(T, C, key[3] if depth else N_CLASSES, TAIL_P, depth)
        for name, (ms, recorded) in timed[(traced,) + key[1:]].items():
            part = next((k for k in seq if k in name), None)
            calls = seq[part] if part is not None else recorded
            part = part or f"operand copy {name[:70]}"
            total[part] += n * ms * calls
            log(f"{label} sequence T={T} C={C}: {part} {ms:.4f} ms a launch, "
                f"{recorded:.2f} recorded a call, {calls:g} counted a call")
    log(f"{label} sequence over the train step's {label} launches: "
        f"{sum(total.values()):.4f} ms on the device")
    for name, ms in sorted(total.items(), key=lambda kv: -kv[1]):
        log(f"{label} sequence: {ms:9.4f} ms  {name}")


def log_depth_sequence(timed, run):
    """K9's launch sequence by kernel over the depth train step (``log_tail_sequence``)."""
    log_tail_sequence(timed, run, depth=True)


def check_grads(name, names, got, want, tol=REL_L2_TOL):
    """Every gradient a backward kernel returns against its plain version's (both None
    where the operand has none).  Returns the worst relative L2 and max abs error."""
    worst = (0.0, 0.0)
    for n, g, w in zip(names, got, want):
        if w is None or g is None:
            if (w is None) != (g is None):
                raise AssertionError(f"{name} {n}: one side has no gradient")
            continue
        err, mae = check_close(f"{name} {n}", g, w, tol)
        worst = (max(worst[0], err), max(worst[1], mae))
    return worst


def confmat_agrees(name, cm, lf, y, slack):
    """A kernel's confusion matrix ``cm`` (F, F) against the plain version's rounded
    logits ``lf`` (T, p, F): every element whose top-2 gap is at least ``slack`` (per
    element) is counted at (target, plain argmax); what remains of ``cm`` is exactly
    the near-tie elements, each in its target's row.  Returns (near-tie elements,
    elements counted elsewhere than the plain argmax at most)."""
    from heal_swin_torch.ops import final_head as fh

    F = lf.shape[-1]
    top2 = lf.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < slack
    yl = y.long()
    cell = yl * F + fh.argmax_lowest(lf).long()
    cm_far = torch.bincount(cell[~near], minlength=F * F).reshape(F, F).float()
    rest = cm.float() - cm_far
    near_rows = torch.bincount(yl[near], minlength=F).float()
    if not (bool((rest >= 0).all()) and torch.equal(rest.sum(1), near_rows)):
        raise AssertionError(f"{name}: confusion matrix differs outside near-ties")
    cm_plain = cm_far + torch.bincount(cell[near], minlength=F * F).reshape(F, F).float()
    return int(near.sum()), int((cm.float() - cm_plain).abs().sum()) // 2


def check_loss_kernels(name, largs, p, fh, timing=True):
    """K3 (classes), K6 (loss, confusion matrix) and K7 (every gradient, for a loss
    gradient of 1 over the weights) against their plain versions on the operands
    ``largs`` = (x, we, gamma, beta, wh, y, welem), bf16 or f32 x, on whichever route
    takes the shape.  bf16: K3's classes equal outside near-ties at ``logit_slack``
    (every z element one bf16 step off); K6's loss within LOSS_REL_TOL relative; its
    confusion matrix checked with ``confmat_agrees`` at that slack plus two bf16 steps
    of the larger logit (the logits' own rounding); every K7 gradient within REL_L2_TOL.
    f32: a slack of F32_TAIL_TOL of the row's largest |logit| (at least F32_TAIL_TOL)
    for K3 and the confusion matrix, K6's two sums and every K7 gradient within
    F32_TAIL_TOL.  Two K7 launches bit-equal, and the launch counters show K3 once, K6
    once and K7 twice.  Returns the errors, or with ``timing`` (bf16) the timings, keyed
    like the launch counters."""
    x, tail = largs[0], largs[1:5]
    T, C = x.shape
    f32 = x.dtype == torch.float32
    sfx = "_f32" if f32 else ""
    tol = F32_TAIL_TOL if f32 else REL_L2_TOL
    kw = dict(patch_size=p)
    before = dict(fh.launches)
    with torch.no_grad():
        lf = fh.final_head_logits_plain(x, *tail, **kw)
        slack = (F32_TAIL_TOL * lf.abs().amax(-1).clamp_min(1.0) if f32
                 else logit_slack(fh, x, tail))
        preds = fh.final_head_predict(*largs[:5], **kw, impl="pallas")
        m3, n3, _ = preds_agree(f"{name} K3", preds, fh.argmax_lowest(lf), lf, slack)
        num, den, cm = fh.final_head_loss_sums(*largs, **kw, impl="pallas")
        wnum, wden, _ = fh.final_head_loss_plain(*largs, **kw)
        loss, wloss = float(num / den), float(wnum / wden)
        loss_rel = abs(loss - wloss) / abs(wloss)
        sums_rel = max(abs(float(a) - float(w)) / abs(float(w))
                       for a, w in ((num, wnum), (den, wden)))
        if not (sums_rel <= F32_TAIL_TOL if f32 else loss_rel <= LOSS_REL_TOL):
            raise AssertionError(f"{name} K6: sums {float(num)}, {float(den)} vs plain "
                                 f"{float(wnum)}, {float(wden)}")
        if not f32:
            lf = lf.to(torch.bfloat16).float()
            slack = slack + 2 * 2.0 ** -7 * lf.abs().amax(-1)
        near, moved = confmat_agrees(f"{name} K6", cm, lf, largs[5].reshape(T, p), slack)
        scale = torch.ones((), device=x.device) / wden
        got = fh.final_head_loss_bwd(*largs, scale, **kw, impl="pallas")
        want = fh.final_head_loss_bwd_plain(*largs, scale, **kw)
        err, mae = check_grads(f"{name} K7", K7_GRADS, got, want, tol)
        again = fh.final_head_loss_bwd(*largs, scale, **kw, impl="pallas")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"{name}: two K7 launches differ")
        del lf, got, want, again
    counted = {k: fh.launches[k + sfx] - before[k + sfx] for k in (
        "final_head_predict", "final_head_loss", "final_head_loss_bwd")}
    if counted != dict(final_head_predict=1, final_head_loss=1, final_head_loss_bwd=2):
        raise AssertionError(f"{name}: launches counted {counted}")
    log(f"{name} final_head_loss{sfx} T={T} C={C} F={tail[3].shape[1]} p={p}: K3 {m3} of "
        f"{T * p} classes differ, all at near-ties ({n3}); loss {loss:.6f} plain "
        f"{wloss:.6f} (rel {loss_rel:.2e}, sums rel {sums_rel:.2e}); confusion matrix: "
        f"{moved} of {T * p} elements in another column, all near-ties ({near} near-tie "
        f"elements); backward rel_l2 <= {err:.3e} max_abs {mae:.3e} (tol {tol}), two "
        "launches bit-equal; counted K3 1, K6 1, K7 2")
    if not timing:
        return dict(classes_differ=m3, near_ties=n3, loss=loss, plain_loss=wloss,
                    loss_rel_err=loss_rel, sums_rel_err=sums_rel, confmat_moved=moved,
                    near_tie_elements=near, rel_l2=err, max_abs_err=mae, scale=scale)
    if f32:
        raise ValueError(f"{name}: the f32 tail is timed by check_f32_loss_kernels")
    with torch.no_grad():
        check_tail_steps(name, largs, p, fh, scale)
        ms6 = median_ms(lambda: fh.final_head_loss_sums(*largs, patch_size=p, impl="pallas"))
        pms6 = median_ms(lambda: fh.final_head_loss_plain(*largs, patch_size=p))
        ms7 = median_ms(lambda: fh.final_head_loss_bwd(*largs, scale, patch_size=p,
                                                       impl="pallas"))
        pms7 = median_ms(lambda: fh.final_head_loss_bwd_plain(*largs, scale, patch_size=p))
        per, _ = trace(lambda: fh.final_head_loss_bwd(*largs, scale, patch_size=p,
                                                      impl="pallas"), SEQUENCE_TRACED)
    route_f, route_b = tail_route(largs, p)
    rms6, rms7 = median_ms(route_f), median_ms(route_b)
    del route_f, route_b
    log(f"K6 final_head_loss T={T} C={C} p={p}: kernel {ms6:.4f} ms plain {pms6:.4f} ms "
        f"route {rms6:.4f} ms")
    log(f"K7 final_head_loss_bwd T={T} C={C} p={p}: kernel {ms7:.4f} ms plain {pms7:.4f} ms "
        f"route {rms7:.4f} ms")
    # K6's max_abs_err: |loss - plain loss|; the confusion matrix's moved elements are
    # counted on their own
    return {("final_head_loss", T, C): dict(max_abs_err=abs(loss - wloss),
                                            confmat_moved=moved, near_tie_elements=near,
                                            ms=ms6, plain_ms=pms6, route_ms=rms6),
            ("final_head_loss_bwd", T, C): dict(rel_l2=err, max_abs_err=mae, ms=ms7,
                                                plain_ms=pms7, route_ms=rms7),
            ("tail_sequence", T, C): {name: (dev_ms / n, n / SEQUENCE_TRACED)
                                      for name, (dev_ms, n) in per.items()}}


def build_task(impl, dev, state=None, depth=False, cos=True, flat=False, embed=96,
               heads=(3, 6, 12, 24)):
    """The paper model's segmentation task, or with ``depth`` its depth task (one
    output channel, the masked l2 loss, the paper depth run's data config: no
    transform, standardized, background masked); with ``cos`` False its blocks run
    scaled-dot attention instead of cosine (the JAX package's ablation ``no_cos``,
    ``benchmarks/ablate.py``); with ``flat`` the flat SWIN-UNet of bench.py's ``swin`` /
    ``depth_swin`` cells (640 x 768, patch 2, window 8 x 8, shift 2, bf16, tanh GELU).
    ``embed``, ``heads``: the HEALPix model's width and heads (the paper's 96, [3, 6, 12,
    24] by default)."""
    from heal_swin_torch.models import tasks as T
    from heal_swin_torch.models.swin_hp import DataSpec, SwinHPTransformerConfig

    gen = torch.Generator().manual_seed(SEED)
    if flat:
        cfg = T.SwinTransformerConfig(
            patch_size=FLAT_PATCH, window_size=FLAT_WIN, shift_size=FLAT_SHIFT, embed_dim=96,
            depths=[2, 2, 6, 2], num_heads=[3, 6, 12, 24], use_cos_attn=True,
            use_v2_norm_placement=True, dtype="bfloat16", gelu_approx=True,
            fused_final_head=True, attention_impl=impl)
        if depth:
            data = T.WoodscapeDepthFlatConfig(common_depth=T.WoodscapeDepthCommonConfig(
                mask_background=True, data_transform=None, normalize_data="standardize"))
            task = T.WoodscapeDepthSwin(
                T.WoodscapeDepthSwinConfig(cfg, common_depth_config=T.CommonDepthConfig(
                    loss="l2")),
                T.DepthDataSpec(dim_in=FLAT_IN, f_in=3, f_out=1), data, device=dev,
                generator=gen)
        else:
            task = T.WoodscapeSegmenterSwin(
                T.WoodscapeSegmenterSwinConfig(cfg),
                DataSpec(dim_in=FLAT_IN, f_in=3, f_out=N_CLASSES), device=dev, generator=gen)
        return seeded_extras(task, gen, state)
    # the paper model (heal_swin_tpu bench.py / __graft_entry__.py)
    cfg = SwinHPTransformerConfig(
        patch_size=4, window_size=WS, shift_size=4, shift_strategy="ring_shift",
        rel_pos_bias="flat", embed_dim=embed, depths=[2, 2, 6, 2], num_heads=list(heads),
        use_cos_attn=cos, use_v2_norm_placement=True, dtype="bfloat16", gelu_approx=True,
        fused_final_head=True, attention_impl=impl)
    npix = 8 * NSIDE * NSIDE
    if depth:
        data = T.WoodscapeHPDepthConfig(common_depth=T.WoodscapeDepthCommonConfig(
            mask_background=True, data_transform=None, normalize_data="standardize"))
        task = T.WoodscapeDepthSwinHP(
            T.WoodscapeDepthSwinHPConfig(cfg, common_depth_config=T.CommonDepthConfig(
                loss="l2")),
            T.DepthDataSpec(dim_in=npix, f_in=3, f_out=1, base_pix=8), data, device=dev,
            generator=gen)
    else:
        task = T.WoodscapeSegmenterSwinHP(
            T.WoodscapeSegmenterSwinHPConfig(cfg),
            DataSpec(dim_in=npix, f_in=3, f_out=N_CLASSES, base_pix=8), device=dev,
            generator=gen)
    return seeded_extras(task, gen, state)


def seeded_extras(task, gen, state):
    """``task`` in eval mode with ``state`` loaded, or, without one, its rel-pos tables
    and logit scales given seeded values from ``gen``: zero-init tables and equal logit
    scales would hide indexing faults."""
    if state is None:
        with torch.no_grad():
            for name, prm in task.model.named_parameters():
                if name.endswith("relative_position_bias_table"):
                    prm.copy_(torch.randn(prm.shape, generator=gen) * 0.5)
                elif name.endswith("logit_scale"):
                    prm.add_((torch.randn(prm.shape, generator=gen) * 0.5).to(prm.device))
    else:
        task.model.load_state_dict(state, strict=True)
    task.model.eval()
    return task


NO_LAUNCHES = {k: 0 for k in (
    "window_attention_qkv_epi", "window_attention", "final_head_predict",
    "window_attention_qkv_epi_bwd", "window_attention_bwd", "final_head_loss",
    "final_head_loss_bwd", "final_head_depth_loss", "final_head_depth_loss_bwd",
    "chamfer_min_both", "chamfer_fold_pairs", "mlp_fwd", "mlp_bwd", "mlp_block_fwd",
    "mlp_block_bwd", "window_attention_qkv", "window_attention_qkv_bwd",
    "final_head_loss_f32", "final_head_loss_bwd_f32", "final_head_depth_loss_f32",
    "final_head_depth_loss_bwd_f32", "window_attention_qkv_epi_f32", "window_attention_f32",
    "final_head_predict_f32", "window_attention_qkv_f32", "window_attention_bwd_f32",
    "window_attention_qkv_bwd_f32", "window_attention_qkv_epi_bwd_f32", "mlp_fwd_f32",
    "mlp_bwd_f32", "mlp_block_fwd_f32", "mlp_block_bwd_f32")}
# the window-attention launches of one pass of the paper model: cosine blocks at
# C <= 384 run K1 (K4 backward), scaled-dot ones K16 (K17); the C = 768 ones K2 (K5)
ATTN_LAUNCHES = {True: dict(window_attention_qkv_epi=20, window_attention=2),
                 False: dict(window_attention_qkv=20, window_attention=2)}
ATTN_BWD_LAUNCHES = {True: dict(window_attention_qkv_epi_bwd=20, window_attention_bwd=2),
                     False: dict(window_attention_qkv_bwd=20, window_attention_bwd=2)}


def counted_modules():
    from heal_swin_torch.ops import chamfer, chamfer_pruned
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.ops import mlp
    from heal_swin_torch.ops import window_attention as wa

    return wa, fh, chamfer, chamfer_pruned, mlp


def read_counters():
    """The kernels' launch counters: (per kernel, per (kernel, shape...))."""
    launches, by_shape = {}, collections.Counter()
    for mod in counted_modules():
        launches.update(mod.launches)
        by_shape += mod.launches_by_shape
    return launches, by_shape


def reset_counters():
    for mod in counted_modules():
        for k in mod.launches:
            mod.launches[k] = 0
        mod.launches_by_shape.clear()
    from heal_swin_torch.ops import final_head as fh

    fh.launches_by_route.clear()


def read_routes():
    """The tail kernels' launches by route: {(kernel, "row core" | "wide"): count}."""
    from heal_swin_torch.ops import final_head as fh

    return {k: v for k, v in fh.launches_by_route.items() if v}


def record_blocks(model, io):
    """Forward hooks that keep the input and output of every block (``SwinHPBlock``,
    ``SwinBlock2D``) of ``model`` in ``io`` (name -> (x, y)).  Returns the hook
    handles."""
    def hook(name):
        def keep(_mod, args, out):
            io[name] = (args[0], out)
        return keep

    return [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
            if isinstance(m, block_classes())]


def block_classes():
    from heal_swin_torch.models.swin_flat import SwinBlock2D
    from heal_swin_torch.models.swin_hp import SwinHPBlock

    return SwinHPBlock, SwinBlock2D


def trace(fn, n=1):
    """``n`` calls of ``fn`` under torch.profiler, device activity only (to keep the
    host's overhead low): (device ms and launches by kernel name, wall ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name][0] += e.time_range.elapsed_us() / 1e3
            per[e.name][1] += 1
    return per, wall_ms


def trace_sequence(fn, kernel):
    """``trace`` of SEQUENCE_TRACED calls of ``fn``, a K13 or K15 call (``kernel``, a key
    of MLP_SEQUENCES), traced again, up to SEQUENCE_TRACES times, where a kernel of its
    sequence left no record (the profiler can drop a launch's records):
    ``sequence_call_ms`` still fails on a kernel the last trace did not record."""
    seq = MLP_SEQUENCES[kernel][1]
    for _ in range(SEQUENCE_TRACES):
        per, wall_ms = trace(fn, SEQUENCE_TRACED)
        if all(any(part in name for name in per) for part in seq):
            break
    return per, wall_ms


def profile(label, fn, n) -> float:
    """Device time by kernel name over ``n`` calls of ``fn`` (``trace``), and the
    device's idle share under the profiler: 1 - (summed device activity) / (wall
    time).  The work runs on one stream, so device activities do not overlap.  Returns
    the device ms per call."""
    fn()
    torch.cuda.synchronize()
    per, wall_ms = trace(fn, n)
    busy = sum(ms for ms, _ in per.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device activity")
    log(f"{label}: {n} calls, wall {wall_ms / n:.3f} ms/call under the profiler, "
        f"device busy {busy / n:.3f} ms/call, idle share {1 - busy / wall_ms:.4f}")
    for name, (ms, cnt) in sorted(per.items(), key=lambda kv: -kv[1][0])[:24]:
        log(f"{label}: {ms / n:9.4f} ms/call {cnt / n:6.1f}/call  {name[:110]}")
    return busy / n


def check_blocks(label, task_k, io, tol=REL_L2_TOL):
    """Every block of the kernel path on the plain path's input to that block (``io``,
    from ``record_blocks``): its residual branch (output - input) against the plain
    block's, held to ``tol`` (the one-kernel tolerance in bf16).  This checks each kernel
    where the model calls it (the operands the model builds: rel-pos bias gather, mask
    groups, shifts, LN) without the drift 22 blocks of random weights add on end to end."""
    if len(io) != 22:
        raise AssertionError(f"{label}: recorded {len(io)} blocks")
    blocks_k = dict(task_k.model.named_modules())
    worst = 0.0
    with torch.no_grad():
        for name, (x, y_p) in io.items():
            y_k = blocks_k[name](x)
            worst = max(worst, check_close(f"{label} block {name}", y_k.float() - x.float(),
                                           y_p.float() - x.float(), tol)[0])
    log(f"{label}: each of the {len(io)} blocks on the plain path's input: residual branch "
        f"rel_l2 <= {worst:.3e} (tol {tol})")


def check_slice(task_k, task_p, imgs, timed, label="slice"):
    """One predict through the kernels (``task_k``) and one through the plain path
    (``task_p``, the same weights), checked against each other.  Returns the kernels'
    launches in the kernel path's predict: per kernel, and per operand shape."""
    from heal_swin_torch.models.tasks import decoder_tail
    from heal_swin_torch.ops import final_head as fh

    cos = task_k.model.config.use_cos_attn
    expected = dict(NO_LAUNCHES, final_head_predict=1, **ATTN_LAUNCHES[cos])
    npix = tuple(imgs.shape[1:-1])  # (npix,) or the flat model's (H, W)

    # the kernel path: count the launches of one predict, keep the features K3 got
    feats = {}
    keep = task_k.model.register_forward_hook(lambda _m, _a, out: feats.update(k=out))
    reset_counters()
    preds_k = task_k.predict(None, imgs)
    torch.cuda.synchronize()
    launches, by_shape = read_counters()
    keep.remove()
    check_launches(f"{label} predict", launches, by_shape, expected, timed)
    if tuple(preds_k.shape) != (BATCH,) + npix or preds_k.dtype != torch.int32:
        raise AssertionError(f"predict gave {tuple(preds_k.shape)} {preds_k.dtype}")
    if int(preds_k.min()) < 0 or int(preds_k.max()) >= N_CLASSES:
        raise AssertionError("predicted class out of range")

    # K3 inside predict: its indices against the plain decoder tail on the very
    # features it was given, with only K3's own rounding as near-tie slack
    feats_k = feats["k"]
    B, N, C = feats_k.shape
    tail = decoder_tail(task_k.model)
    fk = feats_k.reshape(B * N, C)
    with torch.no_grad():
        want = fh.final_head_predict_plain(fk, *tail, patch_size=4)
        lk = fh.final_head_logits_plain(fk, *tail, patch_size=4)
    mism, near, _ = preds_agree(f"{label} K3", task_k._kernel_targets(task_k.model, preds_k),
                                want, lk, logit_slack(fh, fk, tail))
    log(f"{label}: K3 in predict vs the plain tail on its features: {mism} of "
        f"{preds_k.numel()} indices differ, all at near-ties ({near} near-tie rows)")

    # the plain path, keeping every block's input and output and the features
    io = {}
    hooks = record_blocks(task_p.model, io)
    hooks.append(task_p.model.register_forward_hook(lambda _m, _a, out: feats.update(p=out)))
    preds_p = task_p.predict(None, imgs)
    for hk in hooks:
        hk.remove()
    check_blocks(label, task_k, io)
    del io

    # end to end: per op the two paths differ only by bf16 rounding flips (~2^-8
    # relative on a flipped element); 22 residual blocks and the skips carry those
    # on, so the features are held to a looser bound than one block.  First the same
    # measure for the plain path against itself, its input moved by bf16 rounding
    # (2^-9 relative): how much the random-weight network amplifies perturbations of
    # that size
    feats_p = feats["p"]
    amp = amplification(task_p, imgs, feats_p)
    tol = slice_tol(task_k, amp)
    err = check_close(f"{label} tail=False features", feats_k, feats_p, tol)[0]
    log(f"{label}: plain path, input moved by 2^-9 relative: features rel_l2 {amp:.3e}")
    log(f"{label}: features rel_l2 {err:.3e} (tol {tol:.3e}); "
        f"{int((preds_k != preds_p).sum())} of {preds_k.numel()} predicted classes differ "
        f"between the two paths")
    return launches, by_shape


def amplification(task_p, imgs, ref, depth=False):
    """Relative L2 of the plain path's features (``tail=False``; with ``depth`` its
    predict's metric depths) against ``ref`` when its input moves by bf16 rounding, 2^-9
    relative: how much the random-weight network amplifies perturbations of that size."""
    noise = torch.randn(imgs.shape, generator=torch.Generator().manual_seed(SEED + 2))
    moved = imgs * (1 + 2.0 ** -9 * noise.to(imgs.device))
    with torch.no_grad():
        out = task_p.predict(None, moved) if depth else task_p.model(moved, tail=False)
    return rel_l2(out, ref)


def slice_tol(task, amp):
    """The end-to-end limit of the kernel path against the plain path: SLICE_REL_L2_TOL;
    for the flat model twice the plain path's own spread under bf16 rounding of its input
    (``amplification``) where that is larger (its random-weight network amplifies a 2^-9
    input perturbation about twice as much as the HEALPix model's: 8e-2 against 4e-2),
    its blocks each held to REL_L2_TOL by ``check_blocks`` all the same."""
    from heal_swin_torch.models.swin_flat import SwinTransformerSys

    if isinstance(task.model, SwinTransformerSys):
        return max(SLICE_REL_L2_TOL, 2 * amp)
    return SLICE_REL_L2_TOL


def rate(task, imgs, n=5):
    """images/s over ``n`` back-to-back predicts, and the device memory they need on
    top of what was resident before (GiB)."""
    task.predict(None, imgs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t = time.perf_counter()
    for _ in range(n):
        task.predict(None, imgs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    return imgs.shape[0] * n / dt, (torch.cuda.max_memory_allocated() - resident) / 2 ** 30


def drive_slice(dev, timed, cos=True, flat=False):
    """predict at paper scale through the kernels and through the plain path: checked,
    timed, and traced; with ``cos`` False the scaled-dot model, with ``flat`` the flat
    SWIN-UNet at 640 x 768.  Returns the kernels' launches in one predict: per kernel,
    and per operand shape."""
    label = "flat slice" if flat else "slice" if cos else "dot slice"
    imgs, _ = train_batch(dev, flat)
    t0 = time.perf_counter()
    task_k = build_task("auto", dev, cos=cos, flat=flat)
    task_p = build_task("xla", dev, state=task_k.model.state_dict(), cos=cos, flat=flat)
    log(f"{label}: built the paper model twice in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in task_k.model.parameters()):,} parameters")
    launches, by_shape = check_slice(task_k, task_p, imgs, timed, label)

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    ips_k, mem_k = rate(task_k, imgs)
    ips_p, mem_p = rate(task_p, imgs)
    ips_k2, _ = rate(task_k, imgs)
    log(f"{label}: predict kernels {ips_k:.3f} / {ips_k2:.3f} img/s (peak {mem_k:.3f} GiB above "
        f"the resident), plain {ips_p:.3f} img/s (peak {mem_p:.3f} GiB above the resident); "
        f"resident {resident:.3f} GiB (both models' f32 weights and the input)")
    busy = profile(f"{label} profile", lambda: task_k.predict(None, imgs), PROFILE_PREDICTS)
    wall = BATCH / max(ips_k, ips_k2) * 1e3
    log(f"{label} profile: against the untraced {wall:.3f} ms/predict the device idles "
        f"{1 - busy / wall:.4f} of the time")
    timed[f"{label} predict"] = dict(ips=max(ips_k, ips_k2), plain_ips=ips_p, busy_ms=busy,
                                     idle=1 - busy / wall, mem_gib=mem_k)
    return launches, by_shape


def train_batch(dev, flat=False):
    """The fixed training batch: seeded random images (B, npix, 3), or the flat model's
    (B, 640, 768, 3), and targets that are a class per bin of the first input channel,
    so that a few steps on the batch can lower the loss (uniformly random targets leave
    nothing to learn)."""
    shape = (BATCH,) + FLAT_IN + (3,) if flat else (BATCH, 8 * NSIDE * NSIDE, 3)
    imgs = torch.randn(*shape, generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    targets = torch.clamp(((imgs[..., 0] + 2.5) * 2).long(), 0, N_CLASSES - 1)
    return imgs, targets.to(torch.int32)


def check_train_blocks(label, task_k, task_p, imgs, targets, dev):
    """The backward where the model calls the kernels: every block of both paths of a
    task on the plain path's input and upstream gradient to that block (the gradient
    the task's loss gives).  Runs before any optimizer step, so the two models hold the
    same weights.  Returns the plain path's loss and the (T, C) features the kernel
    path's ``loss_fn`` hands its fused tail, for the caller to check the tail on (None
    where the tail is unfused: the flat depth task)."""
    # the plain path's forward and backward, keeping each block's input and the
    # gradient arriving at its output
    io = {}

    def hook(name):
        def keep(_mod, args, out):
            rec = io[name] = [args[0].detach(), None]
            out.register_hook(lambda g: rec.__setitem__(1, g.detach()))
        return keep

    hooks = [m.register_forward_hook(hook(n)) for n, m in task_p.model.named_modules()
             if isinstance(m, block_classes())]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    loss_p, _ = task_p.loss_fn(imgs, targets, generator=gen, deterministic=False)
    loss_p.backward()
    for hk in hooks:
        hk.remove()
    task_p.model.zero_grad(set_to_none=True)
    if len(io) != 22 or any(dy is None for _, dy in io.values()):
        raise AssertionError(f"recorded {len(io)} blocks")

    # each pair of blocks draws the same DropPath masks: one seed per pair
    task_k.model.train()
    blocks_k = dict(task_k.model.named_modules())
    blocks_p = dict(task_p.model.named_modules())
    worst = 0.0
    for i, (name, (x, dy)) in enumerate(io.items()):
        grads = []
        for blk in (blocks_p[name], blocks_k[name]):
            blk.zero_grad(set_to_none=True)
            xi = x.clone().requires_grad_()
            blk(xi, torch.Generator(device=dev).manual_seed(SEED + 100 + i)).backward(dy)
            grads.append([("dx", xi.grad)] + [(n, q.grad) for n, q in blk.named_parameters()])
            blk.zero_grad(set_to_none=True)
        for (n, want), (_, got) in zip(*grads):
            if want is None or got is None:
                raise AssertionError(f"block {name} {n}: no gradient")
            worst = max(worst, check_close(f"block {name} {n}", got, want)[0])
    log(f"{label}: each of the {len(io)} blocks on the plain path's input and upstream "
        f"gradient: input and parameter gradients rel_l2 <= {worst:.3e} (tol {REL_L2_TOL})")
    del io

    # the features the kernel path hands its fused tail
    feats = {}
    keep = task_k.model.register_forward_hook(lambda _m, _a, out: feats.update(k=out))
    with torch.no_grad():
        task_k.loss_fn(imgs, targets, generator=torch.Generator(device=dev).manual_seed(SEED),
                       deterministic=False)
    keep.remove()
    if feats["k"].ndim != 3:  # the unfused tail (the flat depth task): the model's output
        return float(loss_p.detach()), None
    B, N, C = feats["k"].shape
    return float(loss_p.detach()), feats["k"].reshape(B * N, C)


def train_rate(task, opt, mstate, imgs, targets, start, n):
    """``n`` back-to-back train steps: images/s, the peak device memory above what was
    resident before them (GiB), the losses, and the metric state."""
    from heal_swin_torch.training.trainer import step_generator, train_step

    dev = imgs.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    losses = []
    t = time.perf_counter()
    for step in range(start, start + n):
        loss, mstate = train_step(task, opt, mstate, imgs, targets,
                                  step_generator(SEED, step, dev))
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    mem = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    return imgs.shape[0] * n / dt, mem, [float(v) for v in losses], mstate


def depth_batch(dev, flat=False):
    """The fixed depth batch: the training images, and metric depths in [0.1, 60] m
    that are a function of the first input channel, so that a few steps on the batch
    can lower the loss, with BACKGROUND of the pixels marked inf."""
    imgs, _ = train_batch(dev, flat)
    depth = 0.1 + 59.9 * torch.sigmoid(imgs[..., 0])
    bg = torch.rand(depth.shape, generator=torch.Generator().manual_seed(SEED + 3)) < BACKGROUND
    return imgs, torch.where(bg.to(dev), float("inf"), depth)


def check_launches(label, launches, by_shape, expected, timed):
    log(f"{label}: kernel launches: {launches}")
    log(f"{label}: by shape (kernel, T, C[, has_mask | F, kind | H, tanh[, dscale]]): "
        f"{dict(sorted(by_shape.items(), key=str))}")
    if launches != expected:
        raise AssertionError(f"{label}: launch counts {launches} != {expected}")
    unchecked = sorted(set(by_shape) - set(timed), key=str)
    if unchecked:
        raise AssertionError(f"{label}: launched kernels at shapes not checked: {unchecked}")


def drive_depth_predict(task_k, task_p, imgs, timed):
    """Depth predict through the kernels (``task_k``) and through the plain path
    (``task_p``, the same weights): one counted call, every block of the kernel path on
    the plain path's input, the metric depths of the two paths, and their img/s.
    Returns the kernels' launches in one predict: per kernel, and per operand shape."""
    expected = dict(NO_LAUNCHES, **ATTN_LAUNCHES[True])
    reset_counters()
    out_k = task_k.predict(None, imgs)
    torch.cuda.synchronize()
    launches, by_shape = read_counters()
    check_launches("depth predict", launches, by_shape, expected, timed)
    if (tuple(out_k.shape) != tuple(imgs.shape[:-1]) + (1,) or out_k.dtype != torch.float32
            or not torch.isfinite(out_k).all()):
        raise AssertionError(f"depth predict gave {tuple(out_k.shape)} {out_k.dtype}, "
                             f"finite: {bool(torch.isfinite(out_k).all())}")
    io = {}
    hooks = record_blocks(task_p.model, io)
    out_p = task_p.predict(None, imgs)
    for hk in hooks:
        hk.remove()
    check_blocks("depth predict", task_k, io)
    del io
    amp = amplification(task_p, imgs, out_p, depth=True)
    tol = slice_tol(task_k, amp)
    err = check_close("depth predict metric depths", out_k, out_p, tol)[0]
    log(f"depth predict: metric depths {tuple(out_k.shape)} f32 in [{float(out_k.min()):.3f}, "
        f"{float(out_k.max()):.3f}] m; kernels vs plain path rel_l2 {err:.3e} "
        f"(tol {tol:.3e}; plain path, input moved by 2^-9 relative: {amp:.3e})")
    ips_k, mem_k = rate(task_k, imgs)
    ips_p, mem_p = rate(task_p, imgs)
    ips_k2, _ = rate(task_k, imgs)
    log(f"depth predict: kernels {ips_k:.3f} / {ips_k2:.3f} img/s (peak {mem_k:.3f} GiB "
        f"above the resident), plain {ips_p:.3f} img/s (peak {mem_p:.3f} GiB above the "
        f"resident)")
    return launches, by_shape


def drive_train(dev, timed, depth=False, cos=True, flat=False):
    """The train step at paper scale through the kernels and through the plain path,
    for segmentation or, with ``depth``, the depth task (after its ``predict``,
    ``drive_depth_predict``); with ``cos`` False the scaled-dot segmentation model, with
    ``flat`` the flat SWIN-UNet at 640 x 768 (its depth task's tail is unfused, as the
    JAX gate leaves it: no K8 / K9): per-block backward and tail checks, one counted
    step, the loss over TRAIN_STEPS more steps on one batch, the metrics, the rate and
    memory of each path (kernel, plain, kernel), and a trace of the kernel path's step.
    Returns the kernels' launches in one train step: per kernel, and per operand
    shape."""
    from heal_swin_torch.models.tasks import decoder_tail
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.training.optimizer import OptimizerConfig, make_optimizer
    from heal_swin_torch.training.trainer import step_generator, train_step

    label = ("flat " if flat else "") + (
        "depth train" if depth else "train" if cos else "dot train")
    task_k = build_task("auto", dev, depth=depth, cos=cos, flat=flat)
    task_p = build_task("xla", dev, state=task_k.model.state_dict(), depth=depth, cos=cos,
                        flat=flat)
    if depth:
        imgs, metric_depth = depth_batch(dev, flat)
        targets = task_k._to_network(metric_depth)  # standardized with the masked stats
        drive_depth_predict(task_k, task_p, imgs, timed)
        expected = dict(NO_LAUNCHES) if flat else dict(
            NO_LAUNCHES, final_head_depth_loss=1, final_head_depth_loss_bwd=1)
    else:
        imgs, targets = train_batch(dev, flat)
        expected = dict(NO_LAUNCHES, final_head_loss=1, final_head_loss_bwd=1)
    expected.update(ATTN_LAUNCHES[cos], **ATTN_BWD_LAUNCHES[cos])
    loss0_p, feats = check_train_blocks(label, task_k, task_p, imgs, targets, dev)

    # the fused tail on the features the kernel path hands it (none for the flat depth
    # task: its tail is unfused)
    tail = None if feats is None else (feats,) + decoder_tail(task_k.model)
    if depth and not flat:
        check_depth_kernels(f"{label} tail", tail + (targets.reshape(-1, 4),), 4, "l2", fh,
                            timing=False)
    elif not depth:
        y = task_k._kernel_targets(task_k.model, targets)  # (T, 4): each token's pixels
        check_loss_kernels(f"{label} tail", tail + (y, task_k.class_weights[y.long()]), 4,
                           fh, timing=False)
    del feats, tail

    opt_cfg = OptimizerConfig(learning_rate=LEARNING_RATE)
    opts = [make_optimizer(t.model.parameters(), opt_cfg) for t in (task_k, task_p)]
    mstates = [t.metric_init() for t in (task_k, task_p)]

    # step 0 of the kernel path, counted, then 5 timed steps on the same batch; the
    # same on the plain path; then 5 more timed steps on the kernel path
    reset_counters()
    loss_k0, mstates[0] = train_step(task_k, opts[0], mstates[0], imgs, targets,
                                     step_generator(SEED, 0, dev))
    torch.cuda.synchronize()
    launches, by_shape = read_counters()
    check_launches(f"{label} step", launches, by_shape, expected, timed)
    ips_k, mem_k, traj_k, mstates[0] = train_rate(task_k, opts[0], mstates[0], imgs,
                                                  targets, 1, TRAIN_STEPS)
    loss_p0, mstates[1] = train_step(task_p, opts[1], mstates[1], imgs, targets,
                                     step_generator(SEED, 0, dev))
    ips_p, mem_p, traj_p, mstates[1] = train_rate(task_p, opts[1], mstates[1], imgs,
                                                  targets, 1, TRAIN_STEPS)
    ips_k2, _, _, mstates[0] = train_rate(task_k, opts[0], mstates[0], imgs, targets,
                                          1 + TRAIN_STEPS, TRAIN_STEPS)
    resident = torch.cuda.memory_allocated() / 2 ** 30
    loss_k0, loss_p0 = float(loss_k0), float(loss_p0)
    log(f"{label}: first step's loss kernels {loss_k0:.6f} plain {loss_p0:.6f} (rel "
        f"{abs(loss_k0 - loss_p0) / abs(loss_p0):.2e}); plain path before any step "
        f"{loss0_p:.6f}")
    for path, traj in (("kernels", [loss_k0] + traj_k), ("plain", [loss_p0] + traj_p)):
        log(f"{label}: loss over {len(traj)} steps on one batch ({path}): "
            + " ".join(f"{v:.6f}" for v in traj))
        if not (all(math.isfinite(v) for v in traj) and traj[-1] < traj[0]):
            raise AssertionError(f"{label} ({path}): the loss did not fall: {traj}")
    # the metric state counts every pixel (segmentation) or every pixel with a depth
    per_step = float(torch.isfinite(targets).sum()) if depth else targets.numel()
    key = "count" if depth else "total"
    for path, task, ms, n in (("kernels", task_k, mstates[0], 1 + 2 * TRAIN_STEPS),
                              ("plain", task_p, mstates[1], 1 + TRAIN_STEPS)):
        m = task.metric_compute(ms, "train_")
        if not float(ms[key]) == n * per_step:
            raise AssertionError(f"{label} ({path}): metric state counted {float(ms[key])}")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label} ({path}): metrics not finite: {m}")
        log(f"{label}: metrics over {n} steps ({path}): "
            + " ".join(f"{k} {v:.4f}" for k, v in m.items()))
    log(f"{label}: train step kernels {ips_k:.3f} / {ips_k2:.3f} img/s (peak {mem_k:.3f} GiB "
        f"above the resident), plain {ips_p:.3f} img/s (peak {mem_p:.3f} GiB above the "
        f"resident); resident {resident:.3f} GiB (both models' f32 weights, their Adam "
        f"state and the batch)")

    state = dict(step=1 + 2 * TRAIN_STEPS)

    def one_step():
        train_step(task_k, opts[0], mstates[0], imgs, targets,
                   step_generator(SEED, state["step"], dev))
        state["step"] += 1

    busy = profile(f"{label} profile", one_step, PROFILE_STEPS)
    wall = BATCH / max(ips_k, ips_k2) * 1e3
    log(f"{label} profile: against the untraced {wall:.3f} ms/step the device idles "
        f"{1 - busy / wall:.4f} of the time")
    timed[f"{label} step"] = dict(ips=max(ips_k, ips_k2), plain_ips=ips_p, busy_ms=busy,
                                  idle=1 - busy / wall, mem_gib=mem_k)
    return launches, by_shape


# ------------------------------------------------------------- Chamfer evaluation
def woodscape_cal(name, k_scale):
    """The repo's quartic fisheye calibration (``make_cal_info`` of the JAX package's
    synthetic WoodScape data) at WoodScape's frame size."""
    return {
        "name": name,
        "intrinsic": {"aspect_ratio": 1.0, "cx_offset": 0.6, "cy_offset": -0.3,
                      "width": FLAT_W, "height": FLAT_H, "poly_order": 4,
                      "k1": 0.8 * k_scale, "k2": 0.05 * k_scale, "k3": -0.01 * k_scale,
                      "k4": 0.002 * k_scale},
        "extrinsic": {"quaternion": [0.0, 0.0, 0.0, 1.0], "translation": [0.0, 0.0, 1.2]},
    }


def scene_depth(theta, phi, cam):
    """The analytic scene around camera ``cam``, metres along the ray (theta, phi):
    ground 1.2 m below the camera out to 40 m, walls whose distance varies with the
    ray's azimuth and with the camera, and NaN where the ray sees sky."""
    down = np.sin(theta) * np.sin(phi)  # the ray's image-down component
    ground = np.minimum(1.2 / np.maximum(down, 1e-6), 40.0)
    wall = 6.0 + 2.0 * cam + 4.0 * np.cos(2 * phi + cam) * np.sin(theta) + 3.0 * np.cos(theta)
    return np.where(down > 0.05, ground, np.where(down < SKY, np.nan, wall))


def chamfer_targets(n):
    """The writer's batch of ``n`` samples, one per camera, as the depth datamodule
    delivers it: HP targets standardized with the masked depth stats (background inf),
    metric flat targets at 1280 x 966 (1000 for sky, inf outside the lens), names and
    calibrations."""
    from heal_swin_torch.data import normalize_depth_data as ndd
    from heal_swin_torch.projection import fisheye

    stats = ndd.get_depth_data_stats(None, True)
    theta_hp, phi_hp = fisheye.hp_grid_angles(NSIDE, 8)
    u, v = fisheye.get_uv_from_hw(FLAT_H, FLAT_W, (FLAT_H, FLAT_W))
    hp_masks, masks, names, cals = [], [], [], []
    for i in range(n):
        cal = woodscape_cal(CAMS[i % len(CAMS)], K_SCALE * (1 + 0.01 * i))
        theta, phi = fisheye.project_img_points_to_s2(u, v, cal, False,
                                                      used_size=(FLAT_H, FLAT_W))
        flat = scene_depth(theta, phi, i)
        masks.append(np.where(theta > LENS_THETA, np.inf,
                              np.where(np.isnan(flat), 1000.0, flat)).astype(np.float32))
        hp = scene_depth(theta_hp, phi_hp, i)
        bg = (theta_hp > LENS_THETA) | np.isnan(hp)
        hp_masks.append(np.where(bg, np.inf, (hp - stats.mean) / stats.std).astype(np.float32))
        names.append(f"{i:05d}_{cal['name']}")
        cals.append(cal)
    return dict(hp_masks=np.stack(hp_masks), masks=np.stack(masks), names=names,
                cal_infos=cals)


def chamfer_batch(dev):
    """``chamfer_targets(CHAMFER_BATCH)``, and the paper depth model's (the depth train
    phase's seeded weights) metric-depth predictions for seeded images."""
    batch = chamfer_targets(CHAMFER_BATCH)
    masks, hp_masks = batch["masks"], batch["hp_masks"]
    task = build_task("auto", dev, depth=True)
    imgs = torch.randn(CHAMFER_BATCH, 8 * NSIDE * NSIDE, 3,
                       generator=torch.Generator().manual_seed(SEED + 4)).to(dev)
    preds = task.predict(None, imgs)
    if (tuple(preds.shape) != (CHAMFER_BATCH, 8 * NSIDE * NSIDE, 1)
            or not torch.isfinite(preds).all()):
        raise AssertionError(f"depth predict gave {tuple(preds.shape)}, finite: "
                             f"{bool(torch.isfinite(preds).all())}")
    fg = [float((np.isfinite(m) & (m != 1000.0)).mean()) for m in masks]
    log(f"chamfer: {CHAMFER_BATCH} depth predictions (B, npix, 1) in "
        f"[{float(preds.min()):.3f}, {float(preds.max()):.3f}] m; targets in the HP "
        f"foreground {[int(np.isfinite(h).sum()) for h in hp_masks]} of {hp_masks[0].size}, "
        f"flat foreground shares {[round(x, 4) for x in fg]}")
    if min(fg) < 0.75:
        raise AssertionError(f"flat foreground {fg}: keep at least 75% of the frame")
    return preds, batch


def cdist_minima(p, q, exact=True):
    """The library call: torch.cdist, then both minima, squared as the kernels give
    them.  ``exact``: the difference form, whose CUDA kernel launches one block per
    distance, at most 2^31 - 1 of them, so p goes in row chunks of 2^30 distances;
    else the matrix-multiply form, |p|^2 + |q|^2 - 2 p.q, whose cancellation makes
    its minima inexact."""
    mode = "donot_use_mm_for_euclid_dist" if exact else "use_mm_for_euclid_dist"
    rows = max(1, (1 << 30) // q.shape[0])
    pmin, qmin = [], None
    for lo in range(0, p.shape[0], rows):
        d = torch.cdist(p[lo:lo + rows], q, compute_mode=mode)
        pmin.append(d.amin(1))
        qmin = d.amin(0) if qmin is None else torch.minimum(qmin, d.amin(0))
    return torch.cat(pmin).square(), qmin.square()


def bound(flop, nbytes, peak):
    """(least ms, what bounds it): operations over the peak or bytes over the memory
    rate, the larger."""
    t_op, t_b = flop / peak * 1e3, nbytes / HBM_RATE * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def same_bits(label, got, want):
    """Per-point minima equal bit for bit (numpy or torch)."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = want.cpu().numpy() if isinstance(want, torch.Tensor) else want
    if got.shape != want.shape or got.tobytes() != want.tobytes():
        bad = np.count_nonzero(got != want) if got.shape == want.shape else "shape"
        raise AssertionError(f"{label}: minima differ ({bad})")


def replay_folds(p, q, folds, dev, plain_runs=1):
    """K11 and its plain version over a pair's fold lists (``folds``, as the pruned
    pipeline folded them), in order and on the same running minima: each fold's
    minima bit-equal, and both timed there (the kernel's median; the plain version's
    median of ``plain_runs``, whose first run is the one checked).  Returns the final
    per-point minima in the original point order and one dict per non-empty fold."""
    from heal_swin_torch.ops import chamfer_pruned as chp

    n, m = len(p), len(q)
    pr = chp.chamfer_prepare(p, q)
    p_tab = chp._device_side(pr.pkey, pr.ps, pr.rank_p, n, dev)[0]
    q_tab = chp._device_side(pr.qkey, pr.qs, pr.rank_q, m, dev)[0]
    pmin = torch.full((pr.bp,), float("inf"), device=dev)
    qmin = torch.full((pr.bq,), float("inf"), device=dev)
    out = []
    for fold in folds:
        if not len(fold):
            continue
        pairs = torch.from_numpy(np.ascontiguousarray(fold, dtype=np.int32)).to(dev)
        kp, kq = chp.chamfer_fold_pairs(pairs, p_tab, q_tab, n, m, pmin.clone(), qmin.clone())
        wp, wq = pmin.clone(), qmin.clone()
        pms = median_ms(lambda: chp.chamfer_fold_pairs_plain(pairs, p_tab, q_tab, n, m, wp, wq),
                        runs=plain_runs, warmup=0)
        same_bits(f"K11 fold of {len(fold)} tile pairs vs its plain version", kp, wp)
        same_bits(f"K11 fold of {len(fold)} tile pairs vs its plain version", kq, wq)
        ms = median_ms(lambda: chp.chamfer_fold_pairs(pairs, p_tab, q_tab, n, m, kp, kq),
                       runs=10, warmup=2)
        pmin, qmin = kp, kq
        pp = chp._point_pairs(fold, n, m)
        b, by = bound(8.0 * pp, (pr.bp + pr.bq) * 20 + len(fold) * 8, CHAMFER_PEAK)
        out.append(dict(tile_pairs=len(fold), point_pairs=pp, ms=ms, plain_ms=pms,
                        bound_ms=b, bound_by=by))
    rank_p = torch.from_numpy(pr.rank_p[:n].astype(np.int64)).to(dev)
    rank_q = torch.from_numpy(pr.rank_q[:m].astype(np.int64)).to(dev)
    chp.clear()
    return pmin[rank_p], qmin[rank_q], out


def fold_sums(folds):
    """A K11 entry's times over its folds: summed, the bound by what bounds most."""
    return dict(ms=sum(f["ms"] for f in folds), plain_ms=sum(f["plain_ms"] for f in folds),
                bound_ms=sum(f["bound_ms"] for f in folds),
                bound_by=max(("operations", "bytes"), key=lambda by: sum(
                    f["bound_ms"] for f in folds if f["bound_by"] == by)))


def check_other_route(stats, dev, timed):
    """Every pair a Chamfer writer evaluated (its ``on_pair`` records, ``stats``) again
    on the other route: per-point minima bit-equal and the same value.  Each of the
    pairs' launch shapes (K10's (n, m), K11's tile pairs of each fold) is thereby
    checked, and entered in ``timed``."""
    from heal_swin_torch.ops import chamfer as ch
    from heal_swin_torch.ops import chamfer_pruned as chp

    for st in stats:
        other = {}
        v = ch.chamfer_distance(st["p"], st["q"], route="brute" if st["route"] == "pruned"
                                else "pruned", device=dev, stats=other)
        for k in ("d_pq", "d_qp"):
            same_bits(f"{st['sample']} {st['metric']} {k}: {st['route']} vs {other['route']}",
                      st[k], other[k])
        if v != st["value"]:
            raise AssertionError(f"{st['metric']}: {st['value']} vs {v} on the other route")
        note = dict(checked=f"per point bit-equal to the {other['route']} route")
        if st["route"] == "brute":
            timed[("chamfer_min_both", st["n"], st["m"])] = note
        else:
            for k in st["round_pairs"] + [st["final_pairs"]]:
                if k:
                    timed[("chamfer_fold_pairs", k)] = note
    chp.clear()


def check_chamfer_paper(dev, brute, pruned, label="chamfer paper pairs"):
    """K10 and K11 against their plain versions at the writer's own shapes, on the
    card: ``brute`` and ``pruned`` are two of the writer's pairs (its ``on_pair``
    records).  K10's plain version on the brute pair, and K11's fold by fold over the
    pruned pair's folds, must give the writer's per-point minima bit for bit.  Both
    are timed there, with the library call (torch.cdist in its matrix-multiply form;
    its difference form would take minutes at these sizes) on the brute pair.
    Returns the K10 and K11 entries' times for these pairs."""
    from heal_swin_torch.ops import chamfer as ch

    p, q = ch._as_points(brute["p"]), ch._as_points(brute["q"])
    pd, qd = torch.from_numpy(p).to(dev), torch.from_numpy(q).to(dev)
    n, m = len(p), len(q)
    got = {}
    plain_ms = median_ms(lambda: got.update(r=ch.chamfer_min_both_plain(pd, qd)), runs=1,
                         warmup=0)
    for i, k in enumerate(("d_pq", "d_qp")):
        same_bits(f"K10 {brute['sample']} {brute['metric']} {k} vs its plain version",
                  got["r"][i], brute[k])
    del got
    b, by = bound(8.0 * n * m, (n + m) * 16, CHAMFER_PEAK)
    k10 = dict(ms=median_ms(lambda: ch.chamfer_min_both(pd, qd), runs=10, warmup=2),
               plain_ms=plain_ms, bound_ms=b, bound_by=by,
               library_ms=median_ms(lambda: cdist_minima(pd, qd, exact=False), runs=1,
                                    warmup=1),
               timed_on=f"{brute['sample']} {brute['metric']} pair, {n} x {m}")
    del pd, qd
    torch.cuda.empty_cache()

    p, q = ch._as_points(pruned["p"]), ch._as_points(pruned["q"])
    d_pq, d_qp, folds = replay_folds(p, q, pruned["folds"], dev)
    same_bits(f"K11 {pruned['sample']} {pruned['metric']} d_pq vs the writer's", d_pq,
              pruned["d_pq"])
    same_bits(f"K11 {pruned['sample']} {pruned['metric']} d_qp vs the writer's", d_qp,
              pruned["d_qp"])
    k11 = dict(fold_sums(folds), library_ms=None, folds=folds,
               timed_on=f"{pruned['sample']} {pruned['metric']} pair, {len(p)} x {len(q)}")
    torch.cuda.empty_cache()
    log(f"{label} on the card: K10 = plain on {k10['timed_on']} (K10 "
        f"{k10['ms']:.4f} ms, bound {k10['bound_ms']:.4f} ms, plain {k10['plain_ms']:.4f} ms, "
        f"torch.cdist matrix-multiply form + minima {k10['library_ms']:.4f} ms); K11 = plain "
        f"fold by fold on {k11['timed_on']} (K11 {k11['ms']:.4f} ms, bound "
        f"{k11['bound_ms']:.4f} ms, plain {k11['plain_ms']:.4f} ms: "
        + "; ".join(f"{f['tile_pairs']} tile pairs {f['ms']:.4f} / {f['plain_ms']:.4f} ms"
                    for f in folds) + "); per point bit-equal to the writer's minima")
    return k10, k11


def check_chamfer_mid(dev, q_target):
    """K10 and K11 against their plain versions at the mid-size pair, bit for bit, on
    a noise pair (MID_POINTS target points, and the same points moved by NOISE_M) and
    on a uniform pair; then, on the noise pair, the times of K10, its plain version
    and the library call (torch.cdist in the exact difference form, and in the
    inexact matrix-multiply form with its largest error), and of K11 and its plain
    version over the pruned pipeline's folds, replayed fold by fold."""
    from heal_swin_torch.ops import chamfer as ch

    rng = np.random.default_rng(SEED)
    base = q_target[rng.choice(len(q_target), MID_POINTS, replace=False)].astype(np.float32)
    pairs = {"noise": (base, (base + rng.normal(0, NOISE_M, base.shape)).astype(np.float32)),
             "uniform": tuple(rng.uniform(-20, 20, (MID_POINTS, 3)).astype(np.float32)
                              for _ in range(2))}
    for label, (p, q) in pairs.items():
        pd, qd = torch.from_numpy(p).to(dev), torch.from_numpy(q).to(dev)
        got = ch.chamfer_min_both(pd, qd)
        want = ch.chamfer_min_both_plain(pd, qd)
        pruned, plain = {}, {}
        v = ch.chamfer_distance(p, q, route="pruned", device=dev, stats=pruned)
        ch.chamfer_distance(p, q, route="pruned", device=dev, impl="xla", stats=plain)
        for i, k in enumerate(("d_pq", "d_qp")):
            same_bits(f"K10 {label} {k}", got[i], want[i])
            same_bits(f"K11 {label} {k} vs its plain pipeline", pruned[k], plain[k])
            same_bits(f"K11 {label} {k} vs K10", pruned[k], got[i])
        log(f"chamfer mid {label} pair {MID_POINTS} x {MID_POINTS}: K10 = plain, K11 = plain "
            f"pipeline = K10, per point bit-equal; chamfer {v:.6f}; pruned rounds "
            f"{pruned['round_pairs']} final {pruned['final_pairs']} of "
            f"{pruned['dense_pairs']} tile pairs, work_frac {pruned['work_frac']:.4f}")
    p, q = pairs["noise"]
    pd, qd = torch.from_numpy(p).to(dev), torch.from_numpy(q).to(dev)
    n, m = len(p), len(q)
    got = ch.chamfer_min_both(pd, qd)
    mm = cdist_minima(pd, qd, exact=False)
    mm_err = max(float((a - b).abs().max()) for a, b in zip(mm, got))
    del mm
    k10 = dict(n=n, m=m, ms=median_ms(lambda: ch.chamfer_min_both(pd, qd)),
               plain_ms=median_ms(lambda: ch.chamfer_min_both_plain(pd, qd), runs=5, warmup=1),
               bound_ms=bound(8.0 * n * m, (n + m) * 16, CHAMFER_PEAK)[0],
               library_mm_ms=median_ms(lambda: cdist_minima(pd, qd, exact=False), runs=3,
                                       warmup=1),
               library_mm_max_abs_err=mm_err)
    torch.cuda.empty_cache()
    k10["library_ms"] = median_ms(lambda: cdist_minima(pd, qd), runs=1, warmup=0)
    torch.cuda.empty_cache()

    # K11: the noise pair's folds replayed in order, each kernel fold held to the
    # plain fold on the same running minima and both timed there
    pruned = {}
    ch.chamfer_distance(p, q, route="pruned", device=dev, stats=pruned)
    d_pq, _, folds = replay_folds(p, q, pruned["folds"], dev, plain_runs=3)
    same_bits("K11 replay", d_pq, pruned["d_pq"])
    k11 = dict(n=n, m=m, folds=folds, **fold_sums(folds))
    log(f"chamfer mid noise pair {n} x {m}: K10 {k10['ms']:.4f} ms (bound "
        f"{k10['bound_ms']:.4f} ms), plain {k10['plain_ms']:.4f} ms, torch.cdist + minima "
        f"{k10['library_ms']:.4f} ms in the difference form, {k10['library_mm_ms']:.4f} ms "
        f"in the matrix-multiply form (largest error {mm_err:.3e}); K11 over "
        f"{len(folds)} folds {k11['ms']:.4f} ms (bound {k11['bound_ms']:.4f} ms), plain "
        f"{k11['plain_ms']:.4f} ms: "
        + "; ".join(f"{f['tile_pairs']} tile pairs {f['ms']:.4f} / {f['plain_ms']:.4f} ms"
                    for f in folds))
    return k10, k11


def drive_chamfer_eval(dev, timed):
    """The paper's depth Chamfer evaluation at its sizes: the depth model predicts
    CHAMFER_BATCH images and the Chamfer writer scores them (four variants, 16 pairs)
    through K10 and K11, counted and traced.  Then every pair is rerun on the other
    route, its per-point minima held bit-equal (K11 against K10 at the paper pair
    sizes, and each launched shape so checked); the same writer with every pair forced
    through K10 must give the same metric bits; K10 and K11 are held to their plain
    versions on sample 0's HP pair (brute) and full_res_hp_masked pair (pruned), and
    timed there; and both are held to their plain versions at a mid-size pair.
    Returns the launches of the writer's run (per kernel, per shape) and the K10 / K11
    entries of the results line: times at sample 0's pairs, where kernel, plain
    version and bound cover the same work, beside the writer run's device time over
    all its launches (``writer_ms``) and its bound."""
    from heal_swin_torch.evaluation.hp_depth_pred_writers import (
        WoodscapeHPDepthChamferDistBestWorstPredictionWriter as Writer)
    from heal_swin_torch.ops import chamfer_pruned as chp

    preds, batch = chamfer_batch(dev)
    torch.cuda.empty_cache()
    kw = dict(nside=NSIDE, base_pix=8, mask_background=True, normalize_data="standardize",
              data_transform=None, rotate_pole=False, device=dev)
    logged, stats = {}, []
    writer = Writer(**kw, on_pair=stats.append)
    writer.log_metrics = lambda mets: logged.update(kernels=mets)

    def run():
        writer.write_on_batch_end(preds, batch, 0)
        writer.on_predict_epoch_end()

    reset_counters()
    per, wall_ms = trace(run)
    launches, by_shape = read_counters()
    if chp._SIDE_CACHE or chp._DEVICE_CACHE:
        raise AssertionError("the writer left Chamfer tables cached")

    for st in stats:
        line = (f"chamfer pair {st['sample']} {st['metric']}: n {st['n']} m {st['m']} "
                f"(n*m {st['n'] * st['m']:.3e}) route {st['route']}, host prep "
                f"{st['t_prep']:.3f} s, fold {st['t_fold']:.3f} s, value {st['value']:.6f}")
        if st["route"] == "pruned":
            line += (f"; round pairs {st['round_pairs']}, final pairs {st['final_pairs']} "
                     f"of {st['dense_pairs']}, work_frac {st['work_frac']:.4f}")
        log(line)
        want = "pruned" if "full_res" in st["metric"] and "small" not in st["metric"] else "brute"
        if st["route"] != want:
            raise AssertionError(f"{st['metric']} took the {st['route']} route: change the "
                                 f"target so that it takes the {want} one")

    # every pair on the other route: per-point minima bit-equal (K11 against K10 at
    # the paper's pair sizes); each of the run's launch shapes is thereby checked
    check_other_route(stats, dev, timed)
    s0 = next(st for st in stats if st["metric"] == "chamfer_distance_full_res_hp_masked")
    log(f"chamfer: every pair's minima bit-equal on the other route; K11 = K10 at the "
        f"paper pair {s0['sample']} full_res_hp_masked ({s0['n']} x {s0['m']})")

    n_brute = sum(st["route"] == "brute" for st in stats)
    n_folds = sum(bool(k) for st in stats if st["route"] == "pruned"
                  for k in st["round_pairs"] + [st["final_pairs"]])
    expected = dict(NO_LAUNCHES, chamfer_min_both=n_brute, chamfer_fold_pairs=n_folds)
    check_launches("chamfer eval", launches, by_shape, expected, timed)
    # the writer's device ms of each kernel: its mean over the launches the trace
    # recorded, times the launches the wrappers counted (torch.profiler can miss a
    # record; the counters are checked above)
    dev_ms = {}
    for name in ("chamfer_min_both", "chamfer_fold_pairs"):
        traced_ms = sum(ms for k, (ms, _) in per.items() if f"{name}_kernel" in k)
        traced = sum(c for k, (_, c) in per.items() if f"{name}_kernel" in k)
        if launches[name] and not traced:
            raise AssertionError(f"{name}: the trace recorded none of its {launches[name]} "
                                 f"launches")
        dev_ms[name] = traced_ms / traced * launches[name] if traced else 0.0
        log(f"chamfer {name}: {traced} launches traced, {launches[name]} counted")
    busy = sum(ms for ms, _ in per.values())
    log(f"chamfer eval: {wall_ms / 1e3 / CHAMFER_BATCH:.3f} s per evaluated sample "
        f"(traced, device activity only; {wall_ms / 1e3:.3f} s for {CHAMFER_BATCH}); device "
        f"busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}: K10 "
        f"{dev_ms['chamfer_min_both']:.3f} ms over "
        f"{launches['chamfer_min_both']} launches, K11 {dev_ms['chamfer_fold_pairs']:.3f} ms "
        f"over {launches['chamfer_fold_pairs']}; host prep per pair (worker thread) "
        + ", ".join(f"{st['t_prep']:.3f}" for st in stats) + " s")

    # the same writer with every pair forced through K10: the same metric bits
    brute = Writer(**kw, chamfer_route="brute")
    brute.log_metrics = lambda mets: logged.update(brute=mets)
    t0 = time.perf_counter()
    brute.write_on_batch_end(preds, batch, 0)
    brute.on_predict_epoch_end()
    t_brute = time.perf_counter() - t0
    mets = logged["kernels"]
    if set(mets) != set(logged["brute"]) or len(mets) != 4:
        raise AssertionError(f"metrics {sorted(mets)} vs {sorted(logged['brute'])}")
    for k, v in mets.items():
        if not math.isfinite(v) or v != logged["brute"][k]:
            raise AssertionError(f"{k}: {v} through K10/K11, {logged['brute'][k]} through K10")
    log("chamfer metrics (bit-equal with every pair forced through K10, "
        f"{t_brute / CHAMFER_BATCH:.3f} s per sample): "
        + " ".join(f"{k} {v:.6f}" for k, v in mets.items()))
    log(f"chamfer ranking by chamfer_distance (desc, top and bottom 2): "
        f"{ {k: [str(x) for x in v] for k, v in writer.ranked.items()} }")

    # the least time of the writer's folds: the point pairs each route computed
    work = {"chamfer_min_both": [(8.0 * st["n"] * st["m"], (st["n"] + st["m"]) * 16)
                                 for st in stats if st["route"] == "brute"],
            "chamfer_fold_pairs": [(8.0 * st["folded_point_pairs"], (st["n"] + st["m"]) * 20)
                                   for st in stats if st["route"] == "pruned"]}
    s0 = {st["metric"]: st for st in stats if st["sample"] == stats[0]["sample"]}
    del writer, stats
    paper = check_chamfer_paper(dev, s0["chamfer_distance"],
                                s0["chamfer_distance_full_res_hp_masked"])
    q_target = s0["chamfer_distance"]["q"]  # sample 0's HP target cloud
    del s0
    mids = check_chamfer_mid(dev, q_target)
    entries = {}
    for name, at, mid in zip(("chamfer_min_both", "chamfer_fold_pairs"), paper, mids):
        bounds = [bound(f, b, CHAMFER_PEAK)[0] for f, b in work[name]]
        entries[name] = dict(
            max_abs_err=0.0,  # every check above holds the minima bit-equal
            **at, writer_ms=dev_ms[name], writer_bound_ms=sum(bounds), mid=mid)
        if name == "chamfer_min_both":
            entries[name]["library_call"] = ("torch.cdist (matrix-multiply form, inexact) "
                                             "+ amin")
        log(f"chamfer {name}: writer run {dev_ms[name]:.4f} ms device time over "
            f"{launches[name]} launches, bound {sum(bounds):.4f} ms")
    return launches, by_shape, entries


# ------------------------------------------------------------ the MLP family
MLP_GRADS = ("dx", "dw1", "db1", "dw2", "db2")
# K13's and K15's launch sequences: each kernel's launches in one call at the stage
# shapes (K13: its dx kernel, its weight-gradient kernel, and reduce_rows for dW1, dW2
# and db1 | db2; K15: the row kernel with the LayerNorm backward, the dx kernel, the
# weight-gradient kernel, the same three reductions and two passes over the row
# kernel's partial rows), and the calls that one trace takes in
MLP_SEQUENCES = {
    "mlp_bwd": ("K13", {"mlp_dx_kernel": 1, "mlp_dw_kernel": 1, "reduce_rows_kernel": 3}),
    "mlp_block_bwd": ("K15", {"mlp_fwd_kernel": 1, "mlp_dx_kernel": 1, "mlp_dw_kernel": 1,
                              "reduce_rows_kernel": 5}),
}
SEQUENCE_TRACED = 5
SEQUENCE_TRACES = 3  # traces of a sequence at most, until each of its kernels is recorded
MLP_BLOCK_GRADS = MLP_GRADS + ("dgamma", "dbeta")
DROP_KEEP = 0.9  # the DropPath keep rate of the route timings (the paper's last block)


def mlp_stages():
    """(T, C) of the paper model's four stages: B 2, nside 256, patch 4."""
    return [(BATCH * 8 * NSIDE * NSIDE // 4 // 4 ** s, 96 * 2 ** s) for s in range(4)]


def mlp_inputs(rnd, dev, T, C):
    """The MLP family's seeded operands at a stage shape (T, C, H = 4C): args = (x, w1,
    b1, w2, b2, gamma, beta), an output gradient dz (bf16) and the DropPath scale of
    the batch's two samples, one kept, one dropped (ds, (T, 1) f32)."""
    bf16 = torch.bfloat16
    H = 4 * C
    args = (rnd(T, C).to(bf16), rnd(C, H, std=C ** -0.5).to(bf16), rnd(H, std=0.1),
            rnd(H, C, std=H ** -0.5).to(bf16), rnd(C, std=0.1), 1 + rnd(C, std=0.1),
            rnd(C, std=0.1))
    dz = rnd(T, C).to(bf16)
    ds = torch.cat([torch.full((T // 2, 1), 1 / DROP_KEEP), torch.zeros(T // 2, 1)]).to(dev)
    return args, dz, ds


def mlp_route(args, ds, approximate, block, B=BATCH):
    """The port's current route for the same function, on (B, T / B, C) tokens: its
    ``Mlp`` plain path (bf16 cuBLAS ``linear`` + ATen GELU) and, for the branch, its
    LayerNorm, the DropPath scale (``torch.where`` of y / keep, as ``DropPath``) and the
    residual.  Returns (forward, backward): forward() gives the output, backward()
    the autograd gradients of a kept forward for a fixed output gradient."""
    from heal_swin_torch.models.layers import LayerNorm, Mlp

    x, w1, b1, w2, b2, gamma, beta = args
    T, C = x.shape
    H = w1.shape[1]
    mlp = Mlp(C, H, C, gelu_approx=approximate).to(x.device)
    norm = LayerNorm(C).to(x.device)
    with torch.no_grad():
        for dst, src in ((mlp.fc1.weight, w1.t()), (mlp.fc1.bias, b1), (mlp.fc2.weight, w2.t()),
                         (mlp.fc2.bias, b2), (norm.weight, gamma), (norm.bias, beta)):
            dst.copy_(src)
    xr = x.reshape(B, T // B, C).detach().requires_grad_()
    keep = None if ds is None else (ds.reshape(B, T // B, 1)[:, :1] > 0)

    def fwd():
        if not block:
            return mlp(xr)
        y = norm(mlp(xr))
        if keep is not None:
            y = torch.where(keep, y / DROP_KEEP, torch.zeros_like(y))
        return xr + y

    params = [xr] + list(mlp.parameters()) + (list(norm.parameters()) if block else [])
    out = fwd()
    dz = torch.ones_like(out)

    def forward():
        with torch.no_grad():
            return fwd()

    return forward, lambda: torch.autograd.grad(out, params, dz, retain_graph=True)


def gelu_told_apart(kernel, name, db1, plain, other):
    """``db1`` of a backward kernel against its plain version's (``plain``) and the
    plain version's with the other GELU (``other``): whether the first is within the
    kernel's GELU_DB1_TOL and the second beyond it."""
    tol = GELU_DB1_TOL[kernel]
    err, dist = rel_l2(db1, plain), rel_l2(db1, other)
    log(f"{name}: f32 db1 rel_l2 {err:.3e} vs its own GELU's plain version, {dist:.3e} vs "
        f"the other GELU's (tol {tol})")
    return err <= tol < dist


def check_mlp_kernels(gen, dev):
    """K12-K15 against their plain versions at the paper model's stage shapes (T, C,
    H = 4C): tanh GELU at every stage, erf at stage 0; K14/K15 with and without the
    DropPath scale.  Every output and gradient within MLP_REL_L2_TOL, K14 / K15 on the
    branch (z - x, dx - dz); at stage 0, K13 / K15's f32 db1 tells the two GELUs apart
    (``gelu_told_apart``; its failures are raised once every shape has been checked).
    Two K13 launches give the same bits.  Each is timed (median of TIMING_RUNS
    CUDA-event timings) beside its plain version and the port's current route
    (``mlp_route``), and one K13 call at each shape is traced by kernel (its launch
    sequence: ``log_mlp_sequences``), and so is one K15 call at each shape and dscale.
    Returns the timings keyed like the wrappers' ``launches_by_shape``: (kernel, T, C,
    H, approximate[, has_dscale]), and the traces ("sequence", kernel, T, C, H,
    approximate[, has_dscale])."""
    from heal_swin_torch.ops import mlp as tm

    tol = MLP_REL_L2_TOL
    timed, gelu_failed = {}, []

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    for T, C in mlp_stages():
        H = 4 * C
        args, dz, ds = mlp_inputs(rnd, dev, T, C)
        x, dzf = args[0].float(), dz.float()
        log(f"K13 / K15 T={T} C={C} H={H}: workspace {workspace_bytes(('mlp_bwd', T, C, H))} "
            f"/ {workspace_bytes(('mlp_block_bwd', T, C, H))} bytes written and read back "
            f"(K13: its weight-gradient kernel's partial rows; K15: du and the partial rows "
            f"of its row kernel and its weight-gradient kernel; from the shapes)")
        for approximate in ((True, False) if C == 96 else (True,)):
            kw = dict(approximate=approximate)
            a5 = args[:5]
            with torch.no_grad():
                e12 = check_close(f"K12 T={T} C={C} tanh={approximate}",
                                  tm.mlp_fwd(*a5, **kw, impl="pallas"), tm.mlp_plain(*a5, **kw),
                                  tol["mlp_fwd"])
                g13 = tm.mlp_bwd(*a5, dz, **kw, impl="pallas")
                p13 = tm.mlp_bwd_plain(*a5, dz, **kw)
                e13 = check_grads(f"K13 T={T} C={C} tanh={approximate}", MLP_GRADS, g13, p13,
                                  tol["mlp_bwd"])
                if not all(torch.equal(a, b) for a, b in
                           zip(g13, tm.mlp_bwd(*a5, dz, **kw, impl="pallas"))):
                    raise AssertionError(f"K13 T={T} C={C} tanh={approximate}: two launches "
                                         f"differ")
                if C == 96 and not gelu_told_apart(
                        "mlp_bwd", f"K13 T={T} C={C} tanh={approximate}", g13[2], p13[2],
                        tm.mlp_bwd_plain(*a5, dz, approximate=not approximate)[2]):
                    gelu_failed.append(f"K13 tanh={approximate}")
                del g13, p13
                ms12 = median_ms(lambda: tm.mlp_fwd(*a5, **kw, impl="pallas"))
                pms12 = median_ms(lambda: tm.mlp_plain(*a5, **kw))
                ms13 = median_ms(lambda: tm.mlp_bwd(*a5, dz, **kw, impl="pallas"))
                pms13 = median_ms(lambda: tm.mlp_bwd_plain(*a5, dz, **kw))
                per, _ = trace_sequence(lambda: tm.mlp_bwd(*a5, dz, **kw, impl="pallas"),
                                        "mlp_bwd")
            timed[("sequence", "mlp_bwd", T, C, H, approximate)] = {
                name: (dev_ms / n, n / SEQUENCE_TRACED) for name, (dev_ms, n) in per.items()}
            route_f, route_b = mlp_route(args, None, approximate, block=False)
            rms12, rms13 = median_ms(route_f), median_ms(route_b)
            log(f"K12 mlp_fwd T={T} C={C} H={H} tanh={approximate}: rel_l2 {e12[0]:.3e} "
                f"max_abs {e12[1]:.3e} kernel {ms12:.4f} ms plain {pms12:.4f} ms route "
                f"{rms12:.4f} ms")
            log(f"K13 mlp_bwd T={T} C={C} H={H} tanh={approximate}: rel_l2 <= {e13[0]:.3e} "
                f"max_abs {e13[1]:.3e}, two launches bit-equal; kernel {ms13:.4f} ms plain "
                f"{pms13:.4f} ms route {rms13:.4f} ms")
            key = (T, C, H, approximate)
            timed[("mlp_fwd",) + key] = dict(rel_l2=e12[0], max_abs_err=e12[1], ms=ms12,
                                             plain_ms=pms12, route_ms=rms12)
            timed[("mlp_bwd",) + key] = dict(rel_l2=e13[0], max_abs_err=e13[1], ms=ms13,
                                             plain_ms=pms13, route_ms=rms13)
            for d in (None, ds):
                bkw = dict(kw, impl="pallas")
                with torch.no_grad():
                    e14 = check_close(f"K14 T={T} C={C} dscale={d is not None} branch z - x",
                                      tm.mlp_block_fwd(*args, d, **bkw).float() - x,
                                      tm.mlp_block_plain(*args, d, **kw).float() - x,
                                      tol["mlp_block_fwd"])
                    g15 = tm.mlp_block_bwd(*args, d, dz, **bkw)
                    p15 = tm.mlp_block_bwd_plain(*args, d, dz, **kw)
                    e15 = check_grads(f"K15 T={T} C={C} dscale={d is not None}",
                                      ("dx - dz",) + MLP_BLOCK_GRADS[1:],
                                      (g15[0].float() - dzf,) + g15[1:],
                                      (p15[0].float() - dzf,) + p15[1:], tol["mlp_block_bwd"])
                    if C == 96 and not gelu_told_apart(
                            "mlp_block_bwd", f"K15 T={T} C={C} tanh={approximate} dscale={d is not None}",
                            g15[2], p15[2], tm.mlp_block_bwd_plain(
                                *args, d, dz, approximate=not approximate)[2]):
                        gelu_failed.append(f"K15 tanh={approximate} dscale={d is not None}")
                    del g15, p15
                    ms14 = median_ms(lambda: tm.mlp_block_fwd(*args, d, **bkw))
                    pms14 = median_ms(lambda: tm.mlp_block_plain(*args, d, **kw))
                    ms15 = median_ms(lambda: tm.mlp_block_bwd(*args, d, dz, **bkw))
                    pms15 = median_ms(lambda: tm.mlp_block_bwd_plain(*args, d, dz, **kw))
                    per, _ = trace_sequence(lambda: tm.mlp_block_bwd(*args, d, dz, **bkw),
                                            "mlp_block_bwd")
                timed[("sequence", "mlp_block_bwd", T, C, H, approximate, d is not None)] = {
                    name: (dev_ms / n, n / SEQUENCE_TRACED) for name, (dev_ms, n) in per.items()}
                route_f, route_b = mlp_route(args, d, approximate, block=True)
                rms14, rms15 = median_ms(route_f), median_ms(route_b)
                log(f"K14 mlp_block_fwd T={T} C={C} H={H} tanh={approximate} dscale="
                    f"{d is not None}: branch rel_l2 {e14[0]:.3e} max_abs {e14[1]:.3e} kernel "
                    f"{ms14:.4f} ms plain {pms14:.4f} ms route {rms14:.4f} ms")
                log(f"K15 mlp_block_bwd T={T} C={C} H={H} tanh={approximate} dscale="
                    f"{d is not None}: rel_l2 (dx - dz) <= {e15[0]:.3e} max_abs "
                    f"{e15[1]:.3e} kernel {ms15:.4f} ms plain {pms15:.4f} ms route {rms15:.4f} ms")
                bkey = key + (d is not None,)
                timed[("mlp_block_fwd",) + bkey] = dict(rel_l2=e14[0], max_abs_err=e14[1],
                                                        ms=ms14, plain_ms=pms14, route_ms=rms14)
                timed[("mlp_block_bwd",) + bkey] = dict(rel_l2=e15[0], max_abs_err=e15[1],
                                                        ms=ms15, plain_ms=pms15, route_ms=rms15)
        del args, dz, ds, x, dzf
        torch.cuda.empty_cache()
    if gelu_failed:
        raise AssertionError(f"f32 db1 does not tell the GELUs apart ({GELU_DB1_TOL}): "
                             f"{gelu_failed}")
    return timed


def record_mlp_inputs(model, dev):
    """One training forward of ``model`` (no autograd) with DropPath drawing from a
    seeded generator: per ``SwinHPBlock``, the input of its MLP branch and the state
    of the generator as the block's second DropPath call (the MLP branch's) found it,
    or None where the block's rate is 0 (no draw)."""
    from heal_swin_torch.models.swin_hp import SwinHPBlock

    rec, hooks = {}, []
    for name, blk in model.named_modules():
        if not isinstance(blk, SwinHPBlock):
            continue
        r = rec[name] = dict(block=blk, states=[])
        hooks.append(blk.mlp.register_forward_pre_hook(
            lambda _m, args, r=r: r.__setitem__("x", args[0])))
        hooks.append(blk.drop_path.register_forward_pre_hook(
            lambda m, args, r=r: r["states"].append(
                args[1].get_state() if m.rate > 0 else None)))
    imgs = torch.randn(BATCH, 8 * NSIDE * NSIDE, 3,
                       generator=torch.Generator().manual_seed(SEED + 5)).to(dev)
    model.train()
    with torch.no_grad():
        model(imgs, tail=False, generator=torch.Generator(device=dev).manual_seed(SEED + 6))
    for hk in hooks:
        hk.remove()
    if len(rec) != 22 or any(len(r["states"]) != 2 for r in rec.values()):
        raise AssertionError(f"recorded {len(rec)} blocks")
    return rec


def block_dscale(blk, state, B, N, dev):
    """(B * N, 1) f32: the block's DropPath scale for the draw at generator ``state``
    (1 / keep for a kept sample, 0 for a dropped one), or None for no draw."""
    if state is None:
        return None
    g = torch.Generator(device=dev)
    g.set_state(state)
    scale = blk.drop_path(torch.ones(B, 1, 1, device=dev), g)
    return scale.expand(B, N, 1).reshape(B * N, 1).contiguous()


def check_mlp_blocks(label, rec, dev, timed, tol=REL_L2_TOL, sfx=""):
    """The MLP family on the paper model's own blocks (``rec``: ``record_mlp_inputs``),
    counted, in the blocks' dtype (``sfx`` "_f32": the f32 kernels):
    - for each of the 20 blocks at C <= 384, ``fused_mlp_block`` on the block's fc1,
      fc2, norm2 and draw (K14 forward, K15 backward) against its own plain branch
      x + drop_path(norm2(mlp(x))): the output and every gradient, for a seeded
      upstream gradient;
    - for the 4 blocks at C = 96, the block's ``Mlp`` with ``mlp_impl="fused"`` (K13
      backward) against ``"xla"`` on the same weights and input (output and every
      gradient), and ``fused_mlp`` with ``fwd_impl="pallas"`` (K12) against it.
    Each within relative L2 ``tol``; expected launches K12 4 / K13 4 / K14 20 / K15 20.
    Returns (launches, per shape)."""
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(SEED + 8)
    reset_counters()
    worst_blk, worst_mlp, n_blk, n_mlp, n_dp = 0.0, 0.0, 0, 0, 0
    for name, r in rec.items():
        blk, x = r["block"], r["x"]
        B, N, C = x.shape
        if C > 384:
            continue
        n_blk += 1
        ds = block_dscale(blk, r["states"][1], B, N, dev)
        n_dp += ds is not None
        dz = torch.randn(x.shape, generator=gen).to(dev, x.dtype)
        params = [blk.mlp.fc1.weight, blk.mlp.fc1.bias, blk.mlp.fc2.weight, blk.mlp.fc2.bias,
                  blk.norm2.weight, blk.norm2.bias]
        xk = x.detach().requires_grad_()
        zk = tm.fused_mlp_block(xk.reshape(B * N, C), params[0].t(), params[1], params[2].t(),
                                params[3], params[4], params[5], ds,
                                approximate=blk.mlp.gelu_approx)
        gk = torch.autograd.grad(zk, [xk] + params, dz.reshape(B * N, C))
        xp = x.detach().requires_grad_()
        g = None
        if ds is not None:
            g = torch.Generator(device=dev)
            g.set_state(r["states"][1])
        zp = xp + blk.drop_path(blk.norm2(blk.mlp(xp)), g)
        gp = torch.autograd.grad(zp, [xp] + params, dz)
        worst_blk = max(worst_blk, check_close(f"{label} block {name} output", zk.detach(),
                                               zp.detach().reshape(B * N, C), tol)[0])
        for n, a, b in zip(("dx",) + MLP_BLOCK_GRADS[1:], gk, gp):
            worst_blk = max(worst_blk, check_close(f"{label} block {name} {n}", a, b, tol)[0])
        if C != 96:
            continue
        # the block's Mlp through the module's fused gate, and K12 on the same input
        n_mlp += 1
        outs, grads = [], []
        for impl in ("fused", "xla"):
            blk.mlp.mlp_impl = impl
            xi = x.detach().requires_grad_()
            out = blk.mlp(xi)
            outs.append(out.detach())
            grads.append(torch.autograd.grad(out, [xi] + params[:4], dz))
        with torch.no_grad():
            outs.append(tm.fused_mlp(x.reshape(B * N, C), params[0].t(), params[1],
                                     params[2].t(), params[3], approximate=blk.mlp.gelu_approx,
                                     fwd_impl="pallas").reshape(B, N, C))
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"{label} {name}: the fused gate's forward is not the plain "
                                 f"one")
        worst_mlp = max(worst_mlp, check_close(f"{label} {name} K12 output", outs[2], outs[1],
                                               tol)[0])
        for n, a, b in zip(MLP_GRADS, *grads):
            worst_mlp = max(worst_mlp, check_close(f"{label} {name} fused {n}", a, b, tol)[0])
    torch.cuda.synchronize()
    launches, by_shape = read_counters()
    expected = dict(NO_LAUNCHES, **{f"mlp_fwd{sfx}": 4, f"mlp_bwd{sfx}": 4,
                                    f"mlp_block_fwd{sfx}": 20, f"mlp_block_bwd{sfx}": 20})
    check_launches(label, launches, by_shape, expected, timed)
    log(f"{label}: {n_blk} blocks at C <= 384 ({n_dp} with a DropPath draw): fused_mlp_block "
        f"vs the block's own branch x + drop_path(norm2(mlp(x))), output and every gradient "
        f"rel_l2 <= {worst_blk:.3e}; {n_mlp} blocks at C = 96: Mlp(mlp_impl='fused') = "
        f"'xla' forward bit for bit, gradients and fused_mlp(fwd_impl='pallas') rel_l2 <= "
        f"{worst_mlp:.3e} (tol {tol})")
    return launches, by_shape


def drive_mlp(dev, timed):
    """The MLP family at the paper model's widths, on its own blocks.  K12-K15 are held
    to their plain versions at every stage shape first (``check_mlp_kernels``).  Then
    the segmentation model at paper scale (bf16) runs one training forward, keeping
    each block's MLP-branch input and DropPath draw (``record_mlp_inputs``), and the
    family runs on its blocks (``check_mlp_blocks``).  Returns (launches, per shape)."""
    timed.update(check_mlp_kernels(torch.Generator().manual_seed(SEED + 7), dev))
    t0 = time.perf_counter()
    task = build_task("auto", dev)
    rec = record_mlp_inputs(task.model, dev)
    log(f"mlp: built the paper model and recorded its 22 blocks' MLP inputs in "
        f"{time.perf_counter() - t0:.1f} s")
    run = check_mlp_blocks("mlp", rec, dev, timed)
    del rec, task
    return run


# ------------------------------------------------------------ the kernels' refusal
# ------------------------------------------- the paper segmentation config in float32
PAPER_STEPS = 4  # timed train steps of each path after the counted first step
F32_TAIL_TOL = 1e-5  # the f32 K6's sums and every f32 K7 gradient and step vs plain
PAPER_LOSS_TOL = 1e-5  # the train step's loss, kernel path vs plain path, relative
PAPER_GRAD_TOL = 1e-4  # every parameter gradient of the first step, relative L2
PAPER_CLASSES = 8  # the SynWoodScape-large classes of the paper segmentation config
# the f32 K6/K7's bound: the card's TF32 tensor-core peak (H100 SXM, dense) over three,
# the rate of a 3xTF32 product, the f32-accurate tensor-core form
TF32_PEAK = 494.7e12
F32_TC_PEAK = TF32_PEAK / 3
F32_TC_PEAK_NAME = "3xTF32: TF32 494.7 TFLOPS / 3"
F32_KERNELS = ("final_head_loss_f32", "final_head_loss_bwd_f32", "final_head_depth_loss_f32",
               "final_head_depth_loss_bwd_f32", "final_head_predict_f32",
               "window_attention_qkv_epi_f32", "window_attention_f32",
               "window_attention_qkv_f32", "window_attention_qkv_bwd_f32",
               "window_attention_qkv_epi_bwd_f32", "window_attention_bwd_f32", "mlp_fwd_f32",
               "mlp_bwd_f32", "mlp_block_fwd_f32", "mlp_block_bwd_f32")
# the f32 window-attention kernels' bytes over their bf16 forms', (per T C, per C^2): the
# tokens and weights at 4 bytes, the f32 weight gradients as they are
F32_ATTN_EXTRA = {"window_attention_f32": (8, 0), "window_attention_qkv_epi_f32": (4, 8),
                  "window_attention_qkv_f32": (4, 6), "window_attention_bwd_f32": (14, 0),
                  "window_attention_qkv_bwd_f32": (6, 6),
                  "window_attention_qkv_epi_bwd_f32": (6, 8)}
# the kernels of an f32 K6 / K7 call, and of an f32 K8 / K9 call, by their names in a trace
F32_TAIL_STEPS = {"tail_fwd_3xtf32_kernel": "K6 tile kernel",
                  "tail_bwd_3xtf32_kernel": "K7 tile kernel", "reduce_rows_kernel": "reduce_rows"}
F32_DEPTH_STEPS = dict(F32_TAIL_STEPS, tail_fwd_3xtf32_kernel="K8 tile kernel",
                       tail_bwd_3xtf32_kernel="K9 tile kernel")


def f32_tail_work(key):
    """(FLOP, bytes) of one call of the f32 K3, K6 or K7 at (name, T, C) with the paper
    head's F 8 classes, or of the f32 K8 or K9 at (name, T, C, F, kind), p 4: K3, K6 and
    K8 the expand 2 T p C^2 and the head 2 T p C F; K7 and K9 three times each (the
    forward recomputed; dx and dWe; dz and dWh); f32 tokens read once, int32 targets and
    f32 weights (K6, K7) or f32 targets (K8, K9) read once, K3's int32 classes, K8's f32
    predictions and K7's and K9's dx written once, the f32 parameters and, for K7 and
    K9, their gradients."""
    name, T, C = key[:3]
    depth = "depth" in name
    p, F = TAIL_P, key[3] if depth else PAPER_CLASSES
    weights = (p * C * C + C * F + 2 * C) * 4
    if name == "final_head_predict_f32":
        return 2 * T * p * C * C + 2 * T * p * C * F, 4 * T * C + 4 * T * p + weights
    targets = 4 * T * p if depth else 8 * T * p
    if "bwd" not in name:
        preds = 4 * T * p * F if depth else 0
        return 2 * T * p * C * C + 2 * T * p * C * F, 4 * T * C + targets + preds + weights
    return 6 * T * p * C * C + 6 * T * p * C * F, 8 * T * C + targets + 2 * weights


def paper_tail_inputs(gen, dev, flat=False):
    """The paper config's tail operands in f32 (T = 262,144 tokens of batch 2 at nside
    256, or with ``flat`` the flat paper config's 245,760, C 96, p 4, F 8): (x, we,
    gamma, beta, wh, y, welem), welem the SynWoodScape class weights of y."""
    from heal_swin_torch.run_configs import SYNWOODSCAPE_LARGE_WEIGHTS

    rnd, _ = seeded_draws(gen, dev)
    C, p, F = 96, TAIL_P, PAPER_CLASSES
    T = BATCH * (math.prod(flat_res(0)) if flat else 8 * NSIDE * NSIDE // p)
    x = rnd(T, C)
    we, wh = rnd(C, p * C, std=0.1), rnd(C, F, std=0.3)
    g, b = 1.0 + rnd(C, std=0.1), rnd(C, std=0.1)
    y = torch.randint(0, F, (T, p), generator=gen, dtype=torch.int32).to(dev)
    welem = torch.tensor(SYNWOODSCAPE_LARGE_WEIGHTS, device=dev)[y.long()]
    return x, we, g, b, wh, y, welem


def device_ms(fn, n=SEQUENCE_TRACED):
    """One call's device time (ms) by kernel name, from ``n`` traced calls (the profiler
    can drop a launch's record, so these can read low), and in all, by ``spin_ms``."""
    per, _ = trace(fn, n)
    return {name: ms / n for name, (ms, _) in per.items()}, spin_ms(fn)


def check_f32_loss_kernels(largs, fh):
    """The f32 K3, K6 and K7 against their plain versions (f32, TF32 off) at the paper
    tail (``check_loss_kernels``: K6's sums and every K7 gradient within F32_TAIL_TOL,
    the classes and the confusion matrix equal outside near-ties, two K7 launches
    bit-equal); each step of K7 (tile kernel, reduce_rows) against its plain twin on its
    own input within F32_TAIL_TOL and K7 the steps composed bit for bit
    (``check_f32_bwd_steps``); and the probe that K7's tile kernel recomputes K6's f32
    logits bit for bit (the logits taps).  Then one call's time, its device time by
    kernel, its plain version's and the f32 composed PyTorch route's (``tail_route`` in
    f32; its device time by ``spin_ms`` too).  Returns the timings keyed like the launch
    counters."""
    x = largs[0]
    T, C = x.shape
    p, F = TAIL_P, largs[4].shape[1]
    name = "paper tail f32"
    e = check_loss_kernels(name, largs, p, fh, timing=False)
    scale, err, mae = e["scale"], e["rel_l2"], e["max_abs_err"]
    with torch.no_grad():
        lf6 = fh.final_head_loss_sums(*largs, patch_size=p, impl="pallas", tap_logits=True)[3]
        lf7 = fh.final_head_loss_bwd_rows(*largs, scale, patch_size=p, impl="pallas",
                                          tap_logits=True)[-1]
        equal_bits(f"{name} probe: K7's recomputed logits vs K6's", lf7, lf6)
        grid, e_rows, e_red = check_f32_bwd_steps(
            name, "K7", x, F, p, fh,
            lambda: fh.final_head_loss_bwd_rows(*largs, scale, patch_size=p, impl="pallas"),
            lambda grid: fh.final_head_loss_bwd_rows_f32_plain(*largs, scale, patch_size=p,
                                                               grid=grid),
            lambda: fh.final_head_loss_bwd(*largs, scale, patch_size=p, impl="pallas"))
        del lf6, lf7
        log(f"{name} K7 on {grid} blocks: tile kernel rel_l2 <= {e_rows:.3e}, reduce_rows "
            f"{e_red:.3e}, K7 the steps composed bit-equal; K7 recomputes K6's f32 logits "
            "bit for bit")
        ms6 = median_ms(lambda: fh.final_head_loss_sums(*largs, patch_size=p, impl="pallas"))
        pms6 = median_ms(lambda: fh.final_head_loss_plain(*largs, patch_size=p))
        ms7 = median_ms(lambda: fh.final_head_loss_bwd(*largs, scale, patch_size=p,
                                                       impl="pallas"))
        pms7 = median_ms(lambda: fh.final_head_loss_bwd_plain(*largs, scale, patch_size=p))
        by6, dev6 = device_ms(lambda: fh.final_head_loss_sums(*largs, patch_size=p,
                                                              impl="pallas"))
        by7, dev7 = device_ms(lambda: fh.final_head_loss_bwd(*largs, scale, patch_size=p,
                                                             impl="pallas"))
    route_f, route_b = tail_route(largs, p, torch.float32)
    rms6, rms7 = median_ms(route_f), median_ms(route_b)
    rdev6, rdev7 = spin_ms(route_f), spin_ms(route_b)
    del route_f, route_b
    for label, by in (("f32 K6", by6), ("f32 K7", by7)):
        for kname, ms in sorted(by.items(), key=lambda kv: -kv[1]):
            part_of = next((v for k, v in F32_TAIL_STEPS.items() if k in kname), None)
            log(f"{label} one call on the device: {ms:9.4f} ms  "
                f"{part_of or 'operand copy or other'}: {kname[:90]}")
    log(f"f32 K6 final_head_loss_f32 T={T} C={C} p={p} F={F}: kernel {ms6:.4f} ms (device "
        f"{dev6:.4f} ms) plain {pms6:.4f} ms f32 route {rms6:.4f} ms (device {rdev6:.4f} ms)")
    log(f"f32 K7 final_head_loss_bwd_f32 T={T} C={C} p={p} F={F}: kernel {ms7:.4f} ms "
        f"(device {dev7:.4f} ms) plain {pms7:.4f} ms f32 route {rms7:.4f} ms (device "
        f"{rdev7:.4f} ms; autograd on a saved graph, the forward not recomputed)")
    return {("final_head_loss_f32", T, C): dict(
                max_abs_err=abs(e["loss"] - e["plain_loss"]), sums_rel_err=e["sums_rel_err"],
                confmat_moved=e["confmat_moved"], near_tie_elements=e["near_tie_elements"],
                ms=ms6, device_ms=dev6, plain_ms=pms6,
                route_ms=rms6, route_device_ms=rdev6),
            ("final_head_loss_bwd_f32", T, C): dict(
                rel_l2=err, max_abs_err=mae, ms=ms7, device_ms=dev7, plain_ms=pms7,
                route_ms=rms7, route_device_ms=rdev7)}


def paper_task(impl, dev, state=None, depth=False, flat=False, overrides=None,
               classes=PAPER_CLASSES, class_weights=None):
    """The paper segmentation config's task (``heal_swin_torch.run_configs``): f32 compute,
    dropout and attention dropout 0.1, DropPath 0.1, the SynWoodScape-large class
    weights, Adam at the paper rate, at nside 256; with ``depth`` the paper depth
    config's task (``paper_depth_config``: the same network with one output channel, the
    masked l2 loss on standardized depths with background masked, Adam at 0.005).
    Weights from SEED (the rel-pos tables and logit scales perturbed as
    ``build_task``'s) or ``state``.  With ``flat`` the paper flat configs' tasks
    (``run_configs.flat_seg_train_run``, ``depth_swin_train_run``: the copies of
    ``swin_synwoodscape_large_train_run_config.py`` and ``depth_swin_train_run_config.py``)
    at 640 x 768.  ``overrides``: fields set on the HEALPix segmentation config
    (``paper_swin_hp_config``); ``classes`` and ``class_weights``: its head and loss
    weights (the SynWoodScape-large 8 and their weights by default)."""
    from heal_swin_torch.models import tasks as T
    from heal_swin_torch.models.swin_hp import DataSpec
    from heal_swin_torch.run_configs import (PAPER_LR, SYNWOODSCAPE_LARGE_WEIGHTS,
                                             depth_swin_train_run, flat_seg_train_run,
                                             paper_depth_config, paper_swin_hp_config)
    from heal_swin_torch.training.optimizer import OptimizerConfig

    gen = torch.Generator().manual_seed(SEED)
    npix = 8 * NSIDE * NSIDE
    if flat and depth:
        rc = depth_swin_train_run(attention_impl=impl)
        task = T.WoodscapeDepthSwin(rc.model, T.DepthDataSpec(dim_in=FLAT_IN, f_in=3, f_out=1),
                                    rc.data, device=dev, generator=gen)
    elif flat:
        task = T.WoodscapeSegmenterSwin(
            flat_seg_train_run(attention_impl=impl).model,
            DataSpec(dim_in=FLAT_IN, f_in=3, f_out=PAPER_CLASSES), device=dev, generator=gen)
    elif depth:
        cfg = paper_depth_config(attention_impl=impl)
        task = T.WoodscapeDepthSwinHP(
            cfg.model, T.DepthDataSpec(dim_in=npix, f_in=3, f_out=1, base_pix=8), cfg.data,
            device=dev, generator=gen)
    else:
        task = T.WoodscapeSegmenterSwinHP(
            T.WoodscapeSegmenterSwinHPConfig(
                paper_swin_hp_config(attention_impl=impl, **(overrides or {})),
                optimizer_config=OptimizerConfig(learning_rate=PAPER_LR),
                class_weights=list(class_weights or SYNWOODSCAPE_LARGE_WEIGHTS)),
            DataSpec(dim_in=npix, f_in=3, f_out=classes, base_pix=8), device=dev,
            generator=gen)
    if state is None:
        with torch.no_grad():
            for name, prm in task.model.named_parameters():
                if name.endswith("relative_position_bias_table"):
                    prm.copy_(torch.randn(prm.shape, generator=gen) * 0.5)
                elif name.endswith("logit_scale"):
                    prm.add_((torch.randn(prm.shape, generator=gen) * 0.5).to(prm.device))
    else:
        task.model.load_state_dict(state, strict=True)
    return task


def drive_paper_train(dev, timed):
    """The paper segmentation config's own train step at full width and depth (nside 256,
    batch 2, f32, dropout and attention dropout 0.1, DropPath 0.1, 8 classes, the fused
    tail, Adam at the paper rate), through the kernels ("auto") and through the plain
    path ("xla") on the same weights, batch and step generators.  First the f32 K6/K7
    against their plain versions at the paper tail (``check_f32_loss_kernels``), then
    the step (``paper_step``): the kernel path launches one f32 K6 and one f32 K7 and no
    other kernel (attention dropout sends every block to the plain XLA route, the MLP is
    plain).  Returns the kernels' launches in step 0 of the kernel path: per kernel, and
    per operand shape."""
    from heal_swin_torch.ops import final_head as fh

    timed.update(check_f32_loss_kernels(paper_tail_inputs(
        torch.Generator().manual_seed(SEED + 17), dev), fh))
    torch.cuda.empty_cache()
    task_k = paper_task("auto", dev)
    task_p = paper_task("xla", dev, state=task_k.model.state_dict())
    imgs, _ = train_batch(dev)
    targets = torch.clamp(((imgs[..., 0] + 2.5) * PAPER_CLASSES / 5).long(), 0,
                          PAPER_CLASSES - 1).to(torch.int32)
    return paper_step("paper train", task_k, task_p, imgs, targets,
                      dict(NO_LAUNCHES, final_head_loss_f32=1, final_head_loss_bwd_f32=1),
                      timed, ("total", targets.numel()))


def paper_depth_tail_inputs(gen, dev):
    """The depth paper config's tail operands in f32 (T = 262,144 tokens of batch 2 at
    nside 256, C 96, p 4): (x, we, gamma, beta, wh, t), wh (C, 2) for the heads of one
    channel (its first column) and of two, t the (T, p) network-space targets with
    BACKGROUND of them inf.  The targets are N(1, 1) and the logits centred at 0, so that
    dbeta, whose every column is a multiple of the dlogits' sum over the rows, is not a
    sum that cancels to near 0, where a relative L2 limit of F32_TAIL_TOL would read the
    summation order's noise (``tests/test_torch_depth_tail_sequence.py`` chose so too)."""
    rnd, _ = seeded_draws(gen, dev)
    C, p = 96, TAIL_P
    T = BATCH * 8 * NSIDE * NSIDE // p
    x = rnd(T, C)
    we, wh = rnd(C, p * C, std=0.1), rnd(C, 2, std=0.1)
    g, b = 1.0 + rnd(C, std=0.1), rnd(C, std=0.1)
    return x, we, g, b, wh, depth_targets(gen, T, p, dev, mean=1.0)


def check_f32_depth_kernels(dargs, fh):
    """The f32 K8 and K9 against their plain versions (f32, TF32 off) at the paper depth
    tail, for every loss kind and head of DEPTH_CASES: ``check_depth_kernels`` with its
    f32 limits (the count exact; the loss sum, the predictions and every gradient within
    F32_TAIL_TOL), each step of K9 against its twin (``check_depth_steps``), two K9
    launches bit-equal, and the probes that K9's tile kernel recomputes K8's f32 logits
    bit for bit and that K8's predictions are its logits (the logits taps).  The depth
    step's case (l2, one channel) timed: single call, device time by kernel, plain, and
    the f32 route (``depth_route`` in f32; its device time by ``spin_ms`` too).  Returns
    the timings keyed like the launch counters."""
    x = dargs[0]
    T, p = x.shape[0], TAIL_P
    timed = {}
    for kind, F in DEPTH_CASES:
        args = dargs[:4] + (dargs[4][:, :F].contiguous(), dargs[5])
        timing = (kind, F) == ("l2", 1)
        timed.update(check_depth_kernels("paper depth tail f32", args, p, kind, fh, timing))
        label = f"paper depth tail f32 {kind} F={F}"
        kw = dict(patch_size=p, loss_kind=kind, huber_delta=HUBER_DELTA, impl="pallas")
        with torch.no_grad():
            scale = torch.ones((), device=x.device) / torch.isfinite(args[5]).sum()
            if not timing:
                check_depth_steps(label, args, p, kind, fh, scale, F32_TAIL_TOL)
            _, _, preds, lf8 = fh.final_head_depth_loss_sums(*args, **kw, tap_logits=True)
            lf9 = fh.final_head_depth_loss_bwd_rows(*args, scale, **kw, tap_logits=True)[-1]
            equal_bits(f"{label} probe: K9's recomputed logits vs K8's", lf9, lf8,
                       T * p * F // 2)
            equal_bits(f"{label}: K8's predictions vs its logits tap", preds,
                       lf8.reshape(T, p * F))
            got = fh.final_head_depth_loss_bwd(*args, scale, **kw)
            again = fh.final_head_depth_loss_bwd(*args, scale, **kw)
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"{label}: two K9 launches differ")
            del preds, lf8, lf9, got, again
        log(f"{label}: two K9 launches bit-equal")
    return timed


def drive_paper_depth_train(dev, timed):
    """The depth paper config's own train step at full width and depth (nside 256, batch
    2, f32, dropout and attention dropout 0.1, DropPath 0.1, one output channel, the
    fused masked l2 tail on standardized depths, Adam at 0.005), through the kernels
    ("auto") and through the plain path ("xla") on the same weights, batch and step
    generators.  First the f32 K8/K9 against their plain versions at the paper tail
    (``check_f32_depth_kernels``).  Then the step (``paper_step``) on ``depth_batch``'s
    metric depths, BACKGROUND of them inf, taken into the network's space by the task's
    ``_to_network`` (standardized, as the depth datamodule's transform): the kernel path
    launches one f32 K8 and one f32 K9 and no other kernel.  Returns the kernels'
    launches in step 0 of the kernel path: per kernel, and per operand shape."""
    from heal_swin_torch.ops import final_head as fh

    timed.update(check_f32_depth_kernels(paper_depth_tail_inputs(
        torch.Generator().manual_seed(SEED + 18), dev), fh))
    torch.cuda.empty_cache()
    task_k = paper_task("auto", dev, depth=True)
    task_p = paper_task("xla", dev, state=task_k.model.state_dict(), depth=True)
    imgs, metric_depth = depth_batch(dev)
    targets = task_k._to_network(metric_depth)
    return paper_step("paper depth train", task_k, task_p, imgs, targets,
                      dict(NO_LAUNCHES, final_head_depth_loss_f32=1,
                           final_head_depth_loss_bwd_f32=1),
                      timed, ("count", float(torch.isfinite(targets).sum())))


def paper_step(label, task_k, task_p, imgs, targets, expected, timed, counted,
               attn_dropout=True, steps=PAPER_STEPS, routes=None):
    """A paper config's train step through the kernels (``task_k``, "auto") and through
    the plain path (``task_p``, "xla", the same weights), on the same batch and step
    generators.  Step 0 of each path through ``train_step``: every dropout mask the
    kernel path draws is kept and the plain path's are held to them (``torch.equal``, in
    draw order; masks on the attention probabilities where ``attn_dropout``, none
    where not), and their kept share to 0.9 within 3 standard deviations; the kernel
    path's launches are ``expected``; the two losses agree within PAPER_LOSS_TOL
    relative and every parameter gradient within relative L2 PAPER_GRAD_TOL.  Then
    ``steps`` (PAPER_STEPS) more steps of each path, timed (images/s, peak memory above the
    resident), the loss falling on both, the metric state (``counted``: its count's key
    and what a step adds to it), and a trace of a kernel-path step (device time by
    kernel, idle share).  Returns the kernels' launches in step 0 of the kernel path:
    per kernel, and per operand shape; ``routes``, where given, gets the tail kernels'
    launches of step 0 by route (``read_routes``)."""
    from heal_swin_torch.models import layers
    from heal_swin_torch.training.optimizer import make_optimizer
    from heal_swin_torch.training.trainer import step_generator, train_step

    dev = imgs.device
    opts = [make_optimizer(t.model.parameters(), t.optimizer_config) for t in (task_k, task_p)]
    mstates = [t.metric_init() for t in (task_k, task_p)]

    # step 0 of the kernel path, counted, its masks kept
    draw, masks = layers.keep_mask, []

    def keep(shape, keep_prob, generator, device):
        m = draw(shape, keep_prob, generator, device)
        masks.append(m)
        return m

    layers.keep_mask = keep
    try:
        reset_counters()
        loss_k0, mstates[0] = train_step(task_k, opts[0], mstates[0], imgs, targets,
                                         step_generator(SEED, 0, dev))
        torch.cuda.synchronize()
        launches, by_shape = read_counters()
        if routes is not None:
            routes.update(read_routes())
    finally:
        layers.keep_mask = draw
    check_launches(f"{label} step", launches, by_shape, expected, timed)
    grads_k = {n: q.grad.detach().clone() for n, q in task_k.model.named_parameters()}
    kept = sum(int(m.sum()) for m in masks)
    drawn = sum(m.numel() for m in masks)
    share, sd = kept / drawn, (0.9 * 0.1 / drawn) ** 0.5
    elem = [m for m in masks if m.numel() > m.shape[0]]  # the element masks, not DropPath's
    e_share = None
    if elem:
        e_share = sum(int(m.sum()) for m in elem) / sum(m.numel() for m in elem)
        if abs(e_share - 0.9) > 3 * (0.9 * 0.1 / sum(m.numel() for m in elem)) ** 0.5:
            raise AssertionError(f"{label}: the element masks keep {e_share}")

    # step 0 of the plain path: the same masks, in the same order
    seen = {"n": 0, "differ": 0}

    def same(shape, keep_prob, generator, device):
        m = draw(shape, keep_prob, generator, device)
        i = seen["n"]
        seen["n"] += 1
        if i >= len(masks) or not torch.equal(m, masks[i]):
            seen["differ"] += 1
        return m

    layers.keep_mask = same
    try:
        loss_p0, mstates[1] = train_step(task_p, opts[1], mstates[1], imgs, targets,
                                         step_generator(SEED, 0, dev))
    finally:
        layers.keep_mask = draw
    n_masks, n_attn = len(masks), sum(m.ndim == 5 for m in masks)
    del masks, elem
    if seen["n"] != n_masks or seen["differ"] or (n_attn > 0) != attn_dropout:
        raise AssertionError(f"{label}: the plain path drew {seen} against the kernel "
                             f"path's {n_masks} masks ({n_attn} on attention)")
    log(f"{label}: step 0 drew {seen['n']} masks ({n_attn} on attention probabilities), "
        f"{drawn} entries, on both paths bit-equal in draw order; kept share {share:.6f} "
        f"(element masks {'none' if e_share is None else f'{e_share:.6f}'}; 0.9 within "
        f"3 sd = {3 * sd:.2e})")
    loss_k0, loss_p0 = float(loss_k0), float(loss_p0)
    rel = abs(loss_k0 - loss_p0) / abs(loss_p0)
    if rel > PAPER_LOSS_TOL:
        raise AssertionError(f"{label}: step 0 loss {loss_k0} vs plain {loss_p0}")
    worst, worst_name = 0.0, None
    for n, q in task_p.model.named_parameters():
        if q.grad is None or grads_k[n] is None:
            raise AssertionError(f"{label}: {n} has no gradient")
        err, _ = check_close(f"{label} step 0 gradient {n}", grads_k[n], q.grad,
                             PAPER_GRAD_TOL)
        if err >= worst:
            worst, worst_name = err, n
    log(f"{label}: step 0 loss kernels {loss_k0:.7f} plain {loss_p0:.7f} (rel {rel:.2e}, "
        f"tol {PAPER_LOSS_TOL}); all {len(grads_k)} parameter gradients rel_l2 <= "
        f"{worst:.3e} ({worst_name}; tol {PAPER_GRAD_TOL})")
    del grads_k

    ips_k, mem_k, traj_k, mstates[0] = train_rate(task_k, opts[0], mstates[0], imgs,
                                                  targets, 1, steps)
    ips_p, mem_p, traj_p, mstates[1] = train_rate(task_p, opts[1], mstates[1], imgs,
                                                  targets, 1, steps)
    ips_k2, mem_k2, traj_k2, mstates[0] = train_rate(task_k, opts[0], mstates[0], imgs,
                                                     targets, 1 + steps, steps)
    resident = torch.cuda.memory_allocated() / 2 ** 30
    for path, traj in (("kernels", [loss_k0] + traj_k + traj_k2), ("plain", [loss_p0] + traj_p)):
        log(f"{label}: loss over {len(traj)} steps on one batch ({path}): "
            + " ".join(f"{v:.6f}" for v in traj))
        if not (all(math.isfinite(v) for v in traj) and traj[-1] < traj[0]):
            raise AssertionError(f"{label} ({path}): the loss did not fall: {traj}")
    key, per_step = counted
    for path, task, ms, n in (("kernels", task_k, mstates[0], 1 + 2 * steps),
                              ("plain", task_p, mstates[1], 1 + steps)):
        m = task.metric_compute(ms, "train_")
        if float(ms[key]) != n * per_step or not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label} ({path}): metric state {float(ms[key])}, {m}")
        log(f"{label}: metrics over {n} steps ({path}): "
            + " ".join(f"{k} {v:.4f}" for k, v in m.items()))
    timed[f"{label} img/s"] = (ips_k, ips_k2)
    log(f"{label}: train step kernels {ips_k:.4f} / {ips_k2:.4f} img/s (peak {mem_k:.3f} / "
        f"{mem_k2:.3f} GiB above the resident), plain {ips_p:.4f} img/s (peak {mem_p:.3f} "
        f"GiB above the resident); resident {resident:.3f} GiB (both models' f32 weights, "
        f"their Adam state and the batch)")

    state = dict(step=1 + 2 * steps)

    def one_step():
        train_step(task_k, opts[0], mstates[0], imgs, targets,
                   step_generator(SEED, state["step"], dev))
        state["step"] += 1

    busy = profile(f"{label} profile", one_step, PROFILE_STEPS)
    wall = BATCH / max(ips_k, ips_k2) * 1e3
    log(f"{label} profile: against the untraced {wall:.3f} ms/step the device idles "
        f"{1 - busy / wall:.4f} of the time")
    return launches, by_shape


# ----------------------------------- the paper configs' f32 predict and validation
EVAL_BATCHES = 3  # validation batches of each paper config
# the f32 paths end to end, "auto" against "xla" (the features, the metric depths, the
# validation loss and metrics), relative: the f32 K1/K2/K3 sit within ~1e-6 of their
# plain versions (``check_f32_eval_kernels``: f32 rounding in another summation order),
# and the random-weight network carries an input perturbation on ~10x to the features
# (``paper_predict`` logs the plain path's own move for its input moved by 1e-6), so
# ~1e-5 is expected; the limit leaves a factor 10.  Each block, fed the plain path's
# input, the same: its kernel within ~1e-6, its MLP and LayerNorms plain on both paths
PAPER_EVAL_TOL = 1e-4
PAPER_BLOCK_TOL = 1e-4
PAPER_EVAL_LAUNCHES = dict(window_attention_qkv_epi_f32=20, window_attention_f32=2)
# the depth metrics of 1/p and log p: their condition number is unbounded where a
# predicted depth nears 0 m, and the random-weight depth model predicts depths on both
# sides of 0, so a change of 1e-6 in a depth near 0 moves them by any amount (an H100
# read val_iRMSE 316.07 on the kernel path, 312.92 on the plain path, for depths within
# 3e-6 of each other).  ``paper_validation`` holds them by
# their inputs: each path's value is its metric function of its own predictions, and
# the two paths' predictions agree within PAPER_EVAL_TOL
ILL_CONDITIONED = ("val_iRMSE", "val_SILogE")


def check_f32_eval_kernels(gen, dev, flat=False):
    """The f32 K1, K2 and K3 against their plain versions (f32, TF32 off) at every paper
    shape, each within relative L2 F32_TAIL_TOL: K1 at the three stage shapes with and
    without the mask (two launches bit-equal), K2 at the bottleneck in both flavours, K3
    at the paper tail (T 262,144, C 96, p 4, F 8): its classes equal the plain
    version's outside near-ties of the f32 logits, its logits tap within F32_TAIL_TOL,
    and probe (i), its classes ``argmax_lowest`` of its own tap (``torch.equal``), its
    tap the f32 K6's bits.  Each timed: one call (``median_ms``), its device time
    (``spin_ms``; K1's steps by kernel from a trace), the plain version; K2 beside one f32
    ``scaled_dot_product_attention`` (the library call, scaled-dot) and K3 beside the
    f32 composed PyTorch route (``pred_route``).  With ``flat`` the same at the flat paper
    config's shapes (``stage_inputs``' ``flat``).  Returns the timings keyed like the
    launch counters."""
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.ops import window_attention as wa

    f32 = torch.float32
    timed = {}
    rnd, logit_scales = seeded_draws(gen, dev)
    with torch.no_grad():
        for stage in range(3):
            T, C, h, args = stage_inputs(rnd, logit_scales, stage, dev, flat)
            x, wq, bq, wp, bp, g, b, bias, ls, groups = (
                a.float() if a.dtype == torch.bfloat16 else a for a in args)
            for masked in (False, True):
                a = (x, wq, bq, wp, bp, g, b, groups if masked else None, bias, ls)
                kw = dict(ws=WS, num_heads=h, sm_scale=(C // h) ** -0.5, has_mask=masked)
                label = f"f32 K1 C={C} mask={masked}"
                got = wa.window_attention_qkv_epi(*a, **kw, impl="pallas")
                err, mae = check_close(label, got, wa.window_attention_qkv_epi_plain(*a, **kw),
                                       F32_TAIL_TOL)
                repeat_equal(label, got, wa.window_attention_qkv_epi(*a, **kw, impl="pallas"))
                del got

                def call(a=a, kw=kw):
                    return wa.window_attention_qkv_epi(*a, **kw, impl="pallas")

                ms, dev_ms = median_ms(call), spin_ms(call)
                per, _ = trace(call, SEQUENCE_TRACED)
                pms = median_ms(lambda a=a, kw=kw: wa.window_attention_qkv_epi_plain(*a, **kw))
                steps = ", ".join(  # a step's mean a traced launch (records can drop)
                    f"{k.replace('hs::(anonymous namespace)::', '').split('(')[0]} "
                    f"{v / c:.4f} ms x {c}" for k, (v, c) in
                    sorted(per.items(), key=lambda kv: -kv[1][0]))
                log(f"{label} T={T}: rel_l2 {err:.3e} max_abs {mae:.3e} (tol {F32_TAIL_TOL}), "
                    f"two launches bit-equal; kernel {ms:.4f} ms (device {dev_ms:.4f} ms; "
                    f"{SEQUENCE_TRACED} calls traced: {steps}) plain {pms:.4f} ms")
                timed[("window_attention_qkv_epi_f32", T, C, masked)] = dict(
                    rel_l2=err, max_abs_err=mae, ms=ms, device_ms=dev_ms, plain_ms=pms)
            del x, wq, bq, wp, bp, g, b, bias, ls, groups, args

        T, C, h, (qkv, bias, ls, groups, _) = bottleneck_inputs(rnd, logit_scales, dev, flat)
        qkv = qkv.float()
        for masked in (False, True):
            res = {}
            for use_cos in (True, False):
                a = (qkv, groups if masked else None, bias, ls if use_cos else None)
                kw = dict(ws=WS, num_heads=h, use_cos=use_cos, sm_scale=DOT_SCALE,
                          has_mask=masked)
                label = f"f32 K2 C={C} mask={masked} {'cosine' if use_cos else 'scaled-dot'}"
                got = wa.window_attention(*a, **kw, impl="pallas")
                e2 = check_close(label, got, wa.window_attention_plain(*a, **kw), F32_TAIL_TOL)
                repeat_equal(label, got, wa.window_attention(*a, **kw, impl="pallas"))

                def call(a=a, kw=kw):
                    return wa.window_attention(*a, **kw, impl="pallas")

                res[use_cos] = dict(e=e2, ms=median_ms(call), dev=spin_ms(call),
                                    pms=median_ms(lambda a=a, kw=kw:
                                                  wa.window_attention_plain(*a, **kw)))
            lib_f, _ = sdpa_library(qkv, groups if masked else None, bias, h,
                                    torch.zeros(T, C, device=dev))
            lms, ldev = median_ms(lib_f), spin_ms(lib_f)
            if masked:
                log(f"f32 K2 library call: scaled_dot_product_attention ran "
                    f"{sdpa_kernels(lib_f)}")
            cos, dot = res[True], res[False]
            log(f"f32 K2 window_attention_f32 C={C} T={T} mask={masked}: cosine rel_l2 "
                f"{cos['e'][0]:.3e} max_abs {cos['e'][1]:.3e} kernel {cos['ms']:.4f} ms (device "
                f"{cos['dev']:.4f}) plain {cos['pms']:.4f} ms; scaled-dot rel_l2 "
                f"{dot['e'][0]:.3e} kernel {dot['ms']:.4f} ms (device {dot['dev']:.4f}) plain "
                f"{dot['pms']:.4f} ms; library (f32 sdpa, scaled-dot) {lms:.4f} ms (device "
                f"{ldev:.4f}); two launches bit-equal (tol {F32_TAIL_TOL})")
            timed[("window_attention_f32", T, C, masked)] = dict(
                rel_l2=cos["e"][0], max_abs_err=cos["e"][1], ms=cos["ms"], device_ms=cos["dev"],
                plain_ms=cos["pms"], library_ms=lms, library_device_ms=ldev,
                dot_rel_l2=dot["e"][0], dot_ms=dot["ms"], dot_device_ms=dot["dev"],
                dot_plain_ms=dot["pms"])
        del qkv, lib_f

        largs = paper_tail_inputs(gen, dev, flat)
        args = largs[:5]
        x = args[0]
        T, C = x.shape
        p, F = TAIL_P, PAPER_CLASSES
        preds, tap = fh.final_head_predict(*args, patch_size=p, impl="pallas", tap_logits=True)
        lf = fh.final_head_logits_plain(*args, patch_size=p)
        err, mae = check_close("f32 K3 logits tap", tap, lf, F32_TAIL_TOL)
        slack = F32_TAIL_TOL * lf.abs().amax(-1).clamp_min(1.0)
        mism, near, worst = preds_agree("f32 K3", preds, fh.argmax_lowest(lf), lf, slack)
        equal_bits("f32 K3 probe (i): its classes vs argmax_lowest of its own logits tap",
                   fh.argmax_lowest(tap), preds)
        lf6 = fh.final_head_loss_sums(*largs, patch_size=p, impl="pallas", tap_logits=True)[3]
        equal_bits("f32 K3's logits tap vs the f32 K6's", tap, lf6, T * p * F // 2)
        repeat_equal("f32 K3", preds, fh.final_head_predict(*args, patch_size=p, impl="pallas"))
        del tap, lf, lf6

        def call():
            return fh.final_head_predict(*args, patch_size=p, impl="pallas")

        ms, dev_ms = median_ms(call), spin_ms(call)
        k6dev = spin_ms(lambda: fh.final_head_loss_sums(*largs, patch_size=p, impl="pallas"))
        pms = median_ms(lambda: fh.final_head_predict_plain(*args, patch_size=p))
        route = pred_route(args, p, f32)
        rms, rdev = median_ms(route), spin_ms(route)
    log(f"f32 K3 final_head_predict_f32 T={T} C={C} p={p} F={F}: {mism} of {T * p} classes "
        f"differ, all at near-ties ({near} near-tie elements); logits rel_l2 {err:.3e} "
        f"(tol {F32_TAIL_TOL}); kernel {ms:.4f} ms (device {dev_ms:.4f} ms; the f32 K6 on "
        f"the same operands {k6dev:.4f} ms) plain {pms:.4f} ms f32 route {rms:.4f} ms "
        f"(device {rdev:.4f} ms)")
    timed[("final_head_predict_f32", T, C)] = dict(
        max_abs_err=worst, logits_rel_l2=err, index_mismatches=mism, near_tie_elements=near,
        ms=ms, device_ms=dev_ms, plain_ms=pms, route_ms=rms, route_device_ms=rdev,
        k6_device_ms=k6dev)
    return timed


def eval_batches(dev, depth, task):
    """EVAL_BATCHES validation batches of BATCH samples: seeded images, and targets that
    are a class per bin of the first input channel, or ``depth_batch``'s metric depths
    (BACKGROUND of them inf) taken into the depth task's network space."""
    out = []
    for i in range(EVAL_BATCHES):
        imgs = torch.randn(BATCH, 8 * NSIDE * NSIDE, 3,
                           generator=torch.Generator().manual_seed(SEED + 40 + i)).to(dev)
        if depth:
            metric = 0.1 + 59.9 * torch.sigmoid(imgs[..., 0])
            bg = torch.rand(metric.shape, generator=torch.Generator().manual_seed(SEED + 50 + i))
            targets = task._to_network(torch.where(bg.to(dev) < BACKGROUND, float("inf"),
                                                   metric))
        else:
            targets = torch.clamp(((imgs[..., 0] + 2.5) * PAPER_CLASSES / 5).long(), 0,
                                  PAPER_CLASSES - 1).to(torch.int32)
        out.append((imgs, targets))
    return out


def paper_predict(label, task_k, task_p, imgs, timed, depth):
    """A paper config's predict through the kernels (``task_k``, "auto") and the plain
    path (``task_p``, "xla", the same weights): one counted call (launches 20 f32 K1, 2
    f32 K2 and, for segmentation, 1 f32 K3, no other kernel); every block of the kernel
    path on the plain path's input within PAPER_BLOCK_TOL; the features (segmentation)
    or metric depths within PAPER_EVAL_TOL; segmentation classes equal outside near-ties
    (a top-2 gap under twice the row's largest logit difference between the two paths'
    features, plus K3's own F32_TAIL_TOL), and K3 in the predict equal to the plain tail
    on its own features outside K3's near-ties; img/s and memory above the resident
    (``rate``), a trace (device busy, idle share).  Returns the launches."""
    from heal_swin_torch.models.tasks import decoder_tail
    from heal_swin_torch.ops import final_head as fh

    expected = dict(NO_LAUNCHES, **PAPER_EVAL_LAUNCHES)
    if not depth:
        expected["final_head_predict_f32"] = 1
    feats = {}
    hook = (lambda name: lambda _m, _a, out: feats.update({name: out}))
    keep = task_k.model.register_forward_hook(hook("k"))
    reset_counters()
    out_k = task_k.predict(None, imgs)
    torch.cuda.synchronize()
    launches, by_shape = read_counters()
    keep.remove()
    check_launches(f"{label} predict", launches, by_shape, expected, timed)
    io = {}
    hooks = record_blocks(task_p.model, io)
    hooks.append(task_p.model.register_forward_hook(hook("p")))
    out_p = task_p.predict(None, imgs)
    for hk in hooks:
        hk.remove()
    check_blocks(f"{label} predict", task_k, io, PAPER_BLOCK_TOL)
    del io
    with torch.no_grad():  # the plain path's own sensitivity: its input moved by 1e-6
        noise = torch.randn(imgs.shape, generator=torch.Generator().manual_seed(SEED + 2))
        moved = imgs * (1 + 1e-6 * noise.to(imgs.device))
        amp = (rel_l2(task_p.predict(None, moved), out_p) if depth
               else rel_l2(task_p.model(moved, tail=False), feats["p"]))
    if depth:
        if (tuple(out_k.shape) != tuple(imgs.shape[:-1]) + (1,)
                or out_k.dtype != torch.float32):
            raise AssertionError(f"{label}: predict gave {tuple(out_k.shape)} {out_k.dtype}")
        err = check_close(f"{label} metric depths", out_k, out_p, PAPER_EVAL_TOL)[0]
        log(f"{label}: metric depths in [{float(out_k.min()):.3f}, {float(out_k.max()):.3f}] m, "
            f"kernels vs plain rel_l2 {err:.3e} (tol {PAPER_EVAL_TOL}); plain path, input "
            f"moved by 1e-6 relative: rel_l2 {amp:.3e}")
    else:
        fk, fp = feats["k"], feats["p"]
        B, N, C = fk.shape
        err = check_close(f"{label} tail=False features", fk, fp, PAPER_EVAL_TOL)[0]
        tail = decoder_tail(task_k.model)
        with torch.no_grad():
            lk = fh.final_head_logits_plain(fk.reshape(B * N, C), *tail, patch_size=TAIL_P)
            lp = fh.final_head_logits_plain(fp.reshape(B * N, C), *tail, patch_size=TAIL_P)
            own = F32_TAIL_TOL * lk.abs().amax(-1).clamp_min(1.0)
            rows_k = task_k._kernel_targets(task_k.model, out_k)  # (B*N, p): the tail's rows
            mk, nk, _ = preds_agree(f"{label} K3", rows_k, fh.argmax_lowest(lk), lk, own)
            slack = 2 * (lk - lp).abs().amax(-1) + own
            mism, near, _ = preds_agree(f"{label} classes", rows_k,
                                        task_k._kernel_targets(task_k.model, out_p), lp, slack)
        log(f"{label}: features rel_l2 {err:.3e} (tol {PAPER_EVAL_TOL}; plain path, input "
            f"moved by 1e-6 relative: {amp:.3e}); K3 in predict vs "
            f"the plain tail on its features: {mk} of {out_k.numel()} differ ({nk} near-ties); "
            f"classes kernels vs plain: {mism} differ, all at near-ties ({near} near-tie "
            f"elements)")
        del lk, lp
    del feats
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    ips_k, mem_k = rate(task_k, imgs)
    ips_p, mem_p = rate(task_p, imgs)
    ips_k2, _ = rate(task_k, imgs)
    log(f"{label}: predict kernels {ips_k:.3f} / {ips_k2:.3f} img/s (peak {mem_k:.3f} GiB "
        f"above the resident), plain {ips_p:.3f} img/s (peak {mem_p:.3f} GiB above the "
        f"resident); resident {resident:.3f} GiB (both models' f32 weights and the input)")
    busy = profile(f"{label} profile", lambda: task_k.predict(None, imgs), PROFILE_PREDICTS)
    wall = BATCH / max(ips_k, ips_k2) * 1e3
    log(f"{label} profile: against the untraced {wall:.3f} ms/predict the device idles "
        f"{1 - busy / wall:.4f} of the time")
    timed[f"{label} predict"] = dict(ips=max(ips_k, ips_k2), plain_ips=ips_p, busy_ms=busy,
                                     mem_gib=mem_k)
    return launches, by_shape


def metrics_agree(label, got, want, skip=()):
    """Every metric of the kernel path but ``skip`` within PAPER_EVAL_TOL of the plain
    path's, relative to max(|plain|, 1); NaN only where both are NaN.  Returns the
    largest difference."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: metrics {sorted(got)} vs {sorted(want)}")
    worst = 0.0
    for k, w in want.items():
        if k in skip:
            continue
        v = got[k]
        if math.isnan(w) and math.isnan(v):
            continue
        d = abs(v - w) / max(abs(w), 1.0)
        if not d <= PAPER_EVAL_TOL:
            raise AssertionError(f"{label} {k}: {v} vs plain {w}")
        worst = max(worst, d)
    return worst


def captured_updates(task, into):
    """Record each (outputs, targets, sample mask) ``task.metric_update`` gets, in
    ``into``; returns the undo."""
    update = task.metric_update

    def record(state, out, targets, sample_mask=None):
        into.append((out.detach(), targets, sample_mask))
        return update(state, out, targets, sample_mask=sample_mask)

    task.metric_update = record
    return lambda: delattr(task, "metric_update")


def metric_inputs(task, captured):
    """The metric-space depths (float64, flat) of the recorded validation outputs, and
    the targets, inf where a sample is masked out: what ``metric_update`` compares."""
    ps, ts = [], []
    for out, targets, mask in captured:
        t = task._to_metric(torch.as_tensor(targets, device=out.device))
        t = torch.where(torch.as_tensor(mask, device=out.device).reshape(-1, 1), t,
                        float("inf"))
        ps.append(task._to_metric(out[..., 0]).reshape(-1).double())
        ts.append(t.reshape(-1).double())
    return torch.cat(ps), torch.cat(ts)


def inverse_and_log_metrics(p, t):
    """iRMSE and SILogE of depths ``p`` against targets ``t`` in float64, as
    ``evaluation.metrics.depth_state_update`` / ``depth_state_compute`` define them."""
    inv_p, inv_t = 1.0 / (0.001 * p), 1.0 / (0.001 * t)
    ok = torch.isfinite(inv_p) & torch.isfinite(inv_t)
    irmse = float(((inv_p - inv_t)[ok] ** 2).sum() / max(int(ok.sum()), 1)) ** 0.5
    lv = torch.isfinite(t) & torch.isfinite(p) & (p > 0) & (t > 0)
    d = torch.log(t[lv]) - torch.log(p[lv])
    n = max(int(lv.sum()), 1)
    return {"val_iRMSE": irmse, "val_SILogE": float((d * d).sum() / n - (d.sum() / n) ** 2)}


def paper_validation(label, task_k, task_p, batches, timed, depth):
    """``training.trainer.run_validation`` of a paper config over EVAL_BATCHES batches
    through the kernels and the plain path: the launches of the kernel path's run
    (per batch 20 f32 K1 and 2 f32 K2, and for depth 1 f32 K8; segmentation validation
    passes a sample mask, so its tail is unfused and no K6 runs), ``val_loss`` and every
    metric within PAPER_EVAL_TOL, and the steady-state samples/s.  For depth the
    ILL_CONDITIONED metrics are held by their inputs instead: the two paths' metric
    depths, as ``metric_update`` got them, within relative L2 PAPER_EVAL_TOL, and each
    path's value within PAPER_EVAL_TOL of the same metric of its own depths in float64.
    Returns the launches."""
    from heal_swin_torch.training.trainer import run_validation

    n = EVAL_BATCHES
    expected = dict(NO_LAUNCHES, **{k: v * n for k, v in PAPER_EVAL_LAUNCHES.items()})
    if depth:
        expected["final_head_depth_loss_f32"] = n
    caps = {"k": [], "p": []}
    undo = [captured_updates(task_k, caps["k"]), captured_updates(task_p, caps["p"])]
    try:
        reset_counters()
        vk = run_validation(task_k, iter(batches))
        torch.cuda.synchronize()
        launches, by_shape = read_counters()
        vp = run_validation(task_p, iter(batches))
    finally:
        for u in undo:
            u()
    check_launches(f"{label} validation", launches, by_shape, expected, timed)
    skip = ILL_CONDITIONED if depth else ()
    worst = metrics_agree(f"{label} validation", vk.metrics, vp.metrics, skip)
    if depth:
        (pk, t), (pp, _) = metric_inputs(task_k, caps["k"]), metric_inputs(task_p, caps["p"])
        both = torch.isfinite(t) & torch.isfinite(pk) & torch.isfinite(pp)
        err = check_close(f"{label} validation metric depths", pk[both], pp[both],
                          PAPER_EVAL_TOL)[0]
        for path, v, p in (("kernels", vk, pk), ("plain", vp, pp)):
            own = inverse_and_log_metrics(p, t)
            for k in skip:
                if not abs(v.metrics[k] - own[k]) <= PAPER_EVAL_TOL * max(abs(own[k]), 1.0):
                    raise AssertionError(f"{label} validation {k} ({path}): {v.metrics[k]} "
                                         f"vs {own[k]} of its own depths")
        gap = (pk - pp).abs()[both]
        near0 = int((pk[both].abs() < gap.max()).sum())
        log(f"{label} validation: metric depths kernels vs plain rel_l2 {err:.3e} (tol "
            f"{PAPER_EVAL_TOL}), in [{float(pk[both].min()):.3f}, {float(pk[both].max()):.3f}] "
            f"m, {near0} of {int(both.sum())} within the largest difference "
            f"({float(gap.max()):.3e} m) of 0 m; "
            + ", ".join(f"{k} {vk.metrics[k]:.6f} vs plain {vp.metrics[k]:.6f}" for k in skip)
            + f", each within {PAPER_EVAL_TOL} of its own depths' value in float64")
        del caps, pk, pp, t
    if vk.samples != n * BATCH or not math.isfinite(vk.metrics["val_loss"]):
        raise AssertionError(f"{label} validation: {vk}")
    rate_k = vk.steady_samples / vk.steady_time
    rate_p = vp.steady_samples / vp.steady_time
    log(f"{label} validation over {n} batches: every metric within {worst:.3e} of the plain "
        f"path's (tol {PAPER_EVAL_TOL}); steady {rate_k:.3f} samples/s (plain {rate_p:.3f}); "
        + " ".join(f"{k} {v:.6f}" for k, v in vk.metrics.items() if "class" not in k))
    timed[f"{label} validation"] = dict(samples_per_s=rate_k, plain_samples_per_s=rate_p)
    return launches, by_shape


def paper_chamfer_predict(task, dev):
    """The Chamfer writer through the predict loop (``training.trainer.predict``): the
    depth paper config predicts 2 samples, a batch each (one batch in flight), and the
    writer scores them; the same writer's metrics from direct calls on the predictions
    the loop handed it must be the same bits, and those predictions a direct predict's."""
    from heal_swin_torch.evaluation.hp_depth_pred_writers import (
        WoodscapeHPDepthChamferDistBestWorstPredictionWriter as Writer)
    from heal_swin_torch.training.trainer import predict

    batch = chamfer_targets(2)
    kw = dict(nside=NSIDE, base_pix=8, mask_background=True, normalize_data="standardize",
              data_transform=None, rotate_pole=False, device=dev)
    batches = []
    for i in range(2):
        b = {k: v[i:i + 1] for k, v in batch.items()}
        b["hp_imgs"] = torch.randn(1, 8 * NSIDE * NSIDE, 3,
                                   generator=torch.Generator().manual_seed(SEED + 60 + i)).to(dev)
        batches.append(b)
    logged, handed = {}, []
    loop = Writer(**kw)
    loop.log_metrics = lambda mets: logged.update(loop=mets)
    write = loop.write_on_batch_end
    loop.write_on_batch_end = lambda preds, b, i: (handed.append(preds), write(preds, b, i))
    t0 = time.perf_counter()
    run = predict(task, iter(batches), writer=loop)
    t_loop = time.perf_counter() - t0
    direct = Writer(**kw)
    direct.log_metrics = lambda mets: logged.update(direct=mets)
    for i, (preds, b) in enumerate(zip(handed, batches)):
        if not np.array_equal(preds, task.predict(None, b["hp_imgs"]).cpu().numpy()):
            raise AssertionError(f"paper chamfer: batch {i}'s predictions are not a predict's")
        direct.write_on_batch_end(preds, b, i)
    direct.on_predict_epoch_end()
    mets = logged["loop"]
    if len(mets) != 4 or mets != logged["direct"] or not all(map(math.isfinite, mets.values())):
        raise AssertionError(f"paper chamfer: {mets} through predict, {logged['direct']} direct")
    log(f"paper depth chamfer through predict ({run.samples} samples, {len(batches)} batches, "
        f"{t_loop:.3f} s; host blocked on the device {run.device_time:.3f} s, writer "
        f"{run.writer_time:.3f} s): the four metrics bit-equal to direct calls: "
        + " ".join(f"{k} {v:.6f}" for k, v in mets.items()))


def drive_paper_eval(dev, timed):
    """The paper configs' f32 forward in eval mode (nside 256, batch 2, f32, full width and
    depth; dropout inactive at eval, so every block at C <= 384 runs the f32 K1 and the
    bottleneck the f32 K2): first ``check_f32_eval_kernels``; then for the segmentation
    and the depth paper config, built as ``paper_task`` builds them ("auto" and "xla" on
    the same weights), ``paper_predict`` and ``paper_validation``; last the Chamfer writer
    through the predict loop (``paper_chamfer_predict``).  Returns the launches of the
    segmentation predict, which runs the three new kernels."""
    timed.update(check_f32_eval_kernels(torch.Generator().manual_seed(SEED + 20), dev))
    torch.cuda.empty_cache()
    runs = {}
    for depth in (False, True):
        label = "paper depth eval" if depth else "paper eval"
        task_k = paper_task("auto", dev, depth=depth)
        task_p = paper_task("xla", dev, state=task_k.model.state_dict(), depth=depth)
        imgs = torch.randn(BATCH, 8 * NSIDE * NSIDE, 3,
                           generator=torch.Generator().manual_seed(SEED + 30)).to(dev)
        runs[depth] = paper_predict(label, task_k, task_p, imgs, timed, depth)
        paper_validation(label, task_k, task_p, eval_batches(dev, depth, task_k), timed, depth)
        if depth:
            del task_p
            torch.cuda.empty_cache()
            paper_chamfer_predict(task_k, dev)
        del task_k
        torch.cuda.empty_cache()
    return runs[False]


# -------------------------- f32 window-attention training: the paper step, attention dropout off
# the paper segmentation config's train step with attention dropout off (the JAX config
# default), where every block runs the f32 window-attention kernels both ways: (a) proj
# dropout 0.1 active, so the blocks at C <= 384 take K16/K17; (b) dropout 0 as well, so
# they take K1/K4; the bottleneck K2/K5 in both.  DropPath 0.1 stays in both.  (c), the
# f32 MLP phase's (``drive_f32_mlp``): (b) with mlp_impl="fused" set on every block's
# Mlp, so that each block's MLP backward runs the f32 K13.
F32_TRAIN_VARIANTS = {"a": dict(attn_drop_rate=0.0),
                      "b": dict(attn_drop_rate=0.0, drop_rate=0.0),
                      "c": dict(attn_drop_rate=0.0, drop_rate=0.0)}
F32_TRAIN_LAUNCHES = {
    "a": dict(window_attention_qkv_f32=20, window_attention_qkv_bwd_f32=20,
              window_attention_f32=2, window_attention_bwd_f32=2, final_head_loss_f32=1,
              final_head_loss_bwd_f32=1),
    "b": dict(window_attention_qkv_epi_f32=20, window_attention_qkv_epi_bwd_f32=20,
              window_attention_f32=2, window_attention_bwd_f32=2, final_head_loss_f32=1,
              final_head_loss_bwd_f32=1)}
F32_TRAIN_LAUNCHES["c"] = dict(F32_TRAIN_LAUNCHES["b"], mlp_bwd_f32=22)
F32_PLAIN_RUNS = 5  # timed calls of an f32 backward's plain version (each 0.1-0.5 s)


def f32_train_timing(label, call, plain, route=None):
    """One f32 kernel's timings: one call (``median_ms``), its device time (``spin_ms``),
    the plain version (median of F32_PLAIN_RUNS), and a PyTorch route or library call
    (``route``: (field, fn)) where one computes the same function."""
    res = dict(ms=median_ms(call), device_ms=spin_ms(call),
               plain_ms=median_ms(plain, runs=F32_PLAIN_RUNS, warmup=1))
    if route is not None:
        field, fn = route
        res[field] = median_ms(fn)
        res[field.replace("_ms", "_device_ms")] = spin_ms(fn)
    log(f"{label}: kernel {res['ms']:.4f} ms (device {res['device_ms']:.4f}) plain "
        f"{res['plain_ms']:.4f} ms" + ("" if route is None else
                                       f" {route[0][:-3]} {res[route[0]]:.4f} ms (device "
                                       f"{res[route[0].replace('_ms', '_device_ms')]:.4f})"))
    return res


def log_f32_sequence(label, call):
    """One launch sequence's kernels, traced over SEQUENCE_TRACED calls: each kernel's
    device ms and launches a call."""
    per, _ = trace(call, SEQUENCE_TRACED)
    log(f"{label}: {SEQUENCE_TRACED} calls traced, a call: "
        + ", ".join(f"{k.replace('hs::(anonymous namespace)::', '').split('(')[0]} "
                    f"{v / SEQUENCE_TRACED:.4f} ms x {c / SEQUENCE_TRACED:.0f}"
                    for k, (v, c) in sorted(per.items(), key=lambda kv: -kv[1][0])))


def short_kernel_name(name: str) -> str:
    """A profiler kernel name without its namespace, return type and arguments."""
    return name.replace("hs::(anonymous namespace)::", "").replace("void ", "").split("(")[0]


# the f32 K4's and K17's kernels by route: the mma.sync product runs only the recomputed
# qkv and u (NN); the backwards' own products (dWp, do, dWqkv, dx) are the wgmma core's NT
# and TN instantiations
F32_BWD_MMA_SYNC = "gemm_3xtf32_kernel<false, false, EpiBias, false>"
F32_BWD_WG = ("gemm_3xtf32_wg_kernel<true, true, true, false, WgEpiStore<false> >",
              "gemm_3xtf32_wg_kernel<false, false, false, false, WgEpiPartial>")
# the kernels of a cosine f32 K17 call, and those K4 adds (K16's attention, the LayerNorm
# backward)
F32_K17_KERNELS = (F32_BWD_MMA_SYNC,) + F32_BWD_WG + ("attn_bwd_3xtf32_kernel<true>",
                                                    "reduce_rows_kernel")
F32_K4_KERNELS = F32_K17_KERNELS + ("attn_3xtf32_kernel", "ln_bwd_rows_f32_kernel")


def per_call_by_kernel(per, calls=SEQUENCE_TRACED):
    """A trace of ``calls`` calls of one launch sequence (``trace``'s device ms and launches
    by kernel name) as kernel -> (device ms, launches) a call, by ``short_kernel_name``: each
    kernel's mean over its recorded launches times its launches a call, its records over
    ``calls`` rounded up (the profiler can drop a launch's records; every call launches the
    same kernels).  Also whether every kernel's records came whole (a multiple of ``calls``)."""
    rec = collections.defaultdict(lambda: [0.0, 0])
    for k, (ms, n) in per.items():
        short = short_kernel_name(k)
        rec[short][0] += ms
        rec[short][1] += n
    out = {k: (ms / n * math.ceil(n / calls), math.ceil(n / calls)) for k, (ms, n) in rec.items()}
    return out, all(n % calls == 0 for _, n in rec.values())


def trace_f32_bwd(label, call, kernels):
    """SEQUENCE_TRACED calls of an f32 K4 or K17 call traced by kernel (again, up to
    SEQUENCE_TRACES times, until each of its ``kernels`` is recorded and every record came
    whole: the profiler can drop a launch's records), logged, and its route checked: every
    mma.sync product an NN (the recomputed qkv and u), the NT and TN products the wgmma
    core's.  Returns ``per_call_by_kernel`` of the trace."""
    for _ in range(SEQUENCE_TRACES):
        call_ms, whole = per_call_by_kernel(trace(call, SEQUENCE_TRACED)[0])
        missing = [k for k in kernels if k not in call_ms]
        if whole and not missing:
            break
    log(f"{label}: {SEQUENCE_TRACED} calls traced, a call: " + ", ".join(
        f"{k} {ms:.4f} ms x {n}" for k, (ms, n) in sorted(call_ms.items(),
                                                          key=lambda kv: -kv[1][0]))
        + ("" if whole else " (some records dropped in every trace)"))
    stray = [k for k in call_ms if "gemm_3xtf32_kernel" in k and k != F32_BWD_MMA_SYNC]
    if stray or any(w in missing for w in F32_BWD_WG):
        raise AssertionError(f"{label}: mma.sync products other than the recomputes {stray}, "
                             f"kernels not recorded {missing}")
    return call_ms


def log_f32_bwd_sequences(timed, runs):
    """The f32 K4's launch sequence by kernel over step (b)'s f32 K4 launches and the f32
    K17's over step (a)'s: each kernel's device ms and launches in one traced call at each
    shape (``check_f32_train_kernels``, ``trace_f32_bwd``), weighted by the step's launches
    at that shape (``runs``: variant -> launches per kernel, per shape)."""
    for kernel, variant, name in (("window_attention_qkv_epi_bwd_f32", "b", "f32 K4"),
                                  ("window_attention_qkv_bwd_f32", "a", "f32 K17")):
        total = collections.defaultdict(lambda: [0.0, 0.0])
        for key, n in runs[variant][1].items():
            if key[0] == kernel:
                for k, (ms, cnt) in timed[("f32_sequence",) + key].items():
                    total[k][0] += n * ms
                    total[k][1] += n * cnt
        log(f"{name} sequence over step ({variant})'s {name} launches: "
            f"{sum(ms for ms, _ in total.values()):.4f} ms on the device")
        for k, (ms, cnt) in sorted(total.items(), key=lambda kv: -kv[1][0]):
            log(f"{name} sequence: {ms:9.4f} ms {cnt:6.1f} launches  {k}")


def f32_bwd_steps(x, wq, bq, wp, bp, g, groups, bias, ls, dz, *, num_heads, use_cos,
                  sm_scale, has_mask, epi, ws=WS, impl="pallas"):
    """The f32 K4 (``epi``: cosine, sm_scale 1) or the f32 K17 as the composition of its
    steps' own wrappers, in its outputs' order: qkv by the forwards' product
    (``gemm_nn_f32``: the f32 K1's and K16's step 1); for K4 o by the f32 K2 (K16's step
    2), du and [dbp | dgamma | dbeta] by ``qkv_epi_proj_ln_bwd`` (u by the f32 K1's step
    3, then the LayerNorm backward), dWp = o^T du and do = du Wp^T by the wgmma core
    (``gemm_wg_f32``); then the f32 K5 (dqkv, dbias, dls), dx = dqkv Wqkv^T and dWqkv =
    x^T dqkv by the wgmma core, dbqkv by ``reduce_rows``.  On the card the kernels must be
    these steps bit for bit; on the CPU each step is its plain version."""
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.ops import mlp as tm
    from heal_swin_torch.ops import window_attention as wa

    akw = dict(ws=ws, num_heads=num_heads, use_cos=use_cos, sm_scale=sm_scale,
               has_mask=has_mask, impl=impl)
    qkv = wa.gemm_nn_f32(x, wq, bq, impl=impl)
    out = ()
    if epi:
        o = wa.window_attention_fwd(qkv, groups, bias, ls, **akw)
        du, dbp, dg, dbe = wa.qkv_epi_proj_ln_bwd(o, wp, bp, g, dz, impl=impl)
        out = (tm.gemm_wg_f32(o, du, "tn", impl=impl), dbp, dg, dbe)
        dz = tm.gemm_wg_f32(du, wp, "nt", impl=impl)
    dqkv, dbias, dls = wa.window_attention_bwd(qkv, groups, bias, ls, dz, **akw)
    return (tm.gemm_wg_f32(dqkv, wq, "nt", impl=impl), tm.gemm_wg_f32(x, dqkv, "tn", impl=impl),
            fh.reduce_rows(dqkv, impl=impl)) + out + (dbias, dls)


def same_outputs(label, got, want):
    """Two launches' (or a kernel's and its steps') outputs equal bit for bit, None where
    the other is None."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} outputs against {len(want)}")
    for i, (u, v) in enumerate(zip(got, want)):
        if (u is None) != (v is None) or (u is not None and not torch.equal(u, v)):
            raise AssertionError(f"{label}: output {i} differs")


def check_f32_train_kernels(gen, dev, flat=False):
    """The f32 K16, K17, K4 and K5 against their plain versions (f32, TF32 off) at every
    stage shape of the f32 train step, each output within relative L2 F32_TAIL_TOL and
    two launches bit-equal: K16 / K17 at the three stage shapes (T 262,144 / 65,536 /
    16,384, C 96 / 192 / 384) and at their halves (a ragged batch of 1), cosine and
    scaled-dot, masked and unmasked; K4 there with and without LayerNorm; K5 at the
    bottleneck (T 4,096, C 768) in both flavours.  K17 and K4 are also their steps
    composed bit for bit (``f32_bwd_steps``: the recomputed qkv and u are the forwards'
    products' bits, dWp, do, dWqkv and dx the wgmma core's).  With ``flat`` the same on the
    flat model's shapes of batch 2, 9-region groups and 2-D rel-pos bias (checked, not
    timed).  Timed at the flavours the step runs (``f32_train_timing``), at batch 2: K16 /
    K17 cosine beside the f32 composed route of their scaled-dot function (``sdpa_route``,
    f32), K4 with LayerNorm (no PyTorch call computes it), K5 cosine beside one f32
    ``scaled_dot_product_attention`` backward (``sdpa_library``, scaled-dot); K4 with
    LayerNorm and K17 cosine traced by kernel (``trace_f32_bwd``, keyed ("f32_sequence",
    kernel, T, C, masked)).  Returns the timings keyed like the launch counters."""
    from heal_swin_torch.ops import window_attention as wa

    timed = {}
    rnd, logit_scales = seeded_draws(gen, dev)
    where = "flat " if flat else ""
    for stage in range(3):
        T2, C, h, args = stage_inputs(rnd, logit_scales, stage, dev, flat)
        x2, wq, bq, wp, bp, g, b, bias, ls, groups2 = (
            a.float() if a.dtype == torch.bfloat16 else a for a in args)
        dz2 = rnd(T2, C)
        for batch in (BATCH,) if flat else (BATCH, 1):
            T = T2 * batch // BATCH
            x, dz, groups = x2[:T], dz2[:T], groups2[:T // WS]
            timing = not flat and batch == BATCH
            for masked in (False, True):
                gr = groups if masked else None
                for use_cos in (True, False):
                    a = (x, wq, bq, gr, bias, ls if use_cos else None)
                    kw = dict(ws=WS, num_heads=h, use_cos=use_cos, sm_scale=DOT_SCALE,
                              has_mask=masked)
                    label = (f"{where}C={C} T={T} mask={masked} "
                             f"{'cosine' if use_cos else 'scaled-dot'}")
                    got = wa.window_attention_qkv_fwd(*a, **kw, impl="pallas")
                    e16 = check_close(f"f32 K16 {label}", got,
                                      wa.window_attention_qkv_plain(*a, **kw), F32_TAIL_TOL)
                    repeat_equal(f"f32 K16 {label}", got,
                                 wa.window_attention_qkv_fwd(*a, **kw, impl="pallas"))
                    got = wa.window_attention_qkv_bwd(*a, dz, **kw, impl="pallas")
                    e17 = check_grads(f"f32 K17 {label}", K17_GRADS, got,
                                      wa.window_attention_qkv_bwd_plain(*a, dz, **kw),
                                      F32_TAIL_TOL)
                    same_outputs(f"f32 K17 {label}: two launches", got,
                                 wa.window_attention_qkv_bwd(*a, dz, **kw, impl="pallas"))
                    same_outputs(f"f32 K17 {label}: the kernel against its steps", got,
                                 f32_bwd_steps(x, wq, bq, None, None, None, gr, bias, a[5], dz,
                                               epi=False, **kw))
                    del got
                    log(f"f32 K16 {label}: rel_l2 {e16[0]:.3e} max_abs {e16[1]:.3e}; f32 K17 "
                        f"rel_l2 <= {e17[0]:.3e} max_abs {e17[1]:.3e} (tol {F32_TAIL_TOL}); two "
                        f"launches of each bit-equal; K17 its steps composed, bit-equal")
                    if not timing or not use_cos:
                        continue
                    route_f, route_b = sdpa_route(x, wq, bq, gr, bias, h)
                    key = (T, C, masked)

                    def call17(a=a, kw=kw):
                        return wa.window_attention_qkv_bwd(*a, dz, **kw, impl="pallas")

                    timed[("f32_sequence", "window_attention_qkv_bwd_f32") + key] = \
                        trace_f32_bwd(f"f32 K17 {label}", call17, F32_K17_KERNELS)
                    timed[("window_attention_qkv_f32",) + key] = dict(
                        rel_l2=e16[0], max_abs_err=e16[1], **f32_train_timing(
                            f"f32 K16 {label}", lambda: wa.window_attention_qkv_fwd(
                                *a, **kw, impl="pallas"),
                            lambda: wa.window_attention_qkv_plain(*a, **kw),
                            ("route_ms", route_f)))
                    timed[("window_attention_qkv_bwd_f32",) + key] = dict(
                        rel_l2=e17[0], max_abs_err=e17[1], **f32_train_timing(
                            f"f32 K17 {label}", call17,
                            lambda: wa.window_attention_qkv_bwd_plain(*a, dz, **kw),
                            ("route_ms", route_b)))
                    del route_f, route_b
                for has_ln in (True, False):
                    a = (x, wq, bq, wp, bp, g if has_ln else None, b if has_ln else None, gr,
                         bias, ls)
                    kw = dict(ws=WS, num_heads=h, sm_scale=1.0, has_mask=masked)
                    label = f"{where}C={C} T={T} mask={masked} LayerNorm={has_ln}"
                    got = wa.window_attention_qkv_epi_bwd(*a, dz, **kw, impl="pallas")
                    e4 = check_grads(f"f32 K4 {label}", K4_GRADS, got,
                                     wa.window_attention_qkv_epi_bwd_plain(*a, dz, **kw),
                                     F32_TAIL_TOL)
                    same_outputs(f"f32 K4 {label}: two launches", got,
                                 wa.window_attention_qkv_epi_bwd(*a, dz, **kw, impl="pallas"))
                    same_outputs(f"f32 K4 {label}: the kernel against its steps", got,
                                 f32_bwd_steps(*a[:6], gr, bias, ls, dz, num_heads=h,
                                               use_cos=True, sm_scale=1.0, has_mask=masked,
                                               epi=True))
                    del got
                    log(f"f32 K4 {label}: rel_l2 <= {e4[0]:.3e} max_abs {e4[1]:.3e} (tol "
                        f"{F32_TAIL_TOL}); two launches bit-equal; its steps composed, "
                        f"bit-equal")
                    if not timing or not has_ln:
                        continue

                    def call(a=a, kw=kw):
                        return wa.window_attention_qkv_epi_bwd(*a, dz, **kw, impl="pallas")

                    timed[("f32_sequence", "window_attention_qkv_epi_bwd_f32", T, C, masked)] = \
                        trace_f32_bwd(f"f32 K4 {label}", call, F32_K4_KERNELS)
                    timed[("window_attention_qkv_epi_bwd_f32", T, C, masked)] = dict(
                        rel_l2=e4[0], max_abs_err=e4[1], **f32_train_timing(
                            f"f32 K4 {label}", call,
                            lambda a=a, kw=kw: wa.window_attention_qkv_epi_bwd_plain(
                                *a, dz, **kw)))
        del x2, x, wq, bq, wp, bp, g, b, bias, ls, groups2, groups, args, dz2, dz
        torch.cuda.empty_cache()

    T, C, h, (qkv, bias, ls, groups, dout) = bottleneck_inputs(rnd, logit_scales, dev, flat)
    qkv, dout = qkv.float(), dout.float()
    for masked in (False, True):
        gr = groups if masked else None
        for use_cos in (True, False):
            a = (qkv, gr, bias, ls if use_cos else None)
            kw = dict(ws=WS, num_heads=h, use_cos=use_cos, sm_scale=DOT_SCALE, has_mask=masked)
            label = f"{where}C={C} T={T} mask={masked} {'cosine' if use_cos else 'scaled-dot'}"
            got = wa.window_attention_bwd(*a, dout, **kw, impl="pallas")
            e5 = check_grads(f"f32 K5 {label}", K5_GRADS, got,
                             wa.window_attention_bwd_plain(*a, dout, **kw), F32_TAIL_TOL)
            same_outputs(f"f32 K5 {label}: two launches", got,
                         wa.window_attention_bwd(*a, dout, **kw, impl="pallas"))
            del got
            log(f"f32 K5 {label}: rel_l2 <= {e5[0]:.3e} max_abs {e5[1]:.3e} (tol "
                f"{F32_TAIL_TOL}); two launches bit-equal")
            if flat or not use_cos:
                continue
            _, lib_b = sdpa_library(qkv, gr, bias, h, dout)
            timed[("window_attention_bwd_f32", T, C, masked)] = dict(
                rel_l2=e5[0], max_abs_err=e5[1], **f32_train_timing(
                    f"f32 K5 {label}", lambda: wa.window_attention_bwd(*a, dout, **kw,
                                                                      impl="pallas"),
                    lambda: wa.window_attention_bwd_plain(*a, dout, **kw),
                    ("library_ms", lib_b)))
            del lib_b
    del qkv, dout
    torch.cuda.empty_cache()
    return timed


def drive_f32_attention_train(dev, timed):
    """The paper segmentation config's f32 train step at full width and depth with
    attention dropout off, through the f32 window-attention kernels both ways: first
    ``check_f32_train_kernels`` on HEALPix and on flat operands, then for each of
    F32_TRAIN_VARIANTS the step (``paper_step``: "auto" against "xla" on the same
    weights, batch and step generators; equal masks, loss 1e-5, every gradient 1e-4,
    the exact launches F32_TRAIN_LAUNCHES, rate, memory, profile) for variants (a) and
    (b), and the f32 K17's and K4's device ms by kernel over their steps' launches
    (``log_f32_bwd_sequences``).  Returns the variants' step-0 launches, per kernel and per
    shape."""
    timed.update(check_f32_train_kernels(torch.Generator().manual_seed(SEED + 40), dev))
    check_f32_train_kernels(torch.Generator().manual_seed(SEED + 41), dev, flat=True)
    imgs, _ = train_batch(dev)
    targets = torch.clamp(((imgs[..., 0] + 2.5) * PAPER_CLASSES / 5).long(), 0,
                          PAPER_CLASSES - 1).to(torch.int32)
    runs = {}
    for variant in ("a", "b"):
        over = F32_TRAIN_VARIANTS[variant]
        task_k = paper_task("auto", dev, overrides=over)
        task_p = paper_task("xla", dev, state=task_k.model.state_dict(), overrides=over)
        runs[variant] = paper_step(
            f"f32 attention train ({variant})", task_k, task_p, imgs, targets,
            dict(NO_LAUNCHES, **F32_TRAIN_LAUNCHES[variant]), timed,
            ("total", targets.numel()), attn_dropout=False)
        del task_k, task_p
        torch.cuda.empty_cache()
    log_f32_bwd_sequences(timed, runs)
    return runs


# ------------------------------------------------ the MLP kernels in float32 (f32 K12-K15)
F32_MLP_KERNELS = ("mlp_fwd_f32", "mlp_bwd_f32", "mlp_block_fwd_f32", "mlp_block_bwd_f32")


def f32_mlp_inputs(rnd, dev, T, C, B):
    """The f32 MLP family's seeded operands at a stage shape (T, C, H = 4C) of batch B:
    args = (x, w1, b1, w2, b2, gamma, beta) and the output gradient dz, all f32 (not
    bf16 values: their TF32 split would leave no low part), and the DropPath scale of
    the batch's draw (ds, (T, 1)): of two samples one kept, one dropped; a batch of 1
    kept."""
    H = 4 * C
    args = (rnd(T, C), rnd(C, H, std=C ** -0.5), rnd(H, std=0.1), rnd(H, C, std=H ** -0.5),
            rnd(C, std=0.1), 1 + rnd(C, std=0.1), rnd(C, std=0.1))
    ds = torch.full((T, 1), 1 / DROP_KEEP)
    if B == 2:
        ds[T // 2:] = 0.0
    return args, rnd(T, C), ds.to(dev)


def check_core_products(tm, rnd, T, C, tol):
    """The f32 K13's and K15's products alone on their wgmma core (``gemm_wg_f32``) at a
    stage shape against torch f32 (TF32 off): x W1 (NN, T x H over C), dout W2^T (NT, T x
    H over C), dh W1^T (NT, T x C over H), g^T dout (TN, H x C over T, split over the
    tokens); and the f32 K13's dual product (``mlp_dual``: g, dh, db1, db2) against
    ``mlp_dual_plain``.  Each within relative L2 ``tol``; the largest error returned."""
    H = 4 * C
    worst = 0.0
    with torch.no_grad():
        for layout, M, N, K in (("nn", T, H, C), ("nt", T, H, C), ("nt", T, C, H),
                                ("tn", H, C, T)):
            a = rnd(K, M) if layout == "tn" else rnd(M, K)
            b = rnd(N, K) if layout == "nt" else rnd(K, N)
            e = check_close(f"f32 wgmma core {layout} M={M} N={N} K={K}",
                            tm.gemm_wg_f32(a, b, layout, impl="pallas"),
                            tm.gemm_wg_f32_plain(a, b, layout), tol)
            worst = max(worst, e[0])
            del a, b
        x, w1, b1, w2, dout = (rnd(T, C), rnd(C, H, std=C ** -0.5), rnd(H, std=0.1),
                               rnd(H, C, std=H ** -0.5), rnd(T, C))
        for approximate in (True, False):
            e = check_grads(f"f32 K13 dual product T={T} C={C} tanh={approximate}",
                            ("g", "dh", "db1", "db2"),
                            tm.mlp_dual(x, w1, b1, w2, dout, approximate=approximate,
                                        impl="pallas"),
                            tm.mlp_dual_plain(x, w1, b1, w2, dout, approximate=approximate),
                            tol)
            worst = max(worst, e[0])
    log(f"f32 wgmma core T={T} C={C}: NN, NT, NT, TN products and the dual product rel_l2 "
        f"<= {worst:.3e} (tol {tol})")
    return worst


def check_f32_mlp_kernels(gen, dev):
    """The f32 K12-K15 against their plain versions (f32, TF32 off) at every stage shape
    of the paper model at batch 2 and at a ragged batch of 1 (T 262,144 / 65,536 /
    16,384 / 4,096 and their halves, C 96 / 192 / 384 / 768, H = 4C), both GELUs, K14 /
    K15 with no DropPath scale and with the batch's draw: every output and gradient
    within relative L2 F32_TAIL_TOL (K14 / K15 on the branch, z - x and dx - dz), two
    launches of each bit-equal; at the batch-2 shapes the wgmma core's products alone and
    the dual product too (``check_core_products``).  At the batch-2 shapes, with the paper
    config's exact GELU, each is timed (``f32_train_timing``: one call, its device ms by
    ``spin_ms``, the plain version, and the f32 route of the same function,
    ``mlp_route``: F.linear -> GELU -> F.linear [-> LayerNorm, DropPath, residual] with
    autograd, TF32 off) and its workspace logged; K13's and K15's launch sequences are
    traced by kernel at every stage shape of both batches.  Returns the timings keyed
    like the launch counters."""
    from heal_swin_torch import _build
    from heal_swin_torch.ops import mlp as tm

    tol, lib, timed = F32_TAIL_TOL, _build.lib(), {}

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    for B in (BATCH, 1):
        for T2, C in mlp_stages():
            T, H = T2 * B // BATCH, 4 * C
            if B == BATCH:
                check_core_products(tm, rnd, T, C, tol)
                torch.cuda.empty_cache()
            args, dz, ds = f32_mlp_inputs(rnd, dev, T, C, B)
            x, a5 = args[0], args[:5]
            errs = {}
            for approximate in (True, False):
                kw = dict(approximate=approximate)
                pk = dict(kw, impl="pallas")
                label = f"T={T} C={C} batch {B} tanh={approximate}"
                with torch.no_grad():
                    got = tm.mlp_fwd(*a5, **pk)
                    e12 = check_close(f"f32 K12 {label}", got, tm.mlp_plain(*a5, **kw), tol)
                    repeat_equal(f"f32 K12 {label}", got, tm.mlp_fwd(*a5, **pk))
                    got = tm.mlp_bwd(*a5, dz, **pk)
                    e13 = check_grads(f"f32 K13 {label}", MLP_GRADS, got,
                                      tm.mlp_bwd_plain(*a5, dz, **kw), tol)
                    if not all(torch.equal(u, v) for u, v in
                               zip(got, tm.mlp_bwd(*a5, dz, **pk))):
                        raise AssertionError(f"f32 K13 {label}: two launches differ")
                    errs[("mlp_fwd_f32", approximate)] = e12
                    errs[("mlp_bwd_f32", approximate)] = e13
                    for d in (None, ds):
                        dl = f"{label} dscale={d is not None}"
                        got = tm.mlp_block_fwd(*args, d, **pk)
                        e14 = check_close(f"f32 K14 {dl} branch z - x", got - x,
                                          tm.mlp_block_plain(*args, d, **kw) - x, tol)
                        repeat_equal(f"f32 K14 {dl}", got, tm.mlp_block_fwd(*args, d, **pk))
                        got = tm.mlp_block_bwd(*args, d, dz, **pk)
                        want = tm.mlp_block_bwd_plain(*args, d, dz, **kw)
                        e15 = check_grads(f"f32 K15 {dl}", ("dx - dz",) + MLP_BLOCK_GRADS[1:],
                                          (got[0] - dz,) + got[1:], (want[0] - dz,) + want[1:],
                                          tol)
                        if not all(torch.equal(u, v) for u, v in
                                   zip(got, tm.mlp_block_bwd(*args, d, dz, **pk))):
                            raise AssertionError(f"f32 K15 {dl}: two launches differ")
                        errs[("mlp_block_fwd_f32", approximate, d is not None)] = e14
                        errs[("mlp_block_bwd_f32", approximate, d is not None)] = e15
                    del got, want
                log(f"f32 K12-K15 {label}: rel_l2 K12 {e12[0]:.3e}, K13 <= {e13[0]:.3e}, "
                    + ", ".join(f"{k[0][:-4]} dscale={k[2]} <= {v[0]:.3e}"
                                for k, v in errs.items() if len(k) == 3 and k[1] == approximate)
                    + f" (tol {tol}); two launches of each bit-equal")
            if B != BATCH:
                pk = dict(approximate=False, impl="pallas")
                log_f32_sequence(f"f32 K13 sequence T={T} C={C} batch 1 tanh=False",
                                 lambda: tm.mlp_bwd(*a5, dz, **pk))
                log_f32_sequence(f"f32 K15 sequence T={T} C={C} batch 1 tanh=False "
                                 f"dscale=True", lambda: tm.mlp_block_bwd(*args, ds, dz, **pk))
            if B == BATCH:
                log(f"f32 K12-K15 T={T} C={C} H={H}: workspace K12 / K14 "
                    f"{lib.hs_mlp_fwd_f32_workspace(T, C, H)} bytes (g), K13 "
                    f"{lib.hs_mlp_bwd_f32_workspace(T, C, H)} (g, dh, partial rows, scratch), "
                    f"K15 {lib.hs_mlp_block_bwd_f32_workspace(T, C, H)} (g, GELU'(h) / dh, "
                    f"u / du, partial rows, scratch)")
                kw = dict(approximate=False)
                pk = dict(kw, impl="pallas")
                key = (T, C, H, False)
                route_f, route_b = mlp_route(args, None, False, block=False)
                label = f"T={T} C={C} tanh=False"
                for name, call, plain, route in (
                        ("mlp_fwd_f32", lambda: tm.mlp_fwd(*a5, **pk),
                         lambda: tm.mlp_plain(*a5, **kw), route_f),
                        ("mlp_bwd_f32", lambda: tm.mlp_bwd(*a5, dz, **pk),
                         lambda: tm.mlp_bwd_plain(*a5, dz, **kw), route_b)):
                    e = errs[(name, False)]
                    timed[(name,) + key] = dict(
                        rel_l2=e[0], max_abs_err=e[1],
                        **f32_train_timing(f"f32 {name} {label}", call, plain,
                                           ("route_ms", route)))
                log_f32_sequence(f"f32 K13 sequence {label}", lambda: tm.mlp_bwd(*a5, dz, **pk))
                del route_f, route_b
                for d in (None, ds):
                    route_f, route_b = mlp_route(args, d, False, block=True)
                    dl = f"{label} dscale={d is not None}"
                    for name, call, plain, route in (
                            ("mlp_block_fwd_f32", lambda: tm.mlp_block_fwd(*args, d, **pk),
                             lambda: tm.mlp_block_plain(*args, d, **kw), route_f),
                            ("mlp_block_bwd_f32", lambda: tm.mlp_block_bwd(*args, d, dz, **pk),
                             lambda: tm.mlp_block_bwd_plain(*args, d, dz, **kw), route_b)):
                        e = errs[(name, False, d is not None)]
                        timed[(name,) + key + (d is not None,)] = dict(
                            rel_l2=e[0], max_abs_err=e[1],
                            **f32_train_timing(f"f32 {name} {dl}", call, plain,
                                               ("route_ms", route)))
                    log_f32_sequence(f"f32 K15 sequence {dl}",
                                     lambda: tm.mlp_block_bwd(*args, d, dz, **pk))
                    del route_f, route_b
            del args, dz, ds, x, a5
            torch.cuda.empty_cache()
    return timed


def refuse_f16_fused_mlp(dev):
    """A float16 operand: each of the MLP wrappers (K12-K15) and ``Mlp(mlp_impl="fused")``
    raise on the card before any launch, naming what the kernels take, "bfloat16 or
    float32" (the module's autograd function checks the operands of its backward, K13,
    as it is called)."""
    from heal_swin_torch.models.layers import Mlp
    from heal_swin_torch.ops import mlp as tm

    gen = torch.Generator().manual_seed(SEED + 23)
    f16 = torch.float16
    mlp = Mlp(64, 256, 64, mlp_impl="fused").to(dev, f16)
    x = torch.randn(2, 128, 64, generator=gen).to(dev, f16).requires_grad_()
    x2 = x.detach().reshape(256, 64)
    w1, w2 = mlp.fc1.weight.t(), mlp.fc2.weight.t()
    b1, b2 = mlp.fc1.bias.float(), mlp.fc2.bias.float()
    g, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    kw = dict(approximate=True)
    calls = {"Mlp(mlp_impl='fused')": lambda: mlp(x).sum().backward(),
             "mlp_fwd": lambda: tm.mlp_fwd(x2, w1, b1, w2, b2, **kw),
             "mlp_bwd": lambda: tm.mlp_bwd(x2, w1, b1, w2, b2, x2, **kw),
             "mlp_block_fwd": lambda: tm.mlp_block_fwd(x2, w1, b1, w2, b2, g, b, None, **kw),
             "mlp_block_bwd": lambda: tm.mlp_block_bwd(x2, w1, b1, w2, b2, g, b, None, x2,
                                                       **kw)}
    reset_counters()
    msgs = []
    for what, call in calls.items():
        try:
            call()
        except ValueError as e:
            if "bfloat16 or float32" not in str(e):
                raise
            msgs.append(str(e).splitlines()[0])
        else:
            raise AssertionError(f"refusal f16 fused MLP {what}: no refusal")
    torch.cuda.synchronize()
    launches, _ = read_counters()
    if any(launches.values()):
        raise AssertionError(f"refusal f16 fused MLP: kernels launched: {launches}")
    log(f"refusal f16 fused MLP: {', '.join(calls)} each raised with no launch ({msgs[0]})")


def drive_f32_mlp(dev, timed):
    """The MLP family in float32, the paper configs' precision.  First the f32 K12-K15
    against their plain versions (``check_f32_mlp_kernels``).  Then the paper
    segmentation config with dropout and attention dropout 0 (F32_TRAIN_VARIANTS "c")
    at full width and depth runs one training forward, keeping each block's MLP-branch
    input and DropPath draw, and the family runs on its f32 blocks
    (``check_mlp_blocks``, relative L2 F32_TAIL_TOL: f32 K12 4, K13 4, K14 20, K15 20).
    Then variant (c)'s train step (``paper_step``): mlp_impl="fused" on every block's
    Mlp of the kernel path, "auto" against "xla" on the same weights, batch and step
    generators; launches F32_TRAIN_LAUNCHES["c"], (b)'s and the f32 K13 on all 22
    blocks.  Returns the block run's and the step's launches, per kernel and per
    shape."""
    from heal_swin_torch.models.swin_hp import SwinHPBlock

    timed.update(check_f32_mlp_kernels(torch.Generator().manual_seed(SEED + 50), dev))
    torch.cuda.empty_cache()
    over = F32_TRAIN_VARIANTS["c"]
    t0 = time.perf_counter()
    task_k = paper_task("auto", dev, overrides=over)
    rec = record_mlp_inputs(task_k.model, dev)
    log(f"f32 mlp: built the paper f32 model and recorded its 22 blocks' MLP inputs in "
        f"{time.perf_counter() - t0:.1f} s")
    blocks_run = check_mlp_blocks("f32 mlp", rec, dev, timed, F32_TAIL_TOL, "_f32")
    del rec
    torch.cuda.empty_cache()
    fused = [m for m in task_k.model.modules() if isinstance(m, SwinHPBlock)]
    for blk in fused:
        blk.mlp.mlp_impl = "fused"
    task_p = paper_task("xla", dev, state=task_k.model.state_dict(), overrides=over)
    imgs, _ = train_batch(dev)
    targets = torch.clamp(((imgs[..., 0] + 2.5) * PAPER_CLASSES / 5).long(), 0,
                          PAPER_CLASSES - 1).to(torch.int32)
    log(f"f32 mlp: variant (c), mlp_impl='fused' on the {len(fused)} blocks of the kernel path")
    step_run = paper_step("f32 fused-MLP train (c)", task_k, task_p, imgs, targets,
                          dict(NO_LAUNCHES, **F32_TRAIN_LAUNCHES["c"]), timed,
                          ("total", targets.numel()), attn_dropout=False)
    del task_k, task_p
    return blocks_run, step_run


# --------------------------------------------------- the trainer's fit loop on the card
FIT_TRAIN = 8  # synthetic train samples: 4 steps an epoch at batch BATCH
FIT_VAL = 4  # synthetic validation samples: 2 batches of BATCH
FIT_FLOOR = 1e-6  # the least limit of resume against uninterrupted, relative L2
# the metrics of tests/test_train_e2e.py:57-62 that fit logs (its evaluate_* metric is
# the run entry's), the step loss and the memory statistics
FIT_METRICS = (
    "train_loss", "train_acc", "train_acc_ignored", "train_iou_global",
    "train_iou_global_ignored", "val_loss", "val_acc", "val_iou_global",
    "val_iou_global_ignored", "val_iou_global_class_0_background",
    "train_time_per_sample in ms", "lr-Adam", "train_loss_step", "epoch",
    "device0 memory.used in MB", "device0 memory.peak in MB", "device0 memory.limit in MB")


def fit_datamodule(depth, flat=False):
    """The port's synthetic HEALPix datamodule at nside NSIDE on 8 base pixels, or with
    ``flat`` its synthetic flat datamodule at 640 x 768: FIT_TRAIN train and FIT_VAL
    validation samples, batch BATCH for both; segmentation has the fixture's 4 classes,
    depth the depth paper configs' data settings (standardized, background masked)."""
    import dataclasses

    from heal_swin_torch.data.data import get_data_module
    from heal_swin_torch.data.data_config import (WoodscapeCommonConfig, WoodscapeFlatConfig,
                                                  WoodscapeHPConfig)
    from heal_swin_torch.run_configs import depth_swin_train_run, paper_depth_config

    common = WoodscapeCommonConfig(version="synthetic", batch_size=BATCH,
                                   val_batch_size=BATCH, pred_batch_size=BATCH,
                                   synthetic_train_samples=FIT_TRAIN,
                                   synthetic_val_samples=FIT_VAL)
    if flat and depth:
        data = dataclasses.replace(depth_swin_train_run().data, common=common,
                                   input_height=FLAT_IN[0], input_width=FLAT_IN[1])
    elif flat:
        data = WoodscapeFlatConfig(common=common, input_height=FLAT_IN[0],
                                   input_width=FLAT_IN[1])
    elif depth:
        data = dataclasses.replace(paper_depth_config().data, common=common,
                                   input_nside=NSIDE)
    else:
        data = WoodscapeHPConfig(common=common, input_nside=NSIDE, input_base_pix=8)
    return get_data_module(data)


def fit_run(label, root, dm, spec, dev, depth=False, flat=False, **pl):
    """One ``Trainer.fit`` of a paper config (f32, dropout, attention dropout and DropPath
    0.1; segmentation unweighted over the fixture's 4 classes at the paper rate, depth
    as ``paper_depth_config``) on ``dm`` into its own FileStore run and checkpoint dir
    under ``root``, seed SEED, sanity validation of 1 batch, every step's loss logged;
    ``pl``: PLConfig fields on top.  The launch counters are set to 0 just before the
    fit and read just after.  Returns a dict of the trainer, fit result, task, run,
    checkpoint dir, launches (per kernel, per shape) and seconds.  ``flat``: the paper
    flat configs (``run_configs.flat_seg_train_run`` without its class weights,
    ``depth_swin_train_run``)."""
    from heal_swin_torch.models import tasks as T
    from heal_swin_torch.run_configs import (PAPER_LR, depth_swin_train_run,
                                             flat_seg_train_run, paper_depth_config,
                                             paper_swin_hp_config)
    from heal_swin_torch.tracking.mlflow_store import MlflowFileStore
    from heal_swin_torch.training.optimizer import OptimizerConfig
    from heal_swin_torch.training.train_config import PLConfig, TrainConfig
    from heal_swin_torch.training.trainer import Trainer

    if flat and depth:
        rc = depth_swin_train_run()
        task = T.WoodscapeDepthSwin(rc.model, spec, rc.data, device=dev)
    elif flat:
        import dataclasses

        task = T.WoodscapeSegmenterSwin(
            dataclasses.replace(flat_seg_train_run().model, class_weights=None), spec,
            device=dev)
    elif depth:
        cfg = paper_depth_config()
        task = T.WoodscapeDepthSwinHP(cfg.model, spec, cfg.data, device=dev)
    else:
        task = T.WoodscapeSegmenterSwinHP(
            T.WoodscapeSegmenterSwinHPConfig(
                paper_swin_hp_config(), optimizer_config=OptimizerConfig(learning_rate=PAPER_LR)),
            spec, device=dev)
    if depth:
        tc = TrainConfig(seed=SEED, ckpt_metric="val_loss", ckpt_mode="min",
                         mlflow_expmt="chip_smoke_fit")
    else:
        tc = TrainConfig(seed=SEED, ckpt_metric="val_iou_global_ignored", ckpt_mode="max",
                         mlflow_expmt="chip_smoke_fit")
    run = MlflowFileStore(root / "mlruns").create_run(label)
    ckpt_dir = root / label
    trainer = Trainer(PLConfig(**dict(dict(num_sanity_val_steps=1, log_every_n_steps=1), **pl)),
                      tc, run=run, ckpt_dir=ckpt_dir, device=dev)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    result = trainer.fit(task, dm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    run.set_status("FINISHED")
    return dict(trainer=trainer, result=result, task=task, run=run, ckpt_dir=ckpt_dir,
                launches=launches, seconds=seconds)


def fit_state(ckpt_path):
    """(name -> tensor) of a checkpoint's parameters and Adam moments, on the host."""
    from heal_swin_torch.training.checkpoint import load_checkpoint

    model, opt, _ = load_checkpoint(ckpt_path)
    out = {f"param {k}": v for k, v in model.items()}
    for i, st in opt["state"].items():
        out[f"adam {i} exp_avg"] = st["exp_avg"]
        out[f"adam {i} exp_avg_sq"] = st["exp_avg_sq"]
        out[f"adam {i} step"] = st["step"].reshape(1)
    return out


def fit_losses(run, first_step):
    """The logged step losses from global step ``first_step`` on, as a tensor."""
    return torch.tensor([v for _, v, s in run.get_metric_history("train_loss_step")
                         if s >= first_step], dtype=torch.float64)


def fit_compare(a, b):
    """Per tensor of ``a`` (name -> tensor): (relative L2 to ``b``'s, bit-equal)."""
    if set(a) != set(b):
        raise AssertionError(f"fit states differ in their tensors: {sorted(set(a) ^ set(b))[:4]}")
    return {k: (rel_l2(a[k].double(), b[k].double()), torch.equal(a[k], b[k])) for k in a}


def check_fit_launches(label, fit, steps, val_batches, timed, depth=False, fused=True):
    """A fit's launches: per train step the f32 tail's forward and backward (K6/K7, or
    K8/K9) and no attention kernel (attention dropout sends every block to the plain
    route); per validation batch the f32 K1 20 times and K2 twice, and for depth the f32
    K8 once (segmentation validation passes a sample mask, so its tail is unfused and
    runs no K6).  ``fused`` False: the flat depth task, whose tail is unfused (no K8 /
    K9)."""
    tail = "final_head_depth_loss" if depth else "final_head_loss"
    expected = dict(NO_LAUNCHES, **{k: v * val_batches for k, v in PAPER_EVAL_LAUNCHES.items()})
    if fused:
        expected[f"{tail}_f32"] = steps + (val_batches if depth else 0)
        expected[f"{tail}_bwd_f32"] = steps
    check_launches(label, *fit["launches"], expected, timed)


def check_fit_files(label, fit, names, metric):
    """The fit's FileStore run holds every metric of ``names``, each value finite, and
    its checkpoint dir last.ckpt, best.ckpt and an epoch file of ``metric``."""
    run = fit["run"]
    for name in names:
        hist = run.get_metric_history(name)
        if not hist or not all(math.isfinite(v) for _, v, _ in hist):
            raise AssertionError(f"{label}: metric {name!r} missing or not finite: {hist}")
    files = sorted(p.name for p in fit["ckpt_dir"].iterdir())
    epochs = [f for f in files if f.startswith("epoch=") and f"_{metric}=" in f]
    if "last.ckpt" not in files or "best.ckpt" not in files or not epochs:
        raise AssertionError(f"{label}: checkpoint files {files}")
    return files


def drive_fit(dev, timed, flat=False):
    """The trainer's fit loop on the card: ``Trainer.fit`` of the paper segmentation config
    (f32, full width and depth, dropout, attention dropout and DropPath 0.1, nside NSIDE,
    batch BATCH) on the port's synthetic HEALPix datamodule (FIT_TRAIN train samples, 4
    steps an epoch; FIT_VAL validation samples, 2 batches), with sanity validation (1
    batch), validation each epoch, checkpoints on ``val_iou_global_ignored`` and the
    memory statistics logged, into a FileStore and checkpoint dirs under a temporary
    directory that the phase deletes.  Run A: 2 epochs; run A': the same again (their
    difference is the card's run-to-run floor); run B: 1 epoch, then a new Trainer
    resumes from its last.ckpt for epoch 2.  Checks: B's final parameters, Adam state
    and epoch-2 step losses within max(2 x A/A' largest relative L2, FIT_FLOOR) of A's,
    bit-equal wherever A and A' are; A's launches (``check_fit_launches``); A's
    metrics and checkpoint files (``check_fit_files``).  Then the depth paper config
    fits 1 epoch: its launches and its metrics under the JAX trainer's names.  Logs the
    fit's steady train img/s beside ``paper_step``'s, the seconds the step loop waited
    on a checkpoint flush, and a checkpoint's bytes.  With ``flat`` the same for the
    paper flat configs on the synthetic flat datamodule at 640 x 768 (``fit_run``'s
    ``flat``)."""
    import shutil
    import tempfile
    from pathlib import Path

    fit = "flat fit" if flat else "fit"
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    try:
        dm, spec = fit_datamodule(False, flat)
        log(f"{fit}: synthetic datamodule, {len(dm.train_ds)} train / {len(dm.val_ds)} "
            f"validation samples of {spec.dim_in} pixels, {spec.f_out} classes "
            f"(unweighted CE), batch {BATCH}")
        fits = {}
        for label, pl in (("A", dict(max_epochs=2)), ("A'", dict(max_epochs=2)),
                          ("B", dict(max_epochs=1))):
            fits[label] = fit_run(label, root, dm, spec, dev, flat=flat, **pl)
        last = fits["B"]["ckpt_dir"] / "last.ckpt"
        fits["B2"] = fit_run("B2", root, dm, spec, dev, flat=flat, max_epochs=2,
                             resume_from_checkpoint=str(last))
        a = fits["A"]
        steps, per_epoch = a["result"].global_step, a["result"].global_step // 2
        if (steps, fits["B"]["result"].global_step, fits["B2"]["result"].global_step) != (
                2 * per_epoch, per_epoch, steps) or per_epoch != FIT_TRAIN // BATCH:
            raise AssertionError(f"{fit}: steps {[f['result'] for f in fits.values()]}")
        check_fit_launches(f"{fit} A", a, steps, 1 + 2 * (FIT_VAL // BATCH), timed)
        check_fit_launches(f"{fit} B2 (resumed)", fits["B2"], per_epoch,
                           1 + FIT_VAL // BATCH, timed)
        files = check_fit_files(f"{fit} A", a, FIT_METRICS, "val_iou_global_ignored")

        states = {k: fit_state(f["ckpt_dir"] / "last.ckpt") for k, f in fits.items()
                  if k != "B"}
        for k in states:
            states[k]["epoch-2 step losses"] = fit_losses(fits[k]["run"], per_epoch + 1)
        floor = fit_compare(states["A"], states["A'"])
        worst_aa = max(e for e, _ in floor.values())
        tol = max(2 * worst_aa, FIT_FLOOR)
        resumed = fit_compare(states["B2"], states["A"])
        for k, (err, same) in resumed.items():
            if (floor[k][1] and not same) or err > tol:
                raise AssertionError(f"{fit}: resumed {k} rel_l2 {err:.3e} (bit-equal {same}) "
                                     f"against A; A vs A' {floor[k][0]:.3e} (bit-equal "
                                     f"{floor[k][1]}), limit {tol:.3e}")
        worst_b = max(resumed.items(), key=lambda kv: kv[1][0])
        log(f"{fit}: A vs A' over {len(floor)} tensors (parameters, Adam moments and steps, "
            f"epoch-2 step losses): largest rel_l2 {worst_aa:.3e} "
            f"({max(floor.items(), key=lambda kv: kv[1][0])[0]}), "
            f"{sum(s for _, s in floor.values())} bit-equal; resumed B vs A: largest rel_l2 "
            f"{worst_b[1][0]:.3e} ({worst_b[0]}), {sum(s for _, s in resumed.values())} "
            f"bit-equal, limit {tol:.3e}, bit-equal wherever A and A' are")
        log(f"{fit}: step losses A " + " ".join(f"{v:.6f}" for v in fit_losses(a["run"], 1).tolist())
            + "; resumed B epoch 2 " + " ".join(
                f"{v:.6f}" for v in states["B2"]["epoch-2 step losses"].tolist()))
        ckpt_bytes = (a["ckpt_dir"] / "last.ckpt").stat().st_size
        paper = timed.get(("flat " if flat else "") + "paper train img/s", (float("nan"),) * 2)
        for k, f in fits.items():
            tr = f["trainer"]
            rate_fit = tr.last_train_steady_samples / tr.last_train_steady_time
            stamps = [t for t, _, _ in f["run"].get_metric_history("train_loss_step")]
            log(f"{fit} {k}: {f['result'].epochs_run} epochs, {f['result'].global_step} steps "
                f"in {f['seconds']:.3f} s; last epoch's steady train {rate_fit:.4f} img/s "
                f"(after its first step; paper_step's bare train_step {paper[0]:.4f} / "
                f"{paper[1]:.4f}); the train loop waited {tr.ckpt_manager.save_wait_seconds:.4f}"
                f" s on a checkpoint save in flight, the fit's end "
                f"{tr.ckpt_manager.flush_seconds - tr.ckpt_manager.save_wait_seconds:.4f} s; "
                f"the saves took {tr.ckpt_manager.save_seconds:.4f} s in the background; "
                "train_time_per_sample "
                + " ".join(f"{v:.3f}" for _, v, _ in
                           f["run"].get_metric_history("train_time_per_sample in ms"))
                + " ms; val_iou_global_ignored " + " ".join(
                    f"{v:.4f}" for _, v, _ in f["run"].get_metric_history("val_iou_global_ignored"))
                + "; ms between the logged step losses " + " ".join(
                    str(b - a) for a, b in zip(stamps[:-1], stamps[1:])))
            timed[f"{fit} {k}"] = dict(steady_img_s=rate_fit, seconds=f["seconds"],
                                     loop_wait_s=tr.ckpt_manager.save_wait_seconds)
        log(f"{fit}: a checkpoint is {ckpt_bytes} bytes ({ckpt_bytes / 2 ** 30:.4f} GiB: "
            f"parameters and two Adam moments in f32); A's checkpoint dir {files}")
        del fits, states, a
        torch.cuda.empty_cache()

        dm, spec = fit_datamodule(True, flat)
        d = fit_run("depth", root, dm, spec, dev, depth=True, flat=flat, max_epochs=1)
        check_fit_launches(f"{fit} depth", d, FIT_TRAIN // BATCH, 1 + FIT_VAL // BATCH, timed,
                           depth=True, fused=not flat)
        names = (["train_loss", "train_loss_step", "val_loss", "epoch", "lr-Adam"]
                 + list(d["task"].metric_compute(d["task"].metric_init(), "train_"))
                 + list(d["task"].metric_compute(d["task"].metric_init(), "val_")))
        check_fit_files(f"{fit} depth", d, names, "val_loss")
        tr = d["trainer"]
        log(f"{fit} depth: 1 epoch, {d['result'].global_step} steps in {d['seconds']:.3f} s, "
            f"steady train {tr.last_train_steady_samples / tr.last_train_steady_time:.4f} "
            f"img/s (paper_step's "
            f"{timed.get(('flat ' if flat else '') + 'paper depth train img/s', (float('nan'),))[0]:.4f}); "
            + " ".join(f"{k} {v:.6f}" for k, v in d["result"].last_metrics.items()
                       if k.startswith("val_")))
        del d
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------- the real input path and the run entry on the card
RUN_N_PER_CAM = 4  # fixture images per camera: 16 an image set, 13 train (6 steps) / 4 val
RUN_EPOCHS = 5  # segmentation epochs: one validation (check_val_every_n_epoch 5)
RUN_DEPTH_EPOCHS = 4  # depth epochs: one validation (check_val_every_n_epoch 4)
RUN_DEPTH_PREDICT_BATCHES = 1  # the depth evaluation's (its wrapper config): ~7 s a sample
RUN_TIMEOUT = 420  # seconds for one entry subprocess
LR_FIND_STEPS = 20
FIXTURE_H, FIXTURE_W = 966, 1280  # the fixtures' image size, WoodScape's
ENTRY_ARGS = []  # extra arguments of every entry run (a rehearsal passes --device cpu)
PROJ_REL_TOL = 1e-6  # the wide gather against the narrow one, f32, before the floor
DECODE_IMAGES = 4  # fixture images decoded for the host decode time
CONFIGS = "heal_swin_torch/configs"
# the bf16 paper model's launches a train step / a validation batch (its loss passes a
# sample mask, so the tail is unfused: no K6)
SEG_STEP_LAUNCHES = dict(ATTN_LAUNCHES[True], **ATTN_BWD_LAUNCHES[True], final_head_loss=1,
                         final_head_loss_bwd=1)
# the depth paper config's: attention dropout sends training to the plain route
DEPTH_STEP_LAUNCHES = dict(final_head_depth_loss_f32=1, final_head_depth_loss_bwd_f32=1)
DEPTH_VAL_LAUNCHES = dict(PAPER_EVAL_LAUNCHES, final_head_depth_loss_f32=1)
def entry_child(counts_path, argv):
    """``python3 chip_smoke.py --entry-child COUNTS -- <cli arguments>``: runs
    ``python3 -m heal_swin_torch.cli <cli arguments>`` in this process, then writes the
    kernels' launch counters (per kernel, per shape) and the fit's steady train samples
    and seconds (``Trainer.last_train_steady_*``: its last epoch after the epoch's first
    step) to COUNTS and exits with the entry's code."""
    import runpy

    from heal_swin_torch.training.trainer import Trainer

    steady = {}
    fit = Trainer.fit

    def fit_and_keep(self, *args, **kwargs):
        try:
            return fit(self, *args, **kwargs)
        finally:
            steady.update(samples=getattr(self, "last_train_steady_samples", 0),
                          seconds=getattr(self, "last_train_steady_time", 0.0))

    Trainer.fit = fit_and_keep
    sys.argv = ["heal_swin_torch.cli"] + argv
    code = 0
    try:
        runpy.run_module("heal_swin_torch.cli", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    except BaseException:
        import traceback

        traceback.print_exc()
        code = 1
    launches, by_shape = read_counters()
    with open(counts_path, "w") as f:
        json.dump({"launches": launches, "by_shape": [[list(k), v] for k, v in by_shape.items()],
                   "steady": steady}, f)
    return code


def run_entry(label, root, argv, env, evaluates=False):
    """One run of the port's entry (``python3 -m heal_swin_torch.cli`` + ``argv``) in a
    subprocess with ``env`` on top of this one's: checks its exit code, its ``This run
    has id`` line (a train or resume; none for ``evaluate``) and, where it ``evaluates``,
    its ``Evaluation finished.`` line; returns (run id or None, seconds, launches,
    launches by shape, the fit's steady img/s or None)."""
    import re

    counts = root / f"{label.replace(' ', '_')}_counts.json"
    cmd = [sys.executable, __file__, "--entry-child", str(counts), "--"] + argv + ENTRY_ARGS
    log(f"{label}: python3 -m heal_swin_torch.cli {' '.join(argv)} (env {env})")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=dict(os.environ, **env), capture_output=True, text=True,
                          timeout=RUN_TIMEOUT)
    seconds = time.perf_counter() - t0
    (root / f"{label.replace(' ', '_')}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit code {proc.returncode}\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-6000:]}")
    ids = re.findall(r"This run has id (\w+)", proc.stdout)
    if len(ids) != (argv[0] != "evaluate"):
        raise AssertionError(f"{label}: run id lines {ids}\n{proc.stdout[-3000:]}")
    finished = proc.stdout.count("Evaluation finished.")
    if finished != evaluates:
        raise AssertionError(f"{label}: {finished} 'Evaluation finished.' lines\n"
                             f"{proc.stdout[-3000:]}")
    got = json.loads(counts.read_text())
    by_shape = collections.Counter({tuple(k): v for k, v in got["by_shape"]})
    steady = None
    if got["steady"]:
        steady = got["steady"]["samples"] / max(got["steady"]["seconds"], 1e-9)
    log(f"{label}: {'run ' + ids[0] + ', ' if ids else ''}exit code 0 in {seconds:.3f} s"
        + (f"; the fit's last epoch after its first step {steady:.4f} img/s"
           if steady is not None else ""))
    return (ids[0] if ids else None), seconds, got["launches"], by_shape, steady


def entry_run(store, run_id, label, metrics, ckpt_metric, epoch_files=(1, 3)):
    """A finished entry run in ``store``: status FINISHED, every metric of ``metrics``
    logged and finite, and its checkpoints last.ckpt and between ``epoch_files`` top-k
    files of ``ckpt_metric``, and best.ckpt where there is one.  Returns the run."""
    run = store.get_run(run_id)
    if run.status != "FINISHED":
        raise AssertionError(f"{label}: run {run_id} status {run.status}")
    for name in metrics:
        hist = run.get_metric_history(name)
        if not hist or not all(math.isfinite(v) for _, v, _ in hist):
            raise AssertionError(f"{label}: metric {name!r} missing or not finite: {hist}")
    files = sorted(p.name for p in (run.artifact_dir / "checkpoints").iterdir())
    epochs = [f for f in files if f.startswith("epoch=") and f"_{ckpt_metric}=" in f]
    if ("last.ckpt" not in files or ("best.ckpt" in files) != bool(epochs)
            or not epoch_files[0] <= len(epochs) <= epoch_files[1]):
        raise AssertionError(f"{label}: checkpoint files {files}")
    log(f"{label}: status FINISHED, checkpoints {files}")
    return run


def expect_launches(per_step, steps, per_val=None, val_batches=0):
    expected = dict(NO_LAUNCHES)
    for k, v in per_step.items():
        expected[k] += v * steps
    for k, v in (per_val or {}).items():
        expected[k] += v * val_batches
    return expected


def first_val_batch(dm, dev):
    """The datamodule's first validation batch, host and device copies."""
    imgs, targets = next(iter(dm.val_dataloader()))
    return (imgs, targets), (torch.as_tensor(imgs).to(dev),
                             tuple(torch.as_tensor(t).to(dev) for t in targets))


def host_decode_ms(root):
    """Host decode ms per image: the fixture's RGB images and masks through
    ``utils.image``, and one image re-encoded with every row Paeth-filtered (the
    wavefront path; the fixture's writer uses filter None)."""
    from heal_swin_torch.utils import image as I
    from heal_swin_torch.utils import png

    imgs = sorted((root / "woodscape" / "rgb_images" / "rgb_images").glob("*.png"))
    masks = root / "woodscape" / "semantic_annotations" / "semantic_annotations" / "gtLabels"
    t = time.perf_counter()
    for p in imgs[:DECODE_IMAGES]:
        rgb = I.read_image(p)
    img_ms = (time.perf_counter() - t) * 1e3 / DECODE_IMAGES
    t = time.perf_counter()
    for p in imgs[:DECODE_IMAGES]:
        I.read_mask(masks / p.name)
    mask_ms = (time.perf_counter() - t) * 1e3 / DECODE_IMAGES
    paeth = png.encode(rgb.transpose(1, 2, 0), filter_type=4)
    t = time.perf_counter()
    back = png.decode(paeth).samples
    paeth_ms = (time.perf_counter() - t) * 1e3
    if not np.array_equal(back, rgb.transpose(1, 2, 0)):
        raise AssertionError("decode of the Paeth-filtered image differs")
    log(f"run entry: host decode of a {rgb.shape[1]}x{rgb.shape[2]} image: RGB {img_ms:.3f} ms, "
        f"mask {mask_ms:.3f} ms (filter None, the fixture's), RGB with every row Paeth "
        f"{paeth_ms:.3f} ms (the wavefront)")
    return dict(decode_rgb_ms=img_ms, decode_mask_ms=mask_ms, decode_paeth_ms=paeth_ms)


def check_projection(dm, dev, depth):
    """One validation batch projected on the card by the datamodule's
    ``device_batch_transform``, against the host npz pipeline for the same samples
    (segmentation: images at most 1 off and more than 99% equal, masks equal; depth: the
    depth maps equal, inf where the host's are), and the wide gather against the narrow
    plain version within PROJ_REL_TOL before the floor.  Returns the device ms of the
    projection per batch, wide and narrow, and the device batch after the transform."""
    from heal_swin_torch.data.depth_estimation.hp_depth_datamodule import (
        WoodscapeHPDepthImagesDataset)
    from heal_swin_torch.data.segmentation.hp_datamodule import WoodscapeHPSemanticImagesDataset

    c = dm.common
    kind = "depth" if depth else "segmentation"
    (imgs_h, _), (imgs, targets) = first_val_batch(dm, dev)
    with torch.no_grad():
        hp_imgs, hp_targets = dm.device_batch_transform(imgs, targets)
        proj, cal_ids = dm._projector, targets[1]
        wide = proj.project_images(imgs.float(), cal_ids)
        narrow = proj.project_images_narrow(imgs.float(), cal_ids)
    err = rel_l2(wide, narrow)
    if not err <= PROJ_REL_TOL:
        raise AssertionError(f"{kind} projection: wide vs narrow rel_l2 {err:.3e}")
    kw = dict(nside=dm.nside, base_pix=dm.base_pix, cam_pos=c.cam_pos, train_share=c.train_share,
              rotate_pole=c.rotate_pole, part="val", woodscape_version=dm.woodscape_version)
    if depth:
        host_ds = WoodscapeHPDepthImagesDataset(
            mask_background=dm.mask_background, data_transform=dm.data_transform,
            normalize_data=dm.normalize_data, **kw)
    else:
        host_ds = WoodscapeHPSemanticImagesDataset(crop_green=c.crop_green,
                                                   s2_bkgd_class=c.s2_bkgd_class, **kw)
    names = [dm.val_dataset.names[i] for i in range(imgs.shape[0])]
    got_i, got_t = hp_imgs.cpu(), hp_targets.cpu()
    for i, name in enumerate(names):
        hi, ht = host_ds.get_item_by_name(name) if depth else host_ds.load_raw(
            host_ds.names.index(name))
        hi = torch.as_tensor(hi if depth else hi.T).float()
        ht = torch.as_tensor(ht)
        if depth:
            img_err = rel_l2(got_i[i], hi)
            if not (torch.equal(torch.isinf(got_t[i]), torch.isinf(ht))
                    and torch.equal(got_t[i][torch.isfinite(ht)], ht[torch.isfinite(ht)])):
                raise AssertionError(f"depth projection {name}: depth maps differ from the npz")
            log(f"depth projection {name}: depth map equal to the npz pipeline's "
                f"({int(torch.isinf(ht).sum())} inf of {ht.numel()}), image rel_l2 "
                f"{img_err:.3e} (the npz keeps f32 images)")
        else:
            diff = (got_i[i] - hi).abs()
            share = float((diff == 0).float().mean())
            if float(diff.max()) > 1 or share <= 0.99 or not torch.equal(got_t[i].long(),
                                                                          ht.long()):
                raise AssertionError(f"segmentation projection {name}: max diff "
                                     f"{float(diff.max())}, {share:.6f} equal, masks equal "
                                     f"{torch.equal(got_t[i].long(), ht.long())}")
            log(f"segmentation projection {name}: images max diff {float(diff.max()):.0f}, "
                f"{share * 100:.4f}% equal to the npz pipeline's; masks equal")
    wide_ms = median_ms(lambda: proj.project_images(imgs.float(), cal_ids))
    narrow_ms = median_ms(lambda: proj.project_images_narrow(imgs.float(), cal_ids))
    transform_ms = median_ms(lambda: dm.device_batch_transform(imgs, targets))
    B, H, W, C = imgs.shape
    patch_bytes = B * ((H + 1) * (W + 1) - W - 2) * 4 * C * 4
    log(f"{kind} projection of a batch of {B} {H}x{W} images to {wide.shape[1]} pixels: wide "
        f"{wide_ms:.4f} ms, narrow (plain) {narrow_ms:.4f} ms, the whole device transform "
        f"{transform_ms:.4f} ms (one call, CUDA events, median of {TIMING_RUNS}); wide vs "
        f"narrow rel_l2 {err:.3e}; the wide form's patch tensor {patch_bytes / 1e6:.1f} MB")
    return dict(wide_ms=wide_ms, narrow_ms=narrow_ms, transform_ms=transform_ms,
                wide_vs_narrow=err), imgs_h, (hp_imgs, hp_targets)


def bare_step_rate(task, batch, n=5):
    """The bare ``train_step`` rate of ``task`` on a projected batch already on the card
    (after 2 warm-up steps): images/s."""
    from heal_swin_torch.training.optimizer import make_optimizer

    opt = make_optimizer(task.model.parameters(), task.optimizer_config)
    imgs, targets = batch
    _, _, _, mstate = train_rate(task, opt, task.metric_init(), imgs, targets, 0, 2)
    rate_, mem, losses, _ = train_rate(task, opt, mstate, imgs, targets, 2, n)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"bare train_step losses {losses}")
    return rate_, mem


def config_paths():
    """The port's two smoke configs in this checkout: (segmentation, depth)."""
    from pathlib import Path

    return tuple(str(Path(__file__).resolve().parent / CONFIGS / f) for f in (
        "smoke_convergence_run_config.py", "smoke_depth_run_config.py"))


@contextlib.contextmanager
def entry_world():
    """A temporary HEAL_SWIN_DATA_ROOT (the tracking store beneath it) with the smoke
    configs' fixture size and epochs in the environment, for the run-entry and evaluation
    phases; the environment restored and the directory deleted after."""
    import shutil
    import tempfile
    from pathlib import Path

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_entry_"))
    env = dict(HEAL_SWIN_DATA_ROOT=str(root), HEAL_SWIN_MLRUNS=str(root / "mlruns"),
               SMOKE_N_PER_CAM=str(RUN_N_PER_CAM), SMOKE_EPOCHS=str(RUN_EPOCHS))
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield root
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


EVAL_WRAPPER = """import dataclasses

from heal_swin_torch.utils.utils import get_config_from_config_path

BASE = {base!r}


def get_eval_run_config():
    return dataclasses.replace(get_config_from_config_path(BASE, "get_eval_run_config"),
                               **{eval_changes!r})


def get_pl_config():
    return dataclasses.replace(get_config_from_config_path(BASE, "get_pl_config"),
                               **{pl_changes!r})
"""


def eval_wrapper(root, name, base, eval_changes=None, pl_changes=None):
    """A config file ``root / name`` whose ``get_eval_run_config`` and ``get_pl_config``
    are the config ``base``'s with ``eval_changes`` and ``pl_changes``: an evaluation of
    a shipped smoke config with other settings, the shipped file left as it is."""
    path = root / name
    path.write_text(EVAL_WRAPPER.format(base=base, eval_changes=eval_changes or {},
                                        pl_changes=pl_changes or {}))
    return str(path)


def add_launches(expected, *more):
    out = dict(expected)
    for extra in more:
        for k, v in extra.items():
            out[k] += v
    return out


def eval_launches(val_batches, pred_batches, masked_batches=0, depth=False):
    """The launches of an evaluation of the bf16 segmentation model (or, with ``depth``,
    of the f32 depth paper model): validation K1 20 and K2 2 a batch (its loss passes a
    sample mask, so the tail is unfused: no K6; depth: f32 K1 20, K2 2, K8 1); predict K1
    20, K2 2 and K3 1 a batch (depth: f32 K1 20, K2 2; its tail is plain); the masked IoU
    as predict, over every validation batch.  The Chamfer writer's K10 / K11 are counted
    apart (their number follows the clouds)."""
    if depth:
        return add_launches(NO_LAUNCHES, *[DEPTH_VAL_LAUNCHES] * val_batches,
                            *[PAPER_EVAL_LAUNCHES] * pred_batches)
    pred = dict(ATTN_LAUNCHES[True], final_head_predict=1)
    return add_launches(NO_LAUNCHES, *[ATTN_LAUNCHES[True]] * val_batches,
                        *[pred] * (pred_batches + masked_batches))


EVAL_PREFIX = "evaluate_best_"
EVAL_OUTPUT_RES = 0.5  # EvaluateConfig.output_resolution: the base writer's overlays
EVAL_CLOCKS = tuple(EVAL_PREFIX + k for k in (
    "val_samples_per_sec", "predict_samples_per_sec", "predict_device_blocked_sec",
    "predict_writer_host_sec"))
EVAL_VAL_RATES = tuple(EVAL_PREFIX + "val_" + k for k in (
    "acc", "acc_ignored", "iou_global", "iou_global_ignored"))
HEADLINE_PLAIN_PIXELS = 1e-4  # share of back-projected pixels kernel and plain may differ on
HEADLINE_PLAIN_TOL = 1e-3  # each headline writer metric, kernel route against plain
CHAMFER_CHILD_REL_TOL = 1e-6  # each Chamfer metric, this process's rerun against the child's


def eval_metrics(label, run, rates, others=()):
    """The last logged value of each metric of ``rates`` (finite, in [0, 1]) and of
    ``others`` (finite) in ``run``."""
    values = {}
    for name in tuple(rates) + tuple(others):
        hist = run.get_metric_history(name)
        if not hist:
            raise AssertionError(f"{label}: metric {name!r} not logged")
        v = hist[-1][1]
        if not math.isfinite(v) or (name in rates and not 0 <= v <= 1):
            raise AssertionError(f"{label}: metric {name!r} = {v}")
        values[name] = v
    return values


def eval_numbers(values, n_pred):
    """The evaluation's rates and seconds from its logged clocks."""
    c = [values.get(k, float("nan")) for k in EVAL_CLOCKS]
    return dict(val_samples_s=c[0], predict_write_samples_s=c[1], predict_device_blocked_s=c[2],
                writer_host_s=c[3], writer_host_s_per_sample=c[3] / n_pred)


def check_eval_after_train(label, run, n_pred):
    """The in-process evaluation after a fit (``eval_after_train``, a default
    ``EvaluateConfig``): the ``evaluate_best_`` validation metrics and clocks logged and
    finite, and the base writer's overlay grids, one a predicted sample, decoding
    through the port's PNG codec to RGB [ground truth | prediction] pairs at
    EVAL_OUTPUT_RES of the image.  Returns its numbers."""
    from heal_swin_torch.utils import png

    values = eval_metrics(label, run, EVAL_VAL_RATES, (EVAL_PREFIX + "val_loss",) + EVAL_CLOCKS)
    files = sorted(run.artifact_dir.glob(EVAL_PREFIX + "val_*_iou=*.png"))
    h, w = int(FIXTURE_H * EVAL_OUTPUT_RES), int(FIXTURE_W * EVAL_OUTPUT_RES)
    if len(files) != n_pred:
        raise AssertionError(f"{label}: {len(files)} overlays for {n_pred} predicted samples")
    for f in files:
        img = png.read(f)
        if img.color_type != 2 or img.samples.shape != (h, 2 * w, 3):
            raise AssertionError(f"{label}: overlay {f.name}: colour type {img.color_type}, "
                                 f"shape {img.samples.shape}")
    numbers = eval_numbers(values, n_pred)
    log(f"{label}: eval_after_train logged " + " ".join(
        f"{k} {v:.6f}" for k, v in values.items()) + f"; {len(files)} overlays of "
        f"{h}x{2 * w} decode, e.g. {files[0].name}")
    return numbers


def drive_run_entry(dev, timed, root):
    """The real input path and the run entry on the card.  Into ``root``, the
    HEAL_SWIN_DATA_ROOT of ``entry_world``: the port's generator writes both 966x1280
    fixtures (WoodScape, and SynWoodScape with depth maps), RUN_N_PER_CAM images a
    camera; the host decode is
    timed (``host_decode_ms``); one validation batch of each port config's datamodule is
    projected on the card and held to the host npz pipeline and the wide gather to the
    narrow one (``check_projection``).  Then ``python3 -m heal_swin_torch.cli train`` runs
    the port's convergence config (bf16 paper model, nside 256, base_pix 8,
    ``project_on_device``) for RUN_EPOCHS epochs as it stands, ``eval_after_train``
    included, in a subprocess: exit code, run id line, status FINISHED, checkpoints, a
    finite train_loss falling from the first epoch to the last, finite validation
    metrics, and every launch of the run (SEG_STEP_LAUNCHES a step, K1 20 and K2 2 a
    validation batch, and the evaluation's: ``eval_launches``, nothing else); its fit
    rate (the last epoch's ``train_time_per_sample``) beside the bare ``train_step`` on a
    projected batch on the card; the evaluation's ``evaluate_best_*`` metrics and the base
    writer's overlays (``check_eval_after_train``).  ``cli resume`` continues the run from
    its last.ckpt for one more epoch, and evaluates it.  The depth config trains
    RUN_DEPTH_EPOCHS epochs through the entry (f32 K8 / K9 a step; f32 K1 20, K2 2, K8 1 a
    validation batch).  Last ``Trainer.lr_find`` runs LR_FIND_STEPS steps of the
    convergence config.  Returns the run ids and the evaluation's batch counts, for
    ``drive_evaluate``."""
    from heal_swin_torch.data.data import get_data_module
    from heal_swin_torch.data.synthetic_woodscape import generate
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.tracking.mlflow_store import MlflowFileStore
    from heal_swin_torch.train import build_task
    from heal_swin_torch.training.checkpoint import load_checkpoint
    from heal_swin_torch.training.trainer import Trainer
    from heal_swin_torch.utils.utils import get_config_from_config_path

    seg_cfg, depth_cfg = config_paths()
    t = time.perf_counter()
    for version, depth in (("woodscape", False), ("synwoodscape", True)):
        generate(root, version=version, n_per_cam=RUN_N_PER_CAM, W=FIXTURE_W, H=FIXTURE_H,
                 seed=0, with_depth=depth)
    gen_s = time.perf_counter() - t
    log(f"run entry: both {FIXTURE_H}x{FIXTURE_W} fixtures, {4 * RUN_N_PER_CAM} images each, written in "
        f"{gen_s:.3f} s")
    decode = host_decode_ms(root)

    # the projection on the card, against the host npz pipeline
    rc = get_config_from_config_path(seg_cfg, "get_train_run_config")
    t = time.perf_counter()
    dm, spec = get_data_module(rc.data)
    log(f"run entry: segmentation datamodule (the host npz projection of all "
        f"{4 * RUN_N_PER_CAM} images at nside {dm.nside} included) in "
        f"{time.perf_counter() - t:.3f} s; {len(dm.train_dataset)} train / "
        f"{len(dm.val_dataset)} validation samples, {spec.f_out} classes")
    seg_proj, _, seg_batch = check_projection(dm, dev, depth=False)
    drc = get_config_from_config_path(depth_cfg, "get_train_run_config")
    ddm, _ = get_data_module(drc.data)
    depth_proj, _, _ = check_projection(ddm, dev, depth=True)
    n_train, n_val = len(dm.train_dataset), len(dm.val_dataset)
    steps = n_train // rc.data.common.batch_size
    pl = get_config_from_config_path(seg_cfg, "get_pl_config")
    val_batches = min(pl.limit_val_batches, n_val // rc.data.common.val_batch_size)
    c = rc.data.common
    pred_batches = min(pl.limit_predict_batches, -(-len(dm.pred_dataset) // c.pred_batch_size))
    n_pred = min(len(dm.pred_dataset), pred_batches * c.pred_batch_size)
    batches = dict(val_batches=val_batches, pred_batches=pred_batches, n_pred=n_pred,
                   all_pred_batches=-(-len(dm.pred_dataset) // c.pred_batch_size),
                   all_n_pred=len(dm.pred_dataset), pred_batch_size=c.pred_batch_size,
                   val_batch_size=c.val_batch_size,
                   masked_batches=-(-n_val // c.val_batch_size))
    evaluation = eval_launches(val_batches, pred_batches)

    # K6 / K7 at the fixture's classes, against their plain versions
    rnd, _ = seeded_draws(torch.Generator().manual_seed(SEED + 7), dev)
    check_loss_kernels(f"run entry F={spec.f_out}",
                       tail_inputs(rnd, torch.Generator().manual_seed(SEED + 8), dev,
                                   F=spec.f_out), TAIL_P, fh, timing=False)

    # the bare bf16 train_step on a projected batch on the card, and lr_find
    task = build_task(rc.model, spec, rc.data, device=dev)
    bare, bare_mem = bare_step_rate(task, seg_batch)
    trainer = Trainer(pl, rc.train, device=dev)
    t = time.perf_counter()
    sugg, lrs, losses = trainer.lr_find(task, dm, num_training=LR_FIND_STEPS)
    lr_s = time.perf_counter() - t
    if (len(lrs) < 5 or not all(math.isfinite(v) for v in lrs + losses)
            or sugg is None or not min(lrs) <= sugg <= max(lrs)):
        raise AssertionError(f"lr_find: suggestion {sugg}, rates {lrs}, losses {losses}")
    log(f"lr_find: {len(lrs)} steps in {lr_s:.3f} s, suggested lr {sugg:.4e}; smoothed "
        "losses " + " ".join(f"{v:.4f}" for v in losses))
    del task, trainer, seg_batch
    torch.cuda.empty_cache()

    # segmentation through the entry, then its resume
    store = MlflowFileStore(root / "mlruns")
    run_id, seg_s, launches, by_shape, fit_steady = run_entry(
        "entry train", root, ["train", "--config_path", seg_cfg], {}, evaluates=True)
    check_launches("entry train", launches, by_shape,
                   add_launches(expect_launches(SEG_STEP_LAUNCHES, RUN_EPOCHS * steps,
                                                ATTN_LAUNCHES[True], val_batches),
                                evaluation), timed)
    val_names = ("val_loss", "val_acc", "val_iou_global", "val_iou_global_ignored")
    run = entry_run(store, run_id, "entry train",
                    ("train_loss", "train_acc", "train_iou_global", "epoch") + val_names,
                    "val_iou_global_ignored")
    tl = [v for _, v, _ in run.get_metric_history("train_loss")]
    if len(tl) != RUN_EPOCHS or not tl[-1] < tl[0]:
        raise AssertionError(f"entry train: train_loss by epoch {tl}")
    tps = [v for _, v, _ in run.get_metric_history("train_time_per_sample in ms")]
    fit_rate = 1e3 / tps[-1]
    log(f"entry train: {RUN_EPOCHS} epochs of {steps} steps; train_loss by epoch "
        + " ".join(f"{v:.6f}" for v in tl) + "; "
        + " ".join(f"{k} {run.get_metric_history(k)[-1][1]:.6f}" for k in val_names)
        + f"; fit {fit_rate:.4f} img/s in its last epoch (train_time_per_sample "
        + " ".join(f"{v:.3f}" for v in tps) + f" ms), {fit_steady:.4f} after the epoch's "
        f"first step, against the bare train_step's {bare:.4f} img/s ({bare_mem:.3f} GiB "
        "above the resident)")

    seg_eval = check_eval_after_train("entry train", run, n_pred)

    resume_id, resume_s, launches, by_shape, _ = run_entry(
        "entry resume", root, ["resume", "--config_path", seg_cfg],
        dict(RUN_ID=run_id, SMOKE_EPOCHS=str(RUN_EPOCHS + 1)), evaluates=True)
    check_launches("entry resume", launches, by_shape,
                   add_launches(expect_launches(SEG_STEP_LAUNCHES, steps), evaluation),
                   timed)
    resumed = entry_run(store, resume_id, "entry resume", ("train_loss", "epoch"),
                        "val_iou_global_ignored", epoch_files=(0, 0))
    epochs = [v for _, v, _ in resumed.get_metric_history("epoch")]
    _, _, meta = load_checkpoint(resumed.artifact_dir / "checkpoints" / "last.ckpt")
    if (epochs != [RUN_EPOCHS] or meta["epoch"] != RUN_EPOCHS
            or meta["global_step"] != (RUN_EPOCHS + 1) * steps):
        raise AssertionError(f"entry resume: epochs {epochs}, last.ckpt {meta}")
    log(f"entry resume: run {resume_id} continued {run_id} from its last.ckpt: epoch "
        f"{RUN_EPOCHS} only, to global step {meta['global_step']}, train_loss "
        f"{resumed.get_metric_history('train_loss')[-1][1]:.6f}")
    check_eval_after_train("entry resume", resumed, n_pred)

    # depth through the entry
    depth_id, depth_s, launches, by_shape, depth_steady = run_entry(
        "entry depth", root, ["train", "--config_path", depth_cfg],
        dict(SMOKE_EPOCHS=str(RUN_DEPTH_EPOCHS)))
    dsteps = len(ddm.train_dataset) // drc.data.common.batch_size
    dval = min(pl.limit_val_batches, len(ddm.val_dataset) // drc.data.common.val_batch_size)
    dc = drc.data.common
    dpred = min(RUN_DEPTH_PREDICT_BATCHES, -(-len(ddm.pred_dataset) // dc.pred_batch_size))
    batches.update(depth_val_batches=dval, depth_pred_batches=dpred,
                   depth_n_pred=min(len(ddm.pred_dataset), dpred * dc.pred_batch_size))
    check_launches("entry depth", launches, by_shape,
                   expect_launches(DEPTH_STEP_LAUNCHES, RUN_DEPTH_EPOCHS * dsteps,
                                   DEPTH_VAL_LAUNCHES, dval), timed)
    drun = entry_run(store, depth_id, "entry depth",
                     ("train_loss", "val_loss", "val_mse", "epoch"), "val_mse")
    dtps = [v for _, v, _ in drun.get_metric_history("train_time_per_sample in ms")]
    log(f"entry depth: {RUN_DEPTH_EPOCHS} epochs of {dsteps} steps; train_loss by epoch "
        + " ".join(f"{v:.6f}" for _, v, _ in drun.get_metric_history("train_loss"))
        + f"; val_mse {drun.get_metric_history('val_mse')[-1][1]:.6f}; fit "
        f"{1e3 / dtps[-1]:.4f} img/s in its last epoch, {depth_steady:.4f} after its first "
        "step")
    timed["run entry"] = dict(decode, seg_projection=seg_proj, depth_projection=depth_proj,
                              fit_img_s=fit_rate, fit_steady_img_s=fit_steady,
                              bare_img_s=bare, depth_fit_steady_img_s=depth_steady,
                              train_s=seg_s,
                              resume_s=resume_s, depth_s=depth_s, lr_find_s=lr_s,
                              fixtures_s=gen_s, eval_after_train=seg_eval)
    log("run entry: " + json.dumps(timed["run entry"]))
    return dict(batches, seg=run_id, depth=depth_id)


CHAMFER_KERNELS = ("chamfer_min_both", "chamfer_fold_pairs")


class MetricsRecorder:
    """A tracking run that keeps what a writer logs."""

    def __init__(self):
        self.metrics = {}

    def log_metrics(self, metrics):
        self.metrics.update(metrics)


def headline_predict(label, dm, task, ec, pl, dev, out_dir):
    """The headline writer (``back_projected_hp_masked_iou``, ``ec``'s settings) through
    ``Trainer.predict`` of ``task`` on the card, with the counters set to 0 just before
    and read just after: (metrics, back-projected flat predictions, launches, seconds to
    build the writer, the predict's Trainer)."""
    from heal_swin_torch.training.trainer import Trainer

    t = time.perf_counter()
    rec = MetricsRecorder()
    writer = dm.get_pred_writer(ec.pred_writer, output_dir=out_dir,
                                output_resolution=ec.output_resolution, proj_res=ec.proj_res,
                                prefix=EVAL_PREFIX, top_k=ec.top_k, run=rec)
    build_s = time.perf_counter() - t
    flats = []
    inner = writer.proj_pred_writer.write_on_batch_end

    def keep(preds, batch, i):
        flat, masks = inner(preds, batch, i)
        flats.append(flat)
        return flat, masks

    writer.proj_pred_writer.write_on_batch_end = keep
    trainer = Trainer(pl, device=dev)
    reset_counters()
    trainer.predict(task, dm, writer=writer)
    torch.cuda.synchronize()
    launches, by_shape = read_counters()
    log(f"{label}: writer built in {build_s:.3f} s, predict+write "
        f"{trainer.last_predict_samples} samples, device-blocked "
        f"{trainer.predict_device_time:.3f} s, writer host {trainer.predict_writer_time:.3f} s; "
        + " ".join(f"{k} {v:.6f}" for k, v in rec.metrics.items()))
    return rec.metrics, np.concatenate(flats), (launches, by_shape), build_s, trainer


def eval_inputs(cfg, run_id, dev):
    """What ``evaluate`` reads for run ``run_id`` from the evaluation config file ``cfg``:
    (its EvaluateConfig, its PLConfig, the run's model config, the datamodule and data
    spec, the checkpoint's state_dict on ``dev``)."""
    from unittest import mock

    from heal_swin_torch.data.data import get_data_module
    from heal_swin_torch.training.checkpoint import load_checkpoint
    from heal_swin_torch.utils import serialize, utils

    with mock.patch.dict(os.environ, RUN_ID=run_id):
        ec = utils.get_config_from_config_path(cfg, "get_eval_run_config")
    pl = utils.get_config_from_config_path(cfg, "get_pl_config")
    ckpt, artifacts, _ = utils.check_and_get_ckpt_paths(run_id, ec.epoch, ec.epoch_number)
    dm, spec = get_data_module(ec.data_config)
    return (ec, pl, serialize.load(artifacts / "model_config"), dm, spec,
            load_checkpoint(ckpt, map_location=dev)[0])


def check_headline_plain(dev, timed, root, run_id, cfg, logged):
    """The headline writer's metrics again in this process from the run's best checkpoint
    (the evaluation config ``cfg``'s settings), through the kernels ("auto": K1, K2 and K3
    counted) and through the plain route (``attention_impl="xla"``: the plain window
    attention and tail, no launch): the back-projected flat predictions differ on at most
    HEADLINE_PLAIN_PIXELS of the pixels (K3's near-ties), every metric within
    HEADLINE_PLAIN_TOL of the plain route's and of what the evaluate child logged
    (``logged``).  Returns the numbers."""
    import dataclasses

    from heal_swin_torch.train import build_task

    ec, pl, mc, dm, spec, state = eval_inputs(cfg, run_id, dev)
    out_dir = root / "headline_plain"
    out_dir.mkdir()
    results = {}
    for impl in ("auto", "xla"):
        inner = dataclasses.replace(mc.swin_hp_transformer_config, attention_impl=impl)
        task = build_task(dataclasses.replace(mc, swin_hp_transformer_config=inner), spec,
                          ec.data_config, device=dev)
        task.model.load_state_dict(state)
        results[impl] = headline_predict(f"headline writer {impl}", dm, task, ec, pl, dev,
                                         out_dir)
        del task
        torch.cuda.empty_cache()
    (got, flat_k, (launches, by_shape), build_s, tr), (want, flat_p, (plain_l, _), _, _) = (
        results["auto"], results["xla"])
    n_pred = flat_k.shape[0]
    expected = eval_launches(0, -(-n_pred // ec.data_config.common.pred_batch_size))
    check_launches("headline writer auto", launches, by_shape, expected, timed)
    if any(plain_l.values()):
        raise AssertionError(f"headline writer xla: launches {plain_l}")
    differ = float((flat_k != flat_p).mean())
    if set(got) != set(want) or not set(got) <= set(logged):
        raise AssertionError(f"headline writer: metric names {sorted(got)}, plain "
                             f"{sorted(want)}, the child's {sorted(logged)}")
    worst = max(abs(got[k] - want[k]) for k in got)
    child = max(abs(got[k] - logged[k]) for k in got)
    if differ > HEADLINE_PLAIN_PIXELS or worst > HEADLINE_PLAIN_TOL or child > HEADLINE_PLAIN_TOL:
        raise AssertionError(f"headline writer: kernel vs plain {differ:.3e} of the pixels "
                             f"differ, metrics {worst:.3e} apart (the child's {child:.3e})")
    log(f"headline writer: kernel route vs plain route on {n_pred} back-projected "
        f"{flat_k.shape[1]}x{flat_k.shape[2]} predictions: {differ:.3e} of the pixels differ "
        f"(limit {HEADLINE_PLAIN_PIXELS}), metrics at most {worst:.3e} apart (limit "
        f"{HEADLINE_PLAIN_TOL}), {child:.3e} from the evaluate child's; the first writer "
        f"built in {build_s:.3f} s (its HP footprints and nearest-pixel table)")
    return dict(pixels_differ=differ, metric_diff=worst, child_diff=child,
                writer_build_s=build_s, writer_host_s_per_sample=tr.predict_writer_time / n_pred,
                device_blocked_s=tr.predict_device_time, predicted=n_pred)


def check_depth_chamfer(dev, timed, root, run_id, cfg, logged, child_by_shape):
    """The depth evaluation's Chamfer writer again in this process from the run's best
    checkpoint (the evaluation config ``cfg``'s settings), through ``Trainer.predict``
    with the counters set to 0 just before and read just after and the writer's
    ``on_pair`` records kept, as ``drive_chamfer_eval`` holds the writer at the paper
    sizes: every pair bit-equal on the other route (``check_other_route``: each launched
    K10 / K11 shape checked and entered in ``timed``), and K10's plain version on the
    first brute pair and K11's fold by fold on the first pruned pair bit-equal to the
    writer's minima (``check_chamfer_paper``).  The Chamfer launches by shape must equal
    the evaluate child's (``child_by_shape``), and each Chamfer metric must be within
    CHAMFER_CHILD_REL_TOL of what the child logged (``logged``).  Returns the Chamfer
    launches per kernel and the numbers."""
    from heal_swin_torch.train import build_task
    from heal_swin_torch.training.trainer import Trainer

    ec, pl, mc, dm, spec, state = eval_inputs(cfg, run_id, dev)
    task = build_task(mc, spec, ec.data_config, device=dev)
    task.model.load_state_dict(state)
    del state
    rec, stats = MetricsRecorder(), []
    out_dir = root / "chamfer_parent"
    out_dir.mkdir()
    writer = dm.get_pred_writer(ec.pred_writer, output_dir=out_dir,
                                output_resolution=ec.output_resolution, proj_res=ec.proj_res,
                                prefix=EVAL_PREFIX, top_k=ec.top_k,
                                ranking_metric=ec.ranking_metric, sort_dir=ec.sort_dir,
                                run=rec, device=dev, on_pair=stats.append)
    t = time.perf_counter()
    reset_counters()
    Trainer(pl, device=dev).predict(task, dm, writer=writer)
    torch.cuda.synchronize()
    _, by_shape = read_counters()
    write_s = time.perf_counter() - t
    del task
    torch.cuda.empty_cache()

    t = time.perf_counter()
    check_other_route(stats, dev, timed)
    brute, pruned = (next((st for st in stats if st["route"] == r), None)
                     for r in ("brute", "pruned"))
    if brute is None or pruned is None:
        raise AssertionError("evaluate depth: the writer's pairs took the routes "
                             f"{[st['route'] for st in stats]}: one of each is needed")
    k10, k11 = check_chamfer_paper(dev, brute, pruned, label="evaluate depth Chamfer pairs")
    check_s = time.perf_counter() - t
    mine = {k: v for k, v in by_shape.items() if k[0] in CHAMFER_KERNELS}
    child = {k: v for k, v in child_by_shape.items() if k[0] in CHAMFER_KERNELS}
    if mine != child:
        raise AssertionError(f"evaluate depth: Chamfer launches by shape {mine} here, "
                             f"{child} in the evaluate child")
    if set(rec.metrics) - set(logged) or len(rec.metrics) != 4:
        raise AssertionError(f"evaluate depth: metrics {sorted(rec.metrics)} here, the "
                             f"child's {sorted(logged)}")
    apart = max(abs(v - logged[k]) / abs(logged[k]) for k, v in rec.metrics.items())
    if not apart <= CHAMFER_CHILD_REL_TOL:
        raise AssertionError(f"evaluate depth: Chamfer metrics {rec.metrics} here, the "
                             f"child's {logged}: {apart:.3e} apart")
    launches = {k: sum(v for s, v in mine.items() if s[0] == k) for k in CHAMFER_KERNELS}
    log(f"evaluate depth: the Chamfer writer again here from the best checkpoint: "
        f"{len(stats)} pairs in {write_s:.3f} s with its predict, each bit-equal on the "
        f"other route, the first brute and the first pruned pair held to K10's / K11's "
        f"plain versions, in {check_s:.3f} s; launches by shape equal to the child's ({launches}); metrics "
        f"{apart:.3e} apart from the child's (limit {CHAMFER_CHILD_REL_TOL})")
    return launches, dict(pairs=len(stats), write_s=write_s, check_s=check_s,
                          metric_rel_diff=apart, k10_ms=k10["ms"], k10_plain_ms=k10["plain_ms"],
                          k10_on=k10["timed_on"], k11_ms=k11["ms"],
                          k11_plain_ms=k11["plain_ms"], k11_on=k11["timed_on"])


def drive_evaluate(dev, timed, root, entry):
    """The evaluation entry on the card: ``python3 -m heal_swin_torch.cli evaluate`` of the
    run-entry phase's runs (``entry``), each in a child process whose launches are counted:
    the convergence config's headline evaluation as it ships (validation, then predict
    through the ``back_projected_hp_masked_iou`` writer at proj_res 966), the same with the
    masked IoU and every predict sample (``eval_wrapper``), and the depth config's Chamfer
    evaluation with RUN_DEPTH_PREDICT_BATCHES predict batches (``eval_wrapper``).  Each:
    exit code 0 and "Evaluation finished.", every launch (``eval_launches``; depth: with
    the Chamfer launches that ``check_depth_chamfer`` checked, shape by shape), and the
    metrics it logs into the run, finite and the rates in [0, 1].  Then
    ``check_headline_plain``.  Logs the evaluation's rates, the samples each rests on, and
    the phase's wall time."""
    from heal_swin_torch.tracking.mlflow_store import MlflowFileStore

    t_phase = time.perf_counter()
    seg_cfg, depth_cfg = config_paths()
    masked_cfg = eval_wrapper(root, "eval_masked_config.py", seg_cfg,
                              dict(log_masked_iou=True), dict(limit_predict_batches=1.0))
    depth_eval_cfg = eval_wrapper(root, "eval_depth_config.py", depth_cfg,
                                  pl_changes=dict(limit_predict_batches=RUN_DEPTH_PREDICT_BATCHES))
    store = MlflowFileStore(root / "mlruns")
    head = (EVAL_PREFIX + "val_back_projected_hp_masked_iou",) + tuple(
        f"{EVAL_PREFIX}val_{k}_back_projected" for k in ("acc", "acc_ignored", "iou",
                                                          "iou_ignored"))
    masked = (EVAL_PREFIX + "val_masked_iou", EVAL_PREFIX + "val_masked_iou_ignored")
    numbers = {}
    # the samples each rate rests on: the steady window leaves out the first batch
    val_steady = (entry["val_batches"] - 1) * entry["val_batch_size"]
    for label, cfg, extra, pred_batches, n_pred in (
            ("evaluate", seg_cfg, (), entry["pred_batches"], entry["n_pred"]),
            ("evaluate masked", masked_cfg, masked, entry["all_pred_batches"],
             entry["all_n_pred"])):
        _, seconds, launches, by_shape, _ = run_entry(
            label, root, ["evaluate", "--config_path", cfg], dict(RUN_ID=entry["seg"]),
            evaluates=True)
        check_launches(label, launches, by_shape, eval_launches(
            entry["val_batches"], pred_batches, entry["masked_batches"] if extra else 0), timed)
        values = eval_metrics(label, store.get_run(entry["seg"]), head + EVAL_VAL_RATES + extra,
                              (EVAL_PREFIX + "val_loss",) + EVAL_CLOCKS)
        numbers[label] = dict(eval_numbers(values, n_pred), seconds=seconds, predicted=n_pred,
                              val_steady_samples=val_steady,
                              predict_steady_samples=n_pred - entry["pred_batch_size"])
        log(f"{label}: " + " ".join(f"{k} {v:.6f}" for k, v in values.items())
            + f"; the validate rate over its {val_steady} steady samples, predict+write over "
            f"{n_pred - entry['pred_batch_size']} of {n_pred}")
    headline = {k: values[k] for k in head}

    _, seconds, launches, by_shape, _ = run_entry(
        "evaluate depth", root, ["evaluate", "--config_path", depth_eval_cfg],
        dict(RUN_ID=entry["depth"]), evaluates=True)
    # one predict batch leaves no steady state after the first: no predict rate logged
    clocks = EVAL_CLOCKS if entry["depth_pred_batches"] > 1 else tuple(
        k for k in EVAL_CLOCKS if not k.endswith("predict_samples_per_sec"))
    chamfer_names = tuple(EVAL_PREFIX + k for k in (
        "chamfer_distance", "chamfer_distance_full_res", "chamfer_distance_full_res_hp_masked",
        "chamfer_distance_small_res_hp_masked"))
    values = eval_metrics("evaluate depth", store.get_run(entry["depth"]), (),
                          chamfer_names + tuple(EVAL_PREFIX + k for k in ("val_mse", "val_loss"))
                          + clocks)
    chamfer, checked = check_depth_chamfer(dev, timed, root, entry["depth"], depth_eval_cfg,
                                           {k: values[k] for k in chamfer_names}, by_shape)
    check_launches("evaluate depth", launches, by_shape,
                   add_launches(eval_launches(entry["depth_val_batches"],
                                              entry["depth_pred_batches"], depth=True), chamfer),
                   timed)
    numbers["evaluate depth"] = dict(eval_numbers(values, entry["depth_n_pred"]),
                                     seconds=seconds, chamfer_check=checked, **chamfer)
    log("evaluate depth: " + " ".join(f"{k} {v:.6f}" for k, v in values.items()))

    numbers["headline plain"] = check_headline_plain(dev, timed, root, entry["seg"], masked_cfg,
                                                     headline)
    numbers["phase_s"] = time.perf_counter() - t_phase
    timed["evaluate"] = numbers
    log(f"evaluate: {nvidia_smi()}; " + json.dumps(numbers))


# ------------------------------------------------------- the flat SWIN-UNet on the card
FLAT_ENTRY_EPOCHS = 2  # the paper flat segmentation config through the entry: 2 epochs
FLAT_PRED_BATCHES = 2  # predict batches of each flat evaluation (pred_batch_size 2)
FLAT_CHAMFER_SAMPLES = 1  # the flat depth Chamfer writer's samples
FLAT_ENTRY_DATA = {}  # data config fields the entry's flat runs set (a rehearsal: sizes)
FLAT_PAPER_SEG = "swin_synwoodscape_large_train_run_config.py"
FLAT_PAPER_DEPTH = "depth_swin_train_run_config.py"
# the f32 paper flat model's launches: a train step (attention dropout sends every block
# to the plain route; the fused tail), a validation batch (a sample mask: unfused tail),
# a predict batch
FLAT_STEP_LAUNCHES = dict(final_head_loss_f32=1, final_head_loss_bwd_f32=1)
FLAT_PRED_LAUNCHES = dict(PAPER_EVAL_LAUNCHES, final_head_predict_f32=1)


def drive_flat(dev, timed):
    """The flat SWIN-UNet of bench.py's ``swin`` and ``depth_swin`` cells (640 x 768,
    batch 2, bf16, full width and depth) on the card: K1, K4, K2, K5, K3, K6 and K7
    against their plain versions at its shapes, on its 9-region masks and 2-D rel-pos
    bias (``check_kernels``' ``flat``); segmentation predict (K1 20, K2 2, K3 1), the
    segmentation train step (K1 20, K4 20, K2 2, K5 2, K6 1, K7 1) and the depth predict
    and train step (K1 20, K4 20, K2 2, K5 2 and no K8 / K9: the flat depth tail is
    unfused), each through the kernels and through the plain path on the same weights
    (``drive_slice`` / ``drive_train``' ``flat``).  Returns (the predict's launches, the
    segmentation step's)."""
    timed.update(check_kernels(torch.Generator().manual_seed(SEED + 40), dev, flat=True))
    torch.cuda.empty_cache()
    predict_run = drive_slice(dev, timed, flat=True)
    torch.cuda.empty_cache()
    train_run = drive_train(dev, timed, flat=True)
    torch.cuda.empty_cache()
    drive_train(dev, timed, depth=True, flat=True)
    torch.cuda.empty_cache()
    return predict_run, train_run


def drive_flat_paper(dev, timed):
    """The two paper flat configs (f32, dropout, attention dropout and DropPath 0.1) on
    the card: the f32 K6 / K7 and the f32 K1, K2 and K3 against their plain versions at
    the flat shapes (``check_f32_loss_kernels``, ``check_f32_eval_kernels``' ``flat``);
    the segmentation config's train step through both paths on the same dropout masks
    (``paper_step``: f32 K6 1, K7 1); both configs' predict through the kernels and
    against ``attention_impl="xla"`` (``paper_predict``: f32 K1 20, K2 2, and K3 1 for
    segmentation, within PAPER_EVAL_TOL); then ``Trainer.fit`` of both on the synthetic
    flat datamodule, the segmentation fit resumed (``drive_fit``' ``flat``).  Returns (the
    train step's launches, the segmentation predict's)."""
    from heal_swin_torch.ops import final_head as fh

    timed.update(check_f32_loss_kernels(paper_tail_inputs(
        torch.Generator().manual_seed(SEED + 41), dev, flat=True), fh))
    timed.update(check_f32_eval_kernels(torch.Generator().manual_seed(SEED + 42), dev,
                                        flat=True))
    torch.cuda.empty_cache()
    task_k = paper_task("auto", dev, flat=True)
    task_p = paper_task("xla", dev, state=task_k.model.state_dict(), flat=True)
    imgs, _ = train_batch(dev, flat=True)
    targets = torch.clamp(((imgs[..., 0] + 2.5) * PAPER_CLASSES / 5).long(), 0,
                          PAPER_CLASSES - 1).to(torch.int32)
    train_run = paper_step("flat paper train", task_k, task_p, imgs, targets,
                           dict(NO_LAUNCHES, **FLAT_STEP_LAUNCHES), timed,
                           ("total", targets.numel()))
    del task_k, task_p
    torch.cuda.empty_cache()
    runs = {}
    for depth in (False, True):
        task_k = paper_task("auto", dev, depth=depth, flat=True)
        task_p = paper_task("xla", dev, state=task_k.model.state_dict(), depth=depth,
                            flat=True)
        imgs = torch.randn((BATCH,) + FLAT_IN + (3,),
                           generator=torch.Generator().manual_seed(SEED + 30)).to(dev)
        runs[depth] = paper_predict("flat paper depth eval" if depth else "flat paper eval",
                                    task_k, task_p, imgs, timed, depth)
        del task_k, task_p
        torch.cuda.empty_cache()
    drive_fit(dev, timed, flat=True)
    return train_run, runs[False]


FLAT_WRAPPER = """import dataclasses
import os

from heal_swin_torch.evaluation.evaluate_config import EvaluateConfig
from heal_swin_torch.training.train_config import TrainConfig
from heal_swin_torch.utils.utils import get_config_from_config_path

BASE = {base!r}


def get_train_run_config():
    rc = get_config_from_config_path(BASE, "get_train_run_config")
    common = dataclasses.replace(rc.data.common, **{common!r})
    data = dataclasses.replace(rc.data, common=common, **{data!r})
    return dataclasses.replace(rc, data=data,
                               model=dataclasses.replace(rc.model, **{model!r}),
                               train=dataclasses.replace(rc.train, **{train!r}))


def get_pl_config():
    return dataclasses.replace(get_config_from_config_path(BASE, "get_pl_config"), **{pl!r})


def get_eval_run_config():
    rc = get_train_run_config()
    return EvaluateConfig(path=os.environ["RUN_ID"], epoch="best",
                          train_config=TrainConfig(mlflow_expmt=rc.train.mlflow_expmt),
                          data_config=rc.data, **{evaluate!r})
"""


def flat_wrapper(root, name, base, evaluate=None, common=None, pl=None):
    """A config file ``root / name`` of the port's copy of the paper flat segmentation
    config ``base`` on the generated WoodScape fixture: its 4 classes unweighted (the
    paper's 8 SynWoodScape-large weights do not apply), batch sizes of 2, a quarter of the
    fixture's images for validation (4: two full batches, as the smoke configs), one
    process on one GPU (the copy asks for 4 with DDP), FLAT_ENTRY_EPOCHS epochs validated
    once (2 batches); ``get_eval_run_config`` the evaluation of run RUN_ID with
    ``evaluate``.
    The shipped file is left as it is."""
    path = root / name
    path.write_text(FLAT_WRAPPER.format(
        base=base,
        common=dict(dict(version="woodscape", val_batch_size=2, pred_batch_size=2,
                         train_share=0.75, train_worker=2, val_worker=2), **(common or {})),
        data=FLAT_ENTRY_DATA, model=dict(class_weights=None), train=dict(seed=SEED),
        pl=dict(dict(gpus=1, accelerator=None, max_epochs=FLAT_ENTRY_EPOCHS,
                     check_val_every_n_epoch=FLAT_ENTRY_EPOCHS, limit_val_batches=2,
                     limit_predict_batches=FLAT_PRED_BATCHES, num_sanity_val_steps=0,
                     log_every_n_steps=10 ** 6), **(pl or {})),
        evaluate=evaluate or {}))
    return str(path)


def flat_predict(label, dm, task, writer, pl, dev):
    """``Trainer.predict`` of ``task`` through ``writer`` on the card, the counters set to
    0 just before and read just after, the classes handed to the writer kept: (the
    classes, the launches, the predict's Trainer)."""
    from heal_swin_torch.training.trainer import Trainer

    kept = []
    inner = writer.write_on_batch_end

    def keep(preds, batch, i):
        kept.append(np.asarray(preds))
        return inner(preds, batch, i)

    writer.write_on_batch_end = keep
    trainer = Trainer(pl, device=dev)
    reset_counters()
    trainer.predict(task, dm, writer=writer)
    torch.cuda.synchronize()
    launches = read_counters()
    log(f"{label}: predict+write {trainer.last_predict_samples} samples, device-blocked "
        f"{trainer.predict_device_time:.3f} s, writer host {trainer.predict_writer_time:.3f} s")
    return np.concatenate(kept), launches, trainer


def check_flat_headline_plain(dev, timed, root, run_id, cfg, logged):
    """The flat headline writer (``hp_masked_iou``) again in this process from the run's
    best checkpoint, through the kernels ("auto": f32 K1, K2, K3 counted) and through
    ``attention_impl="xla"`` (no launch): the flat classes differ on at most
    HEADLINE_PLAIN_PIXELS of the pixels (K3's near-ties), the metric within
    HEADLINE_PLAIN_TOL of the plain route's and of the evaluate child's (``logged``).
    Returns the numbers."""
    import dataclasses

    from heal_swin_torch.train import build_task

    ec, pl, mc, dm, spec, state = eval_inputs(cfg, run_id, dev)
    results = {}
    for impl in ("auto", "xla"):
        inner = dataclasses.replace(mc.swin_transformer_config, attention_impl=impl)
        task = build_task(dataclasses.replace(mc, swin_transformer_config=inner), spec,
                          ec.data_config, device=dev)
        task.model.load_state_dict(state)
        rec = MetricsRecorder()
        t = time.perf_counter()
        writer = dm.get_pred_writer(ec.pred_writer, output_dir=root, prefix=EVAL_PREFIX,
                                    run=rec)
        build_s = time.perf_counter() - t
        preds, launches, tr = flat_predict(f"flat headline writer {impl}", dm, task, writer,
                                           pl, dev)
        results[impl] = (rec.metrics, preds, launches, build_s, tr)
        del task
        torch.cuda.empty_cache()
    (got, pk, (launches, by_shape), build_s, tr), (want, pp, (plain_l, _), _, _) = (
        results["auto"], results["xla"])
    n_pred = pk.shape[0]
    check_launches("flat headline writer auto", launches, by_shape,
                   expect_launches(FLAT_PRED_LAUNCHES, -(-n_pred // ec.data_config.common
                                                          .pred_batch_size)), timed)
    if any(plain_l.values()):
        raise AssertionError(f"flat headline writer xla: launches {plain_l}")
    differ = float((pk != pp).mean())
    if set(got) != set(want) or not set(got) <= set(logged) or not got:
        raise AssertionError(f"flat headline writer: metric names {sorted(got)}, plain "
                             f"{sorted(want)}, the child's {sorted(logged)}")
    worst = max(abs(got[k] - want[k]) for k in got)
    child = max(abs(got[k] - logged[k]) for k in got)
    if differ > HEADLINE_PLAIN_PIXELS or worst > HEADLINE_PLAIN_TOL or child > HEADLINE_PLAIN_TOL:
        raise AssertionError(f"flat headline writer: kernel vs plain {differ:.3e} of the pixels "
                             f"differ, metrics {worst:.3e} apart (the child's {child:.3e})")
    log(f"flat headline writer: kernel route vs plain route on {n_pred} predicted "
        f"{pk.shape[1]}x{pk.shape[2]} class maps: {differ:.3e} of the pixels differ (limit "
        f"{HEADLINE_PLAIN_PIXELS}), metrics at most {worst:.3e} apart (limit "
        f"{HEADLINE_PLAIN_TOL}), {child:.3e} from the evaluate child's; the writer built in "
        f"{build_s:.3f} s (one HP footprint a calibration cluster); " + " ".join(
            f"{k} {v:.6f}" for k, v in got.items()))
    return dict(pixels_differ=differ, metric_diff=worst, child_diff=child,
                writer_build_s=build_s, writer_host_s_per_sample=tr.predict_writer_time / n_pred,
                device_blocked_s=tr.predict_device_time, predicted=n_pred, **got)


def check_flat_chamfer(dev, timed, root):
    """The flat depth Chamfer writer on the card: the paper flat depth config's task
    (seeded weights, ``paper_task``) predicts FLAT_CHAMFER_SAMPLES sample of the generated
    SynWoodScape fixture at 640 x 768 (its HP targets at nside 256) through
    ``Trainer.predict`` and the writer, the counters set to 0 just before and read just
    after (f32 K1 20, K2 2 and the folds' K10 / K11); every pair again on the other route,
    per point bit-equal (``check_other_route``); K10's plain version on the first brute
    pair and K11's fold by fold on the first pruned pair bit-equal to the writer's minima
    (``check_chamfer_paper``).  Returns (the writer's launches, the K10 / K11 entries'
    times on those pairs, the numbers)."""
    import dataclasses

    from heal_swin_torch.data.data import get_data_module
    from heal_swin_torch.evaluation.hp_depth_pred_writers import METRICS
    from heal_swin_torch.run_configs import depth_swin_train_run
    from heal_swin_torch.training.train_config import PLConfig

    rc = depth_swin_train_run()
    common = dataclasses.replace(rc.data.common, pred_batch_size=FLAT_CHAMFER_SAMPLES,
                                 val_worker=0)
    dm, _ = get_data_module(dataclasses.replace(rc.data, common=common, **FLAT_ENTRY_DATA))
    task = paper_task("auto", dev, depth=True, flat=True)
    # the sample's predict against the plain route: the writer's f32 K1 / K2 launch at
    # batch 1, shapes the paper-config checks do not time
    imgs = torch.as_tensor(next(iter(dm.predict_dataloader()))["s2_imgs"]).to(dev)
    task_p = paper_task("xla", dev, state=task.model.state_dict(), depth=True, flat=True)
    reset_counters()
    out_k = task.predict(None, imgs)
    _, one = read_counters()
    err = check_close("flat Chamfer predict metric depths", out_k, task_p.predict(None, imgs),
                      PAPER_EVAL_TOL)[0]
    for key in one:
        timed.setdefault(key, dict(checked=f"a flat depth predict against "
                                           f"attention_impl='xla', rel_l2 {err:.3e}"))
    log(f"flat Chamfer writer: its sample's predict through the kernels vs the plain route: "
        f"metric depths rel_l2 {err:.3e} (tol {PAPER_EVAL_TOL}); shapes {sorted(one)}")
    del task_p, out_k
    torch.cuda.empty_cache()
    rec, stats = MetricsRecorder(), []
    writer = dm.get_pred_writer("chamfer_distance", output_dir=root, prefix=EVAL_PREFIX,
                                run=rec, device=dev, on_pair=stats.append)
    t = time.perf_counter()
    _, (launches, by_shape), _ = flat_predict("flat Chamfer writer", dm, task, writer,
                                              PLConfig(limit_predict_batches=1), dev)
    write_s = time.perf_counter() - t
    del task
    torch.cuda.empty_cache()
    values = {EVAL_PREFIX + k: rec.metrics.get(EVAL_PREFIX + k, float("nan")) for k in METRICS}
    if len(rec.metrics) != 4 or not all(math.isfinite(v) for v in values.values()):
        raise AssertionError(f"flat Chamfer writer: metrics {rec.metrics}")
    t = time.perf_counter()
    check_other_route(stats, dev, timed)
    chamfer = {k: launches[k] for k in CHAMFER_KERNELS}
    check_launches("flat Chamfer writer", launches, by_shape,
                   add_launches(NO_LAUNCHES, PAPER_EVAL_LAUNCHES, chamfer), timed)
    if not all(chamfer.values()):
        raise AssertionError(f"flat Chamfer writer: launches {chamfer}: both folds expected")
    brute, pruned = (next(st for st in stats if st["route"] == r) for r in ("brute", "pruned"))
    k10, k11 = check_chamfer_paper(dev, brute, pruned, label="flat Chamfer pairs")
    check_s = time.perf_counter() - t
    log(f"flat Chamfer writer: {len(stats)} pairs of {FLAT_CHAMFER_SAMPLES} sample in "
        f"{write_s:.3f} s with its predict ("
        + ", ".join(f"{st['metric']} {st['route']} {st['n']} x {st['m']}" for st in stats)
        + f"), each bit-equal on the other route, the first brute and the first pruned pair "
        f"held to K10's / K11's plain versions, in {check_s:.3f} s; launches {chamfer}; "
        + " ".join(f"{k} {v:.6f}" for k, v in values.items()))
    entries = dict(  # every check above holds the minima bit-equal
        chamfer_min_both=dict(max_abs_err=0.0, **k10, library_call=(
            "torch.cdist (matrix-multiply form, inexact) + amin")),
        chamfer_fold_pairs=dict(max_abs_err=0.0, **k11))
    return (launches, by_shape), entries, dict(pairs=len(stats), write_s=write_s,
                                               check_s=check_s, **values)


def drive_flat_entry(dev, timed, root):
    """The flat SWIN-UNet through the entry on the card, in ``entry_world``'s root after
    the HEALPix phases (the fixtures, their HP npz projections and calibration clusters
    made there): ``python3 -m heal_swin_torch.cli train`` of a wrapper of the port's copy
    of the paper flat segmentation config (``flat_wrapper``: f32, 640 x 768, on the
    WoodScape fixture) in a child process, its launches counted (f32 K6 / K7 a step, f32
    K1 20 and K2 2 a validation batch) and its run checked; then ``cli evaluate`` twice:
    validation and the paper's flat headline ``hp_masked_iou`` (f32 K1 20, K2 2, K3 1 a
    predict batch), and ``val_on_hp_projected``; then the headline writer through the
    kernels against the plain route in this process (``check_flat_headline_plain``) and
    the flat depth Chamfer writer (``check_flat_chamfer``).  Returns the Chamfer writer's
    launches and its K10 / K11 times."""
    from pathlib import Path

    from heal_swin_torch.data.data import get_data_module
    from heal_swin_torch.tracking.mlflow_store import MlflowFileStore
    from heal_swin_torch.utils.utils import get_config_from_config_path

    t_phase = time.perf_counter()
    base = str(Path(__file__).resolve().parent / CONFIGS / FLAT_PAPER_SEG)
    train_cfg = flat_wrapper(root, "flat_train_config.py", base)
    rc = get_config_from_config_path(train_cfg, "get_train_run_config")
    dm, spec = get_data_module(rc.data)
    c = rc.data.common
    steps = len(dm.train_dataset) // c.batch_size
    val_batches = min(2, -(-len(dm.val_dataset) // c.val_batch_size))
    pred_batches = min(FLAT_PRED_BATCHES, -(-len(dm.pred_dataset) // c.pred_batch_size))
    n_pred = min(len(dm.pred_dataset), pred_batches * c.pred_batch_size)
    store = MlflowFileStore(root / "mlruns")
    run_id, train_s, launches, by_shape, steady = run_entry(
        "flat entry train", root, ["train", "--config_path", train_cfg], {})
    check_launches("flat entry train", launches, by_shape,
                   expect_launches(FLAT_STEP_LAUNCHES, FLAT_ENTRY_EPOCHS * steps,
                                   PAPER_EVAL_LAUNCHES, val_batches), timed)
    run = entry_run(store, run_id, "flat entry train",
                    ("train_loss", "train_acc", "train_iou_global", "epoch", "val_loss",
                     "val_iou_global_ignored"), "val_iou_global_ignored", epoch_files=(1, 1))
    tl = [v for _, v, _ in run.get_metric_history("train_loss")]
    log(f"flat entry train: {FLAT_ENTRY_EPOCHS} epochs of {steps} steps on {spec.dim_in} "
        f"images, {spec.f_out} classes; train_loss by epoch " + " ".join(f"{v:.6f}" for v in tl)
        + f"; val_iou_global_ignored {run.get_metric_history('val_iou_global_ignored')[-1][1]:.6f}"
        f"; the last epoch after its first step {steady:.4f} img/s")

    numbers = dict(train_s=train_s, fit_steady_img_s=steady, steps=steps)
    head = (EVAL_PREFIX + "val_hp_masked_iou",)
    projected = tuple(f"{EVAL_PREFIX}val_{k}_projected_to_hp"
                      for k in ("acc", "acc_ignored", "iou", "iou_ignored"))
    headline = {}
    for label, writer, validate, names in (
            ("flat evaluate", "hp_masked_iou", True, head + EVAL_VAL_RATES),
            ("flat evaluate projected", "val_on_hp_projected", False, projected)):
        cfg = flat_wrapper(root, f"{label.replace(' ', '_')}_config.py", base,
                           dict(pred_writer=writer, validate=validate))
        _, seconds, launches, by_shape, _ = run_entry(
            label, root, ["evaluate", "--config_path", cfg], dict(RUN_ID=run_id),
            evaluates=True)
        check_launches(label, launches, by_shape,
                       expect_launches(FLAT_PRED_LAUNCHES, pred_batches, PAPER_EVAL_LAUNCHES,
                                       val_batches if validate else 0), timed)
        # a rate rests on the batches after the first: none of a phase of one batch
        clocks = tuple(k for k in EVAL_CLOCKS
                       if (validate and val_batches > 1) or "val_samples" not in k)
        clocks = tuple(k for k in clocks if pred_batches > 1 or "predict_samples" not in k)
        values = eval_metrics(label, store.get_run(run_id), names,
                              ((EVAL_PREFIX + "val_loss",) if validate else ()) + clocks)
        numbers[label] = dict(eval_numbers(values, n_pred), seconds=seconds, predicted=n_pred,
                              **values)
        log(f"{label}: " + " ".join(f"{k} {v:.6f}" for k, v in values.items()))
        if writer == "hp_masked_iou":
            headline = {k: values[k] for k in head}
            headline_cfg = cfg
    numbers["headline plain"] = check_flat_headline_plain(dev, timed, root, run_id,
                                                          headline_cfg, headline)
    chamfer_run, chamfer, numbers["chamfer"] = check_flat_chamfer(dev, timed, root)
    numbers["phase_s"] = time.perf_counter() - t_phase
    timed["flat entry"] = numbers
    log(f"flat entry: {nvidia_smi()}; " + json.dumps(numbers))
    return chamfer_run, chamfer


# ------------------------------------------------ the decoder tail at every width
WIDTH_T = 8192  # tokens of a width check: 64 tiles of 128 rows
# (C, F, p) of the width checks: corners of the Pallas tails' domain (C % 16 == 8 at 8, 40
# and 136, Swin-L's C 192, heads of 3, 25, 33 and 128 classes, patches of 1, 4 and 16; C
# 192 with 128 classes is the wide route's largest shared memory), the row cores' paper
# widths C 96 and 128, and the row cores' chunked heads and streamed slices: 25 and 33
# classes at C 96 (f32 chunks of 16, bf16 chunks of 32), 64 at C 64, 128 at C 32 with 16
# slices
WIDTH_CASES = ((8, 3, 1), (40, 25, 4), (136, 128, 4), (192, 33, 16), (192, 128, 4),
               (96, 10, 4), (128, 10, 4), (96, 25, 4), (96, 33, 4), (64, 64, 1),
               (32, 128, 16))
# (C, kind, F, p) of the depth width checks: every kind and head at C 40 and 136, a patch
# of 16, and the paper widths
WIDTH_DEPTH_CASES = tuple((C, kind, F, 4) for C in (40, 136) for kind, F in DEPTH_CASES) + (
    (40, "l2", 1, 16), (192, "nll", 2, 16), (96, "l2", 1, 4), (128, "nll", 2, 4))
WIDTH_RUNS = 5  # timed calls of a width check's kernel and of its plain version
SYN_CLASSES = 25  # SynWoodScape's own classes (synwoodscape_merge_classes.py merges them to 8)
WIDE_EMBED, WIDE_HEADS = 128, (4, 8, 16, 32)  # Swin-B's width and heads
WIDE_STEPS = 2  # timed steps of the embed-128 model's kernel path after its counted one
TAIL_NAMES = {"predict": "final_head_predict", "loss": "final_head_loss",
              "loss_bwd": "final_head_loss_bwd", "depth_loss": "final_head_depth_loss",
              "depth_loss_bwd": "final_head_depth_loss_bwd"}


def check_wide_smem(fh):
    """The wide route's row kernel fits a block's shared memory at every shape the
    wrappers admit: the library's figure (``hs_final_head_wide_smem``) for each of the
    five kernels at every C % 8 up to 192 and every F up to 128 (depth: 1 and 2) is at
    most KERNEL_SMEM_LIMIT.  Returns the largest figure per kernel."""
    from heal_swin_torch import _build

    lib = _build.lib()
    worst = {}
    for kernel, kind in fh.WIDE_KINDS.items():
        fs = (1, 2) if kernel.startswith("depth") else range(1, fh.KERNEL_MAX_F + 1)
        worst[kernel] = max(lib.hs_final_head_wide_smem(C, F, kind)
                            for C in range(8, fh.KERNEL_MAX_C + 1, 8) for F in fs)
    if max(worst.values()) > fh.KERNEL_SMEM_LIMIT:
        raise AssertionError(f"wide route: shared memory above the limit: {worst}")
    log(f"wide route: the most shared memory a row kernel asks for over the domain, by "
        f"kernel: {worst} (limit {fh.KERNEL_SMEM_LIMIT})")
    return worst


def log_row_core_domain(fh):
    """The row cores' domain as ``row_core_takes`` reads it from the library: for K3, K6 and
    K7 in each dtype, each C of the row cores and the patches 1, 4 and 16, the largest head
    on the row core (every smaller one is too).  Returns it by (kernel, dtype)."""
    domain = {}
    for f32 in (False, True):
        for kernel in ("predict", "loss", "loss_bwd"):
            rows = {}
            for C in fh.ROW_CORE_CS:
                for p in (1, 4, 16):
                    took = [F for F in range(1, fh.KERNEL_MAX_F + 1)
                            if fh.row_core_takes(kernel, C, F, p, f32)]
                    if took != list(range(1, len(took) + 1)):
                        raise AssertionError(f"row core {kernel} C {C} p {p}: heads {took}")
                    rows[f"C{C} p{p}"] = len(took)
            domain[(TAIL_NAMES[kernel], "f32" if f32 else "bf16")] = rows
    log("row cores: the largest head at each width and patch: "
        + json.dumps({f"{k[0]} {k[1]}": v for k, v in domain.items()}))
    return domain


def tail_work(kernel, T, C, F, p, f32):
    """(FLOP, bytes) of one call of a tail kernel ("predict", "loss", "loss_bwd",
    "depth_loss", "depth_loss_bwd") at T tokens, width C, F outputs, patch p, counted as
    ``shape_work`` and ``f32_tail_work`` count the paper tails: the expand 2 T p C^2 and
    the head 2 T p C F forward, three times the expand and (f32: three, bf16: two) times
    the head backward; tokens read once (bf16 or f32), int32 targets and f32 weights or
    f32 depth targets read once, the classes, predictions and dx written once, the f32
    parameters and, backward, their gradients."""
    tb = 4 if f32 else 2
    weights = (p * C * C + C * F + 2 * C) * 4
    fwd = 2 * T * p * C * C + 2 * T * p * C * F
    if kernel == "predict":
        return fwd, tb * T * C + 4 * T * p + weights
    if kernel == "loss":
        return fwd, tb * T * C + 8 * T * p + weights
    if kernel == "depth_loss":
        return fwd, tb * T * C + 4 * T * p + tb * T * p * F + weights
    targets = 8 * T * p if kernel == "loss_bwd" else 4 * T * p
    return (6 * T * p * C * C + (6 if f32 else 4) * T * p * C * F,
            2 * tb * T * C + targets + 2 * weights)


def tail_bound(kernel, T, C, F, p, f32):
    """(bound ms, bound_by) of one call (``tail_work``) at the card's bf16 peak or, f32,
    its 3xTF32 rate."""
    flop, nbytes = tail_work(kernel, T, C, F, p, f32)
    return bound(flop, nbytes, F32_TC_PEAK if f32 else BF16_PEAK)


def width_inputs(gen, dev, T, C, F, p, dtype):
    """Operands (x, we, gamma, beta, wh, y, welem) of a width check: x N(0, 1) in
    ``dtype``, We N(0, 1 / C) (the expand keeps the tokens' scale), Wh N(0, 0.3^2),
    targets uniform over the F classes, seeded positive class weights per element."""
    rnd, _ = seeded_draws(gen, dev)
    x = rnd(T, C).to(dtype)
    we, wh = rnd(C, p * C, std=C ** -0.5), rnd(C, F, std=0.3)
    g, b = 1.0 + rnd(C, std=0.1), rnd(C, std=0.1)
    y = torch.randint(0, F, (T, p), generator=gen, dtype=torch.int32).to(dev)
    welem = (0.5 + torch.rand(F, generator=gen)).to(dev)[y.long()]
    return x, we, g, b, wh, y, welem


def tail_route_name(fh, kernel, C, F, p, f32):
    return fh.ROUTES[0] if fh.row_core_takes(kernel, C, F, p, f32) else fh.ROUTES[1]


def check_width_tail(label, largs, p, fh):
    """K3, K6 and K7 against their plain versions on ``largs`` (bf16 or f32, on whichever
    route takes the shape: ``check_loss_kernels`` without its timing), then one call of
    each and of its plain version (median of WIDTH_RUNS).  Returns per kernel (name, T,
    C, F, p): the route, errors, ms, plain ms, bound."""
    x, wh = largs[0], largs[4]
    T, C = x.shape
    F = wh.shape[1]
    f32 = x.dtype == torch.float32
    sfx = "_f32" if f32 else ""
    e = check_loss_kernels(label, largs, p, fh, timing=False)
    kw = dict(patch_size=p)
    scale = e["scale"]
    calls = {
        "predict": (lambda: fh.final_head_predict(*largs[:5], **kw, impl="pallas"),
                    lambda: fh.final_head_predict_plain(*largs[:5], **kw),
                    dict(max_abs_err=0, differ=e["classes_differ"], near_ties=e["near_ties"])),
        "loss": (lambda: fh.final_head_loss_sums(*largs, **kw, impl="pallas"),
                 lambda: fh.final_head_loss_plain(*largs, **kw),
                 dict(max_abs_err=abs(e["loss"] - e["plain_loss"]),
                      loss_rel_err=e["loss_rel_err"], confmat_moved=e["confmat_moved"],
                      near_tie_elements=e["near_tie_elements"])),
        "loss_bwd": (lambda: fh.final_head_loss_bwd(*largs, scale, **kw, impl="pallas"),
                     lambda: fh.final_head_loss_bwd_plain(*largs, scale, **kw),
                     dict(max_abs_err=e["max_abs_err"], rel_l2=e["rel_l2"]))}
    out = {}
    with torch.no_grad():
        for kernel, (fn, plain, errs) in calls.items():
            b, by = tail_bound(kernel, T, C, F, p, f32)
            out[(TAIL_NAMES[kernel] + sfx, T, C, F, p)] = dict(
                errs, route=tail_route_name(fh, kernel, C, F, p, f32),
                ms=median_ms(fn, WIDTH_RUNS, 1), plain_ms=median_ms(plain, WIDTH_RUNS, 1),
                bound_ms=b, bound_by=by)
    log(f"{label} routes: " + str({k[0]: v["route"] for k, v in out.items()}))
    return out


def check_width_depth(label, dargs, p, kind, fh):
    """K8 and K9 against their plain versions on ``dargs`` (``check_depth_kernels``
    without its timing: the count exact, the loss sum, the predictions and every
    gradient within its dtype's limits; the launch counters show one launch of each),
    then one call of each and of its plain version
    (median of WIDTH_RUNS).  Returns per kernel (name, T, C, F, p, kind): the route,
    errors, ms, plain ms, bound."""
    x, wh = dargs[0], dargs[4]
    T, C = x.shape
    F = wh.shape[1]
    f32 = x.dtype == torch.float32
    sfx = "_f32" if f32 else ""
    before = dict(fh.launches)
    errs = check_depth_kernels(label, dargs, p, kind, fh, timing=False)
    counted = {k: fh.launches[k + sfx] - before[k + sfx] for k in (
        "final_head_depth_loss", "final_head_depth_loss_bwd")}
    if counted != dict(final_head_depth_loss=1, final_head_depth_loss_bwd=1):
        raise AssertionError(f"{label}: launches counted {counted}")
    kw = dict(patch_size=p, loss_kind=kind, huber_delta=HUBER_DELTA)
    scale = torch.ones((), device=x.device) / torch.isfinite(dargs[5]).sum().clamp_min(1)
    out = {}
    with torch.no_grad():
        for kernel, fn, plain, e in (
                ("depth_loss", lambda: fh.final_head_depth_loss_sums(*dargs, **kw, impl="pallas"),
                 lambda: fh.final_head_depth_loss_plain(*dargs, **kw),
                 dict(max_abs_err=errs["pred_max_abs"], rel_l2=errs["pred_rel_l2"],
                      loss_sum_rel_err=errs["loss_sum_rel_err"])),
                ("depth_loss_bwd",
                 lambda: fh.final_head_depth_loss_bwd(*dargs, scale, **kw, impl="pallas"),
                 lambda: fh.final_head_depth_loss_bwd_plain(*dargs, scale, **kw),
                 dict(max_abs_err=errs["grad_max_abs"], rel_l2=errs["grad_rel_l2"]))):
            b, by = tail_bound(kernel, T, C, F, p, f32)
            out[(TAIL_NAMES[kernel] + sfx, T, C, F, p, kind)] = dict(
                e, route=tail_route_name(fh, kernel, C, F, p, f32),
                ms=median_ms(fn, WIDTH_RUNS, 1), plain_ms=median_ms(plain, WIDTH_RUNS, 1),
                bound_ms=b, bound_by=by)
    return out


def time_width_path(label, largs, p, fh, kernels):
    """One call of each of ``kernels`` ("predict", "loss", "loss_bwd") at a path's tail
    (``largs``): ms (median of TIMING_RUNS), device ms (``device_ms``: ``spin_ms``, and by
    kernel from a trace, logged), the plain version's ms, the composed PyTorch route's in
    the tokens' dtype (``pred_route``, ``tail_route``; its backward autograd on a saved
    graph), its device ms, and the bound.  Returns them per kernel name."""
    x = largs[0]
    T, C = x.shape
    F = largs[4].shape[1]
    f32 = x.dtype == torch.float32
    sfx = "_f32" if f32 else ""
    kw = dict(patch_size=p)
    with torch.no_grad():
        wnum, wden, _ = fh.final_head_loss_plain(*largs, **kw)
    scale = torch.ones((), device=x.device) / wden
    route_f, route_b = tail_route(largs, p, x.dtype)
    routes = {"predict": pred_route(largs[:5], p, x.dtype), "loss": route_f,
              "loss_bwd": route_b}
    calls = {"predict": (lambda: fh.final_head_predict(*largs[:5], **kw, impl="pallas"),
                         lambda: fh.final_head_predict_plain(*largs[:5], **kw)),
             "loss": (lambda: fh.final_head_loss_sums(*largs, **kw, impl="pallas"),
                      lambda: fh.final_head_loss_plain(*largs, **kw)),
             "loss_bwd": (lambda: fh.final_head_loss_bwd(*largs, scale, **kw, impl="pallas"),
                          lambda: fh.final_head_loss_bwd_plain(*largs, scale, **kw))}
    out = {}
    for kernel in kernels:
        fn, plain = calls[kernel]
        with torch.no_grad():
            ms, pms = median_ms(fn), median_ms(plain)
            by, dev_ms = device_ms(fn)
        rms, rdev = median_ms(routes[kernel]), spin_ms(routes[kernel])
        b, bound_by = tail_bound(kernel, T, C, F, p, f32)
        name = TAIL_NAMES[kernel] + sfx
        out[name] = dict(T=T, C=C, F=F, p=p, route=tail_route_name(fh, kernel, C, F, p, f32),
                         ms=ms, device_ms=dev_ms, plain_ms=pms, route_ms=rms,
                         route_device_ms=rdev, bound_ms=b, bound_by=bound_by)
        log(f"{label} {name} T={T} C={C} F={F} p={p} ({out[name]['route']}): kernel "
            f"{ms:.4f} ms (device {dev_ms:.4f} ms) plain {pms:.4f} ms route {rms:.4f} ms "
            f"(device {rdev:.4f} ms), bound {b:.4f} ms ({bound_by})")
        for kname, kms in sorted(by.items(), key=lambda kv: -kv[1]):
            log(f"{label} {name} one call on the device: {kms:9.4f} ms  {kname[:100]}")
    del routes, route_f, route_b
    return out


def drive_wide_train(dev, timed):
    """Path (b): a bf16 HEAL-SWIN at Swin-B's width (embed 128, heads [4, 8, 16, 32], the
    paper's depths, window 64, cosine attention, WoodScape's 10 classes; K1/K4 at the
    stages of C <= 384, K2/K5 at C 512 and 1024) through the kernels and the plain path
    on the same weights: every block on the plain path's input and upstream gradient
    (``check_train_blocks``), the fused tail on the kernel path's own features
    (``check_loss_kernels``: K6 on the row core, K7 at C 128, p 4 on the row core with its
    slices streamed), one counted train step of each path (one K6 and one K7 at (T, 128),
    both on the row core, the attention kernels 22 forward and 22 backward, nothing else),
    then WIDE_STEPS timed steps of the kernel path, the loss falling.  Returns (the step's
    launches per kernel and per shape, the tail's timings)."""
    from heal_swin_torch.models.tasks import decoder_tail
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.training.optimizer import OptimizerConfig, make_optimizer
    from heal_swin_torch.training.trainer import step_generator, train_step

    label = f"embed-{WIDE_EMBED} train"
    task_k = build_task("auto", dev, embed=WIDE_EMBED, heads=WIDE_HEADS)
    task_p = build_task("xla", dev, state=task_k.model.state_dict(), embed=WIDE_EMBED,
                        heads=WIDE_HEADS)
    imgs, targets = train_batch(dev)
    loss0_p, feats = check_train_blocks(label, task_k, task_p, imgs, targets, dev)
    y = task_k._kernel_targets(task_k.model, targets)
    tail = (feats,) + decoder_tail(task_k.model) + (y, task_k.class_weights[y.long()])
    check_loss_kernels(f"{label} tail", tail, 4, fh, timing=False)
    times = time_width_path(label, tuple(t.detach() for t in tail), 4, fh, ("loss", "loss_bwd"))
    del feats, tail
    opt_cfg = OptimizerConfig(learning_rate=LEARNING_RATE)
    opts = [make_optimizer(t.model.parameters(), opt_cfg) for t in (task_k, task_p)]
    mstates = [t.metric_init() for t in (task_k, task_p)]
    reset_counters()
    loss_k0, mstates[0] = train_step(task_k, opts[0], mstates[0], imgs, targets,
                                     step_generator(SEED, 0, dev))
    torch.cuda.synchronize()
    launches, by_shape = read_counters()
    routes = read_routes()
    log(f"{label} step: kernel launches: {launches}")
    log(f"{label} step: by shape: {dict(sorted(by_shape.items(), key=str))}")
    log(f"{label} step: tail launches by route: {routes}")
    if routes != {("final_head_loss", "row core"): 1, ("final_head_loss_bwd", "row core"): 1}:
        raise AssertionError(f"{label}: the tail ran on {routes}, not K6 and K7 on the row core")
    T = imgs.shape[0] * imgs.shape[1] // TAIL_P
    fwd = launches["window_attention_qkv_epi"] + launches["window_attention"]
    bwd = launches["window_attention_qkv_epi_bwd"] + launches["window_attention_bwd"]
    rest = {k: v for k, v in launches.items() if v and k not in (
        "window_attention_qkv_epi", "window_attention", "window_attention_qkv_epi_bwd",
        "window_attention_bwd", "final_head_loss", "final_head_loss_bwd")}
    if (fwd, bwd) != (22, 22) or rest or by_shape[("final_head_loss", T, WIDE_EMBED)] != 1 \
            or by_shape[("final_head_loss_bwd", T, WIDE_EMBED)] != 1 \
            or launches["final_head_loss"] != 1 or launches["final_head_loss_bwd"] != 1:
        raise AssertionError(f"{label}: launches {launches}")
    loss_p0, _ = train_step(task_p, opts[1], mstates[1], imgs, targets,
                            step_generator(SEED, 0, dev))
    loss_k0, loss_p0 = float(loss_k0), float(loss_p0)
    ips, mem, traj, _ = train_rate(task_k, opts[0], mstates[0], imgs, targets, 1, WIDE_STEPS)
    traj = [loss_k0] + traj
    log(f"{label}: first step's loss kernels {loss_k0:.6f} plain {loss_p0:.6f} (rel "
        f"{abs(loss_k0 - loss_p0) / abs(loss_p0):.2e}); plain path before any step "
        f"{loss0_p:.6f}; loss over {len(traj)} steps (kernels): "
        + " ".join(f"{v:.6f}" for v in traj) + f"; {ips:.3f} img/s, peak {mem:.3f} GiB above "
        "the resident")
    if not (all(math.isfinite(v) for v in traj) and traj[-1] < traj[0]):
        raise AssertionError(f"{label}: the loss did not fall: {traj}")
    timed[f"{label} step"] = dict(ips=ips, mem_gib=mem)
    return (launches, by_shape), times


def drive_tail_widths(dev, timed):
    """The decoder tail at every width the Pallas tails take.  First the row cores' domain
    (``log_row_core_domain``), then each of the ten
    kernels (K3, K6-K9, bf16 and f32) against its plain version on the card at the width
    checks' shapes (``WIDTH_CASES``, ``WIDTH_DEPTH_CASES``, T = WIDTH_T, each on the route
    that takes it), one call of each timed beside its plain version.  Then the two paths:
    (a) the paper f32 HEAL-SWIN (``paper_swin_hp_config``, its dropouts) on SynWoodScape's
    own 25 classes with seeded positive class weights: its tail timed (``time_width_path``),
    held to its plain version (``check_loss_kernels``), two train steps through
    ``paper_step`` against the plain path (equal masks, loss 1e-5, gradients 1e-4, one f32
    K6 and one f32 K7 at (T, 96), both on the row core with the head in chunks, nothing
    else) and one ``paper_predict`` (the f32 K3, classes outside near-ties); (b)
    ``drive_wide_train``.  Returns (the grid's results by kernel, path (a)'s step
    launches, its predict's, path (b)'s step launches, the paths' tail timings)."""
    from heal_swin_torch.ops import final_head as fh

    check_wide_smem(fh)
    log_row_core_domain(fh)
    gen = torch.Generator().manual_seed(SEED + 28)
    grid = {}
    for dtype in (torch.bfloat16, torch.float32):
        who = "f32" if dtype == torch.float32 else "bf16"
        for C, F, p in WIDTH_CASES:
            largs = width_inputs(gen, dev, WIDTH_T, C, F, p, dtype)
            grid.update(check_width_tail(f"widths {who}", largs, p, fh))
        for C, kind, F, p in WIDTH_DEPTH_CASES:
            x, we, g, b, wh, _, _ = width_inputs(gen, dev, WIDTH_T, C, F, p, dtype)
            dargs = (x, we, g, b, wh, depth_targets(gen, WIDTH_T, p, dev, mean=1.0))
            grid.update(check_width_depth(f"widths {who} depth", dargs, p, kind, fh))
        torch.cuda.empty_cache()
    by_kernel = collections.defaultdict(list)
    for key, r in sorted(grid.items(), key=str):
        fields = dict(zip(("T", "C", "F", "p", "kind"), key[1:]))
        by_kernel[key[0]].append(dict(fields, **r))
    log("tail widths checks: " + json.dumps(by_kernel))

    # (a) the paper f32 config on SynWoodScape's 25 classes
    largs = width_inputs(torch.Generator().manual_seed(SEED + 29), dev,
                         BATCH * 8 * NSIDE * NSIDE // TAIL_P, 96, SYN_CLASSES, TAIL_P,
                         torch.float32)
    check_loss_kernels("(a) f32 25 classes tail", largs, TAIL_P, fh, timing=False)
    times = time_width_path("(a) f32 25 classes tail", largs, TAIL_P, fh,
                            ("predict", "loss", "loss_bwd"))
    del largs
    torch.cuda.empty_cache()
    weights = (0.5 + torch.rand(SYN_CLASSES, generator=torch.Generator().manual_seed(SEED + 30)))
    kw = dict(classes=SYN_CLASSES, class_weights=weights.tolist())
    task_k = paper_task("auto", dev, **kw)
    task_p = paper_task("xla", dev, state=task_k.model.state_dict(), **kw)
    imgs, _ = train_batch(dev)
    targets = torch.clamp(((imgs[..., 0] + 2.5) * SYN_CLASSES / 5).long(), 0,
                          SYN_CLASSES - 1).to(torch.int32)
    routes_a = {}
    run_a = paper_step("(a) paper train 25 classes", task_k, task_p, imgs, targets,
                       dict(NO_LAUNCHES, final_head_loss_f32=1, final_head_loss_bwd_f32=1),
                       timed, ("total", targets.numel()), steps=1, routes=routes_a)
    log(f"(a) paper train 25 classes step: tail launches by route: {routes_a}")
    if routes_a != {("final_head_loss_f32", "row core"): 1,
                    ("final_head_loss_bwd_f32", "row core"): 1}:
        raise AssertionError(f"(a): the tail ran on {routes_a}, not the f32 K6 and K7 on the "
                             "row core")
    task_p.model.load_state_dict(task_k.model.state_dict())
    for t in (task_k, task_p):
        t.model.zero_grad(set_to_none=True)
    pred_a = paper_predict("(a) paper 25 classes", task_k, task_p, imgs, timed, False)
    del task_k, task_p
    torch.cuda.empty_cache()
    # (b) the bf16 model at embed 128
    run_b, times_b = drive_wide_train(dev, timed)
    times.update(times_b)
    torch.cuda.empty_cache()
    return by_kernel, run_a, pred_a, run_b, times


def width_results(by_kernel, run_a, pred_a, run_b, times):
    """The results line's rows of the new tail shapes on the paths: "widths <kernel>" for
    the f32 K3, K6 and K7 at path (a)'s tail and the bf16 K6 and K7 at path (b)'s, each
    with its launches in that path's counted step or predict, one call's times there
    (``time_width_path``), and the largest error of its width checks (``by_kernel``)."""
    rows = []
    for name, run in (("final_head_predict_f32", pred_a), ("final_head_loss_f32", run_a),
                      ("final_head_loss_bwd_f32", run_a), ("final_head_loss", run_b),
                      ("final_head_loss_bwd", run_b)):
        launches, _ = run
        t = times[name]
        src = ("heal_swin_torch/csrc/final_head_wide.cu" if t["route"] == "wide"
               else "heal_swin_torch/csrc/final_head_f32_chunked.cu"
               if name.endswith("_f32") and t["F"] > 16 else SOURCES[name][0])
        rows.append(dict(
            name=f"widths {name}", route="cuda", source=src, replaces=SOURCES[name][1],
            launches=launches[name], max_abs_err=max(r["max_abs_err"] for r in by_kernel[name]),
            ms=t["ms"] * launches[name], plain_ms=t["plain_ms"] * launches[name],
            bound_ms=t["bound_ms"] * launches[name], bound_by=t["bound_by"], library_ms=None,
            route_ms=t["route_ms"] * launches[name], device_ms=t["device_ms"] * launches[name],
            shape=dict(T=t["T"], C=t["C"], F=t["F"], p=t["p"], route=t["route"])))
    return rows


GATE_NSIDE = 32  # 512 tokens an image at the second stage: one 64-token window per base pixel


def refuse_f32_tails(dev):
    """The f32 tails the kernels do not take, on CUDA tensors: the f32 K3, K8 and K9 on
    a tail of C 200 (the kernels take C % 8 up to 192; the JAX gate has no bound on C)
    raise under "auto" and "pallas" before any launch, naming the kernel and impl="xla";
    under "xla" they run their plain versions with no launch."""
    from heal_swin_torch.ops import final_head as fh

    rnd, _ = seeded_draws(torch.Generator().manual_seed(SEED + 19), dev)
    T, p, C = 64 * 8, TAIL_P, 200
    pred = (rnd(T, C), rnd(C, p * C, std=0.1), 1.0 + rnd(C, std=0.1), rnd(C, std=0.1),
            rnd(C, PAPER_CLASSES, std=0.3))
    wide = (rnd(T, C), rnd(C, p * C, std=0.1), 1.0 + rnd(C, std=0.1), rnd(C, std=0.1),
            rnd(C, 1, std=0.1), depth_targets(torch.Generator().manual_seed(SEED), T, p, dev))
    one = torch.ones((), device=dev)
    kw = dict(patch_size=p, loss_kind="l2")
    cases = (("K3", lambda impl: fh.final_head_predict(*pred, patch_size=p, impl=impl)),
             ("K8", lambda impl: fh.final_head_depth_loss_sums(*wide, **kw, impl=impl)),
             ("K9", lambda impl: fh.final_head_depth_loss_bwd(*wide, one, **kw, impl=impl)))
    reset_counters()
    for who, call in cases:
        for impl in ("auto", "pallas"):
            try:
                call(impl)
            except ValueError as e:
                if f"({who})" not in str(e) or "impl='xla'" not in str(e):
                    raise
            else:
                raise AssertionError(f"refusal f32 {who} {impl}: no refusal")
        out = call("xla")
        out = out if isinstance(out, tuple) else (out,)
        if not all(torch.isfinite(o.float()).all() for o in out):
            raise AssertionError(f"refusal f32 {who} xla: a non-finite result")
    torch.cuda.synchronize()
    launches, _ = read_counters()
    if any(launches.values()):
        raise AssertionError(f"refusal f32 tails: kernels launched: {launches}")
    log("refusal f32 tails: the f32 K3 and K8/K9 at C 200 raised under \"auto\" and "
        "\"pallas\" with no launch, naming the kernel and impl='xla'; \"xla\" ran their "
        "plain versions with no launch")


def refusal_model(dev, impl, dtype=None, ws=WS, classes=N_CLASSES, cos=False):
    """The refusal phase's small segmentation model at nside GATE_NSIDE: patch 4, embed 64,
    depths [2, 2], heads [2, 4], ring_shift, v2 norm placement, no dropout (DropPath 0.1,
    the config default), the fused tail; seeded weights."""
    from heal_swin_torch.models import tasks as T
    from heal_swin_torch.models.swin_hp import DataSpec, SwinHPTransformerConfig

    cfg = SwinHPTransformerConfig(
        patch_size=4, window_size=ws, shift_size=4 if ws == WS else 8,
        shift_strategy="ring_shift", rel_pos_bias="flat", embed_dim=64, depths=[2, 2],
        num_heads=[2, 4], use_cos_attn=cos, use_v2_norm_placement=True, dtype=dtype,
        gelu_approx=True, fused_final_head=True, attention_impl=impl)
    return T.WoodscapeSegmenterSwinHP(
        T.WoodscapeSegmenterSwinHPConfig(cfg),
        DataSpec(dim_in=8 * GATE_NSIDE * GATE_NSIDE, f_in=3, f_out=classes, base_pix=8),
        device=dev, generator=torch.Generator().manual_seed(SEED))


def f32_small_model_through_kernels(dev, imgs, cos):
    """An f32 small model (``refusal_model``, ws 64) that the f32 window-attention kernels
    take: scaled-dot attention (the config default) and, with ``cos``, cosine attention.
    Its train-mode loss and backward and its predict run under "auto" and under "xla" on
    the same weights and generators: the loss within PAPER_LOSS_TOL, every gradient within
    PAPER_GRAD_TOL, the predictions equal on all but HEADLINE_PLAIN_PIXELS of the pixels,
    all finite; "auto" launches, per pass, one f32 K16 (scaled-dot, backward K17) or K1
    (cosine, backward K4) for every attention block (all at C <= 384) and the f32 tail
    (K6 / K7 in the step, K3 in predict), "xla" nothing."""
    from heal_swin_torch.models.layers import WindowAttention

    label = f"refusal phase: f32 {'cosine' if cos else 'scaled-dot'} ws=64 model"
    targets = torch.clamp(((imgs[..., 0] + 2.5) * 2).long(), 0, N_CLASSES - 1)
    out = {}
    for impl in ("auto", "xla"):
        task = refusal_model(dev, impl, cos=cos)
        n_blocks = sum(isinstance(m, WindowAttention) for m in task.model.modules())
        reset_counters()
        loss = task.loss_fn(imgs, targets, deterministic=False,
                            generator=torch.Generator(device=dev).manual_seed(SEED))[0]
        loss.backward()
        torch.cuda.synchronize()
        step, _ = read_counters()
        reset_counters()
        with torch.no_grad():
            preds = task.predict(None, imgs)
        torch.cuda.synchronize()
        pred, _ = read_counters()
        grads = {n: q.grad for n, q in task.model.named_parameters()}
        if not (torch.isfinite(loss) and all(g is not None and torch.isfinite(g).all()
                                             for g in grads.values())):
            raise AssertionError(f"{label} {impl}: a non-finite loss or gradient")
        out[impl] = (float(loss.detach()), grads, preds)
        fwd, bwd = (("window_attention_qkv_epi_f32", "window_attention_qkv_epi_bwd_f32") if cos
                    else ("window_attention_qkv_f32", "window_attention_qkv_bwd_f32"))
        want_step = dict(NO_LAUNCHES) if impl == "xla" else dict(
            NO_LAUNCHES, **{fwd: n_blocks, bwd: n_blocks, "final_head_loss_f32": 1,
                            "final_head_loss_bwd_f32": 1})
        want_pred = dict(NO_LAUNCHES) if impl == "xla" else dict(
            NO_LAUNCHES, **{fwd: n_blocks, "final_head_predict_f32": 1})
        if step != want_step or pred != want_pred:
            raise AssertionError(f"{label} {impl}: launches {step} / {pred}, expected "
                                 f"{want_step} / {want_pred}")
        del task
    (lk, gk, pk), (lp, gp, pp) = out["auto"], out["xla"]
    rel = abs(lk - lp) / abs(lp)
    if rel > PAPER_LOSS_TOL:
        raise AssertionError(f"{label}: loss {lk} vs plain {lp}")
    worst = max(check_close(f"{label} gradient {n}", gk[n], gp[n], PAPER_GRAD_TOL)[0]
                for n in gp)
    differ = int((pk != pp).sum())
    if differ > HEADLINE_PLAIN_PIXELS * pp.numel():
        raise AssertionError(f"{label}: {differ} of {pp.numel()} predictions differ")
    log(f"{label}: \"auto\" ran its loss, backward and predict through the f32 kernels "
        f"({n_blocks} attention blocks a pass), \"xla\" with no launch; loss {lk:.7f} vs "
        f"{lp:.7f} (rel {rel:.2e}, tol {PAPER_LOSS_TOL}), {len(gp)} gradients rel_l2 <= "
        f"{worst:.3e} (tol {PAPER_GRAD_TOL}), {differ} of {pp.numel()} predictions differ")


def drive_refusal(dev):
    """The kernels' refusal on the card, and the f32 models they now take.  First the
    f32 small models (``refusal_model`` at window 64, no dropout) that the f32 window-
    attention kernels run both ways: scaled-dot (the config default) and cosine in
    training, held to "xla" (``f32_small_model_through_kernels``).  Then what the kernels
    still refuse: a bf16 window-16 model with 40 classes (a head the tail kernels take
    since their wide route), whose first block's K16 refuses the window under "auto" and
    "pallas" in a loss and a predict before any launch, naming attention_impl="xla",
    which runs a loss with its backward and a predict with no launch, finite and of the
    expected shapes; the tail wrappers alone (``refuse_f32_tails``: an f32 tail at C 200,
    above the kernels' 192); and the MLP kernels on f16 tokens
    (``refuse_f16_fused_mlp``)."""
    npix = 8 * GATE_NSIDE * GATE_NSIDE
    imgs = torch.randn(BATCH, npix, 3, generator=torch.Generator().manual_seed(SEED + 9)).to(dev)
    for cos in (False, True):
        f32_small_model_through_kernels(dev, imgs, cos)
        torch.cuda.empty_cache()

    label = "refusal dtype=bfloat16 ws=16 classes=40"
    classes = 40
    targets = torch.clamp(((imgs[..., 0] + 2.5) * classes / 5).long(), 0, classes - 1)
    refusals = []
    reset_counters()
    for impl in ("auto", "pallas"):
        task = refusal_model(dev, impl, "bfloat16", 16, classes)
        for call in (lambda: task.loss_fn(imgs, targets), lambda: task.predict(None, imgs)):
            try:
                call()
            except ValueError as e:
                if "impl='xla'" not in str(e):
                    raise
                refusals.append(str(e))
            else:
                raise AssertionError(f"{label} {impl}: no refusal")
    task = refusal_model(dev, "xla", "bfloat16", 16, classes)
    loss, cm = task.loss_fn(imgs, targets)
    loss.backward()
    preds = task.predict(None, imgs)
    torch.cuda.synchronize()
    launches, _ = read_counters()
    if any(launches.values()):
        raise AssertionError(f"{label}: kernels launched: {launches}")
    grads = [q.grad for q in task.model.parameters()]
    if not (torch.isfinite(loss) and tuple(cm.shape) == (classes, classes)
            and tuple(preds.shape) == (BATCH, npix)
            and all(g is not None and torch.isfinite(g).all() for g in grads)):
        raise AssertionError(f"{label} xla: a non-finite or misshapen result")
    log(f"{label}: \"auto\" and \"pallas\" raised in a loss and a predict with no "
        f"launch ({refusals[0]}); \"xla\" ran a loss ({loss.item():.6f}), its "
        f"backward and {preds.numel()} predictions with no launch")
    refuse_f32_tails(dev)
    refuse_f16_fused_mlp(dev)


SOURCES = {
    "window_attention_qkv_epi": ("heal_swin_torch/csrc/window_attention.cu",
                                 "heal_swin_tpu/ops/window_attention.py:993"),
    "window_attention": ("heal_swin_torch/csrc/window_attention.cu",
                         "heal_swin_tpu/ops/window_attention.py:677"),
    "final_head_predict": ("heal_swin_torch/csrc/final_head.cu",
                           "heal_swin_tpu/ops/final_head.py:191"),
    "window_attention_qkv_epi_bwd": ("heal_swin_torch/csrc/window_attention_bwd.cu",
                                     "heal_swin_tpu/ops/window_attention.py:1027"),
    "window_attention_bwd": ("heal_swin_torch/csrc/window_attention_bwd.cu",
                             "heal_swin_tpu/ops/window_attention.py:719"),
    "window_attention_qkv": ("heal_swin_torch/csrc/window_attention.cu",
                             "heal_swin_tpu/ops/window_attention.py:548"),
    "window_attention_qkv_bwd": ("heal_swin_torch/csrc/window_attention_bwd.cu",
                                 "heal_swin_tpu/ops/window_attention.py:585"),
    "final_head_loss": ("heal_swin_torch/csrc/final_head.cu",
                        "heal_swin_tpu/ops/final_head.py:755"),
    "final_head_loss_bwd": ("heal_swin_torch/csrc/final_head.cu",
                            "heal_swin_tpu/ops/final_head.py:781"),
    "final_head_depth_loss": ("heal_swin_torch/csrc/final_head.cu",
                              "heal_swin_tpu/ops/final_head.py:568"),
    "final_head_depth_loss_bwd": ("heal_swin_torch/csrc/final_head.cu",
                                  "heal_swin_tpu/ops/final_head.py:593"),
    "chamfer_min_both": ("heal_swin_torch/csrc/chamfer.cu", "heal_swin_tpu/ops/chamfer.py:159"),
    "chamfer_fold_pairs": ("heal_swin_torch/csrc/chamfer.cu",
                           "heal_swin_tpu/ops/chamfer_pruned.py:212"),
    "mlp_fwd": ("heal_swin_torch/csrc/mlp.cu", "heal_swin_tpu/ops/mlp.py:169"),
    "mlp_bwd": ("heal_swin_torch/csrc/mlp.cu", "heal_swin_tpu/ops/mlp.py:129"),
    "mlp_block_fwd": ("heal_swin_torch/csrc/mlp.cu", "heal_swin_tpu/ops/mlp.py:440"),
    "mlp_block_bwd": ("heal_swin_torch/csrc/mlp.cu", "heal_swin_tpu/ops/mlp.py:467"),
    "mlp_fwd_f32": ("heal_swin_torch/csrc/mlp_f32.cu", "heal_swin_tpu/ops/mlp.py:169"),
    "mlp_bwd_f32": ("heal_swin_torch/csrc/mlp_f32.cu", "heal_swin_tpu/ops/mlp.py:129"),
    "mlp_block_fwd_f32": ("heal_swin_torch/csrc/mlp_f32.cu", "heal_swin_tpu/ops/mlp.py:440"),
    "mlp_block_bwd_f32": ("heal_swin_torch/csrc/mlp_f32.cu", "heal_swin_tpu/ops/mlp.py:467"),
    "final_head_loss_f32": ("heal_swin_torch/csrc/final_head_f32.cu",
                            "heal_swin_tpu/ops/final_head.py:755"),
    "final_head_loss_bwd_f32": ("heal_swin_torch/csrc/final_head_f32.cu",
                                "heal_swin_tpu/ops/final_head.py:781"),
    "final_head_depth_loss_f32": ("heal_swin_torch/csrc/final_head_depth_f32.cu",
                                  "heal_swin_tpu/ops/final_head.py:568"),
    "final_head_depth_loss_bwd_f32": ("heal_swin_torch/csrc/final_head_depth_f32.cu",
                                      "heal_swin_tpu/ops/final_head.py:593"),
    "window_attention_qkv_epi_f32": ("heal_swin_torch/csrc/window_attention_f32.cu",
                                     "heal_swin_tpu/ops/window_attention.py:993"),
    "window_attention_f32": ("heal_swin_torch/csrc/window_attention_f32.cu",
                             "heal_swin_tpu/ops/window_attention.py:677"),
    "final_head_predict_f32": ("heal_swin_torch/csrc/final_head_f32.cu",
                               "heal_swin_tpu/ops/final_head.py:191"),
    "window_attention_qkv_f32": ("heal_swin_torch/csrc/window_attention_f32.cu",
                                 "heal_swin_tpu/ops/window_attention.py:548"),
    "window_attention_qkv_bwd_f32": ("heal_swin_torch/csrc/window_attention_bwd_f32.cu",
                                     "heal_swin_tpu/ops/window_attention.py:585"),
    "window_attention_qkv_epi_bwd_f32": ("heal_swin_torch/csrc/window_attention_bwd_f32.cu",
                                         "heal_swin_tpu/ops/window_attention.py:1027"),
    "window_attention_bwd_f32": ("heal_swin_torch/csrc/window_attention_bwd_f32.cu",
                                 "heal_swin_tpu/ops/window_attention.py:719"),
}


def shape_work(key):
    """(FLOP of the tensor-core products, bytes) of one call of K1-K9 at a launch
    shape key, from the shapes: each input read once, each output written once.
    Window attention (ws 64, head dim 32, T / 64 windows of C / 32 heads; a 64 x 64 x
    32 product is 8192 C FLOP per window over the heads): forward 512 C^2 (qkv and
    proj) + 16384 C (scores and values) FLOP per window, 384 C^2 + 16384 C without
    proj (K16); the attention backward five products, 40960 C (the scores recomputed,
    dv, dp, dq, dk: K5), with proj 1536 C^2 + 49152 C (the values recomputed too, for
    dWp: K4), without proj 1152 C^2 + 40960 C (K17).  The tail (p = 4): the expand product 2 T p C^2 and the head
    2 T p C F forward; three times the expand and twice the head backward.  The MLP
    (T, C, H = 4C): two products of 2 T C H forward, five backward (the hidden
    recomputed, dg, dx, dW1, dW2), six for the branch (u recomputed too); bf16 tokens
    and weights (f32 for the "_f32" kernels), f32 biases, LayerNorm parameters,
    DropPath scale and parameter gradients."""
    name, T, C = key[:3]
    if name.startswith("mlp"):
        H = key[3]
        block = name.startswith("mlp_block")
        tb = 4 if name.endswith("_f32") else 2  # bytes of a token and a weight
        vecs = 4 * (H + C) + (8 * C if block else 0)  # biases [, gamma, beta]
        ds = 4 * T if block and key[5] else 0
        if "fwd" in name:
            return 4 * T * C * H, 2 * tb * T * C + 2 * tb * C * H + vecs + ds
        return ((12 if block else 10) * T * C * H,
                3 * tb * T * C + (2 * tb + 8) * C * H + 2 * vecs + ds)
    if name in F32_ATTN_EXTRA:
        # the f32 window attention: the bf16 forms' FLOPs, their tokens and weights at
        # 4 bytes (F32_ATTN_EXTRA)
        flop, nbytes = shape_work((name[:-4],) + tuple(key[1:]))
        tokens, weights = F32_ATTN_EXTRA[name]
        return flop, nbytes + tokens * T * C + weights * C * C
    if name in F32_KERNELS:
        return f32_tail_work(key)
    W, h, p = T // WS, C // 32, 4
    bias, groups = h * WS * WS * 4, T * 4
    if name == "window_attention_qkv_epi":  # x -> out; weights, LN, bias, groups
        return W * (512 * C * C + 16384 * C), 4 * T * C + 8 * C * C + bias + groups * key[3]
    if name == "window_attention":  # qkv -> out
        return W * 16384 * C, 8 * T * C + bias + groups * key[3]
    if name == "window_attention_qkv_epi_bwd":  # x, dz -> dx; weights -> their gradients
        return (W * (1536 * C * C + 49152 * C),
                6 * T * C + 24 * C * C + 2 * bias + groups * key[3])
    if name == "window_attention_bwd":  # qkv, dout -> dqkv
        return W * 40960 * C, 14 * T * C + 2 * bias + groups * key[3]
    if name == "window_attention_qkv":  # x -> out; Wqkv, bias, groups
        return W * (384 * C * C + 16384 * C), 4 * T * C + 6 * C * C + bias + groups * key[3]
    if name == "window_attention_qkv_bwd":  # x, dout -> dx; Wqkv -> its f32 gradient
        return (W * (1152 * C * C + 40960 * C),
                6 * T * C + 18 * C * C + 2 * bias + groups * key[3])
    F = key[3] if len(key) == 5 else N_CLASSES
    tail = 2 * T * p * C * C + 2 * T * p * C * F
    weights = (p * C * C + C * F + 2 * C) * 4
    if name == "final_head_predict":  # x -> (T, p) int32
        return tail, 2 * T * C + 4 * T * p + weights
    if name == "final_head_loss":  # x, y, weights -> loss sums, confusion matrix
        return tail, 2 * T * C + 8 * T * p + weights
    if name == "final_head_depth_loss":  # x, targets -> loss sums, bf16 predictions
        return tail, 2 * T * C + 4 * T * p + 2 * T * p * F + weights
    if name in ("final_head_loss_bwd", "final_head_depth_loss_bwd"):  # + dx, dW
        targets = 8 * T * p if name == "final_head_loss_bwd" else 4 * T * p
        return 6 * T * p * C * C + 4 * T * p * C * F, 4 * T * C + targets + 2 * weights
    raise KeyError(key)


QKV_BWD_RUN = 8  # windows one K17 block walks (kRun, csrc/window_attention_bwd.cu)


def qkv_bwd_workspace(T, C, run=QKV_BWD_RUN):
    """K17's workspace traffic per launch in bytes, (dqkv, partial rows): the rounded
    dqkv (T x 3C bf16) written once and read twice (gemm_tn's dWqkv, gemm_nt's dx);
    one partial row per run of ``run`` windows, H (64 x 64 + 1) + 3C f32 (dbias, dls,
    dbqkv), written once and read once by reduce_rows.  ``run=1``: one row per window."""
    rows = -(-(T // WS) // run)
    return 3 * T * 3 * C * 2, 2 * rows * ((C // 32) * (WS * WS + 1) + 3 * C) * 4


def workspace_bytes(key):
    """The bytes a backward kernel's design adds to what the function must move: for
    K13 its weight-gradient kernel's partial rows (one set of dW1, dW2, db1 | db2 per
    token split, f32), written once and read once by reduce_rows; for K15 its workspace
    (the rounded du, bf16 T x C, its row kernel's partial rows of db2 | dgamma | dbeta,
    its weight-gradient kernel's as K13's, and the reductions' scratch), written once and
    read once; for K17 its dqkv and partial rows
    (``qkv_bwd_workspace``).  Logged beside the checks; ``bound_ms`` leaves them out,
    since the function itself need not move them."""
    name, T, C = key[:3]
    if name == "mlp_bwd":
        from heal_swin_torch import _build

        H = key[3]
        return 2 * _build.lib().hs_mlp_bwd_splits(T, C, H) * (2 * C * H + H + C) * 4
    if name == "mlp_block_bwd":
        from heal_swin_torch import _build

        return 2 * _build.lib().hs_mlp_block_bwd_workspace(T, C, key[3])
    if name == "window_attention_qkv_bwd":
        return sum(qkv_bwd_workspace(T, C))
    return 0


def shape_fields(key):
    """The named fields of a launch shape key."""
    name = key[0]
    if name.startswith("mlp"):
        shape = dict(T=key[1], C=key[2], H=key[3], approximate=key[4])
        if len(key) == 6:
            shape["dscale"] = key[5]
        return shape
    shape = dict(T=key[1], C=key[2])
    if len(key) == 4:
        shape["mask"] = key[3]
    elif len(key) == 5:
        shape.update(F=key[3], kind=key[4])
    return shape


def kernel_results(timed, runs, chamfer, flat_runs=(), flat_chamfer=None):
    """The per-kernel results line.  ``runs``: kernel -> (launches per kernel, per
    shape) of the run that uses it.  K1-K9 and K12-K15: each kernel's launches in that
    run, and its times and bound summed over the shapes that run launched it at, each
    shape weighted by its launches there; ``library_ms`` where one PyTorch call computes
    the function (K2/K5: scaled_dot_product_attention), else null.  K12-K17 add
    ``route_ms``, the port's composed cuBLAS / ATen route (K12-K15) or the composed
    PyTorch route (K16/K17) for the same function.  K10 / K11: ``chamfer``, from
    ``drive_chamfer_eval``.  ``flat_runs``: kernel -> the flat SWIN-UNet's run that uses
    it, an entry "flat <kernel>" each, its K10 / K11 times ``flat_chamfer``."""
    kernels = []
    rows = [(name, name, runs[name], chamfer) for name in SOURCES] + [
        (f"flat {name}", name, run, flat_chamfer or {}) for name, run in dict(flat_runs).items()]
    for label, name, (launches, by_shape), chamfer in rows:
        source, replaces = SOURCES[name]
        entry = dict(name=label, route="cuda", source=source, replaces=replaces,
                     launches=launches[name])
        if name in chamfer:
            shapes = [dict(shape=list(key[1:]), launches=n) for key, n in
                      sorted(by_shape.items()) if key[0] == name]
            kernels.append(dict(entry, **chamfer[name], shapes=shapes))
            continue
        shapes, op_ms, byte_ms = [], 0.0, 0.0
        peak = F32_TC_PEAK if name in F32_KERNELS else BF16_PEAK
        for key, n in sorted(by_shape.items()):
            if key[0] == name:
                flop, nbytes = shape_work(key)
                b, by = bound(flop, nbytes, peak)
                op_ms += n * flop / peak * 1e3
                byte_ms += n * nbytes / HBM_RATE * 1e3
                shapes.append(dict(shape_fields(key), launches=n, bound_ms=b, bound_by=by,
                                   **timed[key]))
        def total(field):
            return sum(r[field] * r["launches"] for r in shapes)

        result = dict(
            entry, max_abs_err=max(r["max_abs_err"] for r in shapes), ms=total("ms"),
            plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="operations" if op_ms >= byte_ms else "bytes",
            library_ms=total("library_ms") if "library_ms" in shapes[0] else None)
        if "route_ms" in shapes[0]:
            result["route_ms"] = total("route_ms")
        if name in F32_KERNELS:
            result.update(device_ms=total("device_ms"), peak=F32_TC_PEAK_NAME)
        kernels.append(dict(result, shapes=shapes))
    return kernels


# the register-resident kernels' mangled names in the ptxas report
PTXAS_NAMES = {"11attn_kernel": "K2 attn_kernel",
               "14qkv_epi_kernelILi1ELb1ELb1E": "K1 qkv_epi_kernel<1> (C <= 192)",
               "14qkv_epi_kernelILi2ELb1ELb1E": "K1 qkv_epi_kernel<2> (C > 192)",
               "14qkv_epi_kernelILi1ELb0ELb1E":
                   "K16 qkv_epi_kernel<1, no epilogue, cosine> (K4 step 1)",
               "14qkv_epi_kernelILi1ELb0ELb0E": "K16 qkv_epi_kernel<1, no epilogue, scaled-dot>",
               "14qkv_bwd_kernelILb1ELb0E": "K17 qkv_bwd_kernel<cosine> (K4 step 4)",
               "14qkv_bwd_kernelILb0ELb0E": "K17 qkv_bwd_kernel<scaled-dot>",
               "14qkv_bwd_kernelILb1ELb1E": "K5 qkv_bwd_kernel<cosine, load qkv>",
               "14qkv_bwd_kernelILb0ELb1E": "K5 qkv_bwd_kernel<scaled-dot, load qkv>",
               "18proj_ln_bwd_kernelILi1E": "K4 step 2 proj_ln_bwd_kernel<1> (C <= 192)",
               "18proj_ln_bwd_kernelILi2E": "K4 step 2 proj_ln_bwd_kernel<2> (C > 192)",
               "14gemm_nt_kernel": "gemm_nt_kernel (K17 dx, K4 do)",
               "14mlp_fwd_kernelILi12ELNS0_3EpiE0E": "K12 mlp_fwd_kernel<12> (C <= 96)",
               "14mlp_fwd_kernelILi24ELNS0_3EpiE0E": "K12 mlp_fwd_kernel<24> (C > 96)",
               "14mlp_fwd_kernelILi12ELNS0_3EpiE1E":
                   "K14 mlp_fwd_kernel<12, LayerNorm forward> (C <= 96)",
               "14mlp_fwd_kernelILi24ELNS0_3EpiE1E":
                   "K14 mlp_fwd_kernel<24, LayerNorm forward> (C > 96)",
               "14mlp_fwd_kernelILi12ELNS0_3EpiE2E":
                   "K15 step 1 mlp_fwd_kernel<12, LayerNorm backward> (C <= 96)",
               "14mlp_fwd_kernelILi24ELNS0_3EpiE2E":
                   "K15 step 1 mlp_fwd_kernel<24, LayerNorm backward> (C > 96)",
               "13mlp_dx_kernelILi12ELb0E": "K13 step 1 mlp_dx_kernel<12> (C <= 96)",
               "13mlp_dx_kernelILi24ELb0E": "K13 step 1 mlp_dx_kernel<24> (C > 96)",
               "13mlp_dx_kernelILi12ELb1E": "K15 step 2 mlp_dx_kernel<12, residual> (C <= 96)",
               "13mlp_dx_kernelILi24ELb1E": "K15 step 2 mlp_dx_kernel<24, residual> (C > 96)",
               "13mlp_dw_kernelILi3ELi4E": "K13 step 2, K15 step 3 mlp_dw_kernel<3, 4> (C <= 96)",
               "13mlp_dw_kernelILi6ELi4E": "K13 step 2, K15 step 3 mlp_dw_kernel<6, 4> (C <= 192)",
               "13mlp_dw_kernelILi6ELi1E": "K13 step 2, K15 step 3 mlp_dw_kernel<6, 1> (C > 192)"}
# the tail row core's kernels: K3, K6, K7's row kernel, K8 and K9's row kernel at each C
# and head width
TAIL_KERNELS = {"tail_pred_kernel": ("K3", (2, 4)), "tail_loss_kernel": ("K6", (2, 4)),
                "tail_bwd_kernel": ("K7 step 1", (2, 4)),
                "tail_depth_kernel": ("K8", (2,)), "tail_depth_bwd_kernel": ("K9 step 1", (2,))}
PTXAS_NAMES.update({
    f"{len(k)}{k}ILi{nt}ELi{nf}E": f"{who} {k}<{nt}, {nf}> (C {8 * nt}, F <= {8 * nf})"
    for k, (who, nfs) in TAIL_KERNELS.items() for nt in (4, 8, 12, 16) for nf in nfs})
# the f32 tile kernels at each C and head width: K6 and K7's (and K3's, the epilogue
# Argmax) with heads of 8 and 16 columns, K8 and K9's with the depth head (4 columns)
PTXAS_NAMES.update({
    f"22{k}ILi{c}ELi{nf}ENS0_{len(loss)}{loss}E":
        f"{who} {k}<{c}, {nf}, {loss}> (C {c}, F <= {2 if nf == 4 else nf})"
    for k, whos in (("tail_fwd_3xtf32_kernel", ("f32 K6", "f32 K8", "f32 K3")),
                    ("tail_bwd_3xtf32_kernel", ("f32 K7 step 1", "f32 K9 step 1", None)))
    for c in (32, 64, 96, 128)
    for nf, loss, who in ((8, "CeLoss", whos[0]), (16, "CeLoss", whos[0]),
                          (4, "DepthLoss", whos[1]), (8, "Argmax", whos[2]),
                          (16, "Argmax", whos[2]))
    if who is not None})
# the f32 K1's and K2's kernels
PTXAS_NAMES.update({"18attn_3xtf32_kernel": "f32 K2 attn_3xtf32_kernel (f32 K1/K16 step 2)",
                    "18gemm_3xtf32_kernelILb0ELb0E":
                        "f32 K1 steps 1 and 3, K16 step 1, the K4 / K17 recomputes "
                        "gemm_3xtf32_kernel<NN>",
                    "18gemm_3xtf32_kernelILb0ELb1E":
                        "gemm_3xtf32_kernel<NT> (the f32 wide tail's dx)",
                    "18gemm_3xtf32_kernelILb1ELb0E":
                        "gemm_3xtf32_kernel<TN> (split-K; the f32 wide tail's dWe, dWh)",
                    "18ln_rows_f32_kernel": "f32 K1 step 4 ln_rows_f32_kernel",
                    "22attn_bwd_3xtf32_kernelILb1E": "f32 K5/K17 core attn_bwd_3xtf32_kernel<cosine>",
                    "22attn_bwd_3xtf32_kernelILb0E":
                        "f32 K5/K17 core attn_bwd_3xtf32_kernel<scaled-dot>",
                    "22ln_bwd_rows_f32_kernel": "f32 K4 step 2 ln_bwd_rows_f32_kernel"})
# the f32 K12-K15's kernels (csrc/mlp_f32.cu's translation unit): K12 / K14 on the
# mma.sync core; K13 / K15 on the wgmma core (csrc/gemm_3xtf32_wgmma.cuh); the header's
# other mma.sync products are compiled there too and launched by no MLP kernel
MLP_F32_PTXAS_NAMES = {
    "18gemm_3xtf32_kernelILb0ELb0ENS0_7EpiBiasE":
        "f32 K12 / K14 step 2 gemm_3xtf32_kernel<NN> (g W2 + b2)",
    "18gemm_3xtf32_kernelILb0ELb1ENS0_7EpiBiasE":
        "gemm_3xtf32_kernel<NT> (attention_f32.cuh's; no MLP launch)",
    "18gemm_3xtf32_kernelILb1ELb0ENS0_7EpiBiasE":
        "gemm_3xtf32_kernel<TN> (attention_f32.cuh's; no MLP launch)",
    "18gemm_3xtf32_kernelILb0ELb0ENS0_7EpiGeluILb1E":
        "f32 K12 / K14 step 1 gemm_3xtf32_kernel<NN, EpiGelu<tanh>>",
    "18gemm_3xtf32_kernelILb0ELb0ENS0_7EpiGeluILb0E":
        "f32 K12 / K14 step 1 gemm_3xtf32_kernel<NN, EpiGelu<erf>>"}
MLP_F32_PTXAS_NAMES.update({
    f"21mlp_ln_{d}_f32_kernelILi{p}E": f"f32 K{k} mlp_ln_{d}_f32_kernel<{p}> (C <= {32 * p})"
    for d, k in (("fwd", "14 step 3"), ("bwd", "15 step 3")) for p in (3, 6, 12, 24)})
WG_KERNEL = "21gemm_3xtf32_wg_kernelI"
MLP_F32_PTXAS_NAMES.update({
    WG_KERNEL + "Lb1ELb0ELb1ELb1ENS0_9WgEpiDualILb1E":
        "f32 K13 step 1 gemm_3xtf32_wg_kernel<dual, WgEpiDual<tanh>>",
    WG_KERNEL + "Lb1ELb0ELb1ELb1ENS0_9WgEpiDualILb0E":
        "f32 K13 step 1 gemm_3xtf32_wg_kernel<dual, WgEpiDual<erf>>",
    WG_KERNEL + "Lb1ELb1ELb1ELb0ENS0_10WgEpiStoreILb0E": "f32 K13 dx gemm_3xtf32_wg_kernel<NT>",
    WG_KERNEL + "Lb1ELb1ELb1ELb0ENS0_10WgEpiStoreILb1E":
        "f32 K15 dx gemm_3xtf32_wg_kernel<NT, residual>",
    WG_KERNEL + "Lb0ELb0ELb0ELb0ENS0_12WgEpiPartialE":
        "f32 K13 / K15 dW2, dW1 gemm_3xtf32_wg_kernel<TN pair, split-K>",
    WG_KERNEL + "Lb1ELb0ELb0ELb0ENS0_9WgEpiGeluILb1E":
        "f32 K15 step 1 gemm_3xtf32_wg_kernel<NN, WgEpiGelu<tanh>> (g, GELU'(h))",
    WG_KERNEL + "Lb1ELb0ELb0ELb0ENS0_9WgEpiGeluILb0E":
        "f32 K15 step 1 gemm_3xtf32_wg_kernel<NN, WgEpiGelu<erf>> (g, GELU'(h))",
    WG_KERNEL + "Lb1ELb0ELb0ELb0ENS0_10WgEpiStoreILb0E":
        "f32 K15 step 2 gemm_3xtf32_wg_kernel<NN> (u = g W2 + b2)",
    WG_KERNEL + "Lb1ELb1ELb1ELb0ENS0_7WgEpiDhE": "f32 K15 dh gemm_3xtf32_wg_kernel<NT, WgEpiDh>"})
# the f32 K4's and K17's own products on the wgmma core (csrc/window_attention_bwd_f32.cu)
PTXAS_NAMES.update({
    WG_KERNEL + "Lb1ELb1ELb1ELb0ENS0_10WgEpiStoreILb0E":
        "f32 K4 / K17 dx, do gemm_3xtf32_wg_kernel<NT>",
    WG_KERNEL + "Lb0ELb0ELb0ELb0ENS0_12WgEpiPartialE":
        "f32 K4 / K17 dWp, dWqkv gemm_3xtf32_wg_kernel<TN, split-K>"})


def log_ptxas(build_log: str):
    """nvcc's -Xptxas -v report of the build, one line per kernel: its spills, stack,
    registers and shared memory, under its name (the window-attention and MLP kernels and
    gemm_nt by name, the others mangled).  Fails where an instantiation of the wgmma core
    (gemm_3xtf32_wg_kernel) spills."""
    name, props, spilled = None, [], []
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            names = MLP_F32_PTXAS_NAMES if "_mlp_f32_cu_" in name else PTXAS_NAMES
            key = max((k for k in names if k in name), key=len, default=None)
            name = name if key is None else names[key]
            props = []
        elif name and ("spill" in line or "registers" in line):
            props.append(line.split(":", 1)[-1].strip())
            if "registers" in line:
                log(f"ptxas {name}: " + "; ".join(props))
                if "gemm_3xtf32_wg_kernel" in name and any(
                        re.search(r"\b[1-9][0-9]* bytes spill", p) for p in props):
                    spilled.append(name)
                name = None
    if spilled:
        raise AssertionError(f"the wgmma core spills in {spilled}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    log(nvidia_smi())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from heal_swin_torch import _build

    t0 = time.perf_counter()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds} s)")
    log_ptxas(_build.build_log)

    timed = check_kernels(torch.Generator().manual_seed(SEED), dev)
    check_proj_ln(torch.Generator().manual_seed(SEED + 1), dev)
    check_probes(torch.Generator().manual_seed(SEED + 2), dev)
    torch.cuda.empty_cache()
    predict_run = drive_slice(dev, timed)
    torch.cuda.empty_cache()
    train_run = drive_train(dev, timed)
    log_k4_sequence(timed, train_run)
    log_tail_sequence(timed, train_run)
    torch.cuda.empty_cache()
    depth_run = drive_train(dev, timed, depth=True)
    log_depth_sequence(timed, depth_run)
    torch.cuda.empty_cache()
    t_chamfer = time.perf_counter()
    *chamfer_run, chamfer = drive_chamfer_eval(dev, timed)
    torch.cuda.empty_cache()
    t_mlp = time.perf_counter()
    mlp_run = drive_mlp(dev, timed)
    log_mlp_sequences(timed, mlp_run)
    torch.cuda.empty_cache()
    t_dot = time.perf_counter()
    drive_slice(dev, timed, cos=False)
    torch.cuda.empty_cache()
    dot_run = drive_train(dev, timed, cos=False)
    torch.cuda.empty_cache()
    t_flat = time.perf_counter()
    flat_predict_run, flat_train_run = drive_flat(dev, timed)
    torch.cuda.empty_cache()
    t_paper = time.perf_counter()
    paper_run = drive_paper_train(dev, timed)
    torch.cuda.empty_cache()
    t_depth = time.perf_counter()
    paper_depth_run = drive_paper_depth_train(dev, timed)
    torch.cuda.empty_cache()
    t_eval = time.perf_counter()
    paper_eval_run = drive_paper_eval(dev, timed)
    torch.cuda.empty_cache()
    t_f32_train = time.perf_counter()
    f32_train_runs = drive_f32_attention_train(dev, timed)
    torch.cuda.empty_cache()
    t_f32_mlp = time.perf_counter()
    f32_mlp_blocks_run, f32_mlp_step_run = drive_f32_mlp(dev, timed)
    torch.cuda.empty_cache()
    t_widths = time.perf_counter()
    widths = drive_tail_widths(dev, timed)
    torch.cuda.empty_cache()
    t_fit = time.perf_counter()
    drive_fit(dev, timed)
    torch.cuda.empty_cache()
    t_flat_paper = time.perf_counter()
    flat_paper_run, flat_paper_predict_run = drive_flat_paper(dev, timed)
    torch.cuda.empty_cache()
    t_entry = time.perf_counter()
    with entry_world() as root:
        entry = drive_run_entry(dev, timed, root)
        torch.cuda.empty_cache()
        t_evaluate = time.perf_counter()
        drive_evaluate(dev, timed, root, entry)
        torch.cuda.empty_cache()
        t_flat_entry = time.perf_counter()
        flat_chamfer_run, flat_chamfer = drive_flat_entry(dev, timed, root)
    torch.cuda.empty_cache()
    t_gate = time.perf_counter()
    drive_refusal(dev)
    t_end = time.perf_counter()
    log(f"elapsed: {t_end - t0:.1f} s since the build started, the Chamfer phase "
        f"{t_mlp - t_chamfer:.1f} s of it, the MLP phase {t_dot - t_mlp:.1f} s, the "
        f"scaled-dot phase {t_flat - t_dot:.1f} s, the flat bf16 phase "
        f"{t_paper - t_flat:.1f} s, the paper-config phase "
        f"{t_depth - t_paper:.1f} s, the paper depth phase {t_eval - t_depth:.1f} s, the "
        f"paper eval phase {t_f32_train - t_eval:.1f} s, the f32 attention training phase "
        f"{t_f32_mlp - t_f32_train:.1f} s, the f32 MLP phase {t_widths - t_f32_mlp:.1f} s, "
        f"the tail widths phase {t_fit - t_widths:.1f} s, "
        f"the fit phase {t_flat_paper - t_fit:.1f} s, "
        f"the flat paper phase {t_entry - t_flat_paper:.1f} s, "
        f"the run-entry phase {t_evaluate - t_entry:.1f} s, the evaluation phase "
        f"{t_flat_entry - t_evaluate:.1f} s, the flat entry phase "
        f"{t_gate - t_flat_entry:.1f} s, "
        f"the refusal phase {t_end - t_gate:.1f} s")

    blocked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "heal_swin_tpu"))
    if blocked:
        raise AssertionError(f"the port imported the JAX package or jax: {blocked[:5]}")
    runs = {name: train_run for name in SOURCES}
    runs["final_head_predict"] = predict_run
    runs["final_head_depth_loss"] = runs["final_head_depth_loss_bwd"] = depth_run
    runs["chamfer_min_both"] = runs["chamfer_fold_pairs"] = chamfer_run
    for name in ("mlp_fwd", "mlp_bwd", "mlp_block_fwd", "mlp_block_bwd"):
        runs[name] = mlp_run
    for name in ("window_attention", "window_attention_bwd", "window_attention_qkv",
                 "window_attention_qkv_bwd"):
        runs[name] = dot_run
    for name in F32_KERNELS:
        runs[name] = paper_depth_run if "depth" in name else paper_run
    for name in ("window_attention_qkv_epi_f32", "window_attention_f32",
                 "final_head_predict_f32"):
        runs[name] = paper_eval_run
    for name in ("window_attention_qkv_f32", "window_attention_qkv_bwd_f32",
                 "window_attention_bwd_f32"):
        runs[name] = f32_train_runs["a"]
    runs["window_attention_qkv_epi_bwd_f32"] = f32_train_runs["b"]
    for name in F32_MLP_KERNELS:
        runs[name] = f32_mlp_blocks_run
    runs["mlp_bwd_f32"] = f32_mlp_step_run
    flat_runs = {name: flat_train_run for name in (
        "window_attention_qkv_epi", "window_attention", "window_attention_qkv_epi_bwd",
        "window_attention_bwd", "final_head_loss", "final_head_loss_bwd")}
    flat_runs["final_head_predict"] = flat_predict_run
    flat_runs["final_head_loss_f32"] = flat_runs["final_head_loss_bwd_f32"] = flat_paper_run
    for name in ("window_attention_qkv_epi_f32", "window_attention_f32",
                 "final_head_predict_f32"):
        flat_runs[name] = flat_paper_predict_run
    flat_runs["chamfer_min_both"] = flat_runs["chamfer_fold_pairs"] = flat_chamfer_run
    kernels = kernel_results(timed, runs, chamfer, flat_runs, flat_chamfer)
    for row in kernels:  # the ten tail kernels' width checks beside their paper rows
        if row["name"] in widths[0]:
            row["widths"] = widths[0][row["name"]]
    kernels += width_results(*widths)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--entry-child"]:
        sys.exit(entry_child(sys.argv[2], sys.argv[4:]))
    sys.exit(main())
