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
writer through the predict loop (``training.trainer.predict``); then ``Trainer.fit`` of
both paper configs on the port's synthetic HEALPix datamodule (``drive_fit``: two
uninterrupted 2-epoch runs, and a 1-epoch run resumed from its checkpoint and held to
them, with their launches, tracked metrics and checkpoint files); and last the kernels'
refusal: small models the kernels do not take (scaled-dot float32 without dropout,
window 16, float32 cosine in training), and an f32 tail at C 48, raise under "auto"
with no launch, and run the plain versions under "xla".

    python3 chip_smoke.py            # needs one CUDA GPU; exits non-zero otherwise

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
K1, K2 and K3, whose ``bound_ms`` takes the 3xTF32 rate, a third of the TF32 peak, and
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
import json
import math
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


def stage_inputs(rnd, logit_scales, stage, dev):
    """K1's and K4's operands at one stage of the blocks at C <= 384 (encoder stages
    0-2, decoder stages 1-3): T, C, heads and (x, Wqkv, bqkv, Wp, bp, LN scale, LN bias,
    rel-pos bias, logit scales, mask groups)."""
    bf16 = torch.bfloat16
    C = 96 * 2 ** stage
    h = C // 32
    T = BATCH * 8 * NSIDE * NSIDE // 4 // 4 ** stage
    x = rnd(T, C).to(bf16)
    wq, bq = rnd(C, 3 * C, std=C ** -0.5).to(bf16), rnd(3 * C, std=0.02).to(bf16)
    wp, bp = rnd(C, C, std=C ** -0.5).to(bf16), rnd(C, std=0.02).to(bf16)
    g, b = 1.0 + rnd(C, std=0.1), rnd(C, std=0.1)
    bias = rnd(h, WS, WS, std=0.5)
    ls = logit_scales(h)
    return T, C, h, (x, wq, bq, wp, bp, g, b, bias, ls, ring_groups(T // BATCH).to(dev))


def bottleneck_inputs(rnd, logit_scales, dev):
    """K2's and K5's operands at the C = 768 bottleneck blocks: T, C, heads and (qkv,
    rel-pos bias, logit scales, mask groups, output gradient)."""
    bf16 = torch.bfloat16
    C, h = 768, 24
    T = BATCH * 8 * NSIDE * NSIDE // 4 // 4 ** 3
    qkv = rnd(T, 3 * C).to(bf16)
    bias = rnd(h, WS, WS, std=0.5)
    ls = logit_scales(h)
    groups = ring_groups(T // BATCH).to(dev)
    return T, C, h, (qkv, bias, ls, groups, rnd(T, C).to(bf16))


def check_kernels(gen, dev):
    """Each kernel against its plain version at the main paths' shapes.  Returns the
    measures of each shape, keyed as the wrappers' ``launches_by_shape`` counters are:
    (kernel, T, C, has_mask) for the attention kernels, (kernel, T, C) for K3, K6, K7,
    (kernel, T, C, F, loss kind) for K8, K9."""
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.ops import window_attention as wa

    bf16 = torch.bfloat16
    timed = {}
    rnd, logit_scales = seeded_draws(gen, dev)

    # K1: every block at C <= 384 (encoder stages 0-2, decoder stages 1-3)
    for stage in range(3):
        T, C, h, (x, wq, bq, wp, bp, g, b, bias, ls, groups) = stage_inputs(
            rnd, logit_scales, stage, dev)
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
    T, C, h, (qkv, bias, ls, groups, dout) = bottleneck_inputs(rnd, logit_scales, dev)
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
    timed.update(check_qkv_kernels(gen, dev, rnd, logit_scales))

    # K3: the decoder tail, T = 262144 tokens, p = 4, F = 10
    largs = tail_inputs(rnd, gen, dev)
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
    timed.update(check_loss_kernels("K6/K7", largs, p, fh))

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


def tail_inputs(rnd, gen, dev):
    """The paper tail's operands (T = 262,144 tokens of batch 2 at nside 256, C 96, p 4,
    F 10): (x, we, gamma, beta, wh, y, welem), x bf16, per-element weights of random
    class weights."""
    C, p, F = 96, TAIL_P, N_CLASSES
    T = BATCH * 8 * NSIDE * NSIDE // p
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
    device time by kernel and the f32 route."""
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
    if not timing:
        return {}
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
    """K6 (loss, confusion matrix) and K7 (every gradient, for a loss gradient of 1)
    against their plain versions on the operands ``largs`` = (x, we, gamma, beta, wh,
    y, welem).  K6's loss within LOSS_REL_TOL relative; its confusion matrix checked
    with ``confmat_agrees`` at K3's slack (every z element one bf16 step off) plus two
    bf16 steps of the larger logit (the logits' own rounding).  Returns the timings,
    keyed like the launch counters, when ``timing``."""
    x, tail = largs[0], largs[1:5]
    T, C = x.shape
    with torch.no_grad():
        num, den, cm = fh.final_head_loss_sums(*largs, patch_size=p, impl="pallas")
        wnum, wden, wcm = fh.final_head_loss_plain(*largs, patch_size=p)
        loss, wloss = float(num / den), float(wnum / wden)
        if not abs(loss - wloss) <= LOSS_REL_TOL * abs(wloss):
            raise AssertionError(f"{name}: loss {loss} vs plain {wloss}")
        lf = fh.final_head_logits_plain(x, *tail, patch_size=p).to(torch.bfloat16).float()
        slack = logit_slack(fh, x, tail) + 2 * 2.0 ** -7 * lf.abs().amax(-1)
        near, moved = confmat_agrees(name, cm, lf, largs[5].reshape(T, p), slack)
        scale = torch.ones((), device=x.device) / wden
        got = fh.final_head_loss_bwd(*largs, scale, patch_size=p, impl="pallas")
        want = fh.final_head_loss_bwd_plain(*largs, scale, patch_size=p)
        err, mae = check_grads(name, K7_GRADS, got, want)
        again = fh.final_head_loss_bwd(*largs, scale, patch_size=p, impl="pallas")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"{name}: two K7 launches differ")
        del got, want, again
    log(f"{name} final_head_loss T={T} C={C}: loss {loss:.6f} plain {wloss:.6f} (rel "
        f"{abs(loss - wloss) / abs(wloss):.2e}); confusion matrix: {moved} of {T * p} "
        f"elements in another column, all near-ties ({near} near-tie elements); "
        f"backward rel_l2 <= {err:.3e} max_abs {mae:.3e}, two launches bit-equal")
    if not timing:
        return {}
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


def build_task(impl, dev, state=None, depth=False, cos=True):
    """The paper model's segmentation task, or with ``depth`` its depth task (one
    output channel, the masked l2 loss, the paper depth run's data config: no
    transform, standardized, background masked); with ``cos`` False its blocks run
    scaled-dot attention instead of cosine (the JAX package's ablation ``no_cos``,
    ``benchmarks/ablate.py``)."""
    from heal_swin_torch.models import tasks as T
    from heal_swin_torch.models.swin_hp import DataSpec, SwinHPTransformerConfig

    # the paper model (heal_swin_tpu bench.py / __graft_entry__.py)
    cfg = SwinHPTransformerConfig(
        patch_size=4, window_size=WS, shift_size=4, shift_strategy="ring_shift",
        rel_pos_bias="flat", embed_dim=96, depths=[2, 2, 6, 2], num_heads=[3, 6, 12, 24],
        use_cos_attn=cos, use_v2_norm_placement=True, dtype="bfloat16", gelu_approx=True,
        fused_final_head=True, attention_impl=impl)
    gen = torch.Generator().manual_seed(SEED)
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
    if state is None:
        # zero-init rel-pos tables and equal logit scales would hide indexing faults:
        # give them seeded values
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
    "final_head_predict_f32")}
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


def record_blocks(model, io):
    """Forward hooks that keep the input and output of every ``SwinHPBlock`` of
    ``model`` in ``io`` (name -> (x, y)).  Returns the hook handles."""
    from heal_swin_torch.models.swin_hp import SwinHPBlock

    def hook(name):
        def keep(_mod, args, out):
            io[name] = (args[0], out)
        return keep

    return [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
            if isinstance(m, SwinHPBlock)]


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
    npix = imgs.shape[1]

    # the kernel path: count the launches of one predict, keep the features K3 got
    feats = {}
    keep = task_k.model.register_forward_hook(lambda _m, _a, out: feats.update(k=out))
    reset_counters()
    preds_k = task_k.predict(None, imgs)
    torch.cuda.synchronize()
    launches, by_shape = read_counters()
    keep.remove()
    check_launches(f"{label} predict", launches, by_shape, expected, timed)
    if preds_k.shape != (BATCH, npix) or preds_k.dtype != torch.int32:
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
    mism, near, _ = preds_agree(f"{label} K3", preds_k.reshape(B * N, 4), want, lk,
                                logit_slack(fh, fk, tail))
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
    # on, so the features are held to a looser bound than one block
    feats_p = feats["p"]
    err = check_close(f"{label} tail=False features", feats_k, feats_p, SLICE_REL_L2_TOL)[0]
    # the same measure for the plain path against itself, its input moved by bf16
    # rounding (2^-9 relative): how much the random-weight network amplifies
    # perturbations of that size
    noise = torch.randn(imgs.shape, generator=torch.Generator().manual_seed(SEED + 2))
    with torch.no_grad():
        feats_n = task_p.model(imgs * (1 + 2.0 ** -9 * noise.to(imgs.device)), tail=False)
    log(f"{label}: plain path, input moved by 2^-9 relative: features rel_l2 "
        f"{rel_l2(feats_n, feats_p):.3e}")
    log(f"{label}: features rel_l2 {err:.3e} (tol {SLICE_REL_L2_TOL}); "
        f"{int((preds_k != preds_p).sum())} of {preds_k.numel()} predicted classes differ "
        f"between the two paths")
    return launches, by_shape


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


def drive_slice(dev, timed, cos=True):
    """predict at paper scale through the kernels and through the plain path: checked,
    timed, and traced; with ``cos`` False the scaled-dot model.  Returns the kernels'
    launches in one predict: per kernel, and per operand shape."""
    label = "slice" if cos else "dot slice"
    imgs = torch.randn(BATCH, 8 * NSIDE * NSIDE, 3,
                       generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    t0 = time.perf_counter()
    task_k = build_task("auto", dev, cos=cos)
    task_p = build_task("xla", dev, state=task_k.model.state_dict(), cos=cos)
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
    return launches, by_shape


def train_batch(dev):
    """The fixed training batch: seeded random images, and targets that are a class per
    bin of the first input channel, so that a few steps on the batch can lower the
    loss (uniformly random targets leave nothing to learn)."""
    imgs = torch.randn(BATCH, 8 * NSIDE * NSIDE, 3,
                       generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    targets = torch.clamp(((imgs[..., 0] + 2.5) * 2).long(), 0, N_CLASSES - 1)
    return imgs, targets.to(torch.int32)


def check_train_blocks(label, task_k, task_p, imgs, targets, dev):
    """The backward where the model calls the kernels: every block of both paths of a
    task on the plain path's input and upstream gradient to that block (the gradient
    the task's loss gives).  Runs before any optimizer step, so the two models hold the
    same weights.  Returns the plain path's loss and the (T, C) features the kernel
    path's ``loss_fn`` hands its fused tail, for the caller to check the tail on."""
    from heal_swin_torch.models.swin_hp import SwinHPBlock

    # the plain path's forward and backward, keeping each block's input and the
    # gradient arriving at its output
    io = {}

    def hook(name):
        def keep(_mod, args, out):
            rec = io[name] = [args[0].detach(), None]
            out.register_hook(lambda g: rec.__setitem__(1, g.detach()))
        return keep

    hooks = [m.register_forward_hook(hook(n)) for n, m in task_p.model.named_modules()
             if isinstance(m, SwinHPBlock)]
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


def depth_batch(dev):
    """The fixed depth batch: the training images, and metric depths in [0.1, 60] m
    that are a function of the first input channel, so that a few steps on the batch
    can lower the loss, with BACKGROUND of the pixels marked inf."""
    imgs, _ = train_batch(dev)
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
    if (tuple(out_k.shape) != (BATCH, imgs.shape[1], 1) or out_k.dtype != torch.float32
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
    err = check_close("depth predict metric depths", out_k, out_p, SLICE_REL_L2_TOL)[0]
    log(f"depth predict: metric depths (B, npix, 1) f32 in [{float(out_k.min()):.3f}, "
        f"{float(out_k.max()):.3f}] m; kernels vs plain path rel_l2 {err:.3e} "
        f"(tol {SLICE_REL_L2_TOL})")
    ips_k, mem_k = rate(task_k, imgs)
    ips_p, mem_p = rate(task_p, imgs)
    ips_k2, _ = rate(task_k, imgs)
    log(f"depth predict: kernels {ips_k:.3f} / {ips_k2:.3f} img/s (peak {mem_k:.3f} GiB "
        f"above the resident), plain {ips_p:.3f} img/s (peak {mem_p:.3f} GiB above the "
        f"resident)")
    return launches, by_shape


def drive_train(dev, timed, depth=False, cos=True):
    """The train step at paper scale through the kernels and through the plain path,
    for segmentation or, with ``depth``, the depth task (after its ``predict``,
    ``drive_depth_predict``); with ``cos`` False the scaled-dot segmentation model:
    per-block backward and tail checks, one counted step,
    the loss over 5 more steps on one batch, the metrics, the rate and memory of each
    path (kernel, plain, kernel), and a trace of the kernel path's step.  Returns the
    kernels' launches in one train step: per kernel, and per operand shape."""
    from heal_swin_torch.models.tasks import decoder_tail
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.training.optimizer import OptimizerConfig, make_optimizer
    from heal_swin_torch.training.trainer import step_generator, train_step

    label = "depth train" if depth else "train" if cos else "dot train"
    task_k = build_task("auto", dev, depth=depth, cos=cos)
    task_p = build_task("xla", dev, state=task_k.model.state_dict(), depth=depth, cos=cos)
    if depth:
        imgs, metric_depth = depth_batch(dev)
        targets = task_k._to_network(metric_depth)  # standardized with the masked stats
        drive_depth_predict(task_k, task_p, imgs, timed)
        expected = dict(NO_LAUNCHES, final_head_depth_loss=1, final_head_depth_loss_bwd=1)
    else:
        imgs, targets = train_batch(dev)
        expected = dict(NO_LAUNCHES, final_head_loss=1, final_head_loss_bwd=1)
    expected.update(ATTN_LAUNCHES[cos], **ATTN_BWD_LAUNCHES[cos])
    loss0_p, feats = check_train_blocks(label, task_k, task_p, imgs, targets, dev)

    # the fused tail on the features the kernel path hands it
    tail = (feats,) + decoder_tail(task_k.model)
    if depth:
        check_depth_kernels(f"{label} tail", tail + (targets.reshape(-1, 4),), 4, "l2", fh,
                            timing=False)
    else:
        y = targets.reshape(-1, 4)
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


def check_chamfer_paper(dev, brute, pruned):
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
    log(f"chamfer paper pairs on the card: K10 = plain on {k10['timed_on']} (K10 "
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
    from heal_swin_torch.ops import chamfer as ch
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
                per, _ = trace(lambda: tm.mlp_bwd(*a5, dz, **kw, impl="pallas"),
                               SEQUENCE_TRACED)
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
                    per, _ = trace(lambda: tm.mlp_block_bwd(*args, d, dz, **bkw),
                                   SEQUENCE_TRACED)
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


def drive_mlp(dev, timed):
    """The MLP family at the paper model's widths, on its own blocks.  K12-K15 are held
    to their plain versions at every stage shape first (``check_mlp_kernels``).  Then
    the segmentation model at paper scale runs one training forward, keeping each
    block's MLP-branch input and DropPath draw (``record_mlp_inputs``), and, counted:
    - for each of the 20 blocks at C <= 384, ``fused_mlp_block`` on the block's fc1,
      fc2, norm2 and draw (K14 forward, K15 backward) against its own plain branch
      x + drop_path(norm2(mlp(x))): the output and every gradient, for a seeded
      upstream gradient;
    - for the 4 blocks at C = 96, the block's ``Mlp`` with ``mlp_impl="fused"`` (K13
      backward) against ``"xla"`` on the same weights and input (output and every
      gradient), and ``fused_mlp`` with ``fwd_impl="pallas"`` (K12) against it.
    Expected launches K12 4 / K13 4 / K14 20 / K15 20.  Returns (launches, per shape)."""
    from heal_swin_torch.ops import mlp as tm

    timed.update(check_mlp_kernels(torch.Generator().manual_seed(SEED + 7), dev))
    t0 = time.perf_counter()
    task = build_task("auto", dev)
    rec = record_mlp_inputs(task.model, dev)
    log(f"mlp: built the paper model and recorded its 22 blocks' MLP inputs in "
        f"{time.perf_counter() - t0:.1f} s")
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
        worst_blk = max(worst_blk, check_close(f"mlp block {name} output", zk.detach(),
                                               zp.detach().reshape(B * N, C))[0])
        for n, a, b in zip(("dx",) + MLP_BLOCK_GRADS[1:], gk, gp):
            worst_blk = max(worst_blk, check_close(f"mlp block {name} {n}", a, b)[0])
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
            raise AssertionError(f"mlp {name}: the fused gate's forward is not the plain one")
        worst_mlp = max(worst_mlp, check_close(f"mlp {name} K12 output", outs[2], outs[1])[0])
        for n, a, b in zip(MLP_GRADS, *grads):
            worst_mlp = max(worst_mlp, check_close(f"mlp {name} fused {n}", a, b)[0])
    torch.cuda.synchronize()
    launches, by_shape = read_counters()
    expected = dict(NO_LAUNCHES, mlp_fwd=4, mlp_bwd=4, mlp_block_fwd=20, mlp_block_bwd=20)
    check_launches("mlp", launches, by_shape, expected, timed)
    log(f"mlp: {n_blk} blocks at C <= 384 ({n_dp} with a DropPath draw): fused_mlp_block "
        f"vs the block's own branch x + drop_path(norm2(mlp(x))), output and every gradient "
        f"rel_l2 <= {worst_blk:.3e}; {n_mlp} blocks at C = 96: Mlp(mlp_impl='fused') = "
        f"'xla' forward bit for bit, gradients and fused_mlp(fwd_impl='pallas') rel_l2 <= "
        f"{worst_mlp:.3e} (tol {REL_L2_TOL})")
    del rec, task
    return launches, by_shape


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
               "window_attention_qkv_epi_f32", "window_attention_f32")
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


def paper_tail_inputs(gen, dev):
    """The paper config's tail operands in f32 (T = 262,144 tokens of batch 2 at nside
    256, C 96, p 4, F 8): (x, we, gamma, beta, wh, y, welem), welem the SynWoodScape
    class weights of y."""
    from heal_swin_torch.run_configs import SYNWOODSCAPE_LARGE_WEIGHTS

    rnd, _ = seeded_draws(gen, dev)
    C, p, F = 96, TAIL_P, PAPER_CLASSES
    T = BATCH * 8 * NSIDE * NSIDE // p
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
    """The f32 K6 and K7 against their plain versions (f32, TF32 off) at the paper tail:
    K6's sums within F32_TAIL_TOL relative and its confusion matrix equal outside
    near-ties (``confmat_agrees``, slack F32_TAIL_TOL of the row's largest |logit|, at
    least F32_TAIL_TOL); every K7 gradient within relative L2 F32_TAIL_TOL, two launches
    bit-equal; each step of K7 (tile kernel, reduce_rows) against its plain twin on its
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
    with torch.no_grad():
        num, den, cm, lf6 = fh.final_head_loss_sums(*largs, patch_size=p, impl="pallas",
                                                     tap_logits=True)
        wnum, wden, _ = fh.final_head_loss_plain(*largs, patch_size=p)
        errs = [abs(float(a) - float(w)) / abs(float(w)) for a, w in ((num, wnum), (den, wden))]
        if max(errs) > F32_TAIL_TOL:
            raise AssertionError(f"{name}: K6 sums {float(num)}, {float(den)} vs plain "
                                 f"{float(wnum)}, {float(wden)}")
        lf = fh.final_head_logits_plain(x, *largs[1:5], patch_size=p)
        slack = F32_TAIL_TOL * lf.abs().amax(-1).clamp_min(1.0)
        near, moved = confmat_agrees(f"{name} K6", cm, lf, largs[5].reshape(T, p), slack)
        scale = torch.ones((), device=x.device) / wden
        got = fh.final_head_loss_bwd(*largs, scale, patch_size=p, impl="pallas")
        want = fh.final_head_loss_bwd_plain(*largs, scale, patch_size=p)
        err, mae = check_grads(f"{name} K7", K7_GRADS, got, want, F32_TAIL_TOL)
        again = fh.final_head_loss_bwd(*largs, scale, patch_size=p, impl="pallas")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"{name}: two K7 launches differ")
        lf7 = fh.final_head_loss_bwd_rows(*largs, scale, patch_size=p, impl="pallas",
                                          tap_logits=True)[-1]
        equal_bits(f"{name} probe: K7's recomputed logits vs K6's", lf7, lf6)
        grid, e_rows, e_red = check_f32_bwd_steps(
            name, "K7", x, F, p, fh,
            lambda: fh.final_head_loss_bwd_rows(*largs, scale, patch_size=p, impl="pallas"),
            lambda grid: fh.final_head_loss_bwd_rows_f32_plain(*largs, scale, patch_size=p,
                                                               grid=grid),
            lambda: fh.final_head_loss_bwd(*largs, scale, patch_size=p, impl="pallas"))
        del got, want, again, lf, lf6, lf7
        log(f"{name} K6 T={T} C={C} F={F}: sums rel err {errs[0]:.3e}, {errs[1]:.3e} "
            f"(tol {F32_TAIL_TOL}); confusion matrix: {moved} of {T * p} elements in "
            f"another column, all near-ties ({near} near-tie elements)")
        log(f"{name} K7: every gradient rel_l2 <= {err:.3e} max_abs {mae:.3e} (tol "
            f"{F32_TAIL_TOL}), two launches bit-equal; on {grid} blocks tile kernel rel_l2 "
            f"<= {e_rows:.3e}, reduce_rows {e_red:.3e}, K7 the steps composed bit-equal; K7 "
            f"recomputes K6's f32 logits bit for bit")
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
    loss, wloss = float(num / den), float(wnum / wden)
    return {("final_head_loss_f32", T, C): dict(
                max_abs_err=abs(loss - wloss), sums_rel_err=max(errs), confmat_moved=moved,
                near_tie_elements=near, ms=ms6, device_ms=dev6, plain_ms=pms6,
                route_ms=rms6, route_device_ms=rdev6),
            ("final_head_loss_bwd_f32", T, C): dict(
                rel_l2=err, max_abs_err=mae, ms=ms7, device_ms=dev7, plain_ms=pms7,
                route_ms=rms7, route_device_ms=rdev7)}


def paper_task(impl, dev, state=None, depth=False):
    """The paper segmentation config's task (``heal_swin_torch.run_configs``): f32 compute,
    dropout and attention dropout 0.1, DropPath 0.1, the SynWoodScape-large class
    weights, Adam at the paper rate, at nside 256; with ``depth`` the paper depth
    config's task (``paper_depth_config``: the same network with one output channel, the
    masked l2 loss on standardized depths with background masked, Adam at 0.005).
    Weights from SEED (the rel-pos tables and logit scales perturbed as
    ``build_task``'s) or ``state``."""
    from heal_swin_torch.models import tasks as T
    from heal_swin_torch.models.swin_hp import DataSpec
    from heal_swin_torch.run_configs import (PAPER_LR, SYNWOODSCAPE_LARGE_WEIGHTS,
                                             paper_depth_config, paper_swin_hp_config)
    from heal_swin_torch.training.optimizer import OptimizerConfig

    gen = torch.Generator().manual_seed(SEED)
    npix = 8 * NSIDE * NSIDE
    if depth:
        cfg = paper_depth_config(attention_impl=impl)
        task = T.WoodscapeDepthSwinHP(
            cfg.model, T.DepthDataSpec(dim_in=npix, f_in=3, f_out=1, base_pix=8), cfg.data,
            device=dev, generator=gen)
    else:
        task = T.WoodscapeSegmenterSwinHP(
            T.WoodscapeSegmenterSwinHPConfig(
                paper_swin_hp_config(attention_impl=impl),
                optimizer_config=OptimizerConfig(learning_rate=PAPER_LR),
                class_weights=list(SYNWOODSCAPE_LARGE_WEIGHTS)),
            DataSpec(dim_in=npix, f_in=3, f_out=PAPER_CLASSES, base_pix=8), device=dev,
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


def paper_step(label, task_k, task_p, imgs, targets, expected, timed, counted):
    """A paper config's train step through the kernels (``task_k``, "auto") and through
    the plain path (``task_p``, "xla", the same weights), on the same batch and step
    generators.  Step 0 of each path through ``train_step``: every dropout mask the
    kernel path draws is kept and the plain path's are held to them (``torch.equal``, in
    draw order), and their kept share to 0.9 within 3 standard deviations; the kernel
    path's launches are ``expected``; the two losses agree within PAPER_LOSS_TOL
    relative and every parameter gradient within relative L2 PAPER_GRAD_TOL.  Then
    PAPER_STEPS more steps of each path, timed (images/s, peak memory above the
    resident), the loss falling on both, the metric state (``counted``: its count's key
    and what a step adds to it), and a trace of a kernel-path step (device time by
    kernel, idle share).  Returns the kernels' launches in step 0 of the kernel path:
    per kernel, and per operand shape."""
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
    finally:
        layers.keep_mask = draw
    check_launches(f"{label} step", launches, by_shape, expected, timed)
    grads_k = {n: q.grad.detach().clone() for n, q in task_k.model.named_parameters()}
    kept = sum(int(m.sum()) for m in masks)
    drawn = sum(m.numel() for m in masks)
    share, sd = kept / drawn, (0.9 * 0.1 / drawn) ** 0.5
    elem = [m for m in masks if m.numel() > m.shape[0]]  # the element masks, not DropPath's
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
    if seen["n"] != n_masks or seen["differ"] or n_attn == 0:
        raise AssertionError(f"{label}: the plain path drew {seen} against the kernel "
                             f"path's {n_masks} masks ({n_attn} on attention)")
    log(f"{label}: step 0 drew {seen['n']} masks ({n_attn} on attention probabilities), "
        f"{drawn} entries, on both paths bit-equal in draw order; kept share {share:.6f} "
        f"(element masks {e_share:.6f}; 0.9 within 3 sd = {3 * sd:.2e})")
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
                                                  targets, 1, PAPER_STEPS)
    ips_p, mem_p, traj_p, mstates[1] = train_rate(task_p, opts[1], mstates[1], imgs,
                                                  targets, 1, PAPER_STEPS)
    ips_k2, mem_k2, traj_k2, mstates[0] = train_rate(task_k, opts[0], mstates[0], imgs,
                                                     targets, 1 + PAPER_STEPS, PAPER_STEPS)
    resident = torch.cuda.memory_allocated() / 2 ** 30
    for path, traj in (("kernels", [loss_k0] + traj_k + traj_k2), ("plain", [loss_p0] + traj_p)):
        log(f"{label}: loss over {len(traj)} steps on one batch ({path}): "
            + " ".join(f"{v:.6f}" for v in traj))
        if not (all(math.isfinite(v) for v in traj) and traj[-1] < traj[0]):
            raise AssertionError(f"{label} ({path}): the loss did not fall: {traj}")
    key, per_step = counted
    for path, task, ms, n in (("kernels", task_k, mstates[0], 1 + 2 * PAPER_STEPS),
                              ("plain", task_p, mstates[1], 1 + PAPER_STEPS)):
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

    state = dict(step=1 + 2 * PAPER_STEPS)

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


def check_f32_eval_kernels(gen, dev):
    """The f32 K1, K2 and K3 against their plain versions (f32, TF32 off) at every paper
    shape, each within relative L2 F32_TAIL_TOL: K1 at the three stage shapes with and
    without the mask (two launches bit-equal), K2 at the bottleneck in both flavours, K3
    at the paper tail (T 262,144, C 96, p 4, F 8): its classes equal the plain
    version's outside near-ties of the f32 logits, its logits tap within F32_TAIL_TOL,
    and probe (i), its classes ``argmax_lowest`` of its own tap (``torch.equal``), its
    tap the f32 K6's bits.  Each timed: one call (``median_ms``), its device time
    (``spin_ms``; K1's steps by kernel from a trace), the plain version; K2 beside one f32
    ``scaled_dot_product_attention`` (the library call, scaled-dot) and K3 beside the
    f32 composed PyTorch route (``pred_route``).  Returns the timings keyed like the
    launch counters."""
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.ops import window_attention as wa

    f32 = torch.float32
    timed = {}
    rnd, logit_scales = seeded_draws(gen, dev)
    with torch.no_grad():
        for stage in range(3):
            T, C, h, args = stage_inputs(rnd, logit_scales, stage, dev)
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

        T, C, h, (qkv, bias, ls, groups, _) = bottleneck_inputs(rnd, logit_scales, dev)
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

        largs = paper_tail_inputs(gen, dev)
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
        if tuple(out_k.shape) != (BATCH, imgs.shape[1], 1) or out_k.dtype != torch.float32:
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
            mk, nk, _ = preds_agree(f"{label} K3", out_k.reshape(B * N, TAIL_P),
                                    fh.argmax_lowest(lk), lk, own)
            slack = 2 * (lk - lp).abs().amax(-1) + own
            mism, near, _ = preds_agree(f"{label} classes", out_k.reshape(B * N, TAIL_P),
                                        out_p.reshape(B * N, TAIL_P), lp, slack)
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


def fit_datamodule(depth):
    """The port's synthetic HEALPix datamodule at nside NSIDE on 8 base pixels: FIT_TRAIN
    train and FIT_VAL validation samples, batch BATCH for both; segmentation has the
    fixture's 4 classes, depth the depth paper config's data settings (standardized,
    background masked)."""
    import dataclasses

    from heal_swin_torch.data.data import get_data_module
    from heal_swin_torch.data.data_config import WoodscapeCommonConfig, WoodscapeHPConfig
    from heal_swin_torch.run_configs import paper_depth_config

    common = WoodscapeCommonConfig(version="synthetic", batch_size=BATCH,
                                   val_batch_size=BATCH, pred_batch_size=BATCH,
                                   synthetic_train_samples=FIT_TRAIN,
                                   synthetic_val_samples=FIT_VAL)
    if depth:
        data = dataclasses.replace(paper_depth_config().data, common=common,
                                   input_nside=NSIDE)
    else:
        data = WoodscapeHPConfig(common=common, input_nside=NSIDE, input_base_pix=8)
    return get_data_module(data)


def fit_run(label, root, dm, spec, dev, depth=False, **pl):
    """One ``Trainer.fit`` of a paper config (f32, dropout, attention dropout and DropPath
    0.1; segmentation unweighted over the fixture's 4 classes at the paper rate, depth
    as ``paper_depth_config``) on ``dm`` into its own FileStore run and checkpoint dir
    under ``root``, seed SEED, sanity validation of 1 batch, every step's loss logged;
    ``pl``: PLConfig fields on top.  The launch counters are set to 0 just before the
    fit and read just after.  Returns a dict of the trainer, fit result, task, run,
    checkpoint dir, launches (per kernel, per shape) and seconds."""
    from heal_swin_torch.models import tasks as T
    from heal_swin_torch.run_configs import PAPER_LR, paper_depth_config, paper_swin_hp_config
    from heal_swin_torch.tracking.mlflow_store import MlflowFileStore
    from heal_swin_torch.training.optimizer import OptimizerConfig
    from heal_swin_torch.training.train_config import PLConfig, TrainConfig
    from heal_swin_torch.training.trainer import Trainer

    if depth:
        cfg = paper_depth_config()
        task = T.WoodscapeDepthSwinHP(cfg.model, spec, cfg.data, device=dev)
        tc = TrainConfig(seed=SEED, ckpt_metric="val_loss", ckpt_mode="min",
                         mlflow_expmt="chip_smoke_fit")
    else:
        task = T.WoodscapeSegmenterSwinHP(
            T.WoodscapeSegmenterSwinHPConfig(
                paper_swin_hp_config(), optimizer_config=OptimizerConfig(learning_rate=PAPER_LR)),
            spec, device=dev)
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


def check_fit_launches(label, fit, steps, val_batches, timed, depth=False):
    """A fit's launches: per train step the f32 tail's forward and backward (K6/K7, or
    K8/K9) and no attention kernel (attention dropout sends every block to the plain
    route); per validation batch the f32 K1 20 times and K2 twice, and for depth the f32
    K8 once (segmentation validation passes a sample mask, so its tail is unfused and
    runs no K6)."""
    tail = "final_head_depth_loss" if depth else "final_head_loss"
    expected = dict(NO_LAUNCHES, **{k: v * val_batches for k, v in PAPER_EVAL_LAUNCHES.items()})
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


def drive_fit(dev, timed):
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
    on a checkpoint flush, and a checkpoint's bytes."""
    import shutil
    import tempfile
    from pathlib import Path

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    try:
        dm, spec = fit_datamodule(False)
        log(f"fit: synthetic datamodule, {len(dm.train_ds)} train / {len(dm.val_ds)} "
            f"validation samples of {spec.dim_in} pixels, {spec.f_out} classes "
            f"(unweighted CE), batch {BATCH}")
        fits = {}
        for label, pl in (("A", dict(max_epochs=2)), ("A'", dict(max_epochs=2)),
                          ("B", dict(max_epochs=1))):
            fits[label] = fit_run(label, root, dm, spec, dev, **pl)
        last = fits["B"]["ckpt_dir"] / "last.ckpt"
        fits["B2"] = fit_run("B2", root, dm, spec, dev, max_epochs=2,
                             resume_from_checkpoint=str(last))
        a = fits["A"]
        steps, per_epoch = a["result"].global_step, a["result"].global_step // 2
        if (steps, fits["B"]["result"].global_step, fits["B2"]["result"].global_step) != (
                2 * per_epoch, per_epoch, steps) or per_epoch != FIT_TRAIN // BATCH:
            raise AssertionError(f"fit: steps {[f['result'] for f in fits.values()]}")
        check_fit_launches("fit A", a, steps, 1 + 2 * (FIT_VAL // BATCH), timed)
        check_fit_launches("fit B2 (resumed)", fits["B2"], per_epoch, 1 + FIT_VAL // BATCH,
                           timed)
        files = check_fit_files("fit A", a, FIT_METRICS, "val_iou_global_ignored")

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
                raise AssertionError(f"fit: resumed {k} rel_l2 {err:.3e} (bit-equal {same}) "
                                     f"against A; A vs A' {floor[k][0]:.3e} (bit-equal "
                                     f"{floor[k][1]}), limit {tol:.3e}")
        worst_b = max(resumed.items(), key=lambda kv: kv[1][0])
        log(f"fit: A vs A' over {len(floor)} tensors (parameters, Adam moments and steps, "
            f"epoch-2 step losses): largest rel_l2 {worst_aa:.3e} "
            f"({max(floor.items(), key=lambda kv: kv[1][0])[0]}), "
            f"{sum(s for _, s in floor.values())} bit-equal; resumed B vs A: largest rel_l2 "
            f"{worst_b[1][0]:.3e} ({worst_b[0]}), {sum(s for _, s in resumed.values())} "
            f"bit-equal, limit {tol:.3e}, bit-equal wherever A and A' are")
        log("fit: step losses A " + " ".join(f"{v:.6f}" for v in fit_losses(a["run"], 1).tolist())
            + "; resumed B epoch 2 " + " ".join(
                f"{v:.6f}" for v in states["B2"]["epoch-2 step losses"].tolist()))
        ckpt_bytes = (a["ckpt_dir"] / "last.ckpt").stat().st_size
        paper = timed.get("paper train img/s", (float("nan"),) * 2)
        for k, f in fits.items():
            tr = f["trainer"]
            rate_fit = tr.last_train_steady_samples / tr.last_train_steady_time
            stamps = [t for t, _, _ in f["run"].get_metric_history("train_loss_step")]
            log(f"fit {k}: {f['result'].epochs_run} epochs, {f['result'].global_step} steps "
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
            timed[f"fit {k}"] = dict(steady_img_s=rate_fit, seconds=f["seconds"],
                                     loop_wait_s=tr.ckpt_manager.save_wait_seconds)
        log(f"fit: a checkpoint is {ckpt_bytes} bytes ({ckpt_bytes / 2 ** 30:.4f} GiB: "
            f"parameters and two Adam moments in f32); A's checkpoint dir {files}")
        del fits, states, a
        torch.cuda.empty_cache()

        dm, spec = fit_datamodule(True)
        d = fit_run("depth", root, dm, spec, dev, depth=True, max_epochs=1)
        check_fit_launches("fit depth", d, FIT_TRAIN // BATCH, 1 + FIT_VAL // BATCH, timed,
                           depth=True)
        names = (["train_loss", "train_loss_step", "val_loss", "epoch", "lr-Adam"]
                 + list(d["task"].metric_compute(d["task"].metric_init(), "train_"))
                 + list(d["task"].metric_compute(d["task"].metric_init(), "val_")))
        check_fit_files("fit depth", d, names, "val_loss")
        tr = d["trainer"]
        log(f"fit depth: 1 epoch, {d['result'].global_step} steps in {d['seconds']:.3f} s, "
            f"steady train {tr.last_train_steady_samples / tr.last_train_steady_time:.4f} "
            f"img/s (paper_step's {timed.get('paper depth train img/s', (float('nan'),))[0]:.4f}); "
            + " ".join(f"{k} {v:.6f}" for k, v in d["result"].last_metrics.items()
                       if k.startswith("val_")))
        del d
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)


GATE_NSIDE = 32  # 512 tokens an image at the second stage: one 64-token window per base pixel


def refuse_f32_tails(dev):
    """The f32 tails the kernels do not take, on CUDA tensors: the f32 K3, K8 and K9 on
    a tail of C 48 (their instantiations: C 32, 64, 96, 128) raise under "auto" and
    "pallas" before any launch, naming the kernel and impl="xla"; under "xla" they run
    their plain versions with no launch."""
    from heal_swin_torch.ops import final_head as fh

    rnd, _ = seeded_draws(torch.Generator().manual_seed(SEED + 19), dev)
    T, p = 64 * 8, TAIL_P
    pred = (rnd(T, 48), rnd(48, p * 48, std=0.1), 1.0 + rnd(48, std=0.1), rnd(48, std=0.1),
            rnd(48, PAPER_CLASSES, std=0.3))
    d48 = (rnd(T, 48), rnd(48, p * 48, std=0.1), 1.0 + rnd(48, std=0.1), rnd(48, std=0.1),
           rnd(48, 1, std=0.1), depth_targets(torch.Generator().manual_seed(SEED), T, p, dev))
    one = torch.ones((), device=dev)
    kw = dict(patch_size=p, loss_kind="l2")
    cases = (("K3", lambda impl: fh.final_head_predict(*pred, patch_size=p, impl=impl)),
             ("K8", lambda impl: fh.final_head_depth_loss_sums(*d48, **kw, impl=impl)),
             ("K9", lambda impl: fh.final_head_depth_loss_bwd(*d48, one, **kw, impl=impl)))
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
    log("refusal f32 tails: the f32 K3 and K8/K9 at C 48 raised under \"auto\" and "
        "\"pallas\" with no launch, naming the kernel and impl='xla'; \"xla\" ran their "
        "plain versions with no launch")


def drive_refusal(dev):
    """The kernels' refusal on the card: two small segmentation models the kernels were
    not written for -- float32 compute (the config default) at the kernels' window 64
    with no dropout, and bf16 at window 16 with 40 classes (more than K3/K6/K7's 32
    lanes), both with the config's default scaled-dot attention.  Under "auto" and
    "pallas" a loss and a predict raise before any launch, naming attention_impl="xla":
    in the f32 model the first block's K16 (``window_attention_qkv``, bf16 only) refuses
    both, before the predict's f32 K3 or the loss's f32 K6/K7 is reached; in the
    window-16 model K16 refuses the window.  Under "xla" the same weights run a loss
    with its backward and a predict with no launch, finite and of the expected shapes.
    Then the same f32 model with cosine attention in training (no dropout, so every block
    takes K1): its train-mode loss raises in the first block before any launch, naming
    K4 (the f32 K1 is forward only; K4 takes bf16) and attention_impl="xla", which runs
    it and its backward with no launch.  Then the tail wrappers alone
    (``refuse_f32_tails``): an f32 tail at C 48, which the f32 K3 and K8/K9 have no
    instantiation for."""
    from heal_swin_torch.models import tasks as T
    from heal_swin_torch.models.swin_hp import DataSpec, SwinHPTransformerConfig

    refuse_f32_tails(dev)
    npix = 8 * GATE_NSIDE * GATE_NSIDE
    imgs = torch.randn(BATCH, npix, 3, generator=torch.Generator().manual_seed(SEED + 9)).to(dev)
    for dtype, ws, classes in ((None, WS, N_CLASSES), ("bfloat16", 16, 40)):
        label = f"refusal dtype={dtype or 'float32'} ws={ws} classes={classes}"

        def build(impl):
            cfg = SwinHPTransformerConfig(
                patch_size=4, window_size=ws, shift_size=4 if ws == WS else 8,
                shift_strategy="ring_shift", rel_pos_bias="flat", embed_dim=64, depths=[2, 2],
                num_heads=[2, 4], use_v2_norm_placement=True, dtype=dtype, gelu_approx=True,
                fused_final_head=True, attention_impl=impl)
            return T.WoodscapeSegmenterSwinHP(
                T.WoodscapeSegmenterSwinHPConfig(cfg),
                DataSpec(dim_in=npix, f_in=3, f_out=classes, base_pix=8), device=dev,
                generator=torch.Generator().manual_seed(SEED))

        targets = torch.clamp(((imgs[..., 0] + 2.5) * classes / 5).long(), 0, classes - 1)
        refusals = []
        reset_counters()
        for impl in ("auto", "pallas"):
            task = build(impl)
            for call in (lambda: task.loss_fn(imgs, targets), lambda: task.predict(None, imgs)):
                try:
                    call()
                except ValueError as e:
                    if "impl='xla'" not in str(e):
                        raise
                    refusals.append(str(e))
                else:
                    raise AssertionError(f"{label} {impl}: no refusal")
        task = build("xla")
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

    label = "refusal dtype=float32 cosine, training"
    targets = torch.clamp(((imgs[..., 0] + 2.5) * 2).long(), 0, N_CLASSES - 1)

    def build_cos(impl):
        cfg = SwinHPTransformerConfig(
            patch_size=4, window_size=WS, shift_size=4, shift_strategy="ring_shift",
            rel_pos_bias="flat", embed_dim=64, depths=[2, 2], num_heads=[2, 4],
            use_cos_attn=True, use_v2_norm_placement=True, fused_final_head=True,
            attention_impl=impl)
        return T.WoodscapeSegmenterSwinHP(
            T.WoodscapeSegmenterSwinHPConfig(cfg),
            DataSpec(dim_in=npix, f_in=3, f_out=N_CLASSES, base_pix=8), device=dev,
            generator=torch.Generator().manual_seed(SEED))

    def train_loss(task):
        return task.loss_fn(imgs, targets, deterministic=False,
                            generator=torch.Generator(device=dev).manual_seed(SEED))[0]

    reset_counters()
    for impl in ("auto", "pallas"):
        try:
            train_loss(build_cos(impl))
        except ValueError as e:
            if "K4" not in str(e) or "attention_impl='xla'" not in str(e):
                raise
            msg = str(e)
        else:
            raise AssertionError(f"{label} {impl}: no refusal")
    task = build_cos("xla")
    loss = train_loss(task)
    loss.backward()
    torch.cuda.synchronize()
    launches, _ = read_counters()
    if any(launches.values()):
        raise AssertionError(f"{label}: kernels launched: {launches}")
    if not (torch.isfinite(loss) and all(q.grad is not None and torch.isfinite(q.grad).all()
                                         for q in task.model.parameters())):
        raise AssertionError(f"{label} xla: a non-finite result")
    log(f"{label}: \"auto\" and \"pallas\" raised in the train-mode loss with no launch "
        f"({msg}); \"xla\" ran it ({loss.item():.6f}) and its backward with no launch")


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
    and weights, f32 biases, LayerNorm parameters, DropPath scale and parameter
    gradients."""
    name, T, C = key[:3]
    if name.startswith("window_attention") and name.endswith("_f32"):
        # the f32 K1 and K2: the bf16 forms' FLOPs, twice the bytes of their tokens
        flop, nbytes = shape_work((name[:-4],) + tuple(key[1:]))
        tokens = (8 if name == "window_attention_f32" else 4) * T * C
        return flop, nbytes + tokens + (8 * C * C if "epi" in name else 0)
    if name in F32_KERNELS:
        return f32_tail_work(key)
    if name.startswith("mlp"):
        H = key[3]
        block = name.startswith("mlp_block")
        vecs = 4 * (H + C) + (8 * C if block else 0)  # biases [, gamma, beta]
        ds = 4 * T if block and key[5] else 0
        if name.endswith("fwd"):
            return 4 * T * C * H, 4 * T * C + 4 * C * H + vecs + ds
        return (12 if block else 10) * T * C * H, 6 * T * C + 12 * C * H + 2 * vecs + ds
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


def kernel_results(timed, runs, chamfer):
    """The per-kernel results line.  ``runs``: kernel -> (launches per kernel, per
    shape) of the run that uses it.  K1-K9 and K12-K15: each kernel's launches in that
    run, and its times and bound summed over the shapes that run launched it at, each
    shape weighted by its launches there; ``library_ms`` where one PyTorch call computes
    the function (K2/K5: scaled_dot_product_attention), else null.  K12-K17 add
    ``route_ms``, the port's composed cuBLAS / ATen route (K12-K15) or the composed
    PyTorch route (K16/K17) for the same function.  K10 / K11: ``chamfer``, from
    ``drive_chamfer_eval``."""
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        launches, by_shape = runs[name]
        entry = dict(name=name, route="cuda", source=source, replaces=replaces,
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
PTXAS_NAMES.update({"18attn_3xtf32_kernel": "f32 K2 attn_3xtf32_kernel (f32 K1 step 2)",
                    "18gemm_3xtf32_kernel": "f32 K1 steps 1 and 3 gemm_3xtf32_kernel",
                    "18ln_rows_f32_kernel": "f32 K1 step 4 ln_rows_f32_kernel"})


def log_ptxas(build_log: str):
    """nvcc's -Xptxas -v report of the build, one line per kernel: its spills, stack,
    registers and shared memory, under its name (the window-attention and MLP kernels and
    gemm_nt by name, the others mangled)."""
    name, props = None, []
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            key = max((k for k in PTXAS_NAMES if k in name), key=len, default=None)
            name = name if key is None else PTXAS_NAMES[key]
            props = []
        elif name and ("spill" in line or "registers" in line):
            props.append(line.split(":", 1)[-1].strip())
            if "registers" in line:
                log(f"ptxas {name}: " + "; ".join(props))
                name = None


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
    t_paper = time.perf_counter()
    paper_run = drive_paper_train(dev, timed)
    torch.cuda.empty_cache()
    t_depth = time.perf_counter()
    paper_depth_run = drive_paper_depth_train(dev, timed)
    torch.cuda.empty_cache()
    t_eval = time.perf_counter()
    paper_eval_run = drive_paper_eval(dev, timed)
    torch.cuda.empty_cache()
    t_fit = time.perf_counter()
    drive_fit(dev, timed)
    torch.cuda.empty_cache()
    t_gate = time.perf_counter()
    drive_refusal(dev)
    t_end = time.perf_counter()
    log(f"elapsed: {t_end - t0:.1f} s since the build started, the Chamfer phase "
        f"{t_mlp - t_chamfer:.1f} s of it, the MLP phase {t_dot - t_mlp:.1f} s, the "
        f"scaled-dot phase {t_paper - t_dot:.1f} s, the paper-config phase "
        f"{t_depth - t_paper:.1f} s, the paper depth phase {t_eval - t_depth:.1f} s, the "
        f"paper eval phase {t_fit - t_eval:.1f} s, the fit phase {t_gate - t_fit:.1f} s, "
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
    kernels = kernel_results(timed, runs, chamfer)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
