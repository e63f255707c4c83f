"""On-GPU smoke check of heal_swin_torch: builds the CUDA kernels from the checkout,
holds each against its plain PyTorch version at the shapes of the main path, then
drives HEAL-SWIN-UNet at the paper configuration (nside 256, batch 2, bf16, random
seeded weights) through the kernels and through the plain path: segmentation
``predict`` (serving) and its train step (forward, weighted CE, backward, Adam), and
the depth task's ``predict`` and train step (masked l2 loss on standardized depths
with background marked inf).

    python3 chip_smoke.py            # needs one CUDA GPU; exits non-zero otherwise

Prints its findings line by line, a JSON line of per-kernel results, and ends with
{"ok": true, "device": {...}}.  Any failed check raises, so the exit code is non-zero.

The kernels' launch counters (``launches``, and ``launches_by_shape`` per operand
shape) are set to 0 just before each driven call (a segmentation predict, a
segmentation train step, a depth predict, a depth train step) and read just after;
each kernel's ``launches`` in the results line comes from the run that uses it (the
segmentation train step for K1, K2, K4-K7; segmentation predict for K3; the depth
train step for K8, K9), and its ``ms`` / ``plain_ms`` is the sum, over the shapes that
run launched it at, of the median time of one call at that shape times the number of
such launches.  torch.profiler traces of predict and of both train steps give the
device time by kernel and the device's idle share.
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


def check_kernels(gen, dev):
    """Each kernel against its plain version at the main paths' shapes.  Returns the
    measures of each shape, keyed as the wrappers' ``launches_by_shape`` counters are:
    (kernel, T, C, has_mask) for the attention kernels, (kernel, T, C) for K3, K6, K7,
    (kernel, T, C, F, loss kind) for K8, K9."""
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.ops import window_attention as wa

    bf16 = torch.bfloat16
    timed = {}

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(dev)

    def logit_scales(h):
        return torch.exp(torch.clamp_max(math.log(10.0) + 0.5 * torch.randn(h, generator=gen),
                                         math.log(100.0))).to(dev)

    # K1: every block at C <= 384 (encoder stages 0-2, decoder stages 1-3)
    for stage in range(3):
        C = 96 * 2 ** stage
        h = C // 32
        T = BATCH * 8 * NSIDE * NSIDE // 4 // 4 ** stage
        x = rnd(T, C).to(bf16)
        wq, bq = rnd(C, 3 * C, std=C ** -0.5).to(bf16), rnd(3 * C, std=0.02).to(bf16)
        wp, bp = rnd(C, C, std=C ** -0.5).to(bf16), rnd(C, std=0.02).to(bf16)
        g, b = 1.0 + rnd(C, std=0.1), rnd(C, std=0.1)
        bias = rnd(h, WS, WS, std=0.5)
        ls = logit_scales(h)
        groups = ring_groups(T // BATCH).to(dev)
        for masked in (False, True):
            args = (x, wq, bq, wp, bp, g, b, groups if masked else None, bias, ls)
            kw = dict(ws=WS, num_heads=h, sm_scale=(C // h) ** -0.5, has_mask=masked)
            got = wa.window_attention_qkv_epi(*args, **kw, impl="pallas")
            want = wa.window_attention_qkv_epi_plain(*args, **kw)
            err, mae = check_close(f"K1 C={C} mask={masked}", got, want)
            ms = median_ms(lambda: wa.window_attention_qkv_epi(*args, **kw, impl="pallas"))
            pms = median_ms(lambda: wa.window_attention_qkv_epi_plain(*args, **kw))
            log(f"K1 window_attention_qkv_epi C={C} T={T} mask={masked}: rel_l2 {err:.3e} "
                f"max_abs {mae:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms")
            timed[("window_attention_qkv_epi", T, C, masked)] = dict(
                rel_l2=err, max_abs_err=mae, ms=ms, plain_ms=pms)

            # K4, its backward, for an output gradient dz
            dz = rnd(T, C).to(bf16)
            got = wa.window_attention_qkv_epi_bwd(*args, dz, **kw, impl="pallas")
            want = wa.window_attention_qkv_epi_bwd_plain(*args, dz, **kw)
            err, mae = check_grads(f"K4 C={C} mask={masked}", K4_GRADS, got, want)
            ms = median_ms(lambda: wa.window_attention_qkv_epi_bwd(*args, dz, **kw,
                                                                   impl="pallas"))
            pms = median_ms(lambda: wa.window_attention_qkv_epi_bwd_plain(*args, dz, **kw))
            log(f"K4 window_attention_qkv_epi_bwd C={C} T={T} mask={masked}: rel_l2 <= "
                f"{err:.3e} max_abs {mae:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms")
            timed[("window_attention_qkv_epi_bwd", T, C, masked)] = dict(
                rel_l2=err, max_abs_err=mae, ms=ms, plain_ms=pms)

    # K2: the C = 768 bottleneck blocks (one unshifted, one shifted)
    C, h = 768, 24
    T = BATCH * 8 * NSIDE * NSIDE // 4 // 4 ** 3
    qkv = rnd(T, 3 * C).to(bf16)
    bias = rnd(h, WS, WS, std=0.5)
    ls = logit_scales(h)
    groups = ring_groups(T // BATCH).to(dev)
    for masked in (False, True):
        args = (qkv, groups if masked else None, bias, ls)
        kw = dict(ws=WS, num_heads=h, use_cos=True, sm_scale=32 ** -0.5, has_mask=masked)
        got = wa.window_attention(*args, **kw, impl="pallas")
        want = wa.window_attention_plain(*args, **kw)
        err, mae = check_close(f"K2 C={C} mask={masked}", got, want)
        ms = median_ms(lambda: wa.window_attention(*args, **kw, impl="pallas"))
        pms = median_ms(lambda: wa.window_attention_plain(*args, **kw))
        log(f"K2 window_attention C={C} T={T} mask={masked}: rel_l2 {err:.3e} "
            f"max_abs {mae:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms")
        timed[("window_attention", T, C, masked)] = dict(
            rel_l2=err, max_abs_err=mae, ms=ms, plain_ms=pms)

        # K5, its backward, for an output gradient dout
        dout = rnd(T, C).to(bf16)
        got = wa.window_attention_bwd(*args, dout, **kw, impl="pallas")
        want = wa.window_attention_bwd_plain(*args, dout, **kw)
        err, mae = check_grads(f"K5 C={C} mask={masked}", K5_GRADS, got, want)
        ms = median_ms(lambda: wa.window_attention_bwd(*args, dout, **kw, impl="pallas"))
        pms = median_ms(lambda: wa.window_attention_bwd_plain(*args, dout, **kw))
        log(f"K5 window_attention_bwd C={C} T={T} mask={masked}: rel_l2 <= {err:.3e} "
            f"max_abs {mae:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms")
        timed[("window_attention_bwd", T, C, masked)] = dict(
            rel_l2=err, max_abs_err=mae, ms=ms, plain_ms=pms)
    # the scaled-dot flavour (not on the paper path; same kernel)
    kw = dict(ws=WS, num_heads=h, use_cos=False, sm_scale=32 ** -0.5, has_mask=True)
    err, _ = check_close("K2 scaled-dot", wa.window_attention(qkv, groups, bias, None, **kw,
                                                              impl="pallas"),
                         wa.window_attention_plain(qkv, groups, bias, None, **kw))
    log(f"K2 window_attention scaled-dot C={C}: rel_l2 {err:.3e}")
    err, _ = check_grads("K5 scaled-dot", K5_GRADS,
                         wa.window_attention_bwd(qkv, groups, bias, None, dout, **kw,
                                                 impl="pallas"),
                         wa.window_attention_bwd_plain(qkv, groups, bias, None, dout, **kw))
    log(f"K5 window_attention_bwd scaled-dot C={C}: rel_l2 <= {err:.3e}")

    # K3: the decoder tail, T = 262144 tokens, p = 4, F = 10
    C, p, F = 96, 4, N_CLASSES
    T = BATCH * 8 * NSIDE * NSIDE // p
    x = rnd(T, C).to(bf16)
    we, wh = rnd(C, p * C, std=0.02), rnd(C, F, std=0.02)
    g, b = 1.0 + rnd(C, std=0.1), rnd(C, std=0.1)
    args = (x, we, g, b, wh)
    got = fh.final_head_predict(*args, patch_size=p, impl="pallas")
    want = fh.final_head_predict_plain(*args, patch_size=p)
    logits = fh.final_head_logits_plain(*args, patch_size=p)
    mism, near, worst = preds_agree("K3", got, want, logits, logit_slack(fh, x, (we, g, b, wh)))
    ms = median_ms(lambda: fh.final_head_predict(*args, patch_size=p, impl="pallas"))
    pms = median_ms(lambda: fh.final_head_predict_plain(*args, patch_size=p))
    log(f"K3 final_head_predict T={T} C={C} p={p} F={F}: {mism} of {T * p} indices differ, "
        f"all at near-ties ({near} near-tie rows); kernel {ms:.4f} ms plain {pms:.4f} ms")
    # K3 emits class indices: max_abs_err is the largest |kernel - plain| index
    # difference outside near-ties; the near-tie flips are counted on their own
    timed[("final_head_predict", T, C)] = dict(
        max_abs_err=worst, index_mismatches=mism, index_mismatch_share=mism / (T * p),
        near_tie_rows=near, ms=ms, plain_ms=pms)

    # K6 / K7: the fused CE tail and its backward, on the same tail operands
    y = torch.randint(0, F, (T, p), generator=gen, dtype=torch.int32).to(dev)
    welem = (0.5 + torch.rand(F, generator=gen)).to(dev)[y.long()]
    largs = args + (y, welem)
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


def depth_targets(gen, T, p, dev):
    """(T, p) f32 network-space targets, BACKGROUND of them inf."""
    t = torch.randn(T, p, generator=gen)
    bg = torch.rand(T, p, generator=gen) < BACKGROUND
    return torch.where(bg, float("inf"), t).to(dev)


def check_depth_kernels(name, dargs, p, kind, fh, timing=True):
    """K8 (loss sums, predictions) and K9 (every gradient, for a loss gradient of 1)
    against their plain versions on ``dargs`` = (x, we, gamma, beta, wh, t).  The count
    of valid targets exact, the loss sum within LOSS_REL_TOL relative, the bf16
    predictions and the gradients within REL_L2_TOL.  Returns the timings, keyed like
    the launch counters, when ``timing``."""
    x, wh = dargs[0], dargs[4]
    T, C = x.shape
    F = wh.shape[-1]
    kw = dict(patch_size=p, loss_kind=kind, huber_delta=HUBER_DELTA)
    label = f"{name} {kind} F={F}"
    with torch.no_grad():
        num, den, preds = fh.final_head_depth_loss_sums(*dargs, **kw, impl="pallas")
        wnum, wden, wpreds = fh.final_head_depth_loss_plain(*dargs, **kw)
        if float(den) != float(wden) or float(den) != float(torch.isfinite(dargs[5]).sum()):
            raise AssertionError(f"{label}: count {float(den)} vs plain {float(wden)}")
        loss_rel = abs(float(num) - float(wnum)) / abs(float(wnum))
        if not loss_rel <= LOSS_REL_TOL:
            raise AssertionError(f"{label}: loss sum {float(num)} vs plain {float(wnum)}")
        if preds.dtype != x.dtype or tuple(preds.shape) != (T, p * F):
            raise AssertionError(f"{label}: predictions {tuple(preds.shape)} {preds.dtype}")
        perr, pmae = check_close(f"{label} predictions", preds, wpreds)
        scale = torch.ones((), device=x.device) / torch.clamp_min(wden, 1.0)
        got = fh.final_head_depth_loss_bwd(*dargs, scale, **kw, impl="pallas")
        want = fh.final_head_depth_loss_bwd_plain(*dargs, scale, **kw)
        gerr, gmae = check_grads(label, K7_GRADS, got, want)
        if F == 2 and kind != "nll" and float(got[4][:, 1].abs().max()) != 0.0:
            raise AssertionError(f"{label}: the logvar channel got a gradient")
    log(f"{label} final_head_depth_loss T={T} C={C}: loss sum {float(num):.6f} plain "
        f"{float(wnum):.6f} (rel {loss_rel:.2e}), count {int(den)}; predictions rel_l2 "
        f"{perr:.3e} max_abs {pmae:.3e}; backward rel_l2 <= {gerr:.3e} max_abs {gmae:.3e}")
    if not timing:
        return {}
    with torch.no_grad():
        ms8 = median_ms(lambda: fh.final_head_depth_loss_sums(*dargs, **kw, impl="pallas"))
        pms8 = median_ms(lambda: fh.final_head_depth_loss_plain(*dargs, **kw))
        ms9 = median_ms(lambda: fh.final_head_depth_loss_bwd(*dargs, scale, **kw,
                                                             impl="pallas"))
        pms9 = median_ms(lambda: fh.final_head_depth_loss_bwd_plain(*dargs, scale, **kw))
    log(f"K8 final_head_depth_loss T={T} C={C} p={p} F={F} {kind}: kernel {ms8:.4f} ms "
        f"plain {pms8:.4f} ms")
    log(f"K9 final_head_depth_loss_bwd T={T} C={C} p={p} F={F} {kind}: kernel {ms9:.4f} ms "
        f"plain {pms9:.4f} ms")
    # K8's max_abs_err: over its bf16 predictions (its loss sum's relative error apart)
    return {("final_head_depth_loss", T, C, F, kind): dict(
                rel_l2=perr, max_abs_err=pmae, loss_sum_rel_err=loss_rel, ms=ms8,
                plain_ms=pms8),
            ("final_head_depth_loss_bwd", T, C, F, kind): dict(
                rel_l2=gerr, max_abs_err=gmae, ms=ms9, plain_ms=pms9)}


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
    log(f"{name} final_head_loss T={T} C={C}: loss {loss:.6f} plain {wloss:.6f} (rel "
        f"{abs(loss - wloss) / abs(wloss):.2e}); confusion matrix: {moved} of {T * p} "
        f"elements in another column, all near-ties ({near} near-tie elements); "
        f"backward rel_l2 <= {err:.3e} max_abs {mae:.3e}")
    if not timing:
        return {}
    with torch.no_grad():
        ms6 = median_ms(lambda: fh.final_head_loss_sums(*largs, patch_size=p, impl="pallas"))
        pms6 = median_ms(lambda: fh.final_head_loss_plain(*largs, patch_size=p))
        ms7 = median_ms(lambda: fh.final_head_loss_bwd(*largs, scale, patch_size=p,
                                                       impl="pallas"))
        pms7 = median_ms(lambda: fh.final_head_loss_bwd_plain(*largs, scale, patch_size=p))
    log(f"K6 final_head_loss T={T} C={C} p={p}: kernel {ms6:.4f} ms plain {pms6:.4f} ms")
    log(f"K7 final_head_loss_bwd T={T} C={C} p={p}: kernel {ms7:.4f} ms plain {pms7:.4f} ms")
    # K6's max_abs_err: |loss - plain loss|; the confusion matrix's moved elements are
    # counted on their own
    return {("final_head_loss", T, C): dict(max_abs_err=abs(loss - wloss),
                                            confmat_moved=moved, near_tie_elements=near,
                                            ms=ms6, plain_ms=pms6),
            ("final_head_loss_bwd", T, C): dict(rel_l2=err, max_abs_err=mae, ms=ms7,
                                                plain_ms=pms7)}


def build_task(impl, dev, state=None, depth=False):
    """The paper model's segmentation task, or with ``depth`` its depth task (one
    output channel, the masked l2 loss, the paper depth run's data config: no
    transform, standardized, background masked)."""
    from heal_swin_torch.models import tasks as T
    from heal_swin_torch.models.swin_hp import DataSpec, SwinHPTransformerConfig

    # the paper model (heal_swin_tpu bench.py / __graft_entry__.py)
    cfg = SwinHPTransformerConfig(
        patch_size=4, window_size=WS, shift_size=4, shift_strategy="ring_shift",
        rel_pos_bias="flat", embed_dim=96, depths=[2, 2, 6, 2], num_heads=[3, 6, 12, 24],
        use_cos_attn=True, use_v2_norm_placement=True, dtype="bfloat16", gelu_approx=True,
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
    "final_head_loss_bwd", "final_head_depth_loss", "final_head_depth_loss_bwd")}


def read_counters():
    """The kernels' launch counters: (per kernel, per (kernel, T, C[, has_mask]))."""
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.ops import window_attention as wa

    return {**wa.launches, **fh.launches}, wa.launches_by_shape + fh.launches_by_shape


def reset_counters():
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.ops import window_attention as wa

    for mod in (wa, fh):
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


def profile(label, fn, n) -> float:
    """Device time by kernel name over ``n`` calls of ``fn`` under torch.profiler (device
    activity only, to keep the host's overhead low), and the device's idle share under
    the profiler: 1 - (summed device activity) / (wall time).  The work runs on one
    stream, so device activities do not overlap.  Returns the device ms per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
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
    busy = sum(ms for ms, _ in per.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device activity")
    log(f"{label}: {n} calls, wall {wall_ms / n:.3f} ms/call under the profiler, "
        f"device busy {busy / n:.3f} ms/call, idle share {1 - busy / wall_ms:.4f}")
    for name, (ms, cnt) in sorted(per.items(), key=lambda kv: -kv[1][0])[:24]:
        log(f"{label}: {ms / n:9.4f} ms/call {cnt / n:6.1f}/call  {name[:110]}")
    return busy / n


def check_blocks(label, task_k, io):
    """Every block of the kernel path on the plain path's input to that block (``io``,
    from ``record_blocks``): its residual branch (output - input) against the plain
    block's, held to the one-kernel tolerance.  This checks each kernel where the model
    calls it (the operands the model builds: rel-pos bias gather, mask groups, shifts,
    LN) without the drift 22 blocks of random weights add on end to end."""
    if len(io) != 22:
        raise AssertionError(f"{label}: recorded {len(io)} blocks")
    blocks_k = dict(task_k.model.named_modules())
    worst = 0.0
    with torch.no_grad():
        for name, (x, y_p) in io.items():
            y_k = blocks_k[name](x)
            worst = max(worst, check_close(f"{label} block {name}", y_k.float() - x.float(),
                                           y_p.float() - x.float())[0])
    log(f"{label}: each of the {len(io)} blocks on the plain path's input: residual branch "
        f"rel_l2 <= {worst:.3e} (tol {REL_L2_TOL})")


def check_slice(task_k, task_p, imgs, timed):
    """One predict through the kernels (``task_k``) and one through the plain path
    (``task_p``, the same weights), checked against each other.  Returns the kernels'
    launches in the kernel path's predict: per kernel, and per operand shape."""
    from heal_swin_torch.models.tasks import decoder_tail
    from heal_swin_torch.ops import final_head as fh

    expected = dict(NO_LAUNCHES, window_attention_qkv_epi=20, window_attention=2,
                    final_head_predict=1)
    npix = imgs.shape[1]

    # the kernel path: count the launches of one predict, keep the features K3 got
    feats = {}
    keep = task_k.model.register_forward_hook(lambda _m, _a, out: feats.update(k=out))
    reset_counters()
    preds_k = task_k.predict(None, imgs)
    torch.cuda.synchronize()
    launches, by_shape = read_counters()
    keep.remove()
    check_launches("slice predict", launches, by_shape, expected, timed)
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
    mism, near, _ = preds_agree("slice K3", preds_k.reshape(B * N, 4), want, lk,
                                logit_slack(fh, fk, tail))
    log(f"slice: K3 in predict vs the plain tail on its features: {mism} of "
        f"{preds_k.numel()} indices differ, all at near-ties ({near} near-tie rows)")

    # the plain path, keeping every block's input and output and the features
    io = {}
    hooks = record_blocks(task_p.model, io)
    hooks.append(task_p.model.register_forward_hook(lambda _m, _a, out: feats.update(p=out)))
    preds_p = task_p.predict(None, imgs)
    for hk in hooks:
        hk.remove()
    check_blocks("slice", task_k, io)
    del io

    # end to end: per op the two paths differ only by bf16 rounding flips (~2^-8
    # relative on a flipped element); 22 residual blocks and the skips carry those
    # on, so the features are held to a looser bound than one block
    feats_p = feats["p"]
    err = check_close("slice tail=False features", feats_k, feats_p, SLICE_REL_L2_TOL)[0]
    # the same measure for the plain path against itself, its input moved by bf16
    # rounding (2^-9 relative): how much the random-weight network amplifies
    # perturbations of that size
    noise = torch.randn(imgs.shape, generator=torch.Generator().manual_seed(SEED + 2))
    with torch.no_grad():
        feats_n = task_p.model(imgs * (1 + 2.0 ** -9 * noise.to(imgs.device)), tail=False)
    log(f"slice: plain path, input moved by 2^-9 relative: features rel_l2 "
        f"{rel_l2(feats_n, feats_p):.3e}")
    log(f"slice: features rel_l2 {err:.3e} (tol {SLICE_REL_L2_TOL}); "
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


def drive_slice(dev, timed):
    """predict at paper scale through the kernels and through the plain path: checked,
    timed, and traced.  Returns the kernels' launches in one predict: per
    kernel, and per operand shape."""
    imgs = torch.randn(BATCH, 8 * NSIDE * NSIDE, 3,
                       generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    t0 = time.perf_counter()
    task_k = build_task("auto", dev)
    task_p = build_task("xla", dev, state=task_k.model.state_dict())
    log(f"slice: built the paper model twice in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in task_k.model.parameters()):,} parameters")
    launches, by_shape = check_slice(task_k, task_p, imgs, timed)

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    ips_k, mem_k = rate(task_k, imgs)
    ips_p, mem_p = rate(task_p, imgs)
    ips_k2, _ = rate(task_k, imgs)
    log(f"slice: predict kernels {ips_k:.3f} / {ips_k2:.3f} img/s (peak {mem_k:.3f} GiB above "
        f"the resident), plain {ips_p:.3f} img/s (peak {mem_p:.3f} GiB above the resident); "
        f"resident {resident:.3f} GiB (both models' f32 weights and the input)")
    busy = profile("profile", lambda: task_k.predict(None, imgs), PROFILE_PREDICTS)
    wall = BATCH / max(ips_k, ips_k2) * 1e3
    log(f"profile: against the untraced {wall:.3f} ms/predict the device idles "
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
    log(f"{label}: by shape (kernel, T, C[, has_mask | F, kind]): "
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
    expected = dict(NO_LAUNCHES, window_attention_qkv_epi=20, window_attention=2)
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


def drive_train(dev, timed, depth=False):
    """The train step at paper scale through the kernels and through the plain path,
    for segmentation or, with ``depth``, the depth task (after its ``predict``,
    ``drive_depth_predict``): per-block backward and tail checks, one counted step,
    the loss over 5 more steps on one batch, the metrics, the rate and memory of each
    path (kernel, plain, kernel), and a trace of the kernel path's step.  Returns the
    kernels' launches in one train step: per kernel, and per operand shape."""
    from heal_swin_torch.models.tasks import decoder_tail
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.training.optimizer import OptimizerConfig, make_optimizer
    from heal_swin_torch.training.trainer import step_generator, train_step

    label = "depth train" if depth else "train"
    task_k = build_task("auto", dev, depth=depth)
    task_p = build_task("xla", dev, state=task_k.model.state_dict(), depth=depth)
    if depth:
        imgs, metric_depth = depth_batch(dev)
        targets = task_k._to_network(metric_depth)  # standardized with the masked stats
        drive_depth_predict(task_k, task_p, imgs, timed)
        expected = dict(NO_LAUNCHES, final_head_depth_loss=1, final_head_depth_loss_bwd=1)
    else:
        imgs, targets = train_batch(dev)
        expected = dict(NO_LAUNCHES, final_head_loss=1, final_head_loss_bwd=1)
    expected.update(window_attention_qkv_epi=20, window_attention=2,
                    window_attention_qkv_epi_bwd=20, window_attention_bwd=2)
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
    "final_head_loss": ("heal_swin_torch/csrc/final_head.cu",
                        "heal_swin_tpu/ops/final_head.py:755"),
    "final_head_loss_bwd": ("heal_swin_torch/csrc/final_head.cu",
                            "heal_swin_tpu/ops/final_head.py:781"),
    "final_head_depth_loss": ("heal_swin_torch/csrc/final_head.cu",
                              "heal_swin_tpu/ops/final_head.py:568"),
    "final_head_depth_loss_bwd": ("heal_swin_torch/csrc/final_head.cu",
                                  "heal_swin_tpu/ops/final_head.py:593"),
}


def kernel_results(timed, runs):
    """The per-kernel results line.  ``runs``: kernel -> (launches per kernel, per
    shape) of the run that uses it.  Each kernel's launches in that run, and its times
    summed over the shapes that run launched it at, each shape weighted by its launches
    there."""
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        launches, by_shape = runs[name]
        shapes = []
        for key, n in sorted(by_shape.items()):
            if key[0] == name:
                shape = dict(T=key[1], C=key[2])
                if len(key) == 4:
                    shape["mask"] = key[3]
                elif len(key) == 5:
                    shape.update(F=key[3], kind=key[4])
                shapes.append(dict(shape, launches=n, **timed[key]))
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in shapes),
            ms=sum(r["ms"] * r["launches"] for r in shapes),
            plain_ms=sum(r["plain_ms"] * r["launches"] for r in shapes),
            shapes=shapes))
    return kernels


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
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas:", line.strip())

    timed = check_kernels(torch.Generator().manual_seed(SEED), dev)
    predict_run = drive_slice(dev, timed)
    torch.cuda.empty_cache()
    train_run = drive_train(dev, timed)
    torch.cuda.empty_cache()
    depth_run = drive_train(dev, timed, depth=True)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    runs = {name: train_run for name in SOURCES}
    runs["final_head_predict"] = predict_run
    runs["final_head_depth_loss"] = runs["final_head_depth_loss_bwd"] = depth_run
    kernels = kernel_results(timed, runs)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
