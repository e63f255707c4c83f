"""On-GPU smoke check of heal_swin_torch: builds the CUDA kernels from the checkout,
holds each against its plain PyTorch version at the shapes of the serving path, then
drives HEAL-SWIN-UNet segmentation ``predict`` at the paper configuration (nside 256,
batch 2, bf16, random seeded weights) through the kernels and through the plain path.

    python3 chip_smoke.py            # needs one CUDA GPU; exits non-zero otherwise

Prints its findings line by line, a JSON line of per-kernel results, and ends with
{"ok": true, "device": {...}}.  Any failed check raises, so the exit code is non-zero.

The kernels' launch counters (``launches``, and ``launches_by_shape`` per operand
shape) are read from one predict call; each kernel's ``ms`` / ``plain_ms`` is the sum,
over the shapes that predict launched it at, of the median time of one call at that
shape times the number of such launches.  A torch.profiler trace of predict gives the
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
SLICE_REL_L2_TOL = 5e-2  # tail=False features after 22 blocks (see check_slice)
TIMING_RUNS = 20
PROFILE_PREDICTS = 5


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
    err = rel_l2(got, want)
    mae = float((got.float() - want.float()).abs().max())
    if not (torch.isfinite(got.float()).all() and err <= tol):
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
    """Each kernel against its plain version at the serving path's shapes.  Returns the
    measures of each shape, keyed as the wrappers' ``launches_by_shape`` counters are:
    (kernel, T, C, has_mask) for the attention kernels, (kernel, T, C) for K3."""
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
    # the scaled-dot flavour (not on the paper path; same kernel)
    kw = dict(ws=WS, num_heads=h, use_cos=False, sm_scale=32 ** -0.5, has_mask=True)
    err, _ = check_close("K2 scaled-dot", wa.window_attention(qkv, groups, bias, None, **kw,
                                                              impl="pallas"),
                         wa.window_attention_plain(qkv, groups, bias, None, **kw))
    log(f"K2 window_attention scaled-dot C={C}: rel_l2 {err:.3e}")

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
    return timed


def build_task(impl, dev, state=None):
    from heal_swin_torch.models.swin_hp import DataSpec, SwinHPTransformerConfig
    from heal_swin_torch.models.tasks import (
        WoodscapeSegmenterSwinHP,
        WoodscapeSegmenterSwinHPConfig,
    )

    # the paper model (heal_swin_tpu bench.py / __graft_entry__.py)
    cfg = SwinHPTransformerConfig(
        patch_size=4, window_size=WS, shift_size=4, shift_strategy="ring_shift",
        rel_pos_bias="flat", embed_dim=96, depths=[2, 2, 6, 2], num_heads=[3, 6, 12, 24],
        use_cos_attn=True, use_v2_norm_placement=True, dtype="bfloat16", gelu_approx=True,
        fused_final_head=True, attention_impl=impl)
    spec = DataSpec(dim_in=8 * NSIDE * NSIDE, f_in=3, f_out=N_CLASSES, base_pix=8)
    gen = torch.Generator().manual_seed(SEED)
    task = WoodscapeSegmenterSwinHP(WoodscapeSegmenterSwinHPConfig(cfg), spec, device=dev,
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


def profile_predict(task, imgs, n=PROFILE_PREDICTS) -> float:
    """Device time by kernel name over ``n`` predict calls under torch.profiler (device
    activity only, to keep the host's overhead low), and the device's idle share under
    the profiler: 1 - (summed device activity) / (wall time).  The work runs on one
    stream, so device activities do not overlap.  Returns the device ms per predict."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    task.predict(None, imgs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            task.predict(None, imgs)
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
    log(f"profile: {n} predicts, wall {wall_ms / n:.3f} ms/predict under the profiler, "
        f"device busy {busy / n:.3f} ms/predict, idle share {1 - busy / wall_ms:.4f}")
    for name, (ms, cnt) in sorted(per.items(), key=lambda kv: -kv[1][0])[:16]:
        log(f"profile: {ms / n:9.4f} ms/predict {cnt / n:6.1f}/predict  {name[:110]}")
    return busy / n


def check_slice(task_k, task_p, imgs, timed):
    """One predict through the kernels (``task_k``) and one through the plain path
    (``task_p``, the same weights), checked against each other.  Returns the kernels'
    launches in the kernel path's predict: per kernel, and per operand shape."""
    from heal_swin_torch.ops import final_head as fh
    from heal_swin_torch.ops import window_attention as wa

    expected = {"window_attention_qkv_epi": 20, "window_attention": 2, "final_head_predict": 1}
    npix = imgs.shape[1]

    # the kernel path: count the launches of one predict, keep the features K3 got
    feats = {}
    keep = task_k.model.register_forward_hook(lambda _m, _a, out: feats.update(k=out))
    reset_counters()
    preds_k = task_k.predict(None, imgs)
    torch.cuda.synchronize()
    launches = {**wa.launches, **fh.launches}
    by_shape = wa.launches_by_shape + fh.launches_by_shape
    keep.remove()
    log(f"slice: kernel launches in one predict: {launches}")
    log(f"slice: by shape (kernel, T, C[, has_mask]): {dict(sorted(by_shape.items()))}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    unchecked = sorted(set(by_shape) - set(timed))
    if unchecked:
        raise AssertionError(f"predict launched kernels at shapes not checked: {unchecked}")
    if preds_k.shape != (BATCH, npix) or preds_k.dtype != torch.int32:
        raise AssertionError(f"predict gave {tuple(preds_k.shape)} {preds_k.dtype}")
    if int(preds_k.min()) < 0 or int(preds_k.max()) >= N_CLASSES:
        raise AssertionError("predicted class out of range")

    # K3 inside predict: its indices against the plain decoder tail on the very
    # features it was given, with only K3's own rounding as near-tie slack
    feats_k = feats["k"]
    B, N, C = feats_k.shape
    dec = task_k.model.decoder
    tail = (dec.up.expand.weight.t(), dec.up.norm.weight, dec.up.norm.bias,
            dec.output.weight[:, :, 0].t())
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
    if len(io) != expected["window_attention_qkv_epi"] + expected["window_attention"]:
        raise AssertionError(f"recorded {len(io)} blocks")

    # every block of the kernel path on the plain path's input to that block: its
    # residual branch (output - input) against the plain block's, held to the
    # one-kernel tolerance.  This checks each kernel where the model calls it (the
    # operands the model builds: rel-pos bias gather, mask groups, shifts, LN) without
    # the drift 22 blocks of random weights add on end to end.
    blocks_k = dict(task_k.model.named_modules())
    worst = 0.0
    with torch.no_grad():
        for name, (x, y_p) in io.items():
            y_k = blocks_k[name](x)
            worst = max(worst, check_close(f"block {name}", y_k.float() - x.float(),
                                           y_p.float() - x.float())[0])
    log(f"slice: each of the {len(io)} blocks on the plain path's input: residual branch "
        f"rel_l2 <= {worst:.3e} (tol {REL_L2_TOL})")
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
    busy = profile_predict(task_k, imgs)
    wall = BATCH / max(ips_k, ips_k2) * 1e3
    log(f"profile: against the untraced {wall:.3f} ms/predict the device idles "
        f"{1 - busy / wall:.4f} of the time")
    return launches, by_shape


def kernel_results(timed, launches, by_shape):
    """The per-kernel results line: each kernel's launches in the predict run, and
    its times summed over the shapes predict launched it at, each shape weighted by
    its launches there."""
    source = {"window_attention_qkv_epi": "heal_swin_torch/csrc/window_attention.cu",
              "window_attention": "heal_swin_torch/csrc/window_attention.cu",
              "final_head_predict": "heal_swin_torch/csrc/final_head.cu"}
    replaces = {"window_attention_qkv_epi": "heal_swin_tpu/ops/window_attention.py:993",
                "window_attention": "heal_swin_tpu/ops/window_attention.py:677",
                "final_head_predict": "heal_swin_tpu/ops/final_head.py:191"}
    kernels = []
    for name in source:
        shapes = []
        for key, n in sorted(by_shape.items()):
            if key[0] == name:
                shape = dict(T=key[1], C=key[2])
                if len(key) > 3:
                    shape["mask"] = key[3]
                shapes.append(dict(shape, launches=n, **timed[key]))
        kernels.append(dict(
            name=name, route="cuda", source=source[name], replaces=replaces[name],
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
    launches, by_shape = drive_slice(dev, timed)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = kernel_results(timed, launches, by_shape)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
