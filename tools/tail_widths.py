"""The tail widths phase of ``chip_smoke.py`` alone, on the card.

    python3 tools/tail_widths.py          # needs one CUDA GPU
    python3 tools/tail_widths.py --grid   # K7 against plain over the row cores' grid

Builds the kernels, logs the ptxas report of the tail kernels (the row cores'
``tail_*`` kernels of ``csrc/final_head.cu`` and ``csrc/tail_f32.cuh``, the wide route's of
``csrc/final_head_wide.cu``, and ``gemm_nt_kernel`` / ``gemm_tn_kernel``), then runs
``drive_tail_widths`` as ``chip_smoke.py`` runs it: the ten tail kernels (K3, K6-K9, bf16
and f32) against their plain versions at ``WIDTH_CASES`` and ``WIDTH_DEPTH_CASES``, each on
the route ``row_core_takes`` names, then path (a) (the paper f32 config on SynWoodScape's
25 classes) and path (b) (a bf16 model at embed 128), both tails on the row cores, and
prints the results line's "widths" rows.  The launch checks of the paths
hold the counts; their rule that every launched shape was checked earlier in the run reads
the earlier phases' results, which this script does not run.  Every check raises on a
failure; the last line says ``tail widths done``.

With ``--grid`` it runs instead K7 against its plain version over the grid of the GPU
tests' ``test_tail_kernels_at_the_row_core_widths`` (C 32-128, F 8-128, p 1, 4, 16, bf16
and f32, T 64 * 65; F 1 has no gradient) on ``width_inputs`` operands, and logs the
largest relative L2 of each gradient by dtype, head form (bf16: F <= 32 in one piece,
above in chunks of 32; f32: F <= 16 in one piece, above in chunks of 16) and route, with
the shape that gave it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

TAIL_PTXAS = ("tail_", "final_head_wide", "gemm_nt_kernel", "gemm_tn_kernel")


def counts_only(label, launches, by_shape, expected, timed):
    c.log(f"{label}: kernel launches: {launches}")
    c.log(f"{label}: by shape: {dict(sorted(by_shape.items(), key=str))}")
    if launches != expected:
        raise AssertionError(f"{label}: launch counts {launches} != {expected}")


GRID_CS = (32, 64, 96, 128)
GRID_FS = (8, 10, 16, 17, 25, 32, 33, 64, 128)
GRID_PS = (1, 4, 16)


def rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def k7_grid():
    """The largest relative L2 of each K7 gradient against its plain version over the
    grid, by (dtype, head form, route); logged with the shape that gave it."""
    from heal_swin_torch.ops import final_head as fh

    dev = torch.device("cuda", 0)
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        for C in GRID_CS:
            for F in GRID_FS:
                for p in GRID_PS:
                    gen = torch.Generator().manual_seed(1000 + 7 * C + 3 * F + p + f32)
                    largs = c.width_inputs(gen, dev, 64 * 65, C, F, p, dtype)
                    scale = torch.tensor(0.9, device=dev) / largs[6].sum()
                    got = fh.final_head_loss_bwd(*largs, scale, patch_size=p)
                    want = fh.final_head_loss_bwd_plain(*largs, scale, patch_size=p)
                    piece = F <= (16 if f32 else 32)
                    key = ("f32" if f32 else "bf16", "one piece" if piece else "chunked",
                           c.tail_route_name(fh, "loss_bwd", C, F, p, f32))
                    for name, g, w in zip(c.K7_GRADS, got, want):
                        e = rel_l2(g, w)
                        if e > worst.get(key + (name,), (-1.0,))[0]:
                            worst[key + (name,)] = (e, (C, F, p))
    for key, (e, shape) in sorted(worst.items()):
        c.log(f"K7 grid {' '.join(key)}: relative L2 <= {e:.4e} at (C, F, p) {shape}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", action="store_true", help="K7 against plain over the grid")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("tail_widths: no CUDA device", file=sys.stderr)
        return 1
    from heal_swin_torch import _build

    c.log(c.nvidia_smi())
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: full f32 products
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.lib()
    c.log(f"build {time.perf_counter() - t0:.1f} s")
    name = None
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            name = name if any(k in name for k in TAIL_PTXAS) else None
        elif name and ("spill" in line or "registers" in line):
            c.log(f"ptxas {name[:120]}: {line.split(':', 1)[-1].strip()}")
    if a.grid:
        k7_grid()
        c.log("tail widths done")
        return 0
    c.check_launches = counts_only
    t = time.perf_counter()
    res = c.drive_tail_widths(torch.device("cuda", 0), {})
    c.log(f"drive_tail_widths {time.perf_counter() - t:.1f} s")
    c.log(json.dumps({"kernels": c.width_results(*res)}))
    c.log("tail widths done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
