"""The tail widths phase of ``chip_smoke.py`` alone, on the card.

    python3 tools/tail_widths.py   # needs one CUDA GPU

Builds the kernels, logs the ptxas report of the wide route's kernels
(``csrc/final_head_wide.cu``, and ``gemm_nt_kernel`` / ``gemm_tn_kernel``), then runs
``drive_tail_widths`` as ``chip_smoke.py`` runs it: the ten tail kernels (K3, K6-K9, bf16
and f32) against their plain versions at ``WIDTH_CASES`` and ``WIDTH_DEPTH_CASES``, then
path (a) (the paper f32 config on SynWoodScape's 25 classes) and path (b) (a bf16 model at
embed 128), and prints the results line's "widths" rows.  The launch checks of the paths
hold the counts; their rule that every launched shape was checked earlier in the run reads
the earlier phases' results, which this script does not run.  Every check raises on a
failure; the last line says ``tail widths done``.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

WIDE_PTXAS = ("tail_rows_kernel", "final_head_wide", "gemm_nt_kernel", "gemm_tn_kernel")


def counts_only(label, launches, by_shape, expected, timed):
    c.log(f"{label}: kernel launches: {launches}")
    c.log(f"{label}: by shape: {dict(sorted(by_shape.items(), key=str))}")
    if launches != expected:
        raise AssertionError(f"{label}: launch counts {launches} != {expected}")


def main():
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
            name = name if any(k in name for k in WIDE_PTXAS) else None
        elif name and ("spill" in line or "registers" in line):
            c.log(f"ptxas {name[:120]}: {line.split(':', 1)[-1].strip()}")
    c.check_launches = counts_only
    t = time.perf_counter()
    res = c.drive_tail_widths(torch.device("cuda", 0), {})
    c.log(f"drive_tail_widths {time.perf_counter() - t:.1f} s")
    c.log(json.dumps({"kernels": c.width_results(*res)}))
    c.log("tail widths done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
