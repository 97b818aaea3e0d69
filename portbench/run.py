"""The benchmark of ``qpsk_tpu_torch``: one run of one cell.

    python3 -m portbench --workload W --seed N --seconds S --trace 0|1

from the root of a checkout.  It prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit; the same numbers are the
last lines of standard error.  It exits non-zero, printing no result,
without a CUDA device, or if ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``qpsk_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "qpsk_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``qpsk_tpu_torch`` is not
    ``qpsk_tpu``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _caches(root: pathlib.Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = root / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench",
                                 description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = pathlib.Path.cwd()
    _caches(root)

    import torch

    from portbench import harness
    from portbench.cell import load

    chips = next(w["chips"] for w in json.loads(
        (root / "BENCHMARK.json").read_text())["workloads"]
        if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    load(root, args.workload)
    torch.set_num_threads(1)
    result = harness.run(root, args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    info = result.pop("info")
    for k, v in info.items():
        print(f"info {k} {v}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} <= {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
