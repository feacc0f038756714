"""The KG main path of several checkouts, in turns on one card.

    python3 scripts/compare_windows.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repository (an unpacked
``git archive`` of another commit, or ``.``). For each, in the order given,
a process of its own builds that checkout's kernels and runs its
``chip_smoke.py`` phases 2 and 3 (``main_path``: LUBM(10) on 8 shards, the
windows before and after the adaptation round, each held against the numpy
executor; ``profile_window``: the window again at the final layout under
``cProfile`` and ``torch.profiler``), so that window wall times, device
busy time and the join kernels' device time of two versions are read on
the same card and host. Needs a CUDA card; exits nonzero when a run fails.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

RUN = """
import sys, time
sys.path[:0] = ["src", "."]
import chip_smoke
from repro_torch.kernels import _build
t = time.perf_counter()
_build.build()
_build.library()
print(f"[compare] kernels built in {time.perf_counter() - t:.1f} s")
rec = {"join_total": -1, "pack_n": -1, "probe_n": -1, "fed_total": -1}
_, svc, window = chip_smoke.main_path(rec)
chip_smoke.profile_window(svc, window)
print(f"[compare] {chip_smoke.card()}")
"""


def main(trees) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        root = pathlib.Path(tree).resolve()
        print(f"[compare] === {root}", flush=True)
        code = subprocess.run([sys.executable, "-c", RUN], cwd=root).returncode
        if code:
            print(f"[compare] {root} failed with exit code {code}",
                  file=sys.stderr)
            return code
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
