"""`moby-compare-trajs` equivalent: L-inf comparison of two trajectory files
(counterpart of ``moby_tpu/cli/compare.py``; numpy only).

Mirrors programs/compare-trajs.cpp: reads two `t q...` trajectory files
(ignoring each file's trailing wall-clock line), computes the maximum absolute
difference over all shared lines/columns, and exits 1 if above tolerance.

Usage: python -m moby_tpu_torch.cli.compare ref.dat new.dat tol
"""

from __future__ import annotations

import sys

import numpy as np


def load_traj(path):
    rows = []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if not vals:
                continue
            rows.append([float(v) for v in vals])
    # drop the trailing timing line (single value)
    if rows and len(rows[-1]) == 1:
        rows = rows[:-1]
    return rows


def compare(ref_path, new_path):
    """(max |ref − new|, (line, column) where it is reached, lines compared)."""
    ref = load_traj(ref_path)
    new = load_traj(new_path)
    n = min(len(ref), len(new))
    max_err = 0.0
    where = None
    for i in range(n):
        m = min(len(ref[i]), len(new[i]))
        d = np.abs(np.array(ref[i][:m]) - np.array(new[i][:m]))
        if d.size and float(d.max()) > max_err:
            max_err = float(d.max())
            where = (i, int(d.argmax()))
    return max_err, where, n


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3:
        print(__doc__)
        return 2
    tol = float(argv[2])
    max_err, where, n = compare(argv[0], argv[1])
    print(f"L-inf error: {max_err:g} over {n} lines (worst at line {where})")
    if max_err > tol:
        print(f"FAIL: exceeds tolerance {tol:g}")
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
