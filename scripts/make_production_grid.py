"""Generate a production-scale level-list input grid for the CLI.

128^3 base + 3 refined levels (effective 1024^3) with clustered spherical
refinement — the reference's production regime
(/root/reference/inputParameters:3 with deep nesting) as a REAL ingestable
input: per-level cell lists (pos, logT, log nH, log xHI) in the npz schema
io.grid_io reads, plus a source list and a mode-8 inputParameters file.
`--levels 1` writes the uniform 128^3 grid alone.

    python scripts/make_production_grid.py --out <dir> [--n 128] [--levels 4]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--box-kpc", type=float, default=1200.0)
    ap.add_argument("--n-src", type=int, default=8)
    args = ap.parse_args(argv)

    from radiativetransfer_tpu.io import grid_io
    sys.path.insert(0, os.path.dirname(__file__))
    from deep_amr_production import clumpy_refinement

    os.makedirs(args.out, exist_ok=True)
    n, L, box = args.n, args.levels, args.box_kpc
    rng = np.random.default_rng(0)

    from radiativetransfer_tpu.core import amr  # noqa: F401 (balance dep)
    refined = clumpy_refinement(
        n, L, rng, centers_frac=((0.5, 0.5, 0.5), (0.22, 0.7, 0.35)))

    levels = []
    # level 1: the full base grid
    idx = np.indices((n, n, n)).reshape(3, -1).T.astype(np.int64)
    for ell in range(L):
        m = n * 2 ** ell
        ncell = idx.shape[0]
        pos = ((idx + 0.5) / m * box - box / 2).astype(np.float32)
        r = np.sqrt((pos ** 2).sum(axis=1))
        nh = (2e-4 * (1.0 + (r / (0.1 * box)) ** 2) ** -1
              * rng.lognormal(0.0, 0.8, ncell)) * 4.0 ** ell
        levels.append(grid_io.LevelData(
            pos=pos,
            lT=np.full(ncell, 4.0, np.float32),
            lnH=np.log10(nh).astype(np.float32),
            lx=np.zeros(ncell, np.float32)))
        print(f"level {ell + 1}: {ncell:,} cells")
        if ell < L - 1:
            # next level's cells: the 8 children of every refined parent
            par = np.argwhere(refined[ell]).astype(np.int64)
            child = (par[:, None, :] * 2
                     + np.array(list(np.ndindex(2, 2, 2)))[None])
            idx = child.reshape(-1, 3)

    grid_io.write_level_npz(os.path.join(args.out, "prodgrid.npz"), levels)

    # sources: young stars inside the refined core, ages < 34 Myr
    src = rng.uniform(0.45, 0.55, (args.n_src, 3)) * box - box / 2
    with open(os.path.join(args.out, "prodsources.dat"), "w") as fh:
        for i in range(args.n_src):
            fh.write(f"{L} {src[i, 0]:.4f} {src[i, 1]:.4f} "
                     f"{src[i, 2]:.4f} {10.0 + i:.1f}\n")

    with open(os.path.join(args.out, "inputParameters"), "w") as fh:
        fh.write(f"""grid = 'prodgrid'
sources = 'prodsources.dat'
mode = 8
dustApproximation = 0
selfShieldingThreshold = 0.01
massStellarParticle = 1
upperAgeLimit = 34.0
restart = 0
restartCellArrayName = ''
reionizationModel = 10
currentRedshift = 6.55
uvbCoefficient = 1.0
sphDir = '{args.out}'
synthesisDir = '{args.out}'
""")
    total = sum(lv.ncell for lv in levels)
    print(f"wrote {args.out}: {total:,} input cells, {args.n_src} sources")


if __name__ == "__main__":
    main()
