"""Kernels B3a-B3d built in several layouts, timed in turns on one card.

    python -m biscotti_tpu_torch.tools.ladder_ab [--variants NAME,...]
                                                 [--other PATH ...]
                                                 [--rounds 2] [--cases KIND,...]

`csrc/ed25519_ladder.cu` fixes each ladder's layout in compile-time
constants: B3a's threads a lane (`kMsmGroup`) and a block
(`kMsmThreads`), B3b's threads a product group (`kWalkGroup`, four groups
a lane), B3c's threads a block (`kCellThreads`, one thread a cell), B3d's
threads a point add (`kAddGroup`), a block of the pointwise add
(`kAddThreads`) and groups a tree block (`kTreeGroups`). Each variant of
VARIANTS is a copy of the source with some of those constants rewritten,
written under `build/ladder_ab/` and built with the library's nvcc flags,
all at once; `--other PATH` adds another source (such as an earlier
commit's file unpacked by git) with the C interface of B3a-B3d, with or
without the tree launches (given again, "other1", ...). Then each library
runs each case alone (the C interface on inputs made once; CUDA events,
median of 20 calls) at the shapes the crypto plane gives them:

  msm       B3a at the settle's 8,192 lanes and at 32 and 128 (an msm of
            8-100 points)
  walk      B3b at the Pedersen comb's 1 x 512 steps and fixed_base_mult's
            4 x 256
  add       B3d, ext_add's 7,850 pairs
  tree      B3d, the msm's tree at 8,192 lanes, as `tree_sum` runs it: one
            output a launch, from the caching allocator (at most two tree
            launches; a library without them: one add a level)
  cells     B3c, the wave's 64 x 7,850 cells, verdicts and points
  gridtree  the wave's tree over 64 grids: the grid tree from the cells and
            the grid mask (a library without it: one add a level over B3c's
            points, masked)
  grid_sum  `grid_sum` whole at 64 x 7,850 (B3c, the mask, the tree), as
            this tree's wrapper runs it, or as the wrapper before the tree
            launches did (B3c's points, an index-put, one add a level)

The libraries run in turns, forward then backward, `rounds` times, so that
the card's clock and neighbours weigh on all alike. Every library's
outputs are held to the reference library's (this tree's build), bit for
bit. Prints one JSON line: each library's layout, the ptxas report
(registers, spills) of each kernel's instances, the SASS mix of B3c's and
B3d's kernels, whether its outputs equal, its times in turn order and
their median a case, and the card's name and power limit as nvidia-smi
prints them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from biscotti_tpu_torch import _build, bench
from biscotti_tpu_torch.crypto import ed25519 as ed
from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
from biscotti_tpu_torch.crypto.kernels import field as fe
from biscotti_tpu_torch.crypto.kernels import group as gp
from biscotti_tpu_torch.crypto.kernels import primitives as prim
from biscotti_tpu_torch.crypto.kernels.cells import ladder_lanes, wire_grids
from biscotti_tpu_torch.eval.eval_krum_kernel import time_ms

NAME = "ed25519_ladder"
# variant: {constant: value}; "this" is the source as it stands
VARIANTS = {
    "this": {},
    "msm_g4": {"kMsmGroup": 4},
    "msm_g8": {"kMsmGroup": 8},
    "msm_g16": {"kMsmGroup": 16},
    "walk_g4": {"kWalkGroup": 4},
    "walk_g8": {"kWalkGroup": 8},
    "walk_g16": {"kWalkGroup": 16},
    "add_g4": {"kAddGroup": 4},
    "add_g8": {"kAddGroup": 8},
}
MSM_LANES = (8192, 128, 32)
WALK_SHAPES = ((1, 512), (4, 256))
ADD_PAIRS = 7850
TREE_LANES = 8192
WAVE = (64, 7850)
CASES = ("msm", "walk", "add", "tree", "cells", "gridtree", "grid_sum")
KERNELS = ("msm_ladder_kernel", "fixed_walk_kernel", "grid_points_kernel",
           "point_add_kernel")
SASS = ("grid_points_kernel", "point_add_kernel")
CONSTANTS = ("kMsmGroup", "kMsmThreads", "kWalkGroup", "kCellThreads",
             "kAddGroup", "kAddThreads", "kTreeGroups")


def variant_source(name: str) -> Path:
    """This tree's source with VARIANTS[name]'s constants rewritten, under
    build/ladder_ab/ (the source itself for "this")."""
    src = _build.source(NAME)
    if not VARIANTS[name]:
        return src
    text = src.read_text()
    for const, value in VARIANTS[name].items():
        text, n = re.subn(rf"(constexpr int {const} = )\d+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"{const} is not one constant of {src.name}")
    out = _build.BUILD / "ladder_ab" / f"{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def layout(text: str) -> dict:
    """{constant: value} of the layout constants a ladder source's text
    holds (an earlier source holds fewer)."""
    out = {}
    for const in CONSTANTS:
        m = re.search(rf"constexpr int {const} = (\d+);", text)
        if m is not None:
            out[const] = int(m.group(1))
    if "kMsmGroup" not in out:
        raise ValueError("no constant kMsmGroup in the ladder source")
    return out


def _library(src: Path):
    """(library, {kernel: {instance: ptxas report}}, {kernel: SASS mix})."""
    out = _build.digest_path(f"{NAME}-{src.stem}", src, _build.NVCC_FLAGS)
    log = _build.compile_once(_build.nvcc(), _build.NVCC_FLAGS, src, out)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    report = _build.ptxas_report(log)
    return (lib, {k: {fn: r for fn, r in report.items() if k in fn}
                  for k in KERNELS},
            {k: _build.sass_mix(out, k) for k in SASS})


def _trees(lib) -> bool:
    return hasattr(lib, "ed25519_point_tree")


def _declare(lib) -> None:
    """This tree's C signatures (`_build`'s), or, for a library built from
    a source before the tree launches, those of its four entries."""
    if _trees(lib):
        _build.SIGNATURES[NAME](lib)
        return
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.ed25519_msm_ladder, lib.ed25519_fixed_walk):
        fn.argtypes = [p, i, p, p, p, n, p]
        fn.restype = ctypes.c_int
    for fn in (lib.ed25519_grid_points, lib.ed25519_point_add):
        fn.argtypes = [p, p, p, p, n, p]
        fn.restype = ctypes.c_int


def inputs(dev: torch.device) -> dict:
    """The seeded inputs on the card: {(kind, shape): tensors}."""
    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    cases = {}
    for m in MSM_LANES:
        scalars, limbs = ladder_lanes(m, seed=m)
        bits, pts = prim._norm_scalar_point(scalars, limbs)
        cases[("msm", m)] = (on(cl.pack_bits(bits)), on(pts))
    rng = np.random.default_rng(0)
    for m, steps in WALK_SHAPES:
        scalars = [int.from_bytes(rng.bytes(32), "little") % ed.Q
                   for _ in range(m * steps // 256)]
        bits = np.concatenate([fe.scalars_to_bits(scalars[i::m],
                                                  msb_first=False)
                               for i in range(m)]).reshape(m, steps)
        table = np.concatenate([prim._fixed_table(w)
                                for w in "BH"][:steps // 256])
        cases[("walk", (m, steps))] = (on(cl.pack_bits(bits)), on(table))
    _, limbs = ladder_lanes(ADD_PAIRS, seed=1)
    a = prim.point_neg_limbs(limbs)
    cases[("add", ADD_PAIRS)] = (on(a), on(np.roll(limbs, 1, axis=0)))
    cases[("tree", TREE_LANES)] = (cases[("msm", TREE_LANES)][1],)
    xy = on(wire_grids(*WAVE, seed=3))
    for kind in ("cells", "gridtree", "grid_sum"):
        cases[(kind, WAVE)] = (xy,)
    return cases


def _point_levels(lib, pts, flag, stream):
    """A tree one add a level, a fresh output each (as `tree_sum` ran
    before the tree launches)."""
    n = pts.shape[0]
    while n > 1:
        half = n // 2
        out = torch.empty((half,) + pts.shape[1:], dtype=torch.int64,
                          device=pts.device)
        rc = lib.ed25519_point_add(pts.data_ptr(), pts[half:].data_ptr(),
                                   out.data_ptr(), flag.data_ptr(),
                                   out.numel() // 64, stream)
        if rc != 0:
            raise RuntimeError(f"point_add launch failed: {rc}")
        pts, n = out, half
    return pts[0]


def launcher(lib, case, args, flag):
    """A function that runs `case` once on `lib` and returns its outputs
    (the last call's, as tensors)."""
    kind, shape = case
    dev = args[0].device
    stream = torch.cuda.current_stream().cuda_stream

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"{case} launch failed: {rc}")

    if kind in ("msm", "walk"):
        bits, pts = args
        out = torch.empty((bits.shape[0], 4, 16), dtype=torch.int64,
                          device=dev)
        entry = lib.ed25519_msm_ladder if kind == "msm" \
            else lib.ed25519_fixed_walk

        def run():
            check(entry(bits.data_ptr(), bits.shape[1], pts.data_ptr(),
                        out.data_ptr(), flag.data_ptr(), bits.shape[0],
                        stream))
            return (out,)
        return run
    if kind == "add":
        a, b = args
        out = torch.empty_like(a)

        def run():
            check(lib.ed25519_point_add(a.data_ptr(), b.data_ptr(),
                                        out.data_ptr(), flag.data_ptr(),
                                        len(a), stream))
            return (out,)
        return run
    if kind == "tree":
        (pts,) = args
        if _trees(lib):
            return lambda: (cl.tree_launches(lib, pts, len(pts), 1, flag,
                                            stream)[0][0],)
        return lambda: (_point_levels(lib, pts, flag, stream),)
    (xy,) = args
    w, n = xy.shape[:2]
    ok = torch.empty((w, n), dtype=torch.bool, device=dev)
    pts = torch.empty((w, n, 4, 16), dtype=torch.int64, device=dev)

    def cells(points=True):
        check(lib.ed25519_grid_points(xy.data_ptr(), ok.data_ptr(),
                                      pts.data_ptr() if points else None,
                                      flag.data_ptr(), w * n, stream))

    def masked():
        cells()
        grid_ok = ok.all(dim=1)
        pts[~grid_ok] = gp.identity_on((), dev)
        return grid_ok

    if kind == "cells":
        def run():
            cells()
            return ok, pts
        return run
    if kind == "gridtree":  # the tree alone, its inputs made once
        if _trees(lib):
            cells(points=False)
            grid_ok = ok.all(dim=1)
            return lambda: (cl.tree_launches(lib, xy, w, n, flag, stream,
                                            grid_ok)[0],)
        masked()
        return lambda: (_point_levels(lib, pts, flag, stream),)
    if _trees(lib):
        def run():
            cells(points=False)
            grid_ok = ok.all(dim=1)
            return grid_ok, cl.tree_launches(lib, xy, w, n, flag, stream,
                                             grid_ok)[0]
        return run

    def run():
        grid_ok = masked()
        return grid_ok, _point_levels(lib, pts, flag, stream)
    return run


def run(names, others, rounds: int, kinds) -> dict:
    dev = torch.device("cuda", 0)
    sources = {n: variant_source(n) for n in names}
    for k, path in enumerate(others):
        sources["other" if k == 0 else f"other{k}"] = path
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each
        built = dict(zip(sources, pool.map(_library, sources.values())))
    cases = {c: a for c, a in inputs(dev).items() if c[0] in kinds}
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    launch = {(v, c): launcher(built[v][0], c, args, flag)
              for v in built for c, args in cases.items()}
    outs = {key: [t.clone() for t in fn()] for key, fn in launch.items()}
    torch.cuda.synchronize()
    if int(flag):
        raise AssertionError("a ladder flagged a limb of its seeded inputs")
    ref = "this" if "this" in built else next(iter(built))
    label = {c: f"{c[0]} {c[1]}" for c in cases}
    equal = {v: {label[c]: all(torch.equal(g, w) for g, w in
                               zip(outs[(v, c)], outs[(ref, c)]))
                 for c in cases} for v in built}
    times = {v: {label[c]: [] for c in cases} for v in built}
    order = list(built)
    for _ in range(rounds):
        for v in order + order[::-1]:
            for c in cases:
                times[v][label[c]].append(time_ms(launch[(v, c)]))
    return {"reps": 20, "rounds": rounds, "reference": ref,
            "layouts": {v: layout(sources[v].read_text()) for v in built},
            "tree_launches": _trees(built[ref][0]),
            "ptxas": {v: built[v][1] for v in built},
            "sass": {v: built[v][2] for v in built},
            "equal_to_reference": equal,
            "kernel_only_ms": times,
            "median_ms": {v: {c: statistics.median(t) for c, t in ts.items()}
                          for v, ts in times.items()},
            "device": torch.cuda.get_device_name(dev),
            "nvidia_smi": bench.card_line()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help=f"comma-separated, of {', '.join(VARIANTS)}")
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another ed25519_ladder.cu with B3a-B3d's C "
                         "interface (more than once: other, other1, ...)")
    ap.add_argument("--cases", default=",".join(CASES),
                    help=f"comma-separated, of {', '.join(CASES)}")
    ap.add_argument("--rounds", type=int, default=2)
    ns = ap.parse_args(argv)
    names = [n for n in ns.variants.split(",") if n]
    kinds = [k for k in ns.cases.split(",") if k]
    unknown = sorted(set(names) - set(VARIANTS)) \
        + sorted(set(kinds) - set(CASES))
    if unknown:
        raise SystemExit(f"ladder_ab: unknown variants or cases {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("ladder_ab: needs a CUDA device")
    print(json.dumps(run(names, ns.other, ns.rounds, kinds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
