"""Kernels B3a and B3b built in several layouts, timed in turns on one card.

    python -m biscotti_tpu_torch.tools.ladder_ab [--variants NAME,...]
                                                 [--other PATH] [--rounds 2]

`csrc/ed25519_ladder.cu` fixes each ladder's layout in compile-time
constants: B3a's threads a lane (`kMsmGroup`) and a block
(`kMsmThreads`), B3b's threads a product group (`kWalkGroup`, four groups
a lane). Each variant of VARIANTS is a copy of the source with some
of those constants rewritten, written under `build/ladder_ab/` and built
with the library's nvcc flags, all at once; `--other PATH` adds another
source with the same C interface (such as an earlier commit's file unpacked
by git). Then each library's kernels run alone (the C interface on outputs
allocated once; CUDA events, median of 20 launches) at the shapes the
crypto plane gives them: B3a at the settle's 8,192 lanes and at 32 and 128
(an msm of 8-100 points), B3b at the Pedersen comb's 1 x 512 steps and
fixed_base_mult's 4 x 256. The libraries run in turns, forward then
backward, `rounds` times, so that the card's clock and neighbours weigh on
all alike. Every library's outputs are held to this tree's build's, bit
for bit. Prints one JSON line: each library's layout, the ptxas report
(registers, spills) of its two kernels, whether its outputs equal, its
times in turn order and their median a shape, and the card's name and
power limit as nvidia-smi prints them.
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
from biscotti_tpu_torch.crypto.kernels import primitives as prim
from biscotti_tpu_torch.crypto.kernels.cells import ladder_lanes
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
}
MSM_LANES = (8192, 128, 32)
WALK_SHAPES = ((1, 512), (4, 256))
KERNELS = ("msm_ladder_kernel", "fixed_walk_kernel")
CONSTANTS = ("kMsmGroup", "kMsmThreads", "kWalkGroup")


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
    """{constant: value} of the layout constants of a ladder source's
    text."""
    out = {}
    for const in CONSTANTS:
        m = re.search(rf"constexpr int {const} = (\d+);", text)
        if m is None:
            raise ValueError(f"no constant {const} in the ladder source")
        out[const] = int(m.group(1))
    return out


def _library(src: Path):
    """(library, {kernel: ptxas report} of B3a's and B3b's kernels)."""
    out = _build.digest_path(f"{NAME}-{src.stem}", src, _build.NVCC_FLAGS)
    log = _build.compile_once(_build.nvcc(), _build.NVCC_FLAGS, src, out)
    lib = ctypes.CDLL(str(out))
    _build.SIGNATURES[NAME](lib)
    report = _build.ptxas_report(log)
    return lib, {k: next((r for fn, r in report.items() if k in fn), None)
                 for k in KERNELS}


def inputs(dev: torch.device) -> dict:
    """The seeded inputs: {("msm", m): (bits, pts), ("walk", (m, steps)):
    (bits, table)} on the card."""
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
    return cases


def launcher(lib, case, args, out, flag):
    kind = case[0]
    bits, pts = args
    stream = torch.cuda.current_stream().cuda_stream
    entry = lib.ed25519_msm_ladder if kind == "msm" else lib.ed25519_fixed_walk

    def launch():
        rc = entry(bits.data_ptr(), bits.shape[1], pts.data_ptr(),
                   out.data_ptr(), flag.data_ptr(), bits.shape[0], stream)
        if rc != 0:
            raise RuntimeError(f"{case} launch failed: {rc}")
    return launch


def run(names, other, rounds: int) -> dict:
    dev = torch.device("cuda", 0)
    sources = {n: variant_source(n) for n in names}
    if other is not None:
        sources["other"] = other
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each
        built = dict(zip(sources, pool.map(_library, sources.values())))
    cases = inputs(dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    outs = {(v, c): torch.empty((args[0].shape[0], 4, 16), dtype=torch.int64,
                                device=dev)
            for v in built for c, args in cases.items()}
    launch = {(v, c): launcher(built[v][0], c, args, outs[(v, c)], flag)
              for v in built for c, args in cases.items()}
    for fn in launch.values():
        fn()
    torch.cuda.synchronize()
    if int(flag):
        raise AssertionError("a ladder flagged a limb of its seeded inputs")
    ref = "this" if "this" in built else next(iter(built))
    equal = {v: {f"{c[0]} {c[1]}": bool(torch.equal(outs[(v, c)],
                                                     outs[(ref, c)]))
                 for c in cases} for v in built}
    times = {v: {f"{c[0]} {c[1]}": [] for c in cases} for v in built}
    order = list(built)
    for _ in range(rounds):
        for v in order + order[::-1]:
            for c in cases:
                times[v][f"{c[0]} {c[1]}"].append(time_ms(launch[(v, c)]))
    return {"reps": 20, "rounds": rounds, "reference": ref,
            "layouts": {v: layout(sources[v].read_text()) for v in built
                        if v != "other"},
            "ptxas": {v: built[v][1] for v in built},
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
    ap.add_argument("--other", type=Path, default=None,
                    help="another ed25519_ladder.cu with the same C interface")
    ap.add_argument("--rounds", type=int, default=2)
    ns = ap.parse_args(argv)
    names = [n for n in ns.variants.split(",") if n]
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise SystemExit(f"ladder_ab: unknown variants {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("ladder_ab: needs a CUDA device")
    print(json.dumps(run(names, ns.other, ns.rounds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
