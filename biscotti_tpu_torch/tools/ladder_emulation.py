"""Kernels B3a-B3d built for the host, one std::thread a CUDA thread.

    python -m biscotti_tpu_torch.tools.ladder_emulation OUT_DIR
                                                   [--set kTreeGroups=2 ...]

`build` compiles `csrc/ed25519_ladder.cu` with g++ against
`csrc/host_emulation/cuda_runtime.h` into a shared library with the same C
interface as the card's (`_build.SIGNATURES`), so that its entry points run
on CPU tensors' memory. The source is rewritten on the way: the layout
constants named in `constants` (as `tools.ladder_ab` rewrites them), each
`kernel<<<blocks, threads, smem, stream>>>(args)` into the header's
`emu::launch(kernel, blocks, threads, smem, stream)(args)`, the dynamic
shared memory declaration into the header's buffer, and the cp.async
helpers into plain copies. It finds index, barrier and shuffle faults of a
kernel, bit for bit against the plain versions
(`tests/test_torch_ladder_emulated.py`); it does not find what nvcc
refuses for sm_90a. The build takes about half a minute.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

from biscotti_tpu_torch import _build

NAME = "ed25519_ladder"
HEADER_DIR = _build.PKG / "csrc" / "host_emulation"
FLAGS = ("-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-w",
         "-x", "c++")

_CP_ASYNC = {
    "cp_async16": "inline void cp_async16(void* smem, const void* gmem) "
                  "{ std::memcpy(smem, gmem, 16); }",
    "cp_async_commit": "inline void cp_async_commit() {}",
    "cp_async_wait_all": "inline void cp_async_wait_all() {}",
}


def _sub_once(pattern: str, repl, text: str, what: str, flags=0,
              at_least: int = 1) -> str:
    out, n = re.subn(pattern, repl, text, flags=flags)
    if n < at_least:
        raise ValueError(f"ladder emulation: no {what} in {NAME}.cu")
    return out


def host_source(constants: Optional[Dict[str, int]] = None) -> str:
    """The ladder source rewritten for the host emulation header."""
    text = _build.source(NAME).read_text()
    for const, value in (constants or {}).items():
        text = _sub_once(rf"(constexpr int {const} = )\d+;",
                         rf"\g<1>{int(value)};", text, f"constant {const}")
    text = _sub_once(r"extern __shared__[^;]*?(\w+)\[\];",
                     r"unsigned char* \1 = emu::dynamic_smem();", text,
                     "dynamic shared memory")
    text = _sub_once(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(",
                     r"emu::launch(\1, \2)(", text, "launch", re.DOTALL)
    for fn, body in _CP_ASYNC.items():
        text = _sub_once(rf"__device__ __forceinline__ void {fn}\([^)]*\) "
                         r"\{.*?\n\}", body, text, fn, re.DOTALL)
    return text


def gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the ladder emulation needs it")
    return found


def build(out_dir: Path, constants: Optional[Dict[str, int]] = None) -> Path:
    """Compile the emulated ladder library into `out_dir`; returns its
    path (raises with g++'s report if it does not compile)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{NAME}_host.cpp"
    src.write_text(host_source(constants))
    out = out_dir / f"lib{NAME}_host.so"
    proc = subprocess.run([gxx(), *FLAGS, f"-I{HEADER_DIR}", str(src), "-o",
                           str(out)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on the emulated {NAME}:\n"
                           f"{proc.stdout}")
    return out


def load(path: Path) -> ctypes.CDLL:
    """The emulated library with the card library's C signatures."""
    lib = ctypes.CDLL(str(path))
    _build.SIGNATURES[NAME](lib)
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", type=Path)
    ap.add_argument("--set", action="append", default=[],
                    help="a layout constant, NAME=VALUE")
    ns = ap.parse_args(argv)
    constants = dict(kv.split("=", 1) for kv in ns.set)
    print(build(ns.out, {k: int(v) for k, v in constants.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
