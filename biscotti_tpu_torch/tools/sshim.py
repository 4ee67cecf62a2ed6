# The port's own copy of biscotti_tpu/tools/sshim.py; it imports nothing of biscotti_tpu.
"""ssh/scp stand-in that executes locally — lets the fleet launcher's
REAL remote code path (command construction, scp distribution, remote
launch, output collection, oracle) run end-to-end on a box with no ssh
client installed (zero-egress build images). The transport is the ONLY
thing swapped: `pod_launch --ssh-cmd "python -m biscotti_tpu_torch.tools.sshim"
--scp-cmd "python -m biscotti_tpu_torch.tools.sshim --scp"` drives the same
branches a genuine fleet run takes (ref: azure/azure-run/runBiscotti.sh
launches per-VM processes over ssh and collects logs back).

ssh form:   sshim.py [options ignored] <host> <command>
            -> bash -c <command> locally, stdout/stderr passed through
scp form:   sshim.py --scp [-q] [-r] <src> <host>:<dst>
            -> local filesystem copy
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("sshim: missing arguments", file=sys.stderr)
        return 2
    if argv[0] == "--scp":
        rest = [a for a in argv[1:] if a != "-q"]
        recursive = "-r" in rest
        if recursive:
            rest = [a for a in rest if a != "-r"]
        if len(rest) != 2:
            print(f"sshim --scp: expected src host:dst, got {rest}",
                  file=sys.stderr)
            return 2
        src, dst = rest
        dst = dst.split(":", 1)[1] if ":" in dst else dst
        if os.path.abspath(src) == os.path.abspath(dst):
            return 0  # same file — distribution to "remote" self is a no-op
        if recursive:
            shutil.copytree(src, dst, dirs_exist_ok=True)
        else:
            shutil.copyfile(src, dst)
        return 0
    # ssh form: everything before the last arg is host/options, the last
    # arg is the remote command string (matching `ssh <host> <command>`)
    command = argv[-1]
    return subprocess.run(["bash", "-c", command]).returncode


if __name__ == "__main__":
    raise SystemExit(main())
