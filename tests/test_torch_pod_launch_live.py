"""Twin of `tests/test_pod_launch.py::test_remote_branch_executes_end_to_
end_via_sshim` on the port: the fleet launcher's remote branch (scp
distribution, a per-host ssh launch, output collection, the chain-
equality oracle) run for real, with only the transport swapped for the
package's local `tools.sshim`. The '127.0.0.1' host entry is not the
literal 'localhost', so it takes the ssh branch while its peers stay
dialable.

Each package's launcher starts its own peer processes (the port's with
`--platform cpu`), so nothing is injected: the two launchers' summaries
must be equal (the fleet's size, its hosts, equal chains on every peer
and the number of blocks each holds).

Ports are 22400-22499, which no other test file uses."""

import importlib
import json

from torch_twins import PACKAGES


def _remote_branch(pkg, tmp_path, port, capsys) -> dict:
    root = "biscotti_tpu_torch" if pkg.name == "port" else "biscotti_tpu"
    hosts = tmp_path / f"{pkg.name}-hosts.txt"
    hosts.write_text("localhost\n127.0.0.1\n")
    argv = ["--hosts", str(hosts), "--nodes-per-host", "2",
            "--dataset", "creditcard", "--iterations", "1",
            "--base-port", str(port),
            "--peers-file", str(tmp_path / f"{pkg.name}-peers.txt"),
            "--ssh-cmd", f"python -m {root}.tools.sshim",
            "--scp-cmd", f"python -m {root}.tools.sshim --scp",
            "--timeout", "240"]
    if pkg.name == "port":
        argv += ["--platform", "cpu"]
    rc = importlib.import_module(f"{root}.tools.pod_launch").main(argv)
    out = capsys.readouterr().out
    assert rc == 0, out
    summary = json.loads(out.splitlines()[-1])
    assert summary["chains_equal"] is True
    assert summary["total_nodes"] == 4
    assert summary["blocks"] >= 1
    return summary


def test_remote_branch_executes_end_to_end_via_sshim(tmp_path, capsys):
    ref, port = (_remote_branch(pkg, tmp_path, 22400 + 10 * k, capsys)
                 for k, pkg in enumerate(PACKAGES))
    assert port == ref
