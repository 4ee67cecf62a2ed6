"""The port's shell run queues (`biscotti_tpu_torch/eval/run_r5_queue.sh`,
`run_r5_poison2.sh`): every `run` line is the reference queue's line
(`eval/run_r5_*.sh`) with the driver `python -m biscotti_tpu_torch.eval.<name>`
in place of `python eval/<name>.py` and the port's results directory in
place of `eval/results`, and its arguments parse with that driver's own
argument parser. Nothing is run: the parser's `parse_args` returns into a
sentinel before the driver's body."""

import argparse
import importlib
import os
import re
import shlex

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUEUES = ("run_r5_queue.sh", "run_r5_poison2.sh")
OUT = "biscotti_tpu_torch/eval/results"


def _run_lines(path, env):
    """Each `run ...` command of a queue script, its line continuations
    joined and its variables expanded, as an argument list."""
    text = open(path).read().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        for name, value in env.items():
            line = re.sub(r'"?\$' + name + r'\b"?', value, line)
        if line.startswith("run "):
            out.append(shlex.split(line)[1:])
        else:
            m = re.match(r'^(\w+)="(.*)"$', line)
            if m:
                env[m.group(1)] = m.group(2)
    return out


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("queue", QUEUES)
def test_port_queue_mirrors_the_reference_and_parses(queue, monkeypatch):
    ref = _run_lines(os.path.join(REPO, "eval", queue), {})
    port = _run_lines(os.path.join(REPO, "biscotti_tpu_torch", "eval", queue),
                      {"OUT": OUT})
    assert len(port) == len(ref) > 0
    real = argparse.ArgumentParser.parse_args

    def parse_only(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_only)
    for want, got in zip(ref, port):
        assert want[0] == got[0] == "python" and got[1] == "-m"
        name = got[2].rsplit(".", 1)[1]
        assert got[2] == f"biscotti_tpu_torch.eval.{name}"
        assert want[1] == f"eval/{name}.py"
        assert [OUT if a == "eval/results" else a for a in want[2:]] == got[3:]
        module = importlib.import_module(got[2])
        with pytest.raises(_Parsed) as parsed:
            module.main(got[3:])
        ns = parsed.value.args[0]
        assert ns.out == OUT and ns.platform == "cuda"
