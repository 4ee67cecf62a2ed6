"""The port stands alone: importing any of its modules loads neither JAX nor
the JAX package, and its entry points refuse to fall back to the CPU."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import biscotti_tpu_torch
from biscotti_tpu_torch.config import BiscottiConfig
from biscotti_tpu_torch.device import resolve_device
from biscotti_tpu_torch.parallel.sim import Simulator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        biscotti_tpu_torch.__path__, prefix="biscotti_tpu_torch."))


def test_port_modules_import_without_jax_or_reference():
    mods = _port_modules()
    assert "biscotti_tpu_torch.parallel.sim" in mods
    assert "biscotti_tpu_torch.ops.krum_cuda" in mods
    crypto = {"biscotti_tpu_torch.crypto." + m for m in (
        "ed25519", "commitments", "kernels", "kernels.instrument",
        "kernels.field", "kernels.group", "kernels.cuda_validate",
        "kernels.primitives", "kernels.cells")}
    assert crypto <= set(mods), crypto - set(mods)
    slice3 = {"biscotti_tpu_torch." + m for m in (
        "bench", "models.trainer", "models.zoo", "ops.dp_noise",
        "ops.robust_agg", "ops.roni", "ops.lsh_sieve", "telemetry",
        "telemetry.registry", "tools.conv_precision", "utils",
        "utils.profiling")}
    assert slice3 <= set(mods), slice3 - set(mods)
    slice4 = {"biscotti_tpu_torch." + m for m in (
        "crypto._native", "crypto.vrf", "crypto.dkg", "ops.secretshare",
        "parallel.roles")}
    assert slice4 <= set(mods), slice4 - set(mods)
    slice5 = {"biscotti_tpu_torch." + m for m in (
        "ledger", "ledger.block", "ledger.chain", "utils.checkpoint",
        "runtime", "runtime.codecs", "runtime.messages", "runtime.wire",
        "runtime.protocol", "runtime.rpc")}
    assert slice5 <= set(mods), slice5 - set(mods)
    slice6 = {"biscotti_tpu_torch." + m for m in (
        "config", "runtime.faults", "runtime.admission", "runtime.stragglers",
        "runtime.overlay", "runtime.placement", "runtime.membership",
        "runtime.adversary", "ops.trust", "telemetry.recorder",
        "telemetry.tracectx", "telemetry.core", "tools.keygen",
        "runtime.peer")}
    assert slice6 <= set(mods), slice6 - set(mods)
    slice7 = {"biscotti_tpu_torch." + m for m in (
        "runtime.hive", "runtime.device_cluster", "tools.obs",
        "tools.trace_round", "tools.sshim", "tools.bench_diff",
        "tools.pod_launch", "tools.profile_round", "tools.soak",
        "tools.chaos", "tools.verdicts")}
    assert slice7 <= set(mods), slice7 - set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'biscotti_tpu' "
        "or m.startswith('biscotti_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_simulator_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = BiscottiConfig(dataset="creditcard", num_nodes=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulator(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from biscotti_tpu_torch import bench
    from biscotti_tpu_torch.models.trainer import Trainer
    from biscotti_tpu_torch.utils.profiling import device_trace

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer("creditcard", "creditcard0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(["creditcard_10"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with device_trace(os.devnull):
            pass


def test_peer_without_device_needs_a_gpu(monkeypatch):
    """PeerAgent and the peer's CLI resolve the GPU and raise without one,
    and so does arming the crypto plane without a device named."""
    from biscotti_tpu_torch.crypto import kernels
    from biscotti_tpu_torch.runtime import peer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = BiscottiConfig(dataset="creditcard", num_nodes=4, base_port=17990)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peer.PeerAgent(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peer.main(["-i", "0", "-t", "4", "-d", "creditcard", "-p", "17990"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernels.set_enabled(True)
    assert not kernels.active()
