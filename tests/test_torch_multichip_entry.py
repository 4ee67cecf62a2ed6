"""The port's `entry()` (`biscotti_tpu_torch/multichip.py`) against the
reference's (`__graft_entry__.py::entry`), on the CPU.

  * the step it hands out, on the arguments it hands out, equals the
    Simulator's `round_step(w, stake, 0)` bit for bit, and twice in a row;
  * given the reference's own round-0 draws (`test_torch_sim._jax_draws`
    on a JAX `Simulator` at entry()'s configuration), it gives the mask
    and the stakes of the reference's entry() function exactly, w within
    rtol 1e-5 (float32 sums in another order) and the test error within
    one test sample;
  * its Simulator carries the reference's configuration fields."""

import numpy as np
import torch

import jax

import __graft_entry__ as graft
from biscotti_tpu.config import BiscottiConfig as JConfig
from biscotti_tpu.config import Defense as JDefense
from biscotti_tpu.parallel.sim import Simulator as JSimulator
from biscotti_tpu_torch.multichip import entry
from test_torch_sim import _jax_draws

RTOL = 1e-5
FIELDS = dict(dataset="mnist", num_nodes=16, batch_size=10, epsilon=1.0,
              noising=True, verification=True, sample_percent=1.0,
              num_verifiers=0, num_miners=0)


def test_entry_step_is_the_round_step_bit_for_bit():
    fn, args = entry(device="cpu")
    assert all(t.device.type == "cpu" for t in args)
    w, stake = args[:2]
    once, twice = fn(*args), fn(*args)
    want = fn.__self__.round_step(w, stake, 0)
    for got in (once, twice):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.isfinite(once[0]).all() and int(once[2].sum()) > 0


def test_entry_step_equals_the_reference_entry_on_its_draws():
    jfn, jargs = graft.entry()
    jw, jstake, jmask, jerr = jax.jit(jfn)(*jargs)
    jsim = JSimulator(JConfig(defense=JDefense.KRUM, **FIELDS))
    fn, (w, stake, *_) = entry(device="cpu")
    pw, pstake, pmask, perr = fn(w, stake, *_jax_draws(jsim, 0))
    assert np.array_equal(pmask.numpy(), np.asarray(jmask))
    assert np.array_equal(pstake.numpy(), np.asarray(jstake))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=RTOL,
                               atol=RTOL)
    assert abs(float(perr) - float(jerr)) <= 1.0 / jsim.x_val.shape[0]
    assert 0 < int(pmask.sum()) < FIELDS["num_nodes"]


def test_entry_has_the_reference_configuration():
    fn, _ = entry(device="cpu")
    cfg = fn.__self__.cfg
    for key, value in FIELDS.items():
        assert getattr(cfg, key) == value, key
    assert cfg.defense.value == JDefense.KRUM.value
    assert cfg.num_samples == FIELDS["num_nodes"]
