"""repro_torch.optim: the local optimizers and schedules, and the server
optimizers (alone and in the trainer), against repro.optim on the same
numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_regime_matches
from repro.optim import optimizers as ref_optimizers
from repro.optim import server as ref_server
from repro_torch.optim import optimizers, server
from _torch_threads import one_intra_op_thread  # noqa: F401

STEPS = 5
RTOL = 1e-6
OPTIMIZERS = {"sgd": {}, "momentum": {"beta": 0.8},
              "adamw": {"b1": 0.85, "b2": 0.99, "eps": 1e-6},
              "adamw_decay": {"weight_decay": 0.01}}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=1e-30, err_msg=what)


@pytest.mark.parametrize("name", OPTIMIZERS)
@pytest.mark.parametrize("shape", [(37,), (3, 37)])
def test_local_optimizer_matches_reference(name, shape):
    """Five steps from the same params and grads (a flat vector, and a
    client stack): the same updates and state, within rtol 1e-6."""
    kind, kw = name.split("_")[0], OPTIMIZERS[name]
    rng = np.random.default_rng(1)
    params = rng.standard_normal(shape, dtype=np.float32)
    ref = ref_optimizers.get_optimizer(kind, 0.05, **kw)
    mine = optimizers.get_optimizer(kind, 0.05, **kw)
    rstate, state = ref.init(jnp.asarray(params)), mine.init(
        torch.from_numpy(params))
    for step in range(STEPS):
        g = rng.standard_normal(shape, dtype=np.float32)
        rupd, rstate = ref.update(jnp.asarray(g), rstate,
                                  jnp.asarray(params),
                                  jnp.asarray(step, jnp.int32))
        upd, state = mine.update(torch.from_numpy(g), state,
                                 torch.from_numpy(params), step)
        _close(upd, rupd, f"{name} step {step}")
        if kind == "momentum":
            _close(state, rstate, "m")
        elif kind == "adamw":
            for key in ("m", "v"):
                _close(state[key], rstate[key], key)
        params = params - np.asarray(rupd)


def test_get_optimizer_names_and_unknown():
    for name in ("sgd", "momentum", "adamw"):
        assert optimizers.get_optimizer(name, 0.1) is not None
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.get_optimizer("lamb", 0.1)


@pytest.mark.parametrize("make", [
    lambda m: m.cosine_schedule(0.1, warmup=2, total=4),
    lambda m: m.cosine_schedule(0.3, warmup=0, total=3),
    lambda m: m.constant_schedule(0.05)])
def test_schedules_match_reference(make):
    ref, mine = make(ref_optimizers), make(optimizers)
    for step in range(STEPS):
        got = mine(step)
        assert got.dtype == torch.float32
        _close(got, ref(step), f"step {step}")


def test_server_optimizer_names():
    assert set(server.SERVER_OPTIMIZER_NAMES) == set(
        ref_server.SERVER_OPTIMIZER_NAMES)
    assert server.make_server_optimizer(None) is None
    assert server.make_server_optimizer("sgd") is None
    with pytest.raises(ValueError, match="unknown server optimizer"):
        server.make_server_optimizer("fedsgd")


@pytest.mark.parametrize("name", ["fedadam", "fedyogi"])
def test_server_optimizer_apply_matches_reference(name):
    """Five applies, each from the previous new params and a proposal
    near them: the same params and moments within rtol 1e-6."""
    rng = np.random.default_rng(2)
    params = rng.standard_normal(53, dtype=np.float32)
    ref = ref_server.make_server_optimizer(name)
    mine = server.make_server_optimizer(name)
    assert mine.config_dict() == ref.config_dict()
    rstate, state = ref.init(jnp.asarray(params)), mine.init(
        torch.from_numpy(params))
    for step in range(STEPS):
        proposed = params - 0.1 * rng.standard_normal(53, dtype=np.float32)
        rnew, rstate = ref.apply(jnp.asarray(params), jnp.asarray(proposed),
                                 rstate)
        new, state = mine.apply(torch.from_numpy(params),
                                torch.from_numpy(proposed), state)
        _close(new, rnew, f"params step {step}")
        for key in ("m", "v"):
            _close(state[key], rstate[key], f"{key} step {step}")
        params = np.array(rnew)


EXP = ("ExponentialRuntime", (("mean", 1.0),))
# (algorithm, ExecConfig pairs, runtime, server_opt)
CASES = {
    "feddpc_fedadam": ("feddpc", (), None, "fedadam"),
    "feddpc_fedyogi_serial": ("feddpc", (("vectorize", False),), None,
                              "fedyogi"),
    "fedga_async_fedadam": ("fedga", (("async_buffer", True),
                                      ("buffer_size", 4),
                                      ("async_concurrency", 3)), EXP,
                            "fedadam"),
}


@pytest.mark.parametrize("case", CASES)
def test_server_optimizer_in_trainer_matches_reference(case):
    """A server optimizer over FedDPC's kernel step (vectorized, serial)
    and over an async FedGA fold: the reference trainer's schedules,
    losses and parameters."""
    name, exec_kw, rt, sopt = CASES[case]
    tr = assert_regime_matches(name, 3, exec_kw, rt, server_opt=sopt)
    assert float(tr._opt_state["v"].abs().sum()) > 0
