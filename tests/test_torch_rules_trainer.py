"""The server rules and their client variants in the port's
FederatedTrainer on the CPU, against the reference's trainer
at quickstart size (LeNet5, 30 clients, 10 a round, 3 rounds): the same
schedules, per-round losses within 1e-4, the same diagnostics keys,
uplink bytes and chaos counters, parameters within 1e-4 — in the
vectorized and serial rounds (the buffered-async ones are cases of
test_torch_async.py's trainer test)."""
import numpy as np
import pytest

from _torch_parity import assert_runs_match, port_trainer, run_reference
from _torch_threads import one_intra_op_thread  # noqa: F401

ROUNDS = 3
NEW_RULES = ("fedprox", "fedexp", "fedga", "fedcm", "fedvarp",
             "feddpc_noscale", "fedadam", "fedyogi", "feddpc_m")
EXP = ("ExponentialRuntime", (("mean", 1.0),))


@pytest.mark.parametrize("name", NEW_RULES)
@pytest.mark.parametrize("vectorize", [True, False])
def test_rule_matches_reference_quickstart(name, vectorize):
    """Each rule, vectorized and serial, against the reference's
    vectorized round (its serial path agrees with it to ~1e-4)."""
    ref_run = run_reference(name, ROUNDS)
    tr = port_trainer(name, ROUNDS, (("vectorize", vectorize),))
    tr.run()
    assert_runs_match(ref_run, tr)
    for got, want in zip(tr.history, ref_run[0]):
        for key, value in want.diagnostics.items():
            np.testing.assert_allclose(got.diagnostics[key], value,
                                       rtol=1e-3, atol=1e-4, err_msg=key)


DEADLINE = (("round_deadline", 1.5),)


@pytest.mark.parametrize("vectorize", [True, False])
def test_fedvarp_under_deadline_matches_reference(vectorize):
    """FedVARP's table with the deadline's ID_SENTINEL rows, in the
    vectorized and the serial round, against the reference's vectorized
    round."""
    ref_run = run_reference("fedvarp", ROUNDS, DEADLINE, EXP)
    tr = port_trainer("fedvarp", ROUNDS,
                      DEADLINE + (("vectorize", vectorize),), EXP)
    tr.run()
    assert_runs_match(ref_run, tr)
    assert sum(r.deadline_dropped for r in tr.history) > 0
