"""The correctness check at a size the CPU holds: the program passes, the
control (the reference in bfloat16 in the program's place) fails, and so
does a run with the timed path broken underneath, once per fault the
cells can have: a step that returns its state unchanged, half of the
draws or of the batch left out, an answer altered where it is produced, a
prior off by a constant. (One card: no exchange between chips to leave
out.)"""

import io
import json

import pytest
import torch

from port_bench import control, run

CELL = "vet.toi465.nb2.molusc.lc100"
REPLAY = "replay.tab7.b8.molusc.lc100"
SMALL = {"N": 512}
SEED = 2**31 + 101


def last_line(argv, cell=CELL, overrides=SMALL):
    out = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   "0.01", *argv], device="cpu", overrides=overrides, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_control_fails_program_passes():
    s = control.readings(CELL, [SEED], 1, device="cpu", overrides=SMALL,
                         out=io.StringIO())
    from port_bench import check

    limits = check.load_limits(CELL)
    assert check.judge(s["program_max"], limits)[0]
    assert not check.judge(s["control_min"], limits)[0]


def _flat_model(orig, g_at):
    """The core returns lnL of an unchanged, flat model: the draws' model
    never applied."""
    def f(*a, **kw):
        a = list(a)
        a[g_at] = torch.zeros_like(a[g_at])
        return orig(*a, **kw)
    return f


def _best_plus_one(orig):
    """The core's answer altered where it is produced: its best draw's
    lnL raised by one nat."""
    def f(*a, **kw):
        out = orig(*a, **kw)
        fin = torch.where(torch.isfinite(out), out,
                          torch.full_like(out, -float("inf")))
        out[torch.argmax(fin)] += 1.0
        return out
    return f


def _half_draws(orig):
    """Half of the draws left out, the mean taken over the rest."""
    def f(lnL, lnprior, gather):
        n = lnL.shape[0] // 2
        lp = lnprior[:n] if torch.is_tensor(lnprior) and lnprior.dim() else \
            lnprior
        return orig(lnL[:n], lp, {k: v[:n] for k, v in gather.items()})
    return f


def _half_n(orig):
    """The program handed half the draws the configuration asks for."""
    def f(*a, **kw):
        kw["N"] //= 2
        return orig(*a, **kw)
    return f


def _prior_shift(orig):
    """A prior off by a constant: the background-star prior raised 0.5
    nats."""
    def f(*a, **kw):
        return orig(*a, **kw) + 0.5
    return f


@pytest.mark.parametrize("fault", ["state_unchanged", "half_draws",
                                   "half_n", "answer_altered",
                                   "prior_shift"])
def test_fault_fails(fault, monkeypatch):
    from triceratops_tpu_torch.frontend.target import target
    from triceratops_tpu_torch.scenarios import api, engine

    if fault == "state_unchanged":
        monkeypatch.setattr(api, "lnL_planet", _flat_model(api.lnL_planet, 11))
        monkeypatch.setattr(api, "lnL_eb", _flat_model(api.lnL_eb, 12))
    elif fault == "half_draws":
        monkeypatch.setattr(engine, "run_finalize",
                            _half_draws(engine.run_finalize))
    elif fault == "half_n":
        monkeypatch.setattr(target, "calc_probs", _half_n(target.calc_probs))
    elif fault == "prior_shift":
        monkeypatch.setattr(engine, "_background_prior",
                            _prior_shift(engine._background_prior))
    else:
        monkeypatch.setattr(api, "lnL_planet", _best_plus_one(api.lnL_planet))
    res = last_line(["--trace", "0"])
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", ["half_draws", "half_n", "half_batch"])
def test_batch_fault_fails(fault, monkeypatch):
    """The batch path with half of each row's draws left out of the
    evidence, with half the draws handed to it, and with half of the batch
    left out."""
    from triceratops_tpu_torch.parallel import sharding

    if fault == "half_draws":
        orig = sharding._local_lnZ_parts
        monkeypatch.setattr(sharding, "_local_lnZ_parts",
                            lambda x: orig(x[..., : x.shape[-1] // 2]))
    elif fault == "half_n":
        monkeypatch.setattr(sharding, "batch_fpp_full",
                            _half_n(sharding.batch_fpp_full))
    else:
        prep = sharding.prepare_target_batch
        monkeypatch.setattr(sharding, "prepare_target_batch",
                            lambda e, **kw: prep(e[: len(e) // 2], **kw))
    res = last_line(["--trace", "0"], cell=REPLAY,
                    overrides={"N": 256, "per_call": 2})
    assert res["correct"] is False, res["checks"]
