"""The end-to-end parity scripts: parity_ref.py (the JAX package's K-key
record) and parity_port.py (the port against it on the card).

The gates on synthetic K-run samples (including the log10 FPP / NFPP
gates, longer reference rows and the spread statistics of the row mode),
the record's round trip, that the card side imports neither jax nor the
JAX package, that both sides give F1's TP and DTP rows the same inputs
and, on shared uniforms, the same lnZ, and one tiny run of both
scripts' paths on the CPU (F2 at N = 4096, K = 2, and the row mode on
F1)."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest

from test_torch_shared import REPO, shared_uniforms  # noqa: F401

sys.path.insert(0, REPO)
import parity_port  # noqa: E402
import parity_ref  # noqa: E402

NAMES = ["TP", "EB", "EBx2P", "PTP", "STP", "BTP"]
# per-row means: winner, live rows within 5 nats, a deep row, a -inf row
MEANS = np.array([0.0, -1.0, -4.0, -2.5, -20.0, -np.inf])


def _sample(K, seed, means=MEANS, sd=0.1):
    rng = np.random.default_rng(seed)
    return means[None, :] + sd * rng.standard_normal((K, len(means)))


def _kinds(rows):
    return [r["kind"] for r in rows]


class TestGates:
    def test_equal_distributions_pass(self):
        rows = parity_port.gate_rows(_sample(20, 1), _sample(20, 2), NAMES)
        assert _kinds(rows) == ["live"] * 4 + ["deep", "-inf"]
        assert all(r["ok"] for r in rows), rows

    def test_shift_of_0p3_nats_fails(self):
        """K = 20 per side, s.d. 0.1: 3 x combined s.e. is 0.095 nats."""
        port = _sample(20, 3)
        port[:, 3] += 0.3
        rows = parity_port.gate_rows(port, _sample(20, 4), NAMES)
        assert [r["ok"] for r in rows] == [True] * 3 + [False, True, True]
        assert "d mean" in rows[3]["why"]

    def test_threefold_spread_fails(self):
        port = _sample(20, 5)
        port[:, 1] = -1.0 + 3 * (port[:, 1] + 1.0)
        rows = parity_port.gate_rows(port, _sample(20, 6), NAMES)
        assert not rows[1]["ok"] and "s.d. ratio" in rows[1]["why"]
        assert rows[1]["sd_ratio"] > 2.0
        assert all(r["ok"] for i, r in enumerate(rows) if i != 1)

    def test_one_sided_neg_inf_fails(self):
        port, ref = _sample(8, 7), _sample(20, 8)
        port[:, 5] = -30.0
        ref[3, 4] = -np.inf
        rows = parity_port.gate_rows(port, ref, NAMES)
        assert [r["ok"] for r in rows] == [True] * 4 + [False, False]
        assert all(r["why"] == "-inf on one side only" for r in rows[4:])

    def test_deep_rows_not_gated(self):
        """A row more than 5 nats below the winner on both sides passes
        whatever its shift and spread."""
        port = _sample(20, 9)
        port[:, 4] = -14.0 + 3.0 * np.random.default_rng(0).standard_normal(
            20)
        rows = parity_port.gate_rows(port, _sample(20, 10), NAMES)
        assert rows[4]["kind"] == "deep" and rows[4]["ok"]
        assert "limit" not in rows[4]

    def test_row_deep_on_one_side_only_is_gated(self):
        port = _sample(20, 11)
        port[:, 2] -= 3.0           # -7 on the port, -4 in the reference
        rows = parity_port.gate_rows(port, _sample(20, 12), NAMES)
        assert rows[2]["kind"] == "live" and not rows[2]["ok"]

    @pytest.mark.parametrize("shift, ok", [(0.0, True), (0.02, False)])
    def test_fpp_gate(self, shift, ok):
        rng = np.random.default_rng(13)
        ref = 0.05 + 0.005 * rng.standard_normal(20)
        port = 0.05 + shift + 0.005 * rng.standard_normal(8)
        g = parity_port.gate_scalar(port, ref)
        assert g["ok"] is ok and not g["floor"]

    def test_fpp_floor_below_1e_2(self):
        """Both means below 1e-2: the limit is at least 1e-3, and said."""
        g = parity_port.gate_scalar([0.0051] * 8, [0.0046] * 20)
        assert g["floor"] and g["limit"] == 1e-3 and g["ok"]
        g = parity_port.gate_scalar([0.0071] * 8, [0.0046] * 20)
        assert g["floor"] and not g["ok"]

    def test_gate_fixture_and_table(self):
        rng = np.random.default_rng(17)
        port = dict(lnZ=_sample(12, 14).tolist(),
                    FPP=(0.009 + 0.001 * rng.standard_normal(12)).tolist(),
                    NFPP=[0.0] * 12, seconds=[0.5] * 12)
        ref = dict(lnZ=_sample(20, 15).tolist(),
                   FPP=(0.0092 + 0.001 * rng.standard_normal(20)).tolist(),
                   NFPP=[0.0] * 20, scenarios=NAMES, seconds=[200.0] * 20)
        res = parity_port.gate_fixture(port, ref)
        assert res["ok"] and res["K_port"] == 12 and res["K_ref"] == 20
        assert res["logFPP"]["kind"] == "log10"
        assert res["logNFPP"] == dict(kind="zero", ok=True,
                                      why="0 in every run")
        md = parity_port.table({"F1": res}, dict(smi="cpu", torch="x",
                                                 cuda=None))
        # header, rows, FPP, NFPP and their logs
        assert md.count("\n| ") == len(NAMES) + 5
        assert "-inf" in md and "1e-3 floor" in md
        assert "| log10 NFPP | | | | pass (0 in every run) |" in md
        assert "port K = 12 (0.5000 s per call)" in md

    def test_log_gate_sees_what_the_floor_hides(self):
        """NFPP near 1e-7, doubled on the port: inside the 1e-3 floor of
        the mean gate, far outside the log gate's 3 x combined s.e."""
        rng = np.random.default_rng(18)
        ref = 1e-7 * np.exp(0.15 * rng.standard_normal(20))
        for scale, ok in ((1.0, True), (2.0, False)):
            port = scale * 1e-7 * np.exp(0.15 * rng.standard_normal(16))
            assert parity_port.gate_scalar(port, ref)["ok"]
            g = parity_port.gate_log(port, ref)
            assert g["kind"] == "log10" and g["ok"] is ok

    @pytest.mark.parametrize("port, ref, ok, why", [
        ([0.0] * 4, [0.0] * 5, True, "0 in every run"),
        ([0.0] * 4, [1e-7] * 5, False, "0 in every run on one side only"),
        ([0.0, 1e-7], [1e-7] * 5, True, "0 in some runs: not gated")])
    def test_log_gate_zeros(self, port, ref, ok, why):
        assert parity_port.gate_log(port, ref) == dict(kind="zero", ok=ok,
                                                        why=why)

    def test_longer_reference_rows(self):
        """ref_rows replaces a row's reference sample: a 20-run reference
        whose s.d. came out at half the row's fails the ratio gate; the
        same row against 100 runs of its true spread passes, and the
        row's K_ref says which sample it was gated against."""
        rng = np.random.default_rng(20)
        port, ref = _sample(80, 21), _sample(20, 22)
        ref[:, 0] = 0.05 * rng.standard_normal(20)
        assert not parity_port.gate_rows(port, ref, NAMES)[0]["ok"]
        longer = {0: (0.1 * rng.standard_normal(100)).tolist()}
        rows = parity_port.gate_rows(port, ref, NAMES, ref_rows=longer)
        assert rows[0]["ok"] and rows[0]["K_ref"] == 100
        assert [r["K_ref"] for r in rows[1:]] == [20] * 5
        assert rows[0]["limit"] == pytest.approx(max(0.05, 3 * np.sqrt(
            rows[0]["sd_port"]**2 / 80 + rows[0]["sd_ref"]**2 / 100)))

    def test_row_reference_checks_the_records_agree(self):
        """The row record must hold the main record's configuration and
        start with its keys and values."""
        rec = dict(N=10, nsamples=2, trilegal_sha256="x", fixtures=dict(
            F1=dict(scenarios=NAMES, keys=[100, 101],
                    lnZ=_sample(2, 23).tolist())))
        f = rec["fixtures"]["F1"]
        tp = [v[0] for v in f["lnZ"]] + [0.5, 0.6]
        rows = dict(fixture="F1", N=10, nsamples=2, trilegal_sha256="x",
                    rows=dict(TP=dict(keys=[100, 101, 102, 103], lnZ=tp)))
        assert parity_port.row_reference(rec, rows) == {"F1": {0: tp}}
        rows["rows"]["TP"]["lnZ"] = [tp[1], tp[0]] + tp[2:]
        with pytest.raises(ValueError, match="main record's keys"):
            parity_port.row_reference(rec, rows)
        rows["N"] = 20
        with pytest.raises(ValueError, match="N"):
            parity_port.row_reference(rec, rows)

    def test_spread_false_rate_resampled(self):
        """On a large normal sample the resampled rate is the F tail
        rate; on a heavy-tailed one of the same s.d. it is higher."""
        rng = np.random.default_rng(24)
        normal = rng.standard_normal(20000)
        got = parity_port.spread_false_rate_resampled(normal, 8, 20)
        assert got == pytest.approx(parity_port.spread_false_rate(8, 20),
                                    abs=0.006)
        heavy = rng.standard_t(3, 20000) / np.sqrt(3.0)
        assert parity_port.spread_false_rate_resampled(heavy, 8, 20) > got

    @pytest.mark.parametrize("scale, equal", [(1.0, True), (3.0, False)])
    def test_spread_stats(self, scale, equal):
        """200 port runs against 100 reference runs: equal spreads give a
        bootstrap interval around 1 and a large Brown-Forsythe p; a 3x
        spread an interval above 2 and a tiny p."""
        rng = np.random.default_rng(19)
        st = parity_port.spread_stats(scale * rng.standard_normal(200),
                                      rng.standard_normal(100), n_boot=2000)
        lo, hi = st["ci95"]
        assert lo < st["sd_ratio"] < hi
        if equal:
            assert lo < 1.0 < hi and st["p_brown_forsythe"] > 0.01
        else:
            assert lo > 2.0 and st["p_brown_forsythe"] < 1e-6

    @pytest.mark.parametrize("k_port, rate", [(8, 0.0416), (16, 0.0072),
                                              (20, 0.0040)])
    def test_spread_false_rate(self, k_port, rate):
        """Equal normal samples fail the s.d.-ratio gate at the F
        distribution's tail rate, checked by simulation."""
        assert parity_port.spread_false_rate(k_port, 20) == pytest.approx(
            rate, abs=1e-4)
        rng = np.random.default_rng(16)
        a = rng.standard_normal((20000, k_port)).std(axis=1, ddof=1)
        b = rng.standard_normal((20000, 20)).std(axis=1, ddof=1)
        sim = np.mean((a / b < 0.5) | (a / b > 2.0))
        assert sim == pytest.approx(rate, abs=4 * np.sqrt(rate / 20000))


def test_record_round_trip(tmp_path):
    """A tiny record from parity_ref round-trips through both scripts'
    readers: inputs, keys, -inf lnZ and the schema check."""
    rec = parity_ref.new_record(("F1", "F2"), K=2, N=4096, nsamples=2)
    f = rec["fixtures"]["F2"]
    f["lnZ"] = [[0.0, -math.inf], [1.0, -2.0]]
    f["FPP"], f["NFPP"], f["seconds"] = [0.1, 0.2], [0.0, 0.0], [1.0, 1.0]
    path = str(tmp_path / "ref.json")
    parity_ref.write_record(rec, path)
    for reader in (parity_ref.read_record, parity_port.read_record):
        back = reader(path)
        assert back == rec
    assert np.isneginf(back["fixtures"]["F2"]["lnZ"][0][1])
    assert len(back["fixtures"]["F1"]["stars"]) == 3
    assert len(back["fixtures"]["F1"]["flux"]) == parity_ref.N_T
    assert back["fixtures"]["F2"]["keys"] == [200, 201]
    rec["schema"] = 0
    parity_ref.write_record(rec, path)
    with pytest.raises(ValueError, match="schema"):
        parity_port.read_record(path)


def test_card_side_imports_no_jax():
    """Importing parity_port, chip_smoke and every module they reach
    (the port, its profiling helpers) pulls in neither jax nor any
    triceratops_tpu module."""
    code = (
        "import sys\n"
        "import parity_port, chip_smoke\n"
        "import triceratops_tpu_torch.triceratops\n"
        "import triceratops_tpu_torch.utils.profiling\n"
        "import triceratops_tpu_torch.populations.synthetic\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triceratops_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.slow
def test_tiny_end_to_end(tmp_path):
    """F2 at N = 4096, K = 2: the JAX package writes the record, the port
    reads it back and runs the same inputs on the CPU, and every gate
    yields a verdict (at this size the verdicts themselves mean little).
    Marked slow: the JAX package's compile of the 15 scenario programs and
    the port's CPU path (4096 draws padded to draw_chunk's 16384 per core)
    take minutes on an 8-core host."""
    path = str(tmp_path / "jax_ref.json")
    rec = parity_ref.run_reference(names=("F2",), K=2, N=4096, nsamples=2,
                                   out=path, verbose=False)
    f = rec["fixtures"]["F2"]
    assert len(f["lnZ"]) == 2 and len(f["scenarios"]) == 15
    assert all(0.0 <= v <= 1.0 for v in f["FPP"])
    with open(path) as fh:
        assert json.load(fh)["fixtures"]["F2"]["FPP"] == f["FPP"]
    summary, ok = parity_port.check(path, K=2, K_plain=0, device="cpu",
                                    verbose=False, rows_path=None)
    runs = summary["runs"]["F2"]
    assert runs["seeds"] == [1200, 1201]
    assert runs["scenarios"] == f["scenarios"]
    assert np.isfinite(np.asarray(runs["lnZ"])).all()
    gates = summary["gates"]["F2"]
    assert len(gates["rows"]) == 15 and gates["K_ref"] == 2
    assert ok == gates["ok"] and summary["card"]["smi"] == "cpu"
    assert "F2: port K = 2 (" in summary["table"]

    # row mode: TP and DTP on F1 at K = 2 on both packages
    rows_path, f1_path = (str(tmp_path / n) for n in ("rows.json",
                                                      "f1.json"))
    f1 = parity_ref.new_record(("F1",), K=0, N=4096, nsamples=2)
    parity_ref._targets(f1, str(tmp_path))
    parity_ref.write_record(f1, f1_path)
    rows = parity_ref.run_rows(K=2, N=4096, nsamples=2, out=rows_path,
                               verbose=False)
    assert [len(r["lnZ"]) for r in rows["rows"].values()] == [2, 2]
    summary, ok = parity_port.check_rows(rows_path, f1_path, K=2,
                                         device="cpu", verbose=False)
    assert sorted(summary["gates"]) == ["DTP", "TP"]
    assert summary["runs"]["TP"]["seeds"] == [1100, 1101]
    assert all(np.isfinite(r["lnZ"]).all() for r in summary["runs"].values())
    assert "| TP | " in summary["table"] and "| DTP | " in summary["table"]


@pytest.mark.usefixtures("shared_uniforms")
def test_row_lnz_on_shared_uniforms(tmp_path):
    """F1's TP and DTP rows at N = 8192 on shared uniforms and star
    indices: the two packages' scenario functions give one lnZ (within
    1e-3 nats; they read ~2e-5 apart), so their spreads over seeds can
    differ only through the random streams."""
    import jax
    import torch
    from triceratops_tpu.funcs import renorm_flux
    from triceratops_tpu.scenarios import api as japi
    from triceratops_tpu_torch.scenarios import api as tapi

    N = 8192
    rec = parity_ref.new_record(("F1",), K=0, N=N, nsamples=20)
    jt = parity_ref._targets(rec, str(tmp_path))["F1"]
    (tmp_path / "port").mkdir()
    pt = parity_port.build_targets(rec, str(tmp_path / "port"), "cpu")["F1"]
    f = rec["fixtures"]["F1"]
    ja = parity_ref.row_inputs(jt, f, jt.trilegal_fname, renorm_flux)
    ta = parity_port.row_inputs(pt, f, pt.trilegal_fname)
    for row, fn in parity_port.ROW_FNS.items():
        want = float(getattr(japi, fn)(*ja[row], N=N, nsamples=20,
                                       key=jax.random.key(0))["lnZ"])
        got = float(getattr(tapi, fn)(*ta[row], N=N, nsamples=20,
                                      gen=torch.Generator(),
                                      device="cpu")["lnZ"])
        assert np.isfinite(want) and abs(got - want) < 1e-3, (row, got, want)


def test_row_inputs_match(tmp_path):
    """Row mode: both scripts hand their package's TP and DTP scenario
    functions the same inputs for F1's target (the renormalized curve,
    the star's mass, radius, Teff and magnitudes), and the port's
    synthetic TRILEGAL field is the JAX package's."""
    from triceratops_tpu.funcs import renorm_flux

    rec = parity_ref.new_record(("F1",), K=0, N=4096, nsamples=2)
    jt = parity_ref._targets(rec, str(tmp_path))["F1"]
    (tmp_path / "port").mkdir()
    pt = parity_port.build_targets(rec, str(tmp_path / "port"), "cpu")["F1"]
    f = rec["fixtures"]["F1"]
    want = parity_ref.row_inputs(jt, f, jt.trilegal_fname, renorm_flux)
    got = parity_port.row_inputs(pt, f, pt.trilegal_fname)
    assert sorted(got) == sorted(want) == sorted(parity_port.ROW_FNS)
    for row in want:
        assert len(got[row]) == len(want[row])
        for g, w in zip(got[row][:-1], want[row][:-1]):
            np.testing.assert_array_equal(g, w)
    assert (parity_ref._sha256(want["DTP"][-1])
            == parity_ref._sha256(got["DTP"][-1]))
