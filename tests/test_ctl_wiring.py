"""ctl -> model wiring for baseml's nonstandard models (VERDICT r3 item 1:
nhomo/nparK/rho/REVu were parsed-then-ignored; reference ctls silently fit
the wrong model).  Parse-level asserts are cheap and guard the regression;
the fit tests reproduce fresh reference-binary goldens end-to-end through
the CLI (reference: GetOptions src/baseml.c:954, GetStepMatrix :912).
"""
import re

import numpy as np
import pytest

import conftest  # noqa: F401
from paml_tpu.io import ctl as ctlmod


def _spec(path):
    return ctlmod.baseml_spec(ctlmod.read_ctl(path), path)


def test_nhomo_ctls_parse_to_nhomo_spec():
    spec4, _, _, _, _ = _spec(conftest.ref_path(
        "examples", "nhomo", "baseml-nhomo4.ctl"))
    assert spec4.nhomo == 4 and spec4.model == "REV"
    assert spec4.kappa == pytest.approx(2.723)
    spec5, _, _, _, _ = _spec(conftest.ref_path(
        "examples", "nhomo", "baseml-nhomo5.ctl"))
    assert spec5.nhomo == 5 and spec5.fix_kappa == 2


def test_npark_coerces_alpha_rho_fixed(tmp_path):
    """nparK models never use alpha/rho; the reference forces them fixed
    (src/baseml.c:1077).  Leaving them free silently mis-sliced the
    free-rate vector (round-4 advisor finding)."""
    p = tmp_path / "b.ctl"
    p.write_text("seqfile = x\ntreefile = y\nmodel = 4\nncatG = 3\n"
                 "nparK = 2\nfix_rho = 0\nrho = 0.1\nfix_alpha = 0\n"
                 "alpha = 0.5\n")
    spec, *_ = _spec(str(p))
    assert spec.nparK == 2
    assert spec.fix_rho and spec.rho == 0.0
    assert spec.fix_alpha
    assert spec.ncatG == 3          # not collapsed for nparK/AdG models


def test_adg_rho_still_free_without_npark(tmp_path):
    p = tmp_path / "b.ctl"
    p.write_text("seqfile = x\ntreefile = y\nmodel = 4\nncatG = 5\n"
                 "fix_rho = 0\nrho = 0.1\nfix_alpha = 0\nalpha = 0.5\n")
    spec, *_ = _spec(str(p))
    assert not spec.fix_rho and spec.rho == pytest.approx(0.1)
    assert not spec.fix_alpha


def test_stepmatrix_parse():
    step, nrate = ctlmod.parse_step_matrix(
        "9 [2 (TA TC TG CA CG) (AG)]", symmetric=True)
    assert nrate == 2
    # TCAG order: T=0 C=1 A=2 G=3; AG is rate 2, symmetric
    assert step[2, 3] == 2 and step[3, 2] == 2
    assert step[0, 2] == 1 and step[2, 0] == 1
    assert step[0, 1] == 1          # TC
    step_u, nr = ctlmod.parse_step_matrix("10 [1 (TC)]", symmetric=False)
    assert nr == 1 and step_u[0, 1] == 1 and step_u[1, 0] == 0


@pytest.mark.slow
def test_revu_ctl_end_to_end(tmp_path, monkeypatch):
    """REVu 'model = 9 [2 (...) (...)]' on brown.nuc: fresh reference run
    gives lnL -2810.473118 (np 9)."""
    from paml_tpu.__main__ import run_baseml

    ctl = tmp_path / "baseml.ctl"
    ctl.write_text(f"""
seqfile = {conftest.ref_path('examples', 'brown.nuc')}
treefile = {conftest.ref_path('examples', 'brown.trees')}
outfile = mlb
model = 9  [2 (TA TC TG CA CG) (AG)]
fix_kappa = 0
kappa = 5
fix_alpha = 1
alpha = 0
cleandata = 1
""")
    monkeypatch.chdir(tmp_path)
    run_baseml(str(ctl))
    text = open(tmp_path / "mlb").read()
    lnl = float(re.search(r"lnL.*?(-\d+\.\d+)", text).group(1))
    assert lnl == pytest.approx(-2810.473118, abs=2e-3)


@pytest.mark.slow
def test_unrestu_ctl_end_to_end(tmp_path, monkeypatch):
    """UNRESTu 'model = 10 [3 (TC) (CT) (AG GA)]' on brown.nuc: fresh
    reference run gives lnL -2734.378645 (np 10)."""
    from paml_tpu.__main__ import run_baseml

    ctl = tmp_path / "baseml.ctl"
    ctl.write_text(f"""
seqfile = {conftest.ref_path('examples', 'brown.nuc')}
treefile = {conftest.ref_path('examples', 'brown.trees')}
outfile = mlb
model = 10  [3 (TC) (CT) (AG GA)]
fix_kappa = 0
fix_alpha = 1
alpha = 0
cleandata = 1
""")
    monkeypatch.chdir(tmp_path)
    run_baseml(str(ctl))
    text = open(tmp_path / "mlb").read()
    lnl = float(re.search(r"lnL.*?(-\d+\.\d+)", text).group(1))
    assert lnl == pytest.approx(-2734.378645, abs=2e-3)


@pytest.mark.slow
def test_adg_rho_ctl_end_to_end(tmp_path, monkeypatch):
    """Auto-discrete-gamma (fix_rho=0) HKY on brown.nuc: fresh reference
    run gives lnL -2621.396791, alpha 0.23103, rho 0.04153."""
    from paml_tpu.__main__ import run_baseml

    ctl = tmp_path / "baseml.ctl"
    ctl.write_text(f"""
seqfile = {conftest.ref_path('examples', 'brown.nuc')}
treefile = {conftest.ref_path('examples', 'brown.trees')}
outfile = mlb
model = 4
fix_kappa = 0
kappa = 5
fix_alpha = 0
alpha = 0.5
ncatG = 5
fix_rho = 0
rho = 0.1
cleandata = 1
""")
    monkeypatch.chdir(tmp_path)
    run_baseml(str(ctl))
    text = open(tmp_path / "mlb").read()
    lnl = float(re.search(r"lnL.*?(-\d+\.\d+)", text).group(1))
    assert lnl == pytest.approx(-2621.396791, abs=2e-3)
    alpha = float(re.search(r"alpha = ([\d.]+)", text).group(1))
    rho = float(re.search(r"rho \(auto-discrete-gamma\) = ([-\d.]+)",
                          text).group(1))
    assert alpha == pytest.approx(0.23103, abs=2e-3)
    assert rho == pytest.approx(0.04153, abs=5e-3)


@pytest.mark.slow
def test_npark_ctl_end_to_end(tmp_path, monkeypatch):
    """nparK=2 (free rates + freqs) HKY, ncatG=3, on brown.nuc: fresh
    reference run gives lnL -2620.747360 (np 12)."""
    from paml_tpu.__main__ import run_baseml

    ctl = tmp_path / "baseml.ctl"
    ctl.write_text(f"""
seqfile = {conftest.ref_path('examples', 'brown.nuc')}
treefile = {conftest.ref_path('examples', 'brown.trees')}
outfile = mlb
model = 4
fix_kappa = 0
kappa = 5
fix_alpha = 1
alpha = 0
ncatG = 3
nparK = 2
cleandata = 1
""")
    monkeypatch.chdir(tmp_path)
    run_baseml(str(ctl))
    text = open(tmp_path / "mlb").read()
    lnl = float(re.search(r"lnL.*?(-\d+\.\d+)", text).group(1))
    assert lnl == pytest.approx(-2620.747360, abs=2e-3)


@pytest.mark.slow
def test_basemlg_cli(tmp_path, monkeypatch):
    """basemlg subcommand (continuous gamma): brown.nuc K80 reproduces
    the reference basemlg lnL -2726.434658, kappa 11.1555, alpha 0.5529."""
    from paml_tpu.__main__ import run_basemlg

    ctl = tmp_path / "baseml.ctl"
    ctl.write_text(f"""
seqfile = {conftest.ref_path('examples', 'brown.nuc')}
treefile = {conftest.ref_path('examples', 'brown.trees')}
outfile = mlbg
model = 1
fix_kappa = 0
kappa = 5
fix_alpha = 0
alpha = 0.5
cleandata = 1
RateAncestor = 1
""")
    monkeypatch.chdir(tmp_path)
    run_basemlg(str(ctl))
    text = open(tmp_path / "mlbg").read()
    lnl = float(re.search(r"lnL.*?(-\d+\.\d+)", text).group(1))
    assert lnl == pytest.approx(-2726.434658, abs=2e-3)
    alpha = float(re.search(r"alpha \(continuous gamma\) = ([\d.]+)",
                            text).group(1))
    assert alpha == pytest.approx(0.5529, abs=2e-3)
    assert (tmp_path / "rates").exists()


def test_pamp_cli(tmp_path, monkeypatch):
    """pamp subcommand: mtprim9.nuc + 9s.trees reproduce the reference
    pamp alpha estimates (fresh run: MM 2.9244, Sullivan 2.0498,
    YK96 1.3649)."""
    from paml_tpu.__main__ import run_pamp

    ctl = tmp_path / "pamp.ctl"
    ctl.write_text(f"""
seqfile = {conftest.ref_path('examples', 'mtprim9.nuc')}
outfile = mp
treefile = {conftest.ref_path('examples', '9s.trees')}
seqtype = 0
ncatG = 8
""")
    monkeypatch.chdir(tmp_path)
    run_pamp(str(ctl))
    text = open(tmp_path / "mp").read()
    mm = float(re.search(r"method of moments\)\s+= ([\d.]+)", text).group(1))
    su = float(re.search(r"Sullivan et al. 1995\) = ([\d.]+)", text).group(1))
    yk = float(re.search(r"Yang & Kumar 1996\)\s+= ([\d.]+)", text).group(1))
    assert mm == pytest.approx(2.9244, abs=1e-3)
    assert su == pytest.approx(2.0498, abs=1e-3)
    assert yk == pytest.approx(1.3649, abs=1e-3)


@pytest.mark.slow
def test_myxo_fmutsel_ctl_end_to_end(tmp_path, monkeypatch):
    """myxo FMutSel ctl (CodonFreq=7, estFreq=0, gappy .aln alignment,
    cleandata=0): fresh reference run gives lnL -12249.403354 (np 26).
    Regression for an FMutSel fit that went NaN when the CLI ran its f64
    fits on an accelerator backend."""
    from paml_tpu.__main__ import run_codeml

    ctl = tmp_path / "codeml.ctl"
    ctl.write_text(f"""
seqfile = {conftest.ref_path('examples', 'myxo', 'myxovirus.aln')}
treefile = {conftest.ref_path('examples', 'myxo', 'myxovirus.tree')}
outfile = out_M0.txt
seqtype = 1
ndata = 1
icode = 0
cleandata = 0
model = 0
NSsites = 0
CodonFreq = 7
estFreq = 0
fix_omega = 0
omega = 0.5
""")
    monkeypatch.chdir(tmp_path)
    run_codeml(str(ctl))
    text = (tmp_path / "out_M0.txt").read_text()
    lnl = float(re.search(r"lnL.*?(-\d+\.\d+)", text).group(1))
    assert lnl == pytest.approx(-12249.403354, abs=2e-3)
