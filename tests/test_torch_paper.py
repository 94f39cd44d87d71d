"""The paper's drivers on the port (``repro_torch.launch.paper_tables``,
``paper_figures``, ``fig9_adaptation``) against the reference scripts in
``benchmarks/``, on the CPU.  The figures run the same simulator code on
both sides (the port's copy), so their rows are held exactly equal, at a
reduced seed count set on both sides alike.  The tables' fills run on the
port's ``filling_torch`` against the reference's exact numpy filler:
deterministic rows equal exactly, the rows of 200 random trials (torch
generators against numpy's) within the stated tolerances."""
import contextlib
import io

import numpy as np
import pytest
import torch

from benchmarks import fig9_adaptation as ref_fig9
from benchmarks import paper_figures as ref_figures
from benchmarks import paper_tables as ref_tables
from repro.core.instance import paper_example
from repro_torch.launch import fig9_adaptation, paper_figures, paper_tables

#: trial means (T1) and standard deviations (T2), tasks a cell: the
#: tolerance of the reference's own JAX-vs-numpy test
RRR_ATOL = 0.8
#: Jain's index of the dominant shares (T5), which lies in [1/N, 1]
JAIN_ATOL = 0.01


def _printed(fn, *a, **k):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **k)
    return out, buf.getvalue()


def test_paper_tables_rows_equal_reference():
    """Deterministic schedulers' rows exactly; the stochastic ones' T1/T2
    within ``RRR_ATOL``, T3 (the residual, linear in the allocation)
    within ``RRR_ATOL`` times the largest column sum of the demands, T5
    within ``JAIN_ATOL``."""
    (got, text), (want, want_text) = (_printed(paper_tables.run, device="cpu"),
                                      _printed(ref_tables.run))
    assert [r[:3] + r[4:] for r in got] == [r[:3] + r[4:] for r in want]
    res_atol = RRR_ATOL * paper_example().demands.sum(0).max()
    atol = {"T1_alloc_mean": RRR_ATOL, "T2_alloc_std": RRR_ATOL,
            "T3_unused_mean": res_atol, "T5_jain_dominant_share": JAIN_ATOL}
    for (table, sched, _, v, _), (*_, w, _) in zip(got, want):
        if sched in paper_tables.DETERMINISTIC:
            assert v == w, (table, sched)
        else:
            assert abs(v - w) <= atol[table], (table, sched, v, w)
    assert text.splitlines()[0] == want_text.splitlines()[0]
    totals = {ln.split(",")[1]: float(ln.split(",")[2])
              for ln in text.splitlines() if ln.startswith("# total,")}
    assert totals["PS-DSF"] == 41.0 and totals["rPS-DSF"] == 42.0
    assert totals["BF-DRF"] == 42.0 and abs(totals["DRF"] - 22.6) < 0.5


def test_paper_tables_cli_on_cpu():
    _, text = _printed(paper_tables.main, ["--device", "cpu"])
    assert "# total,rPS-DSF,42.00" in text


def test_fig9_on_cpu_equals_reference_with_both_claims():
    got, text = _printed(fig9_adaptation.run, device="cpu")
    want, want_text = _printed(ref_fig9.run)
    assert got.keys() == want.keys()
    for s in want:
        np.testing.assert_array_equal(got[s], want[s])
    assert text == want_text
    assert text.count("# CLAIM PASS") == 2 and "FAIL" not in text


def test_paper_figures_on_cpu_equal_reference(monkeypatch):
    """Two seeds a configuration instead of eight, on both sides."""
    monkeypatch.setattr(paper_figures, "SEEDS", range(2))
    monkeypatch.setattr(ref_figures, "SEEDS", range(2))
    got, text = _printed(paper_figures.run, device="cpu")
    want, want_text = _printed(ref_figures.run)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    assert text == want_text


@pytest.mark.parametrize("module", [fig9_adaptation, paper_figures,
                                    paper_tables])
def test_drivers_default_to_the_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


def test_fig9_cli_on_cpu_prints_both_claims():
    _, text = _printed(fig9_adaptation.main, ["--device", "cpu"])
    assert text.count("# CLAIM PASS") == 2
