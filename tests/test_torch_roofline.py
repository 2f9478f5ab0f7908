"""The port's roofline against the JAX package's: ``model_flops`` equal for
every one of the 40 cells; ``analyze`` gives the JAX package's terms on
the H100's peaks (rescaled by the ratio of the peaks), ``mfu`` only for a
measured record; ``format_table`` prints every row."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as J  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro_torch.launch import roofline as PR  # noqa: E402

CELLS = J.all_cells()
# tests/test_analysis_tools.py's record
RECORD = dict(arch="granite-3-2b", shape="train_4k",
              mesh={"data": 16, "model": 16}, temp_bytes=10 ** 9,
              arg_bytes=0, out_bytes=0, alias_bytes=0,
              flops=1e12, bytes_accessed=1e11,
              collective_bytes={"all-reduce": 1e9},
              notes="accum=4 opt=adamw step_multiplier=4")


@pytest.mark.parametrize("arch_id,shape", CELLS)
def test_model_flops_equal_jax(arch_id, shape):
    want, n_want = JR.model_flops(arch_id, shape)
    got, n_got = PR.model_flops(arch_id, shape)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert n_got == n_want


def test_model_flops_of_a_cut_run():
    full, _ = PR.model_flops("dien", "train_batch")
    assert PR.model_flops("dien", "train_batch", {"batch": 512})[0] == \
        pytest.approx(full * 512 / 65536, rel=1e-12)
    one = PR.model_flops("granite-3-2b", "prefill_32k", {"batch": 1})[0]
    assert one == pytest.approx(
        PR.model_flops("granite-3-2b", "prefill_32k")[0] / 32, rel=1e-12)
    # a depth cut takes the layers' parameters and attention out, not the
    # embedding and head
    four = PR.model_flops("granite-3-2b", "decode_32k", {"n_layers": 4})[0]
    assert 0 < four < PR.model_flops("granite-3-2b", "decode_32k")[0] / 5
    with pytest.raises(KeyError):
        PR.model_flops("eagr", "stream_mixed")


def test_analyze_is_jax_on_the_h100_peaks():
    j = JR.analyze([RECORD])[0]
    p = PR.analyze([RECORD])[0]
    # each term rescaled by the ratio of the peaks
    np.testing.assert_allclose(p["t_compute_s"], j["t_compute_s"]
                               * JR.PEAK_FLOPS / PR.PEAK_FLOPS, rtol=1e-12)
    np.testing.assert_allclose(p["t_memory_s"], j["t_memory_s"]
                               * JR.HBM_BW / PR.HBM_BW, rtol=1e-12)
    np.testing.assert_allclose(
        p["t_collective_s"], j["t_collective_s"]
        * JR.ICI_LINKS * JR.ICI_BW / PR.NVLINK_BW, rtol=1e-12)
    np.testing.assert_allclose(p["t_compute_s"], 4e12 / 989.4e12)
    for k in ("arch", "shape", "chips", "bottleneck", "hlo_flops_per_dev",
              "hlo_bytes_per_dev", "collective_bytes_per_dev",
              "model_flops_total", "useful_ratio", "temp_gb", "notes"):
        assert p[k] == pytest.approx(j[k]) if isinstance(j[k], float) \
            else p[k] == j[k], k
    mf, n = j["model_flops_total"], j["chips"]
    worst = max(p["t_compute_s"], p["t_memory_s"], p["t_collective_s"])
    np.testing.assert_allclose(p["roofline_fraction"],
                               mf / n / PR.PEAK_FLOPS / worst, rtol=1e-12)
    np.testing.assert_allclose(
        p["roofline_cc"], mf / n / PR.PEAK_FLOPS
        / max(p["t_compute_s"], p["t_collective_s"]), rtol=1e-12)
    # not measured: no mfu
    assert p["mfu"] is None


def test_mfu_of_a_measured_record():
    rec = dict(RECORD, mesh={"data": 1, "model": 1}, notes="", measured=True,
               seconds=0.5, model_flops=2e14, reduced={"batch": 8})
    row = PR.analyze([rec])[0]
    assert row["mfu"] == pytest.approx(2e14 / PR.PEAK_FLOPS / 0.5)
    assert row["useful_ratio"] == pytest.approx(2e14 / 1e12)
    # a cell with no model FLOPs (eagr), and a dry run never measured
    assert PR.analyze([dict(rec, model_flops=None)])[0]["mfu"] is None
    dry = dict(rec, measured=False, flops=None, bytes_accessed=None)
    row = PR.analyze([dry])[0]
    assert row["mfu"] is None and row["roofline_fraction"] is None
    assert row["bottleneck"] == "n/a"


def test_format_table_prints_every_row(tmp_path, capsys):
    recs = [dict(RECORD, arch=a, shape=s, notes="") for a, s in CELLS[:7]]
    recs.append(dict(RECORD, arch="eagr", shape="stream_mixed", notes=""))
    rows = PR.analyze(recs)
    table = PR.format_table(rows)
    lines = table.splitlines()
    assert len(lines) == 2 + len(recs)
    for r, line in zip(recs, lines[2:]):
        assert line.startswith(f"{r['arch']:22s} {r['shape']:15s}")
    assert "mfu" in lines[0]
    path = tmp_path / "records.json"
    path.write_text(json.dumps(recs))
    out = tmp_path / "rows.json"
    PR.main([str(path), "--out", str(out)])
    assert len(json.loads(out.read_text())) == len(recs)
    assert capsys.readouterr().out.count("\n") == len(lines)
