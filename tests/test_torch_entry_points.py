"""The port's remaining entry points against the JAX package's: the shape
registry, the analytic FLOP / byte model, the roofline terms on the
H100's peaks, ``bench_modes``, the benchmark runner, and the
``quickstart`` and ``split_serving`` examples.

- ``SHAPES`` field for field; ``analytic.step_flops`` and every
  ``BytesModel`` field of ``step_hbm_bytes`` exactly, over the ten archs x
  four shapes at 256 and 512 chips with ``kv_bits`` 0 and 8, and reduced
  configs;
- the counterpart of ``tests/test_analytic.py``: the analytic forward
  FLOPs within the reference's 35% of ``torch.utils.flop_counter``'s
  count over the port's ``T.forward`` (single-layer stablelm-3b and
  qwen2.5-3b, B 4, S 128), and that file's four other tests;
- ``roofline_terms`` / ``model_flops_per_step`` / ``useful_ratio``: the
  reference's properties (``tests/test_property.py``) on the H100 peaks,
  and the reference's functions with its module's peaks set to the
  H100's in this process give the same terms. The reference's
  ``_shape_bytes`` property has no counterpart: the port records
  collectives instead of parsing HLO (``tests/test_torch_dryrun.py``
  holds the recorder);
- ``bench_modes.run()`` equals the reference's dict; the runner's suites
  and their order; a failing suite's ``# FAILED suites`` line and exit 1;
- ``split_serving`` at ``--requests 4 --n-slots 2 --gen 4``: every line
  equals the reference example's (a request never stops early, so the
  lines do not depend on the weights); ``quickstart`` at 2 steps a phase:
  its payload lines are the reference's, its losses finite.
"""
import dataclasses
import math
import os
import re
import sys

import pytest
from hypothesis import given, settings, strategies as st

import repro.configs as RC
from repro.core import bottleneck as RBN
from repro.launch import analytic as RA
from repro.launch import roofline as RR
from repro_torch import configs as TCF
from repro_torch.configs.base import ShapeConfig, SplitConfig
from repro_torch.launch import analytic as TA
from repro_torch.launch import mesh as TM
from repro_torch.launch import roofline as TR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = dict(max_examples=30, deadline=None)
REDUCED = ("qwen2.5-3b", "recurrentgemma-2b", "xlstm-125m",
           "phi3.5-moe-42b-a6.6b", "musicgen-large")


# ---------------------------------------------------------------------------
# shapes and the analytic model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(RC.SHAPES))
def test_shapes_match_reference(name):
    assert list(TCF.SHAPES) == list(RC.SHAPES)
    assert dataclasses.asdict(TCF.get_shape(name)) == \
        dataclasses.asdict(RC.get_shape(name))


def _same_model(ref_cfg, cfg, ref_sc, sc, chips, kv_bits):
    assert TA.step_flops(cfg, sc) == RA.step_flops(ref_cfg, ref_sc)
    got = TA.step_hbm_bytes(cfg, sc, chips, kv_bits=kv_bits)
    want = RA.step_hbm_bytes(ref_cfg, ref_sc, chips, kv_bits=kv_bits)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total == want.total


@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("chips", [256, 512])
@pytest.mark.parametrize("shape", list(RC.SHAPES))
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_analytic_matches_reference(arch, shape, chips, kv_bits):
    _same_model(RC.get_config(arch), TCF.get_config(arch),
                RC.get_shape(shape), TCF.get_shape(shape), chips, kv_bits)


@pytest.mark.parametrize("arch", REDUCED)
def test_analytic_matches_reference_reduced(arch):
    for shape in RC.SHAPES:
        for chips in (4, 256):
            _same_model(RC.get_reduced(arch), TCF.get_reduced(arch),
                        RC.get_shape(shape), TCF.get_shape(shape), chips, 0)


def _single_layer_cfg(arch):
    cfg = TCF.get_reduced(arch)
    return dataclasses.replace(
        cfg, n_layers=1, block_pattern=(cfg.block_pattern[0],),
        split=SplitConfig(split_at=1, d_bottleneck=0))


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen2.5-3b"])
def test_analytic_fwd_flops_vs_flop_counter(arch):
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import transformer as T
    cfg = _single_layer_cfg(arch)
    B, S = 4, 128
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.zeros((B, S), dtype=torch.int32)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        T.forward(params, toks, cfg)
    counted = counter.get_total_flops()
    sc = ShapeConfig("tiny", seq_len=S, global_batch=B, kind="prefill")
    ours = TA.step_flops(cfg, sc)
    # within 35% (the counter counts the matmul-class ops only, as the
    # analytic model does; attention's dense S x S blocks included)
    assert 0.65 < ours / counted < 1.35, (ours, counted)


def test_train_multiplier_about_4x_forward():
    cfg = _single_layer_cfg("stablelm-3b")
    tr = TA.step_flops(
        cfg, ShapeConfig("t", seq_len=128, global_batch=4, kind="train"))
    fw = TA.step_flops(
        cfg, ShapeConfig("p", seq_len=128, global_batch=4, kind="prefill"))
    assert 3.0 < tr / fw < 4.2


def test_decode_flops_scale_with_context():
    cfg = TCF.get_reduced("granite-8b")
    f1 = TA.step_flops(
        cfg, ShapeConfig("d", seq_len=1024, global_batch=8, kind="decode"))
    f2 = TA.step_flops(
        cfg, ShapeConfig("d", seq_len=8192, global_batch=8, kind="decode"))
    assert f2 > f1                      # attention term grows with cache
    assert f2 < 8 * f1                  # but projections/mlp dominate


def test_swa_caps_decode_flops():
    mix = TCF.get_config("mixtral-8x7b")
    f_short = TA.step_flops(
        mix, ShapeConfig("d", seq_len=4096, global_batch=1, kind="decode"))
    f_long = TA.step_flops(
        mix, ShapeConfig("d", seq_len=524_288, global_batch=1, kind="decode"))
    # window 4096 caps the attention term: long context costs the same
    assert f_long == pytest.approx(f_short, rel=1e-6)


def test_moe_flops_use_active_params():
    phi = TCF.get_config("phi3.5-moe-42b-a6.6b")
    sc = ShapeConfig("t", seq_len=4096, global_batch=8, kind="prefill")
    ours = TA.step_flops(phi, sc)
    toks = sc.seq_len * sc.global_batch
    assert ours < 0.5 * 2 * phi.param_count() * toks   # not all 16 experts
    assert ours > 0.8 * 2 * phi.active_param_count() * toks


def test_analytic_constants():
    assert TA.CAPACITY_FACTOR == RA.CAPACITY_FACTOR
    assert TA._MLSTM_PF == RA._MLSTM_PF
    from repro_torch.configs.base import slstm_up_width
    for d in (64, 128, 768, 2560):
        assert slstm_up_width(d) == int(RA._SLSTM_PF * d)


# ---------------------------------------------------------------------------
# the roofline terms on the H100's peaks
# ---------------------------------------------------------------------------

def test_h100_peaks():
    assert (TM.PEAK_FLOPS_BF16, TM.PEAK_FLOPS_F32, TM.HBM_BW) == \
        (989e12, 67e12, 3.35e12)
    assert TM.COLL_BW == 50e9 and TM.NVLINK_BW == 450e9
    assert (TR.PEAK_FLOPS_BF16, TR.HBM_BW, TR.COLL_BW) == \
        (TM.PEAK_FLOPS_BF16, TM.HBM_BW, TM.COLL_BW)


@given(st.integers(1, 100), st.integers(1, 100))
@settings(**SETTINGS)
def test_roofline_dominant_term(flops_scale, bytes_scale):
    t = TR.roofline_terms(flops_scale * 1e12, bytes_scale * 1e9, 0.0, 256)
    assert t["dominant"] in ("compute_s", "memory_s")
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"],
                               t["collective_s"])


@given(st.floats(0, 1e18), st.floats(0, 1e14), st.floats(0, 1e12),
       st.sampled_from([1, 4, 256, 512]), st.booleans())
@settings(**SETTINGS)
def test_roofline_terms_match_reference_on_h100_peaks(
        flops, hbm, coll, chips, per_device):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RR, "PEAK_FLOPS_BF16", TM.PEAK_FLOPS_BF16)
        mp.setattr(RR, "HBM_BW", TM.HBM_BW)
        mp.setattr(RR, "ICI_BW", TM.COLL_BW)
        want = RR.roofline_terms(flops, hbm, coll, chips,
                                 per_device=per_device)
    assert TR.roofline_terms(flops, hbm, coll, chips,
                             per_device=per_device) == want


@given(st.integers(1, 10**12), st.integers(1, 10**7),
       st.sampled_from(["train", "inference"]), st.floats(0, 1e18),
       st.sampled_from([1, 256, 512]))
@settings(**SETTINGS)
def test_model_flops_and_useful_ratio_match_reference(n, toks, kind,
                                                      flops, chips):
    mf = TR.model_flops_per_step(n, toks, kind)
    assert mf == RR.model_flops_per_step(n, toks, kind)
    assert TR.useful_ratio(mf, flops, chips) == \
        RR.useful_ratio(mf, flops, chips)


# ---------------------------------------------------------------------------
# benches
# ---------------------------------------------------------------------------

def _reference_module(path, name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_modes_matches_reference(capsys):
    from repro_torch.benchmarks import bench_modes
    ref = _reference_module(os.path.join(ROOT, "benchmarks", "bench_modes.py"),
                            "_ref_bench_modes")
    want = ref.run()
    assert bench_modes.run() == want
    ref.main()
    ref_lines = capsys.readouterr().out
    bench_modes.main()
    assert capsys.readouterr().out == ref_lines


def test_run_suites_in_reference_order():
    from repro_torch.benchmarks import run
    src = open(os.path.join(ROOT, "benchmarks", "run.py")).read()
    want = re.findall(r'\("(\w+)", bench_\w+\.main\)', src)
    assert [s[0] for s in run.SUITES] == want
    for name, module, _ in run.SUITES:
        assert module.startswith("repro_torch.benchmarks.bench_")
        assert module.rsplit(".", 1)[1].startswith("bench_")


def test_run_reports_a_failing_suite(monkeypatch, capsys):
    from repro_torch.benchmarks import run
    seen = []

    def fake(name, device="cuda"):
        seen.append((name, device))
        if name == "modes":
            raise RuntimeError("a broken suite")

    monkeypatch.setattr(run, "run_suite", fake)
    with pytest.raises(SystemExit) as exc:
        run.main(["--device", "cpu"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "# FAILED suites: ['modes']" in out
    assert seen == [(s[0], "cpu") for s in run.SUITES]


def test_run_host_suites(tmp_path, monkeypatch, capsys):
    from repro_torch.benchmarks import bench_roofline, run
    monkeypatch.setattr(bench_roofline, "RESULTS_DIR", str(tmp_path))
    run.main(["--device", "cpu", "--suites", "modes,roofline"])
    out = capsys.readouterr().out
    assert "modes_summary,0," in out and "roofline_table,0," in out
    assert out.strip().endswith("# all benchmark suites completed")


# ---------------------------------------------------------------------------
# examples
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--requests", "4", "--n-slots", "2", "--gen", "4"]


def test_split_serving_lines_match_reference(capsys, monkeypatch):
    from repro_torch.examples import split_serving
    ref = _reference_module(os.path.join(ROOT, "examples",
                                         "split_serving.py"),
                            "_ref_split_serving")
    monkeypatch.setattr(sys, "argv", ["split_serving.py", *SERVE_ARGS])
    ref.main()
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    out = split_serving.main(SERVE_ARGS + ["--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert got == want
    assert len(out["requests"]) == 4
    assert out["decode_ticks"] > 0


def test_quickstart_payload_lines_match_reference(capsys):
    from repro_torch.examples import quickstart
    out = quickstart.main(["--device", "cpu", "--steps", "2"])
    lines = capsys.readouterr().out.splitlines()
    cfg = RC.get_reduced("stablelm-3b")
    want = [f"== stablelm-3b (reduced: {cfg.n_layers}L d={cfg.d_model}) ==",
            f"split at layer {cfg.split.split_at}; "
            f"bottleneck {cfg.split.d_bottleneck} @int{cfg.split.quant_bits}"]
    want += [f"  mode {m}: {RBN.mode_payload_bytes(cfg, 1, 1, m)} "
             f"bytes/token on the wire "
             f"(x{RBN.compression_ratio(cfg, m):.3f})"
             for m in range(cfg.split.n_modes)]
    assert lines[:len(want)] == want
    hist = out["history"]
    losses = [r["loss"] for ph in hist["phases"] for r in ph["log"]]
    losses += hist["ensure"]["losses"]
    assert len(hist["phases"]) == 2 and all(math.isfinite(x)
                                            for x in losses)
    assert any("'Ensure' check" in ln for ln in lines)


@pytest.mark.parametrize("module", ["quickstart", "split_serving",
                                    "expert_parallel_moe"])
def test_examples_default_to_the_card(module):
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{module}")
    assert mod.parser().get_default("device") == "cuda"
