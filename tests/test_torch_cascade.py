"""Algorithm 1's cascade trainer in the port (``repro_torch.core.cascade``)
against the JAX package's, its phase masks, the throughput-prediction
example and the three benches built on it, on the CPU.

Tolerances of a composed step (the gradients and the AdamW update
together), float32: Adam's first update of an element is about
lr * sign(g), so where |g| is below 1e-3 of its leaf's largest |g| a
rounding-level difference in g may flip that sign and move the element by
up to 2 lr; there the bound is 2 lr, elsewhere 1e-5 of |p| + |delta|, the
operands of the update p - delta (an element that nearly cancels keeps the
error of delta, not a relative error of its tiny value).
The loss within 1e-5 absolute, the global gradient norm within 1e-4
relative (the gradients' tolerance). Many steps are not held bit for bit (the
frameworks' f32 ``exp`` may differ in the last bit); a run is held by the
reference test's own assertions.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import cascade as JC
from repro.core import split as JS
from repro.data import lumos5g
from repro.models import lstm as JL
from repro.training import checkpoint
from repro.training import optimizer as JO
from repro_torch.benchmarks import bench_cascade, bench_infoplane
from repro_torch.benchmarks import bench_temporal_mi
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import (adam_state_from_flat, flat_from_params,
                                 params_from_flat)
from repro_torch.core import cascade as TC
from repro_torch.core import split as TS
from repro_torch.examples import throughput_prediction as TP
from repro_torch.models import lstm as TL

STEP_REL = 1e-5
SMALL_G = 1e-3
LOSS_ABS = 1e-5
GRAD_REL = 1e-4     # a gradient's tolerance, of its largest element


def _flat_mask(mask):
    out = {}
    for k, v in mask.items():
        for path, leaf in checkpoint._flatten({k: v}).items():
            out[path] = bool(leaf)
    return out


@pytest.mark.parametrize("phase", [1, 2, 3])
def test_transformer_phase_mask_matches(phase):
    """Reduced stablelm-3b's split parameters with a second bottleneck
    head: phase 1 trains all but the bank, phase m >= 2 only head m-2."""
    def two_heads(cfg):
        return dataclasses.replace(cfg, split=dataclasses.replace(
            cfg.split, extra_modes=((16, 4),)))
    jcfg = two_heads(j_reduced("stablelm-3b"))
    tcfg = two_heads(t_reduced("stablelm-3b"))
    jp = JS.init_split_params(jax.random.PRNGKey(0), jcfg)
    tp = TS.init_split_params(torch.Generator().manual_seed(0), tcfg)
    want = _flat_mask(JC.transformer_phase_mask(jp, phase))
    got = _flat_mask(TC.transformer_phase_mask(tp, phase))
    assert got == want
    on = {k for k, t in got.items() if t}
    if phase == 1:
        assert on and not any(k.startswith("bneck_modes") for k in on)
    else:
        assert on and all(k.startswith(f"bneck_modes/{phase - 2}/")
                          for k in on)


def _setup():
    jcfg = j_reduced("lumos5g-lstm")
    tcfg = t_reduced("lumos5g-lstm")
    jp = JL.init_params(jax.random.PRNGKey(0), jcfg)
    d = lumos5g.generate(lumos5g.Lumos5GConfig(n_samples=600,
                                               seq_len=jcfg.seq_len))
    it = lumos5g.batch_iterator(d, 64)
    batches = [next(it) for _ in range(2)]
    kw = dict(learning_rate=5e-3, warmup_steps=5, total_steps=160,
              weight_decay=0.0)
    return jcfg, tcfg, jp, batches, JTrainConfig(**kw), TrainConfig(**kw)


def _to_torch(jp, js):
    return (params_from_flat(checkpoint._flatten(jp), device="cpu"),
            adam_state_from_flat(int(js.step), checkpoint._flatten(js.m),
                                 checkpoint._flatten(js.v), device="cpu"))


def _check_step(jp, jg, jnew, tnew, lr, what):
    g = checkpoint._flatten(jg)
    want = checkpoint._flatten(jnew)
    got = flat_from_params(tnew)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        small = np.abs(g[k]) < SMALL_G * max(np.abs(g[k]).max(), 1e-30)
        p0 = np.asarray(checkpoint._flatten(jp)[k])
        bound = np.where(small, 2 * lr,
                         STEP_REL * (np.abs(p0) + np.abs(p0 - want[k])))
        err = np.abs(v - want[k])
        assert np.all(err <= bound), (what, k, float(err.max()))


def test_first_step_of_each_phase_matches_the_reference():
    """Phase 1's first step (mode 0) from the same parameters and batch,
    then phase 2's first step (mode 1) from the reference's result and
    state on both sides: loss, parameters and step counter; phase 2's
    frozen leaves, their m and v are the tensors passed in."""
    jcfg, tcfg, jp, batches, jtc, ttc = _setup()
    jstep = JC.make_train_step(lambda p, b, m: JL.loss_fn(p, b, jcfg, m),
                               jtc)
    tstep = TC.make_train_step(lambda p, b, m: TL.loss_fn(p, b, tcfg, m),
                               ttc)
    js = JO.init(jp)
    for phase, b in zip((1, 2), batches):
        mode = phase - 1
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        tp, ts = _to_torch(jp, js)
        tmask = TL.phase_mask(tp, phase)
        (_, _), jg = jax.value_and_grad(JL.loss_fn, has_aux=True)(
            jp, jb, jcfg, mode)
        jp2, js2, jm = jstep(jp, js, jb, JL.phase_mask(jp, phase), mode=mode)
        tp2, ts2, tm = tstep(tp, ts, tb, tmask, mode=mode)
        assert int(ts2.step) == int(js2.step) == phase
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=0, atol=LOSS_ABS)
        assert sorted(tm) == sorted(jm)
        # the clip's norm takes every leaf's gradient, frozen ones too
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=GRAD_REL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        _check_step(jp, jg, jp2, tp2, float(jm["lr"]), f"phase {phase}")
        flat_mask = _flat_mask(tmask)
        before = dict(zip(sorted(flat_mask), zip(
            TC.opt.leaves(tp), TC.opt.leaves(ts.m), TC.opt.leaves(ts.v))))
        after = dict(zip(sorted(flat_mask), zip(
            TC.opt.leaves(tp2), TC.opt.leaves(ts2.m), TC.opt.leaves(ts2.v))))
        for k, trainable in flat_mask.items():
            for a, b2 in zip(before[k], after[k]):
                assert (a is b2) == (not trainable), (phase, k)
                if not trainable:
                    assert torch.equal(a, b2)
        if phase == 2:
            moved = [not torch.equal(a, b2) for k, (a, _, _) in before.items()
                     for b2 in [after[k][0]] if k.startswith("bneck")]
            assert moved and all(moved)
        jp, js = jp2, js2


def test_cascade_on_paper_lstm_poc():
    """The reference's ``test_cascade_on_paper_lstm_poc`` on the port: the
    same data, steps, parameters and assertions."""
    lcfg = t_reduced("lumos5g-lstm")
    dcfg = lumos5g.Lumos5GConfig(n_samples=3000, seq_len=lcfg.seq_len,
                                 seed=0)
    data = lumos5g.generate(dcfg)
    train, test = lumos5g.train_test_split(data, dcfg)
    params = params_from_flat(checkpoint._flatten(JL.init_params(
        jax.random.PRNGKey(0), j_reduced("lumos5g-lstm"))), device="cpu")

    it = lumos5g.batch_iterator(train, 128)
    batches = [next(it) for _ in range(160)]

    def data_iter(step):
        b = batches[step % len(batches)]
        return {"x": torch.from_numpy(b["x"]), "y": torch.from_numpy(b["y"])}

    test_b = {"x": torch.from_numpy(test["x"][:512]),
              "y": torch.from_numpy(test["y"][:512])}

    def eval_fn(params, mode):
        loss, m = TL.loss_fn(params, test_b, lcfg, mode)
        return {"loss": loss, "acc": m["acc"]}

    tcfg = TrainConfig(learning_rate=5e-3, warmup_steps=5, total_steps=160,
                       weight_decay=0.0)
    params, hist = TC.train_cascade(
        params, lambda p, b, m: TL.loss_fn(p, b, lcfg, m), data_iter, tcfg,
        n_modes=2, steps_per_phase=80, phase_mask_fn=TL.phase_mask,
        eval_fn=eval_fn, verbose=False)

    assert [(e["phase"], e["mode"]) for e in hist["phases"]] == [(1, 0),
                                                                 (2, 1)]
    assert [r["step"] for r in hist["phases"][0]["log"]] == [0, 50, 79]
    assert set(hist["phases"][0]["log"][0]) == {"loss", "acc", "lr",
                                                "grad_norm", "step"}
    # mode 0 learned something (better than chance = -log(1/3) ~ 1.0986)
    assert hist["phases"][0]["eval"]["loss"] < 1.05
    # Ensure: mode 1 (bottleneck) at most as good as mode 0
    assert hist["ensure"]["losses"][1] >= hist["ensure"]["losses"][0] - 0.02
    # both modes beat chance accuracy
    assert hist["ensure"]["accs"][1] > 0.40


def test_example_runs_reduced_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "tp.json"
    res = TP.main(["--device", "cpu", "--reduced", "--steps-per-phase", "12",
                   "--samples", "2000", "--out", str(out)])
    text = capsys.readouterr().out
    for line in ("mode  code", "Ensure (Alg. 1): ordered=",
                 "information plane (bits):", "mode1_H3: I(X;H)=",
                 "conditional-MI ladder"):
        assert line in text, line
    saved = json.loads(out.read_text())
    assert saved["device"] == "cpu" and len(saved["cond_mi_ladder"]) == 3
    assert set(saved["info_plane"]) == {"mode0_H1", "mode0_H2", "mode1_H1",
                                        "mode1_H2", "mode1_H3"}
    for v in [x for p in res["info_plane"].values() for x in p.values()] \
            + res["cond_mi_ladder"]:
        assert np.isfinite(v)
    assert all(np.isfinite(r["loss"]) for e in res["history"]["phases"]
               for r in e["log"])


def test_example_and_benches_refuse_cuda_without_a_card(monkeypatch):
    """The entry points default to CUDA and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (TP.main, bench_cascade.main, bench_infoplane.main,
                 bench_temporal_mi.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--reduced"] if main is TP.main else [])


def test_benches_run_on_the_cpu():
    out = bench_cascade.run(steps_per_phase=15, device="cpu")
    assert [r["mode"] for r in out["rows"]] == [0, 1]
    assert out["rows"][1]["payload_bytes"] < out["rows"][0]["payload_bytes"]
    plane = bench_infoplane.run(n_epoch_probes=2, steps_per_phase=6,
                                n_eval=200, device="cpu")
    assert set(plane["phase2"]) == {"H1", "H2", "H3"}
    assert all(len(v) == 2 for v in plane["phase1"].values())
    tm = bench_temporal_mi.run(n_probes=2, steps=6, n_eval=200, device="cpu")
    assert tm["I_HtY"].shape == tm["I_XH"].shape == (3, 8)
    assert len(tm["cond_mi_ladder"]) == 3


def test_chip_smoke_first_step_check_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.cascade_first_steps`` at the paper's full size with the
    CPU in the card's place: its comparison, the frozen leaves' bits and
    the moved bottleneck all hold, and every leaf is reported."""
    import sys
    from pathlib import Path
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    import chip_smoke
    rows = chip_smoke.cascade_first_steps(0, torch.device("cpu"))
    assert [r["phase"] for r in rows] == [1, 2]
    assert all(len(r["leaves"]) == 15 for r in rows)
    assert rows[1]["frozen_leaves_bit_identical"] == 10
    assert rows[1]["bneck_leaves_moved"] == 3
    assert "chip_smoke" in sys.modules
