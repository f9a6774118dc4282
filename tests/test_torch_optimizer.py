"""The port's AdamW with freeze masks (``repro_torch.training.optimizer``)
against the JAX package's, fed the same gradients (JAX's, carried across).

Tolerances: the schedule, the clip and the update are float32 arithmetic
in the reference's order, so params, m, v, the learning rate and the norm
agree within 1e-6 relative (each element against its own value: the
frameworks' cos, pow and sqrt may differ in the last bit); ``step`` is
exact, and a frozen leaf, its m and its v are the very tensors passed in.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.training import checkpoint
from repro.training import optimizer as JO
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import (adam_state_from_flat, flat_from_params,
                                 params_from_flat)
from repro_torch.models import lstm as TL
from repro_torch.training import optimizer as TO

REL = 1e-6
CFG = dict(learning_rate=1e-2, weight_decay=0.05, warmup_steps=4,
           total_steps=12, grad_clip=1.0)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=REL,
                               atol=0, err_msg=what)


def _trees(seed=0):
    """A small tree shaped like the paper LSTM's (lists, nested dicts) in
    both packages, and gradients for it."""
    rng = np.random.default_rng(seed)
    shapes = {"enc/0/wx/w": (5, 8), "enc/0/wx/b": (8,), "enc/0/wh/w": (2, 8),
              "dec/0/w": (2, 3), "dec/0/b": (3,), "dec_out/w": (3, 3),
              "dec_out/b": (3,), "bneck/wx/w": (2, 4), "bneck/wx/b": (4,),
              "bneck/wh/w": (1, 4), "adapter/w": (1, 2), "adapter/b": (2,)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 1)).astype(
        np.float32) for k, s in shapes.items()}
    tp = params_from_flat(p, device="cpu")
    return (_nest(p), tp, _nest(g), params_from_flat(g, device="cpu"))


def _nest(flat):
    """``{"a/0/b": x}`` as the JAX tree (lists for integer keys)."""
    t = params_from_flat(flat, device="cpu")

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return [conv(v) for v in node]
        return jnp.asarray(node.numpy())
    return conv(t)


def test_leaves_follow_the_jax_order():
    jp, tp, _, _ = _trees()
    assert [tuple(x.shape) for x in TO.leaves(tp)] == \
        [x.shape for x in jax.tree.leaves(jp)]
    again = TO.unflatten(tp, TO.leaves(tp))
    assert flat_from_params(again).keys() == flat_from_params(tp).keys()


def test_lr_schedule_matches_over_every_step():
    for cfg in (CFG, dict(CFG, warmup_steps=0), dict(CFG, total_steps=3)):
        steps = range(0, cfg["total_steps"] + 6)
        for s in steps:
            got = TO.lr_schedule(TrainConfig(**cfg),
                                 torch.tensor(s, dtype=torch.int32))
            want = JO.lr_schedule(JTrainConfig(**cfg),
                                  jnp.asarray(s, jnp.int32))
            assert got.dtype == torch.float32 and got.shape == ()
            _close(got, want, f"step {s} {cfg}")


@pytest.mark.parametrize("max_norm", [1e3, 0.05])
def test_clip_by_global_norm_matches(max_norm):
    """Below the norm the gradients pass unchanged; above it they scale."""
    _, _, jg, tg = _trees(1)
    jc, jn = JO.clip_by_global_norm(jg, max_norm)
    tc, tn = TO.clip_by_global_norm(tg, max_norm)
    _close(tn, jn)
    want = checkpoint._flatten(jc)
    for k, v in flat_from_params(tc).items():
        _close(v, want[k], k)
    if max_norm > float(tn):
        assert all(torch.equal(a, b) for a, b in
                   zip(TO.leaves(tc), TO.leaves(tg)))
    # a None leaf (outside the loss's graph) adds nothing to the norm
    tg_none = dict(tg, adapter={"w": None, "b": None})
    jg_zero = dict(jg, adapter=jax.tree.map(jnp.zeros_like, jg["adapter"]))
    _close(TO.clip_by_global_norm(tg_none, max_norm)[1],
           JO.clip_by_global_norm(jg_zero, max_norm)[1])


def _mask(phase, tp):
    jm = {k: jax.tree.map(lambda _, t=(k in (TL.PHASE1_KEYS if phase == 1
                                             else TL.PHASE2_KEYS)): t, v)
          for k, v in _nest(flat_from_params(tp)).items()}
    return jm, TL.phase_mask(tp, phase)


def _check_state(jp, js, tp, ts, what):
    assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32
    for name, j, t in (("params", jp, tp), ("m", js.m, ts.m),
                       ("v", js.v, ts.v)):
        want = checkpoint._flatten(j)
        got = flat_from_params(t)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            _close(v, want[k], f"{what} {name} {k}")


def test_apply_updates_matches_with_a_mask_and_across_a_phase_boundary():
    """Two steps of phase 1 then two of phase 2 on one state: the step
    counter is shared, so phase 2's first update of ``bneck`` uses bias
    corrections at step 3 with m = v = 0; frozen leaves keep their value,
    m and v (the same tensors), with weight decay on."""
    jp, tp, _, _ = _trees(2)
    js, ts = JO.init(jp), TO.init(tp)
    jcfg, tcfg = JTrainConfig(**CFG), TrainConfig(**CFG)
    for i, phase in enumerate((1, 1, 2, 2)):
        _, _, jg, tg = _trees(10 + i)
        jm, tm = _mask(phase, tp)
        before = (TO.leaves(tp), TO.leaves(ts.m), TO.leaves(ts.v))
        jp, js, jinfo = JO.apply_updates(jp, jg, js, jcfg, jm)
        tp, ts, tinfo = TO.apply_updates(tp, tg, ts, tcfg, tm)
        _check_state(jp, js, tp, ts, f"step {i + 1} phase {phase}")
        _close(tinfo["lr"], jinfo["lr"])
        _close(tinfo["grad_norm"], jinfo["grad_norm"])
        after = (TO.leaves(tp), TO.leaves(ts.m), TO.leaves(ts.v))
        for t, *pairs in zip(TO.leaves(tm), *before, *after):
            for a, b in zip(pairs[:3], pairs[3:]):
                assert (a is b) == (not t)


def test_apply_updates_without_mask_and_from_a_carried_state():
    """No mask (every leaf trains), from a state carried across with
    ``adam_state_from_flat``."""
    jp, tp, jg, tg = _trees(3)
    js = JO.init(jp)
    jcfg, tcfg = JTrainConfig(**CFG), TrainConfig(**CFG)
    jp, js, _ = JO.apply_updates(jp, jg, js, jcfg)
    ts = adam_state_from_flat(int(js.step), checkpoint._flatten(js.m),
                              checkpoint._flatten(js.v), device="cpu")
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    _, _, jg, tg = _trees(4)
    jp, js, _ = JO.apply_updates(jp, jg, js, jcfg)
    tp, ts, _ = TO.apply_updates(tp, tg, ts, tcfg)
    _check_state(jp, js, tp, ts, "carried")
