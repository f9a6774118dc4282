"""The port's training launcher (``repro_torch.launch.train``) with the
arguments of ``tests/test_launchers.py``'s two train tests (which fail in
the JAX package under jax 0.9, ROADMAP Queue 3), on the CPU, its
``--resume``, and ``launch.serve --ckpt`` serving the trained weights:
the same tokens as the weights in memory, bit for bit.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import split as JSP
from repro.training import checkpoint as JC
from repro_torch.configs import get_reduced
from repro_torch.convert import flat_tensors
from repro_torch.launch import serve
from repro_torch.launch import train as train_launch
from repro_torch.training import checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its steps are many
    small ops, which stall when several test processes' thread teams share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_launcher_monolithic(tmp_path):
    hist = train_launch.main([
        "--arch", "xlstm-125m", "--reduced", "--steps", "4",
        "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
        "--device", "cpu"])
    assert "phase1" in hist
    losses = [h["loss"] for h in hist["phase1"]]
    assert all(np.isfinite(losses))
    assert os.path.exists(tmp_path / "xlstm-125m.npz")
    assert set(hist["ms_per_step"]) == {"phase1"}
    on_disk = json.load(open(tmp_path / "xlstm-125m_history.json"))
    assert on_disk["phase1"] == hist["phase1"]


def test_train_launcher_cascade_dpi(tmp_path):
    """Algorithm 1 through the launcher, then the checkpoint: it holds the
    bank and the backbone in the reference's layout (the JAX package
    restores it into its own tree), and ``serve --ckpt`` decodes from it
    the tokens the saved weights give in memory."""
    saved = {}
    orig = checkpoint.save

    def keep(path, tree, metadata=None):
        saved["tree"] = tree
        orig(path, tree, metadata)

    checkpoint.save = keep
    try:
        hist = train_launch.main([
            "--arch", "qwen2.5-3b", "--reduced", "--steps", "6",
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
            "--cascade", "--device", "cpu"])
    finally:
        checkpoint.save = orig
    ens = hist["cascade"]
    assert len(ens["losses"]) >= 2
    # Algorithm 1's Ensure line: later modes at most as good
    assert ens["losses"][0] <= ens["losses"][1] + 0.5   # smoke-scale slack
    assert set(hist["ms_per_step"]) == {"phase1", "phase2"}
    logged = [r["loss"] for p in hist["phases"] for r in p["log"]]
    assert logged and all(np.isfinite(logged))
    path = str(tmp_path / "qwen2_5-3b.npz")
    assert JC.load_metadata(path) == {"arch": "qwen2.5-3b", "steps": 6,
                                      "reduced": True}
    back = JC._flatten(JC.restore(path, JSP.init_split_params(
        jax.random.PRNGKey(0), j_reduced("qwen2.5-3b"))))
    assert sorted(back) == sorted(flat_tensors(saved["tree"]))

    argv = ["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
            "--requests", "2", "--prompt-len", "4", "--gen", "6",
            "--cache-len", "32", "--policy", "static1"]
    from_ckpt = serve.main(argv + ["--ckpt", path])
    args = serve.parser().parse_args(argv)
    in_memory = serve.run_sync(args, get_reduced("qwen2.5-3b"),
                               saved["tree"])
    untrained = serve.main(argv)
    assert from_ckpt["generated"] == in_memory["generated"]
    assert from_ckpt["generated"] != untrained["generated"]


def test_train_launcher_resume(tmp_path):
    """``--resume`` starts from a checkpoint's weights: on the same first
    batch, the resumed run's first loss is below the fresh init's, which
    the first run's equals."""
    base = ["--arch", "qwen2.5-3b", "--reduced", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--lr", "3e-3"]
    first = train_launch.main(base + ["--steps", "8", "--ckpt-dir",
                                      str(tmp_path / "a")])
    resumed = train_launch.main(base + [
        "--steps", "2", "--ckpt-dir", str(tmp_path / "b"), "--resume",
        str(tmp_path / "a" / "qwen2_5-3b.npz")])
    fresh = train_launch.main(base + ["--steps", "2", "--ckpt-dir",
                                      str(tmp_path / "c")])
    l0 = [h["phase1"][0]["loss"] for h in (first, resumed, fresh)]
    assert l0[2] == l0[0]                  # the same init and batch 0
    assert l0[1] < l0[0]                   # trained weights, same batch 0


def test_train_launcher_refuses(monkeypatch):
    """--mp must divide the ranks (here torchrun's three): ``ValueError``
    before any process group starts; so must --dp x --mp be them."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "3")
    base = ["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu"]
    with pytest.raises(ValueError, match="not divisible by mp=2"):
        train_launch.main(base + ["--mp", "2"])
    with pytest.raises(ValueError, match="needs 2 ranks"):
        train_launch.main(base + ["--dp", "2", "--mp", "1"])


def test_train_launcher_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launch.main(["--arch", "qwen2.5-3b", "--reduced"])
