"""The matcher's held-out operating curve on the port, on the CPU:
``scripts/tune_deep_recall_torch.py`` against ``scripts/tune_deep_recall.py``.

- ``sweep`` of both packages on the shipped weights over the script's 48
  held-out SuperPoint pairs (``make_sp_batch`` with ``default_rng(99)``, 64
  keypoints) at thresholds 0.1, 0.15 and 0.5: precision and recall agree
  within RECALL_TOL (0.02, ``chip_smoke.py``'s gate for the card). Reading
  on the CPU: the two packages' counts are equal at all seven thresholds
  of the ``recall`` phase (``scripts/deep_recall_jax.py``: at 0.5, 252
  true, 36 false positives, 186 missed; precision 0.8750, recall 0.5753),
  so the packages' own spread here is 0.
- ``graft`` keeps the copied layers' tensors and a graft to the same depth
  changes no output.
- ``main --save`` with ``train_lightglue_sp`` and ``sweep`` stubbed, on a
  copy of ``weights/``: the matcher and its meta are written only when the
  F1 at 0.5 rises, and the file loads in the JAX package's ``load_params``.
"""

import importlib.util
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import RECALL_TOL  # noqa: E402

torch.set_num_threads(2)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _load("tune_deep_recall_port", "scripts/tune_deep_recall_torch.py")


@pytest.fixture(scope="module")
def shipped():
    from eacham_tpu_torch.features.deep.frontend import load_frontend_params

    return load_frontend_params(device="cpu")


def test_sweep_agrees_with_the_reference(port, shipped):
    import jax.numpy as jnp

    from eacham_tpu.features.deep import lightglue as jlg
    from eacham_tpu.features.deep import superpoint as jsp

    ref = _load("tune_deep_recall_ref", "scripts/tune_deep_recall.py")
    thresholds = [0.1, 0.15, 0.5]
    key = jax.random.PRNGKey(0)
    to32 = lambda t: jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), t)  # noqa: E731
    wdir = ROOT / "weights"
    sp_params = to32(jlg.load_params(wdir / "superpoint.npz", jsp.init_params(key)))
    lg_params = to32(jlg.load_params(wdir / "lightglue.npz", jlg.init_params(key, n_layers=3)))
    want = ref.sweep(sp_params, lg_params, 3, thresholds)
    superpoint, matcher, n_layers = shipped
    assert n_layers == 3
    got = port.sweep(superpoint, matcher, thresholds)
    for t in thresholds:
        (p, r), (jp, jr) = got[t], want[t]
        assert abs(p - jp) <= RECALL_TOL and abs(r - jr) <= RECALL_TOL, (t, got[t], want[t])
        assert 0.5 < p < 1.0 and 0.5 < r < 1.0, (t, got[t])
    # recall falls and precision rises with the threshold
    assert got[0.1][1] > got[0.5][1] and got[0.1][0] < got[0.5][0]


def test_graft_copies_the_trained_layers(port, shipped):
    from eacham_tpu_torch.features.deep import lightglue as lg

    _, matcher, n_layers = shipped
    deep = port.graft(matcher, 5)
    assert deep.n_layers == 5
    src, dst = matcher.state_dict(), deep.state_dict()
    assert set(src) < set(dst)
    assert all(torch.equal(src[k], dst[k]) for k in src)
    tail = [k for k in dst if k not in src]
    assert tail and all(re.match(r"(self|cross)[01]_[34]\.", k) for k in tail), tail
    fresh = lg.init_params(torch.Generator().manual_seed(1), n_layers=5)
    assert all(torch.equal(dst[k], fresh.state_dict()[k]) for k in tail)

    same = port.graft(matcher, n_layers)
    rng = np.random.default_rng(0)
    kp = torch.as_tensor(rng.uniform(-1, 1, (2, 32, 2)), dtype=torch.float32)
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(2, 32, 256)),
                                                      dtype=torch.float32), dim=-1)
    m = torch.as_tensor(rng.uniform(size=(2, 32)) < 0.8)
    for a, b in zip(lg.match_deep(matcher, kp, d, m, kp.flip(1), d.flip(1), m.flip(1)),
                    lg.match_deep(same, kp, d, m, kp.flip(1), d.flip(1), m.flip(1))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rises", [True, False], ids=["f1_rises", "f1_falls"])
def test_save_writes_only_when_f1_rises(port, tmp_path, monkeypatch, capsys, rises):
    from eacham_tpu.features.deep import lightglue as jlg
    from eacham_tpu_torch.features.deep import train

    wdir = tmp_path / "weights"
    shutil.copytree(ROOT / "weights", wdir)
    before = {p.name: p.read_bytes() for p in wdir.iterdir()}
    monkeypatch.setattr(port, "WEIGHTS", wdir)
    base = {0.3: (0.8, 0.7), 0.4: (0.85, 0.65), 0.5: (0.875, 0.575), 0.6: (0.9, 0.5)}
    after = {**base, 0.5: (0.9, 0.62) if rises else (0.86, 0.56)}
    results = iter([base, after])
    monkeypatch.setattr(port, "sweep", lambda *a, **k: next(results))

    def fake_train(sp_params, steps, batch, lr, n_layers, params, n_kps, device):
        assert steps == 2 and n_layers == 3 and n_kps == 64
        model = port.graft(params, n_layers)
        with torch.no_grad():
            model.final1.bias.add_(0.25)
        return model, [1.0, 0.5]

    monkeypatch.setattr(train, "train_lightglue_sp", fake_train)
    monkeypatch.setattr(sys, "argv", ["tune_deep_recall_torch.py", "--steps", "2", "--save",
                                      "--device", "cpu"])
    assert port.main() == 0
    out = capsys.readouterr().out
    assert out.count("before: thr=") == 4 and out.count("after:  thr=") == 4
    now = {p.name: p.read_bytes() for p in wdir.iterdir()}
    if not rises:
        assert "NOT saved (F1 0.694 -> 0.678)" in out
        assert now == before
        return
    assert f"saved {wdir / 'lightglue.npz'} + meta" in out
    assert now["superpoint.npz"] == before["superpoint.npz"]
    assert now["lightglue.npz"] != before["lightglue.npz"]
    meta = (wdir / "lightglue.meta").read_text().splitlines()
    assert meta[:2] == ["n_layers=3", "steps=+2"] and meta[3:] == [
        "precision=0.900 (held-out SuperPoint-output pairs)", "recall=0.620"]
    # the JAX package reads the file into its own tree
    key = jax.random.PRNGKey(0)
    params = jlg.load_params(wdir / "lightglue.npz", jlg.init_params(key, n_layers=3))
    shipped = jlg.load_params(ROOT / "weights" / "lightglue.npz",
                              jlg.init_params(key, n_layers=3))
    got = np.asarray(params["params"]["final1"]["bias"], np.float32)
    want = np.asarray(shipped["params"]["final1"]["bias"], np.float32) + np.float32(0.25)
    assert np.array_equal(got, want)
    assert np.array_equal(np.asarray(params["params"]["self0_0"]["q"]["kernel"]),
                          np.asarray(shipped["params"]["self0_0"]["q"]["kernel"]))
