"""The deep frontend's parameters in the port against the JAX package on
the CPU: ``save_params`` / ``load_params`` files move both ways with equal
arrays, ``convert``'s two directions are inverses, ``init_params`` and the
missing-weights fallback of ``load_frontend_params`` draw flax's
initialisation (the distribution: the bits of threefry cannot match), and
nothing here or in the trainers touches the shipped ``weights/``.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax

from eacham_tpu.features.deep import lightglue as jlg
from eacham_tpu.features.deep import superpoint as jsp
from eacham_tpu_torch import convert
from eacham_tpu_torch.features.deep import lightglue as lg
from eacham_tpu_torch.features.deep import superpoint as sp
from eacham_tpu_torch.features.deep.frontend import load_frontend_params

from tests.test_torch_deep import WEIGHTS, _flat

torch.set_num_threads(2)


def _weights_digest():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(WEIGHTS.iterdir()) if p.suffix in (".npz", ".meta")}


DIGEST_AT_IMPORT = _weights_digest()


@pytest.fixture(scope="module")
def reference_inits():
    """flax's initialisation of both networks (two LightGlue layers)."""
    sp_p = jax.jit(jsp.init_params)(jax.random.PRNGKey(3))
    lg_p = jax.jit(lambda k: jlg.init_params(k, n_layers=2, n_kps=16))(jax.random.PRNGKey(4))
    return _flat(sp_p), _flat(lg_p)


def _kernels(flat):
    return {k: v for k, v in flat.items() if k.endswith("['kernel']")}


def _check_init(ours: dict, ref: dict):
    """Kernels: per layer of at least 10^4 entries, the std within 5% of
    flax's (the std of such a sample is known to under 1%), and the smaller
    layers pooled after scaling by sqrt(fan_in); every entry within +-2
    sigma of the truncated draw. Biases zero, LayerNorm scales 1, the
    similarity gain 5."""
    assert ours.keys() == ref.keys()
    assert all(ours[k].shape == ref[k].shape for k in ref)
    small_o, small_r = [], []
    for k, r in _kernels(ref).items():
        o = ours[k]
        fan = int(np.prod(r.shape[:-1]))      # kernels are [..., in, out]
        sigma = fan ** -0.5 / 0.87962566103423978
        assert np.abs(o).max() <= 2 * sigma * (1 + 1e-6), k
        if r.size >= 10_000:
            assert abs(o.std() / r.std() - 1) < 0.05, (k, o.std(), r.std())
        else:
            small_o.append(o.ravel() * fan ** 0.5)
            small_r.append(r.ravel() * fan ** 0.5)
    if small_o:
        so, sr = np.concatenate(small_o), np.concatenate(small_r)
        assert abs(so.std() / sr.std() - 1) < 0.05, (so.std(), sr.std())
    for k in ref:
        if k.endswith("['bias']") or k.endswith("['scale']") or "desc_sim_gain" in k:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_superpoint_init_params_draws_flax_distribution(reference_inits):
    model = sp.init_params(torch.Generator().manual_seed(3))
    assert isinstance(model, sp.SuperPointNet)
    _check_init(convert.superpoint_to_numpy(model), reference_inits[0])


def test_lightglue_init_params_draws_flax_distribution(reference_inits):
    model = lg.init_params(torch.Generator().manual_seed(4), n_layers=2, n_kps=16)
    assert model.n_layers == 2 and model.desc_sim_gain.item() == 5.0
    _check_init(convert.lightglue_to_numpy(model), reference_inits[1])


def test_init_params_follows_its_generator():
    a = lg.init_params(torch.Generator().manual_seed(5), n_layers=1)
    b = lg.init_params(torch.Generator().manual_seed(5), n_layers=1)
    c = lg.init_params(torch.Generator().manual_seed(6), n_layers=1)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.self0_0.q.weight, c.self0_0.q.weight)


def test_missing_weights_fall_back_to_flax_initialisation(tmp_path, reference_inits):
    """``load_frontend_params`` on a directory without weight files: both
    modules drawn as the reference's fallback draws them (its
    ``init_params``), the depth from the meta file."""
    (tmp_path / "lightglue.meta").write_text("n_layers=2\n")
    superpoint, matcher, n_layers = load_frontend_params(weights_dir=tmp_path, device="cpu")
    assert n_layers == 2 and superpoint.weights_path is None and matcher.weights_path is None
    _check_init(convert.superpoint_to_numpy(superpoint), reference_inits[0])
    _check_init(convert.lightglue_to_numpy(matcher), reference_inits[1])


@pytest.mark.parametrize("net", ["superpoint", "lightglue"])
def test_convert_to_numpy_inverts_from_numpy(net):
    with np.load(WEIGHTS / f"{net}.npz") as data:
        flat = {k: data[k] for k in data.files}
    if net == "superpoint":
        back = convert.superpoint_to_numpy(convert.superpoint_from_numpy(flat))
    else:
        back = convert.lightglue_to_numpy(convert.lightglue_from_numpy(flat, n_layers=3))
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert back[k].dtype == np.float32 and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v.astype(np.float32), err_msg=k)


@pytest.mark.parametrize("net", ["superpoint", "lightglue"])
def test_port_file_loads_in_the_reference(tmp_path, net):
    """The port's save_params -> the reference's load_params: equal arrays,
    the reference's keys, one array per leaf."""
    if net == "superpoint":
        model = sp.init_params(torch.Generator().manual_seed(7))
        like = jax.eval_shape(jsp.init_params, jax.random.PRNGKey(0))
        flat = convert.superpoint_to_numpy(model)
    else:
        model = lg.init_params(torch.Generator().manual_seed(7), n_layers=2)
        like = jax.eval_shape(lambda k: jlg.init_params(k, n_layers=2), jax.random.PRNGKey(0))
        flat = convert.lightglue_to_numpy(model)
    path = tmp_path / f"{net}.npz"
    lg.save_params(path, model)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(_flat(like).keys())
    loaded = _flat(jlg.load_params(path, like))
    for k, v in flat.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)


@pytest.mark.parametrize("net", ["superpoint", "lightglue"])
def test_reference_file_loads_in_the_port(tmp_path, net):
    """The reference's save_params -> the port's load_params: equal arrays;
    ``dtype`` casts on the host as the reference's does."""
    if net == "superpoint":
        params = jax.jit(jsp.init_params)(jax.random.PRNGKey(8))
        like, to_numpy = sp.SuperPointNet(), convert.superpoint_to_numpy
    else:
        params = jax.jit(lambda k: jlg.init_params(k, n_layers=2))(jax.random.PRNGKey(8))
        like, to_numpy = lg.LightGlueMatcher(n_layers=2), convert.lightglue_to_numpy
    path = tmp_path / f"{net}.npz"
    jlg.save_params(path, params)
    ref = _flat(params)
    model = lg.load_params(path, like)
    assert type(model) is type(like) and not model.training
    got = to_numpy(model)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    half = to_numpy(lg.load_params(path, like, dtype=np.float16))
    for k, v in ref.items():
        assert half[k].dtype == np.float16
        np.testing.assert_array_equal(half[k], np.asarray(v, np.float16), err_msg=k)


def test_load_params_refuses_another_layout(tmp_path):
    path = tmp_path / "lg.npz"
    lg.save_params(path, lg.init_params(torch.Generator().manual_seed(9), n_layers=2))
    with pytest.raises(ValueError):
        lg.load_params(path, lg.LightGlueMatcher(n_layers=1))
    with pytest.raises(TypeError):
        lg.save_params(path, torch.nn.Linear(2, 2))


def test_shipped_weights_are_untouched():
    """Runs after this file's tests (and, in the same process, whatever ran
    before them): the shipped files hash as they did at import."""
    assert DIGEST_AT_IMPORT and _weights_digest() == DIGEST_AT_IMPORT
