"""The port's deep frontend against the benchmark's plain float64 reference
(``sfmbench/reference/frontends/superpoint_lightglue.py``) on the CPU at a
small size: SuperPoint's heatmap and descriptor field, then its extracted
keypoints and descriptors; the attentional matcher's assignment scores; and
the reference's own ``.npz`` reader against ``convert``'s on the shipped
weights."""

import numpy as np
import pytest
import torch

from eacham_tpu_torch import convert
from eacham_tpu_torch.features.deep import lightglue as lg
from eacham_tpu_torch.features.deep import superpoint as sp
from sfmbench.inputs.orbit_blobs import make
from sfmbench.reference.frontends import superpoint_lightglue as ref
from sfmbench.reference.judge import compare_features

W, H = 64, 48
K_SP, K_LG, LAYERS = 64, 64, 3
# fp32 against float64 through 12 attention blocks: seeds 0-3 at K 64 read at
# most 1.45e-7 on scores up to 0.16 (1 and 4 threads); 1e-5 leaves a factor 70
# for other CPUs' kernels, and a bf16 run of the same matcher reads 7e-3 or more
SCORE_TOL = 1e-5
# SuperPoint's heatmap (values up to 0.04 with random weights, 1 with trained
# ones) and its unit descriptor field: fp32 reads 1.7e-8 and 2e-7 at this
# size; TF32 convolutions read 1.5e-5 and 2e-4
HEAT_TOL, FIELD_TOL = 1e-6, 1e-5
# extraction: the quadratic fit divides by a curvature, so fp32 keypoints move
# up to 3e-3 px from the float64 ones on 128x96 frames of the bench's world
# (the benchmark's limits are set from card readings); descriptors by 2e-7
KP_TOL_PX, DESC_TOL = 0.01, 1e-5


@pytest.fixture(scope="module")
def images():
    params = dict(frames=2, width=W, height=H, n_blobs=900, depth=[3.5, 9.0], spread=2.6,
                  radius=0.6, step_deg=0.5, advance=0.03, f_scale=1.2)
    return torch.as_tensor(make(params, 0)["images"])


def random_superpoint(seed, tmp_path):
    model = sp.init_params(torch.Generator().manual_seed(seed)).eval()
    path = tmp_path / f"sp{seed}.npz"
    lg.save_params(path, model)
    return model, ref._cast(ref.superpoint_params(path), torch.float64, "cpu")


def random_matcher(seed, tmp_path):
    model = lg.init_params(torch.Generator().manual_seed(seed), n_layers=LAYERS).eval()
    path = tmp_path / f"lg{seed}.npz"
    lg.save_params(path, model)
    return model, ref._cast(ref.matcher_params(LAYERS, path), torch.float64, "cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_superpoint_forward_against_the_reference(images, seed, tmp_path):
    model, p = random_superpoint(seed, tmp_path)
    with torch.no_grad():
        heat, field = model(images)
    rheat, rfield = ref.superpoint_forward(p, images.double(), ref.Convs())
    assert (heat.double() - rheat).abs().max() < HEAT_TOL
    assert (field.double() - rfield).abs().max() < FIELD_TOL
    # the TF32 control is one precision below the configuration's and fails
    theat, tfield = ref.superpoint_forward(ref._cast(p, torch.float32, "cpu"), images,
                                           ref.Convs(tf32=True))
    assert (theat.double() - rheat).abs().max() > HEAT_TOL
    assert (tfield.double() - rfield).abs().max() > FIELD_TOL


def assert_same_features(port, reference):
    xy, desc, _, mask = port
    rxy, rdesc, rlive = reference
    assert torch.equal(mask, rlive)
    assert (xy.double() - rxy)[mask].abs().max() < KP_TOL_PX
    assert (desc.double() - rdesc)[mask].abs().max() < DESC_TOL
    nums = compare_features(xy, desc, mask, rxy, rdesc, rlive)
    assert nums["kp_unpaired"] == 0 and nums["kp_gap_px"] < KP_TOL_PX


@pytest.mark.parametrize("seed", [0, 1])
def test_superpoint_extraction_on_random_weights(images, seed, tmp_path):
    # random weights give a flat heatmap (every cell near 1/65, below 0.05):
    # the comparison ranks by heat with no threshold, ties to the lower index
    model, p = random_superpoint(seed, tmp_path)
    port = sp.extract_deep(model, images, max_keypoints=K_SP, score_threshold=0.0)
    assert_same_features(port, ref.extract(p, images.double(), K_SP, score_threshold=0.0))


def test_superpoint_extraction_on_the_shipped_weights(images):
    params, _, _ = _shipped()
    model = convert.superpoint_from_numpy(params).eval()
    port = sp.extract_deep(model, images, max_keypoints=K_SP)
    reference = ref.extract(ref._cast(ref.superpoint_params(), torch.float64, "cpu"),
                            images.double(), K_SP)
    assert port[3].sum() > 20
    assert_same_features(port, reference)


def matcher_inputs(seed):
    g = torch.Generator().manual_seed(100 + seed)
    kps = torch.rand(2, K_LG, 2, generator=g) * 2 - 1
    desc = torch.nn.functional.normalize(torch.randn(2, K_LG, 256, generator=g), dim=-1)
    live = torch.rand(2, K_LG, generator=g) > 0.2
    return kps, desc, live


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matcher_scores_against_the_reference(seed, tmp_path):
    model, p = random_matcher(seed, tmp_path)
    kps, desc, live = matcher_inputs(seed)
    with torch.no_grad():
        scores, _, _ = model(kps[:1], desc[:1], live[:1], kps[1:], desc[1:], live[1:])
        low, _, _ = model.to(torch.bfloat16)(kps[:1].bfloat16(), desc[:1].bfloat16(), live[:1],
                                             kps[1:].bfloat16(), desc[1:].bfloat16(), live[1:])
    rscores = ref.assignment(p, LAYERS, kps[:1].double(), desc[:1].double(), live[:1],
                             kps[1:].double(), desc[1:].double(), live[1:])
    assert rscores.max() > 10 * SCORE_TOL
    assert (scores.double() - rscores).abs().max() < SCORE_TOL
    # the same matcher one precision below fails the tolerance
    assert (low.double() - rscores).abs().max() > SCORE_TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_the_tf32_control_matcher_falls_outside_the_tolerance(seed, tmp_path):
    """The reference's "tf32" control (float32, both operands of every product
    rounded to TF32) is the precision just below the configuration's: its
    scores leave the port's tolerance, as the bf16 matcher's do."""
    from sfmbench.reference.frontend import round_tf32

    _, p = random_matcher(seed, tmp_path)
    kps, desc, live = matcher_inputs(seed)
    args = (kps[:1], desc[:1], live[:1], kps[1:], desc[1:], live[1:])
    as64 = [a.double() if a.is_floating_point() else a for a in args]
    rscores = ref.assignment(p, LAYERS, *as64)
    p32 = ref._cast(p, torch.float32, "cpu")
    tf32 = ref.assignment(p32, LAYERS, *args, rnd=round_tf32)
    assert (tf32.double() - rscores).abs().max() > SCORE_TOL


def test_matcher_matches_on_the_shipped_weights(images):
    """The port's matches equal the reference's on two frames of the bench's
    world through the trained matcher (threshold 0.15)."""
    from eacham_tpu_torch.features.deep.frontend import match_all_pairs_deep

    sp_flat, lg_flat, layers = _shipped()
    spm = convert.superpoint_from_numpy(sp_flat).eval()
    lgm = convert.lightglue_from_numpy(lg_flat, layers).eval()
    xy, desc, _, mask = sp.extract_deep(spm, images, max_keypoints=K_SP)
    pairs = torch.tensor([[0, 1]])
    mj, mv, _ = match_all_pairs_deep(lgm, xy, desc, mask, pairs, (W, H), threshold=0.15)
    fe = {"n_layers": layers, "normalize_size": [W, H], "threshold": 0.15}
    rj, rv = ref.match_pairs({"xy": xy, "desc": desc, "mask": mask}, pairs, fe, chunk=1)
    assert rv.sum() > 5
    assert torch.equal(mv, rv) and torch.equal(mj.long()[mv], rj[rv])


def _shipped():
    from eacham_tpu_torch.features.deep.frontend import load_frontend_params

    _, _, layers = load_frontend_params(device="cpu")
    flats = []
    for name in ("superpoint", "lightglue"):
        with np.load(ref.WEIGHTS / f"{name}.npz") as data:
            flats.append({k: data[k] for k in data.files})
    return flats[0], flats[1], layers


def test_the_references_reader_gives_converts_parameters():
    sp_flat, lg_flat, layers = _shipped()
    port = convert.superpoint_from_numpy(sp_flat).state_dict()
    for name, (w, b) in ref.superpoint_params().items():
        key = f"backbone.{name}" if name[0] == "c" else name
        assert torch.equal(w, port[f"{key}.weight"].double()), name
        assert torch.equal(b, port[f"{key}.bias"].double()), name
    port = convert.lightglue_from_numpy(lg_flat, layers).state_dict()
    theirs = ref.matcher_params(layers)
    assert len(port) == 1 + 2 * len(ref.OUTER) + 4 * layers * 2 * (len(ref.DENSE) + len(ref.NORMS))
    for name, value in theirs.items():
        if name == "desc_sim_gain":
            assert torch.equal(value, port[name].double())
        elif name in ref.OUTER:
            assert torch.equal(value[0], port[f"{name}.weight"].double()), name
            assert torch.equal(value[1], port[f"{name}.bias"].double()), name
        else:
            for sub, (a, b) in value.items():
                assert torch.equal(a, port[f"{name}.{sub}.weight"].double()), (name, sub)
                assert torch.equal(b, port[f"{name}.{sub}.bias"].double()), (name, sub)
    # a file of another depth leaves arrays without a place, and is refused
    with pytest.raises(ValueError, match="no place"):
        ref.matcher_params(layers - 1)
