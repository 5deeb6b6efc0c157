"""One reconstruction per input: the port's fixed-order segment sums
(eacham_tpu_torch.ba.core ``_layout`` / ``_seg_sum``) against
``jax.ops.segment_sum``, and the SfM paths run under a guard that refuses
every floating-point scatter-add, on the CPU.

The segment sums are held to the reference within 1e-5 relative (fp32,
another order of the same terms) and, on integer-valued float64 rows that
no fp32 sum could hold, to the exact sum. Under the guard (``index_add``,
``scatter_add``, ``index_put(accumulate=True)``, ``put(accumulate=True)``
and order-dependent ``scatter_reduce`` / ``index_reduce`` on a floating
tensor raise: on the card each is a float atomic whose result depends on
the order of arrival) run ``refine_ba`` in every solver and method,
``refine_ba_sharded`` on two gloo ranks and on a group of one (equal bits
to ``refine_ba``), ``run_sfm``, the anchored ``resume_sfm``, two windows of
``StreamingReconstructor`` and ``run_sfm_rgbd``, each at the size of its own
test file.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from torch.utils._python_dispatch import TorchDispatchMode

from eacham_tpu_torch import convert
from eacham_tpu_torch.ba import core as tba
from tests.test_torch_ba import make_problem
from tests.test_torch_streaming import SIZE as STREAM_SIZE, _opts as stream_options
from tests.test_torch_streaming import stream_scene  # noqa: F401
from tests.test_torch_sweep import OPTS as SWEEP_OPTS, SIZE as SWEEP_SIZE, sequence  # noqa: F401

torch.set_num_threads(2)

_SCATTER_ADD = {"index_add", "index_add_", "scatter_add", "scatter_add_"}
_ACCUMULATE = {"index_put", "index_put_", "_index_put_impl_", "put", "put_"}
_REDUCE = {"scatter_reduce", "scatter_reduce_", "index_reduce", "index_reduce_"}


class FloatScatterGuard(TorchDispatchMode):
    """Raises on a floating-point scatter whose result depends on the order
    in which its rows arrive; counts the operators it saw."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        name = func.overloadpacket.__name__
        if args and isinstance(args[0], torch.Tensor) and args[0].is_floating_point():
            refused = name in _SCATTER_ADD
            if name in _ACCUMULATE:
                refused = bool(kwargs.get("accumulate", args[3] if len(args) > 3 else False))
            if name in _REDUCE:
                reduce = kwargs.get("reduce", args[4] if len(args) > 4 else None)
                refused = reduce in ("sum", "mean", "prod")
            if refused:
                raise AssertionError(f"floating-point scatter-add on the SfM path: {func}")
        return func(*args, **kwargs)


def test_the_guard_refuses_float_scatter_adds_only():
    idx = torch.tensor([0, 1, 0])
    with FloatScatterGuard() as g:
        torch.zeros(2, dtype=torch.int32).index_add_(0, idx, torch.ones(3, dtype=torch.int32))
        torch.zeros(2).index_put_((idx,), torch.ones(3))                # last one wins
        torch.zeros(2).scatter_reduce_(0, idx, torch.ones(3), "amax")
        for bad in (lambda: torch.zeros(2).index_add_(0, idx, torch.ones(3)),
                    lambda: torch.zeros(2).index_add(0, idx, torch.ones(3)),
                    lambda: torch.zeros(2).scatter_add_(0, idx, torch.ones(3)),
                    lambda: torch.scatter_add(torch.zeros(2), 0, idx, torch.ones(3)),
                    lambda: torch.zeros(2).index_put_((idx,), torch.ones(3), accumulate=True),
                    lambda: torch.zeros(2).scatter_reduce_(0, idx, torch.ones(3), "sum")):
            with pytest.raises(AssertionError, match="scatter-add"):
                bad()
    assert g.ops > 0


# ---- the segment sums against jax.ops.segment_sum -----------------------------

C, K, L = 6, 40, 50


def _obs(layout: str, rng):
    """(obs_cam, obs_pt, obs_mask) of one of the builders' camera layouts:
    ``window`` (``ba_problem_windowed`` uncompacted: C runs of exactly K),
    ``compacted`` (the taken rows in camera order, then a padded tail on
    camera 0 and landmark 0), or ``shuffled`` (any other order). Landmarks
    10-19 are seen by no row; landmark 3 holds half the live rows; masked
    rows point at landmark 0, which keeps a few real observations."""
    O = C * K
    cam = np.repeat(np.arange(C), K)
    pt = rng.choice(np.r_[1:10, 20:L], size=O)
    pt[rng.permutation(O)[:O // 2]] = 3
    mask = rng.uniform(size=O) > 0.3
    pt[:3], mask[:3] = 0, True                     # landmark 0's real observations
    pt = np.where(mask, pt, 0)
    if layout == "compacted":
        keep = np.flatnonzero(mask)
        tail = O // 4
        cam = np.r_[cam[keep], np.zeros(tail, int)]
        pt = np.r_[pt[keep], np.zeros(tail, int)]
        mask = np.r_[np.ones(keep.size, bool), np.zeros(tail, bool)]
    elif layout == "shuffled":
        perm = rng.permutation(O)
        cam, pt, mask = cam[perm], pt[perm], mask[perm]
    return cam, pt, mask


def _problem(cam, pt, mask):
    """A BAProblem carrying only the shapes and the observation index
    arrays that the layout reads."""
    t = torch.as_tensor
    return tba.BAProblem(
        poses=torch.zeros(C, 4, 4), points=torch.zeros(L, 3), intr=torch.zeros(4),
        obs_cam=t(cam, dtype=torch.int64), obs_pt=t(pt, dtype=torch.int64),
        obs_uv=torch.zeros(len(cam), 2), obs_mask=t(mask),
        cam_in_ba=torch.ones(C, dtype=torch.bool), cam_fixed=torch.zeros(C, dtype=torch.bool),
        pt_in_ba=torch.ones(L, dtype=torch.bool), pt_obs_count=torch.ones(L))


def _jacobians(rng, mask, a, b, dtype=np.float32, integer=False):
    """[O, 2, a], [O, 2, b] rows, zero where masked (as ``_obs_linearize``
    weighs them), and [O, 2] residuals."""
    O = mask.shape[0]
    draw = ((lambda *s: rng.integers(-2**20, 2**20, size=s) * 2.0**10) if integer
            else (lambda *s: rng.normal(size=s)))
    on = mask[:, None, None]
    return ((draw(O, 2, a) * on).astype(dtype), (draw(O, 2, b) * on).astype(dtype),
            (draw(O, 2) * mask[:, None]).astype(dtype))


@pytest.mark.parametrize("layout", ["window", "compacted", "shuffled"])
def test_segment_sums_match_jax_segment_sum(layout):
    """Camera, landmark and (landmark, camera) sums of J1^T J2 and J^T r
    within 1e-5 relative of ``jax.ops.segment_sum`` over the same rows;
    the window sums its equal runs in place, the other layouts gather each
    camera's rows into a padded row; landmark 0's segment holds its real
    observations only, and landmarks that no row sees sum to zero."""
    rng = np.random.default_rng(0)
    cam, pt, mask = _obs(layout, rng)
    lay = tba._layout(_problem(cam, pt, mask), pairs=True)
    assert (lay.cam.slots is None) == (layout == "window")
    if layout != "window":
        assert lay.cam.slots.shape == (C, int(np.bincount(cam[mask], minlength=C).max()))
    n0 = int(((pt == 0) & mask).sum())
    assert int(lay.pt.offsets[1] - lay.pt.offsets[0]) == n0 == 3

    J1, J2, r = _jacobians(rng, mask, 6, 3)
    outer = np.einsum("oki,okj->oij", J1, J2)
    vec = np.einsum("oki,ok->oi", J1, r)
    for seg, ids, n in ((lay.cam, cam, C), (lay.pt, pt, L), (lay.pair, pt * C + cam, L * C)):
        for got, rows in ((tba._seg_outer(torch.as_tensor(J1), torch.as_tensor(J2), seg), outer),
                          (tba._seg_vec(torch.as_tensor(J1), torch.as_tensor(r), seg), vec)):
            ref = np.asarray(jax.ops.segment_sum(jnp.asarray(rows), jnp.asarray(ids),
                                                 num_segments=n))
            assert got.shape == ref.shape
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max())
    empty = tba._seg_vec(torch.as_tensor(J1), torch.as_tensor(r), lay.pt)[10:20]
    assert torch.equal(empty, torch.zeros_like(empty))


@pytest.mark.parametrize("layout", ["window", "compacted", "shuffled"])
def test_segment_sums_are_exact_in_float64(layout):
    """Integer-valued float64 rows of up to 2^30, whose sums fp32 cannot
    hold: every segment equals the exact integer sum, so no row is lost,
    counted twice or summed in a narrower type."""
    rng = np.random.default_rng(1)
    cam, pt, mask = _obs(layout, rng)
    lay = tba._layout(_problem(cam, pt, mask), pairs=True)
    J1, J2, r = _jacobians(rng, mask, 6, 3, dtype=np.float64, integer=True)
    J2 = np.round(J2 / 2.0**28)                   # keep products of J1 and J2 under 2^53 / O
    r = np.round(r / 2.0**28)
    for seg, ids, n in ((lay.cam, cam, C), (lay.pt, pt, L), (lay.pair, pt * C + cam, L * C)):
        got = tba._seg_outer(torch.as_tensor(J1), torch.as_tensor(J2), seg).numpy()
        exact = np.zeros((n, 6, 3), np.int64)
        np.add.at(exact, ids, np.einsum("oki,okj->oij", J1.astype(np.int64),
                                        J2.astype(np.int64)))
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, exact.astype(np.float64))
        got = tba._seg_vec(torch.as_tensor(J1), torch.as_tensor(r), seg).numpy()
        exact = np.zeros((n, 6), np.int64)
        np.add.at(exact, ids, np.einsum("oki,ok->oi", J1.astype(np.int64), r.astype(np.int64)))
        np.testing.assert_array_equal(got, exact.astype(np.float64))


# ---- the SfM paths under the guard ----------------------------------------------

@pytest.mark.parametrize("solver,method,anchors", [
    ("dense", "lm", False), ("pcg", "lm", False), ("dense", "dogleg", False),
    ("pcg", "dogleg", False), ("dense", "lm", True), ("pcg", "lm", True)])
def test_refine_ba_has_no_float_scatter_add_and_repeats_its_bits(solver, method, anchors):
    d, _ = make_problem(anchors=anchors)
    p = convert.ba_problem_from_numpy(d, device="cpu")
    cfg = tba.BAConfig(max_iters=6, tolerance=1e-7, solver=solver, method=method,
                       trust_radius_init=10.0, cg_iters=20)
    with FloatScatterGuard():
        a = tba.refine_ba(p, cfg)
    b = tba.refine_ba(p, cfg)
    assert a[3]["final_cost"] < a[3]["initial_cost"]
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    assert a[3]["iterations"] == b[3]["iterations"]


WORLD = 2


def _rank_main(rank, init_file, out_dir):
    """Two gloo ranks: ``refine_ba_sharded`` over both and over a group of
    this rank alone, both under the guard, and ``refine_ba`` beside them."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from eacham_tpu_torch.parallel import init_distributed, make_mesh, refine_ba_sharded
    from eacham_tpu_torch.parallel.mesh import Mesh

    init_distributed(f"file://{init_file}", WORLD, rank, device="cpu")
    mesh = make_mesh(WORLD, device="cpu")
    alone = [dist.new_group([r]) for r in range(WORLD)][rank]
    one = Mesh(alone, 1, 0, torch.device("cpu"), ("shard",), {"shard": 1})
    out = {}
    for solver in ("dense", "pcg"):
        p = convert.ba_problem_from_numpy(make_problem()[0], device="cpu")
        cfg = tba.BAConfig(max_iters=8, solver=solver, cg_iters=20)
        with FloatScatterGuard():
            out[solver, 2] = refine_ba_sharded(p, cfg, mesh)[:3]
            out[solver, 1] = refine_ba_sharded(p, cfg, one)[:3]
        out[solver, 0] = tba.refine_ba(p, cfg)[:3]
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    dist.destroy_process_group()


def test_refine_ba_sharded_has_no_float_scatter_add(tmp_path):
    """Two ranks end equal to each other and within 1e-4 of ``refine_ba``
    (their partial sums are added in another order); a group of one rank
    gives ``refine_ba``'s bits."""
    ctx = tmp.spawn(_rank_main, args=(str(tmp_path / "store"), str(tmp_path)), nprocs=WORLD,
                    join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the two gloo ranks did not finish in 120 s")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for solver in ("dense", "pcg"):
        plain = ranks[0][solver, 0]
        for r in range(WORLD):
            assert all(torch.equal(a, b) for a, b in zip(ranks[r][solver, 1], plain))
            assert all(torch.equal(a, b) for a, b in zip(ranks[r][solver, 2],
                                                         ranks[0][solver, 2]))
            for a, b in zip(ranks[r][solver, 2], plain):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_run_sfm_has_no_float_scatter_add(sequence):  # noqa: F811
    """tests/test_torch_sweep.py's 12-frame sequence, every frame registered."""
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, run_sfm

    uv, dsc, vis, intr, _ = sequence
    with FloatScatterGuard():
        scene, stats = run_sfm(uv, dsc, vis, SWEEP_SIZE, intr=intr,
                               options=SfmOptions(**SWEEP_OPTS), device="cpu")
    assert stats["registered"] == uv.shape[0] and stats["global_ba"] is not None


def test_anchored_resume_has_no_float_scatter_add(sequence):  # noqa: F811
    """The anchored path of scripts/anchor_probe.py at the sweep test's
    size: ``run_sfm`` on its 12 frames, five frames spread over the
    registered ones anchored to the truth in the estimate's frame, then
    ``resume_sfm(abs_anchors=...)`` (every global BA with the absolute
    priors) under the guard, and again without it: equal bits."""
    from eacham_tpu_torch.sfm import anchors_in_estimate_frame
    from eacham_tpu_torch.sfm.pipeline import SfmOptions, resume_sfm, run_sfm

    uv, dsc, vis, intr, Ts = sequence
    opt = SfmOptions(**SWEEP_OPTS, abs_sigma_pos=0.05, abs_sigma_rot=0.005)
    scene, _ = run_sfm(uv, dsc, vis, SWEEP_SIZE, intr=intr, options=opt, device="cpu")
    reg = np.flatnonzero(scene.pose_valid.numpy())
    ids = reg[np.linspace(0, len(reg) - 1, 5).round().astype(int)]
    anchors = anchors_in_estimate_frame(scene.pose, Ts, ids, valid=scene.pose_valid)
    with FloatScatterGuard():
        a, stats = resume_sfm(scene, options=opt, verbose=False, abs_anchors=anchors,
                              device="cpu")
    b, _ = resume_sfm(scene, options=opt, verbose=False, abs_anchors=anchors, device="cpu")
    assert stats["registered"] == uv.shape[0] and stats["global_ba"] is not None
    assert torch.equal(a.pose, b.pose) and torch.equal(a.points, b.points)


def test_streaming_has_no_float_scatter_add(stream_scene):  # noqa: F811
    """Two windows of tests/test_torch_streaming.py's stream, the second
    one finalized."""
    from eacham_tpu_torch.sfm.streaming import StreamingReconstructor

    images, _, intr = stream_scene
    rec = StreamingReconstructor(STREAM_SIZE, intr=intr, options=stream_options(),
                                 max_frames=16, window=8, retrieval_k=2, finalize_every=2,
                                 device="cpu")
    with FloatScatterGuard():
        rec.process(images[:8])
        st = rec.process(images[8:16])
    assert st["registered"] >= 14 and "global_ba" in st


def test_run_sfm_rgbd_has_no_float_scatter_add():
    """tests/test_rgbd.py's metric world with exact depth."""
    from eacham_tpu_torch.sfm import rgbd as trgbd
    from tests.test_torch_rgbd import OPTS as RGBD_OPTS
    from tests.test_rgbd import _metric_world

    uv, desc, vis, pc, _, intr = _metric_world(np.random.default_rng(0))
    kp_z = (pc[..., 2] * np.asarray(vis)).astype(np.float32)
    with FloatScatterGuard():
        _, stats = trgbd.run_sfm_rgbd(np.asarray(uv), np.asarray(desc), np.asarray(vis), kp_z,
                                      np.asarray(intr), options=RGBD_OPTS, verbose=False,
                                      device="cpu")
    assert stats["registered"] >= 7 and stats["global_ba"] is not None
