"""Multi-scene / multi-device execution of the SfM compute path.

Counterpart of sfm_tpu/parallel/multiscene.py.  The per-frame stages (LK
tracking, LO-RANSAC, the BA iterations) take a leading ``scene`` axis, and
the scenes are spread over the ranks of a ``("scene", "hyp")`` mesh
(``parallel/mesh.make_mesh``; BASELINE config 5).  Where the JAX twin
``vmap``s a per-scene function and ``shard_map``s it over the mesh, here
each rank runs its own scenes on plain tensors and reduces over the mesh
with explicit collectives:

  * LK takes the stack of the rank's scenes in ONE ``klt.lk_track_fb``
    call, so one K3 launch per level and direction serves all of them;
  * LO-RANSAC and the BA run scene by scene, each scene with its own
    draws;
  * the hypotheses of one RANSAC can be split over the ``hyp`` ranks
    (``find_E_sharded``): an all-reduce MIN of the truncated cost picks
    the winner, the tensor-parallel analogue for this workload.

Draws: a ``draws`` argument is either a list of ``torch.Generator``s, one
per scene on the tensors' device, or an (S,H,N) stack of sampling
priorities (tests hand in the JAX twin's draws, as ``find_E_ransac``'s
``pri=`` takes them).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sfm_tpu_torch.config import KLTConfig
from sfm_tpu_torch.models import tracker
from sfm_tpu_torch.ops import ba as ba_ops, epipolar, klt
from sfm_tpu_torch.ops.features import top_k_stable
from sfm_tpu_torch.parallel.multi_scan import scene_seed
from sfm_tpu_torch.utils import debug


def scene_draws(draws, s: int):
    """(generator, priorities) of scene ``s`` from ``draws``: a list of
    generators or an (S,H,N) priority stack (the other one ``None``)."""
    if isinstance(draws, torch.Tensor):
        return None, draws[s]
    return draws[s], None


def _stack_relpose(rps) -> epipolar.RelPose:
    """Per-scene ``RelPose``s as one with a leading S axis on every field."""
    return epipolar.RelPose(*(torch.stack(f) for f in zip(*rps)))


# ---------------------------------------------------------------------------
# scene-batched stages (a leading S axis)
# ---------------------------------------------------------------------------


def batched_two_view(draws, xi, xj, valid, num_hypotheses: int = 256,
                     sampson_thresh: float = 2e-5, min_inliers: int = 16):
    """LO-RANSAC per scene: xi/xj (S,N,2), valid (S,N); ``draws`` per
    scene (module docstring).  Returns a ``RelPose`` with a leading S."""
    rps = []
    for s in range(xi.shape[0]):
        gen, pri = scene_draws(draws, s)
        rps.append(epipolar.find_E_ransac(
            gen, xi[s], xj[s], valid[s], num_hypotheses=num_hypotheses,
            sampson_thresh=sampson_thresh, min_inliers=min_inliers, pri=pri))
    return _stack_relpose(rps)


def batched_lk(pyr0, pyr1, pts, valid, levels: int, iters: int, radius: int,
               fb_thresh: float = 1.0, device="cuda"):
    """Forward-backward LK over scenes: ONE ``klt.lk_track_fb`` call on
    the stacks (one K3 launch per level and direction for all scenes).

    pyr0/pyr1: tuples of (S,H,W) tensors (finest first); pts (S,T,2),
    valid (S,T).  Returns (new_pts (S,T,2), ok (S,T))."""
    return klt.lk_track_fb(pyr0, pyr1, pts, valid, levels=levels,
                           iters=iters, radius=radius, fb_thresh=fb_thresh,
                           device=device)


def batched_ba_step(problems: ba_ops.BAProblem, iters: int = 3,
                    huber_delta: float = 2e-3):
    """The Schur-LM bundle adjuster per scene (a leading S axis on every
    ``BAProblem`` field).  Returns (R_wc, t_wc, X, info) stacked over
    scenes, ``info``'s entries too."""
    outs = [ba_ops.bundle_adjust(ba_ops.BAProblem(*(f[s] for f in problems)),
                                 iters=iters, huber_delta=huber_delta)
            for s in range(problems.R_wc.shape[0])]
    R, t, X, infos = zip(*outs)
    info = {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
    return torch.stack(R), torch.stack(t), torch.stack(X), info


# ---------------------------------------------------------------------------
# hypothesis-sharded RANSAC (tensor-parallel analogue)
# ---------------------------------------------------------------------------


def _hyp_shard_scores(gen, xi, xj, valid, num_hypotheses: int, thr,
                      pri=None):
    """This rank's hypothesis chunk: draw (or take ``pri``, (H,N)), fit,
    score.  Returns the rank's best (E, truncated cost)."""
    N = xi.shape[0]
    if pri is None:
        pri = epipolar.sample_priorities(gen, num_hypotheses, N, xi.device)
    with debug.nan_ok():  # -inf holds the invalid entries out
        pri = torch.where(valid[None, :], pri, torch.full_like(
            pri, float("-inf")))
        _, sample_idx = top_k_stable(pri, 8)
    E = epipolar.eight_point_E(xi[sample_idx], xj[sample_idx])
    err = epipolar.sampson_error(E, xi[None], xj[None])
    cost = torch.sum(torch.where(valid[None], torch.minimum(err, thr),
                                 torch.zeros_like(err)), dim=-1)
    best = torch.argmin(cost)
    return E[best], cost[best]


def find_E_sharded(seed: int, xi, xj, valid, mesh,
                   num_hypotheses_total: int = 2048,
                   sampson_thresh: float = 2e-5, pri=None):
    """Essential-matrix search with the hypotheses split over the mesh's
    ``hyp`` ranks: each rank draws, fits and scores its chunk of
    ``max(total // hyp, 8)``, the winner is the all-reduce MIN of the
    truncated cost over the ``hyp`` group, and every rank returns the same
    (E, cost).  Exact ties across ranks average their E (as the JAX
    twin's psum does).

    Rank h draws from a generator seeded ``scene_seed(seed, h)`` (the JAX
    twin folds the ``hyp`` index into its key), or takes ``pri``, its own
    (chunk, N) priorities (tests)."""
    n_hyp = mesh.size(1)
    chunk = max(num_hypotheses_total // n_hyp, 8)
    thr = torch.as_tensor(sampson_thresh, dtype=xi.dtype, device=xi.device)
    gen = None
    if pri is None:
        gen = torch.Generator(device=xi.device)
        gen.manual_seed(scene_seed(seed, mesh.get_local_rank("hyp")))
    E_loc, c_loc = _hyp_shard_scores(gen, xi, xj, valid, chunk, thr, pri)
    group = mesh.get_group("hyp")
    c_min = c_loc.clone()
    dist.all_reduce(c_min, op=dist.ReduceOp.MIN, group=group)
    is_best = (c_loc == c_min).to(xi.dtype)
    n_best = is_best.clone()
    dist.all_reduce(n_best, group=group)
    E_best = E_loc * is_best / torch.clamp(n_best, min=1.0)
    dist.all_reduce(E_best, group=group)
    return E_best, c_min


# ---------------------------------------------------------------------------
# scene-sharded lockstep odometry step (the multi-device "training step")
# ---------------------------------------------------------------------------


def make_scene_step(mesh, klt_cfg: KLTConfig, num_hypotheses: int = 128,
                    sampson_thresh: float = 2e-5, ba_iters: int = 2,
                    huber_delta: float = 2e-3):
    """The multi-device frame step.

    On this rank's scenes (the rows of its ``scene`` coordinate,
    ``distributed.scene_shard``): LK-track the track table into the new
    frame (one K3 pass for all of them), run LO-RANSAC for the relative
    pose and ``ba_iters`` LM iterations of the window BA, scene by scene.
    The health metrics (live tracks, inliers, BA cost) are summed on the
    rank, then all-reduced over the ``scene`` group; ranks of one
    ``scene`` coordinate compute the same scenes (the JAX twin's
    ``P("scene")`` replicates over ``hyp``), so none is counted twice.

    Returns step(draws, K, pyr0, pyr1, state, prob) ->
    (new_state, RelPose batch, (R_wc, t_wc, X), metrics dict), where
    ``state`` is a ``TrackerState`` and ``prob`` a ``BAProblem``, each
    with a leading S on every field."""
    levels = klt_cfg.pyr_levels
    group = mesh.get_group("scene")

    def step(draws, K, pyr0, pyr1, state, prob):
        new_pos, ok = batched_lk(
            pyr0, pyr1, state.pos, state.valid, levels=levels,
            iters=klt_cfg.iters, radius=klt_cfg.win_radius,
            fb_thresh=klt_cfg.fb_thresh, device=state.pos.device)
        matched = state.valid & ok
        new_state = tracker.TrackerState(
            pos=torch.where(matched[..., None], new_pos, state.pos),
            valid=matched,
            ids=torch.where(matched, state.ids, -1),
            next_id=state.next_id,
        )
        xi = epipolar.normalize_by_K(K, state.pos)
        xj = epipolar.normalize_by_K(K, new_pos)
        rp = batched_two_view(draws, xi, xj, matched,
                              num_hypotheses=num_hypotheses,
                              sampson_thresh=sampson_thresh, min_inliers=8)
        R_wc, t_wc, X, info = batched_ba_step(prob, iters=ba_iters,
                                              huber_delta=huber_delta)
        metrics = {"tracks_alive": torch.sum(matched),
                   "inliers": torch.sum(rp.num_inliers),
                   "ba_cost": torch.sum(info["cost"])}
        for v in metrics.values():
            dist.all_reduce(v, group=group)
        return new_state, rp, (R_wc, t_wc, X), metrics

    return step
