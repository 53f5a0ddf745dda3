"""Loop verification, correction, global BA and the system's loop glue in
the port against the JAX reference, on the reference's hand-built map with
a drifted revisit (keyframe 0 and the last keyframe see one cloud, the
last one recorded 0.31 m off, with its own copies of the cloud's points),
built by the reference and carried across with `convert.map_to_torch`.
The map capacities are cut to 4096 points, 32 keyframes and 512 features.

Tolerances: `verify_loop` fed the reference's draws gives the same
verdict, inlier count and intermediate match masks, `T_corr` to 1e-3;
`correct_loop`, `search_and_fuse` and `global_ba` from the same input keep
the integer state exactly and poses and points to 1e-3 (64- and
48-iteration float32 CG solves summed in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lc_crf_slam_tpu.config import LoopConfig, MapConfig, SLAMConfig
from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3
from lc_crf_slam_tpu.models import loopclosing as ref_lc
from lc_crf_slam_tpu.models.system import SLAMSystem as RefSystem
from lc_crf_slam_torch import convert
from lc_crf_slam_torch.geometry.camera import TUM3
from lc_crf_slam_torch.models import loopclosing as lc
from lc_crf_slam_torch.models.system import SLAMSystem

from torch_parity import (assert_map_equal, drifted_loop_map, reference_horn_sampler,
                          use_reference_draws, with_loop_twins)

CFG = SLAMConfig(loop=LoopConfig(min_kfs_since_last=5),
                 map=MapConfig(max_points=4096, max_keyframes=32, max_features=512))
KEY = jax.random.PRNGKey(0)
STATE_TOL = 1e-3


def _idx(k):
    return jnp.asarray(k, jnp.int32), torch.tensor(int(k), dtype=torch.int32)


class _Recorder:
    """Stands in for a module's `resolve_duplicates` and keeps what it
    returned: verify_loop's three match masks, in order."""

    def __init__(self, module):
        self.fn, self.masks = module.resolve_duplicates, []

    def __call__(self, *args):
        out = self.fn(*args)
        self.masks.append(np.asarray(out))
        return out


def verify_both(monkeypatch, m_ref, m, kf, cand, key=KEY):
    """Both packages' verify_loop with the reference's draws: (reference
    result, port result, reference masks, port masks)."""
    rec_ref, rec = _Recorder(ref_lc), _Recorder(lc)
    monkeypatch.setattr(ref_lc, "resolve_duplicates", rec_ref)
    monkeypatch.setattr(lc, "resolve_duplicates", rec)
    (kf_j, kf_t), (cand_j, cand_t) = _idx(kf), _idx(cand)
    ref = ref_lc.verify_loop(CFG, REF_TUM3, m_ref, kf_j, cand_j, key)
    out = lc.verify_loop(CFG, TUM3, m, kf_t, cand_t, reference_horn_sampler(key))
    return ref, out, rec_ref.masks, rec.masks


@pytest.fixture(scope="module")
def loop_state():
    """The drifted map with the loop keyframe's twins, in both packages,
    the reference's verification of (loop keyframe, keyframe 0) and its
    map after `correct_loop`."""
    m_ref, kf_loop, T_true, T_drift = drifted_loop_map(CFG)
    m_ref, n_cloud = with_loop_twins(m_ref, kf_loop, T_true, T_drift)
    kf = int(kf_loop)
    ver = ref_lc.verify_loop(CFG, REF_TUM3, m_ref, jnp.asarray(kf, jnp.int32),
                             jnp.asarray(0, jnp.int32), KEY)
    assert bool(ver.accepted)
    corrected = ref_lc.correct_loop(CFG, REF_TUM3, m_ref, jnp.asarray(kf, jnp.int32),
                                    jnp.asarray(0, jnp.int32), ver.T_corr)
    return dict(m_ref=m_ref, m=convert.map_to_torch(m_ref), kf=kf, T_true=T_true,
                n_cloud=n_cloud, ver=ver, corrected=corrected)


@pytest.mark.parametrize("kf", ["loop", 0])
def test_kf_world_points(loop_state, kf):
    """Depth-backed world points of a keyframe's features: 1e-5, the
    usable mask exactly; with the depth removed the map points stand in."""
    kf = loop_state["kf"] if kf == "loop" else kf
    for strip in (False, True):
        m_ref, m = loop_state["m_ref"], loop_state["m"]
        if strip:
            m_ref = m_ref._replace(kf_depth=jnp.zeros_like(m_ref.kf_depth))
            m = m._replace(kf_depth=torch.zeros_like(m.kf_depth))
        kf_j, kf_t = _idx(kf)
        pw_ref, ok_ref = ref_lc._kf_world_points(REF_TUM3, m_ref, kf_j)
        pw, ok = lc._kf_world_points(TUM3, m, kf_t)
        np.testing.assert_array_equal(np.asarray(ok_ref), ok.numpy())
        np.testing.assert_allclose(np.asarray(pw_ref), pw.numpy(), atol=1e-5)
        assert ok.sum() == loop_state["n_cloud"]


def test_verify_loop_matches_reference(loop_state, monkeypatch):
    s = loop_state
    ref, out, masks_ref, masks = verify_both(monkeypatch, s["m_ref"], s["m"], s["kf"], 0)
    assert bool(ref.accepted) and bool(out.accepted)
    assert int(ref.n_inliers) == int(out.n_inliers) >= CFG.loop.min_sim3_inliers
    # descriptor matches, first and second projection round
    assert len(masks_ref) == len(masks) == 3
    for name, a, b in zip(("mv", "mv_g", "mv_b"), masks_ref, masks):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.sum() >= CFG.loop.min_total_matches, name
    # ... and with mv, pairs_ok = mv & usable 3D on both sides
    # (test_kf_world_points holds the usable masks)
    np.testing.assert_allclose(np.asarray(ref.T_corr), out.T_corr.numpy(), atol=STATE_TOL)
    assert float(ref.s_corr) == float(out.s_corr) == 1.0
    # the correction recovers the true pose of the loop keyframe
    T = out.T_corr.numpy()
    T_fixed = s["m"].kf_Tcw[s["kf"]].numpy() @ np.linalg.inv(T)
    np.testing.assert_allclose(T_fixed[:3, 3], s["T_true"][:3, 3], atol=0.03)


@pytest.mark.parametrize("cand", [6, -1])
def test_verify_loop_rejects(loop_state, monkeypatch, cand):
    """A keyframe that looks elsewhere, and the no-candidate index: both
    packages reject, with the identity as correction and the same masks."""
    s = loop_state
    ref, out, masks_ref, masks = verify_both(monkeypatch, s["m_ref"], s["m"], s["kf"], cand)
    assert not bool(ref.accepted) and not bool(out.accepted)
    assert torch.equal(out.T_corr, torch.eye(4)) and float(out.s_corr) == 1.0
    np.testing.assert_array_equal(masks_ref[0], masks[0])
    if cand == -1:      # the same pairs as candidate 0: only `cand >= 0` rejects
        assert int(ref.n_inliers) == int(out.n_inliers) > 0
        for a, b in zip(masks_ref, masks):
            np.testing.assert_array_equal(a, b)


def test_correct_loop_matches_reference(loop_state):
    s = loop_state
    (kf_j, kf_t), (c_j, c_t) = _idx(s["kf"]), _idx(0)
    T_corr = torch.from_numpy(np.array(s["ver"].T_corr))
    out = lc.correct_loop(CFG, TUM3, s["m"], kf_t, c_t, T_corr)
    assert_map_equal(s["corrected"], out, float_tol=STATE_TOL)
    # the branch moved onto the loop, the anchors stayed, twins merged
    before = np.linalg.norm(s["m"].kf_Tcw[s["kf"], :3, 3].numpy() - s["T_true"][:3, 3])
    after = np.linalg.norm(out.kf_Tcw[s["kf"], :3, 3].numpy() - s["T_true"][:3, 3])
    assert after < 0.3 * before
    assert torch.equal(out.kf_Tcw[0], s["m"].kf_Tcw[0])
    assert int(out.p_alive.sum()) <= 1.25 * s["n_cloud"] < int(s["m"].p_alive.sum())


@pytest.mark.parametrize("budget", [1, 4])
def test_search_and_fuse_matches_reference(loop_state, budget):
    """On the pose-graph-corrected map before its own fuse (budget 1: the
    current keyframe, as correct_loop ends) and on the corrected map (4:
    the group, padded with the current keyframe)."""
    s = loop_state
    kf_j, kf_t = _idx(s["kf"])
    if budget == 1:
        c = s["corrected"]
        m_ref = s["m_ref"]._replace(kf_Tcw=c.kf_Tcw, p_xyz=jnp.where(
            s["m_ref"].p_alive[:, None] & ~c.p_alive[:, None], s["m_ref"].p_xyz, c.p_xyz))
        # the merged twins' positions: moved like their survivors'
        D = np.asarray(c.kf_Tcw[s["kf"]])
        D = np.linalg.inv(D) @ np.asarray(s["m_ref"].kf_Tcw[s["kf"]])
        moved = np.asarray(s["m_ref"].p_xyz) @ D[:3, :3].T + D[:3, 3]
        dead = np.asarray(s["m_ref"].p_alive & ~c.p_alive)
        m_ref = m_ref._replace(p_xyz=jnp.where(jnp.asarray(dead)[:, None],
                                               jnp.asarray(moved, jnp.float32), m_ref.p_xyz))
    else:
        m_ref = s["corrected"]
    ref = ref_lc.search_and_fuse(CFG, REF_TUM3, m_ref, kf_j, budget=budget)
    out = lc.search_and_fuse(CFG, TUM3, convert.map_to_torch(m_ref), kf_t, budget=budget)
    assert_map_equal(ref, out, float_tol=1e-6)
    if budget == 1:
        assert int(np.asarray(m_ref.p_alive).sum()) - int(out.p_alive.sum()) > 100


def test_global_ba_matches_reference(loop_state):
    """The whole-map problem field by field, then two LM iterations on the
    corrected map with 3 cm of noise on its points."""
    m_ref = loop_state["corrected"]
    noise = 0.03 * jax.random.normal(jax.random.PRNGKey(3), m_ref.p_xyz.shape)
    m_ref = m_ref._replace(p_xyz=jnp.where(m_ref.p_alive[:, None], m_ref.p_xyz + noise,
                                           m_ref.p_xyz))
    m = convert.map_to_torch(m_ref)
    prob_ref, prob = ref_lc._map_ba_problem(CFG, m_ref), lc._map_ba_problem(CFG, m)
    for f in prob_ref._fields:
        np.testing.assert_allclose(np.asarray(getattr(prob_ref, f)),
                                   getattr(prob, f).numpy(), atol=1e-7, err_msg=f)
    ref = ref_lc.global_ba(CFG, REF_TUM3, m_ref, n_iters=2)
    out = lc.global_ba(CFG, TUM3, m, n_iters=2)
    assert_map_equal(ref, out, float_tol=STATE_TOL)
    alive = np.asarray(m_ref.p_alive)
    moved = np.linalg.norm(out.p_xyz.numpy() - np.asarray(m_ref.p_xyz), axis=-1)[alive]
    assert np.median(moved) > 1e-3


def test_global_ba_alternating_matches_reference(loop_state):
    """The block-coordinate global BA, 5 rounds on the drifted map with 3
    cm of noise on its live points (tests/test_loopclosing.py's
    TestGlobalBA at this module's capacities): keyframe poses to 1e-4,
    live points to 1e-3; the points come back toward the map."""
    m_ref = loop_state["m_ref"]
    noise = 0.03 * jax.random.normal(jax.random.PRNGKey(3), m_ref.p_xyz.shape)
    noisy_ref = m_ref._replace(p_xyz=jnp.where(m_ref.p_alive[:, None],
                                               m_ref.p_xyz + noise, m_ref.p_xyz))
    ref = ref_lc.global_ba_alternating(CFG, REF_TUM3, noisy_ref, n_rounds=5)
    out = lc.global_ba_alternating(CFG, TUM3, convert.map_to_torch(noisy_ref), n_rounds=5)
    np.testing.assert_allclose(out.kf_Tcw.numpy(), np.asarray(ref.kf_Tcw), atol=1e-4)
    alive = np.asarray(m_ref.p_alive)
    np.testing.assert_allclose(out.p_xyz.numpy()[alive], np.asarray(ref.p_xyz)[alive],
                               atol=1e-3)
    dist = lambda m: np.linalg.norm(np.asarray(m.p_xyz) - np.asarray(m_ref.p_xyz),
                                    axis=-1)[alive]
    assert np.median(dist(out)) < 0.5 * np.median(dist(noisy_ref))


# ---- the system's glue -----------------------------------------------------

def _pre(cfg, kf):
    """A detection of candidate 0 with its group {0}, as a chunk fetches it."""
    cands = np.full((cfg.loop.retrieval_topk,), -1, np.int64)
    cands[0] = 0
    groups = np.zeros((cfg.loop.retrieval_topk, cfg.map.max_keyframes), bool)
    groups[0, 0] = True
    return kf, True, cands, groups


def _both_systems(loop_state, cfg=CFG):
    ref = RefSystem(REF_TUM3, cfg, enable_mapping=False, enable_crf=False)
    port = SLAMSystem(TUM3, cfg, enable_mapping=False, enable_crf=False, device="cpu")
    use_reference_draws(port)
    ref.map, port.map = loop_state["m_ref"], loop_state["m"]
    ref.initialized = port.initialized = True
    kf_j, kf_t = _idx(loop_state["kf"])
    ref.ts = ref.ts._replace(ref_kf=kf_j, Tcw=loop_state["m_ref"].kf_Tcw[loop_state["kf"]])
    port.ts = port.ts._replace(ref_kf=kf_t, Tcw=loop_state["m"].kf_Tcw[loop_state["kf"]])
    return ref, port


def _maps_close(ref, port):
    assert_map_equal(ref.map, port.map, float_tol=STATE_TOL)


@pytest.fixture(scope="module")
def closed(loop_state):
    """Both systems after three consistent detections of the revisit."""
    ref, port = _both_systems(loop_state)
    for s in (ref, port):
        for _ in range(CFG.loop.consistency_needed):
            assert not s.loop_log
            s._try_close_loop(pre=_pre(CFG, loop_state["kf"]))
    return ref, port


def test_try_close_loop_closes_as_reference(loop_state, closed):
    """The third detection verifies and corrects: the same log, the map
    and the re-anchored tracker as the reference's, the global-BA budget
    open and nothing of it run yet."""
    ref, port = closed
    assert len(port.loop_log) == 1 and port.loop_log == ref.loop_log
    assert port.loop_log[0] == {"kf": loop_state["kf"], "cand": 0,
                                "inliers": port.loop_log[0]["inliers"], "s_corr": 1.0}
    assert port.n_verify_loops == 1
    assert port._consistent_groups == [] and port._last_loop_kf == loop_state["kf"]
    np.testing.assert_allclose(np.asarray(ref.ts.Tcw), port.ts.Tcw.numpy(), atol=STATE_TOL)
    assert torch.equal(port.ts.Tcw, port.map.kf_Tcw[loop_state["kf"]])
    assert torch.equal(port.ts.vel, torch.eye(4))
    assert port._gba_pending == ref._gba_pending == {
        "left": CFG.loop.gba_total_iters, "kf": loop_state["kf"]}


def test_pump_gba_slices_are_bounded_and_drain(loop_state, closed):
    """Each call consumes `gba_slice_iters` of the budget; the last one
    fuses the group and clears it; the maps agree after every slice."""
    ref, port = closed
    ref = _clone_ref(ref)
    port = _clone_port(port)
    pumps = 0
    while port._gba_pending is not None:
        left = port._gba_pending["left"]
        ref._pump_gba()
        port._pump_gba()
        pumps += 1
        _maps_close(ref, port)
        if port._gba_pending is not None:
            assert left - port._gba_pending["left"] == CFG.loop.gba_slice_iters
    expect = -(-CFG.loop.gba_total_iters // CFG.loop.gba_slice_iters)
    assert pumps == expect == port._gba_slices_run == ref._gba_slices_run
    assert ref._gba_pending is None
    port._pump_gba()                       # nothing pending: nothing runs
    assert port._gba_slices_run == expect


def _clone_ref(ref):
    new = RefSystem(REF_TUM3, ref.cfg, enable_mapping=False, enable_crf=False)
    new.map, new.ts, new.initialized = ref.map, ref.ts, True
    new._gba_pending = dict(ref._gba_pending)
    return new


def _clone_port(port):
    new = SLAMSystem(TUM3, port.cfg, enable_mapping=False, enable_crf=False, device="cpu")
    new.map, new.ts, new.initialized = port.map, port.ts, True
    new._gba_pending = dict(port._gba_pending)
    return new


@pytest.mark.parametrize("export", ["get_trajectory", "save_keyframe_trajectory_tum",
                                    "shutdown"])
def test_trajectory_export_drains_pending_budget(closed, export, tmp_path):
    """An export never reads half-refined poses: the whole budget runs
    first, in one slice."""
    port = _clone_port(closed[1])
    port.trajectory.append((0.0, torch.eye(4), torch.tensor(0)))
    args = (str(tmp_path / "kf.txt"),) if export.startswith("save") else ()
    getattr(port, export)(*args)
    assert port._gba_pending is None and port._gba_slices_run == 1
    port.reset()
    assert port._gba_pending is None and port.loop_log == [] and port._gba_slices_run == 0


def test_sync_fallback_runs_whole_budget_inline(loop_state):
    """`gba_slice_iters=0`: the closure itself runs the budget and the
    group-wide fuse, as the reference's."""
    cfg = dataclasses.replace(CFG, loop=dataclasses.replace(CFG.loop, gba_slice_iters=0))
    ref, port = _both_systems(loop_state, cfg)
    for s in (ref, port):
        for _ in range(cfg.loop.consistency_needed):
            s._try_close_loop(pre=_pre(cfg, loop_state["kf"]))
        assert s._gba_pending is None and s._gba_slices_run == 1
    assert port.loop_log == ref.loop_log and len(port.loop_log) == 1
    _maps_close(ref, port)


def test_rejected_candidates_leave_the_map(loop_state):
    """Ready candidates that fail verification: up to three are tried in
    order, nothing is corrected, and the streak state stays."""
    _, port = _both_systems(loop_state)
    pre = list(_pre(CFG, loop_state["kf"]))
    pre[2] = np.array([6, 7, 8, 9, -1, -1, -1, -1])
    pre[3] = np.zeros_like(pre[3])
    pre[3][:4, 5] = True
    for _ in range(CFG.loop.consistency_needed):
        port._try_close_loop(pre=tuple(pre))
    assert port.n_verify_loops == 3 and port.loop_log == []
    assert port._gba_pending is None and port.map is loop_state["m"]
    assert [st for _, st in port._consistent_groups] == [3, 3, 3, 3]


# ---- end to end ------------------------------------------------------------

@pytest.mark.slow
def test_pan_loop_closes_as_reference_in_throughput_mode():
    """The reference's default-config loop world (a 1.2-turn pan over a
    textured wall with 1.5 cm depth noise, QVGA, 130 frames) through both
    packages' `track_sequence(chunk=15)` with the reference's draws. Both
    make the same keyframes, lose the same frames and close the loop at
    the same keyframe with the same candidate. The world drifts by
    design, and the drift amplifies float32 differences: the poses agree
    to 3 mm / 3 mrad over the first chunk only, and over the whole run
    each package's trajectory error stays under the reference's bar for
    this world (0.35 m), the two within 0.1 m of each other."""
    from lc_crf_slam_tpu.utils.evaluate import evaluate_ate
    from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
    from torch_parity import CAM_REF, assert_poses_close, run_sequences

    n, chunk = 130, 15
    world = RefWorld(cam=CAM_REF, n_frames=n, n_static=900, n_dynamic=0, seed=5,
                     trajectory="pan", wall=True, pan_leadin=0.1, pan_turns=1.2,
                     pan_translation=0.25, render_depth_noise=0.015)
    ref, port, poses_ref, poses_port = run_sequences(world, range(n), chunk,
                                                     cfg=SLAMConfig())
    ref.flush_stats()
    port.flush_stats()
    events = lambda s: [(e["event"], e["t"], e.get("lost_frames")) for e in s.stats
                        if e.get("event", "").startswith("chunk_")]
    slices = (ref._gba_slices_run, port._gba_slices_run)
    t_ref, tr = ref.get_trajectory()
    t_port, tp = port.get_trajectory()
    gt_t, gt = world.groundtruth()
    ate_ref = evaluate_ate(t_ref, tr, gt_t, gt).rmse
    ate_port = evaluate_ate(t_port, tp, gt_t, gt).rmse
    dpos = np.linalg.norm(poses_ref[:, :3, 3] - poses_port[:, :3, 3], axis=-1)
    print("loop_log", ref.loop_log, port.loop_log, "verified", port.n_verify_loops)
    print("events", events(ref), events(port), "slices in the run", slices)
    print("ATE", ate_ref, ate_port, "max pose difference per chunk",
          [float(dpos[i:i + chunk].max()) for i in range(0, n - 1, chunk)])
    print("keyframes", int(ref.map.n_kfs), int(port.map.n_kfs),
          "same log", ref.kf_log == port.kf_log)

    assert len(ref.loop_log) >= 1 and len(port.loop_log) == len(ref.loop_log)
    for a, b in zip(ref.loop_log, port.loop_log):
        assert (a["kf"], a["cand"], a["s_corr"]) == (b["kf"], b["cand"], b["s_corr"])
        assert abs(a["inliers"] - b["inliers"]) <= 5
    assert ref.kf_log == port.kf_log
    assert events(ref) == events(port)
    assert slices[0] == slices[1] >= 1
    assert port._gba_pending is None and ref._gba_pending is None
    assert_poses_close(poses_ref, poses_port, 3e-3, 3e-3, frames=np.arange(n - 1) < chunk)
    assert np.isfinite(tp).all() and ate_ref < 0.35 and ate_port < 0.35
    assert abs(ate_ref - ate_port) < 0.1
