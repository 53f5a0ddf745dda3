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
import os

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


def _clone_system(s, port: bool):
    """A copy of a system after its first closure: map, tracker, the loop
    glue's host state, its counters; the reference's verification key back
    at its start, and the port's draws restarted with it."""
    if port:
        new = SLAMSystem(TUM3, s.cfg, enable_mapping=False, enable_crf=False, device="cpu")
        use_reference_draws(new)
        new.n_verify_loops = s.n_verify_loops
    else:
        new = RefSystem(REF_TUM3, s.cfg, enable_mapping=False, enable_crf=False)
        new._reloc_key = jax.random.PRNGKey(7)
    new.map, new.ts, new.initialized = s.map, s.ts, True
    new.loop_log = [dict(e) for e in s.loop_log]
    new._last_loop_kf, new._gba_slices_run = s._last_loop_kf, s._gba_slices_run
    new._consistent_groups = list(s._consistent_groups)
    new._gba_pending = None if s._gba_pending is None else dict(s._gba_pending)
    return new


def test_pump_gba_slices_are_bounded_and_drain(loop_state, closed):
    """Each call consumes `gba_slice_iters` of the budget; the last one
    fuses the group and clears it; the maps agree after every slice."""
    ref, port = closed
    ref, port = _clone_system(ref, False), _clone_system(port, True)
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


@pytest.mark.parametrize("export", ["get_trajectory", "save_keyframe_trajectory_tum",
                                    "shutdown"])
def test_trajectory_export_drains_pending_budget(closed, export, tmp_path):
    """An export never reads half-refined poses: the whole budget runs
    first, in one slice."""
    port = _clone_system(closed[1], True)
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


def test_try_close_loop_per_frame_closes_as_reference(loop_state):
    """The per-frame path (`pre=None`: the system detects for its current
    reference keyframe and fetches the detection itself), three frames in
    a row on the drifted map: the same log, map and re-anchored tracker as
    the reference's, and the first global-BA slice run by the frame's pump."""
    ref, port = _both_systems(loop_state)
    for s in (ref, port):
        for _ in range(CFG.loop.consistency_needed):
            assert not s.loop_log
            s._try_close_loop()
        s._pump_gba()
    assert port.n_detect_loops == CFG.loop.consistency_needed
    assert len(port.loop_log) == 1 and port.loop_log[0]["kf"] == loop_state["kf"]
    for a, b in zip(ref.loop_log, port.loop_log):
        assert (a["kf"], a["cand"], a["s_corr"]) == (b["kf"], b["cand"], b["s_corr"])
        assert a["inliers"] == b["inliers"]
    np.testing.assert_allclose(np.asarray(ref.ts.Tcw), port.ts.Tcw.numpy(), atol=STATE_TOL)
    assert port._gba_slices_run == ref._gba_slices_run == 1
    assert port._gba_pending == ref._gba_pending
    _maps_close(ref, port)


# ---- a second loop on one map ----------------------------------------------

SECOND_TRUE = (0.04, 0.03, 0.0, 0.0, -0.02, 0.0)     # the second revisit's pose (se3)
SECOND_DRIFT = (-0.2, 0.08, 0.12)                      # ... recorded this far off (m)


def _second_revisit(ref, port, n_away=4, seed=9):
    """Extend both maps alike, after the first closure: `n_away` keyframes
    that look elsewhere, then one that revisits the cloud (keyframe 0's
    points, as the reference's corrected map holds them) from a pose
    recorded with drift, with its own copies of the cloud as the first
    revisit had. Returns the revisiting keyframe's index."""
    from lc_crf_slam_tpu.geometry.se3 import exp_se3
    from lc_crf_slam_tpu.models.mapstate import add_keyframe as ref_add_keyframe
    from lc_crf_slam_tpu.models.mapstate import add_points as ref_add_points
    from lc_crf_slam_torch.models.mapstate import add_keyframe, add_points
    from torch_parity import _observing_frame

    rng = np.random.default_rng(seed)
    m = ref.map
    K = CFG.map.max_features
    n_cloud = int(np.sum(np.asarray(m.kf_obs[0]) >= 0))
    ids0 = np.asarray(m.kf_obs[0])[:n_cloud]
    pts, descs = np.asarray(m.p_xyz)[ids0], np.asarray(m.p_desc)[ids0]
    no_obs = np.full(K, -1, np.int32)

    def add_kf(frame, Tcw, obs):
        t = float(int(ref.map.n_kfs))
        ref.map, kf = ref_add_keyframe(ref.map, frame, jnp.asarray(Tcw), jnp.asarray(t),
                                       jnp.asarray(obs))
        port.map, kf_p = add_keyframe(port.map, convert.frame_to_torch(frame),
                                      torch.tensor(Tcw), torch.tensor(t, dtype=torch.float64),
                                      torch.from_numpy(obs))
        assert int(kf) == int(kf_p)
        return int(kf)

    for i in range(n_away):
        Ti = np.asarray(exp_se3(jnp.asarray([2.0 + 0.1 * i, 0, 0, 0, -0.3, 0], jnp.float32)))
        away = rng.integers(0, 2**32, (n_cloud, 8), dtype=np.uint32)
        add_kf(_observing_frame(rng, pts + np.float32([-8.0, 0, 0]), away, Ti, CFG), Ti, no_obs)
    T_true = np.asarray(exp_se3(jnp.asarray(SECOND_TRUE, jnp.float32)))
    dT = np.eye(4, dtype=np.float32)
    dT[:3, 3] = SECOND_DRIFT
    T_drift = (T_true @ dT).astype(np.float32)
    kf = add_kf(_observing_frame(rng, pts, descs, T_true, CFG), T_drift, no_obs)
    # the drifted branch's copies of the cloud, observed by the new keyframe
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    Twc = np.linalg.inv(T_drift)
    dup = (pc @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32)
    args = [dup, descs, np.zeros((n_cloud, 3), np.float32), np.zeros(n_cloud, np.float32),
            np.full(n_cloud, 100.0, np.float32), np.ones(n_cloud, bool)]
    ref.map, ids_ref = ref_add_points(ref.map, *map(jnp.asarray, args),
                                      jnp.asarray(kf, jnp.int32))
    port.map, ids = add_points(port.map, *(convert._to_tensor(a, "cpu") for a in args),
                               torch.tensor(kf, dtype=torch.int32))
    np.testing.assert_array_equal(np.asarray(ids_ref), ids.numpy())
    ref.map = ref.map._replace(kf_obs=ref.map.kf_obs.at[kf, :n_cloud].set(ids_ref),
                               p_n_obs=ref.map.p_n_obs.at[ids_ref].add(1))
    port.map = port.map._replace(
        kf_obs=port.map.kf_obs.index_put((torch.tensor(kf), torch.arange(n_cloud)), ids),
        p_n_obs=port.map.p_n_obs.index_add(0, ids.long(), torch.ones_like(ids)))
    return kf


def _detect(s, kf, n=CFG.loop.consistency_needed):
    for _ in range(n):
        s._try_close_loop(pre=_pre(CFG, kf))


def _same_loop_state(ref, port):
    """The loop glue's host state, the re-anchored tracker and the map."""
    assert port.loop_log == ref.loop_log
    assert port._gba_pending == ref._gba_pending
    assert port._last_loop_kf == ref._last_loop_kf
    assert port._gba_slices_run == ref._gba_slices_run
    g_ref, g = (convert.consistent_groups_to_numpy(s._consistent_groups) for s in (ref, port))
    assert len(g_ref) == len(g)
    assert all(np.array_equal(a, b) and sa == sb for (a, sa), (b, sb) in zip(g_ref, g))
    np.testing.assert_allclose(np.asarray(ref.ts.Tcw), port.ts.Tcw.numpy(), atol=STATE_TOL)
    np.testing.assert_array_equal(np.asarray(ref.ts.vel), port.ts.vel.numpy())
    _maps_close(ref, port)


@pytest.mark.parametrize("first_budget", ["drained", "pending"])
def test_second_closure_matches_reference(loop_state, closed, first_budget):
    """After the first closure (keyframe 13 on 0, `min_kfs_since_last` 5)
    both maps gain four keyframes that look elsewhere and a second drifted
    revisit (keyframe 18). Detections of keyframe 17, inside the gate, are
    ignored: no streak, no verification. Three of keyframe 18 verify and
    close again, on the corrected map. With the first budget drained the
    second opens a new one; with it still pending (one of its three slices
    run) the second closure overwrites what is left (the reference's
    mbStopGBA abort). Each step: the same `loop_log`, budget, last loop
    keyframe, tracker and map as the reference's."""
    ref, port = (_clone_system(s, p) for s, p in zip(closed, (False, True)))
    first = loop_state["kf"]
    for s in (ref, port):
        if first_budget == "drained":
            s._pump_gba(drain=True)
        else:
            s._pump_gba()
    assert (port._gba_pending is None) == (first_budget == "drained")
    kf = _second_revisit(ref, port)
    assert kf == first + CFG.loop.min_kfs_since_last
    n_verified = port.n_verify_loops
    for s in (ref, port):
        _detect(s, kf - 1)
    assert port.n_verify_loops == n_verified and len(port.loop_log) == 1
    assert port._consistent_groups == []
    _same_loop_state(ref, port)
    for s in (ref, port):
        _detect(s, kf)
    assert port.n_verify_loops == n_verified + 1
    assert [(e["kf"], e["cand"]) for e in port.loop_log] == [(first, 0), (kf, 0)]
    assert port._gba_pending == {"left": CFG.loop.gba_total_iters, "kf": kf}
    assert port._last_loop_kf == kf
    assert torch.equal(port.ts.Tcw, port.map.kf_Tcw[loop_state["kf"]])
    _same_loop_state(ref, port)
    # the new budget drains in whole slices, the maps equal after each
    while port._gba_pending is not None:
        ref._pump_gba()
        port._pump_gba()
        _maps_close(ref, port)
    assert ref._gba_pending is None and port._gba_slices_run == ref._gba_slices_run


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


def _run_per_frame(world, n, cfg):
    """Both packages' `track_rgbd` over world frames 0..n-1 with mapping,
    the CRF and loop closing on, the port making the reference's draws:
    (reference system, port system)."""
    from lc_crf_slam_tpu.models.system import SLAMSystem as Ref
    from torch_parity import CAM, CAM_REF, render

    ref = Ref(CAM_REF, cfg, enable_mapping=True, enable_crf=True)
    port = SLAMSystem(CAM, cfg, enable_mapping=True, enable_crf=True, device="cpu")
    use_reference_draws(port)
    for k in range(n):
        g, d = render(world, k)
        ref.track_rgbd(g, d, k / 30.0)
        port.track_rgbd(g, d, k / 30.0)
    ref.flush_stats()
    port.flush_stats()
    return ref, port


def test_pan_frame1_pose_is_the_reference_op_by_op():
    """Where the per-frame runs of the QVGA pan world part: frame 1's
    `track_step`, from the reference's own state. The reference's pose
    there depends on XLA's fusion: jitted and op by op (`jax.disable_jit`)
    it differs by ~1.5e-4 on the same inputs. The port, on those inputs
    and with the reference's draws, gives the same integers (associations,
    inliers) as both and the op-by-op pose to 1e-5."""
    from lc_crf_slam_tpu.models import tracking as ref_tracking
    from lc_crf_slam_tpu.models.frame import build_frame as ref_build_frame
    from lc_crf_slam_tpu.models.mapstate import empty_map as ref_empty_map
    from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
    from lc_crf_slam_torch.models import tracking
    from torch_parity import CAM, CAM_REF, PAN_WORLD, reference_consensus_sampler, render

    world = RefWorld(cam=CAM_REF, n_frames=130, **PAN_WORLD)   # the pan spans n_frames
    cfg = SLAMConfig()
    build = jax.jit(ref_build_frame, static_argnums=(0, 1))
    f0, f1 = (build(CAM_REF, cfg, *map(jnp.asarray, render(world, k))) for k in (0, 1))
    # frame 0 initialises the map; frame 1's track_step is handed its state
    m, ts = jax.jit(ref_tracking.initialize_map, static_argnums=(0, 1))(
        cfg, CAM_REF, ref_empty_map(cfg), f0, jnp.asarray(0.0))
    args = (cfg, CAM_REF, m, ts, f1)
    fused_out = jax.jit(ref_tracking.track_step, static_argnums=(0, 1))(*args)
    with jax.disable_jit():
        eager = ref_tracking.track_step(*args)
    ts_p, _, info = tracking.track_step(
        cfg, CAM, convert.map_to_torch(m), convert.track_to_torch(ts),
        convert.frame_to_torch(f1), reference_consensus_sampler(1))
    fused, unfused = np.asarray(fused_out[0].Tcw), np.asarray(eager[0].Tcw)
    print("frame 1 Tcw: reference jitted vs op by op", np.abs(fused - unfused).max(),
          "port vs op by op", np.abs(ts_p.Tcw.numpy() - unfused).max())
    assert np.abs(fused - unfused).max() > 1e-4
    np.testing.assert_allclose(ts_p.Tcw.numpy(), unfused, atol=1e-5)
    for out in (fused_out, eager):
        np.testing.assert_array_equal(np.asarray(out[0].last_obs), ts_p.last_obs.numpy())
        assert int(out[2].n_inliers) == int(info.n_inliers)


@pytest.mark.slow
def test_pan_loop_closes_as_reference_per_frame(tmp_path):
    """The reference's default-config loop world (1.2-turn pan over a
    textured wall, 1.5 cm depth noise, QVGA, 130 frames) one frame at a
    time through the port's `track_rgbd` with the reference's draws,
    against the reference run op for op (XLA's backend optimisations off,
    tests/ref_unfused_worker.py, in its own process meanwhile). Whether
    this world's revisit closes per frame turns on rounding: the jitted
    reference closes at keyframe 41 (ATE 0.084 m), the op-by-op one does
    not (ATE 0.085 m), and the two part on frame 1's pose
    (`test_pan_frame1_pose_is_the_reference_op_by_op`). The port holds to
    the op-by-op reference: the same inliers and keyframe decisions on
    every frame until float order parts them (frame 26; at least the
    first 20), no lost frame, the same loop outcome and, where a loop
    closes in both, the same closure; the budget drained. Keyframes and
    ATE are printed: after the parting they are each run's own (the
    port's ATE, 0.110 m, is above the reference test's 0.10 m bar: the
    growth of one frame's float order, which every step from the
    reference's own state keeps to, tests/test_torch_pan_steps.py)."""
    port, ref, parted, ate_port = _per_frame_against_unfused(tmp_path, "pan", 130)
    assert parted + 1 >= 20
    assert len(port.loop_log) == len(ref["loop_log"])
    for (kf, cand, n_inl), b in zip(ref["loop_log"], port.loop_log):
        assert (kf, cand) == (b["kf"], b["cand"]) and abs(n_inl - b["inliers"]) <= 5
    assert port._gba_pending is None
    assert np.all(np.array([s["status"] for s in port.stats[1:]]) == 1)
    assert np.all(ref["status"] == 1)


@pytest.mark.slow
def test_two_loop_pan_per_frame(tmp_path):
    """The pan world rendered on past its 130 frames to frame 179 (1.72
    turns at the same yaw per frame: after its revisit the camera pans
    over the first turn's sector again; chip_smoke.py's per-frame loop
    phase at QVGA) one frame at a time through the port's `track_rgbd`
    with the reference's draws, against the op-by-op reference: the same
    decisions until float order parts them (at least the first 20
    frames), the same number of loops and the same (keyframe, candidate)
    for each. Prints what each package does."""
    from torch_parity import TWO_LOOP_FRAMES

    port, ref, parted, _ = _per_frame_against_unfused(tmp_path, "pan", 130,
                                                      run=TWO_LOOP_FRAMES)
    assert parted + 1 >= 20
    assert len(port.loop_log) == len(ref["loop_log"])
    for (kf, cand, _), b in zip(ref["loop_log"], port.loop_log):
        assert (kf, cand) == (b["kf"], b["cand"])


def _per_frame_against_unfused(tmp_path, world_name, n, run=None):
    """`torch_parity.run_against_unfused` over the world's first `run`
    (default n) frames: (port system, the worker's npz, the index of the
    first frame after frame 0 whose inliers or keyframe decision differ,
    the port's ATE). Prints both runs' keyframes, loops, ATE and the
    port's verified candidates."""
    from torch_parity import run_against_unfused

    port, ref, world = run_against_unfused(tmp_path, world_name, n, run)
    stats = port.stats[1:]
    inliers = np.array([s["n_inliers"] for s in stats])
    need_kf = np.array([bool(s["need_kf"]) for s in stats])
    same = (inliers == ref["n_inliers"]) & (need_kf == ref["need_kf"])
    parted = int(np.argmin(same)) if not same.all() else len(same)
    ate_port = _ate(port, world)
    print(world_name, "parted at frame", parted + 1, "keyframes", len(ref["kf_log"]),
          len(port.kf_log), "loops", ref["loop_log"].tolist(), port.loop_log,
          "verified candidates (port)", port.n_verify_loops, "ATE", float(ref["ate"]),
          ate_port)
    return port, ref, parted, ate_port


def _ate(slam, world):
    from lc_crf_slam_tpu.utils.evaluate import evaluate_ate

    ts, poses = slam.get_trajectory()
    gt = np.stack([world.gt_pose_twc(k) for k in range(len(ts))])   # frame k at k / 30 s
    return evaluate_ate(ts, np.asarray(poses), np.arange(len(ts)) / 30.0, gt).rmse


def _mover_gates(world, slam, n, covisibility):
    """tests/test_loopclosure_render_e2e.py:99-144 on one package's run
    of the mover sweep: the gates that fail, and what was measured."""
    m = slam.map
    alive = np.asarray(m.p_alive)
    gtd = world.bb_gt_dynamic(np.asarray(m.p_xyz), n=n) & alive
    judged = gtd & (np.asarray(m.p_visible) >= 4)
    nk = int(m.n_kfs)
    W = np.asarray(covisibility(m))[:nk, :nk]
    ate = _ate(slam, world)
    lost = sum(1 for s in slam.stats if s.get("status", 1) != 1)
    seen = dict(loops=[(a["kf"], a["cand"]) for a in slam.loop_log], ate=ate, lost=lost,
                live=int(alive.sum()), mover=int(gtd.sum()), judged=int(judged.sum()),
                early_late=float(W[:4, nk - 4:].max()))
    failed = [name for name, ok in (
        ("revisit", bool(slam.loop_log) or (nk >= 10 and W[:4, nk - 4:].max() >= 12)),
        ("ate", ate < 0.10), ("lost", lost <= 8),
        ("judged", judged.sum() <= 0.08 * max(alive.sum(), 1)),
        ("mover", gtd.sum() <= 0.20 * max(alive.sum(), 1)),
        ("live", alive.sum() >= 55)) if not ok]
    return failed, seen


@pytest.mark.slow
def test_sweep_with_mover_matches_reference():
    """tests/test_loopclosure_render_e2e.py's `_run(billboard=True)`: a QVGA
    sweep (1600 points, seed 3) that revisits its start sector with a
    textured billboard mover there, 96 frames, `min_total_matches=25` and
    the reverse neighbour fuse off, through both packages' `track_rgbd`
    with the reference's draws. Both pass the reference test's gates
    (:99-144): a loop or early-late covisibility reconnection, ATE < 0.10
    m, <= 8 lost frames, judged mover points <= 8% and all mover points <=
    20% of the live points, >= 55 live points. The runs part by float
    order after ~70 frames (one keyframe decision), so which of the two
    healthy revisit outcomes each takes is printed, not compared."""
    from lc_crf_slam_tpu.models.mapstate import covisibility as ref_covisibility
    from lc_crf_slam_torch.models.mapstate import covisibility
    from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
    from torch_parity import CAM_REF

    n = 96
    world = RefWorld(cam=CAM_REF, n_frames=n, n_static=1600, n_dynamic=0, seed=3,
                     trajectory="sweep", billboard=True, bb_speed=0.012,
                     bb_center0=(-0.5, 0.0, 2.4), bb_size=(0.9, 1.2))
    cfg = SLAMConfig(loop=LoopConfig(min_total_matches=25))
    cfg = cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, fuse_reverse_neighbors=0, interrupt_fuse_reverse_neighbors=0))
    ref, port = _run_per_frame(world, n, cfg)
    failed_ref, seen_ref = _mover_gates(world, ref, n, ref_covisibility)
    failed, seen = _mover_gates(world, port, n, covisibility)
    print("reference", seen_ref, "port", seen)
    assert failed_ref == [] and failed == [], (failed_ref, failed)


def _global_ba_on_the_cards_map(path=None):
    """Three global-BA slices of both packages on chip_smoke.py's
    BA_MAP_FILE (or a map that script wrote to `path`): (the file, the
    reference's keyframe ATE after each slice, the port's, the largest
    pose difference after each slice). A new map's `ref_kf_ate` is the
    second of these."""
    import chip_smoke
    from lc_crf_slam_tpu.models.mapstate import MapState as RefMap
    from lc_crf_slam_torch.config import SLAMConfig as PortConfig
    from lc_crf_slam_torch.utils.synthetic import SyntheticWorld

    cfg = PortConfig()
    m, z = chip_smoke.load_ba_map(cfg, path or chip_smoke.BA_MAP_FILE)
    m_ref = RefMap(**{f: jnp.asarray(a) for f, a in convert.to_numpy(m).items()})
    world = SyntheticWorld(cam=TUM3, n_frames=chip_smoke.LOOP_FRAMES, **chip_smoke.LOOP_WORLD)
    gt_t, gt = world.groundtruth()
    which = z["ate_kfs"]

    def ate(Tcw):
        return chip_smoke.keyframe_ate(np.asarray(Tcw)[:len(which)], z["kf_time"][:len(which)],
                                       which, gt_t, gt)

    ates_ref, ates, dpose = [], [], []
    for _ in range(cfg.loop.gba_total_iters // cfg.loop.gba_slice_iters):
        m_ref = ref_lc.global_ba(SLAMConfig(), REF_TUM3, m_ref, n_iters=cfg.loop.gba_slice_iters)
        m = lc.global_ba(cfg, TUM3, m, n_iters=cfg.loop.gba_slice_iters)
        ates_ref.append(ate(m_ref.kf_Tcw))
        ates.append(ate(m.kf_Tcw.numpy()))
        dpose.append(float(np.abs(np.asarray(m_ref.kf_Tcw) - m.kf_Tcw.numpy()).max()))
    return z, ates_ref, ates, dpose


def test_global_ba_on_the_cards_loop_map():
    """The map the card held just before the first global-BA slice of
    chip_smoke.py's per-frame loop phase (the 640x480 pan world, 130
    frames through `track_rgbd`; tests/data/loop_per_frame_ba_map.npz,
    written by that script) through both packages' `global_ba`, the
    budget's three slices: the port on the CPU holds the reference's poses
    to 1e-3 and its keyframes' ATE to 0.5 mm, and the reference's ATE
    after each slice is the one the file records, against which
    chip_smoke.py gates the card's. On this map the reference's global BA
    raises the keyframes' ATE (from 0.0281 m to 0.0444 m)."""
    z, ates_ref, ates, dpose = _global_ba_on_the_cards_map()
    print("reference", ates_ref, "port", ates, "max pose diff", dpose)
    np.testing.assert_allclose(ates_ref, z["ref_kf_ate"], rtol=1e-4)
    np.testing.assert_allclose(ates, ates_ref, atol=5e-4)
    assert max(dpose) < STATE_TOL
    assert ates_ref[-1] > 1.1 * ates_ref[0]
