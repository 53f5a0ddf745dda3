"""Loop detection parity: `detect_loop` against the reference on a map
the reference tracker built (converted array by array), and the host's
consecutive-detection group-consistency streak (`_try_close_loop`)
against the reference's on a hand-made sequence of detections, with the
verification of both packages replaced by a recorder that rejects."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lc_crf_slam_tpu.config import (LoopConfig, MapConfig, MappingConfig, SLAMConfig,
                                    TrackingConfig)
from lc_crf_slam_tpu.geometry.camera import TUM3 as REF_TUM3
from lc_crf_slam_tpu.models.loopclosing import detect_loop as ref_detect_loop
from lc_crf_slam_tpu.models.system import SLAMSystem as RefSystem
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch import convert
from lc_crf_slam_torch.geometry.camera import TUM3
from lc_crf_slam_torch import config
from lc_crf_slam_torch.models import system as port_system
from lc_crf_slam_torch.models.loopclosing import LoopVerification, detect_loop
from lc_crf_slam_torch.models.system import SLAMSystem

from torch_parity import CAM, CAM_REF, drifted_loop_map

SCORE_TOL = 1e-5   # a 256-term f32 dot summed in another order

BASE_CFG = SLAMConfig(
    loop=LoopConfig(min_kfs_since_last=4),
    tracking=TrackingConfig(max_frames_between_kf=2),
    map=MapConfig(max_points=8192, max_keyframes=48))


def loosened(cfg, min_weight, score_cap=0.3):
    """cfg with a higher covisibility edge weight and a lower cap on the
    neighbours' minimum score (retrieval floor 0.1): on a map whose
    keyframes all share points, that is what lets candidates through."""
    return dataclasses.replace(
        cfg,
        mapping=dataclasses.replace(cfg.mapping, covisibility_min_weight=min_weight),
        loop=dataclasses.replace(cfg.loop, min_score_cap=score_cap,
                                 retrieval_floor=0.1))


@pytest.fixture(scope="module")
def loop_map():
    """14 keyframes of a 40-frame `trajectory="loop"` world (the world of
    tests/test_loopclosing.py's relocalisation test), tracked by the
    reference from observations: (reference map, converted map). The
    revisit re-observes the first sector's points, so every pair of
    keyframes is covisible (81-531 shared points) and the similarities
    span 0.12-0.92."""
    world = RefWorld(cam=REF_TUM3, n_frames=40, n_static=800, n_dynamic=0, seed=9,
                     trajectory="loop")
    cfg = dataclasses.replace(BASE_CFG, loop=dataclasses.replace(BASE_CFG.loop,
                                                                 enabled=False))
    slam = RefSystem(REF_TUM3, cfg, enable_mapping=False, enable_crf=False)
    for k in range(40):
        f = world.frame(k)
        slam.track_observations(f.uv, f.depth, f.desc, f.timestamp)
    assert int(slam.map.n_kfs) >= 12
    return slam.map, convert.map_to_torch(slam.map)


def assert_candidates_equal(ref, out):
    ref = convert.loop_candidate_to_torch(ref)
    for f in ("valid", "cand", "cands", "groups"):
        assert torch.equal(getattr(ref, f), getattr(out, f)), f
    assert out.cands.dtype == torch.int32 and out.groups.dtype == torch.bool
    if bool(ref.valid):
        assert abs(float(ref.score) - float(out.score)) <= SCORE_TOL
    else:
        assert float(out.score) == float("-inf")


# 15 is the default edge weight (every keyframe of this map is then
# connected: no candidate); 200 and 300 cut the far pairs loose
@pytest.mark.parametrize("min_weight,score_cap", [(15, 0.9), (200, 0.3), (300, 0.3),
                                                  (300, 0.5)])
def test_detect_loop_matches_reference(loop_map, min_weight, score_cap):
    m_ref, m = loop_map
    cfg = loosened(BASE_CFG, min_weight, score_cap)
    det = jax.jit(ref_detect_loop, static_argnums=(0,))
    n_valid = n_cands = 0
    for k in range(int(m_ref.n_kfs)):
        ref = det(cfg, m_ref, jnp.asarray(k, jnp.int32))
        out = detect_loop(cfg, m, torch.tensor(k, dtype=torch.int32))
        assert_candidates_equal(ref, out)
        n_valid += int(out.valid)
        n_cands += int((out.cands >= 0).sum())
    if min_weight == 15:
        assert n_valid == 0
    else:
        assert n_valid >= 3 and n_cands > n_valid   # some with several candidates


def test_detect_loop_on_drifted_revisit():
    """The reference test's hand-built map: keyframe 0 and the last one see
    the same cloud, 12 keyframes between look elsewhere."""
    cfg = SLAMConfig(loop=LoopConfig(min_kfs_since_last=5))
    m_ref, kf_loop, *_ = drifted_loop_map(cfg)
    m = convert.map_to_torch(m_ref)
    for k in (int(kf_loop), 6):
        ref = ref_detect_loop(cfg, m_ref, jnp.asarray(k, jnp.int32))
        out = detect_loop(cfg, m, torch.tensor(k, dtype=torch.int32))
        assert_candidates_equal(ref, out)
    assert bool(out.valid) is False or int(out.cand) != 0
    out = detect_loop(cfg, m, torch.tensor(int(kf_loop), dtype=torch.int32))
    assert bool(out.valid) and int(out.cand) == 0


# ---- the streak logic on the host -----------------------------------------

F, TOPK = 32, 8
STREAK_CFG = SLAMConfig(map=MapConfig(max_points=4096, max_keyframes=F))


def detection(kf, *cands_groups):
    """(kf, valid, cands (TOPK,), groups (TOPK, F)) from (cand, members)."""
    cands = np.full((TOPK,), -1, np.int64)
    groups = np.zeros((TOPK, F), bool)
    for i, (c, members) in enumerate(cands_groups):
        cands[i] = c
        groups[i, list(members)] = True
    return kf, bool(cands_groups), cands, groups


class _Rejected:
    accepted = False


def _rejecting(record):
    """A port `verify_loop` that records the candidate and rejects."""
    def verify(cfg, cam, m, kf, cand, sampler):
        record.append(int(cand))
        return LoopVerification(T_corr=torch.eye(4), s_corr=torch.ones(()),
                                n_inliers=torch.zeros((), dtype=torch.int32),
                                accepted=torch.zeros((), dtype=torch.bool))
    return verify


def both_systems(monkeypatch, cfg=STREAK_CFG, cam_ref=CAM_REF, cam=CAM):
    """(reference, port, candidates the reference verified, ... the port
    verified): both verifications record the candidate and reject."""
    ref = RefSystem(cam_ref, cfg)
    port = SLAMSystem(cam, cfg, device="cpu")
    verified, verified_port = [], []
    ref._verify_loop = lambda cfg, cam, m, kf, cand, key: (
        verified.append(int(cand)), _Rejected())[1]
    monkeypatch.setattr(port_system, "verify_loop", _rejecting(verified_port))
    return ref, port, verified, verified_port


def streaks(system):
    """The streak state of either package as [(group members, streak)]."""
    return [(np.flatnonzero(g).tolist(), s)
            for g, s in convert.consistent_groups_to_numpy(system._consistent_groups)]


SEQUENCE = [
    detection(12, (3, {2, 3, 4})),                        # streak 1
    detection(13, (4, {3, 4, 5}), (9, {9, 10})),          # 2 and 1
    detection(14),                                        # invalid: cleared
    detection(15, (4, {3, 4, 5})),                        # 1 again
    detection(16, (9, {9, 10}), (3, {2, 3})),             # 1 and 2
    detection(17, (2, {1, 2}), (20, {20}), (10, {10})),   # 3 (ready), 1, 2
    detection(18, (2, {2}), (10, {9, 10})),               # 4 and 3: both ready
]


def test_consistency_streak_matches_reference(monkeypatch):
    ref, port, verified, verified_port = both_systems(monkeypatch)
    went_on = []
    for step, pre in enumerate(SEQUENCE):
        before = len(verified)
        ref._try_close_loop(pre=pre)
        port._try_close_loop(pre=pre)
        assert streaks(ref) == streaks(port), step
        # the port verifies exactly where the reference does, the same
        # candidates in the same order
        assert verified_port[before:] == verified[before:], step
        if len(verified) > before:
            went_on.append(step)
    assert went_on == [5, 6] and verified_port == [2, 2, 10]
    assert port.n_verify_loops == 3 and port.loop_log == []
    assert [s for _, s in port._consistent_groups] == [4, 3]


def test_invalid_detection_clears_the_streak(monkeypatch):
    ref, port, _, _ = both_systems(monkeypatch)
    for pre in SEQUENCE[:2]:
        ref._try_close_loop(pre=pre)
        port._try_close_loop(pre=pre)
    assert [s for _, s in port._consistent_groups] == [2, 1]
    port._try_close_loop(pre=SEQUENCE[2])
    ref._try_close_loop(pre=SEQUENCE[2])
    assert port._consistent_groups == [] and ref._consistent_groups == []


def test_gate_after_a_recent_loop(monkeypatch):
    """Within min_kfs_since_last keyframes of the last closed loop nothing
    is looked at, and the streak stays as it is."""
    ref, port, _, _ = both_systems(monkeypatch)
    for s in (ref, port):
        s._try_close_loop(pre=SEQUENCE[0])
        s._last_loop_kf = 8
        s._try_close_loop(pre=SEQUENCE[2])      # kf 14 - 8 < 10: ignored
    assert streaks(ref) == streaks(port) == [([2, 3, 4], 1)]


def test_ready_candidate_raises_by_name(monkeypatch):
    """A ready candidate is verified, no longer refused, and so it is with
    the monocular Sim(3) loop (`fix_scale=False`), which used to raise by
    name; only the "direct" descriptor still does."""
    _, port, _, verified_port = both_systems(monkeypatch)
    port._consistent_groups = [(SEQUENCE[0][3][0], 2)]
    port._try_close_loop(pre=SEQUENCE[0])
    assert verified_port == [3]
    free_scale = config.SLAMConfig(map=config.MapConfig(max_points=4096, max_keyframes=F),
                                   loop=config.LoopConfig(fix_scale=False))
    mono = SLAMSystem(CAM, free_scale, device="cpu")
    mono._consistent_groups = [(SEQUENCE[0][3][0], 2)]
    mono._try_close_loop(pre=SEQUENCE[0])
    assert verified_port == [3, 3] and mono.loop_log == []
    with pytest.raises(NotImplementedError, match="descriptor_variant"):
        SLAMSystem(CAM, free_scale.replace(orb=config.ORBConfig(
            descriptor_variant="direct")), device="cpu")


def test_detection_on_the_current_keyframe(loop_map, monkeypatch):
    """`pre=None`: detect for the tracker's reference keyframe and fetch
    once; both packages then hold the same groups and go on to verify the
    same candidates."""
    m_ref, m = loop_map
    cfg = loosened(BASE_CFG, 300)
    ref, port, verified, verified_port = both_systems(monkeypatch, cfg, REF_TUM3, TUM3)
    n_groups = 0
    for kf in range(int(m_ref.n_kfs)):
        ref.map, port.map = m_ref, m
        ref.ts = ref.ts._replace(ref_kf=jnp.asarray(kf, jnp.int32))
        port.ts = port.ts._replace(ref_kf=torch.tensor(kf, dtype=torch.int32))
        ref._try_close_loop()
        port._try_close_loop()
        assert streaks(ref) == streaks(port), kf
        assert verified == verified_port, kf
        n_groups += len(port._consistent_groups)
    assert port.n_detect_loops == int(m_ref.n_kfs) and n_groups > 0
