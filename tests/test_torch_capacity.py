"""The port at full capacity against the JAX reference.

A map whose keyframe table is full, built by the reference's own
`add_points` / `add_keyframe` from the observations of 16 frames of the
QVGA pan world (`torch_parity.PAN_WORLD`, every 8th frame over its 1.2
turns, so the newest keyframe shares points with some keyframes and none
with others), 16 keyframe slots. The reference marks its local-BA window
with the dump slot `capacity_kfs - 1` (lc_crf_slam_tpu/models/mapping.py:
53-55): once that slot holds a live keyframe, its own entry and the empty
neighbours' writes collide there, and the last write (an empty
neighbour's False) wins, so keyframe F - 1 drops out of its own window
and comes back as a fixed observer. The port writes the same. Then the
point table under pressure: `add_points` recycling dead slots once the
virgin ones run out.

Tolerances: the window and every integer field exactly; the map after
`mapping_step` as tests/test_torch_mapping.py::test_mapping_step holds it
(floats to 1e-3 + 1e-3 relative); `add_points` exactly.

The slow case runs the port's `track_rgbd` over the tracking phase's
orbit world at 640x480 past the point where the keyframe table fills,
against the reference run op for op (chip_smoke.py's capacity phase)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lc_crf_slam_tpu.config import MapConfig, SLAMConfig
from lc_crf_slam_tpu.models import mapping as ref_mapping
from lc_crf_slam_tpu.models import mapstate as ref_ms
from lc_crf_slam_tpu.models.frame import frame_from_observations
from lc_crf_slam_tpu.utils.synthetic import SyntheticWorld as RefWorld
from lc_crf_slam_torch import convert
from lc_crf_slam_torch.models import mapping, mapstate

from torch_parity import CAM, CAM_REF, PAN_WORLD, assert_map_equal

# the smallest keyframe table the windows allow: local BA's top-k takes
# max_local_kfs - 1 = 15 neighbours
N_KFS = 16
CFG = SLAMConfig(map=MapConfig(max_points=4096, max_keyframes=N_KFS, max_features=512))


@pytest.fixture(scope="module")
def full_map():
    """The reference map with all 16 keyframe slots live: every world
    point seen becomes one map point, each keyframe observes the points
    in its view."""
    world = RefWorld(cam=CAM_REF, n_frames=130, **PAN_WORLD)
    K = CFG.map.max_features
    add_points = jax.jit(ref_ms.add_points)
    add_keyframe = jax.jit(ref_ms.add_keyframe)
    m = ref_ms.empty_map(CFG)
    map_id = {}
    for j in range(N_KFS):
        f = world.frame(8 * j)
        pid = f.point_id[:K]
        new = np.array([p not in map_id for p in pid])
        xyz = world.points_at(8 * j)[pid].astype(np.float32)
        n = len(pid)
        m, ids = add_points(m, jnp.asarray(xyz), jnp.asarray(f.desc[:K]),
                            jnp.zeros((n, 3)), jnp.zeros(n), jnp.full((n,), 100.0),
                            jnp.asarray(new), jnp.asarray(j, jnp.int32))
        map_id.update({p: int(i) for p, i, nw in zip(pid, np.asarray(ids), new) if nw})
        obs = np.full(K, -1, np.int32)
        obs[:n] = [map_id[p] for p in pid]
        frame = frame_from_observations(f.uv, f.depth, f.desc, K, CAM_REF)
        m, _ = add_keyframe(m, frame, jnp.asarray(f.T_cw, jnp.float32),
                            jnp.asarray(8 * j / 30.0), jnp.asarray(obs))
    assert int(m.n_kfs) == N_KFS and bool(m.kf_alive.all())
    return m


def test_window_at_full_capacity(full_map):
    """`_select_window` for keyframe F - 1: the reference's window, where
    that keyframe is a local camera but not in `is_local`, so its points
    enter only through the other local keyframes and it is picked again
    as a fixed observer."""
    kf = N_KFS - 1
    ref = ref_mapping._select_window(CFG, full_map, jnp.asarray(kf, jnp.int32))
    out = mapping._select_window(CFG, convert.map_to_torch(full_map), torch.tensor(kf))
    for name, a, b in zip(("cam_ids", "cam_fixed", "point_ids", "point_ok"), ref, out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    cam_ids = np.asarray(ref[0])
    W = CFG.local_ba.max_local_kfs
    # the case at issue: empty neighbour slots, and keyframe F - 1 in the
    # window twice, free at its head and fixed among the observers
    assert (cam_ids[1:W] == -1).any()
    assert cam_ids[0] == kf and kf in cam_ids[W:]


def test_mapping_step_at_full_capacity(full_map):
    """The whole mapping pass for keyframe F - 1 (triangulation, fuses,
    local BA on that window, culling): integer state exactly, floats to
    1e-3 + 1e-3 relative."""
    kf = N_KFS - 1
    ref = jax.jit(ref_mapping.mapping_step, static_argnums=(0, 1))(
        CFG, CAM_REF, full_map, jnp.asarray(kf, jnp.int32))
    out = mapping.mapping_step(CFG, CAM, convert.map_to_torch(full_map), torch.tensor(kf))
    assert_map_equal(ref, out, float_tol=1e-3, rtol=1e-3)
    # the pass moved the free keyframes and pruned observations
    assert not np.array_equal(np.asarray(ref.kf_Tcw), np.asarray(full_map.kf_Tcw))


def test_add_points_recycles_under_pressure(full_map):
    """The full map's point table with a third of its points culled, some
    of them still vetoing as movers, then more new points than virgin
    slots: the rest recycle the dead slots (lowest index first), their
    keyframe references are condemned to -2 and the vetoing ones go to the
    tombstone ring, exactly as the reference's."""
    rng = np.random.default_rng(4)
    n_used = int(full_map.n_points)
    P = CFG.map.max_points
    dead = np.zeros(P, bool)
    dead[:n_used] = rng.random(n_used) < 0.33
    p_dyn = np.where(dead & (rng.random(P) < 0.3), 0.9, 0.0).astype(np.float32)
    m_ref = full_map._replace(p_alive=full_map.p_alive & ~jnp.asarray(dead),
                              p_dyn=jnp.asarray(p_dyn))
    M = P - n_used + int(dead.sum()) // 2          # half the dead slots recycle
    xyz = rng.normal(0, 2, (M, 3)).astype(np.float32)
    desc = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    create = rng.random(M) < 0.97
    args = [xyz, desc, -xyz, np.full(M, 0.5, np.float32), np.full(M, 5.0, np.float32),
            create]
    ref, ids_ref = ref_ms.add_points(m_ref, *map(jnp.asarray, args),
                                     jnp.asarray(N_KFS - 1, jnp.int32))
    out, ids = mapstate.add_points(convert.map_to_torch(m_ref),
                                   *(convert._to_tensor(a, "cpu") for a in args),
                                   torch.tensor(N_KFS - 1, dtype=torch.int32))
    np.testing.assert_array_equal(np.asarray(ids_ref), ids.numpy())
    assert_map_equal(ref, out, float_tol=0.0)
    recycled = np.asarray(ids_ref)[np.asarray(ids_ref) >= 0]
    recycled = recycled[recycled < n_used]
    assert len(recycled) > 0 and dead[recycled].all()
    assert (np.asarray(ref.kf_obs) == -2).any() and int(ref.tomb_n) > 0


@pytest.mark.parametrize("dead_slots", [0, 1])
def test_point_capacity_full_event_matches_reference(dead_slots):
    """The point branch of `capacity_full`: a map handed to each package's
    system with every point slot live (or all but `dead_slots`), one
    keyframe insert by each package's `add_keyframe`, then the system's
    capacity check, twice. With every slot live both say so once, at the
    same record, naming the point table as saturated; with one slot dead
    (the high-water mark at capacity, the live count not) neither says
    anything."""
    from lc_crf_slam_tpu.models.system import SLAMSystem as RefSystem
    from lc_crf_slam_torch.models.system import SLAMSystem

    cfg = SLAMConfig(map=MapConfig(max_points=512, max_keyframes=32, max_features=512))
    P, K = cfg.map.max_points, cfg.map.max_features
    rng = np.random.default_rng(11)
    xyz = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                    rng.uniform(2.5, 6, P)], -1).astype(np.float32)
    desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    m, ids = ref_ms.add_points(ref_ms.empty_map(cfg), jnp.asarray(xyz), jnp.asarray(desc),
                               jnp.zeros((P, 3)), jnp.zeros(P), jnp.full((P,), 100.0),
                               jnp.ones(P, bool), jnp.asarray(0, jnp.int32))
    assert int(m.n_points) == P and bool(m.p_alive.all())
    m = m._replace(p_alive=m.p_alive.at[:dead_slots].set(False))
    uv = np.stack([rng.uniform(0, 320, K), rng.uniform(0, 240, K)], -1).astype(np.float32)
    frame = frame_from_observations(uv, np.full(K, 3.0, np.float32), desc[:K], K, CAM_REF)
    obs = np.array(ids[:K], np.int32)
    ref = RefSystem(CAM_REF, cfg)
    ref.map, _ = ref_ms.add_keyframe(m, frame, jnp.eye(4), jnp.asarray(0.5), jnp.asarray(obs))
    port = SLAMSystem(CAM, cfg, device="cpu")
    port.map, _ = mapstate.add_keyframe(
        convert.map_to_torch(m), convert.frame_to_torch(frame), torch.eye(4),
        torch.tensor(0.5, dtype=torch.float64), torch.from_numpy(obs))
    for slam in (ref, port):
        slam._warn_if_at_capacity()
        slam._warn_if_at_capacity()
    assert int(port.map.n_kfs) == int(ref.map.n_kfs) == 1
    events = [[(i, e["event"], e["detail"].split(": ", 1)[1]) for i, e in
               enumerate(slam.stats) if "event" in e] for slam in (ref, port)]
    assert events[0] == events[1]
    if dead_slots:
        assert events[0] == []
    else:
        assert [e[:2] for e in events[0]] == [(0, "capacity_full")]
        assert "point capacity reached" in events[0][0][2]
        assert "live points saturated" in events[0][0][2]


ORBIT_FRAMES = 45
ORBIT_WORLD_FRAMES = 31     # the orbit's period, as the tracking phase's world


@pytest.mark.slow
def test_orbit_past_keyframe_capacity_matches_reference(tmp_path):
    """chip_smoke.py's capacity phase on the CPU: the port's `track_rgbd`
    (mapping, the CRF and loop closing on, the reference's draws) over 45
    frames of the tracking phase's orbit world at 640x480 with 16 keyframe
    slots and 4096 point slots (`torch_parity.ORBIT_CFG`; the point table
    recycles from frame 38), against the reference run op for op
    over the same frames (tests/ref_unfused_worker.py; the jitted
    reference's fused rounding moves the poses by ~1 mm within a few
    frames): the table fills, both say so once (`capacity_full`) at the
    same record, the later keyframe decisions map on keyframe F - 1 with
    their inserts dropped. The same keyframe log, statuses and poses to
    1 mm."""
    from torch_parity import assert_poses_close, run_against_unfused

    port, ref, _ = run_against_unfused(tmp_path, "orbit16", ORBIT_WORLD_FRAMES,
                                       run=ORBIT_FRAMES)
    events = [(i, e["event"]) for i, e in enumerate(port.stats) if "event" in e]
    full_at = [i for i, e in events if e == "capacity_full"]
    frames = [s for s in port.stats[1:] if "event" not in s]     # after the first
    n_after = sum(1 for s in port.stats[full_at[0]:] if s.get("need_kf")) if full_at else 0
    kf_log_ref = [(t, int(k)) for t, k in ref["kf_log"]]
    dpos = np.linalg.norm(ref["poses"][:, :3, 3] - port.get_trajectory()[1][:, :3, 3], axis=-1)
    print("keyframes", len(kf_log_ref), len(port.kf_log), "max pose difference",
          dpos.max(), "events",
          list(zip(ref["event_at"].tolist(), ref["event"].tolist())), events,
          "keyframe decisions after the fill", n_after)
    assert [(t, int(k)) for t, k in port.kf_log] == kf_log_ref
    assert events == list(zip(ref["event_at"].tolist(), ref["event"].tolist()))
    assert len(full_at) == 1 and int(port.map.n_kfs) == N_KFS and n_after >= 2
    assert [s["status"] for s in frames] == ref["status"].tolist()
    _, poses = port.get_trajectory()
    assert_poses_close(ref["poses"], poses)
    # the point table's high-water mark reaches its end too (frame 38),
    # and add_points recycles from there on (chip_smoke.py's gates)
    assert int(port.map.n_points) == port.cfg.map.max_points and int(port.map.tomb_n) > 0
