"""Typed configuration for the whole pipeline: a copy of the dataclasses
of lc_crf_slam_tpu/config.py, so that the port imports nothing of the JAX
package. tests/test_torch_geometry.py holds every default equal to the
reference's. The port's functions read these fields by name, so either
package's `SLAMConfig` instance drives them.

The reference scatters load-bearing constants across YAML settings files
and hardcoded C++ (SURVEY.md §6.6: matcher thresholds TH_LOW/TH_HIGH,
covisibility weights 15/100, culling ratios, chi2 cutoffs, ORB extractor
params from TUM*.yaml). Here every one of them is a named, documented
field with the reference's default, so ATE parity is a config question,
not an archaeology question.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ORBConfig:
    """ORB extractor (reference: ORBextractor ctor args from YAML)."""

    n_features: int = 1000        # ORBextractor.nFeatures
    scale_factor: float = 1.2     # ORBextractor.scaleFactor
    n_levels: int = 8             # ORBextractor.nLevels
    ini_th_fast: int = 20         # ORBextractor.iniThFAST
    min_th_fast: int = 7          # ORBextractor.minThFAST
    # TPU front-end specifics (no upstream counterpart)
    cell_size: int = 16           # score-grid cell for spatial balancing
    max_keypoints: int = 1024     # static keypoint capacity (>= n_features)
    patch_size: int = 31          # orientation/descriptor patch
    edge_margin: int = 19         # keep keypoints this far from the border
    use_pallas_fast: bool = False  # Pallas FAST kernel (see frame.py note)
    # production descriptor path: "matmul" (angle-binned MXU
    # formulation with bilinear sample taps + angular interpolation —
    # the fast default; bit-agreement with "direct" is golden-tested at
    # the matcher's TH_LOW bar, tests/test_frontend.py) or "direct"
    # (exact-angle rotated gather — the validation sampler; ~2.5x the
    # front-end device time of the matmul path on v5e). The r3 matmul
    # variant (nearest-bin + nearest-pixel) broke loop closure and was
    # reverted; the bilinear+lerp rewrite passes every loop gate
    # (VERDICT r4 next #2).
    descriptor_variant: str = "matmul"


@dataclass(frozen=True)
class MatcherConfig:
    """Hamming matcher thresholds (reference: ORBmatcher.cc constants)."""

    th_low: int = 50              # TH_LOW
    th_high: int = 100            # TH_HIGH
    nn_ratio_tracking: float = 0.9
    nn_ratio_reloc: float = 0.75
    check_orientation: bool = True
    histo_bins: int = 30          # HISTO_LENGTH
    search_radius_motion: float = 15.0   # SearchByProjection frame-frame
    search_radius_map: float = 4.0       # SearchByProjection frame-localmap
                                         # (reference th=1 path: 4.0*scale
                                         # for general viewing angles)


@dataclass(frozen=True)
class TrackingConfig:
    """Tracking thread policy (reference: Tracking.cc)."""

    th_depth: float = 40.0        # ThDepth: close/far split, in units of b
    depth_map_factor: float = 5000.0
    min_frames_between_kf: int = 0
    # throughput-mode KF throttle: the reference's NeedNewKeyFrame
    # refuses insertion while LocalMapping is busy with >=3 queued KFs
    # (SetAcceptKeyFrames false); in the fused-chunk scan mapping runs
    # inline, so the queue-backpressure analog is a minimum frame gap
    # between in-scan keyframes. Applied only by track_sequence.
    interrupt_min_kf_gap: int = 2
    max_frames_between_kf: int = 30       # ~fps
    kf_ref_ratio: float = 0.75            # thRefRatio for RGB-D
    kf_ref_ratio_mono: float = 0.9        # thRefRatio for MONOCULAR
    kf_min_inliers_mono: int = 15         # reference mono c2 inlier bar
    kf_min_close_tracked: int = 100       # nTrackedClose threshold
    kf_max_close_insertable: int = 70     # nNonTrackedClose threshold
    min_inliers_ok: int = 30              # matches to declare tracking OK
    min_inliers_reloc: int = 50
    # (the reference's UpdateLastFrame VO-point cap has no counterpart:
    # the motion-model stage here matches against ALL last-frame depth
    # unprojections, and the final solve deliberately uses map points
    # only — see tracking.py's TrackLocalMap note)


@dataclass(frozen=True)
class PoseOptConfig:
    """Motion-only BA (reference: Optimizer::PoseOptimization)."""

    rounds: int = 4
    iters_per_round: int = 10
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    huber_delta_mono: float = 2.4477   # sqrt(5.991)
    huber_delta_stereo: float = 2.7955  # sqrt(7.815)
    init_lambda: float = 1e-3
    # capture-resistance audit (ba.pose_consensus): batched Horn
    # hypotheses scored under a TIGHT reprojection window; the LM solve
    # is replaced when a hypothesis decisively out-scores it
    consensus_hypotheses: int = 64
    consensus_chi2: float = 2.0        # tight window (1.4px at level 0)
    consensus_ratio: float = 1.08      # decisive-win margin
    consensus_min_3d: int = 30         # skip audit without enough depth
    consensus_audit_points: int = 256  # association subsample for audit


@dataclass(frozen=True)
class LocalBAConfig:
    """Local bundle adjustment window (reference: LocalBundleAdjustment)."""

    max_local_kfs: int = 16       # covisible window (reference: all covisible)
    max_fixed_kfs: int = 16       # fixed observer KFs in the window
                                  # (capped by the 32-camera problem size)
    max_points: int = 4096
    # (edge capacity is structural: window cams x per-KF feature slots)
    outer_iters_1: int = 5
    outer_iters_2: int = 10
    # interruptible schedule for throughput mode: the reference's
    # LocalMapping sets mbAbortBA and cuts local BA short whenever the
    # next keyframe is already queued (InterruptBA, SURVEY.md §4.3);
    # in the fused-chunk scan a next frame is by construction pending,
    # so in-scan mapping runs this shorter schedule.
    interrupt_iters_1: int = 3
    interrupt_iters_2: int = 5
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    huber_delta: float = 2.7955


@dataclass(frozen=True)
class MappingConfig:
    """Local mapping policy (reference: LocalMapping.cc)."""

    cull_found_ratio: float = 0.25     # MapPointCulling found/visible
    cull_min_obs: int = 3
    kf_cull_redundancy: float = 0.9    # KeyFrameCulling ≥90% redundant
    # fuse budget of the post-loop group SearchAndFuse (reference
    # SearchInNeighbors covers ~10+5 neighbors; 4 measured sufficient
    # on the sweep-revisit world — see loopclosing.search_and_fuse)
    fuse_neighbors: int = 4
    # SearchInNeighbors' REVERSE direction at every mapping pass: fuse
    # map points into this many top covisible NEIGHBOR keyframes (not
    # just the new KF). Without it a freshly triangulated point stalls
    # at 2 observations until a future keyframe happens to re-observe
    # it, which (a) starves the reference's TrackedMapPoints(minObs=3)
    # count that NeedNewKeyFrame's thRefRatio trigger reads — measured
    # mono keyframe-insertion deadlock — and (b) leaves duplicate
    # points in the neighbors unmerged. interrupt_* applies in
    # throughput mode's in-scan mapping (InterruptBA rationale).
    fuse_reverse_neighbors: int = 2
    # throughput mode's in-scan mapping skips the reverse pass by
    # default (InterruptBA load-shedding rationale: it exists to give
    # fresh points their 3rd observation QUICKLY for the keyframe-
    # policy counters, and in-scan keyframes arrive so densely that the
    # next forward fuse covers it within a few frames; measured no
    # accuracy change on the throughput e2e gates, ~10 ms/KF saved)
    interrupt_fuse_reverse_neighbors: int = 0
    covisibility_min_weight: int = 15  # covisibility edge threshold
    max_new_points_per_kf: int = 512
    # grid-stratified spawn: cap new map points per image cell so one
    # CLOSE structure (a walking person filling the frame center) cannot
    # monopolize the depth-sorted creation budget and outvote the static
    # world in the next pose solve. 0 disables the cap.
    spawn_cell_px: int = 80
    spawn_cell_quota: int = 16
    # triangulation partners per keyframe (0 = module default 4; the
    # reference searches ~10 best covisible KFs — 4 measured equivalent
    # on synthetic worlds at 5x less work, see mapping.TRIANG_NEIGHBORS);
    # interrupt_triang_neighbors applies in throughput mode's in-scan
    # mapping (same InterruptBA rationale as LocalBAConfig).
    triang_neighbors: int = 0
    interrupt_triang_neighbors: int = 2


@dataclass(frozen=True)
class CRFConfig:
    """CRF dynamic labeler (the fork's addition; SURVEY.md §4.5 [P]).

    Energy weights are exposed because the exact paper values could not be
    verified (empty reference mount); defaults calibrated on synthetic
    dynamic scenes.
    """

    enabled: bool = True
    mean_field_iters: int = 5
    # unary weights
    w_reproj: float = 1.0           # long-term reprojection consistency
    w_depth: float = 1.0            # projected-vs-measured depth
    w_flow: float = 0.5             # short-term track / flow consistency
    reproj_sigma: float = 0.6       # px, on the post-opt residual at
                                    # the audited pose (tracking.py)
    # Miss evidence (visible-but-unmatched tracks) is two-tier: a miss
    # CORROBORATED by an existing motion cue (elevated flow or residual
    # EMA — the signature of a mover whose map position went stale)
    # pushes the error EMA hard toward miss_err; an uncorroborated miss
    # (extraction dropout during fast rotation, occlusion) only drifts
    # toward miss_err_weak, deliberately BELOW the solo-dynamic
    # threshold ((x/reproj_sigma)^2 < dynamic_bias). Without the split,
    # rotation dropouts dynamic-labeled and culled half the static map
    # (sweep world: 1222 -> 42 surviving early points); without the
    # strong tier, stale mover points stop accumulating energy the
    # moment they leave the match gate and survive in the map.
    miss_err: float = 2.5           # px EMA target, corroborated misses
    miss_err_weak: float = 1.0      # px EMA target, uncorroborated
    miss_corroborate_flow: float = 1.25   # px flow EMA that corroborates.
                                          # Flow is the ONLY corroborating
                                          # channel: it is frozen-elevated
                                          # on a stale mover (no updates
                                          # once unmatched) and stays at
                                          # LK-noise level on statics even
                                          # under fast rotation, while a
                                          # residual-EMA channel was
                                          # measured to self-escalate on
                                          # statics with honest 1.5 px
                                          # residuals during the sweep
    miss_border_px: float = 16.0    # misses only count this far inside
                                    # the image (border dropouts are
                                    # extraction artifacts, not motion)
    depth_sigma: float = 0.03       # relative depth error scale
    flow_sigma: float = 2.0         # px
    prior_static: float = 0.6       # label prior
    dynamic_bias: float = 4.0       # constant dynamic-label energy: a track
                                    # whose normalized inconsistency energy
                                    # exceeds this is labeled dynamic
    # pairwise
    knn: int = 8
    pairwise_weight: float = 2.0
    spatial_sigma: float = 0.35     # m, Gaussian kernel on 3D distance
    # consumption
    dynamic_threshold: float = 0.5  # P(dynamic) above this excludes point
    history_decay: float = 0.8      # EMA decay for long-term evidence
    # spawn gating: keypoints whose measured LK flow departs from the
    # rigid egomotion prediction by more than this (px) are dynamic
    # candidates and never become map points — stops a large coherent
    # mover from re-polluting the map at every keyframe. 0 disables.
    spawn_flow_gate: float = 2.5
    # solve gating: points whose flow-inconsistency EMA (p_flow_err)
    # exceeds this (px) are excluded from the pose-solve edge set. A
    # large coherent mover is geometrically indistinguishable from the
    # static world within any single frame (both are rigid); the flow
    # EMA carries the discrimination made while poses were still honest
    # across the frames where the mover would otherwise capture the
    # solve. 0 disables. Only active on the image pipeline (the EMA
    # stays 0 without images).
    solve_flow_gate: float = 2.5
    flow_decay: float = 0.5         # EMA decay for the (short-term) flow
                                    # cue; faster than history_decay so
                                    # the solve gate reacts in ~2 frames
    # LK pyramid depth for the flow-evidence tracks. Each level costs a
    # fixed ~3 ms/frame-pair on v5e regardless of resolution (the
    # per-keypoint window extraction dominates, benchmarks/lk_micro2),
    # and the capture range is ±SEARCH_RAD px per level of the
    # coarse-to-fine chain (ADVICE r3: ±42 px at 3 levels, ±18 at 2).
    # Inter-frame feature motion on 30 fps indoor sequences is well
    # inside ±18 px, but 3 stays the default for safety; the bench
    # profile may drop to 2.
    flow_levels: int = 3


@dataclass(frozen=True)
class LoopConfig:
    """Loop closing (reference: LoopClosing.cc + KeyFrameDatabase)."""

    enabled: bool = True
    min_kfs_since_last: int = 10
    consistency_needed: int = 3        # mnCovisibilityConsistencyTh
    min_bow_matches: int = 20
    min_sim3_inliers: int = 20
    min_total_matches: int = 40        # guided-rematch inliers to accept
    # seed bars for the pre-guided stages (deliberate redesign of the
    # reference's gate budget, loopclosing.verify_loop: the decision
    # rests on the guided stage at the FULL bars above; the early
    # stages only need to seed a usable correction). 0 = derive as
    # max(min_*//2, 8) — the historical default, now explicit.
    seed_bow_matches: int = 0
    seed_sim3_inliers: int = 0
    # retrieval gates (KeyFrameDatabase::DetectLoopCandidates analog):
    # absolute cosine-similarity floor under the covisible-min score,
    # and the cap on that covisible-min (a KF whose neighbors are all
    # near-identical must not set an unreachable bar)
    retrieval_floor: float = 0.35
    min_score_cap: float = 0.9
    guided_radius_px: float = 8.0      # SearchByProjection window (px)
    ransac_hypotheses: int = 256       # batched Horn hypotheses
    ransac_inlier_chi2: float = 9.210
    fix_scale: bool = True             # RGB-D
    pose_graph_iters: int = 20
    covis_edge_weight: int = 100       # strong covisibility edges in ess. graph
    retrieval_topk: int = 8
    # Global BA off the hot path (reference RunGlobalBundleAdjustment
    # runs in a detached, abortable thread; SURVEY.md §4.4): after the
    # pose-graph correction, full-map BA is dispatched as budgeted
    # SLICES — gba_slice_iters LM iterations per subsequent frame (or
    # per chunk in throughput mode) until gba_total_iters have run,
    # then the group-wide SearchAndFuse fires. A frame therefore never
    # stalls on more than one slice. A new verified loop while slices
    # remain aborts the pending budget and restarts it (the reference's
    # mbStopGBA abort). gba_slice_iters = 0 restores the synchronous
    # r3 behavior (whole budget + fuse inside the loop-closing call).
    gba_total_iters: int = 6
    gba_slice_iters: int = 2


@dataclass(frozen=True)
class MapConfig:
    """Fixed capacities of the functional map state."""

    max_points: int = 32768
    max_keyframes: int = 320
    max_features: int = 1024           # per keyframe (= ORBConfig.max_keypoints)


@dataclass(frozen=True)
class SLAMConfig:
    # sensor mode, set by the System entry point actually used
    # ("rgbd" / "stereo" / "monocular"). Keyframe-insertion policy
    # constants switch on THIS, not on per-frame data — an RGB-D frame
    # that transiently has zero valid-depth features must not silently
    # adopt the mono insertion rules (ADVICE r3).
    sensor: str = "rgbd"
    orb: ORBConfig = field(default_factory=ORBConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    pose_opt: PoseOptConfig = field(default_factory=PoseOptConfig)
    local_ba: LocalBAConfig = field(default_factory=LocalBAConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    crf: CRFConfig = field(default_factory=CRFConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    map: MapConfig = field(default_factory=MapConfig)

    def replace(self, **kwargs) -> "SLAMConfig":
        return dataclasses.replace(self, **kwargs)


def tum_config(preset: int = 3, **overrides):
    """(SLAMConfig, Pinhole) for a TUM RGB-D sequence family (fr1/fr2/fr3).
    The three TUM*.yaml settings files differ only in the camera, so the
    preset selects the camera model; `overrides` patch the config's
    sections."""
    from .geometry.camera import TUM1, TUM2, TUM3

    try:
        cam = {1: TUM1, 2: TUM2, 3: TUM3}[preset]
    except KeyError:
        raise ValueError(f"unknown TUM preset {preset!r}; expected 1/2/3")
    return SLAMConfig(**overrides), cam


def load_yaml(path: str) -> SLAMConfig:
    """A config from a flat `section.key: value` file (configs/*.yaml);
    sections are the field names above. Values are Python literals read
    with `ast.literal_eval` (numbers, booleans, strings); anything else
    stays the raw string, as in the reference."""
    import ast
    import re

    cfg = SLAMConfig()
    sections = {f.name: {} for f in dataclasses.fields(cfg)}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            m = re.match(r"([\w.]+)\s*:\s*(.+)", line)
            if not m or "." not in m.group(1):
                continue
            sec, name = m.group(1).split(".", 1)
            if sec in sections:
                val = m.group(2).strip()
                try:
                    sections[sec][name] = ast.literal_eval(val)
                except (ValueError, SyntaxError):
                    sections[sec][name] = val
    return SLAMConfig(**{
        f.name: (dataclasses.replace(getattr(cfg, f.name), **sections[f.name])
                 if sections[f.name] else getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)})
