"""The port's configuration: the sections of ``fitslam_tpu/utils/config.py``
that the ported slices read (the stereo slice's camera, orb, tracking,
mapping and loop; exploration and active SLAM's traversability through
recovery; the dual EKF's localization; the fleet's multi_robot), with
``FitSlamConfig.preset`` and ``validate``.

The port keeps its own copy so that it, and ``chip_smoke.py`` on the card,
import nothing of the reference package. Field names and defaults equal the
reference's field for field (``tests/test_torch_utils.py`` checks it), so a
reference ``FitSlamConfig`` can be passed to the port's ``StereoSlam``,
``ExplorationServer``, ``ActiveSlamSystem`` and ``MultiRobotCoordinator``
as well. The one section no ported slice reads (parallel) is not here; YAML
loading stays with the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole stereo/RGB-D intrinsics."""

    width: int = 640
    height: int = 480
    fx: float = 320.0
    fy: float = 320.0
    cx: float = 320.0
    cy: float = 240.0
    baseline: float = 0.12          # stereo baseline [m]
    depth_min: float = 0.3
    depth_max: float = 14.0
    rgbd: bool = False


@dataclass(frozen=True)
class OrbConfig:
    num_features: int = 1024        # fixed capacity per frame (masked)
    num_levels: int = 4
    scale_factor: float = 1.4142135
    fast_threshold: float = 20.0
    cell_size: int = 16
    descriptor_bits: int = 256


@dataclass(frozen=True)
class TrackingConfig:
    max_matches: int = 512
    match_max_hamming: int = 64
    match_ratio: float = 0.8
    search_radius_px: float = 24.0
    wide_radius_px: float = 96.0
    reinit_after_lost: int = 6              # frames lost before reinit KF
    reloc_enabled: bool = True
    reloc_after_lost: int = 2
    reloc_min_score: float = 0.1
    reloc_min_inliers: int = 20
    pose_gn_iters: int = 8
    huber_delta_px: float = 3.0
    min_inliers: int = 15
    keyframe_min_interval: int = 4          # frames
    keyframe_translation: float = 0.35      # [m]
    keyframe_rotation: float = 0.25         # [rad]
    keyframe_min_tracked_ratio: float = 0.6


@dataclass(frozen=True)
class MappingConfig:
    max_keyframes: int = 256
    max_landmarks: int = 8192
    max_observations: int = 32768
    local_window: int = 8           # keyframes in local BA
    covisibility_window: bool = True
    ba_iters: int = 6
    ba_damping: float = 1e-4
    cull_min_observations: int = 2
    reproj_chi2_mono: float = 5.991
    reproj_chi2_stereo: float = 7.815
    recycle_at_fraction: float = 0.92
    recycle_target_fraction: float = 0.7
    close_depth_factor: float = 60.0


@dataclass(frozen=True)
class LoopConfig:
    enabled: bool = True
    vocab_dim: int = 256
    min_score: float = 0.22
    min_gap_keyframes: int = 20
    min_matches: int = 40
    consistency_threshold: int = 1
    consistency_radius_kf: int = 5
    cooldown_keyframes: int = 0
    gba_min_interval_kf: int = 6
    max_loop_edges: int = 32
    pgo_iters: int = 12
    run_global_ba: bool = True
    gba_iters: int = 8
    covis_max_edges: int = 256
    covis_min_shared: int = 15
    correct_tail_kf: int = 8
    fuse_landmarks: bool = True
    retriangulate: bool = True
    scale_search_halfrange: float = 0.0
    scale_search_points: int = 13


@dataclass(frozen=True)
class TraversabilityConfig:
    """SURVEY.md §2.1 S5; traversabilityParams.yaml:1-32."""

    resolution: float = 0.25
    half_size_m: float = 20.0       # local map half size
    global_size_m: float = 80.0
    security_distance: float = 0.6
    ground_clearance: float = 0.17
    max_slope: float = 0.7
    robot_height: float = 1.5
    lethal_threshold: int = 55      # traversability_ros_params.yaml:22-24
    kf_optimization_enabled: bool = True
    max_points_per_cloud: int = 16384
    max_clouds: int = 256           # per-KF cloud ring buffer


@dataclass(frozen=True)
class FrontierSearchConfig:
    """SURVEY.md §2.3 E3; namespace frontierSearch."""

    search_radius_m: float = 12.0
    search_radius_growth: float = 1.5
    max_frontier_cluster_size: int = 20
    min_frontier_cluster_size: int = 1
    max_frontiers: int = 128
    cc_iters: int = 64              # label-propagation rounds for clustering


@dataclass(frozen=True)
class CostCalculatorConfig:
    """SURVEY.md §2.3 E5; namespace costCalculator."""

    raycast_depth_m: float = 2.0
    raycast_dtheta: float = 0.1     # rad; 63 rays over 2*pi
    camera_fov: float = 1.04        # rad box-filter width
    max_ray_cells: int = 32
    factor_of_max_info: float = 0.7  # achievability floor
    closeness_rejection_m: float = 0.5


@dataclass(frozen=True)
class CostAssignerConfig:
    cost_calculation_methods: Tuple[str, ...] = (
        "RoadmapPlannerDistance",
        "ArrivalInformation",
    )
    alpha: float = 0.25             # info weight in utility
    beta: float = 1.0
    max_linear_velocity: float = 0.5
    max_angular_velocity: float = 0.5
    planner_allow_unknown: bool = True


@dataclass(frozen=True)
class RoadmapConfig:
    """SURVEY.md §2.3 E8; namespace frontierRoadmap."""

    max_nodes: int = 1024
    max_edges_per_node: int = 16
    spatial_hash_cell_m: float = 1.0
    min_node_separation: float = 0.45
    max_edge_length: float = 6.1
    max_unknown_fraction: float = 0.3
    trailing_pose_count: int = 10
    cleanup_period_s: float = 15.0
    correct_loop_closure: bool = True


@dataclass(frozen=True)
class PathOptimizerConfig:
    """SURVEY.md §2.3 E10; namespace fullPathOptimizer."""

    max_local_frontiers: int = 5
    local_path_threshold_m: float = 12.0
    add_yaw_to_tsp: bool = False
    add_distance_to_robot_to_tsp: bool = True
    blacklist_radius_m: float = 1.2
    # a goal REACHED but still unmapped (it sits inside the sensor's blind
    # radius) only needs its own blind spot excluded — the full
    # blacklist_radius_m there was measured to wall off a small room's
    # frontiers after a handful of goals
    unmappable_blacklist_radius_m: float = 0.5
    max_blacklist: int = 64


@dataclass(frozen=True)
class GoalHysteresisConfig:
    enabled: bool = True
    use_euclidean: bool = True      # mutually exclusive with use_roadmap
    use_roadmap: bool = False
    switch_threshold_m: float = 3.0


@dataclass(frozen=True)
class FisherInformationConfig:
    """SURVEY.md §2.2 F1-F4; namespace fisherInformation."""

    enabled: bool = True
    threshold: float = 550.0        # FisherInfoBTPlugin.cpp:20 / v1 yaml
    max_landmark_distance: float = 14.0
    max_landmarks: int = 2048
    voxel_step_min: float = 0.09
    voxel_step_max: float = 0.3
    saturation_exponent: float = 0.8  # exp(1 - count^0.8)
    measurement_noise: float = 0.01
    fov_half_angle: float = 0.52    # camera half-FOV for pair info
    lethal_wedge_apex_deg: float = 45.0
    lethal_wedge_height_m: float = 3.5
    # FI-failure wedges expire after this many BT ticks (<= 0 = never);
    # durable blacklist-eviction discs never expire (r05 overlay hygiene)
    lethal_wedge_ttl_ticks: int = 600
    blacklist_lookahead_m: float = 2.5
    # FI retry ladder (OptimizeFullPath BT node, ExplorationBT.cpp:517-668):
    # after number_retries-1 UNSAFE ticks the landmark search escalates to
    # exhaustive; at number_retries the pose ahead is blacklisted + wedged
    number_retries: int = 3
    # isPathSafe (FullPathOptimizer.cpp:308-340): FOV-overlap angle between
    # the robot->goal segment heading and trailing robot pose headings that
    # triggers the pose-pair FI check (reference ctor value 6.6 rad, :21 —
    # > pi, i.e. every trailing pose overlaps). Off by default, matching the
    # reference's active code path where the getNextGoal isPathSafe call is
    # commented out in favor of isRobotPoseSafe (FullPathOptimizer.cpp:600-603)
    check_path_safety: bool = False
    angle_fov_overlap_rad: float = 6.6
    # fisher_information_in_path gate: frontiers whose straight approach path
    # carries less mean FOV information than this are unachievable
    # (CostCalculator.cpp:330-389 path-FI accumulation; 0 disables)
    min_path_information: float = 0.0
    path_fi_waypoints: int = 6


@dataclass(frozen=True)
class ExplorationBTConfig:
    """Namespace explorationBT; BT pacing + retry ladder."""

    tick_dt_s: float = 0.07         # bt_sleep_ms 70
    rate_hz: float = 1.0            # 5.0 in rapid mode
    nav2_goal_timeout_s: float = 60.0
    # InitializationSequence bootstrap wiggle (reference: 8 s forward +
    # 360 deg spin, initialization_controller.cpp:4-60)
    bootstrap_enabled: bool = False
    bootstrap_forward_s: float = 2.0
    bootstrap_speed: float = 0.3
    bootstrap_spin_rate: float = 0.8    # rad/s; spin runs a full turn
    max_nav_failures_before_blacklist: int = 4
    # force a blacklist when the FI gate only passes via exhaustive search
    # this many times in a row (fi_drop_count == 2 pattern detector,
    # ExplorationBT.cpp:549-554)
    fi_drop_limit: int = 2
    abort_on_nav_abort: bool = False
    replan_timeout_s: float = 6.0
    # ClearCostmap recovery rung: after this many consecutive failures with
    # no completed goal, aged wedge markings within the radius are cleared
    # (reference: ClearCostmap recoveries, active_slam_explore_to_pose.xml:8-30)
    clear_costmap_failures: int = 4
    clear_costmap_radius_m: float = 4.0


@dataclass(frozen=True)
class SensorSimulatorConfig:
    """Namespace sensorSimulator (coverage accounting in light/rapid modes)."""

    enabled: bool = False
    angular_resolution: float = 0.013
    range_m: float = 1.5
    rate_hz: float = 1.0


@dataclass(frozen=True)
class NavConfig:
    """Nav2-equivalent planner/controller (SURVEY.md §2.4)."""

    # "wavefront" = NavFn-equivalent potential planning (N2);
    # "roadmap" = replay the exploration-published refined path (E16,
    # PlannerSelector in active_slam_explore_to_pose.xml:10)
    planner: str = "wavefront"
    planner_tolerance_m: float = 0.5
    allow_unknown: bool = True
    controller_rate_hz: float = 10.0
    desired_speed: float = 0.5
    lookahead_m: float = 0.6
    rotate_to_heading: bool = True
    inflation_radius_m: float = 1.0
    cost_scaling_factor: float = 5.0
    replan_rate_hz: float = 10.0
    wavefront_iters: int = 512      # NavFn-equivalent relaxation sweeps


@dataclass(frozen=True)
class CostmapLayerConfig:
    """One nav2 costmap instance: static source + inflation layer(s)
    (SURVEY.md §2.4 N4, active_slam_nav2_params.yaml:118-173)."""

    rolling: bool = False           # rolling_window: robot-centered window
    size_m: float = 10.0            # rolling window width/height
    resample: int = 1               # >1 upsample factor, <-1 downsample |k|
    inflation_radius_m: float = 0.6
    cost_scaling_factor: float = 0.6
    inscribed_radius_m: float = 0.10  # robot_radius
    lethal_marker: bool = False     # apply the LethalMarker overlay (E15)
    # second inflation pass over marked lethal zones
    # (lethal_inflation_layer, radius 0.3)
    lethal_inflation_radius_m: float = 0.0


@dataclass(frozen=True)
class CostmapsConfig:
    """The reference's two nav2 costmap instances: a rolling local costmap
    (10x10 m @0.25, inflation 0.6/0.6) and a global costmap (@0.05 upsample,
    inflation 0.6/5.0 + LethalMarker + lethal inflation 0.3). The exploration
    server keeps its own third instance (N6) built from the raw occupancy +
    lethal overlay."""

    local: CostmapLayerConfig = field(default_factory=lambda: CostmapLayerConfig(
        rolling=True, size_m=10.0, inflation_radius_m=0.6,
        cost_scaling_factor=0.6, inscribed_radius_m=0.10))
    global_map: CostmapLayerConfig = field(default_factory=lambda: CostmapLayerConfig(
        rolling=False, inflation_radius_m=5.0, cost_scaling_factor=0.6,
        inscribed_radius_m=0.05, lethal_marker=True,
        lethal_inflation_radius_m=0.3))


@dataclass(frozen=True)
class RecoveryConfig:
    """SURVEY.md §2.3 E14."""

    probe_distance_m: float = 2.5
    move_distance_m: float = 0.84
    speed: float = 0.6


@dataclass(frozen=True)
class LocalizationConfig:
    """N5: robot_localization dual-EKF + twist_mux wired into the live loop
    (ekf_with_gps.yaml / twist_mux.yaml). When enabled, ActiveSlamSystem
    fuses wheel-odometry twist + IMU through the odom-frame filter and
    additionally the SLAM pose (the absolute reference, in GPS's role)
    through the map-frame filter; the fused map-frame pose becomes
    get_robot_pose, and nav/recovery twists route through TwistMux."""

    enabled: bool = False
    odom_var: float = 0.01          # wheel twist variance
    imu_rate_var: float = 0.005
    imu_ori_var: float = 0.01
    imu_gate: float = 0.8           # imu0 mahalanobis threshold (yaml)
    slam_pose_var: float = 0.02
    slam_pose_gate: float = 3.0     # reject loop-closure-scale jumps
    fuse_every_n_frames: int = 1    # SLAM pose fusion decimation


@dataclass(frozen=True)
class MultiRobotConfig:
    max_robots: int = 4
    allocator: str = "hungarian"    # or "minpos"


@dataclass(frozen=True)
class FitSlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    traversability: TraversabilityConfig = field(default_factory=TraversabilityConfig)
    frontier_search: FrontierSearchConfig = field(default_factory=FrontierSearchConfig)
    cost_calculator: CostCalculatorConfig = field(default_factory=CostCalculatorConfig)
    cost_assigner: CostAssignerConfig = field(default_factory=CostAssignerConfig)
    roadmap: RoadmapConfig = field(default_factory=RoadmapConfig)
    path_optimizer: PathOptimizerConfig = field(default_factory=PathOptimizerConfig)
    goal_hysteresis: GoalHysteresisConfig = field(default_factory=GoalHysteresisConfig)
    fisher_information: FisherInformationConfig = field(default_factory=FisherInformationConfig)
    exploration_bt: ExplorationBTConfig = field(default_factory=ExplorationBTConfig)
    sensor_simulator: SensorSimulatorConfig = field(default_factory=SensorSimulatorConfig)
    nav: NavConfig = field(default_factory=NavConfig)
    costmaps: CostmapsConfig = field(default_factory=CostmapsConfig)
    localization: LocalizationConfig = field(default_factory=LocalizationConfig)
    recovery: RecoveryConfig = field(default_factory=RecoveryConfig)
    multi_robot: MultiRobotConfig = field(default_factory=MultiRobotConfig)

    @staticmethod
    def preset(mode: str) -> "FitSlamConfig":
        """Per-mode config triples of the reference (SURVEY.md §5 config:
        launch_{rapid,light,active_slam}.sh select {params yaml, BT xml}
        differing only in tick rate, costmap publish rate, and FI nodes):

        - "rapid": 5 Hz pipeline rate, no Fisher-information gate, simulated
          coverage sensor on (rapid_exploration.xml:4, rapid params).
        - "light": 1 Hz rate, no FI gate, coverage sensor on, costmap publish
          effectively off (light params publish_frequency 0.001).
        - "active_slam": 1 Hz rate, FI gate + lethal-marker layer enabled
          (active_slam_exploration_params.yaml, active_slam_exploration.xml).
        """
        base = FitSlamConfig()
        if mode == "rapid":
            return replace(
                base,
                exploration_bt=replace(base.exploration_bt, rate_hz=5.0),
                fisher_information=replace(base.fisher_information,
                                           enabled=False),
                sensor_simulator=replace(base.sensor_simulator, enabled=True),
            ).validate()
        if mode == "light":
            return replace(
                base,
                exploration_bt=replace(base.exploration_bt, rate_hz=1.0),
                fisher_information=replace(base.fisher_information,
                                           enabled=False),
                sensor_simulator=replace(base.sensor_simulator, enabled=True),
            ).validate()
        if mode == "active_slam":
            return replace(
                base,
                exploration_bt=replace(base.exploration_bt, rate_hz=1.0),
                fisher_information=replace(base.fisher_information,
                                           enabled=True),
            ).validate()
        raise KeyError(f"unknown launch mode {mode!r}; "
                       "expected rapid | light | active_slam")

    def validate(self) -> "FitSlamConfig":
        """Startup sanity checks (reference: Parameters.cpp:6-60)."""
        gh = self.goal_hysteresis
        if gh.enabled and gh.use_euclidean and gh.use_roadmap:
            raise ValueError("goal_hysteresis: use_euclidean and use_roadmap are mutually exclusive")
        if not (0.0 < self.cost_assigner.alpha <= 1.0):
            raise ValueError("cost_assigner.alpha must be in (0, 1]")
        if self.fisher_information.threshold <= 0:
            raise ValueError("fisher_information.threshold must be positive")
        if self.traversability.lethal_threshold not in range(0, 256):
            raise ValueError("traversability.lethal_threshold must be a cost in [0, 255]")
        if self.frontier_search.max_frontier_cluster_size < 1:
            raise ValueError("frontier_search.max_frontier_cluster_size must be >= 1")
        return self
