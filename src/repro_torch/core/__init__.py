"""CoCoI core: coded distributed inference (paper §II-IV), PyTorch port.

Public API (what this port holds so far):
    coding      — MDS / replication / LT codes
    schemes     — the CodingScheme protocol and registry
    splitting   — output-driven width/token splits with halo (eqs. 1-2)
    coded_conv  — coded distributed conv2d and coded segments
    coded_linear— coded distributed GEMM (transformer adaptation)
    latency     — shift-exponential latency model (eqs. 7-12)
    planner     — optimal splitting k*, k° (eq. 16, problem 13/17)
    hetero      — per-worker piece allocation for unequal workers
    netplan     — network-level plan compiler (coded segments)
    runtime     — master/worker straggler & failure simulation (§V)
    estimate    — online shift-exp (mu, theta) fitting from telemetry
"""
from .coding import MDSCode, ReplicationCode, LTCode
from .schemes import (
    CodingScheme,
    LTScheme,
    MDSScheme,
    ReplicationScheme,
    UncodedScheme,
    get_scheme,
    register_scheme,
    scheme_names,
)
from .splitting import (
    ConvSpec,
    SplitPlan,
    SegmentSplitPlan,
    plan_width_split,
    plan_token_split,
    plan_segment_split,
    chain_steps,
)
from .coded_conv import (
    conv2d,
    coded_conv2d,
    run_segment,
    boundary_op_counter,
)
from .coded_linear import coded_matmul, coded_ffn_segment
from .netplan import (
    LayerInfo,
    NetPlan,
    SegmentStep,
    LocalStep,
    compile_plan,
    segment_latency,
)
from .latency import ShiftExp, SystemParams, phase_sizes, harmonic
from .planner import (
    L,
    L_continuous,
    k_circ,
    k_circ_remainder_aware,
    k_star,
    expected_latency_mc,
    uncoded_latency,
    uncoded_latency_mc,
    replication_latency_mc,
    straggling_index_R,
    plan_layer,
)
from .hetero import allocate_pieces
from .estimate import (
    ProfileBank,
    WorkerProfile,
    calibrated_params,
    fit_shift_exp,
)
from .runtime import (
    SimScenario,
    simulate_layer,
    simulate_layer_batch,
    simulate_network,
)

__all__ = [
    "MDSCode", "ReplicationCode", "LTCode",
    "CodingScheme", "MDSScheme", "ReplicationScheme", "LTScheme",
    "UncodedScheme", "get_scheme", "register_scheme", "scheme_names",
    "ConvSpec", "SplitPlan", "SegmentSplitPlan", "plan_width_split",
    "plan_token_split", "plan_segment_split", "chain_steps",
    "conv2d", "coded_conv2d", "run_segment", "boundary_op_counter",
    "coded_matmul", "coded_ffn_segment",
    "LayerInfo", "NetPlan", "SegmentStep", "LocalStep", "compile_plan",
    "segment_latency",
    "ShiftExp", "SystemParams", "phase_sizes", "harmonic",
    "L", "L_continuous", "k_circ", "k_circ_remainder_aware", "k_star",
    "expected_latency_mc",
    "uncoded_latency", "uncoded_latency_mc", "replication_latency_mc",
    "straggling_index_R", "plan_layer",
    "allocate_pieces",
    "ProfileBank", "WorkerProfile", "calibrated_params", "fit_shift_exp",
    "SimScenario", "simulate_layer", "simulate_layer_batch",
    "simulate_network",
]
