"""Network substrate of the port: underlay/overlay model, categories,
routing, simulation — own copies of the JAX package's ``net/`` modules, and
the float64 torch rollout engine (``net/torch_engine.py``, imported on use)."""

from repro_torch.net.categories import (
    Categories,
    CategoryIncidence,
    compile_category_incidence,
    compute_categories,
    infer_categories,
)
from repro_torch.net.demands import (
    MulticastDemand,
    activated_links_from_matrix,
    demands_from_links,
)
from repro_torch.net.routing import (
    PhasedRoutingSolution,
    RoutingSolution,
    route,
    route_congestion_aware,
    route_direct,
    route_milp,
    route_time_expanded,
)
from repro_torch.net.simulator import (
    BranchIncidence,
    CapacityPhase,
    CarryoverState,
    ChurnEvent,
    CrossTraffic,
    Scenario,
    SimResult,
    StragglerEvent,
    carryover_state,
    compile_incidence,
    lemma31_time,
    simulate,
    simulate_phased,
)
from repro_torch.net.stochastic import (
    CorrelatedOutages,
    MarkovLinkModel,
    StochasticScenario,
)
from repro_torch.net.topology import (
    MBPS,
    PAPER_MODEL_BYTES,
    OverlayNetwork,
    Underlay,
    build_overlay,
    dumbbell_underlay,
    grid_underlay,
    ici_torus_underlay,
    line_underlay,
    lowest_degree_nodes,
    mid_path_edges,
    random_geometric_underlay,
    roofnet_like,
)
