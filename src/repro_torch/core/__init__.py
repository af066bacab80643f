"""Paper core of the port: mixing-matrix design, D-PSGD, joint designer,
priced training — the same names as the JAX package's ``repro.core``."""

from repro_torch.core.designer import (
    DesignOutcome,
    design,
    evaluate_design,
    sweep_iterations,
)
from repro_torch.core.dpsgd import (
    consensus_distance,
    feddyn_init,
    make_dpsgd_step,
    make_feddyn_step,
    mix_params,
    replicate_for_agents,
    train,
)
from repro_torch.core.priced_training import (
    GossipStrategy,
    PhasedTau,
    PricedTrainLog,
    RoundRecord,
    StaticTau,
    StochasticTau,
    pricer_for,
    train_priced,
)
from repro_torch.core.fmmd import FMMDResult, fmmd, fmmd_wp, theorem35_bound
from repro_torch.core.mixing import (
    ConvergenceConstants,
    ideal_matrix,
    incidence_matrix,
    iterations_to_converge,
    matrix_from_weights,
    rho,
    rho_gradient,
    swapping_matrix,
    total_time,
    validate_mixing,
    weights_from_matrix,
)
from repro_torch.core.sca import sca_design
from repro_torch.core.topology_baselines import (
    clique_design,
    clique_links,
    prim_design,
    prim_links,
    ring_design,
    ring_links,
)
from repro_torch.core.weight_opt import WeightOptResult, optimize_weights
