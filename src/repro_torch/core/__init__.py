"""CoCoA+ core of the port (`repro.core` counterpart).

    CoCoAConfig, CoCoAState, solve, init_state   -- Algorithm 1 driver
    losses.get_loss / LOSSES                     -- l, l*, coordinate updates
    regularizers.get_regularizer                 -- g, g*, the v -> w map
    solvers.{LocalSolver, register_solver, ...}  -- the local solver registry
    duality.{primal, gap_decomposed, gap_at_v}   -- certificates (eq. 4)
    baselines.run_minibatch_{sgd,cd}, one_shot_average -- Figure 2's methods
"""
from .cocoa import (CoCoAConfig, CoCoAState, SolveResult, init_state,
                    primal_w, solve, state_from_reference, state_from_tree,
                    state_to_tree)
from .losses import LOSSES, get_loss
from .regularizers import (L2, REGULARIZERS, Regularizer, get_regularizer,
                           make_elastic_net, make_smoothed_l1)
from .solvers import (SOLVERS, LocalSolver, get_solver, register_solver,
                      sparse_counterpart)
from . import baselines, duality, regularizers, sigma, solvers
