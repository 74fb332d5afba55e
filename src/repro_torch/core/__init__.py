"""MIG-Serving core, the port's copy of the JAX package's ``repro.core``:
the Reconfigurable Machine Scheduling Problem in practice.

Public surface of the paper's contribution:

  * rule-sets:   :class:`repro_torch.core.mig.A100Rules` (the paper's),
                 :class:`repro_torch.core.h100_slice.H100MigRules` (MIG
                 instances of one H100) and
                 :class:`repro_torch.core.h100_slice.H100NodeRules`
                 (groups of cards of an 8-card node)
  * profiles:    :class:`repro_torch.core.profiles.SyntheticPaperProfiles`,
                 :class:`repro_torch.core.profiles.RooflineProfiles`, their
                 §8.3 correction :class:`repro_torch.core.online_profiles.MeasuredProfile`
                 and the bridge from the port's architectures
                 (:mod:`repro_torch.core.arch_bridge`)
  * optimizer:   :class:`repro_torch.core.optimizer.TwoPhaseOptimizer`
  * controller:  :class:`repro_torch.core.controller.Controller`

Like the reference, these modules are host numpy/stdlib code: the
optimizer's choices are seeded numpy draws and float64 sums that the port
reproduces bit for bit.  The card's part is the profile they consume.
"""

from repro_torch.core.cluster import Action, SimulatedCluster, parallel_makespan
from repro_torch.core.controller import Controller, TransitionReport
from repro_torch.core.deployment import (
    ConfigSpace,
    Deployment,
    GPUConfig,
    IndexedDeployment,
    InstanceAssignment,
    OptimizerProcedure,
    Workload,
)
from repro_torch.core.ga import GeneticOptimizer, crossover, fitness_batch, mutate_swap
from repro_torch.core.greedy import GreedyFast
from repro_torch.core.h100_slice import (
    H100MigRules,
    H100NodeRules,
    h100_mig_rules,
    h100_node_rules,
)
from repro_torch.core.lower_bound import (
    baseline_homogeneous,
    baseline_static_mix,
    lower_bound_gpus,
)
from repro_torch.core.mcts import MCTSSlow
from repro_torch.core.exact import PairSpaceExact, per_service_lower_bound
from repro_torch.core.mig import A100Rules, a100_rules
from repro_torch.core.online_profiles import MeasuredProfile
from repro_torch.core.optimizer import BeamGreedy, OptimizeReport, TwoPhaseOptimizer
from repro_torch.core.profiles import (
    ArchPerfSpec,
    PerfProfile,
    RooflineProfiles,
    SyntheticPaperProfiles,
)
from repro_torch.core.rms import SLO, Instance, ReconfigRules, Service
from repro_torch.core.zoo import (
    EnergyAwareRepartitioner,
    FragAwarePacker,
    PowerModel,
    WeightedScoreGreedy,
    deployment_power,
    stranded_slices_of,
)
from repro_torch.roofline.hw import H100MigChip

__all__ = [
    "A100Rules", "a100_rules", "Action", "ArchPerfSpec", "BeamGreedy",
    "ConfigSpace", "Controller", "Deployment", "GeneticOptimizer", "GPUConfig",
    "GreedyFast", "IndexedDeployment", "Instance", "InstanceAssignment", "MCTSSlow",
    "OptimizeReport", "OptimizerProcedure", "parallel_makespan", "PerfProfile",
    "ReconfigRules", "RooflineProfiles", "Service", "SimulatedCluster", "SLO",
    "SyntheticPaperProfiles", "H100MigChip", "H100MigRules", "h100_mig_rules",
    "H100NodeRules", "h100_node_rules",
    "TransitionReport", "TwoPhaseOptimizer", "Workload",
    "baseline_homogeneous", "baseline_static_mix", "crossover",
    "fitness_batch", "lower_bound_gpus", "mutate_swap", "MeasuredProfile",
    "PairSpaceExact", "per_service_lower_bound",
    "EnergyAwareRepartitioner", "FragAwarePacker", "PowerModel",
    "WeightedScoreGreedy", "deployment_power", "stranded_slices_of",
]
