"""Optimizer core: the functional Transform API, the combinators, the
projectors and the family plan, every named optimizer of the paper (GUM,
unbiased GaLore-Adam, Algorithm 3, GaLore / GaLore-Muon / GoLore, Muon,
AdamW, SGDM, Fira, LISA), the projected-space gradient accumulation of GUM
(``gum_accum_tools``), the rank-policy engine (``rank_policy``: rank maps,
policies, state migration, the controller), and the factory."""
from repro_torch.core.adamw import adamw, sgdm
from repro_torch.core.api import (
    MultiState,
    OptimizerConfig,
    Transform,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    multi_transform,
    state_bytes,
    tree_paths,
)
from repro_torch.core.combinators import (
    FullUpdate,
    LayerwiseUnbiasState,
    LowRankState,
    PendingBack,
    ProjGrad,
    add_decayed_weights,
    chain,
    chain_info,
    find_lowrank_states,
    generator_sampler,
    layerwise_unbias,
    lowrank,
    materialize_pending,
    scale_by_adam,
    scale_by_factor,
    scale_by_lr,
    scale_by_momentum,
    scale_by_muon,
    with_fira_residual,
    with_matrix_routing,
)
from repro_torch.core.factory import build_optimizer, resolve_rank_policy
from repro_torch.core.family_plan import FamilyPlan, StackSeg, build_family_plan
from repro_torch.core.fira import fira, fira_matrices
from repro_torch.core.galore import galore, galore_matrices, golore
from repro_torch.core.gum import (
    GUMAccumTools,
    gum,
    gum_accum_tools,
    gum_matrices,
    unbiased_galore_adam,
)
from repro_torch.core.lisa import lisa
from repro_torch.core.lowrank_common import default_lowrank_filter, generator_noise
from repro_torch.core.muon import muon, muon_matrices
from repro_torch.core.newton_schulz import muon_scale
from repro_torch.core.projectors import (
    grass_projector,
    make_projector,
    random_projector,
    rsvd_projector,
    subspace_projector,
    svd_projector,
)
from repro_torch.core.rank_policy import (
    RankMap,
    RankPolicy,
    RankPolicyController,
    gather_probes,
    migrate_opt_state,
    parse_rank_policy,
)
from repro_torch.core.unbiased import unbiased_lowrank
from repro_torch.core import rank_policy

__all__ = [
    "FamilyPlan", "FullUpdate", "GUMAccumTools", "LayerwiseUnbiasState", "LowRankState", "MultiState",
    "OptimizerConfig", "PendingBack", "ProjGrad", "RankMap", "RankPolicy",
    "RankPolicyController", "StackSeg", "Transform",
    "adamw", "add_decayed_weights", "apply_updates", "build_family_plan",
    "build_optimizer", "chain", "chain_info", "clip_by_global_norm", "default_lowrank_filter",
    "find_lowrank_states", "fira", "fira_matrices", "galore", "galore_matrices",
    "gather_probes", "generator_noise", "generator_sampler", "global_norm", "golore", "grass_projector",
    "gum", "gum_accum_tools", "gum_matrices", "layerwise_unbias", "lisa", "lowrank", "make_projector",
    "materialize_pending", "migrate_opt_state", "multi_transform", "muon", "muon_matrices", "muon_scale",
    "parse_rank_policy", "random_projector", "rank_policy", "resolve_rank_policy",
    "rsvd_projector", "scale_by_adam", "scale_by_factor",
    "scale_by_lr", "scale_by_momentum", "scale_by_muon", "sgdm", "state_bytes",
    "subspace_projector", "svd_projector", "tree_paths", "unbiased_galore_adam",
    "unbiased_lowrank", "with_fira_residual", "with_matrix_routing",
]
