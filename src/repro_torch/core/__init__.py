"""EdgeRL core (port of ``repro.core``): profiles (CNN analytic +
transformer), the single cost core (pricing: Eqs. 1-5 and 9-11 under torch
and numpy), the EdgeEnv MDP (Eq. 6-7), reward aggregation (Eq. 8), the
A2C agent (Sec. II-C, batched over parallel envs) and the PPO ablation,
the centralized controller (Sec. II-D) and cut-point partitioning of the
models."""
from repro_torch.core import partition
from repro_torch.core.env import (OBS_FEATURES, EnvConfig, ProfileTables,
                                  action_breakdown, build_tables, env_reset,
                                  env_step, observe)
from repro_torch.core.pricing import (PricingBreakdown, StateView, numpy_tables,
                                      price_actions, view_from_state)
from repro_torch.core.reward import RewardWeights
from repro_torch.core.a2c import A2CConfig, train, init_agent, make_train_episode
from repro_torch.core.ppo import PPOConfig
from repro_torch.core.profiles import paper_profiles, transformer_profile
from repro_torch.core.controller import (make_paper_env, make_tpu_env,
                                         make_task_sampler, measured_state,
                                         resolve_selection, train_agent,
                                         evaluate_policy, decide)

__all__ = [
    "OBS_FEATURES", "EnvConfig", "ProfileTables", "build_tables",
    "env_reset", "env_step", "observe", "action_breakdown",
    "PricingBreakdown", "StateView", "price_actions", "view_from_state",
    "numpy_tables", "RewardWeights", "A2CConfig", "PPOConfig",
    "train", "init_agent", "make_train_episode", "paper_profiles",
    "transformer_profile", "make_paper_env", "make_tpu_env",
    "make_task_sampler", "measured_state", "resolve_selection",
    "train_agent", "evaluate_policy", "decide", "partition",
]
