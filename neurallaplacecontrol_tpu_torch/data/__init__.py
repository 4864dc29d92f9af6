"""Data generation: synthetic batched integration, expert MPPI collection,
replay-buffer files and oracle validation."""

from .collector import collect_expert_data, load_expert_irregular_data_delay_time_multi  # noqa: F401
from .replay import load_replay_buffer, replay_buffer_filename, save_replay_buffer  # noqa: F401
from .synthetic import (  # noqa: F401
    SyntheticDraws,
    default_samples_per_dim,
    generate_irregular_data,
    generate_irregular_data_delay,
    generate_irregular_data_delay_latent,
    generate_irregular_data_delay_time_multi,
)
from .toy import TOY_DATASETS, dde_ramp_loading_time_sol, sine, subsample_irregular  # noqa: F401
from .validation import (  # noqa: F401
    compute_val_data_delay,
    get_val_loss_delay_precomputed,
    get_val_loss_delay_time_multi,
)
