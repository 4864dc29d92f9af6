"""Data generation: expert MPPI collection and replay-buffer files."""

from .collector import collect_expert_data  # noqa: F401
from .replay import load_replay_buffer, replay_buffer_filename, save_replay_buffer  # noqa: F401
