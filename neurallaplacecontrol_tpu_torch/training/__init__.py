"""Planner dynamics and cost closures (the episode loop and training are later slices)."""

from .rollout import build_learned_dynamics, build_running_cost  # noqa: F401
