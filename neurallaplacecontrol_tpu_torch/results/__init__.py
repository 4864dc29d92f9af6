"""Results processing: normalized-return scores."""

from .process import (  # noqa: F401
    REFERENCE_BASELINES,
    expand_records,
    mean_confidence_interval,
    normalized_scores,
)
