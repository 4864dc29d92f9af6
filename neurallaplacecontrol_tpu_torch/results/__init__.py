"""Results processing: normalized-return scores, the log parser and the
LaTeX table. The plots (``results.plotting``) need matplotlib and are not
imported here."""

from .process import (  # noqa: F401
    REFERENCE_BASELINES,
    expand_records,
    latex_table,
    mean_confidence_interval,
    normalized_scores,
    parse_log_file,
)
