"""Quantitative point-cloud evaluation (Python DTU benchmark)."""
from .dtu_eval import (DTUScanResult, aggregate, evaluate_scan,  # noqa: F401
                       reduce_points)
