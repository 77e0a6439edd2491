"""OTU layer: per-OTU accumulators and the OTU x sample table."""

from .table import OTUObserved, OTUTable

__all__ = ["OTUObserved", "OTUTable"]
