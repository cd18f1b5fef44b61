from .cluster import SimResult, Workload, simulate

__all__ = ["SimResult", "Workload", "simulate"]
