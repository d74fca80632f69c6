from .synthetic import Dataset, Workload, make_lcps_dataset, make_workload

__all__ = ["Dataset", "Workload", "make_lcps_dataset", "make_workload"]
