from .synthetic import (KEYWORD_NAMES, Dataset, Workload, make_hcps_dataset,
                        make_lcps_dataset, make_workload)

__all__ = ["KEYWORD_NAMES", "Dataset", "Workload", "make_hcps_dataset",
           "make_lcps_dataset", "make_workload"]
