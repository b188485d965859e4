from .ycsb import MIXES, Workload
