from .lm_data import Prefetcher, SyntheticLM
from .ycsb import MIXES, Workload
