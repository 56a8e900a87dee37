"""Minos core of the port: spike vectors, the dual classifier, Algorithm 1
frequency selection, hierarchical clustering."""
from repro_torch.core import spikes
from repro_torch.core.algorithm1 import (FreqSelection, cap_perf_centric,
                                         cap_power_centric, choose_bin_size,
                                         profiling_savings,
                                         select_optimal_freq)
from repro_torch.core.classify import (FreqPoint, MinosClassifier,
                                       WorkloadProfile,
                                       count_classifier_calls)
from repro_torch.core.clustering import (cosine_distance_matrix, cut, cut_k,
                                         euclidean_distance_matrix, linkage)
