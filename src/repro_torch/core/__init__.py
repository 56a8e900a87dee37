"""Minos core of the port: spike vectors, dual classification, Algorithm 1
frequency selection, clustering, baselines."""
from repro_torch.core import spikes
from repro_torch.core.algorithm1 import (FreqSelection, cap_perf_centric,
                                         cap_power_centric, choose_bin_size,
                                         profiling_savings,
                                         select_optimal_freq)
from repro_torch.core.baselines import (mean_power_neighbor,
                                        util_only_neighbor)
from repro_torch.core.classify import (FreqPoint, MinosClassifier,
                                       WorkloadProfile, app_utilization,
                                       count_classifier_calls)
from repro_torch.core.clustering import (best_k_by_silhouette,
                                         cosine_distance_matrix, cut, cut_k,
                                         dendrogram_order,
                                         euclidean_distance_matrix, kmeans,
                                         kmeanspp_init, linkage,
                                         mahalanobis_distance_matrix,
                                         silhouette_score)
