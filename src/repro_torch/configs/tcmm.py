"""TCMM (the paper's own evaluation workload): incremental trajectory
micro/macro clustering (Li, Lee, Li & Han 2010), §4.1 of the paper.

Not an LM architecture — this configures the ``repro_torch.apps.tcmm`` jobs
that run on the Liquid / Reactive Liquid pipelines exactly as in the
paper's experiment (micro-clustering job -> micro-cluster-changes topic
-> macro-clustering job).
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class TCMMConfig:
    # micro-clustering
    max_micro_clusters: int = 512
    distance_threshold: float = 2.0     # merge radius for micro-clusters
    feature_dim: int = 4                # (x, y, vx, vy) trajectory features
    # macro-clustering (periodic k-means over micro-cluster centroids)
    num_macro_clusters: int = 8
    macro_period: int = 256             # micro updates between macro runs
    kmeans_iters: int = 8
    seed: int = 0
