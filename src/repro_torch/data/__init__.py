"""Data of the port: synthetic datasets, Dirichlet non-iid partitioning and
the LM token pipeline (numpy copies of ``repro.data``)."""
from .synthetic import make_classification, make_lm_tokens, make_pseudo_mnist
from .partition import dirichlet_partition, iid_partition, partition_to_node_data
from .pipeline import ShardedBatcher, TokenPipeline

__all__ = [
    "make_classification", "make_pseudo_mnist", "make_lm_tokens",
    "dirichlet_partition", "iid_partition", "partition_to_node_data",
    "TokenPipeline", "ShardedBatcher",
]
