"""Data of the port: synthetic datasets and Dirichlet non-iid partitioning
(numpy copies of ``repro.data``; the LM batching pipeline is a later slice)."""
from .synthetic import make_classification, make_lm_tokens, make_pseudo_mnist
from .partition import dirichlet_partition, iid_partition, partition_to_node_data

__all__ = [
    "make_classification", "make_pseudo_mnist", "make_lm_tokens",
    "dirichlet_partition", "iid_partition", "partition_to_node_data",
]
