from .synthetic import FederatedLM, SyntheticClassification, SyntheticLM, cifar_like, mnist_like
from .partition import dirichlet_partition, skewed_label_partition, iid_partition
from .loader import ClientBatcher, FederatedDataset

__all__ = [
    "SyntheticClassification",
    "mnist_like",
    "cifar_like",
    "SyntheticLM",
    "FederatedLM",
    "dirichlet_partition",
    "skewed_label_partition",
    "iid_partition",
    "FederatedDataset",
    "ClientBatcher",
]
