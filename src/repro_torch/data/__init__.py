from .synthetic import SyntheticClassification, mnist_like, cifar_like
from .partition import dirichlet_partition, skewed_label_partition, iid_partition
from .loader import ClientBatcher, FederatedDataset

__all__ = [
    "SyntheticClassification",
    "mnist_like",
    "cifar_like",
    "dirichlet_partition",
    "skewed_label_partition",
    "iid_partition",
    "FederatedDataset",
    "ClientBatcher",
]
