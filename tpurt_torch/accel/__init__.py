"""Acceleration structures of the port, built on the host with numpy."""
from tpurt_torch.accel.clusters import (LEAF, ClusterSet, ClusterTree,
                                        build_clusters, build_tree)

__all__ = ["LEAF", "ClusterSet", "ClusterTree", "build_clusters", "build_tree"]
