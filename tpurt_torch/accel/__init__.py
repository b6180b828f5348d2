"""Acceleration structures of the port, built on the host with numpy."""
from tpurt_torch.accel.clusters import (GROUP, LEAF, ClusterSet, ClusterTree, WideTree,
                                        build_clusters, build_tree, build_wide, slot_order)

__all__ = ["GROUP", "LEAF", "ClusterSet", "ClusterTree", "WideTree", "build_clusters",
           "build_tree", "build_wide", "slot_order"]
