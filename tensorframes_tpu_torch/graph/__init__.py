"""Graph IR, builder DSL and analysis of the PyTorch port."""

from .ir import Graph, GraphNode, parse_edge

__all__ = ["Graph", "GraphNode", "parse_edge"]
