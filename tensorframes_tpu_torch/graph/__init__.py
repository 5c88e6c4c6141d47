"""Graph IR, builder DSL and analysis of the PyTorch port."""

from .analysis import GraphSummary, NodeSummary, ShapeHints, analyze_graph
from .freeze import freeze_variables, has_variables
from .ir import Graph, GraphNode, parse_edge

__all__ = [
    "Graph",
    "GraphNode",
    "parse_edge",
    "freeze_variables",
    "has_variables",
    "GraphSummary",
    "NodeSummary",
    "ShapeHints",
    "analyze_graph",
]
