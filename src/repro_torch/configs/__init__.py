"""Registered config family: the paper's graph workloads.

``repro_torch.configs`` exports the FrogWild! graph configs
(``frogwild_graphs.py``: LiveJournal and Twitter, bench and full scale),
as ``repro.configs`` does. The LLM architecture registry is not on this
surface: the model tests and ``launch/serve.py`` import it from
``repro_torch.configs.registry``.
"""
from repro_torch.configs.frogwild_graphs import (GraphConfig,
                                                 LIVEJOURNAL_BENCH,
                                                 LIVEJOURNAL_FULL,
                                                 TWITTER_BENCH, TWITTER_FULL)
from repro_torch.configs.registry import GRAPHS, get_graph_config

__all__ = [
    "GraphConfig",
    "GRAPHS",
    "get_graph_config",
    "LIVEJOURNAL_BENCH",
    "LIVEJOURNAL_FULL",
    "TWITTER_BENCH",
    "TWITTER_FULL",
]
