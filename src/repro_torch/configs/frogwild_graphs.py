"""Graph workload configs for the paper's own experiments (a copy of
``repro/configs/frogwild_graphs.py``; the graphs are synthesized at the
paper's scales, see ``graph/generators.py``)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    name: str
    n: int                       # vertices
    avg_out_deg: float
    theta: float = 2.2           # PageRank power-law exponent (paper §2.3)
    seed: int = 0


# Benchmark-scale stand-ins for the paper's datasets.
LIVEJOURNAL_BENCH = GraphConfig("livejournal-bench", n=65_536, avg_out_deg=14.4)
TWITTER_BENCH = GraphConfig("twitter-bench", n=262_144, avg_out_deg=16.0)

# The paper's full scales.
LIVEJOURNAL_FULL = GraphConfig("livejournal", n=4_847_571, avg_out_deg=14.2)
TWITTER_FULL = GraphConfig("twitter", n=41_652_230, avg_out_deg=35.3)
