"""The engine layer of the port. So far only the wire-byte cost model
(``netcost.py``); the distributed engine (``gas.py``) and its GraphLab-PR
baseline (``baseline.py``) come with the mesh (ROADMAP.md Queue 1 item 8).
"""
from repro_torch.engine.netcost import (BytesReport, frogwild_bytes_measured,
                                        frogwild_bytes_model,
                                        pagerank_bytes_model)

__all__ = [
    "BytesReport",
    "frogwild_bytes_measured",
    "frogwild_bytes_model",
    "pagerank_bytes_model",
]
