"""The LLM architectures the port runs (``registry.py``): the four dense
configs, copied from ``repro/configs``."""
from repro_torch.configs.registry import (ARCHS, SHAPES, get_config,
                                          reduced_config, shape_applicable)

__all__ = ["ARCHS", "SHAPES", "get_config", "reduced_config",
           "shape_applicable"]
