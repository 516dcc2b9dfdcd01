"""The port's public surface against the reference's.

Each service-facing package of the port has an ``__all__`` equal to its
reference twin's snapshot (``tests/test_api_surface.py``'s ``SURFACE``),
less the names still to come, each listed here with the ``ROADMAP.md``
Queue 1 item that brings it, and the reference's deprecated build shims,
named here as not ported. Every exported name resolves, and
``repro_torch.configs`` exports the graph family only: the LLM registry
stays importable from ``repro_torch.configs.registry``.
"""
import importlib

import pytest

from test_api_surface import SURFACE

# names of the reference's surface that the port does not export yet, by
# the Queue 1 item that brings them
TO_COME = {}
# packages of the reference's surface that the port does not have yet
PACKAGES_TO_COME = {}
# the reference's deprecated shims of its index build: the port builds
# through ``FrogWildService.ensure_index`` / ``service.build_index``, and
# the sharded shim needs a mesh
NOT_PORTED = {"repro.query": {"build_walk_index", "build_walk_index_sharded"}}

PORTED = sorted(m.__name__ for m in SURFACE
                if m.__name__ not in PACKAGES_TO_COME)


def _port_module(name):
    return importlib.import_module("repro_torch" + name[len("repro"):])


@pytest.mark.parametrize("name", PORTED)
def test_public_surface_equals_the_reference(name):
    ref = next(m for m in SURFACE if m.__name__ == name)
    mod = _port_module(name)
    missing = set(TO_COME.get(name, {})) | NOT_PORTED.get(name, set())
    assert missing <= set(SURFACE[ref])
    assert sorted(mod.__all__) == sorted(set(SURFACE[ref]) - missing), (
        f"{mod.__name__}.__all__ differs from the reference's")
    assert len(set(mod.__all__)) == len(mod.__all__)
    for attr in mod.__all__:
        assert getattr(mod, attr, None) is not None, (mod.__name__, attr)


def test_every_reference_package_is_ported_or_to_come():
    names = {m.__name__ for m in SURFACE}
    assert set(PACKAGES_TO_COME) <= names
    assert set(TO_COME) | set(NOT_PORTED) <= names
    for name in PACKAGES_TO_COME:
        with pytest.raises(ImportError):
            _port_module(name)


def test_llm_registry_off_the_public_surface():
    import repro_torch.configs
    import repro_torch.configs.registry as registry
    assert "ARCHS" not in repro_torch.configs.__all__
    assert "get_config" not in repro_torch.configs.__all__
    assert sorted(registry.__all__) == ["GRAPHS", "GraphConfig",
                                        "get_graph_config"]
    # still importable by name, and the graph family equals the reference's
    from repro_torch.configs.registry import ARCHS, get_config  # noqa: F401
    import repro.configs
    for name, cfg in repro.configs.GRAPHS.items():
        assert repro_torch.configs.get_graph_config(name).__dict__ == \
            cfg.__dict__
    assert sorted(repro_torch.configs.GRAPHS) == sorted(repro.configs.GRAPHS)


def test_extra_names_stay_importable():
    """Names the port's packages carried before their ``__all__`` matched
    the reference's stay importable where they were."""
    from repro_torch import (FrogWildConfig, ShardRuntime,  # noqa: F401
                             ShardedWalkIndex, WalkIndex, WalkIndexConfig,
                             batch_pagerank, build_index)
    from repro_torch.query import (load_or_repair_walk_index,  # noqa: F401
                                   WalkIndexConfig as QueryWalkIndexConfig)
    from repro_torch.query.engine import (WaveSpec,  # noqa: F401
                                          build_wave_program)
    assert QueryWalkIndexConfig is WalkIndexConfig
