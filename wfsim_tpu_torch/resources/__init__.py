from .loader import Resource, load_config, make_map, DummyMap  # noqa: F401
