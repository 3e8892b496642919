"""pytest settings of the benchmark's own tests (port_bench/tests): the
`card` marker, for tests that need an NVIDIA card and skip without one
(decided inside a fixture, never at import)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")
