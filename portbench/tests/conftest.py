"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``cuda`` marker for tests that need the card."""


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs an NVIDIA GPU; skipped where none is visible')
