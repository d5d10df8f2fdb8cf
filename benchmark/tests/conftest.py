"""The ``gpu`` marker for the tests that need the card (they skip without one)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
