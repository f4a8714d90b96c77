"""The benchmark's CPU tests. ``card`` marks a test that needs a CUDA
card; it decides inside the test, and skips here."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
