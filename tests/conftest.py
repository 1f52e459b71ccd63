"""Test settings shared by the test files."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card and nvcc; skips without one")
