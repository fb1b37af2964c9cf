"""Markers of the test suite."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the hmtpu_torch kernels); "
        "skips where there is none")
    config.addinivalue_line(
        "markers", "slow: a full-size comparison that tier-1 leaves out "
        "(-m 'not slow')")
