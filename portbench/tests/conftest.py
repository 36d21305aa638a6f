"""The benchmark's own tests. They run on the CPU; those marked `card`
need a CUDA card and decide inside the test whether there is one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
