"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the repository.  Tests marked ``cuda`` need an NVIDIA card and
skip without one (each decides inside the test)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where torch.cuda.is_available() is False")
