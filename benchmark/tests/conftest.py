"""Settings of the benchmark's own tests (python -m pytest benchmark/tests)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skips where torch.cuda finds none")
