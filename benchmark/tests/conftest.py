"""Card tests are marked ``cuda`` and skip without a card (the ``card``
fixture decides, never an import)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")
