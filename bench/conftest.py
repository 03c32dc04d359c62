"""pytest settings of the benchmark's own tests (``bench/tests``): the
harness and the program importable, and the ``card`` marker for tests that
need a CUDA device (each decides inside a fixture, never at import)."""
import pathlib
import sys

_HERE = pathlib.Path(__file__).resolve().parent
for p in (str(_HERE), str(_HERE.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped without one")
