"""Root test configuration: build the native graph loader once, before any
pytest-xdist worker starts.

``mini_tpu.native`` compiles ``libmini_graph.so`` with g++ at first use,
into one fixed path.  Under ``pytest -n N`` with no library yet, every
worker does so while it collects, and a worker may load a file another is
still writing: it then marks the build failed and ``tests/test_native.py``
skips in that worker.  The workers are started after ``pytest_configure``
has run in the controlling process, so building there, once, leaves them a
whole library to load.  Without xdist the hook only does early what the
first test would do.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built it
        return
    try:
        from mini_tpu.native import native_available
    except ImportError:
        return
    native_available()
