"""Session set-up for every pytest run from this checkout."""


def pytest_configure(config):
    """Build native/libkmer_io.so once, before any test module is collected.

    The library is built on first load (best effort, ``make -C native``).
    Left to the tests, every xdist worker would start that build while it
    collects, and a worker that loaded a half-written library would skip
    the native tests.  So the controller (or the one process of a run
    without xdist) builds it first; workers only load it."""
    if hasattr(config, "workerinput"):
        return
    from kmer_counter_tpu_torch.io import native

    native.load_library()
